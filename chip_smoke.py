"""Smoke run of the PyTorch port on one NVIDIA GPU (H100): builds the CUDA
rasterizer kernels (forward, with its p2f instance, and backward) from
csrc/, holds each against its plain version at the main paths' shapes and
against the golden oracle, drives the inference slice (test_iou.run at
full s2 width, batch 32; demo.render_panels), the stage-2 training slice
(train_s2.run at full s2 width, batch 16, 6 steps; one step with
cycle_soft_p2f) and the stage-1 training slice (train_s1.run at full s1
width, batch 64, 2 epochs of 3 batches with two template updates), checks
that each path went through the kernels, and times kernels, plain
versions and the training steps.

  python3 chip_smoke.py

Exits non-zero on any failure, and when no GPU is visible. The line
before the last is the kernel record (JSON); the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
KERNEL_SRC = "umr_tpu_torch/csrc/raster_fwd.cu"
TPU_KERNEL = "umr_tpu/ops/raster_kernel.py:299"   # _fwd_kernel
BWD_SRC = "umr_tpu_torch/csrc/raster_bwd.cu"
BWD_TPU_KERNEL = "umr_tpu/ops/raster_kernel_bwd.py:46"   # _bwd_kernel

# the main path's shapes: s2 at 256^2 (512^2 anti-aliased renders),
# subdivide 3 (F=1280), test_iou at batch 32
DEVICE = "cuda:0"
IMAGE_SIZE = 256
SUBDIVIDE = 3
BATCH = 32
N_BATCHES = 4
SCENE_B = 4
# the training slice: bench.py's s2 configuration (batch 16, K=8, tex 6)
TRAIN_BATCH = 16
TRAIN_STEPS = 6          # train_s2.run's steps (the main path)
TIMED_STEPS = 5          # then 1 warm-up and these, timed with CUDA events
FOLD_SLICE = 8           # images of the fold (128) and of the merged pass
                         # (48) the plain backward takes
TRACE_STEPS = 3          # steps traced for the step's split
# the stage-1 slice: train_s1.run at the Config default batch (64) and full
# width, 2 epochs of 3 batches with the template updated after each
S1_BATCH = 64
S1_BATCHES = 3
S1_EPOCHS = 2
P2F_SLICE = 8            # images of the s1 fused render the plain p2f takes

RGBA_ATOL = 1e-3      # kernel vs plain: reductions run in another order
AGGR_RTOL = 1e-4      # softmax (sum, max)
HARD_SHARE = 0.999    # face ids and depths equal on covered pixels
# backward kernel vs plain: the kernel sums each face's pixels per warp,
# per block (shared-memory atomics) and over tiles (global atomics), in an
# order that changes run to run; the plain version per face chunk. Each
# lane group (vertex x, y; vertex z; texels) is held to its own scale, as
# tests/test_torch_cuda.py holds it: |diff| <= BWD_RTOL |plain| + BWD_ATOL
# x the largest |plain| of the group. Reading (NVIDIA H100 80GB HBM3,
# 700 W): 7.5e-7 of the largest vertex gradient at worst, over all lanes
# at once
BWD_RTOL, BWD_ATOL = 1e-4, 1e-5
GOLDEN_BWD_REL = 1e-3  # as tests/test_kernel_interpret.py holds Pallas
# p2f kernel vs the plain version at face_chunk=1 (the same rule) and the
# golden oracle, in grid units (p2f lies in [-1, 1]): the kernel sums each
# face's weights per warp, block and tile with atomics, in another order
P2F_ATOL = 1e-4

# the bound: H100 SXM datasheet peaks, and the operations that this run's
# (pixel, binned face) pairs make the kernels do, counted from the source
# per branch (one per add, subtract, multiply, divide, compare, min, max,
# select, floor, conversion, exponential or atomic add; address
# arithmetic, the per-pixel set-up and write-out, the forward's rescale of
# its running softmax sums and the backward's warp reductions left out)
PEAK_FLOPS = 67e12     # fp32, outside the tensor cores
PEAK_BYTES = 3.35e12   # HBM3
OPS_BOX = 4        # every binned slot: the bbox test (raster_common.cuh:120)
OPS_DIST = 134     # in the bbox: barycentrics 12, three edges' foot points
                   # 99, inside test 6, nearest edge 13, squared distance
                   # and threshold test 4 (:123-186)
OPS_FRAG = 26      # past the threshold: sign and sigmoid 7, clipped
                   # barycentrics and depth 19 (:187-213)
OPS_TEXEL = 18     # the texel index (:214-220) where the pass reads texels
OPS_FOOT = 15      # backward: the foot point's weights (:192-201)
OPS_FWD_PASS = 4   # forward, past the threshold: alpha 2, depth test 2
OPS_FWD_Z = 14     # forward, depth in [near, far]: softmax weight and sum
                   # 8, colour sums 6 (raster_fwd.cu:117-135)
OPS_BWD_PASS = 2   # backward, past the threshold: depth gate
OPS_BWD_Z = 30     # backward, depth in range: alpha term and the x, y
                   # chain (raster_bwd.cu:128-162)
OPS_BWD_SOFT = 6   # its softmax weight, where texels or depths get grads
OPS_BWD_TEX = 7    # its texel lanes (:134-139)
OPS_BWD_ZLANE = 26  # its colour term and z lanes (:141-154)
OPS_P2F = 5        # forward with p2f, depth in range: contrib * gx and
                   # * gy with their sums, the weight sum (raster_fwd.cu:
                   # 161-166; the per-face warp reductions left out)


def phase(name):
    print(f"\n== {name}", flush=True)


def sh(cmd):
    res = subprocess.run(cmd, capture_output=True, text=True, check=True)
    return res.stdout.strip()


def cuda_time(fn, reps, warmup=1):
    """(mean milliseconds of fn() over reps calls after warmup, timed with
    CUDA events; the last call's result)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def sphere_scenes(renderer, template, B, T2, seed, dev):
    """B posed, scaled copies of the template sphere -> projected faces
    [B,F,3,3] and random texel sheets [B,F,T2,3] on the card."""
    g = torch.Generator().manual_seed(seed)
    verts = torch.as_tensor(template.verts)[None].repeat(B, 1, 1)
    verts = verts * (0.8 + 0.4 * torch.rand(B, 1, 3, generator=g))
    q = torch.randn(B, 4, generator=g)
    q = q / q.norm(dim=1, keepdim=True)
    cams = torch.cat([0.5 + 0.3 * torch.rand(B, 1, generator=g),
                      0.3 * torch.rand(B, 2, generator=g) - 0.15, q], 1)
    fv = renderer.project_faces(verts.to(dev), torch.as_tensor(
        template.faces, device=dev), cams.to(dev)).contiguous()
    tex = torch.rand(B, fv.shape[1], T2, 3, generator=g).to(dev)
    return fv, tex


def compare(name, out, ref, hard):
    """Kernel output vs plain version; returns max |rgba| difference."""
    err = (out.rgba - ref.rgba).abs().max().item()
    msg = f"{name}: rgba max|diff| {err:.3e} (<= {RGBA_ATOL})"
    assert err <= RGBA_ATOL, msg
    if hard:
        cov = ref.aggr[:, 1] >= 0
        same = ((out.aggr[:, 1] == ref.aggr[:, 1])
                & (out.aggr[:, 0] == ref.aggr[:, 0]))
        share = same[cov].float().mean().item()
        msg += (f"; face id + depth equal on {share:.6f} of "
                f"{int(cov.sum())} covered pixels (>= {HARD_SHARE})")
        assert share >= HARD_SHARE, msg
    else:
        rel = ((out.aggr - ref.aggr).abs() / ref.aggr.abs()).amax(
            dim=(0, 2, 3))
        msg += (f"; softmax sum rel {rel[0].item():.3e}, max rel "
                f"{rel[1].item():.3e} (<= {AGGR_RTOL})")
        assert rel.max().item() <= AGGR_RTOL, msg
    print(msg, flush=True)
    return err


def pair_counts(fv, bins, S, cap, sigma_val, dist_eps, chunk=1 << 14):
    """Of one render's binned (pixel, face) slots, how many reach each
    branch of the kernels' per-pair code on this run's data, found with
    the plain version's pair arithmetic: (slots of kept faces, pairs in
    the face's margin-expanded bbox, pairs past the distance threshold,
    and of those the pairs with depth in [near, far])."""
    from umr_tpu_torch.ops.rasterize import (_face_info, pair_math,
                                             threshold_of)

    al_fids, astarts = bins
    B, F = fv.shape[:2]
    TX = S // 32
    T = TX * TX
    n = torch.diff(astarts.long(), dim=1).clamp(max=cap)          # [B,T]
    pos = torch.arange(al_fids.shape[1], device=fv.device)
    tile = torch.searchsorted(astarts[:, 1:].long().contiguous(),
                              pos[None].expand(B, -1).contiguous(),
                              right=True)
    tc = tile.clamp(max=T - 1)
    keep = ((al_fids < F) & (tile < T)
            & (pos[None] - astarts.long().gather(1, tc) < n.gather(1, tc)))
    bi, ei = torch.nonzero(keep, as_tuple=True)
    faces = fv[bi, al_fids[bi, ei].long()]                        # [N,3,3]
    tiles = tile[bi, ei]
    thr, margin = threshold_of(sigma_val, dist_eps)
    lane = torch.arange(32 * 32, device=fv.device)
    counts = torch.zeros(4, dtype=torch.float64, device=fv.device)
    for c0 in range(0, faces.shape[0], chunk):
        f = faces[c0:c0 + chunk][None]                            # [1,E,3,3]
        t = tiles[c0:c0 + chunk, None]
        ch = _face_info(f[..., 0], f[..., 1], f[..., 2])
        ch["ok"] = ch.pop("nondegen")
        col = (t % TX) * 32 + lane % 32
        row = (t // TX) * 32 + lane // 32
        xp = ((2.0 * col + 1.0 - S) / S)[None]
        yp = ((2.0 * (S - 1 - row) + 1.0 - S) / S)[None]
        maxx, minx, maxy, miny = ch["bbox"]
        box = ~((xp > maxx + margin) | (xp < minx - margin)
                | (yp > maxy + margin) | (yp < miny - margin)) & ch["ok"]
        pm = pair_math(ch, xp, yp, thr, margin, 1.0 / sigma_val)
        counts += torch.stack([ch["ok"].sum() * lane.numel(), box.sum(),
                               pm["valid"].sum(),
                               (pm["valid"] & pm["z_ok"]).sum()]).double()
    return [int(c) for c in counts.tolist()]


def bound(ops, nbytes):
    """(bound ms, what bounds it): the larger of the two rooflines."""
    t_ops, t_bytes = ops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def lanes(opts):
    """(texel lanes, z lanes) the backward computes under opts, as
    umr_raster_bwd decides them."""
    mask_only = opts.get("mask_only", False)
    return (opts.get("tex_grads", True) and not mask_only,
            not (mask_only or opts.get("rgb_geom_detach", False)))


def raster_bound(counts, fv, tex, bins, S, opts=None, p2f=False):
    """(bound ms, bound_by) of one forward render (opts None; with p2f,
    the p2f instance's) or of its backward under opts, from its
    pair_counts."""
    slots, box, passed, in_depth = counts
    ops = slots * OPS_BOX + box * OPS_DIST + passed * OPS_FRAG
    inputs = 4 * (fv.numel() + tex.numel() + bins[0].numel()
                  + bins[1].numel())
    img = 4 * fv.shape[0] * S * S * (4 + 2)            # rgba, aggr
    if opts is None:
        ops += passed * (OPS_TEXEL + OPS_FWD_PASS) + in_depth * OPS_FWD_Z
        if p2f:
            ops += in_depth * OPS_P2F
            img += 4 * fv.shape[0] * fv.shape[1] * 2   # p2f [B, F, 2]
        return bound(ops, inputs + img)
    want_tex, want_z = lanes(opts)
    rgb = want_tex or want_z
    ops += (passed * (OPS_FOOT + OPS_BWD_PASS + rgb * OPS_TEXEL)
            + in_depth * (OPS_BWD_Z + rgb * OPS_BWD_SOFT
                          + want_tex * OPS_BWD_TEX + want_z * OPS_BWD_ZLANE))
    # reads the forward's outputs and g_rgba, writes the gradients
    return bound(ops, inputs + img + 4 * fv.shape[0] * S * S * 4
                 + 4 * (fv.numel() + tex.numel()))


def grad_check(name, got, want, opts):
    """The backward kernel's (grad faces, grad texels) against the plain
    version's, per lane group against the group's own scale; a group the
    mode does not compute is zero on both sides. Returns (max |diff|,
    max |diff| / the group's scale) over the groups."""
    want_tex, want_z = lanes(opts)
    groups = (("vertex x, y", got[0][..., :2], want[0][..., :2], True),
              ("vertex z", got[0][..., 2], want[0][..., 2], want_z),
              ("texels", got[1], want[1], want_tex))
    worst = (0.0, 0.0)
    msgs, bad = [], []
    for label, g, w, live in groups:
        if not live:
            ok = g.abs().max().item() == 0 == w.abs().max().item()
            msgs.append(f"{label} zero (not computed in this mode)")
            if not ok:
                bad.append(label)
            continue
        scale = w.abs().max().item()
        diff = (g - w).abs()
        err = diff.max().item()
        excess = (diff / (BWD_RTOL * w.abs() + BWD_ATOL * scale)).max().item()
        msgs.append(f"{label} max |diff| {err:.3e} of {scale:.3e} "
                    f"({err / max(scale, 1e-30):.2e}; {excess:.3f} of the "
                    "limit)")
        if not (scale > 0 and excess <= 1.0):
            bad.append(label)
        worst = (max(worst[0], err), max(worst[1], err / max(scale, 1e-30)))
    msg = f"{name}: " + "; ".join(msgs)
    print(msg, flush=True)
    assert not bad, f"{msg} -- outside the limit: {bad}"
    return worst


def kernel_grads(raster_kernel, fv, tex, g, **kw):
    """Forward + backward kernel through the autograd Function."""
    fv = fv.detach().clone().requires_grad_()
    tex = tex.detach().clone().requires_grad_()
    out = raster_kernel.soft_rasterize_fwd(fv, tex, **kw)
    (out.rgba * g).sum().backward()
    torch.cuda.synchronize()
    return fv.grad, tex.grad


def plain_grads(fv, tex, g, kw, opts):
    from umr_tpu_torch.ops.rasterize import soft_rasterize
    from umr_tpu_torch.ops.rasterize_bwd import soft_rasterize_bwd

    bkw = {k: v for k, v in kw.items()
           if k in ("image_size", "sigma_val", "dist_eps", "gamma_val")}
    ref = soft_rasterize(fv, tex, mask_only=opts.get("mask_only", False),
                         **kw)
    return soft_rasterize_bwd(fv, tex, ref.rgba, ref.aggr, g, **opts, **bkw)


def trace_split(one_step, prefix, step_ms, smi, label):
    """A trace of TRACE_STEPS calls of one_step (a training step): device
    time per step by the step's profiler ranges (training/steps.py), the
    rasterizer kernels by the images of their grid, the copies, and the
    device's idle share of the untraced step (step_ms). Prints it and
    returns it as a dict."""
    from umr_tpu_torch.experiments.profile_slice import (
        busy_us, device_ops, launch_times, range_split, trace_events)

    events, wall_us = trace_events(one_step, TRACE_STEPS)
    split = range_split(events, prefix, TRACE_STEPS)
    launch = launch_times(events)
    raster_split, raster_seen = {}, [0, 0]
    for e in events:
        name_ = e.get("name", "")
        if e.get("cat") == "kernel" and "raster_" in name_:
            key = ("raster_fwd" if "raster_fwd" in name_ else "raster_bwd")
            key += f" {e.get('args', {}).get('grid', [0, 0])[1]} images"
            raster_split[key] = (raster_split.get(key, 0.0)
                                 + float(e["dur"]) / TRACE_STEPS / 1e3)
            raster_seen[0] += e.get("args", {}).get("correlation") in launch
            raster_seen[1] += 1
    # device busy time per step against the untraced step: the profiler
    # slows the host, not the device
    busy_ms = busy_us(device_ops(events)) / TRACE_STEPS / 1e3
    traced_ms = wall_us / TRACE_STEPS / 1e3
    copy_ms = {c: sum(d for _, _, d in device_ops(events, (c,)))
               / TRACE_STEPS / 1e3 for c in ("gpu_memcpy", "gpu_memset")}
    idle = 1.0 - busy_ms / step_ms
    print(f"{label} split, device ms per step by profiler range "
          f"({TRACE_STEPS} traced steps): " + ", ".join(
              f"{k} {v:.2f}" for k, v in sorted(split.items()))
          + f"; sum {sum(split.values()):.2f}; rasterizer kernels "
          f"({raster_seen[0]} of {raster_seen[1]} with their launch call "
          "in the trace): "
          + ", ".join(f"{k} {v:.3f}" for k, v in sorted(raster_split.items()))
          + f"; copies {copy_ms['gpu_memcpy']:.2f}, memsets "
          f"{copy_ms['gpu_memset']:.2f}; device busy {busy_ms:.2f} ms per "
          "step, idle share "
          f"{idle:.3f} of the untraced step's {step_ms:.2f} ms (traced "
          f"steps {traced_ms:.2f} ms) [{smi}]", flush=True)
    assert split and busy_ms > 0, "the trace holds no device time"
    return dict(split=split, raster=raster_split, busy_ms=busy_ms,
                traced_ms=traced_ms, copy_ms=copy_ms, idle=idle)


def timed_steps(step_fn, state, batches, n, *args):
    """(median ms, all ms, state) of n steps after 1 warm-up step, each
    timed with CUDA events; every step's total_loss must be finite."""
    times = []
    for i in range(n + 1):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, sc = step_fn(state, batches[i % len(batches)], *args)
        end.record()
        torch.cuda.synchronize()
        assert math.isfinite(sc["total_loss"].item())
        if i:                                        # step 0 is the warm-up
            times.append(start.elapsed_time(end))
    return float(np.median(times)), times, state


def p2f_check(name, out, ref):
    """The p2f instance's p2f against the plain version's (the same rule),
    in grid units; returns the largest |diff|."""
    diff = (out.p2f - ref.p2f).abs()
    err = diff.max().item()
    q = torch.quantile(diff.flatten().double(), 0.999).item()
    nz = int((ref.p2f.abs().sum(-1) > 0).sum())
    msg = (f"{name}: p2f max |diff| {err:.3e} grid units (99.9th percentile "
           f"{q:.3e}) over {diff.shape[0] * diff.shape[1]} faces, {nz} "
           f"with weight (<= {P2F_ATOL})")
    print(msg, flush=True)
    assert err <= P2F_ATOL and nz > 0, msg
    return err


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device visible")
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from golden_raster import golden_soft_rasterize
    from umr_tpu_torch.config import Config
    from umr_tpu_torch.data import synthetic_batch
    from umr_tpu_torch.experiments import demo, test_iou
    from umr_tpu_torch.experiments.profile_slice import random_model
    from umr_tpu_torch.mesh import build_template
    from umr_tpu_torch.models import symmetrize
    from umr_tpu_torch.ops import raster_kernel
    from umr_tpu_torch.ops.raster_bins import compute_raster_bins
    from umr_tpu_torch.ops.rasterize import soft_rasterize
    from umr_tpu_torch.ops.rasterize_bwd import soft_rasterize_bwd
    from umr_tpu_torch.renderer import (SoftRenderer, apply_lighting,
                                        surface_normals)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)

    phase("1. device")
    smi = sh(["nvidia-smi", "--query-gpu=name,power.limit",
              "--format=csv,noheader"]).splitlines()[0]
    print(f"nvidia-smi: {smi}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    print("nvcc: " + sh([raster_kernel._nvcc(), "--version"]).splitlines()[-1])
    print(f"allow_tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, "
          f"cudnn {torch.backends.cudnn.allow_tf32}")
    jax_loaded = sorted({m.split(".")[0] for m in sys.modules} & {
        "jax", "jaxlib", "flax", "umr_tpu"})
    print("jax or the JAX package loaded:", jax_loaded or "none")
    assert not jax_loaded, jax_loaded

    phase("2. build")
    t0 = time.perf_counter()
    raster_kernel.build()
    print(f"built {KERNEL_SRC} and {BWD_SRC} in "
          f"{time.perf_counter() - t0:.1f} s")
    for line in raster_kernel.BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())

    phase("3. kernel vs plain version on the card")
    template = build_template(SUBDIVIDE, 1, 6)
    F = template.faces.shape[0]
    rend = SoftRenderer(image_size=IMAGE_SIZE)     # 2x anti-aliased render
    S = rend.render_size
    cap = rend.resolved_mf_cap(F)
    rkw = dict(image_size=S, sigma_val=rend.sigma_val,
               dist_eps=rend.dist_eps, gamma_val=rend.gamma_val)
    max_err = 0.0
    for mode, T2, seed in (("softmax", 36, 1), ("softmax", 1, 2),
                           ("hard", 36, 3)):
        fv, tex = sphere_scenes(rend, template, SCENE_B, T2, seed, dev)
        tex = None if T2 == 1 else tex
        full = compute_raster_bins(
            fv, S, raster_kernel.TILE_SIZE, rend.sigma_val, rend.dist_eps, F,
            raster_kernel.MAX_COVER, F * 16 + 8 * (S // 32) ** 2)
        most = int(torch.diff(full[1], dim=1).max())
        assert most <= cap, f"a tile holds {most} > cap {cap} entries"
        kw = dict(rkw, aggr_func_rgb=mode)
        out = raster_kernel.soft_rasterize_fwd(fv, tex, mf_cap=cap, **kw)
        torch.cuda.synchronize()
        ref = soft_rasterize(fv, tex, **kw)
        max_err = max(max_err, compare(
            f"{mode} T2={T2} B={SCENE_B} F={F} S={S} cap={cap} (fullest tile "
            f"{most} entries)", out, ref, mode == "hard"))

    gkw = dict(image_size=32, sigma_val=3e-3, gamma_val=1e-2, dist_eps=1e-4,
               background_color=(0.1, 0.2, 0.3))
    rng = np.random.RandomState(0)
    gf = np.zeros((2, 6, 3, 3), np.float32)
    gf[..., :2] = rng.uniform(-0.9, 0.9, (2, 6, 3, 2))
    gf[..., 2] = 7.0 + rng.uniform(-1.0, 1.0, (2, 6, 3))
    gt = rng.uniform(0.0, 1.0, (2, 6, 16, 3)).astype(np.float32)
    for mode in ("softmax", "hard"):
        g_rgba, _, g_aggr = golden_soft_rasterize(gf, gt, aggr_func_rgb=mode,
                                                  **gkw)
        out = raster_kernel.soft_rasterize_fwd(
            torch.as_tensor(gf, device=dev), torch.as_tensor(gt, device=dev),
            aggr_func_rgb=mode, mf_cap=32, **gkw)
        err = np.abs(out.rgba.cpu().numpy() - g_rgba).max()
        assert err <= 5e-4, f"golden {mode}: rgba {err}"
        a1 = out.aggr[:, 1].cpu().numpy()
        if mode == "hard":
            assert (a1 == g_aggr[:, 1]).all(), "golden hard: face ids"
        else:
            assert np.abs(a1 - g_aggr[:, 1]).max() <= 1e-5, "golden max"
        print(f"golden oracle {mode}: rgba max|diff| {err:.3e} (<= 5e-4)")

    phase("4. the slice: test_iou.run (s2, batch 32, 256^2) + demo panels")
    cfg = Config(batch_size=BATCH, image_size=IMAGE_SIZE,
                 subdivide=SUBDIVIDE).sync_image_size()
    model = random_model(cfg, template, seed=0, device="cpu")
    n_batches = N_BATCHES
    data_rng = np.random.RandomState(0)
    loader = [synthetic_batch(data_rng, cfg.batch_size, cfg.image_size)
              for _ in range(n_batches)]
    with tempfile.TemporaryDirectory() as tmp:
        cfg = cfg.replace(model_path=os.path.join(tmp, "pred_net.pth"))
        torch.save(model.state_dict(), cfg.model_path)
        del model
        raster_kernel.LAUNCHES = 0
        t0 = time.perf_counter()
        iou = test_iou.run(cfg, dataloader=loader, device=dev)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        eval_model = test_iou.build_eval_model(cfg, template, dev)
    panel = demo.render_panels(eval_model, loader[0]["img"][0],
                               generator=torch.Generator(dev).manual_seed(0))
    torch.cuda.synchronize()
    launches = raster_kernel.LAUNCHES
    print(f"IoU {iou:.4f} over {n_batches} batches of {cfg.batch_size} "
          f"(random weights, trunk from weights/resnet18_*.npz); "
          f"run {run_s:.2f} s incl. model load")
    print(f"panel {panel.shape}, finite {bool(np.isfinite(panel).all())}")
    print(f"raster_fwd launches on the main path: {launches} "
          f"(expected {n_batches} + 5)")
    assert math.isfinite(iou) and 0.0 <= iou <= 1.0, iou
    assert panel.shape == (2 * cfg.image_size, 3 * cfg.image_size, 3)
    assert np.isfinite(panel).all()
    assert launches == n_batches + 5, launches

    faces = torch.as_tensor(template.faces, device=dev)

    def img_of(batch):
        return torch.as_tensor(test_iou.prepare_batch(batch)[0], device=dev)

    times = []
    with torch.no_grad():
        for i, batch in enumerate(loader * 3):
            x = img_of(batch)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            test_iou.predict_masks(eval_model, rend, faces, x,
                                   generator=torch.Generator(dev).manual_seed(0))
            end.record()
            torch.cuda.synchronize()
            if i:                                   # batch 0 is the warm-up
                times.append(start.elapsed_time(end))
    lat = float(np.median(times))
    print(f"test_iou batch-{cfg.batch_size} latency (forward + {S}^2 AA "
          f"render): median "
          f"{lat:.2f} ms over {len(times)} batches after 1 warm-up "
          f"[{smi}]")

    phase("5. kernel vs plain version on the slice's meshes, and timing")

    def time_shape(label, fv, tex, kw, plain_reps):
        """Kernel (with its binning) against the plain version on the
        same faces, the plain output held against the kernel's. Returns
        (ms with binning, binning ms, plain ms, max |rgba| diff)."""
        ms_k, out = cuda_time(lambda: raster_kernel.soft_rasterize_fwd(
            fv, tex, mf_cap=cap, **kw), 20)
        ms_b, _ = cuda_time(lambda: compute_raster_bins(
            fv, S, raster_kernel.TILE_SIZE, rend.sigma_val, rend.dist_eps,
            cap, raster_kernel.MAX_COVER), 20)
        ms_p, ref = cuda_time(lambda: soft_rasterize(fv, tex, **kw),
                              plain_reps)
        err = compare(label, out, ref, kw.get("aggr_func_rgb") == "hard")
        print(f"{label}: kernel with binning {ms_k:.3f} ms (binning alone "
              f"{ms_b:.3f} ms), plain {ms_p:.1f} ms [{smi}]")
        return ms_k, ms_b, ms_p, err

    with torch.no_grad():
        out = eval_model(img_of(loader[0]),
                         generator=torch.Generator(dev).manual_seed(0))
        verts = (eval_model.get_mean_shape()[None]
                 + symmetrize(out["delta_v"], template))
        fv = rend.project_faces(verts, faces, out["cam"]).contiguous()
    ms, ms_bins, plain_ms, err = time_shape(
        f"test_iou render B={cfg.batch_size} S={S} T2=1 softmax "
        "(predicted meshes)", fv, None, rkw, 2)
    max_err = max(max_err, err)

    vis = demo.vis_renderer(cfg.image_size)
    with torch.no_grad():
        verts1, cams1, tex1, _ = demo.predict_mesh(
            eval_model, loader[0]["img"][0],
            generator=torch.Generator(dev).manual_seed(0))
        fv1 = vis.project_faces(verts1, faces, cams1).contiguous()
        tex1 = apply_lighting(tex1, surface_normals(fv1),
                              vis.ambient_intensity,
                              vis.directional_intensity,
                              vis.light_direction).contiguous()
    hkw = dict(rkw, aggr_func_rgb="hard",
               background_color=vis.background_color)
    ms_demo, ms_demo_bins, plain_ms_demo, err = time_shape(
        f"demo render B=1 S={S} T2=36 hard (predicted mesh)", fv1, tex1,
        hkw, 3)
    max_err = max(max_err, err)

    with torch.no_grad():
        iou_bins = compute_raster_bins(fv, S, raster_kernel.TILE_SIZE,
                                       rend.sigma_val, rend.dist_eps, cap,
                                       raster_kernel.MAX_COVER)
        ms_kernel, _ = cuda_time(lambda: raster_kernel.soft_rasterize_fwd(
            fv, None, mf_cap=cap, bins=iou_bins, **rkw), 20)

    def counts_of(fv_, bins_):
        return pair_counts(fv_, bins_, S, cap, rend.sigma_val, rend.dist_eps)

    iou_counts = counts_of(fv, iou_bins)
    fwd_bound, fwd_by = raster_bound(
        iou_counts, fv, torch.ones_like(fv[:, :, :1]), iou_bins, S)
    print(f"test_iou render: kernel alone {ms_kernel:.3f} ms; bound "
          f"{fwd_bound:.3f} ms ({fwd_by}; slots, pairs in bbox, past the "
          f"threshold, in depth: {iou_counts}) [{smi}]")

    def fullest_tiles(fv_):
        """Per image, the faces binned to its fullest tile, uncapped."""
        full = compute_raster_bins(
            fv_, S, raster_kernel.TILE_SIZE, rend.sigma_val, rend.dist_eps,
            F, raster_kernel.MAX_COVER, F * 16 + 8 * (S // 32) ** 2)
        return torch.diff(full[1], dim=1).amax(dim=1)

    def check_cap(fv_, label):
        """The plain version renders every face: it meets the kernel only
        where no tile overflows the kernel's cap."""
        most = int(fullest_tiles(fv_).max())
        assert most <= cap, f"{label}: a tile holds {most} > cap {cap}"
        return most

    phase("6. backward kernel vs plain version and the golden backward")
    bwd_err, bwd_rel = 0.0, 0.0
    modes = (("default", {}), ("rgb_geom_detach", {"rgb_geom_detach": True}),
             ("tex_grads=False", {"tex_grads": False}),
             ("mask_only", {"mask_only": True}))
    for i, (label, opts) in enumerate(modes):
        fv_s, tex_s = sphere_scenes(rend, template, SCENE_B, 36, 10 + i, dev)
        most = check_cap(fv_s, label)
        g = torch.randn((SCENE_B, S, S, 4), device=dev,
                        generator=torch.Generator(dev).manual_seed(20 + i))
        kf, kt = kernel_grads(raster_kernel, fv_s, tex_s, g, mf_cap=cap,
                              **opts, **rkw)
        pf, pt = plain_grads(fv_s, tex_s, g, rkw, opts)
        e, r = grad_check(f"{label} B={SCENE_B} S={S} T2=36 (fullest tile "
                          f"{most})", (kf, kt), (pf, pt), opts)
        bwd_err, bwd_rel = max(bwd_err, e), max(bwd_rel, r)

    from golden_raster import golden_soft_rasterize_backward
    g_rgba, _, g_aggr = golden_soft_rasterize(gf, gt, **gkw)
    gg = np.random.RandomState(1).standard_normal(
        (2, 32, 32, 4)).astype(np.float32)
    bkw = {k: v for k, v in gkw.items() if k != "background_color"}
    ggf, ggt = golden_soft_rasterize_backward(gf, gt, g_rgba, g_aggr, gg,
                                              **bkw)
    kf, kt = kernel_grads(raster_kernel, torch.as_tensor(gf, device=dev),
                          torch.as_tensor(gt, device=dev),
                          torch.as_tensor(gg, device=dev), mf_cap=32, **gkw)
    for name, got, want in (("grad faces", kf, ggf), ("grad texels", kt, ggt)):
        scale = np.abs(want).max()
        err = np.abs(got.cpu().numpy() - want).max()
        msg = (f"golden backward {name}: max |diff| {err:.3e} of max |grad| "
               f"{scale:.3e} ({err / scale:.2e} <= {GOLDEN_BWD_REL})")
        print(msg, flush=True)
        assert err <= GOLDEN_BWD_REL * scale, msg

    phase("7. the training slice: train_s2.run (s2, batch 16, 256^2 with "
          "512^2 AA renders, K=8, F=1280, T2=36)")
    from umr_tpu_torch.experiments import train_s2
    from umr_tpu_torch.losses.composite import PartMatchingLoss
    from umr_tpu_torch.models import MeshNet, init_weights
    from umr_tpu_torch.ops.grid_sample import sample_textures
    from umr_tpu_torch.ops.quaternion import rotate_cam
    from umr_tpu_torch.training.trainer import prepare_batch

    tcfg = Config(batch_size=TRAIN_BATCH, image_size=IMAGE_SIZE,
                  subdivide=SUBDIVIDE, tex_size=6, num_hypo_cams=8,
                  num_iter=TRAIN_STEPS, print_freq=1).sync_image_size()
    # the synthetic semantic template bench.py builds
    srng = np.random.RandomState(0)
    seg = srng.randint(0, 5, size=(128, 256)).astype(np.float32)
    idx = srng.permutation(template.num_verts)
    pvi = [idx[0:100], idx[100:250], idx[250:330], idx[330:480]]
    tloader = [synthetic_batch(data_rng, TRAIN_BATCH, IMAGE_SIZE)
               for _ in range(TRAIN_STEPS)]
    assert all("dts_barrier" in b for b in tloader)
    torch.cuda.reset_peak_memory_stats()
    raster_kernel.LAUNCHES = raster_kernel.BWD_LAUNCHES = 0
    t0 = time.perf_counter()
    trainer = train_s2.run(tcfg, tloader, device=dev,
                           semantic=(None, seg, pvi))
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    train_fwd, train_bwd = raster_kernel.LAUNCHES, raster_kernel.BWD_LAUNCHES
    state = trainer.state
    print(f"train_s2.run: {state.step} steps in {run_s:.2f} s incl. set-up; "
          f"raster_fwd launches {train_fwd}, raster_bwd launches "
          f"{train_bwd} (expected 3 and 2 per step)")
    assert state.step == state.updates == TRAIN_STEPS
    assert len(trainer.history) == TRAIN_STEPS
    for sc in trainer.history:
        assert all(math.isfinite(v) for v in sc.values()), sc
    assert (train_fwd, train_bwd) == (3 * TRAIN_STEPS, 2 * TRAIN_STEPS)
    fresh = init_weights(MeshNet(template, input_size=IMAGE_SIZE),
                         torch.Generator().manual_seed(tcfg.seed))
    moved = (state.model.shape_predictor.pred_layer.weight.detach().cpu()
             - fresh.shape_predictor.pred_layer.weight).abs().max().item()
    print(f"shape head moved by up to {moved:.3e} from its seeded init")
    assert moved > 0
    first_s2, last = trainer.history[0], trainer.history[-1]
    print("step 1 scalars: " + ", ".join(f"{k} {v:.4f}"
                                          for k, v in first_s2.items()))
    print(f"step {TRAIN_STEPS} total_loss {last['total_loss']:.4f}")

    raster_kernel.LAUNCHES = raster_kernel.BWD_LAUNCHES = 0
    step_ms, times, state = timed_steps(
        trainer.step_fn, state, [prepare_batch(b) for b in tloader],
        TIMED_STEPS)
    assert (raster_kernel.LAUNCHES, raster_kernel.BWD_LAUNCHES) == (
        3 * (TIMED_STEPS + 1), 2 * (TIMED_STEPS + 1))
    imgs_s = TRAIN_BATCH / (step_ms / 1e3)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"s2 training step, batch {TRAIN_BATCH}: median {step_ms:.2f} ms "
          f"over {TIMED_STEPS} steps after 1 warm-up (min {min(times):.2f}, "
          f"max {max(times):.2f}), {imgs_s:.1f} images/s; peak device "
          f"memory {peak_gb:.2f} GB; TF32 off [{smi}]")

    phase("8. kernels at the training step's shapes; the step's split")
    model = state.model
    B, K = TRAIN_BATCH, tcfg.num_hypo_cams
    # the step's renderers (training/steps.py) at the step's inputs
    tex_r = SoftRenderer(image_size=IMAGE_SIZE).ambient_light_only()
    hard_r = SoftRenderer(image_size=IMAGE_SIZE, render_type="hard")
    db = {k: torch.as_tensor(v, device=dev)
          for k, v in prepare_batch(tloader[0]).items()}
    part_loss = PartMatchingLoss.build(seg, template.uv_sampler,
                                       template.num_sym_faces, tex_r,
                                       tex_size=6, device=dev)
    with torch.no_grad():
        out = model(db["input_img"], generator=state.generator)
        pred_vs = (symmetrize(model.mean_v, template)[None]
                   + symmetrize(out["delta_v"], template))
        cams_all = out["cam_hypotheses"].reshape(B * K, 7)
        tex = sample_textures(out["tex_flow"], db["img"]).reshape(
            B, F, 36, 3)
        proj = out["cam"]
        rnd = rotate_cam(proj, torch.randint(
            0, 180, (B,), device=dev,
            generator=torch.Generator(dev).manual_seed(3)))
        fold_fv = tex_r.project_faces(pred_vs.repeat_interleave(K, 0), faces,
                                      cams_all).contiguous()
        fold_tex = tex.repeat_interleave(K, 0).contiguous()
        fold_bins = compute_raster_bins(fold_fv, S, raster_kernel.TILE_SIZE,
                                        rend.sigma_val, rend.dist_eps, cap,
                                        raster_kernel.MAX_COVER)
        groups = part_loss.texture_groups(B)
        n_g = len(groups)
        mrg_fv = tex_r.project_faces(
            torch.cat([pred_vs] * (n_g + 1)), faces,
            torch.cat([proj] * n_g + [rnd])).contiguous()
        mrg_tex = torch.cat(groups + [tex]).contiguous()
        # the merged pass's bins as the step builds them: the main view's
        # (shared with pass 2) once per part group, then the unseen view's
        main_bins = hard_r.compute_bins(pred_vs, faces, proj)
        gan_bins = tex_r.compute_bins(pred_vs, faces, rnd)
        mrg_bins = tuple(torch.cat([m] * n_g + [gb])
                         for m, gb in zip(main_bins, gan_bins))

    shapes = {}
    for label, fv_t, tex_t, bins, opts in (
            ("fold", fold_fv, fold_tex, fold_bins, {"rgb_geom_detach": True}),
            ("merged", mrg_fv, mrg_tex, mrg_bins, {"tex_grads": False})):
        per_img = fullest_tiles(fv_t)
        most = int(per_img.max())
        over = int((per_img > cap).sum())
        n_img = fv_t.shape[0]
        print(f"{label} render: {over} of {n_img} images have a tile over "
              f"the cap of {cap} faces (fullest {most}); the kernels keep "
              f"the first {cap} faces of such a tile, as the TPU kernel does")
        with torch.no_grad():
            ms_b, _ = cuda_time(lambda: compute_raster_bins(
                fv_t, S, raster_kernel.TILE_SIZE, rend.sigma_val,
                rend.dist_eps, cap, raster_kernel.MAX_COVER), 10)
            ms_f, o = cuda_time(lambda: raster_kernel.soft_rasterize_fwd(
                fv_t, tex_t, mf_cap=cap, bins=bins, **opts, **rkw), 10)
            g = torch.randn(o.rgba.shape, device=dev,
                            generator=torch.Generator(dev).manual_seed(5))
            ms_g, _ = cuda_time(lambda: raster_kernel.raster_bwd(
                fv_t, tex_t, bins, o.rgba, o.aggr, g, S, rend.sigma_val,
                rend.dist_eps, rend.gamma_val, cap, **opts), 10)
            del o, g
        counts = counts_of(fv_t, bins)
        fb = raster_bound(counts, fv_t, tex_t, bins, S)
        bb = raster_bound(counts, fv_t, tex_t, bins, S, opts)
        shapes[label] = dict(fwd_ms=ms_f, bins_ms=ms_b, bwd_ms=ms_g,
                             fwd_bound=fb, bwd_bound=bb, over_cap=over,
                             counts=counts)
        print(f"{label} render, {n_img} images at {S}^2, T2=36 (fullest "
              f"tile {most}; slots, pairs in bbox, past the threshold, in "
              f"depth: {counts}): binning {ms_b:.3f} ms; forward kernel "
              f"{ms_f:.3f} ms (bound {fb[0]:.3f} ms, {fb[1]}); backward "
              f"kernel {ms_g:.3f} ms (bound {bb[0]:.3f} ms, {bb[1]}) [{smi}]")

    # the plain backward is dense over all pairs: minutes at a whole pass,
    # and it renders every face, so kernel and plain meet on FOLD_SLICE
    # images of each pass whose tiles all fit the cap, spread over the
    # pass (the merged pass: its part groups and its unseen view), the
    # kernel on the pass's own bins
    slices = {}
    for label, fv_t, tex_t, bins, opts, seed in (
            ("fold", fold_fv, fold_tex, fold_bins, {"rgb_geom_detach": True},
             6),
            ("merged", mrg_fv, mrg_tex, mrg_bins, {"tex_grads": False}, 7)):
        ok = torch.nonzero(fullest_tiles(fv_t) <= cap)[:, 0]
        assert len(ok) >= FOLD_SLICE, f"{label}: {len(ok)} images in the cap"
        sel = ok[torch.linspace(0, len(ok) - 1, FOLD_SLICE,
                                device=ok.device).round().long()]
        sl_fv, sl_tex = fv_t[sel].contiguous(), tex_t[sel].contiguous()
        sl_bins = tuple(b[sel].contiguous() for b in bins)
        g = torch.randn((FOLD_SLICE, S, S, 4), device=dev,
                        generator=torch.Generator(dev).manual_seed(seed))
        kf, kt = kernel_grads(raster_kernel, sl_fv, sl_tex, g, mf_cap=cap,
                              bins=sl_bins, **opts, **rkw)
        pf, pt = plain_grads(sl_fv, sl_tex, g, rkw, opts)
        name = (f"{label} slice: {FOLD_SLICE} images within the cap, on the "
                f"pass's bins (predicted meshes, images {sel.tolist()})")
        e, r = grad_check(name, (kf, kt), (pf, pt), opts)
        bwd_err, bwd_rel = max(bwd_err, e), max(bwd_rel, r)
        del kf, kt, pf, pt
        with torch.no_grad():
            o = raster_kernel.soft_rasterize_fwd(sl_fv, sl_tex, mf_cap=cap,
                                                 bins=sl_bins, **opts, **rkw)
            ms_k, _ = cuda_time(lambda: raster_kernel.raster_bwd(
                sl_fv, sl_tex, sl_bins, o.rgba, o.aggr, g, S, rend.sigma_val,
                rend.dist_eps, rend.gamma_val, cap, **opts), 20)
            ref = soft_rasterize(sl_fv, sl_tex, **rkw)
            ms_p, _ = cuda_time(lambda: soft_rasterize_bwd(
                sl_fv, sl_tex, ref.rgba, ref.aggr, g, image_size=S,
                sigma_val=rend.sigma_val, dist_eps=rend.dist_eps,
                gamma_val=rend.gamma_val, **opts), 1)
            del o, ref
        sb = raster_bound(counts_of(sl_fv, sl_bins), sl_fv, sl_tex, sl_bins,
                          S, opts)
        slices[label] = dict(ms=ms_k, plain_ms=ms_p, bound=sb, max_abs=e,
                             max_rel=r)
        print(f"{label} slice: backward kernel {ms_k:.3f} ms, plain backward "
              f"{ms_p:.1f} ms, bound {sb[0]:.3f} ms ({sb[1]}) [{smi}]")

    # the step's split, from a trace of the step itself (after the timed
    # steps: the profiler leaves host overhead on later launches)
    state_box = [state]

    def one_step():
        state_box[0], _ = trainer.step_fn(state_box[0], prepare_batch(
            tloader[0]))

    s2_trace = trace_split(one_step, "s2.", step_ms, smi, "step")
    split, raster_split = s2_trace["split"], s2_trace["raster"]
    busy_ms, traced_ms = s2_trace["busy_ms"], s2_trace["traced_ms"]
    copy_ms, idle = s2_trace["copy_ms"], s2_trace["idle"]
    del trainer, state, state_box, model, out, tex, fold_fv, fold_tex
    del mrg_fv, mrg_tex, fold_bins, mrg_bins
    torch.cuda.empty_cache()

    phase("9. p2f: the forward kernel's p2f instance vs the plain version "
          "(face_chunk=1, the kernel's rule) and the golden oracle")
    # the plain version one face at a time over the whole image
    pkw = dict(rkw, face_chunk=1, pixel_rows_per_block=S, need_p2f=True)
    p2f_err = 0.0
    for seed in (1, 3):      # phase 3's scenes, every tile within the cap
        fv_s, tex_s = sphere_scenes(rend, template, SCENE_B, 36, seed, dev)
        most = check_cap(fv_s, "p2f sphere scene")
        with torch.no_grad():
            raster_kernel.P2F_LAUNCHES = 0
            out = raster_kernel.soft_rasterize_fwd(fv_s, tex_s, mf_cap=cap,
                                                   need_p2f=True, **rkw)
            torch.cuda.synchronize()
            assert raster_kernel.P2F_LAUNCHES == 1
            ref = soft_rasterize(fv_s, tex_s, **pkw)
        p2f_err = max(p2f_err, p2f_check(
            f"sphere scenes B={SCENE_B} S={S} T2=36 F={F} seed {seed} "
            f"(fullest tile {most})", out, ref))
    _, g_p2f, _ = golden_soft_rasterize(gf, gt, **gkw)
    out = raster_kernel.soft_rasterize_fwd(
        torch.as_tensor(gf, device=dev), torch.as_tensor(gt, device=dev),
        mf_cap=32, need_p2f=True, **gkw)
    p2f_golden = float(np.abs(out.p2f.cpu().numpy() - g_p2f).max())
    msg = (f"golden oracle p2f: max |diff| {p2f_golden:.3e} grid units "
           f"(<= {P2F_ATOL})")
    print(msg, flush=True)
    assert p2f_golden <= P2F_ATOL, msg

    phase("10. the stage-1 slice: train_s1.run (batch 64, 256^2 with "
          "512^2 AA renders, F=1280, T2=36; 2 epochs of 3 batches, the "
          "template updated after each)")
    from umr_tpu_torch.experiments import train_s1

    s1cfg = train_s1.config([
        "--batch_size", str(S1_BATCH), "--image_size", str(IMAGE_SIZE),
        "--subdivide", str(SUBDIVIDE), "--tex_size", "6",
        "--num_epochs", str(S1_EPOCHS), "--update_template_freq", "1",
        "--print_freq", "1"])
    s1loader = [synthetic_batch(data_rng, S1_BATCH, IMAGE_SIZE)
                for _ in range(S1_BATCHES)]
    n1 = S1_BATCHES * S1_EPOCHS
    torch.cuda.reset_peak_memory_stats()
    raster_kernel.LAUNCHES = raster_kernel.BWD_LAUNCHES = 0
    raster_kernel.P2F_LAUNCHES = 0
    t0 = time.perf_counter()
    s1_trainer = train_s1.run(s1cfg, s1loader, device=dev)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    s1_fwd, s1_bwd, s1_p2f = (raster_kernel.LAUNCHES,
                              raster_kernel.BWD_LAUNCHES,
                              raster_kernel.P2F_LAUNCHES)
    s1_state = s1_trainer.state
    print(f"train_s1.run: {s1_state.step} steps in {run_s:.2f} s incl. "
          f"set-up and {len(s1_trainer.template_updates)} template updates "
          f"{s1_trainer.template_updates} (epoch, images); raster_fwd "
          f"launches {s1_fwd} ({s1_p2f} with p2f), raster_bwd launches "
          f"{s1_bwd} (expected 3 (1 with p2f) and 2 per step)")
    assert s1_state.step == s1_state.updates == n1
    assert (s1_fwd, s1_bwd, s1_p2f) == (3 * n1, 2 * n1, n1)
    assert s1_trainer.template_updates == [
        (e, S1_BATCH * S1_BATCHES) for e in range(S1_EPOCHS)]
    for sc in s1_trainer.history:
        assert all(math.isfinite(v) for v in sc.values()), sc
        assert sc["tex_cycle_loss"] > 0, sc
    moved = (s1_state.model.mean_v.cpu()
             - torch.as_tensor(template.mean_v_init)).abs().max().item()
    print(f"template mean_v moved by up to {moved:.3e}")
    assert moved > 0
    first, last = s1_trainer.history[0], s1_trainer.history[-1]
    print("s1 step 1 scalars: " + ", ".join(f"{k} {v:.4f}"
                                             for k, v in first.items()))
    print(f"s1 step {n1} total_loss {last['total_loss']:.4f}")

    raster_kernel.LAUNCHES = raster_kernel.BWD_LAUNCHES = 0
    raster_kernel.P2F_LAUNCHES = 0
    s1_batches = [prepare_batch(b, s1cfg.use_scops, s1cfg.use_texture)
                  for b in s1loader]
    s1_ms, s1_times, s1_state = timed_steps(
        s1_trainer.step_fn, s1_state, s1_batches, TIMED_STEPS,
        float(S1_EPOCHS))
    assert (raster_kernel.LAUNCHES, raster_kernel.BWD_LAUNCHES,
            raster_kernel.P2F_LAUNCHES) == (
        3 * (TIMED_STEPS + 1), 2 * (TIMED_STEPS + 1), TIMED_STEPS + 1)
    s1_imgs = S1_BATCH / (s1_ms / 1e3)
    s1_peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"s1 training step, batch {S1_BATCH}: median {s1_ms:.2f} ms over "
          f"{TIMED_STEPS} steps after 1 warm-up (min {min(s1_times):.2f}, "
          f"max {max(s1_times):.2f}), {s1_imgs:.1f} images/s; peak device "
          f"memory {s1_peak:.2f} GB; TF32 off [{smi}]")
    s1_box = [s1_state]

    def one_s1_step():
        s1_box[0], _ = s1_trainer.step_fn(s1_box[0], s1_batches[0],
                                          float(S1_EPOCHS))

    s1_trace = trace_split(one_s1_step, "s1.", s1_ms, smi, "s1 step")

    phase("11. p2f at the s1 fused render's shape (64 images, 512^2, T2=36)")
    model1 = s1_box[0].model
    tex_r = SoftRenderer(image_size=IMAGE_SIZE).ambient_light_only()
    db1 = {k: torch.as_tensor(v, device=dev) for k, v in s1_batches[0].items()}
    with torch.no_grad():
        model1.train()
        o1 = model1(db1["input_img"],
                    generator=torch.Generator(dev).manual_seed(4))
        pv1 = (symmetrize(model1.mean_v, template)[None]
               + symmetrize(o1["delta_v"], template))
        fv1 = tex_r.project_faces(pv1, faces, o1["cam"]).contiguous()
        tx1 = sample_textures(o1["tex_flow"], db1["img"]).reshape(
            S1_BATCH, F, 36, 3).contiguous()
        bins1 = compute_raster_bins(fv1, S, raster_kernel.TILE_SIZE,
                                    rend.sigma_val, rend.dist_eps, cap,
                                    raster_kernel.MAX_COVER)
        del o1, pv1
    # the main path's bins keep at most `cap` faces per tile, a face in at
    # most MAX_COVER tiles per axis and 8 F entries per image, as the TPU
    # kernel's; the plain version renders every face. At the s1 model's
    # early meshes (large, crossing faces) those caps bite: count what
    # they drop, and hold kernel and plain on bins that drop nothing
    tx = S // raster_kernel.TILE_SIZE

    def full_bins(fv_):
        return compute_raster_bins(
            fv_, S, raster_kernel.TILE_SIZE, rend.sigma_val, rend.dist_eps,
            F, tx, F * tx * tx + 8 * tx * tx)

    with torch.no_grad():
        kept = (bins1[0] < F).sum(1)
        every = (full_bins(fv1)[0] < F).sum(1)
    dropped = every - kept
    s1_over = int((dropped > 0).sum())
    print(f"s1 fused render: {s1_over} of {S1_BATCH} images lose (face, "
          f"tile) entries to the bins' caps ({int(dropped.sum())} of "
          f"{int(every.sum())}; per image at most {int(dropped.max())}; "
          f"fullest tile {int(fullest_tiles(fv1).max())} of cap {cap}): "
          "the kernels render what the TPU kernel renders there", flush=True)
    sel = torch.linspace(0, S1_BATCH - 1, P2F_SLICE,
                         device=dev).round().long()
    sl_fv, sl_tex = fv1[sel].contiguous(), tx1[sel].contiguous()
    with torch.no_grad():
        sl_bins = full_bins(sl_fv)
        p2f_slice_ms, out = cuda_time(
            lambda: raster_kernel.soft_rasterize_fwd(
                sl_fv, sl_tex, mf_cap=F, bins=sl_bins, need_p2f=True,
                **rkw), 20)
        p2f_plain_ms, ref = cuda_time(
            lambda: soft_rasterize(sl_fv, sl_tex, **pkw), 1, warmup=0)
    name = (f"s1 fused slice: {P2F_SLICE} images (images {sel.tolist()}, "
            "on bins that drop nothing)")
    max_err = max(max_err, compare(name, out, ref, False))
    p2f_err = max(p2f_err, p2f_check(name, out, ref))
    slice_bound = raster_bound(
        pair_counts(sl_fv, sl_bins, S, F, rend.sigma_val, rend.dist_eps),
        sl_fv, sl_tex, sl_bins, S, p2f=True)
    print(f"s1 fused slice: p2f kernel {p2f_slice_ms:.3f} ms, plain "
          f"(face_chunk=1) {p2f_plain_ms:.1f} ms, bound "
          f"{slice_bound[0]:.3f} ms ({slice_bound[1]}) [{smi}]")
    del out, ref

    # the p2f instance against the p2f-free one on the same 64 images and
    # bins, in turns (without, with, with, without)
    def fwd(need):
        return lambda: raster_kernel.soft_rasterize_fwd(
            fv1, tx1, mf_cap=cap, bins=bins1, need_p2f=need, **rkw)

    with torch.no_grad():
        turns = [cuda_time(fwd(need), 10)[0]
                 for need in (False, True, True, False)]
    ms_nop2f, ms_p2f = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
    s1_counts = counts_of(fv1, bins1)
    b_p2f = raster_bound(s1_counts, fv1, tx1, bins1, S, p2f=True)
    b_nop2f = raster_bound(s1_counts, fv1, tx1, bins1, S)
    print(f"s1 fused render, {S1_BATCH} images (slots, pairs in bbox, past "
          f"the threshold, in depth: {s1_counts}): forward kernel with p2f "
          f"{ms_p2f:.3f} ms (bound {b_p2f[0]:.3f} ms, {b_p2f[1]}), without "
          f"{ms_nop2f:.3f} ms (bound {b_nop2f[0]:.3f} ms); turns "
          + ", ".join(f"{t:.3f}" for t in turns) + f" ms [{smi}]")
    del fv1, tx1, bins1, model1, s1_trainer, s1_box, s1_state
    torch.cuda.empty_cache()

    phase("12. one s2 step with cycle_soft_p2f (batch 16, full s2 width)")
    from umr_tpu_torch.training.steps import build_s2_step

    _, _, _, init_c, step_c = build_s2_step(
        tcfg.replace(cycle_soft_p2f=True), template, part_loss, pvi, dev)
    state_c = init_c(tcfg.seed)
    raster_kernel.LAUNCHES = raster_kernel.BWD_LAUNCHES = 0
    raster_kernel.P2F_LAUNCHES = 0
    state_c, sc = step_c(state_c, prepare_batch(tloader[0]))
    torch.cuda.synchronize()
    cyc_launches = (raster_kernel.LAUNCHES, raster_kernel.BWD_LAUNCHES,
                    raster_kernel.P2F_LAUNCHES)
    sc = {k: v.item() for k, v in sc.items()}
    print(f"cycle_soft_p2f step: raster_fwd launches {cyc_launches[0]} "
          f"({cyc_launches[2]} with p2f), raster_bwd launches "
          f"{cyc_launches[1]} (expected 4 (1 with p2f) and 2); "
          f"tex_cycle_loss {sc['tex_cycle_loss']:.4f} (flag off, step 1 of "
          f"phase 7: {first_s2['tex_cycle_loss']:.4f}), total_loss "
          f"{sc['total_loss']:.4f}")
    assert cyc_launches == (4, 2, 1), cyc_launches
    assert all(math.isfinite(v) for v in sc.values()), sc
    del state_c, step_c

    record = {"kernels": [{
        "name": "raster_fwd", "route": "cuda", "source": KERNEL_SRC,
        "replaces": TPU_KERNEL, "launches": train_fwd,
        "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": fwd_bound, "bound_by": fwd_by, "library_ms": None,
        "ms_includes_binning": True, "binning_ms": ms_bins,
        "kernel_ms": ms_kernel, "inference_launches": launches,
        "demo_ms": ms_demo, "demo_binning_ms": ms_demo_bins,
        "demo_plain_ms": plain_ms_demo,
        "test_iou_batch_ms": lat,
        "iou": iou,
        "test_iou_pair_counts": iou_counts,
        "fold_ms": shapes["fold"]["fwd_ms"],
        "fold_bound_ms": shapes["fold"]["fwd_bound"][0],
        "merged_ms": shapes["merged"]["fwd_ms"],
        "merged_bound_ms": shapes["merged"]["fwd_bound"][0],
        "s1_launches": s1_fwd, "p2f_launches": s1_p2f,
        "p2f_max_abs_err": p2f_err, "p2f_golden_err": p2f_golden,
        "p2f_ms": ms_p2f, "p2f_bound_ms": b_p2f[0], "p2f_bound_by": b_p2f[1],
        "p2f_free_ms": ms_nop2f, "p2f_free_bound_ms": b_nop2f[0],
        "p2f_turns_ms": turns, "p2f_pair_counts": s1_counts,
        "p2f_images_over_cap": s1_over,
        "p2f_slice_ms": p2f_slice_ms, "p2f_slice_plain_ms": p2f_plain_ms,
        "p2f_slice_bound_ms": slice_bound[0],
        "s1_step_ms": s1_ms, "s1_images_per_s": s1_imgs,
        "s1_peak_gb": s1_peak, "s1_split_ms": s1_trace["split"],
        "s1_raster_ms": s1_trace["raster"], "s1_busy_ms": s1_trace["busy_ms"],
        "s1_traced_ms": s1_trace["traced_ms"],
        "s1_idle_share": s1_trace["idle"], "s1_copy_ms": s1_trace["copy_ms"],
        "cycle_soft_p2f_launches": list(cyc_launches),
    }, {
        "name": "raster_bwd", "route": "cuda", "source": BWD_SRC,
        "replaces": BWD_TPU_KERNEL, "launches": train_bwd,
        "s1_launches": s1_bwd,
        "max_abs_err": bwd_err, "max_rel_err": bwd_rel,
        "ms": slices["fold"]["ms"], "plain_ms": slices["fold"]["plain_ms"],
        "bound_ms": slices["fold"]["bound"][0],
        "bound_by": slices["fold"]["bound"][1],
        "library_ms": None, "images": FOLD_SLICE,
        "merged_slice_ms": slices["merged"]["ms"],
        "merged_slice_plain_ms": slices["merged"]["plain_ms"],
        "merged_slice_bound_ms": slices["merged"]["bound"][0],
        "merged_slice_max_rel_err": slices["merged"]["max_rel"],
        "fold_ms": shapes["fold"]["bwd_ms"],
        "fold_images_over_cap": shapes["fold"]["over_cap"],
        "fold_bound_ms": shapes["fold"]["bwd_bound"][0],
        "fold_pair_counts": shapes["fold"]["counts"],
        "merged_ms": shapes["merged"]["bwd_ms"],
        "merged_bound_ms": shapes["merged"]["bwd_bound"][0],
        "merged_pair_counts": shapes["merged"]["counts"],
        "train_step_ms": step_ms, "train_images_per_s": imgs_s,
        "train_split_ms": split, "train_raster_ms": raster_split,
        "train_busy_ms": busy_ms, "train_traced_ms": traced_ms,
        "train_idle_share": idle, "train_copy_ms": copy_ms,
    }]}
    print(f"\n{smi}")
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
