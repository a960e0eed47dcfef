"""Smoke run of the PyTorch port on one NVIDIA GPU (H100): builds the CUDA
rasterizer kernels (forward, with its p2f instance, and backward) from
csrc/, holds each against its plain version at the main paths' shapes
(every forward and backward instance the training steps launch, on
8-image slices of the steps' own renders) and against the golden oracle,
drives the inference slice (test_iou.run at
full s2 width, batch 32; demo.render_panels), the stage-2 training slice
(train_s2.run at full s2 width, batch 16, 6 steps; one step with
cycle_soft_p2f), the stage-1 training slice (train_s1.run at full s1
width, batch 64, 2 epochs of 3 batches with two template updates) and the
stage handoff through files (avg_uv.run on stage 1's checkpoint,
train_s2.run from that template on disk with an auto-resume, test_iou.run
and test_kp.run on stage 2's checkpoint) and the synthetic category
(generate_dataset through the forward kernel, its renders held against
the plain version, CategoryLoader(device_data=True) against the host
loader, train_s2.run, avg_uv.run, test_iou.run and test_kp.run fed by
it) and the CUB path from files (a CUB-layout fixture written from the
category and the committed JPEGs decoded by nvJPEG, the threaded loader's
host split, then train_s1, avg_uv, train_s2, test_iou and test_kp with no
loader passed, with the trainers' visuals and --visualize) and the
training flag variants (each s2 and s1 variant's step: bf16, without
texture, without the GAN, az_ele_quat; the entry points under --bf16;
test_iou on a one-camera, untextured model; the kernels at the
variants' new shapes against the plain versions) and data parallelism
(train_s2.run in a one-rank NCCL group through parallel.launch; one s2
and one s1 step with the template update on two ranks sharing the card
over gloo, held against one process at the global batch) and tensor
parallelism with the checking tools (one s2 Adam step on two ranks as a
(1, 2) mesh against one process; dryrun_multichip 4 on the card;
check_fused_grads through the kernels; soak_train of both stages at full
width) and the off-path tools (profile_step at full width, each row's
launches; pretrain_trunk and pretrain_lpips on the category's images into
a temporary directory, their files loaded by build_s2_step's init_fn
under the weight overrides, weights/ untouched; voxelize on the card
against the CPU), checks that each path went through the kernels, and times kernels,
plain versions, the training steps and the handoff's entry points. Every
run writes into a fresh temporary directory.

  python3 chip_smoke.py
  python3 chip_smoke.py --cards N    # phases 17 and 18 on N cards (NCCL)
  python3 chip_smoke.py --cards N --phase 18    # phase 18's alone

Exits non-zero on any failure, and when no GPU is visible. The line
before the last is the kernel record (JSON); the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import os
import pickle
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
KERNEL_SRC = "umr_tpu_torch/csrc/raster_fwd.cu"
BINS_SRC = "umr_tpu_torch/csrc/raster_bins.cu"
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
BINS_REPS = 10           # traced binnings of one render, timed by kernel
# the stage-1 slice: train_s1.run at the Config default batch (64) and full
# width, 2 epochs of 3 batches with the template updated after each
S1_BATCH = 64
S1_BATCHES = 3
S1_EPOCHS = 2
P2F_SLICE = 8            # images of the s1 renders the plain p2f and the
                         # plain backward take
KP_PAIRS = 32            # test_kp's pairs in phases 13 and 14
# phase 14, the synthetic category: samples generated (batches of
# TRAIN_BATCH), images of each generator render held against the plain
# version, the device loader's epochs held against the host loader's,
# train_s2.run's steps on the device loader, and the bound on a device
# loader batch's host-to-device copies
GEN_N = 64
GEN_SLICE = 4
LOADER_EPOCHS = 2
CAT_STEPS = 3
HTOD_BATCH_LIMIT = 1 << 20
# phase 15, the CUB path from files: the fixture's birds per split, the
# entry points' steps and display cadence, the loader's keypoint check
# (as phase 14's hole check) and the JPEG reader's limits against PIL's
# decode (mean and 99th percentile of |diff|, in 8-bit levels: the IDCTs
# round apart by a level or two, the 4:2:0 chroma upsampling differs at
# colour edges)
CUB_TRAIN = 128
CUB_TEST = 32
CUB_S1_STEPS = 4
CUB_S1_DISPLAY = 2
CUB_S2_STEPS = 6
CUB_S2_DISPLAY = 3
KP_INSIDE = 0.95
JPEG_MEAN_LIMIT, JPEG_P99_LIMIT = 1.0, 4.0

RGBA_ATOL = 1e-3      # kernel vs plain: reductions run in another order
AGGR_RTOL = 1e-4      # softmax (sum, max)
HARD_SHARE = 0.999    # face ids and depths equal on covered pixels
# backward kernel vs plain: the kernel sums each face's pixels per lane,
# over the warp (shuffles) and over tiles (global atomics), in an order
# that changes run to run; the plain version per face chunk. Each
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
    """Kernel output vs plain version; returns the readings: max |rgba|
    difference ("rgba") and the hard body's share of covered pixels with
    equal face id and depth ("hard_equal") or the softmax sum's and max's
    largest relative difference ("sum_rel", "max_rel")."""
    err = (out.rgba - ref.rgba).abs().max().item()
    got = {"rgba": err}
    msg = f"{name}: rgba max|diff| {err:.3e} (<= {RGBA_ATOL})"
    assert err <= RGBA_ATOL, msg
    if hard:
        cov = ref.aggr[:, 1] >= 0
        same = ((out.aggr[:, 1] == ref.aggr[:, 1])
                & (out.aggr[:, 0] == ref.aggr[:, 0]))
        got["hard_equal"] = share = same[cov].float().mean().item()
        msg += (f"; face id + depth equal on {share:.6f} of "
                f"{int(cov.sum())} covered pixels (>= {HARD_SHARE})")
        assert share >= HARD_SHARE, msg
    else:
        rel = ((out.aggr - ref.aggr).abs() / ref.aggr.abs()).amax(
            dim=(0, 2, 3))
        got["sum_rel"], got["max_rel"] = rel[0].item(), rel[1].item()
        msg += (f"; softmax sum rel {rel[0].item():.3e}, max rel "
                f"{rel[1].item():.3e} (<= {AGGR_RTOL})")
        assert rel.max().item() <= AGGR_RTOL, msg
    print(msg, flush=True)
    return got


def grad_check(name, got, want, opts):
    """The backward kernel's (grad faces, grad texels) against the plain
    version's, per lane group against the group's own scale; a group the
    mode does not compute is zero on both sides. Returns (max |diff|,
    max |diff| / the group's scale) over the groups."""
    from umr_tpu_torch.experiments.raster_bound import lanes

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


def timed_avg_uv(avg_uv, ucfg, loader, dev):
    """avg_uv.run with pass 1 split per batch, each part on the wall clock
    with the card synchronised at its ends: the host's batch preparation
    (prepare_batch), the copies to the card (prep's end to the score's
    start), the scoring on the card (score_batch: the model, the render,
    LPIPS, the UV transfer) and the read-back of scores and fp16 maps
    (the score's end to the next batch's prep; the last batch's to the
    pass's end, so it also holds the concatenation of the pass's maps).
    Returns (run seconds, pass 1 seconds, {part: [seconds per batch]})."""
    prep, score, search = (avg_uv.prepare_batch, avg_uv.score_batch,
                           avg_uv.exemplar_search)
    split = {k: [] for k in ("prep", "copy", "device", "readback")}
    marks = {}

    def close_batch(t):
        if "score_end" in marks:
            split["readback"].append(t - marks.pop("score_end"))

    def timed_prep(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        close_batch(t0)
        out = prep(*a, **k)
        marks["prep_end"] = time.perf_counter()
        split["prep"].append(marks["prep_end"] - t0)
        return out

    def timed_score(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        split["copy"].append(t0 - marks.pop("prep_end"))
        out = score(*a, **k)
        torch.cuda.synchronize()
        marks["score_end"] = time.perf_counter()
        split["device"].append(marks["score_end"] - t0)
        return out

    def timed_search(*a):
        t0 = time.perf_counter()
        out = search(*a)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        close_batch(t1)
        marks["pass1"] = t1 - t0
        return out

    avg_uv.prepare_batch, avg_uv.score_batch = timed_prep, timed_score
    avg_uv.exemplar_search = timed_search
    t0 = time.perf_counter()
    try:
        avg_uv.run(ucfg, loader, device=dev)
    finally:
        avg_uv.prepare_batch, avg_uv.score_batch = prep, score
        avg_uv.exemplar_search = search
    return time.perf_counter() - t0, marks["pass1"], split


def timed_kp_groups(test_kp, kcfg, pairs, dev, split=False):
    """test_kp.run with each group's transfer_group timed on the wall
    clock, the card synchronised at its ends (ms per group, "total").
    With split=True also the host's normalisation of the group's images,
    the model's forward, the render and the keypoint maps (map_kp_flow /
    map_kp_cam, summed over the group's pairs), each synchronised at its
    ends, and the rest of the group (the input's copy to the card, the
    stacks, the read-back)."""
    group_fn, build, renderer_cls, norm = (
        test_kp.transfer_group, test_kp.build_eval_model,
        test_kp.SoftRenderer, test_kp.normalize_images)
    maps = {"flow": test_kp.map_kp_flow, "cam": test_kp.map_kp_cam}
    parts = (("total", "normalise", "model", "render", "maps") if split
             else ("total",))
    out = {k: [] for k in parts}
    acc = dict.fromkeys(parts, 0.0)

    def timed(name, fn):
        def run(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn(*a, **k)
            torch.cuda.synchronize()
            acc[name] += 1e3 * (time.perf_counter() - t0)
            return res
        return run

    def timed_group(*a, **k):
        for name in parts:
            acc[name] = 0.0
        res = timed("total", group_fn)(*a, **k)
        for name in parts:
            out[name].append(acc[name])
        return res

    def timed_build(*a, **k):
        model = build(*a, **k)
        model.forward = timed("model", model.forward)
        return model

    class TimedRenderer(renderer_cls):
        def render(self, *a, **k):
            return timed("render", super().render)(*a, **k)

    test_kp.transfer_group = timed_group
    if split:
        test_kp.build_eval_model = timed_build
        test_kp.SoftRenderer = TimedRenderer
        test_kp.normalize_images = timed("normalise", norm)
        test_kp.map_kp_flow = timed("maps", maps["flow"])
        test_kp.map_kp_cam = timed("maps", maps["cam"])
    try:
        test_kp.run(kcfg, pairs, device=dev)
    finally:
        test_kp.transfer_group = group_fn
        test_kp.build_eval_model, test_kp.SoftRenderer = build, renderer_cls
        test_kp.normalize_images = norm
        test_kp.map_kp_flow, test_kp.map_kp_cam = maps["flow"], maps["cam"]
    if split:
        out["rest"] = [out["total"][i] - sum(out[k][i] for k in parts[1:])
                       for i in range(len(out["total"]))]
    return out


def handoff(dev, smi, template, s1_pth, s1loader, tcfg, tloader, cfg,
            loader):
    """Phase 13: avg_uv.run on stage 1's checkpoint over stage 1's loader,
    train_s2.run from that template on disk at tcfg (refused without
    force_template: the template is dead; 3 steps, then to 6 steps,
    resumed), test_iou.run over `loader` and test_kp.run in both modes on
    stage 2's checkpoint, each path's launches asserted. Returns the
    readings."""
    from umr_tpu_torch.config import normalize_images
    from umr_tpu_torch.data import synthetic_batch
    from umr_tpu_torch.experiments import avg_uv, test_iou, test_kp, train_s2
    from umr_tpu_torch.ops import raster_kernel

    t_phase = time.perf_counter()
    stemp = tempfile.mkdtemp()
    ucfg = tcfg.replace(model_path=s1_pth, out_dir=stemp)
    raster_kernel.LAUNCHES = raster_kernel.BWD_LAUNCHES = 0
    uv_s, pass1_s, split = timed_avg_uv(avg_uv, ucfg, s1loader, dev)
    uv_launches = (raster_kernel.LAUNCHES, raster_kernel.BWD_LAUNCHES)
    counts = {n: len(np.load(os.path.join(stemp, f"{n}_vertices.npy")))
              for n in avg_uv.PART_NAMES}
    min_cnt = math.ceil(ucfg.part_min_vert_frac * template.num_verts)
    # after the first batch (warm-up); the last read-back holds the
    # pass's concatenation
    steady = {k: 1e3 * float(np.median(v[:-1] if k == "readback" else v[1:]))
              for k, v in split.items()}
    print(f"avg_uv.run: {len(s1loader)} batches of {S1_BATCH} in "
          f"{uv_s:.2f} s; pass 1 {pass1_s:.3f} s, "
          f"{pass1_s / len(s1loader):.3f} s/batch; per batch (ms, the first "
          f"included): "
          + "; ".join(f"{k} " + ", ".join(f"{1e3 * t:.1f}" for t in v)
                      for k, v in split.items())
          + "; median after the first (read-back: but the last): "
          + ", ".join(f"{k} {t:.1f}" for k, t in steady.items())
          + f"; part vertex counts {counts} (the bar: {min_cnt}); "
          f"raster_fwd launches {uv_launches[0]}, raster_bwd "
          f"{uv_launches[1]} (expected {len(s1loader)} and 0) [{smi}]",
          flush=True)
    assert uv_launches == (len(s1loader), 0), uv_launches
    for f in ("semantic_prob.npy", "semantic_seg.png", "mean_v.pth",
              "mean_template.obj", "vertex_label.obj"):
        assert os.path.exists(os.path.join(stemp, f)), f
    # why the template is dead: the UV flow's spread over one batch, in
    # eval mode (avg_uv's: the BatchNorms' running statistics of six
    # steps) and in train mode (the batch's statistics)
    model = avg_uv.load_s1_model(ucfg, template, dev)
    x = torch.as_tensor(normalize_images(
        s1loader[0]["img"].astype(np.float32)), device=dev)
    flow_std = {}
    with torch.no_grad():
        for mode in ("eval", "train"):
            model.train(mode == "train")
            flow = model(x, generator=torch.Generator(dev).manual_seed(0))[
                "uvimage_pred"]
            flow_std[mode] = float(flow.std(dim=(1, 2)).mean())
    del model
    print(f"the s1 model's UV flow, std over a batch's UV images (grid "
          f"units, mean over images and axes): eval {flow_std['eval']:.3g},"
          f" train {flow_std['train']:.3g}", flush=True)
    # a dead template, refused
    assert min(counts.values()) < min_cnt, counts
    try:
        train_s2.run(tcfg.replace(stemp_path=stemp,
                                  checkpoint_dir=tempfile.mkdtemp(),
                                  name="s2", num_iter=3), tloader, device=dev)
    except ValueError as e:
        assert "liveliness bar" in str(e), e
        print("train_s2.run refuses the template without "
              "--force_template: " + str(e).split(":")[0])
    else:
        raise AssertionError("train_s2.run took a starved template")

    s2cfg = tcfg.replace(stemp_path=stemp, checkpoint_dir=tempfile.mkdtemp(),
                         name="s2", num_iter=3)
    s2_dir = os.path.join(s2cfg.checkpoint_dir, s2cfg.name)
    raster_kernel.LAUNCHES = raster_kernel.BWD_LAUNCHES = 0
    t0 = time.perf_counter()
    first_run = train_s2.run(s2cfg.replace(force_template=True), tloader,
                             device=dev)
    torch.cuda.synchronize()
    s2a_s = time.perf_counter() - t0
    s2a = (raster_kernel.LAUNCHES, raster_kernel.BWD_LAUNCHES)
    assert first_run.state.step == 3 and len(first_run.history) == 3
    assert s2a == (9, 6), s2a
    del first_run
    raster_kernel.LAUNCHES = raster_kernel.BWD_LAUNCHES = 0
    t0 = time.perf_counter()
    resumed = train_s2.run(s2cfg.replace(force_template=True, num_iter=6),
                           tloader, device=dev)
    torch.cuda.synchronize()
    s2b_s = time.perf_counter() - t0
    s2b = (raster_kernel.LAUNCHES, raster_kernel.BWD_LAUNCHES)
    s2_log = open(os.path.join(s2_dir, "loss_log.txt")).read()
    budget = json.load(open(os.path.join(s2_dir, "stage_budget.json")))
    print(f"train_s2.run from {stemp}: 3 steps in {s2a_s:.2f} s, launches "
          f"{s2a}; again at num_iter=6: resumed at step 3, "
          f"{len(resumed.history)} steps in {s2b_s:.2f} s, launches {s2b} "
          f"(expected 3 and 2 per step); wrote {sorted(os.listdir(s2_dir))}; "
          f"stage budget of the resumed run {budget} [{smi}]", flush=True)
    assert resumed.state.step == 6 and len(resumed.history) == 3
    assert s2b == (9, 6), s2b
    for sc in resumed.history:
        assert all(math.isfinite(v) for v in sc.values()), sc
    for f in ("pred_net_latest.pth", "pred_state.pt", "opts.log"):
        assert os.path.exists(os.path.join(s2_dir, f)), f
    assert s2_log.count("corr_loss: ") == 6, s2_log
    assert "dispatch_s_per_step" in budget and "drain_s_per_step" in budget
    del resumed
    torch.cuda.empty_cache()

    s2_pth = os.path.join(s2_dir, "pred_net_latest.pth")
    raster_kernel.LAUNCHES = 0
    t0 = time.perf_counter()
    s2_iou = test_iou.run(cfg.replace(model_path=s2_pth), loader, device=dev)
    torch.cuda.synchronize()
    s2_iou_s = time.perf_counter() - t0
    iou_launches = raster_kernel.LAUNCHES
    print(f"test_iou.run on stage 2's checkpoint: IoU {s2_iou:.4f} over "
          f"{len(loader)} batches of {cfg.batch_size} in {s2_iou_s:.2f} s; "
          f"raster_fwd launches {iou_launches} (expected {len(loader)})")
    assert math.isfinite(s2_iou) and iou_launches == len(loader)

    pair_rng = np.random.RandomState(5)
    pairs = tuple([synthetic_batch(pair_rng, 1, cfg.image_size)
                   for _ in range(KP_PAIRS)] for _ in range(2))
    kcfg = cfg.replace(model_path=s2_pth, number_pairs=KP_PAIRS)
    groups = -(-KP_PAIRS // 16)
    kp = {}
    for mode in ("flow", "cam"):
        raster_kernel.LAUNCHES = raster_kernel.BWD_LAUNCHES = 0
        t0 = time.perf_counter()
        pck = test_kp.run(kcfg.replace(mode=mode), pairs, device=dev)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches = (raster_kernel.LAUNCHES, raster_kernel.BWD_LAUNCHES)
        want = (groups if mode == "cam" else 0, 0)
        per_group = timed_kp_groups(test_kp, kcfg.replace(mode=mode), pairs,
                                    dev)
        kp_split = timed_kp_groups(test_kp, kcfg.replace(mode=mode), pairs,
                                   dev, split=True)
        kp[mode] = dict(pck=pck, launches=launches[0], run_s=first_s,
                        group_ms=per_group, split_ms=kp_split)
        print(f"test_kp.run {mode}: PCK@0.1 {pck[0]:.4f}, PCK@0.15 "
              f"{pck[1]:.4f} over {KP_PAIRS} pairs ({groups} groups of 16) "
              f"in {first_s:.3f} s with the model load; a group of 16 pairs "
              f"(transfer_group, synchronised at its ends, after that run): "
              + ", ".join(f"{t:.1f}" for t in per_group["total"])
              + " ms; in a further run with each part synchronised (ms per "
              f"group): " + "; ".join(
                  f"{k} " + ", ".join(f"{t:.1f}" for t in v)
                  for k, v in kp_split.items())
              + f"; launches {launches} (expected {want}) [{smi}]",
              flush=True)
        assert launches == want, launches
        assert 0.0 <= pck[0] <= pck[1] <= 1.0
    handoff_s = time.perf_counter() - t_phase
    print(f"phase 13: {handoff_s:.1f} s [{smi}]", flush=True)
    return dict(uv_launches=uv_launches[0], uv_s=uv_s,
                pass1_s_per_batch=pass1_s / len(s1loader),
                pass1_split_s=split, pass1_steady_ms=steady,
                part_counts=counts, flow_std=flow_std,
                resume_launches=list(s2b), iou_launches=iou_launches, kp=kp,
                phase_s=handoff_s)


def htod_bytes(events):
    """Bytes of a torch.profiler trace's host-to-device copies."""
    return sum(int(e.get("args", {}).get("bytes", 0)) for e in events
               if e.get("cat") == "gpu_memcpy" and "HtoD" in e["name"])


def category(dev, smi, template, tcfg, s1_pth):
    """Phase 14: the synthetic category on the card. generate_dataset
    (3 forward launches per batch, no backward), its first batch's three
    renders recorded as the kernel receives them, GEN_SLICE images of
    each held against the plain version, CategoryLoader(device_data=True)
    against the host loader bit for bit, the host-to-device bytes per
    batch of each (torch.profiler), then train_s2.run, avg_uv.run on
    phase 10's checkpoint, test_iou.run and test_kp.run (cam) fed by the
    category's loaders, each path's launches asserted. Returns the
    readings."""
    from umr_tpu_torch.data.synthetic_category import (
        CategoryLoader, PairLoader, generate_dataset, make_pair_orders)
    from umr_tpu_torch.experiments import avg_uv, test_iou, test_kp, train_s2
    from umr_tpu_torch.experiments.profile_slice import trace_events
    from umr_tpu_torch.experiments.raster_bench import (
        render_bounds, render_fwd, step_renders, synthetic_semantic)
    from umr_tpu_torch.experiments.synthetic_parity import (identity_pck,
                                                            pair_keypoints)
    from umr_tpu_torch.ops import raster_kernel
    from umr_tpu_torch.ops.rasterize import soft_rasterize
    from umr_tpu_torch.training.trainer import BatchPrep

    t_phase = time.perf_counter()
    n_b = -(-GEN_N // TRAIN_BATCH)
    stats = {}
    raster_kernel.LAUNCHES = raster_kernel.BWD_LAUNCHES = 0
    t0 = time.perf_counter()
    data = generate_dataset(template, GEN_N, seed=0, image_size=IMAGE_SIZE,
                            batch=TRAIN_BATCH, device=dev, stats=stats)
    gen_s = time.perf_counter() - t0
    gen = (raster_kernel.LAUNCHES, raster_kernel.BWD_LAUNCHES)
    holes = [1.0 - f for f in stats["verts_inside"]]
    cover = data["mask"].mean(axis=(1, 2))
    print(f"generate_dataset: {GEN_N} samples in {n_b} batches of "
          f"{TRAIN_BATCH} at {IMAGE_SIZE}^2 in {gen_s:.2f} s (renders and "
          f"hole check per batch, s: "
          + ", ".join(f"{t:.3f}" for t in stats["render_s"])
          + "); share of projected vertices outside the masks per batch: "
          + ", ".join(f"{h:.4f}" for h in holes)
          + f" (bar <= {1 - 0.95:.2f}); mask coverage {cover.min():.3f}.."
          f"{cover.max():.3f}; raster_fwd launches {gen[0]}, raster_bwd "
          f"{gen[1]} (expected 3 and 0 per batch) [{smi}]", flush=True)
    assert gen == (3 * n_b, 0), gen
    for k in ("img", "mask", "part_prob", "dts_barrier", "kp"):
        assert np.isfinite(data[k]).all(), k
    assert data["part_prob"].shape == (GEN_N, IMAGE_SIZE, IMAGE_SIZE, 5)
    assert ((cover > 0.02) & (cover < 0.8)).all(), cover

    # the first batch again, its renders recorded as the kernel gets them
    with step_renders(("image", "part A", "part B")) as gr:
        first = generate_dataset(template, TRAIN_BATCH, seed=0,
                                 image_size=IMAGE_SIZE, batch=TRAIN_BATCH,
                                 device=dev)
    for k in ("img", "mask", "part_prob", "kp"):
        assert np.array_equal(first[k], data[k][:TRAIN_BATCH]), k
    renders = {}
    for label, r in gr.items():
        kw = r["kw"]
        S = kw["image_size"]
        # the generator's own bins are the renderer's full bins
        most = int(torch.diff(r["bins"][1], dim=1).max())
        ms_k, _ = cuda_time(lambda: render_fwd(r), 10)
        counts, fb, _ = render_bounds(r)
        sl = dict(r, fv=r["fv"][:GEN_SLICE].contiguous(),
                  tex=r["tex"][:GEN_SLICE].contiguous(),
                  bins=tuple(b[:GEN_SLICE].contiguous() for b in r["bins"]))
        ms_s, out = cuda_time(lambda: render_fwd(sl), 10)
        plain_kw = {k: kw[k] for k in (
            "image_size", "background_color", "sigma_val", "dist_eps",
            "gamma_val", "aggr_func_rgb")}
        with torch.no_grad():
            ms_p, ref = cuda_time(lambda: soft_rasterize(
                sl["fv"], sl["tex"], **plain_kw), 1, warmup=0)
        got = compare(
            f"generator {label} render: {GEN_SLICE} images on the "
            f"generator's own bins (every face a tile reaches; fullest "
            f"tile {most} faces)", out, ref, False)
        renders[label] = dict(got, ms=ms_k, bound_ms=fb[0], bound_by=fb[1],
                              slice_ms=ms_s, slice_plain_ms=ms_p,
                              fullest_tile=most, counts=counts)
        print(f"generator {label} render, {TRAIN_BATCH} images at {S}^2: "
              f"forward kernel {ms_k:.3f} ms (bound {fb[0]:.3f} ms, "
              f"{fb[1]}; slots, pairs in bbox, past the threshold, in "
              f"depth: {counts}); {GEN_SLICE}-image slice: kernel "
              f"{ms_s:.3f} ms, plain {ms_p:.1f} ms [{smi}]", flush=True)
        assert most <= kw["mf_cap"], (most, kw["mf_cap"])
    del gr, first

    # the device loader against the host loader, bit for bit
    kw = dict(batch_size=TRAIN_BATCH, seed=20, use_scops=True)
    host = CategoryLoader(data, **kw)
    devl = CategoryLoader(data, device_data=True, device=dev, **kw)
    t0 = time.perf_counter()
    devl._device_arrays()
    torch.cuda.synchronize()
    stage_s = time.perf_counter() - t0
    staged_mb = sum(v.numel() * v.element_size()
                    for v in devl._dev.values()) / 1e6
    n_cmp = 0
    for _ in range(LOADER_EPOCHS):
        for bh, bd in zip(host, devl):
            assert set(bh) == set(bd)
            for k, v in bh.items():
                got = bd[k]
                if torch.is_tensor(got):
                    assert got.device == dev, (k, got.device)
                    got = got.cpu().numpy()
                assert got.dtype == v.dtype and np.array_equal(got, v), k
            n_cmp += 1
    assert n_cmp == LOADER_EPOCHS * len(host) and devl._epoch == LOADER_EPOCHS

    def feed(loader):
        def run():
            prep = BatchPrep(device=dev)
            for b in loader:
                prep(b)
            torch.cuda.synchronize()
        return run

    htod = {}
    for name, device_data in (("device", True), ("host", False)):
        ld = CategoryLoader(data, device_data=device_data, device=dev, **kw)
        events, _ = trace_events(feed(ld), 1)
        htod[name] = htod_bytes(events) / len(ld)
    print(f"CategoryLoader(device_data=True): {staged_mb:.1f} MB staged in "
          f"{stage_s:.3f} s; {n_cmp} batches over {LOADER_EPOCHS} epochs "
          f"equal to the host loader's bit for bit; host-to-device bytes "
          f"per batch through the trainer's BatchPrep "
          f"(profiler): device loader {htod['device']:.0f}, host loader "
          f"{htod['host']:.0f} (device loader < {HTOD_BATCH_LIMIT})",
          flush=True)
    assert htod["device"] < HTOD_BATCH_LIMIT, htod
    assert htod["host"] > HTOD_BATCH_LIMIT, htod   # the trace sees bytes

    seg, pvi = synthetic_semantic(template)
    ccfg = tcfg.replace(num_iter=CAT_STEPS, checkpoint_dir=tempfile.mkdtemp(),
                        name="s2", use_scops=True)
    loader2 = CategoryLoader(data, TRAIN_BATCH, seed=20, use_scops=True,
                             device_data=True, device=dev)
    raster_kernel.LAUNCHES = raster_kernel.BWD_LAUNCHES = 0
    t0 = time.perf_counter()
    trainer = train_s2.run(ccfg, loader2, device=dev,
                           semantic=(None, seg, pvi))
    torch.cuda.synchronize()
    s2_s = time.perf_counter() - t0
    s2 = (raster_kernel.LAUNCHES, raster_kernel.BWD_LAUNCHES)
    s2_dir = os.path.join(ccfg.checkpoint_dir, ccfg.name)
    budget = json.load(open(os.path.join(s2_dir, "stage_budget.json")))
    budget7 = json.load(open(os.path.join(tcfg.checkpoint_dir, tcfg.name,
                                          "stage_budget.json")))
    print(f"train_s2.run on the device loader: {trainer.state.step} steps "
          f"in {s2_s:.2f} s incl. set-up; launches {s2} (expected 3 and 2 "
          f"per step); per step (stage_budget.json, s): prep "
          f"{budget['prep_s_per_step']}, transfer "
          f"{budget['transfer_s_per_step']}, loader "
          f"{budget['loader_s_per_step']} (phase 7, host batches: prep "
          f"{budget7['prep_s_per_step']}, transfer "
          f"{budget7['transfer_s_per_step']}, loader "
          f"{budget7['loader_s_per_step']}) [{smi}]", flush=True)
    assert trainer.state.step == len(trainer.history) == CAT_STEPS
    assert s2 == (3 * CAT_STEPS, 2 * CAT_STEPS), s2
    for sc in trainer.history:
        assert all(math.isfinite(v) for v in sc.values()), sc
    del trainer
    torch.cuda.empty_cache()

    ucfg = tcfg.replace(model_path=s1_pth, out_dir=tempfile.mkdtemp())
    loader_uv = CategoryLoader(data, TRAIN_BATCH, shuffle=False,
                               use_scops=True, device_data=True, device=dev)
    raster_kernel.LAUNCHES = raster_kernel.BWD_LAUNCHES = 0
    uv_s, pass1_s, split = timed_avg_uv(avg_uv, ucfg, loader_uv, dev)
    uv = (raster_kernel.LAUNCHES, raster_kernel.BWD_LAUNCHES)
    steady = {k: 1e3 * float(np.median(v[:-1] if k == "readback" else v[1:]))
              for k, v in split.items()}
    # the read-back part also holds the loader's next batch: its part
    # points, sampled on the host
    print(f"avg_uv.run on the device loader: {len(loader_uv)} batches of "
          f"{TRAIN_BATCH} in {uv_s:.2f} s, pass 1 {pass1_s:.3f} s; per "
          f"batch after the first (ms; read-back, with the loader's next "
          f"batch and its host part points: but the last): "
          + ", ".join(f"{k} {t:.1f}" for k, t in steady.items())
          + f"; launches {uv} (expected {len(loader_uv)} and 0) [{smi}]",
          flush=True)
    assert uv == (len(loader_uv), 0), uv

    s2_pth = os.path.join(s2_dir, "pred_net_latest.pth")
    test_loader = CategoryLoader(data, TRAIN_BATCH, shuffle=False,
                                 use_scops=False, drop_last=False,
                                 device_data=True, device=dev)
    raster_kernel.LAUNCHES = 0
    t0 = time.perf_counter()
    iou = test_iou.run(ccfg.replace(model_path=s2_pth), test_loader,
                       device=dev)
    torch.cuda.synchronize()
    iou_s = time.perf_counter() - t0
    iou_launches = raster_kernel.LAUNCHES
    o1, o2 = make_pair_orders(GEN_N, KP_PAIRS, seed=303)
    raster_kernel.LAUNCHES = raster_kernel.BWD_LAUNCHES = 0
    t0 = time.perf_counter()
    pck = test_kp.run(ccfg.replace(model_path=s2_pth, number_pairs=KP_PAIRS,
                                   mode="cam"),
                      (PairLoader(data, o1), PairLoader(data, o2)),
                      device=dev)
    torch.cuda.synchronize()
    kp_s = time.perf_counter() - t0
    kp = (raster_kernel.LAUNCHES, raster_kernel.BWD_LAUNCHES)
    ident = identity_pck(pair_keypoints(data, o1, o2))
    groups = -(-KP_PAIRS // 16)
    print(f"test_iou.run on the category's device loader: IoU {iou:.4f} "
          f"over {len(test_loader)} batches in {iou_s:.2f} s, launches "
          f"{iou_launches} (expected {len(test_loader)}); test_kp.run cam on "
          f"{KP_PAIRS} PairLoader pairs: PCK@0.1 {pck[0]:.4f}, @0.15 "
          f"{pck[1]:.4f} (identity {ident[0]:.4f}, {ident[1]:.4f}; a "
          f"{CAT_STEPS}-step model) in {kp_s:.2f} s, launches {kp} "
          f"(expected ({groups}, 0))", flush=True)
    assert math.isfinite(iou) and 0.0 <= iou <= 1.0
    assert iou_launches == len(test_loader)
    assert kp == (groups, 0), kp
    assert 0.0 <= pck[0] <= pck[1] <= 1.0
    phase_s = time.perf_counter() - t_phase
    print(f"phase 14: {phase_s:.1f} s [{smi}]", flush=True)
    return dict(gen_launches=gen[0], gen_s=gen_s,
                render_s=stats["render_s"], outside_share=holes,
                renders=renders, staged_mb=staged_mb,
                htod_bytes_per_batch=htod, s2_launches=list(s2),
                s2_budget=budget, s2_budget_phase7=budget7,
                avg_uv_s=uv_s, avg_uv_steady_ms=steady, iou=iou,
                iou_launches=iou_launches, kp_cam=list(pck),
                kp_launches=kp[0], phase_s=phase_s)


CUB_CLASS = "001.Synthetic_Bird"
JPEG_FIXTURES = ("bird_500x375_420", "bird_320x240_grey", "bird_333x301_444")


def quat_to_matrix(q):
    """Unit quaternion (w, x, y, z) -> 3x3 rotation matrix (numpy)."""
    w, x, y, z = np.asarray(q, np.float64) / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]])


def write_cub_fixture(root, data, n_train, padding_frac, seed=0):
    """A CUB-layout dataset in root from a generated category: each 256^2
    render scaled and pasted at a random offset into a noise canvas of
    CUB's sizes (250-500 per side), written as images/<class>/<name>.png;
    data/{split}_cub_cleaned.mat (rel_path, binary mask, 1-based inclusive
    bbox, parts 3x15 from the generator's keypoints) and
    sfm/anno_{split}.mat; the train split's SCOPS maps <name>_<index>.npy,
    cropped with the jitter-free padded square bbox and resized to 256
    (the loader reads them as they are). The committed JPEG fixtures go
    first into the test split (their masks thresholded from nvJPEG's
    decode). Returns the JPEG readings."""
    import scipy.io as sio

    from umr_tpu_torch.image import crop, peturb_bbox, resize_img, square_bbox
    from umr_tpu_torch.jpeg import read_jpeg
    from umr_tpu_torch.png import read_png, write_png

    S = data["img"].shape[1]
    rng = np.random.RandomState(seed)
    img_dir = os.path.join(root, "cub", "images", CUB_CLASS)
    scops_dir = os.path.join(root, "scops", CUB_CLASS)
    for d in (img_dir, scops_dir, os.path.join(root, "cache", "data"),
              os.path.join(root, "cache", "sfm")):
        os.makedirs(d, exist_ok=True)
    bbox_dt = np.dtype([(k, "f8") for k in ("x1", "y1", "x2", "y2")])
    img_dt = np.dtype([(k, "O") for k in ("rel_path", "mask", "bbox",
                                          "parts")])
    sfm_dt = np.dtype([(k, "O") for k in ("scale", "trans", "rot")])
    entries = {"train": [], "test": []}

    def entry(name, mask, kp_px, vis, cam, scale_px, trans_px):
        ys, xs = np.nonzero(mask)
        bbox = np.empty((1, 1), bbox_dt)
        bbox["x1"], bbox["y1"] = xs.min() + 1, ys.min() + 1
        bbox["x2"], bbox["y2"] = xs.max() + 1, ys.max() + 1
        parts = np.stack([(kp_px[:, 0] + 1) * vis, (kp_px[:, 1] + 1) * vis,
                          vis.astype(np.float64)])
        return ((f"{CUB_CLASS}/{name}", mask.astype(np.uint8), bbox, parts),
                (np.float64(scale_px), np.asarray(trans_px, np.float64),
                 quat_to_matrix(cam[3:7])))

    # the committed JPEGs, decoded on the card, lead the test split
    fix = os.path.join(ROOT, "tests", "fixtures")
    meta = json.load(open(os.path.join(fix, "cub_jpegs.json")))
    jpeg_rec = {}
    for name in JPEG_FIXTURES:
        src = os.path.join(fix, name + ".jpg")
        t0 = time.perf_counter()
        dec = read_jpeg(src)
        first_ms = 1e3 * (time.perf_counter() - t0)
        t0 = time.perf_counter()
        for _ in range(10):
            dec = read_jpeg(src)
        ms = 1e2 * (time.perf_counter() - t0)
        ref = read_png(os.path.join(fix, name + ".png"))
        assert dec.shape == ref.shape and dec.dtype == np.uint8, name
        jpeg_rec[name] = dict(ms=ms, first_ms=first_ms,
                              shape=list(dec.shape), **diff_levels(dec, ref))
        grey = dec if dec.ndim == 2 else dec.min(axis=2)
        mask = grey < 240
        kp = np.asarray(meta[name + ".jpg"]["kp"])
        cam = np.asarray(meta[name + ".jpg"]["cam"])
        H, W = mask.shape
        vis = ((kp[:, 0] >= 0) & (kp[:, 0] < W) & (kp[:, 1] >= 0)
               & (kp[:, 1] < H))
        with open(src, "rb") as fi, \
                open(os.path.join(img_dir, name + ".jpg"), "wb") as fo:
            fo.write(fi.read())
        entries["test"].append(entry(
            name + ".jpg", mask, kp, vis, cam, cam[0] * S / 2,
            (cam[1:3] + 1) / 2 * S))

    for i in range(data["img"].shape[0]):
        split = "train" if i < n_train else "test"
        index = len(entries[split])
        name = f"{split}_{i:04d}"
        m256 = data["mask"][i] > 0.5
        ys, xs = np.nonzero(m256)
        H, W = rng.randint(250, 501, 2)
        fit = 0.95 * min(W / (xs.max() - xs.min() + 1),
                         H / (ys.max() - ys.min() + 1))
        f = min(rng.uniform(0.7, 1.6), fit)
        img, (fy, _) = resize_img(data["img"][i].astype(np.float64), f)
        soft, _ = resize_img(data["mask"][i].astype(np.float64), f)
        R = img.shape[0]
        # the resized bird's bbox inside the canvas, the render square not
        ox = rng.randint(-int(xs.min() * fy), W - int(xs.max() * fy) - 1)
        oy = rng.randint(-int(ys.min() * fy), H - int(ys.max() * fy) - 1)
        canvas = rng.uniform(0, 1, (H, W, 3))
        y0, x0 = max(oy, 0), max(ox, 0)
        y1, x1 = min(oy + R, H), min(ox + R, W)
        win = (slice(y0 - oy, y1 - oy), slice(x0 - ox, x1 - ox))
        a = np.clip(soft[win], 0, 1)[..., None]
        canvas[y0:y1, x0:x1] = a * img[win] + (1 - a) * canvas[y0:y1, x0:x1]
        mask = np.zeros((H, W), bool)
        mask[y0:y1, x0:x1] = soft[win] > 0.5
        write_png(os.path.join(img_dir, name + ".png"),
                  np.round(canvas * 255).astype(np.uint8))
        px = (data["kp"][i, :, :2] + 1) / 2 * S          # 256 frame
        kp_px = (px + 0.5) * fy - 0.5 + np.array([ox, oy])
        cam = data["cam"][i]
        ent = entry(name + ".png", mask, kp_px, np.ones(15), cam,
                    cam[0] * S / 2 * fy,
                    ((cam[1:3] + 1) / 2 * S + 0.5) * fy - 0.5
                    + np.array([ox, oy]))
        entries[split].append(ent)
        if split != "train":
            continue
        # the part map in the frame of the jitter-free 256 crop
        parts, _ = resize_img(data["part_prob"][i, ..., 1:].astype(
            np.float64), f)
        pc = np.zeros((H, W, 4))
        pc[y0:y1, x0:x1] = parts[win]
        b = ent[0][2]
        box = np.array([b["x1"][0, 0], b["y1"][0, 0], b["x2"][0, 0],
                        b["y2"][0, 0]], float) - 1
        sq = square_bbox(peturb_bbox(box, pf=padding_frac, jf=0.0))
        pc = crop(pc, sq, bgval=0)
        pc, _ = resize_img(pc, S / float(pc.shape[0]))
        bg = np.clip(1 - pc.sum(-1, keepdims=True), 0, 1)
        np.save(os.path.join(scops_dir, f"{name}_{index}.npy"),
                np.concatenate([bg, pc], -1).astype(np.float32))

    for split, ents in entries.items():
        images = np.empty((len(ents),), img_dt)
        sfm = np.empty((len(ents),), sfm_dt)
        for j, (im, sf) in enumerate(ents):
            images[j] = im
            sfm[j] = sf
        sio.savemat(os.path.join(root, "cache", "data",
                                 f"{split}_cub_cleaned.mat"),
                    {"images": images})
        sio.savemat(os.path.join(root, "cache", "sfm", f"anno_{split}.mat"),
                    {"sfm_anno": sfm})
    return jpeg_rec, {k: len(v) for k, v in entries.items()}


def diff_levels(got, want):
    """mean, 99th percentile and max of |got - want| in 8-bit levels."""
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    return dict(mean_diff=float(d.mean()),
                p99_diff=float(np.percentile(d, 99)), max_diff=int(d.max()))


def kp_inside_share(batch):
    """(visible keypoints on the mask, visible keypoints) of a batch: the
    mask sampled bilinearly at each keypoint > 0.5, as phase 14's hole
    check samples it at the projected vertices."""
    from umr_tpu_torch.ops.grid_sample import grid_sample

    kp = torch.as_tensor(batch["kp"])
    m = grid_sample(torch.as_tensor(batch["mask"])[..., None],
                    kp[..., :2])[..., 0]
    vis = kp[..., 2] > 0
    return int(((m > 0.5) & vis).sum()), int(vis.sum())


def loader_split(cfg, dev, workers):
    """One epoch of the CUB loader at `workers` threads: (wall ms per
    batch, thread-ms per batch in each part of a sample, collate ms of a
    batch, (keypoints on the mask, visible keypoints))."""
    from umr_tpu_torch.data.cub import data_loader
    from umr_tpu_torch.data.loader import collate

    loader = data_loader(cfg.replace(n_data_workers=workers), device=dev)
    ds = loader.dataset
    ds.timings = {}
    inside = [0, 0]
    t0 = time.perf_counter()
    n = 0
    for b in loader:
        n += 1
        k_in, k_vis = kp_inside_share(b)
        inside[0] += k_in
        inside[1] += k_vis
    wall = 1e3 * (time.perf_counter() - t0) / n
    split = {k: 1e3 * v / n for k, v in ds.timings.items()}
    samples = [ds[i] for i in range(cfg.batch_size)]
    t0 = time.perf_counter()
    collate(samples)
    return wall, split, 1e3 * (time.perf_counter() - t0), tuple(inside)


def png_files_decode(directory, names):
    from umr_tpu_torch.png import read_png

    for f in names:
        path = os.path.join(directory, f)
        assert os.path.exists(path), path
        if f.endswith(".png"):
            img = read_png(path)
            assert img.ndim == 3 and img.shape[2] == 3, (path, img.shape)


def cub_path(dev, smi, template):
    """Phase 15: the CUB path from files. A CUB-layout fixture written from
    generate_dataset (CUB_TRAIN + CUB_TEST birds) plus the committed
    JPEGs (nvJPEG against PIL's decode), the loader's host split at 1 and
    4 workers and its keypoint check, then through the entry points with
    no loader passed: train_s1.run (batch 64) with its visuals, avg_uv.run,
    train_s2.run (batch 16, use_scops, forced template) with its visuals,
    test_iou.run and test_kp.run (cam) with --visualize; each path's
    launches asserted. Returns the readings."""
    from umr_tpu_torch import jpeg, native
    from umr_tpu_torch.config import Config
    from umr_tpu_torch.data.synthetic_category import generate_dataset
    from umr_tpu_torch.experiments import (avg_uv, test_iou, test_kp,
                                           train_s1, train_s2)
    from umr_tpu_torch.ops import raster_kernel
    from umr_tpu_torch.training.visuals import render_calls

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp()
    t0 = time.perf_counter()
    native.build()          # g++, before the loader's timings
    edt_build_s = time.perf_counter() - t0
    m = np.zeros((IMAGE_SIZE, IMAGE_SIZE), np.float32)
    m[IMAGE_SIZE // 5:-IMAGE_SIZE // 5, IMAGE_SIZE // 4:-IMAGE_SIZE // 3] = 1
    t0 = time.perf_counter()
    for _ in range(20):
        native.edt_barrier(m)
    edt_ms = 1e3 * (time.perf_counter() - t0) / 20
    t0 = time.perf_counter()
    data = generate_dataset(template, CUB_TRAIN + CUB_TEST, seed=3,
                            image_size=IMAGE_SIZE, batch=TRAIN_BATCH,
                            device=dev)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    jpeg_rec, sizes = write_cub_fixture(root, data, CUB_TRAIN,
                                        Config().padding_frac)
    write_s = time.perf_counter() - t0
    del data
    print(f"EDT barrier built in {edt_build_s:.2f} s, {edt_ms:.3f} ms a "
          f"{IMAGE_SIZE}^2 mask (mean of 20); CUB fixture: {sizes} "
          f"entries ({len(JPEG_FIXTURES)} JPEGs first in test) from "
          f"generate_dataset in {gen_s:.2f} s, written in {write_s:.2f} s",
          flush=True)
    for name, r in jpeg_rec.items():
        print(f"nvJPEG {name} {r['shape']}: {r['ms']:.3f} ms per decode "
              f"(mean of 10 with the file read and the copy back; first "
              f"{r['first_ms']:.1f} ms), against PIL: mean |diff| "
              f"{r['mean_diff']:.4f}, 99th percentile {r['p99_diff']:.1f}, "
              f"max {r['max_diff']} levels (limits {JPEG_MEAN_LIMIT}, "
              f"{JPEG_P99_LIMIT}) [{smi}]",
              flush=True)
        assert (r["mean_diff"] <= JPEG_MEAN_LIMIT
                and r["p99_diff"] <= JPEG_P99_LIMIT), (name, r)

    common = dict(
        image_size=IMAGE_SIZE, img_size=IMAGE_SIZE, subdivide=SUBDIVIDE,
        tex_size=6, num_hypo_cams=8, print_freq=1,
        cub_dir=os.path.join(root, "cub"),
        cub_cache_dir=os.path.join(root, "cache"),
        scops_path=os.path.join(root, "scops"),
        checkpoint_dir=os.path.join(root, "snap"),
        vis_dir=os.path.join(root, "vis"),
        results_vis_dir=os.path.join(root, "rvis"))
    rec = dict(jpeg=jpeg_rec, fixture=sizes, gen_s=gen_s, write_s=write_s,
               edt_build_s=edt_build_s, edt_ms=edt_ms, loader={})
    for label, kw in (("s1", dict(batch_size=S1_BATCH, use_scops=False)),
                      ("s2", dict(batch_size=TRAIN_BATCH, use_scops=True))):
        for workers in (1, 4):
            wall, split, coll, inside = loader_split(
                Config(**common, **kw), dev, workers)
            rec["loader"][f"{label}_w{workers}"] = dict(
                wall_ms=wall, split_ms=split, collate_ms=coll,
                kp_inside=inside)
            print(f"CUB loader, {label} (batch {kw['batch_size']}, "
                  f"use_scops {kw['use_scops']}), {workers} worker(s): "
                  f"{wall:.1f} ms per batch; thread-ms per batch: "
                  + ", ".join(f"{k} {v:.1f}" for k, v in split.items())
                  + f"; collate {coll:.1f} ms; keypoints on the mask "
                  f"{inside[0]}/{inside[1]} [{smi}]", flush=True)
            assert inside[0] >= KP_INSIDE * inside[1], inside

    def launches():
        return (raster_kernel.LAUNCHES, raster_kernel.P2F_LAUNCHES,
                raster_kernel.BWD_LAUNCHES)

    def reset():
        raster_kernel.LAUNCHES = raster_kernel.P2F_LAUNCHES = 0
        raster_kernel.BWD_LAUNCHES = 0

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    vis_names = ("image_pred.png", "uv_images.png", "mask_pred.png",
                 "mask_gt.png", "image_gt.png", "mesh_0.obj", "mesh_0.png")
    s1cfg = train_s1.config(
        ["--batch_size", str(S1_BATCH), "--num_iter", str(CUB_S1_STEPS),
         "--display_freq", str(CUB_S1_DISPLAY), "--name", "cub_s1"]
        + [f"--{k}={v}" for k, v in common.items()])
    reset()
    s1, s1_s = timed(lambda: train_s1.run(s1cfg, device=dev))
    got = s1_l = launches()
    dumps = CUB_S1_STEPS // CUB_S1_DISPLAY
    want = (3 * CUB_S1_STEPS + render_calls() * dumps, CUB_S1_STEPS,
            2 * CUB_S1_STEPS)
    b1 = json.load(open(os.path.join(root, "snap", "cub_s1",
                                     "stage_budget.json")))
    vis1_ms = 1e3 * s1.budget()["vis"] / dumps
    print(f"train_s1.run from --cub_dir: {s1.state.step} steps of "
          f"{S1_BATCH} in {s1_s:.2f} s with set-up; launches (forward, p2f, "
          f"backward) {got} (expected {want}: 3, 1 with p2f, + 2 per step "
          f"and {render_calls()} per visuals dump); {vis1_ms:.1f} ms per "
          f"dump; stage budget (s per step): loader "
          f"{b1['loader_s_per_step']}, dispatch {b1['dispatch_s_per_step']}, "
          f"drain {b1['drain_s_per_step']}, vis {b1['vis_s_per_step']} "
          f"[{smi}]", flush=True)
    assert s1.state.step == CUB_S1_STEPS and got == want, (got, want)
    for sc in s1.history:
        assert all(math.isfinite(v) for v in sc.values()), sc
    png_files_decode(os.path.join(root, "vis", "cub_s1"), vis_names)
    s1_pth = os.path.join(root, "snap", "cub_s1", "pred_net_latest.pth")
    del s1
    torch.cuda.empty_cache()

    stemp = os.path.join(root, "stemp")
    ucfg = Config(**dict(common, batch_size=S1_BATCH, use_scops=True,
                         is_train=False, model_path=s1_pth, out_dir=stemp))
    reset()
    _, uv_s = timed(lambda: avg_uv.run(ucfg, device=dev))
    uv = launches()
    n_uv = CUB_TRAIN // S1_BATCH
    print(f"avg_uv.run from --cub_dir: {n_uv} batches of {S1_BATCH} in "
          f"{uv_s:.2f} s; launches {uv} (expected ({n_uv}, 0, 0)) [{smi}]",
          flush=True)
    assert uv == (n_uv, 0, 0), uv

    s2cfg = Config(**dict(common, batch_size=TRAIN_BATCH, use_scops=True,
                          num_iter=CUB_S2_STEPS, display_freq=CUB_S2_DISPLAY,
                          stemp_path=stemp, force_template=True,
                          name="cub_s2"))
    reset()
    s2, s2_s = timed(lambda: train_s2.run(s2cfg, device=dev))
    got = s2_l = launches()
    dumps2 = CUB_S2_STEPS // CUB_S2_DISPLAY
    calls2 = render_calls(s2cfg.num_parts)
    want = (3 * CUB_S2_STEPS + calls2 * dumps2, 0, 2 * CUB_S2_STEPS)
    b2 = json.load(open(os.path.join(root, "snap", "cub_s2",
                                     "stage_budget.json")))
    vis2_ms = 1e3 * s2.budget()["vis"] / dumps2
    print(f"train_s2.run from --cub_dir: {s2.state.step} steps of "
          f"{TRAIN_BATCH} in {s2_s:.2f} s with set-up; launches {got} "
          f"(expected {want}: 3 + 2 per step and {calls2} per visuals "
          f"dump); {vis2_ms:.1f} ms per dump; stage budget (s per step): "
          f"loader {b2['loader_s_per_step']}, dispatch "
          f"{b2['dispatch_s_per_step']}, drain {b2['drain_s_per_step']}, "
          f"vis {b2['vis_s_per_step']} [{smi}]", flush=True)
    assert s2.state.step == CUB_S2_STEPS and got == want, (got, want)
    for sc in s2.history:
        assert all(math.isfinite(v) for v in sc.values()), sc
    png_files_decode(os.path.join(root, "vis", "cub_s2"), vis_names + (
        "part_cons_vis.png", "part_render_0.png", "part_render_3.png",
        "gt_part_render_0.png", "gt_part_render_3.png"))
    s2_pth = os.path.join(root, "snap", "cub_s2", "pred_net_latest.pth")
    del s2
    torch.cuda.empty_cache()

    tcfg = Config(**dict(common, split="test", use_scops=False,
                         batch_size=BATCH, is_train=False, model_path=s2_pth,
                         visualize=True))
    n_iou = sizes["test"] // BATCH
    reset()
    # count the loader's decodes: read_jpeg calls jpeg.decode_jpeg
    decode, decodes = jpeg.decode_jpeg, [0]

    def counted_decode(*args, **kw):
        decodes[0] += 1
        return decode(*args, **kw)

    jpeg.decode_jpeg = counted_decode
    try:
        iou, iou_s = timed(lambda: test_iou.run(tcfg, device=dev))
    finally:
        jpeg.decode_jpeg = decode
    iou_l, decodes = launches(), decodes[0]
    print(f"test_iou.run --visualize from --cub_dir: IoU {iou:.4f} over "
          f"{n_iou} batch(es) of {BATCH} in {iou_s:.2f} s; launches {iou_l} "
          f"(expected ({n_iou}, 0, 0)); nvJPEG decodes {decodes} [{smi}]",
          flush=True)
    assert math.isfinite(iou) and 0.0 <= iou <= 1.0
    assert iou_l == (n_iou, 0, 0) and decodes >= len(JPEG_FIXTURES)
    png_files_decode(os.path.join(root, "rvis", "vis_iter_0"), (
        "image_gt.png", "mask_gt.png", "mask_pred.png", "mesh_0.obj"))

    kcfg = tcfg.replace(mode="cam", number_pairs=KP_PAIRS,
                        results_vis_dir=os.path.join(root, "kvis"))
    groups = -(-KP_PAIRS // 16)
    reset()
    pck, kp_s = timed(lambda: test_kp.run(kcfg, device=dev))
    kp_l = launches()
    print(f"test_kp.run cam --visualize from --cub_dir: PCK@0.1 "
          f"{pck[0]:.4f}, @0.15 {pck[1]:.4f} over {KP_PAIRS} pairs in "
          f"{kp_s:.2f} s; launches {kp_l} (expected ({groups}, 0, 0)) "
          f"[{smi}]", flush=True)
    assert kp_l == (groups, 0, 0) and 0.0 <= pck[0] <= pck[1] <= 1.0
    assert len(os.listdir(os.path.join(root, "kvis"))) == KP_PAIRS
    png_files_decode(os.path.join(root, "kvis", "vis_iter_0"),
                     ("target.png", "source.png", "gt_img.png"))
    phase_s = time.perf_counter() - t_phase
    print(f"phase 15: {phase_s:.1f} s [{smi}]", flush=True)
    rec.update(s1_launches=list(s1_l), s1_s=s1_s, s1_budget=b1,
               s1_vis_ms=vis1_ms, avg_uv_s=uv_s, avg_uv_launches=uv[0],
               s2_launches=list(s2_l), s2_s=s2_s, s2_budget=b2,
               s2_vis_ms=vis2_ms, iou=iou, iou_s=iou_s,
               iou_launches=iou_l[0], kp_cam=list(pck), kp_s=kp_s,
               kp_launches=kp_l[0], visuals_launches_per_dump={
                   "s1": render_calls(), "s2": calls2},
               phase_s=phase_s)
    return rec


# phase 16, the training flag variants: each variant's launches per step
# (forward, of them with p2f, backward), as training/steps.py lists them
S2_VARIANTS = (("f32", {}, (3, 0, 2)), ("bf16", {"bf16": True}, (3, 0, 2)),
               ("no texture", {"use_texture": False}, (4, 0, 4)),
               ("no GAN", {"use_gan": False}, (4, 0, 3)),
               ("no texture, no GAN", {"use_texture": False,
                                       "use_gan": False}, (3, 0, 3)),
               ("az_ele_quat", {"az_ele_quat": True}, (3, 0, 2)))
S1_VARIANTS = (("f32", {}, (3, 1, 2)), ("bf16", {"bf16": True}, (3, 1, 2)),
               ("no GAN", {"use_gan": False}, (2, 1, 1)),
               ("no texture", {"use_texture": False}, (2, 0, 2)))
VARIANT_STEPS = 3        # the entry points' steps under --bf16


def launches():
    """The kernel wrappers' counts: (forward, of them with p2f, backward)."""
    from umr_tpu_torch.ops import raster_kernel

    return (raster_kernel.LAUNCHES, raster_kernel.P2F_LAUNCHES,
            raster_kernel.BWD_LAUNCHES)


def zero_launches():
    from umr_tpu_torch.ops import raster_kernel

    raster_kernel.LAUNCHES = raster_kernel.BWD_LAUNCHES = 0
    raster_kernel.P2F_LAUNCHES = 0


def variant_step(label, step_fn, state, batch, args, expect, smi,
                 prefix=None):
    """One counted step of a built variant (the renders' input dtypes
    recorded at the kernels' Function), then TIMED_STEPS steps after 1
    warm-up on the same batch, timed with CUDA events, and one more whose
    loss (before its update) must lie below the first step's; with a
    profiler range prefix ("s2." or "s1."), then a trace of the step's
    device time by range. Returns the readings."""
    from umr_tpu_torch.ops import raster_kernel

    function = raster_kernel._Raster
    dtypes = set()

    class Recording:
        @staticmethod
        def apply(fv, tex, al_fids, astarts, kw):
            dtypes.add((fv.dtype, tex.dtype))
            return function.apply(fv, tex, al_fids, astarts, kw)

    raster_kernel._Raster = Recording
    try:
        zero_launches()
        state, sc = step_fn(state, batch, *args)
        torch.cuda.synchronize()
        got = launches()
    finally:
        raster_kernel._Raster = function
    first = {k: v.item() for k, v in sc.items()}
    assert got == expect, (label, got, expect)
    assert dtypes == {(torch.float32, torch.float32)}, (label, dtypes)
    assert all(math.isfinite(v) for v in first.values()), (label, first)
    ms, times, state = timed_steps(step_fn, state, [batch], TIMED_STEPS,
                                   *args)
    state, sc = step_fn(state, batch, *args)
    last = sc["total_loss"].item()
    peak = torch.cuda.max_memory_allocated() / 1e9
    msg = (f"{label}: raster_fwd launches {got[0]} ({got[1]} with p2f), "
           f"raster_bwd launches {got[2]} per step (expected {expect}); "
           f"renders take {sorted(str(d) for d in dtypes)}; median "
           f"{ms:.2f} ms over {TIMED_STEPS} steps after 1 warm-up (min "
           f"{min(times):.2f}, max {max(times):.2f}); peak device memory "
           f"{peak:.2f} GB; total_loss on the batch {first['total_loss']:.4f}"
           f" at step 1, {last:.4f} after {TIMED_STEPS + 2} updates "
           f"[{smi}]")
    print(msg, flush=True)
    assert math.isfinite(last) and last < first["total_loss"], msg
    rec = dict(launches=list(got), ms=ms, times=times, peak_gb=peak,
               first_total=first["total_loss"], last_total=last,
               scalars=first)
    if prefix:
        box = [state]

        def one_step():
            box[0], _ = step_fn(box[0], batch, *args)

        trace = trace_split(one_step, prefix, ms, smi, label)
        rec.update(split_ms=trace["split"], busy_ms=trace["busy_ms"],
                   idle_share=trace["idle"])
    return rec


def flag_variants(dev, smi, template, tcfg, tloader, seg, pvi, part_loss,
                  s1cfg, s1loader, iou_cfg, iou_loader, checks):
    """Phase 16, the training flag variants: each s2 variant at batch 16
    and each s1 variant at batch 64, full width (launch counts, float32
    into every render, finite scalars, a falling loss, step time, peak
    memory); train_s2.run and train_s1.run under --bf16 through the entry
    points; test_iou.run on a one-camera, untextured checkpoint; the new
    kernel shapes (the mask-only fold, the T2=1 GAN view, the unmerged
    part renders, stage 1's mask-only seen render) against the plain
    versions on 8-image slices. Returns the readings."""
    from umr_tpu_torch.cli import parse_config
    from umr_tpu_torch.experiments import test_iou, train_s1, train_s2
    from umr_tpu_torch.experiments.raster_bench import step_renders
    from umr_tpu_torch.models import MeshNet, init_weights
    from umr_tpu_torch.training.steps import build_s1_step, build_s2_step
    from umr_tpu_torch.training.trainer import prepare_batch

    t_phase = time.perf_counter()
    rec = {"s2": {}, "s1": {}}
    for stage, variants, base, data in (
            ("s2", S2_VARIANTS, tcfg, tloader[0]),
            ("s1", S1_VARIANTS, s1cfg, s1loader[0])):
        for label, flags, expect in variants:
            cfg = base.replace(checkpoint_dir=tempfile.mkdtemp(), **flags)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            if stage == "s2":
                _, _, _, init_fn, step_fn = build_s2_step(
                    cfg, template, part_loss, pvi, dev)
                args = ()
            else:
                _, _, _, init_fn, step_fn, _, _ = build_s1_step(
                    cfg, template, dev)
                args = (0.0,)
            batch = prepare_batch(data, cfg.use_scops, cfg.use_texture)
            rec[stage][label] = variant_step(
                f"{stage} {label} step (batch {cfg.batch_size})", step_fn,
                init_fn(cfg.seed), batch, args, expect, smi,
                prefix=f"{stage}." if label in ("f32", "bf16", "az_ele_quat")
                else None)
        a, b = rec[stage]["bf16"], rec[stage]["f32"]
        print(f"{stage} step, bf16 against f32: {a['ms']:.2f} against "
              f"{b['ms']:.2f} ms ({b['ms'] / a['ms']:.3f}x), device busy "
              f"{a['busy_ms']:.2f} against {b['busy_ms']:.2f} ms, peak "
              f"{a['peak_gb']:.2f} against {b['peak_gb']:.2f} GB; TF32 off "
              f"[{smi}]", flush=True)

    # the new kernel shapes, from one untextured step of each stage as the
    # kernels' route receives them, against the plain versions on
    # FOLD_SLICE images spread over each render, on bins that drop nothing
    slices = {}
    cfg2 = tcfg.replace(use_texture=False, checkpoint_dir=tempfile.mkdtemp())
    _, _, _, init_fn, step_fn = build_s2_step(cfg2, template, part_loss, pvi,
                                              dev)
    with step_renders(("s2 fold mask", "s2 gan T2=1", "s2 part 0",
                       "s2 part 1")) as r2:
        step_fn(init_fn(cfg2.seed), prepare_batch(tloader[0], True, False))
    cfg1 = s1cfg.replace(use_texture=False, checkpoint_dir=tempfile.mkdtemp())
    _, _, _, init_fn, step_fn, _, _ = build_s1_step(cfg1, template, dev)
    with step_renders(("s1 seen mask", "s1 gan")) as r1:
        step_fn(init_fn(cfg1.seed), prepare_batch(s1loader[0], False, False),
                0.0)
    torch.cuda.synchronize()
    for seed, (label, r) in enumerate(
            [(k, r2[k]) for k in ("s2 fold mask", "s2 gan T2=1",
                                  "s2 part 0")]
            + [("s1 seen mask", r1["s1 seen mask"])], start=20):
        n_img = r["fv"].shape[0]
        sel = torch.linspace(0, n_img - 1, FOLD_SLICE,
                             device=dev).round().long()
        fwd = checks["check_fwd_slice"](label, r, sel)
        bwd = checks["check_slice"](
            f"{label} slice: {FOLD_SLICE} of {n_img} images (images "
            f"{sel.tolist()}, T2={r['tex'].shape[2]}, on the main path's "
            "bins, the plain backward on the kernel forward's outputs)",
            checks["slice_of"](r, sel), seed,
            shared_forward=True)
        slices[label] = dict(images=n_img, t2=r["tex"].shape[2],
                             fwd=fwd, bwd=bwd)
    del r1, r2
    rec["slices"] = slices

    # the entry points under --bf16, from the command line's Config
    entry = {}
    s2cfg = parse_config([
        "--bf16", "--batch_size", str(TRAIN_BATCH), "--image_size",
        str(IMAGE_SIZE), "--subdivide", str(SUBDIVIDE), "--num_iter",
        str(VARIANT_STEPS), "--checkpoint_dir", tempfile.mkdtemp(),
        "--name", "s2_bf16", "--nodisplay_visuals"])
    s1v = train_s1.config([
        "--bf16", "--batch_size", str(S1_BATCH), "--image_size",
        str(IMAGE_SIZE), "--subdivide", str(SUBDIVIDE), "--num_iter",
        str(VARIANT_STEPS), "--checkpoint_dir", tempfile.mkdtemp(),
        "--name", "s1_bf16", "--nodisplay_visuals"])
    for label, run, want in (
            ("train_s2.run --bf16", lambda: train_s2.run(
                s2cfg, tloader, device=dev, semantic=(None, seg, pvi)),
             (3, 0, 2)),
            ("train_s1.run --bf16", lambda: train_s1.run(
                s1v, s1loader, device=dev), (3, 1, 2))):
        zero_launches()
        t0 = time.perf_counter()
        trainer = run()
        torch.cuda.synchronize()
        got = launches()
        steps = trainer.state.step
        print(f"{label}: {steps} steps in {time.perf_counter() - t0:.2f} s "
              f"incl. set-up; launches {got} (expected {want} per step); "
              "total_loss " + ", ".join(f"{sc['total_loss']:.4f}"
                                        for sc in trainer.history), flush=True)
        assert steps == VARIANT_STEPS, steps
        assert got == tuple(VARIANT_STEPS * w for w in want), got
        for sc in trainer.history:
            assert all(math.isfinite(v) for v in sc.values()), sc
        entry[label] = dict(launches=list(got), steps=steps,
                            total_loss=[sc["total_loss"]
                                        for sc in trainer.history])
        del trainer
    rec["entry_points"] = entry

    # the one-camera, untextured eval model through test_iou.run
    one_cam = init_weights(MeshNet(template, input_size=IMAGE_SIZE,
                                   use_texture=False, multiple_cam_hypo=False),
                           torch.Generator().manual_seed(0))
    with tempfile.TemporaryDirectory() as tmp:
        ecfg = iou_cfg.replace(model_path=os.path.join(tmp, "pred_net.pth"),
                               use_texture=False, multiple_cam_hypo=False)
        torch.save(one_cam.state_dict(), ecfg.model_path)
        zero_launches()
        iou = test_iou.run(ecfg, dataloader=iou_loader, device=dev)
        torch.cuda.synchronize()
        got = launches()
    print(f"test_iou.run, one camera, untextured: IoU {iou:.4f} over "
          f"{len(iou_loader)} batches of {ecfg.batch_size}; launches {got} "
          f"(expected one forward per batch)", flush=True)
    assert math.isfinite(iou) and 0.0 <= iou <= 1.0, iou
    assert got == (len(iou_loader), 0, 0), got
    rec["eval_one_camera_untextured"] = dict(iou=iou, launches=list(got))
    rec["phase_s"] = time.perf_counter() - t_phase
    print(f"phase 16: {rec['phase_s']:.1f} s [{smi}]", flush=True)
    return rec


# phase 17, data parallelism: the two-rank (gloo, one card) s2 step timed
# after the checked one; each 2-rank step against one process. Both
# steps are chaotic at full width: a 1e-6 relative perturbation of the
# input images moves one process's own gradient to cosine 0.99774 (s2)
# and 0.99664 (s1), the worst tensor to 0.36 and 0.15 of its norm, and
# the scalars by 1.2e-4 and 4.3e-4 relative, while one process repeated
# reads cosine 1 - 4e-12 (NVIDIA H100 80GB HBM3, 700 W; the two-rank
# steps read 0.99773 and 0.99870, worst tensor 0.39 and 0.27, scalars
# 4.6e-5 and 7.1e-5). The gradient bounds keep a margin over that; the
# BatchNorm running statistics (global sums in another order, reading
# 1.1e-6) and stage 1's mean_v after the template update (reading 1.2e-7)
# are held tighter
DP_TIMED = 3
DP_COS = 0.99
DP_REL = 0.6
DP_STATS_RTOL = 1e-4
DP_MEAN_V_ATOL = 1e-6
DP_SCALARS_RTOL = 1e-3
# 17d: train_s2.run on the spawned ranks to each num_iter here, a later run
# resuming from the files of the one before; then DP_PROBES steps on the
# first batch, the last one's loss (before its update) below the first
# step's on it
DP_TRAIN_RUNS = (2, 4)
DP_PROBES = 3


def no_tf32():
    """Float32 matmuls and convolutions in float32 (the card's default
    runs them in TF32): set in every process, the spawned ranks too."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def dp_rank_steps(specs):
    """tests/torch_ranks.py::rank_steps with TF32 off, in a spawned rank
    as in this process."""
    from torch_ranks import rank_steps

    no_tf32()
    return rank_steps(specs)


def dp_train_s2(cfg, loader, semantic, out):
    """Phase 17a, on a rank of parallel.launch: train_s2.run on the rank's
    card (its launches per step), then TIMED_STEPS timed steps on the
    first batch and one more, whose loss (before its update) must lie
    below the first step's on that batch. Appends the readings to out."""
    import torch.distributed as dist

    from umr_tpu_torch.experiments import train_s2
    from umr_tpu_torch.training.trainer import prepare_batch

    no_tf32()
    zero_launches()
    trainer = train_s2.run(cfg, loader, semantic=semantic)
    torch.cuda.synchronize()
    got = launches()
    batch = prepare_batch(loader[0])
    ms, times, state = timed_steps(trainer.step_fn, trainer.state, [batch],
                                   TIMED_STEPS)
    _, sc = trainer.step_fn(state, batch)
    out.append(dict(backend=dist.get_backend(), world=dist.get_world_size(),
                    device=str(next(state.model.parameters()).device),
                    launches=got, step=state.step, history=trainer.history,
                    last_total=sc["total_loss"].item(), ms=ms, times=times))


def dp_train_rank(cfg, semantic):
    """Phase 17d on a rank of the group: the synthetic category
    (generate_dataset, two global batches) through CategoryLoader on the
    rank's card, which gives the rank its block of each global batch,
    and train_s2.run to each num_iter of DP_TRAIN_RUNS, every run after
    the first resuming from the files of the one before; then DP_PROBES
    steps on the first global batch's block. Returns per run the state's
    step, the steps it took, its launches and the state digest; the
    first step's loss and the last probe's (before its update); the
    probes' digest."""
    from torch_ranks import state_digest
    from umr_tpu_torch.config import resolve_device
    from umr_tpu_torch.data.synthetic_category import (CategoryLoader,
                                                       generate_dataset)
    from umr_tpu_torch.experiments import train_s2
    from umr_tpu_torch.mesh import build_template
    from umr_tpu_torch.training.trainer import prepare_batch

    no_tf32()
    data = generate_dataset(build_template(SUBDIVIDE, 1, 6), 2 * TRAIN_BATCH,
                            seed=0, image_size=IMAGE_SIZE, batch=TRAIN_BATCH,
                            device="cuda")

    def loader():
        return CategoryLoader(data, cfg.batch_size, seed=20, use_scops=True,
                              device_data=True, device="cuda")

    runs, ld, trainer = [], loader(), None
    for n in DP_TRAIN_RUNS:
        zero_launches()
        trainer = train_s2.run(cfg.replace(num_iter=n), ld, semantic=semantic)
        torch.cuda.synchronize()
        runs.append(dict(step=trainer.state.step, steps=len(trainer.history),
                         launches=launches(), digest=state_digest(
                             trainer.state),
                         losses=[h["total_loss"] for h in trainer.history]))
    batch = prepare_batch(next(iter(loader())))   # the first run's first
    assert batch["img"].device == resolve_device("cuda")
    state = trainer.state
    for _ in range(DP_PROBES):
        state, sc = trainer.step_fn(state, batch)
    return dict(runs=runs, first_total=runs[0]["losses"][0],
                last_total=sc["total_loss"].item(),
                probe_digest=state_digest(state))


def dp_ranks(specs, train):
    """Phase 17's work on each spawned rank: the steps of 17b and 17c
    (dp_rank_steps), then 17d's training run (dp_train_rank)."""
    return dp_rank_steps(specs), dp_train_rank(*train)


def dp_cards_rank(out_dir, specs, train):
    """dp_ranks on a rank that parallel.launch spawned (chip_smoke.py
    --cards N), its readings pickled to out_dir/rank{r}.pkl."""
    from umr_tpu_torch.parallel import rank_and_size

    out = dp_ranks(specs, train)
    with open(os.path.join(out_dir, f"rank{rank_and_size()[0]}.pkl"),
              "wb") as f:
        pickle.dump(out, f)


def dp_train_cfg(tcfg):
    """17d's configuration: phase 7's, logging every step, the part points
    the category loader draws, a fresh checkpoint directory."""
    return tcfg.replace(checkpoint_dir=tempfile.mkdtemp(), name="dp",
                        print_freq=1, use_scops=True)


def hold_train(outs, cfg, where, smi):
    """17d's readings (dp_train_rank's, per rank): every run's steps and
    resume, 3 forward + 2 backward launches a step on every rank, equal
    states on every rank after each run and after the probes, one writer
    of the run's files (one log line a step), a falling loss. Returns the
    readings."""
    r0 = outs[0]
    run_dir = os.path.join(cfg.checkpoint_dir, cfg.name)
    files = sorted(os.listdir(run_dir))
    with open(os.path.join(run_dir, "loss_log.txt")) as f:
        log = f.read().splitlines()
    steps = [(r["step"], r["steps"]) for r in r0["runs"]]
    want = [(n, n - m) for m, n in zip((0,) + DP_TRAIN_RUNS, DP_TRAIN_RUNS)]
    equal = all(o["probe_digest"] == r0["probe_digest"] and
                [r["digest"] for r in o["runs"]] ==
                [r["digest"] for r in r0["runs"]] for o in outs)
    msg = (f"17d: train_s2.run on {where} from the category loader's rank "
           f"blocks: runs to num_iter {list(DP_TRAIN_RUNS)} (step, steps "
           f"taken) {steps} (expected {want}); launches per rank and run "
           f"{[[r['launches'] for r in o['runs']] for o in outs]} (expected "
           "3 forward + 2 backward a step); states equal on every rank "
           f"{equal}; files {files}; total_loss on the first batch "
           f"{r0['first_total']:.4f} at step 1, {r0['last_total']:.4f} after "
           f"{DP_TRAIN_RUNS[-1] + DP_PROBES - 1} updates [{smi}]")
    print(msg, flush=True)
    assert steps == want, msg
    assert all(r["launches"] == (3 * r["steps"], 0, 2 * r["steps"])
               for o in outs for r in o["runs"]), msg
    assert equal, msg
    assert files == ["loss_log.txt", "opts.log", "pred_net_latest.pth",
                     "pred_state.pt", "stage_budget.json"], msg
    assert sum("Training Loss" in line for line in log) == len(
        DP_TRAIN_RUNS), msg
    assert sum(line.startswith("(epoch") for line in log) == DP_TRAIN_RUNS[
        -1], msg
    assert (math.isfinite(r0["last_total"])
            and r0["last_total"] < r0["first_total"]), msg
    return dict(steps=steps, launches=[[list(r["launches"]) for r in o["runs"]]
                                       for o in outs],
                first_total=r0["first_total"], last_total=r0["last_total"])


def dp_s2_spec(seg, pvi, batch, seed):
    """One s2 step (phase 7's configuration) at a global batch of `batch`
    as a tests/torch_ranks.py::rank_steps spec: a seeded batch and
    global draws, on the card, then timed."""
    from umr_tpu_torch.data import synthetic_batch
    from umr_tpu_torch.training.trainer import prepare_batch

    rng = np.random.RandomState(seed)
    kw = dict(batch_size=batch, image_size=IMAGE_SIZE, img_size=IMAGE_SIZE,
              subdivide=SUBDIVIDE, tex_size=6, num_hypo_cams=8)
    return dict(stage=2, kw=kw, template=(SUBDIVIDE, 1, 6), seg=seg, pvi=pvi,
                batch=prepare_batch(synthetic_batch(rng, batch, IMAGE_SIZE)),
                draws=dict(
                    eps=rng.normal(size=(batch, 350)).astype(np.float32),
                    sample_inds=rng.randint(0, 8, size=(batch, 1)),
                    angles=rng.randint(0, 180, size=batch)),
                device="cuda", timed=DP_TIMED)


def dp_specs(seg, pvi):
    """Phase 17's steps as rank_steps specs: one s2 step at a global batch
    of TRAIN_BATCH (dp_s2_spec), and the template update then one s1 step
    at S1_BATCH (phase 10's configuration), seeded, on the card."""
    from umr_tpu_torch.cli import S1_DEFAULTS
    from umr_tpu_torch.data import synthetic_batch
    from umr_tpu_torch.training.trainer import prepare_batch

    rng = np.random.RandomState(18)
    kw = dict(S1_DEFAULTS, batch_size=S1_BATCH, image_size=IMAGE_SIZE,
              img_size=IMAGE_SIZE, subdivide=SUBDIVIDE, tex_size=6)
    s1 = dict(stage=1, kw=kw, template=(SUBDIVIDE, 1, 6),
              batch=prepare_batch(synthetic_batch(rng, S1_BATCH, IMAGE_SIZE),
                                  use_scops=False),
              draws=dict(
                  eps=rng.normal(size=(S1_BATCH, 350)).astype(np.float32),
                  angles=rng.randint(0, 180, size=S1_BATCH)),
              template_batches=[prepare_batch(
                  synthetic_batch(rng, S1_BATCH, IMAGE_SIZE),
                  use_scops=False)],
              device="cuda")
    return dp_s2_spec(seg, pvi, TRAIN_BATCH, 17), s1


def hold_ranks(one, ranks, where, smi):
    """The ranks' s2 and s1 steps (rank_steps outputs, per rank) against
    one process's on the same inputs: launches per rank, equal states on
    every rank, gradients (DP_COS, DP_REL), scalars, BatchNorm statistics,
    mean_v after stage 1's template update; the s2 step's ms with its
    all_reduce share beside one process's. Returns the readings."""
    rec = {}
    for i, (label, want, batch) in enumerate((
            ("s2", (3, 0, 2), TRAIN_BATCH), ("s1", (3, 1, 2), S1_BATCH))):
        outs, ref = [r[i] for r in ranks], one[i]
        r0 = outs[0]
        total = math.sqrt(sum(float(np.sum(v.astype(np.float64) ** 2))
                              for v in ref["grads"].values()))
        worst = max(float(np.linalg.norm(r0["grads"][k] - v)
                          / (np.linalg.norm(v) + 1e-6 * total))
                    for k, v in ref["grads"].items())
        x = np.concatenate([r0["grads"][k].ravel() for k in ref["grads"]]
                           ).astype(np.float64)
        y = np.concatenate([v.ravel() for v in ref["grads"].values()]
                           ).astype(np.float64)
        cos = float(x @ y / (np.linalg.norm(x) * np.linalg.norm(y)))
        sc_rel = max(abs(r0["scalars"][k] - v) / max(abs(v), 1e-6)
                     for k, v in ref["scalars"].items())
        dstats = max(float(np.abs(r0["buffers"][k] - v).max()
                           / (np.abs(v).max() + 1e-6))
                     for k, v in ref["buffers"].items())
        equal = all(o["digest"] == r0["digest"] for o in outs)
        rec[label] = dict(launches=[list(o["launches"]) for o in outs],
                          cosine=cos, worst_tensor=worst, scalars_rel=sc_rel,
                          stats_rel=dstats, seconds=[o["seconds"]
                                                     for o in outs])
        timing = ""
        if "step_ms" in ref:
            rec[label].update(dp_times(ref, outs))
            t = rec[label]
            timing = (f"; the {len(outs)}-rank step median "
                      f"{t['ranks_ms']:.2f} ms, one process "
                      f"{t['one_process_ms']:.2f} ms; all_reduce "
                      f"{100 * t['all_reduce_share']:.1f}% of the "
                      f"{len(outs)}-rank step with each call between two "
                      f"synchronizes ({t['wrapped_ms']:.2f} ms)")
        msg = (f"{label}: {where} vs one process at batch {batch}: launches "
               f"per rank {[o['launches'] for o in outs]} (expected {want}); "
               f"gradient cosine {cos:.9f} (>= {DP_COS}), worst tensor "
               f"{worst:.3e} (<= {DP_REL}); scalars within {sc_rel:.2e} "
               f"relative (<= {DP_SCALARS_RTOL}); BatchNorm statistics within "
               f"{dstats:.3e} of each buffer's largest (<= {DP_STATS_RTOL}); "
               f"states equal on every rank {equal}{timing}; seconds per "
               f"rank {rec[label]['seconds']}, one process {ref['seconds']} "
               f"[{smi}]")
        print(msg, flush=True)
        assert all(o["launches"] == want for o in outs), msg
        assert ref["launches"] == want, msg
        assert equal, msg
        assert cos >= DP_COS and worst <= DP_REL, msg
        assert sc_rel <= DP_SCALARS_RTOL and dstats <= DP_STATS_RTOL, msg
        if "mean_v" in ref:
            dmv = float(np.abs(r0["mean_v"] - ref["mean_v"]).max())
            msg = (f"s1 template update from {r0['count']} images on "
                   f"{where}, before the step: mean_v within {dmv:.3e} of "
                   f"one process's ({ref['count']} images; <= "
                   f"{DP_MEAN_V_ATOL})")
            print(msg, flush=True)
            assert all(o["count"] == ref["count"] == batch for o in outs)
            assert all(np.array_equal(o["mean_v"], r0["mean_v"])
                       for o in outs), msg
            assert dmv <= DP_MEAN_V_ATOL, msg
            rec[label]["mean_v_max_abs"] = dmv
    return rec


def dp_times(ref, outs):
    """The ranks' timed steps (each the slowest rank's) against one
    process's, medians; the share of all_reduce in the ranks' steps, read
    on the steps that time each all_reduce call between two
    synchronizes."""
    steps = [max(t) for t in zip(*(o["step_ms"] for o in outs))]
    wrapped = [max(t) for t in zip(*(o["wrapped_ms"] for o in outs))]
    comm = [np.mean(t) for t in zip(*(o["all_reduce_ms"] for o in outs))]
    return dict(ranks_ms=float(np.median(steps)),
                all_reduce_share=float(np.median(
                    [c / m for c, m in zip(comm, wrapped)])),
                wrapped_ms=float(np.median(wrapped)),
                one_process_ms=float(np.median(ref["step_ms"])))


def data_parallel(smi, tcfg, tloader, seg, pvi, phase7_ms):
    """Phase 17, data parallelism (parallel/mesh.py). 17a: train_s2.run at
    phase 7's configuration in a one-rank NCCL group that
    parallel.launch joins from torchrun's environment, in this process
    (3 + 2 launches per step, a falling loss, one writer of the run's
    files). 17b and 17c: two ranks that parallel.spawn (launch's spawn
    branch) starts on the one card (gloo), each from init_fn(seed +
    rank) and then rank 0's state (parallel.replicate): one s2 step at a
    global batch of 16, and the template update then one s1 step at 64,
    the global draws injected, against one process at the global batch
    on the same inputs (tests/torch_ranks.py::rank_steps both ways):
    averaged gradients, scalars, BatchNorm statistics, mean_v; equal
    states (weights, buffers, optimizer state, generator) on both ranks;
    per-rank launches; the two-rank s2 step timed with its all_reduce
    share. 17d, on the same two ranks: train_s2.run at a global batch of
    16 from the category loader, resumed (hold_train). Returns the
    readings."""
    from umr_tpu_torch.parallel import launch, spawn

    t_phase = time.perf_counter()
    rec = {}
    # 17a: launch's torchrun path, in this process (a group of one)
    ckpt = tempfile.mkdtemp()
    acfg = tcfg.replace(checkpoint_dir=ckpt, name="dp", print_freq=1)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env = dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", LOCAL_WORLD_SIZE="1",
               MASTER_ADDR="localhost", MASTER_PORT=str(port))
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    box = []
    try:
        launch(dp_train_s2, acfg, tloader, (None, seg, pvi), box)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v
    (a,) = box
    first = a["history"][0]["total_loss"]
    files = sorted(os.listdir(os.path.join(ckpt, "dp")))
    with open(os.path.join(ckpt, "dp", "loss_log.txt")) as f:
        log = f.read().splitlines()
    msg = (f"17a: train_s2.run in a {a['world']}-rank {a['backend']} group "
           f"on {a['device']}: {a['step']} steps, raster_fwd launches "
           f"{a['launches'][0]}, raster_bwd {a['launches'][2]} in its "
           f"{TRAIN_STEPS} steps (expected 3 and 2 per step); files {files}; "
           f"total_loss on the first batch {first:.4f} at step 1, "
           f"{a['last_total']:.4f} after {a['step'] - 1} updates; step "
           f"median {a['ms']:.2f} ms over {TIMED_STEPS} steps (phase 7, no "
           f"group: {phase7_ms:.2f} ms) [{smi}]")
    print(msg, flush=True)
    assert a["launches"] == (3 * TRAIN_STEPS, 0, 2 * TRAIN_STEPS), msg
    assert (a["backend"], a["world"]) == ("nccl", 1), msg
    assert files == ["loss_log.txt", "opts.log", "pred_net_latest.pth",
                     "pred_state.pt", "stage_budget.json"], msg
    assert sum("Training Loss" in line for line in log) == 1, msg
    assert sum(line.startswith("(epoch") for line in log) == TRAIN_STEPS
    assert math.isfinite(a["last_total"]) and a["last_total"] < first, msg
    rec["a"] = dict(launches=list(a["launches"]), ms=a["ms"],
                    times=a["times"], phase7_ms=phase7_ms, first_total=first,
                    last_total=a["last_total"])

    # 17b and 17c: the same inputs, one process and two ranks
    s2, s1 = dp_specs(seg, pvi)
    t0 = time.perf_counter()
    one = dp_rank_steps([s2, s1])
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    dcfg = dp_train_cfg(tcfg)
    ranks = spawn(dp_ranks, 2, [s2, s1], (dcfg, (None, seg, pvi)),
                  device="cuda")
    t2 = time.perf_counter()
    rec["seconds"] = dict(a=t0 - t_phase, one_process=t1 - t0,
                          two_ranks=t2 - t1)
    print(f"17b/c/d: one process {t1 - t0:.1f} s, two ranks "
          f"{t2 - t1:.1f} s", flush=True)
    where = "2 ranks (gloo, one card)"
    held = hold_ranks(one, [r[0] for r in ranks], where, smi)
    rec["17b"], rec["17c"] = held["s2"], held["s1"]
    rec["17d"] = hold_train([r[1] for r in ranks], dcfg, where, smi)
    print("the two-rank times are a functional check: gloo copies every "
          "all_reduce through the host, and both ranks share one card; "
          "they are not the speed of two cards", flush=True)
    rec["phase_s"] = time.perf_counter() - t_phase
    print(f"phase 17: {rec['phase_s']:.1f} s [{smi}]", flush=True)
    return rec


# phase 18, tensor parallelism and the checking tools. 18a: one s2 Adam
# step (phase 7's configuration, batch 16) through
# parallel.tensor_parallel_step on two ranks sharing the card (gloo) as
# a (1, 2) mesh at the default min_size, against one process on the same
# inputs: gradients at phase 17's bounds (the step's chaos, above), the
# moments' shards against the one-process moments' slices at the same
# bounds (exp_avg_sq, (1 - beta2) g^2, at twice the per-tensor bound),
# each rank's parameters Adam's first step on its own gradient within
# TP_ADAM_ERR of lr beyond two float32 roundings (reading 6.0e-4 lr before
# those were allowed for: the rounding of a parameter near 1 at lr 1e-4),
# the parameters after the step apart from one
# process's by more than 0.1 lr only where the two gradients' signs
# differ (Adam's first step is about lr sign(g); their share is printed:
# 0.0155% on the (1, 2) mesh, whose ranks compute the one-process batch,
# 1.67% on a 2 x 2 NCCL mesh, whose global BatchNorm sums in another
# order at gradient cosine 0.99899); the leaves JAX's rule shards at this
# configuration (tests/test_torch_tensor_parallel.py pins them to JAX's
# param_partition_specs at Config()'s widths): the texture head's fc and
# its two moments. 18b: dryrun_multichip 4 on the one card (gloo, 2 x 2).
# 18c: check_fused_grads through the kernels. 18d: soak_train at full
# width, each stage over a few rotating batches (SOAK_S2's and SOAK_S1's
# --n_batches: a fresh batch per step costs the host 0.5 s (s2) and 2.4 s
# (s1) to make, more than the step).
TP_LEAVES = ["model.texture_predictor.enc.1.0.weight",
             "model.texture_predictor.enc.1.0.weight:exp_avg",
             "model.texture_predictor.enc.1.0.weight:exp_avg_sq"]
TP_ADAM_ERR = 1e-3
SOAK_S2 = ["--stage", "s2", "--steps", "100", "--batch", "16",
           "--n_batches", "4"]
SOAK_S1 = ["--stage", "s1", "--steps", "150", "--batch", "64",
           "--template_update_every", "50", "--n_batches", "2"]
# Stage 1's soak under the tool's Config() on the synthetic ellipse
# batches: the total loss falls from ~18 to ~7.4 in every run, but the
# mask IoU, head (steps 0-20) to tail, rose in 7 and fell in 3 of 10 runs
# of 150-300 steps (e.g. 0.319 -> 0.349, 0.308 -> 0.282, 0.311 -> 0.330,
# 0.310 -> 0.258; NVIDIA H100 80GB HBM3, 700.00 W): the mask term barely
# moves while the flatten and Laplacian terms settle, and the kernels'
# atomics give each run its own path. So 18d prints s1's IoU trend and
# holds its loss and template; s2's trends are all held.


def tp_rank(mesh_shape, specs):
    """tests/torch_ranks.py::rank_tp with TF32 off, in a spawned rank as
    in this process."""
    from torch_ranks import rank_tp

    no_tf32()
    return rank_tp(mesh_shape, specs)


def tp_spec(seg, pvi, batch, seed):
    """One s2 Adam step at a global batch of `batch` (dp_s2_spec) through
    shard_state at the default min_size, returning the gathered
    gradients and parameters and each rank's moment shards."""
    return dict(dp_s2_spec(seg, pvi, batch, seed), min_size=1 << 22,
                full=("grad", "param"), shard_moments=True)


def _grads_held(got, ref, rel):
    """(worst per-tensor ||got - ref|| / (||ref|| + 1e-6 x the norm of all
    of ref), cosine of all) over ref's keys."""
    total = math.sqrt(sum(float(np.sum(v.astype(np.float64) ** 2))
                          for v in ref.values()))
    worst = max(float(np.linalg.norm(got[k] - v)
                      / (np.linalg.norm(v) + 1e-6 * total))
                for k, v in ref.items())
    x = np.concatenate([got[k].ravel() for k in ref]).astype(np.float64)
    y = np.concatenate([v.ravel() for v in ref.values()]).astype(np.float64)
    return worst, float(x @ y / (np.linalg.norm(x) * np.linalg.norm(y)))


def hold_tp(one, ranks, mesh_shape, lr, where, smi):
    """18a's readings: rank_tp's outputs of the ranks (a mesh_shape group)
    against one process's, an Adam step at learning rate lr. Returns the
    readings."""
    n_data, n_model = mesh_shape
    ref = one["specs"][0]
    outs = [r["specs"][0] for r in ranks]
    r0 = outs[0]
    g, gref = ({k: v["grad"] for k, v in o["full"].items() if "grad" in v}
               for o in (r0, ref))
    worst, cos = _grads_held(g, gref, DP_REL)
    # the moments' shards against the one-process moments' slices
    mworst = {}
    for rank, o in enumerate(outs):
        m = rank % n_model
        for name, full, shard, dim in o["sharded"]:
            got = o["moment_shards"].get(name, {})
            for k, v in got.items():
                want = np.take(ref["full"][name][k], range(
                    m * shard[dim], (m + 1) * shard[dim]), axis=dim)
                assert v.shape == want.shape == tuple(shard), (name, k)
                w, c = _grads_held({name: v}, {name: want}, DP_REL)
                mworst[k] = max(mworst.get(k, 0.0), w)
                assert c >= DP_COS, (name, k, c)
    # the parameters after the step apart from one process's by > 0.1 lr,
    # and of them those the gradients do not explain: Adam's first step
    # moves an element by lr g / (|g| + 1e-8), so two such steps are that
    # far apart only where the two gradients' signs differ or one is
    # below 1e-7
    apart = total = unexplained = 0
    for k, v in r0["full"].items():
        far = np.abs(v["param"] - ref["full"][k]["param"]) > 0.1 * lr
        a = v.get("grad", np.zeros_like(v["param"]))
        b = ref["full"][k].get("grad", np.zeros_like(a))
        flip = (np.sign(a) != np.sign(b)) | (np.minimum(
            np.abs(a), np.abs(b)) < 1e-7)
        apart += int(far.sum())
        unexplained += int((far & ~flip).sum())
        total += far.size
    # replicated state bit-equal within each model group, shards within
    # each data group
    equal = ([len({o["digests"][0] for o in outs[d * n_model:
                                                 (d + 1) * n_model]}) == 1
              for d in range(n_data)]
             + [len({o["digests"][1] for o in outs[m::n_model]}) == 1
                for m in range(n_model)])
    peak = [o["peak_gb"] for o in outs]
    ms = float(np.median([max(t) for t in zip(*(o["step_ms"]
                                                 for o in outs))]))
    one_ms = float(np.median(ref["step_ms"]))
    rec = dict(mesh=list(mesh_shape), spec_leaves=r0["spec_leaves"],
               sharded=[list(x[:3]) for x in r0["sharded"]],
               launches=[list(o["launches"]) for o in outs],
               cosine=cos, worst_tensor=worst, moments_worst=mworst,
               adam_err=max(o["adam_err"] for o in outs),
               params_apart=apart / total, unexplained=unexplained,
               peak_gb=peak,
               one_process_peak_gb=ref["peak_gb"], ms=ms,
               one_process_ms=one_ms, seconds=[o["seconds"] for o in outs])
    msg = (f"18a: tensor_parallel_step on {where} as a {tuple(mesh_shape)} "
           f"mesh vs one process at batch {TRAIN_BATCH}: sharded leaves "
           f"{r0['spec_leaves']} (expected {TP_LEAVES}); shards "
           f"{rec['sharded']}; launches per rank {rec['launches']} "
           f"(expected 3 forward + 2 backward); gradient cosine {cos:.9f} "
           f"(>= {DP_COS}), worst tensor {worst:.3e} (<= {DP_REL}); moment "
           f"shards' worst {mworst} (exp_avg <= {DP_REL}, exp_avg_sq <= "
           f"{2 * DP_REL}); Adam's first step on each rank's own gradient "
           f"within {rec['adam_err']:.2e} lr (<= {TP_ADAM_ERR}); parameters "
           f"more than 0.1 lr from one process's at {100 * apart / total:.4f}"
           f"% of the elements, {unexplained} of them where the gradients' "
           f"signs agree (expected 0); replicated state "
           f"bit-equal within each model group and shards within each data "
           f"group {equal}; peak GB per rank "
           f"{[round(p, 3) for p in peak]}, one process "
           f"{ref['peak_gb']:.3f}; the step median {ms:.2f} ms, one process "
           f"{one_ms:.2f} ms [{smi}]")
    print(msg, flush=True)
    assert r0["spec_leaves"] == TP_LEAVES, msg
    for o in outs:
        for name, full, shard, dim in o["sharded"]:
            want = list(full)
            want[dim] //= n_model
            assert list(shard) == want, msg
            assert all(v == tuple(want) for v in
                       o["moment_shapes"].get(name, {}).values()), msg
    assert all(o["launches"] == (3, 0, 2) for o in outs), msg
    assert ref["launches"] == (3, 0, 2), msg
    assert all(equal), msg
    assert cos >= DP_COS and worst <= DP_REL, msg
    assert mworst.get("exp_avg", 0.0) <= DP_REL, msg
    assert mworst.get("exp_avg_sq", 0.0) <= 2 * DP_REL, msg
    assert rec["adam_err"] <= TP_ADAM_ERR and ref["adam_err"] <= (
        TP_ADAM_ERR), msg
    assert unexplained == 0, msg
    return rec


def dryrun_ranks(n, device):
    """dryrun_multichip's n ranks (parallel.spawn; gloo where ranks share
    a card, NCCL where each has its own): rank 0's line, every rank's
    result."""
    from umr_tpu_torch.experiments import dryrun_multichip
    from umr_tpu_torch.parallel import spawn

    outs = spawn(dryrun_multichip.rank, n, n, device, device=device)
    return dryrun_multichip.line(n, outs[0]), outs


def hold_dryrun(line, outs, n, where, smi):
    """18b's readings: JAX's line with the (n/2, 2) mesh and 143 sharded
    leaves, a finite loss equal on every rank, 3 + 2 launches a rank."""
    want = f"(mesh {{'data': {n // 2}, 'model': 2}}, 143 tp-sharded weight"
    msg = (f"18b: {line} on {where}; launches per rank "
           f"{[o['launches'] for o in outs]} (expected 3 forward + 2 "
           f"backward) [{smi}]")
    print(msg, flush=True)
    assert want in line and math.isfinite(outs[0]["total"]), msg
    assert all(o["total"] == outs[0]["total"] for o in outs), msg
    assert all(o["launches"] == (3, 0, 2) for o in outs), msg
    return dict(line=line, launches=[list(o["launches"]) for o in outs])


def tensor_parallel(smi, seg, pvi):
    """Phase 18. 18a: one s2 Adam step at a global batch of TRAIN_BATCH on
    two ranks sharing the card (gloo) as a (1, 2) mesh, against one
    process (hold_tp). 18b: dryrun_multichip 4 on the card (2 x 2 over
    gloo). 18c: check_fused_grads through the kernels (3 forward + 3
    backward launches). 18d: soak_train's s2 and s1 at full width
    (SOAK_S2, SOAK_S1): s2's trends, s1's loss and template (its IoU
    trend printed), the launches of their steps. Returns the readings."""
    from umr_tpu_torch.experiments import check_fused_grads, soak_train
    from umr_tpu_torch.parallel import spawn

    t_phase = time.perf_counter()
    rec = {}
    spec = tp_spec(seg, pvi, TRAIN_BATCH, 23)
    t0 = time.perf_counter()
    one = tp_rank(None, [dict(spec, full=None)])
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    ranks = spawn(tp_rank, 2, (1, 2), [spec], device="cuda")
    t2 = time.perf_counter()
    rec["18a"] = hold_tp(one, ranks, (1, 2), 1e-4, "2 ranks (gloo, one "
                         "card)", smi)
    rec["18a"]["seconds_total"] = dict(one_process=t1 - t0, ranks=t2 - t1)
    print(f"18a: one process {t1 - t0:.1f} s, two ranks {t2 - t1:.1f} s",
          flush=True)

    t0 = time.perf_counter()
    rec["18b"] = hold_dryrun(*dryrun_ranks(4, "cuda"), 4,
                             "4 ranks (gloo, one card)", smi)
    rec["18b"]["seconds"] = time.perf_counter() - t0

    zero_launches()
    fused = check_fused_grads.run("cuda")
    torch.cuda.synchronize()
    rec["18c"] = dict(fused, launches=list(launches()))
    msg = (f"18c: check_fused_grads through the kernels: verts grad "
           f"max|diff| {fused['dv']:.3e} (scale {fused['sv']:.3e}), tex "
           f"grad max|diff| {fused['dt']:.3e} (scale {fused['st']:.3e}), "
           f"bound 1e-5 + 1e-3 x scale; launches {launches()} (expected 3 "
           f"forward + 3 backward) [{smi}]")
    print(msg, flush=True)
    assert fused["ok"] and launches() == (3, 0, 3), msg

    for label, argv, want in (("s2", SOAK_S2, (3, 0, 2)),
                              ("s1", SOAK_S1, (3, 1, 2))):
        t0 = time.perf_counter()
        zero_launches()
        summary = soak_train.soak(argv)
        torch.cuda.synchronize()
        steps = int(argv[argv.index("--steps") + 1]) + 1
        got = launches()
        msg = (f"18d: soak_train {' '.join(argv)}: total loss head "
               f"{summary['loss_head_mean']} -> tail "
               f"{summary['loss_tail_mean']}, mask IoU "
               f"{summary['mask_iou_head']} -> {summary['mask_iou_tail']}"
               f"{' (not held)' if label == 's1' else ''}, "
               f"template displacement {summary['template_disp']}; "
               f"{summary['wall_s']} s, {summary['images_per_sec']} "
               f"images/s over {steps - 1} steps; launches {got} (expected "
               f"{steps} x {want}) [{smi}]")
        print(msg, flush=True)
        assert got == tuple(steps * w for w in want), msg
        if label == "s2":
            soak_train.check(summary)
        else:
            # stage 1's mask IoU trend is not held (above SOAK_S1)
            disp = summary["template_disp"]
            assert summary["decreased"], msg
            assert len(disp) >= 2 and max(disp) < 2.0, msg
        rec[f"18d_{label}"] = dict(summary, launches=list(got),
                                   seconds=time.perf_counter() - t0)
    rec["phase_s"] = time.perf_counter() - t_phase
    print(f"phase 18: {rec['phase_s']:.1f} s [{smi}]", flush=True)
    return rec


def tp_cards(n, smi, seg, pvi):
    """python3 chip_smoke.py --cards N (N even): 18a on N ranks, one per
    card (NCCL), as an (N/2, 2) mesh at a global batch of TRAIN_BATCH,
    against one process; then dryrun_multichip N on the N cards."""
    from umr_tpu_torch.parallel import spawn

    mesh_shape = (n // 2, 2)
    spec = tp_spec(seg, pvi, TRAIN_BATCH, 23)
    one = tp_rank(None, [dict(spec, full=None)])
    torch.cuda.empty_cache()
    ranks = spawn(tp_rank, n, mesh_shape, [spec], device="cuda")
    where = f"{n} ranks (NCCL, {n} cards)"
    rec = {"18a": hold_tp(one, ranks, mesh_shape, 1e-4, where, smi),
           "18b": hold_dryrun(*dryrun_ranks(n, "cuda"), n, where, smi)}
    print(json.dumps({"tensor_parallel": rec}), flush=True)
    return rec


def multi_card(n, phases=("17", "18")):
    """python3 chip_smoke.py --cards N [--phase 17|18], on a machine with N
    cards. Phase 17: its steps on N ranks, one per card, that
    parallel.launch spawns as the training entry points do (NCCL),
    against one process at the global batch (hold_ranks), then the s2
    step at N x TRAIN_BATCH (each rank TRAIN_BATCH images) timed against
    one process at TRAIN_BATCH: the images a second of N cards beside
    one card's; then 17d's training run on the N ranks (hold_train).
    Phase 18 (N even): tp_cards."""
    from umr_tpu_torch.experiments.raster_bench import synthetic_semantic
    from umr_tpu_torch.mesh import build_template
    from umr_tpu_torch.ops import raster_kernel

    if torch.cuda.device_count() != n:
        raise SystemExit(f"chip_smoke --cards {n}: "
                         f"{torch.cuda.device_count()} cards visible")
    no_tf32()
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    smi = "; ".join(sh(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"]).splitlines())
    print(f"nvidia-smi: {smi}", flush=True)
    raster_kernel.build()
    seg, pvi = synthetic_semantic(build_template(SUBDIVIDE, 1, 6))
    if "17" in phases:
        dp_cards(n, smi, seg, pvi)
    if "18" in phases:
        tp_cards(n, smi, seg, pvi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def dp_cards(n, smi, seg, pvi):
    """multi_card's phase 17 (its docstring). Returns the readings."""
    from umr_tpu_torch.config import Config
    from umr_tpu_torch.parallel import launch

    s2, s1 = dp_specs(seg, pvi)
    wide = dp_s2_spec(seg, pvi, n * TRAIN_BATCH, 19)
    t0 = time.perf_counter()
    one = dp_rank_steps([s2, s1])
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    dcfg = dp_train_cfg(Config(
        batch_size=TRAIN_BATCH, image_size=IMAGE_SIZE, subdivide=SUBDIVIDE,
        tex_size=6, num_hypo_cams=8).sync_image_size())
    out_dir = tempfile.mkdtemp()
    launch(dp_cards_rank, out_dir, [s2, s1, wide], (dcfg, (None, seg, pvi)))
    ranks = []
    for r in range(n):
        with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
    print(f"one process {t1 - t0:.1f} s, {n} ranks "
          f"{time.perf_counter() - t1:.1f} s", flush=True)
    where = f"{n} ranks (NCCL, {n} cards)"
    rec = hold_ranks(one, [r[0][:2] for r in ranks], where, smi)
    outs = [r[0][2] for r in ranks]
    assert all(o["launches"] == (3, 0, 2) for o in outs)
    assert all(o["digest"] == outs[0]["digest"] for o in outs)
    rec["wide"] = dp_times(one[0], outs)
    per_s = {"1": TRAIN_BATCH / rec["wide"]["one_process_ms"] * 1e3,
             str(n): n * TRAIN_BATCH / rec["wide"]["ranks_ms"] * 1e3}
    rec["wide"]["images_per_s"] = per_s
    w = rec["wide"]
    print(f"s2 at {TRAIN_BATCH} images a card: {n} cards {w['ranks_ms']:.2f} "
          f"ms a step, {per_s[str(n)]:.1f} images/s; one card "
          f"{w['one_process_ms']:.2f} ms, {per_s['1']:.1f} images/s; "
          f"all_reduce {100 * w['all_reduce_share']:.1f}% of the step with "
          f"each call between two synchronizes ({w['wrapped_ms']:.2f} ms) "
          f"[{smi}]", flush=True)
    rec["17d"] = hold_train([r[1] for r in ranks], dcfg, where, smi)
    print(json.dumps({"data_parallel": rec}))
    return rec


# phase 19, the off-path tools: profile_step at bench.py's s2 width (each
# row's launches per call), both RotNet pretraining tools on the synthetic
# category's images (phase 14's, generate_dataset seed 0) into a temporary
# directory, weights/ untouched, their files loaded by build_s2_step's
# init_fn under UMR_TPU_RESNET_WEIGHTS / UMR_TPU_LPIPS_WEIGHTS; the
# voxelizer on the card against the CPU on 16 s2 meshes.
PROFILE_SIZES = dict(batch=TRAIN_BATCH, size=IMAGE_SIZE, subdivide=SUBDIVIDE,
                     tex=6, hypo=8, aa=True)
PROFILE_ITERS = 4
# (forward, backward) launches of one call of each row (the others: none)
PROFILE_LAUNCHES = {"FULL step": (3, 2),
                    "fused hypo render fwd+bwd (B*K)": (1, 1),
                    "hard render fwd (B)": (1, 0),
                    "GAN unseen rgb render fwd+bwd (B)": (1, 1),
                    "part-matching fwd+bwd (B)": (2, 2)}
PRETRAIN_STEPS = 30
VOXEL_R = 32


def weights_digest():
    """sha256 of each file under weights/, by name."""
    import hashlib

    out = {}
    wdir = os.path.join(ROOT, "weights")
    for name in sorted(os.listdir(wdir)):
        with open(os.path.join(wdir, name), "rb") as f:
            out[name] = hashlib.sha256(f.read()).hexdigest()
    return out


def unit_box(verts):
    """Meshes [B,V,3], each scaled by its largest extent into
    [0.1, 0.9]^3."""
    lo = verts.amin(1, keepdim=True)
    span = (verts.amax(1, keepdim=True) - lo).amax(-1, keepdim=True)
    return 0.1 + 0.8 * (verts - lo) / span


def off_path(dev, smi, template):
    """Phase 19. 19a: profile_step at PROFILE_SIZES, each row's launches
    per call asserted (PROFILE_LAUNCHES) and the whole run's, the rows
    ranked. 19b: pretrain_trunk and pretrain_lpips, PRETRAIN_STEPS each on
    the category's images written as a train.npz in a temporary
    directory: a falling loss (mean of the first 5 steps against the last
    5), weights/ byte-identical, then build_s2_step's init_fn under both
    overrides loads the new files (trunk_pretrained True). 19c: voxelize
    at VOXEL_R on 19a's 16 s2 meshes on the card, equal to the CPU's.
    Returns the readings."""
    import shutil

    from umr_tpu_torch.config import Config
    from umr_tpu_torch.data.synthetic_category import generate_dataset
    from umr_tpu_torch.experiments import (pretrain_lpips, pretrain_trunk,
                                           profile_step)
    from umr_tpu_torch.losses.composite import PartMatchingLoss
    from umr_tpu_torch.models.weights import load_npz, load_resnet18_npz
    from umr_tpu_torch.ops.voxelize import voxelize
    from umr_tpu_torch.renderer import SoftRenderer
    from umr_tpu_torch.training.steps import build_s2_step

    t_phase = time.perf_counter()
    rec = {}
    zero_launches()
    prof = profile_step.run(dev, PROFILE_ITERS, PROFILE_SIZES)
    torch.cuda.synchronize()
    total = launches()
    rows = prof["rows"]
    for r in rows:
        want = PROFILE_LAUNCHES.get(r["name"], (0, 0))
        assert (r["fwd_launches"], r["bwd_launches"]) == want, (r, want)
    calls = 1 + PROFILE_ITERS
    per_call = [sum(w[i] for w in PROFILE_LAUNCHES.values()) for i in (0, 1)]
    msg = (f"19a: profile_step launches {total} (expected {calls} calls x "
           f"{per_call[0]} forward, 0 p2f, {per_call[1]} backward)")
    assert total == (calls * per_call[0], 0, calls * per_call[1]), msg
    full = next(r["ms"] for r in rows if r["name"] == "FULL step")
    parts = sum(r["ms"] for r in rows if r["name"] != "FULL step")
    print(f"{msg}; the rows ranked, ms a call (batch {TRAIN_BATCH}, "
          f"{IMAGE_SIZE}^2, AA, K=8, F={template.faces.shape[0]}, T2=36; "
          f"isolation re-runs model work, so the components sum to "
          f"{parts:.2f} against the FULL step's {full:.2f}) [{smi}]:")
    for r in sorted(rows, key=lambda r: -r["ms"]):
        print(f"  {r['name']:34s} {r['ms']:9.3f} ms  launches "
              f"{r['fwd_launches']} + {r['bwd_launches']}", flush=True)
    rec["19a"] = dict(rows=[{k: r[k] for k in ("name", "ms", "value",
                                               "fwd_launches",
                                               "bwd_launches")}
                            for r in rows],
                      launches=list(total), components_ms=parts,
                      full_ms=full)
    meshes = unit_box(prof["pieces"]["pred_vs"].detach())
    del prof
    torch.cuda.empty_cache()

    before = weights_digest()
    data = generate_dataset(template, GEN_N, seed=0, image_size=IMAGE_SIZE,
                            batch=TRAIN_BATCH, device=dev)
    tmp = tempfile.mkdtemp()
    try:
        npz = os.path.join(tmp, "train.npz")
        np.savez(npz, img=data["img"])
        del data
        common = ["--data", npz, "--steps", str(PRETRAIN_STEPS), "--batch",
                  str(TRAIN_BATCH), "--device", str(dev)]
        zero_launches()
        trunk = pretrain_trunk.main(common + [
            "--out", os.path.join(tmp, "trunk", "resnet18_params.npz")])
        lp = pretrain_lpips.main(common + [
            "--out", os.path.join(tmp, "lpips", "lpips_alex.npz")])
        assert launches() == (0, 0, 0), launches()
        for label, r in (("pretrain_trunk", trunk), ("pretrain_lpips", lp)):
            head, tail = np.mean(r["losses"][:5]), np.mean(r["losses"][-5:])
            msg = (f"19b: {label}: {PRETRAIN_STEPS} steps x {TRAIN_BATCH}x4 "
                   f"rotations on {GEN_N} category images in "
                   f"{r['wall_s']:.2f} s; loss mean of steps 1-5 {head:.4f}"
                   f" -> last 5 {tail:.4f}, rotation accuracy "
                   f"{np.mean(r['accs'][:5]):.3f} -> "
                   f"{np.mean(r['accs'][-5:]):.3f} [{smi}]")
            print(msg, flush=True)
            assert tail < head, msg
            rec[f"19b_{label}"] = dict(loss_head=head, loss_tail=tail,
                                       wall_s=r["wall_s"],
                                       losses=r["losses"])
        assert weights_digest() == before, "weights/ changed"
        print("19b: weights/ byte-identical (sha256 of "
              f"{len(before)} files)", flush=True)

        cfg = Config(image_size=IMAGE_SIZE, img_size=IMAGE_SIZE,
                     batch_size=TRAIN_BATCH, subdivide=SUBDIVIDE)
        rng = np.random.RandomState(0)
        seg = rng.randint(0, 5, size=(128, 256)).astype(np.float32)
        idx = rng.permutation(template.num_verts)
        part_loss = PartMatchingLoss.build(
            seg, template.uv_sampler, template.num_sym_faces,
            SoftRenderer(image_size=IMAGE_SIZE, ambient_intensity=1.0,
                         directional_intensity=0.0), device=dev)
        model, _, lpips, init_fn, _ = build_s2_step(
            cfg, template, part_loss,
            [idx[a:b] for a, b in profile_step.PART_SLICES], dev)
        os.environ["UMR_TPU_RESNET_WEIGHTS"] = trunk["out"]
        os.environ["UMR_TPU_LPIPS_WEIGHTS"] = lp["out"]
        try:
            state = init_fn(0)
        finally:
            os.environ.pop("UMR_TPU_RESNET_WEIGHTS")
            os.environ.pop("UMR_TPU_LPIPS_WEIGHTS")
        sd = model.state_dict()
        want = load_resnet18_npz(trunk["out"], trunk["stats"])
        assert all(torch.equal(sd[k].cpu(), v) for k, v in want.items())
        alex = load_npz(lp["out"])
        assert all(np.array_equal(
            c.weight.detach().cpu().numpy().transpose(2, 3, 1, 0),
            alex[f"conv{i}"]["kernel"]) for i, c in enumerate(lpips.convs))
        print(f"19b: build_s2_step's init_fn under UMR_TPU_RESNET_WEIGHTS "
              f"and UMR_TPU_LPIPS_WEIGHTS: trunk_pretrained "
              f"{state.trunk_pretrained}, {len(want)} trunk tensors and "
              f"{len(alex)} LPIPS convs equal to the written files",
              flush=True)
        assert state.trunk_pretrained is True
        del model, lpips, init_fn, state, sd
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()

    fv = meshes[:, torch.as_tensor(template.faces, device=dev).long()]
    ms, occ = cuda_time(lambda: voxelize(fv, VOXEL_R), 3)
    t0 = time.perf_counter()
    ref = voxelize(fv.cpu(), VOXEL_R)
    cpu_ms = (time.perf_counter() - t0) * 1e3
    diff = int((occ.cpu() != ref).sum())
    vol = ref.sum(dim=(1, 2, 3)).tolist()
    msg = (f"19c: voxelize R={VOXEL_R} on {fv.shape[0]} s2 meshes (F="
           f"{fv.shape[1]}) on the card {ms:.3f} ms, on the CPU "
           f"{cpu_ms:.1f} ms; {diff} voxels differ; occupied "
           f"{min(vol)}..{max(vol)} of {VOXEL_R ** 3} [{smi}]")
    print(msg, flush=True)
    assert diff == 0 and min(vol) > 0, msg
    rec["19c"] = dict(ms=ms, cpu_ms=cpu_ms, differ=diff, occupied=vol)
    rec["phase_s"] = time.perf_counter() - t_phase
    print(f"phase 19: {rec['phase_s']:.1f} s [{smi}]", flush=True)
    return rec


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device visible")
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from golden_raster import golden_soft_rasterize
    from umr_tpu_torch.config import Config
    from umr_tpu_torch import tracing
    from umr_tpu_torch.data import synthetic_batch
    from umr_tpu_torch.experiments import demo, test_iou
    from umr_tpu_torch.experiments.profile_slice import random_model
    from umr_tpu_torch.experiments.raster_bench import (
        ptxas_usage, render_bounds, render_bwd, render_fwd, step_renders,
        synthetic_semantic)
    from umr_tpu_torch.experiments.profile_slice import trace_events
    from umr_tpu_torch.experiments.raster_bound import (bins_bound, lanes,
                                                        pair_counts,
                                                        raster_bound)
    from umr_tpu_torch.mesh import build_template
    from umr_tpu_torch.models import symmetrize
    from umr_tpu_torch.ops import raster_bins, raster_kernel
    from umr_tpu_torch.ops.raster_bins import (_full_bins_plain,
                                               face_tile_rect, full_entries,
                                               full_raster_bins)
    from umr_tpu_torch.ops.rasterize import soft_rasterize, threshold_of
    from umr_tpu_torch.ops.rasterize_bwd import soft_rasterize_bwd
    from umr_tpu_torch.renderer import (SoftRenderer, apply_lighting,
                                        surface_normals)

    no_tf32()
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
    usage = ptxas_usage(raster_kernel.BUILD_LOG)
    for name_, (n_reg, st, ld) in sorted(usage.items()):
        print(f"  ptxas: {name_}: {n_reg} registers, spill stores {st} "
              f"bytes, spill loads {ld} bytes")
    assert any(k.startswith("raster_bwd_kernel") for k in usage), usage

    def regs(kernel):
        """'R registers, spill s/l bytes' of one instance, from ptxas."""
        n_reg, st, ld = usage[kernel]
        return f"{kernel}: {n_reg} registers, spill {st}/{ld} bytes"

    phase("3. kernel vs plain version on the card")
    template = build_template(SUBDIVIDE, 1, 6)
    F = template.faces.shape[0]
    rend = SoftRenderer(image_size=IMAGE_SIZE)     # 2x anti-aliased render
    S = rend.render_size
    # the kernels walk every entry of the main path's bins: at most every
    # face in a tile, padded
    cap = full_entries(F, 1)
    rkw = dict(image_size=S, sigma_val=rend.sigma_val,
               dist_eps=rend.dist_eps, gamma_val=rend.gamma_val)
    max_err = 0.0
    for mode, T2, seed in (("softmax", 36, 1), ("softmax", 1, 2),
                           ("hard", 36, 3)):
        fv, tex = sphere_scenes(rend, template, SCENE_B, T2, seed, dev)
        tex = None if T2 == 1 else tex
        full = full_raster_bins(fv, S, rend.sigma_val, rend.dist_eps)
        most = int(torch.diff(full[1], dim=1).max())
        kw = dict(rkw, aggr_func_rgb=mode)
        out = raster_kernel.soft_rasterize_fwd(fv, tex, **kw)
        torch.cuda.synchronize()
        ref = soft_rasterize(fv, tex, **kw)
        max_err = max(max_err, compare(
            f"{mode} T2={T2} B={SCENE_B} F={F} S={S} (fullest tile "
            f"{most} entries)", out, ref, mode == "hard")["rgba"])

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
            fv, tex, **kw), 20)
        ms_b, _ = cuda_time(lambda: full_raster_bins(
            fv, S, rend.sigma_val, rend.dist_eps), 20)
        ms_p, ref = cuda_time(lambda: soft_rasterize(fv, tex, **kw),
                              plain_reps)
        err = compare(label, out, ref,
                      kw.get("aggr_func_rgb") == "hard")["rgba"]
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
        iou_bins = full_raster_bins(fv, S, rend.sigma_val, rend.dist_eps)
        ms_kernel, _ = cuda_time(lambda: raster_kernel.soft_rasterize_fwd(
            fv, None, bins=iou_bins, **rkw), 20)

    def counts_of(fv_, bins_):
        return pair_counts(fv_, bins_, S, cap, rend.sigma_val, rend.dist_eps)

    iou_counts = counts_of(fv, iou_bins)
    fwd_bound, fwd_by = raster_bound(
        iou_counts, fv, torch.ones_like(fv[:, :, :1]), iou_bins, S)
    print(f"test_iou render: kernel alone {ms_kernel:.3f} ms; bound "
          f"{fwd_bound:.3f} ms ({fwd_by}; slots, pairs in bbox, past the "
          f"threshold, in depth: {iou_counts}) [{smi}]")

    def fullest_tiles(fv_):
        """Per image, the faces binned to its fullest tile."""
        full = full_raster_bins(fv_, S, rend.sigma_val, rend.dist_eps)
        return torch.diff(full[1], dim=1).amax(dim=1)

    def reached_pairs(fv_):
        """Per image, the (face, tile) pairs the faces' margin-expanded
        bboxes reach, from each face's tile rectangle."""
        _, margin = threshold_of(rend.sigma_val, rend.dist_eps)
        tx0, tx1, ty0, ty1, off = face_tile_rect(
            fv_[..., 0], fv_[..., 1], S, raster_kernel.TILE_SIZE, margin)
        return torch.where(off, 0, (tx1 - tx0 + 1) * (ty1 - ty0 + 1)).sum(1)

    def check_bins(label, fv_):
        """The binning kernels on one recorded render's faces against
        their plain twin (astarts equal, al_fids equal up to each image's
        end), and each kernel's device time (a trace of BINS_REPS
        binnings) beside its byte bound."""
        args = (S, rend.sigma_val, rend.dist_eps)
        with torch.no_grad():
            got = full_raster_bins(fv_, *args)
            want = _full_bins_plain(fv_, *args)
            assert torch.equal(got[1], want[1]), label
            pos = torch.arange(got[0].shape[1], device=dev)
            live = pos < got[1][:, -1:]
            assert torch.equal(torch.where(live, got[0], F),
                               torch.where(live, want[0], F)), label
            events, _ = trace_events(lambda: full_raster_bins(fv_, *args),
                                     BINS_REPS)
        bounds = bins_bound(got, F)
        ms = {k: sum(float(e["dur"]) for e in events
                     if e.get("cat") == "kernel" and k in e.get("name", ""))
              / BINS_REPS / 1e3 for k in bounds}
        print(f"{label} binning kernels vs plain twin, {fv_.shape[0]} "
              f"images: equal ({int(live.sum())} entries with padding); "
              + ", ".join(f"{k} {ms[k]:.4f} ms (bound {bounds[k][0]:.5f} "
                          f"ms, {bounds[k][1]}, {100 * bounds[k][0] / ms[k]:.1f}"
                          "% of it)" for k in bounds) + f" [{smi}]")
        assert all(ms.values()), ms
        return dict(images=fv_.shape[0], entries=int(live.sum()),
                    ms=ms, bound_ms={k: b[0] for k, b in bounds.items()})

    def fwd_kernel(r):
        """The forward instance a recorded render launches."""
        kw = r["kw"]
        return (f"raster_fwd_kernel<{int(kw['aggr_func_rgb'] == 'hard')},"
                f"{int(kw['mask_only'])},{int(kw['need_p2f'])}>")

    def bwd_kernel(r):
        """The backward instance: <texel lanes, z lanes>."""
        return "raster_bwd_kernel<{:d},{:d}>".format(*lanes(r["bwd"]))

    def slice_of(r, sel):
        """Images sel of a recorded render, on its own bins (the main
        path's: every face a tile reaches)."""
        fv_, tex_ = r["fv"][sel].contiguous(), r["tex"][sel].contiguous()
        return dict(r, fv=fv_, tex=tex_,
                    bins=tuple(b[sel].contiguous() for b in r["bins"]))

    def check_slice(name, r, seed, shared_forward=False):
        """The backward kernel on a recorded render's slice against the
        plain version per lane group; then the kernel's time, the plain
        backward's and the bound. By default both sides run their own
        forward, the kernel's through the autograd Function. With
        shared_forward the plain backward takes the kernel forward's rgba
        and aggr (each forward is held against its plain version on its
        own): where the texels are one colour (the untextured GAN view's
        T2=1 ones) every fragment's colour is the pixel's, so the depth
        lanes' colour difference (colour - rgb) is the forward's rounding
        times 1/gamma, on each side's own forward noise of ~1e-4 against
        vertex x, y gradients of ~5e2, which the per-group limits cannot
        hold; on shared forward outputs both sides compute the same
        difference, and a depth group that is exactly zero on the plain
        side must be exactly zero in the kernel."""
        opts, kw = r["bwd"], r["kw"]
        n = kw["image_size"]
        g = torch.randn(r["fv"].shape[:1] + (n, n, 4), device=dev,
                        generator=torch.Generator(dev).manual_seed(seed))
        plain_kw = {k: kw[k] for k in ("image_size", "background_color",
                                       "sigma_val", "dist_eps", "gamma_val")}
        bwd_kw = {k: v for k, v in plain_kw.items()
                  if k != "background_color"}
        if shared_forward:
            o = render_fwd(r)
            ms_k, got = cuda_time(lambda: render_bwd(r, o, g), 20)
            with torch.no_grad():
                ms_p, want = cuda_time(lambda: soft_rasterize_bwd(
                    r["fv"], r["tex"], o.rgba, o.aggr, g, **opts, **bwd_kw),
                    1, warmup=0)
            check_opts = opts
            if lanes(opts)[1] and want[0][..., 2].abs().max().item() == 0:
                z = got[0][..., 2].abs().max().item()
                print(f"{name}: vertex z exactly zero in the plain version "
                      f"on the kernel forward's outputs; the kernel's max "
                      f"|z| {z:.3e} (must be 0)", flush=True)
                assert z == 0, name
                # grad_check then holds the group to zero on both sides
                check_opts = dict(opts, rgb_geom_detach=True)
            e, rel = grad_check(name, got, want, check_opts)
        else:
            kf, kt = kernel_grads(raster_kernel, r["fv"], r["tex"], g,
                                  bins=r["bins"], **kw)
            pf, pt = plain_grads(r["fv"], r["tex"], g, plain_kw, opts)
            e, rel = grad_check(name, (kf, kt), (pf, pt), opts)
            del kf, kt, pf, pt
            o = render_fwd(r)
            ms_k, _ = cuda_time(lambda: render_bwd(r, o, g), 20)
            with torch.no_grad():
                ref = soft_rasterize(r["fv"], r["tex"],
                                     mask_only=opts["mask_only"], **plain_kw)
                ms_p, _ = cuda_time(lambda: soft_rasterize_bwd(
                    r["fv"], r["tex"], ref.rgba, ref.aggr, g, **opts,
                    **bwd_kw), 1)
        _, _, sb = render_bounds(r)
        print(f"{name.split(':')[0]}: backward kernel {ms_k:.3f} ms, plain "
              f"backward {ms_p:.1f} ms, bound {sb[0]:.3f} ms ({sb[1]}) "
              f"[{smi}]", flush=True)
        return dict(ms=ms_k, plain_ms=ms_p, bound=sb, max_abs=e, max_rel=rel)

    def check_fwd_slice(label, r, sel):
        """The forward kernel on images sel of a recorded render, on its
        own bins (which drop nothing), against the plain version (its
        default face_chunk: no p2f is read here) at compare's limits; then
        the kernel's time and the plain version's. Returns the
        readings."""
        sl = slice_of(r, sel)
        kw = sl["kw"]
        ms_k, out = cuda_time(lambda: render_fwd(sl), 10)
        plain_kw = {k: kw[k] for k in (
            "image_size", "background_color", "sigma_val", "dist_eps",
            "gamma_val", "aggr_func_rgb", "mask_only")}
        with torch.no_grad():
            ms_p, ref = cuda_time(lambda: soft_rasterize(
                sl["fv"], sl["tex"], **plain_kw), 1, warmup=0)
        got = compare(
            f"{label} forward slice: {len(sel)} images {sel.tolist()} on "
            f"the main path's bins ({fwd_kernel(sl)})", out, ref,
            kw["aggr_func_rgb"] == "hard")
        print(f"{label} forward slice: kernel {ms_k:.3f} ms, plain "
              f"{ms_p:.1f} ms [{smi}]", flush=True)
        return dict(got, images=sel.tolist(), ms=ms_k, plain_ms=ms_p)

    phase("6. backward kernel vs plain version and the golden backward")
    bwd_err, bwd_rel = 0.0, 0.0
    modes = (("default", {}), ("rgb_geom_detach", {"rgb_geom_detach": True}),
             ("tex_grads=False", {"tex_grads": False}),
             ("mask_only", {"mask_only": True}))
    for i, (label, opts) in enumerate(modes):
        fv_s, tex_s = sphere_scenes(rend, template, SCENE_B, 36, 10 + i, dev)
        most = int(fullest_tiles(fv_s).max())
        g = torch.randn((SCENE_B, S, S, 4), device=dev,
                        generator=torch.Generator(dev).manual_seed(20 + i))
        kf, kt = kernel_grads(raster_kernel, fv_s, tex_s, g, **opts, **rkw)
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
    from umr_tpu_torch.training.trainer import prepare_batch

    tcfg = Config(batch_size=TRAIN_BATCH, image_size=IMAGE_SIZE,
                  subdivide=SUBDIVIDE, tex_size=6, num_hypo_cams=8,
                  num_iter=TRAIN_STEPS, print_freq=1,
                  checkpoint_dir=tempfile.mkdtemp()).sync_image_size()
    seg, pvi = synthetic_semantic(template)       # bench.py's
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
    state_box = [state]

    def one_step():
        state_box[0], _ = trainer.step_fn(state_box[0], prepare_batch(
            tloader[0]))

    # the renders of one step (training/steps.py) as the kernels' route
    # receives them: the fold, the hard pass, the merged part + GAN pass
    before = tracing.totals()
    with step_renders(("fold", "hard", "merged")) as s2r:
        raster_bins.LAUNCHES = 0
        one_step()
        s2_binnings = raster_bins.LAUNCHES
    torch.cuda.synchronize()
    binned = tracing.delta(before)["counters"]
    print(f"s2 step's binnings (forward and backward launches, and the "
          f"recorder's): {s2_binnings} binning launches, "
          f"{binned.get('raster.bins_entries', 0)} (face, tile) entries, "
          f"{binned.get('raster.bins_dropped', 0)} dropped")
    assert s2_binnings == 5, s2_binnings
    assert binned.get("raster.bins_dropped", 0) == 0, binned
    bins_rec = {"fold": check_bins("s2 fold render", s2r["fold"]["fv"])}
    shapes = {}
    for label in ("fold", "merged"):
        r = s2r[label]
        fv_t = r["fv"]
        most = int(fullest_tiles(fv_t).max())
        n_img = fv_t.shape[0]
        held = r["bins"][1][:, -1].sum().item()
        assert held >= reached_pairs(fv_t).sum().item()
        print(f"{label} render: {n_img} images, fullest tile {most} faces, "
              f"{held} entries with padding in the bins")
        with torch.no_grad():
            ms_b, _ = cuda_time(lambda: full_raster_bins(
                fv_t, S, rend.sigma_val, rend.dist_eps), 10)
        ms_f, o = cuda_time(lambda: render_fwd(r), 10)
        g = torch.randn(o.rgba.shape, device=dev,
                        generator=torch.Generator(dev).manual_seed(5))
        ms_g, _ = cuda_time(lambda: render_bwd(r, o, g), 10)
        del o, g
        counts, fb, bb = render_bounds(r)
        shapes[label] = dict(fwd_ms=ms_f, bins_ms=ms_b, bwd_ms=ms_g,
                             fwd_bound=fb, bwd_bound=bb, entries=held,
                             counts=counts, bwd_kernel=bwd_kernel(r))
        print(f"{label} render, {n_img} images at {S}^2, T2=36 (fullest "
              f"tile {most}; slots, pairs in bbox, past the threshold, in "
              f"depth: {counts}): binning {ms_b:.3f} ms; forward kernel "
              f"{ms_f:.3f} ms (bound {fb[0]:.3f} ms, {fb[1]}; "
              f"{regs(fwd_kernel(r))}); backward kernel "
              f"{ms_g:.3f} ms (bound {bb[0]:.3f} ms, {bb[1]}, "
              f"{100 * bb[0] / ms_g:.1f}% of it; {regs(bwd_kernel(r))}) "
              f"[{smi}]")

    # pass 2: the hard body on the main view's bins (forward only)
    r = s2r["hard"]
    ms_h, _ = cuda_time(lambda: render_fwd(r), 10)
    hard_counts, hb, _ = render_bounds(r)
    shapes["hard"] = dict(fwd_ms=ms_h, fwd_bound=hb, counts=hard_counts)
    print(f"hard render (pass 2), {r['fv'].shape[0]} images (slots, pairs in "
          f"bbox, past the threshold, in depth: {hard_counts}): forward "
          f"kernel {ms_h:.3f} ms (bound {hb[0]:.3f} ms, {hb[1]}; "
          f"{regs(fwd_kernel(r))}) [{smi}]")

    # every forward instance the step launches against the plain version,
    # on FOLD_SLICE images of each pass spread over the pass, on bins that
    # drop nothing (the plain version renders every face)
    fwd_slices = {}
    for label in ("fold", "hard", "merged"):
        n_img = s2r[label]["fv"].shape[0]
        sel = torch.linspace(0, n_img - 1, FOLD_SLICE,
                             device=dev).round().long()
        fwd_slices["s2 " + label] = check_fwd_slice(f"s2 {label}",
                                                    s2r[label], sel)
        max_err = max(max_err, fwd_slices["s2 " + label]["rgba"])

    # the plain backward is dense over all pairs: minutes at a whole pass,
    # so kernel and plain meet on FOLD_SLICE images of each pass, spread
    # over the pass (the merged pass: its part groups and its unseen
    # view), the kernel on the pass's own bins
    slices = {}
    for label, seed in (("fold", 6), ("merged", 7)):
        r = s2r[label]
        n_img = r["fv"].shape[0]
        sel = torch.linspace(0, n_img - 1, FOLD_SLICE,
                             device=dev).round().long()
        slices[label] = check_slice(
            f"{label} slice: {FOLD_SLICE} images on the pass's bins "
            f"(predicted meshes, images {sel.tolist()})",
            slice_of(r, sel), seed)
        bwd_err = max(bwd_err, slices[label]["max_abs"])
        bwd_rel = max(bwd_rel, slices[label]["max_rel"])

    # the step's split, from a trace of the step itself (after the timed
    # steps: the profiler leaves host overhead on later launches)
    s2_trace = trace_split(one_step, "s2.", step_ms, smi, "step")
    split, raster_split = s2_trace["split"], s2_trace["raster"]
    busy_ms, traced_ms = s2_trace["busy_ms"], s2_trace["traced_ms"]
    copy_ms, idle = s2_trace["copy_ms"], s2_trace["idle"]
    del trainer, state, state_box, s2r, r
    torch.cuda.empty_cache()

    phase("9. p2f: the forward kernel's p2f instance vs the plain version "
          "(face_chunk=1, the kernel's rule) and the golden oracle")
    # the plain version one face at a time over the whole image
    pkw = dict(rkw, face_chunk=1, pixel_rows_per_block=S, need_p2f=True)
    p2f_err = 0.0
    for seed in (1, 3):      # phase 3's scenes
        fv_s, tex_s = sphere_scenes(rend, template, SCENE_B, 36, seed, dev)
        most = int(fullest_tiles(fv_s).max())
        with torch.no_grad():
            raster_kernel.P2F_LAUNCHES = 0
            out = raster_kernel.soft_rasterize_fwd(fv_s, tex_s,
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
        "--print_freq", "1", "--checkpoint_dir", tempfile.mkdtemp(),
        "--name", "s1"])
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
    s1_dir = os.path.join(s1cfg.checkpoint_dir, s1cfg.name)
    s1_pth = os.path.join(s1_dir, "pred_net_latest.pth")
    s1_log = open(os.path.join(s1_dir, "loss_log.txt")).read()
    print(f"stage 1 wrote {sorted(os.listdir(s1_dir))}")
    assert os.path.exists(s1_pth) and "uv_flow_area: " in s1_log
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

    phase("11. the s1 step's renders (64 images, 512^2, T2=36): p2f and "
          "the backward vs plain, the kernels' times")
    # the renders of one s1 step as the kernels' route receives them: the
    # fused render (p2f, rgb_geom_detach), the hard pass on its bins, the
    # GAN's mask-only render of the unseen view on its own bins
    before = tracing.totals()
    with step_renders(("s1 fused", "s1 hard", "s1 gan")) as s1r:
        raster_bins.LAUNCHES = 0
        one_s1_step()
        s1_binnings = raster_bins.LAUNCHES
    torch.cuda.synchronize()
    binned = tracing.delta(before)["counters"]
    assert s1_binnings == 5, s1_binnings
    fused = s1r["s1 fused"]
    fv1, bins1 = fused["fv"], fused["bins"]
    # the main path's bins hold every (face, tile) pair that a face's
    # margin-expanded bbox reaches, however large the s1 model's early
    # faces are (the JAX package's caps drop a large share there), and
    # the step's binnings drop nothing
    with torch.no_grad():
        pos = torch.arange(bins1[0].shape[1], device=dev)
        kept = ((bins1[0] < F) & (pos < bins1[1][:, -1:])).sum(1)
        every = reached_pairs(fv1)
    s1_dropped = int(binned.get("raster.bins_dropped", 0))
    print(f"s1 fused render: its bins hold {int(kept.sum())} (face, tile) "
          f"entries of the {int(every.sum())} its faces reach (per image "
          f"{int(kept.min())}..{int(kept.max())}; fullest tile "
          f"{int(fullest_tiles(fv1).max())} faces); the step's binnings "
          f"(and the recorder's): {s1_binnings} binning launches, "
          f"{binned.get('raster.bins_entries', 0)} "
          f"entries, {s1_dropped} dropped", flush=True)
    assert torch.equal(kept, every), (kept.tolist(), every.tolist())
    assert s1_dropped == 0, binned
    bins_rec["s1 fused"] = check_bins("s1 fused render", fv1)
    sel = torch.linspace(0, S1_BATCH - 1, P2F_SLICE,
                         device=dev).round().long()
    sl = slice_of(fused, sel)
    p2f_slice_ms, out = cuda_time(lambda: render_fwd(sl), 20)
    with torch.no_grad():
        p2f_plain_ms, ref = cuda_time(
            lambda: soft_rasterize(sl["fv"], sl["tex"], **pkw), 1, warmup=0)
    name = (f"s1 fused slice: {P2F_SLICE} images (images {sel.tolist()}, "
            "on the main path's bins)")
    fwd_slices["s1 fused"] = dict(compare(name, out, ref, False),
                                  images=sel.tolist(), ms=p2f_slice_ms,
                                  plain_ms=p2f_plain_ms)
    max_err = max(max_err, fwd_slices["s1 fused"]["rgba"])
    p2f_err = max(p2f_err, p2f_check(name, out, ref))
    _, slice_bound, _ = render_bounds(sl)
    print(f"s1 fused slice: p2f kernel {p2f_slice_ms:.3f} ms, plain "
          f"(face_chunk=1) {p2f_plain_ms:.1f} ms, bound "
          f"{slice_bound[0]:.3f} ms ({slice_bound[1]}) [{smi}]")
    del out, ref

    # the other two s1 forward instances against the plain version, on the
    # same images
    for label in ("s1 hard", "s1 gan"):
        fwd_slices[label] = check_fwd_slice(label, s1r[label], sel)
        max_err = max(max_err, fwd_slices[label]["rgba"])

    # the backward at both s1 launches against the plain version, on the
    # same slices' bins
    for label, seed in (("s1 fused", 10), ("s1 gan", 11)):
        slices[label] = check_slice(
            f"{label} slice: {P2F_SLICE} images (images {sel.tolist()}, on "
            "the main path's bins)", slice_of(s1r[label], sel),
            seed)
        bwd_err = max(bwd_err, slices[label]["max_abs"])
        bwd_rel = max(bwd_rel, slices[label]["max_rel"])

    # the p2f instance against the p2f-free one on the same 64 images and
    # bins, in turns (without, with, with, without)
    turns = [cuda_time(lambda: render_fwd(fused, need_p2f=need), 10)[0]
             for need in (False, True, True, False)]
    ms_nop2f, ms_p2f = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
    s1_counts, b_p2f, _ = render_bounds(fused)
    _, b_nop2f, _ = render_bounds(dict(fused, kw=dict(fused["kw"],
                                                      need_p2f=False)))
    print(f"s1 fused render, {S1_BATCH} images (slots, pairs in bbox, past "
          f"the threshold, in depth: {s1_counts}): forward kernel with p2f "
          f"{ms_p2f:.3f} ms (bound {b_p2f[0]:.3f} ms, {b_p2f[1]}; "
          f"{regs(fwd_kernel(fused))}), without "
          f"{ms_nop2f:.3f} ms (bound {b_nop2f[0]:.3f} ms); turns "
          + ", ".join(f"{t:.3f}" for t in turns) + f" ms [{smi}]")

    # each of the s1 step's kernel shapes: the fused render's forward and
    # backward, pass 2's hard body, pass 3's mask-only GAN render
    s1_shapes = {}
    for label, r in s1r.items():
        counts, fb, bb = render_bounds(r)
        ms_f, o = cuda_time(lambda: render_fwd(r), 10)
        rec = dict(fwd_ms=ms_f, fwd_bound=fb, counts=counts)
        msg = (f"{label}, {S1_BATCH} images (slots, pairs in bbox, past "
               f"the threshold, in depth: {counts}): forward kernel "
               f"{ms_f:.3f} ms (bound {fb[0]:.3f} ms, {fb[1]}; "
               f"{regs(fwd_kernel(r))})")
        if r["bwd"] is not None:
            g = torch.randn(o.rgba.shape, device=dev,
                            generator=torch.Generator(dev).manual_seed(9))
            ms_g, _ = cuda_time(lambda: render_bwd(r, o, g), 10)
            rec.update(bwd_ms=ms_g, bwd_bound=bb, bwd_kernel=bwd_kernel(r))
            msg += (f"; backward kernel {ms_g:.3f} ms (bound {bb[0]:.3f} "
                    f"ms, {bb[1]}, {100 * bb[0] / ms_g:.1f}% of it; "
                    f"{regs(bwd_kernel(r))})")
            del g
        del o
        s1_shapes[label] = rec
        print(msg + f" [{smi}]", flush=True)
    del fused, fv1, bins1, s1r, sl, r, s1_trainer, s1_box, s1_state
    torch.cuda.empty_cache()

    phase("12. one s2 step with cycle_soft_p2f (batch 16, full s2 width)")
    from umr_tpu_torch.training.steps import build_s2_step

    part_loss = PartMatchingLoss.build(
        seg, template.uv_sampler, template.num_sym_faces,
        SoftRenderer(image_size=IMAGE_SIZE).ambient_light_only(), tex_size=6,
        device=dev)
    _, _, _, init_c, step_c = build_s2_step(
        tcfg.replace(cycle_soft_p2f=True, checkpoint_dir=tempfile.mkdtemp()),
        template, part_loss, pvi, dev)
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

    phase("13. the stage handoff through files: avg_uv.run on stage 1's "
          "checkpoint, train_s2.run from its template on disk (batch 16, "
          "K=8) and resumed, test_iou.run and test_kp.run on stage 2's")
    handoff_rec = handoff(dev, smi, template, s1_pth, s1loader, tcfg,
                          tloader, cfg, loader)

    phase("14. the synthetic category on the card: generate_dataset (64 "
          "samples, batch 16, 256^2 with 512^2 AA renders), the device "
          "loader, train_s2.run, avg_uv, test_iou and test_kp on it")
    category_rec = category(dev, smi, template, tcfg, s1_pth)
    gen_r = category_rec["renders"]

    phase("15. the CUB path from files: a CUB-layout fixture and the "
          "committed JPEGs (nvJPEG), the loader, then train_s1 (batch 64), "
          "avg_uv, train_s2 (batch 16), test_iou and test_kp with no loader "
          "passed, with their visuals")
    cub_rec = cub_path(dev, smi, template)

    phase("16. the training flag variants: s2 (batch 16) bf16, without "
          "texture, without the GAN, az_ele_quat; s1 (batch 64) bf16, "
          "without the GAN, without texture; the entry points under --bf16; "
          "test_iou on a one-camera, untextured model; the new kernel shapes")
    variants_rec = flag_variants(
        dev, smi, template, tcfg, tloader, seg, pvi, part_loss, s1cfg,
        s1loader, cfg, loader, dict(check_fwd_slice=check_fwd_slice,
                                    check_slice=check_slice,
                                    slice_of=slice_of))
    var_slices = variants_rec["slices"].values()
    max_err = max(max_err, *(v["fwd"]["rgba"] for v in var_slices))
    bwd_err = max(bwd_err, *(v["bwd"]["max_abs"] for v in var_slices))
    bwd_rel = max(bwd_rel, *(v["bwd"]["max_rel"] for v in var_slices))

    phase("17. data parallelism: train_s2.run in a one-rank NCCL group "
          "(parallel.launch); "
          "one s2 step (batch 16) and one s1 step and template update "
          "(batch 64) on two ranks sharing the card (gloo), against one "
          "process")
    dp_rec = data_parallel(smi, tcfg, tloader, seg, pvi, step_ms)

    phase("18. tensor parallelism: one s2 Adam step (batch 16) on two ranks "
          "sharing the card as a (1, 2) mesh against one process; "
          "dryrun_multichip 4 on the card; check_fused_grads through the "
          "kernels; soak_train s2 (100 steps, batch 16) and s1 (150 steps, "
          "batch 64)")
    tp_rec = tensor_parallel(smi, seg, pvi)
    tp_launch = {"tensor_parallel_launches": tp_rec["18a"]["launches"],
                 "dryrun_launches": tp_rec["18b"]["launches"],
                 "fused_check_launches": tp_rec["18c"]["launches"],
                 "soak_launches": {k: tp_rec[f"18d_{k}"]["launches"]
                                   for k in ("s2", "s1")}}

    phase("19. the off-path tools: profile_step at full width (batch 16, "
          "K=8, AA, F=1280, T2=36), pretrain_trunk and pretrain_lpips on the "
          "category's images, voxelize at R=32 on the card")
    off_rec = off_path(dev, smi, template)
    prof_launch = off_rec["19a"]["launches"]

    record = {"kernels": [{
        "name": "raster_fwd", "route": "cuda", "source": KERNEL_SRC,
        "replaces": TPU_KERNEL, "launches": train_fwd,
        "max_abs_err": max(max_err, *(v["rgba"] for v in gen_r.values())),
        "ms": ms, "plain_ms": plain_ms,
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
        "s1_entries_dropped": s1_dropped,
        "p2f_slice_ms": p2f_slice_ms, "p2f_slice_plain_ms": p2f_plain_ms,
        "p2f_slice_bound_ms": slice_bound[0],
        "s1_step_ms": s1_ms, "s1_images_per_s": s1_imgs,
        "s1_peak_gb": s1_peak, "s1_split_ms": s1_trace["split"],
        "s1_raster_ms": s1_trace["raster"], "s1_busy_ms": s1_trace["busy_ms"],
        "s1_traced_ms": s1_trace["traced_ms"],
        "s1_idle_share": s1_trace["idle"], "s1_copy_ms": s1_trace["copy_ms"],
        "cycle_soft_p2f_launches": list(cyc_launches),
        "handoff": handoff_rec,
        "generator_launches": category_rec["gen_launches"],
        "generator_ms": {k: v["ms"] for k, v in gen_r.items()},
        "generator_bound_ms": {k: v["bound_ms"] for k, v in gen_r.items()},
        "generator_slice_ms": {k: v["slice_ms"] for k, v in gen_r.items()},
        "generator_slice_plain_ms": {k: v["slice_plain_ms"]
                                     for k, v in gen_r.items()},
        "category": category_rec,
        "cub": cub_rec,
        "s2_hard_ms": shapes["hard"]["fwd_ms"],
        "s2_hard_bound_ms": shapes["hard"]["fwd_bound"][0],
        "s1_hard_ms": s1_shapes["s1 hard"]["fwd_ms"],
        "s1_hard_bound_ms": s1_shapes["s1 hard"]["fwd_bound"][0],
        "s1_gan_ms": s1_shapes["s1 gan"]["fwd_ms"],
        "s1_gan_bound_ms": s1_shapes["s1 gan"]["fwd_bound"][0],
        "step_slices": fwd_slices,
        "variants": variants_rec,
        "data_parallel": dp_rec,
        "tensor_parallel": tp_rec,
        **tp_launch,
        "profile_step_launches": prof_launch[0],
        "off_path": off_rec,
        "ptxas": {k: v for k, v in usage.items()
                  if k.startswith("raster_fwd")},
    }, {
        "name": "raster_bins", "route": "cuda", "source": BINS_SRC,
        "replaces": None, "launches": {"s2 step": s2_binnings,
                                       "s1 step": s1_binnings},
        "max_abs_err": 0, "plain": "ops/raster_bins.py::_full_bins_plain",
        "ms": {k: sum(v["ms"].values()) for k, v in bins_rec.items()},
        "bound_ms": {k: sum(v["bound_ms"].values())
                     for k, v in bins_rec.items()},
        "bound_by": "bytes", "library_ms": None, "renders": bins_rec,
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
        "fold_entries": shapes["fold"]["entries"],
        "fold_bound_ms": shapes["fold"]["bwd_bound"][0],
        "fold_pair_counts": shapes["fold"]["counts"],
        "merged_ms": shapes["merged"]["bwd_ms"],
        "merged_bound_ms": shapes["merged"]["bwd_bound"][0],
        "merged_pair_counts": shapes["merged"]["counts"],
        "train_step_ms": step_ms, "train_images_per_s": imgs_s,
        "train_split_ms": split, "train_raster_ms": raster_split,
        "train_busy_ms": busy_ms, "train_traced_ms": traced_ms,
        "train_idle_share": idle, "train_copy_ms": copy_ms,
        "s1_fused_ms": s1_shapes["s1 fused"]["bwd_ms"],
        "s1_fused_bound_ms": s1_shapes["s1 fused"]["bwd_bound"][0],
        "s1_gan_ms": s1_shapes["s1 gan"]["bwd_ms"],
        "s1_gan_bound_ms": s1_shapes["s1 gan"]["bwd_bound"][0],
        "s1_fused_slice_ms": slices["s1 fused"]["ms"],
        "s1_fused_slice_plain_ms": slices["s1 fused"]["plain_ms"],
        "s1_fused_slice_max_rel_err": slices["s1 fused"]["max_rel"],
        "s1_gan_slice_ms": slices["s1 gan"]["ms"],
        "s1_gan_slice_plain_ms": slices["s1 gan"]["plain_ms"],
        "s1_gan_slice_max_rel_err": slices["s1 gan"]["max_rel"],
        "variants_launches": {
            f"{st} {k}": v["launches"][2]
            for st in ("s2", "s1") for k, v in variants_rec[st].items()},
        "variant_slices": {k: v["bwd"] for k, v in
                           variants_rec["slices"].items()},
        **tp_launch,
        "profile_step_launches": prof_launch[2],
        "ptxas": {k: v for k, v in usage.items()
                  if k.startswith("raster_bwd")},
    }]}
    print(f"\n{smi}")
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--cards"]:
        if not torch.cuda.is_available():
            raise SystemExit("chip_smoke: no CUDA device visible")
        multi_card(int(sys.argv[2]), tuple(sys.argv[4:5]) or ("17", "18"))
    else:
        main()
