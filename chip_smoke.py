"""Smoke run of the PyTorch port on one NVIDIA GPU (H100): builds the CUDA
rasterizer from csrc/, holds it against its plain version at the main
path's shapes, drives the inference slice (test_iou.run at full s2 width,
batch 32; demo.render_panels), checks that the slice went through the
kernel, and times kernel against plain version.

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

# the main path's shapes: s2 at 256^2 (512^2 anti-aliased renders),
# subdivide 3 (F=1280), test_iou at batch 32
DEVICE = "cuda:0"
IMAGE_SIZE = 256
SUBDIVIDE = 3
BATCH = 32
N_BATCHES = 4
SCENE_B = 4

RGBA_ATOL = 1e-3      # kernel vs plain: reductions run in another order
AGGR_RTOL = 1e-4      # softmax (sum, max)
HARD_SHARE = 0.999    # face ids and depths equal on covered pixels


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
    print(f"built {KERNEL_SRC} in {time.perf_counter() - t0:.1f} s")
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

    record = {"kernels": [{
        "name": "raster_fwd", "route": "cuda", "source": KERNEL_SRC,
        "replaces": TPU_KERNEL, "launches": launches,
        "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
        "ms_includes_binning": True, "binning_ms": ms_bins,
        "demo_ms": ms_demo, "demo_binning_ms": ms_demo_bins,
        "demo_plain_ms": plain_ms_demo,
        "test_iou_batch_ms": lat,
        "iou": iou,
    }]}
    print(f"\n{smi}")
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
