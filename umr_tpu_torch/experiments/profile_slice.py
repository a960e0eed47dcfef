"""Where the time of a test_iou batch goes on the GPU: MeshNet-s2 forward
against the softmax silhouette render, the render's binning and kernel,
the device's busy share from a torch.profiler trace, and the kernel's own
device time at the demo's hard, textured render. Its trace helpers
(trace_events, range_split, busy_us) also split the s2 training step by
its profiler ranges (chip_smoke.py).

  python -m umr_tpu_torch.experiments.profile_slice [--out summary.json]

Random weights from a seed (the trunk from weights/resnet18_*.npz), full
s2 width at Config's defaults, TF32 off unless --tf32. Prints one JSON
summary (also written to --out).
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import numpy as np
import torch

from ..config import Config
from ..data import synthetic_batch
from ..mesh import build_template
from ..models import MeshNet, init_weights, symmetrize
from ..models.weights import WEIGHTS_DIR, load_resnet18_npz
from ..ops import raster_kernel
from ..ops.raster_bins import full_raster_bins
from ..renderer import SoftRenderer, apply_lighting, surface_normals
from . import demo, test_iou


def random_model(cfg, template, seed, device):
    """MeshNet-s2 at cfg's widths, initialised from `seed`, with the
    committed ResNet-18 trunk, in eval mode on `device`."""
    model = init_weights(MeshNet(template, input_size=cfg.image_size,
                                 nz_feat=cfg.nz_feat, z_dim=cfg.z_dim,
                                 num_hypo_cams=cfg.num_hypo_cams),
                         torch.Generator().manual_seed(seed))
    res = model.load_state_dict(load_resnet18_npz(
        os.path.join(WEIGHTS_DIR, "resnet18_params.npz"),
        os.path.join(WEIGHTS_DIR, "resnet18_stats.npz")), strict=False)
    assert not res.unexpected_keys, res.unexpected_keys
    return model.to(device).eval()


def event_ms(fn, steps):
    """Per-call milliseconds of fn() (CUDA events), one warm-up call."""
    fn()
    out = []
    for _ in range(steps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end))
    return np.array(out)


def stats(ms):
    return {"median": float(np.median(ms)), "q25": float(np.quantile(ms, .25)),
            "q75": float(np.quantile(ms, .75)), "n": int(ms.size)}


DEVICE_CATS = ("kernel", "gpu_memset", "gpu_memcpy")


def trace_events(fn, steps):
    """Runs fn() `steps` times under torch.profiler (host and device), after
    one untraced call; returns (the Chrome trace's events, wall
    microseconds of the traced calls by CUDA events)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(steps):
            fn()
        end.record()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return events, start.elapsed_time(end) * 1e3


def device_ops(events, cats=DEVICE_CATS):
    """[(name, ts_us, dur_us)] of the trace's device events of `cats`."""
    return [(e["name"], float(e["ts"]), float(e["dur"])) for e in events
            if e.get("cat") in cats and "dur" in e]


def trace_kernels(fn, steps):
    """Runs fn() `steps` times under torch.profiler; returns (device kernel
    events [(name, ts_us, dur_us)], wall microseconds)."""
    events, wall_us = trace_events(fn, steps)
    return device_ops(events, ("kernel",)), wall_us


def launch_times(events):
    """{correlation id: host microsecond} of the trace's CUDA API calls
    (the launches of its device events)."""
    launch = {}
    for e in events:
        if e.get("cat", "").startswith("cuda_"):
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launch[corr] = float(e["ts"])
    return launch


def range_split(events, prefix, steps):
    """Device milliseconds per step by host range: each device event
    (kernel, memset, memcpy) counts to the innermost profiler range named
    prefix* that was open on the host when its launch was issued (the
    runtime call of the same correlation id, on any thread), else to
    "outside" (launched outside every such range) or "unmatched" (no
    launch call in the trace). Returns {name: ms}."""
    launch = launch_times(events)
    ranges = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                      e["name"]) for e in events
                     if e.get("cat") == "user_annotation"
                     and e["name"].startswith(prefix)),
                    key=lambda r: r[1] - r[0])   # innermost first
    out = {}
    for e in events:
        if e.get("cat") not in DEVICE_CATS or "dur" not in e:
            continue
        t = launch.get(e.get("args", {}).get("correlation"))
        name = "unmatched"
        if t is not None:
            name = next((n for lo, hi, n in ranges if lo <= t <= hi),
                        "outside")
        out[name] = out.get(name, 0.0) + float(e["dur"]) / steps / 1e3
    return out


def busy_us(kern):
    """Union of the kernels' intervals, microseconds."""
    total, reach = 0.0, -np.inf
    for _, ts, dur in sorted(kern, key=lambda k: k[1]):
        lo, hi = max(ts, reach), ts + dur
        if hi > lo:
            total += hi - lo
        reach = max(reach, hi)
    return total


def by_name(kern, steps, top=10):
    agg = {}
    for name, _, dur in kern:
        n, t = agg.get(name, (0, 0.0))
        agg[name] = (n + 1, t + dur)
    rows = sorted(agg.items(), key=lambda kv: -kv[1][1])[:top]
    return [{"kernel": name[:90], "calls_per_step": n / steps,
             "ms_per_step": t / steps / 1e3} for name, (n, t) in rows]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch_size", type=int, default=32)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--trace_steps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tf32", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_slice: no CUDA device visible")
    torch.backends.cuda.matmul.allow_tf32 = args.tf32
    torch.backends.cudnn.allow_tf32 = args.tf32
    dev = torch.device("cuda")

    cfg = Config(batch_size=args.batch_size).sync_image_size()
    template = build_template(cfg.subdivide, cfg.axis, cfg.tex_size)
    model = random_model(cfg, template, args.seed, dev)
    rend = SoftRenderer(image_size=cfg.image_size, render_type="softmax")
    faces = torch.as_tensor(template.faces, device=dev)
    batch = synthetic_batch(np.random.RandomState(args.seed), cfg.batch_size,
                            cfg.image_size)
    x = torch.as_tensor(test_iou.prepare_batch(batch)[0], device=dev)
    gen = torch.Generator(dev)

    def forward():
        gen.manual_seed(args.seed)
        with torch.no_grad():
            return model(x, generator=gen)

    out = forward()
    with torch.no_grad():
        verts = model.get_mean_shape()[None] + symmetrize(out["delta_v"],
                                                          template)
        fv = rend.project_faces(verts, faces, out["cam"]).contiguous()
    S = rend.render_size

    def step():
        gen.manual_seed(args.seed)
        return test_iou.predict_masks(model, rend, faces, x, generator=gen)

    def binning():
        return full_raster_bins(fv, S, rend.sigma_val, rend.dist_eps)

    _, astarts = binning()
    per_tile = torch.diff(astarts, dim=1).float()
    # timed before any trace: torch.profiler leaves host overhead on every
    # later launch of the process (step_ms_after_trace shows how much)
    timed = {
        "step_ms": stats(event_ms(step, args.steps)),
        "forward_ms": stats(event_ms(forward, args.steps)),
        "render_ms": stats(event_ms(lambda: rend.render(verts, faces,
                                                        out["cam"]),
                                    args.steps)),
        "binning_ms": stats(event_ms(binning, args.steps)),
    }
    kern, wall_us = trace_kernels(step, args.trace_steps)
    raster = [k for k in kern if "raster_fwd" in k[0]]

    vis = demo.vis_renderer(cfg.image_size)
    with torch.no_grad():
        verts1, cams1, tex1, _ = demo.predict_mesh(model, batch["img"][0],
                                                   generator=gen)
        fv1 = vis.project_faces(verts1, faces, cams1).contiguous()
        tex1 = apply_lighting(tex1, surface_normals(fv1),
                              vis.ambient_intensity,
                              vis.directional_intensity,
                              vis.light_direction).contiguous()
    demo_kern, _ = trace_kernels(
        lambda: raster_kernel.soft_rasterize_fwd(
            fv1, tex1, image_size=S, aggr_func_rgb="hard",
            background_color=vis.background_color),
        args.trace_steps)
    demo_raster = [d for name, _, d in demo_kern if "raster_fwd" in name]

    summary = {
        "tf32": args.tf32, "batch_size": cfg.batch_size, "render_size": S,
        **timed,
        "bin_entries": int(astarts[:, -1].sum()),
        "faces_per_tile": {"mean": float(per_tile.mean()),
                           "max": int(per_tile.max())},
        "trace": {
            "steps": args.trace_steps,
            "wall_ms_per_step": wall_us / args.trace_steps / 1e3,
            "device_busy_ms_per_step": busy_us(kern) / args.trace_steps / 1e3,
            "busy_share": busy_us(kern) / wall_us,
            "raster_kernel_ms": (sum(d for _, _, d in raster) / len(raster)
                                 / 1e3) if raster else None,
            "top_kernels": by_name(kern, args.trace_steps),
        },
        "demo_raster_kernel_ms": (sum(demo_raster) / len(demo_raster) / 1e3
                                  if demo_raster else None),
        "step_ms_after_trace": stats(event_ms(step, args.steps)),
    }
    text = json.dumps(summary, indent=1)
    print(text)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text)
    return summary


if __name__ == "__main__":
    main()
