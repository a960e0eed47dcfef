"""Times the rasterizer kernels built from one or more source trees at
the training steps' shapes, in turns on one card, beside each shape's
bound; prints each build's registers and spills (ptxas), and how far
each build's forward outputs lie from the first build's.

  python -m umr_tpu_torch.experiments.raster_bench \\
      --lib parent=/path/to/parent/umr_tpu_torch/csrc \\
      --lib change=umr_tpu_torch/csrc \\
      --order parent,change,change,parent --out chiprun_out/bench.json

Each --lib NAME=DIR is a csrc/ directory (this package's, an older
commit's unpacked with `git archive`, or a scratch copy with a part cut
out), built with the package's nvcc flags; the kernels' C interface is
the same in every tree.

The shapes are the renders the training steps themselves draw on the
kernels' route (step_renders records them), from each step's first step
at its seeded initialisation (the committed ResNet-18 trunk and LPIPS) on
a synthetic batch: stage 2 at bench.py's configuration, batch 16 with 8
hypotheses (the 128-image fold with rgb_geom_detach, the 16-image hard
pass, the 48-image merged part + GAN pass with tex_grads=False), stage 1
at batch 64 (the fused render with p2f and rgb_geom_detach, the hard
pass, the mask-only GAN render), 256^2 with 512^2 anti-aliased renders,
F=1280, T2=36; and a test_iou batch's render (32 images, T2=1).
chip_smoke.py records the same renders from its trained models. CUDA
events around `--reps` launches after one warm-up; TF32 off.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import subprocess
import tempfile

import numpy as np
import torch

from ..config import Config
from ..data import synthetic_batch
from ..mesh import build_template
from ..ops import raster_kernel
from ..ops.raster_bins import compute_raster_bins
from ..renderer import SoftRenderer
from .raster_bound import block_steps, pair_counts, raster_bound

def _short(raw):
    """A mangled kernel name shortened to `raster_bwd_kernel<1,0>`
    (template bools)."""
    k = re.search(r"(raster_[a-z]+_kernel)(?:I((?:Lb[01]E)+)E)?", raw)
    return raw if k is None else k.group(1) + (
        "<" + ",".join(re.findall(r"Lb([01])E", k.group(2))) + ">"
        if k.group(2) else "")


def ptxas_usage(log):
    """{kernel: (registers, spill store bytes, spill load bytes)} from
    nvcc -Xptxas -v output; kernel names are shortened to
    `raster_bwd_kernel<1,0>` (template bools)."""
    out, name, spill = {}, None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)", line)
        if m:
            name = _short(m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name] = (int(m.group(1)),) + spill
            spill = (0, 0)
    return out


def shared_atomics(sass):
    """{kernel: {opcode: count}} of the shared-memory atomics (ATOMS.*)
    in `cuobjdump -sass` output; a shared float atomicAdd shows as
    ATOMS.CAST.SPIN, a compare-and-swap loop."""
    out, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = _short(m.group(1))
            out[name] = {}
            continue
        m = re.search(r"\b(ATOMS(?:\.[A-Z0-9]+)*)", line)
        if m and name:
            out[name][m.group(1)] = out[name].get(m.group(1), 0) + 1
    return out


def build(name, csrc, workdir):
    """(library, ptxas usage, shared atomics) of the kernels in csrc."""
    lib, log = raster_kernel.build_library(
        csrc, os.path.join(workdir, "build_" + re.sub(r"\W", "_", name)))
    cuobjdump = os.path.join(os.path.dirname(raster_kernel._nvcc()),
                             "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib._name],
                          capture_output=True, text=True, check=True).stdout
    return lib, ptxas_usage(log), shared_atomics(sass)


def synthetic_semantic(template, seed=0):
    """(semantic segmentation [128, 256], part vertex indices: head,
    belly, neck, back) of the synthetic semantic template bench.py
    builds, for train_s2.run."""
    rng = np.random.RandomState(seed)
    seg = rng.randint(0, 5, size=(128, 256)).astype(np.float32)
    idx = rng.permutation(template.num_verts)
    return seg, [idx[0:100], idx[100:250], idx[250:330], idx[330:480]]


@contextlib.contextmanager
def step_renders(labels):
    """Records the renders drawn on the kernels' route while the block
    runs (one training step): yields a dict that, when the block ends,
    maps labels[i] to the i-th render as dict(fv, tex, bins, kw = its
    soft_rasterize_fwd keywords, bwd = its backward's options, None for
    the hard body). The block must draw exactly len(labels) renders.
    Where the plain versions took no bins (CPU tensors), bins are the
    ones the card's route would compute."""
    got, out = [], {}
    function = raster_kernel._Raster

    class Recorder:
        @staticmethod
        def apply(fv, tex, al_fids, astarts, kw):
            bins = (al_fids, astarts)
            if al_fids is None:
                bins = compute_raster_bins(
                    fv.detach(), kw["S"], raster_kernel.TILE_SIZE,
                    kw["sigma_val"], kw["dist_eps"], kw["mf_cap"],
                    raster_kernel.MAX_COVER)
            got.append((fv.detach(), tex.detach(), bins, dict(kw)))
            return function.apply(fv, tex, al_fids, astarts, kw)

    raster_kernel._Raster = Recorder
    try:
        yield out
    finally:
        raster_kernel._Raster = function
    assert len(got) == len(labels), (len(got), labels)
    for label, (fv, tex, bins, kw) in zip(labels, got):
        opts = dict(mask_only=kw["mask_only"],
                    rgb_geom_detach=kw["rgb_geom_detach"],
                    tex_grads=kw["tex_grads"])
        out[label] = dict(fv=fv, tex=tex, bins=bins, kw=dict(
            image_size=kw["S"], background_color=kw["bg"],
            sigma_val=kw["sigma_val"], dist_eps=kw["dist_eps"],
            gamma_val=kw["gamma_val"], mf_cap=kw["mf_cap"],
            aggr_func_rgb="hard" if kw["hard"] else "softmax",
            need_p2f=kw["need_p2f"], **opts),
            bwd=None if kw["hard"] else opts)


def render_fwd(r, **over):
    """The forward kernel on a recorded render (keywords in `over`
    replace the render's), without autograd."""
    with torch.no_grad():
        return raster_kernel.soft_rasterize_fwd(
            r["fv"], r["tex"], **dict(r["kw"], bins=r["bins"], **over))


def render_bwd(r, out, g):
    """The backward kernel on a recorded render: out is its forward's
    RasterOut, g the cotangent of its rgba."""
    kw = r["kw"]
    return raster_kernel.raster_bwd(
        r["fv"], r["tex"], r["bins"], out.rgba, out.aggr, g,
        kw["image_size"], kw["sigma_val"], kw["dist_eps"], kw["gamma_val"],
        kw["mf_cap"], **r["bwd"])


def render_bounds(r):
    """(pair_counts, forward (bound ms, bound_by), backward's or None) of
    a recorded render on its own bins."""
    kw = r["kw"]
    S = kw["image_size"]
    counts = pair_counts(r["fv"], r["bins"], S, kw["mf_cap"],
                         kw["sigma_val"], kw["dist_eps"])
    fwd = raster_bound(counts, r["fv"], r["tex"], r["bins"], S,
                       p2f=kw["need_p2f"], hard=kw["aggr_func_rgb"] == "hard")
    bwd = (None if r["bwd"] is None else
           raster_bound(counts, r["fv"], r["tex"], r["bins"], S, r["bwd"]))
    return counts, fwd, bwd


S2_RENDERS = ("s2_fold", "s2_hard", "s2_merged")
S1_RENDERS = ("s1_fused", "s1_hard", "s1_gan")


def step_shapes(device, seed=0, image_size=256, s2_batch=16, s1_batch=64,
                iou_batch=32):
    """{label: recorded render} of the first step of train_s2.run and of
    train_s1.run at their seeded initialisation, on synthetic batches;
    `s1_fused_no_p2f` is the fused render without p2f (forward only);
    `test_iou` the render of a test_iou batch (MeshNet-s2 at its seeded
    initialisation, eval mode; forward only)."""
    from . import test_iou, train_s1, train_s2
    from .profile_slice import random_model

    rng = np.random.RandomState(seed)
    template = build_template(3, 1, 6)
    cfg = Config(batch_size=s2_batch, image_size=image_size, subdivide=3,
                 tex_size=6, num_hypo_cams=8, num_iter=1, seed=seed,
                 print_scalars=False).sync_image_size()
    with step_renders(S2_RENDERS) as s2:
        train_s2.run(cfg, [synthetic_batch(rng, s2_batch, image_size)],
                     device=device,
                     semantic=(None,) + synthetic_semantic(template))
    cfg = train_s1.config([
        "--batch_size", str(s1_batch), "--image_size", str(image_size),
        "--subdivide", "3", "--tex_size", "6", "--num_iter", "1",
        "--seed", str(seed)]).replace(print_scalars=False)
    with step_renders(S1_RENDERS) as s1:
        train_s1.run(cfg, [synthetic_batch(rng, s1_batch, image_size)],
                     device=device)
    # the fused render by the p2f-free instance, for the p2f premium
    fused = s1["s1_fused"]
    s1["s1_fused_no_p2f"] = dict(fused, bwd=None,
                                 kw=dict(fused["kw"], need_p2f=False))
    icfg = Config(batch_size=iou_batch, image_size=image_size,
                  subdivide=3).sync_image_size()
    model = random_model(icfg, template, seed, device)
    batch = synthetic_batch(np.random.RandomState(seed), iou_batch,
                            image_size)
    x = torch.as_tensor(test_iou.prepare_batch(batch)[0], device=device)
    with step_renders(("test_iou",)) as iou, torch.no_grad():
        test_iou.predict_masks(
            model, SoftRenderer(image_size=image_size, render_type="softmax"),
            torch.as_tensor(template.faces, device=device), x,
            generator=torch.Generator(device).manual_seed(seed))
    iou["test_iou"]["bwd"] = None    # inference: forward only
    return {**s2, **s1, **iou}


def compare_outputs(ref, out, hard):
    """How far the forward output `out` of one render (a RasterOut) lies
    from `ref`, the same render by another build: max |diff| of rgba, of
    aggr and of p2f; for the hard body, the share of the pixels `ref`
    covers whose face id and depth are equal (else None)."""
    diff = {k: (getattr(out, k) - getattr(ref, k)).abs().max().item()
            for k in ("rgba", "aggr", "p2f")}
    diff["hard_equal"] = None
    if hard:
        cov = ref.aggr[:, 1] >= 0
        same = (out.aggr == ref.aggr).all(1)
        diff["hard_equal"] = (same[cov].float().mean().item()
                              if cov.any() else 1.0)
    return diff


def time_ms(fn, reps):
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--lib", action="append", required=True,
                    help="NAME=CSRC_DIR")
    ap.add_argument("--order", default=None,
                    help="comma-separated names, in the order timed "
                         "(default: each --lib once)")
    ap.add_argument("--shapes", default=None,
                    help="comma-separated shape labels (default: all)")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("raster_bench: no CUDA device visible")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)

    libs, usage, atomics = {}, {}, {}
    with tempfile.TemporaryDirectory() as work:
        for spec in args.lib:
            name, csrc = spec.split("=", 1)
            libs[name], usage[name], atomics[name] = build(name, csrc, work)
            print(f"{name}: built from {csrc}; ptxas " + ", ".join(
                f"{k} {r} registers, spill {s}/{l} bytes"
                for k, (r, s, l) in sorted(usage[name].items()))
                + "; shared atomics (SASS) " + ", ".join(
                    f"{k} {v or 'none'}"
                    for k, v in sorted(atomics[name].items())), flush=True)
        order = (args.order.split(",") if args.order else list(libs))

        data = step_shapes(dev)
        labels = args.shapes.split(",") if args.shapes else list(data)
        result = {"card": smi, "order": order, "ptxas": usage,
                  "shared_atomics": atomics, "shapes": {}}
        saved = raster_kernel._lib
        for label in labels:
            r = data[label]
            counts, fwd_bound, bwd_bound = render_bounds(r)
            kw = r["kw"]
            steps = block_steps(r["fv"], r["bins"], kw["image_size"],
                                kw["mf_cap"], kw["sigma_val"],
                                kw["dist_eps"])
            rec = {"images": r["fv"].shape[0], "pair_counts": counts,
                   "block_steps": steps,
                   "fwd_bound": fwd_bound, "bwd_bound": bwd_bound,
                   "fwd_ms": [], "bwd_ms": [], "vs_first": {}}
            hard = kw["aggr_func_rgb"] == "hard"
            first = None
            for name in order:
                raster_kernel._lib = libs[name]
                o = render_fwd(r)
                if first is None:
                    first = o
                elif name not in rec["vs_first"]:
                    rec["vs_first"][name] = compare_outputs(first, o, hard)
                rec["fwd_ms"].append(time_ms(lambda: render_fwd(r),
                                             args.reps))
                if r["bwd"] is not None:
                    g = torch.randn(o.rgba.shape, device=dev,
                                    generator=torch.Generator(dev)
                                    .manual_seed(5))
                    rec["bwd_ms"].append(time_ms(
                        lambda: render_bwd(r, o, g), args.reps))
            raster_kernel._lib = saved
            result["shapes"][label] = rec
            print(f"{label} ({rec['images']} images; slots, pairs in bbox, "
                  f"past the threshold, in depth: {counts}; the forward's "
                  f"block steps {steps}, lanes in a bbox "
                  f"{counts[1] / max(32 * steps, 1):.3f}): forward ms "
                  + ", ".join(f"{n} {t:.3f}" for n, t in
                              zip(order, rec["fwd_ms"]))
                  + f" (bound {fwd_bound[0]:.3f} ms, {fwd_bound[1]})"
                  + ("" if bwd_bound is None else
                     "; backward ms " + ", ".join(
                         f"{n} {t:.3f}" for n, t in
                         zip(order, rec["bwd_ms"]))
                     + f" (bound {bwd_bound[0]:.3f} ms, {bwd_bound[1]})")
                  + f" [{smi}]", flush=True)
            for name, d in rec["vs_first"].items():
                print(f"  {name} vs {order[0]}: max |diff| rgba "
                      f"{d['rgba']:.3e}, aggr {d['aggr']:.3e}, p2f "
                      f"{d['p2f']:.3e}" + ("" if d["hard_equal"] is None else
                                          f"; hard face id + depth equal on "
                                          f"{d['hard_equal']:.6f} of covered "
                                          "pixels"), flush=True)
            del first, o
    print(json.dumps(result))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(result, fh, indent=1)


if __name__ == "__main__":
    main()
