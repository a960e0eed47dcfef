"""Component-level timing of the stage-2 training step (port of
tools/profile_step.py): each loss component's forward and backward in
isolation, to rank where the step's time goes beside what
profile_slice.py's profiler ranges give.

Isolation re-runs the bits of the model each component needs, so the
rows sum to more than the FULL step: read the ranking, not the sum. The
components, at the sizes of UMR_PROFILE_BATCH, _SIZE, _SUBDIV, _TEX,
_HYPO and _AA (default 16, 256, 3, 6, 8, 1: bench.py's s2 step):
  FULL step (build_s2_step's, forward + backward + Adam; the state is put
    back after its timing, so the rows below see the initial weights);
  the model's forward + backward without renders;
  the fused hypothesis render, forward + backward at B*K images;
  LPIPS forward + backward at B*K images;
  the hard render, forward only (its p2f is all zero on stage 2's hard
    renderer, and is summed all the same, as the JAX tool sums it);
  the GAN's unseen render, forward + backward at B;
  the part matching, forward + backward at B;
  the discriminator, forward + backward at B real + B fake;
  the optimizer update (zero gradients);
  the trainer's batch route (trainer.BatchPrep: the loader's arrays
    copied to the card and the batch prepared there).
On the card each row is timed with CUDA events (`iters` calls after one
warm-up), on the CPU with perf_counter; the warm-up call's rasterizer
launches (ops/raster_kernel.py's counters) and forward value are kept.
The random draws (VAE noise, camera hypothesis, GAN angles) are seeded
and injected, so the FULL row's loss is build_s2_step's on the same
state, batch and draws.

  python -m umr_tpu_torch.experiments.profile_step [--device cpu]
"""

from __future__ import annotations

import argparse
import copy
import os
import time

import numpy as np
import torch

from ..config import Config, resolve_device
from ..data import synthetic_batch
from ..losses.composite import (PartMatchingLoss, gan_loss,
                                multi_mask_texture_render)
from ..mesh import build_template
from ..models import symmetrize
from ..ops import raster_kernel
from ..ops.grid_sample import sample_textures
from ..ops.quaternion import rotate_cam
from ..renderer import SoftRenderer
from ..training.steps import _renderers, build_s2_step, normalize_part_segs
from ..training.trainer import BatchPrep, prepare_batch

# the s2 part vertex sets (head, belly, neck, back): slices of a seeded
# permutation of the template's vertices, as the JAX tool's
PART_SLICES = ((0, 100), (100, 250), (250, 330), (330, 480))


def sizes():
    """The JAX tool's UMR_PROFILE_* variables."""
    env = os.environ.get
    return dict(batch=int(env("UMR_PROFILE_BATCH", 16)),
                size=int(env("UMR_PROFILE_SIZE", 256)),
                subdivide=int(env("UMR_PROFILE_SUBDIV", 3)),
                tex=int(env("UMR_PROFILE_TEX", 6)),
                hypo=int(env("UMR_PROFILE_HYPO", 8)),
                aa=env("UMR_PROFILE_AA", "1") == "1")


def _timer(device):
    """fn -> ms per call over `iters` calls."""
    if device.type == "cuda":
        def time_ms(fn, iters):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            torch.cuda.synchronize(device)
            return start.elapsed_time(end) / iters
    else:
        def time_ms(fn, iters):
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            return (time.perf_counter() - t0) * 1e3 / iters
    return time_ms


def _grad(value, inputs):
    """value's gradients to `inputs` (None where it does not reach)."""
    return torch.autograd.grad(value, inputs, allow_unused=True)


def run(device=None, iters=4, size_kw=None):
    """Time every row; returns {"rows": [{name, ms, value, fwd_launches,
    bwd_launches}], "cfg", "seg", "pvi", "batch", "draws", "pieces"}: the
    configuration and the seeded inputs (pieces: the model's outputs the
    render rows take) for a caller that recomputes a row."""
    device = resolve_device(device)
    sz = dict(sizes(), **(size_kw or {}))
    B, S = sz["batch"], sz["size"]
    cfg = Config(image_size=S, img_size=S, batch_size=B,
                 num_hypo_cams=sz["hypo"], anti_aliasing=sz["aa"],
                 subdivide=sz["subdivide"], tex_size=sz["tex"])
    template = build_template(cfg.subdivide, cfg.axis, cfg.tex_size)
    rng = np.random.RandomState(0)
    seg = rng.randint(0, 5, size=(128, 256)).astype(np.float32)
    idx = rng.permutation(template.num_verts)
    pvi = [idx[a:b] for a, b in PART_SLICES]
    part_loss = PartMatchingLoss.build(
        seg, template.uv_sampler, template.num_sym_faces,
        SoftRenderer(image_size=S, anti_aliasing=cfg.anti_aliasing,
                     ambient_intensity=1.0, directional_intensity=0.0),
        tex_size=cfg.tex_size, num_parts=cfg.num_parts, device=device)
    model, disc, lpips, init_fn, step_fn = build_s2_step(
        cfg, template, part_loss, pvi, device)
    state = init_fn(0)
    loader_batch = synthetic_batch(rng, B, S)
    host_batch = prepare_batch(loader_batch)
    draws = dict(eps=rng.normal(size=(B, cfg.z_dim)).astype(np.float32),
                 sample_inds=rng.randint(0, cfg.num_hypo_cams, size=(B, 1)),
                 angles=rng.randint(0, 180, size=B))
    batch = {k: torch.as_tensor(v, device=device)
             for k, v in host_batch.items()}
    dr = {k: torch.as_tensor(v, device=device) for k, v in draws.items()}
    time_ms = _timer(device)
    rows = []

    def row(name, fn):
        l0 = (raster_kernel.LAUNCHES, raster_kernel.BWD_LAUNCHES)
        v = fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        rows.append(dict(
            name=name, value=None if v is None else float(v),
            fwd_launches=raster_kernel.LAUNCHES - l0[0],
            bwd_launches=raster_kernel.BWD_LAUNCHES - l0[1]))
        rows[-1]["ms"] = time_ms(fn, iters)
        print(f"{name:34s} {rows[-1]['ms']:9.1f} ms", flush=True)

    renderer, tex_renderer, hard_renderer = _renderers(cfg, "auto")
    faces = torch.as_tensor(template.faces, device=device)
    # one model forward for realistic render inputs (eval, as JAX's)
    model.eval()
    with torch.no_grad():
        out = model(batch["input_img"], eps=dr["eps"],
                    sample_inds=dr["sample_inds"])
        mean_shape = symmetrize(model.mean_v, template)
        pred_vs = mean_shape[None] + symmetrize(out["delta_v"], template)
        tex = sample_textures(out["tex_flow"], batch["img"])
        T = tex.shape[2]
        tex = tex.reshape(B, tex.shape[1], T * T, 3)
    cams_all, proj_cam = out["cam_hypotheses"], out["cam"]
    imgs, masks = batch["img"], batch["mask"]
    K = cams_all.shape[1]

    saved = copy.deepcopy((model.state_dict(), disc.state_dict(),
                           state.optimizer.state_dict()))
    row("FULL step",
        lambda: step_fn(state, batch, draws)[1]["total_loss"])
    model.load_state_dict(saved[0])
    disc.load_state_dict(saved[1])
    state.optimizer.load_state_dict(saved[2])
    state.step = state.updates = 0

    params = [p for p in model.parameters() if p.requires_grad]

    def model_fb():
        model.train()
        o = model(batch["input_img"], eps=dr["eps"],
                  sample_inds=dr["sample_inds"])
        v = sum(o[k].sum() for k in ("delta_v", "cam_hypotheses",
                                     "tex_flow", "cam_probs"))
        _grad(v, params)
        return v.detach()
    row("model fwd+bwd (no renders)", model_fb)

    v_leaf = pred_vs.detach().requires_grad_(True)
    t_leaf = tex.detach().requires_grad_(True)

    def fused():
        m, tp = multi_mask_texture_render(
            renderer, tex_renderer, v_leaf, faces, cams_all, t_leaf,
            chunks=cfg.hypo_render_chunks)
        v = m.sum() + tp.sum()
        _grad(v, (v_leaf, t_leaf))
        return v.detach()
    row("fused hypo render fwd+bwd (B*K)", fused)

    mrep = masks.repeat_interleave(K, 0)[..., None]
    irep = imgs.repeat_interleave(K, 0)
    tp_leaf = (irep * 0.5).requires_grad_(True)   # stand-in rgb images

    def lp():
        v = state.lpips(2 * tp_leaf * mrep - 1, 2 * irep * mrep - 1).sum()
        _grad(v, tp_leaf)
        return v.detach()
    row("LPIPS fwd+bwd (B*K images)", lp)

    def hard():
        with torch.no_grad():
            o = hard_renderer.render(pred_vs, faces, proj_cam)
            return o.aggr[:, 1].sum() + o.p2f.sum()
    row("hard render fwd (B)", hard)

    random_cams = rotate_cam(proj_cam, dr["angles"])

    def gan():
        o = tex_renderer.render(v_leaf, faces, random_cams, tex,
                                tex_grads=False)
        v = o.rgba[..., :3].sum()
        _grad(v, v_leaf)
        return v.detach()
    row("GAN unseen rgb render fwd+bwd (B)", gan)

    part_segs = normalize_part_segs(batch["part_prob"], masks)

    def pm():
        v = part_loss(v_leaf, faces, proj_cam, part_segs)[0]
        _grad(v, v_leaf)
        return v.detach()
    row("part-matching fwd+bwd (B)", pm)

    disc_params = list(disc.parameters())

    def dsc():
        v = gan_loss(disc, irep[:B], irep[:B] * 0.5)[0]
        _grad(v, disc_params)
        return v.detach()
    row("discriminator fwd+bwd (B)", dsc)

    opt = state.optimizer
    for group in opt.param_groups:
        for p in group["params"]:
            p.grad = torch.zeros_like(p)
    row("optimizer update", opt.step)
    opt.zero_grad(set_to_none=True)

    batch_prep = BatchPrep(device=device)

    def put():
        batch_prep(loader_batch)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    row("host->device batch transfer", put)

    pieces = dict(pred_vs=pred_vs, tex=tex, cams_all=cams_all,
                  proj_cam=proj_cam, random_cams=random_cams)
    return dict(rows=rows, cfg=cfg, seg=seg, pvi=pvi, batch=host_batch,
                draws=draws, pieces=pieces)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="the card unless given (cpu for the CPU)")
    args = ap.parse_args(argv)
    return run(args.device)["rows"]


if __name__ == "__main__":
    main()
