"""Soak check (port of tools/soak_train.py): real optimization for N steps
of either stage, and the trends that show it works, not just that one
step runs:

  - total loss and mask loss: tail mean < head mean;
  - the mask IoU (neg_iou_loss is 1 - IoU): rising;
  - every scalar the step reports, head and tail;
  - stage 1: the online template update on a cadence, the template's
    mean vertex displacement from its init finite and under 2.0.

Batches are fresh by default (a new synthetic batch every step, drawn
from RandomState(0) as the JAX tool draws them); --n_batches N > 0
rotates N batches instead. The steps are the port's build_s1_step /
build_s2_step at full width (256^2, AA, K=8, subdivide 3, tex_size 6),
on the card unless --device cpu. A first step outside the timing builds
what the card needs; unlike the JAX tool's, whose jitted warm-up result
is dropped, it updates the state as every step does.

  python -m umr_tpu_torch.experiments.soak_train --stage s2 --steps 100 \
      --batch 16

soak(argv) runs the steps and returns the summary it prints (JSON);
check(summary) raises AssertionError where a trend fails; main does
both.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..config import Config, resolve_device
from ..data import synthetic_batch
from ..losses.composite import PartMatchingLoss
from ..mesh import build_template
from ..renderer import SoftRenderer
from ..training import steps as tsteps
from ..training.trainer import prepare_batch


# the s2 part vertex sets (head, belly, neck, back): slices of a seeded
# permutation of the template's vertices, as the JAX tool's
PART_SLICES = ((0, 100), (100, 250), (250, 330), (330, 480))


def _head_tail(vs, k=3):
    k = min(k, max(1, len(vs) // 3))
    return float(np.mean(vs[:k])), float(np.mean(vs[-k:]))


def soak(argv=None):
    """The soak's steps (argv: the flags above); returns its summary."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--stage", choices=["s1", "s2"], default="s2")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--image_size", type=int, default=256)
    ap.add_argument("--n_batches", type=int, default=0,
                    help="0 = fresh batch per step; N>0 = rotate N batches")
    ap.add_argument("--template_update_every", type=int, default=120,
                    help="s1: run the online template update every K steps")
    ap.add_argument("--device", default=None, help="the card unless 'cpu'")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    S = args.image_size
    cfg = Config(image_size=S, img_size=S, batch_size=args.batch,
                 num_hypo_cams=8, anti_aliasing=True, subdivide=3,
                 tex_size=6)
    template = build_template(cfg.subdivide, cfg.axis, cfg.tex_size)
    rng = np.random.RandomState(0)

    def fresh_batch():
        return prepare_batch(synthetic_batch(rng, args.batch, S),
                             cfg.use_scops, cfg.use_texture)

    batches = ([fresh_batch() for _ in range(args.n_batches)]
               if args.n_batches > 0 else None)

    template_update = None
    if args.stage == "s2":
        seg = rng.randint(0, 5, size=(128, 256)).astype(np.float32)
        idx = rng.permutation(template.num_verts)
        pvi = [idx[a:b] for a, b in PART_SLICES]
        part_loss = PartMatchingLoss.build(
            seg, template.uv_sampler, template.num_sym_faces,
            SoftRenderer(image_size=S, anti_aliasing=cfg.anti_aliasing,
                         ambient_intensity=1.0, directional_intensity=0.0),
            tex_size=cfg.tex_size, num_parts=cfg.num_parts, device=device)
        init_fn, step_fn = tsteps.build_s2_step(cfg, template, part_loss,
                                                pvi, device)[3:]
        state = init_fn(0)

        def step(state, batch):
            return step_fn(state, batch)
    else:
        (init_fn, step_fn, encode_feat_fn,
         template_update_fn) = tsteps.build_s1_step(cfg, template, device)[3:]
        state = init_fn(0)

        def step(state, batch):
            return step_fn(state, batch, 0.0)

        def template_update(state, batch):
            feat = encode_feat_fn(state, batch)
            return template_update_fn(state, feat.mean(0))

    mean_v0 = state.model.mean_v.detach().cpu().numpy().copy()

    hist = {}          # scalar name -> values every 10 steps
    tpl_disp = []      # the template's mean displacement after updates
    warm = fresh_batch() if batches is None else batches[0]
    _, sc = step(state, warm)          # the first step outside the timing
    float(sc["total_loss"])

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    sync()
    t0 = time.perf_counter()
    for i in range(args.steps):
        batch = batches[i % args.n_batches] if batches else fresh_batch()
        state, sc = step(state, batch)
        if i % 10 == 0 or i == args.steps - 1:
            vals = {k: float(v) for k, v in sc.items()}
            for k, v in vals.items():
                hist.setdefault(k, []).append(v)
            print(f"step {i:4d}  total {vals['total_loss']:8.4f}  "
                  f"mask {vals['mask_loss']:7.4f}", flush=True)
            assert np.isfinite(vals["total_loss"]), \
                f"non-finite loss at step {i}"
        if (template_update is not None and i > 0
                and i % args.template_update_every == 0):
            state = template_update(state, batch)
            mv = state.model.mean_v.detach().cpu().numpy()
            disp = float(np.linalg.norm(mv - mean_v0, axis=1).mean())
            tpl_disp.append(round(disp, 4))
            assert np.isfinite(mv).all(), "template went non-finite"
            print(f"  template update: mean vertex displacement {disp:.4f}",
                  flush=True)
    sync()
    wall = time.perf_counter() - t0

    trends = {}
    for name, vs in sorted(hist.items()):
        h, t = _head_tail(vs)
        trends[name] = {"head": round(h, 4), "tail": round(t, 4)}
    total_h, total_t = _head_tail(hist["total_loss"])
    mask_h, mask_t = _head_tail(hist["mask_loss"])
    # neg_iou_loss = 1 - IoU: the rendered mask's IoU against the mask
    iou_h, iou_t = 1.0 - mask_h, 1.0 - mask_t
    ok_total = total_t < total_h
    ok_iou = iou_t > iou_h
    summary = {
        "stage": args.stage, "steps": args.steps,
        "fresh_batches": batches is None,
        "loss_first": round(hist["total_loss"][0], 4),
        "loss_last": round(hist["total_loss"][-1], 4),
        "loss_head_mean": round(total_h, 4),
        "loss_tail_mean": round(total_t, 4),
        "mask_iou_head": round(iou_h, 4),
        "mask_iou_tail": round(iou_t, 4),
        "template_disp": tpl_disp,
        "trends": trends,
        "decreased": bool(ok_total),
        "iou_improved": bool(ok_iou),
        "wall_s": round(wall, 1),
        "images_per_sec": round(args.steps * args.batch / wall, 2),
    }
    print(json.dumps(summary), flush=True)
    return summary


def check(summary):
    """The soak's assertions: the total loss fell head to tail, the mask
    IoU rose, the template (stage 1) moved less than 2.0."""
    assert summary["decreased"], "total loss did not decrease head->tail"
    assert summary["iou_improved"], \
        "derived mask IoU did not improve head->tail"
    tpl_disp = summary["template_disp"]
    if tpl_disp:
        assert max(tpl_disp) < 2.0, \
            f"template drifted implausibly far: {tpl_disp}"


def main(argv=None):
    summary = soak(argv)
    check(summary)
    return summary


if __name__ == "__main__":
    main()
