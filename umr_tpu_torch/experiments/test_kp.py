"""Keypoint-transfer PCK (port of umr_tpu/experiments/test_kp.py).

  python -m umr_tpu_torch.experiments.test_kp --mode flow \\
      --number_pairs 10000 --model_path <pth> ...

Both transfer modes:
  flow: keypoint -> gaussian heatmap -> the face whose texels (sampled
        at the source flow) see the most of it -> that face's mean
        target-image coordinate (identity grid sampled at the target
        flow). Ref: test_kp.py:125-158.
  cam:  keypoint -> nearest projected template vertex (source camera)
        -> that vertex's nearest foreground pixel in the target view's
        rendered mask. Ref: test_kp.py:160-193.

Pairs go through the model 16 at a time, or number_pairs at a time when
fewer, as in the JAX package (the last group padded by its final pair);
run() takes the two pair loaders (the CUB pair loaders are
not ported yet).
"""

from __future__ import annotations

import numpy as np
import torch

from ..cli import TEST_KP_DEFAULTS, parse_config
from ..config import Config, normalize_images, resolve_device
from ..mesh import build_template
from ..models import symmetrize
from ..ops.grid_sample import grid_sample, identity_grid
from ..renderer import SoftRenderer
from ..visualizer import green
from .test_iou import build_eval_model

GROUP_PAIRS = 16


def kp_heatmaps(kps, image_size, sigma=3.0):
    """kps [K,2] pixel coordinates -> [K,H,W] gaussians with peak 1 at
    floor(kp); keypoints more than 3 sigma outside the image give empty
    maps (ref: utils/kp_utils.py:42-69)."""
    S = image_size
    ar = torch.arange(S, dtype=kps.dtype, device=kps.device)
    cx = torch.floor(kps[:, 0])[:, None, None]
    cy = torch.floor(kps[:, 1])[:, None, None]
    g = torch.exp(-((ar[None, None, :] - cx) ** 2
                    + (ar[None, :, None] - cy) ** 2) / (2 * sigma ** 2))
    inb = ((kps[:, 0] > -3 * sigma) & (kps[:, 0] < S + 3 * sigma)
           & (kps[:, 1] > -3 * sigma) & (kps[:, 1] < S + 3 * sigma))
    return g * inb[:, None, None]


def map_kp_flow(kp_src, flow_src, flow_tgt, image_size, sigma=3.0):
    """kp_src [K,3]; flow_src, flow_tgt [F,T,T,2] -> transferred [K,2]."""
    F = flow_src.shape[0]
    S = image_size
    sgrid = identity_grid(S, S, device=kp_src.device)[None]
    # each face -> its mean target-image coordinate
    p2face = grid_sample(sgrid, flow_tgt.reshape(1, F, -1, 2)).mean(dim=2)[0]
    # `* 256`, not `* image_size`: the reference hardcodes 256 here
    # whatever --img_size is (ref: test_kp.py:146)
    kp_px = (kp_src[:, 0:2] + 1) / 2.0 * 256
    hp = kp_heatmaps(kp_px, S, sigma)                        # [K,H,W]
    k2face = grid_sample(hp.permute(1, 2, 0)[None],
                         flow_src.reshape(1, F, -1, 2))[0]  # [F,T2,K]
    return p2face[k2face.mean(dim=1).argmax(dim=0)]


def map_kp_cam(kp_src, cam_src, cam_tgt, mask_tgt, mean_shape,
               project_points, image_size):
    """Camera-mode transfer; mask_tgt [H,W]: the nearest foreground pixel
    by a masked argmin over the whole pixel grid, a [V, H*W] distance
    matrix (642 x 65536 float32, 168 MB, at 256^2)."""
    S = image_size
    vert2d_tgt = project_points(mean_shape[None], cam_tgt[None])[0]  # [V,2]
    sgrid = identity_grid(S, S, device=kp_src.device).reshape(-1, 2)
    fg = mask_tgt.reshape(-1) != 0
    d = ((vert2d_tgt[:, None, :] - sgrid[None, :, :]) ** 2).sum(-1)
    d = torch.where(fg[None, :], d, torch.inf)
    proj2fg_idx = d.argmin(dim=1)                                    # [V]
    vert2d_src = project_points(mean_shape[None], cam_src[None])[0]
    dk = ((kp_src[:, None, 0:2] - vert2d_src[None, :, :]) ** 2).sum(-1)
    return sgrid[proj2fg_idx[dk.argmin(dim=1)]]


@torch.no_grad()
def transfer_group(cfg: Config, model, renderer, template, faces, mean_shape,
                   generator, imgs, kps):
    """One group of pairs: imgs [G,2,H,W,3], kps [G,2,K,3] (numpy) ->
    (k21, k12) [G,K,2] (numpy): each pair's second image's keypoints on
    the first, and back."""
    group = imgs.shape[0]
    device = mean_shape.device
    flat = imgs.reshape((-1,) + imgs.shape[2:])
    x = torch.as_tensor(normalize_images(flat), device=device)
    # every group draws with the same seed, as the JAX loop reuses its key
    generator.manual_seed(cfg.seed)
    out = model(x, generator=generator)
    kps_t = torch.as_tensor(kps, device=device)
    k12, k21 = [], []
    if cfg.mode == "flow":
        # the flow alone: no render
        flows = out["tex_flow"].reshape((group, 2)
                                        + out["tex_flow"].shape[1:])
        for kp, fl in zip(kps_t, flows):
            k12.append(map_kp_flow(kp[0], fl[0], fl[1], cfg.image_size,
                                   cfg.sigma))
            k21.append(map_kp_flow(kp[1], fl[1], fl[0], cfg.image_size,
                                   cfg.sigma))
    else:
        verts = mean_shape[None] + symmetrize(out["delta_v"], template)
        masks = renderer.render(verts, faces, out["cam"]).rgba[..., 3]
        cams = out["cam"].reshape(group, 2, -1)
        masks = masks.reshape((group, 2) + masks.shape[1:])
        pp = renderer.project_points
        # one pair at a time: one [V, H*W] distance matrix at once
        for kp, cm, mk in zip(kps_t, cams, masks):
            k12.append(map_kp_cam(kp[0], cm[0], cm[1], mk[1], mean_shape,
                                  pp, cfg.image_size))
            k21.append(map_kp_cam(kp[1], cm[1], cm[0], mk[0], mean_shape,
                                  pp, cfg.image_size))
    return (torch.stack(k21).cpu().numpy(), torch.stack(k12).cpu().numpy())


def run(cfg: Config, loaders=None, device=None):
    """PCK at 0.1 and 0.15 over cfg.number_pairs pairs: `loaders` yields
    two loaders whose batches (img [1,H,W,3], kp [1,K,3]) pair up, on the
    card unless device="cpu". Returns (pck@0.1, pck@0.15)."""
    if loaders is None:
        raise NotImplementedError(
            "pass the pair loaders: the CUB pair loaders are not ported yet")
    if cfg.visualize:
        raise NotImplementedError("--visualize is not ported")
    device = resolve_device(device)
    template = build_template(cfg.subdivide, cfg.axis, cfg.tex_size)
    model = build_eval_model(cfg, template, device)
    renderer = SoftRenderer(image_size=cfg.image_size, render_type="softmax",
                            anti_aliasing=cfg.anti_aliasing)
    faces = torch.as_tensor(template.faces, device=device)
    mean_shape = model.get_mean_shape()
    generator = torch.Generator(device)
    # groups of 16, or of number_pairs when fewer, as the JAX package's
    # (umr_tpu/experiments/test_kp.py:176)
    group = max(1, min(GROUP_PAIRS, int(cfg.number_pairs)))
    err_scaling = (1 + 2 * cfg.padding_frac) / 2.0
    kp_errs, kp_vis = [], []

    def process_group(pending):
        n = len(pending)
        items = pending + [pending[-1]] * (group - n)
        imgs = np.stack([p[0] for p in items])             # [G,2,H,W,3]
        kps = np.stack([p[1] for p in items])              # [G,2,K,3]
        k21, k12 = transfer_group(cfg, model, renderer, template, faces,
                                  mean_shape, generator, imgs, kps)
        vis = (kps[:, 0, :, 2] * kps[:, 1, :, 2])[:, None].repeat(2, axis=1)
        err = np.stack([k21, k12], axis=1) - kps[:, :, :, 0:2]
        err = np.sqrt((err ** 2).sum(axis=3)) * err_scaling
        kp_errs.extend(err[:n])
        kp_vis.extend(vis[:n])

    pending, n_done = [], 0
    for b1, b2 in zip(*loaders):
        pending.append((np.concatenate([b1["img"], b2["img"]], axis=0),
                        np.concatenate([b1["kp"], b2["kp"]], axis=0)))
        if len(pending) == group:
            process_group(pending)
            n_done += len(pending)
            pending = []
        if n_done + len(pending) >= cfg.number_pairs:
            break
    if pending:
        process_group(pending)

    kp_errs = np.concatenate(kp_errs)
    kp_vis = np.concatenate(kp_vis)
    n_vis = kp_vis.sum(axis=0)
    pck1 = ((kp_errs < 0.1) * kp_vis).sum(axis=0) / n_vis
    pck15 = ((kp_errs < 0.15) * kp_vis).sum(axis=0) / n_vis
    print(green("PCK.1 %.3g, PCK.15 %.3g" % (pck1.mean(), pck15.mean())))
    return float(pck1.mean()), float(pck15.mean())


def main(argv=None):
    run(parse_config(argv, overrides=TEST_KP_DEFAULTS))


if __name__ == "__main__":
    main()
