"""Training visuals (port of umr_tpu/training/visuals.py): periodic dumps
of the textured render, the UV images, the mask render, the ground-truth
panels, stage 2's part renders, ground-truth part maps and
part-consistency overlay, and the first mesh (.obj). Images are written
by visualizer.save_image_grid (PNG), meshes by obj_io.save_obj.

Each dump makes these render calls, each one launch of the forward
kernel on the card: the textured render (1; none for a model without
texture, whose textured panels and mesh are skipped, as the JAX
package's are), the mask render (1) and, with a part loss, one per
texture group of its parts (2 for 4 parts).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..image import draw_kp_circles
from ..models.mesh_net import symmetrize
from ..obj_io import save_obj
from ..ops.grid_sample import grid_sample, sample_textures
from ..ops.projection import orthographic_proj_withz
from ..visualizer import save_image_grid

N_VIS = 4     # images of the batch a dump shows


def render_calls(num_parts=0, use_texture=True):
    """The render calls (forward launches on the card) of one dump, with a
    part loss of num_parts parts (0: none); a model without texture
    skips the textured render."""
    return 1 + int(use_texture) + -(-num_parts // 3)


def _np(x):
    return x.detach().cpu().numpy()


def make_visuals_fn(cfg, template, renderer_vis, part_loss=None,
                    part_vert_idx=None):
    """visuals_fn(state, batch, eps=None, sample_inds=None) -> dict of
    [N,H,W,C] float images and ('mesh', verts, faces, tex) entries, from
    state.model in eval mode on the first N_VIS images of the batch (the
    trainer's batch dict, on the model's device). The model's draws come
    from a generator seeded 0 unless eps (and, at stage 2, sample_inds)
    are given.

    With `part_loss` (a PartMatchingLoss) and `part_vert_idx` (the
    head, belly, neck, back template-vertex sets) stage 2's panels are
    added: the rendered part projections, the ground-truth part maps and
    the part-consistency overlay (the projected head / belly template
    vertices beside the sampled ground-truth part points: a dead semantic
    template shows no red or green markers)."""

    @torch.no_grad()
    def visuals_fn(state, batch, eps=None, sample_inds=None):
        model = state.model
        device = model.mean_v.device
        faces = torch.as_tensor(template.faces, device=device)
        x = torch.as_tensor(batch["input_img"][:N_VIS], device=device)
        imgs = torch.as_tensor(batch["img"][:N_VIS], device=device)
        kw = {} if sample_inds is None else {"sample_inds": sample_inds}
        was_training = model.training
        model.eval()
        try:
            out = model(x, eps=eps,
                        generator=torch.Generator(device).manual_seed(0),
                        **kw)
        finally:
            model.train(was_training)
        mean_shape = model.get_mean_shape()
        verts = mean_shape[None] + symmetrize(out["delta_v"], template)
        cam = out["cam"]

        vis = {}
        B = imgs.shape[0]
        if "tex_flow" in out:
            tex = sample_textures(out["tex_flow"], imgs)
            F, T = tex.shape[1:3]
            tex2 = tex.reshape(B, F, T * T, 3)
            r = renderer_vis.render(verts, faces, cam, tex2)
            vis["image_pred"] = _np(r.rgba[..., :3])
            vis["uv_images"] = _np(grid_sample(imgs, out["uvimage_pred"]))
            vis["mesh_0"] = (_np(verts[0]), template.faces, _np(tex2[0]))
        rm = renderer_vis.render(verts, faces, cam)
        vis["mask_pred"] = _np(rm.rgba[..., 3:])
        vis["mask_gt"] = _np(torch.as_tensor(
            batch["mask"][:N_VIS]))[..., None]
        vis["image_gt"] = _np(imgs)

        if part_loss is not None and "part_prob" in batch:
            rgb_groups = [
                part_loss.renderer.render(verts, faces, cam, sub).rgba[
                    ..., :3]
                for sub in part_loss.texture_groups(B)]
            projs = _np(part_loss.projs_from_group_renders(rgb_groups))
            for p in range(projs.shape[1]):
                vis[f"part_render_{p}"] = projs[:, p][..., None]
            pp = _np(torch.as_tensor(batch["part_prob"][:N_VIS]))
            for p in range(min(4, pp.shape[-1] - 1)):
                vis[f"gt_part_render_{p}"] = pp[..., p + 1][..., None]

        if part_vert_idx is not None and "head_points" in batch:
            vis["part_cons_vis"] = _part_cons_overlay(
                cfg, vis["image_gt"], mean_shape, cam, part_vert_idx,
                _np(torch.as_tensor(batch["head_points"][:N_VIS])),
                _np(torch.as_tensor(batch["belly_points"][:N_VIS])))
        return vis

    return visuals_fn


def _part_cons_overlay(cfg, imgs, mean_shape, cams, part_vert_idx,
                       head_points, belly_points):
    """The mean shape's head / belly vertices projected with the predicted
    cameras (red / green) beside the sampled ground-truth head / belly
    part points (yellow / cyan), on imgs [N,H,W,3]. As the reference, the
    part points are scaled by 256 and the projections by the image
    size."""
    S = cfg.image_size
    head_idx, belly_idx = part_vert_idx[0], part_vert_idx[1]
    sel = np.concatenate([head_idx, belly_idx]).astype(int)
    n_head = len(head_idx)
    out = []
    if len(sel):
        pts3 = mean_shape[None, torch.as_tensor(sel, device=cams.device)]
        pts3 = pts3.expand((imgs.shape[0],) + pts3.shape[1:])
        vert2d = _np(orthographic_proj_withz(pts3, cams)[:, :, :2])
    else:
        vert2d = np.zeros((imgs.shape[0], 0, 2), np.float32)
    px = lambda k, s: (np.asarray(k)[:, :2] + 1) / 2.0 * s  # noqa: E731
    color = lambda c, n: np.tile(np.asarray(c, np.uint8),  # noqa: E731
                                 (max(n, 1), 1))
    for i in range(imgs.shape[0]):
        im = np.asarray(np.clip(imgs[i], 0, 1) * 255, np.uint8)
        im = draw_kp_circles(im, px(vert2d[i, :n_head], S), radius=2,
                             colors=color((255, 0, 0), n_head))
        im = draw_kp_circles(im, px(vert2d[i, n_head:], S), radius=2,
                             colors=color((0, 255, 0), len(sel) - n_head))
        im = draw_kp_circles(im, px(head_points[i], 256), radius=2,
                             colors=color((255, 255, 0),
                                          head_points.shape[1]))
        im = draw_kp_circles(im, px(belly_points[i], 256), radius=2,
                             colors=color((0, 255, 255),
                                          belly_points.shape[1]))
        out.append(im.astype(np.float32) / 255.0)
    return np.stack(out)


def save_visuals(vis, out_dir):
    """Each image entry as {out_dir}/{key}.png (a horizontal grid), each
    mesh entry as {out_dir}/{key}.obj."""
    os.makedirs(out_dir, exist_ok=True)
    for k, v in vis.items():
        if k.startswith("mesh"):
            verts, faces, tex = v
            save_obj(os.path.join(out_dir, f"{k}.obj"), verts, faces, tex)
        else:
            save_image_grid(os.path.join(out_dir, f"{k}.png"), v)
