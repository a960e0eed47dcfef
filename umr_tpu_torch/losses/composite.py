"""Composite rendering losses of the stage-2 objective (port of
umr_tpu/losses/composite.py).

  * camera hypotheses are folded into the batch of one render per loss;
  * the 4 semantic part channels are rendered in 3-channel groups (the
    channels share the softmax weights, so the grouping is exact);
  * on the kernels' route the silhouette and texture hypothesis renders
    are one fused render whose rgb gradients reach the texels only
    (rgb_geom_detach): the reference renders textures with detached
    geometry. On the plain route (exact AD) they stay two renders.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.grid_sample import grid_sample
from ..renderer.soft_renderer import SoftRenderer
from .losses import batch_get_centers, bce_with_logits, chamfer_dist, neg_iou_loss


def _chunked_render(render_fn, n, chunks):
    """render_fn(i0, m) over `chunks` consecutive slices of a folded batch
    of n (bounds the renders' peak memory), outputs concatenated."""
    if chunks <= 1 or n % chunks:
        return render_fn(0, n)
    m = n // chunks
    outs = [render_fn(i * m, m) for i in range(chunks)]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(parts, 0) for parts in zip(*outs))
    return torch.cat(outs, 0)


def multi_mask_loss(renderer: SoftRenderer, vs, faces, cams_all_hypo,
                    cam_probs, masks_gt, chunks=1):
    """Probability-weighted neg-IoU over the camera hypotheses.
    vs [B,V,3]; cams_all_hypo [B,K,7]; cam_probs [B,K]; masks_gt [B,H,W].
    Returns (loss, mask_all_hypo [B*K,H,W])."""
    B, K = cams_all_hypo.shape[:2]
    pred_vs = vs.repeat_interleave(K, 0)
    cams = cams_all_hypo.reshape(B * K, 7)

    def render_slice(i0, m):
        return renderer.render(pred_vs[i0:i0 + m], faces, cams[i0:i0 + m],
                               mask_only=True).rgba[..., 3]

    mask_all_hypo = _chunked_render(render_slice, B * K, chunks)
    masks = masks_gt.repeat_interleave(K, 0)
    loss = neg_iou_loss(mask_all_hypo, masks, avg=False).reshape(B, K)
    return (loss * cam_probs).sum(1).mean(), mask_all_hypo


def multi_mask_texture_render(renderer, tex_renderer, vs, faces,
                              cams_all_hypo, tex, chunks=1):
    """Per-hypothesis silhouette and texture render.

    Returns (mask_all_hypo [B*K,H,W] with live-geometry gradients,
    texture_pred [B*K,H,W,3] with texture-only gradients): one fused
    render on the kernels' route, two renders (exact AD) on the plain
    route."""
    B, K = cams_all_hypo.shape[:2]
    pred_vs = vs.repeat_interleave(K, 0)
    cams = cams_all_hypo.reshape(B * K, 7)
    texs = tex.repeat_interleave(K, 0)

    if tex_renderer.uses_kernel(vs.device):
        def render_slice(i0, m):
            sl = slice(i0, i0 + m)
            out = tex_renderer.render(pred_vs[sl], faces, cams[sl], texs[sl],
                                      rgb_geom_detach=True)
            return out.rgba[..., 3], out.rgba[..., :3]

        return _chunked_render(render_slice, B * K, chunks)

    def mask_slice(i0, m):
        sl = slice(i0, i0 + m)
        return renderer.render(pred_vs[sl], faces, cams[sl],
                               mask_only=True).rgba[..., 3]

    def tex_slice(i0, m):
        sl = slice(i0, i0 + m)
        return tex_renderer.render(pred_vs[sl].detach(), faces,
                                   cams[sl].detach(), texs[sl]).rgba[..., :3]

    return (_chunked_render(mask_slice, B * K, chunks),
            _chunked_render(tex_slice, B * K, chunks))


def corr_loss_chamfer(project_points, part_vert_idx, part_points, verts,
                      cams, weights=(1.0, 1.0, 0.0, 0.0), avg=True):
    """Semantic part-correspondence chamfer loss: the template vertices of
    each part (head, belly, neck, back) projected and matched to that
    part's sampled 2D points [B,N,2]. The zero-weighted parts stay in the
    mean's denominator, as in the reference; a part with no vertices adds
    nothing. Returns (loss, projected part vertices)."""
    vert_coords = torch.cat([verts[:, torch.as_tensor(np.asarray(idx),
                                                      device=verts.device)]
                             for idx in part_vert_idx], dim=1)
    vert2d = project_points(vert_coords, cams)
    dists, off = [], 0
    for idx, pts, w in zip(part_vert_idx, part_points, weights):
        n = len(idx)
        if n == 0:
            continue
        d1 = chamfer_dist(vert2d[:, off:off + n], pts)[0]
        dists.append(d1 * w)
        off += n
    loss = torch.cat(dists, dim=1).mean(dim=1)
    return (loss.mean() if avg else loss), vert2d


@dataclasses.dataclass(frozen=True, eq=False)
class PartMatchingLoss:
    """Semantic part matching through rendered one-hot part textures."""

    part_tex: torch.Tensor    # [F, T2, num_parts] one-hot parts 1..num_parts
    renderer: SoftRenderer
    weights: tuple = (0.0, 5.0, 0.0, 0.0, 5.0)
    bg_value: float = 0.1
    num_parts: int = 4

    @staticmethod
    def build(semantic_seg, uv_sampler, num_sym_faces, renderer,
              tex_size=6, num_parts=4, device="cpu"):
        """semantic_seg: [H,W] integer labels 0..num_parts (the UV label
        map); uv_sampler: [F_tex,T,T,2]. The float label map is sampled
        bilinearly, then rounded, as the reference does."""
        seg = torch.as_tensor(np.asarray(semantic_seg, np.float32),
                              device=device)[None, :, :, None]
        sampler = torch.as_tensor(np.asarray(uv_sampler, np.float32),
                                  device=device)
        Ft, T = sampler.shape[:2]
        tex = grid_sample(seg, sampler.reshape(1, Ft * T * T, 2)).reshape(
            1, Ft, T * T)
        tex = torch.cat([tex, tex[:, -num_sym_faces:]], dim=1)[0]
        one_hot = torch.nn.functional.one_hot(
            torch.round(tex).long(), num_parts + 1).float()
        return PartMatchingLoss(part_tex=one_hot[..., 1:], renderer=renderer,
                                num_parts=num_parts)

    def texture_groups(self, B):
        """The one-hot part textures in renderable 3-channel groups (the
        last zero-padded): a list of [B, F, T2, 3] tensors."""
        tex_all = self.part_tex[None].expand((B,) + self.part_tex.shape)
        groups = []
        for c0 in range(0, self.num_parts, 3):
            sub = tex_all[..., c0:c0 + 3]
            pad = 3 - sub.shape[-1]
            if pad:
                sub = torch.cat([sub, sub.new_zeros(sub.shape[:-1] + (pad,))],
                                dim=-1)
            groups.append(sub)
        return groups

    def projs_from_group_renders(self, rgb_groups):
        """Rendered group images [B,H,W,3] each -> projs [B,num_parts,H,W]
        (the padding channels dropped)."""
        chans = [rgb[..., :min(3, self.num_parts - i * 3)]
                 for i, rgb in enumerate(rgb_groups)]
        return torch.cat(chans, dim=-1).permute(0, 3, 1, 2)

    def __call__(self, verts, faces, cams, part_segs, cam_probs=None,
                 avg=True):
        """part_segs: [B, num_parts+1, H, W] normalised part maps.
        Returns (loss, projs [B,num_parts,H,W])."""
        rgb_groups = [
            self.renderer.render(verts, faces, cams, sub.detach(),
                                 tex_grads=False).rgba[..., :3]
            for sub in self.texture_groups(verts.shape[0])]
        projs = self.projs_from_group_renders(rgb_groups)
        return self.loss_from_projs(projs, part_segs, cam_probs, avg)

    def loss_from_projs(self, projs, part_segs, cam_probs=None, avg=True):
        """Loss from rendered part projections [B,num_parts,H,W]."""
        B, S = projs.shape[0], projs.shape[-1]
        bg = projs.new_full((B, 1, S, S), self.bg_value)
        proj = torch.cat([bg, projs], dim=1)              # [B,P+1,H,W]
        centers_proj = batch_get_centers(torch.softmax(proj, dim=1)[:, 1:])
        centers_parts = batch_get_centers(
            torch.softmax(part_segs, dim=1)[:, 1:])
        w = proj.new_tensor(self.weights).reshape(1, -1, 1, 1)
        max_proj = proj.reshape(B, self.num_parts + 1, -1).amax(
            dim=2).clamp_min(1e-5)
        proj_norm = proj / max_proj[:, :, None, None]
        max_part = part_segs.reshape(B, self.num_parts + 1, -1).amax(
            dim=2).clamp_min(1e-5)
        part_norm = part_segs / max_part[:, :, None, None]
        if avg:
            loss_eqv = (((proj_norm - part_norm) ** 2) * w).mean()
            loss_lmeqv = ((centers_proj - centers_parts) ** 2).mean()
        else:
            le = (((proj_norm - part_norm) ** 2) * w).sum(dim=(1, 2, 3))
            le = le / (proj.shape[1] * proj.shape[2] * proj.shape[3])
            loss_eqv = (le.reshape(cam_probs.shape) * cam_probs).sum(1).mean()
            lm = ((centers_proj - centers_parts) ** 2).sum(dim=(1, 2))
            lm = lm / (centers_proj.shape[1] * centers_proj.shape[2])
            loss_lmeqv = (lm.reshape(cam_probs.shape) * cam_probs).sum(
                1).mean()
        return (loss_eqv + loss_lmeqv) / 4.0, projs


def gan_loss(disc_apply, real, fake):
    """BCE GAN loss through the gradient-reversal discriminator. real /
    fake: NHWC images. Returns (loss, accuracy)."""
    pred = torch.cat([real, fake], dim=0)
    labels = torch.cat([real.new_ones(real.shape[0]),
                        real.new_zeros(fake.shape[0])])
    logits = disc_apply(pred).squeeze(-1)
    loss = bce_with_logits(logits, labels)
    acc = ((torch.sigmoid(logits) >= 0.5).float() == labels)
    return loss, acc.float().mean()
