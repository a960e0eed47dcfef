"""Loss functions of the stage-1 and stage-2 objectives, channel-last images (port of
umr_tpu/losses/losses.py: the reference's nnutils/loss_utils.py, the
SoftRas losses and the SCOPS centroid ops).
"""

from __future__ import annotations

import torch

from ..ops.grid_sample import grid_sample


def neg_iou_loss(predict, target, avg=True):
    """predict/target: [B, H, W] soft masks -> 1 - IoU (mean, or [B])."""
    dims = tuple(range(1, predict.ndim))
    intersect = (predict * target).sum(dims)
    union = (predict + target - predict * target).sum(dims) + 1e-6
    iou = intersect / union
    return 1.0 - iou.mean() if avg else 1.0 - iou


def texture_dt_loss(texture_flow, dist_transf):
    """Mean of the distance-transform barrier sampled at the texture flow.
    texture_flow [B,F,T,T,2]; dist_transf [B,H,W,1]."""
    B = texture_flow.shape[0]
    return grid_sample(dist_transf, texture_flow.reshape(B, -1, 2)).mean()


def deform_l2reg(V):
    """Mean vertex-displacement norm."""
    return torch.linalg.norm(V.reshape(-1, V.shape[-1]), dim=1).mean()


def sym_reg(verts):
    """Mean |y| of the vertices [B,V,3]: stage 1's orientation reg."""
    return verts[:, :, 1].abs().mean()


def entropy_loss(A):
    """Mean row entropy."""
    return (-(A * torch.log(A)).sum(1)).mean()


def cam_diversity_loss(cam_probs):
    """-sum(p log p) per sample, meaned (log of p + 1e-9)."""
    return (-(torch.log(cam_probs + 1e-9) * cam_probs).sum(1)).mean()


def laplacian_loss(verts, laplacian, average=False):
    """verts [B,V,3]; laplacian [V,V] -> [B] (mean with average)."""
    x = torch.einsum("vw,bwc->bvc", laplacian, verts)
    out = (x ** 2).sum(dim=(1, 2))
    return out.mean() if average else out


def flatten_loss(verts, flatten_idx, eps=1e-6, average=False):
    """Dihedral-angle flatten loss. verts [B,V,3]; flatten_idx [E,4]
    (v0, v1, v2, v3) -> [B] (mean with average)."""
    v0, v1, v2, v3 = (verts[:, flatten_idx[:, i]] for i in range(4))

    def perp(a, b):
        a_l2 = (a ** 2).sum(-1)
        b_l2 = (b ** 2).sum(-1)
        a_l1 = torch.sqrt(a_l2 + eps)
        b_l1 = torch.sqrt(b_l2 + eps)
        ab = (a * b).sum(-1)
        cos = ab / (a_l1 * b_l1 + eps)
        sin = torch.sqrt(1 - cos ** 2 + eps)
        c = a * (ab / (a_l2 + eps))[..., None]
        return b - c, b_l1 * sin

    cb1, cb1l1 = perp(v1 - v0, v2 - v0)
    cb2, cb2l1 = perp(v1 - v0, v3 - v0)
    cos = (cb1 * cb2).sum(-1) / (cb1l1 * cb2l1 + eps)
    out = ((cos + 1) ** 2).sum(1)
    return out.mean() if average else out


def tex_cycle_loss(flow, p2f, face_ids):
    """Texture cycle consistency. flow [B,F,T,T,2]; p2f [B,F,2] (the
    renderer's expected image coordinate per face, detached); face_ids
    [B,P] the hard render's visible face per pixel, -1 for background.
    The visibility mask is set at every id by negative indexing, so -1
    marks the LAST face, as in the reference's torch indexing (scatter_
    would raise on -1). Returns (loss, avg_flow[0, :10])."""
    B, F = flow.shape[:2]
    avg_flow = flow.reshape(B, F, -1, 2).mean(dim=2)
    mask = flow.new_zeros((B, F))
    rows = torch.arange(B, device=flow.device)[:, None]
    mask[rows, face_ids.long()] = 1.0
    mask = mask[..., None]
    return ((avg_flow * mask - p2f * mask) ** 2).mean(), avg_flow[0, 0:10]


def chamfer_dist(a, b):
    """Pairwise chamfer. a [B,N,D], b [B,M,D] -> (min_a2b [B,N],
    min_b2a [B,M], argmin_a2b, argmin_b2a)."""
    aa = (a ** 2).sum(2)
    bb = (b ** 2).sum(2)
    ab = torch.einsum("bnd,bmd->bnm", a, b)
    P = aa[:, :, None] + bb[:, None, :] - 2 * ab
    return (P.min(dim=2).values, P.min(dim=1).values,
            P.argmin(dim=2).to(torch.int32), P.argmin(dim=1).to(torch.int32))


def bce_with_logits(logits, labels):
    """Binary cross-entropy with logits, mean reduction."""
    return torch.mean(torch.clamp_min(logits, 0) - logits * labels
                      + torch.log1p(torch.exp(-logits.abs())))


def get_centers(part_maps, epsilon=1e-3):
    """[C,H,W] part maps -> [C,2] soft centroids (x, y) in [-1, 1]."""
    return batch_get_centers(part_maps[None], epsilon)[0]


def batch_get_centers(pred_softmax, epsilon=1e-3):
    """[B,C,H,W] -> [B,C,2]."""
    H, W = pred_softmax.shape[-2:]
    dev, dt = pred_softmax.device, pred_softmax.dtype
    x_map = (2.0 * torch.arange(W, device=dev, dtype=dt) / W - 1.0)
    y_map = (2.0 * torch.arange(H, device=dev, dtype=dt) / H - 1.0)
    pm = pred_softmax + epsilon
    pdf = pm / pm.sum(dim=(2, 3), keepdim=True)
    x_c = (pdf * x_map[None, None, None, :]).sum(dim=(2, 3))
    y_c = (pdf * y_map[None, None, :, None]).sum(dim=(2, 3))
    return torch.stack([x_c, y_c], dim=2)
