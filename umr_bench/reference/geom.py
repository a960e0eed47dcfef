"""Quaternions, the weak-perspective projection, bilinear sampling and the
losses of both stages' objectives, in plain PyTorch: a frozen copy of the
program's ops/quaternion.py, ops/projection.py, ops/grid_sample.py,
losses/losses.py and the part matching of losses/composite.py (NVlabs
UMR's loss_utils.py, the SoftRas losses and the SCOPS centroid ops).
Cameras are [scale, tx, ty, qw, qx, qy, qz]; images are channel-last.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


# ---- quaternions and projection ----------------------------------------

def hamilton_product(qa, qb):
    w1, x1, y1, z1 = qa.unbind(-1)
    w2, x2, y2, z2 = qb.unbind(-1)
    return torch.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2], dim=-1)


def quat_rotate(X, q):
    """Points X [B, N, 3] rotated by unit quaternions q [B, 4]."""
    q = q[:, None, :]
    conj = torch.cat([q[..., :1], -q[..., 1:4]], dim=-1)
    Xq = torch.cat([torch.zeros_like(X[..., :1]), X], dim=-1)
    return hamilton_product(q, hamilton_product(Xq, conj))[..., 1:4]


def rotate_cam(cam, angles_deg):
    """Rotate the cameras' quaternions about +y by angles_deg [B]."""
    angles = torch.deg2rad(angles_deg.to(cam.dtype))
    half = angles / 2.0
    axis = cam.new_tensor((0.0, 1.0, 0.0))
    q_rot = torch.cat([torch.cos(half)[..., None],
                       axis * torch.sin(half)[..., None]], dim=-1)
    return torch.cat([cam[:, :3], hamilton_product(q_rot, cam[:, 3:7])],
                     dim=-1)


def orthographic_proj_withz(X, cam, offset_z=0.0):
    proj = cam[:, 0][:, None, None] * quat_rotate(X, cam[:, 3:7])
    return torch.cat([proj[:, :, :2] + cam[:, 1:3][:, None, :],
                      proj[:, :, 2:3] + offset_z], dim=2)


def grid_sample(image, grid):
    """image [B, H, W, C]; grid [B, ..., 2] (x, y) in [-1, 1], corners
    aligned, zero padding -> [B, ..., C]."""
    B, C = image.shape[0], image.shape[-1]
    g = grid.reshape(B, 1, -1, 2)
    out = F.grid_sample(image.permute(0, 3, 1, 2), g, mode="bilinear",
                        padding_mode="zeros", align_corners=True)
    return out[:, :, 0].transpose(1, 2).reshape(grid.shape[:-1] + (C,))


# ---- losses --------------------------------------------------------------

def neg_iou_loss(predict, target, avg=True):
    dims = tuple(range(1, predict.ndim))
    intersect = (predict * target).sum(dims)
    union = (predict + target - predict * target).sum(dims) + 1e-6
    iou = intersect / union
    return 1.0 - iou.mean() if avg else 1.0 - iou


def texture_dt_loss(texture_flow, dist_transf):
    B = texture_flow.shape[0]
    return grid_sample(dist_transf, texture_flow.reshape(B, -1, 2)).mean()


def deform_l2reg(V):
    return torch.linalg.norm(V.reshape(-1, V.shape[-1]), dim=1).mean()


def sym_reg(verts):
    return verts[:, :, 1].abs().mean()


def cam_diversity_loss(cam_probs):
    return (-(torch.log(cam_probs + 1e-9) * cam_probs).sum(1)).mean()


def laplacian_loss(verts, laplacian):
    x = torch.einsum("vw,bwc->bvc", laplacian, verts)
    return (x ** 2).sum(dim=(1, 2))


def flatten_loss(verts, flatten_idx, eps=1e-6):
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
    return ((cos + 1) ** 2).sum(1)


def tex_cycle_loss(flow, p2f, face_ids):
    """flow [B,F,T,T,2]; p2f [B,F,2]; face_ids [B,P], -1 for background,
    which marks the last face (torch's negative indexing)."""
    B, F_ = flow.shape[:2]
    avg_flow = flow.reshape(B, F_, -1, 2).mean(dim=2)
    mask = flow.new_zeros((B, F_))
    rows = torch.arange(B, device=flow.device)[:, None]
    mask[rows, face_ids.long()] = 1.0
    mask = mask[..., None]
    return ((avg_flow * mask - p2f * mask) ** 2).mean()


def chamfer_min(a, b):
    """min over b of the squared distance, for each point of a."""
    aa = (a ** 2).sum(2)
    bb = (b ** 2).sum(2)
    ab = torch.einsum("bnd,bmd->bnm", a, b)
    return (aa[:, :, None] + bb[:, None, :] - 2 * ab).min(dim=2).values


def bce_with_logits(logits, labels):
    return torch.mean(torch.clamp_min(logits, 0) - logits * labels
                      + torch.log1p(torch.exp(-logits.abs())))


def batch_get_centers(pred_softmax, epsilon=1e-3):
    H, W = pred_softmax.shape[-2:]
    dev, dt = pred_softmax.device, pred_softmax.dtype
    x_map = 2.0 * torch.arange(W, device=dev, dtype=dt) / W - 1.0
    y_map = 2.0 * torch.arange(H, device=dev, dtype=dt) / H - 1.0
    pm = pred_softmax + epsilon
    pdf = pm / pm.sum(dim=(2, 3), keepdim=True)
    x_c = (pdf * x_map[None, None, None, :]).sum(dim=(2, 3))
    y_c = (pdf * y_map[None, None, :, None]).sum(dim=(2, 3))
    return torch.stack([x_c, y_c], dim=2)


def corr_loss_chamfer(project, part_vert_idx, part_points, verts, cams,
                      weights=(1.0, 1.0, 0.0, 0.0)):
    """Per-sample part-correspondence chamfer [B]: each part's template
    vertices projected and matched to its sampled 2D points."""
    idx_all = torch.as_tensor(np.concatenate(part_vert_idx),
                              device=verts.device)
    vert2d = project(verts[:, idx_all], cams)
    dists, off = [], 0
    for idx, pts, w in zip(part_vert_idx, part_points, weights):
        n = len(idx)
        if n == 0:
            continue
        dists.append(chamfer_min(vert2d[:, off:off + n], pts) * w)
        off += n
    return torch.cat(dists, dim=1).mean(dim=1)


def gan_loss(disc, real, fake):
    """BCE of the discriminator (behind its gradient reversal) on real
    and fake channel-last images."""
    pred = torch.cat([real, fake], dim=0)
    labels = torch.cat([real.new_ones(real.shape[0]),
                        real.new_zeros(fake.shape[0])])
    return bce_with_logits(disc(pred).squeeze(-1), labels)


def part_textures(semantic_seg, uv_sampler, num_sym_faces, num_parts, device):
    """The UV label map sampled at every texel, rounded, one-hot: [F, T2,
    num_parts] (labels 1..num_parts; 0 is no part)."""
    seg = torch.as_tensor(np.asarray(semantic_seg, np.float32),
                          device=device)[None, :, :, None]
    sampler = torch.as_tensor(np.asarray(uv_sampler, np.float32),
                              device=device)
    Ft, T = sampler.shape[:2]
    tex = grid_sample(seg, sampler.reshape(1, Ft * T * T, 2)).reshape(
        1, Ft, T * T)
    tex = torch.cat([tex, tex[:, -num_sym_faces:]], dim=1)[0]
    one_hot = F.one_hot(torch.round(tex).long(), num_parts + 1).float()
    return one_hot[..., 1:]


def part_groups(part_tex, B):
    """The part textures in 3-channel groups, the last zero-padded."""
    num_parts = part_tex.shape[-1]
    tex_all = part_tex[None].expand((B,) + part_tex.shape)
    groups = []
    for c0 in range(0, num_parts, 3):
        sub = tex_all[..., c0:c0 + 3]
        pad = 3 - sub.shape[-1]
        if pad:
            sub = torch.cat([sub, sub.new_zeros(sub.shape[:-1] + (pad,))], -1)
        groups.append(sub)
    return groups


def part_matching_loss(projs, part_segs, weights=(0.0, 5.0, 0.0, 0.0, 5.0),
                       bg_value=0.1):
    """Rendered part maps [B,P,H,W] against the normalised part maps
    [B,P+1,H,W]."""
    B, P, S = projs.shape[0], projs.shape[1], projs.shape[-1]
    proj = torch.cat([projs.new_full((B, 1, S, S), bg_value), projs], dim=1)
    centers_proj = batch_get_centers(torch.softmax(proj, dim=1)[:, 1:])
    centers_parts = batch_get_centers(torch.softmax(part_segs, dim=1)[:, 1:])
    w = proj.new_tensor(weights).reshape(1, -1, 1, 1)
    max_proj = proj.reshape(B, P + 1, -1).amax(dim=2).clamp_min(1e-5)
    max_part = part_segs.reshape(B, P + 1, -1).amax(dim=2).clamp_min(1e-5)
    loss_eqv = (((proj / max_proj[:, :, None, None]
                  - part_segs / max_part[:, :, None, None]) ** 2) * w).mean()
    loss_lmeqv = ((centers_proj - centers_parts) ** 2).mean()
    return (loss_eqv + loss_lmeqv) / 4.0


def normalize_part_segs(part_prob, masks):
    p = part_prob.permute(0, 3, 1, 2) * masks[:, None]
    return p / p.amax(dim=(2, 3), keepdim=True).clamp_min(1e-12)
