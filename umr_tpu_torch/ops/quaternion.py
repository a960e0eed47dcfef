"""Quaternion ops on torch tensors (port of umr_tpu/ops/quaternion.py).

Convention: quaternions are (w, x, y, z).
"""

from __future__ import annotations

import torch


def hamilton_product(qa, qb):
    """Batched Hamilton product. qa, qb: [..., 4] -> [..., 4]."""
    w1, x1, y1, z1 = qa.unbind(-1)
    w2, x2, y2, z2 = qb.unbind(-1)
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        dim=-1,
    )


def quat_conjugate(q):
    return torch.cat([q[..., :1], -q[..., 1:4]], dim=-1)


def quat_rotate(X, q):
    """Rotate points X [B, N, 3] by unit quaternions q [B, 4] (q X q*)."""
    q = q[:, None, :]
    Xq = torch.cat([torch.zeros_like(X[..., :1]), X], dim=-1)
    Xr = hamilton_product(q, hamilton_product(Xq, quat_conjugate(q)))
    return Xr[..., 1:4]


def axis_angle_to_quat(axis, angle):
    """axis: [..., 3] unit axis; angle: [...] radians -> [..., 4]."""
    half = angle / 2.0
    return torch.cat(
        [torch.cos(half)[..., None], axis * torch.sin(half)[..., None]],
        dim=-1,
    )
