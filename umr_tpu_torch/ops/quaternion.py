"""Quaternion ops on torch tensors (port of umr_tpu/ops/quaternion.py).

Convention: quaternions are (w, x, y, z).
"""

from __future__ import annotations

import math

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


def ang2quat(angles):
    """Tanh-squashed (azimuth, elev, cyc) angles [B, 3] -> quaternions
    [B, 4] (the CUB ranges pi/6, pi/2, pi/3)."""
    ang = torch.tanh(angles)
    ey, ex, ez = (angles.new_tensor(v) for v in
                  ((0.0, 1.0, 0.0), (1.0, 0.0, 0.0), (0.0, 0.0, 1.0)))
    q_az = axis_angle_to_quat(ey, math.pi / 6 * ang[..., 0])
    q_el = axis_angle_to_quat(ex, math.pi / 2 * ang[..., 1])
    q_cr = axis_angle_to_quat(ez, math.pi / 3 * ang[..., 2])
    return hamilton_product(q_cr, hamilton_product(q_el, q_az))


def rotate_cam(cam, angles_deg, axis=(0.0, 1.0, 0.0)):
    """Rotate the quaternion of weak-perspective cams [B, 7] about `axis`
    by angles_deg [B] degrees: q <- q_axis(angle) * q."""
    angles = torch.deg2rad(torch.as_tensor(angles_deg, dtype=cam.dtype,
                                           device=cam.device))
    axis = cam.new_tensor(axis)
    axis = axis / torch.linalg.norm(axis)
    q_rot = axis_angle_to_quat(axis.expand(angles.shape + (3,)), angles)
    return torch.cat([cam[:, :3], hamilton_product(q_rot, cam[:, 3:7])],
                     dim=-1)
