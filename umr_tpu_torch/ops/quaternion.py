"""Quaternion ops on torch tensors (port of umr_tpu/ops/quaternion.py),
and its two host numpy helpers for the CUB loader (quat_from_matrix_np,
mirror_quat_np; tests/test_torch_cub.py pins them equal).

Convention: quaternions are (w, x, y, z).
"""

from __future__ import annotations

import math

import numpy as np
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
    [B, 4] (the CUB ranges pi/6, pi/2, pi/3): q_cyc (about z) * q_elev
    (about x) * q_az (about y), the Hamilton products of the three axis
    rotations written out without their zero terms (so the values are
    the products', in a third of the ops, and no constant is copied to
    the angles' device)."""
    ang = torch.tanh(angles)
    half = [(scale * ang[..., i]) / 2.0 for i, scale in
            enumerate((math.pi / 6, math.pi / 2, math.pi / 3))]
    c1, s1 = torch.cos(half[0]), torch.sin(half[0])       # azimuth, y
    c2, s2 = torch.cos(half[1]), torch.sin(half[1])       # elevation, x
    c3, s3 = torch.cos(half[2]), torch.sin(half[2])       # cyclo, z
    w, x, y, z = c2 * c1, s2 * c1, c2 * s1, s2 * s1       # q_elev * q_az
    return torch.stack([c3 * w - s3 * z, c3 * x - s3 * y, c3 * y + s3 * x,
                        c3 * z + s3 * w], dim=-1)


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


def quat_from_matrix_np(R):
    """Rotation matrix (3x3 or 4x4 numpy) -> unit quaternion (w, x, y, z),
    by Shepperd's method (transformations.quaternion_from_matrix with
    isprecise=True, up to sign)."""
    R = np.asarray(R, dtype=np.float64)
    M = R[:3, :3]
    t = np.trace(M)
    if t > 0:
        w = np.sqrt(1.0 + t) / 2.0
        x = (M[2, 1] - M[1, 2]) / (4 * w)
        y = (M[0, 2] - M[2, 0]) / (4 * w)
        z = (M[1, 0] - M[0, 1]) / (4 * w)
    else:
        i = int(np.argmax(np.diag(M)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(max(M[i, i] - M[j, j] - M[k, k] + 1.0, 0.0)) * 2.0
        qi = s / 4.0
        qj = (M[j, i] + M[i, j]) / s
        qk = (M[k, i] + M[i, k]) / s
        w = (M[k, j] - M[j, k]) / s
        xyz = np.zeros(3)
        xyz[i], xyz[j], xyz[k] = qi, qj, qk
        x, y, z = xyz
    q = np.array([w, x, y, z])
    return q / np.linalg.norm(q)


def mirror_quat_np(q):
    """The quaternion of diag(-1,1,1) @ R(q) @ diag(-1,1,1): (w, x, -y, -z)
    (the mirror augmentation's pose flip)."""
    q = np.asarray(q)
    return np.array([q[0], q[1], -q[2], -q[3]])
