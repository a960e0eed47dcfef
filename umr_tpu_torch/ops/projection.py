"""Weak-perspective camera projection (port of umr_tpu/ops/projection.py).

Camera 7-vector: [scale, tx, ty, qw, qx, qy, qz].
"""

from __future__ import annotations

import torch

from .quaternion import quat_rotate


def orthographic_proj_withz(X, cam, offset_z=0.0):
    """X: [B,N,3], cam: [B,7] -> [B,N,3] (scaled xy + translation, scaled
    z + offset_z)."""
    proj = cam[:, 0][:, None, None] * quat_rotate(X, cam[:, 3:7])
    proj_xy = proj[:, :, :2] + cam[:, 1:3][:, None, :]
    proj_z = proj[:, :, 2:3] + offset_z
    return torch.cat([proj_xy, proj_z], dim=2)
