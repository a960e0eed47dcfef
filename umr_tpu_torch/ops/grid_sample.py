"""Bilinear grid sampling in the JAX package's channel-last layout
(port of umr_tpu/ops/grid_sample.py): align_corners=True, zero padding.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def grid_sample(image, grid):
    """image: [B, H, W, C]; grid: [B, ..., 2] with (x, y) in [-1, 1]
    -> [B, ..., C]. Out-of-range taps contribute zeros."""
    B, C = image.shape[0], image.shape[-1]
    g = grid.reshape(B, 1, -1, 2)
    out = F.grid_sample(image.permute(0, 3, 1, 2), g, mode="bilinear",
                        padding_mode="zeros", align_corners=True)
    return out[:, :, 0].transpose(1, 2).reshape(grid.shape[:-1] + (C,))


def sample_textures(texture_flow, images):
    """texture_flow: [B, F, T, T, 2]; images: [B, H, W, C]
    -> [B, F, T, T, C]."""
    return grid_sample(images, texture_flow)


def identity_grid(H, W, align_corners=True, dtype=torch.float32,
                  device=None):
    """The identity affine grid: [H, W, 2] with (x, y) in [-1, 1]
    (linspace(-1, 1, size) under align_corners)."""
    if align_corners:
        ys = torch.linspace(-1.0, 1.0, H, dtype=dtype, device=device)
        xs = torch.linspace(-1.0, 1.0, W, dtype=dtype, device=device)
    else:
        ys = (torch.arange(H, dtype=dtype, device=device) * 2 + 1 - H) / H
        xs = (torch.arange(W, dtype=dtype, device=device) * 2 + 1 - W) / W
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx, gy], dim=-1)
