"""Mesh voxelization in plain torch, on the input's device (port of
umr_tpu/ops/voxelize.py, itself jnp with no Pallas kernel; the reference
exposes it as SoftRas's Mesh.voxelize). No path of UMR calls it.

voxelize_surface marks the voxels whose centres lie within 0.87 of a
voxel (about sqrt(3)/2) of a face's plane and project inside the face
(barycentrics >= -1e-6). The faces go in chunks, so that the per-voxel
tests, [batch, chunk, R^3] at a time, stay within CHUNK_ELEMENTS.
fill_interior floods the exterior from the grid's border by six-neighbour
dilations (torch.roll, which wraps around as jnp.roll does) until nothing
changes, batched, and returns everything the flood did not reach.

Every product, sum and root is an operation of its own, in one order, so
the card and the CPU compute the same occupancy (torch's elementwise
kernels round each operation as the CPU does; no reduction runs).
"""

from __future__ import annotations

import torch

CHUNK_ELEMENTS = 1 << 22      # batch x faces x voxels per chunk


def _dot(a, b):
    """Sum over the last axis of a * b, x + y + z in that order."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _cross(a, b):
    """a x b over the last axis, each product and difference its own
    operation (no fused multiply-add on either device)."""
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def voxelize_surface(face_vertices, resolution=32):
    """face_vertices [B,F,3,3], coordinates in [0,1] -> occupancy
    [B,R,R,R] bool of the voxels the faces' surface passes through."""
    B, F = face_vertices.shape[:2]
    R = int(resolution)
    fv = face_vertices.float() * (R - 1)
    centers = torch.arange(R, device=fv.device, dtype=torch.float32)
    grid = torch.stack(torch.meshgrid(centers, centers, centers,
                                      indexing="ij"), -1).reshape(-1, 3)
    occ = torch.zeros((B, R ** 3), dtype=torch.bool, device=fv.device)
    chunk = max(1, CHUNK_ELEMENTS // (B * R ** 3))
    for f0 in range(0, F, chunk):
        tri = fv[:, f0:f0 + chunk, :, None, :]      # [B,C,3,1,3]
        t0, e1, e2 = tri[:, :, 0], tri[:, :, 1] - tri[:, :, 0], \
            tri[:, :, 2] - tri[:, :, 0]             # [B,C,1,3]
        n = _cross(e1, e2)
        nn = n / torch.sqrt(_dot(n, n)).clamp_min(1e-9)[..., None]
        rel = grid - t0                             # [B,C,R^3,3]
        d = _dot(rel, nn)                           # plane distance
        p = grid - d[..., None] * nn
        g00, g01, g11 = _dot(e1, e1), _dot(e1, e2), _dot(e2, e2)
        g10 = _dot(e2, e1)
        rel = p - t0
        r0, r1 = _dot(rel, e1), _dot(rel, e2)
        det = g00 * g11 - g01 * g10
        u = (r0 * g11 - r1 * g01) / det
        v = (r1 * g00 - r0 * g10) / det
        hit = ((u >= -1e-6) & (v >= -1e-6) & (u + v <= 1 + 1e-6)
               & (d.abs() <= 0.87))
        occ |= hit.any(dim=1)
    return occ.reshape(B, R, R, R)


def fill_interior(occupancy):
    """Everything the exterior flood from the grid's border does not
    reach, [B,R,R,R] bool."""
    surface = occupancy.bool()
    border = torch.zeros_like(surface)
    for axis in (1, 2, 3):
        border.select(axis, 0).fill_(True)
        border.select(axis, -1).fill_(True)
    free = ~surface
    ext = border & free
    while True:
        grown = ext.clone()
        for axis in (1, 2, 3):
            grown |= ext.roll(1, axis) | ext.roll(-1, axis)
        grown &= free
        if torch.equal(grown, ext):
            return ~ext
        ext = grown


def voxelize(face_vertices, resolution=32, fill=True):
    """Solid (or, with fill=False, surface) voxelization [B,R,R,R] bool
    of meshes with vertices in [0,1] (scaled to [0, R-1], the reference's
    Mesh.voxelize convention)."""
    occ = voxelize_surface(face_vertices, resolution)
    return fill_interior(occ) if fill else occ
