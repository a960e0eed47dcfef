"""Face -> tile binning for the rasterizer kernel, in plain torch on the
device (port of umr_tpu/ops/rasterize_binned.py::_face_tile_cover and
umr_tpu/ops/raster_kernel.py::compute_raster_bins/_compute_bins).

The layout is the JAX package's, entry for entry: per image, the face ids
of tile 0, then tile 1, ... in ascending face order; each tile's range
starts at a multiple of GROUP and is padded with the dummy id F; a tile
keeps at most mf_cap faces and the whole array at most E_al entries
(entry_cap), the highest tiles losing theirs first. The kernel walks this
layout, so it renders exactly what the JAX kernel renders even when a tile
overflows its cap.

compute_raster_bins runs inside the span "raster.bins" (tracing.py): its
host time, and the device time of what it launches in a trace. The name
has no step prefix ("s2.", "s1."), so a split of a trace by the step's
ranges still counts the binning to the render pass around it.
"""

from __future__ import annotations

import torch

from ..tracing import span
from .rasterize import threshold_of

GROUP = 8


def entry_dims(F, n_tiles, max_cover, mf_cap, entry_cap=None):
    """(E_al, E_pad): the entry array's length and its padded length."""
    E_al = F * max_cover * max_cover + GROUP * n_tiles
    if entry_cap is None:
        entry_cap = 8 * F
    E_al = min(E_al, ((int(entry_cap) + GROUP - 1) // GROUP) * GROUP)
    return E_al, E_al + mf_cap


def face_tile_cover(face_x, face_y, S, ts, margin, max_cover):
    """Tiles covered by each face's margin-expanded bbox.

    face_x, face_y: [B, F, 3] NDC coords. Returns (tile [B,F,C,C] int64
    ids, ok [B,F,C,C] cover mask)."""
    TX = S // ts
    col_min = (face_x.amin(-1) - margin) * S / 2 + (S - 1) / 2
    col_max = (face_x.amax(-1) + margin) * S / 2 + (S - 1) / 2
    row_min = ((S - 1) - (face_y.amax(-1) + margin) * S) / 2
    row_max = ((S - 1) - (face_y.amin(-1) - margin) * S) / 2

    def tile_of(v):
        return torch.floor(v / ts).clamp(0, TX - 1).to(torch.int64)

    tx0, tx1 = tile_of(col_min), tile_of(col_max)
    ty0, ty1 = tile_of(row_min), tile_of(row_max)
    offscreen = ((col_max < 0) | (col_min > S - 1)
                 | (row_max < 0) | (row_min > S - 1))
    d = torch.arange(max_cover, device=face_x.device)
    txs = tx0[..., None] + d                                   # [B,F,C]
    tys = ty0[..., None] + d
    ok_x = (txs <= tx1[..., None]) & (txs < TX)
    ok_y = (tys <= ty1[..., None]) & (tys < TX)
    tile = tys[..., :, None] * TX + txs[..., None, :]          # [B,F,C,C]
    ok = (ok_y[..., :, None] & ok_x[..., None, :]
          & ~offscreen[..., None, None])
    return tile, ok


@torch.no_grad()
def compute_raster_bins(face_vertices, image_size, tile_size, sigma_val,
                        dist_eps, mf_cap, max_cover, entry_cap=None):
    """face_vertices [B, F, 3, 3] -> (al_fids [B, E_al] int32,
    astarts [B, n_tiles + 1] int32)."""
    with span("raster.bins"):
        return _bins(face_vertices, image_size, tile_size, sigma_val,
                     dist_eps, mf_cap, max_cover, entry_cap)


def _bins(face_vertices, image_size, tile_size, sigma_val, dist_eps, mf_cap,
          max_cover, entry_cap):
    B, F = face_vertices.shape[:2]
    S, ts = int(image_size), int(tile_size)
    n_tiles = (S // ts) ** 2
    E_al, _ = entry_dims(F, n_tiles, max_cover, mf_cap, entry_cap)
    _, margin = threshold_of(sigma_val, dist_eps)
    dev = face_vertices.device

    tile, ok = face_tile_cover(face_vertices[..., 0], face_vertices[..., 1],
                               S, ts, margin, max_cover)
    C2 = max_cover * max_cover
    tile = tile.reshape(B, F, C2)
    ok = ok.reshape(B, F, C2)
    tile_d = torch.where(ok, tile, n_tiles)          # n_tiles: no tile

    # a face covers a tile at most once, so its rank among the tile's
    # faces is the count of earlier faces covering it: an inclusive
    # cumsum over faces of the dense [F, T] cover matrix
    cov = torch.zeros((B, F, n_tiles + 1), dtype=torch.int32, device=dev)
    cov.scatter_(2, tile_d, 1)
    inc = torch.cumsum(cov[..., :n_tiles], dim=1, dtype=torch.int32)
    counts = inc[:, -1].clamp(max=mf_cap)                      # [B,T]
    padded = (counts + GROUP - 1) // GROUP * GROUP
    ends = torch.cumsum(padded, dim=1).clamp(max=E_al).to(torch.int32)
    astarts = torch.cat(
        [torch.zeros((B, 1), dtype=torch.int32, device=dev), ends], dim=1)
    allowed = torch.minimum(counts, ends - astarts[:, :-1])

    tile_c = tile.clamp(0, n_tiles - 1)
    rank = torch.gather(inc, 2, tile_c) - 1                    # [B,F,C2]
    allowed_g = torch.gather(allowed, 1, tile_c.reshape(B, -1)).reshape(
        B, F, C2)
    astart_g = torch.gather(astarts[:, :-1], 1,
                            tile_c.reshape(B, -1)).reshape(B, F, C2)
    entry_ok = ok & (rank < allowed_g)
    position = torch.where(entry_ok, astart_g + rank, E_al).to(torch.int64)

    fids = torch.arange(F, dtype=torch.int32, device=dev)
    al_fids = torch.full((B, E_al + 1), F, dtype=torch.int32, device=dev)
    al_fids.scatter_(1, position.reshape(B, -1),
                     fids[None, :, None].expand(B, F, C2).reshape(B, -1))
    return al_fids[:, :E_al].contiguous(), astarts
