"""Face -> tile binning for the rasterizer kernels (port of
umr_tpu/ops/rasterize_binned.py::_face_tile_cover and
umr_tpu/ops/raster_kernel.py::compute_raster_bins/_compute_bins).

The layout, which both kernels walk: per image, the face ids of tile 0,
then tile 1, ... in ascending face order; each tile's range starts at a
multiple of GROUP and is padded with the dummy id F; astarts [B,
n_tiles + 1] holds the ranges' starts and the end of the last.

full_raster_bins, the main path's, keeps every (face, tile) pair whose
margin-expanded bbox reaches the tile: no cap applies, and the entry
array is sized for the worst case (full_entries: every face in every
tile). On the card the kernels of csrc/raster_bins.cu make it; elsewhere
its plain twin. This is where the port departs from the JAX package,
whose caps drop entries (a face past 4 x 4 tiles, a tile past
resolved_mf_cap faces, an image past 8 F entries) and whose kernel then
renders without them: the main path renders every face a tile reaches,
and the same as the JAX package wherever its caps drop nothing.

compute_raster_bins keeps the JAX package's caps, entry for entry: a
tile keeps at most mf_cap faces, a face at most max_cover tiles per axis,
and the whole array at most E_al entries (entry_cap), the highest tiles
losing theirs first. Where no cap binds, its entries are full_raster_bins'.

Both run inside the span "raster.bins" (tracing.py): its host time, and
the device time of what it launches in a trace. The name has no step
prefix ("s2.", "s1."), so a split of a trace by the step's ranges still
counts the binning to the render pass around it. Inside it they add to
the counters raster.bins_entries (the pairs the bins hold) and
raster.bins_dropped (the pairs a cap left out) on the device, without a
host sync; tracing.totals() reads them. full_raster_bins drops nothing,
so raster.bins_dropped moves only where a capped binning
(compute_raster_bins) runs inside what is counted. LAUNCHES counts the
kernels' binnings.
"""

from __future__ import annotations

import torch

from ..tracing import count, device_counter, span
from .rasterize import threshold_of

GROUP = 8
TILE_SIZE = 32   # the kernels' tile, and the full bins'
# binnings by the kernels of csrc/raster_bins.cu (one each: a count and a
# fill launch); callers may zero it
LAUNCHES = 0


def entry_dims(F, n_tiles, max_cover, mf_cap, entry_cap=None):
    """(E_al, E_pad): the entry array's length and its padded length."""
    E_al = F * max_cover * max_cover + GROUP * n_tiles
    if entry_cap is None:
        entry_cap = 8 * F
    E_al = min(E_al, ((int(entry_cap) + GROUP - 1) // GROUP) * GROUP)
    return E_al, E_al + mf_cap


def full_entries(F, n_tiles):
    """The entries an image's full bins can need: every face in every
    tile, each tile padded to GROUP."""
    return n_tiles * (-(-F // GROUP) * GROUP)


def face_tile_rect(face_x, face_y, S, ts, margin):
    """Each face's margin-expanded bbox in tiles: face_x, face_y [B, F, 3]
    NDC coords -> (tx0, tx1, ty0, ty1) int64 [B, F], the first and last
    tile per axis, clamped to the image, and offscreen [B, F] bool, the
    faces whose bbox misses the image."""
    TX = S // ts
    col_min = (face_x.amin(-1) - margin) * S / 2 + (S - 1) / 2
    col_max = (face_x.amax(-1) + margin) * S / 2 + (S - 1) / 2
    row_min = ((S - 1) - (face_y.amax(-1) + margin) * S) / 2
    row_max = ((S - 1) - (face_y.amin(-1) - margin) * S) / 2

    def tile_of(v):
        return torch.floor(v / ts).clamp(0, TX - 1).to(torch.int64)

    offscreen = ((col_max < 0) | (col_min > S - 1)
                 | (row_max < 0) | (row_min > S - 1))
    return (tile_of(col_min), tile_of(col_max), tile_of(row_min),
            tile_of(row_max), offscreen)


def tile_cover(rect, TX, max_cover):
    """The tiles of each face's rectangle (face_tile_rect), at most
    max_cover per axis: (tile [B,F,C,C] int64 ids, ok [B,F,C,C] cover
    mask)."""
    tx0, tx1, ty0, ty1, offscreen = rect
    d = torch.arange(max_cover, device=tx0.device)
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
    """The JAX package's capped bins: face_vertices [B, F, 3, 3] ->
    (al_fids [B, E_al] int32, astarts [B, n_tiles + 1] int32)."""
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

    rect = face_tile_rect(face_vertices[..., 0], face_vertices[..., 1], S,
                          ts, margin)
    tile, ok = tile_cover(rect, S // ts, max_cover)
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
    tx0, tx1, ty0, ty1, offscreen = rect
    reached = torch.where(offscreen, 0, (tx1 - tx0 + 1) * (ty1 - ty0 + 1))
    kept = entry_ok.sum()
    device_counter("raster.bins_entries", dev).add_(kept)
    device_counter("raster.bins_dropped", dev).add_(reached.sum() - kept)
    position = torch.where(entry_ok, astart_g + rank, E_al).to(torch.int64)

    fids = torch.arange(F, dtype=torch.int32, device=dev)
    al_fids = torch.full((B, E_al + 1), F, dtype=torch.int32, device=dev)
    al_fids.scatter_(1, position.reshape(B, -1),
                     fids[None, :, None].expand(B, F, C2).reshape(B, -1))
    return al_fids[:, :E_al].contiguous(), astarts


@torch.no_grad()
def full_raster_bins(face_vertices, image_size, sigma_val, dist_eps):
    """The main path's bins, every (face, tile) pair whose margin-expanded
    bbox reaches the tile, at 32x32 tiles: face_vertices [B, F, 3, 3]
    float32 -> (al_fids [B, full_entries(F, n_tiles)] int32, astarts [B,
    n_tiles + 1] int32). Entries past astarts[:, -1] are unspecified (the
    dummy id F off the card). A tile holds at most round_up(F, GROUP)
    entries."""
    with span("raster.bins"):
        count("raster.bins_dropped", 0)     # no cap: nothing is dropped
        if face_vertices.is_cuda:
            return _full_bins_kernel(face_vertices.contiguous(),
                                     int(image_size), sigma_val, dist_eps)
        return _full_bins_plain(face_vertices, int(image_size), sigma_val,
                                dist_eps)


def _full_bins_kernel(fv, S, sigma_val, dist_eps):
    from .raster_kernel import build

    B, F = fv.shape[:2]
    if fv.dtype != torch.float32:
        raise TypeError(f"face_vertices is {fv.dtype}, the kernel takes "
                        "torch.float32")
    n_tiles = (S // TILE_SIZE) ** 2
    E = full_entries(F, n_tiles)
    dev = fv.device
    _, margin = threshold_of(sigma_val, dist_eps)
    rect = torch.empty((B, F), dtype=torch.int32, device=dev)
    counts = torch.zeros((B, n_tiles), dtype=torch.int32, device=dev)
    al_fids = torch.empty((B, E), dtype=torch.int32, device=dev)
    astarts = torch.empty((B, n_tiles + 1), dtype=torch.int32, device=dev)
    entries = device_counter("raster.bins_entries", dev)
    lib = build()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.umr_raster_bins(
            fv.data_ptr(), rect.data_ptr(), counts.data_ptr(),
            al_fids.data_ptr(), astarts.data_ptr(), B, F, S, E, margin,
            entries.data_ptr(), stream)
    if err:
        raise RuntimeError("raster_bins launch failed: "
                           + lib.umr_cuda_error_string(err).decode())
    global LAUNCHES
    LAUNCHES += 1
    return al_fids, astarts


def _full_bins_plain(fv, S, sigma_val, dist_eps):
    """full_raster_bins in plain torch (the kernels' twin): the dense
    [B, F, n_tiles] cover, its cumsum over faces for each entry's rank."""
    B, F = fv.shape[:2]
    TX = S // TILE_SIZE
    n_tiles = TX * TX
    dev = fv.device
    _, margin = threshold_of(sigma_val, dist_eps)
    fx, fy = fv[..., 0], fv[..., 1]
    tx0, tx1, ty0, ty1, offscreen = face_tile_rect(fx, fy, S, TILE_SIZE, margin)
    # a face with a non-finite coordinate covers no tile (as the kernel)
    empty = offscreen | ~(fx.isfinite() & fy.isfinite()).all(-1)
    t = torch.arange(n_tiles, device=dev)
    tx, ty = t % TX, t // TX
    cov = ((tx0[..., None] <= tx) & (tx <= tx1[..., None])
           & (ty0[..., None] <= ty) & (ty <= ty1[..., None])
           & ~empty[..., None])                                  # [B,F,T]
    rank = torch.cumsum(cov, dim=1, dtype=torch.int64) - 1
    counts = rank[:, -1] + 1                                     # [B,T]
    padded = (counts + GROUP - 1) // GROUP * GROUP
    astarts = torch.cat([torch.zeros((B, 1), dtype=torch.int64, device=dev),
                         torch.cumsum(padded, dim=1)], dim=1)
    E = full_entries(F, n_tiles)
    position = torch.where(cov, astarts[:, None, :-1] + rank, E)
    al_fids = torch.full((B, E + 1), F, dtype=torch.int32, device=dev)
    fids = torch.arange(F, dtype=torch.int32, device=dev)
    al_fids.scatter_(1, position.reshape(B, -1),
                     fids[None, :, None].expand(B, F, n_tiles).reshape(B, -1))
    device_counter("raster.bins_entries", dev).add_(counts.sum())
    return al_fids[:, :E].contiguous(), astarts.to(torch.int32)
