"""The least time an H100 could take for a rasterizer kernel's work on a
run's own data: the larger of the bytes it must move over the memory
rate and the operations its pairs need over the fp32 rate.

The operations are counted from the kernels' source, per branch (one per
add, subtract, multiply, divide, compare, min, max, select, floor,
conversion, exponential or atomic add; address arithmetic, the per-pixel
set-up and write-out, the forward's rescale of its running softmax sums
and the warp reductions left out), and charged only to the (pixel, binned
face) pairs that reach the branch on this run's data, found with the plain
version's pair arithmetic (pair_counts). Used by chip_smoke.py and
raster_bench.py.
"""

from __future__ import annotations

import torch

from ..ops.raster_kernel import TILE_SIZE, fwd_block_hits
from ..ops.rasterize import _face_info, pair_math, threshold_of

# H100 SXM datasheet peaks. 67 TFLOP/s counts a fused multiply-add as two
# operations; the kernels are built with --fmad=false, so their fp32
# issue ceiling is about half of it
PEAK_FLOPS = 67e12     # fp32, outside the tensor cores
PEAK_BYTES = 3.35e12   # HBM3
OPS_BOX = 4        # the bbox test (raster_common.cuh:120): the function
                   # needs it only on the pairs in a face's bbox (the
                   # backward walks each face's pixel rectangle, the
                   # forward each pixel's mask of bbox hits), so both
                   # charge it there, not on every binned slot
OPS_DIST = 134     # in the bbox: barycentrics 12, three edges' foot points
                   # 99, inside test 6, nearest edge 13, squared distance
                   # and threshold test 4 (:123-186)
OPS_FRAG = 26      # past the threshold: sign and sigmoid 7, clipped
                   # barycentrics and depth 19 (:187-213)
OPS_TEXEL = 18     # the texel index (:214-220) where the pass reads texels
OPS_FOOT = 15      # backward: the foot point's weights (:192-201)
OPS_FWD_PASS = 4   # forward, past the threshold: alpha 2, depth test 2
                   # (raster_fwd.cu:277-278)
OPS_FWD_Z = 14     # forward, depth in [near, far]: softmax weight and sum
                   # 8, colour sums 6 (raster_fwd.cu:289-301, 309-314)
OPS_FWD_HARD = 12  # forward hard body, past the threshold: the [0, 1]
                   # barycentric test 11 (raster_common.cuh:221-222) and
                   # the running z-min compare 1 (raster_fwd.cu:280)
OPS_BWD_PASS = 2   # backward, past the threshold: depth gate
OPS_BWD_Z = 30     # backward, depth in range: alpha term and the x, y
                   # chain (raster_bwd.cu:268, 294-300)
OPS_BWD_SOFT = 6   # its softmax weight, where texels or depths get grads
                   # (:271-273)
OPS_BWD_TEX = 7    # its texel lanes (:275, 124-126, 147-149; the sums
                   # over lanes that share a texel left out)
OPS_BWD_ZLANE = 26  # its colour term and z lanes (:278-291)
OPS_P2F = 5        # forward with p2f, depth in range: contrib * gx and
                   # * gy with their sums, the weight sum (raster_fwd.cu:
                   # 302-308; the per-face warp reductions left out)


def _kept_entries(fv, bins, S, cap):
    """The (face, tile) entries of one render that the kernels walk (the
    first `cap` of each tile, padding skipped): (faces [N, 3, 3], tiles
    [N])."""
    al_fids, astarts = bins
    B, F = fv.shape[:2]
    T = (S // TILE_SIZE) ** 2
    n = torch.diff(astarts.long(), dim=1).clamp(max=cap)          # [B,T]
    pos = torch.arange(al_fids.shape[1], device=fv.device)
    tile = torch.searchsorted(astarts[:, 1:].long().contiguous(),
                              pos[None].expand(B, -1).contiguous(),
                              right=True)
    tc = tile.clamp(max=T - 1)
    keep = ((al_fids < F) & (tile < T)
            & (pos[None] - astarts.long().gather(1, tc) < n.gather(1, tc)))
    bi, ei = torch.nonzero(keep, as_tuple=True)
    return fv[bi, al_fids[bi, ei].long()], tile[bi, ei]


def pair_counts(fv, bins, S, cap, sigma_val, dist_eps, chunk=1 << 14):
    """Of one render's binned (pixel, face) slots, how many reach each
    branch of the kernels' per-pair code on this run's data, found with
    the plain version's pair arithmetic: (slots of kept faces, pairs in
    the face's margin-expanded bbox, pairs past the distance threshold,
    and of those the pairs with depth in [near, far])."""
    TX = S // TILE_SIZE
    faces, tiles = _kept_entries(fv, bins, S, cap)
    thr, margin = threshold_of(sigma_val, dist_eps)
    lane = torch.arange(TILE_SIZE * TILE_SIZE, device=fv.device)
    counts = torch.zeros(4, dtype=torch.float64, device=fv.device)
    for c0 in range(0, faces.shape[0], chunk):
        f = faces[c0:c0 + chunk][None]                            # [1,E,3,3]
        t = tiles[c0:c0 + chunk, None]
        ch = _face_info(f[..., 0], f[..., 1], f[..., 2])
        ch["ok"] = ch.pop("nondegen")
        col = (t % TX) * TILE_SIZE + lane % TILE_SIZE
        row = (t // TX) * TILE_SIZE + lane // TILE_SIZE
        xp = ((2.0 * col + 1.0 - S) / S)[None]
        yp = ((2.0 * (S - 1 - row) + 1.0 - S) / S)[None]
        maxx, minx, maxy, miny = ch["bbox"]
        box = ~((xp > maxx + margin) | (xp < minx - margin)
                | (yp > maxy + margin) | (yp < miny - margin)) & ch["ok"]
        pm = pair_math(ch, xp, yp, thr, margin, 1.0 / sigma_val)
        counts += torch.stack([ch["ok"].sum() * lane.numel(), box.sum(),
                               pm["valid"].sum(),
                               (pm["valid"] & pm["z_ok"]).sum()]).double()
    return [int(c) for c in counts.tolist()]


def block_steps(fv, bins, S, cap, sigma_val, dist_eps):
    """How many (face entry, 8x4 pixel block) pairs the forward kernel's
    walk runs the pair arithmetic in on one render: the blocks each kept,
    non-degenerate face's bbox reaches (raster_kernel.fwd_block_hits).
    Each such step occupies a warp's 32 lanes, so pairs in a bbox over
    32 x this is the share of the lanes doing useful work."""
    faces, tiles = _kept_entries(fv, bins, S, cap)
    _, margin = threshold_of(sigma_val, dist_eps)
    f = faces[None]
    ch = _face_info(f[..., 0], f[..., 1], f[..., 2])
    maxx, minx, maxy, miny = (v[0, :, 0] for v in ch["bbox"])
    box = torch.stack([maxx + margin, minx - margin, maxy + margin,
                       miny - margin], -1)
    hits = fwd_block_hits(box, S, tiles) & ch["nondegen"][0, :, 0, None,
                                                          None]
    return int(hits.sum())


def bound(ops, nbytes):
    """(bound ms, what bounds it): the larger of the two rooflines."""
    t_ops, t_bytes = ops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def lanes(opts):
    """(texel lanes, z lanes) the backward computes under opts, as
    umr_raster_bwd decides them."""
    mask_only = opts.get("mask_only", False)
    return (opts.get("tex_grads", True) and not mask_only,
            not (mask_only or opts.get("rgb_geom_detach", False)))


def raster_bound(counts, fv, tex, bins, S, opts=None, p2f=False,
                 hard=False):
    """(bound ms, bound_by) of one forward render (opts None; with p2f,
    the p2f instance's; with hard, the hard body's) or of its backward
    under opts, from its pair_counts."""
    _, box, passed, in_depth = counts
    ops = box * (OPS_BOX + OPS_DIST) + passed * OPS_FRAG
    inputs = 4 * (fv.numel() + tex.numel() + bins[0].numel()
                  + bins[1].numel())
    img = 4 * fv.shape[0] * S * S * (4 + 2)            # rgba, aggr
    if opts is None:
        ops += passed * (OPS_TEXEL + OPS_FWD_PASS)
        if hard:
            ops += passed * OPS_FWD_HARD
        else:
            ops += in_depth * OPS_FWD_Z
        if p2f:
            ops += in_depth * OPS_P2F
            img += 4 * fv.shape[0] * fv.shape[1] * 2   # p2f [B, F, 2]
        return bound(ops, inputs + img)
    want_tex, want_z = lanes(opts)
    rgb = want_tex or want_z
    ops += (passed * (OPS_FOOT + OPS_BWD_PASS + rgb * OPS_TEXEL)
            + in_depth * (OPS_BWD_Z + rgb * OPS_BWD_SOFT
                          + want_tex * OPS_BWD_TEX + want_z * OPS_BWD_ZLANE))
    # reads the forward's outputs and g_rgba, writes the gradients
    return bound(ops, inputs + img + 4 * fv.shape[0] * S * S * 4
                 + 4 * (fv.numel() + tex.numel()))
