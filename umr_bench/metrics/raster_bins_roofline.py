"""raster_bins_roofline: the least time of the binning kernels' bytes at
3.35 TB/s over their device time, in percent, both over the traced
steps. The bytes are counted here from the renders that the harness's
RenderRecorder kept over those steps: each forward and backward launch
bins its render's faces (the program gives the kernels no bins of its
own making on the main path), and least_bytes counts, from the faces'
geometry, what full bins of them must move. The device time is that of
the kernels named bins_count_kernel and bins_fill_kernel in the same
steps' trace. Nothing where the program has no such kernels.

The context handed to readers does not carry the recorded renders, so
read() takes the harness's recorder from the frame that calls it."""

import sys

import torch

from umr_bench import workcount
from umr_bench.reference.raster import threshold_of

KERNELS = ("bins_count_kernel", "bins_fill_kernel")
TILE = 32
GROUP = 8


def tile_counts(fv, S, sigma_val, dist_eps):
    """[B, n_tiles] the faces whose margin-expanded bbox reaches each
    32x32 tile: the kernels' rule, each face's bbox in pixels floored to
    tiles and clamped to the image, a bbox wholly off the image or a face
    with a non-finite x or y covering none."""
    S = int(S)
    TX = S // TILE
    _, margin = threshold_of(sigma_val, dist_eps)
    x, y = fv[..., 0].float(), fv[..., 1].float()
    c0 = (x.amin(-1) - margin) * S / 2 + (S - 1) / 2
    c1 = (x.amax(-1) + margin) * S / 2 + (S - 1) / 2
    r0 = ((S - 1) - (y.amax(-1) + margin) * S) / 2
    r1 = ((S - 1) - (y.amin(-1) - margin) * S) / 2
    on = ((c1 >= 0) & (c0 <= S - 1) & (r1 >= 0) & (r0 <= S - 1)
          & torch.isfinite(x).all(-1) & torch.isfinite(y).all(-1))

    def tile(v):
        return torch.floor(v / TILE).clamp(0, TX - 1).long()

    ar = torch.arange(TX, device=fv.device)
    in_x = (ar >= tile(c0)[..., None]) & (ar <= tile(c1)[..., None])
    in_y = (ar >= tile(r0)[..., None]) & (ar <= tile(r1)[..., None])
    in_x &= on[..., None]
    # faces per tile: the product of the per-axis covers, summed over faces
    return torch.einsum("bfy,bfx->byx", in_y.float(),
                        in_x.float()).round().long().reshape(fv.shape[0], -1)


def least_bytes(fv, S, sigma_val, dist_eps):
    """The bytes a binning of one render must move, each once: every
    face's x and y read (24 bytes), the tiles' starts and the image's end
    written (4 bytes each), and the entries written, each tile's padded to
    a multiple of 8 (4 bytes each)."""
    B, F = fv.shape[:2]
    counts = tile_counts(fv, S, sigma_val, dist_eps)
    padded = int(((counts + GROUP - 1) // GROUP * GROUP).sum())
    return B * (24 * F + 4 * (counts.shape[1] + 1)) + 4 * padded


def recorder():
    """The harness's RenderRecorder, from the frames above this call."""
    f = sys._getframe(1)
    while f is not None:
        rec = f.f_locals.get("recorder")
        if hasattr(rec, "fwd") and hasattr(rec, "bwd"):
            return rec
        f = f.f_back
    return None


def read(ctx):
    kern_us = sum(d for n, _, d in ctx.kernel_ops
                  if any(k in n for k in KERNELS))
    rec = recorder()
    if not kern_us or rec is None:
        return None
    nbytes = sum(least_bytes(r["fv"], r["S"], r["sigma"], r["dist_eps"])
                 for r in rec.fwd + rec.bwd)
    if not nbytes:
        return None
    return 100.0 * nbytes / workcount.PEAK_BYTES / (kern_us / 1e6)
