"""The forward kernel's slot layout (csrc/raster_fwd.cu::slot_col,
slot_row, slot_of) through its plain twins, ops/raster_kernel.py::
fwd_slot_pixels and fwd_slot_of.

Each of the kernel's 256 threads holds 4 pixels of its 32x32 tile, and
the write-out reads the pixels' accumulators back by slot_of. A pixel held
twice, or none, or read back from the wrong slot, would be rendered wrong
without the kernel failing. These tests show that the slots cover the tile
once, that each warp's slot is one 8x4 block (the footprint the warp's
lanes share a face list over), and that slot_of inverts the layout; and
that the scenes of the card's tests of the forward's work split
(tests/test_torch_cuda.py) hold what those tests rely on.
"""

import numpy as np
import pytest
import torch

from test_torch_cuda import _edge_faces, _fwd_scene
from umr_tpu_torch.ops import raster_kernel
from umr_tpu_torch.ops.raster_bins import compute_raster_bins
from umr_tpu_torch.ops.raster_kernel import (FWD_SLOTS, FWD_THREADS,
                                             TILE_SIZE, fwd_slot_of,
                                             fwd_slot_pixels)
from umr_tpu_torch.ops.rasterize import pixel_coords, threshold_of


def test_slots_cover_the_tile_once():
    pix = fwd_slot_pixels()
    assert pix.shape == (FWD_SLOTS, FWD_THREADS, 2)
    assert FWD_SLOTS * FWD_THREADS == TILE_SIZE * TILE_SIZE
    assert pix.min() >= 0 and pix.max() < TILE_SIZE
    flat = pix[..., 0] * TILE_SIZE + pix[..., 1]
    assert torch.equal(flat.flatten().sort().values,
                       torch.arange(TILE_SIZE * TILE_SIZE))


@pytest.mark.parametrize("q", range(FWD_SLOTS))
def test_each_warp_slot_is_an_8x4_block(q):
    """Lane l of a warp sits at (l / 8, l % 8) of an 8-wide, 4-high block
    whose corner is a multiple of (4, 8)."""
    pix = fwd_slot_pixels()[q].view(FWD_THREADS // 32, 32, 2)
    lane = torch.arange(32)
    corner = pix[:, :1]                                        # [warps,1,2]
    assert (corner[..., 0] % 4 == 0).all() and (corner[..., 1] % 8 == 0).all()
    assert torch.equal(pix - corner,
                       torch.stack([lane // 8, lane % 8], -1).expand_as(pix))


def test_slot_of_inverts_the_slots():
    pix = fwd_slot_pixels()
    slot = fwd_slot_of(pix[..., 0], pix[..., 1])
    assert torch.equal(slot, torch.arange(FWD_SLOTS * FWD_THREADS).view(
        FWD_SLOTS, FWD_THREADS))
    # and every pixel of the tile maps to a slot in range, once
    r, c = torch.meshgrid(torch.arange(TILE_SIZE), torch.arange(TILE_SIZE),
                          indexing="ij")
    every = fwd_slot_of(r, c).flatten().sort().values
    assert torch.equal(every, torch.arange(TILE_SIZE * TILE_SIZE))


# the card tests' scenes, at the seed those tests draw them with
SEED = 7


def _passing(xy, margin):
    """[F, 64, 64] bool: the pixels whose centre passes the bbox test of
    each face xy [F, 3, 2] at 64^2 (ops/rasterize.py::pair_math's)."""
    xp, yp = pixel_coords(64, 0, 64, torch.float32, "cpu")
    x, y = torch.as_tensor(xy[..., 0]), torch.as_tensor(xy[..., 1])
    maxx, minx = x.amax(-1)[:, None], x.amin(-1)[:, None]
    maxy, miny = y.amax(-1)[:, None], y.amin(-1)[:, None]
    out = ((xp[0] > maxx + margin) | (xp[0] < minx - margin)
           | (yp[0] > maxy + margin) | (yp[0] < miny - margin))
    return (~out).reshape(-1, 64, 64)


def test_one_pixel_bbox_scene():
    faces, _, _, _, kw = _fwd_scene("one_pixel_bbox",
                                    np.random.RandomState(SEED))
    _, margin = threshold_of(kw["sigma_val"], kw["dist_eps"])
    for b in range(2):
        assert (_passing(faces[b, ..., :2], margin).sum((1, 2)) == 1).all()


def test_block_edge_scene():
    """The bbox bounds sit on the first column or row of a kernel block,
    or 1-2 ulps off it to either side, and the first passing column and
    row are the ones the scene states."""
    _, _, _, _, kw = _fwd_scene("block_edges", np.random.RandomState(SEED))
    _, margin = threshold_of(kw["sigma_val"], kw["dist_eps"])
    xy, off, first = _edge_faces(np.random.RandomState(SEED), margin)
    off = np.array(off)
    assert np.abs(off).max() <= 2 and (off < 0).any() and (off > 0).any()
    assert (off == 0).sum() >= len(off) // 2
    ok = _passing(xy, margin)
    for f, (c, r) in enumerate(first):
        cols = torch.nonzero(ok[f].any(0))[:, 0]
        rows = torch.nonzero(ok[f].any(1))[:, 0]
        assert (int(cols[0]), int(rows[0])) == (c, r), f
        assert c % 8 in (0, 1) and r % 4 in (0, 1)


def test_degenerate_scene():
    faces, _, _, _, _ = _fwd_scene("degenerate_among_live",
                                   np.random.RandomState(SEED))
    x, y = faces[0, :, :, 0], faces[0, :, :, 1]
    det = (x[:, 2] * (y[:, 0] - y[:, 1]) + x[:, 0] * (y[:, 1] - y[:, 2])
           + x[:, 1] * (y[:, 2] - y[:, 0]))
    dead = np.abs(det) <= 1e-10                 # face_setup culls these
    assert dead.sum() >= 10 and (np.abs(det[~dead]) > 1e-4).all()


@pytest.mark.parametrize("kind,cap,faces_in", [("exact_cap", 64, 64),
                                               ("over_cap", 40, 72)])
def test_cap_scenes(kind, cap, faces_in):
    """Every face of an image is binned to one tile alone (tile (0, 0);
    image 1 is mirrored in y), so the kernel keeps the first mf_cap."""
    faces, _, got_cap, kept, kw = _fwd_scene(kind,
                                             np.random.RandomState(SEED))
    assert (got_cap, kept, faces.shape[1]) == (cap, min(cap, faces_in),
                                               faces_in)
    bins = compute_raster_bins(torch.as_tensor(faces), 64,
                               raster_kernel.TILE_SIZE, kw["sigma_val"],
                               kw["dist_eps"], 1024, raster_kernel.MAX_COVER,
                               4096)
    n = torch.diff(bins[1].long(), dim=1)
    assert (n[0, 0] == faces_in) and (n.amax(1) == faces_in).all()
    assert (n.sum(1) == faces_in).all()


def test_overlap_order_scene():
    """The two faces overlap at two depths, in one id order in image 0
    and the other in image 1."""
    faces, _, _, _, kw = _fwd_scene("overlap_order",
                                    np.random.RandomState(SEED))
    _, margin = threshold_of(kw["sigma_val"], kw["dist_eps"])
    both = _passing(faces[0, ..., :2], margin).all(0)
    assert both.sum() > 100
    assert np.array_equal(faces[1], faces[0, ::-1])
    assert faces[0, 0, 0, 2] != faces[0, 1, 0, 2]
