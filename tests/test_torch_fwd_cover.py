"""The forward kernel's block test (the per-slot face masks of
csrc/raster_fwd.cu) through its plain twin, ops/raster_kernel.py::
fwd_block_hits.

A warp of the forward kernel runs the pair arithmetic for a face only in
the 8x4 pixel blocks whose bit the block test sets, so a pixel whose
centre passes the bbox test of the pair arithmetic (ops/rasterize.py::
pair_math, csrc/raster_common.cuh) in a block the test leaves out would
silently lose the face. These tests show, on seeded faces and on bbox
edges placed on pixel centres and a few ulps off them, at several image
sizes, that every such pixel's block is hit, and that the test does not
hit every block. Exact checks: the test is a float32 compare of the same
numbers.
"""

import numpy as np
import pytest
import torch

from test_torch_bwd_cover import SIZES, passing
from umr_tpu_torch.ops.raster_kernel import TILE_SIZE, fwd_block_hits
from umr_tpu_torch.ops.rasterize import _face_info, threshold_of


def check_blocks(box, S):
    """Every tile: each box's passing pixels lie in blocks it hits; returns
    (blocks hit, blocks hit that hold a passing pixel) over all tiles."""
    TX = S // TILE_SIZE
    ok = passing(box, S).reshape(-1, TX, TILE_SIZE, TX, TILE_SIZE)
    hit_all = held_all = 0
    for tile in range(TX * TX):
        ty, tx = divmod(tile, TX)
        inside = ok[:, ty, :, tx, :]                          # [F, 32, 32]
        held = inside.reshape(-1, 8, 4, 4, 8).any(4).any(2)   # [F, 8, 4]
        hit = fwd_block_hits(box, S, tile)                    # [F, 8, 4]
        assert not (held & ~hit).any(), f"tile {tile}: a pixel is lost"
        hit_all += int(hit.sum())
        held_all += int(held.sum())
    return hit_all, held_all


@pytest.mark.parametrize("S", SIZES)
@pytest.mark.parametrize("sigma_val,dist_eps",
                         [(1e-5, 1e-10), (3e-3, 1e-4)],
                         ids=["renderer", "wide_margin"])
def test_blocks_hold_every_bbox_pixel(S, sigma_val, dist_eps):
    """Seeded faces of every size (one pixel to past the image), boxes
    built as face_setup builds them: the vertices' max / min plus or minus
    the margin, in float32."""
    rng = np.random.RandomState(S + 1)
    F = 96
    centre = rng.uniform(-1.1, 1.1, (F, 1, 2))
    size = np.exp(rng.uniform(np.log(0.3 / S), np.log(1.5), (F, 1, 1)))
    xy = centre + size * rng.uniform(-1.0, 1.0, (F, 3, 2))
    xy[:8, :, 1] = xy[:8, :1, 1]          # slivers: one vertex height
    fx = torch.as_tensor(xy[None, ..., 0], dtype=torch.float32)
    fy = torch.as_tensor(xy[None, ..., 1], dtype=torch.float32)
    maxx, minx, maxy, miny = (v[0, :, 0] for v in _face_info(
        fx, fy, torch.ones_like(fx))["bbox"])
    _, margin = threshold_of(sigma_val, dist_eps)
    m = torch.tensor(margin, dtype=torch.float32)
    box = torch.stack([maxx + m, minx - m, maxy + m, miny - m], -1)
    hit, held = check_blocks(box, S)
    # the test skips blocks: far fewer hits than (faces x blocks)
    assert held > 0 and hit < F * (S // 8) * (S // 4) // 4


@pytest.mark.parametrize("S", SIZES)
def test_blocks_at_pixel_centres(S):
    """Box edges on pixel centres and up to 3 ulps to either side, where
    the float compares of the test and of the bbox test meet; the edges
    fall on the blocks' first and last rows and columns as often as
    anywhere."""
    rng = np.random.RandomState(11 + S)
    ar = np.arange(S)
    xc = ((2.0 * ar + 1.0 - S) / S).astype(np.float32)
    yc = ((2.0 * (S - 1 - ar) + 1.0 - S) / S).astype(np.float32)

    def nudge(v, k):
        for _ in range(abs(k)):
            v = np.nextafter(v, np.float32(np.inf if k > 0 else -np.inf),
                             dtype=np.float32)
        return v

    def border(n, step):
        """A column (step 8) or row (step 4) on a block's first or last."""
        return int(np.clip(step * rng.randint(0, n // step)
                           + rng.choice([0, step - 1, step, -1]), 0, n - 1))

    rows = []
    for _ in range(256):
        c = np.sort([border(S, 8), border(S, 8)])
        r = np.sort([border(S, 4), border(S, 4)])
        k = rng.randint(-3, 4, 4)
        rows.append([nudge(xc[c[1]], k[0]), nudge(xc[c[0]], k[1]),
                     nudge(yc[r[0]], k[2]), nudge(yc[r[1]], k[3])])
    hit, held = check_blocks(torch.as_tensor(np.array(rows, np.float32)), S)
    assert held > 0 and hit >= held
