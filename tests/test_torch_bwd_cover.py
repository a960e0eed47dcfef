"""The backward kernel's pixel rectangle (csrc/raster_bwd.cu::pixel_rect)
through its plain twin, ops/raster_kernel.py::pixel_rect.

A warp of the backward kernel walks only its face's rectangle, so a pixel
whose centre passes the bbox test of the pair arithmetic
(ops/rasterize.py::pair_math, csrc/raster_common.cuh) but lies outside the
rectangle would silently lose its gradient. These tests show, on seeded
faces and on bbox edges placed on pixel centres and a few ulps off them,
at several image sizes, that the rectangle holds every such pixel, never
reaches past its tile, and is at most one pixel wider than the passing
pixels on each side. Exact checks: the rectangle is integer.
"""

import numpy as np
import pytest
import torch

from umr_tpu_torch.ops.raster_kernel import TILE_SIZE, pixel_rect
from umr_tpu_torch.ops.rasterize import _face_info, pixel_coords, threshold_of

SIZES = [64, 96, 256, 512]


def passing(box, S):
    """[F, S, S] bool: the pixels whose centre passes pair_math's bbox test
    of each margin-expanded box [F, 4] (float32)."""
    xp, yp = pixel_coords(S, 0, S, torch.float32, "cpu")
    maxx, minx, maxy, miny = (box[:, k, None] for k in range(4))
    out = (xp[0] > maxx) | (xp[0] < minx) | (yp[0] > maxy) | (yp[0] < miny)
    return (~out).reshape(-1, S, S)


def check_cover(box, S):
    """Every tile: the rectangle of each box holds the box's passing pixels
    of the tile, lies in the tile, and overshoots them by at most one
    pixel per side."""
    TX = S // TILE_SIZE
    ok = passing(box, S).reshape(-1, TX, TILE_SIZE, TX, TILE_SIZE)
    n_rects = 0
    for tile in range(TX * TX):
        ty, tx = divmod(tile, TX)
        inside = ok[:, ty, :, tx, :]                          # [F, 32, 32]
        rect = pixel_rect(box, S, tile)                       # [F, 4]
        c0, r0, w, h = rect.unbind(-1)
        empty = (w <= 0) | (h <= 0)
        # nothing passes where the rectangle is empty
        assert not inside[empty].any(), tile
        live = ~empty
        assert (c0[live] >= 0).all() and (r0[live] >= 0).all()
        assert (c0[live] + w[live] <= TILE_SIZE).all()
        assert (r0[live] + h[live] <= TILE_SIZE).all()
        ar = torch.arange(TILE_SIZE)
        in_c = (ar >= c0[:, None]) & (ar < (c0 + w)[:, None])  # [F, 32]
        in_r = (ar >= r0[:, None]) & (ar < (r0 + h)[:, None])
        held = in_r[:, :, None] & in_c[:, None, :]
        assert not (inside & ~held).any(), f"tile {tile}: a pixel is lost"
        # tight: at most one column or row past the passing pixels per side
        cols, rows = inside.any(1), inside.any(2)             # [F, 32]
        some = cols.any(1) & live
        first_c = torch.argmax(cols.int(), 1)
        last_c = TILE_SIZE - 1 - torch.argmax(cols.flip(1).int(), 1)
        first_r = torch.argmax(rows.int(), 1)
        last_r = TILE_SIZE - 1 - torch.argmax(rows.flip(1).int(), 1)
        assert (first_c - c0)[some].le(1).all()
        assert (c0 + w - 1 - last_c)[some].le(1).all()
        assert (first_r - r0)[some].le(1).all()
        assert (r0 + h - 1 - last_r)[some].le(1).all()
        # a rectangle with no passing pixel is at most 2 pixels wide
        stray = live & ~inside.flatten(1).any(1)
        assert ((w[stray] <= 2) | (h[stray] <= 2)).all()
        n_rects += int(some.sum())
    assert n_rects > 0


@pytest.mark.parametrize("S", SIZES)
@pytest.mark.parametrize("sigma_val,dist_eps",
                         [(1e-5, 1e-10), (3e-3, 1e-4)],
                         ids=["renderer", "wide_margin"])
def test_rect_holds_every_bbox_pixel(S, sigma_val, dist_eps):
    """Seeded faces of every size (one pixel to past the image), boxes
    built as face_setup builds them: the vertices' max / min plus or minus
    the margin, in float32."""
    rng = np.random.RandomState(S)
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
    check_cover(box, S)


@pytest.mark.parametrize("S", SIZES)
def test_rect_at_pixel_centres(S):
    """Box edges on pixel centres and up to 3 ulps to either side, where
    the float test and the rectangle's bound disagree first."""
    rng = np.random.RandomState(7 + S)
    ar = np.arange(S)
    xc = ((2.0 * ar + 1.0 - S) / S).astype(np.float32)
    yc = ((2.0 * (S - 1 - ar) + 1.0 - S) / S).astype(np.float32)

    def nudge(v, k):
        for _ in range(abs(k)):
            v = np.nextafter(v, np.float32(np.inf if k > 0 else -np.inf),
                             dtype=np.float32)
        return v

    rows = []
    for _ in range(256):
        c = np.sort(rng.randint(0, S, 2))
        r = np.sort(rng.randint(0, S, 2))
        k = rng.randint(-3, 4, 4)
        rows.append([nudge(xc[c[1]], k[0]), nudge(xc[c[0]], k[1]),
                     nudge(yc[r[0]], k[2]), nudge(yc[r[1]], k[3])])
    check_cover(torch.as_tensor(np.array(rows, np.float32)), S)
