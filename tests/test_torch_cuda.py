"""The CUDA rasterizer kernels, forward and backward, against their plain
versions, on the card.

Marked `cuda`: they need an NVIDIA GPU and nvcc, and skip elsewhere (a
CUDA kernel has no CPU mode). Run them on the card with
`python -m pytest tests/test_torch_cuda.py -m cuda -q`; chip_smoke.py
makes the same checks at the main path's shapes.

Tolerances: rgba atol 1e-3 and softmax (sum, max) rtol 1e-4 (the kernel
sums faces in another order); hard-mode face ids and depths equal on
>= 99.9% of covered pixels (the per-pair arithmetic is the plain
version's, rounding for rounding). Backward: gradients within 1e-4
relative plus 1e-5 of the largest gradient (the kernel sums pixels and
tiles in another order, with atomics). p2f: atol 1e-5 in grid units (p2f
lies in [-1, 1]; the kernel sums each face's weights per warp, block and
tile with atomics, in an order that changes run to run)."""

import numpy as np
import pytest
import torch

from torch_parity import random_scene
from umr_tpu_torch.ops import raster_kernel
from umr_tpu_torch.ops.raster_bins import compute_raster_bins
from umr_tpu_torch.ops.rasterize import soft_rasterize, threshold_of
from umr_tpu_torch.ops.rasterize_bwd import soft_rasterize_bwd

pytestmark = pytest.mark.cuda

P2F_ATOL = 1e-5
KW = dict(image_size=64, sigma_val=3e-3, gamma_val=1e-2, dist_eps=1e-4,
          background_color=(0.1, 0.2, 0.3))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("mode", ["softmax", "mask_only", "hard"])
def test_kernel_matches_plain(cuda, mode):
    faces, tex = random_scene(np.random.RandomState(1), B=2, F=40, T2=9)
    fv = torch.as_tensor(faces, device=cuda)
    tx = torch.as_tensor(tex, device=cuda)
    kw = dict(KW, aggr_func_rgb="hard" if mode == "hard" else "softmax",
              mask_only=mode == "mask_only")
    before = raster_kernel.LAUNCHES
    # a cap above the scene's needs: the plain version has no bins to cap
    out = raster_kernel.soft_rasterize_fwd(fv, tx, mf_cap=64, **kw)
    torch.cuda.synchronize()
    assert raster_kernel.LAUNCHES == before + 1
    ref = soft_rasterize(fv, tx, **kw)
    torch.testing.assert_close(out.rgba, ref.rgba, atol=1e-3, rtol=0)
    if mode == "hard":
        cov = ref.aggr[:, 1] >= 0
        same = ((out.aggr[:, 1] == ref.aggr[:, 1])
                & (out.aggr[:, 0] == ref.aggr[:, 0]))
        assert same[cov].float().mean() >= 0.999
    else:
        torch.testing.assert_close(out.aggr, ref.aggr, rtol=1e-4, atol=0)


@pytest.mark.parametrize("mode", ["softmax", "mask_only"])
def test_p2f_kernel_matches_plain(cuda, mode):
    """The p2f instance against the plain version at face_chunk=1 (the
    kernel's rule); its rgba and aggr are the p2f-free instance's, bit for
    bit (the same arithmetic)."""
    faces, tex = random_scene(np.random.RandomState(3), B=2, F=40, T2=9)
    fv = torch.as_tensor(faces, device=cuda)
    tx = torch.as_tensor(tex, device=cuda)
    kw = dict(KW, mask_only=mode == "mask_only")
    before = (raster_kernel.LAUNCHES, raster_kernel.P2F_LAUNCHES)
    out = raster_kernel.soft_rasterize_fwd(fv, tx, mf_cap=64, need_p2f=True,
                                           **kw)
    plain_inst = raster_kernel.soft_rasterize_fwd(fv, tx, mf_cap=64, **kw)
    torch.cuda.synchronize()
    assert (raster_kernel.LAUNCHES, raster_kernel.P2F_LAUNCHES) == (
        before[0] + 2, before[1] + 1)
    assert torch.equal(out.rgba, plain_inst.rgba)
    assert torch.equal(out.aggr, plain_inst.aggr)
    assert not plain_inst.p2f.any()
    ref = soft_rasterize(fv, tx, face_chunk=1, need_p2f=True, **kw)
    torch.testing.assert_close(out.p2f, ref.p2f, atol=P2F_ATOL, rtol=0)
    # the hard body writes no p2f
    hard = raster_kernel.soft_rasterize_fwd(
        fv, tx, mf_cap=64, need_p2f=True, aggr_func_rgb="hard", **KW)
    assert not hard.p2f.any()
    assert raster_kernel.P2F_LAUNCHES == before[1] + 1


def test_p2f_kernel_matches_golden(cuda):
    from golden_raster import golden_soft_rasterize

    kw = dict(KW, image_size=32)
    faces, tex = random_scene(np.random.RandomState(4), B=2, F=6, T2=16)
    _, g_p2f, _ = golden_soft_rasterize(faces, tex, **kw)
    out = raster_kernel.soft_rasterize_fwd(
        torch.as_tensor(faces, device=cuda), torch.as_tensor(tex, device=cuda),
        mf_cap=32, need_p2f=True, **kw)
    np.testing.assert_allclose(out.p2f.cpu().numpy(), g_p2f, rtol=0,
                               atol=P2F_ATOL)


@pytest.mark.parametrize("opts", [
    {}, {"rgb_geom_detach": True}, {"tex_grads": False}, {"mask_only": True}],
    ids=["default", "rgb_geom_detach", "no_tex_grads", "mask_only"])
def test_backward_kernel_matches_plain(cuda, opts):
    rng = np.random.RandomState(2)
    faces, tex = random_scene(rng, B=2, F=40, T2=9)
    g = torch.as_tensor(rng.standard_normal((2, 64, 64, 4)).astype(
        np.float32), device=cuda)
    fv = torch.as_tensor(faces, device=cuda).requires_grad_()
    tx = torch.as_tensor(tex, device=cuda).requires_grad_()
    before = raster_kernel.BWD_LAUNCHES
    out = raster_kernel.soft_rasterize_fwd(fv, tx, mf_cap=64, **opts, **KW)
    (out.rgba * g).sum().backward()
    torch.cuda.synchronize()
    assert raster_kernel.BWD_LAUNCHES == before + 1
    ref = soft_rasterize(fv.detach(), tx.detach(),
                         mask_only=opts.get("mask_only", False), **KW)
    bkw = {k: v for k, v in KW.items() if k != "background_color"}
    gf, gt = soft_rasterize_bwd(fv.detach(), tx.detach(), ref.rgba, ref.aggr,
                                g, **opts, **bkw)
    for got, want in ((fv.grad, gf), (tx.grad, gt)):
        scale = max(want.abs().max().item(), 1e-30)
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5 * scale)
    if opts.get("tex_grads", True) and not opts.get("mask_only"):
        assert gt.abs().max() > 0


# scenes that reach what the backward's work split (one warp per face,
# over the face's pixel rectangle in the tile) can get wrong; 64^2 images,
# two tiles per axis, KW's soft edges (the bbox margin is ~5 pixels)
def _tile0(rng, F, lo=0.3, hi=0.75):
    """F small faces inside tile (0, 0), margin included: x in -[hi, lo],
    y in [lo, hi] (NDC)."""
    c = np.stack([-rng.uniform(lo, hi, F), rng.uniform(lo, hi, F)], -1)
    xy = c[:, None] + rng.uniform(-0.06, 0.06, (F, 3, 2))
    return np.clip(xy, [-hi, lo], [-lo, hi])


def _bwd_scene(kind, rng):
    """(faces [2,F,3,3], textures [2,F,9,3], mf_cap, faces the kernel
    keeps: the first n of each image)."""
    if kind == "whole_tile":
        # one face over all of tile (0, 0), its hypotenuse (y = x - 0.3)
        # through the other tiles, and a small face clear of it
        xy = np.array([[[-1.5, 1.5], [1.8, 1.5], [-1.5, -1.8]],
                       [[0.3, -0.8], [0.8, -0.7], [0.5, -0.3]]])
        F, cap = 2, 64
    elif kind == "pixel_and_sliver":
        px = 2.0 / 64                       # one pixel, NDC
        c = rng.uniform(-0.8, 0.8, (12, 1, 2))
        tiny = c + px * np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]])
        long_ = rng.uniform(-0.9, 0.9, (6, 1, 2))
        d = rng.uniform(-1.0, 1.0, (6, 1, 2))
        sliver = long_ + np.concatenate(
            [0 * d, 0.8 * d, 0.8 * d + 0.3 * px * d[..., ::-1] * [1, -1]], 1)
        xy = np.concatenate([tiny, sliver])
        F, cap = xy.shape[0], 64
    elif kind == "many_in_one_tile":
        xy = _tile0(rng, 80)                # 3 chunks of 32, 10 per warp
        F, cap = 80, 128
    elif kind == "truncated":
        xy = _tile0(rng, 56)                # the kernel keeps the first 40
        F, cap = 56, 40
    elif kind == "outside_depth":
        xy = rng.uniform(-0.9, 0.9, (24, 3, 2))
        F, cap = 24, 64
    faces = np.zeros((2, F, 3, 3), np.float32)
    faces[..., :2] = xy
    faces[1, ..., :2] = xy[:, ::-1] * [1, -1]     # mirrored in y
    faces[..., 2] = 7.0 + rng.uniform(-1.0, 1.0, (2, F, 3))
    if kind == "outside_depth":
        # in front of near, past far, and straddling near within a face
        faces[:, 0:8, :, 2] = rng.uniform(0.3, 0.9, (2, 8, 3))
        faces[:, 8:16, :, 2] = rng.uniform(101.0, 150.0, (2, 8, 3))
        faces[:, 16:24, 0, 2] = 0.5
    tex = rng.uniform(0.0, 1.0, (2, F, 9, 3)).astype(np.float32)
    return faces, tex, cap, min(F, cap)


@pytest.mark.parametrize("kind", ["whole_tile", "pixel_and_sliver",
                                  "many_in_one_tile", "truncated",
                                  "outside_depth"])
@pytest.mark.parametrize("opts", [
    {}, {"rgb_geom_detach": True}, {"tex_grads": False}, {"mask_only": True}],
    ids=["default", "rgb_geom_detach", "no_tex_grads", "mask_only"])
def test_backward_kernel_work_split(cuda, kind, opts):
    """Each lane group (vertex x, y; vertex z; texels) within 1e-4
    relative plus 1e-5 of the group's largest gradient of the plain
    version on the faces the kernel keeps; the dropped faces get none."""
    rng = np.random.RandomState(5)
    faces, tex, cap, kept = _bwd_scene(kind, rng)
    g = torch.as_tensor(rng.standard_normal((2, 64, 64, 4)).astype(
        np.float32), device=cuda)
    fv = torch.as_tensor(faces, device=cuda).requires_grad_()
    tx = torch.as_tensor(tex, device=cuda).requires_grad_()
    # an entry cap that drops nothing: the default (8 entries a face)
    # would drop tiles of the two-face scene; only mf_cap truncates
    F = faces.shape[1]
    bins = compute_raster_bins(fv.detach(), 64, raster_kernel.TILE_SIZE,
                               KW["sigma_val"], KW["dist_eps"], cap,
                               raster_kernel.MAX_COVER, 16 * F + 32)
    out = raster_kernel.soft_rasterize_fwd(fv, tx, mf_cap=cap, bins=bins,
                                           **opts, **KW)
    (out.rgba * g).sum().backward()
    torch.cuda.synchronize()
    kf, kt = fv.grad[:, :kept], tx.grad[:, :kept]
    assert not fv.grad[:, kept:].any() and not tx.grad[:, kept:].any()
    rf, rt = fv.detach()[:, :kept].contiguous(), tx.detach()[:, :kept]
    ref = soft_rasterize(rf, rt.contiguous(),
                         mask_only=opts.get("mask_only", False), **KW)
    torch.testing.assert_close(out.rgba, ref.rgba, atol=1e-3, rtol=0)
    bkw = {k: v for k, v in KW.items() if k != "background_color"}
    gf, gt = soft_rasterize_bwd(rf, rt.contiguous(), ref.rgba, ref.aggr, g,
                                **opts, **bkw)
    mask_only = opts.get("mask_only", False)
    want_tex = opts.get("tex_grads", True) and not mask_only
    want_z = not (mask_only or opts.get("rgb_geom_detach", False))
    for got, want, live in ((kf[..., :2], gf[..., :2], True),
                            (kf[..., 2], gf[..., 2], want_z),
                            (kt, gt, want_tex)):
        if not live:
            assert not got.any() and not want.any()
            continue
        scale = want.abs().max().item()
        assert scale > 0
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5 * scale)


# scenes that reach what the forward's work split (a mask of bbox hits per
# pixel, the warp's walk over the union of its lanes' masks, 8x4 pixel
# blocks per slot, pixel accumulators in shared memory) can get wrong; 64^2
# images, two tiles per axis
def _bound_near(target, m, sign):
    """(x, fl32(x + sign * m)): the float32 x whose bbox bound (the face's
    extreme coordinate plus or minus the margin, in float32, as the kernel
    and the plain version compute it) lies nearest to target."""
    t, m, sg = np.float32(target), np.float32(m), np.float32(sign)
    x = np.float32(t - sg * m)
    cands = [x]
    for d in (np.inf, -np.inf):
        y = x
        for _ in range(8):
            y = np.nextafter(y, np.float32(d), dtype=np.float32)
            cands.append(y)
    x = min(cands, key=lambda c: abs(float(np.float32(c + sg * m)) - float(t)))
    return x, np.float32(x + sg * m)


def _centre(i, S=64):
    """Pixel centre coordinate of column i (float32, exact at S = 64); a
    row r's is -_centre(r)."""
    return np.float32((2 * i + 1 - S) / S)


def _ulps(v, k):
    for _ in range(abs(k)):
        v = np.nextafter(v, np.float32(np.inf if k > 0 else -np.inf),
                         dtype=np.float32)
    return v


def _edge_faces(rng, margin, n=24):
    """n right triangles whose margin-expanded bbox has its left and top
    bounds on pixel centres at the borders of the kernel's 8x4 blocks
    (the first column of a block, the first row of one), or a few ulps to
    either side; the legs run along those bounds at the margin, so the
    pixels on them sit at the cull distance. Returns (xy [n, 3, 2], the
    bounds' distances from the centres in ulps, the first column and row
    each face's bbox test passes)."""
    xy, off, first = np.zeros((n, 3, 2), np.float32), [], []
    for i in range(n):
        c_lo = 8 * rng.randint(0, 7)                  # a block's first column
        r_lo = 4 * rng.randint(0, 15)                 # a block's first row
        k = (-1, 0, 1)[i % 3]
        cx, cy = _centre(c_lo), -_centre(r_lo)
        x_lo, bx = _bound_near(_ulps(cx, k), margin, -1)
        y_hi, by = _bound_near(_ulps(cy, -k), margin, 1)
        w = 2.0 / 64 * rng.randint(2, 12)
        h = 2.0 / 64 * rng.randint(2, 12)
        # right angle at the top left: legs along x = x_lo, y = y_hi
        xy[i] = [[x_lo, y_hi], [x_lo + w, y_hi], [x_lo, y_hi - h]]
        ulp = float(np.spacing(np.float32(abs(cx)) or np.float32(1)))
        ulp_y = float(np.spacing(np.float32(abs(cy)) or np.float32(1)))
        off.append(((float(bx) - float(cx)) / ulp,
                    (float(by) - float(cy)) / ulp_y))
        # a centre passes min x - m <= xp and yp <= max y + m
        first.append((c_lo + int(cx < bx), r_lo + int(cy > by)))
    return xy, off, first


def _fwd_scene(kind, rng):
    """(faces [2,F,3,3], textures [2,F,9,3], mf_cap, faces the kernel
    keeps (the first n of each image), render keywords)."""
    kw = dict(KW)
    if kind == "exact_cap":
        xy = _tile0(rng, 64)                # two full chunks in tile (0, 0)
        F, cap = 64, 64
    elif kind == "over_cap":
        xy = _tile0(rng, 72)                # the kernel keeps the first 40
        F, cap = 72, 40
    elif kind == "one_pixel_bbox":
        # the renderer's sigma: a 0.1-pixel face on a pixel centre, whose
        # margin-expanded bbox holds that pixel alone
        kw.update(sigma_val=1e-5, dist_eps=1e-10, gamma_val=1e-4)
        px = 2.0 / 64
        cells = rng.choice(64 * 64, 24, replace=False)
        c = np.stack([(2 * (cells % 64) + 1 - 64) / 64,
                      -(2 * (cells // 64) + 1 - 64) / 64], -1)
        xy = c[:, None] + 0.1 * px * np.array([[-0.5, -0.3], [0.5, -0.3],
                                               [0.0, 0.5]])
        F, cap = 24, 64
    elif kind == "block_edges":
        # fragments at the cull distance are dist_eps: 0.1 here, so a
        # pixel left out of the walk would show in alpha
        kw.update(dist_eps=0.1)
        _, margin = threshold_of(kw["sigma_val"], kw["dist_eps"])
        xy, _, _ = _edge_faces(rng, margin)
        F, cap = xy.shape[0], 64
    elif kind == "whole_tile":
        xy = np.array([[[-1.5, 1.5], [1.8, 1.5], [-1.5, -1.8]],
                       [[0.3, -0.8], [0.8, -0.7], [0.5, -0.3]]])
        F, cap = 2, 64
    elif kind == "degenerate_among_live":
        xy = rng.uniform(-0.9, 0.9, (30, 3, 2))
        xy[::3, 2] = xy[::3, 0]             # two corners equal
        xy[1::6, :, 1] = xy[1::6, :1, 1]    # three corners on one line
        F, cap = 30, 64
    elif kind == "overlap_order":
        # one face over another at another depth; image 1 holds them in
        # the other id order, so p2f (weighed by the running max after
        # each face) pins the order the faces are walked in
        xy = np.array([[[-0.6, -0.5], [0.5, -0.6], [0.0, 0.6]],
                       [[-0.5, -0.3], [0.6, -0.4], [0.1, 0.7]]])
        F, cap = 2, 64
    faces = np.zeros((2, F, 3, 3), np.float32)
    faces[..., :2] = xy
    if kind != "overlap_order":
        faces[1, ..., :2] = xy[:, ::-1] * [1, -1]     # mirrored in y
    faces[..., 2] = 7.0 + rng.uniform(-1.0, 1.0, (2, F, 3))
    if kind == "overlap_order":
        faces[0, 0, :, 2], faces[0, 1, :, 2] = 6.0, 8.0
        faces[1] = faces[0, ::-1]
    tex = rng.uniform(0.0, 1.0, (2, F, 9, 3)).astype(np.float32)
    return faces, tex, cap, min(F, cap), kw


FWD_KINDS = ["exact_cap", "over_cap", "one_pixel_bbox", "block_edges",
             "whole_tile", "degenerate_among_live", "overlap_order"]


@pytest.mark.parametrize("kind", FWD_KINDS)
@pytest.mark.parametrize("mode", ["softmax", "mask_only", "hard",
                                  "softmax_p2f", "mask_only_p2f"])
def test_forward_kernel_work_split(cuda, kind, mode):
    """rgba within 1e-3, softmax (sum, max) within 1e-4 relative, hard
    face ids and depths equal on >= 99.9% of covered pixels, p2f within
    P2F_ATOL of the plain version at face_chunk=1, on the faces the kernel
    keeps; the dropped faces get no p2f."""
    rng = np.random.RandomState(7)
    faces, tex, cap, kept, kw = _fwd_scene(kind, rng)
    hard = mode == "hard"
    need_p2f = mode.endswith("_p2f")
    kw = dict(kw, aggr_func_rgb="hard" if hard else "softmax",
              mask_only=mode.startswith("mask_only"))
    fv = torch.as_tensor(faces, device=cuda)
    tx = torch.as_tensor(tex, device=cuda)
    # an entry cap that drops nothing: only mf_cap truncates
    F = faces.shape[1]
    bins = compute_raster_bins(fv, 64, raster_kernel.TILE_SIZE,
                               kw["sigma_val"], kw["dist_eps"], cap,
                               raster_kernel.MAX_COVER, 16 * F + 32)
    out = raster_kernel.soft_rasterize_fwd(fv, tx, mf_cap=cap, bins=bins,
                                           need_p2f=need_p2f, **kw)
    torch.cuda.synchronize()
    ref = soft_rasterize(fv[:, :kept].contiguous(),
                         tx[:, :kept].contiguous(), need_p2f=need_p2f,
                         **({"face_chunk": 1} if need_p2f else {}), **kw)
    torch.testing.assert_close(out.rgba, ref.rgba, atol=1e-3, rtol=0)
    if hard:
        cov = ref.aggr[:, 1] >= 0
        same = ((out.aggr[:, 1] == ref.aggr[:, 1])
                & (out.aggr[:, 0] == ref.aggr[:, 0]))
        assert cov.any() and same[cov].float().mean() >= 0.999
    else:
        torch.testing.assert_close(out.aggr, ref.aggr, rtol=1e-4, atol=0)
    if need_p2f:
        torch.testing.assert_close(out.p2f[:, :kept], ref.p2f,
                                   atol=P2F_ATOL, rtol=0)
        assert not out.p2f[:, kept:].any()
        assert ref.p2f.abs().sum() > 0
    else:
        assert not out.p2f.any()


def test_trainer_copies_batches_pinned_and_drains_one_step_late(cuda,
                                                                 tmp_path):
    """The trainer on the card: it copies the loader's arrays that the
    step reads (counted as trainer.h2d_bytes) and prepares each batch
    there (one trainer.prep_on_device a step): every key of every step's
    batch is a CUDA tensor equal bit for bit to the host prepare_batch,
    real_imgs one batch late; each step's scalars (queued to pinned
    memory behind the step) come back in order, one step late."""
    from umr_tpu_torch import tracing
    from umr_tpu_torch.config import Config
    from umr_tpu_torch.data import synthetic_batch
    from umr_tpu_torch.training.steps import TrainState
    from umr_tpu_torch.training.trainer import (Trainer, prepare_batch,
                                                step_keys)

    model = torch.nn.Linear(2, 2).to(cuda)
    disc = torch.nn.Linear(1, 1).to(cuda)
    state = TrainState(step=0, updates=0, model=model, disc=disc, lpips=None,
                       optimizer=torch.optim.SGD(model.parameters(), lr=0.1),
                       generator=torch.Generator(cuda))
    rng = np.random.RandomState(0)
    loader = [synthetic_batch(rng, 2, 32) for _ in range(3)]
    seen = []

    def step_fn(st, db):
        assert all(v.is_cuda for v in db.values())
        seen.append({k: v.cpu().numpy() for k, v in db.items()})
        st.step += 1
        return st, {"total_loss": db["img"].sum() * 0 + st.step}

    cfg = Config(checkpoint_dir=str(tmp_path), num_iter=3, num_epochs=1,
                 print_scalars=False)
    t = Trainer(cfg, step_fn, state, loader)
    assert t.device.type == "cuda"
    before = tracing.totals()
    t.train()
    assert [sc["total_loss"] for sc in t.history] == [1.0, 2.0, 3.0]
    counters = tracing.delta(before)["counters"]
    keys = step_keys(loader[0])
    assert counters["trainer.h2d_bytes"] == sum(
        b[k].nbytes for b in loader for k in keys)
    assert counters["trainer.prep_on_device"] == len(loader)
    for i, (got, batch) in enumerate(zip(seen, loader)):
        want = prepare_batch(batch)
        # the GAN's reals lag one batch
        want["real_imgs"] = prepare_batch(loader[max(i - 1, 0)])["real_imgs"]
        assert list(got) == list(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k],
                                          err_msg=f"{k}, step {i}")
