"""The main path's face -> tile bins (ops/raster_bins.py::full_raster_bins):
every (face, tile) pair whose margin-expanded bbox reaches the tile, in
ascending face order, on a spiky mesh at stage 1's render size where the
JAX package's caps drop entries; and, where no cap binds, the capped
layout entry for entry.

The tests marked `cuda` hold the binning kernels (csrc/raster_bins.cu)
to their plain twin and the forward kernel on those bins to the plain
route, and skip elsewhere:

  python -m pytest tests/test_torch_bins.py -m cuda -q --noconftest
"""

import numpy as np
import pytest
import torch

from umr_tpu_torch import tracing
from umr_tpu_torch.mesh import build_template
from umr_tpu_torch.ops import raster_kernel
from umr_tpu_torch.ops import raster_bins
from umr_tpu_torch.ops.raster_bins import (GROUP, compute_raster_bins,
                                           full_entries, full_raster_bins)
from umr_tpu_torch.ops.rasterize import soft_rasterize, threshold_of
from umr_tpu_torch.renderer import SoftRenderer

RENDERER = SoftRenderer(image_size=256)        # 512^2 anti-aliased renders
S = RENDERER.render_size


def spiky_scene(seed, B=3, spread=0.7, device="cpu"):
    """Projected faces [B, 1280, 3, 3] of the subdivided icosphere with
    each vertex's radius scaled by a lognormal draw (sigma `spread`) under
    random cameras: at 0.7 the median face is ~85 px wide at 512^2 (stage
    1's seeded start reads ~90) and the longest cross the image."""
    t = build_template(3, 1, 6)
    rng = np.random.default_rng(seed)
    v = t.verts[None] * rng.lognormal(0.0, spread, (B, len(t.verts), 1))
    cams = np.concatenate([rng.uniform(0.6, 0.8, (B, 1)),
                           rng.uniform(-0.1, 0.1, (B, 2)),
                           rng.standard_normal((B, 4))], 1)
    cams[:, 3:] /= np.linalg.norm(cams[:, 3:], axis=1, keepdims=True)
    f = torch.as_tensor
    return RENDERER.project_faces(
        f(v, dtype=torch.float32, device=device), f(t.faces, device=device),
        f(cams, dtype=torch.float32, device=device)).contiguous()


def reached_pairs(fv):
    """Brute force: [B] lists of [n_tiles] sorted face-id lists, the faces
    whose margin-expanded bbox overlaps each 32x32 tile's pixel centres'
    span, from the bbox in pixels (the binning's float32 expressions) and
    a comparison per tile bound, no floor."""
    _, margin = threshold_of(RENDERER.sigma_val, RENDERER.dist_eps)
    m = np.float32(margin)
    x = fv[..., 0].cpu().numpy()
    y = fv[..., 1].cpu().numpy()
    fS, half, last = np.float32(S), np.float32((S - 1) / 2), np.float32(S - 1)
    two = np.float32(2)
    col_min = (x.min(-1) - m) * fS / two + half
    col_max = (x.max(-1) + m) * fS / two + half
    row_min = (last - (y.max(-1) + m) * fS) / two
    row_max = (last - (y.min(-1) - m) * fS) / two
    TX = S // 32
    lo = np.arange(TX, dtype=np.float32) * 32        # a tile's first pixel
    hi = lo + 32                                      # the next tile's
    out = []
    for b in range(fv.shape[0]):
        on = ~((col_max[b] < 0) | (col_min[b] > last) | (row_max[b] < 0)
               | (row_min[b] > last))
        # the first tile reaches the image's edge, the last its far edge
        in_x = ((col_min[b][:, None] < hi[None]) | (np.arange(TX) == TX - 1)
                ) & ((col_max[b][:, None] >= lo[None]) | (np.arange(TX) == 0))
        in_y = ((row_min[b][:, None] < hi[None]) | (np.arange(TX) == TX - 1)
                ) & ((row_max[b][:, None] >= lo[None]) | (np.arange(TX) == 0))
        cov = in_y[:, :, None] & in_x[:, None, :] & on[:, None, None]
        cov = cov.reshape(len(on), TX * TX)
        out.append([np.nonzero(cov[:, t])[0].tolist()
                    for t in range(TX * TX)])
    return out


def tile_lists(bins, F):
    """[B] lists of [n_tiles] face-id lists of bins, padding checked and
    left out."""
    al_fids, astarts = (b.cpu().numpy() for b in bins)
    out = []
    for b in range(al_fids.shape[0]):
        tiles = []
        for t in range(astarts.shape[1] - 1):
            s, e = astarts[b, t], astarts[b, t + 1]
            assert s % GROUP == 0 and (e - s) % GROUP == 0
            ids = al_fids[b, s:e]
            n = int((ids < F).sum())
            assert (ids[n:] == F).all() and e - s - n < GROUP
            tiles.append(ids[:n].tolist())
        out.append(tiles)
    return out


def test_full_bins_hold_every_reached_pair_of_a_spiky_mesh():
    fv = spiky_scene(17)
    B, F = fv.shape[:2]
    tracing.reset()
    _, capped_starts = compute_raster_bins(
        fv, S, 32, RENDERER.sigma_val, RENDERER.dist_eps,
        RENDERER.resolved_mf_cap(F), raster_kernel.MAX_COVER)
    jax_caps = tracing.totals()["counters"]
    tracing.reset()
    bins = full_raster_bins(fv, S, RENDERER.sigma_val, RENDERER.dist_eps)
    counters = tracing.totals()["counters"]
    want = reached_pairs(fv)
    got = tile_lists(bins, F)
    pairs = sum(len(ids) for tiles in want for ids in tiles)
    assert got == want            # every reached pair, faces ascending
    assert bins[0].shape == (B, full_entries(F, (S // 32) ** 2))
    assert counters["raster.bins_entries"] == pairs
    assert counters["raster.bins_dropped"] == 0
    # the scene is one the JAX package's caps cut: faces in more than
    # 4 x 4 tiles, and a third or more of the pairs dropped
    assert jax_caps["raster.bins_entries"] + jax_caps[
        "raster.bins_dropped"] == pairs
    assert jax_caps["raster.bins_dropped"] > pairs // 3
    widest = max(np.bincount([f for ids in tiles for f in ids]).max()
                 for tiles in want)
    assert widest > raster_kernel.MAX_COVER ** 2
    tracing.reset()


def test_renderer_bins_are_the_full_bins():
    t = build_template(3, 1, 6)
    rng = np.random.default_rng(3)
    v = torch.as_tensor(t.verts[None] * rng.lognormal(0, 0.7, (2, 642, 1)),
                        dtype=torch.float32)
    cams = torch.tensor([[0.7, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0],
                         [0.6, 0.1, -0.1, 0.0, 1.0, 0.0, 0.0]])
    faces = torch.as_tensor(t.faces)
    fv = RENDERER.project_faces(v, faces, cams)
    a = RENDERER.compute_bins(v, faces, cams)
    b = full_raster_bins(fv, S, RENDERER.sigma_val, RENDERER.dist_eps)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("scale,seed", [(0.25, 0), (0.5, 1), (0.8, 2)])
def test_full_bins_are_the_capped_layout_where_no_cap_binds(scale, seed):
    """An unspiked sphere (no face past four tiles, no tile past the cap,
    no image past 8 F entries): the same astarts, and the same al_fids up
    to the last range's end, the capped array's rest all padding."""
    t = build_template(3, 1, 6)
    rng = np.random.default_rng(seed)
    B, F = 2, len(t.faces)
    cams = np.concatenate([np.full((B, 1), scale), rng.uniform(-0.2, 0.2,
                           (B, 2)), rng.standard_normal((B, 4))], 1)
    cams[:, 3:] /= np.linalg.norm(cams[:, 3:], axis=1, keepdims=True)
    fv = RENDERER.project_faces(
        torch.as_tensor(np.repeat(t.verts[None], B, 0), dtype=torch.float32),
        torch.as_tensor(t.faces), torch.as_tensor(cams, dtype=torch.float32))
    tracing.reset()
    capped = compute_raster_bins(fv, S, 32, RENDERER.sigma_val,
                                 RENDERER.dist_eps,
                                 RENDERER.resolved_mf_cap(F),
                                 raster_kernel.MAX_COVER)
    assert tracing.totals()["counters"]["raster.bins_dropped"] == 0
    full = full_raster_bins(fv, S, RENDERER.sigma_val, RENDERER.dist_eps)
    assert torch.equal(full[1], capped[1])
    n = int(capped[1][:, -1].max())
    assert torch.equal(full[0][:, :n], capped[0][:, :n])
    assert (capped[0][:, n:] == F).all()
    tracing.reset()


def test_nonfinite_face_covers_no_tile():
    fv = spiky_scene(5, B=1)
    fv[0, 7, 1, 0] = float("nan")
    fv[0, 9, 2, 1] = float("inf")
    tiles = tile_lists(full_raster_bins(fv, S, RENDERER.sigma_val,
                                        RENDERER.dist_eps), fv.shape[1])[0]
    assert not any(f in ids for ids in tiles for f in (7, 9))


def test_device_counter_adds_to_the_counter_of_its_name():
    tracing.reset()
    tracing.count("x.n", 5)
    tracing.device_counter("x.n", "cpu").add_(torch.tensor([7]))
    tracing.device_counter("x.m", "cpu").add_(3)
    before = tracing.totals()
    assert before["counters"] == {"x.n": 12, "x.m": 3}
    tracing.device_counter("x.n", "cpu").add_(1)
    assert tracing.delta(before)["counters"] == {"x.n": 1, "x.m": 0}
    tracing.reset()
    assert tracing.totals()["counters"] == {}


def _bins_roofline_reader():
    import importlib.util
    import pathlib

    path = (pathlib.Path(__file__).resolve().parents[1] / "umr_bench"
            / "metrics" / "raster_bins_roofline.py")
    spec = importlib.util.spec_from_file_location("_bins_roofline", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("seed,spread", [(17, 0.7), (18, 1.2), (19, 0.0)])
def test_bins_roofline_counts_the_full_bins_bytes(seed, spread):
    """The benchmark's count of a binning's least bytes, from the faces
    alone, is what the program's full bins of them hold: the faces' x
    and y, the starts and every padded entry."""
    reader = _bins_roofline_reader()
    fv = spiky_scene(seed, B=3, spread=spread)
    fv[1, 3, 0, 0] = float("nan")
    fv[2, :50, :, :2] *= 40.0                # offscreen and screen-wide
    B, F = fv.shape[:2]
    al_fids, astarts = full_raster_bins(fv, S, RENDERER.sigma_val,
                                        RENDERER.dist_eps)
    T = astarts.shape[1] - 1
    assert torch.equal(reader.tile_counts(fv, S, RENDERER.sigma_val,
                                          RENDERER.dist_eps),
                       torch.as_tensor([[len(ids) for ids in tiles]
                                        for tiles in tile_lists(
                                            (al_fids, astarts), F)]))
    assert reader.least_bytes(fv, S, RENDERER.sigma_val,
                              RENDERER.dist_eps) == (
        B * (24 * F + 4 * (T + 1)) + 4 * int(astarts[:, -1].sum()))


def test_bins_roofline_reads_the_recorded_renders_over_the_kernels_time():
    from types import SimpleNamespace

    reader = _bins_roofline_reader()
    fv = spiky_scene(17, B=2)
    r = dict(fv=fv, S=S, sigma=RENDERER.sigma_val,
             dist_eps=RENDERER.dist_eps)
    recorder = SimpleNamespace(fwd=[r, r], bwd=[r])     # read from here
    nbytes = 3 * reader.least_bytes(fv, S, RENDERER.sigma_val,
                                    RENDERER.dist_eps)
    ops = [("void (anonymous namespace)::bins_count_kernel(...)", 0, 40.0),
           ("void (anonymous namespace)::bins_fill_kernel(...)", 0, 60.0),
           ("raster_fwd_kernel<0,0,0>", 0, 500.0)]
    got = reader.read(SimpleNamespace(kernel_ops=ops))
    assert got == pytest.approx(100 * nbytes / 3.35e12 / 100e-6)
    assert reader.read(SimpleNamespace(kernel_ops=ops[2:])) is None
    del recorder
    assert reader.read(SimpleNamespace(kernel_ops=ops)) is None


# ---- on the card ------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("seed,spread", [(17, 0.7), (18, 1.2), (19, 0.0)])
def test_bins_kernel_matches_plain_twin(cuda, seed, spread):
    fv = spiky_scene(seed, B=4, spread=spread, device=cuda)
    fv[1, 3, 0, 0] = float("nan")
    fv[2, :50, :, :2] *= 40.0                # offscreen and screen-wide
    F = fv.shape[1]
    tracing.reset()
    raster_bins.LAUNCHES = 0
    got = full_raster_bins(fv, S, RENDERER.sigma_val, RENDERER.dist_eps)
    counters = tracing.totals()["counters"]
    assert raster_bins.LAUNCHES == 1
    tracing.reset()
    want = full_raster_bins(fv.cpu(), S, RENDERER.sigma_val,
                            RENDERER.dist_eps)
    assert torch.equal(got[1].cpu(), want[1])
    n = int(want[1][:, -1].max())
    ends = want[1][:, -1:]
    pos = torch.arange(n)
    assert torch.equal(torch.where(pos < ends, got[0][:, :n].cpu(), F),
                       torch.where(pos < ends, want[0][:, :n], F))
    assert counters["raster.bins_entries"] == int(
        (want[0][:, :n][pos < ends] < F).sum())
    assert counters["raster.bins_dropped"] == 0
    assert raster_bins.LAUNCHES == 1         # the plain twin is no launch
    tracing.reset()


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["softmax", "hard"])
def test_spiky_render_on_full_bins_matches_plain(cuda, mode):
    """The forward kernel on the main path's bins against the plain route,
    which renders every face, on the spiky mesh at 512^2: rgba within
    4.8e-7 (a soft render) and face ids and depths equal (hard). With
    every reached face binned in ascending order, each pixel folds in its
    faces in the plain version's order, with the plain version's pair
    arithmetic (--fmad=false); what is left is the order of float32 sums
    over a chunk of faces, a few ulps of values in [0, 1]."""
    fv = spiky_scene(17, B=2, device=cuda)
    rng = np.random.default_rng(0)
    tex = torch.as_tensor(rng.uniform(0, 1, (2, fv.shape[1], 36, 3)),
                          dtype=torch.float32, device=cuda)
    kw = dict(image_size=S, sigma_val=RENDERER.sigma_val,
              dist_eps=RENDERER.dist_eps, gamma_val=RENDERER.gamma_val,
              aggr_func_rgb=mode)
    with torch.no_grad():
        out = raster_kernel.soft_rasterize_fwd(fv, tex, **kw)
        ref = soft_rasterize(fv, tex, **kw)
    if mode == "hard":
        cov = ref.aggr[:, 1] >= 0
        assert torch.equal(out.aggr[:, 1][cov], ref.aggr[:, 1][cov])
        assert torch.equal(out.aggr[:, 0][cov], ref.aggr[:, 0][cov])
    else:
        torch.testing.assert_close(out.rgba, ref.rgba, atol=4.8e-7, rtol=0)


@pytest.mark.cuda
def test_s1_step_bins_at_each_launch_and_drops_nothing(cuda):
    """One s1 step on the card bins its faces at each of its 3 forward and
    2 backward launches, inside the raster.bins span (the forward's inside
    the step's render passes), and drops no entry."""
    from umr_tpu_torch.cli import S1_DEFAULTS
    from umr_tpu_torch.config import Config
    from umr_tpu_torch.data import synthetic_batch
    from umr_tpu_torch.training import steps
    from umr_tpu_torch.training.trainer import prepare_batch

    cfg = Config(image_size=64, img_size=64, batch_size=2, subdivide=2,
                 tex_size=2, nz_feat=32, z_dim=24, **S1_DEFAULTS)
    *_, init_fn, step_fn, _, _ = steps.build_s1_step(
        cfg, build_template(2, 1, 2), cuda)
    batch = {k: torch.as_tensor(v, device=cuda) if isinstance(
        v, np.ndarray) else v for k, v in prepare_batch(synthetic_batch(
            np.random.RandomState(2), 2, 64)).items()}
    state = init_fn(0)
    step_fn(state, batch)                       # builds the kernels
    torch.cuda.synchronize()
    before = tracing.totals()
    raster_bins.LAUNCHES = 0
    tracing.start_recording()
    step_fn(state, batch)
    torch.cuda.synchronize()
    records = tracing.stop_recording()
    assert raster_bins.LAUNCHES == 5
    counters = tracing.delta(before)["counters"]
    bins = [p for n, p, _, _ in records if n == "raster.bins"]
    assert len(bins) == 5, records
    assert sum(p is not None and p.startswith("s1.pass") for p in bins) == 3
    assert counters["raster.bins_dropped"] == 0
    assert counters["raster.bins_entries"] > 0
