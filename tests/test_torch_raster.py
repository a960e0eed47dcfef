"""Port parity: face->tile bins, the rasterizer's plain version, the
renderer.

Tolerances:
  * bins: exactly equal (integer layout the kernel walks).
  * rgba: atol 5e-4 (as tests/test_kernel_interpret.py against the golden
    oracle); softmax max aggr[:,1]: atol 1e-5.
  * softmax sum aggr[:,0], against the XLA dense path and the Pallas
    kernel alike: rtol 1e-4 on pixels a face covers (alpha > 0.5), rtol
    1e-3 on the others. Outside every face the sum is one soft-edge
    fragment, sigmoid(-d/sigma) ~ 1e-4..1e-2, whose relative error is
    the error of d over sigma: float32 itself cannot do better there.
    Readings on the softmax scene (covered / other pixels): plain vs
    Pallas 2.4e-5 / 4.3e-4, plain vs dense 3.8e-5 / 5.1e-4; against a
    float64 run of the plain version, the plain float32 run is off by
    2.4e-5 / 4.0e-4, the JAX dense path by 2.0e-5 / 2.7e-4 and the
    Pallas kernel by 1.4e-5 / 2.0e-4. So rtol 1e-5 would fail every
    float32 path, JAX's included, against exact arithmetic.
  * hard-mode face ids: exactly equal to the Pallas kernel's.
  * renderer (sigma 1e-5): rgba atol 5e-4 on all but 0.1% of values, the
    rest within 1e-2 (see torch_parity.assert_close_except_slivers);
    readings: 5 of 8,192 values over 5e-4 in either mode, the largest
    4.0e-3.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golden_raster import golden_soft_rasterize
from torch_parity import (assert_close_except_slivers, np_of, random_scene,
                          t_of)
from umr_tpu.ops import raster_kernel as jrk
from umr_tpu.ops.rasterize import soft_rasterize as jax_dense
from umr_tpu.renderer import SoftRenderer as JaxRenderer
from umr_tpu_torch.ops import raster_kernel
from umr_tpu_torch.ops.raster_bins import compute_raster_bins
from umr_tpu_torch.ops.rasterize import soft_rasterize
from umr_tpu_torch.renderer import SoftRenderer

S = 32
KW = dict(image_size=S, sigma_val=3e-3, gamma_val=1e-2, dist_eps=1e-4,
          background_color=(0.1, 0.2, 0.3))
PALLAS = dict(tile_size=16, mf_cap=32, max_cover=2, interpret=True)
PLAIN = dict(face_chunk=4, pixel_rows_per_block=8)


@pytest.mark.parametrize("B,S_,ts,mf_cap,entry_cap", [
    (2, 32, 16, 32, None),     # small image, few tiles
    (2, 64, 16, 8, None),      # mf_cap truncation bites
    (2, 64, 32, 32, 40),       # entry_cap truncation bites
    (3, 64, 32, 64, None),     # production tile size
])
def test_bins_match_jax(B, S_, ts, mf_cap, entry_cap):
    rng = np.random.default_rng(S_ + ts + mf_cap)
    F = 60
    fv = (rng.standard_normal((B, F, 3, 3)) * 0.6).astype(np.float32)
    fv[..., 2] += 5.0
    fv[:, :4, :, 0] += 10.0      # offscreen faces
    fv[:, 4:30] *= 0.15          # a crowd in the middle tiles
    args = (S_, ts, 1e-5, 1e-10, mf_cap, 4, entry_cap)
    j_fids, j_starts = jrk.compute_raster_bins(jnp.asarray(fv), *args)
    t_fids, t_starts = compute_raster_bins(t_of(fv), *args)
    assert t_fids.dtype == torch.int32 and t_starts.dtype == torch.int32
    np.testing.assert_array_equal(np_of(t_starts), np_of(j_starts))
    np.testing.assert_array_equal(np_of(t_fids), np_of(j_fids))
    counts = np.diff(np_of(j_starts), axis=1)
    assert counts.max() <= -(-mf_cap // 8) * 8


def _plain(faces, tex, **kw):
    return soft_rasterize(t_of(faces), t_of(tex), **PLAIN, **KW, **kw)


def _check_sum(ref, out):
    """Softmax sum: rtol 1e-4 where a face covers the pixel, 1e-3 where
    the sum is soft-edge fragments only (see the module docstring)."""
    s, s_ref = np_of(out.aggr[:, 0]), np_of(ref.aggr[:, 0])
    cov = np_of(ref.rgba[..., 3]) > 0.5
    assert cov.any() and not cov.all()
    np.testing.assert_allclose(s[cov], s_ref[cov], rtol=1e-4)
    np.testing.assert_allclose(s[~cov], s_ref[~cov], rtol=1e-3)


def _check_softmax(ref, out, channels=slice(0, 4)):
    np.testing.assert_allclose(np_of(out.rgba[..., channels]),
                               np_of(ref.rgba[..., channels]), atol=5e-4)
    np.testing.assert_allclose(np_of(out.aggr[:, 1]), np_of(ref.aggr[:, 1]),
                               atol=1e-5)
    _check_sum(ref, out)


@pytest.mark.parametrize("mode", ["softmax", "hard"])
def test_plain_matches_jax_dense(rng, mode):
    faces, tex = random_scene(rng)
    ref = jax_dense(jnp.asarray(faces), jnp.asarray(tex),
                    aggr_func_rgb=mode, **KW)
    out = _plain(faces, tex, aggr_func_rgb=mode)
    if mode == "softmax":
        _check_softmax(ref, out)
    else:
        np.testing.assert_allclose(np_of(out.rgba), np_of(ref.rgba),
                                   atol=5e-4)
        np.testing.assert_array_equal(np_of(out.aggr[:, 1]),
                                      np_of(ref.aggr[:, 1]))


@pytest.mark.parametrize("mode", ["softmax", "mask_only", "hard"])
def test_plain_matches_pallas_interpret(rng, mode):
    faces, tex = random_scene(rng)
    kw = dict(aggr_func_rgb="hard" if mode == "hard" else "softmax",
              mask_only=mode == "mask_only")
    ref = jrk.soft_rasterize_pallas(jnp.asarray(faces), jnp.asarray(tex),
                                    need_p2f=False, **PALLAS, **KW, **kw)
    out = _plain(faces, tex, **kw)
    if mode == "hard":
        np.testing.assert_allclose(np_of(out.rgba), np_of(ref.rgba),
                                   atol=5e-4)
        np.testing.assert_array_equal(np_of(out.aggr[:, 1]),
                                      np_of(ref.aggr[:, 1]))
        np.testing.assert_allclose(np_of(out.aggr[:, 0]),
                                   np_of(ref.aggr[:, 0]), rtol=1e-6)
    elif mode == "softmax":
        _check_softmax(ref, out)
    else:
        # mask_only: the TPU kernel leaves its rgb rows unnormalised
        # (callers read alpha only); the port writes the background
        _check_softmax(ref, out, channels=slice(3, 4))
        np.testing.assert_allclose(
            np_of(out.rgba[..., :3]),
            np.broadcast_to([0.1, 0.2, 0.3], out.rgba[..., :3].shape),
            atol=1e-6)


def test_plain_softmax_sum_near_float64(rng):
    """The plain version's float32 sum against its own float64 run, at
    the limits held against JAX: the port adds no error of its own."""
    faces, tex = random_scene(rng)
    out = _plain(faces, tex)
    exact = soft_rasterize(torch.tensor(faces, dtype=torch.float64),
                           torch.tensor(tex, dtype=torch.float64),
                           **PLAIN, **KW)
    _check_sum(exact, out)


def test_plain_matches_golden(rng):
    faces, tex = random_scene(rng, B=1, F=5)
    g_rgba, _, g_aggr = golden_soft_rasterize(faces, tex, **KW)
    out = _plain(faces, tex)
    np.testing.assert_allclose(np_of(out.rgba), g_rgba, atol=5e-4)
    np.testing.assert_allclose(np_of(out.aggr[:, 1]), g_aggr[:, 1],
                               atol=1e-5)


def test_wrapper_on_cpu_is_the_plain_version(rng):
    """A CPU tensor takes the plain version and launches nothing; asked
    for p2f, it runs the plain version one face per chunk (the kernel's
    p2f rule)."""
    faces, tex = random_scene(rng, B=1)
    before = (raster_kernel.LAUNCHES, raster_kernel.P2F_LAUNCHES)
    out = raster_kernel.soft_rasterize_fwd(t_of(faces), t_of(tex), **KW)
    ref = soft_rasterize(t_of(faces), t_of(tex), **KW)
    np.testing.assert_array_equal(np_of(out.rgba), np_of(ref.rgba))
    assert not out.p2f.any()
    out = raster_kernel.soft_rasterize_fwd(t_of(faces), t_of(tex),
                                           need_p2f=True, **KW)
    ref = soft_rasterize(t_of(faces), t_of(tex), face_chunk=1,
                         need_p2f=True, **KW)
    assert (raster_kernel.LAUNCHES, raster_kernel.P2F_LAUNCHES) == before
    np.testing.assert_array_equal(np_of(out.p2f), np_of(ref.p2f))
    np.testing.assert_array_equal(np_of(out.rgba), np_of(ref.rgba))


def _mesh(rng, B=2):
    from umr_tpu.mesh import build_template

    t = build_template(2, 1, 2)
    verts = (t.verts[None] * rng.uniform(0.8, 1.2, (B, 1, 3))).astype(
        np.float32)
    q = rng.standard_normal((B, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    cams = np.concatenate([rng.uniform(0.5, 0.8, (B, 1)),
                           rng.uniform(-0.2, 0.2, (B, 2)), q],
                          axis=1).astype(np.float32)
    return t, verts, cams


@pytest.mark.parametrize("mode", ["softmax", "hard_lit"])
def test_renderer_matches_jax(rng, mode):
    """image 32 with anti-aliasing (a 64^2 render)."""
    t, verts, cams = _mesh(rng)
    if mode == "softmax":
        kw, tex = dict(render_type="softmax"), None
    else:
        kw = dict(render_type="hard", background_color=(1.0, 1.0, 1.0),
                  ambient_intensity=0.8, directional_intensity=0.4,
                  light_direction=(0.0, 1.0, -1.0))
        tex = rng.uniform(0, 1, (2, t.faces.shape[0], 4, 3)).astype(
            np.float32)
    ref = JaxRenderer(image_size=32, **kw).render(
        jnp.asarray(verts), jnp.asarray(t.faces), jnp.asarray(cams),
        None if tex is None else jnp.asarray(tex))
    out = SoftRenderer(image_size=32, **kw).render(
        t_of(verts), t_of(t.faces), t_of(cams),
        None if tex is None else t_of(tex))
    assert out.rgba.shape == (2, 32, 32, 4)
    assert_close_except_slivers(np_of(out.rgba), np_of(ref.rgba), atol=5e-4,
                                frac=1e-3, cap=1e-2)
    assert np_of(out.rgba[..., 3]).max() > 0.5


@pytest.mark.parametrize("image_size,anti_aliasing,num_faces", [
    (256, True, 1280), (32, True, 320), (16, True, 1280), (64, False, 5000),
])
def test_kernel_cap_sized_as_jax(image_size, anti_aliasing, num_faces):
    assert (SoftRenderer(image_size, anti_aliasing=anti_aliasing)
            .resolved_mf_cap(num_faces)
            == JaxRenderer(image_size, anti_aliasing=anti_aliasing)
            .resolved_mf_cap(num_faces))
