"""Port parity of p2f, the rasterizer's per-face expected image coordinate
(the stage-1 texture-cycle target): the plain version's two rules, the
kernels' route (the autograd Function, through its plain version on the
CPU), and the renderer.

p2f depends on the order faces are visited (ops/rasterize.py): a pair is
weighted against the pixel's running max after its face chunk. At
face_chunk=1 that is the reference CUDA kernel's rule (the port's kernel,
tests/golden_raster.py); at face_chunk=F the JAX package's dense rule;
the TPU kernel takes the max after each group of 8 entries. Each pair of
paths is held under the rule they share; the TPU kernel only where depth
is constant, where all three agree.

Tolerances, in grid units (p2f lies in [-1, 1]), from this file's
scene: plain against JAX dense at the same face_chunk atol 1e-5
(readings 1.3e-7 at chunk 1, 1.8e-7 at chunk F); the plain version's
face_chunk=1 rule against the golden oracle atol 1e-5 (reading 1.8e-7);
the Function against the Pallas kernel at constant depth atol 1e-5
(reading 1.8e-7). Every face of the scene has a weight sum (sum of
contrib) at least 0.069 of the largest (0.098 at constant depth), so the
normalisation is stable.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from golden_raster import golden_soft_rasterize
from torch_parity import np_of, random_scene, t_of
from umr_tpu.ops import raster_kernel as jrk
from umr_tpu.ops.rasterize import soft_rasterize as jax_dense
from umr_tpu_torch.mesh import build_template
from umr_tpu_torch.ops import raster_kernel
from umr_tpu_torch.ops.rasterize import soft_rasterize
from umr_tpu_torch.renderer import SoftRenderer

S = 32
F = 6
KW = dict(image_size=S, sigma_val=3e-3, gamma_val=1e-2, dist_eps=1e-4)
ATOL = 1e-5


@pytest.fixture
def scene():
    return random_scene(np.random.RandomState(11), B=2, F=F, T2=16)


@pytest.mark.parametrize("face_chunk", [1, F])
def test_plain_p2f_matches_jax_dense(scene, face_chunk):
    faces, tex = scene
    ref = jax_dense(jnp.asarray(faces), jnp.asarray(tex),
                    face_chunk=face_chunk, **KW)
    out = soft_rasterize(t_of(faces), t_of(tex), face_chunk=face_chunk,
                         need_p2f=True, **KW)
    np.testing.assert_allclose(np_of(out.p2f), np.asarray(ref.p2f), rtol=0,
                               atol=ATOL)
    # the rule matters on this scene: the two chunkings differ
    other = soft_rasterize(t_of(faces), t_of(tex),
                           face_chunk=F + 1 - face_chunk, need_p2f=True, **KW)
    assert np.abs(np_of(other.p2f) - np_of(out.p2f)).max() > 1e-3


def test_plain_face_chunk_1_matches_golden(scene):
    faces, tex = scene
    _, g_p2f, _ = golden_soft_rasterize(faces, tex, **KW)
    out = soft_rasterize(t_of(faces), t_of(tex), face_chunk=1,
                         need_p2f=True, **KW)
    np.testing.assert_allclose(np_of(out.p2f), g_p2f, rtol=0, atol=ATOL)
    # hard mode and need_p2f=False write none
    for kw in (dict(aggr_func_rgb="hard", need_p2f=True), {}):
        z = soft_rasterize(t_of(faces), t_of(tex), face_chunk=1, **kw, **KW)
        assert not z.p2f.any()


def test_kernel_route_matches_pallas_at_constant_depth(scene):
    faces, tex = scene
    faces[..., 2] = 7.0
    ref = jrk.soft_rasterize_pallas(
        jnp.asarray(faces), jnp.asarray(tex), tile_size=16, mf_cap=32,
        max_cover=2, interpret=True, need_p2f=True, **KW)
    n0 = raster_kernel.P2F_LAUNCHES
    out = raster_kernel.soft_rasterize_fwd(t_of(faces), t_of(tex),
                                           need_p2f=True, **KW)
    assert raster_kernel.P2F_LAUNCHES == n0      # the plain version ran
    np.testing.assert_allclose(np_of(out.p2f), np.asarray(ref.p2f), rtol=0,
                               atol=ATOL)


def _grads(fn, faces, tex, g):
    fv = t_of(faces).requires_grad_()
    tx = t_of(tex).requires_grad_()
    out = fn(fv, tx)
    (out.rgba * g).sum().backward()
    return out, fv.grad, tx.grad


@pytest.mark.parametrize("route", ["plain", "function"])
def test_p2f_carries_no_gradient(scene, route):
    """rgba's gradients are those of the render without p2f: exactly on
    the plain route (p2f is summed outside autograd); on the Function to
    rtol 1e-5 (its p2f forward runs face_chunk=1, whose rgba sums run in
    another order; reading 1.5e-7 of the largest gradient)."""
    faces, tex = scene
    g = t_of(np.random.RandomState(2).standard_normal((2, S, S, 4))
             .astype(np.float32))
    if route == "plain":
        def fn(p2f):
            return lambda fv, tx: soft_rasterize(fv, tx, need_p2f=p2f, **KW)
    else:
        def fn(p2f):
            return lambda fv, tx: raster_kernel.soft_rasterize_fwd(
                fv, tx, need_p2f=p2f, **KW)
    on, gf1, gt1 = _grads(fn(True), faces, tex, g)
    off, gf0, gt0 = _grads(fn(False), faces, tex, g)
    assert on.p2f.abs().max() > 0 and not on.p2f.requires_grad
    for a, b in ((gf1, gf0), (gt1, gt0)):
        if route == "plain":
            np.testing.assert_array_equal(np_of(a), np_of(b))
        else:
            np.testing.assert_allclose(np_of(a), np_of(b), rtol=0,
                                       atol=1e-5 * np.abs(np_of(b)).max())


@pytest.mark.parametrize("impl", ["auto", "kernel"])
def test_anti_aliasing_keeps_the_render_size_p2f(impl):
    """With anti-aliasing p2f is the one taken at render_size."""
    template = build_template(1, 1, 2)
    rng = np.random.RandomState(4)
    verts = t_of(template.verts[None] * rng.uniform(0.8, 1.2, (1, 1, 3))
                 .astype(np.float32))
    cams = t_of(np.array([[0.7, 0.05, -0.05, 0.9, 0.3, 0.2, 0.1]],
                         np.float32))
    faces = t_of(template.faces)
    tex = t_of(rng.uniform(0, 1, (1, faces.shape[0], 4, 3))
               .astype(np.float32))
    common = dict(sigma_val=1e-4, gamma_val=1e-2, impl=impl,
                  ambient_intensity=1.0, directional_intensity=0.0)
    aa = SoftRenderer(image_size=16, anti_aliasing=True, **common).render(
        verts, faces, cams, tex, need_p2f=True)
    big = SoftRenderer(image_size=32, anti_aliasing=False, **common).render(
        verts, faces, cams, tex, need_p2f=True)
    assert aa.rgba.shape == (1, 16, 16, 4)
    assert aa.p2f.abs().max() > 0
    np.testing.assert_array_equal(np_of(aa.p2f), np_of(big.p2f))
