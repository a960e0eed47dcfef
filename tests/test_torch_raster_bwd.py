"""Port parity of the rasterizer's backward: the plain backward
(ops/rasterize_bwd.py, the CUDA backward kernel's plain version) and the
autograd Function's CPU route (ops/raster_kernel.py::soft_rasterize_fwd)
against jax.vjp of the JAX package's Pallas kernel in interpret mode and
against tests/golden_raster.py's literal port of the reference CUDA
backward.

Tolerance: max |diff| <= 2e-4 x the largest gradient of the case. Reading
(this file's default scene): plain vs Pallas 1.5e-3 on vertex gradients
up to 48.4 (3.1e-5 of the largest) and 5.7e-5 on texel gradients up to
13.0 (4.4e-6); plain vs golden 1.1e-3 / 4.6e-5. The sums run in other
orders (Pallas segment-sums per entry, the plain version per face chunk).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golden_raster import golden_soft_rasterize, golden_soft_rasterize_backward
from torch_parity import np_of, random_scene, t_of
from umr_tpu.ops.raster_kernel import soft_rasterize_pallas
from umr_tpu_torch.ops import raster_kernel
from umr_tpu_torch.ops.rasterize import soft_rasterize
from umr_tpu_torch.ops.rasterize_bwd import soft_rasterize_bwd

S = 32
KW = dict(image_size=S, sigma_val=3e-3, gamma_val=1e-2, dist_eps=1e-4)
BG = (0.1, 0.2, 0.3)
# a bin cap above the scenes' needs, so the Pallas kernel truncates nothing
PALLAS = dict(tile_size=16, mf_cap=32, max_cover=2, interpret=True)
REL = 2e-4
MODES = [{}, {"rgb_geom_detach": True}, {"tex_grads": False},
         {"mask_only": True}]
IDS = ["default", "rgb_geom_detach", "no_tex_grads", "mask_only"]


def _jax_grads(faces, tex, g, **opts):
    def loss(fv, tx):
        out = soft_rasterize_pallas(fv, tx, background_color=BG, **PALLAS,
                                    **opts, **KW)
        return jnp.sum(out.rgba * g)

    gf, gt = jax.grad(loss, argnums=(0, 1))(jnp.asarray(faces),
                                            jnp.asarray(tex))
    return np.asarray(gf), np.asarray(gt)


def _plain_grads(faces, tex, g, **opts):
    fv, tx = t_of(faces), t_of(tex)
    out = soft_rasterize(fv, tx, background_color=BG,
                         mask_only=opts.get("mask_only", False), **KW)
    gf, gt = soft_rasterize_bwd(fv, tx, out.rgba, out.aggr, t_of(g), **opts,
                                **KW)
    return np_of(gf), np_of(gt)


def _function_grads(faces, tex, g, **opts):
    """The card's route on the CPU: the autograd Function, its forward and
    backward the kernels' plain versions."""
    fv = t_of(faces).requires_grad_()
    tx = t_of(tex).requires_grad_()
    before = raster_kernel.BWD_LAUNCHES
    out = raster_kernel.soft_rasterize_fwd(fv, tx, background_color=BG,
                                           **opts, **KW)
    (out.rgba * t_of(g)).sum().backward()
    assert raster_kernel.BWD_LAUNCHES == before      # CPU: no kernel
    return np_of(fv.grad), np_of(tx.grad)


def _close(actual, desired):
    scale = np.abs(desired).max()
    np.testing.assert_allclose(actual, desired, rtol=0,
                               atol=REL * scale + 1e-30)


def _scene(rng):
    faces, tex = random_scene(rng, B=1, F=5, T2=16)
    g = rng.standard_normal((1, S, S, 4)).astype(np.float32)
    return faces, tex, g


@pytest.mark.parametrize("opts", MODES, ids=IDS)
def test_backward_matches_jax_pallas(rng, opts):
    faces, tex, g = _scene(rng)
    jf, jt = _jax_grads(faces, tex, g, **opts)
    for pf, pt in (_plain_grads(faces, tex, g, **opts),
                   _function_grads(faces, tex, g, **opts)):
        _close(pf, jf)
        if opts.get("tex_grads", True) and not opts.get("mask_only"):
            _close(pt, jt)
            assert np.abs(pt).max() > 0
        else:                   # no texel gradient at all
            np.testing.assert_array_equal(pt, 0.0)
            np.testing.assert_array_equal(jt, 0.0)


def test_backward_matches_golden(rng):
    faces, tex, g = _scene(rng)
    rgba, _, aggr = golden_soft_rasterize(faces, tex, background_color=BG,
                                          **KW)
    gf, gt = golden_soft_rasterize_backward(faces, tex, rgba, aggr, g, **KW)
    pf, pt = _plain_grads(faces, tex, g)
    _close(pf, gf)
    _close(pt, gt)


def test_depth_gate(rng):
    """A face straddling `near` gets no gradient from its pixels whose
    interpolated depth is below near, its alpha path included; a face
    wholly in front of near, or beyond far, gets none at all, though both
    cover pixels. The exp argument of a gated pair is masked first, so
    every gradient stays finite."""
    faces, tex, g = _scene(rng)
    faces = np.concatenate([faces, faces[:, :3]], axis=1)
    tex = np.concatenate([tex, tex[:, :3]], axis=1)
    faces[0, 5, :, 2] = (0.5, 1.5, 1.5)       # straddles near = 1
    faces[0, 6, :, 2] = 0.6                   # in front of near
    faces[0, 7, :, 2] = 150.0                 # beyond far = 100
    out = soft_rasterize(t_of(faces), t_of(tex), **KW)
    assert np_of(out.rgba[..., 3]).max() > 0.5
    jf, jt = _jax_grads(faces, tex, g)
    rgba, _, aggr = golden_soft_rasterize(faces, tex, background_color=BG,
                                          **KW)
    gf, gt = golden_soft_rasterize_backward(faces, tex, rgba, aggr, g, **KW)
    for pf, pt in (_plain_grads(faces, tex, g),
                   _function_grads(faces, tex, g)):
        assert np.isfinite(pf).all() and np.isfinite(pt).all()
        _close(pf, jf)
        _close(pt, jt)
        _close(pf, gf)
        assert np.abs(pf[0, 5]).max() > 0
        np.testing.assert_array_equal(pf[0, 6:], 0.0)
        np.testing.assert_array_equal(pt[0, 6:], 0.0)


def test_hard_mode_has_no_backward(rng):
    faces, tex, g = _scene(rng)
    fv = t_of(faces).requires_grad_()
    tx = t_of(tex).requires_grad_()
    out = raster_kernel.soft_rasterize_fwd(fv, tx, aggr_func_rgb="hard",
                                           background_color=BG, **KW)
    (out.rgba * t_of(g)).sum().backward()
    np.testing.assert_array_equal(np_of(fv.grad), 0.0)
    np.testing.assert_array_equal(np_of(tx.grad), 0.0)
