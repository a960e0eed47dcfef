"""The JAX package's tests of its host utilities and voxelizer
(tests/test_voxelize_geometry.py, tests/test_crf.py), run on the port's
functions (umr_tpu_torch/ops/voxelize.py, geometry.py, crf.py), and the
port's voxelizer held against umr_tpu.ops.voxelize voxel for voxel.

Voxel parity: the occupancy equals JAX's on test_voxelize_sphere's mesh
at R=24 and on 2 random meshes (30 faces in [0.1, 0.9]^3) at R=16,
surface and filled. Where a voxel differs, JAX's own margin to the
thresholds of its inside test there (|plane distance| - 0.87, and the
barycentrics' -1e-6) must be below 1e-5; the reading is 0 differing
voxels of 13,824 + 2 x 4,096.
"""

import numpy as np
import pytest
import torch

from umr_tpu_torch.crf import denseCRF
from umr_tpu_torch.geometry import (project_points_on_mesh,
                                    ray_triangle_intersect)
from umr_tpu_torch.mesh import build_template
from umr_tpu_torch.ops.voxelize import (fill_interior, voxelize,
                                         voxelize_surface)


def test_voxelize_sphere():
    t = build_template(subdivide=2, axis=1, tex_size=2)
    verts = (t.verts * 0.4 + 0.5)  # into [0.1, 0.9]
    fv = torch.as_tensor(verts[t.faces][None], dtype=torch.float32)
    occ = voxelize(fv, resolution=24, fill=True).numpy()[0]
    R = 24
    assert occ[R // 2, R // 2, R // 2]          # center filled
    assert not occ[0, 0, 0]                     # corner empty
    # volume close to sphere volume (4/3 pi r^3, r = 0.4*(R-1))
    r = 0.4 * (R - 1)
    expect = 4 / 3 * np.pi * r ** 3
    assert abs(occ.sum() - expect) / expect < 0.35


def test_ray_triangle():
    v0, v1, v2 = (np.array([0, 0, 1.0]), np.array([1, 0, 1.0]),
                  np.array([0, 1, 1.0]))
    hit, tt = ray_triangle_intersect(
        np.array([0.2, 0.2, 0.0]), np.array([0, 0, 1.0]), v0, v1, v2
    )
    assert hit and abs(tt - 1.0) < 1e-9
    hit, _ = ray_triangle_intersect(
        np.array([0.9, 0.9, 0.0]), np.array([0, 0, 1.0]), v0, v1, v2
    )
    assert not hit


def test_project_points_on_mesh():
    verts = np.array([[0, 0, 1.0], [1, 0, 1.0], [0, 1, 1.0]])
    faces = np.array([[0, 1, 2]])
    pts = np.array([[0.2, 0.2, 0.0], [0.9, 0.9, 0.0]])
    out = project_points_on_mesh(pts, verts, faces)
    np.testing.assert_allclose(out[0], [0.2, 0.2, 1.0], atol=1e-9)
    np.testing.assert_allclose(out[1], pts[1])  # miss -> unchanged


def _jax_margin(fv, R):
    """JAX's smallest margin over the faces to its inside test's
    thresholds, per voxel [B, R^3] (float64 from its float32 pieces)."""
    import jax.numpy as jnp

    fv = np.asarray(fv, np.float32) * (R - 1)
    c = np.arange(R, dtype=np.float32)
    grid = np.stack(np.meshgrid(c, c, c, indexing="ij"), -1).reshape(-1, 3)
    out = np.full((fv.shape[0], R ** 3), np.inf)
    for b in range(fv.shape[0]):
        for tri in fv[b]:
            tri = jnp.asarray(tri)
            n = jnp.cross(tri[1] - tri[0], tri[2] - tri[0])
            nn = n / jnp.maximum(jnp.linalg.norm(n), 1e-9)
            d = (grid - tri[0]) @ nn
            p = grid - d[:, None] * nn[None]
            e = jnp.stack([tri[1] - tri[0], tri[2] - tri[0]])
            g = e @ e.T
            rhs = (p - tri[0]) @ e.T
            det = g[0, 0] * g[1, 1] - g[0, 1] * g[1, 0]
            u = (rhs[:, 0] * g[1, 1] - rhs[:, 1] * g[0, 1]) / det
            v = (rhs[:, 1] * g[0, 0] - rhs[:, 0] * g[1, 0]) / det
            m = np.min(np.abs(np.stack([
                np.abs(d) - 0.87, u + 1e-6, v + 1e-6, 1 + 1e-6 - u - v])),
                axis=0)
            out[b] = np.minimum(out[b], m)
    return out


def _meshes():
    t = build_template(subdivide=2, axis=1, tex_size=2)
    rng = np.random.RandomState(0)
    return [((t.verts * 0.4 + 0.5)[t.faces][None].astype(np.float32), 24)] + [
        (rng.uniform(0.1, 0.9, (1, 30, 3, 3)).astype(np.float32), 16)
        for _ in range(2)]


@pytest.mark.parametrize("case", [0, 1, 2], ids=["sphere_R24", "random0_R16",
                                                 "random1_R16"])
def test_voxelize_matches_jax(case):
    """Surface, then filled (voxelize is fill_interior of the surface in
    both packages)."""
    from umr_tpu.ops.voxelize import fill_interior as jax_fill
    from umr_tpu.ops.voxelize import voxelize_surface as jax_surface

    fv, R = _meshes()[case]
    surf = jax_surface(fv, R)
    jax_occ = (np.asarray(surf), np.asarray(jax_fill(surf)))
    port_surf = voxelize_surface(torch.as_tensor(fv), R)
    port_occ = (port_surf.numpy(), fill_interior(port_surf).numpy())
    assert torch.equal(voxelize(torch.as_tensor(fv), R),
                       fill_interior(port_surf))
    for got, want in zip(port_occ, jax_occ):
        assert got.shape == want.shape == (1, R, R, R)
        diff = (got != want).reshape(1, -1)
        if diff.any():
            margin = _jax_margin(fv, R)
            assert (margin[diff] < 1e-5).all(), margin[diff]
        assert diff.sum() == 0, f"{diff.sum()} near-threshold voxels"


def test_voxelize_chunks_the_faces(monkeypatch):
    """Chunks of one face give the one-chunk occupancy."""
    from umr_tpu_torch.ops import voxelize as vox

    fv, R = _meshes()[1]
    whole = vox.voxelize(torch.as_tensor(np.concatenate([fv, fv[:, ::-1]])),
                         R)
    monkeypatch.setattr(vox, "CHUNK_ELEMENTS", R ** 3)
    assert torch.equal(vox.voxelize(torch.as_tensor(np.concatenate(
        [fv, fv[:, ::-1]])), R), whole)


def _label_probs(labels, n, conf=0.9):
    """One-hot-ish [N,H,W] softmax maps from an int label image."""
    H, W = labels.shape
    p = np.full((n, H, W), (1 - conf) / (n - 1), dtype=np.float32)
    for c in range(n):
        p[c][labels == c] = conf
    return p


def test_output_layout_and_normalization():
    rng = np.random.default_rng(0)
    pred = rng.dirichlet(np.ones(4), size=(17, 23)).transpose(2, 0, 1)
    out = denseCRF(None, pred)
    assert out.shape == (17, 23, 4)  # ref returns (H,W,N)
    assert out.dtype == np.float32
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out.sum(-1), 1.0, atol=1e-5)


def test_uniform_is_fixed_point():
    pred = np.full((3, 12, 12), 1 / 3, dtype=np.float32)
    out = denseCRF(None, pred)
    np.testing.assert_allclose(out, 1 / 3, atol=1e-6)


def test_confident_homogeneous_map_sharpens():
    # one class everywhere: CRF agreement should push prob toward 1
    pred = _label_probs(np.zeros((16, 16), np.int32), 3, conf=0.8)
    out = denseCRF(None, pred)
    assert (out.argmax(-1) == 0).all()
    assert out[..., 0].min() > 0.8


def test_cleans_salt_and_pepper_noise():
    rng = np.random.default_rng(1)
    clean = np.zeros((32, 32), np.int32)
    clean[:, 16:] = 1  # two half-plane regions
    noisy = clean.copy()
    flip = rng.random(clean.shape) < 0.15  # 15% label noise
    noisy[flip] = 1 - noisy[flip]
    pred = _label_probs(noisy, 2, conf=0.7)
    out = denseCRF(None, pred)
    refined = out.argmax(-1)
    err_before = (noisy != clean).mean()
    err_after = (refined != clean).mean()
    assert err_after < err_before / 3, (err_before, err_after)


def test_compat_zero_returns_unary_softmax():
    rng = np.random.default_rng(2)
    pred = rng.dirichlet(np.ones(5), size=(9, 9)).transpose(2, 0, 1)
    out = denseCRF(None, pred, compat=0.0)
    # softmax(-unary) = renormalized clipped input probs
    expect = np.clip(pred, 1e-5, 1.0)
    expect /= expect.sum(0, keepdims=True)
    np.testing.assert_allclose(out, expect.transpose(1, 2, 0), atol=1e-5)


@pytest.mark.parametrize("n_iters", [1, 5])
def test_boundary_stays_put(n_iters):
    # the half-plane boundary of a clean map must not drift
    clean = np.zeros((24, 24), np.int32)
    clean[:, 12:] = 1
    pred = _label_probs(clean, 2, conf=0.9)
    out = denseCRF(None, pred, n_iters=n_iters)
    assert (out.argmax(-1) == clean).all()
