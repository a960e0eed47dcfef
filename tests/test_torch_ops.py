"""Port parity: quaternions, projection, grid sampling (atol 1e-6: the
same float32 formulas, one rounding each)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import np_of, t_of
from umr_tpu.ops import grid_sample as jgs
from umr_tpu.ops import projection as jproj
from umr_tpu.ops import quaternion as jq
from umr_tpu_torch.ops import grid_sample as tgs
from umr_tpu_torch.ops import projection as tproj
from umr_tpu_torch.ops import quaternion as tq

ATOL = 1e-6


def _quats(rng, n):
    q = rng.standard_normal((n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def test_hamilton_and_rotate(rng):
    qa, qb = _quats(rng, 5), _quats(rng, 5)
    np.testing.assert_allclose(
        np_of(tq.hamilton_product(t_of(qa), t_of(qb))),
        np_of(jq.hamilton_product(jnp.asarray(qa), jnp.asarray(qb))),
        atol=ATOL)
    X = rng.standard_normal((5, 7, 3)).astype(np.float32)
    np.testing.assert_allclose(
        np_of(tq.quat_rotate(t_of(X), t_of(qa))),
        np_of(jq.quat_rotate(jnp.asarray(X), jnp.asarray(qa))), atol=ATOL)


def test_axis_angle_to_quat(rng):
    axis = rng.standard_normal((4, 3)).astype(np.float32)
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    ang = rng.uniform(-3, 3, 4).astype(np.float32)
    np.testing.assert_allclose(
        np_of(tq.axis_angle_to_quat(t_of(axis), t_of(ang))),
        np_of(jq.axis_angle_to_quat(jnp.asarray(axis), jnp.asarray(ang))),
        atol=ATOL)


@pytest.mark.parametrize("offset_z", [0.0, 5.0])
def test_orthographic_proj_withz(rng, offset_z):
    X = rng.standard_normal((3, 11, 3)).astype(np.float32)
    cam = np.concatenate(
        [rng.uniform(0.5, 1.5, (3, 1)), rng.uniform(-0.3, 0.3, (3, 2)),
         _quats(rng, 3)], axis=1).astype(np.float32)
    np.testing.assert_allclose(
        np_of(tproj.orthographic_proj_withz(t_of(X), t_of(cam), offset_z)),
        np_of(jproj.orthographic_proj_withz(jnp.asarray(X), jnp.asarray(cam),
                                            offset_z)),
        atol=ATOL)


def test_grid_sample_and_textures(rng):
    """Includes taps beyond [-1, 1] (zero padding) and the exact borders."""
    img = rng.uniform(0, 1, (2, 9, 13, 3)).astype(np.float32)
    grid = rng.uniform(-1.2, 1.2, (2, 5, 7, 2)).astype(np.float32)
    grid[0, 0, :4] = [[-1, -1], [1, 1], [-1, 1], [1, -1]]
    np.testing.assert_allclose(
        np_of(tgs.grid_sample(t_of(img), t_of(grid))),
        np_of(jgs.grid_sample(jnp.asarray(img), jnp.asarray(grid))),
        atol=ATOL)
    flow = rng.uniform(-1, 1, (2, 6, 3, 3, 2)).astype(np.float32)
    np.testing.assert_allclose(
        np_of(tgs.sample_textures(t_of(flow), t_of(img))),
        np_of(jgs.sample_textures(jnp.asarray(flow), jnp.asarray(img))),
        atol=ATOL)
    assert torch.is_tensor(tgs.grid_sample(t_of(img), t_of(grid)))


def test_ang2quat_and_rotate_cam(rng):
    ang = rng.standard_normal((4, 3)).astype(np.float32)
    np.testing.assert_allclose(np_of(tq.ang2quat(t_of(ang))),
                               np_of(jq.ang2quat(jnp.asarray(ang))),
                               atol=ATOL)
    cam = np.concatenate([rng.uniform(0.5, 1.5, (4, 3)), _quats(rng, 4)],
                         axis=1).astype(np.float32)
    deg = rng.randint(0, 180, 4)
    for axis in ((0.0, 1.0, 0.0), (1.0, 2.0, -0.5)):
        np.testing.assert_allclose(
            np_of(tq.rotate_cam(t_of(cam), torch.as_tensor(deg), axis)),
            np_of(jq.rotate_cam(jnp.asarray(cam), jnp.asarray(deg), axis)),
            atol=ATOL)
