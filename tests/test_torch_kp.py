"""Port parity of keypoint transfer (experiments/test_kp.py).

kp_heatmaps, map_kp_flow and map_kp_cam against the JAX functions, on
the golden inputs of tests/test_kp_transfer.py (ground-truth texture
flows and cameras of the subdivide-3 sphere), which the port's outputs
must also pass; then test_kp.run of both packages in flow and cam mode
on one stage-2 .pth (written by the JAX package's save_pth) and the same
pair loaders, at image 32, subdivide 2, tex_size 2.

The .pth pins the model's random draws: the VAE log-variance head is -40
(the noise equals its mean) and camera hypothesis 0 has logit 60 (drawn
with probability 1 - 1e-9), so both runs predict the same meshes and
cameras without sharing a generator.

The checkpoint also gives camera hypothesis 0 a generic pose (see
_s2_pth): at the seeded init every camera is the identity, which makes
exact ties of the nearest-pixel search.

Tolerances, from this file's readings:
  * heatmaps: atol 1e-6 (reading 1.5e-8);
  * transferred keypoints: the same face or pixel for every keypoint, so
    coordinates within 1e-5 (reading 1.8e-7: grid_sample's taps and the
    two linspace grids round apart at the last ulp);
  * PCK: within one keypoint of the count (1 / visible count of a
    keypoint, over the 15 keypoints' mean), for a transfer at a near tie
    (reading: equal in both modes).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_kp_transfer import cam7, front_faces, gt_tex_flow, project
from torch_parity import flax_variables
from umr_tpu.config import Config as JaxConfig
from umr_tpu.experiments import test_iou as jtest_iou
from umr_tpu.experiments import test_kp as jkp
from umr_tpu.mesh import build_template as jax_template
from umr_tpu.training import checkpoints as jckpt
from umr_tpu_torch.config import Config
from umr_tpu_torch.data import synthetic_batch
from umr_tpu_torch.experiments import test_kp
from umr_tpu_torch.mesh import build_template
from umr_tpu_torch.models import MeshNet, init_weights
from umr_tpu_torch.ops import raster_kernel
from umr_tpu_torch.ops.projection import orthographic_proj_withz

ATOL = 1e-5


@pytest.fixture(scope="module")
def template():
    return jax_template(3, 1, 6)


def _pp(verts, cams):
    return orthographic_proj_withz(verts, cams)[:, :, :2]


def test_kp_heatmaps_match_jax():
    kps = np.array([[3.2, 7.9], [-12.0, 5.0], [31.5, 0.4], [40.0, 38.0],
                    [-5.0, 20.0]], np.float32)
    got = test_kp.kp_heatmaps(torch.as_tensor(kps), 32, 3.0).numpy()
    want = np.asarray(jkp.kp_heatmaps(jnp.asarray(kps), 32, 3.0))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert got[1].max() == 0 and got[4].max() > 0     # 3 sigma outside


@pytest.mark.parametrize("same_cam", [False, True])
def test_map_kp_flow_matches_jax_golden(template, same_cam):
    verts = template.verts.astype(np.float32)
    faces = template.faces
    T = template.tex_size
    cam_a = cam7(10.0) if same_cam else cam7(25.0, 0.72, 0.05, -0.03)
    cam_b = cam_a if same_cam else cam7(-40.0, 0.65)
    fsel = (np.arange(len(faces)) if same_cam else np.intersect1d(
        front_faces(verts, faces, cam_a), front_faces(verts, faces, cam_b)))
    flow_a = gt_tex_flow(verts, faces[fsel], cam_a, T)
    flow_b = gt_tex_flow(verts, faces[fsel], cam_b, T)
    kp_idx = (np.arange(3, template.num_verts, 97) if same_cam
              else np.unique(faces[fsel])[::29])
    kp_a = np.asarray(project(verts[None], cam_a[None])[0])[kp_idx]
    kp_b_gt = np.asarray(project(verts[None], cam_b[None])[0])[kp_idx]
    kp_src = np.concatenate([kp_a, np.ones((len(kp_idx), 1))],
                            1).astype(np.float32)
    out = test_kp.map_kp_flow(torch.as_tensor(kp_src),
                              torch.as_tensor(flow_a),
                              torch.as_tensor(flow_b), 256).numpy()
    want = np.asarray(jkp.map_kp_flow(jnp.asarray(kp_src),
                                      jnp.asarray(flow_a),
                                      jnp.asarray(flow_b), 256))
    np.testing.assert_allclose(out, want, rtol=0, atol=ATOL)
    err = np.sqrt(((out - kp_b_gt) ** 2).sum(-1))
    # tests/test_kp_transfer.py's bars
    if same_cam:
        assert err.max() < 0.12 and np.median(err) < 0.05, err
    else:
        assert np.median(err) < 0.06 and err.max() < 0.15, err


@pytest.mark.parametrize("half_mask", [False, True])
def test_map_kp_cam_matches_jax_golden(template, half_mask):
    verts = template.verts.astype(np.float32)
    S = 64
    cam_a, cam_b = cam7(30.0, 0.7, -0.04, 0.02), cam7(-55.0, 0.75)
    kp_idx = np.arange(5, template.num_verts, 53)
    kp_a = np.asarray(project(verts[None], cam_a[None])[0])[kp_idx]
    kp_b_gt = np.asarray(project(verts[None], cam_b[None])[0])[kp_idx]
    kp_src = np.concatenate([kp_a, np.ones((len(kp_idx), 1))],
                            1).astype(np.float32)
    mask = np.ones((S, S), np.float32)
    if half_mask:
        mask[:, S // 2:] = 0.0
    out = test_kp.map_kp_cam(
        torch.as_tensor(kp_src), torch.as_tensor(cam_a),
        torch.as_tensor(cam_b), torch.as_tensor(mask),
        torch.as_tensor(verts), _pp, S).numpy()
    want = np.asarray(jkp.map_kp_cam(
        jnp.asarray(kp_src), jnp.asarray(cam_a), jnp.asarray(cam_b),
        jnp.asarray(mask), jnp.asarray(verts), project, S))
    np.testing.assert_allclose(out, want, rtol=0, atol=ATOL)
    if half_mask:
        assert (out[:, 0] <= 0.0).all()
    else:
        err = np.sqrt(((out - kp_b_gt) ** 2).sum(-1))
        assert err.max() < 2.0 * 2.0 / (S - 1), err


def _s2_pth(path, template):
    """A stage-2 .pth written by the JAX package's save_pth from a seeded
    port model, its draws pinned (module doc). Returns the variables."""
    model = init_weights(MeshNet(template, input_size=32, nz_feat=16,
                                 z_dim=8, num_hypo_cams=2),
                         torch.Generator().manual_seed(4))
    with torch.no_grad():
        model.encoder.logvar_fc[2].weight.zero_()
        model.encoder.logvar_fc[2].bias.fill_(-40.0)
        cam0 = model.cam_predictor.camera_predictor[0]
        cam0.prob_predictor.weight.zero_()
        cam0.prob_predictor.bias.fill_(60.0)
        # a generic pose: at the seeded init every camera is the identity
        # with a translation of ~1e-9, which puts the symmetric template's
        # mid-plane vertices half-way between two pixel columns, where the
        # two packages' linspace grids (1 ulp apart) break the tie apart
        cam0.quat_predictor.pred_layer.bias.copy_(
            torch.tensor([0.95, 0.1, 0.25, 0.05]))
        cam0.trans_predictor.pred_layer.bias.copy_(
            torch.tensor([0.0123, -0.0311]))
    v = flax_variables(model, template, 2)
    jckpt.save_pth(path, v["params"], v["template"],
                   batch_stats=v["batch_stats"])
    return v


class _Pairs:
    """Single-image batches for one side of the pairs."""

    def __init__(self, n, seed):
        self.n, self.seed = n, seed

    def __iter__(self):
        rng = np.random.RandomState(self.seed)
        for _ in range(self.n):
            yield synthetic_batch(rng, 1, 32)


@pytest.mark.parametrize("mode,pairs", [("flow", 18), ("cam", 7)])
def test_kp_run_matches_jax(tmp_path, monkeypatch, mode, pairs):
    """flow: 18 pairs, a whole group of 16 and one of 2 padded to 16; cam:
    7 pairs, one group of 7 (its 64^2 renders take the plain rasterizer
    ~1 s an image pair here)."""
    t = build_template(2, 1, 2)
    pth = str(tmp_path / "s2.pth")
    variables = _s2_pth(pth, t)
    # the JAX model.init (op by op) only gives load_pth the variables'
    # structure, which the .pth fills
    monkeypatch.setattr(jtest_iou.MeshNet, "init",
                        lambda self, *a, **k: variables)
    kw = dict(image_size=32, img_size=32, subdivide=2, tex_size=2,
              nz_feat=16, z_dim=8, num_hypo_cams=2, model_path=pth,
              mode=mode, number_pairs=pairs, seed=0, face_chunk=320,
              pixel_rows_per_block=64)
    loaders = lambda: (_Pairs(20, 1), _Pairs(20, 2))   # noqa: E731
    want = jkp.run(JaxConfig(**kw), loaders=loaders())
    before = raster_kernel.LAUNCHES
    got = test_kp.run(Config(**kw), loaders=loaders(), device="cpu")
    assert raster_kernel.LAUNCHES == before         # CPU: the plain version
    # pairs x 2 directions x 15 keypoints, all visible
    one_kp = 1.0 / (2 * pairs)
    for g, w in zip(got, want):
        assert abs(g - w) <= one_kp / 15 + 1e-7, (got, want)
    assert 0.0 <= got[0] <= got[1] <= 1.0
    with pytest.raises(NotImplementedError, match="visualize"):
        test_kp.run(Config(**kw, visualize=True), loaders=loaders(),
                    device="cpu")
