"""Port parity of avg_uv (experiments/avg_uv.py) and of train_s2's
semantic template read back from avg_uv's files.

The UV transfer, the top-5 averaging, the label derivation and the
most-frequent rule against the JAX functions on the same numpy inputs;
then avg_uv.run of both packages on one stage-1 .pth that the JAX
package's checkpoints.save_pth wrote, at image 32 (64^2 anti-aliased
renders), subdivide 2, tex_size 2, over the same two batches (whose part
maps are the image's quadrants).

The .pth's VAE log-variance head is set to -40 (std 2e-9): the VAE noise
then equals its mean on both sides, so the two runs score the same
meshes without sharing a random generator (the draws are held apart:
tests/test_torch_models.py::test_generator_draws_are_seeded).

Tolerances, from this file's readings:
  * uv_transfer (bilinear taps): atol 1e-6 (reading 1.2e-7);
    average_uv_maps on equal fp16 maps: atol 1e-6 (reading 0);
  * labels: equal wherever the JAX texel's best channel leads the second
    by more than 1e-4 (the sampling's float differences are ~1e-7), and
    faces and vertices equal where all their texels are decided so;
  * pass 1 scores: rtol 2e-4 (reading 1.8e-5; the renders' silhouettes
    differ at a few sliver pixels between XLA's dense path and the port's
    plain one, tests/test_torch_raster.py); the same exemplar ranking;
  * pass 1's UV part maps (fp16): atol 1e-3 (reading 4.9e-4, one fp16 ulp
    of a value in [0.5, 1));
  * pass 2 given the JAX run's exemplar index: semantic_prob within 5e-4
    (reading 8.1e-5), seg and part vertex sets equal.
"""

import os
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import flax_variables
from umr_tpu.config import Config as JaxConfig
from umr_tpu.experiments import avg_uv as javg
from umr_tpu.experiments import train_s2 as jtrain_s2
from umr_tpu.mesh import build_template as jax_template
from umr_tpu.training import checkpoints as jckpt
from umr_tpu_torch.config import Config
from umr_tpu_torch.data import synthetic_batch
from umr_tpu_torch.experiments import avg_uv, train_s2
from umr_tpu_torch.mesh import build_template
from umr_tpu_torch.models import MeshNetS1, init_weights
from umr_tpu_torch.models.weights import WEIGHTS_DIR
from umr_tpu_torch.png import read_png

IMG = 32
KW = dict(image_size=IMG, img_size=IMG, batch_size=3, subdivide=2,
          tex_size=2, nz_feat=16, z_dim=8, seed=0)
MARGIN = 1e-4


@pytest.fixture(scope="module")
def template():
    return build_template(2, 1, 2)


def test_uv_transfer_and_average_match_jax():
    rng = np.random.RandomState(0)
    prob = rng.uniform(0, 1, (3, 16, 16, 5)).astype(np.float32)
    flow = rng.uniform(-1.1, 1.1, (3, 8, 16, 2)).astype(np.float32)
    got = avg_uv.uv_transfer(torch.as_tensor(prob), torch.as_tensor(flow))
    want = np.asarray(javg.uv_transfer(jnp.asarray(prob), jnp.asarray(flow)))
    assert got.shape == want.shape == (3, 5, 8, 16)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)

    maps = rng.uniform(0, 1, (13, 5, 8, 16)).astype(np.float16)
    for sizes, ex in (([4, 4, 5], 6), ([13], 0), ([2, 9, 2], 12)):
        np.testing.assert_allclose(
            avg_uv.average_uv_maps(maps, sizes, ex),
            javg.average_uv_maps(maps, sizes, ex), rtol=0, atol=1e-6)


def test_most_freq_matches_jax():
    rng = np.random.RandomState(1)
    arr = rng.randint(0, 5, (40, 9))
    arr[0] = [3, 3, 1, 1, 2, 2, 0, 4, 4]          # ties: the smallest wins
    np.testing.assert_array_equal(avg_uv._most_freq(arr),
                                  javg._most_freq(arr))


def _decided(prob, template):
    """Per texel of the JAX sampling, whether its best channel leads the
    second by more than MARGIN."""
    tex = np.sort(avg_uv.texel_probs(prob, template), axis=-1)
    return tex[..., -1] - tex[..., -2] > MARGIN


@pytest.mark.parametrize("seed", [0, 1])
def test_derive_vertex_labels_match_jax(template, seed):
    """Smooth random prob maps (so that parts form regions) at the UV
    image's size."""
    jt = jax_template(2, 1, 2)
    rng = np.random.RandomState(seed)
    H, W = template.uv_image_size()
    coarse = rng.uniform(0, 1, (4, 8, 5)).astype(np.float32)
    prob = np.kron(coarse, np.ones((H // 4, W // 8, 1), np.float32))
    prob += rng.uniform(0, 0.3, prob.shape).astype(np.float32)
    fl, vl = avg_uv.derive_vertex_labels(prob, template)
    jfl, jvl = javg.derive_vertex_labels(prob, jt)
    ok_texel = _decided(prob, template)
    ok_face = ok_texel.all(axis=1)
    assert ok_face.mean() > 0.5
    np.testing.assert_array_equal(fl[ok_face], jfl[ok_face])
    faces = template.faces
    ok_vert = np.array([ok_face[(faces == v).any(1)].all()
                        for v in range(template.num_verts)])
    assert ok_vert.mean() > 0.2
    np.testing.assert_array_equal(vl[ok_vert], jvl[ok_vert])


def _s1_pth(path, template):
    """A stage-1 .pth written by the JAX package's save_pth, from a seeded
    port model with moved BatchNorm statistics and template, and the VAE
    noise pinned to its mean (log-variance -40). Returns the flax
    variables it wrote."""
    model = init_weights(MeshNetS1(template, input_size=IMG, nz_feat=16,
                                   z_dim=8), torch.Generator().manual_seed(3))
    rng = np.random.RandomState(3)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (torch.nn.BatchNorm1d, torch.nn.BatchNorm2d)):
                n = mod.num_features
                mod.running_mean.copy_(torch.as_tensor(
                    rng.normal(0, 0.1, n).astype(np.float32)))
                mod.running_var.copy_(torch.as_tensor(
                    rng.uniform(0.5, 2.0, n).astype(np.float32)))
        model.mean_v.add_(torch.as_tensor(
            rng.normal(0, 0.05, model.mean_v.shape).astype(np.float32)))
        model.encoder.logvar_fc[2].weight.zero_()
        model.encoder.logvar_fc[2].bias.fill_(-40.0)
    v = flax_variables(model, template, 0, stage=1)
    jckpt.save_pth(path, v["params"], v["template"],
                   batch_stats=v["batch_stats"])
    return v


def _quadrant_batches():
    """Two synthetic batches of 3 whose part maps are the image's four
    quadrants (parts 1-4) with noise: the flow of an untrained model
    samples near the image's centre, where the synthetic batches' own
    part bumps leave background, and the template would hold no part."""
    rng = np.random.RandomState(7)
    y, x = np.mgrid[0:IMG, 0:IMG]
    part = 1 + (x >= IMG // 2) + 2 * (y >= IMG // 2)
    onehot = np.eye(5, dtype=np.float32)[part]
    batches = [synthetic_batch(rng, 3, IMG) for _ in range(2)]
    for b in batches:
        b["part_prob"] = (onehot[None] + rng.uniform(
            0, 0.5, (3, IMG, IMG, 5))).astype(np.float32)
    return batches


class _RecordingNumpy:
    """numpy for the JAX avg_uv module, recording what its run sorts: the
    first argsort is the exemplar ranking of the pass 1 scores."""

    def __init__(self):
        self.sorted = []

    def __getattr__(self, name):
        return getattr(np, name)

    def argsort(self, a, *args, **kw):
        self.sorted.append(np.array(a))
        return np.argsort(a, *args, **kw)


def test_avg_uv_run_matches_jax(template, tmp_path, monkeypatch):
    monkeypatch.setenv("UMR_TPU_LPIPS_WEIGHTS",
                       os.path.join(WEIGHTS_DIR, "lpips_alex.npz"))
    pth = str(tmp_path / "s1.pth")
    variables = _s1_pth(pth, template)
    # the JAX run's model.init (op by op, ~35 s here) only gives load_pth
    # the variables' structure, which the .pth then fills: hand it that
    # structure directly
    monkeypatch.setattr(javg.MeshNetS1, "init",
                        lambda self, *a, **k: variables)
    loader = _quadrant_batches()
    common = dict(KW, model_path=pth, face_chunk=320,
                  pixel_rows_per_block=2 * IMG)

    # the JAX run, with its ranking and pass 2's inputs recorded
    rec = _RecordingNumpy()
    monkeypatch.setattr(javg, "np", rec)
    seen = {}
    real_avg = javg.average_uv_maps

    def recording_avg(all_uv, group_sizes, exemplar_idx):
        seen.setdefault("uv", np.array(all_uv))
        seen.setdefault("idx", exemplar_idx)
        return real_avg(all_uv, group_sizes, exemplar_idx)

    monkeypatch.setattr(javg, "average_uv_maps", recording_avg)
    jdir = str(tmp_path / "jax")
    javg.run(JaxConfig(**common, out_dir=jdir), dataloader=loader)
    monkeypatch.undo()
    j_scores = rec.sorted[0]

    # the port's pass 1 on the same files and batches
    cfg = Config(**common, out_dir=str(tmp_path / "port"))
    model = avg_uv.load_s1_model(cfg, template, "cpu")
    from umr_tpu_torch.models import LPIPSAlex
    from umr_tpu_torch.models.weights import load_lpips_npz
    from umr_tpu_torch.renderer import SoftRenderer

    lpips = load_lpips_npz(LPIPSAlex(), os.path.join(WEIGHTS_DIR,
                                                     "lpips_alex.npz")).eval()
    renderer = SoftRenderer(image_size=IMG)
    scores, maps, sizes = avg_uv.exemplar_search(
        cfg, model, lpips, renderer, template, loader, "cpu")
    assert sizes == [3, 3]
    np.testing.assert_allclose(scores, j_scores, rtol=2e-4)
    np.testing.assert_array_equal(np.argsort(scores), np.argsort(j_scores))
    np.testing.assert_allclose(maps.astype(np.float32),
                               seen["uv"].astype(np.float32), rtol=0,
                               atol=1e-3)

    # pass 2 given the JAX run's exemplar
    prob = avg_uv.average_uv_maps(maps, sizes, seen["idx"])
    j_prob = np.load(os.path.join(jdir, "semantic_prob.npy"))
    np.testing.assert_allclose(prob, j_prob, rtol=0, atol=5e-4)
    _, vl = avg_uv.derive_vertex_labels(prob, template)
    for p, name in enumerate(avg_uv.PART_NAMES, start=1):
        np.testing.assert_array_equal(
            np.where(vl == p)[0],
            np.load(os.path.join(jdir, f"{name}_vertices.npy")), name)

    # the whole port run writes the same artifact set, and train_s2 of
    # both packages reads the same template back from the JAX files
    out = avg_uv.run(cfg, loader, device="cpu")
    names = sorted(os.listdir(jdir))
    assert sorted(os.listdir(out)) == names
    np.testing.assert_array_equal(read_png(os.path.join(out,
                                                        "semantic_seg.png")),
                                  read_png(os.path.join(jdir,
                                                        "semantic_seg.png")))
    jt = jax_template(2, 1, 2)
    for stemp in (jdir, out):
        with warnings.catch_warnings():
            # a template of a random s1 model may be starved: forced
            warnings.simplefilter("ignore")
            mv, seg, idx = train_s2.load_semantic_template(
                Config(stemp_path=stemp, force_template=True, **KW), template)
            jmv, jseg, jidx = jtrain_s2.load_semantic_template(
                JaxConfig(stemp_path=stemp, force_template=True, **KW), jt)
        np.testing.assert_array_equal(mv, jmv)
        np.testing.assert_array_equal(seg, jseg)
        assert seg.dtype == jseg.dtype == np.float32
        for a, b in zip(idx, jidx):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        torch.load(os.path.join(out, "mean_v.pth")).numpy(),
        torch.load(os.path.join(jdir, "mean_v.pth")).numpy())
