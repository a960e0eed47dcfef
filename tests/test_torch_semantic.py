"""The port's train_s2.load_semantic_template against the JAX one on the
same files (tests/test_semantic_guards.py's cases): a template failing
the liveliness bar (every part >= part_min_vert_frac of the vertices) is
refused, or warned about under force_template; a healthy one loads
silently, in the order head, belly, neck, back. The PNG is written by
imageio, as avg_uv's JAX package writes it. Arrays exactly equal."""

import os.path as osp
import warnings

import imageio.v2 as imageio
import numpy as np
import pytest

from umr_tpu.config import Config as JaxConfig
from umr_tpu.experiments import train_s2 as jtrain_s2
from umr_tpu.mesh import build_template as jax_template
from umr_tpu_torch.config import Config
from umr_tpu_torch.experiments import train_s2
from umr_tpu_torch.mesh import build_template


@pytest.fixture(scope="module")
def templates():
    return build_template(2, 1, 4), jax_template(2, 1, 4)


def _write_stemp(path, counts, subdir=False):
    """A minimal avg_uv output: seg PNG, part vertex files (optionally in
    vertices_idx/), no mean_v.pth."""
    seg = np.random.RandomState(0).randint(0, 5, (128, 256)).astype(np.uint8)
    imageio.imwrite(osp.join(path, "semantic_seg.png"), seg)
    idx_dir = path / "vertices_idx" if subdir else path
    idx_dir.mkdir(exist_ok=True)
    start = 0
    for name, c in counts.items():
        np.save(osp.join(idx_dir, f"{name}_vertices.npy"),
                np.arange(start, start + c, dtype=np.int64))
        start += c
    return str(path), seg


@pytest.mark.parametrize("counts", [
    {"head": 0, "neck": 10, "back": 20, "belly": 5},      # empty head
    {"head": 2, "neck": 1, "back": 1, "belly": 150},      # starved
])
def test_failing_template_refused_or_forced(tmp_path, templates, counts):
    t, jt = templates
    stemp, _ = _write_stemp(tmp_path, counts)
    for load, cfg, tmpl in ((train_s2.load_semantic_template, Config, t),
                            (jtrain_s2.load_semantic_template, JaxConfig,
                             jt)):
        with pytest.raises(ValueError, match="liveliness bar"):
            load(cfg(stemp_path=stemp), tmpl)
    with pytest.warns(UserWarning, match="liveliness bar"):
        got = train_s2.load_semantic_template(
            Config(stemp_path=stemp, force_template=True), t)
    with pytest.warns(UserWarning, match="liveliness bar"):
        want = jtrain_s2.load_semantic_template(
            JaxConfig(stemp_path=stemp, force_template=True), jt)
    assert got[0] is None and want[0] is None
    np.testing.assert_array_equal(got[1], want[1])
    for a, b in zip(got[2], want[2]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("subdir", [False, True])
def test_healthy_template_loads_silently(tmp_path, templates, subdir):
    t, jt = templates
    stemp, seg = _write_stemp(
        tmp_path, {"head": 7, "neck": 10, "back": 20, "belly": 5}, subdir)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        mean_v, got_seg, idx = train_s2.load_semantic_template(
            Config(stemp_path=stemp), t)
    _, jseg, jidx = jtrain_s2.load_semantic_template(
        JaxConfig(stemp_path=stemp), jt)
    assert [len(i) for i in idx] == [7, 5, 10, 20]
    assert got_seg.dtype == np.float32 and got_seg.shape == (128, 256)
    np.testing.assert_array_equal(got_seg, seg)
    np.testing.assert_array_equal(got_seg, jseg)
    for a, b in zip(idx, jidx):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_missing_seg_raises(tmp_path, templates):
    with pytest.raises(FileNotFoundError, match="avg_uv"):
        train_s2.load_semantic_template(Config(stemp_path=str(tmp_path)),
                                        templates[0])
