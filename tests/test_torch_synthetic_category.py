"""The port's synthetic bird category (umr_tpu_torch/data/
synthetic_category.py) against the JAX package's
(umr_tpu/data/synthetic_category.py), on the same seeds.

Tolerances:
  * the host helpers, prob2center, sample_prob, make_pair_orders, the
    cameras, the keypoint indices and every loader batch: exactly equal
    (the same numpy code on the same RandomStates);
  * kp: atol 1e-5 (the projection in torch against XLA, float32; reading
    6.0e-8);
  * img, mask, part_prob at tests/test_torch_slice.py's limits for the
    plain renderer: atol 1e-3 except at most 2e-3 of the values, all
    within 0.02 (silhouette slivers at sigma 1e-5; readings: img 3.2e-3
    at 2.2e-4 of the values, mask and part_prob 1.0e-3 at 1.6e-4 and
    6.5e-5, on both routes);
  * dts_barrier: the port's native C++ barrier (native.edt_barrier) on
    the JAX package's mask against the JAX package's native barrier:
    atol 1e-5 (the same C++ source built twice, with other flags).
"""

import functools

import numpy as np
import pytest
import torch

import umr_tpu.data.synthetic_category as jsc
from torch_parity import assert_close_except_slivers
from umr_tpu.mesh import build_template as jax_template
from umr_tpu.utils import image as jimage
from umr_tpu_torch import image
from umr_tpu_torch.data import synthetic_category as sc
from umr_tpu_torch.mesh import build_template
from umr_tpu_torch.native import edt_barrier
from umr_tpu_torch.renderer import SoftRenderer
from umr_tpu_torch import tracing
from umr_tpu_torch.data import synthetic_batch
from umr_tpu_torch.training import trainer
from umr_tpu_torch.training.trainer import (BatchPrep, prepare_batch,
                                            step_keys, to_device)

pytestmark = pytest.mark.filterwarnings("ignore")
N, S, B = 6, 32, 4


@pytest.fixture(scope="module")
def jax_data():
    return jsc.generate_dataset(jax_template(2, 1, 2), N, seed=0,
                                image_size=S, batch=B)


@pytest.fixture(scope="module", params=["auto", "kernel"])
def port_data(request):
    """The port's dataset through the plain route ("auto" on the CPU) and
    through the kernels' route ("kernel": the card's route, with the
    generator's shared bins, run here through the kernels' plain
    versions)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sc, "SoftRenderer", functools.partial(
            SoftRenderer, impl=request.param))
        return sc.generate_dataset(build_template(2, 1, 2), N, seed=0,
                                   image_size=S, batch=B, device="cpu")


def _sphere():
    t = build_template(2, 1, 2)
    return t, t.verts / np.linalg.norm(t.verts, axis=1, keepdims=True)


def test_constants_match_jax():
    assert sc.PART_NAMES == jsc.PART_NAMES
    assert sc.POINTS_NUM == jsc.POINTS_NUM
    assert sc.PART_CH == jsc.PART_CH
    np.testing.assert_array_equal(sc._Q_SIDE, jsc._Q_SIDE)
    for axis in "xyz":
        np.testing.assert_array_equal(sc._axis_quat(axis, 0.7),
                                      jsc._axis_quat(axis, 0.7))
    a, b = np.random.RandomState(0).randn(2, 4)
    np.testing.assert_array_equal(sc._hamilton(a, b), jsc._hamilton(a, b))


@pytest.mark.parametrize("name", ["base_bird", "part_labels",
                                  "face_part_labels", "base_texture",
                                  "farthest_point_sample", "sample_deform",
                                  "sample_camera"])
def test_host_helpers_match_jax(name):
    t, sphere = _sphere()
    args = {
        "base_bird": lambda: (sphere,),
        "part_labels": lambda: (sphere,),
        "face_part_labels": lambda: (sphere, t.faces),
        "base_texture": lambda: (sphere, t.faces, t.tex_size),
        "farthest_point_sample": lambda: (jsc.base_bird(sphere), 15, 17),
        "sample_deform": lambda: (sphere, np.random.RandomState(5)),
        "sample_camera": lambda: (np.random.RandomState(5),),
    }
    got = getattr(sc, name)(*args[name]())
    want = getattr(jsc, name)(*args[name]())
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_prob2center_and_sample_prob_match_jax(jax_data):
    d = jax_data
    for i in range(N):
        for ch in range(1, 5):
            c = image.prob2center(d["part_prob"][i], d["mask"][i], ch=ch)
            np.testing.assert_array_equal(
                c, jimage.prob2center(d["part_prob"][i], d["mask"][i], ch))
            got = image.sample_prob(d["part_prob"][i], d["mask"][i], c, 10,
                                    ch=ch, rng=np.random.RandomState(i))
            want = jimage.sample_prob(d["part_prob"][i], d["mask"][i], c, 10,
                                      ch=ch, rng=np.random.RandomState(i))
            np.testing.assert_array_equal(got, want)
    # an empty channel falls back to the mask
    pp = np.zeros((S, S, 5), np.float32)
    got = image.sample_prob(pp, d["mask"][0], np.zeros(2, np.float32), 10,
                            rng=np.random.RandomState(1))
    want = jimage.sample_prob(pp, d["mask"][0], np.zeros(2, np.float32), 10,
                              rng=np.random.RandomState(1))
    np.testing.assert_array_equal(got, want)


def test_make_pair_orders_match_jax():
    for n, pairs, seed in ((6, 20, 1), (2, 50, 303), (64, 200, 303)):
        for a, b in zip(sc.make_pair_orders(n, pairs, seed),
                        jsc.make_pair_orders(n, pairs, seed)):
            np.testing.assert_array_equal(a, b)


def test_generate_dataset_matches_jax(jax_data, port_data):
    j, t = jax_data, port_data
    assert set(t) == set(j)
    for k in j:
        assert t[k].shape == j[k].shape and t[k].dtype == j[k].dtype, k
    np.testing.assert_array_equal(t["cam"], j["cam"])
    np.testing.assert_array_equal(t["kp_idx"], j["kp_idx"])
    np.testing.assert_allclose(t["kp"], j["kp"], atol=1e-5, rtol=0)
    for k in ("img", "mask", "part_prob"):
        assert_close_except_slivers(t[k], j[k], atol=1e-3, frac=2e-3,
                                    cap=0.02)
    dts = np.stack([edt_barrier(m) for m in
                    (j["mask"] > 0.5).astype(np.float32)])[..., None]
    np.testing.assert_allclose(dts, j["dts_barrier"], atol=1e-5, rtol=0)
    # the port's own barrier is the same function of its own mask
    np.testing.assert_array_equal(t["dts_barrier"], np.stack(
        [edt_barrier(m) for m in (t["mask"] > 0.5).astype(
            np.float32)])[..., None])


def test_generate_dataset_stats_and_device_rule():
    stats = {}
    sc.generate_dataset(build_template(1, 1, 2), 3, image_size=S, batch=2,
                        device="cpu", stats=stats)
    assert len(stats["verts_inside"]) == len(stats["render_s"]) == 2
    assert min(stats["verts_inside"]) >= sc.MIN_VERTS_INSIDE
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            sc.generate_dataset(build_template(1, 1, 2), 1, image_size=S)


def test_hole_check_raises_on_a_holed_mask(monkeypatch):
    """Fragments dropped by the rasterizer (every other pixel row of the
    silhouette lost) trip the integrity check instead of entering the
    dataset."""
    render = SoftRenderer.render

    def holed(self, *a, **k):
        out = render(self, *a, **k)
        rgba = out.rgba.clone()
        rgba[:, 1::2, :, 3] = 0.0
        return type(out)(rgba=rgba, p2f=out.p2f, aggr=out.aggr)

    monkeypatch.setattr(SoftRenderer, "render", holed)
    with pytest.raises(RuntimeError, match="rendered masks have holes"):
        sc.generate_dataset(build_template(1, 1, 2), 2, image_size=S,
                            batch=2, device="cpu")


def _epochs(loader, n=2):
    return [list(loader) for _ in range(n)]


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for bg, bw in zip(got, want):
        assert set(bg) == set(bw)
        for k in bw:
            g = bg[k].numpy() if torch.is_tensor(bg[k]) else bg[k]
            assert g.dtype == np.asarray(bw[k]).dtype, k
            np.testing.assert_array_equal(g, bw[k], err_msg=k)


@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("use_scops", [True, False])
@pytest.mark.parametrize("drop_last", [True, False])
def test_category_loader_matches_jax(jax_data, shuffle, use_scops,
                                     drop_last):
    """Batch for batch over 2 epochs: the same indices and the same part
    points; device_data=True (staged on the CPU here) yields the host
    path's values."""
    kw = dict(batch_size=B, shuffle=shuffle, seed=7, use_scops=use_scops,
              drop_last=drop_last)
    want = _epochs(jsc.CategoryLoader(jax_data, **kw))
    host = sc.CategoryLoader(jax_data, **kw)
    assert len(host) == len(jsc.CategoryLoader(jax_data, **kw))
    got = _epochs(host)
    assert host._epoch == 2
    for g, w in zip(got, want):
        _assert_batches_equal(g, w)
    dev = sc.CategoryLoader(jax_data, device_data=True, device="cpu", **kw)
    got = _epochs(dev)
    for g, w in zip(got, want):
        for b in g:
            assert torch.is_tensor(b["img"]) and isinstance(b["kp"],
                                                            np.ndarray)
        _assert_batches_equal(g, w)
    staged = ["img", "mask", "dts_barrier"] + (["part_prob"] if use_scops
                                               else [])
    assert sorted(dev._dev) == sorted(staged)


@pytest.mark.parametrize("use_scops", [True, False])
def test_loaders_share_one_staged_copy(jax_data, use_scops):
    """Loaders given one stage() copy index it (no copy of their own) and
    yield what a loader staging its own yields, over 2 epochs."""
    staged = sc.stage(jax_data, "cpu")
    assert all(v.dtype == torch.float32 for v in staged.values())
    kw = dict(batch_size=B, seed=5, use_scops=use_scops)
    want = _epochs(sc.CategoryLoader(jax_data, device_data=True,
                                     device="cpu", **kw))
    shared = sc.CategoryLoader(jax_data, staged=staged, **kw)
    assert shared.device_data and shared.device == torch.device("cpu")
    got = _epochs(shared)
    assert shared._dev is staged
    for g, w in zip(got, want):
        for bg, bw in zip(g, w):
            assert sorted(bg) == sorted(bw)
            for k in bg:
                if torch.is_tensor(bg[k]):
                    torch.testing.assert_close(bg[k], bw[k], rtol=0, atol=0)
                else:
                    np.testing.assert_array_equal(bg[k], bw[k], err_msg=k)


def test_device_batch_prepares_like_the_host_batch(jax_data):
    """prepare_batch normalises a device loader's batch on its device to
    the host batch's values, and to_device() leaves tensors where they
    are and wraps numpy arrays in place."""
    kw = dict(batch_size=B, seed=3, use_scops=True)
    bh = next(iter(sc.CategoryLoader(jax_data, **kw)))
    bd = next(iter(sc.CategoryLoader(jax_data, device_data=True,
                                     device="cpu", **kw)))
    ph, pd = prepare_batch(bh), prepare_batch(bd)
    assert set(ph) == set(pd)
    for k in ph:
        assert torch.is_tensor(pd[k]) == (k not in (
            "head_points", "belly_points", "neck_points", "back_points"))
        g = pd[k].numpy() if torch.is_tensor(pd[k]) else pd[k]
        np.testing.assert_array_equal(g, ph[k], err_msg=k)
    before = tracing.totals()
    moved, pinned = to_device(pd, torch.device("cpu"))
    assert pinned == ()
    assert tracing.delta(before)["counters"].get("trainer.h2d_bytes", 0) == 0
    for k in pd:
        if torch.is_tensor(pd[k]):
            assert moved[k] is pd[k], k
        else:
            assert np.shares_memory(moved[k].numpy(), pd[k]), k


@pytest.mark.parametrize("source", ["numpy", "tensors"])
@pytest.mark.parametrize("use_scops,use_texture", [
    (True, True), (True, False), (False, True), (False, False)])
def test_batch_prep_prepares_like_the_host_batch(use_scops, use_texture,
                                                 source, monkeypatch):
    """The trainer's BatchPrep, on the CPU as on the card, gives every key
    of the host prepare_batch bit for bit, real_imgs one batch late over
    three batches and the batch's own again when the shape changes (there
    a float64 img, cast where the batch is prepared), from a host loader's
    numpy batches or a device loader's tensors. It takes only the loader's
    arrays that the flags keep to the device (their bytes are what
    trainer.h2d_bytes counts on the card; on the CPU nothing is copied:
    numpy is wrapped in place) and counts one trainer.prep_on_device a
    batch."""
    rng = np.random.RandomState(5)
    batches = [synthetic_batch(rng, 2, 16) for _ in range(3)]
    batches.append(synthetic_batch(rng, 3, 16))
    batches[-1]["img"] = batches[-1]["img"].astype(np.float64)
    if source == "tensors":
        batches = [{k: torch.from_numpy(v) for k, v in b.items()}
                   for b in batches]
    handed = []
    monkeypatch.setattr(trainer, "to_device", lambda arrays, device: (
        handed.append(arrays) or to_device(arrays, device)))
    prep = BatchPrep(use_scops, use_texture, torch.device("cpu"))
    keys = step_keys(batches[0], use_scops, use_texture)
    host = [{k: v.numpy() if torch.is_tensor(v) else v for k, v in b.items()}
            for b in batches]
    for i, batch in enumerate(batches):
        before = tracing.totals()
        db, pinned = prep(batch)
        counters = tracing.delta(before)["counters"]
        assert pinned == ()
        assert counters.get("trainer.h2d_bytes", 0) == 0
        assert counters["trainer.prep_on_device"] == 1
        assert list(handed[-1]) == keys
        assert all(handed[-1][k] is batch[k] for k in keys)
        if i < 3:   # float32 img: taken in place, not copied
            assert np.shares_memory(db["img"].numpy(), host[i]["img"])
        want = prepare_batch(host[i], use_scops, use_texture)
        if i in (1, 2):
            want["real_imgs"] = prepare_batch(host[i - 1])["real_imgs"]
        assert list(db) == list(want)
        for k in want:
            assert torch.is_tensor(db[k]), k
            np.testing.assert_array_equal(db[k].numpy(), want[k],
                                          err_msg=f"{k}, batch {i}")


def test_pair_loader_matches_jax(jax_data):
    o1, _ = sc.make_pair_orders(N, 9, seed=2)
    got = list(sc.PairLoader(jax_data, o1))
    want = list(jsc.PairLoader(jax_data, o1))
    assert len(sc.PairLoader(jax_data, o1)) == 9
    _assert_batches_equal(got, want)
