"""The port's synthetic curriculum tools (umr_tpu_torch/experiments/
synthetic_parity.py, extend_s2.py, eval_kp_pairs.py) against the JAX
package's tools/ (pure numpy, imported from tools/), and one end-to-end
CPU run of each.

Tolerances: none; every helper, and stage 1's passes over the loader, are
equal exactly. The CPU runs swap the template the tools hard-code
(build_template(3, 1, 6), as the JAX tools') and Config's for a
subdivide-1 one (42 vertices, 80 faces, T2=4) at 32^2 to stay within a
minute; the bars are read, not asserted (a 2-step stage 1 gives a dead
template: the run ends in the tool's documented abort).
"""

import dataclasses
import importlib.util
import json
import os
import shutil
import sys
import types
from pathlib import Path

import numpy as np
import pytest

import torch_parity  # noqa: F401  (torch on 2 threads)
import umr_tpu_torch.config as tconfig
from umr_tpu_torch.config import Config
from umr_tpu_torch.data.synthetic_category import CategoryLoader
from umr_tpu_torch.experiments import (eval_kp_pairs, extend_s2,
                                       synthetic_parity, train_s1)
from umr_tpu_torch.mesh import build_template

TOOLS = Path(__file__).resolve().parent.parent / "tools"
pytestmark = pytest.mark.filterwarnings("ignore")
SMALL_RUN = ["--train_n", "8", "--test_n", "4", "--image_size", "32",
             "--batch", "4", "--s1_iters", "2", "--s2_iters", "2",
             "--n_pairs", "4", "--device", "cpu"]
PARTS = ("head", "neck", "back", "belly")


@dataclasses.dataclass(frozen=True)
class SmallConfig(Config):
    """Config with a subdivide-1 template: 42 vertices, 80 faces, T2=4."""
    subdivide: int = 1
    tex_size: int = 2


def _small_template(mp):
    """The tools' runs at SmallConfig's template: their Configs, and the
    template synthetic_parity renders the datasets with (asserted to be
    the JAX tool's build_template(3, 1, 6) before it is swapped)."""
    def small(*args):
        assert args == (3, 1, 6), args
        return build_template(1, 1, 2)

    mp.setattr(tconfig, "Config", SmallConfig)
    mp.setattr(synthetic_parity, "build_template", small)


def _tool(name):
    """tools/<name>.py as a module (its imports put tools/ on sys.path)."""
    if str(TOOLS) not in sys.path:
        sys.path.insert(0, str(TOOLS))
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}",
                                                  TOOLS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _nested(fn, name, defaults=()):
    """A function defined inside `fn` (free of closures), callable."""
    code = next(c for c in fn.__code__.co_consts
                if isinstance(c, types.CodeType) and c.co_name == name)
    assert not code.co_freevars, code.co_freevars
    return types.FunctionType(code, fn.__globals__, name, tuple(defaults))


def test_identity_pck_matches_jax():
    jsp = _tool("synthetic_parity")
    rng = np.random.RandomState(0)
    pairs = rng.uniform(-1, 1, (40, 2, 15, 3)).astype(np.float32)
    pairs[..., 2] = rng.rand(40, 2, 15) > 0.2
    pairs[:, :, 0, 2] = 1.0
    for pad in (0.05, 0.1):
        assert (synthetic_parity.identity_pck(list(pairs), pad)
                == jsp.identity_pck(list(pairs), pad))


def test_last_scalar_median_matches_jax(tmp_path):
    jsp = _tool("synthetic_parity")
    jax_median = _nested(jsp.main, "last_scalar_median", (20,))
    log = tmp_path / "loss_log.txt"
    lines = ["================ Training Loss (now) ================"]
    rng = np.random.RandomState(1)
    for i in range(33):
        lines.append(f"(epoch: 0, iters: {i}) total_loss: {rng.rand():.3f} "
                     f"uv_flow_area: {rng.rand():.3f} corr_loss: "
                     f"{rng.rand() * 1e-3:.3f} ")
    log.write_text("\n".join(lines) + "\n")
    for key in ("uv_flow_area", "corr_loss", "total_loss", "absent"):
        for k in (20, 5):
            assert (synthetic_parity.last_scalar_median(str(log), key, k)
                    == jax_median(str(log), key, k)), (key, k)
    assert synthetic_parity.last_scalar_median(str(tmp_path / "no"), "x") \
        is None is jax_median(str(tmp_path / "no"), "x")


class _StageConfig(Exception):
    pass


def _stage_configs(main, config_module, monkeypatch, tmp, argv, module):
    """The Config keyword sets `main` builds for s1, uv and s2 under
    --skip_train (stage 2's raises to stop the run there), on fake
    datasets and a fake finished stage 1 / avg_uv in `tmp`."""
    calls = []

    def fake_config(**kw):
        calls.append(kw)
        if kw.get("name") == "s2":
            raise _StageConfig
        return types.SimpleNamespace(**kw)

    data = {"img": np.zeros((2, 4, 4, 3), np.float32),
            "mask": np.full((2, 4, 4), 0.25, np.float32),
            "dts_barrier": np.zeros((2, 4, 4), np.float32),
            "part_prob": np.zeros((2, 4, 4, 5), np.float32)}
    monkeypatch.setattr(config_module, "Config", fake_config)
    monkeypatch.setattr(module, "get_or_make_dataset",
                        lambda *a, **k: dict(data))
    for d in ("snap/s1", "stemp"):
        os.makedirs(os.path.join(tmp, d), exist_ok=True)
    open(os.path.join(tmp, "snap/s1/pred_net_latest.pth"), "w").close()
    open(os.path.join(tmp, "stemp/semantic_seg.png"), "w").close()
    for p in PARTS:
        np.save(os.path.join(tmp, f"stemp/{p}_vertices.npy"),
                np.arange(20))
    monkeypatch.setattr(sys, "argv", ["tool", "--out", tmp, "--skip_train"]
                        + argv)
    with pytest.raises(_StageConfig):
        main()
    return calls


def test_stage_configs_and_s2_set_match_jax(tmp_path, monkeypatch):
    """The s1, uv and s2 Configs of a run, and --s2_set's parsing, equal
    the JAX tool's."""
    import umr_tpu.config as jconfig
    import umr_tpu.experiments.avg_uv  # noqa: F401  (import-time Configs)
    import umr_tpu.experiments.train_s1  # noqa: F401
    import umr_tpu.experiments.train_s2  # noqa: F401
    import umr_tpu_torch.config as tconfig

    jsp = _tool("synthetic_parity")
    sets = ["cycle_soft_p2f=True", "corr_loss_wt=0.5", "name_tag=abc",
            "flag=False", "lst=[1, 2]", "n=3"]
    argv = ["--s1_iters", "7", "--save_freq", "11"]
    for s in sets:
        argv += ["--s2_set", s]
    want = _stage_configs(jsp.main, jconfig, monkeypatch,
                          str(tmp_path / "jax"), argv, jsp)
    got = _stage_configs(lambda: synthetic_parity.main(
        sys.argv[1:] + ["--device", "cpu"]), tconfig, monkeypatch,
        str(tmp_path / "port"), argv, synthetic_parity)
    assert [c["name"] for c in want] == ["s1", "uv", "s2"]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = {k: v.replace("/port", "/jax") if isinstance(v, str) else v
             for k, v in g.items()}
        assert g == w
    overrides = synthetic_parity.parse_overrides(sets)
    assert overrides == {k: want[2][k] for k in overrides}
    assert overrides["cycle_soft_p2f"] is True
    assert overrides["flag"] is False and overrides["name_tag"] == "abc"


def test_hard_pairs_match_jax():
    jek = _tool("eval_kp_pairs")
    rng = np.random.RandomState(2)
    q1, q2 = rng.randn(2, 30, 4)
    np.testing.assert_array_equal(eval_kp_pairs.quat_angle_deg(q1, q2),
                                  jek.quat_angle_deg(q1, q2))
    cams = rng.randn(16, 7).astype(np.float32)
    for angle in (0.0, 30.0, 90.0):
        got = eval_kp_pairs.hard_pair_orders(cams, 50, angle)
        want = jek.hard_pair_orders(cams, 50, angle)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    with pytest.raises(SystemExit):
        eval_kp_pairs.hard_pair_orders(cams, 5, 400.0)


def _recording(cls, log, ids):
    """cls, each of whose passes appends to `log` (the epoch it began at,
    the sample ids of each batch it yielded); ids maps an image's float32
    bytes to its sample."""
    class Recording(cls):
        def __iter__(self):
            batches = []
            log.append((self._epoch, batches))
            for batch in super().__iter__():
                batches.append([ids[np.asarray(im, np.float32).tobytes()]
                                for im in batch["img"]])
                yield batch

    return Recording


def _jax_s1_passes(cfg_kw, loader, monkeypatch):
    """The JAX package's train_s1.run (experiments/train_s1.py) over
    `loader`, its model steps stubbed: the epoch loop, the template
    update's pass over the loader (:55) and the trainer's stop are JAX's
    own. Returns the images each template update averaged."""
    import jax.numpy as jnp
    import umr_tpu.config as jconfig
    import umr_tpu.experiments.train_s1 as jts1
    import umr_tpu.training.trainer as jtrainer

    encoded, updates = [0], []

    def build_s1_step(cfg, template):
        def init_fn(key, lpips_params):
            return types.SimpleNamespace(step=jnp.int32(0))

        def step_fn(state, db, key, epoch):
            return state, {"total_loss": jnp.float32(0.0)}

        def encode_feat_fn(state, db, rng):
            encoded[0] += db["img"].shape[0]
            return jnp.zeros((db["img"].shape[0], 2))

        def template_update_fn(state, feat_mean):
            updates.append(encoded[0])
            encoded[0] = 0
            return state

        return (None, None, None, init_fn, step_fn, encode_feat_fn,
                template_update_fn)

    monkeypatch.setattr(jts1, "build_s1_step", build_s1_step)
    monkeypatch.setattr(jts1, "_maybe_load_lpips", lambda cfg: None)
    monkeypatch.setattr(jtrainer.Trainer, "save", lambda self, *a, **k: None)
    jts1.run(jconfig.Config(**cfg_kw, data_parallel=False,
                            display_visuals=False), loader)
    return updates


def _s1_passes_match_jax(tmp_path, monkeypatch, n, **cfg_kw):
    """Stage 1 of the port (train_s1.run on the CPU) and of the JAX
    package over device loaders on the same n samples: the loader's passes
    (the epoch each began at and its batches' samples), its final _epoch
    and the images of each template update are equal. Returns the port's
    passes and updates."""
    import umr_tpu.data.synthetic_category as jsc

    d = dict(np.load(_tiny_npz(tmp_path, n)))
    ids = {np.asarray(im, np.float32).tobytes(): i
           for i, im in enumerate(d["img"])}
    assert len(ids) == n
    cfg_kw = dict(image_size=32, img_size=32, batch_size=4, subdivide=1,
                  tex_size=2, nz_feat=16, z_dim=8, use_scops=False,
                  print_scalars=False, name="s1", **cfg_kw)
    jax_log, port_log = [], []
    jax_loader = _recording(jsc.CategoryLoader, jax_log, ids)(
        d, 4, seed=10, use_scops=False, device_data=True)
    jax_updates = _jax_s1_passes(
        dict(cfg_kw, checkpoint_dir=str(tmp_path / "jax")), jax_loader,
        monkeypatch)
    loader = _recording(CategoryLoader, port_log, ids)(
        d, 4, seed=10, use_scops=False, device_data=True, device="cpu")
    trainer = train_s1.run(
        Config(**cfg_kw, checkpoint_dir=str(tmp_path / "port")), loader,
        device="cpu")
    assert port_log == jax_log
    assert loader._epoch == jax_loader._epoch == len(jax_log)
    updates = [c for _, c in trainer.template_updates]
    assert updates == jax_updates
    return trainer, port_log, updates


def test_template_update_advances_the_loader_epoch(tmp_path, monkeypatch):
    """2 epochs with a template update after each: the loader has begun
    4 passes in the port as in JAX, the same samples in the same order."""
    trainer, passes, updates = _s1_passes_match_jax(
        tmp_path, monkeypatch, 4, num_epochs=2, update_template_freq=1)
    assert trainer.state.step == 2
    assert updates == [4, 4]
    assert [e for e, _ in passes] == [0, 1, 2, 3]


def test_template_update_and_num_iter_stop_match_jax(tmp_path, monkeypatch):
    """8 samples in batches of 4, an update every 2 epochs, stopped by
    num_iter=5 in the third epoch: the passes equal JAX's, the last one
    left after its first batch."""
    trainer, passes, updates = _s1_passes_match_jax(
        tmp_path, monkeypatch, 8, num_epochs=3, update_template_freq=2,
        num_iter=5)
    assert trainer.state.step == 5
    assert updates == [8]
    assert [(e, len(b)) for e, b in passes] == [(0, 2), (1, 2), (2, 2),
                                                (3, 1)]


def _tiny_npz(tmp_path, n=4):
    from umr_tpu_torch.data.synthetic_category import generate_dataset

    path = tmp_path / "tiny.npz"
    np.savez(path, **generate_dataset(build_template(1, 1, 2), n,
                                      image_size=32, batch=4, device="cpu"))
    return path


@pytest.fixture(scope="module")
def parity_run(tmp_path_factory):
    """One run of the port's synthetic_parity.main (a small CPU run):
    (out dir, summary, the SystemExit of an abort or None)."""
    out = str(tmp_path_factory.mktemp("synparity"))
    stop = None
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("UMR_TPU_RESUME", raising=False)
        mp.delenv("UMR_TPU_NO_AUTORESUME", raising=False)
        _small_template(mp)
        try:
            synthetic_parity.main(["--out", out] + SMALL_RUN)
        except SystemExit as e:
            stop = e
    with open(os.path.join(out, "summary.json")) as f:
        return out, json.load(f), stop


def test_synthetic_parity_runs_end_to_end_on_cpu(parity_run):
    out, summary, stop = parity_run
    for f in ("train.npz", "test.npz", "summary.json",
              "snap/s1/pred_net_latest.pth", "snap/s1/pred_state.pt",
              "snap/s1/loss_log.txt", "stemp/semantic_seg.png",
              "stemp/mean_v.pth"):
        assert os.path.exists(os.path.join(out, f)), f
    train = np.load(os.path.join(out, "train.npz"))
    assert train["img"].shape == (8, 32, 32, 3)
    assert train["part_prob"].shape == (8, 32, 32, 5)
    assert set(PARTS) == set(summary["part_vertex_counts"])
    for k in ("train_n", "test_n", "image_size", "s1_wall_s",
              "avg_uv_wall_s", "s1_uv_flow_area", "s1_iters_used",
              "template_ok"):
        assert k in summary, k
    if stop is not None:
        # the dead-template abort, after every retry
        assert "ABORT" in str(stop.code)
        assert summary["failed"] == "semantic template never cleared the bar"
        assert summary["template_ok"] is False
        assert summary["s1_iters_used"] == 4 * 2
        assert "test_iou" not in summary
    else:
        for k in ("s2_wall_s", "s2_overrides", "test_iou", "iou_area_prior",
                  "pck_identity_0.1", "pck_identity_0.15", "pck_flow_0.1",
                  "pck_flow_0.15", "pck_cam_0.1", "pck_cam_0.15",
                  "kp_flow_wall_s", "kp_cam_wall_s", "iou_ok", "pck_ok"):
            assert k in summary, k
        assert os.path.exists(os.path.join(out, "snap/s2/pred_net_latest.pth"))
        assert 0.0 <= summary["test_iou"] <= 1.0


def test_extend_s2_and_eval_kp_pairs_on_cpu(parity_run, tmp_path,
                                            monkeypatch):
    """extend_s2 --fresh trains stage 2 from the run's template (its part
    vertex sets replaced by a live partition of the 42 vertices) and
    evaluates; eval_kp_pairs reads that checkpoint."""
    src, _, _ = parity_run
    src2 = str(tmp_path / "src")
    os.makedirs(src2)
    for f in ("train.npz", "test.npz"):
        os.symlink(os.path.join(src, f), os.path.join(src2, f))
    shutil.copytree(os.path.join(src, "stemp"), os.path.join(src2, "stemp"))
    for i, p in enumerate(PARTS):
        np.save(os.path.join(src2, "stemp", f"{p}_vertices.npy"),
                np.arange(42)[i::4])
    out = str(tmp_path / "ext")
    _small_template(monkeypatch)
    summary = extend_s2.main(
        ["--src", src2, "--out", out, "--fresh", "--s2_iters", "2",
         "--batch", "4", "--n_pairs", "4", "--set", "cycle_soft_p2f=True",
         "--device", "cpu"])
    assert summary["overrides"] == {"cycle_soft_p2f": True}
    with open(os.path.join(out, "snap", "s2", "opts.log")) as f:
        assert "cycle_soft_p2f: True" in f.read()
    for k in ("s2_ext_wall_s", "test_iou", "pck_identity_0.1",
              "pck_flow_0.1", "pck_flow_0.15", "pck_cam_0.1",
              "pck_cam_0.15"):
        assert k in summary, k
    assert "iou_area_prior" not in summary
    assert json.load(open(os.path.join(out, "summary.json"))) == summary
    shutil.copy(os.path.join(src, "test.npz"), out)
    res = eval_kp_pairs.main(["--run", out, "--min_angle_deg", "10",
                              "--n_pairs", "4", "--device", "cpu"])
    assert os.path.exists(os.path.join(out, "kp_hard_10deg.json"))
    for mode in ("flow", "cam"):
        assert 0.0 <= res[f"pck_{mode}_0.1"] <= res[f"pck_{mode}_0.15"] <= 1
    assert res["mean_pair_angle_deg"] >= 10.0
