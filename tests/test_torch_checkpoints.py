"""Port parity of the stage handoff through files: checkpoints
(training/checkpoints.py, models/weights.py::load_checkpoint), the
trainer's auto-resume, its one-step-lagged scalar drain, loss_log.txt
(visualizer.py) and stage_budget.json.

  * A port pred_net_*.pth (with the trunk's provenance under
    _meta/trunk_pretrained), imported by the JAX package's
    reference_io.import_reference_checkpoint, gives the JAX model the
    port's eval forward, and loads back into the port; a JAX save_pth file gives the port the JAX
    model's eval forward (BatchNorm statistics and mean_v included). The
    weights are seeded with randomised BatchNorm statistics and template,
    so eval mode exercises them. Tolerance: atol 1e-4, as
    tests/test_torch_models.py (convolutions reduce in another order).
  * A resumed stage-1 run equals an unbroken one bit for bit on the CPU:
    per-step scalars, parameters, optimizer state and template.
  * The JAX trainer and the port's write the same loss_log.txt lines for
    the same scalars (apart from the header's date and iter_time) and
    stage_budget.json with the same keys.
"""

import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_parity import flax_variables, injected_draws, np_of, t_of
from umr_tpu.config import Config as JaxConfig
from umr_tpu.models import MeshNet as JaxMeshNet
from umr_tpu.models import MeshNetS1 as JaxMeshNetS1
from umr_tpu.models.reference_io import import_reference_checkpoint
from umr_tpu.training import checkpoints as jckpt
from umr_tpu.training.steps import TrainState as JaxTrainState
from umr_tpu.training.trainer import Trainer as JaxTrainer
from umr_tpu.utils.visualizer import Visualizer as JaxVisualizer
from umr_tpu_torch.config import Config
from umr_tpu_torch.data import synthetic_batch
from umr_tpu_torch.experiments import train_s1
from umr_tpu_torch.mesh import build_template
from umr_tpu_torch.models import MeshNet, MeshNetS1, init_weights
from umr_tpu_torch.models.weights import load_checkpoint
from umr_tpu_torch.training import checkpoints
from umr_tpu_torch.training.steps import TrainState
from umr_tpu_torch.training.trainer import BUDGET_KEYS, Trainer
from umr_tpu_torch.visualizer import Visualizer

ATOL = 1e-4
S2_KEYS = ("mean", "logvar", "cam_hypotheses", "cam_probs", "cam",
           "delta_v", "tex_flow", "uvimage_pred")
S1_KEYS = ("mean", "logvar", "cam", "delta_v", "tex_flow", "uvimage_pred")


def _seeded(stage, template, seed):
    """A port model of the stage with randomised BatchNorm affines and
    statistics and a moved template."""
    kw = dict(input_size=32, nz_feat=16, z_dim=8)
    model = (MeshNet(template, num_hypo_cams=2, **kw) if stage == 2
             else MeshNetS1(template, **kw))
    init_weights(model, torch.Generator().manual_seed(seed))
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (torch.nn.BatchNorm1d, torch.nn.BatchNorm2d)):
                n = mod.num_features
                mod.weight.copy_(t_of(rng.uniform(0.5, 1.5, n)))
                mod.running_mean.copy_(t_of(rng.normal(0.0, 0.1, n)))
                mod.running_var.copy_(t_of(rng.uniform(0.5, 2.0, n)))
        model.mean_v.add_(t_of(rng.normal(0, 0.05, model.mean_v.shape)
                               .astype(np.float32)))
    return model


def _jax_model(stage, template):
    if stage == 2:
        return JaxMeshNet(template=template, nz_feat=16, z_dim=8,
                          num_hypo_cams=2)
    return JaxMeshNetS1(template=template, nz_feat=16, z_dim=8)


def _forwards_agree(stage, model, jmodel, variables):
    """The port model's eval forward against the JAX model's on the same
    variables, the JAX forward's random draws injected."""
    img = np.random.RandomState(9).standard_normal(
        (3, 32, 32, 3)).astype(np.float32)
    jout = jax.jit(lambda v, x: jmodel.apply(
        v, x, train=False, rngs={"sample": jax.random.key(1)}))(
            variables, jnp.asarray(img))
    model.eval()
    with torch.no_grad():
        if stage == 2:
            eps, inds = injected_draws(jout)
            out = model(t_of(img), eps=eps, sample_inds=inds)
        else:
            eps = ((np.asarray(jout["feat"]) - np.asarray(jout["mean"]))
                   * np.exp(-0.5 * np.asarray(jout["logvar"])))
            out = model(t_of(img), eps=t_of(eps.astype(np.float32)))
    for k in (S2_KEYS if stage == 2 else S1_KEYS):
        np.testing.assert_allclose(np_of(out[k]), np_of(jout[k]), atol=ATOL,
                                   err_msg=k)
    np.testing.assert_allclose(np_of(model.mean_v),
                               np.asarray(variables["template"]["mean_v"]),
                               rtol=0, atol=0)


@pytest.mark.parametrize("stage", [2, 1])
def test_port_pth_imports_into_jax(tmp_path, stage):
    template = build_template(2, 1, 2)
    model = _seeded(stage, template, seed=1)
    path = str(tmp_path / "pred_net_latest.pth")
    checkpoints.save_pth(path, model, meta={"trunk_pretrained": stage == 2})
    sd = {k: v.numpy() for k, v in torch.load(path).items()}
    assert any(k.endswith("running_var") for k in sd) and "mean_v" in sd
    # the trunk's provenance rides beside the weights, as the JAX
    # package's save_pth writes it, and the port's loader drops it
    assert sd["_meta/trunk_pretrained"].dtype == np.bool_
    assert bool(sd["_meta/trunk_pretrained"]) is (stage == 2)
    back = _seeded(stage, template, seed=5)
    load_checkpoint(back, path)
    assert all(torch.equal(v, model.state_dict()[k])
               for k, v in back.state_dict().items())
    # the variables' structure, from another seed: the import fills it
    structure = flax_variables(_seeded(stage, template, seed=2), template,
                               2 if stage == 2 else 0, stage=stage)
    variables = import_reference_checkpoint(
        sd, structure, stage=stage, num_cams=2 if stage == 2 else 0,
        n_upconv=min(5, int(np.log2(template.uv_image_size()[0]))))
    _forwards_agree(stage, model, _jax_model(stage, template), variables)


@pytest.mark.parametrize("stage", [2, 1])
def test_jax_save_pth_loads_into_the_port(tmp_path, stage):
    template = build_template(2, 1, 2)
    variables = flax_variables(_seeded(stage, template, seed=3), template,
                               2 if stage == 2 else 0, stage=stage)
    path = str(tmp_path / "pred_net_latest.pth")
    jckpt.save_pth(path, variables["params"], variables["template"],
                   batch_stats=variables["batch_stats"])
    kw = dict(input_size=32, nz_feat=16, z_dim=8)
    model = (MeshNet(template, num_hypo_cams=2, **kw) if stage == 2
             else MeshNetS1(template, **kw))
    load_checkpoint(model, path)
    _forwards_agree(stage, model, _jax_model(stage, template), variables)


@pytest.mark.parametrize("layout", ["torch", "flax"])
def test_pth_without_bn_statistics_warns(tmp_path, layout):
    """As the JAX package's load_pth: a loud warning, init statistics."""
    template = build_template(2, 1, 2)
    src = _seeded(2, template, seed=4)
    path = str(tmp_path / "old.pth")
    if layout == "torch":
        torch.save({k: v for k, v in src.state_dict().items()
                    if not k.endswith(("running_mean", "running_var"))},
                   path)
    else:
        v = flax_variables(src, template, 2)
        jckpt.save_pth(path, v["params"], v["template"])
    model = MeshNet(template, input_size=32, nz_feat=16, z_dim=8,
                    num_hypo_cams=2)
    with pytest.warns(UserWarning, match="BatchNorm running stats"):
        load_checkpoint(model, path)
    for bn in model.modules():
        if isinstance(bn, (torch.nn.BatchNorm1d, torch.nn.BatchNorm2d)):
            assert bn.running_var.eq(1).all() and bn.running_mean.eq(0).all()
    np.testing.assert_array_equal(np_of(model.mean_v), np_of(src.mean_v))


# ---------------------------------------------------------------------------
# resume

IMG = 32
S1_KW = dict(image_size=IMG, img_size=IMG, batch_size=2, num_hypo_cams=2,
             anti_aliasing=False, subdivide=2, tex_size=2, nz_feat=16,
             z_dim=8, update_template_freq=1, print_scalars=False)


def _scalars(history):
    return [{k: v for k, v in sc.items() if k != "iter_time"}
            for sc in history]


def test_resumed_s1_run_equals_an_unbroken_one(tmp_path, monkeypatch):
    """Two epochs of two batches (the template updated after each) in one
    run, against one epoch, then a fresh run that auto-resumes into epoch
    1 and takes its two steps. Then a relaunch at num_iter=4 finds the
    run complete and takes none."""
    monkeypatch.delenv("UMR_TPU_RESUME", raising=False)
    monkeypatch.delenv("UMR_TPU_NO_AUTORESUME", raising=False)
    loader = [synthetic_batch(np.random.RandomState(20 + i), 2, IMG)
              for i in range(2)]
    base = Config(**S1_KW, checkpoint_dir=str(tmp_path))
    whole = train_s1.run(base.replace(name="whole", num_epochs=2), loader,
                         device="cpu")
    first = train_s1.run(base.replace(name="cut", num_epochs=1), loader,
                         device="cpu")
    second = train_s1.run(base.replace(name="cut", num_epochs=2), loader,
                          device="cpu")
    assert (first.state.step, second.state.step) == (2, 4)
    assert whole.template_updates == [(0, 4), (1, 4)]
    assert first.template_updates == [(0, 4)]
    assert second.template_updates == [(1, 4)]
    assert (_scalars(whole.history)
            == _scalars(first.history) + _scalars(second.history))
    a, b = whole.state, second.state
    assert (a.step, a.updates) == (b.step, b.updates) == (4, 4)
    for mod in ("model", "disc"):
        sa, sb = getattr(a, mod).state_dict(), getattr(b, mod).state_dict()
        for k in sa:
            assert torch.equal(sa[k], sb[k]), (mod, k)
    oa, ob = a.optimizer.state_dict()["state"], b.optimizer.state_dict()[
        "state"]
    for i in oa:
        for k in oa[i]:
            assert torch.equal(oa[i][k], ob[i][k]), (i, k)
    assert torch.equal(a.generator.get_state(), b.generator.get_state())
    save_dir = tmp_path / "cut"
    for name in ("pred_net_latest.pth", "pred_state.pt", "loss_log.txt",
                 "opts.log", "stage_budget.json"):
        assert (save_dir / name).exists(), name

    again = train_s1.run(base.replace(name="cut", num_epochs=2, num_iter=4),
                         loader, device="cpu")
    assert again.state.step == 4 and again.history == []


class _EpochLoader:
    """A sized loader with the epoch counter a shuffling loader keeps."""

    def __init__(self, n):
        self.batches = [synthetic_batch(np.random.RandomState(i), 2, 8)
                        for i in range(n)]
        self._epoch = 0

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        return iter(self.batches)


def _counting_state():
    model, disc = torch.nn.Linear(2, 2), torch.nn.Linear(1, 1)
    with torch.no_grad():
        model.weight.zero_()
    opt = torch.optim.SGD(list(model.parameters()) + list(disc.parameters()),
                          lr=0.1)
    return TrainState(step=0, updates=0, model=model, disc=disc, lpips=None,
                      optimizer=opt, generator=torch.Generator())


def _counting_step(log):
    def step_fn(state, db, *args):
        log.append((state.step, args))
        with torch.no_grad():
            state.model.weight.add_(1.0)
        state.step += 1
        return state, {"total_loss": torch.tensor(0.5 * state.step),
                       "corr_loss": torch.tensor(0.25 * state.step)}
    return step_fn


def test_resume_into_the_right_epoch(tmp_path, monkeypatch):
    """4 steps over a 2-batch loader, then a fresh trainer resumes at step
    4, sets the loader's _epoch to 2 and takes epoch 2 only; with
    UMR_TPU_NO_AUTORESUME it starts over."""
    monkeypatch.delenv("UMR_TPU_RESUME", raising=False)
    monkeypatch.delenv("UMR_TPU_NO_AUTORESUME", raising=False)
    cfg = Config(checkpoint_dir=str(tmp_path), name="r", num_epochs=3,
                 num_iter=4, print_scalars=False, use_scops=False)
    log = []
    Trainer(cfg, _counting_step(log), _counting_state(), _EpochLoader(2),
            extra_step_args=lambda e: (e,)).train()
    assert [s for s, _ in log] == [0, 1, 2, 3]
    log.clear()
    loader = _EpochLoader(2)
    t = Trainer(cfg.replace(num_iter=0), _counting_step(log),
                _counting_state(), loader, extra_step_args=lambda e: (e,))
    assert t.state.step == 4 and t.state.model.weight.eq(4.0).all()
    t.train()
    assert loader._epoch == 2
    assert log == [(4, (2,)), (5, (2,))]
    monkeypatch.setenv("UMR_TPU_NO_AUTORESUME", "1")
    t = Trainer(cfg, _counting_step([]), _counting_state(), _EpochLoader(2))
    assert t.state.step == 0


def test_restore_refuses_another_model_untouched(tmp_path):
    state = _counting_state()
    checkpoints.save_state(str(tmp_path), state)
    other = _counting_state()
    other.model = torch.nn.Linear(3, 2)
    other.optimizer = torch.optim.SGD(list(other.model.parameters())
                                      + list(other.disc.parameters()), lr=0.1)
    before = other.model.weight.clone()
    with pytest.raises(ValueError, match="model"):
        checkpoints.restore_state(str(tmp_path), other)
    assert torch.equal(other.model.weight, before) and other.step == 0
    # the temporary file of the atomic save is gone
    assert sorted(os.listdir(tmp_path)) == ["pred_state.pt"]


def test_restore_refuses_a_generator_state_that_does_not_fit(tmp_path):
    """A generator state of another size (a CUDA generator's, resumed on
    the CPU) is refused before any weight or moment is copied in."""
    checkpoints.save_state(str(tmp_path), _counting_state())
    path = checkpoints.state_path(str(tmp_path))
    ckpt = torch.load(path, weights_only=True)
    ckpt["generator"] = torch.zeros(16, dtype=torch.uint8)
    ckpt["model"]["weight"] = torch.ones(2, 2)
    ckpt["step"] = 7
    torch.save(ckpt, path)
    other = _counting_state()
    before = other.generator.get_state()
    with pytest.raises(ValueError, match="generator"):
        checkpoints.restore_state(str(tmp_path), other)
    assert other.model.weight.eq(0).all() and other.step == 0
    assert torch.equal(other.generator.get_state(), before)


# ---------------------------------------------------------------------------
# the log and the stage budget

def test_visualizer_lines_match_jax(tmp_path):
    cfg = Config(checkpoint_dir=str(tmp_path / "t"), name="v")
    jcfg = JaxConfig(checkpoint_dir=str(tmp_path / "j"), name="v")
    sc = {"smoothed_total_loss": 0.123456, "corr_loss": np.float32(2.5e-4),
          "uv_flow_area": 0.0625, "total_loss": 12.34567, "iter_time": 1.0}
    for vis in (Visualizer(cfg), JaxVisualizer(jcfg)):
        vis.print_current_scalars(3, 17, sc)
        vis.print_current_scalars(4, 1, {"a": -1.0005})
    t = (tmp_path / "t" / "v" / "loss_log.txt").read_text().splitlines()
    j = (tmp_path / "j" / "v" / "loss_log.txt").read_text().splitlines()
    header = re.compile(r"^=+ Training Loss \(.*\) =+$")
    assert header.match(t[0]) and header.match(j[0])
    assert t[1:] == j[1:]
    assert t[1] == ("(epoch: 3, iters: 17) smoothed_total_loss: 0.123 "
                    "corr_loss: 0.000 uv_flow_area: 0.062 total_loss: 12.346 "
                    "iter_time: 1.000 ")


def _jax_tiny_state():
    params = {"model": {"w": jnp.zeros(3)}, "disc": {"d": jnp.ones(2)}}
    return JaxTrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats={"model": {}}, buffers={},
        template={"mean_v": jnp.zeros((4, 3))},
        opt_state=optax.adam(1e-3).init(params), lpips=None)


def test_trainer_log_and_budget_match_jax(tmp_path, monkeypatch):
    """5 steps over a 2-batch loader (three epochs, the third cut by
    num_iter), printed every step: the same loss_log.txt lines but for
    iter_time, the same stage_budget.json keys. The port drains each
    step's scalars after dispatching the next step."""
    monkeypatch.setenv("UMR_TPU_NO_AUTORESUME", "1")
    common = dict(name="log", num_epochs=3, num_iter=5, print_freq=1,
                  use_scops=False, use_texture=False, save_latest_freq=1000)
    loader = [{"img": np.full((2, 8, 8, 3), v, np.float32),
               "mask": np.ones((2, 8, 8), np.float32)} for v in (0.25, 0.5)]

    def jax_step(state, db, key):
        n = state.step + 1
        return state.replace(step=n), {
            "total_loss": jnp.float32(0.5) * n,
            "corr_loss": jnp.float32(0.25) * n}

    jcfg = JaxConfig(checkpoint_dir=str(tmp_path / "j"), data_parallel=False,
                     display_visuals=False, **common)
    JaxTrainer(jcfg, jax_step, _jax_tiny_state(), loader,
               on_epoch_end=lambda s, e: s).train()

    order = []
    real = Visualizer.print_current_scalars

    def recording(self, epoch, i, scalars):
        order.append(("log", scalars["total_loss"]))
        return real(self, epoch, i, scalars)

    monkeypatch.setattr(Visualizer, "print_current_scalars", recording)
    log = []
    step = _counting_step(log)

    def port_step(state, db):
        order.append(("step", state.step + 1))
        return step(state, db)

    cfg = Config(checkpoint_dir=str(tmp_path / "t"), data_parallel=False,
                 display_visuals=False, **common)
    t = Trainer(cfg, port_step, _counting_state(), loader,
                on_epoch_end=lambda s, e: s)
    t.train()
    # the drain of step n follows the dispatch of step n + 1, except where
    # the epoch ends (its hook drains first) and at num_iter
    assert order == [("step", 1), ("step", 2), ("log", 0.5), ("log", 1.0),
                     ("step", 3), ("step", 4), ("log", 1.5), ("log", 2.0),
                     ("step", 5), ("log", 2.5)]
    assert [sc["total_loss"] for sc in t.history] == [0.5, 1, 1.5, 2, 2.5]

    def lines(root):
        text = (root / "log" / "loss_log.txt").read_text().splitlines()[1:]
        return [re.sub(r"iter_time: \S+", "iter_time: T", s) for s in text]

    assert lines(tmp_path / "t") == lines(tmp_path / "j")
    assert len(lines(tmp_path / "t")) == 5
    tb = json.loads((tmp_path / "t" / "log" / "stage_budget.json").read_text())
    jb = json.loads((tmp_path / "j" / "log" / "stage_budget.json").read_text())
    assert sorted(tb) == sorted(jb)
    assert {f"{k}_s_per_step" for k in BUDGET_KEYS + ("epoch_end",)} <= set(tb)
    assert tb["steps"] == jb["steps"] == 5 and "first_cycle_s" in tb
    opts = (tmp_path / "t" / "log" / "opts.log").read_text()
    assert opts == (tmp_path / "j" / "log" / "opts.log").read_text().replace(
        str(tmp_path / "j"), str(tmp_path / "t"))
