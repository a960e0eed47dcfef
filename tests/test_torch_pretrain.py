"""The pretrained weights of the port: the npz writers
(models/weights.py, ports of umr_tpu/models/weight_io.py's
resnet18_from_torch, alexnet_features_from_torch, save_npz, load_npz,
overlay_tree and load_resnet18_pretrained), the trunk's provenance and the
weight-path overrides (training/steps.py's init_fn, checkpoints.py), and
the RotNet pretraining tools (experiments/pretrain_trunk.py and
pretrain_lpips.py, ports of tools/pretrain_trunk.py and
tools/pretrain_lpips.py).

  * The writers: on seeded port state_dicts the port's npz files equal
    the JAX package's save_npz(resnet18_from_torch(sd)) and
    save_npz(alexnet_features_from_torch(sd)) key for key and bit for bit
    (the AlexNet's keys renamed to torchvision's features.{0,3,6,8,10});
    writing and reading back through load_resnet18_npz / load_lpips_npz
    is the identity.
  * init_fn records trunk_pretrained True with the trunk npz and False,
    with a warning, without it; UMR_TPU_RESNET_WEIGHTS and
    UMR_TPU_LPIPS_WEIGHTS land their files (the stats file by the
    basename rule); the flag survives a resume (pred_state.pt) and rides
    in the trainer's .pth as _meta/trunk_pretrained.
  * One RotNet step of each tool against the JAX tools' step composed in
    the test (the JAX step is local to the tools' main()): the same
    weights (carried over by the writers), images and injected draws.
    Tolerances from readings: logits atol 1e-4 (read 2.6e-5), loss rtol
    1e-5 (2.3e-6), accuracy equal; the gradients before Adam, cosine and
    each tensor within a share of its norm plus 1e-6 of the total: the
    trunk (20 convolutions and BatchNorms in another reduction order)
    cosine >= 0.9999 (read 1 - 1.35e-5), 2e-2 (read 8.4e-3); AlexNet
    cosine >= 0.999999, 1e-5 (read 2.0e-6). The trunk's BatchNorm running
    mean after the step atol 2e-6 (read 9.5e-7); its running variance is
    torch's unbiased one against flax's biased one: 0.1 times the batch
    variance after one step from var = 1, so (var - 0.9) / (jax var - 0.9)
    is n / (n - 1) with n the elements per channel at each BatchNorm
    (32 at layer4: a factor 1.032), rtol 1e-4 (read 4.0e-5).
  * Rotation k of the port (torch.rot90 over H, W of NCHW) is
    jnp.rot90(x, k, axes=(1, 2)) of NHWC, label k, on an image with no
    symmetry.
  * Each tool end to end on the CPU (8 images, batch 2, 3 steps): its
    files load through the JAX package's readers onto a fresh JAX init
    and through the port's init_fn under the overrides.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn

from torch_parity import cosine
from umr_tpu.models import weight_io as jio
from umr_tpu.models.lpips import AlexNetFeatures
from umr_tpu.models.resnet import ResNet18Conv
from umr_tpu_torch.config import Config
from umr_tpu_torch.experiments import pretrain_lpips, pretrain_trunk, rotnet
from umr_tpu_torch.mesh import build_template
from umr_tpu_torch.models import LPIPSAlex
from umr_tpu_torch.models.resnet import ResNet18
from umr_tpu_torch.models.weights import (WEIGHTS_DIR,
                                          alexnet_features_from_torch,
                                          load_lpips_npz, load_npz,
                                          load_resnet18_npz,
                                          load_resnet18_pretrained,
                                          overlay_tree, resnet18_from_torch,
                                          save_npz)
from umr_tpu_torch.training.steps import build_s1_step
from umr_tpu_torch.training.trainer import Trainer

TORCHVISION_ALEX = (0, 3, 6, 8, 10)
PREFIX = "encoder.resnet_conv.resnet."


def _seeded_resnet(seed):
    """A port ResNet-18 with seeded weights and BatchNorm statistics."""
    g = torch.Generator().manual_seed(seed)
    m = ResNet18()
    with torch.no_grad():
        for k, v in m.state_dict().items():
            if v.is_floating_point():
                v.copy_(torch.rand(v.shape, generator=g) + 0.5
                        if k.endswith("running_var")
                        else torch.randn(v.shape, generator=g) * 0.1)
    return m


def _npz_bits(path):
    return {k: (v.dtype, v.shape, v.tobytes(order="A"))
            for k, v in np.load(path).items()}


def test_resnet18_writer_matches_jax_bit_for_bit(tmp_path):
    sd = _seeded_resnet(0).state_dict()
    params, stats = resnet18_from_torch(sd)
    save_npz(str(tmp_path / "p.npz"), params)
    save_npz(str(tmp_path / "s.npz"), stats)
    jp, js = jio.resnet18_from_torch(sd)
    jio.save_npz(str(tmp_path / "jp.npz"), jp)
    jio.save_npz(str(tmp_path / "js.npz"), js)
    for a, b in (("p", "jp"), ("s", "js")):
        got, want = (_npz_bits(tmp_path / f"{n}.npz") for n in (a, b))
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k] == want[k], k
    back = load_resnet18_npz(str(tmp_path / "p.npz"),
                             str(tmp_path / "s.npz"))
    want = {PREFIX + k: v for k, v in sd.items()
            if not k.endswith("num_batches_tracked")}
    assert sorted(back) == sorted(want)
    for k, v in want.items():
        assert torch.equal(back[k], v), k


def test_alexnet_writer_matches_jax_bit_for_bit(tmp_path):
    g = torch.Generator().manual_seed(1)
    model = LPIPSAlex()
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=g))
    sd = model.state_dict()
    save_npz(str(tmp_path / "a.npz"), alexnet_features_from_torch(sd))
    tv = {f"features.{TORCHVISION_ALEX[int(k.split('.')[1])]}."
          f"{k.split('.')[2]}": v for k, v in sd.items()}
    jio.save_npz(str(tmp_path / "ja.npz"),
                 jio.alexnet_features_from_torch(tv))
    got, want = (_npz_bits(tmp_path / n) for n in ("a.npz", "ja.npz"))
    assert got == want
    back = load_lpips_npz(LPIPSAlex(), str(tmp_path / "a.npz")).state_dict()
    for k, v in sd.items():
        assert torch.equal(back[k], v), k


def test_overlay_and_the_stats_basename_rule(tmp_path):
    """tests/test_training_extras.py's basename case on the port, and
    overlay_tree's checks."""
    d = tmp_path / "params"           # a directory named 'params'
    d.mkdir()
    save_npz(str(d / "resnet18_params.npz"), {"a": np.ones(2)})
    save_npz(str(d / "resnet18_stats.npz"), {"b": np.zeros(3)})
    params, stats = load_resnet18_pretrained(str(d / "resnet18_params.npz"))
    assert "a" in params and stats is not None and "b" in stats
    os.remove(d / "resnet18_stats.npz")
    assert load_resnet18_pretrained(str(d / "resnet18_params.npz"))[1] is None
    dst = {"x": {"w": np.zeros((2, 3), np.float32)}, "y": np.ones(1)}
    out = overlay_tree(dst, {"x": {"w": np.ones((2, 3))}})
    assert out["x"]["w"].dtype == np.float32 and out["x"]["w"].sum() == 6
    assert dst["x"]["w"].sum() == 0 and out["y"] is dst["y"]
    with pytest.raises(AssertionError, match="not in model tree"):
        overlay_tree(dst, {"z": np.ones(1)})
    with pytest.raises(AssertionError, match="shape mismatch"):
        overlay_tree(dst, {"x": {"w": np.ones((3, 2))}})


# ---- provenance and overrides ------------------------------------------

CFG = Config(image_size=32, img_size=32, batch_size=2, anti_aliasing=False,
             subdivide=1, tex_size=2, nz_feat=16, z_dim=8)


@pytest.fixture(scope="module")
def s1():
    """A stage-1 model and its init_fn (built, never stepped)."""
    model, _, lpips, init_fn = build_s1_step(
        CFG, build_template(1, 1, 2), "cpu")[:4]
    return model, lpips, init_fn


def _trunk(model):
    return {k: v for k, v in model.state_dict().items()
            if k.startswith(PREFIX) and not k.endswith("num_batches_tracked")}


def test_init_fn_records_the_trunk_and_honours_the_overrides(
        s1, tmp_path, monkeypatch):
    model, lpips, init_fn = s1
    monkeypatch.delenv("UMR_TPU_RESNET_WEIGHTS", raising=False)
    monkeypatch.delenv("UMR_TPU_LPIPS_WEIGHTS", raising=False)
    state = init_fn(0)                           # the committed files
    assert state.trunk_pretrained is True
    committed = load_resnet18_npz(
        os.path.join(WEIGHTS_DIR, "resnet18_params.npz"),
        os.path.join(WEIGHTS_DIR, "resnet18_stats.npz"))
    assert all(torch.equal(v, committed[k]) for k, v in _trunk(model).items())
    shape_w = model.shape_predictor.pred_layer[0].weight.clone()

    # an override pair in a directory named 'params': fake values
    d = tmp_path / "params"
    d.mkdir()
    p, s = resnet18_from_torch({k[len(PREFIX):]: v for k, v in
                                _trunk(model).items()})
    save_npz(str(d / "resnet18_params.npz"),
             jax.tree.map(lambda x: np.full(x.shape, 0.123, np.float32), p))
    save_npz(str(d / "resnet18_stats.npz"),
             jax.tree.map(lambda x: np.full(x.shape, 0.456, np.float32), s))
    alex = alexnet_features_from_torch(LPIPSAlex().state_dict())
    save_npz(str(tmp_path / "alex.npz"), jax.tree.map(
        lambda x: np.full(x.shape, 0.25, np.float32), alex))
    monkeypatch.setenv("UMR_TPU_RESNET_WEIGHTS",
                       str(d / "resnet18_params.npz"))
    monkeypatch.setenv("UMR_TPU_LPIPS_WEIGHTS", str(tmp_path / "alex.npz"))
    state = init_fn(0)
    assert state.trunk_pretrained is True
    for k, v in _trunk(model).items():
        want = 0.456 if k.endswith(("running_mean", "running_var")) else 0.123
        assert torch.allclose(v, torch.full_like(v, want), rtol=0, atol=0), k
    assert torch.equal(model.shape_predictor.pred_layer[0].weight, shape_w)
    assert all(p.eq(0.25).all() for p in lpips.parameters())

    # missing files: loud, recorded False, the trunk random-init
    monkeypatch.setenv("UMR_TPU_RESNET_WEIGHTS", str(tmp_path / "nope.npz"))
    monkeypatch.setenv("UMR_TPU_LPIPS_WEIGHTS", str(tmp_path / "nope2.npz"))
    with pytest.warns(UserWarning) as rec:
        state = init_fn(0)
    msgs = " ".join(str(w.message) for w in rec)
    assert "RANDOM-INIT" in msgs and "resnet18" in msgs and "LPIPS" in msgs
    assert state.trunk_pretrained is False
    assert not torch.equal(_trunk(model)[PREFIX + "conv1.weight"],
                           committed[PREFIX + "conv1.weight"])


class _Loader:
    def __init__(self):
        self.batches = [{"img": np.zeros((2, 8, 8, 3), np.float32),
                         "mask": np.zeros((2, 8, 8), np.float32)}]

    def __len__(self):
        return 1

    def __iter__(self):
        return iter(self.batches)


@pytest.mark.parametrize("pretrained", [True, False])
def test_provenance_survives_a_resume_and_rides_in_the_pth(
        tmp_path, monkeypatch, pretrained):
    """The trainer's pred_state.pt keeps trunk_pretrained across a resume;
    its .pth carries _meta/trunk_pretrained, which the port's loader
    drops (the JAX package's import reads the model keys only:
    test_torch_checkpoints.py::test_port_pth_imports_into_jax)."""
    from umr_tpu_torch.training.steps import TrainState

    monkeypatch.delenv("UMR_TPU_RESUME", raising=False)
    monkeypatch.delenv("UMR_TPU_NO_AUTORESUME", raising=False)

    def state(tp):
        model, disc = torch.nn.Linear(2, 2), torch.nn.Linear(1, 1)
        opt = torch.optim.SGD(list(model.parameters())
                              + list(disc.parameters()), lr=0.1)
        return TrainState(step=0, updates=0, model=model, disc=disc,
                          lpips=None, optimizer=opt,
                          generator=torch.Generator(), trunk_pretrained=tp)

    def step_fn(st, db, *args):
        st.step += 1
        return st, {"total_loss": torch.tensor(1.0)}

    cfg = Config(checkpoint_dir=str(tmp_path), name="p", num_epochs=1,
                 num_iter=1, print_scalars=False, use_scops=False)
    Trainer(cfg, step_fn, state(pretrained), _Loader()).train()
    t = Trainer(cfg.replace(num_iter=0), step_fn, state(None), _Loader())
    assert t.state.step == 1 and t.state.trunk_pretrained is pretrained
    sd = torch.load(tmp_path / "p" / "pred_net_latest.pth",
                    weights_only=True)
    assert bool(sd["_meta/trunk_pretrained"]) is pretrained
    assert sd["_meta/trunk_pretrained"].dtype == torch.bool
    assert sorted(k for k in sd if not k.startswith("_meta/")) == [
        "bias", "weight"]


# ---- RotNet --------------------------------------------------------------

def test_rotation_direction_matches_jnp_rot90():
    x = np.random.RandomState(0).uniform(0, 1, (2, 5, 5, 3)).astype(
        np.float32)
    xs, labels = rotnet.rotations(torch.as_tensor(x))
    got = xs.permute(0, 2, 3, 1).numpy()
    for k in range(4):
        want = np.asarray(jnp.rot90(jnp.asarray(x), k, axes=(1, 2)))
        np.testing.assert_array_equal(got[2 * k:2 * k + 2], want)
        assert labels[2 * k:2 * k + 2].tolist() == [k, k]
    # no symmetry: the four rotations differ pairwise
    assert len({got[2 * k].tobytes() for k in range(4)}) == 4


class _JaxTrunkRotNet(nn.Module):
    @nn.compact
    def __call__(self, x, train=True):
        f = ResNet18Conv(n_blocks=4, name="resnet")(x, train)
        return nn.Dense(4, name="head")(f.mean(axis=(1, 2)))


class _JaxAlexRotNet(nn.Module):
    @nn.compact
    def __call__(self, x):
        feats = AlexNetFeatures(name="alex")(x)
        return nn.Dense(4, name="head")(feats[-1].mean(axis=(1, 2)))


def _head(model):
    return {"kernel": model.head.weight.detach().numpy().T.copy(),
            "bias": model.head.bias.detach().numpy().copy()}


def _head_grads(model):
    return {"kernel": model.head.weight.grad.numpy().T,
            "bias": model.head.bias.grad.numpy()}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _jax_step(apply, params, xs, labels):
    """The tools' loss_fn: apply(p, xs) -> (logits, aux); mean softmax
    cross entropy and rotation accuracy; gradients to the params before
    the optimizer."""
    def loss_fn(p):
        logits, aux = apply(p, xs)
        loss = optax.softmax_cross_entropy_with_integer_labels(
            logits, labels).mean()
        return loss, (logits, (logits.argmax(-1) == labels).mean(), aux)

    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)


def _hold(logits, loss, acc, grads, jout, cos, rel):
    """The port's step against the JAX one, at the module's tolerances."""
    (jloss, (jlogits, jacc, _)), jgrads = jout
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    assert float(acc) == float(jacc)
    jg = _flat(jgrads)
    assert sorted(grads) == sorted(jg)
    assert cosine(grads, jg) >= cos
    total = np.sqrt(sum(np.sum(v.astype(np.float64) ** 2)
                        for v in jg.values()))
    for k, v in jg.items():
        err = np.linalg.norm(grads[k] - v)
        assert err <= rel * np.linalg.norm(v) + 1e-6 * total, (k, err)


def _jitter_draws(rng, B, C):
    return {"tint": rng.uniform(0.8, 1.2, (B, 1, 1, 3)).astype(np.float32),
            "noise": (0.02 * rng.normal(size=(B, C, C, 3))).astype(
                np.float32)}


def _bn_key(name):
    """A BatchNorm module name of the port's trunk -> its flax path."""
    parts = name.split(".")
    if parts[0].startswith("layer"):
        bn = "downsample_bn" if parts[2] == "downsample" else parts[2]
        return f"{parts[0]}_{parts[1]}/{bn}"
    return parts[0]


def test_trunk_step_matches_the_jax_tool():
    """64^2 images, batch 2 (8 rotated): layer4's maps are 2x2, n = 32."""
    rng = np.random.RandomState(3)
    B, S = 2, 64
    x = rng.uniform(0, 1, (B, S, S, 3)).astype(np.float32)
    draws = _jitter_draws(rng, B, S)
    model = pretrain_trunk.build_model(0).train()
    p0, s0 = resnet18_from_torch(model.features.state_dict())
    counts = {}            # the BatchNorms' elements per channel
    hooks = [m.register_forward_hook(
        lambda mod, inp, out, name=name: counts.__setitem__(
            name, inp[0].numel() // inp[0].shape[1]))
        for name, m in model.features.named_modules()
        if isinstance(m, torch.nn.BatchNorm2d)]
    xs, labels = pretrain_trunk.inputs(
        torch.as_tensor(x), None, {k: torch.as_tensor(v)
                                   for k, v in draws.items()})
    logits = model(xs)
    loss, acc = rotnet.loss_and_accuracy(logits, labels)
    loss.backward()
    for h in hooks:
        h.remove()
    gp, _ = resnet18_from_torch({
        **model.features.state_dict(),
        **{k: p.grad for k, p in model.features.named_parameters()}})
    grads = _flat({"resnet": gp, "head": _head_grads(model)})

    jx = np.clip(x * draws["tint"] + draws["noise"], 0.0, 1.0)
    jxs = jnp.concatenate([jnp.rot90(jx, k, axes=(1, 2)) for k in range(4)])
    jxs = ((jxs - jnp.asarray(pretrain_trunk.MEAN))
           / jnp.asarray(pretrain_trunk.STD))
    jmodel = _JaxTrunkRotNet()

    def apply(p, v):
        return jmodel.apply({"params": p, "batch_stats": {"resnet": s0}}, v,
                            train=True, mutable=["batch_stats"])

    jout = _jax_step(apply, {"resnet": p0, "head": _head(model)}, jxs,
                     jnp.repeat(jnp.arange(4), B))
    _hold(logits, loss, acc, grads, jout, 0.9999, 2e-2)

    # the running statistics after the step
    port = _flat(resnet18_from_torch(model.features.state_dict())[1])
    jstats = _flat(jout[0][1][2]["batch_stats"]["resnet"])
    assert len(counts) == 20 and min(counts.values()) == 4 * B * 2 * 2
    for name, n in counts.items():
        key = _bn_key(name)
        np.testing.assert_allclose(port[f"{key}/mean"],
                                   jstats[f"{key}/mean"], rtol=0, atol=2e-6,
                                   err_msg=name)
        np.testing.assert_allclose(
            (port[f"{key}/var"] - 0.9) / (jstats[f"{key}/var"] - 0.9),
            n / (n - 1), rtol=1e-4, err_msg=f"{name} n={n}")


def test_lpips_step_matches_the_jax_tool():
    """40^2 images, 32^2 crops at injected offsets: both max-pools run
    (7x7 and 3x3 maps before them)."""
    rng = np.random.RandomState(4)
    B, S, C = 2, 40, 32
    x = rng.uniform(0, 1, (B, S, S, 3)).astype(np.float32)
    draws = dict(_jitter_draws(rng, B, C),
                 oy=rng.randint(0, S - C + 1, B), ox=rng.randint(0, S - C + 1,
                                                                 B))
    model = pretrain_lpips.build_model(0).train()
    sizes = []
    model.features.alex.convs[2].register_forward_hook(
        lambda mod, inp, out: sizes.append(tuple(inp[0].shape[2:])))
    xs, labels = pretrain_lpips.make_inputs(C)(
        torch.as_tensor(x), None, {k: torch.as_tensor(v)
                                   for k, v in draws.items()})
    logits = model(xs)
    loss, acc = rotnet.loss_and_accuracy(logits, labels)
    loss.backward()
    assert sizes == [(1, 1)]          # 32 -> conv 7 -> pool 3 -> pool 1
    alex = model.features.alex
    grads = _flat({"alex": alexnet_features_from_torch(
        {f"convs.{i}.{leaf}": getattr(c, leaf).grad
         for i, c in enumerate(alex.convs) for leaf in ("weight", "bias")}),
        "head": _head_grads(model)})

    jx = np.stack([x[b, draws["oy"][b]:draws["oy"][b] + C,
                     draws["ox"][b]:draws["ox"][b] + C] for b in range(B)])
    jx = np.clip(jx * draws["tint"] + draws["noise"], 0.0, 1.0)
    jxs = jnp.concatenate([jnp.rot90(jx, k, axes=(1, 2)) for k in range(4)])
    from umr_tpu.models.lpips import _SCALE, _SHIFT
    jxs = (2.0 * jxs - 1.0 - _SHIFT) / _SCALE
    jmodel = _JaxAlexRotNet()
    params = {"alex": alexnet_features_from_torch(alex.state_dict()),
              "head": _head(model)}
    jout = _jax_step(lambda p, v: (jmodel.apply({"params": p}, v), None),
                     params, jxs, jnp.repeat(jnp.arange(4), B))
    _hold(logits, loss, acc, grads, jout, 0.999999, 1e-5)


def _fresh(init):
    """A JAX init's tree of zeros in its shapes and dtypes (the overlay
    reads only those; flax's init runs op by op, seconds on the CPU)."""
    return jax.tree.map(lambda s: np.zeros(s.shape, s.dtype),
                        jax.eval_shape(init, jax.random.key(0)))


def _train_npz(path, n, S):
    np.savez(path, img=np.random.RandomState(5).uniform(
        0, 1, (n, S, S, 3)).astype(np.float32))


def test_pretrain_trunk_end_to_end(tmp_path, s1, monkeypatch):
    """8 images at 32^2, batch 2, 3 steps: the pair lands on a fresh JAX
    init's tree through load_resnet18_pretrained + overlay_tree, and through the
    port's init_fn under UMR_TPU_RESNET_WEIGHTS."""
    _train_npz(tmp_path / "train.npz", 8, 32)
    out = tmp_path / "w" / "resnet18_params.npz"
    rec = pretrain_trunk.main(["--data", str(tmp_path / "train.npz"),
                               "--out", str(out), "--steps", "3",
                               "--batch", "2", "--device", "cpu"])
    assert len(rec["losses"]) == 3 and np.isfinite(rec["losses"]).all()
    assert rec["stats"] == str(tmp_path / "w" / "resnet18_stats.npz")
    pre_p, pre_s = jio.load_resnet18_pretrained(str(out))
    assert pre_s is not None
    fresh = _fresh(lambda k: ResNet18Conv(n_blocks=4).init(
        k, jnp.zeros((1, 32, 32, 3)), False))
    got = jio.overlay_tree(fresh["params"], pre_p)
    jio.overlay_tree(fresh["batch_stats"], pre_s)
    np.testing.assert_array_equal(got["conv1"]["kernel"],
                                  load_npz(str(out))["conv1"]["kernel"])
    model, _, init_fn = s1
    monkeypatch.setenv("UMR_TPU_RESNET_WEIGHTS", str(out))
    assert init_fn(0).trunk_pretrained is True
    want = load_resnet18_npz(str(out), rec["stats"])
    assert all(torch.equal(v, want[k]) for k, v in _trunk(model).items())


def test_pretrain_lpips_end_to_end(tmp_path, s1, monkeypatch):
    """8 images at 40^2, crops 32, batch 2, 3 steps: the file loads through
    the JAX package's load_lpips_params onto a fresh JAX LPIPS init, and
    through the port's init_fn under UMR_TPU_LPIPS_WEIGHTS."""
    from umr_tpu.models.lpips import LPIPSAlex as JaxLPIPS

    _train_npz(tmp_path / "train.npz", 8, 40)
    out = tmp_path / "w" / "lpips_alex.npz"
    rec = pretrain_lpips.main(["--data", str(tmp_path / "train.npz"),
                               "--out", str(out), "--steps", "3",
                               "--batch", "2", "--crop", "32",
                               "--device", "cpu"])
    assert len(rec["losses"]) == 3 and np.isfinite(rec["losses"]).all()
    fresh = _fresh(lambda k: JaxLPIPS().init(
        k, jnp.zeros((1, 32, 32, 3)), jnp.zeros((1, 32, 32, 3))))
    got = jio.overlay_tree(fresh["params"], jio.load_lpips_params(str(out)))
    _, lpips, init_fn = s1
    monkeypatch.setenv("UMR_TPU_LPIPS_WEIGHTS", str(out))
    init_fn(0)
    for i, conv in enumerate(lpips.convs):
        np.testing.assert_array_equal(
            conv.weight.detach().numpy().transpose(2, 3, 1, 0),
            got["alex"][f"conv{i}"]["kernel"])
