"""Port parity of stage 1: MeshNet-S1, the training step with its epoch
gates, the online template update, the trainer's hooks and train_s1.run.

The port against the JAX package's build_s1_step on the CPU, at the
config of tests/test_train_steps.py (image 32, subdivide 2, tex_size 2,
no anti-aliasing, one face chunk of 320) with narrow heads and batch 4
(see tests/test_torch_train.py: at batch 2 the train-mode BatchNorms
over 1x1 maps amplify last-ulp differences). The port's weights are
carried to JAX (the discriminator's the other way, LPIPS from the
committed npz), and the JAX step's random draws (VAE noise, GAN view
angles) are injected. Gradients are compared through one SGD step at a
large learning rate ((p0 - p1) / lr), as for stage 2.

The port's plain route runs the same face chunk as JAX's dense
rasterizer, so its p2f follows the same rule (ops/rasterize.py). The
card's route (impl="kernel", through the kernels' plain versions here)
takes its p2f at face_chunk=1, the reference CUDA rule: it is held
against the plain route at face_chunk=1, and against the plain route at
JAX's chunk, where only the texture-cycle loss moves.

Tolerances, from the readings of this file's inputs:
  * MeshNet-S1 outputs, against the output's largest value: eval atol
    1e-5 of it (reading 1.7e-6, the texture flow); train mode atol 5e-3
    of it (reading 1.5e-3, the texture flow; the camera 8.8e-5): the
    train-mode BatchNorms over batch 4 amplify last-ulp differences.
  * scalars of the model alone (deform, flatten, tri, ori, uv_flow_area,
    acc_gan): rtol 1e-4 (reading 5.4e-7); those through renders or the
    texture flow: rtol 2e-3 (reading 1.1e-3, tex_cycle_loss).
  * gradients: cosine of all gradients >= 0.99 (reading 0.9958); per
    tensor ||g - g_jax|| <= 0.5 ||g_jax|| + 1e-6 x the norm of all
    gradients (reading 0.35, the decoder's last bias). Looser than stage
    2's because stage 1's single camera enters the sigma-1e-5 silhouettes
    directly: its train-mode forward differs by 8.8e-5 of its largest
    value between the two implementations, and a camera perturbed by
    1e-4 of its largest value alone turns the port's own silhouette
    gradient to cosine 0.9974. Each loss term's gradient on shared
    inputs agrees to cosine 0.99998 or better (silhouette IoU, LPIPS on
    the masked texture, the GAN's input gradient).
  * the card's route against the plain route at face_chunk=1: scalars
    rtol 1e-5 (reading 2.4e-7), gradients cosine >= 0.9999 (reading
    0.9999999); against the plain route at JAX's chunk the same, but
    tex_cycle_loss rtol 0.1 (reading 3.4e-2: the two p2f rules) and
    total_loss, which sums it, rtol 1e-3 (reading 1.0e-4).
  * encode_feat: rtol 1e-4 (reading 2.2e-7); template update: atol 1e-6
    (reading 1.2e-7).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import flax_flat, flax_variables, np_of, t_of
from umr_tpu.config import Config as JaxConfig
from umr_tpu.mesh import build_template as jax_template
from umr_tpu.models.weight_io import load_lpips_params
from umr_tpu.training import steps as jsteps
from umr_tpu_torch.cli import S1_DEFAULTS
from umr_tpu_torch.config import Config
from umr_tpu_torch.data import synthetic_batch
from umr_tpu_torch.experiments import train_s1
from umr_tpu_torch.mesh import build_template
from umr_tpu_torch.models import MeshNetS1, init_weights
from umr_tpu_torch.models.weights import (WEIGHTS_DIR,
                                          discriminator_state_from_flax,
                                          load_checkpoint)
from umr_tpu_torch.ops import raster_kernel
from umr_tpu_torch.training import steps as tsteps
from umr_tpu_torch.training.trainer import Trainer, prepare_batch

IMG = 32
LR = 1e3
B = 4
KW = dict(image_size=IMG, img_size=IMG, batch_size=B, anti_aliasing=False,
          subdivide=2, tex_size=2, nz_feat=32, z_dim=24, use_sgd=True,
          learning_rate=LR, face_chunk=320, **S1_DEFAULTS)
JAX_KW = dict(pixel_rows_per_block=IMG)
MODEL_SCALARS = ("deform_loss", "flatten_loss", "tri_loss", "ori_loss",
                 "uv_flow_area", "acc_gan")
OUTPUTS = ("delta_v", "cam", "tex_flow", "uvimage_pred", "feat", "mean",
           "logvar")


def _params(state):
    return {f"{p}.{n}": t.detach().clone()
            for p, mod in (("model", state.model), ("disc", state.disc))
            for n, t in mod.named_parameters()}


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _get(tree, path):
    for part in path.split("/"):
        tree = tree[part]
    return tree


def _eps_of(out):
    """The VAE noise a JAX forward drew, from its outputs."""
    mean, logvar = np.asarray(out["mean"]), np.asarray(out["logvar"])
    return t_of(((np.asarray(out["feat"]) - mean)
                 * np.exp(-0.5 * logvar)).astype(np.float32))


@pytest.fixture(scope="module")
def s1():
    """Both steps on the same weights, batch and draws; the JAX step is
    compiled once, and run at epoch 0 and 10 from the same state."""
    cfg = Config(**KW)
    template = build_template(2, 1, 2)
    jt = jax_template(2, 1, 2)
    (_, _, _, init_fn, step_fn, encode_fn,
     update_fn) = tsteps.build_s1_step(cfg, template, "cpu")
    state = init_fn(0)
    with torch.no_grad():          # a template away from the init's
        state.model.mean_v.add_(t_of(np.random.RandomState(8).normal(
            0.0, 0.05, state.model.mean_v.shape).astype(np.float32)))
    batch = synthetic_batch(np.random.RandomState(3), B, IMG)

    jcfg = JaxConfig(**KW, **JAX_KW)
    (jmodel, jdisc, _, _, jstep, jencode,
     jupdate) = jsteps.build_s1_step(jcfg, jt)
    variables = flax_variables(state.model, template, 0, stage=1)
    dparams = jdisc.init(jax.random.key(9), jnp.zeros((2, IMG, IMG, 1)))[
        "params"]
    state.disc.load_state_dict(discriminator_state_from_flax(dparams))
    params = {"model": variables["params"], "disc": dparams}
    jstate = jsteps.TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats={"model": variables["batch_stats"]}, buffers={},
        template=variables["template"],
        opt_state=jsteps.make_optimizer(jcfg).init(params),
        lpips=load_lpips_params(os.path.join(WEIGHTS_DIR, "lpips_alex.npz")))
    db = prepare_batch(batch, cfg.use_scops, cfg.use_texture)
    jbatch = {k: jnp.asarray(v) for k, v in db.items()}
    key = jax.random.key(1)
    jsc, jstate1 = {}, None
    for epoch in (0.0, 10.0):
        st, sc = jstep(jstate, jbatch, key, jnp.float32(epoch))
        jsc[epoch] = {k: float(v) for k, v in sc.items()}
        jstate1 = jstate1 or st

    # the JAX step's draws: its key split as loss_fn splits it
    k_sample, k_gan = jax.random.split(key)
    jout, _ = jmodel.apply(
        {**variables, "params": params["model"]}, jbatch["input_img"],
        train=True, rngs={"sample": k_sample}, mutable=["batch_stats"])
    angles = t_of(np.array(jax.random.randint(k_gan, (B,), 0, 180)))
    draws = dict(eps=_eps_of(jout), angles=angles)

    jgrads = {}
    for pre in ("model", "disc"):
        for k, v in _flatten(jstate.params[pre]).items():
            jgrads[f"{pre}/{k}"] = (np.asarray(v) - np.asarray(
                _get(jstate1.params[pre], k))) / LR
    snapshot = ({k: v.clone() for k, v in state.model.state_dict().items()},
                {k: v.clone() for k, v in state.disc.state_dict().items()})
    return dict(cfg=cfg, template=template, db=db, jbatch=jbatch,
                state=state, step_fn=step_fn, encode_fn=encode_fn,
                update_fn=update_fn, snapshot=snapshot, draws=draws,
                jsc=jsc, jgrads=jgrads, jout=jout, jmodel=jmodel,
                variables=variables, jstate=jstate, jencode=jencode,
                jupdate=jupdate)


def _port_run(s1, epoch=0.0, impl="auto", **cfg_kw):
    """One port step from the fixture's weights: (scalars, gradients)."""
    if impl == "auto" and not cfg_kw:
        step_fn, state = s1["step_fn"], s1["state"]
    else:
        _, _, _, init_fn, step_fn, _, _ = tsteps.build_s1_step(
            s1["cfg"].replace(**cfg_kw), s1["template"], "cpu", impl=impl)
        state = init_fn(0)
    state.model.load_state_dict(s1["snapshot"][0])
    state.disc.load_state_dict(s1["snapshot"][1])
    state.step = state.updates = 0
    p0 = _params(state)
    state, sc = step_fn(state, s1["db"], epoch, s1["draws"])
    p1 = _params(state)
    grads = {k: np_of((p0[k] - p1[k]) / LR) for k in p0}
    state.model.load_state_dict(s1["snapshot"][0])
    state.disc.load_state_dict(s1["snapshot"][1])
    return {k: float(v) for k, v in sc.items()}, grads


@pytest.fixture(scope="module")
def port_auto(s1):
    return _port_run(s1)


def _jax_grads_torch_layout(s1, names):
    """The JAX gradients under the port's names, in the port's layout."""
    from umr_tpu.models.reference_io import _apply_transform, build_key_map

    n_up = min(5, int(np.log2(s1["template"].uv_image_size()[0])))
    pm, _, _, _ = build_key_map(1, 0, n_up)
    m = {f"model.{tkey}": ("model/" + "/".join(path),
                           lambda a, tf=tf: _apply_transform(a, tf,
                                                             to_flax=False))
         for path, tkey, tf in pm}
    for i, t in enumerate(["convs.0", "convs.1", "convs.2", "convs.3",
                           "head"]):
        m[f"disc.{t}.weight"] = (f"disc/Conv_{i}/kernel",
                                 lambda a: a.transpose(3, 2, 0, 1))
        m[f"disc.{t}.bias"] = (f"disc/Conv_{i}/bias", lambda a: a)
    m["disc.fc.weight"] = ("disc/Dense_0/kernel", lambda a: a.T)
    m["disc.fc.bias"] = ("disc/Dense_0/bias", lambda a: a)
    return {k: m[k][1](s1["jgrads"][m[k][0]]) for k in names}


def _cosine(a, b):
    x = np.concatenate([v.ravel() for v in a.values()]).astype(np.float64)
    y = np.concatenate([b[k].ravel() for k in a]).astype(np.float64)
    return float(x @ y / (np.linalg.norm(x) * np.linalg.norm(y)))


def _assert_outputs_close(out, ref, atol):
    for k in OUTPUTS:
        want = np.asarray(ref[k])
        np.testing.assert_allclose(np_of(out[k]), want, rtol=0,
                                   atol=atol * np.abs(want).max(),
                                   err_msg=k)


def test_meshnet_s1_matches_jax_train_and_eval(s1):
    model, draws = s1["state"].model, s1["draws"]
    model.load_state_dict(s1["snapshot"][0])
    img = t_of(s1["db"]["input_img"])
    model.train()
    with torch.no_grad():
        _assert_outputs_close(model(img, eps=draws["eps"]), s1["jout"],
                              5e-3)
    model.load_state_dict(s1["snapshot"][0])   # BN running stats back
    key = jax.random.key(5)
    ref = s1["jmodel"].apply(s1["variables"], s1["jbatch"]["input_img"],
                             train=False, rngs={"sample": key})
    model.eval()
    with torch.no_grad():
        out = model(img, eps=_eps_of(ref))
    _assert_outputs_close(out, ref, 1e-5)


@pytest.mark.parametrize("epoch", [0.0, 10.0])
def test_s1_scalars_match_jax(s1, port_auto, epoch):
    """Epoch 0 takes the orientation reg and not the deform reg; epoch 10
    the deform reg and not the orientation reg."""
    sc = port_auto[0] if epoch == 0.0 else _port_run(s1, epoch)[0]
    jsc = s1["jsc"][epoch]
    assert sorted(sc) == sorted(jsc)
    for k, v in jsc.items():
        rtol = 1e-4 if k in MODEL_SCALARS else 2e-3
        np.testing.assert_allclose(sc[k], v, rtol=rtol, atol=1e-7,
                                   err_msg=k)
    assert sc["tex_cycle_loss"] > 0
    cfg = s1["cfg"]
    gated = (sc["ori_loss"] * cfg.ori_reg_wt if epoch < cfg.stop_ori_epoch
             else sc["deform_loss"] * cfg.deform_reg_wt)
    ungated = (sc["mask_loss"] * cfg.mask_loss_wt
               + sc["tri_loss"] * cfg.triangle_reg_wt
               + sc["flatten_loss"] * cfg.flatten_reg_wt
               + sc["tex_loss"] * cfg.tex_loss_wt
               + sc["tex_dt_loss"] * cfg.tex_dt_loss_wt
               + sc["tex_cycle_loss"] * cfg.tex_cycle_loss_wt
               + sc["gan_loss"] * cfg.gan_loss_wt)
    np.testing.assert_allclose(sc["total_loss"], ungated + gated, rtol=1e-5)


def test_s1_gradients_match_jax(s1, port_auto):
    _, g = port_auto
    jg = _jax_grads_torch_layout(s1, g)
    total = np.sqrt(sum(np.sum(v.astype(np.float64) ** 2)
                        for v in jg.values()))
    assert total > 0
    for k in g:
        err = np.linalg.norm(g[k] - jg[k])
        assert err <= 0.5 * np.linalg.norm(jg[k]) + 1e-6 * total, k
    assert _cosine(g, jg) >= 0.99


def test_s1_kernel_route_on_cpu_matches_plain(s1, port_auto):
    """The card's route: the fused mask + texture render with p2f through
    the Function, the mask-only GAN render, shared bins."""
    n0 = (raster_kernel.LAUNCHES, raster_kernel.BWD_LAUNCHES,
          raster_kernel.P2F_LAUNCHES)
    sc_k, g_k = _port_run(s1, impl="kernel")
    assert (raster_kernel.LAUNCHES, raster_kernel.BWD_LAUNCHES,
            raster_kernel.P2F_LAUNCHES) == n0     # the plain versions ran
    sc_1, g_1 = _port_run(s1, face_chunk=1)
    for (sc, g), rtol in (((sc_1, g_1), {}),
                          (port_auto, dict(tex_cycle_loss=0.1,
                                           total_loss=1e-3))):
        for k, v in sc.items():
            np.testing.assert_allclose(sc_k[k], v, rtol=rtol.get(k, 1e-5),
                                       atol=1e-7, err_msg=k)
        assert _cosine(g_k, g) >= 0.9999


def test_encode_feat_and_template_update_match_jax(s1):
    state = s1["state"]
    state.model.load_state_dict(s1["snapshot"][0])
    key = jax.random.key(2)
    jfeat = s1["jencode"](s1["jstate"], s1["jbatch"], key)
    # its noise: the eval forward's, recovered from its mean and logvar
    ref = s1["jmodel"].apply(s1["variables"], s1["jbatch"]["input_img"],
                             train=False, rngs={"sample": key})
    feat = s1["encode_fn"](state, s1["db"], eps=_eps_of(ref))
    np.testing.assert_allclose(np_of(feat), np.asarray(jfeat), rtol=1e-4,
                               atol=1e-6)
    assert not state.model.training
    feat_mean = np.asarray(jfeat).mean(0)
    jnew = np.asarray(s1["jupdate"](s1["jstate"], jnp.asarray(feat_mean))
                      .template["mean_v"])
    before = state.model.mean_v.clone()
    s1["update_fn"](state, t_of(feat_mean))
    moved = np_of(state.model.mean_v)
    np.testing.assert_allclose(moved, jnew, rtol=0, atol=1e-6)
    assert np.abs(moved - np_of(before)).max() > 1e-6
    state.model.load_state_dict(s1["snapshot"][0])


@pytest.mark.parametrize("keys", ["flax", "torch"])
def test_s1_checkpoint_loads(tmp_path, keys):
    """A stage-1 .pth, with the JAX package's flax-path keys (what its
    trainer saves) or the port's torch keys, loads into MeshNetS1; the
    QuatHead's bias is zero at init (stage 1), (1, 0, 0, 0) in stage 2."""
    template = build_template(2, 1, 2)
    a = init_weights(MeshNetS1(template, input_size=32, nz_feat=16,
                               z_dim=8), torch.Generator().manual_seed(0))
    assert not a.quat_predictor.pred_layer.bias.any()
    with torch.no_grad():
        a.mean_v.add_(0.1)
        for mod in a.modules():
            if isinstance(mod, torch.nn.BatchNorm1d):
                mod.running_var.fill_(2.0)
    if keys == "flax":
        flat = flax_flat(flax_variables(a, template, 0, stage=1))
        sd = {k: torch.as_tensor(v) for k, v in flat.items()}
    else:
        sd = a.state_dict()
    path = tmp_path / "pred_net_latest.pth"
    torch.save(sd, path)
    b = MeshNetS1(template, input_size=32, nz_feat=16, z_dim=8)
    load_checkpoint(b, str(path))
    for k, v in a.state_dict().items():
        np.testing.assert_array_equal(np_of(b.state_dict()[k]), np_of(v),
                                      err_msg=k)


def test_check_supported_by_stage():
    """What the JAX package cannot run either is refused: pred_cam=False
    in both steps and the eval model (no camera to render at),
    multiple_cam_hypo=False in the stage-2 step (no hypotheses); stage 1
    reads no hypothesis flag and the eval model takes one camera. The
    other flags build in both stages."""
    from umr_tpu_torch.config import check_supported

    one_cam = Config(multiple_cam_hypo=False)
    check_supported(one_cam, stage=1)
    check_supported(one_cam, train=False)
    with pytest.raises(NotImplementedError, match="multiple_cam_hypo"):
        check_supported(one_cam)
    for stage, train in ((1, True), (2, True), (2, False)):
        with pytest.raises(NotImplementedError, match="pred_cam"):
            check_supported(Config(pred_cam=False), stage=stage,
                            train=train)
    for k, v in (("use_texture", False), ("use_gan", False), ("bf16", True),
                 ("az_ele_quat", True)):
        check_supported(Config(**{k: v}))
        check_supported(Config(**{k: v}), stage=1)
    tsteps.build_s1_step(Config(**KW, use_gan=False),
                         build_template(2, 1, 2), "cpu")
    with pytest.raises(NotImplementedError, match="pred_cam"):
        tsteps.build_s1_step(Config(**KW, pred_cam=False),
                             build_template(2, 1, 2), "cpu")


@dataclasses.dataclass
class _CountingState(tsteps.TrainState):
    ends: int = 0                    # on_epoch_end calls


def _counting_state():
    """A TrainState (the trainer checkpoints it) over tiny modules, with an
    epoch-end counter `ends`."""
    model, disc = torch.nn.Linear(2, 2), torch.nn.Linear(1, 1)
    opt = torch.optim.SGD(list(model.parameters()) + list(disc.parameters()),
                          lr=0.1)
    return _CountingState(step=0, updates=0, model=model, disc=disc,
                          lpips=None, optimizer=opt,
                          generator=torch.Generator())


def test_trainer_hooks(tmp_path):
    """extra_step_args(epoch) reach each step; on_epoch_end runs after
    each whole epoch and its state is kept; a run cut by num_iter inside
    an epoch skips that epoch's hook. Both hooks return new states, so
    a trainer that dropped either would fail."""
    calls = []

    def step_fn(state, db, epoch):
        calls.append(("step", state.step, state.ends, epoch))
        return (dataclasses.replace(state, step=state.step + 1),
                {"total_loss": torch.tensor(float(state.step))})

    def on_epoch_end(state, epoch):
        calls.append(("end", state.step, state.ends, epoch))
        return dataclasses.replace(state, ends=state.ends + 1)

    loader = [synthetic_batch(np.random.RandomState(i), 2, IMG)
              for i in range(2)]
    cfg = Config(num_epochs=2, print_scalars=False,
                 checkpoint_dir=str(tmp_path), name="a")
    start = _counting_state()
    t = Trainer(cfg, step_fn, start, loader,
                extra_step_args=lambda epoch: (epoch * 0.5,),
                on_epoch_end=on_epoch_end)
    assert t.train() == dataclasses.replace(start, step=4, ends=2)
    assert (start.step, start.ends) == (0, 0)
    assert calls == [("step", 0, 0, 0.0), ("step", 1, 0, 0.0),
                     ("end", 2, 0, 0), ("step", 2, 1, 0.5),
                     ("step", 3, 1, 0.5), ("end", 4, 1, 1)]
    assert [sc["total_loss"] for sc in t.history] == [0.0, 1.0, 2.0, 3.0]
    calls.clear()
    start = _counting_state()
    t = Trainer(cfg.replace(num_iter=3, name="b"), step_fn, start, loader,
                extra_step_args=lambda epoch: (epoch * 0.5,),
                on_epoch_end=on_epoch_end)
    assert t.train() == dataclasses.replace(start, step=3, ends=1)
    assert [c[0] for c in calls] == ["step", "step", "end", "step"]


def test_train_s1_run_on_cpu(tmp_path):
    """2 steps over a 2-batch loader, one epoch, the template updated at
    its end; without a device the entry point asks for the card. The run
    writes into a checkpoint directory under tmp_path."""
    cfg = Config(**dict(KW, use_sgd=False, learning_rate=1e-4),
                 num_epochs=1, update_template_freq=1, print_scalars=False,
                 checkpoint_dir=str(tmp_path))
    loader = [synthetic_batch(np.random.RandomState(10 + i), B, IMG)
              for i in range(2)]
    template = build_template(2, 1, 2)
    trainer = train_s1.run(cfg, loader, device="cpu")
    assert trainer.state.step == trainer.state.updates == 2
    assert trainer.template_updates == [(0, 2 * B)]
    for sc in trainer.history:
        assert all(np.isfinite(v) for v in sc.values()), sc
        assert sc["tex_cycle_loss"] > 0
    moved = np.abs(np_of(trainer.state.model.mean_v)
                   - template.mean_v_init).max()
    assert moved > 0
    assert train_s1.config(["--batch_size", "8"]).mask_loss_wt == 3.0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_s1.run(cfg, loader)
