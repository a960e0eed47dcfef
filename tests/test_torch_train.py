"""Port parity of the stage-2 training step, and its loop.

The port's step (training/steps.py) against the JAX package's
build_s2_step on the CPU at the config of tests/test_train_steps.py
(image 32, K=2, subdivide 2, tex_size 2, no anti-aliasing; narrow heads)
but batch 4: at batch 2 every BatchNorm over a 1x1 map (ResNet layer4,
enc_conv1, the fc stacks) normalises two values, which turns last-ulp
differences into 2.6e-2 differences of the encoder's features between any
two float32 implementations (reading: ResNet layers 1-3 agree to 1e-5,
layer4 to 1.8e-3, enc_conv1 to 0.16; at batch 4 the features agree to
3e-4). Same weights (the port's, converted; the discriminator's from a
flax init, converted the other way; LPIPS from the committed npz), the
same batch, and the JAX step's random draws injected (its key split into
k_sample, k_gan as the step splits it).

Gradients, not post-Adam parameters, are compared: one SGD step at a
large learning rate on both sides makes (p0 - p1) / lr the gradient.
(Adam's first update is about lr * sign(g): noise in a tiny gradient
flips a whole update.) The Adam update is compared apart, on identical
gradients.

Tolerances, from the readings of this file's inputs:
  * scalars of the model alone (cam_div, corr, deform, flatten, tri,
    uv_flow_area, acc_gan): rtol 1e-4 (reading 8.9e-6); the others, which
    pass through renders or the train-mode encoder's texture flow: rtol
    2e-3 (reading 1.03e-3, part_loss; the rasterizers differ at a few
    sliver and texel-border pixels, tests/test_torch_losses.py).
  * gradients, exact AD on both sides (XLA's dense rasterizer against the
    port's plain route): cosine of all gradients flattened >= 0.998
    (reading 0.99928); per tensor ||g - g_jax|| <= 0.3 ||g_jax|| + 1e-6
    x the norm of all gradients (reading: 0.19 at most, the geometry
    gradients through sigma-1e-5 silhouettes; the biases in front of a
    train-mode BatchNorm have gradient 0 up to noise of ~1e-4, which the
    second term covers).
  * the card's route on the CPU (the Function with the reference CUDA
    backward's semantics, the fused hypothesis render, the merged part +
    GAN render, shared bins) against the exact-AD route: scalars equal to
    rtol 1e-5 (the forwards are the same arithmetic; reading: equal);
    gradients cosine >= 0.9999 (reading 0.9999998; the CUDA semantics
    drop the depth-gated and the fused render's rgb-to-geometry terms, as
    the reference does).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_parity import flax_variables, injected_draws, np_of, t_of
from umr_tpu.config import Config as JaxConfig
from umr_tpu.losses.composite import PartMatchingLoss as JaxPartLoss
from umr_tpu.mesh import build_template as jax_template
from umr_tpu.models.weight_io import load_lpips_params
from umr_tpu.renderer import SoftRenderer as JaxRenderer
from umr_tpu.training import steps as jsteps
from umr_tpu_torch.config import Config
from umr_tpu_torch.data import synthetic_batch
from umr_tpu_torch.experiments import train_s2
from umr_tpu_torch.losses.composite import PartMatchingLoss
from umr_tpu_torch.mesh import build_template
from umr_tpu_torch.models.weights import (WEIGHTS_DIR,
                                          discriminator_state_from_flax)
from umr_tpu_torch.ops import raster_kernel
from umr_tpu_torch.renderer import SoftRenderer
from umr_tpu_torch.training import steps as tsteps
from umr_tpu_torch.training.trainer import Trainer, prepare_batch

IMG = 32
LR = 1e3
KW = dict(image_size=IMG, img_size=IMG, batch_size=4, num_hypo_cams=2,
          anti_aliasing=False, subdivide=2, tex_size=2, nz_feat=32, z_dim=24,
          use_sgd=True, learning_rate=LR)
JAX_KW = dict(face_chunk=320, pixel_rows_per_block=IMG)
MODEL_SCALARS = ("cam_div_loss", "corr_loss", "deform_loss", "flatten_loss",
                 "tri_loss", "uv_flow_area", "acc_gan")


def _semantic(template):
    rng = np.random.RandomState(5)
    seg = rng.randint(0, 5, size=(16, 32)).astype(np.float32)
    idx = rng.permutation(template.num_verts)
    return seg, [idx[0:20], idx[20:60], idx[60:80], idx[80:120]]


def _port_step(cfg, template, seg, pvi, impl="auto"):
    pr = SoftRenderer(image_size=IMG, anti_aliasing=False,
                      ambient_intensity=1.0, directional_intensity=0.0,
                      impl=impl)
    pl = PartMatchingLoss.build(seg, template.uv_sampler,
                                template.num_sym_faces, pr, tex_size=2)
    return tsteps.build_s2_step(cfg, template, pl, pvi, "cpu", impl=impl)


def _params(state):
    return {f"{p}.{n}": t.detach().clone()
            for p, mod in (("model", state.model), ("disc", state.disc))
            for n, t in mod.named_parameters()}


@pytest.fixture(scope="module")
def s2():
    """Both steps on the same weights, batch and draws; the JAX step is
    compiled once here."""
    cfg = Config(**KW)
    template = build_template(2, 1, 2)
    jt = jax_template(2, 1, 2)
    seg, pvi = _semantic(template)
    _, _, _, init_fn, step_fn = _port_step(cfg, template, seg, pvi)
    state = init_fn(0)
    batch = synthetic_batch(np.random.RandomState(3), 4, IMG)

    jcfg = JaxConfig(**KW, **JAX_KW)
    jpr = JaxRenderer(image_size=IMG, anti_aliasing=False,
                      ambient_intensity=1.0, directional_intensity=0.0,
                      **JAX_KW)
    jpl = JaxPartLoss.build(seg, jt.uv_sampler, jt.num_sym_faces, jpr,
                            tex_size=2)
    jmodel, jdisc, _, _, jstep = jsteps.build_s2_step(jcfg, jt, jpl, pvi)
    variables = flax_variables(state.model, template, cfg.num_hypo_cams)
    dparams = jdisc.init(jax.random.key(9), jnp.zeros((2, IMG, IMG, 3)))[
        "params"]
    state.disc.load_state_dict(discriminator_state_from_flax(dparams))
    params = {"model": variables["params"], "disc": dparams}
    jstate = jsteps.TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats={"model": variables["batch_stats"]},
        buffers=variables["buffers"], template=variables["template"],
        opt_state=jsteps.make_optimizer(jcfg).init(params),
        lpips=load_lpips_params(os.path.join(WEIGHTS_DIR, "lpips_alex.npz")))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.key(1)
    jstate1, jsc = jstep(jstate, jbatch, key)

    # the JAX step's draws: its key split as loss_fn splits it
    k_sample, k_gan = jax.random.split(key)
    out, _ = jmodel.apply(
        {**variables, "params": params["model"]}, jbatch["input_img"],
        train=True, rngs={"sample": k_sample}, mutable=["batch_stats"])
    eps, inds = injected_draws(out)
    angles = torch.as_tensor(np.asarray(
        jax.random.randint(k_gan, (4,), 0, 180)))
    draws = dict(eps=eps, sample_inds=inds, angles=angles)

    flat = {}
    for pre, tree in (("model", jstate.params["model"]),
                      ("disc", jstate.params["disc"])):
        for k, v in _flatten(tree).items():
            flat[f"{pre}/{k}"] = (np.asarray(v), np.asarray(
                _get(jstate1.params[pre], k)))
    jgrads = {k: (a - b) / LR for k, (a, b) in flat.items()}
    return dict(cfg=cfg, template=template, seg=seg, pvi=pvi, batch=batch,
                state=state, step_fn=step_fn, draws=draws,
                jsc={k: float(v) for k, v in jsc.items()}, jgrads=jgrads)


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


def _port_run(s2, impl="auto", **cfg_kw):
    """One port step from the fixture's weights: (scalars, gradients as
    (p0 - p1) / lr under the torch names)."""
    if impl == "auto" and not cfg_kw:
        step_fn, state = s2["step_fn"], s2["state"]
        snapshot = {k: v.clone() for k, v in state.model.state_dict().items()}
        dsnap = {k: v.clone() for k, v in state.disc.state_dict().items()}
    else:
        _, _, _, init_fn, step_fn = _port_step(
            s2["cfg"].replace(**cfg_kw), s2["template"], s2["seg"],
            s2["pvi"], impl)
        state = init_fn(0)
        state.model.load_state_dict(s2["snapshot"])
        state.disc.load_state_dict(s2["dsnap"])
    p0 = _params(state)
    state, sc = step_fn(state, prepare_batch(s2["batch"]), s2["draws"])
    p1 = _params(state)
    grads = {k: np_of((p0[k] - p1[k]) / LR) for k in p0}
    if impl == "auto" and not cfg_kw:
        s2["snapshot"], s2["dsnap"] = snapshot, dsnap
    return {k: float(v) for k, v in sc.items()}, grads


@pytest.fixture(scope="module")
def port_auto(s2):
    return _port_run(s2)


def _torch_name_map(s2):
    """port parameter name -> (JAX flat name, transform to the port's
    layout) for every parameter, through the JAX package's key map."""
    from umr_tpu.models.reference_io import _apply_transform, build_key_map

    n_up = min(5, int(np.log2(s2["template"].uv_image_size()[0])))
    pm, _, _, _ = build_key_map(2, s2["cfg"].num_hypo_cams, n_up)
    out = {f"model.{tkey}": ("model/" + "/".join(path),
                             lambda a, tf=tf: _apply_transform(a, tf,
                                                               to_flax=False))
           for path, tkey, tf in pm}
    disc = {"convs.0": "Conv_0", "convs.1": "Conv_1", "convs.2": "Conv_2",
            "convs.3": "Conv_3", "head": "Conv_4"}
    for t, f in disc.items():
        out[f"disc.{t}.weight"] = (f"disc/{f}/kernel",
                                   lambda a: a.transpose(3, 2, 0, 1))
        out[f"disc.{t}.bias"] = (f"disc/{f}/bias", lambda a: a)
    out["disc.fc.weight"] = ("disc/Dense_0/kernel", lambda a: a.T)
    out["disc.fc.bias"] = ("disc/Dense_0/bias", lambda a: a)
    return out


def _jax_grads_torch_layout(s2, names):
    m = _torch_name_map(s2)
    return {k: m[k][1](s2["jgrads"][m[k][0]]) for k in names}


def _cosine(a, b):
    x = np.concatenate([v.ravel() for v in a.values()]).astype(np.float64)
    y = np.concatenate([b[k].ravel() for k in a]).astype(np.float64)
    return float(x @ y / (np.linalg.norm(x) * np.linalg.norm(y)))


def test_s2_scalars_match_jax(s2, port_auto):
    sc, _ = port_auto
    assert sorted(sc) == sorted(s2["jsc"])
    for k, v in s2["jsc"].items():
        rtol = 1e-4 if k in MODEL_SCALARS else 2e-3
        np.testing.assert_allclose(sc[k], v, rtol=rtol, atol=1e-7,
                                   err_msg=k)


def test_s2_gradients_match_jax(s2, port_auto):
    _, g = port_auto
    jg = _jax_grads_torch_layout(s2, g)
    total = np.sqrt(sum(np.sum(v.astype(np.float64) ** 2)
                        for v in jg.values()))
    assert total > 0
    for k in g:
        err = np.linalg.norm(g[k] - jg[k])
        assert err <= 0.3 * np.linalg.norm(jg[k]) + 1e-6 * total, k
    assert _cosine(g, jg) >= 0.998


def test_kernel_route_on_cpu_matches_exact_ad(s2, port_auto):
    """The card's route on the CPU: fused fold through the Function, the
    merged part + GAN pass, shared bins; the kernels' plain versions."""
    sc_a, g_a = port_auto
    f0, b0 = raster_kernel.LAUNCHES, raster_kernel.BWD_LAUNCHES
    sc_k, g_k = _port_run(s2, impl="kernel")
    assert (raster_kernel.LAUNCHES, raster_kernel.BWD_LAUNCHES) == (f0, b0)
    for k, v in sc_a.items():
        np.testing.assert_allclose(sc_k[k], v, rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    assert _cosine(g_k, g_a) >= 0.9999


def test_cycle_soft_p2f_changes_the_cycle_target_only(s2, port_auto):
    """cycle_soft_p2f: the texture-cycle target is the soft render's p2f
    at the sampled camera, not the hard render's zeros. Against the JAX
    step without the flag every other scalar agrees as in
    test_s2_scalars_match_jax; the cycle loss agrees with JAX's
    renderer and loss on the port's own forward (rtol 2e-3, reading
    1.5e-4), and the rest of the total as JAX's (reading 2.6e-4)."""
    from umr_tpu.losses.losses import tex_cycle_loss as jax_cycle
    from umr_tpu_torch.models import symmetrize
    from umr_tpu_torch.ops.grid_sample import sample_textures

    sc, _ = _port_run(s2, cycle_soft_p2f=True)
    jsc, cfg = s2["jsc"], s2["cfg"]
    for k, v in jsc.items():
        if k in ("tex_cycle_loss", "total_loss"):
            continue
        rtol = 1e-4 if k in MODEL_SCALARS else 2e-3
        np.testing.assert_allclose(sc[k], v, rtol=rtol, atol=1e-7,
                                   err_msg=k)
    assert abs(sc["tex_cycle_loss"] - jsc["tex_cycle_loss"]) > 1e-3
    np.testing.assert_allclose(
        sc["total_loss"] - sc["tex_cycle_loss"] * cfg.tex_cycle_loss_wt,
        jsc["total_loss"] - jsc["tex_cycle_loss"] * cfg.tex_cycle_loss_wt,
        rtol=2e-3)

    # JAX's soft p2f and cycle loss on the step's forward
    model, t = s2["state"].model, s2["template"]
    model.load_state_dict(s2["snapshot"])
    db = prepare_batch(s2["batch"])
    with torch.no_grad():
        model.train()
        out = model(t_of(db["input_img"]), eps=s2["draws"]["eps"],
                    sample_inds=s2["draws"]["sample_inds"])
        pred_vs = (symmetrize(model.mean_v, t)[None]
                   + symmetrize(out["delta_v"], t))
        tex = sample_textures(out["tex_flow"], t_of(db["img"]))
        tex = tex.reshape(tex.shape[0], tex.shape[1], -1, 3)
    model.load_state_dict(s2["snapshot"])
    common = dict(image_size=IMG, anti_aliasing=False, **JAX_KW)
    args = (jnp.asarray(np_of(pred_vs)), jnp.asarray(t.faces),
            jnp.asarray(np_of(out["cam"])))
    p2f = JaxRenderer(ambient_intensity=1.0, directional_intensity=0.0,
                      **common).render(*args, jnp.asarray(np_of(tex)),
                                       need_p2f=True).p2f
    ids = JaxRenderer(render_type="hard", **common).render(*args).aggr[:, 1]
    want = jax_cycle(jnp.asarray(np_of(out["tex_flow"])), p2f,
                     ids.reshape(ids.shape[0], -1))[0]
    np.testing.assert_allclose(sc["tex_cycle_loss"], float(want), rtol=2e-3)


@pytest.mark.parametrize("optim_bs", [1, 2])
def test_adam_update_matches_optax(optim_bs):
    """Identical gradients, 4 batches: the lr schedule, Adam's moments and
    bias correction, and accumulation (the mean of optim_bs batches)."""
    cfg = Config(learning_rate=1e-2, optim_bs=optim_bs)
    rng = np.random.RandomState(0)
    p0 = rng.standard_normal((5, 3)).astype(np.float32)
    grads = [rng.standard_normal((5, 3)).astype(np.float32)
             for _ in range(4)]
    tx = jsteps.make_optimizer(JaxConfig(learning_rate=1e-2,
                                         optim_bs=optim_bs))
    jp = {"w": jnp.asarray(p0)}
    opt_state = tx.init(jp)
    for g in grads:
        upd, opt_state = tx.update({"w": jnp.asarray(g)}, opt_state, jp)
        jp = optax.apply_updates(jp, upd)
    w = torch.nn.Parameter(t_of(p0.copy()))
    opt = tsteps.make_optimizer(cfg, [w])
    updates = 0
    for i, g in enumerate(grads):
        w.grad = t_of(g) if w.grad is None else w.grad + t_of(g)
        if (i + 1) % optim_bs == 0:
            w.grad /= optim_bs
            for group in opt.param_groups:
                group["lr"] = tsteps.learning_rate(cfg, updates)
            opt.step()
            updates += 1
            w.grad = None
    # updates of ~1e-2 per step; torch and optax order Adam's division by
    # the bias corrections differently: a few ulps of |p| ~ 2
    np.testing.assert_allclose(np_of(w), np.asarray(jp["w"]), rtol=0,
                               atol=1e-6)
    assert np.abs(np_of(w) - p0).max() > 1e-3


def test_trainer_and_run_on_cpu(tmp_path):
    """train_s2.run takes 2 steps: finite losses, parameters changed, the
    GAN's real images one batch behind. Each run writes into its own
    checkpoint directory under tmp_path (the trainer auto-resumes from
    what it finds there)."""
    cfg = Config(**dict(KW, use_sgd=False, learning_rate=1e-4), num_iter=2,
                 print_scalars=False, checkpoint_dir=str(tmp_path))
    template = build_template(2, 1, 2)
    seg, pvi = _semantic(template)
    rng = np.random.RandomState(4)
    loader = [synthetic_batch(rng, 2, IMG) for _ in range(3)]
    mean_v = template.mean_v_init * 1.1
    trainer = train_s2.run(cfg, loader, device="cpu",
                           semantic=(mean_v, seg, pvi))
    assert trainer.state.step == trainer.state.updates == 2
    assert len(trainer.history) == 2
    for sc in trainer.history:
        assert all(np.isfinite(v) for v in sc.values()), sc
    np.testing.assert_allclose(np_of(trainer.state.model.mean_v), mean_v)

    # the lag, and parameters that move
    seen = []

    def recording_step(state, db):
        seen.append(db["real_imgs"])
        return step(state, db)

    _, _, _, init_fn, step = _port_step(cfg, template, seg, pvi)
    state = init_fn(0)
    before = _params(state)
    t = Trainer(cfg.replace(name="lag"), recording_step, state, loader)
    t.train()
    reals = [b["img"] * b["mask"][..., None] for b in loader]
    np.testing.assert_array_equal(seen[0], reals[0])
    np.testing.assert_array_equal(seen[1], reals[0])
    after = _params(t.state)
    assert any((after[k] - before[k]).abs().max() > 0 for k in before)


def test_step_ranges_split_a_trace(tmp_path):
    """The step's profiler ranges are in its trace, and range_split gives
    each device event to the innermost range open at its launch. The CPU
    trace has no device events: each aten op stands in for a kernel
    launched at its start, as the card's trace pairs them by correlation
    id."""
    from torch.profiler import ProfilerActivity, profile

    from umr_tpu_torch.experiments.profile_slice import range_split

    cfg = Config(**dict(KW, batch_size=2))
    template = build_template(2, 1, 2)
    seg, pvi = _semantic(template)
    _, _, _, init_fn, step_fn = _port_step(cfg, template, seg, pvi)
    state = init_fn(0)
    db = prepare_batch(synthetic_batch(np.random.RandomState(6), 2, IMG))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step_fn(state, db)
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    ranges = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    names = {"s2.forward", "s2.model", "s2.pass1_fold", "s2.lpips",
             "s2.pass2_hard", "s2.pass3_merged", "s2.backward",
             "s2.optimizer"}
    assert names <= ranges

    fake = []
    for i, e in enumerate(e for e in events if e.get("cat") == "cpu_op"
                          and e["name"].startswith("aten::")):
        fake.append({"cat": "cuda_runtime", "name": "cudaLaunchKernel",
                     "ts": e["ts"], "dur": 1, "args": {"correlation": i}})
        fake.append({"cat": "kernel", "name": e["name"], "ts": 0.0,
                     "dur": 1000.0, "args": {"correlation": i}})
    n_ops = len(fake) // 2
    fake.append({"cat": "kernel", "name": "unmatched", "ts": 0.0,
                 "dur": 2000.0, "args": {"correlation": -1}})
    split = range_split(events + fake, "s2.", steps=2)
    assert names <= set(split)
    assert split["unmatched"] == pytest.approx(1.0)   # 2 ms over 2 steps
    assert sum(split.values()) == pytest.approx((n_ops * 1.0 + 2.0) / 2)
    # innermost: the model's ops count to s2.model, not to s2.forward
    (model,) = [r for r in events if r.get("cat") == "user_annotation"
                and r["name"] == "s2.model"]
    model_ops = sum(1 for e in events if e.get("cat") == "cpu_op"
                    and e["name"].startswith("aten::")
                    and model["ts"] <= e["ts"] <= model["ts"] + model["dur"])
    assert split["s2.model"] == pytest.approx(model_ops * 1.0 / 2)


def test_entry_points_default_to_the_card():
    """Without a device the entry points ask for the card, and raise where
    none is visible (a CPU-only host); the step raises on what the JAX
    package cannot run either (pred_cam=False: no camera to render at)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default is valid here")
    template = build_template(2, 1, 2)
    seg, pvi = _semantic(template)
    cfg = Config(**KW)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_s2.run(cfg, [synthetic_batch(np.random.RandomState(0), 2,
                                           IMG)], semantic=(None, seg, pvi))
    with pytest.raises(NotImplementedError, match="pred_cam"):
        _port_step(cfg.replace(pred_cam=False), template, seg, pvi)
