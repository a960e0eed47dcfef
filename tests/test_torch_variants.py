"""Port parity of the training flag variants: the model variants
(use_texture, multiple_cam_hypo, az_ele_quat), the kernels'
route of each step variant, and test_iou on a one-camera, untextured
checkpoint (the steps against the JAX package's are in
tests/test_torch_variant_steps.py, bf16 in tests/test_torch_bf16.py).

The models against the JAX package's on the same weights: the port's
seeded ones carried to flax through the key map (tests/torch_parity.py::
flax_variables, which skips the rows a variant has no module for), or,
for stage 2's single camera (a tree the JAX package's map has no rows
for), the JAX model's own init written by its save_pth and read by the
port's load_checkpoint. Image 32, batch 4, subdivide 2, tex_size 2,
narrow heads.

Tolerances, from the readings of this file's inputs:
  * models, eval mode: atol 1e-4 (as tests/test_torch_models.py); train
    mode (batch 4, BatchNorm over 1x1 maps): atol 5e-3 of the output's
    largest value (as tests/test_torch_train_s1.py).
  * the kernels' route on the CPU against the plain route: scalars
    rtol 1e-5, gradients cosine >= 0.9999 (as the default steps; stage 1
    textured at face_chunk 1 on both, the kernel's p2f rule).
  * test_iou: the mean IoU within 1e-3 (as tests/test_torch_slice.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (cosine, flax_variables, np_of, params_of,
                          part_semantic, t_of)
from umr_tpu.mesh import build_template as jax_template
from umr_tpu.models import MeshNet as JaxMeshNet
from umr_tpu.models import MeshNetS1 as JaxMeshNetS1
from umr_tpu_torch.cli import S1_DEFAULTS
from umr_tpu_torch.config import Config
from umr_tpu_torch.data import synthetic_batch
from umr_tpu_torch.experiments import test_iou
from umr_tpu_torch.losses.composite import PartMatchingLoss
from umr_tpu_torch.mesh import build_template
from umr_tpu_torch.models import MeshNet, MeshNetS1, init_weights
from umr_tpu_torch.models.weights import load_checkpoint
from umr_tpu_torch.ops import raster_kernel
from umr_tpu_torch.renderer import SoftRenderer
from umr_tpu_torch.training import steps as tsteps
from umr_tpu_torch.training.trainer import prepare_batch

IMG = 32
B = 4
LR = 1e3
WIDTHS = dict(nz_feat=32, z_dim=24)
S2_KW = dict(image_size=IMG, img_size=IMG, batch_size=B, num_hypo_cams=2,
             anti_aliasing=False, subdivide=2, tex_size=2, use_sgd=True,
             learning_rate=LR, **WIDTHS)
S1_KW = dict(image_size=IMG, img_size=IMG, batch_size=B,
             anti_aliasing=False, subdivide=2, tex_size=2, use_sgd=True,
             learning_rate=LR, face_chunk=320, **WIDTHS, **S1_DEFAULTS)


def _model_pair(stage, variant):
    """(port model, JAX model, JAX variables) on the port's seeded
    weights, BatchNorm affines and statistics randomised so that eval
    mode reads them."""
    template = build_template(2, 1, 2)
    cls, jcls = (MeshNet, JaxMeshNet) if stage == 2 else (MeshNetS1,
                                                          JaxMeshNetS1)
    extra = dict(num_hypo_cams=2) if stage == 2 else {}
    model = init_weights(cls(template, input_size=IMG, **WIDTHS, **extra,
                             **variant), torch.Generator().manual_seed(0))
    rng = np.random.RandomState(0)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (torch.nn.BatchNorm1d, torch.nn.BatchNorm2d)):
                n = mod.num_features
                mod.weight.copy_(t_of(rng.uniform(0.5, 1.5, n)).float())
                mod.running_mean.copy_(t_of(rng.normal(0, 0.1, n)).float())
                mod.running_var.copy_(t_of(rng.uniform(0.5, 2.0, n)).float())
    jmodel = jcls(template=jax_template(2, 1, 2), **WIDTHS, **extra,
                  **variant)
    return model, jmodel, flax_variables(model, template, 2 if stage == 2
                                         else 0, stage)


def _compare_outputs(model, jmodel, variables, img, train):
    jout = jax.jit(lambda v, x: jmodel.apply(
        v, x, train=train, rngs={"sample": jax.random.key(7)},
        mutable=["batch_stats"] if train else False))(variables,
                                                       jnp.asarray(img))
    if train:
        jout = jout[0]
    mean, logvar = np.asarray(jout["mean"]), np.asarray(jout["logvar"])
    noise = np.asarray(jout["noise" if "noise" in jout else "feat"])
    kw = {"eps": t_of(((noise - mean) * np.exp(-0.5 * logvar))
                      .astype(np.float32))}
    if "cam_sample_inds" in jout:
        kw["sample_inds"] = t_of(np.array(jout["cam_sample_inds"]))
    model.train(train)
    with torch.no_grad():
        out = model(t_of(img), **kw)
    assert sorted(out) == sorted(jout)
    for k in jout:
        want = np_of(jout[k])
        atol = 5e-3 * np.abs(want).max() if train else 1e-4
        np.testing.assert_allclose(np_of(out[k]), want, atol=atol,
                                   err_msg=f"{k} (train={train})")
    return out


@pytest.mark.parametrize("stage,variant", [
    (2, dict(use_texture=False)), (2, dict(az_ele_quat=True)),
    (1, dict(use_texture=False))], ids=lambda v: str(v))
def test_variant_models_match_jax(stage, variant):
    """Each variant's outputs (no tex_flow / uvimage_pred without texture)
    in eval and train mode."""
    model, jmodel, variables = _model_pair(stage, variant)
    img = np.random.RandomState(1).standard_normal(
        (B, IMG, IMG, 3)).astype(np.float32)
    for train in (False, True):
        out = _compare_outputs(model, jmodel, variables, img, train)
    if variant.get("az_ele_quat"):
        # the unused linear layer is there, 3 wide, as the reference's
        q = model.cam_predictor.camera_predictor[0].quat_predictor
        assert tuple(q.pred_layer.weight.shape) == (3, WIDTHS["nz_feat"])
        np.testing.assert_allclose(
            np.linalg.norm(np_of(out["cam_hypotheses"][..., 3:]), axis=-1),
            1.0, atol=1e-6)


@pytest.fixture(scope="module")
def one_camera(tmp_path_factory):
    """The JAX package's one-camera, untextured MeshNet-s2 (its own init;
    the VAE's log-variance pinned at -30, so that the eval forward does
    not depend on the noise draw), written by its save_pth: (path, JAX
    model, variables)."""
    from umr_tpu.training.checkpoints import save_pth

    jmodel = JaxMeshNet(template=jax_template(2, 1, 2), **WIDTHS,
                        multiple_cam_hypo=False, use_texture=False)
    variables = jax.jit(lambda k1, k2: jmodel.init(
        {"params": k1, "sample": k2}, jnp.zeros((2, IMG, IMG, 3)),
        train=True))(jax.random.key(0), jax.random.key(1))
    variables = jax.tree.map(np.asarray, variables)
    enc = variables["params"]["encoder"]["logvar_fc_1"]
    enc["kernel"] = np.zeros_like(enc["kernel"])
    enc["bias"] = np.full_like(enc["bias"], -30.0)
    path = str(tmp_path_factory.mktemp("one_camera") / "pred_net_latest.pth")
    save_pth(path, variables["params"], template=variables["template"],
             batch_stats=variables["batch_stats"])
    return path, jmodel, variables


def test_one_camera_model_round_trips_a_jax_pth(one_camera, tmp_path):
    """Stage 2's single camera (cub_mesh.py's names: cam_predictor.
    fc_layer, .quat_predictor, .prob_predictor, .scale_predictor,
    .trans_predictor) loads from a JAX-saved .pth; its outputs equal
    JAX's in eval and train mode ([q4, prob, s, t2] reordered to
    [s, t2, q4], cam_probs ones, sample_inds zeros); the port's own .pth
    of it reloads bit for bit."""
    path, jmodel, variables = one_camera
    template = build_template(2, 1, 2)
    model = MeshNet(template, input_size=IMG, **WIDTHS,
                    multiple_cam_hypo=False, use_texture=False)
    assert not any("camera_predictor" in k for k in model.state_dict())
    load_checkpoint(model, path)
    img = np.random.RandomState(2).standard_normal(
        (B, IMG, IMG, 3)).astype(np.float32)
    for train in (False, True):
        out = _compare_outputs(model, jmodel, variables, img, train)
    np.testing.assert_array_equal(np_of(out["cam_probs"]), 1.0)
    np.testing.assert_array_equal(np_of(out["cam_sample_inds"]), 0)
    torch.save(model.state_dict(), tmp_path / "port.pth")
    again = MeshNet(template, input_size=IMG, **WIDTHS,
                    multiple_cam_hypo=False, use_texture=False)
    load_checkpoint(again, str(tmp_path / "port.pth"))
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(np_of(again.state_dict()[k]),
                                      np_of(v), err_msg=k)


def test_test_iou_one_camera_untextured_matches_jax(one_camera, tmp_path,
                                                    monkeypatch):
    """test_iou.run builds the eval model from cfg.use_texture and
    multiple_cam_hypo, as the JAX package's does, and gives its mean
    IoU on the same checkpoint and batch; --visualize writes untextured
    meshes. (The JAX model's init, whose values load_pth overwrites,
    runs under jax.jit here: op by op it takes ~20 s.)"""
    from umr_tpu.config import Config as JaxConfig
    from umr_tpu.experiments import test_iou as jax_iou

    init = JaxMeshNet.init
    monkeypatch.setattr(JaxMeshNet, "init", lambda self, rngs, x, **kw: (
        jax.jit(lambda r, y: init(self, r, y, **kw))(rngs, x)))
    path = one_camera[0]
    cfg = Config(image_size=IMG, img_size=IMG, subdivide=2, tex_size=2,
                 **WIDTHS, model_path=path, use_texture=False,
                 multiple_cam_hypo=False, anti_aliasing=False, batch_size=2,
                 visualize=True, results_vis_dir=str(tmp_path / "vis"))
    batch = synthetic_batch(np.random.RandomState(4), 2, IMG)
    jcfg = JaxConfig(**{k: getattr(cfg, k) for k in (
        "image_size", "img_size", "subdivide", "tex_size", "nz_feat",
        "z_dim", "model_path", "use_texture", "multiple_cam_hypo",
        "anti_aliasing", "batch_size")}, face_chunk=320,
        pixel_rows_per_block=IMG)
    want = jax_iou.run(jcfg, dataloader=[batch])
    got = test_iou.run(cfg, dataloader=[batch], device="cpu")
    assert abs(got - want) <= 1e-3, (got, want)
    obj = (tmp_path / "vis" / "vis_iter_0" / "mesh_0.obj").read_text()
    assert "mtllib" not in obj and obj.count("\nf ") > 0


def _route_run(stage, cfg, impl, snapshot, db, draws):
    """One port step on `impl`'s route from a weight snapshot: (scalars,
    gradients, forward launches, p2f launches, backward launches),
    launches counted at the kernels' Function (the plain versions run
    here, so the wrappers' own counts do not move)."""
    template = build_template(2, 1, 2)
    if stage == 2:
        seg, pvi = part_semantic(template)
        pl = PartMatchingLoss.build(
            seg, template.uv_sampler, template.num_sym_faces,
            SoftRenderer(image_size=IMG, anti_aliasing=False,
                         ambient_intensity=1.0, directional_intensity=0.0,
                         impl=impl), tex_size=2)
        _, _, _, init_fn, step_fn = tsteps.build_s2_step(
            cfg, template, pl, pvi, "cpu", impl=impl)
        args = ()
    else:
        _, _, _, init_fn, step_fn, _, _ = tsteps.build_s1_step(
            cfg, template, "cpu", impl=impl)
        args = (0.0,)
    state = init_fn(0)
    if snapshot:
        state.model.load_state_dict(snapshot[0])
        state.disc.load_state_dict(snapshot[1])
    else:
        snapshot.extend([{k: v.clone() for k, v in
                          state.model.state_dict().items()},
                         {k: v.clone() for k, v in
                          state.disc.state_dict().items()}])
    counts = [0, 0, 0]
    function, bwd = raster_kernel._Raster, raster_kernel.raster_bwd

    class Counting:
        @staticmethod
        def apply(fv, tex, al_fids, astarts, kw):
            assert fv.dtype == tex.dtype == torch.float32
            counts[0] += 1
            counts[1] += int(kw["need_p2f"])
            return function.apply(fv, tex, al_fids, astarts, kw)

    def counting_bwd(*a, **k):
        counts[2] += 1
        return bwd(*a, **k)

    raster_kernel._Raster, raster_kernel.raster_bwd = Counting, counting_bwd
    try:
        p0 = params_of(state)
        state, sc = step_fn(state, db, *args, draws=draws)
    finally:
        raster_kernel._Raster, raster_kernel.raster_bwd = function, bwd
    p1 = params_of(state)
    grads = {k: np_of((p0[k] - p1[k]) / LR) for k in p0}
    return {k: float(v) for k, v in sc.items()}, grads, tuple(counts)


@pytest.mark.parametrize("stage,variant,launches", [
    (2, dict(use_gan=False), (4, 0, 3)),
    (2, dict(use_texture=False), (4, 0, 4)),
    (1, dict(use_gan=False), (2, 1, 1)),
    (1, dict(use_texture=False), (2, 0, 2))], ids=lambda v: str(v))
def test_variant_kernel_route_matches_plain(stage, variant, launches):
    """The card's route on the CPU (impl="kernel": the kernels' Function
    through their plain versions) against the plain route: the same
    scalars and gradients, the launches the card makes (forward, of
    them with p2f, backward), and only float32 into the renders."""
    kw = dict(S2_KW, **variant) if stage == 2 else dict(S1_KW, **variant)
    if stage == 1 and kw.get("use_texture", True):
        kw["face_chunk"] = 1      # the plain route's p2f at the kernel's rule
    cfg = Config(**kw)
    db = prepare_batch(synthetic_batch(np.random.RandomState(3), B, IMG),
                       cfg.use_scops, cfg.use_texture)
    g = torch.Generator().manual_seed(2)
    draws = {"eps": torch.randn(B, WIDTHS["z_dim"], generator=g),
             "angles": torch.randint(0, 180, (B,), generator=g)}
    if stage == 2:
        draws["sample_inds"] = torch.randint(0, 2, (B, 1), generator=g)
    snapshot = []
    sc_a, g_a, n_a = _route_run(stage, cfg, "auto", snapshot, db, draws)
    sc_k, g_k, n_k = _route_run(stage, cfg, "kernel", snapshot, db, draws)
    assert n_a == (0, 0, 0) and n_k == launches, (n_a, n_k)
    assert sorted(sc_k) == sorted(sc_a)
    for k, v in sc_a.items():
        np.testing.assert_allclose(sc_k[k], v, rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    assert cosine(g_k, g_a) >= 0.9999


def test_avg_uv_refuses_an_untextured_model(tmp_path):
    """avg_uv transfers the part maps through the UV flow: the JAX
    package's fails on a model without texture, and the port's refuses
    it."""
    from umr_tpu_torch.experiments import avg_uv

    cfg = Config(use_texture=False, model_path=str(tmp_path / "absent"))
    with pytest.raises(ValueError, match="use_texture"):
        avg_uv.load_s1_model(cfg, build_template(1, 1, 2), "cpu")


def test_cli_flags_reach_the_steps():
    """--bf16, --nouse_gan, --nouse_texture and --az_ele_quat parse into
    the Config the entry points hand to the steps, which build the
    variant's model and LPIPS."""
    from umr_tpu_torch.cli import parse_config

    cfg = parse_config(["--bf16", "--nouse_gan", "--nouse_texture",
                        "--az_ele_quat", "--image_size", "32",
                        "--num_hypo_cams", "2", "--nz_feat", "16",
                        "--z_dim", "8", "--subdivide", "1", "--tex_size",
                        "2"])
    assert cfg.bf16 and cfg.az_ele_quat
    assert not (cfg.use_gan or cfg.use_texture)
    template = build_template(1, 1, 2)
    seg, pvi = part_semantic(build_template(2, 1, 2))
    pvi = [i[i < template.num_verts] for i in pvi]
    pl = PartMatchingLoss.build(seg, template.uv_sampler,
                                template.num_sym_faces,
                                SoftRenderer(image_size=32), tex_size=2)
    model, _, lpips, _, _ = tsteps.build_s2_step(cfg, template, pl, pvi,
                                                 "cpu")
    assert not hasattr(model, "texture_predictor")
    quat = model.cam_predictor.camera_predictor[0].quat_predictor
    assert type(quat).__name__ == "QuatHeadAzEle"
    assert {m.compute_dtype for m in list(model.modules())
            + list(lpips.modules()) if hasattr(m, "compute_dtype")} == {
                torch.bfloat16}


def test_untextured_visuals_skip_the_texture():
    """A model without texture dumps the mask panels, not the textured
    render, the UV images or the mesh (as the JAX package's visuals
    skip them), with one render call fewer."""
    from umr_tpu_torch.training import visuals
    from umr_tpu_torch.training.steps import TrainState

    template = build_template(1, 1, 2)
    cfg = Config(image_size=IMG, img_size=IMG, subdivide=1, tex_size=2,
                 use_texture=False, **WIDTHS)
    model = init_weights(MeshNetS1(template, input_size=IMG, **WIDTHS,
                                   use_texture=False),
                         torch.Generator().manual_seed(0))
    state = TrainState(step=0, updates=0, model=model, disc=None, lpips=None,
                       optimizer=None, generator=torch.Generator())
    db = prepare_batch(synthetic_batch(np.random.RandomState(5), 2, IMG),
                       False, False)
    calls = []

    class Counting(SoftRenderer):
        def render(self, *a, **k):
            calls.append(1)
            return super().render(*a, **k)

    vis = visuals.make_visuals_fn(cfg, template, Counting(
        image_size=IMG, anti_aliasing=False, render_type="hard"))(state, db)
    assert {"mask_pred", "mask_gt", "image_gt"} <= set(vis)
    assert not {"image_pred", "uv_images", "mesh_0"} & set(vis)
    assert len(calls) == visuals.render_calls(use_texture=False) == 1


def test_variant_runs_save_and_resume(tmp_path):
    """train_s1.run under --bf16 --nouse_texture writes its .pth and resume
    state, a second run resumes from them at its step, and the .pth loads
    into the variant's model (and not into the textured one)."""
    from umr_tpu_torch.experiments import train_s1

    argv = ["--image_size", "32", "--batch_size", "2",
            "--anti_aliasing=false", "--subdivide", "1", "--tex_size", "2",
            "--nz_feat", "16", "--z_dim", "8", "--noprint_scalars",
            "--nodisplay_visuals", "--bf16", "--nouse_texture",
            "--checkpoint_dir", str(tmp_path), "--name", "v"]
    loader = [synthetic_batch(np.random.RandomState(i), 2, IMG)
              for i in range(2)]
    first = train_s1.run(train_s1.config(argv + ["--num_iter", "1"]), loader,
                         device="cpu")
    assert first.state.step == 1
    again = train_s1.run(train_s1.config(argv + ["--num_iter", "2"]), loader,
                         device="cpu")
    assert again.state.step == 2 and len(again.history) == 1
    template = build_template(1, 1, 2)
    pth = str(tmp_path / "v" / "pred_net_latest.pth")
    model = MeshNetS1(template, input_size=IMG, nz_feat=16, z_dim=8,
                      use_texture=False)
    load_checkpoint(model, pth)
    np.testing.assert_array_equal(
        np_of(model.mean_v), np_of(again.state.model.mean_v))
    with pytest.raises(KeyError):
        load_checkpoint(MeshNetS1(template, input_size=IMG, nz_feat=16,
                                  z_dim=8), pth)
