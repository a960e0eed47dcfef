"""Port parity of --bf16 mixed precision: the convs of the encoder's
trunk, its enc_conv1, the texture decoder and LPIPS compute in bfloat16
with float32 parameters, as the JAX package's flax `dtype=` does; every
BatchNorm computes in float32, the linear layers, the heads, the losses
and the rasterizer stay float32.

  * the model (MeshNet-s2) against the JAX package's bf16 model in eval
    mode (running statistics) at image 64, batch 4, on the same weights
    (the port's seeded init with the committed ResNet-18 trunk): its
    outputs, and the parameter gradients of a smooth function of them;
  * LPIPS against the JAX package's bf16 LPIPS: distances and the
    gradient to the input images;
  * single ResNet-18 blocks against the JAX package's bf16 blocks, at a
    bound that the float32 block fails: the model-level bounds above
    cannot tell bf16 from float32, since the two packages round their
    bf16 convs at other points and over the trunk that moves the output
    as far as float32 does (relative 4.0e-3 against 4.4e-3);
  * the dtype contract on the kernels' route (impl="kernel"), both
    stages: where each cast sits (the residual adds, the decoder's last
    conv), and nothing bf16 into a render.
The steps' bf16 scalars are not held against the JAX package's here:
through the texture flow at batch 4 they move as far from float32 as
the two packages move from each other (below); both stages' bf16 steps
run in the dtype contract, and on the card in chip_smoke phase 16.

Tolerances, from the readings of this file's inputs (XLA:CPU and oneDNN
both accumulate bf16 convs in float32 but round their outputs at other
points):
  * model outputs within 1e-2 of the output's largest value (readings:
    mean 5.0e-3, logvar 4.9e-3, feat 4.4e-3), the texture flow and the
    UV image within 5e-2 (readings 1.5e-2, 2.1e-2); the same bounds hold
    each package's bf16 model to its own float32 model (port readings
    8.5e-3, 1.75e-2). Gradient cosine >= 0.98 (reading 0.99797).
  * LPIPS: distances rtol 5e-3 against JAX's bf16 LPIPS and the port's
    float32 one (readings 6.1e-4 and 1.5e-3), input-gradient cosine
    >= 0.98 (reading 0.99885).
  * ResNet blocks (eval mode, the committed trunk weights): relative
    norm of the difference <= 5e-4 of JAX's bf16 block (readings
    layer1.1 and layer2.0, the downsampling one: 5.2e-5 at layer2.0),
    and > 1e-3 from the port's float32 block (reading 2.9e-3).
  * the s2 step (image 32, batch 4; not a test): the geometry's scalars
    read 4.2e-3 (corr_loss) to 1.2e-2 (gan_loss) from JAX's bf16 step,
    those through the texture flow up to 0.19 (tex_loss). That flow
    passes through train-mode BatchNorms over 1x1 maps at batch 4,
    which turn bf16's rounding (~4e-3) into 10-40% differences of the
    features: the JAX package's own bf16 step moves tex_loss by 20%
    from its float32 step (1.9405 -> 2.3314 on these inputs), and the
    port's bf16 gradient moves to cosine 0.54 under a 1e-5
    perturbation of the input images (float32: 0.9997).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from torch_parity import (cosine, flat_tree, flax_variables, injected_draws,
                          np_of, part_semantic, t_of)
from umr_tpu.mesh import build_template as jax_template
from umr_tpu.models import MeshNet as JaxMeshNet
from umr_tpu_torch.cli import S1_DEFAULTS
from umr_tpu_torch.config import Config
from umr_tpu_torch.data import synthetic_batch
from umr_tpu_torch.losses.composite import PartMatchingLoss
from umr_tpu_torch.mesh import build_template
from umr_tpu_torch.models import LPIPSAlex, MeshNet, init_weights
from umr_tpu_torch.models.heads import TexturePredictorUV
from umr_tpu_torch.models.net_blocks import Conv2d
from umr_tpu_torch.models.resnet import BasicBlock
from umr_tpu_torch.models.weights import (WEIGHTS_DIR, load_lpips_npz,
                                          load_resnet18_npz)
from umr_tpu_torch.ops import raster_kernel
from umr_tpu_torch.renderer import SoftRenderer
from umr_tpu_torch.training import steps as tsteps
from umr_tpu_torch.training.trainer import prepare_batch

IMG = 32
S2_KW = dict(image_size=IMG, img_size=IMG, batch_size=4, num_hypo_cams=2,
             anti_aliasing=False, subdivide=2, tex_size=2, nz_feat=32,
             z_dim=24)
S1_KW = dict(image_size=IMG, img_size=IMG, batch_size=4,
             anti_aliasing=False, subdivide=2, tex_size=2, face_chunk=320,
             nz_feat=32, z_dim=24, **S1_DEFAULTS)
OUTPUTS = ("mean", "logvar", "feat", "cam_hypotheses", "cam_probs", "delta_v",
           "tex_flow", "uvimage_pred")
SMOOTH = ("delta_v", "cam_hypotheses", "tex_flow", "mean", "logvar")


def _out_tol(k):
    return 5e-2 if k in ("tex_flow", "uvimage_pred") else 1e-2


def _close(got, want, what):
    for k in OUTPUTS:
        w = np_of(want[k])
        np.testing.assert_allclose(np_of(got[k]), w,
                                   atol=_out_tol(k) * np.abs(w).max(),
                                   err_msg=f"{what}: {k}")


def test_bf16_model_matches_jax():
    """Eval mode, image 64 (the 4x4/s2 enc_conv1), batch 4: every output
    float32, within the bounds of JAX's bf16 model and of the port's own
    float32 model; the parameter gradients of sum(sin(outputs)) against
    JAX's."""
    template = build_template(2, 1, 2)
    kw = dict(input_size=64, nz_feat=32, z_dim=24, num_hypo_cams=2)
    trunk = load_resnet18_npz(os.path.join(WEIGHTS_DIR, "resnet18_params.npz"),
                              os.path.join(WEIGHTS_DIR, "resnet18_stats.npz"))
    models = {}
    for name, cdt in (("f32", None), ("bf16", torch.bfloat16)):
        m = init_weights(MeshNet(template, compute_dtype=cdt, **kw),
                         torch.Generator().manual_seed(0))
        m.load_state_dict(trunk, strict=False)
        models[name] = m.eval()
    variables = flax_variables(models["f32"], template, 2)
    img = np.random.RandomState(1).standard_normal(
        (4, 64, 64, 3)).astype(np.float32)
    jmodel = JaxMeshNet(template=jax_template(2, 1, 2), nz_feat=32, z_dim=24,
                        num_hypo_cams=2, compute_dtype=jnp.bfloat16)

    def jloss(params, x):
        out = jmodel.apply({**variables, "params": params}, x, train=False,
                           rngs={"sample": jax.random.key(7)})
        return sum(jnp.sum(jnp.sin(out[k])) for k in SMOOTH), out

    (_, jout), jgrad = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        variables["params"], jnp.asarray(img))
    eps, inds = injected_draws(jout)
    outs, grads = {}, {}
    for name, m in models.items():
        m.zero_grad()
        out = m(t_of(img), eps=eps, sample_inds=inds)
        sum(torch.sin(out[k]).sum() for k in SMOOTH).backward()
        outs[name] = out
        grads[name] = {n: np_of(p.grad) for n, p in m.named_parameters()
                       if p.grad is not None}
    for k in OUTPUTS:
        assert outs["bf16"][k].dtype == torch.float32, k
    _close(outs["bf16"], jout, "port bf16 vs JAX bf16")
    _close(outs["bf16"], outs["f32"], "port bf16 vs port f32")

    from umr_tpu.models.reference_io import _apply_transform, build_key_map

    pm = build_key_map(2, 2, min(5, int(np.log2(
        template.uv_image_size()[0]))))[0]
    flat = flat_tree(jgrad)
    jg = {tkey: _apply_transform(np.asarray(flat["/".join(path)]), tf,
                                 to_flax=False)
          for path, tkey, tf in pm if tkey in grads["bf16"]}
    assert len(jg) == len(grads["bf16"])
    c = cosine(grads["bf16"], jg)
    assert c >= 0.98, c
    for n, p in models["bf16"].named_parameters():
        assert p.dtype == torch.float32, n
        assert p.grad is None or p.grad.dtype == torch.float32, n


def test_bf16_lpips_matches_jax():
    """LPIPS(bf16) on the committed AlexNet weights: float32 distances
    within rtol 5e-3 of JAX's bf16 LPIPS and of its own float32 run; the
    gradient to the first image against JAX's."""
    from umr_tpu.models.lpips import LPIPSAlex as JaxLPIPS
    from umr_tpu.models.weight_io import load_lpips_params

    rng = np.random.RandomState(3)
    a = rng.uniform(-1, 1, (3, 64, 64, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.3, a.shape), -1, 1).astype(np.float32)
    jparams = load_lpips_params(os.path.join(WEIGHTS_DIR, "lpips_alex.npz"))
    jl = JaxLPIPS(dtype=jnp.bfloat16)
    (_, jdist), jgrad = jax.jit(jax.value_and_grad(
        lambda x: (lambda d: (d.sum(), d))(jl.apply(
            {"params": jparams}, x, jnp.asarray(b))), has_aux=True))(
                jnp.asarray(a))
    jdist, jgrad = np.asarray(jdist), np.asarray(jgrad)
    runs = {}
    for name, cdt in (("f32", None), ("bf16", torch.bfloat16)):
        lp = load_lpips_npz(LPIPSAlex(compute_dtype=cdt),
                            os.path.join(WEIGHTS_DIR, "lpips_alex.npz"))
        x = t_of(a).requires_grad_()
        d = lp(x, t_of(b))
        d.sum().backward()
        runs[name] = (d, np_of(x.grad))
    d16, g16 = runs["bf16"]
    assert d16.dtype == torch.float32
    msg = (f"distances port {np_of(d16)}, JAX {jdist}, port f32 "
           f"{np_of(runs['f32'][0])}; gradient cosine "
           f"{cosine({'g': g16}, {'g': jgrad}):.5f}")
    np.testing.assert_allclose(np_of(d16), jdist, rtol=5e-3, err_msg=msg)
    np.testing.assert_allclose(np_of(d16), np_of(runs["f32"][0]), rtol=5e-3,
                               err_msg=msg)
    assert cosine({"g": g16}, {"g": jgrad}) >= 0.98, msg
    assert (jdist > 0).all()


@pytest.mark.parametrize("name,stride,planes", [("layer1_1", 1, 64),
                                               ("layer2_0", 2, 128)])
def test_bf16_resnet_block_matches_jax(name, stride, planes):
    """One block of the trunk on its committed weights, eval mode: the
    port's bf16 block within 5e-4 (relative norm) of JAX's bf16 block,
    which the port's float32 block misses by more than 1e-3."""
    from umr_tpu.models.resnet import BasicBlock as JaxBlock
    from umr_tpu.models.weight_io import load_npz

    prefix = "encoder.resnet_conv.resnet." + name.replace("_", ".") + "."
    trunk = load_resnet18_npz(os.path.join(WEIGHTS_DIR, "resnet18_params.npz"),
                              os.path.join(WEIGHTS_DIR, "resnet18_stats.npz"))
    sd = {k[len(prefix):]: v for k, v in trunk.items()
          if k.startswith(prefix)}
    x = np.random.RandomState(2).standard_normal(
        (4, 16, 16, planes // stride)).astype(np.float32)
    jblock = JaxBlock(planes, stride, dtype=jnp.bfloat16)
    want = np.asarray(jblock.apply(
        {"params": load_npz(os.path.join(
            WEIGHTS_DIR, "resnet18_params.npz"))[name],
         "batch_stats": load_npz(os.path.join(
             WEIGHTS_DIR, "resnet18_stats.npz"))[name]},
        jnp.asarray(x), train=False))
    err = {}
    for label, cdt in (("f32", None), ("bf16", torch.bfloat16)):
        block = BasicBlock(planes // stride, planes, stride, cdt)
        block.load_state_dict(sd)
        with torch.no_grad():
            got = block.eval()(t_of(x).permute(0, 3, 1, 2))
        assert got.dtype == torch.float32
        got = np_of(got.permute(0, 2, 3, 1))
        err[label] = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert err["bf16"] <= 5e-4, err
    assert err["f32"] > 1e-3, err


@pytest.mark.parametrize("stage", [2, 1])
def test_bf16_dtype_contract(stage, monkeypatch):
    """On the kernels' route: the encoder's, the decoder's and LPIPS's
    convs return bf16, every BatchNorm normalises float32, the residual
    adds take and give float32, the decoder's bf16 output is cast back
    to float32 before the tanh, the linear
    layers and LPIPS's distance are float32, nothing bf16 reaches a
    render, the parameters and their gradients stay float32; the
    kernels' dtype check still refuses a bf16 tensor."""
    template = build_template(2, 1, 2)
    cfg = Config(**dict(S2_KW if stage == 2 else S1_KW, bf16=True))
    if stage == 2:
        seg, pvi = part_semantic(template)
        pl = PartMatchingLoss.build(
            seg, template.uv_sampler, template.num_sym_faces,
            SoftRenderer(image_size=IMG, anti_aliasing=False,
                         ambient_intensity=1.0, directional_intensity=0.0,
                         impl="kernel"), tex_size=2)
        model, disc, lpips, init_fn, step_fn = tsteps.build_s2_step(
            cfg, template, pl, pvi, "cpu", impl="kernel")
        args = ()
    else:
        model, disc, lpips, init_fn, step_fn, _, _ = tsteps.build_s1_step(
            cfg, template, "cpu", impl="kernel")
        args = (0.0,)
    state = init_fn(0)
    seen = {"conv": set(), "bn": set(), "linear": set(), "render": set(),
            "lpips": set(), "residual": set(), "decoder": set()}
    hooks = []
    for mod in list(model.modules()) + list(lpips.modules()):
        if isinstance(mod, BasicBlock):      # its output is the residual add's
            hooks.append(mod.register_forward_hook(
                lambda m, i, o: seen["residual"].add((i[0].dtype, o.dtype))))
        elif isinstance(mod, TexturePredictorUV):
            hooks.append(mod.decoder.register_forward_hook(
                lambda m, i, o: seen["decoder"].add(o.dtype)))
            hooks.append(mod.register_forward_hook(
                lambda m, i, o: seen["decoder"].add(tuple(
                    t.dtype for t in o))))
        elif isinstance(mod, Conv2d):
            hooks.append(mod.register_forward_hook(
                lambda m, i, o: seen["conv"].add(o.dtype)))
        elif isinstance(mod, torch.nn.Linear):
            hooks.append(mod.register_forward_hook(
                lambda m, i, o: seen["linear"].add((i[0].dtype, o.dtype))))
    hooks.append(lpips.register_forward_hook(
        lambda m, i, o: seen["lpips"].add(o.dtype)))
    batch_norm = F.batch_norm

    def recording_bn(x, *a, **k):
        seen["bn"].add(x.dtype)
        return batch_norm(x, *a, **k)

    monkeypatch.setattr(F, "batch_norm", recording_bn)
    function = raster_kernel._Raster

    class Recording:
        @staticmethod
        def apply(fv, tex, al_fids, astarts, kw):
            seen["render"].add((fv.dtype, tex.dtype))
            return function.apply(fv, tex, al_fids, astarts, kw)

    monkeypatch.setattr(raster_kernel, "_Raster", Recording)
    convs = sum(isinstance(m, Conv2d) for m in model.modules())
    assert convs and all(m.compute_dtype == torch.bfloat16
                         for m in model.modules() if isinstance(m, Conv2d))
    db = prepare_batch(synthetic_batch(np.random.RandomState(3), 4, IMG),
                       cfg.use_scops, cfg.use_texture)
    state, sc = step_fn(state, db, *args)
    for h in hooks:
        h.remove()
    assert seen["conv"] == {torch.bfloat16}
    assert seen["bn"] == {torch.float32}
    assert seen["residual"] == {(torch.float32, torch.float32)}
    # the decoder's last conv in bf16, its flow cast back to float32
    assert seen["decoder"] == {torch.bfloat16,
                               (torch.float32, torch.float32)}
    assert seen["linear"] == {(torch.float32, torch.float32)}
    assert seen["lpips"] == {torch.float32}
    assert seen["render"] == {(torch.float32, torch.float32)}
    assert all(np.isfinite(float(v)) for v in sc.values()), sc
    for mod in (model, disc):
        for n, p in mod.named_parameters():
            assert p.dtype == torch.float32, n
            assert p.grad is None or p.grad.dtype == torch.float32, n
    assert not any(isinstance(m, Conv2d) for m in disc.modules())
    fv = torch.zeros((1, 2, 3, 3), dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="bfloat16"):
        raster_kernel._check(fv, "face_vertices", (1, 2, 3, 3),
                             torch.float32, fv.device)
