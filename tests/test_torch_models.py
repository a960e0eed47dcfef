"""Port parity: MeshNet-s2 eval forward with weights carried from flax,
the key map, the ResNet-18 trunk from the committed npz files.

Tolerance: atol 1e-4 on the forward's outputs (convolutions and matmuls
reduce in another order in XLA:CPU and torch)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (SMALL, flax_flat, injected_draws, jax_meshnet,
                          np_of, t_of)
from umr_tpu.mesh import build_template
from umr_tpu.models import reference_io as jio
from umr_tpu_torch.models import MeshNet
from umr_tpu_torch.models import reference_io as tio
from umr_tpu_torch.models.weights import (load_checkpoint, load_into,
                                          load_resnet18_npz,
                                          state_dict_from_flax)

ATOL = 1e-4
KEYS = ("mean", "logvar", "feat", "cam_hypotheses", "cam_probs", "cam",
        "delta_v", "tex_flow", "uvimage_pred")
WEIGHTS = os.path.join(os.path.dirname(__file__), os.pardir, "weights")


@pytest.mark.parametrize("stage,num_cams,n_upconv,variant", [
    pytest.param(2, 8, 5, {}, id="2-8-5"),
    pytest.param(2, 2, 4, {}, id="2-2-4"),
    pytest.param(1, 8, 5, {}, id="1-8-5"),
    pytest.param(2, 8, 5, dict(use_texture=False), id="2-8-5-untextured"),
    pytest.param(1, 8, 5, dict(use_texture=False), id="1-8-5-untextured")])
def test_key_map_matches_jax(stage, num_cams, n_upconv, variant):
    """The port's key map is the JAX package's; an untextured model's is
    JAX's without the texture predictor's rows.
    az_ele_quat keeps every row; stage 2's single camera has no rows in
    JAX's map (tests/test_torch_variants.py round-trips it through a
    JAX-saved .pth)."""
    want = jio.build_key_map(stage, num_cams, n_upconv)
    if variant:
        want = tuple([row for row in rows
                      if not row[1].startswith("texture_predictor.")]
                     for rows in want)
    assert tio.build_key_map(stage, num_cams, n_upconv, **variant) == want


def _port_model(template, variables, image_size, nz_feat, z_dim,
                num_hypo_cams):
    model = MeshNet(template, input_size=image_size, nz_feat=nz_feat,
                    z_dim=z_dim, num_hypo_cams=num_hypo_cams)
    n_up = min(5, int(np.log2(template.uv_image_size()[0])))
    sd = state_dict_from_flax(flax_flat(variables), num_hypo_cams, n_up)
    load_into(model, sd, allow_missing=("cam_biases",))
    return model.eval()


@pytest.mark.parametrize("image_size", [64, 32])
def test_meshnet_eval_matches_jax(image_size):
    """image 64: the 4x4/s2 enc_conv1; image 32: its 1x1 branch."""
    cfg = dict(SMALL, image_size=image_size)
    template = build_template(cfg["subdivide"], 1, cfg["tex_size"])
    kw = {k: cfg[k] for k in ("image_size", "nz_feat", "z_dim",
                              "num_hypo_cams")}
    jmodel, variables = jax_meshnet(template, **kw)
    img = np.random.RandomState(1).standard_normal(
        (3, image_size, image_size, 3)).astype(np.float32)
    jout = jax.jit(lambda v, x: jmodel.apply(
        v, x, train=False, rngs={"sample": jax.random.key(7)}))(
            variables, jnp.asarray(img))
    eps, inds = injected_draws(jout)

    model = _port_model(template, variables, **kw)
    with torch.no_grad():
        out = model(t_of(img), eps=eps, sample_inds=inds)
    for k in KEYS:
        assert out[k].shape == tuple(jout[k].shape), k
        np.testing.assert_allclose(np_of(out[k]), np_of(jout[k]), atol=ATOL,
                                   err_msg=k)
    np.testing.assert_array_equal(np_of(out["cam_sample_inds"]),
                                  np_of(jout["cam_sample_inds"]))


def test_generator_draws_are_seeded():
    template = build_template(2, 1, 2)
    model = MeshNet(template, input_size=32, nz_feat=16, z_dim=8,
                    num_hypo_cams=3).eval()
    img = torch.randn(2, 32, 32, 3)
    with torch.no_grad():
        a = model(img, generator=torch.Generator().manual_seed(3))
        b = model(img, generator=torch.Generator().manual_seed(3))
    for k in ("noise", "cam_sample_inds", "cam"):
        np.testing.assert_array_equal(np_of(a[k]), np_of(b[k]))


def test_resnet18_npz_trunk_matches_jax():
    """The committed trunk weights through the key map give JAX's trunk."""
    from umr_tpu.models.resnet import ResNet18Conv
    from umr_tpu.models.weight_io import load_resnet18_pretrained

    params_path = os.path.join(WEIGHTS, "resnet18_params.npz")
    stats_path = os.path.join(WEIGHTS, "resnet18_stats.npz")
    params, stats = load_resnet18_pretrained(params_path)
    img = np.random.RandomState(2).standard_normal((2, 64, 64, 3)).astype(
        np.float32)
    ref = ResNet18Conv(n_blocks=4).apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(img),
        train=False)

    model = MeshNet(build_template(2, 1, 2), input_size=64, nz_feat=16,
                    z_dim=8, num_hypo_cams=2)
    sd = load_resnet18_npz(params_path, stats_path)
    model.load_state_dict(sd, strict=False)
    trunk = model.encoder.resnet_conv.eval()
    with torch.no_grad():
        out = trunk(t_of(img).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(np_of(out), np_of(ref), atol=ATOL,
                               rtol=1e-4)


def test_checkpoint_roundtrip_torch_keys(tmp_path):
    """The port's own state_dict, and a reference-style one with its
    batch-shaped buffers, load through load_checkpoint."""
    template = build_template(2, 1, 2)
    a = MeshNet(template, input_size=32, nz_feat=16, z_dim=8,
                num_hypo_cams=2)
    sd = dict(a.state_dict())
    sd["texture_predictor.uv_sampler"] = torch.zeros(4, 5)
    sd["noise"] = torch.zeros(3)
    path = tmp_path / "pred_net_latest.pth"
    torch.save(sd, path)
    b = MeshNet(template, input_size=32, nz_feat=16, z_dim=8,
                num_hypo_cams=2)
    load_checkpoint(b, str(path))
    for k, v in a.state_dict().items():
        np.testing.assert_array_equal(np_of(b.state_dict()[k]), np_of(v))
