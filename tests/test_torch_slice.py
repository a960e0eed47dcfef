"""Port parity of the inference slice: test_iou's predict_masks with the
same .pth (written by the JAX trainer's save_pth) and the JAX forward's
random draws injected; run() and the demo's panels on the CPU.

The JAX side runs op by op (not under jax.jit): at the renderer's sigma
(1e-5) XLA's fused rasterizer disagrees with its own op-by-op run on 108
of the 12,288 mask values by more than 1e-3, up to 0.18, while the port
and the op-by-op run agree on all but 10 of them, the largest by 0.014
(measured on this test's inputs; the cameras agree to 4e-9).

Tolerances: cameras atol 1e-4 (as the MeshNet test); masks atol 1e-3
on all but 0.2% of values, the rest within 0.02 (the reading above);
mean IoU within 1e-3."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (SMALL, assert_close_except_slivers,
                          injected_draws, jax_meshnet, np_of, t_of)
from umr_tpu.mesh import build_template as jax_template
from umr_tpu_torch.config import Config, resolve_device
from umr_tpu_torch.data import synthetic_batch
from umr_tpu_torch.experiments import demo
from umr_tpu_torch.experiments import test_iou as port_iou
from umr_tpu_torch.mesh import build_template
from umr_tpu_torch.ops import raster_kernel


def _iou(mask_gt, mask_pred):
    g = mask_gt.reshape(mask_gt.shape[0], -1)
    p = mask_pred.reshape(mask_pred.shape[0], -1)
    return ((g * p).sum(1) / (g + p - g * p).sum(1)).mean()


def _setup(tmp_path):
    from umr_tpu.training.checkpoints import save_pth

    jtemplate = jax_template(SMALL["subdivide"], 1, SMALL["tex_size"])
    jmodel, variables = jax_meshnet(
        jtemplate, SMALL["image_size"], SMALL["nz_feat"], SMALL["z_dim"],
        SMALL["num_hypo_cams"])
    path = str(tmp_path / "pred_net_latest.pth")
    save_pth(path, variables["params"], template=variables["template"],
             batch_stats=variables["batch_stats"])
    cfg = Config(model_path=path, **SMALL).sync_image_size()
    template = build_template(SMALL["subdivide"], 1, SMALL["tex_size"])
    return cfg, template, jtemplate, jmodel, variables


def test_predict_masks_matches_jax(tmp_path):
    from umr_tpu.experiments import test_iou as jax_iou
    from umr_tpu.renderer import SoftRenderer as JaxRenderer

    from umr_tpu.training.checkpoints import load_pth

    cfg, template, jtemplate, jmodel, variables = _setup(tmp_path)
    # what jax_iou.build_eval_model does after its (slow, eager) init
    params, tmpl, stats = load_pth(cfg.model_path, variables["params"],
                                   variables["template"],
                                   variables["batch_stats"])
    jvars = dict(variables, params=params, template=tmpl, batch_stats=stats)
    batch = synthetic_batch(np.random.RandomState(0), 3, cfg.image_size)
    img = batch["input_img"]
    jrend = JaxRenderer(image_size=cfg.image_size, render_type="softmax")
    jmask, jout = jax_iou.predict_masks(
        jmodel, jvars, jrend, jnp.asarray(jtemplate.faces), jtemplate,
        jnp.asarray(img), jax.random.key(cfg.seed))
    eps, inds = injected_draws(jout)

    model = port_iou.build_eval_model(cfg, template, "cpu")
    renderer = port_iou.SoftRenderer(image_size=cfg.image_size)
    mask, out = port_iou.predict_masks(
        model, renderer, t_of(template.faces), t_of(img), eps=eps,
        sample_inds=inds)
    np.testing.assert_allclose(np_of(out["cam"]), np_of(jout["cam"]),
                               atol=1e-4)
    assert_close_except_slivers(np_of(mask), np_of(jmask), atol=1e-3,
                                frac=2e-3, cap=0.02)
    assert abs(_iou(batch["mask"], np_of(mask))
               - _iou(batch["mask"], np_of(jmask))) <= 1e-3


def test_run_and_panels_on_cpu(tmp_path):
    cfg, template, _, _, _ = _setup(tmp_path)
    rng = np.random.RandomState(1)
    loader = [synthetic_batch(rng, 2, cfg.image_size) for _ in range(2)]
    before = raster_kernel.LAUNCHES
    iou = port_iou.run(cfg, dataloader=loader, device="cpu")
    assert 0.0 <= iou <= 1.0
    assert raster_kernel.LAUNCHES == before     # CPU: the plain version

    model = port_iou.build_eval_model(cfg, template, "cpu")
    panel = demo.render_panels(model, loader[0]["img"][0],
                               generator=torch.Generator().manual_seed(0))
    S = cfg.image_size
    assert panel.shape == (2 * S, 3 * S, 3)
    assert np.isfinite(panel).all()
    np.testing.assert_array_equal(panel[:S, :S], loader[0]["img"][0])


def test_entry_points_default_to_the_card():
    """No quiet fallback to the CPU: without a device the entry points ask
    for the card and raise where none is visible (a CPU-only host)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default is valid here")
    cfg = Config(model_path="absent.pth", **SMALL).sync_image_size()
    batch = synthetic_batch(np.random.RandomState(0), 2, cfg.image_size)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_iou.run(cfg, dataloader=[batch])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_iou.build_eval_model(cfg, build_template(2, 1, 2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        demo.run(cfg)
    assert resolve_device("cpu") == torch.device("cpu")
