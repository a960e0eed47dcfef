"""Port parity of the training steps' flag variants: each variant
branch (stage 2 without texture, without the GAN, with az_ele_quat;
stage 1 without texture, without the GAN) against the JAX package's on the
CPU, as tests/test_torch_train.py and tests/test_torch_train_s1.py hold
the default steps (tests/torch_parity.py::step_parity: the same weights,
batch and random draws; gradients before the optimizer, through one SGD
step at a large learning rate), at their config (image 32, K=2,
subdivide 2, tex_size 2, no anti-aliasing, batch 4, narrow heads).

Tolerances, from the readings of this file's inputs (each case alone):
  * scalars of the model alone rtol 1e-4, those through renders or the
    texture flow rtol 2e-3 (as the default steps; readings 8.9e-6 and
    1.03e-3, part_loss, in stage 2; 1.1e-3, tex_cycle_loss, stage 1).
  * gradients: the default steps' bounds (stage 2 cosine >= 0.998, per
    tensor 0.3 of its norm; stage 1 >= 0.99, 0.5). Readings (cosine,
    worst per-tensor ratio net of the absolute term): s2 without
    texture 0.9999926, 0.13; without the GAN 0.99928, 0.19; az_ele_quat
    without texture or GAN 0.99959, 0.23; s1 without texture 0.99995,
    without the GAN 0.99579.
  * az_ele_quat is held without texture: with the texture flow its step
    reads cosine 0.9863 and per tensor 2.03 (shape_predictor). Its
    hypotheses' quaternions are tanh of train-mode BatchNorm features
    with no normalisation, and through the texture terms the step's
    gradient is chaotic there: a 1e-4 perturbation of the input images
    moves the port's own gradient to cosine 0.945 (0.990 with the
    default heads), while the scalars agree as the default step's.
    Its heads are held with texture in tests/test_torch_variants.py.
"""

import numpy as np
import pytest

from torch_parity import grads_close, step_parity
from umr_tpu_torch.cli import S1_DEFAULTS

IMG = 32
LR = 1e3
S2_KW = dict(image_size=IMG, img_size=IMG, batch_size=4, num_hypo_cams=2,
             anti_aliasing=False, subdivide=2, tex_size=2, use_sgd=True,
             learning_rate=LR, nz_feat=32, z_dim=24)
S1_KW = dict(image_size=IMG, img_size=IMG, batch_size=4,
             anti_aliasing=False, subdivide=2, tex_size=2, use_sgd=True,
             learning_rate=LR, face_chunk=320, nz_feat=32, z_dim=24,
             **S1_DEFAULTS)
MODEL_SCALARS = ("cam_div_loss", "corr_loss", "deform_loss", "flatten_loss",
                 "tri_loss", "uv_flow_area", "acc_gan", "ori_loss")


@pytest.mark.parametrize("stage,variant", [
    (2, dict(use_texture=False)), (2, dict(use_gan=False)),
    (2, dict(az_ele_quat=True, use_texture=False, use_gan=False)),
    (1, dict(use_texture=False, use_gan=False))], ids=lambda v: str(v))
def test_variant_step_matches_jax(stage, variant):
    """Each variant branch of the steps: the same scalars as the JAX
    package's step (none of the texture terms without texture, no GAN
    terms without the GAN), and its gradients before the optimizer, at
    the default steps' bounds. Each case compiles a JAX step (20-30 s):
    stage 2 without texture (the mask-only fold, the T2=1 GAN view, the
    part groups apart), without the GAN (the hard pass, the part groups
    apart on its bins), without either with az_ele_quat (the az heads),
    stage 1 without either (the mask-only seen render, no pass 3)."""
    if stage == 2:
        r = step_parity(2, dict(S2_KW, **variant),
                        dict(face_chunk=320, pixel_rows_per_block=IMG), LR)
    else:
        r = step_parity(1, dict(S1_KW, **variant),
                        dict(pixel_rows_per_block=IMG), LR)
    sc, jsc = r["port_sc"], r["jax_sc"]
    assert sorted(sc) == sorted(jsc)
    if not variant.get("use_texture", True):
        assert "tex_loss" not in sc and "uv_flow_area" not in sc
    if not variant.get("use_gan", True):
        assert "gan_loss" not in sc
    for k, v in jsc.items():
        rtol = 1e-4 if k in MODEL_SCALARS else 2e-3
        np.testing.assert_allclose(sc[k], v, rtol=rtol, atol=1e-7,
                                   err_msg=k)
    rel, cos = (0.3, 0.998) if stage == 2 else (0.5, 0.99)
    grads_close(r["port_grads"], r["jax_grads"], rel, cos)
    if variant.get("az_ele_quat"):
        # the unused linear layer: no gradient, so SGD leaves it as it is
        for k, g in r["port_grads"].items():
            if ".camera_predictor." in k and ".quat_predictor." in k:
                assert not g.any(), k
                assert not r["jax_grads"][k].any(), k
