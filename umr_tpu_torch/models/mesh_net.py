"""MeshNet, the single-view reconstruction predictor: stage 2
(port of umr_tpu/models/mesh_net.py::MeshNet; reference
nnutils/cub_mesh.py:366-507) and stage 1 (MeshNetS1; reference
nnutils/cub_mesh_s1.py:225-355).

Module names follow the reference's state_dict (`encoder.resnet_conv...`,
`cam_predictor.camera_predictor.3...`, `texture_predictor.decoder...`,
`mean_v`). Images enter NHWC, as in the JAX package.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn

from .heads import (Camera, Encoder, MultiCamPredictor, QuatHead, ScaleHead,
                    ShapePredictor, ShapePredictorMLP, TexturePredictorUV,
                    TransHead)


class _MeshNetBase(nn.Module):
    """The encoder, the texture flow and the template both stages share
    (registered around the stage's own heads, in the reference's order).
    A model without texture (use_texture=False) has no texture_predictor
    and gives no tex_flow / uvimage_pred; compute_dtype (bf16 mixed
    precision) reaches the convs of the encoder and the texture decoder."""

    def __init__(self, template, input_size, nz_feat, z_dim, use_texture,
                 compute_dtype):
        super().__init__()
        self.template = template
        self.use_texture = use_texture
        self.encoder = Encoder(input_size, nz_feat, z_dim, compute_dtype)

    def _add_texture_and_template(self, nz_feat, compute_dtype):
        template = self.template
        if self.use_texture:
            H, W = template.uv_image_size()
            self.texture_predictor = TexturePredictorUV(
                nz_feat, template.uv_sampler, img_H=H, img_W=W,
                n_upconv=min(5, int(np.log2(H))),
                num_sym_faces=template.num_sym_faces,
                compute_dtype=compute_dtype)
        # a copy: the stage-1 template update moves mean_v in place
        self.register_buffer("mean_v",
                             torch.tensor(np.asarray(template.mean_v_init)))

    def encode(self, img, eps=None, generator=None):
        """img [B,H,W,3] -> (feat, noise, mean, logvar)."""
        return self.encoder(img.permute(0, 3, 1, 2), eps=eps,
                            generator=generator)

    def _texture(self, feat, outputs):
        """outputs['tex_flow'], ['uvimage_pred'] from the features, where
        the model has texture."""
        if self.use_texture:
            outputs["tex_flow"], outputs["uvimage_pred"] = (
                self.texture_predictor(feat))

    def get_mean_shape(self):
        return symmetrize(self.mean_v, self.template)


class MeshNet(_MeshNetBase):
    """Stage 2. multiple_cam_hypo=False predicts one camera (the JAX package's single
    `Camera`, which ignores az_ele_quat) with cam_probs ones and
    sample_inds zeros; az_ele_quat gives the hypotheses QuatHeadAzEle."""

    def __init__(self, template, input_size=256, nz_feat=200, z_dim=350,
                 num_hypo_cams=8, use_texture=True, multiple_cam_hypo=True,
                 az_ele_quat=False, compute_dtype=None):
        super().__init__(template, input_size, nz_feat, z_dim, use_texture,
                         compute_dtype)
        self.multiple_cam_hypo = multiple_cam_hypo
        self.shape_predictor = ShapePredictor(z_dim, template.num_output)
        self.cam_predictor = (
            MultiCamPredictor(nz_feat, num_hypo_cams, az_ele_quat)
            if multiple_cam_hypo else Camera(nz_feat))
        self._add_texture_and_template(nz_feat, compute_dtype)

    def forward(self, img, eps=None, sample_inds=None, generator=None):
        """img [B,H,W,3] -> dict of predictions. eps (VAE noise) and
        sample_inds (camera hypothesis) are drawn from `generator` unless
        given."""
        feat, noise, mean, logvar = self.encode(img, eps, generator)
        outputs = dict(mean=mean, logvar=logvar, noise=noise, feat=feat)
        if self.multiple_cam_hypo:
            cam, inds, cam_probs, all_cams, quats = self.cam_predictor(
                feat, sample_inds=sample_inds, generator=generator)
            outputs.update(cam=cam, cam_sample_inds=inds,
                           cam_probs=cam_probs, cam_hypotheses=all_cams,
                           base_quats=quats[:, 0])
        else:
            raw = self.cam_predictor(feat)        # [q4, prob, s, t2]
            B = raw.shape[0]
            outputs.update(
                cam=torch.cat([raw[:, 5:6], raw[:, 6:8], raw[:, 0:4]], 1),
                cam_sample_inds=torch.zeros((B, 1), dtype=torch.long,
                                            device=raw.device),
                cam_probs=raw.new_ones((B, 1)))
        self._texture(feat, outputs)
        outputs["delta_v"] = self.shape_predictor(noise)
        return outputs


class MeshNetS1(_MeshNetBase):
    """Stage 1: the MLP shape head on the VAE sample, one camera
    [scale, tx, ty, quat] from the features.
    outputs['feat'] is the VAE sample, which the online template update
    averages."""

    def __init__(self, template, input_size=256, nz_feat=200, z_dim=350,
                 use_texture=True, compute_dtype=None):
        super().__init__(template, input_size, nz_feat, z_dim, use_texture,
                         compute_dtype)
        self.shape_predictor = ShapePredictorMLP(z_dim, template.num_output)
        self.quat_predictor = QuatHead(nz_feat, zero_rotation_init=False)
        self.scale_predictor = ScaleHead(nz_feat)
        self.trans_predictor = TransHead(nz_feat)
        self._add_texture_and_template(nz_feat, compute_dtype)

    def forward(self, img, eps=None, generator=None):
        """img [B,H,W,3] -> dict of predictions; eps (VAE noise) is drawn
        from `generator` unless given."""
        feat, noise, mean, logvar = self.encode(img, eps, generator)
        outputs = dict(feat=noise, mean=mean, logvar=logvar,
                       cam=torch.cat([self.scale_predictor(feat),
                                      self.trans_predictor(feat),
                                      self.quat_predictor(feat)], dim=1))
        self._texture(feat, outputs)
        outputs["delta_v"] = self.shape_predictor(noise)
        return outputs


def symmetrize(V, template):
    """Half verts [..., num_indept + num_sym, 3] -> full verts: the
    trailing num_sym are mirrored across template.axis and appended."""
    flip = V.new_ones(3)
    flip[template.axis] = -1.0
    return torch.cat([V, flip * V[..., -template.num_sym:, :]], dim=-2)


@torch.no_grad()
def init_weights(model, generator):
    """Seeded initialisation mirroring the JAX package's initialisers:
    normal(0.02) for convs and linears of the heads, kaiming fan_out for
    the ResNet trunk, normal(1e-4) for stage 2's shape head and lecun
    normal (1/sqrt(fan_in), flax's Dense default) for stage 1's MLP, the
    quaternion heads' bias (1, 0, 0, 0) where zero_rotation_init, zero
    biases, unit BatchNorm scales."""
    def normal_(t, std):
        t.copy_(torch.randn(t.shape, generator=generator) * std)

    for name, mod in model.named_modules():
        if isinstance(mod, (nn.Conv2d, nn.Linear)):
            if ".resnet." in f".{name}.":
                fan_out = mod.weight.shape[0] * math.prod(mod.weight.shape[2:])
                normal_(mod.weight, math.sqrt(2.0 / fan_out))
            elif name.startswith("shape_predictor.pred_layer."):
                normal_(mod.weight, 1.0 / math.sqrt(mod.weight.shape[1]))
            elif name.startswith("shape_predictor"):
                normal_(mod.weight, 1e-4)
            else:
                normal_(mod.weight, 0.02)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, (nn.BatchNorm1d, nn.BatchNorm2d)):
            mod.reset_parameters()
    for mod in model.modules():
        if isinstance(mod, QuatHead) and mod.zero_rotation_init:
            mod.pred_layer.bias.copy_(torch.tensor([1.0, 0.0, 0.0, 0.0]))
    return model
