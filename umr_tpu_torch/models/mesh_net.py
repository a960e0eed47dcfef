"""MeshNet, stage 2: the single-view reconstruction predictor
(port of umr_tpu/models/mesh_net.py::MeshNet; reference
nnutils/cub_mesh.py:366-507).

Module names follow the reference's state_dict (`encoder.resnet_conv...`,
`cam_predictor.camera_predictor.3...`, `texture_predictor.decoder...`,
`mean_v`). Images enter NHWC, as in the JAX package.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn

from .heads import Encoder, MultiCamPredictor, ShapePredictor, TexturePredictorUV


class MeshNet(nn.Module):
    def __init__(self, template, input_size=256, nz_feat=200, z_dim=350,
                 num_hypo_cams=8):
        super().__init__()
        self.template = template
        self.encoder = Encoder(input_size, nz_feat, z_dim)
        self.shape_predictor = ShapePredictor(z_dim, template.num_output)
        self.cam_predictor = MultiCamPredictor(nz_feat, num_hypo_cams)
        H, W = template.uv_image_size()
        self.texture_predictor = TexturePredictorUV(
            nz_feat, template.uv_sampler, img_H=H, img_W=W,
            n_upconv=min(5, int(np.log2(H))),
            num_sym_faces=template.num_sym_faces)
        self.register_buffer("mean_v",
                             torch.as_tensor(np.asarray(template.mean_v_init)))

    def forward(self, img, eps=None, sample_inds=None, generator=None):
        """img [B,H,W,3] -> dict of predictions. eps (VAE noise) and
        sample_inds (camera hypothesis) are drawn from `generator` unless
        given."""
        feat, noise, mean, logvar = self.encoder(
            img.permute(0, 3, 1, 2), eps=eps, generator=generator)
        cam, inds, cam_probs, all_cams, quats = self.cam_predictor(
            feat, sample_inds=sample_inds, generator=generator)
        tex_flow, uv_image = self.texture_predictor(feat)
        return dict(
            cam=cam, cam_sample_inds=inds, cam_probs=cam_probs,
            cam_hypotheses=all_cams, base_quats=quats[:, 0],
            mean=mean, logvar=logvar, noise=noise, feat=feat,
            tex_flow=tex_flow, uvimage_pred=uv_image,
            delta_v=self.shape_predictor(noise),
        )

    def get_mean_shape(self):
        return symmetrize(self.mean_v, self.template)


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
    the ResNet trunk, normal(1e-4) for the shape head, the quaternion
    heads' bias (1, 0, 0, 0), zero biases, unit BatchNorm scales."""
    def normal_(t, std):
        t.copy_(torch.randn(t.shape, generator=generator) * std)

    for name, mod in model.named_modules():
        if isinstance(mod, (nn.Conv2d, nn.Linear)):
            if ".resnet." in f".{name}.":
                fan_out = mod.weight.shape[0] * math.prod(mod.weight.shape[2:])
                normal_(mod.weight, math.sqrt(2.0 / fan_out))
            elif name.startswith("shape_predictor"):
                normal_(mod.weight, 1e-4)
            else:
                normal_(mod.weight, 0.02)
            if mod.bias is not None:
                mod.bias.zero_()
                if name.endswith("quat_predictor.pred_layer"):
                    mod.bias.copy_(torch.tensor([1.0, 0.0, 0.0, 0.0]))
        elif isinstance(mod, (nn.BatchNorm1d, nn.BatchNorm2d)):
            mod.reset_parameters()
    return model
