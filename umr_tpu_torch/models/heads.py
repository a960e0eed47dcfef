"""Prediction heads: encoder, shape (stage 2's linear head, stage 1's
MLP), texture flow, cameras (port of umr_tpu/models/heads.py; reference
nnutils/cub_mesh.py and cub_mesh_s1.py).

Parity traps reproduced here:
  * Encoder: the 4x4/s2 `enc_conv1` becomes a 1x1 conv for inputs under
    64 px (the trunk's map is then 1x1); features flatten in CHW order.
  * Encoder: the VAE noise is drawn in eval too; LeakyReLU 0.01 in the
    mean/logvar heads.
  * Camera: the scale head runs at lr=1.0, bias=1.0 whatever the
    scale_lr / scale_bias flags say (dead in the reference).
  * MultiCamPredictor: the hypothesis is a categorical draw over
    log(p + 1e-9), i.e. proportional to p + 1e-9.
  * QuatHeadAzEle (az_ele_quat): its linear layer exists and is unused;
    the angles are tanh of the features' first three entries.
compute_dtype (bf16 mixed precision) reaches the convs of the encoder's
trunk, its enc_conv1 and the texture decoder (net_blocks.py); the linear
layers and every head stay float32, as in the JAX package.
Random draws take an explicit torch.Generator, or are injected (`eps`,
`sample_inds`) so tests can feed the JAX package's draws. Under data
parallelism the VAE noise is drawn at the global batch's shape, each
rank taking its block, and the camera hypothesis from a stream of the
rank's own (parallel/mesh.py::rank_block, rank_generator).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.grid_sample import grid_sample
from ..ops.quaternion import ang2quat, hamilton_product
from ..parallel import rank_block, rank_generator
from .net_blocks import conv2d, decoder2d, fc_stack
from .resnet import ResNetConv


class Encoder(nn.Module):
    """ResNet trunk -> conv -> fc stack -> (feat, noise, mean, logvar).
    Input NCHW."""

    def __init__(self, input_size=256, nz_feat=200, z_dim=350,
                 compute_dtype=None):
        super().__init__()
        self.resnet_conv = ResNetConv(n_blocks=4, compute_dtype=compute_dtype)
        fmap = -(-input_size // 32)             # trunk output side
        if fmap >= 2:
            self.enc_conv1 = conv2d(512, 256, kernel_size=4, stride=2,
                                    compute_dtype=compute_dtype)
            out = (fmap + 2 - 4) // 2 + 1
        else:
            self.enc_conv1 = conv2d(512, 256, kernel_size=1, stride=1,
                                    compute_dtype=compute_dtype)
            out = fmap
        self.enc_fc = fc_stack(256 * out * out, nz_feat, 2)
        self.mean_fc = nn.Sequential(nn.Linear(nz_feat, nz_feat),
                                     nn.LeakyReLU(0.01),
                                     nn.Linear(nz_feat, z_dim))
        self.logvar_fc = nn.Sequential(nn.Linear(nz_feat, nz_feat),
                                       nn.LeakyReLU(0.01),
                                       nn.Linear(nz_feat, z_dim))

    def forward(self, img, eps=None, generator=None):
        x = self.enc_conv1(self.resnet_conv(img))
        feat = self.enc_fc(x.reshape(x.shape[0], -1))
        mean = self.mean_fc(feat)
        logvar = self.logvar_fc(feat)
        if eps is None:
            eps = rank_block(lambda n: torch.randn(
                (n,) + mean.shape[1:], generator=generator,
                device=mean.device, dtype=mean.dtype), mean.shape[0])
        noise = eps * torch.exp(0.5 * logvar) + mean
        return feat, noise, mean, logvar


class ShapePredictor(nn.Module):
    def __init__(self, nz_feat, num_verts):
        super().__init__()
        self.pred_layer = nn.Linear(nz_feat, num_verts * 3)

    def forward(self, feat):
        dv = self.pred_layer(feat)
        return dv.reshape(dv.shape[0], -1, 3)


class ShapePredictorMLP(nn.Module):
    """Stage 1's shape head: 5 linear layers, widths z, 2z, 4z, 8z, then
    3 per vertex, with leaky ReLU 0.01 between them (reference key layout
    shape_predictor.pred_layer.{0,2,4,6,8})."""

    def __init__(self, nz_feat, num_verts):
        super().__init__()
        widths = [nz_feat, nz_feat, nz_feat * 2, nz_feat * 4, nz_feat * 8]
        layers = []
        for a, b in zip(widths[:-1], widths[1:]):
            layers += [nn.Linear(a, b), nn.LeakyReLU(0.01)]
        self.pred_layer = nn.Sequential(*layers,
                                        nn.Linear(widths[-1], num_verts * 3))

    def forward(self, feat):
        dv = self.pred_layer(feat)
        return dv.reshape(dv.shape[0], -1, 3)


class TexturePredictorUV(nn.Module):
    """fc stack -> conv decoder -> tanh UV flow image -> per-face texel
    flow. Returns (tex_flow [B,F,T,T,2], uv_image [B,H,W,2])."""

    def __init__(self, nz_feat, uv_sampler, img_H=128, img_W=256,
                 n_upconv=5, nc_init=256, num_sym_faces=624,
                 compute_dtype=None):
        super().__init__()
        self.feat_H = img_H // (2 ** n_upconv)
        self.feat_W = img_W // (2 ** n_upconv)
        self.nc_init = nc_init
        self.num_sym_faces = num_sym_faces
        self.enc = fc_stack(nz_feat, nc_init * self.feat_H * self.feat_W, 2)
        self.decoder = decoder2d(n_upconv, nc_init, nc_final=2,
                                 compute_dtype=compute_dtype)
        # not part of the state: the reference stores it batch-shaped
        self.register_buffer("uv_sampler",
                             torch.as_tensor(np.asarray(uv_sampler)),
                             persistent=False)

    def forward(self, feat):
        B = feat.shape[0]
        x = self.enc(feat).reshape(B, self.nc_init, self.feat_H, self.feat_W)
        # the last conv's output back to float32
        uv_image = torch.tanh(self.decoder(x).float()).permute(0, 2, 3, 1)
        Ftex, T = self.uv_sampler.shape[:2]
        grid = self.uv_sampler.reshape(1, Ftex * T * T, 2).expand(B, -1, -1)
        tex = grid_sample(uv_image, grid).reshape(B, Ftex, T, T, 2)
        tex = torch.cat([tex, tex[:, -self.num_sym_faces:]], dim=1)
        return tex, uv_image


class _Pred(nn.Module):
    """A head whose linear layer is `pred_layer` (reference key layout)."""

    def __init__(self, nz, out):
        super().__init__()
        self.pred_layer = nn.Linear(nz, out)


class ScaleHead(_Pred):
    """relu(1.0 * linear(feat) + 1.0) + 1e-12."""

    def __init__(self, nz):
        super().__init__(nz, 1)

    def forward(self, feat):
        return F.relu(1.0 * self.pred_layer(feat) + 1.0) + 1e-12


class QuatHead(_Pred):
    """Normalised quaternion head. zero_rotation_init: init_weights sets
    its bias to (1, 0, 0, 0) (stage 2), else to zero (stage 1)."""

    def __init__(self, nz, zero_rotation_init=True):
        super().__init__(nz, 4)
        self.zero_rotation_init = zero_rotation_init

    def forward(self, feat):
        q = self.pred_layer(feat)
        return q / torch.linalg.norm(q, dim=-1, keepdim=True).clamp_min(1e-12)


class QuatHeadAzEle(_Pred):
    """Azimuth / elevation / cyclo-rotation camera head (az_ele_quat), with
    the reference's quirk kept: its linear layer exists but is unused,
    and the angles are tanh(feat[..., :3]) over the CUB ranges pi/6,
    pi/2, pi/3 (ops/quaternion.py::ang2quat)."""

    def __init__(self, nz):
        super().__init__(nz, 3)

    def forward(self, feat):
        return ang2quat(feat[..., :3])


class TransHead(_Pred):
    def __init__(self, nz):
        super().__init__(nz, 2)

    def forward(self, feat):
        return self.pred_layer(feat)


class Camera(nn.Module):
    """One hypothesis head -> [quat(4), prob(1), scale(1), trans(2)]."""

    def __init__(self, nz_input, az_ele_quat=False):
        super().__init__()
        self.fc_layer = fc_stack(nz_input, nz_input, 2)
        self.quat_predictor = (QuatHeadAzEle(nz_input) if az_ele_quat
                               else QuatHead(nz_input))
        self.prob_predictor = nn.Linear(nz_input, 1)
        self.scale_predictor = ScaleHead(nz_input)
        self.trans_predictor = TransHead(nz_input)

    def forward(self, feat):
        feat = self.fc_layer(feat)
        return torch.cat([self.quat_predictor(feat),
                          self.prob_predictor(feat),
                          self.scale_predictor(feat),
                          self.trans_predictor(feat)], dim=1)


def cam_biases(num_cams):
    """pi/4-spaced quaternion biases (kept in the state for checkpoint
    parity; the reference never applies them)."""
    base_rotation = torch.tensor([[0.9239, 0.0, 0.3827, 0.0]])
    biases = [torch.tensor([0.7071, 0.7071, 0.0, 0.0])]
    for _ in range(1, num_cams):
        biases.append(hamilton_product(base_rotation, biases[-1][None])[0])
    return torch.stack(biases)


class MultiCamPredictor(nn.Module):
    """num_cams hypotheses + softmax probs + one sampled hypothesis.
    Returns (cam [B,7], sample_inds [B,1], cam_probs [B,K],
    all_cams [B,K,7], quats [B,K,4])."""

    def __init__(self, nz_feat=200, num_cams=8, az_ele_quat=False):
        super().__init__()
        self.fc = fc_stack(nz_feat, nz_feat, 2, use_bn=False)
        self.camera_predictor = nn.ModuleList(
            [Camera(nz_feat, az_ele_quat) for _ in range(num_cams)])
        # present in the reference's state, unused by its forward
        self.scale_predictor = ScaleHead(nz_feat)
        self.trans_predictor = TransHead(nz_feat)
        self.prob_predictor = nn.Linear(nz_feat, num_cams)
        self.quat_predictor = QuatHead(nz_feat)
        self.register_buffer("cam_biases", cam_biases(num_cams))

    def forward(self, feat, sample_inds=None, generator=None):
        x = self.fc(feat)
        cams = torch.stack([c(x) for c in self.camera_predictor], dim=1)
        quats = cams[:, :, 0:4]
        cam_probs = torch.softmax(cams[:, :, 4], dim=1)
        all_cams = torch.cat([cams[:, :, 5:6], cams[:, :, 6:8], quats], dim=2)
        if sample_inds is None:
            # categorical over log(p + 1e-9) == multinomial over p + 1e-9
            sample_inds = torch.multinomial(
                cam_probs + 1e-9, 1, generator=rank_generator(generator))
        sample_inds = sample_inds.reshape(-1, 1).to(all_cams.device).long()
        cam = torch.gather(all_cams, 1,
                           sample_inds[:, :, None].expand(-1, 1, 7))[:, 0]
        return cam, sample_inds, cam_probs, all_cams, quats
