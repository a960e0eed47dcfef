"""The networks of both stages in plain PyTorch, float32, one process: the
ResNet-18 trunk, MeshNet (stage 2) and MeshNetS1 (stage 1) with their
heads, the mask discriminator behind its gradient reversal, and
LPIPS-Alex. A frozen copy of the program's models (the layouts of NVlabs
UMR's nnutils/cub_mesh.py, cub_mesh_s1.py, net_blocks.py and
discriminators.py), so that module and parameter names, and the order in
which the seeded initialisation draws, are the program's.

Random draws (the VAE noise, the camera hypothesis) take an explicit
torch.Generator. The trunk and LPIPS load the committed npz files
themselves (load_resnet18_npz, load_lpips_npz).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .geom import grid_sample, hamilton_product


# ---- blocks (net_blocks.py) ------------------------------------------

def fc(in_features, out_features, use_bn=True):
    if use_bn:
        return nn.Sequential(nn.Linear(in_features, out_features),
                             nn.BatchNorm1d(out_features, eps=1e-5,
                                            momentum=0.1),
                             nn.LeakyReLU(0.2))
    return nn.Sequential(nn.Linear(in_features, out_features),
                         nn.LeakyReLU(0.1))


def fc_stack(in_features, out_features, nlayers, use_bn=True):
    return nn.Sequential(*[
        fc(in_features if i == 0 else out_features, out_features, use_bn)
        for i in range(nlayers)])


def conv2d(in_planes, out_planes, kernel_size=3, stride=1, use_bn=True):
    layers = [nn.Conv2d(in_planes, out_planes, kernel_size, stride,
                        (kernel_size - 1) // 2, bias=True)]
    if use_bn:
        layers.append(nn.BatchNorm2d(out_planes, eps=1e-5, momentum=0.1))
    layers.append(nn.LeakyReLU(0.2))
    return nn.Sequential(*layers)


def upconv2d(in_planes, out_planes):
    return nn.Sequential(
        nn.Upsample(scale_factor=2, mode="bilinear", align_corners=False),
        nn.ReflectionPad2d(1),
        nn.Conv2d(in_planes, out_planes, 3, 1, 0),
        nn.LeakyReLU(0.2))


def decoder2d(nlayers, nc_input, nc_final, nc_min=8):
    layers = []
    nc_output = nc_input
    for _ in range(nlayers):
        nc_in = nc_output
        if nc_output // 2 >= nc_min:
            nc_output = nc_output // 2
        layers.append(upconv2d(nc_in, nc_output))
        layers.append(conv2d(nc_output, nc_output))
    layers.append(nn.Conv2d(nc_output, nc_final, 3, 1, 1))
    return nn.Sequential(*layers)


# ---- ResNet-18 trunk (torchvision layout) -----------------------------

def _bn(c):
    return nn.BatchNorm2d(c, eps=1e-5, momentum=0.1)


class BasicBlock(nn.Module):
    def __init__(self, in_planes, planes, stride=1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_planes, planes, 3, stride, 1, bias=False)
        self.bn1 = _bn(planes)
        self.relu = nn.ReLU()
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = _bn(planes)
        self.downsample = None
        if stride != 1 or in_planes != planes:
            self.downsample = nn.Sequential(
                nn.Conv2d(in_planes, planes, 1, stride, bias=False),
                _bn(planes))

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        y = self.relu(self.bn1(self.conv1(x)))
        return self.relu(self.bn2(self.conv2(y)) + identity)


class ResNet18(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = _bn(64)
        self.relu = nn.ReLU()
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        in_planes = 64
        for li, (planes, stride) in enumerate(
                [(64, 1), (128, 2), (256, 2), (512, 2)], start=1):
            setattr(self, f"layer{li}", nn.Sequential(
                BasicBlock(in_planes, planes, stride),
                BasicBlock(planes, planes, 1)))
            in_planes = planes

    def forward(self, x):
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        for li in range(1, 5):
            x = getattr(self, f"layer{li}")(x)
        return x


class ResNetConv(nn.Module):
    def __init__(self):
        super().__init__()
        self.resnet = ResNet18()

    def forward(self, x):
        return self.resnet(x)


# ---- heads -------------------------------------------------------------

class Encoder(nn.Module):
    """ResNet trunk -> conv -> fc stack -> (feat, noise, mean, logvar)."""

    def __init__(self, input_size=256, nz_feat=200, z_dim=350):
        super().__init__()
        self.resnet_conv = ResNetConv()
        fmap = -(-input_size // 32)
        if fmap >= 2:
            self.enc_conv1 = conv2d(512, 256, kernel_size=4, stride=2)
            out = (fmap + 2 - 4) // 2 + 1
        else:
            self.enc_conv1 = conv2d(512, 256, kernel_size=1, stride=1)
            out = fmap
        self.enc_fc = fc_stack(256 * out * out, nz_feat, 2)
        self.mean_fc = nn.Sequential(nn.Linear(nz_feat, nz_feat),
                                     nn.LeakyReLU(0.01),
                                     nn.Linear(nz_feat, z_dim))
        self.logvar_fc = nn.Sequential(nn.Linear(nz_feat, nz_feat),
                                       nn.LeakyReLU(0.01),
                                       nn.Linear(nz_feat, z_dim))

    def forward(self, img, generator):
        x = self.enc_conv1(self.resnet_conv(img))
        feat = self.enc_fc(x.reshape(x.shape[0], -1))
        mean = self.mean_fc(feat)
        logvar = self.logvar_fc(feat)
        eps = torch.randn(mean.shape, generator=generator,
                          device=mean.device, dtype=mean.dtype)
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
    def __init__(self, nz_feat, uv_sampler, img_H=128, img_W=256,
                 n_upconv=5, nc_init=256, num_sym_faces=624):
        super().__init__()
        self.feat_H = img_H // (2 ** n_upconv)
        self.feat_W = img_W // (2 ** n_upconv)
        self.nc_init = nc_init
        self.num_sym_faces = num_sym_faces
        self.enc = fc_stack(nz_feat, nc_init * self.feat_H * self.feat_W, 2)
        self.decoder = decoder2d(n_upconv, nc_init, nc_final=2)
        self.register_buffer("uv_sampler",
                             torch.as_tensor(np.asarray(uv_sampler)),
                             persistent=False)

    def forward(self, feat):
        B = feat.shape[0]
        x = self.enc(feat).reshape(B, self.nc_init, self.feat_H, self.feat_W)
        uv_image = torch.tanh(self.decoder(x)).permute(0, 2, 3, 1)
        Ftex, T = self.uv_sampler.shape[:2]
        grid = self.uv_sampler.reshape(1, Ftex * T * T, 2).expand(B, -1, -1)
        tex = grid_sample(uv_image, grid).reshape(B, Ftex, T, T, 2)
        tex = torch.cat([tex, tex[:, -self.num_sym_faces:]], dim=1)
        return tex, uv_image


class _Pred(nn.Module):
    def __init__(self, nz, out):
        super().__init__()
        self.pred_layer = nn.Linear(nz, out)


class ScaleHead(_Pred):
    def __init__(self, nz):
        super().__init__(nz, 1)

    def forward(self, feat):
        return F.relu(1.0 * self.pred_layer(feat) + 1.0) + 1e-12


class QuatHead(_Pred):
    def __init__(self, nz, zero_rotation_init=True):
        super().__init__(nz, 4)
        self.zero_rotation_init = zero_rotation_init

    def forward(self, feat):
        q = self.pred_layer(feat)
        return q / torch.linalg.norm(q, dim=-1, keepdim=True).clamp_min(1e-12)


class TransHead(_Pred):
    def __init__(self, nz):
        super().__init__(nz, 2)

    def forward(self, feat):
        return self.pred_layer(feat)


class Camera(nn.Module):
    """One hypothesis head -> [quat(4), prob(1), scale(1), trans(2)]."""

    def __init__(self, nz_input):
        super().__init__()
        self.fc_layer = fc_stack(nz_input, nz_input, 2)
        self.quat_predictor = QuatHead(nz_input)
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
    base_rotation = torch.tensor([[0.9239, 0.0, 0.3827, 0.0]])
    biases = [torch.tensor([0.7071, 0.7071, 0.0, 0.0])]
    for _ in range(1, num_cams):
        biases.append(hamilton_product(base_rotation, biases[-1][None])[0])
    return torch.stack(biases)


class MultiCamPredictor(nn.Module):
    """num_cams hypotheses, their softmax probabilities and one hypothesis
    drawn in proportion to p + 1e-9."""

    def __init__(self, nz_feat=200, num_cams=8):
        super().__init__()
        self.fc = fc_stack(nz_feat, nz_feat, 2, use_bn=False)
        self.camera_predictor = nn.ModuleList(
            [Camera(nz_feat) for _ in range(num_cams)])
        # in the published state, unused by the forward
        self.scale_predictor = ScaleHead(nz_feat)
        self.trans_predictor = TransHead(nz_feat)
        self.prob_predictor = nn.Linear(nz_feat, num_cams)
        self.quat_predictor = QuatHead(nz_feat)
        self.register_buffer("cam_biases", cam_biases(num_cams))

    def forward(self, feat, generator):
        x = self.fc(feat)
        cams = torch.stack([c(x) for c in self.camera_predictor], dim=1)
        quats = cams[:, :, 0:4]
        cam_probs = torch.softmax(cams[:, :, 4], dim=1)
        all_cams = torch.cat([cams[:, :, 5:6], cams[:, :, 6:8], quats], dim=2)
        sample_inds = torch.multinomial(cam_probs + 1e-9, 1,
                                        generator=generator).long()
        cam = torch.gather(all_cams, 1,
                           sample_inds[:, :, None].expand(-1, 1, 7))[:, 0]
        return cam, cam_probs, all_cams


class _MeshNetBase(nn.Module):
    def __init__(self, template, input_size, nz_feat, z_dim):
        super().__init__()
        self.template = template
        self.encoder = Encoder(input_size, nz_feat, z_dim)

    def _add_texture_and_template(self, nz_feat):
        template = self.template
        H, W = template.uv_image_size()
        self.texture_predictor = TexturePredictorUV(
            nz_feat, template.uv_sampler, img_H=H, img_W=W,
            n_upconv=min(5, int(np.log2(H))),
            num_sym_faces=template.num_sym_faces)
        self.register_buffer("mean_v",
                             torch.tensor(np.asarray(template.mean_v_init)))

    def encode(self, img, generator):
        return self.encoder(img.permute(0, 3, 1, 2), generator)


class MeshNet(_MeshNetBase):
    """Stage 2: 8 camera hypotheses, the linear shape head."""

    def __init__(self, template, input_size=256, nz_feat=200, z_dim=350,
                 num_hypo_cams=8):
        super().__init__(template, input_size, nz_feat, z_dim)
        self.shape_predictor = ShapePredictor(z_dim, template.num_output)
        self.cam_predictor = MultiCamPredictor(nz_feat, num_hypo_cams)
        self._add_texture_and_template(nz_feat)

    def forward(self, img, generator):
        feat, noise, mean, logvar = self.encode(img, generator)
        cam, cam_probs, all_cams = self.cam_predictor(feat, generator)
        out = dict(cam=cam, cam_probs=cam_probs, cam_hypotheses=all_cams)
        out["tex_flow"], out["uvimage_pred"] = self.texture_predictor(feat)
        out["delta_v"] = self.shape_predictor(noise)
        return out


class MeshNetS1(_MeshNetBase):
    """Stage 1: the MLP shape head on the VAE sample, one camera."""

    def __init__(self, template, input_size=256, nz_feat=200, z_dim=350):
        super().__init__(template, input_size, nz_feat, z_dim)
        self.shape_predictor = ShapePredictorMLP(z_dim, template.num_output)
        self.quat_predictor = QuatHead(nz_feat, zero_rotation_init=False)
        self.scale_predictor = ScaleHead(nz_feat)
        self.trans_predictor = TransHead(nz_feat)
        self._add_texture_and_template(nz_feat)

    def forward(self, img, generator):
        feat, noise, mean, logvar = self.encode(img, generator)
        out = dict(cam=torch.cat([self.scale_predictor(feat),
                                  self.trans_predictor(feat),
                                  self.quat_predictor(feat)], dim=1))
        out["tex_flow"], out["uvimage_pred"] = self.texture_predictor(feat)
        out["delta_v"] = self.shape_predictor(noise)
        return out


def symmetrize(V, template):
    """Half verts [..., num_indept + num_sym, 3] -> full verts."""
    flip = V.new_ones(3)
    flip[template.axis] = -1.0
    return torch.cat([V, flip * V[..., -template.num_sym:, :]], dim=-2)


# ---- discriminator and LPIPS -------------------------------------------

class GradientReversal(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lambda_):
        ctx.lambda_ = lambda_
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return -ctx.lambda_ * g, None


class Discriminator(nn.Module):
    def __init__(self, lambda_=0.2, in_dim=1, img_size=256):
        super().__init__()
        self.lambda_ = lambda_
        chans = (in_dim, 32, 64, 32, 32)
        self.convs = nn.ModuleList(nn.Conv2d(chans[i], chans[i + 1], 3, 2, 1)
                                   for i in range(4))
        self.head = nn.Conv2d(32, 1, 1)
        side = img_size
        for _ in range(4):
            side = (side - 1) // 2 + 1
        self.fc = nn.Linear(side * side, 1)

    def forward(self, imgs):
        x = GradientReversal.apply(imgs, self.lambda_).permute(0, 3, 1, 2)
        for conv in self.convs:
            x = F.relu(conv(x))
        x = self.head(x)
        return self.fc(x.reshape(x.shape[0], -1))


_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)
LPIPS_CONVS = [(3, 64, 11, 4, 2), (64, 192, 5, 1, 2), (192, 384, 3, 1, 1),
               (384, 256, 3, 1, 1), (256, 256, 3, 1, 1)]
_POOL_BEFORE = (1, 2)


class LPIPSAlex(nn.Module):
    """Uncalibrated LPIPS-Alex: the sum over AlexNet's five ReLU slices of
    1 - cosine similarity of the channel vectors, averaged over space.
    Frozen."""

    def __init__(self):
        super().__init__()
        self.convs = nn.ModuleList(nn.Conv2d(i, o, k, s, p)
                                   for i, o, k, s, p in LPIPS_CONVS)
        self.register_buffer("shift", torch.tensor(_SHIFT).reshape(1, 3, 1, 1),
                             persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE).reshape(1, 3, 1, 1),
                             persistent=False)
        self.requires_grad_(False)

    def features(self, x):
        outs = []
        for i, conv in enumerate(self.convs):
            if i in _POOL_BEFORE and min(x.shape[2], x.shape[3]) >= 3:
                x = F.max_pool2d(x, 3, 2)
            x = F.relu(conv(x))
            outs.append(x)
        return outs

    def forward(self, in0, in1):
        f0 = self.features((in0.permute(0, 3, 1, 2) - self.shift) / self.scale)
        f1 = self.features((in1.permute(0, 3, 1, 2) - self.shift) / self.scale)
        val = 0.0
        for a, b in zip(f0, f1):
            an = a / torch.linalg.norm(a, dim=1, keepdim=True).clamp_min(1e-10)
            bn = b / torch.linalg.norm(b, dim=1, keepdim=True).clamp_min(1e-10)
            val = val + (1.0 - (an * bn).sum(1)).mean(dim=(1, 2))
        return val


# ---- seeded initialisation and the committed weights ---------------------

@torch.no_grad()
def init_weights(model, generator):
    """normal(0.02) for the heads' convs and linears, kaiming fan_out for
    the trunk, normal(1e-4) for stage 2's shape head, lecun normal for
    stage 1's MLP, the zero-rotation quaternion bias, zero biases, unit
    BatchNorm scales: each drawn on the host from `generator` in the
    order of named_modules."""
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


@torch.no_grad()
def init_disc(disc, generator):
    """lecun-normal weights, zero biases."""
    for mod in disc.modules():
        if isinstance(mod, (nn.Conv2d, nn.Linear)):
            fan_in = math.prod(mod.weight.shape[1:])
            mod.weight.copy_(torch.randn(mod.weight.shape, generator=generator)
                             / math.sqrt(fan_in))
            mod.bias.zero_()


def _hwio(a):
    return torch.tensor(np.ascontiguousarray(
        np.asarray(a, np.float32).transpose(3, 2, 0, 1)))


def load_resnet18_npz(trunk, params_path, stats_path):
    """The committed trunk (flax paths such as layer2_0/downsample_conv/
    kernel, HWIO kernels) into a ResNet18's weights and BatchNorm
    statistics."""
    params, stats = np.load(params_path), np.load(stats_path)
    sd = {}
    for key in params.files:
        *mod, leaf = key.split("/")
        path = ".".join(m.replace("_", ".", 1) if m.startswith("layer")
                        else m for m in mod)
        path = (path.replace("downsample_conv", "downsample.0")
                .replace("downsample_bn", "downsample.1"))
        name = {"kernel": "weight", "scale": "weight", "bias": "bias"}[leaf]
        sd[f"{path}.{name}"] = (_hwio(params[key]) if leaf == "kernel"
                                else torch.tensor(params[key]))
    for key in stats.files:
        *mod, leaf = key.split("/")
        path = ".".join(m.replace("_", ".", 1) if m.startswith("layer")
                        else m for m in mod)
        path = path.replace("downsample_bn", "downsample.1")
        sd[f"{path}.running_{leaf}"] = torch.tensor(stats[key])
    missing, unexpected = trunk.load_state_dict(sd, strict=False)
    if unexpected or any(not k.endswith("num_batches_tracked")
                         for k in missing):
        raise ValueError(f"trunk npz: missing {missing}, extra {unexpected}")


def load_lpips_npz(lpips, path):
    """weights/lpips_alex.npz (conv{i}/kernel HWIO, conv{i}/bias)."""
    d = np.load(path)
    sd = {}
    for i in range(len(LPIPS_CONVS)):
        sd[f"convs.{i}.weight"] = _hwio(d[f"conv{i}/kernel"])
        sd[f"convs.{i}.bias"] = torch.tensor(d[f"conv{i}/bias"])
    lpips.load_state_dict(sd)
