"""LPIPS perceptual distance, uncalibrated AlexNet variant (port of
umr_tpu/models/lpips.py; the reference's PerceptualSimilarity
DistModel(net='alex')): the sum over AlexNet's five ReLU slices of
1 - cosine similarity of the channel vectors, averaged over space, after
a fixed shift and scale of the input.

Frozen: its parameters never require gradients and no optimizer holds
them. Weights: the committed weights/lpips_alex.npz (torchvision AlexNet
`features` in the flax layout; models/weights.py::load_lpips_npz).
compute_dtype (bf16 mixed precision) goes to the convs, as flax's dtype=
(net_blocks.Conv2d); the cosine distance is taken in float32.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .net_blocks import Conv2d

_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)
# torchvision AlexNet `features` convs: (in, out, kernel, stride, pad)
_CONVS = [(3, 64, 11, 4, 2), (64, 192, 5, 1, 2), (192, 384, 3, 1, 1),
          (384, 256, 3, 1, 1), (256, 256, 3, 1, 1)]
_POOL_BEFORE = (1, 2)   # max-pool after relu1 and relu2


class LPIPSAlex(nn.Module):
    """lpips(in0, in1): NHWC images in [-1, 1] -> per-sample distance [B]."""

    def __init__(self, compute_dtype=None):
        super().__init__()
        self.convs = nn.ModuleList(Conv2d(i, o, k, s, p,
                                          compute_dtype=compute_dtype)
                                   for i, o, k, s, p in _CONVS)
        self.register_buffer("shift", torch.tensor(_SHIFT).reshape(1, 3, 1, 1),
                             persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE).reshape(1, 3, 1, 1),
                             persistent=False)
        self.requires_grad_(False)

    def features(self, x):
        outs = []
        for i, conv in enumerate(self.convs):
            if i in _POOL_BEFORE and min(x.shape[2], x.shape[3]) >= 3:
                # skipped only for tiny test images (< 3 px maps)
                x = F.max_pool2d(x, 3, 2)
            x = F.relu(conv(x))
            outs.append(x)
        return outs

    def forward(self, in0, in1):
        f0 = self.features((in0.permute(0, 3, 1, 2) - self.shift) / self.scale)
        f1 = self.features((in1.permute(0, 3, 1, 2) - self.shift) / self.scale)
        val = 0.0
        for a, b in zip(f0, f1):
            a, b = a.float(), b.float()
            an = a / torch.linalg.norm(a, dim=1, keepdim=True).clamp_min(1e-10)
            bn = b / torch.linalg.norm(b, dim=1, keepdim=True).clamp_min(1e-10)
            val = val + (1.0 - (an * bn).sum(1)).mean(dim=(1, 2))
        return val

