"""ResNet-18 trunk, torchvision layout (port of umr_tpu/models/resnet.py).

Keys follow torchvision (`conv1`, `bn1`, `layer1.0.conv1`,
`layer2.0.downsample.0`, ...), so the reference checkpoints' trunk loads
as is. Max-pool pads with -inf, as torch's MaxPool2d does.

compute_dtype (bf16 mixed precision) goes to every conv; the BatchNorms
compute in float32 (net_blocks.py), so the residual adds, the ReLUs and
the max-pool run on float32, as in the JAX package's trunk.
"""

from __future__ import annotations

import torch.nn as nn

from .net_blocks import BatchNorm2d, Conv2d


def _bn(c):
    return BatchNorm2d(c, eps=1e-5, momentum=0.1)


class BasicBlock(nn.Module):
    def __init__(self, in_planes, planes, stride=1, compute_dtype=None):
        super().__init__()
        self.conv1 = Conv2d(in_planes, planes, 3, stride, 1, bias=False,
                            compute_dtype=compute_dtype)
        self.bn1 = _bn(planes)
        self.relu = nn.ReLU()
        self.conv2 = Conv2d(planes, planes, 3, 1, 1, bias=False,
                            compute_dtype=compute_dtype)
        self.bn2 = _bn(planes)
        self.downsample = None
        if stride != 1 or in_planes != planes:
            self.downsample = nn.Sequential(
                Conv2d(in_planes, planes, 1, stride, bias=False,
                       compute_dtype=compute_dtype),
                _bn(planes))

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        y = self.relu(self.bn1(self.conv1(x)))
        return self.relu(self.bn2(self.conv2(y)) + identity)


class ResNet18(nn.Module):
    """Stem + layer1..layer{n_blocks}; NCHW in, NCHW feature map out."""

    def __init__(self, n_blocks=4, compute_dtype=None):
        super().__init__()
        self.conv1 = Conv2d(3, 64, 7, 2, 3, bias=False,
                            compute_dtype=compute_dtype)
        self.bn1 = _bn(64)
        self.relu = nn.ReLU()
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        in_planes = 64
        self.n_blocks = n_blocks
        for li, (planes, stride) in enumerate(
                [(64, 1), (128, 2), (256, 2), (512, 2)][:n_blocks], start=1):
            setattr(self, f"layer{li}", nn.Sequential(
                BasicBlock(in_planes, planes, stride, compute_dtype),
                BasicBlock(planes, planes, 1, compute_dtype)))
            in_planes = planes

    def forward(self, x):
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        for li in range(1, self.n_blocks + 1):
            x = getattr(self, f"layer{li}")(x)
        return x


class ResNetConv(nn.Module):
    """The reference's `resnet_conv` wrapper: `resnet_conv.resnet.*` keys."""

    def __init__(self, n_blocks=4, compute_dtype=None):
        super().__init__()
        self.resnet = ResNet18(n_blocks, compute_dtype)

    def forward(self, x):
        return self.resnet(x)
