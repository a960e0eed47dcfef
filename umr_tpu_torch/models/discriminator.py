"""Image discriminator behind a gradient-reversal layer (port of
umr_tpu/models/discriminator.py; reference nnutils/discriminators.py).
The reversal (identity forward, -lambda * grad backward) lets the
generator and the discriminator share one optimizer, as in the reference.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


class GradientReversal(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lambda_):
        ctx.lambda_ = lambda_
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return -ctx.lambda_ * g, None


def gradient_reversal(x, lambda_=1.0):
    return GradientReversal.apply(x, lambda_)


class Discriminator(nn.Module):
    """NHWC images with in_dim channels -> one logit each, [B, 1]: four
    3x3 stride-2 convs (32, 64, 32, 32) with ReLU, a 1x1 conv to one
    channel, a linear layer over the flattened map."""

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
        x = gradient_reversal(imgs, self.lambda_).permute(0, 3, 1, 2)
        for conv in self.convs:
            x = F.relu(conv(x))
        x = self.head(x)
        return self.fc(x.reshape(x.shape[0], -1))
