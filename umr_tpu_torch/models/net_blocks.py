"""Building blocks of the reference's nnutils/net_blocks.py, NCHW inside
(port of umr_tpu/models/net_blocks.py).

Module indices follow the reference's nn.Sequential layout, so state_dict
keys are the reference's (e.g. `enc_fc.0.0.weight`, `enc_fc.0.1.running_mean`).
LeakyReLU slopes: 0.2 after BN, 0.1 for fc layers without BN, 0.2 for
convs. BatchNorm eps 1e-5, momentum 0.1 (flax's 0.9).

Mixed precision (--bf16) follows flax's `dtype=` of the JAX package's
convs: a conv given compute_dtype casts its input, weight and bias to it
and returns that dtype; every BatchNorm normalises a float32 copy of its
input and returns float32 (flax's BatchNorm(dtype=float32)); linear
layers stay float32. Parameters are float32 throughout.

Under data parallelism (parallel/mesh.py) every BatchNorm in train mode
normalises over the global batch, as flax's BatchNorm does under the JAX
package's sharded step: global_batch_norm, over all_reduce only (gloo
has no all_gather on CUDA tensors, which torch.nn.SyncBatchNorm needs).
Under make_mesh_2d the sums span the data group, which holds the global
batch once (the ranks of a model group hold the same block).
The running statistics take the global mean and the unbiased global
variance (torch's convention; flax's is biased). With no group, or in
eval mode, each is torch's module, bit for bit.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..parallel import all_reduce_, data_group, data_rank_and_size


class Conv2d(nn.Conv2d):
    """nn.Conv2d that, under compute_dtype, casts its input, weight and
    bias to that dtype and returns it (None: the module's own dtype)."""

    def __init__(self, *args, compute_dtype=None, **kw):
        super().__init__(*args, **kw)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        return self._conv_forward(
            x.to(dt), self.weight.to(dt),
            None if self.bias is None else self.bias.to(dt))


class _GlobalBatchNorm(torch.autograd.Function):
    """Train-mode batch norm over the global batch of all ranks: x [N, C,
    ...] float32, this rank's block. The forward sums, over the ranks,
    the values with their count, then the squares centred on the global
    mean (two passes: sums of x and x^2 cancel in float32); the backward
    sums dy and dy * x_hat. The weight and bias gradients are this rank's
    own sums, which the step averages over the ranks with every other
    gradient."""

    @staticmethod
    def forward(ctx, x, weight, bias, bn):
        C = x.shape[1]
        dims = [0] + list(range(2, x.ndim))
        shape = [1, C] + [1] * (x.ndim - 2)
        sums = torch.cat([x.sum(dims), x.new_full((1,), x.numel() // C)])
        all_reduce_([sums], mean=False, group=data_group())
        count = sums[C]
        mean = sums[:C] / count
        xc = x - mean.view(shape)
        var = (xc * xc).sum(dims)
        all_reduce_([var], mean=False, group=data_group())
        var = var / count
        invstd = torch.rsqrt(var + bn.eps)
        x_hat = xc * invstd.view(shape)
        with torch.no_grad():
            bn.num_batches_tracked.add_(1)
            m = (bn.momentum if bn.momentum is not None
                 else 1.0 / float(bn.num_batches_tracked))
            bn.running_mean.mul_(1 - m).add_(mean, alpha=m)
            bn.running_var.mul_(1 - m).add_(var * count / (count - 1),
                                            alpha=m)
        ctx.save_for_backward(x_hat, invstd, weight, count)
        return x_hat * weight.view(shape) + bias.view(shape)

    @staticmethod
    def backward(ctx, dy):
        x_hat, invstd, weight, count = ctx.saved_tensors
        C = dy.shape[1]
        dims = [0] + list(range(2, dy.ndim))
        shape = [1, C] + [1] * (dy.ndim - 2)
        local = torch.cat([dy.sum(dims), (dy * x_hat).sum(dims)])
        sums = local.clone()
        all_reduce_([sums], mean=False, group=data_group())
        dx = (dy - (sums[:C] / count).view(shape)
              - x_hat * (sums[C:] / count).view(shape)) * (
            invstd * weight).view(shape)
        return dx, local[C:], local[:C], None


class _FloatBatchNorm:
    """A BatchNorm on a float32 copy of its input (a float32 input is
    taken as is): after a bfloat16 conv it computes and returns float32.
    In train mode over a data axis of more than one rank it normalises
    over the global batch (_GlobalBatchNorm)."""

    def forward(self, x):
        x = x.float()
        if self.training and data_rank_and_size()[1] > 1:
            return _GlobalBatchNorm.apply(x, self.weight, self.bias, self)
        return super().forward(x)


class BatchNorm2d(_FloatBatchNorm, nn.BatchNorm2d):
    pass


class BatchNorm1d(_FloatBatchNorm, nn.BatchNorm1d):
    pass


def fc(in_features, out_features, use_bn=True):
    """Linear [+ BatchNorm1d] + LeakyReLU."""
    if use_bn:
        return nn.Sequential(nn.Linear(in_features, out_features),
                             BatchNorm1d(out_features, eps=1e-5,
                                         momentum=0.1),
                             nn.LeakyReLU(0.2))
    return nn.Sequential(nn.Linear(in_features, out_features),
                         nn.LeakyReLU(0.1))


def fc_stack(in_features, out_features, nlayers, use_bn=True):
    return nn.Sequential(*[
        fc(in_features if i == 0 else out_features, out_features, use_bn)
        for i in range(nlayers)
    ])


def conv2d(in_planes, out_planes, kernel_size=3, stride=1, use_bn=True,
           compute_dtype=None):
    """Conv (padding (k-1)//2) [+ BatchNorm2d] + LeakyReLU(0.2)."""
    layers = [Conv2d(in_planes, out_planes, kernel_size, stride,
                     (kernel_size - 1) // 2, bias=True,
                     compute_dtype=compute_dtype)]
    if use_bn:
        layers.append(BatchNorm2d(out_planes, eps=1e-5, momentum=0.1))
    layers.append(nn.LeakyReLU(0.2))
    return nn.Sequential(*layers)


def upconv2d(in_planes, out_planes, mode="bilinear", compute_dtype=None):
    """2x upsample (half-pixel centres) + reflection pad + 3x3 valid conv +
    LeakyReLU(0.2)."""
    return nn.Sequential(
        nn.Upsample(scale_factor=2, mode=mode, align_corners=False),
        nn.ReflectionPad2d(1),
        Conv2d(in_planes, out_planes, 3, 1, 0, compute_dtype=compute_dtype),
        nn.LeakyReLU(0.2),
    )


def decoder2d(nlayers, nc_input, nc_final, nc_min=8, use_bn=True,
              upconv_mode="bilinear", compute_dtype=None):
    """nlayers of (upconv + conv-bn block), halving channels down to
    nc_min, then a final 3x3 conv to nc_final (in compute_dtype: the
    caller casts it back, as the JAX package's Decoder2d does)."""
    layers = []
    nc_output = nc_input
    for _ in range(nlayers):
        nc_in = nc_output
        if nc_output // 2 >= nc_min:
            nc_output = nc_output // 2
        layers.append(upconv2d(nc_in, nc_output, upconv_mode, compute_dtype))
        layers.append(conv2d(nc_output, nc_output, use_bn=use_bn,
                             compute_dtype=compute_dtype))
    layers.append(Conv2d(nc_output, nc_final, 3, 1, 1,
                         compute_dtype=compute_dtype))
    return nn.Sequential(*layers)
