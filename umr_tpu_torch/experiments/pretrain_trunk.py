"""Self-supervised pretraining of the ResNet-18 trunk by rotation
prediction (port of tools/pretrain_trunk.py; the loop is
experiments/rotnet.py's).

The reference trains from an ImageNet-pretrained trunk, which is a
download; this manufactures a generic pretrained trunk from raw images
only (no cameras, masks, keypoints or part labels). The model: the
port's ResNet-18 (n_blocks=4, kaiming fan-out init as the JAX package's),
a global average pool and Linear(512, 4); inputs normalised by the
ImageNet mean and std, as training's prepare_batch does.

Writes `--out` (resnet18_params.npz) and, beside it with 'params' ->
'stats' in the basename, the BatchNorm running statistics, in the layout
of the committed files (models/weights.py::resnet18_from_torch). torch
keeps the unbiased running variance and flax the biased one, so `var`
holds torch's. Training loads them through UMR_TPU_RESNET_WEIGHTS
(trunk_pretrained=True in the state and in every .pth).

  python -m umr_tpu_torch.experiments.pretrain_trunk \
      --data /tmp/sp/train.npz --out /tmp/trunk/resnet18_params.npz \
      --steps 600
"""

from __future__ import annotations

import math
import os
import os.path as osp

import torch

from ..models.resnet import ResNet18
from ..models.weights import (resnet18_from_torch, resnet18_stats_path,
                              save_npz)
from . import rotnet

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


@torch.no_grad()
def build_model(seed):
    """The RotNet over the trunk, initialised from `seed`."""
    g = torch.Generator().manual_seed(seed)
    model = rotnet.RotNet(ResNet18(n_blocks=4), 512)
    for mod in model.features.modules():
        if isinstance(mod, torch.nn.Conv2d):
            fan_out = mod.weight.shape[0] * math.prod(mod.weight.shape[2:])
            mod.weight.copy_(torch.randn(mod.weight.shape, generator=g)
                             * math.sqrt(2.0 / fan_out))
    rotnet.lecun_normal_(model.head, g)
    return model


def inputs(x, generator, draws=None):
    """Images x [B,S,S,3] -> (the normalised four rotations NCHW, labels)."""
    draws = draws or rotnet.draw_jitter(x.shape, generator, x.device)
    xs, labels = rotnet.rotations(rotnet.jitter(x, draws))
    mean = xs.new_tensor(MEAN).view(1, 3, 1, 1)
    std = xs.new_tensor(STD).view(1, 3, 1, 1)
    return (xs - mean) / std, labels


def main(argv=None):
    """Parse argv, pretrain, write the npz pair; returns the loop's
    record with the written paths."""
    args = rotnet.parser(__doc__.splitlines()[0],
                         "cachedir/synparity_r5/train.npz",
                         "weights/resnet18_params.npz").parse_args(argv)
    model = build_model(args.seed)
    rec = rotnet.pretrain(args, model, inputs, "trunk")
    os.makedirs(osp.dirname(args.out) or ".", exist_ok=True)
    params, stats = resnet18_from_torch(model.features.state_dict())
    save_npz(args.out, params)
    save_npz(resnet18_stats_path(args.out), stats)
    print(f"wrote {args.out} (+stats); final rot-acc {rec['accs'][-1]:.3f}. "
          "Training loads it under UMR_TPU_RESNET_WEIGHTS "
          "(trunk_pretrained=True).")
    return dict(rec, out=args.out, stats=resnet18_stats_path(args.out))


if __name__ == "__main__":
    main()
