"""Self-supervised pretraining of the LPIPS AlexNet by rotation prediction
on random crops (port of tools/pretrain_lpips.py; the loop is
experiments/rotnet.py's).

The reference's perceptual loss runs on an ImageNet-pretrained AlexNet,
which is a download; this manufactures a generic pretrained one from raw
images only. Each image gives one random C x C crop (C = min(--crop, S),
offsets uniform over the image), so the rotation must be read from local
texture rather than the silhouette; then the jitter and the four
rotations, and LPIPS's input (2x - 1 - shift) / scale. The model: the
AlexNet features of a trainable LPIPSAlex (models/lpips.py; the loss's
own copy freezes itself), a global average pool of the last slice and
Linear(256, 4). Its max-pools are skipped below 3-px maps, as in both
packages' LPIPS (crops of 32 px and more keep them).

Writes `--out` (lpips_alex.npz, conv{i}/kernel|bias, the committed
file's layout: models/weights.py::alexnet_features_from_torch). Training
and avg_uv load it through UMR_TPU_LPIPS_WEIGHTS.

  python -m umr_tpu_torch.experiments.pretrain_lpips \
      --data /tmp/sp/train.npz --out /tmp/lpips/lpips_alex.npz --steps 600
"""

from __future__ import annotations

import os
import os.path as osp

import torch
import torch.nn as nn

from ..models.lpips import _SCALE, _SHIFT, LPIPSAlex
from ..models.weights import alexnet_features_from_torch, save_npz
from . import rotnet


class AlexLast(nn.Module):
    """A trainable LPIPSAlex's features, its last slice NCHW."""

    def __init__(self):
        super().__init__()
        self.alex = LPIPSAlex().requires_grad_(True)

    def forward(self, x):
        return self.alex.features(x)[-1]


@torch.no_grad()
def build_model(seed):
    """The RotNet over AlexNet, flax's default init from `seed`."""
    g = torch.Generator().manual_seed(seed)
    model = rotnet.RotNet(AlexLast(), 256)
    for conv in model.features.alex.convs:
        rotnet.lecun_normal_(conv, g)
    rotnet.lecun_normal_(model.head, g)
    return model


def draw_crops(shape, crop, generator, device):
    """Offsets oy, ox [B] of one C x C crop per image, C = min(crop, S)."""
    B, S = shape[0], shape[1]
    C = min(crop, S)
    return {k: torch.randint(0, S - C + 1, (B,), generator=generator,
                             device=device) for k in ("oy", "ox")}


def crop(x, oy, ox, C):
    """x [B,S,S,3] -> [B,C,C,3], image b from (oy[b], ox[b])."""
    r = torch.arange(C, device=x.device)
    rows = (oy[:, None] + r)[:, :, None]          # [B,C,1]
    cols = (ox[:, None] + r)[:, None, :]          # [B,1,C]
    b = torch.arange(x.shape[0], device=x.device)[:, None, None]
    return x[b, rows, cols]


def make_inputs(crop_size):
    """inputs(x, generator, draws=None) -> (the four rotations of each
    jittered crop as LPIPS input NCHW, labels); draws injects oy, ox,
    tint and noise."""
    def inputs(x, generator, draws=None):
        C = min(crop_size, x.shape[1])
        if draws is None:
            draws = draw_crops(x.shape, crop_size, generator, x.device)
            draws.update(rotnet.draw_jitter((x.shape[0], C, C, 3),
                                            generator, x.device))
        x = crop(x, draws["oy"], draws["ox"], C)
        xs, labels = rotnet.rotations(rotnet.jitter(x, draws))
        shift = xs.new_tensor(_SHIFT).view(1, 3, 1, 1)
        scale = xs.new_tensor(_SCALE).view(1, 3, 1, 1)
        return (2.0 * xs - 1.0 - shift) / scale, labels

    return inputs


def main(argv=None):
    """Parse argv, pretrain, write the npz; returns the loop's record with
    the written path."""
    ap = rotnet.parser(__doc__.splitlines()[0],
                       "cachedir/synparity_r6/train.npz",
                       "weights/lpips_alex.npz")
    ap.add_argument("--crop", type=int, default=128,
                    help="random-crop size fed to the net (locality)")
    args = ap.parse_args(argv)
    model = build_model(args.seed)
    rec = rotnet.pretrain(args, model, make_inputs(args.crop),
                          f"LPIPS alexnet (crops {args.crop}px)")
    os.makedirs(osp.dirname(args.out) or ".", exist_ok=True)
    save_npz(args.out, alexnet_features_from_torch(
        model.features.alex.state_dict()))
    print(f"wrote {args.out}; final rot-acc {rec['accs'][-1]:.3f}. "
          "Training loads it under UMR_TPU_LPIPS_WEIGHTS.")
    return dict(rec, out=args.out)


if __name__ == "__main__":
    main()
