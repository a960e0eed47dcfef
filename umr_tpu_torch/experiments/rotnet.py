"""Rotation-prediction pretraining (RotNet, Gidaris et al. 2018), the part
that experiments/pretrain_trunk.py and pretrain_lpips.py share (ports of
the step bodies of tools/pretrain_trunk.py and tools/pretrain_lpips.py):
classify by which of {0, 90, 180, 270} degrees an image was rotated,
from raw images only.

Each step draws `--batch` images (np.random.RandomState(--seed), as the
JAX tools draw them), jitters each (a tint U(0.8, 1.2) per image and
channel, noise 0.02 N(0, 1), clipped to [0, 1]), stacks its four
rotations with label k for rot90 by k, and takes one Adam step (optax's
defaults) on the mean cross entropy. The draws come from a
torch.Generator on the device, seeded from --seed; `draws` injects them.
"""

from __future__ import annotations

import argparse
import math
import time

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import resolve_device


def parser(description, data, out):
    """The JAX tools' flags, plus --device."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--data", default=data,
                    help="npz with an 'img' array [N,S,S,3] in [0,1]")
    ap.add_argument("--out", default=out)
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--batch", type=int, default=16,
                    help="images per step; each yields 4 rotated copies")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="the card unless given (cpu for the CPU)")
    return ap


def draw_jitter(shape, generator, device):
    """tint [B,1,1,3] ~ U(0.8, 1.2) and noise [B,S,S,3] ~ 0.02 N(0, 1)."""
    tint = 0.8 + 0.4 * torch.rand((shape[0], 1, 1, 3), generator=generator,
                                  device=device)
    noise = 0.02 * torch.randn(shape, generator=generator, device=device)
    return {"tint": tint, "noise": noise}


def jitter(x, draws):
    """NHWC images in [0,1], tinted and noised, clipped to [0,1]."""
    return (x * draws["tint"] + draws["noise"]).clamp(0.0, 1.0)


def rotations(x):
    """NHWC [B,S,S,3] -> (NCHW [4B,3,S,S] of x rotated by k * 90 degrees
    for k = 0..3, labels [4B] = k): torch.rot90 over (H, W) is
    jnp.rot90(x, k, axes=(1, 2)) on NHWC."""
    x = x.permute(0, 3, 1, 2)
    xs = torch.cat([torch.rot90(x, k, dims=(2, 3)) for k in range(4)])
    labels = torch.arange(4, device=x.device).repeat_interleave(x.shape[0])
    return xs, labels


def loss_and_accuracy(logits, labels):
    """Mean cross entropy and rotation accuracy."""
    return (F.cross_entropy(logits, labels),
            (logits.argmax(-1) == labels).float().mean())


@torch.no_grad()
def lecun_normal_(module, generator):
    """flax's default Dense / Conv initialiser (variance 1 / fan_in), zero
    bias."""
    fan_in = math.prod(module.weight.shape[1:])
    module.weight.copy_(torch.randn(module.weight.shape, generator=generator)
                        / math.sqrt(fan_in))
    if module.bias is not None:
        module.bias.zero_()


class RotNet(nn.Module):
    """features(x) -> its last map, global average pool, Linear(c, 4)."""

    def __init__(self, features, channels):
        super().__init__()
        self.features = features
        self.head = nn.Linear(channels, 4)

    def forward(self, x):
        return self.head(self.features(x).mean(dim=(2, 3)))


def pretrain(args, model, inputs, label):
    """The loop: `inputs(x, generator)` -> (model input NCHW, labels) for
    each step's images x; Adam at args.lr. Prints the JAX tool's lines;
    returns {"losses", "accs", "wall_s"} (per step, read once at the
    end)."""
    device = resolve_device(args.device)
    imgs = np.load(args.data)["img"].astype(np.float32)
    N, S = imgs.shape[0], imgs.shape[1]
    imgs = torch.as_tensor(imgs, device=device)
    print(f"pretraining {label} on {N} images @ {S}px, "
          f"{args.steps} steps x {args.batch}x4 rotations")
    model = model.to(device).train()
    opt = torch.optim.Adam(model.parameters(), lr=args.lr, eps=1e-8)
    gen = torch.Generator(device).manual_seed(args.seed)
    rng_np = np.random.RandomState(args.seed)
    losses, accs = [], []
    t0 = time.perf_counter()
    for it in range(args.steps):
        idx = torch.as_tensor(rng_np.randint(0, N, size=args.batch),
                              device=device)
        xs, labels = inputs(imgs[idx], gen)
        loss, acc = loss_and_accuracy(model(xs), labels)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        loss = loss.detach()
        losses.append(loss)
        accs.append(acc)
        if (it + 1) % 50 == 0 or it == 0:
            print(f"step {it + 1}/{args.steps} loss {float(loss):.4f} "
                  f"rot-acc {float(acc):.3f} "
                  f"({time.perf_counter() - t0:.0f}s)")
    losses = torch.stack(losses).tolist()
    return {"losses": losses, "accs": torch.stack(accs).tolist(),
            "wall_s": time.perf_counter() - t0}
