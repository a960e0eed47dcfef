"""Label-image colouring and part-point sampling (copies of color_map,
colorize, prob2center and sample_prob of umr_tpu/utils/image.py;
tests/test_torch_host.py and tests/test_torch_synthetic_category.py pin
them equal)."""

from __future__ import annotations

import numpy as np


def color_map(N=256, normalized=False):
    """PASCAL-style colour map [N, 3]: uint8, or float in [0, 1]."""

    def bitget(v, idx):
        return (v & (1 << idx)) != 0

    dtype = "float32" if normalized else "uint8"
    cmap = np.zeros((N, 3), dtype=dtype)
    for i in range(N):
        r = g = b = 0
        c = i
        for j in range(8):
            r |= bitget(c, 0) << (7 - j)
            g |= bitget(c, 1) << (7 - j)
            b |= bitget(c, 2) << (7 - j)
            c >>= 3
        cmap[i] = [r, g, b]
    return cmap / 255 if normalized else cmap


def colorize(gray, n=5):
    """Label image [H,W] -> colour image [H,W,3] uint8 (label 255 white)."""
    cmap = color_map(n)
    out = np.zeros(gray.shape + (3,), np.uint8)
    for label in range(n):
        out[gray == label] = cmap[label]
    out[gray == 255] = 255
    return out


def prob2center(part_prob, mask, ch=1):
    """Soft centroid (x, y) in [-1, 1] of channel `ch` of a part
    probability map [H,W,C] inside `mask` [H,W]."""
    p = part_prob[:, :, ch] * mask
    p = p / max(float(p.sum()), 1e-12)
    H, W = p.shape
    x_map = np.tile(np.arange(W), (H, 1)) / W * 2 - 1.0
    y_map = np.tile(np.arange(H), (W, 1)).T / H * 2 - 1.0
    return np.array([(p * x_map).sum(), (p * y_map).sum()], np.float32)


def sample_prob(part_prob, mask, center, num_samples=10, ch=1, rng=None):
    """num_samples points [n,2] of channel `ch`: 1.5x as many pixels drawn
    from the masked map (the mask alone where the channel is empty), the
    num_samples closest to `center` kept. As the reference, the pixel
    index is split by `% H` and `// W` and coordinates are divided by
    256 whatever the image size."""
    rng = rng or np.random
    init = int(num_samples * 1.5)
    p = part_prob[:, :, ch] * mask
    flat = p.reshape(-1).astype(np.float64)
    s = flat.sum()
    if s <= 0:
        flat = mask.reshape(-1).astype(np.float64)
        s = max(flat.sum(), 1.0)
    flat = flat / s
    H, W = p.shape
    samples = rng.choice(H * W, size=init, p=flat)
    coords = np.zeros((init, 2), np.float32)
    coords[:, 0] = samples % H
    coords[:, 1] = samples // W
    coords = (coords / 256.0) * 2 - 1
    dist = ((coords - center) ** 2).sum(1)
    top = np.argsort(dist)[:num_samples]
    return coords[top]
