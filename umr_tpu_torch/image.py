"""Label-image colouring (copy of color_map and colorize of
umr_tpu/utils/image.py; tests/test_torch_host.py pins them equal)."""

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
