"""Console and scalar logging (port of umr_tpu/utils/visualizer.py):
coloured stdout and {checkpoint_dir}/{name}/loss_log.txt, whose lines
tools that read a run back parse ("(epoch: e, iters: i) k: v.vvv ...").
"""

from __future__ import annotations

import os
import time

import numpy as np

from .png import write_png


def green(s):
    return f"\033[92m{s}\033[0m"


def red(s):
    return f"\033[91m{s}\033[0m"


class Visualizer:
    def __init__(self, opts):
        self.log_dir = os.path.join(opts.checkpoint_dir, opts.name)
        os.makedirs(self.log_dir, exist_ok=True)
        self.log_name = os.path.join(self.log_dir, "loss_log.txt")
        with open(self.log_name, "a") as f:
            now = time.strftime("%c")
            f.write(f"================ Training Loss ({now}) ================\n")

    def print_current_scalars(self, epoch, i, scalars):
        message = f"(epoch: {epoch}, iters: {i}) "
        for k, v in scalars.items():
            message += "%s: %.3f " % (k, float(v))
        print(green(message))
        with open(self.log_name, "a") as f:
            f.write(message + "\n")


def save_image_grid(path, images):
    """Save [N,H,W,C] float [0,1] images as a horizontal grid PNG."""
    images = np.asarray(images)
    if images.ndim == 3:
        images = images[None]
    if images.shape[-1] == 1:
        images = np.repeat(images, 3, axis=-1)
    grid = np.concatenate(list(images), axis=1)
    write_png(path, (np.clip(grid, 0, 1) * 255).astype("uint8"))
