"""The training loop, minimal (port of umr_tpu/training/trainer.py:
prepare_batch and the epoch / step loop). Checkpoints, auto-resume,
visuals and the stage budget are not ported yet.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..config import Config, normalize_images


def prepare_batch(batch, use_scops=True, use_texture=True):
    """Host batch dict -> the step's input dict (numpy): normalised input
    images, masks, masked "real" images, and the barrier and part fields
    the losses read."""
    imgs = batch["img"].astype(np.float32)
    out = {
        "img": imgs,
        "input_img": normalize_images(imgs),
        "mask": batch["mask"].astype(np.float32),
        "real_imgs": imgs * batch["mask"][..., None].astype(np.float32),
    }
    if use_texture and "dts_barrier" in batch:
        out["dts_barrier"] = batch["dts_barrier"].astype(np.float32)
    if use_scops and "part_prob" in batch:
        out["part_prob"] = batch["part_prob"].astype(np.float32)
        for k in ("head_points", "belly_points", "neck_points",
                  "back_points"):
            out[k] = batch[k].astype(np.float32)
    return out


class Trainer:
    """Epochs over the dataloader, one step_fn(state, batch,
    *extra_step_args(epoch)) call per batch, stopping at cfg.num_iter when
    it is set; after each whole epoch, on_epoch_end(state, epoch) may
    return a new state (stage 1's template update). history holds each
    step's scalars (as floats) and its wall time, iter_time, from the call
    to the scalars' arrival on the host."""

    def __init__(self, cfg: Config, step_fn, state, dataloader,
                 extra_step_args=None, on_epoch_end=None):
        self.cfg = cfg
        self.step_fn = step_fn
        self.state = state
        self.dataloader = dataloader
        self.extra_step_args = extra_step_args or (lambda epoch: ())
        self.on_epoch_end = on_epoch_end
        self.history = []
        # the GAN's "real" images lag one batch behind, as the reference's
        # random_imgs buffer (filled from the first batch, refreshed after
        # each step; ref train_s2.py:183-184, 270)
        self._lagged_real = None

    def train(self):
        cfg = self.cfg
        for epoch in range(cfg.num_pretrain_epochs, cfg.num_epochs):
            for epoch_iter, batch in enumerate(self.dataloader):
                db = prepare_batch(batch, cfg.use_scops, cfg.use_texture)
                cur_real = db["real_imgs"]
                if (self._lagged_real is not None
                        and self._lagged_real.shape == cur_real.shape):
                    db["real_imgs"] = self._lagged_real
                self._lagged_real = cur_real
                start = time.perf_counter()
                self.state, scalars = self.step_fn(
                    self.state, db, *self.extra_step_args(epoch))
                values = torch.stack(list(scalars.values())).cpu().tolist()
                sc = dict(zip(scalars, values))
                sc["iter_time"] = time.perf_counter() - start
                self.history.append(sc)
                if cfg.print_scalars and self.state.step % cfg.print_freq == 0:
                    print(f"epoch {epoch} iter {epoch_iter + 1}: " + ", ".join(
                        f"{k} {v:.4f}" for k, v in sc.items()), flush=True)
                if cfg.num_iter and self.state.step >= cfg.num_iter:
                    return self.state
            # the epoch's last step has finished: its scalars are on the
            # host
            if self.on_epoch_end is not None:
                self.state = self.on_epoch_end(self.state, epoch) or self.state
        return self.state
