"""The training loop (port of umr_tpu/training/trainer.py): epochs over
the dataloader, the batch's host preparation and its copy to the card,
the step, a one-step-lagged scalar drain, the log and the print / save
cadences, checkpoints with auto-resume, and the stage budget.

Each phase of the step cycle is a span (tracing.py): "trainer.loader"
(the wait for the loader's batch), "trainer.prep" (prepare_batch),
"trainer.transfer" (the copy to the card; its bytes are counted as
"trainer.h2d_bytes"), "trainer.dispatch" (the step call and the queueing
of its scalars), "trainer.drain" (the wait for a step's scalars), and
"trainer.vis", "trainer.save" and "trainer.epoch_end". stage_budget.json
is read from those spans' totals since the trainer began.

Files in {checkpoint_dir}/{name}/: opts.log (the Config), loss_log.txt
(visualizer.py), pred_net_{latest,<epoch>}.pth and pred_state.pt
(checkpoints.py), stage_budget.json. With a visuals_fn
(training/visuals.py) and cfg.display_visuals, every display_freq steps
the visuals go to {vis_dir}/{name}/, timed under the budget's "vis".

In a group of ranks (parallel/mesh.py; --data_parallel through the entry
points' launcher) every rank runs this loop on its own loader's batches
(its block of each global batch) on its own device: every rank resumes
from the same files, then takes rank 0's state (replicate), and reads
the step's scalars as their means over the ranks. Rank 0 alone writes
the files above and prints; the checkpoints wait for its write.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from ..config import Config, normalize_images
from ..parallel import is_writer, replicate
from ..tracing import count, delta, span, totals
from ..visualizer import Visualizer, green
from . import checkpoints
from .visuals import save_visuals

# where each step cycle's wall time goes (stage_budget.json): the spans
# "trainer.<key>"
BUDGET_KEYS = ("loader", "prep", "transfer", "dispatch", "drain", "vis",
               "save")
_END = object()


def _f32(x):
    """A numpy array as float32 (a copy), or a tensor as float32 on its
    device."""
    return x.float() if torch.is_tensor(x) else x.astype(np.float32)


def prepare_batch(batch, use_scops=True, use_texture=True):
    """Batch dict -> the step's input dict: normalised input images,
    masks, masked "real" images, and the barrier and part fields the
    losses read. Numpy entries give numpy; entries that are tensors (a
    device loader's batch) stay on their device and are normalised
    there."""
    imgs = _f32(batch["img"])
    mask = _f32(batch["mask"])
    out = {
        "img": imgs,
        "input_img": normalize_images(imgs),
        "mask": mask,
        "real_imgs": imgs * mask[..., None],
    }
    if use_texture and "dts_barrier" in batch:
        out["dts_barrier"] = _f32(batch["dts_barrier"])
    if use_scops and "part_prob" in batch:
        out["part_prob"] = _f32(batch["part_prob"])
        for k in ("head_points", "belly_points", "neck_points",
                  "back_points"):
            out[k] = _f32(batch[k])
    return out


def transfer(db, device):
    """(the step's batch on `device`, the pinned host buffers its copies
    read). On the card, numpy entries are copied from pinned memory
    without blocking (the buffers must live until the step is drained),
    tensors already there are taken as they are and tensors elsewhere
    moved with .to; off the card the batch is returned as it is."""
    if device.type != "cuda":
        return db, ()
    out, pinned, nbytes = {}, [], 0
    for k, v in db.items():
        if torch.is_tensor(v):
            if v.device.type == "cpu":
                nbytes += v.nbytes
            out[k] = v.to(device)
        else:
            pinned.append(torch.from_numpy(np.ascontiguousarray(v))
                          .pin_memory())
            nbytes += v.nbytes
            out[k] = pinned[-1].to(device, non_blocking=True)
    count("trainer.h2d_bytes", nbytes)
    return out, tuple(pinned)


class Trainer:
    """Epochs over the dataloader, one step_fn(state, batch,
    *extra_step_args(epoch)) call per batch, stopping at cfg.num_iter when
    it is set; after each whole epoch, on_epoch_end(state, epoch) may
    return a new state (stage 1's template update). state is a
    training/steps.py::TrainState.

    When the model lies on the card, the trainer copies each batch's host
    arrays there from pinned memory without blocking (a device loader's
    tensors are not copied again; transfer()), and reads a step's scalars
    back only after it has dispatched the next step (their copy to the
    host is queued behind the step that made them), so host work can
    overlap the card's. On the CPU the step takes the batch as it comes.

    visuals_fn(state, batch) -> the visuals of training/visuals.py, called
    when every display_freq-th step is drained, with that step's batch.

    history holds each step's scalars (as floats) and iter_time, its wall
    time from dispatch to the drain of its scalars."""

    def __init__(self, cfg: Config, step_fn, state, dataloader,
                 extra_step_args=None, on_epoch_end=None, visuals_fn=None):
        self.cfg = cfg
        self.step_fn = step_fn
        self.state = state
        self.dataloader = dataloader
        self.extra_step_args = extra_step_args or (lambda epoch: ())
        self.on_epoch_end = on_epoch_end
        self.visuals_fn = visuals_fn
        self.vis_out = os.path.join(cfg.vis_dir, cfg.name)
        self.device = next(state.model.parameters()).device
        self.history = []
        self.writer = is_writer()
        self.save_dir = os.path.join(cfg.checkpoint_dir, cfg.name)
        os.makedirs(self.save_dir, exist_ok=True)
        if self.writer:
            self._dump_opts()
        self._maybe_auto_resume()
        self.state = replicate(self.state)
        # the GAN's "real" images lag one batch behind, as the reference's
        # random_imgs buffer (filled from the first batch, refreshed after
        # each step; ref train_s2.py:183-184, 270)
        self._lagged_real = None
        self._pending = None
        self._began = totals()
        self._first_cycle_s = None

    def _maybe_auto_resume(self):
        """Restore {save_dir}/pred_state.pt when it exists: step, weights,
        optimizer, generator and template come back. UMR_TPU_RESUME (the
        entry points' .pth import) overrides it; UMR_TPU_NO_AUTORESUME=1
        disables it."""
        if (os.environ.get("UMR_TPU_NO_AUTORESUME")
                or os.environ.get("UMR_TPU_RESUME")):
            return
        path = checkpoints.state_path(self.save_dir)
        if not os.path.exists(path):
            return
        try:
            checkpoints.restore_state(self.save_dir, self.state)
            self._print(green(f"Auto-resumed from {path} at step "
                              f"{self.state.step}."))
        except (ValueError, KeyError, RuntimeError) as e:
            # a state of another model, or a damaged file: start fresh
            self._print(f"Auto-resume from {path} failed ({e}); starting "
                        "fresh.")

    def _print(self, msg):
        if self.writer:
            print(msg)

    def _dump_opts(self):
        with open(os.path.join(self.save_dir, "opts.log"), "w") as f:
            for k, v in sorted(vars(self.cfg).items()):
                f.write(f"{k}: {v}\n")

    def save(self, label, export_pth=True):
        """The resume state, and the .pth unless export_pth=False (the
        mid-run cadence: only stage handoffs read the .pth)."""
        with span("trainer.save"):
            checkpoints.save_state(self.save_dir, self.state)
            if export_pth:
                checkpoints.save_pth(
                    os.path.join(self.save_dir, f"pred_net_{label}.pth"),
                    self.state.model,
                    meta={"trunk_pretrained": self.state.trunk_pretrained})
        self._dump_budget()

    def budget(self):
        """{budget key: seconds} since the trainer began, from its spans;
        "epoch_end" only once on_epoch_end has run."""
        d = delta(self._began)
        keys = BUDGET_KEYS + (("epoch_end",) if d["calls"].get(
            "trainer.epoch_end") else ())
        return {k: d["seconds"].get(f"trainer.{k}", 0.0) for k in keys}

    def _dump_budget(self):
        # one step cycle per dispatch
        n = delta(self._began)["calls"].get("trainer.dispatch", 0)
        if not n or not self.writer:
            return
        budget = self.budget()
        out = {f"{k}_s_per_step": round(v / n, 4)
               for k, v in budget.items()}
        out["steps"] = n
        out["total_s_per_step"] = round(sum(budget.values()) / n, 4)
        if self._first_cycle_s is not None:
            out["first_cycle_s"] = round(self._first_cycle_s, 1)
        with open(os.path.join(self.save_dir, "stage_budget.json"), "w") as f:
            json.dump(out, f, indent=1)
        print("stage budget:", json.dumps(out))

    def _queue_scalars(self, scalars):
        """Start the scalars' copy to the host behind the step that made
        them: (values, the event that marks them ready or None)."""
        values = torch.stack([v.detach().float().reshape(())
                              for v in scalars.values()])
        if not values.is_cuda:
            return values, None
        host = torch.empty(values.shape, dtype=values.dtype, pin_memory=True)
        host.copy_(values, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return host, event

    def train(self):
        cfg = self.cfg
        visualizer = Visualizer(cfg) if self.writer else None
        total_steps = int(self.state.step)       # 0 or resumed
        dispatched = total_steps
        smoothed = 0.0
        self._pending = None
        if cfg.num_iter and total_steps >= cfg.num_iter:
            # resumed at or past the target: the run is done; do not train
            # on through num_epochs over the finished checkpoint
            self._print(green(f"Run already complete at step {total_steps} "
                              f"(num_iter={cfg.num_iter}); nothing to do."))
            return self.state

        # resume into the right epoch: skip the epochs the restored step
        # completed, and advance the loader's epoch counter so that its
        # shuffles are not replayed from epoch 0
        done_epochs = 0
        try:
            spe = len(self.dataloader)
            if spe > 0:
                done_epochs = total_steps // spe
        except TypeError:
            pass  # sized loaders only; unsized ones restart at epoch 0
        if done_epochs and hasattr(self.dataloader, "_epoch"):
            self.dataloader._epoch = done_epochs

        loop_start = time.perf_counter()
        cycles = 0
        for epoch in range(cfg.num_pretrain_epochs + done_epochs,
                           cfg.num_epochs):
            epoch_iter = 0
            for batch in self._batches():
                with span("trainer.prep"):
                    db = prepare_batch(batch, cfg.use_scops, cfg.use_texture)
                    # the lag holds while batch shapes are stable
                    cur_real = db["real_imgs"]
                    if (self._lagged_real is not None
                            and self._lagged_real.shape == cur_real.shape):
                        db["real_imgs"] = self._lagged_real
                    self._lagged_real = cur_real
                with span("trainer.transfer"):
                    db, pinned = transfer(db, self.device)

                start = time.time()
                with span("trainer.dispatch"):
                    self.state, scalars = self.step_fn(
                        self.state, db, *self.extra_step_args(epoch))
                    queued = self._queue_scalars(scalars)
                dispatched += 1
                # drain the PREVIOUS step's scalars now that this one is
                # queued: the logged values are the same, one step late
                total_steps, smoothed = self._drain(total_steps, smoothed,
                                                    visualizer)
                self._pending = (list(scalars), queued, start, epoch,
                                 epoch_iter, pinned, db)
                epoch_iter += 1
                cycles += 1
                if cycles == 2 and self._first_cycle_s is None:
                    # the first two cycles ~ warm-up (cuDNN, allocator)
                    self._first_cycle_s = time.perf_counter() - loop_start

                if cfg.num_iter and dispatched >= cfg.num_iter:
                    total_steps, smoothed = self._drain(
                        total_steps, smoothed, visualizer)
                    self.save("latest")
                    return self.state

            if self.on_epoch_end is not None:
                # drain first: on_epoch_end may change the state (stage
                # 1's template update)
                total_steps, smoothed = self._drain(total_steps, smoothed,
                                                    visualizer)
                with span("trainer.epoch_end"):
                    self.state = (self.on_epoch_end(self.state, epoch)
                                  or self.state)

            if (epoch + 1) % cfg.save_epoch_freq == 0:
                total_steps, smoothed = self._drain(total_steps, smoothed,
                                                    visualizer)
                self.save("latest")
                self.save(epoch + 1)

        total_steps, smoothed = self._drain(total_steps, smoothed, visualizer)
        self.save("latest")
        return self.state

    def _batches(self):
        """The loader's batches, each waited for inside "trainer.loader"
        (the epoch's iterator is made there too)."""
        it = None
        while True:
            with span("trainer.loader"):
                if it is None:
                    it = iter(self.dataloader)
                batch = next(it, _END)
            if batch is _END:
                return
            yield batch

    def _drain(self, total_steps, smoothed, visualizer):
        """Read back the pending step's scalars (waiting for that step
        alone) and run the print and save cadences for it."""
        if self._pending is None:
            return total_steps, smoothed
        cfg = self.cfg
        names, (values, event), start, epoch, epoch_iter, _, db = (
            self._pending)
        self._pending = None
        with span("trainer.drain"):
            if event is not None:
                event.synchronize()
            sc = dict(zip(names, values.tolist()))
        sc["iter_time"] = time.time() - start
        self.history.append(sc)
        smoothed = smoothed * 0.99 + 0.01 * sc["total_loss"]
        total_steps += 1

        if (self.writer and cfg.print_scalars
                and total_steps % cfg.print_freq == 0):
            visualizer.print_current_scalars(
                epoch, epoch_iter + 1,
                {"smoothed_total_loss": smoothed, **sc})

        if (self.writer and cfg.display_visuals
                and self.visuals_fn is not None
                and cfg.display_freq > 0      # <= 0: never
                and total_steps % cfg.display_freq == 0):
            with span("trainer.vis"):
                save_visuals(self.visuals_fn(self.state, db), self.vis_out)
            self._print(green(f"Visualization saved at {self.vis_out}."))

        if total_steps % cfg.save_latest_freq == 0:
            self._print(green(f"saving the model at epoch {epoch}, "
                              f"iters {total_steps}"))
            self.save("latest", export_pth=False)
        return total_steps, smoothed
