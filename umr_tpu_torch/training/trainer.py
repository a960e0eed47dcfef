"""The training loop (port of umr_tpu/training/trainer.py): epochs over
the dataloader, the loader's arrays taken to the model's device and
the batch prepared there (BatchPrep), the step, a one-step-lagged
scalar drain, the log and the print / save cadences, checkpoints with
auto-resume, and the stage budget.

Each phase of the step cycle is a span (tracing.py): "trainer.loader"
(the wait for the loader's batch), "trainer.transfer" (the loader's
arrays taken to the model's device: copied to the card, their bytes
counted as "trainer.h2d_bytes"; wrapped on the CPU), "trainer.prep"
(prepare_batch and the GAN's lag, on that device), "trainer.dispatch"
(the step call and the queueing of its scalars), "trainer.drain" (the
wait for a step's scalars), and "trainer.vis", "trainer.save" and
"trainer.epoch_end". stage_budget.json is read from those spans' totals
since the trainer began.

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


def step_keys(batch, use_scops=True, use_texture=True):
    """The loader's keys that the step reads under the flags: img and
    mask, dts_barrier with texture, part_prob and the four point sets
    with SCOPS parts."""
    keys = ["img", "mask"]
    if use_texture and "dts_barrier" in batch:
        keys.append("dts_barrier")
    if use_scops and "part_prob" in batch:
        keys += ["part_prob", "head_points", "belly_points", "neck_points",
                 "back_points"]
    return keys


def prepare_batch(batch, use_scops=True, use_texture=True, real_from=None):
    """Batch dict -> the step's input dict: normalised input images,
    masks, masked "real" images, and the barrier and part fields the
    losses read. Numpy entries give numpy; entries that are tensors (a
    device loader's batch) stay on their device and are normalised
    there. real_from: the float32 (img, mask) whose masked images are
    real_imgs (the GAN's lag, BatchPrep); by default the batch's own."""
    imgs = _f32(batch["img"])
    mask = _f32(batch["mask"])
    real_img, real_mask = (imgs, mask) if real_from is None else real_from
    out = {
        "img": imgs,
        "input_img": normalize_images(imgs),
        "mask": mask,
        "real_imgs": real_img * real_mask[..., None],
    }
    for k in step_keys(batch, use_scops, use_texture)[2:]:
        out[k] = _f32(batch[k])
    return out


def to_device(arrays, device):
    """(the arrays as tensors on `device`, the pinned host buffers their
    copies read). A numpy array is taken as it is (no cast): copied to
    the card from pinned memory without blocking (the buffers must live
    until the step is drained), wrapped in place on the CPU. A tensor
    already on `device` is taken as it is, one elsewhere moved with .to.
    The bytes copied from host memory to another device are counted as
    trainer.h2d_bytes."""
    out, pinned, nbytes = {}, [], 0
    for k, v in arrays.items():
        if torch.is_tensor(v):
            if v.device.type == "cpu" and device.type != "cpu":
                nbytes += v.nbytes
            out[k] = v.to(device)
            continue
        host = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            host = host.pin_memory()
            pinned.append(host)
            nbytes += v.nbytes
        out[k] = host.to(device, non_blocking=True)
    count("trainer.h2d_bytes", nbytes)
    return out, tuple(pinned)


class BatchPrep:
    """Loader batch -> (the step's batch on `device`, the pinned host
    buffers its copies read), the GAN's real images one batch behind:
    while batch shapes hold, real_imgs is made from the previous batch's
    img and mask, as the reference's random_imgs buffer (filled from the
    first batch, refreshed after each step; ref train_s2.py:183-184, 270).

    The loader's arrays that the flags keep are taken to the device as
    they are (to_device: copied to the card, wrapped on the CPU; a device
    loader's tensors are not copied again) and prepared there, so the
    previous batch's img and mask, and the lag made from them, stay on
    the device. Each batch counts one "trainer.prep_on_device"."""

    def __init__(self, use_scops=True, use_texture=True,
                 device=torch.device("cpu")):
        self.use_scops = use_scops
        self.use_texture = use_texture
        self.device = device
        self._prev = None       # the previous step batch's (img, mask)

    def __call__(self, batch):
        with span("trainer.transfer"):
            batch, pinned = to_device(
                {k: batch[k] for k in step_keys(
                    batch, self.use_scops, self.use_texture)},
                self.device)
        with span("trainer.prep"):
            prev = self._prev
            if prev is not None and (
                    (prev[0].shape, prev[1].shape)
                    != (batch["img"].shape, batch["mask"].shape)):
                prev = None
            db = prepare_batch(batch, self.use_scops, self.use_texture,
                               real_from=prev)
            self._prev = db["img"], db["mask"]
            count("trainer.prep_on_device", 1)
        return db, pinned


class Trainer:
    """Epochs over the dataloader, one step_fn(state, batch,
    *extra_step_args(epoch)) call per batch, stopping at cfg.num_iter when
    it is set; after each whole epoch, on_epoch_end(state, epoch) may
    return a new state (stage 1's template update). state is a
    training/steps.py::TrainState.

    The trainer takes the loader's arrays that the step reads to the
    model's device and prepares the batch there (BatchPrep): on the card
    it copies them from pinned memory without blocking (a device
    loader's tensors are not copied again), and reads a step's scalars
    back only after it has dispatched the next step (their copy to the
    host is queued behind the step that made them), so host work can
    overlap the card's.

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
        self._prep = BatchPrep(cfg.use_scops, cfg.use_texture, self.device)
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
                db, pinned = self._prep(batch)

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
