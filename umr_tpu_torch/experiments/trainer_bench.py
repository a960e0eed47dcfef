"""Times Trainer.train's steps per second at bench.py's stage-2
configuration (batch 16, 8 camera hypotheses, 256^2 with 512^2
anti-aliased renders, F=1280, T2=36) for one or more checkouts of the
package, in turns on one card, and lists the host syncs left in the
trainer's step cycle.

  python -m umr_tpu_torch.experiments.trainer_bench \\
      --root parent=/path/to/parent --root change=. \\
      --order parent,change,change,parent --out trainer.json

Each --root NAME=DIR is a directory holding an umr_tpu_torch package
(this one, or an older commit's unpacked with `git archive`); each turn
runs in its own process with DIR first on sys.path. A turn builds the
stage-2 step from the seeded initialisation, makes a Trainer over a
loader of synthetic batches and trains WARMUP + STEPS steps; the rate is
STEPS over the time between the loader's handing out of batch WARMUP and
of batch WARMUP + STEPS (in the steady state one batch per step cycle,
whichever the trainer waits on). With --sync_debug the turn then trains
two more steps under torch.cuda.set_sync_debug_mode("warn") and counts
the synchronising calls by source line (the checkpoint save at the end
excluded). TF32 off.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import warnings

WARMUP = 2
STEPS = 10
N_DATA = 4          # distinct synthetic batches, cycled


class _TimedLoader:
    """n batches cycled from `batches`, the time each is handed out."""

    def __init__(self, batches, n):
        self.batches, self.n, self.times = batches, n, []

    def __len__(self):
        return self.n

    def __iter__(self):
        for i in range(self.n):
            self.times.append(time.perf_counter())
            yield self.batches[i % len(self.batches)]


def turn(sync_debug=False):
    """One turn in this process, with the umr_tpu_torch first on
    sys.path: the steady rate, and the sync calls when asked."""
    import numpy as np
    import torch

    from umr_tpu_torch.config import Config
    from umr_tpu_torch.data import synthetic_batch
    from umr_tpu_torch.experiments.raster_bench import synthetic_semantic
    from umr_tpu_torch.losses.composite import PartMatchingLoss
    from umr_tpu_torch.mesh import build_template
    from umr_tpu_torch.renderer import SoftRenderer
    from umr_tpu_torch.training.trainer import Trainer
    from umr_tpu_torch.training.steps import build_s2_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    n = WARMUP + STEPS
    cfg = Config(batch_size=16, image_size=256, subdivide=3, tex_size=6,
                 num_hypo_cams=8, num_iter=n, print_scalars=False,
                 checkpoint_dir=tempfile.mkdtemp()).sync_image_size()
    template = build_template(cfg.subdivide, cfg.axis, cfg.tex_size)
    seg, pvi = synthetic_semantic(template)
    part_loss = PartMatchingLoss.build(
        seg, template.uv_sampler, template.num_sym_faces,
        SoftRenderer(image_size=cfg.image_size).ambient_light_only(),
        tex_size=cfg.tex_size, device=dev)
    _, _, _, init_fn, step_fn = build_s2_step(cfg, template, part_loss, pvi,
                                              dev)
    rng = np.random.RandomState(0)
    batches = [synthetic_batch(rng, cfg.batch_size, cfg.image_size)
               for _ in range(N_DATA)]
    loader = _TimedLoader(batches, n)
    trainer = Trainer(cfg, step_fn, init_fn(cfg.seed), loader)
    trainer.train()
    torch.cuda.synchronize()
    t = loader.times
    out = {"steps_per_s": STEPS / (t[WARMUP + STEPS - 1] - t[WARMUP - 1]),
           "steps": STEPS, "warmup": WARMUP, "batch": cfg.batch_size,
           "gpu": torch.cuda.get_device_name(0)}
    budget = getattr(trainer, "_budget", None)    # trainers that keep one
    if budget:
        out["budget_s_per_step"] = {k: v / trainer._budget_n
                                    for k, v in budget.items()}
    if sync_debug:
        out["syncs"] = sync_calls(trainer, cfg, loader, n)
    return out


def sync_calls(trainer, cfg, loader, n):
    """Two more steps under sync debug "warn": {file:line: count} of the
    synchronising calls, the checkpoint save excluded."""
    import torch

    save = trainer.save

    def quiet_save(*args, **kw):
        torch.cuda.set_sync_debug_mode("default")
        return save(*args, **kw)

    trainer.save = quiet_save
    trainer.cfg = cfg.replace(num_iter=n + 2)
    loader.n = n + 2
    counts = {}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            trainer.train()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    for w in caught:
        if "called a synchronizing CUDA operation" in str(w.message):
            where = (f"{os.path.relpath(w.filename)}:{w.lineno}: "
                     f"{str(w.message).splitlines()[0][:80]}")
            counts[where] = counts.get(where, 0) + 1
    return counts


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--root", action="append", default=[],
                   help="NAME=DIR of a directory holding umr_tpu_torch")
    p.add_argument("--order", default=None,
                   help="comma-separated NAMEs, the turns' order")
    p.add_argument("--sync_debug", default=None,
                   help="NAME whose last turn also lists host syncs")
    p.add_argument("--out", default=None)
    p.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.worker is not None:              # one turn, this process
        root, debug = args.worker.rsplit(":", 1)
        sys.path.insert(0, os.path.abspath(root))
        print("TURN " + json.dumps(turn(sync_debug=debug == "1")),
              flush=True)
        return
    roots = dict(r.split("=", 1) for r in args.root)
    order = (args.order or ",".join(roots)).split(",")
    last = {name: i for i, name in enumerate(order)}
    runs = []
    for i, name in enumerate(order):
        debug = name == args.sync_debug and last[name] == i
        env = dict(os.environ, PYTHONPATH=os.path.abspath(roots[name]))
        res = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker",
             f"{roots[name]}:{int(debug)}"], env=env, capture_output=True,
            text=True, cwd=os.path.abspath(roots[name]))
        line = [s for s in res.stdout.splitlines() if s.startswith("TURN ")]
        if res.returncode or not line:
            raise SystemExit(f"turn {name} failed:\n{res.stderr[-4000:]}")
        rec = dict(json.loads(line[-1][5:]), name=name, turn=i)
        runs.append(rec)
        print(f"turn {i} {name}: {rec['steps_per_s']:.3f} steps/s "
              f"({1e3 / rec['steps_per_s']:.2f} ms per step cycle, "
              f"{STEPS} steps after {WARMUP}) [{rec['gpu']}]", flush=True)
        if "budget_s_per_step" in rec:
            print("  the trainer's budget, ms per step: " + ", ".join(
                f"{k} {1e3 * v:.2f}"
                for k, v in rec["budget_s_per_step"].items()), flush=True)
        for where, c in sorted(rec.get("syncs", {}).items()):
            print(f"  sync x{c}: {where}", flush=True)
    summary = {name: [r["steps_per_s"] for r in runs if r["name"] == name]
               for name in roots}
    print("steps/s by tree: " + json.dumps(summary), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"runs": runs, "steps_per_s": summary}, f, indent=1)


if __name__ == "__main__":
    main()
