"""One run of one cell of the benchmark of umr_tpu_torch: the cell's
configuration and traffic by name (BENCHMARK.json, configs/, traffic/),
its inputs from the seed, the program's training entry point driven over
a loader that opens and closes the measured window, the end-to-end
metrics (--trace 0) or the per-layer metrics (--trace 1, metrics/), and
the comparison with the plain reference that decides `correct`.

The window. The loader hands out warm-up batches first (the comparison's
snapshots are taken among them), then, before the first measured batch,
waits for the device and starts the clock. Every later hand-out is
timed; at the first request past the window's length it waits for the
device again, stops the clock and ends the epoch, so work still queued is
counted and the trainer's final drain and checkpoint fall outside.
Each step cycle is the time from one hand-out to the next (the last to
the closing wait).

With --trace 1 the window holds, in order: an untraced stretch (its
step time feeds step_mfu), a stretch of TRACE_STEPS steps traced with
the device's activity alone (busy and idle time: the profiler records no
host operation there, which would slow the host-bound step), a stretch
of TRACE_STEPS steps traced with the host's operations too (the device
time by range and by kernel, the renders, the idle gaps by host
activity), a stretch of SYNC_STEPS steps under
torch.cuda.set_sync_debug_mode("warn") (the host syncs), and untraced
steps to the end.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import os
import shutil
import sys
import tempfile
import time
import warnings
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from . import compare, data, traceutil, workcount
from .reference import raster as ref_raster

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "umr_tpu")
TRACE_STEPS = 8
SYNC_STEPS = 3
UNTRACED_SHARE = 0.4      # of the window, before the profiled stretch


class CellError(RuntimeError):
    """The run cannot give a result (no card, a missing file)."""


def forbidden_modules():
    """Loaded modules whose top-level name is the JAX stack's or the JAX
    package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def load_cell(workload, root=ROOT):
    """(the workload entry, its configuration file, its traffic file, the
    BENCHMARK.json entries of its metrics)."""
    with open(root / "BENCHMARK.json") as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise CellError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    with open(BENCH_DIR / "configs" / f"{cell['config']}.json") as f:
        config = json.load(f)
    with open(BENCH_DIR / "traffic" / f"{cell['traffic']}.json") as f:
        traffic = json.load(f)
    per_layer = [m for m in bench["per_layer"]
                 if workload in m.get("workloads", [workload])]
    end_to_end = [m for m in bench["end_to_end"]
                  if workload in m.get("workloads", [workload])]
    return cell, config, traffic, end_to_end, per_layer


def p95(values):
    """The 95th percentile of all values, linear between order
    statistics."""
    return float(np.percentile(np.asarray(values, np.float64), 95))


class WindowLoader:
    """The batch pool cycled as one epoch that the window ends. hooks:
    {batch index: fn()} called (warm-up only) before that batch is handed
    out, when every earlier step has been dispatched. phase: the traced
    run's stretches (TracePhases)."""

    def __init__(self, pool, warmup, seconds, length, sync, hooks,
                 phase=None):
        self.pool, self.warmup, self.seconds = pool, warmup, seconds
        self.length, self.sync, self.hooks = length, sync, hooks
        self.phase = phase
        self.handouts, self.t0, self.t_end = [], None, None
        self.t_first = self.stat0 = self.stat1 = None

    def __len__(self):
        return self.length

    def __iter__(self):
        i = 0
        while True:
            if i < self.warmup:
                if i == 0:
                    self.t_first = time.perf_counter()
                if i in self.hooks:
                    self.hooks[i]()
            elif i == self.warmup:
                self.sync()
                if self.phase is not None:
                    self.phase.open()
                self.stat0 = host_stat()
                self.t0 = time.perf_counter()
                self.handouts.append(self.t0)
            else:
                now = time.perf_counter()
                if now - self.t0 >= self.seconds:
                    if self.phase is not None:
                        self.phase.before_close(i - self.warmup)
                    self.sync()
                    self.t_end = time.perf_counter()
                    self.stat1 = host_stat()
                    return
                if self.phase is not None:
                    self.phase.step(i - self.warmup, now - self.t0)
                self.handouts.append(time.perf_counter())
            yield self.pool[i % len(self.pool)]
            i += 1

    def cycles(self):
        return np.diff(np.asarray(self.handouts + [self.t_end]))


class RenderRecorder:
    """Records the geometry of every rasterizer launch while on: the
    program's forward and backward launchers, wrapped."""

    def __init__(self, raster_kernel):
        self.mod = raster_kernel
        self.on = False
        self.fwd, self.bwd = [], []
        self.saved = launch_fwd, launch_bwd = (raster_kernel._launch_fwd,
                                               raster_kernel.raster_bwd)

        def fwd(fv, tex, bins, S, bg, sigma_val, dist_eps, gamma_val,
                mf_cap, hard, mask_only, need_p2f=False):
            if self.on:
                self.fwd.append(dict(fv=fv.detach().clone(), S=S,
                                     T2=tex.shape[2], sigma=sigma_val,
                                     dist_eps=dist_eps, hard=bool(hard),
                                     mask_only=bool(mask_only),
                                     need_p2f=bool(need_p2f)))
            return launch_fwd(fv, tex, bins, S, bg, sigma_val, dist_eps,
                              gamma_val, mf_cap, hard, mask_only, need_p2f)

        def bwd(fv, tex, bins, rgba, aggr, g_rgba, S, sigma_val, dist_eps,
                gamma_val, mf_cap, mask_only=False, rgb_geom_detach=False,
                tex_grads=True):
            if self.on and fv.is_cuda:
                self.bwd.append(dict(
                    fv=fv.detach().clone(), S=S, T2=tex.shape[2],
                    sigma=sigma_val, dist_eps=dist_eps,
                    want_tex=bool(tex_grads and not mask_only),
                    want_z=not (mask_only or rgb_geom_detach)))
            return launch_bwd(fv, tex, bins, rgba, aggr, g_rgba, S,
                              sigma_val, dist_eps, gamma_val, mf_cap,
                              mask_only, rgb_geom_detach, tex_grads)

        raster_kernel._launch_fwd = fwd
        raster_kernel.raster_bwd = bwd

    def uninstall(self):
        self.mod._launch_fwd, self.mod.raster_bwd = self.saved

    def work(self):
        """{"fwd"|"bwd": (least seconds, operations, what bounds most of
        the least time)} over the recorded renders."""
        out = {}
        for kind, recs in (("fwd", self.fwd), ("bwd", self.bwd)):
            least = ops_sum = 0.0
            by = {"operations": 0.0, "bytes": 0.0}
            for r in recs:
                counts = ref_raster.pair_counts(r["fv"], r["S"], r["sigma"],
                                                r["dist_eps"])
                B, F = r["fv"].shape[:2]
                if kind == "fwd":
                    ops, nb = workcount.render_work(
                        counts, B, r["S"], F, r["T2"], hard=r["hard"],
                        mask_only=r["mask_only"], need_p2f=r["need_p2f"])
                else:
                    ops, nb = workcount.render_work(
                        counts, B, r["S"], F, r["T2"],
                        backward=(r["want_tex"], r["want_z"]))
                t, bound_by = workcount.least_seconds(ops, nb)
                least += t
                by[bound_by] += t
                ops_sum += ops
            out[kind] = (least, ops_sum,
                         max(by, key=by.get) if recs else None)
        return out


class TracePhases:
    """The traced run's stretches inside the window (module doc)."""

    def __init__(self, seconds, sync, recorder, tmp_dir):
        self.seconds, self.sync, self.recorder = seconds, sync, recorder
        self.tmp_dir = tmp_dir
        self.state = "untraced"
        self.prof = None
        self.untraced = None            # (steps, seconds)
        self.device = None              # (steps, seconds, device events)
        self.trace_t = None             # host seconds of the host profile
        self.events = None
        self.sync_ctx = self.caught = None
        self.k0 = self.t_k0 = None
        self.syncs = None
        self.trace_steps = self.sync_steps = 0
        self.t_mark = None

    def open(self):
        self.t_mark = time.perf_counter()

    def _profile(self, k, activities):
        from torch.profiler import profile

        self.sync()
        self.prof = profile(activities=activities)
        self.prof.start()
        self.k0, self.t_k0 = k, time.perf_counter()

    def _stop(self, k):
        """(steps, host seconds, events) of the profile that ends here."""
        self.sync()
        seconds = time.perf_counter() - self.t_k0
        self.prof.stop()
        events = traceutil.export_events(self.prof, self.tmp_dir)
        self.prof = None
        return k - self.k0, seconds, events

    def _start_device(self, k):
        from torch.profiler import ProfilerActivity

        self.sync()
        self.untraced = (k, time.perf_counter() - self.t_mark)
        self._profile(k, [ProfilerActivity.CUDA])

    def _start_host(self, k):
        from torch.profiler import ProfilerActivity

        self.device = self._stop(k)
        self._profile(k, [ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.recorder.on = True

    def _stop_host(self, k):
        self.recorder.on = False
        self.trace_steps, self.trace_t, self.events = self._stop(k)

    def _start_sync(self, k):
        self.sync_ctx = warnings.catch_warnings(record=True)
        self.caught = self.sync_ctx.__enter__()
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        self.k0 = k

    def _stop_sync(self, k):
        torch.cuda.set_sync_debug_mode("default")
        self.sync_ctx.__exit__(None, None, None)
        self.sync_steps = k - self.k0
        self.syncs = sum("called a synchronizing CUDA operation"
                         in str(w.message) for w in self.caught)

    def step(self, k, elapsed):
        """Before the hand-out of the window's k-th batch (k >= 1)."""
        if (self.state == "untraced"
                and elapsed >= UNTRACED_SHARE * self.seconds):
            self._start_device(k)
            self.state = "device"
        elif self.state == "device" and k - self.k0 >= TRACE_STEPS:
            self._start_host(k)
            self.state = "host"
        elif self.state == "host" and k - self.k0 >= TRACE_STEPS:
            self._stop_host(k)
            self._start_sync(k)
            self.state = "sync"
        elif self.state == "sync" and k - self.k0 >= SYNC_STEPS:
            self._stop_sync(k)
            self.state = "done"

    def before_close(self, k):
        if self.state == "device":
            self.device = self._stop(k)
        elif self.state == "host":
            self._stop_host(k)
        elif self.state == "sync":
            self._stop_sync(k)
        self.state = "closed"


def load_metric(name):
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def program_config(config, traffic, seed, tmp):
    """The program's Config of this cell: the configuration's numbers, the
    traffic's batch and epoch, the run's seed, files under tmp."""
    from umr_tpu_torch.config import Config

    fields = dict(config["program"])
    epoch = traffic["epoch"]
    fields.update(
        batch_size=traffic["batch_size"], seed=int(seed),
        num_pretrain_epochs=epoch, num_epochs=epoch + 1,
        display_visuals=traffic["display_visuals"], data_parallel=False,
        checkpoint_dir=os.path.join(tmp, "snapshots"),
        vis_dir=os.path.join(tmp, "visualization"), name="bench")
    return Config(**fields).sync_image_size()


def host_stat():
    """(the machine's CPU time by kind from /proc/stat, in clock ticks;
    this process's CPU seconds), or None where /proc/stat is unreadable."""
    try:
        with open("/proc/stat") as f:
            ticks = [int(x) for x in f.readline().split()[1:9]]
    except (OSError, ValueError):
        return None
    t = os.times()
    return ticks, t.user + t.system


def host_notes(stat0, stat1, seconds, cycles):
    """What the host did over the window: the share of the machine's CPU
    time taken by the hypervisor (steal) and spent waiting on I/O, the
    cores busy with this process and with anything else, and the spread
    of the step cycles (their standard error, as a share of their mean,
    is what the window's length buys)."""
    out = {"cpus": os.cpu_count(),
           "affinity": len(os.sched_getaffinity(0)),
           "cycle_mean_ms": float(np.mean(cycles) * 1e3),
           "cycle_sd_ms": float(np.std(cycles) * 1e3),
           "cycle_sem_pct": float(100 * np.std(cycles) / np.mean(cycles)
                                  / math.sqrt(len(cycles)))}
    if stat0 is None or stat1 is None:
        return out
    hz = os.sysconf("SC_CLK_TCK")
    d = [b - a for a, b in zip(stat0[0], stat1[0])]
    total = max(sum(d), 1)
    user, nice, system, idle, iowait, irq, softirq, steal = d
    ours = (stat1[1] - stat0[1]) * hz
    busy = user + nice + system + irq + softirq
    out.update(steal_pct=100.0 * steal / total,
               iowait_pct=100.0 * iowait / total,
               ours_cores=ours / hz / seconds,
               others_cores=max(busy - ours, 0) / hz / seconds)
    return out


class Harness:
    """One run of a cell on one card (device "cuda"): it drives the entry
    point, measures and compares; the tests drive it on "cpu" at small
    sizes."""

    def __init__(self, workload, seed, seconds, trace, device="cuda",
                 overrides=None, root=ROOT, t_start=None):
        self.t_start = time.perf_counter() if t_start is None else t_start
        (self.cell, self.config, self.traffic, self.e2e,
         self.per_layer) = load_cell(workload, root)
        self.config = dict(self.config,
                           program=dict(self.config["program"],
                                        **(overrides or {}).get("program",
                                                                {})))
        self.traffic = dict(self.traffic, **(overrides or {}).get("traffic",
                                                                  {}))
        self.workload, self.seed = workload, int(seed)
        self.seconds, self.trace = float(seconds), bool(trace)
        self.device = torch.device(device)
        self.stage = self.config["stage"]
        self.weights_dir = str(root / "weights")
        self.warmup = self.traffic["warmup_steps"]
        self.pool = self.ref_pool = None
        self.host = self.trace_notes = None

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ---- inputs ---------------------------------------------------------

    def make_pool(self, n=None):
        """Batches of the seed (batch i from stream (seed, 1, i)). Stage
        1's leave out the part fields, which it does not read."""
        p = self.config["program"]
        n = self.traffic["pool"] if n is None else n
        pool = data.pool(self.seed, n, self.traffic["batch_size"],
                         p["image_size"])
        if self.stage == 1:
            keep = ("img", "mask", "dts_barrier")
            pool = [{k: b[k] for k in keep} for b in pool]
        return pool

    def reference_batches(self):
        """The first three batches, which the reference steps on."""
        if self.ref_pool is None:
            self.ref_pool = (self.make_pool(3) if self.pool is None
                             else self.pool[:3])
        return self.ref_pool

    def _num_verts(self):
        from .reference.template import build_template
        p = self.config["program"]
        return build_template(p["subdivide"], p["axis"],
                              p["tex_size"]).num_verts

    # ---- the program ---------------------------------------------------

    def _snapshots(self, holder, snap):
        """Hooks that read the program's state among the warm-up steps:
        its parameters before the first step, its first gradient from
        Adam's first moment after step 1, its change after step 3."""
        beta1 = self.config["program"]["beta1"]

        def params():
            st = holder[0].state
            return ([(f"model.{n}", p) for n, p in
                     st.model.named_parameters()]
                    + [(f"disc.{n}", p) for n, p in
                       st.disc.named_parameters()])

        def before_first():
            snap["start"] = {n: p.detach().cpu().clone()
                             for n, p in params()}

        def after_one():
            self.sync()
            opt = holder[0].state.optimizer
            snap["grad1"] = {
                n: (float(opt.state[p]["exp_avg"].norm()) / (1 - beta1)
                    if p in opt.state else 0.0) for n, p in params()}

        def after_three():
            self.sync()
            start = snap.pop("start")
            snap["change"] = {n: p.detach().cpu() - start[n]
                              for n, p in params()}
            snap["delta"] = {n: float(c.norm())
                             for n, c in snap["change"].items()}

        return {0: before_first, 1: after_one, 3: after_three}

    def run_program(self, tmp):
        """Drive the entry point over the window; returns (loader, phases,
        recorder, the program's readings, every step's loss)."""
        from umr_tpu_torch.experiments import train_s1, train_s2
        from umr_tpu_torch.ops import raster_kernel

        entry = train_s2 if self.traffic["entry"] == "train_s2" else train_s1
        holder, snap = [], {}

        class Captured(entry.Trainer):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                holder.append(self)

        cfg = program_config(self.config, self.traffic, self.seed, tmp)
        t = time.perf_counter()
        pool = self.pool = self.make_pool()
        self.setup_parts = {"imports": t - self.t_start,
                            "pool": time.perf_counter() - t}
        recorder = phases = None
        if self.trace:
            recorder = RenderRecorder(raster_kernel)
            phases = TracePhases(self.seconds, self.sync, recorder, tmp)
        loader = WindowLoader(pool, self.warmup, self.seconds,
                              self.traffic["epoch_batches"], self.sync,
                              self._snapshots(holder, snap), phases)
        os.environ["UMR_TPU_NO_AUTORESUME"] = "1"
        saved = entry.Trainer
        entry.Trainer = Captured
        try:
            if self.stage == 2:
                semantic = (None,) + data.semantic_template(
                    self.seed, self._num_verts())
                entry.run(cfg, dataloader=loader, device=self.device,
                          semantic=semantic)
            else:
                entry.run(cfg, dataloader=loader, device=self.device)
        finally:
            entry.Trainer = saved
            if recorder is not None:
                recorder.uninstall()
        trainer = holder[0]
        snap["loss"] = [h["total_loss"] for h in trainer.history[:3]]
        losses = [h["total_loss"] for h in trainer.history]
        return loader, phases, recorder, snap, losses

    # ---- the whole run ------------------------------------------------

    def run(self):
        """The run on this process's device; returns the result dict."""
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        tmp = tempfile.mkdtemp(prefix="umr_bench_")
        try:
            loader, phases, recorder, prog, losses = self.run_program(tmp)
            peak = (torch.cuda.max_memory_allocated(self.device)
                    if self.device.type == "cuda" else 0)
            metrics = ctx = None
            if self.trace:
                ctx = self._trace_context(phases, recorder)
                metrics = {}
                for m in self.per_layer:
                    v = load_metric(m["name"]).read(ctx)
                    if v is not None:
                        metrics[m["name"]] = {"value": float(v),
                                              "unit": m["unit"]}
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        self.setup_parts.update(
            build=loader.t_first - self.t_start - sum(
                self.setup_parts.values()),
            warmup=loader.t0 - loader.t_first)
        found = forbidden_modules()
        if found:
            raise CellError("loaded after the window: " + ", ".join(found))
        cycles = loader.cycles()
        steps = len(cycles)
        window = loader.t_end - loader.t0
        self.host = host_notes(loader.stat0, loader.stat1, window, cycles)
        failed = sum(not math.isfinite(v) for v in losses[self.warmup:])
        device = {"platform": "gpu" if self.device.type == "cuda"
                  else self.device.type,
                  "kind": (torch.cuda.get_device_name(self.device)
                           if self.device.type == "cuda" else "cpu"),
                  "count": self.cell["chips"],
                  "memory_peak_bytes": int(peak)}
        result = {"correct": False, "attempted": steps, "failed": failed,
                  "metrics": {}, "device": device}
        if not self.trace:
            values = {"images_per_s": steps * self.traffic["batch_size"]
                      / window,
                      "step_ms_p95": p95(cycles) * 1e3,
                      "peak_mem_gib": peak / 2 ** 30,
                      "setup_s": loader.t0 - self.t_start}
            for m in self.e2e:
                result["metrics"][m["name"]] = {"value": values[m["name"]],
                                                "unit": m["unit"]}
        else:
            result["metrics"] = metrics
            device["busy_s"] = ctx.busy_us / 1e6
            device["window_s"] = ctx.window_us / 1e6
            result["breakdown"] = {
                "device_ops": [[n, us / 1e6] for n, us in
                               traceutil.by_name(ctx.kernel_ops)],
                "idle_gaps": [[n, us / 1e6] for n, us in
                              traceutil.idle_gaps(ctx.host_ops, ctx.events,
                                                  ctx.h_lo, ctx.h_hi)]}
            self.trace_notes = ctx.notes
        # the program's state is gone with the entry point's return;
        # collect it before the reference runs on the same card
        del loader, phases, recorder, ctx
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        ref = self.reference_readings()
        checks = compare.checks(prog, ref, self.traffic["limits"])
        self.noisy = compare.noisy_readings(prog, ref)
        result["correct"] = bool(failed == 0 and all(
            c["value"] <= c["limit"] for c in checks.values()))
        result["checks"] = checks
        return result

    def reference_readings(self, tf32=False):
        """The plain reference's readings of the run's first three steps,
        from the seed and the pool's first batches."""
        from .reference import step as ref_step

        semantic = None
        if self.stage == 2:
            semantic = data.semantic_template(self.seed, self._num_verts())
        batches = self.reference_batches()
        prev = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            return ref_step.readings(
                self.config["program"], self.stage, self.seed, batches,
                float(self.traffic["epoch"]), self.device,
                self.weights_dir, semantic)
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = prev

    def _trace_context(self, phases, recorder):
        """What the per-layer readers read (metrics/*.py): the device
        stretch's busy time and length, the host stretch's events."""
        from .reference.template import build_template

        d_steps, d_seconds, d_events = phases.device or (0, 0.0, [])
        d_ops = traceutil.device_ops(d_events)
        events = phases.events or []
        host_ops = traceutil.device_ops(events)
        kernel_ops = traceutil.device_ops(events, ("kernel",))
        steps = max(phases.trace_steps, 1)
        h_lo = min((float(e["ts"]) for e in events if "dur" in e),
                   default=0.0)
        h_hi = h_lo + (phases.trace_t or 0.0) * 1e6
        p = self.config["program"]
        t = build_template(p["subdivide"], p["axis"], p["tex_size"])
        flops = workcount.step_flops(p, self.stage,
                                     self.traffic["batch_size"],
                                     t.num_output, t.uv_image_size())
        work = recorder.work()
        flops["renders"] = (work["fwd"][1] + work["bwd"][1]) / steps
        untraced_steps, untraced_s = phases.untraced or (0, 0.0)
        untraced_step_s = (untraced_s / untraced_steps if untraced_steps
                           else None)
        least_s = {k: work[k][0] for k in work}
        kern_s = {k: sum(d for n, _, d in kernel_ops
                         if f"raster_{k}_kernel" in n) / 1e6
                  for k in ("fwd", "bwd")}
        busy = traceutil.busy_us(d_ops)
        notes = {"flops_per_step": flops,
                 "untraced_step_ms": untraced_step_s and untraced_step_s * 1e3,
                 "device_stretch_step_ms": (d_seconds / d_steps * 1e3
                                            if d_steps else None),
                 "host_stretch_step_ms": (phases.trace_t / steps * 1e3
                                          if phases.trace_t else None),
                 "device_busy_ms_per_step": (busy / d_steps / 1e3
                                             if d_steps else None),
                 "render_bound_by": {k: work[k][2] for k in work},
                 "raster_kernel_s": kern_s, "raster_least_s": least_s,
                 "trace_steps": phases.trace_steps,
                 "device_steps": d_steps, "syncs": phases.syncs,
                 "sync_steps": phases.sync_steps}
        prefix = "s2." if self.stage == 2 else "s1."
        return SimpleNamespace(
            prefix=prefix, events=events, host_ops=host_ops,
            kernel_ops=kernel_ops, device_ops=d_ops,
            range_ms=traceutil.range_split(events, prefix, steps),
            busy_us=busy, window_us=d_seconds * 1e6, h_lo=h_lo, h_hi=h_hi,
            busy_per_step_s=busy / d_steps / 1e6 if d_steps else None,
            syncs=phases.syncs, sync_steps=phases.sync_steps,
            untraced_step_s=untraced_step_s, flops_per_step=flops,
            peak_flops=workcount.PEAK_FLOPS, raster_least_s=least_s,
            raster_kernel_s=kern_s, notes=notes)


def check_lines(checks):
    return [f"check {name}: {c['value']:.6g} limit {c['limit']:.6g}"
            for name, c in checks.items()]


def main(args, t_start):
    """The command's run; returns the exit code."""
    if not torch.cuda.is_available():
        print("umr_bench: no CUDA device is visible", file=sys.stderr)
        return 2
    try:
        cell = load_cell(args.workload)[0]
    except (CellError, OSError, KeyError) as e:
        print(f"umr_bench: {e}", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"umr_bench: the cell asks for {cell['chips']} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    # the configuration states float32 with TF32 off
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    h = Harness(args.workload, args.seed, args.seconds, args.trace,
                t_start=t_start)
    try:
        result = h.run()
    except CellError as e:
        print(f"umr_bench: {e}", file=sys.stderr)
        return 1
    found = forbidden_modules()
    if found:
        print("umr_bench: loaded in this process: " + ", ".join(found),
              file=sys.stderr)
        return 1
    print("set-up s: " + json.dumps(h.setup_parts), file=sys.stderr)
    print("host: " + json.dumps(h.host), file=sys.stderr)
    print("readings not compared: " + json.dumps(h.noisy), file=sys.stderr)
    if h.trace:
        print("trace notes: " + json.dumps(h.trace_notes), file=sys.stderr)
    for line in check_lines(result["checks"]):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
