"""The program's spans and counters (umr_tpu_torch/tracing.py) read over a
run of a cell: one run of the benchmark's harness whose traced stretches
also snapshot the spans' totals and keep their records.

  python3 umr_bench/spans.py --workload s2_train --seed 1234 --seconds 40 \
      --trace 1
  python3 umr_bench/spans.py --workload s2_train --seed 1234 --seconds 40 \
      --trace 0 --record 1

prints the harness's result line, then "spans: " and one JSON object.
With --trace 1 it holds, per step:

  trainer.{prep,transfer,dispatch,drain}_ms  host ms in each trainer span
      over the untraced stretch (totals() at the window's opening and at
      the stretch's end)
  device.idle_{before,in}_dispatch_ms  the device stretch (CUDA activity
      alone): the device's idle intervals (the complement of the union of
      its operations) split by how long each overlaps the records of
      trainer.loader, .prep and .transfer, or of trainer.dispatch, mapped
      onto the trace's clock with its baseTimeNanoseconds

and under "notes" what checks them: the loader's ms, the idle time that
overlaps trainer.drain, another trainer span or none, the stretch's idle
time a step, the host stretch's gaps between each record's start and its
own profiler range's ts (the clock check), and the sync stretch's host
syncs by file:line and innermost open span (syncs_by_site). With --trace
0 --record 1 recording is on through the run: its cost against --record
0 on the same seeds.

The harness itself is not changed: its traced stretches are subclassed
here (SpanPhases).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import warnings  # noqa: E402

if __name__ == "__main__":
    # as run.py: few threads, set before numpy and torch load
    for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS",
                 "OPENBLAS_NUM_THREADS"):
        os.environ[_var] = "2"

import numpy as np  # noqa: E402

# idle time by the top-level trainer span it overlaps (the spans of one
# step cycle follow each other: none overlaps another)
IDLE_GROUPS = {"trainer.loader": "before_dispatch",
               "trainer.prep": "before_dispatch",
               "trainer.transfer": "before_dispatch",
               "trainer.dispatch": "in_dispatch",
               "trainer.drain": "drain",
               "trainer.vis": "other_trainer",
               "trainer.save": "other_trainer",
               "trainer.epoch_end": "other_trainer"}
HOST_PHASES = ("prep", "transfer", "dispatch", "drain")


def export(prof, tmp_dir=None):
    """(the Chrome trace events of a finished torch.profiler.profile, its
    baseTimeNanoseconds in microseconds: 0 where the trace has none)."""
    with tempfile.TemporaryDirectory(dir=tmp_dir) as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    return trace["traceEvents"], trace.get("baseTimeNanoseconds", 0) / 1e3


def idle_intervals(ops, lo, hi):
    """[(start, end)] of [lo, hi] in which no operation (name, ts, dur)
    runs."""
    out, reach = [], lo
    for _, ts, dur in sorted(ops, key=lambda o: o[1]):
        if reach >= hi:
            break
        if ts > reach:
            out.append((reach, min(ts, hi)))
        reach = max(reach, ts + dur)
    if reach < hi:
        out.append((reach, hi))
    return [(a, b) for a, b in out if b > a]


def idle_split(idle, records, groups=None, offset_us=0.0):
    """{group: microseconds}: each idle interval's overlap with each record
    (name, parent, start, end) whose name `groups` maps, the records moved
    by -offset_us onto the intervals' clock; what overlaps none under
    None. The grouped records must not overlap each other."""
    groups = IDLE_GROUPS if groups is None else groups
    iv = np.asarray(idle, np.float64).reshape(-1, 2)
    out = dict.fromkeys(groups.values(), 0.0)
    for name, _, start, end in records:
        g = groups.get(name)
        if g is None:
            continue
        lo, hi = start - offset_us, end - offset_us
        out[g] += float(np.clip(np.minimum(iv[:, 1], hi)
                                - np.maximum(iv[:, 0], lo), 0, None).sum())
    out[None] = float((iv[:, 1] - iv[:, 0]).sum()) - sum(out.values())
    return out


def clock_gaps(records, events, offset_us):
    """|record start - offset_us - ts| of each record against the nearest
    profiler range of its name in `events`, microseconds."""
    ts = {}
    for e in events:
        if e.get("cat") == "user_annotation":
            ts.setdefault(e["name"], []).append(float(e["ts"]))
    ts = {k: np.sort(v) for k, v in ts.items()}
    gaps = []
    for name, _, start, _ in records:
        a = ts.get(name)
        if a is None:
            continue
        t = start - offset_us
        j = np.searchsorted(a, t)
        gaps.append(min(abs(a[i] - t) for i in (j - 1, j)
                        if 0 <= i < len(a)))
    return gaps


def _subclassed_phases(harness, tracing):
    class SpanPhases(harness.TracePhases):
        """The harness's stretches, with the spans' totals at the window's
        opening and at the untraced stretch's end, their records over the
        device and the host stretches, each profile's base time and its
        first and last wall-clock microseconds, and the sync stretch's
        sites."""

        def open(self):
            super().open()
            self.t_open = tracing.totals()
            self.t_untraced = None
            self.records, self.spans, self.sites = {}, {}, {}

        def _profile(self, k, activities):
            super()._profile(k, activities)
            self.wall0 = time.time_ns() / 1e3

        def _stop(self, k):
            """The harness's _stop, keeping the trace's base time and the
            profile's wall-clock span."""
            self.sync()
            seconds = time.perf_counter() - self.t_k0
            wall1 = time.time_ns() / 1e3
            self.prof.stop()
            events, base = export(self.prof, self.tmp_dir)
            self.prof = None
            self.spans[self.state] = (base, self.wall0, wall1)
            return k - self.k0, seconds, events

        def _start_device(self, k):
            super()._start_device(k)
            self.t_untraced = tracing.totals()
            tracing.start_recording()

        def _start_host(self, k):
            self.records["device"] = tracing.stop_recording()
            super()._start_host(k)
            tracing.start_recording()

        def _stop_host(self, k):
            self.records["host"] = tracing.stop_recording()
            super()._stop_host(k)

        def _start_sync(self, k):
            super()._start_sync(k)
            log = warnings._showwarnmsg_impl        # the caught list's append

            def site(msg):
                if "called a synchronizing CUDA operation" in str(
                        msg.message):
                    key = (f"{os.path.relpath(msg.filename)}:{msg.lineno} "
                           f"in {tracing.current()}")
                    self.sites[key] = self.sites.get(key, 0) + 1
                log(msg)

            warnings._showwarnmsg_impl = site

        def before_close(self, k):
            if self.state in ("device", "host"):
                self.records[self.state] = tracing.stop_recording()
            super().before_close(k)

    return SpanPhases


def readings(phases, d_ops, host_events):
    """(metrics, notes) of a traced run's SpanPhases."""
    from umr_tpu_torch import tracing

    metrics, notes = {}, {}
    steps, seconds = phases.untraced or (0, 0.0)
    if steps and phases.t_untraced is not None:
        d = tracing.delta(phases.t_open, phases.t_untraced)
        ms = {k: 1e3 * d["seconds"].get(f"trainer.{k}", 0.0) / steps
              for k in HOST_PHASES + ("loader",)}
        for k in HOST_PHASES:
            metrics[f"trainer.{k}_ms"] = ms[k]
        notes.update(untraced_steps=steps,
                     untraced_step_ms=1e3 * seconds / steps,
                     loader_ms=ms["loader"],
                     host_phases_sum_ms=sum(ms.values()))
    if phases.device and "device" in phases.spans:
        d_steps = phases.device[0]
        base, wall0, wall1 = phases.spans["device"]
        idle = idle_intervals(d_ops, wall0 - base, wall1 - base)
        split = idle_split(idle, phases.records.get("device", []),
                           offset_us=base)
        metrics["device.idle_before_dispatch_ms"] = (
            split["before_dispatch"] / d_steps / 1e3)
        metrics["device.idle_in_dispatch_ms"] = (
            split["in_dispatch"] / d_steps / 1e3)
        notes["device_idle_ms"] = {str(k): v / d_steps / 1e3
                                   for k, v in split.items()}
        notes["device_stretch_idle_ms"] = sum(
            b - a for a, b in idle) / d_steps / 1e3
    if "host" in phases.spans and phases.records.get("host"):
        # a span open when the profile started has no range in its trace
        base, wall0, wall1 = phases.spans["host"]
        gaps = clock_gaps([r for r in phases.records["host"]
                           if wall0 <= r[2] <= wall1], host_events, base)
        if gaps:
            notes["clock_gap_us"] = {
                "n": len(gaps), "median": float(np.median(gaps)),
                "p95": float(np.percentile(gaps, 95)),
                "max": float(max(gaps))}
    notes["syncs_by_site"] = dict(sorted(phases.sites.items(),
                                         key=lambda kv: -kv[1]))
    return metrics, notes


def run(h, record=False):
    """(the harness's result, the spans' readings) of one run of the
    Harness h, its traced stretches SpanPhases; record: recording on
    through an untraced run."""
    from umr_bench import harness
    from umr_tpu_torch import tracing

    phases, kept = [], {}
    SpanPhases = _subclassed_phases(harness, tracing)

    def make(*a, **kw):
        phases.append(SpanPhases(*a, **kw))
        return phases[-1]

    context = harness.Harness._trace_context

    def keep(self, ph, rec):
        # the device stretch's operations and the host stretch's events
        ctx = context(self, ph, rec)
        kept.update(d_ops=ctx.device_ops, events=ctx.events)
        ph.recorder = None        # its renders' tensors go with the run
        return ctx

    harness.TracePhases, saved = make, harness.TracePhases
    harness.Harness._trace_context = keep
    if record and not h.trace:
        tracing.start_recording()
    try:
        result = h.run()
    finally:
        harness.TracePhases = saved
        harness.Harness._trace_context = context
        n_records = len(tracing.stop_recording())
    out = {"record": int(bool(record))}
    if h.trace and phases:
        out["metrics"], out["notes"] = readings(
            phases[0], kept.get("d_ops", []), kept.get("events", []))
        out["notes"]["harness"] = h.trace_notes
    elif record:
        out["records"] = n_records
    return result, out


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=1)
    p.add_argument("--record", type=int, choices=(0, 1), default=0)
    args = p.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import torch

    from umr_bench import harness

    if not torch.cuda.is_available():
        print("umr_bench: no CUDA device is visible", file=sys.stderr)
        return 2
    # the configuration states float32 with TF32 off
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    h = harness.Harness(args.workload, args.seed, args.seconds, args.trace,
                        t_start=T_START)
    result, out = run(h, args.record)
    for line in harness.check_lines(result["checks"]):
        print(line, file=sys.stderr)
    print(json.dumps(result), flush=True)
    print("spans: " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
