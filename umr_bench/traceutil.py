"""Reading a torch.profiler trace: device operations, their attribution to
the host's profiler ranges and to kernel names, the device's busy time
and its idle gaps. The arithmetic of trace_events, range_split, busy_us
and by_name is a frozen copy of the program's experiments/
profile_slice.py; idle_gaps is the benchmark's own.
"""

from __future__ import annotations

import json
import os
import tempfile

import numpy as np

DEVICE_CATS = ("kernel", "gpu_memset", "gpu_memcpy")
HOST_CATS = ("cpu_op", "user_annotation", "python_function",
             "cuda_runtime", "cuda_driver")


def export_events(prof, tmp_dir=None):
    """The Chrome trace events of a finished torch.profiler.profile."""
    with tempfile.TemporaryDirectory(dir=tmp_dir) as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]


def device_ops(events, cats=DEVICE_CATS):
    """[(name, ts_us, dur_us)] of the trace's device events of `cats`."""
    return [(e["name"], float(e["ts"]), float(e["dur"])) for e in events
            if e.get("cat") in cats and "dur" in e]


def launch_times(events):
    """{correlation id: host microsecond} of the trace's CUDA API calls."""
    launch = {}
    for e in events:
        if e.get("cat", "").startswith("cuda_"):
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launch[corr] = float(e["ts"])
    return launch


def range_split(events, prefix, steps):
    """Device milliseconds per step by host range: each device event counts
    to the innermost profiler range named prefix* open on the host when
    its launch was issued, else to "outside", or "unmatched" where the
    trace holds no launch for it. Returns {name: ms}."""
    launch = launch_times(events)
    ranges = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                      e["name"]) for e in events
                     if e.get("cat") == "user_annotation"
                     and e["name"].startswith(prefix)),
                    key=lambda r: r[1] - r[0])
    out = {}
    for e in events:
        if e.get("cat") not in DEVICE_CATS or "dur" not in e:
            continue
        t = launch.get(e.get("args", {}).get("correlation"))
        name = "unmatched"
        if t is not None:
            name = next((n for lo, hi, n in ranges if lo <= t <= hi),
                        "outside")
        out[name] = out.get(name, 0.0) + float(e["dur"]) / steps / 1e3
    return out


def busy_us(ops):
    """Length of the union of the operations' intervals, microseconds."""
    total, reach = 0.0, float("-inf")
    for _, ts, dur in sorted(ops, key=lambda k: k[1]):
        lo, hi = max(ts, reach), ts + dur
        if hi > lo:
            total += hi - lo
        reach = max(reach, hi)
    return total


def by_name(ops, top=10):
    """[(name, total us)] of the operations, the largest first."""
    agg = {}
    for name, _, dur in ops:
        agg[name] = agg.get(name, 0.0) + dur
    return sorted(agg.items(), key=lambda kv: -kv[1])[:top]


def idle_gaps(ops, events, lo, hi, top=10, labelled=500):
    """The device's idle time in [lo, hi] (microseconds), summed by what
    the host was doing when each gap began: the innermost host event open
    then, or "host idle". The `labelled` longest gaps are named; the rest
    are summed as "shorter gaps". [(name, us)], the largest first."""
    gaps, reach = [], lo
    for _, ts, dur in sorted(ops, key=lambda k: k[1]):
        if ts > reach:
            gaps.append((reach, min(ts, hi)))
        reach = max(reach, ts + dur)
    if reach < hi:
        gaps.append((reach, hi))
    gaps = sorted((g for g in gaps if g[1] > g[0]),
                  key=lambda g: g[0] - g[1])
    host = [e for e in events if e.get("cat") in HOST_CATS and "dur" in e]
    starts = np.array([float(e["ts"]) for e in host])
    ends = starts + np.array([float(e["dur"]) for e in host])
    agg = {}
    for i, (g0, g1) in enumerate(gaps):
        name = "shorter gaps"
        if i < labelled:
            open_ = np.nonzero((starts <= g0) & (ends > g0))[0]
            name = (host[open_[np.argmin(ends[open_] - starts[open_])]]
                    ["name"] if open_.size else "host idle")
        agg[name] = agg.get(name, 0.0) + (g1 - g0)
    return sorted(agg.items(), key=lambda kv: -kv[1])[:top]
