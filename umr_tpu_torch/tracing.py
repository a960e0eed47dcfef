"""Spans and counters of the program: its one tracing mechanism.

  with span("trainer.prep"):
      ...
  count("trainer.h2d_bytes", n)
  device_counter("raster.bins_entries", dev).add_(n_on_device)

A span always opens a torch.profiler range of its name (so a trace of the
program splits its device time by span) and always adds its host seconds
and one call to its name's totals (two perf_counter_ns calls and a dict
update). While recording is on it also keeps a record (name, the name of
the span open around it on this thread or None, start, end). totals()
reads the totals and counters, delta() the change between two readings,
current() the innermost open span; nothing is written to disk.

A counter the device feeds (device_counter: an int64 tensor on that
device, which kernels and tensor ops add to in place) costs the step no
host sync; totals() reads it back, which waits for the device, so call
totals() outside a step.

stop_recording() returns the records with their start and end as
wall-clock microseconds: the clock of a torch.profiler Chrome trace once
the trace's baseTimeNanoseconds is added to its "ts" (both clocks read
time.time_ns's clock; the pair of readings taken by start_recording maps
perf_counter_ns onto it).
"""

from __future__ import annotations

import threading
import time

import torch
from torch.profiler import record_function

_spans = {}           # name -> [nanoseconds, calls]
_counters = {}        # name -> amount
_device_counters = {}  # (name, device) -> int64 [1] tensor on the device
_records = None       # [(name, parent, start_ns, end_ns)] while recording
_anchor = None        # (time.time_ns(), time.perf_counter_ns())
_open = threading.local()
_lock = threading.Lock()  # the totals, counters and records are shared


class span:
    """Context manager: a profiler range, the host time and call count of
    `name`, and a record while recording is on."""

    __slots__ = ("name", "_range", "_parent", "_t0")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        self._parent = stack[-1] if stack else None
        stack.append(self.name)
        self._range = record_function(self.name)
        # The range's timestamp is taken early in __enter__, whose first
        # call in a process can then spend a millisecond more (torch's
        # lazy set-up), so the record starts where the range does.
        self._t0 = time.perf_counter_ns()
        self._range.__enter__()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        self._range.__exit__(*exc)
        _open.stack.pop()
        with _lock:
            tot = _spans.get(self.name)
            if tot is None:
                tot = _spans[self.name] = [0, 0]
            tot[0] += t1 - self._t0
            tot[1] += 1
            if _records is not None:
                _records.append((self.name, self._parent, self._t0, t1))
        return False


def current():
    """The name of the innermost span open on this thread, or None."""
    stack = getattr(_open, "stack", None)
    return stack[-1] if stack else None


def count(name, n=1):
    """Add n to the counter `name`."""
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def device_counter(name, device):
    """The int64 [1] tensor on `device` that adds to the counter `name`:
    add to it in place (a kernel through its pointer, or add_), and
    totals() counts it with what count() added under the same name."""
    key = (name, torch.device(device))
    with _lock:
        acc = _device_counters.get(key)
        if acc is None:
            acc = _device_counters[key] = torch.zeros(
                1, dtype=torch.int64, device=device)
        return acc


def totals():
    """{"seconds": {span: s}, "calls": {span: n}, "counters": {name: n}}
    since the process began (or the last reset()); reading the device's
    counters waits for their devices."""
    with _lock:
        counters = dict(_counters)
        for (name, _), acc in _device_counters.items():
            counters[name] = counters.get(name, 0) + int(acc.item())
        return {"seconds": {k: v[0] / 1e9 for k, v in _spans.items()},
                "calls": {k: v[1] for k, v in _spans.items()},
                "counters": counters}


def delta(before, after=None):
    """What totals() gained from `before` to `after` (default: now)."""
    after = totals() if after is None else after
    return {kind: {k: v - before[kind].get(k, 0)
                   for k, v in after[kind].items()}
            for kind in after}


def start_recording():
    """Keep a record of every span that ends from now on."""
    global _records, _anchor
    with _lock:
        _anchor = (time.time_ns(), time.perf_counter_ns())
        _records = []


def stop_recording():
    """Stop recording; [(name, parent, start_us, end_us)] of the spans
    that ended while it was on, on the wall clock in microseconds."""
    global _records
    with _lock:
        recs, _records = _records or [], None
    wall, perf = _anchor or (0, 0)
    return [(n, p, (wall + t0 - perf) / 1e3, (wall + t1 - perf) / 1e3)
            for n, p, t0, t1 in recs]


def reset():
    """Clear the totals, the counters and any records; recording off."""
    global _records
    with _lock:
        _spans.clear()
        _counters.clear()
        _device_counters.clear()
        _records = None
