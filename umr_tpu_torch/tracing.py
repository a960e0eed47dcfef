"""Spans and counters of the program: its one tracing mechanism.

  with span("trainer.prep"):
      ...
  count("trainer.h2d_bytes", n)

A span always opens a torch.profiler range of its name (so a trace of the
program splits its device time by span) and always adds its host seconds
and one call to its name's totals (two perf_counter_ns calls and a dict
update). While recording is on it also keeps a record (name, the name of
the span open around it on this thread or None, start, end). totals()
reads the totals and counters, delta() the change between two readings,
current() the innermost open span; nothing is written to disk.

stop_recording() returns the records with their start and end as
wall-clock microseconds: the clock of a torch.profiler Chrome trace once
the trace's baseTimeNanoseconds is added to its "ts" (both clocks read
time.time_ns's clock; the pair of readings taken by start_recording maps
perf_counter_ns onto it).
"""

from __future__ import annotations

import threading
import time

from torch.profiler import record_function

_spans = {}           # name -> [nanoseconds, calls]
_counters = {}        # name -> amount
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
        self._range.__enter__()
        self._t0 = time.perf_counter_ns()
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


def totals():
    """{"seconds": {span: s}, "calls": {span: n}, "counters": {name: n}}
    since the process began (or the last reset())."""
    with _lock:
        return {"seconds": {k: v[0] / 1e9 for k, v in _spans.items()},
                "calls": {k: v[1] for k, v in _spans.items()},
                "counters": dict(_counters)}


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
        _records = None
