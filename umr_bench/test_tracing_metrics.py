"""The split of the device's idle time by the program's spans (spans.py)
on synthetic operations and records: an idle interval split across two
spans, parts that add up to the idle total, records moved onto the
trace's clock, and the clock check's gaps; the device time launched
inside the binning span, which render.device_ms still counts to its
render pass; and the bytes a step copied to the card from the program's
counter.

  python -m pytest umr_bench -q
"""

import sys
from types import SimpleNamespace

import pytest

from umr_bench import harness, spans, traceutil


def test_idle_intervals_are_the_complement_of_the_operations():
    ops = [("a", 10.0, 20.0), ("b", 25.0, 10.0), ("c", 50.0, 5.0),
           ("d", 120.0, 10.0), ("e", -5.0, 8.0)]
    assert spans.idle_intervals(ops, 0.0, 100.0) == [
        (3.0, 10.0), (35.0, 50.0), (55.0, 100.0)]
    assert spans.idle_intervals([], 0.0, 5.0) == [(0.0, 5.0)]
    assert spans.idle_intervals([("x", 0.0, 10.0)], 2.0, 8.0) == []


def test_idle_split_by_overlap_with_spans():
    # the device idles over 0..40 and 60..100
    ops = [("k", 40.0, 20.0)]
    idle = spans.idle_intervals(ops, 0.0, 100.0)
    base = 1000.0                  # the records' clock is the trace's + base
    records = [
        ("trainer.prep", None, base + 0.0, base + 15.0),
        ("trainer.transfer", None, base + 15.0, base + 25.0),
        # one idle interval split across two spans: 25..40 in dispatch,
        # 60..70 in dispatch, 70..90 in drain
        ("trainer.dispatch", None, base + 25.0, base + 70.0),
        ("s2.forward", "trainer.dispatch", base + 30.0, base + 65.0),
        ("trainer.drain", None, base + 70.0, base + 90.0),
    ]
    split = spans.idle_split(idle, records, offset_us=base)
    assert split["before_dispatch"] == pytest.approx(25.0)
    assert split["in_dispatch"] == pytest.approx(15.0 + 10.0)
    assert split["drain"] == pytest.approx(20.0)
    assert split["other_trainer"] == 0.0
    assert split[None] == pytest.approx(10.0)          # 90..100: no span
    # the parts add up to the idle total; a nested span is not counted twice
    assert sum(split.values()) == pytest.approx(80.0)


def test_idle_split_per_interval_not_by_the_span_open_at_its_start():
    idle = [(0.0, 100.0)]
    records = [("trainer.loader", None, -50.0, 10.0),
               ("trainer.dispatch", None, 10.0, 95.0)]
    split = spans.idle_split(idle, records)
    assert split["before_dispatch"] == pytest.approx(10.0)
    assert split["in_dispatch"] == pytest.approx(85.0)
    assert split[None] == pytest.approx(5.0)


def test_clock_gaps_match_each_record_to_its_range():
    base = 5e5
    events = [{"cat": "user_annotation", "name": "trainer.prep", "ts": t,
               "dur": 5.0} for t in (100.0, 300.0)]
    events.append({"cat": "kernel", "name": "trainer.prep", "ts": 0.0,
                   "dur": 1.0})
    records = [("trainer.prep", None, base + 102.0, base + 110.0),
               ("trainer.prep", None, base + 297.0, base + 305.0),
               ("trainer.drain", None, base + 1.0, base + 2.0)]
    assert spans.clock_gaps(records, events, base) == pytest.approx(
        [2.0, 3.0])


def test_bins_device_ms_beside_the_render_passes():
    def ev(cat, name, ts, dur, corr=None):
        e = {"cat": cat, "name": name, "ts": ts, "dur": dur}
        if corr is not None:
            e["args"] = {"correlation": corr}
        return e

    events = [
        ev("user_annotation", "s2.pass1_fold", 0, 100),
        ev("user_annotation", "raster.bins", 10, 20),
        ev("cuda_runtime", "cudaLaunchKernel", 15, 1, corr=1),
        ev("cuda_runtime", "cudaLaunchKernel", 50, 1, corr=2),
        ev("kernel", "scatter_kernel", 20, 300, corr=1),
        ev("kernel", "raster_fwd_kernel", 400, 900, corr=2),
    ]
    ctx = SimpleNamespace(events=events, notes={"trace_steps": 2},
                          prefix="s2.",
                          range_ms=traceutil.range_split(events, "s2.", 2))
    read = harness.load_metric("render.bins_device_ms").read
    assert read(ctx) == pytest.approx(0.150)
    # the pass keeps the binning's launches
    assert harness.load_metric("render.device_ms").read(ctx) == \
        pytest.approx(0.600)
    # a program without the span: nothing to read
    ctx.events = [e for e in events if e["name"] != "raster.bins"]
    assert read(ctx) is None


def test_h2d_mib_from_the_programs_counter(monkeypatch):
    from umr_tpu_torch import tracing

    read = harness.load_metric("trainer.h2d_mib").read
    tracing.reset()
    assert read(None) is None
    for _ in range(3):
        with tracing.span("trainer.dispatch"):
            tracing.count("trainer.h2d_bytes", 3 * 2 ** 20)
    assert read(None) == pytest.approx(3.0)
    # a program without the tracing module: nothing to read
    import umr_tpu_torch
    monkeypatch.delattr(umr_tpu_torch, "tracing")
    monkeypatch.setitem(sys.modules, "umr_tpu_torch.tracing", None)
    assert read(None) is None
    tracing.reset()
