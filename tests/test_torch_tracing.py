"""The port's spans and counters (umr_tpu_torch/tracing.py) on the CPU:
nesting and self time, totals and counters, no records while recording
is off, records on the clock of torch.profiler's Chrome trace, the step's
profiler ranges kept by name, and the trainer's budget read from its
spans."""

import json
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from umr_tpu_torch import tracing
from umr_tpu_torch.config import Config
from umr_tpu_torch.data import synthetic_batch
from umr_tpu_torch.losses.composite import PartMatchingLoss
from umr_tpu_torch.mesh import build_template
from umr_tpu_torch.renderer import SoftRenderer
from umr_tpu_torch.training import steps as tsteps
from umr_tpu_torch.training.steps import TrainState
from umr_tpu_torch.training.trainer import BUDGET_KEYS, Trainer, \
    prepare_batch

# the ranges a stage-2 step opened as torch.profiler ranges before they
# became spans, on the kernels' route (shared bins) at this test's size
S2_RANGES = {"s2.forward", "s2.model", "s2.pass1_fold", "s2.lpips",
             "s2.pass2_hard", "s2.pass3_merged", "s2.backward",
             "s2.optimizer"}


def _recorded(fn):
    tracing.start_recording()
    try:
        fn()
    finally:
        records = tracing.stop_recording()
    return records


def test_nesting_parents_and_self_time():
    def nested():
        with tracing.span("t.outer"):
            time.sleep(0.02)
            with tracing.span("t.inner"):
                time.sleep(0.03)
            with tracing.span("t.inner"):
                pass

    before = tracing.totals()
    records = _recorded(nested)
    assert [(n, p) for n, p, _, _ in records] == [
        ("t.inner", "t.outer"), ("t.inner", "t.outer"), ("t.outer", None)]
    dur = {i: r[3] - r[2] for i, r in enumerate(records)}
    assert all(d >= 0 for d in dur.values())
    # each child lies inside its parent
    (_, _, lo, hi) = records[2]
    assert all(lo <= r[2] <= r[3] <= hi for r in records[:2])
    # the parent's self time: its duration less its children's, which is
    # its own sleep
    self_us = dur[2] - dur[0] - dur[1]
    assert self_us >= 0.02e6 and dur[0] >= 0.03e6
    # the totals hold the same durations (a wall-clock microsecond near
    # 1.8e15 is a float64 to a quarter of a microsecond)
    d = tracing.delta(before)
    assert d["calls"]["t.outer"] == 1 and d["calls"]["t.inner"] == 2
    assert d["seconds"]["t.outer"] * 1e6 == pytest.approx(dur[2], abs=1.0)
    assert d["seconds"]["t.inner"] * 1e6 == pytest.approx(
        dur[0] + dur[1], abs=1.0)


def test_totals_and_counters():
    before = tracing.totals()
    for _ in range(3):
        with tracing.span("t.counted"):
            pass
    tracing.count("t.bytes", 100)
    tracing.count("t.bytes", 28)
    tracing.count("t.events")
    d = tracing.delta(before)
    assert d["calls"]["t.counted"] == 3 and d["seconds"]["t.counted"] >= 0
    assert d["counters"]["t.bytes"] == 128 and d["counters"]["t.events"] == 1
    later = tracing.totals()
    assert tracing.delta(later, later)["counters"]["t.bytes"] == 0
    # a span that raises still ends, and lets the error through
    with pytest.raises(ValueError):
        with tracing.span("t.raises"):
            raise ValueError
    assert tracing.delta(later)["calls"]["t.raises"] == 1
    tracing.reset()
    assert tracing.totals() == {"seconds": {}, "calls": {}, "counters": {}}


def test_totals_lose_no_update_across_threads():
    """More threads than cores, switching every microsecond: every span
    and count arrives, and each thread's spans nest on its own stack."""
    n_threads, n = 2 * (os.cpu_count() or 1), 500
    before = tracing.totals()
    parents = []

    def work():
        for _ in range(n):
            with tracing.span("t.thread_outer"):
                with tracing.span("t.thread_inner"):
                    tracing.count("t.thread_count")
                    parents.append(tracing.current())

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    d = tracing.delta(before)
    assert d["calls"]["t.thread_outer"] == n_threads * n
    assert d["calls"]["t.thread_inner"] == n_threads * n
    assert d["counters"]["t.thread_count"] == n_threads * n
    assert set(parents) == {"t.thread_inner"}


def test_no_records_while_recording_is_off():
    def one(name):
        with tracing.span(name):
            pass

    assert _recorded(lambda: None) == []
    one("t.unrecorded")
    assert tracing.stop_recording() == []
    assert [r[0] for r in _recorded(lambda: one("t.recorded"))] == [
        "t.recorded"]
    one("t.unrecorded")
    assert tracing.stop_recording() == []


def test_records_map_onto_the_profilers_clock(tmp_path):
    """Each record's start, in wall-clock microseconds, lies within 1 ms
    of its own range's ts in the Chrome trace plus baseTimeNanoseconds."""
    def spans():
        for i in range(20):
            with tracing.span(f"t.clock{i}"):
                torch.ones(64).sum()
            time.sleep(0.002)

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        records = _recorded(spans)
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    trace = json.loads((tmp_path / "trace.json").read_text())
    base_us = trace.get("baseTimeNanoseconds", 0) / 1e3
    ts = {e["name"]: float(e["ts"]) + base_us for e in trace["traceEvents"]
          if e.get("cat") == "user_annotation"
          and e["name"].startswith("t.clock")}
    assert len(records) == len(ts) == 20
    gaps = [abs(start - ts[name]) for name, _, start, _ in records]
    assert max(gaps) <= 1000.0, gaps


def test_s2_step_keeps_its_range_names():
    """A step on the kernels' route opens the ranges it opened before its
    layers became spans, and no other s2.* range. It bins nothing outside
    the kernels' launches: on the card each launch bins its faces inside
    the render pass or the backward around it, and the plain versions on
    the CPU take no bins, so this step opens no raster.bins span
    (tests/test_torch_bins.py holds the card's)."""
    img = 32
    cfg = Config(image_size=img, img_size=img, batch_size=2, num_hypo_cams=2,
                 anti_aliasing=False, subdivide=2, tex_size=2, nz_feat=32,
                 z_dim=24)
    template = build_template(2, 1, 2)
    rng = np.random.RandomState(5)
    seg = rng.randint(0, 5, size=(16, 32)).astype(np.float32)
    idx = rng.permutation(template.num_verts)
    pvi = [idx[0:20], idx[20:60], idx[60:80], idx[80:120]]
    pr = SoftRenderer(image_size=img, anti_aliasing=False,
                      ambient_intensity=1.0, directional_intensity=0.0,
                      impl="kernel")
    pl = PartMatchingLoss.build(seg, template.uv_sampler,
                                template.num_sym_faces, pr, tex_size=2)
    _, _, _, init_fn, step_fn = tsteps.build_s2_step(
        cfg, template, pl, pvi, "cpu", impl="kernel")
    state = init_fn(0)
    db = prepare_batch(synthetic_batch(np.random.RandomState(6), 2, img))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        records = _recorded(lambda: step_fn(state, db))
    ranges = {e.name for e in prof.events()}
    assert {n for n in ranges if n.startswith("s2.")} == S2_RANGES
    assert {r[0] for r in records} == S2_RANGES
    assert "raster.bins" not in ranges


class _Loader:
    def __init__(self, n, size=8):
        rng = np.random.RandomState(0)
        self.batches = [synthetic_batch(rng, 2, size) for _ in range(n)]

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        for b in self.batches:
            time.sleep(0.005)
            yield b


def test_trainer_budget_is_read_from_its_spans(tmp_path, monkeypatch):
    """Each step cycle's phases are spans; stage_budget.json holds their
    seconds per step since the trainer began, its steps the dispatches."""
    monkeypatch.setenv("UMR_TPU_NO_AUTORESUME", "1")
    model, disc = torch.nn.Linear(2, 2), torch.nn.Linear(1, 1)
    state = TrainState(step=0, updates=0, model=model, disc=disc, lpips=None,
                       optimizer=torch.optim.SGD(model.parameters(), lr=0.1),
                       generator=torch.Generator())

    def step_fn(state, db):
        with tracing.span("s2.forward"):
            time.sleep(0.002)
        state.step += 1
        return state, {"total_loss": torch.tensor(1.0)}

    cfg = Config(checkpoint_dir=str(tmp_path), name="b", num_epochs=2,
                 print_scalars=False, use_scops=False)
    before = tracing.totals()
    trainer = Trainer(cfg, step_fn, state, _Loader(3),
                      on_epoch_end=lambda s, e: s)
    records = _recorded(trainer.train)
    d = tracing.delta(before)
    # two epochs of three batches; each epoch's loader ends in a fourth wait
    assert {f"trainer.{k}": d["calls"].get(f"trainer.{k}", 0)
            for k in ("loader", "prep", "transfer", "dispatch", "drain",
                      "epoch_end")} == {
        "trainer.loader": 8, "trainer.prep": 6, "trainer.transfer": 6,
        "trainer.dispatch": 6, "trainer.drain": 6, "trainer.epoch_end": 2}
    assert d["seconds"]["trainer.loader"] >= 6 * 0.005
    assert {p for n, p, _, _ in records if n == "s2.forward"} == {
        "trainer.dispatch"}
    budget = json.loads((tmp_path / "b" / "stage_budget.json").read_text())
    assert budget["steps"] == 6
    for k in BUDGET_KEYS + ("epoch_end",):
        assert budget[f"{k}_s_per_step"] == pytest.approx(
            d["seconds"].get(f"trainer.{k}", 0.0) / 6, abs=1e-4), k
    assert trainer.budget()["loader"] == pytest.approx(
        d["seconds"]["trainer.loader"])
