"""A run without the chip (the CPU, small sizes, the program's kernel
route through the kernels' plain versions, whose gradients are the
card's), first sound, then with the timed path broken underneath: a step
that returns its state unchanged, a step that leaves out half of the
batch and takes its mean over the rest, and a step whose update has the
opposite sign. `correct` has to come out false for each fault, by the
cell's own limits."""

import pytest
import torch

from umr_bench import harness
from umr_tpu_torch.experiments import train_s2

SMALL = {"program": {"image_size": 32, "img_size": 32, "subdivide": 2,
                     "num_hypo_cams": 2},
         "traffic": {"batch_size": 4, "pool": 4, "warmup_steps": 4}}


def unchanged(step_fn):
    """The step's scalars, its parameters put back: the state unchanged."""
    def step(state, batch, *a, **kw):
        params = [p.detach().clone() for p in state.model.parameters()]
        state, sc = step_fn(state, batch, *a, **kw)
        with torch.no_grad():
            for p, q in zip(state.model.parameters(), params):
                p.copy_(q)
        return state, sc
    return step


def half_batch(step_fn):
    """The step on the first half of each batch."""
    def step(state, batch, *a, **kw):
        return step_fn(state, {k: v[: len(v) // 2] for k, v in
                               batch.items()}, *a, **kw)
    return step


def ascent(step_fn):
    """The step with its update's sign flipped: each parameter moved as
    far the other way."""
    def step(state, batch, *a, **kw):
        params = [p.detach().clone() for p in state.model.parameters()]
        state, sc = step_fn(state, batch, *a, **kw)
        with torch.no_grad():
            for p, q in zip(state.model.parameters(), params):
                p.copy_(2 * q - p)
        return state, sc
    return step


def _run(monkeypatch, workload, fault=None):
    build = train_s2.build_s2_step

    def broken_build(*a, **kw):
        model, disc, lpips, init_fn, step_fn = build(
            *a, **dict(kw, impl="kernel"))
        return (model, disc, lpips, init_fn,
                step_fn if fault is None else fault(step_fn))

    monkeypatch.setattr(train_s2, "build_s2_step", broken_build)
    torch.manual_seed(0)
    h = harness.Harness(workload, 2**31 + 17, 0.5, 0, device="cpu",
                        overrides=SMALL)
    return h.run()


@pytest.mark.parametrize("workload", ["s2_train"])
def test_sound_run_reads_within_limits(monkeypatch, workload):
    checks = _run(monkeypatch, workload)["checks"]
    for name in ("loss1_gap", "grad1_gap", "delta_cos_gap"):
        assert checks[name]["value"] <= checks[name]["limit"], checks


@pytest.mark.parametrize("fault", [unchanged, half_batch, ascent],
                         ids=["state_unchanged", "half_batch", "ascent"])
@pytest.mark.parametrize("workload", ["s2_train"])
def test_broken_step_is_not_correct(monkeypatch, workload, fault):
    result = _run(monkeypatch, workload, fault)
    assert result["correct"] is False
    assert any(c["value"] > c["limit"] for c in result["checks"].values())
