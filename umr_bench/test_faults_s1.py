"""The s1_train cell without the chip, as test_faults.py runs s2_train:
the CPU, small sizes, the program's kernel route through the kernels'
plain versions (their gradients are the card's), first sound, then with
the timed path broken underneath (the state unchanged, half of each
batch, the update's sign flipped). `correct` has to come out false for
each fault, by the cell's own limits."""

import json
import sys

import pytest
import torch

from umr_bench import harness
from umr_bench.test_faults import ascent, half_batch, unchanged
from umr_tpu_torch.experiments import train_s1

SMALL = {"program": {"image_size": 32, "img_size": 32, "subdivide": 2},
         "traffic": {"batch_size": 4, "pool": 4, "warmup_steps": 4}}


def run_s1(seed, fault=None):
    """The s1_train cell at SMALL on the CPU's kernel route."""
    build = train_s1.build_s1_step

    def broken_build(*a, **kw):
        out = build(*a, **dict(kw, impl="kernel"))
        step_fn = out[4] if fault is None else fault(out[4])
        return out[:4] + (step_fn,) + out[5:]

    train_s1.build_s1_step = broken_build
    try:
        torch.manual_seed(0)
        return harness.Harness("s1_train", seed, 0.5, 0, device="cpu",
                               overrides=SMALL).run()
    finally:
        train_s1.build_s1_step = build


def test_sound_run_reads_within_limits():
    result = run_s1(2**31 + 17)
    assert result["correct"] is True, result["checks"]


@pytest.mark.parametrize("fault", [unchanged, half_batch, ascent],
                         ids=["state_unchanged", "half_batch", "ascent"])
def test_broken_step_is_not_correct(fault):
    result = run_s1(2**31 + 17, fault)
    assert result["correct"] is False
    assert any(c["value"] > c["limit"] for c in result["checks"].values())


if __name__ == "__main__":
    # python -m umr_bench.test_faults_s1 SEED: the sound run's result line
    print(json.dumps(run_s1(int(sys.argv[1]))))
