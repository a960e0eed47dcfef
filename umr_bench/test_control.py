"""The control on the card: the plain reference in a lower precision than
the configuration states (TF32 for float32 with TF32 off), with half of
each batch left out, and with its updates' sign flipped, put in the program's place against the reference
as stated, come out not correct; the reference against itself comes out
within the limits. At the cells' widths with a small batch, so that a
test run holds it; control.py reads the same at the cells' own sizes.

  python -m pytest umr_bench -q -m cuda      (on the card)
"""

import pytest
import torch

from umr_bench import compare, control, harness

SMALL = {"traffic": {"batch_size": 4, "pool": 3}}


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["s2_train"])
def test_control_and_half_batch_fail_reference_passes(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    h = harness.Harness(workload, 2**31 + 5, 0, 0, overrides=SMALL)
    limits = h.traffic["limits"]
    ref = h.reference_readings()

    def failed(readings):
        return [n for n, c in compare.checks(readings, ref, limits).items()
                if c["value"] > c["limit"]]

    assert failed(h.reference_readings()) == []
    assert failed(h.reference_readings(tf32=True))
    assert failed(control.half_batch(h.reference_readings, h))
    assert failed(control.ascent(h.reference_readings))
