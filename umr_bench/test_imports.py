"""No module that a run loads is of the JAX stack or the JAX package
(top-level names compared whole: umr_tpu_torch is the program, umr_tpu
the JAX package), and the plain reference loads nothing of the program.
Each check imports in a fresh interpreter."""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "umr_tpu"}


def _top_level_after(imports):
    code = (f"import sys; sys.path.insert(0, {ROOT!r})\n" + imports
            + "\nimport json; print(json.dumps(sorted({m.split('.')[0] "
              "for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=ROOT)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_and_program_load_no_jax():
    names = _top_level_after(
        "from umr_bench import harness, control, compare, data, workcount\n"
        "from umr_tpu_torch.experiments import train_s1, train_s2\n"
        "from umr_tpu_torch.ops import raster_kernel")
    assert "umr_tpu_torch" in names
    assert not names & FORBIDDEN, names & FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    names = _top_level_after(
        "from umr_bench.reference import geom, nets, raster, step, "
        "template")
    assert not names & (FORBIDDEN | {"umr_tpu_torch"})


@pytest.mark.parametrize("name", sorted(FORBIDDEN))
def test_guard_names_whole_top_level(name, monkeypatch):
    from umr_bench import harness

    monkeypatch.setitem(sys.modules, name + "_torch_lookalike", sys)
    assert name not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, name + ".sub", sys)
    assert name in harness.forbidden_modules()
