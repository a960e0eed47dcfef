"""The benchmark's s1_train cell (umr_bench/: the configuration umr_s1,
its traffic and its limits) through the harness on the CPU at a small
size, on the program's kernel route (the kernels' plain versions): every
check of the program's first steps against the plain reference within
the cell's own limit, on two seeds. Each run is a process of its own, as
the benchmark's are: the harness refuses a process that has loaded the
JAX stack, as this suite's conftest has."""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("seed", [2**31 + 17, 12345])
def test_s1_train_cell_matches_the_reference(seed):
    env = dict(os.environ, OMP_NUM_THREADS="2", MKL_NUM_THREADS="2")
    out = subprocess.run(
        [sys.executable, "-m", "umr_bench.test_faults_s1", str(seed)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["checks"], result
    for name, c in result["checks"].items():
        assert c["value"] <= c["limit"], (name, result["checks"])
    assert result["failed"] == 0
    assert result["correct"] is True
