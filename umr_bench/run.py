"""The benchmark of umr_tpu_torch, one run of one cell:

  python3 umr_bench/run.py --workload s2_train --seed 1234 --seconds 40 \
      --trace 0

prints the cell's metrics as the last line of its standard output (one
JSON object), and each number compared with the plain reference, beside
its limit, as the last lines of its standard error. Exits non-zero,
with no result, when no card (or fewer than the cell asks for) is
visible. See harness.py.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

# one process with few threads: the host work of the step (the trainer's
# preparation, the copies, the launches) competes with nothing of ours
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "2"


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    from umr_bench import harness

    return harness.main(args, T_START)


if __name__ == "__main__":
    sys.exit(main())
