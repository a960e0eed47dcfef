"""The upper readings of a training cell's comparison, on the card at the
cell's own size: the plain reference put in the program's place in a
lower precision (the control: TF32 for float32 with TF32 off), and with
half of each batch left out (the fault "half the batch, the mean over
the rest"), and with every update's sign flipped (gradient ascent),
each against the reference as the configuration states it, from the
same seed. A state left unchanged reads 1 by delta_gap and
needs no run. Not part of a benchmark run.

  python3 umr_bench/control.py --workload s2_train --seeds 11 12 13

prints one JSON line per seed and reading.
"""

import argparse
import json
import os
import sys
import time


def half_batch(readings_fn, h):
    """The reference's readings on the first half of each batch."""
    full = h.reference_batches()
    h.ref_pool = [{k: v[: len(v) // 2] for k, v in b.items()} for b in full]
    try:
        return readings_fn()
    finally:
        h.ref_pool = full


def ascent(readings_fn):
    """The reference's readings with every update's sign flipped (Adam
    maximising the loss)."""
    import functools

    import torch

    adam = torch.optim.Adam
    torch.optim.Adam = functools.partial(adam, maximize=True)
    try:
        return readings_fn()
    finally:
        torch.optim.Adam = adam


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--readings", nargs="+",
                   default=["sound", "control", "half_batch", "ascent"])
    args = p.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import torch

    from umr_bench import compare, harness

    if not torch.cuda.is_available():
        print("control: no CUDA device is visible", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for seed in args.seeds:
        h = harness.Harness(args.workload, seed, 0, 0)
        h.reference_batches()
        t0 = time.perf_counter()
        ref = h.reference_readings()
        ref_s = time.perf_counter() - t0
        variants = {
            "sound": lambda: h.reference_readings(),
            "control": lambda: h.reference_readings(tf32=True),
            "half_batch": lambda: half_batch(h.reference_readings, h),
            "ascent": lambda: ascent(h.reference_readings),
        }
        for name in args.readings:
            other = variants[name]()
            g = compare.gaps(other, ref)
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "reading": name, "reference_s": ref_s,
                              **{k: v for k, (v, _) in g.items()},
                              "at": {k: at for k, (_, at) in g.items()},
                              **compare.noisy_readings(other, ref)}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
