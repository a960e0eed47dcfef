"""The comparison that decides `correct` for a training cell: the
program's readings of its first three steps against the plain
reference's, from the same seed, weights, batches and draws.

The numbers, each with a limit of its own where the cell's traffic
file's "limits" name it:
  loss1_gap  - the relative gap of the first step's total loss;
  grad1_gap  - by the worst leaf, the gap between the norms of the first
               gradient (the program's as Adam's first moment holds it),
               over the reference's norm of that leaf or of the median
               leaf, whichever is larger;
  grad1_median_gap - the same gap of the median leaf;
  delta_gap  - the relative gap of the median leaf's change over the
               three steps, over the leaves the reference moves by more
               than round-off: a leaf whose first gradient is under a
               thousandth of the median leaf's (a bias under a softmax, a
               head the forward never reads) moves under Adam by
               round-off alone, and is left out by that rule;
  delta_cos_gap - 1 - the cosine between the program's change over the
               three steps and the reference's, of the median moved leaf:
               the direction of the update, which the norms above cannot
               see (an update of the opposite sign reads about 2, a leaf
               left unmoved 1).
Adam's first update moves every element by about lr * sign(gradient), so
elements whose gradient is at round-off flip between any two runs, the
reference's own included, and the steps after carry that through the
sharp soft rasterizer: the later steps' losses and the worst leaf's
change are noise, not a reading of the step (noisy_readings gives them
for the record).
"""

from __future__ import annotations

import math
import statistics

STILL = 1e-3     # of the median leaf's first gradient: moved by round-off


def _gap(prog, ref, leaves):
    med = statistics.median(ref[n] for n in leaves)
    worst, where = 0.0, None
    for n in leaves:
        p = prog.get(n, 0.0)
        gap = abs(p - ref[n]) / max(ref[n], med, 1e-30)
        if not math.isfinite(gap):
            return math.inf, n
        if gap > worst:
            worst, where = gap, n
    return worst, where


def _median_gap(prog, ref, leaves):
    med_r = statistics.median(ref[n] for n in leaves)
    med_p = statistics.median(prog.get(n, 0.0) for n in leaves)
    return abs(med_p - med_r) / max(med_r, 1e-30)


def _moved(ref):
    leaves = sorted(ref["grad1"])
    med = statistics.median(ref["grad1"][n] for n in leaves)
    return leaves, [n for n in leaves if ref["grad1"][n] >= STILL * med]


def _cosine(a, b):
    """The cosine between two tensors; 0 where either is all zeros."""
    a, b = a.double().flatten(), b.double().flatten()
    den = float(a.norm() * b.norm())
    return float(a @ b) / den if den > 0 else 0.0


def gaps(prog, ref):
    """{name: (value, what it was read at)} of the numbers."""
    loss1 = math.inf
    if prog["loss"] and math.isfinite(prog["loss"][0]):
        loss1 = abs(prog["loss"][0] - ref["loss"][0]) / max(
            abs(ref["loss"][0]), 1e-30)
    leaves, moved = _moved(ref)
    grad1, at_g = _gap(prog["grad1"], ref["grad1"], leaves)
    med = statistics.median(ref["grad1"][n] for n in leaves)
    grad1_median = statistics.median(
        abs(prog["grad1"].get(n, 0.0) - ref["grad1"][n])
        / max(ref["grad1"][n], med, 1e-30) for n in leaves)
    delta = _median_gap(prog["delta"], ref["delta"], moved)
    cos = statistics.median(
        _cosine(prog["change"][n], ref["change"][n]) if n in prog["change"]
        else 0.0 for n in moved)
    return {"loss1_gap": (loss1, "first step's total loss"),
            "grad1_gap": (grad1, at_g),
            "grad1_median_gap": (grad1_median, "median leaf"),
            "delta_gap": (delta, f"median of {len(moved)} moved leaves"),
            "delta_cos_gap": (1.0 - cos,
                              f"median of {len(moved)} moved leaves")}


def noisy_readings(prog, ref):
    """The readings left uncompared: each step's loss gap, the worst
    moved leaf's change and its least cosine, and delta_cos_gap."""
    _, moved = _moved(ref)
    cos = {n: _cosine(prog["change"][n], ref["change"][n]) for n in moved
           if n in prog["change"]}
    least = min(cos, key=cos.get, default=None)
    return {"loss_gaps": [abs(p - r) / max(abs(r), 1e-30)
                          for p, r in zip(prog["loss"], ref["loss"])],
            "delta_worst_leaf": _gap(prog["delta"], ref["delta"], moved),
            "delta_cos_gap": 1.0 - statistics.median(cos.values()),
            "delta_cos_least_leaf": [cos.get(least), least],
            "loss": prog["loss"], "ref_loss": ref["loss"]}


def checks(prog, ref, limits):
    """{name: {"value", "limit", "at"}} of the numbers the cell's limits
    name, in the order the run prints; the others are readings only."""
    return {name: {"value": v if math.isfinite(v) else 1e30,
                   "limit": limits[name], "at": at}
            for name, (v, at) in gaps(prog, ref).items() if name in limits}
