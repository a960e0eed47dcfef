"""Extend a finished synthetic_parity run's stage 2 and evaluate again
(port of tools/extend_s2.py).

Copies snap/s2 and stemp out of a finished run directory (--src, never
modified), resumes train_s2 through the trainer's auto-resume up to
--s2_iters, and runs the same IoU and keypoint-transfer evaluations,
writing its own summary.json into --out. --fresh trains stage 2 from
scratch on the source run's semantic template instead (only stemp is
copied), and --set K=V overrides Config fields: together, controlled
stage-2 ablations on the same s1 / avg_uv artifacts, e.g.

  python -m umr_tpu_torch.experiments.extend_s2 --src <run> \\
      --out <run>_softp2f --fresh --set cycle_soft_p2f=True \\
      --s2_iters 2500
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import shutil
import time

import numpy as np

from .synthetic_parity import common_config, evaluate, parse_overrides


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default="cachedir/synparity_r6")
    ap.add_argument("--out", default="cachedir/synparity_r6_ext")
    ap.add_argument("--s2_iters", type=int, default=5000)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--n_pairs", type=int, default=200)
    ap.add_argument("--save_freq", type=int, default=500)
    ap.add_argument("--fresh", action="store_true",
                    help="train s2 from scratch off the source run's "
                    "semantic template instead of resuming its s2 state")
    ap.add_argument("--set", action="append", default=[], metavar="K=V",
                    help="Config override (repeatable), e.g. "
                    "cycle_soft_p2f=True")
    ap.add_argument("--device", default=None,
                    help="the card unless 'cpu'")
    args = ap.parse_args(argv)
    overrides = parse_overrides(args.set)

    src, out = osp.abspath(args.src), osp.abspath(args.out)
    os.makedirs(osp.join(out, "snap"), exist_ok=True)
    subs = (("stemp",),) if args.fresh else (("snap", "s2"), ("stemp",))
    for sub in subs:
        dst = osp.join(out, *sub)
        if not osp.isdir(dst):
            shutil.copytree(osp.join(src, *sub), dst)

    from ..config import Config, resolve_device
    from ..data.synthetic_category import CategoryLoader
    from . import train_s2

    device = resolve_device(args.device)
    train = dict(np.load(osp.join(src, "train.npz")))
    test = dict(np.load(osp.join(src, "test.npz")))
    S = int(train["img"].shape[1])
    common = common_config(out, S, args.batch, args.save_freq, 0)
    summary = {"src": src, "s2_iters": args.s2_iters,
               "fresh": args.fresh, "overrides": overrides}

    def save_summary():
        with open(osp.join(out, "summary.json"), "w") as f:
            json.dump(summary, f, indent=1)

    # ---- resume stage 2 to the extended iteration count ------------------
    cfg2 = Config(**common, name="s2", use_scops=True,
                  num_iter=args.s2_iters, **overrides)
    s2_pth = osp.join(out, "snap", "s2", "pred_net_latest.pth")
    t0 = time.perf_counter()
    train_s2.run(cfg2, dataloader=CategoryLoader(
        train, args.batch, seed=20, use_scops=True, device_data=True,
        device=device), device=device)
    summary["s2_ext_wall_s"] = round(time.perf_counter() - t0, 1)
    assert osp.exists(s2_pth), s2_pth
    save_summary()

    # ---- evaluations, as synthetic_parity's -------------------------------
    evaluate(summary, save_summary, common, test, s2_pth, args.n_pairs,
             args.batch, device, full=False)
    print(json.dumps(summary))
    save_summary()
    return summary


if __name__ == "__main__":
    main()
