"""Keypoint-transfer PCK on viewpoint-separated pairs (port of
tools/eval_kp_pairs.py).

Uniformly drawn test pairs of the synthetic category often share
near-canonical keypoint layouts, which inflates the identity-transfer
baseline. This evaluates a finished run's stage-2 checkpoint on pairs
whose ground-truth cameras (the npz's cam) differ by at least
--min_angle_deg of rotation, with synthetic_parity's protocol otherwise
(test_kp.run, the same PCK scaling). Writes
<run>/kp_hard_<angle>deg.json.

  python -m umr_tpu_torch.experiments.eval_kp_pairs --run <run> \\
      --min_angle_deg 30
"""

from __future__ import annotations

import argparse
import json
import os.path as osp

import numpy as np

from .synthetic_parity import KP_PAIR_SEED, identity_pck, pair_keypoints


def quat_angle_deg(q1, q2):
    """Relative rotation angle between unit quaternions, degrees."""
    d = np.abs((q1 * q2).sum(-1)).clip(0.0, 1.0)
    return np.degrees(2.0 * np.arccos(d))


def hard_pair_orders(cams, n_pairs, min_angle_deg, seed=KP_PAIR_SEED):
    """Deterministic pairs, with replacement and without self-pairs, drawn
    from those whose ground-truth relative rotation is >= min_angle_deg;
    returns (o1, o2, their mean angle)."""
    n = cams.shape[0]
    q = cams[:, 3:7] / np.linalg.norm(cams[:, 3:7], axis=-1, keepdims=True)
    ang = quat_angle_deg(q[:, None, :], q[None, :, :])
    i, j = np.where((ang >= min_angle_deg) & ~np.eye(n, dtype=bool))
    if i.size == 0:
        raise SystemExit(
            f"no pairs with relative rotation >= {min_angle_deg} deg "
            f"(max available: {ang[~np.eye(n, dtype=bool)].max():.1f})")
    rng = np.random.RandomState(seed)
    pick = rng.randint(0, i.size, size=n_pairs)
    return i[pick], j[pick], float(ang[i[pick], j[pick]].mean())


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--run", default="cachedir/synparity_r6",
                    help="finished synthetic_parity / extend_s2 run dir")
    ap.add_argument("--min_angle_deg", type=float, default=30.0)
    ap.add_argument("--n_pairs", type=int, default=200)
    ap.add_argument("--modes", default="flow,cam")
    ap.add_argument("--device", default=None,
                    help="the card unless 'cpu'")
    args = ap.parse_args(argv)

    run = osp.abspath(args.run)
    test = dict(np.load(osp.join(run, "test.npz")))

    from ..config import Config, resolve_device
    from ..data.synthetic_category import PairLoader
    from . import test_kp

    device = resolve_device(args.device)
    o1, o2, mean_ang = hard_pair_orders(
        test["cam"], args.n_pairs, args.min_angle_deg)
    id1, id15 = identity_pck(pair_keypoints(test, o1, o2))
    out = {
        "run": run, "min_angle_deg": args.min_angle_deg,
        "n_pairs": args.n_pairs, "mean_pair_angle_deg": round(mean_ang, 1),
        "pck_identity_0.1": round(id1, 4),
        "pck_identity_0.15": round(id15, 4),
    }

    S = int(test["img"].shape[1])
    s2_pth = osp.join(run, "snap", "s2", "pred_net_latest.pth")
    common = dict(
        image_size=S, img_size=S, batch_size=16,
        checkpoint_dir=osp.join(run, "snap"),
        stemp_path=osp.join(run, "stemp"),
        model_path=s2_pth, split="test", number_pairs=args.n_pairs,
    )
    for mode in args.modes.split(","):
        cfg = Config(**common, name=f"kp_hard_{mode}", mode=mode)
        pck1, pck15 = test_kp.run(
            cfg, loaders=(PairLoader(test, o1), PairLoader(test, o2)),
            device=device)
        out[f"pck_{mode}_0.1"] = round(pck1, 4)
        out[f"pck_{mode}_0.15"] = round(pck15, 4)

    path = osp.join(run, f"kp_hard_{int(args.min_angle_deg)}deg.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
