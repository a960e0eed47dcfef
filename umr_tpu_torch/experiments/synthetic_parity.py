"""End-to-end capability run on the synthetic bird category (port of
tools/synthetic_parity.py): the real curriculum, train_s1 (with online
template updates) -> avg_uv -> train_s2 -> test_iou + test_kp, on a
rendered dataset with known ground truth (data/synthetic_category.py)
and a held-out split, in one process on the card.

Bars (the JAX package's, recorded in its CAPABILITY_r05.json):
  - all 4 template parts >= 2% of the template's vertices;
  - stage 2's corr_loss live (median of its last 20 logged values > 0);
  - held-out mask IoU >= 0.7 (and well above the area prior);
  - keypoint-transfer PCK@0.1 (flow or cam mode) above the identity
    transfer on the same deterministic pairs.

  python -m umr_tpu_torch.experiments.synthetic_parity --out <dir> \\
      --train_n 384 --test_n 64 --s1_iters 1500 --s2_iters 2500 \\
      --display_freq 0 --save_freq 500

Re-runs resume: the datasets are cached as npz, each training stage
auto-resumes from its pred_state.pt, and finished stages are skipped.
summary.json is rewritten after every stage. The train split is staged
on the card once (~1.0 GB at n=384), and every stage's loader indexes
that copy.
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import re
import time

import numpy as np

from ..mesh import build_template

# the s1 texture flow's health before avg_uv: the median of the last 20
# logged uv_flow_area values (the share of a 16x16 image grid the UV flow
# samples; ground-truth flow ~0.2-0.4, a collapsed flow < 0.02)
FLOW_AREA_BAR = 0.10
MAX_S1_ATTEMPTS = 4
KP_PAIR_SEED = 303


def get_or_make_dataset(path, template, n, seed, image_size, device=None):
    """The npz at `path` when it holds n samples, else generate_dataset's
    (rendered on `device`), saved there."""
    if osp.exists(path):
        d = dict(np.load(path))
        if d["img"].shape[0] == n:
            return d
        print(f"cached {path} has {d['img'].shape[0]} != {n}; regenerating")
    from ..data.synthetic_category import generate_dataset

    t0 = time.perf_counter()
    stats = {}
    d = generate_dataset(template, n, seed=seed, image_size=image_size,
                         device=device, stats=stats)
    gen_s = time.perf_counter() - t0
    np.savez_compressed(path, **d)
    print(f"generated {n} samples -> {path} ({gen_s:.1f} s; renders "
          f"{sum(stats['render_s']):.1f} s; projected vertices inside the "
          f"masks: min {min(stats['verts_inside']):.4f} over "
          f"{len(stats['verts_inside'])} batches)", flush=True)
    return d


def identity_pck(pairs_kp, padding_frac=0.05):
    """PCK@0.1 and @0.15 of the identity transfer (the source location
    predicted unchanged) over [N,2,K,3] pair keypoints: the chance
    baseline."""
    scale = (1 + 2 * padding_frac) / 2.0
    errs, vis = [], []
    for kp in pairs_kp:
        vis.append((kp[0, :, 2] * kp[1, :, 2])[None].repeat(2, 0))
        e = np.stack([kp[1, :, :2] - kp[0, :, :2],
                      kp[0, :, :2] - kp[1, :, :2]])
        errs.append(np.sqrt((e ** 2).sum(-1)) * scale)
    errs = np.concatenate(errs)
    vis = np.concatenate(vis)
    nv = vis.sum(0)
    return (
        float((((errs < 0.1) * vis).sum(0) / nv).mean()),
        float((((errs < 0.15) * vis).sum(0) / nv).mean()),
    )


def last_scalar_median(log_path, key, k=20):
    """The median of the last k values of `key` in a loss_log.txt, or None
    when it has none."""
    vals = []
    if osp.exists(log_path):
        with open(log_path) as f:
            for line in f:
                m = re.search(rf"{key}: ([0-9.eE+-]+)", line)
                if m:
                    vals.append(float(m.group(1)))
    return float(np.median(vals[-k:])) if vals else None


def parse_overrides(pairs):
    """["K=V", ...] -> {K: V}: V parsed as JSON (True/False as true/false),
    else kept as a string."""
    out = {}
    for kv in pairs:
        k, v = kv.split("=", 1)
        try:
            out[k] = json.loads(v.lower() if v in ("True", "False") else v)
        except json.JSONDecodeError:
            out[k] = v
    return out


def pair_keypoints(test, o1, o2):
    """[N,2,K,3] ground-truth keypoints of the pairs (o1[i], o2[i])."""
    return [np.stack([test["kp"][i], test["kp"][j]]) for i, j in zip(o1, o2)]


def common_config(out, S, batch, save_freq, display_freq):
    """The Config fields every stage of a run in `out` shares."""
    return dict(
        image_size=S, img_size=S, batch_size=batch,
        checkpoint_dir=osp.join(out, "snap"),
        vis_dir=osp.join(out, "vis"),
        results_vis_dir=osp.join(out, "rvis"),
        num_epochs=100000, save_latest_freq=save_freq,
        save_epoch_freq=100000,
        print_freq=20, display_freq=display_freq,
        stemp_path=osp.join(out, "stemp"),
    )


def evaluate(summary, save_summary, common, test, s2_pth, n_pairs, batch,
             device, full=True):
    """test_iou on the held-out split and test_kp in flow and cam mode on
    KP_PAIR_SEED's pairs, into `summary` (saved after each); full adds
    the IoU's area prior and test_kp's wall times. Returns the identity
    transfer's PCK@0.1."""
    from ..config import Config
    from ..data.synthetic_category import (CategoryLoader, PairLoader,
                                           make_pair_orders)
    from . import test_iou, test_kp

    cfg_iou = Config(**common, name="iou", use_scops=False,
                     model_path=s2_pth, split="test")
    test_loader = CategoryLoader(test, batch, shuffle=False,
                                 use_scops=False, drop_last=False,
                                 device_data=True, device=device)
    iou = test_iou.run(cfg_iou, dataloader=test_loader, device=device)
    summary["test_iou"] = round(float(iou), 4)
    if full:
        # predicting the mean ground-truth mask everywhere scores the
        # area prior; a reconstructor must beat it by a wide margin
        summary["iou_area_prior"] = round(float(test["mask"].mean()), 4)
    save_summary()

    o1, o2 = make_pair_orders(test["img"].shape[0], n_pairs,
                              seed=KP_PAIR_SEED)
    id1, id15 = identity_pck(pair_keypoints(test, o1, o2))
    summary["pck_identity_0.1"] = round(id1, 4)
    summary["pck_identity_0.15"] = round(id15, 4)
    for mode in ("flow", "cam"):
        cfg_kp = Config(**common, name=f"kp_{mode}", use_scops=False,
                        model_path=s2_pth, split="test", mode=mode,
                        number_pairs=n_pairs)
        t0 = time.perf_counter()
        pck1, pck15 = test_kp.run(
            cfg_kp, loaders=(PairLoader(test, o1), PairLoader(test, o2)),
            device=device)
        summary[f"pck_{mode}_0.1"] = round(pck1, 4)
        summary[f"pck_{mode}_0.15"] = round(pck15, 4)
        if full:
            summary[f"kp_{mode}_wall_s"] = round(time.perf_counter() - t0, 1)
        save_summary()
    return id1


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="cachedir/synparity")
    ap.add_argument("--train_n", type=int, default=384)
    ap.add_argument("--test_n", type=int, default=64)
    ap.add_argument("--image_size", type=int, default=256)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--s1_iters", type=int, default=600)
    ap.add_argument("--s2_iters", type=int, default=1500)
    ap.add_argument("--n_pairs", type=int, default=200)
    ap.add_argument("--display_freq", type=int, default=200,
                    help="training-visuals cadence (the port's trainer "
                    "writes no visuals)")
    ap.add_argument("--save_freq", type=int, default=200,
                    help="save_latest_freq of the training stages")
    ap.add_argument("--skip_train", action="store_true",
                    help="evaluate existing checkpoints only")
    ap.add_argument("--s2_set", action="append", default=[], metavar="K=V",
                    help="stage-2 Config override (repeatable), e.g. "
                    "cycle_soft_p2f=True; parsed as JSON, falls back to "
                    "string")
    ap.add_argument("--device", default=None,
                    help="the card unless 'cpu'")
    args = ap.parse_args(argv)
    s2_overrides = parse_overrides(args.s2_set)

    from ..config import Config, resolve_device
    from ..data.synthetic_category import CategoryLoader, stage
    from . import avg_uv, train_s1, train_s2

    device = resolve_device(args.device)
    out = osp.abspath(args.out)
    os.makedirs(out, exist_ok=True)
    S = args.image_size
    template = build_template(3, 1, 6)

    train = get_or_make_dataset(osp.join(out, "train.npz"), template,
                                args.train_n, 0, S, device)
    test = get_or_make_dataset(osp.join(out, "test.npz"), template,
                               args.test_n, 1, S, device)
    print(f"mask coverage: train {train['mask'].mean():.3f} "
          f"test {test['mask'].mean():.3f}")
    train_dev = stage(train, device)

    common = common_config(out, S, args.batch, args.save_freq,
                           args.display_freq)
    summary = {"train_n": args.train_n, "test_n": args.test_n,
               "image_size": S}

    def save_summary():
        """Stage-wise durability: a killed run leaves a partial summary."""
        with open(osp.join(out, "summary.json"), "w") as f:
            json.dump(summary, f, indent=1)

    save_summary()

    # ---- stage 1 + avg_uv, with a dead-template retry ---------------------
    # A weak s1 texture flow (UV pixels all sampling near the image centre)
    # collapses the averaged UV part map. Two gates defend the handoff:
    #   1. flow health before avg_uv: uv_flow_area must clear
    #      FLOW_AREA_BAR, else s1 is extended first (avg_uv skipped);
    #   2. the liveliness bar after avg_uv: all 4 parts >= 2% of the
    #      template's vertices.
    s1_pth = osp.join(out, "snap", "s1", "pred_net_latest.pth")
    s1_log = osp.join(out, "snap", "s1", "loss_log.txt")
    stemp = osp.join(out, "stemp")
    summary["s1_wall_s"] = summary["avg_uv_wall_s"] = 0.0
    template_ok = False
    min_cnt = max(1, int(np.ceil(0.02 * template.num_verts)))
    for attempt in range(MAX_S1_ATTEMPTS):
        s1_iters = args.s1_iters * (attempt + 1)
        cfg1 = Config(**common, name="s1", use_scops=False,
                      mask_loss_wt=3.0, flatten_reg_wt=0.0004,
                      deform_reg_wt=5.0, tex_cycle_loss_wt=0.5,
                      num_iter=s1_iters)
        t0 = time.perf_counter()
        if not args.skip_train:
            train_s1.run(cfg1, dataloader=CategoryLoader(
                train, args.batch, seed=10, use_scops=False,
                staged=train_dev), device=device)
        summary["s1_wall_s"] += round(time.perf_counter() - t0, 1)
        assert osp.exists(s1_pth), s1_pth
        flow_area = last_scalar_median(s1_log, "uv_flow_area")
        summary["s1_uv_flow_area"] = flow_area
        summary["s1_iters_used"] = s1_iters
        save_summary()
        if (not args.skip_train and flow_area is not None
                and flow_area < FLOW_AREA_BAR
                and attempt < MAX_S1_ATTEMPTS - 1):
            print(f"s1 flow health {flow_area:.3f} < {FLOW_AREA_BAR}; "
                  f"extending s1 to {args.s1_iters * (attempt + 2)} "
                  "iters before paying for avg_uv")
            continue

        cfg_uv = Config(**common, name="uv", use_scops=True,
                        model_path=s1_pth, out_dir=stemp)
        t0 = time.perf_counter()
        if not (args.skip_train and osp.exists(osp.join(
                stemp, "semantic_seg.png"))):
            avg_uv.run(cfg_uv, dataloader=CategoryLoader(
                train, args.batch, shuffle=False, use_scops=True,
                staged=train_dev), device=device)
        summary["avg_uv_wall_s"] += round(time.perf_counter() - t0, 1)
        # the semantic losses are live only if every part clears the bar
        summary["part_vertex_counts"] = {
            p: int(np.load(osp.join(stemp, f"{p}_vertices.npy")).size)
            for p in ("head", "neck", "back", "belly")}
        save_summary()
        pvc = summary["part_vertex_counts"]
        template_ok = all(c >= min_cnt for c in pvc.values())
        summary["template_ok"] = template_ok
        save_summary()
        if template_ok or args.skip_train:
            break
        print(f"dead semantic template {pvc} (bar: all >= {min_cnt}); "
              f"extending s1 to {args.s1_iters * (attempt + 2)} iters "
              "and retrying avg_uv")

    if not (template_ok or args.skip_train):
        # stop and say so: train_s2 would refuse the template anyway
        summary["failed"] = "semantic template never cleared the bar"
        save_summary()
        print(json.dumps(summary))
        raise SystemExit(
            f"ABORT: {summary['failed']} after {MAX_S1_ATTEMPTS} attempts "
            f"({summary.get('part_vertex_counts')})")

    # ---- stage 2 ---------------------------------------------------------
    # stage 2 trains fresh (the trunk from weights/) and takes only mean_v
    # and the part labels from the semantic template
    cfg2 = Config(**common, name="s2", use_scops=True,
                  num_iter=args.s2_iters, **s2_overrides)
    summary["s2_overrides"] = s2_overrides
    s2_pth = osp.join(out, "snap", "s2", "pred_net_latest.pth")
    t0 = time.perf_counter()
    if not args.skip_train:
        train_s2.run(cfg2, dataloader=CategoryLoader(
            train, args.batch, seed=20, use_scops=True, staged=train_dev),
            device=device)
    summary["s2_wall_s"] = round(time.perf_counter() - t0, 1)
    assert osp.exists(s2_pth), s2_pth
    # the semantic objective was exercised only if corr_loss stayed live
    corr = last_scalar_median(osp.join(out, "snap", "s2", "loss_log.txt"),
                              "corr_loss")
    if corr is not None:
        summary["s2_corr_loss_last20_median"] = round(corr, 4)
        summary["s2_corr_loss_live"] = bool(corr > 0.0)
    save_summary()

    # ---- evals -----------------------------------------------------------
    id1 = evaluate(summary, save_summary, common, test, s2_pth,
                   args.n_pairs, args.batch, device)
    summary["iou_ok"] = bool(summary["test_iou"] >= 0.7)
    summary["pck_ok"] = bool(
        summary["pck_flow_0.1"] > id1 or summary["pck_cam_0.1"] > id1)
    print(json.dumps(summary))
    save_summary()
    return summary


if __name__ == "__main__":
    main()
