"""The benchmark's yardstick on the CPU: the shape-based operation count
against torch's own count of the same layers, the bin-free render count
against a brute-force count over every (pixel, face) pair, the 95th
percentile over all steps, and the attribution of device time by range
and by kernel name on a recorded trace.

  python -m pytest umr_bench -q
"""

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from umr_bench import harness, traceutil, workcount
from umr_bench.reference import nets
from umr_bench.reference.raster import (face_info, pair_counts, pair_math,
                                        threshold_of)
from umr_bench.reference.template import build_template

CFG = {"image_size": 64, "nz_feat": 20, "z_dim": 30, "num_hypo_cams": 3}


def _counted(fn):
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


@pytest.mark.parametrize("stage", [1, 2])
def test_model_operations_match_torch_count(stage):
    t = build_template(1, 1, 2)
    B = 3
    if stage == 2:
        model = nets.MeshNet(t, CFG["image_size"], CFG["nz_feat"],
                             CFG["z_dim"], CFG["num_hypo_cams"])
    else:
        model = nets.MeshNetS1(t, CFG["image_size"], CFG["nz_feat"],
                               CFG["z_dim"])
    model.train()
    img = torch.rand(B, CFG["image_size"], CFG["image_size"], 3)
    gen = torch.Generator().manual_seed(0)

    def step():
        out = model(img, gen)
        loss = sum(v.float().sum() for k, v in out.items()
                   if k in ("delta_v", "tex_flow", "cam"))
        if stage == 2:
            loss = (loss + out["cam_hypotheses"].sum()
                    + (out["cam_probs"] ** 2).sum())
        loss.backward()

    want = workcount.mesh_net(CFG, stage, t.num_output,
                              t.uv_image_size()).flops(B)
    # torch also counts the heads' few non-layer matmuls (none here) and
    # nothing of the elementwise work: the two counts agree exactly
    assert _counted(step) == want


def test_lpips_and_discriminator_operations_match_torch_count():
    S, N = 64, 4
    lp = nets.LPIPSAlex()
    a = torch.rand(N, S, S, 3, requires_grad=True)
    b = torch.rand(N, S, S, 3)
    assert _counted(lambda: lp(a, b).sum().backward()) == \
        workcount.lpips_alex(S).flops(N, n_fwd=2 * N)
    disc = nets.Discriminator(0.2, 3, S)
    # autograd takes the first conv's input gradient for the whole
    # batch; the step needs it for the fake half (step_flops)
    imgs = torch.rand(2 * N, S, S, 3, requires_grad=True)
    L = workcount.discriminator(S, 3)
    want = L.flops(2 * N) + 2 * L.rows[0][0] * 2 * N
    assert _counted(lambda: disc(imgs).sum().backward()) == want


def test_render_pair_count_matches_brute_force():
    torch.manual_seed(0)
    t = build_template(1, 1, 2)
    B, S = 2, 48
    v = torch.as_tensor(t.verts)[None].repeat(B, 1, 1) * 0.7
    v = v + 0.05 * torch.randn_like(v)
    v[1] = v[1] * 1.6                  # faces wider than a tile, some off
    fv = v[:, torch.as_tensor(t.faces).long()]
    fv[..., 2] += 7.7
    thr, margin = threshold_of(1e-5, 1e-4)
    # every (pixel, face) pair at once
    fi = face_info(fv[..., 0], fv[..., 1], fv[..., 2])
    ar = torch.arange(S, dtype=torch.float32)
    xp = ((2.0 * ar + 1.0 - S) / S).repeat(S)[None, None]
    yp = ((2.0 * (S - 1 - ar) + 1.0 - S) / S).repeat_interleave(S)[
        None, None]
    pm = pair_math(fi, fi["nondegen"], xp, yp, thr, margin, 1e5)
    brute = [int(pm["in_box"].sum()), int(pm["valid"].sum()),
             int((pm["valid"] & pm["z_ok"]).sum())]
    assert brute[0] > 0 and brute[1] > 0
    assert pair_counts(fv, S, 1e-5, 1e-4) == brute


def test_render_work_is_larger_of_two_roofs():
    ops, nbytes = workcount.render_work((1000, 400, 300), 2, 64, 20, 36)
    assert ops == 1000 * 138 + 400 * (26 + 4 + 18) + 300 * 14
    t, by = workcount.least_seconds(ops, nbytes)
    assert t == max(ops / 67e12, nbytes / 3.35e12)
    assert by == ("operations" if ops / 67e12 >= nbytes / 3.35e12
                  else "bytes")


def test_p95_is_over_all_steps():
    values = list(range(1, 201))           # 200 steps
    assert harness.p95(values) == pytest.approx(np.percentile(values, 95))
    assert harness.p95(values) == pytest.approx(190.05)
    # one slow step in twenty moves it, as a median of chunks would not
    slow = [10.0] * 190 + [100.0] * 10
    assert harness.p95(slow) > 10.0


def _event(cat, name, ts, dur, corr=None):
    e = {"cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_attribution_by_range_and_kernel_name():
    events = [
        _event("user_annotation", "s2.forward", 0, 100),
        _event("user_annotation", "s2.model", 10, 30),
        _event("cuda_runtime", "cudaLaunchKernel", 15, 1, corr=1),
        _event("cuda_runtime", "cudaLaunchKernel", 60, 1, corr=2),
        _event("cuda_runtime", "cudaLaunchKernel", 150, 1, corr=3),
        _event("kernel", "conv_kernel", 20, 40, corr=1),
        _event("kernel", "raster_fwd_kernel", 70, 20, corr=2),
        _event("kernel", "conv_kernel", 160, 10, corr=3),
        _event("kernel", "orphan", 200, 5, corr=9),
    ]
    split = traceutil.range_split(events, "s2.", steps=1)
    assert split == pytest.approx({"s2.model": 0.040, "s2.forward": 0.020,
                                   "outside": 0.010, "unmatched": 0.005})
    ops = traceutil.device_ops(events)
    assert traceutil.by_name(ops) == [("conv_kernel", 50.0),
                                      ("raster_fwd_kernel", 20.0),
                                      ("orphan", 5.0)]
    assert traceutil.busy_us(ops) == 75.0
    gaps = dict(traceutil.idle_gaps(ops, events, 0.0, 210.0))
    assert sum(gaps.values()) == pytest.approx(210.0 - 75.0)
    # 0..20 and 90..160 begin inside s2.forward (s2.model opens at 10),
    # 60..70 inside a launch call, 170..200 and 205..210 outside all
    assert gaps == pytest.approx({"s2.forward": 90.0,
                                  "cudaLaunchKernel": 10.0,
                                  "host idle": 35.0})


def test_busy_time_merges_overlaps():
    ops = [("a", 0.0, 10.0), ("b", 5.0, 10.0), ("c", 30.0, 5.0)]
    assert traceutil.busy_us(ops) == 20.0
