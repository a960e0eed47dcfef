"""The kernel yardstick's pieces on the CPU: step_renders records the
renders a training step draws on the kernels' route (driven here through
the kernels' plain versions, impl="kernel"), raster_bound charges each
branch's operations to the pairs that reach it, and raster_bench reads
outputs and SASS across builds."""

import numpy as np
import pytest
import torch

from umr_tpu_torch.config import Config
from umr_tpu_torch.data import synthetic_batch
from umr_tpu_torch.experiments import raster_bench
from umr_tpu_torch.experiments.raster_bound import (OPS_BOX, OPS_DIST,
                                                    PEAK_FLOPS, block_steps,
                                                    pair_counts, raster_bound)
from umr_tpu_torch.losses.composite import PartMatchingLoss
from umr_tpu_torch.mesh import build_template
from umr_tpu_torch.ops import raster_kernel
from umr_tpu_torch.ops.raster_bins import compute_raster_bins
from umr_tpu_torch.renderer import SoftRenderer
from umr_tpu_torch.training import steps
from umr_tpu_torch.training.trainer import prepare_batch

IMG = 32
B = 2
KW = dict(image_size=IMG, img_size=IMG, batch_size=B, anti_aliasing=False,
          subdivide=2, tex_size=2, nz_feat=32, z_dim=24)


def _s2_step():
    cfg = Config(**KW, num_hypo_cams=2)
    template = build_template(2, 1, 2)
    rng = np.random.RandomState(5)
    seg = rng.randint(0, 5, size=(16, 32)).astype(np.float32)
    idx = rng.permutation(template.num_verts)
    pvi = [idx[0:20], idx[20:60], idx[60:80], idx[80:120]]
    pr = SoftRenderer(image_size=IMG, anti_aliasing=False,
                      ambient_intensity=1.0, directional_intensity=0.0,
                      impl="kernel")
    pl = PartMatchingLoss.build(seg, template.uv_sampler,
                                template.num_sym_faces, pr, tex_size=2)
    *_, init_fn, step_fn = steps.build_s2_step(cfg, template, pl, pvi, "cpu",
                                               impl="kernel")
    return cfg, template, init_fn(0), step_fn


def test_step_renders_records_the_s2_step():
    cfg, template, state, step_fn = _s2_step()
    F = template.faces.shape[0]
    db = prepare_batch(synthetic_batch(np.random.RandomState(1), B, IMG))
    with raster_bench.step_renders(raster_bench.S2_RENDERS) as got:
        step_fn(state, db)
    assert raster_kernel._Raster.__name__ == "_Raster"
    fold, hard, merged = (got[k] for k in raster_bench.S2_RENDERS)
    K = cfg.num_hypo_cams
    assert fold["fv"].shape == (B * K, F, 3, 3)
    assert fold["bwd"] == dict(mask_only=False, rgb_geom_detach=True,
                               tex_grads=True)
    assert hard["kw"]["aggr_func_rgb"] == "hard" and hard["bwd"] is None
    assert merged["bwd"]["tex_grads"] is False
    assert merged["fv"].shape[0] % B == 0 and merged["fv"].shape[0] > B
    for r in got.values():
        assert r["kw"]["image_size"] == IMG
        assert not r["fv"].requires_grad
    # a recorded render replays through the same route, and carries the
    # bins the card's route gives it
    out = raster_bench.render_fwd(hard)
    assert out.rgba.shape == (B, IMG, IMG, 4)
    for r in got.values():
        counts, fwd, bwd = raster_bench.render_bounds(r)
        assert counts[0] >= counts[1] >= counts[2] >= counts[3] > 0
        assert fwd[0] > 0 and (bwd is None) == (r is hard)


def test_step_renders_records_the_s1_step():
    from umr_tpu_torch.cli import S1_DEFAULTS

    cfg = Config(**KW, **S1_DEFAULTS)
    template = build_template(2, 1, 2)
    *_, init_fn, step_fn, _, _ = steps.build_s1_step(cfg, template, "cpu",
                                                     impl="kernel")
    db = prepare_batch(synthetic_batch(np.random.RandomState(2), B, IMG))
    with raster_bench.step_renders(raster_bench.S1_RENDERS) as got:
        step_fn(init_fn(0), db)
    fused, hard, gan = (got[k] for k in raster_bench.S1_RENDERS)
    assert fused["kw"]["need_p2f"] and fused["bwd"]["rgb_geom_detach"]
    assert hard["bwd"] is None
    # the fused render and the hard pass share their bins
    for a, b in zip(fused["bins"], hard["bins"]):
        assert a is b
    assert gan["bwd"]["mask_only"] and gan["kw"]["mask_only"]
    assert not gan["kw"]["need_p2f"]


def test_step_renders_counts_the_renders():
    """A block that draws another number of renders than labelled fails,
    and the Function is restored."""
    fv = torch.zeros((1, 1, 3, 3))
    with pytest.raises(AssertionError):
        with raster_bench.step_renders(("a", "b")):
            raster_kernel.soft_rasterize_fwd(fv, image_size=IMG)
    assert raster_kernel._Raster.__name__ == "_Raster"


@pytest.mark.parametrize("opts", [{"rgb_geom_detach": True},
                                  {"tex_grads": False}, {"mask_only": True}])
def test_backward_bound_charges_the_bbox_test_on_bbox_pairs(opts):
    """The backward walks each face's pixel rectangle: its bound does not
    grow with the binned slots, and charges the bbox test on the pairs in
    the bbox. So does the forward's (see the test below)."""
    fv = torch.zeros((2, 8, 3, 3))
    tex = torch.zeros((2, 8, 4, 3))
    bins = (torch.zeros((2, 64), dtype=torch.int32),
            torch.zeros((2, 5), dtype=torch.int32))
    counts = [10**9, 2 * 10**8, 10**8, 10**8]
    more_slots = [4 * 10**9] + counts[1:]
    bwd = raster_bound(counts, fv, tex, bins, 64, opts)
    assert bwd == raster_bound(more_slots, fv, tex, bins, 64, opts)
    fewer_box = counts[:1] + [10**8] + counts[2:]
    less = raster_bound(fewer_box, fv, tex, bins, 64, opts)
    assert bwd[0] - less[0] >= 10**8 * OPS_BOX / PEAK_FLOPS * 1e3 * 0.999
    fwd = raster_bound(counts, fv, tex, bins, 64)
    assert raster_bound(more_slots, fv, tex, bins, 64) == fwd


@pytest.mark.parametrize("kind", [{}, {"p2f": True}, {"hard": True}],
                         ids=["softmax", "p2f", "hard"])
def test_forward_bound_charges_the_bbox_test_on_bbox_pairs(kind):
    """The function needs no test outside a face's bbox: the forward's
    bound does not grow with the binned slots, and each pair in a bbox is
    charged the bbox test with the distance code."""
    fv = torch.zeros((2, 8, 3, 3))
    tex = torch.zeros((2, 8, 4, 3))
    bins = (torch.zeros((2, 64), dtype=torch.int32),
            torch.zeros((2, 5), dtype=torch.int32))
    counts = [10**9, 2 * 10**8, 10**8, 10**8]
    fwd = raster_bound(counts, fv, tex, bins, 64, **kind)
    assert fwd[1] == "operations"
    assert raster_bound([4 * 10**9] + counts[1:], fv, tex, bins, 64,
                        **kind) == fwd
    less = raster_bound(counts[:1] + [10**8] + counts[2:], fv, tex, bins, 64,
                        **kind)
    assert fwd[0] - less[0] == pytest.approx(
        10**8 * (OPS_BOX + OPS_DIST) / PEAK_FLOPS * 1e3)


def _out(rgba, aggr, p2f):
    return raster_kernel.RasterOut(rgba=rgba, aggr=aggr, p2f=p2f)


def test_compare_outputs_across_builds():
    """The readings raster_bench prints beside each build's times: max
    |diff| of rgba, aggr and p2f against the first build, and for the hard
    body the share of covered pixels whose face id and depth agree."""
    g = torch.Generator().manual_seed(0)
    rgba = torch.rand((2, 8, 8, 4), generator=g)
    depth = 1.0 + torch.rand((2, 8, 8), generator=g)
    fid = torch.randint(0, 5, (2, 8, 8), generator=g).float()
    fid[0, :2] = -1.0                                  # 16 uncovered pixels
    depth[fid < 0] = 1e7
    aggr = torch.stack([depth, fid], 1)
    p2f = torch.rand((2, 5, 2), generator=g)
    ref = _out(rgba, aggr, p2f)
    same = raster_bench.compare_outputs(ref, _out(rgba.clone(), aggr.clone(),
                                                  p2f.clone()), hard=True)
    assert same == dict(rgba=0.0, aggr=0.0, p2f=0.0, hard_equal=1.0)
    # one covered pixel's winner differs; an uncovered one does not count
    a2 = aggr.clone()
    a2[1, 1, 3, 4] += 1.0
    a2[0, 0, 0, 0] = 3.0
    rg2 = rgba.clone()
    rg2[0, 5, 5, 1] += 0.25
    p2 = p2f.clone()
    p2[1, 2, 0] -= 1e-3
    d = raster_bench.compare_outputs(ref, _out(rg2, a2, p2), hard=True)
    assert d["rgba"] == pytest.approx(0.25)
    assert d["aggr"] == pytest.approx(1e7 - 3.0)
    assert d["p2f"] == pytest.approx(1e-3, rel=1e-3)
    assert d["hard_equal"] == pytest.approx(1.0 - 1.0 / (128 - 16))
    soft = raster_bench.compare_outputs(ref, _out(rg2, a2, p2), hard=False)
    assert soft["hard_equal"] is None and soft["rgba"] == d["rgba"]


def test_shared_atomics_from_sass():
    """cuobjdump -sass text: each kernel's shared-memory atomics, by
    opcode, under its short name; a kernel without any maps to {}."""
    sass = """
	code for sm_90a
		Function : _ZN12_GLOBAL__N_117raster_fwd_kernelILb0ELb0ELb1EEEvPKfS2_PKiS4_PfS5_S5_N3umr6ParamsE
	.headerflags	@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS"
        /*0010*/                   FADD R1, R2, R3 ;
        /*0020*/                   ATOMS.CAST.SPIN P0, [R2], R4, R5 ;
        /*0030*/                   ATOMS.CAST.SPIN P0, [R2+0x4], R4, R5 ;
		Function : _ZN12_GLOBAL__N_117raster_bwd_kernelILb1ELb0EEEvPKfS2_PKiS4_S2_S2_S2_PfS5_N3umr6ParamsE
        /*0010*/                   ATOMS.ADD R3, [UR4], R0 ;
        /*0020*/                   RED.E.ADD.F32.FTZ.RN.STRONG.GPU [R2.64], R5 ;
		Function : _ZN12_GLOBAL__N_117raster_fwd_kernelILb1ELb0ELb0EEEvPKfS2_PKiS4_PfS5_S5_N3umr6ParamsE
        /*0010*/                   RED.E.ADD.F32.FTZ.RN.STRONG.GPU [R2.64], R5 ;
"""
    assert raster_bench.shared_atomics(sass) == {
        "raster_fwd_kernel<0,0,1>": {"ATOMS.CAST.SPIN": 2},
        "raster_bwd_kernel<1,0>": {"ATOMS.ADD": 1},
        "raster_fwd_kernel<1,0,0>": {},
    }


def test_block_steps_hold_the_bbox_pairs():
    """The forward's walk visits every pair in a bbox: 32 lanes per block
    step cover the pairs in the bbox, and the steps cover no more than the
    binned slots; a degenerate face takes none."""
    from torch_parity import random_scene

    faces, _ = random_scene(np.random.RandomState(1), B=2, F=40, T2=1)
    faces[:, :5, 2, :2] = faces[:, :5, 0, :2]          # degenerate
    fv = torch.as_tensor(faces)
    kw = dict(S=64, cap=64, sigma_val=3e-3, dist_eps=1e-4)
    bins = compute_raster_bins(fv, 64, raster_kernel.TILE_SIZE, 3e-3, 1e-4,
                               64, raster_kernel.MAX_COVER, 16 * 40 + 32)
    slots, box, _, _ = pair_counts(fv, bins, **kw)
    steps = block_steps(fv, bins, **kw)
    assert box <= 32 * steps <= slots
    assert block_steps(fv[:, :5].contiguous(), compute_raster_bins(
        fv[:, :5].contiguous(), 64, raster_kernel.TILE_SIZE, 3e-3, 1e-4, 64,
        raster_kernel.MAX_COVER, 16 * 5 + 32), **kw) == 0
