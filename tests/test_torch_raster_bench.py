"""The kernel yardstick's pieces on the CPU: step_renders records the
renders a training step draws on the kernels' route (driven here through
the kernels' plain versions, impl="kernel"), and raster_bound charges
each branch's operations to the pairs that reach it."""

import numpy as np
import pytest
import torch

from umr_tpu_torch.config import Config
from umr_tpu_torch.data import synthetic_batch
from umr_tpu_torch.experiments import raster_bench
from umr_tpu_torch.experiments.raster_bound import (OPS_BOX, PEAK_FLOPS,
                                                    raster_bound)
from umr_tpu_torch.losses.composite import PartMatchingLoss
from umr_tpu_torch.mesh import build_template
from umr_tpu_torch.ops import raster_kernel
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
    the bbox. The forward tests every slot."""
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
    assert raster_bound(more_slots, fv, tex, bins, 64)[0] == pytest.approx(
        fwd[0] + 3 * 10**9 * OPS_BOX / PEAK_FLOPS * 1e3)
