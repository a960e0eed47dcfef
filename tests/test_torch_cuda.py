"""The CUDA rasterizer kernels, forward and backward, against their plain
versions, on the card.

Marked `cuda`: they need an NVIDIA GPU and nvcc, and skip elsewhere (a
CUDA kernel has no CPU mode). Run them on the card with
`python -m pytest tests/test_torch_cuda.py -m cuda -q`; chip_smoke.py
makes the same checks at the main path's shapes.

Tolerances: rgba atol 1e-3 and softmax (sum, max) rtol 1e-4 (the kernel
sums faces in another order); hard-mode face ids and depths equal on
>= 99.9% of covered pixels (the per-pair arithmetic is the plain
version's, rounding for rounding). Backward: gradients within 1e-4
relative plus 1e-5 of the largest gradient (the kernel sums pixels and
tiles in another order, with atomics). p2f: atol 1e-5 in grid units (p2f
lies in [-1, 1]; the kernel sums each face's weights per warp, block and
tile with atomics, in an order that changes run to run)."""

import numpy as np
import pytest
import torch

from torch_parity import random_scene
from umr_tpu_torch.ops import raster_kernel
from umr_tpu_torch.ops.rasterize import soft_rasterize
from umr_tpu_torch.ops.rasterize_bwd import soft_rasterize_bwd

pytestmark = pytest.mark.cuda

P2F_ATOL = 1e-5
KW = dict(image_size=64, sigma_val=3e-3, gamma_val=1e-2, dist_eps=1e-4,
          background_color=(0.1, 0.2, 0.3))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("mode", ["softmax", "mask_only", "hard"])
def test_kernel_matches_plain(cuda, mode):
    faces, tex = random_scene(np.random.RandomState(1), B=2, F=40, T2=9)
    fv = torch.as_tensor(faces, device=cuda)
    tx = torch.as_tensor(tex, device=cuda)
    kw = dict(KW, aggr_func_rgb="hard" if mode == "hard" else "softmax",
              mask_only=mode == "mask_only")
    before = raster_kernel.LAUNCHES
    # a cap above the scene's needs: the plain version has no bins to cap
    out = raster_kernel.soft_rasterize_fwd(fv, tx, mf_cap=64, **kw)
    torch.cuda.synchronize()
    assert raster_kernel.LAUNCHES == before + 1
    ref = soft_rasterize(fv, tx, **kw)
    torch.testing.assert_close(out.rgba, ref.rgba, atol=1e-3, rtol=0)
    if mode == "hard":
        cov = ref.aggr[:, 1] >= 0
        same = ((out.aggr[:, 1] == ref.aggr[:, 1])
                & (out.aggr[:, 0] == ref.aggr[:, 0]))
        assert same[cov].float().mean() >= 0.999
    else:
        torch.testing.assert_close(out.aggr, ref.aggr, rtol=1e-4, atol=0)


@pytest.mark.parametrize("mode", ["softmax", "mask_only"])
def test_p2f_kernel_matches_plain(cuda, mode):
    """The p2f instance against the plain version at face_chunk=1 (the
    kernel's rule); its rgba and aggr are the p2f-free instance's, bit for
    bit (the same arithmetic)."""
    faces, tex = random_scene(np.random.RandomState(3), B=2, F=40, T2=9)
    fv = torch.as_tensor(faces, device=cuda)
    tx = torch.as_tensor(tex, device=cuda)
    kw = dict(KW, mask_only=mode == "mask_only")
    before = (raster_kernel.LAUNCHES, raster_kernel.P2F_LAUNCHES)
    out = raster_kernel.soft_rasterize_fwd(fv, tx, mf_cap=64, need_p2f=True,
                                           **kw)
    plain_inst = raster_kernel.soft_rasterize_fwd(fv, tx, mf_cap=64, **kw)
    torch.cuda.synchronize()
    assert (raster_kernel.LAUNCHES, raster_kernel.P2F_LAUNCHES) == (
        before[0] + 2, before[1] + 1)
    assert torch.equal(out.rgba, plain_inst.rgba)
    assert torch.equal(out.aggr, plain_inst.aggr)
    assert not plain_inst.p2f.any()
    ref = soft_rasterize(fv, tx, face_chunk=1, need_p2f=True, **kw)
    torch.testing.assert_close(out.p2f, ref.p2f, atol=P2F_ATOL, rtol=0)
    # the hard body writes no p2f
    hard = raster_kernel.soft_rasterize_fwd(
        fv, tx, mf_cap=64, need_p2f=True, aggr_func_rgb="hard", **KW)
    assert not hard.p2f.any()
    assert raster_kernel.P2F_LAUNCHES == before[1] + 1


def test_p2f_kernel_matches_golden(cuda):
    from golden_raster import golden_soft_rasterize

    kw = dict(KW, image_size=32)
    faces, tex = random_scene(np.random.RandomState(4), B=2, F=6, T2=16)
    _, g_p2f, _ = golden_soft_rasterize(faces, tex, **kw)
    out = raster_kernel.soft_rasterize_fwd(
        torch.as_tensor(faces, device=cuda), torch.as_tensor(tex, device=cuda),
        mf_cap=32, need_p2f=True, **kw)
    np.testing.assert_allclose(out.p2f.cpu().numpy(), g_p2f, rtol=0,
                               atol=P2F_ATOL)


@pytest.mark.parametrize("opts", [
    {}, {"rgb_geom_detach": True}, {"tex_grads": False}, {"mask_only": True}],
    ids=["default", "rgb_geom_detach", "no_tex_grads", "mask_only"])
def test_backward_kernel_matches_plain(cuda, opts):
    rng = np.random.RandomState(2)
    faces, tex = random_scene(rng, B=2, F=40, T2=9)
    g = torch.as_tensor(rng.standard_normal((2, 64, 64, 4)).astype(
        np.float32), device=cuda)
    fv = torch.as_tensor(faces, device=cuda).requires_grad_()
    tx = torch.as_tensor(tex, device=cuda).requires_grad_()
    before = raster_kernel.BWD_LAUNCHES
    out = raster_kernel.soft_rasterize_fwd(fv, tx, mf_cap=64, **opts, **KW)
    (out.rgba * g).sum().backward()
    torch.cuda.synchronize()
    assert raster_kernel.BWD_LAUNCHES == before + 1
    ref = soft_rasterize(fv.detach(), tx.detach(),
                         mask_only=opts.get("mask_only", False), **KW)
    bkw = {k: v for k, v in KW.items() if k != "background_color"}
    gf, gt = soft_rasterize_bwd(fv.detach(), tx.detach(), ref.rgba, ref.aggr,
                                g, **opts, **bkw)
    for got, want in ((fv.grad, gf), (tx.grad, gt)):
        scale = max(want.abs().max().item(), 1e-30)
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5 * scale)
    if opts.get("tex_grads", True) and not opts.get("mask_only"):
        assert gt.abs().max() > 0
