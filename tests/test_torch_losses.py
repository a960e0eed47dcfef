"""Port parity of the stage-2 losses, LPIPS and the discriminator: each
against its JAX function on the same numpy inputs, values and input
gradients.

Tolerances: float32 formulas evaluated in the same order, one rounding
each: rtol 1e-5, atol 1e-6 on values and gradients of the losses
(gradients: atol times the largest gradient where that is above 1; the
flatten loss's scatter-summed gradients differ by 1.5e-6 at ~7);
convolutions (LPIPS, discriminator) sum in another order: rtol 1e-4,
atol 1e-5 (reading: LPIPS distances agree to 1e-6, input gradients to
2e-6 at magnitudes ~1e-2). Renders of meshes at sigma 1e-5 as the other
render tests (torch_parity.assert_close_except_slivers): silhouettes atol
5e-4 on all but 0.2% of values, the rest within 0.02; textured renders on
all but 0.5%, the rest within 0.03 (0.05 for the one-hot part
renders, where a flipped texel changes a channel from 0 to 1). The port
clips barycentrics as the
TPU kernel does (times one reciprocal) where the XLA dense path divides,
so the nearest texel flips at some cell borders (reading, image 32 without
anti-aliasing: masks 5 of 4,096 values over, at most 2.0e-3; textures 50
of 12,288, at most 0.017; part renders 14 of 8,192, at most 0.031)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_close_except_slivers, flatten, np_of, t_of
from umr_tpu.losses import composite as jcomp
from umr_tpu.losses import losses as jl
from umr_tpu.mesh import build_template as jax_template
from umr_tpu.models.discriminator import Discriminator as JaxDisc
from umr_tpu.models.lpips import LPIPSAlex as JaxLPIPS
from umr_tpu.models.weight_io import load_lpips_params
from umr_tpu.renderer import SoftRenderer as JaxRenderer
from umr_tpu.training import steps as jsteps
from umr_tpu_torch.losses import composite as tcomp
from umr_tpu_torch.losses import losses as tl
from umr_tpu_torch.mesh import build_template
from umr_tpu_torch.models import Discriminator, LPIPSAlex
from umr_tpu_torch.models.weights import (WEIGHTS_DIR,
                                          discriminator_state_from_flax,
                                          load_lpips_npz)
from umr_tpu_torch.renderer import SoftRenderer
from umr_tpu_torch.training import steps as tsteps

TOL = dict(rtol=1e-5, atol=1e-6)
CONV_TOL = dict(rtol=1e-4, atol=1e-5)


def _both(fn_t, fn_j, *arrays, grad=True):
    """fn_t / fn_j on the same float arrays: (port value, JAX value) and,
    with grad, the gradients of sum(value * w) with respect to every
    array (w fixed, from a seed)."""
    ts = [t_of(a).requires_grad_(grad) for a in arrays]
    out_t = fn_t(*ts)
    js = [jnp.asarray(a) for a in arrays]
    out_j = fn_j(*js)
    w = np.random.RandomState(7).uniform(0.5, 1.5, np.shape(out_j)).astype(
        np.float32)
    if not grad:
        return np_of(out_t), np.asarray(out_j), [], []
    g_t = torch.autograd.grad((out_t * t_of(w)).sum(), ts)
    g_j = jax.jit(jax.grad(lambda *xs: jnp.sum(fn_j(*xs) * w),
                           argnums=tuple(range(len(arrays)))))(*js)
    return (np_of(out_t), np.asarray(out_j), [np_of(g) for g in g_t],
            [np.asarray(g) for g in g_j])


def _check(res, tol=TOL):
    """Values to `tol`; gradients (summed by scatter in another order) to
    its rtol and its atol times the largest gradient, if above 1."""
    vt, vj, gt, gj = res
    np.testing.assert_allclose(vt, vj, **tol)
    for a, b in zip(gt, gj):
        np.testing.assert_allclose(
            a, b, rtol=tol["rtol"],
            atol=tol["atol"] * max(1.0, float(np.abs(b).max())))


@pytest.fixture(scope="module")
def template():
    return build_template(2, 1, 2)


def _loss_cases(rng, template):
    B, F, T = 2, template.num_faces, 2
    V = template.num_verts
    m1 = rng.uniform(0, 1, (B, 8, 8)).astype(np.float32)
    m2 = (rng.uniform(0, 1, (B, 8, 8)) > 0.5).astype(np.float32)
    flow = rng.uniform(-1, 1, (B, F, T, T, 2)).astype(np.float32)
    dt = rng.uniform(0, 1, (B, 12, 12, 1)).astype(np.float32)
    verts = (template.verts[None] + 0.05 * rng.standard_normal(
        (B, V, 3))).astype(np.float32)
    probs = rng.dirichlet(np.ones(4), B).astype(np.float32)
    a = rng.standard_normal((B, 5, 2)).astype(np.float32)
    b = rng.standard_normal((B, 7, 2)).astype(np.float32)
    logits = rng.standard_normal(6).astype(np.float32) * 3
    labels = np.array([1, 1, 1, 0, 0, 0], np.float32)
    maps = rng.uniform(0, 1, (B, 3, 6, 5)).astype(np.float32)
    lap, fidx = template.laplacian, template.flatten_idx
    return {
        "neg_iou": (lambda x, y: tl.neg_iou_loss(x, y),
                    lambda x, y: jl.neg_iou_loss(x, y), m1, m2),
        "neg_iou_per_sample": (lambda x, y: tl.neg_iou_loss(x, y, avg=False),
                               lambda x, y: jl.neg_iou_loss(x, y, avg=False),
                               m1, m2),
        "texture_dt": (tl.texture_dt_loss, jl.texture_dt_loss, flow, dt),
        "deform_l2reg": (tl.deform_l2reg, jl.deform_l2reg, verts),
        "sym_reg": (tl.sym_reg, jl.sym_reg, verts),
        "cam_diversity": (tl.cam_diversity_loss, jl.cam_diversity_loss,
                          probs),
        "entropy": (tl.entropy_loss, jl.entropy_loss, probs),
        "laplacian": (lambda v: tl.laplacian_loss(v, t_of(lap)),
                      lambda v: jl.laplacian_loss(v, jnp.asarray(lap)),
                      verts),
        "flatten": (lambda v: tl.flatten_loss(v, t_of(fidx)),
                    lambda v: jl.flatten_loss(v, jnp.asarray(fidx)), verts),
        "chamfer": (lambda x, y: torch.cat(tl.chamfer_dist(x, y)[:2], 1),
                    lambda x, y: jnp.concatenate(jl.chamfer_dist(x, y)[:2],
                                                 1), a, b),
        "bce_with_logits": (lambda x: tl.bce_with_logits(x, t_of(labels)),
                            lambda x: jl.bce_with_logits(
                                x, jnp.asarray(labels)), logits),
        "batch_get_centers": (tl.batch_get_centers, jl.batch_get_centers,
                              maps),
        "get_centers": (tl.get_centers, jl.get_centers, maps[0]),
        "normalize_part_segs": (tsteps.normalize_part_segs,
                                jsteps.normalize_part_segs,
                                rng.uniform(0, 1, (B, 6, 6, 5)).astype(
                                    np.float32), m2[:, :6, :6]),
    }


CASES = ["neg_iou", "neg_iou_per_sample", "texture_dt", "deform_l2reg",
         "sym_reg", "cam_diversity", "entropy", "laplacian", "flatten", "chamfer",
         "bce_with_logits", "batch_get_centers", "get_centers",
         "normalize_part_segs"]


@pytest.mark.parametrize("case", CASES)
def test_loss_matches_jax(rng, template, case):
    fn_t, fn_j, *arrays = _loss_cases(rng, template)[case]
    _check(_both(fn_t, fn_j, *arrays))


@pytest.mark.parametrize("with_bg", [False, True])
def test_tex_cycle_loss_matches_jax(rng, template, with_bg):
    """Face id -1 (background) marks the last face, as in the reference."""
    B, F = 2, template.num_faces
    flow = rng.uniform(-1, 1, (B, F, 2, 2, 2)).astype(np.float32)
    p2f = rng.uniform(-1, 1, (B, F, 2)).astype(np.float32)
    ids = rng.randint(0, F - 1, (B, 30)).astype(np.float32)
    if with_bg:
        ids[:, :5] = -1
    res = _both(lambda f: tl.tex_cycle_loss(f, t_of(p2f), t_of(ids))[0],
                lambda f: jl.tex_cycle_loss(f, jnp.asarray(p2f),
                                            jnp.asarray(ids))[0], flow)
    _check(res)
    last = np.abs(res[2][0][:, F - 1]).max()
    assert (last > 0) == with_bg


def test_uv_flow_area_matches_jax(rng):
    uv = rng.uniform(-1.1, 1.1, (2, 8, 16, 2)).astype(np.float32)
    assert float(tsteps.uv_flow_area(t_of(uv))) == float(
        jsteps.uv_flow_area(jnp.asarray(uv)))


def test_corr_loss_chamfer_matches_jax(rng, template):
    """Zero-weighted parts stay in the mean's denominator; an empty part
    adds nothing."""
    B, V = 3, template.num_verts
    idx = rng.permutation(V)
    pvi = [idx[0:7], idx[7:19], np.zeros(0, np.int64), idx[19:30]]
    pts = [rng.uniform(-1, 1, (B, n, 2)).astype(np.float32)
           for n in (4, 6, 3, 5)]
    verts = (template.verts[None] + 0.1 * rng.standard_normal(
        (B, V, 3))).astype(np.float32)
    cams = np.concatenate([rng.uniform(0.5, 1, (B, 3)), rng.standard_normal(
        (B, 4))], 1).astype(np.float32)
    cams[:, 3:] /= np.linalg.norm(cams[:, 3:], axis=1, keepdims=True)
    tr, jr = SoftRenderer(), JaxRenderer()
    _check(_both(
        lambda v, c: tcomp.corr_loss_chamfer(
            tr.project_points, pvi, [t_of(p) for p in pts], v, c,
            avg=False)[0],
        lambda v, c: jcomp.corr_loss_chamfer(
            jr.project_points, pvi, [jnp.asarray(p) for p in pts], v, c,
            avg=False)[0], verts, cams))


def test_corr_loss_of_a_template_without_part_vertices_raises(rng,
                                                               template):
    """A template with no part vertices at all has no distances to
    average: both packages raise, as the JAX concatenation of none does
    (train_s2 refuses such a template before it gets here)."""
    B = 2
    pvi = [np.zeros(0, np.int64)] * 4
    pts = [rng.uniform(-1, 1, (B, 3, 2)).astype(np.float32)] * 4
    verts = np.tile(template.verts[None], (B, 1, 1)).astype(np.float32)
    cams = np.tile([[0.7, 0, 0, 1, 0, 0, 0]], (B, 1)).astype(np.float32)
    with pytest.raises(ValueError):
        tcomp.corr_loss_chamfer(SoftRenderer().project_points, pvi,
                                [t_of(p) for p in pts], t_of(verts),
                                t_of(cams))
    with pytest.raises(ValueError):
        jcomp.corr_loss_chamfer(JaxRenderer().project_points, pvi,
                                [jnp.asarray(p) for p in pts],
                                jnp.asarray(verts), jnp.asarray(cams))


def _mesh_inputs(rng, template, B=2, K=2):
    V = template.num_verts
    verts = (template.verts[None] * rng.uniform(0.8, 1.1, (B, 1, 3))).astype(
        np.float32)
    q = rng.standard_normal((B, K, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    cams = np.concatenate([rng.uniform(0.5, 0.8, (B, K, 1)),
                           rng.uniform(-0.2, 0.2, (B, K, 2)), q], -1).astype(
        np.float32)
    return verts, cams, V


def test_part_matching_loss_matches_jax(rng, template):
    """build (label map sampled, rounded, one-hot), the 3-channel texture
    groups, and the loss of the renders (plain route against XLA's dense
    rasterizer, image 32, no AA)."""
    jt = jax_template(2, 1, 2)
    seg = rng.randint(0, 5, size=(16, 32)).astype(np.float32)
    kw = dict(image_size=32, anti_aliasing=False, ambient_intensity=1.0,
              directional_intensity=0.0)
    tpl = tcomp.PartMatchingLoss.build(seg, template.uv_sampler,
                                       template.num_sym_faces,
                                       SoftRenderer(**kw), tex_size=2)
    jpl = jcomp.PartMatchingLoss.build(seg, jt.uv_sampler, jt.num_sym_faces,
                                       JaxRenderer(**kw), tex_size=2)
    np.testing.assert_array_equal(np_of(tpl.part_tex), jpl.part_tex)
    for a, b in zip(tpl.texture_groups(2), jpl.texture_groups(2)):
        np.testing.assert_array_equal(np_of(a), np.asarray(b))

    verts, cams, _ = _mesh_inputs(rng, template)
    part_prob = rng.uniform(0, 1, (2, 32, 32, 5)).astype(np.float32)
    masks = (rng.uniform(0, 1, (2, 32, 32)) > 0.3).astype(np.float32)
    segs = jsteps.normalize_part_segs(jnp.asarray(part_prob),
                                      jnp.asarray(masks))
    lt, pt = tpl(t_of(verts), t_of(template.faces), t_of(cams[:, 0]),
                 t_of(np.asarray(segs)))
    lj, pj = jpl(jnp.asarray(verts), jnp.asarray(jt.faces),
                 jnp.asarray(cams[:, 0]), segs)
    assert_close_except_slivers(np_of(pt), np.asarray(pj), atol=5e-4,
                                frac=5e-3, cap=5e-2)
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-3)
    # the loss on identical projections: the same formula
    _check(_both(lambda p: tpl.loss_from_projs(p, t_of(np.asarray(segs)))[0],
                 lambda p: jpl.loss_from_projs(p, segs)[0], np.asarray(pj)))


def test_multi_mask_texture_render_matches_jax(rng, template):
    """Plain route (two renders, exact AD) against the JAX package's XLA
    route: masks, texture renders and the multi-mask loss."""
    jt = jax_template(2, 1, 2)
    verts, cams, _ = _mesh_inputs(rng, template)
    tex = rng.uniform(0, 1, (2, template.num_faces, 4, 3)).astype(np.float32)
    kw = dict(image_size=32, anti_aliasing=False)
    tr = SoftRenderer(**kw)
    jr = JaxRenderer(**kw)
    mt, tt = tcomp.multi_mask_texture_render(
        tr, tr.ambient_light_only(), t_of(verts), t_of(template.faces),
        t_of(cams), t_of(tex))
    mj, tj = jcomp.multi_mask_texture_render(
        jr, jr.ambient_light_only(), jnp.asarray(verts), jnp.asarray(jt.faces),
        jnp.asarray(cams), jnp.asarray(tex))
    assert mt.shape == (4, 32, 32) and tt.shape == (4, 32, 32, 3)
    assert_close_except_slivers(np_of(mt), np.asarray(mj), atol=5e-4,
                                frac=2e-3, cap=2e-2)
    assert_close_except_slivers(np_of(tt), np.asarray(tj), atol=5e-4,
                                frac=5e-3, cap=3e-2)
    gt_masks = (rng.uniform(0, 1, (2, 32, 32)) > 0.5).astype(np.float32)
    probs = np.full((2, 2), 0.5, np.float32)
    lt, _ = tcomp.multi_mask_loss(tr, t_of(verts), t_of(template.faces),
                                  t_of(cams), t_of(probs), t_of(gt_masks))
    lj, _ = jcomp.multi_mask_loss(jr, jnp.asarray(verts),
                                  jnp.asarray(jt.faces), jnp.asarray(cams),
                                  jnp.asarray(probs), jnp.asarray(gt_masks))
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-4)


def test_lpips_matches_jax(rng):
    """Committed weights on both sides; distances and input gradients."""
    model = load_lpips_npz(LPIPSAlex(), f"{WEIGHTS_DIR}/lpips_alex.npz")
    assert not any(p.requires_grad for p in model.parameters())
    params = {"params": load_lpips_params(f"{WEIGHTS_DIR}/lpips_alex.npz")}
    jm = JaxLPIPS()
    a = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    b = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    _check(_both(model, lambda x, y: jm.apply(params, x, y), a, b), CONV_TOL)


def test_discriminator_and_grl_match_jax(rng):
    """Converted flax weights; logits, the parameters' gradients and the
    input gradients, reversed and scaled by lambda by the GRL."""
    jd = JaxDisc(lambda_=0.2, in_dim=3, img_size=32)
    x = rng.uniform(0, 1, (3, 32, 32, 3)).astype(np.float32)
    params = jd.init(jax.random.key(0), jnp.asarray(x))["params"]
    disc = Discriminator(lambda_=0.2, in_dim=3, img_size=32)
    disc.load_state_dict(discriminator_state_from_flax(params))
    res = _both(disc, lambda v: jd.apply({"params": params}, v), x)
    _check(res, CONV_TOL)
    assert np.abs(res[2][0]).max() > 0
    # the GRL: the same network without it gives -1/lambda x that gradient
    xt = t_of(x).requires_grad_()
    h = xt.permute(0, 3, 1, 2)
    for conv in disc.convs:
        h = torch.relu(conv(h))
    out = disc.fc(disc.head(h).reshape(3, -1))
    g_plain = torch.autograd.grad((out * t_of(np.random.RandomState(7).uniform(
        0.5, 1.5, (3, 1)).astype(np.float32))).sum(), xt)[0]
    np.testing.assert_allclose(res[2][0], -0.2 * np_of(g_plain), rtol=1e-5,
                               atol=1e-8)
    g_fc = torch.autograd.grad(disc(t_of(x)).sum(), disc.fc.weight)[0]
    g_j = jax.grad(lambda p: jd.apply({"params": p}, jnp.asarray(x)).sum())(
        params)["Dense_0"]["kernel"]
    np.testing.assert_allclose(np_of(g_fc).T, np.asarray(g_j), **CONV_TOL)


def test_gan_loss_matches_jax(rng):
    jd = JaxDisc(lambda_=0.2, in_dim=3, img_size=32)
    real = rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    fake = rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    params = jd.init(jax.random.key(1), jnp.asarray(real))["params"]
    disc = Discriminator(lambda_=0.2, in_dim=3, img_size=32)
    disc.load_state_dict(discriminator_state_from_flax(params))
    lt, at = tcomp.gan_loss(disc, t_of(real), t_of(fake))
    lj, aj = jcomp.gan_loss(lambda v: jd.apply({"params": params}, v),
                            jnp.asarray(real), jnp.asarray(fake))
    np.testing.assert_allclose(lt.item(), float(lj), **CONV_TOL)
    assert float(at) == float(aj)
    assert sorted(flatten(params)) == sorted(
        "/".join(k) for k in _flax_names())


def _flax_names():
    return ([(f"Conv_{i}", leaf) for i in range(5)
             for leaf in ("bias", "kernel")]
            + [("Dense_0", "bias"), ("Dense_0", "kernel")])
