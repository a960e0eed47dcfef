"""experiments/profile_step.py (port of tools/profile_step.py) on the CPU,
through the plain versions, at B=2, 32^2, K=2, no anti-aliasing, the
subdivide-1 template (80 faces) with tex_size 2 and narrow heads
(nz_feat 32, z_dim 24; the part vertex sets cut to the template's 42
vertices), one timed call a row:

  * every row is there, in the JAX tool's order, with a finite time, a
    finite forward value where the row has one, and no rasterizer
    launch (the CPU has no kernel);
  * the FULL row's loss is build_s2_step's on the same state, batch and
    draws (a step built here), bit for bit on the CPU;
  * each component's forward value is the same value computed here from
    that step's own pieces: the model's outputs at the draws (eval mode
    for the render inputs, as the JAX tool's), the renderers of
    training/steps.py::_renderers, the step's LPIPS, part matching and
    discriminator. Equal on the CPU (same code, same inputs), so held at
    rtol 1e-6.
"""

import math

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401 — torch on 2 threads beside the workers
from umr_tpu_torch.config import Config
from umr_tpu_torch.experiments import profile_step
from umr_tpu_torch.losses.composite import (PartMatchingLoss, gan_loss,
                                            multi_mask_texture_render)
from umr_tpu_torch.mesh import build_template
from umr_tpu_torch.models import symmetrize
from umr_tpu_torch.ops.grid_sample import sample_textures
from umr_tpu_torch.renderer import SoftRenderer
from umr_tpu_torch.training.steps import (_renderers, build_s2_step,
                                          normalize_part_segs)

ROWS = ["FULL step", "model fwd+bwd (no renders)",
        "fused hypo render fwd+bwd (B*K)", "LPIPS fwd+bwd (B*K images)",
        "hard render fwd (B)", "GAN unseen rgb render fwd+bwd (B)",
        "part-matching fwd+bwd (B)", "discriminator fwd+bwd (B)",
        "optimizer update", "host->device batch transfer"]
SIZES = dict(batch=2, size=32, subdivide=1, tex=2, hypo=2, aa=False)


@pytest.fixture(scope="module")
def profiled():
    mp = pytest.MonkeyPatch()
    mp.setattr(profile_step, "Config", lambda **kw: Config(
        **dict(kw, nz_feat=32, z_dim=24)))
    mp.setattr(profile_step, "PART_SLICES",
               ((0, 8), (8, 20), (20, 28), (28, 40)))
    try:
        yield profile_step.run("cpu", iters=1, size_kw=SIZES)
    finally:
        mp.undo()


def test_every_row_finite_on_the_plain_versions(profiled):
    rows = profiled["rows"]
    assert [r["name"] for r in rows] == ROWS
    for r in rows:
        assert math.isfinite(r["ms"]) and r["ms"] >= 0, r
        assert (r["fwd_launches"], r["bwd_launches"]) == (0, 0), r
        assert (r["value"] is None) == (r["name"] in ROWS[-2:]), r
        assert r["value"] is None or math.isfinite(r["value"]), r


def test_rows_equal_the_steps_own_pieces(profiled):
    r = profiled
    cfg = r["cfg"]
    assert (cfg.batch_size, cfg.image_size, cfg.num_hypo_cams,
            cfg.anti_aliasing) == (2, 32, 2, False)
    template = build_template(cfg.subdivide, cfg.axis, cfg.tex_size)
    part_loss = PartMatchingLoss.build(
        r["seg"], template.uv_sampler, template.num_sym_faces,
        SoftRenderer(image_size=32, anti_aliasing=False,
                     ambient_intensity=1.0, directional_intensity=0.0),
        tex_size=cfg.tex_size, num_parts=cfg.num_parts)
    model, disc, _, init_fn, step_fn = build_s2_step(
        cfg, template, part_loss, r["pvi"], "cpu")
    state = init_fn(0)
    batch = {k: torch.as_tensor(v) for k, v in r["batch"].items()}
    dr = {k: torch.as_tensor(v) for k, v in r["draws"].items()}
    B, K = 2, 2
    with torch.no_grad():
        model.eval()
        out = model(batch["input_img"], eps=dr["eps"],
                    sample_inds=dr["sample_inds"])
        pred_vs = (symmetrize(model.mean_v, template)[None]
                   + symmetrize(out["delta_v"], template))
        tex = sample_textures(out["tex_flow"], batch["img"])
        tex = tex.reshape(B, tex.shape[1], -1, 3)
        model.train()
        tr = model(batch["input_img"], eps=dr["eps"],
                   sample_inds=dr["sample_inds"])
    p = r["pieces"]
    for k, v in (("pred_vs", pred_vs), ("tex", tex),
                 ("cams_all", out["cam_hypotheses"]),
                 ("proj_cam", out["cam"])):
        assert torch.equal(p[k], v), k
    renderer, tex_renderer, hard_renderer = _renderers(cfg, "auto")
    faces = torch.as_tensor(template.faces)
    masks, imgs = batch["mask"], batch["img"]
    mrep = masks.repeat_interleave(K, 0)[..., None]
    irep = imgs.repeat_interleave(K, 0)
    with torch.no_grad():
        m, tp = multi_mask_texture_render(renderer, tex_renderer, pred_vs,
                                          faces, out["cam_hypotheses"], tex)
        hard = hard_renderer.render(pred_vs, faces, out["cam"])
        want = {
            "model fwd+bwd (no renders)": sum(
                tr[k].sum() for k in ("delta_v", "cam_hypotheses",
                                      "tex_flow", "cam_probs")),
            "fused hypo render fwd+bwd (B*K)": m.sum() + tp.sum(),
            "LPIPS fwd+bwd (B*K images)": state.lpips(
                2 * irep * 0.5 * mrep - 1, 2 * irep * mrep - 1).sum(),
            "hard render fwd (B)": hard.aggr[:, 1].sum() + hard.p2f.sum(),
            "GAN unseen rgb render fwd+bwd (B)": tex_renderer.render(
                pred_vs, faces, p["random_cams"], tex).rgba[..., :3].sum(),
            "part-matching fwd+bwd (B)": part_loss(
                pred_vs, faces, out["cam"],
                normalize_part_segs(batch["part_prob"], masks))[0],
            "discriminator fwd+bwd (B)": gan_loss(
                disc, irep[:B], irep[:B] * 0.5)[0],
        }
    _, sc = step_fn(state, batch, r["draws"])
    want["FULL step"] = sc["total_loss"]
    got = {row["name"]: row["value"] for row in r["rows"]}
    assert got["FULL step"] == float(want["FULL step"])
    for k, v in want.items():
        np.testing.assert_allclose(got[k], float(v), rtol=1e-6, err_msg=k)
