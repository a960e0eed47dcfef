"""The training visuals (training/visuals.py) against the JAX package's
make_visuals_fn on one MeshNet-s2 (the JAX variables written to a .pth
the port loads) and one batch, with the JAX forward's random draws
injected; then the trainer's display cadence and test_iou's
--visualize writing their files on the CPU.

Tolerances (the render tolerances of tests/test_torch_slice.py): every
image within 1e-3 on all but 0.2% of its values, the rest within 0.02,
the four part renders held as one [N,4,H,W] projection, as the part loss
reads them; the mesh's vertices and texels within 1e-4, as the cameras
there. Readings at image 32 without anti-aliasing, 2 images: the
textured render and the UV images within 1.7e-6; the mask render 2 of
2048 values over 1e-3, the largest 1.8e-3; the part projection 10 of
8192 over 1e-3, the largest 0.0128 (silhouette slivers at sigma 1e-5);
the ground-truth panels and the overlay equal.
"""

import os
import types

import numpy as np
import pytest
import torch

from torch_parity import (SMALL, assert_close_except_slivers,
                          injected_draws, jax_meshnet)
from umr_tpu_torch import png
from umr_tpu_torch.config import Config
from umr_tpu_torch.data import synthetic_batch
from umr_tpu_torch.experiments import test_iou, train_s1, train_s2
from umr_tpu_torch.losses.composite import PartMatchingLoss
from umr_tpu_torch.mesh import build_template
from umr_tpu_torch.renderer import SoftRenderer
from umr_tpu_torch.training import visuals

pytestmark = pytest.mark.filterwarnings("ignore")
VIS_KW = dict(render_type="hard", anti_aliasing=False, ambient_intensity=0.8,
              directional_intensity=0.4, light_direction=(0.0, 1.0, -1.0),
              background_color=(1.0, 1.0, 1.0))
S1_FILES = ("image_pred.png", "uv_images.png", "mask_pred.png",
            "mask_gt.png", "image_gt.png", "mesh_0.obj", "mesh_0.png")


def _semantic(template, rng):
    seg = rng.randint(0, 5, template.uv_image_size()).astype(np.float32)
    pvi = [rng.permutation(template.num_verts)[:12] for _ in range(4)]
    return seg, pvi


def test_visuals_match_jax(tmp_path):
    import jax
    import jax.numpy as jnp

    from umr_tpu.losses.composite import PartMatchingLoss as JaxPML
    from umr_tpu.mesh import build_template as jax_template
    from umr_tpu.renderer import SoftRenderer as JaxRenderer
    from umr_tpu.training.checkpoints import save_pth
    from umr_tpu.training.trainer import prepare_batch as jax_prepare
    from umr_tpu.training.visuals import make_visuals_fn as jax_visuals_fn

    S = 32
    jt = jax_template(SMALL["subdivide"], 1, SMALL["tex_size"])
    jmodel, variables = jax_meshnet(jt, S, SMALL["nz_feat"], SMALL["z_dim"],
                                    SMALL["num_hypo_cams"])
    path = str(tmp_path / "pred_net.pth")
    save_pth(path, variables["params"], template=variables["template"],
             batch_stats=variables["batch_stats"])
    cfg = Config(model_path=path, **dict(SMALL, image_size=S)
                 ).sync_image_size()
    template = build_template(SMALL["subdivide"], 1, SMALL["tex_size"])
    rng = np.random.RandomState(3)
    seg, pvi = _semantic(template, rng)
    db = jax_prepare(synthetic_batch(rng, 2, S))

    part_kw = dict(image_size=S, render_type="softmax", anti_aliasing=False,
                   ambient_intensity=1.0, directional_intensity=0.0)
    jpart = JaxPML.build(seg, jt.uv_sampler, jt.num_sym_faces,
                         JaxRenderer(**part_kw), tex_size=SMALL["tex_size"])
    # the model's forward jitted (op by op it takes ~10 s here); the
    # renders op by op, as tests/test_torch_slice.py runs them
    jitted = types.SimpleNamespace(apply=jax.jit(
        jmodel.apply, static_argnames=("train",)))
    jfn = jax_visuals_fn(cfg, jt, jitted, JaxRenderer(image_size=S, **VIS_KW),
                         jnp.asarray(jt.faces), part_loss=jpart,
                         part_vert_idx=pvi)
    jstate = types.SimpleNamespace(
        params={"model": variables["params"]},
        batch_stats={"model": variables["batch_stats"]},
        template=variables["template"], buffers=variables.get("buffers"))
    want = jfn(jstate, db)
    # the draws JAX's visuals_fn made (its sample key is 0)
    jout = jitted.apply(
        {k: v for k, v in variables.items() if v},
        jnp.asarray(db["input_img"][:4]), train=False,
        rngs={"sample": jax.random.key(0)})
    eps, inds = injected_draws(jout)

    model = test_iou.build_eval_model(cfg, template, "cpu").train()
    part = PartMatchingLoss.build(seg, template.uv_sampler,
                                  template.num_sym_faces,
                                  SoftRenderer(**part_kw),
                                  tex_size=SMALL["tex_size"])
    fn = visuals.make_visuals_fn(cfg, template,
                                 SoftRenderer(image_size=S, **VIS_KW),
                                 part_loss=part, part_vert_idx=pvi)
    got = fn(types.SimpleNamespace(model=model), db, eps=eps,
             sample_inds=inds)
    assert model.training                       # the mode is restored
    assert set(got) == set(want)
    assert len([k for k in got if k.startswith("part_render")]) == 4
    parts = [f"part_render_{p}" for p in range(4)]
    for k, w in want.items():
        if k.startswith("mesh"):
            for g_, w_ in zip(got[k], w):
                np.testing.assert_allclose(g_, w_, atol=1e-4, err_msg=k)
        elif k not in parts:
            assert got[k].shape == w.shape, k
            assert_close_except_slivers(got[k], np.asarray(w), atol=1e-3,
                                        frac=2e-3, cap=0.02)
    assert_close_except_slivers(np.stack([got[k] for k in parts]),
                                np.stack([want[k] for k in parts]),
                                atol=1e-3, frac=2e-3, cap=0.02)
    assert visuals.render_calls(4) == 4 and visuals.render_calls() == 2

    visuals.save_visuals(got, str(tmp_path / "vis"))
    for k, v in got.items():
        if not k.startswith("mesh"):
            img = png.read_png(str(tmp_path / "vis" / f"{k}.png"))
            assert img.shape == (v.shape[1], 2 * v.shape[2], 3), k


def test_trainer_and_test_iou_write_visuals(tmp_path, monkeypatch):
    """The display cadence of both stages and test_iou --visualize on the
    CPU: the files exist, decode, and the budget times them."""
    monkeypatch.setenv("UMR_TPU_NO_AUTORESUME", "1")
    monkeypatch.delenv("UMR_TPU_RESUME", raising=False)
    rng = np.random.RandomState(0)
    S = 32
    small = dict(image_size=S, img_size=S, batch_size=2, num_hypo_cams=2,
                 anti_aliasing=False, subdivide=1, tex_size=2, nz_feat=16,
                 z_dim=8, num_iter=2, display_freq=2, print_scalars=False,
                 checkpoint_dir=str(tmp_path / "snap"),
                 vis_dir=str(tmp_path / "vis"))
    loader = [synthetic_batch(rng, 2, S) for _ in range(2)]
    train_s1.run(Config(**small, name="s1", use_scops=False), loader,
                 device="cpu")
    template = build_template(1, 1, 2)
    seg, pvi = _semantic(template, rng)
    trainer = train_s2.run(Config(**small, name="s2"), loader, device="cpu",
                           semantic=(None, seg, pvi))
    s2_files = S1_FILES + ("part_cons_vis.png",) + tuple(
        f"{p}_{i}.png" for p in ("part_render", "gt_part_render")
        for i in range(4))
    for name, files in (("s1", S1_FILES), ("s2", s2_files)):
        d = tmp_path / "vis" / name
        for f in files:
            assert (d / f).exists(), (name, f)
            if f.endswith(".png") and not f.startswith(("mesh", "uv")):
                assert png.read_png(str(d / f)).shape == (S, 2 * S, 3), f
    assert trainer.budget()["vis"] > 0

    pth = str(tmp_path / "snap" / "s2" / "pred_net_latest.pth")
    cfg = Config(**small, model_path=pth, visualize=True, sample_num=2,
                 results_vis_dir=str(tmp_path / "rvis"))
    iou = test_iou.run(cfg, loader * 3, device="cpu")
    assert 0.0 <= iou <= 1.0
    # the first 5 batches
    assert sorted(os.listdir(tmp_path / "rvis")) == [
        f"vis_iter_{i}" for i in range(test_iou.VIS_BATCHES)]
    d = tmp_path / "rvis" / "vis_iter_0"
    for f in ("image_gt.png", "mask_gt.png", "mask_pred.png", "mesh_0.obj",
              "mesh_1.obj", "mesh_1.png"):
        assert (d / f).exists(), f
    assert png.read_png(str(d / "mask_pred.png")).shape == (S, 2 * S, 3)
    assert torch.isfinite(torch.as_tensor(
        png.read_png(str(d / "image_gt.png")), dtype=torch.float32)).all()
