"""The port's stage handoff end to end on the CPU, through files only
(tests/test_pipeline.py's chain, without visuals): train_s1 ->
avg_uv -> train_s2 (force_template; resumed) -> test_iou -> test_kp in
flow and cam mode, every checkpoint and template in tmp_path, at image
32, subdivide 2, tex_size 2, on synthetic batches."""

import os
import re

import numpy as np
import pytest

from umr_tpu_torch.config import Config
from umr_tpu_torch.data import synthetic_batch
from umr_tpu_torch.experiments import (avg_uv, test_iou, test_kp, train_s1,
                                       train_s2)

IMG = 32
pytestmark = pytest.mark.filterwarnings("ignore")
RUN_FILES = ("pred_net_latest.pth", "pred_state.pt", "loss_log.txt",
             "opts.log", "stage_budget.json")
TEMPLATE_FILES = ("semantic_prob.npy", "semantic_seg.png", "mean_v.pth",
                  "head_vertices.npy", "neck_vertices.npy",
                  "back_vertices.npy", "belly_vertices.npy",
                  "mean_template.obj", "vertex_label.obj")


def _cfg(tmp, **kw):
    base = dict(image_size=IMG, img_size=IMG, batch_size=2, num_hypo_cams=2,
                anti_aliasing=False, subdivide=2, tex_size=2, nz_feat=16,
                z_dim=8, num_epochs=1, num_iter=2,
                checkpoint_dir=os.path.join(tmp, "snap"),
                stemp_path=os.path.join(tmp, "stemp"),
                out_dir=os.path.join(tmp, "stemp"),
                model_path=os.path.join(tmp, "snap", "s1",
                                        "pred_net_latest.pth"),
                print_freq=1, number_pairs=3, seed=0)
    base.update(kw)
    return Config(**base)


def _logged(path, key):
    text = open(path).read()
    return [float(v) for v in re.findall(rf"{key}: (-?[\d.]+)", text)]


def test_chain_through_files(tmp_path, monkeypatch):
    monkeypatch.delenv("UMR_TPU_RESUME", raising=False)
    monkeypatch.delenv("UMR_TPU_NO_AUTORESUME", raising=False)
    tmp = str(tmp_path)
    rng = np.random.RandomState(0)
    loader = [synthetic_batch(rng, 2, IMG) for _ in range(2)]

    s1 = train_s1.run(_cfg(tmp, name="s1", use_scops=False), loader,
                      device="cpu")
    s1_dir = os.path.join(tmp, "snap", "s1")
    for f in RUN_FILES:
        assert os.path.exists(os.path.join(s1_dir, f)), f
    area = _logged(os.path.join(s1_dir, "loss_log.txt"), "uv_flow_area")
    assert len(area) == 2 and all(0 < a <= 1 for a in area)
    assert s1.state.step == 2

    out = avg_uv.run(_cfg(tmp, name="uv"), loader, device="cpu")
    for f in TEMPLATE_FILES:
        assert os.path.exists(os.path.join(out, f)), f

    # a two-step s1 model gives a dead template: refused, then forced
    with pytest.raises(ValueError, match="liveliness bar"):
        train_s2.run(_cfg(tmp, name="s2"), loader, device="cpu")
    s2 = train_s2.run(_cfg(tmp, name="s2", force_template=True), loader,
                      device="cpu")
    assert s2.state.step == 2
    s2_dir = os.path.join(tmp, "snap", "s2")
    for f in RUN_FILES:
        assert os.path.exists(os.path.join(s2_dir, f)), f
    resumed = train_s2.run(_cfg(tmp, name="s2", force_template=True,
                                num_epochs=2, num_iter=4), loader,
                           device="cpu")
    assert resumed.state.step == 4 and len(resumed.history) == 2
    assert len(_logged(os.path.join(s2_dir, "loss_log.txt"),
                       "corr_loss")) == 4

    s2_pth = os.path.join(s2_dir, "pred_net_latest.pth")
    iou = test_iou.run(_cfg(tmp, model_path=s2_pth), loader, device="cpu")
    assert 0.0 <= iou <= 1.0
    for mode in ("flow", "cam"):
        pairs = tuple([synthetic_batch(np.random.RandomState(s + i), 1, IMG)
                       for i in range(3)] for s in (1, 11))
        pck1, pck15 = test_kp.run(_cfg(tmp, model_path=s2_pth, mode=mode),
                                  pairs, device="cpu")
        assert 0.0 <= pck1 <= pck15 <= 1.0
