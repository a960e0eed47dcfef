"""The port's checking tools on the CPU (umr_tpu_torch/experiments/
check_fused_grads.py, soak_train.py, dryrun_multichip.py, ports of
tools/check_fused_grads.py, tools/soak_train.py and
__graft_entry__.py::dryrun_multichip).

  * check_fused_grads through the kernels' plain versions (the kernels'
    route on CPU tensors): the fused rgb_geom_detach render's vertex and
    texture gradients against the mask-only render's plus the render with
    the geometry detached, within the tool's 1e-5 + 1e-3 x scale (reading:
    0 apart; tests/test_kernel_interpret.py holds the JAX package's Pallas
    kernel to the same identity).
  * soak_train at 32^2, batch 4, one rotating batch, a few steps of each
    stage, with the tool's full-width Config cut to subdivide 1 (80
    faces: the renders' plain versions take most of a step here), K=2,
    tex_size 2, no anti-aliasing and narrow heads (the s2 part vertex
    sets cut to slices of the template's 42 vertices): the
    summary's keys, finite trends consistent with its flags, stage 1's
    template update at its cadence; and the tool's assertions on good
    and bad summaries (the trends themselves are held at full width on
    the card: chip_smoke.py's phase 18d).
  * dryrun_multichip 2 --device cpu: JAX's line, with the (1, 2) mesh and
    the port's count of sharded leaves, equal to JAX's rule's count at
    that configuration (tests/torch_parity.py::jax_partition_specs).
"""

import math
import re

import pytest

from torch_parity import jax_partition_specs, meta_s2_state
from umr_tpu_torch.config import Config
from umr_tpu_torch.experiments import (check_fused_grads, dryrun_multichip,
                                       soak_train)
from umr_tpu_torch.mesh import build_template

SUMMARY_KEYS = {
    "stage", "steps", "fresh_batches", "loss_first", "loss_last",
    "loss_head_mean", "loss_tail_mean", "mask_iou_head", "mask_iou_tail",
    "template_disp", "trends", "decreased", "iou_improved", "wall_s",
    "images_per_sec"}


def test_check_fused_grads_plain_versions(monkeypatch, capsys):
    r = check_fused_grads.run("cpu")
    assert r["ok"], r
    assert r["dv"] <= 1e-5 + 1e-3 * r["sv"] and r["sv"] > 0
    assert r["dt"] <= 1e-5 + 1e-3 * r["st"] and r["st"] > 0
    # the entry point's report and exit code on this reading, and on a
    # mismatch
    for ok, code, word in ((True, 0, "OK"), (False, 1, "MISMATCH")):
        monkeypatch.setattr(check_fused_grads, "run",
                            lambda device, ok=ok: dict(r, ok=ok))
        assert check_fused_grads.main(["--device", "cpu"]) == code
        assert capsys.readouterr().out.splitlines()[-1] == word


@pytest.mark.parametrize("stage,steps", [("s2", 3), ("s1", 5)])
def test_soak_train_small(monkeypatch, stage, steps):
    def narrow(**kw):
        return Config(**dict(kw, subdivide=1, num_hypo_cams=2,
                             anti_aliasing=False, tex_size=2, nz_feat=32,
                             z_dim=24))

    monkeypatch.setattr(soak_train, "Config", narrow)
    monkeypatch.setattr(soak_train, "PART_SLICES",
                        ((0, 8), (8, 20), (20, 28), (28, 40)))
    s = soak_train.soak(["--stage", stage, "--steps", str(steps),
                         "--batch", "4", "--image_size", "32",
                         "--n_batches", "1", "--template_update_every", "4",
                         "--device", "cpu"])
    assert set(s) == SUMMARY_KEYS
    assert s["stage"] == stage and s["steps"] == steps
    assert not s["fresh_batches"]
    assert all(math.isfinite(v) for t in s["trends"].values()
               for v in t.values())
    assert s["decreased"] == (s["loss_tail_mean"] < s["loss_head_mean"])
    assert s["iou_improved"] == (s["mask_iou_tail"] > s["mask_iou_head"])
    assert s["trends"]["total_loss"] == {"head": s["loss_head_mean"],
                                         "tail": s["loss_tail_mean"]}
    # stage 1 updates the template at step 4 (every 4, not at 0), after
    # its scalars are read
    assert len(s["template_disp"]) == (1 if stage == "s1" else 0)
    assert all(0 < d < 2.0 for d in s["template_disp"])


@pytest.mark.parametrize("bad,match", [
    (None, None), (dict(decreased=False), "total loss"),
    (dict(iou_improved=False), "IoU"),
    (dict(template_disp=[0.3, 2.0]), "drifted")],
    ids=["good", "loss", "iou", "template"])
def test_soak_check(bad, match):
    good = dict(decreased=True, iou_improved=True, template_disp=[0.3, 0.5])
    if bad is None:
        soak_train.check(good)
    else:
        with pytest.raises(AssertionError, match=match):
            soak_train.check(dict(good, **bad))


def test_dryrun_multichip_two_cpu_ranks(capsys):
    dryrun_multichip.main(["2", "--device", "cpu"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    m = re.fullmatch(r"dryrun_multichip\(2\) ok: total_loss=(\S+) \(mesh "
                     r"\{'data': 1, 'model': 2\}, (\d+) tp-sharded weight "
                     r"tensors\)", line)
    assert m, line
    assert math.isfinite(float(m.group(1)))
    cfg = Config(image_size=32, img_size=32, batch_size=2, num_hypo_cams=2,
                 anti_aliasing=False, subdivide=2, tex_size=2)
    template = build_template(cfg.subdivide, cfg.axis, cfg.tex_size)
    jax_sharded, _ = jax_partition_specs(
        meta_s2_state(cfg, template), template, cfg.num_hypo_cams,
        dryrun_multichip.MIN_SIZE, shapes_only=True)
    assert int(m.group(2)) == len(jax_sharded) == 143
