"""Data parallelism of the port (umr_tpu_torch/parallel/, the global
BatchNorm of models/net_blocks.py, the steps, the trainer) on the CPU:
ranks are processes spawned by parallel.spawn in one gloo group, with a
file:// rendezvous under tmp_path (so xdist workers do not collide), at
the parity tests' size (subdivide 2, 32^2, K=2, narrow heads).

  * The global BatchNorm (BatchNorm2d, fc's BatchNorm1d, and BatchNorm2d
    on a bfloat16 input) on 2 ranks x batch 2 against one process at
    batch 4: outputs, input gradients, the weight and bias gradients
    summed over the ranks, and the running statistics within 1e-6
    absolute plus 1e-6 relative (sums of 60 values of magnitude ~10 in
    another order; reading 4.8e-7 relative).
  * The s2 step on 2 ranks x 2 against the JAX package's
    umr_tpu.parallel.data_parallel_step over a 2-device mesh at a global
    batch of 4 (tests/torch_parity.py::step_parity, its weights and
    draws): test_torch_train.py's s2 bounds: gradient cosine >= 0.998
    (reading 0.99954), each tensor within 0.3 of its norm plus 1e-6 of
    the total (reading 0.12) but one, JAX_UNSTABLE, which JAX's own
    sharded and unsharded steps put 0.93 apart and which is held within
    that gap (reading 0.48); scalars rtol 1e-4 for the model's own, 2e-3
    through renders.
  * The same 2-rank step against the port's one-process step at batch 4:
    cosine >= 0.99999 (reading 0.9999945) and each tensor within REL of
    its norm plus 1e-6 of the total (reading 0.11, the discriminator's
    biases: the GAN view's renders amplify the BatchNorms' last-ulp
    differences, gan_loss 3.0e-4 apart); the model's own scalars within
    1e-5, those through renders within 1e-3. The same step with each
    rank's BatchNorms over its own batch (the negative control) falls
    outside both bounds (reading: cosine 0.068, worst tensor 6.6e3).
  * Stage 1: the template update and one s1 step on 2 ranks against one
    process: mean_v within 1e-6 (reading 1.2e-7).
  * Every rank's weights, buffers, optimizer state, generator state and
    counts are equal after each step (a digest per rank).
  * A group of one rank steps as no group does, bit for bit.
  * A 2-rank train_s2.run of 2 steps, resumed for a third: one writer.
  * The refusals: a batch the ranks do not divide, a rank that fails,
    --nodata_parallel under a torchrun of several processes.
"""

import itertools
import os
import threading

import numpy as np
import pytest
import torch

from torch_parity import cosine, grads_close, part_semantic, step_parity
from torch_ranks import rank_bn, rank_steps, rank_train
from umr_tpu_torch.data import synthetic_batch
from umr_tpu_torch.mesh import build_template
from umr_tpu_torch.parallel import launch, mesh, shard_batch, spawn
from umr_tpu_torch.training.trainer import prepare_batch

IMG = 32
LR = 1e3
KW = dict(image_size=IMG, img_size=IMG, batch_size=4, num_hypo_cams=2,
          anti_aliasing=False, subdivide=2, tex_size=2, nz_feat=32, z_dim=24,
          use_sgd=True, learning_rate=LR)
JAX_KW = dict(face_chunk=320, pixel_rows_per_block=IMG)
MODEL_SCALARS = ("cam_div_loss", "corr_loss", "deform_loss", "flatten_loss",
                 "tri_loss", "uv_flow_area", "acc_gan")
_RENDEZVOUS = itertools.count()
REL = 0.25            # per tensor, the 2-rank step against one process
COS = 0.99999
# a gradient that JAX's own sharded and unsharded steps put 0.93 of its
# norm apart (step_parity with and without mesh=2; the port's one-process
# step reads 0.46 against the sharded one, 0.11 against the unsharded)
JAX_UNSTABLE = ("model.cam_predictor.camera_predictor.1.scale_predictor."
                "pred_layer.bias")
JAX_SELF_GAP = 0.93


def _spawn(tmp_path, fn, n, *args):
    """fn(*args) on n CPU ranks with a fresh file:// rendezvous."""
    rdv = tmp_path / f"rendezvous_{next(_RENDEZVOUS)}"
    return spawn(fn, n, *args, device="cpu", init_method=f"file://{rdv}")


def _scalars_close(sc, ref, render_rtol):
    """The model's own scalars within 1e-5 relative, those through renders
    within render_rtol: their silhouettes at sigma 1e-5 amplify the
    BatchNorms' last-ulp differences."""
    assert sorted(sc) == sorted(ref)
    for k, v in ref.items():
        rtol = 1e-5 if k in MODEL_SCALARS + ("ori_loss",) else render_rtol
        np.testing.assert_allclose(sc[k], v, rtol=rtol, atol=1e-7,
                                   err_msg=k)


def _rel_per_tensor(g, ref):
    """Worst ||g - ref|| / (||ref|| + 1e-6 x the norm of all of ref) over
    the tensors, and the cosine of all of them."""
    total = np.sqrt(sum(np.sum(v.astype(np.float64) ** 2)
                        for v in ref.values()))
    worst = max(np.linalg.norm(g[k] - ref[k])
                / (np.linalg.norm(ref[k]) + 1e-6 * total) for k in ref)
    x = np.concatenate([g[k].ravel() for k in ref]).astype(np.float64)
    y = np.concatenate([ref[k].ravel() for k in ref]).astype(np.float64)
    return worst, float(x @ y / (np.linalg.norm(x) * np.linalg.norm(y)))


# ---- the global BatchNorm ----------------------------------------------

def _bn_cases():
    rng = np.random.RandomState(11)
    cases = []
    for kind, shape, dtype in (("2d", (4, 6, 3, 5), torch.float32),
                               ("1d", (4, 7), torch.float32),
                               ("2d", (4, 6, 3, 5), torch.bfloat16)):
        x = rng.normal(0.3, 2.0, shape).astype(np.float32)
        if dtype == torch.bfloat16:      # values a bfloat16 input holds
            x = torch.as_tensor(x).bfloat16().float().numpy()
        cases.append(dict(kind=kind, dtype=dtype, seed=len(cases), x=x,
                          g=rng.normal(0.0, 1.0, shape).astype(np.float32)))
    return cases


@pytest.fixture(scope="module")
def bn_runs(tmp_path_factory):
    cases = _bn_cases()
    ranks = _spawn(tmp_path_factory.mktemp("bn"), rank_bn, 2, cases)
    return cases, rank_bn(cases), ranks


@pytest.mark.parametrize("case", [0, 1, 2], ids=["bn2d", "bn1d", "bn2d_bf16"])
def test_global_batch_norm_matches_one_process(bn_runs, case):
    _, one, ranks = bn_runs
    want, got = one[case], [r[case] for r in ranks]
    for k in ("y", "dx"):
        np.testing.assert_allclose(np.concatenate([g[k] for g in got]),
                                   want[k], rtol=1e-6, atol=1e-6, err_msg=k)
    for k in ("dw", "db"):
        np.testing.assert_allclose(got[0][k] + got[1][k], want[k], rtol=1e-6,
                                   atol=1e-6, err_msg=k)
    for k in ("running_mean", "running_var", "n"):
        for g in got:
            np.testing.assert_allclose(g[k], want[k], rtol=1e-6, atol=1e-6,
                                       err_msg=k)


# ---- the s2 step -------------------------------------------------------

@pytest.fixture(scope="module")
def s2dp(tmp_path_factory):
    """The JAX step over a 2-device mesh and the port's one-process step
    (step_parity), and meanwhile, in a thread, the port's step on 2 ranks
    from the same weights, batch and draws, with global and with per-rank
    BatchNorms."""
    seg, pvi = part_semantic(build_template(2, 1, 2))
    tmp, box = tmp_path_factory.mktemp("s2"), {}

    def on_ranks(inputs):
        spec = dict(stage=2, kw=KW, template=(2, 1, 2), seg=seg, pvi=pvi,
                    init=inputs["init"], batch=inputs["db"],
                    draws=inputs["draws"])

        def run():
            try:
                box["ranks"] = _spawn(tmp, rank_steps, 2,
                                      [spec, dict(spec, per_rank_bn=True)])
            except BaseException as e:  # noqa: BLE001 — raised below
                box["error"] = e

        box["thread"] = threading.Thread(target=run)
        box["thread"].start()

    r = step_parity(2, KW, JAX_KW, LR, mesh=2, on_inputs=on_ranks)
    box["thread"].join()
    if "error" in box:
        raise box["error"]
    return r, box["ranks"]


def test_s2_two_ranks_match_jax_data_parallel_step(s2dp):
    r, ranks = s2dp
    dp = ranks[0][0]
    assert sorted(dp["scalars"]) == sorted(r["jax_sc"])
    for k, v in r["jax_sc"].items():
        rtol = 1e-4 if k in MODEL_SCALARS else 2e-3
        np.testing.assert_allclose(dp["scalars"][k], v, rtol=rtol, atol=1e-7,
                                   err_msg=k)
    # the heads no loss reaches have no gradient on the port's side
    g = {k: dp["grads"].get(k, np.zeros_like(v))
         for k, v in r["jax_grads"].items()}
    assert cosine(g, r["jax_grads"]) >= 0.998
    grads_close({k: v for k, v in g.items() if k != JAX_UNSTABLE},
                r["jax_grads"], 0.3, 0.998)
    # JAX_UNSTABLE within JAX's own gap between its sharded and unsharded
    # steps (0.93 of its norm; the 2-rank step reads 0.48)
    u, ju = g[JAX_UNSTABLE], r["jax_grads"][JAX_UNSTABLE]
    gap = np.linalg.norm(u - ju) / np.linalg.norm(ju)
    assert gap <= JAX_SELF_GAP, gap


def test_s2_two_ranks_match_one_process(s2dp):
    r, ranks = s2dp
    dp = ranks[0][0]
    assert ranks[0][0]["digest"] == ranks[1][0]["digest"]
    assert ranks[0][0]["scalars"] == ranks[1][0]["scalars"]
    worst, cos = _rel_per_tensor(dp["grads"], r["port_grad"])
    assert cos >= COS and worst <= REL, (cos, worst)
    _scalars_close(dp["scalars"], r["port_sc"], 1e-3)  # reading 3.0e-4


def test_per_rank_batch_norm_falls_outside_the_bound(s2dp):
    """The negative control: with each rank's BatchNorms over its own
    batch the 2-rank step is not the one-process step."""
    r, ranks = s2dp
    worst, cos = _rel_per_tensor(ranks[0][1]["grads"], r["port_grad"])
    assert cos < COS and worst > REL, (cos, worst)


# ---- stage 1, the group of one, the refusals ---------------------------

def _s1_spec():
    rng = np.random.RandomState(21)
    batch = prepare_batch(synthetic_batch(rng, 4, IMG), use_scops=False)
    updates = [prepare_batch(synthetic_batch(rng, 4, IMG), use_scops=False)
               for _ in range(2)]
    draws = dict(eps=rng.normal(size=(4, KW["z_dim"])).astype(np.float32),
                 angles=rng.randint(0, 180, size=4))
    kw = dict(KW, use_sgd=False, learning_rate=1e-4, use_scops=False)
    return dict(stage=1, kw=kw, template=(2, 1, 2), batch=batch,
                draws=draws, template_batches=updates)


@pytest.fixture(scope="module")
def s1dp(tmp_path_factory):
    spec = _s1_spec()
    one = rank_steps([spec])[0]
    ranks = _spawn(tmp_path_factory.mktemp("s1"), rank_steps, 2, [spec])
    alone = _spawn(tmp_path_factory.mktemp("s1_one"), rank_steps, 1, [spec])
    return one, [r[0] for r in ranks], alone[0][0]


def test_s1_template_update_and_step_on_two_ranks(s1dp):
    """The template update from 2 batches (8 images) on 2 ranks, then one
    s1 step: mean_v within 1e-6 of one process's (reading 1.2e-7), the
    model's own scalars within 1e-5 and those through renders within
    1e-2 (reading 1.5e-3, tex_loss). At this size the s1 step is chaotic:
    a 1e-6 relative perturbation of its input images moves one process's
    own tex_loss by 1.6e-3 and its gradient to cosine 0.9995, and the
    BatchNorms' order of summation on 2 ranks moves the gradient to
    0.9988; so its gradient is not held here (the s2 step above and
    chip_smoke.py's phase 17 hold the gradients)."""
    one, ranks, _ = s1dp
    assert ranks[0]["digest"] == ranks[1]["digest"]
    assert ranks[0]["count"] == ranks[1]["count"] == one["count"] == 8
    np.testing.assert_allclose(ranks[0]["mean_v"], one["mean_v"], rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(ranks[0]["mean_v"], ranks[1]["mean_v"])
    _scalars_close(ranks[0]["scalars"], one["scalars"], 1e-2)


def test_a_group_of_one_steps_as_no_group(s1dp):
    """The group code at world size 1 is the one-process step: the same
    template, scalars, gradients and state bit for bit."""
    one, _, alone = s1dp
    np.testing.assert_array_equal(alone["mean_v"], one["mean_v"])
    assert alone["scalars"] == one["scalars"]
    assert alone["digest"] == one["digest"]
    for k, v in one["grads"].items():
        np.testing.assert_array_equal(alone["grads"][k], v, err_msg=k)


def test_shard_batch_takes_the_rank_block_and_refuses_a_remainder(
        monkeypatch):
    batch = {"a": np.arange(6), "b": torch.arange(12).reshape(6, 2)}
    assert shard_batch(batch) is batch              # no group
    monkeypatch.setattr(mesh, "rank_and_size", lambda: (1, 3))
    got = shard_batch(batch)
    np.testing.assert_array_equal(got["a"], [2, 3])
    assert got["b"].tolist() == [[4, 5], [6, 7]]
    monkeypatch.setattr(mesh, "rank_and_size", lambda: (0, 2))
    with pytest.raises(ValueError, match="do not divide"):
        shard_batch({"a": np.arange(5)})


def test_launch_refuses_nodata_parallel_under_a_torchrun_of_several(
        monkeypatch):
    """Each torchrun process would train alone on the same card and write
    the same files; a torchrun of one process runs as no torchrun."""
    ran = []
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="WORLD_SIZE=2"):
        launch(ran.append, 1, data_parallel=False)
    monkeypatch.setenv("WORLD_SIZE", "1")
    launch(ran.append, 2, data_parallel=False)
    assert ran == [2]


# ---- the trainer -------------------------------------------------------

def test_trainer_on_two_ranks_writes_once_and_resumes(tmp_path):
    """train_s2.run on 2 ranks for 2 steps, then again to 3: one
    pred_net_latest.pth, loss_log.txt, stage_budget.json and opts.log
    (rank 0's), both ranks resume at step 2, and their states are equal
    after each run. A batch the ranks do not divide is refused, and the
    failed rank fails the launch."""
    template = build_template(2, 1, 2)
    seg, pvi = part_semantic(template)
    rng = np.random.RandomState(4)
    batches = [synthetic_batch(rng, 4, IMG) for _ in range(3)]
    kw = dict(KW, use_sgd=False, learning_rate=1e-4, print_freq=1,
              checkpoint_dir=str(tmp_path / "snap"), name="dp")
    semantic = (template.mean_v_init * 1.1, seg, pvi)
    ranks = _spawn(tmp_path, rank_train, 2, kw, batches, semantic, [2, 3])
    assert ranks[0] == ranks[1], ranks
    (step_a, n_a, _), (step_b, n_b, _) = ranks[0]
    assert (step_a, n_a, step_b, n_b) == (2, 2, 3, 1)
    run_dir = tmp_path / "snap" / "dp"
    assert sorted(os.listdir(run_dir)) == [
        "loss_log.txt", "opts.log", "pred_net_latest.pth", "pred_state.pt",
        "stage_budget.json"]
    log = (run_dir / "loss_log.txt").read_text().splitlines()
    assert sum("Training Loss" in line for line in log) == 2    # two runs
    assert sum(line.startswith("(epoch") for line in log) == 3  # 3 steps

    with pytest.raises(RuntimeError, match="batch_size=3"):
        _spawn(tmp_path, rank_train, 2, dict(kw, batch_size=3), batches,
               semantic, [1])
