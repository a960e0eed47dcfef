"""The port (the inference slice, a training step of each stage and a
flag variant's (--bf16 --nouse_texture), the stage handoff through
files: avg_uv, test_kp, the synthetic category with its loader and
curriculum tools, and the CUB data path: train_s1 and test_iou
--visualize from a --cub_dir with no loader passed, the native EDT, the
JPEG reader's module; train_s1 from the --cub_dir on two ranks spawned
by parallel.spawn, one torch thread each, which report what they
imported; dryrun_multichip's tensor-parallel step on two CPU ranks; the
off-path tools and utilities imported: profile_step, the RotNet
pretraining, the voxelizer, geometry and the CRF) runs with jax,
flax, optax, orbax, absl, imageio, cv2, PIL and the JAX package umr_tpu
unavailable, and no file of it (nor chip_smoke.py, nor the rank side
it spawns, tests/torch_ranks.py) imports them: the machine with the
card has none of them but umr_tpu, whose __init__ imports jax wherever
jax is installed."""

import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "absl", "imageio",
           "cv2", "PIL", "umr_tpu")

SCRIPT = r"""
import os, sys
for m in %(blocked)r:
    sys.modules[m] = None
import numpy as np
import torch
torch.set_num_threads(2)
import umr_tpu_torch
from umr_tpu_torch.config import Config
from umr_tpu_torch.data import synthetic_batch
from umr_tpu_torch.experiments import demo, test_iou
from umr_tpu_torch.mesh import build_template
from umr_tpu_torch.models import MeshNet, init_weights

tmp = sys.argv[1]
t = build_template(2, 1, 2)
m = init_weights(MeshNet(t, input_size=32, nz_feat=16, z_dim=8,
                         num_hypo_cams=2), torch.Generator().manual_seed(0))
path = os.path.join(tmp, "pred_net.pth")
torch.save(m.state_dict(), path)
cfg = Config(image_size=32, subdivide=2, tex_size=2, num_hypo_cams=2,
             nz_feat=16, z_dim=8, model_path=path).sync_image_size()
batch = synthetic_batch(np.random.RandomState(0), 2, 32)
iou = test_iou.run(cfg, dataloader=[batch], device="cpu")
panel = demo.render_panels(test_iou.build_eval_model(cfg, t, "cpu"),
                           batch["img"][0])
assert panel.shape == (64, 96, 3) and np.isfinite(panel).all()
from umr_tpu_torch.experiments import train_s2
cfg = Config(image_size=32, img_size=32, batch_size=2, num_hypo_cams=2,
             anti_aliasing=False, subdivide=2, tex_size=2, nz_feat=16,
             z_dim=8, num_iter=1, print_scalars=False,
             checkpoint_dir=os.path.join(tmp, "snap"))
rng = np.random.RandomState(1)
pvi = [rng.permutation(t.num_verts)[:20] for _ in range(4)]
trainer = train_s2.run(cfg, [synthetic_batch(rng, 2, 32)], device="cpu",
                       semantic=(None, rng.randint(0, 5, (16, 32)), pvi))
assert trainer.state.step == 1
assert all(np.isfinite(v) for v in trainer.history[0].values())
from umr_tpu_torch.experiments import train_s1
cfg = train_s1.config(["--image_size", "32", "--batch_size", "2",
                       "--anti_aliasing=false", "--subdivide", "1",
                       "--tex_size", "2", "--nz_feat", "16", "--z_dim", "8",
                       "--num_iter", "1", "--noprint_scalars",
                       "--checkpoint_dir", os.path.join(tmp, "snap"),
                       "--name", "s1"])
trainer = train_s1.run(cfg, [synthetic_batch(rng, 2, 32)], device="cpu")
assert trainer.state.step == 1
assert all(np.isfinite(v) for v in trainer.history[0].values())
# a flag variant: bf16 without texture, from the command line
vcfg = train_s1.config(["--image_size", "32", "--batch_size", "2",
                        "--anti_aliasing=false", "--subdivide", "1",
                        "--tex_size", "2", "--nz_feat", "16", "--z_dim", "8",
                        "--num_iter", "1", "--noprint_scalars", "--bf16",
                        "--nouse_texture", "--nodisplay_visuals",
                        "--checkpoint_dir", os.path.join(tmp, "snap"),
                        "--name", "s1_variant"])
trainer = train_s1.run(vcfg, [synthetic_batch(rng, 2, 32)], device="cpu")
assert trainer.state.step == 1 and "tex_loss" not in trainer.history[0]
assert all(np.isfinite(v) for v in trainer.history[0].values())
from umr_tpu_torch.experiments import avg_uv, test_kp
cfg = cfg.replace(model_path=os.path.join(tmp, "snap", "s1",
                                          "pred_net_latest.pth"),
                  out_dir=os.path.join(tmp, "stemp"))
out = avg_uv.run(cfg, [synthetic_batch(rng, 2, 32)], device="cpu")
assert os.path.exists(os.path.join(out, "semantic_seg.png"))
cfg = Config(image_size=32, img_size=32, subdivide=2, tex_size=2,
             num_hypo_cams=2, nz_feat=16, z_dim=8, model_path=path,
             number_pairs=2, mode="cam", anti_aliasing=False)
pairs = [[synthetic_batch(rng, 1, 32) for _ in range(2)] for _ in range(2)]
pck = test_kp.run(cfg, pairs, device="cpu")
assert 0.0 <= pck[0] <= pck[1] <= 1.0
from umr_tpu_torch.data.synthetic_category import (CategoryLoader,
                                                   generate_dataset)
from umr_tpu_torch.experiments import (eval_kp_pairs, extend_s2,
                                       synthetic_parity)
data = generate_dataset(build_template(1, 1, 2), 2, image_size=32, batch=2,
                        device="cpu")
batch = next(iter(CategoryLoader(data, 2, device_data=True, device="cpu")))
assert batch["img"].shape == (2, 32, 32, 3) and "head_points" in batch
# the CUB path from files: a two-image fixture, no loader passed
import scipy.io as sio
from umr_tpu_torch import jpeg, native
from umr_tpu_torch.data import cub, loader
from umr_tpu_torch.png import write_png
from umr_tpu_torch.training import visuals
root = os.path.join(tmp, "cub")
for d in ("cub/images/c", "cache/data", "cache/sfm"):
    os.makedirs(os.path.join(root, d))
bb = np.dtype([(k, "f8") for k in ("x1", "y1", "x2", "y2")])
images = np.empty((2,), np.dtype([(k, "O") for k in
                                  ("rel_path", "mask", "bbox", "parts")]))
sfm = np.empty((2,), np.dtype([(k, "O") for k in ("scale", "trans", "rot")]))
for i in range(2):
    write_png(os.path.join(root, "cub/images/c", f"b{i}.png"),
              rng.randint(0, 256, (40, 50, 3)).astype(np.uint8))
    mask = np.zeros((40, 50), np.uint8)
    mask[8:30, 10:40] = 1
    box = np.empty((1, 1), bb)
    box["x1"], box["y1"], box["x2"], box["y2"] = 11, 9, 40, 30
    kp = np.stack([rng.randint(12, 38, 15) * 1.0, rng.randint(10, 28, 15)
                   * 1.0, np.ones(15)])
    images[i] = (f"c/b{i}.png", mask, box, kp)
    sfm[i] = (np.float64(30.0), np.array([25.0, 20.0]), np.eye(3))
for split in ("train", "test"):
    sio.savemat(os.path.join(root, "cache/data", f"{split}_cub_cleaned.mat"),
                {"images": images})
    sio.savemat(os.path.join(root, "cache/sfm", f"anno_{split}.mat"),
                {"sfm_anno": sfm})
cub_dirs = ["--cub_dir", os.path.join(root, "cub"), "--cub_cache_dir",
            os.path.join(root, "cache")]
cfg = train_s1.config(["--image_size", "32", "--batch_size", "2",
                       "--anti_aliasing=false", "--subdivide", "1",
                       "--tex_size", "2", "--nz_feat", "16", "--z_dim", "8",
                       "--num_iter", "1", "--noprint_scalars",
                       "--n_data_workers", "2", "--name", "cub_s1",
                       "--checkpoint_dir", os.path.join(tmp, "snap")]
                      + cub_dirs)
trainer = train_s1.run(cfg, device="cpu")
assert trainer.state.step == 1
# the same from the files on 2 ranks (parallel.spawn, gloo on the CPU): the
# spawned ranks import nothing blocked either
with open(os.path.join(tmp, "ranks_probe.py"), "w") as f:
    f.write("import sys\n"
            "def train(cfg):\n"
            "    import torch\n"
            "    torch.set_num_threads(1)   # the ranks share the cores\n"
            "    from umr_tpu_torch.experiments import train_s1\n"
            "    trainer = train_s1.run(cfg, device='cpu')\n"
            "    return trainer.state.step, sorted(\n"
            "        k for k, v in sys.modules.items() if v is not None\n"
            "        and k.split('.')[0] in %(blocked)r)\n")
sys.path.insert(0, tmp)
from ranks_probe import train as probe_train
from umr_tpu_torch.parallel import spawn
ranks = spawn(probe_train, 2, cfg.replace(name="cub_s1_2ranks"),
              device="cpu")
assert ranks == [(1, []), (1, [])], ranks
# tensor parallelism: the dry run on 2 CPU ranks as a (1, 2) mesh
from umr_tpu_torch.experiments import dryrun_multichip
line = dryrun_multichip.run(2, "cpu")
assert "{'data': 1, 'model': 2}, 143 tp-sharded" in line, line
cfg = Config(image_size=32, subdivide=2, tex_size=2, num_hypo_cams=2,
             nz_feat=16, z_dim=8, model_path=path, split="test",
             batch_size=2, cub_dir=cub_dirs[1], cub_cache_dir=cub_dirs[3],
             use_scops=False, visualize=True,
             results_vis_dir=os.path.join(tmp, "rvis")).sync_image_size()
assert 0.0 <= test_iou.run(cfg, device="cpu") <= 1.0
assert os.path.exists(os.path.join(tmp, "rvis", "vis_iter_0", "mesh_0.obj"))
# the off-path tools and utilities: imported, not run (their runs are
# tests/test_torch_pretrain.py's, test_torch_profile_step.py's and
# test_torch_utils.py's)
from umr_tpu_torch import crf, geometry
from umr_tpu_torch.experiments import (pretrain_lpips, pretrain_trunk,
                                       profile_step, rotnet)
from umr_tpu_torch.ops import voxelize
loaded = [k for k, v in sys.modules.items()
          if v is not None and k.split(".")[0] in %(blocked)r]
assert not loaded, loaded
print("SLICE_OK", iou)
"""


def test_slice_runs_without_jax():
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    # the runs' checkpoints take ~1 GB: removed whatever the outcome
    with tempfile.TemporaryDirectory() as tmp:
        res = subprocess.run([sys.executable, "-c",
                              SCRIPT % {"blocked": BLOCKED}, tmp],
                             cwd=ROOT, env=env, capture_output=True,
                             text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    assert "SLICE_OK" in res.stdout


def test_no_file_of_the_port_imports_jax():
    pat = re.compile(
        r"^\s*(?:import|from)\s+(?:" + "|".join(BLOCKED) + r")(?:\.|\s|$)",
        re.M)
    files = sorted((ROOT / "umr_tpu_torch").rglob("*.py"))
    # chip_smoke.py and the rank side it spawns on the card
    files += [ROOT / "chip_smoke.py", ROOT / "tests" / "torch_ranks.py"]
    assert len(files) > 10
    for f in ("experiments/train_s1.py", "training/steps.py",
              "parallel/mesh.py", "parallel/__init__.py",
              "models/mesh_net.py", "ops/raster_kernel.py", "data/cub.py",
              "data/loader.py", "native.py", "jpeg.py",
              "training/visuals.py", "parallel/tensor.py",
              "experiments/dryrun_multichip.py",
              "experiments/soak_train.py",
              "experiments/check_fused_grads.py",
              "experiments/profile_step.py", "experiments/rotnet.py",
              "experiments/pretrain_trunk.py",
              "experiments/pretrain_lpips.py", "ops/voxelize.py",
              "geometry.py", "crf.py"):
        assert ROOT / "umr_tpu_torch" / f in files, f
    offenders = [str(f.relative_to(ROOT)) for f in files
                 if pat.search(f.read_text())]
    assert not offenders, offenders
