"""Configuration: one frozen dataclass with the reference's CLI flag names
(copy of umr_tpu/config.py::Config without its absl bridge, so that the
port never imports the JAX package; tests/test_torch_host.py pins the
fields, their defaults and validate() equal to the JAX package's).

Most fields are read by the JAX package's trainers only; the port's
inference entry points read the model, renderer and I/O ones. cli.py
builds the command line from these fields.

Beside it, what every entry point and the training layer share: the
device rule (resolve_device), the model variants the JAX package cannot
run either (check_supported) and the ResNet input normalisation.
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass

import numpy as np
import torch

from .parallel import data_rank_and_size, world_size

RESNET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
RESNET_STD = np.array([0.229, 0.224, 0.225], np.float32)


@dataclass(frozen=True)
class Config:
    # ---- experiment / harness (ref: train_utils.py:48-80) --------------
    name: str = "exp_name"
    checkpoint_dir: str = "cachedir/snapshots"
    vis_dir: str = "cachedir/visualization"
    num_epochs: int = 500
    num_pretrain_epochs: int = 0
    learning_rate: float = 1e-4
    beta1: float = 0.9
    use_sgd: bool = False
    optim_bs: int = 1
    num_iter: int = 0
    batch_size: int = 64
    print_freq: int = 20
    save_latest_freq: int = 3000
    save_epoch_freq: int = 301
    display_freq: int = 100
    display_visuals: bool = True
    print_scalars: bool = True
    is_train: bool = True
    workers: int = 16

    # ---- data (ref: data/base.py:47-57, data/cub.py:45-48) -------------
    img_size: int = 256
    image_size: int = 256          # alias kept for CLI parity
    padding_frac: float = 0.05
    jitter_frac: float = 0.05
    split: str = "train"
    num_kps: int = 15
    n_data_workers: int = 4
    dataset: str = "cub"
    cub_dir: str = "CUB_200_2011/"
    cub_cache_dir: str = "unsup-mesh/cachedir/cub/"
    scops_path: str = "SCOPS/results/cub/ITER_60000/train/dcrf_prob"
    use_scops: bool = True
    number_pairs: int = 10000

    # ---- model (ref: cub_mesh.py:29-48) ---------------------------------
    symmetric: bool = True
    symmetric_texture: bool = True
    multiple_cam_hypo: bool = True
    nz_feat: int = 200
    z_dim: int = 350
    num_hypo_cams: int = 8
    az_ele_quat: bool = False
    scale_lr_decay: float = 0.05
    scale_bias: float = 1.0
    use_texture: bool = True
    tex_size: int = 6
    subdivide: int = 3
    only_mean_sym: bool = False
    axis: int = 1
    pred_cam: bool = True
    renderer_type: str = "softmax"
    use_gan: bool = True
    detach_shape: bool = True
    detach_cam: bool = True
    stemp_path: str = "unsup-mesh/cachedir/cub/scops/"
    model_path: str = "unsup-mesh/cachedir/snapshots/cub_net/pred_net_latest.pth"
    out_dir: str = "unsup-mesh/cachedir/snapshots/cub_net/"
    out_path: str = "unsup-mesh/cachedir/demo/"
    img_path: str = "demo_imgs/birdie.jpg"
    num_parts: int = 4
    avg_uv_exemplar_retries: int = 16
    part_min_vert_frac: float = 0.02
    force_template: bool = False
    mode: str = "flow"
    sigma: int = 3
    visualize: bool = False
    results_vis_dir: str = "cachedir/results_vis"
    sample_num: int = 4

    # ---- loss weights (ref: train_s2.py:49-60 / train_s1.py:46-67) -----
    mask_loss_wt: float = 2.5
    grl_wt: float = 0.2
    gan_loss_wt: float = 1.0
    triangle_reg_wt: float = 0.15
    flatten_reg_wt: float = 0.0005
    tex_loss_wt: float = 3.0
    tex_dt_loss_wt: float = 3.0
    tex_cycle_loss_wt: float = 1.0
    ent_loss_wt: float = 0.05
    prob_loss_wt: float = 5.0
    vertex_loss_wt: float = 10.0
    deform_reg_wt: float = 1.0
    ori_reg_wt: float = 0.4
    stop_ori_epoch: float = 3.0
    update_template_freq: int = 5

    # ---- implementation knobs -------------------------------------------
    anti_aliasing: bool = True     # reference renders 2x + avg-pool
    face_chunk: int = 160
    pixel_rows_per_block: int = 32
    data_parallel: bool = True
    seed: int = 0
    bf16: bool = False
    hypo_render_chunks: int = 1
    cycle_soft_p2f: bool = False

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)

    def validate(self):
        """Reject non-default values of flags whose non-default behaviour
        is not implemented: reference code paths scoped out
        (NotImplementedError) and flags dead in the reference too
        (ValueError), and a batch_size (the global batch) that the ranks
        of this process's group do not divide (ValueError). Returns self
        so it chains."""
        ni = {"symmetric": True, "only_mean_sym": False,
              "symmetric_texture": True}
        for k, default in ni.items():
            if getattr(self, k) != default:
                raise NotImplementedError(
                    f"--{k}={getattr(self, k)} is a reference code path this "
                    f"rebuild does not implement; only {k}={default} is "
                    "supported.")
        size = data_rank_and_size()[1]
        if self.batch_size % size:
            raise ValueError(
                f"--batch_size={self.batch_size} is the global batch: the "
                f"{size} ranks of this run do not divide it")
        dead = {"detach_shape": True, "detach_cam": True, "workers": 16,
                "num_kps": 15, "dataset": "cub"}
        for k, default in dead.items():
            if getattr(self, k) != default:
                raise ValueError(
                    f"--{k}={getattr(self, k)}: this flag is accepted for CLI "
                    "parity but is dead in the reference as well; a "
                    f"non-default value would do nothing. Keep {k}={default!r}.")
        return self

    def sync_image_size(self):
        """Keep the duplicate image_size/img_size in sync: an explicitly
        set one wins; image_size takes priority."""
        if self.image_size != 256:
            return self.replace(img_size=self.image_size)
        if self.img_size != 256:
            return self.replace(image_size=self.img_size)
        return self


def resolve_device(device=None):
    """The entry points' device: the card unless the caller names another
    (device="cpu" for the CPU); in a group of ranks, the rank's card
    (parallel/mesh.py::make_mesh sets it current). No quiet fallback:
    asking for the card where none is visible raises."""
    device = torch.device(device if device is not None else "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible; pass device='cpu' "
                           "to run on the CPU")
    if device.type == "cuda" and device.index is None and world_size() > 1:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def check_supported(cfg: Config, stage=2, train=True):
    """Refuse the model variants the JAX package cannot run either, with
    its reason; every other flag builds. A training step of either stage
    reads the predicted camera, which pred_cam=False does not produce,
    and so does test_iou's render; stage 2's step also reads the camera
    hypotheses, which the one-camera model (multiple_cam_hypo=False)
    does not produce. The eval model (train=False) takes one camera."""
    if not cfg.pred_cam:
        raise NotImplementedError(
            "--pred_cam=False: the model then predicts no camera, and the "
            "JAX package's losses and test_iou read outputs['cam'] (it "
            "cannot run this either)")
    if train and stage == 2 and not cfg.multiple_cam_hypo:
        raise NotImplementedError(
            "--multiple_cam_hypo=False in the stage-2 step: the one-camera "
            "model gives no camera hypotheses, and the JAX package's step "
            "reads outputs['cam_hypotheses'] (it cannot run this either)")


def normalize_images(imgs):
    """Images [..., 3] in [0, 1] -> the encoder's input, normalised with
    the ImageNet mean and std: numpy float32 on the host, or a float32
    tensor on its own device (the constants cached there)."""
    if torch.is_tensor(imgs):
        mean, std = _resnet_consts(imgs.device)
        return (imgs - mean) / std
    return (imgs - RESNET_MEAN) / RESNET_STD


@functools.lru_cache(maxsize=None)
def _resnet_consts(device):
    return (torch.as_tensor(RESNET_MEAN, device=device),
            torch.as_tensor(RESNET_STD, device=device))
