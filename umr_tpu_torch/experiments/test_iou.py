"""Mask-IoU evaluation: render the predicted mesh at the predicted camera,
alpha channel vs the ground-truth mask (port of
umr_tpu/experiments/test_iou.py).

  python -m umr_tpu_torch.experiments.test_iou --model_path <pth> \\
      --cub_dir CUB_200_2011/ --cub_cache_dir <cache> [--visualize]

run() reads CUB's --split (test on the command line; data/cub.py,
unshuffled, unmirrored) unless given a dataloader. --visualize writes,
for the first 5 batches, sample_num ground-truth and predicted mask grids
and textured meshes into {results_vis_dir}/vis_iter_<n>/.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..config import (Config, check_supported, normalize_images,
                      resolve_device)
from ..data.cub import data_loader
from ..mesh import build_template
from ..models.mesh_net import MeshNet, symmetrize
from ..models.weights import load_checkpoint
from ..ops.grid_sample import sample_textures
from ..renderer import SoftRenderer
from ..training.visuals import save_visuals

VIS_BATCHES = 5     # --visualize dumps the first batches only


def build_eval_model(cfg: Config, template, device=None):
    """MeshNet-s2 in cfg's variant (use_texture, multiple_cam_hypo, as
    the JAX package's build_eval_model; az_ele_quat too, so that such a
    checkpoint's 3-wide quaternion layers load) with the weights of
    cfg.model_path, in eval mode."""
    check_supported(cfg, train=False)
    device = resolve_device(device)
    model = MeshNet(template, input_size=cfg.image_size, nz_feat=cfg.nz_feat,
                    z_dim=cfg.z_dim, num_hypo_cams=cfg.num_hypo_cams,
                    use_texture=cfg.use_texture,
                    multiple_cam_hypo=cfg.multiple_cam_hypo,
                    az_ele_quat=cfg.az_ele_quat)
    load_checkpoint(model, cfg.model_path)
    return model.to(device).eval()


def prepare_batch(batch):
    """Batch dict -> (normalised input images, masks): numpy, or float32
    tensors on the device the batch's lie on (a device loader's)."""
    imgs, mask = batch["img"], batch["mask"]
    if torch.is_tensor(imgs):
        return normalize_images(imgs.float()), mask.float()
    return normalize_images(imgs.astype(np.float32)), mask.astype(np.float32)


@torch.no_grad()
def predict_masks(model, renderer, faces, batch_img, eps=None,
                  sample_inds=None, generator=None):
    """batch_img [B,H,W,3] (normalised) -> (rendered alpha [B,H,W], the
    model's outputs)."""
    out = model(batch_img, eps=eps, sample_inds=sample_inds,
                generator=generator)
    verts = (model.get_mean_shape()[None]
             + symmetrize(out["delta_v"], model.template))
    rendered = renderer.render(verts, faces, out["cam"])
    return rendered.rgba[..., 3], out


def save_iou_visuals(cfg: Config, model, batch, out, pred_mask, vis_iter):
    """The first sample_num samples of a batch: image_gt, mask_gt and
    mask_pred grids and mesh_<i>.obj, textured from the image where the
    model predicts texture, into {results_vis_dir}/vis_iter_<vis_iter>/."""
    n = min(cfg.sample_num, batch["img"].shape[0])
    device = pred_mask.device
    imgs = torch.as_tensor(batch["img"][:n], device=device).float()
    mask = torch.as_tensor(batch["mask"][:n], device=device).float()
    vis = {
        "image_gt": imgs.cpu().numpy(),
        "mask_gt": mask[..., None].cpu().numpy(),
        "mask_pred": pred_mask[:n, ..., None].cpu().numpy(),
    }
    verts = (model.get_mean_shape()[None]
             + symmetrize(out["delta_v"][:n], model.template)).cpu().numpy()
    tex = None
    if "tex_flow" in out:
        tex = sample_textures(out["tex_flow"][:n], imgs)
        B, F, T = tex.shape[:3]
        tex = tex.reshape(B, F, T * T, 3).cpu().numpy()
    for i in range(n):
        vis[f"mesh_{i}"] = (verts[i], model.template.faces,
                            None if tex is None else tex[i])
    save_visuals(vis, os.path.join(cfg.results_vis_dir,
                                   f"vis_iter_{vis_iter}"))


def run(cfg: Config, dataloader=None, device=None):
    """Mean mask IoU over the batches of `dataloader` (dicts with 'img'
    [B,H,W,3] in [0,1] and 'mask' [B,H,W], numpy or tensors; by default
    the CUB loader of cfg's files, unshuffled and unmirrored)."""
    device = resolve_device(device)
    if dataloader is None:
        dataloader = data_loader(cfg, shuffle=False, mirror=False,
                                 device=device)
    template = build_template(cfg.subdivide, cfg.axis, cfg.tex_size)
    model = build_eval_model(cfg, template, device)
    renderer = SoftRenderer(image_size=cfg.image_size, render_type="softmax",
                            anti_aliasing=cfg.anti_aliasing)
    faces = torch.as_tensor(template.faces, device=device)
    generator = torch.Generator(device)
    ious = []
    vis_iter = 0
    for batch in dataloader:
        input_img, mask_gt = prepare_batch(batch)
        # every batch draws with the same seed, as the JAX loop reuses its key
        generator.manual_seed(cfg.seed)
        pred_mask, out = predict_masks(
            model, renderer, faces,
            torch.as_tensor(input_img, device=device), generator=generator)
        mask_pred = pred_mask.reshape(pred_mask.shape[0], -1)
        mask_gt = torch.as_tensor(mask_gt, device=device).reshape(
            mask_pred.shape)
        inter = (mask_gt * mask_pred).sum(1)
        union = (mask_gt + mask_pred - mask_gt * mask_pred).sum(1)
        ious.append((inter / union).cpu().numpy())
        if cfg.visualize and vis_iter < VIS_BATCHES:
            save_iou_visuals(cfg, model, batch, out, pred_mask, vis_iter)
            vis_iter += 1
    iou = float(np.concatenate(ious).mean())
    print("Average mask IoU: {:.4f}.".format(iou))
    return iou


def main(argv=None):
    from ..cli import parse_config

    run(parse_config(argv, overrides=dict(
        split="test", use_scops=False, batch_size=32, is_train=False)))


if __name__ == "__main__":
    main()
