"""Mask-IoU evaluation: render the predicted mesh at the predicted camera,
alpha channel vs the ground-truth mask (port of
umr_tpu/experiments/test_iou.py).

  python -m umr_tpu_torch.experiments.test_iou --model_path <pth> ...

run() needs a dataloader: the CUB loader of the JAX package imports its
jax ops and is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import (Config, check_supported, normalize_images,
                      resolve_device)
from ..mesh import build_template
from ..models.mesh_net import MeshNet, symmetrize
from ..models.weights import load_checkpoint
from ..renderer import SoftRenderer


def build_eval_model(cfg: Config, template, device=None):
    """MeshNet-s2 with the weights of cfg.model_path, in eval mode."""
    check_supported(cfg)
    device = resolve_device(device)
    model = MeshNet(template, input_size=cfg.image_size, nz_feat=cfg.nz_feat,
                    z_dim=cfg.z_dim, num_hypo_cams=cfg.num_hypo_cams)
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


def run(cfg: Config, dataloader=None, device=None):
    """Mean mask IoU over the batches of `dataloader` (dicts with 'img'
    [B,H,W,3] in [0,1] and 'mask' [B,H,W], numpy or tensors)."""
    if dataloader is None:
        raise NotImplementedError(
            "pass a dataloader: the CUB loader is not ported yet")
    if cfg.visualize:
        raise NotImplementedError("--visualize is not ported")
    device = resolve_device(device)
    template = build_template(cfg.subdivide, cfg.axis, cfg.tex_size)
    model = build_eval_model(cfg, template, device)
    renderer = SoftRenderer(image_size=cfg.image_size, render_type="softmax",
                            anti_aliasing=cfg.anti_aliasing)
    faces = torch.as_tensor(template.faces, device=device)
    generator = torch.Generator(device)
    ious = []
    for batch in dataloader:
        input_img, mask_gt = prepare_batch(batch)
        # every batch draws with the same seed, as the JAX loop reuses its key
        generator.manual_seed(cfg.seed)
        pred_mask, _ = predict_masks(
            model, renderer, faces,
            torch.as_tensor(input_img, device=device), generator=generator)
        mask_pred = pred_mask.reshape(pred_mask.shape[0], -1)
        mask_gt = torch.as_tensor(mask_gt, device=device).reshape(
            mask_pred.shape)
        inter = (mask_gt * mask_pred).sum(1)
        union = (mask_gt + mask_pred - mask_gt * mask_pred).sum(1)
        ious.append((inter / union).cpu().numpy())
    iou = float(np.concatenate(ious).mean())
    print("Average mask IoU: {:.4f}.".format(iou))
    return iou


def main(argv=None):
    from ..cli import parse_config

    run(parse_config(argv, overrides=dict(
        split="test", use_scops=False, batch_size=32, is_train=False)))


if __name__ == "__main__":
    main()
