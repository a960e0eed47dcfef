"""Single-image demo: image -> textured mesh + novel views panel
(port of umr_tpu/experiments/demo.py).

  python -m umr_tpu_torch.experiments.demo --img_path <jpg> \\
      --model_path <pth> --out_path cachedir/demo/

render_panels is pure torch; run() adds the file I/O: a PNG input and
the PNG panel through the port's codec (png.py; a JPEG input raises).
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from ..config import RESNET_MEAN, RESNET_STD, Config
from ..models.mesh_net import symmetrize
from ..ops.grid_sample import sample_textures
from ..ops.quaternion import axis_angle_to_quat, hamilton_product
from ..png import read_image, write_png
from ..renderer import SoftRenderer

BLUE = (156 / 255.0, 199 / 255.0, 234 / 255.0)


def vis_renderer(image_size, anti_aliasing=True):
    """Visualisation renderer: hard RGB, white background, lighting
    ambient 0.8 + directional 0.4 along (0, 1, -1)."""
    return SoftRenderer(
        image_size=image_size, render_type="hard",
        background_color=(1.0, 1.0, 1.0), anti_aliasing=anti_aliasing,
        ambient_intensity=0.8, directional_intensity=0.4,
        light_direction=(0.0, 1.0, -1.0))


@torch.no_grad()
def predict_mesh(model, img, generator=None):
    """img [H,W,3] in [0,1] -> (verts [1,V,3], cams [1,7], textures
    [1,F,T*T,3], imgs [1,H,W,3])."""
    device = model.mean_v.device
    imgs = torch.as_tensor(np.asarray(img, np.float32), device=device)[None]
    mean = torch.as_tensor(RESNET_MEAN, device=device)
    std = torch.as_tensor(RESNET_STD, device=device)
    out = model((imgs - mean) / std, generator=generator)
    verts = (model.get_mean_shape()[None]
             + symmetrize(out["delta_v"], model.template))
    tex = sample_textures(out["tex_flow"], imgs)
    B, F, T = tex.shape[:3]
    return verts, out["cam"], tex.reshape(B, F, T * T, 3), imgs


@torch.no_grad()
def render_panels(model, img, renderer=None, generator=None):
    """img [H,W,3] in [0,1] -> panel [2H, 3W, 3] float ndarray: the input,
    the mesh in a flat blue and in its predicted texture, then three
    novel views 60 degrees of azimuth apart."""
    img = np.asarray(img, np.float32)
    renderer = renderer or vis_renderer(img.shape[0])
    verts, cams, tex, imgs = predict_mesh(model, img, generator)
    faces = torch.as_tensor(model.template.faces, device=verts.device)
    default_tex = torch.ones_like(tex) * tex.new_tensor(BLUE)

    top = [imgs[0]]
    for t in (default_tex, tex):
        top.append(renderer.render(verts, faces, cams, t).rgba[0, :, :, :3])
    base_rot = axis_angle_to_quat(verts.new_tensor([0.0, 1.0, 0.0]),
                                  verts.new_tensor(math.radians(60)))[None]
    bot = []
    q = cams[:, 3:]
    for _ in range(3):
        q = hamilton_product(base_rot, q)
        cam_i = torch.cat([cams[:, :3], q], dim=1)
        bot.append(renderer.render(verts, faces, cam_i, tex).rgba[0, :, :, :3])
    panel = torch.cat([torch.cat(top, dim=1), torch.cat(bot, dim=1)], dim=0)
    return panel.cpu().numpy()


def crop(img, bbox, bgval=0.0):
    """img [H,W,C] -> the [y0..y1, x0..x1] window of the integer bbox
    (x0, y0, x1, y1), with the part outside the image filled by bgval."""
    x0, y0, x1, y1 = (int(round(c)) for c in bbox)
    out = np.full((y1 - y0 + 1, x1 - x0 + 1, img.shape[2]), bgval)
    xs0, xs1 = max(0, x0), min(img.shape[1], x1 + 1)
    ys0, ys1 = max(0, y0), min(img.shape[0], y1 + 1)
    out[ys0 - y0:ys1 - y0, xs0 - x0:xs1 - x0] = img[ys0:ys1, xs0:xs1]
    return out


def resize(img, scale_factor):
    """Bilinear resize with half-pixel centres (as cv2.resize's default)
    of img [H,W,C] by scale_factor, the new size rounded."""
    h, w = np.round(np.array(img.shape[:2]) * scale_factor).astype(int)
    x = torch.as_tensor(np.ascontiguousarray(img)).permute(2, 0, 1)[None]
    y = torch.nn.functional.interpolate(x, size=(int(h), int(w)),
                                        mode="bilinear", align_corners=False)
    return y[0].permute(1, 2, 0).numpy()


def preprocess_image(img_path, img_size=256):
    """Scale the longer side to img_size, centre square crop, background 1.
    PNG files only (png.read_image)."""
    img = read_image(img_path) / 255.0
    if img.ndim == 2:
        img = np.repeat(img[:, :, None], 3, axis=2)
    img = resize(img[..., :3], float(img_size) / np.max(img.shape[:2]))
    center = np.round(np.array(img.shape[:2]) / 2).astype(int)[::-1]
    bbox = np.hstack([center - img_size / 2.0, center + img_size / 2.0 - 1])
    return crop(img, bbox, bgval=1.0).astype(np.float32)


def run(cfg: Config, device=None):
    """Write pred_tex.png and pred_mesh.obj for cfg.img_path into
    cfg.out_path; returns the png's path."""
    from ..mesh import build_template
    from ..obj_io import save_obj
    from .test_iou import build_eval_model

    template = build_template(cfg.subdivide, cfg.axis, cfg.tex_size)
    model = build_eval_model(cfg, template, device)
    img = preprocess_image(cfg.img_path, cfg.image_size)
    generator = torch.Generator(model.mean_v.device).manual_seed(cfg.seed)
    panel = render_panels(
        model, img, vis_renderer(cfg.image_size, cfg.anti_aliasing),
        generator)
    os.makedirs(cfg.out_path, exist_ok=True)
    out_png = os.path.join(cfg.out_path, "pred_tex.png")
    write_png(out_png, (np.clip(panel, 0, 1) * 255).astype(np.uint8))
    generator.manual_seed(cfg.seed)
    verts, _, tex, _ = predict_mesh(model, img, generator)
    save_obj(os.path.join(cfg.out_path, "pred_mesh.obj"),
             verts[0].cpu().numpy(), template.faces, tex[0].cpu().numpy())
    print(f"Results saved at {cfg.out_path}.")
    return out_png


def main(argv=None):
    from ..cli import parse_config

    run(parse_config(argv, overrides=dict(use_scops=False, batch_size=2,
                                          is_train=False)))


if __name__ == "__main__":
    main()
