"""The reference training step of both stages, in plain PyTorch, and the
readings the benchmark compares: each step's total loss, each leaf's
first gradient, and each leaf's change after the steps.

The objectives are NVlabs UMR's train_s2.py / train_s1.py as the
program's configuration states them (the weights, the epoch gates, the
8-hypothesis fold with its probability weights, LPIPS on the masked
renders, the distance-transform and texture-cycle terms, the part
matching and the mask GAN, the chamfer part correspondence), rendered by
reference/raster.py, with one Adam over the model and the discriminator
at lr = base / (1 + 5e-4 * step). The random draws are made from a
torch.Generator on the device seeded with the run's seed, in the
program's order: the VAE noise, then (stage 2) the camera hypothesis,
then the GAN view's angles.
"""

from __future__ import annotations

import numpy as np
import torch

from . import geom, nets
from .raster import rasterize
from .template import build_template

RESNET_MEAN = (0.485, 0.456, 0.406)
RESNET_STD = (0.229, 0.224, 0.225)
EYE = (0.0, 0.0, -2.732)
OFFSET_Z = 5.0


class Reference:
    """The reference model of one configuration (a dict of its numbers:
    the configuration file's "program" entries) on `device`, initialised
    from `seed` as the configuration states it, with the committed trunk
    and LPIPS weights."""

    def __init__(self, cfg, stage, seed, device, weights_dir, semantic=None):
        self.cfg, self.stage, self.device = cfg, stage, device
        t = build_template(cfg["subdivide"], cfg["axis"], cfg["tex_size"])
        self.template = t
        S = cfg["image_size"]
        if stage == 2:
            model = nets.MeshNet(t, S, cfg["nz_feat"], cfg["z_dim"],
                                 cfg["num_hypo_cams"])
        else:
            model = nets.MeshNetS1(t, S, cfg["nz_feat"], cfg["z_dim"])
        disc = nets.Discriminator(cfg["grl_wt"], 3 if stage == 2 else 1, S)
        g = torch.Generator().manual_seed(int(seed))
        nets.init_weights(model, g)
        nets.init_disc(disc, g)
        nets.load_resnet18_npz(model.encoder.resnet_conv.resnet,
                               f"{weights_dir}/resnet18_params.npz",
                               f"{weights_dir}/resnet18_stats.npz")
        lpips = nets.LPIPSAlex()
        nets.load_lpips_npz(lpips, f"{weights_dir}/lpips_alex.npz")
        self.model, self.disc, self.lpips = (m.to(device) for m in
                                             (model, disc, lpips))
        self.faces = torch.as_tensor(t.faces, device=device).long()
        self.lap = torch.as_tensor(t.laplacian, device=device)
        self.flat_idx = torch.as_tensor(t.flatten_idx, device=device).long()
        self.render_size = S * (2 if cfg["anti_aliasing"] else 1)
        if stage == 2:
            seg, self.part_vert_idx = semantic
            self.part_tex = geom.part_textures(
                seg, t.uv_sampler, t.num_sym_faces, cfg["num_parts"], device)
        self.params = ([(f"model.{n}", p) for n, p in
                        self.model.named_parameters()]
                       + [(f"disc.{n}", p) for n, p in
                          self.disc.named_parameters()])
        self.opt = torch.optim.Adam([p for _, p in self.params],
                                    lr=cfg["learning_rate"],
                                    betas=(cfg["beta1"], 0.999), eps=1e-8)
        self.generator = torch.Generator(device).manual_seed(int(seed))

    # ---- rendering -------------------------------------------------------

    def project_faces(self, verts, cams):
        v = geom.orthographic_proj_withz(verts, cams, offset_z=OFFSET_Z)
        v = v * v.new_tensor([1.0, -1.0, 1.0]) - v.new_tensor(EYE)
        return v[:, self.faces]

    def render(self, verts, cams, tex=None, **kw):
        """rgba [B, S, S, 4] at image size, aggr and p2f at render size."""
        rgba, aggr, p2f = rasterize(self.project_faces(verts, cams), tex,
                                    image_size=self.render_size, **kw)
        if self.cfg["anti_aliasing"]:
            B, S = rgba.shape[0], self.cfg["image_size"]
            rgba = rgba.reshape(B, S, 2, S, 2, 4).mean(dim=(2, 4))
        return rgba, aggr, p2f

    def project_points(self, verts, cams):
        return geom.orthographic_proj_withz(verts, cams)[:, :, :2]

    # ---- the objectives ----------------------------------------------------

    def _textures(self, out, imgs):
        tex_flow = out["tex_flow"]
        B, F_, T = tex_flow.shape[:3]
        return tex_flow, geom.grid_sample(imgs, tex_flow).reshape(
            B, F_, T * T, 3)

    def loss_s2(self, batch):
        cfg, t, gen = self.cfg, self.template, self.generator
        out = self.model(batch["input_img"], gen)
        imgs, masks = batch["img"], batch["mask"]
        B = imgs.shape[0]
        mean_shape = nets.symmetrize(self.model.mean_v, t)
        pred_vs = mean_shape[None] + nets.symmetrize(out["delta_v"], t)
        proj_cam = out["cam"].detach()
        cams_all, cam_probs = out["cam_hypotheses"], out["cam_probs"]
        K = cams_all.shape[1]
        tex_flow, tex = self._textures(out, imgs)
        sc = {"cam_div_loss": geom.cam_diversity_loss(cam_probs)}

        rgba, _, _ = self.render(pred_vs.repeat_interleave(K, 0),
                                 cams_all.reshape(B * K, 7),
                                 tex.repeat_interleave(K, 0),
                                 rgb_geom_detach=True)
        mask_all, texture_pred = rgba[..., 3], rgba[..., :3]
        masks_rep = masks.repeat_interleave(K, 0)
        mloss = geom.neg_iou_loss(mask_all, masks_rep, avg=False)
        sc["mask_loss"] = (mloss.reshape(B, K) * cam_probs).sum(1).mean()
        sc["tri_loss"] = geom.laplacian_loss(pred_vs, self.lap).mean()
        sc["flatten_loss"] = geom.flatten_loss(pred_vs, self.flat_idx).mean()
        sc["deform_loss"] = geom.deform_l2reg(out["delta_v"])
        total = (sc["mask_loss"] * cfg["mask_loss_wt"]
                 + sc["tri_loss"] * cfg["triangle_reg_wt"]
                 + sc["flatten_loss"] * cfg["flatten_reg_wt"]
                 + sc["deform_loss"] * cfg["deform_reg_wt"]
                 + sc["cam_div_loss"] * cfg["ent_loss_wt"])

        pred_masked = texture_pred * mask_all[..., None]
        gt_masked = imgs.repeat_interleave(K, 0) * masks_rep[..., None]
        dist = self.lpips(2 * pred_masked - 1, 2 * gt_masked - 1)
        sc["tex_loss"] = (dist.reshape(B, K)
                          * cam_probs.detach()).sum(1).mean()
        sc["tex_dt_loss"] = geom.texture_dt_loss(tex_flow,
                                                 batch["dts_barrier"])
        _, aggr, _ = self.render(pred_vs.detach(), proj_cam, hard=True)
        face_ids = aggr[:, 1].reshape(B, -1)
        # the hard render writes no p2f: the cycle target is all zeros
        sc["tex_cycle_loss"] = geom.tex_cycle_loss(
            tex_flow, torch.zeros_like(tex_flow[:, :, 0, 0]), face_ids)
        total = (total + sc["tex_loss"] * cfg["tex_loss_wt"]
                 + sc["tex_dt_loss"] * cfg["tex_dt_loss_wt"]
                 + sc["tex_cycle_loss"] * cfg["tex_cycle_loss_wt"])

        part_segs = geom.normalize_part_segs(batch["part_prob"], masks)
        angles = torch.randint(0, 180, (B,), generator=gen,
                               device=imgs.device)
        random_cams = geom.rotate_cam(proj_cam, angles)
        groups = geom.part_groups(self.part_tex, B)
        n_g = len(groups)
        rgb = self.render(torch.cat([pred_vs] * (n_g + 1)),
                          torch.cat([proj_cam] * n_g + [random_cams]),
                          torch.cat(groups + [tex.detach()]))[0][..., :3]
        P = self.part_tex.shape[-1]
        projs = torch.cat([rgb[i * B:(i + 1) * B, ..., :min(3, P - 3 * i)]
                           for i in range(n_g)], -1).permute(0, 3, 1, 2)
        p_loss = geom.part_matching_loss(projs, part_segs)
        sc["gan_loss"] = geom.gan_loss(self.disc, batch["real_imgs"],
                                       rgb[n_g * B:])
        total = total + sc["gan_loss"] * cfg["gan_loss_wt"]
        sc["part_loss"] = p_loss
        total = total + p_loss * cfg["prob_loss_wt"]

        mean_rep = mean_shape[None].expand((B,) + mean_shape.shape)
        pts = [batch[k].repeat_interleave(K, 0)
               for k in ("head_points", "belly_points", "neck_points",
                         "back_points")]
        corr = geom.corr_loss_chamfer(
            self.project_points, self.part_vert_idx, pts,
            mean_rep.repeat_interleave(K, 0), cams_all.reshape(B * K, 7))
        sc["corr_loss"] = (corr.reshape(B, K)
                           * cam_probs.detach()).sum(1).mean()
        total = total + sc["corr_loss"] * cfg["vertex_loss_wt"]
        return total, sc

    def loss_s1(self, batch, epoch):
        cfg, t, gen = self.cfg, self.template, self.generator
        out = self.model(batch["input_img"], gen)
        imgs, masks = batch["img"], batch["mask"]
        B = imgs.shape[0]
        pred_vs = (nets.symmetrize(self.model.mean_v, t)[None]
                   + nets.symmetrize(out["delta_v"], t))
        proj_cam = out["cam"]
        tex_flow, tex = self._textures(out, imgs)
        rgba, _, p2f = self.render(pred_vs, proj_cam, tex, need_p2f=True,
                                   rgb_geom_detach=True)
        mask_seen = rgba[..., 3]
        sc = {"mask_loss": geom.neg_iou_loss(mask_seen, masks),
              "tri_loss": geom.laplacian_loss(pred_vs, self.lap).mean(),
              "flatten_loss": geom.flatten_loss(pred_vs,
                                                self.flat_idx).mean(),
              "deform_loss": geom.deform_l2reg(out["delta_v"]),
              "ori_loss": geom.sym_reg(pred_vs)}
        total = (sc["mask_loss"] * cfg["mask_loss_wt"]
                 + sc["tri_loss"] * cfg["triangle_reg_wt"]
                 + sc["flatten_loss"] * cfg["flatten_reg_wt"])
        if epoch < cfg["stop_ori_epoch"]:
            total = total + sc["ori_loss"] * cfg["ori_reg_wt"]
        if epoch > cfg["update_template_freq"]:
            total = total + sc["deform_loss"] * cfg["deform_reg_wt"]
        sc["tex_loss"] = self.lpips(
            2 * (rgba[..., :3] * mask_seen[..., None]) - 1,
            2 * (imgs * masks[..., None]) - 1).mean()
        sc["tex_dt_loss"] = geom.texture_dt_loss(tex_flow,
                                                 batch["dts_barrier"])
        _, aggr, _ = self.render(pred_vs.detach(), proj_cam.detach(),
                                 hard=True)
        sc["tex_cycle_loss"] = geom.tex_cycle_loss(
            tex_flow, p2f, aggr[:, 1].reshape(B, -1))
        total = (total + sc["tex_loss"] * cfg["tex_loss_wt"]
                 + sc["tex_dt_loss"] * cfg["tex_dt_loss_wt"]
                 + sc["tex_cycle_loss"] * cfg["tex_cycle_loss_wt"])
        angles = torch.randint(0, 180, (B,), generator=gen,
                               device=imgs.device)
        random_cams = geom.rotate_cam(proj_cam.detach(), angles)
        mask_unseen = self.render(pred_vs, random_cams, mask_only=True)[0][
            ..., 3]
        sc["gan_loss"] = geom.gan_loss(self.disc,
                                       mask_seen.detach()[..., None],
                                       mask_unseen[..., None])
        total = total + sc["gan_loss"] * cfg["gan_loss_wt"]
        return total, sc

    # ---- the steps -------------------------------------------------------

    def step(self, batch, updates, epoch):
        """One Adam step on a prepared batch; returns the total loss and
        {leaf: gradient} (views of the .grad tensors)."""
        self.model.train()
        self.disc.train()
        self.opt.zero_grad(set_to_none=True)
        if self.stage == 2:
            total, _ = self.loss_s2(batch)
        else:
            total, _ = self.loss_s1(batch, epoch)
        total.backward()
        grads = {n: p.grad for n, p in self.params}
        for group in self.opt.param_groups:
            group["lr"] = self.cfg["learning_rate"] / (1.0 + 5e-4 * updates)
        self.opt.step()
        return float(total.detach()), grads


def prepare(batch, lagged_real, device):
    """A loader batch (numpy, channel-last) -> the step's tensors on
    `device`: the normalised input, masks, the masked images (the GAN's
    real images are the previous batch's, `lagged_real`, when given)."""
    t = {k: torch.as_tensor(np.asarray(v, np.float32), device=device)
         for k, v in batch.items()}
    mean = torch.tensor(RESNET_MEAN, device=device)
    std = torch.tensor(RESNET_STD, device=device)
    out = dict(t, input_img=(t["img"] - mean) / std,
               real_imgs=t["img"] * t["mask"][..., None])
    if lagged_real is not None:
        out["real_imgs"] = lagged_real
    return out


def readings(cfg, stage, seed, batches, epoch, device, weights_dir,
             semantic=None, steps=3):
    """Drive the reference from `seed` through `steps` Adam steps on the
    loader batches `batches` (the GAN's real images lag one batch, as the
    trainer feeds them) -> {"loss": [per step], "grad1": {leaf: norm of
    its first gradient}, "delta": {leaf: norm of its change over the
    steps}, "change": {leaf: that change, on the host}}."""
    ref = Reference(cfg, stage, seed, device, weights_dir, semantic)
    start = {n: p.detach().clone() for n, p in ref.params}
    losses, grad1, lagged = [], {}, None
    for i in range(steps):
        db = prepare(batches[i], lagged, device)
        lagged = db["img"] * db["mask"][..., None]
        loss, grads = ref.step(db, i, epoch)
        losses.append(loss)
        if i == 0:
            grad1 = {n: 0.0 if g is None else float(g.norm())
                     for n, g in grads.items()}
    change = {n: (p.detach() - start[n]).cpu() for n, p in ref.params}
    return {"loss": losses, "grad1": grad1, "change": change,
            "delta": {n: float(c.norm()) for n, c in change.items()}}
