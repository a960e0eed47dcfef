"""The training steps of both stages (port of umr_tpu/training/steps.py::
build_s2_step and build_s1_step): the model's forward, every loss of the
stage's objective, its rasterizer passes, and one optimizer update over
model and discriminator; for stage 1 also the online template update.

Optimizer (the reference's, ref train_utils.py:172-194): one Adam
(beta1 = cfg.beta1, beta2 = 0.999), or SGD with momentum beta1 under
use_sgd, over the model and discriminator parameters, lr = base /
(1 + 5e-4 * iteration). optim_bs > 1 accumulates: the update every
optim_bs batches uses the mean of their gradients (the JAX package's
documented deviation from the reference, which discards all but the
last batch's). mean_v is a buffer: no optimizer touches it. BatchNorm
uses batch statistics in train mode (running stats at momentum 0.1, the
flax 0.9).

The rasterizer passes of one stage-2 step, on the kernels' route (ops/
raster_kernel.py; the card, or the CPU with impl="kernel"), each on the
full bins it makes at its launches (ops/raster_bins.py::full_raster_bins,
at the forward's and again at the backward's: none is kept through the
step):
  1. the fused silhouette + texture render of the B*K hypothesis fold,
     rgb gradients to the texels only: forward and backward kernel;
  2. the hard visibility render at the sampled camera, forward only;
  3. the semantic part renders and the GAN's unseen view merged into one
     (n_groups + 1) * B render with constant textures (tex_grads=False):
     forward and backward kernel.
With cycle_soft_p2f a fourth, forward-only pass ("s2.pass2_p2f")
renders the textures at the sampled camera for their p2f, the
texture-cycle target in place of the hard render's all-zero p2f.

The passes of one stage-1 step on the kernels' route:
  1. the fused seen-mask + texture render at the predicted camera, with
     p2f, rgb gradients to the texels only: forward (p2f) and backward;
  2. the hard visibility render (face ids), forward only;
  3. the GAN's unseen view, mask only: forward and backward kernel.
On the plain route (CPU, impl="auto") the renders are the plain forward
under exact autograd, unmerged, as the JAX package's XLA paths; stage 1
then renders its seen mask and a detached texture render with p2f
apart, as the JAX package's fallback does.

The flag variants, as the JAX package's steps have them:
  * use_texture=False: no texture flow, LPIPS, dt, cycle or hard pass.
    Stage 2's pass 1 is the mask-only hypothesis fold (multi_mask_loss,
    "s2.pass1_fold"), its GAN view renders T2=1 ones ("s2.pass3_gan")
    and its part groups render apart ("s2.pass3_parts"); stage 1's pass
    1 is a mask-only seen render ("s1.pass1_mask").
  * use_gan=False: no unseen view and no GAN loss (the discriminator is
    kept, with no gradient); stage 2's part groups render apart
    ("s2.pass3_parts").
  * bf16: the convs of the encoder, the texture decoder and LPIPS in
    bfloat16 (models/net_blocks.py); nothing bfloat16 reaches a render.
  * az_ele_quat: the hypotheses' QuatHeadAzEle (models/heads.py).
On the kernels' route an s2 step then launches (forward + backward):
3 + 2 by default, with bf16 or az_ele_quat; 4 + 3 without the GAN;
4 + 4 without texture; 3 + 3 without either. An s1 step: 3 (1 with p2f)
+ 2 by default or with bf16; 2 (1) + 1 without the GAN; 2 (0) + 2
without texture.

Random draws (the VAE noise, the camera hypothesis, the GAN view angles)
come from the state's torch.Generator unless injected (`draws`).

Data parallelism (parallel/mesh.py): in a group of N > 1 ranks each rank
steps on its block of the global batch, and the step is the one-process
step at the global batch. The BatchNorms normalise over the global batch
(models/net_blocks.py); the gradients are averaged over the ranks by one
all_reduce before the update (with optim_bs > 1, once per update, over
the accumulated sums); the returned scalars are their means over the
ranks. Every batch reduction of both objectives is a mean over samples
of equal weight (neg_iou, laplacian, flatten, deform, sym_reg, the
cam_probs-weighted mask, LPIPS and corr sums then .mean(), texture_dt,
tex_cycle, the part matching, the GAN's BCE and accuracy over real and
fake, uv_flow_area), and normalize_part_segs is per sample, so with
equal shards the mean over the ranks is the global batch's value. The
VAE noise and the GAN angles are drawn at the global shape (each rank
its block: one process's draws), the camera hypothesis from the rank's
own stream; injected draws are global and each rank takes its block. No
group: none of this runs. Tensor parallelism (parallel/tensor.py) wraps
the s2 step_fn: ranks and blocks then follow the data coordinate.

The step's layers are spans (tracing.span: a torch.profiler range of the
same name, and host time in tracing.totals()): "s2.forward" around the
loss, inside it "s2.model", "s2.pass1_fold", "s2.lpips", "s2.pass2_hard"
and "s2.pass3_merged"; then "s2.backward" and "s2.optimizer"; stage 1's
"s1.forward" around "s1.model", "s1.pass1_fused", "s1.lpips",
"s1.pass2_hard" and "s1.pass3_gan", then "s1.backward" and
"s1.optimizer". A trace of the step splits its device time by layer
(chip_smoke.py, experiments/profile_slice.py::range_split).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from ..config import Config, check_supported, resolve_device
from ..losses.composite import (PartMatchingLoss, corr_loss_chamfer,
                                gan_loss, multi_mask_loss,
                                multi_mask_texture_render)
from ..losses.losses import (cam_diversity_loss, deform_l2reg, flatten_loss,
                             laplacian_loss, neg_iou_loss, sym_reg,
                             tex_cycle_loss, texture_dt_loss)
from ..models import (Discriminator, LPIPSAlex, MeshNet, MeshNetS1,
                      init_weights, symmetrize)
from ..models.weights import maybe_load_lpips, overlay_resnet18
from ..ops.grid_sample import sample_textures
from ..ops.quaternion import rotate_cam
from ..parallel import all_reduce_, rank_block, shard_batch, world_size
from ..renderer import SoftRenderer
from ..tracing import span

@dataclasses.dataclass
class TrainState:
    step: int                        # batches taken
    updates: int                     # optimizer updates made
    model: torch.nn.Module           # MeshNet or MeshNetS1
    disc: Discriminator
    lpips: LPIPSAlex                 # frozen
    optimizer: torch.optim.Optimizer
    generator: torch.Generator       # the step's random draws
    shards: Optional[object] = None  # parallel/tensor.py::Shards, under
                                     # tensor parallelism (shard_state)
    # provenance: was the encoder trunk overlaid with pretrained weights?
    # (pred_state.pt keeps it; every .pth carries it as
    # _meta/trunk_pretrained)
    trunk_pretrained: Optional[bool] = None


def learning_rate(cfg: Config, updates):
    """lr = base / (1 + 5e-4 * iteration): the iteration counts batches,
    so with accumulation it is updates * optim_bs."""
    return cfg.learning_rate / (1.0 + 5e-4 * updates * max(cfg.optim_bs, 1))


def make_optimizer(cfg: Config, params):
    if cfg.use_sgd:
        return torch.optim.SGD(params, lr=cfg.learning_rate,
                               momentum=cfg.beta1)
    return torch.optim.Adam(params, lr=cfg.learning_rate,
                            betas=(cfg.beta1, 0.999), eps=1e-8)


def _renderers(cfg: Config, impl):
    common = dict(image_size=cfg.image_size,
                  anti_aliasing=cfg.anti_aliasing, impl=impl,
                  face_chunk=cfg.face_chunk)
    renderer = SoftRenderer(render_type=cfg.renderer_type, **common)
    return (renderer, renderer.ambient_light_only(),
            SoftRenderer(render_type="hard", **common))


def _compute_dtype(cfg: Config):
    """--bf16: the convs of the encoder, the texture decoder and LPIPS
    compute in bfloat16; parameters, BatchNorm, the heads, the losses and
    the rasterizer stay float32 (models/net_blocks.py)."""
    return torch.bfloat16 if cfg.bf16 else None


def normalize_part_segs(part_prob, masks):
    """Part maps [B,H,W,C] times the mask, each channel divided by its
    max -> [B,C,H,W]."""
    p = part_prob.permute(0, 3, 1, 2) * masks[:, None]
    return p / p.amax(dim=(2, 3), keepdim=True).clamp_min(1e-12)


@torch.no_grad()
def uv_flow_area(uvimage_pred, grid=16):
    """Flow-health metric: mean fraction of a grid x grid partition of
    the image that the UV flow image [B,h,w,2] samples."""
    cells = ((uvimage_pred + 1.0) * (0.5 * grid)).to(torch.int32).clamp(
        0, grid - 1)
    flat = (cells[..., 1] * grid + cells[..., 0]).reshape(
        uvimage_pred.shape[0], -1).long()
    occ = uvimage_pred.new_zeros((uvimage_pred.shape[0], grid * grid))
    occ.scatter_(1, flat, 1.0)
    return occ.mean(dim=-1).mean()


@torch.no_grad()
def _init_disc(disc, generator):
    """Seeded lecun-normal weights (the flax default's scale), zero bias."""
    for mod in disc.modules():
        if isinstance(mod, (torch.nn.Conv2d, torch.nn.Linear)):
            fan_in = math.prod(mod.weight.shape[1:])
            mod.weight.copy_(torch.randn(mod.weight.shape,
                                         generator=generator)
                             / math.sqrt(fan_in))
            mod.bias.zero_()


def _make_init_fn(cfg: Config, model, disc, lpips, device):
    """init_fn(seed=cfg.seed) -> TrainState: seeded weights, the
    pretrained ResNet-18 trunk and LPIPS where their files are
    (models/weights.py: the committed ones, or UMR_TPU_RESNET_WEIGHTS and
    UMR_TPU_LPIPS_WEIGHTS), the trunk's provenance in trunk_pretrained."""

    def init_fn(seed=None):
        seed = cfg.seed if seed is None else seed
        g = torch.Generator().manual_seed(seed)
        init_weights(model, g)
        _init_disc(disc, g)
        trunk_pretrained = overlay_resnet18(model)
        maybe_load_lpips(lpips)
        opt = make_optimizer(cfg, list(model.parameters())
                             + list(disc.parameters()))
        gen = torch.Generator(device).manual_seed(seed)
        return TrainState(step=0, updates=0, model=model, disc=disc,
                          lpips=lpips, optimizer=opt, generator=gen,
                          trunk_pretrained=trunk_pretrained)

    return init_fn


def _draws_on(draws, device):
    """Injected draws (of the global batch: this rank's block) as tensors
    on `device`."""
    return {k: torch.as_tensor(v, device=device)
            for k, v in shard_batch(draws or {}).items()}


def _train_step(cfg: Config, state: TrainState, batch, device, prefix,
                loss_fn):
    """One training step: the batch to `device`, train mode, loss_fn(batch)
    -> (total, scalars) in the range f"{prefix}.forward", its backward
    and, every optim_bs batches, the update with the mean of their
    gradients at the step's learning rate. In a group of ranks the
    gradients are averaged over the ranks before the update and the
    scalars are their means over the ranks; under tensor parallelism
    (state.shards, parallel/tensor.py) each sharded parameter's gradient
    slice goes to its shard after the backward, and the shards reduce
    over the data group. Returns (state, scalars)."""
    batch = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
    state.model.train()
    state.disc.train()
    opt = state.optimizer
    k = max(cfg.optim_bs, 1)
    if state.step % k == 0:
        opt.zero_grad(set_to_none=True)
    with span(f"{prefix}.forward"):
        total, sc = loss_fn(batch)
    with span(f"{prefix}.backward"):
        total.backward()
    if state.shards is not None:
        state.shards.take_grads()
    state.step += 1
    sc = {name: v.detach() for name, v in sc.items()}
    if world_size() > 1:
        values = torch.stack([v.float().reshape(()) for v in sc.values()])
        all_reduce_([values])
        sc = dict(zip(sc, values.unbind()))
    if state.step % k == 0:
        with span(f"{prefix}.optimizer"):
            if state.shards is None:
                all_reduce_([p.grad for group in opt.param_groups
                             for p in group["params"] if p.grad is not None])
            else:
                state.shards.reduce_grads()
            if k > 1:
                for group in opt.param_groups:
                    for p in group["params"]:
                        if p.grad is not None:
                            p.grad.div_(k)
            for group in opt.param_groups:
                group["lr"] = learning_rate(cfg, state.updates)
            opt.step()
        state.updates += 1
    return state, sc


def build_s2_step(cfg: Config, template, part_loss: PartMatchingLoss,
                  part_vert_idx, device=None, impl="auto"):
    """Returns (model, disc, lpips, init_fn, step_fn) on `device` (the
    card unless "cpu" is asked for).

    part_vert_idx: 4 template-vertex index arrays (head, belly, neck,
    back) of the semantic template. impl: the renderers' route ("kernel"
    drives the card's route on the CPU; see renderer/soft_renderer.py).

    init_fn(seed=cfg.seed) -> TrainState: seeded weights, the ResNet-18
    trunk and LPIPS from their files where present (_make_init_fn).
    step_fn(state, batch, draws=None) -> (state, scalars): batch is the
    trainer's prepare_batch dict (numpy or tensors; in a group of ranks
    this rank's block); draws optionally injects 'eps' [B,z_dim],
    'sample_inds' [B,1] and 'angles' [B] of the global batch."""
    check_supported(cfg)
    device = resolve_device(device)
    model = MeshNet(template, input_size=cfg.image_size, nz_feat=cfg.nz_feat,
                    z_dim=cfg.z_dim, num_hypo_cams=cfg.num_hypo_cams,
                    use_texture=cfg.use_texture, az_ele_quat=cfg.az_ele_quat,
                    compute_dtype=_compute_dtype(cfg))
    disc = Discriminator(lambda_=cfg.grl_wt, in_dim=3,
                         img_size=cfg.image_size)
    lpips = LPIPSAlex(compute_dtype=_compute_dtype(cfg))
    model, disc, lpips = (m.to(device) for m in (model, disc, lpips))
    renderer, tex_renderer, hard_renderer = _renderers(cfg, impl)
    dis_renderer = tex_renderer     # ambient only (ref train_s2.py:105-106)
    faces = torch.as_tensor(template.faces, device=device)
    lap = torch.as_tensor(template.laplacian, device=device)
    flat_idx = torch.as_tensor(template.flatten_idx, device=device)
    init_fn = _make_init_fn(cfg, model, disc, lpips, device)
    # pass 3's ranges: with every flag at its default the part groups and
    # the GAN's view are one merged pass (two renders off the kernels'
    # route); a variant renders them apart
    default = cfg.use_texture and cfg.use_gan
    # the merged part + GAN render draws the part groups with
    # dis_renderer: the part renderer must render as it does
    merge_pass3 = (default and part_loss.renderer == dis_renderer
                   and dis_renderer.uses_kernel(device))
    gan_range = "s2.pass3_merged" if default else "s2.pass3_gan"
    part_range = "s2.pass3_merged" if default else "s2.pass3_parts"

    def loss_fn(state: TrainState, batch, draws):
        with span("s2.model"):
            outputs = model(batch["input_img"], eps=draws.get("eps"),
                            sample_inds=draws.get("sample_inds"),
                            generator=state.generator)
        imgs, masks = batch["img"], batch["mask"]
        B = imgs.shape[0]
        mean_shape = symmetrize(model.mean_v, template)
        pred_vs = mean_shape[None] + symmetrize(outputs["delta_v"], template)
        proj_cam = outputs["cam"].detach()
        cams_all = outputs["cam_hypotheses"]
        cam_probs = outputs["cam_probs"]
        K = cams_all.shape[1]

        sc = {"cam_div_loss": cam_diversity_loss(cam_probs)}
        tex = None
        if cfg.use_texture:
            tex_flow = outputs["tex_flow"]
            tex = sample_textures(tex_flow, imgs)
            T = tex.shape[2]
            tex = tex.reshape(B, tex.shape[1], T * T, 3)
        # pass 1: silhouettes (live geometry) + textures (texels only);
        # without texture the silhouettes alone, mask only
        with span("s2.pass1_fold"):
            if cfg.use_texture:
                mask_all_hypo, texture_pred = multi_mask_texture_render(
                    renderer, tex_renderer, pred_vs, faces, cams_all, tex,
                    chunks=cfg.hypo_render_chunks)
            else:
                _, mask_all_hypo = multi_mask_loss(
                    renderer, pred_vs, faces, cams_all, cam_probs, masks,
                    chunks=cfg.hypo_render_chunks)

        masks_rep = masks.repeat_interleave(K, 0)
        mloss = neg_iou_loss(mask_all_hypo, masks_rep, avg=False)
        sc["mask_loss"] = (mloss.reshape(B, K) * cam_probs).sum(1).mean()
        sc["tri_loss"] = laplacian_loss(pred_vs, lap).mean()
        sc["flatten_loss"] = flatten_loss(pred_vs, flat_idx).mean()
        sc["deform_loss"] = deform_l2reg(outputs["delta_v"])
        total = (sc["mask_loss"] * cfg.mask_loss_wt
                 + sc["tri_loss"] * cfg.triangle_reg_wt
                 + sc["flatten_loss"] * cfg.flatten_reg_wt
                 + sc["deform_loss"] * cfg.deform_reg_wt
                 + sc["cam_div_loss"] * cfg.ent_loss_wt)

        if cfg.use_texture:
            # perceptual loss, hypothesis-weighted by the detached probs;
            # the predicted masks stay live
            pred_masked = texture_pred * mask_all_hypo[..., None]
            gt_masked = imgs.repeat_interleave(K, 0) * masks_rep[..., None]
            with span("s2.lpips"):
                dist = state.lpips(2 * pred_masked - 1, 2 * gt_masked - 1)
            sc["tex_loss"] = (dist.reshape(B, K)
                              * cam_probs.detach()).sum(1).mean()
            sc["tex_dt_loss"] = texture_dt_loss(tex_flow,
                                                batch["dts_barrier"])
            # pass 2: hard visibility at the sampled camera. Its p2f is
            # all zeros (the reference's s2 quirk: the cycle target comes
            # from the hard renderer, which writes no p2f)
            with span("s2.pass2_hard"):
                hard_out = hard_renderer.render(pred_vs.detach(), faces,
                                                proj_cam)
            face_ids = hard_out.aggr[:, 1].reshape(B, -1)
            cycle_p2f = hard_out.p2f
            if cfg.cycle_soft_p2f:
                # the opt-in fix of that quirk: the soft render's real p2f
                # at the sampled camera, stage 1's target; forward only
                with span("s2.pass2_p2f"):
                    cycle_p2f = tex_renderer.render(
                        pred_vs.detach(), faces, proj_cam, tex.detach(),
                        need_p2f=True, tex_grads=False).p2f
            sc["tex_cycle_loss"] = tex_cycle_loss(
                tex_flow, cycle_p2f.detach(), face_ids.detach())[0]
            sc["uv_flow_area"] = uv_flow_area(outputs["uvimage_pred"])
            total = (total + sc["tex_loss"] * cfg.tex_loss_wt
                     + sc["tex_dt_loss"] * cfg.tex_dt_loss_wt
                     + sc["tex_cycle_loss"] * cfg.tex_cycle_loss_wt)

        part_segs = normalize_part_segs(batch["part_prob"], masks)
        if cfg.use_gan:
            angles = draws.get("angles")
            if angles is None:
                angles = rank_block(lambda n: torch.randint(
                    0, 180, (n,), generator=state.generator,
                    device=device), B)
            random_cams = rotate_cam(proj_cam, angles)
        # pass 3: the part groups and the GAN's unseen view in one render
        if merge_pass3:
            with span("s2.pass3_merged"):
                groups = part_loss.texture_groups(B)
                n_g = len(groups)
                rgb = dis_renderer.render(
                    torch.cat([pred_vs] * (n_g + 1), 0), faces,
                    torch.cat([proj_cam] * n_g + [random_cams], 0),
                    torch.cat(groups + [tex.detach()], 0),
                    tex_grads=False).rgba[..., :3]
                projs = part_loss.projs_from_group_renders(
                    [rgb[i * B:(i + 1) * B] for i in range(n_g)])
                unseen = rgb[n_g * B:]
                p_loss = part_loss.loss_from_projs(projs, part_segs)[0]
        else:
            # apart: the GAN's view (untextured: T2=1 ones), then each
            # part group
            if cfg.use_gan:
                with span(gan_range):
                    unseen = dis_renderer.render(
                        pred_vs, faces, random_cams,
                        None if tex is None else tex.detach(),
                        tex_grads=False).rgba[..., :3]
            with span(part_range):
                p_loss = part_loss(pred_vs, faces, proj_cam,
                                   part_segs)[0]

        if cfg.use_gan:
            sc["gan_loss"], sc["acc_gan"] = gan_loss(
                state.disc, batch["real_imgs"], unseen)
            total = total + sc["gan_loss"] * cfg.gan_loss_wt
        sc["part_loss"] = p_loss
        total = total + p_loss * cfg.prob_loss_wt

        mean_rep = mean_shape[None].expand((B,) + mean_shape.shape)
        pts = [batch[k].repeat_interleave(K, 0)
               for k in ("head_points", "belly_points", "neck_points",
                         "back_points")]
        corr = corr_loss_chamfer(
            renderer.project_points, part_vert_idx, pts,
            mean_rep.repeat_interleave(K, 0), cams_all.reshape(B * K, 7),
            avg=False)[0]
        sc["corr_loss"] = (corr.reshape(B, K)
                           * cam_probs.detach()).sum(1).mean()
        total = total + sc["corr_loss"] * cfg.vertex_loss_wt
        sc["total_loss"] = total
        return total, sc

    def step_fn(state: TrainState, batch, draws: Optional[dict] = None):
        draws = _draws_on(draws, device)
        return _train_step(cfg, state, batch, device, "s2",
                           lambda b: loss_fn(state, b, draws))

    return model, disc, lpips, init_fn, step_fn


def build_s1_step(cfg: Config, template, device=None, impl="auto"):
    """Returns (model, disc, lpips, init_fn, step_fn, encode_feat_fn,
    template_update_fn) on `device` (the card unless "cpu" is asked for);
    impl as build_s2_step's.

    init_fn(seed=cfg.seed) -> TrainState, as stage 2's.
    step_fn(state, batch, epoch=0.0, draws=None) -> (state, scalars):
    epoch gates the orientation reg (epoch < stop_ori_epoch) and the
    deform reg (epoch > update_template_freq), as the reference does;
    draws optionally injects 'eps' [B,z_dim] and 'angles' [B].
    encode_feat_fn(state, batch, eps=None, generator=None) -> the VAE
    sample [B,z_dim] of the eval-mode model, no gradients (in a group,
    the noise is this rank's block of the global batch's draw).
    template_update_fn(state, feat_mean [z_dim]) -> state with
    mean_v += shape_predictor(feat_mean), in place; feat_mean is the
    mean over every rank's samples (experiments/train_s1.py)."""
    check_supported(cfg, stage=1)
    device = resolve_device(device)
    model = MeshNetS1(template, input_size=cfg.image_size,
                      nz_feat=cfg.nz_feat, z_dim=cfg.z_dim,
                      use_texture=cfg.use_texture,
                      compute_dtype=_compute_dtype(cfg))
    # the GAN judges silhouettes: the predicted seen mask is its "real"
    disc = Discriminator(lambda_=cfg.grl_wt, in_dim=1,
                         img_size=cfg.image_size)
    lpips = LPIPSAlex(compute_dtype=_compute_dtype(cfg))
    model, disc, lpips = (m.to(device) for m in (model, disc, lpips))
    renderer, tex_renderer, hard_renderer = _renderers(cfg, impl)
    faces = torch.as_tensor(template.faces, device=device)
    lap = torch.as_tensor(template.laplacian, device=device)
    flat_idx = torch.as_tensor(template.flatten_idx, device=device)
    fused = cfg.use_texture and tex_renderer.uses_kernel(device)
    init_fn = _make_init_fn(cfg, model, disc, lpips, device)

    def loss_fn(state: TrainState, batch, draws, epoch):
        with span("s1.model"):
            outputs = model(batch["input_img"], eps=draws.get("eps"),
                            generator=state.generator)
        imgs, masks = batch["img"], batch["mask"]
        B = imgs.shape[0]
        pred_vs = (symmetrize(model.mean_v, template)[None]
                   + symmetrize(outputs["delta_v"], template))
        proj_cam = outputs["cam"]
        if cfg.use_texture:
            tex_flow = outputs["tex_flow"]
            tex = sample_textures(tex_flow, imgs)
            T = tex.shape[2]
            tex = tex.reshape(B, tex.shape[1], T * T, 3)

        with span("s1.pass1_fused" if cfg.use_texture
                             else "s1.pass1_mask"):
            if fused:
                # one pass: live silhouette, rgb gradients to the texels
                # only (the reference detaches geometry and camera in its
                # texture render), p2f for the cycle loss
                tex_out = tex_renderer.render(
                    pred_vs, faces, proj_cam, tex, need_p2f=True,
                    rgb_geom_detach=True)
                mask_pred_seen = tex_out.rgba[..., 3]
            else:
                mask_pred_seen = renderer.render(
                    pred_vs, faces, proj_cam, mask_only=True).rgba[..., 3]
                if cfg.use_texture:
                    tex_out = tex_renderer.render(
                        pred_vs.detach(), faces, proj_cam.detach(), tex,
                        need_p2f=True)

        sc = {"mask_loss": neg_iou_loss(mask_pred_seen, masks),
              "tri_loss": laplacian_loss(pred_vs, lap).mean(),
              "flatten_loss": flatten_loss(pred_vs, flat_idx).mean(),
              "deform_loss": deform_l2reg(outputs["delta_v"]),
              "ori_loss": sym_reg(pred_vs)}
        total = (sc["mask_loss"] * cfg.mask_loss_wt
                 + sc["tri_loss"] * cfg.triangle_reg_wt
                 + sc["flatten_loss"] * cfg.flatten_reg_wt)
        # epoch-gated regularizers (ref train_s1.py:249-255)
        if epoch < cfg.stop_ori_epoch:
            total = total + sc["ori_loss"] * cfg.ori_reg_wt
        if epoch > cfg.update_template_freq:
            total = total + sc["deform_loss"] * cfg.deform_reg_wt

        if cfg.use_texture:
            texture_pred = tex_out.rgba[..., :3]
            with span("s1.lpips"):
                sc["tex_loss"] = state.lpips(
                    2 * (texture_pred * mask_pred_seen[..., None]) - 1,
                    2 * (imgs * masks[..., None]) - 1).mean()
            sc["tex_dt_loss"] = texture_dt_loss(tex_flow,
                                                batch["dts_barrier"])
            with span("s1.pass2_hard"):
                hard_out = hard_renderer.render(
                    pred_vs.detach(), faces, proj_cam.detach())
            face_ids = hard_out.aggr[:, 1].reshape(B, -1)
            sc["tex_cycle_loss"] = tex_cycle_loss(
                tex_flow, tex_out.p2f.detach(), face_ids.detach())[0]
            sc["uv_flow_area"] = uv_flow_area(outputs["uvimage_pred"])
            total = (total + sc["tex_loss"] * cfg.tex_loss_wt
                     + sc["tex_dt_loss"] * cfg.tex_dt_loss_wt
                     + sc["tex_cycle_loss"] * cfg.tex_cycle_loss_wt)

        if cfg.use_gan:
            angles = draws.get("angles")
            if angles is None:
                angles = rank_block(lambda n: torch.randint(
                    0, 180, (n,), generator=state.generator,
                    device=device), B)
            random_cams = rotate_cam(proj_cam.detach(), angles)
            with span("s1.pass3_gan"):
                mask_unseen = renderer.render(pred_vs, faces, random_cams,
                                              mask_only=True).rgba[..., 3]
            sc["gan_loss"], sc["acc_gan"] = gan_loss(
                state.disc, mask_pred_seen.detach()[..., None],
                mask_unseen[..., None])
            total = total + sc["gan_loss"] * cfg.gan_loss_wt
        sc["total_loss"] = total
        return total, sc

    def step_fn(state: TrainState, batch, epoch=0.0,
                draws: Optional[dict] = None):
        draws = _draws_on(draws, device)
        return _train_step(
            cfg, state, batch, device, "s1",
            lambda b: loss_fn(state, b, draws, float(epoch)))

    @torch.no_grad()
    def encode_feat_fn(state: TrainState, batch, eps=None, generator=None):
        model.eval()
        out = model(torch.as_tensor(batch["input_img"], device=device),
                    eps=eps, generator=generator or state.generator)
        return out["feat"]

    @torch.no_grad()
    def template_update_fn(state: TrainState, feat_mean):
        model.mean_v += model.shape_predictor(feat_mean[None])[0]
        return state

    return (model, disc, lpips, init_fn, step_fn, encode_feat_fn,
            template_update_fn)

