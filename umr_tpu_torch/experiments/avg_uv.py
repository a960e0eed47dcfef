"""Semantic template construction (port of umr_tpu/experiments/avg_uv.py):
average the part maps of the training images in UV space, through a
stage-1 model's texture flow, and derive per-part template vertices.

  python -m umr_tpu_torch.experiments.avg_uv --model_path <s1 pth> \\
      --out_dir <stemp dir> ...

run() reads CUB's --split (train) with its SCOPS part maps (data/cub.py,
unshuffled, unmirrored) unless given a dataloader (batches with
part_prob). It writes into --out_dir semantic_prob.npy,
semantic_seg.png, {head,neck,back,belly}_vertices.npy, mean_v.pth,
mean_template.obj and vertex_label.obj: what train_s2 reads.
"""

from __future__ import annotations

import os
import os.path as osp
import time
import warnings

import numpy as np
import torch

from ..cli import AVG_UV_DEFAULTS, parse_config
from ..config import Config, resolve_device
from ..data.cub import data_loader
from ..image import color_map, colorize
from ..mesh import build_template
from ..models import LPIPSAlex, MeshNetS1, symmetrize
from ..models.weights import load_checkpoint, maybe_load_lpips
from ..obj_io import save_obj
from ..ops.grid_sample import grid_sample
from ..png import write_png
from ..renderer import SoftRenderer
from ..training.trainer import prepare_batch
from ..visualizer import green, red

# the cameras are flipped to score the render against the flipped image
# (ref: avg_uv.py:160-161)
ORI_FLIP = (1.0, -1.0, 1.0, 1.0, 1.0, -1.0, -1.0)
PART_NAMES = ("head", "neck", "back", "belly")


def load_s1_model(cfg: Config, template, device):
    """MeshNet-S1 with the weights of cfg.model_path (either key layout),
    in eval mode. avg_uv transfers part maps through the UV flow: a model
    without texture has none, and is refused (the JAX package's avg_uv
    fails on it too, reading outputs['uvimage_pred'])."""
    if not cfg.use_texture:
        raise ValueError("avg_uv needs the UV flow of a textured stage-1 "
                         "model; --use_texture=False predicts none")
    model = MeshNetS1(template, input_size=cfg.image_size,
                      nz_feat=cfg.nz_feat, z_dim=cfg.z_dim)
    load_checkpoint(model, cfg.model_path)
    return model.to(device).eval()


def uv_transfer(part_prob, uvimage_pred):
    """Image-space part probabilities [B,H,W,5] -> UV-space part maps
    [B,5,h,w], sampled at the predicted UV flow image [B,h,w,2] in [-1, 1]
    (ref: avg_uv.py:186-189, 214-215)."""
    return grid_sample(part_prob, uvimage_pred).permute(0, 3, 1, 2)


@torch.no_grad()
def score_batch(model, lpips, renderer, faces, template, db, generator):
    """One batch of the exemplar search (ref: avg_uv.py:141-198): the
    LPIPS distance of the render at the flipped camera to the flipped
    image, plus the distance to the template scaled to the batch's LPIPS
    mean. Returns (score [B], UV part maps [B,5,h,w])."""
    out = model(db["input_img"], generator=generator)
    mean_shape = symmetrize(model.mean_v, template)
    pred_vs = mean_shape[None] + symmetrize(out["delta_v"], template)
    proj_cam = out["cam"] * out["cam"].new_tensor(ORI_FLIP)
    rgba = renderer.render(pred_vs, faces, proj_cam).rgba
    rgb_pred, mask_pred = rgba[..., :3], rgba[..., 3]
    flip_imgs = db["img"].flip(2)
    flip_masks = db["mask"].flip(2)
    tex_loss = lpips(2 * (rgb_pred * mask_pred[..., None]) - 1,
                     2 * (flip_imgs * flip_masks[..., None]) - 1)
    dist = ((pred_vs - mean_shape[None]) ** 2).sum(dim=(1, 2))
    score = tex_loss + dist * (tex_loss.mean() / dist.mean())
    return score, uv_transfer(db["part_prob"], out["uvimage_pred"])


def exemplar_search(cfg: Config, model, lpips, renderer, template,
                    dataloader, device):
    """Pass 1: every image's score and its UV part map, cached in fp16 on
    the host (~0.6 MB an image at CUB scale), so that pass 2 is a host
    reduction rerun per exemplar candidate. Returns (scores [N], maps
    [N,5,h,w] fp16, batch sizes)."""
    faces = torch.as_tensor(template.faces, device=device)
    generator = torch.Generator(device)
    t_pass1 = time.perf_counter()
    t_first = None
    scores, maps, sizes = [], [], []
    for batch in dataloader:
        db = prepare_batch(batch, use_scops=True, use_texture=False)
        db = {k: torch.as_tensor(db[k], device=device)
              for k in ("input_img", "img", "mask", "part_prob")}
        # every batch draws with the same seed, as the JAX loop reuses its key
        generator.manual_seed(cfg.seed)
        score, uv = score_batch(model, lpips, renderer, faces, template, db,
                                generator)
        scores.append(score.cpu().numpy())
        maps.append(uv.half().cpu().numpy())
        sizes.append(int(score.shape[0]))
        if t_first is None:
            t_first = time.perf_counter() - t_pass1
    t_pass1 = time.perf_counter() - t_pass1
    n_b = max(1, len(sizes))
    print(green(f"avg_uv pass1: {t_pass1:.1f}s over {n_b} batches (first "
                f"batch {t_first:.1f}s = warm-up, steady "
                f"{(t_pass1 - t_first) / max(1, n_b - 1):.2f}s/batch)"))
    return np.concatenate(scores), np.concatenate(maps), sizes


def average_uv_maps(all_uv, group_sizes, exemplar_idx):
    """Per batch (group_sizes partition all_uv [N,5,h,w]), the 5 maps
    closest (L2) to the exemplar's are summed; the sum over batches is
    divided by the count kept (ref: avg_uv.py:203-227). Returns [h,w,5]."""
    starts = np.cumsum([0] + list(group_sizes))
    ref_uv = all_uv[exemplar_idx].astype(np.float32)
    d = ((all_uv.astype(np.float32) - ref_uv[None]) ** 2).sum((1, 2, 3))
    acc, counter = 0.0, 0
    for g0, g1 in zip(starts[:-1], starts[1:]):
        k = min(5, g1 - g0)
        idx = g0 + np.argsort(d[g0:g1])[:k]
        acc = acc + all_uv[idx].astype(np.float32).sum(0)
        counter += k
    return (acc / counter).transpose(1, 2, 0)


def texel_probs(avg_prob, template):
    """The UV prob map [h,w,C] sampled at every face's texels, the
    symmetric faces' copied at the end: [F, T*T, C]."""
    uv = torch.as_tensor(template.uv_sampler)
    Ft, T = uv.shape[0], uv.shape[1]
    tex = grid_sample(torch.as_tensor(np.asarray(avg_prob, np.float32))[None],
                      uv.reshape(1, Ft * T * T, 2)).reshape(Ft, T * T, -1)
    return torch.cat([tex, tex[-template.num_sym_faces:]], 0).numpy()


def derive_vertex_labels(avg_prob, template):
    """UV prob map [h,w,5] -> (face_label [F], vert_label [V]), part ids
    0..4: argmax of the 5 channels per texel (ref avg_uv.py:256-264),
    the face's most frequent texel label, the vertex's most frequent
    label over its faces (ref avg_uv.py:268-288)."""
    texel_label = texel_probs(avg_prob, template).argmax(-1)
    face_label = _most_freq(texel_label)
    vert_label = np.zeros(template.num_verts, int)
    for v in range(template.num_verts):
        fids = np.where((template.faces == v).any(axis=1))[0]
        vert_label[v] = _most_freq(face_label[fids][None])[0]
    return face_label, vert_label


def _most_freq(arr):
    """Row-wise most frequent element, the smallest on ties."""
    arr = np.asarray(arr, int)
    out = np.zeros(arr.shape[0], int)
    for i, row in enumerate(arr):
        vals, counts = np.unique(row, return_counts=True)
        out[i] = vals[counts.argmax()]
    return out


def semantic_template(cfg: Config, template, scores, all_uv, group_sizes):
    """Pass 2: the averaged prob map and labels of the best-scored
    exemplar whose template passes the liveliness bar (every part >=
    part_min_vert_frac of the vertices), walking down the ranking up to
    avg_uv_exemplar_retries candidates; else the candidate with the most
    live parts. Returns (prob [h,w,5], vert_label [V], min_cnt)."""
    order = np.argsort(scores)
    n_try = max(1, min(int(cfg.avg_uv_exemplar_retries), order.size))
    min_cnt = max(1, int(np.ceil(cfg.part_min_vert_frac
                                 * template.num_verts)))
    avg_prob = vert_label = None
    best_live = -1
    for rank in range(n_try):
        cand = average_uv_maps(all_uv, group_sizes, int(order[rank]))
        _, vl = derive_vertex_labels(cand, template)
        cnt = [int((vl == p).sum()) for p in range(1, cfg.num_parts + 1)]
        live = sum(c >= min_cnt for c in cnt)
        if live > best_live:
            avg_prob, vert_label, best_live = cand, vl, live
        if live == cfg.num_parts:
            if rank > 0:
                print(green(f"exemplar rank 0 gave a dead template; using "
                            f"rank {rank} (score {scores[order[rank]]:.4f}) "
                            f"with part counts {cnt}"))
            break
    return avg_prob, vert_label, min_cnt


def write_template(cfg: Config, template, model, avg_prob, vert_label,
                   min_cnt):
    """avg_uv's files into cfg.out_dir; returns the part vertex counts."""
    out_dir = cfg.out_dir
    os.makedirs(out_dir, exist_ok=True)
    np.save(osp.join(out_dir, "semantic_prob.npy"), avg_prob)
    seg = np.argmax(avg_prob, axis=2).astype(np.uint8)
    write_png(osp.join(out_dir, "semantic_seg.png"), seg)
    parts = [np.where(vert_label == p)[0]
             for p in range(1, cfg.num_parts + 1)]
    for name, p in zip(PART_NAMES, parts):
        np.save(osp.join(out_dir, f"{name}_vertices.npy"), p)
    counts = {n: len(p) for n, p in zip(PART_NAMES, parts)}
    print(green(f"semantic template part vertex counts: {counts}"))
    empty = [n for n, c in counts.items() if c < min_cnt]
    if empty:
        # corr_loss weighs head and belly only, as does the part matching:
        # a starved set silently kills the semantic objective downstream
        msg = (f"avg_uv produced part vertex sets below the liveliness "
               f"bar (>= {min_cnt} verts each): {empty} (counts "
               f"{counts}). The corr-chamfer and part-matching losses "
               "will be degenerate in train_s2 (which refuses this "
               "template unless --force_template). Check the SCOPS part "
               "maps, the s1 exemplar quality (uv_flow_area scalar), and "
               "the uv part averaging before training stage 2.")
        warnings.warn(msg)
        print(red("WARNING: " + msg))
    mean_v = model.mean_v.detach().cpu()
    torch.save(mean_v.clone(), osp.join(out_dir, "mean_v.pth"))

    # visualisation meshes: the part colours on the surface and per vertex
    mean_full = symmetrize(mean_v, template).numpy()
    seg_color = colorize(seg, cfg.num_parts + 1) / 255.0
    seg_tex = texel_probs(seg_color, template)
    save_obj(osp.join(out_dir, "mean_template.obj"), mean_full,
             template.faces, seg_tex)
    cmap = color_map(cfg.num_parts + 1, normalized=True)
    save_obj(osp.join(out_dir, "vertex_label.obj"), mean_full,
             template.faces, cmap[vert_label], texture_type="vertex")
    print(green(f"Semantic template saved at {out_dir}."))
    return counts


def run(cfg: Config, dataloader=None, device=None):
    """The semantic template of the stage-1 model cfg.model_path over
    `dataloader` (batches with img, mask, part_prob; by default the CUB
    loader of cfg's files, unshuffled and unmirrored), on the card unless
    device="cpu"; written into cfg.out_dir, which it returns."""
    device = resolve_device(device)
    if dataloader is None:
        dataloader = data_loader(cfg, shuffle=False, mirror=False,
                                 device=device)
    template = build_template(cfg.subdivide, cfg.axis, cfg.tex_size)
    model = load_s1_model(cfg, template, device)
    lpips = LPIPSAlex()
    maybe_load_lpips(lpips)
    lpips = lpips.to(device).eval()
    renderer = SoftRenderer(image_size=cfg.image_size, render_type="softmax",
                            anti_aliasing=cfg.anti_aliasing)
    print(green("Search for the exemplar instance."))
    scores, all_uv, sizes = exemplar_search(cfg, model, lpips, renderer,
                                            template, dataloader, device)
    print(green("Start to compute semantic template."))
    avg_prob, vert_label, min_cnt = semantic_template(cfg, template, scores,
                                                      all_uv, sizes)
    write_template(cfg, template, model, avg_prob, vert_label, min_cnt)
    return cfg.out_dir


def main(argv=None):
    run(parse_config(argv, overrides=AVG_UV_DEFAULTS))


if __name__ == "__main__":
    main()
