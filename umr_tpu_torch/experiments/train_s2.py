"""Stage-2 training: the full semantic-consistency objective (port of
umr_tpu/experiments/train_s2.py).

  python -m umr_tpu_torch.experiments.train_s2 --name cub_s2 \\
      --cub_dir CUB_200_2011/ --cub_cache_dir <cache> --scops_path <dir> \\
      --stemp_path <avg_uv output dir> --batch_size 16

run() reads CUB from those files (data/cub.py) unless given a
dataloader. The semantic template comes from avg_uv's files in
--stemp_path (mean_v.pth, semantic_seg.png, {head,neck,back,belly}
_vertices.npy, in vertices_idx/ or beside the PNG), or as arrays. With
--display_visuals the visuals go into {vis_dir}/{name}/ every
display_freq steps.

With --data_parallel (the default) and N > 1 visible cards main() trains
on all of them, one rank per card (parallel/mesh.py::launch; torchrun
--nproc_per_node=N -m ... joins torchrun's group instead); --batch_size
is the global batch, each rank loading batch_size / N, and each step is
the one-process step at the global batch.
"""

from __future__ import annotations

import os
import os.path as osp
import warnings

import numpy as np
import torch

from ..cli import parse_config
from ..config import Config, resolve_device
from ..data.cub import data_loader
from ..losses.composite import PartMatchingLoss
from ..mesh import build_template
from ..models.weights import load_checkpoint
from ..parallel import launch
from ..png import read_png
from ..renderer import SoftRenderer
from ..training.steps import build_s2_step
from ..training.trainer import Trainer
from ..training.visuals import make_visuals_fn
from ..visualizer import red

PARTS = ("head", "belly", "neck", "back")


def load_semantic_template(cfg: Config, template):
    """avg_uv's files in cfg.stemp_path -> (mean_v [num_output,3] or None,
    semantic_seg [H,W] float labels, part_vert_idx: 4 index arrays head,
    belly, neck, back). A template failing the liveliness bar (every part
    >= part_min_vert_frac of the template's vertices) raises ValueError,
    or warns under cfg.force_template: corr_loss and the part matching
    weigh head and belly only, so starved parts silently zero the
    semantic objective."""
    stemp = cfg.stemp_path
    mean_v = None
    mv_path = osp.join(stemp, "mean_v.pth")
    if osp.exists(mv_path):
        mean_v = np.asarray(torch.load(mv_path, map_location="cpu",
                                       weights_only=True)).astype(np.float32)
    seg_path = osp.join(stemp, "semantic_seg.png")
    if not osp.exists(seg_path):
        raise FileNotFoundError(f"{seg_path} missing: run avg_uv first")
    seg = read_png(seg_path).astype(np.float32)

    idx_dir = osp.join(stemp, "vertices_idx")
    if not osp.isdir(idx_dir):
        idx_dir = stemp             # avg_uv writes them beside the PNG
    part_vert_idx = [
        np.load(osp.join(idx_dir, f"{p}_vertices.npy")).astype(np.int64)
        for p in PARTS]
    counts = dict(zip(PARTS, (len(i) for i in part_vert_idx)))
    print(f"semantic template part vertex counts: {counts}")
    min_cnt = max(1, int(np.ceil(cfg.part_min_vert_frac
                                 * template.num_verts)))
    starved = {n: c for n, c in counts.items() if c < min_cnt}
    if starved:
        msg = (f"semantic template fails the liveliness bar "
               f"(every part >= {min_cnt} verts): {starved} of {counts}. "
               "corr_loss/part_matching will be degenerate. Re-run "
               "avg_uv with a better s1 checkpoint (check the "
               "uv_flow_area scalar) or pass --force_template to train "
               "on it anyway.")
        if not cfg.force_template:
            raise ValueError(msg)
        warnings.warn(msg)
        print(red("WARNING (forced): " + msg))
    return mean_v, seg, part_vert_idx


def run(cfg: Config, dataloader=None, device=None, semantic=None):
    """Train stage 2 for cfg.num_epochs over `dataloader` (an iterable of
    CUB-batch dicts; by default the CUB loader of cfg's files), or
    cfg.num_iter steps when that is set, on the card unless device="cpu".
    semantic: (mean_v [num_output,3] or None, semantic_seg [H,W] labels
    0..num_parts, part_vert_idx: 4 index arrays head, belly, neck, back),
    or None to read avg_uv's files from cfg.stemp_path. With
    num_pretrain_epochs > 0 or UMR_TPU_RESUME set, the model starts from
    that .pth ({checkpoint_dir}/{name}/pred_net_latest.pth unless
    UMR_TPU_RESUME names one). Returns the Trainer (its state and the
    per-step history)."""
    cfg.validate()
    device = resolve_device(device)
    template = build_template(cfg.subdivide, cfg.axis, cfg.tex_size)
    if semantic is None:
        semantic = load_semantic_template(cfg, template)
    mean_v, seg, part_vert_idx = semantic
    part_renderer = SoftRenderer(
        image_size=cfg.image_size, render_type="softmax",
        anti_aliasing=cfg.anti_aliasing, ambient_intensity=1.0,
        directional_intensity=0.0)
    part_loss = PartMatchingLoss.build(
        seg, template.uv_sampler, template.num_sym_faces, part_renderer,
        tex_size=cfg.tex_size, num_parts=cfg.num_parts, device=device)
    model, _, _, init_fn, step_fn = build_s2_step(
        cfg, template, part_loss, part_vert_idx, device)
    state = init_fn(cfg.seed)
    if mean_v is not None:
        with torch.no_grad():
            model.mean_v.copy_(torch.as_tensor(np.asarray(mean_v, np.float32)))
    if cfg.num_pretrain_epochs > 0 or os.environ.get("UMR_TPU_RESUME"):
        pth = os.environ.get("UMR_TPU_RESUME", osp.join(
            cfg.checkpoint_dir, cfg.name, "pred_net_latest.pth"))
        if osp.exists(pth):
            load_checkpoint(model, pth)
    if dataloader is None:
        dataloader = data_loader(cfg, device=device)
    visuals_fn = None
    if cfg.display_visuals:
        # lit as stage 1's, on the default black background
        vis_renderer = SoftRenderer(
            image_size=cfg.image_size, render_type="hard",
            anti_aliasing=cfg.anti_aliasing, ambient_intensity=0.8,
            directional_intensity=0.4, light_direction=(0.0, 1.0, -1.0))
        visuals_fn = make_visuals_fn(cfg, template, vis_renderer,
                                     part_loss=part_loss,
                                     part_vert_idx=part_vert_idx)
    trainer = Trainer(cfg, step_fn, state, dataloader,
                      visuals_fn=visuals_fn)
    trainer.train()
    return trainer


def main(argv=None):
    cfg = parse_config(argv)
    launch(run, cfg, data_parallel=cfg.data_parallel)


if __name__ == "__main__":
    main()
