"""Stage-2 training: the full semantic-consistency objective (port of
umr_tpu/experiments/train_s2.py::run).

run() takes the dataloader (the CUB loader is not ported yet) and the
semantic template that avg_uv writes, as arrays: reading avg_uv's files
from disk waits for the avg_uv port.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import Config, resolve_device
from ..losses.composite import PartMatchingLoss
from ..mesh import build_template
from ..renderer import SoftRenderer
from ..training.steps import build_s2_step
from ..training.trainer import Trainer


def run(cfg: Config, dataloader=None, device=None, semantic=None):
    """Train stage 2 for cfg.num_epochs over `dataloader` (an iterable of
    synthetic_batch-like dicts), or cfg.num_iter steps when that is set,
    on the card unless device="cpu". semantic: (mean_v [num_output,3] or
    None, semantic_seg [H,W] labels 0..num_parts, part_vert_idx: 4 index
    arrays head, belly, neck, back). Returns the Trainer (its state and
    the per-step history)."""
    if dataloader is None:
        raise NotImplementedError(
            "pass a dataloader: the CUB loader is not ported yet")
    if semantic is None:
        raise NotImplementedError(
            "pass semantic=(mean_v, seg, part_vert_idx): reading avg_uv's "
            "semantic template from disk is not ported yet")
    cfg.validate()
    device = resolve_device(device)
    template = build_template(cfg.subdivide, cfg.axis, cfg.tex_size)
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
    trainer = Trainer(cfg, step_fn, state, dataloader)
    trainer.train()
    return trainer
