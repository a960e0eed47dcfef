"""Stage-1 training: reconstruction without semantic constraints, with the
online template update (port of umr_tpu/experiments/train_s1.py::run).

run() takes the dataloader (the CUB loader is not ported yet); config()
parses stage 1's command line, whose defaults are cli.S1_DEFAULTS. The
trainer writes {checkpoint_dir}/{name}/pred_net_latest.pth (what avg_uv
reads), pred_state.pt (auto-resume), loss_log.txt, opts.log and
stage_budget.json.

  python -m umr_tpu_torch.experiments.train_s1 --name cub_s1 ...
"""

from __future__ import annotations

import torch

from ..cli import S1_DEFAULTS, parse_config
from ..config import Config, resolve_device
from ..mesh import build_template
from ..training.steps import build_s1_step
from ..training.trainer import Trainer, prepare_batch
from ..visualizer import green


def config(argv=None) -> Config:
    """Stage 1's Config from a command line (argparse over Config's
    fields, stage 1's defaults)."""
    return parse_config(argv, overrides=S1_DEFAULTS)


def run(cfg: Config, dataloader=None, device=None):
    """Train stage 1 for cfg.num_epochs over `dataloader` (an iterable of
    synthetic_batch-like dicts), or cfg.num_iter steps when that is set,
    on the card unless device="cpu". Every update_template_freq epochs
    the template moves: mean_v += shape_predictor(mean VAE sample over
    the loader). LPIPS and the ResNet trunk come from weights/. Returns
    the Trainer (its state, the per-step history, and template_updates:
    (epoch, images averaged) of each update)."""
    if dataloader is None:
        raise NotImplementedError(
            "pass a dataloader: the CUB loader is not ported yet")
    cfg.validate()
    device = resolve_device(device)
    template = build_template(cfg.subdivide, cfg.axis, cfg.tex_size)
    _, _, _, init_fn, step_fn, encode_feat_fn, template_update_fn = (
        build_s1_step(cfg, template, device))
    state = init_fn(cfg.seed)
    updates = []

    def on_epoch_end(state, epoch):
        if (epoch + 1) % cfg.update_template_freq:
            return state
        gen = torch.Generator(device).manual_seed(cfg.seed + 1234 + epoch)
        total, count = None, 0
        for batch in dataloader:
            db = prepare_batch(batch, cfg.use_scops, cfg.use_texture)
            f = encode_feat_fn(state, db, generator=gen)
            total = f.sum(0) if total is None else total + f.sum(0)
            count += f.shape[0]
        state = template_update_fn(state, total / count)
        updates.append((epoch, count))
        print(green(f"epoch {epoch}: template updated from {count} "
                    "images"), flush=True)
        return state

    trainer = Trainer(cfg, step_fn, state, dataloader,
                      extra_step_args=lambda epoch: (float(epoch),),
                      on_epoch_end=on_epoch_end)
    trainer.template_updates = updates
    trainer.train()
    return trainer


def main(argv=None):
    run(config(argv))


if __name__ == "__main__":
    main()
