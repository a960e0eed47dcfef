"""Stage-1 training: reconstruction without semantic constraints, with the
online template update (port of umr_tpu/experiments/train_s1.py::run).

run() reads CUB from --cub_dir / --cub_cache_dir (data/cub.py) unless
given a dataloader; config() parses stage 1's command line, whose
defaults are cli.S1_DEFAULTS. The trainer writes {checkpoint_dir}/{name}/
pred_net_latest.pth (what avg_uv reads), pred_state.pt (auto-resume),
loss_log.txt, opts.log and stage_budget.json, and with --display_visuals
the visuals into {vis_dir}/{name}/ every display_freq steps.

  python -m umr_tpu_torch.experiments.train_s1 --name cub_s1 \\
      --cub_dir CUB_200_2011/ --cub_cache_dir <cache> --batch_size 64

With --data_parallel (the default) and N > 1 visible cards main() trains
on all of them, one rank per card (parallel/mesh.py::launch; torchrun
--nproc_per_node=N -m ... joins torchrun's group instead); --batch_size
is the global batch, each rank loading batch_size / N. The template
update averages the VAE samples of every rank.
"""

from __future__ import annotations

import torch

from ..cli import S1_DEFAULTS, parse_config
from ..config import Config, resolve_device
from ..data.cub import data_loader
from ..mesh import build_template
from ..parallel import all_reduce_, is_writer, launch
from ..renderer import SoftRenderer
from ..training.steps import build_s1_step
from ..training.trainer import Trainer, prepare_batch
from ..training.visuals import make_visuals_fn
from ..visualizer import green


def config(argv=None) -> Config:
    """Stage 1's Config from a command line (argparse over Config's
    fields, stage 1's defaults)."""
    return parse_config(argv, overrides=S1_DEFAULTS)


def vis_renderer(cfg: Config):
    """The visuals' renderer: hard, white background, lit ambient 0.8 +
    directional 0.4 along (0, 1, -1)."""
    return SoftRenderer(
        image_size=cfg.image_size, render_type="hard",
        anti_aliasing=cfg.anti_aliasing, ambient_intensity=0.8,
        directional_intensity=0.4, light_direction=(0.0, 1.0, -1.0),
        background_color=(1.0, 1.0, 1.0))


def update_template(cfg, state, dataloader, encode_feat_fn,
                    template_update_fn, generator):
    """The online template update: mean_v += shape_predictor(the mean VAE
    sample over the loader's images), the sample's noise drawn from
    `generator`. In a group of ranks the sums and counts are all-reduced
    first, so the mean is over every rank's images. Returns (state, the
    number of images averaged)."""
    total, count = None, 0
    for batch in dataloader:
        db = prepare_batch(batch, cfg.use_scops, cfg.use_texture)
        f = encode_feat_fn(state, db, generator=generator)
        total = f.sum(0) if total is None else total + f.sum(0)
        count += f.shape[0]
    sums = torch.cat([total, total.new_full((1,), count)])
    all_reduce_([sums], mean=False)
    count = int(sums[-1])
    return template_update_fn(state, sums[:-1] / count), count


def run(cfg: Config, dataloader=None, device=None):
    """Train stage 1 for cfg.num_epochs over `dataloader` (an iterable of
    CUB-batch dicts; by default the CUB loader of cfg's files), or
    cfg.num_iter steps when that is set, on the card unless device="cpu".
    Every update_template_freq epochs
    the template moves: mean_v += shape_predictor(mean VAE sample over
    the loader). LPIPS and the ResNet trunk come from weights/. Returns
    the Trainer (its state, the per-step history, and template_updates:
    (epoch, images averaged) of each update)."""
    cfg.validate()
    device = resolve_device(device)
    if dataloader is None:
        dataloader = data_loader(cfg, device=device)
    template = build_template(cfg.subdivide, cfg.axis, cfg.tex_size)
    _, _, _, init_fn, step_fn, encode_feat_fn, template_update_fn = (
        build_s1_step(cfg, template, device))
    state = init_fn(cfg.seed)
    updates = []

    def on_epoch_end(state, epoch):
        if (epoch + 1) % cfg.update_template_freq:
            return state
        gen = torch.Generator(device).manual_seed(cfg.seed + 1234 + epoch)
        state, count = update_template(cfg, state, dataloader,
                                       encode_feat_fn, template_update_fn,
                                       gen)
        updates.append((epoch, count))
        if is_writer():
            print(green(f"epoch {epoch}: template updated from {count} "
                        "images"), flush=True)
        return state

    visuals_fn = (make_visuals_fn(cfg, template, vis_renderer(cfg))
                  if cfg.display_visuals else None)
    trainer = Trainer(cfg, step_fn, state, dataloader,
                      extra_step_args=lambda epoch: (float(epoch),),
                      on_epoch_end=on_epoch_end, visuals_fn=visuals_fn)
    trainer.template_updates = updates
    trainer.train()
    return trainer


def main(argv=None):
    cfg = config(argv)
    launch(run, cfg, data_parallel=cfg.data_parallel)


if __name__ == "__main__":
    main()
