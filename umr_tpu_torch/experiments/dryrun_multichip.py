"""One full stage-2 training step over N ranks (port of
__graft_entry__.py::dryrun_multichip): for even N a 2-D (N/2, 2) mesh,
the batch sharded over "data" and every weight of at least 1 << 12
elements, with its Adam moments, over "model" (parallel/tensor.py:
shard_state, tensor_parallel_step); for odd N data parallelism (the
batch sharded, the state replicated). The configuration is the JAX dry
run's: 32^2, batch N, K=2, no anti-aliasing, subdivide 2, tex_size 2;
the weights random from seed 0 (the committed ResNet-18 trunk and LPIPS
where present).

  python -m umr_tpu_torch.experiments.dryrun_multichip N [--device cpu]

parallel.spawn starts the N ranks: by default on the card or cards
(NCCL when each rank has a card of its own, gloo when ranks share one),
with --device cpu on the CPU (gloo). Rank 0 prints JAX's line,
  dryrun_multichip(N) ok: total_loss=... (mesh {'data': N/2, 'model': 2},
  143 tp-sharded weight tensors)
A non-finite loss or a failed rank exits non-zero.
"""

from __future__ import annotations

import argparse
import math
import os

import numpy as np
import torch

IMG = 32
MIN_SIZE = 1 << 12


def rank(n, device):
    """One rank of the dry run (parallel.spawn joined the group): its
    step's total loss (the mean over the ranks), the mesh's layout and
    the kernels' launches in the step (forward, p2f, backward)."""
    from ..config import Config, resolve_device
    from ..data import synthetic_batch
    from ..losses.composite import PartMatchingLoss
    from ..mesh import build_template
    from ..ops import raster_kernel
    from ..parallel import (make_mesh_2d, replicate, shard_batch, shard_state,
                            tensor_parallel_step)
    from ..renderer import SoftRenderer
    from ..training.steps import build_s2_step
    from ..training.trainer import prepare_batch

    dev = resolve_device(device)
    if dev.type == "cpu":       # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    cfg = Config(image_size=IMG, img_size=IMG, batch_size=n, num_hypo_cams=2,
                 anti_aliasing=False, subdivide=2, tex_size=2)
    template = build_template(cfg.subdivide, cfg.axis, cfg.tex_size)
    rng = np.random.RandomState(0)
    seg = rng.randint(0, 5, size=(16, 32)).astype(np.float32)
    idx = rng.permutation(template.num_verts)
    pvi = [idx[0:20], idx[20:60], idx[60:80], idx[80:120]]
    part_loss = PartMatchingLoss.build(
        seg, template.uv_sampler, template.num_sym_faces,
        SoftRenderer(image_size=IMG, anti_aliasing=False,
                     ambient_intensity=1.0, directional_intensity=0.0),
        tex_size=cfg.tex_size, device=dev)
    init_fn, step_fn = build_s2_step(cfg, template, part_loss, pvi, dev)[3:]
    state = replicate(init_fn(0))
    batch = prepare_batch(synthetic_batch(rng, n, IMG))
    if n >= 2 and n % 2 == 0:
        mesh = make_mesh_2d(n // 2, 2)
        state, specs = shard_state(state, mesh, min_size=MIN_SIZE)
        n_tp = sum(d is not None for d in specs.values())
        assert n_tp >= 2, "no weights model-sharded in the tp dry run"
        step = tensor_parallel_step(step_fn, mesh, specs)
        layout = f"mesh {mesh.shape}, {n_tp} tp-sharded weight tensors"
    else:
        step = step_fn
        layout = f"mesh {{'data': {n}}}"
    raster_kernel.LAUNCHES = raster_kernel.BWD_LAUNCHES = 0
    raster_kernel.P2F_LAUNCHES = 0
    _, scalars = step(state, shard_batch(batch))
    total = float(scalars["total_loss"])
    if not math.isfinite(total):
        raise FloatingPointError(f"non-finite loss {total}")
    return dict(total=total, layout=layout, launches=(
        raster_kernel.LAUNCHES, raster_kernel.P2F_LAUNCHES,
        raster_kernel.BWD_LAUNCHES))


def line(n, r):
    """JAX's line from rank 0's result."""
    return (f"dryrun_multichip({n}) ok: total_loss={r['total']:.4f} "
            f"({r['layout']})")


def run(n, device=None):
    """The dry run on n spawned ranks; returns rank 0's line."""
    from ..parallel import spawn

    return line(n, spawn(rank, n, n, device, device=device)[0])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("n", type=int, nargs="?", default=8)
    ap.add_argument("--device", default=None, help="the card unless 'cpu'")
    args = ap.parse_args(argv)
    print(run(args.n, args.device), flush=True)


if __name__ == "__main__":
    main()
