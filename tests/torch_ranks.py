"""The rank side of the port's data-parallel checks: what each rank of
parallel.spawn runs and reports (a training step, the BatchNorms, a run
of train_s2, a digest of the state), and the same alone for one
process. tests/test_torch_parallel.py spawns these on CPU ranks, and
chip_smoke.py on ranks on the card. This module imports nothing of jax
or umr_tpu (tests/test_torch_nojax.py checks it), so that it runs on a
machine that has neither. Torch is kept to a few threads: the suite
runs under several xdist workers, and each spawns ranks.
"""

from __future__ import annotations

import numpy as np
import torch

torch.set_num_threads(2)


def np_of(x):
    """jax or torch array -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def grads_of(state):
    """{'model.<name>' / 'disc.<name>': p.grad as numpy} of the parameters
    that have a gradient."""
    return {f"{p}.{n}": np_of(t.grad)
            for p, mod in (("model", state.model), ("disc", state.disc))
            for n, t in mod.named_parameters() if t.grad is not None}


def state_digest(state):
    """sha256 of everything ranks must agree on after a step: the weights
    and buffers of the model, the discriminator and LPIPS, the optimizer's
    state, the generator's state and the step and update counts."""
    import hashlib

    h = hashlib.sha256(f"{state.step} {state.updates}".encode())
    tensors = []
    for mod in (state.model, state.disc, state.lpips):
        tensors += list(mod.state_dict().values())
    for per_param in state.optimizer.state_dict()["state"].values():
        tensors += [v for _, v in sorted(per_param.items())
                    if torch.is_tensor(v)]
    tensors.append(state.generator.get_state())
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _port_builders(spec, device):
    """The port's step of spec (training/steps.py), as the entry points
    build it: (cfg, template, init_fn, step_fn, encode_feat_fn,
    template_update_fn); stage 2's part renderer as train_s2.run's."""
    from umr_tpu_torch.config import Config
    from umr_tpu_torch.losses.composite import PartMatchingLoss
    from umr_tpu_torch.mesh import build_template
    from umr_tpu_torch.renderer import SoftRenderer
    from umr_tpu_torch.training import steps as tsteps

    cfg = Config(**spec["kw"]).sync_image_size()
    template = build_template(*spec["template"])
    impl = spec.get("impl", "auto")
    if spec["stage"] == 1:
        return (cfg, template) + tsteps.build_s1_step(
            cfg, template, device, impl=impl)[3:]
    pl = PartMatchingLoss.build(
        spec["seg"], template.uv_sampler, template.num_sym_faces,
        SoftRenderer(image_size=cfg.image_size,
                     anti_aliasing=cfg.anti_aliasing, ambient_intensity=1.0,
                     directional_intensity=0.0, impl=impl),
        tex_size=cfg.tex_size, num_parts=cfg.num_parts, device=device)
    return (cfg, template) + tsteps.build_s2_step(
        cfg, template, pl, spec["pvi"], device, impl=impl)[3:] + (None, None)


def _bn_per_rank(self, x):
    """A BatchNorm normalising over this rank's batch alone (the negative
    control of the global BatchNorm)."""
    return torch.nn.modules.batchnorm._BatchNorm.forward(self, x.float())


def _timed_steps(step_fn, state, batch, args, draws, n, device):
    """n steps each timed on the host's clock to a synchronize (step_ms),
    then n more with every all_reduce call timed between two
    synchronizes (all_reduce_ms, and those steps' own wrapped_ms: the
    synchronizes stall the host, so the share of all_reduce is read on
    these)."""
    import time

    import torch.distributed as dist

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def steps(box):
        times = []
        for _ in range(n):
            box.append(0.0)
            sync()
            t0 = time.perf_counter()
            step_fn(state, batch, *args, draws=draws)
            sync()
            times.append(1e3 * (time.perf_counter() - t0))
        return times

    reduce, comm = dist.all_reduce, []

    def timed_all_reduce(*a, **k):
        sync()
        t0 = time.perf_counter()
        r = reduce(*a, **k)
        sync()
        comm[-1] += 1e3 * (time.perf_counter() - t0)
        return r

    out = dict(step_ms=steps([]))
    dist.all_reduce = timed_all_reduce
    try:
        out["wrapped_ms"] = steps(comm)
    finally:
        dist.all_reduce = reduce
    out["all_reduce_ms"] = comm
    return out


def rank_steps(specs):
    """One training step per spec, on this process's rank of the group
    (parallel.spawn) or alone (no group: the one-process step). spec:
    stage, kw (Config fields), template (subdivide, axis, tex_size), seg
    and pvi (stage 2's semantic template), batch (the prepared global
    batch, numpy), draws (global, numpy), optional init (state dicts of
    model and disc, loaded on every rank), epoch (stage 1),
    template_batches (stage 1: global batches the template update
    averages before the step), per_rank_bn (the BatchNorms normalise per
    rank: the negative control), timed (further steps timed, as
    _timed_steps does), device ("cpu", or the rank's card).
    Each rank starts from init_fn(seed + rank), then takes rank 0's state
    (parallel.replicate). Returns per spec: the template update's mean_v
    and image count, the step's scalars, the kernels' launches in the
    step, the state digest after it, on rank 0 (or alone) the gradients
    and BatchNorm statistics after the step, and the seconds each part
    took."""
    import time

    from umr_tpu_torch.config import resolve_device
    from umr_tpu_torch.experiments.train_s1 import update_template
    from umr_tpu_torch.models import net_blocks
    from umr_tpu_torch.ops import raster_kernel
    from umr_tpu_torch.parallel import rank_and_size, replicate, shard_batch

    rank, _ = rank_and_size()
    outs = []
    for spec in specs:
        t0 = time.perf_counter()
        device = resolve_device(spec.get("device", "cpu"))
        cfg, _, init_fn, step_fn, encode_feat_fn, template_update_fn = (
            _port_builders(spec, device))
        state = init_fn(cfg.seed + rank)
        if spec.get("init") is not None:
            state.model.load_state_dict(spec["init"]["model"])
            state.disc.load_state_dict(spec["init"]["disc"])
        t1 = time.perf_counter()
        replicate(state)
        out = {}
        if spec.get("template_batches"):
            gen = torch.Generator(device).manual_seed(cfg.seed + 1234)
            state, out["count"] = update_template(
                cfg, state, [shard_batch(b) for b in spec["template_batches"]],
                encode_feat_fn, template_update_fn, gen)
            out["mean_v"] = np_of(state.model.mean_v)
        batch = shard_batch(spec["batch"])
        draws = {k: torch.as_tensor(v) for k, v in spec["draws"].items()}
        args = (spec.get("epoch", 0.0),) if spec["stage"] == 1 else ()
        forward = net_blocks._FloatBatchNorm.forward
        if spec.get("per_rank_bn"):
            net_blocks._FloatBatchNorm.forward = _bn_per_rank
        try:
            raster_kernel.LAUNCHES = raster_kernel.BWD_LAUNCHES = 0
            raster_kernel.P2F_LAUNCHES = 0
            state, sc = step_fn(state, batch, *args, draws=draws)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        finally:
            net_blocks._FloatBatchNorm.forward = forward
        t2 = time.perf_counter()
        out.update(scalars={k: float(v) for k, v in sc.items()},
                   launches=(raster_kernel.LAUNCHES,
                             raster_kernel.P2F_LAUNCHES,
                             raster_kernel.BWD_LAUNCHES),
                   digest=state_digest(state))
        if rank == 0:
            out.update(grads=grads_of(state), buffers={
                k: np_of(v) for k, v in state.model.state_dict().items()
                if "running" in k})
        out["seconds"] = dict(build=t1 - t0, replicate_update_step=t2 - t1,
                              read=time.perf_counter() - t2)
        if spec.get("timed"):
            out.update(_timed_steps(step_fn, state, batch, args, draws,
                                    spec["timed"], device))
        outs.append(out)
    return outs


def rank_bn(cases):
    """The port's BatchNorms in train mode on this rank's block of each
    case's global input (parallel.spawn), or on all of it alone. case:
    kind ("2d": net_blocks.BatchNorm2d, "1d": BatchNorm1d), x (global
    input), g (the upstream gradient of the output), dtype of the input,
    seed of the affine parameters and running statistics. The loss is
    sum(y * g). Returns per case: y, dx, this rank's weight and bias
    gradients, the running statistics and the batch count."""
    from umr_tpu_torch.models.net_blocks import BatchNorm1d, BatchNorm2d
    from umr_tpu_torch.parallel import shard_batch

    outs = []
    for case in cases:
        C = case["x"].shape[1]
        bn = (BatchNorm2d if case["kind"] == "2d" else BatchNorm1d)(
            C, eps=1e-5, momentum=0.1)
        rng = np.random.RandomState(case["seed"])
        with torch.no_grad():
            for t, lo in ((bn.weight, 0.5), (bn.running_var, 0.5)):
                t.copy_(torch.as_tensor(rng.uniform(lo, 1.5, C)))
            for t in (bn.bias, bn.running_mean):
                t.copy_(torch.as_tensor(rng.normal(0.0, 0.1, C)))
        block = shard_batch({"x": case["x"], "g": case["g"]})
        x = torch.as_tensor(block["x"]).to(case["dtype"]).requires_grad_()
        y = bn(x)
        (y * torch.as_tensor(block["g"])).sum().backward()
        outs.append(dict(
            y=np_of(y), dx=np_of(x.grad.float()), dw=np_of(bn.weight.grad),
            db=np_of(bn.bias.grad), running_mean=np_of(bn.running_mean),
            running_var=np_of(bn.running_var),
            n=int(bn.num_batches_tracked)))
    return outs


def rank_train(kw, batches, semantic, runs):
    """train_s2.run on the CPU over this rank's blocks of the global
    batches, once per num_iter in runs (each later run resumes from the
    files of the one before). Returns per run (the state's step, the
    steps this run took, the state digest)."""
    from umr_tpu_torch.config import Config
    from umr_tpu_torch.experiments import train_s2
    from umr_tpu_torch.parallel import shard_batch

    loader = [shard_batch(b) for b in batches]
    outs = []
    for n in runs:
        trainer = train_s2.run(Config(**kw, num_iter=n), loader,
                               device="cpu", semantic=semantic)
        outs.append((trainer.state.step, len(trainer.history),
                     state_digest(trainer.state)))
    return outs


# ---- tensor parallelism ------------------------------------------------

def tp_full(state, kinds=None):
    """{'model.<n>' | 'disc.<n>': dict(param, grad, and the optimizer's
    moments by name, or those of `kinds`)} at full size, as numpy: a
    sharded parameter's from the shards of its model group (parallel/
    tensor.py::Shards.full, a collective: every rank calls it), a
    replicated one's as it is."""
    opt = state.optimizer
    out = {}
    named = {f"{p}.{n}": t
             for p, mod in (("model", state.model), ("disc", state.disc))
             for n, t in mod.named_parameters()}
    shards = state.shards
    entries = {} if shards is None else {
        e.name: e for e in shards.entries if e.trainable}
    moments = sorted({k for st in opt.state.values() for k, v in st.items()
                      if torch.is_tensor(v) and v.dim() > 0})
    kinds = ["param", "grad"] + moments if kinds is None else list(kinds)
    moments = [m for m in moments if m in kinds]
    for name, t in named.items():
        if name in entries:
            continue
        # copies: the optimizer updates parameters and moments in place
        rec = dict(param=np_of(t).copy()) if "param" in kinds else {}
        if t.grad is not None and "grad" in kinds:
            rec["grad"] = np_of(t.grad).copy()
        rec.update({m: np_of(opt.state[t][m]).copy() for m in moments
                    if m in opt.state.get(t, {})})
        out[name] = rec
    if entries:
        es = [e for e in shards.entries if e.trainable]
        for kind in kinds:
            vals = [e.shard if kind == "param" else e.shard.grad
                    if kind == "grad" else opt.state[e.shard][kind]
                    for e in es]
            for e, full in zip(es, shards.full(vals)):
                out.setdefault(e.name, {})[kind] = np_of(full)
    return out


def tp_digests(state):
    """(replicated, sharded): sha256 of the state the ranks of a model
    group must hold alike (weights and buffers of the three modules, the
    replicated parameters' optimizer state, the generator, the counts)
    and of what the ranks of a data group must hold alike besides (the
    shards and their optimizer state)."""
    import hashlib

    rep = hashlib.sha256(f"{state.step} {state.updates}".encode())
    sha = hashlib.sha256()
    sharded = {id(e.shard) for e in state.shards.entries}
    tensors = [(rep, t) for mod in (state.model, state.disc, state.lpips)
               for t in mod.state_dict().values()]
    tensors += [(sha, e.shard) for e in state.shards.entries]
    for group in state.optimizer.param_groups:
        for p in group["params"]:
            h = sha if id(p) in sharded else rep
            tensors += [(h, v) for _, v in sorted(
                state.optimizer.state.get(p, {}).items())
                if torch.is_tensor(v)]
    tensors.append((rep, state.generator.get_state()))
    for h, t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return rep.hexdigest(), sha.hexdigest()


def _helper_readings(seed):
    """What the rank helpers give this rank: its data coordinate and axis
    size, its block of a 4-row batch, a rank_block draw and the first
    draw of rank_generator's stream."""
    from umr_tpu_torch.parallel import (data_rank_and_size, rank_block,
                                        rank_generator, shard_batch)

    g = torch.Generator().manual_seed(seed)
    return dict(
        data=data_rank_and_size(),
        block=np_of(shard_batch({"x": torch.arange(4)})["x"]),
        rank_block=np_of(rank_block(lambda n: torch.randn(
            n, generator=g), 2)),
        rank_generator=np_of(torch.randn(3, generator=rank_generator(g))))


def _beyond_rounding(got, want):
    """The largest |got - want| beyond two float32 roundings of want
    (2^-23 |want|): the update and its recomputation each round once."""
    return ((got - want).abs() - 2.0 ** -23 * want.abs()).clamp_min(0).max()


def rank_tp(mesh_shape, specs, refusals=False):
    """One stage-2 step per spec on this rank of a make_mesh_2d(*
    mesh_shape) group through parallel.tensor_parallel_step over
    shard_state(min_size=spec['min_size']), or alone (mesh_shape None:
    the one-process step, for reference). spec: as rank_steps' (stage 2)
    plus min_size; timed: further steps timed on the host's clock to a
    synchronize; full: the kinds tp_full returns (default all);
    shard_moments: each rank returns its shards' moments as they are;
    steps: the steps taken before the readings (default 1).
    Each rank starts from init_fn(seed + rank), then rank 0's state
    (parallel.replicate). Returns per spec: the step's scalars,
    launches, the sharded leaves of the specs, the sharded tensors
    (name, full shape, shard shape, dimension, moment shapes), the
    digests (tp_digests), on rank 0 (or alone) the full tensors after
    the step (tp_full) and the BatchNorm statistics, for one Adam step
    the largest distance in lr, beyond two float32 roundings of it
    (_beyond_rounding), of
    any parameter from p0 - lr g / (|g| + eps) (the first Adam step on
    its gradient g, held by the rank on its shards and replicated
    parameters), the seconds of each part, the step's peak memory on the
    card above what the process held before the spec;
    and the helpers' readings (_helper_readings). refusals: the messages
    of make_mesh_2d on a mismatched shape and of shard_batch and
    Config's check on a batch the data axis does not divide."""
    import time

    from umr_tpu_torch.config import Config, resolve_device
    from umr_tpu_torch.ops import raster_kernel
    from umr_tpu_torch.parallel import (make_mesh_2d, rank_and_size,
                                        replicate, shard_batch, shard_state,
                                        tensor_parallel_step)

    rank, size = rank_and_size()
    out = {}
    if refusals:
        out["refusals"] = []
        for fn in (lambda: make_mesh_2d(size + 1, 1),
                   lambda: make_mesh_2d(1, size - 1)):
            try:
                fn()
                out["refusals"].append(None)
            except ValueError as e:
                out["refusals"].append(str(e))
    mesh = make_mesh_2d(*mesh_shape) if mesh_shape else None
    out["helpers"] = _helper_readings(5)
    if refusals:
        for fn in (lambda: shard_batch({"x": np.arange(3)}),
                   lambda: Config(batch_size=3).validate()):
            try:
                fn()
                out["refusals"].append(None)
            except ValueError as e:
                out["refusals"].append(str(e))
    outs = []
    for spec in specs:
        t0 = time.perf_counter()
        device = resolve_device(spec.get("device", "cpu"))
        # what the process held on the card before this spec (another
        # phase's tensors): not counted in the spec's peak
        floor = (torch.cuda.memory_allocated(device)
                 if device.type == "cuda" else 0)
        cfg, _, init_fn, step_fn, _, _ = _port_builders(spec, device)
        state = init_fn(cfg.seed + rank)
        if spec.get("init") is not None:
            state.model.load_state_dict(spec["init"]["model"])
            state.disc.load_state_dict(spec["init"]["disc"])
        replicate(state)
        rec = {}
        if mesh is not None:
            state, specs_ = shard_state(state, mesh,
                                        min_size=spec["min_size"])
            step_fn = tensor_parallel_step(step_fn, mesh, specs_)
            rec["spec_leaves"] = sorted(k for k, d in specs_.items()
                                        if d is not None)
            rec["sharded"] = [(e.name, tuple(e.shape), tuple(e.shard.shape),
                               e.dim) for e in state.shards.entries]
        params = [p for g in state.optimizer.param_groups
                  for p in g["params"]]
        # on the host: a copy on the card would count in the step's peak
        p0 = [p.detach().cpu().clone() for p in params]
        batch = shard_batch(spec["batch"])
        draws = {k: torch.as_tensor(v) for k, v in spec["draws"].items()}
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        t1 = time.perf_counter()
        raster_kernel.LAUNCHES = raster_kernel.BWD_LAUNCHES = 0
        raster_kernel.P2F_LAUNCHES = 0
        for _ in range(spec.get("steps", 1)):
            state, sc = step_fn(state, batch, draws=draws)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            rec["peak_gb"] = (torch.cuda.max_memory_allocated(device)
                              - floor) / 1e9
        t2 = time.perf_counter()
        rec.update(scalars={k: float(v) for k, v in sc.items()},
                   launches=(raster_kernel.LAUNCHES,
                             raster_kernel.P2F_LAUNCHES,
                             raster_kernel.BWD_LAUNCHES))
        if mesh is not None:
            rec["digests"] = tp_digests(state)
            rec["moment_shapes"] = {
                e.name: {k: tuple(v.shape) for k, v in
                         state.optimizer.state[e.shard].items()
                         if torch.is_tensor(v) and v.dim() > 0}
                for e in state.shards.entries if e.trainable}
        rec["buffers"] = {k: np_of(v).copy() for k, v in
                          state.model.state_dict().items() if "running" in k}
        if not cfg.use_sgd and spec.get("steps", 1) == 1:
            lr = cfg.learning_rate
            rec["adam_err"] = max(float(_beyond_rounding(
                p.detach(), q.to(p.device) - lr * g / (g.abs() + 1e-8)))
                / lr for p, q, g in ((p, q, p.grad if p.grad is not None
                                      else torch.zeros_like(p))
                                     for p, q in zip(params, p0)))
        del p0
        if spec.get("shard_moments") and mesh is not None:
            rec["moment_shards"] = {
                e.name: {k: np_of(v).copy() for k, v in
                         state.optimizer.state[e.shard].items()
                         if torch.is_tensor(v) and v.dim() > 0}
                for e in state.shards.entries if e.trainable}
        full = tp_full(state, spec.get("full"))
        if rank == 0:
            rec["full"] = full
        rec["seconds"] = dict(build=t1 - t0, step=t2 - t1,
                              read=time.perf_counter() - t2)
        if spec.get("timed"):
            times = []
            for _ in range(spec["timed"]):
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                ts = time.perf_counter()
                step_fn(state, batch, draws=draws)
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                times.append(1e3 * (time.perf_counter() - ts))
            rec["step_ms"] = times
        outs.append(rec)
        del state
        if device.type == "cuda":
            torch.cuda.empty_cache()
    out["specs"] = outs
    return out
