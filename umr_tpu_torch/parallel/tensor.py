"""Tensor parallelism over torch.distributed (port of umr_tpu/parallel/
mesh.py's tensor-parallel half: param_partition_specs, shard_state,
tensor_parallel_step).

In the JAX package a 2-D ("data", "model") mesh shards every array of
at least min_size elements along its largest dimension that the model
axis divides (ties to the later dimension), the Adam moments as their
parameters, the batch over "data", and GSPMD inserts the collectives of
one jitted step whose math is the unsharded step's at the global batch.
Here the mesh is parallel/mesh.py::make_mesh_2d's, each rank a process,
and the same step is made explicit:

  * param_partition_specs applies JAX's rule to each tensor's flax-layout
    shape (a Dense kernel is nn.Linear's weight transposed, a Conv
    kernel HWIO is nn.Conv2d's OIHW: models/reference_io.py's T_LINEAR,
    T_CONV, through build_key_map for the model) and names the torch
    dimension the layout moves the chosen one to, so it shards the
    leaves JAX's shards, along the same logical dimension;
  * shard_state keeps on each rank its model coordinate's slice of every
    sharded tensor (Shards), in one optimizer over the shards and the
    replicated parameters, whose moments are then shard-sized; between
    steps the modules hold each sharded tensor at size 0;
  * tensor_parallel_step gathers each sharded tensor to full size (an
    all_reduce over the model group of a zero-filled buffer into which
    each rank writes its slice: exact, every element has one non-zero
    addend), runs the one-process step on the rank's data block
    (training/steps.py::_train_step, which moves each sharded
    parameter's gradient slice into its shard's .grad after the
    backward, Shards.take_grads, and reduces before the update,
    Shards.reduce_grads), and releases the full-size copies.

The BatchNorms, the batch blocks and the random draws follow the data
coordinate (parallel/mesh.py), so the ranks of a model group compute the
same block; the step is the one-process step at the global batch.

Bit-equal replicas. The kernels' backward accumulates with atomicAdd, so
two ranks of a model group compute "the same" gradient up to the last
bits. The replicated parameters' gradients are therefore averaged over
the whole group (one all_reduce, whose result every rank receives
alike); a shard's gradient over its data group. The buffers the forward
updates (the BatchNorms' running statistics) are broadcast from model
coordinate 0 over each model group after the step. So after every step
the ranks of a model group hold bit-equal replicated state, and the
ranks of a data group bit-equal shards.

Only all_reduce and broadcast are used, as in parallel/mesh.py.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn as nn

from ..models.reference_io import T_CONV, T_LINEAR, build_key_map
from ..models.weights import model_variant
from .mesh import all_reduce_, broadcast_

# flax leaf dimension i is torch dimension _PERM[transform][i]
_PERM = {T_LINEAR: (1, 0), T_CONV: (2, 3, 1, 0)}


def shard_dim(shape, n, min_size=1 << 22):
    """JAX's rule on a bare shape: the dimension along which an array of
    `shape` shards over n model ranks (its largest that n divides, ties
    to the later), or None (n <= 1, a scalar, fewer than min_size
    elements, or no dimension n divides)."""
    if n <= 1 or len(shape) == 0 or math.prod(shape) < min_size:
        return None
    best = None
    for d, s in enumerate(shape):
        if s % n == 0 and (best is None or s >= shape[best]):
            best = d
    return best


def _module_layouts(prefix, module):
    """{name: transform} of the Linear and Conv2d weights of a module."""
    out = {}
    for name, mod in module.named_modules():
        if isinstance(mod, (nn.Linear, nn.Conv2d)):
            out[f"{prefix}.{name}.weight"] = (
                T_LINEAR if isinstance(mod, nn.Linear) else T_CONV)
    return out


def _model_layouts(model):
    """{'model.<key>': transform} through the model's flax key map."""
    stage, num_cams, variant = model_variant(model)
    n_up = (len(model.texture_predictor.decoder) - 1) // 2 if (
        variant["use_texture"]) else 5
    maps = build_key_map(stage, num_cams, n_up, **variant)
    return {f"model.{tkey}": tf for m in maps for _, tkey, tf in m}


def _moment_names(optimizer):
    """The per-parameter state tensors shaped as their parameter."""
    if isinstance(optimizer, torch.optim.Adam):
        names = ("exp_avg", "exp_avg_sq")
        return names + (("max_exp_avg_sq",) if optimizer.defaults.get(
            "amsgrad") else ())
    if isinstance(optimizer, torch.optim.SGD):
        return ("momentum_buffer",) if optimizer.defaults.get(
            "momentum") else ()
    raise TypeError(f"no moment layout for {type(optimizer).__name__}")


def _owned(state):
    """{'model.<k>' | 'disc.<k>' | 'lpips.<k>': the tensor object of the
    module's state_dict} (parameters as Parameters)."""
    out = {}
    for prefix, mod in (("model", state.model), ("disc", state.disc),
                        ("lpips", state.lpips)):
        if mod is not None:
            for k, v in mod.state_dict(keep_vars=True).items():
                out[f"{prefix}.{k}"] = v
    return out


def param_partition_specs(state, mesh, min_size=1 << 22):
    """{name: the torch dimension to shard, or None} over a TrainState:
    'model.<key>', 'disc.<key>', 'lpips.<key>' for every tensor of the
    three modules' state_dicts (parameters, BatchNorm statistics,
    buffers, mean_v, the frozen LPIPS weights), and '<param name>:
    <moment>' for each optimizer parameter's moments (Adam's exp_avg and
    exp_avg_sq, SGD's momentum_buffer), which shard as their parameter.
    The dimension is JAX's rule (shard_dim, over mesh.shape['model'])
    on the flax-layout shape, sent to the torch dimension the layout
    moves it to."""
    n = mesh.shape.get("model", 1)
    layouts = _model_layouts(state.model)
    for prefix, mod in (("disc", state.disc), ("lpips", state.lpips)):
        if mod is not None:
            layouts.update(_module_layouts(prefix, mod))
    specs = {}
    owned = _owned(state)
    for name, t in owned.items():
        perm = _PERM.get(layouts.get(name), tuple(range(t.dim())))
        d = shard_dim(tuple(t.shape[p] for p in perm), n, min_size)
        specs[name] = None if d is None else perm[d]
    names = {id(t): k for k, t in owned.items()}
    for group in state.optimizer.param_groups:
        for p in group["params"]:
            for m in _moment_names(state.optimizer):
                specs[f"{names[id(p)]}:{m}"] = specs[names[id(p)]]
    return specs


def _slice(t, dim, mesh):
    c = t.shape[dim] // mesh.n_model
    return t.narrow(dim, mesh.model * c, c)


@dataclasses.dataclass
class _Entry:
    name: str
    full: torch.Tensor        # the module's tensor (size 0 between steps)
    shape: torch.Size         # its full shape
    dim: int
    shard: torch.Tensor       # this rank's slice (the optimizer's leaf)
    trainable: bool


class Shards:
    """This rank's slices of the sharded tensors of a TrainState
    (shard_state) and the collectives of a tensor-parallel step:
    gather, take_grads, reduce_grads, release, sync_buffers. entries[i]
    .shard is the optimizer's leaf (its .grad and its moments are
    shard-sized); entries[i].full the module's tensor, at size 0 between
    steps."""

    def __init__(self, mesh, specs, entries, replicated, buffers):
        self.mesh, self.specs = mesh, specs
        self.entries = entries
        self.replicated = replicated   # optimizer params held whole
        self.buffers = buffers         # unsharded buffers of the modules

    def full(self, values):
        """Full-size tensors from this rank's slices `values` (one per
        entry, in order: the shards, their gradients or moments) and the
        model group's: an all_reduce (sum) of zero-filled buffers into
        which each rank writes its slice, one per dtype and device."""
        fulls = []
        for e, v in zip(self.entries, values):
            full = v.new_zeros(e.shape)
            _slice(full, e.dim, self.mesh).copy_(v.detach())
            fulls.append(full)
        all_reduce_(fulls, mean=False, group=self.mesh.model_group)
        return fulls

    def gather(self):
        """Every sharded tensor to full size in its module."""
        for e, full in zip(self.entries,
                           self.full([e.shard for e in self.entries])):
            e.full.data = full

    def take_grads(self):
        """After a backward: each sharded parameter's gradient slice into
        its shard's .grad (added to it under accumulation), the full
        gradient dropped."""
        for e in self.entries:
            g = e.full.grad
            if e.trainable and g is not None:
                sl = _slice(g, e.dim, self.mesh)
                if e.shard.grad is None:
                    e.shard.grad = sl.clone(
                        memory_format=torch.contiguous_format)
                else:
                    e.shard.grad.add_(sl)
            e.full.grad = None

    def reduce_grads(self):
        """Before the update: the shards' gradients averaged over the data
        group, the replicated parameters' over every rank."""
        all_reduce_([e.shard.grad for e in self.entries
                     if e.trainable and e.shard.grad is not None],
                    group=self.mesh.data_group)
        all_reduce_([p.grad for p in self.replicated if p.grad is not None])

    def release(self):
        """After the step: a sharded buffer's update into its shard, every
        module tensor back to size 0."""
        with torch.no_grad():
            for e in self.entries:
                if not isinstance(e.full, nn.Parameter) and e.full.numel():
                    e.shard.copy_(_slice(e.full, e.dim, self.mesh))
                e.full.data = e.full.data.new_empty(0)
                e.full.grad = None

    def sync_buffers(self):
        """The unsharded buffers (the BatchNorms' running statistics)
        broadcast from model coordinate 0 over the model group."""
        with torch.no_grad():
            broadcast_(self.buffers, src=self.mesh.data * self.mesh.n_model,
                       group=self.mesh.model_group)


def shard_state(state, mesh, specs=None, **spec_kwargs):
    """Shard a TrainState over make_mesh_2d's mesh per
    param_partition_specs (spec_kwargs: its min_size), in place. The
    state must be equal on every rank, as parallel.replicate leaves it.
    Each rank keeps its model coordinate's slice of every sharded
    tensor; the optimizer is rebuilt over the shards and the replicated
    parameters, with its hyperparameters and its state (each moment
    sliced as its parameter). Returns (state, specs)."""
    if specs is None:
        specs = param_partition_specs(state, mesh, **spec_kwargs)
    owned = _owned(state)
    opt = state.optimizer
    params = {id(p) for g in opt.param_groups for p in g["params"]}
    entries, new_of = [], {}
    with torch.no_grad():
        for name, t in owned.items():
            dim = specs.get(name)
            if dim is None:
                continue
            shard = _slice(t.detach(), dim, mesh).clone(
                memory_format=torch.contiguous_format)
            trainable = id(t) in params
            if trainable:
                shard = nn.Parameter(shard)
                new_of[id(t)] = shard
            entries.append(_Entry(name, t, t.shape, dim, shard, trainable))
    groups = [dict({k: v for k, v in g.items() if k != "params"},
                   params=[new_of.get(id(p), p) for p in g["params"]])
              for g in opt.param_groups]
    new_opt = type(opt)(groups, **opt.defaults)
    for g in opt.param_groups:
        for p in g["params"]:
            old = opt.state.get(p)
            if not old:
                continue
            q = new_of.get(id(p))
            if q is None:
                new_opt.state[p] = old
                continue
            dim = next(e.dim for e in entries if e.full is p)
            new_opt.state[q] = {
                k: (_slice(v, dim, mesh).clone(
                    memory_format=torch.contiguous_format)
                    if torch.is_tensor(v) and v.shape == p.shape else v)
                for k, v in old.items()}
    shard_ids = {id(e.shard) for e in entries}
    replicated = [p for g in new_opt.param_groups for p in g["params"]
                  if id(p) not in shard_ids]
    held = {id(e.full) for e in entries} | {
        id(t) for mod in (state.model, state.disc, state.lpips)
        if mod is not None for t in mod.parameters()}
    buffers = [t for t in owned.values() if id(t) not in held]
    for e in entries:
        e.full.data = e.full.data.new_empty(0)
    state.optimizer = new_opt
    state.shards = Shards(mesh, specs, entries, replicated, buffers)
    return state, specs


def tensor_parallel_step(step_fn, mesh, specs):
    """Wrap a stage-2 step_fn(state, batch, draws=None) -> (state,
    scalars) (training/steps.py::build_s2_step's) for a state that
    shard_state sharded with `specs` over `mesh`: gather the sharded
    tensors, the one-process step on this rank's data block (batch:
    shard_batch's block; draws global, as step_fn takes them), whose
    optimizer updates the shards, release the full-size copies, and
    broadcast the buffers over the model group. Scalars are their means
    over every rank."""

    def step(state, batch, draws=None):
        shards = state.shards
        if shards is None or shards.mesh is not mesh or shards.specs is not (
                specs):
            raise ValueError("tensor_parallel_step: the state was not "
                             "sharded by shard_state(state, mesh, specs)")
        shards.gather()
        try:
            state, sc = step_fn(state, batch, draws=draws)
        finally:
            shards.release()
        shards.sync_buffers()
        return state, sc

    return step
