"""Data parallelism over torch.distributed (port of umr_tpu/parallel/
mesh.py's data-parallel half: make_mesh, shard_batch, replicate).

In the JAX package one jitted step sees the global batch, sharded on the
mesh's "data" axis, and GSPMD inserts the gradient psum; every loss mean
and every train-mode BatchNorm spans the global batch. Here each rank is
a process with the model on its own device and its block of the global
batch, and the same math is made explicit:
  * the BatchNorms normalise over the global batch (models/net_blocks.py);
  * the step averages its gradients and its scalars over the ranks
    (training/steps.py); every loss of both stages is a per-sample mean,
    so the mean of equal shards' losses is the global batch's loss;
  * elementwise random draws are made at the global shape from the
    generator every rank holds, each rank taking its block (rank_block),
    so they equal one process's draws; the camera hypothesis, drawn from
    the rank's own probabilities, comes from a stream of the rank's own
    (rank_generator). Every rank's generator ends a step in one state.

Only all_reduce and broadcast are used: they are the collectives gloo
runs on CUDA tensors, so one code path serves NCCL across cards, gloo on
the CPU, and gloo between ranks that share one card (NCCL refuses that).

make_mesh_2d lays the group out as JAX's ("data", "model") mesh for
tensor parallelism (parallel/tensor.py): rank r at data coordinate
r // n_model and model coordinate r % n_model. Under it the ranks of one
model group hold one data block, so shard_batch, rank_block,
rank_generator and the BatchNorms follow the data coordinate and the
data axis's size (data_rank_and_size, data_group); without it they
follow the rank and the world size, as before.

The group is the process's default torch.distributed group. make_mesh
joins it: from torchrun's environment (RANK, WORLD_SIZE, LOCAL_RANK,
LOCAL_WORLD_SIZE, MASTER_ADDR/MASTER_PORT) or from explicit arguments.
spawn runs a function on N local ranks; launch is the entry points'
rule: under torchrun join its group, else with N > 1 visible cards spawn
one rank per card, else run in this process. One visible card, or
data_parallel off, is the single-process path on purpose, with no group:
there every helper here is the identity and the step is the one-process
step, draw for draw. A group that fails to form raises, and so does a
launch whose rank fails; nothing falls back to one process.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import pickle
import queue
import socket
import traceback

import torch
import torch.distributed as dist


def rank_and_size():
    """(rank, world size) of the default group, or (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def world_size():
    return rank_and_size()[1]


@dataclasses.dataclass(frozen=True)
class Mesh2D:
    """The default group as a (n_data, n_model) mesh (make_mesh_2d): this
    rank's coordinates, the group of the ranks that share its model
    coordinate (data_group: the batch's blocks, over which gradients of
    a weight's shard average) and of those that share its data
    coordinate (model_group: a weight's shards)."""
    n_data: int
    n_model: int
    data: int
    model: int
    data_group: object
    model_group: object
    world: object

    @property
    def shape(self):
        return {"data": self.n_data, "model": self.n_model}


_MESH = None


def current_mesh():
    """The Mesh2D that make_mesh_2d made on the current default group, or
    None."""
    if (_MESH is not None and dist.is_available() and dist.is_initialized()
            and _MESH.world is dist.group.WORLD):
        return _MESH
    return None


def data_rank_and_size():
    """(data coordinate, data axis size) under make_mesh_2d; else
    rank_and_size()."""
    m = current_mesh()
    return rank_and_size() if m is None else (m.data, m.n_data)


def data_group():
    """The ranks a batch reduction spans: make_mesh_2d's data group, or
    None (the default group)."""
    m = current_mesh()
    return None if m is None else m.data_group


def make_mesh_2d(n_data, n_model):
    """Lay the default group out as a (n_data, n_model) mesh: the group
    this process is in, else the one make_mesh joins from torchrun's
    environment. Rank r sits at data
    coordinate r // n_model and model coordinate r % n_model, as
    np.array(devices).reshape(n_data, n_model) places JAX's devices.
    Every rank creates every subgroup, in one order. A world size other
    than n_data * n_model raises, as does a subgroup that fails to form.
    Returns the Mesh2D, which the rank helpers follow from then on."""
    global _MESH
    if not (dist.is_available() and dist.is_initialized()):
        make_mesh()
    rank, size = dist.get_rank(), dist.get_world_size()
    if size != n_data * n_model:
        raise ValueError(f"make_mesh_2d({n_data}, {n_model}) needs "
                         f"{n_data * n_model} ranks, the group has {size}")
    d, m = divmod(rank, n_model)
    data_groups = [dist.new_group([j * n_model + i for j in range(n_data)])
                   for i in range(n_model)]
    model_groups = [dist.new_group([j * n_model + i for i in range(n_model)])
                    for j in range(n_data)]
    _MESH = Mesh2D(n_data, n_model, d, m, data_groups[m], model_groups[d],
                   dist.group.WORLD)
    return _MESH


def is_writer():
    """Rank 0 (or the only process) writes the run's files and prints."""
    return rank_and_size()[0] == 0


def make_mesh(rank=None, size=None, init_method=None, device=None):
    """Join the default group as `rank` of `size` (from the environment
    torchrun sets where not given). device: "cuda" (the default; the
    rank's card is cuda:{LOCAL_RANK}, modulo the visible cards when
    ranks share them) or "cpu". The backend is NCCL when each rank has a
    card of its own, gloo on the CPU or when ranks share a card."""
    env = os.environ
    rank = int(env["RANK"]) if rank is None else rank
    size = int(env["WORLD_SIZE"]) if size is None else size
    local_rank = int(env.get("LOCAL_RANK", rank))
    local_size = int(env.get("LOCAL_WORLD_SIZE", size))
    backend = "gloo"
    if torch.device(device or "cuda").type == "cuda":
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("make_mesh: no CUDA device is visible; pass "
                               "device='cpu' for ranks on the CPU")
        torch.cuda.set_device(torch.device("cuda", local_rank % n))
        if local_size <= n:
            backend = "nccl"
    dist.init_process_group(backend, init_method=init_method or "env://",
                            rank=rank, world_size=size)


def shard_batch(batch):
    """This rank's contiguous block of every entry of a global batch dict
    (numpy arrays, tensors or lists, on their leading axis), as
    NamedSharding(P("data")) places it: the block of its data coordinate
    (data_rank_and_size). Raises where the data axis does not divide an
    entry's length. Without a group the batch is returned as it is."""
    rank, size = data_rank_and_size()
    if size == 1:
        return batch
    out = {}
    for k, v in batch.items():
        if len(v) % size:
            raise ValueError(f"shard_batch: {k} has {len(v)} rows, which "
                             f"{size} data ranks do not divide")
        b = len(v) // size
        out[k] = v[rank * b:(rank + 1) * b]
    return out


def rank_block(draw, n):
    """draw(m) -> m rows of random draws; returns this rank's block of n
    rows of draw(n * world size), the draws one process makes for the
    global batch (rank and size: data_rank_and_size). Without a group:
    draw(n)."""
    rank, size = data_rank_and_size()
    if size == 1:
        return draw(n)
    return draw(n * size)[rank * n:(rank + 1) * n]


def rank_generator(generator):
    """A generator of this rank's own, seeded from `generator`'s state
    and the rank, for draws that depend on the rank's own data (the
    camera hypothesis); `generator` is not advanced. The ranks of one
    model group (make_mesh_2d) share the stream of their data coordinate.
    Without a group: `generator` itself."""
    rank, size = data_rank_and_size()
    if size == 1 or generator is None:
        return generator
    h = hashlib.sha256(generator.get_state().numpy().tobytes())
    h.update(rank.to_bytes(4, "little"))
    return torch.Generator(generator.device).manual_seed(
        int.from_bytes(h.digest()[:8], "little") >> 1)


def _comm_device():
    """Where a collective's own buffers live: the rank's card under NCCL,
    else the CPU."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _flat_groups(tensors):
    """The tensors grouped by (dtype, device), each group with its flat
    concatenation on a device the backend takes (NCCL: the card; gloo
    takes CPU and CUDA tensors as they are)."""
    groups = {}
    for t in tensors:
        groups.setdefault((t.dtype, t.device), []).append(t)
    nccl = dist.get_backend() == "nccl"
    out = []
    for ts in groups.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        if nccl and flat.device.type != "cuda":
            flat = flat.to(_comm_device())
        out.append((ts, flat))
    return out


def _unflatten(ts, flat):
    off = 0
    for t in ts:
        n = t.numel()
        t.copy_(flat[off:off + n].view_as(t))
        off += n


def all_reduce_(tensors, mean=True, group=None):
    """Sum (mean=False) or mean the tensors over the ranks of `group` (the
    default group if None), in place, with one all_reduce per dtype and
    device. Without a group, or in a group of one: nothing."""
    size = (world_size() if group is None or not dist.is_initialized()
            else dist.get_world_size(group))
    tensors = list(tensors)
    if size == 1 or not tensors:
        return tensors
    for ts, flat in _flat_groups(tensors):
        dist.all_reduce(flat, group=group)
        if mean:
            flat.div_(size)
        _unflatten(ts, flat)
    return tensors


def broadcast_(tensors, src=0, group=None):
    """Copy (global) rank src's values into the tensors of every rank of
    `group` (the default group if None), in place, one broadcast per
    dtype and device. Without a group, or in a group of one: nothing."""
    size = (world_size() if group is None or not dist.is_initialized()
            else dist.get_world_size(group))
    if size == 1:
        return
    for ts, flat in _flat_groups(tensors):
        dist.broadcast(flat, src, group=group)
        _unflatten(ts, flat)


def barrier():
    """Every rank waits here for the others: an all_reduce of one value
    (gloo has no barrier on CUDA tensors, NCCL's needs the device)."""
    if world_size() > 1:
        dist.all_reduce(torch.zeros(1, device=_comm_device()))


def _state_tensors(state):
    """Every tensor a TrainState's ranks must agree on: the parameters and
    buffers of the model, the discriminator and LPIPS, the optimizer's
    state, the generator's state and the step counts."""
    out = []
    for mod in (state.model, state.disc, state.lpips):
        out += list(mod.state_dict(keep_vars=True).values())
    for per_param in state.optimizer.state.values():
        out += [v for v in per_param.values() if torch.is_tensor(v)]
    return [t.data if isinstance(t, torch.nn.Parameter) else t for t in out]


def replicate(state):
    """Broadcast rank 0's training state (training/steps.py::TrainState:
    weights, buffers, optimizer state, generator, step and update counts)
    to every rank, in place, so that ranks start equal whatever their
    seeds. Without a group: nothing."""
    if world_size() == 1:
        return state
    with torch.no_grad():
        broadcast_(_state_tensors(state))
    gen = state.generator.get_state()
    counts = torch.tensor([state.step, state.updates], dtype=torch.int64)
    broadcast_([gen, counts])
    state.generator.set_state(gen)
    state.step, state.updates = (int(v) for v in counts)
    return state


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank, size, init_method, device, args, results):
    """A spawned rank: the torchrun environment, the group, fn(*args); its
    pickled result (or its traceback) goes to the parent through
    `results`."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(size),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(size))
    try:
        make_mesh(rank, size, init_method, device)
        out = pickle.dumps(fn(*args))
    except BaseException:  # noqa: BLE001 — reported, then exit 1
        results.put((rank, False, traceback.format_exc()))
        results.close()
        results.join_thread()
        os._exit(1)
    results.put((rank, True, out))
    dist.destroy_process_group()


def spawn(fn, nprocs, *args, device=None, init_method=None):
    """Run fn(*args) on ranks 0..nprocs-1, each a fresh process (the spawn
    context) in one group (make_mesh's device and backend rules; a local
    tcp:// rendezvous unless init_method is given, e.g. file://...).
    fn must be importable and its result picklable; returns the ranks'
    results in rank order. A rank that raises, dies or ends without a
    result stops the others and raises RuntimeError with its traceback
    or exit code."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    init_method = init_method or f"tcp://localhost:{_free_port()}"
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, args=(
        fn, r, nprocs, init_method, device, args, results))
        for r in range(nprocs)]
    for p in procs:
        p.start()
    got, failure = {}, None
    try:
        while len(got) < nprocs and failure is None:
            try:
                rank, ok, out = results.get(timeout=0.5)
            except queue.Empty:
                # a rank's result is in the pipe before its process ends
                ended = [(r, p.exitcode) for r, p in enumerate(procs)
                         if r not in got and p.exitcode is not None]
                if ended and results.empty():
                    failure = (f"rank {ended[0][0]} ended (exit code "
                               f"{ended[0][1]}) without a result")
                continue
            if ok:
                got[rank] = pickle.loads(out)
            else:
                failure = f"rank {rank} failed:\n{out}"
    except BaseException:
        failure = "interrupted"
        raise
    finally:
        for p in procs:
            if failure is None:
                p.join(60)
            if p.is_alive():
                p.terminate()
                p.join(10)
    if failure is None:
        bad = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode]
        if bad:
            failure = (f"rank {bad[0][0]} exited with code {bad[0][1]} "
                       "(negative: killed by that signal, or stopped here "
                       "after 60 s)")
    if failure is not None:
        raise RuntimeError(f"spawn({getattr(fn, '__name__', fn)}, "
                           f"{nprocs}): {failure}")
    return [got[r] for r in range(nprocs)]


def _call(fn, *args):
    fn(*args)


def launch(fn, *args, data_parallel=True):
    """The training entry points' rule: fn(*args) on every rank. Under
    torchrun (RANK in the environment) this process joins its group; with
    data_parallel and N > 1 visible cards it spawns one rank per card;
    otherwise it runs fn here, with no group. data_parallel off under a
    torchrun of several processes raises: each would train alone on the
    same card and write the same files."""
    if not data_parallel and int(os.environ.get("WORLD_SIZE", "1")) > 1:
        raise ValueError(
            "--nodata_parallel under torchrun with WORLD_SIZE="
            f"{os.environ['WORLD_SIZE']}: run one process without torchrun")
    if data_parallel and "RANK" in os.environ:
        make_mesh()
        try:
            fn(*args)
        finally:
            dist.destroy_process_group()
    elif data_parallel and torch.cuda.device_count() > 1:
        spawn(_call, torch.cuda.device_count(), fn, *args)
    else:
        fn(*args)

