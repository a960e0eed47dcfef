"""Helpers for the parity tests of the PyTorch port (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both sides; the JAX
package runs on XLA:CPU, the port on torch CPU. Torch is kept to a few
threads: the suite runs under several xdist workers.
"""

from __future__ import annotations

import numpy as np
import torch

from torch_ranks import grads_of, np_of  # noqa: F401 — np_of for the tests

torch.set_num_threads(2)


def t_of(x):
    return torch.as_tensor(np.asarray(x))


def flatten(tree, prefix=""):
    """A nested dict -> {'a/b/c': leaf}, as checkpoints.save_pth writes."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten(v, f"{prefix}{k}/"))
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def assert_close_except_slivers(actual, desired, atol, frac, cap):
    """Renders of meshes at the renderer's sigma (1e-5): values agree to
    `atol` except at most `frac` of them, which stay within `cap`.

    At silhouettes a sphere shows sliver faces (|det| ~ 1e-4) whose
    barycentrics are large; the foot-point distance cancels them, and
    sigmoid(d / 1e-5) turns last-ulp differences into alpha differences of
    ~1e-3 to ~1e-2 at a handful of pixels. Each caller states the
    readings its limits were set from."""
    diff = np.abs(np.asarray(actual, np.float64) - np.asarray(desired))
    over = diff > atol
    assert over.mean() <= frac, (over.sum(), over.size, diff.max())
    assert diff.max() <= cap, diff.max()


def random_scene(rng, B=2, F=6, T2=16, z0=7.0, spread=0.9):
    """Random projected triangles [B,F,3,3] and texel sheets [B,F,T2,3]."""
    faces = np.zeros((B, F, 3, 3), dtype=np.float32)
    faces[..., :2] = rng.uniform(-spread, spread, size=(B, F, 3, 2))
    faces[..., 2] = z0 + rng.uniform(-1.0, 1.0, size=(B, F, 3))
    tex = rng.uniform(0.0, 1.0, size=(B, F, T2, 3)).astype(np.float32)
    return faces, tex


SMALL = dict(image_size=64, subdivide=2, tex_size=2, num_hypo_cams=2,
             nz_feat=32, z_dim=24)


def jax_meshnet(template, image_size, nz_feat, z_dim, num_hypo_cams,
                seed=0):
    """The JAX package's MeshNet-s2 and its variables, filled from a seeded
    port model with randomised BatchNorm affines and statistics and mean_v
    (so eval mode exercises them) through the JAX package's key map and
    transforms. flax's init would run op by op, ~20 s on the CPU.
    Returns (model, variables)."""
    from umr_tpu.models import MeshNet as JaxMeshNet
    from umr_tpu_torch.models import MeshNet, init_weights

    model = init_weights(
        MeshNet(template, input_size=image_size, nz_feat=nz_feat, z_dim=z_dim,
                num_hypo_cams=num_hypo_cams),
        torch.Generator().manual_seed(seed))
    rng = np.random.RandomState(seed)

    def rand(fn, *args):
        return torch.as_tensor(fn(*args).astype(np.float32))

    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (torch.nn.BatchNorm1d, torch.nn.BatchNorm2d)):
                n = mod.num_features
                mod.weight.copy_(rand(rng.uniform, 0.5, 1.5, n))
                mod.bias.copy_(rand(rng.normal, 0.0, 0.1, n))
                mod.running_mean.copy_(rand(rng.normal, 0.0, 0.1, n))
                mod.running_var.copy_(rand(rng.uniform, 0.5, 2.0, n))
        model.mean_v.add_(rand(rng.normal, 0.0, 0.05, model.mean_v.shape))
    jmodel = JaxMeshNet(template=template, nz_feat=nz_feat, z_dim=z_dim,
                        num_hypo_cams=num_hypo_cams)
    return jmodel, flax_variables(model, template, num_hypo_cams)


def flax_variables(model, template, num_hypo_cams, stage=2):
    """A port MeshNet's (MeshNetS1's, stage=1) weights, BN statistics,
    buffers and mean_v as the JAX package's model variables, through its
    key map and transforms. An untextured model has no keys for the
    texture predictor: its rows are skipped."""
    from umr_tpu.models.reference_io import _apply_transform, build_key_map

    # copies: a view would follow the model's in-place updates
    sd = {k: v.detach().cpu().numpy().copy()
          for k, v in model.state_dict().items()}
    n_up = min(5, int(np.log2(template.uv_image_size()[0])))
    pm, sm, bm, tm = build_key_map(stage, num_hypo_cams, n_up)
    variables = {"buffers": {}}
    for coll, maps in (("params", pm), ("batch_stats", sm),
                       ("buffers", bm), ("template", tm)):
        for path, tkey, tf in maps:
            if tkey not in sd:
                continue
            node = variables.setdefault(coll, {})
            for part in path[:-1]:
                node = node.setdefault(part, {})
            node[path[-1]] = _apply_transform(sd[tkey], tf, to_flax=True)
    return variables


def flax_flat(variables):
    """What checkpoints.save_pth writes: params, BN stats and mean_v under
    their flax paths."""
    flat = flatten(variables["params"])
    flat.update(flatten(variables["batch_stats"]))
    flat["mean_v"] = np.asarray(variables["template"]["mean_v"])
    return flat


def injected_draws(out):
    """The JAX forward's random draws, recovered from its outputs:
    (VAE eps, camera hypothesis indices)."""
    mean, logvar = np.asarray(out["mean"]), np.asarray(out["logvar"])
    eps = (np.asarray(out["noise"]) - mean) * np.exp(-0.5 * logvar)
    return (torch.as_tensor(eps.astype(np.float32)),
            torch.as_tensor(np.array(out["cam_sample_inds"])))


def flat_tree(tree, prefix=""):
    """A nested dict of leaves -> {'a/b/c': leaf} (leaves kept as they are)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_tree(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def params_of(state):
    """{'model.<name>' / 'disc.<name>': a copy} of a port TrainState's
    trainable parameters."""
    return {f"{p}.{n}": t.detach().clone()
            for p, mod in (("model", state.model), ("disc", state.disc))
            for n, t in mod.named_parameters()}


def cosine(a, b):
    """Cosine of two gradient dicts flattened (a's keys, float64)."""
    x = np.concatenate([v.ravel() for v in a.values()]).astype(np.float64)
    y = np.concatenate([b[k].ravel() for k in a]).astype(np.float64)
    return float(x @ y / (np.linalg.norm(x) * np.linalg.norm(y)))


def part_semantic(template):
    """A seeded UV part-label map [16,32] and head, belly, neck, back
    vertex index sets (tests/test_torch_train.py's)."""
    rng = np.random.RandomState(5)
    seg = rng.randint(0, 5, size=(16, 32)).astype(np.float32)
    idx = rng.permutation(template.num_verts)
    return seg, [idx[0:20], idx[20:60], idx[60:80], idx[80:120]]


def _jax_grads_torch_layout(jgrads, names, stage, num_cams, n_up):
    """JAX gradients {'model/<flax path>' | 'disc/...': array} -> the
    port's parameter names and layouts, through the JAX package's key
    map (the discriminator's fixed names beside it)."""
    from umr_tpu.models.reference_io import _apply_transform, build_key_map

    pm, _, _, _ = build_key_map(stage, num_cams, n_up)
    where = {f"model.{tkey}": ("model/" + "/".join(path), tf)
             for path, tkey, tf in pm}
    disc = {"convs.0": "Conv_0", "convs.1": "Conv_1", "convs.2": "Conv_2",
            "convs.3": "Conv_3", "head": "Conv_4"}
    for t, f in disc.items():
        where[f"disc.{t}.weight"] = (f"disc/{f}/kernel", "conv")
        where[f"disc.{t}.bias"] = (f"disc/{f}/bias", "copy")
    where["disc.fc.weight"] = ("disc/Dense_0/kernel", "linear")
    where["disc.fc.bias"] = ("disc/Dense_0/bias", "copy")
    return {k: _apply_transform(jgrads[where[k][0]], where[k][1],
                                to_flax=False) for k in names}


def step_parity(stage, kw, jax_kw, lr, B=4, image_size=32, impl="auto",
                mesh=None, on_inputs=None, tp_min_size=1 << 12):
    """One training step of the port (stage 1 or 2, Config(**kw)) and of
    the JAX package's (Config(**kw, **jax_kw)) on the same weights (the
    port's seeded init carried to flax; the discriminator's flax init
    carried back; LPIPS from the committed npz), the same synthetic
    batch and the JAX step's random draws injected, one SGD step at
    learning rate lr on both sides. Stage 1 runs at epoch 0, from a
    template moved off its init. Returns dict(port_sc, port_grads,
    jax_sc, jax_grads) with the gradients as (p0 - p1) / lr under the
    port's parameter names and layouts.

    mesh=n runs the JAX step as umr_tpu.parallel.data_parallel_step over
    an n-device mesh (the batch sharded, the state replicated), and adds
    the one-process port step's own gradients (port_grad: p.grad after
    the step); mesh=(n_data, n_model) runs it as tensor_parallel_step
    over make_mesh_2d(n_data, n_model) with shard_state(min_size=
    tp_min_size), the batch sharded over "data". on_inputs, given, is called before either step runs with
    what a port step on ranks needs (rank_steps): init (the port's
    weights), db (the prepared global batch) and draws (global, numpy)."""
    import os

    import jax
    import jax.numpy as jnp

    from umr_tpu.config import Config as JaxConfig
    from umr_tpu.losses.composite import PartMatchingLoss as JaxPartLoss
    from umr_tpu.mesh import build_template as jax_template
    from umr_tpu.models.weight_io import load_lpips_params
    from umr_tpu.renderer import SoftRenderer as JaxRenderer
    from umr_tpu.training import steps as jsteps
    from umr_tpu_torch.config import Config
    from umr_tpu_torch.data import synthetic_batch
    from umr_tpu_torch.losses.composite import PartMatchingLoss
    from umr_tpu_torch.mesh import build_template
    from umr_tpu_torch.models.weights import (WEIGHTS_DIR,
                                              discriminator_state_from_flax)
    from umr_tpu_torch.renderer import SoftRenderer
    from umr_tpu_torch.training import steps as tsteps
    from umr_tpu_torch.training.trainer import prepare_batch

    cfg = Config(**kw)
    jcfg = JaxConfig(**kw, **jax_kw)
    template, jt = build_template(2, 1, 2), jax_template(2, 1, 2)
    batch = synthetic_batch(np.random.RandomState(3), B, image_size)
    db = prepare_batch(batch, cfg.use_scops, cfg.use_texture)
    jbatch = {k: jnp.asarray(v) for k, v in db.items()}
    common = dict(image_size=image_size, anti_aliasing=False,
                  ambient_intensity=1.0, directional_intensity=0.0)
    if stage == 2:
        seg, pvi = part_semantic(template)
        pl = PartMatchingLoss.build(
            seg, template.uv_sampler, template.num_sym_faces,
            SoftRenderer(impl=impl, **common), tex_size=2)
        _, _, _, init_fn, step_fn = tsteps.build_s2_step(
            cfg, template, pl, pvi, "cpu", impl=impl)
        jpl = JaxPartLoss.build(
            seg, jt.uv_sampler, jt.num_sym_faces,
            JaxRenderer(**common, face_chunk=jax_kw.get(
                "face_chunk", cfg.face_chunk), pixel_rows_per_block=jax_kw[
                    "pixel_rows_per_block"]), tex_size=2)
        jmodel, jdisc, _, _, jstep = jsteps.build_s2_step(jcfg, jt, jpl, pvi)
        num_cams = cfg.num_hypo_cams
        if isinstance(mesh, int):
            from umr_tpu.parallel import data_parallel_step, make_mesh
            jstep = data_parallel_step(jstep, make_mesh(mesh))
    else:
        _, _, _, init_fn, step_fn, _, _ = tsteps.build_s1_step(
            cfg, template, "cpu", impl=impl)
        jmodel, jdisc, _, _, jstep, _, _ = jsteps.build_s1_step(jcfg, jt)
        num_cams = 0
    state = init_fn(0)
    if stage == 1:
        with torch.no_grad():      # a template away from the init's
            state.model.mean_v.add_(torch.as_tensor(
                np.random.RandomState(8).normal(
                    0.0, 0.05, state.model.mean_v.shape).astype(np.float32)))
    variables = flax_variables(state.model, template, num_cams, stage)
    dparams = jdisc.init(jax.random.key(9), jnp.zeros(
        (2, image_size, image_size, 3 if stage == 2 else 1)))["params"]
    state.disc.load_state_dict(discriminator_state_from_flax(dparams))
    params = {"model": variables["params"], "disc": dparams}
    jstate = jsteps.TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats={"model": variables["batch_stats"]},
        buffers=variables["buffers"], template=variables["template"],
        opt_state=jsteps.make_optimizer(jcfg).init(params),
        lpips=load_lpips_params(os.path.join(WEIGHTS_DIR, "lpips_alex.npz")))
    key = jax.random.key(1)

    # the JAX step's draws: its key split as loss_fn splits it, the
    # forward jitted as in the step (op by op it takes ~20 s here)
    k_sample, k_gan = jax.random.split(key)
    out, _ = jax.jit(lambda v, x, k: jmodel.apply(
        v, x, train=True, rngs={"sample": k}, mutable=["batch_stats"]))(
        {**variables, "params": params["model"]}, jbatch["input_img"],
        k_sample)
    mean, logvar = np.asarray(out["mean"]), np.asarray(out["logvar"])
    noise = np.asarray(out["noise" if stage == 2 else "feat"])
    draws = {"eps": torch.as_tensor(
        ((noise - mean) * np.exp(-0.5 * logvar)).astype(np.float32))}
    if stage == 2:
        draws["sample_inds"] = torch.as_tensor(
            np.array(out["cam_sample_inds"]))
    if cfg.use_gan:
        draws["angles"] = torch.as_tensor(np.array(
            jax.random.randint(k_gan, (B,), 0, 180)))

    init = {"model": {k: v.clone() for k, v in
                      state.model.state_dict().items()},
            "disc": {k: v.clone() for k, v in state.disc.state_dict().items()}}
    if on_inputs is not None:
        on_inputs(dict(init=init, db=db,
                       draws={k: np_of(v) for k, v in draws.items()}))
    args = (jnp.float32(0.0),) if stage == 1 else ()
    if isinstance(mesh, tuple):
        from umr_tpu.parallel import (make_mesh_2d, shard_batch, shard_state,
                                      tensor_parallel_step)
        mesh2d = make_mesh_2d(*mesh)
        jstate, jspecs = shard_state(jstate, mesh2d, min_size=tp_min_size)
        jstep = tensor_parallel_step(jstep, mesh2d, jspecs)
        jbatch = shard_batch(jbatch, mesh2d)
    jstate1, jsc = jstep(jstate, jbatch, key, *args)

    p0 = params_of(state)
    step_args = (0.0,) if stage == 1 else ()
    state, sc = step_fn(state, db, *step_args, draws=draws)
    p1 = params_of(state)
    port_grads = {k: np_of((p0[k] - p1[k]) / lr) for k in p0}
    jgrads = {}
    for pre in ("model", "disc"):
        after = flat_tree(jstate1.params[pre])
        for k, v in flat_tree(jstate.params[pre]).items():
            jgrads[f"{pre}/{k}"] = (np.asarray(v) - np.asarray(after[k])) / lr
    n_up = min(5, int(np.log2(template.uv_image_size()[0])))
    out = dict(port_sc={k: float(v) for k, v in sc.items()},
               port_grads=port_grads,
               jax_sc={k: float(v) for k, v in jsc.items()},
               jax_grads=_jax_grads_torch_layout(
                   jgrads, port_grads, stage, num_cams, n_up))
    if mesh:
        out["port_grad"] = grads_of(state)
    return out


def grads_close(g, jg, rel, cos):
    """Per tensor ||g - g_jax|| <= rel ||g_jax|| + 1e-6 x the norm of all
    gradients, and the cosine of all gradients >= cos; returns the
    readings (worst per-tensor ratio, cosine)."""
    total = np.sqrt(sum(np.sum(v.astype(np.float64) ** 2)
                        for v in jg.values()))
    assert total > 0
    worst = 0.0
    for k in g:
        err = np.linalg.norm(g[k] - jg[k])
        worst = max(worst, err / (np.linalg.norm(jg[k]) + 1e-30))
        assert err <= rel * np.linalg.norm(jg[k]) + 1e-6 * total, k
    c = cosine(g, jg)
    assert c >= cos, c
    return worst, c


_TO_TORCH_DIM = {"linear": (1, 0), "conv": (2, 3, 1, 0)}


def meta_s2_state(cfg, template):
    """A port s2 TrainState's modules and Adam at cfg on the meta device:
    the shapes without the memory (Config()'s texture fc is 8192 x
    8192)."""
    from umr_tpu_torch.models import Discriminator, LPIPSAlex, MeshNet
    from umr_tpu_torch.training import steps as tsteps

    with torch.device("meta"):
        model = MeshNet(template, input_size=cfg.image_size,
                        nz_feat=cfg.nz_feat, z_dim=cfg.z_dim,
                        num_hypo_cams=cfg.num_hypo_cams)
        disc = Discriminator(in_dim=3, img_size=cfg.image_size)
        lpips = LPIPSAlex()
        opt = tsteps.make_optimizer(cfg, list(model.parameters())
                                    + list(disc.parameters()))
    return tsteps.TrainState(step=0, updates=0, model=model, disc=disc,
                             lpips=lpips, optimizer=opt, generator=None)


def jax_partition_specs(state, template, num_cams, min_size, n_model=2,
                        shapes_only=False):
    """The JAX package's param_partition_specs (umr_tpu.parallel, over a
    make_mesh_2d(n, n_model) mesh) on its s2 TrainState carrying a port
    TrainState's model (flax_variables; shapes_only: the same leaves as
    jax.ShapeDtypeStruct, for a model on the meta device), discriminator
    and LPIPS (the port's, in the flax layout), with optax's Adam state
    on the parameters (the Config's optimizer, jax.eval_shape of its
    init). Returns ({port name: torch dimension} of every leaf it
    shards, the port names of every leaf but the step and Adam's
    count): 'model.<key>', 'disc.<key>', 'lpips.<key>' and '<param
    name>:exp_avg' / ':exp_avg_sq' for optax's mu / nu, as
    umr_tpu_torch.parallel.param_partition_specs names them."""
    import jax
    import jax.numpy as jnp

    from umr_tpu.config import Config as JaxConfig
    from umr_tpu.parallel import make_mesh_2d, param_partition_specs
    from umr_tpu.models.reference_io import _apply_transform, build_key_map
    from umr_tpu.training import steps as jsteps

    n_up = min(5, int(np.log2(template.uv_image_size()[0])))
    maps = build_key_map(2, num_cams, n_up)
    where = {}                      # flax path -> (port name, transform)

    def leaf(t, tf):
        shape = tuple(t.shape)
        if tf == "linear":
            shape = shape[::-1]
        elif tf == "conv":
            shape = tuple(shape[i] for i in (2, 3, 1, 0))
        if shapes_only:
            return jax.ShapeDtypeStruct(shape, jnp.float32)
        return _apply_transform(np_of(t), tf, to_flax=True)

    def put(tree, path, value):
        for p in path[:-1]:
            tree = tree.setdefault(p, {})
        tree[path[-1]] = value

    sd = state.model.state_dict()
    if shapes_only:
        variables = {"buffers": {}}
        for coll, m in zip(("params", "batch_stats", "buffers", "template"),
                           maps):
            for path, tkey, tf in m:
                put(variables.setdefault(coll, {}), path,
                    leaf(sd[tkey], tf))
    else:
        variables = flax_variables(state.model, template, num_cams)
    for coll, m in zip(("params/model", "batch_stats/model", "buffers",
                        "template"), maps):
        for path, tkey, tf in m:
            where[coll + "/" + "/".join(path)] = (f"model.{tkey}", tf)
    disc, dsd = {}, state.disc.state_dict()
    for i, t in enumerate(["convs.0", "convs.1", "convs.2", "convs.3",
                           "head"]):
        put(disc, (f"Conv_{i}", "kernel"), leaf(dsd[f"{t}.weight"], "conv"))
        put(disc, (f"Conv_{i}", "bias"), leaf(dsd[f"{t}.bias"], "copy"))
        where[f"params/disc/Conv_{i}/kernel"] = (f"disc.{t}.weight", "conv")
        where[f"params/disc/Conv_{i}/bias"] = (f"disc.{t}.bias", "copy")
    put(disc, ("Dense_0", "kernel"), leaf(dsd["fc.weight"], "linear"))
    put(disc, ("Dense_0", "bias"), leaf(dsd["fc.bias"], "copy"))
    where["params/disc/Dense_0/kernel"] = ("disc.fc.weight", "linear")
    where["params/disc/Dense_0/bias"] = ("disc.fc.bias", "copy")
    lpips, lsd = {}, state.lpips.state_dict()
    for i in range(5):
        for k, tf, part in (("weight", "conv", "kernel"),
                            ("bias", "copy", "bias")):
            put(lpips, (f"conv{i}", part), leaf(lsd[f"convs.{i}.{k}"], tf))
            where[f"lpips/alex/conv{i}/{part}"] = (f"lpips.convs.{i}.{k}",
                                                   tf)
    for path in list(where):
        for pre, moment in (("params/", "mu"), ("params/", "nu")):
            if path.startswith(pre):
                name, tf = where[path]
                suffix = "exp_avg" if moment == "mu" else "exp_avg_sq"
                where[f"{moment}/{path[len(pre):]}"] = (f"{name}:{suffix}",
                                                        tf)
    params = {"model": variables["params"], "disc": disc}
    jcfg = JaxConfig()
    jstate = jsteps.TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats={"model": variables["batch_stats"]},
        buffers=variables["buffers"], template=variables["template"],
        opt_state=jax.eval_shape(jsteps.make_optimizer(jcfg).init, params),
        lpips={"alex": lpips})
    specs = param_partition_specs(jstate, make_mesh_2d(
        len(jax.devices()) // n_model, n_model), min_size=min_size)
    sharded, names = {}, set()
    for path, spec in jax.tree_util.tree_flatten_with_path(specs)[0]:
        keys = [str(getattr(k, "key", getattr(k, "name", getattr(
            k, "idx", k)))) for k in path]
        if keys[0] == "opt_state":      # (ScaleByAdamState, ...)[0].mu/nu
            keys = keys[2:]
        key = "/".join(keys)
        if key in ("step", "count"):
            assert "model" not in tuple(spec), key
            continue
        name, tf = where[key]
        names.add(name)
        if "model" in tuple(spec):
            d = tuple(spec).index("model")
            sharded[name] = _TO_TORCH_DIM.get(tf, range(8))[d]
    return sharded, names
