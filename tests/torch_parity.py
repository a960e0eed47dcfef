"""Helpers for the parity tests of the PyTorch port (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both sides; the JAX
package runs on XLA:CPU, the port on torch CPU. Torch is kept to a few
threads: the suite runs under several xdist workers.
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
    key map and transforms."""
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
