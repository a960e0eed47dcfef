"""Weights into and out of the port: flax-path-flattened arrays (what
the JAX package's checkpoints.save_pth writes, and the committed ResNet-18
and LPIPS npz files) mapped to and from torch state_dict keys through
models/reference_io.py. Ports umr_tpu/models/weight_io.py (the npz
readers and writers, overlay_tree, load_resnet18_pretrained) and
umr_tpu/training/checkpoints.py::load_pth.

The pretrained weights' paths follow the JAX package's overrides:
UMR_TPU_RESNET_WEIGHTS names the trunk's params npz (its stats file by
the basename rule of load_resnet18_pretrained), UMR_TPU_LPIPS_WEIGHTS the
LPIPS npz; by default the committed files in weights/.
"""

from __future__ import annotations

import os
import warnings

import numpy as np
import torch

from .reference_io import (T_CONV, build_key_map, resnet_maps,
                           to_flax_layout, to_torch_layout)

# the committed weights: ResNet-18 trunk, LPIPS AlexNet
WEIGHTS_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "weights")

# batch-shaped buffers of the reference's checkpoints, not in the port's state
_REFERENCE_ONLY = ("texture_predictor.uv_sampler", "noise")


def _maps(stage=2, num_cams=8, n_upconv=5, **variant):
    pm, sm, bm, tm = build_key_map(stage, num_cams, n_upconv, **variant)
    return pm + sm + bm + tm


def model_variant(model):
    """The key map's arguments for a MeshNet or MeshNetS1: (stage,
    num_cams, variant keywords)."""
    stage = 1 if type(model).__name__ == "MeshNetS1" else 2
    multi = getattr(model, "multiple_cam_hypo", True)
    num_cams = (len(model.cam_predictor.camera_predictor)
                if stage == 2 and multi else 0)
    return stage, num_cams, dict(use_texture=model.use_texture,
                                 multiple_cam_hypo=multi)


def state_dict_from_flax(flat, num_cams=8, n_upconv=5, stage=2, **variant):
    """{'encoder/resnet/conv1/kernel': array, ..., 'mean_v': array} ->
    {torch_key: tensor} for every mapped key of the stage's model
    (MeshNet for 2, MeshNetS1 for 1) in the variant (build_key_map's
    use_texture, multiple_cam_hypo) present in `flat`."""
    sd = {}
    for path, tkey, tf in _maps(stage, num_cams, n_upconv, **variant):
        key = "/".join(path)
        if key in flat:
            arr = to_torch_layout(np.asarray(flat[key], np.float32), tf)
            sd[tkey] = torch.tensor(arr)
    return sd


def save_npz(path, tree):
    """A nested dict of arrays -> one npz, keys joined by '/'."""
    flat = {}

    def rec(prefix, t):
        if isinstance(t, dict):
            for k, v in t.items():
                rec(f"{prefix}{k}/", v)
        else:
            flat[prefix[:-1]] = np.asarray(t)

    rec("", tree)
    np.savez(path, **flat)


def load_npz(path):
    """save_npz's file -> the nested dict."""
    tree = {}
    for key, val in dict(np.load(path)).items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return tree


def overlay_tree(dst, src, path=""):
    """Deep-merge src into a new copy of dst; every src leaf must exist in
    dst with the same shape, and takes dst's dtype."""
    out = dict(dst)
    for k, v in src.items():
        assert k in dst, f"pretrained key {path}{k} not in model tree"
        if isinstance(v, dict):
            out[k] = overlay_tree(dst[k], v, f"{path}{k}/")
        else:
            have, want = tuple(np.shape(dst[k])), tuple(np.shape(v))
            assert have == want, (f"shape mismatch at {path}{k}: model "
                                  f"{have} vs pretrained {want}")
            out[k] = np.asarray(v, dtype=np.asarray(dst[k]).dtype)
    return out


def _tree_set(tree, path, val):
    for p in path[:-1]:
        tree = tree.setdefault(p, {})
    tree[path[-1]] = val


def _tree_get(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def _trunk_maps(prefix):
    """resnet_maps under a torch prefix ("" for torchvision's own keys)."""
    pm, sm = resnet_maps((), prefix)
    return ([(p, k.lstrip("."), tf) for p, k, tf in maps]
            for maps in (pm, sm))


def resnet18_from_torch(sd):
    """A ResNet-18 state_dict with torchvision's keys (the port's
    models/resnet.py::ResNet18, or torchvision's own; `fc.*` ignored) ->
    (params, batch_stats) trees in the flax layout of the JAX package's
    ResNet18Conv, the trees resnet18_params.npz and resnet18_stats.npz
    hold."""
    pm, sm = _trunk_maps("")
    params, stats = {}, {}
    for maps, tree in ((pm, params), (sm, stats)):
        for path, tkey, tf in maps:
            arr = sd[tkey]
            arr = arr.detach().cpu().numpy() if torch.is_tensor(arr) else arr
            # a copy: a view would follow the module's in-place updates
            _tree_set(tree, path, np.array(to_flax_layout(arr, tf)))
    return params, stats


def resnet18_to_torch(params, stats=None, prefix="encoder.resnet_conv.resnet"):
    """The inverse of resnet18_from_torch: state_dict entries under
    `prefix` (the statistics only where `stats` is given)."""
    pm, sm = _trunk_maps(prefix)
    sd = {}
    for maps, tree in ((pm, params), (sm if stats is not None else [],
                                      stats)):
        for path, tkey, tf in maps:
            arr = np.asarray(_tree_get(tree, path), np.float32)
            sd[tkey] = torch.tensor(to_torch_layout(arr, tf))
    return sd


def load_resnet18_npz(params_path, stats_path=None):
    """The committed trunk weights (weights/resnet18_params.npz and its
    *_stats.npz, flax paths without the 'encoder/resnet/' prefix) ->
    state_dict entries under `encoder.resnet_conv.resnet.`."""
    return resnet18_to_torch(
        load_npz(params_path),
        None if stats_path is None else load_npz(stats_path))


def resnet18_stats_path(params_path):
    """The stats file beside a trunk params npz: 'params' -> 'stats' in
    the basename only, so a 'params' elsewhere in the path does not
    redirect the lookup."""
    head, base = os.path.split(params_path)
    return os.path.join(head, base.replace("params", "stats"))


def load_resnet18_pretrained(params_path):
    """The (params, batch_stats) npz pair -> trees; stats None where the
    stats file is absent (the overlay then takes the params only)."""
    stats_path = resnet18_stats_path(params_path)
    stats = (load_npz(stats_path) if stats_path != params_path
             and os.path.exists(stats_path) else None)
    return load_npz(params_path), stats


def overlay_resnet18(model):
    """Land the pretrained trunk (UMR_TPU_RESNET_WEIGHTS, by default the
    committed weights/resnet18_params.npz) on the encoder of a MeshNet or
    MeshNetS1, shape-checked, as the JAX package's maybe_overlay_resnet18.
    Returns the provenance: True where it landed, False (with a warning:
    the trunk stays random-init) where the file is absent."""
    path = os.environ.get("UMR_TPU_RESNET_WEIGHTS", os.path.join(
        WEIGHTS_DIR, "resnet18_params.npz"))
    if not os.path.exists(path):
        warnings.warn(f"pretrained resnet18 trunk weights not found at "
                      f"'{path}': the encoder trunk is RANDOM-INIT (the "
                      "reference's is ImageNet-pretrained). Set "
                      "UMR_TPU_RESNET_WEIGHTS.")
        return False
    pre_params, pre_stats = load_resnet18_pretrained(path)
    trunk = model.encoder.resnet_conv.resnet
    params, stats = resnet18_from_torch(trunk.state_dict())
    params = overlay_tree(params, pre_params, "encoder/resnet/")
    if pre_stats is not None:
        stats = overlay_tree(stats, pre_stats, "encoder/resnet/")
    trunk.load_state_dict(resnet18_to_torch(params, stats, ""),
                          strict=False)
    print(f"encoder trunk: {len(pre_params)} modules from {path} "
          f"({'with' if pre_stats is not None else 'without'} stats)")
    return True


def load_into(model, sd, allow_missing=()):
    """Load a partial state_dict, shape-checked; raise on keys the model
    does not have, and on model keys absent from `sd` unless they match
    an `allow_missing` suffix (BatchNorm's num_batches_tracked always)."""
    own = model.state_dict()
    unknown = sorted(set(sd) - set(own))
    if unknown:
        raise KeyError(f"keys not in the model: {unknown[:5]}")
    for k, v in sd.items():
        if tuple(v.shape) != tuple(own[k].shape):
            raise ValueError(f"{k}: shape {tuple(v.shape)} vs model "
                             f"{tuple(own[k].shape)}")
    missing = [k for k in own if k not in sd
               and not k.endswith(("num_batches_tracked", *allow_missing))]
    if missing:
        raise KeyError(f"checkpoint lacks {len(missing)} keys: {missing[:5]}")
    model.load_state_dict(sd, strict=False)
    return model


_BN_STATS = ("running_mean", "running_var")


def _without_bn_stats(model, sd, path):
    """Where `sd` carries none of the model's BatchNorm running statistics
    (an export from before they were saved), warn loudly: eval then runs
    with init statistics. Returns the key suffixes load_into may miss."""
    stats = [k for k in model.state_dict() if k.endswith(_BN_STATS)]
    if not stats or any(k in sd for k in stats):
        return ()
    msg = (f"{path} carries no BatchNorm running stats (pre-fix export?): "
           "eval will run with INIT statistics and be badly degraded. "
           "Re-export the .pth from the training state.")
    print("WARNING: " + msg)
    warnings.warn(msg)
    return _BN_STATS


def load_checkpoint(model, path):
    """Load a .pth into `model` (MeshNet or MeshNetS1, any variant):
    either flax-path keys (the JAX package's trainer output, mapped by
    state_dict_from_flax) or torch keys (the port's own or a reference
    pred_net_*.pth). One without BatchNorm statistics loads with a warning
    and keeps the model's init statistics, as the JAX package's load_pth
    does."""
    raw = {k: v for k, v in torch.load(path, map_location="cpu",
                                       weights_only=True).items()
           if not k.startswith("_meta/")}      # provenance, not weights
    if any("/" in k for k in raw):
        flat = {k: v.numpy() for k, v in raw.items()}
        stage, num_cams, variant = model_variant(model)
        n_up = sum(1 for k in flat
                   if k.startswith("texture_predictor/decoder/UpConvBlock_")
                   and k.endswith("/kernel"))
        sd = state_dict_from_flax(flat, num_cams, n_up, stage, **variant)
        # a flax export carries params, BN stats and mean_v, not buffers
        return load_into(model, sd, allow_missing=(
            "cam_biases", *_without_bn_stats(model, sd, path)))
    sd = {k: v for k, v in raw.items()
          if k not in _REFERENCE_ONLY and ".resnet.fc." not in k}
    return load_into(model, sd,
                     allow_missing=_without_bn_stats(model, sd, path))


def _conv_from_flax(p):
    """flax Conv {'kernel' HWIO, 'bias'} -> (OIHW weight, bias) tensors."""
    return (torch.tensor(np.asarray(p["kernel"], np.float32)
                         .transpose(3, 2, 0, 1).copy()),
            torch.tensor(np.asarray(p["bias"], np.float32)))


def discriminator_state_from_flax(params):
    """The JAX package's Discriminator params (Conv_0..Conv_4, Dense_0)
    -> the port's Discriminator state_dict."""
    sd = {}
    for i, name in enumerate([f"convs.{i}" for i in range(4)] + ["head"]):
        sd[f"{name}.weight"], sd[f"{name}.bias"] = _conv_from_flax(
            params[f"Conv_{i}"])
    dense = params["Dense_0"]
    sd["fc.weight"] = torch.tensor(np.asarray(dense["kernel"], np.float32).T
                                   .copy())
    sd["fc.bias"] = torch.tensor(np.asarray(dense["bias"], np.float32))
    return sd


def lpips_state_from_flax(params):
    """LPIPSAlex params {'conv0': {'kernel', 'bias'}, ...} (the JAX
    package's params['alex']) -> the port's LPIPSAlex state_dict."""
    sd = {}
    for i in range(len(params)):
        sd[f"convs.{i}.weight"], sd[f"convs.{i}.bias"] = _conv_from_flax(
            params[f"conv{i}"])
    return sd


def alexnet_features_from_torch(sd):
    """The port's AlexNet features state_dict (`convs.{i}.weight|bias`,
    LPIPSAlex's) -> {'conv{i}': {'kernel', 'bias'}}, the tree
    lpips_alex.npz holds (the inverse of lpips_state_from_flax)."""
    n = sum(1 for k in sd if k.startswith("convs.") and k.endswith(".weight"))
    out = {}
    for i in range(n):
        w, b = (sd[f"convs.{i}.{leaf}"].detach().cpu().numpy().copy()
                for leaf in ("weight", "bias"))
        out[f"conv{i}"] = {"kernel": to_flax_layout(w, T_CONV), "bias": b}
    return out


def load_lpips_npz(model, path):
    """weights/lpips_alex.npz (flax paths conv{i}/kernel, conv{i}/bias)
    into an LPIPSAlex."""
    model.load_state_dict(lpips_state_from_flax(load_npz(path)))
    return model


def maybe_load_lpips(model):
    """UMR_TPU_LPIPS_WEIGHTS (by default the committed
    weights/lpips_alex.npz) into an LPIPSAlex, where it exists; else a
    warning (the perceptual loss then runs on a random AlexNet). Returns
    whether it loaded."""
    path = os.environ.get("UMR_TPU_LPIPS_WEIGHTS", os.path.join(
        WEIGHTS_DIR, "lpips_alex.npz"))
    if os.path.exists(path):
        load_lpips_npz(model, path)
        return True
    warnings.warn(f"LPIPS AlexNet weights not found at '{path}': the "
                  "perceptual loss runs on a RANDOM-INIT AlexNet. Set "
                  "UMR_TPU_LPIPS_WEIGHTS.")
    return False
