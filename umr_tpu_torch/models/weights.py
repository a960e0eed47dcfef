"""Weights into the port: flax-path-flattened arrays (what the JAX
package's checkpoints.save_pth writes, and the committed ResNet-18 npz
files) mapped to torch state_dict keys through models/reference_io.py.
Ports umr_tpu/models/weight_io.py (npz load) and
umr_tpu/training/checkpoints.py::load_pth.
"""

from __future__ import annotations

import os
import warnings

import numpy as np
import torch

from .reference_io import build_key_map, resnet_maps, to_torch_layout

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


def load_resnet18_npz(params_path, stats_path=None):
    """The committed trunk weights (weights/resnet18_params.npz and its
    *_stats.npz, flax paths without the 'encoder/resnet/' prefix) ->
    state_dict entries under `encoder.resnet_conv.resnet.`."""
    flat = dict(np.load(params_path))
    if stats_path is not None:
        flat.update(np.load(stats_path))
    pm, sm = resnet_maps((), "encoder.resnet_conv.resnet")
    sd = {}
    for path, tkey, tf in pm + sm:
        key = "/".join(path)
        if key not in flat:
            raise KeyError(f"{params_path}: missing {key}")
        arr = to_torch_layout(np.asarray(flat[key], np.float32), tf)
        sd[tkey] = torch.tensor(arr)
    return sd


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
    raw = torch.load(path, map_location="cpu", weights_only=True)
    if any("/" in k for k in raw):
        flat = {k: v.numpy() for k, v in raw.items()
                if not k.startswith("_meta/")}
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


def load_lpips_npz(model, path):
    """weights/lpips_alex.npz (flax paths conv{i}/kernel, conv{i}/bias)
    into an LPIPSAlex."""
    flat = np.load(path)
    tree = {}
    for key in flat.files:
        conv, leaf = key.split("/")
        tree.setdefault(conv, {})[leaf] = flat[key]
    model.load_state_dict(lpips_state_from_flax(tree))
    return model
