"""Checkpoints (port of umr_tpu/training/checkpoints.py, in torch idiom).

save_pth writes pred_net_{label}.pth as the model's own state_dict: the
reference's torch keys (models/reference_io.py's map), with mean_v and
the BatchNorm running statistics, which eval needs (a .pth without them
evals with init statistics), and the trunk's provenance as
_meta/trunk_pretrained. models/weights.py::load_checkpoint reads it
back, and the JAX package's reference_io.import_reference_checkpoint
reads it too.

save_state / restore_state replace Orbax: {save_dir}/pred_state.pt holds
the model's, the discriminator's and the optimizer's state_dicts, the
step and update counts, the step generator's state and trunk_pretrained,
so that a resumed run continues where the saved one stopped (the
learning rate follows the update count; stage 1's template lives in the
model's mean_v).

In a group of ranks (parallel/mesh.py) rank 0 writes and every rank
waits for the file at a barrier; every rank restores the same file onto
its own device.
"""

from __future__ import annotations

import os

import torch

from ..parallel import barrier, is_writer


def _atomic_save(make_obj, path):
    """torch.save(make_obj()) to a temporary name, then os.replace: a
    killed save leaves the previous file whole. Rank 0 writes; every rank
    returns once the file is in place."""
    if is_writer():
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        tmp = f"{path}.tmp{os.getpid()}"
        torch.save(make_obj(), tmp)
        os.replace(tmp, path)
    barrier()


def save_pth(path, model, meta=None):
    """The model's state_dict (parameters, BatchNorm statistics, mean_v),
    on the CPU, and each provenance scalar of `meta` that is not None
    (trunk_pretrained) under '_meta/<key>', as the JAX package's save_pth
    writes it; readers drop those keys."""
    def make():
        sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}
        sd.update({f"_meta/{k}": torch.tensor(v)
                   for k, v in (meta or {}).items() if v is not None})
        return sd

    _atomic_save(make, path)


def state_path(save_dir, label="pred"):
    return os.path.join(save_dir, f"{label}_state.pt")


def save_state(save_dir, state, label="pred"):
    """The training state (training/steps.py::TrainState) -> the resume
    file; returns its path."""
    path = state_path(save_dir, label)
    _atomic_save(lambda: {
        "model": state.model.state_dict(),
        "disc": state.disc.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "step": int(state.step),
        "updates": int(state.updates),
        "generator": state.generator.get_state(),
        "trunk_pretrained": state.trunk_pretrained,
    }, path)
    return path


def _check_keys(name, saved, module):
    """Refuse a saved state_dict that does not fit `module` before any of
    it is copied in."""
    own = module.state_dict()
    if set(saved) != set(own):
        diff = sorted(set(saved) ^ set(own))
        raise ValueError(f"{name}: keys differ from the model's: {diff[:5]}")
    for k, v in saved.items():
        if tuple(v.shape) != tuple(own[k].shape):
            raise ValueError(f"{name}.{k}: shape {tuple(v.shape)} vs "
                             f"{tuple(own[k].shape)}")


def restore_state(save_dir, state, label="pred"):
    """Load the resume file into `state` (in place) and return it. Raises,
    with `state` untouched, when the file does not fit it."""
    ckpt = torch.load(state_path(save_dir, label), map_location="cpu",
                      weights_only=True)
    _check_keys("model", ckpt["model"], state.model)
    _check_keys("disc", ckpt["disc"], state.disc)
    n_saved = [len(g["params"]) for g in ckpt["optimizer"]["param_groups"]]
    n_own = [len(g["params"]) for g in state.optimizer.param_groups]
    if n_saved != n_own:
        raise ValueError(f"optimizer: parameter groups {n_saved} vs {n_own}")
    try:
        # a CPU generator's state does not fit a CUDA one's: try it on a
        # scratch generator of the same device first
        torch.Generator(state.generator.device).set_state(ckpt["generator"])
    except RuntimeError as e:
        raise ValueError(f"generator: {e}") from e
    state.model.load_state_dict(ckpt["model"])
    state.disc.load_state_dict(ckpt["disc"])
    state.optimizer.load_state_dict(ckpt["optimizer"])
    state.generator.set_state(ckpt["generator"])
    state.step = ckpt["step"]
    state.updates = ckpt["updates"]
    state.trunk_pretrained = ckpt.get("trunk_pretrained",
                                      state.trunk_pretrained)
    return state
