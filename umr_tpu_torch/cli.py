"""Command line for the port's entry points: argparse over the fields of
config.Config, with the JAX package's flag names (booleans as
--flag, --noflag or --flag=true|false)."""

from __future__ import annotations

import argparse
import dataclasses

from .config import Config

# each entry point's flag defaults (the JAX package's define_flags
# overrides of the same entry point)
S1_DEFAULTS = dict(mask_loss_wt=3.0, flatten_reg_wt=4e-4, deform_reg_wt=5.0,
                   tex_cycle_loss_wt=0.5, use_scops=False)
AVG_UV_DEFAULTS = dict(use_scops=True, is_train=False)
TEST_KP_DEFAULTS = dict(split="test", use_scops=False, batch_size=2,
                        number_pairs=10000, is_train=False)


def _bool(v):
    if v.lower() in ("1", "true", "yes"):
        return True
    if v.lower() in ("0", "false", "no"):
        return False
    raise argparse.ArgumentTypeError(f"not a boolean: {v!r}")


def parse_config(argv=None, overrides=None) -> Config:
    """Parse argv into a validated Config; `overrides` change the
    defaults (as each JAX entry point's define_flags(overrides=...))."""
    defaults = Config(**(overrides or {}))
    parser = argparse.ArgumentParser()
    for f in dataclasses.fields(Config):
        default = getattr(defaults, f.name)
        if f.type in ("bool", bool):
            parser.add_argument(f"--{f.name}", type=_bool, nargs="?",
                                const=True, default=default)
            parser.add_argument(f"--no{f.name}", dest=f.name,
                                action="store_false")
        elif f.type in ("int", int):
            parser.add_argument(f"--{f.name}", type=int, default=default)
        elif f.type in ("float", float):
            parser.add_argument(f"--{f.name}", type=float, default=default)
        else:
            parser.add_argument(f"--{f.name}", type=str, default=default)
    args = parser.parse_args(argv)
    return Config(**vars(args)).sync_image_size().validate()
