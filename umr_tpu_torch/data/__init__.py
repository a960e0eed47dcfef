"""Datasets (port of umr_tpu/data/): synthetic batches (synthetic.py) and
the procedural bird category with its loaders (synthetic_category.py)."""

from .synthetic import compute_dt_barrier, synthetic_batch  # noqa: F401
