"""Losses of the stage-2 objective (port of umr_tpu/losses/)."""
