"""Stage-2 training: the step and its loop (port of umr_tpu/training/)."""
