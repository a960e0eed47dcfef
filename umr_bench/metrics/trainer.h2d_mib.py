"""trainer.h2d_mib: the MiB a step that the trainer copies from the host
to the card: the program's counter trainer.h2d_bytes over its
trainer.dispatch spans (umr_tpu_torch/tracing.py), every step of the run
(bytes, which the profiler does not change). Nothing where the program
keeps no such counter."""


def read(ctx):
    try:
        from umr_tpu_torch import tracing
    except ImportError:
        return None
    t = tracing.totals()
    steps = t["calls"].get("trainer.dispatch")
    nbytes = t["counters"].get("trainer.h2d_bytes")
    if not steps or nbytes is None:
        return None
    return nbytes / steps / 2 ** 20
