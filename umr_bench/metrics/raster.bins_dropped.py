"""raster.bins_dropped: the (face, tile) entries a step that a cap of the
program's bins left out (a face's margin-expanded bbox reaches the tile,
the bins do not hold it): its counter raster.bins_dropped (umr_tpu_torch/
tracing.py, inside the raster.bins span) over its trainer.dispatch spans,
every step of the run. Nothing where the program keeps no such
counter."""


def read(ctx):
    try:
        from umr_tpu_torch import tracing
    except ImportError:
        return None
    t = tracing.totals()
    steps = t["calls"].get("trainer.dispatch")
    n = t["counters"].get("raster.bins_dropped")
    if not steps or n is None:
        return None
    return n / steps
