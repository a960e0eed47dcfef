"""raster.bins_entries: thousands of (face, tile) entries a step that the
program's bins hold: its counter raster.bins_entries (umr_tpu_torch/
tracing.py, added on the device inside the raster.bins span, once for
every binning: a render with a backward bins its faces at each launch)
over its trainer.dispatch spans, every step of the run. Nothing where the
program keeps no such counter."""


def read(ctx):
    try:
        from umr_tpu_torch import tracing
    except ImportError:
        return None
    t = tracing.totals()
    steps = t["calls"].get("trainer.dispatch")
    n = t["counters"].get("raster.bins_entries")
    if not steps or n is None:
        return None
    return n / steps / 1e3
