"""render.bins_device_ms: device milliseconds per step launched inside the
program's binning span ("raster.bins", ops/raster_bins.py) in the host
stretch's trace. The span has no step prefix, so render.device_ms still
counts the same launches to the render pass around each binning."""

from umr_bench import traceutil


def read(ctx):
    steps = ctx.notes.get("trace_steps")
    if not ctx.events or not steps:
        return None
    return traceutil.range_split(ctx.events, "raster.", steps).get(
        "raster.bins")
