"""raster_fwd_roofline: the least time an H100 needs for the traced
steps' forward renders (workcount.py, from their geometry: the larger of
operations over 67 TFLOP/s and bytes over 3.35 TB/s) over the device
time of the forward raster kernel, in percent."""


def read(ctx):
    if not ctx.raster_kernel_s["fwd"] or not ctx.raster_least_s["fwd"]:
        return None
    return 100.0 * ctx.raster_least_s["fwd"] / ctx.raster_kernel_s["fwd"]
