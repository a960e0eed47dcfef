"""raster_bwd_roofline: as raster_fwd_roofline, for the backward renders
and the backward raster kernel."""


def read(ctx):
    if not ctx.raster_kernel_s["bwd"] or not ctx.raster_least_s["bwd"]:
        return None
    return 100.0 * ctx.raster_least_s["bwd"] / ctx.raster_kernel_s["bwd"]
