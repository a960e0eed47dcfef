"""render.device_ms: device milliseconds per step launched inside the
step's rasterizer-pass profiler ranges (s*.pass*): the renders, their
binning and the losses computed there."""


def read(ctx):
    ms = [v for k, v in ctx.range_ms.items()
          if k.startswith(ctx.prefix + "pass")]
    return sum(ms) if ms else None
