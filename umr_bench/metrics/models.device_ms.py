"""models.device_ms: device milliseconds per step launched inside the
step's model and LPIPS profiler ranges (s*.model, s*.lpips)."""


def read(ctx):
    names = (ctx.prefix + "model", ctx.prefix + "lpips")
    if not any(n in ctx.range_ms for n in names):
        return None
    return sum(ctx.range_ms.get(n, 0.0) for n in names)
