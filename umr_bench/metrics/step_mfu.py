"""step_mfu: the operations a step needs (workcount.py: its convolutions
and linear layers from the configuration's shapes, its renders from their
geometry) over the step time of the traced run's untraced stretch, as a
share of the H100's 67 TFLOP/s in float32 outside the tensor cores."""


def read(ctx):
    if not ctx.untraced_step_s or not ctx.flops_per_step.get("renders"):
        return None
    ops = sum(ctx.flops_per_step.values())
    return 100.0 * ops / (ctx.untraced_step_s * ctx.peak_flops)
