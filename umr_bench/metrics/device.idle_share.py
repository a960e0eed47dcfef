"""device.idle_share: the share of a step in which no operation runs on
the device, in percent: 1 - the device's busy time per step (the union of
its operations' intervals over the device stretch, traced with the
device's activity alone) over the step time of the untraced stretch.
The profiler slows the host-bound step even when it records no host
operation, so the traced stretch's own length would count its cost as
idle."""


def read(ctx):
    if not ctx.device_ops or not ctx.busy_per_step_s or not \
            ctx.untraced_step_s:
        return None
    return 100.0 * (1.0 - ctx.busy_per_step_s / ctx.untraced_step_s)
