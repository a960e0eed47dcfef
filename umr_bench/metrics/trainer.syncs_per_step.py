"""trainer.syncs_per_step: the host syncs of one step cycle (the trainer's
loop and the step it drives), counted as the synchronising CUDA calls
that torch.cuda.set_sync_debug_mode("warn") reports over the traced run's
sync stretch, per step."""


def read(ctx):
    if ctx.syncs is None or not ctx.sync_steps:
        return None
    return ctx.syncs / ctx.sync_steps
