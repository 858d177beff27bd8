"""dispatch.launches.batch: CUDA kernel-launch calls the host made in the
traced part of the window (torch.profiler) over the batches completed there."""


def read(ctx):
    if ctx.trace is None:
        return None
    tp0, tp1, _r0, _r1 = ctx.traced
    done = sum(1 for c in ctx.calls if tp0 <= c["te"] <= tp1)
    return ctx.trace.launches / done if done else None
