"""seal.idle_share: the card's idle share (%) over the wall time of the
set-up's seals, traced with torch.profiler (device activity only)."""


def read(ctx):
    t = ctx.seal_trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
