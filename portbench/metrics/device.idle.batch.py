"""device.idle.batch: the card's idle share (%) over the traced part of the
window: 1 less the union of every device operation's interval over its
length (torch.profiler)."""


def read(ctx):
    t = ctx.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
