"""qps: every query of the calls completed in the window over the window's
seconds (host clock). Not a median of windows."""

from portbench import stats


def read(ctx):
    return stats.rate(sum(c["n"] for c in ctx.calls if "error" not in c), ctx.seconds)
