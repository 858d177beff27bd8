"""maint.vacuum_ms: the mean time of a vacuum run in the window, from the
port's ``vectorsearch.vacuum.duration_ms`` records (host clock, under the
store's lock)."""


def read(ctx):
    c0, c1 = ctx.counters
    n = "vectorsearch.vacuum.duration_ms"
    vals = ctx.histogram(n, c0[n], c1[n])
    return sum(vals) / len(vals) if vals else None
