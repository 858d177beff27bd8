"""seal_s: time to searchable, the mean of the set-up's seals, each timed by
the harness from ``build_service.build`` to the device sync after it."""


def read(ctx):
    return sum(ctx.seal_s) / len(ctx.seal_s) if ctx.seal_s else None
