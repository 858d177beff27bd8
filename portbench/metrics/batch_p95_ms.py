"""batch_p95_ms: the 95th percentile of the latency of every batch completed
in the window, from the call to its return (host clock)."""

from portbench import stats


def read(ctx):
    lat = [(c["te"] - c["ts"]) * 1e3 if "error" not in c else float("inf")
           for c in ctx.calls]
    return stats.quantile(lat, 0.95) if lat else None
