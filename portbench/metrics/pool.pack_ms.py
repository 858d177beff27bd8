"""pool.pack_ms: the median over the run's records of
``vectorsearch.exact_pool.pack_ms``, the device time a batch spends packing
B1's fold-1 planes on B2's wide route (every ``pack_tiles`` of the batch's
calls, between CUDA events), which the port records once on each batch it
samples (``query_breakdown_sample_every``). None where it recorded none."""

import statistics


def read(ctx):
    vals = ctx.histogram("vectorsearch.exact_pool.pack_ms", 0, None)
    return statistics.median(vals) if vals else None
