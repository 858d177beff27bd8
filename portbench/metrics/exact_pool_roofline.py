"""exact_pool_roofline: the exact pool stage's share (%) of its roofline.

Kernels: every one whose name holds ``exact_pool`` (csrc/exact_pool_tc.cu:
B2's packed form over the sealed segments, B1's over the ACTIVE brute
table), by name in the trace. Work a batch, the algorithm's: each query of
the batch against every live row a query sees (every segment but a
compaction's destination), a multiply and an add for each of the
configuration's ``dimension`` features; the f32 rows and queries read once
and the k (distance, row) pairs of each answer written once. However the program groups, pads or packs the rows, the work is the
same. Batches: those completed in the traced part of the window.
"""

from portbench import roofline

KERNELS = ("exact_pool",)


def read(ctx):
    if ctx.trace is None or ctx.peaks is None:
        return None
    secs, launches = ctx.trace.kernel_time(lambda n: any(k in n for k in KERNELS))
    tp0, tp1, _r0, _r1 = ctx.traced
    batches = sum(1 for c in ctx.calls if tp0 <= c["te"] <= tp1)
    live = sum(s["live"] for s in ctx.segments if s["state"] != "WRITING")
    if not launches or not batches or not live:
        return None
    tr = ctx.cell.traffic
    one = roofline.exact_pool_work(int(tr["batch"]), live,
                                   int(ctx.cell.config["index"]["dimension"]),
                                   int(tr["k"]))
    return roofline.share([one] * batches, secs, ctx.peaks)
