"""adc_pool_roofline: the ADC pool stage's share (%) of its roofline.

Kernels: ``adc_pool_lines_kernel`` (csrc/adc.cu, B3), by name in the trace.
Work a batch, the algorithm's: a pool over each sealed segment, Q x N x M
lookups added (Q the batch, N the segment's live rows, M the PQ
subspaces), the N x M codes, the f32 LUT [Q, M, K] and a pool of ef_search
(score, row) pairs a query. However the program groups the segments into
launches, the work is the same. Batches: those completed in the traced part
of the window.
"""

from portbench import roofline

KERNELS = ("adc_pool_lines_kernel",)


def read(ctx):
    if ctx.trace is None or ctx.peaks is None:
        return None
    secs, launches = ctx.trace.kernel_time(lambda n: any(k in n for k in KERNELS))
    tp0, tp1, _r0, _r1 = ctx.traced
    batches = sum(1 for c in ctx.calls if tp0 <= c["te"] <= tp1)
    sealed = [s["live"] for s in ctx.segments if s["state"] in ("SEALED", "COMPACTING")]
    if not launches or not batches or not sealed:
        return None
    idx, tr = ctx.cell.config["index"], ctx.cell.traffic
    work = [roofline.adc_pool_work(int(tr["batch"]), n, idx["pq_m"], idx["pq_k"],
                                   tr["search"]["ef_search"]) for n in sealed]
    return roofline.share(work * batches, secs, ctx.peaks)
