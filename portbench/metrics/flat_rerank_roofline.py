"""flat_rerank_roofline: the flat route's exact re-rank's share (%) of its
roofline.

Time: the median over the run of ``vectorsearch.flat.rerank_ms``, the
device time of a sampled batch's flat re-ranks summed over its calls (CUDA
events, ``query_breakdown_sample_every``). Work a batch, the algorithm's
(``portbench/rerank_work.py``): for each sealed segment, Q x min(ef_search,
live rows) candidate rows of D f32 features, each read once, the Q queries
and k (score, row) pairs a query; D the configuration's ``dimension``.
However the program groups the segments into calls, the work is the same.
None where the port records no such histogram, or without the card's
peaks."""

import statistics

from portbench import roofline
from portbench.rerank_work import rerank_work


def read(ctx):
    if ctx.peaks is None:
        return None
    vals = ctx.histogram("vectorsearch.flat.rerank_ms", 0, None)
    sealed = [s["live"] for s in ctx.segments if s["state"] in ("SEALED", "COMPACTING")]
    if not vals or not sealed:
        return None
    ms = statistics.median(vals)
    if ms <= 0:
        return None
    idx, tr = ctx.cell.config["index"], ctx.cell.traffic
    q, ef = int(tr["batch"]), int(tr["search"]["ef_search"])
    work = [rerank_work(q, min(ef, n), int(idx["dimension"]), int(tr["k"]))
            for n in sealed]
    return roofline.share(work, ms / 1e3, ctx.peaks)
