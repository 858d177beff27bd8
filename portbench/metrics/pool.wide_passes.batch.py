"""pool.wide_passes.batch: B1 launches of B2's wide route a batch. The port
records one ``vectorsearch.exact_pool.wide_pass`` span for each (a block of
queries whose fold-1 planes fit its byte bound, over one group's rows); the
records within the window, over the batches completed there. None where the
port records no such span, or where its ring dropped records that may have
lain in the window."""

from portbench import spans

NAME = "vectorsearch.exact_pool.wide_pass"


def read(ctx):
    recs = spans.between(ctx.t_open, ctx.t_close, NAME)
    done = sum(1 for c in ctx.calls if "error" not in c)
    if not recs or not done:
        return None
    return len(recs) / done
