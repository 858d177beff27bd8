"""flat.calls.batch: calls of the port's flat route a batch. The port records
one ``vectorsearch.flat.call`` span for each (``core/index.py::
_flat_segments_query``: a LUT product, an ADC pool a segment, one stage-2
top-k and one exact re-rank over the call's segments); the records within
the window, over the batches completed there. None where the port records
no such span, or where its ring dropped records that may have lain in the
window."""

from portbench import spans

NAME = "vectorsearch.flat.call"


def read(ctx):
    recs = spans.between(ctx.t_open, ctx.t_close, NAME)
    done = sum(1 for c in ctx.calls if "error" not in c)
    if not recs or not done:
        return None
    return len(recs) / done
