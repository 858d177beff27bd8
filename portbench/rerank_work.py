"""The work of the flat route's exact re-rank, counted from the algorithm
and the cell's shapes, as ``roofline.py`` counts the pool stages' (its
peaks and ``bound_s`` judge it)."""

from __future__ import annotations


def rerank_work(q: int, c: int, d: int, k: int):
    """(operations, bytes) of an exact re-rank over one segment: Q queries,
    each scoring C candidate rows of D f32 features (a multiply and an add a
    feature); each candidate row read once, the f32 queries read once, and
    k (score, row) pairs a query written."""
    return 2 * q * c * d, q * c * d * 4 + q * d * 4 + q * k * 8
