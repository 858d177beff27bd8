"""The table of peaks and the work of each pool stage, counted from the
algorithm and the cell's shapes, never from a kernel's passes.

Each input byte counts once and each output byte once. Operations are held
against the highest dense rate the card publishes short of fp8, so that no
correct implementation of the stage, in any precision, reads above 100%.
"""

from __future__ import annotations

# NVIDIA's data sheet, H100 SXM, dense, at the 700 W limit.
PEAKS = {
    "H100": {"bytes_s": 3.35e12, "ops_s": 989e12},
}


def peaks(kind: str) -> dict | None:
    """The peaks of a card by the name torch gives it; None when unknown."""
    for key, p in PEAKS.items():
        if key in kind:
            return p
    return None


def bound_s(ops: float, nbytes: float, peak: dict) -> float:
    """The least time the card could take: the larger of bytes over the
    memory rate and operations over the operation rate."""
    return max(nbytes / peak["bytes_s"], ops / peak["ops_s"])


def adc_pool_work(q: int, n: int, m: int, k: int, pool: int):
    """(operations, bytes) of an ADC pool over one segment: Q x N x M table
    lookups added; the N x M one-byte codes, the f32 LUT [Q, M, K] and a
    pool of ``pool`` (score, row) pairs a query."""
    return q * n * m, n * m + q * m * k * 4 + q * pool * 8


def exact_pool_work(q: int, n: int, d: int, pool: int):
    """(operations, bytes) of an exact pool: a multiply and an add for each
    of the N x D live features against Q queries; the f32 rows, the f32
    queries and a pool of ``pool`` (score, row) pairs a query."""
    return 2 * q * n * d, n * d * 4 + q * d * 4 + q * pool * 8


def share(work: list, kernel_s: float, peak: dict) -> float | None:
    """A stage's share of its roofline in %: the least time of all its
    launches' work over their device time; None when nothing ran."""
    if kernel_s <= 0 or not work:
        return None
    return 100.0 * sum(bound_s(o, b, peak) for o, b in work) / kernel_s
