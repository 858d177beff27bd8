"""The comparison that decides ``correct``.

Distances are in the metric the cell's configuration states
(``index.metric``: L2, or COSINE as 1 - similarity), and the reference
computes them in it. Four numbers, each against a limit of its own:

- ``miss``: of the reference's top-k slots of the sampled queries (exact,
  float64, over the rows each query certainly saw), the share the program
  left out although it returned a row farther away: 1 - recall@k.
  Approximate search misses a few; a search that drops a segment, a part of
  the batch or the writes, or ranks in a lower precision, misses more.
- ``dist_err``: the largest gap between a distance the program returned
  and the true distance of the row it named, over that query's k-th true
  distance (floored at a thousandth of it). It holds the re-rank to the
  float32 the configurations state.
- ``bad_rows``: returned gids, over every answer of the run, that the query
  could not have seen (deleted and acknowledged before it was sent, never
  added, or repeated in one answer). The configurations' guarantee: 0.
- ``unanswered``: queries due in the window that raised or never came back.
  0.

The limits of ``miss`` and ``dist_err`` lie between the program's readings
and those of the control or a planted fault, at the cell's own size; each
cell's are in ``portbench/limits/<cell>.json`` beside those readings.
"""

from __future__ import annotations

import numpy as np

from portbench.reference import knn

NUMBERS = ("miss", "dist_err", "bad_rows", "unanswered")


def bad_rows(log: knn.Log, gids, ts, te) -> int:
    """Returned gids that could not have been seen, and repeats."""
    gids = np.asarray(gids, np.int64)
    valid = gids >= 0
    bad = int((valid & ~log.possible(gids, ts, te)).sum())
    srt = np.sort(np.where(valid, gids, -1 - np.arange(gids.shape[1])), axis=1)
    return bad + int((srt[:, 1:] == srt[:, :-1]).sum())


def sampled(log: knn.Log, queries, gids, dists, ts, te, k: int, device,
            metric: str = "L2"):
    """(miss, dist_err) over the sampled answers, in ``metric``."""
    gids = np.asarray(gids, np.int64)
    ref_g, ref_d = knn.topk_certain(log, queries, ts, te, k, device, metric=metric)
    true_d = knn.distances(log, queries, gids, device, metric)  # NaN at -1 / unknown
    valid = (gids >= 0) & ~np.isnan(true_d)
    full = valid.sum(1) == k
    prog_kth = np.where(full, np.nanmax(np.where(valid, true_d, -np.inf), 1), np.inf)
    missed = 0
    for i in range(len(gids)):
        got = set(gids[i][valid[i]].tolist())
        for g, d in zip(ref_g[i], ref_d[i]):
            if g >= 0 and g not in got and d < prog_kth[i] * (1 - 1e-9):
                missed += 1
    slots = max(1, int((ref_g >= 0).sum()))
    kth = np.where(np.isfinite(ref_d[:, -1]), ref_d[:, -1], np.nanmax(ref_d))
    floor = np.maximum(kth * 1e-3, 1e-30)[:, None]
    err = np.abs(np.asarray(dists, np.float64) - true_d) / np.maximum(true_d, floor)
    err = err[valid]
    return missed / slots, float(err.max()) if err.size else 0.0


def limits(cell_limits: dict) -> dict:
    """Each number's limit: the cell's own for miss and dist_err, and 0 for
    the guarantees."""
    return {"miss": cell_limits["miss"], "dist_err": cell_limits["dist_err"],
            "bad_rows": 0, "unanswered": 0}


def verdict(numbers: dict, limits: dict):
    """(correct, {name: {"value": v, "limit": l}}) in NUMBERS' order."""
    out = {n: {"value": numbers[n], "limit": limits[n]} for n in NUMBERS}
    ok = all(out[n]["value"] <= out[n]["limit"] for n in NUMBERS)
    return ok, out
