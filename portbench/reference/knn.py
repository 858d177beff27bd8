"""Exact k nearest neighbours in float64, under the metric the cell's
configuration states, over the rows a query could see.

- ``"L2"``: the Euclidean distance.
- ``"COSINE"``: ``1 - q.x / (|q| |x|)``, with the similarity 0 (the distance
  1) where either norm is 0, as the port and the Java original
  (``Distances.cosine``) define it. No square root is taken.

A query sent at ``ts`` whose answer came back at ``te`` runs while writes
land, so it sees:

- certainly every row whose add was acknowledged before ``ts`` and whose
  delete had not started by ``te``;
- at most the rows whose add started before ``te`` and whose delete was not
  acknowledged before ``ts``.

``Log`` holds those four times for every gid; ``topk_certain`` gives each
query's exact top k over the rows it certainly saw, and ``distances`` the
true distance of any row. Both run in blocks of rows and queries, so they
fit beside nothing else on the card once the program has been freed.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

_INF = float("inf")
METRICS = ("L2", "COSINE")


@dataclasses.dataclass
class Log:
    """Per gid (dense, 0..G-1): the row's vector and its four times."""

    vectors: np.ndarray  # f32 [G, d]; rows of unknown gids are NaN
    add_start: np.ndarray  # f64 [G]; -inf for rows there before the window
    add_ack: np.ndarray
    del_start: np.ndarray  # f64 [G]; +inf for rows never deleted
    del_ack: np.ndarray

    @classmethod
    def build(cls, base_gids, base_rows, adds=(), deletes=()):
        """``adds``: (gids, rows, t_start, t_ack) of each acknowledged add;
        ``deletes``: (gids, t_start, t_ack) of each delete call."""
        base_gids = np.asarray(base_gids, np.int64)
        all_g = [base_gids] + [np.asarray(g, np.int64) for g, *_ in adds]
        size = int(max((g.max() for g in all_g if g.size), default=-1)) + 1
        d = base_rows.shape[1]
        vec = np.full((size, d), np.nan, np.float32)
        add_start = np.full(size, _INF)
        add_ack = np.full(size, _INF)
        vec[base_gids] = base_rows
        add_start[base_gids] = -_INF
        add_ack[base_gids] = -_INF
        for g, rows, t0, t1 in adds:
            g = np.asarray(g, np.int64)
            vec[g] = rows
            add_start[g] = t0
            add_ack[g] = t1
        del_start = np.full(size, _INF)
        del_ack = np.full(size, _INF)
        for g, t0, t1 in deletes:
            g = np.asarray(g, np.int64)
            g = g[(g >= 0) & (g < size)]
            del_start[g] = np.minimum(del_start[g], t0)
            del_ack[g] = np.minimum(del_ack[g], t1)
        return cls(vec, add_start, add_ack, del_start, del_ack)

    def possible(self, gids, ts, te):
        """bool [Q, k]: gid could have been seen by a query sent at ts that
        returned at te (unknown gids and -1 never)."""
        gids = np.asarray(gids, np.int64)
        ok = (gids >= 0) & (gids < len(self.add_start))
        g = np.where(ok, gids, 0)
        ts = np.asarray(ts, np.float64)[:, None]
        te = np.asarray(te, np.float64)[:, None]
        return ok & (self.add_start[g] < te) & (self.del_ack[g] > ts) & \
            ~np.isnan(self.vectors[g, 0])


def _sq(q, x):
    """Squared L2 distances [Q, N] in float64."""
    return ((q * q).sum(1)[:, None] - 2.0 * (q @ x.T)
            + (x * x).sum(1)[None, :]).clamp_min_(0.0)


def _check(metric: str) -> None:
    if metric not in METRICS:
        raise ValueError(f"the reference computes {', '.join(METRICS)} "
                         f"distances, not {metric!r}")


def similarity(dots, qn, xn):
    """dots / (qn xn), 0 where either norm is 0 (the zero-norm rule)."""
    denom = qn * xn
    zero = denom == 0.0
    return torch.where(zero, 0.0, dots / torch.where(zero, 1.0, denom))


def _cos(q, x):
    """Cosine distances [Q, N] in float64."""
    qn = torch.sqrt((q * q).sum(1))[:, None]
    xn = torch.sqrt((x * x).sum(1))[None, :]
    return 1.0 - similarity(q @ x.T, qn, xn)


def distances(log: Log, queries, gids, device, metric: str = "L2") -> np.ndarray:
    """f64 [Q, k]: the true distance of each returned gid (NaN where the
    gid is unknown or -1)."""
    _check(metric)
    gids = np.asarray(gids, np.int64)
    ok = (gids >= 0) & (gids < len(log.add_start))
    rows = log.vectors[np.where(ok, gids, 0)]  # [Q, k, d]
    q = torch.as_tensor(np.asarray(queries), device=device, dtype=torch.float64)
    x = torch.as_tensor(rows, device=device, dtype=torch.float64)
    if metric == "L2":
        d = torch.sqrt(((x - q[:, None, :]) ** 2).sum(-1)).cpu().numpy()
    else:
        dots = (x * q[:, None, :]).sum(-1)
        qn = torch.sqrt((q * q).sum(-1))[:, None]
        xn = torch.sqrt((x * x).sum(-1))
        d = (1.0 - similarity(dots, qn, xn)).cpu().numpy()
    d[~ok] = np.nan
    return d


def topk_certain(log: Log, queries, ts, te, k: int, device,
                 budget_bytes: int = 1 << 31, metric: str = "L2"):
    """(gids i64 [Q, k], distances f64 [Q, k]): each query's exact top k
    over the rows it certainly saw; -1 / inf past the rows there were."""
    _check(metric)
    nq = len(queries)
    q_all = torch.as_tensor(np.asarray(queries), device=device, dtype=torch.float64)
    ts_all = torch.as_tensor(np.asarray(ts, np.float64), device=device)
    te_all = torch.as_tensor(np.asarray(te, np.float64), device=device)
    best_d = torch.full((nq, k), _INF, dtype=torch.float64, device=device)
    best_g = torch.full((nq, k), -1, dtype=torch.int64, device=device)
    qc = min(nq, 512)
    block = max(1024, budget_bytes // (8 * qc))
    known = ~np.isnan(log.vectors[:, 0])
    for off in range(0, len(log.add_start), block):
        sl = slice(off, off + block)
        x = torch.as_tensor(np.nan_to_num(log.vectors[sl]), device=device,
                            dtype=torch.float64)
        ack = torch.as_tensor(log.add_ack[sl], device=device)
        dst = torch.as_tensor(log.del_start[sl], device=device)
        kn = torch.as_tensor(known[sl], device=device)
        gid = torch.arange(off, off + x.shape[0], device=device)
        for qo in range(0, nq, qc):
            qs = slice(qo, qo + qc)
            d2 = _sq(q_all[qs], x) if metric == "L2" else _cos(q_all[qs], x)
            seen = kn[None, :] & (ack[None, :] < ts_all[qs, None]) & \
                (dst[None, :] > te_all[qs, None])
            d2 = torch.where(seen, d2, _INF)
            kk = min(k, d2.shape[1])
            v, i = torch.topk(d2, kk, dim=1, largest=False)
            cand_d = torch.cat([best_d[qs], v], 1)
            cand_g = torch.cat([best_g[qs], gid[i]], 1)
            v2, i2 = torch.topk(cand_d, k, dim=1, largest=False)
            best_d[qs] = v2
            best_g[qs] = torch.gather(cand_g, 1, i2)
        del x
    best_g = torch.where(torch.isinf(best_d), -1, best_g)
    if metric == "COSINE":
        return best_g.cpu().numpy(), best_d.cpu().numpy()
    return best_g.cpu().numpy(), torch.sqrt(best_d).cpu().numpy()
