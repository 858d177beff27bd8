"""Exact re-rank of a candidate pool, and the final top-k of a scored exact
pool.

Mirrors ``exact_rerank`` and ``exact_finalize`` of
``vectorsearch_tpu/ops/traversal.py`` (the traversal itself, ``graph_expand``,
belongs to the graph slice, ROADMAP.md Queue A14).
"""

from __future__ import annotations

import torch

INF = float("inf")


def exact_rerank(
    q: torch.Tensor,  # f32[Q, D] queries
    vectors: torch.Tensor,  # f32[N, D'] raw vectors (D' >= D, zero pad columns)
    alive: torch.Tensor,  # bool[N] non-tombstoned rows
    cand_idx: torch.Tensor,  # i32[Q, C] candidates (-1 padded)
    k: int,
    metric: str = "L2",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact re-rank of approximate candidates (reference:
    fdb/FdbVectorIndex.java:970-1046): gathers the candidates' raw rows,
    scores them exactly (L2 -> score = -dist; cosine -> score = sim,
    distance = 1 - sim, 0 similarity at a zero norm) and drops -1 slots and
    tombstoned rows. Returns (scores f32[Q, k'], distances f32[Q, k'],
    indices i32[Q, k']) with k' = min(k, C); empty slots are
    (-inf, +inf, -1)."""
    out = exact_rerank_segments(q, [(vectors, alive)], cand_idx[None], k, metric)
    return tuple(t[0] for t in out)


def exact_rerank_segments(
    q: torch.Tensor,  # f32[Q, D] queries
    tables: list,  # S pairs (vectors f32[N, D'], alive bool[N]), one D'
    cand_idx: torch.Tensor,  # i32[S, Q, C] each segment's candidates
    k: int,
    metric: str = "L2",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``exact_rerank`` of S segments at once, each segment's candidates
    against its own table -> (scores, distances, indices) [S, Q, k']: one
    gather per segment into one block, then one scoring and one top-k."""
    s_count, qn, c = cand_idx.shape
    dim = tables[0][0].shape[1]
    qf = q.float()
    if qf.shape[1] < dim:
        # segments allocate lane-padded vector planes; zero pads change
        # neither dots nor norms
        qf = torch.nn.functional.pad(qf, (0, dim - qf.shape[1]))
    safe = torch.clamp(cand_idx, min=0).long()
    vecs = torch.empty((s_count, qn, c, dim), dtype=torch.float32, device=q.device)
    live = torch.empty((s_count, qn, c), dtype=torch.bool, device=q.device)
    for i, (vectors, alive) in enumerate(tables):
        rows = safe[i].reshape(-1)
        torch.index_select(vectors, 0, rows, out=vecs[i].view(qn * c, dim))
        torch.index_select(alive, 0, rows, out=live[i].view(qn * c))
    ok = (cand_idx >= 0) & live
    if metric == "COSINE":
        dots = torch.sum(vecs * qf[:, None, :], dim=-1)
        qn_ = torch.sqrt(torch.sum(qf * qf, dim=-1))[:, None]
        vn = torch.sqrt(torch.sum(vecs * vecs, dim=-1))
        denom = qn_ * vn
        sim = torch.where(denom == 0.0, 0.0, dots / torch.where(denom == 0.0, 1.0, denom))
        score, dist = sim, 1.0 - sim
    else:
        diff = vecs - qf[:, None, :]
        d = torch.sqrt(torch.clamp(torch.sum(diff * diff, dim=-1), min=0.0))
        score, dist = -d, d
    score = torch.where(ok, score, -INF)
    kk = min(k, c)
    top_score, pos = torch.topk(score, kk, dim=-1)
    top_idx = torch.gather(cand_idx, -1, pos)
    top_dist = torch.gather(dist, -1, pos)
    keep = top_score > -INF
    return (
        torch.where(keep, top_score, -INF),
        torch.where(keep, top_dist, INF),
        torch.where(keep, top_idx, -1).to(torch.int32),
    )


def exact_finalize(
    q: torch.Tensor,  # f32[Q, D] queries
    pool_scores: torch.Tensor,  # f32[Q, C] rank scores of the candidates
    pool_idx: torch.Tensor,  # i32[Q, C] candidate row ids (-1 padded)
    k: int,
    metric: str = "L2",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Final top-k from a SCORED exact pool, with no row gather (reference
    re-rank contract: fdb/FdbVectorIndex.java:970-1046). The pool's rank
    scores order candidates exactly as their true distances do, and the true
    distances follow from per-query terms alone:
      L2     -> dist^2 = ||q||^2 - s      (clamped at 0)
      COSINE -> sim    = s / ||q||        (0 when ||q|| = 0)
    Returns (scores f32[Q, k'], distances f32[Q, k'], indices i32[Q, k'])
    with k' = min(k, C); empty slots are (-inf, +inf, -1)."""
    qf = q.float()
    s = torch.where(pool_idx >= 0, pool_scores, -INF)
    kk = min(k, pool_idx.shape[1])
    top_s, pos = torch.topk(s, kk, dim=1)
    top_idx = torch.gather(pool_idx, 1, pos)
    if metric == "COSINE":
        qn = torch.sqrt(torch.sum(qf * qf, dim=-1))[:, None]
        sim = torch.where(qn == 0.0, 0.0, top_s / torch.where(qn == 0.0, 1.0, qn))
        score = sim
        dist = 1.0 - sim
    else:
        q2 = torch.sum(qf * qf, dim=-1)[:, None]
        d = torch.sqrt(torch.clamp(q2 - top_s, min=0.0))
        score = -d
        dist = d
    keep = top_s > -INF
    return (
        torch.where(keep, score, -INF),
        torch.where(keep, dist, INF),
        torch.where(keep, top_idx, -1),
    )
