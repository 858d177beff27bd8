"""Batched graph traversal (BEST_FIRST, and legacy BEAM), the exact
re-rank of a candidate pool, and the final top-k of a scored exact pool.

Mirrors ``vectorsearch_tpu/ops/traversal.py``. The traversal
(``graph_expand``, reference fdb/FdbVectorIndex.java:911-968 BEST_FIRST,
:841-903 BEAM) keeps each query's priority queue as a fixed-size,
distance-sorted candidate pool of dense tensors; each step

  1. selects the best ``beam`` unexpanded candidates (masked top-k),
  2. gathers their adjacency rows,
  3. reads the neighbours' ADC distances from the full-scan matrix the
     seeds came from,
  4. dedups them (within the step by sorting, against the pool by
     binary search in the sorted pool),
  5. merges them into the pool with one top-k.

There is no visited set: the pool's contents improve monotonically, so a
node evicted from the pool was worse than everything in it and can never
re-enter or be expanded again; a revisit of an evicted node costs one
redundant distance read. The legacy BEAM mode is the same loop with
``refine_frontier=False`` (expand only what the previous step found) and
``min_steps`` (the reference's minHops floor).

The JAX package's ``lax.while_loop`` is a host loop here with one read of
its condition a step. That is exact: the loop ends at the first step whose
condition is false, as the while loop does.
"""

from __future__ import annotations

import torch

INF = float("inf")
_BIG = 2**30


def _dedup_within_step(ids: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    """Keeps only the first occurrence (by position) of each id among the
    ``new`` entries of a row: ids i32[Q, C], new bool[Q, C] -> bool[Q, C]."""
    keyed = torch.where(new, ids, _BIG)
    order = torch.argsort(keyed, dim=1, stable=True)
    sorted_ids = torch.gather(keyed, 1, order)
    first = torch.cat([
        torch.ones_like(sorted_ids[:, :1], dtype=torch.bool),
        sorted_ids[:, 1:] != sorted_ids[:, :-1],
    ], dim=1) & (sorted_ids < _BIG)
    # back to the original positions
    out = torch.empty_like(first).scatter_(1, order, first)
    return out & new


def graph_expand(
    approx: torch.Tensor,  # f32[Q, N] full ADC scan (inf at invalid rows)
    adjacency: torch.Tensor,  # i32[N', R] (-1 padded)
    row_valid: torch.Tensor,  # bool[N] rows that exist (unread: validity
    #   rides in approx, as in the JAX package)
    seed_idx: torch.Tensor,  # i32[Q, S] (-1 padded)
    seed_dist: torch.Tensor,  # f32[Q, S] ADC distances of the seeds
    ef_dyn,  # int or i32[Q]: effective ef per query row
    beam_dyn,  # int or i32[Q]: effective beam width per query row
    adj_row_offset: torch.Tensor | None = None,  # i32[Q]: added to node ids
    #   when gathering adjacency, so stacked (query, segment) rows share one
    #   flattened [S*N, R] table while keeping segment-local ids
    *,
    ef_buf: int,  # candidate-pool size >= ef_dyn
    beam_buf: int,  # max frontier width >= beam_dyn
    max_steps: int,
    min_steps: int = 0,
    refine_frontier: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Expands the graph frontier -> (cand_idx i32[Q, ef_buf], cand_dist
    f32[Q, ef_buf]) ascending by approximate distance, -1 / inf pads.
    ``graph_expand.steps`` counts the steps taken (expansions of the whole
    batch)."""
    q, s = seed_idx.shape
    r = adjacency.shape[1]
    n = approx.shape[1]
    c = beam_buf * r  # neighbours gathered a step
    dev = approx.device
    ef_vec = torch.as_tensor(ef_dyn, dtype=torch.int32, device=dev).expand(q)
    beam_vec = torch.as_tensor(beam_dyn, dtype=torch.int32, device=dev).expand(q)

    # ---- the pool starts from the seeds, deduplicated ----
    seed_ok = _dedup_within_step(seed_idx, seed_idx >= 0)
    seed_d = torch.where(seed_ok, seed_dist, INF)
    seed_i = torch.where(seed_ok, seed_idx, -1)
    pool = min(s, ef_buf)
    if s > ef_buf:  # keep the best seeds if oversupplied
        neg, keep = torch.topk(-seed_d, ef_buf, dim=1)
        seed_d = -neg
        seed_i = torch.gather(seed_i, 1, keep)
    cand_idx = torch.full((q, ef_buf), -1, dtype=torch.int32, device=dev)
    cand_idx[:, :pool] = seed_i[:, :pool]
    cand_d = torch.full((q, ef_buf), INF, device=dev)
    cand_d[:, :pool] = seed_d[:, :pool]
    cand_d = torch.where(cand_idx >= 0, cand_d, INF)
    expanded = torch.zeros((q, ef_buf), dtype=torch.bool, device=dev)
    fresh = cand_idx >= 0  # seeds count as freshly discovered
    explored = torch.sum(cand_idx >= 0, dim=1, dtype=torch.int32)
    beam_iota = torch.arange(beam_buf, device=dev)[None, :]

    for step in range(max_steps):
        sel = ~expanded & (cand_idx >= 0)
        if not refine_frontier:
            sel = sel & fresh
        go = torch.any(sel & (explored < ef_vec)[:, None])
        if step < min_steps:
            go = go | torch.any(sel)
        if not bool(go):
            break
        _counted.steps += 1
        active_q = (explored < ef_vec) | (step < min_steps)
        sel_score = torch.where(sel, -cand_d, -INF)
        top_score, pos = torch.topk(sel_score, beam_buf, dim=1)  # [Q, beam_buf]
        valid_sel = (
            (top_score > -INF) & (beam_iota < beam_vec[:, None]) & active_q[:, None]
        )
        # topk positions are distinct in a row
        expanded = expanded | torch.zeros_like(expanded).scatter_(1, pos, valid_sel)

        node = torch.clamp(torch.gather(cand_idx, 1, pos), min=0)  # [Q, beam_buf]
        if adj_row_offset is not None:
            node = node + adj_row_offset[:, None]
        nbrs = adjacency[node.long()].reshape(q, c)  # [Q, C]
        # one value sort: the within-step dedup, the pool check, the
        # distance gather and the merge all work in sorted order (the merge's
        # top-k does not care about order)
        keyed = torch.where(
            (nbrs >= 0) & valid_sel.repeat_interleave(r, dim=1), nbrs, _BIG
        )
        sorted_ids = torch.sort(keyed, dim=1).values
        first = torch.cat([
            torch.ones((q, 1), dtype=torch.bool, device=dev),
            sorted_ids[:, 1:] != sorted_ids[:, :-1],
        ], dim=1)
        new = first & (sorted_ids < _BIG)
        # dedup against the pool: a node in the pool was already visited;
        # one evicted from it was worse than the whole pool (module docstring)
        # sorted pool + batched binary search at every size: the JAX
        # package's broadcast compare (while ef_buf * C <= 2^22), which XLA
        # fuses, would build a [Q, C, ef_buf] bool tensor here
        pool_ids = torch.where(cand_idx >= 0, cand_idx, -2)
        sorted_pool = torch.sort(pool_ids, dim=1).values
        spos = torch.searchsorted(sorted_pool, sorted_ids)
        spos = torch.clamp(spos, max=ef_buf - 1)
        in_pool = torch.gather(sorted_pool, 1, spos) == sorted_ids
        new = new & ~in_pool

        # row validity rides in approx (invalid rows are +inf)
        nbr_dist = torch.gather(approx, 1, torch.clamp(sorted_ids, max=n - 1).long())
        new = new & torch.isfinite(nbr_dist)
        new_d = torch.where(new, nbr_dist, INF)
        new_ids = torch.where(new, sorted_ids, -1)
        # every first visit counts, as the reference's `chosen` list
        # (:948-963)
        explored = explored + torch.sum(new, dim=1, dtype=torch.int32)

        all_idx = torch.cat([cand_idx, new_ids], dim=1)
        all_d = torch.cat([cand_d, new_d], dim=1)
        all_exp = torch.cat([expanded, torch.zeros_like(new)], dim=1)
        all_fresh = torch.cat([torch.zeros_like(expanded), new], dim=1)
        neg_top, keep = torch.topk(-all_d, ef_buf, dim=1)
        cand_d = -neg_top
        cand_idx = torch.gather(all_idx, 1, keep)
        expanded = torch.gather(all_exp, 1, keep)
        fresh = torch.gather(all_fresh, 1, keep)
        cand_idx = torch.where(torch.isfinite(cand_d), cand_idx, -1)
    return cand_idx, cand_d


graph_expand.steps = 0
_counted = graph_expand  # the counter's owner, whatever the name is bound to


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
