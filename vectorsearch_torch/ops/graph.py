"""Neighbour-graph construction (reference: graph/GraphBuilder.java:28-342).

Mirrors ``vectorsearch_tpu/ops/graph.py``: the CAGRA-style batch build that
replaces the reference's sequential Vamana insertion (see PAPERS.md):

1. top-L candidate lists for every node from blocked pairwise distances and
   a top-k (``knn_candidates``); from ``FUSED_KNN_MIN_ROWS`` rows on, the
   blocks go through the binned exact pool (B1 on the card, B2 from
   2,000,000 rows) and an exact re-rank of its pool (``_knn_block_fused``);
2. RobustPrune over all nodes at once: per node, select the nearest
   surviving candidate and kill every candidate c with
   d2(c, selected) <= alpha * d2(c, node) (graph/GraphBuilder.java:306-327,
   squared distances, alpha on squared values);
3. reverse-edge merge: each forward edge i->j proposes i as a neighbour of
   j; nodes whose union exceeds the degree are pruned again (reference
   :175-187, one batched pass).

``alpha <= 1.0`` keeps plain kNN edges, the reference's strategy switch
(tasks/SegmentBuildService.java:207-209).

Intended differences from the JAX package (ROADMAP.md Queue C):
- ``_knn_block`` takes an exact ``torch.topk`` where the JAX package takes
  ``approx_max_k`` at recall target 0.95 (never worse; on the CPU XLA
  computes the exact top-k anyway);
- the fused kNN route is chosen by row count alone: no backend test, so
  the CPU and the card take one route;
- RobustPrune's ``fori_loop`` over the degree is a Python loop of tensor
  operations.
"""

from __future__ import annotations

import numpy as np
import torch

from vectorsearch_torch.ops import exact as exact_ops
from vectorsearch_torch.ops.distance import full_f32, pairwise_l2_squared

INF = float("inf")

# Above this row count the [B, N] distance block of _knn_block is the
# build's bottleneck; the binned pool keeps the score tiles on chip. The
# JAX package's threshold, kept so both packages route alike.
FUSED_KNN_MIN_ROWS = 262_144


def find_medoid(vectors: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Index of the valid vector closest to the centroid of the valid
    vectors (reference: GraphBuilder.findMedoid :200-226) -> i64 scalar."""
    v = vectors.float()
    w = valid.float()[:, None]
    centroid = torch.sum(v * w, dim=0) / torch.clamp(torch.sum(w), min=1.0)
    d2 = torch.sum(torch.square(v - centroid[None, :]), dim=-1)
    return torch.argmin(torch.where(valid, d2, INF))


def _knn_block(
    block_vecs: torch.Tensor,  # f32[B, D]
    block_ids: torch.Tensor,  # i32[B] global row ids of the block
    vectors: torch.Tensor,  # f32[N, D]
    valid: torch.Tensor,  # bool[N]
    l: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The block's exact top-l neighbours (self excluded) from one full-f32
    [B, N] distance block -> (ids i32[B, l], d2 f32[B, l]), ascending, -1 /
    inf where fewer than l rows are valid."""
    d2 = pairwise_l2_squared(block_vecs, vectors)  # full f32 (matmul_nt)
    col = torch.arange(vectors.shape[0], device=vectors.device)
    mask = valid[None, :] & (col[None, :] != block_ids[:, None])
    d2 = torch.where(mask, d2, INF)
    top_d2, idx = torch.topk(d2, l, dim=1, largest=False, sorted=True)
    idx = torch.where(torch.isfinite(top_d2), idx, -1)
    return idx.to(torch.int32), top_d2


def _knn_block_fused(
    block_vecs: torch.Tensor,  # f32[B, D]
    block_ids: torch.Tensor,  # i32[B]
    vectors: torch.Tensor,  # f32[N, D]
    valid: torch.Tensor,  # bool[N]
    l: int,
    ef: int,
    xn2: torch.Tensor | None = None,  # f32[N] norms, once per build
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-l candidates through the binned exact pool (``exact_pool_topk``:
    B1 on the card, B2 from 2,000,000 rows), then an exact f32 re-rank of
    its ef-wide pool. The [B, N] block never exists. Self rows win their bin
    (distance 0) and drop at the re-rank; a true candidate is lost only when
    it shares a bin with a closer row, which RobustPrune and the
    reverse-edge merge tolerate."""
    idx = exact_ops.exact_pool_topk(
        block_vecs, vectors, valid, ef_buf=ef, metric="L2", xn2=xn2,
    )  # i32[B, ef], -1 = empty
    cand = vectors[torch.clamp(idx, min=0).long()]  # [B, ef, D]
    diff = cand - block_vecs[:, None, :]
    d2 = torch.sum(diff * diff, dim=-1)
    d2 = torch.where((idx >= 0) & (idx != block_ids[:, None]), d2, INF)
    order = torch.argsort(d2, dim=1, stable=True)[:, :l]
    top_d2 = torch.gather(d2, 1, order)
    top_idx = torch.gather(idx, 1, order)
    return torch.where(torch.isfinite(top_d2), top_idx, -1).to(torch.int32), top_d2


def _use_fused_knn(n: int) -> bool:
    return n >= FUSED_KNN_MIN_ROWS


def knn_candidates(
    vectors: torch.Tensor,
    valid: torch.Tensor,
    l: int,
    row_block: int = 2048,
    fused: bool | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-l neighbour candidates of every row (self excluded), blocked
    over rows to bound the [B, N] distance block; from FUSED_KNN_MIN_ROWS
    rows (or ``fused=True``) through the binned pool in 512-row blocks.

    Returns (idx i32[N, l], d2 f32[N, l]) ascending by d2; -1 / inf pads."""
    n = vectors.shape[0]
    l_eff = min(l, n)
    ids = torch.arange(n, dtype=torch.int32, device=vectors.device)
    if fused is None:
        fused = _use_fused_knn(n)
    xn2 = None
    if fused:
        # 512-row blocks keep the pool's stage 2 small; the pool covers l
        # with bin-collision slack
        row_block = min(row_block, 512)
        ef = max(128, 1 << int(l_eff).bit_length())
        xn2 = torch.sum(vectors * vectors, dim=1)  # shared by every block
    idx_out, d2_out = [], []
    for start in range(0, n, row_block):
        stop = min(start + row_block, n)
        if fused:
            bi, bd = _knn_block_fused(
                vectors[start:stop], ids[start:stop], vectors, valid, l_eff,
                ef, xn2=xn2,
            )
        else:
            bi, bd = _knn_block(vectors[start:stop], ids[start:stop], vectors,
                                valid, l_eff)
        idx_out.append(bi)
        d2_out.append(bd)
    idx = torch.cat(idx_out, dim=0)
    d2 = torch.cat(d2_out, dim=0)
    if l_eff < l:
        idx = torch.nn.functional.pad(idx, (0, l - l_eff), value=-1)
        d2 = torch.nn.functional.pad(d2, (0, l - l_eff), value=INF)
    return idx, d2


def _pairwise_l2_squared_batched(v: torch.Tensor) -> torch.Tensor:
    """``pairwise_l2_squared(v[b], v[b])`` for every b: f32[B, L, D] ->
    f32[B, L, L], one batched full-f32 product."""
    sq = torch.sum(v * v, dim=-1)  # [B, L]
    with full_f32():
        cross = torch.bmm(v, v.transpose(1, 2))
    return torch.clamp(sq[:, :, None] + sq[:, None, :] - 2.0 * cross, min=0.0)


def robust_prune_block(
    vectors: torch.Tensor,  # f32[N, D] full table (for candidate gathers)
    cand_idx: torch.Tensor,  # i32[B, L] sorted ascending by d2; -1 = invalid
    cand_d2: torch.Tensor,  # f32[B, L]
    degree: int,
    alpha: float,  # on squared distances
) -> torch.Tensor:
    """RobustPrune of a block of nodes (reference: GraphBuilder.robustPrune
    :306-327) -> selected neighbour ids i32[B, degree], -1 padded, in
    selection order."""
    b, l = cand_idx.shape
    cand_vecs = vectors[torch.clamp(cand_idx, min=0).long()].float()  # [B, L, D]
    pair_d2 = _pairwise_l2_squared_batched(cand_vecs)  # [B, L, L]
    a = torch.tensor(alpha, dtype=torch.float32, device=cand_d2.device)
    limit = a * cand_d2  # f32, as the JAX package's f32 alpha * d2

    alive = (cand_idx >= 0) & torch.isfinite(cand_d2)
    pos = torch.arange(l, device=cand_idx.device)[None, :]
    out = torch.full((b, degree), -1, dtype=torch.int32, device=cand_idx.device)
    for t in range(degree):
        # first alive position per row (candidates are distance-sorted)
        has = torch.any(alive, dim=1)  # [B]
        sel_pos = torch.argmax(alive.to(torch.uint8), dim=1)  # [B]
        sel_id = torch.gather(cand_idx, 1, sel_pos[:, None])[:, 0]
        out[:, t] = torch.where(has, sel_id, -1)
        # kill candidates too close to the selected one:
        # d2(c_j, selected) <= alpha * d2(c_j, node); the selected one too
        d_to_sel = torch.gather(
            pair_d2, 2, sel_pos[:, None, None].expand(b, l, 1)
        )[:, :, 0]  # [B, L]
        kill = (d_to_sel <= limit) | (pos == sel_pos[:, None])
        alive = alive & ~kill & has[:, None]
    return out


def robust_prune(
    vectors: torch.Tensor,
    cand_idx: torch.Tensor,  # i32[N, L]
    cand_d2: torch.Tensor,  # f32[N, L]
    degree: int,
    alpha: float,
    row_block: int = 2048,
) -> torch.Tensor:
    """Blocked RobustPrune over all nodes -> adjacency i32[N, degree]."""
    n = cand_idx.shape[0]
    return torch.cat([
        robust_prune_block(vectors, cand_idx[s : s + row_block],
                           cand_d2[s : s + row_block], degree, alpha)
        for s in range(0, n, row_block)
    ], dim=0)


def _merge_reverse_edges_host(
    adj: np.ndarray,  # i32[N, R] forward adjacency, -1 padded
    rev_cap: int,
) -> np.ndarray:
    """Host-side reverse-edge candidate collection, vectorized (the JAX
    package's numpy code, unchanged).

    For every forward edge i->j, proposes i as a neighbour of j (reference
    :175-187); each node keeps up to rev_cap reverse proposals. Returns the
    union candidates i32[N, R + rev_cap], -1 padded, deduplicated per row
    (sorted by id: the caller sorts by distance before pruning)."""
    n, r = adj.shape
    src = np.repeat(np.arange(n, dtype=np.int32), r)
    dst = adj.reshape(-1)
    ok = dst >= 0
    src, dst = src[ok], dst[ok]
    # the default introsort, as the JAX package: the order within a
    # destination group selects WHICH rev_cap proposals win, so the same
    # call keeps both packages' unions identical
    order = np.argsort(dst)
    dst_s, src_s = dst[order], src[order]
    # rank of each edge within its destination group
    first = np.ones(len(dst_s), bool)
    first[1:] = dst_s[1:] != dst_s[:-1]
    idx_first = np.flatnonzero(first)
    group_id = np.cumsum(first) - 1
    rank = np.arange(len(dst_s)) - idx_first[group_id]
    keep = rank < rev_cap
    rev = np.full((n, rev_cap), -1, np.int32)
    rev[dst_s[keep], rank[keep]] = src_s[keep]

    union = np.concatenate([adj, rev], axis=1)
    # per-row dedup: sort ids; adjacent equals blank to -1
    union = np.sort(union, axis=1)
    dup = union[:, 1:] == union[:, :-1]
    union[:, 1:][dup & (union[:, 1:] >= 0)] = -1
    return union


def build_graph(
    vectors: torch.Tensor,  # f32[N, D]
    valid: torch.Tensor,  # bool[N]
    degree: int,
    l_build: int,
    alpha: float,
    row_block: int = 2048,
) -> torch.Tensor:
    """Full batch graph build -> adjacency i32[N, degree] (-1 padded) on the
    vectors' device.

    alpha <= 1.0 -> plain kNN edges; else alpha-pruned with the
    reverse-edge merge (the reference's switch,
    tasks/SegmentBuildService.java:207-209)."""
    n = vectors.shape[0]
    l = min(l_build, max(1, n - 1))
    cand_idx, cand_d2 = knn_candidates(vectors, valid, l, row_block=row_block)

    if alpha <= 1.0:
        take = min(degree, l)
        adj = cand_idx[:, :take]
        if take < degree:
            adj = torch.nn.functional.pad(adj, (0, degree - take), value=-1)
        return adj

    fwd = robust_prune(vectors, cand_idx, cand_d2, degree, alpha,
                       row_block=row_block)
    # reverse-edge merge, then the union pruned again, blocked over rows so
    # the [B, U, D] candidate gather stays bounded
    union = torch.from_numpy(
        _merge_reverse_edges_host(fwd.cpu().numpy(), rev_cap=degree)
    ).to(vectors.device)
    ids = torch.arange(n, dtype=torch.int32, device=vectors.device)
    return torch.cat([
        _union_prune_block(vectors, valid, union[s : s + row_block],
                           ids[s : s + row_block], degree, alpha)
        for s in range(0, n, row_block)
    ], dim=0)


def _union_prune_block(
    vectors: torch.Tensor,  # f32[N, D]
    valid: torch.Tensor,  # bool[N]
    union_ids: torch.Tensor,  # i32[B, U] (-1 padded, id-sorted, deduped)
    node_ids: torch.Tensor,  # i32[B]
    degree: int,
    alpha: float,
) -> torch.Tensor:
    """Distance-sorts each row's union candidates and prunes the rows that
    overflow the degree; rows that fit keep every edge (the reference
    prunes only on overflow, :181-186). Invalid nodes get no edges."""
    cand_vecs = vectors[torch.clamp(union_ids, min=0).long()]  # [B, U, D]
    node_vecs = vectors[torch.clamp(node_ids, min=0).long()]  # [B, D]
    diff = cand_vecs - node_vecs[:, None, :]
    d2 = torch.sum(diff * diff, dim=-1)
    d2 = torch.where(union_ids >= 0, d2, INF)
    order = torch.argsort(d2, dim=1, stable=True)
    ids_sorted = torch.gather(union_ids, 1, order)
    d2_sorted = torch.gather(d2, 1, order)
    pruned = robust_prune_block(vectors, ids_sorted, d2_sorted, degree, alpha)
    count = torch.sum((ids_sorted >= 0) & torch.isfinite(d2_sorted), dim=1)
    keep_all = count <= degree
    adj = torch.where(keep_all[:, None], ids_sorted[:, :degree], pruned)
    node_ok = valid[torch.clamp(node_ids, min=0).long()]
    return torch.where(node_ok[:, None], adj, -1).to(torch.int32)
