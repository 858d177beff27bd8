"""Product Quantization ops: codebook training, encoding, LUT build, ADC scan.

Mirrors ``vectorsearch_tpu/ops/pq.py`` (reference: pq/PqTrainer.java:14-96,
pq/PqEncoder.java:8-38, fdb/FdbVectorIndex.java:1057-1079):

- ``pq_train``: per-subspace Lloyd's k-means. The assign step is a pairwise
  distance product + argmin per subspace; the update step is one
  accumulating ``index_put_`` over all subspaces (the JAX package's one-hot
  matmul is a device for the TPU's matrix unit, ``pq.py:85-95``). On the
  card ``index_put_`` sorts its indices and sums each cluster in row order,
  so a training is reproducible bit for bit (``index_add_`` sums with
  float atomics, in whatever order they land).
- ``pq_encode``: nearest centroid per subspace -> one byte per subspace.
- ``build_lut``: per-query M x K table of subspace squared-L2 distances.
- ``adc_lookup`` / ``adc_scan``: approximate distance = sum over subspaces of
  the LUT entries the byte codes select, in full f32 (the function of the
  JAX package's XLA formulation).
- ``adc_scan_auto`` / ``adc_scan_scores_auto`` / ``adc_pool_auto``: the
  search-path dispatchers over ``ops/adc.py``'s kernels (a CUDA tensor
  launches the hand-written kernel, a CPU tensor runs its plain version);
  ``build_luts`` / ``adc_pools_auto`` serve a group of segments in batched
  calls, each segment still pooled on its own.

Intended differences from the JAX package (ROADMAP.md Queue C):
- ``pq_train`` draws its random rows from a ``torch.Generator`` seeded from
  ``pq_train_seed``; it cannot give ``jax.random``'s rows, so codebooks match
  the JAX package's statistically, not bit for bit;
- the dispatchers route by shape alone, on both devices: the JAX package's
  backend test, VMEM budget and ``M >= 8, M*K >= 1024`` gate are TPU layout
  constraints. So ``adc_scan_auto`` always takes the bf16-LUT kernel (the
  JAX package's CPU path sums the f32 LUT), and ``adc_pool_auto`` takes the
  binned pool at N >= 16,384 rows with bins covering ``ef_buf``;
- ``adc_pool_auto``'s stage 2 is an exact ``torch.topk`` where the JAX
  package takes ``approx_max_k`` at recall target 0.95 (never worse).
"""

from __future__ import annotations

import torch

from vectorsearch_torch.ops import adc as adc_ops
from vectorsearch_torch.ops.distance import full_f32
from vectorsearch_torch.ops.exact import pool_topk

INF = float("inf")


def _split_subspaces(x: torch.Tensor, m: int) -> torch.Tensor:
    """f32[N, D] -> f32[M, N, D/M] (subspace-major)."""
    n, d = x.shape
    return x.reshape(n, m, d // m).permute(1, 0, 2)


def _assign(sub_x: torch.Tensor, cent: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Nearest centroid per row: sub_x f32[N, s], cent f32[K, s] -> i64[N];
    invalid rows are assigned -1 so they join no cluster. The product is
    full f32 (the JAX package's Precision.HIGHEST); ties keep the first
    centroid, as jnp.argmin does."""
    x_sq = torch.sum(sub_x * sub_x, dim=-1, keepdim=True)
    c_sq = torch.sum(cent * cent, dim=-1)[None, :]
    with full_f32():
        cross = sub_x @ cent.T
    a = torch.argmin(x_sq + c_sq - 2.0 * cross, dim=-1)
    return torch.where(valid, a, -1)


def _assign_all(subs: torch.Tensor, cent: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """_assign per subspace -> i64[M, N]. One subspace at a time bounds the
    [N, K] distance block (a [M, N, K] block is 1.6 GB at a 100k-row
    segment with M = 16, K = 256)."""
    return torch.stack([_assign(subs[j], cent[j], valid) for j in range(subs.shape[0])])


def pq_train(
    vectors: torch.Tensor,  # f32[N, D] (padded; pads masked out by `valid`)
    valid: torch.Tensor,  # bool[N]
    m: int,
    k: int,
    iters: int,
    generator: torch.Generator,  # on the vectors' device, seeded by the caller
) -> torch.Tensor:
    """Trains an M-subspace PQ codebook with Lloyd's k-means -> f32[M, K, D/M].

    K random valid rows are the initial centroids, shared across subspaces
    (like sampling K training points); ``iters`` Lloyd steps follow; a
    cluster left empty is re-seeded from a random valid row in each step
    (reference: pq/PqTrainer.java:28-91)."""
    n, d = vectors.shape
    sub = d // m
    dev = vectors.device
    subs = _split_subspaces(vectors.float(), m)  # [M, N, sub]
    valid = valid.to(dev, torch.bool)

    def random_valid_rows() -> torch.Tensor:
        # K distinct random valid rows: random scores, -inf at invalid rows,
        # top-k (pad rows only when fewer than K rows are valid). With N < K
        # rows repeat modularly; duplicate centroids are harmless (argmin
        # keeps the first).
        scores = torch.rand(n, generator=generator, device=dev)
        scores = torch.where(valid, scores, -INF)
        take = min(n, k)
        idx = torch.topk(scores, take).indices
        if take < k:
            idx = idx[torch.arange(k, device=dev) % take]
        return idx

    cent = subs[:, random_valid_rows(), :]  # [M, K, sub]
    slot = torch.arange(m, device=dev)[:, None] * (k + 1)  # [M, 1]
    for _ in range(iters):
        a = _assign_all(subs, cent, valid)  # [M, N]
        # invalid rows (-1) land in a spare slot K of their subspace
        flat = (torch.where(a >= 0, a, k) + slot).reshape(-1)
        sums = torch.zeros(m * (k + 1), sub, device=dev).index_put_(
            (flat,), subs.reshape(m * n, sub), accumulate=True
        ).view(m, k + 1, sub)[:, :k]
        counts = torch.bincount(flat, minlength=m * (k + 1)).view(m, k + 1)[:, :k]
        reseed = subs[:, random_valid_rows(), :]
        cent = torch.where(
            (counts > 0)[:, :, None],
            sums / torch.clamp(counts, min=1)[:, :, None],
            reseed,
        )
    return cent


def pq_encode(vectors: torch.Tensor, codebook: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """vectors f32[N, D], codebook f32[M, K, D/M] -> u8[N, M] (reference:
    pq/PqEncoder.java:18-37). Invalid rows encode to code 0 (every search
    masks them out)."""
    m = codebook.shape[0]
    subs = _split_subspaces(vectors.float(), m)
    a = _assign_all(subs, codebook.float(), valid.to(vectors.device, torch.bool))
    return torch.where(a < 0, 0, a).to(torch.uint8).T.contiguous()


def build_lut(q: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """q f32[Q, D], codebook f32[M, K, s] -> f32[Q, M, K] with
    lut[q, m, c] = ||q_sub_m - centroid[m, c]||^2, clamped at 0
    (reference: fdb/FdbVectorIndex.java:1067-1079). Full f32 product."""
    return build_luts(q, codebook[None])[0]


def build_luts(q: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """``build_lut`` for S codebooks f32[S, M, K, s] at once -> f32[S, Q, M, K]
    (one batched product for a group of segments)."""
    qn = q.shape[0]
    s_count, m, k, sub = codebooks.shape
    cb = codebooks.float()
    q_subs = q.float()[:, : m * sub].reshape(qn, m, sub)  # [Q, M, s]
    q_sq = torch.sum(q_subs * q_subs, dim=-1)[:, :, None]  # [Q, M, 1]
    c_sq = torch.sum(cb * cb, dim=-1)[:, None, :, :]  # [S, 1, M, K]
    with full_f32():
        cross = torch.bmm(  # [S*M, Q, K]
            q_subs.transpose(0, 1).repeat(s_count, 1, 1),
            cb.reshape(s_count * m, k, sub).transpose(1, 2),
        )
    cross = cross.view(s_count, m, qn, k).transpose(1, 2)  # [S, Q, M, K]
    return torch.clamp(q_sq + c_sq - 2.0 * cross, min=0.0)


def adc_lookup(lut: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """ADC distance of a gathered subset of codes: lut f32[Q, M, K], codes
    u8/int[Q, C, M] -> f32[Q, C] (reference: FdbVectorIndex.pqApproxDistance
    :1057-1065)."""
    idx = codes.long().permute(0, 2, 1)  # [Q, M, C]
    return torch.gather(lut.float(), 2, idx).sum(dim=1)


def adc_scan(lut: torch.Tensor, codes: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Full ADC scan with the f32 LUT -> f32[Q, N], +inf at invalid rows
    (the function of the JAX package's XLA formulation; the search path
    takes the bf16-LUT kernels through the *_auto dispatchers)."""
    return torch.where(valid[None, :], adc_ops._lut_sums(lut, codes), INF)


def adc_scan_auto(lut: torch.Tensor, codes: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Full ADC distances f32[Q, N] (+inf at invalid rows) through the
    one-pass bf16-LUT kernel (B5-fast; its plain version on a CPU tensor)."""
    return adc_ops.adc_scan_kernel(lut, codes, valid)


def adc_scan_scores_auto(lut: torch.Tensor, codes: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Flat-path scan: NEGATED ADC scores bf16[Q, N_pad] (higher = closer),
    -inf at invalid rows and at the pad columns past N (B4)."""
    return adc_ops.adc_scan_scores(lut, codes, valid)


def adc_pool_auto(
    lut: torch.Tensor,  # f32[Q, M, K]
    codes: torch.Tensor,  # u8[N, M]
    valid: torch.Tensor,  # bool[N]
    *,
    ef_buf: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Flat-path candidate pool: (negated ADC scores f32[Q, ef_buf], row ids
    i32[Q, ef_buf]), -inf / -1 in empty slots, descending by score. At
    N >= 16,384 rows with bins covering ef_buf it is the binned pool (B3):
    the [Q, N] score matrix never exists. Below that it is the scores scan
    (B4) and an exact top-k."""
    neg, idx = adc_pools_auto(lut[None], [codes], [valid], ef_buf=ef_buf)
    return neg[0], idx[0]


def adc_pools_auto(
    luts: torch.Tensor,  # f32[S, Q, M, K]
    codes: list,  # S tables u8[N, M]
    valids: list,  # S masks bool[N]
    *,
    ef_buf: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``adc_pool_auto`` for S same-capacity segments, each pooled on its
    own -> (f32[S, Q, ef_buf], i32[S, Q, ef_buf]): the LUTs round to bf16
    once, each segment's kernel writes its slice of one plane, and one
    stage-2 top-k serves them all."""
    s_count, qn = luts.shape[:2]
    lut_h = adc_ops.lut_bf16(luts)
    if adc_ops.use_fused_adc_pool(codes[0].shape[0], ef_buf):
        outs, outi = adc_ops.adc_bin_pools(lut_h, codes, valids,
                                           min_w=max(16384, 4 * ef_buf))
        top, idx = pool_topk(outs.view(s_count * qn, -1),
                             outi.view(s_count * qn, -1), ef_buf)
        return top.view(s_count, qn, ef_buf), idx.view(s_count, qn, ef_buf)
    neg = adc_ops.adc_scores_many(lut_h, codes, valids)
    top, idx = torch.topk(neg, min(ef_buf, neg.shape[2]), dim=2)
    top = top.float()
    if idx.shape[2] < ef_buf:
        pad = ef_buf - idx.shape[2]
        top = torch.nn.functional.pad(top, (0, pad), value=-INF)
        idx = torch.nn.functional.pad(idx, (0, pad))
    ok = top > -INF
    return torch.where(ok, top, -INF), torch.where(ok, idx.to(torch.int32), -1)


def zero_codebook(m: int, k: int, sub_dim: int, device=None) -> torch.Tensor:
    """Zero-codebook fallback for empty-segment builds
    (reference: tasks/SegmentBuildService.java:143-157)."""
    return torch.zeros((m, k, sub_dim), dtype=torch.float32, device=device)
