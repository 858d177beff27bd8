"""The port's ops (vectorsearch_torch/ops) held against the JAX package's
(vectorsearch_tpu/ops) on the same numpy inputs: distances, exact_finalize,
brute_force_topk (both routes), merge_topk and exact_rerank (one segment, and
several at once), plus the pool geometry.

Tolerances: distance matrices 1e-4 relative / 1e-4 absolute (both are f32
products, summed in different orders); final distances as in the JAX tests
(L2 rtol 3e-3 / atol 3e-3, cosine atol 2e-4). Ids are compared on
margin-separated data, where no tie can flip.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from vectorsearch_tpu.ops import distance as jd
from vectorsearch_tpu.ops import topk as jtk
from vectorsearch_tpu.ops import traversal as jtr
from vectorsearch_tpu.ops.pallas import exact as pe
from vectorsearch_torch.ops import distance as td
from vectorsearch_torch.ops import exact as te
from vectorsearch_torch.ops import topk as ttk
from vectorsearch_torch.ops import traversal as ttr


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(port, ref, rtol=1e-4, atol=1e-4):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=rtol, atol=atol)


def test_vector_distances_match_jax(rng):
    a = rng.normal(size=(5, 12)).astype(np.float32)
    b = rng.normal(size=(5, 12)).astype(np.float32)
    b[2] = 0.0  # zero norm: cosine 0 by the reference convention
    for fname in ("l2_squared", "l2", "dot", "cosine"):
        _close(getattr(td, fname)(_t(a), _t(b)),
               getattr(jd, fname)(jnp.asarray(a), jnp.asarray(b)))
    _close(td.norm(_t(a)), jd.norm(jnp.asarray(a)))
    assert float(td.cosine(_t(a[2]), _t(b[2]))) == 0.0


@pytest.mark.parametrize("metric", ["L2", "COSINE"])
def test_pairwise_distances_match_jax(rng, metric):
    q = rng.normal(size=(7, 24)).astype(np.float32)
    x = rng.normal(size=(50, 24)).astype(np.float32)
    x[3] = 0.0
    valid = rng.random(50) > 0.2
    _close(td.pairwise_l2_squared(_t(q), _t(x)),
           jd.pairwise_l2_squared(jnp.asarray(q), jnp.asarray(x)))
    _close(td.pairwise_cosine(_t(q), _t(x)),
           jd.pairwise_cosine(jnp.asarray(q), jnp.asarray(x)))
    import jax

    _close(
        td.pairwise_rank_scores(_t(q), _t(x), _t(valid), metric),
        jd.pairwise_rank_scores(jnp.asarray(q), jnp.asarray(x),
                                jnp.asarray(valid), metric,
                                precision=jax.lax.Precision.HIGHEST),
    )
    ps, pd = td.scores_from_distances(metric, _t(q), _t(x))
    js, jdd = jd.scores_from_distances(metric, jnp.asarray(q), jnp.asarray(x))
    _close(ps, js)
    _close(pd, jdd)


def test_full_f32_products_switch_tf32_off(rng):
    """TF32 is off while the port's product runs, and the caller's own
    setting is back afterwards."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        with td.full_f32():
            assert not torch.backends.cuda.matmul.allow_tf32
            assert not torch.backends.cudnn.allow_tf32
        assert torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.allow_tf32
        td.pairwise_l2_squared(_t(rng.normal(size=(2, 4)).astype(np.float32)),
                               _t(rng.normal(size=(3, 4)).astype(np.float32)))
        assert torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.allow_tf32
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


@pytest.mark.parametrize("metric", ["L2", "COSINE"])
def test_exact_finalize_matches_jax_and_pads(rng, metric):
    q = rng.normal(size=(4, 16)).astype(np.float32)
    q[3] = 0.0  # zero-norm query: cosine 0 by the reference convention
    x = rng.normal(size=(40, 16)).astype(np.float32)
    s = np.asarray(jd.pairwise_rank_scores(
        jnp.asarray(q), jnp.asarray(x), jnp.ones(40, bool), metric))
    pool_idx = np.tile(np.arange(12, dtype=np.int32), (4, 1))
    pool_idx[:, 8:] = -1  # empty slots
    pool_s = np.take_along_axis(s, np.maximum(pool_idx, 0), 1).astype(np.float32)
    for k in (5, 10, 99):  # k > pool width truncates to the width
        j = jtr.exact_finalize(jnp.asarray(q), jnp.asarray(pool_s),
                               jnp.asarray(pool_idx), k, metric)
        p = ttr.exact_finalize(_t(q), _t(pool_s), _t(pool_idx), k, metric)
        assert p[0].shape == (4, min(k, 12))
        np.testing.assert_array_equal(p[2].numpy()[:3], np.asarray(j[2])[:3])
        # the zero query ties every live candidate: any of them may win
        row3 = p[2].numpy()[3]
        assert set(row3[row3 >= 0].tolist()) <= set(range(8))
        assert (row3 >= 0).sum() == min(k, 8)
        _close(p[0], j[0], rtol=0, atol=2e-4)
        _close(p[1], j[1], rtol=0, atol=2e-4)
        if k > 8:
            assert (p[2].numpy()[:, 8:] == -1).all()
            assert np.isinf(p[1].numpy()[:, 8:]).all()
            assert (p[0].numpy()[:, 8:] == -np.inf).all()


@pytest.mark.parametrize("metric", ["L2", "COSINE"])
def test_brute_force_topk_small_matches_jax(rng, metric):
    n, d, qn, k = 300, 16, 6, 7
    x = rng.normal(size=(n, d)).astype(np.float32)
    q = x[:qn] + 0.01 * rng.normal(size=(qn, d)).astype(np.float32)
    valid = np.ones(n, bool)
    valid[rng.integers(0, n, 30)] = False
    j = jtk.brute_force_topk(jnp.asarray(q), jnp.asarray(x), jnp.asarray(valid),
                             k, metric)
    p = ttk.brute_force_topk(_t(q), _t(x), _t(valid), k, metric)
    np.testing.assert_array_equal(p[2].numpy(), np.asarray(j[2]))
    _close(p[0], j[0], rtol=1e-5, atol=2e-5)
    _close(p[1], j[1], rtol=1e-5, atol=2e-5)
    assert p[2].dtype == torch.int32


def test_brute_force_topk_k_above_n_pads_like_jax(rng):
    x = rng.normal(size=(5, 8)).astype(np.float32)
    valid = np.array([1, 1, 0, 1, 1], bool)
    q = x[:2]
    j = jtk.brute_force_topk(jnp.asarray(q), jnp.asarray(x), jnp.asarray(valid), 9)
    p = ttk.brute_force_topk(_t(q), _t(x), _t(valid), 9)
    assert p[0].shape == (2, 9)
    np.testing.assert_array_equal(p[2].numpy(), np.asarray(j[2]))
    np.testing.assert_array_equal(np.isinf(p[1].numpy()), np.isinf(np.asarray(j[1])))


def _blocked_clusters(rng, n, d, qn, block=64, spread=20.0):
    """Rows in contiguous blocks of `block` around well-separated centers;
    queries near block centers. A query's true top-k lie in one block of
    fewer rows than the pool has bins, so they land in distinct bins and the
    binned pool loses none of them."""
    n_blocks = n // block
    centers = rng.normal(size=(n_blocks, d)) * spread
    x = np.repeat(centers, block, axis=0) + rng.normal(size=(n, d))
    pick = rng.integers(0, n_blocks, qn)
    q = centers[pick] + 0.5 * rng.normal(size=(qn, d))
    return x.astype(np.float32), q.astype(np.float32)


@pytest.mark.parametrize("metric", ["L2", "COSINE"])
def test_brute_force_topk_fused_route_matches_jax(rng, metric):
    """At MIN_ROWS rows the port takes the binned pool (on the card: the
    CUDA kernel) where the JAX package on the CPU takes its exact top-k; on
    data with no bin collisions among the true top-k both give the same
    answer."""
    n, d, qn, k = te.MIN_ROWS, 16, 12, 10
    assert te.use_fused_exact_pool(n, d, 64)
    x, q = _blocked_clusters(rng, n, d, qn)
    valid = np.ones(n, bool)
    valid[rng.integers(0, n, 200)] = False
    j = jtk.brute_force_topk(jnp.asarray(q), jnp.asarray(x), jnp.asarray(valid),
                             k, metric)
    p = ttk.brute_force_topk(_t(q), _t(x), _t(valid), k, metric)
    np.testing.assert_array_equal(p[2].numpy(), np.asarray(j[2]))
    if metric == "COSINE":
        _close(p[0], j[0], rtol=0, atol=2e-4)
        _close(p[1], j[1], rtol=0, atol=2e-4)
    else:
        _close(p[1], j[1], rtol=3e-3, atol=3e-3)


def test_brute_force_topk_fused_route_calls_pool(rng, monkeypatch):
    """The >= MIN_ROWS route goes through exact_pool_scored with the pool
    oversampled 4x past k (the JAX package's contract)."""
    seen = {}
    orig = te.exact_pool_scored

    def spy(*a, ef_buf, **kw):
        seen["ef_buf"] = ef_buf
        return orig(*a, ef_buf=ef_buf, **kw)

    monkeypatch.setattr(te, "exact_pool_scored", spy)
    x, q = _blocked_clusters(rng, te.MIN_ROWS, 8, 2)
    ttk.brute_force_topk(_t(q), _t(x), torch.ones(te.MIN_ROWS, dtype=torch.bool), 10)
    assert seen["ef_buf"] >= 40


def test_merge_topk_matches_jax(rng):
    s1 = -np.sort(-rng.normal(size=(3, 4)).astype(np.float32), axis=1)
    s2 = -np.sort(-rng.normal(size=(3, 6)).astype(np.float32), axis=1)
    i1 = rng.integers(0, 100, size=(3, 4)).astype(np.int32)
    i2 = rng.integers(100, 200, size=(3, 6)).astype(np.int32)
    for k in (5, 20):
        js, ji = jtk.merge_topk([jnp.asarray(s1), jnp.asarray(s2)],
                                [jnp.asarray(i1), jnp.asarray(i2)], k)
        ps, pi = ttk.merge_topk([_t(s1), _t(s2)], [_t(i1), _t(i2)], k)
        np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
        np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))


@pytest.mark.parametrize(
    "qn,d,n,tile,fold,min_w",
    [
        (512, 128, 800_768, None, None, 16384),   # sift1m 8-segment group
        (512, 128, 200_192, None, None, 16384),   # sift1m 2-segment group
        (512, 128, 100_096, None, None, 16384),   # one sift1m segment
        (16, 16, 16_384, None, None, 16384),
        (3, 96, 4_000_000, None, None, 16384),
        (8, 32, 1_659, 512, 2, 16384),
        (8, 768, 50_000, None, None, 1024),
    ],
)
def test_stage1_geometry_matches_jax(qn, d, n, tile, fold, min_w):
    # the JAX tuple is (qp, tile, chunk, bins, n_tiles, fold, W); the port
    # keeps the four that decide which rows share a bin
    _qp, j_tile, _chunk, j_bins, _nn, j_fold, j_w = pe._stage1_params(
        qn, d, n, tile, fold, min_w
    )
    assert te._stage1_params(qn, d, n, tile, fold, min_w) == (
        j_tile, j_bins, j_fold, j_w
    )


def test_sift1m_geometry():
    """The shapes the main path gives the kernel: tile 2048, 256 bins,
    fold 8 (800k rows) or 2 (200k rows), W = 12,544."""
    assert te._stage1_params(512, 128, 800_768, None, None, 16384) == (
        2048, 256, 8, 12_544)
    assert te._stage1_params(512, 128, 200_192, None, None, 16384) == (
        2048, 256, 2, 12_544)


def test_requested_tile_invariants_match_jax():
    for req in (2560, 2048, 1024, 512, 4096):
        assert te._auto_tile(512, 128, req) == pe._auto_tile(512, 128, req)[0]
    with pytest.raises(ValueError):
        te._auto_tile(512, 128, 2176)


def test_use_fused_gating():
    assert not te.use_fused_exact_pool(1000, 128, 32)  # too few rows
    # no backend test: the CPU takes the binned route too
    assert te.use_fused_exact_pool(1_000_000, 128, 32)
    assert te.use_fused_exact_pool(te.MIN_ROWS, 16, 512)
    assert not te.use_fused_exact_pool(te.MIN_ROWS, 16, 513)


def _rerank_case(rng, n=300, d=12, qn=7, c=20):
    x = rng.normal(size=(n, d)).astype(np.float32)
    x[5] = 0.0  # a zero-norm row (cosine similarity 0)
    q = rng.normal(size=(qn, d)).astype(np.float32)
    alive = rng.random(n) > 0.2
    cand = rng.integers(0, n, (qn, c)).astype(np.int32)
    cand[:, -3:] = -1
    cand[0, :4] = 5
    return x, q, alive, cand


@pytest.mark.parametrize("metric", ["L2", "COSINE"])
def test_exact_rerank_matches_jax(rng, metric):
    """Scores and distances 1e-5 relative (f32 sums of the same terms, in
    other orders); -inf / +inf / -1 padding at -1 slots and tombstones."""
    x, q, alive, cand = _rerank_case(rng)
    got = ttr.exact_rerank(_t(q), _t(x), _t(alive), _t(cand), 10, metric)
    want = jtr.exact_rerank(jnp.asarray(q), jnp.asarray(x), jnp.asarray(alive),
                            jnp.asarray(cand), 10, metric)
    (gs, gd, gi), (ws, wd, wi) = (tuple(np.asarray(t) for t in r) for r in (got, want))
    np.testing.assert_allclose(gs, ws, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(gd, wd, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(gi == -1, wi == -1)
    # ids agree wherever the score has no near neighbour in its row
    sep = np.ones_like(gs, bool)
    gap = np.abs(np.diff(ws, axis=1)) > 1e-5
    sep[:, 1:] &= gap
    sep[:, :-1] &= gap
    np.testing.assert_array_equal(gi[sep], wi[sep])
    assert alive[gi[gi >= 0]].all()


def test_exact_rerank_segments_equals_each_segment_alone(rng):
    """Several segments re-ranked in one call: each segment's result is the
    one exact_rerank gives it alone, bit for bit."""
    cases = [_rerank_case(rng) for _ in range(3)]
    q = _t(cases[0][1])
    cand = torch.stack([_t(c[3]) for c in cases])
    tables = [(_t(c[0]), _t(c[2])) for c in cases]
    for metric in ("L2", "COSINE"):
        got = ttr.exact_rerank_segments(q, tables, cand, 8, metric)
        assert got[0].shape == (3, q.shape[0], 8)
        for i, (x, alive) in enumerate(tables):
            alone = ttr.exact_rerank(q, x, alive, cand[i], 8, metric)
            for a, b in zip(got, alone):
                assert torch.equal(a[i], b)
