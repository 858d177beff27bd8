"""The port's PQ ops (vectorsearch_torch/ops/pq.py) held against the JAX
package's (vectorsearch_tpu/ops/pq.py) on the same numpy inputs.

Tolerances: LUT entries 1e-5 relative (both are full-f32 products of the
same expansion, summed in different orders); ADC sums 1e-5 relative (f32
sums of the same LUT entries in different orders); codes equal wherever the
best and second-best centroid of a subspace differ by more than 1e-4
relative (a closer pair may flip on the last bits of either product).
pq_train draws its random rows from a torch.Generator where the JAX package
draws them from jax.random, so the trainers are held to statistical gates
(tests/test_pq_ops.py's), and the port's quantisation error on one clustered
set to within 10% of the JAX trainer's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vectorsearch_tpu.ops import pq as jpq
from vectorsearch_torch.ops import adc as tadc
from vectorsearch_torch.ops import pq as tpq


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _clustered(rng, n_clusters=4, per=25, d=8, spread=0.05):
    centers = rng.normal(size=(n_clusters, d)).astype(np.float32) * 3
    pts = np.concatenate(
        [c + spread * rng.normal(size=(per, d)).astype(np.float32) for c in centers]
    )
    return pts.astype(np.float32), centers


def _sub_dists(x, cb):
    """f64 squared distances of every row's subvectors to every centroid:
    [M, N, K]."""
    m, k, sub = cb.shape
    xs = x.astype(np.float64).reshape(len(x), m, sub).transpose(1, 0, 2)
    return ((xs[:, :, None, :] - cb.astype(np.float64)[:, None, :, :]) ** 2).sum(-1)


def test_pq_encode_matches_jax(rng):
    n, d, m, k = 300, 32, 8, 16
    cb = rng.normal(size=(m, k, d // m)).astype(np.float32)
    x = rng.normal(size=(n, d)).astype(np.float32)
    valid = rng.random(n) > 0.1
    got = tpq.pq_encode(torch.from_numpy(x), torch.from_numpy(cb),
                        torch.from_numpy(valid)).numpy()
    want = np.asarray(jpq.pq_encode(jnp.asarray(x), jnp.asarray(cb),
                                    jnp.asarray(valid)))
    assert got.shape == want.shape == (n, m) and got.dtype == np.uint8
    d2 = np.sort(_sub_dists(x, cb), axis=2)  # [M, N, K]
    sep = ((d2[:, :, 1] - d2[:, :, 0]) > 1e-4 * d2[:, :, 1]).T  # [N, M]
    assert sep.mean() > 0.95
    np.testing.assert_array_equal(got[sep], want[sep])
    assert (got[~valid] == 0).all()


def test_build_lut_matches_jax(rng):
    q = rng.normal(size=(7, 32)).astype(np.float32)
    cb = rng.normal(size=(8, 16, 4)).astype(np.float32)
    got = tpq.build_lut(torch.from_numpy(q), torch.from_numpy(cb)).numpy()
    want = np.asarray(jpq.build_lut(jnp.asarray(q), jnp.asarray(cb)))
    assert got.shape == (7, 8, 16)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert (got >= 0).all()


def test_adc_lookup_and_scan_match_jax(rng):
    q = rng.normal(size=(5, 16)).astype(np.float32)
    cb = rng.normal(size=(4, 32, 4)).astype(np.float32)
    codes = rng.integers(0, 32, size=(97, 4)).astype(np.uint8)
    valid = rng.random(97) > 0.2
    jlut = jpq.build_lut(jnp.asarray(q), jnp.asarray(cb))
    tlut = torch.from_numpy(np.array(jlut))  # the same LUT on both sides
    got = tpq.adc_scan(tlut, torch.from_numpy(codes), torch.from_numpy(valid)).numpy()
    want = np.asarray(jpq.adc_scan(jlut, jnp.asarray(codes), jnp.asarray(valid)))
    np.testing.assert_array_equal(np.isinf(got), ~valid[None, :].repeat(5, 0))
    np.testing.assert_allclose(got[:, valid], want[:, valid], rtol=1e-5)
    sub = codes[rng.integers(0, 97, size=(5, 11))]  # [Q, C, M]
    got = tpq.adc_lookup(tlut, torch.from_numpy(sub)).numpy()
    want = np.asarray(jpq.adc_lookup(jlut, jnp.asarray(sub)))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_pq_train_shapes_and_finite(rng):
    x = rng.normal(size=(100, 16)).astype(np.float32)
    cb = tpq.pq_train(torch.from_numpy(x), torch.ones(100, dtype=torch.bool),
                      m=4, k=8, iters=5, generator=_gen(42))
    assert cb.shape == (4, 8, 4) and cb.dtype == torch.float32
    assert torch.isfinite(cb).all()


def test_pq_train_recovers_clusters(rng):
    """Lloyd's k-means from K random rows recovers 4 separated centres only
    when its start (and re-seeds) reach every cluster, about half the time
    for either trainer on this data; so over 20 seeds the port recovers
    them as often as the JAX trainer does, give or take 4."""
    x, centers = _clustered(rng, n_clusters=4, per=50, d=8)

    def recovered(cb):
        return all(np.min(np.linalg.norm(cb - c, axis=1)) < 0.2 for c in centers)

    port = sum(
        recovered(tpq.pq_train(torch.from_numpy(x), torch.ones(len(x), dtype=torch.bool),
                               m=1, k=4, iters=10, generator=_gen(s)).numpy()[0])
        for s in range(20)
    )
    ref = sum(
        recovered(np.asarray(jpq.pq_train(jnp.asarray(x), jnp.ones(len(x), bool), m=1,
                                          k=4, iters=10, key=jax.random.PRNGKey(s)))[0])
        for s in range(20)
    )
    assert port >= 5 and port >= ref - 4, (port, ref)


def test_pq_train_ignores_invalid_rows(rng):
    x, _ = _clustered(rng, n_clusters=2, per=30, d=4)
    allx = np.concatenate([x, 1000.0 * np.ones((20, 4), np.float32)])
    valid = np.concatenate([np.ones(len(x), bool), np.zeros(20, bool)])
    cb = tpq.pq_train(torch.from_numpy(allx), torch.from_numpy(valid), m=1, k=2,
                      iters=8, generator=_gen(1))
    assert (cb.abs() < 100.0).all()


def test_pq_train_fewer_rows_than_centroids(rng):
    """N < K: the initial rows repeat; every centroid is a real row."""
    x = rng.normal(size=(5, 8)).astype(np.float32)
    cb = tpq.pq_train(torch.from_numpy(x), torch.ones(5, dtype=torch.bool),
                      m=2, k=16, iters=3, generator=_gen(3)).numpy()
    assert cb.shape == (2, 16, 4) and np.isfinite(cb).all()
    subs = x.reshape(5, 2, 4).transpose(1, 0, 2)
    for j in range(2):
        assert all(np.min(np.abs(subs[j] - c).sum(1)) < 1e-5 for c in cb[j])


def _quant_error(x, cb):
    return float(np.mean(np.min(_sub_dists(x, cb), axis=2).sum(0)))


@pytest.mark.parametrize("seed", [0, 1])
def test_pq_train_error_close_to_jax(seed):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(64, 32)).astype(np.float32) * 3
    x = (centers[rng.integers(0, 64, 3000)]
         + rng.normal(size=(3000, 32))).astype(np.float32)
    valid = np.ones(3000, bool)
    valid[::17] = False
    tcb = tpq.pq_train(torch.from_numpy(x), torch.from_numpy(valid), m=8, k=32,
                       iters=5, generator=_gen(42)).numpy()
    jcb = np.asarray(jpq.pq_train(jnp.asarray(x), jnp.asarray(valid), m=8, k=32,
                                  iters=5, key=jax.random.PRNGKey(42)))
    te, je = _quant_error(x[valid], tcb), _quant_error(x[valid], jcb)
    assert abs(te - je) <= 0.1 * je, (te, je)


def test_zero_codebook():
    cb = tpq.zero_codebook(4, 16, 2)
    assert cb.shape == (4, 16, 2) and not cb.any()


def test_adc_pool_auto_routes_by_shape(rng, monkeypatch):
    """The binned pool at >= 16,384 rows with bins covering ef_buf, the
    scores scan + top-k below: on the CPU exactly as on the card."""
    calls = []
    for name in ("adc_bin_pools", "adc_scores_many"):
        orig = getattr(tadc, name)
        monkeypatch.setattr(
            tadc, name,
            lambda *a, _o=orig, _n=name, **kw: calls.append(_n) or _o(*a, **kw),
        )
    lut = torch.rand(3, 4, 16)
    for n in (tadc.MIN_ROWS_POOL - 128, tadc.MIN_ROWS_POOL):
        codes = torch.from_numpy(rng.integers(0, 16, (n, 4)).astype(np.uint8))
        neg, idx = tpq.adc_pool_auto(lut, codes, torch.ones(n, dtype=torch.bool),
                                     ef_buf=64)
        assert neg.shape == idx.shape == (3, 64) and idx.dtype == torch.int32
        assert (neg[:, :-1] >= neg[:, 1:]).all()  # descending
    assert calls == ["adc_scores_many", "adc_bin_pools"]


def test_build_luts_equals_build_lut_per_codebook(rng):
    """A group's LUTs in one batched product: each equals its own
    build_lut bit for bit (the same f32 products and sums per entry)."""
    q = torch.from_numpy(rng.normal(size=(9, 16)).astype(np.float32))
    cbs = torch.from_numpy(rng.normal(size=(3, 4, 32, 4)).astype(np.float32))
    luts = tpq.build_luts(q, cbs)
    assert luts.shape == (3, 9, 4, 32)
    for i in range(3):
        assert torch.equal(luts[i], tpq.build_lut(q, cbs[i]))


@pytest.mark.parametrize("n", [tadc.MIN_ROWS_POOL - 128, tadc.MIN_ROWS_POOL])
def test_adc_pools_auto_equals_adc_pool_auto_per_segment(rng, n):
    """Segments pooled together (one plane, one stage-2 top-k) give each
    segment the pool it gets alone, on both routes (the scores scan below
    16,384 rows, the binned pool from there on)."""
    s_count, qn, m, k = 3, 5, 4, 16
    luts = torch.from_numpy(rng.random((s_count, qn, m, k)).astype(np.float32) * 9)
    codes = [torch.from_numpy(rng.integers(0, k, (n, m)).astype(np.uint8))
             for _ in range(s_count)]
    valids = [torch.from_numpy(rng.random(n) < f) for f in (1.0, 0.5, 0.001)]
    neg, idx = tpq.adc_pools_auto(luts, codes, valids, ef_buf=64)
    assert neg.shape == idx.shape == (s_count, qn, 64)
    for i in range(s_count):
        one_neg, one_idx = tpq.adc_pool_auto(luts[i], codes[i], valids[i], ef_buf=64)
        assert torch.equal(neg[i], one_neg)
        assert torch.equal(idx[i], one_idx)
    # the nearly empty segment pads with -inf / -1
    assert (idx[2] == -1).any() and torch.equal(idx[2] == -1, torch.isinf(neg[2]))
