"""The port's graph build (vectorsearch_torch/ops/graph.py, on the CPU) held
against the JAX package's (vectorsearch_tpu/ops/graph.py) on the same
inputs, plus the port's copies of tests/test_graph_ops.py.

Inputs are gaussian rows from numpy seeds: continuous values, so no two
candidate distances tie. Tolerances: candidate ids identical and distances
rtol 1e-5 (both compute the same full-f32 expansion, summed in another
order); RobustPrune and the reverse-edge merge identical on identical
inputs; whole builds identical adjacency (both prune with the same f32
``alpha * d2`` against the same formulas). The fused kNN route is held to
the JAX package's in interpret mode on rows laid out so that no two of a
query's true neighbours share a pool bin (each block of 16 rows is one
cluster, and a bin holds rows 256 apart): identical ids after the re-rank.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vectorsearch_torch.ops import graph as tg
from vectorsearch_torch.ops import pq as tpq
from vectorsearch_torch.ops import traversal as tt
from vectorsearch_tpu.ops import graph as jg


def _gauss(rng, n, d=16):
    return rng.normal(size=(n, d)).astype(np.float32)


def _valid(n, holes=()):
    v = np.ones(n, bool)
    v[list(holes)] = False
    return v


@pytest.mark.parametrize("n,l,row_block", [(400, 32, 128), (97, 120, 2048)])
def test_knn_candidates_match_jax(rng, n, l, row_block):
    x = _gauss(rng, n)
    valid = _valid(n, holes=(3, 50))
    ji, jd = jg.knn_candidates(jnp.asarray(x), jnp.asarray(valid), l,
                               row_block=row_block)
    ti, td = tg.knn_candidates(torch.from_numpy(x), torch.from_numpy(valid), l,
                               row_block=row_block)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("alpha", [1.0, 1.2, 2.0])
def test_robust_prune_block_matches_jax(rng, alpha):
    x = _gauss(rng, 300)
    valid = _valid(300)
    ci, cd = jg.knn_candidates(jnp.asarray(x), jnp.asarray(valid), 40)
    ci, cd = np.array(ci), np.array(cd)
    ci[5, 30:] = -1  # a short candidate list
    cd[5, 30:] = np.inf
    want = jg.robust_prune_block(jnp.asarray(x), jnp.asarray(ci), jnp.asarray(cd),
                                 12, jnp.float32(alpha))
    got = tg.robust_prune_block(torch.from_numpy(x), torch.from_numpy(ci),
                                torch.from_numpy(cd), 12, alpha)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_merge_reverse_edges_matches_jax(rng):
    n, r = 500, 12
    adj = rng.integers(0, n, size=(n, r)).astype(np.int32)
    adj[rng.random((n, r)) < 0.2] = -1
    for cap in (4, 12):
        np.testing.assert_array_equal(
            tg._merge_reverse_edges_host(adj.copy(), cap),
            jg._merge_reverse_edges_host(adj.copy(), cap),
        )


@pytest.mark.parametrize("n,degree,alpha", [
    (300, 8, 1.0), (300, 16, 1.2), (600, 12, 1.2), (450, 16, 1.4),
])
def test_build_graph_matches_jax(rng, n, degree, alpha):
    x = _gauss(rng, n)
    valid = _valid(n, holes=(0, 77))
    want = np.asarray(jg.build_graph(jnp.asarray(x), jnp.asarray(valid),
                                     degree=degree, l_build=4 * degree,
                                     alpha=alpha, row_block=256))
    got = tg.build_graph(torch.from_numpy(x), torch.from_numpy(valid),
                         degree=degree, l_build=4 * degree, alpha=alpha,
                         row_block=256)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_fused_knn_route_matches_jax(rng, monkeypatch):
    """Past FUSED_KNN_MIN_ROWS (lowered here) knn_candidates takes the binned
    pool; JAX's fused route in interpret mode gives the same ids after the
    re-rank, and distances close to the plain route's."""
    n, d, l = 1536, 16, 8
    centers = rng.normal(size=(n // 16, d)) * 10
    x = (np.repeat(centers, 16, axis=0) + rng.normal(size=(n, d))).astype(np.float32)
    valid = _valid(n, holes=(7,))
    monkeypatch.setattr(tg, "FUSED_KNN_MIN_ROWS", 1024)
    spy = []
    orig = tg._knn_block_fused
    monkeypatch.setattr(tg, "_knn_block_fused",
                        lambda *a, **k: spy.append(1) or orig(*a, **k))
    ti, td = tg.knn_candidates(torch.from_numpy(x), torch.from_numpy(valid), l)
    assert len(spy) == 3  # 512-row blocks
    ji, jd = jg.knn_candidates(jnp.asarray(x), jnp.asarray(valid), l,
                               fused=True, interpret=True)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-5)
    pi, pd = tg.knn_candidates(torch.from_numpy(x), torch.from_numpy(valid), l,
                               fused=False)
    np.testing.assert_array_equal(ti.numpy(), pi.numpy())
    np.testing.assert_allclose(td.numpy(), pd.numpy(), rtol=1e-3, atol=1e-2)


# --- the port's copies of tests/test_graph_ops.py -------------------------


def test_find_medoid(rng):
    x = _gauss(rng, 50, 4)
    med = int(tg.find_medoid(torch.from_numpy(x), torch.ones(50, dtype=torch.bool)))
    assert med == int(np.argmin(np.sum((x - x.mean(axis=0)) ** 2, axis=1)))
    valid = torch.ones(50, dtype=torch.bool)
    valid[med] = False
    assert int(tg.find_medoid(torch.from_numpy(x), valid)) != med


def test_knn_candidates_exact(rng):
    x = _gauss(rng, 30, 6)
    idx, d2 = tg.knn_candidates(torch.from_numpy(x), torch.ones(30, dtype=torch.bool),
                                l=5, row_block=7)
    idx, d2 = idx.numpy(), d2.numpy()
    for i in range(30):
        dists = np.sum((x - x[i]) ** 2, axis=1)
        dists[i] = np.inf
        assert set(idx[i]) == set(np.argsort(dists)[:5])
        assert i not in idx[i]
        assert np.all(np.diff(d2[i]) >= -1e-6)


def test_knn_small_n_pads_with_minus_one(rng):
    idx, _d2 = tg.knn_candidates(torch.from_numpy(_gauss(rng, 3, 4)),
                                 torch.ones(3, dtype=torch.bool), l=8)
    idx = idx.numpy()
    assert np.all(np.sum(idx >= 0, axis=1) == 2)
    assert np.all(idx[:, 2:] == -1)


def test_build_graph_invariants(rng):
    adj = tg.build_graph(torch.from_numpy(_gauss(rng, 60, 8)),
                         torch.ones(60, dtype=torch.bool), degree=8, l_build=24,
                         alpha=1.2).numpy()
    assert adj.shape == (60, 8)
    for i in range(60):
        row = adj[i][adj[i] >= 0]
        assert i not in row
        assert len(set(row.tolist())) == len(row)
        assert np.all(row < 60)


def test_alpha_pruning_reduces_edges_vs_knn(rng):
    x = torch.from_numpy(_gauss(rng, 80, 8))
    valid = torch.ones(80, dtype=torch.bool)
    knn = tg.build_graph(x, valid, degree=16, l_build=32, alpha=1.0).numpy()
    pruned = tg.build_graph(x, valid, degree=16, l_build=32, alpha=1.2).numpy()
    assert int(np.sum(knn >= 0)) == 80 * 16
    assert not np.array_equal(knn, pruned)
    assert int(np.sum(pruned >= 0)) > 0


def test_robust_prune_keeps_nearest(rng):
    x = torch.from_numpy(_gauss(rng, 40, 6))
    ci, cd = tg.knn_candidates(x, torch.ones(40, dtype=torch.bool), l=10)
    adj = tg.robust_prune(x, ci, cd, degree=4, alpha=1.2)
    assert (adj[:, 0] == ci[:, 0]).all()


def test_vamana_recall_gate(rng):
    """Recall@10 >= 0.80 against brute force on 100 random 8-d vectors, R 16,
    L 64, alpha 1.2 (the reference's floor, graph/GraphBuilderTest.java:80-121),
    searched by the port's traversal with one centroid per point (ADC equals
    the exact distance), seeded from the medoid."""
    n, d, r = 100, 8, 16
    x = _gauss(rng, n, d)
    xs = torch.from_numpy(x)
    valid = torch.ones(n, dtype=torch.bool)
    adj = tg.build_graph(xs, valid, degree=r, l_build=64, alpha=1.2)
    m = 4
    cb = xs.reshape(n, m, d // m).permute(1, 0, 2).contiguous()
    codes = tpq.pq_encode(xs, cb, valid)
    med = int(tg.find_medoid(xs, valid))
    hits = 0
    for _ in range(20):
        q = _gauss(rng, 1, d)
        approx = tpq.adc_scan(tpq.build_lut(torch.from_numpy(q), cb), codes, valid)
        seed_idx = torch.tensor([[med]], dtype=torch.int32)
        cand, _cd = tt.graph_expand(
            approx, adj, valid, seed_idx, approx[:, [med]], 64, 8,
            ef_buf=64, beam_buf=8, max_steps=64,
        )
        _s, _d, idx = tt.exact_rerank(torch.from_numpy(q), xs, valid, cand, k=10)
        truth = np.argsort(np.linalg.norm(x - q[0], axis=1))[:10]
        hits += len(set(idx[0].tolist()) & set(truth.tolist()))
    assert hits / 200 >= 0.80, hits / 200
