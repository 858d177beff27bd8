"""The port's traversal (vectorsearch_torch/ops/traversal.py ``graph_expand``
and ``_dedup_within_step``, on the CPU) held against the JAX package's on the
same inputs, the RANDOM_PIVOTS draw held to the JAX package's formula, plus
the port's copies of tests/test_traversal_ops.py.

Both sides are fed the same ``approx`` matrix: uniform random distances (no
two equal), a random graph with -1 holes, rows marked invalid by +inf.
Tolerance: identical candidate ids and equal distances (both only move the
given values around).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vectorsearch_torch.core.index import _pivot_rows
from vectorsearch_torch.ops import pq as tpq
from vectorsearch_torch.ops import traversal as tt
from vectorsearch_tpu.ops import traversal as jt


def _case(rng, q, n, r, seeds, invalid=0.05, holes=0.1):
    approx = rng.random((q, n)).astype(np.float32) * 100
    approx[:, rng.random(n) < invalid] = np.inf
    adj = rng.integers(0, n, size=(n, r)).astype(np.int32)
    adj[rng.random((n, r)) < holes] = -1
    neg = np.argsort(approx, axis=1)[:, :seeds].astype(np.int32)
    seed_d = np.take_along_axis(approx, neg, axis=1)
    seed_i = np.where(np.isfinite(seed_d), neg, -1).astype(np.int32)
    seed_i[0, -1] = seed_i[0, 0]  # a duplicate seed
    seed_d[0, -1] = seed_d[0, 0]
    return approx, adj, seed_i, seed_d


def _both(approx, adj, seed_i, seed_d, ef, beam, offset=None, **kw):
    valid = np.isfinite(approx).any(axis=0)
    j = jt.graph_expand(
        jnp.asarray(approx), jnp.asarray(adj), jnp.asarray(valid),
        jnp.asarray(seed_i), jnp.asarray(seed_d),
        jnp.asarray(ef, jnp.int32), jnp.asarray(beam, jnp.int32),
        None if offset is None else jnp.asarray(offset), **kw,
    )
    t = tt.graph_expand(
        torch.from_numpy(approx), torch.from_numpy(adj), torch.from_numpy(valid),
        torch.from_numpy(seed_i), torch.from_numpy(seed_d),
        torch.as_tensor(ef, dtype=torch.int32), torch.as_tensor(beam, dtype=torch.int32),
        None if offset is None else torch.from_numpy(offset), **kw,
    )
    return [np.asarray(a) for a in j], [a.numpy() for a in t]


@pytest.mark.parametrize("variant", [
    "best_first", "beam", "beam_min_steps", "seeds_past_ef", "wide_pool",
])
def test_graph_expand_matches_jax(rng, variant):
    q, n, r, seeds = 6, 2000, 8, 16
    ef, beam = 60, 12
    kw = dict(ef_buf=64, beam_buf=16, max_steps=64)
    if variant == "beam":
        kw.update(max_steps=4, min_steps=2, refine_frontier=False)
    elif variant == "beam_min_steps":
        ef = 1  # exploration ends at once unless min_steps forces hops
        kw.update(max_steps=6, min_steps=3, refine_frontier=False)
    elif variant == "seeds_past_ef":
        seeds = 80
    elif variant == "wide_pool":
        # ef_buf * beam_buf * R > 2^22: the JAX package's binary-search
        # branch (the other cases take its broadcast compare; the port
        # always searches)
        q, n, r, seeds, ef, beam = 3, 40_000, 160, 64, 500, 60
        kw = dict(ef_buf=512, beam_buf=64, max_steps=8)
        assert 512 * 64 * r > 1 << 22
    approx, adj, seed_i, seed_d = _case(rng, q, n, r, seeds)
    (ji, jd), (ti, td) = _both(approx, adj, seed_i, seed_d, ef, beam, **kw)
    assert (ti >= 0).sum() > seeds
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(td, jd)


def test_graph_expand_per_row_budgets_and_row_offsets_match_jax(rng):
    """Stacked (query, segment) rows: per-row ef and beam, and an offset per
    row into a flattened two-segment adjacency with segment-local ids."""
    q, n, r, s_count = 4, 1500, 8, 2
    approx = np.concatenate([_case(rng, q, n, r, 8)[0] for _ in range(s_count)])
    adj = rng.integers(0, n, size=(s_count * n, r)).astype(np.int32)
    adj[rng.random(adj.shape) < 0.1] = -1
    neg = np.argsort(approx, axis=1)[:, :8].astype(np.int32)
    seed_d = np.take_along_axis(approx, neg, axis=1)
    seed_i = np.where(np.isfinite(seed_d), neg, -1).astype(np.int32)
    offset = np.repeat(np.arange(s_count, dtype=np.int32) * n, q)
    ef = np.array([20, 40, 60, 30, 50, 10, 64, 25], np.int32)
    beam = np.array([4, 8, 16, 2, 6, 16, 1, 8], np.int32)
    (ji, jd), (ti, td) = _both(approx, adj, seed_i, seed_d, ef, beam, offset,
                               ef_buf=64, beam_buf=16, max_steps=64)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(td, jd)


def test_dedup_within_step_matches_jax(rng):
    ids = rng.integers(0, 20, size=(5, 40)).astype(np.int32)
    new = rng.random((5, 40)) < 0.7
    want = np.asarray(jt._dedup_within_step(jnp.asarray(ids), jnp.asarray(new)))
    got = tt._dedup_within_step(torch.from_numpy(ids), torch.from_numpy(new))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seg_id,lut00", [(0, 0.0), (3, 17.25), (1234, 3.1e-7)])
def test_pivot_draw_is_the_jax_formula(rng, seg_id, lut00):
    """The deterministic RANDOM_PIVOTS draw: seed ((segId << 21) ^
    bits(float64(lut[0,0,0]))) & 0xFFFFFFFF into a numpy RandomState, then
    uniform existing rows, as vectorsearch_tpu/core/index.py draws them."""
    exists = rng.random(700) < 0.6
    lut = np.float32(lut00)
    seed_val = ((seg_id << 21) ^ np.float64(lut).view(np.int64).item()) & 0xFFFFFFFF
    rnd = np.random.RandomState(seed_val)
    rows = np.flatnonzero(exists)
    want = rows[rnd.randint(0, len(rows), size=5)]
    got = _pivot_rows(seg_id, float(lut), exists, 5)
    np.testing.assert_array_equal(got, want)
    assert exists[got].all()


# --- the port's copies of tests/test_traversal_ops.py ---------------------


def _line(n=16, d=4):
    """Points on a line; adjacency connects i <-> i+1; one centroid per
    point, so ADC is the exact distance."""
    x = np.zeros((n, d), np.float32)
    x[:, 0] = np.arange(n)
    adj = np.full((n, 2), -1, np.int32)
    adj[:-1, 0] = np.arange(1, n)
    adj[1:, 1] = np.arange(0, n - 1)
    xs = torch.from_numpy(x)
    cb = xs.reshape(n, 2, d // 2).permute(1, 0, 2).contiguous()
    codes = tpq.pq_encode(xs, cb, torch.ones(n, dtype=torch.bool))
    return xs, torch.from_numpy(adj), cb, codes


def _expand(q_first, valid, ef, beam, seeds=((0,),), **kw):
    xs, adj, cb, codes = _line()
    n = xs.shape[0]
    q = torch.zeros((len(q_first), 4))
    q[:, 0] = torch.tensor(q_first, dtype=torch.float32)
    approx = tpq.adc_scan(tpq.build_lut(q, cb), codes, valid)
    seed = torch.tensor(seeds, dtype=torch.int32)
    kw.setdefault("ef_buf", n)
    kw.setdefault("max_steps", n + 2)
    cand, _d = tt.graph_expand(approx, adj, valid, seed,
                               torch.gather(approx, 1, seed.long()), ef, beam,
                               beam_buf=beam, **kw)
    return xs, q, cand


def test_traversal_walks_the_line():
    n = 16
    _xs, _q, cand = _expand([n - 1], torch.ones(n, dtype=torch.bool), n, 1)
    ids = [int(v) for v in cand[0] if v >= 0]
    assert (n - 1) in ids and len(ids) == n == len(set(ids))


def test_traversal_respects_row_valid():
    valid = torch.ones(16, dtype=torch.bool)
    valid[5] = False
    _xs, _q, cand = _expand([15], valid, 16, 1)
    assert {int(v) for v in cand[0] if v >= 0} == {0, 1, 2, 3, 4}


def test_traversal_ef_limit_stops_exploration():
    _xs, _q, cand = _expand([0], torch.ones(16, dtype=torch.bool), 4, 1)
    assert len([v for v in cand[0] if v >= 0]) <= 4 + 2


def test_traversal_batched_queries_independent():
    valid = torch.ones(16, dtype=torch.bool)
    xs, q, cand = _expand([0, 15], valid, 16, 1, seeds=((0,), (0,)))
    _s, _d, idx = tt.exact_rerank(q, xs, valid, cand, k=1)
    assert idx[:, 0].tolist() == [0, 15]


def test_beam_mode_min_steps_forces_hops():
    # ef 1 would stop at once; min_steps 3 forces three hops (minHops)
    _xs, _q, cand = _expand([0], torch.ones(16, dtype=torch.bool), 1, 1,
                            ef_buf=8, max_steps=8, min_steps=3,
                            refine_frontier=False)
    assert len([v for v in cand[0] if v >= 0]) >= 3


def test_steps_are_counted():
    before = tt.graph_expand.steps
    _expand([15], torch.ones(16, dtype=torch.bool), 16, 1)
    assert tt.graph_expand.steps - before == 15  # one hop a step to the end
