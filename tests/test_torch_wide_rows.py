"""The port's exact mode at GIST1M's width (960 features, lane-padded to
1,024) on the CPU, held against the benchmark's plain reference
(portbench/reference/knn.py: exact k-NN in float64, which imports nothing of
the program), on rows drawn by the benchmark's generator
(portbench/data.py) with the gist1m-exact configuration's data settings.

Three sealed segments of 20,000 rows take the exact route as the
benchmark's 1M-row corpus does: a power-of-two subgroup of two segments
(40,000 rows) and a singleton, both past ``MIN_ROWS``, so both take the
binned pool (its plain form on the CPU).

The card's kernel (B1) forms the same product from TF32 halves on the
tensor cores; its precision at this width is emulated here too, with
tests/test_torch_exact_packed.py's model of the tensor cores.

Tolerances:
- distances: relative 2e-5. The port computes a distance as
  sqrt(|q|^2 - (2 q.x - |x|^2)) in float32. At these rows |q|^2 and |x|^2
  are ~16,000 and a neighbour's squared distance ~1,900-5,700, so the
  expansion cancels 3-17x of its magnitude; float32 sums over 1,024 lanes
  err by a few units of 6e-8 of |q||x| each, which leaves a few 1e-6 on a
  distance. Computing the product one precision down (TF32 inputs) errs by
  ~5e-4.
- ids: every true top-10 row is returned, except (a) at the 10th rank,
  where a row may lose to one whose true distance lies within the distance
  tolerance of it (a float32 tie), and (b) where the binned pool kept a
  nearer row of the same bin (the pool keeps each bin's best row alone: a
  bin is the rows r of one call with the same r // (fold * tile) and
  r % bins).
"""

import json
import os

import numpy as np
import pytest
import torch

import vectorsearch_torch as tvs
from portbench import check, data
from portbench.reference import knn
from vectorsearch_torch.ops import exact as te

SEG = 20_000
K = 10
NQ = 64
RTOL = 2e-5
CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "portbench", "configs", "gist1m-exact.json")


def _gist_like(n_rows, n_queries, seed):
    """Rows and held-out queries of the gist1m-exact configuration's
    generator, ``n_rows`` of them."""
    with open(CONFIG) as f:
        spec = dict(json.load(f)["data"], rows=n_rows)
    inputs = data.make(spec, seed=seed, n_queries=n_queries, n_fresh=0, device="cpu")
    return inputs.rows, inputs.queries


def _keys(x):
    """A row's first two features' bits as one int64: unique among the
    generator's rows, 0 for a lane-pad row."""
    return np.ascontiguousarray(np.asarray(x, np.float32)[:, :2]).view(np.int64)[:, 0]


def _bins(calls, rows):
    """(call, bin) of every data row, from the tables the binned pool was
    handed and its geometry; (-1, -1) for a row in no call."""
    where = np.full((len(rows), 2), -1, np.int64)
    pos = {k: i for i, k in enumerate(_keys(rows))}
    for c, (x, g) in enumerate(calls):
        for r, key in enumerate(_keys(x)):
            i = pos.get(int(key))
            if i is not None:
                where[i] = (c, (r // (g["fold"] * g["tile"])) * g["bins"] + r % g["bins"])
    return where


@pytest.mark.parametrize("tombstones", [False, True])
def test_exact_mode_at_gist_width_matches_the_reference(monkeypatch, tombstones):
    with open(CONFIG) as f:
        cfg = json.load(f)
    rows, q = _gist_like(3 * SEG, NQ, 2**31 + 960)
    assert rows.shape == (3 * SEG, 960)

    calls = []
    plain = te.exact_pool_plain

    def spy(q_in, x, aux, **geom):
        calls.append((x.numpy(), geom))
        return plain(q_in, x, aux, **geom)

    monkeypatch.setattr(te, "exact_pool_plain", spy)
    idx = tvs.VectorIndex.create_or_open(tvs.VectorIndexConfig(
        storage=tvs.MemoryStorage(), name="gist", device="cpu",
        **dict(cfg["index"], max_segment_size=SEG)))
    try:
        gids = np.asarray(idx.add_all(rows), np.int64)
        for sid in range(3):
            idx.build_service.build(sid)
        deletes = ()
        if tombstones:
            # the three nearest rows of the first eight queries, and 500 more
            near = knn.topk_certain(knn.Log.build(gids, rows), q[:8], np.zeros(8),
                                    np.zeros(8), 3, "cpu")[0].ravel()
            rng = np.random.default_rng(960)
            dead = np.unique(np.concatenate([near, rng.choice(gids, 500, replace=False)]))
            idx.delete_all(dead.tolist())
            deletes = ((dead, -1.0, -1.0),)
        got_g, got_s, got_d = idx.query_batch_arrays(q, K)
    finally:
        idx.close()

    # both groups took the binned pool at 1,024 lanes
    assert len(calls) == 2
    assert all(x.shape[0] >= te.MIN_ROWS and x.shape[1] == 1024 for x, _g in calls)

    log = knn.Log.build(gids, rows, (), deletes)
    ts = te_ = np.zeros(NQ)
    assert check.bad_rows(log, got_g, ts, te_) == 0  # no tombstone, no repeat
    ref_g, ref_d = knn.topk_certain(log, q, ts, te_, K, "cpu")
    true_d = knn.distances(log, q, got_g, "cpu")
    assert (got_g >= 0).all()
    np.testing.assert_allclose(got_d, true_d, rtol=RTOL, atol=0)
    np.testing.assert_array_equal(got_s, -got_d)

    where = _bins(calls, rows)
    excused = 0
    for i in range(NQ):
        kth = true_d[i].max()
        for g, d in zip(ref_g[i], ref_d[i]):
            if g in got_g[i]:
                continue
            tie = d >= kth * (1 - RTOL)
            same_bin = [h for h in got_g[i] if (where[h] == where[g]).all()
                        and true_d[i][got_g[i] == h][0] <= d * (1 + RTOL)]
            assert tie or same_bin, (i, g, d, kth)
            excused += 1
    assert excused <= NQ * K // 50  # a rare event, not the rule
    if tombstones:
        assert not np.isin(got_g, deletes[0][0]).any()


def test_chunk_sums_keep_float32_distances_at_gist_width():
    """Why B1 sums each 32-feature chunk apart on rows over 128 features
    (csrc/exact_pool_tc.cu, CHUNK_SUM): on GIST-like rows (960 features in
    1,024 lanes, 30 chunks), each query's ten nearest rows' distances, from
    the tensor cores' product as the port turns it into a distance
    (pool_inputs' pre-doubled query and f32 squared norms, exact_finalize's
    sqrt(|q|^2 - s)), stay within the distance tolerance of float64 when the
    chunks are summed apart, and leave it by more than twice when one
    accumulator takes all 30 chunks, rounding toward zero at the running
    sum (~30,000)."""
    from tests.test_torch_exact_packed import _tensor_core_product

    rows, q = _gist_like(20_000, 32, 2**31 + 961)
    x64, q64 = rows.astype(np.float64), q.astype(np.float64)
    d2 = (q64 * q64).sum(1)[:, None] - 2.0 * q64 @ x64.T + (x64 * x64).sum(1)[None, :]
    near = np.argsort(d2, axis=1)[:, :10]
    xs = np.zeros((near.size, 1024), np.float32)
    xs[:, :960] = rows[near.ravel()]
    qs = np.zeros((len(q), 1024), np.float32)
    qs[:, :960] = q
    tq, tx = torch.from_numpy(qs), torch.from_numpy(xs)
    q_in, aux, _geom = te.pool_inputs(tq, tx, torch.ones(len(xs), dtype=torch.bool))
    qn2 = (tq * tq).sum(1)[:, None]
    true = np.sqrt(np.take_along_axis(d2, near, axis=1))
    pick = torch.from_numpy(np.arange(near.size).reshape(near.shape))

    def rel_err(chunk_sums):
        s = _tensor_core_product(chunk_sums)(q_in, tx).float() - aux[0][None, :]
        d = torch.sqrt(torch.clamp(qn2 - torch.gather(s, 1, pick), min=0.0))
        return float((np.abs(d.double().numpy() - true) / true).max())

    assert rel_err(True) <= RTOL
    assert rel_err(False) > 2 * RTOL


def test_exact_route_hands_the_pool_the_logical_width(monkeypatch):
    """core/index.py's exact route gives the binned pool d_live = the
    index's logical width (960) on rows lane-padded to 1,024, so B1 on the
    card reads 30 32-feature chunks, not 32 (its plain form on the CPU,
    reached here by lowering MIN_ROWS), and the answers stay exact."""
    with open(CONFIG) as f:
        cfg = json.load(f)
    seg = 4_200
    rows, q = _gist_like(3 * seg, 8, 2**31 + 962)
    monkeypatch.setattr(te, "MIN_ROWS", 4_096)
    seen = []
    plain = te.exact_pool_plain

    def spy(q_in, x, aux, **geom):
        seen.append((x.shape[1], q_in.shape[1], geom["d_live"]))
        return plain(q_in, x, aux, **geom)

    monkeypatch.setattr(te, "exact_pool_plain", spy)
    idx = tvs.VectorIndex.create_or_open(tvs.VectorIndexConfig(
        storage=tvs.MemoryStorage(), name="gist", device="cpu",
        **dict(cfg["index"], max_segment_size=seg)))
    try:
        gids = np.asarray(idx.add_all(rows), np.int64)
        for sid in range(3):
            idx.build_service.build(sid)
        got, _s, _d = idx.query_batch_arrays(q, K)
    finally:
        idx.close()
    assert seen and all(s == (1024, 1024, 960) for s in seen), seen
    d2 = ((q[:, None, :].astype(np.float64) - rows[None, :, :]) ** 2).sum(-1)
    assert (got[:, 0] == gids[d2.argmin(axis=1)]).all()
