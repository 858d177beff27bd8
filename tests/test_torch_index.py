"""The port's VectorIndex (vectorsearch_torch, exact mode, on the CPU) held
against the JAX package's (vectorsearch_tpu) on the same data: the whole
slice — add, seal, query, merge, gid mapping — and each package opening what
the other wrote through DiskStorage.

The layout exercises every route of the main path: a power-of-two sealed
subgroup of 16,384 rows (the port's binned pool, the CUDA kernel on the
card), a singleton sealed segment (plain scores + top-k), and a brute-force
table of 16,384 rows (one PENDING + the ACTIVE segment, also the binned
pool). The JAX package on the CPU ranks all of them exactly; the data puts
each query's true neighbours in one contiguous block of 64 rows, fewer than
the pool's bins, so the binned pool loses none of them and the answers are
the same. Tolerances: ids equal at result positions whose true distances
are more than 1e-3 (L2) / 1e-5 (cosine) from their neighbours'; distances
rtol 3e-3 / atol 3e-3 (L2) and atol 2e-4 (cosine), the JAX tests' own.
"""

import numpy as np
import pytest

import vectorsearch_tpu as jvs
import vectorsearch_torch as tvs
from vectorsearch_torch.ops import exact as te
from vectorsearch_torch.utils.metrics import get_registry

SEG = 8192  # max_segment_size: two sealed segments make a 16,384-row group
D = 16


def _config(pkg, storage, metric, **kw):
    base = dict(
        storage=storage, name="idx", dimension=D, metric=metric,
        max_segment_size=SEG, pq_m=4, pq_k=16, graph_degree=16,
        graph_build_breadth=64, sealed_search_mode="exact",
        graph_build_mode="skip_for_flat", pq_build_mode="skip_for_exact",
    )
    if pkg is tvs:
        base["device"] = "cpu"
    base.update(kw)
    return pkg.VectorIndexConfig(**base)


def _open(pkg, storage, metric="L2", **kw):
    return pkg.VectorIndex.create_or_open(_config(pkg, storage, metric, **kw))


def _blocked(rng, n, qn, block=64, spread=4.0):
    n_blocks = -(-n // block)
    centers = rng.normal(size=(n_blocks, D)) * spread
    x = np.repeat(centers, block, axis=0)[:n] + rng.normal(size=(n, D))
    pick = rng.integers(0, n // block, qn)
    q = centers[pick] + 0.5 * rng.normal(size=(qn, D))
    return x.astype(np.float32), q.astype(np.float32)


def _populate(idx, x, built, deleted):
    gids = idx.add_all(x)
    for sid in built:
        idx.build_service.build(sid)
    idx.delete_all([gids[i] for i in deleted])
    return gids


def _true_dists(x, q, alive, metric):
    x64, q64 = x.astype(np.float64), q.astype(np.float64)
    if metric == "COSINE":
        xn = np.linalg.norm(x64, axis=1)
        sim = (q64 @ x64.T) / (np.linalg.norm(q64, axis=1)[:, None] * xn[None, :])
        d = 1.0 - sim
    else:
        d = np.linalg.norm(x64[None, :, :] - q64[:, None, :], axis=2)
    return np.where(alive[None, :], d, np.inf)


def _assert_same(port, ref, x, q, alive, metric, k):
    (pg, ps, pd), (jg, js, jd) = port, ref
    assert pg.shape == jg.shape == (q.shape[0], k)
    t = np.sort(_true_dists(x, q, alive, metric), axis=1)[:, : k + 1]
    margin = 1e-5 if metric == "COSINE" else 1e-3
    gap = t[:, 1:] - t[:, :-1]
    before = np.concatenate([np.full((len(t), 1), np.inf), gap[:, :-1]], axis=1)
    sep = (gap > margin) & (before > margin)
    assert sep.mean() > 0.8
    np.testing.assert_array_equal(pg[sep], jg[sep])
    if metric == "COSINE":
        np.testing.assert_allclose(ps, js, rtol=0, atol=2e-4)
        np.testing.assert_allclose(pd, jd, rtol=0, atol=2e-4)
    else:
        np.testing.assert_allclose(pd, jd, rtol=3e-3, atol=3e-3)
        np.testing.assert_allclose(ps, -pd, rtol=0, atol=0)
    # and both are the true top-k
    np.testing.assert_allclose(pd, t[:, :k], rtol=3e-3, atol=3e-3)


@pytest.mark.parametrize("metric", ["L2", "COSINE"])
def test_whole_slice_matches_jax(rng, metric):
    # segments 0-2 sealed (a 0+1 pow2 subgroup and singleton 2), segment 3
    # PENDING and segment 4 ACTIVE (one 16,384-row brute table)
    n = 4 * SEG + 3000
    x, q = _blocked(rng, n, 48)
    deleted = np.concatenate([
        rng.integers(0, 4 * SEG, 300),  # sealed and PENDING rows
        np.arange(4 * SEG, 4 * SEG + 40),  # ACTIVE rows
    ])
    # the nearest rows of a few queries, so deletes change their answers
    near = np.argsort(_true_dists(x, q[:4], np.ones(n, bool), metric), axis=1)
    deleted = np.concatenate([deleted, near[:, :3].ravel()])
    alive = np.ones(n, bool)
    alive[deleted] = False

    results = []
    for pkg, storage in ((jvs, jvs.MemoryStorage()), (tvs, tvs.MemoryStorage())):
        idx = _open(pkg, storage, metric)
        try:
            gids = _populate(idx, x, built=(0, 1, 2), deleted=deleted)
            assert gids == list(range(n))
            states = {s.seg_id: s.state.value for s in idx.store.snapshot_segments()}
            assert states == {0: "SEALED", 1: "SEALED", 2: "SEALED",
                              3: "PENDING", 4: "ACTIVE"}
            results.append(idx.query_batch_arrays(q, 10))
            if pkg is tvs:
                res = idx.query_batch(q[:5], 10)
        finally:
            idx.close()
    _assert_same(results[1], results[0], x, q, alive, metric, 10)
    # the object API returns the same answers
    for i, r in enumerate(res):
        assert [s.gid for s in r] == results[1][0][i].tolist()
    assert not np.isin(results[1][0], deleted).any()


def test_slice_routes_use_the_binned_pool(rng, monkeypatch):
    """The layout above reaches the binned pool twice per batch (the sealed
    16,384-row subgroup and the 16,384-row brute table) and the plain
    top-k once (the 8,192-row singleton)."""
    calls = []
    orig = te.exact_bin_pool

    def spy(q, x, *a, **kw):
        calls.append(x.shape[0])
        return orig(q, x, *a, **kw)

    monkeypatch.setattr(te, "exact_bin_pool", spy)
    x, q = _blocked(rng, 4 * SEG + 3000, 8)
    idx = _open(tvs, tvs.MemoryStorage())
    try:
        _populate(idx, x, built=(0, 1, 2), deleted=[])
        idx.query_batch_arrays(q, 10)
    finally:
        idx.close()
    assert sorted(calls) == [2 * SEG, 2 * SEG]


def test_query_metrics_keep_reference_names(rng):
    reg = get_registry({})
    before = reg.counter_value("vectorsearch.query.count")
    x = rng.normal(size=(300, D)).astype(np.float32)
    idx = _open(tvs, tvs.MemoryStorage(), max_segment_size=128)
    try:
        idx.add_all(x)
        while idx.build_queue.has_visible_unclaimed_tasks():
            c = idx.build_queue.await_and_claim(timeout=1.0)
            idx.build_service.build(c.payload.seg_id)
            c.complete()
        gids, scores, dists = idx.query_batch_arrays(x[:7], 5)
    finally:
        idx.close()
    assert reg.counter_value("vectorsearch.query.count") - before == 7
    for name in ("vectorsearch.query.duration_ms",
                 "vectorsearch.query.segments_searched",
                 "vectorsearch.query.results_returned"):
        assert reg.histogram_values(name)
    assert (gids[:, 0] == np.arange(7)).all()


def _cross_open(writer, reader, tmp_path, rng, metric):
    """`writer` builds an index on disk (sealed segments, a PENDING one, an
    ACTIVE one whose rows live only in the WAL, tombstones); both packages
    then open it and must answer alike."""
    n = 3 * 512 + 200
    x, q = _blocked(rng, n, 24)
    deleted = rng.integers(0, n - 100, 60)
    alive = np.ones(n, bool)
    alive[deleted] = False
    kw = dict(max_segment_size=512)
    idx = _open(writer, writer.DiskStorage(str(tmp_path), fsync=False), metric, **kw)
    try:
        _populate(idx, x[: n - 100], built=(0, 1), deleted=deleted)
        idx.checkpoint()
        idx.add_all(x[n - 100 :])  # after the checkpoint: in the WAL only
    finally:
        idx.close()
    out = []
    for pkg in (writer, reader):
        idx = _open(pkg, pkg.DiskStorage(str(tmp_path), fsync=False), metric, **kw)
        try:
            states = [s.state.value for s in idx.store.snapshot_segments()]
            assert states == ["SEALED", "SEALED", "PENDING", "ACTIVE"]
            out.append(idx.query_batch_arrays(q, 10))
        finally:
            idx.close()
    _assert_same(out[1], out[0], x, q, alive, metric, 10)


@pytest.mark.parametrize("metric", ["L2", "COSINE"])
def test_port_opens_index_written_by_jax(tmp_path, rng, metric):
    _cross_open(jvs, tvs, tmp_path, rng, metric)


@pytest.mark.parametrize("metric", ["L2", "COSINE"])
def test_jax_opens_index_written_by_port(tmp_path, rng, metric):
    _cross_open(tvs, jvs, tmp_path, rng, metric)


def test_wal_only_rows_survive_reopen(tmp_path, rng):
    """Rows added after the last checkpoint live only in the WAL; reopening
    (in the other package) replays them."""
    x = rng.normal(size=(100, D)).astype(np.float32)
    idx = _open(tvs, tvs.DiskStorage(str(tmp_path), fsync=False))
    try:
        idx.add_all(x[:60])
        idx.checkpoint()
        idx.add_all(x[60:])
        idx.delete(5)
    finally:
        idx.close()
    idx = _open(jvs, jvs.DiskStorage(str(tmp_path), fsync=False))
    try:
        gids, _s, d = idx.query_batch_arrays(x[[5, 70, 99]], 1)
    finally:
        idx.close()
    assert gids[1, 0] == 70 and gids[2, 0] == 99
    assert gids[0, 0] != 5


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_graph_index_written_by_one_package_serves_graph_mode_in_both(
        tmp_path, rng, writer):
    """A graph index (PQ and a graph built at seal, sealed_search_mode=
    "graph") written by either package opens in the other with the same
    graphs and codebooks, and graph mode answers alike: recall@10 within
    0.01, ids overlapping >= 0.98 (the port ranks the traversal with the
    bf16-LUT scan, the JAX package on the CPU with the f32 one)."""
    graph = dict(max_segment_size=512, sealed_search_mode="graph",
                 graph_build_mode="always", pq_build_mode="always")
    n = 3 * 512 + 200
    x, q = _blocked(rng, n, 24)
    truth = np.argsort(_true_dists(x, q, np.ones(n, bool), "L2"), axis=1)[:, :10]
    first, second = (jvs, tvs) if writer == "jax" else (tvs, jvs)
    idx = _open(first, first.DiskStorage(str(tmp_path), fsync=False), **graph)
    try:
        _populate(idx, x, built=(0, 1, 2), deleted=[])
        idx.checkpoint()
        adj = [np.array(idx.store.segments[s].adjacency_np) for s in (0, 1, 2)]
    finally:
        idx.close()
    out = []
    for pkg in (first, second):
        idx = _open(pkg, pkg.DiskStorage(str(tmp_path), fsync=False), **graph)
        try:
            for s, a in zip((0, 1, 2), adj):
                np.testing.assert_array_equal(idx.store.segments[s].adjacency_np, a)
            out.append(idx.query_batch_arrays(q, 10)[0])
        finally:
            idx.close()
    recall = [np.mean([len(set(g) & set(t)) / 10 for g, t in zip(o, truth)])
              for o in out]
    assert abs(recall[0] - recall[1]) <= 0.01 and min(recall) >= 0.9, recall
    overlap = np.mean([len(set(a) & set(b)) / 10 for a, b in zip(*out)])
    assert overlap >= 0.98, overlap
