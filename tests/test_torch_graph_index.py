"""The port's graph mode end to end on the CPU (vectorsearch_torch: the graph
built at seal, BEST_FIRST / BEAM / RANDOM_PIVOTS traversal, the unified and
the fused (query, segment) graph routes) held against the JAX package's on
the same index: 3,000 x 16 gaussian-cluster rows in 1,000-row segments, PQ
4 x 64, graph degree 16.

The index is written by the JAX package to DiskStorage and then served by
both, so codebooks and graphs are the same; the two differ only in the scan
that ranks the traversal (the port's bf16-LUT B5 through its plain version,
the JAX package's f32 XLA scan on the CPU). Tolerances: recall@10 within
0.01 of the JAX package's, and result ids overlapping >= 0.98. Where each
package builds its own index, the graphs (built from the raw rows) are
identical and recall@10 stays within 0.01 (the codebooks are trained apart).
"""

import numpy as np
import pytest

import vectorsearch_tpu as jvs
import vectorsearch_torch as tvs
from vectorsearch_torch.core import index as tindex
from vectorsearch_torch.types import SegmentState

D, N, SEG = 16, 3000, 1000
GRAPH = dict(sealed_search_mode="graph", graph_build_mode="always",
             pq_build_mode="always")


def _config(pkg, storage, **kw):
    base = dict(storage=storage, name="g", dimension=D, metric="L2",
                max_segment_size=SEG, pq_m=4, pq_k=64, graph_degree=16,
                graph_build_breadth=64, graph_alpha=1.2, **GRAPH)
    if pkg is tvs:
        base["device"] = "cpu"
    base.update(kw)
    return pkg.VectorIndexConfig(**base)


def _open(pkg, storage, **kw):
    return pkg.VectorIndex.create_or_open(_config(pkg, storage, **kw))


def _data(rng, qn=64):
    centers = rng.normal(size=(60, D)) * 3
    x = (centers[rng.integers(0, 60, N)] + rng.normal(size=(N, D))).astype(np.float32)
    q = (x[rng.integers(0, N, qn)] + 0.3 * rng.normal(size=(qn, D))).astype(np.float32)
    d = np.linalg.norm(x[None].astype(np.float64) - q[:, None], axis=2)
    return x, q, np.argsort(d, axis=1)[:, :10]


def _seal_all(idx):
    while idx.build_queue.has_visible_unclaimed_tasks():
        claim = idx.build_queue.await_and_claim(timeout=1.0)
        if claim is None:
            break
        idx.build_service.build(claim.payload.seg_id)
        claim.complete()


def _recall(gids, truth):
    return float(np.mean([len(set(g) & set(t)) / 10 for g, t in zip(gids, truth)]))


def _overlap(a, b):
    return float(np.mean([len(set(x) & set(y)) / len(x) for x, y in zip(a, b)]))


def _params(pkg, variant):
    if variant == "beam":
        return pkg.SearchParams(mode=pkg.Mode.BEAM, max_iters=4, beam_width=16,
                                ef_search=40)
    if variant == "random_pivots":
        return pkg.SearchParams(ef_search=64, beam_width=16, pivots=4,
                                mode=pkg.Mode.BEST_FIRST,
                                seed_strategy=pkg.SeedStrategy.RANDOM_PIVOTS)
    return pkg.SearchParams(ef_search=64, beam_width=16, mode=pkg.Mode.BEST_FIRST)


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """The JAX package's graph index on disk: three sealed segments."""
    rng = np.random.default_rng(7)
    x, q, truth = _data(rng)
    path = str(tmp_path_factory.mktemp("graph"))
    idx = _open(jvs, jvs.DiskStorage(path, fsync=False))
    try:
        assert idx.add_all(x) == list(range(N))
        _seal_all(idx)
        idx.checkpoint()
    finally:
        idx.close()
    return path, x, q, truth


@pytest.mark.parametrize("variant,kw", [
    ("best_first", {}),
    ("beam", {}),
    ("random_pivots", {}),
    ("best_first", dict(unified_search=True)),
    ("best_first", dict(fuse_multi_segment_queries=True)),
    ("beam", dict(sealed_search_mode="flat")),
])
def test_graph_mode_matches_jax_on_the_same_index(written, variant, kw):
    path, _x, q, truth = written
    out = {}
    for pkg in (jvs, tvs):
        idx = _open(pkg, pkg.DiskStorage(path, fsync=False), **kw)
        try:
            states = [s.state for s in idx.store.snapshot_segments()]
            assert states.count(pkg.SegmentState.SEALED) == 3
            out[pkg] = idx.query_batch_arrays(q, 10, _params(pkg, variant))[0]
        finally:
            idx.close()
    r_jax, r_port = _recall(out[jvs], truth), _recall(out[tvs], truth)
    assert abs(r_port - r_jax) <= 0.01, (r_port, r_jax)
    assert r_port >= 0.9
    assert _overlap(out[tvs], out[jvs]) >= 0.98


def test_graph_mode_takes_the_traversal_route(written, monkeypatch):
    """Graph mode scans each segment once (B5's plain version on the CPU),
    traverses it and uploads its adjacency (the cache gauge counts rows)."""
    from vectorsearch_torch.ops import adc as ta

    path, _x, q, _truth = written
    calls = []
    for mod, name in ((ta, "adc_scan_plain"), (ta, "adc_pool_plain"),
                      (ta, "adc_scores_plain"),
                      (tindex.traversal_ops, "graph_expand")):
        orig = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _o=orig, _n=name, **k:
                            calls.append(_n) or _o(*a, **k))
    idx = _open(tvs, tvs.DiskStorage(path, fsync=False))
    try:
        assert idx.get_adjacency_cache_size() == 0
        idx.query_batch_arrays(q, 10)
        assert sorted(calls) == ["adc_scan_plain"] * 3 + ["graph_expand"] * 3
        assert idx.get_adjacency_cache_size() == N
        calls.clear()
        idx.query_batch_arrays(q, 10, _params(tvs, "best_first").replace(
            seed_strategy=tvs.SeedStrategy.PQ_SEED_ONLY))
        assert calls.count("graph_expand") == 3
    finally:
        idx.close()


def test_each_package_builds_the_same_graph(rng):
    """Both packages seal the same rows into identical graphs (degree 16,
    breadth 64, alpha 1.2), and serve them at recall within 0.01."""
    x, q, truth = _data(rng)
    out, adj = {}, {}
    for pkg in (jvs, tvs):
        idx = _open(pkg, pkg.MemoryStorage())
        try:
            idx.add_all(x)
            _seal_all(idx)
            adj[pkg] = [np.asarray(s.adjacency_np) for s in idx.store.snapshot_segments()
                        if s.state == pkg.SegmentState.SEALED]
            out[pkg] = idx.query_batch_arrays(q, 10)[0]
        finally:
            idx.close()
    assert len(adj[tvs]) == 3
    for a, b in zip(adj[tvs], adj[jvs]):
        assert a.shape == (1024, 16)
        np.testing.assert_array_equal(a, b)
    assert abs(_recall(out[tvs], truth) - _recall(out[jvs], truth)) <= 0.01


def test_default_config_seals_graphs_and_serves_flat(rng):
    """Every mode at the JAX package's default: PQ and a graph at seal, flat
    serving (which never uploads the graph)."""
    x, q, truth = _data(rng)
    idx = tvs.VectorIndex.create_or_open(tvs.VectorIndexConfig(
        storage=tvs.MemoryStorage(), name="d", dimension=D, pq_m=4, pq_k=64,
        max_segment_size=SEG, device="cpu"))
    try:
        assert (idx.config.sealed_search_mode, idx.config.graph_build_mode,
                idx.config.pq_build_mode) == ("flat", "always", "always")
        idx.add_all(x)
        _seal_all(idx)
        for seg in idx.store.snapshot_segments():
            if seg.state == SegmentState.SEALED:
                # degree min(64, rows - 1) = 64: the config default
                assert seg.adjacency_np.shape == (seg.cap_pad, 64)
                live = seg.adjacency_np[: seg.next_row]
                assert (live >= 0).any(axis=1).all()
                assert not (live == np.arange(seg.next_row)[:, None]).any()
        gids = idx.query_batch_arrays(q, 10)[0]
        assert _recall(gids, truth) >= 0.95
        assert idx.get_adjacency_cache_size() == 0
    finally:
        idx.close()


def test_flat_pool_dominates_graph_pool(rng):
    """Port copy of tests/test_index_e2e.py::test_flat_pool_dominates_graph_pool:
    the flat pool recalls at least as well as the traversal at equal ef, and
    deletes are respected on the traversal path."""
    x = rng.normal(size=(300, 8)).astype(np.float32)
    hits = {}
    for mode in ("flat", "graph"):
        idx = _open(tvs, tvs.MemoryStorage(), dimension=8, pq_k=16,
                    max_segment_size=150, sealed_search_mode=mode, oversample=2)
        try:
            gids = idx.add_all(x)
            _seal_all(idx)
            res = idx.query_batch(x[:150], 10)
            hits[mode] = sum(
                1 for i, r in enumerate(res) if gids[i] in [s.gid for s in r])
            victim = idx.query(x[20], 1)[0].gid
            idx.delete(victim)
            assert victim not in [r.gid for r in idx.query(x[20], 20)]
        finally:
            idx.close()
    assert hits["flat"] >= hits["graph"] >= 135


def test_beam_mode_traverses_in_a_flat_config(rng, monkeypatch):
    """Port copy of test_beam_mode_uses_graph_even_in_flat_config: BEAM is a
    traversal concept and traverses a segment's graph under flat mode."""
    seen = []
    orig = tindex.traversal_ops.graph_expand
    monkeypatch.setattr(tindex.traversal_ops, "graph_expand",
                        lambda *a, **k: seen.append(1) or orig(*a, **k))
    x = rng.normal(size=(60, 8)).astype(np.float32)
    idx = _open(tvs, tvs.MemoryStorage(), dimension=8, pq_k=16,
                max_segment_size=50, sealed_search_mode="flat")
    try:
        gids = idx.add_all(x)
        _seal_all(idx)
        params = tvs.SearchParams(mode=tvs.Mode.BEAM, max_iters=4,
                                  beam_width=16, ef_search=40)
        assert gids[7] in [r.gid for r in idx.query(x[7], 10, params)]
        assert seen
    finally:
        idx.close()


def test_random_pivots_append_deterministic_seeds(rng, monkeypatch):
    """Port copy of test_random_pivots_append_diversified_seeds: the seed set
    grows by exactly `pivots` existing rows, the same on every call."""
    captured = []
    orig = tindex.traversal_ops.graph_expand

    def spy(approx, adjacency, exists, seed_idx, *a, **k):
        captured.append(seed_idx.numpy().copy())
        return orig(approx, adjacency, exists, seed_idx, *a, **k)

    monkeypatch.setattr(tindex.traversal_ops, "graph_expand", spy)
    x = rng.normal(size=(100, 8)).astype(np.float32)
    idx = _open(tvs, tvs.MemoryStorage(), dimension=8, pq_k=16,
                max_segment_size=100, oversample=1)
    try:
        idx.add_all(x)
        _seal_all(idx)
        base = tvs.SearchParams(ef_search=50, beam_width=8, max_iters=2,
                                max_explore=100, mode=tvs.Mode.BEAM,
                                seed_strategy=tvs.SeedStrategy.RANDOM_PIVOTS)
        idx.query(x[7], 10, base.replace(pivots=0))
        r1 = idx.query(x[9], 5, base.replace(pivots=6))
        r2 = idx.query(x[9], 5, base.replace(pivots=6))
        lean, rich, rich2 = captured
        assert rich.shape[1] == lean.shape[1] + 6
        assert idx.store.segments[0].exists_np[rich[0, lean.shape[1]:]].all()
        assert np.array_equal(rich, rich2)
        assert [r.gid for r in r1] == [r.gid for r in r2]
        assert r1[0].gid == 9
    finally:
        idx.close()


def test_vacuum_clears_edges_and_removed_rows_stay_out(rng):
    """Vacuum writes -1 into a removed row's adjacency on the host; the
    device graph is not uploaded again (the JAX package's contract): a
    removed row is +inf in every scan, so the traversal never returns or
    expands it."""
    x, q, _truth = _data(rng)
    idx = _open(tvs, tvs.MemoryStorage(), vacuum_min_deleted_ratio=0.01,
                local_maintenance_worker_threads=0)
    try:
        gids = idx.add_all(x)
        _seal_all(idx)
        idx.query_batch_arrays(q, 10)  # the graphs go to the device
        seg = idx.store.segments[0]
        adj_dev = seg.adjacency_dev
        near = idx.query_batch_arrays(q[:8], 5)[0][:, 0]
        dead = sorted({int(g) for g in near if g < SEG} | set(range(0, 100)))
        idx.delete_all([gids[g] for g in dead])
        assert idx.maintenance.vacuum_segment(0) == len(dead)
        assert (seg.adjacency_np[dead] == -1).all()
        assert seg.adjacency_dev is adj_dev
        got = idx.query_batch_arrays(q, 20)[0]
        assert not np.isin(got, dead).any()
    finally:
        idx.close()
