"""The port's flat mode (vectorsearch_torch, ``sealed_search_mode="flat"``
with ``graph_build_mode="skip_for_flat"``, on the CPU) held against the JAX
package's on the same data: the whole slice (add, strict-cap rotation, PQ
training and encoding at seal, ADC candidate pools, exact re-rank, merge)
and each package opening the flat index the other wrote.

The routes: sealed segments of 16,384 rows take the binned ADC pool (B3),
smaller ones the scores scan (B4), ``unified_search=True`` subgroups the
distance scan (B5); the JAX package on the CPU ranks every pool exactly with
the f32 LUT, the port with the bf16 LUT through its kernels' plain versions.
The pools differ only near their boundary, which sits far below the true
neighbours: the data puts each query's neighbours in one block of 64 rows
around a centre, and every pool holds at least 256 candidates. Where each
package trains its own codebook the pools differ more, and still hold the
block. Tolerances: ids equal at result positions whose true distances are
more than 1e-3 (L2) / 1e-5 (cosine) from their neighbours'; distances 1e-4
(both re-rank the same rows exactly in f32).
"""

import numpy as np
import pytest

import vectorsearch_tpu as jvs
import vectorsearch_torch as tvs
from vectorsearch_torch.ops import adc as ta

D = 16
FLAT = dict(sealed_search_mode="flat", graph_build_mode="skip_for_flat",
            pq_build_mode="always")


def _config(pkg, storage, metric="L2", **kw):
    base = dict(storage=storage, name="idx", dimension=D, metric=metric,
                max_segment_size=16_384, pq_m=8, pq_k=64, graph_degree=16,
                graph_build_breadth=64, **FLAT)
    if pkg is tvs:
        base["device"] = "cpu"
    base.update(kw)
    return pkg.VectorIndexConfig(**base)


def _open(pkg, storage, metric="L2", **kw):
    return pkg.VectorIndex.create_or_open(_config(pkg, storage, metric, **kw))


def _blocked(rng, n, qn, block=64, spread=4.0, unit=False):
    n_blocks = -(-n // block)
    centers = rng.normal(size=(n_blocks, D)) * spread
    x = np.repeat(centers, block, axis=0)[:n] + rng.normal(size=(n, D))
    q = centers[rng.integers(0, n // block, qn)] + 0.5 * rng.normal(size=(qn, D))
    if unit:  # cosine ranks as L2 does on unit rows, so the ADC pool holds them
        x /= np.linalg.norm(x, axis=1, keepdims=True)
        q /= np.linalg.norm(q, axis=1, keepdims=True)
    return x.astype(np.float32), q.astype(np.float32)


def _true_dists(x, q, alive, metric):
    x64, q64 = x.astype(np.float64), q.astype(np.float64)
    if metric == "COSINE":
        sim = (q64 @ x64.T) / (np.linalg.norm(q64, axis=1)[:, None]
                               * np.linalg.norm(x64, axis=1)[None, :])
        d = 1.0 - sim
    else:
        d = np.linalg.norm(x64[None, :, :] - q64[:, None, :], axis=2)
    return np.where(alive[None, :], d, np.inf)


def _assert_same(port, ref, x, q, alive, metric, k):
    (pg, ps, pd), (jg, js, jd) = port, ref
    assert pg.shape == jg.shape == (q.shape[0], k)
    t = np.sort(_true_dists(x, q, alive, metric), axis=1)[:, : k + 1]
    gap = t[:, 1:] - t[:, :-1]
    before = np.concatenate([np.full((len(t), 1), np.inf), gap[:, :-1]], axis=1)
    margin = 1e-5 if metric == "COSINE" else 1e-3
    sep = (gap > margin) & (before > margin)
    assert sep.mean() > 0.8
    np.testing.assert_array_equal(pg[sep], jg[sep])
    np.testing.assert_allclose(pd, jd, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ps, js, rtol=1e-4, atol=1e-4)
    # and both found the true top-k
    np.testing.assert_allclose(pd, t[:, :k], rtol=1e-4, atol=1e-4)


def _build_all(idx):
    while idx.build_queue.has_visible_unclaimed_tasks():
        claim = idx.build_queue.await_and_claim(timeout=1.0)
        if claim is None:
            break
        idx.build_service.build(claim.payload.seg_id)
        claim.complete()


def _serve_both(x, q, deleted, k=10, metric="L2", params=None, **kw):
    """Each package builds its own index of x (its own codebooks), seals
    every full segment, tombstones `deleted` and answers q."""
    out = []
    for pkg in (jvs, tvs):
        idx = _open(pkg, pkg.MemoryStorage(), metric, **kw)
        try:
            gids = idx.add_all(x)
            assert gids == list(range(len(x)))
            _build_all(idx)
            idx.delete_all([gids[i] for i in deleted])
            states = [s.state.value for s in idx.store.snapshot_segments()]
            p = None if params is None else params(pkg)
            out.append(idx.query_batch_arrays(q, k, p))
        finally:
            idx.close()
    return out, states


def _layout(rng, seg, n_sealed, qn=32, unit=False):
    n = n_sealed * seg + 1000  # plus an ACTIVE segment
    x, q = _blocked(rng, n, qn, unit=unit)
    deleted = rng.integers(0, n, 200)
    near = np.argsort(_true_dists(x, q[:4], np.ones(n, bool), "L2"), axis=1)
    deleted = np.concatenate([deleted, near[:, :3].ravel()])
    alive = np.ones(n, bool)
    alive[deleted] = False
    return x, q, deleted, alive


@pytest.mark.parametrize("variant", ["per_segment", "unified", "strict", "cosine"])
def test_flat_slice_matches_jax(rng, variant):
    kw, metric = {}, "L2"
    if variant == "unified":
        kw["unified_search"] = True
    elif variant == "strict":
        kw["flat_ef_semantics"] = "strict"
    elif variant == "cosine":
        metric = "COSINE"
    x, q, deleted, alive = _layout(rng, 16_384, 2, unit=metric == "COSINE")
    (ref, port), states = _serve_both(x, q, deleted, metric=metric, **kw)
    assert states == ["SEALED", "SEALED", "ACTIVE"]
    _assert_same(port, ref, x, q, alive, metric, 10)
    assert not np.isin(port[0], deleted).any()


def test_small_segments_match_jax(rng):
    """Sealed segments under 16,384 rows: the scores-scan route (B4)."""
    x, q, deleted, alive = _layout(rng, 4096, 3)
    (ref, port), states = _serve_both(x, q, deleted, max_segment_size=4096)
    assert states == ["SEALED", "SEALED", "SEALED", "ACTIVE"]
    _assert_same(port, ref, x, q, alive, "L2", 10)


@pytest.mark.parametrize("traversal", ["random_pivots", "beam"])
def test_traversal_requests_against_graphless_segments_match_jax(rng, traversal):
    """RANDOM_PIVOTS and BEAM are traversal concepts: against graph-less
    flat segments both packages serve them from the flat pool."""
    x, q, deleted, alive = _layout(rng, 4096, 2)

    def params(pkg):
        if traversal == "beam":
            return pkg.SearchParams(ef_search=150, beam_width=16)
        return pkg.SearchParams(
            ef_search=150, beam_width=16, mode=pkg.Mode.BEST_FIRST,
            seed_strategy=pkg.SeedStrategy.RANDOM_PIVOTS,
        )

    (ref, port), _ = _serve_both(x, q, deleted, params=params,
                                 max_segment_size=4096)
    _assert_same(port, ref, x, q, alive, "L2", 10)


def test_flat_routes_reach_each_kernel(rng, monkeypatch):
    """Per batch: one binned pool per sealed 16,384-row segment, one scores
    scan per smaller sealed segment, one distance scan per segment of a
    unified subgroup."""
    calls = []
    for name in ("adc_pool_plain", "adc_scores_plain", "adc_scan_plain"):
        orig = getattr(ta, name)
        monkeypatch.setattr(
            ta, name,
            lambda *a, _o=orig, _n=name, **k: calls.append(_n) or _o(*a, **k),
        )
    for seg, kw, want in (
        (16_384, {}, ["adc_pool_plain"] * 2),
        (4096, {}, ["adc_scores_plain"] * 2),
        (4096, dict(unified_search=True), ["adc_scan_plain"] * 2),
    ):
        x, q = _blocked(rng, 2 * seg + 100, 8)
        idx = _open(tvs, tvs.MemoryStorage(), max_segment_size=seg, **kw)
        try:
            idx.add_all(x)
            _build_all(idx)
            calls.clear()
            gids, _s, _d = idx.query_batch_arrays(q, 5)
        finally:
            idx.close()
        assert calls == want, (seg, kw, calls)
        assert (gids >= 0).all()


def _cross_open(writer, reader, tmp_path, rng):
    """`writer` builds a flat index on disk (sealed segments with their
    codebooks, a PENDING one, an ACTIVE one whose rows live only in the WAL,
    tombstones); both packages then open it and must answer alike."""
    seg = 4096
    n = 3 * seg + 300
    x, q = _blocked(rng, n, 24)
    deleted = rng.integers(0, n - 100, 60)
    alive = np.ones(n, bool)
    alive[deleted] = False
    kw = dict(max_segment_size=seg)
    idx = _open(writer, writer.DiskStorage(str(tmp_path), fsync=False), **kw)
    try:
        gids = idx.add_all(x[: n - 100])
        for sid in (0, 1):
            idx.build_service.build(sid)
        idx.delete_all([gids[i] for i in deleted])
        idx.checkpoint()
        idx.add_all(x[n - 100 :])  # after the checkpoint: in the WAL only
    finally:
        idx.close()
    out = []
    for pkg in (writer, reader):
        idx = _open(pkg, pkg.DiskStorage(str(tmp_path), fsync=False), **kw)
        try:
            states = [s.state.value for s in idx.store.snapshot_segments()]
            assert states == ["SEALED", "SEALED", "PENDING", "ACTIVE"]
            out.append(idx.query_batch_arrays(q, 10))
        finally:
            idx.close()
    _assert_same(out[1], out[0], x, q, alive, "L2", 10)


def test_port_opens_flat_index_written_by_jax(tmp_path, rng):
    _cross_open(jvs, tvs, tmp_path, rng)


def test_jax_opens_flat_index_written_by_port(tmp_path, rng):
    _cross_open(tvs, jvs, tmp_path, rng)


def test_pqless_segments_under_flat_take_the_exact_pool(tmp_path, rng):
    """Segments sealed by an exact-mode index (no PQ) reopened with flat
    mode are served from the exact pool, as in the JAX package."""
    x, q = _blocked(rng, 2 * 4096 + 200, 16)
    exact = dict(sealed_search_mode="exact", graph_build_mode="skip_for_flat",
                 pq_build_mode="skip_for_exact", max_segment_size=4096)
    idx = _open(tvs, tvs.DiskStorage(str(tmp_path), fsync=False), **exact)
    try:
        idx.add_all(x)
        _build_all(idx)
        want = idx.query_batch_arrays(q, 10)
    finally:
        idx.close()
    idx = _open(tvs, tvs.DiskStorage(str(tmp_path), fsync=False),
                max_segment_size=4096)
    try:
        got = idx.query_batch_arrays(q, 10)
        assert idx._pqless_warned and idx.get_codebook_cache_size() == 0
    finally:
        idx.close()
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_exact_mode_with_pq_at_seal(rng):
    """pq_build_mode="always" in exact mode trains and stores PQ at seal
    (graph-less) and still serves the exact pool."""
    x, q = _blocked(rng, 2 * 4096 + 100, 8)
    idx = _open(tvs, tvs.MemoryStorage(), sealed_search_mode="exact",
                max_segment_size=4096)
    try:
        idx.add_all(x)
        _build_all(idx)
        seg = idx.store.segments[0]
        assert seg.codes_np.shape == (seg.cap_pad, 8)
        assert seg.codebook_np.shape == (8, 64, 2)
        assert seg.adjacency_np.shape == (seg.cap_pad, 0)
        gids, _s, d = idx.query_batch_arrays(q, 10)
    finally:
        idx.close()
    t = np.sort(_true_dists(x, q, np.ones(len(x), bool), "L2"), axis=1)[:, :10]
    np.testing.assert_allclose(d, t, rtol=1e-4, atol=1e-4)


def test_codebook_gauges_and_device_bytes(rng):
    x, q = _blocked(rng, 2 * 4096 + 100, 4)
    idx = _open(tvs, tvs.MemoryStorage(), max_segment_size=4096)
    try:
        idx.add_all(x)
        _build_all(idx)
        assert idx.get_codebook_cache_size() == 0
        idx.query_batch_arrays(q, 5)
        assert idx.get_codebook_cache_size() == 2
        seg = idx.store.segments[0]
        # vectors f32, two bool planes, u8 codes, f32 codebook
        assert seg.device_resident_bytes() == (
            seg.cap_pad * seg.d_pad * 4 + 2 * seg.cap_pad
            + seg.cap_pad * 8 + 8 * 64 * 2 * 4
        )
    finally:
        idx.close()


def test_segment_batches_answer_alike(rng, monkeypatch):
    """The per-segment flat route batches a group's segments into each call
    as far as the re-rank block's budget allows: one segment per call and
    the whole group in one call give the same answers, bit for bit."""
    from vectorsearch_torch.core import index as tindex

    x, q, deleted, _alive = _layout(rng, 4096, 3)
    idx = _open(tvs, tvs.MemoryStorage(), max_segment_size=4096)
    try:
        gids = idx.add_all(x)
        _build_all(idx)
        idx.delete_all([gids[i] for i in deleted])
        together = idx.query_batch_arrays(q, 10)
        monkeypatch.setattr(tindex, "_RERANK_BLOCK_BYTES", 1)
        alone = idx.query_batch_arrays(q, 10)
    finally:
        idx.close()
    for a, b in zip(together, alone):
        np.testing.assert_array_equal(a, b)
    assert not np.isin(together[0], deleted).any()
