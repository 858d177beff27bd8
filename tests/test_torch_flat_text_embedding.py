"""The port's default flat mode on a cosine text-embedding corpus at 1,536
features on the CPU (the openai500k-flat configuration: VectorDBBench's
OpenAI 500K x 1,536 case, PQ 192 x 256), held against the benchmark's plain
reference (portbench/reference/knn.py: exact k-NN in float64 under COSINE,
which imports nothing of the program), on rows drawn by the benchmark's
generator (portbench/data.py) with the configuration's data settings.

Five sealed segments of 3,000 rows (3,072 with the capacity's padding) take
the flat route: a LUT product, an ADC pool a segment (below 16,384 rows the
scores scan and an exact top-k, B4's plain form; at the cell's 100,000 rows
B3), the exact re-rank's cosine branch and the merge. The re-rank's block
bound (``core/index.py::_RERANK_BLOCK_BYTES``) is set to three segments'
gathered block, so the five make two calls (three and two), as the cell's
1,536-feature rows make five calls of one. The generator's centres shrink
with the rows (123 for 15,000 rows: 122 rows a centre, the cell's 500,000
over 4,096), so a query's ten nearest rows lie in its own centre, ~0.35-0.38
away, as at the cell's size. The graph is not built (``skip_for_flat``):
flat mode never reads it, and its prune gathers [2,048, 64, 1,536] blocks.

Tolerances:
- distances, absolute: 1e-6. The re-rank scores each candidate in float32:
  a sum of 1,536 products, the two norms (near 1 and 1.27), a quotient and
  1 - sim, each a few units of 2^-24 (1.6e-7 measured here). Products of
  TF32 inputs, one precision down, err by ~4e-5 on these distances: past the
  tolerance more than ten times (shown below with
  tests/test_torch_exact_packed.py's model of the tensor cores).
- ids: every true top-10 row is returned, except at the 10th rank, where a
  row may lose to one whose true distance lies within twice the distance
  tolerance of it (a float32 tie).
- the zero-norm rule (``ops/distance.py``, the reference's): a zero row or a
  zero query has similarity 0, so distance 1, exactly.
"""

import json
import os

import numpy as np
import pytest
import torch

import vectorsearch_torch as tvs
from portbench import check, data
from portbench.reference import knn
from vectorsearch_torch.core import index as index_mod
from vectorsearch_torch.ops import adc as ta
from vectorsearch_torch.ops import pq as pq_ops
from vectorsearch_torch.ops import traversal as traversal_ops
from vectorsearch_torch.utils.metrics import get_registry

SEG = 3_000
CAP = 3_072
K = 10
NQ = 32
D = 1536
ATOL = 1e-6
CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "portbench", "configs", "openai500k-flat.json")
# the traffic's search settings (portbench/traffic/batch512.json)
PARAMS = dict(ef_search=150, beam_width=128, max_iters=6, max_explore=150)


def _config():
    with open(CONFIG) as f:
        return json.load(f)


def _openai_like(n_rows, n_queries, seed):
    """Rows and held-out queries of the openai500k-flat configuration's
    generator, ``n_rows`` of them over as many centres as keep its rows a
    centre."""
    spec = _config()["data"]
    per_centre = spec["rows"] / spec["centres"]
    spec = dict(spec, rows=n_rows, centres=round(n_rows / per_centre))
    inputs = data.make(spec, seed=seed, n_queries=n_queries, n_fresh=0, device="cpu")
    return inputs.rows, inputs.queries


def _open(**index):
    return tvs.VectorIndex.create_or_open(tvs.VectorIndexConfig(
        storage=tvs.MemoryStorage(), name="openai", device="cpu",
        **dict(_config()["index"], max_segment_size=SEG,
               graph_build_mode="skip_for_flat", **index)))


def _params():
    return tvs.SearchParams(mode=tvs.Mode.BEST_FIRST, **PARAMS)


def _spans_since(seq, name):
    return [r for r in get_registry().spans().records if r.seq > seq and r.name == name]


def _last_seq():
    return max((r.seq for r in get_registry().spans().records), default=-1)


@pytest.mark.parametrize("tombstones", [False, True])
def test_cosine_flat_mode_at_1536_features_matches_the_reference(monkeypatch,
                                                                 tombstones):
    rows, q = _openai_like(5 * SEG, NQ, 2**31 + 1536)
    # three segments' gathered block: 512 MiB at the cell's Q 512, ef_buf 256
    monkeypatch.setattr(index_mod, "_RERANK_BLOCK_BYTES", 3 * NQ * 256 * D * 4)
    calls = []
    real = index_mod._flat_segments_query

    def spy(q_in, segs, *a, **kw):
        calls.append([s.meta.segment_id for s in segs])
        return real(q_in, segs, *a, **kw)

    monkeypatch.setattr(index_mod, "_flat_segments_query", spy)
    idx = _open()
    try:
        gids = np.asarray(idx.add_all(rows), np.int64)
        for sid in range(5):
            idx.build_service.build(sid)
        deletes = ()
        if tombstones:
            # in segment 2: the three nearest rows there of the first eight
            # queries, and 300 more
            seg2 = gids[2 * SEG: 3 * SEG]
            near = knn.topk_certain(knn.Log.build(seg2, rows[2 * SEG: 3 * SEG]),
                                    q[:8], np.zeros(8), np.zeros(8), 3, "cpu",
                                    metric="COSINE")[0].ravel()
            rng = np.random.default_rng(1536)
            dead = np.unique(np.concatenate([near, rng.choice(seg2, 300, replace=False)]))
            idx.delete_all(dead.tolist())
            deletes = ((dead, -1.0, -1.0),)
        s0 = _last_seq()
        got_g, got_s, got_d = idx.query_batch_arrays(q, K, _params())
        recs = _spans_since(s0, index_mod.FLAT_CALL)
    finally:
        idx.close()

    # five sealed segments, two calls of three and two, one span each
    assert calls == [[0, 1, 2], [3, 4]]
    assert [r.attrs for r in recs] == [{"segments": n, "rows": CAP, "d": D}
                                       for n in (3, 2)]
    log = knn.Log.build(gids, rows, (), deletes)
    ts = te = np.zeros(NQ)
    assert check.bad_rows(log, got_g, ts, te) == 0  # no tombstone, no repeat
    ref_g, ref_d = knn.topk_certain(log, q, ts, te, K, "cpu", metric="COSINE")
    true_d = knn.distances(log, q, got_g, "cpu", metric="COSINE")
    assert (got_g >= 0).all()
    np.testing.assert_allclose(got_d, true_d, rtol=0, atol=ATOL)
    np.testing.assert_array_equal(got_d, np.float32(1.0) - got_s)
    # a query's nearest rows lie ~0.35 away, its 10th under 0.4, as at the
    # cell's size
    assert 0.3 < float(np.median(ref_d[:, 0])) and float(np.median(ref_d[:, 9])) < 0.4
    for i in range(NQ):
        kth = true_d[i].max()
        for g, d in zip(ref_g[i], ref_d[i]):
            assert g in got_g[i] or d >= kth - 2 * ATOL, (i, g, d, kth)
    if tombstones:
        assert not np.isin(got_g, deletes[0][0]).any()


def test_tf32_products_fail_the_distance_tolerance():
    """The distance tolerance above is tight enough that products one
    precision down fail it: on this configuration's rows, each query's ten
    nearest rows' cosine distances from TF32 inputs err by more than ten
    times it, while the port's re-rank (float32 products and sums) and a
    3xTF32 product with chunk sums (the tensor cores' model in
    tests/test_torch_exact_packed.py) stay within it."""
    from tests.test_torch_exact_packed import _tensor_core_product
    from tests.test_torch_exact_pool import _split_tf32

    rows, q = _openai_like(5 * SEG, NQ, 2**31 + 1537)
    x64, q64 = rows.astype(np.float64), q.astype(np.float64)
    xn, qn = np.linalg.norm(x64, axis=1), np.linalg.norm(q64, axis=1)
    d = 1.0 - (q64 @ x64.T) / (qn[:, None] * xn[None, :])
    near = np.argsort(d, axis=1)[:, :K]
    true = np.take_along_axis(d, near, axis=1)
    xs = torch.from_numpy(rows[near.ravel()])
    tq = torch.from_numpy(q)
    pick = np.arange(near.size).reshape(near.shape)

    def err(product):
        s = product(tq, xs).double().numpy()[np.arange(NQ)[:, None], pick]
        got = 1.0 - s / (qn[:, None] * xn[near])
        return float(np.abs(got - true).max())

    tf32 = err(lambda a, b: _split_tf32(a)[0] @ _split_tf32(b)[0].T)
    assert tf32 > 10 * ATOL, tf32
    assert err(_tensor_core_product(True)) <= ATOL
    alive = torch.ones(len(rows), dtype=torch.bool)
    _s, port_d, ids = traversal_ops.exact_rerank(
        tq, torch.from_numpy(rows), alive, torch.from_numpy(near.astype(np.int32)),
        K, "COSINE")
    np.testing.assert_array_equal(np.sort(ids.numpy(), axis=1), np.sort(near, axis=1))
    np.testing.assert_allclose(np.sort(port_d.double().numpy(), axis=1),
                               np.sort(true, axis=1), rtol=0, atol=ATOL)


def test_b3_takes_two_queries_a_line_at_m192():
    """B3's line width (``_line_queries``): at the cell's LUT, M 192 x K 256
    at Q 512, one query's lines take 98,304 bytes of shared memory, so a
    block of 227 KB holds the lines of two (196,608 bytes) and not of four;
    sift1m's M 16 takes sixteen."""
    pool = ta._POOL
    assert ta._line_queries("adc_pool_cuda", 512, 192, 256, pool) == 2
    assert ta._line_smem(2, 192, 256, pool) == 196_608 <= ta._SMEM_BYTES
    assert ta._line_smem(4, 192, 256, pool) > ta._SMEM_BYTES
    assert ta._line_queries("adc_pool_cuda", 512, 16, 256, pool) == 16
    # a batch of one query still takes one-query lines
    assert ta._line_queries("adc_pool_cuda", 1, 192, 256, pool) == 1


def test_the_plain_pool_at_m192_keeps_adc_lookup_sums():
    """B3's plain form at M 192 over a segment's codes (PQ 192 x 256 trained
    and encoded on the configuration's rows): each live bin holds the
    negated ADC distance of the row it keeps, the sum of that row's 192 LUT
    entries (``pq.adc_lookup`` over the bf16 LUT the kernel reads; float32
    sums in another order, so within 192 roundings), and that row is valid
    and the bin's best."""
    rows, q = _openai_like(4_096, 16, 2**31 + 1538)
    x = torch.from_numpy(rows)
    valid = torch.ones(len(rows), dtype=torch.bool)
    valid[::7] = False
    cb = pq_ops.pq_train(x, valid, m=192, k=256, iters=2,
                         generator=torch.Generator().manual_seed(7))
    codes = pq_ops.pq_encode(x, cb, valid)
    lut = pq_ops.build_lut(torch.from_numpy(q), cb)
    lh = ta.lut_bf16(lut)
    tile, bins, fold, w = ta.pool_geometry(len(q), 192, 256, len(rows), min_w=512)
    neg, ids = ta.adc_pool_plain(lh, codes, valid, tile=tile, bins=bins,
                                 fold=fold, w=w)
    live = torch.isfinite(neg)
    assert bool(live.any())
    r = ids.long().clamp(min=0)
    assert bool(valid[r[live]].all())
    sums = pq_ops.adc_lookup(lh.float(), codes[r].view(len(q), w, 192))
    np.testing.assert_allclose(-neg[live].numpy(), sums[live].numpy(),
                               rtol=192 * 2**-24, atol=0)
    # the bin's best: no valid row of the bin scores higher
    full = torch.where(valid[None, :], -ta._lut_sums(lh, codes), float("-inf"))
    row = torch.arange(len(rows))
    bin_of = (row // (fold * tile)) * bins + row % bins
    best = torch.full((len(q), w), float("-inf")).scatter_reduce(
        1, bin_of[None, :].expand(len(q), -1), full, "amax")
    assert torch.equal(best[live], neg[live])


def test_the_rerank_cosine_branch_at_1536_features():
    """``exact_rerank_segments`` under COSINE at 1,536 features against
    float64, over two segments' tables: distances within the tolerance, the
    order the true one save float32 ties, a zero row at distance 1 exactly,
    a zero query at 1 from every row, a tombstoned candidate and a -1 slot
    dropped."""
    rows, q = _openai_like(2 * SEG, NQ, 2**31 + 1539)
    rows[5] = 0.0  # a zero row
    q[-1] = 0.0  # a zero query
    tables = [torch.from_numpy(rows[:SEG]), torch.from_numpy(rows[SEG:])]
    alive = [torch.ones(SEG, dtype=torch.bool) for _ in tables]
    alive[1][11] = False  # a tombstone
    x64 = [t.double().numpy() for t in tables]
    q64 = q.astype(np.float64)
    rng = np.random.default_rng(1539)
    cand = rng.integers(0, SEG, (2, NQ, 256)).astype(np.int32)
    for s in range(2):  # each query's 40 nearest rows among the candidates
        dots = q64 @ x64[s].T
        cand[s, :, :40] = np.argsort(-dots / np.maximum(
            np.linalg.norm(x64[s], axis=1), 1e-30)[None, :], axis=1)[:, :40]
    cand[0, :, 40] = 5  # the zero row in every query's candidates
    cand[1, :, 41] = 11  # the tombstone
    cand[1, :, 42] = -1  # an empty slot
    sc, di, iv = traversal_ops.exact_rerank_segments(
        torch.from_numpy(q), list(zip(tables, alive)), torch.from_numpy(cand),
        20, "COSINE")
    assert not bool((iv[1] == 11).any())
    for s in range(2):
        got = iv[s].long().numpy()
        assert (got >= 0).all()
        x = x64[s][got]  # [Q, 20, D]
        nq = np.linalg.norm(q64, axis=1)[:, None]
        nx = np.linalg.norm(x, axis=2)
        den = nq * nx
        sim = np.where(den == 0, 0.0, np.einsum("qd,qcd->qc", q64, x)
                       / np.where(den == 0, 1.0, den))
        np.testing.assert_allclose(di[s].double().numpy(), 1.0 - sim, rtol=0,
                                   atol=ATOL)
        np.testing.assert_array_equal(sc[s].numpy(), np.float32(1.0) - di[s].numpy())
        # ascending, save ties within the tolerance
        assert (np.diff(1.0 - sim[:-1], axis=1) >= -2 * ATOL).all()
    # the zero query scores 0 against every row: distance 1 exactly
    assert (di[:, -1] == 1.0).all()
    # the zero row: distance 1 exactly wherever it was kept (a query whose
    # 20 best lie nearer keeps it only as its last resort)
    zero = iv[0] == 5
    assert bool((di[0][zero] == 1.0).all())


def test_flat_call_spans_and_the_sampled_rerank_histogram(monkeypatch):
    """The flat route's instruments: one ``vectorsearch.flat.call`` record
    a call, always, with the call's segments, a segment's capacity and its
    padded width; ``vectorsearch.flat.rerank_ms`` once a sampled batch (every
    second one here), the sum of its calls' re-rank times, and nothing on
    the first sampled dispatch of a shape nor on unsampled batches."""
    x = np.random.default_rng(9).normal(size=(5 * 1_000, 16)).astype(np.float32)
    reg = get_registry()
    idx = tvs.VectorIndex.create_or_open(tvs.VectorIndexConfig(
        storage=tvs.MemoryStorage(), name="calls", device="cpu", dimension=16,
        max_segment_size=1_000, pq_m=4, pq_k=64, sealed_search_mode="flat",
        graph_build_mode="skip_for_flat", query_breakdown_sample_every=2))
    try:
        idx.add_all(x)
        for sid in range(5):
            idx.build_service.build(sid)
        # three segments a call: five segments make two calls
        monkeypatch.setattr(index_mod, "_RERANK_BLOCK_BYTES", 3 * 32 * 256 * 128 * 4)
        before = len(reg.histogram_values(index_mod.FLAT_RERANK_MS))
        per_batch, recorded = [], []
        for b in range(7):
            s0 = _last_seq()
            n0 = len(reg.histogram_values(index_mod.FLAT_RERANK_MS))
            idx.query_batch_arrays(x[:32], 10, _params())
            per_batch.append([r.attrs for r in _spans_since(s0, index_mod.FLAT_CALL)])
            recorded.append(len(reg.histogram_values(index_mod.FLAT_RERANK_MS)) - n0)
    finally:
        idx.close()
    calls = [{"segments": 3, "rows": 1_024, "d": 128},
             {"segments": 2, "rows": 1_024, "d": 128}]
    assert per_batch == [calls] * 7
    # batches 2, 4 and 6 are sampled; 2 is the shape's first sampled dispatch
    assert recorded == [0, 0, 0, 0, 1, 0, 1]
    vals = reg.histogram_values(index_mod.FLAT_RERANK_MS)[before:]
    assert len(vals) == 2 and min(vals) > 0
