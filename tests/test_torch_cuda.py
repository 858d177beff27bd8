"""On the card only (marker ``cuda``; skips without one): the hand-written
exact-pool (two-plane and packed) and ADC kernels against their plain
PyTorch versions, small
exact, flat and graph indexes on the card against the same indexes on the
CPU, the graph build and its fused kNN route (B1) and the traversal on the
card. Run on a machine with a card
(``--noconftest``: tests/conftest.py sets up JAX, which this file does not
need and such a machine may not have):

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda

Tolerance: pool scores within 1e-5 * (2 ||q|| max||x|| + max||x||^2) per
query (||q|| for cosine); the plain version is full f32 and the two-plane
kernel forms its product from three TF32 tensor-core passes (3xTF32, a
relative error of ~2^-21, FP32's class; tests/test_torch_exact_pool.py
holds the argument on the CPU). ADC kernels: bit-identical to their
plain versions (the same f32 additions in the same order). Packed pool
(3xTF32 on the tensor cores too, each 32-feature chunk summed apart;
tests/test_torch_exact_packed.py holds the argument on the CPU):
quantized levels within 1 step, dead bins in the same places, and the same
slot in all but a few bins (a raw near-tie inside a tile, or two tiles on
one step, may resolve apart). Graph build: edge sets overlapping >= 0.99
with the CPU's (the card's full-f32 products sum in another order, which
can flip a RobustPrune comparison that sits within rounding of its bound).
Traversal: identical to the CPU's on tie-free inputs.
"""

import numpy as np
import pytest
import torch

import vectorsearch_torch as tvs
from vectorsearch_torch.ops import adc as ta
from vectorsearch_torch.ops import exact as te

pytestmark = pytest.mark.cuda


@pytest.fixture
def rng():
    return np.random.default_rng(42)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("metric", ["L2", "COSINE"])
@pytest.mark.parametrize("n,tile,fold,d,qn,scale", [
    (3 * 512 + 123, 512, 1, 128, 100, 1.0),
    (3 * 512 + 123, 512, 2, 128, 100, 1.0),
    (50_123, None, None, 128, 100, 1.0),
    # a feature count that leaves the last 32-feature chunk part empty
    (50_123, None, None, 96, 100, 1.0),
    (50_123, None, None, 100, 100, 1.0),
    # partial query tiles (the kernel's tile is up to 128 queries)
    (50_123, None, None, 128, 1, 1.0),
    (50_123, None, None, 128, 513, 1.0),
    # large magnitudes through the big/small TF32 split
    (50_123, None, None, 128, 100, 1e3),
    # Q x W of a single block: one query tile, one column block (W 128)
    (3 * 512 + 123, 512, 4, 128, 100, 1.0),
    # wide rows: the widest whose query planes stay resident at 8 queries a
    # tile, one feature more (streamed, 4-byte copies), and a published
    # embedding width (streamed, 64 queries a tile)
    (20_123, None, None, 2464, 3, 1.0),
    (20_123, None, None, 2465, 3, 1.0),
    (20_123, None, None, 3072, 100, 1.0),
])
def test_kernel_matches_plain(cuda, rng, metric, n, tile, fold, d, qn, scale):
    x = rng.normal(size=(n, d)).astype(np.float32) * np.float32(scale)
    x[7] = 0.0
    q = rng.normal(size=(qn, d)).astype(np.float32) * np.float32(scale)
    valid = rng.random(n) > 0.1
    args = [torch.from_numpy(a).to(cuda) for a in (q, x, valid)]
    q_in, aux, geom = te.pool_inputs(*args, metric=metric, tile_n=tile, fold=fold)
    if tile == 512 and fold == 4:
        assert geom["w"] == 128
    before = te.exact_pool_cuda.launches
    ks, ki = te.exact_pool_cuda(q_in, args[1], aux, **geom)
    assert te.exact_pool_cuda.launches == before + 1
    ps, pi = te.exact_pool_plain(q_in, args[1], aux, **geom)
    torch.cuda.synchronize()
    ks, ki, ps, pi = (t.cpu().numpy() for t in (ks, ki, ps, pi))
    qnorm = np.linalg.norm(q, axis=1)
    mx = np.linalg.norm(x, axis=1).max()
    bound = qnorm if metric == "COSINE" else 2 * qnorm * mx + mx * mx
    live = np.isfinite(ps)
    np.testing.assert_array_equal(np.isfinite(ks), live)
    assert (np.abs(ks[live] - ps[live]) <= np.broadcast_to(
        1e-5 * bound[:, None], ks.shape)[live]).all()
    assert valid[ki[live]].all()
    # ids agree where the winning score is not tied within the tolerance
    agree = np.mean(ki[live] == pi[live])
    assert agree > 0.999, agree


@pytest.mark.parametrize("metric", ["L2", "COSINE"])
@pytest.mark.parametrize("n,tile,fold,d,d_live,qn", [
    (3 * 512 + 123, 512, 2, 128, None, 100),
    (5 * 512 + 77, 512, 4, 128, None, 100),
    (50_123, None, None, 128, None, 100),
    # query tiles of 8, 64 and 128 (partial at 40)
    (50_123, None, None, 128, None, 8),
    (50_123, None, None, 128, None, 40),
    (50_123, None, None, 128, None, 512),
    # fold 1, and fold 8 over three groups (the last one partial)
    (50_123, None, 1, 128, None, 40),
    (40_000, None, 8, 128, None, 512),
    # Deep10M's rows: 96 live features lane-padded to 128, the pad skipped
    (50_123, None, None, 128, 96, 512),
    # a live width whose last 16-byte copy is part zero-filled
    (20_123, None, None, 128, 98, 40),
    # widths that are no multiple of 32: 16-byte copies, and 4-byte ones
    (50_123, None, None, 100, None, 100),
    (20_123, None, None, 99, None, 40),
    # the streamed query tile (rows too wide for resident planes)
    (20_123, None, None, 3072, None, 100),
])
def test_packed_kernel_matches_plain(cuda, rng, metric, n, tile, fold, d,
                                     d_live, qn):
    x = rng.normal(size=(n, d)).astype(np.float32)
    x[7] = 0.0
    q = rng.normal(size=(qn, d)).astype(np.float32)
    if d_live is not None:
        x[:, d_live:] = 0.0
    valid = rng.random(n) > 0.1
    args = [torch.from_numpy(a).to(cuda) for a in (q, x, valid)]
    q_in, aux, mult, qn2, _step, geom = te.packed_pool_inputs(
        *args, metric=metric, tile_n=tile, fold=fold, d_live=d_live)
    assert geom["d_live"] == (d if d_live is None else d_live)
    before = te.exact_pool_packed_cuda.launches
    kp = te.exact_pool_packed_cuda(q_in, args[1], aux, mult, qn2, **geom)
    assert te.exact_pool_packed_cuda.launches == before + 1
    pp = te.exact_pool_packed_plain(q_in, args[1], aux, mult, qn2, **geom)
    torch.cuda.synchronize()
    kp, pp = kp.cpu().numpy(), pp.cpu().numpy()
    live = np.isfinite(pp)
    np.testing.assert_array_equal(np.isfinite(kp), live)
    f = geom["slot_f"]
    kl, pl = np.floor(kp[live] / f), np.floor(pp[live] / f)
    assert np.abs(kl - pl).max() <= 1
    assert np.mean((kp[live] - kl * f) == (pp[live] - pl * f)) > 0.99
    assert (kp[live] == np.round(kp[live])).all()


def test_kernel_rejects_too_many_row_slices(cuda, rng):
    x = torch.from_numpy(rng.normal(size=(2000, 16)).astype(np.float32)).to(cuda)
    valid = torch.ones(2000, dtype=torch.bool, device=cuda)
    q_in, aux, geom = te.pool_inputs(x[:4], x, valid, tile_n=512)
    before = te.exact_pool_cuda.launches
    with pytest.raises(ValueError, match="row slices per pool group"):
        te.exact_pool_cuda(q_in, x, aux, **dict(geom, fold=2**15, w=geom["bins"]))
    assert te.exact_pool_cuda.launches == before


def test_packed_wrapper_rejects_bad_arguments(cuda, rng):
    x = torch.from_numpy(rng.normal(size=(2000, 16)).astype(np.float32)).to(cuda)
    valid = torch.ones(2000, dtype=torch.bool, device=cuda)
    q_in, aux, mult, qn2, _step, geom = te.packed_pool_inputs(x[:4], x, valid)
    for bad in (
        dict(q_in=q_in.double()), dict(mult=mult.cpu()), dict(qn2=qn2[:2]),
        dict(geom=dict(geom, w=geom["w"] + geom["bins"])),
        dict(geom=dict(geom, slot_f=geom["slot_f"] * 2)),
        # the shared tensor-core kernel's limits: live width 1 .. D, and
        # 16-bit slice ids
        dict(geom=dict(geom, d_live=0)), dict(geom=dict(geom, d_live=17)),
        dict(geom=dict(geom, fold=2**15, w=geom["bins"],
                       slot_f=float(2**15 * (geom["tile"] // geom["bins"])))),
    ):
        a = dict(q_in=q_in, mult=mult, qn2=qn2, geom=geom) | bad
        with pytest.raises(ValueError):
            te.exact_pool_packed_cuda(a["q_in"], x, aux, a["mult"], a["qn2"],
                                      **a["geom"])


def test_index_on_the_card_matches_the_cpu(cuda, rng):
    x = rng.normal(size=(40_000, 16)).astype(np.float32)
    q = x[:64] + 0.05 * rng.normal(size=(64, 16)).astype(np.float32)
    out = []
    for device in ("cpu", "cuda"):
        idx = tvs.VectorIndex.create_or_open(tvs.VectorIndexConfig(
            storage=tvs.MemoryStorage(), name="c", dimension=16,
            max_segment_size=10_000, pq_m=4, device=device,
            sealed_search_mode="exact", graph_build_mode="skip_for_flat",
            pq_build_mode="skip_for_exact",
        ))
        try:
            idx.add_all(x)
            for sid in range(3):
                idx.build_service.build(sid)
            out.append(idx.query_batch_arrays(q, 10))
        finally:
            idx.close()
    (cg, cs, cd), (gg, gs, gd) = out
    assert (gg[:, 0] == np.arange(64)).all()
    assert np.mean(cg == gg) > 0.99
    np.testing.assert_allclose(gd, cd, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("qn,n,m,k,frac,ties", [
    (100, 50_123, 16, 256, 0.9, False), (37, 5000, 12, 100, 0.5, False),
    (20, 3000, 64, 256, 1.0, False),
    # the line widths of B3 and B5-precise: one query (1-query lines), a
    # tile that is no multiple of the line, a wide LUT on narrow lines
    (1, 50_123, 16, 256, 0.9, False), (9, 20_123, 12, 100, 0.7, False),
    (9, 20_123, 64, 256, 0.9, False), (100, 20_123, 64, 256, 0.9, False),
    (100, 20_123, 12, 100, 0.9, False), (1, 5000, 64, 256, 1.0, False),
    # an integer-valued LUT: sums tie often, so pool ids hold the tie rule
    (100, 50_123, 16, 256, 0.9, True), (9, 20_123, 12, 100, 0.7, True),
    # B4's route: a 512-query batch over a segment under 16,384 rows (its
    # scans split each query tile's columns over the blocks it gets)
    (512, 10_112, 16, 256, 0.99, False),
])
def test_adc_kernels_match_plain(cuda, rng, qn, n, m, k, frac, ties):
    if ties:
        lut = torch.from_numpy(rng.integers(0, 3, (qn, m, k)).astype(np.float32)).to(cuda)
    else:
        lut = torch.from_numpy(rng.random((qn, m, k)).astype(np.float32) * 9).to(cuda)
    codes = torch.from_numpy(rng.integers(0, k, (n, m)).astype(np.uint8)).to(cuda)
    valid = torch.from_numpy(rng.random(n) < frac).to(cuda)
    lh = ta.lut_bf16(lut)
    hi, lo = ta.lut_hi_lo(lut)
    tile, bins, fold, w = ta.pool_geometry(qn, m, k, n)
    geom = dict(tile=tile, bins=bins, fold=fold, w=w)
    for kernel, plain, args, kw in (
        (ta.adc_pool_cuda, ta.adc_pool_plain, (lh, codes, valid), geom),
        (ta.adc_scores_cuda, ta.adc_scores_plain, (lh, codes, valid), {}),
        (ta.adc_scan_cuda, ta.adc_scan_plain, (lh, codes, valid), {}),
        (ta.adc_scan_precise_cuda, ta.adc_scan_precise_plain, (hi, lo, codes, valid), {}),
    ):
        before = kernel.launches
        got = kernel(*args, **kw)
        assert kernel.launches == before + 1
        want = plain(*args, **kw)
        torch.cuda.synchronize()
        if kernel is ta.adc_pool_cuda:
            live = torch.isfinite(want[0])
            assert torch.equal(live, torch.isfinite(got[0]))
            assert torch.equal(got[0][live], want[0][live])
            assert torch.equal(got[1][live], want[1][live])
            assert bool((got[1][~live] == -1).all())
        else:
            assert torch.equal(got, want)


@pytest.mark.parametrize("n", [10_112, 50_123])
def test_segment_planes_match_plain(cuda, rng, n):
    """A group's pools and scores written by one launch per segment into one
    plane (the wrappers' ``out``) equal the plain versions', segment by
    segment."""
    s_count, qn, m, k = 3, 40, 16, 256
    lh = ta.lut_bf16(torch.from_numpy(
        rng.random((s_count, qn, m, k)).astype(np.float32) * 9).to(cuda))
    codes = [torch.from_numpy(rng.integers(0, k, (n, m)).astype(np.uint8)).to(cuda)
             for _ in range(s_count)]
    valids = [torch.from_numpy(rng.random(n) < f).to(cuda) for f in (1.0, 0.5, 0.02)]
    before = (ta.adc_pool_cuda.launches, ta.adc_scores_cuda.launches)
    outs, outi = ta.adc_bin_pools(lh, codes, valids)
    scores = ta.adc_scores_many(lh, codes, valids)
    assert (ta.adc_pool_cuda.launches, ta.adc_scores_cuda.launches) == (
        before[0] + s_count, before[1] + s_count)
    tile, bins, fold, w = ta.pool_geometry(qn, m, k, n)
    for i in range(s_count):
        ps, pi = ta.adc_pool_plain(lh[i], codes[i], valids[i], tile=tile,
                                   bins=bins, fold=fold, w=w)
        live = torch.isfinite(ps)
        assert torch.equal(outs[i], ps)
        assert torch.equal(outi[i][live], pi[live])
        assert torch.equal(scores[i], ta.adc_scores_plain(lh[i], codes[i], valids[i]))


def test_flat_index_on_the_card_matches_the_cpu(cuda, rng):
    x = rng.normal(size=(40_000, 16)).astype(np.float32)
    q = x[:64] + 0.05 * rng.normal(size=(64, 16)).astype(np.float32)
    out = []
    for device in ("cpu", "cuda"):
        idx = tvs.VectorIndex.create_or_open(tvs.VectorIndexConfig(
            storage=tvs.MemoryStorage(), name="c", dimension=16,
            max_segment_size=18_000, pq_m=8, pq_k=64, device=device,
            sealed_search_mode="flat", graph_build_mode="skip_for_flat",
        ))
        try:
            idx.add_all(x)
            for sid in range(2):
                idx.build_service.build(sid)
            out.append(idx.query_batch_arrays(q, 10))
        finally:
            idx.close()
    (cg, cs, cd), (gg, gs, gd) = out
    assert (gg[:, 0] == np.arange(64)).all() and (cg[:, 0] == np.arange(64)).all()
    # the two devices train their own codebooks (other random rows)
    assert np.mean(cg == gg) > 0.9


def test_pq_train_is_reproducible_on_the_card(cuda, rng):
    """The k-means update sums each cluster in row order (a sorted
    index_put_), so two trainings from one seed agree bit for bit."""
    from vectorsearch_torch.ops import pq as tpq

    x = torch.from_numpy(rng.normal(size=(50_000, 128)).astype(np.float32)).to(cuda)
    valid = torch.ones(50_000, dtype=torch.bool, device=cuda)
    cbs = [
        tpq.pq_train(x, valid, m=16, k=256, iters=5,
                     generator=torch.Generator(device=cuda).manual_seed(7))
        for _ in range(2)
    ]
    assert torch.equal(cbs[0], cbs[1])
    assert torch.equal(tpq.pq_encode(x, cbs[0], valid), tpq.pq_encode(x, cbs[1], valid))


def test_global_worker_seals_flat_with_pq_on_the_card(cuda):
    """A global worker with its default device (the card) seals a flat
    index with PQ codes of pq_m columns, and the serving index answers
    those segments through the ADC kernels, not the exact pool."""
    from vectorsearch_torch.core.tasks import GlobalWorkerRunner, TaskQueue

    storage = tvs.MemoryStorage()
    bq, mq = TaskQueue("gb"), TaskQueue("gm")
    producer = tvs.VectorIndex.create_or_open(tvs.VectorIndexConfig(
        storage=storage, name="g", dimension=8, max_segment_size=300,
        pq_m=4, pq_k=16, sealed_search_mode="flat",
        graph_build_mode="skip_for_flat", pq_build_mode="always",
        global_task_queue_config=tvs.GlobalTaskQueueConfig(
            build_queue=bq, maintenance_queue=mq),
    ))
    try:
        x = np.random.default_rng(0).normal(size=(650, 8)).astype(np.float32)
        gids = producer.add_all(x)
        producer.checkpoint()
        runner = GlobalWorkerRunner(storage, tvs.WorkerConfig(), bq, mq)
        try:
            while runner.run_once_build(timeout=0.2):
                pass
            rt = runner._indexes["g"]
            assert rt.config.device.type == "cuda"
        finally:
            runner.close()
        assert producer.refresh() == [0, 1]
        for sid in (0, 1):
            assert producer.store.segments[sid].codes_np.shape[1] == 4
        adc_before = ta.adc_scores_cuda.launches + ta.adc_pool_cuda.launches
        pool_before = (te.exact_pool_cuda.launches
                       + te.exact_pool_packed_cuda.launches)
        got, _s, _d = producer.query_batch_arrays(x[:4], 5)
        assert ta.adc_scores_cuda.launches + ta.adc_pool_cuda.launches > adc_before
        assert (te.exact_pool_cuda.launches
                + te.exact_pool_packed_cuda.launches) == pool_before
        assert list(got[:, 0]) == list(gids[:4])
    finally:
        producer.close()


def _edges(adj):
    return {(i, int(j)) for i, row in enumerate(adj) for j in row if j >= 0}


def test_graph_build_on_the_card_matches_the_cpu(cuda, rng):
    from vectorsearch_torch.ops import graph as tg

    x = torch.from_numpy(rng.normal(size=(3000, 16)).astype(np.float32))
    valid = torch.ones(3000, dtype=torch.bool)
    valid[11] = False
    cpu = tg.build_graph(x, valid, degree=16, l_build=64, alpha=1.2).numpy()
    gpu = tg.build_graph(x.to(cuda), valid.to(cuda), degree=16, l_build=64,
                         alpha=1.2).cpu().numpy()
    a, b = _edges(cpu), _edges(gpu)
    assert len(a & b) / max(len(a), len(b)) >= 0.99


def test_fused_knn_route_launches_the_exact_pool(cuda, rng):
    """knn_candidates' fused route (512-row blocks through exact_pool_topk)
    launches B1 once a block and finds the plain route's candidates."""
    from vectorsearch_torch.ops import graph as tg

    n = 20_000
    centers = rng.normal(size=(n // 16, 32)) * 10
    x = np.repeat(centers, 16, axis=0) + rng.normal(size=(n, 32))
    xd = torch.from_numpy(x.astype(np.float32)).to(cuda)
    valid = torch.ones(n, dtype=torch.bool, device=cuda)
    before = te.exact_pool_cuda.launches
    fi, fd = tg.knn_candidates(xd, valid, 8, fused=True)
    assert te.exact_pool_cuda.launches - before == -(-n // 512)
    pi, _pd = tg.knn_candidates(xd, valid, 8, fused=False)
    fi, pi = fi.cpu().numpy(), pi.cpu().numpy()
    assert np.mean([len(set(a) & set(b)) / 8 for a, b in zip(fi, pi)]) >= 0.98
    assert not (fi == np.arange(n)[:, None]).any()


@pytest.mark.parametrize("variant", [
    "best_first", "beam_min_steps", "row_offsets", "bench_shape",
])
def test_graph_expand_on_the_card_matches_the_cpu(cuda, rng, variant):
    """graph_expand on the card against its CPU run (which
    tests/test_torch_traversal.py holds equal to the JAX package's) on
    tie-free inputs: distinct uniform distances, a random graph with -1
    holes, invalid rows at +inf. Identical candidate ids and distances and
    the same number of steps."""
    from vectorsearch_torch.ops import traversal as tt

    q, n, r, seeds, ef, beam = 6, 2000, 8, 16, 60, 12
    kw = dict(ef_buf=64, beam_buf=16, max_steps=64)
    offset = None
    if variant == "beam_min_steps":
        ef = 1  # exploration ends at once unless min_steps forces hops
        kw.update(max_steps=6, min_steps=3, refine_frontier=False)
    elif variant == "bench_shape":
        # the sift1m graph phase's buffers: ef_buf 256, beam_buf 128, R 32
        q, n, r, seeds, ef, beam = 64, 100_096, 32, 128, 150, 128
        kw = dict(ef_buf=256, beam_buf=128, max_steps=256)
    approx = rng.permutation(q * n).reshape(q, n).astype(np.float32)
    approx[:, rng.random(n) < 0.05] = np.inf
    adj = rng.integers(0, n, size=(n, r)).astype(np.int32)
    adj[rng.random((n, r)) < 0.1] = -1
    if variant == "row_offsets":  # two segments' rows share one table
        adj = np.concatenate([adj, rng.integers(0, n, size=(n, r)).astype(np.int32)])
        offset = torch.from_numpy(np.repeat(np.array([0, n], np.int32), q // 2))
        ef = torch.tensor([20, 40, 60, 30, 50, 10], dtype=torch.int32)
        beam = torch.tensor([4, 8, 16, 2, 6, 16], dtype=torch.int32)
    approx = torch.from_numpy(approx)
    seed_d, seed_i = torch.topk(approx, seeds, dim=1, largest=False)
    seed_i = torch.where(torch.isfinite(seed_d), seed_i.to(torch.int32), -1)
    args = (approx, torch.from_numpy(adj), torch.isfinite(approx).any(dim=0),
            seed_i, seed_d, ef, beam, offset)
    out = []
    for dev in ("cpu", cuda):
        tt.graph_expand.steps = 0
        ids, dist = tt.graph_expand(
            *[a.to(dev) if torch.is_tensor(a) else a for a in args], **kw)
        out.append((ids.cpu(), dist.cpu(), tt.graph_expand.steps))
    (ci, cd, cs), (gi, gd, gs) = out
    assert cs > 0 and (ci >= 0).sum() > q * seeds
    assert torch.equal(gi, ci) and torch.equal(gd, cd) and gs == cs


def test_graph_index_on_the_card_matches_the_cpu(cuda, rng):
    """Graph mode on the card: B5-fast once a segment a batch, answers like
    the CPU's (the same graph build, codebooks trained apart; the traversal
    itself is held identical above)."""
    x = rng.normal(size=(30_000, 16)).astype(np.float32)
    q = x[:64] + 0.05 * rng.normal(size=(64, 16)).astype(np.float32)
    out = []
    for device in ("cpu", "cuda"):
        idx = tvs.VectorIndex.create_or_open(tvs.VectorIndexConfig(
            storage=tvs.MemoryStorage(), name="c", dimension=16,
            max_segment_size=10_000, pq_m=8, pq_k=64, graph_degree=16,
            graph_build_breadth=64, device=device, sealed_search_mode="graph",
        ))
        try:
            idx.add_all(x)
            for sid in range(3):
                idx.build_service.build(sid)
            before = ta.adc_scan_cuda.launches
            out.append(idx.query_batch_arrays(q, 10)[0])
            if device == "cuda":
                assert ta.adc_scan_cuda.launches - before == 3
        finally:
            idx.close()
    cg, gg = out
    assert (gg[:, 0] == np.arange(64)).all() and (cg[:, 0] == np.arange(64)).all()
    assert np.mean(cg == gg) > 0.9
