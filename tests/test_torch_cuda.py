"""On the card only (marker ``cuda``; skips without one): the hand-written
exact-pool and ADC kernels against their plain PyTorch versions, and small
exact and flat indexes on the card against the same indexes on the CPU. Run on a machine with a card
(``--noconftest``: tests/conftest.py sets up JAX, which this file does not
need and such a machine may not have):

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda

Tolerance: pool scores within 1e-5 * (2 ||q|| max||x|| + max||x||^2) per
query (||q|| for cosine); the kernel and the plain version are both full
f32 and differ only in summation order. ADC kernels: bit-identical to their
plain versions (the same f32 additions in the same order).
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
@pytest.mark.parametrize("n,tile,fold", [
    (3 * 512 + 123, 512, 1), (3 * 512 + 123, 512, 2), (50_123, None, None),
])
def test_kernel_matches_plain(cuda, rng, metric, n, tile, fold):
    d, qn = 128, 100  # qn not a multiple of the kernel's 64-query tile
    x = rng.normal(size=(n, d)).astype(np.float32)
    x[7] = 0.0
    q = rng.normal(size=(qn, d)).astype(np.float32)
    valid = rng.random(n) > 0.1
    args = [torch.from_numpy(a).to(cuda) for a in (q, x, valid)]
    q_in, aux, geom = te.pool_inputs(*args, metric=metric, tile_n=tile, fold=fold)
    before = te.exact_pool_cuda.launches
    ks, ki = te.exact_pool_cuda(q_in, args[1], aux, **geom)
    assert te.exact_pool_cuda.launches == before + 1
    ps, pi = te.exact_pool_plain(q_in, args[1], aux, **geom)
    torch.cuda.synchronize()
    ks, ki, ps, pi = (t.cpu().numpy() for t in (ks, ki, ps, pi))
    qnorm = np.linalg.norm(q, axis=1)
    mx = np.linalg.norm(x, axis=1).max()
    scale = qnorm if metric == "COSINE" else 2 * qnorm * mx + mx * mx
    live = np.isfinite(ps)
    np.testing.assert_array_equal(np.isfinite(ks), live)
    assert (np.abs(ks[live] - ps[live]) <= np.broadcast_to(
        1e-5 * scale[:, None], ks.shape)[live]).all()
    assert valid[ki[live]].all()
    # ids agree where the winning score is not tied within the tolerance
    agree = np.mean(ki[live] == pi[live])
    assert agree > 0.999, agree


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


@pytest.mark.parametrize("qn,n,m,k,frac", [
    (100, 50_123, 16, 256, 0.9), (37, 5000, 12, 100, 0.5), (20, 3000, 64, 256, 1.0),
])
def test_adc_kernels_match_plain(cuda, rng, qn, n, m, k, frac):
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
