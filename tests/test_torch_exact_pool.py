"""The port's exact binned pool (vectorsearch_torch/ops/exact.py) held against
the JAX package's Pallas pool (ops/pallas/exact.py, run in interpret mode on
the CPU) on the same numpy inputs. On a CPU tensor the port runs the plain
PyTorch version of its CUDA kernel, so these tests pin the function the
kernel must compute; chip_smoke.py holds the kernel itself against that
plain version on the card.

Tolerances: the JAX kernel scores with split-bf16 products (~2^-16
relative; measured here at most 2^-17 of the bound below), the port in full
f32, so pool scores agree within 2^-15 * (2 ||q|| max||x|| + max||x||^2)
per query (||q|| for cosine), and ids agree in every bin whose best and
second-best rows differ by more than twice that. Final
distances use the JAX tests' own tolerances (test_exact_pallas.py):
L2 rtol 3e-3 / atol 3e-3, cosine atol 2e-4.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from vectorsearch_tpu.ops import traversal as jtr
from vectorsearch_tpu.ops.pallas import exact as pe
from vectorsearch_torch.ops import exact as te
from vectorsearch_torch.ops import traversal as ttr


def _true_scores(q, x, valid, metric):
    """f64 rank scores (the pool's conventions), -inf for invalid rows."""
    q64, x64 = q.astype(np.float64), x.astype(np.float64)
    if metric == "COSINE":
        xn = np.linalg.norm(x64, axis=1)
        s = (q64 @ x64.T) / np.where(xn == 0, 1.0, xn)[None, :]
        s = np.where(xn[None, :] == 0, 0.0, s)
    else:
        s = 2.0 * (q64 @ x64.T) - (x64 * x64).sum(1)[None, :]
    return np.where(valid[None, :], s, -np.inf)


def _tolerance(q, x, metric):
    qn = np.linalg.norm(q.astype(np.float64), axis=1)
    mx = np.linalg.norm(x.astype(np.float64), axis=1).max()
    scale = qn if metric == "COSINE" else 2 * qn * mx + mx * mx
    return 2.0 ** -15 * scale  # [Q]


def _best_two(s, tile, bins, fold):
    """Per-bin (best, second best) of a [Q, N] score matrix under the pool's
    geometry: bin b of group g = rows r // (fold*tile) == g, r % bins == b."""
    qn, n = s.shape
    span = fold * tile
    ng = -(-n // span)
    pad = np.full((qn, ng * span - n), -np.inf)
    t = np.concatenate([s, pad], axis=1).reshape(qn, ng, span // bins, bins)
    t = -np.sort(-t, axis=2)
    return t[:, :, 0, :].reshape(qn, -1), t[:, :, 1, :].reshape(qn, -1)


def _compare_pools(q, x, valid, metric, tile, fold, xn2=None):
    jxn2 = None if xn2 is None else jnp.asarray(xn2)
    js, ji = pe.exact_bin_pool(
        jnp.asarray(q), jnp.asarray(x), jnp.asarray(valid), metric=metric,
        tile_n=tile, interpret=True, fold=fold, xn2=jxn2,
    )
    js, ji = np.asarray(js), np.asarray(ji)
    ts, ti = te.exact_bin_pool(
        torch.from_numpy(q), torch.from_numpy(x), torch.from_numpy(valid),
        metric=metric, tile_n=tile, fold=fold,
        xn2=None if xn2 is None else torch.from_numpy(xn2),
    )
    ts, ti = ts.numpy(), ti.numpy()
    assert ts.shape == js.shape and ti.shape == ji.shape
    assert ti.dtype == np.int32
    tol = _tolerance(q, x, metric)[:, None]
    # dead bins agree exactly; live bins within the score tolerance
    np.testing.assert_array_equal(np.isfinite(ts), np.isfinite(js))
    live = np.isfinite(js)
    assert (np.abs(ts[live] - js[live]) <= np.broadcast_to(tol, ts.shape)[live]).all()
    # ids agree wherever the bin's winner is margin-separated
    tile_, bins, f, _w = te._stage1_params(
        q.shape[0], q.shape[1], x.shape[0], tile, fold, 16384
    )
    best, second = _best_two(_true_scores(q, x, valid, metric), tile_, bins, f)
    with np.errstate(invalid="ignore"):  # -inf - -inf in dead bins
        gap = np.where(live, best - second, 0.0)
    sep = live & (gap > 2 * tol)
    assert sep.sum() > 0.5 * live.sum()
    np.testing.assert_array_equal(ti[sep], ji[sep])
    # the port's ids are the rows its scores came from, and never invalid
    rows = ti[live]
    assert ((rows >= 0) & (rows < x.shape[0])).all()
    assert valid[rows].all()
    return ts, ti


@pytest.mark.parametrize("metric", ["L2", "COSINE"])
@pytest.mark.parametrize("fold", [1, 2])
def test_pool_matches_jax_fold_and_invalid_rows(rng, metric, fold):
    # a non-divisible tail group and a block of invalid rows
    n, d, qn = 3 * 512 + 123, 32, 8
    x = rng.normal(size=(n, d)).astype(np.float32)
    q = rng.normal(size=(qn, d)).astype(np.float32)
    valid = np.ones(n, bool)
    valid[100:140] = False
    _compare_pools(q, x, valid, metric, tile=512, fold=fold)


def test_pool_matches_jax_tail_tile_and_dead_bins(rng):
    # n not a multiple of the tile; only 5 alive rows, so most bins are dead
    n, d = 700, 16
    x = rng.normal(size=(n, d)).astype(np.float32)
    q = rng.normal(size=(3, d)).astype(np.float32)
    valid = np.zeros(n, bool)
    valid[:5] = True
    ts, ti = _compare_pools(q, x, valid, "L2", tile=512, fold=1)
    assert set(ti[np.isfinite(ts)].tolist()) <= {0, 1, 2, 3, 4}
    assert (~np.isfinite(ts)).any()


def test_pool_matches_jax_zero_norm_cosine_row(rng):
    n, d = 512, 8
    x = rng.normal(size=(n, d)).astype(np.float32)
    x[7] = 0.0  # zero-norm row: scores 0.0 by the reference convention
    q = rng.normal(size=(2, d)).astype(np.float32)
    ts, ti = _compare_pools(q, x, np.ones(n, bool), "COSINE", tile=512, fold=1)
    col = np.nonzero(ti[0] == 7)[0]
    if len(col):  # row 7 won its bin only if all its bin-mates score < 0
        assert ts[0, col[0]] == 0.0


@pytest.mark.parametrize("metric", ["L2", "COSINE"])
def test_pool_matches_jax_precomputed_xn2(rng, metric):
    n, d, qn = 1024 + 77, 16, 4
    x = rng.normal(size=(n, d)).astype(np.float32)
    q = rng.normal(size=(qn, d)).astype(np.float32)
    valid = np.ones(n, bool)
    xn2 = (x * x).sum(1).astype(np.float32)
    _compare_pools(q, x, valid, metric, tile=512, fold=None, xn2=xn2)


def test_pool_smallest_row_wins_ties():
    """Equal scores in one bin: the smallest row wins (the TPU kernel's
    strict `>` over ascending rows), in both the plain version and JAX."""
    n, d = 1024, 8
    x = np.zeros((n, d), np.float32)
    x[:, 0] = 1.0  # every row identical
    q = np.ones((2, d), np.float32)
    valid = np.ones(n, bool)
    js, ji = pe.exact_bin_pool(
        jnp.asarray(q), jnp.asarray(x), jnp.asarray(valid), tile_n=512,
        interpret=True, fold=2,
    )
    ts, ti = te.exact_bin_pool(
        torch.from_numpy(q), torch.from_numpy(x), torch.from_numpy(valid),
        tile_n=512, fold=2,
    )
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ti.numpy()[0], np.arange(128))


def _clustered(rng, n, d, qn, n_centers=32):
    # bench-like clusters (centers * 4): neighbour gaps well above the
    # split-bf16 score noise, so most result positions are comparable
    centers = rng.normal(size=(n_centers, d)) * 4
    x = (centers[rng.integers(0, n_centers, n)] + rng.normal(size=(n, d)))
    q = (centers[rng.integers(0, n_centers, qn)] + rng.normal(size=(qn, d)))
    return x.astype(np.float32), q.astype(np.float32)


def _separated_positions(s_true, k, margin):
    """[Q, k] mask of result positions whose true score is more than
    `margin` from its neighbours in the true ranking (ties cannot flip)."""
    t = -np.sort(-s_true, axis=1)[:, : k + 1]
    gap_after = t[:, :k] - t[:, 1 : k + 1]
    gap_before = np.concatenate(
        [np.full((t.shape[0], 1), np.inf), gap_after[:, :-1]], axis=1
    )
    return (gap_after > margin) & (gap_before > margin)


def _scored_both(q, x, valid, metric, ef, k, **kw):
    jps, jpi = pe.exact_pool_scored_pallas(
        jnp.asarray(q), jnp.asarray(x), jnp.asarray(valid), ef_buf=ef,
        metric=metric, tile_n=512, interpret=True, packed=False, **kw,
    )
    jsc, jdi, jiv = map(
        np.asarray, jtr.exact_finalize(jnp.asarray(q), jps, jpi, k, metric)
    )
    tq = torch.from_numpy(q)
    tps, tpi = te.exact_pool_scored(
        tq, torch.from_numpy(x), torch.from_numpy(valid), ef_buf=ef,
        metric=metric, tile_n=512, **kw,
    )
    assert tps.shape == (q.shape[0], ef) and tpi.dtype == torch.int32
    tsc, tdi, tiv = (t.numpy() for t in ttr.exact_finalize(tq, tps, tpi, k, metric))
    return (jsc, jdi, jiv), (tsc, tdi, tiv)


def _check_final(q, x, valid, metric, jax_out, port_out, k):
    (jsc, jdi, jiv), (tsc, tdi, tiv) = jax_out, port_out
    assert tiv.shape == jiv.shape
    margin = 2 * _tolerance(q, x, metric)[:, None]
    sep = _separated_positions(_true_scores(q, x, valid, metric), k, margin)
    assert sep.mean() > 0.5
    np.testing.assert_array_equal(tiv[sep], jiv[sep])
    if metric == "COSINE":
        np.testing.assert_allclose(tsc, jsc, rtol=0, atol=2e-4)
        np.testing.assert_allclose(tdi, jdi, rtol=0, atol=2e-4)
    else:
        np.testing.assert_allclose(tdi, jdi, rtol=3e-3, atol=3e-3)
        np.testing.assert_allclose(tsc, -tdi, rtol=0, atol=0)
    # distances are true distances of the returned rows
    for i in range(q.shape[0]):
        ok = tiv[i] >= 0
        if metric == "L2":
            want = np.linalg.norm(x[tiv[i][ok]] - q[i], axis=1)
            np.testing.assert_allclose(tdi[i][ok], want, rtol=3e-3, atol=3e-3)


@pytest.mark.parametrize("metric", ["L2", "COSINE"])
def test_scored_pool_finalize_matches_jax(rng, metric):
    n, d, qn, k = 2048, 48, 16, 8
    x, q = _clustered(rng, n, d, qn)
    valid = np.ones(n, bool)
    valid[rng.integers(0, n, 40)] = False
    jax_out, port_out = _scored_both(q, x, valid, metric, ef=64, k=k)
    _check_final(q, x, valid, metric, jax_out, port_out, k)


def test_scored_pool_small_topk_branch_matches_jax(rng):
    """w <= 2*ef_buf: the pool is narrower than twice ef (here narrower than
    ef itself), so stage 2 sorts it whole and pads with empty slots."""
    n, d, qn, k = 600, 16, 6, 5
    x = rng.normal(size=(n, d)).astype(np.float32)
    q = x[:qn] + 0.01 * rng.normal(size=(qn, d)).astype(np.float32)
    valid = np.ones(n, bool)
    valid[57] = False
    ef = 512  # W = 2 tiles x 128 bins = 256 < ef
    jps, jpi = pe.exact_pool_scored_pallas(
        jnp.asarray(q), jnp.asarray(x), jnp.asarray(valid), ef_buf=ef,
        tile_n=512, interpret=True, packed=False,
    )
    tps, tpi = te.exact_pool_scored(
        torch.from_numpy(q), torch.from_numpy(x), torch.from_numpy(valid),
        ef_buf=ef, tile_n=512,
    )
    jpi, tpi, tps = np.asarray(jpi), tpi.numpy(), tps.numpy()
    assert tpi.shape == (qn, ef)
    assert ((tpi == -1) == (tps == -np.inf)).all()
    np.testing.assert_array_equal(tpi == -1, jpi == -1)
    for r in range(qn):
        assert tpi[r][0] == r == jpi[r][0]  # each query's own row tops it
    assert not (tpi == 57).any()
    jax_out, port_out = _scored_both(q, x, valid, "L2", ef=ef, k=k)
    _check_final(q, x, valid, "L2", jax_out, port_out, k)


@pytest.mark.parametrize("halve", [1, 2])
def test_stage2_halve_matches_jax(rng, halve):
    n, d, qn, k = 2048, 32, 12, 6
    x, q = _clustered(rng, n, d, qn)
    valid = np.ones(n, bool)
    jax_out, port_out = _scored_both(
        q, x, valid, "L2", ef=64, k=k, stage2_halve=halve
    )
    _check_final(q, x, valid, "L2", jax_out, port_out, k)


def test_halve_pool_matches_jax(rng):
    s = rng.normal(size=(4, 64)).astype(np.float32)
    s[:, ::7] = -np.inf
    i = rng.integers(0, 1000, size=(4, 64)).astype(np.int32)
    js, ji = pe._halve_pool(jnp.asarray(s), jnp.asarray(i), 2)
    ts, ti = te._halve_pool(torch.from_numpy(s), torch.from_numpy(i), 2)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_exact_pool_topk_matches_scored(rng):
    x, q = _clustered(rng, 1024, 16, 4)
    args = (torch.from_numpy(q), torch.from_numpy(x), torch.ones(1024, dtype=torch.bool))
    ids = te.exact_pool_topk(*args, ef_buf=32, tile_n=512)
    np.testing.assert_array_equal(
        ids.numpy(), te.exact_pool_scored(*args, ef_buf=32, tile_n=512)[1].numpy()
    )


def test_packed_pool_not_ported_raises(rng):
    """The packed kernel is reached only through CUDA tensors: its wrapper
    raises on CPU tensors, and packed=True on the CPU runs its plain
    version, which answers."""
    x = rng.normal(size=(64, 8)).astype(np.float32)
    args = (torch.from_numpy(x[:2]), torch.from_numpy(x),
            torch.ones(64, dtype=torch.bool))
    q_in, aux, mult, qn2, _step, geom = te.packed_pool_inputs(*args)
    with pytest.raises(ValueError, match="CUDA"):
        te.exact_pool_packed_cuda(q_in, args[1], aux, mult, qn2, **geom)
    _s, ids = te.exact_pool_scored(*args, ef_buf=8, packed=True)
    assert ids[:, 0].tolist() == [0, 1]


# ------------------------------------ the card kernel's 3xTF32 precision


def _tf32_rna(t: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32 on the f32 bits (finite inputs): round to the
    nearest value with 10 mantissa bits, ties away from zero, by adding half
    of the 13 dropped bits to the magnitude and clearing them."""
    bits = t.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _split_tf32(t: torch.Tensor):
    big = _tf32_rna(t)
    return big, _tf32_rna(t - big)  # t - big is exact in f32


def _three_tf32_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [Q, D] . b [N, D]^T as csrc/exact_pool_tc.cu forms it on the tensor
    cores: small_a.big_b + big_a.small_b + big_a.big_b, each product of two
    TF32 values exact in f32, the sums in f32 (in another order than the
    card's)."""
    ab, as_ = _split_tf32(a)
    bb, bs = _split_tf32(b)
    return as_ @ bb.T + ab @ bs.T + ab @ bb.T


def test_tf32_rna_rounds_to_nearest_ties_away():
    v = torch.tensor([1 + 2**-11, -(1 + 2**-11), 1 + 2**-12, 1 + 2**-10,
                      3.0e-20, -7.25e5])
    got = _tf32_rna(v)
    want = torch.tensor([1 + 2**-10, -(1 + 2**-10), 1.0, 1 + 2**-10,
                         3.0e-20, -7.25e5])
    # 1 + 2^-11 is a tie: away from zero (round-to-even would give 1.0)
    assert got[:4].tolist() == want[:4].tolist()
    assert ((got.view(torch.int32) & 0x1FFF) == 0).all()
    x = torch.from_numpy(np.random.default_rng(3).normal(size=10_000).astype(np.float32))
    big, small = _split_tf32(x)
    assert (x.double() - big.double() == (x - big).double()).all()
    # within half a TF32 step (2^-11 relative) and its split within 2^-22
    assert ((x - big).abs() <= 2.0**-11 * x.abs()).all()
    assert ((x.double() - big.double() - small.double()).abs()
            <= 2.0**-22 * x.abs().double()).all()


@pytest.mark.parametrize("metric", ["L2", "COSINE"])
@pytest.mark.parametrize("scale", [1.0, 1e3])
def test_three_tf32_scores_within_pool_tolerance(rng, metric, scale):
    """The precision argument of the card's B1 kernel: at a sift1m-like
    shape (clustered rows, D 128) and at large magnitudes, 3xTF32 rank
    scores stay within a tenth of the card check's tolerance
    1e-5 * (2 ||q|| max||x|| + max||x||^2) (||q|| for cosine) of a float64
    product, while one TF32 pass does not hold that tolerance."""
    x, q = _clustered(rng, 4096, 128, 64)
    x, q = x * np.float32(scale), q * np.float32(scale)
    tx, tq = torch.from_numpy(x), torch.from_numpy(q)
    valid = torch.ones(4096, dtype=torch.bool)
    q_in, aux, _geom = te.pool_inputs(tq, tx, valid, metric)

    def scores(cross):
        if metric == "COSINE":
            return cross * aux[0].double() + aux[1].double()
        return cross - aux[0].double()

    want = scores(q_in.double() @ tx.double().T)
    qn = np.linalg.norm(q.astype(np.float64), axis=1)
    mx = np.linalg.norm(x.astype(np.float64), axis=1).max()
    tol = torch.from_numpy(qn if metric == "COSINE" else 2 * qn * mx + mx * mx)
    tol = 1e-5 * tol[:, None]
    err3 = (scores(_three_tf32_product(q_in, tx).double()) - want).abs()
    assert (err3 <= tol / 10).all(), float((err3 / tol).max())
    err1 = (scores((_tf32_rna(q_in) @ _tf32_rna(tx).T).double()) - want).abs()
    assert (err1 > tol).any()


# ------------------------------------------------- the live width, d_live


@pytest.mark.parametrize("metric", ["L2", "COSINE"])
def test_scored_pool_with_d_live_equals_the_full_width(metric):
    """exact_pool_scored with d_live (the features past it zero, as the
    index lane-pads its rows) gives the pool it gives without: the same
    scores and ids, bit for bit, in both metrics; the geometry carries the
    live width, and the tile stays the padded D's."""
    rng = np.random.default_rng(960)
    n, d, live = 5_000, 256, 200
    x = np.zeros((n, d), np.float32)
    x[:, :live] = rng.normal(size=(n, live))
    q = np.zeros((40, d), np.float32)
    q[:, :live] = rng.normal(size=(40, live))
    valid = rng.random(n) > 0.1
    args = [torch.from_numpy(a) for a in (q, x, valid)]
    full = te.exact_pool_scored(*args, ef_buf=64, metric=metric, packed=False)
    part = te.exact_pool_scored(*args, ef_buf=64, metric=metric, packed=False,
                                d_live=live)
    assert torch.equal(full[0], part[0]) and torch.equal(full[1], part[1])
    _q_in, _aux, geom = te.pool_inputs(*args, metric=metric, d_live=live)
    assert geom["d_live"] == live
    assert te.pool_inputs(*args, metric=metric)[2] == dict(geom, d_live=d)


@pytest.mark.parametrize("d_live", [0, -3, 257])
def test_kernel_wrapper_rejects_d_live_before_loading(monkeypatch, d_live):
    """exact_pool_cuda refuses a live width outside 1 .. D before it loads
    (or builds) the library or checks the tensors' device."""
    def no_library(*a, **k):
        raise AssertionError("the library was loaded")

    monkeypatch.setattr(te.cuda_build, "load", no_library)
    with pytest.raises(ValueError, match="d_live"):
        te.exact_pool_cuda(torch.zeros(2, 256), torch.zeros(16, 256),
                           torch.zeros(1, 16), metric="L2", tile=512, bins=128,
                           fold=1, w=128, d_live=d_live)


@pytest.mark.parametrize("metric", ["L2", "COSINE"])
@pytest.mark.parametrize("d", [99, 2465])
def test_pad_width_leaves_the_plain_pools_bit_identical(metric, d):
    """The kernel wrappers' padding (_pad_width) gives a width that is no
    multiple of 4 zero columns up to the next one and d_live the original
    width: both plain pools (the two-plane and the packed) give the same
    bits on the padded arguments. The features are small integers, so every
    product and sum is exact in f32 and the check does not depend on the
    order in which the CPU's matrix product sums (which changes with the
    width at D 2,465)."""
    rng = np.random.default_rng(d)
    n = 3 * 512 + 77
    x = rng.integers(-8, 9, size=(n, d)).astype(np.float32)
    q = rng.integers(-8, 9, size=(9, d)).astype(np.float32)
    x[5] = 0.0
    valid = rng.random(n) > 0.1
    args = [torch.from_numpy(a) for a in (q, x, valid)]
    q_in, aux, mult, qn2, _step, geom = te.packed_pool_inputs(
        *args, metric=metric, tile_n=512, fold=2)
    pq, px, d_live = te._pad_width(q_in, args[1], None)
    wide = -(-d // 4) * 4
    assert (pq.shape[1], px.shape[1], d_live) == (wide, wide, d)
    assert not pq[:, d:].any() and not px[:, d:].any()
    two = dict(geom)
    del two["slot_f"]
    for got, want in (
        (te.exact_pool_plain(pq, px, aux, **dict(two, d_live=d_live)),
         te.exact_pool_plain(q_in, args[1], aux, **two)),
        ((te.exact_pool_packed_plain(pq, px, aux, mult, qn2,
                                     **dict(geom, d_live=d_live)),),
         (te.exact_pool_packed_plain(q_in, args[1], aux, mult, qn2, **geom),)),
    ):
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    # a width that is a multiple of 4 passes through as it is, unless x
    # starts off a 16-byte boundary: then it is copied at the same width
    same = te._pad_width(pq, px, d_live)
    assert same[0] is pq and same[1] is px and same[2] == d
    off = torch.cat([torch.zeros(1), px.flatten()])[1:].view(px.shape)
    assert off.data_ptr() % 16
    moved = te._pad_width(pq, off, d_live)
    assert moved[1].data_ptr() % 16 == 0 and torch.equal(moved[1], px)
    assert moved[0].shape == pq.shape and moved[2] == d
