"""The port's packed exact pool (vectorsearch_torch/ops/exact.py: the plain
version of csrc/exact_pool_tc.cu's packed kernel, its decode and the packed
route of exact_pool_scored) held against the JAX package's
``exact_bin_pool_packed`` / ``decode_packed_pool`` (Pallas in interpret mode
on the CPU) on the same numpy inputs.

Tolerances: the JAX kernel scores with split-bf16 products (~2^-16
relative), the port in full f32, and both quantize per tile to steps of
scale/SQ (2^-21 of the bound here, finer than that product error). The
pool comparisons therefore use bf16-representable inputs: the split product
is then exact up to the order of the f32 sums, so the quantized levels
floor(p/F) agree within 2 steps (one for the rounding of the quantization,
one for the order of the sums), the -inf (dead) bins agree exactly, and the
decoded rows agree in every bin whose best row beats its runner-up by more
than 3 steps. Decode parity: the same packed plane decodes to identical rows
and to scores within 2^-20 of ||q||^2 + the score (the two packages sum
||q||^2 in a different order).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import vectorsearch_tpu as jvs
import vectorsearch_torch as tvs
from vectorsearch_tpu.ops.pallas import exact as pe
from vectorsearch_torch.ops import exact as te

from vectorsearch_torch.utils.metrics import get_registry

from tests.test_torch_index import SEG, _assert_same, _blocked, _open, _populate
from tests.test_torch_text_embedding import wide_form_stand_in


def _bf16(a):
    return torch.from_numpy(a.astype(np.float32)).bfloat16().float().numpy()


def _inputs(rng, n, d, qn, invalid=(), zero_row=None):
    x = _bf16(rng.normal(size=(n, d)))
    q = _bf16(rng.normal(size=(qn, d)))
    valid = np.ones(n, bool)
    valid[list(invalid)] = False
    if zero_row is not None:
        x[zero_row] = 0.0
    return q, x, valid


def _true_values(q, x, valid, metric):
    """f64 values the packed kernel quantizes: -distance (L2) or cosine
    similarity * 1 (cosine; a zero row scores 0), -inf for invalid rows."""
    q64, x64 = q.astype(np.float64), x.astype(np.float64)
    if metric == "COSINE":
        xn = np.linalg.norm(x64, axis=1)
        v = (q64 @ x64.T) / np.where(xn == 0, 1.0, xn)[None, :]
    else:
        v = -np.linalg.norm(x64[None, :, :] - q64[:, None, :], axis=2)
    return np.where(valid[None, :], v, -np.inf)


def _best_two_rows(v, tile, bins, fold):
    """Per pool column: (best value, runner-up value, best row) under the
    pool geometry."""
    qn, n = v.shape
    span = fold * tile
    ng = -(-n // span)
    t = np.concatenate([v, np.full((qn, ng * span - n), -np.inf)], axis=1)
    t = t.reshape(qn, ng, span // bins, bins)
    order = np.argsort(-t, axis=2, kind="stable")
    srt = np.take_along_axis(t, order, axis=2)
    rows = (np.arange(ng)[None, :, None] * span + order[:, :, 0, :] * bins
            + np.arange(bins)[None, None, :])
    return (srt[:, :, 0, :].reshape(qn, -1), srt[:, :, 1, :].reshape(qn, -1),
            rows.reshape(qn, -1))


def _both_pools(q, x, valid, metric, tile, fold):
    jp, js = pe.exact_bin_pool_packed(
        jnp.asarray(q), jnp.asarray(x), jnp.asarray(valid), metric=metric,
        tile_n=tile, interpret=True, fold=fold,
    )
    tp, ts = te.exact_bin_pool_packed(
        torch.from_numpy(q), torch.from_numpy(x), torch.from_numpy(valid),
        metric=metric, tile_n=tile, fold=fold,
    )
    return (np.asarray(jp), np.asarray(js)), (tp.numpy(), ts.numpy())


def _decode_all(pool, step, q, x, metric, tile, fold):
    qn, w = pool.shape
    pos = torch.arange(w, dtype=torch.int32).repeat(qn, 1)
    return te.decode_packed_pool(
        torch.tensor(pool), pos, torch.tensor(step), torch.from_numpy(q),
        metric, d=q.shape[1], n=x.shape[0], qn=qn, tile_n=tile, fold=fold,
        min_w=16384,
    )


def _compare_packed(q, x, valid, metric, tile, fold):
    (jp, js), (tp, ts) = _both_pools(q, x, valid, metric, tile, fold)
    assert tp.shape == jp.shape and tp.dtype == np.float32
    np.testing.assert_allclose(ts, js, rtol=1e-6, atol=0)
    dead = ~np.isfinite(jp)
    np.testing.assert_array_equal(~np.isfinite(tp), dead)
    tile_, bins, f, _w = te._stage1_params(q.shape[0], q.shape[1], x.shape[0],
                                           tile, fold, 16384)
    slot_f, _sq = te._packed_steps(tile_, bins, f)
    lj = np.floor(np.where(dead, 0.0, jp) / slot_f)
    lt = np.floor(np.where(dead, 0.0, tp) / slot_f)
    assert np.abs(lj - lt).max() <= 2
    # every packed value is an exact f32 integer below 2^24
    live = tp[~dead]
    assert (live == np.round(live)).all() and (np.abs(live) < 2**24).all()
    # rows: identical wherever the bin's winner is 3 steps clear
    best, second, row = _best_two_rows(_true_values(q, x, valid, metric),
                                       tile_, bins, f)
    with np.errstate(invalid="ignore"):
        gap = np.where(dead, 0.0, best - second)
    sep = ~dead & (gap > 3 * ts[:, None].astype(np.float64))
    assert sep.sum() > 0.9 * (~dead).sum()
    _s, rows_t = _decode_all(tp, ts, q, x, metric, tile, fold)
    _s, rows_j = _decode_all(jp, js, q, x, metric, tile, fold)
    rows_t, rows_j = rows_t.numpy(), rows_j.numpy()
    np.testing.assert_array_equal(rows_t[sep], rows_j[sep])
    np.testing.assert_array_equal(rows_t[sep], row[sep])
    assert valid[rows_t[~dead]].all()
    assert (rows_t[dead] == -1).all()
    return tp, ts


@pytest.mark.parametrize("metric", ["L2", "COSINE"])
@pytest.mark.parametrize("fold", [1, 2, 4])
def test_packed_pool_matches_jax(rng, metric, fold):
    # 6 tiles of 512: with fold 4 the second group holds only 2 tiles
    q, x, valid = _inputs(rng, 5 * 512 + 123, 32, 8, invalid=range(100, 140),
                          zero_row=9 if metric == "COSINE" else None)
    _compare_packed(q, x, valid, metric, tile=512, fold=fold)


def test_packed_pool_matches_jax_tail_and_dead_bins(rng):
    # a tail tile, only 5 valid rows: most bins are dead
    q, x, valid = _inputs(rng, 700, 16, 3, invalid=range(5, 700))
    tp, _ts = _compare_packed(q, x, valid, "L2", tile=512, fold=2)
    assert (~np.isfinite(tp)).any()


def test_packed_decode_matches_jax(rng):
    """One packed plane (the JAX package's) through both decodes: the same
    rows and the same scores (the tolerance covers the order of ||q||^2's
    sum)."""
    for metric in ("L2", "COSINE"):
        q, x, valid = _inputs(rng, 3 * 512 + 77, 16, 6, invalid=range(40, 60))
        jp, js = pe.exact_bin_pool_packed(
            jnp.asarray(q), jnp.asarray(x), jnp.asarray(valid), metric=metric,
            tile_n=512, interpret=True, fold=2,
        )
        pos = np.argsort(-np.asarray(jp), axis=1, kind="stable")[:, :40]
        pos = pos.astype(np.int32)
        vals = np.take_along_axis(np.asarray(jp), pos, axis=1)
        geo = dict(d=16, n=x.shape[0], qn=6, tile_n=512, fold=2, min_w=16384)
        j_s, j_r = pe.decode_packed_pool(
            jnp.asarray(vals), jnp.asarray(pos), js, jnp.asarray(q), metric, **geo
        )
        t_s, t_r = te.decode_packed_pool(
            torch.from_numpy(vals), torch.from_numpy(pos),
            torch.tensor(np.asarray(js)), torch.from_numpy(q), metric, **geo
        )
        assert t_r.dtype == torch.int32 and t_s.dtype == torch.float32
        np.testing.assert_array_equal(t_r.numpy(), np.asarray(j_r))
        j_s = np.asarray(j_s)
        np.testing.assert_array_equal(np.isfinite(t_s.numpy()), np.isfinite(j_s))
        fin = np.isfinite(j_s)
        scale = (q.astype(np.float64) ** 2).sum(1)[:, None] + np.abs(j_s)
        assert (np.abs(t_s.numpy() - j_s)[fin] <= (2.0 ** -20 * scale)[fin]).all()


def _clustered(rng, n, d, qn, k=12):
    centers = rng.normal(size=(k, d)) * 10
    x = centers[rng.integers(0, k, n)] + rng.normal(size=(n, d))
    q = centers[rng.integers(0, k, qn)] + rng.normal(size=(qn, d))
    return x.astype(np.float32), q.astype(np.float32)


def _scored(pkg_fn, q, x, valid, **kw):
    if pkg_fn is te.exact_pool_scored:
        s, i = te.exact_pool_scored(torch.from_numpy(q), torch.from_numpy(x),
                                    torch.from_numpy(valid), **kw)
        return s.numpy(), i.numpy()
    s, i = pe.exact_pool_scored_pallas(jnp.asarray(q), jnp.asarray(x),
                                       jnp.asarray(valid), interpret=True, **kw)
    return np.asarray(s), np.asarray(i)


@pytest.mark.parametrize("metric", ["L2", "COSINE"])
def test_packed_pool_matches_two_plane(rng, metric):
    """The port's counterpart of the JAX test of the same name: the packed
    route returns the two-plane route's candidates and scores within one
    quantization step of the true rank scores; and the JAX package's packed
    route returns the same candidate sets."""
    n, d, qn, ef = 3072, 32, 24, 32
    x, q = _clustered(rng, n, d, qn)
    valid = np.ones(n, bool)
    valid[rng.integers(0, n, 64)] = False
    kw = dict(ef_buf=ef, metric=metric, tile_n=512)
    s_p, i_p = _scored(te.exact_pool_scored, q, x, valid, packed=True, **kw)
    s_t, i_t = _scored(te.exact_pool_scored, q, x, valid, packed=False, **kw)
    _s, i_j = _scored(pe.exact_pool_scored_pallas, q, x, valid, packed=True, **kw)
    for other in (i_t, i_j):
        agree = np.mean([
            len(set(i_p[i][i_p[i] >= 0]) & set(other[i][other[i] >= 0]))
            / max(1, (other[i] >= 0).sum())
            for i in range(qn)
        ])
        assert agree >= 0.95, agree
    assert valid[i_p[i_p >= 0]].all()
    x64, q64 = x.astype(np.float64), q.astype(np.float64)
    if metric == "L2":
        true_s = 2.0 * (q64 @ x64.T) - (x64 * x64).sum(1)[None, :]
        maxd = np.linalg.norm(q64, axis=1) + np.sqrt((x64 * x64).sum(1)[valid].max())
        # score error = |d(dist^2)| <= 2 * maxd * (one distance step)
        tol = 2 * maxd * (maxd / (1 << 21)) + 1e-3
    else:
        xn = np.linalg.norm(x64, axis=1)
        true_s = (q64 @ x64.T) / np.where(xn == 0, 1.0, xn)[None, :]
        scale = np.linalg.norm(q64, axis=1)
        tol = scale / (1 << 21) * 1.5 + 1e-3
    for i in range(qn):
        ok = i_p[i] >= 0
        err = np.abs(s_p[i][ok] - true_s[i][i_p[i][ok]])
        assert (err <= tol[i]).all(), (err.max(), tol[i])


@pytest.mark.parametrize("case", ["small_topk_branch", "decode_roundtrip_all_slots"])
def test_packed_pool_jax_cases(rng, case):
    """The port's counterparts of test_packed_pool_small_topk_branch (a pool
    narrower than ef: stage 2 sorts it whole, pads, and decode survives the
    padding) and test_packed_decode_roundtrip_all_slots (q = 0 ranks rows by
    norm, so every bin's winner is known), each also held to the JAX
    package's packed route on the same inputs."""
    if case == "small_topk_branch":
        n, d, qn = 600, 16, 8
        x = rng.normal(size=(n, d)).astype(np.float32)
        q = x[:qn] + 0.01 * rng.normal(size=(qn, d)).astype(np.float32)
        valid = np.ones(n, bool)
        valid[57] = False
        kw = dict(ef_buf=512, metric="L2", tile_n=512, packed=True)
    else:
        n, d, qn = 4096, 16, 4
        base = rng.normal(size=(n, d)).astype(np.float32)
        base /= np.linalg.norm(base, axis=1, keepdims=True)
        x = base * (1.0 + np.arange(n) / n).astype(np.float32)[:, None]
        q = np.zeros((qn, d), np.float32)
        valid = np.ones(n, bool)
        kw = dict(ef_buf=64, metric="L2", tile_n=512, fold=2, packed=True)
    s, i = _scored(te.exact_pool_scored, q, x, valid, **kw)
    js, ji = _scored(pe.exact_pool_scored_pallas, q, x, valid, **kw)
    assert i.shape == ji.shape == (qn, kw["ef_buf"]) and i.dtype == np.int32
    assert ((i == -1) == (s == -np.inf)).all()
    if case == "small_topk_branch":
        for r in range(qn):
            assert r in set(i[r][i[r] >= 0])
        assert not (i == 57).any()
        np.testing.assert_array_equal(i == -1, ji == -1)
        for r in range(qn):
            assert set(i[r][i[r] >= 0]) == set(ji[r][ji[r] >= 0])
    else:
        assert ((i >= 0) & (i < n)).all()
        assert (i[:, 0] == 0).all()
        # each bin's smallest-norm row, in both packages, in the same order
        np.testing.assert_array_equal(i, ji)


@pytest.mark.parametrize("n,packed", [
    (1_999_999, False), (2_000_000, True),
    (2_000_128, True),  # the Deep10M 2-segment subgroup, 2 x pad_cap(1M)
])
def test_packed_default_threshold(n, packed):
    assert te._packed_default(n) is packed
    assert pe._packed_default(n) is packed


def _spy(monkeypatch, names):
    calls = {name: 0 for name in names}
    for name in names:
        orig = getattr(te, name)

        def wrapped(*a, _orig=orig, _name=name, **kw):
            calls[_name] += 1
            return _orig(*a, **kw)

        monkeypatch.setattr(te, name, wrapped)
    return calls


@pytest.mark.parametrize("packed,halve,route", [
    (None, 0, "exact_pool_packed_plain"),  # by row count (threshold lowered)
    (True, 0, "exact_pool_packed_plain"),
    (True, 1, "exact_pool_plain"),  # stage2_halve forces two planes
    (False, 0, "exact_pool_plain"),
])
def test_packed_routing(rng, monkeypatch, packed, halve, route):
    monkeypatch.setattr(te, "_PACKED_MIN_ROWS", 1000)
    calls = _spy(monkeypatch, ["exact_pool_packed_plain", "exact_pool_plain"])
    x, q = _clustered(rng, 1500, 16, 4)
    s, i = te.exact_pool_scored(
        torch.from_numpy(q), torch.from_numpy(x), torch.ones(1500, dtype=torch.bool),
        ef_buf=32, tile_n=512, packed=packed, stage2_halve=halve,
    )
    assert calls == {name: int(name == route) for name in calls}
    assert i.shape == (4, 32) and bool((i >= 0).all())


@pytest.mark.parametrize("metric", ["L2", "COSINE"])
def test_index_takes_the_packed_route_by_row_count(rng, monkeypatch, metric):
    """With the threshold lowered to the layout's 16,384-row tables, the
    sealed power-of-two subgroup and the brute table take the packed pool
    (the singleton 8,192-row segment the plain top-k), and the port answers
    as the JAX index does (exact on the CPU)."""
    monkeypatch.setattr(te, "_PACKED_MIN_ROWS", 2 * SEG)
    calls = []
    orig = te.exact_pool_packed_plain

    def spy(q_in, x, *a, **kw):
        calls.append(x.shape[0])
        return orig(q_in, x, *a, **kw)

    monkeypatch.setattr(te, "exact_pool_packed_plain", spy)
    n = 4 * SEG + 3000
    x, q = _blocked(rng, n, 32)
    deleted = rng.integers(0, 4 * SEG, 200)
    alive = np.ones(n, bool)
    alive[deleted] = False
    out = []
    for pkg in (jvs, tvs):
        idx = _open(pkg, pkg.MemoryStorage(), metric)
        try:
            _populate(idx, x, built=(0, 1, 2), deleted=deleted)
            out.append(idx.query_batch_arrays(q, 10))
        finally:
            idx.close()
    assert sorted(calls) == [2 * SEG, 2 * SEG]
    _assert_same(out[1], out[0], x, q, alive, metric, 10)


def test_exact_subgroups_ignore_the_flat_byte_bound(rng, monkeypatch):
    """The unified flat route's [Q, S*N] byte bound does not apply to exact
    groups (their pool builds no such matrix): with the bound at 0 the
    exact sealed segments still go through one power-of-two subgroup, and
    answer as the JAX index does."""
    from vectorsearch_torch.core import index as tindex

    monkeypatch.setattr(tindex, "_UNIFIED_APPROX_BYTES", 0)
    subgroups = []
    orig = tindex._unified_exact_query

    def spy(q, stack, *a, **kw):
        subgroups.append(stack.vectors.shape[0])
        return orig(q, stack, *a, **kw)

    monkeypatch.setattr(tindex, "_unified_exact_query", spy)
    n = 4 * SEG + 3000
    x, q = _blocked(rng, n, 16)
    out = []
    for pkg in (jvs, tvs):
        idx = _open(pkg, pkg.MemoryStorage(), "L2")
        try:
            _populate(idx, x, built=(0, 1, 2), deleted=[])
            out.append(idx.query_batch_arrays(q, 10))
        finally:
            idx.close()
    assert subgroups == [2]
    _assert_same(out[1], out[0], x, q, np.ones(n, bool), "L2", 10)


# ------------------------- the card kernel's 3xTF32 precision and d_live


def _deep_like(rng, n, qn, scale=1.0):
    """Deep10M-like rows: unit vectors of 96 features near 512 unit centres
    (noise 0.18), zero-padded to 128 as the index lane-pads them; queries
    are rows plus 0.02 noise (bench.py's Deep10M recipe, smaller)."""
    centers = rng.normal(size=(512, 96))
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    x96 = centers[rng.integers(0, 512, n)] + 0.18 * rng.normal(size=(n, 96))
    x96 /= np.linalg.norm(x96, axis=1, keepdims=True)
    q96 = x96[rng.integers(0, n, qn)] + 0.02 * rng.normal(size=(qn, 96))
    x = np.zeros((n, 128), np.float32)
    q = np.zeros((qn, 128), np.float32)
    x[:, :96], q[:, :96] = x96 * scale, q96 * scale
    return x, q, rng.random(n) > 0.02


def _round_to_zero(t64: torch.Tensor) -> torch.Tensor:
    """float64 -> the float32 next to it toward zero."""
    f = t64.float()
    over = f.double().abs() > t64.abs()
    return torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f)


def _tensor_core_product(chunk_sums: bool):
    """a [Q, D] . b [N, D]^T as csrc/exact_pool_tc.cu forms it: each operand
    split into big and small TF32 halves, three MMAs per 8 features
    (small_b.big_a, big_b.small_a, big_b.big_a), each MMA's 8 products
    summed exactly and added to the f32 accumulator rounding toward zero,
    as the tensor cores do. ``chunk_sums``: B2's form, a fresh accumulator
    per 32 features, the chunk's small terms first, the chunks added in
    f32; else B1's, one accumulator over all features, the three MMAs of
    each 8 features in turn."""
    from tests.test_torch_exact_pool import _split_tf32

    def product(a, b):
        ab, as_ = _split_tf32(a)
        bb, bs = _split_tf32(b)
        d = a.shape[1]
        acc = total = torch.zeros(a.shape[0], b.shape[0])
        for c in range(0, d, 32):
            ks = range(c, min(c + 32, d), 8)
            terms = ((ab, bs), (as_, bb), (ab, bb))
            if chunk_sums:
                acc = torch.zeros_like(acc)
                order = [(k0, t) for t in terms for k0 in ks]
            else:
                order = [(k0, t) for k0 in ks for t in terms]
            for k0, (qa, xb) in order:
                k = slice(k0, k0 + 8)
                acc = _round_to_zero(
                    acc.double() + qa[:, k].double() @ xb[:, k].double().T)
            if chunk_sums:
                total = total + acc
        return total if chunk_sums else acc

    return product


def _levels(monkeypatch, product, q, x, valid, metric, **geom_kw):
    """Packed levels floor(p / F) of the live bins of the plain version
    with ``product`` in place of its full-f32 one (None: full f32)."""
    args = (torch.from_numpy(q), torch.from_numpy(x), torch.from_numpy(valid))
    q_in, aux, mult, qn2, _step, geom = te.packed_pool_inputs(
        *args, metric, **geom_kw)
    if product is not None:
        monkeypatch.setattr(te, "matmul_nt", product)
    plane = te.exact_pool_packed_plain(q_in, args[1], aux, mult, qn2, **geom)
    monkeypatch.undo()
    return plane, geom


@pytest.mark.parametrize("metric", ["L2", "COSINE"])
@pytest.mark.parametrize("scale", [1.0, 1e3])
def test_tensor_core_packed_levels_within_one_step(rng, monkeypatch, metric, scale):
    """The precision argument of the card's B2 kernel (3xTF32 MMAs, chunk
    sums), emulated on the CPU: on Deep10M-like rows (D 96 padded to 128,
    the pool's Deep10M geometry: tile 2048, fold 8, F 64) and at 1e3x
    magnitudes, its packed plane holds the same dead bins, levels within
    one step of the full-f32 plain version and the same slot in all but a
    few bins, while one TF32 pass moves levels by more than one step."""
    from tests.test_torch_exact_pool import _tf32_rna

    x, q, valid = _deep_like(rng, 24_000, 48, scale)
    kw = dict(fold=8, d_live=96)
    want, geom = _levels(monkeypatch, None, q, x, valid, metric, **kw)
    assert (geom["tile"], geom["fold"], geom["slot_f"]) == (2048, 8, 64.0)
    got, _g = _levels(monkeypatch, _tensor_core_product(True), q, x, valid,
                      metric, **kw)
    one, _g = _levels(monkeypatch, lambda a, b: _tf32_rna(a) @ _tf32_rna(b).T,
                      q, x, valid, metric, **kw)
    live = torch.isfinite(want)
    assert torch.equal(torch.isfinite(got), live) and live.float().mean() > 0.9
    f = geom["slot_f"]
    lw, lg, lo = (torch.floor(p[live] / f) for p in (want, got, one))
    assert (lg - lw).abs().max() <= 1
    assert ((got[live] - lg * f) == (want[live] - lw * f)).float().mean() > 0.99
    assert (lo - lw).abs().max() > 1


def test_chunk_sums_keep_fine_packed_levels(monkeypatch):
    """Why B2 sums each 32-feature chunk apart, small terms first: at fine
    levels (tile 512, fold 2: F 8, steps of 2^-20 of the scale) on
    sift1m-like rows (D 128, norms ~45), accumulating the whole slice
    inside the MMAs, with its round-toward-zero adds at the running sum's
    magnitude (B1's form), moves levels by more than one step
    (chip_smoke.py's explicit-geometry case caught it on the card), while
    B2's form keeps them within one."""
    rng = np.random.default_rng(0)
    n, d, qn = 12_288, 128, 48
    centers = rng.normal(size=(2048, d)) * 4
    x = (centers[rng.integers(0, 2048, n)] + rng.normal(size=(n, d))).astype(np.float32)
    q = (centers[rng.integers(0, 2048, qn)] + rng.normal(size=(qn, d))).astype(np.float32)
    valid = rng.random(n) < 0.98
    kw = dict(tile_n=512, fold=2)
    want, geom = _levels(monkeypatch, None, q, x, valid, "L2", **kw)
    assert geom["slot_f"] == 8.0
    live = torch.isfinite(want)
    lw = torch.floor(want[live] / 8.0)
    for chunk_sums, most in ((True, 1), (False, None)):
        got, _g = _levels(monkeypatch, _tensor_core_product(chunk_sums), q, x,
                          valid, "L2", **kw)
        diff = (torch.floor(got[live] / 8.0) - lw).abs().max()
        if chunk_sums:
            assert diff <= most
        else:
            assert diff > 1


def test_packed_d_live_gives_the_identical_plane(rng):
    """d_live = 96 on rows zero-padded to 128 (as the index calls the packed
    route) gives the identical plane and step: the geometry stays the padded
    D's, and the skipped columns add exact zeros."""
    x, q, valid = _deep_like(rng, 20_000, 16)
    args = (torch.from_numpy(q), torch.from_numpy(x), torch.from_numpy(valid))
    full, full_step = te.exact_bin_pool_packed(*args, fold=2)
    live, live_step = te.exact_bin_pool_packed(*args, fold=2, d_live=96)
    assert torch.equal(full, live) and torch.equal(full_step, live_step)
    *_rest, geom = te.packed_pool_inputs(*args, fold=2, d_live=96)
    assert geom["d_live"] == 96
    assert geom["tile"] == te._stage1_params(16, 128, 20_000, None, 2, 16384)[0]
    # and the same plane as the JAX package's pool of the padded rows
    _compare_packed(_bf16(q), _bf16(x), valid, "L2", None, 2)


def test_index_passes_its_logical_dimension_to_the_packed_route(rng, monkeypatch):
    """The index's packed calls get d_live = its logical dimension (16) on
    rows lane-padded to 128, and still answer exactly."""
    monkeypatch.setattr(te, "_PACKED_MIN_ROWS", 2 * SEG)
    seen = []
    orig = te.exact_pool_packed_plain

    def spy(q_in, x, *a, **kw):
        seen.append((x.shape[1], q_in.shape[1], kw["d_live"]))
        return orig(q_in, x, *a, **kw)

    monkeypatch.setattr(te, "exact_pool_packed_plain", spy)
    n = 2 * SEG + 100
    x, q = _blocked(rng, n, 16)
    idx = _open(tvs, tvs.MemoryStorage(), "L2")
    try:
        gids = _populate(idx, x, built=(0, 1), deleted=[])
        got, _s, _d = idx.query_batch_arrays(q, 10)
    finally:
        idx.close()
    assert seen == [(128, 128, 16)]
    d = np.linalg.norm(x[None, :, :] - q[:, None, :], axis=2)
    assert (got[:, 0] == np.asarray(gids)[d.argmin(axis=1)]).all()


def _wide_form_model(s, mult, qn2, *, metric, tile, bins, fold, w, slot_f):
    """The packed plane as B2's wide form (csrc/exact_pool_tc.cu's
    exact_pool_wide_kernel<true>) computes it from the scores s f32[Q, N]:
    each group's row slices in ascending order, a bin's best of the tile and
    its slice in the tile kept on `>`; at a tile's last slice (or the
    group's last live one) the best compressed once into
    rint(v * mult) * F + (the tile's first slice in the group + the slot),
    in float32, and merged into the plane by max, the first tile
    overwriting it; the tile's best then starts afresh at -inf."""
    qn, n = s.shape
    per, inf = tile // bins, float("-inf")
    out = torch.full((qn, w), inf)
    for g in range(w // bins):
        plane = None
        for j in range(fold):
            best = torch.full((qn, bins), inf)
            slot = torch.zeros((qn, bins), dtype=torch.int64)
            ran = False
            for a in range(per):
                r0 = ((g * fold + j) * per + a) * bins
                if r0 >= n:
                    break
                sc = torch.full((qn, bins), inf)
                sc[:, :min(bins, n - r0)] = s[:, r0:r0 + bins]
                up = sc > best
                best, slot = torch.where(up, sc, best), torch.where(up, a, slot)
                ran = True
            if not ran:
                break
            if metric == "COSINE":
                v = best
            else:
                v = -torch.sqrt(torch.clamp(qn2[:, None] - best, min=0.0))
            p = torch.round(v * mult[:, None]) * slot_f + (j * per + slot).float()
            plane = p if plane is None else torch.where(p > plane, p, plane)
        if plane is not None:
            out[:, g * bins:(g + 1) * bins] = plane
    return out


@pytest.mark.parametrize("metric", ["L2", "COSINE"])
@pytest.mark.parametrize("fold", [1, 2, 8])
def test_packed_wide_route_equals_the_plain_pool(metric, fold):
    """B2's wide form's packing, slice by slice as the kernel walks a group
    (``_wide_form_model``), gives exact_pool_packed_plain's plane bit for
    bit, and so does the route the wide form replaced (B1's pool at fold 1,
    then pack_tiles): a ragged last tile, a zero row, rows left out and a
    group whose rows are all left out (dead bins). The features are small
    integers, so every score is exact and ties are many: the smallest slice
    of a tile wins one, and of two tiles on one level the higher slot."""
    rng = np.random.default_rng(100 * fold)
    n, d, qn, tile = 17 * 512 + 77, 24, 13, 512
    x = rng.integers(-8, 9, size=(n, d)).astype(np.float32)
    q = rng.integers(-8, 9, size=(qn, d)).astype(np.float32)
    x[9] = 0.0
    valid = rng.random(n) > 0.1
    valid[fold * tile:2 * fold * tile] = False  # the second group: dead bins
    args = [torch.from_numpy(a) for a in (q, x, valid)]
    q_in, aux, mult, qn2, _step, geom = te.packed_pool_inputs(
        *args, metric=metric, tile_n=tile, fold=fold)
    want = te.exact_pool_packed_plain(q_in, args[1], aux, mult, qn2, **geom)
    cross = q_in @ args[1].T
    s = cross * aux[0] + aux[1] if metric == "COSINE" else cross - aux[0]
    got = _wide_form_model(s, mult, qn2, metric=metric, tile=tile,
                           bins=geom["bins"], fold=fold, w=geom["w"],
                           slot_f=geom["slot_f"])
    assert torch.equal(got, want)
    w1 = -(-n // tile) * geom["bins"]
    m, rows = te.exact_pool_plain(q_in, args[1], aux, metric=metric, tile=tile,
                                  bins=geom["bins"], fold=1, w=w1)
    assert torch.equal(te.pack_tiles(m, rows, mult, qn2, metric=metric, tile=tile,
                                     bins=geom["bins"], fold=fold, w=geom["w"],
                                     slot_f=geom["slot_f"]), want)
    live = torch.isfinite(want)
    assert not live.all() and live.any()


@pytest.mark.parametrize("metric", ["L2", "COSINE"])
@pytest.mark.parametrize("qn", [1, 13, 134, 512])
def test_packed_wide_form_is_one_launch_of_all_queries(monkeypatch, metric, qn):
    """exact_pool_packed_cuda where csrc's plan picks B2's wide form (a
    stand-in library whose exact_pool_plan returns FORM_WIDE, its launch
    writing the plain plane): one launch of all Q queries at the pool's own
    fold, with the query planes' scratch the plan reports; no launch of B1;
    one ``wide_pass`` span with the call's
    queries and rows, one ``PACKED_LAUNCHES`` count of form ``wide``; the
    plane returned is the one the launch wrote."""
    rng = np.random.default_rng(qn)
    n, d = 3 * 8 * 512 + 77, 40
    x = rng.integers(-8, 9, size=(n, d)).astype(np.float32)
    q = rng.integers(-8, 9, size=(qn, d)).astype(np.float32)
    valid = rng.random(n) > 0.1
    args = [torch.from_numpy(a) for a in (q, x, valid)]
    q_in, aux, mult, qn2, _step, geom = te.packed_pool_inputs(
        *args, metric=metric, tile_n=512, fold=8)
    want = te.exact_pool_packed_plain(q_in, args[1], aux, mult, qn2, **geom)
    lib = wide_form_stand_in(monkeypatch)

    def no_b1(*a, **k):
        raise AssertionError("B1 was launched")

    monkeypatch.setattr(te, "exact_pool_cuda", no_b1)
    reg = get_registry()
    s0 = max((r.seq for r in reg.spans().records), default=-1)
    wide0 = reg.counter_value(te.PACKED_LAUNCHES, {"form": "wide"})
    calls0 = te.exact_pool_packed_cuda.launches
    got = te.exact_pool_packed_cuda(q_in, args[1], aux, mult, qn2, **geom)
    assert torch.equal(got, want)
    assert lib.plans == [(qn, d, d, geom["w"], 1)]
    assert lib.launches == [dict(qn=qn, n=n, d=d, d_live=d, fold=8, w=geom["w"],
                                 planes=True,
                                 qplane_floats=lib.scratch(qn, d))]
    assert [r.attrs for r in reg.spans().records
            if r.seq > s0 and r.name == te.WIDE_PASS] == [{"queries": qn, "rows": n}]
    assert reg.counter_value(te.PACKED_LAUNCHES, {"form": "wide"}) == wide0 + 1
    assert te.exact_pool_packed_cuda.launches == calls0 + 1
