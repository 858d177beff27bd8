"""The port's ADC kernels (vectorsearch_torch/ops/adc.py) held against the
JAX package's Pallas kernels (ops/pallas/adc.py, in interpret mode on the
CPU, as tests/test_adc_pool.py runs them) on the same numpy inputs. On a CPU
tensor the port runs each kernel's plain PyTorch version, so these tests pin
the function its CUDA kernel must compute; chip_smoke.py holds the kernels
against those plain versions on the card.

Tolerances: both sides sum the same bf16 LUT entries in f32, the TPU kernels
through a one-hot matrix product and the port in m order, so f32 outputs
agree to 1e-5 relative; bf16 score outputs to 1 bf16 ulp (2^-7 relative:
the f32 sums may round to neighbouring bf16 values); pool ids agree in every
bin whose best and second-best scores differ by more than 1e-4 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vectorsearch_tpu.ops import pq as jpq
from vectorsearch_tpu.ops.pallas import adc as pa
from vectorsearch_torch.ops import adc as ta
from vectorsearch_torch.ops import pq as tpq


def _setup(rng, n, d=64, m=8, k=128, qn=12):
    cb = rng.normal(size=(m, k, d // m)).astype(np.float32)
    codes = rng.integers(0, k, size=(n, m)).astype(np.uint8)
    q = rng.normal(size=(qn, d)).astype(np.float32)
    lut = np.array(jpq.build_lut(jnp.asarray(q), jnp.asarray(cb)))
    return lut, codes


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _bf16_sums(lut, codes):
    """f64 sums of the bf16-rounded LUT entries (the kernels' function)."""
    lb = torch.from_numpy(np.array(lut)).to(torch.bfloat16).double().numpy()
    m = lut.shape[1]
    return sum(lb[:, j, :][:, codes[:, j]] for j in range(m))  # [Q, N]


@pytest.mark.parametrize("fold", [1, 2])
def test_pool_matches_pallas(rng, fold):
    n = 512 * 3 + 77  # a tail tile
    lut, codes = _setup(rng, n)
    valid = np.ones(n, bool)
    valid[40:60] = False
    js, ji = pa.adc_bin_pool(jnp.asarray(lut), jnp.asarray(codes),
                             jnp.asarray(valid), tile_n=512, interpret=True,
                             fold=fold)
    js, ji = np.asarray(js), np.asarray(ji)
    ts, ti = ta.adc_bin_pool(*_t(lut, codes, valid), tile_n=512, fold=fold)
    ts, ti = ts.numpy(), ti.numpy()
    assert ts.shape == js.shape and ti.dtype == np.int32
    live = np.isfinite(js)
    np.testing.assert_array_equal(np.isfinite(ts), live)
    np.testing.assert_allclose(ts[live], js[live], rtol=1e-5)
    # ids agree wherever the bin's winner is margin-separated
    s = np.where(valid[None, :], -_bf16_sums(lut, codes), -np.inf)
    tile, bins, f, w = ta.pool_geometry(12, 8, 128, n, 512, fold)
    span = f * tile
    pad = np.full((12, w // bins * span - n), -np.inf)
    t = -np.sort(-np.concatenate([s, pad], 1).reshape(12, w // bins, span // bins, bins), axis=2)
    best, second = t[:, :, 0].reshape(12, -1), t[:, :, 1].reshape(12, -1)
    with np.errstate(invalid="ignore"):
        sep = live & ((best - second) > 1e-4 * np.abs(best))
    assert sep.sum() > 0.9 * live.sum()
    np.testing.assert_array_equal(ti[sep], ji[sep])
    assert not np.isin(ti[live], np.arange(40, 60)).any()


def test_pool_geometry_is_the_jax_packages():
    assert pa._auto_pool_tile(512, 4096, None)[0] == ta.pool_geometry(512, 16, 256, 100_096)[0] == 2048
    assert ta.pool_geometry(512, 16, 256, 100_096) == (2048, 256, 1, 12544)
    assert pa._auto_pool_tile(512, 5120, None)[0] == ta.pool_geometry(512, 20, 256, 50_000)[0]
    # the JAX package finds no tile for a LUT this wide and falls back to 1024
    assert pa._auto_pool_tile(512, 64 * 256, None) is None
    assert ta.pool_geometry(512, 64, 256, 100_096)[0] == 1024
    with pytest.raises(ValueError):
        ta.pool_geometry(8, 8, 16, 5000, tile_n=2176)


def test_pool_contains_true_adc_topk(rng):
    """Collision-free data: each query's 10 nearest rows (by the bf16 ADC
    the kernel ranks with) are consecutive rows, so they share no bin, and
    the stage-2 pool holds all of them."""
    n, qn, k = 20_000, 6, 10
    lut, codes = _setup(rng, n, qn=qn)
    best = np.argmin(lut, axis=2).astype(np.uint8)  # [Q, M] nearest codes
    for i in range(qn):
        rows = 1000 + 2000 * i + np.arange(k)
        codes[rows] = best[i]
        codes[rows, i % 8] = rng.integers(0, 128, k)  # distinct, still near
    valid = np.ones(n, bool)
    truth = np.argsort(_bf16_sums(lut, codes), axis=1, kind="stable")[:, :k]
    neg, idx = ta.adc_pool_scored(*_t(lut, codes, valid), ef_buf=64)
    idx = idx.numpy()
    for i in range(qn):
        assert set(truth[i]) <= set(idx[i].tolist())
    s = _bf16_sums(lut, codes)
    ok = idx >= 0
    np.testing.assert_allclose(-neg.numpy()[ok], np.take_along_axis(s, np.maximum(idx, 0), 1)[ok],
                               rtol=1e-5)


def test_pool_dead_bins_pad_minus_one(rng):
    n = 1024
    lut, codes = _setup(rng, n)
    valid = np.zeros(n, bool)
    valid[:3] = True
    neg, idx = ta.adc_pool_scored(*_t(lut, codes, valid), ef_buf=16, tile_n=512)
    neg, idx = neg.numpy(), idx.numpy()
    assert set(idx.ravel().tolist()) - {-1} <= {0, 1, 2}
    assert (idx[:, 3:] == -1).all() and (neg[:, 3:] == -np.inf).all()
    assert np.isfinite(neg[:, :3]).all()


def test_scores_scan_matches_pallas(rng):
    n = 512 + 130  # not a multiple of the 128-column tile
    lut, codes = _setup(rng, n, qn=8)
    valid = np.ones(n, bool)
    valid[5:9] = False
    want = np.asarray(pa.adc_scan_scores_pallas(
        jnp.asarray(lut), jnp.asarray(codes), jnp.asarray(valid), tile_n=128,
        interpret=True)).astype(np.float32)
    got = ta.adc_scan_scores(*_t(lut, codes, valid))
    assert got.dtype == torch.bfloat16 and got.shape[1] == ta.scores_width(n) >= n
    got = got.float().numpy()
    assert np.isneginf(got[:, :n][:, ~valid]).all()
    assert np.isneginf(got[:, n:]).all()  # pad columns
    np.testing.assert_allclose(got[:, :n][:, valid], want[:, :n][:, valid],
                               rtol=2.0 ** -7)
    # exactly the bf16 rounding of the negated f32 sums
    exact = -_bf16_sums(lut, codes)[:, valid]
    np.testing.assert_allclose(got[:, :n][:, valid], exact, rtol=2.0 ** -8)


@pytest.mark.parametrize("precise", [False, True])
def test_scan_matches_pallas(rng, precise):
    n = 512 + 130
    lut, codes = _setup(rng, n, qn=8)
    valid = np.ones(n, bool)
    valid[5:9] = False
    want = np.asarray(pa.adc_scan_pallas(
        jnp.asarray(lut), jnp.asarray(codes), jnp.asarray(valid), tile_n=128,
        precise=precise, interpret=True))
    got = ta.adc_scan_kernel(*_t(lut, codes, valid), precise=precise).numpy()
    assert got.shape == (8, n) and got.dtype == np.float32
    assert np.isposinf(got[:, ~valid]).all()
    np.testing.assert_allclose(got[:, valid], want[:, valid], rtol=1e-5)
    ref = np.asarray(jpq.adc_scan(jnp.asarray(lut), jnp.asarray(codes),
                                  jnp.asarray(valid)))
    err = np.abs(got[:, valid] - ref[:, valid]).mean()
    if precise:  # the hi/lo planes are near-f32
        np.testing.assert_allclose(got[:, valid], ref[:, valid], rtol=2e-4)
    else:
        assert err > 0  # one bf16 pass is not


def test_lut_hi_lo_planes(rng):
    lut = torch.from_numpy(rng.random((3, 4, 16)).astype(np.float32) * 7)
    hi, lo = ta.lut_hi_lo(lut)
    assert hi.dtype == lo.dtype == torch.bfloat16
    bits = lut.view(torch.int32)
    assert torch.equal(hi.float().view(torch.int32), bits & -65536)
    assert ((hi.float() + lo.float() - lut).abs() <= 2.0 ** -16 * lut.abs()).all()


@pytest.mark.parametrize("m,k", [(12, 100), (3, 7)])
def test_odd_widths(rng, m, k):
    """M not a multiple of 16 and K below 256: the narrower code loads."""
    n = 700
    codes = rng.integers(0, k, size=(n, m)).astype(np.uint8)
    lut = rng.random((5, m, k)).astype(np.float32)
    valid = rng.random(n) > 0.3
    got = ta.adc_scan_kernel(*_t(lut, codes, valid)).numpy()
    want = np.where(valid[None, :], _bf16_sums(lut, codes), np.inf)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    ref = tpq.adc_scan(*_t(lut, codes, valid)).numpy()
    np.testing.assert_allclose(got[:, valid], ref[:, valid], rtol=2.0 ** -7)


def test_use_fused_gating_is_shape_only():
    assert ta.use_fused_adc_pool(100_096, 256)
    assert not ta.use_fused_adc_pool(10_112, 256)  # under MIN_ROWS_POOL
    assert not ta.use_fused_adc_pool(16_384, 4096)  # bins do not cover ef
    assert ta.use_fused_adc_pool(ta.MIN_ROWS_POOL, 128)


def test_kernel_wrappers_reject_cpu_tensors():
    lut = torch.zeros(2, 4, 16, dtype=torch.bfloat16)
    codes = torch.zeros(300, 4, dtype=torch.uint8)
    valid = torch.ones(300, dtype=torch.bool)
    for call in (
        lambda: ta.adc_pool_cuda(lut, codes, valid, tile=512, bins=128, fold=1, w=128),
        lambda: ta.adc_scores_cuda(lut, codes, valid),
        lambda: ta.adc_scan_cuda(lut, codes, valid),
        lambda: ta.adc_scan_precise_cuda(lut, lut, codes, valid),
    ):
        with pytest.raises(ValueError, match="CUDA"):
            call()


# ---------------------------------------------------------------------------
# The LINES design of the four ADC kernels (csrc/adc.cu's header), modelled
# in plain torch with the header's index arithmetic: line li = m*K + c at
# byte li*LB, lane j of a row group reads the WB bytes at li*LB + j*WB. B3,
# B5-fast and B4: G = QL/2 lanes, word j = bf16 of query 2j (low half) |
# query 2j+1 (high half), WB 4, LB 2*QL; at QL 1 a 2-byte line of the one
# query. B5-precise: G = QL lanes, word j = hi of query j (low half) | lo
# (high half), WB 4, LB 4*QL. (G, WB, LB), the scans' output-tile stride and
# their chunk come from the wrapper's own ``_line_layout``, ``_tile_stride``
# and ``_line_chunk``, which also size and drive the kernels. These tests
# hold the documented layout and walk, not the kernel: only the card tests
# (tests/test_torch_cuda.py) run its index arithmetic.

_FORMS = {"pool": ta._POOL, "precise": ta._PRECISE, "fast": ta._FAST,
          "scores": ta._SCORES}


def _line_image(planes, q0, ql, form):
    """The shared-memory bytes of one query tile staged as lines, uint8
    [M*K*LB]; words of queries past the batch hold 0."""
    qn, m, k = planes[0].shape
    g, wb, lb = ta._line_layout(ql, form)
    bits = [p.contiguous().view(torch.int16).to(torch.int64) & 0xFFFF for p in planes]

    def column(plane, q):  # plane's bf16 bits of query q at every line, or 0
        if q0 + q < qn:
            return bits[plane][q0 + q].reshape(-1)
        return torch.zeros(m * k, dtype=torch.int64)

    img = torch.zeros(m * k * lb, dtype=torch.uint8)
    li = torch.arange(m * k)
    for j in range(g):
        if wb == 2:
            word = column(0, 0)
        elif form == ta._PRECISE:
            word = column(0, j) | (column(1, j) << 16)
        else:
            word = column(0, 2 * j) | (column(0, 2 * j + 1) << 16)
        for byte in range(wb):
            img[li * lb + j * wb + byte] = ((word >> (8 * byte)) & 0xFF).to(torch.uint8)
    return img, g, wb, lb


def _line_walk(img, g, wb, lb, codes, k):
    """Each row's sums as its row group computes them: for lane j, the word
    at (m*K + codes[r, m])*LB + j*WB, its halves added into two f32 sums in m
    order -> f32 [N, G, 2] (low-half sum, high-half sum)."""
    n, m = codes.shape
    acc = torch.zeros(n, g, 2, dtype=torch.float32)
    j = torch.arange(g)
    for mm in range(m):
        off = (mm * k + codes[:, mm].long())[:, None] * lb + j[None, :] * wb
        word = torch.zeros(n, g, dtype=torch.int64)
        for byte in range(wb):
            word |= img[off + byte].to(torch.int64) << (8 * byte)
        lo_half = ((word & 0xFFFF) << 16).to(torch.int32).view(torch.float32)
        hi_half = (word & 0xFFFF0000).to(torch.int32).view(torch.float32)
        acc[:, :, 0] += lo_half
        acc[:, :, 1] += hi_half
    return acc


def _line_sums_model(planes, codes, ql, precise):
    """The per-(query, row) results of the LINES walk over every query tile:
    B3 f32 [Q, N] sums, precise f32 [Q, N] hi sum + lo sum."""
    qn, m, k = planes[0].shape
    out = torch.empty(qn, codes.shape[0], dtype=torch.float32)
    form = ta._PRECISE if precise else ta._POOL
    for q0 in range(0, qn, ql):
        img, g, wb, lb = _line_image(planes, q0, ql, form)
        acc = _line_walk(img, g, wb, lb, codes, k)
        for q in range(q0, min(qn, q0 + ql)):
            t = q - q0
            if precise:
                out[q] = acc[:, t, 0] + acc[:, t, 1]
            elif wb == 2:
                out[q] = acc[:, 0, 0]
            else:
                out[q] = acc[:, t // 2, t % 2]
    return out


_LINE_SHAPES = [(16, 256, 16), (12, 100, 8), (64, 256, 4), (16, 256, 1)]


@pytest.mark.parametrize("m,k,ql", _LINE_SHAPES)
@pytest.mark.parametrize("precise", [False, True])
def test_line_layout_gives_lut_sums_bit_for_bit(rng, m, k, ql, precise):
    """The documented line layout and row-group walk (a model, not the
    kernel) give the plain versions' sums bit for bit, over query tiles of
    which the last is partial (B5-precise lines hold at most 8 queries)."""
    ql = min(ql, 8) if precise else ql
    qn, n = 2 * ql + 1, 300
    lut = torch.from_numpy(rng.random((qn, m, k)).astype(np.float32) * 9)
    codes = torch.from_numpy(rng.integers(0, k, (n, m)).astype(np.uint8))
    valid = torch.ones(n, dtype=torch.bool)
    if precise:
        hi, lo = ta.lut_hi_lo(lut)
        got = _line_sums_model([hi, lo], codes, ql, True)
        want = ta.adc_scan_precise_plain(hi, lo, codes, valid)
    else:
        lh = ta.lut_bf16(lut)
        got = _line_sums_model([lh], codes, ql, False)
        want = ta._lut_sums(lh, codes)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def _pool_walk(sums, valid, *, tile, bins, fold, w):
    """B3's walk: the row group of pool column (g, b) visits rows g*fold*tile
    + b + s*bins for s = 0, 1, ... below N, skips invalid ones and keeps a
    row's negated sum when it is strictly greater -> (f32 [Q, W], i32 [Q, W];
    -inf / -1 in dead bins)."""
    qn, n = sums.shape
    col = torch.arange(w)
    row0 = (col // bins) * fold * tile + col % bins
    best = torch.full((qn, w), float("-inf"))
    rows = torch.full((qn, w), -1, dtype=torch.int32)
    for s in range(fold * tile // bins):
        r = row0 + s * bins
        ok = r < n
        rc = torch.where(ok, r, 0)
        ok = ok & valid[rc]
        sc = -sums[:, rc]
        upd = ok[None, :] & (sc > best)
        best = torch.where(upd, sc, best)
        rows = torch.where(upd, rc.to(torch.int32)[None, :], rows)
    return best, rows


@pytest.mark.parametrize("m,k,ql", _LINE_SHAPES)
@pytest.mark.parametrize("tile_n,fold", [(None, None), (512, 2)])
def test_line_pool_walk_keeps_the_tie_rule(rng, m, k, ql, tile_n, fold):
    """On an integer-valued LUT, where sums tie often, the documented walk
    of B3 (a model, not the kernel) over the line sums gives bin_argmax's
    scores and ids: ties go to the smallest row, dead bins score -inf."""
    qn, n = ql + 3, 2_500
    lut = torch.from_numpy(rng.integers(0, 3, (qn, m, k)).astype(np.float32))
    codes = torch.from_numpy(rng.integers(0, k, (n, m)).astype(np.uint8))
    valid = torch.from_numpy(rng.random(n) < 0.7)
    valid[:300] = False  # dead bins at fold 2
    lh = ta.lut_bf16(lut)
    tile, bins, f, w = ta.pool_geometry(qn, m, k, n, tile_n, fold)
    sums = _line_sums_model([lh], codes, ql, False)
    got_s, got_i = _pool_walk(sums, valid, tile=tile, bins=bins, fold=f, w=w)
    want_s, want_i = ta.adc_pool_plain(lh, codes, valid, tile=tile, bins=bins,
                                       fold=f, w=w)
    live = torch.isfinite(want_s)
    assert torch.equal(got_s, want_s)
    assert torch.equal(got_i[live], want_i[live])
    assert bool((got_i[~live] == -1).all())
    # the data does tie: some bins have two rows at their best score
    s = torch.where(valid[None, :], -sums, float("-inf"))
    span = f * tile
    s = torch.nn.functional.pad(s, (0, w // bins * span - n), value=float("-inf"))
    top2 = s.view(qn, w // bins, span // bins, bins).topk(2, dim=2).values
    assert int(((top2[:, :, 0] == top2[:, :, 1]) & torch.isfinite(top2[:, :, 0])).sum()) > 0


# (Q, M, K) -> line width of (B3, B5-precise, B5-fast, B4); None: a
# ValueError (one query's lines do not fit)
_WIDTHS = {
    # the sift1m segment: 16 queries' bf16 a line (128 KB); B5-precise 8
    # queries' hi/lo words (128 KB)
    (512, 16, 256): (16, 8, 16, 16),
    # the scans' output tiles count: at M 24 16-query lines (192 KB) leave
    # room for B4's bf16 tiles (34 KB), not for B5-fast's f32 ones (68 KB)
    (512, 24, 256): (16, 4, 8, 16),
    # a wide LUT on narrow lines
    (512, 64, 256): (4, 2, 4, 4),
    # small batches: the smallest line that holds them all
    (1, 16, 256): (1, 1, 1, 1),
    (9, 12, 100): (16, 8, 16, 16),
    (3, 16, 256): (4, 4, 4, 4),
    # one query's lines only: 2-byte lines (no output tile at G 1), and
    # B5-precise's 4-byte ones do not fit
    (512, 256, 256): (1, None, 1, 1),
    (8, 512, 256): (None, None, None, None),
}
# bytes of a block at the sift1m segment's width: 128 KB of lines, and the
# scans' [QL x stride] output tiles of 32 warps
_SMEM_SIFT = {"pool": 131_072, "precise": 131_072 + 32 * 8 * 36 * 4,
              "fast": 131_072 + 32 * 16 * 34 * 4, "scores": 131_072 + 32 * 16 * 34 * 2}


@pytest.mark.parametrize("form", list(_FORMS))
def test_line_queries(form):
    """The kernels' line width, per form: the widest that fits with the
    form's output tiles and that the batch fills more than half; a
    ValueError when one query's lines do not fit."""
    f = _FORMS[form]
    col = list(_FORMS).index(form)
    for (qn, m, k), widths in _WIDTHS.items():
        want = widths[col]
        if want is None:
            with pytest.raises(ValueError, match="shared memory"):
                ta._line_queries("t", qn, m, k, f)
        else:
            assert ta._line_queries("t", qn, m, k, f) == want, (qn, m, k)
            assert ta._line_smem(want, m, k, f) <= ta._SMEM_BYTES
    ql = _WIDTHS[(512, 16, 256)][col]
    assert ta._line_smem(ql, 16, 256, f) == _SMEM_SIFT[form]


def _no_bank_conflict(addr, elem):
    """The element offsets one store instruction of a warp writes (one a
    lane) hit distinct 4-byte banks, lanes that share a word aside."""
    words = torch.unique(addr * elem // 4)
    assert len(torch.unique(words % 32)) == len(words), addr.tolist()


def _scan_model(planes, codes, valid, ql, form):
    """The line-scan kernel's documented walk and output tiles (a model, not
    the kernel): for each query tile and 32-column slice, G steps in which
    row group g of lane j takes row base + s*RGW + g, stores its queries'
    values (B5-fast the sums, B4 bf16 of the negated sums, B5-precise hi +
    lo; +inf, B4 -inf, at invalid rows and B4's pad columns) at element
    q*stride + s*RGW + g of its warp's tile, every store free of bank
    conflicts; then each query's 32 columns copied out as a line. At G 1 a
    lane is a row and stores its values directly."""
    qn, m, k = planes[0].shape
    n = codes.shape[0]
    scores = form == ta._SCORES
    w = ta.scores_width(n) if scores else n
    g, wb, lb = ta._line_layout(ql, form)
    rgw, stride = 32 // g, ta._tile_stride(ql, form)
    dtype = torch.bfloat16 if scores else torch.float32
    elem = 2 if scores else 4
    dead = float("-inf") if scores else float("inf")
    per_lane = 2 if form != ta._PRECISE and wb == 4 else 1  # queries a lane
    out = torch.full((qn, w), float("nan"), dtype=dtype)  # NaN: never written
    lane = torch.arange(32)
    j, grp = lane % g, lane // g
    for q0 in range(0, qn, ql):
        nq = min(ql, qn - q0)
        img, *_ = _line_image(planes, q0, ql, form)
        acc = _line_walk(img, g, wb, lb, codes, k)  # [N, G, 2]
        for base in range(0, w, 32):
            tile = torch.full((ql * stride,), float("nan"), dtype=dtype)
            for s in range(g):
                rr = s * rgw + grp
                r = base + rr
                rc = r.clamp(max=n - 1)
                ok = (r < n) & valid[rc]
                a = acc[rc, j]
                if form == ta._PRECISE:
                    vals = [a[:, 0] + a[:, 1]]
                else:
                    vals = [-a[:, 0], -a[:, 1]] if scores else [a[:, 0], a[:, 1]]
                for i in range(per_lane):
                    v = torch.where(ok, vals[i], dead).to(dtype)
                    q = per_lane * j + i
                    if g == 1:
                        keep = (r < w) & (q < nq)
                        out[q0 + q[keep], r[keep]] = v[keep]
                    else:
                        addr = q * stride + rr
                        _no_bank_conflict(addr, elem)
                        tile[addr] = v
            if g > 1:
                keep = base + lane < w
                _no_bank_conflict(lane, elem)
                for q in range(nq):
                    out[q0 + q, (base + lane)[keep]] = tile[q * stride + lane[keep]]
    return out


@pytest.mark.parametrize("m,k,ql", _LINE_SHAPES)
@pytest.mark.parametrize("form", ["fast", "scores", "precise"])
def test_line_scan_outputs_match_plain_bit_for_bit(rng, m, k, ql, form):
    """The documented line walk and output-tile layout of the line-scan
    kernel (a model, not the kernel) give B5-fast's, B4's and B5-precise's
    plain outputs bit for bit, invalid rows and B4's pad columns included,
    over query tiles of which the last is partial."""
    f = _FORMS[form]
    ql = min(ql, 8) if f == ta._PRECISE else ql
    qn, n = 2 * ql + 1, 300
    lut = torch.from_numpy(rng.random((qn, m, k)).astype(np.float32) * 9)
    codes = torch.from_numpy(rng.integers(0, k, (n, m)).astype(np.uint8))
    valid = torch.from_numpy(rng.random(n) > 0.2)
    if f == ta._PRECISE:
        planes = list(ta.lut_hi_lo(lut))
        want = ta.adc_scan_precise_plain(*planes, codes, valid)
    else:
        planes = [ta.lut_bf16(lut)]
        plain = ta.adc_scores_plain if f == ta._SCORES else ta.adc_scan_plain
        want = plain(planes[0], codes, valid)
    got = _scan_model(planes, codes, valid, ql, f)
    assert got.shape == want.shape and got.dtype == want.dtype
    bits = torch.int16 if f == ta._SCORES else torch.int32
    assert torch.equal(got.view(bits), want.view(bits))
    if f == ta._SCORES:
        assert bool(torch.isneginf(got[:, n:].float()).all())  # pad columns


@pytest.mark.parametrize("width,qn,ql,chunk,max_stages", [
    # B4's route (a segment under 16,384 rows): each tile split over the
    # blocks it gets, one LUT staged a block
    (10_112, 512, 16, 2_528, 1),
    # the sift1m segment: 1024-column chunks, at most two LUTs a block
    (100_096, 512, 16, 1_024, 2),
    (100_096, 512, 8, 1_024, 2),
    # one query tile, and more tiles than the wave holds blocks
    (20_123, 9, 16, 160, 1),
    (50_123, 4096, 16, 1_024, 3),
])
def test_line_chunk_items_cover_every_slice_once(width, qn, ql, chunk,
                                                 max_stages):
    """The scans' persistent walk (csrc/adc.cu ``Items``) over a 132-SM
    wave with ``_line_chunk``'s chunk: every block takes its share of the
    (query tile, chunk) items in order, its warps the chunk's 32-column
    slices 32 apart; every slice of every tile is taken once, and no block
    stages more LUTs than stated."""
    blocks, tiles = 132, -(-qn // ql)
    assert ta._line_chunk(width, tiles, blocks) == chunk
    chunks = -(-width // chunk)
    items = tiles * chunks
    grid = min(items, blocks)
    seen = torch.zeros(tiles, -(-width // 32), dtype=torch.int32)
    stages = []
    for b in range(grid):
        staged = set()
        for it in range(items * b // grid, items * (b + 1) // grid):
            t, c = divmod(it, chunks)
            staged.add(t)
            # warp w takes the chunk's slices first + w, first + w + 32, ...
            first, end = c * chunk // 32, -(-min((c + 1) * chunk, width) // 32)
            seen[t, first:end] += 1
        stages.append(len(staged))
    assert bool((seen == 1).all())
    assert max(stages) <= max_stages
