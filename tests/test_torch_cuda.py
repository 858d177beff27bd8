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
from vectorsearch_torch.utils.metrics import get_registry

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
    # a 64-query tile on narrow rows (one accumulator: no chunk sums)
    (50_123, None, None, 128, 64, 1.0),
    # large magnitudes through the big/small TF32 split
    (50_123, None, None, 128, 100, 1e3),
    # Q x W of a single block: one query tile, one column block (W 128)
    (3 * 512 + 123, 512, 4, 128, 100, 1.0),
    # wide rows: a width whose rows TMA takes (the wide form), one feature
    # more (a row stride no multiple of 16 bytes: the wrapper pads it with
    # zero columns, then the wide form), and a published embedding width
    # (the wide form)
    (20_123, None, None, 2464, 3, 1.0),
    (20_123, None, None, 2465, 3, 1.0),
    (20_123, None, None, 3072, 100, 1.0),
    # GIST1M's rows (960 features in 1,024 lanes, the lanes past them
    # zeros) at its 2-segment group, as gist1m.batch512 sends them (the
    # wide form, 64 queries a block, chunk sums)
    (2 * 100_096, None, None, 1024, 512, 1.0),
])
def test_kernel_matches_plain(cuda, rng, metric, n, tile, fold, d, qn, scale):
    x = rng.normal(size=(n, d)).astype(np.float32) * np.float32(scale)
    x[7] = 0.0
    q = rng.normal(size=(qn, d)).astype(np.float32) * np.float32(scale)
    if d == 1024:  # GIST1M's 960 live features
        x[:, 960:] = 0.0
        q[:, 960:] = 0.0
    valid = rng.random(n) > 0.1
    args = [torch.from_numpy(a).to(cuda) for a in (q, x, valid)]
    q_in, aux, geom = te.pool_inputs(*args, metric=metric, tile_n=tile, fold=fold)
    if tile == 512 and fold == 4:
        assert geom["w"] == 128
    # the form and the queries a block the kernel takes at each (D, Q) above:
    # rows over 128 live features the wide (pipelined) form, 64 queries a
    # block; narrower rows resident planes at the power of two Q needs
    form = {(128, 1): ("resident", 8), (128, 64): ("resident", 64),
            (2464, 3): ("pipelined", 64),
            (2465, 3): ("pipelined", 64), (3072, 100): ("pipelined", 64),
            (1024, 512): ("pipelined", 64)}.get((d, qn), ("resident", 128))
    registry = get_registry()
    counts = (registry.counter_value(te.LAUNCHES),
              registry.counter_value(te.LAUNCHES, {"form": form[0], "tile": form[1]}))
    before = te.exact_pool_cuda.launches
    ks, ki = te.exact_pool_cuda(q_in, args[1], aux, **geom)
    assert te.exact_pool_cuda.launches == before + 1
    assert (registry.counter_value(te.LAUNCHES),
            registry.counter_value(te.LAUNCHES, {"form": form[0], "tile": form[1]})
            ) == (counts[0] + 1, counts[1] + 1)
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
@pytest.mark.parametrize("n,tile,fold,d,d_live,qn,dead_last", [
    # GIST1M's rows (960 live of 1,024 lanes) at the batch sizes a client
    # sends: one query, a partial query tile, one query past a tile
    (50_123, None, None, 1024, 960, 1, False),
    (50_123, None, None, 1024, 960, 77, False),
    (50_123, None, None, 1024, 960, 513, False),
    # a live width that leaves the last 32-feature chunk part empty
    (50_123, None, None, 1024, 1000, 100, False),
    (20_123, None, None, 256, 200, 100, False),
    # N ragged against the slice and the fold: a part slice, a part group
    (3 * 512 + 123, 512, 2, 1024, 960, 100, False),
    (5 * 512 + 77, 512, 4, 1024, 960, 40, False),
    # the last group's rows all invalid: its bins dead
    (40_000, None, 2, 1024, 960, 100, True),
])
def test_wide_form_matches_plain(cuda, rng, metric, n, tile, fold, d, d_live,
                                 qn, dead_last):
    """B1's wide form (rows over 128 live features that TMA takes: its own
    mainloop, the query planes split once a launch) against the plain
    version, at the tolerance of test_kernel_matches_plain, reading only
    the d_live live features; every launch counts form ``pipelined``, 64
    queries a block."""
    x = rng.normal(size=(n, d)).astype(np.float32)
    x[7] = 0.0
    q = rng.normal(size=(qn, d)).astype(np.float32)
    x[:, d_live:] = 0.0
    q[:, d_live:] = 0.0
    valid = rng.random(n) > 0.1
    args = [torch.from_numpy(a).to(cuda) for a in (q, x, valid)]
    q_in, aux, geom = te.pool_inputs(*args, metric=metric, tile_n=tile,
                                     fold=fold, d_live=d_live)
    assert geom["d_live"] == d_live
    span, bins = geom["fold"] * geom["tile"], geom["bins"]
    last = (n - 1) // span  # the last group
    if dead_last:
        valid[last * span:] = False
        args[2] = torch.from_numpy(valid).to(cuda)
        q_in, aux, geom = te.pool_inputs(*args, metric=metric, tile_n=tile,
                                         fold=fold, d_live=d_live)
    registry = get_registry()
    key = {"form": "pipelined", "tile": 64}
    counts = (registry.counter_value(te.LAUNCHES), registry.counter_value(te.LAUNCHES, key))
    ks, ki = te.exact_pool_cuda(q_in, args[1], aux, **geom)
    assert (registry.counter_value(te.LAUNCHES),
            registry.counter_value(te.LAUNCHES, key)) == (counts[0] + 1, counts[1] + 1)
    ps, pi = te.exact_pool_plain(q_in, args[1], aux, **geom)
    torch.cuda.synchronize()
    ks, ki, ps, pi = (t.cpu().numpy() for t in (ks, ki, ps, pi))
    qnorm = np.linalg.norm(q, axis=1)
    mx = np.linalg.norm(x, axis=1).max()
    bound = qnorm if metric == "COSINE" else 2 * qnorm * mx + mx * mx
    live = np.isfinite(ps)
    np.testing.assert_array_equal(np.isfinite(ks), live)
    if dead_last:
        assert not live[:, last * bins:].any()
        assert (ki[:, last * bins:] == -1).all()
    assert (np.abs(ks[live] - ps[live]) <= np.broadcast_to(
        1e-5 * bound[:, None], ks.shape)[live]).all()
    assert valid[ki[live]].all()
    agree = np.mean(ki[live] == pi[live])
    assert agree > 0.999, agree


def test_kernel_distances_hold_float32_at_gist_rows(cuda):
    """B1 at GIST1M's rows (960 features in 1,024 lanes, clustered as the
    gist1m-exact configuration draws them: centres of scale 4, unit noise;
    64 centres, so each query has close neighbours) and 512 queries (the
    wide form, 64 a block): every live bin's score, made a distance as
    exact_finalize makes it, sqrt(|q|^2 - s), lies within 2e-5 of the
    winning row's float64 distance, relative, the tolerance of
    tests/test_torch_wide_rows.py, whose emulation of the tensor cores puts
    one accumulator over the 30 chunks at ~7e-5 and chunk sums at ~3e-6."""
    g = torch.Generator(device="cuda").manual_seed(960)
    n = 50_123
    centres = torch.randn((64, 960), generator=g, device="cuda") * 4.0

    def draw(m):
        out = torch.zeros((m, 1024), device="cuda")
        pick = torch.randint(0, 64, (m,), generator=g, device="cuda")
        out[:, :960] = centres[pick] + torch.randn((m, 960), generator=g, device="cuda")
        return out

    x, q = draw(n), draw(512)
    q_in, aux, geom = te.pool_inputs(q, x, torch.ones(n, dtype=torch.bool, device="cuda"))
    ks, ki = te.exact_pool_cuda(q_in, x, aux, **geom)
    live = torch.isfinite(ks)
    d = torch.sqrt(torch.clamp((q * q).sum(1)[:, None] - ks, min=0.0)).double()
    x64, q64 = x.double(), q.double()
    d2 = (q64 * q64).sum(1)[:, None] - 2.0 * q64 @ x64.T + (x64 * x64).sum(1)[None, :]
    true = torch.sqrt(torch.gather(d2, 1, ki.long().clamp(min=0)))
    err = ((d - true).abs() / true)[live]
    assert live.float().mean() > 0.99
    assert float(err.max()) <= 2e-5, float(err.max())


@pytest.mark.parametrize("metric", ["L2", "COSINE"])
@pytest.mark.parametrize("n,tile,fold,d,d_live,qn,dead,form", [
    (3 * 512 + 123, 512, 2, 128, None, 100, None, "pipelined"),
    (5 * 512 + 77, 512, 4, 128, None, 100, None, "pipelined"),
    (50_123, None, None, 128, None, 100, None, "pipelined"),
    # query tiles of 8, 64 and 128 (partial at 40)
    (50_123, None, None, 128, None, 8, None, "pipelined"),
    (50_123, None, None, 128, None, 40, None, "pipelined"),
    (50_123, None, None, 128, None, 512, None, "pipelined"),
    # fold 1, and fold 8 over three groups (the last one partial)
    (50_123, None, 1, 128, None, 40, None, "pipelined"),
    (40_000, None, 8, 128, None, 512, None, "pipelined"),
    # Deep10M's rows: 96 live features lane-padded to 128, the pad skipped
    (50_123, None, None, 128, 96, 512, None, "pipelined"),
    # a live width whose last 32-feature stage is part zero-filled
    (20_123, None, None, 128, 98, 40, None, "pipelined"),
    # widths that are no multiple of 32: a tensor map's zero fill, and a
    # row stride no multiple of 16 bytes (the wrapper pads it with zero
    # columns)
    (50_123, None, None, 100, None, 100, None, "pipelined"),
    (20_123, None, None, 99, None, 40, None, "pipelined"),
    # rows too wide for resident planes: B2's wide form
    (20_123, None, None, 3072, None, 100, None, "wide"),
    # a published embedding width past the planes (768 live of 768, Q 512)
    (50_123, None, None, 768, None, 512, None, "wide"),
    # the pipelined form at the batch sizes a client sends: one query, a
    # ragged 77, 128 and 513 (a last tile of one query), at dl 96 of 128
    (5 * 512 + 77, 512, 4, 128, 96, 1, None, "pipelined"),
    (50_123, None, None, 128, 96, 77, None, "pipelined"),
    (50_123, None, None, 128, 96, 128, None, "pipelined"),
    (50_123, None, None, 128, 96, 513, None, "pipelined"),
    # a last group of 40 rows: its second 64-column block lies past N
    (3 * 512 + 40, 512, 1, 128, None, 77, None, "pipelined"),
    # N ragged against tile and fold: two full groups of 8 tiles, then three
    # tiles and 700 rows
    (2 * 8 * 2048 + 3 * 2048 + 700, None, 8, 128, 96, 512, None, "pipelined"),
    # dead bins: every row of one group invalid (dl = D, and dl 96)
    (40_000, None, 8, 128, None, 512, 1, "pipelined"),
    (40_000, None, 2, 128, 96, 77, 0, "pipelined"),
])
def test_packed_kernel_matches_plain(cuda, rng, metric, n, tile, fold, d,
                                     d_live, qn, dead, form):
    x = rng.normal(size=(n, d)).astype(np.float32)
    x[7] = 0.0
    q = rng.normal(size=(qn, d)).astype(np.float32)
    if d_live is not None:
        x[:, d_live:] = 0.0
    valid = rng.random(n) > 0.1
    if dead is not None:
        g_tile, _bins, g_fold, _w = te._stage1_params(qn, d, n, tile, fold, 16384)
        span = g_tile * g_fold
        valid[dead * span:(dead + 1) * span] = False
    args = [torch.from_numpy(a).to(cuda) for a in (q, x, valid)]
    q_in, aux, mult, qn2, _step, geom = te.packed_pool_inputs(
        *args, metric=metric, tile_n=tile, fold=fold, d_live=d_live)
    assert geom["d_live"] == (d if d_live is None else d_live)
    registry = get_registry()
    forms = {f: registry.counter_value(te.PACKED_LAUNCHES, {"form": f})
             for f in ("pipelined", "wide")}
    before = te.exact_pool_packed_cuda.launches
    kp = te.exact_pool_packed_cuda(q_in, args[1], aux, mult, qn2, **geom)
    assert te.exact_pool_packed_cuda.launches == before + 1
    # the form the kernel took, by the registry's counter
    assert {f: registry.counter_value(te.PACKED_LAUNCHES, {"form": f}) - v
            for f, v in forms.items()} == {
        f: float(f == form) for f in forms}
    pp = te.exact_pool_packed_plain(q_in, args[1], aux, mult, qn2, **geom)
    torch.cuda.synchronize()
    kp, pp = kp.cpu().numpy(), pp.cpu().numpy()
    live = np.isfinite(pp)
    np.testing.assert_array_equal(np.isfinite(kp), live)
    if dead is not None:
        bins = geom["bins"]
        assert not live[:, dead * bins:(dead + 1) * bins].any()
    f = geom["slot_f"]
    kl, pl = np.floor(kp[live] / f), np.floor(pp[live] / f)
    assert np.abs(kl - pl).max() <= 1
    assert np.mean((kp[live] - kl * f) == (pp[live] - pl * f)) > 0.99
    assert (kp[live] == np.round(kp[live])).all()


def _text_embedding_group(qn, integers, seed):
    """The 2-segment group of a 1M-row-segment corpus of 768 features
    (2,000,128 rows) and qn queries on the card: small integer features or
    Gaussian ones, a zero row, a tenth of the rows left out and the second
    pool group's rows all left out (its bins dead)."""
    n, d = 2_000_128, 768
    g = torch.Generator(device="cuda").manual_seed(seed)
    if integers:
        x = torch.randint(-8, 9, (n, d), generator=g, device="cuda").float()
        q = torch.randint(-8, 9, (qn, d), generator=g, device="cuda").float()
    else:
        x = torch.randn((n, d), generator=g, device="cuda")
        q = torch.randn((qn, d), generator=g, device="cuda")
    x[7] = 0.0
    valid = torch.rand(n, generator=g, device="cuda") > 0.1
    valid[8 * 1024:2 * 8 * 1024] = False  # the second pool group
    return q, x, valid


@pytest.mark.parametrize("metric", ["COSINE", "L2"])
@pytest.mark.parametrize("qn", [512, 200])
def test_wide_route_at_a_text_embedding_group_equals_plain(cuda, metric, qn):
    """B2's wide form at the 2-segment group of a 1M-row-segment corpus of
    768 features (2,000,128 rows; Q 512, and Q 200, whose last query tile
    holds 8 queries) gives ``exact_pool_packed_plain``'s plane bit for bit:
    one launch of all the queries, one ``wide_pass`` span with all of them.
    The features are small integers, so every product is exact in both
    (3xTF32 on the tensor cores, full f32 in the plain version), and so is
    every bin's winner (the smallest row on a tie). A zero row, rows left
    out, a pool group's rows all left out (its bins dead)."""
    q, x, valid = _text_embedding_group(qn, True, 768 + qn)
    n = x.shape[0]
    q_in, aux, mult, qn2, _step, geom = te.packed_pool_inputs(q, x, valid, metric)
    assert (geom["tile"], geom["fold"], geom["w"]) == (1024, 8, 245 * 128)
    registry = get_registry()
    s0 = max((r.seq for r in registry.spans().records), default=-1)
    wide = registry.counter_value(te.PACKED_LAUNCHES, {"form": "wide"})
    b1 = te.exact_pool_cuda.launches
    kp = te.exact_pool_packed_cuda(q_in, x, aux, mult, qn2, **geom)
    pp = te.exact_pool_packed_plain(q_in, x, aux, mult, qn2, **geom)
    torch.cuda.synchronize()
    assert registry.counter_value(te.PACKED_LAUNCHES, {"form": "wide"}) == wide + 1
    assert te.exact_pool_cuda.launches == b1
    assert torch.equal(kp, pp)
    live = torch.isfinite(pp)
    assert live.any() and not live[:, 128:256].any()
    passes = [r.attrs for r in registry.spans().records
              if r.seq > s0 and r.name == te.WIDE_PASS]
    assert passes == [{"queries": qn, "rows": n}]


@pytest.mark.parametrize("metric", ["COSINE", "L2"])
@pytest.mark.parametrize("qn", [512, 200])
def test_wide_form_equals_the_fold_1_route_on_float_rows(cuda, metric, qn):
    """On Gaussian rows, where the tensor cores' 3xTF32 sums differ from
    full f32, B2's wide form gives the plane of the route it replaced bit
    for bit: B1's wide form at fold 1 over all the queries, its two planes
    packed by ``pack_tiles`` (the same mainloop arithmetic, and IEEE single
    sqrt, products and round-half-even on both sides)."""
    q, x, valid = _text_embedding_group(qn, False, 769 + qn)
    q_in, aux, mult, qn2, _step, geom = te.packed_pool_inputs(q, x, valid, metric)
    kp = te.exact_pool_packed_cuda(q_in, x, aux, mult, qn2, **geom)
    w1 = -(-x.shape[0] // geom["tile"]) * geom["bins"]
    m, rows = te.exact_pool_cuda(q_in, x, aux, metric=metric, tile=geom["tile"],
                                 bins=geom["bins"], fold=1, w=w1)
    route = te.pack_tiles(m, rows, mult, qn2, metric=metric, tile=geom["tile"],
                          bins=geom["bins"], fold=geom["fold"], w=geom["w"],
                          slot_f=geom["slot_f"])
    torch.cuda.synchronize()
    assert torch.equal(kp, route)
    live = torch.isfinite(kp)
    assert live.any() and not live[:, 128:256].any()


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
        # the kernels' limits: live width 1 .. D, and 16-bit slice ids
        dict(geom=dict(geom, d_live=0)), dict(geom=dict(geom, d_live=17)),
        dict(geom=dict(geom, fold=2**15, w=geom["bins"],
                       slot_f=float(2**15 * (geom["tile"] // geom["bins"])))),
    ):
        a = dict(q_in=q_in, mult=mult, qn2=qn2, geom=geom) | bad
        with pytest.raises(ValueError):
            te.exact_pool_packed_cuda(a["q_in"], x, aux, a["mult"], a["qn2"],
                                      **a["geom"])


def test_packed_wrapper_rejects_more_column_blocks_than_a_grid_holds(cuda):
    """A pool whose column blocks pass the grid's 65,535 raises before any
    launch: at tile 512, fold 1 and 32,769 tiles B2's pipelined form would
    need 65,538 blocks of 64 columns, while B1's 32,769 blocks of 128 still
    launch."""
    n = 32_768 * 512 + 1
    x = torch.ones((n, 4), device=cuda)
    valid = torch.ones(n, dtype=torch.bool, device=cuda)
    q_in, aux, mult, qn2, _step, geom = te.packed_pool_inputs(
        x[:2], x, valid, tile_n=512, fold=1)
    assert geom["w"] // 64 == 65_538
    before = te.exact_pool_packed_cuda.launches
    with pytest.raises(ValueError, match="65,535 column blocks"):
        te.exact_pool_packed_cuda(q_in, x, aux, mult, qn2, **geom)
    assert te.exact_pool_packed_cuda.launches == before
    del geom["slot_f"]
    ks, ki = te.exact_pool_cuda(q_in, x, aux, **geom)
    torch.cuda.synchronize()
    assert bool((ki[:, :128] >= 0).all())


@pytest.mark.parametrize("qn,d_live,packed,form,floats", [
    (512, 128, False, "resident", 0), (512, 96, False, "resident", 0),
    (1, 100, False, "resident", 0),
    # rows over 128 live features take the wide form's scratch: two planes
    # of 64 queries x 32 features a query tile and a chunk
    (512, 960, False, "pipelined", 8 * 960 * 128),
    (1, 129, False, "pipelined", 160 * 128),
    (65, 1000, False, "pipelined", 2 * 1024 * 128),
    (513, 960, False, "pipelined", 9 * 960 * 128),
    (64, 960, False, "pipelined", 960 * 128),
    # B2: its pipelined form where its planes fit (none), else its wide
    # form, with B1's wide form's scratch (Cohere10M's batch: 3.1 MB)
    (512, 96, True, "pipelined", 0), (512, 704, True, "pipelined", 0),
    (512, 768, True, "wide", 8 * 768 * 128), (200, 768, True, "wide", 4 * 768 * 128),
])
def test_wide_form_scratch_size(cuda, qn, d_live, packed, form, floats):
    """The query planes' scratch the wrapper hands B1's and B2's wide forms,
    as csrc's exact_pool_plan sizes it (wide_plane_floats): 3.9 MB at
    GIST1M's batch, none on rows of up to 128 live features or on B2's
    pipelined form."""
    lib = te.cuda_build.load("exact_pool_tc", te._bind_tc)
    d = -(-d_live // 32) * 32
    assert te._plan(lib, "test", qn, d, d_live, 128, packed=packed)[::2] == (
        form, floats)


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


def test_b3_at_a_text_embedding_lut_matches_plain(cuda):
    """B3 at openai500k.batch512's shape: Q 512 x M 192 x K 256 over a
    100,096-row segment whose last 96 rows are its pad. The LUT's lines fit
    two queries a line (196,608 bytes of shared memory); the pool equals its
    plain version bit for bit, ids in every live bin included."""
    qn, n, m, k = 512, 100_096, 192, 256
    g = torch.Generator(device="cuda").manual_seed(1536)
    lut = torch.rand((qn, m, k), generator=g, device="cuda") * 9
    codes = torch.randint(0, k, (n, m), generator=g, device="cuda",
                          dtype=torch.int32).to(torch.uint8)
    valid = torch.rand(n, generator=g, device="cuda") < 0.98
    valid[100_000:] = False
    assert ta._line_queries("adc_pool_cuda", qn, m, k, ta._POOL) == 2
    lh = ta.lut_bf16(lut)
    tile, bins, fold, w = ta.pool_geometry(qn, m, k, n)
    geom = dict(tile=tile, bins=bins, fold=fold, w=w)
    before = ta.adc_pool_cuda.launches
    got = ta.adc_pool_cuda(lh, codes, valid, **geom)
    assert ta.adc_pool_cuda.launches == before + 1
    want = ta.adc_pool_plain(lh, codes, valid, **geom)
    torch.cuda.synchronize()
    live = torch.isfinite(want[0])
    assert bool(live.any())
    assert torch.equal(live, torch.isfinite(got[0]))
    assert torch.equal(got[0][live], want[0][live])
    assert torch.equal(got[1][live], want[1][live])
    assert bool((got[1][~live] == -1).all())


def test_rerank_cosine_branch_at_1536_features_on_the_card(cuda):
    """The flat re-rank's cosine branch on the card at 1,536 features
    (openai500k.batch512's rows: unit rows near unit centres, queries a
    centre plus noise), against float64: distances within 1e-6 (float32's
    roundings of the sums and norms; tests/test_torch_flat_text_embedding.py
    holds the argument), a zero row at distance 1 exactly, a zero query at 1
    from every row."""
    from vectorsearch_torch.ops import traversal as traversal_ops

    g = torch.Generator(device="cuda").manual_seed(1537)
    n, d, qn, c = 100_096, 1536, 512, 256
    centres = torch.randn((64, d), generator=g, device="cuda")
    centres /= centres.norm(dim=1, keepdim=True)
    x = centres[torch.randint(0, 64, (n,), generator=g, device="cuda")]
    x = x + 0.02 * torch.randn((n, d), generator=g, device="cuda")
    x /= x.norm(dim=1, keepdim=True)
    x[3] = 0.0
    q = centres[torch.randint(0, 64, (qn,), generator=g, device="cuda")]
    q = q + 0.02 * torch.randn((qn, d), generator=g, device="cuda")
    q[-1] = 0.0
    cand = torch.randint(0, n, (2, qn, c), generator=g, device="cuda",
                         dtype=torch.int32)
    cand[:, :, 0] = 3
    alive = torch.ones(n, dtype=torch.bool, device="cuda")
    sc, di, iv = traversal_ops.exact_rerank_segments(
        q, [(x, alive), (x, alive)], cand, 20, "COSINE")
    torch.cuda.synchronize()
    x64, q64 = x.double(), q.double()
    rows = x64[iv.long()]  # [2, Q, 20, D]
    den = q64.norm(dim=1)[None, :, None] * rows.norm(dim=-1)
    sim = torch.where(den == 0, 0.0, torch.einsum("qd,sqcd->sqc", q64, rows)
                      / torch.where(den == 0, 1.0, den))
    assert float((di.double() - (1.0 - sim)).abs().max()) <= 1e-6
    assert bool((di[:, -1] == 1.0).all())
    assert bool((di[iv == 3] == 1.0).all())


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


@pytest.mark.parametrize("mode", ["exact", "flat"])
def test_mesh_index_on_the_card_matches_the_cpu(cuda, rng, mode):
    """A mesh of [cuda:0] * 4 over one 65,536-row segment (16,384 rows a
    shard): exact mode launches B1 once a shard a batch and returns the
    plain CPU mesh run's gids; flat mode launches B4 once a shard and
    agrees with it (each device trains its own codebook) on > 0.9 of the
    gids. The sharded encoder on the card gives the single-device codes."""
    from vectorsearch_torch.ops import pq as tpq
    from vectorsearch_torch.parallel import mesh as tmesh

    x = rng.normal(size=(65_536 + 500, 16)).astype(np.float32)
    q = x[:64] + 0.05 * rng.normal(size=(64, 16)).astype(np.float32)
    kw = dict(sealed_search_mode="exact", graph_build_mode="skip_for_flat",
              pq_build_mode="skip_for_exact") if mode == "exact" else dict(
        graph_build_mode="skip_for_flat")
    out = []
    for device in ("cpu", "cuda"):
        mesh = tmesh.make_mesh([device] * 4)
        idx = tvs.VectorIndex.create_or_open(tvs.VectorIndexConfig(
            storage=tvs.MemoryStorage(), name="m", dimension=16,
            max_segment_size=65_536, pq_m=8, pq_k=64, device=device,
            mesh=mesh, **kw))
        try:
            idx.add_all(x)
            idx.build_service.build(0)
            idx.query_batch_arrays(q, 10)  # uploads
            b1, b4 = te.exact_pool_cuda.launches, ta.adc_scores_cuda.launches
            out.append(idx.query_batch_arrays(q, 10)[0])
            if device == "cuda":
                # + one B1 for the ACTIVE brute table (its 65,536-row
                # capacity takes the binned pool)
                want = (5, 0) if mode == "exact" else (1, 4)
                assert (te.exact_pool_cuda.launches - b1,
                        ta.adc_scores_cuda.launches - b4) == want
                seg = idx.store.segments[0]
                snap = seg.shard_snapshot()
                if mode == "flat":
                    codes = tmesh.sharded_pq_encode(mesh)(
                        tmesh.shard_rows(mesh, x[:65_536]),
                        seg.codebook_replicas,
                        tmesh.shard_rows(mesh, np.ones(65_536, bool)))
                    single = tpq.pq_encode(
                        torch.from_numpy(x[:65_536]).cuda(), seg.codebook_dev,
                        torch.ones(65_536, dtype=torch.bool, device="cuda"))
                    assert torch.equal(torch.cat(codes), single)
                assert all(v.is_cuda for v in snap.vectors)
        finally:
            idx.close()
    cg, gg = out
    assert (gg[:, 0] == np.arange(64)).all() and (cg[:, 0] == np.arange(64)).all()
    if mode == "exact":
        np.testing.assert_array_equal(gg, cg)
    else:
        assert np.mean(cg == gg) > 0.9


def test_async_prefetch_publishes_a_complete_codebook(cuda, rng):
    """A codebook uploaded by a prefetch thread on its own stream is read
    complete by a query thread on another stream right after it is
    published (the upload completes before the tensor is published)."""
    import threading
    import time

    idx = tvs.VectorIndex.create_or_open(tvs.VectorIndexConfig(
        storage=tvs.MemoryStorage(), name="p", dimension=256,
        max_segment_size=5_000, pq_m=64, pq_k=256, device="cuda",
        graph_build_mode="skip_for_flat"))
    try:
        idx.add_all(rng.normal(size=(15_000, 256)).astype(np.float32))
        for sid in range(3):
            idx.build_service.build(sid)
        segs = [idx.store.segments[s] for s in range(3)]
        for _round in range(20):
            for seg in segs:
                with seg._dev_lock:
                    seg._codebook_dev = None
            side = torch.cuda.Stream()

            def prefetch():
                with torch.cuda.stream(side):
                    idx.caches.prefetch_codebooks(segs)

            t = threading.Thread(target=prefetch)
            t.start()
            for seg in segs:
                while seg._codebook_dev is None:
                    time.sleep(0)
                cb = seg._codebook_dev  # read on this thread's stream
                assert torch.equal(cb.cpu(), torch.from_numpy(seg.codebook_np))
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        idx.close()


def test_a_sampled_batch_makes_no_device_sync(cuda, rng, monkeypatch):
    """Every batch sampled (query_breakdown_sample_every=1): the flat
    group's segments share one call, the phases come from device events
    read after the answers' copy, and no batch calls
    torch.cuda.synchronize."""
    from vectorsearch_torch.utils.metrics import get_registry, reset_for_test

    x = rng.normal(size=(40_000, 16)).astype(np.float32)
    idx = tvs.VectorIndex.create_or_open(tvs.VectorIndexConfig(
        storage=tvs.MemoryStorage(), name="s", dimension=16,
        max_segment_size=18_000, pq_m=8, pq_k=64, device="cuda",
        sealed_search_mode="flat", graph_build_mode="skip_for_flat",
        query_breakdown_sample_every=1,
    ))
    try:
        idx.add_all(x)
        for sid in range(2):
            idx.build_service.build(sid)
        reset_for_test()
        syncs = []
        real = torch.cuda.synchronize
        monkeypatch.setattr(torch.cuda, "synchronize",
                            lambda *a, **k: syncs.append(1) or real(*a, **k))
        for _ in range(4):
            g, _s, _d = idx.query_batch_arrays(x[:64], 10)
            assert (g[:, 0] == np.arange(64)).all()
        assert syncs == []
        scan = get_registry().histogram_values("vectorsearch.query.pq_scan_ms")
        # batches 2 and 3 recorded, two segments each, in one shared call
        assert len(scan) == 4 and len(set(scan)) == 2 and min(scan) > 0
    finally:
        idx.close()
