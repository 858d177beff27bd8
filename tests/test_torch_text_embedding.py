"""The port's exact mode on a cosine text-embedding corpus at 768 features
on the CPU (the cohere10m-exact configuration: VectorDBBench's Cohere
10M x 768 case), held against the benchmark's plain reference
(portbench/reference/knn.py: exact k-NN in float64 under COSINE, which
imports nothing of the program), on rows drawn by the benchmark's generator
(portbench/data.py) with the configuration's data settings.

Three sealed segments of 4,200 rows (4,224 with the capacity's padding)
take the routes the benchmark's 1M-row segments take: with ``MIN_ROWS``
and ``_PACKED_MIN_ROWS`` lowered, the power-of-two subgroup of two
segments (8,448 rows) takes B2's packed pool, whose cosine score is
quantized, and the singleton takes B1's two-plane pool (their plain forms
on the CPU). On the card, at 768 features and 512 queries, the packed pool
is B2's wide form: one launch of all the queries, B1's wide mainloop with
B2's tile epilogue; its wrapper is driven here through the index with a
stand-in library (``WideFormLib``) in the kernel's place.

Tolerances:
- distances, absolute: half the packed plane's step plus 5e-7. B2 packs
  each bin's best cosine score q.x/|x| as rint(score * SQ / |q|), a step
  of |q| / SQ, and the port reports 1 - level * step / |q| with no
  re-rank, so a distance errs by up to half a step over |q|, 0.5 / SQ
  (SQ = 2^23 / (fold * tile / bins): 2^20 at these segments' fold 1,
  2^17 at the 1M-row segments' fold 8, where the nearest rows lie ~0.2
  away). The 5e-7 covers float32's roundings around the score, a few
  units of 2^-23 at 1: the norms, the product's sums, the quotient by
  |q| and 1 - sim (a plain float32 product reads 4.7e-7 here, B2's
  3xTF32 one 2.2e-7). Products of TF32 inputs, one precision down, err
  by ~6e-5 on a distance at 768 features: past this tolerance at the
  cell's step by more than ten times (shown with
  tests/test_torch_exact_packed.py's model of the tensor cores).
- ids: every true top-10 row is returned, except (a) at the 10th rank,
  where a row may lose to one whose true distance lies within the distance
  tolerance of it (a float32 or quantization tie), and (b) where the binned
  pool kept a nearer row of the same bin (the pool keeps each bin's best
  row alone: a bin is the rows r of one call with the same
  r // (fold * tile) and r % bins).
- the zero-norm rule (``ops/distance.py``, the reference's): a zero row
  or a zero query has similarity 0, so distance 1, exactly.
"""

import ctypes
import json
import os

import numpy as np
import pytest
import torch

import vectorsearch_torch as tvs
from portbench import check, data
from portbench.reference import knn
from vectorsearch_torch.ops import exact as te
from vectorsearch_torch.utils.metrics import get_registry

SEG = 4_200
K = 10
NQ = 64
ZERO_ROW = 17  # a row of the singleton's segment, made zero
CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "portbench", "configs", "cohere10m-exact.json")


def _config():
    with open(CONFIG) as f:
        return json.load(f)


def _cohere_like(n_rows, n_queries, seed):
    """Rows and held-out queries of the cohere10m-exact configuration's
    generator, ``n_rows`` of them."""
    spec = dict(_config()["data"], rows=n_rows)
    inputs = data.make(spec, seed=seed, n_queries=n_queries, n_fresh=0, device="cpu")
    return inputs.rows, inputs.queries


def _keys(x):
    """A row's first two features' bits as one int64: unique among the
    generator's rows (the zero row aside)."""
    return np.ascontiguousarray(np.asarray(x, np.float32)[:, :2]).view(np.int64)[:, 0]


def _bins(calls, rows):
    """(call, bin) of every data row, from the tables the pools were handed
    and their geometry; (-1, -1) for a row in no call."""
    where = np.full((len(rows), 2), -1, np.int64)
    pos = {k: i for i, k in enumerate(_keys(rows))}
    for c, (x, g) in enumerate(calls):
        for r, key in enumerate(_keys(x)):
            i = pos.get(int(key))
            if i is not None:
                where[i] = (c, (r // (g["fold"] * g["tile"])) * g["bins"] + r % g["bins"])
    return where


def _open(monkeypatch, **index):
    """The configuration's index at this test's segment size, with the
    packed pool from two segments on and the binned pool from one."""
    monkeypatch.setattr(te, "MIN_ROWS", 4_096)
    monkeypatch.setattr(te, "_PACKED_MIN_ROWS", 2 * 4_096)
    return tvs.VectorIndex.create_or_open(tvs.VectorIndexConfig(
        storage=tvs.MemoryStorage(), name="cohere", device="cpu",
        **dict(_config()["index"], max_segment_size=SEG, **index)))


class WideFormLib:
    """A stand-in for the exact pools' library (``ops/exact.py::_bind_tc``'s)
    in which every packed launch takes B2's wide form: ``exact_pool_plan``
    returns FORM_WIDE with csrc's query tile (64) and scratch
    (wide_plane_floats: two planes of 64 queries x 32 features a query tile
    and a 32-feature chunk), and ``exact_pool_packed_launch`` reads its
    inputs from the pointers it is handed, as the kernel does, and writes
    ``exact_pool_packed_plain``'s plane (the function as it was when the
    stand-in was made) into the output. Every plan and launch is kept."""

    FORM_WIDE = 2  # csrc's enum Form

    def __init__(self):
        self.plain = te.exact_pool_packed_plain
        self.plans, self.launches = [], []

    @staticmethod
    def scratch(qn, d_live):
        return -(-qn // 64) * -(-d_live // 32) * 2 * 64 * 32

    def exact_pool_plan(self, qn, d, d_live, w, packed, tile, scratch):
        self.plans.append((qn, d, d_live, w, packed))
        tile._obj.value, scratch._obj.value = 64, self.scratch(qn, d_live)
        return self.FORM_WIDE

    def exact_pool_packed_launch(self, q, x, aux0, aux1, mult, qn2, out, qn, n,
                                 d, d_live, tile, bins, fold, w, cosine,
                                 slot_f, qplanes, qplane_floats, stream):
        def floats(ptr, count, *shape):
            arr = (ctypes.c_float * count).from_address(ptr)
            return torch.from_numpy(np.ctypeslib.as_array(arr)).view(*shape)

        self.launches.append(dict(qn=qn, n=n, d=d, d_live=d_live, fold=fold, w=w,
                                  planes=qplanes is not None,
                                  qplane_floats=qplane_floats))
        aux = [floats(aux0, n, n)] + ([floats(aux1, n, n)] if cosine else [])
        plane = self.plain(
            floats(q, qn * d, qn, d), floats(x, n * d, n, d), torch.stack(aux),
            floats(mult, qn, qn), floats(qn2, qn, qn),
            metric="COSINE" if cosine else "L2", tile=tile, bins=bins,
            fold=fold, w=w, slot_f=slot_f)
        floats(out, qn * w, qn, w).copy_(plane)
        return 0


def wide_form_stand_in(monkeypatch) -> WideFormLib:
    """Puts a ``WideFormLib`` in the kernel library's place for
    ``exact_pool_packed_cuda`` on CPU tensors: the library's loader returns
    it, the launch runs with no CUDA device or stream, and the tensors'
    checks (whose first is that they lie on the card; the card's tests hold
    them) are left out."""
    lib = WideFormLib()
    monkeypatch.setattr(te.cuda_build, "load", lambda name, bind: lib)
    monkeypatch.setattr(te, "_launch", lambda who, dev, fn, *args: fn(*args, None))
    monkeypatch.setattr(te, "_check_kernel_args", lambda *a, **k: None)
    return lib


def _build(idx, rows):
    gids = np.asarray(idx.add_all(rows), np.int64)
    for sid in range(3):
        idx.build_service.build(sid)
    return gids


@pytest.mark.parametrize("tombstones", [False, True])
def test_cosine_exact_mode_at_768_features_matches_the_reference(monkeypatch,
                                                                 tombstones):
    rows, q = _cohere_like(3 * SEG, NQ, 2**31 + 768)
    rows[2 * SEG + ZERO_ROW] = 0.0
    q[NQ - 1] = 0.0
    calls = []
    for name in ("exact_pool_plain", "exact_pool_packed_plain"):
        def spy(q_in, x, aux, *rest, _fn=getattr(te, name), **geom):
            calls.append((x.numpy(), geom))
            return _fn(q_in, x, aux, *rest, **geom)

        monkeypatch.setattr(te, name, spy)
    idx = _open(monkeypatch)
    try:
        gids = _build(idx, rows)
        deletes = ()
        if tombstones:
            # in the packed pair: the three nearest rows of the first eight
            # queries there, and 300 more
            pair = gids[: 2 * SEG]
            near = knn.topk_certain(knn.Log.build(pair, rows[: 2 * SEG]), q[:8],
                                    np.zeros(8), np.zeros(8), 3, "cpu",
                                    metric="COSINE")[0].ravel()
            rng = np.random.default_rng(768)
            dead = np.unique(np.concatenate([near, rng.choice(pair, 300, replace=False)]))
            idx.delete_all(dead.tolist())
            deletes = ((dead, -1.0, -1.0),)
        got_g, got_s, got_d = idx.query_batch_arrays(q, K)
    finally:
        idx.close()

    # the pair took the packed pool, the singleton the two-plane pool, both
    # binned over 768 features
    assert [("slot_f" in g, x.shape) for x, g in calls] == [
        (True, (2 * 4_224, 768)), (False, (4_224, 768))]
    slot_f, sq = te._packed_steps(calls[0][1]["tile"], calls[0][1]["bins"],
                                  calls[0][1]["fold"])
    atol = 0.5 / sq + 5e-7

    log = knn.Log.build(gids, rows, (), deletes)
    ts = te_ = np.zeros(NQ)
    assert check.bad_rows(log, got_g, ts, te_) == 0  # no tombstone, no repeat
    ref_g, ref_d = knn.topk_certain(log, q, ts, te_, K, "cpu", metric="COSINE")
    true_d = knn.distances(log, q, got_g, "cpu", metric="COSINE")
    assert (got_g >= 0).all()
    np.testing.assert_allclose(got_d, true_d, rtol=0, atol=atol)
    np.testing.assert_array_equal(got_d, np.float32(1.0) - got_s)
    # the zero query: similarity 0 to every row
    assert (got_d[NQ - 1] == 1.0).all()
    # the nearest rows lie ~0.2 away (a centre's rows), as at the cell's size
    assert 0.1 < float(np.median(ref_d[: NQ - 1, 0])) < 0.4

    where = _bins(calls, rows)
    excused = 0
    for i in range(NQ - 1):
        kth = true_d[i].max()
        for g, d in zip(ref_g[i], ref_d[i]):
            if g in got_g[i]:
                continue
            tie = d >= kth - 2 * atol
            same_bin = [h for h in got_g[i] if (where[h] == where[g]).all()
                        and true_d[i][got_g[i] == h][0] <= d + 2 * atol]
            assert tie or same_bin, (i, g, d, kth)
            excused += 1
    assert excused <= NQ * K // 50  # a rare event, not the rule
    if tombstones:
        assert not np.isin(got_g, deletes[0][0]).any()


def test_the_zero_row_is_one_away_from_every_query(monkeypatch):
    """A zero row scores 0 in both pools (its inverse norm is 0), so its
    distance is 1 exactly: asked for every row of a small index, each query
    finds it at 1 among rows at their true distances."""
    rows, q = _cohere_like(3 * SEG, 4, 2**31 + 769)
    zero = 2 * SEG + ZERO_ROW
    rows[zero] = 0.0
    idx = _open(monkeypatch)
    try:
        gids = _build(idx, rows)
        got_g, _s, got_d = idx.query_batch_arrays(q, 3 * SEG)
    finally:
        idx.close()
    hit = got_g == gids[zero]
    assert hit.sum(axis=1).tolist() == [1] * len(q)
    assert (got_d[hit] == 1.0).all()


def test_tf32_products_fail_the_distance_tolerance():
    """The distance tolerance above is tight enough that products one
    precision down fail it: on this configuration's rows, each query's ten
    nearest rows' cosine distances from TF32 inputs err by more than ten
    times the tolerance at the cell's step (fold 8: 0.5 / 2^17 + 5e-7),
    while B2's 3xTF32 product with its chunk sums (the tensor cores'
    model in tests/test_torch_exact_packed.py) stays within the 5e-7 of
    float32's roundings."""
    from tests.test_torch_exact_packed import _tensor_core_product
    from tests.test_torch_exact_pool import _split_tf32

    rows, q = _cohere_like(3 * SEG, 32, 2**31 + 770)
    x64, q64 = rows.astype(np.float64), q.astype(np.float64)
    xn, qn = np.linalg.norm(x64, axis=1), np.linalg.norm(q64, axis=1)
    d = 1.0 - (q64 @ x64.T) / (qn[:, None] * xn[None, :])
    near = np.argsort(d, axis=1)[:, :K]
    true = np.take_along_axis(d, near, axis=1)
    xs = torch.from_numpy(rows[near.ravel()])
    tq = torch.from_numpy(q)
    inv = torch.rsqrt((xs * xs).sum(1)).double().numpy()
    pick = np.arange(near.size).reshape(near.shape)

    def err(product):
        s = product(tq, xs).double().numpy()[np.arange(len(q))[:, None], pick]
        got = 1.0 - s * inv[pick] / qn[:, None]
        return float(np.abs(got - true).max())

    cell_atol = 0.5 / te._packed_steps(1024, 128, 8)[1] + 5e-7
    tf32 = err(lambda a, b: _split_tf32(a)[0] @ _split_tf32(b)[0].T)
    assert tf32 > 10 * cell_atol, tf32
    assert err(_tensor_core_product(True)) <= 5e-7


def test_wide_route_through_the_index(monkeypatch):
    """B2's wide form reached from the index through its wrapper, a
    ``WideFormLib`` in the kernel library's place, over six segments
    (subgroups of four and two, both packed): each call is one launch of
    all the batch's queries with the scratch its plan reports, one
    ``wide_pass`` span a call with the batch's queries and the group's
    rows, on unsampled and sampled batches alike; the answers are the plain
    route's, bit for bit."""
    rows, q = _cohere_like(6 * SEG, NQ, 2**31 + 771)
    idx = _open(monkeypatch, query_breakdown_sample_every=1)
    reg = get_registry()

    def last_seq():
        return max((r.seq for r in reg.spans().records), default=-1)

    groups = (4 * 4_224, 2 * 4_224)
    try:
        gids = np.asarray(idx.add_all(rows), np.int64)
        for sid in range(6):
            idx.build_service.build(sid)
        runs = []
        with monkeypatch.context() as m:
            lib = wide_form_stand_in(m)
            m.setattr(te, "exact_pool_packed_plain", te.exact_pool_packed_cuda)
            # batch 0 (never sampled), 1 (the shapes' first sampled one) and
            # 2 (sampled, recording)
            for _ in range(3):
                s0 = last_seq()
                runs.append(idx.query_batch_arrays(q, K))
                runs[-1] += ([r.attrs for r in reg.spans().records
                              if r.seq > s0 and r.name == te.WIDE_PASS],)
        plain = idx.query_batch_arrays(q, K)
    finally:
        idx.close()
    for r in runs:
        np.testing.assert_array_equal(r[0], plain[0])
        np.testing.assert_array_equal(r[1], plain[1])
        assert r[3] == [{"queries": NQ, "rows": n} for n in groups]
    assert [(c["qn"], c["n"], c["fold"]) for c in lib.launches] == [
        (NQ, n, 1) for n in groups] * 3
    assert all(c["planes"] and c["qplane_floats"] == lib.scratch(NQ, 768)
               for c in lib.launches)
    # the answers are the reference's (the nearest row of each query)
    log = knn.Log.build(gids, rows)
    ref_g, _d = knn.topk_certain(log, q, np.zeros(NQ), np.zeros(NQ), 1, "cpu",
                                 metric="COSINE")
    assert (plain[0][:, 0] == ref_g[:, 0]).mean() > 0.95
