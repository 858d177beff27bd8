"""The plain reference against brute force at a tiny size, its visibility
rules, the control's precision and the comparison's numbers."""

import numpy as np
import pytest
import torch

from portbench import check
from portbench.reference import control, knn


def _brute(q, x, k):
    d = np.linalg.norm(q[:, None, :].astype(np.float64) - x[None, :, :], axis=2)
    i = np.argsort(d, axis=1, kind="stable")[:, :k]
    return i, np.take_along_axis(d, i, 1)


def test_topk_matches_brute_force_in_blocks():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3000, 12)).astype(np.float32)
    q = rng.normal(size=(37, 12)).astype(np.float32)
    log = knn.Log.build(np.arange(3000), x)
    now = np.zeros(37)
    g, d = knn.topk_certain(log, q, now, now, 10, "cpu", budget_bytes=8 * 37 * 1100)
    bi, bd = _brute(q, x, 10)
    assert np.array_equal(g, bi)
    assert np.allclose(d, bd, rtol=1e-12)
    assert np.allclose(knn.distances(log, q, g, "cpu"), bd, rtol=1e-12)


def test_visibility_of_writes():
    x = np.eye(4, dtype=np.float32)
    fresh = np.array([[0.9, 0, 0, 0]], np.float32)
    # row 0 deleted: started at t=5, acknowledged at t=6; gid 4 added at 2..3
    log = knn.Log.build(np.arange(4), x, adds=[(np.array([4]), fresh, 2.0, 3.0)],
                        deletes=[(np.array([0]), 5.0, 6.0)])
    q = np.array([[1.0, 0, 0, 0]] * 3, np.float32)
    ts, te = np.array([0.0, 3.5, 7.0]), np.array([1.0, 4.0, 8.0])
    g, _d = knn.topk_certain(log, q, ts, te, 1, "cpu")
    # before the add: row 0; after the add, before the delete: row 0 again
    # (distance 0); after the delete's acknowledgement: gid 4
    assert g[:, 0].tolist() == [0, 0, 4]
    pos = log.possible(np.array([[0, 4, 9]] * 3), ts, te)
    assert pos.tolist() == [[True, False, False], [True, True, False],
                            [False, True, False]]


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2**-10, 1.0 + 2**-11 + 2**-13, 3.14159265])
    r = control.tf32(x)
    assert r[0] == 1.0 and r[1] == 1.0 + 2**-10
    assert r[2] == 1.0 + 2**-10  # rounded up past the half
    assert abs(float(r[3]) - 3.14159265) <= 3.14159265 * 2**-11


def test_control_answers_and_their_distances():
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(2000, 16)) * 4).astype(np.float32)
    q = x[:50] + rng.normal(size=(50, 16)).astype(np.float32)
    idx = control.BruteIndex(16, 2000, "cpu", block_rows=512)
    gids = idx.add_all(x)
    idx.delete_all([gids[3]])
    g, s, d = idx.query_batch_arrays(q, 10)
    assert g.shape == (50, 10) and (g != 3).all()
    log = knn.Log.build(np.arange(2000), x, deletes=[(np.array([3]), 0.0, 0.0)])
    ts, te = np.ones(50), np.ones(50)
    miss, err = check.sampled(log, q, g, d, ts, te, 10, "cpu")
    assert miss < 0.05
    assert err > 1e-4  # TF32 distances, which the limits reject
    assert check.bad_rows(log, g, ts, te) == 0


def test_numbers_see_the_faults():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(500, 8)).astype(np.float32)
    q = rng.normal(size=(20, 8)).astype(np.float32)
    log = knn.Log.build(np.arange(500), x, deletes=[(np.arange(10), 0.0, 0.5)])
    ts, te = np.ones(20), np.ones(20)
    g, d = knn.topk_certain(log, q, ts, te, 5, "cpu")
    d = d.astype(np.float32)
    assert check.sampled(log, q, g, d, ts, te, 5, "cpu")[0] == 0.0
    half = g.copy()
    half[10:] = -1
    assert check.sampled(log, q, half, d, ts, te, 5, "cpu")[0] == 0.5
    wrong = d.copy()
    wrong[0, 0] *= 1.01
    assert check.sampled(log, q, g, wrong, ts, te, 5, "cpu")[1] > 1e-3
    dead = g.copy()
    dead[0, 0] = 3  # deleted and acknowledged before the query was sent
    assert check.bad_rows(log, dead, ts, te) == 1
    twice = g.copy()
    twice[1, 1] = twice[1, 0]
    assert check.bad_rows(log, twice, ts, te) == 1
    ok, shown = check.verdict({"miss": 0.0, "dist_err": 0.0, "bad_rows": 1,
                               "unanswered": 0},
                              {"miss": 0.1, "dist_err": 1e-4, "bad_rows": 0,
                               "unanswered": 0})
    assert not ok and list(shown) == list(check.NUMBERS)


def _brute_cos(q, x, seen, k):
    """NumPy float64 cosine distances, 1 where either norm is 0; the k
    smallest of the seen rows, ties in gid order."""
    q, x = q.astype(np.float64), x.astype(np.float64)
    den = np.linalg.norm(q, axis=1)[:, None] * np.linalg.norm(x, axis=1)[None, :]
    d = 1.0 - np.where(den == 0, 0.0, (q @ x.T) / np.where(den == 0, 1.0, den))
    d = np.where(seen, d, np.inf)
    i = np.argsort(d, axis=1, kind="stable")[:, :k]
    return i, np.take_along_axis(d, i, 1), d


def _cosine_case():
    """Rows of norms from 0.1 to 10, one of them zero; 100 adds acknowledged
    at 2..3 and the first 200 rows deleted at 5..6; queries near the deleted
    rows and the added ones, sent before, between and after the writes; a
    query along the first axis, from which every row but five points away,
    so that the zero row (gid 2,500, distance 1) ranks sixth; a zero query."""
    rng = np.random.default_rng(7)
    x = (rng.normal(size=(3000, 12)) * rng.uniform(0.1, 10, (3000, 1))).astype(np.float32)
    x[:, 0] = -np.abs(x[:, 0])
    x[2990:2995, 0] = np.abs(x[2990:2995, 0]) + 1.0
    x[2500] = 0.0
    fresh = (rng.normal(size=(100, 12)) * 3).astype(np.float32)
    log = knn.Log.build(np.arange(3000), x, adds=[(np.arange(3000, 3100), fresh, 2.0, 3.0)],
                        deletes=[(np.arange(200), 5.0, 6.0)])
    near = np.concatenate([x[:30], fresh[:30]])
    near = near + 0.05 * np.abs(near).mean(1, keepdims=True) * rng.normal(size=near.shape)
    q = np.concatenate([near, [[3.0] + [0.0] * 11], np.zeros((1, 12))]).astype(np.float32)
    ts = np.resize([0.0, 3.5, 4.0, 7.0], len(q))
    te = ts + np.resize([1.0, 0.5, 1.5, 1.0], len(q))  # 4.0..5.5 overlaps a delete
    rows = np.concatenate([x, fresh])
    seen = (log.add_ack[None, :] < ts[:, None]) & (log.del_start[None, :] > te[:, None])
    return log, q, ts, te, rows, seen


@pytest.mark.parametrize("budget", [8 * 62 * 1100, 1 << 31], ids=["blocks", "one"])
def test_cosine_topk_matches_brute_force(budget):
    log, q, ts, te, rows, seen = _cosine_case()
    g, d = knn.topk_certain(log, q, ts, te, 10, "cpu", budget_bytes=budget,
                            metric="COSINE")
    bi, bd, _ = _brute_cos(q, rows, seen, 10)
    assert np.allclose(d, bd, rtol=1e-12, atol=0)
    assert np.array_equal(g[:-1], bi[:-1])
    assert 2500 in g[-2] and d[-2][list(g[-2]).index(2500)] == 1.0
    # the zero query ties every row at 1: any 10 it saw, each once
    assert (d[-1] == 1.0).all() and len(set(g[-1])) == 10 and seen[-1, g[-1]].all()
    # a tie is never a miss: the stable choice reads as correct
    miss, err = check.sampled(log, q, bi, bd, ts, te, 10, "cpu", "COSINE")
    assert miss == 0.0 and err < 1e-11


def test_cosine_distances_match_brute_force():
    log, q, ts, te, rows, seen = _cosine_case()
    g = np.tile(np.array([0, 2500, 3050, 7, 2999, -1, 99999]), (len(q), 1))
    d = knn.distances(log, q, g, "cpu", "COSINE")
    _, _, full = _brute_cos(q, rows, np.ones_like(seen), 10)
    want = full[:, g[0, :5]]
    assert np.allclose(d[:, :5], want, rtol=1e-12, atol=0)
    assert (d[:, 1] == 1.0).all() and (d[-1, :5] == 1.0).all()  # zero row, zero query
    assert np.isnan(d[:, 5:]).all()


def test_no_metric_is_l2_bit_for_bit():
    log, q, ts, te, _rows, _seen = _cosine_case()
    a = knn.topk_certain(log, q, ts, te, 10, "cpu", budget_bytes=8 * 62 * 1100)
    b = knn.topk_certain(log, q, ts, te, 10, "cpu", budget_bytes=8 * 62 * 1100,
                         metric="L2")
    assert all(u.dtype == v.dtype and u.tobytes() == v.tobytes() for u, v in zip(a, b))
    assert knn.distances(log, q, a[0], "cpu").tobytes() == \
        knn.distances(log, q, a[0], "cpu", "L2").tobytes()
    answers = []
    for kw in ({}, {"metric": "L2"}):
        idx = control.BruteIndex(12, 3100, "cpu", block_rows=512, **kw)
        idx.add_all(log.vectors[:3000])
        answers.append(idx.query_batch_arrays(q, 10))
    assert all(u.tobytes() == v.tobytes() for u, v in zip(*answers))


def test_an_unknown_metric_raises():
    log, q, ts, te, _rows, _seen = _cosine_case()
    with pytest.raises(ValueError, match="IP"):
        knn.topk_certain(log, q, ts, te, 10, "cpu", metric="IP")
    with pytest.raises(ValueError, match="IP"):
        knn.distances(log, q, np.zeros((len(q), 1), np.int64), "cpu", "IP")
    with pytest.raises(ValueError, match="IP"):
        check.sampled(log, q, np.zeros((len(q), 1), np.int64), np.zeros((len(q), 1)),
                      ts, te, 1, "cpu", "IP")
    with pytest.raises(ValueError, match="IP"):
        control.BruteIndex(12, 10, "cpu", metric="IP")


def test_control_cosine_distances_are_tf32():
    rng = np.random.default_rng(4)
    x = (rng.normal(size=(2000, 16)) * rng.uniform(0.5, 4, (2000, 1))).astype(np.float32)
    x[11] = 0.0
    q = (x[:50] + 0.05 * rng.normal(size=(50, 16))).astype(np.float32)
    idx = control.BruteIndex(16, 2000, "cpu", block_rows=512, metric="COSINE")
    gids = idx.add_all(x)
    idx.delete_all([gids[3]])
    g, s, d = idx.query_batch_arrays(q, 10)
    assert g.shape == (50, 10) and (g != 3).all() and (g >= 0).all()
    # 1 - sim from TF32 operands and f32 norms, in float64
    qt = control.tf32(torch.from_numpy(q)).double().numpy()
    xt = control.tf32(torch.from_numpy(x)).double().numpy()
    dots = (qt[:, None, :] * xt[g]).sum(-1)
    den = np.linalg.norm(q, axis=1)[:, None] * np.linalg.norm(x, axis=1)[g]
    want = 1.0 - np.where(den == 0, 0.0, dots / np.where(den == 0, 1.0, den))
    assert np.allclose(d, want, rtol=0, atol=2e-6)
    assert np.allclose(s, 1.0 - d, rtol=0, atol=1e-7)
    log = knn.Log.build(np.arange(2000), x, deletes=[(np.array([3]), 0.0, 0.0)])
    ts, te = np.ones(50), np.ones(50)
    miss, err = check.sampled(log, q, g, d, ts, te, 10, "cpu", "COSINE")
    assert miss < 0.05
    assert err > 1e-3  # past every cell's dist_err limit (2e-5 to 1e-3)
    assert check.bad_rows(log, g, ts, te) == 0
    # the reference's own answers in float32 read far under it
    rg, rd = knn.topk_certain(log, q, ts, te, 10, "cpu", metric="COSINE")
    assert check.sampled(log, q, rg, rd.astype(np.float32), ts, te, 10, "cpu",
                         "COSINE")[1] < 1e-5


@pytest.mark.cuda
def test_tf32_emulation_matches_the_cards_tf32(cuda):
    """The control's rounding stands for the card's TF32 products."""
    g = torch.Generator(device=cuda).manual_seed(5)
    a = torch.randn(256, 128, device=cuda, generator=g)
    b = torch.randn(128, 512, device=cuda, generator=g)
    old = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        card = a @ b
        torch.backends.cuda.matmul.allow_tf32 = False
        emulated = control.tf32(a) @ control.tf32(b.T.contiguous()).T
        full = a.double() @ b.double()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    err_card = (card.double() - full).abs().max().item()
    err_emul = (emulated.double() - full).abs().max().item()
    assert err_card > 1e-4 and err_emul > 1e-4
    assert 0.25 < err_emul / err_card < 4.0
