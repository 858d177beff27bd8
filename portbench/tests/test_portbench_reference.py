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
