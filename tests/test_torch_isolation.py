"""What the port must never do: import JAX or the JAX package, drop silently
to the CPU, serve a mode it has not ported another way, or let a write
change the tensors a query in flight is reading."""

import os
import re
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import vectorsearch_torch as tvs
from vectorsearch_torch.core.segment import Segment
from vectorsearch_torch.core.stack import SealedStack
from vectorsearch_torch.ops import exact as te
from vectorsearch_torch.types import SegmentMeta, SegmentState

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

EXACT = dict(sealed_search_mode="exact", graph_build_mode="skip_for_flat",
             pq_build_mode="skip_for_exact")


def _config(**kw):
    base = dict(storage=tvs.MemoryStorage(), name="idx", dimension=8,
                metric="L2", max_segment_size=128, pq_m=4, pq_k=16,
                graph_degree=16, graph_build_breadth=64, device="cpu", **EXACT)
    base.update(kw)
    return tvs.VectorIndexConfig(**base)


_PROBE = r"""
import sys
import numpy as np
import vectorsearch_torch as vs
idx = vs.VectorIndex.create_or_open(vs.VectorIndexConfig(
    storage=vs.MemoryStorage(), name="p", dimension=8, max_segment_size=64,
    pq_m=4, device="cpu", sealed_search_mode="exact",
    graph_build_mode="skip_for_flat", pq_build_mode="skip_for_exact"))
x = np.random.default_rng(0).normal(size=(200, 8)).astype(np.float32)
idx.add_all(x)
for sid in (0, 1):
    idx.build_service.build(sid)
gids, _s, _d = idx.query_batch_arrays(x[:4], 3)
assert gids[:, 0].tolist() == [0, 1, 2, 3], gids
assert idx.query(x[150], 1)[0].gid == 150
idx.close()
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib", "vectorsearch_tpu")))
print("LOADED", bad)
"""


def test_port_runs_without_jax_or_the_jax_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


def test_port_sources_import_nothing_of_jax():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|vectorsearch_tpu)\b", re.M)
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, names in os.walk(os.path.join(REPO, "vectorsearch_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    for path in files:
        with open(path) as f:
            assert not pat.search(f.read()), path


def test_default_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _config(device="cuda")
    assert tvs.VectorIndexConfig(storage=tvs.MemoryStorage(), name="d",
                                 pq_m=4, dimension=8, **EXACT).device.type == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tvs.VectorIndex.create_or_open(cfg)
    # asking for the CPU works
    tvs.VectorIndex.create_or_open(_config()).close()


class _CudaLike(torch.Tensor):
    """A CPU tensor that reports is_cuda, to drive the pool's dispatch."""

    @property
    def is_cuda(self):
        return True


def test_cuda_tensor_never_takes_the_plain_pool(monkeypatch):
    """The pool wrapper picks the plain version by the tensor's device only:
    a CUDA tensor goes to the kernel wrapper, whose failure propagates."""
    called = []

    def no_kernel(*a, **k):
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr(te, "exact_pool_plain", lambda *a, **k: called.append(1))
    monkeypatch.setattr(te, "exact_pool_cuda", no_kernel)
    x = torch.zeros(16, 8).as_subclass(_CudaLike)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        te.exact_bin_pool(torch.zeros(2, 8), x, torch.ones(16, dtype=torch.bool))
    assert not called


def test_kernel_wrapper_rejects_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        te.exact_pool_cuda(torch.zeros(2, 8), torch.zeros(16, 8),
                           torch.zeros(1, 16), metric="L2", tile=512,
                           bins=128, fold=1, w=128)


@pytest.mark.parametrize(
    "kw,item",
    [
        (dict(sealed_search_mode="flat", graph_build_mode="always",
              pq_build_mode="always"), "A12"),
        (dict(sealed_search_mode="graph", graph_build_mode="always",
              pq_build_mode="always"), "A13"),
        # PQ training at seal is served; building the graph there is not
        # (the message names A13 and points at A12's graph-less seal)
        (dict(pq_build_mode="always", graph_build_mode="always"), "A12"),
        (dict(device_placement="round_robin"), "A15"),
        (dict(mesh=object()), "A15"),
    ],
)
def test_modes_outside_the_slice_raise(kw, item):
    with pytest.raises(NotImplementedError, match=item):
        _config(**kw)


def test_default_modes_raise_not_implemented():
    # the config defaults stay the JAX package's (flat mode with the graph
    # built at seal, which is not ported): a default config fails loudly
    # instead of serving another mode
    with pytest.raises(NotImplementedError, match="flat"):
        tvs.VectorIndexConfig(storage=tvs.MemoryStorage(), name="d")


def test_compaction_and_maintenance_raise():
    idx = tvs.VectorIndex.create_or_open(_config())
    try:
        with pytest.raises(NotImplementedError, match="A11"):
            idx.request_compaction([0, 1])
        with pytest.raises(NotImplementedError, match="A11"):
            idx.dispatch_maintenance(object())
    finally:
        idx.close()


def _segment(n, d=8, cap=256):
    seg = Segment(SegmentMeta(segment_id=0, state=SegmentState.ACTIVE), cap, d)
    rng = np.random.default_rng(1)
    seg.append_rows(rng.normal(size=(n, d)).astype(np.float32), [None] * n)
    return seg


def test_sync_copies_on_write():
    """Appends and tombstones publish NEW device tensors; the ones a query
    already holds keep their contents."""
    seg = _segment(100)
    v0, a0, e0, x0, rows0 = seg.device_snapshot()
    keep = [t.clone() for t in (v0, a0, e0, x0)]
    stack = SealedStack([seg])
    sv, sa = stack.vectors.clone(), stack.alive.clone()
    seg.append_rows(np.ones((50, 8), np.float32), [None] * 50)
    seg.tombstone_batch(np.array([3, 7, 120]))
    v1, a1, e1, x1, rows1 = seg.device_snapshot()
    for old, snap in zip((v0, a0, e0, x0), keep):
        assert torch.equal(old, snap)
    assert torch.equal(stack.vectors, sv) and torch.equal(stack.alive, sa)
    assert (rows0, rows1) == (100, 150)
    assert v1 is not v0 and bool(e1[100:150].all())
    assert int(a1[100:150].sum()) == 49  # all appended rows but 120 alive
    assert not bool(a1[3]) and not bool(a1[7]) and not bool(a1[120])
    assert bool(e1[3]) and float(v1[149, 0]) == 1.0
    assert x1 is not x0 and float(x1[149]) == 8.0
    # a stack refreshed after the tombstones keeps its own rows only
    stack.refresh_flags()
    assert not bool(stack.alive[0, 3]) and not bool(stack.alive[0, 120])
    assert not bool(stack.alive[0, 100:150].any())


def test_duplicate_flag_updates_keep_the_last_write():
    seg = _segment(20)
    seg.sync_device()
    seg.tombstone_batch(np.array([5]))  # alive False, exists True
    seg.remove_rows(np.array([5]))  # then cleared: exists False
    snap = seg.device_snapshot()
    assert not bool(snap.alive[5]) and not bool(snap.exists[5])


def test_query_in_flight_during_append_sync_sees_its_snapshot(monkeypatch):
    """An append and a device sync that land while a query is inside the
    pool do not change what that query reads: it answers from the snapshot
    it started with. (Gids map to rows on the host after the pool, as in the
    JAX package, so a DELETE landing mid-query drops that row's slot.)"""
    rng = np.random.default_rng(3)
    n = te.MIN_ROWS + 100  # one ACTIVE brute table on the binned-pool route
    x = rng.normal(size=(n, 8)).astype(np.float32)
    idx = tvs.VectorIndex.create_or_open(_config(max_segment_size=2 * n))
    try:
        idx.add_all(x)
        q = x[:4] + 0.01
        want = idx.query_batch_arrays(q, 5)
        orig = te.exact_bin_pool
        fired = []

        def racing(qq, xx, valid, *a, **kw):
            if not fired:
                fired.append(1)
                # exact copies of the queries' rows, appended and synced to
                # the device mid-query
                idx.add_all(x[:4])
                idx.store.segments[0].sync_device()
            return orig(qq, xx, valid, *a, **kw)

        monkeypatch.setattr(te, "exact_bin_pool", racing)
        got = idx.query_batch_arrays(q, 5)
        assert fired
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        after = idx.query_batch_arrays(q, 5)[0]
        for i in range(4):  # now the copies tie with their originals
            assert set(after[i, :2].tolist()) == {i, n + i}
    finally:
        idx.close()


def test_concurrent_writers_and_readers_stay_consistent():
    """Time-bounded stress: a writer appends and deletes while readers query
    with a short switch interval. Every answer is sorted and its distances
    are the true distances of the rows it names (a torn snapshot — new rows
    with stale norms or masks — would break this)."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(3000, 8)).astype(np.float32)
    idx = tvs.VectorIndex.create_or_open(_config(max_segment_size=4096))
    errors = []
    stop = threading.Event()
    idx.add_all(x[:500])

    def writer():
        try:
            for i in range(500, 3000, 100):
                idx.add_all(x[i : i + 100])
                idx.delete_all(list(range(i - 500, i - 450)))
        except Exception as e:  # pragma: no cover - reported below
            errors.append(e)
        finally:
            stop.set()

    def reader(seed):
        r = np.random.default_rng(seed)
        try:
            while not stop.is_set():
                q = x[r.integers(0, 500, 16)]
                gids, _s, d = idx.query_batch_arrays(q, 5)
                ok = gids >= 0  # a delete landing mid-query empties its slot
                for row, keep in zip(d, ok):
                    assert (np.diff(row[keep]) >= -1e-5).all()
                true = np.linalg.norm(x[gids[ok]] - np.repeat(q, 5, 0).reshape(
                    16, 5, 8)[ok], axis=1)
                np.testing.assert_allclose(d[ok], true, rtol=1e-3, atol=1e-3)
        except Exception as e:
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=writer)] + [
            threading.Thread(target=reader, args=(s,)) for s in range(4)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
        idx.close()
    assert not errors, errors[0]


_FLAT_PROBE = r"""
import sys
import numpy as np
import vectorsearch_torch as vs
for unified in (False, True):
    idx = vs.VectorIndex.create_or_open(vs.VectorIndexConfig(
        storage=vs.MemoryStorage(), name="p", dimension=8, max_segment_size=64,
        pq_m=4, pq_k=16, device="cpu", sealed_search_mode="flat",
        graph_build_mode="skip_for_flat", pq_build_mode="always",
        unified_search=unified))
    x = np.random.default_rng(0).normal(size=(200, 8)).astype(np.float32)
    idx.add_all(x)
    for sid in (0, 1):
        idx.build_service.build(sid)
    assert idx.store.segments[0].codes_np.shape == (128, 4)
    gids, _s, _d = idx.query_batch_arrays(x[:4], 3)
    assert gids[:, 0].tolist() == [0, 1, 2, 3], gids
    idx.close()
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib", "vectorsearch_tpu")))
print("LOADED", bad)
"""


def test_flat_port_runs_without_jax_or_the_jax_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run(
        [sys.executable, "-c", _FLAT_PROBE], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


def test_defaults_and_graph_mode_name_what_is_missing():
    # the all-defaults config is flat mode with the graph built at seal
    with pytest.raises(NotImplementedError, match="A13"):
        tvs.VectorIndexConfig(storage=tvs.MemoryStorage(), name="d")
    with pytest.raises(NotImplementedError, match="A14"):
        _config(sealed_search_mode="graph", graph_build_mode="always",
                pq_build_mode="always")
    with pytest.raises(NotImplementedError, match="A13"):
        _config(pq_build_mode="always", graph_build_mode="always")
    # served: flat with a graph-less seal, and exact with PQ at seal
    assert _config(sealed_search_mode="flat", pq_build_mode="always").sealed_search_mode == "flat"
    assert _config(pq_build_mode="always").pq_build_mode == "always"


def test_cuda_tensor_never_takes_the_plain_adc_paths(monkeypatch):
    """Each ADC wrapper picks the plain version by the tensor's device only:
    a CUDA tensor goes to the kernel wrapper, whose failure propagates."""
    from vectorsearch_torch.ops import adc as ta

    called = []

    def no_kernel(*a, **k):
        raise RuntimeError("kernel launch failed")

    for plain, kernel in (
        ("adc_pool_plain", "adc_pool_cuda"),
        ("adc_scores_plain", "adc_scores_cuda"),
        ("adc_scan_plain", "adc_scan_cuda"),
        ("adc_scan_precise_plain", "adc_scan_precise_cuda"),
    ):
        monkeypatch.setattr(ta, plain, lambda *a, **k: called.append(1))
        monkeypatch.setattr(ta, kernel, no_kernel)
    lut = torch.rand(2, 4, 16)
    codes = torch.zeros(300, 4, dtype=torch.uint8).as_subclass(_CudaLike)
    valid = torch.ones(300, dtype=torch.bool)
    for call in (
        lambda: ta.adc_bin_pool(lut, codes, valid),
        lambda: ta.adc_scan_scores(lut, codes, valid),
        lambda: ta.adc_scan_kernel(lut, codes, valid),
        lambda: ta.adc_scan_kernel(lut, codes, valid, precise=True),
    ):
        with pytest.raises(RuntimeError, match="kernel launch failed"):
            call()
    assert not called


def test_flat_snapshot_pairs_codes_with_flags_of_one_sync():
    """Codes reach the device in the same locked sync as the flags; a seal
    that replaces the codes drops the device copy, and a vacuumed row stays
    masked (exists=False) whatever codes the device still holds."""
    seg = _segment(100)
    codes = np.arange(seg.cap_pad * 4, dtype=np.uint8).reshape(seg.cap_pad, 4)
    seg.attach_build_artifacts(codes, np.zeros((4, 16, 2), np.float32),
                               np.zeros((seg.cap_pad, 0), np.int32))
    snap = seg.flat_snapshot()
    assert torch.equal(snap.codes, torch.from_numpy(codes)) and snap.rows == 100
    assert snap.codes is seg.flat_snapshot().codes  # uploaded once
    seg.tombstone_batch(np.array([3]))
    seg.remove_rows(np.array([5]))
    snap2 = seg.flat_snapshot()
    assert not bool(snap2.alive[3]) and bool(snap2.exists[3])
    assert not bool(snap2.exists[5]) and not bool(snap2.alive[5])
    assert bool(snap.exists[5])  # the earlier snapshot is untouched
    seg.attach_build_artifacts(codes * 0, np.zeros((4, 16, 2), np.float32),
                               np.zeros((seg.cap_pad, 0), np.int32))
    assert not seg.flat_snapshot().codes.any()
    assert seg.codebook_dev.shape == (4, 16, 2)
