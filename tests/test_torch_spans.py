"""The port's spans on the CPU (vectorsearch_torch/utils/metrics.py): the
span ring, the query's per-batch stages (recorded only under a torch
profiler), the query path's waits on the write side and their holders,
the seal's phases, and the sampled breakdowns, which mark the fused
route's stages without a device synchronisation."""

import threading
import time

import pytest
import torch
from torch.profiler import profile

import vectorsearch_torch as tvs
from vectorsearch_torch.core import index as index_mod
from vectorsearch_torch.utils import metrics
from vectorsearch_torch.utils.metrics import get_registry, reset_for_test

from tests.test_index_e2e import gaussian, run_builds

STAGES = ["vectorsearch.query.plan", "vectorsearch.query.brute",
          "vectorsearch.query.pool", "vectorsearch.query.rerank",
          "vectorsearch.query.merge", "vectorsearch.query.wait",
          "vectorsearch.query.join"]


def make_index(name="s", **kw):
    base = dict(
        storage=tvs.MemoryStorage(), name=name, dimension=8, metric="L2",
        max_segment_size=100, pq_m=4, pq_k=16, graph_degree=16,
        graph_build_breadth=64, graph_alpha=1.2, oversample=2,
        local_worker_threads=0, local_maintenance_worker_threads=0,
        device="cpu",
    )
    base.update(kw)
    return tvs.VectorIndex.create_or_open(tvs.VectorIndexConfig(**base))


def _records(prefix="vectorsearch.query"):
    return [r for r in get_registry().spans().records if r.name.startswith(prefix)]


@pytest.fixture
def sealed(rng):
    """Two sealed segments and an ACTIVE one (flat mode, the defaults),
    queried once: the codebooks are on the device."""
    reset_for_test()
    idx = make_index()
    x = gaussian(rng, 230)
    idx.add_all(x)
    run_builds(idx)
    idx.query_batch_arrays(x[:4], 5)
    yield idx, x
    idx.close()


def test_no_per_batch_span_without_a_profiler(sealed):
    idx, x = sealed
    reset_for_test()
    idx.query_batch_arrays(x[:4], 5)
    idx.query_batch(x[:4], 5)
    assert _records() == []


def test_stages_nest_inside_the_query_and_share_its_batch_id(sealed):
    idx, x = sealed
    reset_for_test()
    with profile():
        idx.query_batch_arrays(x[:4], 5)
        idx.query_batch(x[4:8], 5)
    recs = _records()
    queries = [r for r in recs if r.name == "vectorsearch.query"]
    assert len(queries) == 2 and queries[0].batch != queries[1].batch
    for q in queries:
        inner = [r for r in recs if r.batch == q.batch and r.depth == 1]
        # one stage of each kind here: one brute group, one flat call
        assert [r.name for r in inner] == STAGES
        assert q.depth == 0
        assert all(r.thread == q.thread for r in inner)
        assert all(q.start_ns <= r.start_ns <= r.end_ns <= q.end_ns for r in inner)
        # the stages follow one another
        assert all(a.end_ns <= b.start_ns for a, b in zip(inner, inner[1:]))


def test_a_thread_started_before_the_profiler_records(sealed):
    idx, x = sealed
    reset_for_test()
    go, done = threading.Event(), threading.Event()
    seen = []

    def client():
        go.wait(30)
        idx.query_batch_arrays(x[:4], 5)
        seen.append(threading.get_ident())
        done.set()

    th = threading.Thread(target=client)
    th.start()
    with profile():
        go.set()
        assert done.wait(60)
    th.join(30)
    assert not th.is_alive()
    recs = [r for r in _records() if r.name in ("vectorsearch.query", *STAGES)]
    assert {r.name for r in recs} == {"vectorsearch.query", *STAGES}
    assert {r.thread for r in recs} == set(seen)


def test_lock_waits_are_recorded_only_under_contention(sealed):
    idx, x = sealed
    idx.query_batch_arrays(x[:4], 5)
    reset_for_test()
    idx.query_batch_arrays(x[:4], 5)
    assert _records("vectorsearch.query.lock_wait") == []

    seg = next(s for s in idx.store.snapshot_segments() if s.codes_np is not None)
    for lock, name in ((idx.store.lock, "store"), (seg._dev_lock, "segment")):
        held, release = threading.Event(), threading.Event()

        def holder():
            with lock:
                held.set()
                release.wait(30)

        th = threading.Thread(target=holder)
        th.start()
        assert held.wait(30)
        threading.Timer(0.05, release.set).start()
        idx.query_batch_arrays(x[:4], 5)
        th.join(30)
        assert not th.is_alive()
        waits = [r for r in _records("vectorsearch.query.lock_wait")
                 if r.attrs == {"lock": name}]
        assert len(waits) == 1, name
        assert waits[0].end_ns - waits[0].start_ns >= 20_000_000


def test_the_query_path_records_the_syncs_it_runs(sealed, monkeypatch):
    """With the background syncer off, the query copies the writer's rows
    to the mirror itself, recorded as a query sync; a mirror that is up to
    date records none."""
    idx, x = sealed
    monkeypatch.setenv("VSTPU_NO_BG_SYNC", "1")
    idx.query_batch_arrays(x[:4], 5)
    reset_for_test()
    idx.query_batch_arrays(x[:4], 5)
    assert _records("vectorsearch.query.sync") == []
    idx.add_all(x[:3])
    idx.query_batch_arrays(x[:4], 5)
    syncs = _records("vectorsearch.query.sync")
    active = idx.store.current_segment
    assert [r.attrs for r in syncs] == [{"segment": active}]


def test_the_write_side_records_its_locked_sections(sealed):
    idx, x = sealed
    reset_for_test()
    gids = idx.add_all(x[:20])
    idx.delete_all(gids[:10])
    sid = idx.store.current_segment
    idx.maintenance.vacuum_segment(sid, 0.0)
    names = [r.name for r in get_registry().spans().records]
    for name in ("vectorsearch.store.add.locked",
                 "vectorsearch.store.delete.locked",
                 "vectorsearch.vacuum.locked"):
        assert names.count(name) == 1, name


def test_the_ring_reports_the_records_it_dropped(monkeypatch):
    monkeypatch.setattr(metrics, "SPAN_RING_SIZE", 4)
    reg = metrics.MetricsRegistry()
    for i in range(3):
        reg.add_span("a", None, 0, i, i + 1)
    log = reg.spans()
    assert log.dropped == 0 and [r.start_ns for r in log.records] == [0, 1, 2]
    for i in range(3, 10):
        reg.add_span("a", None, 0, i, i + 1)
    log = reg.spans()
    assert log.dropped == 6 and [r.start_ns for r in log.records] == [6, 7, 8, 9]
    reg.reset()
    assert reg.spans() == metrics.SpanLog([], 0)


@pytest.mark.parametrize("mode", ["graph", "exact"])
def test_seal_phases_are_recorded_once_a_seal(rng, mode):
    reset_for_test()
    kw = {} if mode == "graph" else dict(
        sealed_search_mode="exact", graph_build_mode="skip_for_flat",
        pq_build_mode="skip_for_exact")
    idx = make_index(name=mode, **kw)
    idx.add_all(gaussian(rng, 230))
    run_builds(idx)
    m = get_registry()
    phases = ["pq_train", "pq_encode", "graph_forward", "graph_reverse",
              "graph_union", "publish"] if mode == "graph" else ["publish"]
    per = {p: m.histogram_values(f"vectorsearch.build.{p}_ms") for p in phases}
    assert all(len(v) == 2 for v in per.values()), per
    total = m.histogram_values("vectorsearch.build.duration_ms")
    for i in range(2):
        assert sum(v[i] for v in per.values()) <= total[i]
    spans = [r.name for r in m.spans().records if r.name.startswith("vectorsearch.build.")]
    assert sorted(spans) == sorted(f"vectorsearch.build.{p}" for p in phases for _ in range(2))
    idx.close()


def test_a_stage_span_without_a_profiler_costs_under_half_a_microsecond():
    """Timed on the thread's CPU clock, less the loop's own cost, at the
    best of several repeats (other processes may share the host)."""
    stage, n = metrics.stage, 20_000

    def spans():
        t = time.thread_time_ns()
        for _ in range(n):
            with stage("vectorsearch.query.pool"):
                pass
        return time.thread_time_ns() - t

    def loop():
        t = time.thread_time_ns()
        for _ in range(n):
            pass
        return time.thread_time_ns() - t

    best = min(spans() for _ in range(9)) - min(loop() for _ in range(9))
    assert best / n < 500, f"{best / n:.0f} ns"


def test_a_sampled_batch_runs_the_fused_route(rng, monkeypatch):
    """Five sealed flat segments share one call on every batch, sampled or
    not; a recorded sampled batch gives each segment an equal share of the
    call's phases (0.0 for the traversal flat mode does not have)."""
    reset_for_test()
    idx = make_index(name="f", query_breakdown_sample_every=2)
    x = gaussian(rng, 520)
    idx.add_all(x)
    run_builds(idx)
    calls = []
    orig = index_mod._flat_segments_query

    def spy(q, segs, *a, **kw):
        calls.append((len(segs), kw.get("phases") is not None))
        return orig(q, segs, *a, **kw)

    monkeypatch.setattr(index_mod, "_flat_segments_query", spy)
    for _ in range(5):  # batch 0 unsampled, 2 sampled and discarded, 4 recorded
        idx.query_batch_arrays(x[:8], 5)
    assert calls == [(5, False), (5, False), (5, True), (5, False), (5, True)]
    m = get_registry()
    for name in ("pq_scan_ms", "rerank_ms"):
        vals = m.histogram_values(f"vectorsearch.query.{name}")
        assert len(vals) == 5 and len(set(vals)) == 1 and vals[0] > 0, name
    assert m.histogram_values("vectorsearch.query.graph_traversal_ms") == [0.0] * 5
    idx.close()


def test_a_sampled_batch_takes_no_device_sync(rng, monkeypatch):
    """The breakdown reads its marks once the answers are on the host: no
    call of torch.cuda.synchronize on the way (the card's check of the
    same is tests/test_torch_cuda.py's)."""
    reset_for_test()
    idx = make_index(name="n", query_breakdown_sample_every=1)
    x = gaussian(rng, 230)
    idx.add_all(x)
    run_builds(idx)
    n_sync = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: n_sync.append(1))
    for _ in range(3):
        idx.query_batch_arrays(x[:4], 5)
    assert get_registry().histogram_values("vectorsearch.query.rerank_ms")
    assert n_sync == []
    idx.close()


def test_device_marks_on_the_cpu_read_the_host_clock():
    """On the CPU a device mark is the host clock: the milliseconds from
    one mark to a later one cover the work between them, and a mark to
    itself reads 0 (the sampled breakdowns' phases take their times so)."""
    cpu = torch.device("cpu")
    a = metrics.device_mark(cpu)
    time.sleep(0.02)
    b = metrics.device_mark(cpu)
    assert isinstance(a, float) and isinstance(b, float)
    assert 19.0 <= metrics.elapsed_ms(a, b) < 10_000.0
    assert metrics.elapsed_ms(b, b) == 0.0
