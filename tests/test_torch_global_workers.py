"""The port's global (cross-index) workers (vectorsearch_torch/core/tasks.py
``GlobalWorkerRunner``, config reconstruction in
``VectorIndexConfig.from_index_meta``) on the CPU: the cases of
tests/test_global_workers.py that build through the runner, with the
runner's ``device`` argument, plus the seal it makes.

A worker reconstructs each index's config from its persisted IndexMeta. Both
packages take their defaults there (flat mode, PQ and a graph at seal):
worker seals carry PQ codes with ``pq_m`` columns and a graph, so the serving
index answers them through the flat (ADC) route, never from the exact pool.
Producers here are flat indexes with ``graph_build_mode="skip_for_flat"``;
what the worker seals follows its own reconstructed config.
"""

import numpy as np
import pytest

import vectorsearch_tpu as jvs
from vectorsearch_torch.config import (
    GlobalTaskQueueConfig,
    VectorIndexConfig,
    WorkerConfig,
)
from vectorsearch_torch.core.index import VectorIndex
from vectorsearch_torch.core.persist import MemoryStorage
from vectorsearch_torch.core.tasks import (
    BuildTask,
    GlobalBuildTask,
    GlobalWorkerRunner,
    SharedTaskQueue,
    TaskQueue,
)
from vectorsearch_torch.ops import adc as ta
from vectorsearch_torch.ops import exact as te
from vectorsearch_torch.types import IndexMeta, SegmentState

FLAT = dict(sealed_search_mode="flat", graph_build_mode="skip_for_flat",
            pq_build_mode="always")


@pytest.fixture
def storage():
    return MemoryStorage()


def _config(storage, name, gq, **kw):
    base = dict(storage=storage, name=name, dimension=8, max_segment_size=10,
                pq_m=4, pq_k=16, graph_degree=8, graph_build_breadth=32,
                global_task_queue_config=gq, device="cpu", **FLAT)
    base.update(kw)
    return VectorIndexConfig(**base)


def make_global_setup(storage):
    bq = TaskQueue("global-build", default_throttle_s=0.05)
    mq = TaskQueue("global-maint", default_throttle_s=0.05)
    gq = GlobalTaskQueueConfig(build_queue=bq, maintenance_queue=mq)

    def mk(name, **kw):
        return VectorIndex.create_or_open(_config(storage, name, gq, **kw))

    return bq, mq, mk


def _runner(storage, worker, bq, mq):
    return GlobalWorkerRunner(storage, worker, bq, mq, device="cpu")


def test_global_mode_skips_local_pools(storage):
    bq, mq, mk = make_global_setup(storage)
    idx = mk("g/one")
    assert idx._build_pool is None
    assert idx._maint_pool is None
    idx.close()


def test_two_indices_share_queues_and_worker_builds_both(storage, rng):
    bq, mq, mk = make_global_setup(storage)
    a = mk("g/a")
    b = mk("g/b")
    a.add_all(rng.normal(size=(15, 8)).astype(np.float32))  # rotates seg0
    b.add_all(rng.normal(size=(12, 8)).astype(np.float32))
    a.checkpoint()
    b.checkpoint()
    assert bq.has_visible_unclaimed_tasks()

    worker = WorkerConfig(default_graph_build_breadth=32, default_graph_alpha=1.2)
    runner = _runner(storage, worker, bq, mq)
    # process tasks synchronously (no threads, deterministic)
    while runner.run_once_build(timeout=0.2):
        pass

    # the runner reconstructed configs from persisted IndexMeta and sealed
    # both indices' pending segments in ITS OWN runtimes, with PQ codes
    ra = runner._indexes["g/a"]
    rb = runner._indexes["g/b"]
    for rt in (ra, rb):
        seg = rt.store.segments[0]
        assert seg.state == SegmentState.SEALED
        assert seg.codes_np is not None and seg.codes_np.shape[1] == 4
    # reconstructed config matches persisted data-format params
    assert ra.config.dimension == 8 and ra.config.pq_m == 4
    assert ra.config.effective.local_worker_threads == 0
    assert ra.config.device.type == "cpu"
    runner.close()
    a.close()
    b.close()


def test_malformed_global_task_fails_claim(storage):
    bq, mq, mk = make_global_setup(storage)
    bq.enqueue_if_not_exists("bogus", GlobalBuildTask("no/such/index", BuildTask(0)))
    runner = _runner(storage, WorkerConfig(), bq, mq)
    assert not runner.run_once_build(timeout=0.5)  # fails gracefully
    # task requeued for retry (throttled)
    assert not bq.await_queue_empty(timeout=0.01)
    runner.close()


def test_runner_threads_and_sentinel_shutdown(storage, rng):
    bq, mq, mk = make_global_setup(storage)
    a = mk("g/thr")
    a.add_all(rng.normal(size=(12, 8)).astype(np.float32))
    a.checkpoint()
    runner = _runner(storage, WorkerConfig(), bq, mq)
    runner.start(build_threads=1, maintenance_threads=1)
    assert a.await_indexing_complete(timeout=180)  # adapter delegates globally
    runner.close()
    a.close()


def test_worker_config_matches_jax_less_the_graph(storage, rng):
    """The same IndexMeta and worker template through both packages'
    from_index_meta: equal data and operational params and modes (the JAX
    package's defaults: flat, PQ and a graph at seal); the device is the
    caller's. A worker seal carries the graph."""
    meta = IndexMeta(name="m", dimension=8, metric="COSINE",
                     max_segment_size=300, pq_m=4, pq_k=16, graph_degree=8,
                     oversample=2)
    fields = ("dimension", "metric", "max_segment_size", "pq_m", "pq_k",
              "graph_degree", "oversample", "graph_build_breadth",
              "graph_alpha", "sealed_search_mode", "pq_build_mode",
              "graph_build_mode")
    jcfg = jvs.VectorIndexConfig.from_index_meta(
        jvs.IndexMeta.from_json(meta.to_json()), jvs.MemoryStorage(), "m",
        jvs.WorkerConfig(default_graph_build_breadth=40, default_graph_alpha=1.3),
    )
    tcfg = VectorIndexConfig.from_index_meta(
        meta, storage, "m",
        WorkerConfig(default_graph_build_breadth=40, default_graph_alpha=1.3),
        device="cpu",
    )
    assert {f: getattr(tcfg, f) for f in fields} == {
        f: getattr(jcfg, f) for f in fields}
    assert (tcfg.sealed_search_mode, tcfg.pq_build_mode,
            tcfg.graph_build_mode) == ("flat", "always", "always")
    assert tcfg.device.type == "cpu"
    assert tcfg.effective.local_worker_threads == 0

    bq, mq, mk = make_global_setup(storage)
    producer = mk("g/w", max_segment_size=300)
    producer.add_all(rng.normal(size=(320, 8)).astype(np.float32))
    producer.checkpoint()
    runner = _runner(storage, WorkerConfig(), bq, mq)
    assert runner.run_once_build(timeout=0.2)
    seg = runner._indexes["g/w"].store.segments[0]
    assert seg.state == SegmentState.SEALED
    assert seg.codes_np.shape == (seg.cap_pad, 4)
    assert seg.adjacency_np.shape == (seg.cap_pad, 8)
    assert (seg.adjacency_np[:300] >= 0).any(axis=1).all()
    runner.close()
    producer.close()


def test_worker_seals_flat_index_with_pq_and_serves_it_flat(storage, monkeypatch):
    """A flat index sealed by a global worker: its segments carry PQ codes
    with pq_m columns (rows, 4), and the serving index answers them through
    the ADC route, never the exact pool."""
    bq, mq, mk = make_global_setup(storage)
    producer = mk("g/flat", max_segment_size=300)
    x = np.random.default_rng(0).normal(size=(650, 8)).astype(np.float32)
    gids = producer.add_all(x)
    producer.checkpoint()
    runner = _runner(storage, WorkerConfig(), bq, mq)
    built = 0
    while runner.run_once_build(timeout=0.2):
        built += 1
    assert built == 2
    sealed = [s for s in runner._indexes["g/flat"].store.snapshot_segments()
              if s.state == SegmentState.SEALED]
    assert len(sealed) == 2
    for seg in sealed:
        assert seg.codes_np.shape == (seg.cap_pad, 4)
    runner.close()

    assert producer.refresh() == [0, 1]
    calls = []
    for mod, name in ((ta, "adc_pool_plain"), (ta, "adc_scores_plain"),
                      (te, "exact_pool_plain"), (te, "exact_pool_packed_plain")):
        orig = getattr(mod, name)

        def spy(*a, _orig=orig, _name=name, **kw):
            calls.append(_name)
            return _orig(*a, **kw)

        monkeypatch.setattr(mod, name, spy)
    with producer.store.lock:
        for sid in (0, 1):
            seg = producer.store.segments[sid]
            assert seg.state == SegmentState.SEALED
            assert seg.codes_np.shape[1] == 4
    got, _scores, _dists = producer.query_batch_arrays(x[:4], 5)
    assert "adc_scores_plain" in calls or "adc_pool_plain" in calls
    assert "exact_pool_plain" not in calls
    assert "exact_pool_packed_plain" not in calls
    assert list(got[:, 0]) == list(gids[:4])
    producer.close()


def test_runner_without_a_device_argument_wants_the_card(storage, rng):
    """No hidden fallback: the runner's default device is the card, so on a
    host without one opening the task's index fails the claim."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device opens")
    bq, mq, mk = make_global_setup(storage)
    a = mk("g/dev")
    a.add_all(rng.normal(size=(15, 8)).astype(np.float32))
    a.checkpoint()
    runner = GlobalWorkerRunner(storage, WorkerConfig(), bq, mq)
    assert not runner.run_once_build(timeout=0.5)
    assert runner._indexes == {}
    runner.close()
    a.close()


# ---------------------------------------------------------------------------
# Shared queues over one storage (in process): SharedTaskQueue + refresh()
# ---------------------------------------------------------------------------


def make_shared_setup(storage):
    bq = SharedTaskQueue("gb", storage, "_global", "build",
                         default_throttle_s=0.05)
    mq = SharedTaskQueue("gm", storage, "_global", "maint",
                         default_throttle_s=0.05)
    return bq, mq, GlobalTaskQueueConfig(build_queue=bq, maintenance_queue=mq)


def test_shared_queue_basic_semantics(storage):
    import time as _t

    q = SharedTaskQueue("q", storage, "_global", "build")
    assert q.enqueue_if_not_exists("k", BuildTask(1))
    assert not q.enqueue_if_not_exists("k", BuildTask(1))
    # a SECOND handle over the same storage sees and claims the task
    q2 = SharedTaskQueue("q2", storage, "_global", "build")
    c = q2.await_and_claim(timeout=1)
    assert c is not None and c.payload == BuildTask(1)
    # claimed: invisible to others until lease expiry
    assert q.await_and_claim(timeout=0.1) is None
    c.fail()  # requeue with throttle
    _t.sleep(0.1)
    c2 = q.await_and_claim(timeout=1)
    assert c2 is not None and c2.attempts >= 1
    c2.complete()
    assert q.await_queue_empty(timeout=1)


def test_shared_queue_lease_expiry(storage):
    import time as _t

    q = SharedTaskQueue("q", storage, "_global", "build", default_ttl_s=0.1)
    q.enqueue_if_not_exists("k", BuildTask(5))
    c = q.await_and_claim(timeout=1)  # claim then "crash" (no complete)
    assert c is not None
    _t.sleep(0.15)  # lease expires
    c2 = q.await_and_claim(timeout=1)
    assert c2 is not None and c2.payload == BuildTask(5)
    assert c2.attempts == 1


def test_shared_queue_worker_builds_and_refresh_picks_up(storage, rng):
    """Producer index + a SEPARATE GlobalWorkerRunner (a fresh runtime over
    the same storage and shared queues). The producer sees the sealed
    segment, with its PQ codes, after refresh() and serves queries from it."""
    bq, mq, gq = make_shared_setup(storage)
    producer = VectorIndex.create_or_open(_config(storage, "xp", gq))
    x = rng.normal(size=(15, 8)).astype(np.float32)
    gids = producer.add_all(x)  # rotation -> 1 build task on the shared queue
    with producer.store.lock:
        assert producer.store.segments[0].state == SegmentState.PENDING

    worker = _runner(storage, WorkerConfig(), bq, mq)
    assert worker.run_once_build(timeout=2)
    worker.close()

    assert producer.refresh() == [0]
    with producer.store.lock:
        assert producer.store.segments[0].state == SegmentState.SEALED
        assert producer.store.segments[0].codes_np.shape[1] == 4
    res = producer.query(x[3], 5)
    assert gids[3] in [r.gid for r in res]
    # idempotent: nothing further to refresh
    assert producer.refresh() == []
    producer.close()


def test_shared_queue_wake_memory_no_polling(storage):
    """An idle claimer over MemoryStorage reads the journal only on real
    events (Condition wake channel), and a late enqueue unblocks it fast."""
    import threading
    import time as _t

    q = SharedTaskQueue("q", storage, "_global", "build")
    reads = [0]
    orig = storage.read_queue

    def counting_read(name, qname):
        reads[0] += 1
        return orig(name, qname)

    storage.read_queue = counting_read
    got = {}

    def waiter():
        c = q.await_and_claim(timeout=5)
        got["t"] = _t.monotonic()
        got["claim"] = c

    th = threading.Thread(target=waiter)
    th.start()
    _t.sleep(0.5)  # idle window: a 50 ms poller would do ~10 reads
    reads_idle = reads[0]
    t_enq = _t.monotonic()
    q.enqueue_if_not_exists("k", BuildTask(3))
    th.join(timeout=5)
    assert got["claim"] is not None and got["claim"].payload == BuildTask(3)
    assert got["t"] - t_enq < 0.2, "wake latency should be ~ms, not a poll tick"
    assert reads_idle <= 3, f"idle claimer polled the journal {reads_idle}x"
    got["claim"].complete()
    q.close()
