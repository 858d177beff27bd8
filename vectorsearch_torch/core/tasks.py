"""Own copy of ``vectorsearch_tpu/core/tasks.py`` for the PyTorch port (which imports nothing
of the JAX package); behaviour and on-disk formats are unchanged.

Host-side task system: queues, workers, pools, and the global runner.

Re-implements the semantics of the reference's FDB-backed distributed task
queue (io.github.panghy:taskqueue, used at fdb/FdbVectorIndex.java:187-218 and
tasks/SegmentBuildWorker.java:39-55) as a thread-safe in-process scheduler:

- `enqueue_if_not_exists(key, payload)`: idempotent by key — a pending or
  claimed task with the same key suppresses re-enqueue.
- `await_and_claim(timeout)`: blocking claim with a TTL lease; an expired
  lease makes the task claimable again (crash recovery, SURVEY.md §5.3).
- `Claim.complete()` / `Claim.fail()`: fail requeues for retry.
- `await_queue_empty()`: no visible or claimed tasks remain.

Worker pools mirror tasks/SegmentBuildWorkerPool.java:17-73 and
tasks/MaintenanceWorkerPool.java:24-71: N claim-loop threads, errors swallowed
(fail -> retry), close() wakes blocked claimants with per-thread sentinel tasks.

The GlobalWorkerRunner (tasks/GlobalWorkerRunner.java:50-431) consumes shared
cross-index queues whose payloads carry an index name; it lazily reconstructs
each index's config from its persisted IndexMeta plus a WorkerConfig template.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
import uuid
from typing import Any, Callable, Dict, Optional

LOG = logging.getLogger("vectorsearch_torch.tasks")


# ---------------------------------------------------------------------------
# Task payloads (reference: vectorsearch.proto:161-218)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BuildTask:
    seg_id: int  # < 0 => shutdown sentinel


@dataclasses.dataclass(frozen=True)
class VacuumTask:
    seg_id: int  # < 0 => shutdown sentinel
    min_deleted_ratio: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class CompactTask:
    seg_ids: tuple


@dataclasses.dataclass(frozen=True)
class FindCompactionCandidatesTask:
    anchor_seg_id: int = -1


@dataclasses.dataclass(frozen=True)
class GlobalBuildTask:
    index_path: str
    task: BuildTask


@dataclasses.dataclass(frozen=True)
class GlobalMaintenanceTask:
    index_path: str
    task: Any  # VacuumTask | CompactTask | FindCompactionCandidatesTask


# ---------------------------------------------------------------------------
# Queue
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Task:
    key: str
    payload: Any
    attempts: int = 0
    visible_at: float = 0.0  # retry throttle (reference: defaultThrottle)


class Claim:
    """A claimed task with a TTL lease (reference taskqueue claim protocol)."""

    def __init__(self, queue: "TaskQueue", task: _Task, claim_id: str):
        self._queue = queue
        self._task = task
        self._claim_id = claim_id
        self._done = False

    @property
    def payload(self) -> Any:
        return self._task.payload

    @property
    def key(self) -> str:
        return self._task.key

    @property
    def attempts(self) -> int:
        return self._task.attempts

    def complete(self) -> None:
        self._queue._finish(self._claim_id, requeue=False)
        self._done = True

    def fail(self) -> None:
        self._queue._finish(self._claim_id, requeue=True)
        self._done = True


class TaskQueue:
    def __init__(self, name: str = "queue", default_ttl_s: float = 300.0,
                 default_throttle_s: float = 1.0,
                 clock: Callable[[], float] = time.monotonic):
        self.name = name
        self.default_ttl_s = default_ttl_s
        self.default_throttle_s = default_throttle_s
        self._clock = clock
        self._cond = threading.Condition(threading.RLock())
        self._pending: list[_Task] = []
        self._keys: set[str] = set()  # keys pending or claimed (for idempotence)
        self._claimed: Dict[str, tuple[_Task, float]] = {}  # claim_id -> (task, deadline)
        self._closed = False

    # -- producer side -----------------------------------------------------

    def enqueue_if_not_exists(self, key: str, payload: Any) -> bool:
        """Idempotent enqueue; returns True if the task was added."""
        with self._cond:
            if key in self._keys:
                return False
            self._keys.add(key)
            self._pending.append(_Task(key=key, payload=payload))
            self._cond.notify()
            return True

    def enqueue(self, payload: Any) -> str:
        """Non-idempotent enqueue with a random key (sentinels use this)."""
        key = f"{self.name}:{uuid.uuid4()}"
        with self._cond:
            self._keys.add(key)
            self._pending.append(_Task(key=key, payload=payload))
            self._cond.notify()
            return key

    # -- consumer side ------------------------------------------------------

    def _reap_expired(self) -> None:
        now = self._clock()
        expired = [cid for cid, (_, dl) in self._claimed.items() if dl <= now]
        for cid in expired:
            task, _ = self._claimed.pop(cid)
            task.attempts += 1
            self._pending.append(task)
            LOG.warning("queue %s: lease expired for %s; requeued", self.name, task.key)

    def await_and_claim(self, timeout: Optional[float] = None,
                        ttl_s: Optional[float] = None) -> Optional[Claim]:
        """Blocks until a task is claimable; returns None on timeout/close.

        The wall deadline uses real time even when a fake clock is injected —
        the injected clock only drives lease/throttle semantics."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while True:
                self._reap_expired()
                now = self._clock()
                ready = next((i for i, t in enumerate(self._pending) if t.visible_at <= now), None)
                if ready is not None:
                    task = self._pending.pop(ready)
                    cid = str(uuid.uuid4())
                    lease = ttl_s if ttl_s is not None else self.default_ttl_s
                    self._claimed[cid] = (task, self._clock() + lease)
                    return Claim(self, task, cid)
                if self._closed:
                    return None
                wait = 0.05
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return None
                    wait = min(wait, remaining)
                self._cond.wait(wait)

    def _finish(self, claim_id: str, requeue: bool) -> None:
        with self._cond:
            entry = self._claimed.pop(claim_id, None)
            if entry is None:
                return
            task, _ = entry
            if requeue:
                task.attempts += 1
                task.visible_at = self._clock() + self.default_throttle_s
                self._pending.append(task)
            else:
                self._keys.discard(task.key)
            self._cond.notify_all()

    # -- inspection ----------------------------------------------------------

    def has_visible_unclaimed_tasks(self) -> bool:
        with self._cond:
            self._reap_expired()
            now = self._clock()
            return any(t.visible_at <= now for t in self._pending)

    def has_claimed_tasks(self) -> bool:
        with self._cond:
            return bool(self._claimed)

    def await_queue_empty(self, timeout: Optional[float] = None) -> bool:
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while True:
                self._reap_expired()
                if not self._pending and not self._claimed:
                    return True
                wait = 0.05
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return False
                    wait = min(wait, remaining)
                self._cond.wait(wait)

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()


# ---------------------------------------------------------------------------
# Payload (de)serialization (the analogue of tasks/ProtoSerializers.java:15-119)
# ---------------------------------------------------------------------------

_TASK_TYPES = {
    "build": BuildTask,
    "vacuum": VacuumTask,
    "compact": CompactTask,
    "find_candidates": FindCompactionCandidatesTask,
}


def task_payload_to_json(payload: Any) -> dict:
    """Serializes any task payload to a JSON-safe dict."""
    if isinstance(payload, GlobalBuildTask):
        return {"t": "global_build", "index_path": payload.index_path,
                "task": task_payload_to_json(payload.task)}
    if isinstance(payload, GlobalMaintenanceTask):
        return {"t": "global_maint", "index_path": payload.index_path,
                "task": task_payload_to_json(payload.task)}
    for tag, cls in _TASK_TYPES.items():
        if isinstance(payload, cls):
            d = dataclasses.asdict(payload)
            if "seg_ids" in d:
                d["seg_ids"] = list(d["seg_ids"])
            return {"t": tag, **d}
    raise ValueError(f"unserializable task payload: {payload!r}")


def task_payload_from_json(d: dict) -> Any:
    t = d.get("t")
    if t == "global_build":
        return GlobalBuildTask(d["index_path"], task_payload_from_json(d["task"]))
    if t == "global_maint":
        return GlobalMaintenanceTask(d["index_path"], task_payload_from_json(d["task"]))
    cls = _TASK_TYPES.get(t)
    if cls is None:
        raise ValueError(f"unknown task tag: {t!r}")
    kw = {k: v for k, v in d.items() if k != "t"}
    if "seg_ids" in kw:
        kw["seg_ids"] = tuple(kw["seg_ids"])
    return cls(**kw)


class DurableTaskQueue(TaskQueue):
    """TaskQueue journaled through IndexStorage — the analogue of the
    reference's FDB-backed taskqueue (SURVEY.md §5.3): pending tasks,
    attempt counts, and retry throttles survive process restarts; tasks that
    were CLAIMED at crash time are restored as claimable with attempts+1
    (the dead worker's lease is treated as expired).

    The journal is a small JSON blob rewritten on every mutation — task
    rates are background-level (builds, vacuums, compactions), not hot-path.
    Shutdown sentinels (random-key `enqueue`) are intentionally NOT
    journaled: they are addressed to live worker threads of this process.
    """

    def __init__(self, name: str, storage, index_name: str, qname: str, **kw):
        super().__init__(name, **kw)
        self._storage = storage
        self._index_name = index_name
        self._qname = qname
        self._ephemeral: set[str] = set()  # keys from enqueue(): process-local
        state = storage.read_queue(index_name, qname)
        if state:
            now = self._clock()
            for rec in state.get("tasks", []):
                task = _Task(
                    key=rec["key"],
                    payload=task_payload_from_json(rec["payload"]),
                    attempts=rec.get("attempts", 0) + (1 if rec.get("claimed") else 0),
                    visible_at=now + max(0.0, rec.get("visible_in", 0.0)),
                )
                self._pending.append(task)
                self._keys.add(task.key)

    def _journal_locked(self) -> None:
        now = self._clock()
        tasks = []
        for t, claimed in (
            [(t, False) for t in self._pending]
            + [(t, True) for t, _dl in self._claimed.values()]
        ):
            if t.key in self._ephemeral:
                continue  # shutdown sentinels are process-local; don't journal
            try:
                pj = task_payload_to_json(t.payload)
            except ValueError:
                continue
            tasks.append({
                "key": t.key, "payload": pj, "attempts": t.attempts,
                "visible_in": max(0.0, t.visible_at - now) if not claimed else 0.0,
                "claimed": claimed,
            })
        self._storage.write_queue(self._index_name, self._qname, {"tasks": tasks})

    def enqueue_if_not_exists(self, key: str, payload: Any) -> bool:
        with self._cond:
            if key in self._keys:
                return False
            self._keys.add(key)
            self._pending.append(_Task(key=key, payload=payload))
            self._journal_locked()
            self._cond.notify()
            return True

    def enqueue(self, payload: Any) -> str:
        # one lock scope: the ephemeral mark must land before any concurrent
        # claimant journals the queue
        key = f"{self.name}:{uuid.uuid4()}"
        with self._cond:
            self._ephemeral.add(key)
            self._keys.add(key)
            self._pending.append(_Task(key=key, payload=payload))
            self._cond.notify()
        return key

    def await_and_claim(self, timeout=None, ttl_s=None):
        claim = super().await_and_claim(timeout=timeout, ttl_s=ttl_s)
        if claim is not None:
            with self._cond:
                self._journal_locked()
        return claim

    def _finish(self, claim_id: str, requeue: bool) -> None:
        with self._cond:
            super()._finish(claim_id, requeue)
            self._journal_locked()


class _SharedClaim:
    """Claim handle for SharedTaskQueue (same interface as Claim)."""

    def __init__(self, queue: "SharedTaskQueue", key: str, payload: Any,
                 attempts: int, claim_id: str):
        self._queue = queue
        self.key = key
        self.payload = payload
        self.attempts = attempts
        self._claim_id = claim_id

    def complete(self) -> None:
        self._queue._finish_shared(self._claim_id, requeue=False)

    def fail(self) -> None:
        self._queue._finish_shared(self._claim_id, requeue=True)


class SharedTaskQueue:
    """CROSS-PROCESS task queue over shared storage — the closest analogue of
    the reference's FDB-backed taskqueue (SURVEY.md §5.3): every operation is
    a read-modify-write of the storage journal under `storage.queue_lock`
    (fcntl.flock for DiskStorage), so any number of producer and worker
    PROCESSES can share one queue. Leases use wall-clock time (the shared
    clock across processes); expired leases make tasks re-claimable with
    attempts+1.

    Claims BLOCK on the storage wake channel (persist.QueueWake — a POSIX
    FIFO for DiskStorage, a Condition for MemoryStorage), the analogue of
    the reference blocking on FDB watches (tasks/SegmentBuildWorker.java:
    42-53): idle waiters cost zero journal reads; every journal mutation
    notifies. The only timed wakeups are EXACT edges computed from the
    journal itself (the soonest future visible_at / lease_deadline — events
    with no producer to notify) plus a safety resync (missed-notify bound:
    a notifier crashing between write and notify).

    Shutdown sentinels (random-key `enqueue`) stay process-local: they are
    addressed to THIS process's worker threads, never to other processes.
    """

    _RESYNC_S = 5.0  # safety poll bound; wake channel makes real latency ~ms

    def __init__(self, name: str, storage, index_name: str, qname: str,
                 default_ttl_s: float = 300.0, default_throttle_s: float = 1.0):
        self.name = name
        self._storage = storage
        self._index_name = index_name
        self._qname = qname
        self.default_ttl_s = default_ttl_s
        self.default_throttle_s = default_throttle_s
        self._wake = storage.queue_wake(index_name, qname)
        self._local = TaskQueue(f"{name}/local")  # sentinels only
        self._closed = False

    # -- journal helpers (call under storage.queue_lock) ---------------------

    def _read(self) -> list[dict]:
        state = self._storage.read_queue(self._index_name, self._qname)
        return list(state.get("tasks", [])) if state else []

    def _write(self, tasks: list[dict]) -> None:
        self._storage.write_queue(self._index_name, self._qname, {"tasks": tasks})

    @staticmethod
    def _claimable(rec: dict, now: float) -> bool:
        if rec.get("visible_at", 0.0) > now:
            return False
        return rec.get("lease_deadline", 0.0) <= now  # unclaimed or expired

    # -- producer -------------------------------------------------------------

    def enqueue_if_not_exists(self, key: str, payload: Any) -> bool:
        with self._storage.queue_lock(self._index_name, self._qname):
            tasks = self._read()
            if any(r["key"] == key for r in tasks):
                return False
            tasks.append({
                "key": key, "payload": task_payload_to_json(payload),
                "attempts": 0, "visible_at": 0.0, "lease_deadline": 0.0,
                "claim_id": None,
            })
            self._write(tasks)
        self._wake.notify()
        return True

    def enqueue(self, payload: Any) -> str:
        cid = self._local.enqueue(payload)  # sentinels: process-local
        self._wake.notify()  # a waiter may be blocked on the shared channel
        return cid

    # -- consumer -------------------------------------------------------------

    def await_and_claim(self, timeout: Optional[float] = None,
                        ttl_s: Optional[float] = None) -> Optional[Any]:
        deadline = None if timeout is None else time.monotonic() + timeout
        lease = ttl_s if ttl_s is not None else self.default_ttl_s
        while True:
            local = self._local.await_and_claim(timeout=0)
            if local is not None:
                return local
            next_edge_s = self._RESYNC_S
            with self._storage.queue_lock(self._index_name, self._qname):
                tasks = self._read()
                now = time.time()
                for rec in tasks:
                    if self._claimable(rec, now):
                        if rec.get("lease_deadline", 0.0) > 0.0:
                            rec["attempts"] = rec.get("attempts", 0) + 1
                        cid = str(uuid.uuid4())
                        rec["claim_id"] = cid
                        rec["lease_deadline"] = now + lease
                        self._write(tasks)
                        return _SharedClaim(
                            self, rec["key"],
                            task_payload_from_json(rec["payload"]),
                            rec["attempts"], cid,
                        )
                # nothing claimable: the next TIMED event is the soonest
                # future visible_at (throttle) or lease_deadline (expiry) —
                # neither has a live producer to notify the channel
                for rec in tasks:
                    for edge in (rec.get("visible_at", 0.0),
                                 rec.get("lease_deadline", 0.0)):
                        if edge > now:
                            next_edge_s = min(next_edge_s, edge - now)
            if self._closed:
                return None
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return None
                next_edge_s = min(next_edge_s, remaining)
            self._wake.wait(next_edge_s)

    def _finish_shared(self, claim_id: str, requeue: bool) -> None:
        with self._storage.queue_lock(self._index_name, self._qname):
            tasks = self._read()
            out = []
            now = time.time()
            for rec in tasks:
                if rec.get("claim_id") == claim_id:
                    if requeue:
                        rec["attempts"] = rec.get("attempts", 0) + 1
                        rec["visible_at"] = now + self.default_throttle_s
                        rec["lease_deadline"] = 0.0
                        rec["claim_id"] = None
                        out.append(rec)
                    # else: completed — drop
                else:
                    out.append(rec)
            self._write(out)
        # completion unblocks await_queue_empty; requeue (after throttle)
        # unblocks claimers — their edge-wait handles the visible_at delay
        self._wake.notify()

    # -- inspection -----------------------------------------------------------

    def has_visible_unclaimed_tasks(self) -> bool:
        with self._storage.queue_lock(self._index_name, self._qname):
            now = time.time()
            return any(self._claimable(r, now) for r in self._read())

    def has_claimed_tasks(self) -> bool:
        with self._storage.queue_lock(self._index_name, self._qname):
            now = time.time()
            return any(r.get("lease_deadline", 0.0) > now for r in self._read())

    def await_queue_empty(self, timeout: Optional[float] = None) -> bool:
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            with self._storage.queue_lock(self._index_name, self._qname):
                if not self._read():
                    return True
            wait_s = self._RESYNC_S
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                wait_s = min(wait_s, remaining)
            self._wake.wait(wait_s)

    def close(self) -> None:
        self._closed = True
        self._local.close()
        self._wake.notify()  # unblock waiters so they observe _closed


# ---------------------------------------------------------------------------
# Queue adapters for global (cross-index) routing
# (reference: tasks/GlobalBuildQueueAdapter.java:31-131,
#  tasks/GlobalMaintenanceQueueAdapter.java:27-123)
# ---------------------------------------------------------------------------


class GlobalBuildQueueAdapter:
    """Producer-only shim: wraps payloads with the index path and prefixes keys
    with "<path>:" before delegating to the shared global queue."""

    def __init__(self, global_queue: TaskQueue, index_path: str):
        self._q = global_queue
        self._path = index_path

    def enqueue_if_not_exists(self, key: str, payload: BuildTask) -> bool:
        return self._q.enqueue_if_not_exists(
            f"{self._path}:{key}", GlobalBuildTask(self._path, payload)
        )

    def await_queue_empty(self, timeout=None) -> bool:
        # Delegates globally: drains ALL indices' tasks (reference :123-131).
        return self._q.await_queue_empty(timeout)

    def has_visible_unclaimed_tasks(self):
        return self._q.has_visible_unclaimed_tasks()

    def has_claimed_tasks(self):
        return self._q.has_claimed_tasks()

    # consumer/inspection methods are unsupported on adapters (reference :89-122)
    def await_and_claim(self, *a, **kw):
        raise NotImplementedError("producer-only adapter")


class GlobalMaintenanceQueueAdapter:
    def __init__(self, global_queue: TaskQueue, index_path: str):
        self._q = global_queue
        self._path = index_path

    def enqueue_if_not_exists(self, key: str, payload: Any) -> bool:
        return self._q.enqueue_if_not_exists(
            f"{self._path}:{key}", GlobalMaintenanceTask(self._path, payload)
        )

    def await_queue_empty(self, timeout=None) -> bool:
        return self._q.await_queue_empty(timeout)

    def has_visible_unclaimed_tasks(self):
        return self._q.has_visible_unclaimed_tasks()

    def has_claimed_tasks(self):
        return self._q.has_claimed_tasks()

    def await_and_claim(self, *a, **kw):
        raise NotImplementedError("producer-only adapter")


# ---------------------------------------------------------------------------
# Worker pools
# ---------------------------------------------------------------------------


class _WorkerPool:
    """N claim-loop threads; close() enqueues per-thread sentinels to wake
    blocked claimants (reference: tasks/SegmentBuildWorkerPool.java:38-72)."""

    def __init__(self, queue: TaskQueue, handler: Callable[[Any], None],
                 is_sentinel: Callable[[Any], bool], make_sentinel: Callable[[], Any],
                 name: str = "worker"):
        self._queue = queue
        self._handler = handler
        self._is_sentinel = is_sentinel
        self._make_sentinel = make_sentinel
        self._name = name
        self._threads: list[threading.Thread] = []
        self._stop = threading.Event()

    def start(self, n: int) -> None:
        for i in range(n):
            t = threading.Thread(target=self._loop, name=f"{self._name}-{i}", daemon=True)
            t.start()
            self._threads.append(t)

    def run_once(self, timeout: float = 1.0) -> bool:
        """Claims and processes one task; returns False if none/sentinel."""
        claim = self._queue.await_and_claim(timeout=timeout)
        if claim is None:
            return False
        if self._is_sentinel(claim.payload):
            claim.complete()
            return False
        try:
            self._handler(claim.payload)
            claim.complete()
        except Exception:
            LOG.exception("%s: task %s failed; will retry", self._name, claim.key)
            claim.fail()
        return True

    def _loop(self) -> None:
        while not self._stop.is_set():
            claim = self._queue.await_and_claim(timeout=0.5)
            if claim is None:
                continue
            if self._is_sentinel(claim.payload):
                claim.complete()
                return  # sentinel: exit this worker thread
            try:
                self._handler(claim.payload)
                claim.complete()
            except Exception:
                # errors swallowed; task requeued for retry (reference :48-50)
                LOG.exception("%s: task %s failed; will retry", self._name, claim.key)
                claim.fail()

    def close(self) -> None:
        self._stop.set()
        for _ in self._threads:
            self._queue.enqueue(self._make_sentinel())
        for t in self._threads:
            t.join(timeout=10.0)
        self._threads.clear()

    @property
    def active_threads(self) -> int:
        return sum(1 for t in self._threads if t.is_alive())


class SegmentBuildWorkerPool(_WorkerPool):
    """Consumes BuildTask(seg_id); sentinel is seg_id < 0
    (reference: tasks/SegmentBuildWorker.java:39-55)."""

    def __init__(self, queue: TaskQueue, build_service):
        super().__init__(
            queue,
            handler=lambda p: build_service.build(p.seg_id),
            is_sentinel=lambda p: isinstance(p, BuildTask) and p.seg_id < 0,
            make_sentinel=lambda: BuildTask(seg_id=-1),
            name="segment-build",
        )


class MaintenanceWorkerPool(_WorkerPool):
    """Dispatches Vacuum/Compact/FindCandidates (reference:
    tasks/MaintenanceWorker.java:62-95); sentinel is VacuumTask(seg_id=-1)."""

    def __init__(self, queue: TaskQueue, dispatcher: Callable[[Any], None]):
        super().__init__(
            queue,
            handler=dispatcher,
            is_sentinel=lambda p: isinstance(p, VacuumTask) and p.seg_id < 0,
            make_sentinel=lambda: VacuumTask(seg_id=-1),
            name="maintenance",
        )


# ---------------------------------------------------------------------------
# Global worker runner
# ---------------------------------------------------------------------------


class GlobalWorkerRunner:
    """Standalone multi-index worker process analogue
    (reference: tasks/GlobalWorkerRunner.java:50-431).

    Consumes GlobalBuildTask / GlobalMaintenanceTask from shared queues; per
    task it resolves the target index by name, reconstructing config from the
    persisted IndexMeta (data params) + the WorkerConfig template (operational
    params), with zero local workers. Malformed tasks fail their claim.
    ``device`` is where the runner's indexes live (not persisted; with no
    card the default raises when a task opens its index).
    """

    def __init__(self, storage, worker_config, build_queue: TaskQueue,
                 maintenance_queue: TaskQueue, *, device="cuda"):
        self._storage = storage
        self._worker_config = worker_config
        self._device = device
        self._build_queue = build_queue
        self._maint_queue = maintenance_queue
        self._indexes: Dict[str, Any] = {}  # cached runtimes per index path
        self._lock = threading.RLock()
        self._build_pool: Optional[_WorkerPool] = None
        self._maint_pool: Optional[_WorkerPool] = None

    def _resolve_index(self, index_path: str):
        from vectorsearch_torch.config import VectorIndexConfig
        from vectorsearch_torch.core.index import VectorIndex
        from vectorsearch_torch.types import IndexMeta

        with self._lock:
            rt = self._indexes.get(index_path)
            if rt is not None:
                return rt
            meta_json = self._storage.read_meta(index_path)
            if meta_json is None:
                raise ValueError(f"invalid task: unknown index path {index_path!r}")
            meta = IndexMeta.from_json(meta_json)
            cfg = VectorIndexConfig.from_index_meta(
                meta, self._storage, index_path, self._worker_config,
                device=self._device,
            )
            # Follow-up tasks must stay on the global queues (reference :224-242).
            from vectorsearch_torch.config import GlobalTaskQueueConfig

            cfg = cfg.replace(
                global_task_queue_config=GlobalTaskQueueConfig(
                    build_queue=self._build_queue, maintenance_queue=self._maint_queue
                )
            )
            rt = VectorIndex.create_or_open(cfg)
            self._indexes[index_path] = rt
            return rt

    def _handle_build(self, payload: GlobalBuildTask) -> None:
        if not isinstance(payload, GlobalBuildTask) or not payload.index_path:
            raise ValueError(f"invalid global build task: {payload!r}")
        idx = self._resolve_index(payload.index_path)
        idx.build_service.build(payload.task.seg_id)

    def _handle_maintenance(self, payload: GlobalMaintenanceTask) -> None:
        if not isinstance(payload, GlobalMaintenanceTask) or not payload.index_path:
            raise ValueError(f"invalid global maintenance task: {payload!r}")
        idx = self._resolve_index(payload.index_path)
        idx.dispatch_maintenance(payload.task)

    def start(self, build_threads: int = 1, maintenance_threads: int = 1) -> None:
        self._build_pool = _WorkerPool(
            self._build_queue,
            handler=self._handle_build,
            is_sentinel=lambda p: isinstance(p, GlobalBuildTask) and p.task.seg_id < 0,
            make_sentinel=lambda: GlobalBuildTask("", BuildTask(-1)),
            name="global-build",
        )
        self._maint_pool = _WorkerPool(
            self._maint_queue,
            handler=self._handle_maintenance,
            is_sentinel=lambda p: (
                isinstance(p, GlobalMaintenanceTask)
                and isinstance(p.task, VacuumTask)
                and p.task.seg_id < 0
            ),
            make_sentinel=lambda: GlobalMaintenanceTask("", VacuumTask(-1)),
            name="global-maintenance",
        )
        self._build_pool.start(build_threads)
        self._maint_pool.start(maintenance_threads)

    def run_once_build(self, timeout: float = 1.0) -> bool:
        """Processes one build task synchronously (for tests)."""
        claim = self._build_queue.await_and_claim(timeout=timeout)
        if claim is None:
            return False
        try:
            self._handle_build(claim.payload)
            claim.complete()
            return True
        except Exception:
            LOG.exception("global build task failed")
            claim.fail()
            return False

    def run_once_maintenance(self, timeout: float = 1.0) -> bool:
        claim = self._maint_queue.await_and_claim(timeout=timeout)
        if claim is None:
            return False
        try:
            self._handle_maintenance(claim.payload)
            claim.complete()
            return True
        except Exception:
            LOG.exception("global maintenance task failed")
            claim.fail()
            return False

    def close(self) -> None:
        if self._build_pool:
            self._build_pool.close()
        if self._maint_pool:
            self._maint_pool.close()
        with self._lock:
            for rt in self._indexes.values():
                rt.close()
            self._indexes.clear()
