"""VectorIndex: the public entry point + query engine
(reference: api/VectorIndex.java:32-200, fdb/FdbVectorIndex.java:62-1080).

Mirrors ``vectorsearch_tpu/core/index.py`` in exact and flat mode
(``sealed_search_mode="exact"`` / ``"flat"``), the slices this port serves:

- snapshot the segment registry;
- ACTIVE/PENDING segments -> brute force, one flattened product per
  capacity group (``_stacked_brute_query`` -> ops/topk.brute_force_topk);
- SEALED/COMPACTING segments, grouped by capacity:
  - exact: the exact pool over raw vectors, power-of-two subgroups
    (11 segments -> 8+2+1) each as one binned pool over the flattened
    subgroup (``_unified_exact_query``), singletons per segment
    (``_sealed_exact_query``);
  - flat: per segment, LUT -> ADC candidate pool -> exact re-rank, the
    segments of a group batched into each call (``_flat_segments_query``);
    with ``unified_search=True`` power-of-two subgroups share one ADC
    top-ef over the whole subgroup (``_unified_flat_query``);
  - graph-less segments asked for a traversal (BEAM, RANDOM_PIVOTS) are
    served from their pool, PQ-less ones from the exact pool (warn-once);
    a segment with a traversal graph asked for a traversal raises (A14);
  WRITING segments are invisible;
- merge every group by score, truncate to k, map (slot, row) to gids on the
  host.

Deletes schedule vacuums by the deleted ratio and a cooldown, and a
maintenance worker pool runs vacuum, the compaction planner and the
compaction executor (``core/maintenance.py``), as in the JAX package.

What the JAX package has and this port does not (yet): ``jit`` and the
compile-warming machinery (``wait_sync_ladder`` and the sync-ladder
warm-up, shape warming after rotations) have no counterpart, since PyTorch
runs eagerly and compiles nothing per shape; the asynchronous codebook
prefetch (codebooks load on first use; ``prefetch_codebooks_sync`` loads
them before the batch); the sampled split-phase breakdown profiling, graph
traversal, mesh and multi-device merges belong to later slices (ROADMAP.md
Queue A11-A15), as does the async facade with its QueryBatcher.
"""

from __future__ import annotations

import logging
import math
import time
from typing import Optional, Sequence

import numpy as np
import torch

from vectorsearch_torch.config import VectorIndexConfig, check_device
from vectorsearch_torch.core.build import SegmentBuildService
from vectorsearch_torch.core.caches import SegmentCaches
from vectorsearch_torch.core.maintenance import MaintenanceService
from vectorsearch_torch.core.segment import Segment
from vectorsearch_torch.core.stack import StackCache
from vectorsearch_torch.core.store import VectorStore
from vectorsearch_torch.core.tasks import (
    CompactTask,
    FindCompactionCandidatesTask,
    GlobalBuildQueueAdapter,
    GlobalMaintenanceQueueAdapter,
    MaintenanceWorkerPool,
    SegmentBuildWorkerPool,
    TaskQueue,
    VacuumTask,
)
from vectorsearch_torch.ops import distance as distance_ops
from vectorsearch_torch.ops import exact as exact_ops
from vectorsearch_torch.ops import pq as pq_ops
from vectorsearch_torch.ops import topk as topk_ops
from vectorsearch_torch.ops import traversal as traversal_ops
from vectorsearch_torch.params import Mode, SearchParams, SeedStrategy
from vectorsearch_torch.results import SearchResult
from vectorsearch_torch.types import BRUTE_FORCE_STATES, GRAPH_STATES
from vectorsearch_torch.utils.metrics import get_registry
from vectorsearch_torch.utils.metrics import span as metrics_span

LOG = logging.getLogger("vectorsearch_torch.index")

# The flat re-rank gathers [segments, Q, ef_buf, D] f32 rows at once; a
# group's segments go through it in batches that keep that block under this.
_RERANK_BLOCK_BYTES = 1 << 29

# The unified flat route's [Q, S*N] f32 ADC matrix stays under this.
_UNIFIED_APPROX_BYTES = 1 << 31


def _bucket(n: int, lo: int = 16) -> int:
    """Rounds up to a power of two (the JAX package's ef buckets)."""
    b = lo
    while b < n:
        b *= 2
    return b


def _graphless(seg) -> bool:
    """Sealed with graph_build_mode="skip_for_flat": the zero-column
    adjacency plane marks the segment as having no traversal graph."""
    return seg.adjacency_np is not None and seg.adjacency_np.shape[1] == 0


def _pqless(seg) -> bool:
    """Sealed with pq_build_mode="skip_for_exact": the zero-column codes
    plane marks the segment as having no PQ artifacts; it can only be
    served from the exact (raw-vector) pool."""
    return seg.codes_np is not None and seg.codes_np.shape[1] == 0


def _traversal_not_ported() -> NotImplementedError:
    return NotImplementedError(
        "graph traversal (BEAM mode, RANDOM_PIVOTS or sealed_search_mode="
        "'graph' against segments that carry a graph) is not ported to "
        "PyTorch yet (ROADMAP.md Queue A14)"
    )


def _pad_cols(q: torch.Tensor, d: int) -> torch.Tensor:
    """Zero-pads q's feature dim to the segments' lane-padded width (exact
    for L2 and cosine scores)."""
    if q.shape[1] < d:
        q = torch.nn.functional.pad(q, (0, d - q.shape[1]))
    return q


def _sealed_exact_pool_scored(q, vectors, valid, xn2, *, ef_buf, metric):
    """Exact-mode candidate pool WITH its rank scores:
    (scores f32[Q, ef_buf], rows i32[Q, ef_buf]), -inf / -1 in empty slots.
    Tables of ``exact.MIN_ROWS`` rows or more go through the binned pool (a
    CUDA kernel on the card: the packed one from 2,000,000 rows, since
    ``packed=None`` resolves by row count); smaller ones through one
    full-f32 score matrix and an exact top-k. Callers pass ``valid=alive``:
    an exact ranking without tombstones equals dropping them at re-rank.
    q has the index's logical width; the rows' lane-pad columns are zero,
    and the packed kernel skips them (``d_live``)."""
    d_live = q.shape[1]
    q = _pad_cols(q, vectors.shape[1])
    if exact_ops.use_fused_exact_pool(vectors.shape[0], vectors.shape[1], ef_buf):
        return exact_ops.exact_pool_scored(
            q, vectors, valid, ef_buf=ef_buf, metric=metric, xn2=xn2,
            packed=None, d_live=d_live,
        )
    scores = distance_ops.pairwise_rank_scores(q, vectors, valid, metric)
    top, idx = torch.topk(scores, ef_buf, dim=1)
    ok = top > float("-inf")
    return (
        torch.where(ok, top, float("-inf")),
        torch.where(ok, idx.to(torch.int32), -1),
    )


def _sealed_exact_query(q, seg: Segment, slot_base: int, *, ef_buf, rr, metric):
    """One sealed segment: pool + finalize + the segment-slot plane
    (``_sealed_query_slot_step`` with exact=True in the JAX package)."""
    snap = seg.device_snapshot()
    ps, pi = _sealed_exact_pool_scored(
        q, snap.vectors, snap.alive, snap.xn2, ef_buf=ef_buf, metric=metric,
    )
    sc, di, iv = traversal_ops.exact_finalize(q, ps, pi, rr, metric)
    return sc, di, iv, torch.where(iv >= 0, slot_base, -1).to(torch.int32)


def _unified_exact_query(q, stack, slot_base: int, *, ef_buf, rr, metric):
    """A subgroup of same-capacity sealed segments as ONE flattened pool:
    an exact ranking is a true ranking, so the global top pool merged once
    equals the merged per-segment pools (``_unified_sealed_query`` with
    exact=True in the JAX package). Global rows split into (slot, row)."""
    s_count, n, d = stack.vectors.shape
    ps, pi = _sealed_exact_pool_scored(
        q, stack.vectors.reshape(s_count * n, d), stack.alive.reshape(-1),
        stack.xn2.reshape(-1), ef_buf=ef_buf, metric=metric,
    )
    scores, dists, gidx = traversal_ops.exact_finalize(q, ps, pi, rr, metric)
    seg_of = torch.div(gidx, n, rounding_mode="floor")
    vid = torch.where(gidx >= 0, gidx - seg_of * n, -1)
    slot = torch.where(gidx >= 0, slot_base + seg_of, -1)
    return scores, dists, vid.to(torch.int32), slot.to(torch.int32)


def _flat_segments_query(q, segs, codebooks, slot_base: int, *, ef_dyn,
                         ef_buf, rr, metric, flat_strict):
    """Same-capacity sealed segments in flat mode, each searched on its own
    (``_sealed_query_slot_step`` with flat=True in the JAX package, once per
    segment), in batched calls: one LUT product for every codebook, one ADC
    pool per segment into one plane (the binned pool kernel at >= 16,384
    rows, the scores-scan kernel + exact top-k below), one stage-2 top-k and
    one exact re-rank. The pool covers ``exists`` (tombstones take pool
    slots and drop at re-rank, as in the JAX package); the re-rank covers
    ``alive``. Each segment's codes and flags come from one sync.
    ``flat_strict`` masks each segment's descending pool down to its
    dynamic ef (``ef_dyn``, one per segment), the reference's literal
    efSearch contract (config.flat_ef_semantics); the default keeps the full
    buffer. Returns (scores, dists, rows, slots), each [Q, S*rr'] with one
    block of columns per segment."""
    snaps = [seg.flat_snapshot() for seg in segs]
    luts = pq_ops.build_luts(q, torch.stack(codebooks))
    neg, idx = pq_ops.adc_pools_auto(
        luts, [sn.codes for sn in snaps], [sn.exists for sn in snaps],
        ef_buf=ef_buf,
    )
    ok = neg > float("-inf")
    if flat_strict:
        lim = torch.tensor(ef_dyn, device=idx.device)[:, None, None]
        ok = ok & (torch.arange(idx.shape[2], device=idx.device) < lim)
    cand = torch.where(ok, idx, -1)
    sc, di, iv = traversal_ops.exact_rerank_segments(
        q, [(sn.vectors, sn.alive) for sn in snaps], cand, rr, metric,
    )
    s_count, qn, kk = iv.shape
    slot = slot_base + torch.arange(s_count, device=iv.device, dtype=torch.int32)
    slot = torch.where(iv >= 0, slot[:, None, None], -1).to(torch.int32)
    return tuple(
        t.permute(1, 0, 2).reshape(qn, s_count * kk) for t in (sc, di, iv, slot)
    )


def _unified_flat_query(q, stack, slot_base: int, *, ef_dyn, ef_buf, rr,
                        metric, flat_strict):
    """A subgroup of same-capacity sealed segments searched as one corpus
    (``_unified_sealed_query`` with flat=True in the JAX package): one ADC
    distance scan per segment (the B5 kernel), ONE top-ef over [Q, S*N]
    with global row ids, one exact re-rank over the flattened subgroup.
    The ef is shared per query over the whole subgroup, not spent in every
    segment (config.unified_search)."""
    s_count, n, d = stack.vectors.shape
    luts = pq_ops.build_luts(q, stack.codebooks)
    approx = torch.cat([
        pq_ops.adc_scan_auto(luts[i], stack.codes[i], stack.exists[i])
        for i in range(s_count)
    ], dim=1)  # [Q, S*N]
    neg, idx = torch.topk(-approx, min(ef_buf, approx.shape[1]), dim=1)
    del approx
    ok = torch.isfinite(neg)
    if flat_strict:
        ok = ok & (torch.arange(idx.shape[1], device=idx.device)[None, :] < ef_dyn)
    cand = torch.where(ok, idx.to(torch.int32), -1)
    scores, dists, gidx = traversal_ops.exact_rerank(
        q, stack.vectors.reshape(s_count * n, d), stack.alive.reshape(-1),
        cand, rr, metric,
    )
    seg_of = torch.div(gidx, n, rounding_mode="floor")
    vid = torch.where(gidx >= 0, gidx - seg_of * n, -1)
    slot = torch.where(gidx >= 0, slot_base + seg_of, -1)
    return scores, dists, vid.to(torch.int32), slot.to(torch.int32)


def _stacked_brute_query(q, x_flat, valid_flat, slot_base, k, metric,
                         n_per_seg, xn2=None):
    """ALL brute-force segments of one capacity in one flattened product +
    top-k; flat row ids decompose into (segment slot, vector id)."""
    q = _pad_cols(q, x_flat.shape[1])
    scores, dists, idx = topk_ops.brute_force_topk(
        q, x_flat, valid_flat, k, metric, xn2
    )
    slot = torch.where(
        idx >= 0, slot_base + torch.div(idx, n_per_seg, rounding_mode="floor"), -1
    )
    vid = torch.where(idx >= 0, idx % n_per_seg, -1)
    return scores, dists, vid.to(torch.int32), slot.to(torch.int32)


def _merge_entries(entries, k):
    """Cross-segment merge of all result groups (the reference's score
    merge, fdb/FdbVectorIndex.java:432-469): one top-k on the device, then
    the four [Q, k] planes come to the host. The int planes come back as
    ints (the JAX package's f32 value-cast was a TPU fetch workaround)."""
    scores = torch.cat([e[0] for e in entries], dim=1)
    kk = min(k, scores.shape[1])
    top_s, pos = torch.topk(scores, kk, dim=1)
    planes = [top_s] + [
        torch.gather(torch.cat([e[j] for e in entries], dim=1), 1, pos)
        for j in (1, 2, 3)
    ]
    return [p.cpu().numpy() for p in planes]


class VectorIndex:
    """Use `VectorIndex.create_or_open(config)`; call `close()` when done."""

    def __init__(self, config: VectorIndexConfig):
        check_device(config.device)
        self.config = config
        self.device = config.device
        self._beam_warned = False
        self._graphless_warned = False
        self._pqless_warned = False
        self._closed = False
        self._metrics = get_registry(config.metric_attributes)

        gq = config.global_task_queue_config
        if gq is not None:
            # Global mode: producer-only adapters; NO local queues or pools
            # (reference: createOrOpenWithGlobalQueues :157-176).
            self.build_queue = GlobalBuildQueueAdapter(gq.build_queue, config.name)
            self.maintenance_queue = GlobalMaintenanceQueueAdapter(
                gq.maintenance_queue, config.name
            )
            self._owns_queues = False
        else:
            eff = config.effective
            if config.durable_task_queues:
                from vectorsearch_torch.core.tasks import DurableTaskQueue

                self.build_queue = DurableTaskQueue(
                    f"{config.name}/tasks", config.storage, config.name,
                    "build", default_ttl_s=eff.default_ttl_s,
                    default_throttle_s=eff.default_throttle_s,
                )
                self.maintenance_queue = DurableTaskQueue(
                    f"{config.name}/tasks/maint", config.storage, config.name,
                    "maint", default_ttl_s=eff.default_ttl_s,
                    default_throttle_s=eff.default_throttle_s,
                )
            else:
                self.build_queue = TaskQueue(
                    f"{config.name}/tasks", default_ttl_s=eff.default_ttl_s,
                    default_throttle_s=eff.default_throttle_s,
                )
                self.maintenance_queue = TaskQueue(
                    f"{config.name}/tasks/maint", default_ttl_s=eff.default_ttl_s,
                    default_throttle_s=eff.default_throttle_s,
                )
            self._owns_queues = True

        self.store = VectorStore(config, self.build_queue)
        self.store.create_or_open()
        self._stacks = StackCache()
        eff_w = config.effective
        self.caches = SegmentCaches(
            self.store,
            hbm_limit_bytes=eff_w.hbm_cache_limit_bytes,
            expire_after_access_s=eff_w.cache_expire_after_access_s,
            metric_attributes=config.metric_attributes,
        )
        self.build_service = SegmentBuildService(config, self.store)
        self.maintenance = MaintenanceService(
            config, self.store, self.build_service, self.maintenance_queue
        )

        self._build_pool: Optional[SegmentBuildWorkerPool] = None
        self._maint_pool: Optional[MaintenanceWorkerPool] = None
        if gq is None:
            eff = config.effective
            if eff.local_worker_threads > 0:
                self._build_pool = SegmentBuildWorkerPool(
                    self.build_queue, self.build_service
                )
                self._build_pool.start(eff.local_worker_threads)
            if eff.local_maintenance_worker_threads > 0:
                self._maint_pool = MaintenanceWorkerPool(
                    self.maintenance_queue, self.dispatch_maintenance
                )
                self._maint_pool.start(eff.local_maintenance_worker_threads)

    # ------------------------------------------------------------- lifecycle

    @classmethod
    def create_or_open(cls, config: VectorIndexConfig) -> "VectorIndex":
        return cls(config)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self._build_pool:
            self._build_pool.close()
        if self._maint_pool:
            self._maint_pool.close()
        if self._owns_queues:
            self.build_queue.close()
            self.maintenance_queue.close()
        self.store.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def checkpoint(self) -> None:
        """Full durability flush (segments + control state)."""
        self.store.checkpoint_all()

    def refresh(self) -> list[int]:
        """Synchronizes with mutations made in ANOTHER process over shared
        storage (see VectorStore.refresh). Returns changed segment ids."""
        return self.store.refresh()

    # ---------------------------------------------------------------- ingest

    def add(self, embedding, payload: Optional[bytes] = None) -> int:
        gids = self.store.add_batch(np.asarray(embedding, np.float32)[None, :],
                                    [payload])
        return gids[0]

    def add_all(self, embeddings, payloads: Optional[Sequence] = None) -> list[int]:
        return self.store.add_batch(np.asarray(embeddings, np.float32), payloads)

    # ---------------------------------------------------------------- delete

    def delete(self, gid: int) -> None:
        if not isinstance(gid, (int, np.integer)):
            raise TypeError(
                "delete() takes a single gid; use delete_all(gids) for a batch"
            )
        self.delete_all([gid])

    def delete_all(self, gids) -> None:
        if gids is None or len(gids) == 0:
            return
        affected = self.store.delete_batch(gids)
        for seg_id in set(affected):
            self._schedule_vacuum_if_needed(seg_id)

    def _schedule_vacuum_if_needed(self, seg_id: int) -> None:
        """Ratio + cooldown gate (reference: fdb/FdbVectorIndex.java:552-608)."""
        eff = self.config.effective
        with self.store.lock:
            seg = self.store.segments.get(seg_id)
            if seg is None:
                return
            live = seg.meta.count
            dead = seg.meta.deleted_count
            total = live + dead
            ratio = dead / total if total > 0 else 0.0
            if ratio < eff.vacuum_min_deleted_ratio:
                self._metrics.inc("vectorsearch.maintenance.vacuum.skipped")
                return
            now_ms = eff.clock_ms()
            if (
                eff.vacuum_cooldown_s > 0
                and seg.meta.last_vacuum_at_ms > 0
                and (now_ms - seg.meta.last_vacuum_at_ms)
                < eff.vacuum_cooldown_s * 1000.0
            ):
                self._metrics.inc("vectorsearch.maintenance.vacuum.skipped")
                return
        self.maintenance_queue.enqueue_if_not_exists(
            f"vacuum-if-needed:{seg_id}", VacuumTask(seg_id)
        )
        self._metrics.inc("vectorsearch.maintenance.vacuum.scheduled")

    # ----------------------------------------------------------- maintenance

    def request_compaction(self, seg_ids) -> None:
        """Idempotent, order-invariant enqueue
        (reference: fdb/FdbVectorIndex.java:531-543)."""
        ids = sorted(int(s) for s in seg_ids)
        self.maintenance_queue.enqueue_if_not_exists(
            f"compact:{ids}", CompactTask(tuple(ids))
        )

    def dispatch_maintenance(self, task) -> None:
        """Maintenance task dispatcher (reference:
        tasks/MaintenanceWorker.java:62-95). Spans mirror the reference's
        vectorsearch.vacuum / .compaction (tasks/MaintenanceWorker.java:67-105)."""
        if isinstance(task, VacuumTask):
            with metrics_span("vectorsearch.vacuum", {"segment": task.seg_id}):
                self.maintenance.vacuum_segment(task.seg_id, task.min_deleted_ratio)
        elif isinstance(task, FindCompactionCandidatesTask):
            max_cc = self.config.effective.max_concurrent_compactions
            if max_cc <= 0:
                return  # compaction disabled
            if self.maintenance.count_in_flight_compactions() >= max_cc:
                return  # throttled (reference :106-110)
            ids = self.maintenance.find_compaction_candidates(task.anchor_seg_id)
            if not ids:
                return
            if not self.maintenance.mark_candidates_compacting(ids):
                return
            self.request_compaction(ids)
        elif isinstance(task, CompactTask):
            with metrics_span(
                "vectorsearch.compaction", {"segments": str(list(task.seg_ids))}
            ):
                self.maintenance.compact_segments(list(task.seg_ids))
        else:
            raise ValueError(f"unknown maintenance task: {task!r}")

    def await_indexing_complete(self, timeout: Optional[float] = None) -> bool:
        if (
            timeout is None
            and self._build_pool is None
            and self.config.global_task_queue_config is None
            and self.build_queue.has_visible_unclaimed_tasks()
        ):
            LOG.warning(
                "await_indexing_complete() called with localWorkerThreads=0 "
                "and no global task queue: nothing in this process will "
                "claim build tasks; this call blocks until an external "
                "worker drains the queue"
            )
        return self.build_queue.await_queue_empty(timeout)

    # ------------------------------------------------------------ inspection

    def get_codebook_cache_size(self) -> int:
        return self.caches.codebook_cache_size()

    def get_adjacency_cache_size(self) -> int:
        return self.caches.adjacency_cache_size()

    def resolve_ids(self, gids) -> list[tuple[int, int]]:
        return [self.store.resolve_gid(g) for g in gids]

    def resolve_payloads(self, gids) -> list:
        """Payloads by gid; None for absent payloads, unknown or deleted gids."""
        out = []
        with self.store.lock:
            for g in gids:
                if g is None or int(g) < 0:
                    out.append(None)
                    continue
                sid, vid = self.store.resolve_gid(int(g))
                seg = self.store.segments.get(sid) if sid >= 0 else None
                out.append(
                    seg.payloads[vid]
                    if seg is not None and 0 <= vid < seg.cap_pad else None
                )
        return out

    # ----------------------------------------------------------------- query

    def query(self, q, k: int, params: Optional[SearchParams] = None) -> list[SearchResult]:
        return self.query_batch(np.asarray(q, np.float32)[None, :], k, params)[0]

    def query_batch(
        self, qs, k: int, params: Optional[SearchParams] = None
    ) -> list[list[SearchResult]]:
        # OTel span parity: vectorsearch.query (fdb/FdbVectorIndex.java:359)
        with metrics_span("vectorsearch.query"):
            return self._query_batch(qs, k, params)

    def query_batch_arrays(
        self, qs, k: int, params: Optional[SearchParams] = None
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Batch API: (gids i64[Q, k], scores f32[Q, k], distances f32[Q, k]);
        empty slots carry gid=-1 / -inf / inf. Skips per-result Python
        object construction."""
        with metrics_span("vectorsearch.query"):
            return self._query_batch(qs, k, params, as_arrays=True)

    def _query_batch(
        self, qs, k: int, params: Optional[SearchParams] = None,
        as_arrays: bool = False,
    ):
        t0 = time.monotonic()
        self.store.note_query()  # gates the background syncer's eager mode
        if isinstance(qs, torch.Tensor):
            # device-resident fast path: no numpy round trip
            qs = qs.to(self.device, torch.float32)
        else:
            qs = np.asarray(qs, np.float32)
        if qs.ndim != 2 or qs.shape[1] != self.config.dimension:
            raise ValueError(
                f"query dimension mismatch: expected {self.config.dimension}"
            )
        if params is None:
            params = SearchParams.defaults(k, self.config.oversample)
        if params.mode == Mode.BEAM and not self._beam_warned:
            self._beam_warned = True
            LOG.warning(
                "SearchParams.Mode.BEAM is deprecated; prefer BEST_FIRST "
                "(this warning is logged once)"
            )

        segments = self.store.snapshot_segments()
        if self.config.segment_shard is not None:
            # cluster serving: this process owns only seg_id % n == shard
            shard, n_shards = self.config.segment_shard
            segments = [s for s in segments if s.meta.segment_id % n_shards == shard]
        per_seg_limit = max(k, k * max(1, self.config.oversample))
        nq = qs.shape[0]
        # Pad the device batch to a power-of-two bucket of query_batch_pad
        # (as the JAX package does, so both run the same shapes); pad rows
        # are zero queries, dropped right after the merge.
        nq_dev = self._query_pad_bucket(nq)
        qd = torch.as_tensor(qs, device=self.device)
        if nq_dev != nq:
            qd = torch.nn.functional.pad(qd, (0, 0, 0, nq_dev - nq))

        brute_segs: list[Segment] = []
        sealed_segs: list[Segment] = []
        for seg in segments:
            if seg.state in BRUTE_FORCE_STATES:
                if seg.next_row > 0:
                    brute_segs.append(seg)
            elif seg.state in GRAPH_STATES:
                if seg.codes_np is None:
                    # SEALED without artifacts (shouldn't happen): brute force
                    if seg.next_row > 0:
                        brute_segs.append(seg)
                elif int(np.count_nonzero(seg.exists_np[: seg.next_row])) > 0:
                    sealed_segs.append(seg)
            # WRITING: invisible (reference :646-649)
        self.caches.touch(brute_segs + sealed_segs)

        metric = self.config.metric
        seg_list: list[Segment] = []  # global slot -> Segment
        entries: list[tuple] = []  # (scores, dists, vids, slots) device tensors

        # --- brute-force segments: one flattened product per capacity ---
        groups: dict[int, list[Segment]] = {}
        for seg in brute_segs:
            groups.setdefault(seg.cap_pad, []).append(seg)
        for cap, group in groups.items():
            stack = self._stacks.brute(group)
            base = len(seg_list)
            seg_list.extend(group)
            entries.append(
                _stacked_brute_query(
                    qd, stack.vectors, stack.alive, base,
                    k=min(per_seg_limit, cap * len(group)),
                    metric=metric, n_per_seg=cap, xn2=stack.xn2,
                )
            )

        # --- sealed segments: per capacity group ---
        # Flat and exact are BEST_FIRST pools; BEAM and RANDOM_PIVOTS are
        # traversal concepts, served from the pools only for graph-less
        # segments (the JAX package traverses segments that have a graph).
        mode_cfg = self.config.sealed_search_mode
        flat = mode_cfg == "flat" and params.mode == Mode.BEST_FIRST
        exact = mode_cfg == "exact" and params.mode == Mode.BEST_FIRST
        flat_strict = self.config.flat_ef_semantics == "strict"
        use_stacked = params.seed_strategy != SeedStrategy.RANDOM_PIVOTS
        if (
            self.config.effective.prefetch_codebooks_enabled
            and self.config.effective.prefetch_codebooks_sync
            and sealed_segs
        ):
            # reference :377-416; without sync, codebooks load on first use
            self.caches.prefetch_codebooks(sealed_segs)
        sgroups: dict[int, list[Segment]] = {}
        for seg in sealed_segs:
            sgroups.setdefault(seg.cap_pad, []).append(seg)
        for cap, group in sgroups.items():
            # graph-less segments: a traversal request falls back to the
            # pool (never worse: the flat pool dominates a traversal pool at
            # equal ef); PQ-less segments only have the exact pool
            gflat, gexact = flat, exact
            if not (gflat or gexact) and any(_graphless(seg) for seg in group):
                self._warn_graphless_once()
                if mode_cfg == "exact":
                    gexact = True
                else:
                    gflat = True
            if not gexact and any(_pqless(seg) for seg in group):
                self._warn_pqless_once()
                gflat, gexact = False, True
            if not use_stacked:
                for seg in group:
                    res = self._search_sealed(qd, seg, k, per_seg_limit, params)
                    if res is None:
                        continue
                    base = len(seg_list)
                    seg_list.append(seg)
                    sc, di, iv = res
                    entries.append(
                        (sc, di, iv, torch.where(iv >= 0, base, -1).to(torch.int32))
                    )
                continue
            if not (gflat or gexact):
                raise _traversal_not_ported()
            if gexact:
                # the pool covers k plus bin-collision slack (4k), not
                # efSearch: there is no lossy scan to make up for, and
                # tombstones are masked out of the ranking
                ef_buf = min(_bucket(max(4 * k, 32)), cap)
            else:
                tuned_max = max(self._auto_tune(seg, k, params)[0] for seg in group)
                ef_buf = min(_bucket(max(tuned_max, k)), cap)
            # The unified flat route builds one [Q, S*N] f32 ADC matrix, so
            # it is bounded by bytes; the exact route builds none (its pool
            # never materializes the score matrix), so it takes power-of-two
            # subgroups at every size. The JAX package applies the bound to
            # both (ROADMAP.md Queue C).
            approx_bytes = len(group) * nq_dev * cap * 4
            if len(group) > 1 and (
                gexact
                or (self.config.unified_search
                    and approx_bytes <= _UNIFIED_APPROX_BYTES)
            ):
                # power-of-two subgroups (11 segments -> 8+2+1); singletons
                # fall through to the per-segment path
                rest: list = []
                todo = list(group)
                while todo:
                    size = 1
                    while size * 2 <= len(todo):
                        size *= 2
                    sub, todo = todo[:size], todo[size:]
                    if len(sub) == 1:
                        rest.extend(sub)
                        continue
                    stack = self._stacks.sealed(sub, pq=gflat)
                    base = len(seg_list)
                    seg_list.extend(sub)
                    if gexact:
                        u_ef_buf = min(_bucket(max(4 * k, 32)), len(sub) * cap)
                        entries.append(
                            _unified_exact_query(
                                qd, stack, base, ef_buf=u_ef_buf,
                                rr=min(per_seg_limit * len(sub), u_ef_buf),
                                metric=metric,
                            )
                        )
                        continue
                    total_codes = sum(seg.exists_count() for seg in sub)
                    u_ef, _u_beam = self._auto_tune_n(total_codes, k, params)
                    u_ef_buf = min(_bucket(max(u_ef, k)), len(sub) * cap)
                    entries.append(
                        _unified_flat_query(
                            qd, stack, base, ef_dyn=u_ef, ef_buf=u_ef_buf,
                            rr=min(per_seg_limit * len(sub), u_ef_buf),
                            metric=metric, flat_strict=flat_strict,
                        )
                    )
                group = rest
            rr = min(per_seg_limit, ef_buf)
            if gexact:
                for seg in group:
                    base = len(seg_list)
                    seg_list.append(seg)
                    entries.append(
                        _sealed_exact_query(
                            qd, seg, base, ef_buf=ef_buf, rr=rr, metric=metric,
                        )
                    )
                continue
            if not group:
                continue
            # flat, per segment: batches of segments share each call, as
            # many as keep the re-rank's gathered block under its budget
            per_call = max(1, _RERANK_BLOCK_BYTES // max(
                1, nq_dev * ef_buf * group[0].d_pad * 4))
            for i in range(0, len(group), per_call):
                chunk = group[i : i + per_call]
                base = len(seg_list)
                seg_list.extend(chunk)
                entries.append(
                    _flat_segments_query(
                        qd, chunk, [self.caches.get_codebook(s) for s in chunk],
                        base,
                        ef_dyn=[self._auto_tune(s, k, params)[0] for s in chunk],
                        ef_buf=ef_buf, rr=rr, metric=metric,
                        flat_strict=flat_strict,
                    )
                )

        results: list[list[SearchResult]] = [[] for _ in range(nq)]
        if entries:
            top_s, top_d, vid_of, slot_of = _merge_entries(entries, k)
            top_s, top_d = top_s[:nq], top_d[:nq]  # drop the pad rows
            vid_of, slot_of = vid_of[:nq], slot_of[:nq]

            gid_of = np.full(slot_of.shape, -1, np.int64)
            for si, seg in enumerate(seg_list):
                mask = (slot_of == si) & (vid_of >= 0)
                if mask.any():
                    gid_of[mask] = seg.gids_np[vid_of[mask]]

            valid = (slot_of >= 0) & (vid_of >= 0) & (gid_of >= 0) & np.isfinite(top_s)
            if as_arrays:
                kk = top_s.shape[1]
                gids_a = np.full((nq, k), -1, np.int64)
                scores_a = np.full((nq, k), -np.inf, np.float32)
                dists_a = np.full((nq, k), np.inf, np.float32)
                take = min(k, kk)
                gids_a[:, :take] = np.where(valid, gid_of, -1)[:, :take]
                scores_a[:, :take] = np.where(valid, top_s, -np.inf)[:, :take]
                dists_a[:, :take] = np.where(valid, top_d, np.inf)[:, :take]
                self._record_query(t0, nq, len(brute_segs) + len(sealed_segs),
                                   float(np.mean(np.sum(gids_a >= 0, axis=1))))
                return gids_a, scores_a, dists_a
            results = self._build_results(
                gid_of, top_s, top_d, slot_of, vid_of, valid, seg_list, nq
            )

        self._record_query(
            t0, nq, len(brute_segs) + len(sealed_segs),
            float(np.mean([len(r) for r in results])) if results else 0.0,
        )
        if as_arrays:  # no entries: nothing searchable
            return (
                np.full((nq, k), -1, np.int64),
                np.full((nq, k), -np.inf, np.float32),
                np.full((nq, k), np.inf, np.float32),
            )
        return results

    def _record_query(self, t0, nq, n_segments, returned) -> None:
        """The reference's query instruments (same names as the JAX package)."""
        self._metrics.inc("vectorsearch.query.count", nq)
        self._metrics.record(
            "vectorsearch.query.duration_ms", (time.monotonic() - t0) * 1000.0
        )
        self._metrics.record("vectorsearch.query.segments_searched", n_segments)
        self._metrics.record("vectorsearch.query.results_returned", returned)
        self.caches.enforce_budget()

    @staticmethod
    def _build_results(gid_of, top_s, top_d, slot_of, vid_of, valid, seg_list, nq):
        """SearchResult lists, through the C result builder when it loads
        (native/resultbuilder.c), else a Python loop over .tolist() planes."""
        from vectorsearch_torch.native import load_result_builder

        builder = load_result_builder()
        if builder is not None:
            try:
                return builder(
                    SearchResult,
                    np.ascontiguousarray(gid_of, np.int64),
                    np.ascontiguousarray(top_s, np.float32),
                    np.ascontiguousarray(top_d, np.float32),
                    np.ascontiguousarray(slot_of, np.int32),
                    np.ascontiguousarray(vid_of, np.int32),
                    np.ascontiguousarray(valid, np.uint8),
                    [
                        seg.payloads if isinstance(seg.payloads, list)
                        else seg.payloads.c_planes()
                        for seg in seg_list
                    ],
                    nq, valid.shape[1],
                )
            except (TypeError, ValueError):
                pass  # shape/dtype mismatch: use the Python loop
        valid_l = valid.tolist()
        gid_l = gid_of.tolist()
        s_l = top_s.tolist()
        d_l = top_d.tolist()
        slot_l = slot_of.tolist()
        vid_l = vid_of.tolist()
        return [
            [
                SearchResult(g, s, dd, seg_list[sl].payloads[vv])
                for ok, g, s, dd, sl, vv in zip(
                    valid_l[qi], gid_l[qi], s_l[qi], d_l[qi],
                    slot_l[qi], vid_l[qi],
                )
                if ok
            ]
            for qi in range(nq)
        ]

    # -- auto-tune (verbatim formulas, reference :772-784) --------------------

    def _auto_tune(self, seg: Segment, k: int, params: SearchParams) -> tuple[int, int]:
        """Returns (tuned_ef, tuned_beam) for a sealed segment."""
        return self._auto_tune_n(seg.exists_count(), k, params)

    def _auto_tune_n(self, n_codes: int, k: int, params: SearchParams) -> tuple[int, int]:
        base_ef = max(params.ef_search, k * max(1, params.per_segment_limit_multiplier))
        scale = int(max(1, round(math.sqrt(max(1, n_codes) / 1000.0))))
        tuned_ef = min(params.max_explore, max(base_ef, min(n_codes, base_ef * scale)))
        tuned_beam = max(
            1,
            min(n_codes, max(params.beam_width, min(64, math.ceil(math.sqrt(n_codes))))),
        )
        return tuned_ef, tuned_beam

    # -- sealed path, RANDOM_PIVOTS against graph-less segments ---------------

    def _warn_graphless_once(self) -> None:
        if not self._graphless_warned:
            self._graphless_warned = True
            LOG.warning(
                "traversal-mode query against segments sealed with "
                "graphBuildMode='skip_for_flat' (no adjacency); falling back "
                "to the flat pool (this warning is logged once)"
            )

    def _warn_pqless_once(self) -> None:
        if not self._pqless_warned:
            self._pqless_warned = True
            LOG.warning(
                "PQ-scanning query mode against segments sealed with "
                "pqBuildMode='skip_for_exact' (no codes); serving them from "
                "the exact raw-vector pool (this warning is logged once)"
            )

    def _search_sealed(self, qd, seg: Segment, k: int, limit: int,
                       params: SearchParams):
        """One sealed segment under RANDOM_PIVOTS (reference :730-837). A
        graph-less segment is served from its pool instead (the JAX
        package's ``_search_sealed`` graph-less branch): the exact pool in
        exact mode or for a PQ-less segment, else the flat pool. Returns
        (scores, dists, rows) or None for a segment with no rows."""
        if seg.exists_count() == 0:
            return None
        if not _graphless(seg):
            raise _traversal_not_ported()
        self._warn_graphless_once()
        metric = self.config.metric
        if self.config.sealed_search_mode == "exact" or _pqless(seg):
            ef_buf = min(_bucket(max(4 * k, 32)), seg.cap_pad)
            sc, di, iv, _slots = _sealed_exact_query(
                qd, seg, 0, ef_buf=ef_buf, rr=min(limit, ef_buf), metric=metric,
            )
            return sc, di, iv
        tuned_ef, _tb = self._auto_tune(seg, k, params)
        ef_buf = min(_bucket(max(tuned_ef, k)), seg.cap_pad)
        sc, di, iv, _slots = _flat_segments_query(
            qd, [seg], [self.caches.get_codebook(seg)], 0, ef_dyn=[tuned_ef],
            ef_buf=ef_buf, rr=min(limit, ef_buf), metric=metric,
            flat_strict=self.config.flat_ef_semantics == "strict",
        )
        return sc, di, iv

    def _query_pad_bucket(self, nq: int) -> int:
        """config.query_batch_pad doubled until it covers nq; <= 1 disables."""
        p = self.config.query_batch_pad
        if p <= 1:
            return nq
        b = p
        while b < nq:
            b *= 2
        return b
