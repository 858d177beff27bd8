"""Segment caches: codebook + adjacency device-residency tracking with stats
(reference: cache/SegmentCaches.java:33-271).

Own copy of ``vectorsearch_tpu/core/caches.py`` for the PyTorch port: the
codebook loader and gauges of the flat path, the device-residency budget and
LRU eviction. The adjacency loader belongs to the traversal slice (ROADMAP.md
Queue A14): no sealed segment's graph goes to the device yet, so its gauge
reads 0.

The reference caches decoded codebooks and adjacency rows loaded from FDB. In
the TPU design those artifacts live in each sealed segment's device bundle, so
the "cache" is device memory residency: a get materializes the host array onto the
device on miss, and eviction frees device memory. Hit/miss/load gauges keep the
reference's metric names ({cache=codebook|adjacency}).

device memory budget: the reference bounds its caches (codebooks: 10-min
expireAfterAccess; adjacency: 100k entries, cache/SegmentCaches.java:39-128).
Here the bound is a byte budget over segment device bundles
(config.hbm_cache_limit_bytes) plus the same expire-after-access window
(config.cache_expire_after_access_s): `enforce_budget` evicts
least-recently-queried bundles until under budget. Host numpy stays
authoritative, so an evicted segment re-uploads transparently on next access.
The ACTIVE segment is exempt (its incremental device sync would thrash).
"""

from __future__ import annotations

import threading
import time

from vectorsearch_torch.types import SegmentState
from vectorsearch_torch.utils.metrics import get_registry


class SegmentCaches:
    def __init__(self, store, hbm_limit_bytes: int = 0,
                 expire_after_access_s: float = 0.0,
                 metric_attributes: dict | None = None):
        self.store = store
        self.hbm_limit_bytes = hbm_limit_bytes
        self.expire_after_access_s = expire_after_access_s
        self._lock = threading.Lock()
        self._last_access: dict[int, float] = {}  # seg_id -> monotonic
        self._metrics = get_registry(metric_attributes)

    # ---------------------------------------------------------------- codebook

    def get_codebook(self, seg):
        """Device codebook for a sealed segment (loads on miss)."""
        attrs = {"cache": "codebook"}
        with seg._dev_lock:
            resident = seg._codebook_dev is not None
        if resident:
            self._metrics.inc("vectorsearch.cache.hit", attrs=attrs)
        else:
            self._metrics.inc("vectorsearch.cache.miss", attrs=attrs)
        cb = seg.codebook_dev
        if cb is None:
            self._metrics.inc("vectorsearch.cache.load_failure", attrs=attrs)
        elif not resident:
            self._metrics.inc("vectorsearch.cache.load_success", attrs=attrs)
        return cb

    def prefetch_codebooks(self, segments) -> None:
        """Warms codebooks for sealed segments (reference:
        fdb/FdbVectorIndex.java:377-416 codebook prefetch)."""
        for seg in segments:
            if seg.codebook_np is not None:
                self.get_codebook(seg)

    def codebook_cache_size(self) -> int:
        with self.store.lock:
            segs = list(self.store.segments.values())
        n = 0
        for seg in segs:
            with seg._dev_lock:
                if seg._codebook_dev is not None:
                    n += 1
        return n

    # --------------------------------------------------------------- adjacency

    def adjacency_cache_size(self) -> int:
        return 0

    # ---------------------------------------------------------------- eviction

    def evict_segment(self, seg) -> None:
        """Frees a segment's device bundle (device memory pressure relief)."""
        seg.invalidate_device()
        with self._lock:
            self._last_access.pop(seg.seg_id, None)

    def touch(self, segments) -> None:
        """Marks segments as just-accessed (call per query batch)."""
        now = time.monotonic()
        with self._lock:
            for seg in segments:
                self._last_access[seg.seg_id] = now

    def resident_bytes(self) -> int:
        with self.store.lock:
            segs = list(self.store.segments.values())
        return sum(seg.device_resident_bytes() for seg in segs)

    def enforce_budget(self) -> list[int]:
        """Evicts expired then least-recently-accessed device bundles until
        the device memory budget is met; emits the vectorsearch.cache.size gauges
        (reference: cache/SegmentCaches.java:210-270). Returns evicted ids."""
        with self.store.lock:
            segs = {s.seg_id: s for s in self.store.segments.values()}
            active = {
                sid for sid, s in segs.items() if s.state == SegmentState.ACTIVE
            }
        now = time.monotonic()
        with self._lock:
            last = dict(self._last_access)
        sizes = {sid: seg.device_resident_bytes() for sid, seg in segs.items()}
        total = sum(sizes.values())
        evicted: list[int] = []

        def _evict(sid: int) -> None:
            nonlocal total
            self.evict_segment(segs[sid])
            total -= sizes.pop(sid, 0)
            evicted.append(sid)

        if self.expire_after_access_s > 0:
            for sid in list(sizes):
                if sid in active or sizes[sid] == 0:
                    continue
                at = last.get(sid)
                if at is not None and (now - at) > self.expire_after_access_s:
                    _evict(sid)
        if self.hbm_limit_bytes > 0 and total > self.hbm_limit_bytes:
            # LRU order; never-touched bundles (e.g. loaded by a build) first
            order = sorted(
                (sid for sid in sizes if sid not in active and sizes[sid] > 0),
                key=lambda sid: last.get(sid, 0.0),
            )
            for sid in order:
                if total <= self.hbm_limit_bytes:
                    break
                _evict(sid)

        self._metrics.record(
            "vectorsearch.cache.size", self.codebook_cache_size(),
            attrs={"cache": "codebook"},
        )
        self._metrics.record(
            "vectorsearch.cache.size", self.adjacency_cache_size(),
            attrs={"cache": "adjacency"},
        )
        self._metrics.record("vectorsearch.cache.hbm_bytes", total)
        return evicted
