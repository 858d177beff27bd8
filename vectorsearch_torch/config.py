"""Index configuration: two-tier split of data-format vs operational parameters.

Own copy of ``vectorsearch_tpu/config.py`` for the PyTorch port. Differences:
``device`` takes a torch device and defaults to ``"cuda"`` (opening an index
with no CUDA device raises unless the caller asks for ``device="cpu"``), and
the modes this port does not serve yet (``mesh``, ``device_placement=
"round_robin"``) raise ``NotImplementedError`` naming the ROADMAP.md item
that will port them. The defaults are those of the JAX package (flat mode,
PQ and a graph built at seal).

Mirrors the reference's config system (config/VectorIndexConfig.java:18-710,
config/WorkerConfig.java:22-455, config/GlobalTaskQueueConfig.java:18-48):

- **Data-format params** (dimension, metric, max_segment_size, pq_m, pq_k,
  graph_degree, oversample, graph_build_breadth, graph_alpha) are persisted in
  IndexMeta and immutable — reopening with a mismatch raises.
- **Operational params** (worker threads, TTLs, batch sizes, compaction weights,
  chunk limits, cache sizes) live only in process config / WorkerConfig and may
  differ per process.
- Per-call search tuning is the third tier (params.SearchParams).

TPU-specific additions live at the end of VectorIndexConfig (device/mesh
placement, PQ training iterations/seed, query batching) — these are operational.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional


class Metric:
    """Distance metric (reference: config/VectorIndexConfig.java Metric enum)."""

    L2 = "L2"
    COSINE = "COSINE"

    _ALL = (L2, COSINE)

    @staticmethod
    def validate(m: str) -> str:
        if m not in Metric._ALL:
            raise ValueError(f"metric must be one of {Metric._ALL}, got {m!r}")
        return m


def _system_clock_ms() -> int:
    return int(time.time() * 1000)


def check_device(device) -> "torch.device":
    """The device an index opens on. A CUDA device that is not there is an
    error: the port never drops silently to the CPU — callers that want the
    CPU ask for it with device="cpu"."""
    import torch

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"VectorIndexConfig.device={str(device)!r} but no CUDA device is "
            "available; pass device='cpu' to run on the CPU"
        )
    return device


@dataclasses.dataclass(frozen=True)
class WorkerConfig:
    """Operational-only settings, shared by indices and global workers
    (reference: config/WorkerConfig.java:22-129).

    Also carries data-format *fallback defaults* used by global workers when a
    persisted IndexMeta has 0-valued fields (reference: WorkerConfig.java:282-289).
    """

    local_worker_threads: int = 0
    local_maintenance_worker_threads: int = 0
    max_concurrent_compactions: int = 1
    vacuum_cooldown_s: float = 0.0
    vacuum_min_deleted_ratio: float = 0.25
    default_ttl_s: float = 300.0
    default_throttle_s: float = 1.0
    clock_ms: Callable[[], int] = _system_clock_ms  # injectable InstantSource analogue
    prefetch_codebooks_enabled: bool = True
    prefetch_codebooks_sync: bool = False  # sync blocks the query on codebook
    #   residency; async (default) warms on the executor (core/index.py)
    auto_find_compaction_candidates: bool = True
    compaction_min_segments: int = 2
    compaction_max_segments: int = 8
    compaction_min_fragmentation: float = 0.1
    compaction_age_bias_weight: float = 0.3
    compaction_size_bias_weight: float = 0.5
    compaction_frag_bias_weight: float = 0.2
    # Knobs the reference needs that the TPU design makes moot — REMOVED
    # rather than carried as validated-but-unread fields (VERDICT r3 #5):
    # estimatedWorkerCount (FDB task-claim spreading; local pools + the
    # global queue's lease TTLs cover it), buildTxnLimitBytes/SoftRatio/
    # SizeCheckEvery (FDB 10 MB txn budget; builds persist via single-file
    # atomic renames with no txn ceiling), codebook/adjacencyBatchLoadSize
    # (FDB range-read batching; device uploads are one put per plane).
    # HBM residency budget over segment device bundles (the TPU analogue of
    # the reference's Caffeine cache bounds: 10-min expireAfterAccess on
    # codebooks + 100k-entry adjacency cap, cache/SegmentCaches.java:39-128).
    # 0 = unbounded. The ACTIVE segment is exempt (it is being written).
    hbm_cache_limit_bytes: int = 0
    cache_expire_after_access_s: float = 600.0  # 0 = never expire
    # Hot-path breakdown sampling: every Nth query batch is dispatched as
    # split phase programs (ADC scan / traversal / rerank) with a device sync
    # between phases, so pq_scan_ms / graph_traversal_ms / rerank_ms are real
    # measurements (reference records these per sealed query on its host-side
    # async chain, fdb/FdbVectorIndex.java:99-116; here the phases fuse into
    # ONE XLA program, so always-on splitting would forfeit the fusion —
    # sampling keeps overhead at ~1/N). Batch 0 is always sampled; 0 = off.
    query_breakdown_sample_every: int = 64
    # Cross-process writer lease: mutating processes heartbeat a TTL lease in
    # storage; vacuum/compaction REFUSES to run while a live lease from
    # another process exists (gid remaps under a concurrent foreign writer
    # would corrupt resolution — the reference gets this safety from FDB
    # transactions, tasks/MaintenanceService.java:326-386). 0 disables.
    writer_lease_ttl_ms: int = 10_000
    # Single-writer enforcement (VERDICT r2 #3): what add/delete do when
    # ANOTHER process holds a live writer lease. "raise" fails fast with
    # ConcurrentWriterError (route writes to the lease holder, e.g. via the
    # cluster layer's write forwarding); "wait" blocks until the foreign
    # lease expires or is released (up to writer_conflict_wait_timeout_s,
    # then raises). The reference supports true concurrent writers via FDB
    # serializable transactions (fdb/FdbVectorStore.java:575-601); the
    # rebuild's model is one writer at a time, enforced at lease acquisition.
    writer_conflict_policy: str = "raise"
    writer_conflict_wait_timeout_s: float = 30.0
    metric_attributes: Dict[str, str] = dataclasses.field(default_factory=dict)

    # Data-format fallback defaults for global workers reconstructing configs
    # from persisted IndexMeta with missing optional fields.
    default_graph_build_breadth: int = 256
    default_graph_alpha: float = 1.2

    def __post_init__(self):
        if self.local_worker_threads < 0:
            raise ValueError("localWorkerThreads must be >= 0")
        if self.local_maintenance_worker_threads < 0:
            raise ValueError("localMaintenanceWorkerThreads must be >= 0")
        if self.max_concurrent_compactions < 0:
            raise ValueError("maxConcurrentCompactions must be >= 0")
        if self.vacuum_cooldown_s < 0:
            raise ValueError("vacuumCooldown must be >= 0")
        if not (0.0 <= self.vacuum_min_deleted_ratio <= 1.0):
            raise ValueError("vacuumMinDeletedRatio must be in [0,1]")
        if self.default_ttl_s <= 0:
            raise ValueError("defaultTtl must be positive")
        if self.default_throttle_s < 0:
            raise ValueError("defaultThrottle must not be negative")
        if self.clock_ms is None:
            raise ValueError("instantSource must not be null")
        if self.compaction_min_segments < 2:
            raise ValueError("compactionMinSegments must be >= 2")
        if self.compaction_max_segments < self.compaction_min_segments:
            raise ValueError("compactionMaxSegments must be >= compactionMinSegments")
        if not (0.0 <= self.compaction_min_fragmentation <= 1.0):
            raise ValueError("compactionMinFragmentation must be in [0,1]")
        if self.compaction_age_bias_weight < 0:
            raise ValueError("compactionAgeBiasWeight must be >= 0")
        if self.compaction_size_bias_weight < 0:
            raise ValueError("compactionSizeBiasWeight must be >= 0")
        if self.compaction_frag_bias_weight < 0:
            raise ValueError("compactionFragBiasWeight must be >= 0")
        if self.hbm_cache_limit_bytes < 0:
            raise ValueError("hbmCacheLimitBytes must be >= 0")
        if self.cache_expire_after_access_s < 0:
            raise ValueError("cacheExpireAfterAccess must be >= 0")
        if self.query_breakdown_sample_every < 0:
            raise ValueError("queryBreakdownSampleEvery must be >= 0")
        if self.writer_lease_ttl_ms < 0:
            raise ValueError("writerLeaseTtlMs must be >= 0")
        if self.writer_conflict_policy not in ("raise", "wait", "concurrent"):
            raise ValueError(
                "writerConflictPolicy must be 'raise', 'wait', or 'concurrent'"
            )
        if self.writer_conflict_wait_timeout_s < 0:
            raise ValueError("writerConflictWaitTimeout must be >= 0")

    def replace(self, **kw) -> "WorkerConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class GlobalTaskQueueConfig:
    """Pairs shared cross-index build + maintenance queues
    (reference: config/GlobalTaskQueueConfig.java:18-48).

    Presence of this config means: do NOT create per-index local queues or start
    local worker pools; route tasks to the shared queues instead (a standalone
    GlobalWorkerRunner consumes them).
    """

    build_queue: Any  # tasks.TaskQueue of GlobalBuildTask
    maintenance_queue: Any  # tasks.TaskQueue of GlobalMaintenanceTask

    def __post_init__(self):
        if self.build_queue is None:
            raise ValueError("build_queue must not be null")
        if self.maintenance_queue is None:
            raise ValueError("maintenance_queue must not be null")


# Operational field names delegated to WorkerConfig when one is provided.
_OPERATIONAL_FIELDS = tuple(
    f.name for f in dataclasses.fields(WorkerConfig) if not f.name.startswith("default_graph")
)


@dataclasses.dataclass(frozen=True)
class VectorIndexConfig:
    """Full index configuration (reference: config/VectorIndexConfig.java:18-710).

    ``storage`` is the durability backend (vectorsearch_torch.core.persist.IndexStorage)
    — the analogue of the reference's FDB Database; ``name`` identifies the index
    within it (the analogue of the FDB directory path).
    """

    storage: Any
    name: str

    # ---- data-format params (persisted in IndexMeta, immutable on reopen) ----
    dimension: int = 768
    metric: str = Metric.L2
    max_segment_size: int = 100_000
    pq_m: int = 16
    pq_k: int = 256
    graph_degree: int = 64
    oversample: int = 2
    graph_build_breadth: int = 256
    graph_alpha: float = 1.2

    # ---- operational params (either inline or via worker_config) ----
    worker_config: Optional[WorkerConfig] = None
    local_worker_threads: int = 0
    local_maintenance_worker_threads: int = 0
    max_concurrent_compactions: int = 1
    vacuum_cooldown_s: float = 0.0
    vacuum_min_deleted_ratio: float = 0.25
    default_ttl_s: float = 300.0
    default_throttle_s: float = 1.0
    clock_ms: Callable[[], int] = _system_clock_ms
    prefetch_codebooks_enabled: bool = True
    prefetch_codebooks_sync: bool = False
    auto_find_compaction_candidates: bool = True
    compaction_min_segments: int = 2
    compaction_max_segments: int = 8
    compaction_min_fragmentation: float = 0.1
    compaction_age_bias_weight: float = 0.3
    compaction_size_bias_weight: float = 0.5
    compaction_frag_bias_weight: float = 0.2
    hbm_cache_limit_bytes: int = 0
    cache_expire_after_access_s: float = 600.0
    query_breakdown_sample_every: int = 64
    writer_lease_ttl_ms: int = 10_000
    # Single-writer enforcement (VERDICT r2 #3): what add/delete do when
    # ANOTHER process holds a live writer lease. "raise" fails fast with
    # ConcurrentWriterError (route writes to the lease holder, e.g. via the
    # cluster layer's write forwarding); "wait" blocks until the foreign
    # lease expires or is released (up to writer_conflict_wait_timeout_s,
    # then raises). The reference supports true concurrent writers via FDB
    # serializable transactions (fdb/FdbVectorStore.java:575-601);
    # "concurrent" is this rebuild's equivalent capability: N processes
    # ingest at once, each appending to its OWN ACTIVE segment with gid /
    # segment-id blocks allocated from shared transactional counters in
    # storage, control-state checkpoints merged under the cross-process
    # state lock, and cross-writer deletes routed through per-segment
    # overlay delete logs (core/store.py "concurrent writers" section).
    # Gid-remapping maintenance (vacuum/compaction) still requires
    # exclusivity and defers while other writers are live.
    writer_conflict_policy: str = "raise"
    writer_conflict_wait_timeout_s: float = 30.0
    metric_attributes: Dict[str, str] = dataclasses.field(default_factory=dict)
    global_task_queue_config: Optional[GlobalTaskQueueConfig] = None

    # ---- TPU-specific operational params ----
    pq_train_iters: int = 5  # reference hardcodes 5 (tasks/SegmentBuildService.java:180)
    pq_train_seed: int = 42  # reference hardcodes 42 (tasks/SegmentBuildService.java:180)
    query_batch_pad: int = 8  # device query batches pad to this bucket size
    #   doubled up to Q (8, 16, 32, ...): every distinct Q is its own XLA
    #   program (~20-40 s remote compile each), so ragged batches otherwise
    #   compile-storm the chip. <=1 disables padding (each Q compiles).
    fuse_multi_segment_queries: bool = False  # stack (query, segment) pairs
    #   into one traversal program; measured slower than pipelined
    #   per-segment programs on 100k segments (see ROADMAP.md)
    unified_search: bool = False  # TPU-native extension: search all sealed
    #   segments of a shape group as ONE disconnected graph with a single
    #   per-query exploration budget (the reference spends ef in EVERY
    #   segment). Changes per-segment ef/fan-in semantics — opt in.
    sealed_search_mode: str = "flat"  # "flat" | "exact" | "graph".
    #   flat (default): the candidate pool is the global ADC top-ef of the
    #     full PQ scan (computed anyway for seeds) — dominates any
    #     graph-traversal pool at equal ef because the traversal ranks a
    #     visited SUBSET by the same ADC distances (~22x QPS at >= recall
    #     on v5e; see core/index._sealed_query_step).
    #   exact: the pool is the approx top-k of a DIRECT raw-vector matmul —
    #     no PQ/ADC on the query path at all. The one-hot ADC matmul spends
    #     Q*(M*K)*N MACs to approximate what the raw matmul computes in
    #     Q*D*N (32x less at M=16,K=256,D=128) — on a 16 GB-HBM chip whose
    #     raw vectors are device-resident for the re-rank anyway, exhaustive
    #     MXU scan IS the fast path (core/index._sealed_exact_pool_scored). Recall
    #     is exact up to bf16-multiply ranking noise at the (oversampled)
    #     pool boundary. Prefer "flat" only when segments outgrow the
    #     raw-vector HBM budget (codes are 16 B/row vs 4*D B/row).
    #   graph: the reference's BEST_FIRST frontier expansion — DEPRECATED
    #     for TPU serving (r4 decision, VERDICT r3 #10): the per-step
    #     frontier gather is element-serial on TPU (~30 ms/step at Q=512),
    #     capping traversal at ~2.5k QPS where flat/exact serve 37-56k at
    #     equal-or-better recall. Full behavioral parity is kept and tested
    #     on the CPU backend (BEAM, RANDOM_PIVOTS, traversal semantics);
    #     selecting it on TPU logs a once-per-process perf warning. There is
    #     no planned Pallas traversal kernel: exhaustive MXU scans beat
    #     scan-free traversal on this hardware by construction — the scan is
    #     the thing the MXU is FOR, and the reference only avoids it because
    #     CPUs cannot afford it (fdb/FdbVectorIndex.java:911-968).
    #   BEAM mode / RANDOM_PIVOTS always traverse (graph-less or exact-mode
    #   segments fall back to their pool, warn-once).
    flat_ef_semantics: str = "buffer"  # "buffer" | "strict": the ef contract
    #   in flat mode (api/SearchParams.java:20-42). The graph path spends
    #   efSearch as an EXPLORATION budget, but its whole ef_buf candidate
    #   buffer reaches the re-rank; flat mode has no exploration phase, so:
    #   buffer (default): the candidate pool is the full static ef_buf
    #     (efSearch bucketed to the next power of two, capped at the segment
    #     size) — matches the graph path's effective re-rank semantics and
    #     its measured recall (.99 on sift100k).
    #   strict: the pool is masked to exactly the auto-tuned ef (the
    #     reference's literal contract). Costs recall when ADC ranking is
    #     noisy or top candidates are deleted (.99 -> .87 on sift100k) —
    #     opt in for strict parity experiments.
    graph_build_mode: str = "always"  # "always" | "skip_for_flat". The
    #   reference always builds the Vamana graph at seal (its only sealed
    #   search IS traversal, tasks/SegmentBuildService.java:204-209). Flat
    #   mode (the TPU-native default) never reads adjacency, so
    #   "skip_for_flat" skips the graph build entirely when
    #   sealed_search_mode="flat" — seal time drops to PQ train+encode and
    #   checkpoints shed the [cap, R] adjacency plane. Queries that request
    #   a traversal mode (BEAM / RANDOM_PIVOTS) against a graph-less segment
    #   fall back to the flat pool (warn-once), whose recall dominates the
    #   traversal pool at equal ef by construction.
    pq_build_mode: str = "always"  # "always" | "skip_for_exact". The
    #   reference always trains PQ at seal (its sealed search IS the ADC
    #   scan, tasks/SegmentBuildService.java:174-209). Exact mode never
    #   reads codes on the query path, so "skip_for_exact" skips PQ
    #   training+encoding entirely when sealed_search_mode="exact" — sealing
    #   becomes a metadata flip + checkpoint, and codes shed 16 B/row from
    #   checkpoints and HBM. Segments sealed this way carry a zero-column
    #   codes plane; a process that later opens them with a PQ-scanning mode
    #   ("flat"/"graph") serves them from the exact pool (warn-once).
    #   Requires sealed_search_mode="exact" and graph_build_mode=
    #   "skip_for_flat" (the graph path ranks by ADC and needs codes).
    payload_storage: str = "list"  # "list" | "arena". list: one Python object
    #   per row — feeds the C result builder (fastest objects API), fine to
    #   ~1M rows. arena: one bytes blob + int64 offset planes per segment
    #   (core/payloads.py) — bounded memory at 10M+ rows (16B/row overhead,
    #   payloads materialized only when a result returns them); checkpoints
    #   embed the blob in the npz instead of pickling object lists.
    durable_task_queues: bool = False  # journal build/maintenance queues
    #   through the storage backend so in-flight tasks (attempts, retry
    #   throttles) survive restarts — the reference gets this from its
    #   FDB-backed taskqueue (SURVEY.md §5.3). Off by default: reopen
    #   already re-derives build tasks from persisted lifecycle state.
    device: Any = "cuda"  # torch device (or its name) holding segment
    #   tensors. Never falls back: with no CUDA device, opening an index
    #   raises unless the caller passes device="cpu" (see check_device).
    device_placement: str = "default"  # "default" | "round_robin" (spreads
    #   segments across devices in the JAX package; not ported yet)
    mesh: Any = None  # optional jax.sharding.Mesh: SEALED segments' row data
    #   (vectors/codes/exists/alive) is sharded over the mesh's first axis,
    #   queries run as SPMD programs with per-shard ADC scan + local exact
    #   re-rank and an O(devices*k) all-gather merge riding ICI, and builds
    #   train/encode PQ with psum-reduced k-means (parallel/mesh.py) — the
    #   TPU answer to the reference's per-segment async fan-out + merge
    #   (fdb/FdbVectorIndex.java:417-470). ACTIVE/PENDING segments stay on
    #   the default device (their incremental appends would thrash shards).
    #   Requires sealed_search_mode="flat" and default device placement.
    segment_shard: Any = None  # optional (shard, n_shards): this process
    #   serves only segments with seg_id % n_shards == shard — the multi-HOST
    #   (DCN) distribution unit for parallel/cluster.py query servers, above
    #   the per-host device/mesh axes. Deterministic modulo ownership means
    #   rotation assigns new segments without any coordinator round-trip
    #   (the reference gets cross-host placement for free from FDB ranges).

    def __post_init__(self):
        if self.storage is None:
            raise ValueError("database must not be null")
        if self.name is None:
            raise ValueError("indexDir must not be null")
        if self.dimension <= 0:
            raise ValueError("dimension must be positive")
        Metric.validate(self.metric)
        if self.max_segment_size <= 0:
            raise ValueError("maxSegmentSize must be positive")
        if self.pq_m <= 0:
            raise ValueError("pqM must be positive")
        if self.pq_k <= 1:
            raise ValueError("pqK must be > 1")
        if self.dimension % self.pq_m != 0:
            raise ValueError(
                f"dimension ({self.dimension}) must be divisible by pqM ({self.pq_m})"
            )
        if self.graph_degree <= 0:
            raise ValueError("graphDegree must be positive")
        if self.graph_build_breadth < self.graph_degree:
            raise ValueError("graphBuildBreadth must be >= graphDegree")
        if self.graph_alpha < 0.0:
            raise ValueError("graphAlpha must be >= 0")
        if self.oversample <= 0:
            raise ValueError("oversample must be positive")
        if self.sealed_search_mode not in ("flat", "exact", "graph"):
            raise ValueError(
                "sealedSearchMode must be 'flat', 'exact' or 'graph'"
            )
        if self.flat_ef_semantics not in ("buffer", "strict"):
            raise ValueError("flatEfSemantics must be 'buffer' or 'strict'")
        if self.payload_storage not in ("list", "arena"):
            raise ValueError("payloadStorage must be 'list' or 'arena'")
        if self.graph_build_mode not in ("always", "skip_for_flat"):
            raise ValueError(
                "graphBuildMode must be 'always' or 'skip_for_flat'"
            )
        if self.pq_build_mode not in ("always", "skip_for_exact"):
            raise ValueError(
                "pqBuildMode must be 'always' or 'skip_for_exact'"
            )
        if self.pq_build_mode == "skip_for_exact" and (
            self.sealed_search_mode != "exact"
            or self.graph_build_mode != "skip_for_flat"
        ):
            raise ValueError(
                "pqBuildMode='skip_for_exact' requires sealedSearchMode="
                "'exact' and graphBuildMode='skip_for_flat' (the PQ-scanning "
                "and graph paths need codes)"
            )
        # Validate operational fields by constructing the effective WorkerConfig.
        object.__setattr__(self, "_effective_worker", self._build_effective_worker())
        if self.pq_train_iters <= 0:
            raise ValueError("pqTrainIters must be positive")
        if self.device_placement not in ("default", "round_robin"):
            raise ValueError("devicePlacement must be 'default' or 'round_robin'")
        self._check_ported()
        import torch

        object.__setattr__(self, "device", torch.device(self.device))
        if self.segment_shard is not None:
            try:
                shard, n_shards = (int(v) for v in self.segment_shard)
            except (TypeError, ValueError):
                raise ValueError("segmentShard must be a (shard, nShards) pair")
            if n_shards <= 0 or not (0 <= shard < n_shards):
                raise ValueError(
                    "segmentShard requires 0 <= shard < nShards"
                )
            object.__setattr__(self, "segment_shard", (shard, n_shards))

    def _check_ported(self) -> None:
        """Modes the port does not serve yet fail loudly; they are never
        served another way."""
        if self.mesh is not None:
            raise NotImplementedError(
                "mesh sharding is not ported to PyTorch yet (ROADMAP.md "
                "Queue A15)"
            )
        if self.device_placement == "round_robin":
            raise NotImplementedError(
                "device_placement='round_robin' is not ported to PyTorch yet "
                "(ROADMAP.md Queue A15)"
            )

    def _build_effective_worker(self) -> WorkerConfig:
        if self.worker_config is not None:
            return self.worker_config
        return WorkerConfig(
            local_worker_threads=self.local_worker_threads,
            local_maintenance_worker_threads=self.local_maintenance_worker_threads,
            max_concurrent_compactions=self.max_concurrent_compactions,
            vacuum_cooldown_s=self.vacuum_cooldown_s,
            vacuum_min_deleted_ratio=self.vacuum_min_deleted_ratio,
            default_ttl_s=self.default_ttl_s,
            default_throttle_s=self.default_throttle_s,
            clock_ms=self.clock_ms,
            prefetch_codebooks_enabled=self.prefetch_codebooks_enabled,
            prefetch_codebooks_sync=self.prefetch_codebooks_sync,
            auto_find_compaction_candidates=self.auto_find_compaction_candidates,
            compaction_min_segments=self.compaction_min_segments,
            compaction_max_segments=self.compaction_max_segments,
            compaction_min_fragmentation=self.compaction_min_fragmentation,
            compaction_age_bias_weight=self.compaction_age_bias_weight,
            compaction_size_bias_weight=self.compaction_size_bias_weight,
            compaction_frag_bias_weight=self.compaction_frag_bias_weight,
            hbm_cache_limit_bytes=self.hbm_cache_limit_bytes,
            cache_expire_after_access_s=self.cache_expire_after_access_s,
            query_breakdown_sample_every=self.query_breakdown_sample_every,
            writer_lease_ttl_ms=self.writer_lease_ttl_ms,
            writer_conflict_policy=self.writer_conflict_policy,
            writer_conflict_wait_timeout_s=self.writer_conflict_wait_timeout_s,
            metric_attributes=dict(self.metric_attributes),
        )

    # ---- effective operational getters (delegate to worker_config when set,
    #      reference: VectorIndexConfig.java:116-147) ----

    @property
    def effective(self) -> WorkerConfig:
        return self._effective_worker  # type: ignore[attr-defined]

    @property
    def sub_dim(self) -> int:
        return self.dimension // self.pq_m

    @property
    def is_global_task_queue_enabled(self) -> bool:
        return self.global_task_queue_config is not None

    def to_index_meta(self) -> "IndexMeta":
        from vectorsearch_torch.types import IndexMeta

        return IndexMeta(
            name=self.name,
            dimension=self.dimension,
            metric=self.metric,
            max_segment_size=self.max_segment_size,
            pq_m=self.pq_m,
            pq_k=self.pq_k,
            graph_degree=self.graph_degree,
            oversample=self.oversample,
            graph_build_breadth=self.graph_build_breadth,
            graph_alpha=self.graph_alpha,
        )

    def validate_against_meta(self, existing: "IndexMeta") -> None:
        """Reopen compatibility checks (reference: fdb/FdbVectorStore.java:124-166)."""
        if existing.dimension != self.dimension:
            raise ValueError(
                f"Dimension mismatch: existing={existing.dimension}, requested={self.dimension}"
            )
        if existing.metric != self.metric:
            raise ValueError(
                f"Metric mismatch: existing={existing.metric}, requested={self.metric}"
            )
        if existing.max_segment_size != self.max_segment_size:
            raise ValueError(
                "maxSegmentSize mismatch: existing="
                f"{existing.max_segment_size}, requested={self.max_segment_size}"
            )
        if existing.pq_m != self.pq_m:
            raise ValueError(f"pqM mismatch: existing={existing.pq_m}, requested={self.pq_m}")
        if existing.pq_k != self.pq_k:
            raise ValueError(f"pqK mismatch: existing={existing.pq_k}, requested={self.pq_k}")
        if existing.graph_degree != self.graph_degree:
            raise ValueError(
                f"graphDegree mismatch: existing={existing.graph_degree}, "
                f"requested={self.graph_degree}"
            )
        if existing.graph_build_breadth != 0 and existing.graph_build_breadth != self.graph_build_breadth:
            raise ValueError(
                f"graphBuildBreadth mismatch: existing={existing.graph_build_breadth}, "
                f"requested={self.graph_build_breadth}"
            )
        if existing.graph_alpha != 0.0 and existing.graph_alpha != self.graph_alpha:
            raise ValueError(
                f"graphAlpha mismatch: existing={existing.graph_alpha}, "
                f"requested={self.graph_alpha}"
            )
        if existing.oversample != self.oversample:
            raise ValueError(
                f"oversample mismatch: existing={existing.oversample}, "
                f"requested={self.oversample}"
            )

    @staticmethod
    def from_index_meta(
        meta: "IndexMeta",
        storage: Any,
        name: str,
        worker: WorkerConfig,
        *,
        device: Any = "cuda",
    ) -> "VectorIndexConfig":
        """Reconstructs a full config from persisted IndexMeta (data params) plus a
        WorkerConfig template (operational params) — used by global workers
        (reference: tasks/GlobalWorkerRunner.java:364-425). Zero-valued optional
        fields fall back to the worker defaults (reference: WorkerConfig.java:282-289).

        The modes are the JAX package's: it passes none, so they are the
        defaults (flat mode, PQ and a graph built at seal). ``device`` is the
        worker's own; it is not persisted, so the storage format stays the
        JAX package's.
        """
        return VectorIndexConfig(
            storage=storage,
            name=name,
            dimension=meta.dimension,
            metric=meta.metric,
            max_segment_size=meta.max_segment_size,
            pq_m=meta.pq_m,
            pq_k=meta.pq_k,
            graph_degree=meta.graph_degree,
            oversample=meta.oversample,
            graph_build_breadth=(
                meta.graph_build_breadth
                if meta.graph_build_breadth
                else max(worker.default_graph_build_breadth, meta.graph_degree)
            ),
            graph_alpha=meta.graph_alpha if meta.graph_alpha else worker.default_graph_alpha,
            worker_config=worker.replace(
                local_worker_threads=0, local_maintenance_worker_threads=0
            ),
            device=device,
        )

    def replace(self, **kw) -> "VectorIndexConfig":
        return dataclasses.replace(self, **kw)
