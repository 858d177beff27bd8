"""vectorsearch_torch — the PyTorch/CUDA port of vectorsearch_tpu.

A second package beside the JAX one, which stays the reference: each module
here names the ``vectorsearch_tpu`` module it mirrors, and the tests hold the
two against each other on the same inputs. The port imports ``torch`` and
numpy and nothing of JAX or of ``vectorsearch_tpu``; the host modules it
needs (config, params, types, persistence, tasks, metrics) are its own
copies, and the checkpoint/WAL format is the same, so an index written by
either package opens in the other.

The port serves exact mode (``sealed_search_mode="exact"`` with
``pq_build_mode="skip_for_exact"``) and flat mode (``sealed_search_mode=
"flat"`` with ``graph_build_mode="skip_for_flat"``: PQ trained at seal, ADC
candidate pools, exact re-rank) end to end: add, seal, query, merge and gid
mapping. Its kernels are hand-written CUDA: the exact pool scans, two-plane
and packed (``csrc/exact_pool_tc.cu``, on the tensor cores), and the ADC
pool and scans (``csrc/adc.cu``).
Indexes run on ``config.device`` (default ``"cuda"``); the CPU runs only
when asked for with ``device="cpu"``. ROADMAP.md lists what is still to
port.
"""

from vectorsearch_torch.config import (
    GlobalTaskQueueConfig,
    Metric,
    VectorIndexConfig,
    WorkerConfig,
)
from vectorsearch_torch.params import Mode, SearchParams, SeedStrategy
from vectorsearch_torch.results import SearchResult
from vectorsearch_torch.types import (
    ConcurrentWriterError,
    IndexMeta,
    SegmentMeta,
    SegmentState,
)

__version__ = "0.1.0"

__all__ = [
    "ConcurrentWriterError",
    "GlobalTaskQueueConfig",
    "DiskStorage",
    "IndexMeta",
    "IndexStorage",
    "MemoryStorage",
    "Metric",
    "Mode",
    "SearchParams",
    "SearchResult",
    "SeedStrategy",
    "SegmentMeta",
    "SegmentState",
    "VectorIndex",
    "VectorIndexConfig",
    "WorkerConfig",
]


def __getattr__(name):
    # Lazy, as in vectorsearch_tpu/__init__.py: config-only use stays light.
    if name == "VectorIndex":
        from vectorsearch_torch.core.index import VectorIndex

        return VectorIndex
    if name in ("DiskStorage", "MemoryStorage", "IndexStorage"):
        import vectorsearch_torch.core.persist as _persist

        return getattr(_persist, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
