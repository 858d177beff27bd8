"""Own copy of ``vectorsearch_tpu/utils/metrics.py`` for the PyTorch port (which imports nothing
of the JAX package); behaviour and on-disk formats are unchanged.

Telemetry registry (reference: util/Metrics.java:14-69, README.md:71-92).

Self-contained counters/histograms with the reference's metric names, so tests
can assert emissions without an OTel SDK. If opentelemetry is importable, the
same instruments are mirrored to the global OTel meter.

Instruments (reference names):
  histograms: vectorsearch.query.duration_ms, vectorsearch.build.duration_ms,
              vectorsearch.vacuum.duration_ms, vectorsearch.compaction.duration_ms,
              vectorsearch.query.pq_scan_ms, vectorsearch.query.graph_traversal_ms,
              vectorsearch.query.rerank_ms, vectorsearch.query.segments_searched,
              vectorsearch.query.results_returned
  counters:   vectorsearch.query.count, vectorsearch.build.count,
              vectorsearch.vacuum.run, vectorsearch.vacuum.removed,
              vectorsearch.compaction.run,
              vectorsearch.maintenance.vacuum.scheduled,
              vectorsearch.maintenance.vacuum.skipped
  gauges:     vectorsearch.cache.size/hit/miss/load_success/load_failure
              tagged {cache=codebook|adjacency}

Spans (``span``): each is mirrored to OpenTelemetry and appended to a
bounded in-process ring (``get_registry().spans()``), stamped on the
``time.perf_counter_ns`` clock. ``CLOCK_PAIR`` holds one reading of that
clock beside ``time.time_ns`` (the epoch clock torch.profiler stamps its
events on), taken at import, so that a reader can put the spans on a
profiler trace. The query's per-batch spans (``per_batch=True``: the query
and its stages) record only while a torch profiler runs; the others
(seals, vacuum, the writer's locked sections, the query path's waits on
them) are few a second and record always, as do the port's own route
records outside the ``vectorsearch.query.`` prefix: one
``vectorsearch.exact_pool.wide_pass`` a launch of B2's wide form, one
``vectorsearch.flat.call`` a flat-route call (``record_span``: around the
batch's stages, nesting none of them, with no batch id), and, on sampled
batches, the histogram ``vectorsearch.flat.rerank_ms`` (the batch's flat
re-ranks' device time).
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import defaultdict, deque
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.autograd.profiler as _autograd_profiler

#: (perf_counter_ns, time_ns) read together at import: a span's
#: ``start_ns`` s lies at ``s - CLOCK_PAIR[0] + CLOCK_PAIR[1]`` on the epoch
#: clock.
CLOCK_PAIR = (time.perf_counter_ns(), time.time_ns())

#: Records the span ring keeps; the oldest go first.
SPAN_RING_SIZE = 1 << 16


def _key(name: str, attrs: dict | None) -> Tuple[str, tuple]:
    return name, tuple(sorted((attrs or {}).items()))


class _OtelBridge:
    """Mirrors instruments to the global OpenTelemetry meter/tracer when the
    opentelemetry API is importable (reference: util/Metrics.java uses
    GlobalOpenTelemetry — a no-op unless the app installs an SDK,
    README.md:94-96). Instruments are created lazily per name."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict = {}
        self._histograms: dict = {}
        try:
            from opentelemetry import metrics as _om
            from opentelemetry import trace as _ot

            self._meter = _om.get_meter("vectorsearch_torch")
            self.tracer = _ot.get_tracer("vectorsearch_torch")
        except Exception:  # opentelemetry not installed: stay silent
            self._meter = None
            self.tracer = None

    def add(self, name: str, value: float, attrs: dict | None) -> None:
        if self._meter is None:
            return
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = self._meter.create_counter(name)
        c.add(value, attributes=attrs or {})

    def record(self, name: str, value: float, attrs: dict | None) -> None:
        if self._meter is None:
            return
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                h = self._histograms[name] = self._meter.create_histogram(name)
        h.record(value, attributes=attrs or {})


_OTEL = _OtelBridge()


class SpanRecord(NamedTuple):
    """One closed span. ``seq`` counts the records appended since the last
    reset; ``batch`` is the id shared by the spans of one query batch (None
    outside a recorded batch); ``depth`` is the number of spans open on the
    thread when it opened."""

    seq: int
    name: str
    batch: Optional[int]
    depth: int
    thread: int
    start_ns: int
    end_ns: int
    attrs: Optional[dict]


class SpanLog(NamedTuple):
    """The ring's records, oldest first, and how many records it dropped
    (appended since the last reset and no longer held)."""

    records: list
    dropped: int


_OPEN = threading.local()  # .stack: the spans open on this thread
_BATCH_IDS = itertools.count()


def _open_spans() -> list:
    st = getattr(_OPEN, "stack", None)
    if st is None:
        st = _OPEN.stack = []
    return st


class _Span:
    """A recording span: appended to the global registry's ring when it
    closes, and, with ``otel``, mirrored to the OpenTelemetry tracer when
    there is one (an exception is recorded there with ERROR status)."""

    __slots__ = ("name", "attrs", "per_batch", "otel", "batch", "depth",
                 "start_ns", "_otel")

    def __init__(self, name: str, attrs: dict | None, per_batch: bool,
                 otel: bool = True):
        self.name, self.attrs = name, attrs
        self.per_batch, self.otel = per_batch, otel

    def __enter__(self):
        st = _open_spans()
        self.depth = len(st)
        # inside a batch a span takes its batch id; the outermost span of a
        # batch draws one
        self.batch = st[-1].batch if st else None
        if self.batch is None and self.per_batch:
            self.batch = next(_BATCH_IDS)
        st.append(self)
        self._otel = None
        if self.otel and _OTEL.tracer is not None:
            self._otel = _otel_span(self.name, self.attrs)
            self._otel.__enter__()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, et, ev, tb):
        end = time.perf_counter_ns()
        st = _open_spans()
        if st and st[-1] is self:
            st.pop()
        GLOBAL.add_span(self.name, self.batch, self.depth, self.start_ns, end,
                        self.attrs)
        if self._otel is not None:
            self._otel.__exit__(et, ev, tb)
        return False


class _NullSpan:
    """The shared span that records nothing (cheaper to enter than
    ``contextlib.nullcontext``)."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, et, ev, tb):
        return None


_NULL_SPAN = _NullSpan()


def span(name: str, attrs: dict | None = None, *, per_batch: bool = False):
    """A tracing span: recorded in the registry's span ring (``spans()``)
    and mirrored to OpenTelemetry (the reference's vectorsearch.query /
    build / vacuum / compaction spans; an exception is recorded with ERROR
    status). ``per_batch`` marks the span a query batch opens (the
    outermost: it draws the batch id its stages share); it records in the
    ring only while a torch profiler runs, and keeps its OpenTelemetry
    mirror either way."""
    if per_batch and not _autograd_profiler._is_profiler_enabled:
        return _otel_span(name, attrs) if _OTEL.tracer is not None else _NULL_SPAN
    return _Span(name, attrs, per_batch)


def stage(name: str):
    """A stage of a query batch, opened inside its per-batch ``span``:
    recorded in the ring only while a torch profiler runs (a process-wide
    flag, which threads started before the profiler see too), with no
    OpenTelemetry mirror. Otherwise it costs one flag read."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NULL_SPAN
    return _Span(name, None, True, otel=False)


def record_span(name: str, start_ns: int, attrs: dict | None = None) -> None:
    """Appends a closed record from ``start_ns`` (``time.perf_counter_ns``)
    to now to the span ring, always, without opening it on the thread: the
    spans opened meanwhile keep their depth and batch, and the record takes
    none (a route's record around a query batch's stages). No OpenTelemetry
    mirror."""
    GLOBAL.add_span(name, None, len(_open_spans()), start_ns,
                    time.perf_counter_ns(), attrs)


@contextlib.contextmanager
def timed_span(name: str, registry=None):
    """A ``span`` whose length is also recorded, in ms, as the histogram
    ``<name>_ms`` of ``registry`` (the global one by default), as the
    seal's phases are."""
    t0 = time.perf_counter_ns()
    try:
        with span(name):
            yield
    finally:
        (registry or GLOBAL).record(f"{name}_ms",
                                    (time.perf_counter_ns() - t0) / 1e6)


@contextlib.contextmanager
def _otel_span(name: str, attrs: dict | None):
    with _OTEL.tracer.start_as_current_span(name) as sp:
        for k, v in (attrs or {}).items():
            sp.set_attribute(k, v)
        yield sp


def device_mark(device: torch.device):
    """A point in time on ``device``: a timing CUDA event recorded on its
    current stream (readable once the work before it has completed, so
    taking one waits for nothing), the host clock on the CPU."""
    if device.type == "cuda":
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(device))
        return ev
    return time.perf_counter()


def elapsed_ms(a, b) -> float:
    """Milliseconds from one ``device_mark`` of a device to a later one."""
    if isinstance(a, float):
        return (b - a) * 1000.0
    return a.elapsed_time(b)


class QueryLock:
    """A lock the query path takes (``with``): when another thread holds
    it, the wait is recorded as a ``vectorsearch.query.lock_wait`` span
    whose attribute ``lock`` names it. An uncontended acquire records
    nothing."""

    __slots__ = ("lock", "attrs")

    def __init__(self, lock, name: str):
        self.lock, self.attrs = lock, {"lock": name}

    def __enter__(self):
        if not self.lock.acquire(blocking=False):
            with span("vectorsearch.query.lock_wait", self.attrs):
                self.lock.acquire()
        return self

    def __exit__(self, *exc):
        self.lock.release()
        return False


class MetricsRegistry:
    """Thread-safe in-process metrics sink (mirrored to OTel when available)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[Tuple[str, tuple], float] = defaultdict(float)
        self._histograms: Dict[Tuple[str, tuple], list] = defaultdict(list)
        # appends take no lock: deque.append and next() on a count are
        # atomic under the interpreter lock
        self._spans: deque = deque(maxlen=SPAN_RING_SIZE)
        self._span_seq = itertools.count()

    def add_span(self, name: str, batch, depth: int, start_ns: int,
                 end_ns: int, attrs: dict | None = None) -> None:
        """Appends a closed span to the ring (``span`` calls this)."""
        self._spans.append(SpanRecord(
            next(self._span_seq), name, batch, depth, threading.get_ident(),
            start_ns, end_ns, attrs))

    def spans(self) -> SpanLog:
        """The span ring's records, oldest first, and the count dropped."""
        while True:
            try:
                recs = list(self._spans)
                break
            except RuntimeError:  # appended to while copied: copy again
                continue
        top = max((r.seq for r in recs), default=-1)
        return SpanLog(recs, max(0, top + 1 - len(recs)))

    def inc(self, name: str, value: float = 1.0, attrs: dict | None = None) -> None:
        with self._lock:
            self._counters[_key(name, attrs)] += value
        _OTEL.add(name, value, attrs)

    def record(self, name: str, value: float, attrs: dict | None = None) -> None:
        with self._lock:
            self._histograms[_key(name, attrs)].append(value)
        _OTEL.record(name, value, attrs)

    def counter_value(self, name: str, attrs: dict | None = None) -> float:
        with self._lock:
            if attrs is None:
                return sum(v for (n, _), v in self._counters.items() if n == name)
            return self._counters.get(_key(name, attrs), 0.0)

    def histogram_values(self, name: str, attrs: dict | None = None) -> list:
        with self._lock:
            if attrs is None:
                out = []
                for (n, _), vs in self._histograms.items():
                    if n == name:
                        out.extend(vs)
                return out
            return list(self._histograms.get(_key(name, attrs), []))

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "counters": {f"{n}{dict(a)}": v for (n, a), v in self._counters.items()},
                "histogram_counts": {
                    f"{n}{dict(a)}": len(v) for (n, a), v in self._histograms.items()
                },
            }

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._histograms.clear()
            self._spans.clear()
            self._span_seq = itertools.count()


class ScopedRegistry:
    """View of a registry that merges fixed base attributes into every
    emission — the analogue of the reference's `metricAttribute(k, v)`
    user attributes (config/VectorIndexConfig.java:594-606): components
    holding a config emit through get_registry(config.metric_attributes) so
    every counter/histogram (and the OTel mirror) carries the user tags.
    Per-call attrs override base attrs on key collision."""

    def __init__(self, base: "MetricsRegistry", attrs: dict):
        self._base = base
        self._attrs = dict(attrs)

    def _merge(self, attrs: dict | None) -> dict:
        return {**self._attrs, **(attrs or {})}

    def inc(self, name: str, value: float = 1.0, attrs: dict | None = None) -> None:
        self._base.inc(name, value, self._merge(attrs))

    def record(self, name: str, value: float, attrs: dict | None = None) -> None:
        self._base.record(name, value, self._merge(attrs))

    def counter_value(self, name: str, attrs: dict | None = None) -> float:
        return self._base.counter_value(name, attrs)

    def histogram_values(self, name: str, attrs: dict | None = None) -> list:
        return self._base.histogram_values(name, attrs)

    def spans(self) -> SpanLog:
        return self._base.spans()

    def snapshot(self) -> dict:
        return self._base.snapshot()

    def reset(self) -> None:
        self._base.reset()


#: Global registry (reference uses GlobalOpenTelemetry; tests may reset()).
GLOBAL = MetricsRegistry()


def get_registry(attrs: dict | None = None):
    """The global sink, or a scoped view merging ``attrs`` (e.g.
    config.metric_attributes) into every emission."""
    if attrs:
        return ScopedRegistry(GLOBAL, attrs)
    return GLOBAL


def reset_for_test() -> None:
    GLOBAL.reset()
