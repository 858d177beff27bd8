"""The system under test: vectorsearch_torch, the PyTorch and CUDA port.
The only module of the benchmark that imports it. It opens an index as a
configuration states, seals it, and reads the port's own counters and its
segments; the harness times everything from outside.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np


def search_params(search: dict):
    from vectorsearch_torch.params import Mode, SearchParams

    kw = dict(search)
    kw["mode"] = Mode[kw.get("mode", "BEST_FIRST")]
    return SearchParams(**kw)


def open_index(config: dict, device: str):
    import vectorsearch_torch as tvs

    return tvs.VectorIndex.create_or_open(tvs.VectorIndexConfig(
        storage=tvs.MemoryStorage(), name=config["name"], device=device,
        **config["index"]))


def seal(index, config: dict, sync, seal_s: list, last=None) -> None:
    """Makes every full segment searchable. With no build worker in the
    configuration the harness seals each one itself and times it, from the
    call to the device sync after it; with workers it waits for them.
    ``last``, a context manager, is entered around the last seal alone
    (the profiler slows a seal several times over, so it traces one)."""
    if config["index"].get("local_worker_threads", 0) > 0:
        if not index.await_indexing_complete(timeout=1800):
            raise RuntimeError("the build workers did not finish")
        return
    while index.build_queue.has_visible_unclaimed_tasks():
        claim = index.build_queue.await_and_claim(timeout=1)
        if claim is None:
            break
        final = last is not None and not index.build_queue.has_visible_unclaimed_tasks()
        with last if final else contextlib.nullcontext():
            t0 = time.perf_counter()
            index.build_service.build(claim.payload.seg_id)
            sync()
            seal_s.append(time.perf_counter() - t0)
        claim.complete()


def warm(index, traffic: dict, pool, params) -> None:
    """Runs the one query shape the closed loop sends, twice."""
    n, k = int(traffic["batch"]), int(traffic["k"])
    for _ in range(2):
        index.query_batch_arrays(pool[:n], k, params)


def counters(index) -> dict:
    """The port's counters, summed over the registry's attributes, and the
    length of each histogram so far."""
    from vectorsearch_torch.ops import traversal
    from vectorsearch_torch.utils.metrics import get_registry

    reg = get_registry()
    out = {n: reg.counter_value(n) for n in (
        "vectorsearch.query.count", "vectorsearch.vacuum.run",
        "vectorsearch.compaction.run")}
    for n in ("vectorsearch.query.duration_ms", "vectorsearch.vacuum.duration_ms"):
        out[n] = len(reg.histogram_values(n))
    out["graph_expand.steps"] = traversal.graph_expand.steps
    return out


def histogram(name: str, lo: int, hi: int) -> list:
    from vectorsearch_torch.utils.metrics import get_registry

    return get_registry().histogram_values(name)[lo:hi]


def segments(index) -> list:
    """[{state, cap, live}] of every segment, as the store holds them; live
    counts the rows written and not deleted."""
    return [dict(state=s.state.value, cap=int(s.cap_pad),
                 live=int(np.count_nonzero(s.alive_np[: s.next_row])))
            for s in index.store.snapshot_segments()]
