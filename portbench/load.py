"""The one load generator: every traffic mix is a JSON file of parameters
that this module reads (``portbench/traffic/<mix>.json``).

- ``"loop": "closed"``: ``clients`` threads, each sending ``batch``-query
  calls to ``query_batch_arrays`` one after another (bench.py's
  ``measure_qps``: client i's j-th call takes the block at
  ``(i + j) * batch`` of the held-out pool, modulo ``pool - batch``, plus a
  small scalar of its own).
- ``"writer"``: one thread adding ``adds`` fresh rows and
  deleting ``deletes`` rows a loop, at ``rate_per_s`` mutations a second
  (bench.py's pinned writer; deletes walk the initial gids from
  ``delete_from`` of them on).

Every call's times, inputs and answers are kept for the rates, the tails
and the comparison that decides ``correct``.
"""

from __future__ import annotations

import contextlib
import math
import threading
import time

import numpy as np


def spans(on: bool):
    """The span the load puts around each call into the program: a
    torch.profiler range named after the call in traced runs, nothing
    otherwise (end-to-end runs are measured with tracing off)."""
    if not on:
        return lambda _name: contextlib.nullcontext()
    from torch.profiler import record_function

    return lambda name: record_function("portbench." + name)


def perturbation(i: int, traffic: dict) -> np.float32:
    step, cycle = traffic["perturb"]
    return np.float32((i % int(cycle)) * float(step))


def writer_loops(traffic: dict, seconds: float) -> int:
    """The writer's loops a run can take at most (its rows are drawn ahead)."""
    w = traffic.get("writer")
    if not w:
        return 0
    per_s = w["rate_per_s"] / (w["adds"] + w["deletes"])
    return int(math.ceil((w["lead_max_s"] + seconds + 30.0) * per_s))


class Closed:
    """Closed-loop clients. ``calls``: one dict per completed or failed call."""

    def __init__(self, index, pool, traffic, params, traced=False):
        self.index, self.pool, self.t, self.params = index, pool, traffic, params
        self.span = spans(traced)
        self.stop = threading.Event()
        self.calls: list = []
        self._lock = threading.Lock()
        self.threads = [threading.Thread(target=self._client, args=(i,), daemon=True)
                        for i in range(int(traffic["clients"]))]

    def _client(self, i):
        batch, k = int(self.t["batch"]), int(self.t["k"])
        span = len(self.pool) - batch
        j = 0
        while not self.stop.is_set():
            off = ((i + j) * batch) % span if span > 0 else 0
            pert = perturbation(i * 1_000_003 + j, self.t)
            block = self.pool[off : off + batch] + pert
            ts = time.perf_counter()
            rec = dict(client=i, call=j, off=off, pert=float(pert), ts=ts, n=batch)
            try:
                with self.span("query_batch_arrays"):
                    g, _s, d = self.index.query_batch_arrays(block, k, self.params)
                rec.update(te=time.perf_counter(), gids=g, dists=d)
            except Exception as e:  # counted as failed queries
                rec.update(te=time.perf_counter(), error=repr(e))
            with self._lock:
                self.calls.append(rec)
            j += 1

    def start(self):
        for th in self.threads:
            th.start()

    def close(self, timeout=120.0):
        self.stop.set()
        for th in self.threads:
            th.join(timeout)
        if any(th.is_alive() for th in self.threads):
            raise RuntimeError("a client thread did not stop")


class Writer:
    """The pinned writer. ``adds``: (gids, rows, t_start, t_ack);
    ``deletes``: (gids, t_start, t_ack)."""

    def __init__(self, index, fresh, base_gids, traffic, traced=False):
        self.index, self.fresh = index, fresh
        self.span = spans(traced)
        w = traffic["writer"]
        self.n_add, self.n_del = int(w["adds"]), int(w["deletes"])
        self.budget = (self.n_add + self.n_del) / float(w["rate_per_s"])
        self.victims = np.asarray(base_gids)[int(len(base_gids) * w["delete_from"]):]
        self.adds: list = []
        self.deletes: list = []
        self.errors: list = []
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        j = 0
        while not self.stop.is_set():
            t_loop = time.perf_counter()
            rows = self.fresh[j * self.n_add : (j + 1) * self.n_add]
            dels = self.victims[j * self.n_del : (j + 1) * self.n_del]
            if len(rows) < self.n_add or len(dels) < self.n_del:
                self.errors.append(f"writer ran out of rows at loop {j}")
                return
            try:
                t0 = time.perf_counter()
                with self.span("add_all"):
                    gids = self.index.add_all(rows)
                t1 = time.perf_counter()
                self.adds.append((np.asarray(gids, np.int64), rows, t0, t1))
                t0 = time.perf_counter()
                with self.span("delete_all"):
                    self.index.delete_all(dels.tolist())
                t1 = time.perf_counter()
                self.deletes.append((dels, t0, t1))
            except Exception as e:  # reported by the harness
                self.errors.append(repr(e))
                return
            j += 1
            time.sleep(max(0.01, self.budget - (time.perf_counter() - t_loop)))

    def mutations_between(self, t0, t1) -> int:
        return sum(len(g) for g, _r, _s, a in self.adds if t0 <= a <= t1) + \
            sum(len(g) for g, _s, a in self.deletes if t0 <= a <= t1)

    def start(self):
        self.thread.start()

    def close(self, timeout=120.0):
        self.stop.set()
        self.thread.join(timeout)
        if self.thread.is_alive():
            raise RuntimeError("the writer did not stop")
