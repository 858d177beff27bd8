"""One run of one cell: set-up, the measured window, the per-layer readings,
then the comparison with the reference once the program is freed.

``run`` takes the cell as ``portbench.spec`` found it, so that the tests can
drive a whole run on the CPU at a size of their own (``device="cpu"``), and
``system`` (``"port"`` or ``"control"``) says what sits in the program's
place.
"""

from __future__ import annotations

import gc
import sys
import time
import types

import numpy as np
import torch

from portbench import check, data, load, roofline, spec
from portbench.reference import control, knn
from portbench.trace import Profiled

FORBIDDEN = ("jax", "jaxlib", "flax", "vectorsearch_tpu")
TRACE_S = 3.0  # the traced part of a --trace 1 window


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


class _Port:
    def __init__(self):
        from portbench import program

        self.p = program

    def open(self, config, device, capacity):
        return self.p.open_index(config, device)

    def params(self, traffic):
        return self.p.search_params(traffic["search"])

    def seal(self, index, config, sync, seal_s, last=None):
        self.p.seal(index, config, sync, seal_s, last)
        self.last_trace = last.trace if last is not None else None

    def warm(self, index, traffic, pool, params):
        self.p.warm(index, traffic, pool, params)

    def counters(self, index):
        return self.p.counters(index)

    def histogram(self, name, lo, hi):
        return self.p.histogram(name, lo, hi)

    def segments(self, index):
        return self.p.segments(index)


class _Control:
    """The reference in TF32 arithmetic in the program's place."""

    def __init__(self, metric):
        self.metric = metric

    def open(self, config, device, capacity):
        return control.BruteIndex(int(config["data"]["dim"]), capacity, device,
                                  metric=self.metric)

    def params(self, traffic):
        return None

    def seal(self, index, config, sync, seal_s, last=None):
        pass

    def warm(self, index, traffic, pool, params):
        pass

    def counters(self, index):
        return {}

    def histogram(self, name, lo, hi):
        return []

    def segments(self, index):
        return []


def _sync(device):
    if str(device).startswith("cuda"):
        torch.cuda.synchronize()


def _log(msg):
    print(msg, file=sys.stderr, flush=True)


def run(cell: spec.Cell, seed: int, seconds: float, trace: bool, device: str,
        t_start: float, system: str = "port") -> dict:
    cfg, tr = cell.config, cell.traffic
    if tr.get("loop", "closed") != "closed":
        raise ValueError(f"{cell.name}: only closed-loop traffic is generated")
    metric = cfg["index"].get("metric", "L2")
    if metric not in knn.METRICS:
        raise ValueError(f"{cell.name}: its configuration's metric {metric!r} is "
                         f"not one the reference computes ({', '.join(knn.METRICS)})")
    sysm = _Port() if system == "port" else _Control(metric)
    cuda = str(device).startswith("cuda")
    loops = load.writer_loops(tr, seconds)
    w = tr.get("writer") or {}
    inputs = data.make(cfg["data"], seed, int(tr["query_pool"]),
                       loops * int(w.get("adds", 0)), device)
    n_rows = len(inputs.rows)
    t_index = time.perf_counter()
    index = sysm.open(cfg, device, n_rows + len(inputs.fresh))
    seal_s: list = []
    t_add = time.perf_counter()
    base_gids = np.asarray(index.add_all(inputs.rows), np.int64)
    t_seal = time.perf_counter()
    sysm.seal(index, cfg, lambda: _sync(device), seal_s,
              last=Profiled(cpu=False) if trace and cuda else None)
    seal_trace = getattr(sysm, "last_trace", None)
    t_warm = time.perf_counter()
    params = sysm.params(tr)
    sysm.warm(index, tr, inputs.queries, params)
    _sync(device)
    t_load = time.perf_counter()

    spans = trace and cuda
    writer = load.Writer(index, inputs.fresh, base_gids, tr, spans) if w else None
    gen = load.Closed(index, inputs.queries, tr, params, spans)
    c0 = sysm.counters(index)
    if writer:
        writer.start()
    gen.start()
    lead_end = time.perf_counter() + float(tr["lead_s"])
    # the writer leads until it has made the vacuums the mix asks for (the
    # control has no vacuum: its lead is the clients' alone)
    need = int(w.get("vacuums_before_window", 0)) * ("vectorsearch.vacuum.run" in c0)
    while time.perf_counter() < lead_end or (
            need and writer and time.perf_counter() - t_load < w["lead_max_s"]
            and sysm.counters(index).get("vectorsearch.vacuum.run", 0)
            - c0.get("vectorsearch.vacuum.run", 0) < need):
        time.sleep(0.005)
    t_open = time.perf_counter()
    setup_s = t_open - t_start
    t_close = t_open + seconds
    reg0 = sysm.counters(index)
    window_trace, traced = None, None
    if trace and cuda:
        time.sleep(min(1.0, seconds / 4))
        r0 = sysm.counters(index)
        with Profiled(cpu=True, at_stop=lambda: sysm.counters(index)) as prof:
            time.sleep(min(TRACE_S, max(0.1, t_close - time.perf_counter() - 0.1)))
        window_trace, traced = prof.trace, (prof.t0, prof.t1, r0, prof.state)
    time.sleep(max(0.0, t_close - time.perf_counter()))
    reg1 = sysm.counters(index)
    gen.close()
    if writer:
        writer.close()
    _sync(device)
    memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
    segs = sysm.segments(index)

    ctx = types.SimpleNamespace(
        cell=cell, seconds=seconds, t_open=t_open, t_close=t_close,
        setup_s=setup_s, seal_s=seal_s, trace=window_trace, seal_trace=seal_trace,
        segments=segs, peaks=roofline.peaks(torch.cuda.get_device_name(0))
        if cuda else None,
        counters=(reg0, reg1), histogram=sysm.histogram, traced=traced,
        calls=[c for c in gen.calls if t_open <= c["te"] <= t_close],
    )
    k = int(tr["k"])
    attempted = sum(c["n"] for c in ctx.calls)
    failed = sum(c["n"] for c in ctx.calls if "error" in c)
    _log(f"setup: {setup_s:.3f} s (imports and data {t_index - t_start:.3f}; "
         f"open {t_add - t_index:.3f}; add {t_seal - t_add:.3f}; seals {t_warm - t_seal:.3f} over "
         f"{len(seal_s)}; warm {t_load - t_warm:.3f}; load lead "
         f"{t_open - t_load:.3f})")
    if writer:
        mut = writer.mutations_between(t_open, t_close)
        _log(f"writer: {mut} mutations acknowledged in the window, "
             f"{mut / seconds:.1f}/s; {len(writer.adds)} loops in all")
    if reg0 and reg1:
        nv = reg1.get("vectorsearch.vacuum.run", 0) - reg0.get("vectorsearch.vacuum.run", 0)
        _log(f"vacuums in the window: {nv:.0f}")
    names = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in names:
        v = spec.reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}

    # the comparison: free the program first, then the reference in blocks
    log_writes = (writer.adds, writer.deletes) if writer else ((), ())
    done = [c for c in gen.calls if "gids" in c]
    answers = dict(
        gids=[c["gids"] for c in done], dists=[c["dists"] for c in done],
        ts=[np.full(c["n"], c["ts"]) for c in done],
        te=[np.full(c["n"], c["te"]) for c in done],
        qidx=[c["off"] + np.arange(c["n"]) for c in done],
        pert=[np.full(c["n"], c["pert"], np.float32) for c in done])
    answers = {key: (np.concatenate(v) if v else np.zeros((0, k) if key in
               ("gids", "dists") else 0)) for key, v in answers.items()}
    errors = list(writer.errors) if writer else []
    index.close()
    del index, gen, writer
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    bad = forbidden_modules()
    if bad:
        raise SystemExit(f"loaded in the run's process: {', '.join(bad)}")
    if errors:
        _log(f"writer errors: {errors[:3]}")
    t_ref = time.perf_counter()
    log = knn.Log.build(base_gids, inputs.rows, log_writes[0], log_writes[1])
    numbers = compare(log, answers, inputs.queries, ctx, tr, k, seed, device, metric)
    _log(f"reference: {time.perf_counter() - t_ref:.3f} s over "
         f"{min(int(tr['sample']), len(answers['te']))} sampled answers and "
         f"{len(answers['te'])} checked for rows they could not see")
    numbers["unanswered"] = failed + len(errors)
    correct, shown = check.verdict(numbers, check.limits(cell.limits))
    result = {
        "correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
        "metrics": metrics,
        "device": {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": cell.chips, "memory_peak_bytes": int(memory_peak)},
    }
    if trace and window_trace is not None:
        result["device"].update(busy_s=window_trace.busy_s,
                                window_s=window_trace.window_s)
        result["breakdown"] = {"device_ops": window_trace.device_ops,
                               "idle_gaps": window_trace.idle_gaps}
    result["checks"] = shown
    return result


def compare(log, answers, pool, ctx, traffic, k, seed, device, metric) -> dict:
    """bad_rows over every answer; miss and dist_err, in ``metric``, over
    answers drawn from the seed among those that came back in the window."""
    bad = check.bad_rows(log, answers["gids"], answers["ts"], answers["te"])
    te = answers["te"]
    cand = np.flatnonzero((te >= ctx.t_open) & (te <= ctx.t_close))
    rng = np.random.default_rng([int(seed), 0x5EED])
    take = min(int(traffic["sample"]), len(cand))
    if not take:
        return {"miss": 1.0, "dist_err": 0.0, "bad_rows": bad}
    rows = np.sort(rng.choice(cand, size=take, replace=False))
    q = pool[answers["qidx"][rows]] + answers["pert"][rows][:, None]
    miss, err = check.sampled(log, q, answers["gids"][rows], answers["dists"][rows],
                              answers["ts"][rows], te[rows], k, device, metric)
    return {"miss": miss, "dist_err": err, "bad_rows": bad}
