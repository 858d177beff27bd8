#!/usr/bin/env python3
"""Drives the PyTorch port (vectorsearch_torch) end to end on one CUDA card.

    python3 chip_smoke.py

It imports nothing of JAX and nothing of the JAX package. Phases, each of
which raises on failure (the script then exits non-zero and prints no
result):

1. environment: the card's name and power limit, the CUDA and nvcc versions;
2. build: compiles the hand-written kernels (vectorsearch_torch/csrc/*.cu,
   one nvcc per source, all started together) for sm_90a from the checkout,
   prints each kernel's registers and spills (the ADC kernels one line per
   form, line width and FULL flag), and counts the warpgroup MMA (HGMMA)
   instructions in the SASS (cuobjdump) of every instantiation of the exact
   pools' shared kernel, B1's and B2's: none in any of them, or no
   instantiation of either, fails;
3. kernel vs plain on the card:
   - the exact-pool kernel (B1) at every shape a sift1m exact batch gives it
     (Q 512, D 128, L2: the 8-segment group, N 800,768, fold 8; the
     2-segment group, N 200,192, fold 2; the ACTIVE brute table, N 100,096
     with its first 20,000 rows valid, fold 1) and a Deep10M batch gives it
     (its ACTIVE brute table: N 1,000,064, D 128 from 96 unit features,
     fold 8), a cosine case with a zero-norm row, and a tail case (N not a
     multiple of the tile, invalid rows, dead bins);
   - the packed exact-pool kernel (B2) at the Deep10M subgroups' shapes
     (Q 512, D 128 from 96 unit features, L2, ~2% invalid rows: the
     8-segment group, N 8,000,512, whose plain side runs over 64 queries,
     and the 2-segment group, N 2,000,128, each with the kernel reading only
     the 96 live features (d_live, as the index calls it), and the 2-segment
     group over all 128), a cosine case with a zero-norm row, a tail case
     with dead bins and fold 1 and an explicit tile 512, fold 2 geometry;
     the packed planes compare level by level (within one quantization
     step) and slot by slot, then the decoded top-k;
   - the ADC kernels (B3 pool, B4 scores, B5 scan, B5 precise scan) at the
     sift1m segment shape (Q 512, M 16, K 256, N 100,096), a segment under
     16,384 rows (N 10,112), a tail case (N 50,123, ~2% valid rows, dead
     bins, B4's pad columns), a wide LUT (M 64, K 256, D 256), an
     integer-valued LUT whose sums tie often and a small batch on narrow
     lines (Q 9, N 20,123, M 12, K 100); all four bit-identical to their
     plain versions, pool ids in every live bin included;
4. end to end on sift1m (1M x 128 clustered rows from seed 42, 10 sealed
   segments of 100k, L2, 512-query batches, k = 10, recall@10 on 128
   held-out queries against float64 ground truth computed on the card):
   - exact mode (skip_for_exact): recall >= 0.99, B1 launches per batch, the
     brute route with a 20,000-row ACTIVE segment, serving QPS with 8 client
     threads and one batch's latency, and a profile (below);
   - flat mode, the all-defaults config (PQ M 16 x K 256 trained and the
     graph built at seal on the card: degree 32, breadth 64, alpha 1.2,
     bench.py's values; each seal's PQ and graph seconds, every adjacency
     checked: no self edge, ids < cap_pad, an edge on every live row, mean
     filled degree logged; bench.py's SearchParams): per-segment pools
     through B3 (10 launches per batch), recall >= 0.97, true distances,
     QPS with 8 clients and with 1, latency, and a profile;
   - unified flat: the same sealed segments reopened with
     unified_search=True, through B5 (10 launches per batch), recall >= 0.85
     (one ef_buf of 256 spans 800k rows by design);
   - graph mode: the same seals reopened with sealed_search_mode="graph"
     (BEST_FIRST, ef 150, beam 128, max_explore 150): graph_expand on the
     card equal to its CPU run on one segment's graph and tie-free ranks of
     its scan, pools holding rows past the seeds; per segment a B5-fast
     scan (10 launches per batch), seeds, the traversal and the exact
     re-rank, recall >= 0.95, one-client QPS, latency, the traversal's
     steps per batch and a profile; one batch each of BEAM (max_iters 6)
     and RANDOM_PIVOTS at recall >= 0.95; unified_search=True graph mode at
     recall >= 0.6566, the JAX package's reading on the same rows (0.6766,
     tests/test_torch_graph_sift1m.py) less 0.02 (B5-fast 10 times a
     batch);
   - the graph build's fused kNN route (segments of 262,144 rows or more):
     4 blocks of 512 rows over the first 300,000 sift1m rows through
     _knn_block_fused (B1 once a block, counted) against _knn_block on the
     same blocks, mean top-64 overlap >= 0.98, each route's time a block;
   - small-segment flat: 100,000 rows in 10,000-row segments (with their
     graphs), through B4 (10 launches per batch), recall >= 0.97;
   - Deep10M under churn (bench.py's bench_deep10m in exact mode: 10M x 96
     unit rows from seed 42 in 1M-row segments, vacuum at a deleted ratio
     of 0.1 with a 5 s cooldown, one build and one maintenance worker):
     recall@10 >= 0.99; B2 launches per batch equal to the sealed
     power-of-two subgroups of >= 2M rows (8 + 2 segments: 2) and B1 once
     for the brute table; QPS with 8 clients, idle and under the pinned
     24k mutations/s writer; >= 1 vacuum; a compaction of the most-vacuumed
     segment and a neighbour forced through the public chain while 8
     clients query (the longest gap between batch completions); then
     self-recall >= 0.99, no leaked delete, no segment COMPACTING or
     WRITING, and the sources' surviving gids in the new segments;
   each profile traces five one-client batches and (exact, flat, Deep10M)
   one 8-client window with torch.profiler: wall and device time per batch,
   the card's busy share, device operations and kernel-launch calls per
   batch, top kernels (full tables in _profiles/chip_smoke_profile.txt,
   git-ignored); unified flat, graph and small-segment flat are profiled
   over the five one-client batches only;
5. timings at the sift1m shapes (B2: the Deep10M subgroups' shapes, its
   plain version over 64 queries): each kernel, its plain version, one
   PyTorch call computing the same function where there is one (the library
   yardstick; the port never calls it) and the card's bound; for the four
   ADC kernels also their lookup ceiling (the shared-memory bank reads of
   their Q*N_valid*M lookups at 32 a cycle per SM, at the card's maximum SM
   clock; logged, not in the kernels line) and their time on codes that
   are the same in every row (every load one line: no bank conflict); B4
   at its route's N 10,112 (its figures in the kernels line: kernel and
   library timed as CUDA graphs of 20 calls, so the host's pace stays out),
   five host-loop timings there as earlier versions took them, and its
   chunk candidates side by side (the wrapper's chunk against 1,024
   columns, in turns); for B1 also its
   useful TFLOP/s, the ceiling of its 3xTF32 form at the TF32 peak, and its
   times at the 2-segment group, the Deep10M brute table and 3,072-feature
   rows (its streamed form, beside torch.matmul); for B2 its useful
   TFLOP/s, 3xTF32 ceiling and bound both at the padded D 128 and at the
   96 live features the index asks for, beside torch.matmul of the padded
   and of the live product.

Every kernel's launch count is set to 0 just before each main-path run and
read just after. The line before the last names the card and its power
limit; the line before that is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import concurrent.futures
import gc
import json
import os
import re
import statistics
import subprocess
import sys
import threading
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# Published peaks (NVIDIA data sheets, dense): bytes/s of device memory,
# bf16 and TF32 tensor-core and FP32 CUDA-core FLOP/s.
_PEAKS = {
    "sxm": dict(bytes_s=3.35e12, bf16=989e12, tf32=495e12, fp32=67e12),
    "pcie": dict(bytes_s=2.0e12, bf16=756e12, tf32=378e12, fp32=51e12),
}

# (name, C source, replaced TPU kernel) of every kernel the port has
_KERNELS = [
    ("exact_pool", "exact_pool_tc", "vectorsearch_tpu/ops/pallas/exact.py:107"),
    ("exact_pool_packed", "exact_pool_tc", "vectorsearch_tpu/ops/pallas/exact.py:203"),
    ("adc_pool", "adc", "vectorsearch_tpu/ops/pallas/adc.py:274"),
    ("adc_scores", "adc", "vectorsearch_tpu/ops/pallas/adc.py:79"),
    ("adc_scan", "adc", "vectorsearch_tpu/ops/pallas/adc.py:68"),
    ("adc_scan_precise", "adc", "vectorsearch_tpu/ops/pallas/adc.py:51"),
]


def _log(msg: str) -> None:
    print(msg, flush=True)


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def _wrappers():
    """Kernel name -> its wrapper (each carries a ``launches`` count)."""
    from vectorsearch_torch.ops import adc as adc_ops
    from vectorsearch_torch.ops import exact as exact_ops

    return {
        "exact_pool": exact_ops.exact_pool_cuda,
        "exact_pool_packed": exact_ops.exact_pool_packed_cuda,
        "adc_pool": adc_ops.adc_pool_cuda,
        "adc_scores": adc_ops.adc_scores_cuda,
        "adc_scan": adc_ops.adc_scan_cuda,
        "adc_scan_precise": adc_ops.adc_scan_precise_cuda,
    }


def _counted(fn):
    """Runs fn() with every kernel's launch count set to 0 just before it;
    returns (fn's result, {kernel: launches during that run})."""
    wrappers = _wrappers()
    for w in wrappers.values():
        w.launches = 0
    out = fn()
    return out, {name: w.launches for name, w in wrappers.items()}


def _time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of fn() over `iters` runs, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


# --------------------------------------------------------------- phase 2


def _build_all():
    """Builds every csrc/*.cu library, one nvcc each, all started together;
    returns {source: (path, compiler output, seconds)}."""
    from vectorsearch_torch.utils import cuda_build

    sources = sorted({src for _n, src, _r in _KERNELS})

    def one(src):
        t0 = time.time()
        path, out = cuda_build.build(src)
        return src, (path, out, time.time() - t0)

    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        return dict(pool.map(one, sources))


_PACKED_FLAG = re.compile(
    r"exact_pool_tc_kernel(?:<\d+, \w+, (\w+)>|ILi\d+ELb[01]ELb([01])E)")


def _packed_flag(name):
    """B2's PACKED flag, the last template argument of exact_pool_tc_kernel
    (B1 and B2 are its instantiations), read from a demangled or mangled
    kernel name; None for a name that is no instantiation of it."""
    m = _PACKED_FLAG.search(name)
    return None if m is None else (m.group(1) or m.group(2)) in ("true", "1")


_ADC_KERNEL = re.compile(
    r"adc_(?:pool_lines_kernelILi(\d+)ELb([01])E|scan_lines_kernelILi(\d)ELi(\d+)ELb([01])E)")
_ADC_FORMS = {"1": "B5-precise", "2": "B5-fast", "3": "B4"}


def _adc_ptxas(compiler_out):
    """One line per ADC kernel instantiation from nvcc's ptxas -v output:
    its form (B3's pool, or the line-scan kernel's B5-precise, B5-fast or
    B4), line width, FULL flag (16-byte code loads), registers and spill
    stores."""
    lines, name, spill = [], None, "?"
    for line in compiler_out.splitlines():
        if "Compiling entry" in line:
            m = _ADC_KERNEL.search(line)
            name = None if m is None else (
                f"B3 QL {m.group(1)} FULL {m.group(2)}" if m.group(1) else
                f"{_ADC_FORMS[m.group(3)]} QL {m.group(4)} FULL {m.group(5)}")
        elif name and "spill stores" in line:
            spill = line.split("bytes spill stores")[0].split(",")[-1].strip()
        elif name and "Used" in line and "registers" in line:
            regs = line.split("Used", 1)[1].split("registers")[0].strip()
            lines.append(f"{name}: {regs} registers, {spill} bytes spill stores")
            name, spill = None, "?"
    return sorted(lines)


def _warpgroup_mmas(lib_path, kernel):
    """{function: HGMMA instruction count} of every function of a built
    library whose name holds `kernel`, read from its SASS (cuobjdump,
    beside nvcc)."""
    from vectorsearch_torch.utils import cuda_build

    cuobjdump = os.path.join(os.path.dirname(cuda_build.nvcc()), "cuobjdump")
    out = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True,
                         text=True, timeout=300)
    if out.returncode != 0:
        raise RuntimeError(f"cuobjdump failed: {out.stderr.strip()}")
    counts, fn = {}, None
    for line in out.stdout.splitlines():
        if "Function : " in line:
            name = line.split("Function : ", 1)[1].strip()
            fn = name if kernel in name else None
            if fn:
                counts[fn] = 0
        elif fn is not None:
            counts[fn] += "HGMMA" in line.split("*/", 1)[-1]
    return counts


# ------------------------------------------------------- phase 3: exact


def _case(name, n, metric, *, seed, zero_row=False, alive_frac=1.0, qn=512,
          d=128, segs=None, live_rows=None):
    """Clustered rows and queries made on the card from a seed. `segs`: a
    stack of that many 100,000-row segments; `live_rows`: only the first
    rows are valid (an ACTIVE segment's brute table)."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    centers = torch.randn(2048, d, device="cuda", generator=g) * 4
    x = centers[torch.randint(0, 2048, (n,), device="cuda", generator=g)]
    x = (x + torch.randn(n, d, device="cuda", generator=g)).contiguous()
    q = centers[torch.randint(0, 2048, (qn,), device="cuda", generator=g)]
    q = q + torch.randn(qn, d, device="cuda", generator=g)
    if alive_frac < 1.0:
        valid = torch.rand(n, device="cuda", generator=g) < alive_frac
    else:
        valid = torch.ones(n, dtype=torch.bool, device="cuda")
    if segs is not None:
        # a stack of `segs` segments: the pad rows past 100,000 in each are
        # invalid, as in the index
        per = n // segs
        valid = valid & ((torch.arange(n, device="cuda") % per) < 100_000)
    if live_rows is not None:
        valid = valid & (torch.arange(n, device="cuda") < live_rows)
    if zero_row:
        x[7] = 0.0
    return dict(name=name, q=q, x=x, valid=valid, metric=metric)


def _near_ties(rank, tol):
    """Positions of a descending [Q, k] rank-score plane whose neighbour
    sits within `tol` (their ids may swap)."""
    import torch

    near = torch.zeros_like(rank, dtype=torch.bool)
    diff = (rank[:, :-1] - rank[:, 1:]).abs() <= tol
    near[:, :-1] |= diff
    near[:, 1:] |= diff
    return near


def _check_pool(case, exact_ops, traversal_ops):
    """Kernel vs plain version on one case; returns (max_abs_err, report)."""
    import torch

    from vectorsearch_torch.ops.distance import matmul_nt

    q, x, valid, metric = case["q"], case["x"], case["valid"], case["metric"]
    q_in, aux, geom = exact_ops.pool_inputs(q, x, valid, metric)
    ks, ki = exact_ops.exact_pool_cuda(q_in, x, aux, **geom)
    ps, pi = exact_ops.exact_pool_plain(q_in, x, aux, **geom)
    torch.cuda.synchronize()
    qn = q.norm(dim=1)
    mx = torch.sqrt(torch.where(valid, (x * x).sum(1), 0.0).max())
    scale = qn if metric == "COSINE" else 2 * qn * mx + mx * mx
    tol = (1e-5 * scale)[:, None]  # per query
    live = torch.isfinite(ps)
    if not torch.equal(live, torch.isfinite(ks)):
        raise AssertionError(f"{case['name']}: dead bins differ")
    err = torch.where(live, (ks - ps).abs(), 0.0)
    max_err = float(err.max())
    if bool((err > tol).any()):
        raise AssertionError(
            f"{case['name']}: pool score error {max_err} above tolerance"
        )
    # ids: equal in every bin whose best and second best differ by > tol
    n, span, bins = x.shape[0], geom["fold"] * geom["tile"], geom["bins"]
    ng = geom["w"] // bins
    cross = matmul_nt(q_in, x)  # full f32, as the plain version computes it
    s = cross * aux[0] + aux[1] if metric == "COSINE" else cross - aux[0]
    s = torch.nn.functional.pad(s, (0, ng * span - n), value=float("-inf"))
    top2 = s.view(q.shape[0], ng, span // bins, bins).topk(2, dim=2).values
    del s, cross
    gap = (top2[:, :, 0] - top2[:, :, 1]).reshape(q.shape[0], -1)
    sep = live & (torch.nan_to_num(gap, nan=0.0, posinf=float("inf")) > tol)
    if not torch.equal(ki[sep], pi[sep]):
        bad = int((ki[sep] != pi[sep]).sum())
        raise AssertionError(f"{case['name']}: {bad} separated bins differ in id")
    rows = ki[live].long()
    if not bool(valid[rows].all()):
        raise AssertionError(f"{case['name']}: an invalid row won a bin")
    # identical final top-k after stage 2 + exact_finalize
    ef, k = 64, 10
    finals = []
    for outs, outi in ((ks, ki), (ps, pi)):
        top, pos = torch.topk(outs, min(ef, outs.shape[1]), dim=1)
        ids = torch.where(top > float("-inf"), torch.gather(outi, 1, pos), -1)
        finals.append(traversal_ops.exact_finalize(q, top, ids, k, metric))
        rank = torch.topk(top, k, dim=1).values  # final rank scores
    (_ks, _kd, k_i), (_ps, _pd, p_i) = finals
    near = _near_ties(rank, 2 * tol)
    mismatch = int(((k_i != p_i) & ~near).sum())
    if mismatch:
        raise AssertionError(f"{case['name']}: {mismatch} final top-k ids differ")
    report = (
        f"{case['name']}: N={n} W={geom['w']} fold={geom['fold']} "
        f"max_abs_err={max_err:.3e} sep_bins={int(sep.sum())}/{int(live.sum())} "
        f"final_ids_equal={int((k_i == p_i).sum())}/{k_i.numel()} "
        f"(near-tie positions {int(near.sum())})"
    )
    return max_err, report


# ------------------------------------------------ phase 3: packed pool


def _deep_case(name, segs, *, seed, alive_frac=0.98, qn=512):
    """A Deep10M subgroup's table made on the card from a seed: `segs`
    segments of pad_cap(1,000,000) = 1,000,064 rows, unit rows of 96
    features near 4096 unit centres (noise 0.18) zero-padded to 128, the
    pad rows past 1,000,000 of each segment invalid and ~2% of the rest
    too; queries are rows plus 0.02 noise (bench.py's Deep10M shapes)."""
    import torch

    per, d = 1_000_064, 96
    n = segs * per
    g = torch.Generator(device="cuda").manual_seed(seed)
    centers = torch.randn(4096, d, device="cuda", generator=g)
    centers /= centers.norm(dim=1, keepdim=True)
    x = torch.zeros(n, 128, device="cuda")
    for off in range(0, n, 1_000_000):
        hi = min(off + 1_000_000, n)
        c = centers[torch.randint(0, 4096, (hi - off,), device="cuda", generator=g)]
        c = c + 0.18 * torch.randn(hi - off, d, device="cuda", generator=g)
        x[off:hi, :d] = c / c.norm(dim=1, keepdim=True)
    q = x[torch.randint(0, n, (qn,), device="cuda", generator=g)]
    q[:, :d] += 0.02 * torch.randn(qn, d, device="cuda", generator=g)
    rows = torch.arange(n, device="cuda")
    valid = (torch.rand(n, device="cuda", generator=g) < alive_frac) & (
        rows % per < 1_000_000
    )
    x[~(rows % per < 1_000_000)] = 0.0
    return dict(name=name, q=q.contiguous(), x=x, valid=valid, metric="L2")


def _check_packed(case, exact_ops, traversal_ops, *, plain_q=None, tile_n=None,
                  fold=None, d_live=None):
    """The packed kernel vs its plain version on one case (the plain side
    over the first `plain_q` queries when given; `d_live`: the kernel reads
    only the first features, the rest being zero). The planes: dead bins in
    the same places, quantized levels floor(p/F) within 1 step, and where
    the slots differ the kernel's row must be a near-winner (its own level,
    in the plain arithmetic, within 1 step of the plain winner's: a raw
    near-tie in a tile or two tiles on one step may resolve apart). Then
    the decoded top-k after stage 2 and exact_finalize: identical ids but
    at near-ties (2 steps). Returns (max level difference x step,
    max level difference, report)."""
    import torch

    q, x, valid, metric = case["q"], case["x"], case["valid"], case["metric"]
    q_in, aux, mult, qn2, step, geom = exact_ops.packed_pool_inputs(
        q, x, valid, metric, tile_n=tile_n, fold=fold, d_live=d_live
    )
    kp = exact_ops.exact_pool_packed_cuda(q_in, x, aux, mult, qn2, **geom)
    nq = q.shape[0] if plain_q is None else plain_q
    pp = exact_ops.exact_pool_packed_plain(
        q_in[:nq].contiguous(), x, aux, mult[:nq].contiguous(),
        qn2[:nq].contiguous(), **geom
    )
    torch.cuda.synchronize()
    k = kp[:nq]
    live = torch.isfinite(pp)
    if not torch.equal(live, torch.isfinite(k)):
        raise AssertionError(f"{case['name']}: dead bins differ")
    f = geom["slot_f"]
    kl = torch.floor(torch.where(live, k, 0.0) / f)
    pl = torch.floor(torch.where(live, pp, 0.0) / f)
    level_diff = int((kl - pl).abs().max())
    if level_diff > 1:
        raise AssertionError(f"{case['name']}: level difference {level_diff} > 1")
    ks, ps = k - kl * f, pp - pl * f  # slots
    differ = live & (ks != ps)
    qi, col = torch.nonzero(differ, as_tuple=True)
    if len(qi):
        # the kernel's winning row, and its level in the plain arithmetic
        tile, bins, fold_ = geom["tile"], geom["bins"], geom["fold"]
        per = tile // bins
        slot = ks[qi, col].long()
        t = (col // bins) * fold_ + slot // per
        row = t * tile + (slot % per) * bins + col % bins
        cross = (q_in[qi] * x[row]).sum(1)
        if metric == "COSINE":
            v = cross * aux[0][row] + aux[1][row]
        else:
            v = -torch.sqrt(torch.clamp(qn2[qi] - (cross - aux[0][row]), min=0.0))
        lev = torch.round(v * mult[qi])
        worst = float((lev - pl[qi, col]).abs().max())
        if worst > 1:
            raise AssertionError(
                f"{case['name']}: a differing slot is {worst} levels off the winner"
            )
    max_err = float(((kl - pl).abs() * step[:nq, None]).max())
    # stage 2 + decode + finalize on both planes
    ef, kk = 64, 10
    finals = []
    for plane in (k, pp):
        pv, pos = torch.topk(plane, ef, dim=1)
        s, r = exact_ops.decode_packed_pool(
            pv, pos, step[:nq], q[:nq], metric, d=q.shape[1], n=x.shape[0],
            qn=q.shape[0], tile_n=tile_n, fold=fold, min_w=16384,
        )
        finals.append(traversal_ops.exact_finalize(q[:nq], s, r, kk, metric))
    (k_s, _kd, k_i), (p_s, _pd, p_i) = finals
    # final scores are -distance (L2, one step = step) or the similarity
    # (cosine, one step = step / ||q||)
    tol = 2 * step[:nq]
    if metric == "COSINE":
        tol = tol / torch.clamp(q[:nq].norm(dim=1), min=1e-30)
    near = _near_ties(p_s, tol[:, None])
    mismatch = int(((k_i != p_i) & ~near).sum())
    if mismatch:
        raise AssertionError(f"{case['name']}: {mismatch} final top-k ids differ")
    report = (
        f"{case['name']}: Q={q.shape[0]} (plain over {nq}) N={x.shape[0]} "
        f"d_live={geom['d_live']} W={geom['w']} tile={geom['tile']} "
        f"fold={geom['fold']} F={int(f)} "
        f"max_level_diff={level_diff} slot_differs={int(differ.sum())}/"
        f"{int(live.sum())} bins ({float(differ.sum()) / max(1, int(live.sum())):.2e}) "
        f"max_abs_err={max_err:.3e} final_ids_equal={int((k_i == p_i).sum())}/"
        f"{k_i.numel()} (near-tie positions {int(near.sum())})"
    )
    return max_err, level_diff, report


# --------------------------------------------------------- phase 3: ADC


def _adc_case(name, n, *, seed, qn=512, m=16, k=256, d=128, frac=1.0,
              pad_from=None, ties=False):
    """A real LUT (queries near a random codebook's centroids, through
    build_lut), random byte codes and a validity mask, made on the card from
    a seed. `pad_from`: rows from there on are invalid (a segment's pad).
    `ties`: an integer-valued LUT (0, 1 or 2) instead, so that row sums tie
    often and the pool's ids hold its tie rule (the smallest row)."""
    import torch

    from vectorsearch_torch.ops import pq as pq_ops

    g = torch.Generator(device="cuda").manual_seed(seed)
    if ties:
        lut = torch.randint(0, 3, (qn, m, k), device="cuda", generator=g).float()
    else:
        cb = torch.randn(m, k, d // m, device="cuda", generator=g) * 4
        pick = torch.randint(0, k, (qn, m), device="cuda", generator=g)
        q = cb[torch.arange(m, device="cuda")[None, :], pick].reshape(qn, d)
        q = q + torch.randn(qn, d, device="cuda", generator=g)
        lut = pq_ops.build_lut(q, cb)
    codes = torch.randint(0, k, (n, m), device="cuda", generator=g,
                          dtype=torch.int32).to(torch.uint8)
    if frac < 1.0:
        valid = torch.rand(n, device="cuda", generator=g) < frac
    else:
        valid = torch.ones(n, dtype=torch.bool, device="cuda")
    if pad_from is not None:
        valid &= torch.arange(n, device="cuda") < pad_from
    return dict(name=name, lut=lut, codes=codes, valid=valid)


def _check_adc(case, adc_ops):
    """The four ADC kernels vs their plain versions on one case; returns
    ({kernel: max_abs_err}, report). All four bit-identical (the same f32
    additions in the same order, and B4's one rounding to bf16 at nearest
    even; pool ids equal in every live bin, ties included, -1 in dead bins;
    B4's pad columns -inf), and an identical stage-2 pool."""
    import torch

    from vectorsearch_torch.ops.exact import pool_topk

    lut, codes, valid = case["lut"], case["codes"], case["valid"]
    qn, m, k = lut.shape
    n = codes.shape[0]
    lh = adc_ops.lut_bf16(lut)
    hi, lo = adc_ops.lut_hi_lo(lut)
    tile, bins, fold, w = adc_ops.pool_geometry(qn, m, k, n)
    geom = dict(tile=tile, bins=bins, fold=fold, w=w)
    errs, notes = {}, []

    def rel_check(label, got, want, rtol):
        fin = torch.isfinite(want)
        if not torch.equal(fin, torch.isfinite(got)) or not torch.equal(
            got[~fin], want[~fin]
        ):
            raise AssertionError(f"{case['name']}: {label} padding differs")
        diff = (got[fin].float() - want[fin].float()).abs()
        err = float(diff.max()) if diff.numel() else 0.0
        if bool((diff > rtol * want[fin].float().abs()).any()):
            raise AssertionError(f"{case['name']}: {label} error {err} above tolerance")
        return err

    # B3
    ks, ki = adc_ops.adc_pool_cuda(lh, codes, valid, **geom)
    ps, pi = adc_ops.adc_pool_plain(lh, codes, valid, **geom)
    torch.cuda.synchronize()
    live = torch.isfinite(ps)
    errs["adc_pool"] = rel_check("pool scores", ks, ps, 1e-6)
    if not torch.equal(ks, ps) or not torch.equal(ki[live], pi[live]):
        raise AssertionError(f"{case['name']}: pool differs from its plain version")
    s = torch.where(valid[None, :], -adc_ops._lut_sums(lh, codes), float("-inf"))
    span, ng = fold * tile, w // bins
    s = torch.nn.functional.pad(s, (0, ng * span - n), value=float("-inf"))
    top2 = s.view(qn, ng, span // bins, bins).topk(2, dim=2).values
    del s
    best, second = top2[:, :, 0].reshape(qn, -1), top2[:, :, 1].reshape(qn, -1)
    tied = live & (best == second)
    if not bool(valid[ki[live].long()].all()):
        raise AssertionError(f"{case['name']}: an invalid row won a pool bin")
    if not bool((ki[~live] == -1).all()):
        raise AssertionError(f"{case['name']}: a dead pool bin has a row id")
    (kt, kid), (pt, pid) = pool_topk(ks, ki, 256), pool_topk(ps, pi, 256)
    scale = pt.abs().nan_to_num(0.0, posinf=0.0).amax(1, keepdim=True)
    near = _near_ties(pt, 1e-6 * scale)
    if int(((kid != pid) & ~near).sum()):
        raise AssertionError(f"{case['name']}: stage-2 pools differ")
    notes.append(f"pool W={w} fold={fold} tied_bins={int(tied.sum())}/"
                 f"{int(live.sum())} stage2_equal={int((kid == pid).sum())}/"
                 f"{kid.numel()}")
    # B4, B5-fast, B5-precise: the line-scan kernel's three forms
    for key, label, kern, plain, args in (
        ("adc_scores", "scores", adc_ops.adc_scores_cuda,
         adc_ops.adc_scores_plain, (lh, codes, valid)),
        ("adc_scan", "scan", adc_ops.adc_scan_cuda, adc_ops.adc_scan_plain,
         (lh, codes, valid)),
        ("adc_scan_precise", "precise scan", adc_ops.adc_scan_precise_cuda,
         adc_ops.adc_scan_precise_plain, (hi, lo, codes, valid)),
    ):
        a, b = kern(*args), plain(*args)
        errs[key] = rel_check(label, a, b, 0.0)
        if not torch.equal(a, b):
            raise AssertionError(f"{case['name']}: {label} differs from its plain version")
        del a, b
    notes.append(f"scores width={adc_ops.scores_width(n)}")
    torch.cuda.synchronize()
    report = (f"{case['name']}: Q={qn} N={n} M={m} K={k} valid={int(valid.sum())} "
              + " ".join(f"{key}_err={v:.3e}" for key, v in errs.items())
              + "; " + "; ".join(notes))
    return errs, report


# --------------------------------------------------------------- phase 4


def _sift1m_data():
    """bench.py's sift1m generator: 1M x 128 rows and 512 queries."""
    import numpy as np

    rng = np.random.default_rng(42)
    n, d = 1_000_000, 128
    centers = rng.normal(size=(2048, d)).astype(np.float32) * 4
    x = centers[rng.integers(0, 2048, n)] + rng.normal(size=(n, d)).astype(
        np.float32
    )
    q = centers[rng.integers(0, 2048, 512)] + rng.normal(size=(512, d)).astype(
        np.float32
    )
    return x, q, rng


def _open_index(tvs, storage, mode, seg_size, **kw):
    """bench.py's sift1m index (bench.py:76-89, 212-230): PQ 16 x 256,
    graph degree 32, breadth 64, alpha 1.2. Flat is the all-defaults
    config (PQ and a graph at seal); graph serves the same seals by
    traversal."""
    modes = dict(
        exact=dict(sealed_search_mode="exact", graph_build_mode="skip_for_flat",
                   pq_build_mode="skip_for_exact"),
        flat=dict(sealed_search_mode="flat", graph_build_mode="always",
                  pq_build_mode="always"),
        graph=dict(sealed_search_mode="graph", graph_build_mode="always",
                   pq_build_mode="always"),
    )[mode]
    return tvs.VectorIndex.create_or_open(tvs.VectorIndexConfig(
        storage=storage, name="sift1m", dimension=128, metric="L2",
        max_segment_size=seg_size, pq_m=16, pq_k=256, graph_degree=32,
        graph_build_breadth=64, device="cuda", **modes, **kw,
    ))


def _build(tvs, x, storage, mode, seg_size, seal_s=None):
    """Adds x and seals every full segment (PQ trained and the graph built
    on the card in flat mode); returns (index, gids, seconds). ``seal_s``,
    when given, collects each seal's seconds."""
    import numpy as np
    import torch

    t0 = time.time()
    idx = _open_index(tvs, storage, mode, seg_size)
    gids = idx.add_all(x)
    while idx.build_queue.has_visible_unclaimed_tasks():
        claim = idx.build_queue.await_and_claim(timeout=1)
        if claim is None:
            break
        t_seal = time.perf_counter()
        idx.build_service.build(claim.payload.seg_id)
        torch.cuda.synchronize()
        if seal_s is not None:
            seal_s.append(time.perf_counter() - t_seal)
        claim.complete()
    torch.cuda.synchronize()
    return idx, np.asarray(gids), time.time() - t0


class _GraphBuildTimer:
    """Times every ops/graph.build_graph call the seals make (synchronized
    on both sides), to split a seal into its PQ and graph parts."""

    def __init__(self):
        from vectorsearch_torch.ops import graph as graph_ops

        self.mod, self.orig, self.seconds = graph_ops, graph_ops.build_graph, []

    def __enter__(self):
        import torch

        def timed(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = self.orig(*a, **k)
            torch.cuda.synchronize()
            self.seconds.append(time.perf_counter() - t0)
            return out

        self.mod.build_graph = timed
        return self

    def __exit__(self, *exc):
        self.mod.build_graph = self.orig


def _check_graphs(segs, degree):
    """Each sealed adjacency: `degree` columns, no self edge, ids inside the
    segment's rows, every live row with at least one edge. Returns the mean
    filled degree of the live rows."""
    import numpy as np

    filled = []
    for seg in segs:
        adj = seg.adjacency_np
        if adj.shape != (seg.cap_pad, degree):
            raise AssertionError(f"segment {seg.seg_id}: adjacency {adj.shape}")
        rows = adj[: seg.next_row]
        if (rows == np.arange(seg.next_row)[:, None]).any():
            raise AssertionError(f"segment {seg.seg_id}: a self edge")
        if (adj >= seg.cap_pad).any():
            raise AssertionError(f"segment {seg.seg_id}: an id past cap_pad")
        live = seg.alive_np[: seg.next_row]
        if not (rows[live] >= 0).any(axis=1).all():
            raise AssertionError(f"segment {seg.seg_id}: a live row without edges")
        filled.append((rows[live] >= 0).sum(axis=1).mean())
    return float(np.mean(filled))


def _ground_truth(x, q, k, chunk=1_000_000):
    """Exact top-k row ids in float64 on the card, over chunks of rows."""
    import torch

    qd = torch.from_numpy(q).cuda().double()
    best_d, best_i = [], []
    for off in range(0, x.shape[0], chunk):
        xd = torch.from_numpy(x[off : off + chunk]).cuda().double()
        d2 = (qd * qd).sum(1)[:, None] - 2 * qd @ xd.T + (xd * xd).sum(1)[None, :]
        top = torch.topk(d2, min(k, xd.shape[0]), dim=1, largest=False)
        best_d.append(top.values)
        best_i.append(top.indices + off)
        del xd, d2
    pos = torch.topk(torch.cat(best_d, 1), k, dim=1, largest=False).indices
    out = torch.gather(torch.cat(best_i, 1), 1, pos).cpu().numpy()
    torch.cuda.empty_cache()
    return out


def _recall(got, truth, gids):
    import numpy as np

    return float(np.mean([
        len(set(gids[truth[i]].tolist()) & set(got[i].tolist())) / truth.shape[1]
        for i in range(len(truth))
    ]))


def _measure_qps(idx, queries, k, params=None, batch=512, clients=8,
                 seconds=2.0, windows=5, discard=True):
    """Serving QPS: `clients` threads call query_batch_arrays in a loop;
    counts are sampled at window boundaries, the first window discarded
    (unless `discard` is False), median (lo, hi) of the rest. Each call's
    block is perturbed by a fresh scalar, as bench.py does."""
    import numpy as np

    stop = threading.Event()
    counts = [0] * clients
    errors = []

    def client(i):
        done = 0
        try:
            while not stop.is_set():
                off = (i * batch + done) % (len(queries) - batch)
                uniq = np.float32(i * 1_000_003 + done) * np.float32(1e-7)
                idx.query_batch_arrays(queries[off : off + batch] + uniq, k, params)
                done += batch
                counts[i] += batch
        except Exception as e:  # reported by the caller
            errors.append(e)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(clients)]
    for t in threads:
        t.start()
    samples = []
    last, t_last = 0, time.perf_counter()
    try:
        for _ in range(windows):
            time.sleep(seconds)
            now, t_now = sum(counts), time.perf_counter()
            samples.append((now - last) / (t_now - t_last))
            last, t_last = now, t_now
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=120)
    if errors:
        raise errors[0]
    if any(t.is_alive() for t in threads):
        raise RuntimeError("a client thread did not stop")
    meas = samples[1:] if discard else samples
    return statistics.median(meas), min(meas), max(meas)


def _latency(idx, q, k, params=None, runs=10):
    """One client: a 512-query batch's latency end to end, (median, lo, hi) ms."""
    import numpy as np
    import torch

    lat = []
    for b in range(runs):
        t0 = time.perf_counter()
        idx.query_batch_arrays(q + np.float32(b * 1e-6), k, params)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(lat), min(lat), max(lat)


class _Launches:
    """Launch counts of the main path, summed over its counted runs."""

    def __init__(self):
        self.total = {name: 0 for name, _s, _r in _KERNELS}
        self.per_batch = {}

    def run(self, fn):
        out, counts = _counted(fn)
        for name, n in counts.items():
            self.total[name] += n
        return out, counts


def _serve_checks(label, idx, x, q, gids, truth, tag, launches, *, kernel,
                  want_per_batch, min_recall, params=None, qps=True):
    """Recall, true distances and per-batch launches of one path; then its
    serving QPS and one batch's latency. Returns ({kernel: launches in one
    512-batch}, recall); every kernel's count is read from the same three
    counted batches, and must be the same in each."""
    import numpy as np

    # warm: uploads, stacks, codebooks (a main-path run, counted too)
    launches.run(lambda: idx.query_batch_arrays(q, 10, params))
    (got, _s, dists), _c = launches.run(
        lambda: idx.query_batch_arrays(q[:128], 10, params)
    )
    if got.shape != (128, 10) or not np.isfinite(dists).all():
        raise AssertionError(f"{label}: malformed results")
    recall = _recall(got, truth, gids)
    row_of = {int(g): i for i, g in enumerate(gids[:len(x)])}
    rows = np.asarray([row_of[int(g)] for g in got[0]])
    want = np.linalg.norm(x[rows] - q[0], axis=1)
    if not np.allclose(dists[0], want, rtol=1e-3, atol=1e-3):
        raise AssertionError(f"{label}: distances are not true distances")
    per_batch = []
    for b in range(3):
        _o, c = launches.run(
            lambda: idx.query_batch_arrays(q + np.float32(b * 1e-6), 10, params)
        )
        per_batch.append(c)
    if any(c != per_batch[0] for c in per_batch):
        raise AssertionError(f"{label}: launches differ between batches {per_batch}")
    if per_batch[0][kernel] != want_per_batch:
        raise AssertionError(
            f"{label}: {kernel} launches per batch {per_batch[0][kernel]}, "
            f"expected {want_per_batch}"
        )
    _log(f"{label} {tag}: recall@10 {recall:.4f} on 128 queries (float64 "
         f"ground truth on the card); launches per 512-batch {per_batch[0]}")
    if recall < min_recall:
        raise AssertionError(f"{label}: recall@10 {recall} < {min_recall}")
    if qps:
        (rate, lo, hi), _c = launches.run(
            lambda: _measure_qps(idx, np.concatenate([q] * 8), 10, params)
        )
        _log(f"{label} serving {tag}: {rate:.1f} QPS median of 4 windows "
             f"[{lo:.1f}, {hi:.1f}], 8 clients, 512-query batches, k=10")
    (med, lo, hi), _c = launches.run(lambda: _latency(idx, q, 10, params))
    _log(f"{label} latency {tag}: one 512-query batch, one client, median of "
         f"10: {med:.3f} ms [{lo:.3f}, {hi:.3f}]")
    return per_batch[0], recall


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def _short(key: str) -> str:
    """A kernel's profiler name, shortened for a log line (B1 and B2 keep
    their template arguments)."""
    key = key.replace("(anonymous namespace)::", "")
    return (key[5:] if key.startswith("void ") else key)[:48]


def _on_device(evt) -> bool:
    return "CUDA" in str(getattr(evt, "device_type", ""))


def _traced(fn):
    """Runs fn() under torch.profiler -> (fn's result, wall s, key_averages)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return out, wall, prof.key_averages()


def _profile(label, idx, q, params, tag, launches, tables, clients=True):
    """Where one path's time goes: five one-client batches and (`clients`)
    one 8-client window under torch.profiler. Prints per batch the wall
    time, the device time of all device operations, the card's busy share
    (device time over wall time), the device operations and the host's
    kernel-launch calls and their mean time, and the top device operations;
    appends the full tables to `tables`. These runs are main-path runs and
    are counted like the others."""
    import numpy as np

    def batches():
        for b in range(5):
            idx.query_batch_arrays(q + np.float32(b * 1e-6), 10, params)

    def launch_calls(ka):
        calls = [e for e in ka if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                                            "cudaLaunchKernelExC")]
        n = sum(e.count for e in calls)
        us = sum(e.self_cpu_time_total for e in calls)
        return n, (us / n if n else 0.0)

    ((_o, wall, ka), _c) = launches.run(lambda: _traced(batches))
    dev = [e for e in ka if _on_device(e)]
    dev_s = sum(_device_us(e) for e in dev) / 1e6
    n_calls, call_us = launch_calls(ka)
    top = sorted(dev, key=_device_us, reverse=True)[:6]
    _log(f"{label} profile {tag}: one client, 5 batches: wall "
         f"{wall / 5 * 1e3:.3f} ms per batch, device {dev_s / 5 * 1e3:.3f} ms "
         f"per batch, card busy {dev_s / wall:.3f}, "
         f"{sum(e.count for e in dev) / 5:.0f} device operations and "
         f"{n_calls / 5:.0f} kernel-launch calls ({call_us:.1f} us each) per "
         f"batch; top: " + "; ".join(
             f"{_short(e.key)} {_device_us(e) / 5e3:.3f} ms x{e.count / 5:.0f}"
             for e in top))
    tables += [f"== {label}, one client, 5 batches {tag}",
               ka.table(sort_by="self_cpu_time_total", row_limit=25)]
    if not clients:
        return
    ((rate, _lo, _hi), wall, ka), _c = launches.run(lambda: _traced(
        lambda: _measure_qps(idx, np.concatenate([q] * 8), 10, params,
                             clients=8, seconds=1.0, windows=3)))
    dev_s = sum(_device_us(e) for e in ka if _on_device(e)) / 1e6
    n_calls, call_us = launch_calls(ka)
    _log(f"{label} profile {tag}: 8 clients, {rate:.1f} QPS while traced, card "
         f"busy {dev_s / wall:.3f}, kernel-launch calls {call_us:.1f} us each")
    tables += [f"== {label}, 8 clients {tag}",
               ka.table(sort_by="self_cpu_time_total", row_limit=25)]


# --------------------------------------------- phase 4c: graph mode


def _traversal_check(idx, q, params, tag):
    """graph_expand on the card against the same call on the CPU (whose
    result tests/test_torch_traversal.py holds equal to the JAX package's),
    on the first segment's graph and this batch's B5-fast scan of it made
    tie-free (each row's distance replaced by its rank, ties broken by row
    id), with the served ef, beam and step settings: identical candidate
    ids and distances, the same number of steps, and pools that hold rows
    that are not seeds (the expansion found them). Its scan is not counted
    as a launch of the main path."""
    import torch

    from vectorsearch_torch.core import index as core_index
    from vectorsearch_torch.ops import pq as pq_ops
    from vectorsearch_torch.ops import traversal as traversal_ops

    seg = min((s for s in idx.store.snapshot_segments()
               if s.state.value == "SEALED"), key=lambda s: s.seg_id)
    snap = seg.flat_snapshot()
    qd = torch.from_numpy(q).cuda()
    approx = pq_ops.adc_scan_auto(
        pq_ops.build_lut(qd, idx.caches.get_codebook(seg)), snap.codes,
        snap.exists)
    qn, n = approx.shape
    order = torch.argsort(approx, dim=1, stable=True)
    rank = torch.empty_like(approx).scatter_(
        1, order, torch.arange(n, dtype=torch.float32, device="cuda").expand(qn, n))
    rank = torch.where(torch.isfinite(approx), rank, float("inf"))
    del approx, order
    ef, beam = idx._auto_tune(seg, 10, params)
    ef_buf = min(core_index._bucket(max(ef, 10)), seg.cap_pad)
    beam_buf = min(core_index._bucket(beam, lo=8), ef_buf)
    walk = core_index._walk(params, ef_buf)
    seed_idx, seed_d = core_index._seeds(rank, beam_buf)
    adjacency = idx.caches.get_adjacency(seg)
    out = {}
    for dev in ("cuda", "cpu"):
        traversal_ops.graph_expand.steps = 0
        t0 = time.perf_counter()
        ids, dist = traversal_ops.graph_expand(
            rank.to(dev), adjacency.to(dev), snap.exists.to(dev),
            seed_idx.to(dev), seed_d.to(dev), ef, beam, ef_buf=ef_buf,
            beam_buf=beam_buf, **walk)
        ids, dist = ids.cpu(), dist.cpu()
        out[dev] = (ids, dist, traversal_ops.graph_expand.steps,
                    time.perf_counter() - t0)
    (gi, gd, gs, gt), (ci, cd, cs, ct) = out["cuda"], out["cpu"]
    seeds = seed_idx.cpu()
    found = (gi >= 0) & ~(gi[:, :, None] == seeds[:, None, :]).any(dim=2)
    per_q = found.sum(dim=1).float()
    same = torch.equal(gi, ci) and torch.equal(gd, cd)
    _log(f"sift1m graph traversal check {tag}: segment {seg.seg_id}, Q {qn}, "
         f"N {n:,}, ef {ef} (buffer {ef_buf}), beam {beam} (buffer "
         f"{beam_buf}), tie-free ranks: card == CPU {same}, steps card {gs} / "
         f"CPU {cs}, rows found past the seeds per query mean "
         f"{per_q.mean().item():.1f} min {per_q.min().item():.0f}; card "
         f"{gt * 1e3:.1f} ms, CPU {ct * 1e3:.1f} ms")
    if not same or gs != cs:
        raise AssertionError("sift1m graph: graph_expand on the card differs "
                             "from the CPU's on tie-free inputs")
    if gs < 1 or per_q.mean().item() <= 0:
        raise AssertionError("sift1m graph: the traversal found no row "
                             "past its seeds")
    return {"same": same, "steps": gs, "found_mean": per_q.mean().item()}


def _graph_phase(tvs, traversal_ops, storage, x, q, gids, truth, tag,
                 launches, tables, params):
    """Graph mode over phase 4b's seals: bench.py's SearchParams (BEST_FIRST,
    ef 150, beam 128, max_explore 150), B5-fast 10 times a batch, recall@10
    >= 0.95; one-client QPS, latency and profile with the traversal's steps
    a batch; one batch each of BEAM (max_iters 6) and RANDOM_PIVOTS at
    >= 0.95; then unified_search=True at the JAX package's reading less
    0.02. The recall gates alone cannot catch a broken traversal (the
    seeds' re-rank alone reads about flat's recall), so graph_expand is
    held to its CPU result first (``_traversal_check``). Returns what it
    read."""
    import numpy as np

    out = {}
    t0 = time.time()
    idx = _open_index(tvs, storage, "graph", 100_000)
    try:
        _log(f"sift1m graph {tag}: reopened in {time.time() - t0:.1f} s")
        out["traversal"] = _traversal_check(idx, q, params, tag)
        out["counts"], out["recall"] = _serve_checks(
            "sift1m graph", idx, x, q, gids, truth, tag, launches,
            kernel="adc_scan", want_per_batch=10, min_recall=0.95,
            params=params, qps=False,
        )
        (rate, lo, hi), _c = launches.run(lambda: _measure_qps(
            idx, np.concatenate([q] * 8), 10, params, clients=1))
        _log(f"sift1m graph serving {tag}: {rate:.1f} QPS median of 4 windows "
             f"[{lo:.1f}, {hi:.1f}], 1 client, 512-query batches, k=10")
        steps = []
        for b in range(3):
            traversal_ops.graph_expand.steps = 0
            launches.run(lambda: idx.query_batch_arrays(
                q + np.float32(b * 1e-6), 10, params))
            steps.append(traversal_ops.graph_expand.steps)
        out["steps"] = steps
        _log(f"sift1m graph {tag}: graph_expand steps per 512-batch (10 "
             f"segments) {steps}; adjacency rows on the card "
             f"{idx.get_adjacency_cache_size():,}")
        _profile("sift1m graph", idx, q, params, tag, launches, tables,
                 clients=False)
        for label, p, key in (
            ("BEAM", tvs.SearchParams(ef_search=150, beam_width=128,
                                      max_iters=6, max_explore=150,
                                      mode=tvs.Mode.BEAM), "beam_recall"),
            ("RANDOM_PIVOTS", params.replace(
                seed_strategy=tvs.SeedStrategy.RANDOM_PIVOTS), "pivots_recall"),
        ):
            t0 = time.perf_counter()
            (got, _s, dists), c = launches.run(
                lambda: idx.query_batch_arrays(q[:128], 10, p))
            secs = time.perf_counter() - t0
            if got.shape != (128, 10) or not np.isfinite(dists).all():
                raise AssertionError(f"sift1m graph {label}: malformed results")
            out[key] = _recall(got, truth, gids)
            _log(f"sift1m graph {label} {tag}: recall@10 {out[key]:.4f} on 128 "
                 f"queries, one batch {secs * 1e3:.1f} ms, launches {c}")
            if out[key] < 0.95:
                raise AssertionError(f"sift1m graph {label}: recall@10 "
                                     f"{out[key]} < 0.95")
    finally:
        idx.close()
    del idx
    # One ef of 150 over a whole subgroup: the JAX package reads 0.6766 on
    # these seals' rows (tests/test_torch_graph_sift1m.py, the CPU), so the
    # route is held to that reading less 0.02 (codebooks trained apart)
    idx = _open_index(tvs, storage, "graph", 100_000, unified_search=True)
    try:
        out["unified_counts"], out["unified_recall"] = _serve_checks(
            "sift1m unified graph", idx, x, q, gids, truth, tag, launches,
            kernel="adc_scan", want_per_batch=10, min_recall=0.6766 - 0.02,
            params=params, qps=False,
        )
    finally:
        idx.close()
    return out


def _knn_phase(x, tag, launches):
    """The fused kNN route of the graph build against the plain one on four
    512-row blocks of the first 300,000 rows: mean overlap of the top-64
    candidate sets >= 0.98; B1 once a block. Returns what it read."""
    import numpy as np
    import torch

    from vectorsearch_torch.ops import graph as graph_ops

    n, l = 300_000, 64
    xd = torch.from_numpy(np.ascontiguousarray(x[:n])).cuda()
    valid = torch.ones(n, dtype=torch.bool, device="cuda")
    ids = torch.arange(n, dtype=torch.int32, device="cuda")
    ef = max(128, 1 << l.bit_length())
    xn2 = torch.sum(xd * xd, dim=1)
    if not graph_ops._use_fused_knn(n):
        raise AssertionError("knn: 300,000 rows should take the fused route")
    starts = [0, 75_008, 150_016, 299_488]
    fused, fused_s = [], []

    def run_fused():
        for s0 in starts:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fused.append(graph_ops._knn_block_fused(
                xd[s0 : s0 + 512], ids[s0 : s0 + 512], xd, valid, l, ef,
                xn2=xn2)[0])
            torch.cuda.synchronize()
            fused_s.append(time.perf_counter() - t0)

    _o, c = launches.run(run_fused)
    plain, plain_s = [], []
    for s0 in starts:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain.append(graph_ops._knn_block(
            xd[s0 : s0 + 512], ids[s0 : s0 + 512], xd, valid, l)[0])
        torch.cuda.synchronize()
        plain_s.append(time.perf_counter() - t0)
    overlap = float(np.mean([
        len(set(a) & set(b)) / l
        for f, p in zip(fused, plain)
        for a, b in zip(f.cpu().numpy().tolist(), p.cpu().numpy().tolist())
    ]))
    fmed, pmed = statistics.median(fused_s[1:]), statistics.median(plain_s[1:])
    _log(f"knn route {tag}: N 300,000 x 128, 4 blocks of 512 rows, l 64, ef "
         f"{ef}: B1 launches {c['exact_pool']}, mean top-64 overlap with the "
         f"plain route {overlap:.4f}; per block (median of the last 3) fused "
         f"{fmed * 1e3:.2f} ms ({512 / fmed:,.0f} rows/s), plain "
         f"{pmed * 1e3:.2f} ms ({512 / pmed:,.0f} rows/s); first blocks "
         f"{fused_s[0] * 1e3:.2f} / {plain_s[0] * 1e3:.2f} ms")
    if c["exact_pool"] != 4:
        raise AssertionError(f"knn route: {c['exact_pool']} B1 launches, expected 4")
    if overlap < 0.98:
        raise AssertionError(f"knn route: overlap {overlap} < 0.98")
    del xd, valid, ids, xn2
    torch.cuda.empty_cache()
    return {"launches": c["exact_pool"], "overlap": overlap,
            "fused_ms": fmed * 1e3, "plain_ms": pmed * 1e3}


# -------------------------------------------------- phase 4e: Deep10M


def _deep10m_data():
    """bench.py's Deep10M generator (bench_deep10m, seed 42): 10M x 96 unit
    rows near 4096 unit centres (noise 0.18), and 512 queries, each a row
    plus 0.02 noise. Returns (x, q, centres)."""
    import numpy as np

    rng = np.random.default_rng(42)
    n, d, n_centers = 10_000_000, 96, 4096
    centers = rng.normal(size=(n_centers, d)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    x = np.empty((n, d), np.float32)
    for off in range(0, n, 1_000_000):
        hi = min(off + 1_000_000, n)
        c = centers[rng.integers(0, n_centers, hi - off)]
        x[off:hi] = c + 0.18 * rng.normal(size=(hi - off, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = x[rng.integers(0, n, 512)] + 0.02 * rng.normal(size=(512, d)).astype(
        np.float32
    )
    return x, q, centers


def _expected_pools(idx, exact_ops):
    """(two-plane, packed) pool launches one exact batch makes over the
    index's segment set as it stands: the brute tables (one per capacity,
    the segment count padded to a power of two) and the sealed power-of-two
    subgroups and singletons, each through the binned pool from
    exact.MIN_ROWS rows on, and packed from 2,000,000 rows on."""
    counts = [0, 0]

    def pool(rows):
        if rows >= exact_ops.MIN_ROWS:
            counts[int(exact_ops._packed_default(rows))] += 1

    segs = idx.store.snapshot_segments()
    brute, sealed = {}, {}
    for s in segs:
        if s.state.value in ("ACTIVE", "PENDING") and s.next_row > 0:
            brute.setdefault(s.cap_pad, []).append(s)
        elif s.state.value in ("SEALED", "COMPACTING") and s.exists_count() > 0:
            sealed.setdefault(s.cap_pad, []).append(s)
    for cap, group in brute.items():
        pad = 1
        while pad < len(group):
            pad *= 2
        pool(cap * pad)
    for cap, group in sealed.items():
        left = len(group)
        while left:
            size = 1
            while size * 2 <= left:
                size *= 2
            pool(size * cap)
            left -= size
    return tuple(counts)


def _deep10m(tvs, exact_ops, tag, launches, tables):
    """Phase 4e: the Deep10M churn path (bench.py bench_deep10m in exact
    mode). Returns a dict of what it measured; raises on a failed gate."""
    import numpy as np
    import torch

    from vectorsearch_torch.utils.metrics import get_registry

    out = {}
    t0 = time.time()
    x, q, centers = _deep10m_data()
    n, d = x.shape
    truth = _ground_truth(x, q[:128], 10)
    _log(f"deep10m data {tag}: {n:,} x {d} and 512 queries from seed 42, "
         f"float64 ground truth of 128 queries on the card, "
         f"{time.time() - t0:.1f} s")
    params = tvs.SearchParams(ef_search=150, beam_width=128, max_iters=6,
                              max_explore=150, mode=tvs.Mode.BEST_FIRST)
    reg = get_registry({})
    counters = ("vectorsearch.vacuum.run", "vectorsearch.vacuum.removed",
                "vectorsearch.compaction.run",
                "vectorsearch.maintenance.vacuum.scheduled")
    base = {c: reg.counter_value(c) for c in counters}
    t0 = time.time()
    idx = tvs.VectorIndex.create_or_open(tvs.VectorIndexConfig(
        storage=tvs.MemoryStorage(), name="deep10m", dimension=d, metric="L2",
        max_segment_size=n // 10, pq_m=16, pq_k=256, graph_degree=32,
        graph_build_breadth=64, local_worker_threads=1,
        local_maintenance_worker_threads=1, sealed_search_mode="exact",
        graph_build_mode="skip_for_flat", pq_build_mode="skip_for_exact",
        vacuum_min_deleted_ratio=0.1, vacuum_cooldown_s=5.0, device="cuda",
    ))
    try:
        gids = np.asarray(idx.add_all(x))
        if not idx.await_indexing_complete(timeout=900):
            raise AssertionError("deep10m: sealing did not finish")
        build_s = time.time() - t0
        states = [s.state.value for s in idx.store.snapshot_segments()]
        if states.count("SEALED") != 10:
            raise AssertionError(f"deep10m: expected 10 sealed segments, {states}")
        _log(f"deep10m index {tag}: {len(states)} segments {states}, add + "
             f"seal {build_s:.1f} s")
        # as bench.py: one row in the ACTIVE segment, one delete, then warm
        idx.add_all(x[:1])
        idx.delete_all([int(gids[300])])
        launches.run(lambda: idx.query_batch_arrays(q, 10, params))
        (got, _s, dists), _c = launches.run(
            lambda: idx.query_batch_arrays(q[:128], 10, params))
        out["recall"] = _recall(got, truth, gids)
        rows0 = np.where(got[0] == n, 0, got[0])  # gid n: the copy of row 0
        want = np.linalg.norm(x[rows0] - q[0], axis=1)
        if not np.allclose(dists[0], want, rtol=1e-3, atol=1e-3):
            raise AssertionError("deep10m: distances are not true distances")
        expect = _expected_pools(idx, exact_ops)
        per_batch = []
        for b in range(3):
            _o, c = launches.run(lambda: idx.query_batch_arrays(
                q + np.float32(b * 1e-6), 10, params))
            per_batch.append(c)
        if any(c != per_batch[0] for c in per_batch):
            raise AssertionError(f"deep10m: launches differ {per_batch}")
        got_pools = (per_batch[0]["exact_pool"], per_batch[0]["exact_pool_packed"])
        if got_pools != expect or expect[1] != 2:
            raise AssertionError(
                f"deep10m: (two-plane, packed) pools per batch {got_pools}, "
                f"expected {expect} (8 + 2 sealed subgroups, the brute table)"
            )
        out["per_batch"] = per_batch[0]
        _log(f"deep10m exact {tag}: recall@10 {out['recall']:.4f} on 128 "
             f"queries; launches per 512-batch {per_batch[0]} (expected from "
             f"the segment set: {expect[1]} packed pools for the 8- and "
             f"2-segment subgroups, {expect[0]} two-plane for the brute table)")
        if out["recall"] < 0.99:
            raise AssertionError(f"deep10m: recall@10 {out['recall']} < 0.99")
        qs = np.concatenate([q] * 4)
        (rate, lo, hi), _c = launches.run(
            lambda: _measure_qps(idx, qs, 10, params, seconds=2.0, windows=5))
        out["qps"] = rate
        _log(f"deep10m serving {tag}: {rate:.1f} QPS median of 4 windows of "
             f"2 s [{lo:.1f}, {hi:.1f}], 8 clients, no churn")
        (med, lo, hi), _c = launches.run(lambda: _latency(idx, q, 10, params, runs=5))
        _log(f"deep10m latency {tag}: one 512-query batch, one client, median "
             f"of 5: {med:.3f} ms [{lo:.3f}, {hi:.3f}]")

        # churn: bench.py's pinned writer (24k mutations/s: 2,000 adds and
        # 2,000 deletes per loop from gid n/2, seed 7) under 8 clients
        stop = threading.Event()
        mutations = [0]
        werr = []

        def writer():
            wrng = np.random.default_rng(7)
            next_del = n // 2
            loop_budget = 4000.0 / 24000.0
            try:
                while not stop.is_set():
                    t_loop = time.perf_counter()
                    fresh = centers[wrng.integers(0, 4096, 2000)] + 0.18 * (
                        wrng.normal(size=(2000, d)).astype(np.float32))
                    idx.add_all(fresh)
                    idx.delete_all(list(range(next_del, next_del + 2000)))
                    next_del += 2000
                    mutations[0] += 4000
                    time.sleep(max(0.01, loop_budget - (time.perf_counter() - t_loop)))
            except Exception as e:  # reported below
                werr.append(e)

        wt = threading.Thread(target=writer, daemon=True)
        t_churn = time.perf_counter()
        wt.start()
        time.sleep(1.0)
        try:
            (rate, lo, hi), _c = launches.run(lambda: _measure_qps(
                idx, qs, 10, params, seconds=5.0, windows=6, discard=False))
            # where the device time goes under churn: a traced 8-client
            # window with the writer still running
            ((t_rate, _l, _h), wall, ka), _c = launches.run(lambda: _traced(
                lambda: _measure_qps(idx, qs, 10, params, seconds=1.0,
                                     windows=3)))
        finally:
            stop.set()
            wt.join(timeout=120)
        dev = [e for e in ka if _on_device(e)]
        dev_s = sum(_device_us(e) for e in dev) / 1e6

        def share(pred):
            return sum(_device_us(e) for e in dev if pred(e.key)) / 1e6 / wall

        def pool(key, packed):
            return _packed_flag(key) is packed

        top = sorted(dev, key=_device_us, reverse=True)[:8]
        _log(f"deep10m churn profile {tag}: 8 clients and the writer, "
             f"{t_rate:.1f} QPS while traced, card busy {dev_s / wall:.3f}; "
             f"share of wall time: packed pool "
             f"{share(lambda k: pool(k, True)):.3f}, two-plane pool "
             f"{share(lambda k: pool(k, False)):.3f}, copies "
             f"(uploads and copy-on-write clones) "
             f"{share(lambda k: 'Memcpy' in k or 'copy' in k.lower()):.3f}; top: "
             + "; ".join(f"{_short(e.key)} {_device_us(e) / 1e3:.1f} ms "
                         f"x{e.count}" for e in top))
        tables += ["== deep10m exact under churn, 8 clients and the writer",
                   ka.table(sort_by="self_cpu_time_total", row_limit=25)]
        churn_s = time.perf_counter() - t_churn
        if werr:
            raise werr[0]
        out["churn_qps"] = rate
        _log(f"deep10m churn serving {tag}: {rate:.1f} QPS median of 6 "
             f"windows of 5 s [{lo:.1f}, {hi:.1f}] after a 1 s lead, 8 clients, "
             f"{mutations[0]:,} mutations in {churn_s:.1f} s "
             f"({mutations[0] / churn_s:,.0f}/s)")
        if not idx.maintenance_queue.await_queue_empty(timeout=300):
            raise AssertionError("deep10m: maintenance queue did not drain")
        vac = {c: reg.counter_value(c) - base[c] for c in counters}
        stalls = reg.histogram_values("vectorsearch.vacuum.duration_ms")
        _log(f"deep10m vacuum {tag}: {vac['vectorsearch.vacuum.run']:.0f} runs, "
             f"{vac['vectorsearch.vacuum.removed']:,.0f} rows removed, "
             f"{vac['vectorsearch.maintenance.vacuum.scheduled']:.0f} scheduled; "
             f"vacuum time (under the store lock) max "
             f"{max(stalls) if stalls else 0.0:.1f} ms")
        if vac["vectorsearch.vacuum.run"] < 1:
            raise AssertionError("deep10m: no vacuum ran under churn")

        # a compaction of the most-vacuumed segment and a neighbour, forced
        # through the public chain, while 8 clients query
        with idx.store.lock:
            sealed = sorted(
                (s.meta.count, s.seg_id) for s in idx.store.segments.values()
                if s.state.value == "SEALED" and s.meta.last_vacuum_at_ms > 0
            )
            src = sealed[0][1]
            ids = [s.seg_id for s in idx.store.segments.values()
                   if s.state.value == "SEALED"]
            nb = min((i for i in ids if i != src), key=lambda i: abs(i - src))
            src_rows = {sid: idx.store.segments[sid].meta.count for sid in (src, nb)}
            seg_rows = n // 10  # rows of each initial segment, in gid order
            keep = [int(g) for g in gids[src * seg_rows : (src + 1) * seg_rows : 997]
                    if idx.store.resolve_gid(int(g))[0] == src][:50]
        pair = sorted((src, nb))
        done_at = []
        cstop = threading.Event()
        cerr = []

        def client(i):
            try:
                while not cstop.is_set():
                    idx.query_batch_arrays(qs[i * 192 : i * 192 + 512], 10, params)
                    done_at.append(time.perf_counter())
            except Exception as e:  # reported below
                cerr.append(e)

        def compact():
            if not idx.maintenance.mark_candidates_compacting(pair):
                raise AssertionError(f"deep10m: could not mark {pair}")
            idx.request_compaction(pair)
            if not idx.maintenance_queue.await_queue_empty(timeout=600):
                raise AssertionError("deep10m: compaction did not finish")

        clients = [threading.Thread(target=client, args=(i,)) for i in range(8)]
        for t in clients:
            t.start()
        time.sleep(1.0)
        t_c0 = time.perf_counter()
        try:
            launches.run(compact)
            t_c1 = time.perf_counter()
            time.sleep(1.0)
        finally:
            cstop.set()
            for t in clients:
                t.join(timeout=120)
        if cerr:
            raise cerr[0]
        during = sorted(t for t in done_at if t_c0 <= t <= t_c1)
        marks = [t_c0] + during + [t_c1]
        gap = max(b - a for a, b in zip(marks, marks[1:]))
        comp_ms = reg.histogram_values("vectorsearch.compaction.duration_ms")
        compactions = (reg.counter_value("vectorsearch.compaction.run")
                       - base["vectorsearch.compaction.run"])
        _log(f"deep10m compaction {tag}: segments {pair} ({src_rows} live "
             f"rows) in {t_c1 - t_c0:.1f} s (executor "
             f"{comp_ms[-1] if comp_ms else 0.0:.0f} ms) with 8 clients "
             f"querying: {len(during)} batches completed during it, longest "
             f"gap between completions {gap * 1e3:.0f} ms")
        if compactions != 1:
            raise AssertionError(f"deep10m: {compactions} compactions ran")

        # afterwards, queues drained
        if not idx.await_indexing_complete(timeout=300):
            raise AssertionError("deep10m: builds did not drain")
        res, _c = launches.run(lambda: idx.query_batch_arrays(x[:256], 10, params))
        out["self_recall"] = float(np.mean(
            [int(gids[i]) in res[0][i].tolist() for i in range(256)]))
        dead, _c = launches.run(lambda: idx.query_batch_arrays(
            x[n // 2 : n // 2 + 64], 20, params))
        out["leaked"] = sum(int(gids[n // 2 + i]) in dead[0][i].tolist()
                            for i in range(64))
        with idx.store.lock:
            states = sorted({s.state.value for s in idx.store.segments.values()})
            stuck = [s.seg_id for s in idx.store.segments.values()
                     if s.state.value in ("COMPACTING", "WRITING")]
            gone = [sid for sid in pair if sid in idx.store.segments]
        locs = idx.resolve_ids(keep)
        moved = bool(keep) and all(sid not in pair and sid >= 0 for sid, _v in locs)
        _log(f"deep10m after churn {tag}: self-recall of x[:256] "
             f"{out['self_recall']:.4f}, leaked deletes {out['leaked']} of 64 "
             f"at k=20, segment states {states}, {len(keep)} surviving gids "
             f"of segment {src} resolve to {sorted({s for s, _v in locs})}")
        if out["self_recall"] < 0.99 or out["leaked"] or stuck or gone or not moved:
            raise AssertionError(
                f"deep10m: after churn self-recall {out['self_recall']}, leaked "
                f"{out['leaked']}, stuck {stuck}, sources left {gone}, "
                f"gids moved {moved}")
        _profile("deep10m exact", idx, q, params, tag, launches, tables)
    finally:
        idx.close()
    return out


# --------------------------------------------------------------- phase 5


def _bound(bytes_moved, ops, peaks):
    """(bound ms, bound_by): the larger of bytes over the memory rate and
    FP32 operations over the CUDA-core rate."""
    bytes_ms = bytes_moved / peaks["bytes_s"] * 1e3
    ops_ms = ops / peaks["fp32"] * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations")


def _max_sm_clock_hz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def _graph_ms(fn, iters: int = 20, replays: int = 5) -> float:
    """Mean device time of fn() captured `iters` times in one CUDA graph, by
    CUDA events over `replays` replays: the launches run back to back, so
    the host's pace stays out of a short kernel's time."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(stop) / (replays * iters)


_ADC_NAMES = ("adc_pool", "adc_scores", "adc_scan", "adc_scan_precise")


def _adc_timings(case, adc_ops, peaks, names=_ADC_NAMES, graph=False):
    """Kernel, plain, library and bound times of the ADC kernels `names` on
    one case (kernel and library as CUDA graphs with `graph`) -> ({kernel:
    times}, {kernel: extra}). The extras: the lookup ceiling, the 4-byte
    bank reads of the kernel's Q*N_valid*M lookups at 32 a cycle per SM, at
    the card's SM count and maximum SM clock (B3, B5-fast and B4 read two
    queries' bf16 values a word at 16-query lines, so half a read a lookup;
    B5-precise one (hi, lo) word a lookup), and the kernel's time on codes
    equal in every row, where the row groups of a load read one line (no
    bank conflict). The library yardstick is the XLA formulation's product
    (vectorsearch_tpu/ops/pq.py:182-190): the bf16 LUT [Q, M*K] times a
    prebuilt bf16 one-hot [M*K, N] in one torch.matmul (two for the hi/lo
    planes); the port never calls it."""
    import torch

    lut, codes, valid = case["lut"], case["codes"], case["valid"]
    qn, m, k = lut.shape
    n = codes.shape[0]
    lh = adc_ops.lut_bf16(lut)
    hi, lo = adc_ops.lut_hi_lo(lut)
    tile, bins, fold, w = adc_ops.pool_geometry(qn, m, k, n)
    geom = dict(tile=tile, bins=bins, fold=fold, w=w)
    onehot = torch.zeros(m * k, n, dtype=torch.bfloat16, device="cuda")
    cols = torch.arange(n, device="cuda")
    for j in range(m):
        onehot[j * k + codes[:, j].long(), cols] = 1.0
    lf, hf, lof = (t.reshape(qn, m * k) for t in (lh, hi, lo))
    n_valid = int(valid.sum())
    lut_b = qn * m * k * 2
    adds = qn * n_valid * m  # the kernels skip invalid rows
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    read_ms = 1e3 / (32 * sms * _max_sm_clock_hz())  # one bank read a lane
    same = codes[:1].expand(n, m).contiguous()
    kernels = {
        "adc_pool": lambda c: adc_ops.adc_pool_cuda(lh, c, valid, **geom),
        "adc_scores": lambda c: adc_ops.adc_scores_cuda(lh, c, valid),
        "adc_scan": lambda c: adc_ops.adc_scan_cuda(lh, c, valid),
        "adc_scan_precise": lambda c: adc_ops.adc_scan_precise_cuda(hi, lo, c, valid),
    }
    timer = _graph_ms if graph else (lambda fn: _time_ms(fn, 20))
    extra = {
        name: dict(
            lookup_ceiling_ms=adds * read_ms / (1 if name == "adc_scan_precise" else 2),
            same_codes_ms=timer(lambda: kernels[name](same)))
        for name in names
    }
    del same
    plains = {
        "adc_pool": (lambda: adc_ops.adc_pool_plain(lh, codes, valid, **geom),
                     lambda: lf @ onehot, n * m + n + lut_b + qn * w * 8, adds),
        "adc_scores": (lambda: adc_ops.adc_scores_plain(lh, codes, valid),
                       lambda: lf @ onehot,
                       n * m + n + lut_b + qn * adc_ops.scores_width(n) * 2, adds),
        "adc_scan": (lambda: adc_ops.adc_scan_plain(lh, codes, valid),
                     lambda: lf @ onehot, n * m + n + lut_b + qn * n * 4, adds),
        "adc_scan_precise": (
            lambda: adc_ops.adc_scan_precise_plain(hi, lo, codes, valid),
            lambda: hf @ onehot + lof @ onehot,
            n * m + n + 2 * lut_b + qn * n * 4, 2 * adds + qn * n_valid),
    }
    out = {}
    for name in names:
        plain, lib, nbytes, ops = plains[name]
        bound_ms, bound_by = _bound(nbytes, ops, peaks)
        out[name] = dict(
            ms=timer(lambda: kernels[name](codes)),
            plain_ms=_time_ms(plain, 3, 1),
            library_ms=_graph_ms(lib) if graph else _time_ms(lib, 10),
            bound_ms=bound_ms, bound_by=bound_by,
        )
    del onehot
    torch.cuda.empty_cache()
    return out, extra


def _chunk_candidates(case, adc_ops, rounds=3):
    """B4 on one case with the wrapper's chunk (``_line_chunk``) and with
    1,024-column chunks, in turns, each as a CUDA graph of 20 calls ->
    ({chunk columns: [ms, ...]})."""
    lh = adc_ops.lut_bf16(case["lut"])
    codes, valid = case["codes"], case["valid"]
    rule = adc_ops._line_chunk
    times = {}
    try:
        for _ in range(rounds):
            for fixed in (None, 1024):
                picked = []

                def chunk(*args, fixed=fixed, picked=picked):
                    picked.append(fixed or rule(*args))
                    return picked[-1]

                adc_ops._line_chunk = chunk
                ms = _graph_ms(lambda: adc_ops.adc_scores_cuda(lh, codes, valid))
                times.setdefault(picked[-1], []).append(ms)
    finally:
        adc_ops._line_chunk = rule
    return times


def _packed_timings(exact_ops, peaks, tag):
    """B2 at the Deep10M subgroups' shapes: the kernel as the index calls it
    (the 96 live features of the 128-wide rows) and over all 128, its plain
    version over a 64-query slice (stated; the full [512, N] plain block
    takes 16 GB at the 8-segment group), torch.matmul of the same product
    over the live columns ([512, 96] x [96, N]: library_ms) and over all 128
    (library_padded_ms), and the bound:
    bytes (x's live columns, aux and the per-query terms read once, the f32
    pool written once) over the memory rate, or three split-bf16 passes of
    the live product over the bf16 tensor-core rate; the same at the padded
    D, and the 3xTF32 ceilings (three TF32 passes at the TF32 peak)."""
    import torch

    out = {}
    for segs in (8, 2):
        case = _deep_case(f"deep {segs}", segs, seed=30 + segs)
        q, x, valid = case["q"], case["x"], case["valid"]
        q_in, aux, mult, qn2, _step, geom = exact_ops.packed_pool_inputs(
            q, x, valid, "L2", d_live=96)
        iters = 5 if segs == 8 else 10
        ms = _time_ms(lambda: exact_ops.exact_pool_packed_cuda(
            q_in, x, aux, mult, qn2, **geom), iters)
        ms_pad = _time_ms(lambda: exact_ops.exact_pool_packed_cuda(
            q_in, x, aux, mult, qn2, **dict(geom, d_live=None)), iters)
        s = slice(0, 64)
        plain64 = _time_ms(lambda: exact_ops.exact_pool_packed_plain(
            q_in[s].contiguous(), x, aux, mult[s].contiguous(),
            qn2[s].contiguous(), **geom), 2, 1)
        lib_pad = _time_ms(lambda: torch.matmul(q_in, x.T), 5, 1)
        lib = _time_ms(lambda: torch.matmul(q_in[:, :96], x[:, :96].T), 5, 1)
        qn, n, w = q.shape[0], x.shape[0], geom["w"]
        line = {}
        for d in (96, 128):
            nbytes = n * d * 4 + n * 4 + qn * d * 4 + qn * 8 + qn * w * 4
            flops = 2 * qn * n * d
            bytes_ms = nbytes / peaks["bytes_s"] * 1e3
            ops_ms = 3 * flops / peaks["bf16"] * 1e3
            line[d] = dict(
                flops=flops, bound=max(bytes_ms, ops_ms), bytes_ms=bytes_ms,
                ops_ms=ops_ms, tf32_ms=3 * flops / peaks["tf32"] * 1e3,
                by="operations" if ops_ms >= bytes_ms else "bytes")
        live, pad = line[96], line[128]
        _log(f"timing exact_pool_packed {tag}: Q {qn} x N {n:,} x D 128 "
             f"(fold {geom['fold']}, W {w:,}): kernel over the 96 live "
             f"features {ms:.3f} ms ({live['flops'] / ms / 1e9:.1f} useful "
             f"TFLOP/s; 3xTF32 ceiling {live['tf32_ms']:.3f} ms; bound "
             f"{live['bound']:.3f} ms, operations {live['ops_ms']:.3f} ms as 3 "
             f"split-bf16 passes of {live['flops'] / 1e12:.3f} TFLOP, bytes "
             f"{live['bytes_ms']:.3f} ms), over all 128 {ms_pad:.3f} ms "
             f"({pad['flops'] / ms_pad / 1e9:.1f} useful TFLOP/s; 3xTF32 "
             f"ceiling {pad['tf32_ms']:.3f} ms; bound {pad['bound']:.3f} ms); "
             f"plain over 64 queries {plain64:.3f} ms; torch.matmul of the "
             f"same product over the 96 live columns {lib:.3f} ms, over all "
             f"128 {lib_pad:.3f} ms")
        key = "" if segs == 8 else "_2seg"
        out.update({
            f"ms{key}": ms, f"ms_padded{key}": ms_pad,
            f"plain_ms{key}": plain64, f"library_ms{key}": lib,
            f"library_padded_ms{key}": lib_pad, f"bound_ms{key}": live["bound"],
            f"bound_padded_ms{key}": pad["bound"],
        })
        out.setdefault("bound_by", live["by"])
        del case, q, x, valid, q_in, aux
        torch.cuda.empty_cache()
    out["plain_queries"] = 64
    out["d_live"] = 96
    return out


# ------------------------------------------------------------------ main


def main() -> int:
    # one card: on a host with several, only the first visible one is used,
    # so the device count reported on the last line is the count the run used
    os.environ["CUDA_VISIBLE_DEVICES"] = (
        os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]
    )
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "vectorsearch_torch")):
        print("chip_smoke: run from a checkout of the repository "
              "(vectorsearch_torch/ not found next to this script)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import numpy as np

    import vectorsearch_torch as tvs
    from vectorsearch_torch.ops import adc as adc_ops
    from vectorsearch_torch.ops import exact as exact_ops
    from vectorsearch_torch.ops import traversal as traversal_ops
    from vectorsearch_torch.utils import cuda_build

    t_start = time.time()
    # 1. environment
    card = _card_line()
    name = torch.cuda.get_device_name(0)
    peaks = _PEAKS["pcie" if "PCIe" in card else "sxm"]
    _log(f"card: {card}")
    _log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
         f"python {sys.version.split()[0]}")
    nvcc = subprocess.run([cuda_build.nvcc(), "--version"], capture_output=True,
                          text=True, timeout=60)
    _log("nvcc: " + nvcc.stdout.strip().splitlines()[-1])
    tag = f"[{card}]"

    # 2. build: every library, one nvcc each, all started together
    t0 = time.time()
    built = _build_all()
    for src, (path, compiler_out, secs) in sorted(built.items()):
        _log(f"build {tag}: {os.path.relpath(path, REPO)} in {secs:.1f} s")
        if src == "adc":  # one line per form, line width and FULL flag
            for line in _adc_ptxas(compiler_out):
                _log(f"  ptxas {tag}: {line}")
            continue
        for line in compiler_out.splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                _log("  ptxas: " + line.strip())
    cuda_build.load("exact_pool_tc", exact_ops._bind_tc)
    adc_ops._load_kernel()
    _log(f"build {tag}: every library in {time.time() - t0:.1f} s")
    # B1 and B2 run on the tensor cores: warpgroup MMA in each instantiation
    # of their kernel (its last template argument is B2's PACKED flag)
    mmas = _warpgroup_mmas(built["exact_pool_tc"][0], "exact_pool_tc_kernel")
    for fn, n in sorted(mmas.items()):
        _log(f"sass {tag}: {fn}: {n} HGMMA")
    flags = {fn: _packed_flag(fn) for fn in mmas}
    if None in flags.values():
        raise AssertionError(
            f"exact_pool_tc_kernel: no PACKED flag in "
            f"{[fn for fn, f in flags.items() if f is None]}")
    for flag, kname in ((False, "B1"), (True, "B2")):
        mine = [n for fn, n in mmas.items() if flags[fn] is flag]
        if not mine or min(mine) == 0:
            raise AssertionError(
                f"exact_pool_tc_kernel: {kname} has an instantiation without "
                f"HGMMA instructions, or none: {mmas}")

    # 3. kernel vs plain version on the card (launches here are comparisons;
    # the counts are set to 0 before each run of phase 4)
    cases = [
        _case("sift1m 8-segment group (L2)", 8 * 100_096, "L2", seed=1, segs=8),
        _case("sift1m 2-segment group (L2)", 2 * 100_096, "L2", seed=4, segs=2),
        _case("ACTIVE brute table, 20,000 of 100,096 rows valid (L2)", 100_096,
              "L2", seed=5, live_rows=20_000),
        _case("cosine, zero-norm row", 2 * 100_096, "COSINE", seed=2,
              zero_row=True, alive_frac=0.9),
        _case("tail tile, dead bins (L2)", 50_123, "L2", seed=3,
              alive_frac=0.02),
        _deep_case("Deep10M ACTIVE brute table, 1,000,064 rows (L2)", 1,
                   seed=23),
    ]
    max_err = {name_: 0.0 for name_, _s, _r in _KERNELS}
    for case in cases:
        err, report = _check_pool(case, exact_ops, traversal_ops)
        max_err["exact_pool"] = max(max_err["exact_pool"], err)
        _log(f"kernel vs plain {tag}: {report}")
    sift_case, two_case, deep_brute = cases[0], cases[1], cases[5]
    del cases
    # the packed kernel (B2): the Deep10M subgroups' shapes as the index calls
    # them (96 live features: 128 queries a tile), the 2-segment group over
    # all 128 (64 queries a tile), then cosine, a tail and an explicit
    # geometry; each case made and freed in turn
    max_level_diff = 0
    packed_cases = [
        (lambda: _deep_case("Deep10M 2-segment group, all 128 features (L2)",
                            2, seed=21), {}),
        (lambda: _deep_case("Deep10M 8-segment group, 96 live features (L2)",
                            8, seed=22), dict(plain_q=64, d_live=96)),
        (lambda: _case("cosine, zero-norm row", 2 * 100_096, "COSINE", seed=2,
                       zero_row=True, alive_frac=0.9), {}),
        (lambda: _case("tail tile, dead bins, fold 1 (L2)", 50_123, "L2",
                       seed=3, alive_frac=0.02), {}),
        (lambda: _case("explicit tile 512, fold 2 (L2)", 100_096, "L2", seed=6,
                       alive_frac=0.98), dict(tile_n=512, fold=2)),
        (lambda: _deep_case("Deep10M 2-segment group, 96 live features (L2)",
                            2, seed=24), dict(d_live=96)),
    ]
    for make, kw in packed_cases:
        err, level, report = _check_packed(make(), exact_ops, traversal_ops, **kw)
        max_err["exact_pool_packed"] = max(max_err["exact_pool_packed"], err)
        max_level_diff = max(max_level_diff, level)
        _log(f"kernel vs plain {tag}: packed {report}")
        torch.cuda.empty_cache()
    adc_cases = [
        _adc_case("ADC sift1m segment", 100_096, seed=11, pad_from=100_000),
        _adc_case("ADC segment under 16,384 rows", 10_112, seed=12,
                  pad_from=10_000),
        _adc_case("ADC tail, ~2% valid, dead bins", 50_123, seed=13, frac=0.02),
        _adc_case("ADC wide LUT (M 64, K 256, D 256)", 100_096, seed=14, m=64,
                  d=256, pad_from=100_000),
        _adc_case("ADC ties, integer-valued LUT", 100_096, seed=15,
                  pad_from=100_000, ties=True),
        _adc_case("ADC small batch, narrow lines (Q 9, M 12, K 100)", 20_123,
                  seed=16, qn=9, m=12, k=100, d=96, frac=0.7),
    ]
    for case in adc_cases:
        errs, report = _check_adc(case, adc_ops)
        for key, v in errs.items():
            max_err[key] = max(max_err[key], v)
        _log(f"kernel vs plain {tag}: {report}")
    adc_sift, adc_small = adc_cases[0], adc_cases[1]
    del adc_cases
    torch.cuda.empty_cache()
    _log(f"phases 1-3 {tag}: {time.time() - t_start:.1f} s")

    # 4. end to end on sift1m
    x, q, rng = _sift1m_data()
    truth = _ground_truth(x, q[:128], 10)
    launches = _Launches()
    tables: list[str] = []  # the profiles' full tables
    flat_params = tvs.SearchParams(
        ef_search=150, beam_width=128, max_iters=6, max_explore=150,
        mode=tvs.Mode.BEST_FIRST,
    )

    # 4a. exact mode
    idx, gids, build_s = _build(tvs, x, tvs.MemoryStorage(), "exact", 100_000)
    try:
        _log(f"sift1m exact index {tag}: 1,000,000 x 128, "
             f"{len(idx.store.snapshot_segments())} segments, "
             f"build+seal {build_s:.1f} s")
        exact_counts, exact_recall = _serve_checks(
            "sift1m exact", idx, x, q, gids, truth, tag, launches,
            kernel="exact_pool", want_per_batch=2, min_recall=0.99,
        )
        exact_per_batch = exact_counts["exact_pool"]
        _profile("sift1m exact", idx, q, None, tag, launches, tables)
        # the brute route: an ACTIVE segment of 20,000 rows (>= 16,384)
        extra = x[:20_000] + rng.normal(size=(20_000, 128)).astype(np.float32)
        new_gids = idx.add_all(extra)
        (got2, _s2, _d2), c = launches.run(
            lambda: idx.query_batch_arrays(extra[:512], 10)
        )
        brute_launches = c["exact_pool"]
        if brute_launches != exact_per_batch + 1:
            raise AssertionError(
                f"brute route: {brute_launches} launches, expected "
                f"{exact_per_batch + 1}"
            )
        if not (got2[:, 0] == np.asarray(new_gids[:512])).all():
            raise AssertionError("brute route: appended rows not found")
        _log(f"brute route {tag}: ACTIVE segment of 20,000 rows, kernel "
             f"launches in that batch {brute_launches} (the sealed subgroups' "
             f"{exact_per_batch} and the brute table's 1), each query's own "
             f"new row ranks first")
    finally:
        idx.close()
    del idx
    torch.cuda.empty_cache()

    # 4b. flat mode, per-segment pools (B3): the all-defaults config, so
    # every seal trains PQ and builds the graph on the card
    storage = tvs.MemoryStorage()
    seal_s: list[float] = []
    with _GraphBuildTimer() as graph_timer:
        idx, gids, build_s = _build(tvs, x, storage, "flat", 100_000, seal_s)
    try:
        segs = idx.store.snapshot_segments()
        sealed = [s for s in segs if s.state.value == "SEALED"]
        if len(sealed) != 10 or sealed[0].codes_np.shape[1] != 16:
            raise AssertionError("sift1m flat: expected 10 PQ-sealed segments")
        if len(graph_timer.seconds) != 10:
            raise AssertionError("sift1m flat: expected 10 graph builds")
        mean_degree = _check_graphs(sealed, 32)
        _log(f"sift1m flat index {tag}: 1,000,000 x 128, {len(segs)} "
             f"segments, add + build+seal {build_s:.1f} s; each seal (PQ "
             f"M 16 x K 256, 5 iterations, and encoding, then the graph: "
             f"degree 32, breadth 64, alpha 1.2, on the card), PQ / graph "
             f"seconds: " + ", ".join(
                 f"{t - g:.2f} / {g:.2f}"
                 for t, g in zip(seal_s, graph_timer.seconds))
             + f"; adjacency checked (no self edge, ids < cap_pad, every "
             f"live row with an edge), mean filled degree {mean_degree:.2f}")
        flat_counts, flat_recall = _serve_checks(
            "sift1m flat", idx, x, q, gids, truth, tag, launches,
            kernel="adc_pool", want_per_batch=10, min_recall=0.97,
            params=flat_params,
        )
        (rate, lo, hi), _c = launches.run(lambda: _measure_qps(
            idx, np.concatenate([q] * 8), 10, flat_params, clients=1))
        _log(f"sift1m flat serving {tag}: {rate:.1f} QPS median of 4 windows "
             f"[{lo:.1f}, {hi:.1f}], 1 client, 512-query batches, k=10")
        _profile("sift1m flat", idx, q, flat_params, tag, launches, tables)
    finally:
        idx.close()
    del idx
    torch.cuda.empty_cache()

    # 4c. unified flat: the same sealed segments reopened (nothing trained
    # again), one ADC top-ef per power-of-two subgroup (8 + 2) through B5
    t0 = time.time()
    idx = _open_index(tvs, storage, "flat", 100_000, unified_search=True)
    try:
        _log(f"sift1m unified flat {tag}: reopened in {time.time() - t0:.1f} s")
        unified_counts, unified_recall = _serve_checks(
            "sift1m unified flat", idx, x, q, gids, truth, tag, launches,
            kernel="adc_scan", want_per_batch=10, min_recall=0.85,
            params=flat_params, qps=False,
        )
        _profile("sift1m unified flat", idx, q, flat_params, tag, launches,
                 tables, clients=False)
    finally:
        idx.close()
    del idx
    torch.cuda.empty_cache()

    # 4c-graph. graph mode: the same seals reopened (nothing trained or
    # built again), per segment a B5-fast scan, seeds, the traversal and
    # the exact re-rank; then BEAM, RANDOM_PIVOTS and the unified graph
    graph = _graph_phase(tvs, traversal_ops, storage, x, q, gids, truth, tag,
                         launches, tables, flat_params)
    del storage
    torch.cuda.empty_cache()

    # 4c-knn. the graph build's fused kNN route (segments of 262,144 rows
    # or more): 4 blocks of 512 rows over the first 300,000 sift1m rows
    # through _knn_block_fused (B1) against _knn_block on the same blocks
    knn = _knn_phase(x, tag, launches)

    # 4d. small-segment flat: 100,000 rows in 10,000-row segments (B4)
    xs = np.ascontiguousarray(x[:100_000])
    small_truth = _ground_truth(xs, q[:128], 10)
    idx, sgids, build_s = _build(tvs, xs, tvs.MemoryStorage(), "flat", 10_000)
    try:
        _log(f"small-segment flat index {tag}: 100,000 x 128 in 10,000-row "
             f"segments, build+seal {build_s:.1f} s")
        small_counts, small_recall = _serve_checks(
            "small-segment flat", idx, xs, q, sgids, small_truth, tag, launches,
            kernel="adc_scores", want_per_batch=10, min_recall=0.97,
            params=flat_params, qps=False,
        )
        _profile("small-segment flat", idx, q, flat_params, tag, launches,
                 tables, clients=False)
    finally:
        idx.close()
    del idx, x, xs
    torch.cuda.empty_cache()

    # 4e. Deep10M under churn: B2 on the 8- and 2-segment subgroups,
    # vacuum and a compaction under serving; its host and device memory
    # are freed before phase 5
    deep = _deep10m(tvs, exact_ops, tag, launches, tables)
    gc.collect()
    torch.cuda.empty_cache()
    for kname in ("exact_pool", "exact_pool_packed", "adc_pool", "adc_scores",
                  "adc_scan"):
        if launches.total[kname] < 1:
            raise AssertionError(f"{kname} was not launched on the main path")
    if graph["counts"]["adc_scan"] != 10 or knn["launches"] != 4:
        raise AssertionError("the graph routes did not launch B5-fast / B1")
    _log(f"main path launches {tag}: {launches.total}")
    out_dir = os.path.join(REPO, "_profiles")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke_profile.txt"), "w") as f:
        f.write("\n".join(tables) + "\n")

    # 5. timings at the sift1m shapes
    qc, xc, vc = sift_case["q"], sift_case["x"], sift_case["valid"]
    q_in, aux, geom = exact_ops.pool_inputs(qc, xc, vc, "L2")
    kernel_ms = _time_ms(lambda: exact_ops.exact_pool_cuda(q_in, xc, aux, **geom), 10)
    plain_ms = _time_ms(lambda: exact_ops.exact_pool_plain(q_in, xc, aux, **geom), 3, 1)
    library_ms = _time_ms(lambda: torch.matmul(q_in, xc.T), 10)
    # the other pool shape of a sift1m batch: the 2-segment group
    x2 = two_case["x"]
    q2_in, aux2, geom2 = exact_ops.pool_inputs(
        two_case["q"], x2, two_case["valid"], "L2"
    )
    two_ms = _time_ms(lambda: exact_ops.exact_pool_cuda(q2_in, x2, aux2, **geom2), 10)
    # and the Deep10M batch's: its ACTIVE brute table
    q3_in, aux3, geom3 = exact_ops.pool_inputs(
        deep_brute["q"], deep_brute["x"], deep_brute["valid"], "L2"
    )
    deep_ms = _time_ms(lambda: exact_ops.exact_pool_cuda(
        q3_in, deep_brute["x"], aux3, **geom3), 10)
    # rows of a published 3,072-feature embedding width: the kernel's
    # streamed form (the query tile does not fit in shared memory); off the
    # main path, timed beside torch.matmul of the same product
    gw = torch.Generator(device="cuda").manual_seed(31)
    xw = torch.randn((100_096, 3072), generator=gw, device="cuda")
    qw = torch.randn((512, 3072), generator=gw, device="cuda")
    qw_in, auxw, geomw = exact_ops.pool_inputs(
        qw, xw, torch.ones(xw.shape[0], dtype=torch.bool, device="cuda"), "L2"
    )
    wide_ms = _time_ms(lambda: exact_ops.exact_pool_cuda(qw_in, xw, auxw, **geomw), 10)
    wide_lib_ms = _time_ms(lambda: torch.matmul(qw_in, xw.T), 10)
    del xw, qw, qw_in, auxw
    qn, n, d, w = qc.shape[0], xc.shape[0], xc.shape[1], geom["w"]
    bytes_moved = n * d * 4 + n * 4 + qn * d * 4 + qn * w * 8
    flops = 2 * qn * n * d
    bytes_ms = bytes_moved / peaks["bytes_s"] * 1e3
    # the least time for this work at the precision it needs: three
    # split-bf16 tensor-core passes (plain TF32 is not precise enough); the
    # kernel's own form, three TF32 passes, has a ceiling twice as high
    ops_ms = 3 * flops / peaks["bf16"] * 1e3
    tf32_ms = 3 * flops / peaks["tf32"] * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    _log(f"timing exact_pool {tag}: kernel {kernel_ms:.3f} ms, plain "
         f"{plain_ms:.3f} ms, torch.matmul of the same product "
         f"{library_ms:.3f} ms, bound {bound_ms:.3f} ms (operations: 3 "
         f"split-bf16 passes of {flops / 1e9:.1f} GFLOP; bytes "
         f"{bytes_ms:.3f} ms), 3xTF32 ceiling {tf32_ms:.3f} ms at "
         f"{peaks['tf32'] / 1e12:.0f} TFLOP/s; kernel {flops / kernel_ms / 1e9:.1f} "
         f"useful TFLOP/s ({3 * flops / kernel_ms / 1e9:.1f} on the tensor "
         f"cores); kernel at the 2-segment group (N 200,192, fold "
         f"{geom2['fold']}) {two_ms:.3f} ms; at the Deep10M brute table "
         f"(N {deep_brute['x'].shape[0]:,}, fold {geom3['fold']}) {deep_ms:.3f} ms; "
         f"at Q 512 x N 100,096 x D 3,072 (streamed query tile) {wide_ms:.3f} ms, "
         f"torch.matmul {wide_lib_ms:.3f} ms")
    del sift_case, two_case, deep_brute
    torch.cuda.empty_cache()
    timings = {"exact_pool": dict(
        ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by="operations" if ops_ms >= bytes_ms else "bytes",
        library_ms=library_ms, ms_2seg=two_ms, ms_deep10m_brute=deep_ms,
    )}
    timings["exact_pool_packed"] = _packed_timings(exact_ops, peaks, tag)
    adc_times, adc_extra = _adc_timings(adc_sift, adc_ops, peaks)
    timings.update(adc_times)
    for kname in _ADC_NAMES:
        t, x = timings[kname], adc_extra[kname]
        _log(f"timing {kname} {tag}: Q 512 x N 100,096 x M 16 x K 256: kernel "
             f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, one-hot "
             f"torch.matmul {t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} "
             f"ms ({t['bound_by']}), lookup ceiling (bank reads) "
             f"{x['lookup_ceiling_ms']:.4f} ms, kernel on codes equal in every "
             f"row {x['same_codes_ms']:.4f} ms")
    # B4 at its route (a segment under 16,384 rows): its figures in the
    # kernels line, the sift1m segment's beside them
    route, route_extra = _adc_timings(adc_small, adc_ops, peaks,
                                      names=("adc_scores",), graph=True)
    t, x = route["adc_scores"], route_extra["adc_scores"]
    _log(f"timing adc_scores {tag}: at its route, Q 512 x N 10,112 x M 16 x K "
         f"256, CUDA graphs of 20 calls: kernel {t['ms']:.4f} ms, plain "
         f"{t['plain_ms']:.4f} ms, one-hot torch.matmul {t['library_ms']:.4f} "
         f"ms, bound {t['bound_ms']:.4f} ms ({t['bound_by']}), lookup ceiling "
         f"(bank reads) {x['lookup_ceiling_ms']:.4f} ms, kernel on codes equal "
         f"in every row {x['same_codes_ms']:.4f} ms")
    timings["adc_scores"] = dict(t, **{
        f"{key}_sift_segment": v for key, v in adc_times["adc_scores"].items()
        if key != "bound_by"})
    small_scores_ms = [_time_ms(lambda: adc_ops.adc_scores_cuda(
        adc_ops.lut_bf16(adc_small["lut"]), adc_small["codes"],
        adc_small["valid"]), 20) for _ in range(5)]
    _log(f"timing adc_scores {tag}: at the small segment (N 10,112), five "
         f"host-loop timings (the LUT to bf16, then the kernel): "
         f"{', '.join(f'{v:.4f}' for v in small_scores_ms)} ms")
    cands = _chunk_candidates(adc_small, adc_ops)
    _log(f"timing adc_scores {tag}: chunk candidates at N 10,112 in turns, "
         f"CUDA graphs of 20 calls: " + "; ".join(
             f"{cols:,} columns {', '.join(f'{v:.4f}' for v in ms)} ms"
             for cols, ms in cands.items()))

    # per kernel: the most launches one 512-batch of any path made
    per_batch = {
        kname: max(c[kname] for c in (exact_counts, flat_counts,
                                      unified_counts, graph["counts"],
                                      graph["unified_counts"], small_counts,
                                      deep["per_batch"]))
        for kname, _s, _r in _KERNELS
    }
    entries = []
    for kname, src, replaces in _KERNELS:
        entries.append({
            "name": kname,
            "route": "cuda",
            "source": f"vectorsearch_torch/csrc/{src}.cu",
            "replaces": replaces,
            "launches": launches.total[kname],
            "launches_per_batch": per_batch[kname],
            "max_abs_err": max_err[kname],
            **timings[kname],
        })
    entries[0]["brute_launches"] = brute_launches
    entries[0]["knn_route_launches"] = knn["launches"]
    entries[1]["max_level_diff"] = max_level_diff
    entries[4]["graph_launches_per_batch"] = graph["counts"]["adc_scan"]
    _log(f"recall@10 {tag}: exact {exact_recall:.4f}, flat {flat_recall:.4f}, "
         f"unified flat {unified_recall:.4f}, graph {graph['recall']:.4f} "
         f"(BEAM {graph['beam_recall']:.4f}, RANDOM_PIVOTS "
         f"{graph['pivots_recall']:.4f}, unified graph "
         f"{graph['unified_recall']:.4f}), small-segment flat "
         f"{small_recall:.4f}, deep10m exact {deep['recall']:.4f} (self-recall "
         f"after churn {deep['self_recall']:.4f}); deep10m QPS "
         f"{deep['qps']:.1f} idle, {deep['churn_qps']:.1f} under churn; whole "
         f"run {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": entries}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
