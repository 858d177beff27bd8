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
   form, line width and FULL flag; B2's pipelined form one line per query
   tile and B1's and B2's wide forms, a spill or other than 168 registers
   fails), and counts the warpgroup MMA (HGMMA) instructions in the SASS
   (cuobjdump) of every instantiation of the exact pools' kernels, B1's
   narrow and wide forms and B2's pipelined and wide forms: none in any of
   them, or no instantiation of one, fails; beside them it builds the exact
   pool's copy-only variant (EXACT_POOL_FEED_ONLY) for phase 5;
3. kernel vs plain on the card:
   - the exact-pool kernel (B1) at every shape a sift1m exact batch gives it
     (Q 512, D 128, L2: the 8-segment group, N 800,768, fold 8; the
     2-segment group, N 200,192, fold 2; the ACTIVE brute table, N 100,096
     with its first 20,000 rows valid, fold 1) and a Deep10M batch gives it
     (its ACTIVE brute table: N 1,000,064, D 128 from 96 unit features,
     fold 8), a gist1m batch gives it (Q 512, 960 clustered features
     zero-padded to 1,024 lanes and read over the 960 live ones, L2: the
     8- and the 2-segment group, the wide form at 64 queries a block with
     chunk sums, which the launch's counter must read, its scores held to
     3e-6 x scale where the others are held to 1e-5, since one accumulator
     over its 30 chunks read 7e-6 there), a cosine case
     with a zero-norm row, and a tail case (N not a multiple of the tile,
     invalid rows, dead bins);
   - the packed exact-pool kernel (B2) at the Deep10M subgroups' shapes
     (Q 512, D 128 from 96 unit features, L2, ~2% invalid rows: the
     8-segment group, N 8,000,512, whose plain side runs over 64 queries,
     and the 2-segment group, N 2,000,128, each with the kernel reading only
     the 96 live features (d_live, as the index calls it), and the 2-segment
     group over all 128), a cosine case with a zero-norm row, a tail case
     with dead bins and fold 1 and an explicit tile 512, fold 2 geometry,
     and B2's wide form at the Cohere10M subgroups' shapes (768 features
     near unit centres, under COSINE and L2, a zero row, ~2% of the rows
     and the pad rows left out, the second pool group's rows all left out:
     the 8-segment group, N 8,000,512, at Q 512 with the plain side over
     the first and the last 32 queries, and the 2-segment group, N
     2,000,128, at Q 200, whose last query tile holds 8 queries, the plain
     side over all 200); the packed planes compare level by level (within
     one quantization step) and slot by slot, then the decoded top-k; each
     check names the form the launch took (the registry's counter; the
     Cohere10M cases must take the wide form); then B2's timings (the
     kernel at the Deep10M subgroups' shapes, its plain version over 64
     queries, torch.matmul, its bound and 3xTF32 ceiling, and the pipelined
     form's registers and spills beside them; the wide form at the Cohere10M
     groups under COSINE, torch.matmul, its bound and 3xTF32 ceiling; phase
     5 lists what);
   - the ADC kernels (B3 pool, B4 scores, B5 scan, B5 precise scan) at the
     sift1m segment shape (Q 512, M 16, K 256, N 100,096), a segment under
     16,384 rows (N 10,112), a tail case (N 50,123, ~2% valid rows, dead
     bins, B4's pad columns), a wide LUT (M 64, K 256, D 256), an
     integer-valued LUT whose sums tie often and a small batch on narrow
     lines (Q 9, N 20,123, M 12, K 100), and openai500k.batch512's LUT
     (Q 512, M 192, K 256, D 1,536, N 100,096: two queries a line, B3's
     widest LUT); all four bit-identical to their plain versions, pool ids
     in every live bin included;
   - the flat re-rank's cosine branch at 1,536 features (openai500k's
     shape: unit rows near unit centres, Q 512, two segments' candidates of
     256, a zero row and a zero query) against float64: distances within
     1e-6, the zero-norm rule's distance 1 exactly;
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
   - a mesh of 4 shards on the one card (make_mesh([cuda:0] * 4), config
     mesh; 25,024 rows a shard): exact mode, B1 once a shard a segment (40
     a batch), recall >= 0.99 and ids equal to the exact index's on
     margin-separated queries (a difference is allowed only where a route's
     binned pool held two true neighbours in one bin, which both packages'
     pools do); flat mode with PQ-only seals (the sharded k-means and
     encoding, each seal's seconds beside the single-device PQ seconds), B4
     once a shard a segment (40 a batch), recall >= 0.97; one-client
     latency and QPS each; the sharded encoder equal to pq_encode on the
     card given the same codebook;
   - round_robin placement over the exact and flat seals, reopened (every
     segment on cuda:0; the per-device groups and per-segment routes run,
     and the results, all on the one card, merge there): exact ids as the
     default placement's (the same bin rule), flat ids and scores equal;
     the host merge that results on several cards take, held to the
     device merge on the same entries on the card;
   - query_async: 8 client threads of single queries for 3 s against the
     exact index through the QueryBatcher: QPS, the batch sizes it formed,
     recall >= 0.99; five batches with query_breakdown_sample_every=1 on
     the flat and the graph index: the medians of pq_scan_ms,
     graph_traversal_ms and rerank_ms, the sampled batches' ids equal to
     the unsampled one's;
   - the cluster router: two ClusterQueryServers in this process over
     DiskStorage (a temporary directory) holding the first 400,000 rows in
     exact mode, segment_shard (0, 2) and (1, 2), both on cuda:0, a
     ClusterClient routing 512-query batches equal to one process's answer
     (scores rtol 1e-5, ids save near-ties);
   each profile traces five one-client batches and (exact, flat, Deep10M)
   one 8-client window with torch.profiler: wall and device time per batch,
   the card's busy share, device operations and kernel-launch calls per
   batch, top kernels (full tables in _profiles/chip_smoke_profile.txt,
   git-ignored); unified flat, graph and small-segment flat are profiled
   over the five one-client batches only;
5. timings at the sift1m shapes (B2's, at the Deep10M subgroups' shapes,
   taken in phase 3): each kernel, its plain version, one
   PyTorch call computing the same function where there is one (the library
   yardstick; the port never calls it) and the card's bound; for the four
   ADC kernels also their lookup ceiling (the shared-memory bank reads of
   their Q*N_valid*M lookups at 32 a cycle per SM, at the card's maximum SM
   clock; logged, not in the kernels line) and their time on codes that
   are the same in every row (every load one line: no bank conflict); B3
   also at openai500k.batch512's segment (M 192, two queries a line); B4
   at its route's N 10,112 (its figures in the kernels line: kernel and
   library timed as CUDA graphs of 20 calls, so the host's pace stays out),
   five host-loop timings there as earlier versions took them, and its
   chunk candidates side by side (the wrapper's chunk against 1,024
   columns, in turns); for B1 also its
   useful TFLOP/s, the ceiling of its 3xTF32 form at the TF32 peak, and its
   times at the 2-segment group, the Deep10M brute table and GIST1M's two
   groups of 960-feature rows in 1,024 lanes (its wide form over the 960
   live lanes, with the form and query tile its counter read, beside
   torch.matmul, which it must beat at the 8-segment group, the bound, the
   3xTF32 ceiling over the live lanes and the copy-only variant's feed in
   TB/s); for B2 its useful
   TFLOP/s, 3xTF32 ceiling and bound both at the padded D 128 and at the
   96 live features the index asks for, beside torch.matmul of the padded
   and of the live product, and its wide form's at Cohere10M's two groups
   (the bytes of its bound beside it: 24.9 and 6.2 GB at 3.35 TB/s).

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


# the exact pool's copy-only variant (csrc/exact_pool_tc.cu's
# EXACT_POOL_FEED_ONLY: B1's wide form with its consumers reading nothing),
# built beside the libraries to time the ring's feed in phase 5
_FEED_ONLY = ("EXACT_POOL_FEED_ONLY",)


def _build_all():
    """Builds every csrc/*.cu library and the exact pool's copy-only
    variant, one nvcc each, all started together; returns {source or
    "feed_only": (path, compiler output, seconds)}."""
    from vectorsearch_torch.utils import cuda_build

    jobs = [(src, src, ()) for src in sorted({src for _n, src, _r in _KERNELS})]
    jobs.append(("feed_only", "exact_pool_tc", _FEED_ONLY))

    def one(job):
        key, src, defines = job
        t0 = time.time()
        path, out = cuda_build.build(src, defines)
        return key, (path, out, time.time() - t0)

    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        return dict(pool.map(one, jobs))


_EXACT_FORM = re.compile(
    r"exact_pool_(?:tc_kernel"
    r"|pipelined_kernel(?:<(\d+)>|ILi(\d+)E)"
    r"|wide_kernel(?:<(true|false)>|ILb([01])E)|(query_planes)_kernel)")
# the forms that run on the tensor cores (every instantiation holds HGMMA)
_EXACT_FORMS = ("B1 narrow", "B1 wide", "B2 pipelined", "B2 wide")


def _exact_form(name):
    """(form, NQW) of an exact-pool kernel from its demangled or mangled
    name: B1's narrow form (exact_pool_tc_kernel<NQ>; NQW None), B2's
    pipelined form (exact_pool_pipelined_kernel<NQW>), B1's and B2's wide
    forms (exact_pool_wide_kernel<false> and <true>) or their prologue,
    which splits the query planes (exact_pool_query_planes_kernel, "B1
    query planes": no MMA); None for any other name."""
    m = _EXACT_FORM.search(name)
    if m is None:
        return None
    if m.group(1) or m.group(2):
        return "B2 pipelined", int(m.group(1) or m.group(2))
    if m.group(3) or m.group(4):
        return ("B2 wide" if m.group(3) == "true" or m.group(4) == "1"
                else "B1 wide"), None
    if m.group(5):
        return "B1 query planes", None
    return "B1 narrow", None


def _pipelined_ptxas(compiler_out):
    """{form: (registers, spill store bytes)} of every instantiation of the
    warp-specialised forms ("B2 pipelined NQW <n>", "B1 wide", "B2 wide"),
    from nvcc's ptxas -v output."""
    out, key, spill = {}, None, None
    for line in compiler_out.splitlines():
        if "Compiling entry" in line:
            form = _exact_form(line)
            key = None
            if form and form[0] == "B2 pipelined":
                key = f"B2 pipelined NQW {form[1]}"
            elif form and form[0] in ("B1 wide", "B2 wide"):
                key = form[0]
            spill = None
        elif key is not None and "spill stores" in line:
            spill = int(line.split("bytes spill stores")[0].split(",")[-1])
        elif key is not None and "Used" in line and "registers" in line:
            out[key] = (int(line.split("Used", 1)[1].split("registers")[0]), spill)
            key = None
    return out


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
          d=128, live_d=None, segs=None, live_rows=None, rtol=1e-5,
          form=None):
    """Clustered rows and queries made on the card from a seed. `live_d`:
    only the first features are drawn, the rest are zeros (rows padded to
    their lanes, as a segment stores them), and the kernel reads only them
    (d_live, as the index calls it); `form`: the form B1's launch must
    count (the registry's counter), if given; `segs`: a stack of that many
    100,000-row segments; `live_rows`: only the first rows are valid (an
    ACTIVE segment's brute table); `rtol`: `_check_pool`'s tolerance over
    the case's scale."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    centers = torch.randn(2048, d, device="cuda", generator=g) * 4
    x = centers[torch.randint(0, 2048, (n,), device="cuda", generator=g)]
    x = (x + torch.randn(n, d, device="cuda", generator=g)).contiguous()
    q = centers[torch.randint(0, 2048, (qn,), device="cuda", generator=g)]
    q = q + torch.randn(qn, d, device="cuda", generator=g)
    if live_d is not None:
        x[:, live_d:] = 0.0
        q[:, live_d:] = 0.0
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
    return dict(name=name, q=q, x=x, valid=valid, metric=metric, rtol=rtol,
                live_d=live_d, form=form)


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
    """Kernel vs plain version on one case, scores within the case's rtol
    (1e-5 unless it sets one) x scale; returns (max_abs_err, report)."""
    import torch

    from vectorsearch_torch.ops.distance import matmul_nt

    from vectorsearch_torch.utils.metrics import get_registry

    q, x, valid, metric = case["q"], case["x"], case["valid"], case["metric"]
    q_in, aux, geom = exact_ops.pool_inputs(q, x, valid, metric,
                                            d_live=case.get("live_d"))
    reg = get_registry()
    before = reg.snapshot()["counters"]
    ks, ki = exact_ops.exact_pool_cuda(q_in, x, aux, **geom)
    forms = sorted(k[len(exact_ops.LAUNCHES):] for k, v in
                   reg.snapshot()["counters"].items()
                   if k.startswith(exact_ops.LAUNCHES + "{")
                   and v > before.get(k, 0.0))
    if case.get("form") and not (len(forms) == 1
                                 and f"'form': '{case['form']}'" in forms[0]):
        raise AssertionError(f"{case['name']}: B1 took {forms}, not {case['form']}")
    ps, pi = exact_ops.exact_pool_plain(q_in, x, aux, **geom)
    torch.cuda.synchronize()
    qn = q.norm(dim=1)
    mx = torch.sqrt(torch.where(valid, (x * x).sum(1), 0.0).max())
    scale = qn if metric == "COSINE" else 2 * qn * mx + mx * mx
    tol = (case.get("rtol", 1e-5) * scale)[:, None]  # per query
    live = torch.isfinite(ps)
    if not torch.equal(live, torch.isfinite(ks)):
        raise AssertionError(f"{case['name']}: dead bins differ")
    err = torch.where(live, (ks - ps).abs(), 0.0)
    max_err = float(err.max())
    if bool((err > tol).any()):
        raise AssertionError(
            f"{case['name']}: pool score error {max_err} above tolerance"
        )
    # ids: equal in every bin whose best and second best differ by > tol;
    # in every live bin the kernel's row lies in that bin and its full-f32
    # score is within 2 tol of the one the kernel reported (each within tol
    # of the exact score)
    n, span, bins = x.shape[0], geom["fold"] * geom["tile"], geom["bins"]
    ng = geom["w"] // bins
    cross = matmul_nt(q_in, x)  # full f32, as the plain version computes it
    s = cross * aux[0] + aux[1] if metric == "COSINE" else cross - aux[0]
    del cross

    def bin_of(rows):  # the pool column a row's bin takes
        rows = rows.long()
        return rows // span * bins + rows % span % bins

    def score_of(rows):  # full-f32 rank scores of rows (none: -inf)
        got = torch.gather(s, 1, rows.long().clamp(0, n - 1))
        return torch.where((rows >= 0) & (rows < n), got, float("-inf"))

    cols = torch.arange(geom["w"], device=ki.device).expand_as(ki)
    if not torch.equal(bin_of(ki)[live], cols[live]):
        raise AssertionError(f"{case['name']}: a kernel row lies outside its bin")
    if bool(((score_of(ki) - ks).abs() > 2 * tol)[live].any()):
        raise AssertionError(
            f"{case['name']}: a kernel score is not its row's score")
    top2 = torch.nn.functional.pad(
        s, (0, ng * span - n), value=float("-inf")
    ).view(q.shape[0], ng, span // bins, bins).topk(2, dim=2).values
    gap = (top2[:, :, 0] - top2[:, :, 1]).reshape(q.shape[0], -1)
    del top2
    sep = live & (torch.nan_to_num(gap, nan=0.0, posinf=float("inf")) > tol)
    if not torch.equal(ki[sep], pi[sep]):
        bad = int((ki[sep] != pi[sep]).sum())
        raise AssertionError(f"{case['name']}: {bad} separated bins differ in id")
    rows = ki[live].long()
    if not bool(valid[rows].all()):
        raise AssertionError(f"{case['name']}: an invalid row won a bin")
    # identical final top-k after stage 2 + exact_finalize, save near-ties:
    # neighbouring positions within 2 tol (their ids may swap), or one
    # position holding two rows of one pool bin whose full-f32 scores,
    # recomputed from the rows, lie within 2 tol (each version kept one)
    ef, k = 64, 10
    finals, ranks = [], []
    for outs, outi in ((ks, ki), (ps, pi)):
        top, pos = torch.topk(outs, min(ef, outs.shape[1]), dim=1)
        ids = torch.where(top > float("-inf"), torch.gather(outi, 1, pos), -1)
        finals.append(traversal_ops.exact_finalize(q, top, ids, k, metric))
        # the final rank scores and the first one past them
        ranks.append(torch.topk(top, k + 1, dim=1).values)
    (_ks, _kd, k_i), (_ps, _pd, p_i) = finals
    # a tie with the first row past the top-k counts too (either may be in)
    near = _near_ties(ranks[1], 2 * tol)[:, :k]
    differ = k_i != p_i
    binmate = (
        (k_i >= 0) & (p_i >= 0) & (bin_of(k_i) == bin_of(p_i))
        & ((score_of(k_i) - score_of(p_i)).abs() <= 2 * tol)
    )
    bad = differ & ~near & ~binmate
    mismatch = int(bad.sum())
    if mismatch:
        qi, j = (int(v) for v in bad.nonzero()[0])
        raise AssertionError(
            f"{case['name']}: {mismatch} final top-k ids differ; first at "
            f"query {qi} position {j}: kernel row {int(k_i[qi, j])} (bin "
            f"{int(bin_of(k_i[qi, j]))}, score {float(score_of(k_i)[qi, j])}), "
            f"plain row {int(p_i[qi, j])} (bin {int(bin_of(p_i[qi, j]))}, "
            f"score {float(score_of(p_i)[qi, j])}); rank scores kernel "
            f"{ranks[0][qi].tolist()}, plain {ranks[1][qi].tolist()}; tol "
            f"{float(tol[qi])}")
    del s
    report = (
        f"{case['name']}: {', '.join(forms)} N={n} d_live={geom['d_live']} "
        f"W={geom['w']} fold={geom['fold']} max_abs_err={max_err:.3e} sep_bins={int(sep.sum())}/{int(live.sum())} "
        f"final_ids_equal={int((k_i == p_i).sum())}/{k_i.numel()} "
        f"(near-tie positions {int(near.sum())}, differing ids of one bin "
        f"{int((differ & ~near & binmate).sum())})"
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


def _cohere_case(name, segs, metric, *, seed, qn=512):
    """A Cohere10M subgroup's table made on the card from a seed (the
    cohere10m-exact configuration's rows: 768 features near 4,096 unit
    centres, noise 0.02, not normalised; queries a centre plus 0.02 noise):
    `segs` segments of pad_cap(1,000,000) = 1,000,064 rows, the pad rows
    past 1,000,000 of each segment zero and invalid, ~2% of the rest
    invalid, row 7 zero and valid, and the rows of the second pool group
    (rows 8,192 .. 16,383 at tile 1,024 and fold 8) all invalid, so its
    bins (pool columns 128 .. 255) are dead."""
    import torch

    per, d = 1_000_064, 768
    n = segs * per
    g = torch.Generator(device="cuda").manual_seed(seed)
    centers = torch.randn(4096, d, device="cuda", generator=g)
    centers /= centers.norm(dim=1, keepdim=True)
    x = torch.empty(n, d, device="cuda")
    for off in range(0, n, 1_000_000):
        hi = min(off + 1_000_000, n)
        x[off:hi] = centers[torch.randint(0, 4096, (hi - off,), device="cuda",
                                          generator=g)]
        x[off:hi] += 0.02 * torch.randn(hi - off, d, device="cuda", generator=g)
    q = centers[torch.randint(0, 4096, (qn,), device="cuda", generator=g)]
    q += 0.02 * torch.randn(qn, d, device="cuda", generator=g)
    pad = torch.arange(n, device="cuda") % per >= 1_000_000
    x[pad] = 0.0
    x[7] = 0.0
    valid = (torch.rand(n, device="cuda", generator=g) < 0.98) & ~pad
    valid[7] = True
    valid[8 * 1024:16 * 1024] = False
    return dict(name=name, q=q.contiguous(), x=x, valid=valid, metric=metric,
                dead_cols=(128, 256), form="wide")


def _packed_forms(exact_ops, registry):
    """{form: B2 launches so far} from the port's registry counter."""
    return {f: registry.counter_value(exact_ops.PACKED_LAUNCHES, {"form": f})
            for f in ("pipelined", "wide")}


def _form_taken(before, after):
    """The one form whose count grew between two readings of _packed_forms."""
    grew = [f for f in before if after[f] > before[f]]
    if len(grew) != 1:
        raise AssertionError(f"B2 forms counted: {before} -> {after}")
    return grew[0]


def _check_packed(case, exact_ops, traversal_ops, *, plain_q=None, tile_n=None,
                  fold=None, d_live=None):
    """The packed kernel vs its plain version on one case (the plain side
    over `plain_q` queries when given, the first half and the last half, so
    a ragged last query tile is compared; `d_live`: the kernel reads only
    the first features, the rest being zero; the case's `form`, if given:
    the form the launch must count; its `dead_cols`, if given: pool columns
    that no live row reaches, dead in both planes). The planes: dead bins in
    the same places, quantized levels floor(p/F) within 1 step, and where
    the slots differ the kernel's row must be a near-winner (its own level,
    in the plain arithmetic, within 1 step of the plain winner's: a raw
    near-tie in a tile or two tiles on one step may resolve apart). Then
    the decoded top-k after stage 2 and exact_finalize: identical ids but
    at near-ties (2 steps). Returns (max level difference x step,
    max level difference, report)."""
    import torch

    q, x, valid, metric = case["q"], case["x"], case["valid"], case["metric"]
    from vectorsearch_torch.utils.metrics import get_registry

    q_in, aux, mult, qn2, step, geom = exact_ops.packed_pool_inputs(
        q, x, valid, metric, tile_n=tile_n, fold=fold, d_live=d_live
    )
    forms = _packed_forms(exact_ops, get_registry())
    kp = exact_ops.exact_pool_packed_cuda(q_in, x, aux, mult, qn2, **geom)
    form = _form_taken(forms, _packed_forms(exact_ops, get_registry()))
    if case.get("form") not in (None, form):
        raise AssertionError(f"{case['name']}: {form} form, not {case['form']}")
    qall = q.shape[0]
    nq = qall if plain_q is None else plain_q
    sel = torch.cat([torch.arange(nq // 2), torch.arange(qall - (nq - nq // 2), qall)]
                    ).to(q.device)
    q, q_in, mult, qn2, step = q[sel], q_in[sel], mult[sel], qn2[sel], step[sel]
    pp = exact_ops.exact_pool_packed_plain(
        q_in.contiguous(), x, aux, mult.contiguous(), qn2.contiguous(), **geom
    )
    torch.cuda.synchronize()
    k = kp[sel]
    live = torch.isfinite(pp)
    if not torch.equal(live, torch.isfinite(k)):
        raise AssertionError(f"{case['name']}: dead bins differ")
    if "dead_cols" in case:
        lo, hi = case["dead_cols"]
        if live[:, lo:hi].any() or not live.any():
            raise AssertionError(f"{case['name']}: a dead pool group has live bins")
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
    max_err = float(((kl - pl).abs() * step[:, None]).max())
    # stage 2 + decode + finalize on both planes
    ef, kk = 64, 10
    finals = []
    for plane in (k, pp):
        pv, pos = torch.topk(plane, ef, dim=1)
        s, r = exact_ops.decode_packed_pool(
            pv, pos, step, q, metric, d=q.shape[1], n=x.shape[0],
            qn=qall, tile_n=tile_n, fold=fold, min_w=16384,
        )
        finals.append(traversal_ops.exact_finalize(q, s, r, kk, metric))
    (k_s, _kd, k_i), (p_s, _pd, p_i) = finals
    # final scores are -distance (L2, one step = step) or the similarity
    # (cosine, one step = step / ||q||)
    tol = 2 * step
    if metric == "COSINE":
        tol = tol / torch.clamp(q.norm(dim=1), min=1e-30)
    near = _near_ties(p_s, tol[:, None])
    mismatch = int(((k_i != p_i) & ~near).sum())
    if mismatch:
        raise AssertionError(f"{case['name']}: {mismatch} final top-k ids differ")
    report = (
        f"{case['name']}: {form} form, Q={qall} (plain over {nq}) N={x.shape[0]} "
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


def _check_rerank_cosine(traversal_ops):
    """The flat re-rank's cosine branch at openai500k.batch512's width
    (1,536 features, unit rows near unit centres, queries a centre plus
    noise; Q 512, two segments' candidates of 256) against float64: the
    kept rows' distances within 1e-6 (float32's roundings of the sums and
    norms), a zero row at distance 1 exactly, a zero query at 1 from every
    row. Returns the report."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(19)
    n, d, qn, c = 100_096, 1536, 512, 256
    centres = torch.randn((64, d), generator=g, device="cuda")
    centres /= centres.norm(dim=1, keepdim=True)
    x = centres[torch.randint(0, 64, (n,), generator=g, device="cuda")]
    x = x + 0.02 * torch.randn((n, d), generator=g, device="cuda")
    x /= x.norm(dim=1, keepdim=True)
    x[3] = 0.0
    q = centres[torch.randint(0, 64, (qn,), generator=g, device="cuda")]
    q = q + 0.02 * torch.randn((qn, d), generator=g, device="cuda")
    q[-1] = 0.0
    cand = torch.randint(0, n, (2, qn, c), generator=g, device="cuda",
                         dtype=torch.int32)
    cand[:, :, 0] = 3
    alive = torch.ones(n, dtype=torch.bool, device="cuda")
    _sc, di, iv = traversal_ops.exact_rerank_segments(
        q, [(x, alive), (x, alive)], cand, 20, "COSINE")
    torch.cuda.synchronize()
    x64, q64 = x.double(), q.double()
    rows = x64[iv.long()]
    den = q64.norm(dim=1)[None, :, None] * rows.norm(dim=-1)
    sim = torch.where(den == 0, 0.0, torch.einsum("qd,sqcd->sqc", q64, rows)
                      / torch.where(den == 0, 1.0, den))
    err = float((di.double() - (1.0 - sim)).abs().max())
    del rows, x64, sim
    if err > 1e-6:
        raise AssertionError(f"re-rank cosine at D 1,536: distance error {err}")
    if not bool((di[:, -1] == 1.0).all()) or not bool((di[iv == 3] == 1.0).all()):
        raise AssertionError("re-rank cosine at D 1,536: a zero norm's distance is not 1")
    return (f"flat re-rank cosine, Q 512 x 2 segments x 256 candidates x D 1,536: "
            f"max distance error {err:.3e} (limit 1e-6), zero row and zero "
            f"query at 1")


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
        graph_build_breadth=64, device="cuda", **dict(modes, **kw),
    ))


def _build(tvs, x, storage, mode, seg_size, seal_s=None, **kw):
    """Adds x and seals every full segment (PQ trained and the graph built
    on the card in flat mode); returns (index, gids, seconds). ``seal_s``,
    when given, collects each seal's seconds; ``kw`` goes to the config."""
    import numpy as np
    import torch

    t0 = time.time()
    idx = _open_index(tvs, storage, mode, seg_size, **kw)
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


# ------------------------------------ phases 4f-4i: mesh, placement, async


def _margin_rows(dists, rel=1e-4):
    """Queries whose k+1 returned distances are each more than `rel` of the
    distance apart (some 40x the exact pool's rounding, 3xTF32 sums): their
    top-k ids have no near-tie, so two exact routes must agree on them."""
    import numpy as np

    gaps = np.diff(dists, axis=1)
    return np.flatnonzero((gaps > rel * dists[:, 1:]).all(axis=1))


def _pool_bin(rows, n):
    """The bin of each of an n-row table's rows in the exact pool
    (ops/exact.py's geometry at Q 512, D 128, ef_buf 64): of the rows that
    share a bin the pool keeps the best alone, so two true neighbours in
    one bin lose one, in either package."""
    from vectorsearch_torch.ops import exact as exact_ops

    tile, bins, fold, _w = exact_ops._stage1_params(512, 128, n, None, None,
                                                    16384)
    return (rows // (fold * tile)) * bins + rows % bins


def _route_bins(seg_size, n_sealed, route, shards=4):
    """gid -> its exact-pool bin key under one route (gids are sequential:
    segment gid // seg_size, row gid % seg_size): "subgroups" (the default
    placement: power-of-two subgroups of flattened segments, singletons and
    the brute table alone), "cluster" (the same within each of two shard
    servers' segments, seg_id % 2), "segments" (round_robin: each segment
    alone), "mesh" (each segment's shards alone)."""
    from vectorsearch_torch.core.segment import pad_cap

    cap = pad_cap(seg_size)

    def subgroups(segs):
        """segment -> (its subgroup's first segment, position, size)"""
        out, i = {}, 0
        while i < len(segs):
            size = 1
            while size * 2 <= len(segs) - i:
                size *= 2
            for j in range(size):
                out[segs[i + j]] = (segs[i], j, size)
            i += size
        return out

    groups = {}
    if route == "subgroups":
        groups = subgroups(list(range(n_sealed)))
    elif route == "cluster":
        for shard in range(2):
            groups.update(subgroups(list(range(shard, n_sealed, 2))))

    def key(gid):
        seg, row = divmod(int(gid), seg_size)
        if route == "mesh":
            n_local = cap // shards
            return seg, row // n_local, _pool_bin(row % n_local, n_local)
        if seg in groups:
            lo, pos, size = groups[seg]
            return lo, _pool_bin(pos * cap + row, size * cap)
        return seg, _pool_bin(row, cap)
    return key


def _same_or_binned(label, got, want, truth_gids, key_got, key_want):
    """Two exact routes over the same rows, on the queries whose k+1
    returned distances are margin-separated (``_margin_rows``): the same
    top-k ids, save where a route's pool dropped a true neighbour (float64
    ground truth) that shares that route's pool bin with a row it returned.
    Returns (margin queries, equal, differing by the bin rule)."""
    k = truth_gids.shape[1]
    rows = _margin_rows(want[2])
    if len(rows) == 0:
        raise AssertionError(f"{label}: no margin-separated query")
    binned = 0
    for i in rows:
        g, w = got[0][i, :k], want[0][i, :k]
        if (g == w).all():
            continue
        for ids, key in ((g, key_got), (w, key_want)):
            kept = {key(r) for r in ids.tolist()}
            for t in truth_gids[i].tolist():
                if t not in ids and key(t) not in kept:
                    raise AssertionError(
                        f"{label}: query {i} misses gid {t}, which shares no "
                        f"pool bin with a returned row: {ids.tolist()} / "
                        f"{truth_gids[i].tolist()}")
        binned += 1
    return len(rows), len(rows) - binned, binned


def _tie_equal(label, got, want):
    """Identical ids and scores, save positions where the two results hold
    rows of exactly equal score (a tie may resolve in either order)."""
    import numpy as np

    (g, s), (wg, ws) = got, want
    if not np.array_equal(s, ws):
        raise AssertionError(f"{label}: scores differ")
    tied = (s == np.roll(s, 1, axis=1)) | (s == np.roll(s, -1, axis=1))
    bad = (g != wg) & ~tied
    if bad.any():
        raise AssertionError(f"{label}: ids differ at {int(bad.sum())} untied slots")


def _mesh_phase(tvs, x, q, gids, truth, tag, launches, exact_ref, pq_s,
                truth512, tables, seg_size=100_000):
    """4f. A mesh of [cuda:0] * 4 over sift1m: exact mode (B1 once a shard a
    segment: 40 a batch) with ids equal to phase 4a's single-device index on
    margin-separated queries, then flat mode with PQ-only seals (the sharded
    k-means and encoding: each seal's seconds beside phase 4b's PQ seconds;
    B4 once a shard a segment: 40 a batch); recall gates as phases 4a/4b;
    one-client latency, QPS and a profile each; the sharded encoder on the
    card equal to the single-device one given the same codebook."""
    import numpy as np
    import torch

    from vectorsearch_torch.ops import pq as pq_ops
    from vectorsearch_torch.parallel import mesh as mesh_ops

    mesh = mesh_ops.make_mesh([torch.device("cuda", 0)] * 4)
    flat_params = tvs.SearchParams(ef_search=150, beam_width=128, max_iters=6,
                                   max_explore=150, mode=tvs.Mode.BEST_FIRST)
    out = {}
    for mode, kernel, kw in (
        ("exact", "exact_pool", {}),
        ("flat", "adc_scores", dict(graph_build_mode="skip_for_flat")),
    ):
        seal_s: list[float] = []
        idx, mgids, build_s = _build(tvs, x, tvs.MemoryStorage(), mode,
                                     seg_size, seal_s, mesh=mesh, **kw)
        try:
            segs = [s for s in idx.store.snapshot_segments()
                    if s.state.value == "SEALED"]
            if len(segs) != 10 or not np.array_equal(mgids, gids):
                raise AssertionError(f"mesh {mode}: expected 10 sealed segments")
            label = f"sift1m mesh {mode}"
            params = None if mode == "exact" else flat_params
            _log(f"{label} {tag}: mesh of 4 shards on cuda:0, {len(x):,} x 128, "
                 f"add + build+seal {build_s:.1f} s; rows a shard "
                 f"{segs[0].shard_snapshot().vectors[0].shape[0]:,}")
            counts, recall = _serve_checks(
                label, idx, x, q, gids, truth, tag, launches, kernel=kernel,
                want_per_batch=40, min_recall=0.99 if mode == "exact" else 0.97,
                params=params, qps=False,
            )
            (rate, lo, hi), _c = launches.run(lambda: _measure_qps(
                idx, np.concatenate([q] * 8), 10, params, clients=1,
                seconds=1.0, windows=4))
            _log(f"{label} serving {tag}: {rate:.1f} QPS median of 3 windows "
                 f"[{lo:.1f}, {hi:.1f}], 1 client, 512-query batches, k=10")
            _profile(label, idx, q, params, tag, launches, tables,
                     clients=False)
            out[mode] = dict(counts=counts, recall=recall, qps=rate,
                             seal_s=seal_s)
            if mode == "exact":
                got, _c = launches.run(lambda: idx.query_batch_arrays(q, 11))
                n, same, binned = _same_or_binned(
                    label, got, exact_ref, gids[truth512],
                    _route_bins(seg_size, 10, "mesh"),
                    _route_bins(seg_size, 10, "subgroups"))
                _log(f"{label} {tag}: of 512 queries {n} margin-separated: ids "
                     f"equal to the single-device exact index's on {same}, "
                     f"and {binned} differ only where a pool bin held two "
                     f"true neighbours")
                continue
            _log(f"{label} {tag}: seal seconds (sharded PQ k-means + encode, "
                 f"4 shards): " + ", ".join(f"{t:.2f}" for t in seal_s)
                 + "; phase 4b's single-device PQ seconds: "
                 + ", ".join(f"{t:.2f}" for t in pq_s))
            seg = segs[0]
            rows = torch.from_numpy(seg.vectors_np[:, :128]).cuda()
            valid = torch.from_numpy(seg.exists_np).cuda()
            single = pq_ops.pq_encode(rows, seg.codebook_dev, valid)
            shard = torch.cat(mesh_ops.sharded_pq_encode(mesh)(
                mesh_ops.shard_rows(mesh, rows), seg.codebook_replicas,
                mesh_ops.shard_rows(mesh, valid)))
            if not torch.equal(shard, single):
                raise AssertionError("sharded_pq_encode on the card differs "
                                     "from pq_encode")
            _log(f"{label} {tag}: sharded_pq_encode == pq_encode on segment "
                 f"{seg.seg_id} ({rows.shape[0]:,} rows, same codebook)")
        finally:
            idx.close()
        del idx
        torch.cuda.empty_cache()
    return out


def _host_merge_check(tag):
    """``_merge_entries_host`` (pinned buffers, copies started before any
    is waited on) against ``_merge_entries`` on ten [512, 64] entries on
    the card: identical scores in order, and identical distances, vector
    ids and slots wherever a score is finite (distinct scores)."""
    import numpy as np
    import torch

    from vectorsearch_torch.core import index as index_mod

    g = torch.Generator(device="cuda").manual_seed(5)
    entries = []
    for slot in range(10):
        s = torch.rand(512, 64, device="cuda", generator=g) + slot
        s[torch.rand(512, 64, device="cuda", generator=g) < 0.1] = float("-inf")
        vids = torch.randint(0, 100_000, (512, 64), device="cuda", generator=g,
                             dtype=torch.int32)
        entries.append((s, -s, vids, torch.full_like(vids, slot)))
    dev = index_mod._merge_entries(entries, 10)
    host = index_mod._merge_entries_host(entries, 10)
    finite = np.isfinite(dev[0])
    if not np.array_equal(host[0], dev[0]) or not all(
        np.array_equal(host[j][finite], dev[j][finite]) for j in (1, 2, 3)
    ):
        raise AssertionError("the host merge differs from the device merge")
    _log(f"sift1m round_robin {tag}: the host merge equals the device merge "
         f"on 10 entries of [512, 64] on the card")


def _placement_phase(tvs, q, tag, launches, exact_storage, flat_storage,
                     exact_after, flat_ref, flat_params, truth_after,
                     seg_size=100_000):
    """4g. round_robin placement over phase 4a's and 4b's seals, reopened:
    on one card every segment lands on cuda:0, and the per-device groups
    and the per-segment routes (no subgroups under round_robin, as in the
    JAX package) run; the results, all on the one card, merge there.
    Exact: ids equal to the default placement's on margin-separated
    queries; flat: ids and scores equal (the same pools; ties aside). The
    host merge, which results on several cards take, is held to the device
    merge on the same entries on the card."""
    _host_merge_check(tag)
    out = {}
    idx = _open_index(tvs, exact_storage, "exact", seg_size,
                      device_placement="round_robin")
    try:
        launches.run(lambda: idx.query_batch_arrays(q, 11))  # uploads
        got, c = launches.run(lambda: idx.query_batch_arrays(q, 11))
        n, same, binned = _same_or_binned(
            "round_robin exact", got, exact_after, truth_after,
            _route_bins(seg_size, 10, "segments"),
            _route_bins(seg_size, 10, "subgroups"))
        devs = sorted({str(s.device) for s in idx.store.snapshot_segments()})
        out["exact_counts"] = c
        _log(f"sift1m round_robin exact {tag}: segments on {devs}; of 512 "
             f"queries {n} margin-separated: ids equal to the default "
             f"placement's on {same}, {binned} differ only where a pool bin "
             f"held two true neighbours; launches in that batch {c}")
    finally:
        idx.close()
    idx = _open_index(tvs, flat_storage, "flat", seg_size,
                      device_placement="round_robin")
    try:
        launches.run(lambda: idx.query_batch_arrays(q, 10, flat_params))
        (g, s, _d), c = launches.run(
            lambda: idx.query_batch_arrays(q, 10, flat_params))
        _tie_equal("round_robin flat", (g, s), flat_ref)
        out["flat_counts"] = c
        _log(f"sift1m round_robin flat {tag}: ids and scores equal to the "
             f"default placement's on 512 queries; launches in that batch {c}")
    finally:
        idx.close()
    return out


def _async_phase(tvs, x, q, gids, tag, launches, exact_storage, extra,
                 new_gids, flat_storage, flat_params, seconds=3.0,
                 seg_size=100_000):
    """4h. query_async: 8 client threads send single queries for a fixed
    window against the sift1m exact index (phase 4a's seals and its 20,000
    ACTIVE rows, reopened); QPS, the batch sizes the QueryBatcher formed,
    and recall@10 of the answers against float64 ground truth over every
    row. Then five batches with query_breakdown_sample_every=1 on the flat
    and the graph index: the three phase histograms' medians, and the
    sampled batches' ids equal to batch 0's (unsampled)."""
    import numpy as np

    from vectorsearch_torch.utils.metrics import get_registry, reset_for_test

    out = {}
    x_all = np.concatenate([x, extra])
    gids_all = np.concatenate([gids, np.asarray(new_gids)])
    truth = _ground_truth(x_all, q[:128], 10)
    del x_all
    idx = _open_index(tvs, exact_storage, "exact", seg_size)
    try:
        launches.run(lambda: idx.query_batch_arrays(q, 10))  # uploads
        sizes = []
        orig = idx.query_batch

        def counted(qs, k, params=None):
            sizes.append(len(qs))
            return orig(qs, k, params)

        idx.query_batch = counted
        stop = threading.Event()
        done = [0] * 8
        first = {}
        errors = []

        def client(i):
            try:
                j = i
                while not stop.is_set():
                    res = idx.query_async(q[j % 512], 10).result(timeout=60)
                    if j < 128 and j not in first:
                        first[j] = [r.gid for r in res]
                    done[i] += 1
                    j += 8
            except Exception as e:  # reported below
                errors.append(e)

        def window():
            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(8)]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            time.sleep(seconds)
            stop.set()
            for t in threads:
                t.join(timeout=120)
            if any(t.is_alive() for t in threads):
                raise RuntimeError("an async client did not stop")
            return time.perf_counter() - t0

        secs, _c = launches.run(window)
        if errors:
            raise errors[0]
        got = np.full((128, 10), -1, np.int64)
        for j, row in first.items():
            got[j, : len(row)] = row
        if len(first) < 128:
            raise AssertionError(f"async: only {len(first)} of 128 queries answered")
        recall = _recall(got, truth, gids_all)
        qps = sum(done) / secs
        out.update(qps=qps, recall=recall, batch_median=float(np.median(sizes)),
                   batch_max=int(max(sizes)))
        _log(f"sift1m async {tag}: query_async, 8 client threads, single "
             f"queries, {secs:.1f} s: {qps:.1f} QPS, {sum(done)} queries in "
             f"{len(sizes)} batches (median {np.median(sizes):.0f}, max "
             f"{max(sizes)} queries a batch), recall@10 {recall:.4f} on 128 "
             f"queries (float64 ground truth over all {len(gids_all):,} rows)")
        if recall < 0.99:
            raise AssertionError(f"async: recall@10 {recall} < 0.99")
    finally:
        idx.close()
    m = get_registry()
    for mode in ("flat", "graph"):
        reset_for_test()
        idx = _open_index(tvs, flat_storage, mode, seg_size,
                          query_breakdown_sample_every=1)
        try:
            res = []
            for _b in range(5):
                (g, s, _d), _c = launches.run(
                    lambda: idx.query_batch_arrays(q, 10, flat_params))
                res.append((g, s))
            for b in range(1, 5):  # batch 0 is not sampled
                _tie_equal(f"sampled {mode} batch {b}", res[b], res[0])
            med = {name: float(np.median(m.histogram_values(
                f"vectorsearch.query.{name}")))
                for name in ("pq_scan_ms", "graph_traversal_ms", "rerank_ms")}
            n_rec = len(m.histogram_values("vectorsearch.query.rerank_ms"))
            n_sealed = sum(sg.state.value == "SEALED"
                           for sg in idx.store.snapshot_segments())
            if n_rec != 3 * n_sealed:
                raise AssertionError(f"sampled {mode}: {n_rec} records, expected "
                                     f"3 recorded batches x {n_sealed} segments")
            out[mode] = med
            _log(f"sift1m sampled breakdowns {mode} {tag}: 5 batches, "
                 f"sample_every 1 (batch 0 unsampled, batch 1 discarded, "
                 f"{n_rec} segment records), medians: pq_scan "
                 f"{med['pq_scan_ms']:.3f} ms, graph_traversal "
                 f"{med['graph_traversal_ms']:.3f} ms, rerank "
                 f"{med['rerank_ms']:.3f} ms a segment; sampled batches' ids "
                 f"== the unsampled batch's")
        finally:
            idx.close()
    reset_for_test()
    return out


def _cluster_phase(tvs, x, q, tag, launches, rows=400_000, seg_size=100_000):
    """4i. Two ClusterQueryServers in this process over DiskStorage (a
    temporary directory) holding the first 400,000 sift1m rows in exact
    mode, segment_shard (0, 2) and (1, 2), both on cuda:0; a ClusterClient
    routes 512-query batches. Its answers equal one process's on the
    margin-separated queries (each server pools its own subgroup of two
    segments where one process pools four: a difference is allowed only
    where a pool bin held two true neighbours), with the scores of equal
    ids within rtol 1e-5."""
    import tempfile

    import numpy as np

    from vectorsearch_torch.parallel.cluster import (ClusterClient,
                                                      ClusterQueryServer)

    with tempfile.TemporaryDirectory(prefix="vs-cluster-") as root:
        t0 = time.time()
        idx, _g, _s = _build(tvs, np.ascontiguousarray(x[:rows]),
                             tvs.DiskStorage(root, fsync=False), "exact",
                             seg_size)
        idx.checkpoint()
        (want, _c) = launches.run(lambda: idx.query_batch_arrays(q, 11))
        idx.close()
        truth = _ground_truth(np.ascontiguousarray(x[:rows]), q, 10)
        shards = []
        try:
            for sh in range(2):
                sidx = _open_index(tvs, tvs.DiskStorage(root, fsync=False),
                                   "exact", seg_size, segment_shard=(sh, 2))
                shards.append((sidx, ClusterQueryServer(sidx, port=0).start()))
            client = ClusterClient([srv.address for _, srv in shards])
            _log(f"cluster {tag}: {rows:,} rows written to disk and 2 shard "
                 f"servers opened in {time.time() - t0:.1f} s")
            launches.run(lambda: client.query_batch_arrays(q, 11))  # uploads
            lat = []
            for b in range(5):
                t1 = time.perf_counter()
                (got, _c) = launches.run(lambda: client.query_batch_arrays(q, 11))
                lat.append((time.perf_counter() - t1) * 1e3)
            n, same, binned = _same_or_binned(
                "cluster", got, want, truth, _route_bins(seg_size, 4, "cluster"),
                _route_bins(seg_size, 4, "subgroups"))
            eq = got[0][:, :10] == want[0][:, :10]
            if not np.allclose(got[1][:, :10][eq], want[1][:, :10][eq],
                               rtol=1e-5, atol=0):
                raise AssertionError("cluster: scores of equal ids differ")
            _log(f"cluster {tag}: router over 2 shard servers against one "
                 f"process, 512 queries: {float(eq.mean()):.4f} of the top-10 "
                 f"slots hold the same id, their scores within rtol 1e-5; of "
                 f"{n} margin-separated queries {same} equal and {binned} "
                 f"differ only where a pool bin held two true neighbours; "
                 f"routed 512-query batch median {statistics.median(lat):.1f} "
                 f"ms [{min(lat):.1f}, {max(lat):.1f}]")
            client.shutdown_servers()
        finally:
            for sidx, srv in shards:
                srv.close()
                sidx.close()
    return {"latency_ms": statistics.median(lat)}


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
            form = _exact_form(key)
            return form is not None and form[0].startswith("B2") is packed

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


def _packed_timings(exact_ops, peaks, tag, pipe_regs):
    """B2 at the Deep10M subgroups' shapes (the form each launch took, from
    the registry's counter, and the pipelined form's ptxas registers and
    spills, `pipe_regs`, beside them): the kernel as the index calls it
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

    from vectorsearch_torch.utils.metrics import get_registry

    regs = ", ".join(f"NQW {k}: {r} registers, {sp} bytes spilled"
                     for k, (r, sp) in sorted(pipe_regs.items()))
    out = {}
    for segs in (8, 2):
        case = _deep_case(f"deep {segs}", segs, seed=30 + segs)
        q, x, valid = case["q"], case["x"], case["valid"]
        q_in, aux, mult, qn2, _step, geom = exact_ops.packed_pool_inputs(
            q, x, valid, "L2", d_live=96)
        iters = 5 if segs == 8 else 10
        before = _packed_forms(exact_ops, get_registry())
        ms = _time_ms(lambda: exact_ops.exact_pool_packed_cuda(
            q_in, x, aux, mult, qn2, **geom), iters)
        mid = _packed_forms(exact_ops, get_registry())
        ms_pad = _time_ms(lambda: exact_ops.exact_pool_packed_cuda(
            q_in, x, aux, mult, qn2, **dict(geom, d_live=None)), iters)
        forms = (_form_taken(before, mid),
                 _form_taken(mid, _packed_forms(exact_ops, get_registry())))
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
             f"(fold {geom['fold']}, W {w:,}): kernel ({forms[0]} form) over "
             f"the 96 live features {ms:.3f} ms ({live['flops'] / ms / 1e9:.1f} useful "
             f"TFLOP/s; 3xTF32 ceiling {live['tf32_ms']:.3f} ms; bound "
             f"{live['bound']:.3f} ms, operations {live['ops_ms']:.3f} ms as 3 "
             f"split-bf16 passes of {live['flops'] / 1e12:.3f} TFLOP, bytes "
             f"{live['bytes_ms']:.3f} ms), over all 128 ({forms[1]} form) "
             f"{ms_pad:.3f} ms "
             f"({pad['flops'] / ms_pad / 1e9:.1f} useful TFLOP/s; 3xTF32 "
             f"ceiling {pad['tf32_ms']:.3f} ms; bound {pad['bound']:.3f} ms); "
             f"plain over 64 queries {plain64:.3f} ms; torch.matmul of the "
             f"same product over the 96 live columns {lib:.3f} ms, over all "
             f"128 {lib_pad:.3f} ms; ptxas of the pipelined form: {regs}")
        key = "" if segs == 8 else "_2seg"
        out.update({
            f"ms{key}": ms, f"ms_padded{key}": ms_pad,
            f"plain_ms{key}": plain64, f"library_ms{key}": lib,
            f"library_padded_ms{key}": lib_pad, f"bound_ms{key}": live["bound"],
            f"bound_padded_ms{key}": pad["bound"],
        })
        out.setdefault("bound_by", live["by"])
        out.setdefault("form", forms[0])
        del case, q, x, valid, q_in, aux
        torch.cuda.empty_cache()
    out["plain_queries"] = 64
    out["d_live"] = 96
    return out


def _wide_timings(exact_ops, peaks, tag):
    """B2's wide form at cohere10m.batch512's two groups (Q 512 x N
    8,000,512 and 2,000,128, 768 features, COSINE, fold 8; the form each
    launch took from the registry's counter), torch.matmul of the same
    product, and the bound: bytes (x, both column terms, q and the
    per-query terms read once, the packed plane written once) over the
    memory rate, or three split-bf16 passes of the product over the bf16
    tensor-core rate; beside it the bytes alone and the 3xTF32 ceiling."""
    import torch

    from vectorsearch_torch.utils.metrics import get_registry

    out = {}
    for segs in (8, 2):
        case = _cohere_case(f"cohere {segs}", segs, "COSINE", seed=40 + segs)
        q, x, valid = case["q"], case["x"], case["valid"]
        q_in, aux, mult, qn2, _step, geom = exact_ops.packed_pool_inputs(
            q, x, valid, "COSINE")
        before = _packed_forms(exact_ops, get_registry())
        ms = _time_ms(lambda: exact_ops.exact_pool_packed_cuda(
            q_in, x, aux, mult, qn2, **geom), 5 if segs == 8 else 10)
        form = _form_taken(before, _packed_forms(exact_ops, get_registry()))
        if form != "wide":
            raise AssertionError(f"B2 at Cohere10M's {segs}-segment group: {form} form")
        lib = _time_ms(lambda: torch.matmul(q_in, x.T), 3, 1)
        (qn, d), n, w = q_in.shape, x.shape[0], geom["w"]
        nbytes = n * d * 4 + 2 * n * 4 + qn * d * 4 + qn * 8 + qn * w * 4
        flops = 2 * qn * n * d
        bytes_ms = nbytes / peaks["bytes_s"] * 1e3
        ops_ms = 3 * flops / peaks["bf16"] * 1e3
        tf32_ms = 3 * flops / peaks["tf32"] * 1e3
        _log(f"timing exact_pool_packed {tag}: Cohere10M {segs}-segment group, "
             f"Q {qn} x N {n:,} x D {d} (COSINE, fold {geom['fold']}, W {w:,}): "
             f"kernel ({form} form) {ms:.3f} ms ({flops / ms / 1e9:.1f} useful "
             f"TFLOP/s), torch.matmul {lib:.3f} ms, bound "
             f"{max(bytes_ms, ops_ms):.3f} ms (operations {ops_ms:.3f} ms as 3 "
             f"split-bf16 passes of {flops / 1e12:.3f} TFLOP, bytes "
             f"{bytes_ms:.3f} ms: {nbytes / 1e9:.2f} GB), 3xTF32 ceiling "
             f"{tf32_ms:.3f} ms")
        key = f"_cohere_{segs}seg"
        out.update({f"ms{key}": ms, f"library_ms{key}": lib,
                    f"bound_ms{key}": max(bytes_ms, ops_ms),
                    f"bytes_ms{key}": bytes_ms, f"tf32_ceiling_ms{key}": tf32_ms,
                    f"form{key}": form})
        del case, q, x, valid, q_in, aux
        torch.cuda.empty_cache()
    return out


def _wide_feed(exact_ops, q_in, x, aux, geom):
    """(ms, bytes) of the copy-only variant of B1's wide form (L2): its
    ring fed as the kernel feeds it (each stage a 128-row box of x and the
    chunk's two 64-query planes, 32 KB, from L2 or device memory), its
    consumers reading nothing; the prologue that splits the query planes is
    in the time. The bytes count the ring's stages alone."""
    import torch

    from vectorsearch_torch.utils import cuda_build

    lib = cuda_build.load("exact_pool_tc", exact_ops._bind_tc, defines=_FEED_ONLY)
    (qn, d), n, w = q_in.shape, x.shape[0], geom["w"]
    outs = torch.empty((qn, w), dtype=torch.float32, device="cuda")
    outi = torch.empty((qn, w), dtype=torch.int32, device="cuda")
    form, _nq, nplane = exact_ops._plan(lib, "copy-only wide form", qn, d,
                                        geom["d_live"], w, packed=False)
    if form != "pipelined":
        raise AssertionError(f"copy-only wide form: form {form}")
    planes = torch.empty((nplane,), dtype=torch.float32, device="cuda")

    def run():
        rc = lib.exact_pool_launch(
            q_in.data_ptr(), x.data_ptr(), aux[0].data_ptr(), None,
            outs.data_ptr(), outi.data_ptr(), qn, n, d, geom["d_live"],
            geom["tile"], geom["bins"], geom["fold"], w, 0, planes.data_ptr(),
            nplane, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise AssertionError(f"copy-only wide form: rc {rc}")

    span, bins = geom["fold"] * geom["tile"], geom["bins"]
    steps = sum(min(-(-(n - f - b0) // bins), span // bins)
                for f in range(0, w // bins * span, span)
                for b0 in range(0, bins, 128) if f + b0 < n)
    nbytes = steps * -(-geom["d_live"] // 32) * 32 * 1024 * -(-qn // 64)
    return _time_ms(run, 10), nbytes


def _gist_timings(exact_ops, peaks, tag):
    """B1 at GIST1M's two sealed groups' shapes (Q 512 x N 800,768 and
    200,192, rows of 960 features zero-padded to 1,024 lanes, as
    gist1m.batch512's index holds them, read over the 960 live features as
    the index asks: d_live), the form and query tile each launch took (the
    registry's counter), torch.matmul of the same product, and the bound:
    bytes (the 960 live features of x, aux and q read once, the pool
    written once) over the memory rate, or three split-bf16 passes of the
    live product over the bf16 tensor-core rate; beside it the 3xTF32
    ceiling over the 960 live lanes, which the wide form computes (and over
    all 1,024); and the copy-only variant's feed (_wide_feed): the rate at
    which the ring's stages reach shared memory."""
    import torch

    from vectorsearch_torch.utils.metrics import get_registry

    reg = get_registry()
    g = torch.Generator(device="cuda").manual_seed(37)
    out = {}
    for segs in (8, 2):
        n = segs * 100_096
        x = torch.randn((n, 1024), generator=g, device="cuda")
        q = torch.randn((512, 1024), generator=g, device="cuda")
        x[:, 960:] = 0.0
        q[:, 960:] = 0.0
        valid = torch.ones(n, dtype=torch.bool, device="cuda")
        q_in, aux, geom = exact_ops.pool_inputs(q, x, valid, "L2", d_live=960)
        before = reg.snapshot()["counters"]
        ms = _time_ms(lambda: exact_ops.exact_pool_cuda(q_in, x, aux, **geom), 10)
        forms = sorted(k[len(exact_ops.LAUNCHES):] for k, v in
                       reg.snapshot()["counters"].items()
                       if k.startswith(exact_ops.LAUNCHES + "{")
                       and v > before.get(k, 0.0))
        lib = _time_ms(lambda: torch.matmul(q_in, x.T), 10)
        feed_ms, feed_bytes = _wide_feed(exact_ops, q_in, x, aux, geom)
        flops = 2 * 512 * n * 960
        nbytes = n * 960 * 4 + n * 4 + 512 * 960 * 4 + 512 * geom["w"] * 8
        bytes_ms = nbytes / peaks["bytes_s"] * 1e3
        ops_ms = 3 * flops / peaks["bf16"] * 1e3
        tf32_ms = 3 * flops / peaks["tf32"] * 1e3
        tf32_all_ms = 3 * 2 * 512 * n * 1024 / peaks["tf32"] * 1e3
        _log(f"timing exact_pool {tag}: GIST1M {segs}-segment group, Q 512 x "
             f"N {n:,} x D 1,024 (960 live; fold {geom['fold']}, W "
             f"{geom['w']:,}): kernel ({', '.join(forms)}) {ms:.3f} ms "
             f"({flops / ms / 1e9:.1f} useful TFLOP/s), torch.matmul "
             f"{lib:.3f} ms, bound {max(bytes_ms, ops_ms):.3f} ms (operations "
             f"{ops_ms:.3f}, bytes {bytes_ms:.3f}), 3xTF32 ceiling over the "
             f"960 live lanes {tf32_ms:.3f} ms (over 1,024: {tf32_all_ms:.3f}); "
             f"copy-only ring {feed_ms:.3f} ms, {feed_bytes / 1e9:.2f} GB at "
             f"{feed_bytes / feed_ms / 1e9:.2f} TB/s")
        if segs == 8 and ms >= lib:
            raise AssertionError(
                f"B1 at GIST1M's 8-segment group: {ms:.3f} ms, not under "
                f"torch.matmul's {lib:.3f} ms")
        key = f"_gist_{segs}seg"
        out.update({f"ms{key}": ms, f"library_ms{key}": lib,
                    f"bound_ms{key}": max(bytes_ms, ops_ms), f"form{key}": forms,
                    f"tf32_ceiling_ms{key}": tf32_ms, f"feed_ms{key}": feed_ms,
                    f"feed_tb_s{key}": feed_bytes / feed_ms / 1e9})
        del x, q, q_in, aux, valid
        torch.cuda.empty_cache()
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
        if src == "feed_only":  # a measurement variant: its lines repeat
            continue
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
    # B2's pipelined form and B1's wide form: 168 registers at launch
    # (setmaxnreg hands the consumers 240), no spill; a library built before
    # this run printed no ptxas lines
    pipe_regs = _pipelined_ptxas(built["exact_pool_tc"][1])
    for key, (regs, spill) in sorted(pipe_regs.items()):
        _log(f"  ptxas {tag}: {key}: {regs} registers, {spill} bytes spill stores")
    if not built["exact_pool_tc"][1]:
        _log(f"  ptxas {tag}: exact_pool_tc was built before this run, "
             "no ptxas lines to check")
    elif ("B1 wide" not in pipe_regs or "B2 wide" not in pipe_regs
          or len(pipe_regs) < 3
          or any(sp != 0 or r != 168 for r, sp in pipe_regs.values())):
        raise AssertionError(
            f"B2 pipelined / B1 and B2 wide: spills, registers other than 168 "
            f"or no instantiation: {pipe_regs}")
    # B1 and B2 run on the tensor cores: warpgroup MMA in each instantiation
    # of their forms (B1 narrow, B1 wide, B2 pipelined, B2 wide)
    mmas = _warpgroup_mmas(built["exact_pool_tc"][0], "exact_pool_")
    for fn, n in sorted(mmas.items()):
        _log(f"sass {tag}: {fn}: {n} HGMMA")
    forms = {fn: _exact_form(fn) for fn in mmas}
    if None in forms.values():
        raise AssertionError(
            f"exact pool: no form read from "
            f"{[fn for fn, f in forms.items() if f is None]}")
    for kname in _EXACT_FORMS:
        mine = [n for fn, n in mmas.items() if forms[fn][0] == kname]
        if not mine or min(mine) == 0:
            raise AssertionError(
                f"exact pool: {kname} has an instantiation without HGMMA "
                f"instructions, or none: {mmas}")

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
        # the shapes phases 4f-4i give it: a mesh shard, a round_robin
        # segment alone, the cluster check's 4-segment group
        _case("mesh shard, N 25,024 (L2)", 25_024, "L2", seed=7),
        _case("one segment, N 100,096 (L2)", 100_096, "L2", seed=8),
        _case("sift1m 4-segment group (L2)", 4 * 100_096, "L2", seed=9, segs=4),
        # gist1m.batch512's two groups: 960 live features in 1,024 lanes,
        # the wide form at 64 queries a block, with chunk sums. rtol 3e-6:
        # one accumulator over the 30 chunks (the fault the sums repaired)
        # read 6.7-7.0e-6 x scale here, the chunk sums 1.1e-6 (one H100)
        _case("GIST1M 8-segment group, 960 of 1,024 lanes (L2)", 8 * 100_096,
              "L2", seed=10, d=1024, live_d=960, segs=8, rtol=3e-6,
              form="pipelined"),
        _case("GIST1M 2-segment group, 960 of 1,024 lanes (L2)", 2 * 100_096,
              "L2", seed=11, d=1024, live_d=960, segs=2, rtol=3e-6,
              form="pipelined"),
    ]
    max_err = {name_: 0.0 for name_, _s, _r in _KERNELS}
    for case in cases:
        err, report = _check_pool(case, exact_ops, traversal_ops)
        max_err["exact_pool"] = max(max_err["exact_pool"], err)
        _log(f"kernel vs plain {tag}: {report}")
    sift_case, two_case, deep_brute = cases[0], cases[1], cases[5]
    mesh_case = cases[6]
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
        # cohere10m.batch512's groups, 768 features: B2's wide form
        (lambda: _cohere_case("Cohere10M 8-segment group (COSINE)", 8,
                              "COSINE", seed=25), dict(plain_q=64)),
        (lambda: _cohere_case("Cohere10M 8-segment group (L2)", 8, "L2",
                              seed=26), dict(plain_q=64)),
        (lambda: _cohere_case("Cohere10M 2-segment group, Q 200 (COSINE)", 2,
                              "COSINE", seed=27, qn=200), {}),
        (lambda: _cohere_case("Cohere10M 2-segment group, Q 200 (L2)", 2,
                              "L2", seed=28, qn=200), {}),
    ]
    for make, kw in packed_cases:
        err, level, report = _check_packed(make(), exact_ops, traversal_ops, **kw)
        max_err["exact_pool_packed"] = max(max_err["exact_pool_packed"], err)
        max_level_diff = max(max_level_diff, level)
        _log(f"kernel vs plain {tag}: packed {report}")
        torch.cuda.empty_cache()
    # B2's timings at the Deep10M and Cohere10M subgroups' shapes (in the
    # kernels line)
    packed_times = _packed_timings(exact_ops, peaks, tag, pipe_regs)
    torch.cuda.empty_cache()
    packed_times.update(_wide_timings(exact_ops, peaks, tag))
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
        # B4 at a mesh shard (the last shard of a segment: 96 pad rows)
        _adc_case("ADC mesh shard (N 25,024)", 25_024, seed=17,
                  pad_from=24_928),
        # openai500k.batch512's segment: B3 at two queries a line
        _adc_case("ADC OpenAI500K segment (M 192, K 256, D 1,536)", 100_096,
                  seed=18, m=192, d=1536, pad_from=100_000),
    ]
    for case in adc_cases:
        errs, report = _check_adc(case, adc_ops)
        for key, v in errs.items():
            max_err[key] = max(max_err[key], v)
        _log(f"kernel vs plain {tag}: {report}")
    adc_sift, adc_small, adc_mesh = adc_cases[0], adc_cases[1], adc_cases[6]
    adc_openai = adc_cases[7]
    del adc_cases
    torch.cuda.empty_cache()
    _log(f"kernel vs float64 {tag}: {_check_rerank_cosine(traversal_ops)}")
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

    # 4a. exact mode (its seals and refs serve phases 4f-4h too)
    exact_storage = tvs.MemoryStorage()
    idx, gids, build_s = _build(tvs, x, exact_storage, "exact", 100_000)
    try:
        _log(f"sift1m exact index {tag}: 1,000,000 x 128, "
             f"{len(idx.store.snapshot_segments())} segments, "
             f"build+seal {build_s:.1f} s")
        exact_counts, exact_recall = _serve_checks(
            "sift1m exact", idx, x, q, gids, truth, tag, launches,
            kernel="exact_pool", want_per_batch=2, min_recall=0.99,
        )
        exact_per_batch = exact_counts["exact_pool"]
        exact_ref, _c = launches.run(lambda: idx.query_batch_arrays(q, 11))
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
        exact_after, _c = launches.run(lambda: idx.query_batch_arrays(q, 11))
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
        (fg, fs, _fd), _c = launches.run(
            lambda: idx.query_batch_arrays(q, 10, flat_params))
        flat_ref = (fg, fs)
        pq_s = [t - g for t, g in zip(seal_s, graph_timer.seconds)]
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
    del idx, xs
    torch.cuda.empty_cache()

    # 4f. a mesh of 4 shards on the card: exact (B1 a shard) and flat with
    # PQ-only seals (the sharded k-means; B4 a shard)
    t_new = time.time()
    # float64 ground truth of all 512 queries, over x and over x with
    # phase 4a's 20,000 added rows (gids)
    truth512 = _ground_truth(x, q, 10)
    truth_after = np.concatenate([gids, np.asarray(new_gids)])[
        _ground_truth(np.concatenate([x, extra]), q, 10)]
    mesh = _mesh_phase(tvs, x, q, gids, truth, tag, launches, exact_ref, pq_s,
                       truth512, tables)
    # 4g. round_robin placement over phase 4a's and 4b's seals
    placement = _placement_phase(tvs, q, tag, launches, exact_storage, storage,
                                 exact_after, flat_ref, flat_params,
                                 truth_after)
    # 4h. query_async through the QueryBatcher; sampled phase histograms
    asyn = _async_phase(tvs, x, q, gids, tag, launches, exact_storage, extra,
                        new_gids, storage, flat_params)
    del exact_storage, storage, extra
    # 4i. the cluster router over two shard servers
    cluster = _cluster_phase(tvs, x, q, tag, launches)
    _log(f"phases 4f-4i {tag}: {time.time() - t_new:.1f} s")
    del x
    gc.collect()
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
         f"(N {deep_brute['x'].shape[0]:,}, fold {geom3['fold']}) {deep_ms:.3f} ms")
    # B1 at the mesh route's shape (a shard of a sift1m segment)
    qm_in, auxm, geomm = exact_ops.pool_inputs(
        mesh_case["q"], mesh_case["x"], mesh_case["valid"], "L2")
    mesh_ms = _time_ms(lambda: exact_ops.exact_pool_cuda(
        qm_in, mesh_case["x"], auxm, **geomm), 20)
    mesh_plain_ms = _time_ms(lambda: exact_ops.exact_pool_plain(
        qm_in, mesh_case["x"], auxm, **geomm), 3, 1)
    mesh_lib_ms = _time_ms(lambda: torch.matmul(qm_in, mesh_case["x"].T), 20)
    nm, wm = mesh_case["x"].shape[0], geomm["w"]
    mesh_bound_ms = max(
        (nm * d * 4 + nm * 4 + qn * d * 4 + qn * wm * 8) / peaks["bytes_s"],
        3 * 2 * qn * nm * d / peaks["bf16"]) * 1e3
    _log(f"timing exact_pool {tag}: at a mesh shard, Q 512 x N {nm:,} x D "
         f"128 (fold {geomm['fold']}): kernel {mesh_ms:.4f} ms, plain "
         f"{mesh_plain_ms:.4f} ms, torch.matmul {mesh_lib_ms:.4f} ms, bound "
         f"{mesh_bound_ms:.4f} ms (operations)")
    del sift_case, two_case, deep_brute, mesh_case
    torch.cuda.empty_cache()
    timings = {"exact_pool": dict(
        ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by="operations" if ops_ms >= bytes_ms else "bytes",
        library_ms=library_ms, ms_2seg=two_ms, ms_deep10m_brute=deep_ms,
        ms_mesh_shard=mesh_ms, plain_ms_mesh_shard=mesh_plain_ms,
        library_ms_mesh_shard=mesh_lib_ms, bound_ms_mesh_shard=mesh_bound_ms,
        **_gist_timings(exact_ops, peaks, tag),
    )}
    timings["exact_pool_packed"] = packed_times
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
    # B3 at openai500k.batch512's segment (M 192: two queries a line)
    wide_lut, _x = _adc_timings(adc_openai, adc_ops, peaks, names=("adc_pool",))
    t = wide_lut["adc_pool"]
    _log(f"timing adc_pool {tag}: Q 512 x N 100,096 x M 192 x K 256 (2 queries "
         f"a line): kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
         f"one-hot torch.matmul {t['library_ms']:.4f} ms, bound "
         f"{t['bound_ms']:.4f} ms ({t['bound_by']}), lookup ceiling (bank "
         f"reads) {_x['adc_pool']['lookup_ceiling_ms']:.4f} ms, kernel on codes "
         f"equal in every row {_x['adc_pool']['same_codes_ms']:.4f} ms")
    timings["adc_pool"].update({
        f"{key}_openai_segment": v for key, v in t.items() if key != "bound_by"})
    del adc_openai
    torch.cuda.empty_cache()
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
    # and at the mesh route's shard (N 25,024), CUDA graphs as at its route
    mroute, mextra = _adc_timings(adc_mesh, adc_ops, peaks,
                                  names=("adc_scores",), graph=True)
    t = mroute["adc_scores"]
    _log(f"timing adc_scores {tag}: at a mesh shard, Q 512 x N 25,024 x M 16 "
         f"x K 256, CUDA graphs of 20 calls: kernel {t['ms']:.4f} ms, plain "
         f"{t['plain_ms']:.4f} ms, one-hot torch.matmul {t['library_ms']:.4f} "
         f"ms, bound {t['bound_ms']:.4f} ms ({t['bound_by']})")
    timings["adc_scores"].update({
        f"{key}_mesh_shard": v for key, v in t.items() if key != "bound_by"})
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
                                      deep["per_batch"],
                                      mesh["exact"]["counts"],
                                      mesh["flat"]["counts"],
                                      placement["exact_counts"],
                                      placement["flat_counts"]))
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
    # the mesh route (4 shards a sealed segment): per-shard N 25,024
    entries[0]["mesh_launches_per_batch"] = mesh["exact"]["counts"]["exact_pool"]
    entries[3]["mesh_launches_per_batch"] = mesh["flat"]["counts"]["adc_scores"]
    entries[0]["round_robin_launches_per_batch"] = (
        placement["exact_counts"]["exact_pool"])
    _log(f"recall@10 {tag}: exact {exact_recall:.4f}, flat {flat_recall:.4f}, "
         f"unified flat {unified_recall:.4f}, graph {graph['recall']:.4f} "
         f"(BEAM {graph['beam_recall']:.4f}, RANDOM_PIVOTS "
         f"{graph['pivots_recall']:.4f}, unified graph "
         f"{graph['unified_recall']:.4f}), small-segment flat "
         f"{small_recall:.4f}, deep10m exact {deep['recall']:.4f} (self-recall "
         f"after churn {deep['self_recall']:.4f}), mesh exact "
         f"{mesh['exact']['recall']:.4f}, mesh flat "
         f"{mesh['flat']['recall']:.4f}, async {asyn['recall']:.4f}; "
         f"cluster routed batch {cluster['latency_ms']:.1f} ms; deep10m QPS "
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
