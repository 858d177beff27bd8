"""Exact binned pool: stage 1 (scan + per-bin arg-max) and stage 2 (top-k of
the pool), so the [Q, N] score matrix never has to be ranked whole.

Mirrors ``vectorsearch_tpu/ops/pallas/exact.py``. Its two TPU kernels become
one hand-written CUDA source on the tensor cores,
``vectorsearch_torch/csrc/exact_pool_tc.cu``: ``_pool_kernel`` (two planes,
score and row id) is ``exact_pool_cuda``, and ``_packed_pool_kernel`` (one
plane of score|slot values) is ``exact_pool_packed_cuda``. Each has a plain
PyTorch version beside it (``exact_pool_plain``, ``exact_pool_packed_plain``)
that computes the same function and is what a CPU tensor runs. A CUDA tensor
launches the kernel or raises: there is no fallback.

The pool function is the TPU kernel's, so the two pools compare directly:
the geometry (tile, bins, fold, pool width W) comes from ``_stage1_params``,
and bin b of group g holds the max rank score over the rows r < N with
r // (fold*tile) == g and r % bins == b, with the smallest such row as its id.
A true top-k row is lost only when two of them share a bin (the per-bucket
max estimator of the TPU-KNN paper, PAPERS.md).

``packed=None`` resolves by row count, as in the JAX package: tables of
2,000,000 rows or more take the packed kernel (``_packed_default``).

Intended differences from the JAX package (ROADMAP.md Queue C):
- stage 2 is an exact ``torch.topk`` where the JAX package used
  ``approx_max_k`` at recall target 0.99 (never worse), over the packed
  plane too;
- the JAX package's ``VSTPU_EXACT_PACKED`` environment override has no
  counterpart: ``packed=`` is the switch;
- ``use_fused_exact_pool`` has no backend test, so the CPU runs the same
  binned route as the card;
- a pool of more than 65,535 column blocks raises (the grid's limit): past
  ~536M rows at tile 1,024 and fold 8 on B1 and on B2's wide form, ~268M on
  B2's pipelined form.
"""

from __future__ import annotations

import contextlib
import ctypes
import threading

import torch

from vectorsearch_torch.ops.distance import matmul_nt
from vectorsearch_torch.utils import cuda_build
from vectorsearch_torch.utils.metrics import get_registry, span

_BINS = 128  # one 128-wide row of bins per 1024 rows of tile

# Below this row count a plain score matrix + top-k is cheaper than the
# binned pool, and tiny tables divide into too few bins for a useful pool.
MIN_ROWS = 16_384

# packed=None takes the packed kernel from this many rows on (the JAX
# package's row-count policy: below it the two-plane kernel served faster
# on the TPU, above it the packed pool's halved write won)
_PACKED_MIN_ROWS = 2_000_000


def _packed_default(n_rows: int) -> bool:
    return n_rows >= _PACKED_MIN_ROWS


def _auto_tile(qp: int, d: int, requested: int | None) -> int:
    """The row tile exactly as the JAX package picks it (its VMEM budget
    test included): the tile decides which rows share a bin, so the port's
    pool stays comparable with the JAX pool."""
    if requested is not None:
        bins = _BINS * max(1, requested // 1024)
        if requested % bins:
            raise ValueError(
                f"tile_n={requested} must be a multiple of bins={bins}"
            )
        return requested
    budget = 11 * 1024 * 1024
    for t in (2048, 1024, 512):
        c = _BINS * max(1, t // 1024)
        need = 2 * (qp * c * 4) + 2 * t * d * 4 + c * d * 4 + qp * d * 8
        if need <= budget:
            return t
    return 512


def _auto_fold(w_raw: int, requested: int | None, min_w: int = 16384) -> int:
    """Fold factor: merge consecutive tiles into one pool group until the
    pool is about ``min_w`` bins wide (capped at 8)."""
    if requested is not None:
        return requested
    f = 1
    while f < 8 and w_raw // f > min_w:
        f *= 2
    return f


def _stage1_params(qn: int, d: int, n: int, tile_n: int | None,
                   fold: int | None, min_w: int):
    """Static stage-1 geometry: (tile, bins, fold, W)."""
    qp = max(8, -(-qn // 8) * 8)
    tile = _auto_tile(qp, d, tile_n)
    bins = _BINS * max(1, tile // 1024)
    nn = -(-n // tile)
    f = _auto_fold(nn * bins, fold, min_w)
    return tile, bins, f, -(-nn // f) * bins


def _packed_steps(tile: int, bins: int, fold: int) -> tuple[float, float]:
    """(F, SQ) of the packed pool: F = fold * tile/bins slots per bin, and
    SQ = 2^23 / F quantization steps, so |rint(v * SQ/scale)| <= SQ keeps
    every packed value rint(..) * F + slot below 2^24, an exact f32 integer."""
    slot_f = float(fold * (tile // bins))
    return slot_f, float(1 << 23) / slot_f


# ------------------------------------------------------------- the kernel


def _bind_tc(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.exact_pool_plan.argtypes = [
        i, i, i, i, i, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_longlong),
    ]
    lib.exact_pool_plan.restype = ctypes.c_int
    lib.exact_pool_launch.argtypes = [
        p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, p, ctypes.c_longlong, p,
    ]
    lib.exact_pool_launch.restype = ctypes.c_int
    lib.exact_pool_packed_launch.argtypes = [
        p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, ctypes.c_float, p,
        ctypes.c_longlong, p,
    ]
    lib.exact_pool_packed_launch.restype = ctypes.c_int


_count_lock = threading.Lock()

#: Registry counter of B1's launches, by the form the kernel took
#: (attribute ``form``): ``resident`` (rows of up to 128 live features: the
#: narrow kernel, the query tile's planes split once into shared memory) or
#: ``pipelined`` (wider rows: the wide form's own mainloop, a TMA ring fed
#: with x and with the query planes split once a launch); and by the
#: queries a block (attribute ``tile``, an int).
LAUNCHES = "vectorsearch.exact_pool.launches"
#: Registry counter of B2's launches, by the form the kernel took
#: (attribute ``form``): ``pipelined`` (its own mainloop, resident query
#: planes, a TMA ring) or ``wide`` (rows too wide for those planes: B1's
#: wide mainloop with B2's tile epilogue, which packs in the kernel; one
#: launch a call, not counted under ``LAUNCHES``).
PACKED_LAUNCHES = "vectorsearch.exact_pool.packed.launches"
_FORMS = {1: "pipelined", 2: "wide", 3: "resident"}  # csrc's enum Form
_MAX_SLICES = 65_534  # csrc/exact_pool_tc.cu: 16-bit slice ids, one kept free
#: Span of one launch of B2's wide form, recorded always (one a packed
#: call: two a Cohere10M batch), with the attributes ``queries`` (all the
#: call's) and ``rows`` (the table's).
WIDE_PASS = "vectorsearch.exact_pool.wide_pass"


def _check_d_live(who: str, d_live, d: int) -> int:
    """The live width, D by default; raises outside 1 .. D."""
    d_live = d if d_live is None else int(d_live)
    if not 1 <= d_live <= d:
        raise ValueError(f"{who}: d_live={d_live} outside 1 .. {d}")
    return d_live


def _pad_width(q_in, x, d_live):
    """q_in and x as the kernels take them: a row stride that is a multiple
    of 4 floats and x on a 16-byte boundary (16-byte copies and TMA tensor
    maps need both). Otherwise both are copied with zero columns up to the
    next multiple of 4; ``d_live`` (default: the width given) keeps the
    original width, so the kernels skip the zeros and no bit changes. The
    index's tables are lane-padded and never copy -> (q_in, x, d_live)."""
    d = x.shape[1]
    d_live = d if d_live is None else d_live
    if d % 4 or x.data_ptr() % 16:
        pad = (0, -d % 4)
        q_in = torch.nn.functional.pad(q_in, pad)
        x = torch.nn.functional.pad(x, pad)
    return q_in, x, d_live


def _launch(who, dev, fn, *args):
    """Calls the library's launch function ``fn`` with ``args`` and the
    current stream of ``dev``, with ``dev`` the current device; raises on a
    CUDA error."""
    with torch.cuda.device(dev):
        rc = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{who} failed: CUDA error {rc}")


def _plan(lib, who, qn, d, d_live, w, packed):
    """(form, queries a block, scratch floats) of a launch, as csrc's
    exact_pool_plan decides them; raises where no form takes the geometry
    (more column blocks than a grid holds)."""
    tile, scratch = ctypes.c_int(0), ctypes.c_longlong(0)
    form = lib.exact_pool_plan(qn, d, d_live, w, int(packed),
                               ctypes.byref(tile), ctypes.byref(scratch))
    if form not in _FORMS:
        raise ValueError(
            f"{who}: no form of the kernel takes Q={qn} D={d} d_live={d_live} "
            f"W={w} (more than 65,535 column blocks)"
        )
    return _FORMS[form], tile.value, scratch.value


def _check_kernel_args(who, q_in, x, aux, metric, tile, bins, fold, w,
                       per_query=()):
    """Raises on what the pool kernels do not take: tensors off the card
    or of another type, shape or layout, a geometry that does not cover N,
    and more row slices per group than 16-bit slice ids hold
    (``per_query``: extra (name, tensor) pairs of shape [Q])."""
    qn, d = q_in.shape
    n = x.shape[0]
    dev = x.device
    for name, t, shape in (
        ("q", q_in, (qn, d)), ("x", x, (n, d)),
        ("aux", aux, (2 if metric == "COSINE" else 1, n)),
    ) + tuple((name, t, (qn,)) for name, t in per_query):
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{who}: {name} must be on {dev} (CUDA)")
        if t.dtype != torch.float32:
            raise ValueError(f"{who}: {name} must be float32")
        if tuple(t.shape) != shape:
            raise ValueError(
                f"{who}: {name} has shape {tuple(t.shape)}, expected {shape}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{who}: {name} must be contiguous")
    if bins % 128 or tile % bins or w % bins or w // bins != -(-n // (fold * tile)):
        raise ValueError(
            f"{who}: inconsistent geometry tile={tile} bins={bins} "
            f"fold={fold} w={w} n={n}"
        )
    if n >= 2**31:
        raise ValueError(f"{who}: table too large for int32 row ids")
    if fold * (tile // bins) > _MAX_SLICES:
        raise ValueError(
            f"{who}: fold={fold} x tile/bins={tile // bins} row slices per "
            f"pool group, at most {_MAX_SLICES:,}"
        )


def exact_pool_cuda(q_in, x, aux, *, metric, tile, bins, fold, w,
                    d_live=None):
    """Launches the CUDA pool kernel on the current stream. q_in f32[Q, D]
    (pre-doubled for L2), x f32[N, D], aux f32[1|2, N] -> (scores f32[Q, W],
    row ids i32[Q, W]). ``d_live`` (default D): the kernel reads features
    0 .. d_live-1 only; the caller vouches that the others are zero in q_in
    or in x (lane padding), so skipping them changes no bit. A width that
    is no multiple of 4 is copied with zero columns first (``_pad_width``).
    Rows over 128 live features take a scratch of split query planes
    (``torch.empty``, 3.9 MB at Q 512 x 960, as csrc's exact_pool_plan
    sizes it). ``exact_pool_cuda.launches`` counts the launches, and the
    registry's ``LAUNCHES`` counts them by the form and the query tile the
    kernel took."""
    who = "exact_pool_cuda"
    d_live = _check_d_live(who, d_live, q_in.shape[1])
    _check_kernel_args(who, q_in, x, aux, metric, tile, bins, fold, w)
    q_in, x, d_live = _pad_width(q_in, x, d_live)
    (qn, d), n = q_in.shape, x.shape[0]
    cosine = metric == "COSINE"
    dev = x.device
    lib = cuda_build.load("exact_pool_tc", _bind_tc)
    form, nq, nplane = _plan(lib, who, qn, d, d_live, w, packed=False)
    outs = torch.empty((qn, w), dtype=torch.float32, device=dev)
    outi = torch.empty((qn, w), dtype=torch.int32, device=dev)
    # the wide form's query planes: released with the call, which the
    # caching allocator orders after the launch on this stream
    planes = torch.empty((nplane,), dtype=torch.float32, device=dev) if nplane else None
    _launch(
        "exact_pool_launch", dev, lib.exact_pool_launch,
        q_in.data_ptr(), x.data_ptr(), aux[0].data_ptr(),
        aux[1].data_ptr() if cosine else None,
        outs.data_ptr(), outi.data_ptr(),
        qn, n, d, d_live, tile, bins, fold, w, int(cosine),
        planes.data_ptr() if nplane else None, nplane,
    )
    with _count_lock:
        exact_pool_cuda.launches += 1
    if qn and w:  # else nothing was launched
        get_registry().inc(LAUNCHES, attrs={"form": form, "tile": nq})
    return outs, outi


exact_pool_cuda.launches = 0


def exact_pool_plain(q_in, x, aux, *, metric, tile, bins, fold, w,
                     d_live=None):
    """The kernel's function in plain PyTorch (same arguments and outputs;
    ``d_live`` is not needed: the columns past it are zero and add exact
    zeros to the full product). Dead bins score -inf; their id is the bin's
    first row (unspecified by the contract, masked downstream)."""
    cross = matmul_nt(q_in, x)  # [Q, N], full f32
    if metric == "COSINE":
        s = cross * aux[0][None, :] + aux[1][None, :]
    else:
        s = cross - aux[0][None, :]
    return bin_argmax(s, tile=tile, bins=bins, fold=fold, w=w)


def bin_argmax(s: torch.Tensor, *, tile, bins, fold, w):
    """The binned pool of a [Q, N] score matrix: bin b of group g holds the
    max over the rows r with r // (fold*tile) == g and r % bins == b, with
    the smallest such row as its id -> (f32[Q, W], i32[Q, W]). A NaN score
    never wins a bin (the kernels' `>` max); a dead bin scores -inf and its
    id is the bin's first row (unspecified by the contract, masked
    downstream)."""
    qn, n = s.shape
    s = torch.where(torch.isnan(s), float("-inf"), s.float())
    ng, span = w // bins, fold * tile
    s = torch.nn.functional.pad(s, (0, ng * span - n), value=float("-inf"))
    s = s.view(qn, ng, span // bins, bins)
    m = s.amax(dim=2)  # [Q, ng, bins]
    slot = torch.arange(span // bins, device=s.device, dtype=torch.int32)
    first = torch.where(
        s == m.unsqueeze(2), slot[None, None, :, None], span // bins
    ).amin(dim=2)  # smallest row attaining the max
    rows = (
        torch.arange(ng, device=s.device, dtype=torch.int32)[None, :, None] * span
        + first * bins
        + torch.arange(bins, device=s.device, dtype=torch.int32)[None, None, :]
    )
    return m.reshape(qn, w), rows.reshape(qn, w).to(torch.int32)


def pack_tiles(m, rows, mult, qn2, *, metric, tile, bins, fold, w, slot_f):
    """B2's packing of B1's pool at fold 1 (m f32[Q, T * bins], rows
    i32[Q, T * bins]: each of the T tiles' raw max per bin and the row that
    attains it; a dead bin's m is -inf, its row any) -> the packed plane
    f32[Q, W]. Per tile, each bin's (max, slot) is compressed once into
        p = rint(v * mult) * F + (j * tile/bins + slot),  F = slot_f,
    with v = -sqrt(max(||q||^2 - max, 0)) (L2: minus the distance) or
    v = max (cosine), slot the row's slice in its tile and j the tile's
    place in its fold group; the pool column holds the max of p over the
    group's tiles. Tiles are quantized one by one, so two tiles whose
    maxima fall on one step resolve toward the higher slot. rint rounds half
    to even. A dead bin reads -inf."""
    qn = m.shape[0]
    per = tile // bins
    nn = m.shape[1] // bins
    m = m.view(qn, nn, bins)
    slot = ((rows.view(qn, nn, bins) % tile) // bins).float()
    if metric == "COSINE":
        v = m
    else:
        v = -torch.sqrt(torch.clamp(qn2[:, None, None] - m, min=0.0))
    j = (torch.arange(nn, device=m.device) % fold).float()[None, :, None]
    p = torch.round(v * mult[:, None, None]) * slot_f + (j * per + slot)
    ng = w // bins
    p = torch.nn.functional.pad(p, (0, 0, 0, ng * fold - nn), value=float("-inf"))
    return p.view(qn, ng, fold, bins).amax(dim=2).reshape(qn, w)


def exact_pool_packed_cuda(q_in, x, aux, mult, qn2, *, metric, tile, bins,
                           fold, w, slot_f, d_live=None):
    """Launches the packed CUDA pool kernel on the current stream. q_in
    f32[Q, D] (pre-doubled for L2), x f32[N, D], aux f32[1|2, N], mult and
    qn2 f32[Q] (the quantization factor SQ/scale and ||q||^2) -> the packed
    plane f32[Q, W]. ``d_live`` (default D): the kernel reads features
    0 .. d_live-1 only; the caller vouches that the others are zero in q_in
    or in x (lane padding), so skipping them changes no bit. A width that
    is no multiple of 4 is copied with zero columns first (``_pad_width``).
    Rows too wide for the pipelined form's resident planes take B2's wide
    form: one launch of all Q queries at the pool's fold, B1's wide
    mainloop packing in its tile epilogue, with a scratch of split query
    planes (as csrc's exact_pool_plan sizes it: 3.1 MB at Q 512 x 768) and
    one ``WIDE_PASS`` span. Both forms pack inside the kernel.
    ``exact_pool_packed_cuda.launches`` counts the calls, and
    the registry's ``PACKED_LAUNCHES`` counts them by the form the pool
    took."""
    who = "exact_pool_packed_cuda"
    (qn, d), n = q_in.shape, x.shape[0]
    dev = x.device
    _check_kernel_args(who, q_in, x, aux, metric, tile, bins, fold, w,
                       per_query=(("mult", mult), ("qn2", qn2)))
    if slot_f != _packed_steps(tile, bins, fold)[0]:
        raise ValueError(f"{who}: slot_f={slot_f} is not fold*tile/bins")
    if tile // bins > 16:
        raise ValueError(
            f"{who}: tile/bins={tile // bins} row slices per tile, at most 16 "
            "(4-bit slice ids)"
        )
    d_live = _check_d_live(who, d_live, d)
    q_in, x, d_live = _pad_width(q_in, x, d_live)
    d = x.shape[1]
    lib = cuda_build.load("exact_pool_tc", _bind_tc)
    form, _nq, nplane = _plan(lib, who, qn, d, d_live, w, packed=True)
    out = torch.empty((qn, w), dtype=torch.float32, device=dev)
    # the wide form's query planes: released with the call, which the
    # caching allocator orders after the launch on this stream
    planes = torch.empty((nplane,), dtype=torch.float32, device=dev) if nplane else None
    cosine = metric == "COSINE"
    wide = form == "wide" and qn > 0 and w > 0  # else nothing is launched
    with span(WIDE_PASS, {"queries": qn, "rows": n}) if wide else contextlib.nullcontext():
        _launch(
            "exact_pool_packed_launch", dev, lib.exact_pool_packed_launch,
            q_in.data_ptr(), x.data_ptr(), aux[0].data_ptr(),
            aux[1].data_ptr() if cosine else None,
            mult.data_ptr(), qn2.data_ptr(), out.data_ptr(),
            qn, n, d, d_live, tile, bins, fold, w, int(cosine), slot_f,
            planes.data_ptr() if nplane else None, nplane,
        )
    with _count_lock:
        exact_pool_packed_cuda.launches += 1
    if qn and w:  # else nothing was launched
        get_registry().inc(PACKED_LAUNCHES, attrs={"form": form})
    return out


exact_pool_packed_cuda.launches = 0


def exact_pool_packed_plain(q_in, x, aux, mult, qn2, *, metric, tile, bins,
                            fold, w, slot_f, d_live=None):
    """The packed kernel's function in plain PyTorch (same arguments and
    output; ``d_live`` is not needed: the columns past it are zero and add
    exact zeros to the full product): the binned pool at fold 1, whose bins
    are each tile's raw (max, smallest row), packed by ``pack_tiles``."""
    cross = matmul_nt(q_in, x)  # [Q, N], full f32
    if metric == "COSINE":
        s = cross * aux[0][None, :] + aux[1][None, :]
    else:
        s = cross - aux[0][None, :]
    del cross
    nn = -(-x.shape[0] // tile)  # the tiles that hold rows (the TPU kernel's grid)
    m, rows = bin_argmax(s, tile=tile, bins=bins, fold=1, w=nn * bins)
    del s
    return pack_tiles(m, rows, mult, qn2, metric=metric, tile=tile,
                      bins=bins, fold=fold, w=w, slot_f=slot_f)


# ------------------------------------------------------------ the wrapper


def pool_inputs(
    q: torch.Tensor,  # f32[Q, D]
    x: torch.Tensor,  # f32[N, D]
    valid: torch.Tensor,  # bool[N]
    metric: str = "L2",
    tile_n: int | None = None,
    xn2: torch.Tensor | None = None,  # f32[N] precomputed squared norms
    fold: int | None = None,
    min_w: int = 16384,
    d_live: int | None = None,
):
    """The kernel's arguments: (q_in, aux, geometry). Column terms are
    computed here, outside the kernel, with validity folded in (as the JAX
    wrapper does): L2 aux = ||x||^2 (+inf if invalid) with q pre-doubled;
    cosine aux = (1/||x|| or 0 for a zero row, 0 or -inf if invalid). The
    geometry carries ``d_live`` (default D: the features past it are zero
    padding, which the kernels skip); the tile is chosen at the padded D,
    as in the JAX package, since it decides which rows share a bin."""
    qn, d = q.shape
    n = x.shape[0]
    tile, bins, f, w = _stage1_params(qn, d, n, tile_n, fold, min_w)
    if xn2 is None:
        xf = x.float()
        xn2 = torch.sum(xf * xf, dim=1)
    inf = float("inf")
    if metric == "COSINE":
        nz = valid & (xn2 > 0.0)
        inv = torch.where(nz, torch.rsqrt(torch.where(nz, xn2, 1.0)), 0.0)
        bias = torch.where(valid, 0.0, -inf)
        aux = torch.stack([inv, bias]).float()
        q_in = q.float().contiguous()
    else:
        aux = torch.where(valid, xn2, inf)[None, :].float().contiguous()
        q_in = (q.float() * 2.0).contiguous()  # folds the 2x into the product
    return q_in, aux, dict(metric=metric, tile=tile, bins=bins, fold=f, w=w,
                           d_live=d if d_live is None else d_live)


def exact_bin_pool(
    q: torch.Tensor,  # f32[Q, D]
    x: torch.Tensor,  # f32[N, D]
    valid: torch.Tensor,  # bool[N]
    metric: str = "L2",
    tile_n: int | None = None,
    xn2: torch.Tensor | None = None,  # f32[N] precomputed squared norms
    fold: int | None = None,
    min_w: int = 16384,
    d_live: int | None = None,
):
    """Stage 1: (scores f32[Q, W], row ids i32[Q, W]) with
    W = ceil(ceil(N/tile)/fold) * bins. Invalid rows never win a bin; a bin
    with no valid row scores -inf. A CUDA tensor runs the kernel, a CPU
    tensor its plain version. ``d_live``: the features past it are zero
    (lane padding); the kernel skips them."""
    q_in, aux, geom = pool_inputs(q, x, valid, metric, tile_n, xn2, fold,
                                  min_w, d_live)
    fn = exact_pool_cuda if x.is_cuda else exact_pool_plain
    return fn(q_in, x, aux, **geom)


def packed_pool_inputs(
    q: torch.Tensor,  # f32[Q, D]
    x: torch.Tensor,  # f32[N, D]
    valid: torch.Tensor,  # bool[N]
    metric: str = "L2",
    tile_n: int | None = None,
    xn2: torch.Tensor | None = None,
    fold: int | None = None,
    min_w: int = 16384,
    d_live: int | None = None,
):
    """The packed kernel's arguments: (q_in, aux, mult, qn2, step, geometry),
    the two-plane kernel's q_in and aux plus, per query, the quantization
    factor mult = SQ/scale, ||q||^2 (zeros for cosine) and the
    dequantization step scale/SQ. ``scale`` bounds every valid value the
    kernel quantizes: L2 ||q|| + max valid ||x|| (a bound on the distance),
    cosine ||q||; both at least 1e-30. The geometry is ``pool_inputs``'
    (``d_live`` included) with ``slot_f``."""
    q_in, aux, geom = pool_inputs(q, x, valid, metric, tile_n, xn2, fold,
                                  min_w, d_live)
    slot_f, sq_steps = _packed_steps(geom["tile"], geom["bins"], geom["fold"])
    qf = q.float()
    qnorm = torch.sqrt(torch.sum(qf * qf, dim=1))
    if metric == "COSINE":
        scale = torch.clamp(qnorm, min=1e-30)
        qn2 = torch.zeros_like(scale)
    else:
        # aux = ||x||^2 of valid rows, +inf for the others
        mx2 = torch.where(valid, aux[0], 0.0).max()
        scale = torch.clamp(qnorm + torch.sqrt(mx2), min=1e-30)
        qn2 = qnorm * qnorm
    mult = (sq_steps / scale).contiguous()
    return (q_in, aux, mult, qn2.contiguous(), scale / sq_steps,
            dict(geom, slot_f=slot_f))


def exact_bin_pool_packed(
    q: torch.Tensor,  # f32[Q, D]
    x: torch.Tensor,  # f32[N, D]
    valid: torch.Tensor,  # bool[N]
    metric: str = "L2",
    tile_n: int | None = None,
    xn2: torch.Tensor | None = None,
    fold: int | None = None,
    min_w: int = 16384,
    d_live: int | None = None,
):
    """Packed stage 1: (ONE f32[Q, W] plane whose values order by quantized
    score and carry the winning slot, the dequantization step f32[Q]).
    Decode with decode_packed_pool under the same geometry arguments. A
    CUDA tensor runs the kernel, a CPU tensor its plain version.
    ``d_live``: the features past it are zero (lane padding); the kernel
    skips them."""
    q_in, aux, mult, qn2, step, geom = packed_pool_inputs(
        q, x, valid, metric, tile_n, xn2, fold, min_w, d_live
    )
    fn = exact_pool_packed_cuda if x.is_cuda else exact_pool_packed_plain
    return fn(q_in, x, aux, mult, qn2, **geom), step


def decode_packed_pool(
    pvals: torch.Tensor,  # f32[Q, E] selected packed values
    pos: torch.Tensor,  # i32[Q, E] their columns in the [Q, W] pool
    step: torch.Tensor,  # f32[Q] dequantization step (scale/SQ)
    q: torch.Tensor,  # f32[Q, D] queries (||q||^2 for the L2 dequant)
    metric: str,
    *, d: int, n: int, qn: int, tile_n: int | None, fold: int | None,
    min_w: int,
):
    """(packed value, pool column) -> (rank score f32, global row id i32),
    per-element algebra (no kernel; the JAX package computes it outside its
    kernel too). The geometry arguments must be those of the
    exact_bin_pool_packed call that made the pool. Inverts the packing:
    L2 dist = -level * step, score = ||q||^2 - dist^2 (the
    pairwise_rank_scores convention exact_finalize expects); cosine
    score = level * step. Empty slots (-inf) decode to (-inf, -1)."""
    tile, bins, f, _w = _stage1_params(qn, d, n, tile_n, fold, min_w)
    slot_f, _sq = _packed_steps(tile, bins, f)
    ok = pvals > float("-inf")
    pv = torch.where(ok, pvals, 0.0)  # keeps the integer algebra NaN-free
    level = torch.floor(pv / slot_f)  # exact: slot_f is a power of two
    slot = (pv - level * slot_f).to(torch.int32)  # [0, F)
    if metric == "COSINE":
        scores = level * step[:, None]
    else:
        qf = q.float()
        dist = -level * step[:, None]
        scores = torch.sum(qf * qf, dim=1)[:, None] - dist * dist
    scores = torch.where(ok, scores, float("-inf"))
    per = tile // bins
    pos = pos.to(torch.int32)
    t = (pos // bins) * f + slot // per
    rows = t * tile + (slot % per) * bins + pos % bins
    return scores, torch.where(ok, rows, -1).to(torch.int32)


def _halve_pool(outs: torch.Tensor, outi: torch.Tensor, times: int):
    """Paired max over adjacent bins: [Q, W] -> [Q, W/2] per halving (the
    same estimator as bins twice as wide)."""
    for _ in range(times):
        w = outs.shape[1] // 2 * 2
        s = outs[:, :w].reshape(outs.shape[0], -1, 2)
        i = outi[:, :w].reshape(outi.shape[0], -1, 2)
        left = s[:, :, 0] >= s[:, :, 1]
        outs = torch.where(left, s[:, :, 0], s[:, :, 1])
        outi = torch.where(left, i[:, :, 0], i[:, :, 1])
    return outs, outi


def exact_pool_scored(
    q: torch.Tensor,
    x: torch.Tensor,
    valid: torch.Tensor,
    *,
    ef_buf: int,
    metric: str = "L2",
    tile_n: int | None = None,
    stage2_halve: int = 0,
    xn2: torch.Tensor | None = None,
    fold: int | None = None,
    packed: bool | None = None,
    d_live: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact candidate pool WITH its rank scores: (scores f32[Q, ef_buf],
    row ids i32[Q, ef_buf]), -inf / -1 in empty slots. The scores are the
    ops/distance.pairwise_rank_scores conventions (L2 -> 2 q.x - ||x||^2,
    COSINE -> (q.x)/||x||), so ops/traversal.exact_finalize rebuilds true
    distances from them with no row gather.

    ``packed`` (None: by row count, ``_packed_default``): stage 1 emits the
    single packed score|slot plane and stage 2 decodes the row ids from the
    values and their columns. Its scores carry the packing's quantization
    (a step of scale/SQ); ``stage2_halve`` reduces (score, id) pairs and so
    always takes the two-plane kernel. ``d_live``: the features past it are
    zero (lane padding), which both kernels skip."""
    if packed is None:
        packed = _packed_default(x.shape[0])
    min_w = max(16384, 4 * ef_buf)
    if packed and not stage2_halve:
        pool, step = exact_bin_pool_packed(
            q, x, valid, metric=metric, tile_n=tile_n, xn2=xn2, fold=fold,
            min_w=min_w, d_live=d_live,
        )
        pv, pos = torch.topk(pool, min(ef_buf, pool.shape[1]), dim=1)
        if pos.shape[1] < ef_buf:
            pad = ef_buf - pos.shape[1]
            pv = torch.nn.functional.pad(pv, (0, pad), value=float("-inf"))
            pos = torch.nn.functional.pad(pos, (0, pad))
        return decode_packed_pool(
            pv, pos, step, q, metric, d=q.shape[1], n=x.shape[0],
            qn=q.shape[0], tile_n=tile_n, fold=fold, min_w=min_w,
        )
    outs, outi = exact_bin_pool(
        q, x, valid, metric=metric, tile_n=tile_n, xn2=xn2, fold=fold,
        min_w=min_w, d_live=d_live,
    )
    if stage2_halve:
        outs, outi = _halve_pool(outs, outi, stage2_halve)
    return pool_topk(outs, outi, ef_buf)


def pool_topk(outs: torch.Tensor, outi: torch.Tensor, ef_buf: int):
    """Stage 2: the pool's top ef_buf -> (scores f32[Q, ef_buf], row ids
    i32[Q, ef_buf]), -inf / -1 in empty slots. An exact top-k at every
    width: the JAX package sorts a pool exactly only while W <= 2*ef_buf and
    takes approx_max_k above that; exact is never worse, so the two branches
    are one here. A pool narrower than ef_buf pads with empty slots."""
    top, pos = torch.topk(outs, min(ef_buf, outs.shape[1]), dim=1)
    if pos.shape[1] < ef_buf:
        pad = ef_buf - pos.shape[1]
        top = torch.nn.functional.pad(top, (0, pad), value=float("-inf"))
        pos = torch.nn.functional.pad(pos, (0, pad))
    rows = torch.gather(outi, 1, pos)
    ok = top > float("-inf")
    return torch.where(ok, top, float("-inf")), torch.where(ok, rows, -1)


def exact_pool_topk(
    q: torch.Tensor, x: torch.Tensor, valid: torch.Tensor, *, ef_buf: int,
    metric: str = "L2", tile_n: int | None = None,
    xn2: torch.Tensor | None = None,
) -> torch.Tensor:
    """Exact candidate pool -> i32[Q, ef_buf] row ids (-1 = empty)."""
    return exact_pool_scored(
        q, x, valid, ef_buf=ef_buf, metric=metric, tile_n=tile_n, xn2=xn2,
    )[1]


def use_fused_exact_pool(n: int, d: int, ef_buf: int) -> bool:
    """Whether the binned pool replaces the plain score matrix + top-k:
    enough rows to amortize, and enough bins to cover the pool width. Unlike
    the JAX package there is no backend test: CPU and card take one route."""
    if n < MIN_ROWS:
        return False
    return (-(-n // 4096)) * _BINS >= ef_buf
