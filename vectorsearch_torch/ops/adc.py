"""ADC kernels: binned pool, negated-scores scan and distance scan over PQ
codes, one wrapper per kernel.

Mirrors ``vectorsearch_tpu/ops/pallas/adc.py``. Its four Pallas kernels
become the hand-written CUDA kernels of ``vectorsearch_torch/csrc/adc.cu``:

  B3 ``_adc_pool_kernel``   -> ``adc_pool_cuda``          (plain: ``adc_pool_plain``)
  B4 ``_adc_kernel_scores`` -> ``adc_scores_cuda``        (plain: ``adc_scores_plain``)
  B5 ``_adc_kernel_fast``   -> ``adc_scan_cuda``          (plain: ``adc_scan_plain``)
  B5 ``_adc_kernel``        -> ``adc_scan_precise_cuda``  (plain: ``adc_scan_precise_plain``)

Each computes WHAT its TPU kernel computes, not how: the TPU kernels expand
the byte codes into a one-hot matrix and multiply it with the LUT on the
matrix unit (``adc.py:1-10``); on the card a shared-memory table lookup gives
the same sums. The function, for query q and row r:

  a[q, r] = sum over m, in m order, in f32, of bf16(lut[q, m, codes[r, m]])

(the precise scan sums a hi and a lo bf16 plane of the f32 LUT separately
and adds the two sums). The plain versions repeat that arithmetic in the
same order, so kernel and plain version agree bit for bit; a CPU tensor runs
the plain version, a CUDA tensor launches the kernel or raises.

One design serves all four (the source's header states it): a block stages
a tile of queries' LUT query-major, one line per (m, code), read by the
lanes of a row group together. The pool is one kernel (form ``_POOL``); the
three scans are forms of one line-scan kernel (``_FAST``, ``_SCORES``,
``_PRECISE``) that stage each warp's outputs in a shared-memory tile and
write each query's columns as whole lines. ``_line_queries`` picks the
line's width (16 queries, 8 for the precise scan, narrower for wide LUTs
and small batches), ``_line_chunk`` the rows (output columns) of a scan's
work item.

The pool's function is the TPU kernel's, so pools compare directly: the
geometry (tile, bins, fold, W) is the JAX package's, and bin b of group g
holds the max negated score over the valid rows r with r // (fold*tile) == g
and r % bins == b, with the smallest such row as its id.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from vectorsearch_torch.ops.exact import _auto_fold, bin_argmax, pool_topk
from vectorsearch_torch.utils import cuda_build

INF = float("inf")
_BINS = 128  # one 128-wide row of bins per 1024 rows of tile

# Below this the plain scores scan + top-k is cheaper than the binned pool,
# and tiny segments divide into too few bins for a useful pool.
MIN_ROWS_POOL = 16_384

# Shared memory: 227 KB at most per block on Hopper.
_SMEM_BYTES = 227 * 1024
# The kernels' block: 1024 threads, 32 warps; a scan warp takes 32 columns
# at a time, a block 1024.
_LINE_THREADS = 1024
_LINE_WARPS = _LINE_THREADS // 32
# The kernel forms (``Form`` in csrc/adc.cu): B3's pool, and the line-scan
# kernel's B5-precise, B5-fast and B4 forms.
_POOL, _PRECISE, _FAST, _SCORES = 0, 1, 2, 3


# ------------------------------------------------------------ geometry


def _auto_pool_tile(qp: int, mk: int) -> int:
    """The row tile as the JAX package picks it (its VMEM budget included),
    so the two pools bin the same rows together; where the JAX package finds
    no tile it falls back to 1024, and so does this."""
    budget = 14 * 1024 * 1024
    fixed = qp * mk * 2 + mk * 4
    for t, c in ((2048, 256), (1024, 128)):
        need = fixed + c * mk * 6 + qp * c * 4
        need += 2 * qp * (_BINS * max(1, t // 1024)) * 8
        if need <= budget:
            return t
    return 1024


def pool_geometry(qn: int, m: int, k: int, n: int, tile_n: int | None = None,
                  fold: int | None = None, min_w: int = 16384):
    """The binned pool's (tile, bins, fold, W) for Q queries over N rows."""
    if tile_n is not None:
        bins = _BINS * max(1, tile_n // 1024)
        if tile_n % bins:
            raise ValueError(f"tile_n={tile_n} must be a multiple of bins={bins}")
        tile = tile_n
    else:
        tile = _auto_pool_tile(max(8, -(-qn // 8) * 8), m * k)
    bins = _BINS * max(1, tile // 1024)
    nn = -(-n // tile)
    f = _auto_fold(nn * bins, fold, min_w)
    return tile, bins, f, -(-nn // f) * bins


def scores_width(n: int) -> int:
    """Width of the negated-scores output: N rounded up to 128 columns (the
    TPU kernel's smallest tile); the pad columns score -inf."""
    return -(-n // 128) * 128


def use_fused_adc_pool(n: int, ef_buf: int) -> bool:
    """Whether the binned pool replaces the scores scan + top-k: enough rows
    to amortize, and enough bins to cover ef_buf. By shape alone, on both
    devices (the JAX package's backend and layout tests are TPU constraints)."""
    if n < MIN_ROWS_POOL:
        return False
    return (-(-n // 2048)) * 2 * _BINS >= ef_buf


def lut_bf16(lut: torch.Tensor) -> torch.Tensor:
    """The f32 LUT rounded to bf16 (the TPU kernels' LUT precision)."""
    return lut.float().to(torch.bfloat16).contiguous()


def lut_hi_lo(lut: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The precise scan's two bf16 planes of the f32 LUT: hi keeps the top
    16 bits of each f32 (exactly a bf16), lo = bf16(lut - hi)."""
    f = lut.float().contiguous()
    hi = (f.view(torch.int32) & -65536).view(torch.float32)
    return hi.to(torch.bfloat16), (f - hi).to(torch.bfloat16)


# ------------------------------------------------------------- the kernels


def _bind(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.adc_pool_launch.argtypes = [p, p, p, p, p] + [i] * 10 + [p]
    lib.adc_scores_launch.argtypes = [p, p, p, p] + [i] * 8 + [p]
    lib.adc_scan_launch.argtypes = [p, p, p, p] + [i] * 7 + [p]
    lib.adc_scan_precise_launch.argtypes = [p, p, p, p, p] + [i] * 7 + [p]
    lib.adc_init.argtypes = []
    lib.adc_lines_blocks_per_sm.argtypes = [i, p, i, i, i, ctypes.POINTER(i)]
    for fn in (lib.adc_pool_launch, lib.adc_scores_launch,
               lib.adc_scan_launch, lib.adc_scan_precise_launch, lib.adc_init,
               lib.adc_lines_blocks_per_sm):
        fn.restype = ctypes.c_int


def _load_kernel():
    """The built csrc/adc.cu library (see utils/cuda_build.py)."""
    return cuda_build.load("adc", _bind)


_count_lock = threading.Lock()
_sm_count: dict[int, int] = {}
_line_blocks_per_sm: dict[tuple, int] = {}  # by device and kernel form
_ready: set[int] = set()  # devices where adc_init has raised the smem limit


def _device_index(dev) -> int:
    return dev.index if dev.index is not None else torch.cuda.current_device()


def _prepare(lib, dev) -> None:
    """The library's one-time set-up on a device (``adc_init``: the kernels
    may take the opt-in maximum of shared memory), so launches make no
    other CUDA call. Runs under ``torch.cuda.device(dev)``."""
    di = _device_index(dev)
    if di in _ready:
        return
    with _count_lock:
        if di not in _ready:
            _launch("adc_init", lib.adc_init)
            _ready.add(di)


def _check(name, codes, valid, planes):
    """Device, type, shape and layout checks shared by the kernel wrappers;
    returns (Q, N, M, K)."""
    dev = codes.device
    qn, m, k = planes[0].shape
    n = codes.shape[0]
    for label, t, dtype, shape in (
        [(f"lut{i}", p, torch.bfloat16, (qn, m, k)) for i, p in enumerate(planes)]
        + [("codes", codes, torch.uint8, (n, m)), ("valid", valid, torch.bool, (n,))]
    ):
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: {label} must be on {dev} (CUDA)")
        if t.dtype != dtype:
            raise ValueError(f"{name}: {label} must be {dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(
                f"{name}: {label} has shape {tuple(t.shape)}, expected {shape}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")
    if k > 256:
        raise ValueError(f"{name}: K={k} > 256 does not fit byte codes")
    if n >= 2**31:
        raise ValueError(f"{name}: table too large for int32 row ids")
    return qn, n, m, k


def _sms(dev) -> int:
    di = _device_index(dev)
    if di not in _sm_count:
        _sm_count[di] = torch.cuda.get_device_properties(di).multi_processor_count
    return _sm_count[di]


def _line_layout(ql: int, form: int) -> tuple[int, int, int]:
    """(G, WB, LB) of a LUT line (``Lines`` in csrc/adc.cu): G lanes a row
    group, each reading WB bytes of the LB-byte line. One 32-bit word of two
    queries' bf16 values a lane, and at QL 1 the one query's bf16 (WB 2);
    B5-precise: one query's hi and lo a lane."""
    g = ql if form == _PRECISE else max(1, ql // 2)
    wb = 2 if form != _PRECISE and ql == 1 else 4
    return g, wb, g * wb


def _tile_stride(ql: int, form: int) -> int:
    """Elements a row of a scan warp's output tile (``ScanTile`` in
    csrc/adc.cu): 32 columns and a pad of RGW/2 (two queries a lane) or RGW
    (B5-precise, one query a lane), RGW = 32/G, so that a warp's 32 stores
    fall in distinct banks."""
    rgw = 32 // _line_layout(ql, form)[0]
    return 32 + (rgw if form == _PRECISE else rgw // 2)


def _line_smem(ql: int, m: int, k: int, form: int) -> int:
    """Bytes of a block's shared memory (``line_smem`` in csrc/adc.cu): M*K
    lines of QL queries, bf16 each or B5-precise's hi/lo word each, and for
    the scans a [QL x _tile_stride] output tile a warp (f32; bf16 for B4;
    none at G 1, whose lanes store their own rows)."""
    g, _, lb = _line_layout(ql, form)
    tiles = 0
    if form != _POOL and g > 1:
        elem = 2 if form == _SCORES else 4
        tiles = _LINE_WARPS * ql * _tile_stride(ql, form) * elem
    return m * k * lb + tiles


def _line_queries(name: str, qn: int, m: int, k: int, form: int) -> int:
    """Queries a LUT line: the widest power of two (16, B5-precise 8 at
    most) whose block fits in shared memory and that the batch fills more
    than half (a batch of Q < 16 queries takes the smallest line that holds
    them all)."""
    ql = 8 if form == _PRECISE else 16
    while ql > 1 and (ql >= 2 * qn or _line_smem(ql, m, k, form) > _SMEM_BYTES):
        ql //= 2
    if _line_smem(ql, m, k, form) > _SMEM_BYTES:
        raise ValueError(
            f"{name}: a LUT of M={m} x K={k} "
            f"({_line_smem(1, m, k, form)} bytes of lines for one query) "
            f"does not fit in a block's {_SMEM_BYTES} bytes of shared memory"
        )
    return ql


def _line_blocks(lib, dev, form: int, codes, m: int, k: int, ql: int) -> int:
    """Blocks of the form's kernel the card holds at once (its occupancy:
    registers, threads and shared memory, times the SMs): the persistent
    wave, of which a launch takes no more blocks than it has items. Asked
    of the card once per device and form. Runs under
    ``torch.cuda.device(dev)``, after ``_prepare``."""
    key = (_device_index(dev), form, ql, m, k, codes.data_ptr() % 16)
    if key not in _line_blocks_per_sm:
        blocks = ctypes.c_int(0)
        _launch("adc_lines_blocks_per_sm", lib.adc_lines_blocks_per_sm,
                form, codes.data_ptr(), m, k, ql, ctypes.byref(blocks))
        _line_blocks_per_sm[key] = max(1, blocks.value)
    return _sms(dev) * _line_blocks_per_sm[key]


def _line_chunk(width: int, tiles: int, blocks: int) -> int:
    """Columns of a scan's (query tile, chunk) item, a multiple of 32. A
    1024-column chunk is one round of the block's 32 warps; with items in
    order over the wave a block may stage two tiles' LUTs. Where the tiles
    fit the wave, splitting each tile's columns evenly over the blocks one
    tile gets gives every block one item, one stage: taken when that costs
    no more rounds of 1024 columns on the busiest block."""
    rounds = -(-tiles * -(-width // 1024) // blocks)
    per_tile = blocks // tiles
    if per_tile >= 1:
        split = 32 * -(-width // (32 * per_tile))
        if -(-split // 1024) <= rounds:
            return split
    return 1024


def _launch(name, fn, *args):
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{name} failed: CUDA error {rc}")


def _count(wrapper) -> None:
    with _count_lock:
        wrapper.launches += 1


def _output(name, out, shape, dtype, dev):
    """A new output tensor, or the caller's ``out`` after checking that the
    kernel may write it as a dense [Q, W] plane."""
    if out is None:
        return torch.empty(shape, dtype=dtype, device=dev)
    if (tuple(out.shape) != shape or out.dtype != dtype or out.device != dev
            or not out.is_contiguous()):
        raise ValueError(
            f"{name}: out must be a contiguous {dtype}{list(shape)} on {dev}"
        )
    return out


def adc_pool_cuda(lut_h, codes, valid, *, tile, bins, fold, w, out=None):
    """B3 on the card: lut_h bf16[Q, M, K], codes u8[N, M], valid bool[N]
    -> (negated scores f32[Q, W], row ids i32[Q, W]; -inf / -1 in dead bins),
    written into ``out`` (a pair of such planes) when given.
    ``adc_pool_cuda.launches`` counts the launches."""
    qn, n, m, k = _check("adc_pool_cuda", codes, valid, [lut_h])
    if bins % 128 or tile % bins or w % bins or w // bins != -(-n // (fold * tile)):
        raise ValueError(
            f"adc_pool_cuda: inconsistent geometry tile={tile} bins={bins} "
            f"fold={fold} w={w} n={n}"
        )
    dev = codes.device
    outs, outi = out if out is not None else (None, None)
    outs = _output("adc_pool_cuda", outs, (qn, w), torch.float32, dev)
    outi = _output("adc_pool_cuda", outi, (qn, w), torch.int32, dev)
    if qn == 0 or w == 0:
        return outs, outi
    ql = _line_queries("adc_pool_cuda", qn, m, k, _POOL)
    chunks = -(-w // (_LINE_THREADS // _line_layout(ql, _POOL)[0]))
    lib = _load_kernel()
    with torch.cuda.device(dev):
        _prepare(lib, dev)
        grid = min(-(-qn // ql) * chunks,
                   _line_blocks(lib, dev, _POOL, codes, m, k, ql))
        _launch("adc_pool_launch", lib.adc_pool_launch,
                lut_h.data_ptr(), codes.data_ptr(), valid.data_ptr(),
                outs.data_ptr(), outi.data_ptr(),
                qn, n, m, k, ql, tile, bins, fold, w, grid,
                torch.cuda.current_stream(dev).cuda_stream)
    _count(adc_pool_cuda)
    return outs, outi


adc_pool_cuda.launches = 0


def _scan_lines(wrapper, form, entry, planes, codes, valid, out=None):
    """Launches the line-scan kernel's `form` through the library entry
    `entry` (named as the C function) and counts it on `wrapper`: planes
    [lut] or B5-precise's [hi, lo] -> f32[Q, N], B4 bf16[Q, scores_width(N)],
    written into ``out`` when given."""
    name = wrapper.__name__
    qn, n, m, k = _check(name, codes, valid, planes)
    dev = codes.device
    scores = form == _SCORES
    w = scores_width(n) if scores else n
    out = _output(name, out, (qn, w), torch.bfloat16 if scores else torch.float32,
                  dev)
    if qn == 0 or w == 0:
        return out
    ql = _line_queries(name, qn, m, k, form)
    tiles = -(-qn // ql)
    lib = _load_kernel()
    with torch.cuda.device(dev):
        _prepare(lib, dev)
        blocks = _line_blocks(lib, dev, form, codes, m, k, ql)
        chunk = _line_chunk(w, tiles, blocks)
        grid = min(tiles * -(-w // chunk), blocks)
        args = [t.data_ptr() for t in (*planes, codes, valid, out)]
        shape = [qn, n, m, k] + ([w] if scores else [])
        _launch(entry, getattr(lib, entry), *args, *shape, ql, chunk, grid,
                torch.cuda.current_stream(dev).cuda_stream)
    _count(wrapper)
    return out


def adc_scores_cuda(lut_h, codes, valid, out=None):
    """B4 on the card: -> negated scores bf16[Q, N_pad] (N_pad =
    scores_width(N)), -inf at invalid rows and pad columns, written into
    ``out`` when given. ``adc_scores_cuda.launches`` counts the launches."""
    return _scan_lines(adc_scores_cuda, _SCORES, "adc_scores_launch", [lut_h],
                       codes, valid, out)


adc_scores_cuda.launches = 0


def adc_scan_cuda(lut_h, codes, valid):
    """B5 (one bf16 pass) on the card: -> ADC distances f32[Q, N], +inf at
    invalid rows. ``adc_scan_cuda.launches`` counts the launches."""
    return _scan_lines(adc_scan_cuda, _FAST, "adc_scan_launch", [lut_h], codes,
                       valid)


adc_scan_cuda.launches = 0


def adc_scan_precise_cuda(hi, lo, codes, valid):
    """B5 (hi/lo bf16 planes) on the card: -> ADC distances f32[Q, N],
    +inf at invalid rows. ``adc_scan_precise_cuda.launches`` counts the
    launches."""
    return _scan_lines(adc_scan_precise_cuda, _PRECISE,
                       "adc_scan_precise_launch", [hi, lo], codes, valid)


adc_scan_precise_cuda.launches = 0


# ----------------------------------------------------- the plain versions


def _lut_sums(lut_h: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """sum over m, in m order, in f32, of lut_h[q, m, codes[r, m]] -> f32[Q, N]
    (the kernels' arithmetic, term for term; an f32 LUT gives the full-f32
    ADC of ops/pq.adc_scan)."""
    lf = lut_h.float()
    c = codes.long()
    acc = torch.zeros(lut_h.shape[0], codes.shape[0], device=lut_h.device)
    for j in range(lut_h.shape[1]):
        acc += lf[:, j, :][:, c[:, j]]
    return acc


def adc_pool_plain(lut_h, codes, valid, *, tile, bins, fold, w):
    """B3's function in plain PyTorch (same arguments and outputs; a dead
    bin's id is unspecified, masked downstream)."""
    s = torch.where(valid[None, :], -_lut_sums(lut_h, codes), -INF)
    return bin_argmax(s, tile=tile, bins=bins, fold=fold, w=w)


def adc_scores_plain(lut_h, codes, valid):
    """B4's function in plain PyTorch."""
    s = torch.where(valid[None, :], -_lut_sums(lut_h, codes), -INF)
    pad = scores_width(codes.shape[0]) - codes.shape[0]
    return torch.nn.functional.pad(s, (0, pad), value=-INF).to(torch.bfloat16)


def adc_scan_plain(lut_h, codes, valid):
    """B5's (one bf16 pass) function in plain PyTorch."""
    return torch.where(valid[None, :], _lut_sums(lut_h, codes), INF)


def adc_scan_precise_plain(hi, lo, codes, valid):
    """B5's (hi/lo planes) function in plain PyTorch."""
    s = _lut_sums(hi, codes) + _lut_sums(lo, codes)
    return torch.where(valid[None, :], s, INF)


# ------------------------------------------------------------ the wrappers
# Each takes the f32 LUT [Q, M, K]; a CUDA tensor launches the kernel, a CPU
# tensor runs the plain version.


def adc_bin_pool(lut, codes, valid, tile_n: int | None = None,
                 fold: int | None = None, min_w: int = 16384):
    """Stage 1 of the flat pool (B3): (negated scores f32[Q, W], row ids
    i32[Q, W]). A true top-k row is lost only when two of them share a bin."""
    tile, bins, f, w = pool_geometry(
        lut.shape[0], lut.shape[1], lut.shape[2], codes.shape[0], tile_n,
        fold, min_w,
    )
    fn = adc_pool_cuda if codes.is_cuda else adc_pool_plain
    return fn(lut_bf16(lut), codes, valid, tile=tile, bins=bins, fold=f, w=w)


def adc_pool_scored(lut, codes, valid, *, ef_buf: int,
                    tile_n: int | None = None, fold: int | None = None):
    """The flat candidate pool through B3: (negated scores f32[Q, ef_buf],
    row ids i32[Q, ef_buf]), -inf / -1 in empty slots; stage 2 is an exact
    top-k of the bin pool (the JAX package: approx_max_k at 0.95 above
    2*ef_buf)."""
    outs, outi = adc_bin_pool(
        lut, codes, valid, tile_n=tile_n, fold=fold,
        min_w=max(16384, 4 * ef_buf),
    )
    return pool_topk(outs, outi, ef_buf)


def adc_bin_pools(lut_h, codes, valids, *, min_w: int = 16384):
    """B3 over S same-capacity segments, each pooled on its own: lut_h
    bf16[S, Q, M, K] (one LUT per segment's codebook), codes and valids the
    S segments' u8[N, M] and bool[N] -> (negated scores f32[S, Q, W], row
    ids i32[S, Q, W]). One launch per segment, each into its slice of one
    plane, so stage 2 can take every segment's top in one call."""
    s_count, qn, m, k = lut_h.shape
    tile, bins, fold, w = pool_geometry(qn, m, k, codes[0].shape[0],
                                        min_w=min_w)
    geom = dict(tile=tile, bins=bins, fold=fold, w=w)
    outs = torch.empty((s_count, qn, w), dtype=torch.float32, device=lut_h.device)
    outi = torch.empty((s_count, qn, w), dtype=torch.int32, device=lut_h.device)
    for i in range(s_count):
        if codes[i].is_cuda:
            adc_pool_cuda(lut_h[i], codes[i], valids[i], **geom,
                          out=(outs[i], outi[i]))
        else:
            outs[i], outi[i] = adc_pool_plain(lut_h[i], codes[i], valids[i], **geom)
    return outs, outi


def adc_scores_many(lut_h, codes, valids):
    """B4 over S same-capacity segments (arguments as ``adc_bin_pools``) ->
    negated scores bf16[S, Q, N_pad]; one launch per segment into its slice."""
    s_count, qn = lut_h.shape[:2]
    n_out = scores_width(codes[0].shape[0])
    out = torch.empty((s_count, qn, n_out), dtype=torch.bfloat16,
                      device=lut_h.device)
    for i in range(s_count):
        if codes[i].is_cuda:
            adc_scores_cuda(lut_h[i], codes[i], valids[i], out=out[i])
        else:
            out[i] = adc_scores_plain(lut_h[i], codes[i], valids[i])
    return out


def adc_scan_scores(lut, codes, valid):
    """Negated ADC scores bf16[Q, N_pad] through B4."""
    fn = adc_scores_cuda if codes.is_cuda else adc_scores_plain
    return fn(lut_bf16(lut), codes, valid)


def adc_scan_kernel(lut, codes, valid, precise: bool = False):
    """ADC distances f32[Q, N], +inf at invalid rows, through B5: one bf16
    pass, or the hi/lo planes with ``precise=True``."""
    if precise:
        hi, lo = lut_hi_lo(lut)
        fn = adc_scan_precise_cuda if codes.is_cuda else adc_scan_precise_plain
        return fn(hi, lo, codes, valid)
    fn = adc_scan_cuda if codes.is_cuda else adc_scan_plain
    return fn(lut_bf16(lut), codes, valid)
