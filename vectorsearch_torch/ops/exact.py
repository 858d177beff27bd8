"""Exact binned pool: stage 1 (scan + per-bin arg-max) and stage 2 (top-k of
the pool), so the [Q, N] score matrix never has to be ranked whole.

Mirrors ``vectorsearch_tpu/ops/pallas/exact.py``. Its TPU kernel
``_pool_kernel`` becomes the hand-written CUDA kernel in
``vectorsearch_torch/csrc/exact_pool.cu`` (``exact_pool_cuda`` below); its
plain PyTorch version (``exact_pool_plain``) computes the same function and is
what a CPU tensor runs. A CUDA tensor launches the kernel or raises: there is
no fallback.

The pool function is the TPU kernel's, so the two pools compare directly:
the geometry (tile, bins, fold, pool width W) comes from ``_stage1_params``,
and bin b of group g holds the max rank score over the rows r < N with
r // (fold*tile) == g and r % bins == b, with the smallest such row as its id.
A true top-k row is lost only when two of them share a bin (the per-bucket
max estimator of the TPU-KNN paper, PAPERS.md).

Intended differences from the JAX package (ROADMAP.md Queue C):
- stage 2 is an exact ``torch.topk`` where the JAX package used
  ``approx_max_k`` at recall target 0.99 (never worse);
- ``packed=True`` (the score|slot packed kernel, ROADMAP.md Queue B2) raises,
  and ``packed=None`` resolves to the two-plane kernel at every row count;
- ``use_fused_exact_pool`` has no backend test, so the CPU runs the same
  binned route as the card.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from vectorsearch_torch.ops.distance import matmul_nt
from vectorsearch_torch.utils import cuda_build

_BINS = 128  # one 128-wide row of bins per 1024 rows of tile

# Below this row count a plain score matrix + top-k is cheaper than the
# binned pool, and tiny tables divide into too few bins for a useful pool.
MIN_ROWS = 16_384


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


# ------------------------------------------------------------- the kernel


def _bind(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.exact_pool_launch.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, i, p]
    lib.exact_pool_launch.restype = ctypes.c_int


def _load_kernel():
    """The built csrc/exact_pool.cu library (see utils/cuda_build.py)."""
    return cuda_build.load("exact_pool", _bind)


_count_lock = threading.Lock()


def exact_pool_cuda(q_in, x, aux, *, metric, tile, bins, fold, w):
    """Launches the CUDA pool kernel on the current stream. q_in f32[Q, D]
    (pre-doubled for L2), x f32[N, D], aux f32[1|2, N] -> (scores f32[Q, W],
    row ids i32[Q, W]). ``exact_pool_cuda.launches`` counts the launches."""
    qn, d = q_in.shape
    n = x.shape[0]
    cosine = metric == "COSINE"
    dev = x.device
    for name, t, shape in (
        ("q", q_in, (qn, d)), ("x", x, (n, d)),
        ("aux", aux, (2 if cosine else 1, n)),
    ):
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"exact_pool_cuda: {name} must be on {dev} (CUDA)")
        if t.dtype != torch.float32:
            raise ValueError(f"exact_pool_cuda: {name} must be float32")
        if tuple(t.shape) != shape:
            raise ValueError(
                f"exact_pool_cuda: {name} has shape {tuple(t.shape)}, "
                f"expected {shape}"
            )
        if not t.is_contiguous():
            raise ValueError(f"exact_pool_cuda: {name} must be contiguous")
    if bins % 128 or tile % bins or w % bins or w // bins != -(-n // (fold * tile)):
        raise ValueError(
            f"exact_pool_cuda: inconsistent geometry tile={tile} bins={bins} "
            f"fold={fold} w={w} n={n}"
        )
    if n >= 2**31:
        raise ValueError("exact_pool_cuda: table too large for int32 row ids")
    lib = _load_kernel()
    outs = torch.empty((qn, w), dtype=torch.float32, device=dev)
    outi = torch.empty((qn, w), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.exact_pool_launch(
            q_in.data_ptr(), x.data_ptr(), aux[0].data_ptr(),
            aux[1].data_ptr() if cosine else None,
            outs.data_ptr(), outi.data_ptr(),
            qn, n, d, tile, bins, fold, w, int(cosine),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"exact_pool_launch failed: CUDA error {rc}")
    with _count_lock:
        exact_pool_cuda.launches += 1
    return outs, outi


exact_pool_cuda.launches = 0


def exact_pool_plain(q_in, x, aux, *, metric, tile, bins, fold, w):
    """The kernel's function in plain PyTorch (same arguments and outputs).
    Dead bins score -inf; their id is the bin's first row (unspecified by
    the contract, masked downstream)."""
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
):
    """The kernel's arguments: (q_in, aux, geometry). Column terms are
    computed here, outside the kernel, with validity folded in (as the JAX
    wrapper does): L2 aux = ||x||^2 (+inf if invalid) with q pre-doubled;
    cosine aux = (1/||x|| or 0 for a zero row, 0 or -inf if invalid)."""
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
    return q_in, aux, dict(metric=metric, tile=tile, bins=bins, fold=f, w=w)


def exact_bin_pool(
    q: torch.Tensor,  # f32[Q, D]
    x: torch.Tensor,  # f32[N, D]
    valid: torch.Tensor,  # bool[N]
    metric: str = "L2",
    tile_n: int | None = None,
    xn2: torch.Tensor | None = None,  # f32[N] precomputed squared norms
    fold: int | None = None,
    min_w: int = 16384,
):
    """Stage 1: (scores f32[Q, W], row ids i32[Q, W]) with
    W = ceil(ceil(N/tile)/fold) * bins. Invalid rows never win a bin; a bin
    with no valid row scores -inf. A CUDA tensor runs the kernel, a CPU
    tensor its plain version."""
    q_in, aux, geom = pool_inputs(q, x, valid, metric, tile_n, xn2, fold, min_w)
    fn = exact_pool_cuda if x.is_cuda else exact_pool_plain
    return fn(q_in, x, aux, **geom)


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
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact candidate pool WITH its rank scores: (scores f32[Q, ef_buf],
    row ids i32[Q, ef_buf]), -inf / -1 in empty slots. The scores are the
    ops/distance.pairwise_rank_scores conventions (L2 -> 2 q.x - ||x||^2,
    COSINE -> (q.x)/||x||), so ops/traversal.exact_finalize rebuilds true
    distances from them with no row gather."""
    if packed:
        raise NotImplementedError(
            "the packed score|slot pool kernel is not ported yet "
            "(ROADMAP.md Queue B2)"
        )
    outs, outi = exact_bin_pool(
        q, x, valid, metric=metric, tile_n=tile_n, xn2=xn2, fold=fold,
        min_w=max(16384, 4 * ef_buf),
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
