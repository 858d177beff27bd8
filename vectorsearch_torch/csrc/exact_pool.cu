// Exact packed pool B2: the Hopper counterpart of the TPU kernel
// vectorsearch_tpu/ops/pallas/exact.py::_packed_pool_kernel (reached through
// exact_bin_pool_packed), launched through exact_pool_packed_launch below.
// Its two-plane sibling B1 (_pool_kernel) is csrc/exact_pool_tc.cu.
//
// Function: B1's scan (for each query and pool column (group g, bin b), the
// max over the rows r < N with r / (fold*tile) == g and r % bins == b of the
// rank score, L2 (2q).x - aux0[r] or cosine (q.x) * aux0[r] + aux1[r]), but
// per TILE t = g*fold + j of the group the raw (max m, smallest slice a) of
// each bin is compressed once into one exact-integer f32
//     p = rint(v * mult[q]) * F + (j * tile/bins + a),  F = fold * tile/bins
// with v = -sqrt(max(qn2[q] - m, 0)) for L2 (minus the distance; the sqrt
// compression carries recall) and v = m for cosine, and the column holds the
// max of p over the group's tiles. mult = SQ/scale with SQ = 2^23/F keeps
// |p| < 2^24. Tiles are quantized one by one (two tiles on one step resolve
// toward the higher slot), rint rounds half to even, a dead bin reads -inf.
// Rows past N are never read; a NaN score never wins. The build uses no
// fast-math: the epilogue needs IEEE sqrtf and rintf.
//
// What bounds it on an H100: a [Q, N] x [N, D] product folded into a per-bin
// reduction, so the [Q, N] score matrix never reaches device memory. At the
// Deep10M 8-segment shape (Q 512, N 8,000,512, D 128) that is 1.05 TFLOP
// against 4.1 GB of x: operations bound it (the bytes take ~1.3 ms at
// 3.35 TB/s; the FLOPs ~16 ms on the FP32 CUDA cores at 67 TFLOP/s, ~3.2 ms
// as three split-bf16 tensor-core passes at 989 TFLOP/s).
//
// Design (first port, simple and right): FP32 FMA on the CUDA cores, as
// precise as exact_finalize needs (the scores become true distances with no
// re-rank behind them). The grid is (query tile of 64, 128 pool columns of
// one group); each block walks the group's tiles and their row slices in
// ascending order, stages a 64-query x 32-feature tile and a 128-row x
// 32-feature tile in shared memory per step, keeps each tile's raw (max,
// slice) of its 64 x 128 (query, bin) pairs in registers (8 queries x 4 bins
// per thread) and, at each tile's end, compresses and merges it into a
// third register plane of running packed maxima; the per-query mult and
// ||q||^2 sit in registers. The 64 query tiles of one group run side by
// side, so x is read from device memory about once and from L2 after that.
// B1's tensor-core mainloop (exact_pool_tc.cu) is the next step for it, as
// is skipping the zero pad columns (D 96 -> 128 at Deep10M).

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int BQ = 64;        // queries per block
constexpr int BR = 128;       // pool columns (bins) per block
constexpr int KC = 32;        // feature chunk staged per step
constexpr int TQ = 8;         // queries per thread
constexpr int TR = 4;         // bins per thread
constexpr int THREADS = (BQ / TQ) * (BR / TR);  // 256

// Qs is read as float4 along the query axis: its row stride stays a
// multiple of 4 floats. Xs rows are 128 + 4 for the same reason.
struct Stage {
  float q[KC][BQ + 4];
  float x[KC][BR + 4];
};

// acc[i][j] = q[q0 + tq*TQ + i] . x[base + tr*TR + j] over the D features
// (zero for rows past N or queries past Q), through shared memory.
__device__ __forceinline__ void slice_product(
    const float* __restrict__ q, const float* __restrict__ x, int Q, int N,
    int D, int q0, long long base, int tid, int tq, int tr, Stage& st,
    float (&acc)[TQ][TR]) {
#pragma unroll
  for (int i = 0; i < TQ; ++i)
#pragma unroll
    for (int j = 0; j < TR; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < D; k0 += KC) {
    // query tile: a warp reads 32 consecutive features of one query
    for (int e = tid; e < BQ * KC; e += THREADS) {
      const int qq = e / KC, kk = e % KC;
      const int qi = q0 + qq, k = k0 + kk;
      st.q[kk][qq] = (qi < Q && k < D) ? q[(long long)qi * D + k] : 0.f;
    }
    // row tile: a warp reads 32 consecutive features of one row
    for (int e = tid; e < BR * KC; e += THREADS) {
      const int rr = e / KC, kk = e % KC;
      const long long r = base + rr;
      const int k = k0 + kk;
      st.x[kk][rr] = (r < N && k < D) ? x[r * D + k] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < KC; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&st.q[kk][tq * TQ]);
      const float4 a1 = *reinterpret_cast<const float4*>(&st.q[kk][tq * TQ + 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&st.x[kk][tr * TR]);
      const float a[TQ] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[TR] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < TQ; ++i)
#pragma unroll
        for (int j = 0; j < TR; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(THREADS) exact_pool_packed_kernel(
    const float* __restrict__ q,     // [Q, D]
    const float* __restrict__ x,     // [N, D]
    const float* __restrict__ aux0,  // [N]
    const float* __restrict__ aux1,  // [N] (COSINE only)
    const float* __restrict__ mult,  // [Q] SQ / scale
    const float* __restrict__ qn2,   // [Q] ||q||^2 (L2 only)
    float* __restrict__ out,         // [Q, W]
    int Q, int N, int D, int tile, int bins, int fold, int W, int cosine,
    float slot_f) {
  __shared__ __align__(16) Stage st;

  const int tid = threadIdx.x;
  const int tr = tid % (BR / TR);
  const int tq = tid / (BR / TR);
  const int q0 = blockIdx.x * BQ;
  const int col_blocks = bins / BR;
  const int g = blockIdx.y / col_blocks;
  const int b0 = (blockIdx.y % col_blocks) * BR;
  const long long group_row0 = (long long)g * fold * tile;
  const int per = tile / bins;  // row slices per tile

  float qm[TQ], qq[TQ];
#pragma unroll
  for (int i = 0; i < TQ; ++i) {
    const int qi = q0 + tq * TQ + i;
    qm[i] = qi < Q ? mult[qi] : 0.f;
    qq[i] = (qi < Q && !cosine) ? qn2[qi] : 0.f;
  }
  float packed[TQ][TR];
#pragma unroll
  for (int i = 0; i < TQ; ++i)
#pragma unroll
    for (int j = 0; j < TR; ++j) packed[i][j] = -CUDART_INF_F;

  for (int t = 0; t < fold; ++t) {
    const long long tile_row0 = group_row0 + (long long)t * tile;
    if (tile_row0 >= N) break;  // tiles past N hold no rows (no grid step)

    float best[TQ][TR];
    int slot[TQ][TR];
#pragma unroll
    for (int i = 0; i < TQ; ++i)
#pragma unroll
      for (int j = 0; j < TR; ++j) {
        best[i][j] = -CUDART_INF_F;
        slot[i][j] = 0;
      }

    for (int sl = 0; sl < per; ++sl) {
      const long long base = tile_row0 + (long long)sl * bins + b0;
      if (base >= N) break;

      float acc[TQ][TR];
      slice_product(q, x, Q, N, D, q0, base, tid, tq, tr, st, acc);

      // the tile's raw running (max, smallest slice) per bin
#pragma unroll
      for (int j = 0; j < TR; ++j) {
        const long long r = base + tr * TR + j;
        if (r >= N) continue;
        const float c0 = aux0[r];
        const float c1 = cosine ? aux1[r] : 0.f;
#pragma unroll
        for (int i = 0; i < TQ; ++i) {
          const float s = cosine ? acc[i][j] * c0 + c1 : acc[i][j] - c0;
          if (s > best[i][j]) {
            best[i][j] = s;
            slot[i][j] = sl;
          }
        }
      }
    }

    // tile epilogue: compress each bin once, merge over the fold by max
    // (p is never NaN for a real query: a dead bin gives -inf)
#pragma unroll
    for (int i = 0; i < TQ; ++i)
#pragma unroll
      for (int j = 0; j < TR; ++j) {
        const float v =
            cosine ? best[i][j] : -sqrtf(fmaxf(qq[i] - best[i][j], 0.f));
        const float p =
            rintf(v * qm[i]) * slot_f + (float)(t * per + slot[i][j]);
        if (p > packed[i][j]) packed[i][j] = p;
      }
  }

#pragma unroll
  for (int i = 0; i < TQ; ++i) {
    const int qi = q0 + tq * TQ + i;
    if (qi >= Q) continue;
#pragma unroll
    for (int j = 0; j < TR; ++j) {
      out[(long long)qi * W + (long long)g * bins + b0 + tr * TR + j] =
          packed[i][j];
    }
  }
}

}  // namespace

// Launches on the caller's stream; returns cudaGetLastError() (0 =
// launched). Shapes are checked by the Python wrapper
// (vectorsearch_torch/ops/exact.py).
extern "C" int exact_pool_packed_launch(const float* q, const float* x,
                                        const float* aux0, const float* aux1,
                                        const float* mult, const float* qn2,
                                        float* out, int Q, int N, int D,
                                        int tile, int bins, int fold, int W,
                                        int cosine, float slot_f,
                                        void* stream) {
  if (Q <= 0 || W <= 0) return (int)cudaSuccess;
  dim3 grid((Q + BQ - 1) / BQ, W / BR);
  exact_pool_packed_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      q, x, aux0, aux1, mult, qn2, out, Q, N, D, tile, bins, fold, W, cosine,
      slot_f);
  return (int)cudaGetLastError();
}
