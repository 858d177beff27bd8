// ADC kernels over PQ codes: the Hopper counterparts of the four Pallas
// kernels of vectorsearch_tpu/ops/pallas/adc.py.
//
//   adc_pool_launch          <- _adc_pool_kernel   (adc.py:274, via adc_bin_pool)
//   adc_scores_launch        <- _adc_kernel_scores (adc.py:79, via adc_scan_scores_pallas)
//   adc_scan_launch          <- _adc_kernel_fast   (adc.py:68, via adc_scan_pallas)
//   adc_scan_precise_launch  <- _adc_kernel        (adc.py:51, via adc_scan_pallas(precise=True))
//
// Function (what the TPU kernels compute, not how: they expand the codes into
// a one-hot matrix for the TPU's matrix unit): for query q and row r
//     a[q, r] = sum over m, in m order, in f32, of lut[q, m, codes[r, m]]
// with the LUT in bf16, the TPU kernels' LUT precision (the precise scan sums
// a hi and a lo bf16 plane separately and adds the two sums). Then:
//   pool    per (group g, bin b): the max of -a[q, r] over the valid rows
//           r / (fold*tile) == g, r % bins == b, and the smallest such row
//           (-inf / -1 when the bin has no valid row);
//   scores  bf16(-a[q, r]), -inf at invalid rows and at pad columns r >= N;
//   scan    a[q, r] (hi + lo for precise), +inf at invalid rows.
// The plain PyTorch versions (vectorsearch_torch/ops/adc.py) repeat the same
// additions in the same order, so the two agree bit for bit.
//
// What bounds it on an H100: the card's bound for this work is bytes (codes,
// LUT and outputs: at the sift1m segment shape Q 512, N 100,096, M 16, K 256
// the pool moves ~57 MB, 0.017 ms at 3.35 TB/s, against 0.012 ms for the
// Q*N*M f32 adds at 67 TFLOP/s). What bounds this kernel is the Q*N*M
// data-dependent table lookups in shared memory (8.2e8 per segment; a
// Hopper SM serves 32 bank reads a cycle, so ~0.11 ms without bank
// conflicts) and the instructions around each one.
//
// Design (first port, simple and right): a block owns a tile of up to 16
// queries and a range of rows (scans) or pool columns (pool). It stages the
// tile's bf16 LUTs in shared memory once (8 KB per query at M 16, K 256; the
// wrapper shrinks the tile for wide LUTs and raises when one query's LUT
// does not fit), then each thread takes one row at a time: one 16-byte load
// brings 16 codes into registers (narrower loads for an odd M or an
// unaligned table), and the thread sums the 16 lookups for every query of
// the tile, so each code load serves the whole tile. The pool's thread owns
// a pool column and walks its rows in ascending order with a strict `>`, so
// ties keep the smallest row; no block depends on another. About four waves
// of blocks per launch spread each block's LUT load over many rows. Bank
// conflicts of the random lookups, warp-level LUT replication and tensor-core
// forms are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int QMAX = 16;  // queries per block at most (the wrapper may pick fewer)
constexpr int MG = 16;    // codes held in registers per step: one 16-byte load

enum Mode { POOL = 0, SCORES = 1, SCAN = 2 };

__device__ __forceinline__ float bf16_to_f32(unsigned short h) {
  return __uint_as_float(((unsigned int)h) << 16);
}

// Copies `count` bf16 values from device memory into shared memory, 16 bytes
// at a time where the sizes and addresses allow it.
__device__ __forceinline__ void stage(unsigned short* dst,
                                      const unsigned short* __restrict__ src,
                                      int count) {
  if ((count & 7) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0 &&
      (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    for (int i = threadIdx.x; i < count / 8; i += THREADS) d4[i] = __ldg(s4 + i);
  } else {
    for (int i = threadIdx.x; i < count; i += THREADS) dst[i] = src[i];
  }
}

// codes[m0, m0 + cnt) of one row into four words (code i of the group in byte
// i % 4 of word i / 4). FULL: cnt == 16 and the address is 16-byte aligned.
template <bool FULL>
__device__ __forceinline__ void load_codes(const uint8_t* __restrict__ p,
                                           int cnt, uint32_t w[4]) {
  if (FULL) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = v.x;
    w[1] = v.y;
    w[2] = v.z;
    w[3] = v.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) w[j] = 0u;
#pragma unroll
    for (int i = 0; i < MG; ++i)
      if (i < cnt) w[i >> 2] |= (uint32_t)__ldg(p + i) << (8 * (i & 3));
  }
}

// acc[q] = sum over m of lut[q, m, code_m] for the tile's queries q < nq, in
// m order (lo[q] the same over the lo plane when PRECISE).
template <bool PRECISE, bool FULL>
__device__ __forceinline__ void row_sums(const unsigned short* lut_s,
                                         int lo_off,
                                         const uint8_t* __restrict__ row,
                                         int M, int K, int MK, int nq,
                                         float acc[QMAX], float lo[QMAX]) {
#pragma unroll
  for (int q = 0; q < QMAX; ++q) {
    acc[q] = 0.f;
    if (PRECISE) lo[q] = 0.f;
  }
  for (int m0 = 0; m0 < M; m0 += MG) {
    const int cnt = min(MG, M - m0);
    uint32_t w[4];
    load_codes<FULL>(row + m0, cnt, w);
#pragma unroll
    for (int i = 0; i < MG; ++i) {
      if (!FULL && i >= cnt) break;
      const int code = (w[i >> 2] >> (8 * (i & 3))) & 0xFF;
      const unsigned short* p = lut_s + (m0 + i) * K + code;
#pragma unroll
      for (int q = 0; q < QMAX; ++q) {
        if (q < nq) {
          acc[q] += bf16_to_f32(p[q * MK]);
          if (PRECISE) lo[q] += bf16_to_f32(p[lo_off + q * MK]);
        }
      }
    }
  }
}

template <int MODE, bool PRECISE, bool FULL>
__global__ void __launch_bounds__(THREADS) adc_kernel(
    const unsigned short* __restrict__ lut,     // [Q, M, K] bf16 (hi plane)
    const unsigned short* __restrict__ lut_lo,  // [Q, M, K] bf16 (PRECISE)
    const uint8_t* __restrict__ codes,          // [N, M]
    const uint8_t* __restrict__ valid,          // [N] 0 / 1
    float* __restrict__ out_f,                  // POOL [Q, W]; SCAN [Q, N]
    int* __restrict__ out_i,                    // POOL [Q, W]
    __nv_bfloat16* __restrict__ out_h,          // SCORES [Q, items]
    int Q, int N, int M, int K, int qt, int items, int per_block, int tile,
    int bins, int fold) {
  extern __shared__ __align__(16) unsigned short lut_s[];
  const int MK = M * K;
  const int q0 = blockIdx.x * qt;
  const int nq = min(qt, Q - q0);
  const int lo_off = qt * MK;
  stage(lut_s, lut + (long long)q0 * MK, nq * MK);
  if (PRECISE) stage(lut_s + lo_off, lut_lo + (long long)q0 * MK, nq * MK);
  __syncthreads();

  const int it0 = blockIdx.y * per_block;
  const int it1 = min(items, it0 + per_block);
  float acc[QMAX], lo[QMAX];
  for (int it = it0 + threadIdx.x; it < it1; it += THREADS) {
    if (MODE == POOL) {
      // pool column it = (group g, bin b); its rows ascend by `bins`
      const int g = it / bins;
      const long long row0 = (long long)g * fold * tile + (it - g * bins);
      const int slices = fold * tile / bins;
      float best[QMAX];
      int best_row[QMAX];
#pragma unroll
      for (int q = 0; q < QMAX; ++q) {
        best[q] = -CUDART_INF_F;
        best_row[q] = -1;
      }
      for (int s = 0; s < slices; ++s) {
        const long long r = row0 + (long long)s * bins;
        if (r >= N) break;  // later slices lie further past N
        if (!valid[r]) continue;
        row_sums<false, FULL>(lut_s, 0, codes + r * M, M, K, MK, nq, acc, lo);
#pragma unroll
        for (int q = 0; q < QMAX; ++q) {
          const float sc = -acc[q];
          if (q < nq && sc > best[q]) {
            best[q] = sc;
            best_row[q] = (int)r;
          }
        }
      }
#pragma unroll
      for (int q = 0; q < QMAX; ++q) {
        if (q < nq) {
          const long long o = (long long)(q0 + q) * items + it;
          out_f[o] = best[q];
          out_i[o] = best_row[q];
        }
      }
    } else if (MODE == SCORES) {
      const bool ok = it < N && valid[it];
      if (ok) row_sums<false, FULL>(lut_s, 0, codes + (long long)it * M, M, K, MK, nq, acc, lo);
#pragma unroll
      for (int q = 0; q < QMAX; ++q) {
        if (q < nq)
          out_h[(long long)(q0 + q) * items + it] =
              __float2bfloat16_rn(ok ? -acc[q] : -CUDART_INF_F);
      }
    } else {
      const bool ok = valid[it] != 0;
      if (ok) row_sums<PRECISE, FULL>(lut_s, lo_off, codes + (long long)it * M, M, K, MK, nq, acc, lo);
#pragma unroll
      for (int q = 0; q < QMAX; ++q) {
        if (q < nq) {
          const float v = PRECISE ? acc[q] + lo[q] : acc[q];
          out_f[(long long)(q0 + q) * N + it] = ok ? v : CUDART_INF_F;
        }
      }
    }
  }
}

template <int MODE, bool PRECISE, bool FULL>
int launch(const void* lut, const void* lut_lo, const void* codes,
           const void* valid, float* out_f, int* out_i, void* out_h, int Q,
           int N, int M, int K, int qt, int items, int grid_y, int tile,
           int bins, int fold, cudaStream_t stream) {
  // above 48 KB this relies on adc_init() having raised the limit
  const size_t smem = (size_t)(PRECISE ? 2 : 1) * qt * M * K * sizeof(unsigned short);
  const int per_block = (items + grid_y - 1) / grid_y;
  dim3 grid((Q + qt - 1) / qt, grid_y);
  adc_kernel<MODE, PRECISE, FULL><<<grid, THREADS, smem, stream>>>(
      (const unsigned short*)lut, (const unsigned short*)lut_lo,
      (const uint8_t*)codes, (const uint8_t*)valid, out_f, out_i,
      (__nv_bfloat16*)out_h, Q, N, M, K, qt, items, per_block, tile, bins, fold);
  return (int)cudaGetLastError();
}

// 16-byte code loads need M a multiple of 16 and an aligned table.
bool full_rows(const void* codes, int M) {
  return M % 16 == 0 && (reinterpret_cast<uintptr_t>(codes) & 15) == 0;
}

}  // namespace

// Lets every kernel instantiation take the current device's opt-in maximum of
// dynamic shared memory (a tile of 16 queries' LUTs is 128 KB at M 16, K 256;
// the default limit is 48 KB). The wrappers call it once per device before
// their first launch there, so a launch makes no other CUDA call. Always
// the maximum, so threads launching with other tiles never lower each
// other's limit. Returns the first CUDA error (0 = done).
extern "C" int adc_init() {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const void* kernels[] = {
      (const void*)adc_kernel<POOL, false, true>,
      (const void*)adc_kernel<POOL, false, false>,
      (const void*)adc_kernel<SCORES, false, true>,
      (const void*)adc_kernel<SCORES, false, false>,
      (const void*)adc_kernel<SCAN, false, true>,
      (const void*)adc_kernel<SCAN, false, false>,
      (const void*)adc_kernel<SCAN, true, true>,
      (const void*)adc_kernel<SCAN, true, false>,
  };
  for (const void* k : kernels)
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  return (int)e;
}

// Each entry launches on the caller's stream and returns cudaGetLastError()
// (0 = launched). Shapes are checked by the Python wrappers
// (vectorsearch_torch/ops/adc.py).

extern "C" int adc_pool_launch(const void* lut, const void* codes,
                               const void* valid, float* out_s, int* out_i,
                               int Q, int N, int M, int K, int qt, int tile,
                               int bins, int fold, int W, int grid_y,
                               void* stream) {
  if (Q <= 0 || W <= 0) return (int)cudaSuccess;
  auto s = (cudaStream_t)stream;
  if (full_rows(codes, M))
    return launch<POOL, false, true>(lut, nullptr, codes, valid, out_s, out_i,
                                     nullptr, Q, N, M, K, qt, W, grid_y, tile,
                                     bins, fold, s);
  return launch<POOL, false, false>(lut, nullptr, codes, valid, out_s, out_i,
                                    nullptr, Q, N, M, K, qt, W, grid_y, tile,
                                    bins, fold, s);
}

extern "C" int adc_scores_launch(const void* lut, const void* codes,
                                 const void* valid, void* out, int Q, int N,
                                 int M, int K, int qt, int n_out, int grid_y,
                                 void* stream) {
  if (Q <= 0 || n_out <= 0) return (int)cudaSuccess;
  auto s = (cudaStream_t)stream;
  if (full_rows(codes, M))
    return launch<SCORES, false, true>(lut, nullptr, codes, valid, nullptr,
                                       nullptr, out, Q, N, M, K, qt, n_out,
                                       grid_y, 1, 1, 1, s);
  return launch<SCORES, false, false>(lut, nullptr, codes, valid, nullptr,
                                      nullptr, out, Q, N, M, K, qt, n_out,
                                      grid_y, 1, 1, 1, s);
}

extern "C" int adc_scan_launch(const void* lut, const void* codes,
                               const void* valid, float* out, int Q, int N,
                               int M, int K, int qt, int grid_y, void* stream) {
  if (Q <= 0 || N <= 0) return (int)cudaSuccess;
  auto s = (cudaStream_t)stream;
  if (full_rows(codes, M))
    return launch<SCAN, false, true>(lut, nullptr, codes, valid, out, nullptr,
                                     nullptr, Q, N, M, K, qt, N, grid_y, 1, 1,
                                     1, s);
  return launch<SCAN, false, false>(lut, nullptr, codes, valid, out, nullptr,
                                    nullptr, Q, N, M, K, qt, N, grid_y, 1, 1,
                                    1, s);
}

extern "C" int adc_scan_precise_launch(const void* hi, const void* lo,
                                       const void* codes, const void* valid,
                                       float* out, int Q, int N, int M, int K,
                                       int qt, int grid_y, void* stream) {
  if (Q <= 0 || N <= 0) return (int)cudaSuccess;
  auto s = (cudaStream_t)stream;
  if (full_rows(codes, M))
    return launch<SCAN, true, true>(hi, lo, codes, valid, out, nullptr,
                                    nullptr, Q, N, M, K, qt, N, grid_y, 1, 1,
                                    1, s);
  return launch<SCAN, true, false>(hi, lo, codes, valid, out, nullptr, nullptr,
                                   Q, N, M, K, qt, N, grid_y, 1, 1, 1, s);
}
