// ADC kernels over PQ codes: the Hopper counterparts of the four Pallas
// kernels of vectorsearch_tpu/ops/pallas/adc.py, in two designs.
//
//   adc_pool_launch          <- _adc_pool_kernel   (adc.py:274, via adc_bin_pool)        LINES
//   adc_scan_precise_launch  <- _adc_kernel        (adc.py:51, via adc_scan_pallas(precise=True))  LINES
//   adc_scores_launch        <- _adc_kernel_scores (adc.py:79, via adc_scan_scores_pallas)  ROWS
//   adc_scan_launch          <- _adc_kernel_fast   (adc.py:68, via adc_scan_pallas)     ROWS
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
// Q*N*M f32 adds at 67 TFLOP/s). What bounds these kernels is the Q*N*M
// data-dependent table lookups in shared memory (8.2e8 per segment; a
// Hopper SM serves 32 four-byte bank reads a cycle, ~0.11 ms at one lookup
// per bank read) and the instructions around each one.
//
// ROWS design (B4, B5-fast): a block of 256 threads owns a tile of up to 16
// queries and a range of rows. It stages the tile's bf16 LUTs in shared
// memory query by query ([q][m][k]), then each thread takes one row at a
// time: one 16-byte load brings 16 codes into registers and the thread sums
// the 16 lookups for every query of the tile. The 32 lanes of a load hit 32
// random 2-byte addresses (~3.5 bank wavefronts per 32 lookups), and the
// 128 KB stage leaves room for one block, 8 warps, per SM.
//
// LINES design (B3, B5-precise): the tile's LUT is staged query-major, one
// line per (m, code), so the lanes that share a row read one line together:
//   line li = m*K + c at byte li*LB; lane j of a row group reads the WB
//   bytes at li*LB + j*WB of the line of its row's code c = codes[r, m].
//   B3:       QL queries a line (16, 8, 4, 2 or 1), G = QL/2 lanes a row
//             group, word j = bf16 of query 2j (low half) | query 2j+1 (high
//             half), WB 4, LB 2*QL; at QL 1 the line is the one query's bf16
//             (G 1, WB 2, LB 2).
//   precise:  QL queries a line (8, 4, 2 or 1), G = QL lanes, word j = hi
//             bf16 of query j (low half) | lo bf16 (high half), WB 4, LB 4*QL.
// A warp holds 32/G row groups, each on its own row. A lane unpacks a word
// with a shift and a mask (exact) and adds into two f32 sums in m order.
// At B3's QL 16 one load instruction serves 4 rows x 16 queries = 64
// lookups, its 4 lines in random bank quarters (~2.1 wavefronts); the
// precise scan reads both planes in one load. The wrapper picks the widest
// line that fits a block's shared memory (227 KB, B5-precise's output tiles
// included) and is no wider than the batch needs; it raises when one
// query's line does not fit. Blocks of 1024 threads (32 warps on one 128 KB
// stage) run as one persistent wave (as many blocks as the SMs hold at once,
// adc_lines_blocks_per_sm): block i takes the i-th share of the
// (query tile, chunk) items in order, so it stages at most a few LUTs, each
// transposed into lines inside the kernel (16-byte loads, byte permutes,
// stores rotated over the bank quarters). B3: a chunk is 1024/G pool
// columns, one a row group, walked slice by slice in ascending row order
// with a strict `>` (ties keep the smallest row), the best score and row of
// each of the lane's queries in registers. B5-precise: a chunk is 1024 rows,
// 32 a warp; a warp stages its [QL x 32] outputs in shared memory (row
// stride 32 + 32/G floats: no bank conflict) and writes each query's 32
// rows as one 128-byte line.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

// ===================================================== ROWS (B4, B5-fast)
// (its POOL mode and PRECISE plane are not instantiated: B3 and B5-precise
// run the LINES kernels below)

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

// ================================================= LINES (B3, B5-precise)

constexpr int LTHREADS = 1024;
constexpr int LWARPS = LTHREADS / 32;
constexpr int SCAN_ROWS = LWARPS * 32;  // rows of a B5-precise chunk, 32 a warp

// The line layout of the header: G lanes a row group, WB bytes a lane reads,
// LB bytes a line, RGW row groups a warp.
template <bool PRECISE, int QL>
struct Lines {
  static constexpr int G = PRECISE ? QL : (QL >= 2 ? QL / 2 : 1);
  static constexpr int WB = (PRECISE || QL >= 2) ? 4 : 2;
  static constexpr int LB = G * WB;
  static constexpr int RGW = 32 / G;
};

// Bytes of a block's shared memory: the lines, then (B5-precise, G > 1) one
// [QL x (32 + RGW)] f32 output tile a warp. ops/adc.py::_line_smem mirrors it.
template <bool PRECISE, int QL>
size_t line_smem(int M, int K) {
  using L = Lines<PRECISE, QL>;
  size_t b = (size_t)M * K * L::LB;
  if (PRECISE && L::G > 1) b += (size_t)LWARPS * QL * (32 + L::RGW) * sizeof(float);
  return b;
}

// Rotates w left by r (0..7) places without dynamic register indexing.
__device__ __forceinline__ void rotate8(uint32_t w[8], int r) {
#pragma unroll
  for (int k = 1; k < 8; k <<= 1) {
    uint32_t t[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) t[i] = (r & k) ? w[(i + k) & 7] : w[i];
#pragma unroll
    for (int i = 0; i < 8; ++i) w[i] = t[i];
  }
}

// Stages queries [q0, q0 + nq) of the LUT as lines (header); the words of
// queries past nq hold 0. B3: p0 the bf16 LUT [Q, M, K]; precise: p0 the hi
// and p1 the lo plane. Word j of line mk takes its low half from row A and
// its high half from row B at column mk: B3 A = query 2j, B = query 2j + 1;
// precise A = hi of query j, B = lo of query j.
template <bool PRECISE, int QL>
__device__ __forceinline__ void stage_lines(unsigned char* lines,
                                            const unsigned short* __restrict__ p0,
                                            const unsigned short* __restrict__ p1,
                                            int q0, int nq, int MK) {
  using L = Lines<PRECISE, QL>;
  constexpr int G = L::G;
  const unsigned short* pb = PRECISE ? p1 : p0;
  uint32_t* w32 = reinterpret_cast<uint32_t*>(lines);
  const bool vec = (MK & 7) == 0 && (reinterpret_cast<uintptr_t>(p0) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(pb) & 15) == 0;
  if (L::WB == 2) {  // B3 at QL 1: the one query's LUT as it is
    unsigned short* d = reinterpret_cast<unsigned short*>(lines);
    const unsigned short* src = p0 + (long long)q0 * MK;
    for (int i = threadIdx.x; i < MK; i += LTHREADS) d[i] = src[i];
  } else if (vec) {
    // thread -> (8 consecutive lines, word j): two 16-byte loads, eight
    // words; consecutive threads take consecutive j, then the next 8 lines,
    // and each stores its words rotated by its line block so that one store
    // instruction spreads over all 32 banks
    for (int t = threadIdx.x; t < (MK >> 3) * G; t += LTHREADS) {
      const int j = t % G, cb = t / G;
      const int qa = PRECISE ? j : 2 * j, qb = PRECISE ? j : 2 * j + 1;
      uint4 a = make_uint4(0u, 0u, 0u, 0u), b = a;
      if (qa < nq)
        a = __ldg(reinterpret_cast<const uint4*>(p0 + (long long)(q0 + qa) * MK) + cb);
      if (qb < nq)
        b = __ldg(reinterpret_cast<const uint4*>(pb + (long long)(q0 + qb) * MK) + cb);
      const uint32_t av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
      uint32_t w[8];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        w[2 * e] = __byte_perm(av[e], bv[e], 0x5410);
        w[2 * e + 1] = __byte_perm(av[e], bv[e], 0x7632);
      }
      const int r = cb & 7;
      rotate8(w, r);
#pragma unroll
      for (int s = 0; s < 8; ++s) w32[(cb * 8 + ((s + r) & 7)) * G + j] = w[s];
    }
  } else {
    for (int t = threadIdx.x; t < MK * G; t += LTHREADS) {
      const int j = t % G, mk = t / G;
      const int qa = PRECISE ? j : 2 * j, qb = PRECISE ? j : 2 * j + 1;
      const uint32_t lo = qa < nq ? p0[(long long)(q0 + qa) * MK + mk] : 0u;
      const uint32_t hi = qb < nq ? pb[(long long)(q0 + qb) * MK + mk] : 0u;
      w32[t] = lo | (hi << 16);
    }
  }
}

// Adds the low / high half of the lane's word at `a` into a0 / a1 (B3 at QL
// 1: its 2-byte line into a0).
template <bool PRECISE, int QL>
__device__ __forceinline__ void add_word(const unsigned char* a, float& a0,
                                         float& a1) {
  if (Lines<PRECISE, QL>::WB == 2) {
    a0 += bf16_to_f32(*reinterpret_cast<const unsigned short*>(a));
  } else {
    const uint32_t v = *reinterpret_cast<const uint32_t*>(a);
    a0 += __uint_as_float(v << 16);
    a1 += __uint_as_float(v & 0xFFFF0000u);
  }
}

// a0 / a1 = sum over m, in m order, in f32, of the low / high half of the
// lane's word in line (m, row[m]); `lane_lines` is the lines plus the lane's
// j*WB, KLB = K*LB. B3: the sums of queries 2j and 2j + 1 (QL 1: a0 only);
// precise: the hi and the lo sum. FULL rows read 16 codes a load; the
// others one code a load (any M, any alignment).
template <bool PRECISE, int QL, bool FULL>
__device__ __forceinline__ void line_sums(const unsigned char* lane_lines,
                                          const uint8_t* __restrict__ row,
                                          int M, int KLB, float& a0, float& a1) {
  constexpr int LB = Lines<PRECISE, QL>::LB;
  a0 = 0.f;
  a1 = 0.f;
  if (FULL) {
    for (int m0 = 0; m0 < M; m0 += MG) {
      uint32_t w[4];
      load_codes<true>(row + m0, MG, w);
      const unsigned char* p = lane_lines + m0 * KLB;
#pragma unroll
      for (int i = 0; i < MG; ++i) {
        const int code = (w[i >> 2] >> (8 * (i & 3))) & 0xFF;
        add_word<PRECISE, QL>(p + i * KLB + code * LB, a0, a1);
      }
    }
  } else {
    for (int m = 0; m < M; ++m)
      add_word<PRECISE, QL>(lane_lines + m * KLB + __ldg(row + m) * LB, a0, a1);
  }
}

// The persistent walk over (query tile, chunk) items: block i takes the i-th
// of gridDim.x equal shares of the tiles*chunks items, in order; `t` and `c`
// are the current item's query tile and chunk.
struct Items {
  long long it, end;
  int t, c, chunks;
  __device__ Items(int Q, int QL, int chunks_) : chunks(chunks_) {
    const long long total = (long long)((Q + QL - 1) / QL) * chunks;
    it = total * blockIdx.x / gridDim.x;
    end = total * (blockIdx.x + 1) / gridDim.x;
    t = (int)(it / chunks);
    c = (int)(it - (long long)t * chunks);
  }
  __device__ bool more() const { return it < end; }
  __device__ void next() {
    ++it;
    if (++c == chunks) {
      c = 0;
      ++t;
    }
  }
};

template <int QL, bool FULL>
__global__ void __launch_bounds__(LTHREADS) adc_pool_lines_kernel(
    const unsigned short* __restrict__ lut,  // [Q, M, K] bf16
    const uint8_t* __restrict__ codes,       // [N, M]
    const uint8_t* __restrict__ valid,       // [N] 0 / 1
    float* __restrict__ out_s,               // [Q, W]
    int* __restrict__ out_i,                 // [Q, W]
    int Q, int N, int M, int K, int tile, int bins, int fold, int W) {
  using L = Lines<false, QL>;
  constexpr int RGB = LTHREADS / L::G;  // row groups a block: pool columns a chunk
  extern __shared__ __align__(16) unsigned char lines[];
  const int lane = threadIdx.x & 31, j = lane % L::G;
  const int rg = (threadIdx.x >> 5) * L::RGW + lane / L::G;
  const int KLB = K * L::LB;
  const int slices = fold * tile / bins;
  const int qa = L::WB == 4 ? 2 * j : 0;  // the lane's first query in the tile
  const unsigned char* mine = lines + j * L::WB;
  int staged = -1;
  for (Items items(Q, QL, (W + RGB - 1) / RGB); items.more(); items.next()) {
    const int q0 = items.t * QL, nq = min(QL, Q - q0);
    if (items.t != staged) {
      if (staged >= 0) __syncthreads();  // every warp is done with the old lines
      stage_lines<false, QL>(lines, lut, nullptr, q0, nq, M * K);
      __syncthreads();
      staged = items.t;
    }
    // pool column col = (group g, bin b); its rows ascend by `bins`
    const int col = items.c * RGB + rg;
    if (col >= W) continue;
    const int g = col / bins;
    const long long row0 = (long long)g * fold * tile + (col - g * bins);
    float b0 = -CUDART_INF_F, b1 = -CUDART_INF_F;
    int r0 = -1, r1 = -1;
    for (int s = 0; s < slices; ++s) {
      const long long r = row0 + (long long)s * bins;
      if (r >= N) break;  // later slices lie further past N
      if (!valid[r]) continue;
      float a0, a1;
      line_sums<false, QL, FULL>(mine, codes + r * M, M, KLB, a0, a1);
      if (-a0 > b0) {
        b0 = -a0;
        r0 = (int)r;
      }
      if (-a1 > b1) {
        b1 = -a1;
        r1 = (int)r;
      }
    }
    if (qa < nq) {
      out_s[(long long)(q0 + qa) * W + col] = b0;
      out_i[(long long)(q0 + qa) * W + col] = r0;
    }
    if (L::WB == 4 && qa + 1 < nq) {
      out_s[(long long)(q0 + qa + 1) * W + col] = b1;
      out_i[(long long)(q0 + qa + 1) * W + col] = r1;
    }
  }
}

template <int QL, bool FULL>
__global__ void __launch_bounds__(LTHREADS) adc_scan_precise_lines_kernel(
    const unsigned short* __restrict__ hi,  // [Q, M, K] bf16
    const unsigned short* __restrict__ lo,  // [Q, M, K] bf16
    const uint8_t* __restrict__ codes,      // [N, M]
    const uint8_t* __restrict__ valid,      // [N] 0 / 1
    float* __restrict__ out,                // [Q, N]
    int Q, int N, int M, int K) {
  using L = Lines<true, QL>;
  constexpr int STRIDE = 32 + L::RGW;  // the output tile's row stride, floats
  extern __shared__ __align__(16) unsigned char lines[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int j = lane % L::G, g = lane / L::G;
  const int MK = M * K, KLB = K * L::LB;
  const unsigned char* mine = lines + j * L::WB;
  float* tile_out = reinterpret_cast<float*>(lines + (size_t)MK * L::LB) +
                    warp * QL * STRIDE;
  int staged = -1;
  for (Items items(Q, QL, (N + SCAN_ROWS - 1) / SCAN_ROWS); items.more(); items.next()) {
    const int q0 = items.t * QL, nq = min(QL, Q - q0);
    if (items.t != staged) {
      if (staged >= 0) __syncthreads();  // every warp is done with the old lines
      stage_lines<true, QL>(lines, hi, lo, q0, nq, MK);
      __syncthreads();
      staged = items.t;
    }
    const int base = items.c * SCAN_ROWS + warp * 32;  // the warp's 32 rows
    if (base >= N) continue;
    // G steps of RGW rows: row group g takes row base + s*RGW + g
#pragma unroll 1
    for (int s = 0; s < L::G; ++s) {
      const int rr = s * L::RGW + g;
      const int r = base + rr;
      float v = CUDART_INF_F;
      if (r < N && valid[r]) {
        float h, l;
        line_sums<true, QL, FULL>(mine, codes + (long long)r * M, M, KLB, h, l);
        v = h + l;
      }
      if (L::G == 1) {  // lane = row: the store is coalesced as it is
        if (r < N) out[(long long)q0 * N + r] = v;
      } else {
        tile_out[j * STRIDE + rr] = v;
      }
    }
    if (L::G > 1) {
      __syncwarp();
      const int r = base + lane;
      if (r < N)
        for (int q = 0; q < nq; ++q)
          out[(long long)(q0 + q) * N + r] = tile_out[q * STRIDE + lane];
      __syncwarp();  // the tile is read before the next chunk writes it
    }
  }
}

template <int QL, bool FULL>
int pool_lines(const void* lut, const void* codes, const void* valid,
               float* out_s, int* out_i, int Q, int N, int M, int K, int tile,
               int bins, int fold, int W, int grid, cudaStream_t stream) {
  adc_pool_lines_kernel<QL, FULL><<<grid, LTHREADS, line_smem<false, QL>(M, K), stream>>>(
      (const unsigned short*)lut, (const uint8_t*)codes, (const uint8_t*)valid,
      out_s, out_i, Q, N, M, K, tile, bins, fold, W);
  return (int)cudaGetLastError();
}

template <int QL, bool FULL>
int scan_precise_lines(const void* hi, const void* lo, const void* codes,
                       const void* valid, float* out, int Q, int N, int M,
                       int K, int grid, cudaStream_t stream) {
  adc_scan_precise_lines_kernel<QL, FULL><<<grid, LTHREADS, line_smem<true, QL>(M, K), stream>>>(
      (const unsigned short*)hi, (const unsigned short*)lo,
      (const uint8_t*)codes, (const uint8_t*)valid, out, Q, N, M, K);
  return (int)cudaGetLastError();
}

// Lets every kernel of one FULL form take `bytes` of dynamic shared memory.
template <bool FULL>
cudaError_t allow_smem(int bytes) {
  const void* kernels[] = {
      (const void*)adc_kernel<SCORES, false, FULL>,
      (const void*)adc_kernel<SCAN, false, FULL>,
      (const void*)adc_pool_lines_kernel<16, FULL>,
      (const void*)adc_pool_lines_kernel<8, FULL>,
      (const void*)adc_pool_lines_kernel<4, FULL>,
      (const void*)adc_pool_lines_kernel<2, FULL>,
      (const void*)adc_pool_lines_kernel<1, FULL>,
      (const void*)adc_scan_precise_lines_kernel<8, FULL>,
      (const void*)adc_scan_precise_lines_kernel<4, FULL>,
      (const void*)adc_scan_precise_lines_kernel<2, FULL>,
      (const void*)adc_scan_precise_lines_kernel<1, FULL>,
  };
  cudaError_t e = cudaSuccess;
  for (const void* k : kernels)
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  return e;
}

}  // namespace

// Lets every kernel instantiation take the current device's opt-in maximum of
// dynamic shared memory (a tile's LUT is 128 KB at M 16, K 256; the default
// limit is 48 KB). The wrappers call it once per device before their first
// launch there, so a launch makes no other CUDA call. Always the maximum, so
// threads launching with other tiles never lower each other's limit. Returns
// the first CUDA error (0 = done).
extern "C" int adc_init() {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess) e = allow_smem<true>(optin);
  if (e == cudaSuccess) e = allow_smem<false>(optin);
  return (int)e;
}

// Each entry launches on the caller's stream and returns cudaGetLastError()
// (0 = launched). Shapes, the line width `ql` and the grid are checked and
// chosen by the Python wrappers (vectorsearch_torch/ops/adc.py).

extern "C" int adc_pool_launch(const void* lut, const void* codes,
                               const void* valid, float* out_s, int* out_i,
                               int Q, int N, int M, int K, int ql, int tile,
                               int bins, int fold, int W, int grid,
                               void* stream) {
  if (Q <= 0 || W <= 0) return (int)cudaSuccess;
  auto s = (cudaStream_t)stream;
  const bool full = full_rows(codes, M);
#define POOL_QL(N_)                                                          \
  case N_:                                                                   \
    return full ? pool_lines<N_, true>(lut, codes, valid, out_s, out_i, Q, N, \
                                       M, K, tile, bins, fold, W, grid, s)   \
                : pool_lines<N_, false>(lut, codes, valid, out_s, out_i, Q,  \
                                        N, M, K, tile, bins, fold, W, grid, s);
  switch (ql) {
    POOL_QL(16)
    POOL_QL(8)
    POOL_QL(4)
    POOL_QL(2)
    POOL_QL(1)
  }
#undef POOL_QL
  return (int)cudaErrorInvalidValue;
}

// The blocks of the LINES kernel that adc_pool_launch (precise 0) or
// adc_scan_precise_launch (precise 1) runs for these arguments that fit on
// one SM at once, registers, threads and shared memory all counted, into
// *blocks. Returns the CUDA error (0 = done).
extern "C" int adc_lines_blocks_per_sm(int precise, const void* codes, int M,
                                       int K, int ql, int* blocks) {
  const bool full = full_rows(codes, M);
  const void* k = nullptr;
  size_t smem = 0;
#define FORM(P_, KERNEL_, N_)                                             \
  case N_:                                                                \
    k = full ? (const void*)KERNEL_<N_, true> : (const void*)KERNEL_<N_, false>; \
    smem = line_smem<P_, N_>(M, K);                                       \
    break;
  if (precise) {
    switch (ql) {
      FORM(true, adc_scan_precise_lines_kernel, 8)
      FORM(true, adc_scan_precise_lines_kernel, 4)
      FORM(true, adc_scan_precise_lines_kernel, 2)
      FORM(true, adc_scan_precise_lines_kernel, 1)
    }
  } else {
    switch (ql) {
      FORM(false, adc_pool_lines_kernel, 16)
      FORM(false, adc_pool_lines_kernel, 8)
      FORM(false, adc_pool_lines_kernel, 4)
      FORM(false, adc_pool_lines_kernel, 2)
      FORM(false, adc_pool_lines_kernel, 1)
    }
  }
#undef FORM
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, k, LTHREADS, smem);
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
                                       int ql, int grid, void* stream) {
  if (Q <= 0 || N <= 0) return (int)cudaSuccess;
  auto s = (cudaStream_t)stream;
  const bool full = full_rows(codes, M);
#define SCAN_QL(N_)                                                          \
  case N_:                                                                   \
    return full ? scan_precise_lines<N_, true>(hi, lo, codes, valid, out, Q, \
                                               N, M, K, grid, s)             \
                : scan_precise_lines<N_, false>(hi, lo, codes, valid, out, Q, \
                                                N, M, K, grid, s);
  switch (ql) {
    SCAN_QL(8)
    SCAN_QL(4)
    SCAN_QL(2)
    SCAN_QL(1)
  }
#undef SCAN_QL
  return (int)cudaErrorInvalidValue;
}
