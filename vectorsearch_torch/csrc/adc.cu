// ADC kernels over PQ codes: the Hopper counterparts of the four Pallas
// kernels of vectorsearch_tpu/ops/pallas/adc.py, in one design (LINES).
//
//   adc_pool_launch          <- _adc_pool_kernel   (adc.py:274, via adc_bin_pool)        form POOL
//   adc_scan_precise_launch  <- _adc_kernel        (adc.py:51, via adc_scan_pallas(precise=True))  form PRECISE
//   adc_scan_launch          <- _adc_kernel_fast   (adc.py:68, via adc_scan_pallas)     form FAST
//   adc_scores_launch        <- _adc_kernel_scores (adc.py:79, via adc_scan_scores_pallas)  form SCORES
//
// Function (what the TPU kernels compute, not how: they expand the codes into
// a one-hot matrix for the TPU's matrix unit): for query q and row r
//     a[q, r] = sum over m, in m order, in f32, of lut[q, m, codes[r, m]]
// with the LUT in bf16, the TPU kernels' LUT precision (the precise scan sums
// a hi and a lo bf16 plane separately and adds the two sums). Then:
//   pool    per (group g, bin b): the max of -a[q, r] over the valid rows
//           r / (fold*tile) == g, r % bins == b, and the smallest such row
//           (-inf / -1 when the bin has no valid row);
//   scores  bf16(-a[q, r]) rounded to nearest even, -inf at invalid rows and
//           at the pad columns N <= r < W = scores_width(N);
//   scan    a[q, r] (hi + lo for precise), +inf at invalid rows.
// The plain PyTorch versions (vectorsearch_torch/ops/adc.py) repeat the same
// additions in the same order, so the two agree bit for bit.
//
// What bounds it on an H100: the card's bound for this work is bytes (codes,
// LUT and outputs: at the sift1m segment shape Q 512, N 100,096, M 16, K 256
// the pool moves ~57 MB, 0.017 ms at 3.35 TB/s, the f32 scan ~210 MB, 0.063
// ms). What bounds these kernels is the Q*N*M data-dependent table lookups in
// shared memory (8.2e8 per segment; a Hopper SM serves 32 four-byte bank
// reads a cycle) and the instructions around each one.
//
// The LUT of a tile of QL queries is staged query-major, one line per (m,
// code), so the lanes that share a row read one line together:
//   line li = m*K + c at byte li*LB; lane j of a row group reads the WB
//   bytes at li*LB + j*WB of the line of its row's code c = codes[r, m].
//   POOL, FAST, SCORES: QL queries a line (16, 8, 4, 2 or 1), G = QL/2 lanes
//             a row group, word j = bf16 of query 2j (low half) | query 2j+1
//             (high half), WB 4, LB 2*QL; at QL 1 the line is the one
//             query's bf16 (G 1, WB 2, LB 2).
//   PRECISE:  QL queries a line (8, 4, 2 or 1), G = QL lanes, word j = hi
//             bf16 of query j (low half) | lo bf16 (high half), WB 4, LB 4*QL.
// A warp holds RGW = 32/G row groups, each on its own row. A lane unpacks a
// word with a shift and a mask (exact) and adds into two f32 sums in m order
// (line_sums): two queries' sums (one at QL 1), or PRECISE's hi and lo sum.
// At QL 16 one load instruction serves 4 rows x 16 queries = 64 lookups, its
// 4 lines in random bank quarters (~2.1 wavefronts). The wrapper picks the
// widest line that fits a block's shared memory (227 KB, the output tiles
// included) and is no wider than the batch needs; it raises when one query's
// line does not fit. Blocks of 1024 threads (32 warps on one stage) run as
// one persistent wave (as many blocks as the SMs hold at once,
// adc_lines_blocks_per_sm): block i takes the i-th share of the (query tile,
// chunk) items in order, so it stages few LUTs, each transposed into lines
// inside the kernel (16-byte loads, byte permutes, stores rotated over the
// bank quarters).
//
// POOL: a chunk is 1024/G pool columns, one a row group, walked slice by
// slice in ascending row order with a strict `>` (ties keep the smallest
// row), the best score and row of each of the lane's queries in registers.
//
// FAST, SCORES, PRECISE (the line-scan kernel): a chunk is `chunk` output
// columns (a multiple of 32, chosen by the wrapper: 1024, or a tile's
// columns split evenly over the blocks one tile gets, so that a block stages
// one LUT where the items allow it); SCORES' chunks cover the pad columns
// too. Each warp takes 32-column slices of the chunk, 32 warps apart, in G
// steps of RGW rows, and stores each value into its own [QL x STRIDE] tile
// in shared memory (f32; bf16 for SCORES, rounded there), then writes each
// query's 32 columns as one line of 128 (SCORES 64) bytes. At G 1 a lane is
// a row and stores its values to device memory directly (coalesced as they
// are). STRIDE: a store instruction puts the value of query qa = 2j (FAST,
// SCORES) or j (PRECISE) of each lane at element qa*STRIDE + s*RGW + g, g =
// lane / G < RGW. With STRIDE = 32 + RGW/2 (FAST, SCORES; two queries a
// lane) or 32 + RGW (PRECISE) the lanes' offsets are j*RGW + g modulo 32
// elements: 32 banks for f32, and for bf16 16 words (two lanes a word, g
// even and odd) in 16 banks, so no store conflicts; the reads of a query's
// 32 columns are consecutive.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

namespace {

constexpr int MG = 16;  // codes held in registers per step: one 16-byte load
constexpr int LTHREADS = 1024;
constexpr int LWARPS = LTHREADS / 32;

// The kernel forms; ops/adc.py names the same numbers.
enum Form { POOL = 0, PRECISE = 1, FAST = 2, SCORES = 3 };

template <int F>
using FormT = std::integral_constant<int, F>;

__device__ __forceinline__ float bf16_to_f32(unsigned short h) {
  return __uint_as_float(((unsigned int)h) << 16);
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

// 16-byte code loads need M a multiple of 16 and an aligned table.
bool full_rows(const void* codes, int M) {
  return M % 16 == 0 && (reinterpret_cast<uintptr_t>(codes) & 15) == 0;
}

// The line layout of the header: G lanes a row group, WB bytes a lane reads,
// LB bytes a line, RGW row groups a warp.
template <int FORM, int QL>
struct Lines {
  static constexpr bool HILO = FORM == PRECISE;
  static constexpr int G = HILO ? QL : (QL >= 2 ? QL / 2 : 1);
  static constexpr int WB = (HILO || QL >= 2) ? 4 : 2;
  static constexpr int LB = G * WB;
  static constexpr int RGW = 32 / G;
};

// The output tile of a scan form (header): [QL x STRIDE] values of type T a
// warp, none at G 1.
template <int FORM, int QL>
struct ScanTile {
  using T = typename std::conditional<FORM == SCORES, __nv_bfloat16, float>::type;
  static constexpr int RGW = Lines<FORM, QL>::RGW;
  static constexpr bool USED = FORM != POOL && Lines<FORM, QL>::G > 1;
  static constexpr int STRIDE = 32 + (FORM == PRECISE ? RGW : RGW / 2);
};

// Bytes of a block's shared memory: the lines, then the warps' output tiles.
// ops/adc.py::_line_smem mirrors it.
template <int FORM, int QL>
size_t line_smem(int M, int K) {
  using S = ScanTile<FORM, QL>;
  size_t b = (size_t)M * K * Lines<FORM, QL>::LB;
  if (S::USED) b += (size_t)LWARPS * QL * S::STRIDE * sizeof(typename S::T);
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
// queries past nq hold 0. p0 the bf16 LUT [Q, M, K] (PRECISE: its hi plane),
// p1 PRECISE's lo plane. Word j of line mk takes its low half from row A and
// its high half from row B at column mk: A = query 2j, B = query 2j + 1;
// PRECISE A = hi of query j, B = lo of query j.
template <int FORM, int QL>
__device__ __forceinline__ void stage_lines(unsigned char* lines,
                                            const unsigned short* __restrict__ p0,
                                            const unsigned short* __restrict__ p1,
                                            int q0, int nq, int MK) {
  using L = Lines<FORM, QL>;
  constexpr int G = L::G;
  const unsigned short* pb = L::HILO ? p1 : p0;
  uint32_t* w32 = reinterpret_cast<uint32_t*>(lines);
  const bool vec = (MK & 7) == 0 && (reinterpret_cast<uintptr_t>(p0) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(pb) & 15) == 0;
  if (L::WB == 2) {  // QL 1 (not PRECISE): the one query's LUT as it is
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
      const int qa = L::HILO ? j : 2 * j, qb = L::HILO ? j : 2 * j + 1;
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
      const int qa = L::HILO ? j : 2 * j, qb = L::HILO ? j : 2 * j + 1;
      const uint32_t lo = qa < nq ? p0[(long long)(q0 + qa) * MK + mk] : 0u;
      const uint32_t hi = qb < nq ? pb[(long long)(q0 + qb) * MK + mk] : 0u;
      w32[t] = lo | (hi << 16);
    }
  }
}

// Adds the low / high half of the lane's word at `a` into a0 / a1 (QL 1, not
// PRECISE: its 2-byte line into a0).
template <int FORM, int QL>
__device__ __forceinline__ void add_word(const unsigned char* a, float& a0,
                                         float& a1) {
  if (Lines<FORM, QL>::WB == 2) {
    a0 += bf16_to_f32(*reinterpret_cast<const unsigned short*>(a));
  } else {
    const uint32_t v = *reinterpret_cast<const uint32_t*>(a);
    a0 += __uint_as_float(v << 16);
    a1 += __uint_as_float(v & 0xFFFF0000u);
  }
}

// a0 / a1 = sum over m, in m order, in f32, of the low / high half of the
// lane's word in line (m, row[m]); `lane_lines` is the lines plus the lane's
// j*WB, KLB = K*LB. The sums of queries 2j and 2j + 1 (QL 1: a0 only);
// PRECISE: the hi and the lo sum. FULL rows read 16 codes a load; the others
// one code a load (any M, any alignment).
template <int FORM, int QL, bool FULL>
__device__ __forceinline__ void line_sums(const unsigned char* lane_lines,
                                          const uint8_t* __restrict__ row,
                                          int M, int KLB, float& a0, float& a1) {
  constexpr int LB = Lines<FORM, QL>::LB;
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
        add_word<FORM, QL>(p + i * KLB + code * LB, a0, a1);
      }
    }
  } else {
    for (int m = 0; m < M; ++m)
      add_word<FORM, QL>(lane_lines + m * KLB + __ldg(row + m) * LB, a0, a1);
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
  using L = Lines<POOL, QL>;
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
      stage_lines<POOL, QL>(lines, lut, nullptr, q0, nq, M * K);
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
      line_sums<POOL, QL, FULL>(mine, codes + r * M, M, KLB, a0, a1);
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

template <typename T>
__device__ __forceinline__ T to_out(float v);
template <>
__device__ __forceinline__ float to_out<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 to_out<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// The line-scan kernel: FAST, SCORES or PRECISE (header). At 16- and 8-query
// lines its stage leaves room for one block a SM, and its launch bounds say
// so: with the thread count alone ptxas built the PRECISE forms at 32
// registers with spills (room for two blocks a SM), where one may take 64.
template <int FORM, int QL, bool FULL>
__global__ void __launch_bounds__(LTHREADS, 1) adc_scan_lines_kernel(
    const unsigned short* __restrict__ p0,  // [Q, M, K] bf16 LUT (PRECISE: hi plane)
    const unsigned short* __restrict__ p1,  // [Q, M, K] bf16 lo plane (PRECISE)
    const uint8_t* __restrict__ codes,      // [N, M]
    const uint8_t* __restrict__ valid,      // [N] 0 / 1
    void* __restrict__ out_,                // [Q, W]: f32 (W = N), SCORES bf16
    int Q, int N, int W, int M, int K, int chunk) {
  using L = Lines<FORM, QL>;
  using S = ScanTile<FORM, QL>;
  using T = typename S::T;
  // queries a lane sums: 2j and 2j + 1 (one at QL 1); PRECISE j
  constexpr int QA = (FORM != PRECISE && L::WB == 4) ? 2 : 1;
  const float dead = FORM == SCORES ? -CUDART_INF_F : CUDART_INF_F;
  extern __shared__ __align__(16) unsigned char lines[];
  T* __restrict__ out = static_cast<T*>(out_);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int j = lane % L::G, g = lane / L::G;
  const int qa = QA * j;  // the lane's first query in the tile
  const int MK = M * K, KLB = K * L::LB;
  const unsigned char* mine = lines + j * L::WB;
  T* tile = reinterpret_cast<T*>(lines + (size_t)MK * L::LB) + warp * QL * S::STRIDE;
  int staged = -1;
  for (Items items(Q, QL, (W + chunk - 1) / chunk); items.more(); items.next()) {
    const int q0 = items.t * QL, nq = min(QL, Q - q0);
    if (items.t != staged) {
      if (staged >= 0) __syncthreads();  // every warp is done with the old lines
      stage_lines<FORM, QL>(lines, p0, p1, q0, nq, MK);
      __syncthreads();
      staged = items.t;
    }
    const long long c0 = (long long)items.c * chunk;
    const int end = (int)min(c0 + chunk, (long long)W);
    // the warp's 32-column slices of the chunk, 32 warps apart
    for (int base = (int)c0 + warp * 32; base < end; base += LTHREADS) {
      // G steps of RGW rows: row group g takes row base + s*RGW + g
#pragma unroll 1
      for (int s = 0; s < L::G; ++s) {
        const int rr = s * L::RGW + g;
        const int r = base + rr;
        float v0 = dead, v1 = dead;
        if (r < N && valid[r]) {
          float a0, a1;
          line_sums<FORM, QL, FULL>(mine, codes + (long long)r * M, M, KLB, a0, a1);
          if (FORM == PRECISE) {
            v0 = a0 + a1;
          } else if (FORM == SCORES) {
            v0 = -a0;
            v1 = -a1;
          } else {
            v0 = a0;
            v1 = a1;
          }
        }
        if (!S::USED) {  // G 1: lane = row, the stores are coalesced as they are
          if (r < W) {
            out[(long long)q0 * W + r] = to_out<T>(v0);
            if (QA == 2 && nq > 1) out[(long long)(q0 + 1) * W + r] = to_out<T>(v1);
          }
        } else {
          tile[qa * S::STRIDE + rr] = to_out<T>(v0);
          if (QA == 2) tile[(qa + 1) * S::STRIDE + rr] = to_out<T>(v1);
        }
      }
      if (S::USED) {
        __syncwarp();
        const int r = base + lane;
        if (r < W)
          for (int q = 0; q < nq; ++q)
            out[(long long)(q0 + q) * W + r] = tile[q * S::STRIDE + lane];
        __syncwarp();  // the tile is read before the next slice writes it
      }
    }
  }
}

// A form's kernel at line width QL.
template <int FORM, int QL, bool FULL>
const void* kernel_of() {
  if constexpr (FORM == POOL)
    return (const void*)adc_pool_lines_kernel<QL, FULL>;
  else
    return (const void*)adc_scan_lines_kernel<FORM, QL, FULL>;
}

// Calls fn(FormT<QL>) for a line width given at run time; false for a width
// that FORM has no kernel of (PRECISE lines hold at most 8 queries).
template <int FORM, typename Fn>
bool with_width(int ql, Fn&& fn) {
  switch (ql) {
    case 16:
      if constexpr (FORM != PRECISE) {
        fn(FormT<16>{});
        return true;
      }
      return false;
    case 8: fn(FormT<8>{}); return true;
    case 4: fn(FormT<4>{}); return true;
    case 2: fn(FormT<2>{}); return true;
    case 1: fn(FormT<1>{}); return true;
  }
  return false;
}

// Calls fn(FormT<FORM>, FormT<QL>) for a form and line width given at run
// time; false for a pair that has no kernel.
template <typename Fn>
bool with_form(int form, int ql, Fn&& fn) {
  auto at = [&](auto f) {
    return with_width<decltype(f)::value>(ql, [&](auto q) { fn(f, q); });
  };
  switch (form) {
    case POOL: return at(FormT<POOL>{});
    case PRECISE: return at(FormT<PRECISE>{});
    case FAST: return at(FormT<FAST>{});
    case SCORES: return at(FormT<SCORES>{});
  }
  return false;
}

// Launches a scan form (FAST, SCORES, PRECISE) on `stream`.
template <int FORM>
int scan_launch(const void* p0, const void* p1, const void* codes,
                const void* valid, void* out, int Q, int N, int W, int M,
                int K, int ql, int chunk, int grid, void* stream) {
  if (Q <= 0 || W <= 0) return (int)cudaSuccess;
  if (chunk <= 0 || chunk % 32) return (int)cudaErrorInvalidValue;
  const bool full = full_rows(codes, M);
  const bool known = with_width<FORM>(ql, [&](auto q) {
    constexpr int QL = decltype(q)::value;
    auto k = full ? adc_scan_lines_kernel<FORM, QL, true>
                  : adc_scan_lines_kernel<FORM, QL, false>;
    k<<<grid, LTHREADS, line_smem<FORM, QL>(M, K), (cudaStream_t)stream>>>(
        (const unsigned short*)p0, (const unsigned short*)p1,
        (const uint8_t*)codes, (const uint8_t*)valid, out, Q, N, W, M, K, chunk);
  });
  if (!known) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// Lets every kernel of one FULL form take `bytes` of dynamic shared memory.
template <bool FULL>
cudaError_t allow_smem(int bytes) {
  cudaError_t e = cudaSuccess;
  for (int form : {POOL, PRECISE, FAST, SCORES})
    for (int ql : {16, 8, 4, 2, 1})
      with_form(form, ql, [&](auto f, auto q) {
        if (e == cudaSuccess)
          e = cudaFuncSetAttribute(
              kernel_of<decltype(f)::value, decltype(q)::value, FULL>(),
              cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
      });
  return e;
}

}  // namespace

// Lets every kernel instantiation take the current device's opt-in maximum of
// dynamic shared memory (a tile's LUT lines are 128 KB at M 16, K 256; the
// default limit is 48 KB). The wrappers call it once per device before their
// first launch there, so a launch makes no other CUDA call. Always the
// maximum, so threads launching with other tiles never lower each other's
// limit. Returns the first CUDA error (0 = done).
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
// (0 = launched). Shapes, the line width `ql`, the chunk and the grid are
// checked and chosen by the Python wrappers (vectorsearch_torch/ops/adc.py).

extern "C" int adc_pool_launch(const void* lut, const void* codes,
                               const void* valid, float* out_s, int* out_i,
                               int Q, int N, int M, int K, int ql, int tile,
                               int bins, int fold, int W, int grid,
                               void* stream) {
  if (Q <= 0 || W <= 0) return (int)cudaSuccess;
  const bool full = full_rows(codes, M);
  const bool known = with_width<POOL>(ql, [&](auto q) {
    constexpr int QL = decltype(q)::value;
    auto k = full ? adc_pool_lines_kernel<QL, true> : adc_pool_lines_kernel<QL, false>;
    k<<<grid, LTHREADS, line_smem<POOL, QL>(M, K), (cudaStream_t)stream>>>(
        (const unsigned short*)lut, (const uint8_t*)codes, (const uint8_t*)valid,
        out_s, out_i, Q, N, M, K, tile, bins, fold, W);
  });
  if (!known) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// The blocks of `form`'s kernel at line width `ql` for these arguments that
// fit on one SM at once, registers, threads and shared memory all counted,
// into *blocks. Returns the CUDA error (0 = done).
extern "C" int adc_lines_blocks_per_sm(int form, const void* codes, int M,
                                       int K, int ql, int* blocks) {
  const bool full = full_rows(codes, M);
  const void* k = nullptr;
  size_t smem = 0;
  with_form(form, ql, [&](auto f, auto q) {
    constexpr int F = decltype(f)::value, QL = decltype(q)::value;
    k = full ? kernel_of<F, QL, true>() : kernel_of<F, QL, false>();
    smem = line_smem<F, QL>(M, K);
  });
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, k, LTHREADS, smem);
}

extern "C" int adc_scan_precise_launch(const void* hi, const void* lo,
                                       const void* codes, const void* valid,
                                       float* out, int Q, int N, int M, int K,
                                       int ql, int chunk, int grid,
                                       void* stream) {
  return scan_launch<PRECISE>(hi, lo, codes, valid, out, Q, N, N, M, K, ql,
                              chunk, grid, stream);
}

extern "C" int adc_scan_launch(const void* lut, const void* codes,
                               const void* valid, float* out, int Q, int N,
                               int M, int K, int ql, int chunk, int grid,
                               void* stream) {
  return scan_launch<FAST>(lut, lut, codes, valid, out, Q, N, N, M, K, ql,
                           chunk, grid, stream);
}

// W = scores_width(N): the columns past N are pad columns (-inf).
extern "C" int adc_scores_launch(const void* lut, const void* codes,
                                 const void* valid, void* out, int Q, int N,
                                 int M, int K, int W, int ql, int chunk,
                                 int grid, void* stream) {
  return scan_launch<SCORES>(lut, lut, codes, valid, out, Q, N, W, M, K, ql,
                             chunk, grid, stream);
}
