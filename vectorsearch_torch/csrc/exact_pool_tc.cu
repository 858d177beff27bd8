// Exact binned pool B1 on Hopper's tensor cores: the counterpart of the TPU
// kernel vectorsearch_tpu/ops/pallas/exact.py::_pool_kernel (reached through
// exact_bin_pool), launched through exact_pool_launch below.
//
// Function (the TPU kernel's, so the two pools compare directly): for each
// query q and each pool column (group g, bin b), the max over the rows r < N
// with r / (fold*tile) == g and r % bins == b of the rank score
//     L2:     s = (2q).x - aux0[r]           (aux0 = ||x||^2, +inf if invalid;
//                                              the wrapper pre-doubles q)
//     COSINE: s = (q.x) * aux0[r] + aux1[r]  (aux0 = 1/||x|| or 0 for a zero
//                                              row, aux1 = 0 or -inf if invalid)
// and the smallest r that attains it. A bin with no valid row scores -inf
// (its id is -1 here; callers mask it). Rows past N are never read. The max
// compares with `>`, so a NaN score never wins (as in the TPU kernel).
//
// What bounds it on an H100: a [Q, N] x [N, D] product folded into a per-bin
// reduction, so the [Q, N] score matrix never reaches device memory. At the
// sift1m 8-segment group (Q 512, N 800,768, D 128) that is 105 GFLOP against
// 410 MB of x: operations bound it (the bytes take ~0.13 ms at 3.35 TB/s).
// The scores become true distances with no re-rank behind them
// (exact_finalize), so the product must keep FP32's precision.
//
// Precision: 3xTF32. Each operand v splits into big = tf32_rna(v) and
// small = tf32_rna(v - big) (v - big is exact in f32), and the tensor cores
// accumulate small_q.big_x + big_q.small_x + big_q.big_x in f32: a relative
// error of ~2^-21, FP32's class, so the plain version (full f32) and the
// card check's tolerance stay as they were. The tensor cores only ever see
// values whose low 13 bits are zero. The TPU kernel's split-bf16 form would
// run twice the tensor rate on paper, but errs by up to ~1.1e-5 x 2|q||x|,
// the edge of that tolerance. Three TF32 passes at 495 TFLOP/s put this
// kernel's ceiling at ~0.64 ms for the shape above.
//
// Design, against the three limits of the FP32 kernel it replaces:
// - FP32 FMA on the CUDA cores (67 TFLOP/s peak): the product runs on the
//   tensor cores, as warpgroup MMA (wgmma m64nNk8 TF32) with x in registers
//   as the A operand and the query tile in shared memory as B.
// - Synchronous staging with bank conflicts: x arrives by cp.async (16-byte
//   copies, zero-filled past N and past D; 4-byte copies when rows are not
//   16-byte aligned) into rings of STAGES stages of 32 features, whose
//   padded row stride (36 floats) makes every fragment load conflict-free.
//   Each warpgroup has a ring of its own 64 rows and its own named barrier,
//   one wait per stage with the next stages' copies in flight, so the two
//   warpgroups drift apart and one's epilogue and fragment splits overlap
//   the other's MMAs (faster on the card than one ring of 128 rows under
//   block barriers).
// - The query tile staged again per row slice: it is split into big and
//   small once, at block start, into two shared-memory planes in wgmma's
//   K-major layout (no swizzle: 8x4 core matrices of 128 contiguous bytes),
//   where it stays for all of the block's slices.
// The grid is (query tile of NQ <= 128, 128 pool columns of one group). A
// block's two warpgroups take rows 0-63 and 64-127 of each 128-row slice
// (slice sl of the block is rows group_row0 + sl*bins + b0 .. +127, so
// accumulator row i of every slice belongs to bin b0 + i). The running
// (max, slice) of each (row, query) pair lives in registers in the
// accumulator's own fragment layout, so a slice's epilogue is elementwise:
// take off the column term, keep score and slice on `>`. Slices ascend, so
// the smallest row wins a tie. Slice indices are 16 bits, two per register.
// blockIdx.x is the query tile, so the query tiles of one column block run
// side by side and x is read from device memory about once. Features are
// taken in whole stages of 32 (zero past D). NQ is the power of two up to
// 128 that Q needs. Its resident planes take 2 * NQ * ceil32(D) * 4 bytes
// beside the 72 KB of rings: D up to 128 at NQ 128, 288 at NQ 64, 576 at NQ
// 32. NQ halves (not below 32, or what Q needs) until they fit. Wider rows
// take the streamed form (SQ): each ring stage also brings the query tile's
// 32 features of that step, which the warpgroup splits into planes of its
// own before its MMAs (one more named barrier per step), at NQ up to 64.
// Any D runs; the main path's D is 128 (resident, NQ 128).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 128;     // pool columns (bins) per block = rows per slice
constexpr int KC = 32;        // features per ring stage
constexpr int XS = KC + 4;    // a stage's row stride in floats
constexpr int STAGES = 4;     // ring depth
constexpr int THREADS = 256;  // two warpgroups of 64 rows
constexpr int WG_THREADS = 128;
constexpr int WG_ROWS = 64;
constexpr int NO_SLICE = 0xFFFF;
constexpr size_t SMEM_MAX = 232448;  // a block's opt-in maximum on sm_90

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Round to the nearest TF32 (10 mantissa bits), ties away from zero; the
// low 13 bits of the result are zero.
__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ void split_tf32(float v, uint32_t& big,
                                           uint32_t& small) {
  big = to_tf32(v);
  small = to_tf32(v - __uint_as_float(big));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const float* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(ok ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(ok ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(PENDING) : "memory");
}

// Keeps a register's value where it is across the asynchronous MMA (the
// compiler may neither read it early nor reuse it before the wait).
__device__ __forceinline__ void reg_fence(float& r) {
  asm volatile("" : "+f"(r) :: "memory");
}
__device__ __forceinline__ void reg_fence(uint32_t& r) {
  asm volatile("" : "+r"(r) :: "memory");
}

// Shared-memory matrix descriptor: no swizzle; lbo = bytes between core
// matrices adjacent along K, sbo = bytes between query octets.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32);
}

// D[64 x N] (+)= A[64 x 8] . B[8 x N]: A (x rows) from registers in the
// m16n8k8 TF32 fragment layout per warp, B (queries) from shared memory,
// both K-major; scale_d 0 overwrites D.
template <int N>
struct Wgmma;

template <> struct Wgmma<8> {
  __device__ __forceinline__ static void run(float* d, const uint32_t* a,
                                             uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3"
        "}, {%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

template <> struct Wgmma<16> {
  __device__ __forceinline__ static void run(float* d, const uint32_t* a,
                                             uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

template <> struct Wgmma<32> {
  __device__ __forceinline__ static void run(float* d, const uint32_t* a,
                                             uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

template <> struct Wgmma<64> {
  __device__ __forceinline__ static void run(float* d, const uint32_t* a,
                                             uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

template <> struct Wgmma<128> {
  __device__ __forceinline__ static void run(float* d, const uint32_t* a,
                                             uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39,"
        "%40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55,"
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

// The query planes are K-major in wgmma's no-swizzle layout: core matrices
// of 8 queries x 4 features in 128 contiguous bytes, adjacent along K 128
// bytes apart (LBO), query octets (features per plane) * 32 bytes apart
// (SBO). Element o of a plane of kp features is query n, feature k:
__device__ __forceinline__ void plane_pos(int o, int kp, int& n, int& k) {
  n = (o / (kp * 8)) * 8 + ((o & 31) >> 2);
  k = ((o >> 5) % (kp >> 2)) * 4 + (o & 3);
}

// Shared memory: resident (SQ false): the two planes [NQ x kq], then each
// warpgroup's ring of STAGES x [64 x XS]. Streamed: each warpgroup's two
// planes [NQ x KC], then its ring of STAGES x ([64 x XS] of x, [NQ x XS] of
// the query tile's raw features).
template <int NQ, bool SQ>
__global__ void __launch_bounds__(THREADS, 1) exact_pool_tc_kernel(
    const float* __restrict__ q,     // [Q, D]
    const float* __restrict__ x,     // [N, D]
    const float* __restrict__ aux0,  // [N]
    const float* __restrict__ aux1,  // [N] (COSINE only)
    float* __restrict__ out_s,       // [Q, W]
    int* __restrict__ out_i,         // [Q, W]
    int Q, int N, int D, int kq, int tile, int bins, int fold, int W,
    int cosine, int vec) {
  extern __shared__ __align__(128) float smem[];
  constexpr int STAGE = (WG_ROWS + (SQ ? NQ : 0)) * XS;  // floats per stage
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int me = tid & (WG_THREADS - 1);  // index in the warpgroup
  const int row0 = wg * WG_ROWS;          // the warpgroup's first slice row
  const int kp = SQ ? KC : kq;            // features per query plane
  float* qb = smem + (SQ ? wg * 2 * NQ * KC : 0);  // big halves of the queries
  float* qs = qb + NQ * kp;                        // their small halves
  float* ring = smem + (SQ ? 4 * NQ * KC : 2 * NQ * kq) + wg * STAGES * STAGE;
  const int g = (tid & 31) >> 2, t = tid & 3;
  const int lr0 = (tid >> 5) * 16 + g;  // this thread's rows: lr0, lr0 + 8
  const int q0 = blockIdx.x * NQ;
  const int col_blocks = bins / ROWS;
  const int grp = blockIdx.y / col_blocks;
  const int b0 = (blockIdx.y % col_blocks) * ROWS;
  const long long first = (long long)grp * fold * tile + b0;
  const int slices = fold * (tile / bins);
  // slices holding rows < N (later ones lie further past N)
  const int nsl = first >= N ? 0
      : (int)(((N - first + bins - 1) / bins) < slices
                  ? (N - first + bins - 1) / bins : slices);
  const int nch = kq / KC;  // ring stages per slice
  const int steps = nsl * nch;

  // step s = (slice s / nch, feature chunk s % nch) -> its ring stage
  auto load_stage = [&](int s) {
    const int sl = s / nch;
    const long long base = first + (long long)sl * bins + row0;
    const int k0 = (s - sl * nch) * KC;
    float* st = ring + (s % STAGES) * STAGE;
    if (vec) {
      for (int e = me; e < WG_ROWS * KC / 4; e += WG_THREADS) {
        const int row = e >> 3, kk = (e & 7) * 4;
        const long long r = base + row;
        const bool ok = r < N && k0 + kk < D;
        cp_async16(smem_addr(st + row * XS + kk), ok ? x + r * D + k0 + kk : x, ok);
      }
    } else {
      for (int e = me; e < WG_ROWS * KC; e += WG_THREADS) {
        const int row = e >> 5, kk = e & 31;
        const long long r = base + row;
        const bool ok = r < N && k0 + kk < D;
        cp_async4(smem_addr(st + row * XS + kk), ok ? x + r * D + k0 + kk : x, ok);
      }
    }
    if (SQ) {  // the query tile's features k0 .. k0 + 31 (zero past Q and D)
      float* sq = st + WG_ROWS * XS;
      if (vec) {
        for (int e = me; e < NQ * KC / 4; e += WG_THREADS) {
          const int n = e >> 3, kk = (e & 7) * 4, qi = q0 + n;
          const bool ok = qi < Q && k0 + kk < D;
          cp_async16(smem_addr(sq + n * XS + kk),
                     ok ? q + (long long)qi * D + k0 + kk : q, ok);
        }
      } else {
        for (int e = me; e < NQ * KC; e += WG_THREADS) {
          const int n = e >> 5, kk = e & 31, qi = q0 + n;
          const bool ok = qi < Q && k0 + kk < D;
          cp_async4(smem_addr(sq + n * XS + kk),
                    ok ? q + (long long)qi * D + k0 + kk : q, ok);
        }
      }
    }
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) load_stage(s);
    cp_async_commit();
  }

  // resident: the query tile, split once into the two planes (zero past Q
  // and D)
  if (!SQ) {
    for (int o = tid; o < NQ * kq; o += THREADS) {
      int n, k;
      plane_pos(o, kq, n, k);
      const int qi = q0 + n;
      const float v = (qi < Q && k < D) ? q[(long long)qi * D + k] : 0.f;
      uint32_t big, small;
      split_tf32(v, big, small);
      qb[o] = __uint_as_float(big);
      qs[o] = __uint_as_float(small);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
  }

  float acc[NQ / 2], best[NQ / 2];
  uint32_t slot[NQ / 4];  // two 16-bit slice indices per register
#pragma unroll
  for (int i = 0; i < NQ / 2; ++i) {
    acc[i] = 0.f;
    best[i] = -CUDART_INF_F;
  }
#pragma unroll
  for (int i = 0; i < NQ / 4; ++i) slot[i] = 0xFFFFFFFFu;
  float ca0 = 0.f, cb0 = 0.f, ca1 = 0.f, cb1 = 0.f;  // rows lr0, lr0 + 8
  const uint32_t pb = smem_addr(qb), ps = smem_addr(qs);
  const uint32_t sbo = (uint32_t)kp * 32;

  for (int s = 0; s < steps; ++s) {
    cp_async_wait<STAGES - 2>();
    // stage s landed; stage s - 1 is free for reuse
    asm volatile("bar.sync %0, %1;\n" :: "r"(1 + wg), "n"(WG_THREADS) : "memory");
    if (s + STAGES - 1 < steps) load_stage(s + STAGES - 1);
    cp_async_commit();

    const int sl = s / nch, c = s - sl * nch;
    const long long r0 = first + (long long)sl * bins + lr0, r1 = r0 + 8;
    if (c == 0) {  // the slice's column terms, needed at its last chunk
      ca0 = r0 < N ? aux0[r0] : 0.f;
      ca1 = r1 < N ? aux0[r1] : 0.f;
      cb0 = (cosine && r0 < N) ? aux1[r0] : 0.f;
      cb1 = (cosine && r1 < N) ? aux1[r1] : 0.f;
    }

    if (SQ) {
      // streamed: this step's query features into the warpgroup's planes
      // (its MMAs of the last step are complete: each warp waited for them
      // before the barrier above)
      const float* sq = ring + (s % STAGES) * STAGE + WG_ROWS * XS;
      for (int o = me; o < NQ * KC; o += WG_THREADS) {
        int n, k;
        plane_pos(o, KC, n, k);
        uint32_t big, small;
        split_tf32(sq[n * XS + k], big, small);
        qb[o] = __uint_as_float(big);
        qs[o] = __uint_as_float(small);
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync %0, %1;\n" :: "r"(1 + wg), "n"(WG_THREADS) : "memory");
    }

    // A fragments of x (rows lr0, lr0 + 8; features t, t + 4 of each k8)
    const float* st = ring + (s % STAGES) * STAGE + (lr0 - row0) * XS + t;
    uint32_t ab[4][4], as[4][4];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const float* p = st + ks * 8;
      split_tf32(p[0], ab[ks][0], as[ks][0]);
      split_tf32(p[8 * XS], ab[ks][1], as[ks][1]);
      split_tf32(p[4], ab[ks][2], as[ks][2]);
      split_tf32(p[8 * XS + 4], ab[ks][3], as[ks][3]);
    }

#pragma unroll
    for (int i = 0; i < NQ / 2; ++i) reg_fence(acc[i]);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const uint32_t off = (uint32_t)((SQ ? 0 : c * 4) + ks) * 256;
      const uint64_t db = smem_desc(pb + off, 128, sbo);
      const uint64_t ds = smem_desc(ps + off, 128, sbo);
      // a slice's first product overwrites the accumulator
      Wgmma<NQ>::run(acc, as[ks], db, (c | ks) != 0);
      Wgmma<NQ>::run(acc, ab[ks], ds, 1);
      Wgmma<NQ>::run(acc, ab[ks], db, 1);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int i = 0; i < NQ / 2; ++i) reg_fence(acc[i]);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        reg_fence(ab[ks][f]);
        reg_fence(as[ks][f]);
      }

    if (c == nch - 1) {
      // epilogue in the accumulator's layout: acc[4j + 2h + e] is row
      // lr0 + 8h, query q0 + 8j + 2t + e
      const bool ok0 = r0 < N, ok1 = r1 < N;
#pragma unroll
      for (int j = 0; j < NQ / 8; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const bool ok = h ? ok1 : ok0;
          const float ca = h ? ca1 : ca0, cb = h ? cb1 : cb0;
          uint32_t sp = slot[2 * j + h];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * j + 2 * h + e;
            const float sc = cosine ? acc[i] * ca + cb : acc[i] - ca;
            if (ok && sc > best[i]) {
              best[i] = sc;
              sp = e ? (sp & 0xFFFFu) | ((uint32_t)sl << 16)
                     : (sp & 0xFFFF0000u) | (uint32_t)sl;
            }
          }
          slot[2 * j + h] = sp;
        }
      }
    }
  }

  const long long col0 = (long long)grp * bins + b0;
#pragma unroll
  for (int j = 0; j < NQ / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qi = q0 + 8 * j + 2 * t + e;
        if (qi >= Q) continue;
        const int lr = lr0 + 8 * h;
        const long long o = (long long)qi * W + col0 + lr;
        const uint32_t sv = (slot[2 * j + h] >> (16 * e)) & 0xFFFFu;
        out_s[o] = best[4 * j + 2 * h + e];
        out_i[o] = sv == NO_SLICE ? -1 : (int)(first + (long long)sv * bins + lr);
      }
}

size_t smem_bytes(int nq, int kq, bool sq) {
  return sizeof(float) * (sq ? (size_t)(4 * nq * KC + 2 * STAGES * (WG_ROWS + nq) * XS)
                             : (size_t)(2 * nq * kq + STAGES * ROWS * XS));
}

template <int NQ, bool SQ>
int launch(const float* q, const float* x, const float* aux0, const float* aux1,
           float* out_s, int* out_i, int Q, int N, int D, int kq, int tile,
           int bins, int fold, int W, int cosine, int vec, cudaStream_t stream) {
  // each instantiation takes the device's opt-in maximum of shared memory
  // once per device, so later launches make no other CUDA call
  static bool ready[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!ready[dev]) {
    int optin = 0;
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(exact_pool_tc_kernel<NQ, SQ>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (e != cudaSuccess) return (int)e;
    ready[dev] = true;
  }
  dim3 grid((Q + NQ - 1) / NQ, W / ROWS);
  exact_pool_tc_kernel<NQ, SQ><<<grid, THREADS, smem_bytes(NQ, kq, SQ), stream>>>(
      q, x, aux0, aux1, out_s, out_i, Q, N, D, kq, tile, bins, fold, W, cosine, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on the caller's stream; returns cudaGetLastError() (0 =
// launched), or cudaErrorInvalidValue for 65,535 or more row slices per
// group. The other checks are the Python wrapper's
// (vectorsearch_torch/ops/exact.py).
extern "C" int exact_pool_launch(const float* q, const float* x,
                                 const float* aux0, const float* aux1,
                                 float* out_s, int* out_i, int Q, int N, int D,
                                 int tile, int bins, int fold, int W, int cosine,
                                 void* stream) {
  if (Q <= 0 || W <= 0) return (int)cudaSuccess;
  const int kq = (D + KC - 1) / KC * KC;
  if ((long long)fold * (tile / bins) >= NO_SLICE) return (int)cudaErrorInvalidValue;
  int want = 8;
  while (want < 128 && want < Q) want *= 2;
  int nq = want;
  const int least = want < 32 ? want : 32;
  while (nq > least && smem_bytes(nq, kq, false) > SMEM_MAX) nq /= 2;
  const bool sq = smem_bytes(nq, kq, false) > SMEM_MAX;
  if (sq) nq = want < 64 ? want : 64;  // 180 KB of shared memory at 64
  const int vec = D % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0 &&
                  (!sq || (reinterpret_cast<uintptr_t>(q) & 15) == 0);
  auto s = (cudaStream_t)stream;
  switch (nq * 2 + sq) {
#define EXACT_POOL_TC_LAUNCH(NQ, SQ)                                          \
  case NQ * 2 + SQ:                                                           \
    return launch<NQ, SQ>(q, x, aux0, aux1, out_s, out_i, Q, N, D, kq, tile,  \
                          bins, fold, W, cosine, vec, s);
    EXACT_POOL_TC_LAUNCH(128, false)
    EXACT_POOL_TC_LAUNCH(64, false)
    EXACT_POOL_TC_LAUNCH(32, false)
    EXACT_POOL_TC_LAUNCH(16, false)
    EXACT_POOL_TC_LAUNCH(8, false)
    EXACT_POOL_TC_LAUNCH(64, true)
    EXACT_POOL_TC_LAUNCH(32, true)
    EXACT_POOL_TC_LAUNCH(16, true)
    EXACT_POOL_TC_LAUNCH(8, true)
#undef EXACT_POOL_TC_LAUNCH
  }
  return (int)cudaErrorInvalidValue;
}
