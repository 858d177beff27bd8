// Exact binned pools B1 and B2 on Hopper's tensor cores: the counterparts
// of the TPU kernels vectorsearch_tpu/ops/pallas/exact.py::_pool_kernel
// (B1, reached through exact_bin_pool; launched through exact_pool_launch
// below) and ::_packed_pool_kernel (B2, reached through
// exact_bin_pool_packed; launched through exact_pool_packed_launch). One
// mainloop serves each form a launch can take (exact_pool_plan picks it):
// exact_pool_tc_kernel (B1 narrow: rows of up to 128 live features),
// exact_pool_wide_kernel<false> (B1 wide: wider rows, after its prologue
// exact_pool_query_planes_kernel) and exact_pool_pipelined_kernel (B2 where
// its resident query planes fit). B2 on rows too wide for those planes is
// exact_pool_wide_kernel<true> (B2 wide): B1's wide mainloop, instruction
// for instruction, with B2's tile epilogue, so it writes B2's packed plane
// at the pool's own fold in one launch of all the queries. The mainloops
// share no logic, only the small helpers (the TF32 split, the wgmma
// wrappers, the descriptors, the query planes' layout, the TMA and mbarrier
// wrappers).
//
// B1's function (the TPU kernel's, so the two pools compare directly): for
// each query q and each pool column (group g, bin b), the max over the rows
// r < N with r / (fold*tile) == g and r % bins == b of the rank score
//     L2:     s = (2q).x - aux0[r]           (aux0 = ||x||^2, +inf if invalid;
//                                              the wrapper pre-doubles q)
//     COSINE: s = (q.x) * aux0[r] + aux1[r]  (aux0 = 1/||x|| or 0 for a zero
//                                              row, aux1 = 0 or -inf if invalid)
// and the smallest r that attains it. A bin with no valid row scores -inf
// (its id is -1 here; callers mask it). Rows past N are never read. The max
// compares with `>`, so a NaN score never wins (as in the TPU kernel).
//
// B2's function: the same scan, but per TILE t = g*fold + j of the group the
// raw (max m, smallest slice a) of each bin is compressed once into one
// exact-integer f32
//     p = rint(v * mult[q]) * F + (j * tile/bins + a),  F = fold * tile/bins
// with v = -sqrt(max(qn2[q] - m, 0)) for L2 (minus the distance; the sqrt
// runs once per tile, not per element) and v = m for cosine, and the column
// holds the max of p over the group's tiles. mult = steps/scale with
// steps = 2^23/F keeps |p| < 2^24. Tiles are quantized one by one (two
// tiles on one step resolve toward the higher slot), rint rounds half to
// even, a dead bin reads -inf. The build uses no fast-math: the epilogue
// needs IEEE sqrtf and rintf.
//
// All read features 0 .. dl-1 of each row (dl <= D, the row stride): the
// index lane-pads rows with zero columns (Deep10M: 96 -> 128, GIST1M: 960
// -> 1,024), which add exact zeros to every product, so they are skipped.
// The wrapper gives every launch a row stride that is a multiple of 16
// bytes and x on a 16-byte boundary (it pads other widths with zero
// columns), which 16-byte copies and TMA tensor maps need.
//
// What bounds it on an H100: a [Q, N] x [N, dl] product folded into a
// per-bin reduction, so the [Q, N] score matrix never reaches device memory.
// At the sift1m 8-segment group (Q 512, N 800,768, D 128) that is 105 GFLOP
// against 410 MB of x; at the Deep10M 8-segment group (N 8,000,512, dl 96)
// 0.79 TFLOP against 3.1 GB: operations bound both. The scores become true
// distances with no re-rank behind them (exact_finalize), so the product
// must keep FP32's precision.
//
// Precision: 3xTF32. Each operand v splits into big = tf32_rna(v) and
// small = tf32_rna(v - big) (v - big is exact in f32), and the tensor cores
// accumulate small_q.big_x + big_q.small_x + big_q.big_x in f32: a relative
// error of ~2^-21, FP32's class, so the plain versions (full f32) and the
// card check's tolerances stay as they were (B2's packed levels are ~2^-17
// of the scale apart, so they move by at most one). The tensor cores only
// ever see values whose low 13 bits are zero. The TPU kernel's split-bf16
// form would run twice the tensor rate on paper, but errs by up to ~1.1e-5 x
// 2|q||x|, the edge of B1's tolerance. Three TF32 passes at 495 TFLOP/s put
// B1's ceiling at ~0.64 ms for the sift1m shape, B2's at ~4.8 ms for the
// Deep10M one. B2 and B1's wide form also sum each 32-feature chunk's
// products apart (chunk sums) and add the chunks in registers: the tensor
// cores round each MMA's sum into the accumulator toward zero, so
// accumulated inside the MMAs over a slice the error grows with the running
// sum and the chunk count. At GIST1M's rows (960 features in 30 chunks,
// |q|^2 ~ 16,000) one accumulator put ~1e-4 on a neighbour's distance, ~25x
// float32's; at 128 features (4 chunks) it stays within B1's tolerance, so
// B1's narrow kernel keeps one accumulator at every query tile, and a
// narrow row's distance does not depend on its batch's size. The same
// rounding moves B2's quantization step (up to 2-3 levels at F 8 over 128
// features; tests/test_torch_exact_packed.py emulates it).
//
// The mainloops put the product on the tensor cores as warpgroup MMA
// (wgmma m64nNk8 TF32) with x in registers as the A operand (split into big
// and small by the consumer threads) and the query tile in shared memory as
// B, split into two planes in wgmma's K-major layout (no swizzle: 8x4
// core matrices of 128 contiguous bytes). A block takes 128 (B1, B2 wide)
// or 64 (B2 pipelined) pool columns of one group and walks the group's row slices (slice sl is
// rows group_row0 + sl*bins + b0 .., so accumulator row i of every slice
// belongs to bin b0 + i). The running (max, slice) of each (row, query)
// pair lives in registers in the accumulator's own fragment layout, so a
// slice's epilogue is elementwise: take off the column term, keep score and
// slice on `>`. Slices ascend, so the smallest row wins a tie. B1's slice
// indices (in the group) are 16 bits, two per register; B2's (in the tile:
// a < tile/bins <= 16, and the packed slot is j * tile/bins + a) are 4
// bits, eight per register, and its running packed maxima live in shared
// memory. blockIdx.x is the query tile in every form, so the query tiles of
// one column block run side by side and x is read from device memory about
// once.
//
// B1 narrow (exact_pool_tc_kernel<NQ>): x arrives by cp.async (16-byte
// copies, zero-filled past N and past dl) into rings of 32 features a stage
// (4 stages), whose padded row stride (36 floats) makes every fragment load
// conflict-free. Each of the block's two warpgroups has a ring of its own
// 64 rows of the 128-row slice and its own named barrier, one wait per
// stage with the next stages' copies in flight, so the two warpgroups drift
// apart and one's epilogue and fragment splits overlap the other's MMAs. A
// warpgroup waits for its MMAs at every chunk (wgmma.wait_group 0) before
// its epilogue. NQ is the power of two up to 128 that Q needs; the resident
// query planes take 2 * NQ * ceil32(dl) * 4 bytes beside the rings (72 KB),
// 128 KB at NQ 128 and dl 128. Its main path is D 128 (NQ 128: sift1m's kNN
// seal route, the mesh, Deep10M's brute table).
//
// B1 wide (exact_pool_wide_kernel<false>): rows over 128 live features (kq > 128),
// whose query planes the narrow kernel cannot hold resident at a useful
// query tile:
// - The query planes are split once a launch, by a prologue kernel
//   (exact_pool_query_planes_kernel) into a scratch the wrapper allocates
//   (wide_plane_floats: 3.9 MB at Q 512 x 960), chunk by chunk in wgmma's
//   layout, cvt.rna as before; the ring brings each chunk's two planes
//   beside x by one bulk copy.
// - B2's warp specialisation: 384 threads, setmaxnreg 24 / 240; thread 0
//   of the producer warp issues a stage's copies (x's 128 rows x 32
//   features as one TMA box, 128-byte swizzled, zeros past N and past dl;
//   the planes, 16 KB), its warp the slice's column terms at
//   the slice's last chunk (cp.async), all on the stage's full mbarrier;
//   the consumers spend no instruction on a copy.
// - One MMA wait a chunk, as B2's: two accumulators and two sets of x
//   fragments, chunk c+1's 12 MMAs committed before wgmma.wait_group 1 on
//   chunk c, whose chunk-sum add (and, once every 30 chunks at GIST1M, the
//   slice epilogue) runs under them. The x split in integer operations
//   (split_tf32_int).
// - The tile: a block takes 128 rows (pool columns) x 64 queries, each
//   consumer warpgroup 64 rows against the stage's 64-query planes (64
//   registers of accumulators, 32 of chunk sums, 32 running maxima, 16 of
//   16-bit slices: 168 registers at launch, no spill). Of the two tiles the
//   register file allows, this one pulls the fewer bytes from L2: N * Q *
//   dl * (4/64 + 8/128), 49.2 GB at GIST1M's 8-segment group against 61.5
//   GB for 64 rows x 128 queries. blockIdx.x is the query tile, so x comes
//   from device memory about once.
// - The feed: the kernel asks the ring 80-90% of the rate its copy-only
//   variant (EXACT_POOL_FEED_ONLY: the consumers wait for each stage and
//   hand it back) reaches, 8.2-8.8 TB/s from L2 on one H100. TMA multicast
//   of x over a cluster of two neighbouring query tiles ran 2x slower; 6
//   stages ran as 4, 3 ran 15% slower (PERF.md section 6, PR 18).
// Its arithmetic is B2's: 3xTF32 in the same pass order, chunk sums over
// 32 features added in order, slices ascending on `>`.
//
// B2 wide (exact_pool_wide_kernel<true>): B2 where its resident query
// planes do not fit (over 704 live features at Q 512: the 768- to
// 1,536-feature text embeddings). The mainloop above, unchanged (the same
// prologue, ring, passes, chunk sums and `>`); only what a slice epilogue
// keeps differs. The winning slice is kept in its tile, in 4 bits, eight a
// register (16 registers of slices become 4), by one select of bits as the
// 16-bit slices take. At a tile's last slice (every tile/bins slices, and
// at the block's last live one) B2's tile epilogue, as B2's pipelined form
// has it: each (row, query)'s best of the tile compressed once into
// rint(v * mult) * F + slot, merged by max into a packed plane in shared
// memory, the tile's best reset to -inf; the block's queries' mult and
// qn2 are staged once. It runs once every tile/bins x kq/32 ring steps (192
// at Cohere10M's 768 features), so it adds well under 1% of the mainloop's
// instructions; the slice epilogue only marks it due, and the step loop
// runs it after each pair of steps and after the last, so the unrolled loop
// holds two copies of it, not one a step. One launch takes all the queries at the pool's fold, in
// 64-query tiles, and writes only the packed plane [Q, W]: no fold-1
// planes, no row ids. Every operation of the packing is an IEEE single one
// (sqrtf, the product, rintf's round half to even; p is an exact integer
// below 2^24), so the plane equals B1's wide form at fold 1 packed in plain
// torch (vectorsearch_torch/ops/exact.py::pack_tiles) bit for bit.
// Shared memory (4 stages; B2 wide adds the packed plane and query terms):
//   ring, 4 stages x (16 KB of x + 2 x 8 KB of query planes)  131,072
//   column terms, 4 stages x 2 x 128 x 4 B                        4,096
//   B2 wide: packed plane, 32 values x 256 threads x 4 B         32,768
//   B2 wide: query terms, 64 queries x 2 x 4 B                      512
//   mbarriers, 8 x 8 B                                               64
//   alignment to the swizzle's 1,024-byte period                  1,024
//   total                                           136,256 / 169,536
//
// B2 pipelined (exact_pool_pipelined_kernel):
// - One MMA wait a chunk. Each consumer warpgroup takes 64 rows x NQW (up
//   to 64) queries: one accumulator of NQW/2 registers a chunk, so two
//   accumulators and two sets of x fragments fit beside the chunk sums and
//   the running maxima (240 registers a consumer thread through setmaxnreg;
//   the producer warpgroup keeps 24). Chunk c+1's fragments are split and
//   its 12 MMAs committed before the warpgroup waits for chunk c's
//   (wgmma.wait_group 1); chunk c's chunk-sum add, the slice epilogue and
//   the tile epilogue then run under chunk c+1's MMAs.
// - A ring of 4 stages filled by TMA. Thread 0 of the producer warpgroup
//   issues a 2-D tensor copy a stage (64 rows x 32 features of x, box
//   {32, 64} of the tensor map [N, dl] with row stride D; rows past N and
//   features past dl arrive as zeros); the lanes of its warp copy the
//   slice's column terms (aux0, aux1 of the 64 rows, zeros past N) by
//   cp.async beside it; both complete on the stage's full mbarrier (33
//   arrivals). Each consumer warp arrives on the stage's empty mbarrier
//   after the step's epilogue, which reads the column terms last. The
//   consumers spend no instruction on an address or a copy of x. The
//   stages are 128-byte swizzled (16-byte unit u of row r at u ^ (r & 7)),
//   so the fragment loads are conflict-free with one XOR a load address.
// - The block's two consumer warpgroups share each stage (the same 64 rows
//   of the slice, each against its own NQW queries), so a block takes
//   2 * NQW queries, and Q 512 makes 4 query tiles as before: x is read from
//   L2 four times, from device memory about once.
// - Fewest instructions a chunk. On the card every instruction that any
//   warp of the SM issues beside the MMAs lengthens them: the MMAs and the
//   copies alone ran Deep10M's shape in 6.0 ms; 768 more warp
//   instructions a chunk (96 FFMAs a consumer thread, or 256 a thread of
//   the producer's three idle warps) added 1.4-2.4 ms; integer, select and
//   add chains cost about the same per instruction; and the SM clock rose
//   meanwhile (so not power). So: the x split in integer
//   operations (split_tf32_int), the descriptors in uniform registers, the
//   column terms one FFMA from shared memory, the running max and slice
//   without branches, the queries' quantization terms staged once a block.
//   Staging the tile epilogue through shared memory, or sharing each split
//   between the two warpgroups through shared memory, ran slower: their
//   loads, stores and barriers cost more than they saved.
// Shared memory at NQW 64, dl 96 (kq 96), of the block's 232,448 bytes:
//   ring of x, 4 stages x 8 KB                   32,768
//   column terms, 4 stages x 2 x 64 x 4 B         2,048
//   query planes, 2 x 128 queries x 96 x 4 B     98,304
//   packed plane, 32 values x 256 threads x 4 B  32,768
//   query terms, 128 queries x 2 x 4 B           1,024
//   mbarriers, 8 x 8 B                              64
//   alignment to the swizzle's 1,024-byte period 1,024
//   total                                       168,000
// The room came from the padded stride (36 floats to 32: 8 KB a stage where
// a 64-row stage of B1's takes 9 KB), from sharing each stage between the
// warpgroups (one ring, not one each) and from the 64-query accumulator
// tile (the packed plane halves to 32 KB). Up to kq 128 fits at NQW 64,
// 320 at 32, 704 at 16; NQW halves (not below 16, or what Q needs) until
// the planes fit. Wider rows (768- to 1,536-feature embeddings at Q 512)
// take B2's wide form.

#include <cuda.h>  // the tensor map's types (libcuda is not linked)
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 128;     // pool columns (bins) per block = rows per slice
constexpr int KC = 32;        // features per ring stage
constexpr int XS = KC + 4;    // a stage's row stride in floats
constexpr int STAGES = 4;     // ring depth (B2: 3, for its packed plane)
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

// The same split in four integer and float operations (B2 pipelined's hot
// loop, where every instruction costs tensor-core time): for a finite v,
// adding half a TF32 unit to the magnitude's bits and clearing the low 13
// rounds to the nearest TF32 with ties away from zero, bit for bit as
// cvt.rna (tests/test_torch_exact_pool.py::_tf32_rna). The MMA operands
// keep their low 13 bits uncleared: the tensor cores ignore them (on the
// card the planes came out bit-identical to cleared operands). A NaN or
// infinite feature leaves the row's score NaN or -inf through its column
// term either way, so such a row never wins.
__device__ __forceinline__ void split_tf32_int(float v, uint32_t& big,
                                               uint32_t& small) {
  big = __float_as_uint(v) + 0x1000u;
  small = __float_as_uint(v - __uint_as_float(big & 0xFFFFE000u)) + 0x1000u;
}

// 16 bytes into shared memory, of which the first `bytes` (0-16) come from
// src and the rest are zero
__device__ __forceinline__ void cp_async16(uint32_t dst, const float* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}

// One float into shared memory: src's where ok, else zero
__device__ __forceinline__ void cp_async_f32(uint32_t dst, const float* src,
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

// The kernel's arguments (one struct, passed by value).
struct PoolArgs {
  const float* q;     // [Q, D] (pre-doubled for L2)
  const float* x;     // [N, D]
  const float* aux0;  // [N]
  const float* aux1;  // [N] (COSINE only)
  const float* mult;  // [Q] steps / scale (B2 only)
  const float* qn2;   // [Q] ||q||^2 (B2, L2 only)
  float* out_s;       // [Q, W] B1's scores, or B2's packed plane
  int* out_i;         // [Q, W] B1's row ids
  int Q, N, D, dl, kq, tile, bins, fold, W, cosine;
  float slot_f;       // B2's F
  float* qp;          // the wide forms: the query planes' scratch (wide_plane_floats)
  long long qp_floats;
};

// Bytes of shared memory of the narrow kernel: the query planes and the two
// warpgroups' rings.
size_t smem_bytes(int nq, int kq) {
  return sizeof(float) * ((size_t)2 * nq * kq + (size_t)2 * STAGES * WG_ROWS * XS);
}

// Shared memory: the two query planes [NQ x kq], then each warpgroup's ring
// of STAGES x [64 x XS].
template <int NQ>
__global__ void __launch_bounds__(THREADS, 1) exact_pool_tc_kernel(const PoolArgs a) {
  extern __shared__ __align__(128) float smem[];
  constexpr int STAGE = WG_ROWS * XS;  // floats per stage
  const float* __restrict__ q = a.q;
  const float* __restrict__ x = a.x;
  const int Q = a.Q, N = a.N, D = a.D, dl = a.dl, kq = a.kq, bins = a.bins;
  const bool cosine = a.cosine != 0;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int me = tid & (WG_THREADS - 1);  // index in the warpgroup
  const int row0 = wg * WG_ROWS;          // the warpgroup's first slice row
  float* qb = smem;                       // big halves of the queries
  float* qs = qb + NQ * kq;               // their small halves
  float* ring = smem + 2 * NQ * kq + wg * STAGES * STAGE;
  const int g = (tid & 31) >> 2, t = tid & 3;
  const int lr0 = (tid >> 5) * 16 + g;  // this thread's rows: lr0, lr0 + 8
  const int q0 = blockIdx.x * NQ;
  const int col_blocks = bins / ROWS;
  const int grp = blockIdx.y / col_blocks;
  const int b0 = (blockIdx.y % col_blocks) * ROWS;
  const long long first = (long long)grp * a.fold * a.tile + b0;
  const int slices = a.fold * (a.tile / bins);
  // slices holding rows < N (later ones lie further past N)
  const int nsl = first >= N ? 0
      : (int)(((N - first + bins - 1) / bins) < slices
                  ? (N - first + bins - 1) / bins : slices);
  const int nch = kq / KC;  // ring stages per slice
  const int steps = nsl * nch;
  const long long col0 = (long long)grp * bins + b0;

  // step s = (slice s / nch, feature chunk s % nch) -> its ring stage
  auto load_stage = [&](int s) {
    const int sl = s / nch;
    const long long base = first + (long long)sl * bins + row0;
    const int k0 = (s - sl * nch) * KC;
    float* st = ring + (s % STAGES) * STAGE;
    for (int e = me; e < WG_ROWS * KC / 4; e += WG_THREADS) {
      const int row = e >> 3, kk = (e & 7) * 4;
      const long long r = base + row;
      const int left = dl - k0 - kk;  // features of this copy below dl
      const bool ok = r < N && left > 0;
      cp_async16(smem_addr(st + row * XS + kk), ok ? x + r * D + k0 + kk : x,
                 ok ? (left < 4 ? 4 * left : 16) : 0);
    }
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) load_stage(s);
    cp_async_commit();
  }

  // the query tile, split once into the two planes (zero past Q and dl)
  for (int o = tid; o < NQ * kq; o += THREADS) {
    int n, k;
    plane_pos(o, kq, n, k);
    const int qi = q0 + n;
    const float v = (qi < Q && k < dl) ? q[(long long)qi * D + k] : 0.f;
    uint32_t big, small;
    split_tf32(v, big, small);
    qb[o] = __uint_as_float(big);
    qs[o] = __uint_as_float(small);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  // The winning slices: each one's index in the group, 16 bits, two per
  // register.
  float acc[NQ / 2], best[NQ / 2];
  uint32_t slot[NQ / 4];
#pragma unroll
  for (int i = 0; i < NQ / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < NQ / 2; ++i) best[i] = -CUDART_INF_F;
#pragma unroll
  for (int i = 0; i < NQ / 4; ++i) slot[i] = 0xFFFFFFFFu;
  float ca0 = 0.f, cb0 = 0.f, ca1 = 0.f, cb1 = 0.f;  // rows lr0, lr0 + 8
  const uint32_t pb = smem_addr(qb), ps = smem_addr(qs);
  const uint32_t sbo = (uint32_t)kq * 32;

  for (int s = 0; s < steps; ++s) {
    cp_async_wait<STAGES - 2>();
    // stage s landed; stage s - 1 is free for reuse
    asm volatile("bar.sync %0, %1;\n" :: "r"(1 + wg), "n"(WG_THREADS) : "memory");
    if (s + STAGES - 1 < steps) load_stage(s + STAGES - 1);
    cp_async_commit();

    const int sl = s / nch, c = s - sl * nch;
    const long long r0 = first + (long long)sl * bins + lr0, r1 = r0 + 8;
    if (c == 0) {  // the slice's column terms, needed at its last chunk
      ca0 = r0 < N ? a.aux0[r0] : 0.f;
      ca1 = r1 < N ? a.aux0[r1] : 0.f;
      cb0 = (cosine && r0 < N) ? a.aux1[r0] : 0.f;
      cb1 = (cosine && r1 < N) ? a.aux1[r1] : 0.f;
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
    // the tile's queries at this step's 8 features ks
    auto desc = [&](uint32_t plane, int ks) {
      return smem_desc(plane + (uint32_t)(c * 4 + ks) * 256, 128, sbo);
    };
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      // a slice's first product overwrites the accumulator
      Wgmma<NQ>::run(acc, as[ks], desc(pb, ks), (c | ks) != 0);
      Wgmma<NQ>::run(acc, ab[ks], desc(ps, ks), 1);
      Wgmma<NQ>::run(acc, ab[ks], desc(pb, ks), 1);
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
          // both elements' slice indices share a register; the update is a
          // branch (on the card it ran faster than selects)
          uint32_t sp = slot[2 * j + h];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * j + 2 * h + e;
            const int sh = 16 * e;
            const float sc = cosine ? acc[i] * ca + cb : acc[i] - ca;
            if (ok && sc > best[i]) {
              best[i] = sc;
              sp = (sp & ~(0xFFFFu << sh)) | ((uint32_t)sl << sh);
            }
          }
          slot[2 * j + h] = sp;
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < NQ / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qi = q0 + 8 * j + 2 * t + e;
        if (qi >= Q) continue;
        const int lr = lr0 + 8 * h;
        const long long o = (long long)qi * a.W + col0 + lr;
        const int i = 4 * j + 2 * h + e;
        const uint32_t sv = (slot[i / 2] >> (16 * e)) & 0xFFFFu;
        a.out_s[o] = best[i];
        a.out_i[o] = sv == NO_SLICE ? -1 : (int)(first + (long long)sv * bins + lr);
      }
}

// ------------------------------------------------------- B2 pipelined

constexpr int P_ROWS = 64;    // pool columns a block = rows a slice = wgmma M
constexpr int P_STAGES = 4;   // ring depth (a power of two)
constexpr int P_STAGE = P_ROWS * KC;  // floats a stage: one TMA box, 8 KB
constexpr int P_THREADS = 384;        // the producer warpgroup, two consumers
constexpr int P_CONSUMERS = 256;
// registers a thread after setmaxnreg: 128 x 24 + 256 x 240 = 64,512, the
// 168 a thread that 384 threads launch with
constexpr int P_PRODUCER_REGS = 24;
constexpr int P_CONSUMER_REGS = 240;

// Bytes of shared memory of the pipelined form at NQW queries a consumer
// warpgroup (the head of the file itemizes them).
size_t pipe_smem_bytes(int nqw, int kq) {
  return 1024 + sizeof(float) * ((size_t)P_STAGES * (P_STAGE + 2 * P_ROWS) +
                                 (size_t)2 * 2 * nqw * kq +
                                 (size_t)nqw / 2 * P_CONSUMERS +
                                 (size_t)2 * 2 * nqw) +
         2 * P_STAGES * sizeof(uint64_t);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

// Arrives once and adds `bytes` to the phase's expected transaction count.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// Arrives once where `lane` is 0 (no branch around it).
__device__ __forceinline__ void mbar_arrive_lane0(uint32_t bar, int lane) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.eq.s32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n"
      :: "r"(bar), "r"(lane) : "memory");
}

// Waits until the barrier's phase of this parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred done;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra LAB_WAIT;\n}\n"
      :: "r"(bar), "r"(parity) : "memory");
}

// A 2-D box of the tensor map at (feature c0, row c1) into shared memory,
// completed on the barrier.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(bar) : "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

template <int V>
struct Buf {
  static constexpr int value = V;
};

// Shared memory (from a 1,024-byte boundary): the ring of P_STAGES x [64 x
// 32] of x (128-byte swizzled), the two query planes [2 NQW x kq], the
// packed plane (NQW/2 values of each consumer thread), each stage's column
// terms [2 x 64], the block's query terms [2 NQW x 2], the full and the
// empty mbarriers. Threads 0-127 are the producer warpgroup (its warp 0
// issues the copies; warps 1-3 only give their registers up), 128-383 the
// two consumer warpgroups.
template <int NQW>
__global__ void __launch_bounds__(P_THREADS, 1)
    exact_pool_pipelined_kernel(const __grid_constant__ PoolArgs a,
                                const __grid_constant__ CUtensorMap xmap) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  float* ring = reinterpret_cast<float*>(
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023));
  const int N = a.N, kq = a.kq, bins = a.bins;
  float* qb = ring + P_STAGES * P_STAGE;  // big halves of the queries
  float* qs = qb + 2 * NQW * kq;          // their small halves
  float* pk = qs + 2 * NQW * kq;          // element i of thread ct at pk[i * 256 + ct]
  float* cols = pk + NQW / 2 * P_CONSUMERS;  // each stage's aux0, aux1 of its 64 rows
  float* qterm = cols + P_STAGES * 2 * P_ROWS;  // mult, qn2 of the block's queries
  const uint32_t ring_s = smem_addr(ring);
  const uint32_t full_s = smem_addr(qterm + 2 * 2 * NQW);
  const uint32_t empty_s = full_s + 8 * P_STAGES;
  const int tid = threadIdx.x;
  const int col_blocks = bins / P_ROWS;
  const int grp = blockIdx.y / col_blocks;
  const int b0 = (blockIdx.y % col_blocks) * P_ROWS;
  const long long first = (long long)grp * a.fold * a.tile + b0;
  const int per = a.tile / bins;  // row slices per tile
  const int slices = a.fold * per;
  // slices holding rows < N (later ones lie further past N)
  const int nsl = first >= N ? 0
      : (int)(((N - first + bins - 1) / bins) < slices
                  ? (N - first + bins - 1) / bins : slices);
  const int nch = kq / KC;  // ring stages per slice
  const int steps = nsl * nch;

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < P_STAGES; ++i) {
      mbar_init(full_s + 8 * i, 1 + 32);  // the copy's thread, the column terms' warp
      mbar_init(empty_s + 8 * i, P_CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < WG_THREADS) {
    // the producer warp: step s = (slice s / nch, feature chunk s % nch)
    // into stage s % P_STAGES once the consumers have left it; thread 0
    // copies x's box by TMA, the warp the slice's column terms by cp.async
    // (zeros past N), each lane's completion an arrival on the full barrier
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(P_PRODUCER_REGS));
    if (tid < 32) {
      const bool cosine = a.cosine != 0;
      int c = 0, row = (int)first;
      for (int s = 0; s < steps; ++s) {
        const int st = s & (P_STAGES - 1);
        const uint32_t full = full_s + 8 * st;
        if (s >= P_STAGES) mbar_wait(empty_s + 8 * st, ((s / P_STAGES) + 1) & 1);
        if (tid == 0) {
          mbar_expect_tx(full, P_STAGE * sizeof(float));
          tma_load_2d(ring_s + st * P_STAGE * sizeof(float), &xmap, c * KC, row, full);
        }
        const uint32_t dst = smem_addr(cols + st * 2 * P_ROWS);
#pragma unroll
        for (int k = 0; k < P_ROWS; k += 32) {
          const int r = row + k + tid;
          const bool ok = r < N;
          cp_async_f32(dst + 4 * (k + tid), ok ? a.aux0 + r : a.aux0, ok);
          if (cosine)
            cp_async_f32(dst + 4 * (P_ROWS + k + tid), ok ? a.aux1 + r : a.aux1, ok);
        }
        asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
                     :: "r"(full) : "memory");
        if (++c == nch) {
          c = 0;
          row += bins;
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(P_CONSUMER_REGS));
  const int ct = tid - WG_THREADS;  // consumer thread 0 .. 255
  // its warpgroup (queries wg*NQW ..), warp-uniform as the compiler sees it,
  // so the MMA descriptors live in uniform registers
  const int wg = __shfl_sync(0xFFFFFFFFu, ct >> 7, 0);
  const int lane = ct & 31;
  const int g = lane >> 2, t = lane & 3;
  const int lr0 = ((ct & 127) >> 5) * 16 + g;  // this thread's rows: lr0, lr0 + 8
  const int Q = a.Q;
  const int q0 = blockIdx.x * 2 * NQW;  // the block's queries
  const int qw = q0 + wg * NQW;         // the warpgroup's
  const bool cosine = a.cosine != 0;

  // the block's queries' quantization terms
  for (int n = ct; n < 2 * NQW; n += P_CONSUMERS) {
    const int qi = q0 + n;
    qterm[2 * n] = qi < Q ? a.mult[qi] : 0.f;
    qterm[2 * n + 1] = (qi < Q && !cosine) ? a.qn2[qi] : 0.f;
  }
  // the block's query tile, split once into the two planes (zero past Q
  // and dl)
  for (int o = ct; o < 2 * NQW * kq; o += P_CONSUMERS) {
    int n, k;
    plane_pos(o, kq, n, k);
    const int qi = q0 + n;
    const float v = (qi < Q && k < a.dl) ? a.q[(long long)qi * a.D + k] : 0.f;
    uint32_t big, small;
    split_tf32(v, big, small);
    qb[o] = __uint_as_float(big);
    qs[o] = __uint_as_float(small);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync 1, %0;\n" :: "n"(P_CONSUMERS) : "memory");

  // two accumulators and two sets of x fragments: one chunk's MMAs run
  // while the last chunk is summed and its epilogue runs. acc[b][4j + 2h +
  // e] (and sum, best) is row lr0 + 8h, query qw + 8j + 2t + e. The winning
  // slices in the tile: 4 bits, eight a register.
  constexpr int NA = NQW / 2;
  constexpr int NSLOT = (NA + 7) / 8;
  float acc[2][NA], best[NA], sum[NA];
  uint32_t fb[2][4][4], fs[2][4][4], slot[NSLOT];
#pragma unroll
  for (int i = 0; i < NA; ++i) {
    acc[0][i] = 0.f;
    acc[1][i] = 0.f;
    best[i] = -CUDART_INF_F;
    sum[i] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < NSLOT; ++i) slot[i] = 0xFFFFFFFFu;
  const uint32_t pb = smem_addr(qb), ps = smem_addr(qs);
  const uint32_t sbo = (uint32_t)kq * 32;
  const uint32_t qoff = (uint32_t)(wg * NQW / 8) * sbo;
  // the fragment loads' byte offsets in a stage: unit u of row lr0 lies at
  // lr0 * 128 + (u ^ g) * 16, which is frag ^ (u << 4) (lr0 * 128 has its
  // low 7 bits clear); row lr0 + 8 lies 1,024 bytes on
  const uint32_t frag = lr0 * 128 + g * 16 + t * 4;

  // Step s (chunk c of its slice) into buffer B: wait for its stage, split
  // the warp's fragments (rows lr0, lr0 + 8; features t, t + 4 of each k8;
  // unit u of row r sits at u ^ (r & 7), and r & 7 is g for both rows),
  // commit the chunk's 12 MMAs (small terms first: the chunk's first
  // product overwrites the accumulator: chunk sums). The stage goes back to
  // the producer in finish, after its column terms are read.
  auto issue = [&](auto buf, int s, int c) {
    constexpr int B = decltype(buf)::value;
    const int st = s & (P_STAGES - 1);
    mbar_wait(full_s + 8 * st, (s / P_STAGES) & 1);
    const unsigned char* stage =
        reinterpret_cast<const unsigned char*>(ring + st * P_STAGE);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const float* p0 = reinterpret_cast<const float*>(stage + (frag ^ (2 * ks << 4)));
      const float* p1 = reinterpret_cast<const float*>(stage + (frag ^ ((2 * ks + 1) << 4)));
      split_tf32_int(p0[0], fb[B][ks][0], fs[B][ks][0]);
      split_tf32_int(p0[256], fb[B][ks][1], fs[B][ks][1]);
      split_tf32_int(p1[0], fb[B][ks][2], fs[B][ks][2]);
      split_tf32_int(p1[256], fb[B][ks][3], fs[B][ks][3]);
    }
#pragma unroll
    for (int i = 0; i < NA; ++i) reg_fence(acc[B][i]);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    auto desc = [&](uint32_t plane, int ks) {
      return smem_desc(plane + (uint32_t)(c * 4 + ks) * 256 + qoff, 128, sbo);
    };
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) Wgmma<NQW>::run(acc[B], fs[B][ks], desc(pb, ks), ks != 0);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) Wgmma<NQW>::run(acc[B], fb[B][ks], desc(ps, ks), 1);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) Wgmma<NQW>::run(acc[B], fb[B][ks], desc(pb, ks), 1);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  };

  // Step c's chunk in buffer B, its MMAs complete: into the slice's sum
  auto add = [&](auto buf, int c) {
    constexpr int B = decltype(buf)::value;
#pragma unroll
    for (int i = 0; i < NA; ++i) reg_fence(acc[B][i]);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        reg_fence(fb[B][ks][f]);
        reg_fence(fs[B][ks][f]);
      }
    if (c == 0) {
#pragma unroll
      for (int i = 0; i < NA; ++i) sum[i] = 0.f + acc[B][i];
    } else {
#pragma unroll
      for (int i = 0; i < NA; ++i) sum[i] += acc[B][i];
    }
  };

  // Where a step lies: step s, chunk c of slice sl, the slice in_tile of its
  // tile.
  struct Pos {
    int s, c, sl, in_tile;
  };
  auto next = [&](Pos p) {
    ++p.s;
    if (++p.c == nch) {
      p.c = 0;
      ++p.sl;
      if (++p.in_tile == per) p.in_tile = 0;
    }
    return p;
  };

  // After step p's sum: at the slice's last chunk keep (score, slice) on
  // `>`; at the tile's last slice compress, merge into the packed plane,
  // start afresh.
  auto epilogue = [&](Pos p) {
    if (p.c != nch - 1) return;
    const int sl = p.sl, in_tile = p.in_tile;
    // rows lr0 and lr0 + 8's column terms as one FFMA, score = sum * m + c:
    // L2 (1, -aux0), exact as sum - aux0; cosine (aux0, aux1); a row past N
    // (0, -inf), which never wins
    const float* cl = cols + (p.s & (P_STAGES - 1)) * 2 * P_ROWS;
    const long long r0 = first + (long long)sl * bins + lr0;
    const bool ok0 = r0 < N, ok1 = r0 + 8 < N;
    float m0, c0, m1, c1;
    if (cosine) {
      m0 = ok0 ? cl[lr0] : 0.f;
      m1 = ok1 ? cl[lr0 + 8] : 0.f;
      c0 = ok0 ? cl[P_ROWS + lr0] : -CUDART_INF_F;
      c1 = ok1 ? cl[P_ROWS + lr0 + 8] : -CUDART_INF_F;
    } else {
      m0 = ok0 ? 1.f : 0.f;
      m1 = ok1 ? 1.f : 0.f;
      c0 = ok0 ? -cl[lr0] : -CUDART_INF_F;
      c1 = ok1 ? -cl[lr0 + 8] : -CUDART_INF_F;
    }
#pragma unroll
    for (int j = 0; j < NQW / 8; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float m = h ? m1 : m0, cc = h ? c1 : c0;
        uint32_t sp = slot[(4 * j + 2 * h) / 8];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * h + e;
          const int sh = (i % 8) * 4;
          const float sc = fmaf(sum[i], m, cc);
          const bool up = sc > best[i];
          best[i] = up ? sc : best[i];
          sp = up ? (sp & ~(0xFu << sh)) | ((uint32_t)in_tile << sh) : sp;
        }
        slot[(4 * j + 2 * h) / 8] = sp;
      }
    }
    if (in_tile != per - 1 && sl + 1 != nsl) return;
    const bool first_tile = sl < per;
    const int tile0 = sl - in_tile;  // the tile's first slice
#pragma unroll
    for (int j = 0; j < NQW / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = wg * NQW + 8 * j + 2 * t + e;  // the query in the block
        const bool live = q0 + n < Q;
        const float m = qterm[2 * n], n2 = qterm[2 * n + 1];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 4 * j + 2 * h + e;
          const float b = best[i];
          const float v = cosine ? b : -sqrtf(fmaxf(n2 - b, 0.f));
          const int sv = tile0 + (int)((slot[i / 8] >> ((i % 8) * 4)) & 0xFu);
          const float pv = rintf(v * m) * a.slot_f + (float)sv;
          if (live) {
            float* o = pk + i * P_CONSUMERS + ct;
            const float old = first_tile ? -CUDART_INF_F : *o;
            *o = pv > old ? pv : old;  // a NaN never wins
          }
          best[i] = -CUDART_INF_F;
        }
      }
  };

  // the step's sums and epilogue, then its stage back to the producer (its
  // column terms were read last)
  auto finish = [&](auto buf, Pos p) {
    add(buf, p.c);
    epilogue(p);
    __syncwarp();
    mbar_arrive_lane0(empty_s + 8 * (p.s & (P_STAGES - 1)), lane);
  };

  // One MMA wait a chunk: step s's MMAs are committed before the wait for
  // step s - 1's (wgmma.wait_group 1), whose sums and epilogues then run
  // under them. Buffers alternate, even steps in 0, odd in 1.
  if (steps > 0) {
    Pos p{0, 0, 0, 0};  // the step in flight
    issue(Buf<0>{}, 0, 0);
    int s = 1;
    for (; s + 1 < steps; s += 2) {
      Pos p1 = next(p);
      issue(Buf<1>{}, s, p1.c);
      wgmma_wait<1>();
      finish(Buf<0>{}, p);
      p = next(p1);
      issue(Buf<0>{}, s + 1, p.c);
      wgmma_wait<1>();
      finish(Buf<1>{}, p1);
    }
    if (s < steps) {
      const Pos p1 = next(p);
      issue(Buf<1>{}, s, p1.c);
      wgmma_wait<1>();
      finish(Buf<0>{}, p);
      wgmma_wait<0>();
      finish(Buf<1>{}, p1);
    } else {
      wgmma_wait<0>();
      finish(Buf<0>{}, p);
    }
  }

  // the packed plane out of shared memory; a column block past N (no tile)
  // has every bin dead
  const long long col0 = (long long)grp * bins + b0;
#pragma unroll
  for (int j = 0; j < NQW / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int qi = qw + 8 * j + 2 * t + e;
      if (qi >= Q) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = 4 * j + 2 * h + e;
        a.out_s[(long long)qi * a.W + col0 + lr0 + 8 * h] =
            nsl == 0 ? -CUDART_INF_F : pk[i * P_CONSUMERS + ct];
      }
    }
}

// ----------------------------------------- B1 and B2 wide (B1's mainloop)

constexpr int W_NQ = 64;                    // queries a block
constexpr int W_STAGES = 4;                 // ring depth
constexpr int W_X = ROWS * KC;              // floats of x a stage: one TMA box, 16 KB
constexpr int W_PLANE = W_NQ * KC;          // floats of one query plane a stage, 8 KB
constexpr int W_STAGE = W_X + 2 * W_PLANE;  // floats a stage, 32 KB

// Floats of the query planes' scratch: for each query tile of 64 and each
// 32-feature chunk, its big and its small plane [64 x 32] in wgmma's layout.
__host__ __device__ __forceinline__ long long wide_plane_floats(int Q, int kq) {
  return (long long)((Q + W_NQ - 1) / W_NQ) * (kq / KC) * 2 * W_PLANE;
}

// Floats of shared memory the packed wide form adds: the packed plane (32
// values of each consumer thread), then the block's query terms (mult,
// qn2 of each of its 64 queries).
constexpr int W_PACKED = W_NQ / 2 * P_CONSUMERS + 2 * W_NQ;

// Bytes of shared memory of the wide form, packed or not (the head of the
// file itemizes them).
size_t wide_smem_bytes(bool packed) {
  return 1024 + sizeof(float) * ((size_t)W_STAGES * (W_STAGE + 2 * ROWS) +
                                 (packed ? W_PACKED : 0)) +
         2 * W_STAGES * sizeof(uint64_t);
}

// One 16-byte-aligned run of bytes from global into shared memory by the
// bulk copy engine, completed on the barrier.
__device__ __forceinline__ void bulk_load(uint32_t dst, const float* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// The wide form's prologue: the query planes, split once a launch (zeros
// past Q and past dl). Chunk c of query tile t: its big plane at
// qp[(t * nch + c) * 2 * W_PLANE ..], element o in plane_pos's layout at 32
// features, then its small plane.
__global__ void exact_pool_query_planes_kernel(const PoolArgs a) {
  const int nch = a.kq / KC;
  const long long total = wide_plane_floats(a.Q, a.kq) / 2;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (long long)gridDim.x * blockDim.x) {
    const int o = (int)(e % W_PLANE);
    const long long tc = e / W_PLANE;  // t * nch + c
    const int c = (int)(tc % nch), t = (int)(tc / nch);
    int n, k;
    plane_pos(o, KC, n, k);
    const int qi = t * W_NQ + n, f = c * KC + k;
    const float v = (qi < a.Q && f < a.dl) ? a.q[(long long)qi * a.D + f] : 0.f;
    uint32_t big, small;
    split_tf32(v, big, small);
    float* dst = a.qp + tc * 2 * W_PLANE;
    dst[o] = __uint_as_float(big);
    dst[W_PLANE + o] = __uint_as_float(small);
  }
}

// Shared memory (from a 1,024-byte boundary): the ring of W_STAGES stages,
// each [128 x 32] of x (128-byte swizzled) then the chunk's big and small
// query planes [64 x 32]; each stage's column terms [2 x 128]; PACKED: the
// packed plane and the block's query terms (W_PACKED); the full and the
// empty mbarriers. Threads 0-127 are the producer warpgroup (its warp 0
// issues the copies), 128-383 the two consumer warpgroups: warpgroup w
// takes rows 64w .. 64w + 63 of each slice against the block's 64 queries.
// PACKED (B2's wide form) writes B2's packed plane where B1 writes its two
// planes; its mainloop is B1's, instruction for instruction.
template <bool PACKED>
__global__ void __launch_bounds__(P_THREADS, 1)
    exact_pool_wide_kernel(const __grid_constant__ PoolArgs a,
                           const __grid_constant__ CUtensorMap xmap) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  float* ring = reinterpret_cast<float*>(
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023));
  float* cols = ring + W_STAGES * W_STAGE;  // each stage's aux0, aux1 of its 128 rows
  float* pk = cols + W_STAGES * 2 * ROWS;   // PACKED: element i of thread ct at pk[i * 256 + ct]
  float* qterm = pk + W_NQ / 2 * P_CONSUMERS;  // PACKED: mult, qn2 of the block's queries
  const uint32_t ring_s = smem_addr(ring);
  const uint32_t full_s = smem_addr(cols + W_STAGES * 2 * ROWS + (PACKED ? W_PACKED : 0));
  const uint32_t empty_s = full_s + 8 * W_STAGES;
  const int N = a.N, bins = a.bins;
  const int tid = threadIdx.x;
  const int col_blocks = bins / ROWS;
  const int grp = blockIdx.y / col_blocks;
  const int b0 = (blockIdx.y % col_blocks) * ROWS;
  const long long first = (long long)grp * a.fold * a.tile + b0;
  const int slices = a.fold * (a.tile / bins);
  // slices holding rows < N (later ones lie further past N)
  const int nsl = first >= N ? 0
      : (int)(((N - first + bins - 1) / bins) < slices
                  ? (N - first + bins - 1) / bins : slices);
  const int nch = a.kq / KC;  // ring stages per slice
  const int steps = nsl * nch;

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < W_STAGES; ++i) {
      mbar_init(full_s + 8 * i, 1 + 32);  // the copies' thread, the column terms' warp
      mbar_init(empty_s + 8 * i, P_CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < WG_THREADS) {
    // the producer warp: step s = (slice s / nch, chunk c = s % nch) into
    // stage s % W_STAGES once the consumers have left it. Thread 0 copies
    // x's box by TMA and the chunk's query planes by the bulk copy engine;
    // at a slice's last chunk the warp copies its column terms by cp.async
    // (zeros past N). Each lane's arrival, after its copies, counts on the
    // full barrier.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(P_PRODUCER_REGS));
    if (tid < 32) {
      const bool cosine = a.cosine != 0;
      const float* qsrc = a.qp + (long long)blockIdx.x * nch * 2 * W_PLANE;
      int c = 0, row = (int)first, st = 0;
      uint32_t ph = 0;
      for (int s = 0; s < steps; ++s) {
        const uint32_t full = full_s + 8 * st;
        if (s >= W_STAGES) mbar_wait(empty_s + 8 * st, ph ^ 1);
        if (tid == 0) {
          const uint32_t dst = ring_s + (uint32_t)(st * W_STAGE) * sizeof(float);
          mbar_expect_tx(full, W_STAGE * sizeof(float));
          tma_load_2d(dst, &xmap, c * KC, row, full);
          bulk_load(dst + W_X * sizeof(float), qsrc + (long long)c * 2 * W_PLANE,
                    2 * W_PLANE * sizeof(float), full);
        }
        if (c == nch - 1) {
          const uint32_t dst = smem_addr(cols + st * 2 * ROWS);
#pragma unroll
          for (int k = 0; k < ROWS; k += 32) {
            const int r = row + k + tid;
            const bool ok = r < N;
            cp_async_f32(dst + 4 * (k + tid), ok ? a.aux0 + r : a.aux0, ok);
            if (cosine)
              cp_async_f32(dst + 4 * (ROWS + k + tid), ok ? a.aux1 + r : a.aux1, ok);
          }
        }
        asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
                     :: "r"(full) : "memory");
        if (++c == nch) {
          c = 0;
          row += bins;
        }
        if (++st == W_STAGES) {
          st = 0;
          ph ^= 1;
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(P_CONSUMER_REGS));
  const int ct = tid - WG_THREADS;  // consumer thread 0 .. 255
  // its warpgroup, warp-uniform as the compiler sees it
  const int wg = __shfl_sync(0xFFFFFFFFu, ct >> 7, 0);
  const int lane = ct & 31;
  const int g = lane >> 2, t = lane & 3;
  // this thread's rows in the slice: lr, lr + 8
  const int lr = wg * 64 + ((ct & 127) >> 5) * 16 + g;
  const int Q = a.Q;
  const int q0 = blockIdx.x * W_NQ;
  const bool cosine = a.cosine != 0;
  const int per = a.tile / bins;  // PACKED: row slices a tile
  int in_tile = 0;                // PACKED: the next slice epilogue's slice in its tile
  int due = -1;                   // PACKED: the first slice of a tile whose epilogue is due

  if constexpr (PACKED) {
    // the block's queries' quantization terms, staged once
    for (int n = ct; n < W_NQ; n += P_CONSUMERS) {
      const int qi = q0 + n;
      qterm[2 * n] = qi < Q ? a.mult[qi] : 0.f;
      qterm[2 * n + 1] = (qi < Q && !cosine) ? a.qn2[qi] : 0.f;
    }
    asm volatile("bar.sync 1, %0;\n" :: "n"(P_CONSUMERS) : "memory");
  }

  // acc[b][4j + 2h + e] (and sum, best) is row lr + 8h, query q0 + 8j + 2t
  // + e. The winning slices: in the group, 16 bits, two a register; PACKED,
  // in the tile, 4 bits, eight a register.
  constexpr int NA = W_NQ / 2;
  constexpr int NSLOT = PACKED ? NA / 8 : NA / 2;
  float acc[2][NA], best[NA], sum[NA];
  uint32_t fb[2][4][4], fs[2][4][4], slot[NSLOT];
#pragma unroll
  for (int i = 0; i < NA; ++i) {
    acc[0][i] = 0.f;
    acc[1][i] = 0.f;
    best[i] = -CUDART_INF_F;
    sum[i] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < NSLOT; ++i) slot[i] = 0xFFFFFFFFu;

  // Where a step lies: chunk c of slice sl, in stage st of ring phase ph.
  struct Pos {
    int c, sl, st;
    uint32_t ph;
  };
  auto next = [&](Pos p) {
    if (++p.c == nch) {
      p.c = 0;
      ++p.sl;
    }
    if (++p.st == W_STAGES) {
      p.st = 0;
      p.ph ^= 1;
    }
    return p;
  };

#ifdef EXACT_POOL_FEED_ONLY
  // the feed alone (chip_smoke.py times it): each stage waited for and
  // handed back, nothing read
  for (Pos p{0, 0, 0, 0}; p.sl < nsl; p = next(p)) {
    mbar_wait(full_s + 8 * p.st, p.ph);
    __syncwarp();
    mbar_arrive_lane0(empty_s + 8 * p.st, lane);
  }
#else
  // the fragment loads' byte offsets in a stage's x: unit u of row lr lies
  // at lr * 128 + (u ^ g) * 16 (lr & 7 is g), which is frag ^ (u << 4); row
  // lr + 8 lies 1,024 bytes on
  const uint32_t frag = lr * 128 + g * 16 + t * 4;

  // Step p into buffer B: wait for its stage, split the warp's fragments of
  // x (rows lr, lr + 8; features t, t + 4 of each k8), commit the chunk's
  // 12 MMAs against the stage's query planes (small terms first: the
  // chunk's first product overwrites the accumulator). The stage goes back
  // to the producer in finish.
  auto issue = [&](auto buf, Pos p) {
    constexpr int B = decltype(buf)::value;
    mbar_wait(full_s + 8 * p.st, p.ph);
    const unsigned char* stage =
        reinterpret_cast<const unsigned char*>(ring + p.st * W_STAGE);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const float* p0 = reinterpret_cast<const float*>(stage + (frag ^ (2 * ks << 4)));
      const float* p1 = reinterpret_cast<const float*>(stage + (frag ^ ((2 * ks + 1) << 4)));
      split_tf32_int(p0[0], fb[B][ks][0], fs[B][ks][0]);
      split_tf32_int(p0[256], fb[B][ks][1], fs[B][ks][1]);
      split_tf32_int(p1[0], fb[B][ks][2], fs[B][ks][2]);
      split_tf32_int(p1[256], fb[B][ks][3], fs[B][ks][3]);
    }
#pragma unroll
    for (int i = 0; i < NA; ++i) reg_fence(acc[B][i]);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    const uint32_t pb = ring_s + (uint32_t)(p.st * W_STAGE + W_X) * sizeof(float);
    const uint32_t ps = pb + W_PLANE * sizeof(float);
    auto desc = [&](uint32_t plane, int ks) {
      return smem_desc(plane + (uint32_t)ks * 256, 128, KC * 32);
    };
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) Wgmma<W_NQ>::run(acc[B], fs[B][ks], desc(pb, ks), ks != 0);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) Wgmma<W_NQ>::run(acc[B], fb[B][ks], desc(ps, ks), 1);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) Wgmma<W_NQ>::run(acc[B], fb[B][ks], desc(pb, ks), 1);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  };

  // PACKED, once the slice epilogue of a tile's last slice (or the block's)
  // has set `due` to the tile's first slice: B2's tile epilogue. Each (row,
  // query)'s best of the tile is compressed once into p = rint(v * mult) *
  // F + (the tile's first slice in the group + its slot), v = -sqrt(max(qn2
  // - best, 0)) (L2) or best (cosine), and merged into the packed plane by
  // max (the first tile overwrites it; a NaN never wins); the tile's best
  // starts afresh. The step loop runs it after each pair of steps and once
  // after the last, so the unrolled loop holds two copies, not one a step:
  // a slice takes kq/32 >= 2 steps in this form (its query planes did not
  // fit B2's pipelined form, so kq > 128), and the step after a slice's
  // last is the next slice's first chunk, which keeps no best.
  auto tile_epilogue = [&]() {
    const bool first_tile = due == 0;
    const int tile0 = due;
    due = -1;
#pragma unroll
    for (int j = 0; j < W_NQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = 8 * j + 2 * t + e;  // the query in the block
        const float m = qterm[2 * n], n2 = qterm[2 * n + 1];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 4 * j + 2 * h + e;
          const float b = best[i];
          const float v = cosine ? b : -sqrtf(fmaxf(n2 - b, 0.f));
          const int sv = tile0 + (int)((slot[i / 8] >> ((i % 8) * 4)) & 0xFu);
          const float pv = rintf(v * m) * a.slot_f + (float)sv;
          float* o = pk + i * P_CONSUMERS + ct;
          const float old = first_tile ? -CUDART_INF_F : *o;
          *o = pv > old ? pv : old;
          best[i] = -CUDART_INF_F;
        }
      }
  };

  // Step p's chunk in buffer B, its MMAs complete: into the slice's sum;
  // at the slice's last chunk keep (score, slice) on `>` (PACKED: and at a
  // tile's last slice the tile epilogue). Then its stage goes back to the
  // producer (its column terms were read last).
  auto finish = [&](auto buf, Pos p) {
    constexpr int B = decltype(buf)::value;
#pragma unroll
    for (int i = 0; i < NA; ++i) reg_fence(acc[B][i]);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        reg_fence(fb[B][ks][f]);
        reg_fence(fs[B][ks][f]);
      }
    if (p.c == 0) {
#pragma unroll
      for (int i = 0; i < NA; ++i) sum[i] = 0.f + acc[B][i];
    } else {
#pragma unroll
      for (int i = 0; i < NA; ++i) sum[i] += acc[B][i];
    }
    if (p.c == nch - 1) {
      // rows lr and lr + 8's column terms as one FFMA, score = sum * m + c:
      // L2 (1, -aux0), exact as sum - aux0; cosine (aux0, aux1); a row past
      // N (0, -inf), which never wins
      const float* cl = cols + p.st * 2 * ROWS;
      const long long r0 = first + (long long)p.sl * bins + lr;
      const bool ok0 = r0 < N, ok1 = r0 + 8 < N;
      float m0, c0, m1, c1;
      if (cosine) {
        m0 = ok0 ? cl[lr] : 0.f;
        m1 = ok1 ? cl[lr + 8] : 0.f;
        c0 = ok0 ? cl[ROWS + lr] : -CUDART_INF_F;
        c1 = ok1 ? cl[ROWS + lr + 8] : -CUDART_INF_F;
      } else {
        m0 = ok0 ? 1.f : 0.f;
        m1 = ok1 ? 1.f : 0.f;
        c0 = ok0 ? -cl[lr] : -CUDART_INF_F;
        c1 = ok1 ? -cl[lr + 8] : -CUDART_INF_F;
      }
      if constexpr (PACKED) {
        // the slice in its tile in every 4-bit field: one select of bits an
        // update, as the 16-bit slices take
        const uint32_t now = (uint32_t)in_tile * 0x11111111u;
#pragma unroll
        for (int j = 0; j < W_NQ / 8; ++j) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float m = h ? m1 : m0, cc = h ? c1 : c0;
            uint32_t sp = slot[(4 * j + 2 * h) / 8];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int i = 4 * j + 2 * h + e;
              const uint32_t field = 0xFu << ((i % 8) * 4);
              const float sc = fmaf(sum[i], m, cc);
              const bool up = sc > best[i];
              best[i] = up ? sc : best[i];
              sp = up ? (sp & ~field) | (now & field) : sp;
            }
            slot[(4 * j + 2 * h) / 8] = sp;
          }
        }
        if (in_tile == per - 1 || p.sl + 1 == nsl) due = p.sl - in_tile;
        if (++in_tile == per) in_tile = 0;
      } else {
        const uint32_t now = (uint32_t)p.sl;
#pragma unroll
        for (int j = 0; j < W_NQ / 8; ++j) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float m = h ? m1 : m0, cc = h ? c1 : c0;
            uint32_t sp = slot[2 * j + h];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int i = 4 * j + 2 * h + e;
              const float sc = fmaf(sum[i], m, cc);
              const bool up = sc > best[i];
              best[i] = up ? sc : best[i];
              sp = up ? (sp & ~(0xFFFFu << (16 * e))) | (now << (16 * e)) : sp;
            }
            slot[2 * j + h] = sp;
          }
        }
      }
    }
    __syncwarp();
    mbar_arrive_lane0(empty_s + 8 * p.st, lane);
  };

  // One MMA wait a chunk: step s's MMAs are committed before the wait for
  // step s - 1's (wgmma.wait_group 1), whose sums and epilogue then run
  // under them. Buffers alternate, even steps in 0, odd in 1.
  if (steps > 0) {
    Pos p{0, 0, 0, 0};  // the step in flight
    issue(Buf<0>{}, p);
    int s = 1;
    for (; s + 1 < steps; s += 2) {
      Pos p1 = next(p);
      issue(Buf<1>{}, p1);
      wgmma_wait<1>();
      finish(Buf<0>{}, p);
      p = next(p1);
      issue(Buf<0>{}, p);
      wgmma_wait<1>();
      finish(Buf<1>{}, p1);
      if constexpr (PACKED) {
        if (due >= 0) tile_epilogue();
      }
    }
    if (s < steps) {
      const Pos p1 = next(p);
      issue(Buf<1>{}, p1);
      wgmma_wait<1>();
      finish(Buf<0>{}, p);
      wgmma_wait<0>();
      finish(Buf<1>{}, p1);
    } else {
      wgmma_wait<0>();
      finish(Buf<0>{}, p);
    }
    if constexpr (PACKED) {
      if (due >= 0) tile_epilogue();
    }
  }
#endif

  // the planes out: a bin no row won (a column block past N) scores -inf,
  // id -1; PACKED, the packed plane (-inf where no tile ran)
  const long long col0 = (long long)grp * bins + b0;
#pragma unroll
  for (int j = 0; j < W_NQ / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qi = q0 + 8 * j + 2 * t + e;
        if (qi >= Q) continue;
        const int r = lr + 8 * h;
        const long long o = (long long)qi * a.W + col0 + r;
        const int i = 4 * j + 2 * h + e;
        if constexpr (PACKED) {
          a.out_s[o] = nsl == 0 ? -CUDART_INF_F : pk[i * P_CONSUMERS + ct];
        } else {
          const uint32_t sv = (slot[i / 2] >> (16 * e)) & 0xFFFFu;
          a.out_s[o] = best[i];
          a.out_i[o] = sv == NO_SLICE ? -1 : (int)(first + (long long)sv * bins + r);
        }
      }
}

// ------------------------------------------------------------ launching

// Lets the kernel take the device's opt-in maximum of shared memory, once
// per device (`ready`: one flag a device), so later launches make no other
// CUDA call.
int allow_max_smem(const void* kernel, bool* ready) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!ready[dev]) {
    int optin = 0;
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin);
    if (e != cudaSuccess) return (int)e;
    ready[dev] = true;
  }
  return (int)cudaSuccess;
}

template <int NQ>
int launch(const PoolArgs& a, cudaStream_t stream) {
  static bool ready[64];
  const int e = allow_max_smem((const void*)exact_pool_tc_kernel<NQ>, ready);
  if (e != (int)cudaSuccess) return e;
  const dim3 grid((a.Q + NQ - 1) / NQ, a.W / ROWS);
  exact_pool_tc_kernel<NQ><<<grid, THREADS, smem_bytes(NQ, a.kq), stream>>>(a);
  return (int)cudaGetLastError();
}

template <int NQW>
int launch_pipelined(const PoolArgs& a, const CUtensorMap& xmap, cudaStream_t stream) {
  static bool ready[64];
  const int e = allow_max_smem((const void*)exact_pool_pipelined_kernel<NQW>, ready);
  if (e != (int)cudaSuccess) return e;
  const dim3 grid((a.Q + 2 * NQW - 1) / (2 * NQW), a.W / P_ROWS);
  exact_pool_pipelined_kernel<NQW>
      <<<grid, P_THREADS, pipe_smem_bytes(NQW, a.kq), stream>>>(a, xmap);
  return (int)cudaGetLastError();
}

template <bool PACKED>
int launch_wide(const PoolArgs& a, const CUtensorMap& xmap, cudaStream_t stream) {
  static bool ready[64];
  const int e = allow_max_smem((const void*)exact_pool_wide_kernel<PACKED>, ready);
  if (e != (int)cudaSuccess) return e;
  const long long total = wide_plane_floats(a.Q, a.kq) / 2;
  const long long blocks = (total + 255) / 256;
  exact_pool_query_planes_kernel<<<(int)(blocks < 8192 ? blocks : 8192), 256, 0, stream>>>(a);
  const cudaError_t pe = cudaGetLastError();
  if (pe != cudaSuccess) return (int)pe;
  const dim3 grid((a.Q + W_NQ - 1) / W_NQ, a.W / ROWS);
  exact_pool_wide_kernel<PACKED>
      <<<grid, P_THREADS, wide_smem_bytes(PACKED), stream>>>(a, xmap);
  return (int)cudaGetLastError();
}

// cuTensorMapEncodeTiled through the runtime (libcuda is not linked)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult got = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &got);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                  cudaEnableDefault, &got);
#endif
    return e == cudaSuccess && got == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// x as a tensor map [N rows, dl features] with row stride D, boxes of
// `rows` rows x 32 features, 128-byte swizzled, zeros outside; false where
// the encode fails (dispatch has checked that the row stride and x's
// address are multiples of 16 bytes, as TMA needs).
bool x_tensor_map(CUtensorMap* map, const PoolArgs& a, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)a.dl, (cuuint64_t)a.N};
  const cuuint64_t strides[1] = {(cuuint64_t)a.D * sizeof(float)};
  const cuuint32_t box[2] = {KC, (cuuint32_t)rows};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(a.x),
                dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The form of a launch (exact_pool_plan's result): B1's narrow kernel
// (resident query planes) or its wide form, B2's pipelined form, or B2's
// wide form (B1's wide mainloop with B2's tile epilogue).
enum Form { FORM_NONE = 0, FORM_PIPELINED = 1, FORM_WIDE = 2, FORM_RESIDENT = 3 };

struct Plan {
  int form;           // Form
  int nq;             // queries a block
  long long scratch;  // floats of the query planes' scratch (B1's and B2's wide forms)
};

// The form a launch takes at Q queries, row stride D, dl live features and
// W pool columns. B1: rows of up to 128 live features the narrow kernel at
// the power of two up to 128 that Q needs, wider rows the wide form. B2:
// its pipelined form where its planes fit at 16 queries a warpgroup or
// more, else its wide form (FORM_WIDE). FORM_NONE where no form launches: a
// row stride that is no multiple of 4 floats, dl outside 1 .. D, or more
// column blocks than the grid's 65,535.
Plan plan(int Q, int D, int dl, int W, bool packed) {
  const Plan none{FORM_NONE, 0, 0};
  if (D % 4 != 0 || dl < 1 || dl > D) return none;
  const int kq = (dl + KC - 1) / KC * KC;
  int want = 8;
  while (want < 128 && want < Q) want *= 2;
  Plan p;
  int rows = ROWS;  // pool columns a block
  if (packed) {
    int nqw = want / 2 < 8 ? 8 : want / 2;
    const int least = nqw < 16 ? nqw : 16;
    while (nqw > least && pipe_smem_bytes(nqw, kq) > SMEM_MAX) nqw /= 2;
    if (pipe_smem_bytes(nqw, kq) > SMEM_MAX) {
      p = {FORM_WIDE, W_NQ, wide_plane_floats(Q, kq)};
    } else {
      p = {FORM_PIPELINED, 2 * nqw, 0};
      rows = P_ROWS;
    }
  } else if (kq <= 128) {
    p = {FORM_RESIDENT, want, 0};
  } else {
    p = {FORM_PIPELINED, W_NQ, wide_plane_floats(Q, kq)};
  }
  return W / rows > 65535 ? none : p;
}

// Launches the form plan() picks.
int dispatch(PoolArgs a, bool packed, void* stream) {
  if (a.Q <= 0 || a.W <= 0) return (int)cudaSuccess;
  const Plan p = plan(a.Q, a.D, a.dl, a.W, packed);
  if (p.form == FORM_NONE || (long long)a.fold * (a.tile / a.bins) >= NO_SLICE ||
      (packed && a.tile / a.bins > 16) ||
      (reinterpret_cast<uintptr_t>(a.x) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  a.kq = (a.dl + KC - 1) / KC * KC;
  auto s = (cudaStream_t)stream;
  if (p.form == FORM_RESIDENT) {
    switch (p.nq) {
      case 128: return launch<128>(a, s);
      case 64: return launch<64>(a, s);
      case 32: return launch<32>(a, s);
      case 16: return launch<16>(a, s);
      case 8: return launch<8>(a, s);
    }
    return (int)cudaErrorInvalidValue;
  }
  // B1's wide mainloop: B1's wide form, or B2's (FORM_WIDE)
  const bool wide = !packed || p.form == FORM_WIDE;
  CUtensorMap xmap;
  if (!x_tensor_map(&xmap, a, wide ? ROWS : P_ROWS)) return (int)cudaErrorInvalidValue;
  if (wide) {
    if (a.qp == nullptr || a.qp_floats < p.scratch) return (int)cudaErrorInvalidValue;
    return packed ? launch_wide<true>(a, xmap, s) : launch_wide<false>(a, xmap, s);
  }
  switch (p.nq / 2) {
    case 64: return launch_pipelined<64>(a, xmap, s);
    case 32: return launch_pipelined<32>(a, xmap, s);
    case 16: return launch_pipelined<16>(a, xmap, s);
    case 8: return launch_pipelined<8>(a, xmap, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The form (enum Form) a launch of the two-plane pool (packed 0) or of the
// packed pool (packed 1) takes at Q queries, row stride D, d_live live
// features and W pool columns, the queries a block in *tile and the floats
// of query-plane scratch the launch needs in *scratch (0 but for the wide
// forms). The wrappers ask it before they allocate and launch.
extern "C" int exact_pool_plan(int Q, int D, int d_live, int W, int packed,
                               int* tile, long long* scratch) {
  const Plan p = plan(Q, D, d_live, W, packed != 0);
  *tile = p.nq;
  *scratch = p.scratch;
  return p.form;
}

// Both launch on the caller's stream and return cudaGetLastError() (0 =
// launched; nothing is launched for no query or no column), or
// cudaErrorInvalidValue where exact_pool_plan finds no form, for 65,535 or
// more row slices per group, for x off a 16-byte boundary or a tensor map
// that fails, or for a wide launch whose query planes' scratch (qplanes,
// qplane_floats floats; unused by other forms) is smaller than
// exact_pool_plan's. The other checks are the Python wrappers'
// (vectorsearch_torch/ops/exact.py).
extern "C" int exact_pool_launch(const float* q, const float* x,
                                 const float* aux0, const float* aux1,
                                 float* out_s, int* out_i, int Q, int N, int D,
                                 int d_live, int tile, int bins, int fold, int W,
                                 int cosine, float* qplanes, long long qplane_floats,
                                 void* stream) {
  const PoolArgs a{q, x, aux0, aux1, nullptr, nullptr, out_s, out_i, Q, N, D,
                   d_live, 0, tile, bins, fold, W, cosine, 0.f, qplanes,
                   qplane_floats};
  return dispatch(a, false, stream);
}

extern "C" int exact_pool_packed_launch(const float* q, const float* x,
                                        const float* aux0, const float* aux1,
                                        const float* mult, const float* qn2,
                                        float* out, int Q, int N, int D,
                                        int d_live, int tile, int bins,
                                        int fold, int W, int cosine,
                                        float slot_f, float* qplanes,
                                        long long qplane_floats, void* stream) {
  const PoolArgs a{q, x, aux0, aux1, mult, qn2, out, nullptr, Q, N, D,
                   d_live, 0, tile, bins, fold, W, cosine, slot_f, qplanes,
                   qplane_floats};
  return dispatch(a, true, stream);
}
