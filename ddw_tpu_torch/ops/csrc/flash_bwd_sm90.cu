// Flash attention backward for Hopper (K4 dQ and K5 dK/dV, the sm90 variant):
// TMA-fed, warp-specialised, every product on wgmma.
//
// Replaces ddw_tpu/ops/flash_attention.py `_partitioned_bwd` (:397): K4 its
// `_dq_kernel` (:307, pallas_call :425), K5 its `_dkv_kernel` (:350,
// pallas_call :445), on the main path's shapes: bf16 at head dim 64 or 128.
// Head dim 32 stays on the mma.sync kernels of flash_attention.cu and f32 on
// its CUDA-core kernels; the choice is made in Python (`_bwd_variant` in
// ops/flash_attention.py).
//
// What they compute is the TPU kernels' function, pair by (query, key) pair
// (the K4/K5 section of flash_attention.cu spells it out): s = (q . k) *
// sm_scale in f32, masked (causal by global position q_offset / k_offset,
// keys at or past k_valid); p = exp(s - lse), zero where s was masked
// (`_guarded_exp`); dp = do . v; ds = p * (dp - delta); dq = sm_scale * sum_k
// round(ds) k, dk = sm_scale * sum_q round(ds) q, dv = sum_q round(p) do,
// where round() is the rounding to bf16 where the value becomes a product's
// operand and sm_scale multiplies the f32 sums at the end. delta = rowsum(do
// * out) - g_lse comes from the caller. The backward has no running max, so
// the tiles set only how the f32 partial sums are grouped. Any Sq, Sk >= 1:
// keys past Sk and query rows past Sq are masked by index (never by TMA's
// zero fill: a zero lse would turn a padded row's p into exp(s)), and rows
// past Sq read lse = +inf, so their p is exactly 0. A row that sees no key
// gets dq = 0 and gives no share of dk or dv. Tiles that are wholly masked
// are never loaded. Each output tile is summed by one CTA in a fixed order,
// with no atomics, so two launches give the same bits; that is why dQ and
// dK/dV stay two kernels (3 + 4 products) and not FlashAttention-3's single
// pass (5 products, dQ added with float atomics).
//
// What bounds them: operations. At the LM's training shape [256, 2048, 64]
// bf16 causal, K4 does 3 products of 2 * D FLOP over the 256 * 2048 * 2049
// / 2 visible pairs, 2.06e11 FLOP (0.209 ms at the 989 TFLOP/s dense bf16
// peak), K5 4, 2.75e11 (0.278 ms), against 0.34 and 0.40 GB of traffic
// (0.10 and 0.12 ms at 3.35 TB/s). The mma.sync kernels they replace ran at
// 110-114 TFLOP/s: synchronous staging copies between two __syncthreads on
// every tile, mma.sync, 64 x 64 tiles of 4 warps, no pipelining, one CTA
// per tile.
//
// Design, and what each step does about that (K3's, flash_fwd_sm90.cu):
// - TMA. 3-D tensor maps over [BH, S, D] load 128-byte swizzled boxes of 64
//   columns; a tile past S reads zeros from the map's bounds, never the next
//   head's rows. Encoded on the host through cudaGetDriverEntryPoint (no
//   -lcuda), passed as __grid_constant__.
// - Warp specialisation. Warpgroup 0 produces: its thread 0 issues every TMA
//   load, through mbarrier rings of stages (transaction counts; "empty"
//   barriers the consumer warps arrive at); in K5 its warp 1 also copies each
//   query block's lse (times log2 e, +inf past Sq) and delta (0 past Sq)
//   into the stage. setmaxnreg gives its registers to the two consumer
//   warpgroups (24 against 240 a thread), which own 64 rows each of a
//   128-row tile. Producer and consumers get a tile's blocks from the same
//   function, so offsets or a ragged edge cannot leave one side waiting;
//   every mbarrier wait traps after 10 s instead of hanging.
// - K4 owns query tiles: it loads a tile's Q and dO once and streams the
//   visible K and V blocks (BN = 128 keys at D = 64, 64 at D = 128, where
//   S, dP and dQ would not fit 240 registers a thread at 128). S = Q . K^T
//   and dP = dO . V^T are wgmma with both operands from the swizzled tiles;
//   P and dS = P * (dP - delta) in registers; dQ += round(dS) . K is a
//   wgmma with A from registers (the accumulator layout is the A fragment,
//   FlashAttention-3's identity) and B the same K tile read MN-major with
//   the descriptor's transpose bit.
// - K5 owns key tiles (FlashAttention-3's layout): it loads a tile's K and V
//   once and streams Q, dO, lse and delta of the visible query blocks (BQ =
//   64), from the first block at or after the diagonal. S^T = K . Q^T and
//   dP^T = V . dO^T from shared memory; P^T = exp(S^T - lse) with lse along
//   the columns; dV += round(P^T) . dO and dK += round(dS^T) . Q with A from
//   registers, dO and Q read MN-major.
// - Persistent CTAs, one per SM, walk the tiles in groups of 8 heads, the
//   heaviest causal tiles first (K4: the last query tiles; K5: the first key
//   tiles); a group's streamed operands stay in L2 for all its tiles. The
//   producer loads the next tile while the consumers write this one.
// - Each consumer warpgroup runs its blocks in series (the products, then
//   the elementwise step, then the accumulating products): K3's measurements
//   found the overlapped schedules no faster, and this one keeps wgmma out of
//   data-dependent branches (ptxas serialises it there). Masks run only on
//   blocks where this warp's rows can meet one.
// The C entries return cudaGetLastError() after the launch, or 1000 plus the
// CUresult when a tensor map cannot be encoded.

#include <cuda.h>  // CUtensorMap and its enums: types only, nothing linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;       // rows a CTA owns: queries (K4), keys (K5)
constexpr int BQ = 64;        // queries per streamed block of K5
constexpr int THREADS = 384;  // warpgroup 0 the producer, 1 and 2 the consumers
constexpr int kGroupHeads = 8;  // heads per group of the tile order
constexpr int CHUNK = 64;     // bf16 columns of a 128-byte swizzled box row
constexpr int ROWB = 128;     // bytes of a box row
constexpr int kEncodeError = 1000;
constexpr uint64_t kWaitBoundNs = 10000000000ull;  // 10 s: see mbar_wait
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers and TMA (as in flash_fwd_sm90.cu) ----------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ uint32_t mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done;
}

// Wait until the phase of parity `parity` has completed. Producer and
// consumers agree on every count, so a wait that lasts kWaitBoundNs is a
// fault: it traps (the launch fails with a CUDA error) instead of hanging.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  uint64_t t0, now;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t0));
  while (!mbar_try_wait(bar, parity)) {
    asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(now));
    if (now - t0 > kWaitBoundNs) __trap();
  }
}

// One box of `map` at (c0 column, c1 row, c2 batch*head) into shared memory,
// completing `bar`'s transaction count.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// The CHUNK-column boxes of a [rows][D] tile at row `row` of head `bh`.
template <int D>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int rows, int row, int bh) {
#pragma unroll
  for (int c = 0; c < D / CHUNK; ++c)
    tma_load_3d(dst + c * rows * ROWB, map, bar, c * CHUNK, row, bh);
}

// ---- wgmma ----------------------------------------------------------------------

// A shared-memory matrix descriptor over a 128-byte-swizzled tile: start
// address, leading and stride byte offsets (16-byte units), layout 1 = 128B.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Registers an asynchronous wgmma reads or writes: keep the compiler from
// moving their uses across the wait.
template <int R>
__device__ __forceinline__ void fence_regs(float (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
}

// D[64 x 64] (+)= A[64 x 16] . B[16 x 64], A and B in shared memory (descriptors,
// K-major); scale_d = 0 starts the sum.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                            int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 128] (+)= A[64 x 16] . B[16 x 128], A and B in shared memory (descriptors,
// K-major); scale_d = 0 starts the sum.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                            int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 64] += A[64 x 16] . B[16 x 64], A in registers (bf16 pairs), B in shared
// memory, MN-major (the transpose bit set).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// D[64 x 128] += A[64 x 16] . B[16 x 128], A in registers (bf16 pairs), B in shared
// memory, MN-major (the transpose bit set).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db,
                                         int scale_d) {
  if constexpr (N == 64) {
    wgmma_ss_n64(d, da, db, scale_d);
  } else {
    wgmma_ss_n128(d, da, db, scale_d);
  }
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (N == 64) {
    wgmma_rs_n64(d, a, db);
  } else {
    wgmma_rs_n128(d, a, db);
  }
}

// acc[64 x N] = A[64 x D] . B[N x D]^T, issued and committed, not waited for.
// Both are K-major swizzled tiles: A 64 rows of a tile of A_ROWS rows (its
// 64-column chunks A_ROWS rows apart), B a tile of N rows.
template <int D, int N, int A_ROWS>
__device__ __forceinline__ void issue_abt(float (&acc)[N / 2], uint32_t a, uint32_t b) {
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const int c = ks / 4, kc = ks % 4;  // 64-column chunk, k16 slice in it
    wgmma_ss<N>(acc, smem_desc(a + c * A_ROWS * ROWB + kc * 32, 16, 1024),
                smem_desc(b + c * N * ROWB + kc * 32, 16, 1024), ks > 0);
  }
  wgmma_commit();
}

// acc[64 x D] += X[64 x K] . B[K x D], issued and committed, not waited for.
// X is bf16 A fragments (pack_a); B a [K rows][D] swizzled tile read
// MN-major: 8-row groups 1024 bytes apart, 64-column chunks K rows apart.
template <int D, int K>
__device__ __forceinline__ void issue_xb(float (&acc)[D / 2], const uint32_t (&xa)[K / 16][4],
                                         uint32_t b) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
    wgmma_rs<D>(acc, xa[kk], smem_desc(b + kk * 16 * ROWB, K * ROWB, 1024));
  wgmma_commit();
}

// 2^x on the special-function unit (subnormal results flush to zero)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two floats rounded to bf16 (nearest even), the lower column in the low half
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// An f32 accumulator [64 x N] rounded to bf16 as the A operand of the k16
// slices: columns 16 kk .. 16 kk + 15 are the 8-column groups 2 kk, 2 kk + 1.
template <int N>
__device__ __forceinline__ void pack_a(uint32_t (&xa)[N / 16][4], const float (&x)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    xa[kk][0] = pack_bf16x2(x[8 * kk + 0], x[8 * kk + 1]);
    xa[kk][1] = pack_bf16x2(x[8 * kk + 2], x[8 * kk + 3]);
    xa[kk][2] = pack_bf16x2(x[8 * kk + 4], x[8 * kk + 5]);
    xa[kk][3] = pack_bf16x2(x[8 * kk + 6], x[8 * kk + 7]);
  }
}

template <int R>
__device__ __forceinline__ void zero(float (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) r[i] = 0.f;
}

// ---- which blocks a tile sees (producer and consumers both call these) -----

// K4: the key blocks [0, n) of BN keys that a query tile whose last global
// position is q_last sees.
template <int BN>
__device__ __forceinline__ int key_blocks(int sk, int causal, int q_last, int k_offset,
                                          int k_valid) {
  int n = (sk + BN - 1) / BN;
  if (causal) {
    const int span = q_last - k_offset;
    n = span < 0 ? 0 : min(n, span / BN + 1);
  }
  if (k_valid >= 0) {
    const int kv = k_valid - k_offset;
    n = kv <= 0 ? 0 : min(n, (kv + BN - 1) / BN);
  }
  return n;
}

// K5: the query blocks [first, first + n) of BQ queries that a key tile
// whose first global position is k_first sees: from the first block whose
// last row reaches the tile (causal) to the end; none at or past k_valid.
__device__ __forceinline__ void query_blocks(int sq, int causal, int k_first, int q_offset,
                                             int k_valid, int& first, int& n) {
  const int end = (sq + BQ - 1) / BQ;
  first = 0;
  n = end;
  if ((k_valid >= 0 && k_first >= k_valid) || (causal && q_offset + sq - 1 < k_first)) {
    n = 0;
    return;
  }
  if (causal) {
    const int need = k_first - q_offset - (BQ - 1);
    first = need <= 0 ? 0 : (need + BQ - 1) / BQ;
    n = end - first;
  }
}

// ---- the elementwise steps ---------------------------------------------------

// K4, one key block in registers: sc holds q . k and dp holds do . v on
// entry; dp holds ds = p * (dp - delta) on exit, p = 2^(s sm_scale log2 e -
// lse log2 e), 0 where masked. Thread rows qpos0 and qpos0 + 8 (global),
// columns k_local + 8 j + 2 t (+1) of the block (local key index).
template <bool kMask, int BN>
__device__ __forceinline__ void dq_step(const float (&sc)[BN / 2], float (&dp)[BN / 2],
                                        const float (&lse_l2)[2], const float (&dl)[2],
                                        float scale_l2, int qpos0, int k_local, int t,
                                        int sk, int causal, int k_offset, int k_valid) {
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1, i = 4 * j + e;
      float p = ex2(fmaf(sc[i], scale_l2, -lse_l2[h]));
      if (kMask) {
        const int kl = k_local + 8 * j + 2 * t + (e & 1), kpos = k_offset + kl;
        const bool keep = kl < sk && (!causal || kpos <= qpos0 + 8 * h) &&
                          (k_valid < 0 || kpos < k_valid);
        if (!keep) p = 0.f;
      }
      dp[i] = p * (dp[i] - dl[h]);
    }
}

// K5, one query block in registers: the transposed products, rows this
// thread's keys (kl0, kl0 + 8 local), columns the block's queries q_local +
// 8 j + 2 t (+1). sc holds k . q on entry and p on exit, dp holds v . do on
// entry and ds on exit. L and Dl are the block's lse log2 e and delta.
template <bool kMask>
__device__ __forceinline__ void dkv_step(float (&sc)[BQ / 2], float (&dp)[BQ / 2],
                                         const float* L, const float* Dl, float scale_l2,
                                         int kl0, int q_local, int t, int sq, int sk,
                                         int causal, int q_offset, int k_offset,
                                         int k_valid) {
#pragma unroll
  for (int j = 0; j < BQ / 8; ++j) {
    const int c = 8 * j + 2 * t;
    const float2 l2 = *reinterpret_cast<const float2*>(L + c);
    const float2 d2 = *reinterpret_cast<const float2*>(Dl + c);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1, i = 4 * j + e;
      const float lse_l2 = (e & 1) ? l2.y : l2.x, delta = (e & 1) ? d2.y : d2.x;
      float p = ex2(fmaf(sc[i], scale_l2, -lse_l2));
      if (kMask) {
        const int ql = q_local + c + (e & 1), kl = kl0 + 8 * h, kpos = k_offset + kl;
        const bool keep = ql < sq && kl < sk && (!causal || kpos <= q_offset + ql) &&
                          (k_valid < 0 || kpos < k_valid);
        if (!keep) p = 0.f;
      }
      sc[i] = p;
      dp[i] = p * (dp[i] - delta);
    }
  }
}

// ---- K4: dQ --------------------------------------------------------------------

template <int D>
struct DqCfg {
  static constexpr int BN = D <= 64 ? 128 : 64;  // keys per streamed block
  static constexpr int kStages = 3;
  static constexpr int kQBytes = BM * D * 2;   // the Q or the dO tile
  static constexpr int kKVBytes = BN * D * 2;  // one K or one V block
  static constexpr int kBarOffset = 2 * kQBytes + 2 * kStages * kKVBytes;
  // q_full, q_empty, then k_full, v_full and empty per stage; 1024 bytes of
  // slack to align the tiles to the 128-byte swizzle's 1024-byte atom
  static constexpr int kSmem = kBarOffset + 8 * (2 + 3 * kStages) + 1024;
};

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tdo,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dq, int sq, int sk, int causal,
                         int q_offset, int k_offset, float sm_scale, int k_valid,
                         int n_bh) {
  using C = DqCfg<D>;
  constexpr int S = C::kStages, BN = C::BN;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base, sO = base + C::kQBytes;  // [chunk][BM rows][64]
  const uint32_t sK = sO + C::kQBytes;               // [stage][chunk][BN keys][64]
  const uint32_t sV = sK + S * C::kKVBytes;
  const uint32_t q_full = base + C::kBarOffset, q_empty = q_full + 8;
  const uint32_t k_full = q_empty + 8, v_full = k_full + 8 * S, empty = v_full + 8 * S;

  // The CTA walks tiles blockIdx.x, + gridDim.x, ... in groups of
  // kGroupHeads heads, and in a group the heaviest causal tiles (the last
  // query tiles) first.
  const int n_qt = (sq + BM - 1) / BM, n_tiles = n_bh * n_qt;
  const int group = min(kGroupHeads, n_bh);
  auto tile_at = [&](int t, int& bh, int& q0, int& n_kb) {
    const int g0 = t / (group * n_qt) * group;  // the group's first head
    const int gn = min(group, n_bh - g0);       // heads in the group
    const int r = t - g0 * n_qt;
    bh = g0 + r % gn;
    q0 = (n_qt - 1 - r / gn) * BM;
    n_kb = key_blocks<BN>(sk, causal, q_offset + min(q0 + BM, sq) - 1, k_offset, k_valid);
  };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, 8);  // one arrival per consumer warp
    for (int s = 0; s < S; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- the producer warpgroup: one thread issues every load ---------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      int it = 0, nq = 0;  // K/V blocks and Q tiles loaded so far
      for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        int bh, q0, n_kb;
        tile_at(t, bh, q0, n_kb);
        if (n_kb == 0) continue;  // a tile that sees no key loads nothing
        mbar_wait(q_empty, (nq++ & 1) ^ 1);  // the consumers are done with Q, dO
        mbar_expect_tx(q_full, 2 * C::kQBytes);
        tma_tile<D>(sQ, &tq, q_full, BM, q0, bh);
        tma_tile<D>(sO, &tdo, q_full, BM, q0, bh);
        for (int i = 0; i < n_kb; ++i, ++it) {
          const int s = it % S;
          mbar_wait(empty + 8 * s, ((it / S) & 1) ^ 1);  // the first round passes
          mbar_expect_tx(k_full + 8 * s, C::kKVBytes);
          tma_tile<D>(sK + s * C::kKVBytes, &tk, k_full + 8 * s, BN, i * BN, bh);
          mbar_expect_tx(v_full + 8 * s, C::kKVBytes);
          tma_tile<D>(sV + s * C::kKVBytes, &tv, v_full + 8 * s, BN, i * BN, bh);
        }
      }
    }
  } else {
    // ---- two consumer warpgroups, 64 query rows each --------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int cw = threadIdx.x / 128 - 1;
    const int warp = threadIdx.x % 128 / 32, lane = threadIdx.x % 32, t4 = lane % 4;
    const uint32_t qa = sQ + cw * 64 * ROWB, oa = sO + cw * 64 * ROWB;
    const float scale_l2 = sm_scale * kLog2e;
    auto release = [&](uint32_t bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };
    float sc[BN / 2], dp[BN / 2];
    zero(sc);
    zero(dp);
    uint32_t da[BN / 16][4];

    int it = 0, nq = 0;  // K/V blocks and Q tiles consumed so far
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      int bh, q0, n_kb;
      tile_at(t, bh, q0, n_kb);
      const int row0 = q0 + cw * 64 + warp * 16 + lane / 4;  // rows row0, row0 + 8
      const int qpos0 = q_offset + row0;
      const int wq_first = q_offset + q0 + cw * 64 + warp * 16;  // the warp's first row
      float acc[D / 2];
      zero(acc);
      float lse_l2[2], dl[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row0 + 8 * h;
        const size_t row = (size_t)bh * sq + r;
        lse_l2[h] = r < sq ? lse[row] * kLog2e : INFINITY;  // rows past Sq: p = 0
        dl[h] = r < sq ? delta[row] : 0.f;
      }
      if (n_kb > 0) mbar_wait(q_full, nq & 1);
      // Both warpgroups run all n_kb blocks of the tile; a block in one's
      // causal future is an exact no-op for it.
      for (int i = 0; i < n_kb; ++i, ++it) {
        const int s = it % S;
        const uint32_t phase = (it / S) & 1;
        const uint32_t kb = sK + s * C::kKVBytes;
        mbar_wait(k_full + 8 * s, phase);
        issue_abt<D, BN, BM>(sc, qa, kb);
        mbar_wait(v_full + 8 * s, phase);
        issue_abt<D, BN, BM>(dp, oa, sV + s * C::kKVBytes);
        wgmma_wait_all();
        fence_regs(sc);
        fence_regs(dp);
        const int k_local = i * BN, k_last = k_offset + k_local + BN - 1;
        if ((causal && k_last > wq_first) || (k_valid >= 0 && k_last >= k_valid) ||
            k_local + BN > sk)
          dq_step<true, BN>(sc, dp, lse_l2, dl, scale_l2, qpos0, k_local, t4, sk, causal,
                            k_offset, k_valid);
        else
          dq_step<false, BN>(sc, dp, lse_l2, dl, scale_l2, qpos0, k_local, t4, sk, causal,
                             k_offset, k_valid);
        pack_a<BN>(da, dp);
        issue_xb<D, BN>(acc, da, kb);  // dq += round(ds) . k
        wgmma_wait_all();
        fence_regs(acc);
        fence_regs(da);
        release(empty + 8 * s);
      }
      if (n_kb > 0) {
        release(q_empty);  // no wgmma reads Q or dO any more
        ++nq;
      }

#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row0 + 8 * h;
        if (r >= sq) continue;
        const size_t row = (size_t)bh * sq + r;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<uint32_t*>(dq + row * D + j * 8 + 2 * t4) =
              pack_bf16x2(acc[4 * j + 2 * h] * sm_scale, acc[4 * j + 2 * h + 1] * sm_scale);
      }
    }
  }
}

// ---- K5: dK and dV ---------------------------------------------------------------

template <int D>
struct DkvCfg {
  static constexpr int kStages = D <= 64 ? 4 : 3;
  static constexpr int kKBytes = BM * D * 2;  // the K or the V tile
  static constexpr int kQBytes = BQ * D * 2;  // one Q or one dO block
  static constexpr int kLOffset = 2 * kKBytes + 2 * kStages * kQBytes;
  static constexpr int kBarOffset = kLOffset + kStages * 2 * BQ * 4;  // lse, delta
  // kv_full, kv_empty, then q_full, o_full and empty per stage; 1024 bytes
  // of alignment slack
  static constexpr int kSmem = kBarOffset + 8 * (2 + 3 * kStages) + 1024;
};

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkv_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                          int sq, int sk, int causal, int q_offset, int k_offset,
                          float sm_scale, int k_valid, int n_bh) {
  using C = DkvCfg<D>;
  constexpr int S = C::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sK = base, sV = base + C::kKBytes;  // [chunk][BM keys][64]
  const uint32_t sQ = sV + C::kKBytes;               // [stage][chunk][BQ rows][64]
  const uint32_t sO = sQ + S * C::kQBytes;
  float* const sL = reinterpret_cast<float*>(smem_raw + (base - raw) + C::kLOffset);
  const uint32_t kv_full = base + C::kBarOffset, kv_empty = kv_full + 8;
  const uint32_t q_full = kv_empty + 8, o_full = q_full + 8 * S, empty = o_full + 8 * S;

  // The CTA walks tiles blockIdx.x, + gridDim.x, ... in groups of
  // kGroupHeads heads, and in a group the heaviest causal tiles (the first
  // key tiles) first.
  const int n_kt = (sk + BM - 1) / BM, n_tiles = n_bh * n_kt;
  const int group = min(kGroupHeads, n_bh);
  auto tile_at = [&](int t, int& bh, int& k0, int& qb0, int& n_qb) {
    const int g0 = t / (group * n_kt) * group;
    const int gn = min(group, n_bh - g0);
    const int r = t - g0 * n_kt;
    bh = g0 + r % gn;
    k0 = r / gn * BM;
    query_blocks(sq, causal, k_offset + k0, q_offset, k_valid, qb0, n_qb);
  };

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    mbar_init(kv_empty, 8);  // one arrival per consumer warp
    for (int s = 0; s < S; ++s) {
      mbar_init(q_full + 8 * s, 1);
      mbar_init(o_full + 8 * s, 1 + 32);  // the TMA thread and warp 1's lanes
      mbar_init(empty + 8 * s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- the producer warpgroup: thread 0 issues every TMA load; warp 1
    // copies each query block's lse and delta into its stage --------------------
    // The split must fit the 168 x 384 registers the launch holds (24 x 128
    // + 240 x 256 does exactly), or setmaxnreg.inc waits forever. At 24,
    // warp 1's loop spills 4 bytes (ptxas); 40 / 232 spills the D = 128
    // consumers instead.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    const int lane = threadIdx.x % 32;
    if (threadIdx.x == 0) {
      int it = 0, nkv = 0;  // query blocks and K/V tiles loaded so far
      for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        int bh, k0, qb0, n_qb;
        tile_at(t, bh, k0, qb0, n_qb);
        if (n_qb == 0) continue;  // a tile no query sees loads nothing
        mbar_wait(kv_empty, (nkv++ & 1) ^ 1);  // the consumers are done with K, V
        mbar_expect_tx(kv_full, 2 * C::kKBytes);
        tma_tile<D>(sK, &tk, kv_full, BM, k0, bh);
        tma_tile<D>(sV, &tv, kv_full, BM, k0, bh);
        for (int j = 0; j < n_qb; ++j, ++it) {
          const int s = it % S, row = (qb0 + j) * BQ;
          mbar_wait(empty + 8 * s, ((it / S) & 1) ^ 1);  // the first round passes
          mbar_expect_tx(q_full + 8 * s, C::kQBytes);
          tma_tile<D>(sQ + s * C::kQBytes, &tq, q_full + 8 * s, BQ, row, bh);
          mbar_expect_tx(o_full + 8 * s, C::kQBytes);
          tma_tile<D>(sO + s * C::kQBytes, &tdo, o_full + 8 * s, BQ, row, bh);
        }
      }
    } else if (threadIdx.x / 32 == 1) {
      int it = 0;
      for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        int bh, k0, qb0, n_qb;
        tile_at(t, bh, k0, qb0, n_qb);
        for (int j = 0; j < n_qb; ++j, ++it) {
          const int s = it % S;
          mbar_wait(empty + 8 * s, ((it / S) & 1) ^ 1);
          float* L = sL + s * 2 * BQ;
          for (int c = lane; c < BQ; c += 32) {
            const int r = (qb0 + j) * BQ + c;
            const size_t row = (size_t)bh * sq + r;
            L[c] = r < sq ? lse[row] * kLog2e : INFINITY;  // rows past Sq: p = 0
            L[BQ + c] = r < sq ? delta[row] : 0.f;
          }
          mbar_arrive(o_full + 8 * s);  // release: the stores above are seen
        }
      }
    }
  } else {
    // ---- two consumer warpgroups, 64 keys each ----------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int cw = threadIdx.x / 128 - 1;
    const int warp = threadIdx.x % 128 / 32, lane = threadIdx.x % 32, t4 = lane % 4;
    const uint32_t ka = sK + cw * 64 * ROWB, va = sV + cw * 64 * ROWB;
    const float scale_l2 = sm_scale * kLog2e;
    auto release = [&](uint32_t bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };
    float sc[BQ / 2], dp[BQ / 2];
    zero(sc);
    zero(dp);
    uint32_t pa[BQ / 16][4], da[BQ / 16][4];

    int it = 0, nkv = 0;  // query blocks and K/V tiles consumed so far
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      int bh, k0, qb0, n_qb;
      tile_at(t, bh, k0, qb0, n_qb);
      const int wk0 = k0 + cw * 64 + warp * 16;   // the warp's first key (local)
      const int kl0 = wk0 + lane / 4;             // keys kl0, kl0 + 8
      const int wk_last = k_offset + wk0 + 15;    // the warp's last key (global)
      const bool key_edge = (k_valid >= 0 && wk_last >= k_valid) || wk0 + 16 > sk;
      float dka[D / 2], dva[D / 2];
      zero(dka);
      zero(dva);
      if (n_qb > 0) mbar_wait(kv_full, nkv & 1);
      for (int j = 0; j < n_qb; ++j, ++it) {
        const int s = it % S;
        const uint32_t phase = (it / S) & 1;
        const uint32_t qb = sQ + s * C::kQBytes, ob = sO + s * C::kQBytes;
        const int q_local = (qb0 + j) * BQ;
        mbar_wait(q_full + 8 * s, phase);
        issue_abt<D, BQ, BM>(sc, ka, qb);  // s^T = k . q^T
        mbar_wait(o_full + 8 * s, phase);
        issue_abt<D, BQ, BM>(dp, va, ob);  // dp^T = v . do^T
        wgmma_wait_all();
        fence_regs(sc);
        fence_regs(dp);
        const float* L = sL + s * 2 * BQ;
        if (key_edge || (causal && wk_last > q_offset + q_local) || q_local + BQ > sq)
          dkv_step<true>(sc, dp, L, L + BQ, scale_l2, kl0, q_local, t4, sq, sk, causal,
                         q_offset, k_offset, k_valid);
        else
          dkv_step<false>(sc, dp, L, L + BQ, scale_l2, kl0, q_local, t4, sq, sk, causal,
                          q_offset, k_offset, k_valid);
        pack_a<BQ>(pa, sc);
        pack_a<BQ>(da, dp);
        issue_xb<D, BQ>(dva, pa, ob);  // dv += round(p)^T . do
        issue_xb<D, BQ>(dka, da, qb);  // dk += round(ds)^T . q
        wgmma_wait_all();
        fence_regs(dva);
        fence_regs(dka);
        fence_regs(pa);
        fence_regs(da);
        release(empty + 8 * s);
      }
      if (n_qb > 0) {
        release(kv_empty);  // no wgmma reads K or V any more
        ++nkv;
      }

#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = kl0 + 8 * h;
        if (r >= sk) continue;
        const size_t row = (size_t)bh * sk + r;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          *reinterpret_cast<uint32_t*>(dk + row * D + j * 8 + 2 * t4) =
              pack_bf16x2(dka[4 * j + 2 * h] * sm_scale, dka[4 * j + 2 * h + 1] * sm_scale);
          *reinterpret_cast<uint32_t*>(dv + row * D + j * 8 + 2 * t4) =
              pack_bf16x2(dva[4 * j + 2 * h], dva[4 * j + 2 * h + 1]);
        }
      }
    }
  }
}

// ---- the host side ------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found once through the runtime.
EncodeTiledFn encode_fn() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// A 3-D map over a contiguous bf16 [bh, s, d] tensor, boxes of 64 columns x
// box_rows rows x 1 head, 128-byte swizzle, zeros outside the bounds.
int encode(CUtensorMap* map, const void* ptr, int bh, int s, int d, int box_rows) {
  const EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return kEncodeError + (int)CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)s, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)s * d * 2};
  const cuuint32_t box[3] = {(cuuint32_t)CHUNK, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
                        dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeError + (int)r;
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  __nv_bfloat16 *dq, *dk, *dv;
  int bh, sq, sk, causal, q_offset, k_offset, k_valid;
  float sm_scale;
  cudaStream_t stream;
};

// The four tensor maps: q and do in boxes of q_rows rows, k and v of k_rows.
int encode_all(CUtensorMap (&m)[4], const Args& a, int d, int q_rows, int k_rows) {
  if (int err = encode(&m[0], a.q, a.bh, a.sq, d, q_rows)) return err;
  if (int err = encode(&m[1], a.k, a.bh, a.sk, d, k_rows)) return err;
  if (int err = encode(&m[2], a.v, a.bh, a.sk, d, k_rows)) return err;
  return encode(&m[3], a.dout, a.bh, a.sq, d, q_rows);
}

// One persistent CTA per SM, or one per tile when there are fewer tiles.
template <typename Kernel>
int grid_for(Kernel kernel, int smem, int tiles, int* grid) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
      cudaSuccess)
    return (int)err;
  *grid = tiles < sms ? tiles : sms;
  return 0;
}

template <int D>
int launch_dq(const Args& a) {
  using C = DqCfg<D>;
  CUtensorMap m[4];
  if (int err = encode_all(m, a, D, BM, C::BN)) return err;
  auto kernel = flash_bwd_dq_sm90_kernel<D>;
  int grid = 0;
  if (int err = grid_for(kernel, C::kSmem, a.bh * ((a.sq + BM - 1) / BM), &grid)) return err;
  kernel<<<grid, THREADS, C::kSmem, a.stream>>>(
      m[0], m[1], m[2], m[3], a.lse, a.delta, a.dq, a.sq, a.sk, a.causal, a.q_offset,
      a.k_offset, a.sm_scale, a.k_valid, a.bh);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const Args& a) {
  using C = DkvCfg<D>;
  CUtensorMap m[4];
  if (int err = encode_all(m, a, D, BQ, BM)) return err;
  auto kernel = flash_bwd_dkv_sm90_kernel<D>;
  int grid = 0;
  if (int err = grid_for(kernel, C::kSmem, a.bh * ((a.sk + BM - 1) / BM), &grid)) return err;
  kernel<<<grid, THREADS, C::kSmem, a.stream>>>(
      m[0], m[1], m[2], m[3], a.lse, a.delta, a.dk, a.dv, a.sq, a.sk, a.causal,
      a.q_offset, a.k_offset, a.sm_scale, a.k_valid, a.bh);
  return (int)cudaGetLastError();
}

bool bad_shape(int bh, int sq, int sk) {
  return bh < 1 || sq < 1 || sk < 1 ||
         (long long)bh * ((sq + BM - 1) / BM) > 0x7fffffffLL ||
         (long long)bh * ((sk + BM - 1) / BM) > 0x7fffffffLL;
}

}  // namespace

extern "C" {

// K4: q, do [bh, sq, d], k/v [bh, sk, d] contiguous, 16-byte aligned
// bfloat16; lse and delta [bh, sq] float32; dq [bh, sq, d] bfloat16. d in
// {64, 128}; any sq, sk >= 1; k_valid < 0 means no key mask. Returns a
// cudaError_t code, or 1000 + the CUresult of a failed tensor-map encode.
int ddw_flash_bwd_dq_sm90(const void* q, const void* k, const void* v, const void* dout,
                          const void* lse, const void* delta, void* dq, int bh, int sq,
                          int sk, int d, int causal, int q_offset, int k_offset,
                          float sm_scale, int k_valid, void* stream) {
  if (bad_shape(bh, sq, sk)) return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dq),
               nullptr, nullptr, bh, sq, sk, causal, q_offset, k_offset, k_valid,
               sm_scale, static_cast<cudaStream_t>(stream)};
  if (d == 64) return launch_dq<64>(a);
  if (d == 128) return launch_dq<128>(a);
  return (int)cudaErrorInvalidValue;
}

// K5: the inputs of K4; dk, dv [bh, sk, d] bfloat16.
int ddw_flash_bwd_dkv_sm90(const void* q, const void* k, const void* v, const void* dout,
                           const void* lse, const void* delta, void* dk, void* dv, int bh,
                           int sq, int sk, int d, int causal, int q_offset, int k_offset,
                           float sm_scale, int k_valid, void* stream) {
  if (bad_shape(bh, sq, sk)) return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(delta), nullptr,
               static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), bh, sq,
               sk, causal, q_offset, k_offset, k_valid, sm_scale,
               static_cast<cudaStream_t>(stream)};
  if (d == 64) return launch_dkv<64>(a);
  if (d == 128) return launch_dkv<128>(a);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
