// Flash attention backward for Hopper (K4 dQ and K5 dK/dV, the sm90 variant):
// TMA-fed, warp-specialised, every product on wgmma.
//
// Replaces ddw_tpu/ops/flash_attention.py `_partitioned_bwd` (:397): K4 its
// `_dq_kernel` (:307, pallas_call :425), K5 its `_dkv_kernel` (:350,
// pallas_call :445), for bf16 and f16 at every head dim d up to 256 that is a
// multiple of 8: the main path's backward (the LM's 64, the lm_wide path's
// 256, ViT's 48). Other 16-bit head dims stay on the mma.sync kernels of
// flash_attention_bwd.cu and f32 and head dims above 256 on its CUDA-core
// kernels; the choice is made in Python (`_bwd_variant` in
// ops/flash_attention.py).
//
// What they compute is the TPU kernels' function, pair by (query, key) pair
// (the header of flash_attention_bwd.cu spells it out): s = (q . k) *
// sm_scale in f32, masked (causal by global position q_offset / k_offset,
// keys at or past k_valid); p = exp(s - lse), zero where s was masked
// (`_guarded_exp`); dp = do . v; ds = p * (dp - delta); dq = sm_scale * sum_k
// round(ds) k, dk = sm_scale * sum_q round(ds) q, dv = sum_q round(p) do,
// where round() is the rounding to the input type T (bf16 or f16) where the
// value becomes a product's operand and sm_scale, the caller's from the true
// d, multiplies the f32 sums at the end. delta = rowsum(do * out) - g_lse
// comes from the caller. The backward has no running max, so the tiles set
// only how the f32 partial sums are grouped. Any Sq, Sk >= 1: keys past Sk
// and query rows past Sq are masked by index (never by TMA's zero fill: a
// zero lse would turn a padded row's p into exp(s)), and rows past Sq read
// lse = +inf, so their p is exactly 0. A row that sees no key gets dq = 0
// and gives no share of dk or dv. Tiles that are wholly masked are never
// loaded. Each output tile is summed by one CTA in a fixed order, with no
// atomics, so two launches give the same bits; that is why dQ and dK/dV
// stay two kernels (3 + 4 products) and not FlashAttention-3's single pass
// (5 products, dQ added with float atomics).
//
// Widths. Three are compiled, 64, 128 and 256; a call runs at the smallest
// one >= d (K3's ladder, flash_fwd_sm90.cu). The tensor maps take the true d
// as their innermost dimension and d * 2 bytes as the row stride (16-byte
// aligned only when d % 8 == 0, which is why d must be a multiple of 8), and
// load boxes of 64 columns: columns at or past d arrive as zeros through
// TMA's out-of-bounds fill and add exact zeros to every product; the
// epilogues write rows d values apart and no column at or past d.
//
// What bounds them: operations. At the LM's training shape [256, 2048, 64]
// bf16 causal, K4 does 3 products of 2 * D FLOP over the 256 * 2048 * 2049
// / 2 visible pairs, 2.06e11 FLOP (0.209 ms at the 989 TFLOP/s dense 16-bit
// peak), K5 4, 2.75e11 (0.278 ms), against 0.34 and 0.40 GB of traffic
// (0.10 and 0.12 ms at 3.35 TB/s); the lm_wide path's [64, 2048, 256] has
// the same FLOPs. ViT's [512, 256, 48] with 196 valid keys is bound by
// bytes. The mma.sync kernels these replace ran at 110-114 TFLOP/s at 64
// and about 10% of the bound at 256 and 48: synchronous staging copies
// between two __syncthreads on every tile, mma.sync, no pipelining.
//
// Design (K3's, flash_fwd_sm90.cu):
// - TMA. 3-D tensor maps over [BH, S, d] load 128-byte swizzled boxes of 64
//   columns; a tile past S reads zeros from the map's bounds, never the next
//   head's rows. Encoded on the host through cudaGetDriverEntryPoint (no
//   -lcuda), passed as __grid_constant__.
// - Warp specialisation. Warpgroup 0 produces: its thread 0 issues every TMA
//   load, through mbarrier rings (transaction counts; "empty" barriers the
//   consumer warps arrive at); in K5 its warps 1 and 2 also copy each query
//   block's lse (times log2 e, +inf past Sq) and delta (0 past Sq) into the
//   stage. setmaxnreg gives its registers to the two consumer warpgroups (24
//   against 240 a thread). Producer and consumers get a tile's blocks from
//   the same function, so offsets or a ragged edge cannot leave one side
//   waiting; every mbarrier wait traps after 10 s instead of hanging.
// - K4 owns query tiles of 128 rows, 64 a consumer warpgroup: it loads a
//   tile's Q and dO once and streams the visible K and V blocks (BN = 128
//   keys at width 64, 64 at 128 and 256, where S, dP and dQ would not fit
//   240 registers a thread at 128). S = Q . K^T and dP = dO . V^T are wgmma
//   with both operands from the swizzled tiles; P and dS = P * (dP - delta)
//   in registers; dQ += round(dS) . K is a wgmma with A from registers (the
//   accumulator layout is the A fragment, FlashAttention-3's identity) and B
//   the same K tile read MN-major with the descriptor's transpose bit.
//   Widths 64 and 128 stream stages of a K and a V block (3 of them). At
//   256 Q and dO take 128 KB and a 64-key K+V stage 64 KB, so only one stage
//   would fit: the ring's unit is a slot of one 64-key K or V block (32 KB),
//   3 slots beside Q and dO (224 KB), loaded V first. V is freed once dP is
//   computed, so the next block's K loads while this block's dS and dQ run,
//   and the next V while its K waits for this block's dQ.
// - K5 owns key tiles (FlashAttention-3's layout): it loads a tile's K and V
//   once and streams Q, dO, lse and delta of the visible query blocks (BQ =
//   64), from the first block at or after the diagonal. S^T = K . Q^T and
//   dP^T = V . dO^T from shared memory; P^T = exp(S^T - lse) with lse along
//   the columns; dV += round(P^T) . dO and dK += round(dS^T) . Q with A from
//   registers, dO and Q read MN-major. At widths 64 and 128 a tile is 128
//   keys, 64 a consumer warpgroup, and each warpgroup computes all four
//   products for its keys (dK and dV, D / 2 registers each, beside 96 of
//   scores: 224 at D = 128). At 256 dK and dV alone would take 256
//   registers a thread, over the 240 (and the 255 limit). The split there:
//   a tile is 64 keys, and the two warpgroups share them by output.
//   Warpgroup 1 computes S^T and P^T, hands the f32 P^T to warpgroup 2
//   through 16 KB of shared memory (a pair of mbarriers, one arrival a
//   thread: the same accumulator layout, so thread i reads what thread i
//   wrote), and accumulates dV; warpgroup 2 computes dP^T, dS^T from that
//   P^T, and accumulates dK. Each holds one 128-register accumulator, 32 of
//   scores and 16 of packed operand, and does two of the four products, so
//   no product is computed twice. K and V take 64 KB, two stages of Q and
//   dO blocks 128 KB, P^T 16 KB: 209 KB of the 227. (The other candidates:
//   FlashAttention-3's swapped products with the head dim as wgmma's M
//   side, which reorders the outputs' layout; and both warpgroups splitting
//   dK and dV by columns, each recomputing S^T and dP^T, 1.5x the
//   operations.)
// - Persistent CTAs, one per SM, walk the tiles in groups of 8 heads, the
//   heaviest causal tiles first (K4: the last query tiles; K5: the first key
//   tiles); a group's streamed operands stay in L2 for all its tiles. The
//   producer loads the next tile while the consumers write this one.
// - Each consumer warpgroup runs its blocks in series (the products, then
//   the elementwise step, then the accumulating products): K3's measurements
//   found the overlapped schedules no faster, and this one keeps wgmma out of
//   data-dependent branches (ptxas serialises it there; the warpgroup index
//   is read through a shuffle so that ptxas sees it uniform). Masks run only
//   on blocks where this warp's rows can meet one. A consumer waits for
//   every slot a product group reads before that group's wgmma fence.
// - f16: the same kernels on the `.f16` forms of wgmma, p and ds packed to
//   f16 where bf16 packs to bf16, f16 tensor maps.
// The source is compiled as six parts, one a width and kernel (ops/_build.py).
// The C entries return cudaGetLastError() after the launch, or 1000 plus the
// CUresult when a tensor map cannot be encoded.

// nvcc parts: 6

#include <cuda.h>  // CUtensorMap and its enums: types only, nothing linked
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

// Parts: -DDDW_PART=p compiles only part p's kernels (part_of: K4 and K5 at
// each width apart); part 0 also holds the C entries. Without it one
// translation unit holds everything.
#ifndef DDW_PART
#define DDW_PART -1
#endif

namespace {

constexpr int BM = 128;       // rows a CTA owns: queries (K4), keys (K5 to width 128)
constexpr int BQ = 64;        // queries per streamed block of K5
constexpr int THREADS = 384;  // warpgroup 0 the producer, 1 and 2 the consumers
constexpr int kGroupHeads = 8;  // heads per group of the tile order
constexpr int CHUNK = 64;     // 16-bit columns of a 128-byte swizzled box row
constexpr int ROWB = 128;     // bytes of a box row
constexpr int kMaxD = 256;
constexpr int kEncodeError = 1000;
constexpr int kNotHere = -1;  // no cudaError_t is negative
constexpr int kPart = DDW_PART;
// 10 s in the 2^20 ns (about 1 ms) ticks mbar_wait counts in
constexpr uint32_t kWaitBoundTicks = 10000000000ull >> 20;
constexpr float kLog2e = 1.4426950408889634f;

// The compiled width a head dim d (a multiple of 8, at most 256) runs at.
// ops/flash_attention.py `compiled_width("sm90", d)` gives the same.
__host__ __device__ constexpr int sm90_width(int d) {
  return d <= 64 ? 64 : d <= 128 ? 128 : 256;
}

// The part that holds K4 (dkv false) or K5 at a width.
constexpr int part_of(int width, bool dkv) {
  return 2 * (width == 64 ? 0 : width == 128 ? 1 : 2) + (dkv ? 1 : 0);
}
static_assert(sm90_width(kMaxD) == kMaxD, "the widest head dim is a compiled width");

// The element type's tensor-map type and its pair packing (nearest even,
// the lower column in the low half).
template <typename T>
struct Elem;

template <>
struct Elem<__nv_bfloat16> {
  static constexpr CUtensorMapDataType kMap = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
};

template <>
struct Elem<__half> {
  static constexpr CUtensorMapDataType kMap = CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    const __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The warpgroup index of this thread, read through a shuffle so that the
// compiler knows it is the same across the warp (a wgmma under a branch it
// cannot prove uniform is serialised).
__device__ __forceinline__ int warpgroup() {
  return __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x / 128), 0);
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

// An arrival with release semantics at CTA scope (the default): the shared
// memory writes before it are seen by a thread whose wait completes on it.
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

// The global timer in ticks of 2^20 ns, as 32 bits (they wrap after 52
// days; the difference of two readings is right across a wrap).
__device__ __forceinline__ uint32_t timer_ticks() {
  uint64_t ns;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(ns));
  return static_cast<uint32_t>(ns >> 20);
}

// Wait until the phase of parity `parity` has completed. Producer and
// consumers agree on every count, so a wait that lasts 10 s is a fault: it
// traps (the launch fails with a CUDA error) instead of hanging. The start
// is kept in one register, which the producer warpgroup's 24 need.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const uint32_t t0 = timer_ticks();
  while (!mbar_try_wait(bar, parity))
    if (timer_ticks() - t0 > kWaitBoundTicks) __trap();
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

// The operand lists of a wgmma's f32 accumulator: the placeholders
// "%0, ..., %(n-1)" and the constraints c(d[o]), ..., c(d[o + n - 1]).
#define DDW_L32                                                               \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "     \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define DDW_L64                                                               \
  DDW_L32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "     \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "    \
  "%58, %59, %60, %61, %62, %63"
#define DDW_L128                                                              \
  DDW_L64 ", %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, "     \
  "%76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, "    \
  "%90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, "      \
  "%103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, "  \
  "%115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "  \
  "%127"
#define DDW_OPS8(c, d, o)                                                     \
  c(d[(o) + 0]), c(d[(o) + 1]), c(d[(o) + 2]), c(d[(o) + 3]), c(d[(o) + 4]),   \
      c(d[(o) + 5]), c(d[(o) + 6]), c(d[(o) + 7])
#define DDW_OPS32(c, d, o)                                                    \
  DDW_OPS8(c, d, o), DDW_OPS8(c, d, (o) + 8), DDW_OPS8(c, d, (o) + 16),        \
      DDW_OPS8(c, d, (o) + 24)
#define DDW_OPS64(c, d, o) DDW_OPS32(c, d, o), DDW_OPS32(c, d, (o) + 32)
#define DDW_OPS128(c, d, o) DDW_OPS64(c, d, o), DDW_OPS64(c, d, (o) + 64)

// One wgmma.mma_async of T's type (f16 or bf16, f32 accumulation): SHAPE
// ("m64nNk16"), ARGS its operand string after the type, SCALE the scale-d
// predicate's operand ("1" accumulates; a register's placeholder decides at
// run time); the asm's constraints follow.
#define DDW_WGMMA(T, SHAPE, ARGS, SCALE, ...)                                 \
  do {                                                                        \
    if constexpr (std::is_same_v<T, __half>)                                  \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " SCALE ", 0;\n"         \
                   "wgmma.mma_async.sync.aligned." SHAPE ".f32.f16.f16 " ARGS \
                   "\n}\n" __VA_ARGS__);                                      \
    else                                                                      \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " SCALE ", 0;\n"         \
                   "wgmma.mma_async.sync.aligned." SHAPE                      \
                   ".f32.bf16.bf16 " ARGS "\n}\n" __VA_ARGS__);               \
  } while (0)

// D[64 x N] (+)= A[64 x 16] . B[16 x N], A and B in shared memory
// (descriptors, K-major); N = 64 or 128 by d's size; scale_d = 0 starts the
// sum.
template <typename T>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db,
                                         int scale_d) {
  DDW_WGMMA(T, "m64n64k16", "{" DDW_L32 "}, %32, %33, p, 1, 1, 0, 0;", "%34",
            : DDW_OPS32("+f", d, 0) : "l"(da), "l"(db), "r"(scale_d));
}

template <typename T>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db,
                                         int scale_d) {
  DDW_WGMMA(T, "m64n128k16", "{" DDW_L64 "}, %64, %65, p, 1, 1, 0, 0;", "%66",
            : DDW_OPS64("+f", d, 0) : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x N] += A[64 x 16] . B[16 x N], A in registers (T pairs), B in shared
// memory, MN-major (the transpose bit set); N = 64, 128 or 256 by d's size.
template <typename T>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  DDW_WGMMA(T, "m64n64k16", "{" DDW_L32 "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;",
            "1", : DDW_OPS32("+f", d, 0)
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

template <typename T>
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  DDW_WGMMA(T, "m64n128k16", "{" DDW_L64 "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;",
            "1", : DDW_OPS64("+f", d, 0)
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

template <typename T>
__device__ __forceinline__ void wgmma_rs(float (&d)[128], const uint32_t (&a)[4], uint64_t db) {
  DDW_WGMMA(T, "m64n256k16",
            "{" DDW_L128 "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;", "1",
            : DDW_OPS128("+f", d, 0)
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// acc[64 x N] = A[64 x D] . B[N x D]^T, issued and committed, not waited for.
// Both are K-major swizzled tiles: A 64 rows of a tile of A_ROWS rows (its
// 64-column chunks A_ROWS rows apart), B a tile of N rows.
template <typename T, int D, int N, int A_ROWS>
__device__ __forceinline__ void issue_abt(float (&acc)[N / 2], uint32_t a, uint32_t b) {
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const int c = ks / 4, kc = ks % 4;  // 64-column chunk, k16 slice in it
    wgmma_ss<T>(acc, smem_desc(a + c * A_ROWS * ROWB + kc * 32, 16, 1024),
                smem_desc(b + c * N * ROWB + kc * 32, 16, 1024), ks > 0);
  }
  wgmma_commit();
}

// acc[64 x D] += X[64 x K] . B[K x D], issued and committed, not waited for.
// X is T A fragments (pack_a); B a [K rows][D] swizzled tile read MN-major:
// 8-row groups 1024 bytes apart, 64-column chunks K rows apart.
template <typename T, int D, int K>
__device__ __forceinline__ void issue_xb(float (&acc)[D / 2], const uint32_t (&xa)[K / 16][4],
                                         uint32_t b) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
    wgmma_rs<T>(acc, xa[kk], smem_desc(b + kk * 16 * ROWB, K * ROWB, 1024));
  wgmma_commit();
}

// 2^x on the special-function unit (subnormal results flush to zero)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// An f32 accumulator [64 x N] rounded to T as the A operand of the k16
// slices: columns 16 kk .. 16 kk + 15 are the 8-column groups 2 kk, 2 kk + 1.
template <typename T, int N>
__device__ __forceinline__ void pack_a(uint32_t (&xa)[N / 16][4], const float (&x)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    xa[kk][0] = Elem<T>::pack(x[8 * kk + 0], x[8 * kk + 1]);
    xa[kk][1] = Elem<T>::pack(x[8 * kk + 2], x[8 * kk + 3]);
    xa[kk][2] = Elem<T>::pack(x[8 * kk + 4], x[8 * kk + 5]);
    xa[kk][3] = Elem<T>::pack(x[8 * kk + 6], x[8 * kk + 7]);
  }
}

template <int R>
__device__ __forceinline__ void zero(float (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) r[i] = 0.f;
}

// An f32 accumulator [64 x D] (rows r0 and r0 + 8 of this thread, the
// accumulator layout) times `scale`, stored as T into rows d values apart of
// `out` (row index base + r, rows at or past `rows` skipped); no column at
// or past d is written (d % 8 == 0, so an 8-column group lies wholly below d
// or at or past it). At d == D the stores are unmasked (K3 measured a masked
// epilogue slower at the compiled width).
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* __restrict__ out, const float (&acc)[D / 2],
                                           float scale, size_t base, int r0, int rows,
                                           int d, int t) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    if (r >= rows) continue;
    const size_t row = base + r;
    if (d == D) {
      T* orow = out + row * D + 2 * t;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(orow + j * 8) =
            Elem<T>::pack(acc[4 * j + 2 * h] * scale, acc[4 * j + 2 * h + 1] * scale);
    } else {
      T* orow = out + row * d + 2 * t;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        if (j * 8 < d)
          *reinterpret_cast<uint32_t*>(orow + j * 8) =
              Elem<T>::pack(acc[4 * j + 2 * h] * scale, acc[4 * j + 2 * h + 1] * scale);
    }
  }
}

// ---- which blocks a tile sees (producer and consumers both call these) -----

// K4: the key blocks [0, n) of BN keys that a query tile whose last global
// position is q_last sees.
template <int BN>
__device__ __forceinline__ int key_blocks(int sk, int causal, int q_last, int k_offset,
                                          int kv_end) {
  int n = (sk + BN - 1) / BN;
  if (causal) {
    const int span = q_last - k_offset;
    n = span < 0 ? 0 : min(n, span / BN + 1);
  }
  if (kv_end < INT_MAX) {
    const int kv = kv_end - k_offset;
    n = kv <= 0 ? 0 : min(n, (kv + BN - 1) / BN);
  }
  return n;
}

// K5: the query blocks [first, first + n) of BQ queries that a key tile
// whose first global position is k_first sees: from the first block whose
// last row reaches the tile (causal) to the end; none at or past kv_end.
__device__ __forceinline__ void query_blocks(int sq, int causal, int k_first, int q_offset,
                                             int kv_end, int& first, int& n) {
  const int end = (sq + BQ - 1) / BQ;
  first = 0;
  n = end;
  if (k_first >= kv_end || (causal && q_offset + sq - 1 < k_first)) {
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

// The kernels take kv_end, the first global key position the key mask
// hides (k_valid, or INT_MAX without one; the C entries convert), so that a
// mask is one comparison with a kernel parameter. With k_valid and a test
// of k_valid < 0 in the mask, ptxas reloaded k_valid from the constant bank
// for every element of a masked block at widths 64 and 128.

// K4, one key block in registers: sc holds q . k and dp holds do . v on
// entry; dp holds ds = p * (dp - delta) on exit, p = 2^(s sm_scale log2 e -
// lse log2 e), 0 where masked. Columns k_local + 8 j + 2 t (+1) of the
// block (local key index); the masks in local keys: the thread's rows see
// keys up to qlim and qlim + 8 (causal), and none at or past kl_end (past
// Sk, or at kv_end): two comparisons an element, which keeps the width-256
// kernel inside its registers.
template <bool kMask, int BN>
__device__ __forceinline__ void dq_step(const float (&sc)[BN / 2], float (&dp)[BN / 2],
                                        const float (&lse_l2)[2], const float (&dl)[2],
                                        float scale_l2, int qlim, int k_local, int t,
                                        int kl_end, int causal) {
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1, i = 4 * j + e;
      float p = ex2(fmaf(sc[i], scale_l2, -lse_l2[h]));
      if (kMask) {
        const int kl = k_local + 8 * j + 2 * t + (e & 1);
        const bool keep = kl < kl_end && (!causal || kl <= qlim + 8 * h);
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
                                         int kv_end) {
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
                          kpos < kv_end;
        if (!keep) p = 0.f;
      }
      sc[i] = p;
      dp[i] = p * (dp[i] - delta);
    }
  }
}

// K5 at width 256, the dV warpgroup's half of dkv_step: sc holds k . q on
// entry and p (0 where masked) on exit.
template <bool kMask>
__device__ __forceinline__ void p_step(float (&sc)[BQ / 2], const float* L, float scale_l2,
                                       int kl0, int q_local, int t, int sq, int sk,
                                       int causal, int q_offset, int k_offset,
                                       int kv_end) {
#pragma unroll
  for (int j = 0; j < BQ / 8; ++j) {
    const int c = 8 * j + 2 * t;
    const float2 l2 = *reinterpret_cast<const float2*>(L + c);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1, i = 4 * j + e;
      float p = ex2(fmaf(sc[i], scale_l2, -((e & 1) ? l2.y : l2.x)));
      if (kMask) {
        const int ql = q_local + c + (e & 1), kl = kl0 + 8 * h, kpos = k_offset + kl;
        const bool keep = ql < sq && kl < sk && (!causal || kpos <= q_offset + ql) &&
                          kpos < kv_end;
        if (!keep) p = 0.f;
      }
      sc[i] = p;
    }
  }
}

// ... and the dK warpgroup's: dp holds v . do on entry and ds = p (dp -
// delta) on exit, p this thread's element i at P[128 i] (0 where masked, so
// ds needs no mask of its own).
__device__ __forceinline__ void ds_step(float (&dp)[BQ / 2], const float* P, const float* Dl,
                                        int t) {
#pragma unroll
  for (int j = 0; j < BQ / 8; ++j) {
    const float2 d2 = *reinterpret_cast<const float2*>(Dl + 8 * j + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * j + e;
      dp[i] = P[128 * i] * (dp[i] - ((e & 1) ? d2.y : d2.x));
    }
  }
}

// ---- K4: dQ --------------------------------------------------------------------

template <int D>
struct DqCfg {
  static constexpr int BN = D <= 64 ? 128 : 64;  // keys per streamed block
  // width 256: the ring's unit is one K or one V block (a slot), not a stage
  // of both
  static constexpr bool kSlotRing = D > 128;
  static constexpr int kStages = 3;            // stages, or slots at 256
  static constexpr int kQBytes = BM * D * 2;   // the Q or the dO tile
  static constexpr int kKVBytes = BN * D * 2;  // one K or one V block
  static constexpr int kSlots = kSlotRing ? kStages : 2 * kStages;
  static constexpr int kBarOffset = 2 * kQBytes + kSlots * kKVBytes;
  // q_full, q_empty, then k_full, v_full and empty per stage (the slot ring
  // uses k_full as each slot's full barrier); 1024 bytes of slack to align
  // the tiles to the 128-byte swizzle's 1024-byte atom
  static constexpr int kSmem = kBarOffset + 8 * (2 + 3 * kStages) + 1024;
  static_assert(kSmem <= 232448, "227 KB of shared memory a block");
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tdo,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         T* __restrict__ dq, int sq, int sk, int d, int causal,
                         int q_offset, int k_offset, float sm_scale, int kv_end,
                         int n_bh) {
  using C = DqCfg<D>;
  constexpr int S = C::kStages, BN = C::BN;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base, sO = base + C::kQBytes;  // [chunk][BM rows][64]
  // [stage][chunk][BN keys][64] of K, then V's; or [slot][chunk][BN keys][64]
  const uint32_t sK = sO + C::kQBytes;
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
    n_kb = key_blocks<BN>(sk, causal, q_offset + min(q0 + BM, sq) - 1, k_offset, kv_end);
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
      int it = 0, nq = 0;  // K/V stages (slots at 256) and Q tiles loaded so far
      for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        int bh, q0, n_kb;
        tile_at(t, bh, q0, n_kb);
        if (n_kb == 0) continue;  // a tile that sees no key loads nothing
        mbar_wait(q_empty, (nq++ & 1) ^ 1);  // the consumers are done with Q, dO
        mbar_expect_tx(q_full, 2 * C::kQBytes);
        tma_tile<D>(sQ, &tq, q_full, BM, q0, bh);
        tma_tile<D>(sO, &tdo, q_full, BM, q0, bh);
        for (int i = 0; i < n_kb; ++i) {
          if constexpr (C::kSlotRing) {  // V's slot, then K's
#pragma unroll
            for (int kv = 0; kv < 2; ++kv, ++it) {
              const int s = it % S;
              mbar_wait(empty + 8 * s, ((it / S) & 1) ^ 1);  // the first round passes
              mbar_expect_tx(k_full + 8 * s, C::kKVBytes);
              tma_tile<D>(sK + s * C::kKVBytes, kv ? &tk : &tv, k_full + 8 * s, BN, i * BN,
                          bh);
            }
          } else {
            const int s = it % S;
            mbar_wait(empty + 8 * s, ((it / S) & 1) ^ 1);  // the first round passes
            mbar_expect_tx(k_full + 8 * s, C::kKVBytes);
            tma_tile<D>(sK + s * C::kKVBytes, &tk, k_full + 8 * s, BN, i * BN, bh);
            mbar_expect_tx(v_full + 8 * s, C::kKVBytes);
            tma_tile<D>(sV + s * C::kKVBytes, &tv, v_full + 8 * s, BN, i * BN, bh);
            ++it;
          }
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
    // the first local key the masks hide: past Sk, or at kv_end
    const int kl_end = kv_end == INT_MAX ? sk : min(sk, kv_end - k_offset);
    auto release = [&](uint32_t bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };
    float sc[BN / 2], dp[BN / 2];
    zero(sc);
    zero(dp);
    uint32_t da[BN / 16][4];

    int it = 0, nq = 0;  // K/V stages (slots) and Q tiles consumed so far
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
      for (int i = 0; i < n_kb; ++i) {
        uint32_t kb;  // this block's K tile (or slot), which dq's product reads too
        if constexpr (C::kSlotRing) {
          const int vs = it % S;
          const uint32_t vph = (it / S) & 1;
          ++it;
          const int ks = it % S;
          const uint32_t kph = (it / S) & 1;
          ++it;
          kb = sK + ks * C::kKVBytes;
          mbar_wait(k_full + 8 * vs, vph);
          issue_abt<T, D, BN, BM>(dp, oa, sK + vs * C::kKVBytes);
          mbar_wait(k_full + 8 * ks, kph);
          issue_abt<T, D, BN, BM>(sc, qa, kb);
          wgmma_wait_all();
          fence_regs(sc);
          fence_regs(dp);
          release(empty + 8 * vs);  // V is read: the next block's K may land
        } else {
          const int s = it % S;
          const uint32_t phase = (it / S) & 1;
          ++it;
          kb = sK + s * C::kKVBytes;
          mbar_wait(k_full + 8 * s, phase);
          issue_abt<T, D, BN, BM>(sc, qa, kb);
          mbar_wait(v_full + 8 * s, phase);
          issue_abt<T, D, BN, BM>(dp, oa, sV + s * C::kKVBytes);
          wgmma_wait_all();
          fence_regs(sc);
          fence_regs(dp);
        }
        const int k_local = i * BN, k_last = k_offset + k_local + BN - 1;
        if ((causal && k_last > wq_first) || k_last >= kv_end || k_local + BN > sk)
          dq_step<true, BN>(sc, dp, lse_l2, dl, scale_l2, qpos0 - k_offset, k_local, t4,
                            kl_end, causal);
        else
          dq_step<false, BN>(sc, dp, lse_l2, dl, scale_l2, qpos0 - k_offset, k_local, t4,
                             kl_end, causal);
        pack_a<T, BN>(da, dp);
        issue_xb<T, D, BN>(acc, da, kb);  // dq += round(ds) . k
        wgmma_wait_all();
        fence_regs(acc);
        fence_regs(da);
        release(empty + 8 * ((kb - sK) / C::kKVBytes));  // K's stage or slot
      }
      if (n_kb > 0) {
        release(q_empty);  // no wgmma reads Q or dO any more
        ++nq;
      }
      store_rows<T, D>(dq, acc, sm_scale, (size_t)bh * sq, row0, sq, d, t4);
    }
  }
}

// ---- K5: dK and dV, widths 64 and 128 -------------------------------------------

// K5's producer warps 1 (kLse: lse times log2 e, +inf past Sq) and 2 (delta,
// 0 past Sq): each streamed query block's rows of one array into its
// stage's L (lse at L[0, BQ), delta at L[BQ, 2 BQ)), then one arrival a
// lane on the stage's o_full (release: the stores are seen). One array a
// warp keeps each warp's loop inside the 24 registers setmaxnreg leaves the
// producer warpgroup (one warp for both spilled 4 bytes).
template <bool kLse, int S, typename TileAt>
__device__ __forceinline__ void stage_rows(const TileAt& tile_at, const float* __restrict__ src,
                                           float* sL, uint32_t empty, uint32_t o_full,
                                           int n_tiles, int sq) {
  const int lane = threadIdx.x % 32;
  int it = 0;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    int bh, k0, qb0, n_qb;
    tile_at(t, bh, k0, qb0, n_qb);
    const float* rows = src + (size_t)bh * sq;
    for (int j = 0; j < n_qb; ++j, ++it) {
      const int s = it % S;
      mbar_wait(empty + 8 * s, ((it / S) & 1) ^ 1);
      float* L = sL + s * 2 * BQ + (kLse ? 0 : BQ);
#pragma unroll
      for (int c = lane; c < BQ; c += 32) {
        const int r = (qb0 + j) * BQ + c;
        if (kLse)
          L[c] = r < sq ? rows[r] * kLog2e : INFINITY;  // rows past Sq: p = 0
        else
          L[c] = r < sq ? rows[r] : 0.f;
      }
      mbar_arrive(o_full + 8 * s);
    }
  }
}

// K5's producer warpgroup, after its setmaxnreg: thread 0 issues every TMA
// load, each key tile's K and V (KROWS rows) once, then its visible query
// blocks' Q and dO through the ring of S stages; warps 1 and 2 stage each
// block's lse and delta (stage_rows). The tiles come from the consumers'
// tile_at, so both sides agree on every count.
template <int D, int S, int KROWS, typename TileAt>
__device__ __forceinline__ void dkv_produce(const TileAt& tile_at, const CUtensorMap* tq,
                                            const CUtensorMap* tk, const CUtensorMap* tv,
                                            const CUtensorMap* tdo,
                                            const float* __restrict__ lse,
                                            const float* __restrict__ delta, uint32_t sK,
                                            uint32_t sV, uint32_t sQ, uint32_t sO, float* sL,
                                            uint32_t kv_full, uint32_t kv_empty,
                                            uint32_t q_full, uint32_t o_full, uint32_t empty,
                                            int n_tiles, int sq) {
  constexpr int kKBytes = KROWS * D * 2;  // the K or the V tile
  constexpr int kQBytes = BQ * D * 2;     // one Q or one dO block
  if (threadIdx.x == 0) {
    int it = 0, nkv = 0;  // query blocks and K/V tiles loaded so far
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      int bh, k0, qb0, n_qb;
      tile_at(t, bh, k0, qb0, n_qb);
      if (n_qb == 0) continue;  // a tile no query sees loads nothing
      mbar_wait(kv_empty, (nkv++ & 1) ^ 1);  // the consumers are done with K, V
      mbar_expect_tx(kv_full, 2 * kKBytes);
      tma_tile<D>(sK, tk, kv_full, KROWS, k0, bh);
      tma_tile<D>(sV, tv, kv_full, KROWS, k0, bh);
      for (int j = 0; j < n_qb; ++j, ++it) {
        const int s = it % S, row = (qb0 + j) * BQ;
        mbar_wait(empty + 8 * s, ((it / S) & 1) ^ 1);  // the first round passes
        mbar_expect_tx(q_full + 8 * s, kQBytes);
        tma_tile<D>(sQ + s * kQBytes, tq, q_full + 8 * s, BQ, row, bh);
        mbar_expect_tx(o_full + 8 * s, kQBytes);
        tma_tile<D>(sO + s * kQBytes, tdo, o_full + 8 * s, BQ, row, bh);
      }
    }
  } else if (threadIdx.x / 32 == 1) {
    stage_rows<true, S>(tile_at, lse, sL, empty, o_full, n_tiles, sq);
  } else if (threadIdx.x / 32 == 2) {
    stage_rows<false, S>(tile_at, delta, sL, empty, o_full, n_tiles, sq);
  }
}

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
  static_assert(kSmem <= 232448, "227 KB of shared memory a block");
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkv_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          T* __restrict__ dk, T* __restrict__ dv, int sq, int sk, int d,
                          int causal, int q_offset, int k_offset, float sm_scale,
                          int kv_end, int n_bh) {
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
    query_blocks(sq, causal, k_offset + k0, q_offset, kv_end, qb0, n_qb);
  };

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    mbar_init(kv_empty, 8);  // one arrival per consumer warp
    for (int s = 0; s < S; ++s) {
      mbar_init(q_full + 8 * s, 1);
      mbar_init(o_full + 8 * s, 1 + 64);  // the TMA thread, warps 1 and 2's lanes
      mbar_init(empty + 8 * s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- the producer warpgroup (dkv_produce) -------------------------------------
    // The split must fit the 168 x 384 registers the launch holds (24 x 128
    // + 240 x 256 does exactly), or setmaxnreg.inc waits forever; 40 / 232
    // spills the D = 128 consumers.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    dkv_produce<D, S, BM>(tile_at, &tq, &tk, &tv, &tdo, lse, delta, sK, sV, sQ, sO, sL,
                          kv_full, kv_empty, q_full, o_full, empty, n_tiles, sq);
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
      const bool key_edge = wk_last >= kv_end || wk0 + 16 > sk;
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
        issue_abt<T, D, BQ, BM>(sc, ka, qb);  // s^T = k . q^T
        mbar_wait(o_full + 8 * s, phase);
        issue_abt<T, D, BQ, BM>(dp, va, ob);  // dp^T = v . do^T
        wgmma_wait_all();
        fence_regs(sc);
        fence_regs(dp);
        const float* L = sL + s * 2 * BQ;
        if (key_edge || (causal && wk_last > q_offset + q_local) || q_local + BQ > sq)
          dkv_step<true>(sc, dp, L, L + BQ, scale_l2, kl0, q_local, t4, sq, sk, causal,
                         q_offset, k_offset, kv_end);
        else
          dkv_step<false>(sc, dp, L, L + BQ, scale_l2, kl0, q_local, t4, sq, sk, causal,
                          q_offset, k_offset, kv_end);
        pack_a<T, BQ>(pa, sc);
        pack_a<T, BQ>(da, dp);
        issue_xb<T, D, BQ>(dva, pa, ob);  // dv += round(p)^T . do
        issue_xb<T, D, BQ>(dka, da, qb);  // dk += round(ds)^T . q
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
      store_rows<T, D>(dk, dka, sm_scale, (size_t)bh * sk, kl0, sk, d, t4);
      store_rows<T, D>(dv, dva, 1.f, (size_t)bh * sk, kl0, sk, d, t4);
    }
  }
}

// ---- K5 at width 256: the two warpgroups split the outputs -----------------------

struct DkvSplitCfg {
  static constexpr int D = 256;
  static constexpr int BK = 64;                // keys a tile: both warpgroups' rows
  static constexpr int kStages = 2;
  static constexpr int kKBytes = BK * D * 2;   // the K or the V tile
  static constexpr int kQBytes = BQ * D * 2;   // one Q or one dO block
  static constexpr int kPOffset = 2 * kKBytes + 2 * kStages * kQBytes;
  static constexpr int kPBytes = 128 * (BQ / 2) * 4;  // f32 P^T, [element][thread]
  static constexpr int kLOffset = kPOffset + kPBytes;
  static constexpr int kBarOffset = kLOffset + kStages * 2 * BQ * 4;  // lse, delta
  // kv_full, kv_empty, p_full, p_empty, then q_full, o_full and empty per
  // stage; 1024 bytes of alignment slack
  static constexpr int kSmem = kBarOffset + 8 * (4 + 3 * kStages) + 1024;
  static_assert(kSmem <= 232448, "227 KB of shared memory a block");
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkv_sm90_split_kernel(const __grid_constant__ CUtensorMap tq,
                                const __grid_constant__ CUtensorMap tk,
                                const __grid_constant__ CUtensorMap tv,
                                const __grid_constant__ CUtensorMap tdo,
                                const float* __restrict__ lse,
                                const float* __restrict__ delta, T* __restrict__ dk,
                                T* __restrict__ dv, int sq, int sk, int d, int causal,
                                int q_offset, int k_offset, float sm_scale, int kv_end,
                                int n_bh) {
  using C = DkvSplitCfg;
  static_assert(D == C::D, "the split kernel is width 256's");
  constexpr int S = C::kStages, BK = C::BK;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sK = base, sV = base + C::kKBytes;  // [chunk][BK keys][64]
  const uint32_t sQ = sV + C::kKBytes;               // [stage][chunk][BQ rows][64]
  const uint32_t sO = sQ + S * C::kQBytes;
  float* const sP = reinterpret_cast<float*>(smem_raw + (base - raw) + C::kPOffset);
  float* const sL = reinterpret_cast<float*>(smem_raw + (base - raw) + C::kLOffset);
  const uint32_t kv_full = base + C::kBarOffset, kv_empty = kv_full + 8;
  const uint32_t p_full = kv_empty + 8, p_empty = p_full + 8;
  const uint32_t q_full = p_empty + 8, o_full = q_full + 8 * S, empty = o_full + 8 * S;

  const int n_kt = (sk + BK - 1) / BK, n_tiles = n_bh * n_kt;
  const int group = min(kGroupHeads, n_bh);
  auto tile_at = [&](int t, int& bh, int& k0, int& qb0, int& n_qb) {
    const int g0 = t / (group * n_kt) * group;
    const int gn = min(group, n_bh - g0);
    const int r = t - g0 * n_kt;
    bh = g0 + r % gn;
    k0 = r / gn * BK;
    query_blocks(sq, causal, k_offset + k0, q_offset, kv_end, qb0, n_qb);
  };

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    mbar_init(kv_empty, 8);  // one arrival per consumer warp
    mbar_init(p_full, 128);  // one arrival per thread of the dV warpgroup
    mbar_init(p_empty, 128);  // ... of the dK warpgroup
    for (int s = 0; s < S; ++s) {
      mbar_init(q_full + 8 * s, 1);
      mbar_init(o_full + 8 * s, 1 + 64);  // the TMA thread, warps 1 and 2's lanes
      mbar_init(empty + 8 * s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = warpgroup();
  if (wg == 0) {
    // ---- the producer warpgroup (dkv_produce) -------------------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    dkv_produce<D, S, BK>(tile_at, &tq, &tk, &tv, &tdo, lse, delta, sK, sV, sQ, sO, sL,
                          kv_full, kv_empty, q_full, o_full, empty, n_tiles, sq);
  } else {
    // ---- warpgroup 1: S^T, P^T, dV; warpgroup 2: dP^T, dS^T, dK; the same
    // 64 keys ------------------------------------------------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32, t4 = lane % 4;
    const float scale_l2 = sm_scale * kLog2e;
    auto release = [&](uint32_t bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };
    float sc[BQ / 2];  // s^T then p^T (warpgroup 1), dp^T then ds^T (2)
    zero(sc);
    uint32_t xa[BQ / 16][4];

    int it = 0, nkv = 0;  // query blocks and K/V tiles consumed so far
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      int bh, k0, qb0, n_qb;
      tile_at(t, bh, k0, qb0, n_qb);
      const int wk0 = k0 + warp * 16;             // the warp's first key (local)
      const int kl0 = wk0 + lane / 4;             // keys kl0, kl0 + 8
      const int wk_last = k_offset + wk0 + 15;    // the warp's last key (global)
      const bool key_edge = wk_last >= kv_end || wk0 + 16 > sk;
      float acc[D / 2];  // dV (warpgroup 1) or dK (2)
      zero(acc);
      if (n_qb > 0) mbar_wait(kv_full, nkv & 1);
      for (int j = 0; j < n_qb; ++j, ++it) {
        const int s = it % S;
        const uint32_t phase = (it / S) & 1;
        const uint32_t qb = sQ + s * C::kQBytes, ob = sO + s * C::kQBytes;
        const int q_local = (qb0 + j) * BQ;
        const float* L = sL + s * 2 * BQ;
        if (wg == 1) {
          mbar_wait(q_full + 8 * s, phase);
          issue_abt<T, D, BQ, BK>(sc, sK, qb);  // s^T = k . q^T
          mbar_wait(o_full + 8 * s, phase);     // dO, lse and delta
          wgmma_wait_all();
          fence_regs(sc);
          if (key_edge || (causal && wk_last > q_offset + q_local) || q_local + BQ > sq)
            p_step<true>(sc, L, scale_l2, kl0, q_local, t4, sq, sk, causal, q_offset,
                         k_offset, kv_end);
          else
            p_step<false>(sc, L, scale_l2, kl0, q_local, t4, sq, sk, causal, q_offset,
                          k_offset, kv_end);
          mbar_wait(p_empty, (it & 1) ^ 1);  // warpgroup 2 has read the last p^T
#pragma unroll
          for (int i = 0; i < BQ / 2; ++i) sP[128 * i + tid] = sc[i];
          mbar_arrive(p_full);
          pack_a<T, BQ>(xa, sc);
          issue_xb<T, D, BQ>(acc, xa, ob);  // dv += round(p)^T . do
        } else {
          mbar_wait(o_full + 8 * s, phase);
          issue_abt<T, D, BQ, BK>(sc, sV, ob);  // dp^T = v . do^T
          mbar_wait(q_full + 8 * s, phase);
          wgmma_wait_all();
          fence_regs(sc);
          mbar_wait(p_full, it & 1);
          ds_step(sc, sP + tid, L + BQ, t4);
          mbar_arrive(p_empty);
          pack_a<T, BQ>(xa, sc);
          issue_xb<T, D, BQ>(acc, xa, qb);  // dk += round(ds)^T . q
        }
        wgmma_wait_all();
        fence_regs(acc);
        fence_regs(xa);
        release(empty + 8 * s);
      }
      if (n_qb > 0) {
        release(kv_empty);  // no wgmma reads K or V any more
        ++nkv;
      }
      if (wg == 1)
        store_rows<T, D>(dv, acc, 1.f, (size_t)bh * sk, kl0, sk, d, t4);
      else
        store_rows<T, D>(dk, acc, sm_scale, (size_t)bh * sk, kl0, sk, d, t4);
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

// A 3-D map over a contiguous 16-bit [bh, s, d] tensor of type T, boxes of 64
// columns x box_rows rows x 1 head, 128-byte swizzle, zeros outside the
// bounds (the columns at or past d of a box among them).
template <typename T>
int encode(CUtensorMap* map, const void* ptr, int bh, int s, int d, int box_rows) {
  const EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return kEncodeError + (int)CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)s, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)s * d * 2};
  const cuuint32_t box[3] = {(cuuint32_t)CHUNK, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = fn(map, Elem<T>::kMap, 3, const_cast<void*>(ptr), dims, strides,
                        box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeError + (int)r;
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *dq, *dk, *dv;
  int bh, sq, sk, d, causal, q_offset, k_offset, k_valid;
  float sm_scale;
  cudaStream_t stream;
};

// The kernels' kv_end: the caller's k_valid, or INT_MAX for none (< 0).
int key_end(const Args& a) { return a.k_valid < 0 ? INT_MAX : a.k_valid; }

// The four tensor maps: q and do in boxes of q_rows rows, k and v of k_rows.
template <typename T>
int encode_all(CUtensorMap (&m)[4], const Args& a, int q_rows, int k_rows) {
  if (int err = encode<T>(&m[0], a.q, a.bh, a.sq, a.d, q_rows)) return err;
  if (int err = encode<T>(&m[1], a.k, a.bh, a.sk, a.d, k_rows)) return err;
  if (int err = encode<T>(&m[2], a.v, a.bh, a.sk, a.d, k_rows)) return err;
  return encode<T>(&m[3], a.dout, a.bh, a.sq, a.d, q_rows);
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

template <typename T, int D>
int launch_dq(const Args& a) {
  using C = DqCfg<D>;
  CUtensorMap m[4];
  if (int err = encode_all<T>(m, a, BM, C::BN)) return err;
  auto kernel = flash_bwd_dq_sm90_kernel<T, D>;
  int grid = 0;
  if (int err = grid_for(kernel, C::kSmem, a.bh * ((a.sq + BM - 1) / BM), &grid)) return err;
  kernel<<<grid, THREADS, C::kSmem, a.stream>>>(
      m[0], m[1], m[2], m[3], a.lse, a.delta, static_cast<T*>(a.dq), a.sq, a.sk, a.d,
      a.causal, a.q_offset, a.k_offset, a.sm_scale, key_end(a), a.bh);
  return (int)cudaGetLastError();
}

// K5's key tile: 128 keys to width 128, 64 at 256 (the split kernel)
constexpr int dkv_tile(int width) { return width > 128 ? DkvSplitCfg::BK : BM; }

template <typename T, int D>
int launch_dkv(const Args& a) {
  constexpr int BK = dkv_tile(D);
  CUtensorMap m[4];
  if (int err = encode_all<T>(m, a, BQ, BK)) return err;
  int grid = 0;
  const int tiles = a.bh * ((a.sk + BK - 1) / BK);
  if constexpr (D > 128) {
    auto kernel = flash_bwd_dkv_sm90_split_kernel<T, D>;
    if (int err = grid_for(kernel, DkvSplitCfg::kSmem, tiles, &grid)) return err;
    kernel<<<grid, THREADS, DkvSplitCfg::kSmem, a.stream>>>(
        m[0], m[1], m[2], m[3], a.lse, a.delta, static_cast<T*>(a.dk),
        static_cast<T*>(a.dv), a.sq, a.sk, a.d, a.causal, a.q_offset, a.k_offset,
        a.sm_scale, key_end(a), a.bh);
  } else {
    auto kernel = flash_bwd_dkv_sm90_kernel<T, D>;
    if (int err = grid_for(kernel, DkvCfg<D>::kSmem, tiles, &grid)) return err;
    kernel<<<grid, THREADS, DkvCfg<D>::kSmem, a.stream>>>(
        m[0], m[1], m[2], m[3], a.lse, a.delta, static_cast<T*>(a.dk),
        static_cast<T*>(a.dv), a.sq, a.sk, a.d, a.causal, a.q_offset, a.k_offset,
        a.sm_scale, key_end(a), a.bh);
  }
  return (int)cudaGetLastError();
}

// K4 (kDkv false) or K5 at width D in bf16 (dtype 1) or f16 (2), or kNotHere
// when another part holds it.
template <int D, bool kDkv>
int run(const Args& a, int dtype) {
  if constexpr (kPart >= 0 && kPart != part_of(D, kDkv)) {
    return kNotHere;
  } else if constexpr (kDkv) {
    if (dtype == 1) return launch_dkv<__nv_bfloat16, D>(a);
    if (dtype == 2) return launch_dkv<__half, D>(a);
    return (int)cudaErrorInvalidValue;
  } else {
    if (dtype == 1) return launch_dq<__nv_bfloat16, D>(a);
    if (dtype == 2) return launch_dq<__half, D>(a);
    return (int)cudaErrorInvalidValue;
  }
}

template <bool kDkv>
int run_width(const Args& a, int dtype) {
  switch (sm90_width(a.d)) {
    case 64: return run<64, kDkv>(a, dtype);
    case 128: return run<128, kDkv>(a, dtype);
    default: return run<256, kDkv>(a, dtype);
  }
}

int run_kernel(const Args& a, int dtype, int dkv) {
  return dkv ? run_width<true>(a, dtype) : run_width<false>(a, dtype);
}

// A shape no kernel here takes: empty tensors, a d that is not a multiple
// of 8 in [8, 256], another dtype, or more tiles than a grid walk counts.
bool bad_shape(int bh, int sq, int sk, int d, int dtype) {
  return bh < 1 || sq < 1 || sk < 1 || d < 8 || d > kMaxD || d % 8 != 0 ||
         (dtype != 1 && dtype != 2) ||
         (long long)bh * ((sq + BM - 1) / BM) > 0x7fffffffLL ||
         (long long)bh * ((sk + DkvSplitCfg::BK - 1) / DkvSplitCfg::BK) > 0x7fffffffLL;
}

}  // namespace

extern "C" {

#if DDW_PART >= 0
#define DDW_CAT_(a, b) a##b
#define DDW_CAT(a, b) DDW_CAT_(a, b)
// This part's kernels (kNotHere for the others'); args is an Args.
int DDW_CAT(ddw_flash_bwd_sm90_part, DDW_PART)(const void* args, int dtype, int dkv) {
  return run_kernel(*static_cast<const Args*>(args), dtype, dkv);
}
int ddw_flash_bwd_sm90_part0(const void* args, int dtype, int dkv);
int ddw_flash_bwd_sm90_part1(const void* args, int dtype, int dkv);
int ddw_flash_bwd_sm90_part2(const void* args, int dtype, int dkv);
int ddw_flash_bwd_sm90_part3(const void* args, int dtype, int dkv);
int ddw_flash_bwd_sm90_part4(const void* args, int dtype, int dkv);
int ddw_flash_bwd_sm90_part5(const void* args, int dtype, int dkv);
#endif

#if DDW_PART <= 0

}  // extern "C"

namespace {

int dispatch(const Args& a, int dtype, int dkv) {
#if DDW_PART < 0
  return run_kernel(a, dtype, dkv);
#else
  using Part = int (*)(const void*, int, int);
  const Part parts[] = {ddw_flash_bwd_sm90_part0, ddw_flash_bwd_sm90_part1,
                        ddw_flash_bwd_sm90_part2, ddw_flash_bwd_sm90_part3,
                        ddw_flash_bwd_sm90_part4, ddw_flash_bwd_sm90_part5};
  return parts[part_of(sm90_width(a.d), dkv != 0)](&a, dtype, dkv);
#endif
}

}  // namespace

extern "C" {

// K4: q, do [bh, sq, d], k/v [bh, sk, d] contiguous, 16-byte aligned, in
// bfloat16 (dtype 1) or float16 (2); lse and delta [bh, sq] float32; dq [bh,
// sq, d] in the inputs' dtype. d a multiple of 8 up to 256, run at the
// compiled width 64, 128 or 256 (sm90_width); sm_scale the caller's (from
// the true d); any sq, sk >= 1; k_valid < 0 means no key mask. Returns a
// cudaError_t code, or 1000 + the CUresult of a failed tensor-map encode.
int ddw_flash_bwd_dq_sm90(const void* q, const void* k, const void* v, const void* dout,
                          const void* lse, const void* delta, void* dq, int bh, int sq,
                          int sk, int d, int dtype, int causal, int q_offset, int k_offset,
                          float sm_scale, int k_valid, void* stream) {
  if (bad_shape(bh, sq, sk, d, dtype)) return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(delta), dq, nullptr, nullptr, bh, sq, sk, d,
               causal, q_offset, k_offset, k_valid, sm_scale,
               static_cast<cudaStream_t>(stream)};
  return dispatch(a, dtype, 0);
}

// K5: the inputs of K4; dk, dv [bh, sk, d] in their dtype.
int ddw_flash_bwd_dkv_sm90(const void* q, const void* k, const void* v, const void* dout,
                           const void* lse, const void* delta, void* dk, void* dv, int bh,
                           int sq, int sk, int d, int dtype, int causal, int q_offset,
                           int k_offset, float sm_scale, int k_valid, void* stream) {
  if (bad_shape(bh, sq, sk, d, dtype)) return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(delta), nullptr, dk, dv, bh, sq, sk, d,
               causal, q_offset, k_offset, k_valid, sm_scale,
               static_cast<cudaStream_t>(stream)};
  return dispatch(a, dtype, 1);
}

// The dynamic shared memory a launch of K4 (dkv 0) or K5 (1) at head dim d
// takes, in bytes (0 for a d no width takes).
int ddw_flash_bwd_sm90_smem(int d, int dkv) {
  if (d < 8 || d > kMaxD || d % 8 != 0) return 0;
  switch (sm90_width(d)) {
    case 64: return dkv ? DkvCfg<64>::kSmem : DqCfg<64>::kSmem;
    case 128: return dkv ? DkvCfg<128>::kSmem : DqCfg<128>::kSmem;
    default: return dkv ? DkvSplitCfg::kSmem : DqCfg<256>::kSmem;
  }
}

#endif  // DDW_PART <= 0

}  // extern "C"
