// Flash attention forward for Hopper (K3, the sm90 variant): TMA-fed,
// warp-specialised, with both products on wgmma.
//
// Replaces ddw_tpu/ops/flash_attention.py `_flash_kernel` (:161) /
// `_flash_forward` (:217), the Pallas TPU kernel whose pallas_call is at :232,
// for bf16 and f16 with block_k = 128 keys at every head dim d up to 256 that
// is a multiple of 8: the main path's attention (the LM's 64, the lm_wide
// path's 256, ViT's 48). Every other shape stays on flash_attention.cu
// (`mma.sync` for 16-bit blocks of other multiples of 16, CUDA cores for f32
// and above 256); the choice is made in Python (`_fwd_variant` in
// ops/flash_attention.py).
//
// What it computes is K3's online softmax, block for block (the header of
// flash_attention.cu spells it out): per K block of 128 keys, s = (q . k) *
// sm_scale in f32, -1e30 where masked (causal by global position q_offset /
// k_offset, keys at or past k_valid), m_new = max(m, rowmax s), p = exp(s -
// m_new) re-zeroed where s was masked, l = alpha * l + rowsum(p) from the f32
// p, acc = acc * alpha + T(p) . v; out = acc / max(l, 1e-30) in T (bf16 or
// f16) and lse = m + log(max(l, 1e-30)) in f32. p is rounded to T against
// the running max of each whole 128-key block, the TPU kernel's rounding
// point (`p.astype(q.dtype)`), so the kernel stays within rounding of
// flash_attention_plain. A row that sees no key gives out 0 and lse ~ -1e30.
// K blocks past every row's causal horizon or at or past k_valid are never
// loaded. sm_scale is the caller's, from the true head dim.
//
// Widths. Three are compiled, 64, 128 and 256; a call runs at the smallest
// one >= d. The tensor maps take the true d as their innermost dimension and
// d * 2 bytes as the row stride (16-byte aligned only when d % 8 == 0, which
// is why d must be a multiple of 8), and load boxes of 64 columns: columns at
// or past d arrive as zeros through TMA's out-of-bounds fill, add exact
// zeros to every score and give zero output columns, which the epilogue
// does not write (its row stride is d). A 64-column box of a narrower row
// is a box past the row's end, which TMA fills, so no narrower swizzle mode
// is needed: ViT's 96-byte rows of d = 48 run at width 64.
//
// What bounds it: operations at the LM's shapes, bytes at ViT's. A causal
// call at [512, 2048, 64] or [128, 2048, 256] does 4 * d FLOP over each
// visible (query, key) pair, 2.75e11 FLOP, 0.278 ms at the 989 TFLOP/s dense
// 16-bit peak, against 537 MB (0.16 ms at 3.35 TB/s). ViT's [512, 256, 48]
// with 196 valid keys is 4.9e9 FLOP against 45 MB: 0.0134 ms of bytes. The
// mma.sync kernel ran at about 85 TFLOP/s at 64 and 63 at 256: synchronous
// staging copies, mma.sync (which does not reach Hopper's full rate), and at
// 256 two warps that split the output columns and both compute the scores.
//
// What bounds each width on the SM, and what the design does about it:
// - 64 and 128: the softmax beside the tensor cores (one FFMA and one ex2 a
//   score against 4 d FLOP). Two consumer warpgroups interleave on the
//   tensor cores; the ring holds 3 (d 64) or 2 (d 128) K/V blocks ahead,
//   each block's K and V in one stage freed after P . V. Measured on the
//   card in turns (tools/torch_flash_fwd_profile.py --tree), three
//   alternatives are slower at width 64 and are avoided: K and V in
//   separate slots with K freed after S (12-15% non-causal), an epilogue
//   that masks its stores at d when d is the compiled width (10% non-causal,
//   3% causal; 2-4% at 128), and an S product that defines its registers
//   afresh every block (causal).
// - 256: shared memory and registers. Q is 64 KB for a 128-row tile and one
//   128-key K or V block 64 KB, so two stages of each (320 KB) exceed the
//   227 KB a block may use. The ring's slots are 64-key halves of 32 KB: a
//   K or V block spans two, and five slots beside Q (224 KB) let the next
//   block's first K half load while this block's V halves are read. S for
//   128 keys is two m64n64 products (one a half) into the 64 registers of
//   one m64n128 accumulator, so the row max still covers all 128 keys
//   before p is rounded; P . V is 8 k16 steps of m64n256 over the two V
//   halves. A consumer thread holds 128 f32 outputs, 64 f32 scores and 32
//   registers of packed P against the 240 registers setmaxnreg gives it;
//   ptxas fits them without a spill.
// - f16: the same kernel on the `.f16` forms of wgmma, p and out packed to
//   f16 where bf16 packs to bf16, f16 tensor maps.
//
// Design:
// - TMA. 3-D tensor maps over [BH, S, d] (innermost first) load 128-byte
//   swizzled boxes of 64 columns: a row of width W is W / 64 boxes. A query
//   tile past Sq reads zeros from the map's bounds, never the next head's
//   rows. The maps are encoded on the host through cudaGetDriverEntryPoint
//   (no -lcuda) and passed as __grid_constant__.
// - Warp specialisation. Warpgroup 0 is the producer: one thread loads Q,
//   then streams each K block and its V block through a ring guarded by
//   mbarriers: a full one per slot (transaction count), and empty ones that
//   the 8 consumer warps arrive at. At widths 64 and 128 the ring's unit is
//   a stage (3 or 2), one block's K slot and V slot, freed after P . V; at
//   256 it is a 64-key half slot (5), K halves freed as soon as S is
//   computed, V halves after P . V. q_full / q_empty guard Q. setmaxnreg
//   gives the producer's registers to the two consumer warpgroups (24
//   against 240 a thread), which own 64 query rows each of a 128-row tile.
//   Producer and consumers compute a tile's visible K blocks with the same
//   function, so a ring hop's offsets or a padded sequence cannot leave one
//   side waiting. A consumer waits for every slot a product reads before
//   its wgmma fence (a wait between the fence and the products made ptxas
//   inject fences of its own).
// - S = Q . K^T with wgmma m64n128k16 (m64n64k16 a half at 256), A and B read
//   from the swizzled tiles through descriptors, f32 in 64 registers.
// - The softmax in registers; masks only on edge tiles; the row max and sum
//   over the 4 lanes of a row; one FFMA and one ex2 per score.
// - O += P . V with wgmma m64nWk16, A = P from registers: the S accumulator's
//   layout is the A fragment of the k16 slices (FlashAttention-3's identity),
//   rounded to T as it is packed; B is the V slot, MN-major, read with the
//   descriptor's transpose bit.
// - Persistent CTAs, one per SM, walk the query tiles in groups of 8 heads,
//   heaviest causal tiles first within a group: the producer loads the next
//   tile's Q and K/V while the consumers write this one's output, and a
//   group's K and V stay in L2 for all of its tiles.
// - Each consumer warpgroup runs its blocks in series: Q . K^T, the
//   softmax, P . V. Measured on the card, overlapping the softmax with the
//   previous block's P . V, ping-ponging the two warpgroups on named
//   barriers, and a 192-row tile of three warpgroups were no faster at the
//   LM's shapes (PERF.md), so the kernel keeps the simplest schedule.
// - The epilogue writes out and lse for rows below Sq and out's columns
//   below d only.
// The source is compiled as three parts, one a width (ops/_build.py). The C
// entry returns cudaGetLastError() after the launch, or 1000 plus the
// CUresult when a tensor map cannot be encoded.

// nvcc parts: 3

#include <cuda.h>  // CUtensorMap and its enums: types only, nothing linked
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

// Parts: -DDDW_PART=p compiles only width p's kernels (p = 0, 1, 2 for 64,
// 128, 256); part 0 also holds the C entries. Without it one translation
// unit holds everything.
#ifndef DDW_PART
#define DDW_PART -1
#endif

namespace {

constexpr int BM = 128;       // query rows per tile: two consumer warpgroups x 64
constexpr int BN = 128;       // keys per K block (block_k)
constexpr int THREADS = 384;  // warpgroup 0 the producer, 1 and 2 the consumers
constexpr int kGroupHeads = 8;  // heads per group of the tile order
constexpr int CHUNK = 64;     // 16-bit columns of a 128-byte swizzled box row
constexpr int ROWB = 128;     // bytes of a box row
constexpr int kMaxD = 256;
constexpr int kEncodeError = 1000;
constexpr int kNotHere = -1;  // no cudaError_t is negative
constexpr int kPart = DDW_PART;
constexpr uint64_t kWaitBoundNs = 10000000000ull;  // 10 s: see mbar_wait
constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// The compiled width a head dim d (a multiple of 8, at most 256) runs at.
// ops/flash_attention.py `compiled_width("sm90", d)` gives the same.
__host__ __device__ constexpr int sm90_width(int d) {
  return d <= 64 ? 64 : d <= 128 ? 128 : 256;
}

constexpr int part_of(int width) { return width == 64 ? 0 : width == 128 ? 1 : 2; }
static_assert(sm90_width(kMaxD) == kMaxD, "the widest head dim is a compiled width");

template <int D>
struct Cfg {
  static constexpr int kChunks = D / CHUNK;
  static constexpr int kHalves = D > 128 ? 2 : 1;  // slots a K or V block spans
  static constexpr int kSlotKeys = BN / kHalves;
  // K/V slots: 3 (width 64) or 2 (128) stages of a K and a V slot; 5 half
  // slots at 256
  static constexpr int kSlots = D <= 64 ? 6 : D <= 128 ? 4 : 5;
  static constexpr int kQBytes = BM * D * 2;
  static constexpr int kSlotBytes = kSlotKeys * D * 2;
  static constexpr int kBarOffset = kQBytes + kSlots * kSlotBytes;
  // q_full, q_empty, then full and empty per slot (at widths 64 and 128 the
  // first kSlots / 2 empty ones, a stage's, are used); 1024 bytes of slack to
  // align the tiles to the 128-byte swizzle's 1024-byte atom
  static constexpr int kSmem = kBarOffset + 8 * (2 + 2 * kSlots) + 1024;
  static_assert(kSmem <= 232448, "227 KB of shared memory a block");
  static_assert(kSlotBytes % 1024 == 0, "slots on swizzle atoms");
};

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

// ---- mbarriers and TMA ------------------------------------------------------

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

// A position in the ring of N K/V slots: r slots filled (or consumed) so
// far, across tiles. Slot r % N, in round r / N, whose parity is the phase
// its barriers complete in: arithmetic, no branch between the products.
template <int N>
struct Ring {
  uint32_t r = 0;
  __device__ __forceinline__ int slot() const { return r % N; }
  __device__ __forceinline__ uint32_t phase() const { return (r / N) & 1; }
};

// ---- wgmma --------------------------------------------------------------------

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
// predicate's value ("1" accumulates, "0" overwrites without reading); the
// asm's constraints follow.
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

// S[64 x 128] (+)= A[64 x 16] . B[16 x 128] into d, A (Q) and B (K) in shared
// memory, both K-major: kAcc false overwrites d (scale-d 0). d stays bound to
// the same registers from block to block: an S whose first product defined
// them afresh ("=f") measured slower on the card (the header).
template <typename T, bool kAcc>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db) {
  if constexpr (kAcc)
    DDW_WGMMA(T, "m64n128k16", "{" DDW_L64 "}, %64, %65, p, 1, 1, 0, 0;", "1",
              : DDW_OPS64("+f", d, 0) : "l"(da), "l"(db));
  else
    DDW_WGMMA(T, "m64n128k16", "{" DDW_L64 "}, %64, %65, p, 1, 1, 0, 0;", "0",
              : DDW_OPS64("+f", d, 0) : "l"(da), "l"(db));
}

// S[64 x 64] (+)= A[64 x 16] . B[16 x 64] into d[O, O + 32): the scores of one
// 64-key half of a K block (width 256), as wgmma_ss_n128.
template <typename T, int O, bool kAcc>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[64], uint64_t da, uint64_t db) {
  if constexpr (kAcc)
    DDW_WGMMA(T, "m64n64k16", "{" DDW_L32 "}, %32, %33, p, 1, 1, 0, 0;", "1",
              : DDW_OPS32("+f", d, O) : "l"(da), "l"(db));
  else
    DDW_WGMMA(T, "m64n64k16", "{" DDW_L32 "}, %32, %33, p, 1, 1, 0, 0;", "0",
              : DDW_OPS32("+f", d, O) : "l"(da), "l"(db));
}

// O[64 x N] += A[64 x 16] . B[16 x N], A in registers (T pairs), B in shared
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

// 2^x on the special-function unit (subnormal results flush to zero)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The number of K blocks a tile of query rows whose last global position is
// q_last must visit: blocks [0, n). Producer and consumers both call this.
__device__ __forceinline__ int visible_blocks(int sk, int causal, int q_last,
                                              int k_offset, int k_valid) {
  int n = sk / BN;
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

// The per-thread view of a consumer warpgroup's 64 query rows: thread (warp,
// g = lane / 4, t = lane % 4) holds rows 16 warp + g and + 8 of the wgmma
// accumulator layout.
struct Rows {
  int qpos0;     // global position of this thread's first row
  int wq_first;  // global position of this warp's first row
  int t;         // lane % 4: columns 2t, 2t + 1 of every 8-column group
};

// S = Q . K^T over the K slot kb (half h of the block), issued, not
// committed. A 64-column chunk of Q is BM rows, of a K slot kSlotKeys rows;
// the k16 slices are 32 bytes apart in a row.
template <typename T, int D, int h>
__device__ __forceinline__ void issue_qk(float (&sc)[64], uint32_t qa, uint32_t kb) {
  using C = Cfg<D>;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const int c = ks / 4, kc = ks % 4;  // 64-column chunk, k16 slice in it
    const uint64_t da = smem_desc(qa + c * BM * ROWB + kc * 32, 16, 1024);
    const uint64_t db = smem_desc(kb + c * C::kSlotKeys * ROWB + kc * 32, 16, 1024);
    if constexpr (C::kHalves == 1) {
      if (ks == 0)
        wgmma_ss_n128<T, false>(sc, da, db);
      else
        wgmma_ss_n128<T, true>(sc, da, db);
    } else {
      if (ks == 0)
        wgmma_ss_n64<T, h * 32, false>(sc, da, db);
      else
        wgmma_ss_n64<T, h * 32, true>(sc, da, db);
    }
  }
}

// O += P . V over the V slot vb (half h of the block), issued, not committed.
// B is MN-major: 8-key groups 1024 bytes apart, 64-column chunks kSlotKeys
// rows apart; keys 16 kk .. 16 kk + 15 of the block are P's slice kk.
template <typename T, int D, int h>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2],
                                         const uint32_t (&pa)[BN / 16][4], uint32_t vb) {
  using C = Cfg<D>;
  constexpr int kSteps = C::kSlotKeys / 16;
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk)
    wgmma_rs<T>(o, pa[h * kSteps + kk],
                smem_desc(vb + kk * 16 * ROWB, C::kSlotKeys * ROWB, 1024));
}

// The online softmax of one K block in registers: sc holds the f32 scores
// q . k on entry and the f32 p on exit; m and l move on; alpha = exp(m_old -
// m_new). kMask: this warp's 16 rows can meet a mask (the causal diagonal or
// the key-valid edge); the other blocks run no mask code at all.
// The TPU kernel's arithmetic, arranged for the card: the row max is taken
// over the unscaled scores (sm_scale > 0, and rounding is monotonic, so
// max(s) * sm_scale is the max of the scaled scores bit for bit); a masked
// score is -inf here, which leaves m_new = max(m, ...) as the -1e30 mask
// would, since m starts at -1e30, and gives p = 2^-inf = 0 exactly, as
// `_guarded_exp` does. p = 2^(s * sm_scale * log2 e - m_new * log2 e) is one
// FFMA and one ex2. The row max and sum run as 4 independent chains per row,
// then combine (the max is exact in any order; the f32 sum of p is a sum in
// another order, as on any card).
template <bool kMask>
__device__ __forceinline__ void softmax_block(float (&sc)[64], float (&m)[2], float (&l)[2],
                                              float (&alpha)[2], const Rows& rw,
                                              int k_first, int causal, int k_valid,
                                              float sm_scale) {
  float mx[2][4];
#pragma unroll
  for (int c = 0; c < 4; ++c) mx[0][c] = mx[1][c] = -INFINITY;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1;
      if (kMask) {
        const int kpos = k_first + j * 8 + 2 * rw.t + (e & 1);
        const bool keep = (!causal || kpos <= rw.qpos0 + 8 * h) &&
                          (k_valid < 0 || kpos < k_valid);
        if (!keep) sc[4 * j + e] = -INFINITY;
      }
      mx[h][j & 3] = fmaxf(mx[h][j & 3], sc[4 * j + e]);
    }
  const float scale_l2 = sm_scale * kLog2e;
  float m_new[2], m_l2[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float v = fmaxf(fmaxf(mx[h][0], mx[h][1]), fmaxf(mx[h][2], mx[h][3]));
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
    m_new[h] = fmaxf(m[h], v * sm_scale);
    m_l2[h] = m_new[h] * kLog2e;
  }
  float sum[2][4] = {};
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1;
      const float p = ex2(fmaf(sc[4 * j + e], scale_l2, -m_l2[h]));
      sc[4 * j + e] = p;
      sum[h][j & 3] += p;
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float v = (sum[h][0] + sum[h][1]) + (sum[h][2] + sum[h][3]);
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
    alpha[h] = exp2f((m[h] - m_new[h]) * kLog2e);
    l[h] = alpha[h] * l[h] + v;
    m[h] = m_new[h];
  }
}

// softmax_block with the mask only where this warp's rows can meet one.
__device__ __forceinline__ void softmax(float (&sc)[64], float (&m)[2], float (&l)[2],
                                        float (&alpha)[2], const Rows& rw, int k_first,
                                        int causal, int k_valid, float sm_scale) {
  const int k_last = k_first + BN - 1;
  if ((causal && k_last > rw.wq_first) || (k_valid >= 0 && k_last >= k_valid))
    softmax_block<true>(sc, m, l, alpha, rw, k_first, causal, k_valid, sm_scale);
  else
    softmax_block<false>(sc, m, l, alpha, rw, k_first, causal, k_valid, sm_scale);
}

// acc *= alpha, then P to T as the A operand of the k16 slices: keys
// 16 kk .. 16 kk + 15 are the accumulator's 8-column groups 2 kk, 2 kk + 1.
template <typename T, int D>
__device__ __forceinline__ void rescale_and_pack(float (&o)[D / 2], uint32_t (&pa)[BN / 16][4],
                                                 const float (&sc)[64],
                                                 const float (&alpha)[2]) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    o[4 * j + 0] *= alpha[0];
    o[4 * j + 1] *= alpha[0];
    o[4 * j + 2] *= alpha[1];
    o[4 * j + 3] *= alpha[1];
  }
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      pa[kk][e] = Elem<T>::pack(sc[8 * kk + 2 * e], sc[8 * kk + 2 * e + 1]);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv, T* __restrict__ out,
                      float* __restrict__ lse, int sq, int sk, int d, int causal,
                      int q_offset, int k_offset, float sm_scale, int k_valid,
                      int n_bh) {
  using C = Cfg<D>;
  constexpr int H = C::kHalves, NS = C::kSlots;
  // units of the ring: stages of a K and a V slot (H == 1), or slots
  constexpr int NR = H == 1 ? NS / 2 : NS;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base;               // [chunk][BM rows][64]
  const uint32_t sKV = base + C::kQBytes;  // [slot][chunk][kSlotKeys keys][64]
  const uint32_t q_full = base + C::kBarOffset, q_empty = q_full + 8;
  const uint32_t full = q_empty + 8, empty = full + 8 * NS;

  // The CTA walks tiles blockIdx.x, + gridDim.x, ... The tile order: groups
  // of kGroupHeads heads, and in a group the heaviest causal tiles first (all
  // its heads' last query tile, then the one before, ...); a group's K and V
  // stay in L2 while its tiles run. Producer and consumers compute each
  // tile's visible K blocks with the same function.
  const int n_qt = (sq + BM - 1) / BM, n_tiles = n_bh * n_qt;
  const int group = min(kGroupHeads, n_bh);
  auto tile_at = [&](int t, int& bh, int& q0, int& n_kb) {
    const int g0 = t / (group * n_qt) * group;  // the group's first head
    const int gn = min(group, n_bh - g0);       // heads in the group
    const int r = t - g0 * n_qt;
    bh = g0 + r % gn;
    q0 = (n_qt - 1 - r / gn) * BM;
    n_kb = visible_blocks(sk, causal, q_offset + min(q0 + BM, sq) - 1, k_offset, k_valid);
  };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, 8);  // one arrival per consumer warp
    for (int s = 0; s < NS; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // One K or V slot's rows [row, row + kSlotKeys) of head bh, by TMA, onto
  // the slot's full barrier.
  auto load_slot = [&](const CUtensorMap* map, int slot, int row, int bh) {
    const uint32_t dst = sKV + slot * C::kSlotBytes, bar = full + 8 * slot;
    mbar_expect_tx(bar, C::kSlotBytes);
#pragma unroll
    for (int c = 0; c < C::kChunks; ++c)
      tma_load_3d(dst + c * C::kSlotKeys * ROWB, map, bar, c * CHUNK, row, bh);
  };

  if (threadIdx.x < 128) {
    // ---- the producer warpgroup: one thread issues every load ---------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      Ring<NR> ring;
      for (int t = blockIdx.x, n = 0; t < n_tiles; t += gridDim.x, ++n) {
        int bh, q0, n_kb;
        tile_at(t, bh, q0, n_kb);
        mbar_wait(q_empty, (n & 1) ^ 1);  // the consumers are done with Q
        mbar_expect_tx(q_full, C::kQBytes);
#pragma unroll
        for (int c = 0; c < C::kChunks; ++c)
          tma_load_3d(sQ + c * BM * ROWB, &tq, q_full, c * CHUNK, q0, bh);
        for (int i = 0; i < n_kb; ++i) {
          // the first round of every empty barrier passes (parity 1)
          if constexpr (H == 1) {  // stage s: K slot s, V slot NR + s
            const int s = ring.slot();
            mbar_wait(empty + 8 * s, ring.phase() ^ 1);
            load_slot(&tk, s, i * BN, bh);
            load_slot(&tv, NR + s, i * BN, bh);
            ++ring.r;
          } else {  // the K halves' slots, then the V halves'
#pragma unroll
            for (int kv = 0; kv < 2; ++kv)
#pragma unroll
              for (int h = 0; h < H; ++h, ++ring.r) {
                mbar_wait(empty + 8 * ring.slot(), ring.phase() ^ 1);
                load_slot(kv ? &tv : &tk, ring.slot(), i * BN + h * C::kSlotKeys, bh);
              }
          }
        }
      }
    }
  } else {
    // ---- two consumer warpgroups, 64 query rows each --------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int cw = threadIdx.x / 128 - 1;
    const int warp = threadIdx.x % 128 / 32, lane = threadIdx.x % 32;
    const uint32_t qa = sQ + cw * 64 * ROWB;
    auto release = [&](uint32_t bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };
    float sc[64];  // bound to the S products' registers: see wgmma_ss_n128
#pragma unroll
    for (int i = 0; i < 64; ++i) sc[i] = 0.f;
    uint32_t pa[BN / 16][4];

    Ring<NR> ring;
    for (int t = blockIdx.x, n = 0; t < n_tiles; t += gridDim.x, ++n) {
      int bh, q0, n_kb;
      tile_at(t, bh, q0, n_kb);
      const int row0 = q0 + cw * 64 + warp * 16 + lane / 4;  // rows row0, row0 + 8
      const Rows rw{q_offset + row0, q_offset + q0 + cw * 64 + warp * 16, lane % 4};
      float o[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
      float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f}, alpha[2];

      mbar_wait(q_full, n & 1);
      // Both warpgroups run all n_kb blocks of the tile; a block in one's
      // causal future is an exact no-op for it.
      for (int i = 0; i < n_kb; ++i) {
        // The block's K and V slots, and the phases they fill in: stage s's
        // (H == 1), or the ring's next 2H slots, K halves first (H == 2).
        int ks[H], vs[H];
        uint32_t kph[H], vph[H];
        if constexpr (H == 1) {
          ks[0] = ring.slot();
          vs[0] = NR + ks[0];
          kph[0] = vph[0] = ring.phase();
          ++ring.r;
        } else {
#pragma unroll
          for (int h = 0; h < H; ++h, ++ring.r) {
            ks[h] = ring.slot();
            kph[h] = ring.phase();
          }
#pragma unroll
          for (int h = 0; h < H; ++h, ++ring.r) {
            vs[h] = ring.slot();
            vph[h] = ring.phase();
          }
        }
        // S from the K slots
#pragma unroll
        for (int h = 0; h < H; ++h) mbar_wait(full + 8 * ks[h], kph[h]);
        wgmma_fence();
        issue_qk<T, D, 0>(sc, qa, sKV + ks[0] * C::kSlotBytes);
        if constexpr (H == 2) issue_qk<T, D, 1>(sc, qa, sKV + ks[1] * C::kSlotBytes);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(sc);
        if constexpr (H == 2) {  // the K halves are read: the next block's may land
#pragma unroll
          for (int h = 0; h < H; ++h) release(empty + 8 * ks[h]);
        }
        softmax(sc, m, l, alpha, rw, k_offset + i * BN, causal, k_valid, sm_scale);
        rescale_and_pack<T, D>(o, pa, sc, alpha);
        // O from the V slots
#pragma unroll
        for (int h = 0; h < H; ++h) mbar_wait(full + 8 * vs[h], vph[h]);
        wgmma_fence();
        issue_pv<T, D, 0>(o, pa, sKV + vs[0] * C::kSlotBytes);
        if constexpr (H == 2) issue_pv<T, D, 1>(o, pa, sKV + vs[1] * C::kSlotBytes);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(o);
        fence_regs(pa);
        if constexpr (H == 1) {
          release(empty + 8 * ks[0]);  // the stage
        } else {
#pragma unroll
          for (int h = 0; h < H; ++h) release(empty + 8 * vs[h]);
        }
      }
      release(q_empty);  // no wgmma reads Q any more: the next tile's may land

      // out's rows are d values apart; columns at or past d are not written
      // (d % 8 == 0, so an 8-column group lies wholly below d or at or past it)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row0 + 8 * h;
        if (r >= sq) continue;
        const size_t row = (size_t)bh * sq + r;
        const float den = fmaxf(l[h], 1e-30f);
        if (d == D) {  // the compiled width: unmasked (measured faster, header)
          T* orow = out + row * D + 2 * rw.t;
#pragma unroll
          for (int j = 0; j < D / 8; ++j)
            *reinterpret_cast<uint32_t*>(orow + j * 8) =
                Elem<T>::pack(o[4 * j + 2 * h] / den, o[4 * j + 2 * h + 1] / den);
        } else {
          T* orow = out + row * d + 2 * rw.t;
#pragma unroll
          for (int j = 0; j < D / 8; ++j)
            if (j * 8 < d)
              *reinterpret_cast<uint32_t*>(orow + j * 8) =
                  Elem<T>::pack(o[4 * j + 2 * h] / den, o[4 * j + 2 * h + 1] / den);
        }
        if (rw.t == 0) lse[row] = m[h] + logf(den);
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

struct FwdArgs {
  const void *q, *k, *v;
  void *out, *lse;
  int bh, sq, sk, d, causal, q_offset, k_offset;
  float sm_scale;
  int k_valid;
  cudaStream_t stream;
};

template <typename T, int D>
int launch(const FwdArgs& a) {
  using C = Cfg<D>;
  CUtensorMap tq, tk, tv;
  if (int err = encode<T>(&tq, a.q, a.bh, a.sq, a.d, BM)) return err;
  if (int err = encode<T>(&tk, a.k, a.bh, a.sk, a.d, C::kSlotKeys)) return err;
  if (int err = encode<T>(&tv, a.v, a.bh, a.sk, a.d, C::kSlotKeys)) return err;
  auto kernel = flash_fwd_sm90_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return (int)err;
  // one persistent CTA per SM, or one per tile when there are fewer tiles
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
      cudaSuccess)
    return (int)err;
  const int tiles = a.bh * ((a.sq + BM - 1) / BM);
  kernel<<<tiles < sms ? tiles : sms, THREADS, C::kSmem, a.stream>>>(
      tq, tk, tv, static_cast<T*>(a.out), static_cast<float*>(a.lse), a.sq, a.sk, a.d,
      a.causal, a.q_offset, a.k_offset, a.sm_scale, a.k_valid, a.bh);
  return (int)cudaGetLastError();
}

// Width D's kernels in bf16 (dtype 1) or f16 (2), or kNotHere when another
// part holds them.
template <int D>
int run(const FwdArgs& a, int dtype) {
  if constexpr (kPart >= 0 && kPart != part_of(D)) {
    return kNotHere;
  } else {
    if (dtype == 1) return launch<__nv_bfloat16, D>(a);
    if (dtype == 2) return launch<__half, D>(a);
    return (int)cudaErrorInvalidValue;
  }
}

int run_width(const FwdArgs& a, int dtype) {
  switch (sm90_width(a.d)) {
    case 64: return run<64>(a, dtype);
    case 128: return run<128>(a, dtype);
    default: return run<256>(a, dtype);
  }
}

}  // namespace

extern "C" {

#if DDW_PART >= 0
#define DDW_CAT_(a, b) a##b
#define DDW_CAT(a, b) DDW_CAT_(a, b)
// This part's width (kNotHere for the others'); args is a FwdArgs.
int DDW_CAT(ddw_flash_fwd_sm90_part, DDW_PART)(const void* args, int dtype) {
  return run_width(*static_cast<const FwdArgs*>(args), dtype);
}
int ddw_flash_fwd_sm90_part0(const void* args, int dtype);
int ddw_flash_fwd_sm90_part1(const void* args, int dtype);
int ddw_flash_fwd_sm90_part2(const void* args, int dtype);
#endif

#if DDW_PART <= 0

// q [bh, sq, d], k/v [bh, sk, d] contiguous, 16-byte aligned, in bfloat16
// (dtype 1) or float16 (2); out [bh, sq, d] in that dtype, lse [bh, sq]
// float32. d a multiple of 8 up to 256, run at the compiled width 64, 128 or
// 256 (sm90_width); block_k is 128, so sk is a multiple of 128; any sq >= 1;
// sm_scale the caller's (from the true d); k_valid < 0 means no key mask.
// Returns a cudaError_t code, or 1000 + the CUresult of a failed tensor-map
// encode.
int ddw_flash_fwd_sm90(const void* q, const void* k, const void* v, void* out,
                       void* lse, int bh, int sq, int sk, int d, int dtype, int causal,
                       int q_offset, int k_offset, float sm_scale, int k_valid,
                       void* stream) {
  if (bh < 1 || sq < 1 || sk < 1 || sk % BN != 0 || d < 8 || d > kMaxD || d % 8 != 0 ||
      (dtype != 1 && dtype != 2) ||
      (long long)bh * ((sq + BM - 1) / BM) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const FwdArgs a{q, k, v, out, lse, bh, sq, sk, d, causal, q_offset, k_offset,
                  sm_scale, k_valid, static_cast<cudaStream_t>(stream)};
#if DDW_PART < 0
  return run_width(a, dtype);
#else
  using Part = int (*)(const void*, int);
  const Part parts[] = {ddw_flash_fwd_sm90_part0, ddw_flash_fwd_sm90_part1,
                        ddw_flash_fwd_sm90_part2};
  return parts[part_of(sm90_width(d))](&a, dtype);
#endif
}

// The dynamic shared memory a launch at head dim d takes, in bytes (0 for a
// d no width takes).
int ddw_flash_fwd_sm90_smem(int d) {
  if (d < 8 || d > kMaxD || d % 8 != 0) return 0;
  switch (sm90_width(d)) {
    case 64: return Cfg<64>::kSmem;
    case 128: return Cfg<128>::kSmem;
    default: return Cfg<256>::kSmem;
  }
}

#endif  // DDW_PART <= 0

}  // extern "C"
