// Flash attention forward for Hopper (K3, the sm90 variant): TMA-fed,
// warp-specialised, with both products on wgmma.
//
// Replaces ddw_tpu/ops/flash_attention.py `_flash_kernel` (:161) /
// `_flash_forward` (:217), the Pallas TPU kernel whose pallas_call is at :232,
// on the main path's attention: bf16, block_k = 128 keys, head dim 64 or 128.
// Every other shape stays on flash_attention.cu (`mma.sync` for bf16 and f16
// blocks of multiples of 16 at other head dims up to 256, CUDA cores for f32
// and the rest); the choice is made in Python (`_fwd_variant` in
// ops/flash_attention.py).
//
// What it computes is K3's online softmax, block for block (the header of
// flash_attention.cu spells it out): per K block of 128 keys, s = (q . k) *
// sm_scale in f32, -1e30 where masked (causal by global position q_offset /
// k_offset, keys at or past k_valid), m_new = max(m, rowmax s), p = exp(s -
// m_new) re-zeroed where s was masked, l = alpha * l + rowsum(p) from the f32
// p, acc = acc * alpha + bf16(p) . v; out = acc / max(l, 1e-30) in bf16 and
// lse = m + log(max(l, 1e-30)) in f32. p is rounded to bf16 against the
// running max after each 128-key block, the TPU kernel's rounding point, so
// the kernel stays within rounding of flash_attention_plain. A row that sees
// no key gives out 0 and lse ~ -1e30. K blocks past every row's causal
// horizon or at or past k_valid are never loaded.
//
// What bounds it: operations. A causal call at the LM's [512, 2048, 64] does
// 4 * D FLOP over each of the 512 * 2048 * 2049 / 2 visible pairs, 2.75e11
// FLOP, 0.278 ms at the 989 TFLOP/s dense bf16 peak, against 537 MB of
// traffic (0.16 ms at 3.35 TB/s). The mma.sync kernel it replaces ran at
// about 85 TFLOP/s: synchronous staging copies that idled the tensor cores,
// mma.sync (which does not reach Hopper's full rate), 64-row tiles.
//
// Design, and what each step does about that:
// - TMA. 3-D tensor maps over [BH, S, D] (innermost first) load 128-byte
//   swizzled boxes of 64 columns, so a row of D = 64 is one box row and D =
//   128 two boxes. A query tile past Sq reads zeros from the map's bounds,
//   never the next head's rows. The maps are encoded on the host through
//   cudaGetDriverEntryPoint (no -lcuda) and passed as __grid_constant__. The
//   synchronous staging copies of the mma.sync kernel are gone.
// - Warp specialisation. Warpgroup 0 is the producer: one thread loads Q,
//   then streams K and V blocks through a ring of stages (3 at D = 64, 2 at
//   D = 128) guarded by mbarriers: a k_full and a v_full per stage
//   (transaction counts), an empty one and a q_empty one that the consumer
//   warps arrive at. setmaxnreg gives its registers to the two consumer
//   warpgroups (24 against 240 a thread), which own 64 query rows each of a
//   128-row tile. Producer and consumers compute a tile's visible K blocks
//   with the same function, so a ring hop's offsets or a padded sequence
//   cannot leave one side waiting.
// - S = Q . K^T with wgmma m64n128k16 (D / 16 of them), A and B read from the
//   swizzled tiles through descriptors, f32 in 64 registers a thread.
// - The softmax in registers; masks only on edge tiles; the row max and sum
//   over the 4 lanes of a row; one FFMA and one ex2 per score.
// - O += P . V with wgmma m64nDk16, A = P from registers: the S accumulator's
//   layout is the A fragment of the k16 slices (FlashAttention-3's identity),
//   rounded to bf16 as it is packed; B is the V tile, MN-major, read with the
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
// - The epilogue writes out and lse for rows below Sq only.
// The C entry returns cudaGetLastError() after the launch, or 1000 plus the
// CUresult when a tensor map cannot be encoded.

#include <cuda.h>  // CUtensorMap and its enums: types only, nothing linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;       // query rows per tile: two consumer warpgroups x 64
constexpr int BN = 128;       // keys per K block (block_k)
constexpr int THREADS = 384;  // warpgroup 0 the producer, 1 and 2 the consumers
constexpr int kGroupHeads = 8;  // heads per group of the tile order
constexpr int CHUNK = 64;     // bf16 columns of a 128-byte swizzled box row
constexpr int ROWB = 128;     // bytes of a box row
constexpr int kEncodeError = 1000;
constexpr uint64_t kWaitBoundNs = 10000000000ull;  // 10 s: see mbar_wait
constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Cfg {
  static constexpr int kChunks = D / CHUNK;
  static constexpr int kStages = D <= 64 ? 3 : 2;
  static constexpr int kQBytes = BM * D * 2;
  static constexpr int kKVBytes = BN * D * 2;  // one K or one V block
  static constexpr int kBarOffset = kQBytes + 2 * kStages * kKVBytes;
  // q_full, q_empty, then k_full, v_full and empty per stage; 1024 bytes of
  // slack to align the tiles to the 128-byte swizzle's 1024-byte atom
  static constexpr int kSmem = kBarOffset + 8 * (2 + 3 * kStages) + 1024;
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

// D[64 x 128] (+)= A[64 x 16] . B[16 x 128], A and B in shared memory (descriptors).
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
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
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// D[64 x 128] += A[64 x 16] . B[16 x 128], A in registers (bf16 pairs), B in shared
// memory, MN-major (the transpose bit set).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}


template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2], const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (D == 64) {
    wgmma_rs_n64(o, a, db);
  } else {
    wgmma_rs_n128(o, a, db);
  }
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

// S = Q . K^T for one K block, issued and committed, not waited for.
template <int D>
__device__ __forceinline__ void issue_qk(float (&sc)[64], uint32_t qa, uint32_t kb) {
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const int c = ks / 4, kc = ks % 4;  // 64-column chunk, k16 slice in it
    wgmma_ss_n128(sc, smem_desc(qa + c * BM * ROWB + kc * 32, 16, 1024),
                  smem_desc(kb + c * BN * ROWB + kc * 32, 16, 1024), ks > 0);
  }
  wgmma_commit();
}

// O += P . V for one K block, issued and committed, not waited for. B is the
// V tile, MN-major: 8-key groups 1024 bytes apart, 64-column chunks BN rows.
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2], const uint32_t (&pa)[BN / 16][4],
                                         uint32_t vb) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
    wgmma_pv<D>(o, pa[kk], smem_desc(vb + kk * 16 * ROWB, BN * ROWB, 1024));
  wgmma_commit();
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

// acc *= alpha, then P to bf16 as the A operand of the k16 slices: keys
// 16 kk .. 16 kk + 15 are the accumulator's 8-column groups 2 kk, 2 kk + 1.
template <int D>
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
  for (int kk = 0; kk < BN / 16; ++kk) {
    pa[kk][0] = pack_bf16x2(sc[8 * kk + 0], sc[8 * kk + 1]);
    pa[kk][1] = pack_bf16x2(sc[8 * kk + 2], sc[8 * kk + 3]);
    pa[kk][2] = pack_bf16x2(sc[8 * kk + 4], sc[8 * kk + 5]);
    pa[kk][3] = pack_bf16x2(sc[8 * kk + 6], sc[8 * kk + 7]);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                      int sq, int sk, int causal, int q_offset, int k_offset,
                      float sm_scale, int k_valid, int n_bh) {
  using C = Cfg<D>;
  constexpr int S = C::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base;  // [chunk][BM rows][64]
  const uint32_t sK = base + C::kQBytes;  // [stage][chunk][BN keys][64]
  const uint32_t sV = sK + S * C::kKVBytes;
  const uint32_t q_full = base + C::kBarOffset, q_empty = q_full + 8;
  const uint32_t k_full = q_empty + 8, v_full = k_full + 8 * S, empty = v_full + 8 * S;

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
      int it = 0;  // K/V blocks loaded so far, across tiles
      for (int t = blockIdx.x, n = 0; t < n_tiles; t += gridDim.x, ++n) {
        int bh, q0, n_kb;
        tile_at(t, bh, q0, n_kb);
        mbar_wait(q_empty, (n & 1) ^ 1);  // the consumers are done with Q
        mbar_expect_tx(q_full, C::kQBytes);
#pragma unroll
        for (int c = 0; c < C::kChunks; ++c)
          tma_load_3d(sQ + c * BM * ROWB, &tq, q_full, c * CHUNK, q0, bh);
        for (int i = 0; i < n_kb; ++i, ++it) {
          const int s = it % S;
          mbar_wait(empty + 8 * s, ((it / S) & 1) ^ 1);  // the first round passes
          mbar_expect_tx(k_full + 8 * s, C::kKVBytes);
#pragma unroll
          for (int c = 0; c < C::kChunks; ++c)
            tma_load_3d(sK + s * C::kKVBytes + c * BN * ROWB, &tk, k_full + 8 * s,
                        c * CHUNK, i * BN, bh);
          mbar_expect_tx(v_full + 8 * s, C::kKVBytes);
#pragma unroll
          for (int c = 0; c < C::kChunks; ++c)
            tma_load_3d(sV + s * C::kKVBytes + c * BN * ROWB, &tv, v_full + 8 * s,
                        c * CHUNK, i * BN, bh);
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
    float sc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) sc[i] = 0.f;
    uint32_t pa[BN / 16][4];

    int it = 0;  // K/V blocks consumed so far, across tiles
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
      for (int i = 0; i < n_kb; ++i, ++it) {
        const int s = it % S;
        const uint32_t phase = (it / S) & 1;
        mbar_wait(k_full + 8 * s, phase);
        issue_qk<D>(sc, qa, sK + s * C::kKVBytes);
        wgmma_wait_all();
        fence_regs(sc);
        softmax(sc, m, l, alpha, rw, k_offset + i * BN, causal, k_valid, sm_scale);
        rescale_and_pack<D>(o, pa, sc, alpha);
        mbar_wait(v_full + 8 * s, phase);
        issue_pv<D>(o, pa, sV + s * C::kKVBytes);
        wgmma_wait_all();
        fence_regs(o);
        fence_regs(pa);
        release(empty + 8 * s);
      }
      release(q_empty);  // no wgmma reads Q any more: the next tile's may land

#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row0 + 8 * h;
        if (r >= sq) continue;
        const size_t row = (size_t)bh * sq + r;
        const float den = fmaxf(l[h], 1e-30f);
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<uint32_t*>(out + row * D + j * 8 + 2 * rw.t) =
              pack_bf16x2(o[4 * j + 2 * h] / den, o[4 * j + 2 * h + 1] / den);
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

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, void* lse, int bh,
           int sq, int sk, int causal, int q_offset, int k_offset, float sm_scale,
           int k_valid, cudaStream_t stream) {
  using C = Cfg<D>;
  CUtensorMap tq, tk, tv;
  if (int err = encode(&tq, q, bh, sq, D, BM)) return err;
  if (int err = encode(&tk, k, bh, sk, D, BN)) return err;
  if (int err = encode(&tv, v, bh, sk, D, BN)) return err;
  auto kernel = flash_fwd_sm90_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return (int)err;
  // one persistent CTA per SM, or one per tile when there are fewer tiles
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
      cudaSuccess)
    return (int)err;
  const int tiles = bh * ((sq + BM - 1) / BM);
  kernel<<<tiles < sms ? tiles : sms, THREADS, C::kSmem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), sq, sk,
      causal, q_offset, k_offset, sm_scale, k_valid, bh);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q [bh, sq, d], k/v [bh, sk, d] contiguous, 16-byte aligned bfloat16; out
// [bh, sq, d] bfloat16, lse [bh, sq] float32. d in {64, 128}; block_k is 128,
// so sk is a multiple of 128; any sq >= 1; k_valid < 0 means no key mask.
// Returns a cudaError_t code, or 1000 + the CUresult of a failed tensor-map
// encode.
int ddw_flash_fwd_sm90(const void* q, const void* k, const void* v, void* out,
                       void* lse, int bh, int sq, int sk, int d, int causal,
                       int q_offset, int k_offset, float sm_scale, int k_valid,
                       void* stream) {
  if (bh < 1 || sq < 1 || sk < 1 || sk % BN != 0 ||
      (long long)bh * ((sq + BM - 1) / BM) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64)
    return launch<64>(q, k, v, out, lse, bh, sq, sk, causal, q_offset, k_offset,
                      sm_scale, k_valid, s);
  if (d == 128)
    return launch<128>(q, k, v, out, lse, bh, sq, sk, causal, q_offset, k_offset,
                       sm_scale, k_valid, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
