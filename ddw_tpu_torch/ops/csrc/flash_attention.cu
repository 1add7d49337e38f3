// Flash attention for Hopper: the forward (K3), online-softmax attention that
// never writes the score matrix to device memory, and the backward (K4 dQ,
// K5 dK/dV, further below), which rebuilds p from the saved logsumexp.
//
// K3 replaces ddw_tpu/ops/flash_attention.py `_flash_kernel` / `_flash_forward`
// (the Pallas TPU kernel). For q [BH, Sq, D] and k, v [BH, Sk, D] it computes
// what that kernel computes, one K block of `block_k` keys at a time:
//   s     = (q . k) * sm_scale                      f32 (products of the input
//                                                   dtype, f32 accumulation)
//   s     = -1e30 where masked: causal by global position
//           (k_offset + key <= q_offset + query) and keys >= k_valid
//   m_new = max(m, rowmax(s));  p = exp(s - m_new), re-zeroed where s was
//           masked (`_guarded_exp`);  alpha = exp(m - m_new)
//   l     = alpha * l + rowsum(p)                    (p in f32)
//   acc   = acc * alpha + round_to_input_dtype(p) . v
// and at the end out = acc / max(l, 1e-30) in the input dtype and
// lse = m + log(max(l, 1e-30)) in f32. A row that sees no key keeps m = -1e30
// and l = 0, so it gives out 0 and lse ~ -1e30, never NaN. The running-max
// rescale happens at the same block_k granularity as the TPU kernel (the bf16
// rounding of p depends on the max it was taken against), so the kernel stays
// within rounding of the plain PyTorch version in flash_attention.py, which
// follows the TPU kernel step for step. K blocks wholly in the future of every
// query row of a block, or wholly at or past k_valid, are skipped: their
// update would be an exact no-op.
//
// What bounds it: operations. A causal call does about 2 * 2 * BH * Sq * Sk *
// D / 2 multiply-adds' worth of FLOPs against 4 * BH * S * D * bytes of
// traffic; at the LM's shape [512, 2048, 64] bf16 that is 2.75e11 FLOP (0.28 ms
// at the 989 TFLOP/s dense bf16 peak) against 537 MB (0.16 ms at 3.35 TB/s).
//
// Design: simple and right first, in two paths. bf16 with block_k a multiple
// of 16 (every block flash_mha picks for bf16) runs both products on the
// tensor cores with mma.sync m16n8k16 and f32 accumulation (the second
// kernel below). f32, and bf16 blocks of other sizes, run in f32 on the CUDA
// cores (FFMA), the first kernel: one block of 256 threads owns BQ = 64 query
// rows of one (batch*head), a 16 x 16 thread grid, ty holding 4 rows and tx a
// set of key columns (scores) or head-dim columns (output). Q is staged once,
// transposed, in shared memory; each K/V block of up to KT = 128 keys is
// staged as f32 (K transposed), the 4 x 8 score tile of a thread is a register
// tile, row max and row sum are butterfly shuffles over the 16 tx lanes of a
// half warp (every lane ends with the same bits), and the rounded p goes
// through shared memory (aliasing the dead K tile) for the P.V product.
// Shared memory: (64 D + max(128 D, 64 * 132) + 128 D) * 4 bytes, 81 KB at
// D = 64, so two blocks fit on an SM. Neither path uses wgmma, TMA or
// pipelining: the main path's attention (bf16, block_k = 128, head dim 64 or
// 128) runs on the Hopper kernel of flash_fwd_sm90.cu instead, and these two
// keep the other shapes (ops/flash_attention.py `_fwd_variant`). The C entry
// returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int KT = 128;       // key columns per staged tile (block_k <= KT)
constexpr int PS = KT + 4;    // row stride of the p tile (bank spread)
constexpr int THREADS = 256;  // 16 row groups (ty) x 16 column lanes (tx)
constexpr float kNeg = -1e30f;

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// V elements of T loaded as one aligned 16-byte vector.
template <typename T, int V>
struct alignas(16) Pack {
  T v[V];
};

template <int D>
constexpr int smem_floats() {
  return D * BQ + (D * KT > BQ * PS ? D * KT : BQ * PS) + KT * D;
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Copy `rows` rows (of `valid` real ones, the rest zero) of a [*, D] tensor
// into shared memory as f32, transposed to [D][stride] when kTrans.
template <typename T, int D, bool kTrans>
__device__ __forceinline__ void stage(const T* __restrict__ src, float* dst,
                                      int rows, int valid, int stride) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int DV = D / VEC;
  for (int idx = threadIdx.x; idx < rows * DV; idx += THREADS) {
    const int r = kTrans ? idx % rows : idx / DV;
    const int dv = kTrans ? idx / rows : idx % DV;
    Pack<T, VEC> pk;
    if (r < valid) {
      pk = *reinterpret_cast<const Pack<T, VEC>*>(src + (size_t)r * D + dv * VEC);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) pk.v[e] = from_f32<T>(0.f);
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const int d = dv * VEC + e;
      dst[kTrans ? d * stride + r : r * stride + d] = to_f32<T>(pk.v[e]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, D <= 64 ? 2 : 1)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int sq, int sk, int causal,
                 int q_offset, int k_offset, float sm_scale, int block_k,
                 int k_valid) {
  // head-dim columns of a thread in the output: NCH chunks of W adjacent
  // columns, chunk c at c * 16 * W + tx * W (conflict-free vector reads; at
  // D = 48, W = 3 columns read one by one: 12-byte runs are not aligned)
  constexpr int NV = D / 16;
  constexpr int W = NV < 4 ? NV : 4;
  constexpr int NCH = NV / W;
  static_assert(NV % W == 0, "head dim a multiple of 16");

  extern __shared__ float4 smem_raw[];
  float* Qt = reinterpret_cast<float*>(smem_raw);  // [D][BQ]
  float* KtP = Qt + D * BQ;                        // [D][KT], then [BQ][PS]
  float* Vs = KtP + (D * KT > BQ * PS ? D * KT : BQ * PS);  // [KT][D]

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int bh = blockIdx.x;
  const int nq = gridDim.y;
  const int q0 = (nq - 1 - blockIdx.y) * BQ;  // heaviest causal tiles first
  const int qrows = min(BQ, sq - q0);
  const bool masked = causal || k_valid >= 0;

  stage<T, D, true>(q + ((size_t)bh * sq + q0) * D, Qt, BQ, qrows, BQ);

  float m[4], l[4], acc[4][NV];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NV; ++c) acc[i][c] = 0.f;
  }

  const int q_last = q_offset + q0 + qrows - 1;
  const int kte = (block_k + 3) & ~3;  // P.V loop length (zero-padded tail)
  const int n_kb = sk / block_k;
  for (int kb = 0; kb < n_kb; ++kb) {
    const int k_first = k_offset + kb * block_k;
    if (causal && k_first > q_last) break;
    if (k_valid >= 0 && k_first >= k_valid) break;
    const size_t kv_base = ((size_t)bh * sk + (size_t)kb * block_k) * D;

    __syncthreads();  // the previous block's readers of KtP and Vs are done
    stage<T, D, true>(k + kv_base, KtP, KT, block_k, KT);
    stage<T, D, false>(v + kv_base, Vs, KT, block_k, D);
    __syncthreads();

    // s[i][j]: row ty*4+i, key column (j/4)*64 + tx*4 + j%4
    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(Qt + d * BQ + ty * 4);
      const float4 k0 = *reinterpret_cast<const float4*>(KtP + d * KT + tx * 4);
      const float4 k1 = *reinterpret_cast<const float4*>(KtP + d * KT + 64 + tx * 4);
      const float qa[4] = {qv.x, qv.y, qv.z, qv.w};
      const float ka[8] = {k0.x, k0.y, k0.z, k0.w, k1.x, k1.y, k1.z, k1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(qa[i], ka[j], s[i][j]);
    }

    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q_offset + q0 + ty * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = (j >> 2) * 64 + tx * 4 + (j & 3);
        const int kpos = k_first + c;
        float x = s[i][j] * sm_scale;
        if (masked) {
          const bool keep = (!causal || kpos <= qpos) && (k_valid < 0 || kpos < k_valid);
          if (!keep) x = kNeg;
        }
        if (c >= block_k) x = -INFINITY;  // not a key of this block
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float p = expf(s[i][j] - m_new);
        if (masked && !(s[i][j] > kNeg / 2)) p = 0.f;  // exp(-inf) is 0 too
        s[i][j] = p;
        sum += p;
      }
      alpha[i] = expf(m[i] - m_new);
      l[i] = alpha[i] * l[i] + half_warp_sum(sum);
      m[i] = m_new;
    }

    __syncthreads();  // every thread is done reading the K tile
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float* row = KtP + (ty * 4 + i) * PS + tx * 4;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float4 pv;
        pv.x = to_f32<T>(from_f32<T>(s[i][h * 4 + 0]));
        pv.y = to_f32<T>(from_f32<T>(s[i][h * 4 + 1]));
        pv.z = to_f32<T>(from_f32<T>(s[i][h * 4 + 2]));
        pv.w = to_f32<T>(from_f32<T>(s[i][h * 4 + 3]));
        *reinterpret_cast<float4*>(row + h * 64) = pv;
      }
    }
    __syncthreads();

    float t[4][NV];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < NV; ++c) t[i][c] = 0.f;
    for (int kk = 0; kk < kte; kk += 4) {
      float pa[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 pv = *reinterpret_cast<const float4*>(KtP + (ty * 4 + i) * PS + kk);
        pa[i][0] = pv.x; pa[i][1] = pv.y; pa[i][2] = pv.z; pa[i][3] = pv.w;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* vrow = Vs + (kk + e) * D + tx * W;
        float va[NV];
#pragma unroll
        for (int ch = 0; ch < NCH; ++ch) {
          if constexpr (W == 4) {
            const float4 x = *reinterpret_cast<const float4*>(vrow + ch * 16 * W);
            va[ch * 4 + 0] = x.x; va[ch * 4 + 1] = x.y;
            va[ch * 4 + 2] = x.z; va[ch * 4 + 3] = x.w;
          } else if constexpr (W == 2) {
            const float2 x = *reinterpret_cast<const float2*>(vrow + ch * 16 * W);
            va[ch * 2 + 0] = x.x; va[ch * 2 + 1] = x.y;
          } else {
#pragma unroll
            for (int e2 = 0; e2 < W; ++e2) va[ch * W + e2] = vrow[ch * 16 * W + e2];
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < NV; ++c) t[i][c] = fmaf(pa[i][e], va[c], t[i][c]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < NV; ++c) acc[i][c] = acc[i][c] * alpha[i] + t[i][c];
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r >= qrows) continue;
    const size_t row = (size_t)bh * sq + q0 + r;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      const int col = (c / W) * 16 * W + tx * W + (c % W);
      out[row * D + col] = from_f32<T>(acc[i][c] / denom);
    }
    if (tx == 0) lse[row] = m[i] + logf(denom);
  }
}

// ---- bf16 on the tensor cores: mma.sync m16n8k16, f32 accumulation ---------
//
// The same online softmax, block for block, with both products on the tensor
// cores. A block of 4 warps owns MQ = 64 query rows, 16 per warp; Q and each
// K and V block are staged in bf16 with 16-byte copies, rows padded by 8
// elements so that the ldmatrix loads of a warp hit 32 distinct banks; K^T
// and V fragments come from ldmatrix (V with .trans). A thread of a warp
// holds, in the mma.sync accumulator layout (g = lane / 4, t = lane % 4),
// rows g and g + 8 and columns 2t, 2t + 1 of every 8-wide tile; the row max
// and row sum are shuffles over the 4 lanes of a row, and p = exp2((s - m) *
// log2 e). The f32 score tile becomes the A operand of P.V in registers
// (FA2's layout identity: two 16x8 accumulator tiles are one 16x16 A
// fragment), rounded to bf16 as the TPU kernel rounds p. Shared memory:
// (64 + 2 * 128) * (D + 8) * 2 bytes, 45 KB at D = 64.

constexpr int MQ = 64;          // query rows per block: 4 warps x 16
constexpr int MTHREADS = 128;
constexpr int MPAD = 8;         // bf16 elements of row padding
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
constexpr int mma_smem_bytes() {
  return (MQ + 2 * KT) * (D + MPAD) * 2;
}

__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16 (nearest even), the lower column in the low half
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Four 8x8 bf16 matrices from shared memory; lane l gives the address of row
// l % 8 of matrix l / 8 and receives row l / 4, columns 2 (l % 4) + {0, 1}
// of each (with .trans: column l / 4, rows 2 (l % 4) + {0, 1}).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4],
                                        const __nv_bfloat16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// Two 8x8 bf16 matrices: lanes 0-15 give the row addresses (row l % 8 of
// matrix l / 8); every lane receives row l / 4, columns 2 (l % 4) + {0, 1}.
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2],
                                        const __nv_bfloat16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const __nv_bfloat16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// Copy `rows` rows (of `valid` real ones, the rest zero) of a [*, D] bf16
// tensor into shared memory with row stride `stride`, 16 bytes a thread.
template <int D>
__device__ __forceinline__ void stage_bf16(const __nv_bfloat16* __restrict__ src,
                                           __nv_bfloat16* dst, int rows,
                                           int valid, int stride) {
  constexpr int DV = D / 8;
  for (int idx = threadIdx.x; idx < rows * DV; idx += MTHREADS) {
    const int r = idx / DV, dv = idx % DV;
    uint4 pk = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid)
      pk = *reinterpret_cast<const uint4*>(src + (size_t)r * D + dv * 8);
    *reinterpret_cast<uint4*>(dst + r * stride + dv * 8) = pk;
  }
}

template <int D>
__global__ void __launch_bounds__(MTHREADS, D <= 64 ? 3 : 2)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                     int sq, int sk, int causal, int q_offset, int k_offset,
                     float sm_scale, int block_k, int k_valid) {
  constexpr int QS = D + MPAD;   // row stride of the Q, K and V tiles
  constexpr int KS = D / 16;     // k-steps of Q.K^T
  constexpr int NT = KT / 8;     // 8-key tiles of a K block
  constexpr int DT = D / 8;      // 8-wide head-dim tiles of P.V
  static_assert(DT % 2 == 0, "V fragments are loaded in pairs");

  extern __shared__ uint4 smem_mma[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_mma);
  __nv_bfloat16* Ks = Qs + MQ * QS;
  __nv_bfloat16* Vs = Ks + KT * QS;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * MQ;  // heaviest tiles first
  const int qrows = min(MQ, sq - q0);

  stage_bf16<D>(q + ((size_t)bh * sq + q0) * D, Qs, MQ, qrows, QS);
  __syncthreads();
  uint32_t qf[KS][4];
  const __nv_bfloat16* qw = Qs + warp * 16 * QS + 2 * t;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    qf[ks][0] = lds32(qw + g * QS + ks * 16);
    qf[ks][1] = lds32(qw + (g + 8) * QS + ks * 16);
    qf[ks][2] = lds32(qw + g * QS + ks * 16 + 8);
    qf[ks][3] = lds32(qw + (g + 8) * QS + ks * 16 + 8);
  }

  float o[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
  const int qpos0 = q_offset + q0 + warp * 16 + g;  // rows qpos0, qpos0 + 8
  const int q_last = q_offset + q0 + qrows - 1;
  const int n_kb = sk / block_k;
  for (int kb = 0; kb < n_kb; ++kb) {
    const int k_first = k_offset + kb * block_k;
    if (causal && k_first > q_last) break;
    if (k_valid >= 0 && k_first >= k_valid) break;
    const size_t kv_base = ((size_t)bh * sk + (size_t)kb * block_k) * D;

    __syncthreads();  // the previous block's readers of Ks and Vs are done
    stage_bf16<D>(k + kv_base, Ks, KT, block_k, QS);
    stage_bf16<D>(v + kv_base, Vs, KT, block_k, QS);
    __syncthreads();

    // B fragments of K^T: matrices (keys j*8.., d 16 ks + 0 / 8 / 16 / 24)
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
      if (j * 8 < block_k) {
        const __nv_bfloat16* kr = Ks + (j * 8 + (lane & 7)) * QS + (lane >> 3) * 8;
#pragma unroll
        for (int ks = 0; ks + 1 < KS; ks += 2) {
          uint32_t b[4];
          ldsm_x4(b, kr + ks * 16);
          mma_16816(s[j], qf[ks], b[0], b[1]);
          mma_16816(s[j], qf[ks + 1], b[2], b[3]);
        }
        if constexpr (KS % 2 == 1) {  // D = 48: the last 16 of the head dim
          uint32_t b[2];
          ldsm_x2(b, kr + (KS - 1) * 16);
          mma_16816(s[j], qf[KS - 1], b[0], b[1]);
        }
      }
    }

    // masks only where this warp's 16 rows can meet one: the causal
    // diagonal, the key-valid edge, or a block narrower than the tile
    const int k_last = k_first + block_k - 1;
    const bool edge = (causal && k_last > qpos0 - g) ||
                      (k_valid >= 0 && k_last >= k_valid) || block_k < KT;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        float x = s[j][e] * sm_scale;
        if (edge) {
          const int c = j * 8 + 2 * t + (e & 1);
          const int kpos = k_first + c;
          const bool keep = (!causal || kpos <= qpos0 + 8 * h) &&
                            (k_valid < 0 || kpos < k_valid);
          if (!keep) x = kNeg;
          if (c >= block_k) x = -INFINITY;  // not a key of this block
        }
        s[j][e] = x;
        mx[h] = fmaxf(mx[h], x);
      }
    float alpha[2], sum[2] = {0.f, 0.f}, m_new[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      m_new[h] = fmaxf(m[h], mx[h]);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        float p = exp2f((s[j][e] - m_new[h]) * kLog2e);
        if (edge && !(s[j][e] > kNeg / 2)) p = 0.f;  // exp(-inf) is 0 too
        s[j][e] = p;
        sum[h] += p;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
      alpha[h] = exp2f((m[h] - m_new[h]) * kLog2e);
      l[h] = alpha[h] * l[h] + sum[h];
      m[h] = m_new[h];
    }
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      if (kk * 16 >= block_k) break;
      const uint32_t a[4] = {pack_bf16x2(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16x2(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      // B fragments of V, transposed on load: matrices (keys 16 kk + 0 / 8,
      // d 8 j) and (keys 16 kk + 0 / 8, d 8 (j + 1))
      const __nv_bfloat16* vr = Vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * QS
                                + (lane >> 4) * 8;
#pragma unroll
      for (int j = 0; j < DT; j += 2) {
        uint32_t b[4];
        ldsm_x4_trans(b, vr + j * 8);
        mma_16816(o[j], a, b[0], b[1]);
        mma_16816(o[j + 1], a, b[2], b[3]);
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = warp * 16 + g + 8 * h;
    if (r >= qrows) continue;
    const size_t row = (size_t)bh * sq + q0 + r;
    const float den = fmaxf(l[h], 1e-30f);
#pragma unroll
    for (int j = 0; j < DT; ++j)
      *reinterpret_cast<uint32_t*>(out + row * D + j * 8 + 2 * t) =
          pack_bf16x2(o[j][2 * h] / den, o[j][2 * h + 1] / den);
    if (t == 0) lse[row] = m[h] + logf(den);
  }
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, void* out,
               void* lse, int bh, int sq, int sk, int causal, int q_offset,
               int k_offset, float sm_scale, int block_k, int k_valid,
               cudaStream_t stream) {
  const int smem = mma_smem_bytes<D>();
  auto kernel = flash_fwd_mma_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(bh, (sq + MQ - 1) / MQ);
  kernel<<<grid, MTHREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(lse), sq, sk, causal, q_offset, k_offset, sm_scale,
      block_k, k_valid);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, void* lse,
           int bh, int sq, int sk, int causal, int q_offset, int k_offset,
           float sm_scale, int block_k, int k_valid, cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  auto kernel = flash_fwd_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(bh, (sq + BQ - 1) / BQ);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), static_cast<float*>(lse),
      sq, sk, causal, q_offset, k_offset, sm_scale, block_k, k_valid);
  return (int)cudaGetLastError();
}

// bf16 with block_k a multiple of 16 runs on the tensor cores; f32, and bf16
// blocks of other sizes, on the CUDA cores.
template <typename T, int D>
int launch_any(const void* q, const void* k, const void* v, void* out,
               void* lse, int bh, int sq, int sk, int causal, int q_offset,
               int k_offset, float sm_scale, int block_k, int k_valid,
               cudaStream_t stream) {
  if (sizeof(T) == 2 && block_k % 16 == 0)
    return launch_mma<D>(q, k, v, out, lse, bh, sq, sk, causal, q_offset,
                         k_offset, sm_scale, block_k, k_valid, stream);
  return launch<T, D>(q, k, v, out, lse, bh, sq, sk, causal, q_offset,
                      k_offset, sm_scale, block_k, k_valid, stream);
}

template <typename T>
int dispatch_d(int d, const void* q, const void* k, const void* v, void* out,
               void* lse, int bh, int sq, int sk, int causal, int q_offset,
               int k_offset, float sm_scale, int block_k, int k_valid,
               cudaStream_t stream) {
  switch (d) {
    case 32:
      return launch_any<T, 32>(q, k, v, out, lse, bh, sq, sk, causal,
                               q_offset, k_offset, sm_scale, block_k, k_valid,
                               stream);
    case 48:
      return launch_any<T, 48>(q, k, v, out, lse, bh, sq, sk, causal,
                               q_offset, k_offset, sm_scale, block_k, k_valid,
                               stream);
    case 64:
      return launch_any<T, 64>(q, k, v, out, lse, bh, sq, sk, causal,
                               q_offset, k_offset, sm_scale, block_k, k_valid,
                               stream);
    case 128:
      return launch_any<T, 128>(q, k, v, out, lse, bh, sq, sk, causal,
                                q_offset, k_offset, sm_scale, block_k,
                                k_valid, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}


// ---- K4 (dQ) and K5 (dK/dV): the backward, from the saved logsumexp --------
//
// K4 replaces ddw_tpu/ops/flash_attention.py `_dq_kernel` (the pallas_call of
// `_partitioned_bwd` at :425) and K5 `_dkv_kernel` (the one at :445). For
// q, do [BH, Sq, D], k, v [BH, Sk, D], lse and delta = rowsum(do * out) -
// g_lse [BH, Sq] (f32, computed outside the kernels) they compute, pair by
// (query, key) pair, what those kernels compute block by block:
//   s  = (q . k) * sm_scale, masked to -1e30 as in K3
//   p  = exp(s - lse), re-zeroed where s was masked (`_guarded_exp`)
//   dp = do . v                                  (input-dtype products, f32)
//   ds = p * (dp - delta)
//   dq = sm_scale * sum_k round(ds) k      dv = sum_q round(p) do
//   dk = sm_scale * sum_q round(ds) q
// where round() is the rounding to the input dtype (bf16; none for f32), and
// sm_scale multiplies the f32 sums after the products. The TPU's block sizes
// set only the grouping of the f32 partial sums; the kernels use their own
// tiles (64 x 64 on the tensor cores, 32 x 32 on the CUDA cores), take any
// Sq and Sk, and mask the ragged edge: keys past Sk give p = 0, and query
// rows past Sq load lse = +inf, so their p is 0 too. A row that sees no key
// has lse ~ -1e30 and every s masked, so the guard gives p = 0 and its dq,
// and its share of dk and dv, are exactly 0. Tiles wholly in the causal
// future, or at or past k_valid, are skipped (an exact no-op), and a block
// whose rows see nothing writes zeros.
//
// Determinism: each output element is summed by one thread, over tiles in a
// fixed order; there are no atomics, so two launches give the same bits.
// K4: one block owns a tile of query rows and walks the visible key tiles;
// K5: one block owns a tile of key rows and walks the visible query tiles
// (at or after the diagonal when causal). (FA2's single-pass backward adds
// dQ with float atomics from the dK/dV pass; that is what these avoid.)
//
// What bounds them: operations. A causal K4 at the LM's training shape
// [256, 2048, 64] does three products of 2 * D FLOPs over the 256 * 2048 *
// 2049 / 2 visible pairs, 2.06e11 FLOP (0.208 ms at 989 TFLOP/s bf16), K5
// four, 2.75e11 (0.278 ms), against 0.34 and 0.40 GB of traffic (0.10 and
// 0.12 ms at 3.35 TB/s).
//
// Design, simple and right first: bf16 runs on the tensor cores with the
// mma.sync m16n8k16 fragments, ldmatrix staging and pack_bf16x2 of K3; f32
// on the CUDA cores. Operands are staged in shared memory with synchronous
// 16-byte copies per tile (no cp.async, TMA or wgmma). The main path's
// shapes (bf16 at head dim 64 and 128) run the sm90 variant instead,
// flash_bwd_sm90.cu (TMA, warp-specialised wgmma, persistent CTAs); these
// mma.sync kernels take bf16 at head dim 32 and timing comparisons. The C
// entries return cudaGetLastError() after the launch.

constexpr int BT = 64;          // columns (keys in K4, queries in K5) per tile

// A-operand fragments (16 rows of a warp x D) of a [rows][QS] bf16 tile.
template <int D>
__device__ __forceinline__ void load_a_frags(uint32_t (&f)[D / 16][4],
                                             const __nv_bfloat16* tile,
                                             int warp, int g, int t) {
  constexpr int QS = D + MPAD;
  const __nv_bfloat16* w = tile + warp * 16 * QS + 2 * t;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    f[ks][0] = lds32(w + g * QS + ks * 16);
    f[ks][1] = lds32(w + (g + 8) * QS + ks * 16);
    f[ks][2] = lds32(w + g * QS + ks * 16 + 8);
    f[ks][3] = lds32(w + (g + 8) * QS + ks * 16 + 8);
  }
}

// acc[j] (16 x 8 tile j of a warp's 16 x BT block) += A . B^T, A from
// fragments, B the BT rows of a [BT][QS] tile (contraction over D).
template <int D>
__device__ __forceinline__ void mma_abt(float (&acc)[BT / 8][4],
                                        const uint32_t (&a)[D / 16][4],
                                        const __nv_bfloat16* tile, int lane) {
  constexpr int QS = D + MPAD;
#pragma unroll
  for (int j = 0; j < BT / 8; ++j) {
    const __nv_bfloat16* r = tile + (j * 8 + (lane & 7)) * QS + (lane >> 3) * 8;
#pragma unroll
    for (int ks = 0; ks + 1 < D / 16; ks += 2) {
      uint32_t b[4];
      ldsm_x4(b, r + ks * 16);
      mma_16816(acc[j], a[ks], b[0], b[1]);
      mma_16816(acc[j], a[ks + 1], b[2], b[3]);
    }
    if constexpr ((D / 16) % 2 == 1) {  // D = 48: the last 16 of the head dim
      uint32_t b[2];
      ldsm_x2(b, r + (D / 16 - 1) * 16);
      mma_16816(acc[j], a[D / 16 - 1], b[0], b[1]);
    }
  }
}

// out[j] (16 x 8 tile j of a warp's 16 x D block) += round(x) . B, x the
// warp's 16 x BT f32 block in the accumulator layout (rounded to bf16 as it
// becomes the A operand) and B a [BT][QS] tile (contraction over its rows).
template <int D>
__device__ __forceinline__ void mma_xb(float (&out)[D / 8][4],
                                       const float (&x)[BT / 8][4],
                                       const __nv_bfloat16* tile, int lane) {
  constexpr int QS = D + MPAD;
#pragma unroll
  for (int kk = 0; kk < BT / 16; ++kk) {
    const uint32_t a[4] = {pack_bf16x2(x[2 * kk][0], x[2 * kk][1]),
                           pack_bf16x2(x[2 * kk][2], x[2 * kk][3]),
                           pack_bf16x2(x[2 * kk + 1][0], x[2 * kk + 1][1]),
                           pack_bf16x2(x[2 * kk + 1][2], x[2 * kk + 1][3])};
    const __nv_bfloat16* r = tile + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * QS
                             + (lane >> 4) * 8;
#pragma unroll
    for (int j = 0; j < D / 8; j += 2) {
      uint32_t b[4];
      ldsm_x4_trans(b, r + j * 8);
      mma_16816(out[j], a, b[0], b[1]);
      mma_16816(out[j + 1], a, b[2], b[3]);
    }
  }
}

template <int D>
constexpr int bwd_mma_smem_bytes() {
  return 4 * BT * (D + MPAD) * 2 + 2 * BT * 4;
}

template <int D>
__global__ void __launch_bounds__(MTHREADS, D <= 64 ? 2 : 1)
flash_bwd_dq_mma_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        __nv_bfloat16* __restrict__ dq, int sq, int sk,
                        int causal, int q_offset, int k_offset, float sm_scale,
                        int k_valid) {
  constexpr int QS = D + MPAD;
  constexpr int NT = BT / 8, DT = D / 8;
  static_assert(DT % 2 == 0, "B fragments of P.V come in pairs");
  extern __shared__ uint4 smem_bwd[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_bwd);
  __nv_bfloat16* Os = Qs + MQ * QS;
  __nv_bfloat16* Ks = Os + MQ * QS;
  __nv_bfloat16* Vs = Ks + BT * QS;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * MQ;  // heaviest causal tiles first
  const int qrows = min(MQ, sq - q0);
  const size_t qbase = (size_t)bh * sq + q0;
  stage_bf16<D>(q + qbase * D, Qs, MQ, qrows, QS);
  stage_bf16<D>(dout + qbase * D, Os, MQ, qrows, QS);
  __syncthreads();
  uint32_t qf[D / 16][4], of[D / 16][4];
  load_a_frags<D>(qf, Qs, warp, g, t);
  load_a_frags<D>(of, Os, warp, g, t);
  float lrow[2], drow[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = warp * 16 + g + 8 * h;
    lrow[h] = r < qrows ? lse[qbase + r] : INFINITY;  // rows past Sq: p = 0
    drow[h] = r < qrows ? delta[qbase + r] : 0.f;
  }
  float acc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  const int qpos0 = q_offset + q0 + warp * 16 + g;  // rows qpos0, qpos0 + 8
  const int q_last = q_offset + q0 + qrows - 1;
  const int n_kt = (sk + BT - 1) / BT;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k_first = k_offset + kt * BT;
    if (causal && k_first > q_last) break;
    if (k_valid >= 0 && k_first >= k_valid) break;
    const int kvalid = min(BT, sk - kt * BT);
    const size_t kv_base = ((size_t)bh * sk + (size_t)kt * BT) * D;
    __syncthreads();  // the previous tile's readers of Ks and Vs are done
    stage_bf16<D>(k + kv_base, Ks, BT, kvalid, QS);
    stage_bf16<D>(v + kv_base, Vs, BT, kvalid, QS);
    __syncthreads();

    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    mma_abt<D>(s, qf, Ks, lane);
    mma_abt<D>(dp, of, Vs, lane);

    const int k_last = k_first + BT - 1;
    const bool edge = (causal && k_last > qpos0 - g) ||
                      (k_valid >= 0 && k_last >= k_valid) || kvalid < BT;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const int c = j * 8 + 2 * t + (e & 1);
        float x = s[j][e] * sm_scale;
        bool dead = false;
        if (edge) {
          const int kpos = k_first + c;
          const bool keep = (!causal || kpos <= qpos0 + 8 * h) &&
                            (k_valid < 0 || kpos < k_valid);
          if (!keep) x = kNeg;
          dead = c >= kvalid || !(x > kNeg / 2);  // a padded key, or masked
        }
        const float p = dead ? 0.f : exp2f((x - lrow[h]) * kLog2e);
        dp[j][e] = p * (dp[j][e] - drow[h]);  // ds
      }
    mma_xb<D>(acc, dp, Ks, lane);  // dq += round(ds) . k
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = warp * 16 + g + 8 * h;
    if (r >= qrows) continue;
    const size_t row = qbase + r;
#pragma unroll
    for (int j = 0; j < DT; ++j)
      *reinterpret_cast<uint32_t*>(dq + row * D + j * 8 + 2 * t) =
          pack_bf16x2(acc[j][2 * h] * sm_scale, acc[j][2 * h + 1] * sm_scale);
  }
}

template <int D>
__global__ void __launch_bounds__(MTHREADS, D <= 64 ? 2 : 1)
flash_bwd_dkv_mma_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv, int sq, int sk,
                         int causal, int q_offset, int k_offset,
                         float sm_scale, int k_valid) {
  constexpr int QS = D + MPAD;
  constexpr int NT = BT / 8, DT = D / 8;
  static_assert(DT % 2 == 0, "B fragments of P.V come in pairs");
  extern __shared__ uint4 smem_bwd[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_bwd);
  __nv_bfloat16* Vs = Ks + MQ * QS;
  __nv_bfloat16* Qs = Vs + MQ * QS;
  __nv_bfloat16* Os = Qs + BT * QS;
  float* Ls = reinterpret_cast<float*>(Os + BT * QS);
  float* Dl = Ls + BT;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * MQ;  // low key tiles, the most causal work, first
  const int krows = min(MQ, sk - k0);
  const size_t kbase = (size_t)bh * sk + k0;
  stage_bf16<D>(k + kbase * D, Ks, MQ, krows, QS);
  stage_bf16<D>(v + kbase * D, Vs, MQ, krows, QS);
  __syncthreads();
  uint32_t kf[D / 16][4], vf[D / 16][4];
  load_a_frags<D>(kf, Ks, warp, g, t);
  load_a_frags<D>(vf, Vs, warp, g, t);
  float dka[DT][4], dva[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;

  const int kpos0 = k_offset + k0 + warp * 16 + g;  // keys kpos0, kpos0 + 8
  const int k_first = k_offset + k0;
  const int k_last_w = kpos0 - g + 15;              // the warp's last key
  int qt0 = 0;  // causal: the first query tile whose last row reaches k_first
  if (causal) {
    const int need = k_first - q_offset - (BT - 1);
    qt0 = need <= 0 ? 0 : (need + BT - 1) / BT;
  }
  const int n_qt = (k_valid >= 0 && k_first >= k_valid) ? 0 : (sq + BT - 1) / BT;
  for (int qt = qt0; qt < n_qt; ++qt) {
    const int qvalid = min(BT, sq - qt * BT);
    const size_t qrow = (size_t)bh * sq + (size_t)qt * BT;
    __syncthreads();  // the previous tile's readers are done
    stage_bf16<D>(q + qrow * D, Qs, BT, qvalid, QS);
    stage_bf16<D>(dout + qrow * D, Os, BT, qvalid, QS);
    for (int i = threadIdx.x; i < BT; i += MTHREADS) {
      Ls[i] = i < qvalid ? lse[qrow + i] : INFINITY;  // rows past Sq: p = 0
      Dl[i] = i < qvalid ? delta[qrow + i] : 0.f;
    }
    __syncthreads();

    // the transposed products: rows are this warp's 16 keys, columns the
    // tile's queries
    float st[NT][4], dpt[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
    mma_abt<D>(st, kf, Qs, lane);
    mma_abt<D>(dpt, vf, Os, lane);

    const int q_first = q_offset + qt * BT;
    const bool edge = (causal && q_first < k_last_w) ||
                      (k_valid >= 0 && k_last_w >= k_valid) || qvalid < BT;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const int c = j * 8 + 2 * t + (e & 1);
        float x = st[j][e] * sm_scale;
        bool dead = false;
        if (edge) {
          const int kpos = kpos0 + 8 * h;
          const bool keep = (!causal || kpos <= q_first + c) &&
                            (k_valid < 0 || kpos < k_valid);
          if (!keep) x = kNeg;
          dead = c >= qvalid || !(x > kNeg / 2);  // a padded query, or masked
        }
        const float p = dead ? 0.f : exp2f((x - Ls[c]) * kLog2e);
        st[j][e] = p;
        dpt[j][e] = p * (dpt[j][e] - Dl[c]);  // ds
      }
    mma_xb<D>(dva, st, Os, lane);   // dv += round(p)^T . do
    mma_xb<D>(dka, dpt, Qs, lane);  // dk += round(ds)^T . q
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = warp * 16 + g + 8 * h;
    if (r >= krows) continue;
    const size_t row = kbase + r;
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      *reinterpret_cast<uint32_t*>(dk + row * D + j * 8 + 2 * t) =
          pack_bf16x2(dka[j][2 * h] * sm_scale, dka[j][2 * h + 1] * sm_scale);
      *reinterpret_cast<uint32_t*>(dv + row * D + j * 8 + 2 * t) =
          pack_bf16x2(dva[j][2 * h], dva[j][2 * h + 1]);
    }
  }
}

// ---- f32 on the CUDA cores: 32 x 32 tiles, 256 threads ---------------------
//
// A thread owns one row of the block's 32 (r = tid / 8) and the columns
// tid % 8 + 8 i of each tile: four (row, column) pairs of s and dp, then
// D / 8 output columns per accumulated tensor. Tiles are staged as f32 with
// rows padded to D + 1 floats (conflict-free column walks).

constexpr int FR = 32, FC = 32, FTHREADS = 256;

template <int D>
constexpr int bwd_f32_smem_bytes() {
  return (4 * FR * (D + 1) + 2 * FR * (FC + 1) + 2 * FC) * 4;
}

template <int D>
__device__ __forceinline__ void stage_f32(const float* __restrict__ src,
                                          float* dst, int rows, int valid) {
  for (int idx = threadIdx.x; idx < rows * D; idx += FTHREADS) {
    const int r = idx / D, d = idx % D;
    dst[r * (D + 1) + d] = r < valid ? src[(size_t)r * D + d] : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(FTHREADS)
flash_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, float* __restrict__ dq,
                        int sq, int sk, int causal, int q_offset, int k_offset,
                        float sm_scale, int k_valid) {
  constexpr int DS = D + 1, NDL = D / 8;
  extern __shared__ float4 smem_f32[];
  float* Qs = reinterpret_cast<float*>(smem_f32);
  float* Os = Qs + FR * DS;
  float* Ks = Os + FR * DS;
  float* Vs = Ks + FC * DS;
  float* Ds = Vs + FC * DS;  // [FR][FC + 1]

  const int r = threadIdx.x >> 3, l8 = threadIdx.x & 7;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * FR;
  const int qrows = min(FR, sq - q0);
  const size_t qbase = (size_t)bh * sq + q0;
  stage_f32<D>(q + qbase * D, Qs, FR, qrows);
  stage_f32<D>(dout + qbase * D, Os, FR, qrows);
  const float lrow = r < qrows ? lse[qbase + r] : INFINITY;
  const float drow = r < qrows ? delta[qbase + r] : 0.f;
  float acc[NDL];
#pragma unroll
  for (int i = 0; i < NDL; ++i) acc[i] = 0.f;
  const bool masked = causal || k_valid >= 0;
  const int qpos = q_offset + q0 + r;
  const int q_last = q_offset + q0 + qrows - 1;
  const int n_kt = (sk + FC - 1) / FC;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k_first = k_offset + kt * FC;
    if (causal && k_first > q_last) break;
    if (k_valid >= 0 && k_first >= k_valid) break;
    const int kvalid = min(FC, sk - kt * FC);
    const size_t kv_base = ((size_t)bh * sk + (size_t)kt * FC) * D;
    __syncthreads();
    stage_f32<D>(k + kv_base, Ks, FC, kvalid);
    stage_f32<D>(v + kv_base, Vs, FC, kvalid);
    __syncthreads();
    float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
    for (int d = 0; d < D; ++d) {
      const float qv = Qs[r * DS + d], ov = Os[r * DS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[i] = fmaf(qv, Ks[(l8 + 8 * i) * DS + d], s[i]);
        dp[i] = fmaf(ov, Vs[(l8 + 8 * i) * DS + d], dp[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = l8 + 8 * i, kpos = k_first + c;
      float x = s[i] * sm_scale;
      if (masked && !((!causal || kpos <= qpos) && (k_valid < 0 || kpos < k_valid)))
        x = kNeg;
      const bool dead = c >= kvalid || (masked && !(x > kNeg / 2));
      const float p = dead ? 0.f : expf(x - lrow);
      Ds[r * (FC + 1) + c] = p * (dp[i] - drow);
    }
    __syncthreads();
    for (int c = 0; c < FC; ++c) {
      const float ds = Ds[r * (FC + 1) + c];
#pragma unroll
      for (int i = 0; i < NDL; ++i)
        acc[i] = fmaf(ds, Ks[c * DS + l8 + 8 * i], acc[i]);
    }
  }
  if (r < qrows)
#pragma unroll
    for (int i = 0; i < NDL; ++i) dq[(qbase + r) * D + l8 + 8 * i] = acc[i] * sm_scale;
}

template <int D>
__global__ void __launch_bounds__(FTHREADS)
flash_bwd_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, float* __restrict__ dk,
                         float* __restrict__ dv, int sq, int sk, int causal,
                         int q_offset, int k_offset, float sm_scale,
                         int k_valid) {
  constexpr int DS = D + 1, NDL = D / 8;
  extern __shared__ float4 smem_f32[];
  float* Ks = reinterpret_cast<float*>(smem_f32);
  float* Vs = Ks + FR * DS;
  float* Qs = Vs + FR * DS;
  float* Os = Qs + FC * DS;
  float* Ps = Os + FC * DS;        // [FR][FC + 1]
  float* Ds = Ps + FR * (FC + 1);  // [FR][FC + 1]
  float* Ls = Ds + FR * (FC + 1);
  float* Dl = Ls + FC;

  const int r = threadIdx.x >> 3, l8 = threadIdx.x & 7;
  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * FR;
  const int krows = min(FR, sk - k0);
  const size_t kbase = (size_t)bh * sk + k0;
  stage_f32<D>(k + kbase * D, Ks, FR, krows);
  stage_f32<D>(v + kbase * D, Vs, FR, krows);
  float dka[NDL], dva[NDL];
#pragma unroll
  for (int i = 0; i < NDL; ++i) dka[i] = dva[i] = 0.f;
  const bool masked = causal || k_valid >= 0;
  const int kpos = k_offset + k0 + r;
  const int k_first = k_offset + k0;
  int qt0 = 0;
  if (causal) {
    const int need = k_first - q_offset - (FC - 1);
    qt0 = need <= 0 ? 0 : (need + FC - 1) / FC;
  }
  const int n_qt = (k_valid >= 0 && k_first >= k_valid) ? 0 : (sq + FC - 1) / FC;
  for (int qt = qt0; qt < n_qt; ++qt) {
    const int qvalid = min(FC, sq - qt * FC);
    const size_t qrow = (size_t)bh * sq + (size_t)qt * FC;
    __syncthreads();
    stage_f32<D>(q + qrow * D, Qs, FC, qvalid);
    stage_f32<D>(dout + qrow * D, Os, FC, qvalid);
    for (int i = threadIdx.x; i < FC; i += FTHREADS) {
      Ls[i] = i < qvalid ? lse[qrow + i] : INFINITY;
      Dl[i] = i < qvalid ? delta[qrow + i] : 0.f;
    }
    __syncthreads();
    float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
    for (int d = 0; d < D; ++d) {
      const float kv = Ks[r * DS + d], vv = Vs[r * DS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[i] = fmaf(kv, Qs[(l8 + 8 * i) * DS + d], s[i]);
        dp[i] = fmaf(vv, Os[(l8 + 8 * i) * DS + d], dp[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = l8 + 8 * i, qpos = q_offset + qt * FC + c;
      float x = s[i] * sm_scale;
      if (masked && !((!causal || kpos <= qpos) && (k_valid < 0 || kpos < k_valid)))
        x = kNeg;
      const bool dead = c >= qvalid || (masked && !(x > kNeg / 2));
      const float p = dead ? 0.f : expf(x - Ls[c]);
      Ps[r * (FC + 1) + c] = p;
      Ds[r * (FC + 1) + c] = p * (dp[i] - Dl[c]);
    }
    __syncthreads();
    for (int c = 0; c < FC; ++c) {
      const float p = Ps[r * (FC + 1) + c], ds = Ds[r * (FC + 1) + c];
#pragma unroll
      for (int i = 0; i < NDL; ++i) {
        dva[i] = fmaf(p, Os[c * DS + l8 + 8 * i], dva[i]);
        dka[i] = fmaf(ds, Qs[c * DS + l8 + 8 * i], dka[i]);
      }
    }
  }
  if (r < krows)
#pragma unroll
    for (int i = 0; i < NDL; ++i) {
      dk[(kbase + r) * D + l8 + 8 * i] = dka[i] * sm_scale;
      dv[(kbase + r) * D + l8 + 8 * i] = dva[i];
    }
}

struct BwdArgs {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *dq, *dk, *dv;
  int bh, sq, sk, causal, q_offset, k_offset, k_valid;
  float sm_scale;
  cudaStream_t stream;
};

template <typename Kernel>
int set_smem(Kernel kernel, int bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int D>
int launch_bwd(const BwdArgs& a, int dtype, bool dq_pass) {
  using bf = __nv_bfloat16;
  if (dtype == 1) {  // bf16: the tensor cores
    const int smem = bwd_mma_smem_bytes<D>();
    if (dq_pass) {
      auto kern = flash_bwd_dq_mma_kernel<D>;
      if (int err = set_smem(kern, smem)) return err;
      kern<<<dim3(a.bh, (a.sq + MQ - 1) / MQ), MTHREADS, smem, a.stream>>>(
          (const bf*)a.q, (const bf*)a.k, (const bf*)a.v, (const bf*)a.dout,
          (const float*)a.lse, (const float*)a.delta, (bf*)a.dq, a.sq, a.sk,
          a.causal, a.q_offset, a.k_offset, a.sm_scale, a.k_valid);
    } else {
      auto kern = flash_bwd_dkv_mma_kernel<D>;
      if (int err = set_smem(kern, smem)) return err;
      kern<<<dim3(a.bh, (a.sk + MQ - 1) / MQ), MTHREADS, smem, a.stream>>>(
          (const bf*)a.q, (const bf*)a.k, (const bf*)a.v, (const bf*)a.dout,
          (const float*)a.lse, (const float*)a.delta, (bf*)a.dk, (bf*)a.dv,
          a.sq, a.sk, a.causal, a.q_offset, a.k_offset, a.sm_scale, a.k_valid);
    }
  } else {  // f32: the CUDA cores
    const int smem = bwd_f32_smem_bytes<D>();
    if (dq_pass) {
      auto kern = flash_bwd_dq_f32_kernel<D>;
      if (int err = set_smem(kern, smem)) return err;
      kern<<<dim3(a.bh, (a.sq + FR - 1) / FR), FTHREADS, smem, a.stream>>>(
          (const float*)a.q, (const float*)a.k, (const float*)a.v,
          (const float*)a.dout, (const float*)a.lse, (const float*)a.delta,
          (float*)a.dq, a.sq, a.sk, a.causal, a.q_offset, a.k_offset,
          a.sm_scale, a.k_valid);
    } else {
      auto kern = flash_bwd_dkv_f32_kernel<D>;
      if (int err = set_smem(kern, smem)) return err;
      kern<<<dim3(a.bh, (a.sk + FR - 1) / FR), FTHREADS, smem, a.stream>>>(
          (const float*)a.q, (const float*)a.k, (const float*)a.v,
          (const float*)a.dout, (const float*)a.lse, (const float*)a.delta,
          (float*)a.dk, (float*)a.dv, a.sq, a.sk, a.causal, a.q_offset,
          a.k_offset, a.sm_scale, a.k_valid);
    }
  }
  return (int)cudaGetLastError();
}

int dispatch_bwd(const BwdArgs& a, int d, int dtype, bool dq_pass) {
  if (a.bh < 1 || a.sq < 1 || a.sk < 1 || (dtype != 0 && dtype != 1) ||
      (a.sq + FR - 1) / FR > 65535 || (a.sk + FR - 1) / FR > 65535)
    return (int)cudaErrorInvalidValue;
  switch (d) {
    case 32: return launch_bwd<32>(a, dtype, dq_pass);
    case 48: return launch_bwd<48>(a, dtype, dq_pass);
    case 64: return launch_bwd<64>(a, dtype, dq_pass);
    case 128: return launch_bwd<128>(a, dtype, dq_pass);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q [bh, sq, d], k/v [bh, sk, d] contiguous, 16-byte aligned, in float32
// (dtype 0) or bfloat16 (dtype 1); out [bh, sq, d] in that dtype, lse
// [bh, sq] float32. d in {32, 48, 64, 128}; 1 <= block_k <= 128 dividing sk;
// k_valid < 0 means no key mask. Returns a cudaError_t code.
int ddw_flash_fwd(const void* q, const void* k, const void* v, void* out,
                  void* lse, int bh, int sq, int sk, int d, int dtype,
                  int causal, int q_offset, int k_offset, float sm_scale,
                  int block_k, int k_valid, void* stream) {
  if (bh < 1 || sq < 1 || sk < 1 || block_k < 1 || block_k > KT ||
      sk % block_k != 0 || (sq + BQ - 1) / BQ > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(d, q, k, v, out, lse, bh, sq, sk, causal,
                             q_offset, k_offset, sm_scale, block_k, k_valid, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(d, q, k, v, out, lse, bh, sq, sk, causal,
                                     q_offset, k_offset, sm_scale, block_k,
                                     k_valid, s);
  return (int)cudaErrorInvalidValue;
}

// K4: q, do [bh, sq, d], k/v [bh, sk, d] in float32 (dtype 0) or bfloat16
// (dtype 1), lse and delta [bh, sq] float32, all contiguous and 16-byte
// aligned; dq [bh, sq, d] in the input dtype. d in {32, 48, 64, 128}; any sq,
// sk >= 1; k_valid < 0 means no key mask. Returns a cudaError_t code.
int ddw_flash_bwd_dq(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dq, int bh, int sq, int sk, int d, int dtype,
                     int causal, int q_offset, int k_offset, float sm_scale,
                     int k_valid, void* stream) {
  const BwdArgs a{q, k, v, dout, lse, delta, dq, nullptr, nullptr, bh, sq,
                  sk, causal, q_offset, k_offset, k_valid, sm_scale,
                  static_cast<cudaStream_t>(stream)};
  return dispatch_bwd(a, d, dtype, true);
}

// K5: the inputs of K4; dk, dv [bh, sk, d] in the input dtype.
int ddw_flash_bwd_dkv(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dk, void* dv, int bh, int sq, int sk, int d,
                      int dtype, int causal, int q_offset, int k_offset,
                      float sm_scale, int k_valid, void* stream) {
  const BwdArgs a{q, k, v, dout, lse, delta, nullptr, dk, dv, bh, sq, sk,
                  causal, q_offset, k_offset, k_valid, sm_scale,
                  static_cast<cudaStream_t>(stream)};
  return dispatch_bwd(a, d, dtype, false);
}

}  // extern "C"
