// Flash attention for Hopper, the forward (K3): online-softmax attention that
// never writes the score matrix to device memory. The backward (K4 dQ, K5
// dK/dV) is flash_attention_bwd.cu; both use flash_common.cuh.
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
// rescale happens at the same block_k granularity as the TPU kernel (the
// rounding of p depends on the max it was taken against), so the kernel stays
// within rounding of the plain PyTorch version in flash_attention.py, which
// follows the TPU kernel step for step. K blocks wholly in the future of every
// query row of a block, or wholly at or past k_valid, are skipped: their
// update would be an exact no-op. Like the TPU kernel it takes any head dim D
// and float32, bfloat16 or float16.
//
// What bounds it: operations. A causal call does about 2 * 2 * BH * Sq * Sk *
// D / 2 multiply-adds' worth of FLOPs against 4 * BH * S * D * bytes of
// traffic; at the LM's shape [512, 2048, 64] bf16 that is 2.75e11 FLOP (0.28 ms
// at the 989 TFLOP/s dense bf16 peak) against 537 MB (0.16 ms at 3.35 TB/s).
//
// Design: simple and right first, in two paths. bf16 and f16 with block_k a
// multiple of 16 (every block flash_mha picks for them) and D up to 256 run
// both products on the tensor cores with mma.sync m16n8k16 and f32
// accumulation (the second kernel below). f32, 16-bit blocks of other sizes
// and D above 256 run in f32 on the CUDA cores (FFMA), the first kernel. The
// main path's attention at head dim 64 or 128 (bf16, block_k = 128) runs the
// Hopper kernel of flash_fwd_sm90.cu instead; these two keep the other shapes
// (ops/flash_attention.py `_fwd_variant`). The head dim is rounded up inside
// the kernels, never on the host (flash_common.cuh). The C entry returns
// cudaGetLastError() after the launch.

// nvcc parts: 4

#include <type_traits>

#include "flash_common.cuh"

namespace {

using namespace flash;

// ---- f32 on the CUDA cores ---------------------------------------------------
//
// One block of 256 threads owns BQ = 64 query rows of one (batch*head) and DC
// output columns, a 16 x 16 thread grid: ty holds 4 rows and tx a set of key
// columns (scores) or output columns. DC is 16 or 32 for D up to 32 and 64
// above; a wider head dim runs ceil(D / 64) blocks side by side (grid z), each
// computing the scores over the whole D in slabs of 64 (so every block of a
// row takes the same steps and gets the same m and l bits) and the output of
// its own 64 columns. Registers and shared memory do not grow with D, so
// every D takes this kernel. A slab of Q (D = 64 or less: all of Q, staged
// once) and of K is staged as f32, transposed; the 4 x 8 score tile of a
// thread is a register tile, row max and row sum are butterfly shuffles over
// the 16 tx lanes of a half warp (every lane ends with the same bits), and
// the rounded p goes through shared memory (aliasing the dead K tile) for the
// P.V product against the block's V columns. Shared memory:
// (64 DC + max(128 DC, 64 * 132) + 128 DC) * 4 bytes, 81 KB at DC = 64, so
// two blocks fit on an SM.

constexpr int BQ = 64;        // query rows per block
constexpr int KT = 128;       // key columns per staged tile (block_k <= KT)
constexpr int PS = KT + 4;    // row stride of the p tile (bank spread)

template <int DC>
constexpr int smem_floats() {
  return DC * BQ + (DC * KT > BQ * PS ? DC * KT : BQ * PS) + KT * DC;
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

struct FwdArgs {
  const void *q, *k, *v;
  void *out, *lse;
  int bh, sq, sk, d, causal, q_offset, k_offset, block_k, k_valid;
  float sm_scale;
  cudaStream_t stream;
};

template <typename T, int DC>
__global__ void __launch_bounds__(CC_THREADS, 2)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int sq, int sk, int d, int causal,
                 int q_offset, int k_offset, float sm_scale, int block_k,
                 int k_valid) {
  // output columns of a thread: NCH chunks of W adjacent columns, chunk c at
  // c * 16 * W + tx * W (conflict-free vector reads)
  constexpr int NV = DC / 16;
  constexpr int W = NV < 4 ? NV : 4;
  constexpr int NCH = NV / W;
  static_assert(NV % W == 0, "a width of whole 16-column groups");

  extern __shared__ float4 smem_raw[];
  float* Qt = reinterpret_cast<float*>(smem_raw);  // [DC][BQ]
  float* KtP = Qt + DC * BQ;                       // [DC][KT], then [BQ][PS]
  float* Vs = KtP + (DC * KT > BQ * PS ? DC * KT : BQ * PS);  // [KT][DC]

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest causal tiles first
  const int qrows = min(BQ, sq - q0);
  const int nslab = gridDim.z;                       // ceil(d / DC)
  const int c0 = blockIdx.z * DC;                    // this block's output columns
  const bool masked = causal || k_valid >= 0;
  const bool vec = d % (16 / (int)sizeof(T)) == 0;
  const T* qb = q + ((size_t)bh * sq + q0) * d;

  if (nslab == 1) stage_f32<T, DC, true>(qb, Qt, BQ, qrows, d, 0, BQ, vec);

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
    const size_t kv_base = ((size_t)bh * sk + (size_t)kb * block_k) * d;

    // s[i][j]: row ty*4+i, key column (j/4)*64 + tx*4 + j%4, summed over
    // the head dim one slab of DC columns at a time
    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
    for (int sl = 0; sl < nslab; ++sl) {
      __syncthreads();  // the readers of the previous slab (or block) are done
      if (nslab > 1) stage_f32<T, DC, true>(qb, Qt, BQ, qrows, d, sl * DC, BQ, vec);
      stage_f32<T, DC, true>(k + kv_base, KtP, KT, block_k, d, sl * DC, KT, vec);
      __syncthreads();
#pragma unroll 4
      for (int dd = 0; dd < DC; ++dd) {
        const float4 qv = *reinterpret_cast<const float4*>(Qt + dd * BQ + ty * 4);
        const float4 k0 = *reinterpret_cast<const float4*>(KtP + dd * KT + tx * 4);
        const float4 k1 = *reinterpret_cast<const float4*>(KtP + dd * KT + 64 + tx * 4);
        const float qa[4] = {qv.x, qv.y, qv.z, qv.w};
        const float ka[8] = {k0.x, k0.y, k0.z, k0.w, k1.x, k1.y, k1.z, k1.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) s[i][j] = fmaf(qa[i], ka[j], s[i][j]);
      }
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
        pv.x = round_to<T>(s[i][h * 4 + 0]);
        pv.y = round_to<T>(s[i][h * 4 + 1]);
        pv.z = round_to<T>(s[i][h * 4 + 2]);
        pv.w = round_to<T>(s[i][h * 4 + 3]);
        *reinterpret_cast<float4*>(row + h * 64) = pv;
      }
    }
    stage_f32<T, DC, false>(v + kv_base, Vs, KT, block_k, d, c0, DC, vec);
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
        const float* vrow = Vs + (kk + e) * DC + tx * W;
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
      const int col = c0 + (c / W) * 16 * W + tx * W + (c % W);
      if (col < d) out[row * d + col] = from_f32<T>(acc[i][c] / denom);
    }
    if (tx == 0 && blockIdx.z == 0) lse[row] = m[i] + logf(denom);
  }
}

// ---- bf16 and f16 on the tensor cores: mma.sync m16n8k16, f32 accumulation -
//
// The same online softmax, block for block, with both products on the tensor
// cores. A block owns MQ = 64 query rows, 16 per row warp; Q and each K and V
// block are staged at the compiled width DP (a multiple of 16 at or above D,
// the tail zero) with 16-byte copies, rows padded by 8 values so that the
// ldmatrix loads of a warp hit 32 distinct banks. A's fragments are read from
// shared memory per k-step pair and K^T and V fragments come from ldmatrix (V
// with .trans). A thread holds, in the mma.sync accumulator layout (g =
// lane / 4, t = lane % 4), rows g and g + 8 and columns 2t, 2t + 1 of every
// 8-wide tile; the row max and row sum are shuffles over the 4 lanes of a
// row, and p = exp2((s - m) * log2 e). The f32 score tile becomes the A
// operand of P.V in registers, rounded to the input dtype as the TPU kernel
// rounds p. Above DP = 128 the output accumulators, 4 f32 registers per 8
// columns, would not fit beside the scores: two warps share each 16 rows,
// both computing the scores (identical bits) and each the P.V product of
// half of the head dim (the head dim split across warps; 8 warps). Shared
// memory: (64 + 2 * 128) * (DP + 8) * 2 bytes, 45 KB at DP = 64, 169 KB at
// DP = 256.

template <typename T, int DP>
__global__ void __launch_bounds__(128 * mma_split(DP), DP <= 64 ? 3 : DP <= 128 ? 2 : 1)
flash_fwd_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out,
                     float* __restrict__ lse, int sq, int sk, int d, int causal,
                     int q_offset, int k_offset, float sm_scale, int block_k,
                     int k_valid) {
  constexpr int NS = mma_split(DP);
  constexpr int THR = 128 * NS;
  constexpr int QS = DP + MPAD;  // row stride of the Q, K and V tiles
  constexpr int NT = KT / 8;     // 8-key tiles of a K block
  constexpr int DC = DP / NS;    // output columns of a warp
  constexpr int DT = DC / 8;     // 8-wide output tiles of a warp

  extern __shared__ uint4 smem_mma[];
  T* Qs = reinterpret_cast<T*>(smem_mma);
  T* Ks = Qs + MQ * QS;
  T* Vs = Ks + KT * QS;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rw = warp & 3, part = warp >> 2;  // row warp; head-dim part
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * MQ;  // heaviest tiles first
  const int qrows = min(MQ, sq - q0);
  const bool vec = (d & 7) == 0;

  stage16<DP, THR>(q + ((size_t)bh * sq + q0) * d, Qs, MQ, qrows, d, vec);

  float o[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
  const int qpos0 = q_offset + q0 + rw * 16 + g;  // rows qpos0, qpos0 + 8
  const int q_last = q_offset + q0 + qrows - 1;
  const int n_kb = sk / block_k;
  for (int kb = 0; kb < n_kb; ++kb) {
    const int k_first = k_offset + kb * block_k;
    if (causal && k_first > q_last) break;
    if (k_valid >= 0 && k_first >= k_valid) break;
    const size_t kv_base = ((size_t)bh * sk + (size_t)kb * block_k) * d;

    __syncthreads();  // the previous block's readers of Ks and Vs are done
    stage16<DP, THR>(k + kv_base, Ks, KT, block_k, d, vec);
    stage16<DP, THR>(v + kv_base, Vs, KT, block_k, d, vec);
    __syncthreads();

    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    mma_abt<T, DP, KT>(s, Qs + rw * 16 * QS, Ks, lane, block_k);

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
    mma_xb<T, DP, KT, DT>(o, s, Vs, part * DC, lane, block_k);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = rw * 16 + g + 8 * h;
    if (r >= qrows) continue;
    const size_t row = (size_t)bh * sq + q0 + r;
    const float den = fmaxf(l[h], 1e-30f);
#pragma unroll
    for (int j = 0; j < DT; ++j)
      store2<T>(out + row * d, part * DC + j * 8 + 2 * t, d, o[j][2 * h] / den,
                o[j][2 * h + 1] / den);
    if (t == 0 && part == 0) lse[row] = m[h] + logf(den);
  }
}

template <typename T, int DP>
int launch_mma(const FwdArgs& a) {
  if constexpr (!part_holds(true, DP)) {
    return kNotHere;
  } else {
    constexpr int THR = 128 * mma_split(DP);
    const int smem = (MQ + 2 * KT) * (DP + MPAD) * 2;
    auto kernel = flash_fwd_mma_kernel<T, DP>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(a.bh, (a.sq + MQ - 1) / MQ);
    kernel<<<grid, THR, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<T*>(a.out),
        static_cast<float*>(a.lse), a.sq, a.sk, a.d, a.causal, a.q_offset,
        a.k_offset, a.sm_scale, a.block_k, a.k_valid);
    return (int)cudaGetLastError();
  }
}

template <typename T, int DC>
int launch_cc(const FwdArgs& a) {
  if constexpr (!part_holds(false, DC)) {
    return kNotHere;
  } else {
    const size_t smem = smem_floats<DC>() * sizeof(float);
    auto kernel = flash_fwd_kernel<T, DC>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(a.bh, (a.sq + BQ - 1) / BQ, (a.d + DC - 1) / DC);
    kernel<<<grid, CC_THREADS, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<T*>(a.out),
        static_cast<float*>(a.lse), a.sq, a.sk, a.d, a.causal, a.q_offset,
        a.k_offset, a.sm_scale, a.block_k, a.k_valid);
    return (int)cudaGetLastError();
  }
}

// bf16 and f16 with block_k a multiple of 16 and D up to 256 run on the
// tensor cores; f32, other 16-bit blocks and wider heads on the CUDA cores.
template <typename T>
int dispatch(const FwdArgs& a) {
  if constexpr (!std::is_same<T, float>::value) {
    if (a.block_k % 16 == 0 && a.d <= kMmaMaxD) {
      switch (mma_width(a.d)) {
        case 16: return launch_mma<T, 16>(a);
        case 32: return launch_mma<T, 32>(a);
        case 48: return launch_mma<T, 48>(a);
        case 64: return launch_mma<T, 64>(a);
        case 96: return launch_mma<T, 96>(a);
        case 128: return launch_mma<T, 128>(a);
        default: return launch_mma<T, 256>(a);
      }
    }
  }
  switch (cc_width(a.d)) {
    case 16: return launch_cc<T, 16>(a);
    case 32: return launch_cc<T, 32>(a);
    default: return launch_cc<T, 64>(a);
  }
}

int run(const FwdArgs& a, int dtype) {
  if (dtype == 0) return dispatch<float>(a);
  if (dtype == 1) return dispatch<__nv_bfloat16>(a);
  if (dtype == 2) return dispatch<__half>(a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

#if DDW_PART >= 0
#define DDW_CAT_(a, b) a##b
#define DDW_CAT(a, b) DDW_CAT_(a, b)
// This part's kernels (kNotHere for the others'); args is a FwdArgs.
int DDW_CAT(ddw_flash_fwd_part, DDW_PART)(const void* args, int dtype) {
  return run(*static_cast<const FwdArgs*>(args), dtype);
}
int ddw_flash_fwd_part0(const void* args, int dtype);
int ddw_flash_fwd_part1(const void* args, int dtype);
int ddw_flash_fwd_part2(const void* args, int dtype);
int ddw_flash_fwd_part3(const void* args, int dtype);
#endif

#if DDW_PART <= 0

// q [bh, sq, d], k/v [bh, sk, d] contiguous, 16-byte aligned, in float32
// (dtype 0), bfloat16 (1) or float16 (2); out [bh, sq, d] in that dtype, lse
// [bh, sq] float32. Any d >= 1; 1 <= block_k <= 128 dividing sk; k_valid < 0
// means no key mask. Returns a cudaError_t code.
int ddw_flash_fwd(const void* q, const void* k, const void* v, void* out,
                  void* lse, int bh, int sq, int sk, int d, int dtype,
                  int causal, int q_offset, int k_offset, float sm_scale,
                  int block_k, int k_valid, void* stream) {
  if (bh < 1 || sq < 1 || sk < 1 || d < 1 || block_k < 1 || block_k > KT ||
      sk % block_k != 0 || (sq + BQ - 1) / BQ > 65535 ||
      (d + 63) / 64 > 65535)
    return (int)cudaErrorInvalidValue;
  const FwdArgs a{q, k, v, out, lse, bh, sq, sk, d, causal, q_offset,
                  k_offset, block_k, k_valid, sm_scale,
                  static_cast<cudaStream_t>(stream)};
#if DDW_PART < 0
  return run(a, dtype);
#else
  using Part = int (*)(const void*, int);
  const Part parts[] = {ddw_flash_fwd_part0, ddw_flash_fwd_part1,
                        ddw_flash_fwd_part2, ddw_flash_fwd_part3};
  static_assert(sizeof(parts) / sizeof(parts[0]) == flash::kParts,
                "one ddw_flash_fwd_part<p> a part");
  for (const Part part : parts) {
    const int err = part(&a, dtype);
    if (err != flash::kNotHere) return err;
  }
  return (int)cudaErrorInvalidValue;
#endif
}
#endif  // DDW_PART <= 0

}  // extern "C"
