// Flash attention for Hopper, the backward: K4 (dQ) and K5 (dK/dV), which
// rebuild p from the saved logsumexp. The forward (K3) is flash_attention.cu;
// both use flash_common.cuh.
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
// where round() is the rounding to the input dtype (bf16 or f16; none for
// f32), and sm_scale multiplies the f32 sums after the products. The TPU's
// block sizes set only the grouping of the f32 partial sums; the kernels use
// their own tiles, take any Sq and Sk, and mask the ragged edge: keys past Sk
// give p = 0, and query rows past Sq load lse = +inf, so their p is 0 too. A
// row that sees no key has lse ~ -1e30 and every s masked, so the guard gives
// p = 0 and its dq, and its share of dk and dv, are exactly 0. Tiles wholly in
// the causal future, or at or past k_valid, are skipped (an exact no-op), and
// a block whose rows see nothing writes zeros. Like the TPU kernels they take
// any head dim D and float32, bfloat16 or float16.
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
// Design, simple and right first: bf16 and f16 at D up to 256 run on the
// tensor cores with the mma.sync m16n8k16 fragments, ldmatrix staging and
// rounding of K3 (flash_common.cuh); f32, and 16-bit heads wider than 256,
// on the CUDA cores. Operands are staged in shared memory with synchronous
// copies per tile (no cp.async, TMA or wgmma), at the compiled width with
// the head dim's tail zero-filled. The main path's shapes (bf16 at head dim
// 64 and 128) run the sm90 variant instead, flash_bwd_sm90.cu (TMA,
// warp-specialised wgmma, persistent CTAs). The C entries return
// cudaGetLastError() after the launch.

// nvcc parts: 4

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int BT = 64;  // K4's key columns per tile (K5's queries: kdkv_cols)

// K5's query columns per tile: 32 from a compiled width of 96, so that the
// two f32 accumulators of a warp (dK and dV, 8 registers per 8 columns) fit
// beside the scores.
__host__ __device__ constexpr int kdkv_cols(int dp) {
  return dp >= 96 ? 32 : 64;
}

template <int DP>
constexpr int dq_mma_smem_bytes() {
  return (2 * MQ + 2 * BT) * (DP + MPAD) * 2;
}

template <int DP>
constexpr int dkv_mma_smem_bytes() {
  return (2 * MQ + 2 * kdkv_cols(DP)) * (DP + MPAD) * 2 + 2 * kdkv_cols(DP) * 4;
}

// K4 on the tensor cores. A block owns MQ = 64 query rows, 16 per row warp;
// above a compiled width of 128 two warps share each 16 rows, both computing
// s and dp over the whole head dim (identical bits) and each the dQ columns
// of its half.
template <typename T, int DP>
__global__ void __launch_bounds__(128 * mma_split(DP), DP <= 64 ? 2 : 1)
flash_bwd_dq_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        int sq, int sk, int d, int causal, int q_offset,
                        int k_offset, float sm_scale, int k_valid) {
  constexpr int NS = mma_split(DP), THR = 128 * NS;
  constexpr int QS = DP + MPAD;
  constexpr int NT = BT / 8, DC = DP / NS, DT = DC / 8;
  extern __shared__ uint4 smem_bwd[];
  T* Qs = reinterpret_cast<T*>(smem_bwd);
  T* Os = Qs + MQ * QS;
  T* Ks = Os + MQ * QS;
  T* Vs = Ks + BT * QS;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rw = warp & 3, part = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * MQ;  // heaviest causal tiles first
  const int qrows = min(MQ, sq - q0);
  const size_t qbase = (size_t)bh * sq + q0;
  const bool vec = (d & 7) == 0;
  stage16<DP, THR>(q + qbase * d, Qs, MQ, qrows, d, vec);
  stage16<DP, THR>(dout + qbase * d, Os, MQ, qrows, d, vec);
  float lrow[2], drow[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = rw * 16 + g + 8 * h;
    lrow[h] = r < qrows ? lse[qbase + r] : INFINITY;  // rows past Sq: p = 0
    drow[h] = r < qrows ? delta[qbase + r] : 0.f;
  }
  float acc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  const int qpos0 = q_offset + q0 + rw * 16 + g;  // rows qpos0, qpos0 + 8
  const int q_last = q_offset + q0 + qrows - 1;
  const int n_kt = (sk + BT - 1) / BT;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k_first = k_offset + kt * BT;
    if (causal && k_first > q_last) break;
    if (k_valid >= 0 && k_first >= k_valid) break;
    const int kvalid = min(BT, sk - kt * BT);
    const size_t kv_base = ((size_t)bh * sk + (size_t)kt * BT) * d;
    __syncthreads();  // the previous tile's readers of Ks and Vs are done
    stage16<DP, THR>(k + kv_base, Ks, BT, kvalid, d, vec);
    stage16<DP, THR>(v + kv_base, Vs, BT, kvalid, d, vec);
    __syncthreads();

    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    mma_abt<T, DP, BT>(s, Qs + rw * 16 * QS, Ks, lane);
    mma_abt<T, DP, BT>(dp, Os + rw * 16 * QS, Vs, lane);

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
    mma_xb<T, DP, BT, DT>(acc, dp, Ks, part * DC, lane);  // dq += round(ds) . k
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = rw * 16 + g + 8 * h;
    if (r >= qrows) continue;
    T* row = dq + (qbase + r) * d;
#pragma unroll
    for (int j = 0; j < DT; ++j)
      store2<T>(row, part * DC + j * 8 + 2 * t, d, acc[j][2 * h] * sm_scale,
                acc[j][2 * h + 1] * sm_scale);
  }
}

// K5 on the tensor cores. A block owns MQ = 64 key rows, 16 per row warp, and
// walks query tiles of kdkv_cols(DP); above a compiled width of 128 two warps
// share each 16 keys, each accumulating dK and dV for half of the head dim.
template <typename T, int DP>
__global__ void __launch_bounds__(128 * mma_split(DP), DP <= 64 ? 2 : 1)
flash_bwd_dkv_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dk,
                         T* __restrict__ dv, int sq, int sk, int d, int causal,
                         int q_offset, int k_offset, float sm_scale,
                         int k_valid) {
  constexpr int NS = mma_split(DP), THR = 128 * NS;
  constexpr int QS = DP + MPAD, BQT = kdkv_cols(DP);
  constexpr int NT = BQT / 8, DC = DP / NS, DT = DC / 8;
  extern __shared__ uint4 smem_bwd[];
  T* Ks = reinterpret_cast<T*>(smem_bwd);
  T* Vs = Ks + MQ * QS;
  T* Qs = Vs + MQ * QS;
  T* Os = Qs + BQT * QS;
  float* Ls = reinterpret_cast<float*>(Os + BQT * QS);
  float* Dl = Ls + BQT;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rw = warp & 3, part = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * MQ;  // low key tiles, the most causal work, first
  const int krows = min(MQ, sk - k0);
  const size_t kbase = (size_t)bh * sk + k0;
  const bool vec = (d & 7) == 0;
  stage16<DP, THR>(k + kbase * d, Ks, MQ, krows, d, vec);
  stage16<DP, THR>(v + kbase * d, Vs, MQ, krows, d, vec);
  float dka[DT][4], dva[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;

  const int kpos0 = k_offset + k0 + rw * 16 + g;  // keys kpos0, kpos0 + 8
  const int k_first = k_offset + k0;
  const int k_last_w = kpos0 - g + 15;              // the warp's last key
  int qt0 = 0;  // causal: the first query tile whose last row reaches k_first
  if (causal) {
    const int need = k_first - q_offset - (BQT - 1);
    qt0 = need <= 0 ? 0 : (need + BQT - 1) / BQT;
  }
  const int n_qt = (k_valid >= 0 && k_first >= k_valid) ? 0 : (sq + BQT - 1) / BQT;
  for (int qt = qt0; qt < n_qt; ++qt) {
    const int qvalid = min(BQT, sq - qt * BQT);
    const size_t qrow = (size_t)bh * sq + (size_t)qt * BQT;
    __syncthreads();  // the previous tile's readers are done
    stage16<DP, THR>(q + qrow * d, Qs, BQT, qvalid, d, vec);
    stage16<DP, THR>(dout + qrow * d, Os, BQT, qvalid, d, vec);
    for (int i = threadIdx.x; i < BQT; i += THR) {
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
    mma_abt<T, DP, BQT>(st, Ks + rw * 16 * QS, Qs, lane);
    mma_abt<T, DP, BQT>(dpt, Vs + rw * 16 * QS, Os, lane);

    const int q_first = q_offset + qt * BQT;
    const bool edge = (causal && q_first < k_last_w) ||
                      (k_valid >= 0 && k_last_w >= k_valid) || qvalid < BQT;
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
    mma_xb<T, DP, BQT, DT>(dva, st, Os, part * DC, lane);   // dv += round(p)^T . do
    mma_xb<T, DP, BQT, DT>(dka, dpt, Qs, part * DC, lane);  // dk += round(ds)^T . q
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = rw * 16 + g + 8 * h;
    if (r >= krows) continue;
    const size_t row = kbase + r;
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      const int c = part * DC + j * 8 + 2 * t;
      store2<T>(dk + row * d, c, d, dka[j][2 * h] * sm_scale,
                dka[j][2 * h + 1] * sm_scale);
      store2<T>(dv + row * d, c, d, dva[j][2 * h], dva[j][2 * h + 1]);
    }
  }
}

// ---- on the CUDA cores: 32 x 32 tiles, 256 threads ---------------------------
//
// A thread owns one row of the block's 32 (r = tid / 8) and the columns
// tid % 8 + 8 i of each tile: four (row, column) pairs of s and dp, then
// DC / 8 output columns per accumulated tensor. A block owns DC output
// columns (16, 32, or 64 above 32; grid z, as in K3's CUDA-core kernel) and
// computes s and dp over the whole head dim in slabs of DC; operands are
// staged as f32 with rows padded to DC + 1 floats (conflict-free column
// walks). p and ds are rounded to the input dtype before their products.

constexpr int FR = 32, FC = 32;

template <int DC>
constexpr int cc_smem_bytes() {
  return (4 * FR * (DC + 1) + 2 * FR * (FC + 1) + 2 * FC) * 4;
}

template <typename T, int DC>
__global__ void __launch_bounds__(CC_THREADS)
flash_bwd_dq_cc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const T* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta, T* __restrict__ dq,
                       int sq, int sk, int d, int causal, int q_offset,
                       int k_offset, float sm_scale, int k_valid) {
  constexpr int DS = DC + 1, NDL = DC / 8;
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
  const int nslab = gridDim.z, c0 = blockIdx.z * DC;
  const bool vec = d % (16 / (int)sizeof(T)) == 0;
  if (nslab == 1) {
    stage_f32<T, DC, false>(q + qbase * d, Qs, FR, qrows, d, 0, DS, vec);
    stage_f32<T, DC, false>(dout + qbase * d, Os, FR, qrows, d, 0, DS, vec);
  }
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
    const size_t kv_base = ((size_t)bh * sk + (size_t)kt * FC) * d;
    float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
    for (int sl = 0; sl < nslab; ++sl) {
      __syncthreads();  // the readers of the previous slab (or tile) are done
      if (nslab > 1) {
        stage_f32<T, DC, false>(q + qbase * d, Qs, FR, qrows, d, sl * DC, DS, vec);
        stage_f32<T, DC, false>(dout + qbase * d, Os, FR, qrows, d, sl * DC, DS, vec);
      }
      stage_f32<T, DC, false>(k + kv_base, Ks, FC, kvalid, d, sl * DC, DS, vec);
      stage_f32<T, DC, false>(v + kv_base, Vs, FC, kvalid, d, sl * DC, DS, vec);
      __syncthreads();
      for (int dd = 0; dd < DC; ++dd) {
        const float qv = Qs[r * DS + dd], ov = Os[r * DS + dd];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[i] = fmaf(qv, Ks[(l8 + 8 * i) * DS + dd], s[i]);
          dp[i] = fmaf(ov, Vs[(l8 + 8 * i) * DS + dd], dp[i]);
        }
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
      Ds[r * (FC + 1) + c] = round_to<T>(p * (dp[i] - drow));
    }
    if (nslab > 1) {  // this block's columns of K, in place of the last slab
      __syncthreads();
      stage_f32<T, DC, false>(k + kv_base, Ks, FC, kvalid, d, c0, DS, vec);
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
    for (int i = 0; i < NDL; ++i) {
      const int col = c0 + l8 + 8 * i;
      if (col < d) dq[(qbase + r) * d + col] = from_f32<T>(acc[i] * sm_scale);
    }
}

template <typename T, int DC>
__global__ void __launch_bounds__(CC_THREADS)
flash_bwd_dkv_cc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dk,
                        T* __restrict__ dv, int sq, int sk, int d, int causal,
                        int q_offset, int k_offset, float sm_scale,
                        int k_valid) {
  constexpr int DS = DC + 1, NDL = DC / 8;
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
  const int nslab = gridDim.z, c0 = blockIdx.z * DC;
  const bool vec = d % (16 / (int)sizeof(T)) == 0;
  if (nslab == 1) {
    stage_f32<T, DC, false>(k + kbase * d, Ks, FR, krows, d, 0, DS, vec);
    stage_f32<T, DC, false>(v + kbase * d, Vs, FR, krows, d, 0, DS, vec);
  }
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
    float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
    for (int sl = 0; sl < nslab; ++sl) {
      __syncthreads();  // the readers of the previous slab (or tile) are done
      if (nslab > 1) {
        stage_f32<T, DC, false>(k + kbase * d, Ks, FR, krows, d, sl * DC, DS, vec);
        stage_f32<T, DC, false>(v + kbase * d, Vs, FR, krows, d, sl * DC, DS, vec);
      }
      stage_f32<T, DC, false>(q + qrow * d, Qs, FC, qvalid, d, sl * DC, DS, vec);
      stage_f32<T, DC, false>(dout + qrow * d, Os, FC, qvalid, d, sl * DC, DS, vec);
      if (sl == 0)
        for (int i = threadIdx.x; i < FC; i += CC_THREADS) {
          Ls[i] = i < qvalid ? lse[qrow + i] : INFINITY;
          Dl[i] = i < qvalid ? delta[qrow + i] : 0.f;
        }
      __syncthreads();
      for (int dd = 0; dd < DC; ++dd) {
        const float kv = Ks[r * DS + dd], vv = Vs[r * DS + dd];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[i] = fmaf(kv, Qs[(l8 + 8 * i) * DS + dd], s[i]);
          dp[i] = fmaf(vv, Os[(l8 + 8 * i) * DS + dd], dp[i]);
        }
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
      Ps[r * (FC + 1) + c] = round_to<T>(p);
      Ds[r * (FC + 1) + c] = round_to<T>(p * (dp[i] - Dl[c]));
    }
    if (nslab > 1) {  // this block's columns of Q and dO
      __syncthreads();
      stage_f32<T, DC, false>(q + qrow * d, Qs, FC, qvalid, d, c0, DS, vec);
      stage_f32<T, DC, false>(dout + qrow * d, Os, FC, qvalid, d, c0, DS, vec);
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
      const int col = c0 + l8 + 8 * i;
      if (col >= d) continue;
      dk[(kbase + r) * d + col] = from_f32<T>(dka[i] * sm_scale);
      dv[(kbase + r) * d + col] = from_f32<T>(dva[i]);
    }
}

struct BwdArgs {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *dq, *dk, *dv;
  int bh, sq, sk, d, causal, q_offset, k_offset, k_valid;
  float sm_scale;
  cudaStream_t stream;
};

template <typename Kernel>
int set_smem(Kernel kernel, int bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename T, int DP>
int launch_mma(const BwdArgs& a, bool dq_pass) {
  if constexpr (!part_holds(true, DP)) {
    return kNotHere;
  } else {
    constexpr int THR = 128 * mma_split(DP);
    if (dq_pass) {
      auto kern = flash_bwd_dq_mma_kernel<T, DP>;
      const int smem = dq_mma_smem_bytes<DP>();
      if (int err = set_smem(kern, smem)) return err;
      kern<<<dim3(a.bh, (a.sq + MQ - 1) / MQ), THR, smem, a.stream>>>(
          (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout,
          (const float*)a.lse, (const float*)a.delta, (T*)a.dq, a.sq, a.sk,
          a.d, a.causal, a.q_offset, a.k_offset, a.sm_scale, a.k_valid);
    } else {
      auto kern = flash_bwd_dkv_mma_kernel<T, DP>;
      const int smem = dkv_mma_smem_bytes<DP>();
      if (int err = set_smem(kern, smem)) return err;
      kern<<<dim3(a.bh, (a.sk + MQ - 1) / MQ), THR, smem, a.stream>>>(
          (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout,
          (const float*)a.lse, (const float*)a.delta, (T*)a.dk, (T*)a.dv,
          a.sq, a.sk, a.d, a.causal, a.q_offset, a.k_offset, a.sm_scale,
          a.k_valid);
    }
    return (int)cudaGetLastError();
  }
}

template <typename T, int DC>
int launch_cc(const BwdArgs& a, bool dq_pass) {
  if constexpr (!part_holds(false, DC)) {
    return kNotHere;
  } else {
    const int smem = cc_smem_bytes<DC>();
    const int nz = (a.d + DC - 1) / DC;
    if (dq_pass) {
      auto kern = flash_bwd_dq_cc_kernel<T, DC>;
      if (int err = set_smem(kern, smem)) return err;
      kern<<<dim3(a.bh, (a.sq + FR - 1) / FR, nz), CC_THREADS, smem,
             a.stream>>>(
          (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout,
          (const float*)a.lse, (const float*)a.delta, (T*)a.dq, a.sq, a.sk,
          a.d, a.causal, a.q_offset, a.k_offset, a.sm_scale, a.k_valid);
    } else {
      auto kern = flash_bwd_dkv_cc_kernel<T, DC>;
      if (int err = set_smem(kern, smem)) return err;
      kern<<<dim3(a.bh, (a.sk + FR - 1) / FR, nz), CC_THREADS, smem,
             a.stream>>>(
          (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout,
          (const float*)a.lse, (const float*)a.delta, (T*)a.dk, (T*)a.dv,
          a.sq, a.sk, a.d, a.causal, a.q_offset, a.k_offset, a.sm_scale,
          a.k_valid);
    }
    return (int)cudaGetLastError();
  }
}

template <typename T>
int dispatch_cc(const BwdArgs& a, bool dq_pass) {
  switch (cc_width(a.d)) {
    case 16: return launch_cc<T, 16>(a, dq_pass);
    case 32: return launch_cc<T, 32>(a, dq_pass);
    default: return launch_cc<T, 64>(a, dq_pass);
  }
}

// bf16 and f16 up to D = 256 on the tensor cores, the rest on the CUDA cores.
template <typename T>
int dispatch_mma(const BwdArgs& a, bool dq_pass) {
  if (a.d > kMmaMaxD) return dispatch_cc<T>(a, dq_pass);
  switch (mma_width(a.d)) {
    case 16: return launch_mma<T, 16>(a, dq_pass);
    case 32: return launch_mma<T, 32>(a, dq_pass);
    case 48: return launch_mma<T, 48>(a, dq_pass);
    case 64: return launch_mma<T, 64>(a, dq_pass);
    case 96: return launch_mma<T, 96>(a, dq_pass);
    case 128: return launch_mma<T, 128>(a, dq_pass);
    default: return launch_mma<T, 256>(a, dq_pass);
  }
}

int run(const BwdArgs& a, int dtype, bool dq_pass) {
  switch (dtype) {
    case 0: return dispatch_cc<float>(a, dq_pass);
    case 1: return dispatch_mma<__nv_bfloat16>(a, dq_pass);
    case 2: return dispatch_mma<__half>(a, dq_pass);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

#if DDW_PART >= 0
#define DDW_CAT_(a, b) a##b
#define DDW_CAT(a, b) DDW_CAT_(a, b)
// This part's kernels (kNotHere for the others'); args is a BwdArgs.
int DDW_CAT(ddw_flash_bwd_part, DDW_PART)(const void* args, int dtype,
                                          int dq_pass) {
  return run(*static_cast<const BwdArgs*>(args), dtype, dq_pass != 0);
}
int ddw_flash_bwd_part0(const void* args, int dtype, int dq_pass);
int ddw_flash_bwd_part1(const void* args, int dtype, int dq_pass);
int ddw_flash_bwd_part2(const void* args, int dtype, int dq_pass);
int ddw_flash_bwd_part3(const void* args, int dtype, int dq_pass);
#endif

#if DDW_PART <= 0

static int dispatch(const BwdArgs& a, int dtype, bool dq_pass) {
  if (a.bh < 1 || a.sq < 1 || a.sk < 1 || a.d < 1 ||
      (a.sq + FR - 1) / FR > 65535 || (a.sk + FR - 1) / FR > 65535 ||
      (a.d + 63) / 64 > 65535)
    return (int)cudaErrorInvalidValue;
#if DDW_PART < 0
  return run(a, dtype, dq_pass);
#else
  using Part = int (*)(const void*, int, int);
  const Part parts[] = {ddw_flash_bwd_part0, ddw_flash_bwd_part1,
                        ddw_flash_bwd_part2, ddw_flash_bwd_part3};
  static_assert(sizeof(parts) / sizeof(parts[0]) == flash::kParts,
                "one ddw_flash_bwd_part<p> a part");
  for (const Part part : parts) {
    const int err = part(&a, dtype, dq_pass);
    if (err != flash::kNotHere) return err;
  }
  return (int)cudaErrorInvalidValue;
#endif
}

// K4: q, do [bh, sq, d], k/v [bh, sk, d] in float32 (dtype 0), bfloat16 (1)
// or float16 (2), lse and delta [bh, sq] float32, all contiguous and 16-byte
// aligned; dq [bh, sq, d] in the input dtype. Any d, sq, sk >= 1; k_valid < 0
// means no key mask. Returns a cudaError_t code.
int ddw_flash_bwd_dq(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dq, int bh, int sq, int sk, int d, int dtype,
                     int causal, int q_offset, int k_offset, float sm_scale,
                     int k_valid, void* stream) {
  const BwdArgs a{q, k, v, dout, lse, delta, dq, nullptr, nullptr, bh, sq,
                  sk, d, causal, q_offset, k_offset, k_valid, sm_scale,
                  static_cast<cudaStream_t>(stream)};
  return dispatch(a, dtype, true);
}

// K5: the inputs of K4; dk, dv [bh, sk, d] in the input dtype.
int ddw_flash_bwd_dkv(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dk, void* dv, int bh, int sq, int sk, int d,
                      int dtype, int causal, int q_offset, int k_offset,
                      float sm_scale, int k_valid, void* stream) {
  const BwdArgs a{q, k, v, dout, lse, delta, nullptr, dk, dv, bh, sq, sk, d,
                  causal, q_offset, k_offset, k_valid, sm_scale,
                  static_cast<cudaStream_t>(stream)};
  return dispatch(a, dtype, false);
}
#endif  // DDW_PART <= 0

}  // extern "C"
