// Pieces shared by the flash-attention kernels of flash_attention.cu (K3,
// the forward) and flash_attention_bwd.cu (K4 and K5, the backward): the
// value types, the staging of tiles into shared memory with the head dim's
// tail zero-filled, and the mma.sync m16n8k16 products in bf16 or f16.
//
// Head dims. A kernel is compiled for a few widths and takes any head dim d
// up to its width: tiles are staged at the compiled width with the columns
// at or past d zero-filled in shared memory (they add exact zeros to every
// product), loads and stores are masked at d, and the caller's sm_scale is
// that of the true d. Global rows are d values long, so a row starts on a
// 16-byte boundary only when d * sizeof(value) is a multiple of 16: staging
// then moves 16 bytes a thread, and otherwise falls back to scalar loads.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace flash {

constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int CC_THREADS = 256;  // a CUDA-core kernel's block
constexpr int MQ = 64;           // an mma block's own rows: 4 row warps x 16
constexpr int MPAD = 8;          // 16-bit values of row padding (ldmatrix banks)

// The mma kernels' compiled head dims (d is rounded up to the next) and the
// CUDA-core kernels' column widths (d up to 32 rounds up to one of the first
// two; a wider d runs in slabs of 64). ops/flash_attention.py lists the same.
constexpr int kMmaMaxD = 256;

__host__ __device__ constexpr int mma_width(int d) {
  return d <= 16 ? 16 : d <= 32 ? 32 : d <= 48 ? 48 : d <= 64 ? 64
       : d <= 96 ? 96 : d <= 128 ? 128 : 256;
}

__host__ __device__ constexpr int cc_width(int d) {
  return d <= 16 ? 16 : d <= 32 ? 32 : 64;
}

// Parts. A source that declares `// nvcc parts: N` is compiled N times side
// by side, with -DDDW_PART=p, and the objects are linked into one library
// (ops/_build.py): one nvcc over every width of both files took 30-44 s.
// Part p instantiates only the kernels part_holds() gives it and answers
// kNotHere for the others; part 0 also holds the C entries, which ask each
// part in turn. Without DDW_PART one translation unit holds everything.
#ifndef DDW_PART
#define DDW_PART -1
#endif
constexpr int kPart = DDW_PART;
constexpr int kParts = 4;
constexpr int kNotHere = -1;  // no cudaError_t is negative

// By compiled width, so that the slowest to compile stand apart: mma 16-64,
// mma 96-128, mma 256, and every CUDA-core width.
constexpr int part_of(bool mma, int width) {
  return !mma ? 3 : width <= 64 ? 0 : width <= 128 ? 1 : 2;
}

constexpr bool part_holds(bool mma, int width) {
  return kPart < 0 || kPart == part_of(mma, width);
}

// Warps that split the head dim of an mma block's accumulators: one above a
// compiled width of 128 would hold 64 f32 registers of output per 8 columns.
__host__ __device__ constexpr int mma_split(int dp) { return dp > 128 ? 2 : 1; }

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <> __device__ __forceinline__ float to_f32<__half>(__half v) {
  return __half2float(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}

// v rounded to T and back: the TPU kernels' casts of p and ds to the input
// dtype before a product (none for f32).
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f32<T>(from_f32<T>(v));
}

// V elements of T loaded as one aligned 16-byte vector.
template <typename T, int V>
struct alignas(16) Pack {
  T v[V];
};

// ---- the CUDA-core kernels' staging ----------------------------------------

// Copy `rows` rows (of `valid` real ones) x DC columns, from column c0, of a
// row-major [*, d] tensor into shared memory as f32: dst[r * stride + c], or
// transposed dst[c * stride + r]. Rows past `valid` and columns past d are
// zero. `vec`: d * sizeof(T) is a multiple of 16, so 16-byte loads.
template <typename T, int DC, bool kTrans>
__device__ __forceinline__ void stage_f32(const T* __restrict__ src, float* dst,
                                          int rows, int valid, int d, int c0,
                                          int stride, bool vec) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int DV = DC / VEC;
  static_assert(DC % VEC == 0, "a width of whole vectors");
  for (int idx = threadIdx.x; idx < rows * DV; idx += CC_THREADS) {
    const int r = kTrans ? idx % rows : idx / DV;
    const int dv = kTrans ? idx / rows : idx % DV;
    const int col = c0 + dv * VEC;
    float f[VEC];
    if (vec && r < valid && col < d) {
      const Pack<T, VEC> pk =
          *reinterpret_cast<const Pack<T, VEC>*>(src + (size_t)r * d + col);
#pragma unroll
      for (int e = 0; e < VEC; ++e) f[e] = to_f32<T>(pk.v[e]);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        f[e] = (r < valid && col + e < d) ? to_f32<T>(src[(size_t)r * d + col + e])
                                          : 0.f;
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const int c = dv * VEC + e;
      dst[kTrans ? c * stride + r : r * stride + c] = f[e];
    }
  }
}

// ---- bf16 and f16 on the tensor cores: mma.sync m16n8k16, f32 sums ---------

template <typename T> struct Mma;

template <> struct Mma<__nv_bfloat16> {
  static __device__ __forceinline__ void run(float (&c)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  // two floats rounded to nearest even, the lower column in the low half
  static __device__ __forceinline__ uint32_t pack2(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
};

template <> struct Mma<__half> {
  static __device__ __forceinline__ void run(float (&c)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ uint32_t pack2(float lo, float hi) {
    const __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
};

__device__ __forceinline__ uint32_t lds32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Four 8x8 16-bit matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8 and receives row l / 4, columns 2 (l % 4) + {0, 1}
// of each (with .trans: column l / 4, rows 2 (l % 4) + {0, 1}).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// Two 8x8 matrices: lanes 0-15 give the row addresses (row l % 8 of matrix
// l / 8); every lane receives row l / 4, columns 2 (l % 4) + {0, 1}.
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// Copy `rows` rows (of `valid` real ones) x DP columns of a row-major [*, d]
// tensor of 16-bit values into shared memory with row stride DP + MPAD, 16
// bytes a thread of NTHR; rows past `valid` and columns past d are zero.
// `vec`: d is a multiple of 8, so every row starts 16-byte aligned.
template <int DP, int NTHR>
__device__ __forceinline__ void stage16(const void* __restrict__ src_, void* dst_,
                                        int rows, int valid, int d, bool vec) {
  const uint16_t* src = static_cast<const uint16_t*>(src_);
  uint16_t* dst = static_cast<uint16_t*>(dst_);
  constexpr int QS = DP + MPAD, DV = DP / 8;
  for (int idx = threadIdx.x; idx < rows * DV; idx += NTHR) {
    const int r = idx / DV, col = (idx % DV) * 8;
    uint4 pk = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid && col < d) {
      if (vec) {
        pk = *reinterpret_cast<const uint4*>(src + (size_t)r * d + col);
      } else {
        uint16_t* e = reinterpret_cast<uint16_t*>(&pk);
#pragma unroll
        for (int k = 0; k < 8; ++k)
          if (col + k < d) e[k] = src[(size_t)r * d + col + k];
      }
    }
    *reinterpret_cast<uint4*>(dst + r * QS + col) = pk;
  }
}

// The A fragment (16 x 16) whose row g, columns 2t, 2t + 1 sit at p, in a
// tile of row stride qs.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const void* p, int qs) {
  const uint16_t* w = static_cast<const uint16_t*>(p);
  a[0] = lds32(w);
  a[1] = lds32(w + 8 * qs);
  a[2] = lds32(w + 8);
  a[3] = lds32(w + 8 * qs + 8);
}

// acc[j] (the 16 x 8 tile j of a warp's 16 x NB block) += A . B^T, the sum
// over the head dim: A the warp's 16 rows of a [*][DP + MPAD] tile from
// `a_rows`, B the NB rows of a [NB][DP + MPAD] tile. 8-row tiles of B at or
// past `nb` are skipped. A's fragments are read from shared memory two
// k-steps at a time, so no operand stays in registers across calls.
template <typename T, int DP, int NB>
__device__ __forceinline__ void mma_abt(float (&acc)[NB / 8][4], const T* a_rows,
                                        const T* b_tile, int lane, int nb = NB) {
  constexpr int QS = DP + MPAD, KS = DP / 16;
  const int g = lane >> 2, t = lane & 3;
  const T* aw = a_rows + g * QS + 2 * t;
#pragma unroll
  for (int ks = 0; ks + 1 < KS; ks += 2) {
    uint32_t a0[4], a1[4];
    load_a(a0, aw + ks * 16, QS);
    load_a(a1, aw + ks * 16 + 16, QS);
#pragma unroll
    for (int j = 0; j < NB / 8; ++j) {
      if (j * 8 >= nb) break;
      uint32_t b[4];
      ldsm_x4(b, b_tile + (j * 8 + (lane & 7)) * QS + (lane >> 3) * 8 + ks * 16);
      Mma<T>::run(acc[j], a0, b[0], b[1]);
      Mma<T>::run(acc[j], a1, b[2], b[3]);
    }
  }
  if constexpr (KS % 2 == 1) {  // the last 16 of an odd number of k-steps
    uint32_t a0[4];
    load_a(a0, aw + (KS - 1) * 16, QS);
#pragma unroll
    for (int j = 0; j < NB / 8; ++j) {
      if (j * 8 >= nb) break;
      uint32_t b[2];
      ldsm_x2(b, b_tile + (j * 8 + (lane & 7)) * QS + ((lane >> 3) & 1) * 8 +
                     (KS - 1) * 16);
      Mma<T>::run(acc[j], a0, b[0], b[1]);
    }
  }
}

// out[j] (the 16 x 8 tile j of a warp's 16 x 8 DT block) += round(x) . B: x
// the warp's 16 x NB f32 block in the accumulator layout, rounded to T as it
// becomes the A operand (FA2's layout identity: two 16 x 8 accumulator tiles
// are one 16 x 16 A fragment), B the rows of a [NB][DP + MPAD] tile from
// column c0 (contraction over its rows). 16-row steps at or past nb skipped.
template <typename T, int DP, int NB, int DT>
__device__ __forceinline__ void mma_xb(float (&out)[DT][4], const float (&x)[NB / 8][4],
                                       const T* b_tile, int c0, int lane, int nb = NB) {
  constexpr int QS = DP + MPAD;
  static_assert(DT % 2 == 0, "B fragments come in pairs");
#pragma unroll
  for (int kk = 0; kk < NB / 16; ++kk) {
    if (kk * 16 >= nb) break;
    const uint32_t a[4] = {Mma<T>::pack2(x[2 * kk][0], x[2 * kk][1]),
                           Mma<T>::pack2(x[2 * kk][2], x[2 * kk][3]),
                           Mma<T>::pack2(x[2 * kk + 1][0], x[2 * kk + 1][1]),
                           Mma<T>::pack2(x[2 * kk + 1][2], x[2 * kk + 1][3])};
    const T* r = b_tile + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * QS +
                 (lane >> 4) * 8 + c0;
#pragma unroll
    for (int j = 0; j < DT; j += 2) {
      uint32_t b[4];
      ldsm_x4_trans(b, r + j * 8);
      Mma<T>::run(out[j], a, b[0], b[1]);
      Mma<T>::run(out[j + 1], a, b[2], b[3]);
    }
  }
}

// Columns c and c + 1 (c even) of an output row of d values, rounded to T;
// none at or past d. One 4-byte store where d is even (the pair is then
// aligned), two scalar ones otherwise.
template <typename T>
__device__ __forceinline__ void store2(T* row, int c, int d, float lo, float hi) {
  if ((d & 1) == 0 && c + 1 < d) {
    *reinterpret_cast<uint32_t*>(row + c) = Mma<T>::pack2(lo, hi);
  } else {
    if (c < d) row[c] = from_f32<T>(lo);
    if (c + 1 < d) row[c + 1] = from_f32<T>(hi);
  }
}

}  // namespace flash
