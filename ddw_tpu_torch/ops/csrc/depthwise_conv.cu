// SAME 3x3 depthwise convolution, stride 1, NHWC — forward kernel for Hopper.
//
// Replaces ddw_tpu/ops/depthwise_conv.py `_fwd_kernel` / `_pallas_fwd` (the
// Pallas TPU kernel). It computes exactly what that kernel computes:
//   y[b,h,w,c] = sum_{dy,dx} xpad[b,h+dy,w+dx,c] * w[dy,dx,c]
// with zero padding of 1 on every side, accumulated in f32 in the order
// dy-major then dx, and the result cast to the input dtype. Each product and
// each sum is rounded on its own (__fmul_rn / __fadd_rn, no FMA contraction),
// as the plain PyTorch version in depthwise_conv.py does them, so the two
// agree to the last bit of the f32 accumulator.
//
// What bounds it: memory. A depthwise 3x3 does 9 multiply-adds per element
// read, far below the ~295 operations per byte at which the H100's compute
// becomes the limit. The least time is one read of x, one read of the taps
// and one write of y:
//   (2*B*H*W*C + 9*C) * bytes / 3.35 TB/s   (H100 SXM data sheet).
//
// Design. The TPU kernel holds a whole [H, W, C] image in VMEM per grid step;
// an H100 block has at most 227 KB of shared memory, so that blocking does
// not carry over. Here one thread computes V adjacent channels of a column of
// kRows = 4 output pixels (same w, rows h0..h0+3), with the channel index
// innermost in the thread numbering, so that neighbouring threads read
// neighbouring addresses (16-byte vector loads when C and the pointers allow:
// V = 8 for bf16, V = 4 for f32; else V = 1). The thread walks the 6 input
// rows h0-1..h0+4 once, each row feeding up to three output rows, so it loads
// 18 input vectors for 4 outputs instead of 36; the left and right taps are
// the neighbouring threads' columns, served by L1. Index arithmetic is 32-bit
// (the launcher refuses tensors of 2^30 work items or more). Border taps are
// skipped by bounds checks instead of a padded copy, and a grid-stride loop
// covers the tensor. The C entry returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 4;  // output rows per thread (a sliding 3-row window)

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

// V elements of T loaded or stored as one aligned vector.
template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

template <typename T, int V, int R>
__global__ void __launch_bounds__(256)
dw3x3_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                 T* __restrict__ y, int B, int H, int W, int C) {
  const int cv = C / V;              // channel vectors per pixel
  const int hb = (H + R - 1) / R;    // row blocks per image
  const int total = B * hb * W * cv;  // launch() keeps this below 2^30
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += gridDim.x * blockDim.x) {
    const int c0 = (i % cv) * V;
    int p = i / cv;
    const int wo = p % W;
    p /= W;
    const int h0 = (p % hb) * R;
    const int b = p / hb;
    const T* xb = x + (long long)b * H * W * C + c0;

    float acc[R][V];
#pragma unroll
    for (int o = 0; o < R; ++o)
#pragma unroll
      for (int k = 0; k < V; ++k) acc[o][k] = 0.0f;

    // Input rows h0-1 .. h0+R in ascending order: every output row then
    // receives its taps dy = 0, 1, 2 in that order, dx innermost.
#pragma unroll
    for (int r = 0; r < R + 2; ++r) {
      const int hi = h0 - 1 + r;
      if (hi < 0 || hi >= H) continue;
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const int wi = wo + dx - 1;
        if (wi < 0 || wi >= W) continue;
        const Pack<T, V> xv = *reinterpret_cast<const Pack<T, V>*>(
            xb + ((long long)hi * W + wi) * C);
#pragma unroll
        for (int o = 0; o < R; ++o) {
          const int dy = r - o;
          if (dy < 0 || dy > 2) continue;
          const Pack<T, V> wv = *reinterpret_cast<const Pack<T, V>*>(
              w + (dy * 3 + dx) * C + c0);
#pragma unroll
          for (int k = 0; k < V; ++k)
            acc[o][k] = __fadd_rn(acc[o][k],
                                  __fmul_rn(to_f32(xv.v[k]), to_f32(wv.v[k])));
        }
      }
    }

#pragma unroll
    for (int o = 0; o < R; ++o) {
      if (h0 + o >= H) break;
      Pack<T, V> out;
#pragma unroll
      for (int k = 0; k < V; ++k) out.v[k] = from_f32<T>(acc[o][k]);
      *reinterpret_cast<Pack<T, V>*>(
          y + (((long long)b * H + h0 + o) * W + wo) * C + c0) = out;
    }
  }
}

template <typename T, int V>
int launch(const void* x, const void* w, void* y, int B, int H, int W, int C,
           cudaStream_t stream) {
  const long long total = (long long)B * ((H + kRows - 1) / kRows) * W * (C / V);
  if (total >= (1LL << 30)) return (int)cudaErrorInvalidValue;  // int math
  const int threads = 256;
  int device = 0, sms = 132;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  long long blocks = (total + threads - 1) / threads;
  const long long cap = (long long)sms * 32;  // grid-stride beyond this
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  dw3x3_fwd_kernel<T, V, kRows><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y),
      B, H, W, C);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. vec: channels per thread (f32: 4 or 1,
// bf16: 8 or 1); the caller guarantees C % vec == 0 and 16-byte aligned
// pointers when vec > 1. Returns the cudaError_t of the launch (0 = success).
extern "C" int ddw_dw3x3_fwd(const void* x, const void* w, void* y, int B,
                             int H, int W, int C, int dtype, int vec,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && vec == 4) return launch<float, 4>(x, w, y, B, H, W, C, s);
  if (dtype == 0 && vec == 1) return launch<float, 1>(x, w, y, B, H, W, C, s);
  if (dtype == 1 && vec == 8) return launch<__nv_bfloat16, 8>(x, w, y, B, H, W, C, s);
  if (dtype == 1 && vec == 1) return launch<__nv_bfloat16, 1>(x, w, y, B, H, W, C, s);
  return (int)cudaErrorInvalidValue;
}
