// SAME 3x3 depthwise convolution, stride 1, NHWC — the forward kernel (K1,
// also the input gradient on flipped taps) and the weight-gradient kernel (K2,
// below) for Hopper: the "simt" variant, per-thread global loads. The main
// path runs the "tma" variant of depthwise_sm90.cu; this one takes the shapes
// that one refuses (C * bytes not a multiple of 16, unaligned pointers) and
// is kept for timing the two in turns (`_variant="simt"`).
//
// K1 replaces ddw_tpu/ops/depthwise_conv.py `_fwd_kernel` / `_pallas_fwd` (the
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
                 T* __restrict__ y, int B, int H, int W, int C, int flip) {
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
              w + (flip ? 8 - (dy * 3 + dx) : dy * 3 + dx) * C + c0);
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
           int flip, cudaStream_t stream) {
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
      B, H, W, C, flip);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K2 — the weight gradient of the same convolution.
//
// Replaces ddw_tpu/ops/depthwise_conv.py `_dw_kernel` / `_pallas_dw`:
//   dw[dy,dx,c] = sum_{b,h,w} xpad[b,h+dy,w+dx,c] * g[b,h,w,c]
// accumulated in f32 and written as f32 [3, 3, C] (the caller casts it to the
// tap dtype, as `_vjp_bwd` does).
//
// What bounds it: memory. It reads x and g once each and writes 9*C floats;
// 9 multiply-adds per element pair is far below the H100's ~295 operations
// per byte. The least time is
//   (2*B*H*W*C * bytes + 9*C*4) / 3.35 TB/s   (H100 SXM data sheet).
//
// Design. The TPU kernel keeps its [3, 3, C] output block resident and adds
// one image per step of a sequential ("arbitrary") grid. Hopper blocks run in
// no order, and float atomics would make the sum depend on that order, so the
// reduction is two deterministic passes instead:
//  1. `dw3x3_wgrad_partial_kernel`: the B*H rows are cut into tiles of
//     kTileRows rows of one image; block (tile, channel block) writes the
//     tile's f32 partial [9, C] to a workspace [tiles, 9, C]. A thread owns V
//     adjacent channels (channels innermost, 16-byte vector loads as in K1)
//     of a set of columns w = lane, lane + lanes, ..., and slides a 3x3
//     window of x down each column of the tile: one new x row of three
//     pixels and one g pixel per output row, 9*V multiply-adds into registers.
//     The block then sums its lanes' registers through shared memory, one tap
//     at a time, lane by lane in order.
//  2. `dw3x3_wgrad_reduce_kernel`: each output (tap, channel) is the sum of
//     its tiles' partials: 32 row groups sum tiles t = r, r + 32, ... in
//     order, then one thread adds the 32 group sums in order.
// Every sum has a fixed order that does not depend on scheduling, so two
// launches on the same input give the same bits. Index arithmetic inside an
// image is 32-bit, as in K1 (the launcher refuses 2^30 elements or more).

constexpr int kTileRows = 16;      // rows of one image per partial tile
constexpr int kWgradThreads = 256;
constexpr int kReduceGroups = 32;  // pass 2: row groups per output

template <typename T, int V>
__device__ __forceinline__ Pack<T, V> load_or_zero(const T* xb, int hi, int wi,
                                                   int H, int W, int C) {
  Pack<T, V> p;
  if (hi < 0 || hi >= H || wi < 0 || wi >= W) {
#pragma unroll
    for (int k = 0; k < V; ++k) p.v[k] = from_f32<T>(0.0f);
    return p;
  }
  return *reinterpret_cast<const Pack<T, V>*>(xb + (hi * W + wi) * C);
}

template <typename T, int V>
__global__ void __launch_bounds__(kWgradThreads)
dw3x3_wgrad_partial_kernel(const T* __restrict__ x, const T* __restrict__ g,
                           float* __restrict__ part, int H, int W, int C,
                           int cvb) {
  const int cv = C / V;
  const int hb = (H + kTileRows - 1) / kTileRows;
  const int tile = blockIdx.x;
  const int b = tile / hb;
  const int h0 = (tile % hb) * kTileRows;
  const int h1 = min(h0 + kTileRows, H);
  const int lanes = blockDim.x / cvb;
  const int lane = threadIdx.x / cvb;
  const int cvl = threadIdx.x % cvb;
  const int cvi = blockIdx.y * cvb + cvl;

  float acc[9][V];
#pragma unroll
  for (int k = 0; k < 9; ++k)
#pragma unroll
    for (int v = 0; v < V; ++v) acc[k][v] = 0.0f;

  if (cvi < cv) {
    const long long img = (long long)b * H * W * C + cvi * V;
    const T* xb = x + img;
    const T* gb = g + img;
    for (int wo = lane; wo < W; wo += lanes) {
      Pack<T, V> win[3][3];  // x rows h-1, h, h+1 at columns wo-1, wo, wo+1
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        win[0][dx] = load_or_zero<T, V>(xb, h0 - 1, wo + dx - 1, H, W, C);
        win[1][dx] = load_or_zero<T, V>(xb, h0, wo + dx - 1, H, W, C);
      }
      for (int h = h0; h < h1; ++h) {
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
          win[2][dx] = load_or_zero<T, V>(xb, h + 1, wo + dx - 1, H, W, C);
        const Pack<T, V> gv =
            *reinterpret_cast<const Pack<T, V>*>(gb + (h * W + wo) * C);
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
#pragma unroll
          for (int dx = 0; dx < 3; ++dx)
#pragma unroll
            for (int v = 0; v < V; ++v)
              acc[dy * 3 + dx][v] = __fmaf_rn(to_f32(win[dy][dx].v[v]),
                                              to_f32(gv.v[v]),
                                              acc[dy * 3 + dx][v]);
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          win[0][dx] = win[1][dx];
          win[1][dx] = win[2][dx];
        }
      }
    }
  }

  // Sum the lanes of each channel, one tap at a time, in lane order.
  __shared__ float red[kWgradThreads * 8];
#pragma unroll
  for (int k = 0; k < 9; ++k) {
#pragma unroll
    for (int v = 0; v < V; ++v) red[threadIdx.x * V + v] = acc[k][v];
    __syncthreads();
    if (threadIdx.x < cvb * V) {
      const int cl = threadIdx.x / V, v = threadIdx.x % V;
      if (blockIdx.y * cvb + cl < cv) {
        float s = 0.0f;
        for (int l = 0; l < lanes; ++l) s += red[(l * cvb + cl) * V + v];
        part[((long long)tile * 9 + k) * C + (blockIdx.y * cvb + cl) * V + v] = s;
      }
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kReduceGroups * 32)
dw3x3_wgrad_reduce_kernel(const float* __restrict__ part,
                          float* __restrict__ dw, int tiles, int n) {
  const int col = threadIdx.x % 32;
  const int r = threadIdx.x / 32;
  const int j = blockIdx.x * 32 + col;
  float s = 0.0f;
  if (j < n)
    for (int t = r; t < tiles; t += kReduceGroups) s += part[(long long)t * n + j];
  __shared__ float red[kReduceGroups][33];
  red[r][col] = s;
  __syncthreads();
  if (r == 0 && j < n) {
    float tot = 0.0f;
    for (int i = 0; i < kReduceGroups; ++i) tot += red[i][col];
    dw[j] = tot;
  }
}

long long wgrad_tiles(int B, int H) {
  return (long long)B * ((H + kTileRows - 1) / kTileRows);
}

template <typename T, int V>
int launch_wgrad(const void* x, const void* g, float* part, float* dw, int B,
                 int H, int W, int C, cudaStream_t stream) {
  if ((long long)B * H * W * C >= (1LL << 30)) return (int)cudaErrorInvalidValue;
  const int cv = C / V;
  const int cvb = cv < 32 ? cv : 32;
  const int lanes = kWgradThreads / cvb;
  const long long tiles = wgrad_tiles(B, H);
  const dim3 grid((unsigned)tiles, (unsigned)((cv + cvb - 1) / cvb));
  dw3x3_wgrad_partial_kernel<T, V><<<grid, lanes * cvb, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), part, H, W, C, cvb);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const int n = 9 * C;
  dw3x3_wgrad_reduce_kernel<<<(n + 31) / 32, kReduceGroups * 32, 0, stream>>>(
      part, dw, (int)tiles, n);
  return (int)cudaGetLastError();
}

}  // namespace

// Floats of f32 workspace K2 needs for x of shape [B, H, W, C].
extern "C" long long ddw_dw3x3_wgrad_workspace(int B, int H, int W, int C) {
  (void)W;
  return wgrad_tiles(B, H) * 9 * C;
}

// K2: dw (f32 [3, 3, C]) from x and g (both [B, H, W, C], the same dtype).
// part is the caller's f32 workspace of ddw_dw3x3_wgrad_workspace() floats.
// dtype and vec as for ddw_dw3x3_fwd. Returns the cudaError_t of the launches.
extern "C" int ddw_dw3x3_wgrad(const void* x, const void* g, void* part,
                               void* dw, int B, int H, int W, int C, int dtype,
                               int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  float* d = static_cast<float*>(dw);
  if (dtype == 0 && vec == 4) return launch_wgrad<float, 4>(x, g, p, d, B, H, W, C, s);
  if (dtype == 0 && vec == 1) return launch_wgrad<float, 1>(x, g, p, d, B, H, W, C, s);
  if (dtype == 1 && vec == 8)
    return launch_wgrad<__nv_bfloat16, 8>(x, g, p, d, B, H, W, C, s);
  if (dtype == 1 && vec == 1)
    return launch_wgrad<__nv_bfloat16, 1>(x, g, p, d, B, H, W, C, s);
  return (int)cudaErrorInvalidValue;
}

// dtype: 0 = float32, 1 = bfloat16. vec: channels per thread (f32: 4 or 1,
// bf16: 8 or 1); the caller guarantees C % vec == 0 and 16-byte aligned
// pointers when vec > 1. flip != 0 reads the taps w[2-dy][2-dx] (the input
// gradient). Returns the cudaError_t of the launch (0 = success).
extern "C" int ddw_dw3x3_fwd(const void* x, const void* w, void* y, int B,
                             int H, int W, int C, int dtype, int vec,
                             int flip, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && vec == 4) return launch<float, 4>(x, w, y, B, H, W, C, flip, s);
  if (dtype == 0 && vec == 1) return launch<float, 1>(x, w, y, B, H, W, C, flip, s);
  if (dtype == 1 && vec == 8) return launch<__nv_bfloat16, 8>(x, w, y, B, H, W, C, flip, s);
  if (dtype == 1 && vec == 1) return launch<__nv_bfloat16, 1>(x, w, y, B, H, W, C, flip, s);
  return (int)cudaErrorInvalidValue;
}
