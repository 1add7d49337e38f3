// SAME 3x3 depthwise convolution, stride 1, NHWC, for Hopper: the "tma"
// variant of the forward kernel (K1, also the input gradient on flipped taps)
// and of the weight-gradient kernel (K2). Both are fed by one TMA loader of
// halo tiles. depthwise_conv.cu keeps the "simt" variant for the shapes this
// one does not take (C * bytes not a multiple of 16, unaligned pointers); the
// choice is `_dw_variant` in ops/depthwise_conv.py.
//
// K1 replaces ddw_tpu/ops/depthwise_conv.py `_fwd_kernel` (:46) / `_pallas_fwd`
// (:74), K2 `_dw_kernel` (:57) / `_pallas_dw` (:91):
//   y[b,h,w,c]   = sum_{dy,dx} xpad[b,h+dy,w+dx,c] * w[dy,dx,c]
//   dw[dy,dx,c]  = sum_{b,h,w} xpad[b,h+dy,w+dx,c] * g[b,h,w,c]
// with zero padding of 1 on every side. K1 accumulates in f32 from 0.0 in the
// order dy-major then dx, each product and each sum rounded on its own
// (__fmul_rn / __fadd_rn, no FMA), and rounds once to the input dtype: the
// bits of depthwise_conv3x3_plain. With `flip` it reads w[2-dy][2-dx], the
// taps of the input gradient, in the same order. K2 accumulates f32 FMAs and
// writes f32 [3, 3, C], within 1e-5 * sum|xpad * g| of the exact sum.
//
// What bounds them: memory. 9 multiply-adds per element read, against the
// H100's ~295 operations per byte. K1 reads x once and writes y once, K2
// reads x and g once: (2 * B*H*W*C * bytes) / 3.35 TB/s each (H100 SXM data
// sheet), plus 9*C taps or f32 outputs. The non-FMA arithmetic of K1 (18
// instructions an element) comes to about half of that time at the card's
// FP32 issue rate, so the design keeps every other instruction out of the
// inner loop too.
//
// Design, and what each step does about that:
// - One 4-D TMA tensor map over NHWC x, dims {C, W, H, B}, box {CB, TW+2,
//   TH+2, 1}, no swizzle. A box that starts at (c0, w0-1, h0-1, b) is the
//   tile with its one-pixel halo; what lies outside the tensor arrives as
//   zero, which is SAME padding: no border branch, no padding bytes read.
//   Interior halos are L2 hits. K2 adds a map over g with box {CB, TW, TH, 1}
//   under the same mbarrier transaction.
// - Persistent blocks over a fixed partition: block (cb, p) takes channel
//   block cb and the contiguous range [p*T/P, (p+1)*T/P) of the T spatial
//   tiles (image-major, then tile rows, then tile columns). P and the tiles
//   come from `dw_tile_plan` (ops/depthwise_conv.py), a function of the shape
//   alone, never of the SM count, so K2's partials and the order of every
//   sum are fixed: two launches give the same bits.
// - A ring of S stages (2 to 4; the plan takes 2, which measured fastest)
//   in dynamic shared memory behind one mbarrier each. Thread 0 issues the
//   first loads, and after the block has finished a tile (__syncthreads)
//   issues tile i+S into the freed stage, so S-1 tiles are in flight while
//   the block computes.
// - A thread owns V channels (16 bytes) of a strip of kRows output rows at
//   one column of the tile, channels innermost: a warp reads contiguous
//   16-byte vectors of shared memory, without bank conflicts, and K1 writes
//   16-byte vectors to global memory. The channel block of a block never
//   changes, so K1's 9 x V taps are loaded once into f32 registers.
// - K1 walks the kRows + 2 input rows of the strip once, each feeding up to
//   three output rows: 3 * (kRows + 2) vector reads for kRows outputs.
// - K2 keeps its 9 x V f32 sums in registers across every tile of the block
//   (the x window is read from shared memory, not held in registers), then
//   reduces the threads of a channel vector once, through shared memory:
//   every thread takes columns of the [rows, 9 x CB] table of sums and adds
//   its rows in order, and the block writes one [9, CB] partial. A second
//   small launch sums the P partials of each output in a fixed order.
// The C entries return cudaGetLastError() after the launches, or 1000 plus
// the CUresult when a tensor map cannot be encoded.

#include <cuda.h>  // CUtensorMap and its enums: types only, nothing linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 4;          // output rows of a thread's strip
constexpr int kMaxThreads = 256;  // the plan keeps a tile's threads at or below
constexpr int kBarBytes = 128;    // the stages' mbarriers, ahead of the tiles
constexpr int kMaxStages = 4;
constexpr int kReduceGroups = 32;  // K2's second pass: row groups per output
constexpr int kEncodeError = 1000;
constexpr uint64_t kWaitBoundNs = 10000000000ull;  // 10 s: see mbar_wait

template <typename T> struct Traits;
template <> struct Traits<float> {
  static constexpr int V = 4;
  static constexpr CUtensorMapDataType kType = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
};
template <> struct Traits<__nv_bfloat16> {
  static constexpr int V = 8;
  static constexpr CUtensorMapDataType kType = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};

// The launch's geometry, derived on the host from the plan (see make_plan).
struct Plan {
  int H, W, C;
  int th, tw, cb;   // tile rows, columns and channels
  int stages;
  int parts;        // P: blocks per channel block
  int nth, ntw;     // tiles down and across an image
  int tiles;        // spatial tiles per channel block: B * nth * ntw
  int strips;       // ceil(th / kRows)
  int xbytes;       // one stage's x box, rounded up to 128 bytes
  int gbytes;       // one stage's g box (K2), rounded up to 128 bytes
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

// Wait until the phase of parity `parity` has completed. Every load is
// waited for exactly once, so a wait that lasts kWaitBoundNs is a fault: it
// traps (the launch fails with a CUDA error) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  uint64_t t0, now;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t0));
  while (!mbar_try_wait(bar, parity)) {
    asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(now));
    if (now - t0 > kWaitBoundNs) __trap();
  }
}

// One box of `map` at (c, w, h, b), innermost first, into shared memory,
// completing `bar`'s transaction count. Coordinates may be negative or past
// the end: those elements arrive as zero.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c, int w, int h, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c), "r"(w), "r"(h), "r"(b)
      : "memory");
}

// ---- vectors of V channels --------------------------------------------------

__device__ __forceinline__ void unpack(const uint4& r, float (&f)[4]) {
  f[0] = __uint_as_float(r.x);
  f[1] = __uint_as_float(r.y);
  f[2] = __uint_as_float(r.z);
  f[3] = __uint_as_float(r.w);
}

__device__ __forceinline__ void unpack(const uint4& r, float (&f)[8]) {
  const uint32_t u[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // bf16 -> f32 is exact: the high 16 bits
    f[2 * i] = __uint_as_float(u[i] << 16);
    f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint4 pack(const float (&f)[4]) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                    __float_as_uint(f[2]), __float_as_uint(f[3]));
}

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

__device__ __forceinline__ uint4 pack(const float (&f)[8]) {
  return make_uint4(bf16x2(f[0], f[1]), bf16x2(f[2], f[3]), bf16x2(f[4], f[5]),
                    bf16x2(f[6], f[7]));
}


// ---- the tile walk ----------------------------------------------------------

// The block's channel block and its range [t0, t1) of spatial tiles.
struct Range {
  int cb, part, t0, t1;
};

__device__ __forceinline__ Range block_range(const Plan& p) {
  Range r;
  r.cb = blockIdx.x / p.parts;
  r.part = blockIdx.x % p.parts;
  r.t0 = (int)((long long)r.part * p.tiles / p.parts);
  r.t1 = (int)((long long)(r.part + 1) * p.tiles / p.parts);
  return r;
}

__device__ __forceinline__ void tile_origin(const Plan& p, int t, int& b, int& h0, int& w0) {
  const int per_image = p.nth * p.ntw;
  b = t / per_image;
  const int r = t - b * per_image;
  h0 = (r / p.ntw) * p.th;
  w0 = (r % p.ntw) * p.tw;
}

// Thread 0: load spatial tile t of the channel block at c0 into stage s: x
// with its halo and, for K2 (gmap non-null), the g tile, under one
// transaction count on the stage's barrier.
template <typename T>
__device__ __forceinline__ void issue(const Plan& p, const CUtensorMap* xmap,
                                      const CUtensorMap* gmap, uint32_t base, int s,
                                      int t, int c0) {
  int b, h0, w0;
  tile_origin(p, t, b, h0, w0);
  const uint32_t bar = base + 8 * s;
  const uint32_t dst = base + kBarBytes + s * (p.xbytes + p.gbytes);
  uint32_t bytes = (p.th + 2) * (p.tw + 2) * p.cb * (uint32_t)sizeof(T);
  if (gmap) bytes += p.th * p.tw * p.cb * (uint32_t)sizeof(T);
  mbar_expect_tx(bar, bytes);
  tma_load_4d(dst, xmap, bar, c0, w0 - 1, h0 - 1, b);
  if (gmap) tma_load_4d(dst + p.xbytes, gmap, bar, c0, w0, h0, b);
}

// Barriers, then the first min(S, n) loads. Every thread calls it.
template <typename T>
__device__ __forceinline__ void start_ring(const Plan& p, const CUtensorMap* xmap,
                                           const CUtensorMap* gmap, uint32_t base,
                                           const Range& r) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) mbar_init(base + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int i = 0; i < p.stages && r.t0 + i < r.t1; ++i)
      issue<T>(p, xmap, gmap, base, i, r.t0 + i, r.cb * p.cb);
  }
  __syncthreads();
}

// After every thread has finished tile i (in stage i % S): thread 0 refills
// the stage with tile i + S. The fence orders the threads' reads of the stage
// before the TMA's writes to it.
template <typename T>
__device__ __forceinline__ void next_tile(const Plan& p, const CUtensorMap* xmap,
                                          const CUtensorMap* gmap, uint32_t base,
                                          const Range& r, int i) {
  __syncthreads();
  if (threadIdx.x == 0 && r.t0 + i + p.stages < r.t1) {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    issue<T>(p, xmap, gmap, base, i % p.stages, r.t0 + i + p.stages, r.cb * p.cb);
  }
}

// ---- K1 ---------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kMaxThreads, 2)
dw3x3_fwd_tma_kernel(const __grid_constant__ CUtensorMap xmap, const T* __restrict__ w,
                     T* __restrict__ y, const Plan p, const int flip) {
  constexpr int V = Traits<T>::V;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t base = smem_u32(smem);
  const Range r = block_range(p);
  const int cvb = p.cb / V;
  const int cv = threadIdx.x % cvb, j = threadIdx.x / cvb;
  const int col = j % p.tw, r0 = (j / p.tw) * kRows;
  const bool active = r0 < p.th;  // threads past the tile's items idle
  const int c = r.cb * p.cb + cv * V;
  const bool cvalid = active && c < p.C;

  start_ring<T>(p, &xmap, nullptr, base, r);

  float wt[9][V];  // this thread's taps, in f32, for every tile
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    if (cvalid) {
      const int src = flip ? 8 - k : k;  // w[2-dy][2-dx] for the input gradient
      unpack(*reinterpret_cast<const uint4*>(w + (long long)src * p.C + c), wt[k]);
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v) wt[k][v] = 0.0f;
    }
  }

  const int n = r.t1 - r.t0;
  for (int i = 0; i < n; ++i) {
    const int s = i % p.stages;
    mbar_wait(base + 8 * s, (i / p.stages) & 1);
    if (active) {
      const unsigned char* tile = smem + kBarBytes + s * p.xbytes;
      float acc[kRows][V];
#pragma unroll
      for (int o = 0; o < kRows; ++o)
#pragma unroll
        for (int v = 0; v < V; ++v) acc[o][v] = 0.0f;
      // Box rows r0 .. r0 + kRows + 1 (image rows h0 - 1 + ...) in ascending
      // order: every output row receives dy = 0, 1, 2 in turn, dx innermost.
#pragma unroll
      for (int rr = 0; rr < kRows + 2; ++rr) {
        if (r0 + rr >= p.th + 2) break;  // past the box: feeds no output row
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          float xv[V];
          unpack(*reinterpret_cast<const uint4*>(
                     tile + (((r0 + rr) * (p.tw + 2) + col + dx) * p.cb + cv * V) * sizeof(T)),
                 xv);
#pragma unroll
          for (int o = 0; o < kRows; ++o) {
            const int dy = rr - o;
            if (dy < 0 || dy > 2) continue;
#pragma unroll
            for (int v = 0; v < V; ++v)
              acc[o][v] = __fadd_rn(acc[o][v], __fmul_rn(xv[v], wt[dy * 3 + dx][v]));
          }
        }
      }
      int b, h0, w0;
      tile_origin(p, r.t0 + i, b, h0, w0);
      const int wo = w0 + col;
      if (cvalid && wo < p.W) {
#pragma unroll
        for (int o = 0; o < kRows; ++o) {
          const int h = h0 + r0 + o;
          if (r0 + o >= p.th || h >= p.H) break;
          *reinterpret_cast<uint4*>(y + (((long long)b * p.H + h) * p.W + wo) * p.C + c) =
              pack(acc[o]);
        }
      }
    }
    next_tile<T>(p, &xmap, nullptr, base, r, i);
  }
}

// ---- K2 ---------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kMaxThreads, 2)
dw3x3_wgrad_tma_kernel(const __grid_constant__ CUtensorMap xmap,
                       const __grid_constant__ CUtensorMap gmap, float* __restrict__ part,
                       const Plan p) {
  constexpr int V = Traits<T>::V;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t base = smem_u32(smem);
  const Range r = block_range(p);
  const int cvb = p.cb / V;
  const int cv = threadIdx.x % cvb, j = threadIdx.x / cvb;
  const int col = j % p.tw, r0 = (j / p.tw) * kRows;
  const bool active = r0 < p.th;

  start_ring<T>(p, &xmap, &gmap, base, r);

  float acc[9][V];  // this thread's sums over every tile of the block
#pragma unroll
  for (int k = 0; k < 9; ++k)
#pragma unroll
    for (int v = 0; v < V; ++v) acc[k][v] = 0.0f;

  const int n = r.t1 - r.t0;
  for (int i = 0; i < n; ++i) {
    const int s = i % p.stages;
    mbar_wait(base + 8 * s, (i / p.stages) & 1);
    if (active) {
      const unsigned char* xt = smem + kBarBytes + s * (p.xbytes + p.gbytes);
      const unsigned char* gt = xt + p.xbytes;
      float gv[kRows][V];  // g rows of the strip; rows past the tile are 0
      // x box row r0 + rr holds image row h0 - 1 + r0 + rr: it meets g row
      // o = rr - dy of the strip through tap row dy.
#pragma unroll
      for (int rr = 0; rr < kRows + 2; ++rr) {
        if (rr < kRows) {
          if (r0 + rr < p.th) {
            unpack(*reinterpret_cast<const uint4*>(
                       gt + (((r0 + rr) * p.tw + col) * p.cb + cv * V) * sizeof(T)),
                   gv[rr]);
          } else {
#pragma unroll
            for (int v = 0; v < V; ++v) gv[rr][v] = 0.0f;
          }
        }
        if (r0 + rr >= p.th + 2) break;
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          float xv[V];
          unpack(*reinterpret_cast<const uint4*>(
                     xt + (((r0 + rr) * (p.tw + 2) + col + dx) * p.cb + cv * V) * sizeof(T)),
                 xv);
#pragma unroll
          for (int dy = 0; dy < 3; ++dy) {
            const int o = rr - dy;
            if (o < 0 || o >= kRows) continue;
#pragma unroll
            for (int v = 0; v < V; ++v)
              acc[dy * 3 + dx][v] = __fmaf_rn(xv[v], gv[o][v], acc[dy * 3 + dx][v]);
          }
        }
      }
    }
    next_tile<T>(p, &xmap, &gmap, base, r, i);
  }

  // Sum the threads of each channel vector: row jj of red holds thread row
  // jj's 9 x CB sums; every thread then owns columns of red and adds their
  // rows in order. The stages are free: every load was waited for and every
  // thread has passed next_tile's barrier.
  float* red = reinterpret_cast<float*>(smem + kBarBytes);
  const int rows = p.tw * p.strips;
  const int width = 9 * p.cb;
  if (active) {
#pragma unroll
    for (int k = 0; k < 9; ++k)
#pragma unroll
      for (int q = 0; q < V / 4; ++q)
        *reinterpret_cast<float4*>(red + j * width + k * p.cb + cv * V + 4 * q) =
            make_float4(acc[k][4 * q], acc[k][4 * q + 1], acc[k][4 * q + 2],
                        acc[k][4 * q + 3]);
  }
  __syncthreads();
  for (int m = threadIdx.x; m < width; m += blockDim.x) {
    float sum = 0.0f;
    for (int jj = 0; jj < rows; ++jj) sum += red[jj * width + m];
    const int k = m / p.cb, ch = r.cb * p.cb + m % p.cb;
    if (ch < p.C) part[((long long)r.part * 9 + k) * p.C + ch] = sum;
  }
}

// dw[j] = sum over the P partials of j, in a fixed order: 32 row groups sum
// partials q = g, g + 32, ... in order, then one thread adds the 32 group
// sums in order.
__global__ void __launch_bounds__(kReduceGroups * 32)
dw3x3_wgrad_tma_reduce_kernel(const float* __restrict__ part, float* __restrict__ dw,
                              int parts, int n) {
  const int col = threadIdx.x % 32;
  const int g = threadIdx.x / 32;
  const int j = blockIdx.x * 32 + col;
  float s = 0.0f;
  if (j < n)
    for (int q = g; q < parts; q += kReduceGroups) s += part[(long long)q * n + j];
  __shared__ float red[kReduceGroups][33];
  red[g][col] = s;
  __syncthreads();
  if (g == 0 && j < n) {
    float tot = 0.0f;
    for (int i = 0; i < kReduceGroups; ++i) tot += red[i][col];
    dw[j] = tot;
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

// A 4-D map over a contiguous NHWC [B, H, W, C] tensor, boxes of {cb, bw, bh,
// 1}, no swizzle, zeros outside the bounds.
template <typename T>
int encode(CUtensorMap* map, const void* ptr, int B, int H, int W, int C, int cb, int bw,
           int bh) {
  const EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return kEncodeError + (int)CUDA_ERROR_NOT_FOUND;
  const cuuint64_t e = sizeof(T);
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {C * e, (cuuint64_t)W * C * e, (cuuint64_t)H * W * C * e};
  const cuuint32_t box[4] = {(cuuint32_t)cb, (cuuint32_t)bw, (cuuint32_t)bh, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, Traits<T>::kType, 4, const_cast<void*>(ptr), dims, strides,
                        box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeError + (int)r;
}

int round128(long long n) { return (int)((n + 127) / 128 * 128); }

// The geometry of a plan (th, tw, cb, stages, parts from `dw_tile_plan`),
// or false where the TMA or this kernel cannot take it. The same rules as
// the Python plan; smem is the dynamic shared memory of the launch.
template <typename T>
bool make_plan(Plan& p, int& threads, int& smem, int B, int H, int W, int C, int th, int tw,
               int cb, int stages, int parts, bool wgrad) {
  constexpr int V = Traits<T>::V;
  if (B < 1 || H < 1 || W < 1 || C < 1 || C % V || cb < V || cb % V || cb > 256 ||
      th < 1 || th > 254 || tw < 1 || tw > 254 || stages < 2 || stages > kMaxStages ||
      parts < 1 || (long long)B * H * W * C >= (1LL << 31))
    return false;
  p.H = H, p.W = W, p.C = C, p.th = th, p.tw = tw, p.cb = cb;
  p.stages = stages;
  p.nth = (H + th - 1) / th;
  p.ntw = (W + tw - 1) / tw;
  p.tiles = B * p.nth * p.ntw;
  p.parts = parts < p.tiles ? parts : p.tiles;
  p.strips = (th + kRows - 1) / kRows;
  p.xbytes = round128((long long)(th + 2) * (tw + 2) * cb * sizeof(T));
  p.gbytes = wgrad ? round128((long long)th * tw * cb * sizeof(T)) : 0;
  const int items = (cb / V) * tw * p.strips;
  threads = (items + 31) / 32 * 32;
  long long body = (long long)stages * (p.xbytes + p.gbytes);
  const long long red = wgrad ? (long long)tw * p.strips * 9 * cb * 4 : 0;
  if (red > body) body = red;
  smem = kBarBytes + (int)body;
  return items <= kMaxThreads && smem <= 232448;
}

int grid_of(const Plan& p) { return ((p.C + p.cb - 1) / p.cb) * p.parts; }

template <typename T>
int launch_fwd(const void* x, const void* w, void* y, int B, int H, int W, int C, int th,
               int tw, int cb, int stages, int parts, int flip, cudaStream_t stream) {
  Plan p;
  int threads, smem;
  if (!make_plan<T>(p, threads, smem, B, H, W, C, th, tw, cb, stages, parts, false))
    return (int)cudaErrorInvalidValue;
  // A runtime call first: it makes the device's primary context current on
  // this thread (an autograd worker may not have one yet), which encoding a
  // tensor map through the driver needs.
  auto kernel = dw3x3_fwd_tma_kernel<T>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap xm;
  if (int e = encode<T>(&xm, x, B, H, W, C, cb, tw + 2, th + 2)) return e;
  kernel<<<grid_of(p), threads, smem, stream>>>(xm, static_cast<const T*>(w),
                                                static_cast<T*>(y), p, flip);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_wgrad(const void* x, const void* g, float* part, float* dw, int B, int H, int W,
                 int C, int th, int tw, int cb, int stages, int parts, cudaStream_t stream) {
  Plan p;
  int threads, smem;
  if (!make_plan<T>(p, threads, smem, B, H, W, C, th, tw, cb, stages, parts, true))
    return (int)cudaErrorInvalidValue;
  auto kernel = dw3x3_wgrad_tma_kernel<T>;  // runtime call first, as in K1
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap xm, gm;
  if (int e = encode<T>(&xm, x, B, H, W, C, cb, tw + 2, th + 2)) return e;
  if (int e = encode<T>(&gm, g, B, H, W, C, cb, tw, th)) return e;
  kernel<<<grid_of(p), threads, smem, stream>>>(xm, gm, part, p);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int n = 9 * C;
  dw3x3_wgrad_tma_reduce_kernel<<<(n + 31) / 32, kReduceGroups * 32, 0, stream>>>(
      part, dw, p.parts, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K1, the "tma" variant: y = depthwise 3x3 of x with taps w (w[2-dy][2-dx]
// when flip is non-zero). x and y [B, H, W, C], w [3, 3, C], contiguous,
// 16-byte aligned, of one dtype (0 = float32, 1 = bfloat16), C * bytes a
// multiple of 16. th, tw, cb, stages and parts are `dw_tile_plan`'s.
// Returns a cudaError_t code, or 1000 + the CUresult of a failed encode.
int ddw_dw3x3_fwd_tma(const void* x, const void* w, void* y, int B, int H, int W, int C,
                      int dtype, int th, int tw, int cb, int stages, int parts, int flip,
                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_fwd<float>(x, w, y, B, H, W, C, th, tw, cb, stages, parts, flip, s);
  if (dtype == 1)
    return launch_fwd<__nv_bfloat16>(x, w, y, B, H, W, C, th, tw, cb, stages, parts, flip,
                                     s);
  return (int)cudaErrorInvalidValue;
}

// K2, the "tma" variant: dw (f32 [3, 3, C]) from x and g ([B, H, W, C], as
// for K1). part is the caller's f32 workspace of parts * 9 * C floats (parts
// as the plan gives it, at most its spatial tiles).
int ddw_dw3x3_wgrad_tma(const void* x, const void* g, void* part, void* dw, int B, int H,
                        int W, int C, int dtype, int th, int tw, int cb, int stages,
                        int parts, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pp = static_cast<float*>(part);
  float* d = static_cast<float*>(dw);
  if (dtype == 0)
    return launch_wgrad<float>(x, g, pp, d, B, H, W, C, th, tw, cb, stages, parts, s);
  if (dtype == 1)
    return launch_wgrad<__nv_bfloat16>(x, g, pp, d, B, H, W, C, th, tw, cb, stages, parts,
                                       s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
