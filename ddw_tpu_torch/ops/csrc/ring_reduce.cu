// Ring all-reduce (sum) over the ranks of a process group — K6 for Hopper.
//
// Replaces ddw_tpu/ops/ring_reduce.py `_kernel` (the Pallas TPU kernel that
// `ring_all_reduce_pallas` launches). It computes what that kernel computes,
// with the same additions in the same order: each array is framed as (n,
// chunk) rows, chunk = ceil(size / n) rounded up to 128, and
//   reduce-scatter hop k (k = 0 .. n-2): send row (me-k) mod n to the right
//     neighbour's slot k; out[(me-k-1) mod n] = local + arriving;
//   all-gather hop k: send row (me+1-k) mod n to the right neighbour's slot
//     k; out[(me-k) mod n] = arriving.
// Each f32 sum is rounded on its own (__fadd_rn, no FMA contraction), so the
// result equals the plain PyTorch version and ddw_tpu's kernel bit for bit.
// Integer adds wrap modulo 2^bits, as torch's and the TPU kernel's do (int32,
// int16, int8; uint32 and uint8 ring as int32 and int8, whose wrapping adds
// give the same bits), and bool adds as logical or, as jnp's add of bools.
//
// Ranks are processes. Each allocates one buffer (ddw_ring_alloc): flag words
// and two sets of 2(n-1) slots, exported with cudaIpcGetMemHandle; each
// opens its left and right neighbours' buffers (ddw_ring_open). That works
// between processes that share one card (there NCCL refuses two ranks on a
// device) and, across cards, maps the peers over NVLink.
//
// What bounds it: bytes. It adds one value per value received and does no
// other arithmetic. With all N ranks on one card the least time is every
// rank's input read once and output written once, 2*N*bytes / 3.35 TB/s;
// across four cards each rank sends 2(N-1)/N * bytes over NVLink at 450 GB/s
// each way. That bound assumes the ranks run at once. Without MPS a card
// time-slices the processes that share it: a kernel that waits for a
// neighbour holds the card until its slice ends, so every point at which one
// rank waits for another costs about a time slice, far above the bytes.
//
// Design (pack_ring_kernel, the one the port runs):
// - One launch carries a whole tree of arrays of one dtype. The pack of a hop
//   lays each array's row side by side, array i at column off_i of the pack
//   (a multiple of 128), chunk_i columns wide. Arrays are packed, never
//   re-framed: array i keeps its own (n, chunk_i) rows, so each value is
//   summed by the same ranks in the same order as in a launch of its own.
//   The host's pack plan (ops/ring_reduce.py ring_pack_plan) cuts the pack
//   into launches of at most a slot's columns and kMaxLeaves arrays; the
//   lm_flash LM's 102-leaf gradient tree is one launch at 2 and at 4 ranks.
//   So a call waits 2(n-1) times, once per hop, not 2n-1 times per array.
// - The arrays are read and written in place: values past size_i read as
//   zero (as the TPU's zero padding) and are never stored.
// - Up to one block per SM (kMaxBlocks, an H100's 132): block b owns a
//   contiguous range of the pack's columns, a multiple of 128, in every row
//   of every array it meets, and runs an independent ring over them with its
//   own flags, so no block ever waits on another block of its launch. The
//   arrays' descriptors are the launch's __grid_constant__ parameters; a
//   block walks them in order, the same for all its threads.
// - 16-byte loads and stores (4 four-byte, 8 two-byte or 16 one-byte values),
//   kUnroll of them in flight per thread: every row and range is a multiple
//   of 128 values, so at least 128 bytes, and the wrapper gives 16-byte-
//   aligned arrays; a row's last partial vector is masked value by value.
//   Two-byte values add in pairs (__vadd2), one-byte values in fours
//   (__vadd4), bools by a bitwise or of the 0/1 bytes.
// - Slots count bytes, not values: one comm serves every ring dtype, and a
//   slot of B bytes carries B / sizeof(value) pack columns.
// - A hop: every thread stores its values into the right neighbour's slot
//   and runs __threadfence_system(); after __syncthreads() thread 0 stores
//   seq (a call number all ranks of the group advance together) into the
//   neighbour's flag [hop][block] with release semantics at system scope
//   (st.release.sys). The receiver's thread 0 spins with ld.acquire.sys and
//   __nanosleep until the flag reaches seq, then __syncthreads(); slot
//   values are read through L2 (__ldcg). Flags are never reset and only
//   grow: a flag at or past seq means the sender has done that hop of call
//   seq (a later call of the same block comes after it in stream order).
// - Every hop of a call has its own slot (the TPU's rs_buf / ag_buf), and
//   call seq uses slot set seq % 2, so no entry barrier is needed. Why no
//   slot is overwritten while its reader still needs it: the value rank r
//   receives at its last all-gather hop of call s is row r+2, which rank r+1
//   finished at the end of its reduce-scatter and sent on at all-gather hop
//   0, through r+2, ..., r-1 (each forward comes after the receive it
//   forwards; for n = 2 directly). So when block b of r ends call s, block b
//   of r+1 has read every reduce-scatter slot of call s, and its launch of
//   call s-1 has ended (stream order). r writes into r+1 only (its right
//   neighbour), and call s+1 writes set (s+1) % 2, last read by r+1 in call
//   s-1: done. Induction keeps r at most one call ahead of r+1's
//   reduce-scatter, whatever the grid of each call: the knowledge passes
//   from r's launch of call s to every block of its next launch by stream
//   order. A flag of the next call may land while its reader still waits
//   for this call's (it waits for "at least seq"), and the data it guards
//   for this call is in the other set, written before.
// - Every wait is bounded by %globaltimer: past the bound the kernel traps,
//   so a peer that never arrives fails the rank with a CUDA error instead of
//   hanging it.
//
// leaf_ring_kernel is the earlier design (one launch per array and column
// segment, at most 32 blocks, scalar loads and stores, an entry barrier with
// both neighbours), kept only so that the two can be timed side by side. It
// uses the same slot sets and flags, so the two may follow each other.
//
// Plain C interface, built by ops/_build.py with nvcc and loaded with ctypes.
// The launch functions return cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>
#include <string.h>

namespace {

constexpr int kMaxBlocks = 132;      // pack_ring_kernel's grid at most
constexpr int kLeafMaxBlocks = 32;   // leaf_ring_kernel's grid at most
constexpr int kMaxLeaves = 256;      // arrays in one pack_ring_kernel launch
constexpr int kPackThreads = 512;
constexpr int kLeafThreads = 256;
constexpr int kLane = 128;           // row and pack alignment, in values
constexpr int kUnroll = 4;           // vectors in flight per thread

// Flag words of one rank's buffer: entry from the left neighbour [block],
// entry from the right [block] (leaf_ring_kernel's), reduce-scatter
// [hop][block], all-gather [hop][block]. Two sets of 2(n-1) slots of
// slot_bytes each follow, 256-byte aligned.
__host__ __device__ inline long long flag_words(int n) {
  return (2LL + 2LL * (n - 1)) * kMaxBlocks;
}
__host__ __device__ inline long long data_offset(int n) {
  return (flag_words(n) * 4 + 255) / 256 * 256;
}

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ void store_release_sys(unsigned* p, unsigned v) {
  asm volatile("st.release.sys.global.u32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ unsigned load_acquire_sys(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.sys.global.u32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}

// The byte offset of call seq's first slot in a buffer's data: set seq % 2.
__device__ __forceinline__ long long slot_set(unsigned seq, int n,
                                              long long slot_bytes) {
  return (seq & 1u) * 2LL * (n - 1) * slot_bytes;
}

// Thread 0 only: spin until *flag reaches seq (flags only grow; the
// difference is taken modulo 2^32), or trap past the deadline.
__device__ void wait_flag(const unsigned* flag, unsigned seq,
                          unsigned long long deadline, int hop) {
  unsigned sleep = 32;
  while ((int)(load_acquire_sys(flag) - seq) < 0) {
    if (now_ns() > deadline) {
      printf("ring_reduce: block %d waited past its bound at hop %d "
             "(call %u); a peer did not arrive\n", blockIdx.x, hop, seq);
      __trap();
    }
    __nanosleep(sleep);
    if (sleep < 1024) sleep *= 2;
  }
}

// The ring dtypes: T the value as stored, N values in a 16-byte vector,
// add1 one value's sum, add a vector's (lane by lane, in the same bits).
struct F32Op {
  using T = float;
  static constexpr int N = 4;
  static __device__ __forceinline__ T add1(T a, T b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ unsigned add_word(unsigned a, unsigned b) {
    return __float_as_uint(__fadd_rn(__uint_as_float(a), __uint_as_float(b)));
  }
};
struct I32Op {
  using T = int;
  static constexpr int N = 4;
  static __device__ __forceinline__ T add1(T a, T b) {
    return (int)((unsigned)a + (unsigned)b);
  }
  static __device__ __forceinline__ unsigned add_word(unsigned a, unsigned b) {
    return a + b;
  }
};
struct I16Op {
  using T = short;
  static constexpr int N = 8;
  static __device__ __forceinline__ T add1(T a, T b) {
    return (short)(unsigned short)((unsigned)a + (unsigned)b);
  }
  static __device__ __forceinline__ unsigned add_word(unsigned a, unsigned b) {
    return __vadd2(a, b);
  }
};
struct I8Op {
  using T = signed char;
  static constexpr int N = 16;
  static __device__ __forceinline__ T add1(T a, T b) {
    return (signed char)(unsigned char)((unsigned)a + (unsigned)b);
  }
  static __device__ __forceinline__ unsigned add_word(unsigned a, unsigned b) {
    return __vadd4(a, b);
  }
};
struct BoolOp {
  using T = unsigned char;  // torch's bool: one byte, 0 or 1
  static constexpr int N = 16;
  static __device__ __forceinline__ T add1(T a, T b) { return a | b; }
  static __device__ __forceinline__ unsigned add_word(unsigned a, unsigned b) {
    return a | b;
  }
};

// The flags of one block: thread 0 tells both neighbours this block entered
// call seq and waits until both have (the TPU kernel's barrier semaphore).
__device__ __forceinline__ void entry_barrier(unsigned* own_flags,
                                              unsigned* left_flags,
                                              unsigned* right_flags,
                                              unsigned seq,
                                              unsigned long long deadline) {
  const int b = blockIdx.x;
  if (threadIdx.x == 0) {
    store_release_sys(right_flags + b, seq);               // I am its left
    store_release_sys(left_flags + kMaxBlocks + b, seq);   // I am its right
    wait_flag(own_flags + b, seq, deadline, -1);
    wait_flag(own_flags + kMaxBlocks + b, seq, deadline, -1);
  }
  __syncthreads();
}

// After this thread's stores into the neighbour's slot: make them visible,
// then thread 0 raises the neighbour's flag for (hop, block) and waits for
// its own.
__device__ __forceinline__ void hop_sync(unsigned* right_flags,
                                         const unsigned* own_flags, int hop,
                                         unsigned seq,
                                         unsigned long long deadline) {
  const int f = (2 + hop) * kMaxBlocks + blockIdx.x;
  __threadfence_system();
  __syncthreads();
  if (threadIdx.x == 0) {
    store_release_sys(right_flags + f, seq);
    wait_flag(own_flags + f, seq, deadline, hop);
  }
  __syncthreads();
}

// ---- pack_ring_kernel: a tree of arrays in one launch ----

struct Leaf {
  const void* x;  // this rank's `size` values, 16-byte aligned
  void* out;      // the sum, `size` values, 16-byte aligned
  long long size, chunk, off;  // values; row length; first pack column
};

struct PackArgs {
  char* own;    // this rank's buffer
  char* right;  // the right neighbour's buffer (mapped)
  long long p0, len, per;  // pack columns [p0, p0+len), per block
  long long slot_bytes;
  int n, me, nleaves;
  unsigned seq;
  unsigned long long timeout_ns;
  Leaf leaf[kMaxLeaves];  // in pack order, covering [p0, p0+len)
};

// N values of an array from flat index i (a multiple of N); those at or
// past `size` read as zero.
template <typename Op>
__device__ __forceinline__ uint4 loadv(const typename Op::T* p, long long i,
                                       long long size) {
  using T = typename Op::T;
  if (i + Op::N <= size) return *reinterpret_cast<const uint4*>(p + i);
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  T* e = reinterpret_cast<T*>(&v);
#pragma unroll
  for (int t = 0; t < Op::N; ++t)
    if (i + t < size) e[t] = p[i + t];
  return v;
}

// Store N values at flat index i, none at or past `size`.
template <typename Op>
__device__ __forceinline__ void storev(typename Op::T* p, long long i,
                                       long long size, uint4 v) {
  using T = typename Op::T;
  if (i + Op::N <= size) {
    *reinterpret_cast<uint4*>(p + i) = v;
    return;
  }
  const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
  for (int t = 0; t < Op::N; ++t)
    if (i + t < size) p[i + t] = e[t];
}

template <typename Op>
__device__ __forceinline__ uint4 addv(uint4 a, uint4 b) {
  a.x = Op::add_word(a.x, b.x);
  a.y = Op::add_word(a.y, b.y);
  a.z = Op::add_word(a.z, b.z);
  a.w = Op::add_word(a.w, b.w);
  return a;
}

// One pass of a hop over this block's pack columns [c0, c1): for every
// N-th column j of each array's row that falls there (s its column in the
// slot), v = load(leaf, j, s), then store(leaf, j, s, v), kUnroll vectors in
// flight per thread. Arrays from `first`, in pack order; the mapping of
// columns to threads is the same at every hop.
template <typename Op, typename Load, typename Store>
__device__ __forceinline__ void hop_pass(const PackArgs& a, int first,
                                         long long c0, long long c1,
                                         Load load, Store store) {
  const long long step = (long long)Op::N * blockDim.x;
  for (int l = first; l < a.nleaves && a.leaf[l].off < c1; ++l) {
    const Leaf& L = a.leaf[l];
    const long long j0 = (c0 > L.off ? c0 : L.off) - L.off;
    const long long j1 =
        (c1 < L.off + L.chunk ? c1 : L.off + L.chunk) - L.off;
    for (long long j = j0 + (long long)Op::N * threadIdx.x; j < j1;
         j += kUnroll * step) {
      uint4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long ju = j + u * step;
        if (ju < j1) v[u] = load(L, ju, L.off + ju - a.p0);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long ju = j + u * step;
        if (ju < j1) store(L, ju, L.off + ju - a.p0, v[u]);
      }
    }
  }
}

template <typename Op>
__global__ void __launch_bounds__(kPackThreads)
    pack_ring_kernel(const __grid_constant__ PackArgs a) {
  using T = typename Op::T;
  const int n = a.n, me = a.me;
  const long long c0 = a.p0 + blockIdx.x * a.per;
  const long long c1 =
      c0 + a.per < a.p0 + a.len ? c0 + a.per : a.p0 + a.len;
  const unsigned long long deadline = now_ns() + a.timeout_ns;

  unsigned* own_flags = reinterpret_cast<unsigned*>(a.own);
  unsigned* right_flags = reinterpret_cast<unsigned*>(a.right);
  const long long set = data_offset(n) + slot_set(a.seq, n, a.slot_bytes);
  const uint4* own_slots = reinterpret_cast<const uint4*>(a.own + set);
  uint4* right_slots = reinterpret_cast<uint4*>(a.right + set);
  const long long slot_vecs = a.slot_bytes / 16;
  int first = 0;  // the first array with a column in [c0, c1)
  while (first < a.nleaves && a.leaf[first].off + a.leaf[first].chunk <= c0)
    ++first;
  auto to_slot = [](uint4* dst) {
    return [=](const Leaf&, long long, long long s, uint4 v) {
      dst[s / Op::N] = v;
    };
  };
  auto to_row = [](int c) {
    return [=](const Leaf& L, long long j, long long, uint4 v) {
      storev<Op>(static_cast<T*>(L.out), c * L.chunk + j, L.size, v);
    };
  };

  // Reduce-scatter: forward the running sum of row (me - k) of every array,
  // fold the arriving partial into row (me - k - 1). A row is received once
  // and sent on at the next hop by the same thread.
  for (int k = 0; k < n - 1; ++k) {
    const int c_send = (me - k + n) % n, c_recv = (me - k - 1 + n) % n;
    hop_pass<Op>(a, first, c0, c1,
                 [=](const Leaf& L, long long j, long long) {
                   return loadv<Op>(static_cast<const T*>(k == 0 ? L.x : L.out),
                                    c_send * L.chunk + j, L.size);
                 },
                 to_slot(right_slots + k * slot_vecs));
    hop_sync(right_flags, own_flags, k, a.seq, deadline);
    const uint4* slot = own_slots + k * slot_vecs;
    hop_pass<Op>(a, first, c0, c1,
                 [=](const Leaf& L, long long j, long long s) {
                   return addv<Op>(loadv<Op>(static_cast<const T*>(L.x),
                                             c_recv * L.chunk + j, L.size),
                                   __ldcg(slot + s / Op::N));
                 },
                 to_row(c_recv));
  }
  // Row (me + 1) mod n now holds the full sum. All-gather: hop k sends row
  // (me + 1 - k) and receives row (me - k) into place.
  for (int k = 0; k < n - 1; ++k) {
    const int c_send = (me + 1 - k + n) % n, c_recv = (me - k + n) % n;
    hop_pass<Op>(a, first, c0, c1,
                 [=](const Leaf& L, long long j, long long) {
                   return loadv<Op>(static_cast<const T*>(L.out),
                                    c_send * L.chunk + j, L.size);
                 },
                 to_slot(right_slots + (n - 1 + k) * slot_vecs));
    hop_sync(right_flags, own_flags, n - 1 + k, a.seq, deadline);
    const uint4* slot = own_slots + (n - 1 + k) * slot_vecs;
    hop_pass<Op>(a, first, c0, c1,
                 [=](const Leaf&, long long, long long s) {
                   return __ldcg(slot + s / Op::N);
                 },
                 to_row(c_recv));
  }
}

// ---- leaf_ring_kernel: the earlier design, one array segment a launch ----

struct LeafArgs {
  const void* x;   // (n, chunk) rows of this rank
  void* out;       // (n, chunk), every value of the segment written
  char* own;
  char* left;
  char* right;
  long long chunk, seg_start, seg_len, slot_bytes;
  int n, me;
  unsigned seq;
  unsigned long long timeout_ns;
};

template <typename Op>
__global__ void __launch_bounds__(kLeafThreads) leaf_ring_kernel(LeafArgs a) {
  using T = typename Op::T;
  const int b = blockIdx.x, n = a.n, me = a.me;
  const long long per = (a.seg_len + gridDim.x - 1) / gridDim.x;
  const long long c0 = b * per;
  const long long c1 = c0 + per < a.seg_len ? c0 + per : a.seg_len;
  const unsigned long long deadline = now_ns() + a.timeout_ns;

  unsigned* own_flags = reinterpret_cast<unsigned*>(a.own);
  unsigned* left_flags = reinterpret_cast<unsigned*>(a.left);
  unsigned* right_flags = reinterpret_cast<unsigned*>(a.right);
  const long long set = data_offset(n) + slot_set(a.seq, n, a.slot_bytes);
  const T* own_slots = reinterpret_cast<const T*>(a.own + set);
  T* right_slots = reinterpret_cast<T*>(a.right + set);
  const long long slot_vals = a.slot_bytes / (long long)sizeof(T);
  const T* x = static_cast<const T*>(a.x) + a.seg_start;
  T* out = static_cast<T*>(a.out) + a.seg_start;

  entry_barrier(own_flags, left_flags, right_flags, a.seq, deadline);
  for (int k = 0; k < n - 1; ++k) {
    const int c_send = (me - k + n) % n, c_recv = (me - k - 1 + n) % n;
    const T* src = (k == 0 ? x : out) + c_send * a.chunk;
    T* dst = right_slots + k * slot_vals;
    for (long long j = c0 + threadIdx.x; j < c1; j += blockDim.x)
      dst[j] = src[j];
    hop_sync(right_flags, own_flags, k, a.seq, deadline);
    const T* slot = own_slots + k * slot_vals;
    const T* loc = x + c_recv * a.chunk;
    T* o = out + c_recv * a.chunk;
    for (long long j = c0 + threadIdx.x; j < c1; j += blockDim.x)
      o[j] = Op::add1(loc[j], __ldcg(slot + j));
  }
  for (int k = 0; k < n - 1; ++k) {
    const int c_send = (me + 1 - k + n) % n, c_recv = (me - k + n) % n;
    const T* src = out + c_send * a.chunk;
    T* dst = right_slots + (n - 1 + k) * slot_vals;
    for (long long j = c0 + threadIdx.x; j < c1; j += blockDim.x)
      dst[j] = src[j];
    hop_sync(right_flags, own_flags, n - 1 + k, a.seq, deadline);
    const T* slot = own_slots + (n - 1 + k) * slot_vals;
    T* o = out + c_recv * a.chunk;
    for (long long j = c0 + threadIdx.x; j < c1; j += blockDim.x)
      o[j] = __ldcg(slot + j);
  }
}

// The kernel of a dtype code: 0 float32, 1 int32 (and uint32), 2 int8 (and
// uint8), 3 int16, 4 bool.
template <template <typename> class Kernel, typename Args>
int launch_by_code(int dtype, int blocks, int threads, const Args& a,
                   cudaStream_t s) {
  switch (dtype) {
    case 0: Kernel<F32Op>::launch(blocks, threads, a, s); break;
    case 1: Kernel<I32Op>::launch(blocks, threads, a, s); break;
    case 2: Kernel<I8Op>::launch(blocks, threads, a, s); break;
    case 3: Kernel<I16Op>::launch(blocks, threads, a, s); break;
    case 4: Kernel<BoolOp>::launch(blocks, threads, a, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename Op> struct PackKernel {
  static void launch(int blocks, int threads, const PackArgs& a, cudaStream_t s) {
    pack_ring_kernel<Op><<<blocks, threads, 0, s>>>(a);
  }
};
template <typename Op> struct LeafKernel {
  static void launch(int blocks, int threads, const LeafArgs& a, cudaStream_t s) {
    leaf_ring_kernel<Op><<<blocks, threads, 0, s>>>(a);
  }
};

int value_bytes(int dtype) {
  switch (dtype) {
    case 0: case 1: return 4;
    case 3: return 2;
    case 2: case 4: return 1;
    default: return 0;
  }
}

}  // namespace

extern "C" {

// Bytes of one rank's buffer for a group of n with slots of slot_bytes:
// the flags, then two sets of 2(n-1) slots.
long long ddw_ring_buffer_bytes(int n, long long slot_bytes) {
  return data_offset(n) + 4LL * (n - 1) * slot_bytes;
}

// cudaMalloc a zeroed buffer on the current device and export it. `handle`
// receives the 64-byte cudaIpcMemHandle_t.
int ddw_ring_alloc(long long bytes, void** ptr, void* handle) {
  cudaError_t err = cudaMalloc(ptr, (size_t)bytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemset(*ptr, 0, (size_t)bytes);
  if (err == cudaSuccess) err = cudaDeviceSynchronize();
  if (err == cudaSuccess) {
    cudaIpcMemHandle_t h;
    err = cudaIpcGetMemHandle(&h, *ptr);
    memcpy(handle, &h, sizeof(h));
  }
  return (int)err;
}

// Map a neighbour's buffer from its 64-byte handle.
int ddw_ring_open(const void* handle, void** ptr) {
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof(h));
  return (int)cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess);
}

int ddw_ring_close(void* ptr) { return (int)cudaIpcCloseMemHandle(ptr); }

int ddw_ring_free(void* ptr) { return (int)cudaFree(ptr); }

// One ring over pack columns [p0, p0 + len) of `nleaves` arrays. `table`
// holds five 64-bit words per array, in pack order: x, out, size, chunk,
// off. dtype: 0 float32, 1 int32 or uint32, 2 int8 or uint8, 3 int16,
// 4 bool. slot_bytes: a slot's bytes, a multiple of 512, holding len values.
int ddw_ring_pack_all_reduce(const long long* table, int nleaves, void* own,
                             void* right, long long p0,
                             long long len, long long slot_bytes, int n,
                             int me, unsigned seq, int dtype,
                             double timeout_s, void* stream) {
  const int vb = value_bytes(dtype);
  if (n < 2 || me < 0 || me >= n || nleaves < 1 || nleaves > kMaxLeaves ||
      vb == 0 || len < 1 || len * vb > slot_bytes || p0 % kLane ||
      len % kLane || slot_bytes % 512)
    return (int)cudaErrorInvalidValue;
  PackArgs a;  // 10 KB of kernel parameters (CUDA 12.1+ takes 32 KB)
  a.own = static_cast<char*>(own);
  a.right = static_cast<char*>(right);
  for (int l = 0; l < nleaves; ++l) {
    const long long* w = table + 5 * l;
    Leaf& L = a.leaf[l];
    L.x = reinterpret_cast<const void*>(w[0]);
    L.out = reinterpret_cast<void*>(w[1]);
    L.size = w[2];
    L.chunk = w[3];
    L.off = w[4];
    if ((w[0] | w[1]) % 16 || L.chunk % kLane || L.off % kLane ||
        L.size > n * L.chunk)
      return (int)cudaErrorInvalidValue;
  }
  const long long tiles = len / kLane;
  const long long per_block = (tiles + kMaxBlocks - 1) / kMaxBlocks;
  const int blocks = (int)((tiles + per_block - 1) / per_block);
  a.p0 = p0;
  a.len = len;
  a.per = per_block * kLane;
  a.slot_bytes = slot_bytes;
  a.n = n;
  a.me = me;
  a.nleaves = nleaves;
  a.seq = seq;
  a.timeout_ns = (unsigned long long)(timeout_s * 1e9);
  return launch_by_code<PackKernel>(dtype, blocks, kPackThreads, a,
                                    static_cast<cudaStream_t>(stream));
}

// The earlier design: one ring over columns [seg_start, seg_start + seg_len)
// of one array's (n, chunk) rows x -> out. dtype and slot_bytes as above.
int ddw_ring_leaf_all_reduce(const void* x, void* out, void* own, void* left,
                             void* right, long long chunk, long long seg_start,
                             long long seg_len, long long slot_bytes, int n,
                             int me, unsigned seq, int blocks, int dtype,
                             double timeout_s, void* stream) {
  const int vb = value_bytes(dtype);
  if (n < 2 || me < 0 || me >= n || blocks < 1 || blocks > kLeafMaxBlocks ||
      vb == 0 || seg_len < 1 || seg_len * vb > slot_bytes ||
      seg_start + seg_len > chunk)
    return (int)cudaErrorInvalidValue;
  LeafArgs a;
  a.x = x;
  a.out = out;
  a.own = static_cast<char*>(own);
  a.left = static_cast<char*>(left);
  a.right = static_cast<char*>(right);
  a.chunk = chunk;
  a.seg_start = seg_start;
  a.seg_len = seg_len;
  a.slot_bytes = slot_bytes;
  a.n = n;
  a.me = me;
  a.seq = seq;
  a.timeout_ns = (unsigned long long)(timeout_s * 1e9);
  return launch_by_code<LeafKernel>(dtype, blocks, kLeafThreads, a,
                                    static_cast<cudaStream_t>(stream));
}

}  // extern "C"
