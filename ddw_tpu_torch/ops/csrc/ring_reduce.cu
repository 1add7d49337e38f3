// Ring all-reduce (sum) over the ranks of a process group — K6 for Hopper.
//
// Replaces ddw_tpu/ops/ring_reduce.py `_kernel` (the Pallas TPU kernel that
// `ring_all_reduce_pallas` launches). It computes what that kernel computes,
// with the same additions in the same order: the array is framed by the
// wrapper as (n, chunk) rows, chunk a multiple of 128, and
//   reduce-scatter hop k (k = 0 .. n-2): send row (me-k) mod n to the right
//     neighbour's slot k; out[(me-k-1) mod n] = local + arriving;
//   all-gather hop k: send row (me+1-k) mod n to the right neighbour's slot
//     k; out[(me-k) mod n] = arriving.
// Each f32 sum is rounded on its own (__fadd_rn, no FMA contraction), so the
// result equals the plain PyTorch version and ddw_tpu's kernel bit for bit.
// int32 adds wrap modulo 2^32, as torch's do.
//
// Ranks are processes. Each allocates one buffer (ddw_ring_alloc): flag words
// and 2(n-1) slots of one segment's row, exported with cudaIpcGetMemHandle;
// each opens its left and right neighbours' buffers (ddw_ring_open). That
// works between processes that share one card (there NCCL refuses two ranks
// on a device) and, across cards, maps the peers over NVLink.
//
// What bounds it: bytes. It adds one value per value received and does no
// other arithmetic. With all N ranks on one card the least time is every
// rank's input read once and output written once, 2*N*bytes / 3.35 TB/s;
// across four cards each rank sends 2(N-1)/N * bytes over NVLink at 450 GB/s
// each way.
//
// Design, right first and simple:
// - One launch per rank per segment of columns, on PyTorch's current stream.
//   A small grid (at most 32 blocks of 256 threads): block b owns the columns
//   [b*w, (b+1)*w) of every row and runs an independent ring over them with
//   its own flags, so no block ever waits on another block of its launch.
// - Every hop has its own slot (the TPU's rs_buf / ag_buf), so no slot is
//   reused within a call. The entry barrier makes reuse across calls safe:
//   block b stores seq (a call number all ranks of the group advance
//   together) into its neighbours' entry flags for block b and waits for both
//   of its own. A neighbour signals call seq+1 only once its kernel for call
//   seq has finished (stream order), so nothing it still reads is
//   overwritten. Flags are never reset; they only take the current seq.
// - A hop: every thread stores its values into the neighbour's slot and runs
//   __threadfence_system(); after __syncthreads() thread 0 stores seq into
//   the neighbour's flag [hop][block] with release semantics at system scope
//   (st.release.sys). The receiver's thread 0 spins with ld.acquire.sys and
//   __nanosleep, then __syncthreads(); slot values are read through L2
//   (__ldcg).
// - Every wait is bounded by %globaltimer: past the bound the kernel traps,
//   so a peer that never arrives fails the rank with a CUDA error instead of
//   hanging it. Processes that share a card are time-sliced, not run
//   concurrently: a waiting kernel holds the card until its slice ends.
// - Scalar four-byte loads and stores. Vector loads, copy engines, overlapped
//   hops and NVLink multicast are later work.
//
// Plain C interface, built by ops/_build.py with nvcc and loaded with ctypes.
// The launch function returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>
#include <string.h>

namespace {

constexpr int kMaxBlocks = 32;
constexpr int kThreads = 256;

// Flag words of one rank's buffer: entry from the left neighbour [block],
// entry from the right [block], reduce-scatter [hop][block], all-gather
// [hop][block]. The slots follow, 256-byte aligned.
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

// Thread 0 only: spin until *flag == seq, or trap past the deadline.
__device__ void wait_flag(const unsigned* flag, unsigned seq,
                          unsigned long long deadline, int hop) {
  unsigned sleep = 32;
  while (load_acquire_sys(flag) != seq) {
    if (now_ns() > deadline) {
      printf("ring_reduce: block %d waited past its bound at hop %d "
             "(call %u); a peer did not arrive\n", blockIdx.x, hop, seq);
      __trap();
    }
    __nanosleep(sleep);
    if (sleep < 1024) sleep *= 2;
  }
}

__device__ __forceinline__ float ring_add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ int ring_add(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

struct RingArgs {
  const void* x;   // (n, chunk) rows of this rank
  void* out;       // (n, chunk), every value of the segment written
  char* own;       // this rank's buffer
  char* left;      // the left neighbour's buffer (mapped)
  char* right;     // the right neighbour's buffer (mapped)
  long long chunk, seg_start, seg_len, slot_elems;
  int n, me;
  unsigned seq;
  unsigned long long timeout_ns;
};

// After this thread's stores into the neighbour's slot: make them visible,
// then thread 0 raises the neighbour's flag and waits for its own.
__device__ __forceinline__ void hop_sync(unsigned* peer_flag,
                                         const unsigned* own_flag,
                                         unsigned seq,
                                         unsigned long long deadline,
                                         int hop) {
  __threadfence_system();
  __syncthreads();
  if (threadIdx.x == 0) {
    store_release_sys(peer_flag, seq);
    wait_flag(own_flag, seq, deadline, hop);
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kThreads) ring_kernel(RingArgs a) {
  const int b = blockIdx.x, n = a.n, me = a.me;
  const long long per = (a.seg_len + gridDim.x - 1) / gridDim.x;
  const long long c0 = b * per;
  const long long c1 = c0 + per < a.seg_len ? c0 + per : a.seg_len;
  const unsigned long long deadline = now_ns() + a.timeout_ns;

  unsigned* own_flags = reinterpret_cast<unsigned*>(a.own);
  unsigned* left_flags = reinterpret_cast<unsigned*>(a.left);
  unsigned* right_flags = reinterpret_cast<unsigned*>(a.right);
  const T* own_slots = reinterpret_cast<const T*>(a.own + data_offset(n));
  T* right_slots = reinterpret_cast<T*>(a.right + data_offset(n));
  const T* x = static_cast<const T*>(a.x) + a.seg_start;
  T* out = static_cast<T*>(a.out) + a.seg_start;

  // Entry barrier with both neighbours (the TPU kernel's barrier semaphore).
  if (threadIdx.x == 0) {
    store_release_sys(right_flags + b, a.seq);               // I am its left
    store_release_sys(left_flags + kMaxBlocks + b, a.seq);   // I am its right
    wait_flag(own_flags + b, a.seq, deadline, -1);
    wait_flag(own_flags + kMaxBlocks + b, a.seq, deadline, -1);
  }
  __syncthreads();

  // Reduce-scatter: forward the running sum of row (me - k), fold the
  // arriving partial into row (me - k - 1). A row is received once and sent
  // on at the next hop by the same threads, so out needs no barrier here.
  for (int k = 0; k < n - 1; ++k) {
    const int c_send = (me - k + n) % n, c_recv = (me - k - 1 + n) % n;
    const T* src = (k == 0 ? x : out) + c_send * a.chunk;
    T* dst = right_slots + k * a.slot_elems;
    for (long long j = c0 + threadIdx.x; j < c1; j += blockDim.x)
      dst[j] = src[j];
    const int f = (2 + k) * kMaxBlocks + b;
    hop_sync(right_flags + f, own_flags + f, a.seq, deadline, k);
    const T* slot = own_slots + k * a.slot_elems;
    const T* loc = x + c_recv * a.chunk;
    T* o = out + c_recv * a.chunk;
    for (long long j = c0 + threadIdx.x; j < c1; j += blockDim.x)
      o[j] = ring_add(loc[j], __ldcg(slot + j));
  }
  // Row (me + 1) mod n now holds the full sum. All-gather: hop k sends row
  // (me + 1 - k) and receives row (me - k) into place.
  for (int k = 0; k < n - 1; ++k) {
    const int c_send = (me + 1 - k + n) % n, c_recv = (me - k + n) % n;
    const T* src = out + c_send * a.chunk;
    T* dst = right_slots + (n - 1 + k) * a.slot_elems;
    for (long long j = c0 + threadIdx.x; j < c1; j += blockDim.x)
      dst[j] = src[j];
    const int f = (2 + n - 1 + k) * kMaxBlocks + b;
    hop_sync(right_flags + f, own_flags + f, a.seq, deadline, n - 1 + k);
    const T* slot = own_slots + (n - 1 + k) * a.slot_elems;
    T* o = out + c_recv * a.chunk;
    for (long long j = c0 + threadIdx.x; j < c1; j += blockDim.x)
      o[j] = __ldcg(slot + j);
  }
}

}  // namespace

extern "C" {

// Bytes of one rank's buffer for a group of n with slots of slot_elems
// four-byte values.
long long ddw_ring_buffer_bytes(int n, long long slot_elems) {
  return data_offset(n) + 2LL * (n - 1) * slot_elems * 4;
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

// One ring over columns [seg_start, seg_start + seg_len) of the (n, chunk)
// rows x -> out. dtype 0: float32, 1: int32.
int ddw_ring_all_reduce(const void* x, void* out, void* own, void* left,
                        void* right, long long chunk, long long seg_start,
                        long long seg_len, long long slot_elems, int n, int me,
                        unsigned seq, int blocks, int dtype, double timeout_s,
                        void* stream) {
  if (n < 2 || me < 0 || me >= n || blocks < 1 || blocks > kMaxBlocks ||
      seg_len < 1 || seg_len > slot_elems || seg_start + seg_len > chunk)
    return (int)cudaErrorInvalidValue;
  RingArgs a;
  a.x = x;
  a.out = out;
  a.own = static_cast<char*>(own);
  a.left = static_cast<char*>(left);
  a.right = static_cast<char*>(right);
  a.chunk = chunk;
  a.seg_start = seg_start;
  a.seg_len = seg_len;
  a.slot_elems = slot_elems;
  a.n = n;
  a.me = me;
  a.seq = seq;
  a.timeout_ns = (unsigned long long)(timeout_s * 1e9);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    ring_kernel<float><<<blocks, kThreads, 0, s>>>(a);
  else if (dtype == 1)
    ring_kernel<int><<<blocks, kThreads, 0, s>>>(a);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"
