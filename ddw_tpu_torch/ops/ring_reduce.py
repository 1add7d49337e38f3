"""Ring all-reduce over ranks — the port of ``ddw_tpu.ops.ring_reduce``.

The algorithm is ``ddw_tpu``'s (the Baidu ring Horovod ships): the array is
flattened and zero-padded into ``(n, chunk)`` rows with ``chunk`` a multiple
of 128 (:func:`ring_chunks`); ``n - 1`` reduce-scatter hops each send one
row to the right-hand neighbour, which adds it to its own copy of that row
(``local + arriving``); after them rank ``r`` holds the full sum of row
``(r + 1) % n``, and ``n - 1`` all-gather hops circulate the finished rows.
The framing decides which rank starts each element's sum, so it decides the
order of the additions: every implementation here keeps it, and gives the
bits of ``ddw_tpu``'s ``ring_all_reduce_pallas``.

- :func:`ring_all_reduce_cuda` launches K6 of ``csrc/ring_reduce.cu``, which
  replaces the Pallas kernel ``ddw_tpu/ops/ring_reduce.py`` ``_kernel``. The
  ranks are processes, one per rank, on one card or several; each maps its
  neighbours' receive buffers through CUDA IPC (:class:`RingComm`) and the
  kernel moves the rows and signals with flags in that memory. It uses no
  NCCL, so ranks may share a card.
- :func:`ring_all_reduce_plain`, the plain version: the same rows, hops and
  additions over ``torch.distributed`` point-to-point (gloo on the CPU).

:func:`ring_all_reduce_pallas` is the entry ``ddw_tpu`` has: bf16 and f16 go
through an f32 ring, a CUDA tensor launches K6, a CPU tensor runs the plain
version. A row longer than a comm slot (``SLOT_BYTES``) runs as several
segments of columns, one launch each, as the TPU kernel runs segments under
its VMEM budget; segments do not change the order of any sum.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.distributed as dist

_LANE = 128        # rows are padded to this multiple, as on the TPU
SLOT_BYTES = 16 << 20   # one comm slot of a RingComm: 4 Mi four-byte values
_RING_DTYPES = {torch.float32: 0, torch.int32: 1}  # dtype -> kernel code
_BLOCKS = 32       # K6 grid at most (kMaxBlocks): a block per 1,024 values
_WIDE = (torch.bfloat16, torch.float16)  # cast to f32 around the ring


def ring_chunk_len(size: int, n: int, lane: int = 1) -> int:
    """Row length of ``size`` values framed into ``n`` rows: the ceiling of
    ``size / n`` rounded up to a multiple of ``lane``."""
    chunk = -(-size // n)
    return -(-chunk // lane) * lane


def ring_chunks(x: torch.Tensor, n: int, lane: int = 1) -> torch.Tensor:
    """Ring framing shared by the ppermute and kernel rings: flatten and
    zero-pad ``x`` into ``(n, chunk)`` with ``chunk`` a multiple of
    ``lane``. Returns a new contiguous tensor."""
    flat = x.reshape(-1)
    chunk = ring_chunk_len(flat.numel(), n, lane)
    out = flat.new_zeros(n * chunk)
    out[:flat.numel()] = flat
    return out.view(n, chunk)


def ring_unchunk(out: torch.Tensor, orig_shape: tuple[int, ...],
                 size: int) -> torch.Tensor:
    """Inverse of :func:`ring_chunks`: drop padding, restore the shape."""
    return out.reshape(-1)[:size].reshape(orig_shape)


def ring_segments(chunk: int, slot_elems: int) -> list[tuple[int, int]]:
    """``(start, length)`` column segments of a row of ``chunk`` values,
    each at most ``slot_elems`` long: one ring (one kernel launch) each."""
    return [(s, min(slot_elems, chunk - s))
            for s in range(0, chunk, slot_elems)]


def slot_elems_of(slot_bytes: int) -> int:
    """Four-byte values in a slot of ``slot_bytes``, a multiple of 128."""
    return max(_LANE, slot_bytes // 4 // _LANE * _LANE)


def _group(group):
    return dist.group.WORLD if group is None else group


def group_size_rank(group=None) -> tuple[int, int]:
    """``(size, rank in the group)``; ``(1, 0)`` when no process group is
    initialized (a world of one)."""
    if not (dist.is_available() and dist.is_initialized()):
        return 1, 0
    g = _group(group)
    return dist.get_world_size(g), dist.get_rank(g)


def ring_shift(t: torch.Tensor, group=None) -> torch.Tensor:
    """One ring hop over ``torch.distributed`` point-to-point: send ``t`` to
    the right-hand neighbour (group rank ``+1``) and return what arrives
    from the left (``-1``) — ``lax.ppermute`` with ``i -> i+1``."""
    g = _group(group)
    n, me = group_size_rank(g)
    right = dist.get_global_rank(g, (me + 1) % n)
    left = dist.get_global_rank(g, (me - 1) % n)
    recv = torch.empty_like(t)
    reqs = [dist.isend(t.contiguous(), right, group=g),
            dist.irecv(recv, left, group=g)]
    for r in reqs:
        r.wait()
    return recv


def _check_ring_dtype(dtype: torch.dtype) -> None:
    if dtype not in _RING_DTYPES:
        raise TypeError(f"the ring all-reduce takes float32 and int32 (bf16 "
                        f"and f16 ring in float32), got {dtype}; other dtypes "
                        f"are not ported yet (ROADMAP.md)")


def ring_all_reduce_plain(x: torch.Tensor, group=None,
                          slot_bytes: int | None = None) -> torch.Tensor:
    """Plain PyTorch version of K6: the kernel's rows, segments, hop schedule
    and additions (``out[c_recv] = local + arriving``) over point-to-point
    sends to the right and receives from the left. ``x`` is float32 or
    int32; every rank of ``group`` passes the same shape."""
    _check_ring_dtype(x.dtype)
    n, me = group_size_rank(group)
    if n == 1:
        return x
    x2d = ring_chunks(x, n, lane=_LANE)
    out = torch.empty_like(x2d)
    slot = slot_elems_of(SLOT_BYTES if slot_bytes is None else slot_bytes)
    for start, seg in ring_segments(x2d.shape[1], slot):
        cols = slice(start, start + seg)
        for k in range(n - 1):
            c_send, c_recv = (me - k) % n, (me - k - 1) % n
            src = x2d if k == 0 else out
            arriving = ring_shift(src[c_send, cols], group)
            out[c_recv, cols] = x2d[c_recv, cols] + arriving
        for k in range(n - 1):
            c_send, c_recv = (me + 1 - k) % n, (me - k) % n
            out[c_recv, cols] = ring_shift(out[c_send, cols], group)
    return ring_unchunk(out, tuple(x.shape), x.numel())


@functools.cache
def _kernel_lib() -> ctypes.CDLL:
    from ddw_tpu_torch.ops import _build

    lib = _build.load("ring_reduce.cu")
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.ddw_ring_buffer_bytes.argtypes = [i, ll]
    lib.ddw_ring_buffer_bytes.restype = ll
    lib.ddw_ring_alloc.argtypes = [ll, ctypes.POINTER(p), p]
    lib.ddw_ring_open.argtypes = [p, ctypes.POINTER(p)]
    lib.ddw_ring_close.argtypes = [p]
    lib.ddw_ring_free.argtypes = [p]
    lib.ddw_ring_all_reduce.argtypes = [p, p, p, p, p, ll, ll, ll, ll, i, i,
                                        ctypes.c_uint, i, i, ctypes.c_double,
                                        p]
    for fn in (lib.ddw_ring_alloc, lib.ddw_ring_open, lib.ddw_ring_close,
               lib.ddw_ring_free, lib.ddw_ring_all_reduce):
        fn.restype = i
    return lib


def _cuda_check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"ring all-reduce: {what} failed: CUDA error {err}")


class RingComm:
    """The peer mapping of one process group on one CUDA device: K6's
    communicator state, which lives across calls.

    Each rank allocates one buffer with ``cudaMalloc`` (never from PyTorch's
    caching allocator: an IPC handle names a whole allocation): flag words
    ``[hop][block]`` and two entry flags per block, then ``n - 1``
    reduce-scatter and ``n - 1`` all-gather slots of ``slot_bytes`` each.
    The 64-byte IPC handles are exchanged with ``all_gather_object`` over
    the group (the only use of the group besides barriers, so a gloo group
    serves ranks that share a card, where NCCL refuses), and each rank opens
    its left and right neighbours' (by group rank). ``seq`` numbers the
    launches; all ranks of the group advance it together, and the flags only
    ever take its current value. ``timeout_s`` bounds every wait inside the
    kernel: past it the kernel traps, so a peer that never arrives fails the
    rank with a CUDA error instead of hanging it.

    :meth:`close` tears down in the order that lets every rank exit
    cleanly: synchronize, barrier, unmap the peers, barrier, free."""

    def __init__(self, group=None, device=None, slot_bytes: int | None = None,
                 timeout_s: float = 30.0):
        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError("RingComm needs an initialized process group")
        self.group = _group(group)
        self.n, self.me = group_size_rank(self.group)
        self.device = torch.device("cuda", torch.cuda.current_device()) \
            if device is None else torch.device(device)
        if self.device.type != "cuda":
            raise ValueError(f"RingComm maps CUDA memory, got {self.device}")
        if self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.slot_elems = slot_elems_of(
            SLOT_BYTES if slot_bytes is None else slot_bytes)
        self.timeout_s, self.seq = timeout_s, 0
        self.own = self.left = self.right = None
        lib = _kernel_lib()
        handle = ctypes.create_string_buffer(64)
        own = ctypes.c_void_p()
        with torch.cuda.device(self.device):
            nbytes = lib.ddw_ring_buffer_bytes(self.n, self.slot_elems)
            _cuda_check(lib.ddw_ring_alloc(nbytes, ctypes.byref(own), handle),
                        "cudaMalloc / cudaIpcGetMemHandle")
            self.own = own.value
            handles: list = [None] * self.n
            dist.all_gather_object(handles, handle.raw, group=self.group)
            opened: dict[int, int] = {}  # n = 2: left and right are one peer
            for peer in sorted({(self.me - 1) % self.n,
                                (self.me + 1) % self.n}):
                ptr = ctypes.c_void_p()
                _cuda_check(lib.ddw_ring_open(handles[peer],
                                              ctypes.byref(ptr)),
                            f"cudaIpcOpenMemHandle of group rank {peer}")
                opened[peer] = ptr.value
        self._opened = opened
        self.left = opened[(self.me - 1) % self.n]
        self.right = opened[(self.me + 1) % self.n]

    def launch(self, x2d: torch.Tensor, out: torch.Tensor, start: int,
               seg: int) -> None:
        """One K6 launch over columns ``[start, start + seg)`` of the
        ``(n, chunk)`` rows, on the current stream."""
        blocks = max(1, min(_BLOCKS, -(-seg // 1024)))
        self.seq += 1
        with torch.cuda.device(self.device):
            stream = torch.cuda.current_stream(self.device).cuda_stream
            err = _kernel_lib().ddw_ring_all_reduce(
                x2d.data_ptr(), out.data_ptr(), self.own, self.left,
                self.right, x2d.shape[1], start, seg, self.slot_elems, self.n,
                self.me, self.seq, blocks, _RING_DTYPES[x2d.dtype],
                self.timeout_s, stream)
        _cuda_check(err, "kernel launch")

    def close(self) -> None:
        """Collective over the group: every rank calls it after its last
        launch."""
        if self.own is None:
            return
        lib = _kernel_lib()
        with torch.cuda.device(self.device):
            torch.cuda.synchronize(self.device)
            dist.barrier(group=self.group)
            for ptr in self._opened.values():
                _cuda_check(lib.ddw_ring_close(ptr), "cudaIpcCloseMemHandle")
            dist.barrier(group=self.group)
            _cuda_check(lib.ddw_ring_free(self.own), "cudaFree")
        self.own = self.left = self.right = None
        self._opened = {}


_COMMS: dict = {}


def get_comm(group, device: torch.device) -> RingComm:
    """The cached :class:`RingComm` of ``group`` on ``device``, made at its
    first use (a collective over the group, which every rank reaches at the
    same leaf)."""
    g = _group(group)
    key = (g, device.index)
    if key not in _COMMS:
        _COMMS[key] = RingComm(g, device)
    return _COMMS[key]


def close_comms() -> None:
    """Close every cached :class:`RingComm`, in the order they were made (a
    collective: every rank calls it)."""
    while _COMMS:
        _COMMS.pop(next(iter(_COMMS))).close()


def ring_all_reduce_cuda(x: torch.Tensor, comm: RingComm) -> torch.Tensor:
    """Launch K6 on the current stream, once per column segment, without
    synchronising: the sum of ``x`` over ``comm``'s group. ``x`` is a
    float32 or int32 CUDA tensor on ``comm``'s device, the same shape on
    every rank. Raises on anything else; never falls back."""
    if not x.is_cuda or x.device != comm.device:
        raise ValueError(f"K6 needs a tensor on {comm.device}, got "
                         f"{x.device}")
    _check_ring_dtype(x.dtype)
    if comm.own is None:
        raise RuntimeError("RingComm is closed")
    if comm.n == 1:
        return x
    x2d = ring_chunks(x, comm.n, lane=_LANE)
    out = torch.empty_like(x2d)
    for start, seg in ring_segments(x2d.shape[1], comm.slot_elems):
        comm.launch(x2d, out, start, seg)
        ring_all_reduce_cuda.launches += 1
    return ring_unchunk(out, tuple(x.shape), x.numel())


ring_all_reduce_cuda.launches = 0


def ring_all_reduce_pallas(x: torch.Tensor, group=None,
                           comm: RingComm | None = None) -> torch.Tensor:
    """Sum-allreduce ``x`` over ``group`` (default: the world) on the ring:
    K6 for a CUDA tensor (through ``comm``, default the group's cached
    :class:`RingComm`), the plain version for a CPU tensor. bf16 and f16 ring
    in f32 and are cast back; float32 and int32 ring as they are; other
    dtypes raise. A world of one returns ``x`` and launches nothing."""
    if comm is not None:
        group = comm.group
    n, _ = group_size_rank(group)
    if n == 1:
        return x
    acc = torch.float32 if x.dtype in _WIDE else x.dtype
    _check_ring_dtype(acc)
    xa = x.to(acc)
    if x.is_cuda:
        out = ring_all_reduce_cuda(xa, comm or get_comm(group, x.device))
    else:
        out = ring_all_reduce_plain(xa, group)
    return out.to(x.dtype)
