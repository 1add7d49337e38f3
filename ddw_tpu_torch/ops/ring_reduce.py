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

A tree of arrays rings as one: each hop carries every array's row side by
side (the *pack*, :func:`ring_pack_plan`). Arrays are packed whole-row, never
re-framed, so every value is summed by the same ranks in the same order as
in a ring of its own array. A pack wider than a comm slot (``SLOT_BYTES``)
runs as several rings over column ranges of the pack, as the TPU kernel runs
segments under its VMEM budget; ranges change the order of no sum.

- :func:`ring_all_reduce_cuda` launches K6 of ``csrc/ring_reduce.cu``, which
  replaces the Pallas kernel ``ddw_tpu/ops/ring_reduce.py`` ``_kernel``: one
  launch per column range of the pack, reading and writing the arrays in
  place. The ranks are processes, one per rank, on one card or several; each
  maps its neighbours' receive buffers through CUDA IPC (:class:`RingComm`)
  and the kernel moves the rows and signals with flags in that memory. It
  uses no NCCL, so ranks may share a card.
- :func:`ring_all_reduce_tree_plain`, the plain version: the same pack,
  hops and additions over ``torch.distributed`` point-to-point (gloo on the
  CPU), one send per hop carrying every array's row.

:func:`ring_all_reduce_tree_pallas` is the entry ``all_reduce_sum`` takes:
bf16 and f16 ring in f32, each ring dtype is one group, a CUDA tree launches
K6, a CPU tree runs the plain version. The ring dtypes are ``ddw_tpu``'s:
float32, int32, uint32, int16, int8, uint8 (integer sums wrap, as the
reference's do) and bool (adds as logical or, as ``jnp.add`` of bools); the
kernel rings uint32 and uint8 as int32 and int8, whose wrapping adds give the
same bits. A comm slot counts bytes, so it carries four times as many int8
columns as f32 ones. :func:`ring_all_reduce_pallas` and
:func:`ring_all_reduce_plain` are its one-array forms.

Point-to-point (:func:`send`, :func:`recv` and the hop :func:`ring_shift`
built on them) runs on the tensor's device, except that gloo's
point-to-point reads and writes host memory only (a CUDA pointer fails in
its TCP write with ``Bad address``). Ranks that share one card join over
gloo (NCCL refuses two ranks on a device), so over gloo a CUDA tensor is
sent from, and received into, a host copy; :data:`HOST_STAGED` counts
those copies, so a caller can report them.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
import itertools

import torch
import torch.distributed as dist

_LANE = 128        # rows are padded to this multiple, as on the TPU
SLOT_BYTES = 64 << 20   # one comm slot of a RingComm: 16 Mi four-byte values
# dtype -> kernel code (csrc/ring_reduce.cu's add): uint32 and uint8 take the
# int32 and int8 codes, whose wrapping adds give their bits
_RING_DTYPES = {torch.float32: 0, torch.int32: 1, torch.uint32: 1,
                torch.int8: 2, torch.uint8: 2, torch.int16: 3, torch.bool: 4}
_MAX_LEAVES = 256  # arrays in one K6 launch (kMaxLeaves)
_LEAF_BLOCKS = 32  # per-leaf K6 grid at most (kLeafMaxBlocks)
_WIDE = (torch.bfloat16, torch.float16)  # cast to f32 around the ring
_VARIANTS = ("packed", "per_leaf")
# "send" / "recv" -> CUDA tensors that went through a host copy (gloo)
HOST_STAGED: collections.Counter = collections.Counter()


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


def slot_elems_of(slot_bytes: int, itemsize: int = 4) -> int:
    """Values of ``itemsize`` bytes in a slot of ``slot_bytes``: the slot
    is rounded down to a multiple of 512 bytes (128 four-byte values), at
    least 512, so it holds a multiple of 128 values of every ring dtype."""
    return max(_LANE, slot_bytes // 4 // _LANE * _LANE) * 4 // itemsize


@dataclasses.dataclass(frozen=True)
class PackLaunch:
    """One ring over pack columns ``[p0, p1)``; ``leaves`` are the arrays
    with a column there, in pack order."""
    p0: int
    p1: int
    leaves: tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class PackPlan:
    """Where each array's row lies in a hop's pack, and the rings (kernel
    launches) that cover the pack."""
    chunks: tuple[int, ...]    # each array's row length, a multiple of 128
    offsets: tuple[int, ...]   # each array's first column in the pack
    width: int                 # columns of the pack
    launches: tuple[PackLaunch, ...]


def ring_pack_plan(sizes, n: int, slot_elems: int) -> PackPlan:
    """The pack of arrays of ``sizes`` values in a ring of ``n``: array
    ``i``'s row is ``chunks[i] = ring_chunk_len(sizes[i], n, 128)`` columns
    from column ``offsets[i]``, so every row starts on a multiple of 128.
    The pack is cut into launches of at most ``slot_elems`` columns (a
    multiple of 128) and 256 arrays (the kernel's table), which together
    cover every column once. Empty arrays take no column and no launch."""
    chunks = tuple(ring_chunk_len(s, n, _LANE) for s in sizes)
    offsets = tuple(itertools.accumulate(chunks, initial=0))
    width = offsets[-1]
    live = [i for i, c in enumerate(chunks) if c]
    launches, p0, a = [], 0, 0
    while p0 < width:
        while offsets[live[a]] + chunks[live[a]] <= p0:
            a += 1
        p1, b = min(p0 + slot_elems, width), a
        while b < len(live) and offsets[live[b]] < p1 and b - a < _MAX_LEAVES:
            b += 1
        if b < len(live) and offsets[live[b]] < p1:
            p1 = offsets[live[b]]  # a full table: end before the next array
        launches.append(PackLaunch(p0, p1, tuple(live[a:b])))
        p0 = p1
    return PackPlan(chunks, offsets[:-1], width, tuple(launches))


def ring_dtype_groups(dtypes) -> list[tuple[torch.dtype, list[int]]]:
    """``(ring dtype, array indices)`` per group, in order of first
    appearance: bf16 and f16 ring in f32 beside the f32 arrays; every other
    ring dtype (int32, uint32, int16, int8, uint8, bool) rings apart; other
    dtypes raise."""
    groups: dict[torch.dtype, list[int]] = {}
    for i, dt in enumerate(dtypes):
        acc = torch.float32 if dt in _WIDE else dt
        _check_ring_dtype(acc)
        groups.setdefault(acc, []).append(i)
    return list(groups.items())


def _group(group):
    return dist.group.WORLD if group is None else group


def group_size_rank(group=None) -> tuple[int, int]:
    """``(size, rank in the group)``, read from the group itself: a group
    built outside the default one (a replica's private gloo group, with no
    ``init_process_group`` at all) answers for itself. ``(1, 0)`` only for
    ``group=None`` when no default group is initialized (a world of
    one)."""
    if group is None:
        if not (dist.is_available() and dist.is_initialized()):
            return 1, 0
        group = dist.group.WORLD
    return group.size(), group.rank()


def _host_p2p(device, group) -> bool:
    return (torch.device(device).type == "cuda"
            and dist.get_backend(group) == "gloo")


def send(t: torch.Tensor, dst: int, group=None):
    """Start sending ``t`` to global rank ``dst``; returns ``(request,
    buffer)``: keep the buffer alive until the request is waited on."""
    g = _group(group)
    if _host_p2p(t.device, g):
        HOST_STAGED["send"] += 1
        buf = t.detach().cpu()
    else:
        buf = t.detach().contiguous()
    return dist.isend(buf, dst, group=g), buf


def recv(shape, dtype: torch.dtype, device, src: int,
         group=None) -> torch.Tensor:
    """Receive a tensor of ``shape`` from global rank ``src`` onto
    ``device`` (blocking)."""
    g = _group(group)
    host = _host_p2p(device, g)
    buf = torch.empty(shape, dtype=dtype, device="cpu" if host else device)
    dist.recv(buf, src, group=g)
    if host:
        HOST_STAGED["recv"] += 1
        return buf.to(device)
    return buf


def ring_shift(t: torch.Tensor, group=None, step: int = 1) -> torch.Tensor:
    """One ring hop over point-to-point: send ``t`` to group rank
    ``me + step`` and return what arrives from ``me - step`` (``step=1`` is
    ``lax.ppermute`` with ``i -> i+1``, ``step=-1`` its transpose)."""
    g = _group(group)
    n, me = group_size_rank(g)
    dst = dist.get_global_rank(g, (me + step) % n)
    src = dist.get_global_rank(g, (me - step) % n)
    req, _buf = send(t, dst, g)
    out = recv(t.shape, t.dtype, t.device, src, g)
    req.wait()
    return out


def _check_ring_dtype(dtype: torch.dtype) -> None:
    if dtype not in _RING_DTYPES:
        raise TypeError(f"the ring all-reduce takes float32, int32, uint32, "
                        f"int16, int8, uint8 and bool (bf16 and f16 ring in "
                        f"float32), got {dtype}: ddw_tpu rings no other dtype "
                        f"(it runs without 64-bit types)")


def ring_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a + b`` as K6 adds: wrapping for integers (uint32 through an int32
    view, which torch can add), logical or for bools."""
    if a.dtype == torch.uint32:
        return (a.view(torch.int32) + b.view(torch.int32)).view(torch.uint32)
    return a + b


def ring_all_reduce_tree_plain(xs: list[torch.Tensor], group=None,
                               slot_bytes: int | None = None
                               ) -> list[torch.Tensor]:
    """Plain PyTorch version of K6: the kernel's pack plan, hop schedule and
    additions (``out[c_recv] = local + arriving``) over point-to-point sends
    to the right and receives from the left, one send per hop carrying the
    rows of every array of the launch. ``xs`` share one ring dtype; every
    rank of ``group`` passes the same shapes."""
    for x in xs:
        _check_ring_dtype(x.dtype)
    n, me = group_size_rank(group)
    if n == 1:
        return list(xs)
    rows = [ring_chunks(x, n, lane=_LANE) for x in xs]
    outs = [torch.empty_like(r) for r in rows]
    plan = ring_pack_plan([x.numel() for x in xs], n, slot_elems_of(
        SLOT_BYTES if slot_bytes is None else slot_bytes,
        xs[0].element_size()))
    for launch in plan.launches:
        parts = []  # (rows, out, columns) of each array in the launch
        for i in launch.leaves:
            off = plan.offsets[i]
            cols = slice(max(launch.p0, off) - off,
                         min(launch.p1, off + plan.chunks[i]) - off)
            parts.append((rows[i], outs[i], cols))
        widths = [c.stop - c.start for _, _, c in parts]

        def hop(c_send, from_out):
            pack = torch.cat([(o if from_out else r)[c_send, c]
                              for r, o, c in parts])
            return ring_shift(pack, group).split(widths)

        for k in range(n - 1):
            c_send, c_recv = (me - k) % n, (me - k - 1) % n
            for (r, o, c), arriving in zip(parts, hop(c_send, k > 0)):
                o[c_recv, c] = ring_add(r[c_recv, c], arriving)
        for k in range(n - 1):
            c_send, c_recv = (me + 1 - k) % n, (me - k) % n
            for (_, o, c), arriving in zip(parts, hop(c_send, True)):
                o[c_recv, c] = arriving
    return [ring_unchunk(o, tuple(x.shape), x.numel())
            for o, x in zip(outs, xs)]


def ring_all_reduce_plain(x: torch.Tensor, group=None,
                          slot_bytes: int | None = None) -> torch.Tensor:
    """:func:`ring_all_reduce_tree_plain` of one array."""
    return ring_all_reduce_tree_plain([x], group, slot_bytes)[0]


@functools.cache
def _kernel_lib() -> ctypes.CDLL:
    from ddw_tpu_torch.ops import _build

    lib = _build.load("ring_reduce.cu")
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    u, d = ctypes.c_uint, ctypes.c_double
    lib.ddw_ring_buffer_bytes.argtypes = [i, ll]
    lib.ddw_ring_buffer_bytes.restype = ll
    lib.ddw_ring_alloc.argtypes = [ll, ctypes.POINTER(p), p]
    lib.ddw_ring_open.argtypes = [p, ctypes.POINTER(p)]
    lib.ddw_ring_close.argtypes = [p]
    lib.ddw_ring_free.argtypes = [p]
    lib.ddw_ring_pack_all_reduce.argtypes = [p, i, p, p, ll, ll, ll, i, i, u,
                                             i, d, p]
    lib.ddw_ring_leaf_all_reduce.argtypes = [p, p, p, p, p, ll, ll, ll, ll, i,
                                             i, u, i, i, d, p]
    for fn in (lib.ddw_ring_alloc, lib.ddw_ring_open, lib.ddw_ring_close,
               lib.ddw_ring_free, lib.ddw_ring_pack_all_reduce,
               lib.ddw_ring_leaf_all_reduce):
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
    ``[hop][block]`` and two entry flags per block (the per-leaf design's),
    then two sets (by call parity) of ``n - 1`` reduce-scatter and ``n - 1``
    all-gather slots of ``slot_bytes`` each (by default ``SLOT_BYTES``,
    which holds the lm_flash LM's whole gradient pack at 2 ranks and up;
    a slot carries ``slot_bytes / itemsize`` columns of a ring dtype). The 64-byte IPC
    handles are exchanged with ``all_gather_object`` over the group (the
    only use of the group besides barriers, so a gloo group serves ranks
    that share a card, where NCCL refuses), and each rank opens its left
    and right neighbours' (by group rank). ``seq`` numbers the launches;
    all ranks of the group advance it together, and a flag only ever takes
    the number of the call that wrote it (``csrc/ring_reduce.cu`` says why
    two slot sets need no entry barrier). ``timeout_s`` bounds every wait
    inside the kernel: past it the kernel traps, so a peer that never
    arrives fails the rank with a CUDA error instead of hanging it.

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
        self.slot_bytes = 4 * slot_elems_of(
            SLOT_BYTES if slot_bytes is None else slot_bytes)
        self.timeout_s, self.seq = timeout_s, 0
        self.own = self.left = self.right = None
        lib = _kernel_lib()
        handle = ctypes.create_string_buffer(64)
        own = ctypes.c_void_p()
        with torch.cuda.device(self.device):
            nbytes = lib.ddw_ring_buffer_bytes(self.n, self.slot_bytes)
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

    def _stream(self) -> int:
        return torch.cuda.current_stream(self.device).cuda_stream

    def slot_cols(self, dtype: torch.dtype) -> int:
        """Columns of ``dtype`` one slot carries: its bytes over the value's,
        a multiple of 128."""
        return self.slot_bytes // torch.empty((), dtype=dtype).element_size()

    def launch_pack(self, xs, outs, plan: PackPlan,
                    launch: PackLaunch) -> None:
        """One K6 launch over pack columns ``[launch.p0, launch.p1)`` of the
        arrays ``xs`` (contiguous, 16-byte aligned) into ``outs``, on the
        current stream."""
        words = (ctypes.c_longlong * (5 * len(launch.leaves)))(*(
            w for i in launch.leaves
            for w in (xs[i].data_ptr(), outs[i].data_ptr(), xs[i].numel(),
                      plan.chunks[i], plan.offsets[i])))
        self.seq += 1
        with torch.cuda.device(self.device):
            err = _kernel_lib().ddw_ring_pack_all_reduce(
                words, len(launch.leaves), self.own, self.right, launch.p0,
                launch.p1 - launch.p0, self.slot_bytes, self.n, self.me,
                self.seq, _RING_DTYPES[xs[0].dtype], self.timeout_s,
                self._stream())
        _cuda_check(err, "kernel launch")

    def launch_leaf(self, x2d: torch.Tensor, out: torch.Tensor, start: int,
                    seg: int) -> None:
        """One launch of the earlier per-leaf K6 over columns ``[start,
        start + seg)`` of one array's ``(n, chunk)`` rows."""
        blocks = max(1, min(_LEAF_BLOCKS, -(-seg // 1024)))
        self.seq += 1
        with torch.cuda.device(self.device):
            err = _kernel_lib().ddw_ring_leaf_all_reduce(
                x2d.data_ptr(), out.data_ptr(), self.own, self.left,
                self.right, x2d.shape[1], start, seg, self.slot_bytes, self.n,
                self.me, self.seq, blocks, _RING_DTYPES[x2d.dtype],
                self.timeout_s, self._stream())
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
    same call)."""
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


def ring_all_reduce_cuda(xs: list[torch.Tensor], comm: RingComm,
                         _variant: str = "packed") -> list[torch.Tensor]:
    """Launch K6 on the current stream, once per launch of the pack plan,
    without synchronising: the sums of the arrays ``xs`` over ``comm``'s
    group, new tensors. ``xs`` are CUDA tensors of one ring dtype on
    ``comm``'s device, the same shapes on every rank. Raises on
    anything else; never falls back. ``_variant="per_leaf"`` runs the
    earlier design (one launch per array and slot-wide segment), for timing
    beside it only."""
    if _variant not in _VARIANTS:
        raise ValueError(f"unknown K6 variant {_variant!r}")
    if len({x.dtype for x in xs}) > 1:
        raise ValueError("one K6 launch takes arrays of one dtype")
    for x in xs:
        _check_ring_dtype(x.dtype)
    for x in xs:
        if not x.is_cuda or x.device != comm.device:
            raise ValueError(f"K6 needs tensors on {comm.device}, got "
                             f"{x.device}")
    if comm.own is None:
        raise RuntimeError("RingComm is closed")
    if comm.n == 1:
        return list(xs)
    count = ring_all_reduce_cuda.launches_by_variant
    if _variant == "per_leaf":
        outs = []
        for x in xs:
            x2d = ring_chunks(x, comm.n, lane=_LANE)
            out = torch.empty_like(x2d)
            for start, seg in ring_segments(x2d.shape[1],
                                            comm.slot_cols(x.dtype)):
                comm.launch_leaf(x2d, out, start, seg)
                ring_all_reduce_cuda.launches += 1
                count["per_leaf"] += 1
            outs.append(ring_unchunk(out, tuple(x.shape), x.numel()))
        return outs
    # In place: contiguous and 16-byte aligned (a view at an odd offset is
    # copied), outputs fresh from the allocator.
    xs = [x.contiguous() for x in xs]
    xs = [x if x.data_ptr() % 16 == 0 else x.clone() for x in xs]
    outs = [torch.empty_like(x) for x in xs]
    plan = ring_pack_plan([x.numel() for x in xs], comm.n,
                          comm.slot_cols(xs[0].dtype))
    for launch in plan.launches:
        comm.launch_pack(xs, outs, plan, launch)
        ring_all_reduce_cuda.launches += 1
        count["packed"] += 1
    return outs


ring_all_reduce_cuda.launches = 0
ring_all_reduce_cuda.launches_by_variant = dict.fromkeys(_VARIANTS, 0)


def ring_all_reduce_tree_pallas(xs: list[torch.Tensor], group=None,
                                comm: RingComm | None = None,
                                _variant: str = "packed"
                                ) -> list[torch.Tensor]:
    """Sum-allreduce the arrays ``xs`` over ``group`` (default: the world)
    on the ring, one ring per ring dtype (:func:`ring_dtype_groups`): K6 for
    CUDA arrays (through ``comm``, default the group's cached
    :class:`RingComm`), the plain version for CPU arrays. bf16 and f16 ring
    in f32 and are cast back. The arrays must lie on one device; dtypes
    ``ddw_tpu`` does not ring (64-bit ones) raise. A world of one returns ``xs`` and launches nothing."""
    devices = {x.device for x in xs}
    if len(devices) > 1:
        raise ValueError(f"the ring all-reduce takes arrays on one device, "
                         f"got {sorted(map(str, devices))}")
    if comm is not None:
        group = comm.group
    n, _ = group_size_rank(group)
    if n == 1 or not xs:
        return list(xs)
    device = xs[0].device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"the ring all-reduce runs on CPU or CUDA arrays, "
                         f"got {device}")
    out: list = [None] * len(xs)
    for acc, idx in ring_dtype_groups([x.dtype for x in xs]):
        xa = [xs[i].to(acc) for i in idx]
        if device.type == "cuda":
            got = ring_all_reduce_cuda(xa, comm or get_comm(group, device),
                                       _variant)
        else:
            got = ring_all_reduce_tree_plain(xa, group)
        for i, g in zip(idx, got):
            out[i] = g.to(xs[i].dtype)
    return out


def ring_all_reduce_pallas(x: torch.Tensor, group=None,
                           comm: RingComm | None = None) -> torch.Tensor:
    """:func:`ring_all_reduce_tree_pallas` of one array — the entry
    ``ddw_tpu`` has."""
    return ring_all_reduce_tree_pallas([x], group, comm)[0]
