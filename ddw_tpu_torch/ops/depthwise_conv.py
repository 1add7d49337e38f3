"""Depthwise 3x3 convolution, NHWC — the port of ``ddw_tpu.ops.depthwise_conv``.

Implementations of the same SAME-padded function and its gradients:

- :func:`depthwise_conv3x3_cuda` launches the hand-written kernel K1
  (stride 1), which replaces the Pallas kernel
  ``ddw_tpu/ops/depthwise_conv.py`` ``_fwd_kernel`` / ``_pallas_fwd``;
  ``flip=True`` reads the taps
  ``w[2-dy, 2-dx]``, the input gradient's. Like that kernel it is bound by
  memory — about 9 multiply-adds per element read, one read of x and one
  write of y — so its least time on an H100 SXM is
  ``(2*B*H*W*C + 9*C) * bytes / 3.35 TB/s``.
- :func:`depthwise_conv3x3_wgrad_cuda` launches K2, the weight gradient,
  which replaces ``_dw_kernel`` / ``_pallas_dw``: deterministic per-block
  f32 partials, then a sum in a fixed order, no atomics.
- Each has two variants, picked by :func:`_dw_variant`: ``"tma"``
  (``csrc/depthwise_sm90.cu``: TMA halo tiles with zero fill for the padding,
  persistent blocks over the partition of :func:`dw_tile_plan`) wherever
  ``C * bytes`` is a multiple of 16 and the pointers are 16-byte aligned, and
  ``"simt"`` (``csrc/depthwise_conv.cu``: per-thread global loads) for the
  rest. ``_variant="simt"`` forces the older kernel, to time the two in
  turns; ``launches_by_variant`` counts each.
- :func:`depthwise_conv3x3_plain` and :func:`depthwise_conv3x3_wgrad_plain`,
  the plain PyTorch versions: shifted products over ``F.pad`` accumulated in
  f32 (f64 for f64 input). The CPU path and the references the kernels are
  held against.
- :func:`conv2d_same` with ``groups=C``, the library grouped convolution, for
  stride 2 (the flipped-tap trick and the kernels are stride-1 only) and for
  ``dw_impl="xla"``.

:func:`depthwise_conv3x3` dispatches: stride 1 goes through
:class:`DepthwiseKernelFn` — the kernels for a CUDA tensor, the plain
versions for a CPU tensor — whose backward is K1 on the output gradient with
flipped taps (dx) and K2 (dw), as ``_vjp_bwd`` does; stride 2 goes to the
library conv and its autograd, as ``impl="auto"`` does in ``ddw_tpu``.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

_KERNEL_DTYPES = {torch.float32: (0, 4), torch.bfloat16: (1, 8)}  # code, vec
_VARIANTS = ("tma", "simt")


def same_pads(n: int, k: int, s: int) -> tuple[int, int]:
    """JAX's ``padding="SAME"`` split for one spatial dim of size ``n``:
    ``(0, 1)`` for a stride-2 3x3 on even ``n``, ``(1, 1)`` on odd ``n``."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def conv2d_same(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
                groups: int = 1) -> torch.Tensor:
    """Library convolution with JAX SAME padding. ``x`` is NHWC, ``w`` is
    ``[out, in/groups, kh, kw]``; returns NHWC-contiguous.

    The conv sees ``x.permute(0, 3, 1, 2)``, which on an NHWC-contiguous
    tensor is a ``channels_last`` NCHW view with no copy."""
    kh, kw = w.shape[-2:]
    ph = same_pads(x.shape[1], kh, stride)
    pw = same_pads(x.shape[2], kw, stride)
    if any(ph + pw):
        x = F.pad(x, (0, 0, *pw, *ph))
    y = F.conv2d(x.permute(0, 3, 1, 2), w, stride=stride, groups=groups)
    return y.permute(0, 2, 3, 1).contiguous()


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """f32 accumulation, as the kernels do; f64 stays f64 (gradcheck)."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def depthwise_conv3x3_plain(x: torch.Tensor, w: torch.Tensor, *,
                            flip: bool = False) -> torch.Tensor:
    """Plain PyTorch version of K1: stride 1, f32 accumulation in dy-major
    then dx order, each product and sum rounded on its own, cast to the input
    dtype. ``flip=True`` takes the taps ``w[2-dy, 2-dx]`` (the input
    gradient's), in the same order."""
    acc_dtype = _acc_dtype(x.dtype)
    xf, wf = x.to(acc_dtype), w.to(acc_dtype)
    if flip:
        wf = wf.flip(0, 1)
    _, h, wd, _ = x.shape
    xp = F.pad(xf, (0, 0, 1, 1, 1, 1))
    acc = torch.zeros_like(xf)
    for dy in range(3):
        for dx in range(3):
            acc += xp[:, dy:dy + h, dx:dx + wd, :] * wf[dy, dx]
    return acc.to(x.dtype)


def depthwise_conv3x3_wgrad_plain(x: torch.Tensor,
                                  g: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K2: ``dw[dy, dx, c] = sum_{b,h,w}
    xpad[b, h+dy, w+dx, c] * g[b, h, w, c]`` — nine shifted products summed
    over ``(b, h, w)`` in f32 (f64 for f64 input), returned ``[3, 3, C]`` in
    that accumulation dtype."""
    acc_dtype = _acc_dtype(x.dtype)
    xf, gf = x.to(acc_dtype), g.to(acc_dtype)
    _, h, wd, c = x.shape
    xp = F.pad(xf, (0, 0, 1, 1, 1, 1))
    taps = [(xp[:, dy:dy + h, dx:dx + wd, :] * gf).sum(dim=(0, 1, 2))
            for dy in range(3) for dx in range(3)]
    return torch.stack(taps).reshape(3, 3, c)


# -- the "tma" variant's tile plan -------------------------------------------

_TMA_ROWS = 4              # output rows of a thread's strip (kRows)
_TMA_MAX_THREADS = 256     # threads of a block (its __launch_bounds__)
# Stages of the ring. Two measured faster than three or four for both
# kernels at every MobileNetV2 layer on the H100 (PERF.md); the kernels take
# up to four.
_TMA_STAGES = 2
_TMA_BAR_BYTES = 128       # the mbarriers ahead of the stages
# Shared memory of one block such that two fit on an SM (228 KB each, 1 KB
# of it reserved per block): the register budget of 128 a thread allows two.
_TMA_SMEM = 233472 // 2 - 1024
# Blocks the partition aims at: two on each of an H100's 132 SMs. A
# constant, so that the partition, and K2's order of sums, depend on the
# shape alone.
_TMA_BLOCKS = 264
# The cost model's fixed costs, in element slots, fitted to tile timings on
# the H100 (PERF.md): a tile's, a box row's (one run of channels, a TMA
# request), and a box row's extra where channel blocks do not start on
# 128-byte lines.
_TMA_TILE_COST = 1024
_TMA_RUN_COST = 64
_TMA_MISALIGNED_RUN_COST = 32


class DwTilePlan(NamedTuple):
    """The tiles and the partition of a ``"tma"`` launch.

    A tile is ``th`` rows x ``tw`` columns x ``cb`` channels of one image;
    its TMA box of x adds a one-pixel halo. Block ``(cb_index, part)``, of
    ``grid = channel_blocks * parts``, walks the channel block's spatial
    tiles ``tile_range(part)`` (image-major, then rows, then columns)
    through a ring of ``stages`` stages of shared memory (``smem`` bytes for
    K1, ``smem_wgrad`` for K2, whose stages hold the g tile too). K2 writes
    one f32 ``[9, cb]`` partial per block into a ``[parts, 9, C]``
    workspace."""
    th: int
    tw: int
    cb: int
    stages: int
    grid: int
    parts: int
    threads: int
    smem: int
    smem_wgrad: int
    channel_blocks: int
    tiles: int    # of a channel block: B * ceil(H / th) * ceil(W / tw)

    def tile_range(self, part: int) -> range:
        """The spatial tiles block ``(·, part)`` takes, in its order."""
        return range(part * self.tiles // self.parts,
                     (part + 1) * self.tiles // self.parts)


def _round128(n: int) -> int:
    return -(-n // 128) * 128


def _tile_plan_of(b: int, h: int, w: int, c: int, nbytes: int, th: int,
                  tw: int, cb: int) -> DwTilePlan | None:
    """The plan of one tile shape, or None where the TMA (box dims <= 256,
    ``cb * bytes`` a multiple of 16), the block (256 threads) or two blocks'
    shared memory cannot take it."""
    vec = 16 // nbytes
    if cb % vec or not 0 < cb <= 256 or not 0 < th <= 254 or \
            not 0 < tw <= 254:
        return None
    strips = -(-th // _TMA_ROWS)
    items = cb // vec * tw * strips
    if items > _TMA_MAX_THREADS:
        return None
    xbytes = _round128((th + 2) * (tw + 2) * cb * nbytes)
    gbytes = _round128(th * tw * cb * nbytes)
    reduce_bytes = tw * strips * 9 * cb * 4     # K2: its threads' sums
    smem_wgrad = _TMA_BAR_BYTES + max(_TMA_STAGES * (xbytes + gbytes),
                                      reduce_bytes)
    if smem_wgrad > _TMA_SMEM:
        return None
    channel_blocks = -(-c // cb)
    tiles = b * -(-h // th) * -(-w // tw)
    parts = min(tiles, -(-_TMA_BLOCKS // channel_blocks))
    return DwTilePlan(
        th, tw, cb, _TMA_STAGES, channel_blocks * parts, parts,
        -(-items // 32) * 32, _TMA_BAR_BYTES + _TMA_STAGES * xbytes,
        smem_wgrad, channel_blocks, tiles)


def _plan_cost(plan: DwTilePlan, b: int, h: int, w: int, c: int,
               nbytes: int) -> float:
    """Element slots a plan spends per output element: the boxes filled
    (halo included, each pixel's run of channels rounded up to 32-byte
    sectors, plus a fixed cost per run), the thread slots computed, a fixed
    cost per tile, all divided by the share of ``_TMA_BLOCKS`` the tiles can
    keep busy."""
    tiles = plan.tiles * plan.channel_blocks
    run = -(-plan.cb * nbytes // 32) * 32 // nbytes + _TMA_RUN_COST
    if plan.channel_blocks > 1 and plan.cb * nbytes % 128:
        run += _TMA_MISALIGNED_RUN_COST
    fill = tiles * (plan.th + 2) * (plan.tw + 2) * run
    lanes = tiles * plan.threads * _TMA_ROWS * (16 // nbytes)
    busy = min(1.0, tiles / _TMA_BLOCKS)
    return (fill + lanes + tiles * _TMA_TILE_COST) / busy / (b * h * w * c)


def _sizes(n: int, small: tuple[int, ...]) -> set[int]:
    """Candidate tile sizes along a dim of ``n``: ``small`` sizes, ``n``
    itself and its halves, thirds, quarters and eighths, all at most 64."""
    out = {min(n, t) for t in small}
    out |= {-(-n // k) for k in (1, 2, 3, 4, 8)}
    return {t for t in out if t <= 64}


@functools.lru_cache(maxsize=None)
def dw_tile_plan(b: int, h: int, w: int, c: int,
                 dtype: torch.dtype) -> DwTilePlan:
    """The ``"tma"`` kernels' tiles and partition for x ``[b, h, w, c]``: the
    cheapest tile shape by :func:`_plan_cost` among those the TMA and two
    blocks an SM allow, with a channel block of at least 128 bytes and a
    multiple of 32 (or all of ``c``). A function of the shape alone. Raises
    where ``c * bytes`` is not a multiple of 16 or the dtype is not float32
    or bfloat16."""
    if dtype not in _KERNEL_DTYPES:
        raise ValueError(f"the depthwise kernel takes float32 or bfloat16, "
                         f"got {dtype}")
    nbytes = torch.finfo(dtype).bits // 8
    vec = 16 // nbytes
    if c % vec or min(b, h, w, c) < 1:
        raise ValueError(f"the tma depthwise kernel needs C * {nbytes} bytes "
                         f"a multiple of 16 and a non-empty x, got "
                         f"{[b, h, w, c]}")
    min_cb = min(128 // nbytes, c)
    best = None
    for cb in range(min_cb, min(256, c) + 1, vec):
        if cb < c and cb * nbytes % 32:
            continue        # channel blocks would start inside a sector
        for tw in sorted(_sizes(w, (4, 8, 16, 32))):
            for th in sorted(_sizes(h, tuple(range(4, 65, 4)))):
                plan = _tile_plan_of(b, h, w, c, nbytes, th, tw, cb)
                if plan is None:
                    continue
                key = (_plan_cost(plan, b, h, w, c, nbytes), -cb, -tw, -th)
                if best is None or key < best[0]:
                    best = (key, plan)
    if best is None:
        raise ValueError(f"no tma tile plan for {[b, h, w, c]} {dtype}")
    return best[1]


def _dw_variant(dtype: torch.dtype, c: int, aligned: bool) -> str:
    """Which K1 and K2 kernels a launch takes: ``"tma"``
    (``csrc/depthwise_sm90.cu``) where ``c * bytes`` is a multiple of 16
    and every pointer is 16-byte aligned, which is what the TMA needs, else
    ``"simt"`` (``csrc/depthwise_conv.cu``)."""
    return "tma" if aligned and c % _KERNEL_DTYPES[dtype][1] == 0 else "simt"


def _pick_variant(x: torch.Tensor, tensors, forced: str | None) -> str:
    """:func:`_dw_variant` for these tensors, or ``forced``: ``"simt"``
    takes every shape; ``"tma"`` where the shape refuses it raises."""
    aligned = all(t.data_ptr() % 16 == 0 for t in tensors)
    variant = _dw_variant(x.dtype, x.shape[-1], aligned)
    if forced is None or forced == variant or forced == "simt":
        return variant if forced is None else forced
    raise ValueError(f"cannot run the {forced!r} depthwise kernel on "
                     f"{x.dtype} x {tuple(x.shape)}"
                     f"{'' if aligned else ' (unaligned pointers)'}: its "
                     f"kernel is {variant!r}")


# -- the kernels --------------------------------------------------------------

@functools.cache
def _kernel_lib() -> ctypes.CDLL:
    from ddw_tpu_torch.ops import _build

    lib = _build.load("depthwise_conv.cu")
    lib.ddw_dw3x3_fwd.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 \
        + [ctypes.c_void_p]
    lib.ddw_dw3x3_fwd.restype = ctypes.c_int
    lib.ddw_dw3x3_wgrad.argtypes = [ctypes.c_void_p] * 4 \
        + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.ddw_dw3x3_wgrad.restype = ctypes.c_int
    lib.ddw_dw3x3_wgrad_workspace.argtypes = [ctypes.c_int] * 4
    lib.ddw_dw3x3_wgrad_workspace.restype = ctypes.c_longlong
    return lib


@functools.cache
def _tma_lib() -> ctypes.CDLL:
    from ddw_tpu_torch.ops import _build

    lib = _build.load("depthwise_sm90.cu")
    # x, w, y; B, H, W, C, dtype, th, tw, cb, stages, parts, flip; the stream
    lib.ddw_dw3x3_fwd_tma.argtypes = [ctypes.c_void_p] * 3 \
        + [ctypes.c_int] * 11 + [ctypes.c_void_p]
    lib.ddw_dw3x3_fwd_tma.restype = ctypes.c_int
    # x, g, part, dw; B, H, W, C, dtype, th, tw, cb, stages, parts; the stream
    lib.ddw_dw3x3_wgrad_tma.argtypes = [ctypes.c_void_p] * 4 \
        + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    lib.ddw_dw3x3_wgrad_tma.restype = ctypes.c_int
    return lib


def _check_kernel_input(x: torch.Tensor, other: torch.Tensor, name: str,
                        other_shape: tuple) -> None:
    """The refusals K1 and K2 share: one CUDA device, f32 or bf16 of one
    dtype, NHWC ``x``, contiguity, and 32-bit indexing."""
    if not (x.is_cuda and other.is_cuda and x.device == other.device):
        raise ValueError(f"the depthwise kernel needs x and {name} on one "
                         f"CUDA device, got {x.device} and {other.device}")
    if x.dtype not in _KERNEL_DTYPES or other.dtype != x.dtype:
        raise ValueError(f"the depthwise kernel takes float32 or bfloat16 x "
                         f"and {name} of the same dtype, got {x.dtype}, "
                         f"{other.dtype}")
    if x.dim() != 4 or tuple(other.shape) != other_shape:
        raise ValueError(f"need x [B, H, W, C] and {name} "
                         f"{list(other_shape)}, got {tuple(x.shape)} and "
                         f"{tuple(other.shape)}")
    if not (x.is_contiguous() and other.is_contiguous()):
        raise ValueError(f"the depthwise kernel needs NHWC-contiguous x and "
                         f"contiguous {name}")
    if x.numel() >= 1 << 30:
        raise ValueError(f"x has {x.numel()} elements; the kernel indexes "
                         f"with 32-bit integers (fewer than 2**30)")


def _vec(x: torch.Tensor, *others: torch.Tensor) -> tuple[int, int]:
    """Dtype code and channels per thread of the ``"simt"`` kernels: 16-byte
    vectors when C and every pointer allow, else one channel."""
    code, vec = _KERNEL_DTYPES[x.dtype]
    if x.shape[-1] % vec or any(t.data_ptr() % 16 for t in (x, *others)):
        vec = 1
    return code, vec


def _launch(fn, device: torch.device, *args) -> int:
    """Call a C entry on ``device``'s current stream; its return code."""
    with torch.cuda.device(device):
        return fn(*args, torch.cuda.current_stream(device).cuda_stream)


def _check_launch(err: int, what: str) -> None:
    """Raise on a C entry's non-zero return: a cudaError_t code, or (from
    ``depthwise_sm90.cu``) 1000 plus the CUresult of a failed tensor-map
    encode. Nothing falls back."""
    if err >= 1000:
        raise RuntimeError(f"{what}: encoding a TMA tensor map failed with "
                           f"CUresult {err - 1000}")
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def depthwise_conv3x3_cuda(x: torch.Tensor, w: torch.Tensor, *,
                           flip: bool = False, _variant: str | None = None,
                           _plan: DwTilePlan | None = None) -> torch.Tensor:
    """Launch K1 (stride 1) on the current stream, without synchronising.
    ``x`` is an NHWC-contiguous CUDA tensor in float32 or bfloat16, ``w`` the
    contiguous ``[3, 3, C]`` taps in the same dtype; ``flip=True`` computes
    with ``w[2-dy, 2-dx]``. The kernel is :func:`_dw_variant`'s;
    ``_variant="simt"`` forces the older kernel and ``_plan`` another tile
    plan of the ``"tma"`` one (timing only). Raises on anything else; never
    falls back. ``launches`` counts every launch, ``launches_by_variant``
    each kernel's."""
    _check_kernel_input(x, w, "w", (3, 3, x.shape[-1]))
    b, h, wd, c = x.shape
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y
    variant = _pick_variant(x, (x, w, y), _variant)
    code = _KERNEL_DTYPES[x.dtype][0]
    if variant == "tma":
        plan = _plan or dw_tile_plan(b, h, wd, c, x.dtype)
        err = _launch(_tma_lib().ddw_dw3x3_fwd_tma, x.device, x.data_ptr(),
                      w.data_ptr(), y.data_ptr(), b, h, wd, c, code, plan.th,
                      plan.tw, plan.cb, plan.stages, plan.parts, int(flip))
    else:
        _, vec = _vec(x, w, y)
        err = _launch(_kernel_lib().ddw_dw3x3_fwd, x.device, x.data_ptr(),
                      w.data_ptr(), y.data_ptr(), b, h, wd, c, code, vec,
                      int(flip))
    _check_launch(err, f"depthwise 3x3 forward (K1, {variant})")
    _count_launch(depthwise_conv3x3_cuda, variant)
    return y


def depthwise_conv3x3_wgrad_cuda(x: torch.Tensor, g: torch.Tensor, *,
                                 _variant: str | None = None,
                                 _plan: DwTilePlan | None = None
                                 ) -> torch.Tensor:
    """Launch K2 on the current stream, without synchronising: the f32
    ``[3, 3, C]`` weight gradient from ``x`` and the output gradient ``g``,
    both NHWC-contiguous CUDA tensors of one shape in float32 or bfloat16.
    Variants, ``_plan`` and counts as for :func:`depthwise_conv3x3_cuda`.
    Raises on anything else; never falls back. Deterministic: the partition
    and every order of summation depend on the shape alone, so two launches
    on the same input give the same bits."""
    _check_kernel_input(x, g, "g", tuple(x.shape))
    b, h, wd, c = x.shape
    dw = torch.empty(3, 3, c, dtype=torch.float32, device=x.device)
    if x.numel() == 0:
        return dw.zero_()
    variant = _pick_variant(x, (x, g), _variant)
    code = _KERNEL_DTYPES[x.dtype][0]
    if variant == "tma":
        plan = _plan or dw_tile_plan(b, h, wd, c, x.dtype)
        part = torch.empty(plan.parts * 9 * c, dtype=torch.float32,
                           device=x.device)
        err = _launch(_tma_lib().ddw_dw3x3_wgrad_tma, x.device, x.data_ptr(),
                      g.data_ptr(), part.data_ptr(), dw.data_ptr(), b, h, wd,
                      c, code, plan.th, plan.tw, plan.cb, plan.stages,
                      plan.parts)
    else:
        _, vec = _vec(x, g)
        lib = _kernel_lib()
        part = torch.empty(lib.ddw_dw3x3_wgrad_workspace(b, h, wd, c),
                           dtype=torch.float32, device=x.device)
        err = _launch(lib.ddw_dw3x3_wgrad, x.device, x.data_ptr(),
                      g.data_ptr(), part.data_ptr(), dw.data_ptr(), b, h, wd,
                      c, code, vec)
    _check_launch(err, f"depthwise 3x3 weight gradient (K2, {variant})")
    _count_launch(depthwise_conv3x3_wgrad_cuda, variant)
    return dw


# Trials of a parallel search launch from several threads at once; a bare
# ``+= 1`` on a function attribute is a read and a write that two threads can
# interleave, losing a count.
_COUNT_LOCK = threading.Lock()


def _count_launch(fn, variant: str) -> None:
    """One more launch of ``fn``'s kernel on ``variant``, under the lock."""
    with _COUNT_LOCK:
        fn.launches += 1
        fn.launches_by_variant[variant] += 1


def reset_depthwise_counts() -> None:
    """Set K1's and K2's launch counts, the totals and each variant's, to
    zero."""
    with _COUNT_LOCK:
        for fn in (depthwise_conv3x3_cuda, depthwise_conv3x3_wgrad_cuda):
            fn.launches = 0
            fn.launches_by_variant = dict.fromkeys(_VARIANTS, 0)


reset_depthwise_counts()


class DepthwiseKernelFn(torch.autograd.Function):
    """The stride-1 kernel path with its backward (``_depthwise_pallas``'s
    custom VJP): forward K1; backward ``dx = K1(g, w flipped in both spatial
    axes)`` (the flip read inside the kernel, no copy of the taps) and
    ``dw = K2(x, g)`` cast to the tap dtype (``_vjp_bwd``, which
    rounds dw to bf16 in bf16 training before the parameter cast returns it
    to f32). ``plain=True`` runs the plain versions instead."""

    @staticmethod
    def forward(ctx, x, w, plain: bool):
        ctx.save_for_backward(x, w)
        ctx.plain = plain
        return (depthwise_conv3x3_plain if plain
                else depthwise_conv3x3_cuda)(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype).contiguous()  # autograd may hand a strided view
        dx = dw = None
        if ctx.needs_input_grad[0]:
            fwd = depthwise_conv3x3_plain if ctx.plain \
                else depthwise_conv3x3_cuda
            dx = fwd(g, w, flip=True)
        if ctx.needs_input_grad[1]:
            wgrad = depthwise_conv3x3_wgrad_plain if ctx.plain \
                else depthwise_conv3x3_wgrad_cuda
            dw = wgrad(x, g).to(w.dtype)
        return dx, dw, None


def depthwise_conv3x3(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
                      impl: str = "auto",
                      interpret: bool = False) -> torch.Tensor:
    """SAME depthwise 3x3 conv, NHWC; ``w`` is ``[3, 3, C]``.

    ``impl``: "auto" (the kernel path at stride 1, the library conv at stride
    2), "pallas" (the kernel path; stride 1 only) or "xla" (the library
    conv). On the kernel path (:class:`DepthwiseKernelFn`, differentiable) a
    CUDA tensor launches the CUDA kernels and a CPU tensor runs the plain
    versions; ``interpret=True`` runs the plain versions on any device (the
    role of the Pallas interpreter in ``ddw_tpu``'s tests)."""
    if w.dim() != 3 or tuple(w.shape[:2]) != (3, 3):
        raise ValueError(f"w must be [3, 3, C], got {tuple(w.shape)}")
    if x.shape[-1] != w.shape[-1]:
        raise ValueError(f"channel mismatch: x {tuple(x.shape)} vs w "
                         f"{tuple(w.shape)}")
    if impl not in ("auto", "pallas", "xla"):
        raise ValueError(f"unknown impl {impl!r}")
    if impl == "auto":
        impl = "pallas" if stride == 1 else "xla"
    if impl == "pallas":
        if stride != 1:
            raise ValueError("the depthwise kernel supports stride 1; use "
                             "impl='xla' for strided layers")
        return DepthwiseKernelFn.apply(
            x, w, interpret or x.device.type == "cpu")
    return conv2d_same(x, w.permute(2, 0, 1).unsqueeze(1), stride,
                       groups=x.shape[-1])


class DepthwiseConv3x3(nn.Module):
    """Depthwise 3x3 layer holding its taps as ``weight`` ``[3, 3, C]`` in
    f32 (flax's ``[3, 3, 1, C]`` kernel without the unit axis). The taps are
    cast to the compute dtype before the conv, as flax's ``promote_dtype``
    does."""

    def __init__(self, features: int, stride: int = 1,
                 dtype: torch.dtype = torch.bfloat16, impl: str = "auto",
                 interpret: bool = False):
        super().__init__()
        self.stride, self.dtype = stride, dtype
        self.impl, self.interpret = impl, interpret
        self.weight = nn.Parameter(torch.empty(3, 3, features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return depthwise_conv3x3(x.to(self.dtype).contiguous(),
                                 self.weight.to(self.dtype).contiguous(),
                                 stride=self.stride, impl=self.impl,
                                 interpret=self.interpret)
