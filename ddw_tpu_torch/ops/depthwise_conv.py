"""Depthwise 3x3 convolution, NHWC — the port of ``ddw_tpu.ops.depthwise_conv``.

Implementations of the same SAME-padded function and its gradients:

- :func:`depthwise_conv3x3_cuda` launches the hand-written kernel K1 of
  ``csrc/depthwise_conv.cu`` (stride 1). It replaces the Pallas kernel
  ``ddw_tpu/ops/depthwise_conv.py`` ``_fwd_kernel`` / ``_pallas_fwd``. Like
  that kernel it is bound by memory — about 9 multiply-adds per element read,
  one read of x and one write of y — so its least time on an H100 SXM is
  ``(2*B*H*W*C + 9*C) * bytes / 3.35 TB/s``. One thread computes a few
  adjacent channels of a column of four output pixels with the channel
  innermost (coalesced 16-byte loads, each input row loaded once for the
  three output rows it feeds), taps at the border are skipped by bounds
  checks and a grid-stride loop covers the tensor (design notes in the
  source).
- :func:`depthwise_conv3x3_wgrad_cuda` launches K2, the weight gradient,
  which replaces ``_dw_kernel`` / ``_pallas_dw``: a deterministic two-pass
  reduction (per-tile f32 partials, then a sum in fixed order), no atomics.
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

import torch
import torch.nn.functional as F
from torch import nn

_KERNEL_DTYPES = {torch.float32: (0, 4), torch.bfloat16: (1, 8)}  # code, vec


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


def depthwise_conv3x3_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K1: stride 1, f32 accumulation in dy-major
    then dx order, each product and sum rounded on its own, cast to the input
    dtype."""
    acc_dtype = _acc_dtype(x.dtype)
    xf, wf = x.to(acc_dtype), w.to(acc_dtype)
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


@functools.cache
def _kernel_lib() -> ctypes.CDLL:
    from ddw_tpu_torch.ops import _build

    lib = _build.load("depthwise_conv.cu")
    lib.ddw_dw3x3_fwd.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 \
        + [ctypes.c_void_p]
    lib.ddw_dw3x3_fwd.restype = ctypes.c_int
    lib.ddw_dw3x3_wgrad.argtypes = [ctypes.c_void_p] * 4 \
        + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.ddw_dw3x3_wgrad.restype = ctypes.c_int
    lib.ddw_dw3x3_wgrad_workspace.argtypes = [ctypes.c_int] * 4
    lib.ddw_dw3x3_wgrad_workspace.restype = ctypes.c_longlong
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
    """Dtype code and channels per thread: 16-byte vectors when C and every
    pointer allow, else one channel."""
    code, vec = _KERNEL_DTYPES[x.dtype]
    if x.shape[-1] % vec or any(t.data_ptr() % 16 for t in (x, *others)):
        vec = 1
    return code, vec


def depthwise_conv3x3_cuda(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Launch K1 (stride 1) on the current stream, without synchronising.
    ``x`` is an NHWC-contiguous CUDA tensor in float32 or bfloat16, ``w`` the
    contiguous ``[3, 3, C]`` taps in the same dtype. Raises on anything else;
    never falls back."""
    _check_kernel_input(x, w, "w", (3, 3, x.shape[-1]))
    b, h, wd, c = x.shape
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y
    code, vec = _vec(x, w)
    lib = _kernel_lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ddw_dw3x3_fwd(x.data_ptr(), w.data_ptr(), y.data_ptr(),
                                b, h, wd, c, code, vec, stream)
    if err != 0:
        raise RuntimeError(f"depthwise 3x3 kernel launch failed: CUDA error "
                           f"{err}")
    depthwise_conv3x3_cuda.launches += 1
    return y


depthwise_conv3x3_cuda.launches = 0


def depthwise_conv3x3_wgrad_cuda(x: torch.Tensor,
                                 g: torch.Tensor) -> torch.Tensor:
    """Launch K2 on the current stream, without synchronising: the f32
    ``[3, 3, C]`` weight gradient from ``x`` and the output gradient ``g``,
    both NHWC-contiguous CUDA tensors of one shape in float32 or bfloat16.
    Raises on anything else; never falls back. Deterministic: two launches
    on the same input give the same bits."""
    _check_kernel_input(x, g, "g", tuple(x.shape))
    b, h, wd, c = x.shape
    dw = torch.empty(3, 3, c, dtype=torch.float32, device=x.device)
    if x.numel() == 0:
        return dw.zero_()
    code, vec = _vec(x, g)
    lib = _kernel_lib()
    part = torch.empty(lib.ddw_dw3x3_wgrad_workspace(b, h, wd, c),
                       dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ddw_dw3x3_wgrad(x.data_ptr(), g.data_ptr(), part.data_ptr(),
                                  dw.data_ptr(), b, h, wd, c, code, vec,
                                  stream)
    if err != 0:
        raise RuntimeError(f"depthwise 3x3 weight-gradient kernel launch "
                           f"failed: CUDA error {err}")
    depthwise_conv3x3_wgrad_cuda.launches += 1
    return dw


depthwise_conv3x3_wgrad_cuda.launches = 0


class DepthwiseKernelFn(torch.autograd.Function):
    """The stride-1 kernel path with its backward (``_depthwise_pallas``'s
    custom VJP): forward K1; backward ``dx = K1(g, w flipped in both spatial
    axes)`` and ``dw = K2(x, g)`` cast to the tap dtype (``_vjp_bwd``, which
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
            dx = fwd(g, w.flip(0, 1).contiguous())
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
