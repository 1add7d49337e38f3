"""Depthwise 3x3 convolution, NHWC — the port of ``ddw_tpu.ops.depthwise_conv``.

Three implementations of the same SAME-padded function:

- :func:`depthwise_conv3x3_cuda` launches the hand-written kernel
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
- :func:`depthwise_conv3x3_plain`, the plain PyTorch version: nine shifted
  multiply-adds in f32 over ``F.pad``, in the kernel's order. The CPU path and
  the reference the kernel is held against.
- :func:`conv2d_same` with ``groups=C``, the library grouped convolution, for
  stride 2 (the flipped-tap trick and the kernel are stride-1 only) and for
  ``dw_impl="xla"``.

:func:`depthwise_conv3x3` dispatches: stride 1 goes to the kernel for a CUDA
tensor and to the plain version for a CPU tensor; stride 2 goes to the
library conv, as ``impl="auto"`` does in ``ddw_tpu``. The backward kernels
(input and weight gradients) come with the training slice.
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


def depthwise_conv3x3_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: stride 1, f32 accumulation in
    dy-major then dx order, each product and sum rounded on its own, cast to
    the input dtype."""
    xf, wf = x.float(), w.float()
    _, h, wd, _ = x.shape
    xp = F.pad(xf, (0, 0, 1, 1, 1, 1))
    acc = torch.zeros_like(xf)
    for dy in range(3):
        for dx in range(3):
            acc += xp[:, dy:dy + h, dx:dx + wd, :] * wf[dy, dx]
    return acc.to(x.dtype)


@functools.cache
def _kernel_lib() -> ctypes.CDLL:
    from ddw_tpu_torch.ops import _build

    lib = _build.load("depthwise_conv.cu")
    lib.ddw_dw3x3_fwd.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 \
        + [ctypes.c_void_p]
    lib.ddw_dw3x3_fwd.restype = ctypes.c_int
    return lib


def depthwise_conv3x3_cuda(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel (stride 1) on the current stream, without
    synchronising. ``x`` is an NHWC-contiguous CUDA tensor in float32 or
    bfloat16, ``w`` the contiguous ``[3, 3, C]`` taps in the same dtype.
    Raises on anything else; never falls back."""
    if not (x.is_cuda and w.is_cuda and x.device == w.device):
        raise ValueError(f"the depthwise kernel needs x and w on one CUDA "
                         f"device, got {x.device} and {w.device}")
    if x.dtype not in _KERNEL_DTYPES or w.dtype != x.dtype:
        raise ValueError(f"the depthwise kernel takes float32 or bfloat16 x "
                         f"and w of the same dtype, got {x.dtype}, {w.dtype}")
    if x.dim() != 4 or tuple(w.shape) != (3, 3, x.shape[-1]):
        raise ValueError(f"need x [B, H, W, C] and w [3, 3, C], got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("the depthwise kernel needs NHWC-contiguous x and "
                         "contiguous w")
    b, h, wd, c = x.shape
    if x.numel() >= 1 << 30:
        raise ValueError(f"x has {x.numel()} elements; the kernel indexes "
                         f"with 32-bit integers (fewer than 2**30)")
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y
    code, vec = _KERNEL_DTYPES[x.dtype]
    if c % vec or x.data_ptr() % 16 or w.data_ptr() % 16:
        vec = 1
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


def depthwise_conv3x3(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
                      impl: str = "auto",
                      interpret: bool = False) -> torch.Tensor:
    """SAME depthwise 3x3 conv, NHWC; ``w`` is ``[3, 3, C]``.

    ``impl``: "auto" (the kernel path at stride 1, the library conv at stride
    2), "pallas" (the kernel path; stride 1 only) or "xla" (the library
    conv). On the kernel path a CUDA tensor launches the CUDA kernel and a
    CPU tensor runs the plain version; ``interpret=True`` runs the plain
    version on any device (the role of the Pallas interpreter in
    ``ddw_tpu``'s tests)."""
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
        if interpret or x.device.type == "cpu":
            return depthwise_conv3x3_plain(x, w)
        return depthwise_conv3x3_cuda(x, w)
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
