"""Space-to-depth stem convolution — the port of ``ddw_tpu.ops.s2d_conv`` in
plain PyTorch (no kernel of its own: it is a rearrangement around one
library convolution).

A stride-2 SAME convolution is the same arithmetic as a stride-1
convolution over the 2x2 space-to-depth rearrangement of its input, with the
kernel's taps folded the same way:

    y[o] = sum_t  K[t] * x[2o + t - before]              (stride 2, taps t)
         = sum_{m,d} K[2m+d ...] * x_s2d[o+m, phase d]   (stride 1, phases)

The kernel is zero-padded to an even size, aligned so that every tap lands
on a whole (phase, offset) pair, then folded ``[K,K,C,F] -> [K/2,K/2,4C,F]``
to match the input's ``[B,H,W,C] -> [B,H/2,W/2,4C]``. The parameters are the
plain convolution's, so checkpoints and converters do not change; a 3-channel
stem contracts over 4x as many channels per tap. The stem layer that holds
the parameter is :class:`ddw_tpu_torch.models.layers.S2DConv`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def space_to_depth_conv(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Stride-2 SAME convolution of NHWC ``x`` with the HWIO ``kernel``
    (``ddw_tpu``'s layouts), through a 2x2 space-to-depth rearrangement: the
    same products as ``conv2d_same(x, w, stride=2)``, summed in another
    order. Needs an odd square kernel and even spatial dims (the stems)."""
    b, h, w, c = x.shape
    kh, kw, cin, cout = kernel.shape
    if kh != kw or kh % 2 == 0:
        raise ValueError(f"space_to_depth_conv needs an odd square kernel, "
                         f"got {kh}x{kw}")
    if h % 2 or w % 2:
        raise ValueError(f"space_to_depth_conv needs even spatial dims, got "
                         f"{h}x{w}")
    if cin != c:
        raise ValueError(f"kernel expects {cin} input channels, input has "
                         f"{c}")
    k = kh
    # JAX's SAME for stride 2 on even input: total pad k - 2, low side first
    before = (k - 2) // 2
    tl = before % 2            # pad the kernel top-left when `before` is odd,
    br = (k + tl) % 2          # then bottom-right to the next even size
    kpad = F.pad(kernel, (0, 0, 0, 0, tl, br, tl, br))
    ke = k + tl + br
    kfold = kpad.reshape(ke // 2, 2, ke // 2, 2, cin, cout)
    kfold = kfold.permute(0, 2, 1, 3, 4, 5).reshape(ke // 2, ke // 2,
                                                    4 * cin, cout)
    xs = x.reshape(b, h // 2, 2, w // 2, 2, c)
    xs = xs.permute(0, 1, 3, 2, 4, 5).reshape(b, h // 2, w // 2, 4 * c)
    pad_lo = (before + 1) // 2
    pad_hi = (k - 1 - before) // 2
    xs = F.pad(xs, (0, 0, pad_lo, pad_hi, pad_lo, pad_hi))
    y = F.conv2d(xs.permute(0, 3, 1, 2), kfold.permute(3, 2, 0, 1))
    return y.permute(0, 2, 3, 1).contiguous()
