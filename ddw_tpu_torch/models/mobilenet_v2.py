"""MobileNetV2 for inference — the port of ``ddw_tpu.models.mobilenet_v2``.

The same architecture (Sandler et al. 2018: inverted residuals, linear
bottlenecks, ReLU6, widths rounded to multiples of 8) with the transfer head
GAP -> Dropout -> Dense, eval path only. Activations are NHWC at every public
function, as in ``ddw_tpu``. Submodules carry flax's names
(``backbone.InvertedResidual_3.ConvBN_1.BatchNorm_0``, ``head``...), so
:mod:`ddw_tpu_torch.models.convert` maps a flax variables tree onto the module
mechanically.

Numerics follow the flax module step for step:

- the input is cast to the compute dtype; conv weights (depthwise taps
  included) are cast to it before each conv (flax ``promote_dtype``);
- BatchNorm runs in f32 on the running ``mean``/``var`` with ``epsilon=1e-3``;
- ReLU6 output is cast back to the compute dtype; the linear-bottleneck
  output stays f32, so the residual add is f32;
- GAP and the head run in f32;
- stride-2 convs pad with JAX's SAME split (``(0, 1)`` on even inputs).

Stride-1 depthwise layers go through :func:`ddw_tpu_torch.ops.depthwise_conv.
depthwise_conv3x3` when ``dw_impl`` is "pallas" (the CUDA kernel on the card,
the plain version on the CPU) or "pallas_interpret" (the plain version); 1x1
convs, the stem and stride-2 depthwise layers are library convs, as they are
XLA convs in ``ddw_tpu``.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ddw_tpu_torch.ops.depthwise_conv import DepthwiseConv3x3, conv2d_same

# (expansion t, out channels c, repeats n, stride s) — Sandler et al. Table 2.
_INVERTED_RESIDUAL_CFG = (
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
)
_DW_IMPLS = ("xla", "pallas", "pallas_interpret")
_BN_EPS = 1e-3  # Keras's value, so converted pretrained weights reproduce


def _make_divisible(v: float, divisor: int = 8) -> int:
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class Conv(nn.Module):
    """Bias-free convolution with SAME padding; ``weight`` is
    ``[out, in/groups, kh, kw]`` in f32, cast to ``dtype`` for the conv."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 groups: int = 1, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.stride, self.groups, self.dtype = stride, groups, dtype
        self.weight = nn.Parameter(
            torch.empty(cout, cin // groups, kernel, kernel))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d_same(x.to(self.dtype), self.weight.to(self.dtype),
                           self.stride, self.groups)


class BatchNorm(nn.Module):
    """Inference BatchNorm in f32: flax's ``(x - mean) * (rsqrt(var + eps) *
    scale) + bias`` over the last (channel) axis."""

    def __init__(self, features: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mul = torch.rsqrt(self.var + _BN_EPS) * self.scale
        return (x.float() - self.mean) * mul + self.bias


class ConvBN(nn.Module):
    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 groups: int = 1, act: bool = True,
                 dtype: torch.dtype = torch.bfloat16, dw_impl: str = "xla"):
        super().__init__()
        if dw_impl not in _DW_IMPLS:
            raise ValueError(f"unknown dw_impl {dw_impl!r}")
        self.act, self.dtype = act, dtype
        if groups > 1 and groups == cin and kernel == 3:
            self.Conv_0 = DepthwiseConv3x3(
                cout, stride, dtype,
                impl="xla" if dw_impl == "xla" else "auto",
                interpret=dw_impl == "pallas_interpret")
        else:
            self.Conv_0 = Conv(cin, cout, kernel, stride, groups, dtype)
        self.BatchNorm_0 = BatchNorm(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.BatchNorm_0(self.Conv_0(x))
        if self.act:
            x = x.clamp(0.0, 6.0).to(self.dtype)  # ReLU6
        return x


class InvertedResidual(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, stride: int, expand: int,
                 dtype: torch.dtype = torch.bfloat16, dw_impl: str = "xla"):
        super().__init__()
        hidden = in_ch * expand
        layers = []
        if expand != 1:
            layers.append(ConvBN(in_ch, hidden, 1, dtype=dtype))
        layers.append(ConvBN(hidden, hidden, 3, stride, groups=hidden,
                             dtype=dtype, dw_impl=dw_impl))
        layers.append(ConvBN(hidden, out_ch, 1, act=False, dtype=dtype))
        for i, layer in enumerate(layers):  # flax's creation-order names
            self.add_module(f"ConvBN_{i}", layer)
        self.residual = stride == 1 and in_ch == out_ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for layer in self.children():
            h = layer(h)
        return h + x if self.residual else h


class MobileNetV2Backbone(nn.Module):
    def __init__(self, width_mult: float = 1.0,
                 dtype: torch.dtype = torch.bfloat16, dw_impl: str = "xla"):
        super().__init__()
        self.dtype = dtype
        ch = _make_divisible(32 * width_mult)
        self.ConvBN_0 = ConvBN(3, ch, 3, stride=2, dtype=dtype)
        i = 0
        for t, c, n, s in _INVERTED_RESIDUAL_CFG:
            out_ch = _make_divisible(c * width_mult)
            for j in range(n):
                self.add_module(f"InvertedResidual_{i}", InvertedResidual(
                    ch, out_ch, s if j == 0 else 1, t, dtype, dw_impl))
                ch, i = out_ch, i + 1
        self.out_features = _make_divisible(1280 * max(1.0, width_mult))
        self.ConvBN_1 = ConvBN(ch, self.out_features, 1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        for layer in self.children():
            x = layer(x)
        return x


class MobileNetV2(nn.Module):
    """Backbone + transfer head; ``forward`` takes NHWC images and returns
    f32 logits. Dropout is the identity at inference."""

    def __init__(self, num_classes: int = 5, width_mult: float = 1.0,
                 dtype: torch.dtype = torch.bfloat16, dw_impl: str = "xla"):
        super().__init__()
        self.backbone = MobileNetV2Backbone(width_mult, dtype, dw_impl)
        self.head = nn.Linear(self.backbone.out_features, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feats = self.backbone(x)
        return self.head(feats.float().mean(dim=(1, 2)))


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Random weights from ``generator``: conv and dense kernels normal with
    variance 1/fan_in (flax's LeCun scale), BatchNorm scale/bias and running
    statistics drawn around their identity values so that every layer does
    non-trivial work. The numbers differ from flax's for the same seed; tests
    that compare the two packages carry weights across instead."""
    def normal(shape, std, mean=0.0):
        return torch.randn(shape, generator=generator) * std + mean

    for mod in model.modules():
        if isinstance(mod, (Conv, DepthwiseConv3x3, nn.Linear)):
            w = mod.weight
            if isinstance(mod, Conv):
                fan_in = math.prod(w.shape[1:])
            elif isinstance(mod, DepthwiseConv3x3):
                fan_in = 9
            else:
                fan_in = w.shape[1]
            w.copy_(normal(w.shape, fan_in ** -0.5))
            if isinstance(mod, nn.Linear):
                mod.bias.zero_()
        elif isinstance(mod, BatchNorm):
            c = mod.scale.shape
            mod.scale.copy_(normal(c, 0.1, 1.0))
            mod.bias.copy_(normal(c, 0.1))
            mod.mean.copy_(normal(c, 0.1))
            mod.var.copy_(torch.rand(c, generator=generator) + 0.5)
