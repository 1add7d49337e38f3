"""MobileNetV2 — the port of ``ddw_tpu.models.mobilenet_v2``.

The same architecture (Sandler et al. 2018: inverted residuals, linear
bottlenecks, ReLU6, widths rounded to multiples of 8) with the transfer head
GAP -> Dropout -> Dense, in eval and training mode (``module.train()``).
Activations are NHWC at every public
function, as in ``ddw_tpu``. Submodules carry flax's names
(``backbone.InvertedResidual_3.ConvBN_1.BatchNorm_0``, ``head``...), so
:mod:`ddw_tpu_torch.models.convert` maps a flax variables tree onto the module
mechanically.

Numerics follow the flax module step for step:

- the input is cast to the compute dtype; conv weights (depthwise taps
  included) are cast to it before each conv (flax ``promote_dtype``);
- BatchNorm runs in f32 with ``epsilon=1e-3``: on the running ``mean``/``var``
  in eval mode; in training mode on the batch statistics over ``(B, H, W)``
  with flax's fast variance ``E[x^2] - E[x]^2`` clipped at 0 (biased), and
  the running statistics updated in place as ``m*ra + (1-m)*batch`` with
  ``m = bn_momentum`` (flax's convention; torch's BatchNorm would use the
  unbiased variance and ``1-m``);
- head dropout draws its mask from an explicit ``torch.Generator``
  (``flax.linen.Dropout``'s keep-and-rescale); with ``freeze_base`` the
  backbone runs in eval mode and its features are detached, as
  ``stop_gradient`` does in ``ddw_tpu``;
- ReLU6 output is cast back to the compute dtype; the linear-bottleneck
  output stays f32, so the residual add is f32;
- GAP and the head run in f32;
- stride-2 convs pad with JAX's SAME split (``(0, 1)`` on even inputs);
  ``stem_s2d`` runs the stem through :mod:`ddw_tpu_torch.ops.s2d_conv`.

The conv, BatchNorm and dropout layers and the init rules are the shared
ones of :mod:`ddw_tpu_torch.models.layers`.

Stride-1 depthwise layers go through :func:`ddw_tpu_torch.ops.depthwise_conv.
depthwise_conv3x3` when ``dw_impl`` is "pallas" (the CUDA kernel on the card,
the plain version on the CPU) or "pallas_interpret" (the plain version); 1x1
convs, the stem and stride-2 depthwise layers are library convs, as they are
XLA convs in ``ddw_tpu``.
"""

from __future__ import annotations

import torch
from torch import nn

from ddw_tpu_torch.models.layers import BatchNorm, conv_or_s2d, dropout
from ddw_tpu_torch.ops.depthwise_conv import DepthwiseConv3x3

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


def _make_divisible(v: float, divisor: int = 8) -> int:
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class ConvBN(nn.Module):
    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 groups: int = 1, act: bool = True,
                 dtype: torch.dtype = torch.bfloat16, dw_impl: str = "xla",
                 bn_momentum: float = 0.9, s2d: bool = False):
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
            self.Conv_0 = conv_or_s2d(cin, cout, kernel, stride=stride,
                                      groups=groups, dtype=dtype, s2d=s2d)
        self.BatchNorm_0 = BatchNorm(cout, bn_momentum)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.BatchNorm_0(self.Conv_0(x))
        if self.act:
            x = x.clamp(0.0, 6.0).to(self.dtype)  # ReLU6
        return x


class InvertedResidual(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, stride: int, expand: int,
                 dtype: torch.dtype = torch.bfloat16, dw_impl: str = "xla",
                 bn_momentum: float = 0.9):
        super().__init__()
        hidden = in_ch * expand
        bn = bn_momentum
        layers = []
        if expand != 1:
            layers.append(ConvBN(in_ch, hidden, 1, dtype=dtype, bn_momentum=bn))
        layers.append(ConvBN(hidden, hidden, 3, stride, groups=hidden,
                             dtype=dtype, dw_impl=dw_impl, bn_momentum=bn))
        layers.append(ConvBN(hidden, out_ch, 1, act=False, dtype=dtype,
                             bn_momentum=bn))
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
                 dtype: torch.dtype = torch.bfloat16, dw_impl: str = "xla",
                 bn_momentum: float = 0.9, stem_s2d: bool = False):
        super().__init__()
        self.dtype = dtype
        bn = bn_momentum
        ch = _make_divisible(32 * width_mult)
        self.ConvBN_0 = ConvBN(3, ch, 3, stride=2, dtype=dtype, bn_momentum=bn,
                               s2d=stem_s2d)
        i = 0
        for t, c, n, s in _INVERTED_RESIDUAL_CFG:
            out_ch = _make_divisible(c * width_mult)
            for j in range(n):
                self.add_module(f"InvertedResidual_{i}", InvertedResidual(
                    ch, out_ch, s if j == 0 else 1, t, dtype, dw_impl, bn))
                ch, i = out_ch, i + 1
        self.out_features = _make_divisible(1280 * max(1.0, width_mult))
        self.ConvBN_1 = ConvBN(ch, self.out_features, 1, dtype=dtype,
                               bn_momentum=bn)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        for layer in self.children():
            x = layer(x)
        return x


class MobileNetV2(nn.Module):
    """Backbone + transfer head; ``forward`` takes NHWC images and returns
    f32 logits. Dropout is the identity in eval mode; in training mode it
    needs ``dropout_rng``. ``freeze_base`` is Keras's ``base_model.trainable
    = False``: the backbone's BatchNorm stays in inference mode and no
    gradient reaches the backbone (the trainer also excludes it from
    updates, :meth:`frozen_prefixes`)."""

    def __init__(self, num_classes: int = 5, width_mult: float = 1.0,
                 dtype: torch.dtype = torch.bfloat16, dw_impl: str = "xla",
                 dropout: float = 0.5, freeze_base: bool = True,
                 bn_momentum: float = 0.9, stem_s2d: bool = False):
        super().__init__()
        self.dropout, self.freeze_base = dropout, freeze_base
        self.backbone = MobileNetV2Backbone(width_mult, dtype, dw_impl,
                                            bn_momentum, stem_s2d)
        self.head = nn.Linear(self.backbone.out_features, num_classes)

    def train(self, mode: bool = True) -> "MobileNetV2":
        super().train(mode)
        self.backbone.train(mode and not self.freeze_base)
        return self

    def forward(self, x: torch.Tensor,
                dropout_rng: torch.Generator | None = None) -> torch.Tensor:
        feats = self.backbone(x)
        if self.freeze_base:
            feats = feats.detach()
        h = feats.float().mean(dim=(1, 2))
        if self.training and self.dropout > 0.0:
            h = dropout(h, self.dropout, dropout_rng)
        return self.head(h)

    @staticmethod
    def frozen_prefixes(freeze_base: bool) -> tuple[str, ...]:
        """Top-level parameter names the optimizer must not update in
        transfer mode."""
        return ("backbone",) if freeze_base else ()
