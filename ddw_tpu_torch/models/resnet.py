"""ResNet (v1.5) — the port of ``ddw_tpu.models.resnet``: depths 18, 34 and
50, with the zoo's transfer head (GAP -> Dropout -> Dense).

Submodules carry flax's names (``backbone.stem``, ``backbone.stage{s}_block
{i}._ConvBN_{j}`` / ``.proj``, each ``Conv_0`` + ``BatchNorm_0``, and
``head``), so :mod:`ddw_tpu_torch.models.convert` maps ``ddw_tpu``'s
variables onto the module leaf for leaf. Activations are NHWC.

Numerics follow the flax module: convs in the compute dtype with JAX's SAME
padding (the 7x7 stride-2 stem pads (2, 3) on 224, not torch's (3, 3));
BatchNorm in f32 with epsilon 1e-5 (torch's, not MobileNetV2's 1e-3) and
flax's momentum convention (:class:`~ddw_tpu_torch.models.mobilenet_v2.
BatchNorm`); ReLU on the f32 output, so a block's residual sum is f32; the
3x3 stride-2 max pool pads with -inf on JAX's SAME split ((0, 1) on even
sizes) by an explicit ``F.pad``. v1.5: a bottleneck strides its 3x3 conv.
``stem_s2d`` runs the stem through :mod:`ddw_tpu_torch.ops.s2d_conv`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ddw_tpu_torch.models.layers import BatchNorm, conv_or_s2d, dropout
from ddw_tpu_torch.ops.depthwise_conv import same_pads

# depth -> (block counts per stage, bottleneck?)
_CONFIGS = {
    18: ((2, 2, 2, 2), False),
    34: ((3, 4, 6, 3), False),
    50: ((3, 4, 6, 3), True),
}
_BN_EPS = 1e-5


class _ConvBN(nn.Module):
    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 act: bool = True, dtype: torch.dtype = torch.bfloat16,
                 s2d: bool = False):
        super().__init__()
        self.act = act
        self.Conv_0 = conv_or_s2d(cin, cout, kernel, stride=stride,
                                  dtype=dtype, s2d=s2d)
        self.BatchNorm_0 = BatchNorm(cout, 0.9, _BN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.BatchNorm_0(self.Conv_0(x))
        return F.relu(x) if self.act else x


class BasicBlock(nn.Module):
    def __init__(self, cin: int, features: int, stride: int = 1,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self._ConvBN_0 = _ConvBN(cin, features, stride=stride, dtype=dtype)
        self._ConvBN_1 = _ConvBN(features, features, act=False, dtype=dtype)
        self.proj = (_ConvBN(cin, features, 1, stride, act=False, dtype=dtype)
                     if cin != features or stride != 1 else None)
        self.out_features = features

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self._ConvBN_1(self._ConvBN_0(x))
        if self.proj is not None:
            x = self.proj(x)
        return F.relu(x + h)


class BottleneckBlock(nn.Module):
    def __init__(self, cin: int, features: int, stride: int = 1,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        out = features * 4
        self._ConvBN_0 = _ConvBN(cin, features, 1, dtype=dtype)
        self._ConvBN_1 = _ConvBN(features, features, stride=stride,
                                 dtype=dtype)  # v1.5: stride on the 3x3
        self._ConvBN_2 = _ConvBN(features, out, 1, act=False, dtype=dtype)
        self.proj = (_ConvBN(cin, out, 1, stride, act=False, dtype=dtype)
                     if cin != out or stride != 1 else None)
        self.out_features = out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self._ConvBN_2(self._ConvBN_1(self._ConvBN_0(x)))
        if self.proj is not None:
            x = self.proj(x)
        return F.relu(x + h)


def max_pool_same(x: torch.Tensor, k: int = 3, s: int = 2) -> torch.Tensor:
    """flax ``nn.max_pool(x, (k, k), (s, s), padding="SAME")`` on NHWC:
    -inf on JAX's SAME split, then an unpadded pool."""
    ph, pw = same_pads(x.shape[1], k, s), same_pads(x.shape[2], k, s)
    x = F.pad(x, (0, 0, *pw, *ph), value=float("-inf"))
    y = F.max_pool2d(x.permute(0, 3, 1, 2), k, s)
    return y.permute(0, 2, 3, 1).contiguous()


class ResNetBackbone(nn.Module):
    def __init__(self, depth: int = 50, width_mult: float = 1.0,
                 dtype: torch.dtype = torch.bfloat16, stem_s2d: bool = False):
        super().__init__()
        if depth not in _CONFIGS:
            raise KeyError(f"unsupported resnet depth {depth} (have "
                           f"{sorted(_CONFIGS)})")
        counts, bottleneck = _CONFIGS[depth]
        block = BottleneckBlock if bottleneck else BasicBlock
        width = int(64 * width_mult)
        self.stem = _ConvBN(3, width, 7, 2, dtype=dtype, s2d=stem_s2d)
        ch = width
        for stage, n_blocks in enumerate(counts):
            feats = width * 2 ** stage
            for i in range(n_blocks):
                b = block(ch, feats, 2 if (stage > 0 and i == 0) else 1,
                          dtype)
                self.add_module(f"stage{stage}_block{i}", b)
                ch = b.out_features
        self.out_features = ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = max_pool_same(self.stem(x))
        for name, layer in self.named_children():
            if name != "stem":
                x = layer(x)
        return x


class ResNet(nn.Module):
    """Backbone + transfer head; NHWC images in, f32 logits out. Dropout
    needs ``dropout_rng`` in training mode; ``freeze_base`` keeps the
    backbone in inference mode with no gradient (:meth:`frozen_prefixes`)."""

    def __init__(self, num_classes: int = 5, depth: int = 50,
                 width_mult: float = 1.0, dropout: float = 0.5,
                 freeze_base: bool = False,
                 dtype: torch.dtype = torch.bfloat16, stem_s2d: bool = False):
        super().__init__()
        self.dtype, self.dropout, self.freeze_base = dtype, dropout, freeze_base
        self.depth, self.width_mult = depth, width_mult
        self.backbone = ResNetBackbone(depth, width_mult, dtype, stem_s2d)
        self.head = nn.Linear(self.backbone.out_features, num_classes)

    def train(self, mode: bool = True) -> "ResNet":
        super().train(mode)
        self.backbone.train(mode and not self.freeze_base)
        return self

    def forward(self, x: torch.Tensor,
                dropout_rng: torch.Generator | None = None) -> torch.Tensor:
        feats = self.backbone(x.to(self.dtype))
        if self.freeze_base:
            feats = feats.detach()
        h = feats.float().mean(dim=(1, 2))
        if self.training and self.dropout > 0.0:
            h = dropout(h, self.dropout, dropout_rng)
        return self.head(h)

    @staticmethod
    def frozen_prefixes(freeze_base: bool) -> tuple[str, ...]:
        return ("backbone",) if freeze_base else ()
