"""Model registry: :class:`ModelCfg` -> ``nn.Module`` (the port of
``ddw_tpu.models.registry``): ``mobilenet_v2``, ``small_cnn``,
``resnet18/34/50``, ``convnext_tiny/small`` and ``vit``, each registered
in ``MODEL_REGISTRY`` by :func:`register_model`.

A frozen random backbone is guarded as in ``ddw_tpu`` (``registry.py``):
``freeze_base=True`` without ``pretrained_path`` auto-unfreezes, with a
warning, unless ``allow_frozen_random`` keeps it frozen (also warned).
``lora_rank`` is taken by ViT only (the LM family builds through
:func:`ddw_tpu_torch.models.lm.build_lm`); without ``pretrained_path`` it
warns that the adapters sit over a random base.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Callable

from torch import nn

from ddw_tpu_torch.utils.config import ModelCfg
from ddw_tpu_torch.utils.device import torch_dtype

MODEL_REGISTRY: dict[str, Callable] = {}


def register_model(name: str):
    """Register ``fn(cfg, image_size) -> nn.Module`` under ``name`` (the
    port's factories also take the image size, which sizes ViT's position
    embedding)."""
    def deco(fn):
        MODEL_REGISTRY[name] = fn
        return fn
    return deco


@register_model("small_cnn")
def _small_cnn(cfg: ModelCfg, image_size: tuple[int, int]) -> nn.Module:
    from ddw_tpu_torch.models.cnn import SmallCNN

    return SmallCNN(num_classes=cfg.num_classes, dropout=cfg.dropout,
                    dtype=torch_dtype(cfg.dtype))


@register_model("mobilenet_v2")
def _mobilenet_v2(cfg: ModelCfg, image_size: tuple[int, int]) -> nn.Module:
    from ddw_tpu_torch.models.mobilenet_v2 import MobileNetV2

    return MobileNetV2(num_classes=cfg.num_classes,
                       width_mult=cfg.width_mult,
                       dtype=torch_dtype(cfg.dtype), dw_impl=cfg.dw_impl,
                       dropout=cfg.dropout, freeze_base=cfg.freeze_base,
                       bn_momentum=cfg.bn_momentum, stem_s2d=cfg.stem_s2d)


def _resnet(cfg: ModelCfg, image_size: tuple[int, int]) -> nn.Module:
    from ddw_tpu_torch.models.resnet import ResNet

    return ResNet(num_classes=cfg.num_classes,
                  depth=int(cfg.name.removeprefix("resnet")),
                  width_mult=cfg.width_mult, dropout=cfg.dropout,
                  freeze_base=cfg.freeze_base, dtype=torch_dtype(cfg.dtype),
                  stem_s2d=cfg.stem_s2d)


def _convnext(cfg: ModelCfg, image_size: tuple[int, int]) -> nn.Module:
    from ddw_tpu_torch.models.convnext import ConvNeXt

    if cfg.dw_impl != "xla":
        # the repository's depthwise kernel is 3x3 only; ConvNeXt's 7x7
        # depthwise is a library grouped conv, so the knob would change
        # nothing
        raise ValueError(
            f"convnext ignores model.dw_impl={cfg.dw_impl!r}: its 7x7 "
            f"depthwise always runs the library's grouped convolution "
            f"(the depthwise kernel is 3x3-only — see "
            f"ddw_tpu_torch/ops/depthwise_conv.py); drop the setting or "
            f"use mobilenet_v2 for the kernel arm")
    return ConvNeXt(num_classes=cfg.num_classes,
                    variant=cfg.name.removeprefix("convnext_"),
                    width_mult=cfg.width_mult, dropout=cfg.dropout,
                    freeze_base=cfg.freeze_base, dtype=torch_dtype(cfg.dtype))


for _name in ("resnet18", "resnet34", "resnet50"):
    register_model(_name)(_resnet)
for _name in ("convnext_tiny", "convnext_small"):
    register_model(_name)(_convnext)


@register_model("vit")
def _vit(cfg: ModelCfg, image_size: tuple[int, int]) -> nn.Module:
    from ddw_tpu_torch.models.vit import ViT

    kwargs = {}
    if cfg.num_heads:
        kwargs["num_heads"] = cfg.num_heads
    if cfg.hidden:
        # mlp_dim keeps the default geometry's 4x ratio
        kwargs["hidden"] = cfg.hidden
        kwargs["mlp_dim"] = 4 * cfg.hidden
    return ViT(num_classes=cfg.num_classes, dropout=cfg.dropout,
               dtype=torch_dtype(cfg.dtype), lora_rank=cfg.lora_rank,
               lora_alpha=cfg.lora_alpha,
               lora_targets=tuple(cfg.lora_targets), image_size=image_size,
               **kwargs)


def build_model(cfg: ModelCfg,
                image_size: tuple[int, int] = (224, 224)) -> nn.Module:
    """Instantiate the module named by ``cfg.name`` (weights uninitialised:
    load them with :func:`ddw_tpu_torch.models.convert.load_flax_variables`
    or draw them with :func:`ddw_tpu_torch.models.layers.init_params`).
    ``image_size`` sizes ViT's position embedding (flax sizes it from the
    first input); the CNNs take any size."""
    if cfg.name not in MODEL_REGISTRY:
        raise KeyError(f"unknown model {cfg.name!r}; have "
                       f"{sorted(MODEL_REGISTRY)}")
    model = MODEL_REGISTRY[cfg.name](cfg, image_size)
    if cfg.lora_rank and not hasattr(model, "lora_rank"):
        # a silently ignored field would full-fine-tune while the user
        # believes adapters are training
        raise ValueError(f"{cfg.name!r} does not support LoRA "
                         f"(model.lora_rank); use the vit or LM families")
    if cfg.lora_rank and not cfg.pretrained_path:
        warnings.warn(
            f"{cfg.name}: lora_rank={cfg.lora_rank} with no pretrained_path "
            f"freezes a randomly initialized backbone under the adapters "
            f"(accuracy will stay near chance unless params are grafted "
            f"before training)", stacklevel=2)
    if (cfg.freeze_base and not cfg.pretrained_path
            and type(model).frozen_prefixes(True)):
        # A frozen *random* backbone trains only the head over noise
        # features; unless the caller opts into that, auto-unfreeze.
        if cfg.allow_frozen_random:
            warnings.warn(
                f"{cfg.name}: freeze_base=True with no pretrained_path freezes "
                f"a randomly initialized backbone (accuracy will stay near "
                f"chance); allow_frozen_random=True keeps it frozen anyway",
                stacklevel=2)
        else:
            warnings.warn(
                f"{cfg.name}: freeze_base=True needs model.pretrained_path (a "
                f"converted-weights artifact; see ddw_tpu_torch.models."
                f"convert) — auto-unfreezing the randomly initialized "
                f"backbone. Set model.allow_frozen_random=true to keep it "
                f"frozen.", stacklevel=2)
            model = MODEL_REGISTRY[cfg.name](
                dataclasses.replace(cfg, freeze_base=False), image_size)
    return model
