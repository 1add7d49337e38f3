"""Model registry: :class:`ModelCfg` -> ``nn.Module`` (the port of
``ddw_tpu.models.registry``). MobileNetV2 and SmallCNN are ported so far; the
other families of ``ddw_tpu`` raise, naming ``ROADMAP.md``.

A frozen random backbone is guarded as in ``ddw_tpu`` (``registry.py``):
``freeze_base=True`` without ``pretrained_path`` auto-unfreezes, with a
warning, unless ``allow_frozen_random`` keeps it frozen (also warned).
"""

from __future__ import annotations

import dataclasses
import warnings

from torch import nn

from ddw_tpu_torch.utils.config import ModelCfg
from ddw_tpu_torch.utils.device import torch_dtype

_NOT_YET_PORTED = ("resnet18", "resnet34", "resnet50",
                   "convnext_tiny", "convnext_small", "vit")


def build_model(cfg: ModelCfg) -> nn.Module:
    """Instantiate the module named by ``cfg.name`` (weights uninitialized:
    load them with :func:`ddw_tpu_torch.models.convert.load_flax_variables`
    or draw them with :func:`ddw_tpu_torch.models.mobilenet_v2.init_weights`)."""
    if cfg.name in _NOT_YET_PORTED:
        raise NotImplementedError(
            f"model {cfg.name!r} is not yet ported to ddw_tpu_torch; see "
            f"ROADMAP.md for the order of the remaining slices")
    if cfg.name not in ("mobilenet_v2", "small_cnn"):
        raise KeyError(f"unknown model {cfg.name!r}; have ['mobilenet_v2', "
                       f"'small_cnn']")
    if cfg.lora_rank:
        raise ValueError(f"{cfg.name!r} does not support LoRA "
                         f"(model.lora_rank); use the vit or LM families")
    if cfg.name == "small_cnn":
        from ddw_tpu_torch.models.cnn import SmallCNN

        return SmallCNN(num_classes=cfg.num_classes, dropout=cfg.dropout,
                        dtype=torch_dtype(cfg.dtype))
    if cfg.stem_s2d:
        raise NotImplementedError("model.stem_s2d is not yet ported to "
                                  "ddw_tpu_torch; see ROADMAP.md")
    from ddw_tpu_torch.models.mobilenet_v2 import MobileNetV2

    if (cfg.freeze_base and not cfg.pretrained_path
            and MobileNetV2.frozen_prefixes(True)):
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
                f"converted-weights artifact; see ddw_tpu.models.convert) — "
                f"auto-unfreezing the randomly initialized backbone. Set "
                f"model.allow_frozen_random=true to keep it frozen.",
                stacklevel=2)
            cfg = dataclasses.replace(cfg, freeze_base=False)
    return MobileNetV2(num_classes=cfg.num_classes, width_mult=cfg.width_mult,
                       dtype=torch_dtype(cfg.dtype), dw_impl=cfg.dw_impl,
                       dropout=cfg.dropout, freeze_base=cfg.freeze_base,
                       bn_momentum=cfg.bn_momentum)
