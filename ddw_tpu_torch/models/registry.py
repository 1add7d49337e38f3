"""Model registry: :class:`ModelCfg` -> ``nn.Module`` (the port of
``ddw_tpu.models.registry``). Only MobileNetV2 is ported so far; the other
families of ``ddw_tpu`` raise, naming ``ROADMAP.md``.

Training-time behaviour of the original (the frozen-random-backbone guard,
``freeze_base``) comes with the training slice: the eval output of a model
does not depend on it.
"""

from __future__ import annotations

from torch import nn

from ddw_tpu_torch.utils.config import ModelCfg
from ddw_tpu_torch.utils.device import torch_dtype

_NOT_YET_PORTED = ("small_cnn", "resnet18", "resnet34", "resnet50",
                   "convnext_tiny", "convnext_small", "vit")


def build_model(cfg: ModelCfg) -> nn.Module:
    """Instantiate the module named by ``cfg.name`` (weights uninitialized:
    load them with :func:`ddw_tpu_torch.models.convert.load_flax_variables`
    or draw them with :func:`ddw_tpu_torch.models.mobilenet_v2.init_weights`)."""
    if cfg.name in _NOT_YET_PORTED:
        raise NotImplementedError(
            f"model {cfg.name!r} is not yet ported to ddw_tpu_torch; see "
            f"ROADMAP.md for the order of the remaining slices")
    if cfg.name != "mobilenet_v2":
        raise KeyError(f"unknown model {cfg.name!r}; have ['mobilenet_v2']")
    if cfg.lora_rank:
        raise ValueError("'mobilenet_v2' does not support LoRA "
                         "(model.lora_rank); use the vit or LM families")
    if cfg.stem_s2d:
        raise NotImplementedError("model.stem_s2d is not yet ported to "
                                  "ddw_tpu_torch; see ROADMAP.md")
    from ddw_tpu_torch.models.mobilenet_v2 import MobileNetV2

    return MobileNetV2(num_classes=cfg.num_classes, width_mult=cfg.width_mult,
                       dtype=torch_dtype(cfg.dtype), dw_impl=cfg.dw_impl)
