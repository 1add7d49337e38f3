"""ddw_tpu_torch — the PyTorch/CUDA port of ddw_tpu for NVIDIA Hopper.

Mirrors ``ddw_tpu``'s layout module for module (the counterpart of
``ddw_tpu/x/y.py`` is ``ddw_tpu_torch/x/y.py``) and imports nothing of it, nor
of JAX: host logic it needs is kept here as its own copy. Every Pallas kernel
on a ported path becomes a hand-written CUDA kernel for ``sm_90a``
(``ddw_tpu_torch/ops/csrc``), with a plain PyTorch version beside it.

Ported so far: packaged-model serving of MobileNetV2 (``serving.package``,
``serving.batch``), with the stride-1 depthwise 3x3 layers on the CUDA kernel
``ops/csrc/depthwise_conv.cu``. What remains is listed in ``ROADMAP.md``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with no
CUDA device and no explicit CPU request they raise.
"""

from ddw_tpu_torch.utils.device import resolve_device, torch_dtype

__all__ = ["resolve_device", "torch_dtype"]
