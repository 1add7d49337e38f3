"""ddw_tpu_torch — the PyTorch/CUDA port of ddw_tpu for NVIDIA Hopper.

Mirrors ``ddw_tpu``'s layout module for module (the counterpart of
``ddw_tpu/x/y.py`` is ``ddw_tpu_torch/x/y.py``) and imports nothing of it, nor
of JAX: host logic it needs is kept here as its own copy. Every Pallas kernel
on a ported path becomes a hand-written CUDA kernel for ``sm_90a``
(``ddw_tpu_torch/ops/csrc``), with a plain PyTorch version beside it.

The port does all that ``ddw_tpu`` does: every public name a ``ddw_tpu``
module defines is bound in its counterpart here, or, where the port answers
it differently, listed with its counterpart in ``tests/test_torch_names.py``,
which holds the two packages together name by name. Serving, training,
the collectives, multi-device parallelism, the fleet and the fault-tolerant
runtime all run on the card, with the depthwise (``depthwise_conv.cu``,
``depthwise_sm90.cu``), flash-attention (``flash_attention*.cu``,
``flash_fwd_sm90.cu``, ``flash_bwd_sm90.cu``) and ring all-reduce
(``ring_reduce.cu``) kernels.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with no
CUDA device and no explicit CPU request they raise.
"""

from ddw_tpu_torch.utils.device import resolve_device, torch_dtype

__all__ = ["resolve_device", "torch_dtype"]
