"""Export a MobileNetV2 backbone to the torchvision and Keras weight layouts
— the port of ``ddw_tpu.models.export``.

The exact inverse of the two import paths of
:mod:`ddw_tpu_torch.models.convert`, so the transfer contract can be shown
end to end without downloading weights: pretrain a backbone, export it in
the layouts pretrained artifacts ship in, convert it back and train a head
over it (``examples_torch/08_pretrained_transfer.py``). The round trip is
exact: ``convert_torch_mobilenet_v2(export_torch_mobilenet_v2(v)) == v`` up
to the BatchNorm epsilon fold, which both directions apply symmetrically.

- conv kernels: flax ``[kh, kw, in, out]`` -> torch ``[out, in, kh, kw]``
  (depthwise ``[kh, kw, 1, C]`` -> ``[C, 1, kh, kw]``); Keras keeps flax's
  layout for regular convs and ``[kh, kw, C, 1]`` for depthwise ones;
- BatchNorm: the scale carries MobileNetV2's epsilon (1e-3); exporting to
  torch (1e-5) inverts the fold ``scale' = scale * sqrt((var + eps_dst) /
  (var + eps_src))``. Keras shares the epsilon, so its fold is the identity.

Any ``width_mult`` exports: both layouts are positional by name, and the
converter's artifact is checked against the model's shapes on load.
"""

from __future__ import annotations

import numpy as np

from ddw_tpu_torch.models.convert import (_EPS_FLAX, _EPS_TORCH,
                                          _mobilenet_blocks,
                                          keras_mobilenet_stages,
                                          torch_mobilenet_pairs)


def _t(kernel: np.ndarray) -> np.ndarray:
    """flax conv kernel -> torch layout."""
    return np.asarray(kernel, np.float32).transpose(3, 2, 0, 1)


def _bn_out(sub_p: dict, sub_s: dict,
            eps_dst: float) -> tuple[np.ndarray, ...]:
    """(weight, bias, mean, var) with the epsilon fold inverted for
    ``eps_dst``."""
    var = np.asarray(sub_s["var"], np.float32)
    scale = np.asarray(sub_p["scale"], np.float32)
    scale = scale * np.sqrt((var + eps_dst) / (var + _EPS_FLAX))
    return (scale, np.asarray(sub_p["bias"], np.float32),
            np.asarray(sub_s["mean"], np.float32), var)


def export_torch_mobilenet_v2(backbone_vars: dict,
                              eps_dst: float = _EPS_TORCH
                              ) -> dict[str, np.ndarray]:
    """Backbone ``{"params", "batch_stats"}`` trees -> a torchvision-layout
    state_dict of numpy arrays (``torch.save`` it after ``torch.from_numpy``
    per value, or pass it to the converter as it is)."""
    params, stats = backbone_vars["params"], backbone_vars["batch_stats"]
    sd: dict[str, np.ndarray] = {}

    def put(conv_prefix: str, bn_prefix: str, p: dict, s: dict):
        sd[f"{conv_prefix}.weight"] = _t(p["Conv_0"]["kernel"])
        w, b, m, v = _bn_out(p["BatchNorm_0"], s["BatchNorm_0"], eps_dst)
        sd[f"{bn_prefix}.weight"] = w
        sd[f"{bn_prefix}.bias"] = b
        sd[f"{bn_prefix}.running_mean"] = m
        sd[f"{bn_prefix}.running_var"] = v
        sd[f"{bn_prefix}.num_batches_tracked"] = np.asarray(0, np.int64)

    put("features.0.0", "features.0.1", params["ConvBN_0"], stats["ConvBN_0"])
    for block, t in _mobilenet_blocks():
        p = params[f"InvertedResidual_{block}"]
        s = stats[f"InvertedResidual_{block}"]
        for i, (cp, bp) in enumerate(torch_mobilenet_pairs(block, t)):
            put(cp, bp, p[f"ConvBN_{i}"], s[f"ConvBN_{i}"])
    put("features.18.0", "features.18.1", params["ConvBN_1"], stats["ConvBN_1"])
    return sd


def export_keras_mobilenet_v2(backbone_vars: dict) -> dict[str, np.ndarray]:
    """Backbone trees -> a flat Keras-applications ``layer/weight`` dict
    (``np.savez`` it to feed :func:`~ddw_tpu_torch.models.convert.
    load_keras_weights`)."""
    params, stats = backbone_vars["params"], backbone_vars["batch_stats"]
    w: dict[str, np.ndarray] = {}

    def put(conv: str, bn: str, p: dict, s: dict, depthwise: bool):
        kernel = np.asarray(p["Conv_0"]["kernel"], np.float32)
        if depthwise:  # flax grouped [kh,kw,1,C] -> keras [kh,kw,C,1]
            w[f"{conv}/depthwise_kernel"] = kernel.transpose(0, 1, 3, 2)
        else:
            w[f"{conv}/kernel"] = kernel
        gamma, beta, mean, var = _bn_out(p["BatchNorm_0"], s["BatchNorm_0"],
                                         _EPS_FLAX)  # identity fold
        w[f"{bn}/gamma"] = gamma
        w[f"{bn}/beta"] = beta
        w[f"{bn}/moving_mean"] = mean
        w[f"{bn}/moving_variance"] = var

    put("Conv1", "bn_Conv1", params["ConvBN_0"], stats["ConvBN_0"], False)
    for block, t in _mobilenet_blocks():
        p = params[f"InvertedResidual_{block}"]
        s = stats[f"InvertedResidual_{block}"]
        for i, (conv, bn, dw) in enumerate(keras_mobilenet_stages(block, t)):
            put(conv, bn, p[f"ConvBN_{i}"], s[f"ConvBN_{i}"], dw)
    put("Conv_1", "Conv_1_bn", params["ConvBN_1"], stats["ConvBN_1"], False)
    return w
