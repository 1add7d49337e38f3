"""Weight-only int8 quantization for packaged models — the port's copy of
``ddw_tpu.serving.quantize`` (numpy only), so int8 packages load and save
identically in both packages.

Per output channel (the last axis), symmetric:

    scale[c] = max(|W[..., c]|) / 127
    Q[..., c] = round(W[..., c] / scale[c])    (int8)

Only floating leaves with ``ndim >= 2`` quantize; each becomes a
``{_Q8_VALUES, _Q8_SCALE}`` dict, restored by :func:`dequantize_tree`.
"""

from __future__ import annotations

import numpy as np

_Q8_VALUES = "__q8_values__"
_Q8_SCALE = "__q8_scale__"
MODE_INT8 = "int8_weight_only"


def _is_quantizable(leaf) -> bool:
    a = np.asarray(leaf)
    return a.ndim >= 2 and np.issubdtype(a.dtype, np.floating)


def quantize_tree(tree):
    """Per-output-channel symmetric int8 on every quantizable leaf."""
    if isinstance(tree, dict):
        if set(tree) == {_Q8_VALUES, _Q8_SCALE}:
            raise ValueError("tree is already quantized")
        return {k: quantize_tree(v) for k, v in tree.items()}
    if not _is_quantizable(tree):
        return np.asarray(tree)
    w = np.asarray(tree, np.float32)
    absmax = np.max(np.abs(w), axis=tuple(range(w.ndim - 1)), keepdims=True)
    scale = (absmax / 127.0).astype(np.float32)
    scale = np.where(scale == 0.0, np.float32(1.0), scale)  # all-zero channel
    q = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
    return {_Q8_VALUES: q,
            _Q8_SCALE: np.squeeze(scale, tuple(range(w.ndim - 1)))}


def dequantize_tree(tree):
    """Inverse of :func:`quantize_tree`: int8 leaves back to f32."""
    if isinstance(tree, dict):
        if set(tree) == {_Q8_VALUES, _Q8_SCALE}:
            q = np.asarray(tree[_Q8_VALUES])
            scale = np.asarray(tree[_Q8_SCALE])
            return q.astype(np.float32) * scale
        return {k: dequantize_tree(v) for k, v in tree.items()}
    return tree


def is_quantized_tree(tree) -> bool:
    """Whether any leaf of ``tree`` is a quantized ``{values, scale}``
    pair."""
    if isinstance(tree, dict):
        if set(tree) == {_Q8_VALUES, _Q8_SCALE}:
            return True
        return any(is_quantized_tree(v) for v in tree.values())
    return False
