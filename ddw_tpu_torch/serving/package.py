"""Packaged-model format — the port of ``ddw_tpu.serving.package`` (the
MLflow pyfunc role).

The directory format is ``ddw_tpu``'s, unchanged, so a package written by
either package loads in the other:

    package.json     kind, format_version, model_cfg, classes, image size,
                     preprocess_impl (+ quantization for int8 packages)
    params.msgpack   ``{"params": ..., "batch_stats": ...}`` flax variables
                     in flax's msgpack encoding (``serving/_msgpack.py``)

:class:`PackagedModel` restores it onto a device and predicts from encoded
image bytes, file paths or decoded float arrays, in fixed sub-batches of 128
padded with zeros, under ``torch.inference_mode()``; ``engine_handle()``
is what the online ``ServingEngine``'s image lane serves.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import warnings
from typing import Sequence

import numpy as np
import torch

from ddw_tpu_torch.data.loader import active_decoder, preprocess_image
from ddw_tpu_torch.models.convert import load_flax_variables
from ddw_tpu_torch.models.registry import build_model
from ddw_tpu_torch.serving import _msgpack
from ddw_tpu_torch.utils.config import ModelCfg
from ddw_tpu_torch.utils.device import resolve_device

_FORMAT_VERSION = 1
# Version 2 == version 1 + int8-quantized params blob, so readers that
# predate quantization reject it at the version gate.
_FORMAT_VERSION_QUANT = 2
_SUPPORTED_VERSIONS = (1, 2)
_PREDICT_BATCH = 128  # reference :64


def write_package_dir(out_dir: str, meta: dict, tree, quantize: str | None,
                      quant_version: int) -> str:
    """Quantization gate, ``package.json``, ``params.msgpack``. ``meta``
    carries ``kind``/``format_version``; int8 rewrites ``format_version`` to
    ``quant_version``."""
    if quantize not in (None, "int8"):
        raise ValueError(f"unknown quantize mode {quantize!r}; use 'int8'")
    os.makedirs(out_dir, exist_ok=True)
    if quantize == "int8":
        from ddw_tpu_torch.serving.quantize import MODE_INT8, quantize_tree

        meta = dict(meta, quantization=MODE_INT8, format_version=quant_version)
        tree = quantize_tree(tree)
    with open(os.path.join(out_dir, "package.json"), "w") as f:
        json.dump(meta, f, indent=2)
    with open(os.path.join(out_dir, "params.msgpack"), "wb") as f:
        f.write(_msgpack.packb(tree))
    return out_dir


def read_package_dir(model_dir: str, expected_kind: str,
                     supported_versions: tuple,
                     other_kind_hint: str) -> tuple[dict, dict, str]:
    """Kind/version gates, sha256 content digest over blob + meta (the same
    digest ``ddw_tpu`` computes), msgpack restore, transparent dequantize.
    Returns ``(meta, restored_tree, content_digest)``."""
    with open(os.path.join(model_dir, "package.json")) as f:
        meta = json.load(f)
    kind = meta.get("kind", "image")
    if kind != expected_kind:
        raise ValueError(f"not an {expected_kind} package (kind={kind!r}); "
                         f"{other_kind_hint}")
    if meta["format_version"] not in supported_versions:
        raise ValueError(
            f"unsupported package format {meta['format_version']}")
    with open(os.path.join(model_dir, "params.msgpack"), "rb") as f:
        blob = f.read()
    h = hashlib.sha256(blob)
    h.update(json.dumps(meta, sort_keys=True).encode())
    restored = _msgpack.unpackb(blob)
    quant = meta.get("quantization")
    if quant is not None:
        from ddw_tpu_torch.serving.quantize import MODE_INT8, dequantize_tree

        if quant != MODE_INT8:
            raise ValueError(f"unsupported quantization mode {quant!r}")
        restored = dequantize_tree(restored)
    return meta, restored, h.hexdigest()[:16]


def save_packaged_model(
    out_dir: str,
    model_cfg: ModelCfg,
    classes: Sequence[str],
    params,
    batch_stats=None,
    img_height: int = 224,
    img_width: int = 224,
    extra_meta: dict | None = None,
    quantize: str | None = None,
) -> str:
    """Write the packaged-model directory. ``params``/``batch_stats`` are
    flax-layout trees of numpy arrays (``to_flax_variables(model)`` gives
    them for a port module); ``classes`` must be index-ordered."""
    reserved = {"kind", "format_version", "model_cfg", "classes",
                "quantization", "img_height", "img_width", "preprocess_impl"}
    clash = reserved & set(extra_meta or {})
    if clash:
        raise ValueError(f"extra_meta must not override reserved keys "
                         f"{sorted(clash)}")
    meta = {
        "kind": "image",
        "format_version": _FORMAT_VERSION,
        "model_cfg": dataclasses.asdict(model_cfg),
        "classes": list(classes),
        "img_height": img_height,
        "img_width": img_width,
        "preprocess_impl": active_decoder(),
        **(extra_meta or {}),
    }
    tree = {"params": params, "batch_stats": batch_stats or {}}
    return write_package_dir(out_dir, meta, tree, quantize,
                             _FORMAT_VERSION_QUANT)


def load_packaged_model(model_dir: str, device=None) -> "PackagedModel":
    """The package at ``model_dir`` as a :class:`PackagedModel` on
    ``device`` (the card unless the caller asks for the CPU)."""
    return PackagedModel(model_dir, device=device)


@dataclasses.dataclass
class ImageEngineHandle:
    """What :class:`ddw_tpu_torch.serve.engine.ServingEngine` needs from an
    image package: its forward and the input coercion it shares with
    :meth:`PackagedModel.predict` (same preprocessing, no offline/online
    skew). ``apply`` is the package's own forward with its ``dw_impl`` —
    with ``"pallas"`` every stride-1 depthwise layer launches K1."""

    model: object
    classes: list
    height: int
    width: int
    decode_one: object          # item -> [H, W, 3] float array
    apply: object               # [G, H, W, 3] f32 array -> [G, C] logits
    content_digest: str = ""
    device: torch.device | None = None


class PackagedModel:
    """Self-contained predictor (the ``FlowerPyFunc`` role) on one device.

    ``device=None`` means the CUDA card (raises without one); tests pass
    ``device="cpu"``. ``predict`` accepts a list of encoded image bytes, a
    list of file paths, or a decoded float array [N, H, W, 3] in [-1, 1], and
    returns class names (or indices with ``return_indices=True``).
    """

    def __init__(self, model_dir: str, device=None):
        self.device = resolve_device(device)
        # content_digest: identity of this packaged model (weights + meta).
        self.meta, restored, self.content_digest = read_package_dir(
            model_dir, "image", _SUPPORTED_VERSIONS,
            "LM packages load via ddw_tpu_torch.serving.lm_package."
            "LMPackagedModel")
        self.model_cfg = ModelCfg(**self.meta["model_cfg"])
        self.classes: list[str] = self.meta["classes"]
        self.height, self.width = self.meta["img_height"], self.meta["img_width"]
        trained_with = self.meta.get("preprocess_impl")
        if trained_with and trained_with != active_decoder():
            warnings.warn(
                f"packaged model was trained with the {trained_with!r} image "
                f"decoder but this environment resolves {active_decoder()!r}; "
                f"decoded pixels differ slightly (train/serve preprocessing "
                f"skew)", stacklevel=2)
        self.model = build_model(self.model_cfg, (self.height, self.width))
        load_flax_variables(self.model, {
            "params": restored["params"],
            "batch_stats": restored.get("batch_stats") or {}})
        self.model.to(self.device).eval()

    def engine_handle(self) -> ImageEngineHandle:
        return ImageEngineHandle(self.model, self.classes, self.height,
                                 self.width, self._decode_one, self._forward,
                                 self.content_digest, self.device)

    # -- input coercion (the reference's bytes-vs-str handling, :214-234) -----
    def _decode_one(self, item) -> np.ndarray:
        if isinstance(item, np.ndarray) and item.ndim == 3:
            return item.astype(np.float32)
        if isinstance(item, str):
            if os.path.exists(item):
                with open(item, "rb") as f:
                    item = f.read()
            else:
                # stringified bytes from a text serialization boundary
                import ast

                item = ast.literal_eval(item)
        if isinstance(item, (bytes, bytearray)):
            return preprocess_image(bytes(item), self.height, self.width)
        raise TypeError(f"cannot decode input of type {type(item)}")

    def _forward(self, chunk: np.ndarray) -> np.ndarray:
        with torch.inference_mode():
            x = torch.from_numpy(chunk).to(self.device)
            return self.model(x).cpu().numpy()

    def predict_logits(self, inputs) -> np.ndarray:
        if isinstance(inputs, np.ndarray) and inputs.ndim == 4:
            imgs = np.ascontiguousarray(inputs, np.float32)
        elif len(inputs) == 0:
            return np.zeros((0, len(self.classes)), np.float32)
        else:
            imgs = np.stack([self._decode_one(x) for x in inputs])
        outs = []
        # fixed sub-batch with padding: one shape for every N
        for i in range(0, len(imgs), _PREDICT_BATCH):
            chunk = imgs[i:i + _PREDICT_BATCH]
            pad = _PREDICT_BATCH - len(chunk)
            if pad:
                chunk = np.concatenate(
                    [chunk, np.zeros((pad, *chunk.shape[1:]), np.float32)])
            outs.append(self._forward(chunk)[:_PREDICT_BATCH - pad])
        return (np.concatenate(outs) if outs
                else np.zeros((0, len(self.classes)), np.float32))

    def predict(self, inputs, return_indices: bool = False):
        """argmax -> class name (reference ``:208-212``)."""
        idx = np.argmax(self.predict_logits(inputs), axis=-1)
        if return_indices:
            return idx
        return [self.classes[i] for i in idx]
