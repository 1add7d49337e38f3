"""The serving side of ``ddw_tpu.data.loader``: image preprocessing and the
``raw_u8`` scheme, as the port's own copy.

Preprocessing is one definition shared by everything that decodes an image
(decode -> bilinear resize -> ``x / 127.5 - 1``), the same arithmetic as
``ddw_tpu``'s PIL path. The native libjpeg pipeline is not yet ported; where
PIL is not importable, decoding raises and names the missing decoder. Tables
pre-decoded to ``raw_u8`` need no decoder at all.
"""

from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor
from io import BytesIO

import numpy as np


def bounded_map(pool: ThreadPoolExecutor, fn, iterable, window: int):
    """Ordered parallel map with at most ``window`` items in flight."""
    pending: deque = deque()
    for item in iterable:
        pending.append(pool.submit(fn, item))
        if len(pending) >= window:
            yield pending.popleft().result()
    while pending:
        yield pending.popleft().result()


def raw_u8_view(content: bytes, height: int, width: int) -> np.ndarray:
    """Reinterpret a ``raw_u8`` record as a [H, W, 3] uint8 array — a
    zero-copy view over the record bytes."""
    return np.frombuffer(content, np.uint8).reshape(height, width, 3)


def dequantize_raw_u8(batch: np.ndarray) -> None:
    """In place: a float batch holding uint8 pixel values becomes [-1, 1]
    (the inverse of ``ddw_tpu.data.prep.materialize_decoded``)."""
    batch /= 127.5
    batch -= 1.0


def _pil():
    try:
        from PIL import Image
    except ImportError:
        return None
    return Image


def active_decoder() -> str:
    """The decode implementation :func:`preprocess_image` uses here: ``pil``,
    or ``none`` where PIL is not importable. Packages record it at save time;
    loading warns when the serving side resolves differently."""
    return "pil" if _pil() is not None else "none"


def preprocess_image(content: bytes, height: int, width: int) -> np.ndarray:
    """Encoded image bytes -> float32 [H, W, 3] in [-1, 1]."""
    image = _pil()
    if image is None:
        raise RuntimeError(
            "decoding images needs PIL (Pillow), which is not importable "
            "here; the native libjpeg decoder is not yet ported. Score a "
            "pre-decoded raw_u8 table or pass decoded arrays instead")
    img = image.open(BytesIO(content))
    # JPEG DCT-scaled decode when the source is larger than the target.
    img.draft("RGB", (width, height))
    if img.mode != "RGB":
        img = img.convert("RGB")
    img = img.resize((width, height), image.BILINEAR)
    arr = np.asarray(img, dtype=np.float32)
    return arr / 127.5 - 1.0
