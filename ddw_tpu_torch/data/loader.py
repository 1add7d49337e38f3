"""The port of ``ddw_tpu.data.loader``: image preprocessing, the ``raw_u8``
scheme, and the per-rank :class:`ShardedLoader` (the Petastorm role).

Preprocessing is one definition shared by everything that decodes an image
(decode -> bilinear resize -> ``x / 127.5 - 1``), dispatched as ``ddw_tpu``
dispatches it: the native libjpeg pipeline (:mod:`ddw_tpu_torch.native.
decode`, ``ddw_tpu``'s C++ source, so the same pixels bit for bit) where it
builds, else PIL (the same arithmetic as ``ddw_tpu``'s PIL path). Where
neither is available, decoding raises and names the missing decoder. Tables
pre-decoded to ``raw_u8`` need no decoder at all.

:class:`ShardedLoader` yields the same record stream and the same host
batches, byte for byte, as ``ddw_tpu``'s: the ``shard_plan`` round-robin,
record-stride sharding when there are fewer shards than workers, the seeded
epoch-varying shard shuffle and shuffle buffer (bounded to 64 MB on
``raw_u8``), infinite repeat, ``skip_records``. With ``prefetch_to`` a device,
a background thread copies each batch from pinned host memory on its own
CUDA stream (``non_blocking``) and records an event the consumer's stream
waits on; ``raw_u8`` batches cross as uint8 and are dequantized on the
device. Token tables (``tokens_i32``, :func:`ddw_tpu_torch.data.prep.
write_token_table`) yield next-token pairs ``(inputs [B, S], targets [B,
S])`` int32, a memcpy per record. Super-batches ``[k, B, ...]`` for
``steps_per_dispatch`` are stacked on the device in ``chain_plan`` order.
Cached-feature tables (``features_f32``, :mod:`ddw_tpu_torch.train.transfer`)
yield ``(features [B, D] f32, labels [B])`` for a head-only model.
"""

from __future__ import annotations

import os
import queue
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from io import BytesIO
from typing import Iterator

import numpy as np
import torch

from ddw_tpu_torch.data.store import Table, read_shard_contents


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
    (the inverse of :func:`ddw_tpu_torch.data.prep.materialize_decoded`).
    :func:`dequantize_raw_u8_device` is its device twin."""
    batch /= 127.5
    batch -= 1.0


def dequantize_raw_u8_device(x: torch.Tensor) -> torch.Tensor:
    """The same scheme on the device: uint8 -> f32 in [-1, 1]. Within 1 ULP
    of :func:`dequantize_raw_u8` (a CUDA division by a scalar multiplies by
    its reciprocal)."""
    return x.float() / 127.5 - 1.0


def _pil():
    try:
        from PIL import Image
    except ImportError:
        return None
    return Image


def _preprocess_image_pil(content: bytes, height: int,
                          width: int) -> np.ndarray:
    image = _pil()
    if image is None:
        raise RuntimeError(
            "decoding images needs the native libjpeg pipeline or PIL "
            "(Pillow), and neither is available here; score a pre-decoded "
            "raw_u8 table or pass decoded arrays instead")
    img = image.open(BytesIO(content))
    # JPEG DCT-scaled decode when the source is larger than the target.
    img.draft("RGB", (width, height))
    if img.mode != "RGB":
        img = img.convert("RGB")
    img = img.resize((width, height), image.BILINEAR)
    arr = np.asarray(img, dtype=np.float32)
    return arr / 127.5 - 1.0


def active_decoder() -> str:
    """The decode implementation :func:`preprocess_image` uses here:
    ``native`` (the libjpeg pipeline), ``pil``, or ``none`` where neither is
    available. Packages record it at save time; loading warns when the
    serving side resolves differently (decoder skew)."""
    from ddw_tpu_torch.native.decode import native_available

    if native_available():
        return "native"
    return "pil" if _pil() is not None else "none"


def preprocess_image(content: bytes, height: int, width: int) -> np.ndarray:
    """Encoded image bytes -> float32 [H, W, 3] in [-1, 1]: the native
    pipeline (point-sampled bilinear, ``tf.image.resize``'s semantics) where
    it builds, else PIL (area-filtered bilinear); an image the native
    decoder refuses goes to PIL too."""
    from ddw_tpu_torch.native.decode import decode_one_native

    out = decode_one_native(content, height, width)
    if out is not None:
        return out
    return _preprocess_image_pil(content, height, width)


class ShardedLoader:
    """Iterate ``(images, labels)`` batches from a table, sharded by rank.

    Arguments as ``ddw_tpu``'s, except ``prefetch_to``, which here is a
    ``torch.device`` (``"cuda"`` or ``"cpu"``): batches then arrive as
    tensors on it — f32 images ``[B, H, W, 3]`` and int32 labels ``[B]``,
    for a ``features_f32`` table f32 features ``[B, D]``, or for a
    ``tokens_i32`` table int32 ``(inputs, targets)`` ``[B, S]``
    (``[k, B, ...]`` with ``super_batch``) — from a background thread
    ``prefetch`` batches ahead. Without it, host numpy batches.
    """

    def __init__(
        self,
        table: Table,
        batch_size: int,
        image_size: tuple[int, int] = (224, 224),
        cur_shard: int = 0,
        shard_count: int = 1,
        num_epochs: int | None = None,
        shuffle: bool = True,
        seed: int = 0,
        shuffle_buffer: int = 1024,
        workers: int = 4,
        prefetch: int = 2,
        prefetch_to=None,
        skip_records: int = 0,
        super_batch=None,
    ):
        if not 0 <= cur_shard < shard_count:
            raise ValueError(f"cur_shard {cur_shard} out of range for "
                             f"shard_count {shard_count}")
        self._super_plan = None
        if super_batch is not None:
            plan = ((int(super_batch),) if isinstance(super_batch, int)
                    else tuple(int(k) for k in super_batch))
            if not plan or any(k < 1 for k in plan):
                raise ValueError(f"super_batch must be a positive int or a "
                                 f"tuple of positive chain lengths, got "
                                 f"{super_batch!r}")
            if any(k != 1 for k in plan):
                if prefetch_to is None:
                    raise ValueError("super_batch needs prefetch_to (batches "
                                     "are stacked on the device on the "
                                     "prefetch thread)")
                self._super_plan = plan
        encoding = table.meta.get("encoding")
        self.table = table
        self.batch_size = batch_size
        self.height, self.width = image_size
        self.cur_shard = cur_shard
        self.shard_count = shard_count
        self.num_epochs = num_epochs
        self.shuffle = shuffle
        self.seed = seed
        self.shuffle_buffer = shuffle_buffer
        self.workers = workers
        self.prefetch = prefetch
        self.prefetch_to = (torch.device(prefetch_to)
                            if prefetch_to is not None else None)
        self.skip_records = skip_records

        # a cached-feature table's content is the frozen backbone's pooled
        # f32 feature vector (train/transfer.py); batches go to the head
        self._feature_dim = (table.meta.get("feature_dim")
                             if encoding == "features_f32" else None)
        # a token table's content is an int32 [S+1] sequence
        self._token_len = (table.meta.get("seq_plus_one")
                           if encoding == "tokens_i32" else None)
        self._raw_u8 = encoding == "raw_u8"
        if self._raw_u8:
            th, tw = table.meta["height"], table.meta["width"]
            if (th, tw) != (self.height, self.width):
                raise ValueError(
                    f"loader image_size {(self.height, self.width)} != "
                    f"materialized table size {(th, tw)} — re-materialize or "
                    f"match DataCfg.img_height/img_width")
            # Bound the shuffle buffer by bytes (64 MB), not records.
            record_bytes = th * tw * 3
            self.shuffle_buffer = max(
                2, min(self.shuffle_buffer, (64 << 20) // record_bytes))

        shards = list(table.shard_paths)
        if len(shards) >= shard_count:
            plan = self.shard_plan(len(shards), shard_count)
            self._my_shards = [shards[i] for i in plan[cur_shard]]
            self._record_stride = None
        else:
            # Fewer shards than workers: record-level modulo sharding.
            self._my_shards = shards
            self._record_stride = (cur_shard, shard_count)

    @staticmethod
    def shard_plan(n_shards: int, shard_count: int) -> list[list[int]]:
        """Round-robin assignment of table shards to workers: worker ``r``
        owns ``range(r, n_shards, shard_count)`` — a partition."""
        if shard_count < 1:
            raise ValueError(f"shard_count must be >= 1, got {shard_count}")
        return [list(range(r, n_shards, shard_count))
                for r in range(shard_count)]

    @property
    def records_per_worker(self) -> int:
        """Records this worker owns."""
        if self._record_stride is None:
            counts = {m["file"]: m["num_records"]
                      for m in self.table.manifest["shards"]}
            return sum(counts[os.path.basename(p)] for p in self._my_shards)
        n, (r, k) = self.table.num_records, self._record_stride
        return n // k + (1 if r < n % k else 0)

    def steps_per_epoch(self) -> int:
        """``table_size // (batch * shard_count)`` (global-size floor)."""
        return max(1, self.table.num_records
                   // (self.batch_size * self.shard_count))

    # -- host pipeline -------------------------------------------------------
    def _iter_raw(self) -> Iterator[tuple[bytes, int]]:
        """Infinite (or ``num_epochs``-bounded) stream of ``(content,
        label_idx)`` for this worker, with the epoch-varying shard shuffle and
        the record-level shuffle buffer of ``ddw_tpu``."""
        epoch = 0
        while self.num_epochs is None or epoch < self.num_epochs:
            rng = np.random.RandomState(
                (self.seed * 100003 + epoch * 7919 + self.cur_shard)
                & 0x7FFFFFFF)
            shards = list(self._my_shards)
            if self.shuffle:
                rng.shuffle(shards)

            def records():
                for sp in shards:
                    if self._record_stride is None:
                        yield from read_shard_contents(sp)
                    else:
                        r, k = self._record_stride
                        for i, entry in enumerate(read_shard_contents(sp)):
                            if i % k == r:
                                yield entry

            if not self.shuffle:
                yield from records()
            else:
                buf = []
                for item in records():
                    buf.append(item)
                    if len(buf) >= self.shuffle_buffer:
                        j = rng.randint(len(buf))
                        buf[j], buf[-1] = buf[-1], buf[j]
                        yield buf.pop()
                rng.shuffle(buf)
                yield from buf
            epoch += 1

    def _iter_raw_resumed(self) -> Iterator[tuple[bytes, int]]:
        """The raw stream fast-forwarded ``skip_records`` records (skipped
        records advance the shuffle RNG as consumed ones do; never
        decoded)."""
        it = self._iter_raw()
        for _ in range(self.skip_records):
            next(it)
        return it

    def _iter_batches(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        from ddw_tpu_torch.native.decode import (decode_batch_native,
                                                 native_available)

        if self._token_len:
            t = self._token_len
            toks = np.empty((self.batch_size, t), np.int32)
            i = 0
            for content, _ in self._iter_raw_resumed():
                toks[i] = np.frombuffer(content, np.int32, count=t)
                i += 1
                if i == self.batch_size:
                    yield toks[:, :-1].copy(), toks[:, 1:].copy()
                    i = 0
            return  # drop remainder: static shapes

        if self._feature_dim:
            d = self._feature_dim
            feats = np.empty((self.batch_size, d), np.float32)
            flbls = np.empty((self.batch_size,), np.int32)
            i = 0
            for content, label_idx in self._iter_raw_resumed():
                feats[i] = np.frombuffer(content, np.float32, count=d)
                flbls[i] = label_idx
                i += 1
                if i == self.batch_size:
                    yield feats.copy(), flbls.copy()
                    i = 0
            return  # drop remainder: static shapes

        lbls = np.empty((self.batch_size,), np.int32)
        if self._raw_u8:
            # uint8 batches when a device prefetcher dequantizes downstream
            device_side = self.prefetch_to is not None
            buf = np.empty((self.batch_size, self.height, self.width, 3),
                           np.uint8 if device_side else np.float32)
            i = 0
            for content, label_idx in self._iter_raw_resumed():
                buf[i] = raw_u8_view(content, self.height, self.width)
                lbls[i] = label_idx
                i += 1
                if i == self.batch_size:
                    if not device_side:
                        dequantize_raw_u8(buf)
                    yield buf.copy(), lbls.copy()
                    i = 0
            return  # drop remainder: static shapes

        imgs = np.empty((self.batch_size, self.height, self.width, 3),
                        np.float32)
        if native_available():
            # one C++ thread-pool call per batch (one GIL release); images
            # the native decoder refuses fall back to PIL one by one
            contents: list[bytes] = []
            for content, label_idx in self._iter_raw_resumed():
                lbls[len(contents)] = label_idx
                contents.append(content)
                if len(contents) == self.batch_size:
                    _, ok = decode_batch_native(
                        contents, self.height, self.width,
                        threads=self.workers, out=imgs)
                    for j in np.nonzero(~ok)[0]:
                        imgs[j] = _preprocess_image_pil(
                            contents[j], self.height, self.width)
                    yield imgs.copy(), lbls.copy()
                    contents = []
            return  # drop remainder: static shapes

        # PIL on a thread pool (PIL releases the GIL in its C decode)
        pool = ThreadPoolExecutor(max_workers=self.workers)
        try:
            def decode(entry):
                content, label_idx = entry
                return (preprocess_image(content, self.height, self.width),
                        np.int32(label_idx))

            i = 0
            for img, lbl in bounded_map(pool, decode, self._iter_raw_resumed(),
                                        self.workers * 4):
                imgs[i], lbls[i] = img, lbl
                i += 1
                if i == self.batch_size:
                    yield imgs.copy(), lbls.copy()
                    i = 0
        finally:
            pool.shutdown(wait=False, cancel_futures=True)

    # -- device prefetch -------------------------------------------------------
    def _transfer(self, imgs: np.ndarray, lbls: np.ndarray, dev, stream):
        """Host batch -> device tensors on ``stream`` (None on the CPU)."""
        x, y = torch.from_numpy(imgs), torch.from_numpy(lbls)
        if dev.type == "cuda":
            x, y = x.pin_memory(), y.pin_memory()
            with torch.cuda.stream(stream):
                x = x.to(dev, non_blocking=True)
                y = y.to(dev, non_blocking=True)
                if self._raw_u8:
                    x = dequantize_raw_u8_device(x)
        elif self._raw_u8:
            x = dequantize_raw_u8_device(x)
        return x, y

    def __iter__(self):
        """Yield batches; with ``prefetch_to`` a background thread runs the
        host pipeline and the device copy ``prefetch`` batches ahead."""
        if self.prefetch_to is None:
            yield from self._iter_batches()
            return

        dev = self.prefetch_to
        cuda = dev.type == "cuda"
        if cuda and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        stream = torch.cuda.Stream(device=dev) if cuda else None
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        sentinel = object()
        plan = self._super_plan

        def put_or_stop(item) -> bool:
            # an abandoned consumer sets `stop`; re-check between attempts
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def ready(x, y):
            event = None
            if cuda:
                event = torch.cuda.Event()
                event.record(stream)
            return x, y, event

        def producer():
            try:
                if cuda:
                    torch.cuda.set_device(dev)
                group: list = []
                ci = 0
                for imgs, lbls in self._iter_batches():
                    if stop.is_set():
                        return
                    x, y = self._transfer(imgs, lbls, dev, stream)
                    if plan is None:
                        if not put_or_stop(ready(x, y)):
                            return
                        continue
                    group.append((x, y))
                    if len(group) == plan[ci % len(plan)]:
                        if cuda:
                            with torch.cuda.stream(stream):
                                xs = torch.stack([g[0] for g in group])
                                ys = torch.stack([g[1] for g in group])
                        else:
                            xs = torch.stack([g[0] for g in group])
                            ys = torch.stack([g[1] for g in group])
                        if not put_or_stop(ready(xs, ys)):
                            return
                        group = []
                        ci += 1
                put_or_stop(sentinel)
            except Exception as e:  # surface errors on the consumer side
                put_or_stop(e)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    return
                if isinstance(item, Exception):
                    raise item
                x, y, event = item
                if event is not None:
                    consumer = torch.cuda.current_stream(dev)
                    consumer.wait_event(event)
                    x.record_stream(consumer)
                    y.record_stream(consumer)
                yield x, y
        finally:
            stop.set()
            while True:
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            t.join(timeout=10)
