"""Data-prep / ETL — the port's copy of ``ddw_tpu.data.prep``.

The reference ETL: raw JPEG directory tree -> *bronze* table (recursive
``*.jpg`` scan with a seeded fractional sample) -> label from the parent
directory name -> seeded 90/10 train/val split -> ``label_to_idx`` from the
sorted distinct labels -> silver train/val tables; and
:func:`materialize_decoded`, the pre-decoded ``raw_u8`` table the training
loader reads with no JPEG work. Same plans, same split membership, same
label index and same table bytes as ``ddw_tpu``'s for the same inputs; and
:func:`write_token_table`, the LM family's ``tokens_i32`` table.

JPEG decode goes through :func:`ddw_tpu_torch.data.loader.preprocess_image`
(PIL, or raise). :func:`prepare_flowers_distributed` is the shared-nothing
multi-worker prep (one shared plan, round-robin slices, per-worker part
tables, a run-token-fenced merge on worker 0), and
:func:`generate_synthetic_flowers` writes the seeded stand-in for
tf_flowers: the same JPEG bytes as ``ddw_tpu``'s under the same PIL.
"""

from __future__ import annotations

import math
import os
import random
from typing import Sequence

import numpy as np

from ddw_tpu_torch.data.store import Record, Table, TableStore

FLOWER_CLASSES = ["daisy", "dandelion", "roses", "sunflowers", "tulips"]


def scan_jpeg_tree(source_dir: str, sample_fraction: float = 1.0, seed: int = 12345) -> list[str]:
    """Recursive ``*.jpg``/``*.jpeg`` scan with a seeded fractional sample.

    Mirrors ``binaryFile`` + ``pathGlobFilter='*.jpg'`` + ``recursiveFileLookup`` +
    ``.sample(frac, seed)`` (reference ``01_data_prep.py:61-66``). Paths are sorted
    before sampling so the sample is enumeration-order independent.
    """
    paths = []
    for dirpath, _dirnames, filenames in os.walk(source_dir):
        for fn in filenames:
            if fn.lower().endswith((".jpg", ".jpeg")):
                paths.append(os.path.join(dirpath, fn))
    paths.sort()
    if sample_fraction < 1.0:
        rng = random.Random(seed)
        paths = [p for p in paths if rng.random() < sample_fraction]
    return paths


def label_from_path(path: str) -> str:
    """Label = parent directory name — the pandas_udf regex
    ``'.*/(\\w+)/\\d+[_\\w]*.jpg'`` role (reference ``01_data_prep.py:125-130``)."""
    return os.path.basename(os.path.dirname(path))


def build_label_index(labels: Sequence[str]) -> dict[str, int]:
    """Sorted-distinct label -> index map (reference ``01_data_prep.py:179-181``)."""
    return {lbl: i for i, lbl in enumerate(sorted(set(labels)))}


def _prep_plan(source_dir: str, sample_fraction: float, train_fraction: float,
               split_seed: int):
    """The deterministic global ETL plan — identical on every worker.

    (sorted+sampled paths, label_to_idx, train-membership index set). Because
    the plan depends only on the source tree and seeds, distributed workers
    can each compute it locally and agree without communicating (the role of
    Spark's query plan, reference ``01_data_prep.py:61-66,162``).
    """
    paths = scan_jpeg_tree(source_dir, sample_fraction)
    if not paths:
        raise FileNotFoundError(f"no JPEGs under {source_dir}")
    label_to_idx = build_label_index([label_from_path(p) for p in paths])
    rng = np.random.RandomState(split_seed)
    perm = rng.permutation(len(paths))
    n_train = int(math.floor(train_fraction * len(paths)))
    train_ids = set(perm[:n_train].tolist())
    return paths, label_to_idx, train_ids


def prepare_flowers(
    source_dir: str,
    store: TableStore,
    sample_fraction: float = 0.5,
    train_fraction: float = 0.9,
    split_seed: int = 42,
    shard_size: int = 256,
    bronze_name: str = "flowers_bronze",
    train_name: str = "silver_train",
    val_name: str = "silver_val",
    io_workers: int = 8,
) -> tuple[Table, Table, dict[str, int]]:
    """Full 01_data_prep pipeline: scan -> bronze -> label/split/index -> silver.

    Returns (silver_train, silver_val, label_to_idx). Split uses a seeded
    permutation of the bronze rows (the ``randomSplit([.9,.1], seed=42)`` role,
    reference ``01_data_prep.py:162``). ``io_workers`` parallelizes the raw
    file reads (executor-scan role) without changing record order.
    """
    from concurrent.futures import ThreadPoolExecutor

    from ddw_tpu_torch.data.loader import bounded_map

    paths, label_to_idx, train_ids = _prep_plan(
        source_dir, sample_fraction, train_fraction, split_seed)

    def read_one(p: str) -> Record:
        with open(p, "rb") as f:
            return Record(path=p, content=f.read())

    def bronze_records():
        with ThreadPoolExecutor(max_workers=io_workers) as pool:
            yield from bounded_map(pool, read_one, paths, io_workers * 4)

    bronze = store.write(bronze_name, bronze_records(), shard_size=shard_size,
                         meta={"source_dir": source_dir, "sample_fraction": sample_fraction})

    # Single pass over bronze, routing each record to its split writer (re-reading
    # the bronze table once per destination would double prep IO at scale).
    t_meta = {"label_to_idx": label_to_idx, "split": "train", "split_seed": split_seed}
    v_meta = {"label_to_idx": label_to_idx, "split": "val", "split_seed": split_seed}
    with store.writer(train_name, shard_size, t_meta) as tw, \
         store.writer(val_name, shard_size, v_meta) as vw:
        for i, rec in enumerate(bronze.iter_records()):
            lbl = label_from_path(rec.path)
            silver_rec = Record(rec.path, rec.content, lbl, label_to_idx[lbl])
            (tw if i in train_ids else vw).append(silver_rec)
    return tw.close(), vw.close(), label_to_idx


def prepare_flowers_distributed(
    source_dir: str,
    store: TableStore,
    worker_index: int,
    worker_count: int,
    sample_fraction: float = 0.5,
    train_fraction: float = 0.9,
    split_seed: int = 42,
    shard_size: int = 256,
    bronze_name: str = "flowers_bronze",
    train_name: str = "silver_train",
    val_name: str = "silver_val",
    io_workers: int = 8,
    merge_timeout_s: float = 600.0,
    abort=None,
) -> tuple[Table, Table, dict[str, int]] | None:
    """Multi-worker 01_data_prep: the Spark-executors ETL role, shared-nothing.

    Every worker computes the identical deterministic plan (:func:`_prep_plan`),
    takes the round-robin slice ``paths[worker_index::worker_count]``, reads its
    files on a thread pool, and writes per-worker part tables
    (``<name>_p<w>``). Worker 0 then waits for all parts and commits the final
    tables via zero-copy manifest merge (:meth:`TableStore.merge_shards`) —
    the executors-scan / coordinator-commits split of the reference
    (``01_data_prep.py:61-95``). Same split membership and label index as
    :func:`prepare_flowers` (the plan is shared); record order differs
    (per-worker striping), which the shuffling loader never observes.

    Returns (silver_train, silver_val, label_to_idx) on worker 0, None on
    other workers. Workers must share ``store``'s filesystem. ``abort`` (an
    optional zero-arg callable returning a reason string, polled while
    waiting) lets the coordinator fail fast when a worker process dies
    instead of sleeping out ``merge_timeout_s``.
    """
    from concurrent.futures import ThreadPoolExecutor

    from ddw_tpu_torch.data.loader import bounded_map

    if not 0 <= worker_index < worker_count:
        raise ValueError(f"worker_index {worker_index} out of range "
                         f"for worker_count {worker_count}")
    paths, label_to_idx, train_ids = _prep_plan(
        source_dir, sample_fraction, train_fraction, split_seed)
    my = list(range(worker_index, len(paths), worker_count))

    # Run token: every worker derives the identical id from the run's actual
    # inputs (config + the sampled files' identity), with no communication.
    # The coordinator only merges parts carrying this id, so a re-run against
    # changed data can never silently mix a previous run's parts
    # (TableStore.await_parts). Same data + config => same id, and then stale
    # parts are byte-identical to fresh ones, so matching them is harmless.
    def _stat(p):
        st = os.stat(p)
        return f"{p}|{st.st_size}|{st.st_mtime_ns}"

    run_id = TableStore.run_token(
        (worker_count, sample_fraction, train_fraction, split_seed, shard_size),
        [_stat(p) for p in paths])

    def read_one(i: int) -> tuple[int, Record]:
        with open(paths[i], "rb") as f:
            return i, Record(path=paths[i], content=f.read())

    part = f"_p{worker_index}"
    b_meta = {"source_dir": source_dir, "sample_fraction": sample_fraction,
              "worker": worker_index, "run_id": run_id}
    t_meta = {"label_to_idx": label_to_idx, "split": "train",
              "split_seed": split_seed, "worker": worker_index,
              "run_id": run_id}
    v_meta = {**t_meta, "split": "val"}
    with store.writer(bronze_name + part, shard_size, b_meta) as bw, \
         store.writer(train_name + part, shard_size, t_meta) as tw, \
         store.writer(val_name + part, shard_size, v_meta) as vw, \
         ThreadPoolExecutor(max_workers=io_workers) as pool:
        for i, rec in bounded_map(pool, read_one, my, io_workers * 4):
            bw.append(rec)
            lbl = label_from_path(rec.path)
            silver = Record(rec.path, rec.content, lbl, label_to_idx[lbl])
            (tw if i in train_ids else vw).append(silver)

    if worker_index != 0:
        return None

    # Coordinator: wait for every worker's current-run parts, then commit
    # merged tables (zero-copy manifest concat).
    def merge(name, meta):
        parts = store.await_parts([f"{name}_p{w}" for w in range(worker_count)],
                                  run_id, merge_timeout_s, abort=abort)
        return store.merge_shards(name, parts,
                                  meta={**meta, "worker_count": worker_count,
                                        "run_id": run_id})

    merge(bronze_name, {"source_dir": source_dir,
                        "sample_fraction": sample_fraction})
    train_tbl = merge(train_name, {"label_to_idx": label_to_idx,
                                   "split": "train", "split_seed": split_seed})
    val_tbl = merge(val_name, {"label_to_idx": label_to_idx,
                               "split": "val", "split_seed": split_seed})
    return train_tbl, val_tbl, label_to_idx


def materialize_decoded(
    table: Table,
    store: TableStore,
    out_name: str,
    height: int,
    width: int,
    shard_size: int = 256,
    io_workers: int = 4,
) -> Table:
    """Materialize a silver table into a pre-decoded ``raw_u8`` table.

    The Petastorm materialized-cache role (the reference converts the Spark
    table into a decoded parquet cache before training,
    ``03_model_training_distributed.py:137-144``): decode + resize every JPEG
    ONCE at prep time and store raw uint8 [H, W, 3] pixels, so the training
    loader's per-batch work drops from JPEG decode to a memcpy + scale. Pixels are produced by the SAME shared
    ``preprocess_image`` path training/serving use, then quantized to uint8
    (max quantization error 1/255 of the [-1, 1] range — the JPEG already
    quantized harder). The loader detects ``meta.encoding == 'raw_u8'`` and
    skips decode.

    Size: ~H*W*3 bytes/record (150 KB at 224²) vs ~20-40 KB JPEG — the
    standard decode-once/store-big tradeoff the reference's cache makes too.
    """
    from concurrent.futures import ThreadPoolExecutor

    from ddw_tpu_torch.data.loader import bounded_map, preprocess_image

    def decode(rec: Record) -> Record:
        arr = preprocess_image(rec.content, height, width)  # f32 [-1, 1]
        u8 = np.clip(np.round((arr + 1.0) * 127.5), 0, 255).astype(np.uint8)
        return Record(rec.path, u8.tobytes(), rec.label, rec.label_idx)

    meta = {**table.meta, "encoding": "raw_u8", "height": height,
            "width": width, "source_table": table.manifest["name"],
            "source_version": table.manifest["version"]}
    with ThreadPoolExecutor(max_workers=io_workers) as pool:
        return store.write(
            out_name,
            bounded_map(pool, decode, table.iter_records(), io_workers * 4),
            shard_size=shard_size, meta=meta)


def write_token_table(
    store: TableStore,
    name: str,
    tokens,
    shard_size: int = 2048,
) -> Table:
    """Materialize a token corpus ``[N, S+1]`` int32 as a ``tokens_i32``
    table (record ``seq/{i:08d}``, content the row's int32 bytes, meta
    ``seq_plus_one``) — byte for byte the table ``ddw_tpu`` writes."""
    tokens = np.asarray(tokens, np.int32)
    if tokens.ndim != 2 or tokens.shape[1] < 2 or tokens.shape[0] < 1:
        raise ValueError(f"tokens must be a non-empty [num_seqs, seq_len+1], "
                         f"got {tokens.shape}")
    meta = {"encoding": "tokens_i32", "seq_plus_one": int(tokens.shape[1])}
    recs = (Record(path=f"seq/{i:08d}",
                   content=np.ascontiguousarray(row).tobytes())
            for i, row in enumerate(tokens))
    return store.write(name, recs, shard_size=shard_size, meta=meta)


# ---------------------------------------------------------------------------
# Synthetic flowers (zero-egress stand-in for tf_flowers)
# ---------------------------------------------------------------------------

def _draw_class_image(rng: np.random.RandomState, cls_idx: int, size: int) -> "np.ndarray":
    """Class-distinctive synthetic image: each class gets a distinct dominant hue and
    petal-count geometry, with noise, random rotation/position/scale so the task is
    learnable but not trivial."""
    img = (rng.rand(size, size, 3) * 60).astype(np.float32)  # dark noise background
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    cx, cy = rng.uniform(size * 0.3, size * 0.7, 2)
    r = np.hypot(xx - cx, yy - cy)
    theta = np.arctan2(yy - cy, xx - cx) + rng.uniform(0, 2 * np.pi)
    petals = 3 + cls_idx * 2                      # 3,5,7,9,11 petals by class
    radius = size * rng.uniform(0.18, 0.30) * (1 + 0.45 * np.cos(petals * theta))
    mask = r < radius
    hue = np.zeros(3, np.float32)
    hue[cls_idx % 3] = 200 + rng.uniform(0, 55)
    hue[(cls_idx + 1) % 3] = 60 * (cls_idx // 3) + rng.uniform(0, 40)
    img[mask] = hue + rng.randn(int(mask.sum()), 3).astype(np.float32) * 12
    return np.clip(img, 0, 255).astype(np.uint8)


def generate_synthetic_flowers(
    root: str,
    images_per_class: int = 40,
    size: int = 64,
    classes: Sequence[str] = tuple(FLOWER_CLASSES),
    seed: int = 0,
) -> str:
    """Write a tf_flowers-layout JPEG tree (``<root>/<class>/<i>.jpg``)."""
    from PIL import Image

    rng = np.random.RandomState(seed)
    for ci, cls in enumerate(classes):
        cdir = os.path.join(root, cls)
        os.makedirs(cdir, exist_ok=True)
        for i in range(images_per_class):
            arr = _draw_class_image(rng, ci, size)
            Image.fromarray(arr).save(os.path.join(cdir, f"{i:04d}.jpg"), quality=90)
    return root
