"""Batch scorer — the port of ``ddw_tpu.serving.batch.BatchScorer`` (the
``mlflow.pyfunc.spark_udf`` role) for one process on one device.

Shards of the input table are the unit of work. A ``raw_u8`` table (pixels
pre-decoded by ``ddw_tpu.data.prep.materialize_decoded``) is reinterpreted and
dequantized with no decode at all; any other table is decoded record by record
on a thread pool. Batches go through :meth:`PackagedModel.predict_logits`
(fixed device sub-batch of 128). Results are written as a predictions table
stamped with the same run token ``ddw_tpu`` derives.

This process's rank and world come from ``DDW_PROCESS_ID`` /
``DDW_NUM_PROCESSES`` when set (else 0 and 1) and select its shards. Merging
the per-process parts (``merge_predictions``) and the native JPEG pipeline
are not yet ported.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ddw_tpu_torch.data.loader import (bounded_map, dequantize_raw_u8,
                                       preprocess_image, raw_u8_view)
from ddw_tpu_torch.data.store import Record, Table, TableStore, read_shard
from ddw_tpu_torch.serving.package import PackagedModel


def process_topology() -> tuple[int, int]:
    """(rank, world) of this process from the launcher's environment."""
    rank = int(os.environ.get("DDW_PROCESS_ID", "0"))
    world = int(os.environ.get("DDW_NUM_PROCESSES", "1"))
    if world < 1 or not 0 <= rank < world:
        raise ValueError(f"bad process topology rank={rank} world={world}")
    return rank, world


def _process_shards(table: Table, rank: int, world: int) -> list[str]:
    """This process's disjoint shard subset (round-robin by rank); small
    tables fall to rank 0."""
    shards = table.shard_paths
    if len(shards) >= world:
        return shards[rank::world]
    return shards if rank == 0 else []


def _write_scored_table(out_store: TableStore, out_name: str, records,
                        meta: dict, table: Table, content_digest: str,
                        rank: int, world: int) -> None:
    """Per-process ``{out_name}_pN`` parts (one ``out_name`` table for a
    single process), stamped with the run token."""
    run_id = TableStore.run_token(table.manifest["name"],
                                  table.manifest["version"], content_digest)
    name = out_name if world == 1 else f"{out_name}_p{rank}"
    out_store.write(name, records,
                    meta={**meta, "source_table": table.manifest["name"],
                          "run_id": run_id})


class BatchScorer:
    """Score a table of image records with a packaged model on one device.

    ``batch_per_device`` records are gathered per scoring call; the device
    runs them in the packaged model's fixed sub-batches of 128."""

    def __init__(self, model: PackagedModel | str, batch_per_device: int = 128,
                 workers: int = 4, device=None):
        self.model = (model if isinstance(model, PackagedModel)
                      else PackagedModel(model, device=device))
        self.batch = batch_per_device
        self.workers = workers

    def score_table(self, table: Table, out_store: TableStore | None = None,
                    out_name: str = "predictions",
                    merge: bool = True) -> list[tuple[str, str]]:
        """Returns [(path, predicted_class)] for this process's shard subset;
        with ``out_store`` also writes them as a table (path,
        label=prediction). Several processes with ``merge=True`` raise: the
        part merge comes with the distributed slice."""
        rank, world = process_topology()
        if merge and world > 1:
            raise NotImplementedError(
                "merging per-process prediction parts is not yet ported to "
                "ddw_tpu_torch; pass merge=False to write the parts only")
        h, w = self.model.height, self.model.width
        results: list[tuple[str, str]] = []

        raw_u8 = table.meta.get("encoding") == "raw_u8"
        if raw_u8 and (table.meta.get("height"), table.meta.get("width")) != (h, w):
            raise ValueError(
                f"materialized table is {table.meta.get('height')}x"
                f"{table.meta.get('width')} but the packaged model expects "
                f"{h}x{w} — re-materialize at the model's size or score the "
                f"JPEG silver table")

        def records():
            for sp in _process_shards(table, rank, world):
                yield from read_shard(sp)

        def score(imgs: np.ndarray, n: int, paths: list[str]):
            idx = np.argmax(self.model.predict_logits(imgs[:n]), axis=-1)
            results.extend((p, self.model.classes[i])
                           for p, i in zip(paths, idx))

        if raw_u8:
            imgs = np.empty((self.batch, h, w, 3), np.float32)
            paths: list[str] = []
            i = 0
            for rec in records():
                imgs[i] = raw_u8_view(rec.content, h, w)
                paths.append(rec.path)
                i += 1
                if i == self.batch:
                    dequantize_raw_u8(imgs)
                    score(imgs, i, paths)
                    paths, i = [], 0
            if i:
                dequantize_raw_u8(imgs[:i])
                score(imgs, i, paths)
        else:
            def decode(rec: Record):
                return rec.path, preprocess_image(rec.content, h, w)

            buf_paths: list[str] = []
            buf_imgs: list[np.ndarray] = []
            with ThreadPoolExecutor(max_workers=self.workers) as pool:
                for path, img in bounded_map(pool, decode, records(),
                                             self.workers * 4):
                    buf_paths.append(path)
                    buf_imgs.append(img)
                    if len(buf_imgs) == self.batch:
                        score(np.stack(buf_imgs), len(buf_imgs), buf_paths)
                        buf_paths, buf_imgs = [], []
                if buf_imgs:
                    score(np.stack(buf_imgs), len(buf_imgs), buf_paths)

        if out_store is not None:
            _write_scored_table(
                out_store, out_name,
                (Record(path=p, content=b"", label=pred)
                 for p, pred in results),
                {"model_classes": self.model.classes}, table,
                self.model.content_digest, rank, world)
        return results
