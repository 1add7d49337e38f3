"""Batch scorers — the port of ``ddw_tpu.serving.batch`` (the
``mlflow.pyfunc.spark_udf`` role) for one process on one device:
:class:`BatchScorer` for image tables, :class:`LMBatchScorer` for
``tokens_i32`` tables with a packaged LM.

Shards of the input table are the unit of work. A ``raw_u8`` table (pixels
pre-decoded by ``ddw_tpu.data.prep.materialize_decoded``) is reinterpreted and
dequantized with no decode at all; any other table is decoded record by record
on a thread pool. Batches go through :meth:`PackagedModel.predict_logits`
(fixed device sub-batch of 128). Results are written as a predictions table
stamped with the same run token ``ddw_tpu`` derives. The LM scorer gathers
fixed batches of ``batch_per_device`` rows (zero-padded at the end), checks
the token ids and scores each row's mean next-token NLL.

This process's rank and world come from ``DDW_PROCESS_ID`` /
``DDW_NUM_PROCESSES`` when set (else 0 and 1) and select its shards. Several
processes each write a ``{out_name}_pN`` part stamped with the run token of
(input table version, packaged-model digest); with ``merge=True`` rank 0
waits for every part carrying this run's token and commits one ``out_name``
table (:func:`merge_predictions`), so a part from a run over another table
version or model is never matched. The native JPEG pipeline is not yet
ported.
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


def _scoring_run_id(table: Table, content_digest: str) -> str:
    """The scoring run's token: equal on every process for the same (input
    table version, packaged model), with no communication, and equal to
    ``ddw_tpu``'s."""
    return TableStore.run_token(table.manifest["name"],
                                table.manifest["version"], content_digest)


def _write_scored_table(out_store: TableStore, out_name: str, records,
                        meta: dict, table: Table, content_digest: str,
                        rank: int, world: int, merge: bool) -> None:
    """Per-process ``{out_name}_pN`` parts (one ``out_name`` table for a
    single process), stamped with the run token; with ``merge`` rank 0 then
    waits for every part of this run and merges them."""
    run_id = _scoring_run_id(table, content_digest)
    name = out_name if world == 1 else f"{out_name}_p{rank}"
    out_store.write(name, records,
                    meta={**meta, "source_table": table.manifest["name"],
                          "run_id": run_id})
    if merge and world > 1 and rank == 0:
        merge_predictions(out_store, out_name, world, run_id)


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
        label=prediction): one table for a single process, else a part per
        process, which rank 0 merges into one ``out_name`` table when
        ``merge`` is set (module docstring)."""
        rank, world = process_topology()
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
                self.model.content_digest, rank, world, merge)
        return results


class LMBatchScorer:
    """Score a ``tokens_i32`` table with a packaged LM on one device —
    per-sequence mean next-token NLL in fixed batches of
    ``batch_per_device`` rows (64 by default, ``ddw_tpu``'s; at the LM's
    2,048-token rows that batch takes attention to K3)."""

    def __init__(self, model, device=None, batch_per_device: int = 64):
        from ddw_tpu_torch.serving.lm_package import LMPackagedModel

        self.model = (LMPackagedModel(model, device=device)
                      if isinstance(model, str) else model)
        self.batch = batch_per_device

    def score_table(self, table: Table, out_store: TableStore | None = None,
                    out_name: str = "lm_scores",
                    merge: bool = True) -> list[tuple[str, float]]:
        """Returns [(path, nll)] for this process's shard subset; with
        ``out_store`` also writes a scores table (label = formatted NLL,
        content = f32 bytes) stamped with the run token, its parts merged
        by rank 0 as :meth:`BatchScorer.score_table` merges them."""
        from ddw_tpu_torch.serving.lm_package import check_token_ids

        if table.meta.get("encoding") != "tokens_i32":
            raise ValueError(f"LMBatchScorer needs a tokens_i32 table, got "
                             f"encoding {table.meta.get('encoding')!r} — "
                             f"materialize with prep.write_token_table")
        rank, world = process_topology()
        t = table.meta["seq_plus_one"]
        cfg = self.model.lm_cfg
        if t - 1 > cfg.max_len:
            raise ValueError(f"table sequences ({t - 1}) exceed the packaged "
                             f"model's max_len {cfg.max_len}")
        results: list[tuple[str, float]] = []
        buf = np.zeros((self.batch, t), np.int32)
        paths: list[str] = []

        def flush():
            if not paths:
                return
            n = len(paths)
            buf[n:] = 0  # padded rows: valid ids, sliced off below
            check_token_ids(buf[:n], cfg.vocab_size)
            nll = self.model.nll(buf)[:n]
            results.extend((p, float(v)) for p, v in zip(paths, nll))
            paths.clear()

        for sp in _process_shards(table, rank, world):
            for rec in read_shard(sp):
                buf[len(paths)] = np.frombuffer(rec.content, np.int32,
                                                count=t)
                paths.append(rec.path)
                if len(paths) == self.batch:
                    flush()
        flush()

        if out_store is not None:
            _write_scored_table(
                out_store, out_name,
                (Record(path=p, content=np.float32(v).tobytes(),
                        label=f"{v:.6f}") for p, v in results),
                {"metric": "mean_next_token_nll"}, table,
                self.model.content_digest, rank, world, merge)
        return results


def merge_predictions(out_store: TableStore, out_name: str, n_parts: int,
                      run_id: str, timeout_s: float = 300.0) -> Table:
    """Merge the per-process ``{out_name}_pN`` tables into one ``out_name``
    table (the single result table of ``spark_udf`` scoring): wait for every
    part stamped with this run's token (:meth:`TableStore.await_parts`; an
    existence check would match an earlier run's parts), then commit the
    merged table by manifest concatenation."""
    part_names = [f"{out_name}_p{i}" for i in range(n_parts)]
    parts = out_store.await_parts(part_names, run_id, timeout_s)
    return out_store.merge_shards(
        out_name, parts,
        meta={**parts[0].meta, "merged_from": part_names, "run_id": run_id})
