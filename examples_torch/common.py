"""Shared plumbing of the ddw_tpu_torch example scripts (the ``00_setup.py``
role), mirroring ``examples/common.py`` with the port's packages.

One ``--workdir`` tree holds tables, runs, registry and checkpoints;
``--quick`` bootstraps the synthetic flowers dataset; ``section.key=value``
overrides come last. Every example accepts:

    --workdir DIR     (default /tmp/ddw_tpu_workshop)
    --source DIR      raw JPEG class-dir tree (tf_flowers layout)
    --quick           synthetic data + SmallCNN + small images (CPU-friendly)
    --device DEV      "cuda" (the default: the card) or "cpu"
    overrides         e.g. train.batch_size=64 model.name=mobilenet_v2

Every example's ``main(argv)`` returns what it computed, so a caller can run
it in process and check the result.
"""

from __future__ import annotations

import argparse
import os

import torch

from ddw_tpu_torch.data.prep import generate_synthetic_flowers
from ddw_tpu_torch.data.store import TableStore
from ddw_tpu_torch.tracking.registry import ModelRegistry
from ddw_tpu_torch.tracking.tracker import Tracker
from ddw_tpu_torch.utils.config import (DataCfg, ModelCfg, TrainCfg, TuneCfg,
                                        apply_overrides)


def parse_args(description: str, extra=None, argv=None):
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--workdir", default="/tmp/ddw_tpu_workshop")
    ap.add_argument("--source", default="", help="raw JPEG class-dir tree")
    ap.add_argument("--quick", action="store_true",
                    help="synthetic dataset + SmallCNN, small images")
    ap.add_argument("--device", default=None,
                    help="'cuda' (default: the card) or 'cpu'")
    ap.add_argument("overrides", nargs="*",
                    help="section.key=value config overrides")
    if extra:
        extra(ap)
    return ap.parse_args(argv)


def setup(args) -> dict:
    """Build the config tree and workspace handles from CLI args."""
    cfgs = {"data": DataCfg(), "model": ModelCfg(), "train": TrainCfg(),
            "tune": TuneCfg()}
    if args.quick:
        cfgs["data"].img_height = cfgs["data"].img_width = 32
        cfgs["data"].sample_fraction = 1.0
        cfgs["data"].shard_size = 32
        cfgs["model"].name = "small_cnn"
        cfgs["model"].dtype = "float32"
        cfgs["train"].batch_size = 8
        cfgs["train"].warmup_epochs = 0
    apply_overrides(cfgs, args.overrides)

    os.makedirs(args.workdir, exist_ok=True)
    source = args.source
    if not source:
        source = os.path.join(args.workdir, "raw_flowers")
        if not os.path.isdir(source):
            if not args.quick:
                raise SystemExit("--source required (or pass --quick for "
                                 "synthetic data)")
            print(f"[setup] generating synthetic flowers at {source}")
            generate_synthetic_flowers(source, images_per_class=40, size=48)
    cfgs["data"].source_dir = source
    cfgs["data"].table_root = os.path.join(args.workdir, "tables")

    return {
        "cfgs": cfgs,
        "store": TableStore(cfgs["data"].table_root),
        "tracker": Tracker(os.path.join(args.workdir, "runs"), "workshop"),
        "registry": ModelRegistry(os.path.join(args.workdir, "registry")),
        "workdir": args.workdir,
        "device": args.device,
    }


def require_tables(store: TableStore, data_cfg=None):
    """Resolve the training tables, preferring the pre-decoded ``*_decoded``
    tables (``01_data_prep.py --materialize``) when they exist, match the
    configured image size and were decoded from the current silver
    versions."""
    if not (store.exists("silver_train") and store.exists("silver_val")):
        raise SystemExit("silver tables missing — run "
                         "examples_torch/01_data_prep.py first")
    train = store.table("silver_train")
    val = store.table("silver_val")
    return _prefer_materialized(store, data_cfg, train, val)


def ensure_frozen_backbone_cfg(model_cfg) -> None:
    """Demo policy of the ``--cache-features`` examples: swap the
    backbone-less ``--quick`` default for a small frozen MobileNetV2 and opt
    into a frozen random base when no pretrained artifact is set."""
    if model_cfg.name == "small_cnn":
        model_cfg.name, model_cfg.width_mult = "mobilenet_v2", 0.35
    model_cfg.freeze_base = True
    if not model_cfg.pretrained_path:
        model_cfg.allow_frozen_random = True


def _prefer_materialized(store, data_cfg, train, val):
    if (data_cfg is not None and store.exists("silver_train_decoded")
            and store.exists("silver_val_decoded")):
        t = store.table("silver_train_decoded")
        v = store.table("silver_val_decoded")
        size_ok = (t.meta.get("height"), t.meta.get("width")) == (
            data_cfg.img_height, data_cfg.img_width)
        fresh = (t.meta.get("source_version") == train.manifest["version"]
                 and v.meta.get("source_version") == val.manifest["version"])
        if size_ok and fresh:
            print("[tables] using pre-decoded raw_u8 tables (materialized "
                  "cache)")
            return t, v
        if size_ok and not fresh:
            print("[tables] ignoring stale materialized cache (silver tables "
                  "are newer — re-run 01_data_prep.py --materialize)")
    return train, val


def rank_threads(procs: int) -> None:
    """Give this rank its share of the host's cores: ranks that share a
    host each default to all of them, and the host-side work then crawls."""
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // procs))


def _score_rank(pkg_dir: str, table_root: str, table_name: str,
                out_name: str, device, batch_per_device: int):
    """One rank of :func:`score_distributed` (a spawned process)."""
    from ddw_tpu_torch.runtime.dist import process_topology
    from ddw_tpu_torch.serving.batch import BatchScorer

    rank_threads(process_topology()[1])
    store = TableStore(table_root)
    return BatchScorer(pkg_dir, device=device,
                       batch_per_device=batch_per_device).score_table(
        store.table(table_name), out_store=store, out_name=out_name,
        merge=True)


def score_distributed(pkg_dir: str, store: TableStore, table_name: str,
                      out_name: str, procs: int, device=None,
                      batch_per_device: int = 16) -> list[tuple[str, str]]:
    """Score a table with the packaged model in ``procs`` processes joined
    by a gloo group (each takes its shards; on one card they share it);
    rank 0 merges the parts into one ``out_name`` table. Returns every
    rank's ``(path, predicted_class)`` rows, in rank order."""
    from ddw_tpu_torch.runtime.dist import spawn_cpu

    parts = spawn_cpu(_score_rank, procs, pkg_dir, store.root, table_name,
                      out_name, device, batch_per_device, timeout_s=900)
    return [row for part in parts for row in part]
