"""Cached-feature transfer learning — the port of ``ddw_tpu.train.transfer``:
train the head without re-running the frozen base.

A frozen backbone in inference mode (BatchNorm on its running statistics, no
dropout below the head, no gradient into it) is a pure function of the
pixels. This module runs it once per dataset and stores the pooled feature
vectors (f32, exactly the head's input) as a ``features_f32`` table; head
training then reads ``(B, feature_dim)`` batches and computes only Dropout
-> Dense forward and backward. On the card the featurisation is
MobileNetV2's eval forward, whose stride-1 depthwise layers run K1 with
``dw_impl="pallas"`` (13 launches a batch).

Cache fence: the feature table records a fingerprint of the backbone's
weights and BatchNorm statistics (:func:`backbone_fingerprint`, over the
flax-layout leaves in ``jax.tree.leaves`` order, so it equals ``ddw_tpu``'s
for the same weights), the source table's name and version and the input
resolution; a cached table is reused only when all of them match, so stale
features are never trained on, whichever package wrote them.

Where ``ddw_tpu`` passes ``(model, params, batch_stats)`` and a ``mesh``, the
port passes the module (its parameters and buffers are the weights) and a
``device``; data-parallel head training runs over the process group, as
:class:`~ddw_tpu_torch.train.trainer.Trainer` does.
"""

from __future__ import annotations

import copy
import dataclasses
import hashlib

import numpy as np
import torch
from torch import nn

from ddw_tpu_torch.data.store import Record, Table, TableStore
from ddw_tpu_torch.models.mobilenet_v2 import dropout
from ddw_tpu_torch.train.step import (TrainState, get_lr, init_state,
                                      make_optimizer, set_lr)
from ddw_tpu_torch.utils.config import DataCfg, ModelCfg, TrainCfg
from ddw_tpu_torch.utils.device import resolve_device


class TransferHead(nn.Module):
    """The transfer head alone: Dropout -> Dense logits over ``features``
    inputs. Its Dense is named ``head`` as in the full models, so trained
    weights fold back into the full model (:func:`merge_head_params`)."""

    def __init__(self, num_classes: int = 5, dropout: float = 0.5,
                 features: int = 1280):
        super().__init__()
        self.dropout = dropout
        self.head = nn.Linear(features, num_classes)

    def forward(self, x: torch.Tensor,
                dropout_rng: torch.Generator | None = None) -> torch.Tensor:
        h = x.float()
        if self.training and self.dropout > 0.0:
            h = dropout(h, self.dropout, dropout_rng)
        return self.head(h)

    @staticmethod
    def frozen_prefixes(freeze_base: bool) -> tuple[str, ...]:
        return ()


def _pooled_features(model: nn.Module, images: torch.Tensor) -> torch.Tensor:
    """The frozen base's pooled f32 features: the backbone in eval mode on
    images in the compute dtype, then the full model's GAP."""
    from ddw_tpu_torch.models.mobilenet_v2 import MobileNetV2

    if not isinstance(model, MobileNetV2):
        raise TypeError(f"cached-feature transfer needs a backbone/head "
                        f"model (MobileNetV2); got {type(model).__name__}")
    feats = model.backbone(images)
    return feats.float().mean(dim=(1, 2))


def _leaves(tree):
    """A flax-layout tree's leaves in ``jax.tree.leaves`` order (dict keys
    sorted at every level)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    else:
        yield tree


def backbone_fingerprint(params, batch_stats) -> str:
    """Content hash of the backbone's weights and BatchNorm statistics (the
    ``backbone`` subtrees of flax-layout ``params`` / ``batch_stats``, as
    :func:`~ddw_tpu_torch.models.convert.to_flax_variables` gives them):
    the feature cache's freshness fence, equal to ``ddw_tpu``'s."""
    h = hashlib.sha256()
    for tree in (params.get("backbone", {}),
                 (batch_stats or {}).get("backbone", {})):
        for leaf in _leaves(tree):
            h.update(np.asarray(leaf).tobytes())
    return h.hexdigest()[:32]


def model_fingerprint(model: nn.Module) -> str:
    """:func:`backbone_fingerprint` of a port module's weights."""
    from ddw_tpu_torch.models.convert import to_flax_variables

    v = to_flax_variables(model)
    return backbone_fingerprint(v["params"], v.get("batch_stats"))


def _decode_record(rec, table_meta, height: int, width: int) -> np.ndarray:
    from ddw_tpu_torch.data.loader import (dequantize_raw_u8,
                                           preprocess_image, raw_u8_view)

    if table_meta.get("encoding") == "raw_u8":
        arr = raw_u8_view(rec.content, table_meta["height"],
                          table_meta["width"]).astype(np.float32)
        dequantize_raw_u8(arr)
        return arr
    return preprocess_image(rec.content, height, width)


def _cache_fresh(cached: Table, fp: str, table: Table,
                 height: int, width: int) -> bool:
    """The freshness fence: backbone fingerprint, source table name and
    version, and input resolution all match."""
    return (cached.meta.get("backbone_fingerprint") == fp
            and cached.meta.get("source_version") == table.manifest["version"]
            and cached.meta.get("source_table") == table.manifest["name"]
            and (cached.meta.get("image_height"),
                 cached.meta.get("image_width")) == (height, width))


def _featurize_stream(model: nn.Module, table: Table, worker_slice,
                      height: int, width: int, batch_size: int,
                      io_workers: int):
    """Yield ``(feature Record, dim)`` for this worker's records
    (``worker_slice`` is ``(worker_index, worker_count)``, a round-robin
    stripe, or None for every record), decoding on a thread pool and
    featurising in batches of ``batch_size``, the last one zero-padded (one
    shape for every batch; every selected record is featurised)."""
    from concurrent.futures import ThreadPoolExecutor

    from ddw_tpu_torch.data.loader import bounded_map

    device = next(model.parameters()).device
    model.eval()
    buf_recs: list = []
    buf = np.empty((batch_size, height, width, 3), np.float32)

    def flush():
        n = len(buf_recs)
        with torch.inference_mode():
            feats = _pooled_features(
                model, torch.from_numpy(buf).to(device)).cpu().numpy()[:n]
        dim = feats.shape[1]
        for rec, f in zip(buf_recs, feats):
            yield Record(rec.path, np.ascontiguousarray(f).tobytes(),
                         rec.label, rec.label_idx), dim
        buf_recs.clear()

    def selected():
        if worker_slice is None:
            yield from table.iter_records()
        else:
            w, k = worker_slice
            for i, rec in enumerate(table.iter_records()):
                if i % k == w:
                    yield rec

    def decode(r):
        return r, _decode_record(r, table.meta, height, width)

    with ThreadPoolExecutor(max_workers=io_workers) as pool:
        for rec, arr in bounded_map(pool, decode, selected(), io_workers * 4):
            buf[len(buf_recs)] = arr
            buf_recs.append(rec)
            if len(buf_recs) == batch_size:
                yield from flush()
        if buf_recs:
            buf[len(buf_recs):] = 0.0
            yield from flush()


def _feature_meta(table: Table, fp: str, height: int, width: int,
                  feature_dim: int) -> dict:
    return {**table.meta, "encoding": "features_f32",
            "feature_dim": feature_dim, "backbone_fingerprint": fp,
            "image_height": height, "image_width": width,
            "source_table": table.manifest["name"],
            "source_version": table.manifest["version"]}


def materialize_features(
    model: nn.Module,
    table: Table,
    store: TableStore,
    out_name: str,
    image_size: tuple[int, int],
    batch_size: int = 64,
    io_workers: int = 4,
) -> Table:
    """Run ``model``'s frozen backbone once over ``table`` on the model's
    device; write (or reuse, when the fence holds) a ``features_f32`` table
    of pooled feature vectors, one per record, in the table's order."""
    height, width = image_size
    fp = model_fingerprint(model)
    if store.exists(out_name):
        cached = store.table(out_name)
        if _cache_fresh(cached, fp, table, height, width):
            return cached

    gen = _featurize_stream(model, table, None, height, width, batch_size,
                            io_workers)
    first = next(gen, None)
    if first is None:
        raise ValueError(f"table {table.manifest['name']} has no records")
    meta = _feature_meta(table, fp, height, width, feature_dim=first[1])

    def stream():
        yield first[0]
        for rec, _ in gen:
            yield rec

    return store.write(out_name, stream(), meta=meta)


def materialize_features_distributed(
    model: nn.Module,
    table: Table,
    store: TableStore,
    out_name: str,
    image_size: tuple[int, int],
    worker_index: int,
    worker_count: int,
    batch_size: int = 64,
    io_workers: int = 4,
    merge_timeout_s: float = 600.0,
    abort=None,
) -> Table | None:
    """Multi-worker :func:`materialize_features`, the part/merge shape of
    ``prep.prepare_flowers_distributed``: each worker featurises the record
    stripe ``[worker_index::worker_count]`` into a part table; worker 0
    awaits every part of this run (the token derives from the fingerprint,
    the source version, the resolution and the worker count) and commits
    the merged table. Returns it on worker 0, None elsewhere; a fresh cache
    short-circuits every worker."""
    if not 0 <= worker_index < worker_count:
        raise ValueError(f"worker_index {worker_index} out of range "
                         f"for worker_count {worker_count}")
    if table.num_records == 0:
        raise ValueError(f"table {table.manifest['name']} has no records")
    height, width = image_size
    fp = model_fingerprint(model)
    if store.exists(out_name):
        cached = store.table(out_name)
        if _cache_fresh(cached, fp, table, height, width):
            return cached if worker_index == 0 else None

    run_id = TableStore.run_token(fp, table.manifest["name"],
                                  table.manifest["version"],
                                  height, width, worker_count)
    gen = _featurize_stream(model, table, (worker_index, worker_count),
                            height, width, batch_size, io_workers)
    first = next(gen, None)
    dim = first[1] if first is not None else 0  # an empty stripe is fine
    part_meta = {**_feature_meta(table, fp, height, width, feature_dim=dim),
                 "worker": worker_index, "run_id": run_id}

    def stream():
        if first is not None:
            yield first[0]
            for rec, _ in gen:
                yield rec

    store.write(f"{out_name}_p{worker_index}", stream(), meta=part_meta)
    if worker_index != 0:
        return None

    names = [f"{out_name}_p{w}" for w in range(worker_count)]
    parts = store.await_parts(names, run_id, merge_timeout_s, abort=abort)
    dims = {p.meta["feature_dim"] for p in parts if p.meta["feature_dim"]}
    if len(dims) != 1:
        raise RuntimeError(f"feature-dim mismatch across parts: {dims}")
    meta = {**_feature_meta(table, fp, height, width, feature_dim=dims.pop()),
            "worker_count": worker_count, "run_id": run_id}
    return store.merge_shards(out_name, parts, meta=meta)


def prepare_feature_tables(
    data_cfg: DataCfg,
    model_cfg: ModelCfg,
    train_cfg: TrainCfg,
    train_table: Table,
    val_table: Table,
    store: TableStore,
    feature_batch: int = 64,
    device=None,
):
    """Featurise (or reuse cached) train/val tables for a frozen model built
    from ``model_cfg`` and initialised from ``train_cfg.seed``, on
    ``device`` (the card unless the caller asks for the CPU).

    Returns ``(feat_train, feat_val, full_model, full_state)``. Dropout and
    the Dense head sit above the pooled features, so one cache serves every
    head hyperparameter (HPO over dropout, learning rate, optimizer, batch).
    Raises when the model would not be frozen."""
    from ddw_tpu_torch.models.mobilenet_v2 import init_params
    from ddw_tpu_torch.models.registry import build_model

    if not model_cfg.freeze_base:
        raise ValueError("cached-feature training requires freeze_base=True "
                         "(an unfrozen backbone invalidates the cache every "
                         "step)")
    device = resolve_device(device)
    full_model = build_model(model_cfg)
    if not getattr(full_model, "freeze_base", False):
        raise ValueError(
            "build_model auto-unfroze the backbone (no pretrained_path); "
            "cached-feature training needs a frozen (pretrained or "
            "allow_frozen_random) base")
    if model_cfg.pretrained_path:
        raise NotImplementedError(
            "model.pretrained_path (converted pretrained weights) is not yet "
            "ported to ddw_tpu_torch; see ROADMAP.md")
    init_params(full_model, torch.Generator().manual_seed(train_cfg.seed))
    full_model.to(device)
    tx = make_optimizer(train_cfg,
                        type(full_model).frozen_prefixes(True))
    full_state = init_state(full_model, tx)

    prefix = train_table.meta.get("source_table", train_table.manifest["name"])
    size = (data_cfg.img_height, data_cfg.img_width)
    feat_train = materialize_features(
        full_model, train_table, store, f"{prefix}_feat_train", size,
        batch_size=feature_batch, io_workers=data_cfg.loader_workers)
    feat_val = materialize_features(
        full_model, val_table, store, f"{prefix}_feat_val", size,
        batch_size=feature_batch, io_workers=data_cfg.loader_workers)
    return feat_train, feat_val, full_model, full_state


def make_head_trainer(
    data_cfg: DataCfg,
    model_cfg: ModelCfg,
    train_cfg: TrainCfg,
    full_state: TrainState,
    run=None,
    on_epoch=None,
    device=None,
):
    """A :class:`~ddw_tpu_torch.train.trainer.Trainer` that trains only a
    :class:`TransferHead` on feature tables, starting from
    ``full_state``'s head (so a single run is step-equivalent to frozen
    full-model training). ``model_cfg.dropout`` may differ from the
    features' config: dropout sits above the cache."""
    from ddw_tpu_torch.train.trainer import Trainer

    device = resolve_device(device)
    src = full_state.model.head
    head = TransferHead(model_cfg.num_classes, model_cfg.dropout,
                        src.in_features)
    head.head.load_state_dict(src.state_dict())
    head.to(device)
    tx = make_optimizer(train_cfg)
    return Trainer(data_cfg, model_cfg, train_cfg, run=run, model=head,
                   initial=(init_state(head, tx), tx), on_epoch=on_epoch,
                   device=device)


@torch.no_grad()
def merge_head_params(full_state: TrainState,
                      head_state: TrainState) -> TrainState:
    """A copy of the full model with ``head_state``'s trained head in it,
    ready to package or serve (``full_state`` is left as it was: trials that
    share one feature cache each merge their own head); the optimizer state
    is ``full_state``'s and the dynamic learning rate ``head_state``'s."""
    model = copy.deepcopy(full_state.model)
    model.head.load_state_dict(head_state.model.head.state_dict())
    out = TrainState(model, full_state.opt_state, head_state.step)
    return set_lr(out, get_lr(head_state))


def train_frozen_via_features(
    data_cfg: DataCfg,
    model_cfg: ModelCfg,
    train_cfg: TrainCfg,
    train_table: Table,
    val_table: Table,
    store: TableStore,
    run=None,
    feature_batch: int = 64,
    device=None,
):
    """The frozen-transfer contract: featurise once, train the head from the
    cache, return a ``TrainResult`` whose state holds the full model
    (backbone and trained head). Requires ``model_cfg.freeze_base``."""
    feat_train, feat_val, _, full_state = prepare_feature_tables(
        data_cfg, model_cfg, train_cfg, train_table, val_table, store,
        feature_batch=feature_batch, device=device)
    trainer = make_head_trainer(data_cfg, model_cfg, train_cfg, full_state,
                                run=run, device=device)
    res = trainer.fit(feat_train, feat_val)
    return dataclasses.replace(res,
                               state=merge_head_params(full_state, res.state))
