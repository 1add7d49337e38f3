"""The port's cached-feature transfer path (``ddw_tpu_torch.train.transfer``)
on the CPU against ``ddw_tpu.train.transfer``: the cached features against
the backbone's pooled features and against JAX's table, the backbone
fingerprint across packages, the cache fence (stale weights, a newer source
version, a cache written by the other package), the distributed
featurisation, and head-only training against JAX's for a few sgd steps.
MobileNetV2 width 0.35, 32x32 images, f32."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddw_tpu.data.store import TableStore as JaxStore
from ddw_tpu.models.mobilenet_v2 import MobileNetV2 as JaxMobileNetV2
from ddw_tpu.runtime.mesh import MeshSpec, make_mesh
from ddw_tpu.train import step as jstep
from ddw_tpu.train import transfer as jtransfer
from ddw_tpu.utils.config import DataCfg as JaxDataCfg
from ddw_tpu.utils.config import ModelCfg as JaxModelCfg
from ddw_tpu.utils.config import TrainCfg as JaxTrainCfg
from ddw_tpu_torch.data.loader import dequantize_raw_u8, raw_u8_view
from ddw_tpu_torch.data.store import Record, TableStore
from ddw_tpu_torch.models.convert import load_flax_variables, to_flax_variables
from ddw_tpu_torch.models.layers import init_weights
from ddw_tpu_torch.models.registry import build_model
from ddw_tpu_torch.train import step as tstep
from ddw_tpu_torch.train import transfer
from ddw_tpu_torch.utils.config import DataCfg, ModelCfg, TrainCfg

IMG = 32
MCFG = ModelCfg(width_mult=0.35, dtype="float32", dw_impl="pallas",
                dropout=0.0, freeze_base=True, allow_frozen_random=True)


def _records(n, seed):
    rng = np.random.RandomState(seed)
    for i in range(n):
        img = rng.randint(0, 60, (IMG, IMG, 3)) + 150 * (
            np.arange(3) == i % 3)
        yield Record(f"img/{i:04d}", img.clip(0, 255).astype(np.uint8)
                     .tobytes(), f"c{i % 5}", i % 5)


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    store = TableStore(str(tmp_path_factory.mktemp("tables")))
    meta = {"encoding": "raw_u8", "height": IMG, "width": IMG}
    return (store, store.write("train", _records(40, 0), 16, meta),
            store.write("val", _records(16, 1), 16, meta))


@pytest.fixture(scope="module")
def variables():
    """Seeded flax-layout weights with non-trivial BatchNorm statistics."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        m = build_model(MCFG)
    init_weights(m, torch.Generator().manual_seed(7))
    return to_flax_variables(m)


def _port_model(variables):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return load_flax_variables(build_model(MCFG), variables).eval()


def _images(table):
    x = np.stack([raw_u8_view(r.content, IMG, IMG)
                  for r in table.iter_records()]).astype(np.float32)
    dequantize_raw_u8(x)
    return x


def _feats(table):
    d = table.meta["feature_dim"]
    return (np.stack([np.frombuffer(r.content, np.float32, count=d)
                      for r in table.iter_records()]),
            [(r.path, r.label, r.label_idx) for r in table.iter_records()])


def test_cached_features_equal_pooled_features_and_jax(tables, variables):
    store, train, _ = tables
    model = _port_model(variables)
    ft = transfer.materialize_features(model, train, store, "feat_a",
                                       (IMG, IMG), batch_size=16)
    got, rows = _feats(ft)
    assert ft.meta["encoding"] == "features_f32"
    assert got.shape == (40, ft.meta["feature_dim"]) == (40, 1280)
    assert rows == [(r.path, r.label, r.label_idx)
                    for r in train.iter_records()]
    with torch.no_grad():
        pooled = model.backbone(torch.from_numpy(_images(train))).mean(
            dim=(1, 2)).numpy()
    # batches of 16 (the last one padded) against one batch of 40
    np.testing.assert_allclose(got, pooled, rtol=1e-6,
                               atol=1e-6 * np.abs(pooled).max())

    jmodel = JaxMobileNetV2(width_mult=0.35, dtype=jnp.float32,
                            dw_impl="xla", dropout=0.0, freeze_base=True)
    jstore = JaxStore(store.root)
    jt = jtransfer.materialize_features(
        jmodel, variables["params"], variables["batch_stats"],
        jstore.table("train"), jstore, "feat_jax", (IMG, IMG), batch_size=16)
    ref, jrows = _feats(jt)
    assert jrows == rows
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())
    meta = {k: v for k, v in ft.meta.items()}
    assert meta == {k: v for k, v in jt.meta.items()}


def test_backbone_fingerprint_is_equal_across_packages(variables):
    model = _port_model(variables)
    want = jtransfer.backbone_fingerprint(variables["params"],
                                          variables["batch_stats"])
    assert transfer.backbone_fingerprint(variables["params"],
                                         variables["batch_stats"]) == want
    assert transfer.model_fingerprint(model) == want
    with torch.no_grad():
        model.head.bias.add_(1.0)          # the head is not the backbone
    assert transfer.model_fingerprint(model) == want
    with torch.no_grad():
        model.backbone.ConvBN_1.BatchNorm_0.mean[0] += 1e-3
    assert transfer.model_fingerprint(model) != want


def test_cache_fence_refuses_stale_weights_and_versions(tables, variables):
    store, train, _ = tables
    model = _port_model(variables)
    first = transfer.materialize_features(model, train, store, "feat_f",
                                          (IMG, IMG), batch_size=16)
    again = transfer.materialize_features(model, train, store, "feat_f",
                                          (IMG, IMG), batch_size=16)
    assert again.manifest["version"] == first.manifest["version"]
    with torch.no_grad():                  # stale weights
        model.backbone.ConvBN_0.Conv_0.weight.mul_(1.5)
    moved = transfer.materialize_features(model, train, store, "feat_f",
                                          (IMG, IMG), batch_size=16)
    assert moved.manifest["version"] == first.manifest["version"] + 1
    assert not np.array_equal(_feats(moved)[0], _feats(first)[0])
    newer = store.write("train", train.iter_records(), 16, train.meta)
    assert newer.manifest["version"] == train.manifest["version"] + 1
    fresh = transfer.materialize_features(model, newer, store, "feat_f",
                                          (IMG, IMG), batch_size=16)
    assert fresh.manifest["version"] == moved.manifest["version"] + 1
    assert not transfer._cache_fresh(fresh, transfer.model_fingerprint(model),
                                     newer, IMG + 1, IMG)

    # a cache the JAX package wrote is reused here for the same weights and
    # refused for others
    other = store.write("train_x", train.iter_records(), 16, train.meta)
    jstore = JaxStore(store.root)
    jt = jtransfer.materialize_features(
        JaxMobileNetV2(width_mult=0.35, dtype=jnp.float32, dw_impl="xla",
                       dropout=0.0, freeze_base=True),
        variables["params"], variables["batch_stats"],
        jstore.table("train_x"), jstore, "feat_x", (IMG, IMG), batch_size=16)
    reused = transfer.materialize_features(_port_model(variables), other,
                                           store, "feat_x", (IMG, IMG))
    assert reused.manifest["version"] == jt.manifest["version"]
    refused = transfer.materialize_features(model, other, store, "feat_x",
                                            (IMG, IMG))
    assert refused.manifest["version"] == jt.manifest["version"] + 1
    # and the JAX package reuses a cache this package wrote
    ours = transfer.materialize_features(_port_model(variables), other,
                                         store, "feat_y", (IMG, IMG))
    theirs = jtransfer.materialize_features(
        JaxMobileNetV2(width_mult=0.35, dtype=jnp.float32, dw_impl="xla",
                       dropout=0.0, freeze_base=True),
        variables["params"], variables["batch_stats"],
        jstore.table("train_x"), jstore, "feat_y", (IMG, IMG))
    assert theirs.manifest["version"] == ours.manifest["version"]


def test_distributed_featurisation_equals_single(tables, variables):
    store, _, val = tables
    model = _port_model(variables)
    single = transfer.materialize_features(model, val, store, "feat_s",
                                           (IMG, IMG), batch_size=4)
    # worker 1 first; worker 0 then merges both parts of this run
    assert transfer.materialize_features_distributed(
        model, val, store, "feat_d", (IMG, IMG), 1, 2, batch_size=4) is None
    merged = transfer.materialize_features_distributed(
        model, val, store, "feat_d", (IMG, IMG), 0, 2, batch_size=4,
        merge_timeout_s=5)
    a, rows_a = _feats(single)
    b, rows_b = _feats(merged)
    order = [rows_b.index(r) for r in rows_a]
    np.testing.assert_array_equal(a, b[order])
    assert merged.meta["worker_count"] == 2
    with pytest.raises(ValueError, match="out of range"):
        transfer.materialize_features_distributed(
            model, val, store, "feat_d", (IMG, IMG), 2, 2)


def test_head_only_training_matches_jax(tables, variables, tmp_path):
    store, train, val = tables
    model = _port_model(variables)
    ft = transfer.materialize_features(model, train, store, "feat_h",
                                       (IMG, IMG), batch_size=16)
    fv = transfer.materialize_features(model, val, store, "feat_hv",
                                       (IMG, IMG), batch_size=16)
    kw = dict(batch_size=8, epochs=2, warmup_epochs=0, learning_rate=0.1,
              optimizer="sgd", seed=1)
    data = dict(img_height=IMG, img_width=IMG, shuffle_buffer=32,
                loader_workers=1)

    jfull = jstep.TrainState(variables["params"], variables["batch_stats"],
                             {}, jnp.zeros((), jnp.int32))
    jstore = JaxStore(store.root)
    jres = jtransfer.make_head_trainer(
        JaxDataCfg(**data), JaxModelCfg(width_mult=0.35, dtype="float32",
                                        dropout=0.0),
        JaxTrainCfg(**kw), jfull,
        mesh=make_mesh(MeshSpec((("data", 1),)),
                       devices=jax.devices()[:1])).fit(
            jstore.table("feat_h"), jstore.table("feat_hv"))

    tx = tstep.make_optimizer(TrainCfg(**kw), ("backbone",))
    full = tstep.init_state(model, tx)
    trainer = transfer.make_head_trainer(DataCfg(**data), MCFG,
                                         TrainCfg(**kw), full, device="cpu")
    res = trainer.fit(ft, fv)
    for key in ("loss", "val_loss", "accuracy", "val_accuracy"):
        np.testing.assert_allclose([r[key] for r in res.history],
                                   [r[key] for r in jres.history], rtol=1e-5)
    head = res.state.model.head
    np.testing.assert_allclose(head.weight.detach().numpy().T,
                               np.asarray(jres.state.params["head"]["kernel"]),
                               rtol=1e-5, atol=1e-6)
    before = full.model.head.weight.detach().clone()
    merged = transfer.merge_head_params(full, res.state)
    assert torch.equal(merged.model.head.weight, head.weight)
    assert torch.equal(full.model.head.weight, before)  # left as it was
    assert merged.model is not full.model
    assert merged.step == res.state.step == 2 * (40 // 8)


def test_train_frozen_via_features_refuses_unfrozen_and_runs(tables, tmp_path):
    store, train, val = tables
    data = DataCfg(img_height=IMG, img_width=IMG, loader_workers=1)
    cfg = TrainCfg(batch_size=8, epochs=1, warmup_epochs=0)
    with pytest.raises(ValueError, match="freeze_base"):
        transfer.prepare_feature_tables(
            data, ModelCfg(width_mult=0.35, freeze_base=False), cfg, train,
            val, store, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.raises(ValueError, match="auto-unfroze"):
            transfer.prepare_feature_tables(
                data, ModelCfg(width_mult=0.35), cfg, train, val, store,
                device="cpu")
        res = transfer.train_frozen_via_features(
            data, MCFG, cfg, train, val, store, feature_batch=16,
            device="cpu")
    assert res.epochs_run == 1 and np.isfinite(res.val_loss)
    logits = res.state.model.eval()(torch.from_numpy(_images(val)))
    assert logits.shape == (16, 5) and torch.isfinite(logits).all()
