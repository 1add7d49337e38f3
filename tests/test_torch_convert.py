"""The port's pretrained-weight path (``ddw_tpu_torch.models.convert`` and
``export``) against ``ddw_tpu``'s on the CPU: the torchvision MobileNetV2
and ResNet converters and the Keras one give the JAX package's trees
exactly, on hand-built state_dicts (no torchvision); both exports round-trip;
``.npz`` artifacts written by either package load in the other;
``load_pretrained`` refuses a mismatch; and ``model.pretrained_path`` gives
``Trainer`` and the cached-feature path the JAX package's initial weights."""

import os

import jax
import numpy as np
import pytest
import torch

import ddw_tpu.models.convert as jconv
import ddw_tpu.models.export as jexp
from ddw_tpu_torch.models import convert as tconv
from ddw_tpu_torch.models import export as texp
from ddw_tpu_torch.models.layers import init_weights
from ddw_tpu_torch.models.registry import build_model
from ddw_tpu_torch.utils.config import DataCfg, ModelCfg, TrainCfg


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_trees_equal(a, b, rtol=0.0):
    fa, fb = _flat(a), _flat(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        assert fa[k].shape == fb[k].shape, k
        if rtol:
            np.testing.assert_allclose(fa[k], fb[k], rtol=rtol, atol=1e-7,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


def _backbone_vars(width=0.35, seed=0):
    """Random MobileNetV2 backbone variables (every BatchNorm leaf
    non-trivial) in the flax layout."""
    model = build_model(ModelCfg(width_mult=width, freeze_base=False))
    init_weights(model, torch.Generator().manual_seed(seed))
    v = tconv.to_flax_variables(model)
    return {"params": v["params"]["backbone"],
            "batch_stats": v["batch_stats"]["backbone"]}


def test_mobilenet_exports_and_converters_equal_ddw_tpus():
    bb = _backbone_vars()
    sd = texp.export_torch_mobilenet_v2(bb)
    jsd = jexp.export_torch_mobilenet_v2(bb)
    assert sd.keys() == jsd.keys()
    for k in sd:
        np.testing.assert_array_equal(sd[k], jsd[k], err_msg=k)
    # a state_dict of torch tensors, as torch.load gives one
    tsd = {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}
    conv = tconv.convert_torch_mobilenet_v2(tsd)
    _assert_trees_equal(conv, jconv.convert_torch_mobilenet_v2(sd))
    _assert_trees_equal(conv, bb, rtol=1e-6)   # the fold, both ways

    kw = texp.export_keras_mobilenet_v2(bb)
    jkw = jexp.export_keras_mobilenet_v2(bb)
    assert kw.keys() == jkw.keys()
    for k in kw:
        np.testing.assert_array_equal(kw[k], jkw[k], err_msg=k)
    kconv = tconv.convert_keras_mobilenet_v2(kw)
    _assert_trees_equal(kconv, jconv.convert_keras_mobilenet_v2(jkw))
    _assert_trees_equal(kconv, bb, rtol=1e-6)


def _torch_resnet_state_dict(depth, seed=0):
    """A torchvision-layout ResNet state_dict built by hand: stem conv1 /
    bn1, layer{s}.{i}.conv{j} / bn{j} and downsample.0 / .1, fc; random
    weights and BatchNorm statistics."""
    from ddw_tpu_torch.models.resnet import _CONFIGS

    rng = np.random.RandomState(seed)
    sd = {}

    def conv(name, cout, cin, k):
        sd[f"{name}.weight"] = rng.randn(cout, cin, k, k).astype(np.float32)

    def bn(name, c):
        sd[f"{name}.weight"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        sd[f"{name}.bias"] = rng.normal(0, 0.5, c).astype(np.float32)
        sd[f"{name}.running_mean"] = rng.normal(0, 0.5, c).astype(np.float32)
        sd[f"{name}.running_var"] = rng.uniform(0.5, 2, c).astype(np.float32)
        sd[f"{name}.num_batches_tracked"] = np.asarray(7, np.int64)

    counts, bottleneck = _CONFIGS[depth]
    conv("conv1", 64, 3, 7)
    bn("bn1", 64)
    inp = 64
    for stage, n in enumerate(counts):
        width = 64 * 2 ** stage
        for i in range(n):
            stride = 2 if (stage > 0 and i == 0) else 1
            t = f"layer{stage + 1}.{i}"
            out = width * 4 if bottleneck else width
            shapes = ([(width, inp, 1), (width, width, 3), (out, width, 1)]
                      if bottleneck else [(width, inp, 3), (width, width, 3)])
            for j, (co, ci, k) in enumerate(shapes):
                conv(f"{t}.conv{j + 1}", co, ci, k)
                bn(f"{t}.bn{j + 1}", co)
            if stride != 1 or inp != out:
                conv(f"{t}.downsample.0", out, inp, 1)
                bn(f"{t}.downsample.1", out)
            inp = out
    sd["fc.weight"] = rng.randn(1000, inp).astype(np.float32)
    sd["fc.bias"] = np.zeros(1000, np.float32)
    return sd


@pytest.mark.parametrize("depth", [18, 34, 50])
def test_resnet_converter_equals_ddw_tpus(depth):
    sd = _torch_resnet_state_dict(depth)
    assert tconv.infer_torch_resnet_depth(sd) == \
        jconv.infer_torch_resnet_depth(sd) == depth
    conv = tconv.convert_torch_resnet(sd, depth)
    _assert_trees_equal(conv, jconv.convert_torch_resnet(sd, depth))
    # the artifact fits the port's ResNet at width 1.0, every leaf
    model = build_model(ModelCfg(name=f"resnet{depth}", freeze_base=False))
    v = tconv.to_flax_variables(model)
    _assert_trees_equal(
        jax.tree_util.tree_map(np.shape, conv),
        jax.tree_util.tree_map(np.shape, {"params": v["params"]["backbone"],
                                          "batch_stats": v["batch_stats"][
                                              "backbone"]}))
    with pytest.raises(KeyError, match="unsupported resnet depth"):
        tconv.convert_torch_resnet(sd, 101)


def test_artifacts_cross_load_both_ways(tmp_path):
    bb = _backbone_vars(seed=1)
    ours, theirs = str(tmp_path / "ours.npz"), str(tmp_path / "theirs.npz")
    tconv.save_pretrained(ours, bb)
    jconv.save_pretrained(theirs, bb)
    with np.load(ours) as a, np.load(theirs) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
    model = build_model(ModelCfg(width_mult=0.35, freeze_base=False))
    init_weights(model, torch.Generator().manual_seed(5))
    fresh = tconv.to_flax_variables(model)
    for path in (ours, theirs):
        merged = tconv.load_pretrained(fresh, path)
        jmerged = jconv.load_pretrained(fresh, path)
        _assert_trees_equal(merged, jmerged)
        _assert_trees_equal({"params": merged["params"]["backbone"],
                             "batch_stats": merged["batch_stats"]["backbone"]},
                            bb)
        np.testing.assert_array_equal(merged["params"]["head"]["kernel"],
                                      fresh["params"]["head"]["kernel"])
    loaded = tconv.load_pretrained_module(model, theirs)
    _assert_trees_equal(tconv.to_flax_variables(loaded),
                        tconv.load_pretrained(fresh, theirs))


def test_load_pretrained_refuses_a_mismatch(tmp_path):
    bb = _backbone_vars()
    fresh = tconv.to_flax_variables(
        build_model(ModelCfg(width_mult=1.0, freeze_base=False)))
    art = str(tmp_path / "a.npz")
    tconv.save_pretrained(art, bb)           # width 0.35 into width 1.0
    with pytest.raises(ValueError, match="shape mismatch"):
        tconv.load_pretrained(fresh, art)
    bb["params"]["Extra_0"] = {"kernel": np.zeros(3, np.float32)}
    tconv.save_pretrained(art, bb)
    small = tconv.to_flax_variables(
        build_model(ModelCfg(width_mult=0.35, freeze_base=False)))
    with pytest.raises(KeyError, match="not in model variables"):
        tconv.load_pretrained(small, art)


def test_load_keras_weights_npz_and_h5(tmp_path):
    kw = texp.export_keras_mobilenet_v2(_backbone_vars())
    npz = str(tmp_path / "k.npz")
    np.savez(npz, **{k + ":0": v for k, v in kw.items()})
    got = tconv.load_keras_weights(npz)
    assert got.keys() == kw.keys()
    try:
        import h5py
    except ImportError:
        with pytest.raises(ImportError, match="h5py"):
            tconv.load_keras_weights(str(tmp_path / "w.h5"))
        return
    h5 = str(tmp_path / "w.h5")
    with h5py.File(h5, "w") as f:   # save_weights' layer/layer/weight:0
        for k, v in kw.items():
            layer, weight = k.split("/")
            f.create_dataset(f"{layer}/{layer}/{weight}:0", data=v)
    from_h5 = tconv.load_keras_weights(h5)
    assert from_h5.keys() == kw.keys()
    for k in kw:
        np.testing.assert_array_equal(from_h5[k], kw[k])
    assert jconv.load_keras_weights(h5).keys() == kw.keys()


def test_h5_needs_h5py_and_says_so(tmp_path, monkeypatch):
    import builtins

    real = builtins.__import__

    def no_h5py(name, *a, **k):
        if name == "h5py":
            raise ImportError("No module named 'h5py'")
        return real(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_h5py)
    with pytest.raises(ImportError, match="needs h5py"):
        tconv.load_keras_weights(str(tmp_path / "w.h5"))


def test_cli_writes_ddw_tpus_artifact(tmp_path):
    bb = _backbone_vars(seed=2)
    pt = str(tmp_path / "mnv2.pt")
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in
                texp.export_torch_mobilenet_v2(bb).items()}, pt)
    keras = str(tmp_path / "keras.npz")
    np.savez(keras, **texp.export_keras_mobilenet_v2(bb))
    rn = str(tmp_path / "rn18.pt")
    torch.save({k: torch.from_numpy(v)
                for k, v in _torch_resnet_state_dict(18).items()}, rn)
    for src in (pt, keras, rn):
        ours, theirs = str(tmp_path / "o.npz"), str(tmp_path / "t.npz")
        tconv.main([src, ours])
        jconv.main([src, theirs])
        with np.load(ours) as a, np.load(theirs) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k])
    bad = str(tmp_path / "bad.npz")
    np.savez(bad, x=np.zeros(2))
    with pytest.raises(SystemExit, match="not a Keras MobileNetV2"):
        tconv.main([bad, str(tmp_path / "o.npz")])


def _artifact(tmp_path, width=0.35):
    art = str(tmp_path / "backbone.npz")
    tconv.save_pretrained(art, _backbone_vars(width, seed=3))
    return art


def test_trainer_pretrained_path_gives_jax_initial_weights(tmp_path):
    """``model.pretrained_path`` merges the artifact over the seeded init in
    the port's Trainer as ``ddw_tpu.train.step.init_state`` does: the
    backbone's weights and statistics are the artifact's in both (the head
    is each package's own draw), the backbone is frozen and the registry's
    frozen-random guard stays quiet."""
    import warnings

    from ddw_tpu.models.registry import build_model as jbuild
    from ddw_tpu.train.step import init_state
    from ddw_tpu.utils.config import ModelCfg as JModelCfg
    from ddw_tpu.utils.config import TrainCfg as JTrainCfg
    from ddw_tpu_torch.train.trainer import Trainer

    art = _artifact(tmp_path)
    kw = dict(name="mobilenet_v2", width_mult=0.35, dtype="float32",
              freeze_base=True, pretrained_path=art)
    jstate, _ = init_state(jbuild(JModelCfg(**kw)), JModelCfg(**kw),
                           JTrainCfg(batch_size=2), (32, 32, 3),
                           jax.random.PRNGKey(0))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        trainer = Trainer(DataCfg(img_height=32, img_width=32),
                          ModelCfg(**kw), TrainCfg(batch_size=2),
                          device="cpu")
    state, tx = trainer._init_state()
    assert trainer.model.freeze_base
    assert tx.frozen_prefixes == ("backbone",)
    got = tconv.to_flax_variables(state.model)
    want = {"params": jax.tree_util.tree_map(np.asarray, jstate.params),
            "batch_stats": jax.tree_util.tree_map(np.asarray,
                                                  jstate.batch_stats)}
    for coll in ("params", "batch_stats"):
        _assert_trees_equal(got[coll]["backbone"], want[coll]["backbone"])
    assert got["params"]["head"]["kernel"].shape == \
        want["params"]["head"]["kernel"].shape


def test_cached_features_take_the_pretrained_backbone(tmp_path):
    """``train/transfer.py``'s frozen model takes ``model.pretrained_path``
    too: its backbone is the artifact's, and so is the feature cache's
    fingerprint."""
    from PIL import Image

    from ddw_tpu_torch.data.prep import prepare_flowers
    from ddw_tpu_torch.data.store import TableStore
    from ddw_tpu_torch.train.transfer import (model_fingerprint,
                                              prepare_feature_tables)

    src = tmp_path / "raw"
    rng = np.random.RandomState(0)
    for c in ("a", "b"):
        os.makedirs(src / c)
        for i in range(4):
            Image.fromarray(rng.randint(0, 255, (40, 40, 3), np.uint8)).save(
                src / c / f"{i}.jpg")
    store = TableStore(str(tmp_path / "tables"))
    train, val, _ = prepare_flowers(str(src), store, sample_fraction=1.0,
                                    train_fraction=0.75, shard_size=4)
    art = _artifact(tmp_path)
    mcfg = ModelCfg(width_mult=0.35, dtype="float32", num_classes=2,
                    pretrained_path=art)
    data = DataCfg(img_height=32, img_width=32)
    ft, fv, full, _ = prepare_feature_tables(data, mcfg, TrainCfg(), train,
                                             val, store, feature_batch=2,
                                             device="cpu")
    v = tconv.to_flax_variables(full)
    _assert_trees_equal({"params": v["params"]["backbone"],
                         "batch_stats": v["batch_stats"]["backbone"]},
                        _backbone_vars(0.35, seed=3))
    assert ft.meta["backbone_fingerprint"] == model_fingerprint(full)
    assert ft.num_records == train.num_records
