"""The port's SmallCNN (``ddw_tpu_torch.models.cnn``) against
``ddw_tpu.models.cnn`` on the CPU: eval logits (f32 within 1e-5 of the
largest |logit|, at even and odd sizes, so the stride-2 SAME split is held),
the flax-layout round trip, one adam step with dropout 0 (loss within 1e-5
relative, updated params within 2e-5 where adam moves them by about the
lr of 1e-2), and a 1-epoch ``Trainer.fit`` on a tiny table. Width 32 (the
model's own), 32x32 images."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddw_tpu.models.cnn import SmallCNN as JaxSmallCNN
from ddw_tpu.runtime.mesh import MeshSpec, make_mesh
from ddw_tpu.train import step as jstep
from ddw_tpu.utils.config import TrainCfg as JaxTrainCfg
from ddw_tpu_torch.data.store import Record, TableStore
from ddw_tpu_torch.models.cnn import GroupNorm, SmallCNN
from ddw_tpu_torch.models.convert import load_flax_variables, to_flax_variables
from ddw_tpu_torch.models.registry import build_model
from ddw_tpu_torch.train import step as tstep
from ddw_tpu_torch.train.trainer import Trainer
from ddw_tpu_torch.utils.config import DataCfg, ModelCfg, TrainCfg

IMG = 32


def _variables(seed=0, size=IMG):
    """flax variables with GroupNorm scales and biases moved off 1 and 0."""
    model = JaxSmallCNN(num_classes=5, dtype=jnp.float32, dropout=0.0)
    v = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, size, size, 3)))
    v = jax.tree_util.tree_map(np.array, v)
    rng = np.random.RandomState(seed + 1)
    for i in range(3):
        gn = v["params"][f"GroupNorm_{i}"]
        gn["scale"][...] = rng.uniform(0.5, 1.5, gn["scale"].shape)
        gn["bias"][...] = rng.uniform(-0.3, 0.3, gn["bias"].shape)
    v["params"]["head"]["bias"][...] = rng.uniform(-0.1, 0.1, 5)
    return v


def _images(n, seed, h=IMG, w=IMG):
    return np.random.RandomState(seed).uniform(
        -1, 1, (n, h, w, 3)).astype(np.float32)


def _port(v, dtype="float32"):
    return load_flax_variables(
        build_model(ModelCfg(name="small_cnn", dtype=dtype, dropout=0.0)), v)


@pytest.mark.parametrize("h,w", [(32, 32), (33, 30)])
def test_eval_logits_match_jax_f32(h, w):
    v = _variables()
    x = _images(6, 1, h, w)
    ref = np.asarray(JaxSmallCNN(dtype=jnp.float32).apply(v, jnp.asarray(x)))
    got = _port(v).eval()(torch.from_numpy(x)).detach().numpy()
    assert got.shape == (6, 5) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


def test_bf16_logits_track_jax():
    v = _variables()
    x = _images(6, 2)
    ref = np.asarray(JaxSmallCNN(dtype=jnp.bfloat16).apply(v, jnp.asarray(x)))
    got = _port(v, "bfloat16").eval()(torch.from_numpy(x)).detach().numpy()
    # bf16 convs on both sides, rounded at different points: 2% of the scale
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=2e-2 * np.abs(ref).max())


def test_registry_layout_and_groupnorm_conventions():
    model = build_model(ModelCfg(name="small_cnn", num_classes=7))
    assert isinstance(model, SmallCNN) and model.dtype == torch.bfloat16
    assert model.frozen_prefixes(True) == ()
    v = _variables()
    back = to_flax_variables(_port(v))
    assert set(back) == {"params"}
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(v)):
        np.testing.assert_array_equal(a, b)
    # flax's epsilon (1e-6) and fast variance, not torch.nn.GroupNorm's
    x = torch.full((1, 2, 2, 8), 3.0)
    x[0, 0, 0] += 1e-3
    gn = GroupNorm(8, num_groups=8)
    var = (x * x).mean((1, 2)) - x.mean((1, 2)) ** 2
    want = (x - x.mean((1, 2), keepdim=True)) * torch.rsqrt(
        var.clamp_min(0).reshape(1, 1, 1, 8) + 1e-6)
    torch.testing.assert_close(gn(x), want, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="groups"):
        GroupNorm(12, num_groups=8)


def test_one_adam_step_matches_jax():
    v = _variables(3)
    x = _images(8, 4)
    y = np.random.RandomState(5).randint(0, 5, 8).astype(np.int32)
    kw = dict(optimizer="adam", learning_rate=1e-2)
    jmodel = JaxSmallCNN(dtype=jnp.float32, dropout=0.0)
    tx = jstep.make_optimizer(JaxTrainCfg(**kw))
    jstate = jstep.TrainState(v["params"], {}, tx.init(v["params"]),
                              jnp.zeros((), jnp.int32))
    mesh = make_mesh(MeshSpec((("data", 1),)), devices=jax.devices()[:1])
    jstate, jm = jstep.make_train_step(jmodel, tx, mesh, donate=False)(
        jstate, jnp.asarray(x), jnp.asarray(y), jax.random.PRNGKey(0))

    model = _port(v)
    opt = tstep.make_optimizer(TrainCfg(**kw))
    state = tstep.init_state(model, opt)
    m = tstep.make_train_step(opt)(state, torch.from_numpy(x),
                                   torch.from_numpy(y), 0)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m["accuracy"]), float(jm["accuracy"]))
    got = to_flax_variables(model)["params"]
    ref = jax.tree_util.tree_map(np.asarray, jstate.params)
    for (path, r), g in zip(jax.tree_util.tree_flatten_with_path(ref)[0],
                            jax.tree_util.tree_leaves(got)):
        # adam moves every leaf by about lr (1e-2); 1e-5 absolute plus
        # 1e-3 of the lr
        assert np.abs(g - r).max() <= 2e-5, \
            jax.tree_util.keystr(path)


def test_trainer_fits_one_epoch(tmp_path):
    rng = np.random.RandomState(0)
    store = TableStore(str(tmp_path))
    meta = {"encoding": "raw_u8", "height": IMG, "width": IMG}

    def recs(n):
        for i in range(n):
            img = rng.randint(0, 80, (IMG, IMG, 3)) + 150 * (
                np.arange(3) == i % 3)
            yield Record(f"{i}", img.clip(0, 255).astype(np.uint8).tobytes(),
                         f"c{i % 3}", i % 3)

    train = store.write("train", recs(48), 16, meta)
    val = store.write("val", recs(16), 16, meta)
    res = Trainer(DataCfg(img_height=IMG, img_width=IMG, loader_workers=1,
                          shuffle_buffer=32),
                  ModelCfg(name="small_cnn", num_classes=3, dtype="float32"),
                  TrainCfg(batch_size=8, epochs=1, warmup_epochs=0),
                  device="cpu").fit(train, val)
    assert res.epochs_run == 1 and res.state.step == 48 // 8
    row = res.history[0]
    assert np.isfinite([row["loss"], row["val_loss"]]).all()
    assert 0.0 <= row["val_accuracy"] <= 1.0
