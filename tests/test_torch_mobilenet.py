"""The PyTorch port's MobileNetV2 (``ddw_tpu_torch.models``) against the JAX
model on the CPU: eval-mode logits from the same flax variables (random,
non-trivial BatchNorm statistics included), the exact round trip of the
weight mapping, and the registry's refusals."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddw_tpu.models.mobilenet_v2 import MobileNetV2 as JaxMobileNetV2
from ddw_tpu_torch.models.convert import load_flax_variables, to_flax_variables
from ddw_tpu_torch.models.mobilenet_v2 import init_weights
from ddw_tpu_torch.models.registry import build_model
from ddw_tpu_torch.utils.config import ModelCfg


def _jax_model(width, dtype, dw_impl):
    return JaxMobileNetV2(width_mult=width, dtype=dtype, dw_impl=dw_impl,
                          dropout=0.0)


@functools.lru_cache(maxsize=None)
def _init_variables(width):
    """Flax variables with random, non-trivial running statistics (BN must
    use mean/var). dw_impl does not change the param tree: init through the
    fast arm, once per width."""
    init = jax.jit(_jax_model(width, jnp.float32, "xla").init,
                   static_argnames="train")
    v = init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 32, 32, 3)),
             train=False)
    v = jax.tree_util.tree_map(np.array, v)
    rng = np.random.RandomState(1)
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            v["batch_stats"])[0]:
        var = jax.tree_util.keystr(path).endswith("['var']")
        leaf[...] = rng.uniform(0.5, 1.5, leaf.shape) if var else \
            rng.uniform(-0.2, 0.2, leaf.shape)
    return v


def _jax_variables(width):
    return jax.tree_util.tree_map(np.copy, _init_variables(width))


def _jax_logits(width, dtype, dw_impl, v, x):
    apply = jax.jit(_jax_model(width, dtype, dw_impl).apply,
                    static_argnames="train")
    return np.asarray(apply(v, jnp.asarray(x), train=False))


@pytest.mark.parametrize("width,dw_impl", [(0.35, "pallas_interpret"),
                                           (1.0, "pallas_interpret"),
                                           (0.35, "xla")])
def test_f32_logits_match_jax(width, dw_impl):
    x = np.random.RandomState(0).randn(2, 32, 32, 3).astype(np.float32)
    v = _jax_variables(width)
    ref = _jax_logits(width, jnp.float32, dw_impl, v, x)
    # "pallas" on CPU tensors runs the kernel's plain version
    port_impl = "pallas" if dw_impl == "pallas_interpret" else dw_impl
    model = build_model(ModelCfg(width_mult=width, dtype="float32",
                                 dw_impl=port_impl))
    load_flax_variables(model, v).eval()
    with torch.inference_mode():
        got = model(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (2, 5)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4)


def test_bf16_logits_track_jax():
    # bf16 rounds at the same places in both (input, conv weights incl. the
    # depthwise taps, ReLU6 output) but the convs sum in another order, so
    # agreement is to bf16 resolution through the depth. The depthwise arm's
    # own bf16 parity with the Pallas kernel is test_torch_depthwise's.
    x = np.random.RandomState(1).randn(4, 32, 32, 3).astype(np.float32)
    v = _jax_variables(0.35)
    ref = _jax_logits(0.35, jnp.bfloat16, "xla", v, x)
    model = build_model(ModelCfg(width_mult=0.35, dtype="bfloat16",
                                 dw_impl="pallas"))
    load_flax_variables(model, v).eval()
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0.05,
                               atol=0.05 * np.abs(ref).max())


def test_weights_round_trip_exactly():
    v = _jax_variables(0.35)
    model = load_flax_variables(build_model(ModelCfg(width_mult=0.35)), v)
    back = to_flax_variables(model)
    flat_v = jax.tree_util.tree_flatten_with_path(v)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_v) == len(flat_b)
    for path, leaf in flat_v:
        np.testing.assert_array_equal(flat_b[path], leaf)
        assert flat_b[path].dtype == np.float32


def test_load_refuses_mismatched_trees():
    v = _jax_variables(0.35)
    with pytest.raises(ValueError, match="does not fit"):
        load_flax_variables(build_model(ModelCfg(width_mult=1.0)), v)
    del v["params"]["head"]["bias"]
    with pytest.raises(ValueError, match="missing"):
        load_flax_variables(build_model(ModelCfg(width_mult=0.35)), v)


def test_init_weights_is_seeded():
    def draw(seed):
        m = build_model(ModelCfg(width_mult=0.35))
        init_weights(m, torch.Generator().manual_seed(seed))
        return to_flax_variables(m)

    a, b, c = draw(0), draw(0), draw(1)
    la, lb, lc = (jax.tree_util.tree_leaves(t) for t in (a, b, c))
    assert all(np.array_equal(p, q) for p, q in zip(la, lb))
    assert not all(np.array_equal(p, q) for p, q in zip(la, lc))
    assert all(np.isfinite(p).all() for p in la)


@pytest.mark.parametrize("cfg,err,match", [
    (ModelCfg(name="resnet50"), NotImplementedError, "ROADMAP.md"),
    (ModelCfg(name="vit"), NotImplementedError, "not yet ported"),
    (ModelCfg(name="nope"), KeyError, "unknown model"),
    (ModelCfg(stem_s2d=True), NotImplementedError, "stem_s2d"),
    (ModelCfg(lora_rank=4), ValueError, "LoRA"),
    (ModelCfg(dw_impl="cudnn"), ValueError, "dw_impl"),
    (ModelCfg(dtype="float16"), ValueError, "dtype"),
])
def test_registry_refusals(cfg, err, match):
    with pytest.raises(err, match=match):
        build_model(cfg)
