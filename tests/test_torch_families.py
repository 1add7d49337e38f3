"""The port's other vision families (``ddw_tpu_torch.models.resnet``,
``convnext``, ``vit`` and ``ops.s2d_conv``) against the JAX package on the
CPU at small size: the same flax variables (random, every leaf non-trivial)
give f32 logits within 1e-4, bf16 logits that track, and one training
step's gradients; the SAME-padding traps are pinned, and every family
round-trips its weights exactly."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ddw_tpu.models.convnext import ConvNeXt as JaxConvNeXt
from ddw_tpu.models.mobilenet_v2 import MobileNetV2 as JaxMobileNetV2
from ddw_tpu.models.resnet import ResNet as JaxResNet
from ddw_tpu.models.vit import ViT as JaxViT
from ddw_tpu.ops.s2d_conv import space_to_depth_conv as jax_s2d
from ddw_tpu_torch.models.convert import load_flax_variables, to_flax_variables
from ddw_tpu_torch.models.convnext import ConvNeXt
from ddw_tpu_torch.models.layers import init_params
from ddw_tpu_torch.models.mobilenet_v2 import MobileNetV2
from ddw_tpu_torch.models.registry import build_model
from ddw_tpu_torch.models.resnet import ResNet, max_pool_same
from ddw_tpu_torch.models.vit import ViT
from ddw_tpu_torch.ops.depthwise_conv import conv2d_same
from ddw_tpu_torch.ops.s2d_conv import space_to_depth_conv
from ddw_tpu_torch.utils.config import ModelCfg

_DT = {"float32": (jnp.float32, torch.float32),
       "bfloat16": (jnp.bfloat16, torch.bfloat16)}

# name -> (JAX module factory, port module factory), both by dtype name;
# vit at hidden 96 over 2 heads is head dim 48, ViT's own
_FAMILIES = {
    "resnet18": (
        lambda d: JaxResNet(depth=18, width_mult=0.25, dropout=0.0,
                            dtype=_DT[d][0]),
        lambda d: ResNet(depth=18, width_mult=0.25, dropout=0.0,
                         dtype=_DT[d][1])),
    "resnet50": (
        lambda d: JaxResNet(depth=50, width_mult=0.25, dropout=0.0,
                            dtype=_DT[d][0]),
        lambda d: ResNet(depth=50, width_mult=0.25, dropout=0.0,
                         dtype=_DT[d][1])),
    "resnet18_s2d": (
        lambda d: JaxResNet(depth=18, width_mult=0.25, dropout=0.0,
                            dtype=_DT[d][0], stem_s2d=True),
        lambda d: ResNet(depth=18, width_mult=0.25, dropout=0.0,
                         dtype=_DT[d][1], stem_s2d=True)),
    "convnext_tiny": (
        lambda d: JaxConvNeXt(variant="tiny", width_mult=0.125, dropout=0.0,
                              dtype=_DT[d][0]),
        lambda d: ConvNeXt(variant="tiny", width_mult=0.125, dropout=0.0,
                           dtype=_DT[d][1])),
    "vit": (
        lambda d: JaxViT(hidden=96, num_heads=2, mlp_dim=384, depth=2,
                         dropout=0.0, dtype=_DT[d][0]),
        lambda d: ViT(hidden=96, num_heads=2, mlp_dim=384, depth=2,
                      dropout=0.0, dtype=_DT[d][1], image_size=(32, 32))),
    "mobilenet_v2_s2d": (
        lambda d: JaxMobileNetV2(width_mult=0.35, dropout=0.0,
                                 dtype=_DT[d][0], stem_s2d=True),
        lambda d: MobileNetV2(width_mult=0.35, dropout=0.0, dtype=_DT[d][1],
                              stem_s2d=True)),
}


@functools.lru_cache(maxsize=None)
def _init_variables(name):
    """Random flax variables of the JAX module, every leaf non-trivial: the
    tree's shapes from ``eval_shape`` (no compile), kernels normal at
    1/sqrt(fan_in), scales around 1, biases, GRN and the position embedding
    around 0 (flax's zero-initialised ConvNeXt projections and GRN would
    make each block the identity), random running statistics."""
    model = _FAMILIES[name][0]("float32")
    shapes = jax.eval_shape(functools.partial(model.init, train=False),
                            {"params": jax.random.PRNGKey(0)},
                            jnp.zeros((1, 32, 32, 3)))
    rng = np.random.RandomState(1)

    def draw(path, leaf):
        key, shape = jax.tree_util.keystr(path), leaf.shape
        if key.endswith("['kernel']"):
            if len(shape) == 3 and "['out']" not in key:
                fan_in = shape[0]          # DenseGeneral [embed, heads, hd]
            else:
                fan_in = int(np.prod(shape[:-1]))
            return rng.normal(0, fan_in ** -0.5, shape).astype(np.float32)
        if key.endswith("['var']"):
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        if key.endswith("['scale']"):
            return rng.normal(1.0, 0.1, shape).astype(np.float32)
        std = 0.02 if key.endswith("['pos_embed']") else 0.1
        return rng.normal(0, std, shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _variables(name):
    return jax.tree_util.tree_map(np.copy, _init_variables(name))


def _apply(name, dtype):
    model = _FAMILIES[name][0](dtype)
    return jax.jit(lambda v, x: model.apply(v, x, train=False))


def _port(name, dtype, v):
    model = _FAMILIES[name][1](dtype)
    return load_flax_variables(model, v)


def _images(n, seed):
    return np.random.RandomState(seed).randn(n, 32, 32, 3).astype(np.float32)


@pytest.mark.parametrize("name", sorted(_FAMILIES))
def test_f32_logits_match_jax(name):
    x = _images(2, 0)
    v = _variables(name)
    ref = np.asarray(_apply(name, "float32")(v, jnp.asarray(x)))
    model = _port(name, "float32", v).eval()
    with torch.inference_mode():
        got = model(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (2, 5)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", ["resnet50", "convnext_tiny", "vit"])
def test_bf16_logits_track_jax(name):
    # bf16 rounds at the same places in both, but the library convolutions
    # and products sum in another order: agreement to bf16 resolution
    # through the depth
    x = _images(4, 1)
    v = _variables(name)
    ref = np.asarray(_apply(name, "bfloat16")(v, jnp.asarray(x)))
    model = _port(name, "bfloat16", v).eval()
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0.05,
                               atol=0.05 * np.abs(ref).max())


def _jax_grads(name, v, x, y):
    model = _FAMILIES[name][0]("float32")
    stats = v.get("batch_stats")

    def loss_fn(params):
        variables = {"params": params}
        if stats:
            variables["batch_stats"] = stats
            logits, _ = model.apply(variables, x, train=True,
                                    mutable=["batch_stats"])
        else:
            logits = model.apply(variables, x, train=True)
        logp = jax.nn.log_softmax(logits)
        return -jnp.mean(jnp.take_along_axis(logp, y[:, None], 1))

    loss, g = jax.jit(jax.value_and_grad(loss_fn))(v["params"])
    return float(loss), jax.tree_util.tree_map(np.asarray, g)


@pytest.mark.parametrize("name", ["resnet18", "convnext_tiny", "vit"])
def test_train_step_gradients_match_jax(name):
    x = _images(8, 2)
    y = np.arange(8) % 5
    v = _variables(name)
    loss_j, g_j = _jax_grads(name, v, jnp.asarray(x), jnp.asarray(y))
    model = _port(name, "float32", v).train()
    logits = model(torch.from_numpy(x))
    loss = F.cross_entropy(logits, torch.from_numpy(y))
    loss.backward()
    assert abs(loss.item() - loss_j) <= 1e-5 * max(1.0, abs(loss_j))
    # the port's gradients in the flax layout: copy them over the weights
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(p.grad)
    grads = to_flax_variables(model)["params"]
    flat_j = dict(jax.tree_util.tree_flatten_with_path(g_j)[0])
    flat_p = dict(jax.tree_util.tree_flatten_with_path(grads)[0])
    assert flat_j.keys() == flat_p.keys()
    for path, gj in flat_j.items():
        if "['key']['bias']" in jax.tree_util.keystr(path):
            # softmax is invariant to the key projection's bias: its exact
            # gradient is zero, and both sides hold rounding noise there
            assert np.abs(gj).max() < 1e-6
            continue
        top = max(float(np.abs(gj).max()), 1e-6)
        gap = float(np.abs(flat_p[path] - gj).max())
        assert gap <= 2e-3 * top, (jax.tree_util.keystr(path), gap, top)


@pytest.mark.parametrize("name", sorted(_FAMILIES))
def test_weights_round_trip_exactly(name):
    v = _variables(name)
    back = to_flax_variables(_port(name, "float32", v))
    flat_v = jax.tree_util.tree_flatten_with_path(v)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_v) == len(flat_b)
    for path, leaf in flat_v:
        np.testing.assert_array_equal(flat_b[path], leaf)


@pytest.mark.parametrize("k,hw", [(3, (32, 32)), (7, (32, 32)),
                                  (7, (224, 224)), (5, (18, 30))])
def test_space_to_depth_conv_is_a_stride2_conv(k, hw):
    rng = np.random.RandomState(k)
    x = rng.randn(2, *hw, 3).astype(np.float32)
    w = rng.randn(k, k, 3, 8).astype(np.float32)
    got = space_to_depth_conv(torch.from_numpy(x), torch.from_numpy(w))
    plain = conv2d_same(torch.from_numpy(x),
                        torch.from_numpy(w).permute(3, 2, 0, 1), stride=2)
    ref = np.asarray(jax_s2d(jnp.asarray(x), jnp.asarray(w)))
    assert got.shape == plain.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-4)
    with pytest.raises(ValueError, match="odd square"):
        space_to_depth_conv(torch.from_numpy(x), torch.zeros(4, 4, 3, 8))


def test_same_padding_traps_are_pinned():
    """JAX's SAME pads a 7x7 stride-2 conv on 224 by (2, 3), where torch's
    ``padding=3`` pads (3, 3), and the 3x3 stride-2 max pool on 112 by (0,
    1) with -inf: the port's stem and pool follow JAX, and the torch
    padding would give other numbers."""
    rng = np.random.RandomState(3)
    x = rng.randn(1, 224, 224, 3).astype(np.float32)
    w = rng.randn(7, 7, 3, 4).astype(np.float32)
    ref = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (2, 2), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC")))
    xt, wt = torch.from_numpy(x), torch.from_numpy(w).permute(3, 2, 0, 1)
    got = conv2d_same(xt, wt, stride=2).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-4)
    torch_pad = F.conv2d(xt.permute(0, 3, 1, 2), wt, stride=2,
                         padding=3).permute(0, 2, 3, 1).numpy()
    assert torch_pad.shape == ref.shape
    assert np.abs(torch_pad - ref).max() > 1.0
    # max pool: -inf padding on JAX's split, so a negative border survives
    y = -np.abs(rng.randn(1, 112, 112, 4)).astype(np.float32) - 1.0
    import flax.linen as nn

    ref = np.asarray(nn.max_pool(jnp.asarray(y), (3, 3), (2, 2), "SAME"))
    got = max_pool_same(torch.from_numpy(y)).numpy()
    np.testing.assert_array_equal(got, ref)
    zero_pad = F.max_pool2d(torch.from_numpy(y).permute(0, 3, 1, 2), 3, 2,
                            padding=1).permute(0, 2, 3, 1).numpy()
    assert not np.array_equal(zero_pad, ref)


def test_build_model_builds_every_family():
    for name in ("resnet18", "resnet34", "resnet50", "convnext_tiny",
                 "convnext_small", "vit"):
        cfg = ModelCfg(name=name, freeze_base=False, dtype="float32",
                       width_mult=0.125)
        m = build_model(cfg, image_size=(32, 32))
        init_params(m, torch.Generator().manual_seed(0))
        with torch.inference_mode():
            assert m.eval()(torch.zeros(1, 32, 32, 3)).shape == (1, 5)
    for name in ("mobilenet_v2", "resnet50"):
        m = build_model(ModelCfg(name=name, stem_s2d=True, width_mult=0.25,
                                 freeze_base=False))
        stem = m.backbone.ConvBN_0 if name == "mobilenet_v2" \
            else m.backbone.stem
        assert type(stem.Conv_0).__name__ == "S2DConv"
    vit = build_model(ModelCfg(name="vit", hidden=96, num_heads=2))
    assert vit.backbone_block0.mlp.fc1.kernel.shape == (96, 384)
    assert vit.pos_embed.shape == (1, 196, 96)
    with pytest.warns(UserWarning, match="random"):
        lora = build_model(ModelCfg(name="vit", lora_rank=4))
    assert lora.backbone_block0.attn.query.lora_a.shape == (192, 4)
    with pytest.raises(ValueError, match="unknown lora_targets"):
        build_model(ModelCfg(name="vit", lora_rank=4, lora_targets=("qkv",)))


def test_init_keeps_flax_zero_initialised_leaves():
    """ConvNeXt's ``project`` kernels and GRN parameters start at zero, as
    flax's initialisers give them, so every block is the identity at init;
    its other kernels are drawn."""
    m = ConvNeXt(variant="tiny", width_mult=0.125, dtype=torch.float32)
    init_params(m, torch.Generator().manual_seed(0))
    blk = m.backbone.stage0_block0
    assert torch.count_nonzero(blk.project.kernel) == 0
    assert torch.count_nonzero(blk.grn.gamma) == 0
    assert torch.count_nonzero(blk.grn.beta) == 0
    assert torch.count_nonzero(blk.expand.kernel) > 0
    x = torch.randn(1, 8, 8, 12)
    with torch.inference_mode():
        assert torch.equal(blk(x), x)
    jv = jax.jit(JaxConvNeXt(variant="tiny", width_mult=0.125).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    jblk = jv["params"]["backbone"]["stage0_block0"]
    assert not np.asarray(jblk["project"]["kernel"]).any()
    assert not np.asarray(jblk["grn"]["gamma"]).any()


def test_trainer_trains_only_vits_adapters_and_head_under_lora():
    """``model.lora_rank`` on ViT: the trainer's optimizer updates the
    adapters and the head, and no base weight (``ddw_tpu.train.step.
    init_state``'s ``lora_optimizer``)."""
    import warnings

    from ddw_tpu_torch.train.trainer import Trainer
    from ddw_tpu_torch.utils.config import DataCfg, TrainCfg

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # adapters over a random base
        trainer = Trainer(DataCfg(img_height=32, img_width=32),
                          ModelCfg(name="vit", hidden=96, num_heads=2,
                                   lora_rank=2, dtype="float32"),
                          TrainCfg(), device="cpu")
    state, tx = trainer._init_state()
    names = [n for n, _ in state.model.named_parameters()]
    trained = {n for n in names if tx.trainable(n)}
    assert trained == {n for n in names if "lora_" in n or
                       n.startswith("head.")}
    assert "backbone_block0.attn.query.lora_a" in trained
    assert "backbone_block0.attn.key.kernel" not in trained
