"""K1 and K2 of the PyTorch port: the plain versions of the CUDA depthwise
kernels (``ddw_tpu_torch.ops.depthwise_conv``) against the JAX Pallas
kernels in interpreter mode, the autograd Function against ``jax.grad``, the
stride-2 library arm against ``impl="xla"``, and the dispatch rules. The CUDA
kernels themselves are held against the plain versions on the card by
``chip_smoke.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from ddw_tpu.ops.depthwise_conv import DepthwiseConv3x3 as JaxDepthwise
from ddw_tpu.ops.depthwise_conv import _pallas_dw
from ddw_tpu.ops.depthwise_conv import depthwise_conv3x3 as jax_dw
from ddw_tpu_torch.ops import _build
from ddw_tpu_torch.ops.depthwise_conv import (DepthwiseConv3x3,
                                              DepthwiseKernelFn, conv2d_same,
                                              depthwise_conv3x3,
                                              depthwise_conv3x3_cuda,
                                              depthwise_conv3x3_plain,
                                              depthwise_conv3x3_wgrad_cuda,
                                              depthwise_conv3x3_wgrad_plain,
                                              same_pads)


def _inputs(shape, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(*shape).astype(np.float32),
            rng.randn(3, 3, shape[-1]).astype(np.float32))


def _bf16_ulp(a: np.ndarray) -> np.ndarray:
    mag = np.maximum(np.abs(a), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(mag)) - 7)


@pytest.mark.parametrize("shape", [(2, 8, 8, 8), (1, 14, 10, 16),
                                   (2, 6, 5, 13)])
def test_plain_matches_pallas_f32(shape):
    x, w = _inputs(shape, 0)
    ref = np.asarray(jax_dw(jnp.asarray(x), jnp.asarray(w), impl="pallas",
                            interpret=True))
    got = depthwise_conv3x3_plain(torch.from_numpy(x), torch.from_numpy(w))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", [(2, 8, 8, 8), (1, 14, 10, 16),
                                   (2, 6, 5, 13)])
def test_plain_matches_pallas_bf16_within_one_ulp(shape):
    # Both accumulate the bf16 inputs in f32 in the same tap order and round
    # once at the end, so they may differ by one bf16 rounding at most.
    x, w = _inputs(shape, 1)
    ref = jax_dw(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16),
                 impl="pallas", interpret=True)
    assert ref.dtype == jnp.bfloat16
    ref = np.asarray(ref, np.float32)
    got = depthwise_conv3x3_plain(torch.from_numpy(x).bfloat16(),
                                  torch.from_numpy(w).bfloat16())
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - ref)
    assert (err <= _bf16_ulp(ref)).all(), err.max()


@pytest.mark.parametrize("hw", [(8, 8), (7, 9)])
def test_stride2_library_arm_matches_xla(hw):
    x, w = _inputs((2, *hw, 8), 2)
    ref = np.asarray(jax_dw(jnp.asarray(x), jnp.asarray(w), stride=2,
                            impl="xla"))
    got = depthwise_conv3x3(torch.from_numpy(x), torch.from_numpy(w),
                            stride=2)
    assert got.shape == ref.shape and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n,k,s", [(224, 3, 2), (7, 3, 2), (8, 1, 1),
                                   (9, 3, 1), (5, 5, 3)])
def test_same_pads_is_jax_same(n, k, s):
    assert same_pads(n, k, s) == tuple(
        lax.padtype_to_pads((n,), (k,), (s,), "SAME")[0])


@pytest.mark.parametrize("hw", [(16, 16), (15, 13)])
def test_conv2d_same_stem_matches_lax(hw):
    rng = np.random.RandomState(3)
    x = rng.randn(2, *hw, 3).astype(np.float32)
    k = rng.randn(3, 3, 3, 8).astype(np.float32)   # flax HWIO
    ref = np.asarray(lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(k), (2, 2), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC")))
    got = conv2d_same(torch.from_numpy(x),
                      torch.from_numpy(k.transpose(3, 2, 0, 1).copy()), 2)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_cpu_tensors_never_touch_the_kernel():
    x, w = map(torch.from_numpy, _inputs((1, 6, 6, 8), 4))
    before = depthwise_conv3x3_cuda.launches
    for impl in ("auto", "pallas"):
        y = depthwise_conv3x3(x, w, impl=impl)
        torch.testing.assert_close(y, depthwise_conv3x3_plain(x, w),
                                   rtol=0, atol=0)
    depthwise_conv3x3(x, w, interpret=True)
    depthwise_conv3x3(x, w, stride=2)
    depthwise_conv3x3(x, w, impl="xla")
    assert depthwise_conv3x3_cuda.launches == before


def test_bad_inputs_raise():
    x, w = map(torch.from_numpy, _inputs((1, 8, 8, 8), 5))
    before = depthwise_conv3x3_cuda.launches
    with pytest.raises(ValueError, match=r"w must be \[3, 3, C\]"):
        depthwise_conv3x3(x, torch.zeros(5, 5, 8))
    with pytest.raises(ValueError, match="channel mismatch"):
        depthwise_conv3x3(x, torch.zeros(3, 3, 4))
    with pytest.raises(ValueError, match="unknown impl"):
        depthwise_conv3x3(x, w, impl="cudnn")
    with pytest.raises(ValueError, match="stride 1"):
        depthwise_conv3x3(x, w, stride=2, impl="pallas")
    # the kernel wrappers refuse a CPU tensor before any build or launch
    with pytest.raises(ValueError, match="CUDA device"):
        depthwise_conv3x3_cuda(x, w)
    with pytest.raises(ValueError, match="CUDA device"):
        depthwise_conv3x3_wgrad_cuda(x, x)
    assert depthwise_conv3x3_cuda.launches == before
    assert depthwise_conv3x3_wgrad_cuda.launches == 0


def test_build_without_nvcc_raises(monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "_NVCC_FALLBACK", "/nonexistent/bin/nvcc")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


def test_library_is_keyed_by_source_and_flags(tmp_path, monkeypatch):
    src = tmp_path / "k.cu"
    src.write_text("extern \"C\" int f() { return 0; }\n")
    monkeypatch.setattr(_build, "CSRC", str(tmp_path))
    first = _build.library_path("k.cu")
    assert first.startswith(_build.BUILD_DIR) and "libk-" in first
    src.write_text("extern \"C\" int f() { return 1; }\n")
    assert _build.library_path("k.cu") != first


def _abs_sum_bound(x: np.ndarray, g: np.ndarray) -> np.ndarray:
    """sum_{b,h,w} |xpad * g| per (dy, dx, c), in float64: the scale of
    K2's rounding error (the result itself can cancel to near zero)."""
    h, w = x.shape[1:3]
    xp = np.pad(x.astype(np.float64), ((0, 0), (1, 1), (1, 1), (0, 0)))
    g = g.astype(np.float64)
    return np.stack([np.abs(xp[:, dy:dy + h, dx:dx + w] * g).sum((0, 1, 2))
                     for dy in range(3) for dx in range(3)]).reshape(3, 3, -1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 8, 8, 8), (3, 7, 5, 13)])
def test_wgrad_plain_matches_pallas_dw(shape, dtype):
    # Both accumulate in f32 in another order: error <= 1e-5 * sum|xpad*g|.
    rng = np.random.RandomState(6)
    x = rng.randn(*shape).astype(np.float32)
    g = rng.randn(*shape).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    xj, gj = jnp.asarray(x, jdt), jnp.asarray(g, jdt)
    ref = np.asarray(_pallas_dw(xj, gj, True))
    tdt = getattr(torch, dtype)
    got = depthwise_conv3x3_wgrad_plain(torch.from_numpy(x).to(tdt),
                                        torch.from_numpy(g).to(tdt))
    assert got.dtype == torch.float32 and got.shape == (3, 3, shape[-1])
    bound = 1e-5 * _abs_sum_bound(np.asarray(xj, np.float32),
                                  np.asarray(gj, np.float32))
    assert (np.abs(got.numpy() - ref) <= bound).all()


def test_function_gradients_match_jax_grad():
    # tests/test_depthwise.py::test_gradients_match_xla, through the port's
    # Function (plain path on the CPU) against jax.grad through the Pallas
    # kernel in interpret mode.
    rng = np.random.RandomState(1)
    x = rng.randn(2, 8, 8, 8).astype(np.float32)
    w = rng.randn(3, 3, 8).astype(np.float32)

    def loss_pallas(x, w):
        return jnp.sum(jnp.sin(jax_dw(x, w, impl="pallas", interpret=True)))

    gx_j, gw_j = jax.grad(loss_pallas, argnums=(0, 1))(jnp.asarray(x),
                                                       jnp.asarray(w))
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    torch.sin(depthwise_conv3x3(xt, wt, impl="pallas")).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx_j),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(gw_j),
                               rtol=1e-4, atol=1e-4)


def test_bf16_layer_rounds_dw_to_the_tap_dtype():
    # _vjp_bwd casts dw to the tap dtype (bf16) before the parameter cast
    # returns it to f32: the f32 parameter gradient is bf16-representable,
    # and within one bf16 ulp of the JAX layer's.
    rng = np.random.RandomState(7)
    x = rng.randn(2, 6, 6, 16).astype(np.float32)
    kernel = rng.randn(3, 3, 1, 16).astype(np.float32)
    layer = JaxDepthwise(16, dtype=jnp.bfloat16, impl="pallas",
                         interpret=True)

    def loss(params, x):
        y = layer.apply({"params": params}, x)
        return jnp.sum(jnp.sin(y.astype(jnp.float32)))

    ref = np.asarray(jax.grad(loss)({"kernel": jnp.asarray(kernel)},
                                    jnp.asarray(x))["kernel"])[:, :, 0, :]
    mod = DepthwiseConv3x3(16, dtype=torch.bfloat16, impl="pallas")
    with torch.no_grad():
        mod.weight.copy_(torch.from_numpy(kernel[:, :, 0, :]))
    torch.sin(mod(torch.from_numpy(x)).float()).sum().backward()
    got = mod.weight.grad
    assert got.dtype == torch.float32
    assert torch.equal(got, got.bfloat16().float())
    assert (np.abs(got.numpy() - ref) <= _bf16_ulp(ref)).all()


def test_function_gradcheck_float64():
    rng = np.random.RandomState(8)
    x = torch.from_numpy(rng.randn(2, 4, 5, 3)).requires_grad_(True)
    w = torch.from_numpy(rng.randn(3, 3, 3)).requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda x, w: DepthwiseKernelFn.apply(x, w, True), (x, w))


def test_function_skips_unneeded_gradients():
    x, w = map(torch.from_numpy, _inputs((1, 5, 5, 4), 9))
    wt = w.clone().requires_grad_(True)
    depthwise_conv3x3(x, wt).sum().backward()       # dw only
    xt = x.clone().requires_grad_(True)
    depthwise_conv3x3(xt, w).sum().backward()       # dx only
    assert wt.grad.shape == (3, 3, 4) and xt.grad.shape == x.shape
    # a non-contiguous output gradient reaches the kernels contiguous
    xt2 = x.clone().requires_grad_(True)
    y = depthwise_conv3x3(xt2, w)
    g = torch.randn(1, 5, 4, 5).permute(0, 1, 3, 2)
    y.backward(g)
    ref = depthwise_conv3x3_plain(g.contiguous(), w.flip(0, 1).contiguous())
    assert torch.equal(xt2.grad, ref)
