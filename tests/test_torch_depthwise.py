"""K1 of the PyTorch port: the plain version of the CUDA depthwise kernel
(``ddw_tpu_torch.ops.depthwise_conv``) against the JAX Pallas kernel in
interpreter mode, the stride-2 library arm against ``impl="xla"``, and the
dispatch rules. The CUDA kernel itself is held against the plain version on
the card by ``chip_smoke.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from ddw_tpu.ops.depthwise_conv import depthwise_conv3x3 as jax_dw
from ddw_tpu_torch.ops import _build
from ddw_tpu_torch.ops.depthwise_conv import (conv2d_same, depthwise_conv3x3,
                                              depthwise_conv3x3_cuda,
                                              depthwise_conv3x3_plain,
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
    # the kernel wrapper refuses a CPU tensor before any build or launch
    with pytest.raises(ValueError, match="CUDA device"):
        depthwise_conv3x3_cuda(x, w)
    assert depthwise_conv3x3_cuda.launches == before


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
