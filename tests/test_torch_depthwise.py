"""K1 and K2 of the PyTorch port: the plain versions of the CUDA depthwise
kernels (``ddw_tpu_torch.ops.depthwise_conv``) against the JAX Pallas
kernels in interpreter mode, the autograd Function against ``jax.grad``, the
stride-2 library arm against ``impl="xla"``, and the dispatch rules. The CUDA
kernels themselves are held against the plain versions on the card by
``chip_smoke.py``."""

import os
import re
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from ddw_tpu.ops.depthwise_conv import DepthwiseConv3x3 as JaxDepthwise
from ddw_tpu.ops.depthwise_conv import _pallas_dw, _pallas_fwd
from ddw_tpu.ops.depthwise_conv import depthwise_conv3x3 as jax_dw
from ddw_tpu_torch.ops import _build
from ddw_tpu_torch.ops import depthwise_conv as dc
from ddw_tpu_torch.ops.depthwise_conv import (DepthwiseConv3x3,
                                              DepthwiseKernelFn, conv2d_same,
                                              depthwise_conv3x3,
                                              depthwise_conv3x3_cuda,
                                              depthwise_conv3x3_plain,
                                              depthwise_conv3x3_wgrad_cuda,
                                              depthwise_conv3x3_wgrad_plain,
                                              dw_tile_plan, same_pads)


def _inputs(shape, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(*shape).astype(np.float32),
            rng.randn(3, 3, shape[-1]).astype(np.float32))


def _bf16_ulp(a: np.ndarray) -> np.ndarray:
    mag = np.maximum(np.abs(a), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(mag)) - 7)


def _f16_ulp(a: np.ndarray) -> np.ndarray:
    mag = np.maximum(np.abs(a), np.finfo(np.float16).tiny)
    return np.exp2(np.floor(np.log2(mag)) - 10)


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


@pytest.mark.parametrize("shape", [(2, 8, 8, 8), (1, 14, 10, 16),
                                   (2, 6, 5, 13)])
def test_plain_matches_pallas_f16_within_one_ulp(shape):
    # K1 in f16, the forward and the input gradient on flipped taps (dx, as
    # _vjp_bwd runs it), against the Pallas kernel in interpret mode: both
    # accumulate the f16 inputs in f32 in the same tap order and round once,
    # so they may differ by one f16 rounding at most.
    x, w = _inputs(shape, 11)
    xj, wj = jnp.asarray(x, jnp.float16), jnp.asarray(w, jnp.float16)
    xt, wt = torch.from_numpy(x).half(), torch.from_numpy(w).half()
    for flip in (False, True):
        ref = _pallas_fwd(xj, wj[::-1, ::-1, :] if flip else wj, True)
        assert ref.dtype == jnp.float16
        ref = np.asarray(ref, np.float32)
        got = depthwise_conv3x3_plain(xt, wt, flip=flip)
        assert got.dtype == torch.float16
        err = np.abs(got.float().numpy() - ref)
        assert (err <= _f16_ulp(ref)).all(), err.max()


def test_f16_function_gradients_match_jax_grad():
    # The Function in f16 against jax.grad through the Pallas kernels in
    # interpret mode: dx (K1 on flipped taps, f16) within one f16 ulp, dw
    # (K2 in f32, cast to the f16 taps as _vjp_bwd casts it) within one f16
    # ulp plus K2's 1e-5 * sum|xpad * g|.
    rng = np.random.RandomState(12)
    x = rng.randn(2, 8, 8, 16).astype(np.float32)
    w = rng.randn(3, 3, 16).astype(np.float32)
    gy = rng.randn(2, 8, 8, 16).astype(np.float32)

    def loss(x, w):
        y = jax_dw(x, w, impl="pallas", interpret=True)
        return jnp.sum(y.astype(jnp.float32) * gy)

    gx_j, gw_j = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x, jnp.float16),
                                               jnp.asarray(w, jnp.float16))
    xt = torch.from_numpy(x).half().requires_grad_(True)
    wt = torch.from_numpy(w).half().requires_grad_(True)
    (depthwise_conv3x3(xt, wt, impl="pallas").float()
     * torch.from_numpy(gy)).sum().backward()
    assert xt.grad.dtype == wt.grad.dtype == torch.float16
    gx_j, gw_j = np.asarray(gx_j, np.float32), np.asarray(gw_j, np.float32)
    assert (np.abs(xt.grad.float().numpy() - gx_j) <= _f16_ulp(gx_j)).all()
    bound = 1e-5 * _abs_sum_bound(x.astype(np.float16).astype(np.float32),
                                  gy.astype(np.float16).astype(np.float32))
    assert (np.abs(wt.grad.float().numpy() - gw_j)
            <= _f16_ulp(gw_j) + bound).all()


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


def test_a_source_in_parts_compiles_each_then_links(tmp_path, monkeypatch):
    """``// nvcc parts: 3``: three compiles (``-c -DDDW_PART=p``) and one
    link of their objects into the library (a stand-in nvcc records its
    arguments and writes its ``-o`` file)."""
    (tmp_path / "k.cu").write_text("// nvcc parts: 3\nint f();\n")
    calls = tmp_path / "calls.txt"
    fake = tmp_path / "nvcc"
    fake.write_text('#!/bin/sh\necho "$@" >> ' + str(calls) + '\n'
                    'while [ "$1" != "-o" ]; do shift; done\n'
                    'echo built > "$2"\n')
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "CSRC", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(fake))
    assert _build.parts("k.cu") == 3
    path, seconds, _ = _build.build("k.cu")
    assert path == _build.library_path("k.cu") and os.path.exists(path)
    lines = calls.read_text().splitlines()
    compiles = sorted(ln for ln in lines if "-DDDW_PART=" in ln)
    assert [ln.split("-DDDW_PART=")[1].split()[0] for ln in compiles] == [
        "0", "1", "2"]
    assert all(" -c " in ln and "-shared" not in ln for ln in compiles)
    link = [ln for ln in lines if "-DDDW_PART=" not in ln]
    assert len(link) == 1 and link[0].startswith("-shared -o ")
    assert [w.rsplit("/", 1)[1] for w in link[0].split()[3:]] == [
        "part0.o", "part1.o", "part2.o"]
    assert _build.build("k.cu")[1] == 0.0       # reused, not rebuilt
    assert len(calls.read_text().splitlines()) == 4


def test_flash_sources_declare_the_parts_their_entries_ask():
    """The two mma.sync / CUDA-core flash sources build in as many parts as
    flash_common.cuh's kParts, whose entries each part answers; the sm90
    forward in as many as its entry asks, one a compiled width; the sm90
    backward in as many as its entries ask, one a kernel (K4, K5) and
    compiled width; the others build whole."""
    with open(os.path.join(_build.CSRC, "flash_common.cuh")) as f:
        k_parts = int(re.search(r"constexpr int kParts = (\d+);",
                                f.read()).group(1))
    sm90_parts = {}
    for src, entry, per_width in (("flash_fwd_sm90.cu", "fwd", 1),
                                  ("flash_bwd_sm90.cu", "bwd", 2)):
        with open(os.path.join(_build.CSRC, src)) as f:
            text = f.read()
        sm90_parts[src] = len(set(re.findall(
            rf"int ddw_flash_{entry}_sm90_part(\d+)\(", text)))
        # the widths the entries dispatch: each case, and the default (256)
        widths = len(re.findall(r"case \d+: return run<", text)) + 1
        assert sm90_parts[src] == per_width * widths, src
    for src in sorted(os.listdir(_build.CSRC)):
        if src.endswith(".cu"):
            want = (k_parts if src.startswith("flash_attention") else
                    sm90_parts.get(src, 1))
            assert _build.parts(src) == want, src


def _abs_sum_bound(x: np.ndarray, g: np.ndarray) -> np.ndarray:
    """sum_{b,h,w} |xpad * g| per (dy, dx, c), in float64: the scale of
    K2's rounding error (the result itself can cancel to near zero)."""
    h, w = x.shape[1:3]
    xp = np.pad(x.astype(np.float64), ((0, 0), (1, 1), (1, 1), (0, 0)))
    g = g.astype(np.float64)
    return np.stack([np.abs(xp[:, dy:dy + h, dx:dx + w] * g).sum((0, 1, 2))
                     for dy in range(3) for dx in range(3)]).reshape(3, 3, -1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("shape", [(2, 8, 8, 8), (3, 7, 5, 13)])
def test_wgrad_plain_matches_pallas_dw(shape, dtype):
    # Both accumulate in f32 in another order: error <= 1e-5 * sum|xpad*g|.
    rng = np.random.RandomState(6)
    x = rng.randn(*shape).astype(np.float32)
    g = rng.randn(*shape).astype(np.float32)
    jdt = getattr(jnp, dtype)
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


# -- the "tma" variant: its tile plan, its choice, its counts ----------------

# (B, H, W, C): the six distinct shapes of MobileNetV2-224's 13 stride-1
# layers at batch 128, then odd shapes: B = 1, H and W that no tile divides,
# C that no channel block divides.
PLAN_SHAPES = [(128, 112, 112, 32), (128, 56, 56, 144), (128, 28, 28, 192),
               (128, 14, 14, 384), (128, 14, 14, 576), (128, 7, 7, 960),
               (1, 15, 13, 64), (2, 9, 7, 64), (3, 8, 8, 40), (2, 8, 8, 200),
               (1, 224, 224, 16)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_tile_plan_covers_each_output_once_within_limits(shape, dtype):
    b, h, w, c = shape
    plan = dw_tile_plan(b, h, w, c, dtype)
    nbytes = torch.finfo(dtype).bits // 8
    # the TMA's box limits, 16-byte channel runs, the block and two blocks'
    # shared memory on an SM
    assert max(plan.th + 2, plan.tw + 2, plan.cb) <= 256
    assert plan.cb * nbytes % 16 == 0
    assert plan.cb * nbytes >= min(128, c * nbytes)
    assert plan.threads % 32 == 0 and plan.threads <= 256
    items = plan.cb * nbytes // 16 * plan.tw * -(-plan.th // 4)
    assert plan.threads - 32 < items <= plan.threads
    assert 2 * (max(plan.smem, plan.smem_wgrad) + 1024) <= 233472
    assert plan.stages >= 2
    assert plan.smem >= 128 + plan.stages * (plan.th + 2) * (plan.tw + 2) \
        * plan.cb * nbytes
    # the parts' tile ranges cover the spatial tiles once, in order
    assert plan.grid == plan.channel_blocks * plan.parts
    assert 1 <= plan.parts <= plan.tiles
    ranges = [plan.tile_range(p) for p in range(plan.parts)]
    assert all(len(r) >= 1 for r in ranges)
    assert [t for r in ranges for t in r] == list(range(plan.tiles))
    # each spatial tile is (image, tile row, tile column); the tiles of an
    # image cover its H x W once, the channel blocks cover C once
    nth, ntw = -(-h // plan.th), -(-w // plan.tw)
    assert plan.tiles == b * nth * ntw
    seen = np.zeros((h, w), np.int32)
    for t in range(nth * ntw):
        h0, w0 = (t // ntw) * plan.th, (t % ntw) * plan.tw
        seen[h0:h0 + plan.th, w0:w0 + plan.tw] += 1
    assert (seen == 1).all()
    chans = np.zeros(c, np.int32)
    for k in range(plan.channel_blocks):
        chans[k * plan.cb:(k + 1) * plan.cb] += 1
    assert (chans == 1).all()


def test_tile_plan_is_a_function_of_the_shape_alone(monkeypatch):
    # No device query enters the plan: K2's partials and every order of
    # summation depend on (B, H, W, C, dtype) only.
    first = [dw_tile_plan(*s, torch.bfloat16) for s in PLAN_SHAPES]
    dw_tile_plan.cache_clear()
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda *a: pytest.fail("the plan asked the device"))
    monkeypatch.setattr(torch.cuda, "device_count",
                        lambda *a: pytest.fail("the plan asked the device"))
    again = [dw_tile_plan(*s, torch.bfloat16) for s in PLAN_SHAPES]
    assert again == first
    for plan in first:
        assert plan.parts == min(plan.tiles,
                                 -(-dc._TMA_BLOCKS // plan.channel_blocks))


@pytest.mark.parametrize("dtype,c", [(torch.bfloat16, 13),
                                     (torch.bfloat16, 12),
                                     (torch.float32, 6)])
def test_tile_plan_refuses_what_the_tma_cannot_take(dtype, c):
    with pytest.raises(ValueError, match="multiple of 16"):
        dw_tile_plan(2, 8, 8, c, dtype)
    # f16 plans as bf16 does (8 channels a vector); f64 has no kernel
    assert dw_tile_plan(2, 8, 8, 16, torch.float16) == \
        dw_tile_plan(2, 8, 8, 16, torch.bfloat16)
    with pytest.raises(ValueError, match="float32, bfloat16 or float16"):
        dw_tile_plan(2, 8, 8, 16, torch.float64)


@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_tile_plan_takes_f16_as_bf16(shape):
    assert dw_tile_plan(*shape, torch.float16) == \
        dw_tile_plan(*shape, torch.bfloat16)


def test_dw_variant_rules():
    assert dc._dw_variant(torch.bfloat16, 32, True) == "tma"
    assert dc._dw_variant(torch.bfloat16, 40, True) == "tma"
    assert dc._dw_variant(torch.float32, 36, True) == "tma"
    assert dc._dw_variant(torch.bfloat16, 12, True) == "simt"   # 24 bytes
    assert dc._dw_variant(torch.float32, 13, True) == "simt"
    assert dc._dw_variant(torch.bfloat16, 32, False) == "simt"  # unaligned
    assert dc._dw_variant(torch.float16, 32, True) == "tma"
    assert dc._dw_variant(torch.float16, 40, True) == "tma"
    assert dc._dw_variant(torch.float16, 12, True) == "simt"    # 24 bytes
    assert dc._dw_variant(torch.float16, 32, False) == "simt"


class _FakeLib:
    """Stands in for the built libraries: records each C call, returns
    ``err``."""

    def __init__(self, err=0):
        self.calls, self.err = [], err

    def __getattr__(self, name):
        if name.startswith("ddw_"):
            return lambda *args: (self.calls.append((name, args)), self.err)[1]
        raise AttributeError(name)


@pytest.fixture
def fake_launch(monkeypatch):
    """The wrappers' dispatch and counting on CPU tensors: the CUDA input
    check passes, the libraries are recorders, the launch calls them."""
    libs = {"tma": _FakeLib(), "simt": _FakeLib()}
    libs["simt"].ddw_dw3x3_wgrad_workspace = lambda *a: 16
    monkeypatch.setattr(dc, "_check_kernel_input", lambda *a: None)
    monkeypatch.setattr(dc, "_tma_lib", lambda: libs["tma"])
    monkeypatch.setattr(dc, "_kernel_lib", lambda: libs["simt"])
    monkeypatch.setattr(dc, "_launch", lambda fn, device, *args: fn(*args))
    dc.reset_depthwise_counts()
    yield libs
    dc.reset_depthwise_counts()


def test_counters_count_by_variant(fake_launch):
    x16 = torch.zeros(1, 6, 6, 16, dtype=torch.bfloat16)
    x13 = torch.zeros(1, 6, 6, 13, dtype=torch.bfloat16)
    w16 = torch.zeros(3, 3, 16, dtype=torch.bfloat16)
    w13 = torch.zeros(3, 3, 13, dtype=torch.bfloat16)
    depthwise_conv3x3_cuda(x16, w16)                     # tma
    depthwise_conv3x3_cuda(x16, w16, flip=True)          # tma, flipped
    depthwise_conv3x3_cuda(x16, w16, _variant="simt")    # forced
    depthwise_conv3x3_cuda(x13, w13)                     # simt: 26 bytes
    depthwise_conv3x3_wgrad_cuda(x16, x16)               # tma
    depthwise_conv3x3_wgrad_cuda(x13, x13)               # simt
    assert depthwise_conv3x3_cuda.launches == 4
    assert depthwise_conv3x3_cuda.launches_by_variant == {"tma": 2,
                                                          "simt": 2}
    assert depthwise_conv3x3_wgrad_cuda.launches == 2
    assert depthwise_conv3x3_wgrad_cuda.launches_by_variant == {"tma": 1,
                                                                "simt": 1}
    plan = dw_tile_plan(1, 6, 6, 16, torch.bfloat16)
    (n1, a1), (n2, a2) = fake_launch["tma"].calls[:2]
    assert n1 == n2 == "ddw_dw3x3_fwd_tma"
    # B, H, W, C, dtype code, th, tw, cb, stages, parts, flip
    assert a1[3:] == (1, 6, 6, 16, 1, plan.th, plan.tw, plan.cb, plan.stages,
                      plan.parts, 0)
    assert a2[-1] == 1
    name, args = fake_launch["tma"].calls[2]
    assert name == "ddw_dw3x3_wgrad_tma" and args[-1] == plan.parts
    assert [n for n, _ in fake_launch["simt"].calls] == [
        "ddw_dw3x3_fwd", "ddw_dw3x3_fwd", "ddw_dw3x3_wgrad"]
    dc.reset_depthwise_counts()
    assert depthwise_conv3x3_cuda.launches_by_variant == {"tma": 0,
                                                          "simt": 0}
    assert depthwise_conv3x3_wgrad_cuda.launches == 0


class _YieldingCounts(dict):
    """Per-variant counts that hand the interpreter to another thread
    between the read and the write of an increment, as a thread preempted
    there would."""

    def __getitem__(self, key):
        value = super().__getitem__(key)
        time.sleep(0)
        return value


def test_counters_lose_no_launch_under_threads(fake_launch):
    """Trials of a parallel search launch from several threads: every
    launch is counted, even when a thread is switched out inside an
    increment."""
    import threading

    for fn in (depthwise_conv3x3_cuda, depthwise_conv3x3_wgrad_cuda):
        fn.launches_by_variant = _YieldingCounts(fn.launches_by_variant)
    x = torch.zeros(1, 6, 6, 16, dtype=torch.bfloat16)
    w = torch.zeros(3, 3, 16, dtype=torch.bfloat16)
    x13 = torch.zeros(1, 6, 6, 13, dtype=torch.bfloat16)
    w13 = torch.zeros(3, 3, 13, dtype=torch.bfloat16)
    start = threading.Barrier(8)

    def launch(i):
        start.wait()
        for _ in range(100):
            depthwise_conv3x3_cuda(*((x, w) if i % 2 else (x13, w13)))
            depthwise_conv3x3_wgrad_cuda(x, x)

    threads = [threading.Thread(target=launch, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert depthwise_conv3x3_cuda.launches == 800
    assert depthwise_conv3x3_cuda.launches_by_variant == {"tma": 400,
                                                          "simt": 400}
    assert depthwise_conv3x3_wgrad_cuda.launches_by_variant == {"tma": 800,
                                                                "simt": 0}


def test_unaligned_pointers_take_simt_and_tma_cannot_be_forced(fake_launch):
    flat = torch.zeros(1 + 6 * 6 * 16, dtype=torch.bfloat16)
    x = flat[1:].view(1, 6, 6, 16)                 # 2 bytes past 16
    w = torch.zeros(3, 3, 16, dtype=torch.bfloat16)
    depthwise_conv3x3_cuda(x, w)
    assert depthwise_conv3x3_cuda.launches_by_variant == {"tma": 0,
                                                          "simt": 1}
    with pytest.raises(ValueError, match="unaligned"):
        depthwise_conv3x3_cuda(x, w, _variant="tma")
    x13 = torch.zeros(1, 6, 6, 13)
    with pytest.raises(ValueError, match="its kernel is 'simt'"):
        depthwise_conv3x3_wgrad_cuda(x13, x13, _variant="tma")
    with pytest.raises(ValueError, match="'cudnn'"):
        depthwise_conv3x3_cuda(x, w, _variant="cudnn")
    assert depthwise_conv3x3_cuda.launches == 1
    assert depthwise_conv3x3_wgrad_cuda.launches == 0


@pytest.mark.parametrize("err,match", [(700, "CUDA error 700"),
                                       (1001, "TMA tensor map failed with "
                                              "CUresult 1")])
def test_launch_errors_raise_and_are_not_counted(fake_launch, err, match):
    fake_launch["tma"].err = err
    x = torch.zeros(1, 6, 6, 16, dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match=match):
        depthwise_conv3x3_cuda(x, torch.zeros(3, 3, 16, dtype=torch.bfloat16))
    with pytest.raises(RuntimeError, match=match):
        depthwise_conv3x3_wgrad_cuda(x, x)
    assert depthwise_conv3x3_cuda.launches == 0
    assert depthwise_conv3x3_wgrad_cuda.launches == 0
    assert not fake_launch["simt"].calls          # nothing fell back


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(2, 8, 8, 8), (1, 7, 5, 13)])
def test_plain_flip_equals_plain_on_flipped_taps(shape, dtype):
    x, w = _inputs(shape, 10)
    xt, wt = torch.from_numpy(x).to(dtype), torch.from_numpy(w).to(dtype)
    got = depthwise_conv3x3_plain(xt, wt, flip=True)
    ref = depthwise_conv3x3_plain(xt, wt.flip(0, 1).contiguous())
    assert torch.equal(got, ref)
    assert not torch.equal(got, depthwise_conv3x3_plain(xt, wt))


def _wgrad_in_partition_order(x: torch.Tensor, g: torch.Tensor,
                              plan) -> torch.Tensor:
    """K2's sums in the kernel's partition: per block (channel block, part),
    the f32 sum of its tiles' products in its tile order; then the parts'
    partials added in order."""
    b, h, w, c = x.shape
    xp = torch.nn.functional.pad(x.float(), (0, 0, 1, 1, 1, 1))
    gf = g.float()
    ntw = -(-w // plan.tw)
    per_image = -(-h // plan.th) * ntw
    out = torch.zeros(3, 3, c)
    for k in range(plan.channel_blocks):
        cs = slice(k * plan.cb, min((k + 1) * plan.cb, c))
        total = torch.zeros(3, 3, cs.stop - cs.start)
        for part in range(plan.parts):
            acc = torch.zeros_like(total)
            for t in plan.tile_range(part):
                img, r = divmod(t, per_image)
                h0, w0 = (r // ntw) * plan.th, (r % ntw) * plan.tw
                h1, w1 = min(h0 + plan.th, h), min(w0 + plan.tw, w)
                gt = gf[img, h0:h1, w0:w1, cs]
                for dy in range(3):
                    for dx in range(3):
                        acc[dy, dx] += (xp[img, h0 + dy:h1 + dy,
                                           w0 + dx:w1 + dx, cs]
                                        * gt).sum((0, 1))
            total += acc
        out[:, :, cs] = total
    return out


@pytest.mark.parametrize("tiles", [None, (4, 3, 16)])
def test_wgrad_in_partition_order_matches_float64(tiles):
    # the kernel's partition: several tiles a part and several parts a
    # channel block, the last channel block partial (C = 24 under cb 16)
    rng = np.random.RandomState(11)
    shape = (40, 9, 7, 24)
    x = torch.from_numpy(rng.randn(*shape).astype(np.float32))
    g = torch.from_numpy(rng.randn(*shape).astype(np.float32))
    plan = (dw_tile_plan(*shape, torch.float32) if tiles is None else
            dc._tile_plan_of(*shape, 4, *tiles))
    assert tiles is None or (plan.tiles > plan.parts
                             and plan.channel_blocks == 2)
    got = _wgrad_in_partition_order(x, g, plan)
    ref = depthwise_conv3x3_wgrad_plain(x.double(), g.double())
    bound = 1e-5 * _abs_sum_bound(x.numpy(), g.numpy())
    assert (np.abs(got.double().numpy() - ref.numpy()) <= bound).all()
