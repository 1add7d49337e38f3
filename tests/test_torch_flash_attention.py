"""Flash attention in the PyTorch port (``ddw_tpu_torch.ops.flash_attention``)
against ``ddw_tpu.ops.flash_attention`` on the CPU: K3's plain version
against the Pallas kernel in interpret mode (the cases of
``tests/test_ops_parallel.py``), the ``xla`` tier, the size dispatch and
block picking, and the refusals of the kernel path (no backward yet, no CPU
tensors for the CUDA wrapper)."""

import importlib
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddw_tpu_torch.ops import flash_attention as tfa

# ddw_tpu.ops re-exports a function of this name over the submodule
jfa = importlib.import_module("ddw_tpu.ops.flash_attention")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _qkv(b=2, h=2, s=256, d=64, seed=0, sk=None):
    rng = np.random.RandomState(seed)
    sk = s if sk is None else sk
    return (rng.randn(b, h, s, d).astype(np.float32),
            rng.randn(b, h, sk, d).astype(np.float32),
            rng.randn(b, h, sk, d).astype(np.float32))


def _jax(arrs, dtype=jnp.float32):
    return [jnp.asarray(a, dtype=dtype) for a in arrs]


def _torch(arrs, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrs]


def _np(t):
    return np.asarray(t.float() if isinstance(t, torch.Tensor) else
                      jnp.asarray(t, jnp.float32))


def test_flash_matches_reference():
    arrs = _qkv()
    out = tfa.flash_attention(*_torch(arrs))
    ref = jfa.flash_attention(*_jax(arrs))
    np.testing.assert_allclose(_np(out), _np(ref), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(_np(out), _np(tfa.mha_reference(*_torch(arrs))),
                               rtol=2e-5, atol=2e-5)


def test_flash_causal():
    arrs = _qkv(seed=1)
    q, k, v = _torch(arrs)
    out = tfa.flash_attention(q, k, v, True)
    ref = jfa.flash_attention(*_jax(arrs), True)
    np.testing.assert_allclose(_np(out), _np(ref), rtol=2e-5, atol=2e-5)
    # position 0..127 must not depend on later keys
    v2 = v.clone()
    v2[:, :, 128:] = 0.0
    out2 = tfa.flash_attention(q, k, v2, True)
    np.testing.assert_allclose(_np(out[:, :, :128]), _np(out2[:, :, :128]),
                               rtol=1e-6, atol=1e-6)


def test_flash_bf16():
    """bf16 in, bf16 out: p is rounded to bf16 for the P.V product in both
    packages, so they agree within two bf16 ulps or 1e-3 * max|v|."""
    arrs = _qkv(seed=2)
    out = tfa.flash_attention(*_torch(arrs, torch.bfloat16), True)
    ref = jfa.flash_attention(*_jax(arrs, jnp.bfloat16), True)
    assert out.dtype == torch.bfloat16
    got, want = _np(out), _np(ref)
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    tol = np.maximum(2 * ulp, 1e-3 * np.abs(arrs[2]).max())
    assert (np.abs(got - want) <= tol).all()


def test_flash_offsets():
    """q_offset/k_offset shift the causal mask to global positions."""
    arrs = _qkv(s=128, seed=3)
    q, k, v = _torch(arrs)
    past = tfa.flash_attention(q, k, v, True, 128, 0)  # keys all in the past
    np.testing.assert_allclose(_np(past), _np(tfa.mha_reference(q, k, v)),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(
        _np(past), _np(jfa.flash_attention(*_jax(arrs), True, 128, 0)),
        rtol=2e-5, atol=2e-5)
    future, lse = tfa.flash_attention_lse(q, k, v, True, 0, 128)
    assert np.isfinite(_np(future)).all()
    assert (_np(future) == 0).all() and (_np(lse) <= -1e29).all()
    jout, jlse = jfa.flash_attention_lse(*_jax(arrs), True, 0, 128)
    np.testing.assert_array_equal(_np(future), _np(jout))
    np.testing.assert_allclose(_np(lse), _np(jlse), rtol=1e-6)


def test_flash_misaligned_offset_masked_rows_zero():
    """k_offset=64 with block_k=128: rows 0-63 see no key but the K block
    passes the block-level check; the guarded exp keeps them at zero."""
    arrs = _qkv(s=256, seed=3)
    q, k, v = _torch(arrs)
    out, lse = tfa.flash_attention_lse(q[:, :, :128], k, v, True, 0, 64)
    np.testing.assert_array_equal(_np(out[:, :, :64]), 0.0)
    assert (_np(lse[:, :, :64]) <= -1e29).all()
    ref = tfa.mha_reference(q[:, :, :128], k, v, causal=True, q_offset=0,
                            k_offset=64)
    np.testing.assert_allclose(_np(out[:, :, 64:]), _np(ref[:, :, 64:]),
                               rtol=2e-5, atol=2e-5)
    jq, jk, jv = _jax(arrs)
    jout, jlse = jfa.flash_attention_lse(jq[:, :, :128], jk, jv, True, 0, 64)
    np.testing.assert_allclose(_np(out), _np(jout), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(_np(lse), _np(jlse), rtol=1e-5, atol=1e-5)


def test_flash_lse_matches_logsumexp():
    arrs = _qkv(b=1, h=2, s=256, d=32, seed=4)
    q, k, v = _torch(arrs)
    out, lse = tfa.flash_attention_lse(q, k, v)
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) / np.sqrt(32)
    np.testing.assert_allclose(_np(lse), _np(torch.logsumexp(scores, -1)),
                               rtol=1e-5, atol=1e-5)
    jout, jlse = jfa.flash_attention_lse(*_jax(arrs))
    np.testing.assert_allclose(_np(out), _np(jout), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(_np(lse), _np(jlse), rtol=1e-5, atol=1e-5)


def test_flash_mha_padded_seq():
    """impl='pallas' pads 196 to a block multiple, masks the padded keys with
    k_valid and slices the padded rows off, in both packages."""
    arrs = _qkv(b=1, h=2, s=196, d=48, seed=6)
    out, lse = tfa.flash_mha_lse(*_torch(arrs), impl="pallas")
    jout, jlse = jfa.flash_mha_lse(*_jax(arrs), impl="pallas")
    assert out.shape == (1, 2, 196, 48) and lse.shape == (1, 2, 196)
    np.testing.assert_allclose(_np(out), _np(jout), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(_np(lse), _np(jlse), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(out), _np(tfa.mha_reference(
        *_torch(arrs))), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("causal,q_offset,k_offset,k_valid,block_k", [
    (True, 0, 0, 200, 48), (False, 0, 0, 72, 40), (True, 32, 0, None, 16),
    (True, 0, 48, 150, 80)])
def test_plain_masks_and_blocks_match_jax(causal, q_offset, k_offset, k_valid,
                                          block_k):
    """Key-padding masks, blocks that are not 128 and offsets that are not
    block-aligned, against the Pallas kernel."""
    arrs = _qkv(b=1, h=3, s=80, d=32, seed=7, sk=240)
    out, lse = tfa.flash_attention_lse(*_torch(arrs), causal, q_offset,
                                       k_offset, None, 16, block_k,
                                       k_valid=k_valid)
    jout, jlse = jfa.flash_attention_lse(*_jax(arrs), causal, q_offset,
                                         k_offset, None, 16, block_k,
                                         k_valid=k_valid)
    np.testing.assert_allclose(_np(out), _np(jout), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(_np(lse), _np(jlse), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,q_offset,k_offset,k_valid", [
    (False, 0, 0, None), (True, 0, 0, None), (True, 0, 64, None),
    (True, 16, 0, 90)])
def test_xla_tier_matches_jax(dtype, causal, q_offset, k_offset, k_valid):
    arrs = _qkv(b=2, h=2, s=96, d=32, seed=8)
    scale = 1.0 / np.sqrt(32)
    out, lse = tfa.xla_attention_lse(*_torch(arrs, getattr(torch, dtype)),
                                     causal, q_offset, k_offset, scale,
                                     k_valid)
    jout, jlse = jfa._xla_attention_lse(*_jax(arrs, getattr(jnp, dtype)),
                                        causal, q_offset, k_offset, scale,
                                        k_valid)
    tol = 2e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(_np(out), _np(jout), rtol=tol, atol=tol)
    np.testing.assert_allclose(_np(lse), _np(jlse), rtol=1e-5, atol=1e-5)
    if k_offset:  # fully masked rows: zero out, lse clamped at -1e30
        assert (_np(out[:, :, :k_offset]) == 0).all()
        assert (_np(lse[:, :, :k_offset]) <= -1e29).all()


def test_dispatch_and_block_picking_match_jax():
    """Both packages pick the same tier and blocks for the same shapes."""
    assert tfa._XLA_PLAIN_MAX == jfa._XLA_PLAIN_MAX == 256 * 1024**2
    assert tfa._XLA_CKPT_MAX == jfa._XLA_CKPT_MAX == 2 * 1024**3
    for b, h, sq, sk in [(1, 1, 16, 16), (8, 8, 2048, 2048),
                         (64, 8, 2048, 2048), (16, 8, 1024, 2048),
                         (8, 8, 2049, 2049), (2, 4, 4096, 8192)]:
        tq = torch.empty(b, h, sq, 0)
        tk = torch.empty(b, h, sk, 0)
        jq = jax.ShapeDtypeStruct((b, h, sq, 1), jnp.float32)
        jk = jax.ShapeDtypeStruct((b, h, sk, 1), jnp.float32)
        for impl in ("auto", "xla", "pallas"):
            assert tfa._attn_impl(tq, tk, impl) == jfa._attn_impl(jq, jk,
                                                                  impl)
    assert tfa._attn_impl(torch.empty(8, 8, 2048, 0),
                          torch.empty(8, 8, 2048, 0), "auto") == "xla_ckpt"
    assert tfa._attn_impl(torch.empty(64, 8, 2048, 0),
                          torch.empty(64, 8, 2048, 0), "auto") == "pallas"
    for s in (1, 7, 8, 15, 16, 100, 127, 128, 129, 196, 2047, 2048):
        for block in (16, 64, 128, 256):
            for td, jd in ((torch.float32, jnp.float32),
                           (torch.bfloat16, jnp.bfloat16)):
                assert tfa._pick_block(s, block, td) == \
                    jfa._pick_block(s, block, jd), (s, block, td)


def test_thresholds_read_from_the_environment():
    code = ("from ddw_tpu_torch.ops import flash_attention as f\n"
            "print(f._XLA_PLAIN_MAX, f._XLA_CKPT_MAX)\n")
    env = dict(os.environ, DDW_ATTN_XLA_PLAIN_MAX="5",
               DDW_ATTN_XLA_CKPT_MAX="7")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["5", "7"]


def test_tiers_agree_and_xla_ckpt_differentiates():
    """Every tier computes the same attention; xla_ckpt's checkpointed
    backward equals the plain xla tier's."""
    arrs = _qkv(b=2, h=2, s=80, d=32, seed=9)
    outs = {impl: tfa.flash_mha_lse(*_torch(arrs), True, impl=impl)
            for impl in ("xla", "xla_ckpt", "pallas")}
    for impl in ("xla_ckpt", "pallas"):
        for a, b in zip(outs[impl], outs["xla"]):
            np.testing.assert_allclose(_np(a), _np(b), rtol=2e-5, atol=2e-5)
    grads = {}
    for impl in ("xla", "xla_ckpt"):
        q, k, v = (t.requires_grad_(True) for t in _torch(arrs))
        (tfa.flash_mha(q, k, v, True, impl=impl) ** 2).sum().backward()
        grads[impl] = [t.grad for t in (q, k, v)]
    for a, b in zip(grads["xla_ckpt"], grads["xla"]):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="unknown attention impl"):
        tfa.flash_mha(*_torch(arrs), impl="triton")


def test_pallas_tier_backward_raises_naming_k4_k5():
    q, k, v = (t.requires_grad_(True) for t in _torch(_qkv(s=32, d=32)))
    out = tfa.flash_mha(q, k, v, True, impl="pallas")
    with pytest.raises(NotImplementedError, match="K4.*K5.*ROADMAP.md"):
        out.sum().backward()


def test_cuda_wrapper_refuses_cpu_tensors_and_bad_shapes():
    q, k, v = _torch(_qkv(b=1, h=1, s=64, d=64))
    q, k, v = (t[0] for t in (q, k, v))
    with pytest.raises(ValueError, match="one CUDA device"):
        tfa.flash_attention_cuda(q, k, v)
    before = tfa.flash_attention_cuda.launches
    out, lse = tfa.FlashAttentionFn.apply(q, k, v, True, 0, 0, 0.125, 128,
                                          128, None, False)
    assert tfa.flash_attention_cuda.launches == before  # CPU: plain version
    ref, ref_lse = tfa.flash_attention_plain(q, k, v, True, 0, 0, 0.125)
    assert torch.equal(out, ref) and torch.equal(lse, ref_lse)
