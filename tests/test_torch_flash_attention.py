"""Flash attention in the PyTorch port (``ddw_tpu_torch.ops.flash_attention``)
against ``ddw_tpu.ops.flash_attention`` on the CPU: the plain versions of
K3 (forward), K4 (dQ) and K5 (dK/dV) against the Pallas kernels in
interpret mode (the cases of ``tests/test_ops_parallel.py``),
``FlashAttentionFn``'s gradients against ``jax.grad`` (the lse cotangent
and fully masked rows included) and a float64 gradcheck, the ``xla`` tier,
the size dispatch and block picking, and the refusals of the CUDA wrappers
(no CPU tensors)."""

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


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """One intra-op thread per test: under several test workers per host,
    torch's default pool (one thread per core, in every worker) spends its
    time waiting at OpenMP barriers for descheduled threads."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


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
    d = torch.zeros(1, 64)
    for fn in (tfa.flash_attention_dq_cuda, tfa.flash_attention_dkv_cuda):
        with pytest.raises(ValueError, match="one CUDA device"):
            fn(q, k, v, q, d, d)


# -- the forward's Q tile, and the choice of kernel --------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,q_offset,k_offset,k_valid", [
    (True, 40, 0, None), (True, 0, 192, None), (False, 0, 0, 300),
    (False, 0, 0, None)])
def test_plain_forward_bits_do_not_depend_on_block_q(dtype, causal, q_offset,
                                                     k_offset, k_valid):
    """The numerics of K3 do not depend on the query tile: a row that sees no
    key of a K block takes an exact no-op update there (alpha = 1, p = 0).
    So the sm90 kernel may pick its own Q tile (128 rows) and still follow
    the TPU kernel. Same bits for block_q 16 to 192 (rows 0-191 fully masked
    in the k_offset case), and the Pallas kernel in interpret mode agrees."""
    arrs = _qkv(b=1, h=2, s=384, d=64, seed=11)
    tdt = getattr(torch, dtype)
    q, k, v = (t[0] for t in _torch(arrs, tdt))
    runs = [tfa.flash_attention_plain(q, k, v, causal, q_offset, k_offset,
                                      block_q=bq, block_k=128,
                                      k_valid=k_valid)
            for bq in (16, 64, 128, 192)]
    for out, lse in runs[1:]:
        assert torch.equal(out, runs[0][0]) and torch.equal(lse, runs[0][1])
    jout, jlse = jfa.flash_attention_lse(
        *_jax(arrs, getattr(jnp, dtype)), causal, q_offset, k_offset, None,
        128, 128, interpret=True, k_valid=k_valid)
    got, want = _np(runs[0][0]), _np(jout)[0]
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    else:  # bf16 outputs: two bf16 ulps or 1e-3 * max|v|, as test_flash_bf16
        ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
        assert (np.abs(got - want) <= np.maximum(
            2 * ulp, 1e-3 * np.abs(arrs[2]).max())).all()
    np.testing.assert_allclose(_np(runs[0][1]), _np(jlse)[0], rtol=2e-5,
                               atol=2e-5)
    if k_offset:
        assert (_np(runs[0][0])[:, :k_offset] == 0).all()


def test_forward_variant_by_shape():
    """K3's kernel is a pure function of (dtype, head dim, block_k): sm90
    (TMA, wgmma) for bf16 and f16 at block_k 128 and every head dim up to
    256 that is a multiple of 8, mma.sync for the other bf16 and f16 blocks
    of multiples of 16 at head dims up to 256, CUDA cores for f32, for other
    16-bit blocks and above head dim 256. The LM's S = 2,048 takes sm90; a
    short sequence's smaller block takes mma.sync."""
    bf, f32, f16 = torch.bfloat16, torch.float32, torch.float16
    for d in range(8, 257, 8):  # 16, 40, 48, 80, 96, 256 among them
        for dtype in (bf, f16):
            assert tfa._fwd_variant(dtype, d, 128) == "sm90"
            assert tfa._fwd_variant(dtype, d, 64) == "mma"
            assert tfa._fwd_variant(dtype, d, 40) == "cuda_cores"
        assert tfa._fwd_variant(f32, d, 128) == "cuda_cores"
    for d in (1, 12, 36, 100, 200 + 4, 255):  # not multiples of 8
        for dtype in (bf, f16):
            assert tfa._fwd_variant(dtype, d, 128) == "mma"
            assert tfa._fwd_variant(dtype, d, 48) == "mma"
    for dtype in (bf, f16, f32):
        assert tfa._fwd_variant(dtype, 257, 128) == "cuda_cores"
        assert tfa._fwd_variant(dtype, 264, 128) == "cuda_cores"
        assert tfa._fwd_variant(dtype, 512, 64) == "cuda_cores"
    assert tfa._fwd_variant(bf, 64, 48) == "mma"
    assert tfa._fwd_variant(bf, 64, 64) == "mma"
    assert tfa._fwd_variant(bf, 64, 40) == "cuda_cores"
    assert tfa._fwd_variant(f32, 64, 48) == "cuda_cores"
    for dtype in (bf, f16):
        block = tfa._pick_block(2048, 128, dtype)
        assert block == 128 and tfa._fwd_variant(dtype, 64, block) == "sm90"
        assert tfa._fwd_variant(dtype, 256, block) == "sm90"
        # a short sequence pads to a smaller block and stays on mma.sync
        assert tfa._fwd_variant(dtype, 64, tfa._pick_block(
            100, 128, dtype)) == "mma"
    # the sm90 forward's compiled widths
    assert [tfa.compiled_width("sm90", d) for d in (8, 16, 48, 64, 72, 128,
                                                    136, 256)] == \
        [64, 64, 64, 64, 128, 128, 256, 256]


def test_forward_counts_reset_and_refuse_bad_variants():
    """The counts, total and per variant, start at zero after a reset; a
    CPU tensor launches nothing; a forced variant the shape cannot take is
    refused before anything launches."""
    tfa.reset_forward_counts()
    assert tfa.flash_attention_cuda.launches == 0
    assert tfa.flash_attention_cuda.launches_by_variant == {
        "sm90": 0, "mma": 0, "cuda_cores": 0}
    q = torch.zeros(1, 128, 64)
    with pytest.raises(ValueError, match="one CUDA device"):
        tfa.flash_attention_cuda(q, q, q, _variant="sm90")
    assert tfa.flash_attention_cuda.launches_by_variant["sm90"] == 0
    bf = torch.bfloat16
    assert tfa._forced_variant(bf, 64, 128, None) == "sm90"
    assert tfa._forced_variant(bf, 64, 128, "mma") == "mma"
    assert tfa._forced_variant(bf, 64, 48, "mma") == "mma"
    assert tfa._forced_variant(torch.float16, 256, 128, "mma") == "mma"
    for args in ((bf, 64, 48, "sm90"), (torch.float32, 64, 128, "sm90"),
                 (bf, 64, 128, "cuda_cores"), (bf, 36, 128, "sm90")):
        with pytest.raises(ValueError, match="cannot run"):
            tfa._forced_variant(*args)


def test_backward_variant_by_shape():
    """K4's and K5's kernel is a pure function of (dtype, head dim), the
    same for both: sm90 (TMA, wgmma) for bf16 and f16 at every head dim up
    to 256 that is a multiple of 8, mma.sync for the other bf16 and f16 head
    dims up to 256, CUDA cores for f32 and above 256."""
    bf, f32, f16 = torch.bfloat16, torch.float32, torch.float16
    for d in (8, 16, 32, 40, 48, 64, 80, 96, 128, 136, 200, 256):
        assert tfa._bwd_variant(bf, d) == "sm90"
        assert tfa._bwd_variant(f16, d) == "sm90"
        assert tfa._bwd_variant(f32, d) == "cuda_cores"
    for d in (1, 4, 12, 36, 100, 129, 250, 255):
        assert tfa._bwd_variant(bf, d) == "mma"
        assert tfa._bwd_variant(f16, d) == "mma"
        assert tfa._bwd_variant(f32, d) == "cuda_cores"
    for dtype in (bf, f16, f32):
        assert tfa._bwd_variant(dtype, 257) == "cuda_cores"
        assert tfa._bwd_variant(dtype, 264) == "cuda_cores"
    # the forward takes sm90 at the same head dims, at block_k 128
    for d in range(1, 300):
        for dtype in (bf, f16, f32):
            assert (tfa._bwd_variant(dtype, d) == "sm90") == \
                (tfa._fwd_variant(dtype, d, 128) == "sm90")


def test_backward_counts_reset_and_refuse_bad_variants():
    """After a reset both backward wrappers count zero, in total and per
    variant; a CPU tensor launches nothing; a forced variant the shape
    cannot take is refused before anything launches."""
    tfa.reset_backward_counts()
    for fn in (tfa.flash_attention_dq_cuda, tfa.flash_attention_dkv_cuda):
        assert fn.launches == 0
        assert fn.launches_by_variant == {"sm90": 0, "mma": 0,
                                          "cuda_cores": 0}
    q = torch.zeros(1, 128, 64, dtype=torch.bfloat16)
    lse = torch.zeros(1, 128)
    for fn in (tfa.flash_attention_dq_cuda, tfa.flash_attention_dkv_cuda):
        with pytest.raises(ValueError, match="one CUDA device"):
            fn(q, q, q, q, lse, lse, _variant="sm90")
        with pytest.raises(ValueError, match="one CUDA device"):
            fn(q, q, q, q, lse, lse, _variant="cuda_cores")
        assert fn.launches == 0
        assert sum(fn.launches_by_variant.values()) == 0
    bf = torch.bfloat16
    assert tfa._forced_bwd_variant(bf, 64, None) == "sm90"
    assert tfa._forced_bwd_variant(bf, 64, "mma") == "mma"
    assert tfa._forced_bwd_variant(bf, 32, "mma") == "mma"
    assert tfa._forced_bwd_variant(torch.float32, 64, None) == "cuda_cores"
    assert tfa._forced_bwd_variant(bf, 32, None) == "sm90"
    assert tfa._forced_bwd_variant(torch.float16, 256, "mma") == "mma"
    assert tfa._forced_bwd_variant(bf, 36, None) == "mma"
    for args in ((bf, 36, "sm90"), (torch.float32, 64, "sm90"),
                 (torch.float32, 64, "mma"), (bf, 64, "cuda_cores"),
                 (bf, 128, "fast"), (bf, 264, "sm90")):
        with pytest.raises(ValueError, match="cannot run"):
            tfa._forced_bwd_variant(*args)


# -- the backward: K4 (dQ) and K5 (dK/dV) ------------------------------------

def _bf16_tol(want, ref_max, bits=7):
    """max(2 ulp, 5e-3 * ref_max) elementwise: ``bits`` 7 is bf16's ulp,
    10 f16's."""
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - bits)
    return np.maximum(2 * ulp, 5e-3 * ref_max)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,causal,q_offset,k_offset,k_valid", [
    (32, True, 0, 0, None), (64, False, 0, 0, None), (128, True, 0, 64, None),
    (32, True, 48, 0, 100), (64, False, 0, 0, 72)])
def test_plain_backward_matches_jax_partitioned_bwd(dtype, d, causal,
                                                    q_offset, k_offset,
                                                    k_valid):
    """flash_attention_dq_plain / _dkv_plain against ``_partitioned_bwd``
    (the Pallas ``_dq_kernel`` and ``_dkv_kernel`` in interpret mode) on the
    same q, k, v, do, lse and delta, with 32-row blocks so several blocks
    are skipped or partly masked. f32 within 1e-5 * max|ref| (sums in
    another order); bf16 within max(2 bf16 ulp, 5e-3 * max|ref|) (a sum
    that lands on the other side of a bf16 rounding of ds moves it by an
    ulp)."""
    _check_plain_backward(dtype, d, causal, q_offset, k_offset, k_valid,
                          s=96, sk=128, block_q=32, block_k=32,
                          seed=d + q_offset)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("block_q,causal,q_offset,k_offset,k_valid", [
    (64, True, 0, 0, None), (128, True, 0, 0, None), (128, True, 0, 192, None),
    (64, False, 0, 0, 200)])
def test_plain_backward_matches_jax_partitioned_bwd_at_sm90_tiles(
        dtype, block_q, causal, q_offset, k_offset, k_valid):
    """The same comparison at the sm90 backward kernels' tiles: 64- and
    128-row query blocks against 128-key blocks at head dim 64, a ring hop
    whose keys start at global 192 (rows 0-191 see no key and get exactly
    zero dq), and a key mask at 200, inside a 128-key block."""
    _check_plain_backward(dtype, 64, causal, q_offset, k_offset, k_valid,
                          s=256, sk=256, block_q=block_q, block_k=128,
                          seed=block_q + k_offset)


@pytest.mark.parametrize(
    "dtype,d,s,block_q,block_k,causal,q_offset,k_offset,k_valid", [
        ("bfloat16", 256, 128, 64, 64, True, 0, 64, None),
        ("bfloat16", 48, 256, 128, 128, False, 0, 0, 196),
        ("float16", 64, 256, 128, 128, True, 0, 0, None),
        ("float16", 256, 128, 64, 64, False, 0, 0, 100)])
def test_plain_backward_matches_jax_partitioned_bwd_at_sm90_wide_tiles(
        dtype, d, s, block_q, block_k, causal, q_offset, k_offset, k_valid):
    """The same comparison at the tiles of the sm90 backward's other widths
    and in f16: head dim 256 at 64-key blocks (K4's K/V slots and K5's split
    key tiles at width 256), causal with keys from global 64 (rows 0-63 get
    exactly zero dq) and in f16 with a key mask at 100; ViT's head dim 48
    with its 196 valid keys of 256; f16 at head dim 64 on the 128-key
    blocks. f16 within max(2 f16 ulp, 5e-3 * max|ref|), the bf16 bound in
    f16's ulps."""
    _check_plain_backward(dtype, d, causal, q_offset, k_offset, k_valid,
                          s=s, sk=s, block_q=block_q, block_k=block_k,
                          seed=d + s)


def _check_plain_backward(dtype, d, causal, q_offset, k_offset, k_valid, *,
                          s, sk, block_q, block_k, seed):
    b, h = 1, 2
    rng = np.random.RandomState(seed)
    q, g = (rng.randn(b, h, s, d).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(b, h, sk, d).astype(np.float32) for _ in range(2))
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jq, jk, jv, jg = (jnp.asarray(x, jd) for x in (q, k, v, g))
    scale = 1.0 / np.sqrt(d)
    # jitted: the same interpret-mode kernels, traced once instead of run
    # op by op (about half the time)
    lse = jax.jit(lambda q, k, v: jfa.flash_attention_lse(
        q, k, v, causal, q_offset, k_offset, scale, block_q, block_k,
        k_valid=k_valid)[1])(jq, jk, jv)
    dvec = rng.randn(b, h, s).astype(np.float32)
    jdq, jdk, jdv = jax.jit(jfa._partitioned_bwd(
        causal, q_offset, k_offset, scale, block_q, block_k, True, k_valid))(
            jq, jk, jv, lse, jg, jnp.asarray(dvec))
    flat = lambda x, n: torch.from_numpy(np.array(x, np.float32)).to(
        td).reshape(b * h, n, d)
    tq, tg = flat(jq, s), flat(jg, s)
    tk, tv = flat(jk, sk), flat(jv, sk)
    tl = torch.from_numpy(np.asarray(lse)).reshape(b * h, s)
    tdv = torch.from_numpy(dvec).reshape(b * h, s)
    args = (tq, tk, tv, tg, tl, tdv, causal, q_offset, k_offset, scale,
            block_q, block_k, k_valid)
    dq = tfa.flash_attention_dq_plain(*args)
    dk, dv = tfa.flash_attention_dkv_plain(*args)
    for got, want in ((dq, jdq), (dk, jdk), (dv, jdv)):
        assert got.dtype == td
        got = _np(got).reshape(np.shape(want))
        want = _np(want)
        ref_max = np.abs(want).max()
        tol = 1e-5 * ref_max if dtype == "float32" else \
            _bf16_tol(want, ref_max, 7 if dtype == "bfloat16" else 10)
        assert (np.abs(got - want) <= tol).all(), np.abs(got - want).max()
    if k_offset > q_offset and causal:  # rows that see no key
        assert (_np(dq)[:, :k_offset - q_offset] == 0).all()


def _grads_port(fn, arrs, dtype=torch.float32):
    ts = [t.requires_grad_(True) for t in _torch(arrs, dtype)]
    fn(*ts).backward()
    return [_np(t.grad) for t in ts]


def _grads_jax(fn, arrs, dtype=jnp.float32):
    return [_np(g) for g in jax.jit(jax.grad(fn, argnums=(0, 1, 2)))(
        *_jax(arrs, dtype))]


def test_flash_gradients():
    """``test_ops_parallel.py::test_flash_gradients``: FlashAttentionFn's
    backward (K4/K5's plain versions) against jax.grad through the Pallas
    backward, causal, within 1e-5; and against the f32 reference within
    1e-4 as the JAX test holds it."""
    arrs = _qkv(b=1, h=1, s=128, d=32)
    port = _grads_port(lambda q, k, v: (tfa.flash_attention(
        q, k, v, True) ** 2).sum(), arrs)
    jaxg = _grads_jax(lambda q, k, v: jnp.sum(jfa.flash_attention(
        q, k, v, True) ** 2), arrs)
    ref = _grads_port(lambda q, k, v: (tfa.mha_reference(
        q, k, v, True) ** 2).sum(), arrs)
    for a, b, r in zip(port, jaxg, ref):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(a, r, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kw", [dict(causal=False),
                                dict(causal=True, q_offset=256),
                                dict(causal=True, q_offset=64, k_offset=0)])
def test_flash_gradients_noncausal_and_offsets(kw):
    arrs = _qkv(b=2, h=2, s=256, d=32, seed=5)
    args = (kw["causal"], kw.get("q_offset", 0), kw.get("k_offset", 0))
    port = _grads_port(lambda q, k, v: (tfa.flash_attention(
        q, k, v, *args) ** 2).sum(), arrs)
    jaxg = _grads_jax(lambda q, k, v: jnp.sum(jfa.flash_attention(
        q, k, v, *args) ** 2), arrs)
    for a, b in zip(port, jaxg):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


def test_flash_gradients_bf16_multiblock():
    """bf16 across three 128-row blocks: the port's bf16 gradients against
    JAX's bf16 gradients within max(2 bf16 ulp, 5e-3 * max|g|), and both
    within 0.1 of the f32 reference, as the JAX test holds its own."""
    arrs = _qkv(b=1, h=2, s=384, d=32, seed=7)
    port = _grads_port(lambda q, k, v: (tfa.flash_attention(
        q, k, v, True).float() ** 2).sum(), arrs, torch.bfloat16)
    jaxg = _grads_jax(lambda q, k, v: jnp.sum(jfa.flash_attention(
        q, k, v, True).astype(jnp.float32) ** 2), arrs, jnp.bfloat16)
    ref = _grads_port(lambda q, k, v: (tfa.mha_reference(
        q, k, v, True) ** 2).sum(), arrs)
    for a, b, r in zip(port, jaxg, ref):
        assert (np.abs(a - b) <= _bf16_tol(b, np.abs(b).max())).all()
        np.testing.assert_allclose(a, r, rtol=0.1, atol=0.1)


def test_flash_gradients_fully_masked_rows_zero():
    """Rows that see no key (keys from global 64) get exactly zero dQ and
    add nothing to dK/dV; every gradient finite and equal to JAX's."""
    arrs = _qkv(s=128, seed=9)
    port = _grads_port(lambda q, k, v: (tfa.flash_attention(
        q, k, v, True, 0, 64) ** 2).sum(), arrs)
    jaxg = _grads_jax(lambda q, k, v: jnp.sum(jfa.flash_attention(
        q, k, v, True, 0, 64) ** 2), arrs)
    assert all(np.isfinite(g).all() for g in port)
    assert (port[0][:, :, :64] == 0).all()
    for a, b in zip(port, jaxg):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


def _combine(o1, l1, o2, l2):
    """ring_attention's softmax combine of two partial attentions."""
    lse = torch.logaddexp(l1, l2)
    return o1 * torch.exp(l1 - lse)[..., None] + \
        o2 * torch.exp(l2 - lse)[..., None]


def test_flash_lse_split_combine_gradients():
    """Keys split over two flash_attention_lse calls and softmax-combined
    equal full attention in value and gradients: the lse cotangent folds
    into delta (``delta = rowsum(g * out) - g_lse``). Against jax.grad of
    the same split loss within 1e-5, and the full reference within 1e-4."""
    from ddw_tpu.parallel.ring_attention import _combine as jax_combine

    q, k, v = _qkv(b=1, h=1, s=128, d=32, seed=5)
    arrs = (q, np.concatenate([k, k], 2), np.concatenate([v, v + 1.0], 2))

    def split_port(q, k2, v2):
        o1, l1 = tfa.flash_attention_lse(q, k2[:, :, :128], v2[:, :, :128])
        o2, l2 = tfa.flash_attention_lse(q, k2[:, :, 128:], v2[:, :, 128:])
        return (_combine(o1, l1, o2, l2) ** 2).sum()

    def split_jax(q, k2, v2):
        o1, l1 = jfa.flash_attention_lse(q, k2[:, :, :128], v2[:, :, :128])
        o2, l2 = jfa.flash_attention_lse(q, k2[:, :, 128:], v2[:, :, 128:])
        return jnp.sum(jax_combine(o1, l1, o2, l2)[0] ** 2)

    port = _grads_port(split_port, arrs)
    jaxg = _grads_jax(split_jax, arrs)
    full = _grads_port(lambda q, k, v: (tfa.mha_reference(q, k, v) ** 2)
                       .sum(), arrs)
    for a, b, f in zip(port, jaxg, full):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(a, f, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("causal,q_offset,k_offset,k_valid", [
    (True, 0, 4, 14), (False, 0, 0, None), (True, 8, 0, None)])
def test_flash_attention_fn_float64_gradcheck(causal, q_offset, k_offset,
                                              k_valid):
    """gradcheck of FlashAttentionFn on the plain path in float64, both
    outputs (out and lse) differentiated, 8-row blocks over 16 rows."""
    gen = torch.Generator().manual_seed(0)
    qkv = [torch.randn(1, 16, 4, dtype=torch.float64, generator=gen,
                       requires_grad=True) for _ in range(3)]
    fn = lambda q, k, v: tfa.FlashAttentionFn.apply(  # noqa: E731
        q, k, v, causal, q_offset, k_offset, 0.3, 8, 8, k_valid, True)
    assert torch.autograd.gradcheck(fn, qkv)
    only_q = lambda q: fn(q, *qkv[1:])[0]  # noqa: E731
    assert torch.autograd.gradcheck(only_q, (qkv[0],))


@pytest.mark.parametrize("s", [100, 255])
def test_flash_mha_backward_through_padding(s, monkeypatch):
    """flash_mha(impl='pallas') pads S to a block multiple (f32 blocks
    are multiples of 8: 100 -> 104, 255 -> 256), masks the padded keys with
    k_valid and slices the padded rows off: its gradients equal the xla
    tier's within 1e-5 and JAX's pallas tier's within 1e-5."""
    arrs = _qkv(b=1, h=2, s=s, d=32, seed=s)
    grads = {impl: _grads_port(lambda q, k, v: (tfa.flash_mha(
        q, k, v, True, impl=impl) ** 2).sum(), arrs)
        for impl in ("pallas", "xla")}
    jaxg = _grads_jax(lambda q, k, v: jnp.sum(jfa.flash_mha(
        q, k, v, True, impl="pallas") ** 2), arrs)
    for a, b, c in zip(grads["pallas"], grads["xla"], jaxg):
        assert a.shape == (1, 2, s, 32)
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(a, c, rtol=1e-5, atol=1e-5)


# -- ViT's head dim: 48 (hidden 192 over 4 heads) ----------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,sk,causal,q_offset,k_offset,k_valid", [
    (256, 256, False, 0, 0, 196),     # ViT at 224/16, padded to 256
    (128, 128, True, 0, 96, None),    # causal by offsets: rows 0-95 see
])                                    # no key
def test_plain_forward_at_head_dim_48_matches_jax(dtype, s, sk, causal,
                                                  q_offset, k_offset,
                                                  k_valid):
    """K3's plain version at head dim 48 against the Pallas kernel in
    interpret mode: out and lse, with the tolerances of the other head
    dims."""
    arrs = _qkv(b=1, h=2, s=s, d=48, seed=48 + s, sk=sk)
    tdt = getattr(torch, dtype)
    q, k, v = (t[0] for t in _torch(arrs, tdt))
    out, lse = tfa.flash_attention_plain(q, k, v, causal, q_offset, k_offset,
                                         block_q=128, block_k=64,
                                         k_valid=k_valid)
    jout, jlse = jfa.flash_attention_lse(
        *_jax(arrs, getattr(jnp, dtype)), causal, q_offset, k_offset, None,
        128, 64, interpret=True, k_valid=k_valid)
    got, want = _np(out), _np(jout)[0]
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    else:
        ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
        assert (np.abs(got - want) <= np.maximum(
            2 * ulp, 1e-3 * np.abs(arrs[2]).max())).all()
    np.testing.assert_allclose(_np(lse), _np(jlse)[0], rtol=2e-5, atol=2e-5)
    if k_offset > q_offset and causal:
        assert (got[:, :k_offset - q_offset] == 0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,q_offset,k_offset,k_valid", [
    (False, 0, 0, 72), (True, 0, 32, None)])
def test_plain_backward_at_head_dim_48_matches_jax(dtype, causal, q_offset,
                                                   k_offset, k_valid):
    """K4's and K5's plain versions at head dim 48 against
    ``_partitioned_bwd`` in interpret mode (the tolerances of
    test_plain_backward_matches_jax_partitioned_bwd): non-causal with a
    key mask inside a block, and causal by offsets (rows 0-31 see no
    key)."""
    _check_plain_backward(dtype, 48, causal, q_offset, k_offset, k_valid,
                          s=64, sk=96, block_q=32, block_k=32,
                          seed=480 + q_offset + k_offset)


@pytest.mark.parametrize("kw", [dict(causal=True, q_offset=16, k_valid=80)])
def test_flash_gradients_at_head_dim_48(kw):
    """FlashAttentionFn's backward at head dim 48 against jax.grad through
    the Pallas forward and backward (the VJP of ``flash_attention``)."""
    arrs = _qkv(b=1, h=2, s=96, d=48, seed=7)
    port = _grads_port(lambda q, k, v: (tfa.flash_attention(
        q, k, v, block_q=32, block_k=32, **kw) ** 2).sum(), arrs)
    jaxg = _grads_jax(lambda q, k, v: jnp.sum(jfa.flash_attention(
        q, k, v, block_q=32, block_k=32, interpret=True, **kw) ** 2), arrs)
    for a, b in zip(port, jaxg):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


def test_vit_attention_through_the_kernel_tier_matches_jax(monkeypatch):
    """ViT's attention shape (196 tokens, head dim 48, non-causal) through
    ``flash_mha`` with both thresholds at 0, as a ViT run with
    ``DDW_ATTN_XLA_PLAIN_MAX=0 DDW_ATTN_XLA_CKPT_MAX=0`` takes it: padded to
    a 128 block (Sq = Sk = 256, ``k_valid`` 196) in both packages, the plain
    versions here against the Pallas kernels in interpret mode, forward and
    gradients."""
    for mod in (tfa, jfa):
        monkeypatch.setattr(mod, "_XLA_PLAIN_MAX", 0)
        monkeypatch.setattr(mod, "_XLA_CKPT_MAX", 0)
    arrs = _qkv(b=1, h=2, s=196, d=48, seed=196)
    assert tfa._attn_impl(*_torch(arrs)[:2], "auto") == "pallas"
    assert tfa._pick_block(196, 128, torch.bfloat16) == 128
    port = _grads_port(lambda q, k, v: (tfa.flash_mha(q, k, v) ** 2).sum(),
                       arrs)
    jaxg = _grads_jax(lambda q, k, v: jnp.sum(jfa.flash_mha(
        q, k, v, interpret=True) ** 2), arrs)
    for a, b in zip(port, jaxg):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    out = tfa.flash_mha(*_torch(arrs))
    ref = jfa.flash_mha(*_jax(arrs), interpret=True)
    np.testing.assert_allclose(_np(out), _np(ref), rtol=2e-5, atol=2e-5)


def test_head_dim_48_takes_mma_or_cuda_cores():
    """Head dim 48 (ViT's) runs the sm90 forward in bf16 and f16 at block_k
    128 and the sm90 backward in both (its 96-byte rows read as 64-column
    boxes, zero past the row, at compiled width 64), the mma.sync forward at
    other 16-bit blocks; the CUDA-core kernels in f32. mma.sync can be
    forced in place of either sm90 kernel, sm90 nowhere else."""
    bf, f16, f32 = torch.bfloat16, torch.float16, torch.float32
    assert tfa.compiled_width("mma", 48) == 48
    assert tfa.compiled_width("sm90", 48) == 64
    assert tfa._fwd_variant(bf, 48, 128) == "sm90"
    assert tfa._fwd_variant(bf, 48, 64) == "mma"
    assert tfa._fwd_variant(bf, 48, 40) == "cuda_cores"
    assert tfa._fwd_variant(f32, 48, 128) == "cuda_cores"
    assert tfa._bwd_variant(bf, 48) == tfa._bwd_variant(f16, 48) == "sm90"
    assert tfa._bwd_variant(f32, 48) == "cuda_cores"
    assert tfa._forced_variant(bf, 48, 128, "mma") == "mma"
    assert tfa._forced_bwd_variant(bf, 48, "mma") == "mma"
    assert tfa._forced_bwd_variant(f16, 48, None) == "sm90"
    with pytest.raises(ValueError, match="cannot run"):
        tfa._forced_variant(bf, 48, 64, "sm90")
    with pytest.raises(ValueError, match="cannot run"):
        tfa._forced_bwd_variant(f32, 48, "sm90")


@pytest.mark.parametrize("d", [40, 96])
def test_kernel_inputs_refuse_other_head_dims_by_name(d):
    """Every head dim is a kernel's now (the TPU kernel takes any): head
    dims 40 and 96, and 48, pass the dtype and shape checks in f32, bf16
    and f16, and only the device check refuses a CPU tensor, before
    anything launches. f64, which ddw_tpu (run without x64) never holds, is
    refused by name on any device."""
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        q = torch.zeros(2, 64, d, dtype=dtype)
        lse = torch.zeros(2, 64)
        before = (tfa.flash_attention_cuda.launches,
                  tfa.flash_attention_dq_cuda.launches)
        with pytest.raises(ValueError, match="one CUDA device"):
            tfa._check_kernel_inputs(q, q, q)
        with pytest.raises(ValueError, match="one CUDA device"):
            tfa.flash_attention_cuda(q, q, q)
        with pytest.raises(ValueError, match="one CUDA device"):
            tfa.flash_attention_dq_cuda(q, q, q, q, lse, lse)
        assert (tfa.flash_attention_cuda.launches,
                tfa.flash_attention_dq_cuda.launches) == before
        q48 = torch.zeros(2, 64, 48, dtype=dtype)
        with pytest.raises(ValueError, match="one CUDA device"):
            tfa._check_kernel_inputs(q48, q48, q48)
    q64 = torch.zeros(2, 64, d, dtype=torch.float64)
    with pytest.raises(ValueError, match="64-bit"):
        tfa.flash_attention_cuda(q64, q64, q64)
