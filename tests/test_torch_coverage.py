"""The widened inputs of the port's flash-attention kernels on the CPU: the
plain versions of K3 (forward), K4 (dQ) and K5 (dK/dV) against
``ddw_tpu``'s Pallas kernels in interpret mode at head dims the LM's 64 and
128 never reach (16, 40, 80, 96, 256) in f32 and f16 (bf16 at 80 and 256),
``FlashAttentionFn``'s gradients at head dim 80, a small TransformerLM at
bench.py's SMOKE geometry (hidden 64 over 4 heads: head dim 16) through the
forced kernel tier against ``ddw_tpu``'s logits and one step's gradients,
``flash_mha(impl="pallas")`` at head dims 1 and 300, and the compiled head
dims the Python side names against the CUDA source's."""

import importlib
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddw_tpu.models.lm import build_lm as jax_build_lm
from ddw_tpu.train import lm_step as jlm
from ddw_tpu.utils.config import LMCfg as JaxLMCfg
from ddw_tpu_torch.models.convert import load_flax_variables
from ddw_tpu_torch.models.lm import build_lm
from ddw_tpu_torch.ops import flash_attention as tfa
from ddw_tpu_torch.train import lm_step as tlm
from ddw_tpu_torch.train import step as tstep
from ddw_tpu_torch.utils.config import LMCfg

jfa = importlib.import_module("ddw_tpu.ops.flash_attention")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Causal with offsets and a key mask: keys start at global 32 and stop at 80,
# queries start at 16, so query rows 0-15 see no key at all.
MASKS = dict(causal=True, q_offset=16, k_offset=32, k_valid=80)
S, SK, BLOCK = 64, 96, 32
CASES = [(dt, d) for d in (16, 40, 80, 96, 256)
         for dt in ("float32", "float16")] + \
    [("bfloat16", 80), ("bfloat16", 256)]


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _np(t):
    return np.asarray(t.float() if isinstance(t, torch.Tensor) else
                      jnp.asarray(t, jnp.float32))


def _ulp(want, dtype):
    """One ulp of the 16-bit dtype at each element (bf16: 8 mantissa bits,
    f16: 11)."""
    bits = 7 if dtype == "bfloat16" else 10
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - bits)


def _close(got, want, dtype, rel):
    """f32 within 2e-5 * max|ref|; a 16-bit result within max(2 ulp of its
    dtype, ``rel`` * max|ref|) elementwise (a sum that lands on the other
    side of a rounding moves it by an ulp)."""
    top = np.abs(want).max()
    if dtype == "float32":
        return np.abs(got - want).max() <= 2e-5 * max(top, 1.0)
    return bool((np.abs(got - want) <= np.maximum(
        2 * _ulp(want, dtype), rel * top)).all())


def _inputs(d, seed):
    rng = np.random.RandomState(seed)
    q, g = (rng.randn(1, 2, S, d).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(1, 2, SK, d).astype(np.float32) for _ in range(2))
    return q, k, v, g, rng.randn(1, 2, S).astype(np.float32)


def _flat(x, dtype, n, d):
    return torch.from_numpy(np.array(x, np.float32)).to(
        getattr(torch, dtype)).reshape(2, n, d)


@pytest.mark.parametrize("dtype,d", CASES)
def test_plain_forward_at_any_head_dim_matches_jax(dtype, d):
    """K3's plain version against the Pallas kernel in interpret mode:
    out within ``_close`` (16-bit: 1e-3 of max|out|), lse within 2e-5, and
    the rows that see no key at exactly 0."""
    q, k, v, _, _ = _inputs(d, d)
    jd = getattr(jnp, dtype)
    jq, jk, jv = (jnp.asarray(x, jd) for x in (q, k, v))
    jout, jlse = jax.jit(lambda q, k, v: jfa.flash_attention_lse(
        q, k, v, MASKS["causal"], MASKS["q_offset"], MASKS["k_offset"],
        None, BLOCK, BLOCK, interpret=True, k_valid=MASKS["k_valid"]))(
            jq, jk, jv)
    out, lse = tfa.flash_attention_plain(
        _flat(jq, dtype, S, d), _flat(jk, dtype, SK, d),
        _flat(jv, dtype, SK, d), MASKS["causal"], MASKS["q_offset"],
        MASKS["k_offset"], block_q=BLOCK, block_k=BLOCK,
        k_valid=MASKS["k_valid"])
    assert out.dtype == getattr(torch, dtype) and out.shape == (2, S, d)
    assert _close(_np(out), _np(jout)[0], dtype, 1e-3)
    np.testing.assert_allclose(_np(lse), _np(jlse)[0], rtol=2e-5, atol=2e-5)
    assert (_np(out)[:, :16] == 0).all()


@pytest.mark.parametrize("dtype,d", CASES)
def test_plain_backward_at_any_head_dim_matches_jax(dtype, d):
    """K4's and K5's plain versions against ``_partitioned_bwd`` (the Pallas
    ``_dq_kernel`` and ``_dkv_kernel`` in interpret mode) on the same q, k,
    v, do, lse and delta: f32 within 2e-5 * max|ref|, 16-bit within
    max(2 ulp, 5e-3 * max|ref|); rows that see no key get exactly zero
    dq."""
    q, k, v, g, dvec = _inputs(d, 100 + d)
    jd = getattr(jnp, dtype)
    jq, jk, jv, jg = (jnp.asarray(x, jd) for x in (q, k, v, g))
    scale = 1.0 / np.sqrt(d)
    lse = jax.jit(lambda q, k, v: jfa.flash_attention_lse(
        q, k, v, MASKS["causal"], MASKS["q_offset"], MASKS["k_offset"],
        scale, BLOCK, BLOCK, k_valid=MASKS["k_valid"])[1])(jq, jk, jv)
    jdq, jdk, jdv = jax.jit(jfa._partitioned_bwd(
        MASKS["causal"], MASKS["q_offset"], MASKS["k_offset"], scale, BLOCK,
        BLOCK, True, MASKS["k_valid"]))(jq, jk, jv, lse, jg,
                                        jnp.asarray(dvec))
    args = (_flat(jq, dtype, S, d), _flat(jk, dtype, SK, d),
            _flat(jv, dtype, SK, d), _flat(jg, dtype, S, d),
            torch.from_numpy(np.asarray(lse)).reshape(2, S),
            torch.from_numpy(dvec).reshape(2, S), MASKS["causal"],
            MASKS["q_offset"], MASKS["k_offset"], scale, BLOCK, BLOCK,
            MASKS["k_valid"])
    dq = tfa.flash_attention_dq_plain(*args)
    dk, dv = tfa.flash_attention_dkv_plain(*args)
    for got, want in ((dq, jdq), (dk, jdk), (dv, jdv)):
        assert got.dtype == getattr(torch, dtype)
        assert _close(_np(got).reshape(np.shape(want)), _np(want), dtype,
                      5e-3)
    assert (_np(dq)[:, :16] == 0).all()


def test_flash_gradients_at_head_dim_80():
    """FlashAttentionFn's backward at head dim 80 (the mma kernels' compiled
    width 96, zero-filled past 80) against jax.grad through the Pallas
    forward and backward, with both masks, in f32 within 1e-5 * max|grad|
    (sums over 80 columns in another order)."""
    q, k, v, _, _ = _inputs(80, 7)
    kw = dict(block_q=BLOCK, block_k=BLOCK, **MASKS)
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    (tfa.flash_attention(*ts, **kw) ** 2).sum().backward()
    port = [_np(t.grad) for t in ts]
    jaxg = jax.jit(jax.grad(lambda q, k, v: jnp.sum(jfa.flash_attention(
        q, k, v, interpret=True, **kw) ** 2), argnums=(0, 1, 2)))(
            *(jnp.asarray(x) for x in (q, k, v)))
    for a, b in zip(port, jaxg):
        b = _np(b)
        assert np.abs(a - b).max() <= 1e-5 * max(np.abs(b).max(), 1.0)
    assert (port[0][:, :, :16] == 0).all()


# bench.py's SMOKE LM geometry: hidden 64 over 4 heads, head dim 16
SMOKE = dict(vocab_size=64, max_len=64, hidden=64, depth=2, num_heads=4,
             mlp_dim=128, dropout=0.0, dtype="float32")


def _force_kernel_tier(monkeypatch):
    for mod in (tfa, jfa):
        monkeypatch.setattr(mod, "_XLA_PLAIN_MAX", 0)
        monkeypatch.setattr(mod, "_XLA_CKPT_MAX", 0)


def test_smoke_lm_at_head_dim_16_on_the_kernel_tier_matches_jax(monkeypatch):
    """A 2-layer TransformerLM with head dim 16 through the forced kernel
    tier in both packages (K3-K5's plain versions here, the Pallas kernels
    in interpret mode there): logits within 1e-5, and one training step's
    loss within 1e-5 and per-leaf gradients within 1e-5 relative plus
    1e-6."""
    _force_kernel_tier(monkeypatch)
    jm = jax_build_lm(JaxLMCfg(**SMOKE))
    params = jax.tree_util.tree_map(np.array, jax.jit(jm.init)(
        {"params": jax.random.PRNGKey(3)}, np.zeros((1, 8), np.int32))[
            "params"])
    tm = load_flax_variables(build_lm(LMCfg(**SMOKE)), {"params": params})
    toks = np.random.RandomState(3).randint(0, 64, (2, 41)).astype(np.int32)
    x, y = toks[:, :-1], toks[:, 1:]
    calls = []
    plain = tfa.flash_attention_plain
    monkeypatch.setattr(tfa, "flash_attention_plain",
                        lambda *a, **kw: calls.append(a[0].shape) or plain(
                            *a, **kw))
    with torch.inference_mode():
        got = tm.eval()(torch.from_numpy(x).long()).float().numpy()
    assert calls == [(2 * 4, 40, 16)] * 2  # one kernel-tier call a layer
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)

    state = tstep.TrainState(tm.train(), {}, 0)
    loss, _, grads = tlm.lm_forward_and_grads(
        state, torch.from_numpy(x), torch.from_numpy(y), None)

    def jloss(p):
        return jlm.lm_loss(jm.apply({"params": p}, jnp.asarray(x),
                                    train=True), jnp.asarray(y))

    jl, jg = jax.jit(jax.value_and_grad(jloss))(params)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    from ddw_tpu_torch.models.convert import to_flax_variables

    with torch.no_grad():
        for n, p in tm.named_parameters():
            p.copy_(grads[n])
    flat = dict(jax.tree_util.tree_flatten_with_path(
        to_flax_variables(tm)["params"])[0])
    for path, w in jax.tree_util.tree_flatten_with_path(
            jax.device_get(jg))[0]:
        np.testing.assert_allclose(np.asarray(flat[path]), np.asarray(w),
                                   rtol=1e-5, atol=1e-6,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("d", [1, 300])
def test_flash_mha_pallas_takes_any_head_dim(d):
    """flash_mha(impl="pallas") at head dim 1 and 300 (above the mma
    kernels' 256) runs the plain versions on CPU tensors and agrees with the
    xla tier, value and gradients, within 1e-5 * max|ref| (sums over up to
    300 columns in another order)."""
    rng = np.random.RandomState(d)
    arrs = [rng.randn(1, 2, 40, d).astype(np.float32) for _ in range(3)]
    outs = {}
    for impl in ("pallas", "xla"):
        ts = [torch.from_numpy(a).requires_grad_(True) for a in arrs]
        out = tfa.flash_mha(*ts, causal=True, impl=impl)
        (out ** 2).sum().backward()
        outs[impl] = [_np(out.detach())] + [_np(t.grad) for t in ts]
    for a, b in zip(outs["pallas"], outs["xla"]):
        assert np.abs(a - b).max() <= 1e-5 * max(np.abs(b).max(), 1.0)


def test_compiled_widths_match_the_cuda_source():
    """ops/flash_attention.py names the head dims the CUDA kernels are
    compiled for (compiled_width); csrc/flash_common.cuh's mma_width and
    cc_width, and the sm90_width of csrc/flash_fwd_sm90.cu (K3) and
    csrc/flash_bwd_sm90.cu (K4, K5) and the head dims their C entries take,
    hold the same ladders."""
    csrc = os.path.join(REPO, "ddw_tpu_torch", "ops", "csrc")
    src = open(os.path.join(csrc, "flash_common.cuh")).read()
    sm90 = open(os.path.join(csrc, "flash_fwd_sm90.cu")).read()
    sm90_bwd = open(os.path.join(csrc, "flash_bwd_sm90.cu")).read()

    def ladder(fn, text=src):
        body = re.search(fn + r"\(int d\) \{(.*?)\}", text, re.S).group(1)
        return tuple(int(x) for x in re.findall(r"\? (\d+)", body)) + (
            int(re.search(r": (\d+);", body).group(1)),)

    assert ladder("mma_width") == tfa._MMA_WIDTHS
    assert ladder("cc_width") == tfa._CC_WIDTHS
    assert ladder("sm90_width", sm90) == tfa._SM90_WIDTHS
    # the widths each part instantiates, and the entry's bounds on d
    assert tuple(int(w) for w in re.findall(r"case (\d+): return run<\1>",
                                            sm90)) + (256,) == \
        tfa._SM90_WIDTHS
    assert int(re.search(r"kMaxD = (\d+);", sm90).group(1)) == \
        tfa._SM90_WIDTHS[-1] == tfa._MMA_MAX_HEAD_DIM
    assert "d % 8 != 0" in sm90 and tfa._SM90_HEAD_DIM_STEP == 8
    # the backward's: the same ladder, widths and bounds on d
    assert ladder("sm90_width", sm90_bwd) == tfa._SM90_WIDTHS
    assert tuple(int(w) for w in re.findall(
        r"case (\d+): return run<\1, kDkv>", sm90_bwd)) + (256,) == \
        tfa._SM90_WIDTHS
    assert int(re.search(r"kMaxD = (\d+);", sm90_bwd).group(1)) == \
        tfa._SM90_WIDTHS[-1]
    assert "d < 8 || d > kMaxD || d % 8 != 0" in sm90_bwd
    assert [tfa.compiled_width("sm90", d) for d in (8, 40, 64, 80, 96, 128,
                                                    136, 256)] == \
        [64, 64, 64, 128, 128, 128, 256, 256]
    assert int(re.search(r"kMmaMaxD = (\d+);", src).group(1)) == \
        tfa._MMA_MAX_HEAD_DIM
    assert [tfa.compiled_width("mma", d) for d in (1, 16, 17, 40, 80, 96,
                                                   100, 129, 256)] == \
        [16, 16, 32, 48, 96, 96, 128, 256, 256]
    assert [tfa.compiled_width("cuda_cores", d) for d in (1, 17, 33, 64, 65,
                                                          300, 512)] == \
        [16, 32, 64, 64, 128, 320, 512]
