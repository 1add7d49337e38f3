"""The TransformerLM in the PyTorch port (``ddw_tpu_torch.models.lm``) against
``ddw_tpu.models.lm`` on the CPU: logits for learned and rotary positions,
GQA and LoRA in f32 (through both attention tiers) and bf16, greedy
generation; and inside the port, decode against the full forward, the cache
overflow poison, the tile skipping, sampling, training-mode dropout and the
refusals; per-row serving adapters (``forward(adapters=(stacks, idx))``)
against ``ddw_tpu``'s, full and paged."""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddw_tpu.models.lm import build_lm as jax_build_lm
from ddw_tpu.models.lm import generate as jax_generate
from ddw_tpu.utils.config import LMCfg as JaxLMCfg
from ddw_tpu_torch.models.convert import (init_lm_weights,
                                          load_flax_variables,
                                          to_flax_variables)
from ddw_tpu_torch.models.lm import (build_lm, generate,
                                     init_cache, set_cache_lengths)
from ddw_tpu_torch.ops import flash_attention as tfa
from ddw_tpu_torch.utils.config import LMCfg

jfa = importlib.import_module("ddw_tpu.ops.flash_attention")

VOCAB = 32
BASE = dict(vocab_size=VOCAB, max_len=64, hidden=32, depth=2, num_heads=4,
            mlp_dim=64, dropout=0.0, dtype="float32")
VARIANTS = {
    "learned": {},
    "rope": {"pos_encoding": "rope"},
    "gqa": {"num_kv_heads": 2},
    "lora": {"lora_rank": 2, "lora_targets": ("query", "value", "out",
                                              "fc1")},
}


def _pair(seed=0, **kw):
    """(jax model, flax params as numpy, the port model with those params);
    built once per argument set (tests only read them)."""
    return _pair_cached(seed, tuple(sorted(kw.items())))


@functools.cache
def _pair_cached(seed, kw):
    cfg = dict(BASE, **dict(kw))
    jm = jax_build_lm(JaxLMCfg(**cfg))
    params = jm.init({"params": jax.random.PRNGKey(seed)},
                     np.zeros((1, 8), np.int32))["params"]
    params = jax.tree_util.tree_map(np.array, params)
    rng = np.random.RandomState(seed + 100)
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        if jax.tree_util.keystr(path).endswith("['lora_b']"):
            leaf[...] = 0.1 * rng.randn(*leaf.shape)  # adapters that matter
    tm = load_flax_variables(build_lm(LMCfg(**cfg)), {"params": params})
    return jm, params, tm.eval()


def _tokens(b=2, s=24, seed=0):
    return np.random.RandomState(seed).randint(0, VOCAB, (b, s)).astype(
        np.int32)


def _port_logits(tm, toks):
    with torch.inference_mode():
        return tm(torch.from_numpy(toks).long()).float().numpy()


def _jax_logits(jm, params, toks):
    return np.asarray(jm.apply({"params": params}, jnp.asarray(toks)),
                      np.float32)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_f32_logits_match_jax(variant):
    jm, params, tm = _pair(**VARIANTS[variant])
    toks = _tokens()
    np.testing.assert_allclose(_port_logits(tm, toks),
                               _jax_logits(jm, params, toks),
                               rtol=1e-5, atol=1e-5)


def test_f32_logits_match_jax_on_the_pallas_tier(monkeypatch):
    """Both packages forced to the kernel tier (thresholds 0 at test time):
    the port's K3 plain version against the Pallas kernel in interpret
    mode, through rope + GQA."""
    for mod in (tfa, jfa):
        monkeypatch.setattr(mod, "_XLA_PLAIN_MAX", 0)
        monkeypatch.setattr(mod, "_XLA_CKPT_MAX", 0)
    calls = []
    plain = tfa.flash_attention_plain
    monkeypatch.setattr(tfa, "flash_attention_plain",
                        lambda *a, **kw: calls.append(1) or plain(*a, **kw))
    jm, params, tm = _pair(seed=1, pos_encoding="rope", num_kv_heads=2)
    toks = _tokens(s=40, seed=1)
    got = _port_logits(tm, toks)
    assert len(calls) == BASE["depth"]  # one kernel-tier call per layer
    np.testing.assert_allclose(got, _jax_logits(jm, params, toks),
                               rtol=1e-5, atol=1e-5)


def test_bf16_logits_track_jax():
    """bf16 compute (flax dtype placement: projections and GELU in bf16,
    LayerNorm and head in f32). The two frameworks round bf16 at different
    places inside fused ops, so the logits agree to about one bf16 rounding
    of the residual stream: within 5e-2 * std(logits) everywhere."""
    jm, params, tm = _pair(seed=2, dtype="bfloat16", pos_encoding="rope")
    toks = _tokens(seed=2)
    got = _port_logits(tm, toks)
    want = _jax_logits(jm, params, toks)
    assert np.abs(got - want).max() <= 5e-2 * want.std()
    assert (got.argmax(-1) == want.argmax(-1)).mean() > 0.9


@pytest.mark.parametrize("variant", ["learned", "rope", "gqa"])
def test_decode_equals_full_forward(variant):
    """Prefill of 8 tokens then one token at a time through the cache gives
    the full forward's logits at every position."""
    _, _, tm = _pair(seed=3, **VARIANTS[variant])
    toks = torch.from_numpy(_tokens(s=20, seed=3)).long()
    with torch.inference_mode():
        full = tm(toks)
        cache = init_cache(tm, 2)
        steps = [tm(toks[:, :8], cache=cache)]
        for t in range(8, 20):
            steps.append(tm(toks[:, t:t + 1], cache=cache))
    np.testing.assert_allclose(torch.cat(steps, 1).numpy(), full.numpy(),
                               rtol=1e-5, atol=1e-5)
    attn = cache["backbone_block0"]["attn"]
    assert attn["cache_index"] == cache["pos_index"] == 20
    assert attn["cached_key"].shape == (2, 64, tm.kv_heads, 8)


def test_decode_overflow_poisons_output():
    tm = build_lm(LMCfg(**dict(BASE, max_len=8, depth=1)))
    init_lm_weights(tm, torch.Generator().manual_seed(0))
    cache = init_cache(tm.eval(), 1)
    tok = torch.zeros((1, 1), dtype=torch.long)
    with torch.inference_mode():
        for i in range(8):
            assert torch.isfinite(tm(tok, cache=cache)).all(), i
        assert torch.isnan(tm(tok, cache=cache)).all()


def test_decode_work_scales_with_position():
    """Tiles past the filled position are skipped (and counted)."""
    tm = build_lm(LMCfg(**dict(BASE, max_len=1024, hidden=16, num_heads=2)))
    init_lm_weights(tm, torch.Generator().manual_seed(0))
    cache = init_cache(tm.eval(), 1)

    def tiles(c):
        return sum(c[f"backbone_block{i}"]["attn"]["tiles_computed"]
                   for i in range(tm.depth))

    tok = torch.zeros((1, 1), dtype=torch.long)
    with torch.inference_mode():
        tm(tok, cache=cache)
        assert tiles(cache) == 2           # depth 2 x 1 tile
        cache = set_cache_lengths(cache, 800)
        before = tiles(cache)
        tm(tok, cache=cache)
        assert tiles(cache) - before == 8  # depth 2 x tiles 0..3


def test_greedy_generate_matches_jax():
    """Token-identical greedy continuation, on a path whose every argmax wins
    by a margin far above f32 rounding (so the equality is meaningful)."""
    jm, params, tm = _pair(seed=4)
    prompt = _tokens(b=2, s=6, seed=4)
    want = np.asarray(jax_generate(jm, params, prompt, num_steps=10))
    got = generate(tm, torch.from_numpy(prompt), 10).numpy()
    np.testing.assert_array_equal(got, want)
    full = _port_logits(tm, np.concatenate([prompt, got], 1))[:, 5:-1]
    top2 = np.sort(full, -1)[..., -2:]
    assert (top2[..., 1] - top2[..., 0]).min() > 1e-4
    # padded-bucket prefill (prompt_len) in both packages
    padded = np.concatenate([prompt, np.zeros((2, 2), np.int32)], 1)
    want_p = np.asarray(jax_generate(jm, params, padded, num_steps=10,
                                     prompt_len=6))
    got_p = generate(tm, torch.from_numpy(padded), 10, prompt_len=6).numpy()
    np.testing.assert_array_equal(got_p, want_p)
    np.testing.assert_array_equal(got_p, got)


def test_generate_argument_checks():
    _, _, tm = _pair()
    prompt = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(ValueError, match="exceeds"):
        generate(tm, torch.zeros((1, 40), dtype=torch.long), 30)
    with pytest.raises(ValueError, match="requires a generator"):
        generate(tm, prompt, 2, temperature=0.8)
    with pytest.raises(ValueError, match="temperature must be"):
        generate(tm, prompt, 2, temperature=-1.0)
    with pytest.raises(ValueError, match="top_k must be"):
        generate(tm, prompt, 2, top_k=-1)
    with pytest.raises(ValueError, match="top_p must be"):
        generate(tm, prompt, 2, top_p=1.5)
    with pytest.raises(ValueError, match="require temperature"):
        generate(tm, prompt, 2, top_k=3)


def test_seeded_sampling_is_reproducible_inside_the_port():
    _, _, tm = _pair(seed=5)
    prompt = torch.from_numpy(_tokens(b=2, s=5, seed=5))

    def run(seed, **kw):
        return generate(tm, prompt, 16, torch.Generator().manual_seed(seed),
                        **kw)

    a = run(7, temperature=2.0, top_k=8, top_p=0.9)
    assert torch.equal(a, run(7, temperature=2.0, top_k=8, top_p=0.9))
    assert not torch.equal(a, run(8, temperature=2.0, top_k=8, top_p=0.9))
    assert a.min() >= 0 and a.max() < VOCAB
    greedy = generate(tm, prompt, 16)
    assert torch.equal(run(1, temperature=5.0, top_k=1), greedy)
    assert torch.equal(run(1, temperature=5.0, top_p=1e-9), greedy)


def test_unported_options_are_refused_naming_the_roadmap():
    """MoE and sequence parallelism build now (slice 5); the options that
    are wrong in ddw_tpu too stay refused."""
    cfg = LMCfg(**BASE)
    moe = build_lm(LMCfg(**dict(BASE, num_experts=2)), expert_axis="data")
    assert moe.expert_axis == "data" and hasattr(moe.blocks()[0], "moe")
    assert build_lm(cfg, seq_axis="seq").blocks()[0].attn.seq_axis == "seq"
    with pytest.raises(ValueError, match="unknown lora_targets"):
        build_lm(LMCfg(**dict(BASE, lora_rank=2, lora_targets=("qkv",))))
    with pytest.raises(ValueError, match="unknown pos_encoding"):
        build_lm(LMCfg(**dict(BASE, pos_encoding="alibi")))


def test_training_mode_dropout():
    """flax's Dropout after attention and after the MLP of each block, in
    training mode only: masks from the dropout_rng generator (required),
    kept elements scaled by 1 / (1 - rate), the same generator seed giving
    the same logits; eval mode and rate 0 draw nothing."""
    from ddw_tpu_torch.models.lm import dropout

    drop = build_lm(LMCfg(**dict(BASE, dropout=0.1)))
    init_lm_weights(drop, torch.Generator().manual_seed(0))
    toks = torch.from_numpy(_tokens(seed=9)).long()
    with pytest.raises(ValueError, match="dropout_rng"):
        drop.train()(toks)
    with torch.no_grad():
        a = drop.train()(toks, dropout_rng=torch.Generator().manual_seed(1))
        b = drop.train()(toks, dropout_rng=torch.Generator().manual_seed(1))
        c = drop.train()(toks, dropout_rng=torch.Generator().manual_seed(2))
        ev = drop.eval()(toks)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert not torch.equal(a, ev)
    h = torch.ones(20000)
    out = dropout(h, 0.25, torch.Generator().manual_seed(0))
    kept = out != 0
    assert torch.allclose(out[kept], torch.full_like(out[kept], 1 / 0.75))
    assert abs(kept.float().mean().item() - 0.75) < 0.02


def test_remat_is_accepted_and_changes_nothing_in_eval():
    jm, params, tm = _pair(seed=6)
    tr = load_flax_variables(build_lm(LMCfg(**dict(BASE, remat="full"))),
                             {"params": params}).eval()
    toks = _tokens(seed=6)
    np.testing.assert_array_equal(_port_logits(tr, toks),
                                  _port_logits(tm, toks))


def test_init_lm_weights_follow_flax():
    """The port's initialiser gives flax's tree (names and shapes, LoRA and
    GQA included) and flax's scales."""
    cfg = dict(BASE, vocab_size=512, hidden=64, num_heads=4, mlp_dim=256,
               lora_rank=2, num_kv_heads=2)
    tm = build_lm(LMCfg(**cfg))
    init_lm_weights(tm, torch.Generator().manual_seed(0))
    got = to_flax_variables(tm)["params"]
    jm = jax_build_lm(JaxLMCfg(**cfg))
    want = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 8), jnp.int32)))
    assert jax.tree_util.tree_map(np.shape, got) == \
        jax.tree_util.tree_map(lambda s: s.shape, want["params"])
    emb = got["tok_embed"]["embedding"]
    assert abs(emb.std() * np.sqrt(64) - 1) < 0.05
    assert abs(got["pos_embed"].std() / 0.02 - 1) < 0.05
    fc1 = got["backbone_block0"]["fc1"]["kernel"]
    assert abs(fc1.std() * np.sqrt(64) - 1) < 0.05
    assert np.abs(fc1).max() <= 2 / np.sqrt(64) / 0.87962566103423978 + 1e-6
    q = got["backbone_block0"]["attn"]["query"]
    assert (q["lora_b"] == 0).all() and q["lora_a"].std() > 0
    assert (got["LayerNorm_0"]["scale"] == 1).all()


@pytest.mark.parametrize("convention", ["gelu_tanh", "layernorm_eps",
                                        "embed_cast"])
def test_flax_conventions(convention):
    """The flax conventions the LM inherits, each against flax itself (the
    fast variance E[x^2] - E[x]^2 is held by the logits tests above: where
    it differs from the two-pass variance, the f32 sums' order decides)."""
    import flax.linen as fnn
    import torch.nn.functional as F

    from ddw_tpu_torch.models.lm import Embed, LayerNorm

    rng = np.random.RandomState(7)
    if convention == "gelu_tanh":
        x = rng.randn(4096).astype(np.float32) * 3
        got = F.gelu(torch.from_numpy(x), approximate="tanh").numpy()
        np.testing.assert_allclose(got, np.asarray(fnn.gelu(x)), atol=2e-6)
        exact = F.gelu(torch.from_numpy(x)).numpy()
        assert np.abs(exact - np.asarray(fnn.gelu(x))).max() > 1e-4
    elif convention == "layernorm_eps":
        # rows of variance ~1e-5: flax's eps 1e-6 (not torch's 1e-5) shows
        x = (0.01 + 3e-3 * rng.randn(8, 64)).astype(np.float32)
        scale = rng.uniform(0.5, 1.5, 64).astype(np.float32)
        bias = rng.randn(64).astype(np.float32)
        ln = LayerNorm(64)
        with torch.no_grad():
            ln.scale.copy_(torch.from_numpy(scale))
            ln.bias.copy_(torch.from_numpy(bias))
            got = ln(torch.from_numpy(x)).numpy()
        want = np.asarray(fnn.LayerNorm(dtype=jnp.float32).apply(
            {"params": {"scale": scale, "bias": bias}}, x))
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
        torch_default = F.layer_norm(torch.from_numpy(x), (64,),
                                     torch.from_numpy(scale),
                                     torch.from_numpy(bias)).numpy()
        assert np.abs(torch_default - want).max() > 5e-2
    else:
        table = rng.randn(50, 16).astype(np.float32)
        ids = rng.randint(0, 50, (3, 7))
        emb = Embed(50, 16, torch.bfloat16)
        with torch.no_grad():
            emb.embedding.copy_(torch.from_numpy(table))
            got = emb(torch.from_numpy(ids))
        want = fnn.Embed(50, 16, dtype=jnp.bfloat16).apply(
            {"params": {"embedding": table}}, jnp.asarray(ids))
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))


def _adapter_stacks(slots=2, rank=3, seed=5):
    """Seeded per-target stacks in the pool layout ({block: {target:
    (a [slots+1, *in, r], b [slots+1, r, *feats])}}), slot 0 all zeros."""
    rng = np.random.RandomState(seed)
    hd, heads, hid, mlp = 8, 4, 32, 64
    shapes = {"query": ((hid,), (heads, hd)), "key": ((hid,), (heads, hd)),
              "value": ((hid,), (heads, hd)), "out": ((heads, hd), (hid,)),
              "fc1": ((hid,), (mlp,)), "fc2": ((mlp,), (hid,))}
    out = {}
    for i in range(BASE["depth"]):
        blk = {}
        for name, (ins, feats) in shapes.items():
            a = 0.3 * rng.randn(slots + 1, *ins, rank).astype(np.float32)
            b = 0.3 * rng.randn(slots + 1, rank, *feats).astype(np.float32)
            a[0] = 0.0
            b[0] = 0.0
            blk[name] = (a, b)
        out[f"backbone_block{i}"] = blk
    return out


@pytest.mark.parametrize("mode", ["full", "paged"])
def test_per_row_adapters_match_jax(mode):
    """``adapters=(stacks, idx)``: each row's delta from its own slot, f32
    logits within 1e-4 of ddw_tpu's; the slot-0 row is bit-equal to the
    adapter-free forward (the delta is added, never folded in)."""
    from ddw_tpu_torch.models.lm import init_paged_cache

    jm, params, tm = _pair()
    stacks = _adapter_stacks()
    idx = np.array([2, 0, 1], np.int32)
    toks = _tokens(b=3, s=12, seed=4)
    tstacks = {b: {t: (torch.from_numpy(a), torch.from_numpy(bb))
                   for t, (a, bb) in blk.items()}
               for b, blk in stacks.items()}
    if mode == "full":
        want = np.asarray(jm.apply({"params": params}, jnp.asarray(toks),
                                   adapters=(stacks, idx)), np.float32)
        with torch.inference_mode():
            got = tm(torch.from_numpy(toks).long(),
                     adapters=(tstacks, idx)).numpy()
            base = tm(torch.from_numpy(toks).long()).numpy()
    else:
        jp = jax_build_lm(JaxLMCfg(**BASE)).clone(
            decode=True, paged_decode=True, kv_cache_blocks=16,
            kv_block_size=8)
        tables = np.array([[1, 2, 0, 0, 0, 0, 0, 0], [3, 4, 0, 0, 0, 0, 0, 0],
                           [5, 6, 0, 0, 0, 0, 0, 0]], np.int32)
        starts = np.zeros((3,), np.int32)
        cache = jp.init({"params": jax.random.PRNGKey(0)},
                        jnp.zeros((3, 12), jnp.int32), block_tables=tables,
                        start_pos=starts)["cache"]
        want = np.asarray(jp.apply(
            {"params": params, "cache": cache}, jnp.asarray(toks),
            block_tables=tables, start_pos=starts, adapters=(stacks, idx),
            mutable=["cache"])[0], np.float32)
        with torch.inference_mode():
            def run(ad):
                c = init_paged_cache(tm, 16, 8)
                return tm(torch.from_numpy(toks).long(), cache=c,
                          adapters=ad,
                          block_tables=torch.from_numpy(tables).long(),
                          start_pos=starts).numpy()
            got, base = run((tstacks, idx)), run(None)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert np.array_equal(got[1], base[1])
    assert np.abs(got[0] - base[0]).max() > 1e-2   # the adapters matter
