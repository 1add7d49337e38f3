"""Speculative decoding in the PyTorch port
(``ddw_tpu_torch.models.spec_decode``, ``LMPackagedModel.
generate_speculative``) against ``ddw_tpu`` on the CPU: the tokens equal
greedy ``generate`` (the port's and ddw_tpu's) for self-drafts and smaller
drafts at several ``k``, the round statistics equal ddw_tpu's, and
``match_length`` is ddw_tpu's rule."""

import functools

import jax
import numpy as np
import pytest
import torch

from ddw_tpu.models import spec_decode as jax_spec
from ddw_tpu.models.lm import build_lm as jax_build_lm
from ddw_tpu.models.lm import generate as jax_generate
from ddw_tpu.utils.config import LMCfg as JaxLMCfg
from ddw_tpu_torch.models.convert import load_flax_variables
from ddw_tpu_torch.models.lm import build_lm, generate
from ddw_tpu_torch.models.spec_decode import (generate_speculative,
                                              match_length)
from ddw_tpu_torch.serving.lm_package import (LMPackagedModel,
                                              save_lm_package)
from ddw_tpu_torch.utils.config import LMCfg

VOCAB = 48
TARGET = dict(vocab_size=VOCAB, max_len=96, hidden=32, depth=2, num_heads=4,
              mlp_dim=64, dropout=0.0, dtype="float32")
DRAFT = dict(TARGET, hidden=16, depth=1, num_heads=2, mlp_dim=32)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny models: one intra-op thread is fastest, and the test workers
    share the host's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@functools.cache
def _pair(seed, **kw):
    cfg = dict(TARGET, **kw)
    jm = jax_build_lm(JaxLMCfg(**cfg))
    params = jax.tree_util.tree_map(np.array, jm.init(
        {"params": jax.random.PRNGKey(seed)}, np.zeros((1, 8), np.int32))[
            "params"])
    tm = load_flax_variables(build_lm(LMCfg(**cfg)), {"params": params})
    return jm, params, tm.eval()


def test_match_length_is_ddw_tpus_rule():
    rng = np.random.RandomState(0)
    for _ in range(200):
        k = rng.randint(0, 6)
        d = rng.randint(0, 3, k)
        p = rng.randint(0, 3, rng.randint(0, 7))
        assert match_length(d, p) == jax_spec.match_length(d, p)


@pytest.mark.parametrize("draft,k", [("self", 3), ("small", 1),
                                     ("small", 4)])
def test_speculative_equals_greedy_and_ddw_tpu(draft, k):
    jm, params, tm = _pair(0)
    jd, dparams, td = (jm, params, tm) if draft == "self" else _pair(
        1, **{key: DRAFT[key] for key in ("hidden", "depth", "num_heads",
                                          "mlp_dim")})
    prompt = np.random.RandomState(2).randint(0, VOCAB, (1, 9)).astype(
        np.int32)
    out, stats = generate_speculative(tm, td, prompt, 20, k=k)
    greedy = generate(tm, prompt, 20).numpy()
    np.testing.assert_array_equal(out.numpy(), greedy)
    jout, jstats = jax_spec.generate_speculative(jm, params, jd, dparams,
                                                 prompt, 20, k=k)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(
        greedy, np.asarray(jax_generate(jm, params, prompt, 20)))
    assert stats == jstats
    if draft == "self":
        assert stats["acceptance_rate"] == 1.0


def test_packaged_speculative_and_refusals(tmp_path):
    _, params, tm = _pair(0)
    _, dparams, _ = _pair(1, **{key: DRAFT[key] for key in (
        "hidden", "depth", "num_heads", "mlp_dim")})
    pm = LMPackagedModel(save_lm_package(str(tmp_path / "t"),
                                         LMCfg(**TARGET), params),
                         device="cpu")
    dm = LMPackagedModel(save_lm_package(str(tmp_path / "d"),
                                         LMCfg(**DRAFT), dparams),
                         device="cpu")
    prompt = np.arange(1, 6, dtype=np.int32)[None]
    spec, stats = pm.generate_speculative(dm, prompt, 12, k=3)
    np.testing.assert_array_equal(spec, pm.generate(prompt, 12))
    assert spec.dtype == np.int32 and stats["target_calls"] >= 4
    with pytest.raises(ValueError, match="B=1"):
        generate_speculative(tm, tm, np.zeros((2, 3), np.int32), 4)
    with pytest.raises(ValueError, match="k must be"):
        generate_speculative(tm, tm, prompt, 4, k=0)
    with pytest.raises(ValueError, match="lookahead"):
        generate_speculative(tm, tm, prompt, 90, k=4)
    with pytest.raises(ValueError, match="token ids outside"):
        pm.generate_speculative(dm, np.full((1, 3), VOCAB, np.int32), 4)
