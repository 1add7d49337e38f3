"""Rotary position embeddings in the PyTorch port (``ddw_tpu_torch.ops.rope``)
against ``ddw_tpu.ops.rope`` on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddw_tpu.ops import rope as jrope
from ddw_tpu_torch.ops import rope as trope


def test_rope_angles_match_jax():
    pos = np.arange(0, 4096, 37, dtype=np.int32)
    for hd in (2, 16, 64):
        cos, sin = trope.rope_angles(torch.from_numpy(pos), hd)
        jcos, jsin = jrope.rope_angles(jnp.asarray(pos), hd)
        np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), atol=2e-6)
        np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), atol=2e-6)
    with pytest.raises(ValueError, match="even head_dim"):
        trope.rope_angles(torch.arange(4), 7)


@pytest.mark.parametrize("layout,seq_axis", [("bhsd", -2), ("bshd", 1)])
@pytest.mark.parametrize("per_row", [False, True])
def test_apply_rope_matches_jax(layout, seq_axis, per_row):
    rng = np.random.RandomState(0)
    b, h, s, hd = 2, 3, 10, 16
    shape = (b, h, s, hd) if layout == "bhsd" else (b, s, h, hd)
    x = rng.randn(*shape).astype(np.float32)
    pos = (rng.randint(0, 5000, size=(b, s)) if per_row
           else np.arange(7, 7 + s)).astype(np.int32)
    got = trope.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                           seq_axis=seq_axis)
    want = jrope.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                            seq_axis=seq_axis)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-6)


def test_apply_rope_bf16_keeps_dtype_and_tracks_jax():
    rng = np.random.RandomState(1)
    x = rng.randn(2, 12, 4, 8).astype(np.float32)
    pos = np.arange(12, dtype=np.int32)
    got = trope.apply_rope(torch.from_numpy(x).bfloat16(),
                           torch.from_numpy(pos), seq_axis=1)
    want = jrope.apply_rope(jnp.asarray(x, jnp.bfloat16), jnp.asarray(pos),
                            seq_axis=1)
    assert got.dtype == torch.bfloat16
    # one rounding of the f32 rotation to bf16 in each package
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=2e-2)


def test_scores_depend_on_relative_position():
    rng = np.random.RandomState(2)
    q = torch.from_numpy(rng.randn(1, 1, 1, 32).astype(np.float32))
    k = torch.from_numpy(rng.randn(1, 1, 1, 32).astype(np.float32))

    def score(pq, pk):
        rq = trope.apply_rope(q, torch.tensor([pq]))
        rk = trope.apply_rope(k, torch.tensor([pk]))
        return float((rq * rk).sum())

    assert score(5, 3) == pytest.approx(score(105, 103), rel=1e-4)
    assert score(5, 3) != pytest.approx(score(5, 4), rel=1e-3)


def test_apply_rope_refuses_bad_shapes():
    x = torch.zeros(2, 4, 6, 8)
    with pytest.raises(ValueError, match="must match seq dim"):
        trope.apply_rope(x, torch.arange(5))
    with pytest.raises(ValueError, match="head dim"):
        trope.apply_rope(x, torch.arange(8), seq_axis=-1)
