"""Parity of the benchmark's environment helpers and of the shared step core.

The same environments go to ``ddw_tpu.utils.config`` and
``ddw_tpu_torch.utils.config`` (``DDW_REQUIRE_TPU`` and ``DDW_REQUIRE_GPU``
for the device refusal), and one adam update of the same seeded f32 params
and gradients goes through both packages' ``apply_gradients``. The refusal
runs with no TPU and with ``torch.cuda.is_available`` made false, on any
host.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddw_tpu.train import step as jax_step
from ddw_tpu.utils import config as jax_config
from ddw_tpu.utils.config import TrainCfg as JaxTrainCfg
from ddw_tpu_torch.train import step as torch_step
from ddw_tpu_torch.utils import config as torch_config
from ddw_tpu_torch.utils.config import TrainCfg

SPELLINGS = {"": False, "0": False, "false": False, "No": False,
             " OFF ": False, "1": True, "true": True, " Yes": True,
             "ON": True}
REFUSED = ("2", "y", "enable", "truth", "-1")


@pytest.mark.parametrize("value", sorted(SPELLINGS) + list(REFUSED))
def test_env_flag_spellings(monkeypatch, value):
    monkeypatch.setenv("DDW_TEST_FLAG", value)
    if value in SPELLINGS:
        for mod in (jax_config, torch_config):
            assert mod.env_flag("DDW_TEST_FLAG") is SPELLINGS[value]
        return
    msgs = []
    for mod in (jax_config, torch_config):
        with pytest.raises(ValueError, match="must be a boolean flag") as e:
            mod.env_flag("DDW_TEST_FLAG")
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_require_device_refuses_without_one(monkeypatch, capsys):
    """``require_tpu_or_exit`` under ``DDW_REQUIRE_TPU=1`` and
    ``require_gpu_or_exit`` under ``DDW_REQUIRE_GPU=1`` both exit 4 with
    one refusal on stderr; unset, both return ``"cpu"``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("DDW_REQUIRE_TPU", raising=False)
    monkeypatch.delenv("DDW_REQUIRE_GPU", raising=False)
    assert jax_config.require_tpu_or_exit() == "cpu"
    assert torch_config.require_gpu_or_exit() == "cpu"
    for flag, fn in (("DDW_REQUIRE_TPU", jax_config.require_tpu_or_exit),
                     ("DDW_REQUIRE_GPU", torch_config.require_gpu_or_exit)):
        monkeypatch.setenv(flag, "1")
        with pytest.raises(SystemExit) as e:
            fn("bench")
        assert e.value.code == 4
        err = capsys.readouterr().err
        assert flag in err and "refusing to bench" in err
        assert len(err.strip().splitlines()) == 1
        monkeypatch.delenv(flag)
    monkeypatch.setenv("DDW_REQUIRE_GPU", "maybe")
    with pytest.raises(ValueError, match="DDW_REQUIRE_GPU"):
        torch_config.require_gpu_or_exit()


class _Params(torch.nn.Module):
    def __init__(self, tree):
        super().__init__()
        for name, value in tree.items():
            self.register_parameter(name, torch.nn.Parameter(
                torch.from_numpy(value.copy())))


def test_apply_gradients_matches():
    """One adam update of the same params and gradients: the port's
    in-place ``apply_gradients`` against ``ddw_tpu``'s, and the step
    advanced in both."""
    rng = np.random.RandomState(22)
    params = {"kernel": rng.randn(6, 5).astype(np.float32),
              "bias": rng.randn(5).astype(np.float32)}
    grads = {k: rng.randn(*v.shape).astype(np.float32)
             for k, v in params.items()}
    jtx = jax_step.make_optimizer(JaxTrainCfg(optimizer="adam",
                                              learning_rate=1e-2))
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = jax_step.TrainState(jparams, {}, jtx.init(jparams),
                                 jnp.zeros((), jnp.int32))
    jnew = jax_step.apply_gradients(jstate, jtx,
                                    jax.tree.map(jnp.asarray, grads), {})
    ttx = torch_step.make_optimizer(TrainCfg(optimizer="adam",
                                             learning_rate=1e-2))
    tstate = torch_step.init_state(_Params(params), ttx)
    out = torch_step.apply_gradients(
        tstate, ttx, {k: torch.from_numpy(v) for k, v in grads.items()})
    assert out is tstate and tstate.step == int(jnew.step) == 1
    scale = max(float(np.abs(v).max()) for v in params.values())
    for name in params:
        got = tstate.params[name].detach().numpy()
        assert not np.array_equal(got, params[name]), name
        np.testing.assert_allclose(got, np.asarray(jnew.params[name]),
                                   rtol=0, atol=1e-6 * scale, err_msg=name)
