"""The plain references against the port at a tiny size on the CPU, both
in float32: the same function, to rounding."""

import copy

import pytest
import torch

from benchmark.families import mobilenet_v2 as mnv2_family
from benchmark.families import transformer_lm as lm_family
from benchmark.lib import drivers, weights
from benchmark.reference import decoder, mobilenet_v2
import tiny


def test_decoder_matches_the_port():
    cfg = dict(copy.deepcopy(tiny.TINY_LM), dtype="float32")
    model = lm_family.build(cfg, {}, "cpu").eval()
    specs = decoder.specs(cfg)
    weights.draw(specs, lm_family.init, 11, "cpu",
                 into=drivers._check_specs(model, specs, buffers=False))
    p = weights.draw(specs, lm_family.init, 11, "cpu")
    tokens = torch.randint(0, cfg["vocab_size"], (1, 40),
                           generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        want = model(tokens)[0]
    got = decoder.logits_at(cfg, p, tokens[0], range(40))
    assert torch.allclose(got, want, atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("train", [True, False])
def test_mobilenet_v2_matches_the_port(train):
    from ddw_tpu_torch.models.registry import build_model
    from ddw_tpu_torch.utils.config import ModelCfg

    cfg = dict(copy.deepcopy(tiny.TINY_MNV2), dtype="float32", dropout=0.0)
    model = build_model(ModelCfg(
        name="mobilenet_v2", num_classes=5, dropout=0.0, freeze_base=False,
        width_mult=cfg["width_multiplier"], dtype="float32",
        dw_impl="pallas"), (32, 32))
    params, buffers = mobilenet_v2.specs(cfg)
    weights.draw(params + buffers, mnv2_family.init, 5, "cpu",
                 into=drivers._check_specs(model, params + buffers, True))
    p = weights.draw(params + buffers, mnv2_family.init, 5, "cpu")
    x = torch.rand(4, 32, 32, 3, generator=torch.Generator().manual_seed(1))
    model.train(train)
    with torch.no_grad():
        want = model(x * 2 - 1)
    got = mobilenet_v2.logits(cfg, p, p, x * 2 - 1, train=train,
                              freeze_base=False, keep=None)
    # in training mode the port's BatchNorm takes the fast variance
    # E[x^2] - E[x]^2, the reference the two-pass one: float32 cancellation
    # on channels whose mean is large against their spread, over 4 images
    tol = 2e-3 if train else 1e-4
    assert torch.allclose(got, want, atol=tol, rtol=tol)


def test_adam_matches_the_ports_first_steps():
    from ddw_tpu_torch.train.step import Optimizer

    from benchmark.reference.adam import Adam

    g = torch.Generator().manual_seed(2)
    p0 = {"w": torch.randn(64, generator=g)}
    grads = [{"w": torch.randn(64, generator=g)} for _ in range(3)]
    port = Optimizer("adam", 1e-3)
    pp = {"w": p0["w"].clone()}
    state = port.init(pp)
    ref = {"w": p0["w"].clone()}
    opt = Adam(ref, 1e-3)
    for gr in grads:
        port.update(pp, gr, state)
        opt.step(ref, gr)
    assert torch.allclose(pp["w"], ref["w"], atol=1e-7)
