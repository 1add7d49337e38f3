"""The yardstick's counts at the cells' shapes against values worked by
hand."""

import json
import os

import pytest

from benchmark.lib import flops

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _config(name):
    with open(os.path.join(ROOT, "benchmark", "configs", f"{name}.json")) as f:
        return json.load(f)


def test_mobilenet_v2_layers_and_step():
    cfg = _config("mobilenet_v2_1.0_224")
    layers = flops.mnv2_layers(cfg, 1)
    # stem 3x3/2 to 32 channels, 17 blocks, the 1x1 to 1280, the head
    assert layers[0] == dict(kind="conv", b=1, h=224, w=224, cin=3, cout=32,
                             k=3, stride=2, ho=112, block=-1)
    assert sum(1 for l in layers if l["kind"] == "dw") == 17
    # stem: 112 * 112 * 32 outputs of 27 multiply-adds
    stem = 2 * 112 * 112 * 32 * 27
    assert flops._fwd_flops(layers[0]) == stem
    # the paper's 300 million multiply-adds (Table 3) for the backbone at
    # width 1.0 and 224 px
    macs = sum(flops._fwd_flops(l) for l in layers[:-1]) / 2
    assert 295e6 < macs < 305e6
    fwd = sum(flops._fwd_flops(l) for l in flops.mnv2_layers(cfg, 256))
    # fine-tuning: 3x forward, less the stem's input gradient
    assert flops.mnv2_step_flops(cfg, 256, False) == \
        pytest.approx(3 * fwd - 256 * stem)
    head = 2 * 256 * 1280 * 5
    # transfer: the backbone's forward, the head's forward and weight
    # gradient
    assert flops.mnv2_step_flops(cfg, 256, True) == \
        pytest.approx(fwd + head)


def test_depthwise_shapes_and_bounds():
    cfg = _config("mobilenet_v2_1.0_224")
    shapes = flops.dw_stride1_shapes(cfg, 256)
    assert len(shapes) == 13
    assert shapes[0] == (256, 112, 112, 32)
    assert shapes[-1] == (256, 7, 7, 960)
    # K1 at [256, 112, 112, 32] bf16: read x, write y, the 9 taps
    nbytes = (2 * 256 * 112 * 112 * 32 + 9 * 32) * 2
    assert flops.k1_bound_s(256, 112, 112, 32, 2) == \
        pytest.approx(nbytes / 3.35e12)
    # K2: read x and g, write the f32 [3, 3, 32] gradient
    nbytes = 2 * 256 * 112 * 112 * 32 * 2 + 9 * 32 * 4
    assert flops.k2_bound_s(256, 112, 112, 32, 2) == \
        pytest.approx(nbytes / 3.35e12)


def test_starcoder2_step_and_attention():
    cfg = _config("starcoder2_3b")
    # per layer q and out 3072^2, k and v 3072 x 256, MLP 2 x 3072 x 12288
    per_layer = 2 * 3072 * 3072 + 2 * 3072 * 256 + 2 * 3072 * 12288
    assert per_layer == 95_944_704
    assert flops.lm_matmul_params(cfg) == 12 * per_layer + 3072 * 49152
    pairs = 4096 * 4097 // 2
    attn = 4 * 4 * 24 * pairs * 128            # QK^T and PV, 4 rows
    step = 6 * 1_302_331_392 * 16384 + 3 * 12 * attn
    assert flops.lm_train_step_flops(cfg, 4, 4096) == pytest.approx(step)
    assert 142e12 < step < 144e12
    # K3 at [96, 4096, 128]: bound by its 412 GFLOP
    k3 = 4 * 96 * pairs * 128
    assert flops.k3_bound_s(96, 4096, 128, 2) == pytest.approx(k3 / 989e12)
    assert flops.k45_bound_s(96, 4096, 128, 2) == \
        pytest.approx(2.5 * k3 / 989e12)
    # a decode token at context 1,000: 2 FLOPs a weight, QK and PV
    assert flops.lm_token_flops(cfg, 1000) == pytest.approx(
        2 * 1_302_331_392 + 4 * 12 * 24 * 128 * 1000)
