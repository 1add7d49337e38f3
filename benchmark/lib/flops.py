"""The yardstick: the H100's published peaks, and the operations and bytes
of each model and kernel operation, counted from shapes.

Peaks are NVIDIA's data sheet for the H100 SXM, dense rates at the full
700 W: 989 TFLOP/s in bf16 and fp16 on the tensor cores, 67 TFLOP/s in
float32 on the CUDA cores, 3.35 TB/s of HBM. A kernel's least time is the
larger of its bytes over the bandwidth and its operations over the peak of
the units it runs on; bytes count each input read once and each output
written once, whatever the kernel reads again; attention counts the causal
pairs only. Model FLOPs count the matrix products and convolutions of the
forward and backward passes (two per multiply-add), no recomputation, no
elementwise work.
"""

from __future__ import annotations

BF16_TENSOR_FLOPS = 989e12
F32_CUDA_CORE_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


def bound_s(flops: float, nbytes: float, peak: float) -> float:
    """The least time of an operation: bytes or operations, whichever
    bounds it."""
    return max(nbytes / HBM_BYTES_PER_S, flops / peak)


# -- MobileNetV2 --------------------------------------------------------------

def make_divisible(v: float, divisor: int = 8) -> int:
    """Sandler et al.'s channel rounding: the nearest multiple of
    ``divisor``, never more than 10% below ``v``."""
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def mnv2_layers(cfg: dict, batch: int) -> list[dict]:
    """Every convolution and the head of MobileNetV2 at ``batch``, in
    order: ``kind`` ("conv", "dw" or "dense"), input ``[B, H, W, Cin]``,
    output spatial size, ``cout``, ``k``, ``stride``, and the index of the
    inverted-residual block (-1 outside one)."""
    wm = cfg["width_multiplier"]
    size = cfg["image_size"]
    layers = []
    ch = make_divisible(cfg["first_channels"] * wm)

    def add(kind, cin, cout, k, stride, h, block):
        out = -(-h // stride)
        layers.append(dict(kind=kind, b=batch, h=h, w=h, cin=cin, cout=cout,
                           k=k, stride=stride, ho=out, block=block))
        return out

    h = add("conv", cfg["channels"], ch, 3, 2, size, -1)
    block = 0
    for t, c, n, s in cfg["inverted_residual_setting"]:
        out_ch = make_divisible(c * wm)
        for j in range(n):
            stride = s if j == 0 else 1
            hidden = ch * t
            if t != 1:
                add("conv", ch, hidden, 1, 1, h, block)
            h = add("dw", hidden, hidden, 3, stride, h, block)
            add("conv", hidden, out_ch, 1, 1, h, block)
            ch = out_ch
            block += 1
    last = make_divisible(cfg["last_channels"] * max(1.0, wm))
    add("conv", ch, last, 1, 1, h, -1)
    layers.append(dict(kind="dense", b=batch, h=1, w=1, cin=last,
                       cout=cfg["num_classes"], k=1, stride=1, ho=1,
                       block=-1))
    return layers


def _fwd_flops(layer: dict) -> float:
    cin_per_out = 1 if layer["kind"] == "dw" else layer["cin"]
    return (2.0 * layer["b"] * layer["ho"] * layer["ho"] * layer["cout"]
            * cin_per_out * layer["k"] * layer["k"])


def mnv2_step_flops(cfg: dict, batch: int, freeze_base: bool) -> float:
    """Model FLOPs of one training step. Fine-tuning: every layer's
    forward and weight gradient, and the input gradient of every layer but
    the stem. Transfer (``freeze_base``): the backbone's forward, the head's
    forward and weight gradient."""
    total = 0.0
    for i, layer in enumerate(mnv2_layers(cfg, batch)):
        f = _fwd_flops(layer)
        if freeze_base and layer["kind"] != "dense":
            total += f
        else:
            total += f * (2 if i == 0 or freeze_base else 3)
    return total


def dw_stride1_shapes(cfg: dict, batch: int) -> list[tuple[int, int, int, int]]:
    """``[B, H, W, C]`` of the stride-1 depthwise layers, the port's K1/K2
    path."""
    return [(l["b"], l["h"], l["w"], l["cin"]) for l in mnv2_layers(cfg, batch)
            if l["kind"] == "dw" and l["stride"] == 1]


def k1_bound_s(b: int, h: int, w: int, c: int, nbytes: int) -> float:
    """Depthwise 3x3 forward (or input gradient): read x and the taps once,
    write y once; 9 multiply-adds an output element on the CUDA cores."""
    elems = b * h * w * c
    return bound_s(18.0 * elems, (2 * elems + 9 * c) * nbytes,
                   F32_CUDA_CORE_FLOPS)


def k2_bound_s(b: int, h: int, w: int, c: int, nbytes: int) -> float:
    """Depthwise 3x3 weight gradient: read x and g once, write the f32
    ``[3, 3, C]`` gradient once; 9 multiply-adds an element."""
    elems = b * h * w * c
    return bound_s(18.0 * elems, 2 * elems * nbytes + 9 * c * 4,
                   F32_CUDA_CORE_FLOPS)


# -- the decoder LM -----------------------------------------------------------

def lm_dims(cfg: dict) -> dict:
    hidden = cfg["hidden_size"]
    heads = cfg["num_attention_heads"]
    return dict(hidden=hidden, heads=heads, kv=cfg["num_key_value_heads"],
                hd=hidden // heads, mlp=cfg["intermediate_size"],
                layers=cfg["num_hidden_layers"], vocab=cfg["vocab_size"])


def lm_matmul_params(cfg: dict) -> int:
    """Weights that multiply every token: the projections of every block
    and the vocab head (not the embedding, a gather)."""
    d = lm_dims(cfg)
    per_layer = (2 * d["hidden"] * d["heads"] * d["hd"]
                 + 2 * d["hidden"] * d["kv"] * d["hd"]
                 + 2 * d["hidden"] * d["mlp"])
    return d["layers"] * per_layer + d["hidden"] * d["vocab"]


def causal_pairs(s: int) -> int:
    return s * (s + 1) // 2


def attn_fwd_flops(rows: int, heads: int, s: int, hd: int) -> float:
    """Q.K^T and P.V over the causal pairs of every head."""
    return 4.0 * rows * heads * causal_pairs(s) * hd


def lm_train_step_flops(cfg: dict, rows: int, seq: int) -> float:
    """Forward and backward of one step: 6 FLOPs a weight a token, and 3x
    the causal attention forward of every layer."""
    d = lm_dims(cfg)
    return (6.0 * lm_matmul_params(cfg) * rows * seq
            + 3.0 * d["layers"] * attn_fwd_flops(rows, d["heads"], seq,
                                                 d["hd"]))


def lm_token_flops(cfg: dict, context: int) -> float:
    """Forward FLOPs of one token that attends ``context`` positions."""
    d = lm_dims(cfg)
    return (2.0 * lm_matmul_params(cfg)
            + 4.0 * d["layers"] * d["heads"] * d["hd"] * context)


def lm_prefill_flops(cfg: dict, n: int) -> float:
    """Forward FLOPs of an ``n``-token prompt, causal."""
    d = lm_dims(cfg)
    return (2.0 * lm_matmul_params(cfg) * n
            + d["layers"] * attn_fwd_flops(1, d["heads"], n, d["hd"]))


def k3_bound_s(bh: int, s: int, hd: int, nbytes: int) -> float:
    """Causal attention forward on ``[bh, s, hd]``: read q, k, v once,
    write o and the f32 logsumexp once; two products over the causal
    pairs."""
    flops = 4.0 * bh * causal_pairs(s) * hd
    nbytes_all = 4 * bh * s * hd * nbytes + bh * s * 4
    return bound_s(flops, nbytes_all, BF16_TENSOR_FLOPS)


def k45_bound_s(bh: int, s: int, hd: int, nbytes: int) -> float:
    """Causal attention backward on ``[bh, s, hd]``: read q, k, v, dO and
    the f32 logsumexp and delta once, write dq, dk, dv once; five products
    over the causal pairs (the scores again, dP, dV, dQ, dK)."""
    flops = 10.0 * bh * causal_pairs(s) * hd
    nbytes_all = 7 * bh * s * hd * nbytes + 2 * bh * s * 4
    return bound_s(flops, nbytes_all, BF16_TENSOR_FLOPS)
