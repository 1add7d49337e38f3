"""Plain float32 MobileNetV2 with the workshop's transfer head.

Written from Sandler et al. 2018 (arXiv:1801.04381): a 3x3 stride-2 stem,
inverted residual blocks (1x1 expansion unless the factor is 1, 3x3
depthwise, linear 1x1 projection; a residual where the stride is 1 and the
widths agree), a 1x1 convolution to 1,280 channels, BatchNorm after every
convolution and ReLU6 after all but the projections. The head is the
workshop's (``02_model_training_single_node.py``): global average pooling,
Dropout(0.5), Dense(num_classes); the loss is sparse categorical
cross-entropy, the optimizer Adam.

Departures from the paper, all of them the Keras model the workshop
fine-tunes: "same" padding with TensorFlow's split (one more row and column
after than before on a stride-2 convolution of an even size), BatchNorm with
epsilon 1e-3 and the biased batch variance, no bias on the convolutions.

Parameters are passed in a dict, named and laid out as the port's
checkpoints lay them out (flax's names: ``backbone.InvertedResidual_3.
ConvBN_1.Conv_0.weight``; a convolution ``[out, in, kh, kw]``, a depthwise
one ``[3, 3, C]``, the head ``[classes, 1280]``), so that one dict of seeded
weights feeds the program and this reference. NHWC images in [-1, 1].
Nothing of the program is imported.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference.adam import Adam
from benchmark.reference.precision import FLOAT32, Precision


def make_divisible(v: float, divisor: int = 8) -> int:
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def blocks(cfg: dict) -> list[dict]:
    """The inverted residual blocks: input and output widths, expansion,
    stride."""
    wm = cfg["width_multiplier"]
    ch = make_divisible(cfg["first_channels"] * wm)
    out = []
    for t, c, n, s in cfg["inverted_residual_setting"]:
        oc = make_divisible(c * wm)
        for j in range(n):
            out.append(dict(cin=ch, cout=oc, t=t, stride=s if j == 0 else 1))
            ch = oc
    return out


def _convbn(prefix: str, cout: int, wshape: tuple) -> tuple[list, list]:
    params = [(f"{prefix}.Conv_0.weight", wshape),
              (f"{prefix}.BatchNorm_0.scale", (cout,)),
              (f"{prefix}.BatchNorm_0.bias", (cout,))]
    buffers = [(f"{prefix}.BatchNorm_0.mean", (cout,)),
               (f"{prefix}.BatchNorm_0.var", (cout,))]
    return params, buffers


def specs(cfg: dict) -> tuple[list, list]:
    """(parameters, BatchNorm running statistics): names and shapes, in
    the model's order."""
    params, buffers = [], []

    def add(pair):
        params.extend(pair[0])
        buffers.extend(pair[1])

    first = make_divisible(cfg["first_channels"] * cfg["width_multiplier"])
    add(_convbn("backbone.ConvBN_0", first, (first, cfg["channels"], 3, 3)))
    ch = first
    for i, b in enumerate(blocks(cfg)):
        hidden = b["cin"] * b["t"]
        j = 0
        if b["t"] != 1:
            add(_convbn(f"backbone.InvertedResidual_{i}.ConvBN_0", hidden,
                        (hidden, b["cin"], 1, 1)))
            j = 1
        add(_convbn(f"backbone.InvertedResidual_{i}.ConvBN_{j}", hidden,
                    (3, 3, hidden)))
        add(_convbn(f"backbone.InvertedResidual_{i}.ConvBN_{j + 1}",
                    b["cout"], (b["cout"], hidden, 1, 1)))
        ch = b["cout"]
    last = make_divisible(cfg["last_channels"] * max(1.0, cfg["width_multiplier"]))
    add(_convbn("backbone.ConvBN_1", last, (last, ch, 1, 1)))
    params += [("head.weight", (cfg["num_classes"], last)),
               ("head.bias", (cfg["num_classes"],))]
    return params, buffers


def _same(n: int, k: int, s: int) -> tuple[int, int]:
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class _Net:
    def __init__(self, cfg: dict, p: dict, buf: dict, train_bn: bool,
                 prec: Precision):
        self.cfg, self.p, self.buf = cfg, p, buf
        self.train_bn, self.prec = train_bn, prec

    def convbn(self, prefix: str, x: torch.Tensor, stride: int,
               act: bool) -> torch.Tensor:
        w = self.p[f"{prefix}.Conv_0.weight"]
        groups = 1
        if w.dim() == 3:                       # depthwise [3, 3, C]
            groups = w.shape[-1]
            w = w.permute(2, 0, 1).unsqueeze(1)
        k = w.shape[-1]
        ph = _same(x.shape[2], k, stride)
        pw = _same(x.shape[3], k, stride)
        x = F.pad(x, (*pw, *ph))
        x = self.prec.stored(F.conv2d(self.prec.operand(x),
                                      self.prec.operand(w), stride=stride,
                                      groups=groups))
        bn = f"{prefix}.BatchNorm_0"
        if self.train_bn:
            mean = x.mean(dim=(0, 2, 3))
            var = x.var(dim=(0, 2, 3), unbiased=False)
        else:
            mean, var = self.buf[f"{bn}.mean"], self.buf[f"{bn}.var"]
        eps = self.cfg["batchnorm_epsilon"]
        x = ((x - mean[:, None, None]) * torch.rsqrt(var + eps)[:, None, None]
             * self.p[f"{bn}.scale"][:, None, None]
             + self.p[f"{bn}.bias"][:, None, None])
        return self.prec.stored(x.clamp(0.0, 6.0) if act else x)

    def features(self, x_nhwc: torch.Tensor) -> torch.Tensor:
        x = self.convbn("backbone.ConvBN_0", x_nhwc.permute(0, 3, 1, 2), 2,
                        True)
        for i, b in enumerate(blocks(self.cfg)):
            pre = f"backbone.InvertedResidual_{i}"
            h, j = x, 0
            if b["t"] != 1:
                h = self.convbn(f"{pre}.ConvBN_0", h, 1, True)
                j = 1
            h = self.convbn(f"{pre}.ConvBN_{j}", h, b["stride"], True)
            h = self.convbn(f"{pre}.ConvBN_{j + 1}", h, 1, False)
            x = x + h if b["stride"] == 1 and b["cin"] == b["cout"] else h
        x = self.convbn("backbone.ConvBN_1", x, 1, True)
        return x.mean(dim=(2, 3))

    def head(self, h: torch.Tensor) -> torch.Tensor:
        w, b = self.p["head.weight"], self.p["head.bias"]
        return self.prec.output(
            self.prec.operand(h) @ self.prec.operand(w).t()) + b


def logits(cfg: dict, p: dict, buf: dict, x_nhwc: torch.Tensor, *,
           train: bool, freeze_base: bool, keep: torch.Tensor | None,
           prec: Precision = FLOAT32) -> torch.Tensor:
    """Logits of NHWC images. ``train``: BatchNorm on the batch's statistics
    (the backbone keeps its running statistics, and takes no gradient, when
    ``freeze_base``) and the head's dropout by the boolean ``keep`` mask."""
    net = _Net(cfg, p, buf, train and not freeze_base, prec)
    if freeze_base:
        with torch.no_grad():
            h = net.features(x_nhwc)
    else:
        h = net.features(x_nhwc)
    if train and cfg["dropout"] > 0.0:
        rate = cfg["dropout"]
        h = torch.where(keep, h / (1.0 - rate), torch.zeros_like(h))
    return net.head(h)


def dropout_keep(seed: int, step: int, shape: tuple, rate: float,
                 device) -> torch.Tensor:
    """The head's dropout mask at ``step``: the workshop step draws it from
    a CPU generator keyed by (seed, rank 0, step, microbatch 0), uniforms
    kept below ``1 - rate``."""
    key = int(seed) & 0xFFFFFFFF
    for part in (0, step, 0):
        key = (key * 1_000_003 + part + 1) % (1 << 62)
    u = torch.rand(shape, generator=torch.Generator().manual_seed(key))
    return (u < 1.0 - rate).to(device)


def train(cfg: dict, p0: dict, buf: dict, batches: list, *, seed: int,
          lr: float, freeze_base: bool, prec: Precision = FLOAT32) -> dict:
    """Adam steps from ``p0`` over ``batches`` ([(uint8 NHWC images,
    labels)]): each step's loss, every trainable leaf's gradient norm at
    the first step, and each one's change after the last."""
    trainable = [n for n in p0 if not (freeze_base and n.startswith("backbone."))]
    p = {n: t.detach().clone() for n, t in p0.items()}
    opt = Adam({n: p[n] for n in trainable}, lr)
    losses, first = [], None
    for step, (images, labels) in enumerate(batches):
        x = images.float() / 127.5 - 1.0
        leaves = {n: p[n].requires_grad_(True) for n in trainable}
        keep = dropout_keep(seed, step, (x.shape[0], p["head.weight"].shape[1]),
                            cfg["dropout"], x.device)
        out = logits(cfg, p, buf, x, train=True, freeze_base=freeze_base,
                     keep=keep, prec=prec)
        loss = F.cross_entropy(out, labels.long())
        grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        for t in leaves.values():
            t.requires_grad_(False)
        if first is None:
            first = {n: float(g.norm()) for n, g in grads.items()}
        opt.step(p, grads)
        losses.append(float(loss.detach()))
    change = {n: float((p[n] - p0[n]).norm()) for n in trainable}
    return {"losses": losses, "grad_norms": first, "change_norms": change}
