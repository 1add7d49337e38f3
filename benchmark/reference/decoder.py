"""Plain float32 StarCoder2-shaped decoder.

Written from the StarCoder2 description (Lozhkov et al. 2024,
arXiv:2402.19173, and the model's ``config.json``): token embedding; per
block a pre-LayerNorm (with bias) before grouped-query attention with
biased projections and rotary positions, a residual add, a pre-LayerNorm
before a biased MLP with the tanh-approximated GELU, a residual add; a final
LayerNorm and the vocabulary head. Attention is causal over every earlier
position: at the cells' lengths the 4,096-token sliding window covers them
all.

Departures, each the configuration's ``assumed``: RoPE with the
configuration's theta rotating (even, odd) pairs of the head dimension (the
published model rotates the two halves: a fixed permutation of the head
dimension, the same function for random weights); LayerNorm's epsilon as
the configuration states; an untied vocabulary head with a bias.

Parameters come in a dict named and laid out as the port's checkpoints lay
them out (flax's names and layouts: ``backbone_block3.attn.query.kernel``
``[hidden, heads, head_dim]``, ``attn.out.kernel`` ``[heads, head_dim,
hidden]``, ``head.kernel`` ``[hidden, vocab]``), so one dict of seeded
weights feeds the program and this reference. Attention runs in blocks of
queries, so that long sequences fit. Nothing of the program is imported.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark.reference.adam import Adam
from benchmark.reference.precision import FLOAT32, Precision

_Q_BLOCK = 512


def dims(cfg: dict) -> dict:
    hidden, heads = cfg["hidden_size"], cfg["num_attention_heads"]
    return dict(hidden=hidden, heads=heads, kv=cfg["num_key_value_heads"],
                hd=hidden // heads, mlp=cfg["intermediate_size"],
                layers=cfg["num_hidden_layers"], vocab=cfg["vocab_size"])


def specs(cfg: dict) -> list[tuple[str, tuple]]:
    """Parameter names and shapes, in the model's order."""
    d = dims(cfg)
    h, hd = d["hidden"], d["hd"]
    out = [("tok_embed.embedding", (d["vocab"], h))]
    for i in range(d["layers"]):
        b = f"backbone_block{i}"
        out += [(f"{b}.LayerNorm_0.scale", (h,)), (f"{b}.LayerNorm_0.bias", (h,)),
                (f"{b}.attn.query.kernel", (h, d["heads"], hd)),
                (f"{b}.attn.query.bias", (d["heads"], hd)),
                (f"{b}.attn.key.kernel", (h, d["kv"], hd)),
                (f"{b}.attn.key.bias", (d["kv"], hd)),
                (f"{b}.attn.value.kernel", (h, d["kv"], hd)),
                (f"{b}.attn.value.bias", (d["kv"], hd)),
                (f"{b}.attn.out.kernel", (d["heads"], hd, h)),
                (f"{b}.attn.out.bias", (h,)),
                (f"{b}.LayerNorm_1.scale", (h,)), (f"{b}.LayerNorm_1.bias", (h,)),
                (f"{b}.fc1.kernel", (h, d["mlp"])), (f"{b}.fc1.bias", (d["mlp"],)),
                (f"{b}.fc2.kernel", (d["mlp"], h)), (f"{b}.fc2.bias", (h,))]
    out += [("LayerNorm_0.scale", (h,)), ("LayerNorm_0.bias", (h,)),
            ("head.kernel", (h, d["vocab"])), ("head.bias", (d["vocab"],))]
    return out


def _layernorm(x, scale, bias, eps):
    mean = x.mean(-1, keepdim=True)
    var = x.var(-1, unbiased=False, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * scale + bias


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """``x [S, H, hd]`` at positions 0..S-1, (even, odd) pairs rotated."""
    s, hd = x.shape[0], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, device=x.device,
                                       dtype=torch.float64) / hd)
    ang = (torch.arange(s, device=x.device, dtype=torch.float64)[:, None]
           * inv).float()[:, None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    xe, xo = x[..., 0::2], x[..., 1::2]
    return torch.stack([xe * cos - xo * sin, xe * sin + xo * cos],
                       dim=-1).reshape(x.shape)


class Decoder:
    def __init__(self, cfg: dict, p: dict, prec: Precision = FLOAT32):
        self.cfg, self.p, self.prec = cfg, p, prec
        self.d = dims(cfg)
        self.eps = cfg["norm_epsilon"]

    def _mm(self, x, w):
        return self.prec.output(self.prec.operand(x) @ self.prec.operand(w))

    def _attention(self, q, k, v):
        """Causal softmax attention of ``q [S, H, hd]`` over ``k, v [S, KV,
        hd]`` (query head ``h`` reads K/V head ``h // (H / KV)``), in blocks
        of queries."""
        s, heads, hd = q.shape
        group = heads // k.shape[1]
        k = k.repeat_interleave(group, dim=1).transpose(0, 1)   # [H, S, hd]
        v = v.repeat_interleave(group, dim=1).transpose(0, 1)
        q = q.transpose(0, 1)
        scale = 1.0 / math.sqrt(hd)
        outs = []
        for a in range(0, s, _Q_BLOCK):
            e = min(a + _Q_BLOCK, s)
            sc = self._mm(q[:, a:e], k[:, :e].transpose(1, 2)) * scale
            qpos = torch.arange(a, e, device=q.device)[:, None]
            kpos = torch.arange(e, device=q.device)[None, :]
            sc = sc.masked_fill(kpos > qpos, float("-inf"))
            outs.append(self._mm(torch.softmax(sc, dim=-1), v[:, :e]))
        return torch.cat(outs, dim=1).transpose(0, 1)           # [S, H, hd]

    def block(self, i: int, x: torch.Tensor) -> torch.Tensor:
        p, d, b = self.p, self.d, f"backbone_block{i}."
        s = x.shape[0]
        h = _layernorm(x, p[b + "LayerNorm_0.scale"], p[b + "LayerNorm_0.bias"],
                       self.eps)

        def proj(name, heads):
            w = p[b + f"attn.{name}.kernel"].reshape(d["hidden"], heads * d["hd"])
            return (self._mm(h, w) + p[b + f"attn.{name}.bias"].reshape(-1)
                    ).reshape(s, heads, d["hd"])

        theta = self.cfg["rope_theta"]
        q = _rope(proj("query", d["heads"]), theta)
        k = _rope(proj("key", d["kv"]), theta)
        v = proj("value", d["kv"])
        o = self._attention(q, k, v).reshape(s, d["heads"] * d["hd"])
        wo = p[b + "attn.out.kernel"].reshape(d["heads"] * d["hd"], d["hidden"])
        x = x + self._mm(o, wo) + p[b + "attn.out.bias"]
        h = _layernorm(x, p[b + "LayerNorm_1.scale"], p[b + "LayerNorm_1.bias"],
                       self.eps)
        h = F.gelu(self._mm(h, p[b + "fc1.kernel"]) + p[b + "fc1.bias"],
                   approximate="tanh")
        return x + self._mm(h, p[b + "fc2.kernel"]) + p[b + "fc2.bias"]

    def hidden(self, tokens: torch.Tensor) -> torch.Tensor:
        """Final-LayerNorm output ``[S, hidden]`` of one sequence."""
        x = self.p["tok_embed.embedding"][tokens.long()]
        for i in range(self.d["layers"]):
            x = self.block(i, x)
        return _layernorm(x, self.p["LayerNorm_0.scale"],
                          self.p["LayerNorm_0.bias"], self.eps)

    def logits(self, h: torch.Tensor) -> torch.Tensor:
        return self._mm(h, self.p["head.kernel"]) + self.p["head.bias"]


@torch.no_grad()
def logits_at(cfg: dict, p: dict, tokens: torch.Tensor, positions,
              prec: Precision = FLOAT32) -> torch.Tensor:
    """Logits ``[len(positions), vocab]`` of one sequence at the given
    positions (each predicts the token after it)."""
    net = Decoder(cfg, p, prec)
    h = net.hidden(tokens)
    return net.logits(h[torch.as_tensor(positions, device=h.device)])


def train(cfg: dict, p0: dict, batches: list, *, lr: float,
          prec: Precision = FLOAT32) -> dict:
    """Adam steps from ``p0`` over ``batches`` ([(inputs [B, S], targets
    [B, S])]), the loss the mean next-token cross-entropy over every token,
    each row's gradient accumulated in turn: each step's loss, every leaf's
    gradient norm at the first step, and each one's change after the
    last."""
    p = {n: t.detach().clone() for n, t in p0.items()}
    opt = Adam(p, lr)
    losses, first = [], None
    for inputs, targets in batches:
        rows = inputs.shape[0]
        grads = {n: torch.zeros_like(t) for n, t in p.items()}
        total = 0.0
        for r in range(rows):
            leaves = {n: t.requires_grad_(True) for n, t in p.items()}
            net = Decoder(cfg, leaves, prec)
            loss = F.cross_entropy(net.logits(net.hidden(inputs[r])),
                                   targets[r].long()) / rows
            for n, g in zip(leaves, torch.autograd.grad(loss, list(leaves.values()))):
                grads[n] += g
            total += float(loss.detach())
            for t in leaves.values():
                t.requires_grad_(False)
            del loss, net
        if first is None:
            first = {n: float(g.norm()) for n, g in grads.items()}
        opt.step(p, grads)
        del grads
        losses.append(total)
    change = {n: float((p[n] - p0[n]).norm()) for n in p}
    return {"losses": losses, "grad_norms": first, "change_norms": change}
