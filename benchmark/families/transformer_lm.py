"""The port's TransformerLM as the benchmark drives it, for configurations
whose ``family`` is ``transformer_lm``: the model built from the
configuration, the leaves and the rule of their seeded weights, the plain
decoder's training steps and logits, the model FLOPs of a step, a token and
a prompt, and the least times of the attention kernels in a step."""

from __future__ import annotations

import math

import torch

from benchmark.lib import flops
from benchmark.reference import decoder as ref

logits_at = ref.logits_at
token_flops = flops.lm_token_flops
prefill_flops = flops.lm_prefill_flops


def build(cfg: dict, mix: dict, device) -> torch.nn.Module:
    """The port's TransformerLM at the configuration's widths, on
    ``device``."""
    from ddw_tpu_torch.models.lm import TransformerLM

    port = cfg["port"]
    with torch.device(device):
        return TransformerLM(
            vocab_size=cfg["vocab_size"],
            max_len=cfg["max_position_embeddings"],
            hidden=cfg["hidden_size"], depth=cfg["num_hidden_layers"],
            num_heads=cfg["num_attention_heads"],
            mlp_dim=cfg["intermediate_size"], dropout=0.0,
            dtype=getattr(torch, cfg["dtype"]),
            num_kv_heads=cfg["num_key_value_heads"],
            pos_encoding=port["pos_encoding"], remat=port["remat"])


def lm_cfg(cfg: dict):
    """The port's ``LMCfg`` of the configuration, for its serving engine."""
    from ddw_tpu_torch.utils.config import LMCfg

    return LMCfg(vocab_size=cfg["vocab_size"],
                 max_len=cfg["max_position_embeddings"],
                 hidden=cfg["hidden_size"], depth=cfg["num_hidden_layers"],
                 num_heads=cfg["num_attention_heads"],
                 mlp_dim=cfg["intermediate_size"],
                 num_kv_heads=cfg["num_key_value_heads"],
                 pos_encoding=cfg["port"]["pos_encoding"], dtype=cfg["dtype"])


def specs(cfg: dict) -> tuple[list, list]:
    """(parameters, no buffers): names and shapes."""
    return ref.specs(cfg), []


def init(name: str, shape: tuple, z: torch.Tensor) -> torch.Tensor:
    """Embedding normal(1); projection kernels normal with variance
    1/fan_in (the output projection contracts heads and head dim); biases
    normal(0.02); LayerNorm scale about 1 and shift about 0."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "embedding":
        return z
    if leaf == "kernel":
        fan_in = (math.prod(shape[:-1]) if name.endswith("attn.out.kernel")
                  else shape[0])
        return z * fan_in ** -0.5
    if "LayerNorm" in name:
        return (1.0 + 0.05 * z) if leaf == "scale" else 0.05 * z
    if leaf == "bias":
        return 0.02 * z
    raise KeyError(f"no init rule for {name}")


def reference(cfg: dict, mix: dict, p0: dict, batches: list, seed: int,
              prec) -> dict:
    """The plain decoder's steps over ``batches`` from ``p0``."""
    return ref.train(cfg, p0, batches, lr=mix["learning_rate"], prec=prec)


def step_flops(cfg: dict, mix: dict) -> float:
    return flops.lm_train_step_flops(cfg, mix["batch"], mix["seq"])


def op_bounds(cfg: dict, mix: dict) -> dict:
    """Least seconds of K3 and of K4 + K5 over every layer of one step."""
    d = flops.lm_dims(cfg)
    bh, s = mix["batch"] * d["heads"], mix["seq"]
    return {"k3_attn_fwd": d["layers"] * flops.k3_bound_s(bh, s, d["hd"], 2),
            "k45_attn_bwd": d["layers"] * flops.k45_bound_s(bh, s, d["hd"], 2)}


def leaf_groups(cfg: dict, mix: dict) -> dict:
    return {}
