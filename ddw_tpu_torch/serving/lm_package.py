"""Packaged LM artifacts — the port of ``ddw_tpu.serving.lm_package``.

The directory format is ``ddw_tpu``'s, unchanged, so a package written by
either package loads in the other (f32 and int8):

    package.json     kind "lm", format_version, lm_cfg (+ quantization)
    params.msgpack   ``{"params": ...}`` flax parameter tree, full precision
                     or int8 weight-only (``serving/quantize.py``)

:class:`LMPackagedModel` restores it onto a device and exposes
``score(tokens [B, S+1]) -> nll [B]`` (mean next-token negative
log-likelihood; perplexity is ``exp(nll)``) and ``generate`` (the KV-cached
decode path), both padding request widths to the shared buckets
(``serve/bucketing.py``), ``generate_speculative`` (draft-verified greedy
decoding against a second package) and ``engine_handle`` (what the online
``ServingEngine`` serves).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from ddw_tpu_torch.models.convert import load_flax_variables
from ddw_tpu_torch.models.lm import build_lm, generate
from ddw_tpu_torch.serve.bucketing import bucket_len, pad_to_bucket
from ddw_tpu_torch.serving.package import read_package_dir, write_package_dir
from ddw_tpu_torch.utils.config import LMCfg
from ddw_tpu_torch.utils.device import resolve_device

_LM_FORMAT_VERSION = 1
_LM_FORMAT_VERSION_QUANT = 2
_SUPPORTED = (_LM_FORMAT_VERSION, _LM_FORMAT_VERSION_QUANT)


def sequence_nll(model, tokens: torch.Tensor,
                 lengths: torch.Tensor | None = None) -> torch.Tensor:
    """Per-sequence mean next-token NLL of ``tokens [B, S+1]`` — the single
    scoring definition :class:`LMPackagedModel` and
    ``serving.batch.LMBatchScorer`` share. Callers bounds-check token ids
    first (:func:`check_token_ids`). ``lengths [B]`` gives each row's true
    target count when ``tokens`` is right-padded: padded positions drop out
    of the mean; zero-length rows return 0."""
    inp, tgt = tokens[:, :-1], tokens[:, 1:]
    logp = F.log_softmax(model(inp).to(torch.float32), dim=-1)
    tok_ll = torch.gather(logp, -1, tgt[..., None].long())[..., 0]
    if lengths is None:
        return -tok_ll.mean(-1)
    mask = torch.arange(tgt.shape[1], device=tokens.device)[None, :] \
        < lengths[:, None]
    return -(tok_ll * mask).sum(-1) / lengths.clamp_min(1)


def check_token_ids(tokens, vocab_size: int) -> None:
    """Refuse out-of-vocab ids before any gather sees them."""
    if tokens.min() < 0 or tokens.max() >= vocab_size:
        raise ValueError(f"token ids outside [0, {vocab_size}): "
                         f"min={tokens.min()}, max={tokens.max()}")


def save_lm_package(out_dir: str, lm_cfg: LMCfg, params,
                    extra_meta: dict | None = None,
                    quantize: str | None = None) -> str:
    """Write a packaged-LM directory from a flax-layout parameter tree of
    numpy arrays (``to_flax_variables(model)["params"]`` for a port
    module). ``quantize="int8"`` stores per-output-channel int8 kernels."""
    reserved = {"kind", "format_version", "lm_cfg", "quantization"}
    clash = reserved & set(extra_meta or {})
    if clash:
        raise ValueError(f"extra_meta must not override reserved keys "
                         f"{sorted(clash)}")
    meta = {
        "kind": "lm",
        "format_version": _LM_FORMAT_VERSION,
        "lm_cfg": dataclasses.asdict(lm_cfg),
        **(extra_meta or {}),
    }
    return write_package_dir(out_dir, meta, {"params": params}, quantize,
                             _LM_FORMAT_VERSION_QUANT)


class LMPackagedModel:
    """Self-contained LM scorer and generator on one device.

    ``device=None`` means the CUDA card (raises without one); tests pass
    ``device="cpu"``. Request widths are padded to the serving buckets, as
    in ``ddw_tpu``, so both packages run the same shapes."""

    def __init__(self, model_dir: str, device=None):
        self.device = resolve_device(device)
        self.meta, restored, self.content_digest = read_package_dir(
            model_dir, "lm", _SUPPORTED,
            "image packages load via ddw_tpu_torch.serving.package."
            "PackagedModel")
        self.lm_cfg = LMCfg(**{k: (tuple(v) if isinstance(v, list) else v)
                               for k, v in self.meta["lm_cfg"].items()})
        self.model = build_lm(self.lm_cfg)
        load_flax_variables(self.model, {"params": restored["params"]})
        self.model.to(self.device).eval()

    def nll(self, tokens: np.ndarray, lengths=None) -> np.ndarray:
        """:func:`sequence_nll` of int ``tokens [B, S+1]`` on the device."""
        with torch.inference_mode():
            t = torch.from_numpy(np.ascontiguousarray(tokens, np.int64))
            n = None if lengths is None else torch.as_tensor(
                lengths, device=self.device)
            return sequence_nll(self.model, t.to(self.device),
                                n).cpu().numpy()

    def score(self, tokens) -> np.ndarray:
        """Mean next-token NLL per sequence; perplexity = exp(score)."""
        tokens = np.asarray(tokens, np.int32)
        if tokens.ndim != 2 or tokens.shape[1] < 2:
            raise ValueError(f"tokens must be [B, S+1], got {tokens.shape}")
        if tokens.shape[1] - 1 > self.lm_cfg.max_len:
            raise ValueError(f"sequence {tokens.shape[1] - 1} exceeds "
                             f"max_len {self.lm_cfg.max_len}")
        check_token_ids(tokens, self.lm_cfg.vocab_size)
        b, width = tokens.shape
        padded = pad_to_bucket(
            tokens, bucket_len(width, self.lm_cfg.max_len + 1))
        return self.nll(padded, np.full((b,), width - 1, np.int32))

    def generate(self, prompt, num_steps: int,
                 generator: torch.Generator | None = None,
                 temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 0.0) -> np.ndarray:
        """``[B, num_steps]`` int32 continuation of ``prompt [B, P]``: the
        prompt right-padded to its bucket, prefilled once, the cache indices
        snapped back to P (:func:`ddw_tpu_torch.models.lm.generate`)."""
        prompt = np.asarray(prompt, np.int32)
        if prompt.ndim != 2 or prompt.shape[1] < 1:
            raise ValueError(f"prompt must be [B, P], got {prompt.shape}")
        b, plen = prompt.shape
        if plen + num_steps > self.lm_cfg.max_len:
            raise ValueError(f"prompt {plen} + steps {num_steps} exceeds "
                             f"max_len {self.lm_cfg.max_len}")
        check_token_ids(prompt, self.lm_cfg.vocab_size)
        padded = pad_to_bucket(prompt, bucket_len(plen, self.lm_cfg.max_len))
        out = generate(self.model, torch.from_numpy(padded), num_steps,
                       generator=generator, temperature=temperature,
                       top_k=top_k, top_p=top_p, prompt_len=plen)
        return out.cpu().numpy()

    def generate_speculative(self, draft: "LMPackagedModel", prompt,
                             num_steps: int, k: int = 4):
        """Draft-verified greedy decoding against another packaged model
        (:func:`ddw_tpu_torch.models.spec_decode.generate_speculative`):
        ``(tokens [1, num_steps] int32, stats)``, the tokens equal to
        greedy :meth:`generate`'s."""
        from ddw_tpu_torch.models.spec_decode import generate_speculative

        prompt = np.asarray(prompt, np.int32)
        check_token_ids(prompt, self.lm_cfg.vocab_size)
        out, stats = generate_speculative(self.model, draft.model, prompt,
                                          num_steps, k=k)
        return out.cpu().numpy(), stats

    def engine_handle(self) -> "LMEngineHandle":
        """What :class:`ddw_tpu_torch.serve.engine.ServingEngine` needs
        from this package."""
        return LMEngineHandle(self.model, self.lm_cfg, self.content_digest,
                              self.device)


@dataclasses.dataclass
class LMEngineHandle:
    """What :class:`ddw_tpu_torch.serve.engine.ServingEngine` needs from an
    LM package: the module (on its device, weights loaded) and the config
    that bounds admission validation. A handle, not the package object, so
    any weight source can serve through the engine."""

    model: object               # TransformerLM; the pools build its caches
    cfg: LMCfg
    content_digest: str = ""
    device: torch.device | None = None


def load_lm_package(model_dir: str, device=None) -> LMPackagedModel:
    return LMPackagedModel(model_dir, device=device)
