"""Flash attention — the port of ``ddw_tpu.ops.flash_attention``.

Implementations of the same masked softmax attention, all in the JAX
package's ``[B, H, S, D]`` layout at the public entries:

- :func:`flash_attention_cuda` launches the hand-written kernel K3 of
  ``csrc/flash_attention.cu`` on ``[B*H, S, D]`` tensors. It replaces the
  Pallas kernel ``ddw_tpu/ops/flash_attention.py`` ``_flash_kernel`` /
  ``_flash_forward``. It is bound by operations (a causal call at the LM's
  ``[512, 2048, 64]`` is 2.75e11 FLOP against 537 MB), and this first version
  computes in f32 on the CUDA cores, far from the tensor-core bound; the
  design notes are in the source.
- :func:`flash_attention_plain`, its plain PyTorch version: the TPU kernel's
  online softmax step for step, one K block at a time, vectorised over every
  (batch*head, query row) at once. The CPU path and the reference K3 is held
  against on the card.
- :func:`xla_attention_lse`, the ``xla`` tier of ``flash_mha``: one masked
  score matrix in plain torch ops (``_xla_attention_lse``), which the JAX
  package computes outside any Pallas kernel.

:func:`flash_mha` / :func:`flash_mha_lse` dispatch on the f32 score-matrix
bytes ``B*H*Sq*Sk*4`` exactly as ``ddw_tpu`` does (same thresholds, same
environment names, read at import): ``xla`` up to 256 MiB, ``xla_ckpt`` (the
``xla`` tier under ``torch.utils.checkpoint`` when grad is enabled) up to
2 GiB, ``pallas`` (K3 through :class:`FlashAttentionFn`) above. The
thresholds were set on a TPU; they are kept so both packages pick the same
tier for the same shapes, and re-setting them for the H100 needs
measurements. The ``pallas`` tier has no backward yet: K4/K5 come with LM
training (``ROADMAP.md``).
"""

from __future__ import annotations

import ctypes
import functools
import math
import os

import torch
from torch.utils.checkpoint import checkpoint

_NEG_INF = -1e30
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL_HEAD_DIMS = (32, 64, 128)
_KERNEL_MAX_BLOCK_K = 128

# Score-matrix bytes (B*H*Sq*Sk*4, f32) thresholds; env-overridable, as in
# ddw_tpu (values set on a TPU, see the module docstring).
_XLA_PLAIN_MAX = int(os.environ.get("DDW_ATTN_XLA_PLAIN_MAX", 256 * 1024**2))
_XLA_CKPT_MAX = int(os.environ.get("DDW_ATTN_XLA_CKPT_MAX", 2 * 1024**3))


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """f32 accumulation, as the kernels do; f64 stays f64."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def _default_scale(sm_scale: float | None, head_dim: int) -> float:
    return 1.0 / float(head_dim) ** 0.5 if sm_scale is None else sm_scale


def mha_reference(q, k, v, causal: bool = False, q_offset: int = 0,
                  k_offset: int = 0,
                  sm_scale: float | None = None) -> torch.Tensor:
    """Plain attention in f32 — the numerics oracle. q [B,H,Sq,D], k/v
    [B,H,Sk,D]."""
    d = q.shape[-1]
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    acc = _acc_dtype(q.dtype)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.to(acc), k.to(acc)) * scale
    if causal:
        qpos = q_offset + torch.arange(q.shape[2], device=q.device)[:, None]
        kpos = k_offset + torch.arange(k.shape[2], device=q.device)[None, :]
        logits = torch.where(kpos <= qpos, logits,
                             torch.full_like(logits, _NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v.to(acc)).to(q.dtype)


def flash_attention_plain(q, k, v, causal: bool = False, q_offset: int = 0,
                          k_offset: int = 0, sm_scale: float | None = None,
                          block_q: int = 128, block_k: int = 128,
                          k_valid: int | None = None):
    """Plain PyTorch version of K3 on ``[B*H, S, D]``: returns ``(out [BH,
    Sq, D]`` in q's dtype, ``lse [BH, Sq]`` f32).

    ``_flash_kernel``'s arithmetic, one K block at a time: scores are
    input-dtype products with f32 accumulation (an f32 product of upcast
    operands is exact) times ``sm_scale``; masked entries (causal by global
    positions ``q_offset``/``k_offset``, keys at or past ``k_valid``) are
    ``-1e30``; the running max starts at ``-1e30`` and ``p = exp(s - m_new)``
    is re-zeroed where ``s`` was masked (``_guarded_exp``); ``p`` is cast to
    the input dtype for the P.V product. K blocks wholly in the future of a
    query block, or at or past ``k_valid``, are skipped (their update would
    be an exact no-op)."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    sm_scale = _default_scale(sm_scale, d)
    block_q = min(block_q, sq)
    block_k = min(block_k, sk)
    if sq % block_q or sk % block_k:
        raise ValueError(f"seq lengths ({sq},{sk}) must divide blocks "
                         f"({block_q},{block_k})")
    acc_dtype = _acc_dtype(q.dtype)
    qf, kf, vf = q.to(acc_dtype), k.to(acc_dtype), v.to(acc_dtype)
    dev = q.device
    m = torch.full((bh, sq), _NEG_INF, dtype=acc_dtype, device=dev)
    l = torch.zeros((bh, sq), dtype=acc_dtype, device=dev)
    acc = torch.zeros((bh, sq, d), dtype=acc_dtype, device=dev)
    masked = causal or k_valid is not None
    qpos = q_offset + torch.arange(sq, device=dev)
    for kb in range(sk // block_k):
        k_first = k_offset + kb * block_k
        if k_valid is not None and k_first >= k_valid:
            continue
        r0 = 0
        if causal:
            # first query block whose last row reaches this K block
            qi0 = max(0, -(-(k_first - q_offset - block_q + 1) // block_q))
            if qi0 * block_q >= sq:
                continue
            r0 = qi0 * block_q
        ks = slice(kb * block_k, (kb + 1) * block_k)
        s = torch.matmul(qf[:, r0:], kf[:, ks].transpose(1, 2)) * sm_scale
        if masked:
            kpos = k_first + torch.arange(block_k, device=dev)
            keep = torch.ones((sq - r0, block_k), dtype=torch.bool,
                              device=dev)
            if causal:
                keep = kpos[None, :] <= qpos[r0:, None]
            if k_valid is not None:
                keep = keep & (kpos < k_valid)[None, :]
            s = torch.where(keep, s, torch.full_like(s, _NEG_INF))
        m_prev = m[:, r0:]
        m_new = torch.maximum(m_prev, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        if masked:
            p = torch.where(s > _NEG_INF / 2, p, torch.zeros_like(p))
        alpha = torch.exp(m_prev - m_new)
        l[:, r0:] = alpha * l[:, r0:] + p.sum(-1)
        acc[:, r0:] = acc[:, r0:] * alpha[..., None] + torch.matmul(
            p.to(q.dtype).to(acc_dtype), vf[:, ks])
        m[:, r0:] = m_new
    l = l.clamp_min(1e-30)
    out = (acc / l[..., None]).to(q.dtype)
    lse = (m + torch.log(l)).to(torch.float32)
    return out, lse


@functools.cache
def _kernel_lib() -> ctypes.CDLL:
    from ddw_tpu_torch.ops import _build

    lib = _build.load("flash_attention.cu")
    lib.ddw_flash_fwd.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_float]
        + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    lib.ddw_flash_fwd.restype = ctypes.c_int
    return lib


def flash_attention_cuda(q, k, v, causal: bool = False, q_offset: int = 0,
                         k_offset: int = 0, sm_scale: float | None = None,
                         block_k: int = 128, k_valid: int | None = None):
    """Launch K3 on the current stream, without synchronising: ``(out [BH,
    Sq, D]`` in q's dtype, ``lse [BH, Sq]`` f32) from contiguous, 16-byte
    aligned ``q [BH, Sq, D]``, ``k``/``v [BH, Sk, D]`` CUDA tensors of one
    dtype, float32 or bfloat16, with D in (32, 64, 128) and ``block_k <=
    128`` dividing Sk. Raises on anything else; never falls back."""
    tensors = (q, k, v)
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError(f"the flash-attention kernel needs q, k, v on one "
                         f"CUDA device, got {[str(t.device) for t in tensors]}")
    if q.dtype not in _KERNEL_DTYPES or any(t.dtype != q.dtype
                                            for t in tensors):
        raise ValueError(f"the flash-attention kernel takes float32 or "
                         f"bfloat16 q, k, v of one dtype, got "
                         f"{[t.dtype for t in tensors]}")
    if q.dim() != 3 or k.shape != v.shape or k.dim() != 3 or \
            k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2]:
        raise ValueError(f"need q [BH, Sq, D] and k, v [BH, Sk, D], got "
                         f"{[tuple(t.shape) for t in tensors]}")
    bh, sq, d = q.shape
    sk = k.shape[1]
    if d not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"the flash-attention kernel supports head dims "
                         f"{_KERNEL_HEAD_DIMS}, got {d}")
    if not 1 <= block_k <= _KERNEL_MAX_BLOCK_K or sk % block_k:
        raise ValueError(f"block_k {block_k} must be in [1, "
                         f"{_KERNEL_MAX_BLOCK_K}] and divide Sk={sk}")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in tensors):
        raise ValueError("the flash-attention kernel needs contiguous, "
                         "16-byte aligned q, k, v")
    if min(bh, sq, sk) < 1 or max(q.numel(), k.numel()) >= 1 << 31:
        raise ValueError(f"need non-empty q, k, v of fewer than 2**31 "
                         f"elements, got {[tuple(t.shape) for t in tensors]}")
    out = torch.empty_like(q)
    lse = torch.empty((bh, sq), dtype=torch.float32, device=q.device)
    lib = _kernel_lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.ddw_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), bh, sq, sk, d, _KERNEL_DTYPES[q.dtype],
            int(causal), q_offset, k_offset, _default_scale(sm_scale, d),
            block_k, -1 if k_valid is None else k_valid, stream)
    if err != 0:
        raise RuntimeError(f"flash-attention kernel launch failed: CUDA "
                           f"error {err}")
    flash_attention_cuda.launches += 1
    return out, lse


flash_attention_cuda.launches = 0


class FlashAttentionFn(torch.autograd.Function):
    """The ``pallas`` tier on ``[B*H, S, D]``: forward K3 on a CUDA tensor,
    the plain version on a CPU tensor (or with ``plain=True``). Returns
    ``(out, lse)``. The backward kernels (K4 dQ, K5 dK/dV) are not ported
    yet, so the backward raises on every device: the CPU never trains on a
    path the card cannot."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset, k_offset, sm_scale, block_q,
                block_k, k_valid, plain):
        if plain or q.device.type == "cpu":
            return flash_attention_plain(q, k, v, causal, q_offset, k_offset,
                                         sm_scale, block_q, block_k, k_valid)
        return flash_attention_cuda(q, k, v, causal, q_offset, k_offset,
                                    sm_scale, min(block_k, k.shape[1]),
                                    k_valid)

    @staticmethod
    def backward(ctx, g_out, g_lse):
        raise NotImplementedError(
            "the flash-attention backward (K4 dQ, K5 dK/dV) is not yet ported "
            "to ddw_tpu_torch; it comes with LM training (see ROADMAP.md). "
            "Use impl='xla' or 'xla_ckpt' to differentiate attention")


def _flash_forward(q, k, v, causal, q_offset, k_offset, sm_scale, block_q,
                   block_k, interpret, k_valid):
    """``[B,H,S,D]`` -> ``(out [B,H,Sq,D], lse [B,H,Sq])`` through
    :class:`FlashAttentionFn`; ``interpret=True`` (or a CPU tensor) runs the
    plain version."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if sq % min(block_q, sq) or sk % min(block_k, sk):
        raise ValueError(f"seq lengths ({sq},{sk}) must divide blocks "
                         f"({block_q},{block_k})")
    out, lse = FlashAttentionFn.apply(
        q.reshape(b * h, sq, d).contiguous(),
        k.reshape(b * h, sk, d).contiguous(),
        v.reshape(b * h, sk, d).contiguous(), causal, q_offset, k_offset,
        _default_scale(sm_scale, d), block_q, block_k, k_valid,
        bool(interpret))
    return out.reshape(b, h, sq, d), lse.reshape(b, h, sq)


def flash_attention(q, k, v, causal: bool = False, q_offset: int = 0,
                    k_offset: int = 0, sm_scale: float | None = None,
                    block_q: int = 128, block_k: int = 128,
                    interpret: bool | None = None,
                    k_valid: int | None = None) -> torch.Tensor:
    """Flash attention: softmax(q k^T * sm_scale) v without the score matrix.
    q [B,H,Sq,D], k/v [B,H,Sk,D] -> [B,H,Sq,D]; offsets and ``k_valid`` as in
    ``ddw_tpu``. K3 on a CUDA tensor, the plain version on a CPU tensor or
    with ``interpret=True``."""
    return _flash_forward(q, k, v, causal, q_offset, k_offset, sm_scale,
                          block_q, block_k, interpret, k_valid)[0]


def flash_attention_lse(q, k, v, causal: bool = False, q_offset: int = 0,
                        k_offset: int = 0, sm_scale: float | None = None,
                        block_q: int = 128, block_k: int = 128,
                        interpret: bool | None = None,
                        k_valid: int | None = None):
    """Flash attention that also returns the per-row logsumexp:
    ``(out [B,H,Sq,D], lse [B,H,Sq] f32)``."""
    return _flash_forward(q, k, v, causal, q_offset, k_offset, sm_scale,
                          block_q, block_k, interpret, k_valid)


def _pick_block(s: int, block: int, dtype: torch.dtype) -> int:
    """``ddw_tpu``'s tile-aligned block for a sequence of length ``s``: a
    multiple of 16 (bf16/f16) or 8, at most ``block``; ``s`` is padded up to
    a multiple of it."""
    tile = 16 if dtype in (torch.bfloat16, torch.float16) else 8
    aligned = -(-max(s, 1) // tile) * tile
    return max(tile, min(block, aligned) // tile * tile)


def _pad_seq(x: torch.Tensor, mult: int) -> torch.Tensor:
    """Zero-pad the sequence axis (dim 2 of [B,H,S,D]) up to a multiple."""
    pad = (-x.shape[2]) % mult
    if pad == 0:
        return x
    return torch.nn.functional.pad(x, (0, 0, 0, pad))


def xla_attention_lse(q, k, v, causal: bool, q_offset: int, k_offset: int,
                      sm_scale: float, k_valid: int | None):
    """The ``xla`` tier (``_xla_attention_lse``): the whole masked score
    matrix at once. Input-dtype products with f32 accumulation, ``-inf``
    masking with the row max clamped at ``-1e30`` (fully masked rows stay
    finite), ``p`` cast to the input dtype for the P.V product. Returns
    ``(out [B,H,Sq,D], lse [B,H,Sq])``."""
    acc = _acc_dtype(q.dtype)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(acc), k.to(acc)) * sm_scale
    sq, sk = q.shape[2], k.shape[2]
    kpos = k_offset + torch.arange(sk, device=q.device)
    mask = None
    if causal:
        qpos = q_offset + torch.arange(sq, device=q.device)
        mask = kpos[None, :] <= qpos[:, None]
    if k_valid is not None:
        kv_mask = (kpos < k_valid)[None, :]
        mask = kv_mask if mask is None else (mask & kv_mask)
    if mask is not None:
        s = s.masked_fill(~mask, float("-inf"))
    m = s.amax(-1, keepdim=True).clamp_min(_NEG_INF)
    p = torch.exp(s - m)
    del s
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    out = (torch.einsum("bhqk,bhkd->bhqd", p.to(q.dtype).to(acc), v.to(acc))
           / l).to(q.dtype)
    lse = (m + torch.log(l))[..., 0].to(torch.float32)
    return out, lse


def _attn_impl(q, k, impl: str) -> str:
    if impl != "auto":
        return impl
    b, h, sq, _ = q.shape
    score_bytes = b * h * sq * k.shape[2] * 4
    if score_bytes <= _XLA_PLAIN_MAX:
        return "xla"
    if score_bytes <= _XLA_CKPT_MAX:
        return "xla_ckpt"
    return "pallas"


def flash_mha(q, k, v, causal: bool = False, sm_scale: float | None = None,
              block_q: int = 128, block_k: int = 128,
              interpret: bool | None = None,
              impl: str = "auto") -> torch.Tensor:
    """Attention for arbitrary sequence lengths (the model-facing entry).
    ``impl``: ``auto`` (size-based dispatch, see the module docstring),
    ``xla``, ``xla_ckpt`` or ``pallas`` (K3: pads Sq/Sk to tile-aligned block
    multiples, masks padded keys with ``k_valid``, slices padded query rows
    off)."""
    return flash_mha_lse(q, k, v, causal, sm_scale, block_q, block_k,
                         interpret, impl)[0]


def flash_mha_lse(q, k, v, causal: bool = False,
                  sm_scale: float | None = None, block_q: int = 128,
                  block_k: int = 128, interpret: bool | None = None,
                  impl: str = "auto"):
    """Padded-length attention with logsumexp — ``(out, lse [B,H,Sq])``, the
    dispatch and padding contract of :func:`flash_mha`."""
    chosen = _attn_impl(q, k, impl)
    if chosen not in ("xla", "xla_ckpt", "pallas"):
        raise ValueError(f"unknown attention impl {impl!r}; use 'auto', "
                         f"'xla', 'xla_ckpt' or 'pallas'")
    if chosen in ("xla", "xla_ckpt"):
        fn = functools.partial(xla_attention_lse, causal=causal, q_offset=0,
                               k_offset=0,
                               sm_scale=_default_scale(sm_scale, q.shape[-1]),
                               k_valid=None)
        if chosen == "xla_ckpt" and torch.is_grad_enabled():
            return checkpoint(fn, q, k, v, use_reentrant=False)
        return fn(q, k, v)
    sq, sk = q.shape[2], k.shape[2]
    bq = _pick_block(sq, block_q, q.dtype)
    bk = _pick_block(sk, block_k, k.dtype)
    qp = _pad_seq(q, bq)
    kp = _pad_seq(k, bk)
    vp = _pad_seq(v, bk)
    k_valid = sk if kp.shape[2] != sk else None
    out, lse = flash_attention_lse(qp, kp, vp, causal, 0, 0, sm_scale, bq, bk,
                                   interpret, k_valid)
    if qp.shape[2] != sq:
        out, lse = out[:, :, :sq], lse[:, :, :sq]
    return out, lse
