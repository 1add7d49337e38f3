"""Flash attention — the port of ``ddw_tpu.ops.flash_attention``.

Implementations of the same masked softmax attention, all in the JAX
package's ``[B, H, S, D]`` layout at the public entries:

- :func:`flash_attention_cuda` launches the hand-written kernel K3 on
  ``[B*H, S, D]`` tensors. It replaces the Pallas kernel
  ``ddw_tpu/ops/flash_attention.py`` ``_flash_kernel`` / ``_flash_forward``.
  It is bound by operations (a causal call at the LM's ``[512, 2048, 64]`` is
  2.75e11 FLOP against 537 MB). Like the TPU kernel it takes any head dim
  and float32, bfloat16 or float16. Three variants, chosen by shape in
  :func:`_fwd_variant`: ``sm90`` (``csrc/flash_fwd_sm90.cu``: TMA loads fed
  by a producer warp, ``wgmma`` on two consumer warpgroups) for bf16 and f16
  with ``block_k`` = 128 at every head dim up to 256 that is a multiple of 8,
  the main path's attention (the LM's 64, the lm_wide path's 256, ViT's 48);
  ``mma`` (``mma.sync`` in ``csrc/flash_attention.cu``) for the other bf16
  and f16 shapes up to head dim 256 with ``block_k`` a multiple of 16;
  ``cuda_cores`` (the same file) for f32, for 16-bit blocks of other sizes
  and for head dims above 256. The head dim is rounded up to a compiled
  width inside the kernels (:func:`compiled_width`), never padded here: the
  ``sm90`` tensor maps zero-fill the columns past it, the others zero-fill
  them in shared memory. The design notes are in the sources.
- :func:`flash_attention_dq_cuda` (K4) and :func:`flash_attention_dkv_cuda`
  (K5) launch the backward kernels, which replace ``_dq_kernel`` and
  ``_dkv_kernel`` (``_partitioned_bwd``): dQ, and dK/dV, from the saved
  logsumexp, with ``p`` rebuilt tile by tile. Three variants, chosen by
  shape in :func:`_bwd_variant`: ``sm90`` (``csrc/flash_bwd_sm90.cu``: TMA
  loads fed by a producer warp, ``wgmma`` on two consumer warpgroups) for
  bf16 and f16 at every head dim up to 256 that is a multiple of 8, the
  main path's (the LM's 64, the lm_wide path's 256, ViT's 48); ``mma``
  (``mma.sync`` in ``csrc/flash_attention_bwd.cu``) for the other bf16 and
  f16 head dims up to 256; ``cuda_cores`` (the same file) for f32 and for
  head dims above 256. None uses float atomics, so two launches give the
  same bits. The head dim is rounded up to the forward's compiled widths.
- :func:`flash_attention_plain`, :func:`flash_attention_dq_plain` and
  :func:`flash_attention_dkv_plain`, their plain PyTorch versions: the TPU
  kernels' arithmetic block by block, vectorised over every (batch*head,
  row) at once. The CPU path, and the reference the kernels are held against
  on the card.
- :class:`FlashAttentionFn`, the autograd Function of the ``pallas`` tier:
  K3 forward, K4 and K5 backward on CUDA tensors, the plain versions on CPU
  tensors. Differentiable in both outputs (``out`` and ``lse``).
- :func:`xla_attention_lse`, the ``xla`` tier of ``flash_mha``: one masked
  score matrix in plain torch ops (``_xla_attention_lse``), which the JAX
  package computes outside any Pallas kernel.

:func:`flash_mha` / :func:`flash_mha_lse` dispatch on the f32 score-matrix
bytes ``B*H*Sq*Sk*4`` exactly as ``ddw_tpu`` does (same thresholds, same
environment names, read at import): ``xla`` up to 256 MiB, ``xla_ckpt`` (the
``xla`` tier under ``torch.utils.checkpoint`` when grad is enabled) up to
2 GiB, ``pallas`` (:class:`FlashAttentionFn`) above. The thresholds were set
on a TPU; they are kept so both packages pick the same tier for the same
shapes, and re-setting them for the H100 needs measurements.
"""

from __future__ import annotations

import ctypes
import functools
import math
import os

import torch
from torch.utils.checkpoint import checkpoint

_NEG_INF = -1e30
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_HALF_DTYPES = (torch.bfloat16, torch.float16)
# The kernels' compiled head dims (csrc/flash_common.cuh mma_width and
# cc_width): the mma kernels round D up to the next of _MMA_WIDTHS (D up to
# _MMA_MAX_HEAD_DIM), the CUDA-core ones to 16 or 32, or to slabs of 64
# above 32.
_MMA_WIDTHS = (16, 32, 48, 64, 96, 128, 256)
_MMA_MAX_HEAD_DIM = _MMA_WIDTHS[-1]
_CC_WIDTHS = (16, 32, 64)
_KERNEL_MAX_BLOCK_K = 128
# The sm90 kernels of K3, K4 and K5: compiled for head dims 64, 128 and 256
# (a multiple of _SM90_HEAD_DIM_STEP up to 256 runs at the next;
# csrc/flash_fwd_sm90.cu and csrc/flash_bwd_sm90.cu sm90_width), in bf16 and
# f16; K3's at block_k 128.
_SM90_WIDTHS = (64, 128, 256)
_SM90_HEAD_DIM_STEP = 8
_SM90_BLOCK_K = 128
_FWD_VARIANTS = ("sm90", "mma", "cuda_cores")
_BWD_VARIANTS = _FWD_VARIANTS

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


def _masked_scores(qf, kf, q_first: int, k_first: int, causal: bool,
                   sm_scale: float, k_valid: int | None) -> torch.Tensor:
    """``_masked_scores``: ``q . k^T * sm_scale`` over upcast rows (an
    f32 product of upcast bf16 operands is exact, the sum is f32) with the
    causal and key-padding masks at global positions set to ``-1e30``.
    Shared by the forward and both backward versions, as in ``ddw_tpu``."""
    s = torch.matmul(qf, kf.transpose(1, 2)) * sm_scale
    if causal or k_valid is not None:
        dev = qf.device
        kpos = k_first + torch.arange(kf.shape[1], device=dev)
        keep = torch.ones((qf.shape[1], kf.shape[1]), dtype=torch.bool,
                          device=dev)
        if causal:
            qpos = q_first + torch.arange(qf.shape[1], device=dev)
            keep = kpos[None, :] <= qpos[:, None]
        if k_valid is not None:
            keep = keep & (kpos < k_valid)[None, :]
        s = torch.where(keep, s, torch.full_like(s, _NEG_INF))
    return s


def _guarded_exp(s: torch.Tensor, ref: torch.Tensor,
                 masked: bool) -> torch.Tensor:
    """``p = exp(s - ref)``, re-zeroed where ``s`` was masked: there the
    subtraction cancels (``-1e30 - -1e30``), so a row that sees no key would
    otherwise get p = 1. Keeps such rows at zero output and zero gradient."""
    p = torch.exp(s - ref)
    if masked:
        p = torch.where(s > _NEG_INF / 2, p, torch.zeros_like(p))
    return p


def _first_visible_row(k_first: int, q_offset: int, block_q: int) -> int:
    """The first row of the first query block whose last row reaches a K
    block starting at global position ``k_first`` (causal)."""
    return max(0, -(-(k_first - q_offset - block_q + 1) // block_q)) * block_q


def _blocks(sq: int, sk: int, block_q: int, block_k: int) -> tuple[int, int]:
    block_q, block_k = min(block_q, sq), min(block_k, sk)
    if sq % block_q or sk % block_k:
        raise ValueError(f"seq lengths ({sq},{sk}) must divide blocks "
                         f"({block_q},{block_k})")
    return block_q, block_k


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
    be an exact no-op). ``lse`` is f32 (f64 for f64 inputs)."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    sm_scale = _default_scale(sm_scale, d)
    block_q, block_k = _blocks(sq, sk, block_q, block_k)
    acc_dtype = _acc_dtype(q.dtype)
    qf, kf, vf = q.to(acc_dtype), k.to(acc_dtype), v.to(acc_dtype)
    dev = q.device
    m = torch.full((bh, sq), _NEG_INF, dtype=acc_dtype, device=dev)
    l = torch.zeros((bh, sq), dtype=acc_dtype, device=dev)
    acc = torch.zeros((bh, sq, d), dtype=acc_dtype, device=dev)
    masked = causal or k_valid is not None
    for kb in range(sk // block_k):
        k_first = k_offset + kb * block_k
        if k_valid is not None and k_first >= k_valid:
            continue
        r0 = _first_visible_row(k_first, q_offset, block_q) if causal else 0
        if r0 >= sq:
            continue
        ks = slice(kb * block_k, (kb + 1) * block_k)
        s = _masked_scores(qf[:, r0:], kf[:, ks], q_offset + r0, k_first,
                           causal, sm_scale, k_valid)
        m_prev = m[:, r0:]
        m_new = torch.maximum(m_prev, s.amax(-1))
        p = _guarded_exp(s, m_new[..., None], masked)
        alpha = torch.exp(m_prev - m_new)
        l[:, r0:] = alpha * l[:, r0:] + p.sum(-1)
        acc[:, r0:] = acc[:, r0:] * alpha[..., None] + torch.matmul(
            p.to(q.dtype).to(acc_dtype), vf[:, ks])
        m[:, r0:] = m_new
    l = l.clamp_min(1e-30)
    out = (acc / l[..., None]).to(q.dtype)
    return out, m + torch.log(l)


def flash_attention_dq_plain(q, k, v, do, lse, delta, causal: bool = False,
                             q_offset: int = 0, k_offset: int = 0,
                             sm_scale: float | None = None,
                             block_q: int = 128, block_k: int = 128,
                             k_valid: int | None = None) -> torch.Tensor:
    """Plain PyTorch version of K4 (``_dq_kernel``): ``dq [BH, Sq, D]`` in
    q's dtype from ``q, do [BH, Sq, D]``, ``k, v [BH, Sk, D]``, the saved
    ``lse [BH, Sq]`` and ``delta = rowsum(do * out) - g_lse [BH, Sq]``.

    Per visible K block, in order: ``p = exp(s - lse)`` re-zeroed where ``s``
    was masked; ``dp = do . v^T`` (input-dtype products, f32 sums); ``ds =
    p * (dp - delta)``; ``dq += sm_scale * (ds in the input dtype) . k``.
    Blocks are skipped by the same causal / ``k_valid`` test as K3's."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    sm_scale = _default_scale(sm_scale, d)
    block_q, block_k = _blocks(sq, sk, block_q, block_k)
    acc_dtype = _acc_dtype(q.dtype)
    qf, kf, vf, dof = (t.to(acc_dtype) for t in (q, k, v, do))
    lse_, dl = lse.to(acc_dtype)[..., None], delta.to(acc_dtype)[..., None]
    dq = torch.zeros((bh, sq, d), dtype=acc_dtype, device=q.device)
    masked = causal or k_valid is not None
    for kb in range(sk // block_k):
        k_first = k_offset + kb * block_k
        if k_valid is not None and k_first >= k_valid:
            continue
        r0 = _first_visible_row(k_first, q_offset, block_q) if causal else 0
        if r0 >= sq:
            continue
        ks = slice(kb * block_k, (kb + 1) * block_k)
        s = _masked_scores(qf[:, r0:], kf[:, ks], q_offset + r0, k_first,
                           causal, sm_scale, k_valid)
        p = _guarded_exp(s, lse_[:, r0:], masked)
        dp = torch.matmul(dof[:, r0:], vf[:, ks].transpose(1, 2))
        ds = (p * (dp - dl[:, r0:])).to(q.dtype).to(acc_dtype)
        dq[:, r0:] += sm_scale * torch.matmul(ds, kf[:, ks])
    return dq.to(q.dtype)


def flash_attention_dkv_plain(q, k, v, do, lse, delta, causal: bool = False,
                              q_offset: int = 0, k_offset: int = 0,
                              sm_scale: float | None = None,
                              block_q: int = 128, block_k: int = 128,
                              k_valid: int | None = None):
    """Plain PyTorch version of K5 (``_dkv_kernel``): ``(dk, dv [BH, Sk,
    D])`` in k's and v's dtypes, from the inputs of
    :func:`flash_attention_dq_plain`.

    Per query block, in order, over the K blocks it sees: ``dv += (p in the
    input dtype)^T . do``; ``dk += sm_scale * (ds in the input dtype)^T .
    q``, with ``p`` and ``ds`` as in the dQ pass."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    sm_scale = _default_scale(sm_scale, d)
    block_q, block_k = _blocks(sq, sk, block_q, block_k)
    acc_dtype = _acc_dtype(q.dtype)
    qf, kf, vf, dof = (t.to(acc_dtype) for t in (q, k, v, do))
    lse_, dl = lse.to(acc_dtype)[..., None], delta.to(acc_dtype)[..., None]
    dk = torch.zeros((bh, sk, d), dtype=acc_dtype, device=q.device)
    dv = torch.zeros_like(dk)
    masked = causal or k_valid is not None
    for qb in range(sq // block_q):
        q_first = q_offset + qb * block_q
        # the visible K blocks are a prefix: k_first <= the block's last
        # row (causal) and k_first < k_valid
        n_kb = sk // block_k
        if causal:
            n_kb = min(n_kb, (q_first + block_q - 1 - k_offset)
                       // block_k + 1)
        if k_valid is not None:
            n_kb = min(n_kb, -(-(k_valid - k_offset) // block_k))
        if n_kb <= 0:
            continue
        qs, kc = slice(qb * block_q, (qb + 1) * block_q), n_kb * block_k
        s = _masked_scores(qf[:, qs], kf[:, :kc], q_first, k_offset, causal,
                           sm_scale, k_valid)
        p = _guarded_exp(s, lse_[:, qs], masked)
        dv[:, :kc] += torch.matmul(
            p.to(do.dtype).to(acc_dtype).transpose(1, 2), dof[:, qs])
        dp = torch.matmul(dof[:, qs], vf[:, :kc].transpose(1, 2))
        ds = (p * (dp - dl[:, qs])).to(q.dtype).to(acc_dtype)
        dk[:, :kc] += sm_scale * torch.matmul(ds.transpose(1, 2), qf[:, qs])
    return dk.to(k.dtype), dv.to(v.dtype)


@functools.cache
def _kernel_lib() -> ctypes.CDLL:
    from ddw_tpu_torch.ops import _build

    lib = _build.load("flash_attention.cu")
    lib.ddw_flash_fwd.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_float]
        + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    lib.ddw_flash_fwd.restype = ctypes.c_int
    return lib


@functools.cache
def _bwd_lib() -> ctypes.CDLL:
    from ddw_tpu_torch.ops import _build

    lib = _build.load("flash_attention_bwd.cu")
    # q, k, v, do, lse, delta, then dq or (dk, dv); bh, sq, sk, d, dtype,
    # causal, q_offset, k_offset; sm_scale; k_valid; the stream
    for fn, outs in ((lib.ddw_flash_bwd_dq, 1), (lib.ddw_flash_bwd_dkv, 2)):
        fn.argtypes = ([ctypes.c_void_p] * (6 + outs) + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


@functools.cache
def _sm90_lib() -> ctypes.CDLL:
    from ddw_tpu_torch.ops import _build

    lib = _build.load("flash_fwd_sm90.cu")
    # q, k, v, out, lse; bh, sq, sk, d, dtype, causal, q_offset, k_offset;
    # sm_scale; k_valid; the stream
    lib.ddw_flash_fwd_sm90.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_float,
                                                     ctypes.c_int,
                                                     ctypes.c_void_p])
    lib.ddw_flash_fwd_sm90.restype = ctypes.c_int
    lib.ddw_flash_fwd_sm90_smem.argtypes = [ctypes.c_int]
    lib.ddw_flash_fwd_sm90_smem.restype = ctypes.c_int
    return lib


@functools.cache
def _sm90_bwd_lib() -> ctypes.CDLL:
    from ddw_tpu_torch.ops import _build

    lib = _build.load("flash_bwd_sm90.cu")
    # q, k, v, do, lse, delta, then dq or (dk, dv); bh, sq, sk, d, dtype,
    # causal, q_offset, k_offset; sm_scale; k_valid; the stream
    for fn, outs in ((lib.ddw_flash_bwd_dq_sm90, 1),
                     (lib.ddw_flash_bwd_dkv_sm90, 2)):
        fn.argtypes = ([ctypes.c_void_p] * (6 + outs) + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    lib.ddw_flash_bwd_sm90_smem.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.ddw_flash_bwd_sm90_smem.restype = ctypes.c_int
    return lib


def _fwd_variant(dtype: torch.dtype, head_dim: int, block_k: int) -> str:
    """Which K3 kernel a forward of this shape launches: ``"sm90"`` (TMA and
    ``wgmma``, ``csrc/flash_fwd_sm90.cu``) for bf16 and f16 with ``block_k``
    = 128 at every head dim up to 256 that is a multiple of 8 (a row of
    ``head_dim * 2`` bytes is then 16-byte aligned, as a tensor map needs;
    the 64-column boxes read zeros past the row's end, so a 96-byte row of
    head dim 48 runs at width 64); ``"mma"`` (``mma.sync``) for the other
    bf16 and f16 shapes with ``block_k`` a multiple of 16 up to head dim
    256; ``"cuda_cores"`` for f32, for 16-bit blocks that are not multiples
    of 16 and for head dims above 256."""
    if dtype in _HALF_DTYPES and block_k % 16 == 0 and \
            head_dim <= _MMA_MAX_HEAD_DIM:
        if block_k == _SM90_BLOCK_K and head_dim % _SM90_HEAD_DIM_STEP == 0:
            return "sm90"
        return "mma"
    return "cuda_cores"


def _bwd_variant(dtype: torch.dtype, head_dim: int) -> str:
    """Which K4 and K5 kernels a backward of this shape launches (the two
    always take the same): ``"sm90"`` (TMA and ``wgmma``,
    ``csrc/flash_bwd_sm90.cu``) for bf16 and f16 at every head dim up to 256
    that is a multiple of 8 (the tensor maps' 16-byte row stride, as in
    :func:`_fwd_variant`); ``"mma"`` (``mma.sync``) for the other bf16 and
    f16 head dims up to 256; ``"cuda_cores"`` for f32 and for head dims
    above 256. The kernels pick their own tiles, so no block size enters."""
    if dtype in _HALF_DTYPES and head_dim <= _MMA_MAX_HEAD_DIM:
        if head_dim % _SM90_HEAD_DIM_STEP == 0:
            return "sm90"
        return "mma"
    return "cuda_cores"


def compiled_width(variant: str, head_dim: int) -> int:
    """The head dim a variant's kernel is compiled for and stages at (the
    columns past ``head_dim`` zero-filled in shared memory): the next of
    :data:`_MMA_WIDTHS` on ``mma``, 16 or 32 on ``cuda_cores`` up to 32 and
    whole slabs of 64 above, the next of :data:`_SM90_WIDTHS` (64, 128 or
    256) on ``sm90``, K3's forward and K4's and K5's backward alike (their
    tensor maps zero-fill the columns past ``head_dim``)."""
    if variant == "mma":
        return next(w for w in _MMA_WIDTHS if w >= head_dim)
    if variant == "cuda_cores":
        if head_dim <= _CC_WIDTHS[-2]:
            return next(w for w in _CC_WIDTHS if w >= head_dim)
        return -(-head_dim // _CC_WIDTHS[-1]) * _CC_WIDTHS[-1]
    return next(w for w in _SM90_WIDTHS if w >= head_dim)


def _check_kernel_inputs(q, k, v, *extra) -> None:
    """The contract every flash-attention kernel checks before it launches:
    contiguous, 16-byte aligned ``q [BH, Sq, D]``, ``k``/``v [BH, Sk, D]``
    CUDA tensors of one dtype, float32, bfloat16 or float16, any D >= 1,
    non-empty and under 2**31 elements; ``extra`` tensors on the same
    device, contiguous and aligned too. The dtype and shape are checked
    first, so a dtype no kernel takes is named wherever the tensors lie:
    64-bit types, which ``ddw_tpu`` (run without x64) never holds."""
    tensors = (q, k, v, *extra)
    if q.dtype not in _KERNEL_DTYPES or any(t.dtype != q.dtype
                                            for t in (k, v)):
        raise ValueError(f"the flash-attention kernels take float32, "
                         f"bfloat16 or float16 q, k, v of one dtype, as "
                         f"ddw_tpu's do (it runs without 64-bit types), got "
                         f"{[t.dtype for t in (q, k, v)]}")
    if q.dim() != 3 or k.shape != v.shape or k.dim() != 3 or \
            k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2] or \
            q.shape[2] < 1:
        raise ValueError(f"need q [BH, Sq, D] and k, v [BH, Sk, D] with "
                         f"D >= 1, got {[tuple(t.shape) for t in (q, k, v)]}")
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError(f"the flash-attention kernel needs q, k, v on one "
                         f"CUDA device, got {[str(t.device) for t in tensors]}")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in tensors):
        raise ValueError("the flash-attention kernel needs contiguous, "
                         "16-byte aligned q, k, v")
    if min(q.shape[0], q.shape[1], k.shape[1]) < 1 or \
            max(q.numel(), k.numel()) >= 1 << 31:
        raise ValueError(f"need non-empty q, k, v of fewer than 2**31 "
                         f"elements, got {[tuple(t.shape) for t in tensors]}")


def _check_launch(err: int, what: str) -> None:
    """Raise on a C entry's non-zero return: a cudaError_t code, or (from the
    sm90 sources) 1000 plus the CUresult of a failed tensor-map encode."""
    if err >= 1000:
        raise RuntimeError(f"{what}: encoding a TMA tensor map failed with "
                           f"CUresult {err - 1000}")
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _override(variant: str, forced: str | None, what: str) -> str:
    """``variant``, or ``forced`` where that kernel takes the shape too:
    only ``"mma"`` in place of ``"sm90"``. Raises otherwise."""
    if forced is None or forced == variant:
        return variant
    if forced == "mma" and variant == "sm90":
        return forced
    raise ValueError(f"cannot run the {forced!r} {what} (its kernel is "
                     f"{variant!r})")


def _forced_variant(dtype: torch.dtype, head_dim: int, block_k: int,
                    forced: str | None) -> str:
    """:func:`_fwd_variant`, or ``forced`` where that kernel takes the shape
    too: only ``"mma"`` in place of ``"sm90"``. Raises otherwise."""
    return _override(_fwd_variant(dtype, head_dim, block_k), forced,
                     f"forward kernel on {dtype}, head dim {head_dim}, "
                     f"block_k {block_k}")


def _forced_bwd_variant(dtype: torch.dtype, head_dim: int,
                        forced: str | None) -> str:
    """:func:`_bwd_variant`, or ``forced`` where that kernel takes the shape
    too: only ``"mma"`` in place of ``"sm90"``. Raises otherwise."""
    return _override(_bwd_variant(dtype, head_dim), forced,
                     f"backward kernel on {dtype}, head dim {head_dim}")


def flash_attention_cuda(q, k, v, causal: bool = False, q_offset: int = 0,
                         k_offset: int = 0, sm_scale: float | None = None,
                         block_k: int = 128, k_valid: int | None = None, *,
                         _variant: str | None = None):
    """Launch K3 on the current stream, without synchronising: ``(out [BH,
    Sq, D]`` in q's dtype, ``lse [BH, Sq]`` f32) from inputs that meet
    :func:`_check_kernel_inputs`, with ``block_k <= 128`` dividing Sk. The
    kernel is :func:`_fwd_variant`'s; ``_variant="mma"`` runs the ``mma.sync``
    kernel where ``sm90`` would run (to time the two side by side). Raises on
    anything else; never falls back. ``launches`` counts every launch,
    ``launches_by_variant`` each kernel's."""
    _check_kernel_inputs(q, k, v)
    bh, sq, d = q.shape
    sk = k.shape[1]
    if not 1 <= block_k <= _KERNEL_MAX_BLOCK_K or sk % block_k:
        raise ValueError(f"block_k {block_k} must be in [1, "
                         f"{_KERNEL_MAX_BLOCK_K}] and divide Sk={sk}")
    variant = _forced_variant(q.dtype, d, block_k, _variant)
    out = torch.empty_like(q)
    lse = torch.empty((bh, sq), dtype=torch.float32, device=q.device)
    scale = _default_scale(sm_scale, d)
    kv = -1 if k_valid is None else k_valid
    with torch.cuda.device(q.device):
        if variant == "sm90":
            err = _sm90_lib().ddw_flash_fwd_sm90(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse.data_ptr(), bh, sq, sk, d, _KERNEL_DTYPES[q.dtype],
                int(causal), q_offset, k_offset, scale, kv,
                _stream(q.device))
        else:
            err = _kernel_lib().ddw_flash_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse.data_ptr(), bh, sq, sk, d, _KERNEL_DTYPES[q.dtype],
                int(causal), q_offset, k_offset, scale, block_k, kv,
                _stream(q.device))
    _check_launch(err, f"flash-attention forward (K3, {variant})")
    flash_attention_cuda.launches += 1
    flash_attention_cuda.launches_by_variant[variant] += 1
    return out, lse


def reset_forward_counts() -> None:
    """Set K3's launch counts, the total and each variant's, to zero."""
    flash_attention_cuda.launches = 0
    flash_attention_cuda.launches_by_variant = dict.fromkeys(_FWD_VARIANTS, 0)


reset_forward_counts()


def _check_bwd_inputs(q, k, v, do, lse, delta) -> None:
    _check_kernel_inputs(q, k, v, do, lse, delta)
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"do must match q [BH, Sq, D] {q.dtype}, got "
                         f"{tuple(do.shape)} {do.dtype}")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != q.shape[:2] or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 [BH, Sq] = "
                             f"{tuple(q.shape[:2])}, got {tuple(t.shape)} "
                             f"{t.dtype}")


def flash_attention_dq_cuda(q, k, v, do, lse, delta, causal: bool = False,
                            q_offset: int = 0, k_offset: int = 0,
                            sm_scale: float | None = None,
                            k_valid: int | None = None, *,
                            _variant: str | None = None) -> torch.Tensor:
    """Launch K4 on the current stream, without synchronising: ``dq [BH, Sq,
    D]`` in q's dtype from the inputs of :func:`flash_attention_dq_plain`
    (``do`` like q; ``lse`` and ``delta`` float32 ``[BH, Sq]``), all meeting
    :func:`_check_kernel_inputs`. Any Sq and Sk: the kernels' tiles are their
    own, and mask the ragged edge. The kernel is :func:`_bwd_variant`'s;
    ``_variant="mma"`` runs the ``mma.sync`` kernel where ``sm90`` would run
    (to time the two side by side). Raises on anything else; never falls
    back. ``launches`` counts every launch, ``launches_by_variant`` each
    kernel's."""
    _check_bwd_inputs(q, k, v, do, lse, delta)
    bh, sq, d = q.shape
    variant = _forced_bwd_variant(q.dtype, d, _variant)
    dq = torch.empty_like(q)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr())
    scale = _default_scale(sm_scale, d)
    kv = -1 if k_valid is None else k_valid
    with torch.cuda.device(q.device):
        if variant == "sm90":
            err = _sm90_bwd_lib().ddw_flash_bwd_dq_sm90(
                *ptrs, bh, sq, k.shape[1], d, _KERNEL_DTYPES[q.dtype],
                int(causal), q_offset, k_offset, scale, kv, _stream(q.device))
        else:
            err = _bwd_lib().ddw_flash_bwd_dq(
                *ptrs, bh, sq, k.shape[1], d, _KERNEL_DTYPES[q.dtype],
                int(causal), q_offset, k_offset, scale, kv, _stream(q.device))
    _check_launch(err, f"flash-attention dQ (K4, {variant})")
    flash_attention_dq_cuda.launches += 1
    flash_attention_dq_cuda.launches_by_variant[variant] += 1
    return dq


def flash_attention_dkv_cuda(q, k, v, do, lse, delta, causal: bool = False,
                             q_offset: int = 0, k_offset: int = 0,
                             sm_scale: float | None = None,
                             k_valid: int | None = None, *,
                             _variant: str | None = None):
    """Launch K5 on the current stream, without synchronising: ``(dk, dv
    [BH, Sk, D])`` in k's dtype, from the inputs of
    :func:`flash_attention_dq_cuda`, on the same variant. Raises on bad
    input; never falls back."""
    _check_bwd_inputs(q, k, v, do, lse, delta)
    bh, sq, d = q.shape
    variant = _forced_bwd_variant(q.dtype, d, _variant)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr())
    scale = _default_scale(sm_scale, d)
    kv = -1 if k_valid is None else k_valid
    with torch.cuda.device(q.device):
        if variant == "sm90":
            err = _sm90_bwd_lib().ddw_flash_bwd_dkv_sm90(
                *ptrs, bh, sq, k.shape[1], d, _KERNEL_DTYPES[q.dtype],
                int(causal), q_offset, k_offset, scale, kv, _stream(q.device))
        else:
            err = _bwd_lib().ddw_flash_bwd_dkv(
                *ptrs, bh, sq, k.shape[1], d, _KERNEL_DTYPES[q.dtype],
                int(causal), q_offset, k_offset, scale, kv, _stream(q.device))
    _check_launch(err, f"flash-attention dK/dV (K5, {variant})")
    flash_attention_dkv_cuda.launches += 1
    flash_attention_dkv_cuda.launches_by_variant[variant] += 1
    return dk, dv


def reset_backward_counts() -> None:
    """Set K4's and K5's launch counts, the totals and each variant's, to
    zero."""
    for fn in (flash_attention_dq_cuda, flash_attention_dkv_cuda):
        fn.launches = 0
        fn.launches_by_variant = dict.fromkeys(_BWD_VARIANTS, 0)


reset_backward_counts()


class FlashAttentionFn(torch.autograd.Function):
    """The ``pallas`` tier on ``[B*H, S, D]``: returns ``(out, lse)``, both
    differentiable. On CUDA tensors the forward launches K3 and the backward
    K4 (dQ) and K5 (dK/dV); on CPU tensors, or with ``plain=True``, the
    plain versions run. The backward computes ``delta = rowsum(g_out * out)
    - g_lse`` in f32 outside the kernels (``_bwd_impl``): the lse cotangent
    folds into the score gradient as ``ds = p * (dp - delta)``. It returns
    only the gradients the inputs need."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset, k_offset, sm_scale, block_q,
                block_k, k_valid, plain):
        plain = bool(plain) or q.device.type == "cpu"
        if plain:
            out, lse = flash_attention_plain(q, k, v, causal, q_offset,
                                             k_offset, sm_scale, block_q,
                                             block_k, k_valid)
        else:
            out, lse = flash_attention_cuda(q, k, v, causal, q_offset,
                                            k_offset, sm_scale,
                                            min(block_k, k.shape[1]), k_valid)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.cfg = (causal, q_offset, k_offset, sm_scale, block_q, block_k,
                   k_valid, plain)
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, g_out, g_lse):
        q, k, v, out, lse = ctx.saved_tensors
        causal, q_offset, k_offset, sm_scale, block_q, block_k, k_valid, \
            plain = ctx.cfg
        need_q, need_k, need_v = ctx.needs_input_grad[:3]
        acc = _acc_dtype(q.dtype)
        if g_out is None:
            g_out = torch.zeros_like(out)
        g_out = g_out.to(q.dtype).contiguous()
        delta = (g_out.to(acc) * out.to(acc)).sum(-1)
        if g_lse is not None:
            delta = delta - g_lse.to(acc)
        args = (q, k, v, g_out, lse, delta, causal, q_offset, k_offset,
                sm_scale)
        dq = dk = dv = None
        if plain:
            if need_q:
                dq = flash_attention_dq_plain(*args, block_q, block_k,
                                              k_valid)
            if need_k or need_v:
                dk, dv = flash_attention_dkv_plain(*args, block_q, block_k,
                                                   k_valid)
        else:
            if need_q:
                dq = flash_attention_dq_cuda(*args, k_valid)
            if need_k or need_v:
                dk, dv = flash_attention_dkv_cuda(*args, k_valid)
        return (dq, dk if need_k else None, dv if need_v else None,
                None, None, None, None, None, None, None, None)


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
