"""Rotary position embeddings — the port of ``ddw_tpu.ops.rope``.

Each (even, odd) pair of the head dim is rotated by an angle proportional to
the token's absolute position, so attention scores depend on relative
distance only: ``(x_even, x_odd) -> (x_even cos - x_odd sin, x_even sin +
x_odd cos)`` with ``theta(pos, 2i) = pos / theta^(2i/hd)``. Angles are
computed in f32 whatever the activation dtype.
"""

from __future__ import annotations

import torch


def rope_angles(positions: torch.Tensor, head_dim: int,
                theta: float = 10000.0) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) tables for integer ``positions [S]`` -> ``[S, hd/2]``
    (leading axes pass through: ``[B, S]`` -> ``[B, S, hd/2]``)."""
    if head_dim % 2:
        raise ValueError(f"RoPE needs an even head_dim, got {head_dim}")
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=positions.device) / head_dim
    inv_freq = 1.0 / (theta ** exponent)
    ang = positions.to(torch.float32)[..., None] * inv_freq
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *,
               seq_axis: int = -2, theta: float = 10000.0) -> torch.Tensor:
    """Rotate ``x`` by its positions. The last axis is the head dim;
    ``seq_axis`` is where S lives (``-2`` for ``[B, H, S, hd]``, ``1`` for
    ``[B, S, H, hd]``). ``positions`` is ``[S]`` (shared across the batch) or
    ``[B, S]`` (per-row). Returns x's dtype."""
    hd = x.shape[-1]
    axis = seq_axis % x.ndim
    if axis == x.ndim - 1:
        raise ValueError("seq_axis cannot be the head dim")
    s = x.shape[axis]
    if tuple(positions.shape) not in ((s,), (x.shape[0], s)):
        raise ValueError(f"positions {tuple(positions.shape)} must match seq "
                         f"dim {s} (axis {seq_axis}) or be [batch, {s}]")
    cos, sin = rope_angles(positions, hd, theta)
    bshape = [1] * x.ndim
    bshape[axis] = s
    bshape[-1] = hd // 2
    if positions.dim() == 2:
        bshape[0] = x.shape[0]
    cos = cos.reshape(bshape)
    sin = sin.reshape(bshape)
    x32 = x.to(torch.float32)
    x_even = x32[..., 0::2]
    x_odd = x32[..., 1::2]
    out_even = x_even * cos - x_odd * sin
    out_odd = x_even * sin + x_odd * cos
    out = torch.stack([out_even, out_odd], dim=-1).reshape(x.shape)
    return out.to(x.dtype)
