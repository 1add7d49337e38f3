"""Shape buckets — the port's copy of ``ddw_tpu.serve.bucketing`` (numpy only).

Variable prompt and sequence lengths are right-padded up to a small
geometric ladder of buckets (powers of two from ``min_bucket``, capped by the
model bound), the same ladder ``ddw_tpu`` uses, so both packages pad a
request to the same width. Padding is free on the LM paths: causal masking
hides pad positions from every real query, scoring masks them out of the
mean, and after a padded prefill the cache indices snap back to the true
length (:func:`ddw_tpu_torch.models.lm.set_cache_lengths`).
"""

from __future__ import annotations

import numpy as np

DEFAULT_MIN_BUCKET = 8


def length_buckets(max_len: int, min_bucket: int = DEFAULT_MIN_BUCKET
                   ) -> tuple[int, ...]:
    """The bucket ladder: powers of two in ``[min_bucket, max_len)`` plus
    ``max_len`` itself (so the bound is always reachable exactly)."""
    if max_len < 1:
        raise ValueError(f"max_len must be >= 1, got {max_len}")
    out = []
    b = max(1, min_bucket)
    while b < max_len:
        out.append(b)
        b *= 2
    out.append(max_len)
    return tuple(out)


def bucket_len(n: int, max_len: int,
               min_bucket: int = DEFAULT_MIN_BUCKET) -> int:
    """Smallest bucket >= ``n``. Raises when ``n`` exceeds every bucket —
    the caller's length validation should have refused first."""
    for b in length_buckets(max_len, min_bucket):
        if n <= b:
            return b
    raise ValueError(f"length {n} exceeds the largest bucket {max_len}")


def pad_to_bucket(tokens: np.ndarray, bucket: int,
                  pad_id: int = 0) -> np.ndarray:
    """Right-pad int token rows ``[B, L]`` to ``[B, bucket]``. ``pad_id``
    must be a valid vocab id (the embedding gathers it; causal masking and
    the index snap-back keep it out of every real result)."""
    b, n = tokens.shape
    if n > bucket:
        raise ValueError(f"tokens length {n} exceeds bucket {bucket}")
    if n == bucket:
        return tokens
    out = np.full((b, bucket), pad_id, tokens.dtype)
    out[:, :n] = tokens
    return out


def batch_bucket(n: int, max_batch: int) -> int:
    """Batch-dim bucket: smallest power of two >= ``n``, capped at
    ``max_batch`` (the dynamic batcher never forms a larger batch)."""
    if n < 1:
        raise ValueError(f"batch must be >= 1, got {n}")
    b = 1
    while b < n:
        b *= 2
    return min(b, max_batch)
