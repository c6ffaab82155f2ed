"""Power-of-two bucket and padding geometry of the device verify (the port's
copy of charon_tpu/ops/buckets.py).

The floors are part of each caller's contract, as in the reference: pairing
pair sets floor at 2 (a slot always carries one message group plus the
signature pair) and hash-to-G2 batches at 1. Padding repeats lane 0, so a
padding lane holds a real group element and is masked out of the verdict.
`pad_lane0` pads a tensor (the port's rows) instead of a numpy array.
"""

from __future__ import annotations

import torch


def pow2_bucket(n: int, floor: int = 1) -> int:
    """Smallest power-of-two multiple of `floor` that is >= max(n, floor);
    `floor` must itself be a power of two."""
    if floor < 1 or floor & (floor - 1):
        raise ValueError(f"floor must be a power of two, got {floor}")
    b = floor
    while b < n:
        b *= 2
    return b


def pad_lane0(a: torch.Tensor, bucket: int, n: int | None = None) -> torch.Tensor:
    """Pad `a` along axis 0 to `bucket` rows by repeating lane 0; a no-op
    when already at the bucket."""
    if n is None:
        n = a.shape[0]
    if bucket == n:
        return a
    if bucket < n:
        raise ValueError(f"bucket {bucket} below batch {n}")
    return torch.cat([a, a[:1].expand(bucket - n, *a.shape[1:])])


def live_mask(n: int, bucket: int, device=None) -> torch.Tensor:
    """Bool mask over a padded batch axis: True for the n live lanes."""
    mask = torch.zeros(bucket, dtype=torch.bool, device=device)
    mask[:n] = True
    return mask


def chunk_spans(n: int, size: int) -> list[tuple[int, int]]:
    """[start, stop) spans covering range(n) in `size`-wide chunks."""
    if size < 1:
        raise ValueError(f"chunk size must be positive, got {size}")
    return [(s, min(s + size, n)) for s in range(0, n, size)]
