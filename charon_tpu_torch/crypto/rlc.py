"""Random-linear-combination randomizers for the slot's batch verify and
the FROST ceremony's batched share check.

A forged batch passes the RLC check with probability <= 2^-RLC_BITS over
the randomizers, so they come from the OS CSPRNG (`secrets`), never from a
seeded generator. Same width and distribution as charon_tpu/crypto/rlc.py.
"""

from __future__ import annotations

import secrets

import numpy as np

RLC_BITS = 64


def sample_randomizer() -> int:
    """One nonzero RLC_BITS-bit randomizer (low bit forced so none is 0)."""
    return secrets.randbits(RLC_BITS) | 1


def sample_randomizers(n: int) -> np.ndarray:
    """n nonzero RLC_BITS-bit randomizers as one uint64 array: uniform
    64-bit values with the low bit forced so none is 0."""
    if n <= 0:
        return np.zeros(0, dtype=np.uint64)
    raw = np.frombuffer(secrets.token_bytes(8 * n), dtype=np.uint64)
    return raw | np.uint64(1)
