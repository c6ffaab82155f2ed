"""Limb planes and rows between the two packages.

The reference keeps a field element batch as an `(E, 32, 8, W)` int32 plane
of 12-bit limbs (batch b at (b // W, b % W), pallas_plane.py to_plane /
from_plane), or as `(..., 32)` rows; the port keeps `(E, 12, Bp)` int32
tensors of 32-bit limbs with batch b in column b, or `(..., 12)` rows. Both
use R = 2^384, so a Montgomery residue is the same integer in both and
converts exactly: every 8 limbs of 12 bits are 3 limbs of 32 bits.
"""

from __future__ import annotations

import numpy as np
import torch

from . import field as F


def planes_from_jax(plane_np) -> torch.Tensor:
    """Reference (E, 32, 8, W) 12-bit plane -> port (E, 12, 8·W) tensor."""
    p = np.asarray(plane_np)
    E = p.shape[0]
    flat = p.reshape(E, 32, -1).astype(np.uint64)               # (E, 32, Bp)
    g = flat.reshape(E, 4, 8, flat.shape[-1])                    # 8 x 12 bits = 96
    l = [g[:, :, k] for k in range(8)]
    w0 = l[0] | (l[1] << 12) | ((l[2] & 0xFF) << 24)
    w1 = (l[2] >> 8) | (l[3] << 4) | (l[4] << 16) | ((l[5] & 0xF) << 28)
    w2 = (l[5] >> 4) | (l[6] << 8) | (l[7] << 20)
    words = np.stack([w0, w1, w2], axis=2).reshape(E, 12, -1)    # (E, 12, Bp)
    return torch.from_numpy((words & 0xFFFFFFFF).astype(np.uint32).view(np.int32).copy())


def planes_to_jax(t: torch.Tensor, B: int | None = None) -> np.ndarray:
    """Port (E, 12, Bp) tensor -> reference (E, 32, 8, Bp/8) 12-bit plane.
    B, when given, zeroes the padding columns from B on."""
    w = t.detach().cpu().numpy().view(np.uint32).astype(np.uint64)
    E, _, Bp = w.shape
    if B is not None:
        w = w.copy()
        w[..., B:] = 0
    g = w.reshape(E, 4, 3, Bp)
    w0, w1, w2 = g[:, :, 0], g[:, :, 1], g[:, :, 2]
    m = 0xFFF
    l = [w0 & m, (w0 >> 12) & m, (w0 >> 24) | ((w1 & 0xF) << 8), (w1 >> 4) & m,
         (w1 >> 16) & m, (w1 >> 28) | ((w2 & 0xFF) << 4), (w2 >> 8) & m, (w2 >> 20) & m]
    limbs = np.stack(l, axis=2).reshape(E, 32, Bp).astype(np.int32)
    return limbs.reshape(E, 32, 8, Bp // 8)


def port_from_ints(values, E: int, device="cpu") -> torch.Tensor:
    """Canonical ints (E=1) or (c0, c1) pairs (E=2) -> (E, 12, n) Montgomery
    tensor."""
    if E == 1:
        rows = np.stack([F.fq_from_int(v) for v in values])[:, None, :]
    else:
        rows = np.stack([F.fq2_from_ints(*v) for v in values])
    return torch.as_tensor(np.ascontiguousarray(rows.transpose(1, 2, 0)), device=device)


def ints_from_port(t: torch.Tensor) -> list:
    """(E, 12, n) Montgomery tensor -> canonical ints (E=1) or pairs (E=2)."""
    a = t.detach().cpu().numpy()
    if a.shape[0] == 1:
        return [F.fq_to_int(a[0, :, i]) for i in range(a.shape[-1])]
    return [(F.fq_to_int(a[0, :, i]), F.fq_to_int(a[1, :, i])) for i in range(a.shape[-1])]


def rows_from_jax(rows_np) -> torch.Tensor:
    """Reference (..., 32) 12-bit rows -> port (..., 12) int32 rows."""
    r = np.asarray(rows_np).astype(np.uint64)
    lead = r.shape[:-1]
    l = [r.reshape(-1, 4, 8)[:, :, k] for k in range(8)]
    w0 = l[0] | (l[1] << 12) | ((l[2] & 0xFF) << 24)
    w1 = (l[2] >> 8) | (l[3] << 4) | (l[4] << 16) | ((l[5] & 0xF) << 28)
    w2 = (l[5] >> 4) | (l[6] << 8) | (l[7] << 20)
    words = np.stack([w0, w1, w2], axis=2).reshape(*lead, 12)
    return torch.from_numpy((words & 0xFFFFFFFF).astype(np.uint32).view(np.int32).copy())


def rows_to_jax(t: torch.Tensor) -> np.ndarray:
    """Port (..., 12) rows -> reference (..., 32) 12-bit rows."""
    w = t.detach().cpu().numpy().view(np.uint32).astype(np.uint64)
    lead = w.shape[:-1]
    g = w.reshape(-1, 4, 3)
    w0, w1, w2 = g[:, :, 0], g[:, :, 1], g[:, :, 2]
    m = 0xFFF
    l = [w0 & m, (w0 >> 12) & m, (w0 >> 24) | ((w1 & 0xF) << 8), (w1 >> 4) & m,
         (w1 >> 16) & m, (w1 >> 28) | ((w2 & 0xFF) << 4), (w2 >> 8) & m, (w2 >> 20) & m]
    return np.stack(l, axis=2).reshape(*lead, 32).astype(np.int32)
