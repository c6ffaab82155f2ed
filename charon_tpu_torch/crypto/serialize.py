"""ETH compressed serialization of BLS12-381 points (encoding half only).

The port's own copy of the encoders of charon_tpu/crypto/serialize.py:
G1 is 48 bytes of big-endian x, G2 is 96 bytes c1 || c0 of x; the top byte
carries bit7 = compressed, bit6 = infinity, bit5 = y sign (lexicographically
largest convention).
"""

from __future__ import annotations

from . import fields as F
from .curve import Fq2Ops, FqOps, to_affine

_COMP = 0x80
_INF = 0x40
_SIGN = 0x20


def g1_to_bytes(pt_jac) -> bytes:
    aff = to_affine(FqOps, pt_jac)
    if aff is None:
        out = bytearray(48)
        out[0] = _COMP | _INF
        return bytes(out)
    x, y = aff
    flags = _COMP | (_SIGN if y > (F.P - 1) // 2 else 0)
    out = bytearray(x.to_bytes(48, "big"))
    out[0] |= flags
    return bytes(out)


def g2_to_bytes(pt_jac) -> bytes:
    return g2_affine_to_bytes(to_affine(Fq2Ops, pt_jac))


def g2_affine_to_bytes(aff) -> bytes:
    """Compress an affine G2 point (None = infinity)."""
    if aff is None:
        out = bytearray(96)
        out[0] = _COMP | _INF
        return bytes(out)
    (x0, x1), y = aff
    flags = _COMP | (_SIGN if F.fq2_sign(y) else 0)
    out = bytearray(x1.to_bytes(48, "big") + x0.to_bytes(48, "big"))
    out[0] |= flags
    return bytes(out)
