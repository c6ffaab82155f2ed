"""ETH compressed serialization of BLS12-381 points.

The port's own copy of the encoders of charon_tpu/crypto/serialize.py, of
its G1 decoder and flag check (g1_from_bytes, g1_finite_compressed: FROST's
commitments), and of the G2 decoder without its subgroup check (for H(m)
points, which hash-to-curve put in the subgroup): G1 is 48 bytes of big-endian x, G2 is
96 bytes c1 || c0 of x; the top byte carries bit7 = compressed, bit6 =
infinity, bit5 = y sign (lexicographically largest convention).
"""

from __future__ import annotations

from . import fields as F
from .curve import B_G1, B_G2, Fq2Ops, FqOps, g1_in_subgroup, jac_infinity, to_affine, to_jacobian

_COMP = 0x80
_INF = 0x40
_SIGN = 0x20


class DeserializationError(ValueError):
    pass


def g1_finite_compressed(data: bytes) -> bool:
    """Flag-level check: 48 bytes, compression bit set, NOT the point at
    infinity (FROST dealer commitments must not be ∞); the on-curve and
    subgroup work stays in the decoders."""
    return len(data) == 48 and bool(data[0] & _COMP) and not (data[0] & _INF)


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


def g1_from_bytes(data: bytes, subgroup_check: bool = True):
    """Decompress a 48-byte G1 encoding to a Jacobian point (Z = 1, or the
    infinity); raises DeserializationError on a malformed, off-curve or
    (with subgroup_check) out-of-subgroup encoding."""
    if len(data) != 48:
        raise DeserializationError("G1 compressed must be 48 bytes")
    flags = data[0]
    if not flags & _COMP:
        raise DeserializationError("uncompressed G1 not supported")
    if flags & _INF:
        if any(data[1:]) or flags & ~(_COMP | _INF):
            raise DeserializationError("invalid infinity encoding")
        return jac_infinity(FqOps)
    x = int.from_bytes(bytes([data[0] & 0x1F]) + data[1:], "big")
    if x >= F.P:
        raise DeserializationError("x not in field")
    y = F.fq_sqrt((x * x % F.P * x + B_G1) % F.P)
    if y is None:
        raise DeserializationError("x not on curve")
    if (y > (F.P - 1) // 2) != bool(flags & _SIGN):
        y = F.fq_neg(y)
    pt = to_jacobian(FqOps, (x, y))
    if subgroup_check and not g1_in_subgroup(pt):
        raise DeserializationError("point not in G1 subgroup")
    return pt


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


def g2_affine_from_bytes(data: bytes):
    """Decompress a 96-byte G2 encoding to affine ints ((x0, x1), (y0, y1)),
    None for infinity; no subgroup check. Raises ValueError on a malformed
    encoding."""
    if len(data) != 96:
        raise ValueError("G2 compressed must be 96 bytes")
    flags = data[0]
    if not flags & _COMP:
        raise ValueError("uncompressed G2 not supported")
    if flags & _INF:
        if any(data[1:]) or flags & ~(_COMP | _INF):
            raise ValueError("invalid infinity encoding")
        return None
    x1 = int.from_bytes(bytes([data[0] & 0x1F]) + data[1:48], "big")
    x0 = int.from_bytes(data[48:], "big")
    if x0 >= F.P or x1 >= F.P:
        raise ValueError("x not in field")
    x = (x0, x1)
    y = F.fq2_sqrt(F.fq2_add(F.fq2_mul(F.fq2_sqr(x), x), B_G2))
    if y is None:
        raise ValueError("x not on curve")
    if F.fq2_sign(y) != (1 if flags & _SIGN else 0):
        y = F.fq2_neg(y)
    return (x, y)
