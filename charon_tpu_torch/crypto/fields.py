"""BLS12-381 base-field and scalar-field arithmetic over Python ints.

The port's own copy of the Fq / Fq2 / Fr part of the reference oracle
(charon_tpu/crypto/fields.py): the host fold, the affine conversions, the
Lagrange coefficients of the slot and the host constants of the device
tower (Frobenius γ, from fq2_pow and fq2_conj) need nothing of the Fq6/Fq12
tower itself.

    Fq   : int in [0, P)
    Fq2  : (c0, c1)  meaning c0 + c1*u,  u^2 = -1
"""

from __future__ import annotations

# Base field modulus (381 bits).
P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
# Subgroup order (scalar field, 255 bits).
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
# BLS parameter x (negative: x = -X_ABS).
X_ABS = 0xD201000000010000

# ---------------------------------------------------------------------------
# Fq
# ---------------------------------------------------------------------------


def fq_add(a: int, b: int) -> int:
    c = a + b
    return c - P if c >= P else c


def fq_sub(a: int, b: int) -> int:
    c = a - b
    return c + P if c < 0 else c


def fq_mul(a: int, b: int) -> int:
    return (a * b) % P


def fq_neg(a: int) -> int:
    return P - a if a else 0


def fq_inv(a: int) -> int:
    return pow(a, -1, P)


def fq_sqrt(a: int) -> int | None:
    """Square root in Fq (P % 4 == 3): a^((P+1)/4), None for a non-QR."""
    s = pow(a, (P + 1) // 4, P)
    return s if (s * s) % P == a else None


# ---------------------------------------------------------------------------
# Fq2 = Fq[u]/(u^2+1)
# ---------------------------------------------------------------------------

FQ2_ZERO = (0, 0)
FQ2_ONE = (1, 0)


def fq2_add(a, b):
    return (fq_add(a[0], b[0]), fq_add(a[1], b[1]))


def fq2_sub(a, b):
    return (fq_sub(a[0], b[0]), fq_sub(a[1], b[1]))


def fq2_neg(a):
    return (fq_neg(a[0]), fq_neg(a[1]))


def fq2_mul(a, b):
    a0, a1 = a
    b0, b1 = b
    t0 = a0 * b0
    t1 = a1 * b1
    t2 = (a0 + a1) * (b0 + b1)
    return ((t0 - t1) % P, (t2 - t0 - t1) % P)


def fq2_sqr(a):
    a0, a1 = a
    t0 = (a0 + a1) * (a0 - a1)
    t1 = 2 * a0 * a1
    return (t0 % P, t1 % P)


def fq2_mul_scalar(a, k: int):
    return ((a[0] * k) % P, (a[1] * k) % P)


def fq2_inv(a):
    a0, a1 = a
    d = pow((a0 * a0 + a1 * a1) % P, -1, P)
    return ((a0 * d) % P, (P - a1) * d % P if a1 else 0)


def fq2_conj(a):
    return (a[0], fq_neg(a[1]))


def fq2_pow(a, e: int):
    result = FQ2_ONE
    base = a
    while e:
        if e & 1:
            result = fq2_mul(result, base)
        base = fq2_sqr(base)
        e >>= 1
    return result


def fq2_sign(a) -> int:
    """Lexicographic sign of the ETH compressed encoding: 1 iff c1 > (P-1)/2,
    or c1 == 0 and c0 > (P-1)/2."""
    half = (P - 1) // 2
    if a[1]:
        return 1 if a[1] > half else 0
    return 1 if a[0] > half else 0


def fq2_sqrt(a):
    """Square root in Fq2 by the complex method (P % 4 == 3); None if a is
    not a square."""
    a0, a1 = a
    if a1 == 0:
        s = fq_sqrt(a0)
        if s is not None:
            return (s, 0)
        s = fq_sqrt(fq_neg(a0))
        if s is None:
            return None
        return (0, s)
    alpha = fq_sqrt((a0 * a0 + a1 * a1) % P)
    if alpha is None:
        return None
    inv2 = (P + 1) // 2
    delta = (a0 + alpha) * inv2 % P
    x0 = fq_sqrt(delta)
    if x0 is None:
        delta = (a0 - alpha) * inv2 % P
        x0 = fq_sqrt(delta)
        if x0 is None:
            return None
    x1 = a1 * inv2 % P * pow(x0, -1, P) % P
    cand = (x0, x1)
    if fq2_sqr(cand) != (a0 % P, a1 % P):
        return None
    return cand


# ---------------------------------------------------------------------------
# Scalar field Fr
# ---------------------------------------------------------------------------


def fr_inv(a: int) -> int:
    return pow(a, -1, R)


def lagrange_coefficients_at_zero(ids: list[int]) -> list[int]:
    """Lagrange basis coefficients lambda_i at x=0 for the share indices
    `ids` (distinct, >= 1), over Fr: sum_i lambda_i * f(id_i) = f(0) for any
    f of degree < len(ids)."""
    coeffs = []
    for i in ids:
        num, den = 1, 1
        for j in ids:
            if j == i:
                continue
            num = num * j % R
            den = den * ((j - i) % R) % R
        coeffs.append(num * fr_inv(den) % R)
    return coeffs
