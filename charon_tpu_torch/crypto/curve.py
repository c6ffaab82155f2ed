"""BLS12-381 G1/G2 Jacobian group operations over Python ints.

The port's own copy of the parts of the reference oracle
(charon_tpu/crypto/curve.py) the slices use: the host fold of the MSM
reductions (jac_add), affine conversion, the scalar multiplication behind
the G1 endomorphism constants and the FROST share check's host terms, the
G1 subgroup test of the G1 decoder, and the G2 effective cofactor of
hash-to-curve (H_EFF_G2).

G1: y^2 = x^3 + 4 over Fq;  G2: y^2 = x^3 + 4(u+1) over Fq2.
Points are Jacobian (X, Y, Z), x = X/Z^2, y = Y/Z^3; infinity is Z == 0.
"""

from __future__ import annotations

from . import fields as F


class FqOps:
    zero = 0
    one = 1
    add = staticmethod(F.fq_add)
    sub = staticmethod(F.fq_sub)
    mul = staticmethod(F.fq_mul)
    neg = staticmethod(F.fq_neg)
    inv = staticmethod(F.fq_inv)

    @staticmethod
    def sqr(a):
        return (a * a) % F.P

    @staticmethod
    def mul_small(a, k):
        return (a * k) % F.P

    @staticmethod
    def is_zero(a):
        return a == 0


class Fq2Ops:
    zero = F.FQ2_ZERO
    one = F.FQ2_ONE
    add = staticmethod(F.fq2_add)
    sub = staticmethod(F.fq2_sub)
    mul = staticmethod(F.fq2_mul)
    neg = staticmethod(F.fq2_neg)
    inv = staticmethod(F.fq2_inv)
    sqr = staticmethod(F.fq2_sqr)
    mul_small = staticmethod(F.fq2_mul_scalar)

    @staticmethod
    def is_zero(a):
        return a == F.FQ2_ZERO


B_G1 = 4
B_G2 = (4, 4)

G1_GEN = (
    0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB,
    0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1,
)
G2_GEN = (
    (
        0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
        0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E,
    ),
    (
        0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
        0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE,
    ),
)


# Effective G2 cofactor of hash-to-curve (RFC 9380 §8.8.2; the reference's
# H_EFF_G2, crypto/curve.py:250).
H_EFF_G2 = 0xBC69F08F2EE75B3584C6A0EA91B352888E2A8E9145AD7689986FF031508FFE1329C2F178731DB956D82BF015D1212B02EC0EC69D7477C1AE954CBC06689F6A359894C0ADEBBF6B4E8020005AAA95551


def jac_infinity(ops):
    return (ops.one, ops.one, ops.zero)


def jac_is_infinity(ops, pt):
    return ops.is_zero(pt[2])


def to_jacobian(ops, affine):
    if affine is None:
        return jac_infinity(ops)
    return (affine[0], affine[1], ops.one)


def to_affine(ops, pt):
    X, Y, Z = pt
    if ops.is_zero(Z):
        return None
    zi = ops.inv(Z)
    zi2 = ops.sqr(zi)
    zi3 = ops.mul(zi2, zi)
    return (ops.mul(X, zi2), ops.mul(Y, zi3))


def jac_double(ops, pt):
    X, Y, Z = pt
    if ops.is_zero(Z) or ops.is_zero(Y):
        return jac_infinity(ops)
    A = ops.sqr(X)
    B = ops.sqr(Y)
    C = ops.sqr(B)
    D = ops.mul_small(ops.sub(ops.sub(ops.sqr(ops.add(X, B)), A), C), 2)
    E = ops.mul_small(A, 3)
    Fv = ops.sqr(E)
    X3 = ops.sub(Fv, ops.mul_small(D, 2))
    Y3 = ops.sub(ops.mul(E, ops.sub(D, X3)), ops.mul_small(C, 8))
    Z3 = ops.mul_small(ops.mul(Y, Z), 2)
    return (X3, Y3, Z3)


def jac_add(ops, p1, p2):
    X1, Y1, Z1 = p1
    X2, Y2, Z2 = p2
    if ops.is_zero(Z1):
        return p2
    if ops.is_zero(Z2):
        return p1
    Z1Z1 = ops.sqr(Z1)
    Z2Z2 = ops.sqr(Z2)
    U1 = ops.mul(X1, Z2Z2)
    U2 = ops.mul(X2, Z1Z1)
    S1 = ops.mul(ops.mul(Y1, Z2), Z2Z2)
    S2 = ops.mul(ops.mul(Y2, Z1), Z1Z1)
    if U1 == U2:
        if S1 == S2:
            return jac_double(ops, p1)
        return jac_infinity(ops)
    H = ops.sub(U2, U1)
    I = ops.sqr(ops.mul_small(H, 2))
    J = ops.mul(H, I)
    r = ops.mul_small(ops.sub(S2, S1), 2)
    V = ops.mul(U1, I)
    X3 = ops.sub(ops.sub(ops.sqr(r), J), ops.mul_small(V, 2))
    Y3 = ops.sub(ops.mul(r, ops.sub(V, X3)), ops.mul_small(ops.mul(S1, J), 2))
    Z3 = ops.mul(ops.mul_small(ops.mul(Z1, Z2), 2), H)
    return (X3, Y3, Z3)


def jac_neg(ops, pt):
    X, Y, Z = pt
    return (X, ops.neg(Y), Z)


def jac_mul(ops, pt, k: int):
    """Scalar multiplication by k mod R, MSB-first double-and-add."""
    k %= F.R
    if k == 0 or jac_is_infinity(ops, pt):
        return jac_infinity(ops)
    acc = jac_infinity(ops)
    for bit in bin(k)[2:]:
        acc = jac_double(ops, acc)
        if bit == "1":
            acc = jac_add(ops, acc, pt)
    return acc


def is_on_curve(ops, affine, b):
    if affine is None:
        return True
    x, y = affine
    return ops.sqr(y) == ops.add(ops.mul(ops.sqr(x), x), b)


def mul_full(ops, pt, k: int):
    """Scalar multiplication WITHOUT reducing k mod R (subgroup checks)."""
    if k == 0 or jac_is_infinity(ops, pt):
        return jac_infinity(ops)
    acc = jac_infinity(ops)
    for bit in bin(abs(k))[2:]:
        acc = jac_double(ops, acc)
        if bit == "1":
            acc = jac_add(ops, acc, pt)
    return jac_neg(ops, acc) if k < 0 else acc


def g1_in_subgroup(pt) -> bool:
    aff = to_affine(FqOps, pt)
    if aff is None:
        return True
    if not is_on_curve(FqOps, aff, B_G1):
        return False
    return jac_is_infinity(FqOps, mul_full(FqOps, pt, F.R))


def g1_generator():
    return to_jacobian(FqOps, G1_GEN)


def g2_generator():
    return to_jacobian(Fq2Ops, G2_GEN)
