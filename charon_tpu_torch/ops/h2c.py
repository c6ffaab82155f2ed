"""Device hash-to-curve for BLS12-381 G2 (RFC 9380 SSWU_RO_) on rows (the
port's charon_tpu/ops/h2c.py).

SHA-256 `expand_message_xmd` and hash_to_field stay on the host
(crypto/hash_to_curve.py) and ship Fq2 elements u0, u1 as Montgomery rows
plus sgn0(u); the curve math runs on the device over the batch axis:

  * simplified SWU onto the 3-isogenous curve E' (`_sswu`), branchless;
    u0 and u1 of every message run as ONE batch of 2B lanes. Fq2 square
    roots use the complex method (p ≡ 3 mod 4) and squareness the Euler
    test on the Fq norm, as the host reference, so outputs are
    bit-identical. The three independent power scans of the square root
    (δ+, δ−, −a0) run as one scan over stacked rows;
  * the 3-isogeny into Jacobian coordinates, inversion-free
    (`_iso_map`, Z = x_den·y_den), its four polynomials in one stacked
    Horner;
  * q0 + q1 on the plane kernel pt_add<2> after one rows->plane
    transpose, then the 636-bit h_eff cofactor clear as one pt_mul_shared<2>
    launch (635 doublings and 304 additions chained in the kernel);
  * one Fq2 inversion for the affine output the pairing consumes. The
    Jacobian representative of the cleared point may differ from the
    reference's (other point formulas); the affine point does not.

Every exponentiation is `rows.pow_rows` over the exponent's nonzero 4-bit
windows. Batches pad to a power of two with lane-0 repeats; beyond
MAX_BATCH messages they run as successive chunks.
"""

from __future__ import annotations

import numpy as np
import torch

from ..crypto import fields as PF
from ..crypto import hash_to_curve as HH
from ..crypto.curve import H_EFF_G2
from . import buckets as BK
from . import cuda_plane as CP
from . import field as F
from . import rows as R
from . import tower as T

DST_ETH = HH.DST_ETH
MAX_BATCH = 1024     # the reference's plane TILE
LIMBS = F.LIMBS


def _c2(v) -> np.ndarray:
    return np.asarray(F.fq2_from_ints(*v), dtype=np.int32)


_A = _c2(HH.A_ISO)
_B = _c2(HH.B_ISO)
_Z = _c2(HH.Z_SSWU)
_NEG_B_A = _c2(HH._NEG_B_OVER_A)
# exceptional-case x1 = B/(Z·A) (tv == 0 in the SSWU map)
_X1_EXC = _c2(PF.fq2_mul(HH.B_ISO, PF.fq2_inv(PF.fq2_mul(HH.Z_SSWU, HH.A_ISO))))
_ONE2 = _c2(PF.FQ2_ONE)
_ZERO2 = np.zeros((2, LIMBS), np.int32)
# the four isogeny polynomials low -> high, padded to degree 3 (a leading
# zero coefficient changes no Horner value); K2 and K4 are monic
_ISO = np.stack([np.stack([_c2(c) for c in poly] + [_ZERO2] * (4 - len(poly)))
                 for poly in (HH._K1, HH._K2 + [PF.FQ2_ONE], HH._K3, HH._K4 + [PF.FQ2_ONE])])
_MONT_ONE = np.asarray(F.fq_from_int(1), dtype=np.int32)
# multiplying a Montgomery element by RAW 1 converts it to standard form
_RAW_ONE = np.asarray(F.limbs_from_int(1), dtype=np.int32)
_INV2 = np.asarray(F.fq_from_int((F.P_INT + 1) // 2), dtype=np.int32)

_E_SQRT = (F.P_INT + 1) // 4      # Fq sqrt exponent (p ≡ 3 mod 4)
_E_EULER = (F.P_INT - 1) // 2     # Euler QR test exponent


# ---------------------------------------------------------------------------
# Field helpers
# ---------------------------------------------------------------------------


def _fq_pow_scan(a, e: int):
    """a^e for a fixed host exponent (rows.pow_rows)."""
    return R.pow_rows(a, e)


def _fq_eq(a, b):
    return (a == b).all(-1)


def _fq2_eq(a, b):
    return (a == b).all(-1).all(-1)


def _fq2_norm(a):
    n0, n1 = R._fq_mul_many([(a[..., 0, :], a[..., 0, :]), (a[..., 1, :], a[..., 1, :])])
    return R.fq_add(n0, n1)


def _fq2_is_square(a):
    """Euler criterion on the Fq norm (a square in Fq2 iff norm(a) is a
    square in Fq); zero counts as square, as in the host reference."""
    norm = _fq2_norm(a)
    e = _fq_pow_scan(norm, _E_EULER)
    return R.fq_is_zero(norm) | _fq_eq(e, R.const(_MONT_ONE, a))


def _fq2_sqrt(a):
    """Branchless Fq2 square root by the complex method (p ≡ 3 mod 4), for
    a that has one: candidate (x0, a1/(2·x0)) with x0 the root of δ+ or δ−,
    else (0, sqrt(−a0)) for the a1 == 0 corner where a0 is a non-residue."""
    a0, a1 = a[..., 0, :], a[..., 1, :]
    inv2 = R.const(_INV2, a)
    alpha = _fq_pow_scan(_fq2_norm(a), _E_SQRT)
    s = R.fq_add(a0, alpha)
    d = R.fq_sub(a0, alpha)
    d1, d2 = R._fq_mul_many([(s, inv2), (d, inv2)])
    x0a, x0b, s_neg = _fq_pow_scan(R.stack([d1, d2, R.fq_neg(a0)]), _E_SQRT).unbind(0)
    x0 = R.fq_select(_fq_eq(R.fq_sqr(x0a), d1), x0a, x0b)
    x1c = R.fq_mont_mul(R.fq_mont_mul(a1, inv2), T.fq_inv(x0))
    cand = torch.stack([x0, x1c], -2)
    cand_b = torch.stack([torch.zeros_like(x0), s_neg], -2)
    return R.fq2_select(_fq2_eq(R.fq2_sqr(cand), a), cand, cand_b)


def _sgn0(a):
    """RFC 9380 sgn0 for m = 2: parity of the standard-form coordinates
    (a product with RAW 1), the c1 parity taking over when c0 == 0."""
    s = R.fq_mont_mul(a, R.const(_RAW_ONE, a))
    sign0 = s[..., 0, 0] & 1
    sign1 = s[..., 1, 0] & 1
    zero0 = R.fq_is_zero(s[..., 0, :]).to(torch.int32)
    return sign0 | (zero0 & sign1)


# ---------------------------------------------------------------------------
# SSWU map, 3-isogeny, cofactor clear
# ---------------------------------------------------------------------------


def _g(x, A, B):
    """(x² + A)·x + B for stacked x."""
    return R.fq2_add(R.fq2_mul(R.fq2_add(R.fq2_sqr(x), A), x), B)


def _sswu(u, u_sgn):
    """Simplified SWU: Fq2 rows u (..., 2, 12) -> affine (x, y) on E'. u_sgn
    is sgn0(u), computed on the host (int32, batch-shaped)."""
    A, B, Z = R.const(_A, u), R.const(_B, u), R.const(_Z, u)
    u2 = R.fq2_sqr(u)
    zu2 = R.fq2_mul(Z, u2)
    tv = R.fq2_add(R.fq2_sqr(zu2), zu2)
    tv_zero = R.fq2_is_zero(tv)
    # fq2_inv(0) = 0, so the tv == 0 lanes compute garbage that the select
    # replaces with the exceptional-case constant B/(Z·A)
    x1 = R.fq2_mul(R.const(_NEG_B_A, u), R.fq2_add(R.const(_ONE2, u), T.fq2_inv(tv)))
    x1 = R.fq2_select(tv_zero, R.const(_X1_EXC, u).expand(x1.shape), x1)
    x2 = R.fq2_mul(zu2, x1)
    gx1, gx2 = _g(torch.stack([x1, x2]), A, B).unbind(0)
    sq1 = _fq2_is_square(gx1)
    x = R.fq2_select(sq1, x1, x2)
    gx = R.fq2_select(sq1, gx1, gx2)
    y = _fq2_sqrt(gx)
    flip = u_sgn != _sgn0(y)
    y = R.fq2_select(flip, R.fq2_neg(y), y)
    return x, y


def _horner(coeffs, x):
    """Σ coeffs[i]·xⁱ over Fq2 rows x (n, 2, 12) for several polynomials at
    once: coeffs low -> high, each (polys, 2, 12); returns (polys, n, 2, 12)."""
    lead = (coeffs[0].shape[0],) + (1,) * (x.dim() - 2) + (2, LIMBS)
    acc = coeffs[-1].reshape(lead).expand(coeffs[-1].shape[0], *x.shape).contiguous()
    for c in reversed(coeffs[:-1]):
        acc = R.fq2_add(R.fq2_mul(acc, x), c.reshape(lead))
    return acc


def _iso_map(x, y):
    """3-isogeny E' -> E, inversion-free into Jacobian coordinates with
    Z = x_den·y_den (X/Z² = x_num/x_den, Y/Z³ = y·y_num/y_den)."""
    K = R.const(_ISO, x)                                   # (4 polys, 4 coeffs, 2, 12)
    xn, xd, yn, yd = _horner([K[:, i] for i in range(4)], x).unbind(0)
    Zj, yd2, xd2, xnxd, yyn = R._fq2_mul_many([(xd, yd), (yd, yd), (xd, xd), (xn, xd), (y, yn)])
    Xj, xd3 = R._fq2_mul_many([(xnxd, yd2), (xd2, xd)])
    Yj = R.fq2_mul(R.fq2_mul(yyn, xd3), yd2)
    return (Xj, Yj, Zj)


def _to_plane(x):
    """(n, 2, 12) rows -> (2, 12, n) plane."""
    return x.permute(1, 2, 0).contiguous()


def _to_rows(x):
    """(2, 12, n) plane -> (n, 2, 12) rows."""
    return x.permute(2, 0, 1).contiguous()


def _clear_cofactor(p):
    """[h_eff]·P for a Jacobian G2 plane triple (2, 12, n): MSB-first
    double-and-add over the 636-bit constant, one pt_mul_shared<2> launch
    (the reference's scan, charon_tpu/ops/h2c.py:216, starts from ∞ and
    gives the same affine point)."""
    return CP.shared_mul(*p, H_EFF_G2, 2)


def map_to_g2(u0, u1, s0, s1):
    """(u0, u1) Fq2 rows (B, 2, 12) and their host sgn0 (B,) -> affine
    (hx, hy) rows (B, 2, 12) of the G2 hash points."""
    B = u0.shape[0]
    x, y = _sswu(torch.cat([u0, u1]), torch.cat([s0, s1]))
    X, Y, Z = (_to_plane(c) for c in _iso_map(x, y))
    q0 = [c[..., :B].contiguous() for c in (X, Y, Z)]
    q1 = [c[..., B:].contiguous() for c in (X, Y, Z)]
    rX, rY, rZ = (_to_rows(c) for c in _clear_cofactor(CP.pt_add(*q0, *q1, 2)))
    zi = T.fq2_inv(rZ)
    zi2 = R.fq2_sqr(zi)
    hx, zi3 = R._fq2_mul_many([(rX, zi2), (zi2, zi)])
    return hx, R.fq2_mul(rY, zi3)


# ---------------------------------------------------------------------------
# Host entry points
# ---------------------------------------------------------------------------


def _bucket(n: int) -> int:
    return BK.pow2_bucket(n, floor=1)


def hash_to_field_planes(msgs, dst: bytes = DST_ETH):
    """Host half: expand_message_xmd + hash_to_field per message, as
    Montgomery rows u0, u1 (B, 2, 12) and the sgn0 of each u ((B,) int32)."""
    us, sg = [], []
    for m in msgs:
        u0, u1 = HH.hash_to_field_fq2(bytes(m), dst, 2)
        us += [*u0, *u1]
        sg.append((HH._sgn0_fq2(u0), HH._sgn0_fq2(u1)))
    u = F.fq_rows(us).reshape(-1, 2, 2, LIMBS)
    s = np.asarray(sg, dtype=np.int32).reshape(-1, 2)
    return (np.ascontiguousarray(u[:, 0]), np.ascontiguousarray(u[:, 1]),
            np.ascontiguousarray(s[:, 0]), np.ascontiguousarray(s[:, 1]))


def map_to_g2_device(u0, u1, s0, s1):
    """Device half over rows already on the device: pad to the power-of-two
    bucket (≤ MAX_BATCH) and run the map. Returns device rows, unsynced."""
    B = u0.shape[0]
    if B > MAX_BATCH:
        raise ValueError(f"h2c batch {B} exceeds MAX_BATCH={MAX_BATCH}")
    Bp = _bucket(B)
    hx, hy = map_to_g2(*(BK.pad_lane0(t, Bp, B) for t in (u0, u1, s0, s1)))
    return hx[:B], hy[:B]


def hash_to_g2_device(msgs, device, dst: bytes = DST_ETH):
    """hash_to_curve of a message batch on `device`: affine (hx, hy) rows
    (B, 2, 12), bit-identical to the host reference. Batches beyond
    MAX_BATCH run as successive chunks."""
    device = torch.device(device)
    if not msgs:
        empty = torch.zeros((0, 2, LIMBS), dtype=torch.int32, device=device)
        return empty, empty.clone()
    outs = []
    for lo, hi in BK.chunk_spans(len(msgs), MAX_BATCH):
        planes = hash_to_field_planes(msgs[lo:hi], dst)
        outs.append(map_to_g2_device(*(torch.as_tensor(a, device=device) for a in planes)))
    return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])
