"""The fused sigagg slot of the port (the slice's part of
charon_tpu/ops/plane_agg.py).

One slot aggregates V validators' threshold partial signatures (T each) and
RLC-verifies the aggregates against their pubkeys, in one stream-ordered
sequence of kernel launches (cuda_plane) followed by a host finish:

  1. parse + G2 decompression of the V·T partials (`g2_decompress`),
  2. windowed Lagrange sweep + T-way pairwise combine (`sweep_combine`),
  3. affine standard-form x, sign and infinity of the aggregates
     (`g2_affine_std`),
  4. the combined sig+pk RLC MSM and its group sums, one pt_reduce_groups
     call (`combined_msm`),
  5. host emit: compressed aggregate bytes and the summed points read back
     (`host_emit`),
  6. verify: one multi-pairing over (P_m, H(m)) and (−g1, S)
     (`pairing_finish`): by default on the device (the rows kernels of
     ops/rows.py through ops/pairing.py, H(m) from the dual-form cache and
     the device hash-to-G2 of ops/h2c.py), or on the native rung when asked.

The slot runs through ops/guard.py, as the reference's does on one device
(`threshold_aggregate_and_verify`): `dispatch_slot` asks the plane breaker
first (open: the slot goes to the native rung with no launch) and captures
a device-class failure of steps 1-4 as ("dispatch_failed", exc);
`guard.finish_slot` then runs the readback, emit and verify, and lands the
slot on the native rung (native.native_slot_fallback, byte-identical) on a
device-class failure of any of them. A device-class failure of the device
pairing check alone re-runs the check natively (`pairing_finish`, as the
reference's _pairing_finish). The fault seam's sites sigagg.pack,
sigagg.execute, sigagg.readback and sigagg.finish sit where the reference
has them. Inside `guard.fallback(False)` (TorchImpl with
fallback_on_device_error off) none of this applies and a device error
raises.

The bulk verify of compressed (pk, msg, sig) triples (`rlc_verify_batch`,
the receipt path of peer partials) runs chunks of VERIFY_CHUNK triples:
per chunk the parse, G2 decompression, the G2 subgroup check
(`g2_subgroup_mask`: psi(P) == [x]P) and the combined MSM
(`verify_slot`), then the chunks' sums added on the host and one pairing
check. `verify_each` checks each triple on its own instead (the attribution
after a failed batch): per-lane decoding, one Miller loop pair a triple and
the final exponentiations batched (pairing.verify_triples).

The FROST ceremony's G1 programs (dkg/frost.py's device paths) close the
module: the batched fixed-base keygen (`g1_mul_gen_batch`), the grouped
share-check MSM (`g1_groups_msm`, chunks of `groups_msm_chunk`: G1
decompression, the subgroup check, a windowed sweep on 64-bit digits and
one `pt_reduce_groups` call over the commitment degrees) and the generic
lincomb check (`g1_lincomb_is_infinity`).

The pk planes are decompressed and subgroup-checked once per pubkey set
and span (`PkPlaneCache`). Batch element b of a plane sits in column b of an
`(E, 12, n)` tensor, which is element (b // W, b % W) of the reference's
(8, W) plane, so layouts, padding, digit order and reduction order are the
reference's. Outputs are byte-identical to the reference, with the same
verdicts and the same ValueErrors.
"""

from __future__ import annotations

import functools
import hashlib
import threading
import time
from collections import OrderedDict

import numpy as np
import torch

from .. import native
from ..crypto import fields as PF
from ..crypto.curve import (B_G1, B_G2, FqOps, Fq2Ops, g1_generator, jac_add, jac_infinity,
                            jac_is_infinity, jac_mul, to_affine, to_jacobian)
from ..crypto.rlc import RLC_BITS, sample_randomizers
from ..crypto.serialize import g1_to_bytes, g2_affine_from_bytes, g2_affine_to_bytes, g2_to_bytes
from ..utils import faults
from . import cuda_plane as CP
from . import field as F
from . import guard
from . import h2c as h2c_mod
from . import pairing as pairing_mod

LIMBS = F.LIMBS
SUB = CP.SUB


@functools.lru_cache(maxsize=4096)
def lagrange(ids: tuple[int, ...]) -> tuple[int, ...]:
    return tuple(PF.lagrange_coefficients_at_zero(list(ids)))


def bucket_for_slots(V: int, T: int) -> int:
    """Per-validator bucket whose T-slot combined plane (Vp·T elements) is
    itself a padded size."""
    step = min(CP.TILE, CP.MIN_TILE)
    Vp = CP.pad_batch(V)
    while CP.pad_batch(Vp * T) != Vp * T:
        Vp += step
    return Vp


def layout_slots(batches: list[dict[int, bytes]]):
    """Permuted slot layout of all T·Vp partials: partial j of validator i
    lands at flat index (i // Wv)·W4 + (i % Wv) + j·Wv — lane block j of the
    reference's (8, W4) plane — so the combine adds lane blocks and
    validator i's aggregate lands at index i. Padding entries are compressed
    infinity with λ = 0."""
    V = len(batches)
    T = max(len(b) for b in batches)
    if T == 0:
        raise ValueError("empty partial signature set")
    Vp = bucket_for_slots(V, T)
    zero96 = b"\xc0" + bytes(95)
    Wv = Vp // SUB
    W4 = (Vp * T) // SUB
    sigs_all = [zero96] * (Vp * T)
    scalars_all = [0] * (Vp * T)
    for i, batch in enumerate(batches):
        ids = sorted(batch)
        lam = lagrange(tuple(ids))
        base = (i // Wv) * W4 + (i % Wv)
        for j in range(len(ids)):
            flat = base + j * Wv
            sigs_all[flat] = bytes(batch[ids[j]])
            scalars_all[flat] = lam[j]
    return sigs_all, scalars_all, V, Vp, T, Wv


# ---------------------------------------------------------------------------
# Parsing and constants
# ---------------------------------------------------------------------------

_P_BE = np.frombuffer(PF.P.to_bytes(48, "big"), np.uint8).astype(np.int16)


def lex_lt_p(be48: np.ndarray) -> np.ndarray:
    """(n, 48) big-endian byte rows -> (n,) bool: value < p."""
    diff = be48.astype(np.int16) - _P_BE[None]
    nz = diff != 0
    anynz = nz.any(axis=1)
    first = diff[np.arange(len(be48)), np.argmax(nz, axis=1)]
    return anynz & (first < 0)


def flag_fields(data: np.ndarray):
    """(n, size) compressed encodings -> (body, compressed, infinity, sign,
    in_field) per lane: body the bytes with the three flag bits cleared,
    in_field whether each 48-byte x part of the body is below p. The flag
    rules of parse_compressed and parse_lanes."""
    flags = data[:, 0]
    body = data.copy()
    body[:, 0] &= 0x1F
    in_field = np.ones(len(data), bool)
    for off in range(0, data.shape[1], 48):
        in_field &= lex_lt_p(body[:, off:off + 48])
    return (body, (flags & 0x80) != 0, (flags & 0x40) != 0,
            ((flags & 0x20) >> 5).astype(np.int32), in_field)


def parse_compressed(items: list[bytes], size: int, kind: str,
                     reject_infinity: bool, Bp: int):
    """Host-side byte parsing with the reference's flag rules (compression
    bit, infinity encoding, x < p) and error texts. Returns (body, fin,
    sign, loaded) with sign/loaded as flat (Bp,) arrays."""
    n = len(items)
    data = np.frombuffer(b"".join(bytes(s) for s in items), np.uint8).reshape(n, size)
    body, comp, inf, sign, in_field = flag_fields(data)
    if not comp.all():
        raise ValueError(f"uncompressed {kind} not supported")
    if inf.any():
        if reject_infinity:
            raise ValueError(f"infinity {kind} point rejected")
        bad = inf & (body.any(axis=1) | (sign == 1))
        if bad.any():
            raise ValueError(f"invalid {kind} point at index {int(np.argmax(bad))}")
    fin = ~inf
    if not in_field[fin].all():
        raise ValueError(f"invalid {kind} point: x not in field")
    sgn = np.zeros(Bp, np.int32)
    sgn[:n] = sign
    loaded = np.zeros(Bp, bool)
    loaded[:n] = fin
    return body, fin, sgn, loaded


def raise_bad(okm: np.ndarray, kind: str) -> None:
    raise ValueError(f"invalid {kind} point at index {int(np.argmax(~okm.reshape(-1)))}")


def raw_to_plane(be48: np.ndarray, Bp: int, device) -> torch.Tensor:
    """(n, 48) big-endian bytes -> (1, 12, Bp) raw-limb plane (standard form)."""
    arr = np.zeros((Bp, LIMBS), np.int32)
    arr[:len(be48)] = F.fp_limbs_raw(be48)
    return torch.as_tensor(np.ascontiguousarray(arr.T)[None], device=device)


_const_cache: dict = {}
_const_lock = threading.Lock()


def const_plane(vals: tuple, E: int, n: int, device, raw: bool = False) -> torch.Tensor:
    """Broadcast (E, 12, n) plane of a constant: Montgomery form of vals, or
    with raw=True the limbs of vals[0] as they are (R² for the Montgomery
    entry, 1 for the exit)."""
    key = (vals, E, n, str(device), raw)
    t = _const_cache.get(key)
    if t is None:
        if raw:
            col = F.limbs_from_int(vals[0])[None]
        elif E == 1:
            col = F.fq_from_int(vals[0])[None]
        else:
            col = F.fq2_from_ints(*vals)
        t = torch.as_tensor(col, device=device).view(E, LIMBS, 1).expand(E, LIMBS, n).contiguous()
        with _const_lock:
            if len(_const_cache) > 256:
                _const_cache.clear()
            _const_cache[key] = t
    return t


def to_mont(plane: torch.Tensor) -> torch.Tensor:
    """Raw standard-form Fq limbs (1, 12, n) -> Montgomery form: one product
    by R²."""
    return CP.fe_mul(plane, const_plane((F.R2_INT,), 1, plane.shape[-1], plane.device, raw=True), 1)


def to_std(*planes: torch.Tensor) -> list:
    """Montgomery -> standard form of each (E, 12, n) plane: one Fq product
    by raw 1 per component, every component of every plane in one level
    (the reference packs an Fq2 plane's components onto the lanes)."""
    one = const_plane((1,), 1, planes[0].shape[-1], planes[0].device, raw=True)
    outs = [torch.empty_like(p) for p in planes]
    CP.mul_level([(p[e:e + 1], one) for p in planes for e in range(p.shape[0])], 1,
                 [o[e:e + 1] for o in outs for e in range(o.shape[0])])
    return outs


_HALF = F.limbs_from_int((PF.P - 1) // 2).astype(np.int64) & 0xFFFFFFFF
_EXP = {
    "sqrt": CP.exp_digits((PF.P + 1) // 4),
    "inv": CP.exp_digits(PF.P - 2),
    "e34": CP.exp_digits((PF.P - 3) // 4),
}


def gt_half_std(plane: torch.Tensor) -> torch.Tensor:
    """(1, 12, n) standard-form Fq plane -> (n,) bool: value > (p−1)/2."""
    x = plane[0].to(torch.int64) & 0xFFFFFFFF
    gt = torch.zeros(x.shape[-1], dtype=torch.bool, device=x.device)
    eq = torch.ones_like(gt)
    for j in reversed(range(LIMBS)):
        gt = gt | (eq & (x[j] > int(_HALF[j])))
        eq = eq & (x[j] == int(_HALF[j]))
    return gt


def _all(mask: torch.Tensor) -> torch.Tensor:
    """(E, 12, n) bool -> (n,): true in every component and limb."""
    return mask.all(0).all(0)


def fq_sqrt(a: torch.Tensor, more=()):
    """Batched Fq sqrt candidate s = a^((p+1)/4) and its validity s² == a;
    the check's product shares its level with s·m for each m in `more`.
    Returns (s, ok, [s·m ...])."""
    s = CP.pow_scan(a, _EXP["sqrt"])
    sq, *rest = CP.mul_level([(s, s)] + [(s, m) for m in more], 1)
    return s, _all(sq == a), rest


def _sel(mask: torch.Tensor, a: torch.Tensor, b) -> torch.Tensor:
    return torch.where(mask.view(1, 1, -1), a, b)


# ---------------------------------------------------------------------------
# Decompression (reference _g1_decompress_core :462, _g2_decompress_core :508)
# ---------------------------------------------------------------------------


def g1_decompress(Xr, sgn, lmask):
    """Raw x plane + flat sign/loaded masks -> (X, Y, Z, ok) Montgomery
    affine points (Z = 1 where loaded, ∞ elsewhere)."""
    X = to_mont(Xr)
    n = X.shape[-1]
    xsq = CP.fe_mul(X, X, 1)
    xcube = CP.fe_mul(xsq, X, 1)
    y2 = CP.fe_add(xcube, const_plane((B_G1,), 1, n, X.device), 1)
    # the root's standard form (for its sign) beside the check s² == y2
    y, ok, (ystd,) = fq_sqrt(y2, [const_plane((1,), 1, n, X.device, raw=True)])
    flip = (gt_half_std(ystd).to(torch.int32) != sgn) & lmask
    Y = _sel(flip, CP.fe_neg(y, 1), y)
    Y = _sel(lmask, Y, 0)
    X = _sel(lmask, X, 0)
    Z = _sel(lmask, const_plane((1,), 1, n, X.device), 0)
    return X, Y, Z, ok | ~lmask


def g2_decompress(X0r, X1r, sgn, lmask):
    """Raw x component planes + flat masks -> (X, Y, Z, ok). The Fq2 square
    root by the complex method, branchless over the plane: one (p−3)/4 power
    scan serves the three candidates (δ+, δ−, −c0) and also yields 1/y0; the
    c1 == 0 fallback candidate is (0, sqrt(−c0)); the sign is lexicographic,
    and its flip negates both components in one Fq2 pass. Independent
    operations share a level: one launch each."""
    n = X0r.shape[-1]
    dev = X0r.device
    X = torch.empty((2, LIMBS, n), dtype=torch.int32, device=dev)
    r2 = const_plane((F.R2_INT,), 1, n, dev, raw=True)
    CP.mul_level([(X0r, r2), (X1r, r2)], 1, [X[0:1], X[1:2]])
    Xsq = CP.fe_mul(X, X, 2)
    Xcb = CP.fe_mul(Xsq, X, 2)
    y2 = CP.fe_add(Xcb, const_plane(B_G2, 2, n, dev), 2)
    c0, c1 = y2[0:1], y2[1:2]

    norm = CP.fe_add(*CP.mul_level([(c0, c0), (c1, c1)], 1), 1)
    alpha = CP.pow_scan(norm, _EXP["sqrt"])
    inv2 = const_plane(((PF.P + 1) // 2,), 1, n, dev)
    # the candidates δ+ = (c0 + α)/2, δ− = (c0 − α)/2 and −c0 side by side
    packed = torch.empty((1, LIMBS, 3 * n), dtype=torch.int32, device=dev)
    delta_p, delta_m, neg_c0 = packed[..., :n], packed[..., n:2 * n], packed[..., 2 * n:]
    c0pa, c0ma = CP.addsub_level([("add", c0, alpha), ("sub", c0, alpha), ("neg", None, c0)], 1,
                                 [None, None, neg_c0])[:2]
    c1h = CP.mul_level([(c0pa, inv2), (c0ma, inv2), (c1, inv2)], 1, [delta_p, delta_m, None])[2]
    s34 = CP.pow_scan(packed, _EXP["e34"])
    roots = CP.fe_mul(s34, packed, 1)
    x0p, x0m, s2c = roots[..., :n], roots[..., n:2 * n], roots[..., 2 * n:]
    s_p, s_m = s34[..., :n], s34[..., n:2 * n]
    # both candidates' s² (the one selected is the same words as the square
    # of the selected s) and the fallback's check beside the δ+ check
    x0psq, spsq, smsq, s2sq = CP.mul_level([(x0p, x0p), (s_p, s_p), (s_m, s_m), (s2c, s2c)], 1)
    okp = _all(x0psq == delta_p)
    y0 = _sel(okp, x0p, x0m)
    y0inv = CP.fe_mul(y0, _sel(okp, spsq, smsq), 1)
    y1 = CP.fe_mul(c1h, y0inv, 1)

    ypy, ymy = CP.addsub_level([("add", y0, y1), ("sub", y0, y1)], 1)
    m0, m1 = CP.mul_level([(ypy, ymy), (y0, y1)], 1)
    m1x2, neg_s2sq = CP.addsub_level([("add", m1, m1), ("neg", None, s2sq)], 1)
    valid1 = _all(m0 == c0) & _all(m1x2 == c1)
    valid2 = _all(neg_s2sq == c0) & _all(c1 == 0)
    Y = torch.cat([_sel(valid1, y0, 0), _sel(valid1, y1, s2c)], 0)
    ok = valid1 | valid2

    ys = to_std(Y)[0]
    csign = torch.where(~_all(Y[1:2] == 0), gt_half_std(ys[1:2]),
                        gt_half_std(ys[0:1])).to(torch.int32)
    flip = (csign != sgn) & lmask
    Y = _sel(flip, CP.fe_neg(Y, 2), Y)

    Xp = _sel(lmask, X, 0)
    Yp = _sel(lmask, Y, 0)
    z0 = _sel(lmask, const_plane((1,), 1, n, dev), 0)
    Z = torch.cat([z0, torch.zeros_like(z0)], 0)
    return Xp, Yp, Z, ok | ~lmask


# ---------------------------------------------------------------------------
# Aggregate: sweep + combine (:726), affine standard form (:1418)
# ---------------------------------------------------------------------------


def sweep_combine(X, Y, Z, digits, T: int, Wv: int):
    """Windowed Lagrange sweep over the T·Vp partials, then the T lane
    blocks of the (8, W4) layout added pairwise in the reference's order."""
    pX, pY, pZ = CP.scalar_mul_windowed(X, Y, Z, digits, 2)
    Vp = Wv * SUB

    def part(c, j):
        return c.view(2, LIMBS, SUB, T, Wv)[:, :, :, j, :].reshape(2, LIMBS, Vp)

    parts = [(part(pX, j), part(pY, j), part(pZ, j)) for j in range(T)]
    while len(parts) > 1:
        nxt = [CP.pt_add(*parts[k], *parts[k + 1], 2) for k in range(0, len(parts) - 1, 2)]
        if len(parts) % 2:
            nxt.append(parts[-1])
        parts = nxt
    return parts[0]


def g2_affine_std(X, Y, Z):
    """Jacobian G2 plane -> (standard-form affine x (2, 12, n), sign, inf):
    1/z = conj(z)/|z|² with one p−2 power scan over the norm; independent
    operations share a level."""
    z0, z1 = Z[0:1], Z[1:2]
    norm, nz1 = CP.addsub_level([("add", *CP.mul_level([(z0, z0), (z1, z1)], 1)),
                                 ("neg", None, z1)], 1)
    ninv = CP.pow_scan(norm, _EXP["inv"])
    zi = torch.empty_like(Z)
    CP.mul_level([(z0, ninv), (nz1, ninv)], 1, [zi[0:1], zi[1:2]])
    zi2 = CP.fe_mul(zi, zi, 2)
    zi3, xa = CP.mul_level([(zi2, zi), (X, zi2)], 2)
    ya = CP.fe_mul(Y, zi3, 2)
    xs, ys = to_std(xa, ya)
    inf = _all(Z == 0)
    y0s, y1s = ys[0:1], ys[1:2]
    y1nz = ~_all(y1s == 0)
    sign = torch.where(y1nz, gt_half_std(y1s), gt_half_std(y0s))
    return xs, sign, inf


def stamp_flags(buf: np.ndarray, sign_np: np.ndarray, inf_np: np.ndarray, V: int) -> list[bytes]:
    """ETH flag byte over a (V, nbytes) buffer, sliced into per-lane bytes:
    0x80 | sign << 5 OR'd into byte 0, infinity rows set to 0xc0 0…"""
    sign_np = np.asarray(sign_np).reshape(-1)[:V].astype(bool)
    inf_np = np.asarray(inf_np).reshape(-1)[:V].astype(bool)
    nbytes = buf.shape[1]
    buf[:, 0] |= np.where(sign_np, np.uint8(0xA0), np.uint8(0x80))
    if inf_np.any():
        inf_row = np.zeros(nbytes, np.uint8)
        inf_row[0] = 0xC0
        buf[inf_np] = inf_row
    blob = buf.tobytes()
    return [blob[i * nbytes:(i + 1) * nbytes] for i in range(V)]


def g2_emit_bytes(x_np: np.ndarray, sign_np: np.ndarray, inf_np: np.ndarray,
                  V: int) -> list[bytes]:
    """Standard-form affine x (2, 12, n) + sign/infinity -> compressed 96-byte
    strings (c1 || c0)."""
    x0 = F.fp_limbs_to_be(np.ascontiguousarray(x_np[0].T[:V]))
    x1 = F.fp_limbs_to_be(np.ascontiguousarray(x_np[1].T[:V]))
    return stamp_flags(np.concatenate([x1, x0], axis=1), sign_np, inf_np, V)


# ---------------------------------------------------------------------------
# pk plane: G1 subgroup check (:687) and the digest-keyed cache
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=1)
def g1_endo_consts():
    """(beta, sign) with phi(P) = (beta·x, y) == [sign·u²]P on G1."""
    g1 = g1_generator()
    aff = to_affine(FqOps, g1)
    for g in (2, 3, 5, 7):
        beta = pow(g, (PF.P - 1) // 3, PF.P)
        if beta == 1:
            continue
        phi = to_jacobian(FqOps, (aff[0] * beta % PF.P, aff[1]))
        for sign in (1, -1):
            tgt = jac_mul(FqOps, g1, (sign * PF.X_ABS * PF.X_ABS) % PF.R)
            if to_affine(FqOps, phi) == to_affine(FqOps, tgt):
                return beta, sign
    raise RuntimeError("no beta/sign works for the G1 endomorphism")


def jac_eq_mask(p, q, E: int, x1_by=None, y1_by=None) -> torch.Tensor:
    """(n,) bool: per-element Jacobian equality (∞ == ∞, ∞ != finite), in
    three levels of products. With x1_by (y1_by), p's X (Y) is X1·x1_by
    (Y1·y1_by), its product in the first level."""
    (X1, Y1, Z1), (X2, Y2, Z2) = p, q
    scaled = [(c, by) for c, by in ((X1, x1_by), (Y1, y1_by)) if by is not None]
    first = CP.mul_level([(Z1, Z1), (Z2, Z2)] + scaled, E)
    z1z1, z2z2 = first[:2]
    rest = iter(first[2:])
    X1 = next(rest) if x1_by is not None else X1
    Y1 = next(rest) if y1_by is not None else Y1
    lx, rx, z1c, z2c = CP.mul_level([(X1, z2z2), (X2, z1z1), (z1z1, Z1), (z2z2, Z2)], E)
    ly, ry = CP.mul_level([(Y1, z2c), (Y2, z1c)], E)
    eq = _all((lx == rx) & (ly == ry))
    inf1 = _all(Z1 == 0)
    inf2 = _all(Z2 == 0)
    return torch.where(inf1 | inf2, inf1 & inf2, eq)


def g1_subgroup_mask(X, Y, Z) -> torch.Tensor:
    """(n,) bool on the planes' device: phi(P) == [s·u²]P per element (∞
    and padding lanes pass), with [u²]P by the shared-scalar double-and-add
    and phi(P)'s product in the comparison's first level."""
    beta, sign = g1_endo_consts()
    uX, uY, uZ = CP.shared_mul(X, Y, Z, PF.X_ABS * PF.X_ABS, 1)
    if sign < 0:
        uY = CP.fe_neg(uY, 1)
    beta_plane = const_plane((beta,), 1, X.shape[-1], X.device)
    return jac_eq_mask((X, Y, Z), (uX, uY, uZ), 1, x1_by=beta_plane)


def g1_subgroup_ok(X, Y, Z) -> bool:
    """True iff every loaded element is in the r-subgroup (∞ passes)."""
    return bool(g1_subgroup_mask(X, Y, Z).all())


# ---------------------------------------------------------------------------
# G2 subgroup check (:599 _psi_consts, :662 _g2_subgroup_core, :706
# _conj_plane): psi(P) == [x]P, x = −X_ABS
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=1)
def psi_consts():
    """(cx, cy) with psi(x, y) = (conj(x)·cx, conj(y)·cy): the
    untwist-Frobenius-twist endomorphism of G2."""
    xi = (1, 1)
    return (PF.fq2_inv(PF.fq2_pow(xi, (PF.P - 1) // 3)),
            PF.fq2_inv(PF.fq2_pow(xi, (PF.P - 1) // 2)))


def g2_subgroup_mask(X, Y, Z) -> torch.Tensor:
    """(n,) bool on the planes' device: psi(P) == [x]P per element, as
    native g2_in_subgroup; ∞ and padding lanes (Z = 0) pass. [u]P by the
    shared-scalar double-and-add (u = X_ABS: 63 doubles, 5 adds), then one
    fe_addsub level of negations: the conjugation's c1 of X, Y and Z, each
    into a copy of the point, and [x]P's Y, since [x]P = −[u]P; psi's two
    products run in the comparison's first level."""
    n = X.shape[-1]
    uX, uY, uZ = CP.shared_mul(X, Y, Z, PF.X_ABS, 2)
    conj = torch.stack([X, Y, Z])          # c0 as it is, c1 negated below
    xY = torch.empty_like(uY)
    CP.addsub_level([("neg", None, X[1:2]), ("neg", None, Y[1:2]), ("neg", None, Z[1:2]),
                     ("neg", None, uY[0:1]), ("neg", None, uY[1:2])], 1,
                    [conj[0, 1:2], conj[1, 1:2], conj[2, 1:2], xY[0:1], xY[1:2]])
    cx, cy = psi_consts()
    return jac_eq_mask((conj[0], conj[1], conj[2]), (uX, xY, uZ), 2,
                       x1_by=const_plane(cx, 2, n, X.device), y1_by=const_plane(cy, 2, n, X.device))


def g2_subgroup_ok(X, Y, Z) -> bool:
    """True iff every loaded element is in the r-subgroup (∞ passes)."""
    return bool(g2_subgroup_mask(X, Y, Z).all())


def g1_plane(pks: list[bytes], Bp: int, device):
    """Compressed pubkeys -> (X, Y, Z) G1 plane of Bp elements; raises the
    reference's ValueErrors (infinity rejected, off-curve at index k)."""
    body, _fin, sgn, loaded = parse_compressed(pks, 48, "G1", True, Bp)
    X, Y, Z, ok = g1_decompress(raw_to_plane(body, Bp, device),
                                torch.as_tensor(sgn, device=device),
                                torch.as_tensor(loaded, device=device))
    okm = ok.cpu().numpy()
    if not okm.all():
        raise_bad(okm, "G1")
    return X, Y, Z


class PkPlaneCache:
    """Decoded, subgroup-checked pk planes keyed by the full pubkey set's
    digest, the span of the set a plane holds, the bucket and the device:
    the counterpart of the reference's PlaneStore
    (charon_tpu/ops/plane_store.py:134-190). `get` is the whole set's plane
    (the fused slot), `chunk_planes` one plane per span (the chunked
    verify), so a fixed peer set decodes once a process. A true LRU of
    MAX_ENTRIES planes: a hit refreshes its entry; on overflow the oldest
    entry whose digest is not pinned goes, and when every entry is pinned
    the cache grows rather than drop a pin. `pin` / `unpin` act on the
    set's digest, so its planes of every span, bucket and device are
    protected. Raises ValueError, and caches nothing of the call, on an
    invalid, infinity or out-of-subgroup pubkey. `hits`, `misses` and
    `evictions` count lookups and drops."""

    MAX_ENTRIES = 64

    def __init__(self):
        self._entries: OrderedDict = OrderedDict()      # oldest first
        self._pinned: set[bytes] = set()
        self._lock = threading.Lock()
        self.hits = self.misses = self.evictions = 0

    @staticmethod
    def digest(pks) -> bytes:
        h = hashlib.sha256()
        for p in pks:
            h.update(bytes(p))
        return h.digest()

    def pin(self, pks) -> None:
        """Keep this set's planes through any cache pressure."""
        if pks:
            with self._lock:
                self._pinned.add(self.digest(pks))

    def unpin(self, pks) -> None:
        with self._lock:
            self._pinned.discard(self.digest(pks))

    def get(self, pks: list[bytes], Bp: int, device):
        """The whole set's plane at bucket Bp."""
        return self.chunk_planes(pks, [(0, len(pks))], [Bp], device)[0]

    def chunk_planes(self, pks: list[bytes], chunks, buckets, device) -> list:
        """One (X, Y, Z) plane per span (s, e) of the full set `pks`, at the
        span's bucket: decoded and subgroup-checked on a miss (every missing
        span first, then all are cached), refreshed on a hit."""
        dg = self.digest(pks)
        keys = [(dg, s, e, Bc, str(device)) for (s, e), Bc in zip(chunks, buckets)]
        out: list = [None] * len(keys)
        with self._lock:
            for i, key in enumerate(keys):
                plane = self._entries.get(key)
                if plane is None:
                    self.misses += 1
                else:
                    self._entries.move_to_end(key)
                    self.hits += 1
                    out[i] = plane
        missing = [i for i, plane in enumerate(out) if plane is None]
        for i in missing:
            (s, e), Bc = chunks[i], buckets[i]
            plane = g1_plane([bytes(p) for p in pks[s:e]], Bc, device)
            if not g1_subgroup_ok(*plane):
                raise ValueError("G1 pubkey not in subgroup")
            out[i] = plane
        with self._lock:
            for i in missing:
                self._entries[keys[i]] = out[i]
                while len(self._entries) > self.MAX_ENTRIES:
                    victim = next((k for k in self._entries if k[0] not in self._pinned), None)
                    if victim is None:
                        break
                    del self._entries[victim]
                    self.evictions += 1
        return out

    def stats(self) -> dict[str, int]:
        with self._lock:
            return {"hits": self.hits, "misses": self.misses, "evictions": self.evictions,
                    "entries": len(self._entries), "pinned_sets": len(self._pinned)}


# ---------------------------------------------------------------------------
# RLC MSM (:1974) and groups (:2027, :2041)
# ---------------------------------------------------------------------------


def group_index(msgs):
    """First-seen distinct messages -> (gidx, G, keys), G padded up to a
    power of two with empty groups (keys padded with b"")."""
    gidx: dict[bytes, int] = {}
    for m in msgs:
        gidx.setdefault(bytes(m), len(gidx))
    G = 1
    while G < len(gidx):
        G *= 2
    return gidx, G, list(gidx) + [b""] * (G - len(gidx))


def group_ids(msgs, Bp: int, index=None):
    """(keys, (Bp,) int32 ids): element i's id is its message's group,
    padding elements' −1. `index`, group_index over a longer message list,
    makes id g mean the same message in every chunk of it."""
    gidx, _G, keys = index if index is not None else group_index(msgs)
    gid = np.full(Bp, -1, np.int32)
    gid[:len(msgs)] = [gidx[bytes(m)] for m in msgs]
    return keys, gid


def msm_group_ids(gid: np.ndarray) -> np.ndarray:
    """The combined MSM's (2·Bp,) group ids: its signature lanes group 0,
    message group g's pk lanes 1 + g, padding −1."""
    live = gid >= 0
    return np.concatenate([np.where(live, 0, -1), np.where(live, gid + 1, -1)]).astype(np.int32)


def combined_msm(SX, SY, SZ, pkX, pkY, pkZ, rdig, mgid, G: int):
    """Sig-G2 MSM and pk-G1 MSM through ONE windowed sweep: G1 embedded in
    Fq2 with zero c1 and placed after the sig elements; then ONE
    pt_reduce_groups<2> call over the sweep's output with the ids `mgid`
    (msm_group_ids, on the device). Returns the sums as three (2, 12, 1 + G)
    planes: S = Σ rᵢ·sigᵢ at 0, message group g's embedded Σ rᵢ·pkᵢ at 1 + g."""
    pk2 = [torch.cat([c, torch.zeros_like(c)], 0) for c in (pkX, pkY, pkZ)]
    CX = torch.cat([SX, pk2[0]], -1)
    CY = torch.cat([SY, pk2[1]], -1)
    CZ = torch.cat([SZ, pk2[2]], -1)
    cdig = torch.cat([rdig, rdig], -1)
    return CP.reduce_groups(*CP.scalar_mul_windowed(CX, CY, CZ, cdig, 2), mgid, 1 + G, 2)


def msm_points(sums) -> tuple:
    """combined_msm's sums on the host: (S, [P_g ...]), S a G2 Jacobian and
    each P_g a G1 one."""
    pts = CP.host_points(*sums)
    return pts[0], [unembed_g1(p) for p in pts[1:]]


def unembed_g1(jac2):
    """Fq2-embedded G1 Jacobian (host ints) -> G1 Jacobian."""
    (x0, x1), (y0, y1), (z0, z1) = jac2
    if x1 or y1 or z1:
        raise RuntimeError("embedded G1 left the base field")
    return (x0, y0, z0)


# ---------------------------------------------------------------------------
# Verify: the dual-form H(m) cache (:2089-2222), the device pairing check
# (:2225) and the two rungs of the finish (:2265, :2289)
# ---------------------------------------------------------------------------

VERIFY_PATHS = ("device", "native")
_path_lock = threading.Lock()      # pairing_path counts from several threads


class H2CCache:
    """Bounded LRU of H(m) keyed by the message bytes, each entry dual-form:
    [96-byte compressed, (hx, hy) affine Montgomery rows (2, 12) | None].
    The compressed form feeds the native rung; the rows feed the device
    pairing. `get` (bytes) fills a miss through native ct_hash_to_g2 and
    stores no rows; `planes` fills misses through the device hash-to-G2, in
    one batch, and upgrades a bytes-only entry in place by decompressing
    its bytes on the host. A cap <= 0 disables the cache. `hits` and
    `misses` count lookups (the reference's ops_hash_to_g2_cache_total)."""

    CAP = 4096    # policy.h2c_cache_cap_default

    def __init__(self, cap: int = CAP):
        self.cap = cap
        self._entries: OrderedDict = OrderedDict()
        self._lock = threading.Lock()
        self.hits = self.misses = 0

    def set_cap(self, cap: int) -> int:
        """Set the bound (evicting down if needed); returns the previous."""
        with self._lock:
            prev, self.cap = self.cap, cap
            while len(self._entries) > max(cap, 0):
                self._entries.popitem(last=False)
        return prev

    def entry(self, m: bytes):
        with self._lock:
            return self._entries.get(bytes(m))

    def _store(self, key: bytes, comp: bytes, planes) -> None:
        with self._lock:
            if self.cap <= 0:
                return
            entry = self._entries.get(key)
            if entry is None:
                self._entries[key] = [comp, planes]
            elif planes is not None and entry[1] is None:
                entry[1] = planes
            self._entries.move_to_end(key)
            while len(self._entries) > self.cap:
                self._entries.popitem(last=False)

    def get(self, m: bytes) -> bytes:
        """Compressed H(m); native ct_hash_to_g2 on a miss."""
        key = bytes(m)
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                self._entries.move_to_end(key)
                self.hits += 1
                return entry[0]
            self.misses += 1
        out = native.hash_to_g2(key)
        self._store(key, out, None)
        return out

    def planes(self, msgs, device):
        """Affine H(m) rows for a message batch on `device`: (hx, hy), each
        (B, 2, 12). Misses run ONE device hash-to-G2 batch and store both
        forms."""
        device = torch.device(device)
        B = len(msgs)
        got: list = [None] * B
        derive, missing = [], []
        with self._lock:
            for i, m in enumerate(msgs):
                key = bytes(m)
                entry = self._entries.get(key)
                if entry is None:
                    missing.append((i, key))
                    continue
                self._entries.move_to_end(key)
                if entry[1] is None:
                    derive.append((i, key, entry[0]))
                else:
                    got[i] = entry[1]
            self.hits += B - len(missing)
            self.misses += len(missing)
        for i, key, comp in derive:
            got[i] = _planes_from_compressed(comp, device)
            self._store(key, comp, got[i])
        if missing:
            hx, hy = h2c_mod.hash_to_g2_device([k for _, k in missing], device)
            ints = F.fq_ints(torch.stack([hx, hy], 1).cpu().numpy())   # x0 x1 y0 y1 per msg
            for j, (i, key) in enumerate(missing):
                got[i] = (hx[j], hy[j])
                x0, x1, y0, y1 = ints[4 * j:4 * j + 4]
                self._store(key, g2_affine_to_bytes(((x0, x1), (y0, y1))), got[i])
        if not B:
            empty = torch.zeros((0, 2, LIMBS), dtype=torch.int32, device=device)
            return empty, empty.clone()
        return (torch.stack([g[0].to(device) for g in got]),
                torch.stack([g[1].to(device) for g in got]))


def _planes_from_compressed(comp: bytes, device):
    """Host decompression of a stored H(m) into affine rows — the upgrade of
    an entry first filled by `get`. The point came from hash-to-curve, so
    no subgroup check."""
    (x0, x1), (y0, y1) = g2_affine_from_bytes(comp)
    rows = torch.as_tensor(F.fq_rows([x0, x1, y0, y1]).reshape(2, 2, LIMBS), device=device)
    return rows[0], rows[1]


def pairing_rows(S, live, h2c: H2CCache, device):
    """The pairs of a slot's check as device rows: H(m) from the cache (one
    device hash-to-G2 batch on the misses) against the live P_m, then the
    signature pair (−g1, S). Returns (p_x, p_y, q_x, q_y): (n, 12) affine
    G1 and (n, 2, 12) affine G2 Montgomery rows, n = len(live) + 1."""
    hx, hy = h2c.planes([m for m, _ in live], device)
    px, py = pairing_mod.g1_rows([to_affine(FqOps, P) for _m, P in live]
                                 + [pairing_mod._G1_NEG], device)
    sx, sy = pairing_mod.g2_rows([to_affine(Fq2Ops, S)], device)
    return px, py, torch.cat([hx, sx]), torch.cat([hy, sy])


def device_pairing_check(S, live, h2c: H2CCache, device) -> bool:
    """The device rung: every pair's Miller loop on its own lane and one
    final exponentiation (pairing.pairing_check_planes)."""
    return pairing_mod.pairing_check_planes(*pairing_rows(S, live, h2c, device))


def native_pairing_check(S, live, h2c: H2CCache) -> bool:
    """The native rung: compressed pairs through native ct_pairing_check."""
    g1_pts = [g1_to_bytes(P) for _m, P in live] + [g1_to_bytes(g1_generator())]
    g2_pts = [h2c.get(m) for m, _P in live] + [g2_to_bytes(S)]
    negs = bytes([0] * len(live) + [1])
    return native.pairing_check(b"".join(g1_pts), b"".join(g2_pts), negs)


def _count_pairs(pairing_path: dict, rung: str, n: int) -> None:
    with _path_lock:
        pairing_path[rung] = pairing_path.get(rung, 0) + n


def pairing_finish(S, group_points, h2c: H2CCache, pairing_path: dict,
                   verify: str = "device", device=None) -> bool:
    """Π e(P_m, H(m)) · e(−g1, S) == 1 on the chosen rung: "device" (the
    default, as in the reference) or "native". An infinity P_m drops its
    pair; an infinity S verifies only when every P_m vanished too.
    `pairing_path` counts pairs per rung (ops_pairing_total{path}). On the
    device rung, while guard.fallback_enabled(), an open plane breaker
    sends the check to the native rung, and a device-class failure of the
    device check re-runs it there (guard.note_verify_fallback), as the
    reference's _pairing_finish; any other error propagates."""
    if verify not in VERIFY_PATHS:
        raise ValueError(f"verify must be one of {VERIFY_PATHS}, got {verify!r}")
    live = [(bytes(m), P) for m, P in group_points if not jac_is_infinity(FqOps, P)]
    if jac_is_infinity(Fq2Ops, S):
        return not live
    if verify == "device":
        guarded = guard.fallback_enabled()
        if not guarded or guard.BREAKER.state != guard.OPEN:
            try:
                ok = device_pairing_check(S, live, h2c, device)
            except Exception as exc:
                reason = guard.device_reason(exc)
                if not guarded or reason is None:
                    raise
                guard.note_verify_fallback(reason, exc)
            else:
                _count_pairs(pairing_path, "device", len(live) + 1)
                return ok
    _count_pairs(pairing_path, "native", len(live) + 1)
    return native_pairing_check(S, live, h2c)


# ---------------------------------------------------------------------------
# The slot
# ---------------------------------------------------------------------------


def load_partials(layout, device):
    sigs_all, scalars_all, V, Vp, T, Wv = layout
    n = Vp * T
    body, _fin, sgn, loaded = parse_compressed(sigs_all, 96, "G2", False, n)
    X0r = raw_to_plane(body[:, 48:], n, device)
    X1r = raw_to_plane(body[:, :48], n, device)
    ldig = torch.as_tensor(CP.scalars_to_digitplanes(scalars_all, n), device=device)
    return (X0r, X1r, torch.as_tensor(sgn, device=device),
            torch.as_tensor(loaded, device=device), ldig)


def aggregate(layout, device) -> list[bytes]:
    """Aggregates only (threshold_aggregate_batch's device path, and the
    bad_pk slot): decompress and raise on an invalid partial before the
    sweep, as the reference's plane loader does, then sweep and emit."""
    _s, _l, V, _Vp, T, Wv = layout
    X0r, X1r, sgn, lmask, ldig = load_partials(layout, device)
    X, Y, Z, ok = g2_decompress(X0r, X1r, sgn, lmask)
    okm = ok.cpu().numpy()
    if not okm.all():
        raise_bad(okm, "G2")
    xs, sign, inf = g2_affine_std(*sweep_combine(X, Y, Z, ldig, T, Wv))
    return g2_emit_bytes(xs.cpu().numpy(), sign.cpu().numpy(), inf.cpu().numpy(), V)


def fused_slot(layout, pks, msgs, device, pk_cache: PkPlaneCache, randomizers=None,
               mark=None):
    """Host parse + the slot's stream-ordered launches. Returns the pending
    state for `readback`: ("pending", V, group_msgs, outs) with outs =
    (ok, xs, sign, inf, sums) on the device, or ("bad_pk",
    layout) when the pubkey set is invalid. `randomizers` (V nonzero
    64-bit values) replaces the CSPRNG draw, for tests only. `mark`, when
    given, is called with each step's name once the step's work is issued
    (a per-step breakdown of this sequence)."""
    mark = mark or (lambda _name: None)
    faults.check("sigagg.pack")
    sigs_all, scalars_all, V, Vp, T, Wv = layout
    X0r, X1r, sgn, lmask, ldig = load_partials(layout, device)
    mark("parse + partial upload (host)")
    try:
        pkX, pkY, pkZ = pk_cache.get(pks, Vp, device)
    except ValueError:
        return ("bad_pk", layout)
    mark("pk plane (cache, or G1 decompression + subgroup check)")
    r = sample_randomizers(V) if randomizers is None else np.asarray(randomizers, np.uint64)
    rdig = torch.as_tensor(CP.scalars_to_digitplanes(r, Vp, nbits=RLC_BITS), device=device)
    group_msgs, gid = group_ids(msgs, Vp)
    mgid = torch.as_tensor(msm_group_ids(gid), device=device)
    mark("randomizer digits + group ids (host)")
    X, Y, Z, ok = g2_decompress(X0r, X1r, sgn, lmask)
    mark("G2 decompression")
    RX, RY, RZ = sweep_combine(X, Y, Z, ldig, T, Wv)
    mark("Lagrange sweep + combine")
    xs, sign, inf = g2_affine_std(RX, RY, RZ)
    mark("affine standard form")
    sums = combined_msm(RX, RY, RZ, pkX, pkY, pkZ, rdig, mgid, len(group_msgs))
    mark("combined RLC MSM + reduction trees")
    return ("pending", V, group_msgs, (ok, xs, sign, inf, sums))


def readback(state):
    """Wait for the slot's device work (a fence on the stream it ran on) and
    bring its outputs to the host."""
    faults.check("sigagg.execute")
    if state[0] == "bad_pk":
        return state
    _tag, V, group_msgs, (ok, xs, sign, inf, sums) = state
    if ok.is_cuda:
        torch.cuda.current_stream(ok.device).synchronize()
    faults.check("sigagg.readback")
    host = (ok.cpu().numpy(), xs.cpu().numpy(), sign.cpu().numpy(), inf.cpu().numpy(),
            tuple(c.cpu() for c in sums))
    return ("host", V, group_msgs, host)


def host_emit(hstate, device):
    """Validity check, byte emission and the RLC sums read back. Returns
    (aggregates, S, group_points) for `pairing_finish`; a bad pubkey set
    still yields the aggregates, with S and group_points None (verdict
    False)."""
    faults.check("sigagg.finish")
    if hstate[0] == "bad_pk":
        return aggregate(hstate[1], device), None, None
    _tag, V, group_msgs, host = hstate
    if not host[0].all():
        raise_bad(host[0], "G2")
    _ok, xs, sign, inf, sums = host
    out = g2_emit_bytes(xs, sign, inf, V)
    S, P = msm_points(sums)
    return out, S, list(zip(group_msgs, P))


class SlotTimes:
    """Seconds of the last slot's phases: dispatch (host parse + launches),
    readback, emit (bytes + the sums read back), verify (the pairing check on
    whichever rung ran) and native (the native rung, when the slot landed
    there: the phases before it keep the time they took, the ones it
    skipped are 0)."""

    def __init__(self):
        self.dispatch = self.readback = self.emit = self.verify = self.native = 0.0


def dispatch_slot(batches, pks, msgs, device, pk_cache: PkPlaneCache):
    """The guarded dispatch (the reference's _dispatch_slot): ("native_slot",)
    when the plane breaker is open, with no device work;
    ("dispatch_failed", exc) when the host parse or a launch failed
    device-class; else fused_slot's state. Other errors raise (releasing
    the breaker's probe, if this slot was it), and so does every error
    outside guard.fallback_enabled()."""
    if not guard.fallback_enabled():
        return fused_slot(layout_slots(batches), pks, msgs, device, pk_cache)
    if not guard.allow_device_dispatch():
        return ("native_slot",)
    try:
        return fused_slot(layout_slots(batches), pks, msgs, device, pk_cache)
    except Exception as exc:
        if not guard.is_device_error(exc):
            guard.BREAKER.release_probe()
            raise
        return ("dispatch_failed", exc)


def threshold_aggregate_and_verify(batches, pks, msgs, device, pk_cache: PkPlaneCache,
                                   h2c: H2CCache, pairing_path: dict,
                                   times: SlotTimes | None = None, verify: str = "device"):
    """The fused sigagg slot end to end: (compressed aggregates, all_valid),
    verified on the `verify` rung ("device" or "native"), through the guard
    (dispatch_slot, guard.finish_slot)."""
    if not batches:
        return [], True
    if not (len(batches) == len(pks) == len(msgs)):
        raise ValueError("length mismatch")
    times = SlotTimes() if times is None else times
    times.dispatch = times.readback = times.emit = times.verify = times.native = 0.0
    t0 = time.perf_counter()
    state = dispatch_slot(batches, pks, msgs, device, pk_cache)
    times.dispatch = time.perf_counter() - t0
    on_device = []

    def finish(state):
        t1 = time.perf_counter()
        hstate = readback(state)
        t2 = time.perf_counter()
        times.readback = t2 - t1
        out, S, pts = host_emit(hstate, device)
        t3 = time.perf_counter()
        times.emit = t3 - t2
        ok = S is not None and pairing_finish(S, pts, h2c, pairing_path, verify, device)
        times.verify = time.perf_counter() - t3
        on_device.append(True)
        return out, ok

    t1 = time.perf_counter()
    out = guard.finish_slot(state, (batches, pks, msgs), finish)
    if not on_device:
        times.native = time.perf_counter() - t1 - times.readback - times.emit - times.verify
    return out


# ---------------------------------------------------------------------------
# The bulk verify of compressed (pk, msg, sig) triples: rlc_verify_batch
# (:1825), rlc_verify_dispatch (:1870), rlc_verify_finish (:1912) and the
# per-chunk verify slot (_verify_slot_jit :2018)
# ---------------------------------------------------------------------------

VERIFY_CHUNK = CP.TILE      # triples a chunk: 1,024, the reference's TILE


def verify_chunks(n: int) -> list[tuple[int, int]]:
    """The chunks' spans (s, e) of n triples."""
    return [(s, min(s + VERIFY_CHUNK, n)) for s in range(0, n, VERIFY_CHUNK)]


def verify_slot(X0r, X1r, sgn, lmask, rdig, pk, mgid, G: int):
    """One chunk's launches: G2 decompression of its signatures, their
    subgroup check, and the combined sig + pk RLC MSM with its group sums.
    Returns (ok, sub_ok, sums) on the device: the decompression's per-lane
    validity, the subgroup verdict (one bool) and combined_msm's sums."""
    X, Y, Z, ok = g2_decompress(X0r, X1r, sgn, lmask)
    sub_ok = g2_subgroup_mask(X, Y, Z).all()
    return ok, sub_ok, combined_msm(X, Y, Z, *pk, rdig, mgid, G)


def rlc_verify_dispatch(pks, msgs, sigs, device, pk_cache: PkPlaneCache, randomizers=None,
                        mark=None):
    """Host parse and every chunk's launches, in chunks of VERIFY_CHUNK
    triples, each at its own bucket (pad_batch) and with the message
    groups of the whole list. Returns the pending state for
    `rlc_verify_finish`: ("pending", group messages, one verify_slot
    output per chunk), or ("invalid",) when a pubkey does not decode, is
    infinity or lies outside the subgroup, or a signature's encoding is
    bad or infinity. `randomizers` (n nonzero values below 2^64) replaces
    the CSPRNG draw, for tests only. `mark`, when given, is called with
    "pk planes" once the pubkey planes are ready and with "chunk k" once
    chunk k's launches are issued."""
    mark = mark or (lambda _name: None)
    n = len(msgs)
    chunks = verify_chunks(n)
    buckets = [CP.pad_batch(e - s) for s, e in chunks]
    index = group_index(msgs)
    r = sample_randomizers(n) if randomizers is None else np.asarray(randomizers, np.uint64)
    try:
        pk_planes = pk_cache.chunk_planes(pks, chunks, buckets, device)
    except ValueError:
        return ("invalid",)
    mark("pk planes")
    pending = []
    for k, ((s, e), Bc, pk) in enumerate(zip(chunks, buckets, pk_planes)):
        try:
            body, _fin, sgn, loaded = parse_compressed(sigs[s:e], 96, "G2", True, Bc)
        except ValueError:
            return ("invalid",)
        rdig = torch.as_tensor(CP.scalars_to_digitplanes(r[s:e], Bc, nbits=RLC_BITS), device=device)
        _keys, gid = group_ids(msgs[s:e], Bc, index)
        pending.append(verify_slot(
            raw_to_plane(body[:, 48:], Bc, device), raw_to_plane(body[:, :48], Bc, device),
            torch.as_tensor(sgn, device=device), torch.as_tensor(loaded, device=device), rdig,
            pk, torch.as_tensor(msm_group_ids(gid), device=device), index[1]))
        mark(f"chunk {k + 1}")
    return ("pending", index[2], pending)


def rlc_fold(state):
    """Read the chunks back and combine their RLC sums: (S, [(m, P_m)]) with
    S = Σ rᵢ·sigᵢ and P_m = Σ rᵢ·pkᵢ over message m's triples, by Jacobian
    adds of the chunks' summed points (1 + G a chunk); None when the state
    is invalid, a signature did not decompress or one lies outside the
    subgroup."""
    if state[0] == "invalid":
        return None
    _tag, group_msgs, pending = state
    S, Pg = None, [None] * len(group_msgs)
    for ok, sub_ok, sums in pending:
        if not (bool(ok.all()) and bool(sub_ok)):
            return None
        sc, pcs = msm_points(sums)
        S = sc if S is None else jac_add(Fq2Ops, S, sc)
        Pg = [pc if P is None else jac_add(FqOps, P, pc) for P, pc in zip(Pg, pcs)]
    return S, list(zip(group_msgs, Pg))


def rlc_verify_finish(state, h2c: H2CCache, pairing_path: dict, verify: str = "device",
                      device=None) -> bool:
    """Fold the dispatched chunks and run the multi-pairing on the `verify`
    rung (pairing_finish: the device rung's check lands natively on a
    device-class failure while guard.fallback_enabled())."""
    folded = rlc_fold(state)
    return folded is not None and pairing_finish(*folded, h2c, pairing_path, verify, device)


def rlc_verify_batch(pks, msgs, sigs, device, pk_cache: PkPlaneCache, h2c: H2CCache,
                     pairing_path: dict, verify: str = "device", randomizers=None) -> bool:
    """Batch-verify compressed (pk, msg, sig) triples: one verdict for all,
    sound to 2^-64 over the randomizers. n = 0 is True and a length
    mismatch raises ValueError; a bad encoding, an infinity, an off-curve
    or out-of-subgroup signature or pubkey gives False. One path for every
    n: the chunked device slot, then the pairing on the chosen rung."""
    n = len(msgs)
    if n == 0:
        return True
    if not (len(pks) == len(sigs) == n):
        raise ValueError("length mismatch")
    state = rlc_verify_dispatch(pks, msgs, sigs, device, pk_cache, randomizers)
    return rlc_verify_finish(state, h2c, pairing_path, verify, device)


# ---------------------------------------------------------------------------
# Per-triple verdicts (the attribution after a failed batch): verify_each,
# the reference's verify_batch_device (charon_tpu/ops/pairing.py:233) on
# compressed triples
# ---------------------------------------------------------------------------


def parse_lanes(items, size: int, Bp: int):
    """Host parse of compressed points lane by lane, raising nothing: (body,
    sign, usable), body the (n, size) bytes with the flag bits cleared
    (zeros in a lane that is not usable), sign and usable flat (Bp,)
    arrays. A lane is usable when it is `size` bytes that parse_compressed
    would take as a finite point (flag_fields: the compression bit, no
    infinity bit, x < p); every other lane is not, and is not loaded."""
    raw = [bytes(x) for x in items]
    n = len(raw)
    fit = np.array([len(r) == size for r in raw], bool)
    data = np.zeros((n, size), np.uint8)
    if fit.any():
        data[fit] = np.frombuffer(b"".join(r for r, f in zip(raw, fit) if f),
                                  np.uint8).reshape(-1, size)
    body, comp, inf, sgn, in_field = flag_fields(data)
    ok = fit & comp & ~inf & in_field
    body[~ok] = 0
    sign = np.zeros(Bp, np.int32)
    sign[:n] = np.where(ok, sgn, 0)
    usable = np.zeros(Bp, bool)
    usable[:n] = ok
    return body, sign, usable


def g1_lanes(pks, Bp: int, device):
    """Compressed pubkeys -> ((X, Y, Z) G1 plane of Bp elements, (Bp,) bool
    on the device): per lane, whether it decoded to a point of the subgroup
    other than infinity. Raises nothing."""
    body, sgn, usable = parse_lanes(pks, 48, Bp)
    lmask = torch.as_tensor(usable, device=device)
    X, Y, Z, ok = g1_decompress(raw_to_plane(body, Bp, device), torch.as_tensor(sgn, device=device),
                                lmask)
    return (X, Y, Z), ok & lmask & g1_subgroup_mask(X, Y, Z)


def verify_each(pks, msgs, sigs, device, pk_cache: PkPlaneCache, h2c: H2CCache) -> np.ndarray:
    """Per-triple verdicts of compressed (pk, msg, sig) triples as an (n,)
    bool array, each native ct_verify's: e(pk, H(m))·e(−G1, sig) == 1 on
    the triple's own lane of one device pairing (pairing.verify_triples),
    whose host work is one pairing's whatever n. In verify_chunks' spans:
    the pubkeys through the cache's chunk planes (the spans and buckets of
    rlc_verify_batch, so after a failed batch they are hits), or, when the
    cache rejects the set, decoded lane by lane (g1_lanes); the signatures'
    G2 decompression and subgroup check lane by lane. The decompressed
    points are affine (Z = 1), so their coordinates are the pairing's rows.
    H(m) from the cache, one device hash-to-G2 batch on its misses. A lane
    whose pubkey or signature is a bad encoding, infinity, off the curve or
    outside the subgroup is False, and its neighbours keep their verdicts.
    n = 0 gives an empty array; a length mismatch raises ValueError."""
    n = len(msgs)
    if not (len(pks) == len(sigs) == n):
        raise ValueError("length mismatch")
    if n == 0:
        return np.zeros(0, bool)
    device = torch.device(device)
    chunks = verify_chunks(n)
    bks = [CP.pad_batch(e - s) for s, e in chunks]
    try:
        pk_planes = [(p, None) for p in pk_cache.chunk_planes(pks, chunks, bks, device)]
    except ValueError:
        pk_planes = [g1_lanes(pks[s:e], Bc, device) for (s, e), Bc in zip(chunks, bks)]
    rows, oks = [], []
    for (s, e), Bc, ((pX, pY, _pZ), pk_ok) in zip(chunks, bks, pk_planes):
        body, sgn, usable = parse_lanes(sigs[s:e], 96, Bc)
        lmask = torch.as_tensor(usable, device=device)
        X, Y, Z, dec = g2_decompress(raw_to_plane(body[:, 48:], Bc, device),
                                     raw_to_plane(body[:, :48], Bc, device),
                                     torch.as_tensor(sgn, device=device), lmask)
        ok = dec & lmask & g2_subgroup_mask(X, Y, Z)
        m = e - s
        oks.append((ok if pk_ok is None else ok & pk_ok)[:m])
        rows.append((pX[0, :, :m].T, pY[0, :, :m].T, X[..., :m].permute(2, 0, 1),
                     Y[..., :m].permute(2, 0, 1)))
    pk_x, pk_y, s_x, s_y = (torch.cat([r[i] for r in rows]).contiguous() for i in range(4))
    distinct = {m: g for g, m in enumerate(dict.fromkeys(bytes(m) for m in msgs))}
    hx, hy = h2c.planes(list(distinct), device)
    idx = torch.as_tensor([distinct[bytes(m)] for m in msgs], device=device)
    ok = pairing_mod.verify_triples(pk_x, pk_y, hx[idx], hy[idx], s_x, s_y)
    return (ok & torch.cat(oks)).cpu().numpy()


# ---------------------------------------------------------------------------
# The FROST ceremony's G1 programs: the batched fixed-base keygen
# (g1_mul_gen_batch :1494 over _g1_fixedbase_jit :1489, _g1_affine_std_jit
# :1443, _g1_emit_bytes :1464, _gen_plane :1475), the grouped share-verify
# MSM (g1_groups_msm :1702 in chunks of _groups_msm_chunk :1760) and the
# generic lincomb check (g1_lincomb_is_infinity :1795 over msm_sum)
# ---------------------------------------------------------------------------


def g1_affine_std(X, Y, Z):
    """Jacobian G1 plane -> (standard-form affine x (1, 12, n), sign, inf):
    1/z by one p−2 power scan (a Z = 0 lane gives 0^(p−2) = 0, masked by
    inf), then one level each for zi², zi³, (x, y) and the standard form."""
    zi = CP.pow_scan(Z, _EXP["inv"])
    zi2 = CP.fe_mul(zi, zi, 1)
    zi3 = CP.fe_mul(zi2, zi, 1)
    xa, ya = CP.mul_level([(X, zi2), (Y, zi3)], 1)
    xs, ys = to_std(xa, ya)
    return xs, gt_half_std(ys), _all(Z == 0)


def g1_emit_bytes(x_np: np.ndarray, sign_np: np.ndarray, inf_np: np.ndarray,
                  V: int) -> list[bytes]:
    """Standard-form affine x (1, 12, n) + sign/infinity -> the first V
    compressed 48-byte strings."""
    buf = F.fp_limbs_to_be(np.ascontiguousarray(x_np[0].T[:V]))
    return stamp_flags(buf, sign_np, inf_np, V)


def gen_plane(Bp: int, device):
    """The G1 generator in every lane of a Bp-lane (X, Y, Z) Montgomery
    plane: the keygen's fixed base, cached per bucket and device (the
    constant planes' cache)."""
    ax, ay = to_affine(FqOps, g1_generator())
    return tuple(const_plane((v,), 1, Bp, device) for v in (ax, ay, 1))


def g1_mul_gen_batch(scalars: list[int], device) -> list[bytes]:
    """kᵢ·G compressed for a batch of scalars (mod r), the ceremony's
    round-1 commitments and PoK nonces: one pt_mul_windowed<1> launch at 64
    windows over the generator plane, the affine standard form, and the
    emit of the first n lanes (padding lanes carry the generator with digit
    0). Byte-identical to native ct_pubkey of each scalar."""
    n = len(scalars)
    if n == 0:
        return []
    device = torch.device(device)
    Bp = CP.pad_batch(n)
    digits = torch.as_tensor(CP.scalars_to_digitplanes([s % PF.R for s in scalars], Bp),
                             device=device)
    xs, sign, inf = g1_affine_std(*CP.scalar_mul_windowed(*gen_plane(Bp, device), digits, 1))
    return g1_emit_bytes(xs.cpu().numpy(), sign.cpu().numpy(), inf.cpu().numpy(), n)


def groups_msm_chunk(points, scalars, groups, n_groups: int, s: int, e: int, device,
                     nbits: int = RLC_BITS):
    """Parse and launch one chunk [s, e) of a grouped G1 MSM at its bucket:
    G1 decompression with ∞ rejected (a ValueError here), the subgroup check,
    one pt_mul_windowed<1> sweep on nbits-bit digits and one reduce_groups
    over the global group ids (padding in none). Returns (ok, sub_ok, sums)
    on the device: the decoding and subgroup verdicts (one bool each) and
    the chunk's n_groups partial sums as (1, 12, n_groups) planes."""
    nc = e - s
    Bc = CP.pad_batch(nc)
    body, _fin, sgn, loaded = parse_compressed([bytes(p) for p in points[s:e]], 48, "G1", True, Bc)
    digits = torch.as_tensor(CP.scalars_to_digitplanes(scalars[s:e], Bc, nbits=nbits),
                             device=device)
    gid = np.full(Bc, -1, np.int32)
    gid[:nc] = groups[s:e]
    X, Y, Z, ok = g1_decompress(raw_to_plane(body, Bc, device), torch.as_tensor(sgn, device=device),
                                torch.as_tensor(loaded, device=device))
    sub = g1_subgroup_mask(X, Y, Z)
    sums = CP.reduce_groups(*CP.scalar_mul_windowed(X, Y, Z, digits, 1),
                            torch.as_tensor(gid, device=device), n_groups)
    return ok.all(), sub.all(), sums


def _grouped_msm(points, scalars, groups, n_groups: int, nbits: int, device) -> list:
    """Chunks of CP.TILE points, each groups_msm_chunk, all launched before
    any is read back; then the device branch's ValueErrors and the chunks'
    partial sums added on the host."""
    if any(not 0 <= g < n_groups for g in groups):
        raise ValueError("group id out of range")
    device = torch.device(device)
    n = len(points)
    pending = [groups_msm_chunk(points, scalars, groups, n_groups, s, min(s + CP.TILE, n), device,
                                nbits) for s in range(0, n, CP.TILE)]
    sums: list = [None] * n_groups
    for ok, sub_ok, red in pending:
        if not bool(ok):
            raise ValueError("invalid G1 point encoding")
        if not bool(sub_ok):
            raise ValueError("G1 point not in subgroup")
        for g, part in enumerate(CP.host_points(*red)):
            sums[g] = part if sums[g] is None else jac_add(FqOps, sums[g], part)
    return [jac_infinity(FqOps) if p is None else p for p in sums]


def g1_groups_msm(points: list[bytes], scalars: list[int], groups: list[int], n_groups: int,
                  device) -> list:
    """Per-group G1 MSMs with RLC_BITS-bit scalars: [Σ_{i: groups[i] = g}
    kᵢ·Pᵢ for g < n_groups] as host Jacobians. One path for every n: chunks
    of CP.TILE points (groups_msm_chunk), partial sums added on the host.
    Raises ValueError on a bad encoding, ∞ ("infinity G1 point rejected"),
    an off-curve point ("invalid G1 point encoding") or one outside the
    subgroup ("G1 point not in subgroup": an order-3 component survives a
    64-bit RLC with probability ~1/3, so the check is not optional)."""
    if not (len(points) == len(scalars) == len(groups)):
        raise ValueError("length mismatch")
    return _grouped_msm(points, scalars, groups, n_groups, RLC_BITS, device)


def g1_lincomb_is_infinity(points: list[bytes], scalars: list[int], device) -> bool:
    """Σ kᵢ·Pᵢ == ∞ with per-point 256-bit scalars (mod r): the same chunked
    load (∞ rejected, subgroup checked), a 64-window pt_mul_windowed<1> and
    reduce_groups with one group; n = 0 is True. Raises g1_groups_msm's
    ValueErrors."""
    n = len(points)
    if n == 0:
        return True
    if len(scalars) != n:
        raise ValueError("length mismatch")
    S = _grouped_msm(points, [s % PF.R for s in scalars], [0] * n, 1, 256, device)[0]
    return jac_is_infinity(FqOps, S)
