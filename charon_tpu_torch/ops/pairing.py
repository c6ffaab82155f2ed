"""Batched optimal-ate multi-pairing check on rows: Miller loop, Fq12 tree
fold and one final exponentiation (the port's charon_tpu/ops/pairing.py).

The reference's design and formulas, kept so that step outputs compare
exactly with the JAX package: the Miller loop runs on the M-twist with
homogeneous projective T (no inversions) and sparse line values scaled by
ξ·2y'·Z³ (doubling) or ξ·λ·Z (addition), which the final exponentiation
kills; the hard part uses the Ghammam–Fouotsa chain for
m^(3·(p⁴−p²+1)/r), a multiple coprime to r, so `final_exp(f) == 1` is the
exact check.

What differs is how the loops run. The reference scans 63 uniform steps and
computes every addition step, selecting by the bit; here the bits of |x|
are host constants, so Python branches on them: 63 doubling steps and 5
addition steps, and `_expt_conj` multiplies only on set bits. The values
are the same. Every product goes through the rows seam (ops/rows.py), so
on the card the whole check runs on fe_mul_rows (Fq2 products in one
launch each), fe_add_rows (split: a level's independent adds, ξ products
and subs in one launch; n_add = 0 a subtraction) and fe_pow (the final
exponentiation's Fq inversion).

A check runs every pair's Miller loop on its own batch lane (padded to a
power of two with masked repeats of lane 0), tree-folds the lanes into one
Fq12 product and runs a single final exponentiation. Beyond MAX_PAIR_TILE
pairs it runs chunk by chunk and folds the per-chunk products before the
one final exponentiation; pairing multiplicativity makes the verdict the
same as one monolithic check. `verify_triples` checks triples each on its
own lane instead: no fold, a final exponentiation a lane.
"""

from __future__ import annotations

import torch

from ..crypto import curve as PC
from ..crypto import fields as PF
from . import buckets
from . import field as F
from . import rows as R
from . import tower as T

X_ABS = PF.X_ABS
_X_BITS = bin(X_ABS)[3:]  # MSB implied; 63 steps, 5 additions

# Lane ceiling of one Miller-loop chunk (the reference's plane TILE).
MAX_PAIR_TILE = 1024

# −G1 generator (host constant).
_G1_NEG = (PC.g1_generator()[0], PF.fq_neg(PC.g1_generator()[1]))


def _scale_fq_many(xs, ss):
    """[x · s for Fq2 x, Fq s]: one product launch."""
    x = R.stack(list(xs))
    s = R.stack(list(ss))[..., None, :]
    return list(R._mont_mul(x, s).unbind(0))


def _dbl_step(f, Tp, xp, yp):
    """Doubling step: line through T, T evaluated at P; T <- 2T. The
    reference's values, with fewer dependent levels of sums: 2S is formed
    beside 2X², so that 8S³ = (2S)²·2S and 4Y²S² = (2YS)² come from the
    products."""
    X, Y, Z = Tp
    XX, S, XY = R._fq2_mul_many([(X, X), (Y, Z), (X, Y)])
    XX2, S2 = T._add_many([XX, S], [XX, S])
    W = R.fq2_add(XX2, XX)                        # 3X²
    SZ, XW, WZ, B_, WW, S2S2, YS = R._fq2_mul_many(
        [(S, Z), (X, W), (W, Z), (XY, S), (W, W), (S2, S2), (Y, S)])
    SZ2, YS2, B2 = T._add_many([SZ, YS, B_], [SZ, YS, B_])
    # line: l = 2YZ²·ξ·yp + (3X³ − 2Y²Z)·vw − 3X²Z·xp·v²w
    a0s, av2ws = _scale_fq_many([SZ2, WZ], [yp, xp])
    (B4,), (a0,), (avw, av2w) = T._level(adds=[(B2, B2)], xis=[a0s],
                                         subs=[(XW, YS2), (torch.zeros_like(av2ws), av2ws)])
    # point update (homogeneous doubling, a = 0): H = W² − 8B and
    # B4 − H = 8B − (W² − 4B)
    (B8,), _, (T1,) = T._level(adds=[(B4, B4)], subs=[(WW, B4)])
    H, G = T._sub_many([T1, B8], [B4, T1])
    HS, WBH, y4, Z3 = R._fq2_mul_many([(H, S), (W, G), (YS2, YS2), (S2S2, S2)])
    X3, y8 = T._add_many([HS, y4], [HS, y4])      # 2HS, 8Y²S²; Z3 = 8S³
    f, (Y3,) = T.mul_sparse_sub(f, a0, avw, av2w, [(WBH, y8)])
    return f, (X3, Y3, Z3)


def _add_step(f, Tp, xq, yq, xp, yp):
    """Mixed addition step: line through T and Q at P; T <- T + Q."""
    X, Y, Z = Tp
    yqZ, xqZ = R._fq2_mul_many([(yq, Z), (xq, Z)])
    (XxqZ,), _, (theta, lam) = T._level(adds=[(X, xqZ)], subs=[(Y, yqZ), (X, xqZ)])
    ll, thth, th_xq, lam_yq = R._fq2_mul_many(
        [(lam, lam), (theta, theta), (theta, xq), (lam, yq)])
    # line: l = λ·ξ·yp + (θ·xq − λ·yq)·vw − θ·xp·v²w
    a0s, av2ws = _scale_fq_many([lam, theta], [yp, xp])
    _, (a0,), (avw, av2w) = T._level(xis=[a0s], subs=[(th_xq, lam_yq),
                                                      (torch.zeros_like(av2ws), av2ws)])
    lll, thZ, llA, llX = R._fq2_mul_many(
        [(ll, lam), (thth, Z), (ll, XxqZ), (ll, X)])
    D = R.fq2_sub(thZ, llA)
    X3, thT, Ylll, Z3 = R._fq2_mul_many(
        [(lam, D), (theta, R.fq2_sub(llX, D)), (Y, lll), (lll, Z)])
    f, (Y3,) = T.mul_sparse_sub(f, a0, avw, av2w, [(thT, Ylll)])
    return f, (X3, Y3, Z3)


def _select_fq12(mask, a, b):
    def sel(x, y):
        return torch.where(mask[..., None, None], x, y)
    return (tuple(sel(x, y) for x, y in zip(a[0], b[0])),
            tuple(sel(x, y) for x, y in zip(a[1], b[1])))


def _one2_like(x):
    return T.fq12_one_like(x)[0][0]


def miller_loop_pairs(g1_points, g2_points):
    """Product of Miller loops over pair groups sharing one accumulator:
    f = Π_j f_{|x|,Q_j}(P_j), conjugated at the end (x < 0).

    g1_points: list of (xp, yp) Fq rows (batch, 12).
    g2_points: list of (xq, yq) Fq2 rows (batch, 2, 12) on the twist.
    """
    f = T.fq12_one_like(g2_points[0][0])
    Ts = [(xq, yq, _one2_like(xq)) for (xq, yq) in g2_points]
    for bit in _X_BITS:
        f = T.fq12_sqr(f)
        for j, (xp, yp) in enumerate(g1_points):
            f, Ts[j] = _dbl_step(f, Ts[j], xp, yp)
        if bit == "1":
            for j, ((xp, yp), (xq, yq)) in enumerate(zip(g1_points, g2_points)):
                f, Ts[j] = _add_step(f, Ts[j], xq, yq, xp, yp)
    return T.fq12_conj(f)


def _expt_conj(m):
    """m^u for the (negative) BLS parameter u: conj(m^|u|), valid in the
    cyclotomic subgroup (after the easy part). Square-and-multiply over the
    host bits of |u|: the leading 1 gives m, then 63 squarings and 5
    products."""
    acc = m
    for bit in bin(X_ABS)[3:]:
        acc = T.fq12_sqr(acc)
        if bit == "1":
            acc = T.fq12_mul(acc, m)
    return T.fq12_conj(acc)


def final_exp_is_one(f):
    """final_exponentiation(f) == 1 per batch lane, computed as
    f^(3·(p¹²−1)/r) == 1 (gcd(3, r) = 1)."""
    # easy part: f^(p⁶−1)(p²+1)
    f1 = T.fq12_mul(T.fq12_conj(f), T.fq12_inv(f))
    m = T.fq12_mul(T.fq12_frobenius(f1, 2), f1)
    # hard part ×3 (Ghammam–Fouotsa chain)
    t0 = T.fq12_sqr(m)
    t1 = _expt_conj(m)
    t2 = T.fq12_conj(m)
    t1 = T.fq12_mul(t1, t2)
    t2 = _expt_conj(t1)
    t1 = T.fq12_conj(t1)
    t1 = T.fq12_mul(t1, t2)
    t2 = _expt_conj(t1)
    t1 = T.fq12_frobenius(t1, 1)
    t1 = T.fq12_mul(t1, t2)
    res = T.fq12_mul(m, t0)
    t0 = _expt_conj(t1)
    t2 = _expt_conj(t0)
    t0 = T.fq12_frobenius(t1, 2)
    t1 = T.fq12_conj(t1)
    t1 = T.fq12_mul(t1, t2)
    t1 = T.fq12_mul(t1, t0)
    res = T.fq12_mul(res, t1)
    return T.fq12_is_one(res)


# ---------------------------------------------------------------------------
# Per-triple verification (the reference's _compiled_verify :213 and
# verify_batch_device :233)
# ---------------------------------------------------------------------------

# Triples a Miller-loop chunk of verify_triples: one call's host work is one
# pairing's launches whatever its width, so only a batch past this many
# triples (a few MB of Fq12 rows a chunk) runs in more than one
MAX_EACH_TILE = 8192


def _bucket_triples(n: int) -> int:
    return buckets.pow2_bucket(n, floor=8)


def verify_triples(pk_x, pk_y, h_x, h_y, s_x, s_y) -> torch.Tensor:
    """e(pk, H(m))·e(−G1, sig) == 1 for each triple on its own lane: pk_*
    are (n, 12) affine G1 rows, h_* and s_* (n, 2, 12) affine G2 twist rows
    of H(m) and the signature, all on one device, n >= 1. Both pairs of a triple
    share its Miller loop's accumulator (miller_loop_pairs over the pair
    groups (pk, H(m)) and (−G1, sig)), with no fold across lanes, then one
    final exponentiation per lane, batched. Pads to the power-of-two bucket
    (floor 8) with repeats of lane 0, whose verdicts are dropped. Returns
    the (n,) bool verdicts on the device."""
    n = pk_x.shape[0]
    outs = []
    for lo, hi in buckets.chunk_spans(n, MAX_EACH_TILE):
        m = hi - lo
        Bp = _bucket_triples(m)
        px, py, hx, hy, sx, sy = (buckets.pad_lane0(a[lo:hi], Bp, m)
                                  for a in (pk_x, pk_y, h_x, h_y, s_x, s_y))
        gx, gy = (row.expand(Bp, F.LIMBS).contiguous() for row in g1_rows([_G1_NEG], px.device))
        f = miller_loop_pairs([(px, py), (gx, gy)], [(hx, hy), (sx, sy)])
        outs.append(final_exp_is_one(f)[:m])
    return torch.cat(outs)


# ---------------------------------------------------------------------------
# The multi-pairing check
# ---------------------------------------------------------------------------


def _fq12_slice(f, a: int, b: int):
    return (tuple(c[a:b] for c in f[0]), tuple(c[a:b] for c in f[1]))


def _fq12_fold_product(f, batch: int):
    """Pairwise tree product over a power-of-two batch axis -> batch 1."""
    while batch > 1:
        half = batch // 2
        f = T.fq12_mul(_fq12_slice(f, 0, half), _fq12_slice(f, half, batch))
        batch = half
    return f


def _bucket_pairs(n: int) -> int:
    return buckets.pow2_bucket(n, floor=2)


def miller_fold_chunk(p_x, p_y, q_x, q_y):
    """ONE chunk (≤ MAX_PAIR_TILE pairs): per-lane Miller loops, padding
    lanes masked to Fq12 one, tree-folded to a batch-1 Fq12 product. No
    final exponentiation."""
    m = p_x.shape[0]
    Bp = _bucket_pairs(m)
    mask = buckets.live_mask(m, Bp, p_x.device)
    px, py, qx, qy = (buckets.pad_lane0(a, Bp, m) for a in (p_x, p_y, q_x, q_y))
    f = miller_loop_pairs([(px, py)], [(qx, qy)])
    f = _select_fq12(mask, f, T.fq12_one_like(qx))
    return _fq12_fold_product(f, Bp)


def _fq12_concat(fs):
    return (tuple(torch.cat([f[0][i] for f in fs]) for i in range(3)),
            tuple(torch.cat([f[1][i] for f in fs]) for i in range(3)))


def fold_chunks_is_one(parts) -> bool:
    """Fold per-chunk Fq12 products (batch 1 each) through the pairwise
    tree and run the single final exponentiation."""
    k = len(parts)
    if k == 1:
        return bool(final_exp_is_one(parts[0]).reshape(-1)[0])
    Kp = _bucket_pairs(k)
    f = _fq12_concat(parts)
    f = tuple(tuple(buckets.pad_lane0(c, Kp, k) for c in half) for half in f)
    mask = buckets.live_mask(k, Kp, f[0][0].device)
    f = _select_fq12(mask, f, T.fq12_one_like(f[0][0]))
    return bool(final_exp_is_one(_fq12_fold_product(f, Kp)).reshape(-1)[0])


def _pairing_check_chunked(p_x, p_y, q_x, q_y) -> bool:
    """More than MAX_PAIR_TILE pairs: one Miller + fold per chunk, then one
    cross-chunk fold and final exponentiation."""
    n = p_x.shape[0]
    parts = [miller_fold_chunk(*(a[lo:hi] for a in (p_x, p_y, q_x, q_y)))
             for lo, hi in buckets.chunk_spans(n, MAX_PAIR_TILE)]
    return fold_chunks_is_one(parts)


def pairing_check_planes(p_x, p_y, q_x, q_y) -> bool:
    """Π e(Pᵢ, Qᵢ) == 1 over Montgomery rows: p_* are (n, 12) affine G1
    coordinates, q_* are (n, 2, 12) affine G2 twist coordinates, all on one
    device and none infinity (degenerate pairs are the caller's contract,
    plane_agg.pairing_finish). Pads to the power-of-two bucket with masked
    repeats of lane 0; beyond MAX_PAIR_TILE pairs it runs chunked, with the
    same verdict."""
    n = p_x.shape[0]
    if n == 0:
        return True
    if n > MAX_PAIR_TILE:
        return _pairing_check_chunked(p_x, p_y, q_x, q_y)
    return fold_chunks_is_one([miller_fold_chunk(p_x, p_y, q_x, q_y)])


def g1_rows(points, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Affine G1 ints [(x, y), ...] -> (n, 12) Montgomery rows x, y."""
    xy = F.fq_rows([c for pt in points for c in pt]).reshape(len(points), 2, F.LIMBS)
    t = torch.as_tensor(xy, device=device)
    return t[:, 0].contiguous(), t[:, 1].contiguous()


def g2_rows(points, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Affine G2 ints [((x0, x1), (y0, y1)), ...] -> (n, 2, 12) rows x, y."""
    flat = [c for pt in points for xy in pt for c in xy]
    t = torch.as_tensor(F.fq_rows(flat).reshape(len(points), 2, 2, F.LIMBS), device=device)
    return t[:, 0].contiguous(), t[:, 1].contiguous()
