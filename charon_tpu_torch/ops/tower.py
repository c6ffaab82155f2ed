"""Fq6 / Fq12 extension towers on rows (the port's charon_tpu/ops/tower.py).

Same tower as the host oracle: Fq2 = Fq[u]/(u²+1), Fq6 = Fq2[v]/(v³−ξ) with
ξ = 1+u, Fq12 = Fq6[w]/(w²−v). Elements are nested tuples of Fq2 rows
`(..., 2, 12)` (ops/rows.py): Fq6 = (c0, c1, c2), Fq12 = (g, h).

The formulas are the reference's. What differs is only how the work is
issued: every independent Fq2 product of a step is stacked into one
`rows._fq2_mul_many` (one product launch), and the adds and subs around
them are stacked into as few rows launches as their dependencies allow
(`_add_many`, `_sub_many`, and `_level`, whose split launch runs a level's
adds, ξ products and subs at once). Every value is canonical, so the
outputs are the reference's limb for limb, however the sums are grouped.
"""

from __future__ import annotations

import torch

from ..crypto import fields as PF
from . import field as F
from . import rows as R

LIMBS = F.LIMBS

# -- batched Fq2 adds, subs and ξ products ------------------------------------


def _add_many(xs, ys):
    """[x + y for x, y in zip(xs, ys)] in one add launch."""
    k = len(xs)
    t = R.stack(list(xs) + list(ys))
    return list(R.add_rows(t[:k], t[k:]).unbind(0))


def _sub_many(xs, ys):
    """[x − y for x, y in zip(xs, ys)] in one sub launch."""
    k = len(xs)
    t = R.stack(list(xs) + list(ys))
    return list(R.sub_rows(t[:k], t[k:]).unbind(0))


def _neg_many(xs):
    return list(R.fq_neg(R.stack(list(xs))).unbind(0))


_LEVEL_INDEX: dict = {}


def _level_index(na: int, nz: int, ns: int, m: int, device):
    """The gathers of a `_level` of m-lane Fq2 elements, cached per shape:
    (rows of the stacked inputs that form a then b, rows of the launch's
    output in Fq2 order or None, n_add). Input element e's lane i,
    component c is row (e·m + i)·2 + c of the stack [adds' x, subs' x, xis,
    adds' y, subs' y]; the launch adds adds' x + y and z0 + z1 (ξ's c1),
    then subtracts z0 − z1 (ξ's c0) and subs' x − y."""
    key = (na, nz, ns, m, device)
    if key not in _LEVEL_INDEX:
        def rows(e, comps=(0, 1)):
            return [(e * m + i) * 2 + c for i in range(m) for c in comps]

        zs = [na + ns + j for j in range(nz)]
        y0 = na + ns + nz
        z0 = [r for e in zs for r in rows(e, (0,))]
        z1 = [r for e in zs for r in rows(e, (1,))]
        a = [r for e in range(na) for r in rows(e)] + z0 + z0 + \
            [r for e in range(na, na + ns) for r in rows(e)]
        b = [r for e in range(na) for r in rows(y0 + e)] + z1 + z1 + \
            [r for e in range(ns) for r in rows(y0 + na + e)]
        order = None
        if nz:
            c1, c0, n2 = 2 * na * m, (2 * na + nz) * m, (2 * na + 2 * nz) * m
            order = list(range(c1)) + [r for k in range(nz * m) for r in (c0 + k, c1 + k)] + \
                list(range(n2, n2 + 2 * ns * m))
            order = torch.tensor(order, dtype=torch.int64, device=device)
        _LEVEL_INDEX[key] = (torch.tensor(a + b, dtype=torch.int64, device=device), order,
                             2 * na * m + nz * m)
    return _LEVEL_INDEX[key]


def _level(adds=(), xis=(), subs=()):
    """One level of independent Fq2 adds, ξ products and subs in ONE split
    add launch: ([x + y for x, y in adds], [z·ξ for z in xis], [x − y for
    x, y in subs]), z·ξ = (z0 − z1) + (z0 + z1)u. The inputs are stacked
    once and gathered into the launch's rows by cached indices, so a level
    costs the host the same few ops whatever it holds."""
    na, nz, ns = len(adds), len(xis), len(subs)
    W = R.stack([x for x, _ in adds] + [x for x, _ in subs] + list(xis)
                + [y for _, y in adds] + [y for _, y in subs])
    shape = W.shape[1:]
    src, order, n_add = _level_index(na, nz, ns, W[0].numel() // (2 * LIMBS), W.device)
    ab = W.view(-1, LIMBS).index_select(0, src)
    n = ab.shape[0] // 2
    out = R.addsub_rows(ab[:n], ab[n:], n_add)
    if order is not None:
        out = out.index_select(0, order)
    res = out.view(na + nz + ns, *shape).unbind(0)
    return list(res[:na]), list(res[na:na + nz]), list(res[na + nz:])


def _mul_xi_many(xs):
    """[x·ξ for x in xs]: (x0 − x1) + (x0 + x1)u, one split add launch."""
    return _level(xis=xs)[1]


def _conj_many(xs):
    """[conj(x) for x in xs]: one neg launch over the u components."""
    X = R.stack(list(xs))
    return list(torch.stack([X[..., 0, :], R.fq_neg(X[..., 1, :])], -2).unbind(0))


def fq2_mul_xi(a):
    """(a0 + a1·u)(1 + u) = (a0 − a1) + (a0 + a1)u."""
    return _mul_xi_many([a])[0]


def fq2_conj(a):
    return _conj_many([a])[0]


# -- Fq6 ----------------------------------------------------------------------


def fq6_add(a, b):
    return tuple(_add_many(a, b))


def fq6_sub(a, b):
    return tuple(_sub_many(a, b))


def fq6_neg(a):
    return tuple(_neg_many(a))


def fq6_mul_many(pairs):
    """k independent Fq6 Karatsuba products: one add launch for the
    pre-sums, all 6k Fq2 products in one `_fq2_mul_many`, five launches for
    the recombination (reference formulas, tower.py :50)."""
    k = len(pairs)
    L, Rr = [], []
    for a, b in pairs:
        a0, a1, a2 = a
        b0, b1, b2 = b
        L += [a1, b1, a0, b0, a0, b0]
        Rr += [a2, b2, a1, b1, a2, b2]
    S = _add_many(L, Rr)
    ops = []
    for i, (a, b) in enumerate(pairs):
        s = S[6 * i:6 * i + 6]
        ops += [(a[0], b[0]), (a[1], b[1]), (a[2], b[2]),
                (s[0], s[1]), (s[2], s[3]), (s[4], s[5])]
    rs = R._fq2_mul_many(ops)
    t0, t1, t2, s12, s01, s02 = (rs[j::6] for j in range(6))
    u = _sub_many(s12 + s01 + s02, t1 + t0 + t0)
    w = _sub_many(u, t2 + t1 + t2)
    xi = _mul_xi_many(w[:k] + t2)
    c = _add_many(t0 + w[k:2 * k] + w[2 * k:], xi[:k] + xi[k:] + t1)
    # c0 = t0 + ξ(s12 − t1 − t2), c1 = (s01 − t0 − t1) + ξt2,
    # c2 = (s02 − t0 − t2) + t1
    return [(c[i], c[k + i], c[2 * k + i]) for i in range(k)]


def fq6_mul(a, b):
    return fq6_mul_many([(a, b)])[0]


def fq6_sqr(a):
    return fq6_mul(a, a)


def fq6_mul_v(a):
    return (fq2_mul_xi(a[2]), a[0], a[1])


def fq6_inv(a):
    a0, a1, a2 = a
    sq0, m12, sq2, m01, sq1, m02 = R._fq2_mul_many(
        [(a0, a0), (a1, a2), (a2, a2), (a0, a1), (a1, a1), (a0, a2)])
    x12, x22 = _mul_xi_many([m12, sq2])
    c0, c1, c2 = _sub_many([sq0, x22, sq1], [x12, m01, m02])
    p0, p21, p12 = R._fq2_mul_many([(a0, c0), (a2, c1), (a1, c2)])
    t = R.fq2_add(p0, fq2_mul_xi(R.fq2_add(p21, p12)))
    ti = fq2_inv(t)
    return tuple(R._fq2_mul_many([(c0, ti), (c1, ti), (c2, ti)]))


# -- Fq inversion: a^(p−2) ------------------------------------------------------


def fq_inv(a):
    """a^(p−2) (0 for 0), the exponent's zero windows skipped (rows.pow_rows)."""
    return R.pow_rows(a, F.P_INT - 2)


def fq2_inv(a):
    a0, a1 = a[..., 0, :], a[..., 1, :]
    n0, n1 = R._fq_mul_many([(a0, a0), (a1, a1)])
    d = fq_inv(R.fq_add(n0, n1))
    m0, m1 = R._fq_mul_many([(a0, d), (a1, d)])
    return torch.stack([m0, R.fq_neg(m1)], -2)


# -- Fq12 ---------------------------------------------------------------------


def fq12_one_like(x):
    """Fq12 one, broadcast to x's batch shape; x is an Fq2 row (..., 2, 12)."""
    one = torch.as_tensor(F.fq_from_int(1), device=x.device).expand(x[..., 0, :].shape)
    f2_one = torch.stack([one, torch.zeros_like(one)], -2)
    f2_zero = torch.zeros_like(f2_one)
    return ((f2_one, f2_zero, f2_zero), (f2_zero, f2_zero, f2_zero))


def fq12_add(a, b):
    return (fq6_add(a[0], b[0]), fq6_add(a[1], b[1]))


def fq12_mul(a, b):
    a0, a1 = a
    b0, b1 = b
    s = _add_many(list(a0) + list(b0), list(a1) + list(b1))
    # the 3 Karatsuba Fq6 products are independent: one 18-wide Fq2 stack
    t0, t1, st = fq6_mul_many([(a0, b0), (a1, b1), (tuple(s[:3]), tuple(s[3:]))])
    # c0 = t0 + v·t1 = (t0_0 + ξ·t1_2, t0_1 + t1_0, t0_2 + t1_1) and
    # c1 = s − (t0 + t1), in two split launches
    r, (xt,), _ = _level(adds=[(t0[1], t1[0]), (t0[2], t1[1]), (t0[0], t1[0]),
                               (t0[1], t1[1]), (t0[2], t1[2])], xis=[t1[2]])
    (c00,), _, c1 = _level(adds=[(t0[0], xt)], subs=list(zip(st, r[2:])))
    return ((c00, r[0], r[1]), tuple(c1))


def fq12_sqr(a):
    return fq12_mul(a, a)


def fq12_conj(a):
    return (a[0], fq6_neg(a[1]))


def fq12_inv(a):
    a0, a1 = a
    s0, s1 = fq6_mul_many([(a0, a0), (a1, a1)])
    ti = fq6_inv(fq6_sub(s0, fq6_mul_v(s1)))
    m0, m1 = fq6_mul_many([(a0, ti), (a1, ti)])
    return (m0, fq6_neg(m1))


def fq12_mul_sparse(f, a, b, c):
    """f · (a + b·vw + c·v²w) for Fq2 a, b, c — the Miller line shape
    (basis 1, v, v², w, vw, v²w with w² = v, v³ = ξ):
      c0' = a f0 + ξ(b f4 + c f3)      c3' = a f3 + ξ(b f2 + c f1)
      c1' = a f1 + ξ(b f5 + c f4)      c4' = a f4 + b f0 + ξ c f2
      c2' = a f2 + b f3 + ξ c f5       c5' = a f5 + b f1 + c f0
    All 18 Fq2 products in one stack, then three launches of sums."""
    return mul_sparse_sub(f, a, b, c)[0]


def mul_sparse_sub(f, a, b, c, subs=()):
    """(fq12_mul_sparse(f, a, b, c), [x − y for x, y in subs]): the subs,
    of values already computed, ride in the first launch of sums."""
    (f0, f1, f2), (f3, f4, f5) = f
    coeffs = (f0, f1, f2, f3, f4, f5)
    rs = R._fq2_mul_many([(a, x) for x in coeffs] + [(b, x) for x in coeffs]
                         + [(c, x) for x in coeffs])
    af, bf, cf = rs[0:6], rs[6:12], rs[12:18]
    (g0, g1, g3, g5, h2, h4), _, d = _level(
        adds=[(bf[4], cf[3]), (bf[5], cf[4]), (bf[2], cf[1]), (bf[1], cf[0]),
              (af[2], bf[3]), (af[4], bf[0])], subs=subs)
    (o5,), (x0, x1, x3, xc5, xc2), _ = _level(adds=[(af[5], g5)],
                                              xis=[g0, g1, g3, cf[5], cf[2]])
    o = _add_many([af[0], af[1], h2, af[3], h4], [x0, x1, xc5, x3, xc2])
    return ((o[0], o[1], o[2]), (o[3], o[4], o5)), d


# -- Frobenius with host-computed γ constants -----------------------------------


def _host_frob_constants():
    """γ_{n,k} for frobeniusⁿ on basis (1, v, v², w, vw, v²w):
    frobⁿ(Σ c_k e_k) = Σ conjⁿ(c_k)·γ_{n,k}·e_k (the reference's tables)."""
    xi = (1, 1)
    e = (PF.P - 1) // 6
    gamma1 = [PF.fq2_pow(xi, e * k) for k in [0, 2, 4, 1, 3, 5]]
    tables = [gamma1]
    prev = gamma1
    for _ in range(2):  # frob^2, frob^3
        prev = [PF.fq2_mul(PF.fq2_conj(pk), g1k) for pk, g1k in zip(prev, gamma1)]
        tables.append(prev)
    return tables


_FROB_TABLES = _host_frob_constants()


def fq12_frobenius(f, n: int = 1):
    """frobⁿ for n in {1, 2, 3}."""
    if n not in (1, 2, 3):
        raise ValueError("frobenius power must be 1..3")
    (f0, f1, f2), (f3, f4, f5) = f
    coeffs = [f0, f1, f2, f3, f4, f5]
    if n % 2 == 1:
        coeffs = _conj_many(coeffs)
    consts = [torch.as_tensor(F.fq2_from_ints(*g), device=f0.device) for g in _FROB_TABLES[n - 1]]
    out = R._fq2_mul_many(list(zip(coeffs, consts)))
    return ((out[0], out[1], out[2]), (out[3], out[4], out[5]))


def fq12_is_one(f):
    """Canonical equality with 1 (Montgomery one in slot 0), per batch lane."""
    one = fq12_one_like(f[0][0])
    ok = torch.ones(f[0][0].shape[:-2], dtype=torch.bool, device=f[0][0].device)
    for fa, fb in zip(f, one):
        for ca, cb in zip(fa, fb):
            ok = ok & (ca == cb).all(-1).all(-1)
    return ok
