"""Plain Jacobian point formulas on tensors: the PyTorch counterparts of the
pt_double and pt_add CUDA kernels (ops/csrc/plane_kernels.cu), and of the
two scalar multiplications that chain them in one launch, pt_mul_shared and
pt_mul_windowed (the loops of those steps, in the same order).

Same math and staging as the reference's in-kernel forms
(charon_tpu/ops/pallas_plane.py `_pt_double` :371 and `_pt_add_unified`
:389): dbl-2009-l doubling for a = 0, and the unified add whose results are
resolved by selects in the reference's order — the P+P double, then H=0,
R≠0 -> ∞, then q=∞ -> p, then p=∞ -> q (the last select wins). Every value
a kernel outputs or tests is canonical, so the outputs are exactly the
kernels'. Arithmetic is field.py's lazy digit scheme: products of one stage
go through one plain Montgomery call, and only the outputs and the zero
tests are reduced. The P+P double inside the add is evaluated only when a
lane needs it, and lanes whose inputs are all zero (the ∞ padding of the
planes) are not computed at all: the formulas give zero for their double
and the other operand for their add. Neither changes an output.
"""

from __future__ import annotations

import torch

from . import field as F


def _where(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.where(mask[None, :, None], a, b)


def c_double(p, E: int, canonical_in: bool):
    """dbl-2009-l on (E, n, 16) digit coordinates; loose outputs."""
    X1, Y1, Z1 = p
    A, B, YZ = F.mul_many([(X1, X1), (Y1, Y1), (Y1, Z1)], E, shrink=not canonical_in)
    XB = X1 + B
    C, t = F.mul_many([(B, B), (XB, XB)], E)
    D = t - A - C
    D = D + D
    Ev = A + A + A
    Fv = F.mul_many([(Ev, Ev)], E)[0]
    X3 = Fv - (D + D)
    C8 = C + C
    C8 = C8 + C8
    C8 = C8 + C8
    Y3 = F.mul_many([(Ev, D - X3)], E)[0] - C8
    Z3 = YZ + YZ
    return (X3, Y3, Z3)


def c_add_unified(p, q, E: int):
    """Unified add of canonical (E, n, 16) digit points; canonical outputs."""
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    Z1Z1, Z2Z2, Z1Z2 = F.mul_many([(Z1, Z1), (Z2, Z2), (Z1, Z2)], E, shrink=False)
    U1, U2, Y1Z2, Y2Z1 = F.mul_many([(X1, Z2Z2), (X2, Z1Z1), (Y1, Z2), (Y2, Z1)], E)
    S1, S2 = F.mul_many([(Y1Z2, Z2Z2), (Y2Z1, Z1Z1)], E)
    H, R = F.canon(torch.stack([U2 - U1, S2 - S1]))
    HH, RR = F.mul_many([(H, H), (R, R)], E, shrink=False)
    HHH, V, Z3 = F.mul_many([(H, HH), (U1, HH), (Z1Z2, H)], E)
    X3 = RR - HHH - (V + V)
    RVX, S1H = F.mul_many([(R, V - X3), (S1, HHH)], E)
    Y3 = RVX - S1H

    p_inf = F.is_zero(Z1)
    q_inf = F.is_zero(Z2)
    both = ~(p_inf | q_inf)
    dbl = both & F.is_zero(H) & F.is_zero(R)
    if bool(dbl.any()):
        res = F.canon(torch.stack([X3, Y3, Z3, *c_double(p, E, True)]))
        res = [_where(dbl, d, r) for d, r in zip(res[3:], res[:3])]
    else:
        res = list(F.canon(torch.stack([X3, Y3, Z3])))
    neg = both & F.is_zero(H) & ~F.is_zero(R)
    res = [_where(neg, torch.zeros_like(r), r) for r in res]
    res = [_where(q_inf, a, r) for a, r in zip(p, res)]
    return [_where(p_inf, b, r) for b, r in zip(q, res)]


def _live(coords) -> torch.Tensor:
    """(n,) bool: lanes where any input coordinate is nonzero."""
    return torch.stack([(c != 0).any(0).any(0) for c in coords]).any(0)


def _on_live(fn, coords, n_out: int):
    """Run fn on the lanes with a nonzero input; all-zero lanes output zero
    (fn must map all-zero inputs to all-zero outputs)."""
    live = _live(coords)
    if bool(live.all()):
        return fn(coords)
    out = [torch.zeros_like(coords[0]) for _ in range(n_out)]
    if bool(live.any()):
        idx = live.nonzero().squeeze(1)
        sub = fn([c.index_select(2, idx).contiguous() for c in coords])
        for o, s in zip(out, sub):
            o[:, :, idx] = s
    return tuple(out)


def _double_limbs(coords):
    E = coords[0].shape[0]
    d = F.to_digits(torch.stack(coords).flatten(0, 1).contiguous())
    X, Y, Z = d.reshape(3, E, *d.shape[1:])
    out = F.canon(torch.stack(c_double((X, Y, Z), E, True)))
    lim = F.from_digits(out.flatten(0, 1))
    return tuple(lim.reshape(3, E, *lim.shape[1:]))


def _add_limbs(coords):
    E = coords[0].shape[0]
    d = F.to_digits(torch.stack(coords).flatten(0, 1).contiguous())
    c = d.reshape(6, E, *d.shape[1:])
    out = c_add_unified(tuple(c[:3]), tuple(c[3:]), E)
    lim = F.from_digits(torch.stack(out).flatten(0, 1))
    return tuple(lim.reshape(3, E, *lim.shape[1:]))


def pt_double_plain(X, Y, Z, E: int):
    """Plain version of the pt_double kernel on (E, 12, n) limb tensors."""
    return _on_live(_double_limbs, [X, Y, Z], 3)


def pt_add_plain(X1, Y1, Z1, X2, Y2, Z2, E: int):
    """Plain version of the pt_add kernel on (E, 12, n) limb tensors."""
    coords = [X1, Y1, Z1, X2, Y2, Z2]
    trivial = ~_live(coords[:3]) | ~_live(coords[3:])
    if bool(trivial.any()):
        # an all-zero operand is ∞, so the selects decide: q where p is ∞
        # (Z1 = 0), else p
        rest = ~trivial
        p_inf = (Z1 == 0).all(0).all(0).view(1, 1, -1)
        out = [torch.where(p_inf, b, a) for a, b in zip(coords[:3], coords[3:])]
        if bool(rest.any()):
            idx = rest.nonzero().squeeze(1)
            sub = _add_limbs([c.index_select(2, idx).contiguous() for c in coords])
            for o, s in zip(out, sub):
                o[:, :, idx] = s
        return tuple(out)
    return _add_limbs(coords)


def pt_mul_shared_plain(X, Y, Z, k: int, E: int):
    """Plain version of the pt_mul_shared kernel: k·P (k >= 1) by MSB-first
    double-and-add, a double per bit after the first and an add of P per
    set bit."""
    acc = (X, Y, Z)
    for bit in bin(k)[3:]:
        acc = pt_double_plain(*acc, E)
        if bit == "1":
            acc = pt_add_plain(*acc, X, Y, Z, E)
    return acc


def pt_mul_windowed_plain(X, Y, Z, digits, E: int):
    """Plain version of the pt_mul_windowed kernel: per-element k·P from
    (nwin, n) MSB-first 4-bit digits. The 16-entry table k·P (entry 0 ∞,
    an even entry the double of entry k/2, an odd one entry k−1 plus P),
    then from ∞ per window 4 doubles and one unified add of the entry the
    digit selects (digit 0: ∞, Z = 0)."""
    zero = torch.zeros_like(X)
    tab = [(zero, zero, zero), (X, Y, Z)]
    for k in range(2, 16):
        if k % 2 == 0:
            tab.append(pt_double_plain(*tab[k // 2], E))
        else:
            tab.append(pt_add_plain(*tab[k - 1], X, Y, Z, E))
    T = [torch.stack([t[c] for t in tab]) for c in range(3)]    # (16, E, 12, n)
    n = X.shape[-1]
    idx_all = digits.to(torch.int64)
    acc = (zero, zero, zero)
    for w in range(idx_all.shape[0]):
        for _ in range(4):
            acc = pt_double_plain(*acc, E)
        idx = idx_all[w].view(1, 1, 1, n).expand(1, E, F.LIMBS, n)
        acc = pt_add_plain(*acc, *[t.gather(0, idx)[0] for t in T], E)
    return acc


RED_POINTS = 8      # pt_reduce_groups' accumulators a block (kRedPoints)
RED_SPAN = 64       # lanes a block of its first launch (kRedSpan)


def _reduce_blocks(coords, gid, n: int, G: int, nb: int, span: int, E: int):
    """One launch of the pt_reduce_groups kernel: block k = g·nb + b sums,
    from zeros, accumulator l adding element base + i at step j (i = b·span
    + j·RED_POINTS + l; base 0 with gid, else g·n), zeros where i >= n or
    gid[i] != g; then l += l + h for h = RED_POINTS/2 .. 1. Returns the
    blocks' sums as (E, 12, G·nb) planes."""
    dev = coords[0].device
    K, P = G * nb, RED_POINTS
    k = torch.arange(K, device=dev)
    g, b = (k // nb).view(K, 1), (k % nb).view(K, 1)
    lane = torch.arange(P, device=dev).view(1, P)
    zero = torch.zeros((E, F.LIMBS, K * P), dtype=torch.int32, device=dev)
    acc = (zero, zero, zero)
    for j in range(span // P):
        i = b * span + j * P + lane                                  # (K, P)
        take = i < n
        addr = i.clamp(max=n - 1) + (0 if gid is not None else g * n)
        if gid is not None:
            take = take & (gid[addr] == g)
        addr, take = addr.reshape(-1), take.reshape(-1)
        addend = [torch.where(take.view(1, 1, -1), c.index_select(2, addr), 0) for c in coords]
        acc = pt_add_plain(*acc, *addend, E)
    h = P // 2
    while h >= 1:
        lo = [c.view(E, F.LIMBS, K, P)[..., :h].reshape(E, F.LIMBS, -1) for c in acc]
        hi = [c.view(E, F.LIMBS, K, P)[..., h:2 * h].reshape(E, F.LIMBS, -1) for c in acc]
        acc = pt_add_plain(*lo, *hi, E)
        P, h = h, h // 2
    return acc


def pt_reduce_groups_plain(X, Y, Z, gid, G: int, E: int = 1):
    """Plain version of the pt_reduce_groups kernel on an (E, 12, n) plane
    and (n,) int32 group ids: for each g < G the sum of the points whose id
    is g (an id outside [0, G) is in no group; an empty group is ∞, zeros),
    as three (E, 12, G) planes, in the kernel's order of adds: the partial
    sums of spans of RED_SPAN lanes, then each group's partials."""
    n = X.shape[-1]
    nb = -(-n // RED_SPAN)
    parts = _reduce_blocks([X, Y, Z], gid.to(torch.int64), n, G, nb, RED_SPAN, E)
    span = -(-nb // RED_POINTS) * RED_POINTS
    return tuple(_reduce_blocks(list(parts), None, nb, G, 1, span, E))
