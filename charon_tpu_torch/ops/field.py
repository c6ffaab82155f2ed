"""Fq / Fq2 limb layout, Montgomery constants, and the plain field ops.

Layout. A batch of field elements is an int32 tensor `(E, 12, n)`: E in
{1, 2} extension components, 12 little-endian limbs of 32 bits (stored as
int32 holding the uint32 bit pattern), limb-major so that neighbouring CUDA
threads read neighbouring words. Values are canonical in [0, p) and in
Montgomery form with R = 2^384 — the same R as the reference's 32 x 12-bit
limbs (charon_tpu/ops/field.py), so a residue is the same integer in both
packages and converts exactly (ops/convert.py).

Plain versions. `fe_mul_plain` / `fe_add_plain` / `fe_sub_plain` are the
PyTorch counterparts of the CUDA kernels fe_mul / fe_add / fe_sub
(ops/csrc/plane_kernels.cu). They compute bit-identical outputs and are what
the wrappers run on a CPU tensor and what chip_smoke.py holds each kernel
against on the card. int64 cannot hold a 32x32-bit product plus carries, so
the plain versions compute in an exact scheme of their own, built to keep the
number of PyTorch calls small:

* an element is 16 digits of 24 bits in int64 (`(..., 16)`). Inside a plain
  kernel, add, sub and neg are single digit-wise ops and leave values
  unreduced (digits and value may grow, and may go negative);
* a product first shrinks each operand: q = round(v/p) is estimated in
  float64 from the digits (an error of one in q is harmless), v − q·p is
  exact in int64, and two carry folds bring the digits back to 24 bits plus
  a small carry, |v| < 0.51p. Every digit product is then < 2^48.001 and
  every column sum of 16 of them < 2^53, so float64 matrix products are
  exact: the full product is an outer product summed along anti-diagonals
  by a constant 0/1 matrix, m = (T mod R)·(−p⁻¹) mod R and m·p are products
  with constant Toeplitz matrices, and the carry of the low half of T + m·p
  (an exact multiple of R) is the float64-rounded value of that half / R;
* only what a kernel outputs, and what it tests for zero, is made
  canonical: shrink, add p where negative, and propagate carries until
  every digit is in [0, 2^24).
* a plain add or sub of canonical operands needs no digits at all: on int64
  limbs of 32 bits, of v − p, v, v + p (v = a ± b) the first that is not
  negative is the answer (`_rows_sum`).

The rows kernels (ops/rows.py) have plain versions here too:
`rows_mul_plain` is the same digit product entered from `(..., 12)` rows,
`rows_mul2_plain` the Karatsuba Fq2 product over it and the rows add and
sub, `rows_add_plain` / `rows_sub_plain` the same sum as fe_add / fe_sub,
and `rows_addsub_plain` both at once, split along the first axis (all three
are fe_add_rows). `pow_plain` is the fe_pow kernel's power scan over either
layout's plain product.
"""

from __future__ import annotations

import numpy as np
import torch

P_INT = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB

LIMB_BITS = 32
LIMBS = 12                                   # 12 x 32 = 384 bits >= 381
R_MONT = 1 << (LIMB_BITS * LIMBS)            # Montgomery R = 2^384
R_MONT_INV = pow(R_MONT, -1, P_INT)
R2_INT = (R_MONT * R_MONT) % P_INT
# -p^{-1} mod 2^32: the CIOS constant of the CUDA kernels (fp.cuh FP_N0)
N0_INV = (-pow(P_INT, -1, 1 << LIMB_BITS)) % (1 << LIMB_BITS)

_M32 = (1 << 32) - 1


def limbs_from_int(x: int) -> np.ndarray:
    """int in [0, 2^384) -> (12,) int32 limbs (uint32 bit patterns)."""
    if x >> 384:
        raise ValueError("value exceeds 384 bits")
    return np.frombuffer(x.to_bytes(48, "little"), "<u4").astype(np.uint32).view(
        np.int32).copy()


def int_from_limbs(limbs) -> int:
    """(12,) limbs (any integer dtype holding the uint32 pattern) -> int."""
    arr = np.asarray(limbs).astype(np.int64) & _M32
    return int.from_bytes(arr.astype("<u4").tobytes(), "little")


def fq_from_int(x: int) -> np.ndarray:
    """Canonical int -> Montgomery limbs."""
    return limbs_from_int((x % P_INT) * R_MONT % P_INT)


def fq_to_int(limbs) -> int:
    """Montgomery limbs -> canonical int."""
    return int_from_limbs(limbs) * R_MONT_INV % P_INT


def fq2_from_ints(c0: int, c1: int) -> np.ndarray:
    return np.stack([fq_from_int(c0), fq_from_int(c1)])


def fq_rows(values) -> np.ndarray:
    """Canonical ints -> (n, 12) int32 Montgomery rows."""
    blob = b"".join(((v % P_INT) * R_MONT % P_INT).to_bytes(48, "little") for v in values)
    return np.frombuffer(blob, "<u4").astype(np.uint32).view(np.int32).reshape(-1, LIMBS).copy()


def fq_ints(rows) -> list[int]:
    """(..., 12) Montgomery rows -> canonical ints, in row order."""
    blob = np.ascontiguousarray(np.asarray(rows, np.int32).reshape(-1, LIMBS)).tobytes()
    return [int.from_bytes(blob[48 * i:48 * (i + 1)], "little") * R_MONT_INV % P_INT
            for i in range(len(blob) // 48)]


# ---------------------------------------------------------------------------
# Byte loaders (the reference's _fp_limbs_raw / _fp_limbs_to_be, plane_agg.py
# :188 and :1514, on 32-bit limbs).
# ---------------------------------------------------------------------------


def fp_limbs_raw(be: np.ndarray) -> np.ndarray:
    """(N, 48) big-endian Fp byte strings -> (N, 12) int32 RAW limbs
    (standard form, not Montgomery)."""
    le = np.ascontiguousarray(np.asarray(be, np.uint8)[:, ::-1])
    return le.view("<u4").astype(np.uint32).view(np.int32).reshape(len(le), LIMBS)


def fp_limbs_to_be(limbs: np.ndarray) -> np.ndarray:
    """(N, 12) int32 limbs -> (N, 48) uint8 big-endian bytes."""
    le = np.ascontiguousarray(np.asarray(limbs, np.int32)).view(np.uint32).astype("<u4")
    return np.ascontiguousarray(le.view(np.uint8).reshape(len(le), 48)[:, ::-1])


# ---------------------------------------------------------------------------
# Plain versions: exact lazy arithmetic on 24-bit digits (module docstring).
# ---------------------------------------------------------------------------

_M24 = (1 << 24) - 1
_DIG = 16                     # 24-bit digits per element

_consts: dict = {}


def _const(device: torch.device) -> dict:
    """Per-device constants of the plain arithmetic."""
    key = str(device)
    c = _consts.get(key)
    if c is None:
        def digits(x):
            return [(x >> (24 * i)) & _M24 for i in range(_DIG)]

        def toeplitz(vals, ncols):
            m = np.zeros((_DIG, ncols), np.float64)
            for i in range(_DIG):
                for j in range(_DIG):
                    if i + j < ncols:
                        m[i, i + j] = vals[j]
            return m

        anti = np.zeros((_DIG * _DIG, 2 * _DIG), np.float64)
        for i in range(_DIG):
            for j in range(_DIG):
                anti[i * _DIG + j, i + j] = 1.0
        n_prime = (-pow(P_INT, -1, R_MONT)) % R_MONT
        f64 = dict(dtype=torch.float64, device=device)
        c = {
            "anti": torch.tensor(anti, **f64),
            "nprime": torch.tensor(toeplitz(digits(n_prime), _DIG), **f64),
            "p_full": torch.tensor(toeplitz(digits(P_INT), 2 * _DIG), **f64),
            # v ≈ digits @ w_p · p, and the low half of T + m·p over R
            "w_p": torch.tensor([2.0 ** (24 * k) / P_INT for k in range(_DIG)], **f64),
            "w_r": torch.tensor([2.0 ** (24 * k - 384) for k in range(_DIG)], **f64),
            "p": torch.tensor(digits(P_INT), dtype=torch.int64, device=device),
            "p32": torch.tensor([(P_INT >> (32 * i)) & _M32 for i in range(LIMBS)],
                                dtype=torch.int64, device=device),
        }
        _consts[key] = c
    return c


def rows_to_digits(x: torch.Tensor) -> torch.Tensor:
    """(..., 12) int32 limb rows -> (..., 16) int64 canonical 24-bit digits
    (every 3 little-endian bytes are one digit)."""
    b = x.contiguous().view(torch.uint8).reshape(*x.shape[:-1], _DIG, 3).to(torch.int64)
    return b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16)


def digits_to_rows(d: torch.Tensor) -> torch.Tensor:
    """(..., 16) canonical digits -> (..., 12) int32 limb rows."""
    b = (torch.stack([d, d >> 8, d >> 16], -1) & 0xFF).to(torch.uint8)
    return b.reshape(*d.shape[:-1], 3 * _DIG).view(torch.int32)


def to_digits(x: torch.Tensor) -> torch.Tensor:
    """(E, 12, n) int32 limbs -> (E, n, 16) int64 canonical 24-bit digits."""
    return rows_to_digits(x.permute(0, 2, 1))


def from_digits(d: torch.Tensor) -> torch.Tensor:
    """(E, n, 16) canonical digits -> (E, 12, n) int32 limbs."""
    return digits_to_rows(d).permute(0, 2, 1).contiguous()


def _fold(x: torch.Tensor, keep_top: bool = True) -> torch.Tensor:
    """One carry pass: each digit keeps its low 24 bits and takes the carry
    of the digit below. keep_top leaves the top digit's carry in place (the
    value is unchanged); otherwise it is dropped (the value mod R)."""
    hi = x >> 24
    out = x & _M24
    out[..., 1:] += hi[..., :-1]
    if keep_top:
        out[..., -1] += hi[..., -1] << 24
    return out


def _shrink(x: torch.Tensor) -> torch.Tensor:
    """Loose digits -> same residue with |v| < 0.51p and digits within
    [−2^12, 2^24 + 2^12]."""
    k = _const(x.device)
    q = torch.round(x.to(torch.float64) @ k["w_p"]).to(torch.int64)
    return _fold(_fold(x - q.unsqueeze(-1) * k["p"]))


def _normalize(v: torch.Tensor, bits: int = 24) -> torch.Tensor:
    """Propagate carries until every digit but the top is in [0, 2^bits);
    the top digit keeps the overflow and the sign."""
    mask = (1 << bits) - 1
    while True:
        c = v[..., :-1] >> bits
        if not bool(c.any()):
            return v
        v = torch.cat([v[..., :-1] & mask, v[..., -1:]], -1)
        v[..., 1:] += c


def canon(x: torch.Tensor) -> torch.Tensor:
    """Loose digits -> canonical digits of the value mod p."""
    x = _shrink(x)
    v = _normalize(torch.stack([x, x + _const(x.device)["p"]]))
    return torch.where(v[0, ..., -1:] < 0, v[1], v[0])


def mont_mul(a: torch.Tensor, b: torch.Tensor, shrink: bool = True) -> torch.Tensor:
    """Montgomery product a·b·R⁻¹ of same-shape digit tensors (..., 16): the
    same residue as the kernels', left loose (|v| < 1.2p). shrink=False only
    for operands already canonical."""
    k = _const(a.device)
    shape = a.shape
    N = a.numel() // _DIG
    if shrink:
        a, b = _shrink(a), _shrink(b)
    da = a.reshape(N, _DIG).to(torch.float64)
    db = b.reshape(N, _DIG).to(torch.float64)
    # a ⊛ b: the outer product of the digits summed along anti-diagonals
    T = ((da[:, :, None] * db[:, None, :]).reshape(N, _DIG * _DIG) @ k["anti"]).to(torch.int64)
    t_low = _fold(_fold(T[:, :_DIG], False), False)                 # T mod R
    m = _fold(_fold((t_low.to(torch.float64) @ k["nprime"]).to(torch.int64), False), False)
    U = _fold(T) + (m.to(torch.float64) @ k["p_full"]).to(torch.int64)   # ≡ 0 mod R
    carry = torch.round(U[:, :_DIG].to(torch.float64) @ k["w_r"]).to(torch.int64)
    r = U[:, _DIG:].clone()
    r[:, 0] += carry
    return r.reshape(shape)


def is_zero(x: torch.Tensor) -> torch.Tensor:
    """(E, n, 16) canonical -> (n,) bool: every component zero."""
    return (x == 0).all(-1).all(0)


def mul_many(pairs, E: int, shrink: bool = True):
    """Independent products [(a, b), ...] of (E, n, 16) digit tensors through
    ONE mont_mul call. E=2: Karatsuba (3 products), or complex squaring (2
    products) when a is b — the kernels' formulas."""
    if E == 1:
        R = mont_mul(torch.stack([a[0] for a, _ in pairs]),
                     torch.stack([b[0] for _, b in pairs]), shrink)
        return [R[i][None] for i in range(len(pairs))]
    A, B, kinds = [], [], []
    for a, b in pairs:
        if a is b:
            A += [a[0] + a[1], a[0]]
            B += [a[0] - a[1], a[1]]
            kinds.append(2)
        else:
            A += [a[0], a[1], a[0] + a[1]]
            B += [b[0], b[1], b[0] + b[1]]
            kinds.append(3)
    R = mont_mul(torch.stack(A), torch.stack(B), shrink=True)
    outs, pos = [], 0
    for kind in kinds:
        if kind == 2:
            outs.append(torch.stack([R[pos], R[pos + 1] + R[pos + 1]]))
        else:
            v0, v1, t = R[pos], R[pos + 1], R[pos + 2]
            outs.append(torch.stack([v0 - v1, t - v0 - v1]))
        pos += kind
    return outs


def _reduce_once(r: torch.Tensor) -> torch.Tensor:
    """Loose digits of a value in [0, 2p) -> canonical digits."""
    v = _normalize(torch.stack([r, r - _const(r.device)["p"]]))
    return torch.where(v[1, ..., -1:] < 0, v[0], v[1])


_LANE_KEY = torch.tensor(np.random.default_rng(0x5EED).integers(1, 1 << 62, 48) | 1,
                         dtype=torch.int64)


def _distinct_lanes(x: torch.Tensor):
    """(k, 12, n) -> (rep, inv) with x[..., rep][..., inv] == x, rep one lane
    per distinct column; None when every lane is distinct. Columns are
    keyed by a wrapping int64 hash and the result is checked exactly."""
    n = x.shape[-1]
    w = _LANE_KEY[:x.shape[0] * LIMBS].to(x.device).view(x.shape[0], LIMBS, 1)
    keys, inv = torch.unique((x.to(torch.int64) * w).sum((0, 1)), return_inverse=True)
    if keys.numel() == n:
        return None
    rep = torch.full((keys.numel(),), n, dtype=torch.int64, device=x.device)
    rep.scatter_reduce_(0, inv, torch.arange(n, device=x.device), "amin")
    if not bool((x[..., rep[inv]] == x).all()):
        return None
    return rep, inv


def fe_mul_plain(a: torch.Tensor, b: torch.Tensor, E: int) -> torch.Tensor:
    """Plain version of the fe_mul kernel: a·b·R⁻¹ mod p (Fq, or Fq2 by
    Karatsuba) on (E, 12, n) limb tensors. Equal lanes (the padding of a
    plane) are computed once."""
    ab = torch.cat([a, b])
    lanes = _distinct_lanes(ab)
    if lanes is not None:
        rep, inv = lanes
        return fe_mul_plain(ab[:E, :, rep].contiguous(), ab[E:, :, rep].contiguous(), E)[..., inv]
    d = to_digits(ab)
    if E == 1:
        # canonical operands: the product is in [0, 1.3p), one subtraction
        return from_digits(_reduce_once(mont_mul(d[0], d[1], shrink=False))[None])
    return from_digits(canon(mul_many([(d[:2], d[2:])], E)[0]))


def _rows_sum(a: torch.Tensor, b: torch.Tensor, sign: int) -> torch.Tensor:
    """(a ± b) mod p of canonical rows on int64 32-bit limbs: the first of
    v − p, v, v + p that is not negative, v = a ± b."""
    x = torch.stack([a, b]).to(torch.int64) & _M32
    v = x[0] + x[1] if sign > 0 else x[0] - x[1]
    p = _const(v.device)["p32"]
    c = _normalize(torch.stack([v - p, v, v + p]), 32)
    neg = c[..., -1:] < 0
    r = torch.where(neg[0], torch.where(neg[1], c[2], c[1]), c[0])
    return torch.where(r >= 1 << 31, r - (1 << 32), r).to(torch.int32)


def fe_add_plain(a: torch.Tensor, b: torch.Tensor, E: int) -> torch.Tensor:
    """Plain version of the fe_add kernel: (a + b) mod p per component, for
    canonical a, b (the kernel's contract)."""
    return _rows_sum(a.transpose(1, 2), b.transpose(1, 2), 1).transpose(1, 2).contiguous()


def fe_sub_plain(a: torch.Tensor, b: torch.Tensor, E: int) -> torch.Tensor:
    """Plain version of the fe_sub kernel: (a − b) mod p per component, for
    canonical a, b."""
    return _rows_sum(a.transpose(1, 2), b.transpose(1, 2), -1).transpose(1, 2).contiguous()


# Plain versions of the rows kernels (ops/rows.py): the same digit
# arithmetic as fe_*_plain (E = 1), entered from (..., 12) rows directly.


def rows_mul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of fe_mul_rows: a·b·R⁻¹ mod p per canonical row."""
    d = rows_to_digits(torch.stack([a, b]))
    return digits_to_rows(_reduce_once(mont_mul(d[0], d[1], shrink=False)))


def rows_mul2_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of fe_mul_rows for E = 2: the Karatsuba product of
    canonical Fq2 rows (..., 2, 12), (a0b0 − a1b1, (a0+a1)(b0+b1) − a0b0 −
    a1b1), through the plain rows product, add and sub."""
    s = rows_add_plain(torch.stack([a[..., 0, :], b[..., 0, :]]),
                       torch.stack([a[..., 1, :], b[..., 1, :]]))
    v = rows_mul_plain(torch.stack([a[..., 0, :], a[..., 1, :], s[0]]),
                       torch.stack([b[..., 0, :], b[..., 1, :], s[1]]))
    d = rows_sub_plain(torch.stack([v[0], v[2]]), torch.stack([v[1], v[0]]))  # c0, s − v0
    return torch.stack([d[0], rows_sub_plain(d[1], v[1])], -2)


def rows_addsub_plain(a: torch.Tensor, b: torch.Tensor, n_add: int) -> torch.Tensor:
    """Plain version of fe_add_rows with a split: (a + b) mod p for
    a[:n_add], (a − b) mod p for a[n_add:], canonical rows."""
    parts = [_rows_sum(a[:n_add], b[:n_add], 1) if n_add > 0 else None,
             _rows_sum(a[n_add:], b[n_add:], -1) if n_add < a.shape[0] else None]
    return torch.cat([p for p in parts if p is not None])


def rows_add_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of fe_add_rows: (a + b) mod p per canonical row."""
    return _rows_sum(a, b, 1)


def rows_sub_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of fe_add_rows with n_add = 0: (a − b) mod p per
    canonical row."""
    return _rows_sum(a, b, -1)


# ---------------------------------------------------------------------------
# The lane-split Montgomery product of fp.cuh (fq_mul_split), modelled on
# Python ints word for word: the kernels' arithmetic, off the card.
# ---------------------------------------------------------------------------


def _lookahead(gen: list, prop: list) -> int:
    """Carries of a group of lanes from their generate and propagate bits
    (as __ballot_sync gives them): bit l of the result is the carry into
    lane l, bit T the carry out of the group. A = G | P and B = G are two
    numbers whose bitwise sum carries exactly where the lanes do."""
    G = sum(g << lane for lane, g in enumerate(gen))
    GP = G | sum(p << lane for lane, p in enumerate(prop))
    return (GP + G) ^ GP ^ G


def mont_mul_split(a, b, T: int, bounds: list | None = None, reduce: bool = True) -> list:
    """a·b·R⁻¹ mod p on 12 canonical 32-bit limbs, as fq_mul_split runs it
    on a group of T lanes (T divides 12), each lane l holding L = 12/T limbs
    (Ll .. Ll + L − 1) of b and of the running value w, and a carry word c
    of its own at limb Ll + L. Step i of the 12 (a_i the same on every lane):
      1. w += a_i·b on each lane, a row of L 64-bit multiply-adds whose
         carry out goes into c;
      2. m = w_0·(−p⁻¹) mod 2^32 on lane 0, shuffled to the group;
      3. w += m·p likewise (now lane 0's w_0 is 0);
      4. the shift: each lane's w_0 moves down to the lane below (__shfl,
         lane T−1 gets 0), w moves down a limb, and c, now at w's top limb,
         is added to it: the top limb keeps the low word, c the rest.
    No carry crosses lanes inside a step. At the end the carries resolve
    once: lane l adds lane l−1's c, then the carry each lane passes up
    comes from a lookahead over the group's generate (carry out) and
    propagate (all ones) bits; one subtraction of p, its borrows from the
    same lookahead (each lane's bits for either carry in, chosen once the
    carries are known: one round of ballots), is kept unless the group
    borrows out. Every step's
    carry words are appended to `bounds`, as ("row", c) after its rows (c <
    2^34: a u64 on the card) and ("shift", c) after its shift (c ≤ 3).
    reduce=False stops after the carries (fq_mul_split<T, false>, which
    fe_pow runs between its first and last product): the result is below 2p,
    and inputs below 2p are as good as canonical ones (4p < R keeps CIOS's
    value below 3p inside a product and 2p after it)."""
    if 12 % T:
        raise ValueError("T must divide 12")
    L = 12 // T
    p = [(P_INT >> (32 * i)) & _M32 for i in range(LIMBS)]
    sl = [[b[L * lane + j] & _M32 for j in range(L)] for lane in range(T)]
    pl = [p[L * lane:L * lane + L] for lane in range(T)]
    w = [[0] * L for _ in range(T)]
    c = [0] * T

    def row(x, ys, lane):
        carry = 0
        for j in range(L):
            s = x * ys[j] + w[lane][j] + carry
            w[lane][j], carry = s & _M32, s >> 32
        c[lane] += carry

    for i in range(LIMBS):
        ai = a[i] & _M32
        for lane in range(T):
            row(ai, sl[lane], lane)
        m = (w[0][0] * N0_INV) & _M32
        for lane in range(T):
            row(m, pl[lane], lane)
        if bounds is not None:
            bounds.extend(("row", v) for v in c)
        assert w[0][0] == 0
        down = [w[lane + 1][0] if lane + 1 < T else 0 for lane in range(T)]
        for lane in range(T):
            s = c[lane] + down[lane]
            w[lane] = w[lane][1:] + [s & _M32]
            c[lane] = s >> 32
        if bounds is not None:
            bounds.extend(("shift", v) for v in c)
    # resolve the carries in one round: lane l adds lane l−1's carry word
    # (s, its carry out, all ones?); with k, the carry that then reaches it,
    # its words s + k borrow against p's limbs or equal them, for k = 0 as
    # d = s − p says, for k = 1 where s + 1 < p (all ones wraps to 0) and
    # where d is all ones and borrows
    full = (1 << (32 * L)) - 1
    pv = [sum(v << (32 * j) for j, v in enumerate(pl[lane])) for lane in range(T)]
    sv, gen, ones, borrow, zero, dones = [], [], [], [], [], []
    for lane in range(T):
        v = sum(x << (32 * j) for j, x in enumerate(w[lane])) + (c[lane - 1] if lane else 0)
        sv.append(v & full)
        gen.append(v >> (32 * L))
        ones.append(int(v & full == full))
        d = (v & full) - pv[lane]
        borrow.append(int(d < 0))
        zero.append(int(d == 0))
        dones.append(int(d % (1 << (32 * L)) == full))
    carries = _lookahead(gen, ones)
    assert c[T - 1] == 0 and not carries >> T
    k = [carries >> lane & 1 for lane in range(T)]
    if not reduce:
        out = [(sv[lane] + k[lane]) % (full + 1) for lane in range(T)]
        return [(out[i // L] >> (32 * (i % L))) & _M32 for i in range(LIMBS)]
    borrows = _lookahead(
        [int(ones[i] or (borrow[i] and not dones[i])) if k[i] else borrow[i] for i in range(T)],
        [int(not ones[i] and borrow[i] and dones[i]) if k[i] else zero[i] for i in range(T)])
    keep = borrows >> T & 1
    out = [(sv[lane] + k[lane] - (0 if keep else pv[lane] + (borrows >> lane & 1))) % (full + 1)
           for lane in range(T)]
    return [(out[i // L] >> (32 * (i % L))) & _M32 for i in range(LIMBS)]


def pow_plain(a: torch.Tensor, digits, mul) -> torch.Tensor:
    """Plain version of the fe_pow kernel: a^e over a plain product `mul` of
    canonical elements (planes' or rows'), e given as MSB-first 4-bit window
    digits with digits[0] != 0. The kernel's schedule: the table a^1..a^15
    (a^k = a^(k−1)·a), then from entry digits[0], per further digit four
    squarings and, where the digit is not 0, one table product. Every value
    is canonical, so any schedule gives these limbs."""
    tab = [None, a]
    for _ in range(2, 16):
        tab.append(mul(tab[-1], a))
    acc = tab[digits[0]]
    for d in digits[1:]:
        for _ in range(4):
            acc = mul(acc, acc)
        if d:
            acc = mul(acc, tab[d])
    return acc
