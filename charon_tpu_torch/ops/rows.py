"""The rows field plane: Fq / Fq2 arithmetic on `(..., 12)` int32 rows, and
the seam every product of the tower, the pairing and hash-to-G2 goes
through.

The port's counterpart of the reference's rows plane
(charon_tpu/ops/field.py :92-250 on `(..., 32)` rows of 12-bit limbs) and of
its seam (charon_tpu/ops/curve.py :24-69, `_mont_mul`, `_fq_mul_many`,
`_fq2_mul_many`). A row is one Fq element: 12 little-endian 32-bit limbs,
limb axis last, canonical in [0, p), Montgomery form with R = 2^384 (the
same residues as the reference's rows and the port's planes). An Fq2
element is `(..., 2, 12)`. Leading axes are any batch shape.

Three CUDA kernels (ops/csrc/plane_kernels.cu) compute on rows in place:

    fe_mul_rows   E = 1: a·b·R⁻¹ mod p  (pallas_plane._mont_rows_call :969)
                  E = 2: the whole Karatsuba Fq2 product of (..., 2, 12)
                  rows (curve._fq2_mul_many :56: its pre-sums, three
                  products and recombination in one launch)
    fe_add_rows   (a + b) mod p, and (a − b) mod p past a split along the
                  first axis (field.fq_add / fq_sub, XLA ops in the
                  reference); at n_add = 0 a subtraction (fq_neg(a) = 0 − a)
    fe_pow        a^e for a host-known exponent in one launch (the scans of
                  tower.fq_inv :105 and h2c._fq_pow_scan :91)

Their wrappers take same-shape contiguous int32 rows with a trailing 12
(`(..., 2, 12)` for E = 2). A CUDA tensor launches the kernel and counts a
launch in cuda_plane.KERNELS (it must start on a 16-byte boundary: the
kernels read rows 16 bytes at a time, and the wrapper raises rather than
copy); a CPU tensor runs the plain version — field.rows_*_plain, the digit
arithmetic of field.fe_*_plain entered from rows — and counts a plain call.
There is no fallback between the two, and no switch between field planes:
on the card every product takes fe_mul_rows (the reference pins its "xla"
and "pallas" planes bit-identical, so one plane is faithful to both).

Batching. `_fq_mul_many` is ONE product launch over the stacked rows, and
`_fq2_mul_many` ONE E = 2 product launch (complex squaring when every pair
squares one element). Every output is canonical, so how the work is batched
changes no value.
"""

from __future__ import annotations

import torch

from . import cuda_plane as CP
from . import field as F

LIMBS = F.LIMBS


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _check(a: torch.Tensor, b: torch.Tensor, E: int = 1) -> torch.device:
    for t in (a, b):
        if t.dtype != torch.int32:
            raise TypeError(f"rows must be int32, got {t.dtype}")
    if a.shape != b.shape:
        raise ValueError(f"row shapes differ: {tuple(a.shape)} vs {tuple(b.shape)}")
    tail = (2, LIMBS) if E == 2 else (LIMBS,)
    if tuple(a.shape[-len(tail):]) != tail or a.numel() == 0:
        raise ValueError(f"expected (..., {', '.join(map(str, tail))}) rows, got {tuple(a.shape)}")
    if a.device != b.device:
        raise ValueError("rows are on different devices")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("rows must be contiguous")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {a.device}")
    return a.device


def aligned(*ts: torch.Tensor) -> bool:
    """Every tensor starts on a 16-byte boundary (the kernels' uint4 loads)."""
    return all(t.data_ptr() % 16 == 0 for t in ts)


def _run(name: str, plain, a: torch.Tensor, b: torch.Tensor, E: int = 1, args=()) -> torch.Tensor:
    """plain(a, b) on CPU rows, counted as a plain call; on CUDA rows one
    launch of charon_<name>(a, b, out, n, *args, stream)."""
    if _check(a, b, E).type == "cpu":
        CP.KERNELS[name].count(E, plain=True)
        return plain(a, b)
    if not aligned(a, b):
        raise ValueError("rows must start on a 16-byte boundary")
    return CP.launch_rows(name, a, b, E, args)


def mont_mul_rows(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery products a·b·R⁻¹ mod p over same-shape rows, canonical:
    the contract of pallas_plane.mont_mul_rows, any leading rank."""
    return _run("fe_mul_rows", F.rows_mul_plain, a, b, 1, (1,))


def fq2_mul_rows(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Fq2 products over same-shape (..., 2, 12) rows in one launch:
    (a0b0 − a1b1, (a0+a1)(b0+b1) − a0b0 − a1b1), canonical; complex
    squaring on the card when a and b are the same tensor (the same
    values)."""
    return _run("fe_mul_rows", F.rows_mul2_plain, a, b, 2, (2,))


def _addsub(a: torch.Tensor, b: torch.Tensor, split: int, plain) -> torch.Tensor:
    """One fe_add_rows call: rows [0, split) add, the rest subtract; a call
    that subtracts is counted in KERNELS["fe_add_rows"].cases by (1, rows,
    split)."""
    out = _run("fe_add_rows", plain, a, b, 1, (split,))
    n = a.numel() // LIMBS
    if split < n:
        CP.KERNELS["fe_add_rows"].count(1, case=(1, n, split))
    return out


def addsub_rows(a: torch.Tensor, b: torch.Tensor, n_add: int) -> torch.Tensor:
    """(a + b) mod p for a[:n_add], (a − b) mod p for a[n_add:], along the
    first axis, in one launch."""
    if a.dim() < 2 or not 0 <= n_add <= a.shape[0]:
        raise ValueError(f"n_add must be in [0, {a.shape[0] if a.dim() > 1 else 0}] on the "
                         f"first axis of (k, ..., {LIMBS}) rows, got {n_add} for {tuple(a.shape)}")
    split = n_add * (a[0].numel() // LIMBS)                  # in rows
    return _addsub(a, b, split, lambda x, y: F.rows_addsub_plain(x, y, n_add))


def add_rows(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a + b) mod p over same-shape rows."""
    return _addsub(a, b, a.numel() // LIMBS, F.rows_add_plain)


def sub_rows(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a − b) mod p over same-shape rows: fe_add_rows with n_add = 0."""
    return _addsub(a, b, 0, F.rows_sub_plain)


# ---------------------------------------------------------------------------
# Field ops (the reference's field.py names; Fq2 adds are Fq adds)
# ---------------------------------------------------------------------------


def _shape(xs) -> tuple:
    """The broadcast shape of xs (torch.broadcast_shapes without its cost)."""
    shapes = [tuple(x.shape) for x in xs]
    n = max(len(s) for s in shapes)
    out = [1] * n
    for s in shapes:
        for i, d in enumerate(s, n - len(s)):
            if d != 1:
                if out[i] not in (1, d):
                    raise ValueError(f"shapes {shapes} do not broadcast")
                out[i] = d
    return tuple(out)


def _bc(*xs):
    """Broadcast to one shape, contiguous."""
    first = xs[0].shape
    if all(x.shape == first for x in xs):
        return [x.contiguous() for x in xs]
    shape = _shape(xs)
    return [x.expand(shape).contiguous() for x in xs]


def stack(xs, dim: int = 0) -> torch.Tensor:
    """Stack elements of possibly broadcast shapes (one copy: torch.stack
    takes strided views as they are)."""
    shapes = [x.shape for x in xs]
    if shapes.count(shapes[0]) != len(shapes):
        shape = _shape(xs)
        xs = [x.expand(shape) for x in xs]
    return torch.stack(list(xs), dim)


def fq_add(a, b):
    return add_rows(*_bc(a, b))


def fq_sub(a, b):
    return sub_rows(*_bc(a, b))


def fq_neg(a):
    a = a.contiguous()
    return sub_rows(torch.zeros_like(a), a)


def fq_mont_mul(a, b):
    return _mont_mul(a, b)


def fq_sqr(a):
    return _mont_mul(a, a)


def fq_is_zero(a):
    return (a == 0).all(-1)


fq2_add = fq_add
fq2_sub = fq_sub
fq2_neg = fq_neg


def fq2_mul(a, b):
    return _fq2_mul_many([(a, b)])[0]


def fq2_sqr(a):
    return _fq2_mul_many([(a, a)])[0]


def fq2_is_zero(a):
    return (a == 0).all(-1).all(-1)


def fq_select(mask, a, b):
    return torch.where(mask[..., None], a, b)


def fq2_select(mask, a, b):
    return torch.where(mask[..., None, None], a, b)


def const(rows, like: torch.Tensor) -> torch.Tensor:
    """Host limb rows (numpy) as a tensor on `like`'s device."""
    return torch.as_tensor(rows, dtype=torch.int32, device=like.device)


# ---------------------------------------------------------------------------
# The seam (curve.py :24-69)
# ---------------------------------------------------------------------------


def _mont_mul(a, b):
    """One possibly stacked Montgomery product through fe_mul_rows."""
    return mont_mul_rows(*_bc(a, b))


def _fq_mul_many(pairs):
    """k independent Fq products as ONE product launch over stacked rows."""
    if len(pairs) == 1:
        return [_mont_mul(*pairs[0])]
    k = len(pairs)
    ab = stack([a for a, _ in pairs] + [b for _, b in pairs])
    return list(mont_mul_rows(ab[:k], ab[k:]).unbind(0))


def _fq2_mul_many(pairs):
    """k independent Fq2 products as ONE fe_mul_rows<2> launch over the
    stacked rows; complex squaring when every pair squares one element."""
    k = len(pairs)
    if all(a is b for a, b in pairs):
        x = pairs[0][0].contiguous() if k == 1 else stack([a for a, _ in pairs])
        out = fq2_mul_rows(x, x)
    elif k == 1:
        return [fq2_mul_rows(*_bc(*pairs[0]))]
    else:
        ab = stack([a for a, _ in pairs] + [b for _, b in pairs])
        out = fq2_mul_rows(ab[:k], ab[k:])
    return [out] if k == 1 else list(out.unbind(0))


# ---------------------------------------------------------------------------
# Fixed-exponent powers
# ---------------------------------------------------------------------------


def pow_rows(a: torch.Tensor, e: int) -> torch.Tensor:
    """a^e for a host-known exponent e >= 1 over Fq rows, canonical: one
    fe_pow launch on the card (the exponent's MSB-first 4-bit windows,
    leading zeros stripped, a zero window costing no product); on the CPU
    its plain version, the same scan over the plain rows product. The value
    is the reference's square-and-multiply scan's."""
    if e < 1:
        raise ValueError("exponent must be >= 1")
    digits = CP.pow_digits(CP.exp_digits(e))
    a = a.contiguous()
    if _check(a, a).type == "cuda" and not aligned(a):
        raise ValueError("rows must start on a 16-byte boundary")
    return CP.pow_call("rows", a, digits, F.rows_mul_plain)
