"""Port rows field plane vs the JAX package: the plain versions of the
fe_mul_rows (E = 1 and the whole Fq2 product, E = 2) and fe_add_rows (with
its add/sub split; at n_add = 0 the subtraction and negation) kernels
(ops/rows.py on CPU tensors) against charon_tpu.ops.field's fq_mont_mul /
fq_add / fq_sub / fq_neg and charon_tpu.ops.curve's _fq2_mul_many, the
port's seam (_fq_mul_many, _fq2_mul_many) against charon_tpu.ops.curve's,
and fe_pow's rows plain version (rows.pow_rows) against the reference's
tower.fq_inv and h2c._fq_pow_scan, on the same seeded inputs through
ops/convert.py, with exact equality; plus the wrappers' input checks and
the power scan's host digits.

The reference's field primitives are run under jax.jit (each compiled once
per shape): they are the same functions, and called eagerly their scans
would recompile on every call."""

import importlib.util
import os
import random

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from charon_tpu.ops import curve as RC
from charon_tpu.ops import field as RF
from charon_tpu.ops import h2c as RH
from charon_tpu.ops import tower as RT
from charon_tpu_torch.ops import convert as CV
from charon_tpu_torch.ops import cuda_plane as CP
from charon_tpu_torch.ops import field as F
from charon_tpu_torch.ops import rows as R

P = RF.P_INT
EDGES = [0, 1, P - 1, (1 << 384) % P]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def jit_field():
    """The reference's field primitives under jax.jit, for this module."""
    mp = pytest.MonkeyPatch()
    for name in ("fq_add", "fq_sub", "fq_neg", "fq_mont_mul"):
        mp.setattr(RF, name, jax.jit(getattr(RF, name)))
    yield
    mp.undo()


def _ref_rows(vals, shape):
    return np.stack([RF.fq_from_int(v) for v in vals]).reshape(*shape, RF.LIMBS)


def _pair(seed: int, shape=(2, 3, 4)):
    """Seeded (a, b) reference rows of `shape`, the edges against each other
    (0·(R mod p), 1·(p−1), ...) in the first lanes."""
    rng = random.Random(seed)
    n = int(np.prod(shape))
    a = [rng.randrange(P) for _ in range(n)]
    b = [rng.randrange(P) for _ in range(n)]
    a[:4], b[:4] = EDGES, EDGES[::-1]
    a[4:8], b[4:8] = EDGES, EDGES
    return _ref_rows(a, shape), _ref_rows(b, shape)


@pytest.mark.parametrize("op", ["mul", "add", "sub", "neg"])
def test_rows_ops_match_the_jax_package(op, jit_field):
    a_np, b_np = _pair(30)
    a, b = CV.rows_from_jax(a_np), CV.rows_from_jax(b_np)
    ja, jb = jnp.asarray(a_np), jnp.asarray(b_np)
    CP.reset_counts()
    if op == "mul":
        got, want = R.mont_mul_rows(a, b), RF.fq_mont_mul(ja, jb)
    elif op == "add":
        got, want = R.add_rows(a, b), RF.fq_add(ja, jb)
    elif op == "sub":
        got, want = R.sub_rows(a, b), RF.fq_sub(ja, jb)
    else:
        got, want = R.fq_neg(a), RF.fq_neg(ja)
    assert got.shape == a.shape and got.dtype == torch.int32
    assert np.array_equal(CV.rows_to_jax(got), np.asarray(want))
    name = "fe_mul_rows" if op == "mul" else "fe_add_rows"
    variants = CP.KERNELS[name].variants
    assert CP.KERNELS[name].plain_calls == {E: int(E == 1) for E in variants}
    assert CP.KERNELS[name].launches == {E: 0 for E in variants}


def test_seam_matches_the_jax_package(jit_field):
    a1, b1 = _pair(31, (8,))
    a2, b2 = _pair(32, (4, 2))
    c2, d2 = _pair(33, (4, 2))
    want1 = RC._fq_mul_many([(jnp.asarray(a1), jnp.asarray(b1)), (jnp.asarray(b1), jnp.asarray(b1))])
    want2 = RC._fq2_mul_many([(jnp.asarray(a2), jnp.asarray(b2)), (jnp.asarray(c2), jnp.asarray(c2)),
                              (jnp.asarray(d2), jnp.asarray(a2))])
    t = {k: CV.rows_from_jax(v) for k, v in dict(a1=a1, b1=b1, a2=a2, b2=b2, c2=c2, d2=d2).items()}
    CP.reset_counts()
    got1 = R._fq_mul_many([(t["a1"], t["b1"]), (t["b1"], t["b1"])])
    assert CP.KERNELS["fe_mul_rows"].plain_calls[1] == 1          # one product launch
    CP.reset_counts()
    got2 = R._fq2_mul_many([(t["a2"], t["b2"]), (t["c2"], t["c2"]), (t["d2"], t["a2"])])
    # the whole Karatsuba product of every pair in one fe_mul_rows<2> launch
    assert {k: dict(CP.KERNELS[k].plain_calls) for k in ("fe_add_rows", "fe_mul_rows")} \
        == {"fe_add_rows": {1: 0}, "fe_mul_rows": {1: 0, 2: 1}}
    for g, w in zip(got1 + got2, want1 + want2):
        assert np.array_equal(CV.rows_to_jax(g), np.asarray(w))


@pytest.mark.parametrize("square", [False, True])
def test_fq2_products_match_the_jax_package(square, jit_field):
    """fe_mul_rows<2>'s plain version and its wrapper on (2, 3, 4, 2, 12)
    rows, the edges 0, 1, p−1, R mod p in both components, against the
    reference's Fq2 seam; a == b is the complex-square case of the kernel."""
    a_np, b_np = _pair(35, (2, 3, 4, 2))
    if square:
        b_np = a_np
    want = RC._fq2_mul_many([(jnp.asarray(a_np), jnp.asarray(b_np))])[0]
    a = CV.rows_from_jax(a_np)
    b = a if square else CV.rows_from_jax(b_np)
    assert np.array_equal(CV.rows_to_jax(F.rows_mul2_plain(a, b)), np.asarray(want))
    CP.reset_counts()
    got = R.fq2_mul_rows(a, b)
    assert got.shape == a.shape and np.array_equal(CV.rows_to_jax(got), np.asarray(want))
    assert CP.KERNELS["fe_mul_rows"].plain_calls == {1: 0, 2: 1}


@pytest.mark.parametrize("n_add", [0, 1, 3, 5, 6])
def test_addsub_rows_matches_the_jax_package(n_add, jit_field):
    """The split add on (6, 4, 12) rows: a[:n_add] + b[:n_add], then
    a[n_add:] − b[n_add:], against the reference's fq_add and fq_sub."""
    a_np, b_np = _pair(36, (6, 4))
    ja, jb = jnp.asarray(a_np), jnp.asarray(b_np)
    want = np.concatenate([np.asarray(RF.fq_add(ja[:n_add], jb[:n_add])),
                           np.asarray(RF.fq_sub(ja[n_add:], jb[n_add:]))])
    CP.reset_counts()
    got = R.addsub_rows(CV.rows_from_jax(a_np), CV.rows_from_jax(b_np), n_add)
    assert np.array_equal(CV.rows_to_jax(got), want)
    k = CP.KERNELS["fe_add_rows"]
    assert k.plain_calls == {1: 1} and k.launches == {1: 0}
    # every call that subtracts is counted by (1, width, n_add) in rows
    assert dict(k.cases) == ({(1, 24, 4 * n_add): 1} if n_add < 6 else {})


def test_pow_rows_matches_host_powers():
    rng = random.Random(34)
    vals = [0, 1, P - 1] + [rng.randrange(P) for _ in range(5)]
    a = torch.as_tensor(F.fq_rows(vals))
    for e in (P - 2, (P + 1) // 4, 0x10, 3):
        assert F.fq_ints(R.pow_rows(a, e).numpy()) == [pow(v, e, P) for v in vals]
    with pytest.raises(ValueError):
        R.pow_rows(a, 0)


# the exponents of the port's power scans: Fq sqrt, the G2 root's (p−3)/4,
# the inversion's p−2, and Euler's criterion
POW_EXPONENTS = {"sqrt": (P + 1) // 4, "e34": (P - 3) // 4, "inv": P - 2, "euler": (P - 1) // 2}


@pytest.mark.parametrize("name", sorted(POW_EXPONENTS))
def test_pow_rows_matches_the_jax_package(name):
    """fe_pow's rows plain version on 8 rows, the edges 0, 1, p−1, R mod p
    first, against the reference's scans: tower.fq_inv for p−2 and
    h2c._fq_pow_scan over the exponent's bits for the others; exact. One
    fe_pow<rows> call, no per-step product call."""
    e = POW_EXPONENTS[name]
    rng = random.Random(37)
    vals = EDGES + [rng.randrange(P) for _ in range(4)]
    a_np = _ref_rows(vals, (8,))
    ja = jnp.asarray(a_np)
    want = jax.jit(RT.fq_inv)(ja) if name == "inv" else \
        jax.jit(RH._fq_pow_scan)(ja, RH._bits_arr(e))
    CP.reset_counts()
    got = R.pow_rows(CV.rows_from_jax(a_np), e)
    assert np.array_equal(CV.rows_to_jax(got), np.asarray(want))
    assert F.fq_ints(got.numpy()) == [pow(v, e, P) for v in vals]
    assert CP.KERNELS["fe_pow"].plain_calls == {"plane": 0, "rows": 1}
    assert CP.KERNELS["fe_mul_rows"].plain_calls == {1: 0, 2: 0}


def test_pow_digits_strip_leading_zeros_and_skip_zero_windows():
    """fe_pow's host digits start at the exponent's first nonzero window;
    its plain version squares four times per further window and multiplies
    only where the window is not 0 (after the 14 table products)."""
    for e in (P - 2, (P + 1) // 4, 0x10, 0x1000F, 3):
        full = CP.exp_digits(e)
        digits = CP.pow_digits(full)
        lead = next(k for k, d in enumerate(full) if d)
        assert digits == full[lead:] and digits[0] != 0
        calls = []

        def mul(x, y, calls=calls):
            calls.append(1)
            return F.rows_mul_plain(x, y)

        a = torch.as_tensor(F.fq_rows([5, 7]))
        got = F.pow_plain(a, digits, mul)
        assert F.fq_ints(got.numpy()) == [pow(5, e, P), pow(7, e, P)]
        assert len(calls) == 14 + 4 * (len(digits) - 1) + sum(1 for d in digits[1:] if d)
    assert CP.pow_digits(CP.exp_digits(0x10)) == [1, 0]
    for bad in ([0] * 96, [16], [-1]):
        with pytest.raises(ValueError):
            CP.pow_digits(bad)


def test_row_wrappers_reject_what_the_kernels_do_not_take():
    a = torch.zeros(4, 12, dtype=torch.int32)
    with pytest.raises(TypeError):
        R.mont_mul_rows(a.to(torch.int64), a.to(torch.int64))
    with pytest.raises(ValueError, match="differ"):
        R.add_rows(a, torch.zeros(5, 12, dtype=torch.int32))
    with pytest.raises(ValueError, match="rows"):
        R.sub_rows(torch.zeros(4, 8, dtype=torch.int32), torch.zeros(4, 8, dtype=torch.int32))
    strided = torch.zeros(4, 24, dtype=torch.int32)[:, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        R.mont_mul_rows(strided, strided)
    meta = torch.zeros(4, 12, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="device"):
        R.add_rows(meta, meta)
    with pytest.raises(ValueError):
        R.add_rows(torch.zeros(0, 12, dtype=torch.int32), torch.zeros(0, 12, dtype=torch.int32))
    # the Fq2 product takes (..., 2, 12) rows only
    with pytest.raises(ValueError, match="2, 12"):
        R.fq2_mul_rows(a, a)
    fq2 = torch.zeros(4, 4, 12, dtype=torch.int32)[:, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        R.fq2_mul_rows(fq2, fq2)
    # the split lies on the first axis, within it
    for bad in (-1, 5):
        with pytest.raises(ValueError, match="n_add"):
            R.addsub_rows(a, a, bad)
    with pytest.raises(ValueError, match="n_add"):
        R.addsub_rows(a[0], a[0], 0)
    with pytest.raises(ValueError, match="contiguous"):
        R.addsub_rows(strided, strided, 2)
    # the kernels read rows 16 bytes at a time: a base 4 bytes in is refused
    flat = torch.zeros(52, dtype=torch.int32)
    assert R.aligned(flat[:48]) and not R.aligned(flat[1:49])


def test_chip_smoke_times_the_rows_kernels_where_the_main_path_launches_them():
    """chip_smoke.py times each rows kernel at every width (and split) the
    main path's run launched it, beside the gate's widths at 0 launches; a
    split fe_add_rows launch is its own case, not one of its width's adds."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                   "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    slot = {"widths": {"fe_mul_rows": {(1, 1): 11, (1, 8): 59, (2, 18): 351},
                       "fe_add_rows": {(1, 12): 830 + 351 + 702, (1, 2): 353},
                       "fe_pow": {("rows", 1): 1}},
            "cases": {"fe_add_rows": {(1, 12, 6): 351, (1, 2, 1): 353, (1, 12, 0): 702}}}
    cases = chip_smoke.path_rows_cases(slot)
    assert cases == {
        ("fe_mul_rows", 1): {1: 11, 108: 0, 6912: 0, 8: 59},
        ("fe_add_rows", 1): {108: 0, 6912: 0, 12: 830, (12, 6): 351, (2, 1): 353,
                             (12, 0): 702},
        ("fe_mul_rows", 2): {3: 0, 18: 351, 36: 0, 2304: 0},
    }
    # every launch of the run is one case's
    for name in ("fe_mul_rows", "fe_add_rows"):
        assert sum(c for (n, E), keys in cases.items() if n == name for c in keys.values()) \
            == sum(slot["widths"][name].values())


def test_chip_smoke_holds_what_the_committee_phase_launched_beyond_the_headline():
    """chip_smoke.py holds and times every rows, fe_pow and scalar-
    multiplication case that the committee slot and the chunked check
    launched and the headline slot did not: h2c's scans and cofactor clear
    at 64 messages and the pairing's wider rows."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                   "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    inv = (1, 2, 3)
    slot = {"widths": {"fe_mul_rows": {(1, 1): 11, (2, 18): 351},
                       "fe_add_rows": {(1, 12): 830 + 351, (1, 2): 353}},
            "cases": {"fe_add_rows": {(1, 12, 6): 351, (1, 2, 1): 353},
                      "fe_pow": {("rows", 1, inv): 1, ("plane", 4096, inv): 1},
                      "pt_mul_shared": {(2, 1, 5): 1}, "pt_mul_windowed": {(2, 4096, 64): 1}}}
    run = {"widths": {"fe_mul_rows": {(1, 1): 3, (1, 384): 5, (2, 18): 2, (2, 130): 7},
                      "fe_add_rows": {(1, 12): 4, (1, 390): 9 + 6}},
           "cases": {"fe_add_rows": {(1, 390, 0): 6, (1, 12, 6): 1},
                     "fe_pow": {("rows", 1, inv): 2, ("rows", 384, inv): 1,
                                ("plane", 4096, inv): 1},
                     "pt_mul_shared": {(2, 1, 5): 2, (2, 64, 5): 1},
                     "pt_mul_windowed": {(2, 4096, 64): 1}}}
    rows, more = chip_smoke.other_cases(run, slot)
    assert rows == {("fe_mul_rows", 1): {384: 5}, ("fe_mul_rows", 2): {130: 7},
                    ("fe_add_rows", 1): {390: 9, (390, 0): 6}}
    assert more["fe_pow"] == {("rows", 384, inv): 1}
    assert chip_smoke.mul_cases(more) == {("pt_mul_shared", 2, 64, 5): 1}

