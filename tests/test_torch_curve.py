"""Port point layer vs the JAX package: the plain versions of the pt_double
and pt_add kernels against charon_tpu.ops.pallas_plane's pt_double/pt_add
(their CPU path) with the edges P+P, P+(−P), ∞+Q and P+∞, compared as affine
points; the plain versions of the two scalar-multiplication kernels
(pt_mul_shared, pt_mul_windowed) word for word against the reference's
pt_double/pt_add chained in the order of _shared_mul_call and
_scalar_mul_windowed; and the composites (pow scan, windowed and
shared-scalar multiplication) against the pure-Python oracle. The group
reduction is tests/test_torch_g1_msm.py's."""

import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from charon_tpu.crypto import curve as RC
from charon_tpu.crypto import fields as RPF
from charon_tpu.ops import field as RF
from charon_tpu.ops import pallas_plane as PP
from charon_tpu_torch.ops import convert as CV
from charon_tpu_torch.ops import cuda_plane as CP

B = 128


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _ops(E):
    return RC.FqOps if E == 1 else RC.Fq2Ops


def _points(E: int, seed: int, k: int = 8):
    rng = random.Random(seed)
    gen = RC.g1_generator() if E == 1 else RC.g2_generator()
    return [RC.jac_mul(_ops(E), gen, rng.randrange(1, RPF.R)) for _ in range(k)]


def _lanes(E: int):
    """(p lanes, q lanes): lanes 0-7 P+2P, 8 P+P, 9 P+(−P), 10 ∞+Q, 11 P+∞,
    the rest P+2P again."""
    ops = _ops(E)
    pts = _points(E, 60 + E)
    inf = (ops.one, ops.one, ops.zero)
    ps, qs = [], []
    for i in range(B):
        P = pts[i % 8]
        ps.append(P)
        qs.append(RC.jac_double(ops, P))
    ps[8], qs[8] = pts[0], pts[0]
    ps[9], qs[9] = pts[1], RC.jac_neg(ops, pts[1])
    ps[10], qs[10] = inf, pts[2]
    ps[11], qs[11] = pts[3], inf
    return ps, qs


def _ref_planes(pts, E):
    enc = RF.fq_from_int if E == 1 else (lambda v: RF.fq2_from_ints(*v))
    return [PP.to_plane(np.stack([enc(p[c]) for p in pts]), E) for c in range(3)]


def _affine(planes_port, E):
    cols = [CV.ints_from_port(c) for c in planes_port]
    return [RC.to_affine(_ops(E), (x, y, z)) for x, y, z in zip(*cols)]


@pytest.mark.parametrize("E", [1, 2])
def test_plain_double_matches_the_jax_package(E):
    ps, _ = _lanes(E)
    ref = _ref_planes(ps, E)
    want = PP.pt_double(PP.PlanePoint(*[jnp.asarray(c) for c in ref], E, B))
    got = CP.pt_double(*[CV.planes_from_jax(c) for c in ref], E)
    got_aff = _affine(got, E)
    assert got_aff == _affine([CV.planes_from_jax(np.asarray(c)) for c in
                               (want.X, want.Y, want.Z)], E)
    assert got_aff[:12] == [RC.to_affine(_ops(E), RC.jac_double(_ops(E), p)) for p in ps[:12]]


@pytest.mark.parametrize("E", [1, 2])
def test_plain_unified_add_matches_the_jax_package(E):
    ps, qs = _lanes(E)
    rp, rq = _ref_planes(ps, E), _ref_planes(qs, E)
    want = PP.pt_add(PP.PlanePoint(*[jnp.asarray(c) for c in rp], E, B),
                     PP.PlanePoint(*[jnp.asarray(c) for c in rq], E, B))
    got = CP.pt_add(*[CV.planes_from_jax(c) for c in rp + rq], E)
    got_aff = _affine(got, E)
    assert got_aff == _affine([CV.planes_from_jax(np.asarray(c)) for c in
                               (want.X, want.Y, want.Z)], E)
    oracle = [RC.to_affine(_ops(E), RC.jac_add(_ops(E), p, q)) for p, q in zip(ps[:12], qs[:12])]
    assert got_aff[:12] == oracle
    assert got_aff[9] is None                       # P + (−P) = ∞
    assert CV.ints_from_port(got[2])[9] in (0, (0, 0))


@pytest.mark.parametrize("e", [(RPF.P + 1) // 4, (RPF.P - 3) // 4, RPF.P - 2, (RPF.P - 1) // 2],
                         ids=["sqrt", "e34", "inv", "euler"])
def test_pow_scan_matches_the_jax_package(e):
    """fe_pow's plane plain version (cuda_plane.pow_scan on a CPU plane) on 8
    lanes, the edges 0, 1, p−1, R mod p first, against the reference's
    _pow_scan over the same window digits (its CPU path); exact. One
    fe_pow<plane> call, no per-step fe_mul call."""
    rng = random.Random(8)
    vals = [0, 1, RPF.P - 1, (1 << 384) % RPF.P] + [rng.randrange(RPF.P) for _ in range(4)]
    ref = PP.to_plane(np.stack([RF.fq_from_int(v) for v in vals]), 1)
    want = np.asarray(PP._pow_scan(jnp.asarray(ref), jnp.asarray(PP.exp_digits(e))))
    CP.reset_counts()
    got = CP.pow_scan(CV.planes_from_jax(ref), CP.exp_digits(e))
    assert torch.equal(got, CV.planes_from_jax(want))
    assert CV.ints_from_port(got)[:len(vals)] == [pow(v, e, RPF.P) for v in vals]
    assert CP.KERNELS["fe_pow"].plain_calls == {"plane": 1, "rows": 0}
    assert CP.KERNELS["fe_mul"].plain_calls == {1: 0, 2: 0}


def test_pow_scan_is_a_fixed_exponent_power():
    rng = random.Random(7)
    vals = [0, 1, RPF.P - 1] + [rng.randrange(RPF.P) for _ in range(5)]
    for e in ((RPF.P - 3) // 4, RPF.P - 2):
        got = CV.ints_from_port(CP.pow_scan(CV.port_from_ints(vals, 1), CP.exp_digits(e)))
        assert got == [pow(v, e, RPF.P) for v in vals]


@pytest.mark.parametrize("E", [1, 2])
def test_windowed_scalar_mul_with_zero_digits(E):
    pts = _points(E, 70 + E, 4) + [(_ops(E).one, _ops(E).one, _ops(E).zero)] * 4
    scalars = [0, 1, 0xF0F0_0000_0000_0001, (1 << 64) - 1, 5, 0, 7, 9]
    planes = [CV.port_from_ints([p[c] for p in pts], E) for c in range(3)]
    digits = torch.as_tensor(CP.scalars_to_digitplanes(scalars, len(pts), nbits=64))[:, :8]
    assert digits.shape == (16, 8) and int(digits[:, 0].max()) == 0
    got = _affine(CP.scalar_mul_windowed(*planes, digits, E), E)
    assert got == [RC.to_affine(_ops(E), RC.jac_mul(_ops(E), p, k)) for p, k in zip(pts, scalars)]


def test_shared_scalar_mul():
    pts = _points(1, 80, 4)
    planes = [CV.port_from_ints([p[c] for p in pts], 1) for c in range(3)]
    for k in (1, 13, RPF.X_ABS):
        got = _affine(CP.shared_mul(*planes, k, 1), 1)
        assert got == [RC.to_affine(RC.FqOps, RC.jac_mul(RC.FqOps, p, k)) for p in pts]
    with pytest.raises(ValueError):
        CP.shared_mul(*planes, 0, 1)


# ---------------------------------------------------------------------------
# The scalar-multiplication kernels' plain versions against the reference's
# point steps, chained in its order (its whole composites are not compiled
# here: PP._scalar_mul_windowed and PP._shared_mul_call take minutes on
# XLA:CPU)
# ---------------------------------------------------------------------------

N8 = 8


def _mul_lanes(E: int, seed: int):
    """8 lanes: random points, lane 5 ∞, lane 6 the generator (small
    multiples of one point)."""
    ops = _ops(E)
    pts = _points(E, seed)
    pts[5] = (ops.one, ops.one, ops.zero)
    pts[6] = RC.g1_generator() if E == 1 else RC.g2_generator()
    return pts, _ref_planes(pts, E)


def _ref_point(planes, E):
    return PP.PlanePoint(*[jnp.asarray(c) for c in planes], E, N8)


def _words(point):
    return [CV.planes_from_jax(np.asarray(c)) for c in (point.X, point.Y, point.Z)]


def _plain_calls(*names):
    return {k: dict(CP.KERNELS[k].plain_calls) for k in names}


@pytest.mark.parametrize("E", [1, 2])
def test_shared_mul_plain_matches_the_jax_package_steps(E):
    """k = 13 (bits 1101): the reference's unrolled double-and-add
    (_shared_mul_call: a double per bit after the first, an add of P per set
    bit) over PP.pt_double / PP.pt_add, word for word; one pt_mul_shared
    plain call and no per-step one."""
    pts, ref = _mul_lanes(E, 90 + E)
    P = _ref_point(ref, E)
    acc = P
    for bit in bin(13)[3:]:
        acc = PP.pt_double(acc)
        if bit == "1":
            acc = PP.pt_add(acc, P)
    CP.reset_counts()
    got = CP.shared_mul(*[CV.planes_from_jax(c) for c in ref], 13, E)
    assert all(torch.equal(g, w) for g, w in zip(got, _words(acc)))
    assert _plain_calls("pt_mul_shared", "pt_double", "pt_add") == {
        "pt_mul_shared": {1: int(E == 1), 2: int(E == 2)},
        "pt_double": {1: 0, 2: 0}, "pt_add": {1: 0, 2: 0}}
    assert CP.KERNELS["pt_mul_shared"].cases == {(E, 128, 13): 1}
    assert _affine(got, E)[:N8] == [RC.to_affine(_ops(E), RC.jac_mul(_ops(E), p, 13))
                                    for p in pts]


@pytest.mark.parametrize("nwin", [2, 4])
def test_windowed_mul_plain_matches_the_jax_package_steps(nwin):
    """E = 2, seeded digits with an all-zero column (lane 2), a zero row and
    the ∞ lane: the reference's _scalar_mul_windowed walk over PP.pt_double /
    PP.pt_add (the table: an even entry the double of entry k/2, an odd one
    entry k−1 plus P; then from ∞ per window 4 doubles and the add of the
    selected entry, digit 0 the ∞ entry), word for word; one
    pt_mul_windowed plain call and no per-step one."""
    E = 2
    pts, ref = _mul_lanes(E, 100 + nwin)
    rng = np.random.default_rng(nwin)
    digits = np.zeros((nwin, 128), np.uint8)
    digits[:, :N8] = rng.integers(0, 16, (nwin, N8))
    digits[:, 2] = 0
    digits[0, 3:5] = 0
    digits[1, 6] = 1
    P = _ref_point(ref, E)
    zero = PP.PlanePoint(P.X * 0, P.Y * 0, P.Z * 0, E, N8)
    tab = [zero, P]
    for k in range(2, 16):
        tab.append(PP.pt_double(tab[k // 2]) if k % 2 == 0 else PP.pt_add(tab[k - 1], P))
    T = [np.stack([np.asarray(getattr(t, c)) for t in tab]) for c in "XYZ"]  # (16, E, 12, 8, 16)
    acc = zero
    for w in range(nwin):
        for _ in range(4):
            acc = PP.pt_double(acc)
        idx = np.broadcast_to(digits[w].reshape(1, 1, 1, 8, 16).astype(np.int64),
                              (1,) + T[0].shape[1:])
        sel = [jnp.asarray(np.take_along_axis(t, idx, 0)[0]) for t in T]
        acc = PP.pt_add(acc, PP.PlanePoint(*sel, E, N8))
    CP.reset_counts()
    got = CP.scalar_mul_windowed(*[CV.planes_from_jax(c) for c in ref], torch.as_tensor(digits), E)
    assert all(torch.equal(g, w) for g, w in zip(got, _words(acc)))
    assert _plain_calls("pt_mul_windowed", "pt_double", "pt_add") == {
        "pt_mul_windowed": {1: 0, 2: 1}, "pt_double": {1: 0, 2: 0}, "pt_add": {1: 0, 2: 0}}
    assert CP.KERNELS["pt_mul_windowed"].cases == {(2, 128, nwin): 1}
    ks = [sum(int(digits[w, i]) << (4 * (nwin - 1 - w)) for w in range(nwin)) for i in range(N8)]
    assert _affine(got, E)[:N8] == [RC.to_affine(_ops(E), RC.jac_mul(_ops(E), p, k))
                                    for p, k in zip(pts, ks)]


def test_shared_mul_large_scalars_match_the_oracle():
    """[X_ABS²]P (the G1 subgroup check's scalar) on 4 points and [h_eff]P
    (the G2 cofactor clear's, 636 bits) on one, affine against RC.jac_mul."""
    pts = _points(1, 110, 4)
    planes = [CV.port_from_ints([p[c] for p in pts], 1) for c in range(3)]
    u2 = RPF.X_ABS * RPF.X_ABS
    assert _affine(CP.shared_mul(*planes, u2, 1), 1) == [
        RC.to_affine(RC.FqOps, RC.jac_mul(RC.FqOps, p, u2)) for p in pts]
    q = _points(2, 111, 1)
    planes = [CV.port_from_ints([q[0][c]], 2) for c in range(3)]
    assert _affine(CP.shared_mul(*planes, RC.H_EFF_G2, 2), 2) == [
        RC.to_affine(RC.Fq2Ops, RC.jac_mul(RC.Fq2Ops, q[0], RC.H_EFF_G2))]


def test_scalar_mul_wrappers_reject_what_the_kernels_do_not_take():
    planes = [CV.port_from_ints([p[c] for p in _points(1, 120, 2)], 1) for c in range(3)]
    digits = torch.zeros((2, 2), dtype=torch.uint8)
    CP.reset_counts()
    for k in (0, -1, 1 << CP.MUL_MAX_BITS):
        with pytest.raises(ValueError, match="shared scalar"):
            CP.shared_mul(*planes, k, 1)
    with pytest.raises(ValueError, match="E must be 1 or 2"):
        CP.shared_mul(*planes, 5, 3)
    for bad in (digits[:, :1], torch.zeros((0, 2), dtype=torch.uint8), digits[0],
                digits.to(torch.int32)):
        with pytest.raises(ValueError, match="digits"):
            CP.scalar_mul_windowed(*planes, bad, 1)
    with pytest.raises(ValueError, match="E must be 1 or 2"):
        CP.scalar_mul_windowed(*planes, digits, 3)
    assert _plain_calls("pt_mul_shared", "pt_mul_windowed") == {
        "pt_mul_shared": {1: 0, 2: 0}, "pt_mul_windowed": {1: 0, 2: 0}}


def test_pad_batch_buckets_match_the_reference():
    for n in (1, 8, 127, 128, 129, 1000, 1024, 1025, 3000, 4096):
        assert CP.pad_batch(n) == PP.pad_batch(n)
    assert CP.exp_digits(RPF.P - 2) == list(PP.exp_digits(RPF.P - 2))
    scalars = [0, 1, RPF.R - 1, 12345]
    ref = PP.scalars_to_digitplanes(scalars, 4)
    assert np.array_equal(CP.scalars_to_digitplanes(scalars, 4), ref.reshape(ref.shape[0], -1))
