"""Port point layer vs the JAX package: the plain versions of the pt_double
and pt_add kernels against charon_tpu.ops.pallas_plane's pt_double/pt_add
(their CPU path) with the edges P+P, P+(−P), ∞+Q and P+∞, compared as affine
points; and the composite loops (pow scan, windowed scalar multiplication,
reduction tree + host fold, shared-scalar multiplication) against the
pure-Python oracle."""

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


def test_reduce_tree_and_host_fold_sum_the_plane():
    ops = RC.FqOps
    g = RC.g1_generator()
    pts, acc = [], g
    for _ in range(200):
        pts.append(acc)
        acc = RC.jac_add(ops, acc, g)
    pts += [(1, 1, 0)] * (256 - len(pts))           # ∞ padding
    planes = [CV.port_from_ints([p[c] for p in pts], 1) for c in range(3)]
    red = CP.reduce_tree(*planes, 1)
    assert red[0].shape == (1, 12, 32)              # (8, 32) -> one sublane
    total = CP.host_fold(*red, 1)
    assert RC.to_affine(ops, total) == RC.to_affine(ops, RC.jac_mul(ops, g, 200 * 201 // 2))
    emb = [torch.cat([c, torch.zeros_like(c)]) for c in planes]
    total2 = CP.host_fold(*CP.reduce_tree(*emb, 2), 2)
    assert RC.to_affine(ops, tuple(c[0] for c in total2)) == RC.to_affine(ops, total)


def test_shared_scalar_mul():
    pts = _points(1, 80, 4)
    planes = [CV.port_from_ints([p[c] for p in pts], 1) for c in range(3)]
    for k in (1, 13, RPF.X_ABS):
        got = _affine(CP.shared_mul(*planes, k, 1), 1)
        assert got == [RC.to_affine(RC.FqOps, RC.jac_mul(RC.FqOps, p, k)) for p in pts]
    with pytest.raises(ValueError):
        CP.shared_mul(*planes, 0, 1)


def test_pad_batch_buckets_match_the_reference():
    for n in (1, 8, 127, 128, 129, 1000, 1024, 1025, 3000, 4096):
        assert CP.pad_batch(n) == PP.pad_batch(n)
    assert CP.exp_digits(RPF.P - 2) == list(PP.exp_digits(RPF.P - 2))
    scalars = [0, 1, RPF.R - 1, 12345]
    ref = PP.scalars_to_digitplanes(scalars, 4)
    assert np.array_equal(CP.scalars_to_digitplanes(scalars, 4), ref.reshape(ref.shape[0], -1))
