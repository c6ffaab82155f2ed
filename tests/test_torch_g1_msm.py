"""The port's G1 programs of the FROST ceremony on the CPU (ops/plane_agg.py):
the batched fixed-base keygen g1_mul_gen_batch byte for byte against native
(the JAX package's frost._g1_mul_gen), the G1 affine form and emit against
the JAX package's _g1_emit_bytes and its serializer, the group reduction's
plain version (ops/curve.py, the kernel's order of adds) against
pure-Python sums, at E = 1 and at E = 2 (the sigagg paths' combined MSM),
and its kernel body built on the host at both, g1_groups_msm against pure-Python group sums, and
g1_lincomb_is_infinity against the JAX package's own device graph at the
size of its tier-1 test; both G1 paths reject an order-3 and an infinity
point; the launches of a keygen call and of a chunk, which chip_smoke.py
pins on the card. Sizes stay at one 128-lane bucket."""

import importlib.util
import os
import random

import pytest
import torch

from charon_tpu.crypto import curve as RC
from charon_tpu.crypto import fields as RF
from charon_tpu.crypto.serialize import g1_from_bytes, g1_to_bytes
from charon_tpu.dkg import frost as RFROST
from charon_tpu.ops import plane_agg as RPA
from charon_tpu_torch.ops import convert as CV
from charon_tpu_torch.ops import cuda_plane as CP
from charon_tpu_torch.ops import plane_agg as PA

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
INF48 = b"\xc0" + bytes(47)


@pytest.fixture(scope="module")
def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _launches() -> dict:
    """The plain calls since the last reset, by kernel and variant: what a
    launch counts on the card."""
    return {k: {v: c for v, c in kern.plain_calls.items() if c}
            for k, kern in CP.KERNELS.items() if sum(kern.plain_calls.values())}


def _affine(pt):
    return RC.to_affine(RC.FqOps, pt)


def _order3():
    """A point of order 3 on G1's curve (tests/test_dkg.py's construction)."""
    h = 0x396C8C005555E1568C00AAAB0000AAAB
    x = 1
    while True:
        y = RF.fq_sqrt((x ** 3 + RC.B_G1) % RF.P)
        if y is not None:
            cand = RC._mul_full(RC.FqOps, RC.to_jacobian(RC.FqOps, (x, y)), h * RF.R // 3)
            if not RC.jac_is_infinity(RC.FqOps, cand):
                assert RC.jac_is_infinity(RC.FqOps, RC._mul_full(RC.FqOps, cand, 3))
                return cand
        x += 1


def test_g1_mul_gen_batch_is_native_byte_for_byte(chip_smoke):
    """9 seeded scalars and 1, 2, r−1: the bytes of native ct_pubkey (the JAX
    package's frost._g1_mul_gen), from one sweep of 64 windows over the
    generator plane, the p−2 scan and 4 product levels (padding lanes,
    which carry the generator, are not emitted)."""
    rng = random.Random(31)
    scalars = [rng.randrange(1, RF.R) for _ in range(9)] + [1, 2, RF.R - 1]
    CP.reset_counts()
    got = PA.g1_mul_gen_batch(scalars, CPU)
    assert _launches() == chip_smoke.DKG_KEYGEN_LAUNCHES
    assert CP.KERNELS["pt_mul_windowed"].cases == {(1, 128, 64): 1}
    assert got == [RFROST._g1_mul_gen(s) for s in scalars]
    assert PA.g1_mul_gen_batch([], CPU) == []


def test_g1_affine_std_and_emit_match_the_reference():
    """Jacobian points with random Z (both signs of y), infinity with a
    nonzero X and padding: the standard-form x, sign and infinity flags of
    g1_affine_std give through g1_emit_bytes the JAX package's
    _g1_emit_bytes bytes on the same plane (as numpy, no jit) and its
    serializer's; only the first V lanes are emitted."""
    rng = random.Random(7)
    pts = []
    for _ in range(10):
        ax, ay = _affine(RC.jac_mul(RC.FqOps, RC.g1_generator(), rng.randrange(1, RF.R)))
        z = rng.randrange(1, RF.P)
        pts.append((ax * z * z % RF.P, ay * z * z * z % RF.P, z))
    pts[3] = (5, 9, 0)
    assert len({_affine(p)[1] > (RF.P - 1) // 2 for p in pts if p[2]}) == 2
    X, Y, Z = (CV.port_from_ints([p[c] for p in pts] + [0] * 118, 1) for c in range(3))
    xs, sign, inf = PA.g1_affine_std(X, Y, Z)
    V = 9
    got = PA.g1_emit_bytes(xs.numpy(), sign.numpy(), inf.numpy(), V)
    want = RPA._g1_emit_bytes(CV.planes_to_jax(xs), sign.numpy(), inf.numpy(), V)
    assert got == want == [g1_to_bytes(p) for p in pts[:V]]
    assert inf.tolist() == [p[2] == 0 for p in pts] + [True] * 118


def _python_groups(pts, gid, G, ops=RC.FqOps):
    sums = [RC.jac_infinity(ops) for _ in range(G)]
    for p, g in zip(pts, gid):
        if 0 <= g < G:
            sums[g] = RC.jac_add(ops, sums[g], p)
    return sums


@pytest.mark.parametrize("n,G", [(5, 1), (70, 4), (130, 2)])
def test_reduce_groups_plain_is_each_groups_sum(n, G):
    """reduce_groups on the CPU (the kernel's plain version, its order of
    adds: spans of 64 lanes, then each group's partials): each group's
    affine sum is the pure-Python sum of its lanes, with an empty group,
    a point and its negation, a point twice, infinity lanes (zeros, and
    Z = 0 with X, Y not), ids −1 and ≥ G (in no group); one plain call."""
    rng = random.Random(n)
    base = [RC.jac_mul(RC.FqOps, RC.g1_generator(), rng.randrange(1, RF.R)) for _ in range(5)]
    pts = [base[rng.randrange(5)] for _ in range(n)]
    gid = [rng.randrange(-1, max(G - 1, 1)) for _ in range(n)]
    neg0 = (base[0][0], RF.P - base[0][1], base[0][2])
    edges = [(base[0], 0), (neg0, 0), (base[1], 0), (base[1], 0), ((0, 0, 0), 0), ((3, 4, 0), 0),
             (base[2], G), (base[3], -1)]
    for i, (p, g) in enumerate(edges[:n]):
        pts[i], gid[i] = p, g
    X, Y, Z = (CV.port_from_ints([p[c] for p in pts], 1) for c in range(3))
    CP.reset_counts()
    got = CP.reduce_groups(X, Y, Z, torch.tensor(gid, dtype=torch.int32), G)
    assert CP.KERNELS["pt_reduce_groups"].cases == {(1, n, G): 1}
    assert [o.shape for o in got] == [(1, 12, G)] * 3
    sums = [tuple(c) for c in zip(*(CV.ints_from_port(o) for o in got))]
    want = _python_groups(pts, gid, G)
    assert [_affine(s) for s in sums] == [_affine(w) for w in want]
    if G > 1:
        assert _affine(sums[G - 1]) is None        # empty group: ∞, zeros
        assert sums[G - 1] == (0, 0, 0)


@pytest.mark.parametrize("n,G", [(8, 3), (70, 3), (130, 5)])
def test_reduce_groups_plain_at_e2_is_each_groups_sum(n, G):
    """reduce_groups at E = 2, as the combined MSM calls it: group 0 G2
    points (its signature lanes), groups 1 .. G − 2 G1 points embedded in
    Fq2 (c1 = 0: its pk lanes), group G − 1 empty. Each group's affine sum
    is the pure-Python sum of its lanes over Fq2 (charon_tpu.crypto.curve),
    with a point and its negation, a point twice, infinity lanes (zeros,
    and Z = 0 with X, Y not), ids −1 and ≥ G (in no group); one plain call
    counted at E = 2, and the sums read back by host_points."""
    rng = random.Random(200 + n)
    ops = RC.Fq2Ops
    g2 = [RC.jac_mul(ops, RC.g2_generator(), rng.randrange(1, RF.R)) for _ in range(4)]
    g1 = [tuple((c, 0) for c in RC.jac_mul(RC.FqOps, RC.g1_generator(), rng.randrange(1, RF.R)))
          for _ in range(4)]
    gid = [rng.randrange(-1, G - 1) for _ in range(n)]
    pts = [g2[rng.randrange(4)] if g <= 0 else g1[rng.randrange(4)] for g in gid]
    neg0 = (g2[0][0], tuple(RF.P - c for c in g2[0][1]), g2[0][2])
    zero2 = ((0, 0),) * 3
    edges = [(g2[0], 0), (neg0, 0), (g2[1], 0), (g2[1], 0), (zero2, 0), (g1[0], 1),
             (((3, 1), (4, 0), (0, 0)), 1), (g2[2], G), (g1[1], -1)]
    for i, (p, g) in enumerate(edges[:n]):
        pts[i], gid[i] = p, g
    X, Y, Z = (CV.port_from_ints([p[c] for p in pts], 2) for c in range(3))
    CP.reset_counts()
    got = CP.reduce_groups(X, Y, Z, torch.tensor(gid, dtype=torch.int32), G, 2)
    assert CP.KERNELS["pt_reduce_groups"].cases == {(2, n, G): 1}
    assert CP.KERNELS["pt_reduce_groups"].plain_calls == {1: 0, 2: 1}
    assert [o.shape for o in got] == [(2, 12, G)] * 3
    sums = CP.host_points(*got)
    assert sums == [tuple(c) for c in zip(*(CV.ints_from_port(o) for o in got))]
    want = _python_groups(pts, gid, G, ops)
    assert [RC.to_affine(ops, s) for s in sums] == [RC.to_affine(ops, w) for w in want]
    assert all(s[c][1] == 0 for s in sums[1:] for c in range(3))   # G1 sums stay in Fq
    assert sums[G - 1] == zero2                  # empty group: ∞, zeros


def _items(n_val: int, dealers: int, t: int, x: int, ctx: bytes):
    out = []
    for v in range(n_val):
        for d in range(1, dealers + 1):
            b, shares = RFROST.Participant(d, t, 3, ctx + bytes([v])).round1()
            out.append((x, shares[x], b.commitments))
    return out


def test_g1_groups_msm_matches_python_group_sums(chip_smoke):
    """Two validators × 3 dealers at t = 3 (18 commitments), 64-bit scalars,
    a group a degree: each group's sum is the pure-Python Σ kᵢ·Pᵢ (affine),
    from one chunk whose launches are chip_smoke.DKG_CHUNK_LAUNCHES."""
    rng = random.Random(3)
    items = _items(2, 3, 3, 2, b"gm")
    pts = [c for _, _, cm in items for c in cm]
    scalars = [rng.randrange(1, 1 << 64) for _ in pts]
    groups = [k % 3 for k in range(len(pts))]
    CP.reset_counts()
    sums = PA.g1_groups_msm(pts, scalars, groups, 3, CPU)
    assert _launches() == chip_smoke.DKG_CHUNK_LAUNCHES
    want = [RC.jac_infinity(RC.FqOps) for _ in range(3)]
    for p, k, g in zip(pts, scalars, groups):
        want[g] = RC.jac_add(RC.FqOps, want[g], RC.jac_mul(RC.FqOps, g1_from_bytes(p), k))
    assert [_affine(s) for s in sums] == [_affine(w) for w in want]
    with pytest.raises(ValueError, match="length mismatch"):
        PA.g1_groups_msm(pts, scalars[:-1], groups, 3, CPU)


def test_g1_lincomb_is_infinity_is_the_reference_device_graph():
    """The JAX package's tier-1 equation (tests/test_dkg.py:136: one dealer,
    t = 2, fixed randomizers) through its g1_lincomb_is_infinity and the
    port's: True, and False with the first scalar changed; n = 0 is True."""
    b, shares = RFROST.Participant(1, 2, 2, b"ctx").round1()
    rng = random.Random(9)
    pts, scs = RFROST._rlc_share_equation([(2, shares[2], b.commitments)],
                                          rand=lambda: rng.randrange(1, 1 << 64))
    bad = [(scs[0] + 1) % (2 ** 256 - 1)] + scs[1:]
    for s, want in ((scs, True), (bad, False)):
        assert RPA.g1_lincomb_is_infinity(pts, s) is want
        assert PA.g1_lincomb_is_infinity(pts, s, CPU) is want
    assert PA.g1_lincomb_is_infinity([], [], CPU) is True


def test_g1_paths_reject_order3_and_infinity_points():
    """An order-3 component survives a 64-bit RLC with probability ~1/3 and
    ∞ is the RLC identity: both G1 paths raise the device branch's
    ValueError for each (the JAX package's CPU path raises a ValueError
    too, from its native decoder)."""
    b, shares = RFROST.Participant(1, 2, 2, b"ctx").round1()
    evil = g1_to_bytes(RC.jac_add(RC.FqOps, g1_from_bytes(b.commitments[0]), _order3()))
    for bad, text in (([evil] + b.commitments[1:], "G1 point not in subgroup"),
                      ([INF48] + b.commitments[1:], "infinity G1 point rejected")):
        pts, scs = RFROST._rlc_share_equation([(2, shares[2], bad)])
        with pytest.raises(ValueError):
            RPA.g1_lincomb_is_infinity(pts, scs)
        with pytest.raises(ValueError, match=f"^{text}$"):
            PA.g1_lincomb_is_infinity(pts, scs, CPU)
        with pytest.raises(ValueError, match=f"^{text}$"):
            PA.g1_groups_msm(bad, [3, 5], [0, 1], 2, CPU)


def test_groups_msm_chunks_at_the_tile(monkeypatch):
    """Past one TILE the points go in chunks, each at its bucket, group ids
    global, partial sums added on the host (TILE patched to 4: 6 points in
    chunks of 4 and 2, both at the 4-lane bucket)."""
    monkeypatch.setattr(CP, "TILE", 4)
    pts = [RC.jac_mul(RC.FqOps, RC.g1_generator(), k) for k in range(1, 7)]
    enc = [g1_to_bytes(p) for p in pts]
    CP.reset_counts()
    sums = PA.g1_groups_msm(enc, [1, 2, 3, 4, 5, 6], [0, 1, 0, 1, 0, 1], 2, CPU)
    assert CP.KERNELS["pt_reduce_groups"].cases == {(1, 4, 2): 2}
    assert [_affine(s) for s in sums] == [
        _affine(RC.jac_mul(RC.FqOps, RC.g1_generator(), 1 + 9 + 25)),
        _affine(RC.jac_mul(RC.FqOps, RC.g1_generator(), 4 + 16 + 36))]


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory, chip_smoke):
    """plane_kernels.cu compiled by g++ through tests/test_torch_windowed.py's
    shim of the CUDA keywords (a block at a time, one std::thread a CUDA
    thread) with the point schedules' header, bound as on the card."""
    import shutil
    import subprocess

    import test_torch_windowed as TW
    from charon_tpu_torch.ops import point_schedule as PS

    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++: the kernels' host build needs a C++20 compiler")
    out = tmp_path_factory.mktemp("reduce_host")
    (out / "cuda_runtime.h").write_text(TW._SHIM)
    (out / "point_schedule.h").write_text(PS.header())
    with open(CP.SOURCES[0]) as f:
        (out / "k.cpp").write_text(TW.shim_source(f.read()))
    proc = subprocess.run([gxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", "-w", "-I",
                           str(out), "-I", os.path.dirname(CP.SOURCES[0]), "-o",
                           str(out / "libk.so"), str(out / "k.cpp")],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return CP.bind(str(out / "libk.so"))


def test_reduce_groups_kernel_is_the_plain_version(host_lib, chip_smoke):
    """The kernel body itself (two launches: the partial sums of two spans,
    then the groups') on the host, at E = 1 and E = 2: its X, Y, Z words are
    the plain version's on chip_smoke.py's edge lanes (∞, order 3, P + (−P)
    and P + P in an accumulator, padding, an empty group; at E = 2 G2
    points beside embedded G1 ones) and with every lane padding; the card
    holds it at every width the DKG, the slot and the bulk verify launch.
    E = 2 runs at 24 lanes, one span a group (its 256-thread blocks take
    seconds each on the host), on the edge lanes."""
    G = 2
    for E, n, cases in ((1, 72, 2), (2, 24, 1)):
        for label, pts, gid in chip_smoke._reduce_cases(n, G, CPU, E)[:cases]:
            want = CP.C.pt_reduce_groups_plain(*pts, gid, G, E)
            nb = -(-n // CP.C.RED_SPAN)
            scratch = torch.empty(3 * E * 12 * G * nb, dtype=torch.int32)
            outs = [torch.empty((E, 12, G), dtype=torch.int32) for _ in range(3)]
            rc = host_lib.charon_pt_reduce_groups(E, *[t.data_ptr() for t in pts], gid.data_ptr(),
                                                  n, G, *[o.data_ptr() for o in outs],
                                                  scratch.data_ptr(), None)
            assert rc == 0
            assert all(torch.equal(o, w) for o, w in zip(outs, want)), (E, label)
