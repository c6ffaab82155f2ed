"""The plane field kernels as levels (ops/cuda_plane.py mul_level,
addsub_level; ops/csrc/plane_kernels.cu fe_mul<E>, fe_addsub): the level
wrappers on the CPU against the one-operation plain versions word for word,
with mixed segment widths, lane slices of wider planes, add, sub and neg in
one level and the edges 0, 1, p−1, R mod p; the slot's callers that run by
level and had no direct test, g2_affine_std and jac_eq_mask, against the JAX
package; and the kernel bodies themselves, compiled by g++ through the host
shim of tests/test_torch_windowed.py, against the plain versions."""

import os
import random
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from charon_tpu.crypto import fields as RPF
from charon_tpu.ops import pallas_plane as PP
from charon_tpu.ops import plane_agg as RPA
from charon_tpu_torch.crypto import curve as PC
from charon_tpu_torch.ops import convert as CV
from charon_tpu_torch.ops import cuda_plane as CP
from charon_tpu_torch.ops import field as F
from charon_tpu_torch.ops import plane_agg as PA
from charon_tpu_torch.ops import point_schedule as PS

import test_torch_windowed as TW

P = RPF.P
EDGES = [0, 1, P - 1, (1 << 384) % P]


@pytest.fixture(scope="module")
def chip_smoke():
    return TW._chip_smoke()


def _plane(rng, E: int, n: int) -> torch.Tensor:
    """n seeded elements, the edges first (at E = 2 paired with the edges
    reversed)."""
    vals = [rng.randrange(P) if E == 1 else (rng.randrange(P), rng.randrange(P)) for _ in range(n)]
    for i, e in enumerate(EDGES[:n]):
        vals[i] = e if E == 1 else (e, EDGES[-1 - i])
    return CV.port_from_ints(vals, E)


def _wide(rng, E: int, widths) -> tuple:
    """Operands a, b of each segment as lane slices of one wide plane pair,
    the edges at each segment's first lanes (reversed in b)."""
    A = torch.cat([_plane(rng, E, n) for n in widths], -1)
    B = torch.cat([_plane(rng, E, n) for n in widths], -1)
    segs, off = [], 0
    for n in widths:
        a, b = A[..., off:off + n], B[..., off:off + n]
        b[..., :min(n, 4)] = a[..., :min(n, 4)].flip(-1)
        segs.append((a, b))
        off += n
    return segs


def _one(op: str, a, b, E: int) -> torch.Tensor:
    """The one-operation plain version of a segment."""
    a = None if a is None else a.contiguous()
    b = b.contiguous()
    if op == "mul":
        return F.fe_mul_plain(a, b, E)
    if op == "add":
        return F.fe_add_plain(a, b, E)
    return F.fe_sub_plain(torch.zeros_like(b) if a is None else a, b, E)


# (E, segment widths, operations: "mul" for a product level)
LEVELS = [(1, (64, 5, 1), "mul"), (2, (33, 4), "mul"), (1, (7,) * 8, "mul"),
          (1, (20, 9, 3, 1), ("add", "sub", "neg", "add")), (2, (17, 2, 6), ("neg", "sub", "add")),
          (2, (1,) * 4, ("add", "sub", "neg", "add"))]


@pytest.mark.parametrize("E,widths,ops", LEVELS, ids=lambda v: str(v).replace(" ", ""))
def test_a_level_is_its_operations_one_by_one(E, widths, ops):
    """Each segment's output equals the plain version of its operation word
    for word, strided operands and strided outputs alike; the level counts
    one plain call and one case, by (E, total width, shape)."""
    rng = random.Random(f"{E} {widths} {ops}")
    segs = _wide(rng, E, widths)
    out_plane = torch.full((E, F.LIMBS, sum(widths) + 3), -1, dtype=torch.int32)
    outs, off = [], 0
    for n in widths:
        outs.append(out_plane[..., off:off + n] if len(outs) % 2 else None)
        off += n
    CP.reset_counts()
    if ops == "mul":
        got = CP.mul_level(segs, E, outs)
        kern, shape, names = "fe_mul", tuple(widths), ["mul"] * len(widths)
    else:
        level = [(op, None if op == "neg" else a, b) for op, (a, b) in zip(ops, segs)]
        got = CP.addsub_level(level, E, outs)
        kern, shape, names = "fe_addsub", tuple(zip(ops, widths)), ops
    for k, (name, (a, b)) in enumerate(zip(names, segs)):
        want = _one(name, None if name == "neg" else a, b, E)
        assert torch.equal(got[k], want), k
        if outs[k] is not None:
            assert got[k].data_ptr() == outs[k].data_ptr()
    assert bool((out_plane[..., -3:] == -1).all())
    k = CP.KERNELS[kern]
    assert k.plain_calls == {1: int(E == 1), 2: int(E == 2)}
    assert dict(k.cases) == {(E, sum(widths), shape): 1}
    assert all(c.launches == {v: 0 for v in c.variants} for c in CP.KERNELS.values())


def test_fq2_components_are_segments():
    """An Fq2 plane's components read and written in place as two Fq
    segments: the product by raw 1 of each (to_std) is the reference's
    packed Fq pass, component by component."""
    rng = random.Random(11)
    x = _plane(rng, 2, 40)
    got = PA.to_std(x)[0]
    one = PA.const_plane((1,), 1, 40, "cpu", raw=True)
    for e in range(2):
        assert torch.equal(got[e:e + 1], F.fe_mul_plain(x[e:e + 1].contiguous(), one, 1))
    assert CV.ints_from_port(x) == [tuple(F.int_from_limbs(got[e, :, i].numpy()) for e in range(2))
                                    for i in range(40)]


@pytest.mark.parametrize("case", ["too many", "neg with a", "sub without a", "op", "widths",
                                  "E", "components"])
def test_a_level_rejects_what_the_kernels_do_not_take(case):
    a = torch.zeros(1, 12, 8, dtype=torch.int32)
    with pytest.raises(ValueError):
        if case == "too many":
            CP.mul_level([(a, a)] * (CP.LEVEL_SEGS + 1), 1)
        elif case == "neg with a":
            CP.addsub_level([("neg", a, a)], 1)
        elif case == "sub without a":
            CP.addsub_level([("sub", None, a)], 1)
        elif case == "op":
            CP.addsub_level([("mul", a, a)], 1)
        elif case == "widths":
            CP.mul_level([(a, a)], 1, [torch.zeros(1, 12, 9, dtype=torch.int32)])
        elif case == "E":
            CP.addsub_level([("add", a, a)] * 5, 2)
        else:
            # an Fq2 view whose components are not 12 limb rows apart
            b = torch.zeros(12, 2, 8, dtype=torch.int32).permute(1, 0, 2)
            CP.mul_level([(b, b)], 2)


# ---------------------------------------------------------------------------
# The slot's callers by level against the JAX package
# ---------------------------------------------------------------------------


def _jax(t: torch.Tensor):
    return jnp.asarray(CV.planes_to_jax(t))


def test_g2_affine_std_matches_the_jax_package():
    """Random Jacobian planes (64 lanes) with ∞ lanes (Z = 0), Z with one
    zero component, and x or y components 0: the standard-form x, the sign
    and the infinity mask of _g2_affine_std_core, word for word and bit for
    bit."""
    rng = random.Random(13)
    X, Y, Z = (CV.port_from_ints([(rng.randrange(P), rng.randrange(P)) for _ in range(64)], 2)
               for _ in range(3))
    for i in (0, 9, 63):
        Z[:, :, i] = 0
    Z[1, :, 3] = 0
    Z[0, :, 4] = 0
    Y[1, :, 5] = 0
    Y[:, :, 6] = 0
    X[:, :, 7] = 0
    xs, sign, inf = PA.g2_affine_std(X, Y, Z)
    rx, rsign, rinf = RPA._g2_affine_std_core(_jax(X), _jax(Y), _jax(Z))
    assert torch.equal(xs, CV.planes_from_jax(np.asarray(rx)))
    assert np.array_equal(sign.numpy(), np.asarray(rsign).reshape(-1))
    assert np.array_equal(inf.numpy(), np.asarray(rinf).reshape(-1))
    assert inf.tolist() == [i in (0, 9, 63) for i in range(64)]


def _jac_lanes(E: int, n: int = 16):
    """Two planes of Jacobian points, lane by lane: ∞ == ∞, ∞ against a
    finite point both ways, one point under two Z, two different points,
    the same point under the same Z, then random points under random Z
    (every second lane one point twice)."""
    rng = random.Random(f"jac {E}")
    ops = PC.FqOps if E == 1 else PC.Fq2Ops
    gen = PC.g1_generator() if E == 1 else PC.g2_generator()
    aff = [PC.to_affine(ops, PC.jac_mul(ops, gen, rng.randrange(1, RPF.R))) for _ in range(n)]

    def scaled(pt, lam):
        l2 = ops.mul(lam, lam)
        return (ops.mul(pt[0], l2), ops.mul(pt[1], ops.mul(l2, lam)), lam)

    def rand():
        return rng.randrange(1, P) if E == 1 else (rng.randrange(P), rng.randrange(1, P))

    zero = 0 if E == 1 else (0, 0)
    inf = (zero, zero, zero)
    p, q = [], []
    for i in range(n):
        a, b = aff[i], aff[(i + 1) % n]
        lane = {0: (inf, inf), 1: (inf, scaled(a, rand())), 2: (scaled(a, rand()), inf),
                3: (scaled(a, rand()), scaled(a, rand())), 4: (scaled(a, rand()), scaled(b, rand())),
                5: (scaled(a, ops.one), scaled(a, ops.one))}.get(i)
        if lane is None:
            lane = (scaled(a, rand()), scaled(a if i % 2 else b, rand()))
        p.append(lane[0])
        q.append(lane[1])
    planes = [tuple(CV.port_from_ints([pt[c] for pt in side], E) for c in range(3))
              for side in (p, q)]
    want = [True, False, False, True, False, True] + [i % 2 == 1 for i in range(6, n)]
    return planes, want


@pytest.mark.parametrize("E", [1, 2])
def test_jac_eq_mask_matches_the_jax_package(E):
    """jac_eq_mask in its three product levels against _jac_eq_mask on the
    same planes, mask for mask, and against the expected equalities; with
    x1_by, p's X scaled in the first level as the G1 subgroup check scales
    it by β."""
    (p, q), want = _jac_lanes(E)
    n = p[0].shape[-1]
    got = PA.jac_eq_mask(p, q, E)
    ref = RPA._jac_eq_mask(PP.PlanePoint(*map(_jax, p), E, n), PP.PlanePoint(*map(_jax, q), E, n))
    assert np.array_equal(got.numpy(), np.asarray(ref).reshape(-1))
    assert got.tolist() == want
    by = PA.const_plane((3,) if E == 1 else (3, 5), E, n, "cpu")
    scaled = (CP.fe_mul(p[0], by, E), p[1], p[2])
    CP.reset_counts()
    assert torch.equal(PA.jac_eq_mask(p, q, E, x1_by=by), PA.jac_eq_mask(scaled, q, E))
    assert CP.KERNELS["fe_mul"].plain_calls[E] == 6
    assert CP.KERNELS["fe_mul"].cases[E, 3 * n, (n,) * 3] == 1


# ---------------------------------------------------------------------------
# The kernel bodies on the host (g++ through the windowed test's shim)
# ---------------------------------------------------------------------------

# builds: the kernel as built; and the other shapes: products split over 2
# lanes at E = 1 and each Karatsuba product over 4 (or, where the build
# splits them, on a lane each) at E = 2, each up to 64 elements a level and
# one thread (E = 1) or one lane (E = 2) a product past it
with open(CP.SOURCES[0]) as _f:
    _BUILT_T2 = int(re.search(r"^constexpr int kFeMul2Lanes = (\d+);", _f.read(), re.M).group(1))
BUILDS = {"kernel": {},
          "other": {"kFeMul1Lanes": 2, "kFeMul2Lanes": 4 if _BUILT_T2 == 1 else 1,
                    "kFeMul1SplitMax": 64, "kFeMul2SplitMax": 64}}


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory, chip_smoke):
    """plane_kernels.cu of each build compiled by g++ with the windowed
    test's shim, bound as cuda_plane binds the card's."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++: the kernels' host build needs a C++20 compiler")
    out = tmp_path_factory.mktemp("levels_host")
    (out / "cuda_runtime.h").write_text(TW._SHIM)
    (out / "point_schedule.h").write_text(PS.header())
    with open(CP.SOURCES[0]) as f:
        text = f.read()
    procs = {}
    for name, consts in BUILDS.items():
        cpp = out / f"{name}.cpp"
        cpp.write_text(TW.shim_source(chip_smoke.ab_source(text, consts)))
        procs[name] = (out / f"lib{name}.so", subprocess.Popen(
            [gxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", "-w", "-I", str(out),
             "-I", os.path.dirname(CP.SOURCES[0]), "-o", str(out / f"lib{name}.so"), str(cpp)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate(timeout=300)
        assert proc.returncode == 0, log.decode()[-3000:]
        libs[name] = CP.bind(str(lib))
    return libs


# (kernel, E, shape) as chip_smoke.fe_level builds them: a ragged edge in a
# block and two segments of other widths
HOST_LEVELS = [("fe_mul", 1, (300, 37)), ("fe_mul", 1, (130,)), ("fe_mul", 2, (150, 9)),
               ("fe_mul", 2, (40,)), ("fe_addsub", 1, (("add", 300), ("neg", 37), ("sub", 5))),
               ("fe_addsub", 2, (("sub", 130), ("neg", 9)))]


@pytest.mark.parametrize("build", list(BUILDS))
@pytest.mark.parametrize("kernel,E,shape", HOST_LEVELS, ids=lambda v: str(v).replace(" ", ""))
def test_kernel_body_is_the_plain_version(build, kernel, E, shape, host_libs, chip_smoke):
    """charon_fe_mul_level / charon_fe_addsub_level of a host build on CPU
    planes (stream NULL): every segment's words are the plain version's."""
    ops = chip_smoke.fe_level(kernel, E, shape, "cpu", f"host {kernel} {E} {shape}")
    full = ops if kernel == "fe_addsub" else [(None, a, b) for a, b in ops]
    _dev, segs, outs, _key = CP.level_args(kernel, full, E, None)
    lib = host_libs[build]
    assert getattr(lib, f"charon_{kernel}_level")(E, CP.level_table(segs), len(segs), None) == 0
    for k, (got, want) in enumerate(zip(outs, chip_smoke.fe_plain(kernel, E, ops))):
        assert torch.equal(got, want), k


def test_launchers_reject_a_bad_level(host_libs):
    """The C entries refuse what the kernels do not take (an error code,
    nothing launched): no segment, a stride below the width, a null a in a
    product, an Fq2 add/sub level past the table."""
    lib = host_libs["kernel"]
    a = torch.zeros(2, 12, 8, dtype=torch.int32)
    ptr = a.data_ptr()

    def seg(**kw):
        f = dict(a=ptr, b=ptr, o=ptr, n=8, lda=8, ldb=8, ldo=8, op=0)
        f.update(kw)
        return CP.FeSeg(**f)

    assert lib.charon_fe_mul_level(1, (CP.FeSeg * 1)(seg()), 0, None) != 0
    assert lib.charon_fe_mul_level(1, (CP.FeSeg * 1)(seg(lda=4)), 1, None) != 0
    assert lib.charon_fe_mul_level(1, (CP.FeSeg * 1)(seg(a=None)), 1, None) != 0
    assert lib.charon_fe_mul_level(3, (CP.FeSeg * 1)(seg()), 1, None) != 0
    assert lib.charon_fe_addsub_level(2, (CP.FeSeg * 5)(*[seg()] * 5), 5, None) != 0
    assert lib.charon_fe_addsub_level(1, (CP.FeSeg * 1)(seg(op=2)), 1, None) != 0
    assert lib.charon_fe_addsub_level(1, (CP.FeSeg * 1)(seg(a=None)), 1, None) == 0
    assert lib.charon_empty(None) == 0


@pytest.mark.parametrize("const", ["kFeBlock", "kFeMul1Lanes", "kFeMul1SplitMax", "kFeMul2Lanes",
                                   "kFeMul2SplitMax"])
def test_level_constants_patch_the_source(const, chip_smoke):
    """`--ab` sets the field kernels' constants in the source."""
    with open(CP.SOURCES[0]) as f:
        src = f.read()
    out = chip_smoke.ab_source(src, {const: 2})
    assert f"constexpr int {const} = 2;" in out and out != src


def test_ab_times_every_level_of_the_headline_slot(chip_smoke):
    """FE_AB holds every field level of the 1000 × 4-of-6 slot's dispatch
    (1,024 validators a bucket, 4,096 partials), which ab_uncovered checks
    against what the card launched."""
    assert set(chip_smoke.slot_levels(1024, 4096)) <= set(chip_smoke.FE_AB)
    cases = {"fe_mul": {(1, 1024, (1024,)): 3, (1, 4096, (4096,)): 1},
             "fe_addsub": {(1, 2, (("add", 1), ("neg", 1))): 1}}
    assert chip_smoke.ab_uncovered(cases) == [("fe_addsub", 1, (("add", 1), ("neg", 1)))]
