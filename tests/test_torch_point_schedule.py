"""The point kernels' schedules (charon_tpu_torch/ops/point_schedule.py): no
level races with itself, the levels run in order with the port's plain field
ops give exactly the plain point ops and the JAX package's unified add
(_pt_add_unified with its P+P double, run on its CPU path), and the header
that cuda_plane.build() writes is deterministic and names every slot; the
kernel builds that `chip_smoke.py --ab` makes from the source still apply."""

import importlib.util
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from charon_tpu.ops import field as RF
from charon_tpu.ops import pallas_plane as PP
from charon_tpu_torch.ops import convert as CV
from charon_tpu_torch.ops import cuda_plane as CP
from charon_tpu_torch.ops import curve as C
from charon_tpu_torch.ops import field as F
from charon_tpu_torch.ops import point_schedule as PS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 16                       # lanes
PP_LANES = range(4, 9)       # P+P: the add doubles p there
KEYS = sorted(PS.SCHEDULES)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def jit_field():
    """The reference's XLA-op field primitives, jitted once at one padded
    row count, so its CPU point path compiles each primitive once."""
    rows = 512

    def padded(fn):
        jfn = jax.jit(fn)

        def call(*args):
            args = [jnp.asarray(a) for a in args]
            shape = jnp.broadcast_shapes(*[a.shape for a in args])
            flat = [jnp.broadcast_to(a, shape).reshape(-1, shape[-1]) for a in args]
            n = flat[0].shape[0]
            out = jfn(*[jnp.pad(f, ((0, rows - n), (0, 0))) for f in flat])
            return out[:n].reshape(shape)

        return call

    mp = pytest.MonkeyPatch()
    for name in ("fq_add", "fq_sub", "fq_neg", "fq_mont_mul"):
        mp.setattr(RF, name, padded(getattr(RF, name)))
    yield
    mp.undo()


def _inputs(E: int, seed: int):
    """Six (E, 12, N) planes of canonical residues from a numpy seed: lanes
    0-3 and 14-15 P+Q, 4-8 P+P, 9 P+(−P), 10 ∞+Q, 11 P+∞, 12 ∞+∞, 13 an
    all-zero p."""
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 256, size=(6, E, N, 48), dtype=np.uint8)
    vals = [[[int.from_bytes(raw[c, e, i].tobytes(), "little") % F.P_INT for i in range(N)]
             for e in range(E)] for c in range(6)]
    for c in range(3):
        for e in range(E):
            for i in PP_LANES:
                vals[3 + c][e][i] = vals[c][e][i]
            vals[3 + c][e][9] = vals[c][e][9]
    for e in range(E):
        vals[4][e][9] = (F.P_INT - vals[1][e][9]) % F.P_INT
        vals[2][e][10] = vals[5][e][11] = vals[2][e][12] = vals[5][e][12] = 0
        for c in range(3):
            vals[c][e][13] = 0
    return [torch.from_numpy(np.stack([np.stack([F.limbs_from_int(v) for v in vals[c][e]], 1)
                                       for e in range(E)])) for c in range(6)]


def _run(s: PS.Schedule, slots: dict, levels) -> None:
    """The levels in order, each operation on (1, 12, N) Fq planes."""
    def operand(a, b, sub):
        if b == PS.NONE:
            return slots[a]
        return (F.fe_sub_plain if sub else F.fe_add_plain)(slots[a], slots[b], 1)

    for lv in levels:
        for op in lv.ops:
            x, y = operand(op.a, op.b, op.sub_x), operand(op.c, op.d, op.sub_y)
            if lv.kind == PS.MUL:
                slots[op.dst] = F.fe_mul_plain(x, y, 1)
            else:
                slots[op.dst] = (F.fe_sub_plain if op.sub else F.fe_add_plain)(x, y, 1)


def _execute(s: PS.Schedule, ins):
    """What the kernel computes: the schedule on every lane, then for pt_add
    the selects in the reference's order."""
    E = s.E
    slots = {}
    for k, slot in enumerate(s.inputs):
        slots[slot] = ins[k // E][k % E][None].contiguous()
    _run(s, slots, s.levels)

    def coords(tab):
        return [torch.cat([slots[tab[c * E + e]] for e in range(E)]) for c in range(3)]

    out = coords(s.outputs)
    if s.name == "pt_double":
        return out

    def zero(tab):
        return torch.stack([(slots[t] == 0).all(1)[0] for t in tab]).all(0)

    p_inf, q_inf = zero(s.inputs[2 * E:3 * E]), zero(s.inputs[5 * E:6 * E])
    h0, r0 = zero(s.h), zero(s.r)
    P, Q, D = coords(s.inputs[:3 * E]), coords(s.inputs[3 * E:]), coords(s.dbl_outputs)
    res = []
    for c in range(3):
        v = torch.where(r0, D[c], torch.zeros_like(D[c]))
        v = torch.where(h0, v, out[c])
        v = torch.where(q_inf, P[c], v)
        res.append(torch.where(p_inf, Q[c], v))
    return res


@pytest.mark.parametrize("key", KEYS, ids=lambda k: f"{k[0]}<{k[1]}>")
def test_levels_read_only_what_earlier_levels_wrote(key):
    s = PS.SCHEDULES[key]
    # the kernels load component e of coordinate c into slot c·E + e
    assert s.inputs == tuple(range(len(s.inputs)))
    written = set(s.inputs)
    for L, lv in enumerate(s.levels):
        dsts = [op.dst for op in lv.ops]
        reads = {v for op in lv.ops for v in (op.a, op.b, op.c, op.d) if v != PS.NONE}
        assert len(dsts) == len(set(dsts)), f"level {L} writes a slot twice"
        assert not reads & set(dsts), f"level {L} writes a slot it reads"
        assert reads <= written, f"level {L} reads a slot no earlier level wrote"
        assert all(d < s.n_slots for d in dsts) and lv.kind in (PS.MUL, PS.LIN)
        written |= set(dsts)
    products = {("pt_double", 1): (7, 3), ("pt_double", 2): (16, 3),
                ("pt_add", 1): (16, 5), ("pt_add", 2): (44, 5)}[key]
    main = s.levels[:s.main]
    assert (s.products, sum(lv.kind == PS.MUL for lv in main)) == products
    if s.name == "pt_add":
        # what the selects read stays put: no level writes an input, and
        # the double writes neither the sum nor H and R
        assert not set(s.inputs) & {op.dst for lv in s.levels for op in lv.ops}
        kept = set(s.outputs) | set(s.h) | set(s.r)
        assert not kept & {op.dst for lv in s.levels[s.main:] for op in lv.ops}
        assert s.products + sum(len(lv.ops) for lv in s.levels[s.main:]
                                if lv.kind == PS.MUL) == products[0] + (7 if s.E == 1 else 16)


@pytest.mark.parametrize("E", [1, 2])
def test_schedules_give_the_plain_point_ops_and_the_jax_package(E, jit_field):
    ins = _inputs(E, 40 + E)
    dbl = _execute(PS.SCHEDULES[("pt_double", E)], ins)
    add = _execute(PS.SCHEDULES[("pt_add", E)], ins)
    for got, want in zip(dbl, C.pt_double_plain(*ins[:3], E)):
        assert torch.equal(got, want)
    for got, want in zip(add, C.pt_add_plain(*ins, E)):
        assert torch.equal(got, want)
    assert all(int(c[:, :, 9].abs().sum()) == 0 for c in add)          # P + (−P) = ∞
    # the JAX package's unified add: the general sum, the P+P double on
    # lanes 4-8, and the selects
    ref = PP._add_call(*[jnp.asarray(CV.planes_to_jax(t)) for t in ins], E)
    ref = [CV.planes_from_jax(np.asarray(c)) for c in ref]
    for got, want in zip(add, ref):
        assert torch.equal(got, want)
    for got, want in zip(dbl, ref):
        assert torch.equal(got[:, :, PP_LANES.start:PP_LANES.stop],
                           want[:, :, PP_LANES.start:PP_LANES.stop])


def test_header_is_deterministic_and_names_every_slot():
    text = PS.header()
    assert text == PS.header()
    for (name, E), s in PS.SCHEDULES.items():
        kind = {"pt_double": "kPtDouble", "pt_add": "kPtAdd"}[name]
        m = re.search(rf"struct Sched<{kind}, {E}> {{\n    static constexpr int ([^;]*);", text)
        fields = dict(f.split(" = ") for f in m.group(1).split(", "))
        assert int(fields["kSlots"]) == s.n_slots and int(fields["kLevels"]) == len(s.levels)
        block = text[text.index(f"// {name}<{E}>: "):m.start()]
        named = [int(k) for k in re.findall(r"//   slot (\d+): \S", block)]
        assert named == list(range(s.n_slots))
    n_ops = sum(len(lv.ops) for s in PS.SCHEDULES.values() for lv in s.levels)
    assert f"kSchedOps[{n_ops}]" in text
    assert len(re.findall(r"^    SCHED_OP\(\d+, \d+, \d+, \d+, \d+, \d\),  // ", text, re.M)) == n_ops


@pytest.fixture(scope="module")
def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("variant", ["kDoubleG1", "kDoubleG2", "kAddG1", "kAddG2",
                                     "no-arith", "no-linear", "no-products"])
def test_ab_variants_still_patch_the_kernel_source(variant, chip_smoke):
    """Each --ab variant (a group size set, a diagnostic build) finds what it
    patches exactly once in plane_kernels.cu, so it cannot fail on the card
    only."""
    with open(CP.SOURCES[0]) as f:
        src = f.read()
    if variant in chip_smoke.DIAGNOSTICS:
        out = chip_smoke.ab_source(src, {}, chip_smoke.DIAGNOSTICS[variant])
        assert out != src
    else:
        out = chip_smoke.ab_source(src, {variant: 16})
        assert f"constexpr int {variant} = 16;" in out
        assert len(re.findall(rf"\b{variant}\b", out)) >= 3      # set, kernel, block size
    with pytest.raises(ValueError):
        chip_smoke.ab_source(src, {"kNoSuchConstant": 1})
