"""The point kernels' formulas as schedules of Fq operations, and the C
header that `cuda_plane.build()` writes from them.

The CUDA kernels pt_double and pt_add (ops/csrc/plane_kernels.cu) give each
point a group of G threads. The formulas are the reference's
(charon_tpu/ops/pallas_plane.py `_pt_double` :371, dbl-2009-l with a = 0,
and `_pt_add_unified` :389, whose P+P double runs on the lanes that need it),
written here at the granularity of one Fq operation: an Fq2 product is its
three Karatsuba products, an Fq2 square the two of complex squaring, with
their pre-sums in the products' operands and their post-subs as linear
operations. Every operand is a value or a sum or difference of two: an add
or sub of two values is folded into each operand that reads it alone, and
stays an operation of its own only for a reader whose operand is already a
sum, or when the kernel reads it at the end. The operations are grouped into levels: a level is a set of
independent operations of one kind (products, or adds and subs), each
reading and writing numbered Fq slots of a per-point scratch. Thread r of a
group runs operations r, r + G, ... of a level, then the group syncs, so the
critical path is one Fq product per product level: 5 for pt_add<2> (44
products) and 3 for pt_double<2> (16).

Placement: a product goes to the product level after the latest level that
feeds it; an add or sub to the first linear level after its operands, within
the phase of its latest product, or within the last phase of its formula if
only the kernel's reads at the end need it and that phase has a linear
level for it anyway (so it adds no level where it was). Slots: inputs first, in order (the kernels
load component e of coordinate c into slot c·E + e), then each level takes
the lowest free slots; a slot is free once every level that reads its value
has ended, so no level writes a slot that the same level reads, and no two
operations of a level write one slot. Values the kernel reads after the
levels (outputs; for pt_add also both inputs, H, R and the double's
outputs) stay in their slots.

Every value is canonical in [0, p), so this order of the same operations
gives the kernels' earlier outputs bit for bit (ops/curve.py's plain
versions). `SCHEDULES` holds the four schedules as plain data; `header()` is
the header text.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass

NONE = 255          # "no second term" in an operand; no slot has this number
MUL, LIN = "mul", "lin"


@dataclass(frozen=True)
class Op:
    """dst = x·y (product level) or x ± y (linear level; `sub`), where
    x = a, a + b or a − b (b NONE, or `sub_x`) and y likewise from c, d."""

    dst: int
    a: int
    b: int
    c: int
    d: int
    sub_x: bool
    sub_y: bool
    sub: bool
    text: str           # the operation on named values, for the header


@dataclass(frozen=True)
class Level:
    kind: str           # MUL or LIN
    ops: tuple


@dataclass(frozen=True)
class Schedule:
    """One kernel's schedule. Slot tables list Fq slots coordinate-major,
    component-minor: `inputs` X, Y, Z (and X2, Y2, Z2 for pt_add),
    `outputs` X3, Y3, Z3. For pt_add, levels[:main] compute the general sum
    and levels[main:] the double of the first input, and `h`, `r`,
    `dbl_outputs` name the slots of H, R and the double's X3, Y3, Z3."""

    name: str
    E: int
    n_slots: int
    levels: tuple
    main: int
    inputs: tuple
    outputs: tuple
    h: tuple = ()
    r: tuple = ()
    dbl_outputs: tuple = ()
    slot_values: tuple = ()   # per slot, the names of the values it holds in turn

    @property
    def products(self) -> int:
        return sum(len(lv.ops) for lv in self.levels[:self.main] if lv.kind == MUL)


# ---------------------------------------------------------------------------
# Formulas on Fq values
# ---------------------------------------------------------------------------


class _Graph:
    """Fq operations as nodes: ("in",), (MUL, x, y) or (LIN, x, y, sub),
    each operand x = (a, b, sub_x) with b None for a alone. `segment` splits
    pt_add's general sum (0) from its P+P double (1)."""

    def __init__(self, E: int):
        self.E = E
        self.nodes = []       # (name, kind, args, segment)
        self.segment = 0

    def _node(self, name, kind, args=()) -> int:
        self.nodes.append((name, kind, args, self.segment))
        return len(self.nodes) - 1

    def input(self, name: str) -> list:
        return [self._node(self._comp(name, i), "in") for i in range(self.E)]

    def _comp(self, name: str, i: int) -> str:
        return name if self.E == 1 else f"{name}.c{i}"

    def mul_fq(self, name, x, y) -> int:
        x = x if isinstance(x, tuple) else (x, None, False)
        y = y if isinstance(y, tuple) else (y, None, False)
        return self._node(name, MUL, (x, y))

    def lin_fq(self, name, a, b, sub) -> int:
        return self._node(name, LIN, ((a, None, False), (b, None, False), sub))

    # field elements: lists of E Fq nodes
    def add(self, name, a, b):
        return [self.lin_fq(self._comp(name, i), a[i], b[i], False) for i in range(self.E)]

    def sub(self, name, a, b):
        return [self.lin_fq(self._comp(name, i), a[i], b[i], True) for i in range(self.E)]

    def mul(self, name, a, b):
        if self.E == 1:
            return [self.mul_fq(name, a[0], b[0])]
        # Karatsuba (fp.cuh fq2_mul): v0 - v1, (a0 + a1)(b0 + b1) - v0 - v1
        v0 = self.mul_fq(f"{name}.v0", a[0], b[0])
        v1 = self.mul_fq(f"{name}.v1", a[1], b[1])
        s = self.mul_fq(f"{name}.s", (a[0], a[1], False), (b[0], b[1], False))
        c0 = self.lin_fq(f"{name}.c0", v0, v1, True)
        t = self.lin_fq(f"{name}.s-v0", s, v0, True)
        return [c0, self.lin_fq(f"{name}.c1", t, v1, True)]

    def sqr(self, name, a):
        if self.E == 1:
            return [self.mul_fq(name, a[0], a[0])]
        # complex squaring: (a0 + a1)(a0 - a1), 2 a0 a1 (as (a0 + a0) a1:
        # the same canonical value, with no add after the product)
        c0 = self.mul_fq(f"{name}.c0", (a[0], a[1], False), (a[0], a[1], True))
        return [c0, self.mul_fq(f"{name}.c1", (a[0], a[0], False), a[1])]


def _double(g: _Graph, X, Y, Z, pre: str = ""):
    """dbl-2009-l, a = 0 (fp.cuh pt_double, pallas_plane.py _pt_double)."""
    A = g.sqr(pre + "A", X)
    B = g.sqr(pre + "B", Y)
    YZ = g.mul(pre + "YZ", Y, Z)
    XB = g.add(pre + "XB", X, B)
    C = g.sqr(pre + "C", B)
    t = g.sqr(pre + "t", XB)
    D = g.sub(pre + "t-A", t, A)
    D = g.sub(pre + "t-A-C", D, C)
    D = g.add(pre + "D", D, D)
    Ev = g.add(pre + "2A", A, A)
    Ev = g.add(pre + "E", Ev, A)
    Fv = g.sqr(pre + "F", Ev)
    X3 = g.sub(pre + "X3", Fv, g.add(pre + "2D", D, D))
    C8 = g.add(pre + "2C", C, C)
    C8 = g.add(pre + "4C", C8, C8)
    C8 = g.add(pre + "8C", C8, C8)
    Y3 = g.mul(pre + "E(D-X3)", Ev, g.sub(pre + "D-X3", D, X3))
    Y3 = g.sub(pre + "Y3", Y3, C8)
    Z3 = g.add(pre + "Z3", YZ, YZ)
    return X3, Y3, Z3


def _add(g: _Graph, P, Q):
    """The unified add's general sum (fp.cuh pt_add, pallas_plane.py
    _pt_add_unified); returns (X3, Y3, Z3, H, R)."""
    X1, Y1, Z1 = P
    X2, Y2, Z2 = Q
    Z1Z1 = g.sqr("Z1Z1", Z1)
    Z2Z2 = g.sqr("Z2Z2", Z2)
    Z1Z2 = g.mul("Z1Z2", Z1, Z2)
    U1 = g.mul("U1", X1, Z2Z2)
    U2 = g.mul("U2", X2, Z1Z1)
    Y1Z2 = g.mul("Y1Z2", Y1, Z2)
    Y2Z1 = g.mul("Y2Z1", Y2, Z1)
    S1 = g.mul("S1", Y1Z2, Z2Z2)
    S2 = g.mul("S2", Y2Z1, Z1Z1)
    H = g.sub("H", U2, U1)
    R = g.sub("R", S2, S1)
    HH = g.sqr("HH", H)
    RR = g.sqr("RR", R)
    HHH = g.mul("HHH", H, HH)
    V = g.mul("V", U1, HH)
    Z3 = g.mul("Z3", Z1Z2, H)
    X3 = g.sub("RR-HHH", RR, HHH)
    X3 = g.sub("X3", X3, g.add("2V", V, V))
    Y3 = g.mul("R(V-X3)", R, g.sub("V-X3", V, X3))
    Y3 = g.sub("Y3", Y3, g.mul("S1*HHH", S1, HHH))
    return X3, Y3, Z3, H, R


# ---------------------------------------------------------------------------
# Levels and slots
# ---------------------------------------------------------------------------


def _args(node):
    name, kind, args, _seg = node
    if kind == "in":
        return []
    x, y = args[0], args[1]
    return [v for v in (x[0], x[1], y[0], y[1]) if v is not None]


def _fuse(g: _Graph) -> None:
    """Fold each single-term add or sub into the operands that read it: an
    operand that is one value computed as a ± b becomes the term a ± b, so
    its consumer computes it and needs no level of its own for it."""
    for i, (name, kind, args, seg) in enumerate(g.nodes):
        if kind == "in":
            continue
        new = list(args)
        for k in (0, 1):
            a, b, _sub = args[k]
            src = g.nodes[a]
            if b is None and src[1] == LIN and src[2][0][1] is None and src[2][1][1] is None:
                new[k] = (src[2][0][0], src[2][1][0], src[2][2])
        g.nodes[i] = (name, kind, tuple(new), seg)


def _needed(g: _Graph, roots) -> set:
    """The nodes the roots are computed from, roots included."""
    seen, todo = set(), list(roots)
    while todo:
        v = todo.pop()
        if v not in seen:
            seen.add(v)
            todo += _args(g.nodes[v])
    return seen


def _positions(g: _Graph, needed: set, deferred=frozenset(), last=None) -> dict:
    """(phase, sublevel) of each needed node (module docstring): products at
    sublevel 0; the adds and subs in `deferred` in phase last[segment]."""
    pos = {}
    for i in sorted(needed):
        node = g.nodes[i]
        if node[1] == "in":
            pos[i] = (0, 0)
            continue
        srcs = [pos[j] for j in _args(node)]
        phase = max(p for p, _ in srcs)
        if node[1] == MUL:
            pos[i] = (phase + 1, 0)
            continue
        if i in deferred:
            phase = last[node[3]]
        pos[i] = (phase, 1 + max((s for p, s in srcs if p == phase), default=0))
    return pos


def _levels(g: _Graph, needed: set) -> list:
    """[(kind, [node ids])] of the needed operations, per segment in order:
    each at its (phase, sublevel) position (module docstring)."""
    ops = [i for i, n in enumerate(g.nodes) if i in needed and n[1] != "in"]
    readers = {i: [] for i in needed}
    for i in ops:
        for j in _args(g.nodes[i]):
            readers[j].append(i)
    late = set()
    for i in reversed(ops):
        if g.nodes[i][1] == LIN and all(r in late for r in readers[i]):
            late.add(i)

    # the last product phase of each segment (deferring moves no product)
    pos, last = _positions(g, needed), {}
    for i in ops:
        seg = g.nodes[i][3]
        last[seg] = max(last.get(seg, 0), pos[i][0])

    def n_levels(deferred):
        pos = _positions(g, needed, deferred, last)
        return len({(g.nodes[i][3], pos[i]) for i in ops})

    deferred = set()
    for i in sorted(late):
        if n_levels(deferred | {i}) <= n_levels(deferred):
            deferred.add(i)
    pos = _positions(g, needed, deferred, last)
    out = []
    for seg in sorted({g.nodes[i][3] for i in ops}):
        keys = sorted({pos[i] for i in ops if g.nodes[i][3] == seg})
        for key in keys:
            ids = [i for i in ops if g.nodes[i][3] == seg and pos[i] == key]
            out.append((MUL if key[1] == 0 else LIN, ids, seg))
    return out


def _build(name: str, g: _Graph, inputs, outputs, extra_live=(), h=(), r=(),
           dbl_outputs=()) -> Schedule:
    _fuse(g)
    kept = (*inputs, *outputs, *extra_live)
    levels = _levels(g, _needed(g, kept))
    n_main = sum(seg == 0 for _k, _ids, seg in levels)
    end = len(levels)
    last = {}
    for L, (_kind, ids, _seg) in enumerate(levels):
        for i in ids:
            for j in _args(g.nodes[i]):
                last[j] = L
    for v in kept:
        last[v] = end
    slot_of, free, n_slots = {}, [], 0
    slot_values = {}

    def take(v):
        nonlocal n_slots
        if free:
            s = heapq.heappop(free)
        else:
            s, n_slots = n_slots, n_slots + 1
        slot_of[v] = s
        slot_values.setdefault(s, []).append(g.nodes[v][0])

    for v in inputs:
        take(v)
    freed_at = {}
    for v, L in last.items():
        freed_at.setdefault(L, []).append(v)
    out_levels = []
    for L, (kind, ids, _seg) in enumerate(levels):
        for v in freed_at.get(L - 1, ()):
            heapq.heappush(free, slot_of[v])
        for i in ids:
            if i not in last:
                raise ValueError(f"{name}: value {g.nodes[i][0]} is never read")
            take(i)
        ops = []
        for i in ids:
            vname, _k, args, _seg = g.nodes[i]
            x, y = args[0], args[1]

            def sl(v):
                return NONE if v is None else slot_of[v]

            def term(t):
                nm = g.nodes[t[0]][0]
                return nm if t[1] is None else f"({nm} {'-' if t[2] else '+'} {g.nodes[t[1]][0]})"

            sub = kind == LIN and args[2]
            sym = "*" if kind == MUL else ("-" if sub else "+")
            ops.append(Op(slot_of[i], sl(x[0]), sl(x[1]), sl(y[0]), sl(y[1]), bool(x[2]),
                          bool(y[2]), bool(sub), f"{vname} = {term(x)} {sym} {term(y)}"))
        out_levels.append(Level(kind, tuple(ops)))
    if n_slots >= NONE:
        raise ValueError(f"{name}: {n_slots} slots do not fit a byte")

    def slots(vs):
        return tuple(slot_of[v] for v in vs)

    return Schedule(name, g.E, n_slots, tuple(out_levels), n_main, slots(inputs),
                    slots(outputs), slots(h), slots(r), slots(dbl_outputs),
                    tuple(tuple(slot_values[s]) for s in range(n_slots)))


def pt_double_schedule(E: int) -> Schedule:
    g = _Graph(E)
    X, Y, Z = g.input("X"), g.input("Y"), g.input("Z")
    out = _double(g, X, Y, Z)
    return _build("pt_double", g, X + Y + Z, [v for c in out for v in c])


def pt_add_schedule(E: int) -> Schedule:
    g = _Graph(E)
    P = [g.input(n) for n in ("X1", "Y1", "Z1")]
    Q = [g.input(n) for n in ("X2", "Y2", "Z2")]
    X3, Y3, Z3, H, R = _add(g, P, Q)
    g.segment = 1
    dbl = _double(g, *P, pre="dbl.")
    ins = [v for c in P + Q for v in c]
    outs = X3 + Y3 + Z3
    dbl_outs = [v for c in dbl for v in c]
    return _build("pt_add", g, ins, outs, extra_live=H + R + dbl_outs, h=H, r=R,
                  dbl_outputs=dbl_outs)


SCHEDULES = {(name, E): fn(E) for E in (1, 2)
             for name, fn in (("pt_double", pt_double_schedule), ("pt_add", pt_add_schedule))}


# ---------------------------------------------------------------------------
# The header
# ---------------------------------------------------------------------------

_KIND = {"pt_double": "kPtDouble", "pt_add": "kPtAdd"}


def header() -> str:
    """The C header of the four schedules: one table of levels, one of
    operations and one of slot lists for all of them, and a traits
    specialisation per (kernel, E) with its offsets into those tables."""
    lines = [
        "// Generated from charon_tpu_torch/ops/point_schedule.py by",
        "// charon_tpu_torch/ops/cuda_plane.py build(); do not edit.",
        "#pragma once",
        "",
        "#include <stdint.h>",
        "",
        "// An operation, one word: dst = x * y (product level) or x +/- y (linear",
        "// level, flag 4), where x = a, a + b or a - b (b = kSchedNone, or flag 1)",
        "// and y likewise from c, d (flag 2); operands and dst are Fq slots of the",
        "// point. A level, one word: operations [first, first + count), products",
        "// (mul 1) or adds and subs (mul 0).",
        "#define SCHED_OP(dst, a, b, c, d, flags)                                      \\",
        "    ((uint64_t)(dst) | (uint64_t)(a) << 8 | (uint64_t)(b) << 16 |             \\",
        "     (uint64_t)(c) << 24 | (uint64_t)(d) << 32 | (uint64_t)(flags) << 40)",
        "#define SCHED_LEVEL(first, count, mul) \\",
        "    ((uint32_t)(first) | (uint32_t)(count) << 16 | (uint32_t)(mul) << 24)",
        "enum SchedKind { kPtDouble, kPtAdd };",
        "template <SchedKind K, int E>",
        "struct Sched;",
        f"constexpr int kSchedNone = {NONE};",
        "",
    ]
    levels, ops, slots, traits = [], [], [], []
    n_entries = 0
    for (name, E), s in SCHEDULES.items():
        tag = f"{name}<{E}>"
        lv0 = len(levels)
        n_mul = sum(lv.kind == MUL for lv in s.levels[:s.main])
        traits.append(f"// {tag}: {s.products} Fq products in {n_mul} product levels, "
                      f"{s.main} levels")
        if s.main < len(s.levels):
            traits.append(f"// (+ {len(s.levels) - s.main} levels of the P+P double), "
                          f"{s.n_slots} slots")
        else:
            traits.append(f"// {s.n_slots} slots")
        for k, names in enumerate(s.slot_values):
            traits.append(f"//   slot {k}: {', '.join(names)}")
        for L, lv in enumerate(s.levels):
            levels.append(f"    SCHED_LEVEL({len(ops)}, {len(lv.ops)}, {int(lv.kind == MUL)}),  "
                          f"// {tag} level {L}")
            for op in lv.ops:
                flags = int(op.sub_x) | 2 * int(op.sub_y) | 4 * int(op.sub)
                ops.append(f"    SCHED_OP({op.dst}, {op.a}, {op.b}, {op.c}, {op.d}, {flags}),  "
                           f"// {op.text}")
        offs = {}
        for key, tab in (("kIn", s.inputs), ("kOut", s.outputs), ("kH", s.h), ("kR", s.r),
                         ("kDblOut", s.dbl_outputs)):
            if tab:
                offs[key] = n_entries
                n_entries += len(tab)
                slots.append(f"    {', '.join(map(str, tab))},  // {tag} {key[1:]}")
        fields = [f"kSlots = {s.n_slots}", f"kLevel0 = {lv0}", f"kMain = {s.main}",
                  f"kLevels = {len(s.levels)}"] + [f"{k} = {v}" for k, v in offs.items()]
        traits.append(f"template <>\nstruct Sched<{_KIND[name]}, {E}> {{")
        traits.append(f"    static constexpr int {', '.join(fields)};")
        traits.append("};")
        traits.append("")

    if len(ops) >= 1 << 16 or max(len(lv.ops) for s in SCHEDULES.values()
                                   for lv in s.levels) >= 1 << 8:
        raise ValueError("the level words hold 16-bit offsets and 8-bit counts")
    lines += [f"__constant__ const uint32_t kSchedLevels[{len(levels)}] = {{", *levels, "};",
              f"__constant__ const uint64_t kSchedOps[{len(ops)}] = {{", *ops, "};",
              f"__constant__ const uint8_t kSchedSlots[{n_entries}] = {{", *slots, "};",
              "", *traits]
    return "\n".join(lines)
