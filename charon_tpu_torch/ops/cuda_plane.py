"""The port's counterpart of charon_tpu/ops/pallas_plane.py: build and bind
the CUDA kernels, the kernel wrappers, and the composite loops over them.

Kernels (ops/csrc/plane_kernels.cu, sm_90a, over `(E, 12, n)` int32 limb
planes — see ops/field.py for the layout — or over `(n, 12)` rows, see
ops/rows.py):

    fe_mul                                        for E in {1, 2}, a level of independent
                                                  products a launch: E = 1 each split over a
                                                  group of lanes up to a width, E = 2 the
                                                  three Karatsuba products on their own lanes
    fe_addsub                                     a level of adds, subs and negations (0 − b)
                                                  a launch, a thread per Fq component
    pt_double, pt_add                             for E in {1, 2}, a group of threads
                                                  per point (ops/point_schedule.py)
    fe_mul_rows                                   rows: E = 1 a thread per row; E = 2
                                                  (Fq2 rows, whole Karatsuba products) a
                                                  group of 4 lanes per product
    fe_add_rows                                   rows, a thread per row: adds below a
                                                  split and subtracts past it (n_add = 0:
                                                  a subtraction, also −a as 0 − a)
    fe_pow                                        a fixed-exponent power scan in one
                                                  launch over a (1, 12, n) plane or
                                                  (n, 12) rows: each product split over
                                                  a group of 4 lanes up to 8,192
                                                  elements, a thread an element past it
    pt_mul_shared, pt_mul_windowed                for E in {1, 2}: k·P for one host-known
                                                  scalar, and per-element k·P from 4-bit
                                                  digits, each in one launch, walking the
                                                  point kernels' schedules: pt_mul_shared
                                                  a group of threads per point (products
                                                  split over 4 lanes each), pt_mul_windowed
                                                  a point a lane, a level's operations on
                                                  the block's ranks of lanes
    pt_reduce_groups                              for E in {1, 2}: per-group sums of a plane
                                                  (a group id a lane) in two launches, on
                                                  pt_mul_windowed's add and block shape

Build: the point schedules' header into `build/charon_tpu_torch/`, then
`nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -I build/charon_tpu_torch`
into `build/charon_tpu_torch/libplane.so` under the repo root, at the first
launch (`build()`), loaded with ctypes. Nothing is built or imported from
CUDA when this module is imported.

Wrappers check device, dtype, shape and contiguity and raise on anything
else. A CPU tensor runs the kernel's plain version (ops/field.py,
ops/curve.py) and counts a plain call; a CUDA tensor launches the kernel on
the current stream and counts a launch — or raises DeviceError (its
launcher returned a CUDA error): a wrapper has no fallback, and the guard
(ops/guard.py) lands no launch failure on the native rung.
The field kernels take a level (`mul_level`, `addsub_level`): up to
LEVEL_SEGS independent operations of one kind and one E, each on its own
(E, 12, n) views whose lanes are contiguous and whose limb rows may be a
wider plane's (a lane slice, or one component of an Fq2 plane), read and
written in place; one launch, or one plain call on the CPU. `fe_mul`,
`fe_add`, `fe_sub` and `fe_neg` are levels of one operation.

Composites: `pow_scan` (_pow_scan :593) is one fe_pow launch, `shared_mul`
(_shared_mul_call :625, and the cofactor clear of h2c._clear_cofactor) one
pt_mul_shared launch and `scalar_mul_windowed` (_scalar_mul_windowed :677)
one pt_mul_windowed launch; `reduce_groups` (a mask a group,
_reduce_tree_jit :763 and _host_fold :778, for every group at once) is one
pt_reduce_groups call, and `host_points` reads its sums back as host
Jacobians. Bucket sizes (`pad_batch`), the 4-bit windows
and the MSB-first digit order are the reference's: they decide the outputs'
shapes.
"""

from __future__ import annotations

import collections
import ctypes
import os
import subprocess
import threading
import time

import numpy as np
import torch

from . import curve as C
from . import field as F
from . import point_schedule as PS

LIMBS = F.LIMBS
SUB = 8            # the reference's sublanes: batch b sits at (b // W, b % W)
TW = 128           # the reference's lanes per tile
TILE = SUB * TW
MIN_TILE = 128     # smallest batch bucket
WINDOW = 4         # scalar-multiplication window bits
POW_WINDOW = 4     # fixed-exponent power-scan window bits

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
SOURCES = (os.path.join(CSRC, "plane_kernels.cu"), os.path.join(CSRC, "fp.cuh"),
           os.path.abspath(PS.__file__))
BUILD_DIR = os.path.join(_REPO_ROOT, "build", "charon_tpu_torch")
LIB_PATH = os.path.join(BUILD_DIR, "libplane.so")
SCHEDULE_HEADER = os.path.join(BUILD_DIR, "point_schedule.h")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def pad_batch(n: int) -> int:
    """Batch -> padded plane size (the reference's buckets): MIN_TILE
    multiples up to one 1024 tile, whole tiles above."""
    floor = min(TILE, MIN_TILE)
    b = ((max(n, 1) + floor - 1) // floor) * floor
    if b > TILE and b % TILE:
        b = ((b + TILE - 1) // TILE) * TILE
    return b


# ---------------------------------------------------------------------------
# Build and bind
# ---------------------------------------------------------------------------


class BuildInfo:
    """What the last build did: seconds spent and nvcc's -Xptxas -v report."""

    seconds: float = 0.0
    log: str = ""


BUILD = BuildInfo()
_build_lock = threading.Lock()
_lib: list = []

_VP = ctypes.c_void_p
_LL = ctypes.c_longlong
_ARGS = {
    "charon_fe_mul_level": [ctypes.c_int, _VP, ctypes.c_int, _VP],
    "charon_fe_addsub_level": [ctypes.c_int, _VP, ctypes.c_int, _VP],
    "charon_empty": [_VP],
    "charon_pt_double": [ctypes.c_int] + [_VP] * 6 + [_LL, _VP],
    "charon_pt_add": [ctypes.c_int] + [_VP] * 9 + [_LL, _VP],
    "charon_fe_mul_rows": [_VP, _VP, _VP, _LL, ctypes.c_int, _VP],
    "charon_fe_add_rows": [_VP, _VP, _VP, _LL, _LL, _VP],
    "charon_fe_pow": [ctypes.c_int, _VP, _VP, _LL, ctypes.c_char_p, ctypes.c_int, _VP],
    "charon_pt_mul_shared": [ctypes.c_int] + [_VP] * 6 + [_LL, ctypes.c_char_p, ctypes.c_int, _VP],
    "charon_pt_mul_windowed": [ctypes.c_int] + [_VP] * 6 + [_LL, _VP, ctypes.c_int, _VP],
    "charon_pt_reduce_groups": [ctypes.c_int] + [_VP] * 4 + [_LL, ctypes.c_int] + [_VP] * 5,
}


class DeviceError(RuntimeError):
    """A kernel did not launch (its launcher returned a CUDA error: an
    invalid configuration, too many resources, no image for the card): a
    defect of the kernel or its build, which ops/guard.py classifies as
    "launch" and never lands on the native rung, as it does a failed build
    (subprocess.CalledProcessError)."""


def nvcc() -> str:
    path = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    return path if os.path.exists(path) else "nvcc"


def build(force: bool = False) -> str:
    """Compile the kernels with nvcc unless the library is newer than every
    source: first the point schedules' header (ops/point_schedule.py) into
    BUILD_DIR, then the library. Returns the library path; raises
    CalledProcessError with nvcc's output when the build fails."""
    with _build_lock:
        fresh = (os.path.exists(LIB_PATH) and not force and
                 os.path.getmtime(LIB_PATH) >= max(os.path.getmtime(s) for s in SOURCES))
        if fresh:
            return LIB_PATH
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp_h = f"{SCHEDULE_HEADER}.{os.getpid()}.tmp"
        with open(tmp_h, "w") as f:
            f.write(PS.header())
        os.replace(tmp_h, SCHEDULE_HEADER)
        tmp = LIB_PATH + f".{os.getpid()}.tmp"
        t0 = time.perf_counter()
        proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-I", BUILD_DIR, "-o", tmp, SOURCES[0]],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            raise subprocess.CalledProcessError(proc.returncode, proc.args,
                                                proc.stdout, proc.stderr)
        os.replace(tmp, LIB_PATH)
        BUILD.seconds = time.perf_counter() - t0
        BUILD.log = proc.stdout + proc.stderr
        return LIB_PATH


def bind(path: str, strict: bool = True) -> ctypes.CDLL:
    """Load a built library and declare its C interface; strict=False skips
    the launchers it lacks (an older tree's, for an A/B)."""
    lib = ctypes.CDLL(path)
    for name, argtypes in _ARGS.items():
        if not strict and not hasattr(lib, name):
            continue
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def _library() -> ctypes.CDLL:
    if not _lib:
        path = build()
        with _build_lock:
            if not _lib:
                _lib.append(bind(path))
    return _lib[0]


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


class Kernel:
    """One CUDA kernel: where its source is, which TPU kernel (or, for the
    rows add, which XLA-op function; for the scalar multiplications, which
    composite of point kernels) it replaces, and how often it ran, per
    variant: E for most (fe_add_rows has E = 1 only), the layout ("plane",
    "rows") for fe_pow. `launches` counts CUDA launches only, `widths` the
    launches by (variant, width) (rows: Fq or Fq2 rows); `plain_calls` counts
    CPU calls of its plain version. `replaces` is a site, or one per variant."""

    def __init__(self, name: str, replaces, variants=(1, 2)):
        self.name = name
        self.replaces = replaces
        self.source = "charon_tpu_torch/ops/csrc/plane_kernels.cu"
        self.variants = tuple(variants)
        self.reset()

    def site(self, variant) -> str:
        """The replaced kernel's file:line for one variant."""
        return self.replaces[variant] if isinstance(self.replaces, dict) else self.replaces

    def reset(self) -> None:
        with _count_lock:
            self.launches = {E: 0 for E in self.variants}
            self.plain_calls = {E: 0 for E in self.variants}
            self.widths = collections.Counter()     # launches by (E, width)
            # calls (launches, or plain calls on the CPU) by (variant, width,
            # extra): the field levels by (E, total width, the segments'
            # widths (fe_mul) or (operation, width) pairs (fe_addsub)),
            # fe_add_rows' calls that subtract by (1, rows, n_add), fe_pow's
            # by (layout, width, digits), pt_mul_shared's by (E, width, k),
            # pt_mul_windowed's by (E, width, windows)
            self.cases = collections.Counter()

    def count(self, variant, width: int | None = None, case=None, plain: bool = False) -> None:
        """Count one call: a plain call (plain=True) or a launch at `width`,
        and, where given, its case. Device work runs on several threads
        (the slot thread of the submit front door beside the callers' own),
        so every read-modify-write of the counters holds one lock: the exact
        counts that tests and chip_smoke.py pin stay exact."""
        with _count_lock:
            if case is not None:
                self.cases[case] += 1
            if plain:
                self.plain_calls[variant] += 1
            elif width is not None:
                self.launches[variant] += 1
                self.widths[variant, width] += 1


_count_lock = threading.Lock()

KERNELS = {
    "fe_mul": Kernel("fe_mul", "charon_tpu/ops/pallas_plane.py:458"),        # _kern_mul
    # _kern_addp and _kern_sub (fe_neg is 0 − b), one site an operation
    "fe_addsub": Kernel("fe_addsub", {"add": "charon_tpu/ops/pallas_plane.py:452",
                                      "sub": "charon_tpu/ops/pallas_plane.py:446"}),
    "pt_double": Kernel("pt_double", "charon_tpu/ops/pallas_plane.py:433"),  # _kern_double
    "pt_add": Kernel("pt_add", "charon_tpu/ops/pallas_plane.py:439"),        # _kern_add
    # _kern_mul as _mont_rows_call launches it (its pallas_call at :982);
    # E = 2 with the adds and subs of curve._fq2_mul_many
    "fe_mul_rows": Kernel("fe_mul_rows", "charon_tpu/ops/pallas_plane.py:969"),
    # XLA-op field.fq_add / fq_sub (and fq_neg) of the rows plane
    "fe_add_rows": Kernel("fe_add_rows", "charon_tpu/ops/field.py:134", (1,)),
    # the power scans: _pow_scan over _mul_call on planes; on rows the scans
    # of tower.fq_inv (:105) and h2c._fq_pow_scan (:91) over the rows product
    "fe_pow": Kernel("fe_pow", {"plane": "charon_tpu/ops/pallas_plane.py:593",
                                "rows": "charon_tpu/ops/tower.py:105"}, ("plane", "rows")),
    # the composites of _kern_double and _kern_add, each one launch: k·P for
    # one host-known scalar (_shared_mul_call; at E = 2 the main path's use
    # is the cofactor clear, h2c._clear_cofactor) and per-element k·P from
    # digit planes (_scalar_mul_windowed)
    "pt_mul_shared": Kernel("pt_mul_shared", {1: "charon_tpu/ops/pallas_plane.py:625",
                                              2: "charon_tpu/ops/h2c.py:216"}),
    "pt_mul_windowed": Kernel("pt_mul_windowed", "charon_tpu/ops/pallas_plane.py:677"),
    # the masked per-group reduction: a jnp.where mask a group, then
    # _reduce_tree_jit's pt_add levels and _host_fold (:778); a call, its two
    # launches, counts one; E = 1 the DKG's group sums, E = 2 the sigagg
    # paths' combined MSM (the slot, the bulk verify's chunks)
    "pt_reduce_groups": Kernel("pt_reduce_groups", "charon_tpu/ops/pallas_plane.py:763"),
}


def reset_counts() -> None:
    for k in KERNELS.values():
        k.reset()


def _check(tensors, E: int) -> torch.device:
    if E not in (1, 2):
        raise ValueError(f"E must be 1 or 2, got {E}")
    first = tensors[0]
    if first.dim() != 3 or first.shape[0] != E or first.shape[1] != LIMBS or first.shape[2] < 1:
        raise ValueError(f"expected an ({E}, {LIMBS}, n) plane, got {tuple(first.shape)}")
    for t in tensors:
        if t.dtype != torch.int32:
            raise TypeError(f"planes must be int32, got {t.dtype}")
        if t.shape != first.shape:
            raise ValueError(f"plane shapes differ: {tuple(t.shape)} vs {tuple(first.shape)}")
        if t.device != first.device:
            raise ValueError("planes are on different devices")
        if not t.is_contiguous():
            raise ValueError("planes must be contiguous")
    if first.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {first.device}")
    return first.device


def call(lib: ctypes.CDLL, name: str, E: int, ins, n_out: int, args=()):
    """Launch charon_<name> of a bound library on CUDA planes, with the
    launcher's own arguments after n (the scalar multiplications' scalar
    or digits), on the current stream of their device, and return the new
    output planes."""
    outs = [torch.empty_like(ins[0]) for _ in range(n_out)]
    fn = getattr(lib, "charon_" + name)
    with torch.cuda.device(ins[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(E, *[t.data_ptr() for t in ins], *[t.data_ptr() for t in outs],
                ins[0].shape[2], *args, stream)
    if rc != 0:
        raise DeviceError(f"CUDA kernel {name}<{E}> did not launch: error {rc}")
    return outs


def _launch(name: str, E: int, ins, n_out: int, args=(), case=None):
    outs = call(_library(), name, E, ins, n_out, args)
    KERNELS[name].count(E, ins[0].shape[2], case)
    return outs


def launch_rows(name: str, a: torch.Tensor, b: torch.Tensor, E: int, args=()) -> torch.Tensor:
    """Launch charon_<name>(a, b, out, n, *args, stream) on checked,
    contiguous, 16-byte aligned CUDA rows (ops/rows.py), n = numel / (12 E)
    rows, on the current stream of the rows' device; counts the launch under
    E and its width."""
    if a.device.index != torch.cuda.current_device():
        with torch.cuda.device(a.device):
            return launch_rows(name, a, b, E, args)
    out = torch.empty_like(a)
    n = a.numel() // (E * LIMBS)
    rc = getattr(_library(), "charon_" + name)(a.data_ptr(), b.data_ptr(), out.data_ptr(), n,
                                               *args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise DeviceError(f"CUDA kernel {name}<{E}> did not launch: error {rc}")
    KERNELS[name].count(E, n)
    return out


# ---------------------------------------------------------------------------
# The field kernels: a level of independent operations a launch
# ---------------------------------------------------------------------------

LEVEL_SEGS = 8          # segments a level (kLevelSegs); an Fq2 add/sub takes two
ADDSUB_OPS = {"add": 0, "sub": 1, "neg": 1}     # neg: 0 − b, no a


class FeSeg(ctypes.Structure):
    """One segment of a level, as charon_fe_*_level take it: limb j of
    component e of element i of an operand at word [(e·12 + j)·ld + i]."""

    _fields_ = [("a", _VP), ("b", _VP), ("o", _VP), ("n", _LL), ("lda", _LL), ("ldb", _LL),
                ("ldo", _LL), ("op", ctypes.c_int)]


def _operand(t: torch.Tensor, E: int, n: int | None, device) -> int:
    """Check one operand view of a level; returns its limb stride."""
    if t.dtype != torch.int32:
        raise TypeError(f"planes must be int32, got {t.dtype}")
    if t.dim() != 3 or t.shape[0] != E or t.shape[1] != LIMBS or t.shape[2] < 1:
        raise ValueError(f"expected an ({E}, {LIMBS}, n) plane, got {tuple(t.shape)}")
    if n is not None and t.shape[2] != n:
        raise ValueError(f"plane widths differ: {t.shape[2]} vs {n}")
    if device is not None and t.device != device:
        raise ValueError("planes are on different devices")
    ld = t.stride(1)
    if t.stride(2) != 1 or ld < t.shape[2] or (E == 2 and t.stride(0) != LIMBS * ld):
        raise ValueError(f"planes must be contiguous along the lanes, limb rows at least a "
                         f"row apart and Fq2 components 12 rows apart: strides {t.stride()}")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    return ld


def level_args(kind: str, ops, E: int, outs):
    """Check a level [(op, a, b)] (op None for fe_mul; a None for a
    negation) and its outputs (None: new planes); returns (device, the
    segment table, the outputs, the case key)."""
    if E not in (1, 2):
        raise ValueError(f"E must be 1 or 2, got {E}")
    if not 1 <= len(ops) * (E if kind == "fe_addsub" else 1) <= LEVEL_SEGS:
        raise ValueError(f"a level holds 1 to {LEVEL_SEGS} Fq{'' if E == 1 else '2'} segments "
                         f"of {kind}, got {len(ops)}")
    outs = list(outs) if outs is not None else [None] * len(ops)
    if len(outs) != len(ops):
        raise ValueError("one output a segment")
    device, segs = None, []
    for k, (op, a, b) in enumerate(ops):
        if kind == "fe_addsub" and op not in ADDSUB_OPS:
            raise ValueError(f"operation must be one of {tuple(ADDSUB_OPS)}, got {op!r}")
        if (a is None) != (op == "neg"):
            raise ValueError("a negation takes b alone, every other operation a and b")
        ldb = _operand(b, E, None, device)
        device, n = b.device, b.shape[2]
        lda = _operand(a, E, n, device) if a is not None else ldb
        if outs[k] is None:
            outs[k] = torch.empty((E, LIMBS, n), dtype=torch.int32, device=device)
        ldo = _operand(outs[k], E, n, device)
        segs.append((a, b, outs[k], n, lda, ldb, ldo, ADDSUB_OPS.get(op, 0)))
    shape = tuple(s[3] for s in segs) if kind == "fe_mul" else \
        tuple((op, s[3]) for (op, _a, _b), s in zip(ops, segs))
    return device, segs, outs, (E, sum(s[3] for s in segs), shape)


def level_table(segs) -> ctypes.Array:
    """The ctypes segment table of a checked level."""
    return (FeSeg * len(segs))(*[
        FeSeg(a.data_ptr() if a is not None else None, b.data_ptr(), o.data_ptr(), n, lda, ldb,
              ldo, op) for a, b, o, n, lda, ldb, ldo, op in segs])


def call_level(lib: ctypes.CDLL, kind: str, E: int, segs) -> None:
    """Launch charon_<kind>_level of a bound library over a checked level's
    CUDA segments on the current stream of their device, without counting."""
    with torch.cuda.device(segs[0][1].device):
        rc = getattr(lib, f"charon_{kind}_level")(E, level_table(segs), len(segs),
                                                 torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise DeviceError(f"CUDA kernel {kind}<{E}> did not launch: error {rc}")


def level_plain(op, a, b, E: int) -> torch.Tensor:
    """One segment's plain version: the product (op None), (a + b), (a − b)
    or −b (a None) mod p per component."""
    a = torch.zeros_like(b) if a is None else a.contiguous()
    if op is None:
        return F.fe_mul_plain(a, b.contiguous(), E)
    return (F.fe_add_plain if op == "add" else F.fe_sub_plain)(a, b.contiguous(), E)


def _run_level(kind: str, ops, E: int, outs) -> list:
    device, segs, outs, key = level_args(kind, ops, E, outs)
    kern = KERNELS[kind]
    if device.type == "cpu":
        kern.count(E, case=key, plain=True)
        for (op, a, b), o in zip(ops, outs):
            o.copy_(level_plain(op, a, b, E))
        return outs
    call_level(_library(), kind, E, segs)
    kern.count(E, key[1], case=key)
    return outs


def mul_level(ops, E: int, outs=None) -> list:
    """a·b·R⁻¹ mod p for each (a, b) of a level of independent products over
    (E, 12, n) Montgomery views (E = 2: Fq2): one fe_mul launch (a plain
    call on the CPU). `outs`, where given, holds each segment's output view
    (None: a new plane). Returns the outputs."""
    return _run_level("fe_mul", [(None, a, b) for a, b in ops], E, outs)


def addsub_level(ops, E: int, outs=None) -> list:
    """A level of independent (op, a, b): "add" (a + b) mod p, "sub" (a − b)
    mod p, "neg" −b mod p (a None), per component: one fe_addsub launch (a
    plain call on the CPU). Returns the outputs."""
    return _run_level("fe_addsub", ops, E, outs)


def fe_mul(a: torch.Tensor, b: torch.Tensor, E: int) -> torch.Tensor:
    """a·b·R⁻¹ mod p over (E, 12, n) Montgomery planes (E=2: Fq2)."""
    return mul_level([(a, b)], E)[0]


def fe_add(a: torch.Tensor, b: torch.Tensor, E: int) -> torch.Tensor:
    """(a + b) mod p per component."""
    return addsub_level([("add", a, b)], E)[0]


def fe_sub(a: torch.Tensor, b: torch.Tensor, E: int) -> torch.Tensor:
    """(a − b) mod p per component."""
    return addsub_level([("sub", a, b)], E)[0]


def fe_neg(a: torch.Tensor, E: int) -> torch.Tensor:
    """−a mod p, as the reference's fe_sub(0, a), with no zeros plane."""
    return addsub_level([("neg", None, a)], E)[0]


def pt_double(X, Y, Z, E: int):
    """Jacobian doubling (dbl-2009-l, a = 0) of a plane of points."""
    if _check((X, Y, Z), E).type == "cpu":
        KERNELS["pt_double"].count(E, plain=True)
        return C.pt_double_plain(X, Y, Z, E)
    return tuple(_launch("pt_double", E, (X, Y, Z), 3))


def pt_add(X1, Y1, Z1, X2, Y2, Z2, E: int):
    """Branchless unified Jacobian add of two planes of points."""
    if _check((X1, Y1, Z1, X2, Y2, Z2), E).type == "cpu":
        KERNELS["pt_add"].count(E, plain=True)
        return C.pt_add_plain(X1, Y1, Z1, X2, Y2, Z2, E)
    return tuple(_launch("pt_add", E, (X1, Y1, Z1, X2, Y2, Z2), 3))


# ---------------------------------------------------------------------------
# Fixed-exponent powers: one fe_pow launch
# ---------------------------------------------------------------------------

POW_LAYOUTS = {"plane": 0, "rows": 1}      # charon_fe_pow's layout argument


def exp_digits(e: int, nbits: int = 384) -> list[int]:
    """Fixed exponent -> MSB-first POW_WINDOW-bit window digits."""
    w = POW_WINDOW
    nw = nbits // w
    mask = (1 << w) - 1
    return [(e >> (w * (nw - 1 - i))) & mask for i in range(nw)]


def pow_digits(digits) -> list[int]:
    """MSB-first window digits as fe_pow takes them: leading zeros stripped,
    so digits[0] != 0 (a zero window further on costs its squarings and no
    product). ValueError for the exponent 0 or a digit past the window."""
    digits = [int(d) for d in digits]
    if any(not 0 <= d < 1 << POW_WINDOW for d in digits):
        raise ValueError(f"window digits must be in [0, {1 << POW_WINDOW})")
    for k, d in enumerate(digits):
        if d:
            return digits[k:]
    raise ValueError("exponent must be >= 1")


def pow_call(layout: str, a: torch.Tensor, digits: list[int], plain_mul) -> torch.Tensor:
    """fe_pow over checked, contiguous elements of one layout: on a CPU
    tensor its plain version (field.pow_plain over `plain_mul`, the layout's
    plain product), counted as one plain call; on a CUDA tensor one launch.
    Either way counted by (layout, width, digits) in `cases`."""
    case = (layout, a.numel() // LIMBS, tuple(digits))
    if a.device.type == "cpu":
        KERNELS["fe_pow"].count(layout, case=case, plain=True)
        return F.pow_plain(a, digits, plain_mul)
    return launch_pow(layout, a, digits, case)


def launch_pow(layout: str, a: torch.Tensor, digits: list[int], case=None) -> torch.Tensor:
    """One charon_fe_pow launch over a contiguous CUDA plane or rows (rows
    16-byte aligned), on the current stream of its device; counts the
    launch under the layout and its width, and its case where given."""
    if a.device.index != torch.cuda.current_device():
        with torch.cuda.device(a.device):
            return launch_pow(layout, a, digits, case)
    out = torch.empty_like(a)
    n = a.numel() // LIMBS
    rc = _library().charon_fe_pow(POW_LAYOUTS[layout], a.data_ptr(), out.data_ptr(), n,
                                  bytes(digits), len(digits),
                                  torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise DeviceError(f"CUDA kernel fe_pow<{layout}> did not launch: error {rc}")
    KERNELS["fe_pow"].count(layout, n, case)
    return out


def pow_scan(A: torch.Tensor, digits) -> torch.Tensor:
    """A^e for a (1, 12, n) Fq plane and one shared exponent given as
    MSB-first 4-bit window digits (leading zeros are stripped; e >= 1): one
    fe_pow launch on the card; on the CPU its plain version, the same scan
    over the plain product."""
    digits = pow_digits(digits)
    _check((A,), 1)
    return pow_call("plane", A, digits, lambda x, y: F.fe_mul_plain(x, y, 1))


# ---------------------------------------------------------------------------
# Scalar multiplication: one launch each
# ---------------------------------------------------------------------------

MUL_MAX_BITS = 640      # pt_mul_shared's parameter struct; H_EFF_G2 has 636 bits


def scalar_bits(k: int) -> bytes:
    """k's bits MSB-first, a byte each, as pt_mul_shared takes them."""
    return bytes(int(b) for b in bin(k)[2:])


def shared_mul(X, Y, Z, k: int, E: int):
    """k·P for one scalar 1 <= k < 2^MUL_MAX_BITS shared by the whole
    batch and known on the host: MSB-first double-and-add, a double per
    bit after the first and an add of P per set bit (_shared_mul_call's
    unrolled order, and the cofactor clear's). One pt_mul_shared launch on
    the card; on the CPU its plain version, the same loop over the plain
    point functions. Counted by (E, width, k) in `cases`."""
    if not 1 <= k < 1 << MUL_MAX_BITS:
        raise ValueError(f"shared scalar must be in [1, 2^{MUL_MAX_BITS})")
    device = _check((X, Y, Z), E)
    case = (E, X.shape[2], k)
    if device.type == "cpu":
        KERNELS["pt_mul_shared"].count(E, case=case, plain=True)
        return C.pt_mul_shared_plain(X, Y, Z, k, E)
    bits = scalar_bits(k)
    return tuple(_launch("pt_mul_shared", E, (X, Y, Z), 3, (bits, len(bits)), case))


def scalars_to_digitplanes(scalars, B: int, nbits: int = 256) -> np.ndarray:
    """Per-element scalars -> (nbits/WINDOW, pad_batch(B)) uint8 MSB-first
    window digits, element b in column b (the reference's (8, W) planes
    flattened)."""
    Bp = pad_batch(B)
    nb = nbits // 8
    n = len(scalars)
    raw = np.zeros((Bp, nb), dtype=np.uint8)
    if n:
        if (isinstance(scalars, np.ndarray) and scalars.dtype.kind == "u"
                and scalars.itemsize <= nb):
            w = scalars.itemsize
            be = np.ascontiguousarray(scalars.astype(scalars.dtype.newbyteorder(">")))
            raw[:n, nb - w:] = be.view(np.uint8).reshape(n, w)
        else:
            blob = b"".join(int(s).to_bytes(nb, "big") for s in scalars)
            raw[:n] = np.frombuffer(blob, np.uint8).reshape(-1, nb)
    bits = np.unpackbits(raw, axis=1).astype(np.int32).T        # (nbits, Bp)
    b = bits.reshape(nbits // WINDOW, WINDOW, Bp)
    w = np.asarray([1 << (WINDOW - 1 - i) for i in range(WINDOW)], np.int32)
    return (b * w[None, :, None]).sum(axis=1).astype(np.uint8)


def scalar_mul_windowed(X, Y, Z, digits: torch.Tensor, E: int):
    """Per-element k·P from (nwin, n) MSB-first 4-bit digits, uint8 on the
    planes' device, read in place: a 16-entry table k·P (7 doubles and 7
    adds), then from ∞ per window 4 doubles and one unified add of the
    selected entry; digit 0 selects ∞ (Z = 0). One pt_mul_windowed launch
    on the card; on the CPU its plain version. Counted by (E, width,
    windows) in `cases`."""
    device = _check((X, Y, Z), E)
    n = X.shape[2]
    if (digits.dim() != 2 or digits.shape[0] < 1 or digits.shape[1] != n
            or digits.dtype != torch.uint8 or digits.device != device):
        raise ValueError(f"digits must be a (windows >= 1, {n}) uint8 tensor on {device}, "
                         f"got {tuple(digits.shape)} {digits.dtype} on {digits.device}")
    digits = digits.contiguous()
    case = (E, n, digits.shape[0])
    if device.type == "cpu":
        KERNELS["pt_mul_windowed"].count(E, case=case, plain=True)
        return C.pt_mul_windowed_plain(X, Y, Z, digits, E)
    return tuple(_launch("pt_mul_windowed", E, (X, Y, Z), 3,
                         (digits.data_ptr(), digits.shape[0]), case))


# ---------------------------------------------------------------------------
# Reductions: the group sums in one pt_reduce_groups call
# ---------------------------------------------------------------------------


def reduce_groups(X, Y, Z, gid: torch.Tensor, G: int, E: int = 1):
    """Per-group sums of an (E, 12, n) plane of Jacobians, E = 1 or 2:
    out[g] = the sum of the points whose (n,) int32 id is g, for g < G (an
    id outside [0, G), −1 for padding, is in no group; an empty group is ∞,
    zeros), as three (E, 12, G) planes. One pt_reduce_groups call on the
    card (two launches: spans of C.RED_SPAN lanes, then each group's
    partials), counted once; on the CPU its plain version, in the kernel's
    order of adds. Counted by (E, width, G) in `cases`."""
    device = _check((X, Y, Z), E)
    n = X.shape[2]
    if (gid.dtype != torch.int32 or gid.shape != (n,) or gid.device != device
            or not gid.is_contiguous()):
        raise ValueError(f"gid must be a contiguous ({n},) int32 tensor on {device}, "
                         f"got {tuple(gid.shape)} {gid.dtype} on {gid.device}")
    if G < 1:
        raise ValueError(f"G must be >= 1, got {G}")
    case = (E, n, G)
    if device.type == "cpu":
        KERNELS["pt_reduce_groups"].count(E, case=case, plain=True)
        return C.pt_reduce_groups_plain(X, Y, Z, gid, G, E)
    nb = -(-n // C.RED_SPAN)
    scratch = torch.empty(3 * E * LIMBS * G * nb, dtype=torch.int32, device=device)
    outs = [torch.empty((E, LIMBS, G), dtype=torch.int32, device=device) for _ in range(3)]
    with torch.cuda.device(device):
        rc = _library().charon_pt_reduce_groups(
            E, X.data_ptr(), Y.data_ptr(), Z.data_ptr(), gid.data_ptr(), n, G,
            *[o.data_ptr() for o in outs], scratch.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise DeviceError(f"CUDA kernel pt_reduce_groups<{E}> did not launch: error {rc}")
    KERNELS["pt_reduce_groups"].count(E, n, case)
    return tuple(outs)


def host_points(X, Y, Z) -> list:
    """The (E, 12, k) planes' k Jacobians as host tuples of canonical ints
    (Fq: (x, y, z); Fq2: ((x0, x1), ...))."""
    E, k = X.shape[0], X.shape[-1]
    xs, ys, zs = (F.fq_ints(np.ascontiguousarray(c.cpu().numpy().transpose(2, 0, 1))
                            .reshape(k * E, LIMBS)) for c in (X, Y, Z))
    if E == 2:
        xs, ys, zs = (list(zip(v[0::2], v[1::2])) for v in (xs, ys, zs))
    return list(zip(xs, ys, zs))
