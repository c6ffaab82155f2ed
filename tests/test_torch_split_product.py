"""The lane-split Montgomery product (fp.cuh fq_mul_split, which fe_pow and
pt_mul_shared run on groups of T lanes): its word-for-word model,
field.mont_mul_split, against the port's plain product and the JAX
package's field encoding (charon_tpu.ops.field: Montgomery form with the
same R = 2^384 on 12-bit limbs; no JAX graph is compiled), at T in
{1, 2, 3, 4}, with every carry word's bound checked at every step; the
group's carry lookahead against a ripple; fp.cuh itself compiled by g++
(fq_mul_split, fq_reduce_split and fq_addsub's C form, the warp functions
over one thread a lane) against the model and the plain product; and
chip_smoke.py's A/B cases against the widths the main path launches the two
kernels at."""

import ctypes
import importlib.util
import itertools
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from charon_tpu.ops import field as RF
from charon_tpu_torch.ops import cuda_plane as CP
from charon_tpu_torch.ops import field as F

P = F.P_INT
R = 1 << 384
LANES = [1, 2, 3, 4]
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# 0, 1, p − 1, R mod p (Montgomery 1), and the largest value below p whose
# limbs are all ones but the top one's high bits
EDGES = [0, 1, P - 1, R % P, (1 << 352) - 1 + (((P >> 352) - 1) << 352)]


def _limbs(x: int) -> list:
    return [(x >> (32 * i)) & 0xFFFFFFFF for i in range(F.LIMBS)]


def _pairs():
    rng = np.random.default_rng(20261017)
    words = rng.integers(0, 1 << 32, size=(256, 2, F.LIMBS), dtype=np.uint64)
    pairs = [tuple(int(sum(int(w) << (32 * j) for j, w in enumerate(v))) % P for v in pair)
             for pair in words]
    return [(a, b) for a in EDGES for b in EDGES] + pairs


PAIRS = _pairs()


def _want(pairs) -> list:
    """The port's plain product (field.rows_mul_plain) of the pairs, as
    ints."""
    a = torch.tensor(np.stack([F.limbs_from_int(x) for x, _ in pairs]))
    b = torch.tensor(np.stack([F.limbs_from_int(y) for _, y in pairs]))
    out = F.rows_mul_plain(a, b).numpy()
    return [F.int_from_limbs(r) for r in out]


WANT = _want(PAIRS)


def test_edges_are_canonical_and_all_ones_below_the_top():
    assert all(0 <= e < P for e in EDGES)
    assert _limbs(EDGES[-1])[:11] == [0xFFFFFFFF] * 11


@pytest.mark.parametrize("T", LANES)
def test_split_product_is_the_plain_product_and_the_jax_packages(T):
    """Each lane count gives the port's plain Montgomery product word for
    word, on the edges (every pair of them) and 256 seeded random pairs;
    read through the JAX package's encoding, the same residue: a = xR and
    b = yR give xyR, its fq_from_int(x·y)."""
    for (a, b), want in zip(PAIRS, WANT):
        got = F.int_from_limbs(np.array(F.mont_mul_split(_limbs(a), _limbs(b), T), np.uint32)
                               .view(np.int32))
        assert got == want
        x, y = (RF.from_mont_int(v) for v in (a, b))
        assert RF.int_from_limbs(RF.fq_from_int(x * y % P)) == got
        assert RF.fq_to_int(RF.limbs_from_int(got)) == x * y % P


@pytest.mark.parametrize("T", LANES)
def test_carry_words_stay_in_their_bounds(T):
    """Every lane's carry word after a step's two rows fits the kernel's
    u64 with room (< 2^34), and after the shift is at most 3, at every step
    of every product; the top lane's ends at 0 (the model asserts that and
    that no carry leaves the group)."""
    bounds = []
    for a, b in PAIRS:
        F.mont_mul_split(_limbs(a), _limbs(b), T, bounds)
    assert len(bounds) == len(PAIRS) * F.LIMBS * 2 * T
    rows = [v for kind, v in bounds if kind == "row"]
    shifts = [v for kind, v in bounds if kind == "shift"]
    assert max(rows) < 1 << 34 and max(shifts) <= 3
    if T > 1:                            # the rows' carry words do need the u64
        assert max(rows) >= 1 << 32


@pytest.mark.parametrize("T", LANES)
def test_unreduced_split_product_stays_below_2p(T):
    """Without its subtraction of p (fe_pow's products between its first
    and last) the split product of inputs below 2p is the same residue,
    below 2p, its carry words in the same bounds; and reduced once, the
    plain product's words."""
    bounds = []
    for (a, b), want in zip(PAIRS[:89], WANT):          # the edges and 64 random pairs
        for x, y in ((a, b), (a + P, b), (a, b + P), (a + P, b + P)):
            got = F.int_from_limbs(np.array(
                F.mont_mul_split(_limbs(x), _limbs(y), T, bounds, reduce=False), np.uint32)
                .view(np.int32))
            assert got < 2 * P and got % P == want
    assert max(v for kind, v in bounds if kind == "shift") <= 3
    assert max(v for kind, v in bounds if kind == "row") < 1 << 34


def test_split_product_rejects_a_lane_count_that_does_not_divide_the_limbs():
    with pytest.raises(ValueError):
        F.mont_mul_split(_limbs(1), _limbs(1), 5)


@pytest.mark.parametrize("T", LANES)
def test_lookahead_gives_the_ripple_carries(T):
    """The group's carries from generate and propagate bits (exclusive, as
    a lane that carries out cannot be all ones) are a ripple's: the carry
    into lane l + 1 is g_l or (p_l and the carry into lane l)."""
    for bits in itertools.product((0, 1, 2), repeat=T):       # 2: propagate
        gen = [int(b == 1) for b in bits]
        prop = [int(b == 2) for b in bits]
        carry, want = 0, 0
        for lane in range(T):
            carry = gen[lane] | (prop[lane] & carry)
            want |= carry << (lane + 1)
        assert F._lookahead(gen, prop) == want


# ---------------------------------------------------------------------------
# The kernel source's lane counts and chip_smoke.py's A/B cases
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", ["kPowLanes", "kMulLanes1", "kMulLanes2"])
def test_lane_counts_are_source_constants_that_ab_sets(name, chip_smoke):
    """T is a `constexpr int` of plane_kernels.cu (not a setting): a
    power of two that divides the 12 limbs, and one that `--ab` sets."""
    with open(CP.SOURCES[0]) as f:
        src = f.read()
    value = int(re.search(rf"^constexpr int {name} = (\d+);$", src, re.M).group(1))
    assert value in (1, 2, 4)
    for T in (1, 2, 4):
        assert f"constexpr int {name} = {T};" in chip_smoke.ab_source(src, {name: T})
    if name == "kPowLanes":     # chip_smoke.py reads fe_pow's shape and width rule
        assert f"{value} lanes a product up to " in chip_smoke.pow_shape()


# the cases the first 1000 × 4-of-6 slot launched (chip_smoke.py's
# path_counts()["cases"] of its run): fe_pow by (layout, width, digits) —
# on planes the G1 sqrt of the 1,024-lane pk plane, the G2 partials' sqrt
# (4,096) and (p−3)/4 (12,288 packed Fq), the affine p−2 (1,024); on rows
# the verify's and hash-to-G2's scans at 1, 2 and 6 rows — and
# pt_mul_shared by (E, width, k): the pk plane's [u²]P and the cofactor
# clear of one message
def _digits(e: int) -> tuple:
    return tuple(CP.pow_digits(CP.exp_digits(e)))


FIRST_SLOT_POW = {
    ("plane", 1024, _digits((P + 1) // 4)): 1, ("plane", 4096, _digits((P + 1) // 4)): 1,
    ("plane", 12288, _digits((P - 3) // 4)): 1, ("plane", 1024, _digits(P - 2)): 1,
    ("rows", 1, _digits(P - 2)): 1, ("rows", 2, _digits(P - 2)): 1,
    ("rows", 2, _digits((P - 1) // 2)): 2, ("rows", 2, _digits((P + 1) // 4)): 2,
    ("rows", 6, _digits((P + 1) // 4)): 1}


def test_ab_cases_cover_every_width_the_first_slot_launched(chip_smoke):
    """`--ab --kernels pow,mul` times fe_pow at every (layout, width) and
    pt_mul_shared at every (E, width) that a first slot launched them at
    (chip_smoke.ab_uncovered, which chip_smoke.py also applies to its own
    slot's run and fails on)."""
    cases = {"fe_pow": FIRST_SLOT_POW,
             "pt_mul_shared": {(1, 1024, chip_smoke.U2): 1,
                               (2, 1, chip_smoke.PC.H_EFF_G2): 1}}
    assert chip_smoke.ab_uncovered(cases) == []
    wider = {"fe_pow": {("rows", 3, _digits(P - 2)): 1}, "pt_mul_shared": {(2, 2, 5): 1}}
    assert chip_smoke.ab_uncovered(wider) == [("fe_pow", "rows", 3), ("pt_mul_shared", 2, 2)]


# ---------------------------------------------------------------------------
# fp.cuh itself: the split product, its reduction and fq_addsub's C form,
# compiled for the host with warp functions over threads
# ---------------------------------------------------------------------------

# fp.cuh's warp functions on the host (FP_WARP_FUNCTIONS): one std::thread a
# lane of one warp, each call an exchange between two barriers of the whole
# warp, so that every lane must reach it, as on the card (its masks are the
# whole warp's). A group past the last pair runs the last pair and stores
# nothing, as fe_pow's does.
_HARNESS = r"""
#include <stdint.h>
#include <barrier>
#include <thread>

static std::barrier<>* shim_bar;
static uint64_t shim_x[32];
static thread_local int shim_lane;

template <class V>
static V __shfl_sync(unsigned, V v, int src) {
    shim_x[shim_lane] = (uint64_t)v;
    shim_bar->arrive_and_wait();
    const V r = (V)shim_x[src & 31];
    shim_bar->arrive_and_wait();
    return r;
}

static unsigned __ballot_sync(unsigned, int pred) {
    shim_x[shim_lane] = pred != 0;
    shim_bar->arrive_and_wait();
    unsigned r = 0;
    for (int k = 0; k < 32; ++k) r |= (unsigned)shim_x[k] << k;
    shim_bar->arrive_and_wait();
    return r;
}

#define FP_WARP_FUNCTIONS 1
#include "fp.cuh"

// fn(lane's group, pair index) for every lane of one warp over n pairs
template <int T, class F>
static void warp(int n, F fn) {
    std::barrier<> bar(32);
    shim_bar = &bar;
    std::thread ts[32];
    for (int l = 0; l < 32; ++l)
        ts[l] = std::thread([=] {
            shim_lane = l;
            const FqGroup<T> g = fq_group<T>(l % T, l - l % T);
            for (int base = 0; base < n; base += 32 / T) fn(g, base + l / T);
        });
    for (auto& t : ts) t.join();
}

static void load(Fq& x, const uint32_t* a, int i) {
    for (int j = 0; j < FP_LIMBS; ++j) x.v[j] = a[i * FP_LIMBS + j];
}

template <int T, bool R>
static void mul(int n, const uint32_t* a, const uint32_t* b, uint32_t* out) {
    constexpr int L = FP_LIMBS / T;
    warp<T>(n, [=](const FqGroup<T>& g, int i) {
        Fq x, y;
        FqSlice<L> ys, r;
        load(x, a, i < n ? i : n - 1);
        load(y, b, i < n ? i : n - 1);
        fq_slice<T>(ys, y, g);
        fq_mul_split<T, R>(r, x, ys, g);
        if (i < n)
            for (int j = 0; j < L; ++j) out[i * FP_LIMBS + L * g.lane + j] = r.v[j];
    });
}

template <int T>
static void reduce(int n, const uint32_t* a, uint32_t* out) {
    constexpr int L = FP_LIMBS / T;
    warp<T>(n, [=](const FqGroup<T>& g, int i) {
        Fq x;
        FqSlice<L> xs, r;
        load(x, a, i < n ? i : n - 1);
        fq_slice<T>(xs, x, g);
        fq_reduce_split<T>(r, xs, g);
        if (i < n)
            for (int j = 0; j < L; ++j) out[i * FP_LIMBS + L * g.lane + j] = r.v[j];
    });
}

extern "C" int split_mul(int T, int r, int n, const uint32_t* a, const uint32_t* b,
                         uint32_t* out) {
    switch (T * 2 + r) {
        case 2: mul<1, false>(n, a, b, out); return 0;
        case 3: mul<1, true>(n, a, b, out); return 0;
        case 4: mul<2, false>(n, a, b, out); return 0;
        case 5: mul<2, true>(n, a, b, out); return 0;
        case 8: mul<4, false>(n, a, b, out); return 0;
        case 9: mul<4, true>(n, a, b, out); return 0;
    }
    return 1;
}

extern "C" int split_reduce(int T, int n, const uint32_t* a, uint32_t* out) {
    switch (T) {
        case 1: reduce<1>(n, a, out); return 0;
        case 2: reduce<2>(n, a, out); return 0;
        case 4: reduce<4>(n, a, out); return 0;
    }
    return 1;
}

extern "C" void addsub(int n, const uint32_t* a, const uint32_t* b, int sub, uint32_t* out) {
    for (int i = 0; i < n; ++i) {
        Fq x, y, r;
        load(x, a, i);
        load(y, b, i);
        fq_addsub(r, x, y, sub != 0);
        for (int j = 0; j < FP_LIMBS; ++j) out[i * FP_LIMBS + j] = r.v[j];
    }
}
"""
HOST_LANES = [1, 2, 4]      # 32 % T == 0: a warp holds whole groups


@pytest.fixture(scope="module")
def fp_host(tmp_path_factory):
    """fp.cuh compiled by g++ into a library with _HARNESS's entry points."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++: fp.cuh's host build needs a C++20 compiler")
    out = tmp_path_factory.mktemp("fp_host")
    src = out / "fp_host.cpp"
    src.write_text(_HARNESS)
    lib = out / "libfp_host.so"
    subprocess.run([gxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", "-I",
                    os.path.dirname(CP.SOURCES[0]), "-o", str(lib), str(src)],
                   check=True, capture_output=True, timeout=120)
    return ctypes.CDLL(str(lib))


def _words(xs) -> np.ndarray:
    return np.ascontiguousarray(np.array([_limbs(x) for x in xs], np.uint32))


def _ints(words: np.ndarray) -> list:
    return [sum(int(w) << (32 * j) for j, w in enumerate(row)) for row in words]


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _host_mul(lib, T: int, reduce: bool, pairs) -> list:
    a, b = _words(x for x, _ in pairs), _words(y for _, y in pairs)
    out = np.zeros_like(a)
    assert lib.split_mul(T, int(reduce), len(pairs), _ptr(a), _ptr(b), _ptr(out)) == 0
    return _ints(out)


@pytest.mark.parametrize("T", HOST_LANES)
def test_fp_cuh_split_product_is_the_model_and_the_plain_product(T, fp_host):
    """fq_mul_split<T> as fp.cuh builds it (its lookahead's ballots, the
    shift's and m's shuffles) gives the plain product's words and the
    model's on the edges and the seeded pairs; fq_mul_split<T, false>, on
    inputs below 2p, the model's unreduced words."""
    assert _host_mul(fp_host, T, True, PAIRS) == WANT
    wide = [(x + dx, y + dy) for x, y in PAIRS[:89] for dx in (0, P) for dy in (0, P)]
    got = _host_mul(fp_host, T, False, wide)
    assert got == [F.int_from_limbs(np.array(
        F.mont_mul_split(_limbs(x), _limbs(y), T, reduce=False), np.uint32).view(np.int32))
        for x, y in wide]
    assert all(v < 2 * P for v in got)


@pytest.mark.parametrize("T", HOST_LANES)
def test_fp_cuh_reduce_split_subtracts_p_once(T, fp_host):
    """fq_reduce_split<T>: x mod p for x below 2p (the edges, the edges
    plus p, and seeded values), its borrows from the group's lookahead."""
    xs = EDGES + [e + P for e in EDGES] + [P, 2 * P - 1] + [a + b % 2 * P for a, b in PAIRS[25:]]
    a, out = _words(xs), np.zeros((len(xs), F.LIMBS), np.uint32)
    assert fp_host.split_reduce(T, len(xs), _ptr(a), _ptr(out)) == 0
    assert _ints(out) == [x % P for x in xs]


def test_fp_cuh_addsub_is_the_plain_add_and_sub(fp_host):
    """fq_addsub's two chains (the host form of the card's PTX): (a + b)
    mod p and (a − b) mod p on the edges and the seeded pairs."""
    a, b = _words(x for x, _ in PAIRS), _words(y for _, y in PAIRS)
    for sub in (0, 1):
        out = np.zeros_like(a)
        fp_host.addsub(len(PAIRS), _ptr(a), _ptr(b), sub, _ptr(out))
        assert _ints(out) == [(x - y if sub else x + y) % P for x, y in PAIRS]
