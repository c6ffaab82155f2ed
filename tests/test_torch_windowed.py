"""pt_mul_windowed (ops/csrc/plane_kernels.cu): the kernel itself, compiled
by g++ for the host through a small shim of the CUDA keywords (a block at a
time, one std::thread a CUDA thread, __syncthreads a barrier of the block,
the warp votes and shuffles an exchange between two barriers of the warp,
dynamic shared memory poisoned), held word for word (X, Y, Z) against its
plain version, ops/curve.py pt_mul_windowed_plain, on chip_smoke.py's edge
lanes (infinity, a point of order 3 through the P+P double, a G1 point plus
it, an all-zero digit column, k = 1) and seeded general lanes, with padded
lanes in a block; at other numbers of warps a block and with the other
product; and chip_smoke.py's --ab cases and diagnostic builds against the
new body. The plain version itself is held to the JAX package in
tests/test_torch_curve.py."""

import ctypes
import importlib.util
import os
import re
import shutil
import subprocess

import pytest
import torch

from charon_tpu_torch.ops import cuda_plane as CP
from charon_tpu_torch.ops import curve as C
from charon_tpu_torch.ops import point_schedule as PS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The CUDA runtime as plane_kernels.cu uses it, on host threads.
_SHIM = r"""
#pragma once
#include <stdint.h>
#include <stddef.h>
#include <atomic>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __noinline__
#define __launch_bounds__(...)
#define __shared__ static
#define __constant__
#define __align__(n) __attribute__((aligned(n)))
#define __grid_constant__

typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <class K>
static cudaError_t cudaFuncSetAttribute(K, int, int) { return cudaSuccess; }
static cudaError_t cudaGetLastError() { return cudaSuccess; }

struct uint4 { uint32_t x, y, z, w; };
static inline uint4 make_uint4(uint32_t x, uint32_t y, uint32_t z, uint32_t w) {
    return {x, y, z, w};
}
struct shim_dim3 { unsigned x, y, z; };
static thread_local shim_dim3 threadIdx, blockIdx;
static shim_dim3 blockDim;

// a barrier of n threads on a generation count: a waiter yields a few
// times, then sleeps on the count (a futex), so that a loaded host is not
// kept busy
struct shim_barrier {
    std::atomic<int> count{0}, gen{0};
    int n = 0;
    void wait() {
        const int g = gen.load(std::memory_order_acquire);
        if (count.fetch_add(1, std::memory_order_acq_rel) == n - 1) {
            count.store(0, std::memory_order_relaxed);
            gen.store(g + 1, std::memory_order_release);
            gen.notify_all();
            return;
        }
        for (int k = 0; k < 8 && gen.load(std::memory_order_acquire) == g; ++k)
            std::this_thread::yield();
        while (gen.load(std::memory_order_acquire) == g) gen.wait(g, std::memory_order_acquire);
    }
};

static unsigned char* shim_dyn_smem;
static shim_barrier shim_block_bar, shim_warp_bar[32];
static uint64_t shim_x[1024];

static inline void __syncthreads() { shim_block_bar.wait(); }
static inline void __syncwarp(unsigned = 0xffffffffu) { shim_warp_bar[threadIdx.x / 32].wait(); }
template <class V>
static V __shfl_sync(unsigned, V v, int src) {
    const int w = threadIdx.x / 32 * 32;
    shim_x[threadIdx.x] = (uint64_t)v;
    __syncwarp();
    const V r = (V)shim_x[w + (src & 31)];
    __syncwarp();
    return r;
}
static unsigned __ballot_sync(unsigned, int pred) {
    const int w = threadIdx.x / 32 * 32;
    shim_x[threadIdx.x] = pred != 0;
    __syncwarp();
    unsigned r = 0;
    for (int k = 0; k < 32; ++k) r |= (unsigned)shim_x[w + k] << k;
    __syncwarp();
    return r;
}
static int __any_sync(unsigned m, int pred) { return __ballot_sync(m, pred) != 0; }

// a block at a time, one std::thread a CUDA thread
template <class F>
static void shim_launch(unsigned grid, unsigned block, size_t smem, F fn) {
    std::vector<unsigned char> dyn(smem + 16, 0xa5);
    shim_dyn_smem = dyn.data();
    blockDim = {block, 1, 1};
    shim_block_bar.n = block;
    for (auto& w : shim_warp_bar) w.n = 32;
    for (unsigned b = 0; b < grid; ++b) {
        std::vector<std::thread> ts;
        for (unsigned t = 0; t < block; ++t)
            ts.emplace_back([&, t] {
                threadIdx = {t, 0, 0};
                blockIdx = {b, 0, 0};
                fn();
            });
        for (auto& t : ts) t.join();
    }
}
#define FP_WARP_FUNCTIONS 1
"""


def shim_source(src: str) -> str:
    """plane_kernels.cu for the shim: each `extern __shared__` array a
    pointer to the launch's dynamic shared memory, each launch k<<<grid,
    block, smem, stream>>>(args) a shim_launch."""
    src = re.sub(r"extern __shared__ (?:__align__\(\d+\) )?(\w+) (\w+)\[\];",
                 r"\1* const \2 = (\1*)shim_dyn_smem;", src)
    return re.sub(r"([\w:]+(?:<[^<>;]*>)?)<<<(.*?),(.*?),(.*?),(.*?)>>>\((.*?)\);",
                  r"shim_launch(\2, \3, \4, [&] { \1(\6); });", src, flags=re.S)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def chip_smoke():
    return _chip_smoke()


# builds: name -> constants set in the source (chip_smoke.ab_source): the
# kernel as built (E = 2: 16 points a block up to 2,048 points, two ranks a
# warp, 16 ranks; E = 1: products split over 4 lanes, 8 points a block);
# one lane a product, 32 points a block and 4 ranks at every width and E;
# and at E = 2 products split over 2 lanes, 16 points a block, 2 ranks
BUILDS = {"kernel": {},
          "wide": {"kWinNarrowMax": 0, "kWin2Ranks": 4, "kWin1Points": 32, "kWin1Lanes": 1,
                   "kWin1Ranks": 4},
          "split": {"kWin2Lanes": 2, "kWin2WidePoints": 16, "kWin2Ranks": 2}}


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory, chip_smoke):
    """plane_kernels.cu of each build compiled by g++ with the shim and the
    point schedules' header, bound as cuda_plane binds the card's."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++: the kernels' host build needs a C++20 compiler")
    out = tmp_path_factory.mktemp("windowed_host")
    (out / "cuda_runtime.h").write_text(_SHIM)
    (out / "point_schedule.h").write_text(PS.header())
    with open(CP.SOURCES[0]) as f:
        text = f.read()
    procs = {}
    for name, consts in BUILDS.items():
        tag = name.replace(" ", "_")
        cpp = out / f"{tag}.cpp"
        cpp.write_text(shim_source(chip_smoke.ab_source(text, consts)))
        procs[name] = (out / f"lib{tag}.so", subprocess.Popen(
            [gxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", "-w", "-I", str(out),
             "-I", os.path.dirname(CP.SOURCES[0]), "-o", str(out / f"lib{tag}.so"), str(cpp)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate(timeout=300)
        assert proc.returncode == 0, log.decode()[-3000:]
        libs[name] = CP.bind(str(lib))
    return libs


def _host_call(lib, E: int, pts, digits):
    """charon_pt_mul_windowed of a host library on CPU planes (stream NULL)."""
    outs = [torch.empty_like(pts[0]) for _ in range(3)]
    rc = lib.charon_pt_mul_windowed(E, *[t.data_ptr() for t in pts],
                                    *[t.data_ptr() for t in outs], pts[0].shape[2],
                                    digits.data_ptr(), digits.shape[0], None)
    assert rc == 0
    return outs


def _same(got, want) -> bool:
    return all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("build,E,n,nwin", [("kernel", 1, 12, 1), ("kernel", 2, 40, 2),
                                             ("wide", 1, 40, 2),
                                             ("wide", 2, 40, 2), ("split", 2, 20, 1)])
def test_kernel_is_the_plain_version_word_for_word(build, E, n, nwin, host_libs, chip_smoke):
    """The kernel's X, Y, Z words are the plain version's on the edge lanes
    (∞, order 3 through P + P, a G1 point plus it, an all-zero digit
    column, k = 1) and the general lanes, in every block shape: one lane a
    product (at E = 2 and 40 lanes three blocks of 16 points, two ranks a
    warp, the last block with 8 padded lanes; 32 points a block: two, the
    second with 24) and products split over 2 or 4 lanes (fq_mul_split),
    with 16, 8 or 4 ranks a block."""
    for label, pts, digits in chip_smoke._mul_cases("pt_mul_windowed", E, n, nwin,
                                                    torch.device("cpu")):
        want = C.pt_mul_windowed_plain(*pts, digits, E)
        assert _same(_host_call(host_libs[build], E, pts, digits), want), label


def test_add_never_writes_its_addend_slots():
    """The kernel reads the add's addend Q (slots 3E..6E-1) in place from a
    table entry: no operation of pt_add's schedule writes those slots, and
    none of the double's outputs or the add's selected slots is one of the
    accumulator's (0..3E-1), which the copies write."""
    for E in (1, 2):
        add, dbl = PS.SCHEDULES["pt_add", E], PS.SCHEDULES["pt_double", E]
        written = {op.dst for lv in add.levels for op in lv.ops}
        assert not written & set(range(3 * E, 6 * E))
        assert not set(dbl.outputs) & set(range(3 * E))
        assert not set(add.outputs + add.dbl_outputs) & set(range(3 * E))
        assert add.inputs == tuple(range(6 * E))


@pytest.mark.parametrize("variant", ["kWinNarrowMax", "kWin2NarrowPoints", "kWin2WidePoints",
                                     "kWin2Lanes", "kWin2Ranks", "kWin1Points", "kWin1Lanes",
                                     "kWin1Ranks"])
def test_windowed_constants_patch_the_source(variant, chip_smoke):
    """`--ab` sets the windowed kernel's constants in the source."""
    with open(CP.SOURCES[0]) as f:
        src = f.read()
    out = chip_smoke.ab_source(src, {variant: 2})
    assert f"constexpr int {variant} = 2;" in out and out != src


@pytest.mark.parametrize("diag", ["no-arith", "no-linear", "no-products"])
def test_diagnostics_patch_the_windowed_body(diag, chip_smoke):
    """Each --diagnose build changes the windowed kernel's operation or
    level loop as well as the point kernels' level loop."""
    with open(CP.SOURCES[0]) as f:
        src = f.read()
    out = chip_smoke.ab_source(src, {}, chip_smoke.DIAGNOSTICS[diag])
    body = out[out.index("__device__ __forceinline__ void win_op"):
               out.index("__device__ __forceinline__ bool win_zero")]
    assert body != src[src.index("__device__ __forceinline__ void win_op"):
                       src.index("__device__ __forceinline__ bool win_zero")]


def test_ab_times_every_windowed_case_of_the_main_path(chip_smoke):
    """MUL_AB times pt_mul_windowed<2> at the sweep's and the MSM's cases
    and pt_mul_windowed<1> at the G1 MSM's width."""
    cases = {(name, E, n, arg) for name, E, n, arg in chip_smoke.MUL_AB}
    assert {("pt_mul_windowed", 2, 4096, 64), ("pt_mul_windowed", 2, 2048, 16),
            ("pt_mul_windowed", 1, 1024, 16)} <= cases
