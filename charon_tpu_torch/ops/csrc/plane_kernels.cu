// The port's field/point kernels for Hopper (sm_90a), over two layouts of
// uint32 limbs:
//   planes: limb-major (E, 12, n): limb j of component e of element i lives
//     at [(e*12 + j)*n + i], so neighbouring threads read neighbouring words
//     of one limb row;
//   rows: (n, 12), element i limb j at [i*12 + j] — the layout of the
//     pairing, tower and hash-to-curve code (ops/rows.py), read in place
//     with no transpose, 16 bytes at a time.
//
// Each kernel replaces one Pallas body of charon_tpu/ops/pallas_plane.py:
//   fe_mul<E>    -> _kern_mul    (Montgomery product; E=2 Karatsuba), a
//                   level of independent products a launch
//   fe_addsub    -> _kern_addp and _kern_sub ((a + b) or (a - b) mod p per
//                   component; also -b), a level of them a launch
//   pt_double<E> -> _kern_double (Jacobian dbl-2009-l, a = 0)
//   pt_add<E>    -> _kern_add    (unified add with its selects)
//   fe_mul_rows<E> -> _kern_mul as launched by _mont_rows_call (rows; E = 2
//                   the whole Karatsuba product of curve._fq2_mul_many)
//   fe_pow<L>    -> _pow_scan    (the fixed-exponent power scan over
//                   _mul_call, whole, in one launch; on rows also the scans
//                   of tower.fq_inv and h2c._fq_pow_scan)
// and two chain the point steps of _kern_double and _kern_add, whole, in one
// launch each, where the reference compiles the loop of steps as one program:
//   pt_mul_shared<E>   -> _shared_mul_call (k*P for one host-known scalar;
//                         also the cofactor clear of charon_tpu/ops/h2c.py)
//   pt_mul_windowed<E> -> _scalar_mul_windowed (per-element k*P from 4-bit
//                         digit planes)
// and one sums a plane by groups, where the reference masks the plane once a
// group and runs _reduce_tree_jit's pt_add levels and the host fold:
//   pt_reduce_groups<E> (E = 1: the DKG's group sums; E = 2: the sigagg
//                        paths' RLC sums) -> _reduce_tree_jit + _host_fold
// and one more stands for XLA-op code of the reference's rows field plane
// (charon_tpu/ops/field.py fq_add / fq_sub / fq_neg):
//   fe_add_rows (adds, then subtracts past a split; at n_add = 0 a
//   subtraction, and fq_neg(a) is 0 - a)
//
// What bounds them on an H100 (3.35 TB/s; 32-bit integer multiply-adds at
// 132 SMs x 64 INT32 lanes x 1.98 GHz = 16.7 T/s, from the Hopper white
// paper's SM and the data sheet's boost clock; a 32x32->64-bit limb product
// counts as 2 of them):
//   fe_addsub: 3 x 48 B per Fq component moved, ~40 integer ops — bytes.
//   fe_mul<1>: 144 B moved against 2 x 144 limb products = 576 multiply-adds
//     — bytes, by 1.25x; fe_mul<2>: 288 B against 3 x 576 — operations, 1.2x.
//   pt_double<1> / pt_add<1>: 6 or 9 x 48 B moved against 5 or 4 Fq squares
//     (444 multiply-adds each: 78 distinct limb products + 144 for the
//     reduction) and 2 or 12 products (3,372 / 8,688) — operations, 2.3x / 4x.
//   pt_double<2> / pt_add<2>: 6 or 9 x 96 B moved against 16 or 44 Fq
//     products (9,216 / 25,344 multiply-adds) — operations, by 3x / 6x
//     (pt_add counts a double's work more on a lane that needs the P+P double).
//   fe_pow: 96 B moved against ~485 Fq operations (376-380 squarings, 105
//     products for a 381-bit exponent: ~229,000 multiply-adds) —
//     operations, by ~3,000x.
// fe_mul_rows<1> moves the same 144 B per product as fe_mul<1> against the
// same 576 multiply-adds, so it is bound by bytes, by 1.25x, and
// fe_mul_rows<2> like fe_mul<2> by operations; fe_add_rows moves 144 B
// against ~36 integer ops, bound by bytes. At the pairing's widths (3-2,304
// Fq2 products, 108-6,912 rows) each launch is a few dozen warps: latency-
// and launch-bound like the rest (see "Rows kernels" below).
// The plane field kernels ran one thread per element at first: at the
// slot's widths (1,024-12,288 elements) far below either bound, latency-
// and launch-bound, one launch per operation. They now take a level of
// independent operations a launch, each product split over lanes (see "The
// plane field kernels" below). The point kernels were built the same way at first, and
// one thread walking a whole formula waited through its 16 or 44 dependent
// Fq products (~2.4 us each); they now give each point a group of G threads
// that runs the formula as levels of independent Fq operations
// (ops/point_schedule.py), so a thread waits through one product per level:
// see "Point kernels" below. fe_pow keeps a whole power scan in registers,
// each product split over a group of lanes (see "fe_pow" below). Every
// kernel shares fp.cuh's carry-chain fq_mul, fq_sqr and fq_addsub, or its
// lane-split fq_mul_split. The scalar multiplications keep each point's
// scratch for the whole chain of steps: pt_mul_shared a group of threads a
// point, pt_mul_windowed a point a lane, the block's ranks of lanes running
// a level's operations (see "Scalar multiplication" below); pt_reduce_groups
// runs pt_mul_windowed's add on accumulators (see "The masked group
// reduction" below).
#include <cuda_runtime.h>

#include "fp.cuh"
#include "point_schedule.h"

namespace {

constexpr int kBlock = 128;

enum Layout { kPlane, kRows };

// 12 limbs at p (16-byte aligned), 16 bytes at a time.
__device__ __forceinline__ void load16(Fq& x, const uint32_t* p) {
    const uint4* q = reinterpret_cast<const uint4*>(p);
#pragma unroll
    for (int k = 0; k < FP_LIMBS / 4; ++k) {
        const uint4 v = q[k];
        x.v[4 * k] = v.x;
        x.v[4 * k + 1] = v.y;
        x.v[4 * k + 2] = v.z;
        x.v[4 * k + 3] = v.w;
    }
}

__device__ __forceinline__ void store16(uint32_t* p, const Fq& x) {
    uint4* q = reinterpret_cast<uint4*>(p);
#pragma unroll
    for (int k = 0; k < FP_LIMBS / 4; ++k)
        q[k] = make_uint4(x.v[4 * k], x.v[4 * k + 1], x.v[4 * k + 2], x.v[4 * k + 3]);
}

// Element i of an n-element array: limb j at [j * n + i] in a plane, the
// row at [i * 12] (16-byte aligned) in rows.
template <Layout L = kPlane>
__device__ __forceinline__ void load(Fq& x, const uint32_t* b, long long n, long long i) {
    if (L == kRows) {
        load16(x, b + i * FP_LIMBS);
        return;
    }
#pragma unroll
    for (int j = 0; j < FP_LIMBS; ++j) x.v[j] = b[(long long)j * n + i];
}

template <Layout L = kPlane>
__device__ __forceinline__ void store(uint32_t* b, const Fq& x, long long n, long long i) {
    if (L == kRows) {
        store16(b + i * FP_LIMBS, x);
        return;
    }
#pragma unroll
    for (int j = 0; j < FP_LIMBS; ++j) b[(long long)j * n + i] = x.v[j];
}

// r = this lane's limbs of x * y, y given as this lane's limbs (fp.cuh
// fq_mul_split; T = 1 fq_mul)
template <int T>
__device__ __forceinline__ void mul_split(FqSlice<FP_LIMBS / T>& r, const Fq& x,
                                          const FqSlice<FP_LIMBS / T>& y, const FqGroup<T>& g) {
    if constexpr (T == 1) {
        Fq b, c;
#pragma unroll
        for (int j = 0; j < FP_LIMBS; ++j) b.v[j] = y.v[j];
        fq_mul(c, x, b);
#pragma unroll
        for (int j = 0; j < FP_LIMBS; ++j) r.v[j] = c.v[j];
    } else {
        fq_mul_split<T>(r, x, y, g);
    }
}

__device__ __forceinline__ long long element() {
    return (long long)blockIdx.x * blockDim.x + threadIdx.x;
}

// ---------------------------------------------------------------------------
// The plane field kernels: a level of independent operations a launch
// ---------------------------------------------------------------------------
//
// fe_mul<E> replaces _kern_mul (charon_tpu/ops/pallas_plane.py:458, through
// _mul_call :657): a*b*R^-1 mod p, CIOS for E = 1, Karatsuba for E = 2.
// fe_addsub replaces _kern_addp (:452, through _addp_call :559) and _kern_sub
// (:446, through _sub_call :531): (a + b) or (a - b) mod p per component, and
// -b as 0 - b (the reference's fe_neg), on one branch-free path (fq_addsub
// with its sign), so the threads of a level that mixes them do not diverge.
//
// A launch takes a level: up to kLevelSegs segments of one kind and one E,
// each its own a, b, o, element count n and limb strides, passed by value as
// a __grid_constant__ struct (a struct indexed at run time would otherwise go
// to a local stack). Limb j of component e of element i of an operand sits at
// [(e * 12 + j) * ld + i], so a lane slice of a wider plane (roots[..., :n])
// or one component of an Fq2 plane is read and written in place. The blocks
// map to segments through a prefix of block counts (FeLevel::first): no block
// straddles two segments, so every block finds its segment by the same few
// uniform compares. A segment's output may be its own input, not another
// segment's.
//
// What bounds them at the slot's widths (1,024-12,288 elements a level): not
// the card's rates (fe_mul<1>: 144 B against 576 multiply-adds an element,
// bytes by 1.25x; fe_mul<2>: 288 B against 3 x 576, operations by 1.2x;
// fe_addsub: bytes) but latency: a launch, the loads, and one product's chain
// on as many warps as the level has. One thread an Fq product (fq_mul,
// ~1,320 instructions, PERF.md) put 8 blocks of 128 threads on the 132 SMs at
// 1,024 elements, one warp issuing a whole product on each of 32 SM
// sub-partitions. Here a level fills more of the card and waits through a
// shorter chain:
//   E = 1: a product split over kFeMul1Lanes = T = 4 lanes (fp.cuh
//     fq_mul_split<T>, as fe_pow's) up to kFeMul1SplitMax = 8,192 elements
//     a level; past it one thread a product (with every SM busy the split's
//     extra instructions cost more than its shorter chain saves: at 12,288
//     elements 4.4 against 3.6 us; T = 2 was slower than one thread at every
//     width).
//   E = 2: the three Karatsuba products on four teams of kFeMul2Lanes = T
//     lanes each (fe_mul_rows<2> runs T = 1): team 0 v0 = a0*b0, 1 v1 =
//     a1*b1, 2 and 3 s = (a0 + a1)(b0 + b1); v0 and v1 are shuffled to the
//     product's lanes, team 0 stores c0 = v0 - v1 and team 2 c1 = s - v0 -
//     v1, each lane of a team its 12/T limbs. T = 4 (16 lanes a product) up
//     to kFeMul2SplitMax = 1,024 elements, T = 1 past it: at 1,024 elements
//     3.7 against 4.1 us, at 4,096 5.2 against 4.1 (PERF.md).
// Every lane of a warp reaches each shuffle and ballot: a group past n runs
// on element n - 1 and stores nothing, and a warp wholly past n leaves at
// once. Loads and stores stay coalesced: neighbouring groups of lanes on
// neighbouring elements of a limb row. Every output word is canonical, the
// plain versions' (ops/field.py fe_*_plain, segment by segment).
constexpr int kFeBlock = 128;
constexpr int kFeMul1Lanes = 4;
constexpr int kFeMul1SplitMax = 8192;
constexpr int kFeMul2Lanes = 4;
constexpr int kFeMul2SplitMax = 1024;
constexpr int kLevelSegs = 8;

// One segment as the C interface takes it (cuda_plane.FeSeg): op 0 adds, 1
// subtracts (fe_mul ignores it); a null a reads 0.
struct FeSeg {
    const uint32_t* a;
    const uint32_t* b;
    uint32_t* o;
    long long n, lda, ldb, ldo;
    int op;
};

struct FeLevel {
    FeSeg s[kLevelSegs];
    unsigned first[kLevelSegs];  // the segment's first block
    int count;
};

__device__ __forceinline__ int level_segment(const FeLevel& L) {
    int s = 0;
#pragma unroll 1
    for (int k = 1; k < L.count; ++k)
        if (blockIdx.x >= L.first[k]) s = k;
    return s;
}

// element i of a strided Fq operand: limb j at [j * ld + i]
__device__ __forceinline__ void load_ld(Fq& x, const uint32_t* b, long long ld, long long i) {
#pragma unroll
    for (int j = 0; j < FP_LIMBS; ++j) x.v[j] = b[(long long)j * ld + i];
}

__device__ __forceinline__ void store_ld(uint32_t* b, const Fq& x, long long ld, long long i) {
#pragma unroll
    for (int j = 0; j < FP_LIMBS; ++j) b[(long long)j * ld + i] = x.v[j];
}

// this lane's W = 12 / T limbs of x: limbs W * lane .. W * lane + W - 1
template <int T>
__device__ __forceinline__ void store_slice_ld(uint32_t* b, const FqSlice<FP_LIMBS / T>& x,
                                               int lane, long long ld, long long i) {
    constexpr int W = FP_LIMBS / T;
#pragma unroll
    for (int j = 0; j < W; ++j) b[(long long)(W * lane + j) * ld + i] = x.v[j];
}

__device__ __forceinline__ void pick(Fq& r, bool c, const Fq& x, const Fq& y) {
#pragma unroll
    for (int j = 0; j < FP_LIMBS; ++j) r.v[j] = c ? x.v[j] : y.v[j];
}

__device__ __forceinline__ void shfl(Fq& r, const Fq& x, int src) {
#pragma unroll
    for (int j = 0; j < FP_LIMBS; ++j) r.v[j] = __shfl_sync(0xffffffffu, x.v[j], src);
}

template <int E, int T>
__global__ void __launch_bounds__(kFeBlock) fe_mul_kernel(const __grid_constant__ FeLevel L) {
    static_assert(kFeBlock % 32 == 0, "whole warps");
    // the segment read in place in the parameter space (a copy in registers
    // was 37% slower at 1,024 elements a level on the H100: PERF.md)
    const int seg = level_segment(L);
    const FeSeg& g = L.s[seg];
    const long long t = (long long)(blockIdx.x - L.first[seg]) * blockDim.x + threadIdx.x;
    constexpr int G = E == 1 ? T : 4 * T;  // lanes a product
    static_assert(32 % G == 0, "a product's lanes lie in one warp");
    if constexpr (E == 1 && T == 1) {
        if (t >= g.n) return;
        Fq x, y, r;
        load_ld(x, g.a, g.lda, t);
        load_ld(y, g.b, g.ldb, t);
        fq_mul(r, x, y);
        store_ld(g.o, r, g.ldo, t);
    } else {
        constexpr int W = FP_LIMBS / T;
        if ((t & ~31ll) / G >= g.n) return;
        const long long me = t / G, i = me < g.n ? me : g.n - 1;
        const int lane = threadIdx.x % T;
        const FqGroup<T> grp = fq_group<T>(lane, threadIdx.x % 32 - lane);
        Fq x;
        FqSlice<W> ys, rs;
        int team = 0;
        if constexpr (E == 1) {
            load_ld(x, g.a, g.lda, i);
#pragma unroll
            for (int j = 0; j < W; ++j) ys.v[j] = g.b[(long long)(W * lane + j) * g.ldb + i];
        } else {
            // teams 0, 1, 2-3: (a0, b0), (a1, b1), (a0 + a1, b0 + b1)
            team = threadIdx.x % G / T;
            Fq a0, a1, b0, b1, xa, xb, ya, yb, y, zero;
            load_ld(a0, g.a, g.lda, i);
            load_ld(a1, g.a + FP_LIMBS * g.lda, g.lda, i);
            load_ld(b0, g.b, g.ldb, i);
            load_ld(b1, g.b + FP_LIMBS * g.ldb, g.ldb, i);
#pragma unroll
            for (int j = 0; j < FP_LIMBS; ++j) zero.v[j] = 0;
            pick(xa, team == 1, a1, a0);
            pick(xb, team >= 2, a1, zero);
            pick(ya, team == 1, b1, b0);
            pick(yb, team >= 2, b1, zero);
            fq_addsub(x, xa, xb, false);
            fq_addsub(y, ya, yb, false);
            fq_slice<T>(ys, y, grp);
        }
        mul_split<T>(rs, x, ys, grp);
        if constexpr (E == 1) {
            if (me < g.n) store_slice_ld<T>(g.o, rs, lane, g.ldo, i);
        } else {
            // v0 and v1 to every lane of the product
            const int base = threadIdx.x % 32 / G * G;
            Fq r, v0, v1, d, c;
            fq_gather<T>(r, rs, grp);
            shfl(v0, r, base);
            shfl(v1, r, base + T);
            pick(d, team == 0, v1, v0);
            fq_addsub(d, r, d, true);      // team 0: c0 = v0 - v1; team 2: s - v0
            fq_addsub(c, d, v1, true);     // team 2: c1 = s - v0 - v1
            pick(c, team == 0, d, c);
            fq_slice<T>(rs, c, grp);
            if (me < g.n && (team == 0 || team == 2))
                store_slice_ld<T>(g.o + (team / 2) * FP_LIMBS * g.ldo, rs, lane, g.ldo, i);
        }
    }
}

// Fq segments only: the launcher splits an Fq2 segment into its components.
__global__ void __launch_bounds__(kFeBlock) fe_addsub_kernel(const __grid_constant__ FeLevel L) {
    // the segment copied to registers (0.05-0.2 us faster a launch than read
    // in place on the H100, where fe_mul runs the other way round: PERF.md)
    const int seg = level_segment(L);
    const FeSeg g = L.s[seg];
    const long long i = (long long)(blockIdx.x - L.first[seg]) * blockDim.x + threadIdx.x;
    if (i >= g.n) return;
    Fq x, y, r;
    if (g.a) {
        load_ld(x, g.a, g.lda, i);
    } else {
#pragma unroll
        for (int j = 0; j < FP_LIMBS; ++j) x.v[j] = 0;
    }
    load_ld(y, g.b, g.ldb, i);
    fq_addsub(r, x, y, g.op != 0);
    store_ld(g.o, r, g.ldo, i);
}

// The launch floor: an empty kernel, timed as the field kernels are.
__global__ void empty_kernel() {}

// ---------------------------------------------------------------------------
// Point kernels: a group of G threads per point, P = kPoints points per block
// ---------------------------------------------------------------------------
//
// The block loads the limb rows of its P points from the planes into shared
// memory (consecutive threads on consecutive words: limb j of points
// i..i+P-1 are neighbours in a plane), and each group walks its kernel's
// schedule (point_schedule.h, written by cuda_plane.build() from
// ops/point_schedule.py): per level, thread r of the group runs operations
// r, r + G, ... on the point's Fq slots, then the group syncs. Slot s of
// point pt holds its 12 limbs at sm[s * kSlotWords + pt * 12 + j], read and
// written 16 bytes at a time; a slot stride of 4 words mod 32 puts the
// different slots that a group reads at once on different banks. A group
// whose point lies past n skips its levels but not the block's barriers;
// the ragged edge is masked at the loads and stores.
//
// What bounds them: latency, not the card's rates. Each thread still waits
// through one whole fq_mul per product level (CIOS: 288 limb products in
// carry order), and a warp issues it once for all of its lanes, busy or
// not; between the product levels the adds and subs wait on each other as
// well, and the launch with its staging costs as much as a few levels. At
// 4,096 lanes two to four warps share each SM sub-partition. PERF.md ("PR
// 3") has the split, from `chip_smoke.py --ab --diagnose`.

constexpr int kPoints = 16;
constexpr int kSlotWords = FP_LIMBS * kPoints + 4;
static_assert(FP_LIMBS % 4 == 0 && kSlotWords % 32 == 4, "16-byte rows, spread slots");

// Group sizes: the widest product level rounded to a power of two
// (pt_double<2> 7 products, the E = 1 kernels 5 and 3), except pt_add<2>,
// whose widest levels (13 and 12 products) would take 16: with 8 a thread
// runs two products in each of them, but a warp carries four points instead
// of two, and at the sweep's 4,096 lanes that is faster (PERF.md;
// `chip_smoke.py --ab` times other sizes by patching these constants).
constexpr int kDoubleG1 = 4;
constexpr int kDoubleG2 = 8;
constexpr int kAddG1 = 4;
constexpr int kAddG2 = 8;

template <int G>
__device__ __forceinline__ unsigned group_mask() {
    static_assert(G <= 32 && 32 % G == 0, "a group lies inside one warp");
    return G == 32 ? 0xffffffffu : ((1u << G) - 1) << (threadIdx.x % 32 / G * G);
}

__device__ __forceinline__ int sword(int s, int pt) { return s * kSlotWords + pt * FP_LIMBS; }

__device__ __forceinline__ void sload(Fq& x, const uint32_t* sm, int s, int pt) {
    load16(x, sm + sword(s, pt));
}

__device__ __forceinline__ void sstore(uint32_t* sm, int s, int pt, const Fq& x) {
    store16(sm + sword(s, pt), x);
}

// x = slot a, a + b or a - b (b = kSchedNone: a + 0). A team of T > 1
// lanes skips adding 0; one thread an operation (T = 1) adds it, as the
// threads of a warp run different operations there: on the H100 the branch
// cost more than the add in pt_add<2>, pt_double<2> and the MSM (2-3%),
// though not in the sweep (PERF.md, PR 7).
template <int T>
__device__ __forceinline__ void operand(Fq& x, const uint32_t* sm, int a, int b, bool sub,
                                        int pt) {
    Fq y;
    sload(x, sm, a, pt);
    if (T > 1 && b == kSchedNone) return;
    if (b != kSchedNone)
        sload(y, sm, b, pt);
    else
#pragma unroll
        for (int j = 0; j < FP_LIMBS; ++j) y.v[j] = 0;
    fq_addsub(x, x, y, sub);
}

constexpr int kSchedLevelWords = sizeof(kSchedLevels) / sizeof(kSchedLevels[0]);
constexpr int kSchedOpWords = sizeof(kSchedOps) / sizeof(kSchedOps[0]);
constexpr int kSchedSlotBytes = sizeof(kSchedSlots);

// The schedule tables where a kernel reads them: the header's constant
// arrays (const_tables), or a copy in the block's shared memory that
// stage_tables makes before the block's first sync. The threads of a warp
// read different operation words of a level at once, which the constant
// cache serves one after another: in the scalar multiplications' chains of
// steps the copy pays (4-8% on the H100), in the one-step point kernels it
// costs more than it saves (1-1.5 us a launch; PERF.md, PR 7).
struct SchedTables {
    const uint64_t* ops;
    const uint32_t* levels;
    const uint8_t* slots;
};

__device__ __forceinline__ SchedTables const_tables() {
    return {kSchedOps, kSchedLevels, kSchedSlots};
}

struct SchedStage {   // 1,856 B
    uint64_t ops[kSchedOpWords];
    uint32_t levels[kSchedLevelWords];
    uint8_t slots[kSchedSlotBytes];
};

__device__ __forceinline__ SchedTables stage_tables(SchedStage& st) {
    for (int i = threadIdx.x; i < kSchedOpWords; i += blockDim.x) st.ops[i] = kSchedOps[i];
    for (int i = threadIdx.x; i < kSchedLevelWords; i += blockDim.x)
        st.levels[i] = kSchedLevels[i];
    for (int i = threadIdx.x; i < kSchedSlotBytes; i += blockDim.x) st.slots[i] = kSchedSlots[i];
    return {st.ops, st.levels, st.slots};
}

// a "group" of one lane: the point kernels' products on one thread (fq_mul)
__device__ __forceinline__ FqGroup<1> one_lane() {
    return fq_group<1>(0, threadIdx.x % 32);
}

// this lane's limbs of slot s of point pt, 16 bytes at a time where they
// are whole 16-byte words
template <int T>
__device__ __forceinline__ void sstore_slice(uint32_t* sm, int s, int pt,
                                             const FqSlice<FP_LIMBS / T>& r, const FqGroup<T>& g) {
    constexpr int W = FP_LIMBS / T;
    uint32_t* q = sm + sword(s, pt) + W * g.lane;
    if constexpr (W % 4 == 0) {
#pragma unroll
        for (int k = 0; k < W / 4; ++k)
            reinterpret_cast<uint4*>(q)[k] =
                make_uint4(r.v[4 * k], r.v[4 * k + 1], r.v[4 * k + 2], r.v[4 * k + 3]);
    } else {
#pragma unroll
        for (int j = 0; j < W; ++j) q[j] = r.v[j];
    }
}

// Levels [first, last) of the schedule tables for one point, run by its G
// teams of T lanes (g: this lane's team; mask: the point's G * T lanes);
// every lane of the point calls it, and for T > 1 every lane of its warp.
// Team `rank` runs operations rank, rank + G, ... of a level, all T lanes
// of the team on the same operation: each lane forms both operands whole, a
// product is split over the team (fq_mul_split; T = 1 fq_mul), and each
// lane stores its 12/T limbs of the product; a linear operation runs whole
// on every lane of the team, which all store it. A product level takes the
// same number of turns on every team (the split product's shuffles take
// the whole warp): a team past the level's last product runs operation word
// 0 (slot 0 + slot 0, squared) and stores nothing. The team's first
// operation of the next level is fetched while this level runs.
template <int G, int T>
__device__ void run_levels(const SchedTables& tab, uint32_t* sm, int first, int last, int pt,
                           int rank, const FqGroup<T>& g, unsigned mask) {
    constexpr int W = FP_LIMBS / T;
    uint32_t lv = tab.levels[first];
    uint64_t next = rank < (int)(lv >> 16 & 0xff) ? tab.ops[(lv & 0xffff) + rank] : 0;
#pragma unroll 1
    for (int L = first; L < last; ++L) {
        const int op0 = lv & 0xffff, count = lv >> 16 & 0xff;
        const bool mul = lv >> 24;
        const int end = T > 1 && mul ? (count + G - 1) / G * G : count;
        const uint64_t mine = next;
        if (L + 1 < last) {
            lv = tab.levels[L + 1];
            next = rank < (int)(lv >> 16 & 0xff) ? tab.ops[(lv & 0xffff) + rank] : 0;
        }
#pragma unroll 1
        for (int k = rank; k < end; k += G) {
            const uint64_t op = k >= count ? 0 : k == rank ? mine : tab.ops[op0 + k];
            const int flags = (int)(op >> 40);
            Fq x, y, z;
            FqSlice<W> r;
            operand<T>(x, sm, op >> 8 & 0xff, op >> 16 & 0xff, flags & 1, pt);
            operand<T>(y, sm, op >> 24 & 0xff, op >> 32 & 0xff, flags & 2, pt);
            if (mul) {
                fq_slice<T>(r, y, g);
                mul_split<T>(r, x, r, g);
                if (k < count) sstore_slice<T>(sm, op & 0xff, pt, r, g);
            } else {
                fq_addsub(z, x, y, flags & 4);
                sstore(sm, op & 0xff, pt, z);
            }
        }
        __syncwarp(mask);
    }
}

template <int E>
__device__ __forceinline__ bool slots_zero(const SchedTables& tab, const uint32_t* sm, int at,
                                           int pt) {
    bool zero = true;
#pragma unroll
    for (int e = 0; e < E; ++e) {
        Fq x;
        sload(x, sm, tab.slots[at + e], pt);
        zero = zero && fq_is_zero(x);
    }
    return zero;
}

// The unified add of the points in slots 0..6E-1 (the schedule's inputs,
// p then q), by the group: the general sum, then on a point that needs it
// the P+P double; returns where the reference's selects (P+P double, H=0 &
// R!=0 -> infinity, q = inf -> p, p = inf -> q; the last wins) put the sum:
// the offset into tab.slots of its 3E slots, or -1 for infinity (zeros).
// The selects read shared slots after the level's sync, so every thread of
// the group takes the same branch.
template <int E, int G, int T>
__device__ __forceinline__ int add_levels(const SchedTables& tab, uint32_t* sm, int pt, int rank,
                                          const FqGroup<T>& g, unsigned mask) {
    typedef Sched<kPtAdd, E> S;
    run_levels<G, T>(tab, sm, S::kLevel0, S::kLevel0 + S::kMain, pt, rank, g, mask);
    const bool p_inf = slots_zero<E>(tab, sm, S::kIn + 2 * E, pt);
    const bool q_inf = slots_zero<E>(tab, sm, S::kIn + 5 * E, pt);
    const bool h_zero = slots_zero<E>(tab, sm, S::kH, pt);
    const bool r_zero = slots_zero<E>(tab, sm, S::kR, pt);
    // for T > 1 the double runs where any point of the warp needs it (its
    // levels write none of the slots read below)
    bool dbl = !p_inf && !q_inf && h_zero && r_zero;
    if (T > 1) dbl = __any_sync(FP_WARP, dbl);
    if (dbl)
        run_levels<G, T>(tab, sm, S::kLevel0 + S::kMain, S::kLevel0 + S::kLevels, pt, rank, g,
                         mask);
    return p_inf    ? S::kIn + 3 * E
           : q_inf  ? S::kIn
           : !h_zero ? S::kOut
           : r_zero ? S::kDblOut
                    : -1;
}

// Coordinates c of the planes src into slots c * E + e (every schedule puts
// its inputs first, in order); points past n read as zero. A block of T
// threads and NP points: each thread issues all of its loads before it
// writes any, so their latencies overlap.
template <int E, int NC, int T, int NP = kPoints>
__device__ __forceinline__ void load_points(uint32_t* sm, const uint32_t* const (&src)[NC],
                                            long long base, long long n) {
    constexpr int W = E * FP_LIMBS * NP, K = (W + T - 1) / T;
    uint32_t v[NC][K];
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int k = 0; k < K; ++k) {
            const int w = threadIdx.x + k * T, pt = w % NP, ej = w / NP;
            v[c][k] = w < W && base + pt < n ? src[c][ej * n + base + pt] : 0u;
        }
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int k = 0; k < K; ++k) {
            const int w = threadIdx.x + k * T, pt = w % NP, ej = w / NP;
            if (w < W) sm[sword(c * E + ej / FP_LIMBS, pt) + ej % FP_LIMBS] = v[c][k];
        }
}

// X, Y, Z of point pt from the slots listed at tab.slots[off[pt] + c * E +
// e], or zeros where off[pt] < 0.
template <int E, int T>
__device__ __forceinline__ void store_points(uint32_t* const (&dst)[3], const SchedTables& tab,
                                             const uint32_t* sm, const short* off, long long base,
                                             long long n) {
    constexpr int W = E * FP_LIMBS * kPoints, K = (W + T - 1) / T;
#pragma unroll
    for (int c = 0; c < 3; ++c)
#pragma unroll
        for (int k = 0; k < K; ++k) {
            const int w = threadIdx.x + k * T, pt = w % kPoints, ej = w / kPoints;
            if (w >= W || base + pt >= n) continue;
            const int o = off[pt];
            dst[c][ej * n + base + pt] =
                o < 0 ? 0u : sm[sword(tab.slots[o + c * E + ej / FP_LIMBS], pt) + ej % FP_LIMBS];
        }
}

// Replaces _kern_double (pallas_plane.py:433): dbl-2009-l, a = 0.
// Bound: operations (7 / 16 Fq products per element for E = 1 / 2).
template <int E, int G>
__global__ void __launch_bounds__(G * kPoints) pt_double_kernel(const uint32_t* x, const uint32_t* y,
                                                                const uint32_t* z, uint32_t* ox,
                                                                uint32_t* oy, uint32_t* oz,
                                                                long long n) {
    typedef Sched<kPtDouble, E> S;
    static_assert(S::kSlots * kSlotWords * 4 <= 48 * 1024, "static shared memory");
    __shared__ __align__(16) uint32_t sm[S::kSlots * kSlotWords];
    __shared__ short off[kPoints];
    const SchedTables tab = const_tables();
    const long long base = (long long)blockIdx.x * kPoints;
    const int pt = threadIdx.x / G, rank = threadIdx.x % G;
    const uint32_t* const src[3] = {x, y, z};
    load_points<E, 3, G * kPoints>(sm, src, base, n);
    if (rank == 0) off[pt] = S::kOut;
    __syncthreads();
    if (base + pt < n)
        run_levels<G, 1>(tab, sm, S::kLevel0, S::kLevel0 + S::kLevels, pt, rank,
                         one_lane(), group_mask<G>());
    __syncthreads();
    uint32_t* const dst[3] = {ox, oy, oz};
    store_points<E, G * kPoints>(dst, tab, sm, off, base, n);
}

// Replaces _kern_add (pallas_plane.py:439): add_levels, and its selects as
// the choice of the slots stored. Bound:
// operations (16 / 44 Fq products per element, +7 / +16 on a lane that
// takes the P+P double).
template <int E, int G>
__global__ void __launch_bounds__(G * kPoints) pt_add_kernel(const uint32_t* x1, const uint32_t* y1,
                                                             const uint32_t* z1, const uint32_t* x2,
                                                             const uint32_t* y2, const uint32_t* z2,
                                                             uint32_t* ox, uint32_t* oy,
                                                             uint32_t* oz, long long n) {
    typedef Sched<kPtAdd, E> S;
    static_assert(S::kSlots * kSlotWords * 4 <= 48 * 1024, "static shared memory");
    __shared__ __align__(16) uint32_t sm[S::kSlots * kSlotWords];
    __shared__ short off[kPoints];
    const SchedTables tab = const_tables();
    const long long base = (long long)blockIdx.x * kPoints;
    const int pt = threadIdx.x / G, rank = threadIdx.x % G;
    const uint32_t* const src[6] = {x1, y1, z1, x2, y2, z2};
    load_points<E, 6, G * kPoints>(sm, src, base, n);
    __syncthreads();
    if (base + pt < n) {
        const int o = add_levels<E, G, 1>(tab, sm, pt, rank, one_lane(), group_mask<G>());
        if (rank == 0) off[pt] = o;
    }
    __syncthreads();
    uint32_t* const dst[3] = {ox, oy, oz};
    store_points<E, G * kPoints>(dst, tab, sm, off, base, n);
}

// ---------------------------------------------------------------------------
// Rows kernels: (n, 12) Fq rows or (n, 2, 12) Fq2 rows, read in place, 16
// bytes at a time (the wrappers pass 16-byte aligned bases)
// ---------------------------------------------------------------------------
//
// fe_mul_rows replaces _kern_mul as _mont_rows_call launches it
// (pallas_plane.py:969, :982), without the reference's transposes into an
// (1, LIMBS, 8, W) tile; for E = 2 it is the whole Karatsuba Fq2 product of
// the reference's seam curve._fq2_mul_many (charon_tpu/ops/curve.py:56),
// which the reference computes as one product launch between XLA adds and
// subs. Bound: bytes for E = 1 (144 B against 576 multiply-adds), operations
// for E = 2 (288 B against 3 x 576), by 1.25x / 1.2x. At the pairing's
// widths (3-2,304 Fq2 products, 108-6,912 rows) a launch is a few warps, so
// what it costs is latency: the launch, the loads and the chain of dependent
// field operations a thread waits through. E = 1 runs a thread per row.
// E = 2 gives each product a group of kMulRowsG = 4 lanes (8 products a
// warp): lanes 0-2 compute v0 = a0*b0, v1 = a1*b1 and s = (a0 + a1)(b0 + b1)
// at once, then v0 and v1 are shuffled to the group and lane 0 stores
// c0 = v0 - v1, lane 2 c1 = s - v0 - v1; complex squaring (a and b the same
// rows) takes two products, (a0 + a1)(a0 - a1) and 2*a0*a1. A product waits
// through one fq_mul and a few linear operations, not three fq_muls (one
// thread per Fq2 product, timed against this group on the H100, was slower
// at 36 and 2,304 products: PERF.md).
constexpr int kMulRowsG = 4;

template <int E>
__global__ void __launch_bounds__(kBlock) fe_mul_rows_kernel(const uint32_t* a, const uint32_t* b,
                                                             uint32_t* o, long long n) {
    if constexpr (E == 1) {
        const long long i = element();
        if (i >= n) return;
        Fq x, y, r;
        load16(x, a + i * FP_LIMBS);
        load16(y, b + i * FP_LIMBS);
        fq_mul(r, x, y);
        store16(o + i * FP_LIMBS, r);
    } else {
        constexpr int G = kMulRowsG;
        static_assert(E == 2 && G == 4 && kBlock % 32 == 0, "4 lanes a product, whole warps");
        // every lane of a warp reaches the shuffles: the lanes past n work on
        // the last product and store nothing
        const long long i = element() / G;
        const long long k = (i < n ? i : n - 1) * 2 * FP_LIMBS;
        const int lane = threadIdx.x % G;
        const bool sq = a == b;
        Fq a0, a1, b0, b1, zero;
        load16(a0, a + k);
        load16(a1, a + k + FP_LIMBS);
        load16(b0, b + k);
        load16(b1, b + k + FP_LIMBS);
#pragma unroll
        for (int j = 0; j < FP_LIMBS; ++j) zero.v[j] = 0;
        // x = xa + xb, y = ya +/- yb:
        //   lanes 0, 1, 2-3: (a0, b0), (a1, b1), (a0 + a1, b0 + b1);
        //   a square (b0 = a0, b1 = a1), lanes 0, 1-3: (a0 + a1, a0 - a1), (a0, a1)
        Fq xa, xb, ya, yb, x, y, r;
        pick(xa, lane == 1 && !sq, a1, a0);
        pick(xb, sq ? lane == 0 : lane >= 2, a1, zero);
        pick(ya, sq ? lane == 0 : lane != 1, b0, b1);
        pick(yb, sq ? lane == 0 : lane >= 2, b1, zero);
        fq_addsub(x, xa, xb, false);
        fq_addsub(y, ya, yb, sq && lane == 0);
        fq_mul(r, x, y);
        Fq c;
        bool mine;
        int col;
        if (sq) {                          // c0 = r (lane 0), c1 = r + r (lane 1)
            Fq rr;
            fq_addsub(rr, r, r, false);
            pick(c, lane == 0, r, rr);
            mine = lane < 2;
            col = lane;
        } else {                           // v0 and v1 to every lane of the group
            const int base = (threadIdx.x % 32) / G * G;
            Fq v0, v1, t;
            shfl(v0, r, base);
            shfl(v1, r, base + 1);
            pick(t, lane == 0, v1, v0);
            fq_addsub(t, r, t, true);      // lane 0: c0 = v0 - v1; lane 2: s - v0
            fq_addsub(c, t, v1, true);     // lane 2: c1 = s - v0 - v1
            pick(c, lane == 0, t, c);
            mine = lane == 0 || lane == 2;
            col = lane / 2;
        }
        if (i < n && mine) store16(o + i * 2 * FP_LIMBS + col * FP_LIMBS, c);
    }
}

// Stands for the XLA-op field.fq_add and field.fq_sub of the reference's
// rows plane at once: rows [0, n_add) get (a + b) mod p, rows [n_add, n) get
// (a - b) mod p, on one branch-free path (fq_addsub), so the threads of a
// level that mixes independent adds and subs (the ξ product's x0 + x1 and
// x0 - x1) do not diverge and the level is one launch. Bound: bytes.
__global__ void __launch_bounds__(kBlock) fe_add_rows_kernel(const uint32_t* a, const uint32_t* b,
                                                             uint32_t* o, long long n,
                                                             long long n_add) {
    const long long i = element();
    if (i >= n) return;
    Fq x, y, r;
    load16(x, a + i * FP_LIMBS);
    load16(y, b + i * FP_LIMBS);
    fq_addsub(r, x, y, i >= n_add);
    store16(o + i * FP_LIMBS, r);
}

// ---------------------------------------------------------------------------
// fe_pow: a fixed-exponent power scan in one launch, planes or rows
// ---------------------------------------------------------------------------
//
// Replaces the reference's _pow_scan (pallas_plane.py:593: a lax.scan over
// _mul_call, one product launch per step) and, on rows, the square-and-
// multiply scans of tower.fq_inv and h2c._fq_pow_scan: o = a^e mod p in
// Montgomery form, canonical, for an exponent known on the host. A group of
// kPowLanes = T lanes runs one element's whole chain on split products
// (fp.cuh fq_mul_split): each lane keeps its 12/T limbs of the accumulator
// in registers through every squaring and table product, and only a and a^e
// touch global memory. Every lane loads the whole element (its row's 48 B
// in 16-byte pieces, or its word of each limb row of a plane: the group's
// lanes read one address), which is a for the table's products; a squaring
// or a table product first gathers the accumulator to every lane (12
// shuffles); each lane stores its limbs. Between the first product and the
// last the values stay below 2p, not reduced (fq_mul_split<T, false>: the
// carries resolve, the subtraction of p waits), and one subtraction at the
// end makes a^e canonical. The exponent arrives by value in the
// parameter space as MSB-first 4-bit windows, leading zeros stripped (d[0]
// != 0): every thread reads the same digit at the same step, a uniform
// broadcast with no memory traffic, and a zero window costs its four
// squarings and no product. The power table a^1..a^15 is split as the
// accumulator, each lane's limbs of each entry in shared memory entry-major,
// [15][12/T][blockDim], so that neighbouring threads read neighbouring words
// (no bank conflicts): 15 x 48/T B a lane, at T = 4 and kPowBlock = 128
// threads 23,040 B a block (at T = 1 92,160 B; the launcher opts in past
// 48 KB).
//
// What bounds it: latency. A scan is ~485 dependent Fq operations (~380 of
// them squarings); at the main path's widths (1 to 12,288 elements) each SM
// sub-partition runs a few warps or none, and on one thread (T = 1) a
// product is ~1,350 instructions that one warp issues in turn (ptxas issues
// each mad.cc of fq_mul as an IMAD and an IADD3.X; PERF.md), ~1.1 us. On T
// = 4 lanes a lane issues ~30 instructions a CIOS step (one IMAD.WIDE.U32
// a limb product; PERF.md §7 from the SASS), ~8 of them on the step's
// critical path with the m shuffle, and the group resolves its carries with
// ballots once a product: ~0.6 us. Past kPowSplitMax elements a sub-
// partition holds three warps or more at T = 4 and their extra instructions
// cost more than the shorter chain saves (at 12,288 elements T = 4 was 4%
// slower than one thread, at 4,096 twice as fast), so the launcher takes T =
// 1 there. kPowLanes = 4 from the A/B in PERF.md (T = 2 was slower at every
// width). The loops are not unrolled (code size: an unrolled squaring loop
// was 22% slower with every SM running it).
// Threads a block (at T = 1, 128 was never slower than 64 on the H100, and
// faster at 1,024 lanes); lanes a product (1: fq_mul on one thread, 2 or 4)
// up to kPowSplitMax elements, one thread an element past it.
constexpr int kPowBlock = 128;
constexpr int kPowLanes = 4;
constexpr int kPowSplitMax = 8192;
constexpr int kPowMaxDigits = 96;  // 384 / 4
constexpr int kPowTable = 15;      // a^1 .. a^15

struct PowDigits {
    uint8_t d[kPowMaxDigits];
    int n;
};

// this thread's words (an Fq, or a lane's FqSlice) of entry k (a^(k+1)) of
// its table column
template <class X>
__device__ __forceinline__ void tab_put(uint32_t* tab, int k, const X& x) {
    constexpr int W = sizeof(x.v) / sizeof(x.v[0]);
#pragma unroll
    for (int j = 0; j < W; ++j) tab[(k * W + j) * blockDim.x + threadIdx.x] = x.v[j];
}

template <class X>
__device__ __forceinline__ void tab_get(X& x, const uint32_t* tab, int k) {
    constexpr int W = sizeof(x.v) / sizeof(x.v[0]);
#pragma unroll
    for (int j = 0; j < W; ++j) x.v[j] = tab[(k * W + j) * blockDim.x + threadIdx.x];
}

// Each thread touches only its own table column, so the block never syncs.
// The digits are read in place in the parameter space (__grid_constant__:
// indexed at run time, a by-value struct would be copied to a local stack).
// T = 1: a thread an element, fq_sqr and fq_mul on whole elements. T > 1:
// every lane of a warp runs the scan (the shuffles take the whole warp); a
// group past n works on element n - 1 and stores nothing, a warp wholly past
// n leaves at once.
template <Layout L, int T>
__global__ void __launch_bounds__(kPowBlock) fe_pow_kernel(const uint32_t* a, uint32_t* o,
                                                           long long n,
                                                           const __grid_constant__ PowDigits e) {
    static_assert(kPowBlock % 32 == 0, "whole warps");
    extern __shared__ uint32_t tab[];
    if constexpr (T == 1) {
        const long long i = element();
        if (i >= n) return;
        Fq x, acc, y;
        load<L>(x, a, n, i);
        tab_put(tab, 0, x);
        acc = x;
#pragma unroll 1
        for (int k = 2; k <= kPowTable; ++k) {  // a^k = a^(k-1) * a
            fq_mul(acc, acc, x);
            tab_put(tab, k - 1, acc);
        }
        tab_get(acc, tab, e.d[0] - 1);
#pragma unroll 1
        for (int s = 1; s < e.n; ++s) {
#pragma unroll 1
            for (int q = 0; q < 4; ++q) fq_sqr(acc, acc);
            const int d = e.d[s];
            if (d) {
                tab_get(y, tab, d - 1);
                fq_mul(acc, acc, y);
            }
        }
        store<L>(o, acc, n, i);
    } else {
        constexpr int W = FP_LIMBS / T;
        const long long me = element() / T, i = me < n ? me : n - 1;
        if ((element() & ~31ll) / T >= n) return;
        const int lane = threadIdx.x % T;
        const FqGroup<T> g = fq_group<T>(lane, threadIdx.x % 32 - lane);
        Fq x, full;
        FqSlice<W> acc, y;
        load<L>(x, a, n, i);
        fq_slice<T>(acc, x, g);
        tab_put(tab, 0, acc);
#pragma unroll 1
        for (int k = 2; k <= kPowTable; ++k) {  // a^k = a * a^(k-1)
            fq_mul_split<T, false>(acc, x, acc, g);
            tab_put(tab, k - 1, acc);
        }
        tab_get(acc, tab, e.d[0] - 1);
#pragma unroll 1
        for (int s = 1; s < e.n; ++s) {
#pragma unroll 1
            for (int q = 0; q < 4; ++q) {
                fq_gather<T>(full, acc, g);
                fq_mul_split<T, false>(acc, full, acc, g);
            }
            const int d = e.d[s];
            if (d) {
                tab_get(y, tab, d - 1);
                fq_gather<T>(full, acc, g);
                fq_mul_split<T, false>(acc, full, y, g);
            }
        }
        fq_reduce_split<T>(acc, acc, g);
        if (me < n)
#pragma unroll
            for (int j = 0; j < W; ++j) {
                const long long k = W * lane + j;
                o[L == kRows ? i * FP_LIMBS + k : k * n + i] = acc.v[j];
            }
    }
}

// ---------------------------------------------------------------------------
// Scalar multiplication: the point steps chained in one launch
// ---------------------------------------------------------------------------
//
// pt_mul_shared<E> replaces _shared_mul_call (pallas_plane.py:625: one
// jax.jit of the unrolled steps) and the cofactor clear of the reference's
// hash-to-G2 (charon_tpu/ops/h2c.py:216, a lax.scan): k*P for one scalar k
// known on the host, MSB-first double-and-add, a double per bit after the
// first and an add of P per set bit, the order of the port's earlier loop of
// pt_double / pt_add launches, so the Jacobian outputs are that loop's bit
// for bit. The bits arrive by value in the parameter space, as fe_pow's
// digits: every group reads the same bit at the same step, so the branch on
// it is uniform.
//
// pt_mul_windowed<E> replaces _scalar_mul_windowed (pallas_plane.py:677,
// the MSM of _msm_reduce_jit :746): per-element k*P from (windows, n) uint8
// MSB-first 4-bit digit planes, read in place (the low 4 bits of each). The
// reference's 16-entry table k*P first (7 doubles, 7 adds: an even entry is
// the double of entry k/2, an odd one entry k-1 plus P), then from infinity
// per window 4 doubles and one unified add of the entry the digit selects,
// digit 0 the all-zero infinity entry.
//
// pt_mul_shared gives each point a group for the whole chain, as the point
// kernels do for one step, and walks the same schedules (Sched<kPtDouble,
// E>, Sched<kPtAdd, E>) through run_levels on one scratch of slots in
// shared memory; the groups never sync with each other. Its group is G =
// kMulG1 / kMulG2 teams of T = kMulLanes1 / kMulLanes2 lanes (at T = 4, 16
// lanes a G1 point, two a warp, and 32 a G2 point, a warp each),
// kMulPoints1 / kMulPoints2 = 8 / 4 points a block, so that at the main
// path's widths (1,024 G1 points, 1 and 64 G2 points) a warp has its SM
// sub-partition to itself (16 points a block put four G2 warps on each); a
// product runs split over a team (fq_mul_split), a linear operation whole
// on every lane of its team (split, it would add the lanes' carry
// resolution); the whole warp runs the chain in step, so its syncs take the
// whole warp's mask too (8% faster at E = 1 than the point's 16 lanes). The
// lane split adds no slot and no shared memory: the block's slots are sized
// for 16 points as the point kernels' layout. It stages the schedule tables
// in shared memory (stage_tables: 1,856 B a block). The accumulator lives in
// slots 0..3E-1, the inputs of both schedules; a double ends with the group
// copying the schedule's outputs into them, an add starts by copying its
// addend into slots 3E..6E-1 and ends by copying the slots that
// pt_add_kernel's selects choose (the P+P double where H = R = 0, infinity,
// P or Q). Every copy goes through registers between two group syncs, 16
// bytes at a time, so a schedule's output slot may be one of its input
// slots. P stays in slots past the scratch.
//
// pt_mul_windowed walks the same schedules with the block's points as the
// lanes and the block's ranks (groups of lanes) as the schedule's threads
// (below, at its kernel): at the sweep's 4,096 points a group of 8 threads a
// point left most lanes of a warp idle in the narrow levels and walked the
// level tables per lane; a rank issues only where it has an operation.
//
// What bounds them: latency. The chain has 635 + 304 steps for the cofactor
// clear (one point, one group: nothing hides it), 143 for the G1 subgroup
// check and 14 + 5 x windows for the windowed product, and a step waits
// through its formula's dependent product levels (3 and 5 at E = 2) and
// linear levels (6 and 8); the card's rates bound none of them (the
// operations of all steps over the card's integer rate are ~1 us for the
// cofactor clear and ~1 ms for the sweep). A product level waits through one
// fq_mul (~1,320 instructions on one thread, IMAD and IADD3 in equal parts:
// PERF.md, from the SASS) or one split product (its step's critical path and
// instructions from the SASS, PERF.md). The level loops and the step loops
// are not unrolled (code size: fe_pow's unrolled squaring loop was slower
// with every SM busy). pt_mul_shared's group sizes: 8 at E = 2 as the point
// kernels (16 was 8% faster at one point, 18% slower at 64 and 79% at
// 4,096), 4 at E = 1. Lanes a product: 4 (2 was slower at every width of the
// main path; `chip_smoke.py --ab` with kMulLanes1/2, PERF.md).
constexpr int kMulG1 = 4;
constexpr int kMulG2 = 8;
constexpr int kMulLanes1 = 4;
constexpr int kMulLanes2 = 4;
constexpr int kMulPoints1 = 8;
constexpr int kMulPoints2 = 4;
constexpr int kMulMaxBits = 640;     // the largest scalar, H_EFF_G2, has 636 bits
constexpr int kWinTable = 15;        // entries 1..15 of the window table
// pt_mul_windowed's block shapes: points a block, lanes a product (P * T =
// 32 past one lane) and ranks a block; at E = 2 the points a block up to
// kWinNarrowMax points and past it
constexpr int kWinNarrowMax = 2048;
constexpr int kWin2NarrowPoints = 16;
constexpr int kWin2WidePoints = 32;
constexpr int kWin2Lanes = 1;
constexpr int kWin2Ranks = 16;
constexpr int kWin1Points = 8;
constexpr int kWin1Lanes = 4;
constexpr int kWin1Ranks = 8;

template <int E>
struct MulTraits {
    static constexpr int G = E == 1 ? kMulG1 : kMulG2;
    // pt_mul_shared: lanes a product, points a block
    static constexpr int T = E == 1 ? kMulLanes1 : kMulLanes2;
    static constexpr int NP = E == 1 ? kMulPoints1 : kMulPoints2;
    // slots of the scratch: the larger of the two schedules
    static constexpr int kScratch = Sched<kPtDouble, E>::kSlots > Sched<kPtAdd, E>::kSlots
                                        ? Sched<kPtDouble, E>::kSlots
                                        : Sched<kPtAdd, E>::kSlots;
};

struct MulBits {
    uint32_t w[kMulMaxBits / 32];    // bit b (b = 0 the most significant) at w[b / 32] >> b % 32
    int n;
};

// The 3E Fq of a point from src(i) to dst(i), i < 3E (src(i) null: zeros), by
// the group: each thread loads its share of the 16-byte words, the group
// syncs, stores and syncs again.
template <int E, int G, class Src, class Dst>
__device__ __forceinline__ void group_copy(Src src, Dst dst, int rank, unsigned mask) {
    constexpr int Q = FP_LIMBS / 4, N = 3 * E * Q, K = (N + G - 1) / G;
    uint4 v[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
        const int w = rank + k * G;
        if (w < N) {
            const uint32_t* p = src(w / Q);
            v[k] = p ? reinterpret_cast<const uint4*>(p)[w % Q] : make_uint4(0u, 0u, 0u, 0u);
        }
    }
    __syncwarp(mask);
#pragma unroll
    for (int k = 0; k < K; ++k) {
        const int w = rank + k * G;
        if (w < N) reinterpret_cast<uint4*>(dst(w / Q))[w % Q] = v[k];
    }
    __syncwarp(mask);
}

// acc = 2 * acc (acc: slots 0..3E-1), by the point's G teams of T lanes (q:
// this thread's lane in the point's G * T, g: its team, mask: the point's)
template <int E, int T>
__device__ void mul_double(const SchedTables& tab, uint32_t* sm, int pt, int q, const FqGroup<T>& g,
                           unsigned mask) {
    typedef Sched<kPtDouble, E> S;
    constexpr int G = MulTraits<E>::G;
    run_levels<G, T>(tab, sm, S::kLevel0, S::kLevel0 + S::kLevels, pt, q / T, g, mask);
    group_copy<E, G * T>(
        [&](int i) -> const uint32_t* { return sm + sword(tab.slots[S::kOut + i], pt); },
        [&](int i) { return sm + sword(i, pt); }, q, mask);
}

// acc = acc + a, a(i) the addend's Fq i (null: zero): pt_add_kernel's
// add_levels, then the selected slots copied into acc
template <int E, int T, class A>
__device__ __forceinline__ void mul_add(const SchedTables& tab, uint32_t* sm, A a, int pt, int q,
                                        const FqGroup<T>& g, unsigned mask) {
    constexpr int G = MulTraits<E>::G;
    group_copy<E, G * T>(a, [&](int i) { return sm + sword(3 * E + i, pt); }, q, mask);
    const int o = add_levels<E, G, T>(tab, sm, pt, q / T, g, mask);
    group_copy<E, G * T>(
        [&](int i) -> const uint32_t* {
            return o < 0 ? nullptr : sm + sword(tab.slots[o + i], pt);
        },
        [&](int i) { return sm + sword(i, pt); }, q, mask);
}

// X, Y, Z of each of the block's NP points from slots c * E + e.
template <int E, int T, int NP = kPoints>
__device__ __forceinline__ void store_acc(uint32_t* const (&dst)[3], const uint32_t* sm,
                                          long long base, long long n) {
    constexpr int W = E * FP_LIMBS * NP, K = (W + T - 1) / T;
#pragma unroll
    for (int c = 0; c < 3; ++c)
#pragma unroll
        for (int k = 0; k < K; ++k) {
            const int w = threadIdx.x + k * T, pt = w % NP, ej = w / NP;
            if (w < W && base + pt < n)
                dst[c][ej * n + base + pt] = sm[sword(c * E + ej / FP_LIMBS, pt) + ej % FP_LIMBS];
        }
}

template <int E>
__global__ void __launch_bounds__(MulTraits<E>::G * MulTraits<E>::T * MulTraits<E>::NP)
    pt_mul_shared_kernel(const uint32_t* x, const uint32_t* y, const uint32_t* z, uint32_t* ox,
                         uint32_t* oy, uint32_t* oz, long long n, const __grid_constant__ MulBits k) {
    constexpr int T = MulTraits<E>::T, GT = MulTraits<E>::G * T, NP = MulTraits<E>::NP,
                  kP = MulTraits<E>::kScratch;
    static_assert((kP + 3 * E) * kSlotWords * 4 + sizeof(SchedStage) <= 48 * 1024,
                  "static shared memory");
    __shared__ __align__(16) uint32_t sm[(kP + 3 * E) * kSlotWords];
    __shared__ SchedStage stage;
    const long long base = (long long)blockIdx.x * NP;
    const int pt = threadIdx.x / GT, q = threadIdx.x % GT;
    const uint32_t* const src[3] = {x, y, z};
    load_points<E, 3, GT * NP, NP>(sm + kP * kSlotWords, src, base, n);
    const SchedTables tab = stage_tables(stage);
    __syncthreads();
    // for T > 1 every point of a warp with a point below n runs (the
    // others on zeros, ∞, and store nothing): the split products' shuffles
    // and the level syncs take the whole warp
    if (base + (T > 1 ? (int)(threadIdx.x & ~31u) / GT : pt) < n) {
        const unsigned mask = T > 1 ? FP_WARP : group_mask<GT>();
        const FqGroup<T> g = fq_group<T>(q % T, threadIdx.x % 32 - q % T);
        auto P = [&](int i) -> const uint32_t* { return sm + sword(kP + i, pt); };
        group_copy<E, GT>(P, [&](int i) { return sm + sword(i, pt); }, q, mask);
#pragma unroll 1
        for (int b = 1; b < k.n; ++b) {
            mul_double<E, T>(tab, sm, pt, q, g, mask);
            if (k.w[b >> 5] >> (b & 31) & 1u) mul_add<E, T>(tab, sm, P, pt, q, g, mask);
        }
    }
    __syncthreads();
    uint32_t* const dst[3] = {ox, oy, oz};
    store_acc<E, GT * NP, NP>(dst, sm, base, n);
}

// pt_mul_windowed: a rank a group of lanes, a point a lane (or T lanes).
// A block holds P points and R ranks of P * T lanes, lanes l * T ..
// l * T + T - 1 of a rank on point l (P * T = 32: a warp a rank; P = 16, T
// = 1: two ranks a warp); operation j of a schedule level runs on rank j %
// R for all P points at once, so a warp with no operation in a
// level issues nothing there, the lanes of a rank run the same operation on
// the same slots (the level tables' reads are uniform broadcasts, a warp's
// branches on an operation's kind uniform), and the block syncs once a
// level (__syncthreads). A product runs on one lane (T = 1: fq_mul) or split
// over the point's T lanes (fq_mul_split<T>, whose shuffles take the rank's
// whole warp), each lane storing its 12 / T limbs; a linear operation runs
// whole on each of the T lanes, each storing its limbs. A slot is 12 words
// for each of the P points, lane-minor: limbs 4q..4q+3 of slot s of point l
// in the uint4 at (s * 3 + q) * P + l, so a rank reads a slot in three
// 16-byte accesses a lane (the T lanes of a point read the same words),
// without bank conflicts for any slot a lane picks. The window table's 16
// entries (entry 0 zeros) sit past the scratch; the unified add reads its
// addend Q in place from the entry the point's digit selects (the
// schedule's Q slots, 3E..6E-1, are read-only inputs, mapped per lane). A
// double ends with its outputs copied into the accumulator's slots
// (0..3E-1), an add with each point's selected slots copied there (none
// where Q is infinity), the copies spread over the block's lanes. The P+P
// double of the add runs where any of the block's points needs it (every
// warp holds all P points, so __any_sync agrees in every warp). Points past
// n run on zeros (infinity, digit 0) and store nothing.
//
// What bounds it on the H100: the chain of levels and the SM's issue, not
// the card's rates (their bound is ~1 ms for the sweep). A window is 19
// product levels (3 a double, 5 the add at E = 2) and 32 linear ones; a
// product on one lane is ~1,320 instructions (fq_mul, IMAD and IADD3 in
// equal parts), so a level of 3 products keeps 3 of an SM's warps busy and
// one of 13 fills every sub-partition's issue. Shapes, from `chip_smoke.py
// --ab` (PERF.md, PR 8): at E = 2 32 points a block at the sweep's 4,096
// (one block an SM; 16 points were 8% slower, products on 2 lanes 14%),
// 16 points a block at the MSM's 2,048 (32 leave 68 SMs idle: 28% slower),
// 16 ranks (8 were 1.5-4.7% slower); at E = 1 (1,024 points) products split
// over 4 lanes, 8 points a block (one lane a product was 59% slower).
template <int E, int P, int T, int R>
struct WinTraits {
    static_assert(32 % (P * T) == 0 && (T == 1 || P * T == 32) && FP_LIMBS % T == 0,
                  "whole ranks a warp; a split product's rank a whole warp");
    static constexpr int kScratch = MulTraits<E>::kScratch;
    static constexpr int kEntry = 3 * E;                           // slots an entry
    static constexpr int kSlots = kScratch + (kWinTable + 1) * kEntry;
    static constexpr int kSmemBytes = kSlots * 3 * P * 16;
    static constexpr int kThreads = P * T * R;
};
static_assert(WinTraits<2, 32, 1, 1>::kSmemBytes <= 227 * 1024, "the block's table fits an SM");

// this thread's point in its block
template <int P, int T>
__device__ __forceinline__ int win_point() {
    return threadIdx.x / T % P;
}

// the point's uint4 of slot s (its q-th at [q * P]); slots 3E..6E-1 map to
// those from qb on (qb = 3E: no remap)
template <int E, int P, int T>
__device__ __forceinline__ uint4* win_slot(uint4* sm, int s, int qb) {
    const int d = s - 3 * E;
    return sm + ((unsigned)d < 3u * E ? qb + d : s) * 3 * P + win_point<P, T>();
}

template <int P>
__device__ __forceinline__ void win_load(Fq& x, const uint4* p) {
#pragma unroll
    for (int q = 0; q < 3; ++q) {
        const uint4 v = p[q * P];
        x.v[4 * q] = v.x;
        x.v[4 * q + 1] = v.y;
        x.v[4 * q + 2] = v.z;
        x.v[4 * q + 3] = v.w;
    }
}

// limbs L * t .. L * t + L - 1 (L = 12 / T) of a slot: x.v[j] of them, or,
// T = 1, the whole slot in three 16-byte stores
template <int P, int T, class X>
__device__ __forceinline__ void win_store(uint4* p, const X& x) {
    constexpr int L = FP_LIMBS / T;
    if constexpr (T == 1) {
#pragma unroll
        for (int q = 0; q < 3; ++q)
            p[q * P] = make_uint4(x.v[4 * q], x.v[4 * q + 1], x.v[4 * q + 2], x.v[4 * q + 3]);
    } else {
        uint32_t* const w = reinterpret_cast<uint32_t*>(p);
        const int t = threadIdx.x % T;
#pragma unroll
        for (int j = 0; j < L; ++j) {
            const int k = L * t + j;
            w[k / 4 * 4 * P + k % 4] = x.v[sizeof(x.v) == 4 * L ? j : k];
        }
    }
}

// x = slot a, a + b or a - b (b = kSchedNone: a alone)
template <int E, int P, int T>
__device__ __forceinline__ void win_operand(Fq& x, uint4* sm, int a, int b, bool sub, int qb) {
    win_load<P>(x, win_slot<E, P, T>(sm, a, qb));
    if (b == kSchedNone) return;
    Fq y;
    win_load<P>(y, win_slot<E, P, T>(sm, b, qb));
    fq_addsub(x, x, y, sub);
}

// One schedule operation for the rank's P points.
template <int E, int P, int T>
__device__ __forceinline__ void win_op(uint4* sm, uint64_t op, bool mul, int qb) {
    const int flags = (int)(op >> 40);
    Fq x, y, z;
    win_operand<E, P, T>(x, sm, op >> 8 & 0xff, op >> 16 & 0xff, flags & 1, qb);
    win_operand<E, P, T>(y, sm, op >> 24 & 0xff, op >> 32 & 0xff, flags & 2, qb);
    uint4* const dst = win_slot<E, P, T>(sm, op & 0xff, qb);
    if constexpr (T > 1) {
        if (mul) {
            const int t = threadIdx.x % T;
            const FqGroup<T> g = fq_group<T>(t, threadIdx.x % 32 - t);
            FqSlice<FP_LIMBS / T> ys, r;
            fq_slice<T>(ys, y, g);
            fq_mul_split<T>(r, x, ys, g);
            win_store<P, T>(dst, r);
            return;
        }
    }
    if (mul)
        fq_mul(z, x, y);
    else
        fq_addsub(z, x, y, flags & 4);
    win_store<P, T>(dst, z);
}

// Levels [first, last) of the schedule tables: operations rank, rank +
// R, ... of each level on this rank, then the block's sync. (Fetching the
// rank's first operation of the next level during a level, as run_levels
// does, was 7-12% slower here: PERF.md, PR 8.)
template <int E, int P, int T, int R>
__device__ void win_levels(uint4* sm, int first, int last, int rank, int qb) {
#pragma unroll 1
    for (int L = first; L < last; ++L) {
        const uint32_t lv = kSchedLevels[L];
        const int op0 = lv & 0xffff, count = lv >> 16 & 0xff;
        const bool mul = lv >> 24;
#pragma unroll 1
        for (int k = rank; k < count; k += R)
            win_op<E, P, T>(sm, kSchedOps[op0 + k], mul, qb);
        __syncthreads();
    }
}

template <int E, int P, int T>
__device__ __forceinline__ bool win_zero(uint4* sm, int at, int qb) {
    bool zero = true;
#pragma unroll
    for (int e = 0; e < E; ++e) {
        Fq x;
        win_load<P>(x, win_slot<E, P, T>(sm, kSchedSlots[at + e], qb));
        zero = zero && fq_is_zero(x);
    }
    return zero;
}

// Slots dst..dst+3E-1 = slots src(i), i < 3E, each point its own src (src
// < 0: zeros), the 9E uint4 of a point spread over the ranks and the
// point's T lanes; then the sync.
template <int E, int P, int T, int R, class Src>
__device__ __forceinline__ void win_copy(uint4* sm, int dst, Src src, int rank) {
    const int l = win_point<P, T>();
#pragma unroll 1
    for (int i = rank * T + threadIdx.x % T; i < 9 * E; i += R * T) {
        const int s = src(i / 3);
        sm[((dst + i / 3) * 3 + i % 3) * P + l] =
            s < 0 ? make_uint4(0u, 0u, 0u, 0u) : sm[(s * 3 + i % 3) * P + l];
    }
    __syncthreads();
}

// acc = 2 acc
template <int E, int P, int T, int R>
__device__ void win_double(uint4* sm, int rank) {
    typedef Sched<kPtDouble, E> S;
    win_levels<E, P, T, R>(sm, S::kLevel0, S::kLevel0 + S::kLevels, rank, 3 * E);
    win_copy<E, P, T, R>(sm, 0, [](int i) { return (int)kSchedSlots[S::kOut + i]; }, rank);
}

// acc = acc + the table entry at slot qb (each point its own), with
// pt_add_kernel's selects
template <int E, int P, int T, int R>
__device__ void win_add(uint4* sm, int rank, int qb) {
    typedef Sched<kPtAdd, E> S;
    win_levels<E, P, T, R>(sm, S::kLevel0, S::kLevel0 + S::kMain, rank, qb);
    const bool p_inf = win_zero<E, P, T>(sm, S::kIn + 2 * E, qb);
    const bool q_inf = win_zero<E, P, T>(sm, S::kIn + 5 * E, qb);
    const bool h_zero = win_zero<E, P, T>(sm, S::kH, qb);
    const bool r_zero = win_zero<E, P, T>(sm, S::kR, qb);
    __syncthreads();   // every rank has read P before the copy writes acc
    if (__any_sync(FP_WARP, !p_inf && !q_inf && h_zero && r_zero))
        win_levels<E, P, T, R>(sm, S::kLevel0 + S::kMain, S::kLevel0 + S::kLevels, rank, qb);
    // the sum's slots: Q, P (acc itself: nothing to copy), the general sum,
    // the double, or infinity
    const int o = p_inf ? -2 : q_inf ? -3 : !h_zero ? S::kOut : r_zero ? S::kDblOut : -1;
    win_copy<E, P, T, R>(sm, 0, [&](int i) {
        return o == -2 ? qb + i : o == -3 ? i : o < 0 ? -1 : (int)kSchedSlots[o + i];
    }, rank);
}

template <int E, int P, int T, int R>
__global__ void __launch_bounds__(WinTraits<E, P, T, R>::kThreads)
    pt_mul_windowed_kernel(const uint32_t* x, const uint32_t* y, const uint32_t* z, uint32_t* ox,
                           uint32_t* oy, uint32_t* oz, long long n, const uint8_t* digits,
                           int n_win) {
    typedef WinTraits<E, P, T, R> W;
    extern __shared__ __align__(16) uint4 smv[];
    uint4* const sm = smv;
    uint32_t* const smw = reinterpret_cast<uint32_t*>(smv);
    const long long base = (long long)blockIdx.x * P;
    const int rank = threadIdx.x / (P * T), l = win_point<P, T>();
    const int first = rank * T + threadIdx.x % T, step = R * T;
    const long long lane = base + l;
    auto entry = [](int t) { return W::kScratch + t * W::kEntry; };
    // P into slots 0..3E-1, word j of Fq c * E + e at ((s * 3 + j / 4) * P +
    // l) * 4 + j % 4; entry 0 zeros
    const uint32_t* const src[3] = {x, y, z};
#pragma unroll 1
    for (int w = first; w < 3 * E * FP_LIMBS; w += step) {
        const int c = w / (E * FP_LIMBS), ej = w % (E * FP_LIMBS), j = ej % FP_LIMBS;
        smw[(((c * E + ej / FP_LIMBS) * 3 + j / 4) * P + l) * 4 + j % 4] =
            lane < n ? src[c][(long long)ej * n + lane] : 0u;
    }
#pragma unroll 1
    for (int i = first; i < 9 * E; i += step)
        sm[((entry(0) + i / 3) * 3 + i % 3) * P + l] = make_uint4(0u, 0u, 0u, 0u);
    __syncthreads();
    win_copy<E, P, T, R>(sm, entry(1), [](int i) { return i; }, rank);
#pragma unroll 1
    for (int t = 2; t <= kWinTable; ++t) {        // acc holds entry t - 1
        if (t % 2 == 0) {
            if (t > 2) win_copy<E, P, T, R>(sm, 0, [&](int i) { return entry(t / 2) + i; }, rank);
            win_double<E, P, T, R>(sm, rank);
        } else {
            win_add<E, P, T, R>(sm, rank, entry(1));
        }
        win_copy<E, P, T, R>(sm, entry(t), [](int i) { return i; }, rank);
    }
    win_copy<E, P, T, R>(sm, 0, [](int) { return -1; }, rank);
#pragma unroll 1
    for (int w = 0; w < n_win; ++w) {
#pragma unroll 1
        for (int q = 0; q < 4; ++q) win_double<E, P, T, R>(sm, rank);
        const int d = lane < n ? digits[(long long)w * n + lane] & 15 : 0;
        win_add<E, P, T, R>(sm, rank, entry(d));
    }
    uint32_t* const dst[3] = {ox, oy, oz};
#pragma unroll 1
    for (int w = first; w < 3 * E * FP_LIMBS; w += step) {
        const int c = w / (E * FP_LIMBS), ej = w % (E * FP_LIMBS), j = ej % FP_LIMBS;
        if (lane < n)
            dst[c][(long long)ej * n + lane] =
                smw[(((c * E + ej / FP_LIMBS) * 3 + j / 4) * P + l) * 4 + j % 4];
    }
}

// ---------------------------------------------------------------------------
// The masked group reduction: per-group sums of a plane of points
// ---------------------------------------------------------------------------
//
// pt_reduce_groups<E> replaces what the reference runs for each group g of
// the FROST share check's MSM (charon_tpu/ops/plane_agg.py:1661, :1683), for
// the RLC MSM of msm_sum (pallas_plane.py:754) and, at E = 2, for the fused
// slot's and the bulk verify's combined sig + pk MSM (the signature lanes one
// group, each message's embedded pk lanes another): jnp.where(gmask[g], P,
// 0), the lane- and sublane-halving pt_add levels of _reduce_tree_jit
// (pallas_plane.py:763) and the host's 127 bigint adds of _host_fold (:778),
// here for every group of a call at once and to one point each: out[g] = the
// sum of the lanes i with gid[i] == g (an id outside [0, G), -1 for padding,
// is in no group; an empty group gives infinity, all zeros).
//
// The adds are pt_mul_windowed's win_add, pt_add_kernel's unified add and
// selects (P + P, P + (-P), inf + Q, inf + inf) on the same block shape: a
// block holds kRedPoints accumulators as its points (a point on kRedLanes
// lanes, products split over them) and kRedRanks ranks of lanes, the add's
// addend in slots past the scratch. Two launches a call:
//   1. a block (g, b) for each group and span of kRedSpan lanes: from zeros,
//      accumulator l adds lane b * kRedSpan + j * kRedPoints + l at step j
//      where that lane is in g, zeros where it is not (the reference's
//      masked plane), then the accumulators are folded in halving steps
//      (l += l + h for l < h; the others add zeros) into a partial sum, at
//      element g * nb + b of a scratch plane (nb spans);
//   2. a block a group folds its nb partials the same way.
// The plain version (ops/curve.py pt_reduce_groups_plain) adds in this
// order, so the Jacobian words are its own bit for bit; its sum is the
// reference's as an affine point (another tree order gives another
// representative).
//
// What bounds it: the chain of dependent adds, as pt_mul_windowed. A call at
// 1,024 lanes and 4 groups moves 148 KB (each lane's X, Y, Z and id read
// once) against 1,024 adds of 4 Fq squares and 12 products (~8.9 M
// multiply-adds): ~0.53 us at the card's integer rate. Its chain is 8 + 3
// adds in the first launch and 2 + 3 in the second, ~6 us an add: ~100 us a
// call on the H100 (PERF.md). At E = 2 an add is 44 Fq products on the same
// lanes (the Karatsuba forms), so the chain is ~3x as long a step.
constexpr int kRedPoints = 8;
constexpr int kRedLanes = 4;
constexpr int kRedRanks = 8;
constexpr int kRedSpan = 64;         // lanes a block of the first launch

template <int E>
struct RedTraits {
    typedef WinTraits<E, kRedPoints, kRedLanes, kRedRanks> W;
    static constexpr int kA = W::kScratch;                   // the addend's slots
    static constexpr int kWords = (W::kScratch + 3 * E) * 3 * kRedPoints;   // uint4s
};

// Block k = g * nb + b of the grid: accumulator l adds element base + i of
// the planes (limb stride ld), i = b * span + j * kRedPoints + l for j <
// span / kRedPoints, where i < n and (gid null or gid[i] == g); base = 0
// with gid, else g * n (n elements a group, the partials of launch 1). The
// block's sum goes to element k of the outputs (limb stride ldo).
template <int E>
__global__ void __launch_bounds__(kRedPoints * kRedLanes * kRedRanks)
    pt_reduce_groups_kernel(const uint32_t* x, const uint32_t* y, const uint32_t* z, long long ld,
                            long long n, const int* gid, int nb, int span, uint32_t* ox,
                            uint32_t* oy, uint32_t* oz, long long ldo) {
    constexpr int P = kRedPoints, T = kRedLanes, R = kRedRanks, kA = RedTraits<E>::kA;
    __shared__ __align__(16) uint4 sm[RedTraits<E>::kWords];
    uint32_t* const smw = reinterpret_cast<uint32_t*>(sm);
    const int g = blockIdx.x / nb, b = blockIdx.x % nb;
    const int rank = threadIdx.x / (P * T), l = win_point<P, T>();
    const int first = rank * T + threadIdx.x % T, step = R * T;
    const long long base = gid ? 0 : (long long)g * n;
    const uint32_t* const src[3] = {x, y, z};
    // accumulators from zeros
#pragma unroll 1
    for (int i = first; i < 9 * E; i += step) sm[(i / 3 * 3 + i % 3) * P + l] = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll 1
    for (int j = 0; j < span / P; ++j) {
        const long long i = (long long)b * span + j * P + l;
        const bool take = i < n && (!gid || gid[i] == g);
#pragma unroll 1
        for (int w = first; w < 3 * E * FP_LIMBS; w += step) {
            const int c = w / (E * FP_LIMBS), ej = w % (E * FP_LIMBS), q = ej % FP_LIMBS;
            smw[(((kA + c * E + ej / FP_LIMBS) * 3 + q / 4) * P + l) * 4 + q % 4] =
                take ? src[c][ej * ld + base + i] : 0u;
        }
        __syncthreads();
        win_add<E, P, T, R>(sm, rank, kA);
    }
#pragma unroll 1
    for (int h = P / 2; h >= 1; h /= 2) {
#pragma unroll 1
        for (int i = first; i < 9 * E; i += step)
            sm[((kA + i / 3) * 3 + i % 3) * P + l] =
                l < h ? sm[(i / 3 * 3 + i % 3) * P + l + h] : make_uint4(0u, 0u, 0u, 0u);
        __syncthreads();
        win_add<E, P, T, R>(sm, rank, kA);
    }
    uint32_t* const dst[3] = {ox, oy, oz};
#pragma unroll 1
    for (int w = first; w < 3 * E * FP_LIMBS; w += step) {
        const int c = w / (E * FP_LIMBS), ej = w % (E * FP_LIMBS), q = ej % FP_LIMBS;
        if (l == 0)
            dst[c][ej * ldo + blockIdx.x] =
                smw[(((c * E + ej / FP_LIMBS) * 3 + q / 4) * P + l) * 4 + q % 4];
    }
}

inline unsigned grid_for(long long n) { return (unsigned)((n + kBlock - 1) / kBlock); }
inline unsigned point_blocks(long long n) { return (unsigned)((n + kPoints - 1) / kPoints); }

typedef const uint32_t* In;
typedef uint32_t* Out;

// The table's shared memory is past the 48 KB a launch gets by default: the
// opt-in belongs to the kernel on the current device, so it is set at every
// launch (a cheap call).
template <Layout L, int T>
int pow_launch(const void* a, void* o, long long n, const PowDigits& e, cudaStream_t s) {
    const int smem = kPowTable * FP_LIMBS / T * (int)sizeof(uint32_t) * kPowBlock;
    const cudaError_t err = cudaFuncSetAttribute(
        fe_pow_kernel<L, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    const long long threads = n * T;
    fe_pow_kernel<L, T><<<(unsigned)((threads + kPowBlock - 1) / kPowBlock), kPowBlock, smem, s>>>(
        (In)a, (Out)o, n, e);
    return (int)cudaGetLastError();
}

// T from the width: kPowLanes up to kPowSplitMax elements, one thread an
// element past it
template <Layout L>
int pow_launch(const void* a, void* o, long long n, const PowDigits& e, cudaStream_t s) {
    return n <= kPowSplitMax ? pow_launch<L, kPowLanes>(a, o, n, e, s)
                             : pow_launch<L, 1>(a, o, n, e, s);
}

template <int E>
int mul_shared_launch(const void* x, const void* y, const void* z, void* ox, void* oy, void* oz,
                      long long n, const MulBits& k, cudaStream_t s) {
    constexpr int GT = MulTraits<E>::G * MulTraits<E>::T, NP = MulTraits<E>::NP;
    pt_mul_shared_kernel<E><<<(unsigned)((n + NP - 1) / NP), GT * NP, 0, s>>>(
        (In)x, (In)y, (In)z, (Out)ox, (Out)oy, (Out)oz, n, k);
    return (int)cudaGetLastError();
}

// The table's slots take the block past the 48 KB a launch gets by default:
// opted into at every launch, as fe_pow's.
template <int E, int P, int T, int R>
int mul_windowed_launch(const void* x, const void* y, const void* z, void* ox, void* oy, void* oz,
                        long long n, const uint8_t* digits, int n_win, cudaStream_t s) {
    typedef WinTraits<E, P, T, R> W;
    const cudaError_t err = cudaFuncSetAttribute(
        pt_mul_windowed_kernel<E, P, T, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        W::kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    pt_mul_windowed_kernel<E, P, T, R><<<(unsigned)((n + P - 1) / P), W::kThreads,
                                         W::kSmemBytes, s>>>((In)x, (In)y, (In)z, (Out)ox,
                                                             (Out)oy, (Out)oz, n, digits, n_win);
    return (int)cudaGetLastError();
}

// The block's shape: E = 2 kWin2NarrowPoints up to kWinNarrowMax points,
// where blocks of 32 would leave SMs idle, kWin2WidePoints past it; E = 1
// one shape
template <int E>
int mul_windowed_launch(const void* x, const void* y, const void* z, void* ox, void* oy, void* oz,
                        long long n, const uint8_t* digits, int n_win, cudaStream_t s) {
    if constexpr (E == 1)
        return mul_windowed_launch<1, kWin1Points, kWin1Lanes, kWin1Ranks>(x, y, z, ox, oy, oz, n,
                                                                           digits, n_win, s);
    else if (n <= kWinNarrowMax)
        return mul_windowed_launch<2, kWin2NarrowPoints, kWin2Lanes, kWin2Ranks>(
            x, y, z, ox, oy, oz, n, digits, n_win, s);
    else
        return mul_windowed_launch<2, kWin2WidePoints, kWin2Lanes, kWin2Ranks>(
            x, y, z, ox, oy, oz, n, digits, n_win, s);
}

// Two launches: the spans' partial sums into `scratch` (3 planes of E * 12
// rows of G * nb words), then each group's nb partials into the outputs.
template <int E>
int reduce_groups_launch(const void* x, const void* y, const void* z, const int* gid, long long n,
                         int G, void* ox, void* oy, void* oz, uint32_t* scratch, cudaStream_t s) {
    constexpr int kThreads = kRedPoints * kRedLanes * kRedRanks;
    const long long nb = (n + kRedSpan - 1) / kRedSpan, ld1 = G * nb;
    uint32_t* const px = scratch;
    uint32_t* const py = px + E * FP_LIMBS * ld1;
    uint32_t* const pz = py + E * FP_LIMBS * ld1;
    pt_reduce_groups_kernel<E><<<(unsigned)(G * nb), kThreads, 0, s>>>(
        (In)x, (In)y, (In)z, n, n, gid, (int)nb, kRedSpan, px, py, pz, ld1);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const int span = (int)((nb + kRedPoints - 1) / kRedPoints * kRedPoints);
    pt_reduce_groups_kernel<E><<<(unsigned)G, kThreads, 0, s>>>(px, py, pz, ld1, nb, nullptr, 1,
                                                                 span, (Out)ox, (Out)oy, (Out)oz, G);
    return (int)cudaGetLastError();
}

// The level's table: its segments, each one's first block at `lanes`
// threads an element; returns the blocks of the launch.
inline unsigned level_table(FeLevel& L, const FeSeg* segs, int count, int lanes) {
    unsigned blocks = 0;
    for (int k = 0; k < count; ++k) {
        L.s[k] = segs[k];
        L.first[k] = blocks;
        blocks += (unsigned)((segs[k].n * lanes + kFeBlock - 1) / kFeBlock);
    }
    L.count = count;
    return blocks;
}

inline bool level_ok(const FeSeg* segs, int count, bool need_a) {
    if (!segs || count < 1 || count > kLevelSegs) return false;
    for (int k = 0; k < count; ++k) {
        const FeSeg& g = segs[k];
        if (g.n <= 0 || g.ldb < g.n || g.ldo < g.n || !g.b || !g.o ||
            (g.a ? g.lda < g.n : need_a))
            return false;
    }
    return true;
}

template <int E, int T>
int mul_level_launch(const FeSeg* segs, int count, cudaStream_t s) {
    FeLevel L;
    const unsigned blocks = level_table(L, segs, count, E == 1 ? T : 4 * T);
    fe_mul_kernel<E, T><<<blocks, kFeBlock, 0, s>>>(L);
    return (int)cudaGetLastError();
}

}  // namespace

// Launchers: plain C interface for ctypes. Each launches on the caller's
// stream, synchronises nothing, and returns cudaGetLastError() (0 = launched).
extern "C" {

// A level of count <= kLevelSegs segments (FeSeg; every n >= 1, each
// stride at least its n, a and b and o not null, at E = 2 component 1 at
// [12 * ld]): fe_mul over them all in one launch, T lanes a product as the
// level's width and E take them.
// (The table arrives as void*: a parameter of a type in the unnamed
// namespace would give the entry internal linkage.)
int charon_fe_mul_level(int E, const void* table, int count, void* stream) {
    const FeSeg* segs = (const FeSeg*)table;
    if (!level_ok(segs, count, true)) return (int)cudaErrorInvalidValue;
    long long total = 0;
    for (int k = 0; k < count; ++k) total += segs[k].n;
    cudaStream_t s = (cudaStream_t)stream;
    if (E == 1)
        return total <= kFeMul1SplitMax ? mul_level_launch<1, kFeMul1Lanes>(segs, count, s)
                                        : mul_level_launch<1, 1>(segs, count, s);
    if (E == 2)
        return total <= kFeMul2SplitMax ? mul_level_launch<2, kFeMul2Lanes>(segs, count, s)
                                        : mul_level_launch<2, 1>(segs, count, s);
    return (int)cudaErrorInvalidValue;
}

// fe_addsub over a level: segment k adds (op 0) or subtracts (op 1), a null
// a reads 0; an Fq2 segment runs as its two components, so count * E <=
// kLevelSegs.
int charon_fe_addsub_level(int E, const void* table, int count, void* stream) {
    const FeSeg* segs = (const FeSeg*)table;
    if ((E != 1 && E != 2) || count * E > kLevelSegs || !level_ok(segs, count, false))
        return (int)cudaErrorInvalidValue;
    FeSeg comps[kLevelSegs];
    for (int k = 0; k < count; ++k)
        for (int e = 0; e < E; ++e) {
            FeSeg c = segs[k];
            if (c.op != 0 && c.op != 1) return (int)cudaErrorInvalidValue;
            if (c.a) c.a += e * FP_LIMBS * c.lda;
            c.b += e * FP_LIMBS * c.ldb;
            c.o += e * FP_LIMBS * c.ldo;
            comps[k * E + e] = c;
        }
    FeLevel L;
    const unsigned blocks = level_table(L, comps, count * E, 1);
    fe_addsub_kernel<<<blocks, kFeBlock, 0, (cudaStream_t)stream>>>(L);
    return (int)cudaGetLastError();
}

// One empty kernel: the launch floor.
int charon_empty(void* stream) {
    empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
    return (int)cudaGetLastError();
}

int charon_pt_double(int E, const void* x, const void* y, const void* z, void* ox, void* oy,
                     void* oz, long long n, void* stream) {
    if (n <= 0) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    if (E == 1)
        pt_double_kernel<1, kDoubleG1><<<point_blocks(n), kDoubleG1 * kPoints, 0, s>>>(
            (In)x, (In)y, (In)z, (Out)ox, (Out)oy, (Out)oz, n);
    else if (E == 2)
        pt_double_kernel<2, kDoubleG2><<<point_blocks(n), kDoubleG2 * kPoints, 0, s>>>(
            (In)x, (In)y, (In)z, (Out)ox, (Out)oy, (Out)oz, n);
    else
        return (int)cudaErrorInvalidValue;
    return (int)cudaGetLastError();
}

int charon_pt_add(int E, const void* x1, const void* y1, const void* z1, const void* x2,
                  const void* y2, const void* z2, void* ox, void* oy, void* oz, long long n,
                  void* stream) {
    if (n <= 0) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    if (E == 1)
        pt_add_kernel<1, kAddG1><<<point_blocks(n), kAddG1 * kPoints, 0, s>>>(
            (In)x1, (In)y1, (In)z1, (In)x2, (In)y2, (In)z2, (Out)ox, (Out)oy, (Out)oz, n);
    else if (E == 2)
        pt_add_kernel<2, kAddG2><<<point_blocks(n), kAddG2 * kPoints, 0, s>>>(
            (In)x1, (In)y1, (In)z1, (In)x2, (In)y2, (In)z2, (Out)ox, (Out)oy, (Out)oz, n);
    else
        return (int)cudaErrorInvalidValue;
    return (int)cudaGetLastError();
}

inline bool aligned16(const void* a, const void* b, const void* o) {
    return (((uintptr_t)a | (uintptr_t)b | (uintptr_t)o) & 15) == 0;
}

// Every rows launcher takes (a, b, o, n, [its own argument,] stream).
// fe_mul_rows: E = 1, n rows (n, 12); E = 2, n Fq2 rows (n, 2, 12).
int charon_fe_mul_rows(const void* a, const void* b, void* o, long long n, int E, void* stream) {
    if (n <= 0 || !aligned16(a, b, o)) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    if (E == 1)
        fe_mul_rows_kernel<1><<<grid_for(n), kBlock, 0, s>>>((In)a, (In)b, (Out)o, n);
    else if (E == 2)
        fe_mul_rows_kernel<2><<<grid_for(n * kMulRowsG), kBlock, 0, s>>>((In)a, (In)b, (Out)o, n);
    else
        return (int)cudaErrorInvalidValue;
    return (int)cudaGetLastError();
}

// Rows [0, n_add) add, rows [n_add, n) subtract.
int charon_fe_add_rows(const void* a, const void* b, void* o, long long n, long long n_add,
                       void* stream) {
    if (n <= 0 || n_add < 0 || n_add > n || !aligned16(a, b, o)) return (int)cudaErrorInvalidValue;
    fe_add_rows_kernel<<<grid_for(n), kBlock, 0, (cudaStream_t)stream>>>((In)a, (In)b, (Out)o, n,
                                                                         n_add);
    return (int)cudaGetLastError();
}

// o = a^e for n Fq elements: layout 0 an (1, 12, n) plane, 1 (n, 12) rows
// (16-byte aligned); e as n_digits MSB-first 4-bit windows, digits[0] != 0.
int charon_fe_pow(int layout, const void* a, void* o, long long n, const uint8_t* digits,
                  int n_digits, void* stream) {
    if (n <= 0 || n_digits < 1 || n_digits > kPowMaxDigits || digits[0] == 0 ||
        (layout == kRows && !aligned16(a, a, o)))
        return (int)cudaErrorInvalidValue;
    PowDigits e;
    e.n = n_digits;
    for (int k = 0; k < kPowMaxDigits; ++k) {
        if (k < n_digits && digits[k] > kPowTable) return (int)cudaErrorInvalidValue;
        e.d[k] = k < n_digits ? digits[k] : 0;
    }
    if (layout == kPlane) return pow_launch<kPlane>(a, o, n, e, (cudaStream_t)stream);
    if (layout == kRows) return pow_launch<kRows>(a, o, n, e, (cudaStream_t)stream);
    return (int)cudaErrorInvalidValue;
}

// k * P for one scalar k: n_bits bytes of 0 or 1, most significant first,
// bits[0] = 1, n_bits <= kMulMaxBits.
int charon_pt_mul_shared(int E, const void* x, const void* y, const void* z, void* ox, void* oy,
                         void* oz, long long n, const uint8_t* bits, int n_bits, void* stream) {
    if (n <= 0 || n_bits < 1 || n_bits > kMulMaxBits || bits[0] != 1)
        return (int)cudaErrorInvalidValue;
    MulBits k = {};
    k.n = n_bits;
    for (int b = 0; b < n_bits; ++b) {
        if (bits[b] > 1) return (int)cudaErrorInvalidValue;
        k.w[b >> 5] |= (uint32_t)bits[b] << (b & 31);
    }
    cudaStream_t s = (cudaStream_t)stream;
    if (E == 1) return mul_shared_launch<1>(x, y, z, ox, oy, oz, n, k, s);
    if (E == 2) return mul_shared_launch<2>(x, y, z, ox, oy, oz, n, k, s);
    return (int)cudaErrorInvalidValue;
}

// Per-element k * P from digits (n_win, n) uint8, element i's window w at
// digits[w * n + i].
int charon_pt_mul_windowed(int E, const void* x, const void* y, const void* z, void* ox,
                           void* oy, void* oz, long long n, const void* digits, int n_win,
                           void* stream) {
    if (n <= 0 || n_win < 1 || !digits) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    const uint8_t* d = (const uint8_t*)digits;
    if (E == 1) return mul_windowed_launch<1>(x, y, z, ox, oy, oz, n, d, n_win, s);
    if (E == 2) return mul_windowed_launch<2>(x, y, z, ox, oy, oz, n, d, n_win, s);
    return (int)cudaErrorInvalidValue;
}

// out[g] = the sum of the n points (E, 12, n) whose gid (n int32) is g, for
// g < G, as three (E, 12, G) planes; scratch holds 3 * E * 12 * G * nb words,
// nb = ceil(n / kRedSpan). E = 1 or 2.
int charon_pt_reduce_groups(int E, const void* x, const void* y, const void* z, const void* gid,
                            long long n, int G, void* ox, void* oy, void* oz, void* scratch,
                            void* stream) {
    if (n <= 0 || G < 1 || !gid || !scratch) return (int)cudaErrorInvalidValue;
    if (E == 1)
        return reduce_groups_launch<1>(x, y, z, (const int*)gid, n, G, ox, oy, oz,
                                       (uint32_t*)scratch, (cudaStream_t)stream);
    if (E == 2)
        return reduce_groups_launch<2>(x, y, z, (const int*)gid, n, G, ox, oy, oz,
                                       (uint32_t*)scratch, (cudaStream_t)stream);
    return (int)cudaErrorInvalidValue;
}

}  // extern "C"
