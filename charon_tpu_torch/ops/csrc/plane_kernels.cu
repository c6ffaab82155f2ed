// The port's field/point kernels for Hopper (sm_90a), one thread per batch
// element, over two layouts of uint32 limbs:
//   planes: limb-major (E, 12, n): limb j of component e of element i lives
//     at [(e*12 + j)*n + i], so the 32 threads of a warp read 32
//     neighbouring words of one limb row;
//   rows: (n, 12), element i limb j at [i*12 + j] — the layout of the
//     pairing, tower and hash-to-curve code (ops/rows.py), read in place
//     with no transpose.
//
// Each kernel replaces one Pallas body of charon_tpu/ops/pallas_plane.py:
//   fe_mul<E>    -> _kern_mul    (Montgomery product; E=2 Karatsuba)
//   fe_add<E>    -> _kern_addp   ((a + b) mod p per component)
//   fe_sub<E>    -> _kern_sub    ((a - b) mod p per component; also -a)
//   pt_double<E> -> _kern_double (Jacobian dbl-2009-l, a = 0)
//   pt_add<E>    -> _kern_add    (branchless unified add with its selects)
//   fe_mul_rows  -> _kern_mul as launched by _mont_rows_call (rows, E = 1)
// and two more stand for XLA-op code of the reference's rows field plane
// (charon_tpu/ops/field.py fq_add / fq_sub / fq_neg):
//   fe_add_rows, fe_sub_rows (fq_neg(a) is fe_sub_rows(0, a))
//
// What bounds them on an H100 (3.35 TB/s; 32-bit integer multiply-adds at
// 132 SMs x 64 INT32 lanes x 1.98 GHz = 16.7 T/s, from the Hopper white
// paper's SM and the data sheet's boost clock; a 32x32->64-bit limb product
// counts as 2 of them):
//   fe_add / fe_sub: 3 x 48 B per Fq component moved, ~40 integer ops — bytes.
//   fe_mul<1>: 144 B moved against 2 x 144 limb products = 576 multiply-adds
//     — bytes, by 1.25x; fe_mul<2>: 288 B against 3 x 576 — operations, 1.2x.
//   pt_double<1> / pt_add<1>: 6 or 9 x 48 B moved against 5 or 4 Fq squares
//     (444 multiply-adds each: 78 distinct limb products + 144 for the
//     reduction) and 2 or 12 products (3,372 / 8,688) — operations, 2.3x / 4x.
//   pt_double<2> / pt_add<2>: 6 or 9 x 96 B moved against 16 or 44 Fq
//     products (9,216 / 25,344 multiply-adds) — operations, by 3x / 6x
//     (pt_add counts a double's work more on a lane that needs the P+P double).
// fe_mul_rows moves the same 144 B per product as fe_mul<1> against the same
// 576 multiply-adds, so it is bound by bytes, by 1.25x; fe_add_rows and
// fe_sub_rows move 144 B against ~36 integer ops, bound by bytes. At the
// pairing's widths (108-6,912 rows: one Fq12 product's 54 Fq products on 2
// to 128 lanes) each launch is a few dozen warps: latency- and launch-bound
// like the rest.
// At the slot's widths (1,024-12,288 elements) every kernel is far below
// either bound and is launch- and latency-bound: 4,096 threads are 128
// warps, about one per SM where an SM can hold 64. This first design is
// plain and right: the products are out-of-line calls in the point kernels
// (small code, fast build, spills to L1-cached local memory expected for
// Fq2). Making them
// fast is later work: several elements per thread, mul.wide/mad.cc carry
// chains, shared-memory staging, and fusing the composite loops (pow scan,
// windowed scalar multiplication, reduction tree) into single kernels.
#include <cuda_runtime.h>

#include "fp.cuh"

namespace {

constexpr int kBlock = 128;

template <int E>
struct FieldOf;
template <>
struct FieldOf<1> {
    typedef Fq T;
};
template <>
struct FieldOf<2> {
    typedef Fq2 T;
};

enum Layout { kPlane, kRows };

// Word index of limb j of element i (component 0) in an n-element array.
template <Layout L>
__device__ __forceinline__ long long word(long long n, long long i, int j) {
    return L == kPlane ? (long long)j * n + i : i * FP_LIMBS + j;
}

template <Layout L = kPlane>
__device__ __forceinline__ void load(Fq& x, const uint32_t* b, long long n, long long i) {
#pragma unroll
    for (int j = 0; j < FP_LIMBS; ++j) x.v[j] = b[word<L>(n, i, j)];
}

__device__ __forceinline__ void load(Fq2& x, const uint32_t* b, long long n, long long i) {
    load(x.c0, b, n, i);
    load(x.c1, b + FP_LIMBS * n, n, i);
}

template <Layout L = kPlane>
__device__ __forceinline__ void store(uint32_t* b, const Fq& x, long long n, long long i) {
#pragma unroll
    for (int j = 0; j < FP_LIMBS; ++j) b[word<L>(n, i, j)] = x.v[j];
}

__device__ __forceinline__ void store(uint32_t* b, const Fq2& x, long long n, long long i) {
    store(b, x.c0, n, i);
    store(b + FP_LIMBS * n, x.c1, n, i);
}

__device__ __forceinline__ void mul_inline(Fq& r, const Fq& a, const Fq& b) { fq_mul(r, a, b); }
__device__ __forceinline__ void mul_inline(Fq2& r, const Fq2& a, const Fq2& b) { fq2_mul(r, a, b); }

__device__ __forceinline__ long long element() {
    return (long long)blockIdx.x * blockDim.x + threadIdx.x;
}

// Replaces _kern_mul (charon_tpu/ops/pallas_plane.py:458): a*b*R^-1 mod p,
// CIOS for E=1, Karatsuba for E=2. Bound: bytes (E=1) / operations (E=2).
template <int E>
__global__ void __launch_bounds__(kBlock) fe_mul_kernel(const uint32_t* a, const uint32_t* b,
                                                        uint32_t* o, long long n) {
    const long long i = element();
    if (i >= n) return;
    typename FieldOf<E>::T x, y, r;
    load(x, a, n, i);
    load(y, b, n, i);
    mul_inline(r, x, y);
    store(o, r, n, i);
}

// Replaces _kern_addp (pallas_plane.py:452): (a + b) mod p per component.
// Bound: bytes.
template <int E>
__global__ void __launch_bounds__(kBlock) fe_add_kernel(const uint32_t* a, const uint32_t* b,
                                                        uint32_t* o, long long n) {
    const long long i = element();
    if (i >= n) return;
    typename FieldOf<E>::T x, y, r;
    load(x, a, n, i);
    load(y, b, n, i);
    fadd(r, x, y);
    store(o, r, n, i);
}

// Replaces _kern_sub (pallas_plane.py:446): (a - b) mod p per component
// (fe_neg is fe_sub from 0). Bound: bytes.
template <int E>
__global__ void __launch_bounds__(kBlock) fe_sub_kernel(const uint32_t* a, const uint32_t* b,
                                                        uint32_t* o, long long n) {
    const long long i = element();
    if (i >= n) return;
    typename FieldOf<E>::T x, y, r;
    load(x, a, n, i);
    load(y, b, n, i);
    fsub(r, x, y);
    store(o, r, n, i);
}

// Replaces _kern_double (pallas_plane.py:433): dbl-2009-l, a = 0.
// Bound: operations (7 / 16 Fq products per element for E = 1 / 2).
template <int E>
__global__ void __launch_bounds__(kBlock) pt_double_kernel(const uint32_t* x, const uint32_t* y,
                                                           const uint32_t* z, uint32_t* ox,
                                                           uint32_t* oy, uint32_t* oz,
                                                           long long n) {
    const long long i = element();
    if (i >= n) return;
    Pt<typename FieldOf<E>::T> p, r;
    load(p.x, x, n, i);
    load(p.y, y, n, i);
    load(p.z, z, n, i);
    pt_double(r, p);
    store(ox, r.x, n, i);
    store(oy, r.y, n, i);
    store(oz, r.z, n, i);
}

// Replaces _kern_add (pallas_plane.py:439): unified add with the reference's
// selects. Bound: operations (16 / 44 Fq products per element, +7 / +16 on a
// lane that takes the P+P double).
template <int E>
__global__ void __launch_bounds__(kBlock) pt_add_kernel(const uint32_t* x1, const uint32_t* y1,
                                                        const uint32_t* z1, const uint32_t* x2,
                                                        const uint32_t* y2, const uint32_t* z2,
                                                        uint32_t* ox, uint32_t* oy, uint32_t* oz,
                                                        long long n) {
    const long long i = element();
    if (i >= n) return;
    Pt<typename FieldOf<E>::T> p, q, r;
    load(p.x, x1, n, i);
    load(p.y, y1, n, i);
    load(p.z, z1, n, i);
    load(q.x, x2, n, i);
    load(q.y, y2, n, i);
    load(q.z, z2, n, i);
    pt_add(r, p, q);
    store(ox, r.x, n, i);
    store(oy, r.y, n, i);
    store(oz, r.z, n, i);
}

// Rows kernels: one Fq row per thread, read and written in place (E = 1).
// fe_mul_rows replaces _kern_mul as _mont_rows_call launches it
// (pallas_plane.py:969, :982), without the reference's transposes into an
// (1, LIMBS, 8, W) tile. Bound: bytes, as fe_mul<1>.
__global__ void __launch_bounds__(kBlock) fe_mul_rows_kernel(const uint32_t* a, const uint32_t* b,
                                                             uint32_t* o, long long n) {
    const long long i = element();
    if (i >= n) return;
    Fq x, y, r;
    load<kRows>(x, a, n, i);
    load<kRows>(y, b, n, i);
    fq_mul(r, x, y);
    store<kRows>(o, r, n, i);
}

// Stands for the XLA-op field.fq_add of the reference's rows plane. Bound:
// bytes.
__global__ void __launch_bounds__(kBlock) fe_add_rows_kernel(const uint32_t* a, const uint32_t* b,
                                                             uint32_t* o, long long n) {
    const long long i = element();
    if (i >= n) return;
    Fq x, y, r;
    load<kRows>(x, a, n, i);
    load<kRows>(y, b, n, i);
    fq_add(r, x, y);
    store<kRows>(o, r, n, i);
}

// Stands for the XLA-op field.fq_sub (and fq_neg as 0 - a, which maps 0 to
// 0). Bound: bytes.
__global__ void __launch_bounds__(kBlock) fe_sub_rows_kernel(const uint32_t* a, const uint32_t* b,
                                                             uint32_t* o, long long n) {
    const long long i = element();
    if (i >= n) return;
    Fq x, y, r;
    load<kRows>(x, a, n, i);
    load<kRows>(y, b, n, i);
    fq_sub(r, x, y);
    store<kRows>(o, r, n, i);
}

inline unsigned grid_for(long long n) { return (unsigned)((n + kBlock - 1) / kBlock); }

typedef const uint32_t* In;
typedef uint32_t* Out;

}  // namespace

// Launchers: plain C interface for ctypes. Each launches on the caller's
// stream, synchronises nothing, and returns cudaGetLastError() (0 = launched).
extern "C" {

int charon_fe_mul(int E, const void* a, const void* b, void* o, long long n, void* stream) {
    if (n <= 0) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    if (E == 1)
        fe_mul_kernel<1><<<grid_for(n), kBlock, 0, s>>>((In)a, (In)b, (Out)o, n);
    else if (E == 2)
        fe_mul_kernel<2><<<grid_for(n), kBlock, 0, s>>>((In)a, (In)b, (Out)o, n);
    else
        return (int)cudaErrorInvalidValue;
    return (int)cudaGetLastError();
}

int charon_fe_add(int E, const void* a, const void* b, void* o, long long n, void* stream) {
    if (n <= 0) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    if (E == 1)
        fe_add_kernel<1><<<grid_for(n), kBlock, 0, s>>>((In)a, (In)b, (Out)o, n);
    else if (E == 2)
        fe_add_kernel<2><<<grid_for(n), kBlock, 0, s>>>((In)a, (In)b, (Out)o, n);
    else
        return (int)cudaErrorInvalidValue;
    return (int)cudaGetLastError();
}

int charon_fe_sub(int E, const void* a, const void* b, void* o, long long n, void* stream) {
    if (n <= 0) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    if (E == 1)
        fe_sub_kernel<1><<<grid_for(n), kBlock, 0, s>>>((In)a, (In)b, (Out)o, n);
    else if (E == 2)
        fe_sub_kernel<2><<<grid_for(n), kBlock, 0, s>>>((In)a, (In)b, (Out)o, n);
    else
        return (int)cudaErrorInvalidValue;
    return (int)cudaGetLastError();
}

int charon_pt_double(int E, const void* x, const void* y, const void* z, void* ox, void* oy,
                     void* oz, long long n, void* stream) {
    if (n <= 0) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    if (E == 1)
        pt_double_kernel<1><<<grid_for(n), kBlock, 0, s>>>((In)x, (In)y, (In)z, (Out)ox, (Out)oy,
                                                           (Out)oz, n);
    else if (E == 2)
        pt_double_kernel<2><<<grid_for(n), kBlock, 0, s>>>((In)x, (In)y, (In)z, (Out)ox, (Out)oy,
                                                           (Out)oz, n);
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
        pt_add_kernel<1><<<grid_for(n), kBlock, 0, s>>>((In)x1, (In)y1, (In)z1, (In)x2, (In)y2,
                                                        (In)z2, (Out)ox, (Out)oy, (Out)oz, n);
    else if (E == 2)
        pt_add_kernel<2><<<grid_for(n), kBlock, 0, s>>>((In)x1, (In)y1, (In)z1, (In)x2, (In)y2,
                                                        (In)z2, (Out)ox, (Out)oy, (Out)oz, n);
    else
        return (int)cudaErrorInvalidValue;
    return (int)cudaGetLastError();
}

int charon_fe_mul_rows(const void* a, const void* b, void* o, long long n, void* stream) {
    if (n <= 0) return (int)cudaErrorInvalidValue;
    fe_mul_rows_kernel<<<grid_for(n), kBlock, 0, (cudaStream_t)stream>>>((In)a, (In)b, (Out)o, n);
    return (int)cudaGetLastError();
}

int charon_fe_add_rows(const void* a, const void* b, void* o, long long n, void* stream) {
    if (n <= 0) return (int)cudaErrorInvalidValue;
    fe_add_rows_kernel<<<grid_for(n), kBlock, 0, (cudaStream_t)stream>>>((In)a, (In)b, (Out)o, n);
    return (int)cudaGetLastError();
}

int charon_fe_sub_rows(const void* a, const void* b, void* o, long long n, void* stream) {
    if (n <= 0) return (int)cudaErrorInvalidValue;
    fe_sub_rows_kernel<<<grid_for(n), kBlock, 0, (cudaStream_t)stream>>>((In)a, (In)b, (Out)o, n);
    return (int)cudaGetLastError();
}

}  // extern "C"
