// BLS12-381 Fq / Fq2 arithmetic and Jacobian point formulas for the port's
// CUDA kernels (plane_kernels.cu). Every function is __host__ __device__, so
// the same code also builds with a host C++ compiler.
//
// An Fq element is 12 little-endian 32-bit limbs, canonical in [0, p), in
// Montgomery form with R = 2^384 (the reference's R, so residues are the same
// integers as charon_tpu's 32 x 12-bit limbs). Fq2 = Fq[u]/(u^2 + 1).
//
// Formulas match the reference's in-kernel forms in
// charon_tpu/ops/pallas_plane.py: Karatsuba Fq2 products and complex
// squaring (_e_mul_many), dbl-2009-l doubling (_pt_double) and the unified
// add with its exceptional-case selects in the same order (_pt_add_unified).
// Every result is canonical, so the kernels agree bit for bit with the plain
// PyTorch versions in ops/field.py and ops/curve.py.
#pragma once

#include <stdint.h>

#if defined(__CUDACC__)
#define FP_HD __host__ __device__ __forceinline__
#define FP_NOINLINE __host__ __device__ __noinline__
#else
#define FP_HD static inline
#define FP_NOINLINE static __attribute__((noinline))
#endif

#define FP_LIMBS 12
// -p^{-1} mod 2^32
#define FP_N0 0xfffcfffdu
#define FP_P_INIT                                                          \
    {0xffffaaabu, 0xb9feffffu, 0xb153ffffu, 0x1eabfffeu, 0xf6b0f624u,      \
     0x6730d2a0u, 0xf38512bfu, 0x64774b84u, 0x434bacd7u, 0x4b1ba7b6u,      \
     0x397fe69au, 0x1a0111eau}

struct Fq {
    uint32_t v[FP_LIMBS];
};

struct Fq2 {
    Fq c0, c1;
};

template <typename F>
struct Pt {
    F x, y, z;
};

// ---------------------------------------------------------------------------
// Fq
// ---------------------------------------------------------------------------

FP_HD bool fq_is_zero(const Fq& a) {
    uint32_t acc = 0;
#pragma unroll
    for (int i = 0; i < FP_LIMBS; ++i) acc |= a.v[i];
    return acc == 0;
}

FP_HD void fq_set_zero(Fq& r) {
#pragma unroll
    for (int i = 0; i < FP_LIMBS; ++i) r.v[i] = 0;
}

// r = t + hi*2^384 reduced once: t - p when that value is >= p, else t.
FP_HD void fq_reduce_once(Fq& r, const uint32_t* t, uint32_t hi) {
    const uint32_t p[FP_LIMBS] = FP_P_INIT;
    uint32_t d[FP_LIMBS];
    uint32_t borrow = 0;
#pragma unroll
    for (int i = 0; i < FP_LIMBS; ++i) {
        uint64_t s = (uint64_t)t[i] - p[i] - borrow;
        d[i] = (uint32_t)s;
        borrow = (uint32_t)(s >> 63);
    }
    const bool ge = (hi != 0) || (borrow == 0);
#pragma unroll
    for (int i = 0; i < FP_LIMBS; ++i) r.v[i] = ge ? d[i] : t[i];
}

FP_HD void fq_add(Fq& r, const Fq& a, const Fq& b) {
    uint32_t t[FP_LIMBS];
    uint64_t c = 0;
#pragma unroll
    for (int i = 0; i < FP_LIMBS; ++i) {
        c += (uint64_t)a.v[i] + b.v[i];
        t[i] = (uint32_t)c;
        c >>= 32;
    }
    fq_reduce_once(r, t, (uint32_t)c);
}

FP_HD void fq_sub(Fq& r, const Fq& a, const Fq& b) {
    const uint32_t p[FP_LIMBS] = FP_P_INIT;
    uint32_t d[FP_LIMBS];
    uint32_t borrow = 0;
#pragma unroll
    for (int i = 0; i < FP_LIMBS; ++i) {
        uint64_t s = (uint64_t)a.v[i] - b.v[i] - borrow;
        d[i] = (uint32_t)s;
        borrow = (uint32_t)(s >> 63);
    }
    // a < b: add p back (the carry out of the top limb cancels the borrow)
    const uint32_t mask = 0u - borrow;
    uint64_t c = 0;
#pragma unroll
    for (int i = 0; i < FP_LIMBS; ++i) {
        c += (uint64_t)d[i] + (p[i] & mask);
        r.v[i] = (uint32_t)c;
        c >>= 32;
    }
}

// CIOS Montgomery product a*b*R^-1 mod p with 64-bit limb products.
FP_HD void fq_mul(Fq& r, const Fq& a, const Fq& b) {
    const uint32_t p[FP_LIMBS] = FP_P_INIT;
    uint32_t t[FP_LIMBS + 2];
#pragma unroll
    for (int j = 0; j < FP_LIMBS + 2; ++j) t[j] = 0;
#pragma unroll
    for (int i = 0; i < FP_LIMBS; ++i) {
        uint64_t c = 0;
#pragma unroll
        for (int j = 0; j < FP_LIMBS; ++j) {
            c += (uint64_t)a.v[i] * b.v[j] + t[j];
            t[j] = (uint32_t)c;
            c >>= 32;
        }
        c += t[FP_LIMBS];
        t[FP_LIMBS] = (uint32_t)c;
        t[FP_LIMBS + 1] = (uint32_t)(c >> 32);
        const uint32_t m = t[0] * FP_N0;
        c = ((uint64_t)m * p[0] + t[0]) >> 32;
#pragma unroll
        for (int j = 1; j < FP_LIMBS; ++j) {
            c += (uint64_t)m * p[j] + t[j];
            t[j - 1] = (uint32_t)c;
            c >>= 32;
        }
        c += t[FP_LIMBS];
        t[FP_LIMBS - 1] = (uint32_t)c;
        t[FP_LIMBS] = t[FP_LIMBS + 1] + (uint32_t)(c >> 32);
    }
    // t < 2p < 2^382: one conditional subtraction makes it canonical
    fq_reduce_once(r, t, t[FP_LIMBS]);
}

// ---------------------------------------------------------------------------
// Fq2
// ---------------------------------------------------------------------------

FP_HD bool fq2_is_zero(const Fq2& a) { return fq_is_zero(a.c0) && fq_is_zero(a.c1); }

FP_HD void fq2_set_zero(Fq2& r) {
    fq_set_zero(r.c0);
    fq_set_zero(r.c1);
}

FP_HD void fq2_add(Fq2& r, const Fq2& a, const Fq2& b) {
    fq_add(r.c0, a.c0, b.c0);
    fq_add(r.c1, a.c1, b.c1);
}

FP_HD void fq2_sub(Fq2& r, const Fq2& a, const Fq2& b) {
    fq_sub(r.c0, a.c0, b.c0);
    fq_sub(r.c1, a.c1, b.c1);
}

// Karatsuba: 3 Fq products.
FP_HD void fq2_mul(Fq2& r, const Fq2& a, const Fq2& b) {
    Fq v0, v1, sa, sb, s;
    fq_mul(v0, a.c0, b.c0);
    fq_mul(v1, a.c1, b.c1);
    fq_add(sa, a.c0, a.c1);
    fq_add(sb, b.c0, b.c1);
    fq_mul(s, sa, sb);
    fq_sub(r.c0, v0, v1);
    fq_sub(s, s, v0);
    fq_sub(r.c1, s, v1);
}

// Complex squaring: ((a0 + a1)(a0 - a1), 2 a0 a1), 2 Fq products.
FP_HD void fq2_sqr(Fq2& r, const Fq2& a) {
    Fq s, d, c0, t;
    fq_add(s, a.c0, a.c1);
    fq_sub(d, a.c0, a.c1);
    fq_mul(c0, s, d);
    fq_mul(t, a.c0, a.c1);
    r.c0 = c0;
    fq_add(r.c1, t, t);
}

// Out-of-line products for the point formulas: one call per product keeps
// the point kernels' code size (and build time) small.
FP_NOINLINE void fq_mul_nl(Fq& r, const Fq& a, const Fq& b) { fq_mul(r, a, b); }
FP_NOINLINE void fq2_mul_nl(Fq2& r, const Fq2& a, const Fq2& b) { fq2_mul(r, a, b); }
FP_NOINLINE void fq2_sqr_nl(Fq2& r, const Fq2& a) { fq2_sqr(r, a); }

// ---------------------------------------------------------------------------
// Overloads that let one template serve G1 (Fq) and G2 (Fq2).
// ---------------------------------------------------------------------------

FP_HD void fadd(Fq& r, const Fq& a, const Fq& b) { fq_add(r, a, b); }
FP_HD void fadd(Fq2& r, const Fq2& a, const Fq2& b) { fq2_add(r, a, b); }
FP_HD void fsub(Fq& r, const Fq& a, const Fq& b) { fq_sub(r, a, b); }
FP_HD void fsub(Fq2& r, const Fq2& a, const Fq2& b) { fq2_sub(r, a, b); }
FP_HD void fmul(Fq& r, const Fq& a, const Fq& b) { fq_mul_nl(r, a, b); }
FP_HD void fmul(Fq2& r, const Fq2& a, const Fq2& b) { fq2_mul_nl(r, a, b); }
FP_HD void fsqr(Fq& r, const Fq& a) { fq_mul_nl(r, a, a); }
FP_HD void fsqr(Fq2& r, const Fq2& a) { fq2_sqr_nl(r, a); }
FP_HD bool fis_zero(const Fq& a) { return fq_is_zero(a); }
FP_HD bool fis_zero(const Fq2& a) { return fq2_is_zero(a); }
FP_HD void fset_zero(Fq& r) { fq_set_zero(r); }
FP_HD void fset_zero(Fq2& r) { fq2_set_zero(r); }

// ---------------------------------------------------------------------------
// Jacobian points, a = 0
// ---------------------------------------------------------------------------

// dbl-2009-l (pallas_plane.py _pt_double).
template <typename F>
FP_HD void pt_double(Pt<F>& r, const Pt<F>& p) {
    F A, B, YZ, XB, C, t, D, E, Fv, X3, Y3, C8, u;
    fsqr(A, p.x);
    fsqr(B, p.y);
    fmul(YZ, p.y, p.z);
    fadd(XB, p.x, B);
    fsqr(C, B);
    fsqr(t, XB);
    fsub(D, t, A);
    fsub(D, D, C);
    fadd(D, D, D);
    fadd(E, A, A);
    fadd(E, E, A);
    fsqr(Fv, E);
    fadd(u, D, D);
    fsub(X3, Fv, u);
    fadd(C8, C, C);
    fadd(C8, C8, C8);
    fadd(C8, C8, C8);
    fsub(u, D, X3);
    fmul(Y3, E, u);
    fsub(Y3, Y3, C8);
    fadd(r.z, YZ, YZ);
    r.x = X3;
    r.y = Y3;
}

// Unified add (pallas_plane.py _pt_add_unified): general sum, then the
// selects in the reference's order — P+P double, H=0 & R!=0 -> infinity,
// q = inf -> p, p = inf -> q (the last select wins).
template <typename F>
FP_HD void pt_add(Pt<F>& r, const Pt<F>& p, const Pt<F>& q) {
    F Z1Z1, Z2Z2, Z1Z2, U1, U2, Y1Z2, Y2Z1, S1, S2, H, R, HH, RR, HHH, V, u;
    Pt<F> res;
    fsqr(Z1Z1, p.z);
    fsqr(Z2Z2, q.z);
    fmul(Z1Z2, p.z, q.z);
    fmul(U1, p.x, Z2Z2);
    fmul(U2, q.x, Z1Z1);
    fmul(Y1Z2, p.y, q.z);
    fmul(Y2Z1, q.y, p.z);
    fmul(S1, Y1Z2, Z2Z2);
    fmul(S2, Y2Z1, Z1Z1);
    fsub(H, U2, U1);
    fsub(R, S2, S1);
    fsqr(HH, H);
    fsqr(RR, R);
    fmul(HHH, H, HH);
    fmul(V, U1, HH);
    fmul(res.z, Z1Z2, H);
    fsub(res.x, RR, HHH);
    fadd(u, V, V);
    fsub(res.x, res.x, u);
    fsub(u, V, res.x);
    fmul(res.y, R, u);
    fmul(u, S1, HHH);
    fsub(res.y, res.y, u);

    const bool p_inf = fis_zero(p.z);
    const bool q_inf = fis_zero(q.z);
    const bool h_zero = fis_zero(H);
    const bool r_zero = fis_zero(R);
    const bool both = !(p_inf || q_inf);
    if (both && h_zero && r_zero) pt_double(res, p);
    if (both && h_zero && !r_zero) {
        fset_zero(res.x);
        fset_zero(res.y);
        fset_zero(res.z);
    }
    if (q_inf) res = p;
    if (p_inf) res = q;
    r = res;
}
