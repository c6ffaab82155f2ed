// BLS12-381 Fq / Fq2 arithmetic for the port's CUDA kernels
// (plane_kernels.cu). Every function is __host__ __device__, so the same code
// also builds with a host C++ compiler.
//
// An Fq element is 12 little-endian 32-bit limbs, canonical in [0, p), in
// Montgomery form with R = 2^384 (the reference's R, so residues are the same
// integers as charon_tpu's 32 x 12-bit limbs). Fq2 = Fq[u]/(u^2 + 1).
//
// Formulas match the reference's in-kernel forms in
// charon_tpu/ops/pallas_plane.py: Karatsuba Fq2 products (_e_mul_many). The
// point formulas are schedules of these Fq operations
// (ops/point_schedule.py). Every result is canonical, so the kernels agree
// bit for bit with the plain PyTorch versions in ops/field.py and
// ops/curve.py.
#pragma once

#include <stdint.h>

#if defined(__CUDACC__)
#define FP_HD __host__ __device__ __forceinline__
#else
#define FP_HD static inline
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

// ---------------------------------------------------------------------------
// Fq
// ---------------------------------------------------------------------------

FP_HD bool fq_is_zero(const Fq& a) {
    uint32_t acc = 0;
#pragma unroll
    for (int i = 0; i < FP_LIMBS; ++i) acc |= a.v[i];
    return acc == 0;
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

// ---------------------------------------------------------------------------
// Overloads that let one field-op template serve Fq and Fq2.
// ---------------------------------------------------------------------------

FP_HD void fadd(Fq& r, const Fq& a, const Fq& b) { fq_add(r, a, b); }
FP_HD void fadd(Fq2& r, const Fq2& a, const Fq2& b) { fq2_add(r, a, b); }
FP_HD void fsub(Fq& r, const Fq& a, const Fq& b) { fq_sub(r, a, b); }
FP_HD void fsub(Fq2& r, const Fq2& a, const Fq2& b) { fq2_sub(r, a, b); }
