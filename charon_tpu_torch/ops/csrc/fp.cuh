// BLS12-381 Fq / Fq2 arithmetic for the port's CUDA kernels
// (plane_kernels.cu), the one field core every kernel shares. Every function
// is __host__ __device__: on the card fq_add, fq_sub, fq_addsub and fq_mul are
// PTX carry chains, and a host C++ compiler builds C forms of the same
// functions.
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

#if defined(__CUDA_ARCH__)

// On the card every carry chain is PTX (add.cc / sub.cc / mad.lo.cc /
// madc.hi.cc), each chain inside ONE asm statement: nvcc does not promise to
// keep the carry flag from one statement to the next. A host build of this
// file (g++, or nvcc's host pass) takes the C forms after #else.

// PTX for limbs 0..11 of a chain: L(op, i, j) for destination limb %i and
// the other operand's limb %j.
#define FQ_CHAIN(L, first, next, last, o0, o1, o2, o3, o4, o5, o6, o7, o8, o9, o10, o11) \
    L(first, 0, o0) L(next, 1, o1) L(next, 2, o2) L(next, 3, o3) L(next, 4, o4)         \
    L(next, 5, o5) L(next, 6, o6) L(next, 7, o7) L(next, 8, o8) L(next, 9, o9)          \
    L(next, 10, o10) L(last, 11, o11)
#define FQ_CHAIN_LIMB(op, i, j) op " %" #i ", %" #i ", %" #j ";\n\t"
#define FQ_CHAIN_RLIMB(op, i, j) op " %" #i ", %" #j ", %" #i ";\n\t"
// %i += lo or hi of (s * %j), s at %13 (low rows) or %12 (high rows)
#define FQ_MAD13(op, i, j) op " %" #i ", %13, %" #j ", %" #i ";\n\t"
#define FQ_MAD12(op, i, j) op " %" #i ", %12, %" #j ", %" #i ";\n\t"
#define FQ_LIMB_OPERANDS(x) \
    "r"(x[0]), "r"(x[1]), "r"(x[2]), "r"(x[3]), "r"(x[4]), "r"(x[5]), "r"(x[6]), "r"(x[7]), \
    "r"(x[8]), "r"(x[9]), "r"(x[10]), "r"(x[11])
#define FQ_LIMB_INOUT(x, k)                                                                  \
    "+r"(x[k]), "+r"(x[k + 1]), "+r"(x[k + 2]), "+r"(x[k + 3]), "+r"(x[k + 4]),              \
        "+r"(x[k + 5]), "+r"(x[k + 6]), "+r"(x[k + 7]), "+r"(x[k + 8]), "+r"(x[k + 9]),      \
        "+r"(x[k + 10]), "+r"(x[k + 11])
// sets the carry flag to c (0 or 1) for the chain that follows
#define FQ_CARRY_IN(c) "{\n\t.reg .u32 cin;\n\tadd.cc.u32 cin, " c ", 0xffffffff;\n\t"

// (a + b) mod p, or (a - b) mod p as a + (p - b), in one branch-free path, so
// that threads that add and threads that subtract do not diverge. Canonical
// inputs, canonical output.
FP_HD void fq_addsub(Fq& r, const Fq& a, const Fq& b, bool sub) {
    const uint32_t p[FP_LIMBS] = FP_P_INIT;
    uint32_t t[FP_LIMBS], d[FP_LIMBS], hi;
#pragma unroll
    for (int i = 0; i < FP_LIMBS; ++i) t[i] = b.v[i];
    // t = p - b (b < p: no borrow out)
    asm(FQ_CHAIN(FQ_CHAIN_RLIMB, "sub.cc.u32", "subc.cc.u32", "subc.u32", 12, 13, 14, 15, 16,
                 17, 18, 19, 20, 21, 22, 23)
        : FQ_LIMB_INOUT(t, 0)
        : FQ_LIMB_OPERANDS(p));
#pragma unroll
    for (int i = 0; i < FP_LIMBS; ++i) t[i] = sub ? t[i] : b.v[i];
    // t += a, its carry into hi
    asm(FQ_CHAIN(FQ_CHAIN_LIMB, "add.cc.u32", "addc.cc.u32", "addc.cc.u32", 13, 14, 15, 16, 17,
                 18, 19, 20, 21, 22, 23, 24) "addc.u32 %12, 0, 0;"
        : FQ_LIMB_INOUT(t, 0), "=r"(hi)
        : FQ_LIMB_OPERANDS(a.v));
    // t < 2p < 2^382: d = t - p, kept unless it borrows
#pragma unroll
    for (int i = 0; i < FP_LIMBS; ++i) d[i] = t[i];
    asm(FQ_CHAIN(FQ_CHAIN_LIMB, "sub.cc.u32", "subc.cc.u32", "subc.cc.u32", 13, 14, 15, 16, 17,
                 18, 19, 20, 21, 22, 23, 24) "subc.u32 %12, %12, 0;"
        : FQ_LIMB_INOUT(d, 0), "+r"(hi)
        : FQ_LIMB_OPERANDS(p));
    const bool ge = hi == 0;
#pragma unroll
    for (int i = 0; i < FP_LIMBS; ++i) r.v[i] = ge ? d[i] : t[i];
}

FP_HD void fq_add(Fq& r, const Fq& a, const Fq& b) { fq_addsub(r, a, b, false); }
FP_HD void fq_sub(Fq& r, const Fq& a, const Fq& b) { fq_addsub(r, a, b, true); }

// CIOS Montgomery product a*b*R^-1 mod p on carry chains, with the running
// value split in two 13-limb accumulators, T for the low halves of the limb
// products and U for the high halves (value T + U + c, c a carry of 0 or 1 at
// limb 0), so that each CIOS step runs two independent chains at a time
// instead of one chain twice as long. Step i:
//   T[0..11] += lo(a_i * b) + c       U[1..12] += hi(a_i * b)
//   m = (T[0] + U[0]) * (-p^-1) mod 2^32
//   T[0..11] += lo(m * p)             U[1..12] += hi(m * p)
// Now T[0] + U[0] is 0 or 2^32: c = (U[0] != 0), and both shift down a limb.
// No chain carries out of limb 12: T < 2^387, and U < 2^415 because the top
// limbs of b and p are below 2^29. The value stays the CIOS value, < 2p.
FP_HD void fq_mul(Fq& r, const Fq& a, const Fq& b) {
    const uint32_t p[FP_LIMBS] = FP_P_INIT;
    uint32_t T[FP_LIMBS + 1], U[FP_LIMBS + 1], c = 0;
#pragma unroll
    for (int j = 0; j <= FP_LIMBS; ++j) T[j] = U[j] = 0;
#pragma unroll
    for (int i = 0; i < FP_LIMBS; ++i) {
        const uint32_t ai = a.v[i];
        asm(FQ_CARRY_IN("%26")
            FQ_CHAIN(FQ_MAD13, "madc.lo.cc.u32", "madc.lo.cc.u32", "madc.lo.cc.u32", 14, 15, 16,
                     17, 18, 19, 20, 21, 22, 23, 24, 25) "addc.u32 %12, %12, 0;\n\t}"
            : FQ_LIMB_INOUT(T, 0), "+r"(T[12])
            : "r"(ai), FQ_LIMB_OPERANDS(b.v), "r"(c));
        asm(FQ_CHAIN(FQ_MAD12, "mad.hi.cc.u32", "madc.hi.cc.u32", "madc.hi.u32", 13, 14, 15, 16,
                     17, 18, 19, 20, 21, 22, 23, 24)
            : FQ_LIMB_INOUT(U, 1)
            : "r"(ai), FQ_LIMB_OPERANDS(b.v));
        const uint32_t m = (T[0] + U[0]) * FP_N0;
        asm(FQ_CHAIN(FQ_MAD13, "mad.lo.cc.u32", "madc.lo.cc.u32", "madc.lo.cc.u32", 14, 15, 16,
                     17, 18, 19, 20, 21, 22, 23, 24, 25) "addc.u32 %12, %12, 0;"
            : FQ_LIMB_INOUT(T, 0), "+r"(T[12])
            : "r"(m), FQ_LIMB_OPERANDS(p));
        asm(FQ_CHAIN(FQ_MAD12, "mad.hi.cc.u32", "madc.hi.cc.u32", "madc.hi.u32", 13, 14, 15, 16,
                     17, 18, 19, 20, 21, 22, 23, 24)
            : FQ_LIMB_INOUT(U, 1)
            : "r"(m), FQ_LIMB_OPERANDS(p));
        c = U[0] != 0;
#pragma unroll
        for (int j = 0; j < FP_LIMBS; ++j) {
            T[j] = T[j + 1];
            U[j] = U[j + 1];
        }
        T[FP_LIMBS] = U[FP_LIMBS] = 0;
    }
    // T = T + U + c < 2p, then d = T - p, kept unless it borrows
    asm(FQ_CARRY_IN("%24")
        FQ_CHAIN(FQ_CHAIN_LIMB, "addc.cc.u32", "addc.cc.u32", "addc.u32", 12, 13, 14, 15, 16, 17,
                 18, 19, 20, 21, 22, 23) "}"
        : FQ_LIMB_INOUT(T, 0)
        : FQ_LIMB_OPERANDS(U), "r"(c));
    uint32_t d[FP_LIMBS], borrow;
#pragma unroll
    for (int j = 0; j < FP_LIMBS; ++j) d[j] = T[j];
    asm(FQ_CHAIN(FQ_CHAIN_LIMB, "sub.cc.u32", "subc.cc.u32", "subc.cc.u32", 13, 14, 15, 16, 17,
                 18, 19, 20, 21, 22, 23, 24) "subc.u32 %12, 0, 0;"
        : FQ_LIMB_INOUT(d, 0), "=r"(borrow)
        : FQ_LIMB_OPERANDS(p));
#pragma unroll
    for (int j = 0; j < FP_LIMBS; ++j) r.v[j] = borrow ? T[j] : d[j];
}

#else  // host build: the same functions in C

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

FP_HD void fq_addsub(Fq& r, const Fq& a, const Fq& b, bool sub) {
    if (sub)
        fq_sub(r, a, b);
    else
        fq_add(r, a, b);
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

#endif  // __CUDA_ARCH__

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
