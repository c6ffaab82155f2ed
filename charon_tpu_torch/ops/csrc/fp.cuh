// BLS12-381 Fq arithmetic for the port's CUDA kernels
// (plane_kernels.cu), the one field core every kernel shares. Every function
// but the lane-split product's is __host__ __device__: on the card fq_add,
// fq_sub, fq_addsub and fq_mul are PTX carry chains, and a host C++ compiler
// builds C forms of the same functions. The lane-split product
// (fq_mul_split, below) is plain C on both sides, __device__ on the card.
//
// An Fq element is 12 little-endian 32-bit limbs, canonical in [0, p), in
// Montgomery form with R = 2^384 (the reference's R, so residues are the same
// integers as charon_tpu's 32 x 12-bit limbs). The kernels build Fq2 =
// Fq[u]/(u^2 + 1) from these: Karatsuba products of three Fq products, as the
// reference's in-kernel forms in charon_tpu/ops/pallas_plane.py
// (_e_mul_many), and the point formulas are schedules of Fq operations
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
// 2^384 - p
#define FP_NEG_P_INIT                                                      \
    {0x00005555u, 0x46010000u, 0x4eac0000u, 0xe1540001u, 0x094f09dbu,      \
     0x98cf2d5fu, 0x0c7aed40u, 0x9b88b47bu, 0xbcb45328u, 0xb4e45849u,      \
     0xc6801965u, 0xe5feee15u}

struct Fq {
    uint32_t v[FP_LIMBS];
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

// (a + b) mod p or (a - b) mod p, in one branch-free path, so that threads
// that add and threads that subtract do not diverge, in two dependent carry
// chains: s = a + b, or a + ~b + 1 = a - b (its carry c: no borrow); t = s +
// (2^384 - p), or s + p; r = t where the add's t carries out (s >= p) or the
// sub borrows (c = 0), else s. The chains' flag is the carry in and out of
// each. Canonical inputs, canonical output.
FP_HD void fq_addsub(Fq& r, const Fq& a, const Fq& b, bool sub) {
    const uint32_t p[FP_LIMBS] = FP_P_INIT, np[FP_LIMBS] = FP_NEG_P_INIT;
    uint32_t s[FP_LIMBS], q[FP_LIMBS], c1, c2;
#pragma unroll
    for (int i = 0; i < FP_LIMBS; ++i) {
        s[i] = sub ? ~b.v[i] : b.v[i];
        q[i] = sub ? p[i] : np[i];
    }
    asm(FQ_CARRY_IN("%25")
        FQ_CHAIN(FQ_CHAIN_LIMB, "addc.cc.u32", "addc.cc.u32", "addc.cc.u32", 13, 14, 15, 16, 17,
                 18, 19, 20, 21, 22, 23, 24) "addc.u32 %12, 0, 0;\n\t}"
        : FQ_LIMB_INOUT(s, 0), "=r"(c1)
        : FQ_LIMB_OPERANDS(a.v), "r"((uint32_t)sub));
    uint32_t t[FP_LIMBS];
#pragma unroll
    for (int i = 0; i < FP_LIMBS; ++i) t[i] = s[i];
    asm(FQ_CHAIN(FQ_CHAIN_LIMB, "add.cc.u32", "addc.cc.u32", "addc.cc.u32", 13, 14, 15, 16, 17,
                 18, 19, 20, 21, 22, 23, 24) "addc.u32 %12, 0, 0;"
        : FQ_LIMB_INOUT(t, 0), "=r"(c2)
        : FQ_LIMB_OPERANDS(q));
    const bool take = sub ? c1 == 0 : c2 != 0;
#pragma unroll
    for (int i = 0; i < FP_LIMBS; ++i) r.v[i] = take ? t[i] : s[i];
}

FP_HD void fq_add(Fq& r, const Fq& a, const Fq& b) { fq_addsub(r, a, b, false); }
FP_HD void fq_sub(Fq& r, const Fq& a, const Fq& b) { fq_addsub(r, a, b, true); }

// r = T + U + c (limbs 0..11, c a carry of 0 or 1 at limb 0) reduced once:
// the value is below 2p, so T + U + c - p is kept unless it borrows.
FP_HD void fq_mont_finish(Fq& r, uint32_t* T, const uint32_t* U, uint32_t c) {
    const uint32_t p[FP_LIMBS] = FP_P_INIT;
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
    fq_mont_finish(r, T, U, c);
}

// Squaring a*a*R^-1 mod p, bit-equal to fq_mul(r, a, a), in two passes
// (SOS) with 78 distinct limb products instead of 144 for the square:
//   1. X = a^2 in 24 limbs: the 66 cross products a_i*a_j (i < j), low
//      halves into T at limb i+j and high halves into U at limb i+j+1, one
//      row a_i*(a_{i+1}..a_11) per pair of chains; then X = 2(T + U) plus
//      the diagonal a_i^2 at limbs 2i, 2i+1.
//   2. Montgomery reduction of the low half as fq_mul's reduction steps
//      (W the low-half accumulator, V the high-half one, c the carry at
//      limb 0), 144 limb products, then + the high half of X: the value is
//      (Xlo + m p)/R + Xhi < (p + 1) + p/8 < 2p, reduced once.
// A row's chain binds a fixed window of 12 accumulator limbs and 12 limbs
// of the zero-padded operand ap[i..i+11], so that one template serves each
// row length L: limb k of the window gets a_i * a_{i+1+k} for k < L, and
// the carry lands in limb L (= i + 12 of the accumulator, still zero).
#define FQ_SQR_MAD(op, d, x, y) op " %" #d ", %" #x ", %" #y ", %" #d ";\n\t"
#define FQ_SQR1(o) FQ_SQR_MAD("mad." o ".cc.u32", 0, 12, 13)
#define FQ_SQR2(o) FQ_SQR1(o) FQ_SQR_MAD("madc." o ".cc.u32", 1, 12, 14)
#define FQ_SQR3(o) FQ_SQR2(o) FQ_SQR_MAD("madc." o ".cc.u32", 2, 12, 15)
#define FQ_SQR4(o) FQ_SQR3(o) FQ_SQR_MAD("madc." o ".cc.u32", 3, 12, 16)
#define FQ_SQR5(o) FQ_SQR4(o) FQ_SQR_MAD("madc." o ".cc.u32", 4, 12, 17)
#define FQ_SQR6(o) FQ_SQR5(o) FQ_SQR_MAD("madc." o ".cc.u32", 5, 12, 18)
#define FQ_SQR7(o) FQ_SQR6(o) FQ_SQR_MAD("madc." o ".cc.u32", 6, 12, 19)
#define FQ_SQR8(o) FQ_SQR7(o) FQ_SQR_MAD("madc." o ".cc.u32", 7, 12, 20)
#define FQ_SQR9(o) FQ_SQR8(o) FQ_SQR_MAD("madc." o ".cc.u32", 8, 12, 21)
#define FQ_SQR10(o) FQ_SQR9(o) FQ_SQR_MAD("madc." o ".cc.u32", 9, 12, 22)
#define FQ_SQR11(o) FQ_SQR10(o) FQ_SQR_MAD("madc." o ".cc.u32", 10, 12, 23)
#define FQ_SQR_ROW(i, L)                                                                  \
    asm(FQ_SQR##L("lo") "addc.u32 %" #L ", %" #L ", 0;"                                   \
        : FQ_LIMB_INOUT(T, 2 * i + 1)                                                     \
        : FQ_LIMB_OPERANDS((ap + i)));                                                    \
    asm(FQ_SQR##L("hi") "addc.u32 %" #L ", %" #L ", 0;"                                   \
        : FQ_LIMB_INOUT(U, 2 * i + 2)                                                     \
        : FQ_LIMB_OPERANDS((ap + i)));

FP_HD void fq_sqr(Fq& r, const Fq& a) {
    const uint32_t p[FP_LIMBS] = FP_P_INIT;
    // T[k], U[k]: limb k of the cross-product sum's low / high halves; limbs
    // past 23 only pad the rows' windows and stay 0
    uint32_t T[2 * FP_LIMBS + 9], U[2 * FP_LIMBS + 10], ap[2 * FP_LIMBS - 2], c;
#pragma unroll
    for (int k = 0; k < 2 * FP_LIMBS + 10; ++k) {
        if (k < 2 * FP_LIMBS + 9) T[k] = 0;
        U[k] = 0;
    }
#pragma unroll
    for (int k = 0; k < 2 * FP_LIMBS - 2; ++k) ap[k] = k < FP_LIMBS ? a.v[k] : 0;
    FQ_SQR_ROW(0, 11) FQ_SQR_ROW(1, 10) FQ_SQR_ROW(2, 9) FQ_SQR_ROW(3, 8) FQ_SQR_ROW(4, 7)
    FQ_SQR_ROW(5, 6) FQ_SQR_ROW(6, 5) FQ_SQR_ROW(7, 4) FQ_SQR_ROW(8, 3) FQ_SQR_ROW(9, 2)
    FQ_SQR_ROW(10, 1)
    // T += U over 24 limbs (< 2^761), in two chains joined by c
    asm(FQ_CHAIN(FQ_CHAIN_LIMB, "add.cc.u32", "addc.cc.u32", "addc.cc.u32", 13, 14, 15, 16, 17,
                 18, 19, 20, 21, 22, 23, 24) "addc.u32 %12, 0, 0;"
        : FQ_LIMB_INOUT(T, 0), "=r"(c)
        : FQ_LIMB_OPERANDS(U));
    asm(FQ_CARRY_IN("%24")
        FQ_CHAIN(FQ_CHAIN_LIMB, "addc.cc.u32", "addc.cc.u32", "addc.u32", 12, 13, 14, 15, 16, 17,
                 18, 19, 20, 21, 22, 23) "}"
        : FQ_LIMB_INOUT(T, FP_LIMBS)
        : FQ_LIMB_OPERANDS((U + FP_LIMBS)), "r"(c));
    // doubled: independent shifts, no chain
#pragma unroll
    for (int k = 2 * FP_LIMBS - 1; k > 0; --k) T[k] = (T[k] << 1) | (T[k - 1] >> 31);
    T[0] <<= 1;
    // + a_i^2 at limbs 2i, 2i+1, in two chains joined by c
    asm(FQ_SQR_MAD("mad.lo.cc.u32", 0, 13, 13) FQ_SQR_MAD("madc.hi.cc.u32", 1, 13, 13)
        FQ_SQR_MAD("madc.lo.cc.u32", 2, 14, 14) FQ_SQR_MAD("madc.hi.cc.u32", 3, 14, 14)
        FQ_SQR_MAD("madc.lo.cc.u32", 4, 15, 15) FQ_SQR_MAD("madc.hi.cc.u32", 5, 15, 15)
        FQ_SQR_MAD("madc.lo.cc.u32", 6, 16, 16) FQ_SQR_MAD("madc.hi.cc.u32", 7, 16, 16)
        FQ_SQR_MAD("madc.lo.cc.u32", 8, 17, 17) FQ_SQR_MAD("madc.hi.cc.u32", 9, 17, 17)
        FQ_SQR_MAD("madc.lo.cc.u32", 10, 18, 18) FQ_SQR_MAD("madc.hi.cc.u32", 11, 18, 18)
        "addc.u32 %12, 0, 0;"
        : FQ_LIMB_INOUT(T, 0), "=r"(c)
        : "r"(a.v[0]), "r"(a.v[1]), "r"(a.v[2]), "r"(a.v[3]), "r"(a.v[4]), "r"(a.v[5]));
    asm(FQ_CARRY_IN("%18")
        FQ_SQR_MAD("madc.lo.cc.u32", 0, 12, 12) FQ_SQR_MAD("madc.hi.cc.u32", 1, 12, 12)
        FQ_SQR_MAD("madc.lo.cc.u32", 2, 13, 13) FQ_SQR_MAD("madc.hi.cc.u32", 3, 13, 13)
        FQ_SQR_MAD("madc.lo.cc.u32", 4, 14, 14) FQ_SQR_MAD("madc.hi.cc.u32", 5, 14, 14)
        FQ_SQR_MAD("madc.lo.cc.u32", 6, 15, 15) FQ_SQR_MAD("madc.hi.cc.u32", 7, 15, 15)
        FQ_SQR_MAD("madc.lo.cc.u32", 8, 16, 16) FQ_SQR_MAD("madc.hi.cc.u32", 9, 16, 16)
        FQ_SQR_MAD("madc.lo.cc.u32", 10, 17, 17) FQ_SQR_MAD("madc.hi.u32", 11, 17, 17) "}"
        : FQ_LIMB_INOUT(T, FP_LIMBS)
        : "r"(a.v[6]), "r"(a.v[7]), "r"(a.v[8]), "r"(a.v[9]), "r"(a.v[10]), "r"(a.v[11]),
          "r"(c));
    // reduction of the low half: step i adds m*p (with the carry c at limb 0)
    // and shifts the accumulators down a limb
    uint32_t W[FP_LIMBS + 1], V[FP_LIMBS + 1];
#pragma unroll
    for (int j = 0; j < FP_LIMBS; ++j) {
        W[j] = T[j];
        V[j] = 0;
    }
    W[FP_LIMBS] = V[FP_LIMBS] = 0;
    c = 0;
#pragma unroll
    for (int i = 0; i < FP_LIMBS; ++i) {
        const uint32_t m = (W[0] + V[0] + c) * FP_N0;
        asm(FQ_CARRY_IN("%26")
            FQ_CHAIN(FQ_MAD13, "madc.lo.cc.u32", "madc.lo.cc.u32", "madc.lo.cc.u32", 14, 15, 16,
                     17, 18, 19, 20, 21, 22, 23, 24, 25) "addc.u32 %12, %12, 0;\n\t}"
            : FQ_LIMB_INOUT(W, 0), "+r"(W[12])
            : "r"(m), FQ_LIMB_OPERANDS(p), "r"(c));
        asm(FQ_CHAIN(FQ_MAD12, "mad.hi.cc.u32", "madc.hi.cc.u32", "madc.hi.u32", 13, 14, 15, 16,
                     17, 18, 19, 20, 21, 22, 23, 24)
            : FQ_LIMB_INOUT(V, 1)
            : "r"(m), FQ_LIMB_OPERANDS(p));
        c = V[0] != 0;
#pragma unroll
        for (int j = 0; j < FP_LIMBS; ++j) {
            W[j] = W[j + 1];
            V[j] = V[j + 1];
        }
        W[FP_LIMBS] = V[FP_LIMBS] = 0;
    }
    // V += the high half of X (W + V + c <= p, so no carry out), then finish
    asm(FQ_CHAIN(FQ_CHAIN_LIMB, "add.cc.u32", "addc.cc.u32", "addc.u32", 12, 13, 14, 15, 16, 17,
                 18, 19, 20, 21, 22, 23)
        : FQ_LIMB_INOUT(V, 0)
        : FQ_LIMB_OPERANDS((T + FP_LIMBS)));
    fq_mont_finish(r, W, V, c);
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

// the card's two chains
FP_HD void fq_addsub(Fq& r, const Fq& a, const Fq& b, bool sub) {
    const uint32_t p[FP_LIMBS] = FP_P_INIT, np[FP_LIMBS] = FP_NEG_P_INIT;
    uint32_t s[FP_LIMBS], t[FP_LIMBS];
    uint64_t c = sub;
    for (int i = 0; i < FP_LIMBS; ++i) {
        c += (uint64_t)a.v[i] + (sub ? ~b.v[i] : b.v[i]);
        s[i] = (uint32_t)c;
        c >>= 32;
    }
    const bool borrow = c == 0;
    c = 0;
    for (int i = 0; i < FP_LIMBS; ++i) {
        c += (uint64_t)s[i] + (sub ? p[i] : np[i]);
        t[i] = (uint32_t)c;
        c >>= 32;
    }
    const bool take = sub ? borrow : c != 0;
    for (int i = 0; i < FP_LIMBS; ++i) r.v[i] = take ? t[i] : s[i];
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

FP_HD void fq_sqr(Fq& r, const Fq& a) { fq_mul(r, a, a); }

#endif  // __CUDA_ARCH__

// ---------------------------------------------------------------------------
// The Fq product split over a group of T lanes of one warp
// ---------------------------------------------------------------------------
//
// fq_mul_split<T> is fq_mul's CIOS on T lanes (T divides 12): lane l of the
// group holds limbs L*l .. L*l + L - 1 (L = 12 / T) of b, of p and of the
// running value w, and a carry word c of its own at limb L*l + L; every lane
// holds all of a. Step i of the 12:
//   1. w += a_i * b, a row of L multiply-adds (64-bit: x*y + w + carry
//      never overflows), whose carry out goes into c;
//   2. m = w_0 * (-p^-1) mod 2^32 on lane 0, shuffled to the group;
//   3. w += m * p likewise (lane 0's w_0 is now 0);
//   4. the shift: each lane's w_0 moves to the lane below (__shfl_sync; the
//      top lane gets 0), w moves down a limb, and c, now at w's top limb, is
//      added to it: the top limb keeps the low word and c the rest.
// No carry crosses lanes inside a step: c < 2^34 after the rows (a u64) and
// c <= 3 after the shift. The value stays CIOS's, < 2p < 2^382, so the top
// lane's c ends at 0. At the end the carries resolve once: lane l adds
// lane l-1's c, and the carry it passes up comes from a lookahead over the
// group's generate (carry out) and propagate (all ones) bits; one
// subtraction of p, its borrows from the same lookahead, is kept unless the
// group borrows out; both lookaheads take one round of __ballot_sync. The
// output is the same 12 canonical words as fq_mul's, lane l holding its L
// of them.
// ops/field.py mont_mul_split models it word for word (T a parameter).
//
// A lane's work per step is 2L multiply-adds and a few adds against fq_mul's
// 24 (ptxas issues each of fq_mul's 288 mad.cc as an IMAD and an IADD3.X:
// ~1,350 instructions a product on one thread); at L = 3 ~30 instructions a
// step, each limb product one IMAD.WIDE.U32 with a 64-bit addend, ~8 on its
// critical path: lane 0's w_0 -> m -> the shuffle -> m * p_0, m * p_1 -> the
// next w_0 (PERF.md §7, from the SASS). What did not pay on the H100 (PERF.md
// PR 7): every lane keeping lane 0's words to form m without a shuffle, and
// forming m by a recurrence off the shuffle: more instructions a step cost
// more than the shuffle's latency.
//
// Every lane of the warp calls each function at once, every group with its
// own arguments: the shuffles and ballots take the whole warp's mask, a
// constant. (With a mask that differs between the warp's groups, ptxas
// cannot prove it uniform and wraps each shuffle in a loop over the masks,
// WARPSYNC ... ENDCOLLECTIVE, which ran the groups of a warp one after
// another on the H100: PERF.md.) A host build has these only where the
// caller defines the warp functions (FP_WARP_FUNCTIONS: the g++ build of
// tests/test_torch_split_product.py, one thread a lane).
#if defined(__CUDACC__) || defined(FP_WARP_FUNCTIONS)

#define FP_WARP 0xffffffffu
// device code only on the card (the warp functions are __device__)
#if defined(__CUDACC__)
#define FP_WD __device__ __forceinline__
#else
#define FP_WD static inline
#endif

template <int T>
struct FqGroup {
    static_assert(T >= 1 && FP_LIMBS % T == 0 && 32 % T == 0, "T lanes divide the 12 limbs");
    static constexpr int L = FP_LIMBS / T;
    int lane;        // 0 .. T-1 within the group
    int base;        // the warp lane of the group's lane 0
    uint32_t p[L];   // this lane's limbs of p
};

template <int L>
struct FqSlice {
    uint32_t v[L];
};

// x if c else y, a select that stays one: a chain of ?: over the lane index
// (fq_slice) is otherwise turned into an array indexed in local memory
FP_WD uint32_t fp_pick(bool c, uint32_t x, uint32_t y) {
#if defined(__CUDA_ARCH__)
    uint32_t r;
    asm("{\n\t.reg .pred c;\n\tsetp.ne.u32 c, %3, 0;\n\tselp.b32 %0, %1, %2, c;\n\t}"
        : "=r"(r)
        : "r"(x), "r"(y), "r"((uint32_t)c));
    return r;
#else
    return c ? x : y;
#endif
}

// lane `lane` of a group of T whose first lane in the warp is `base`
template <int T>
FP_WD FqGroup<T> fq_group(int lane, int base) {
    constexpr int L = FP_LIMBS / T;
    const uint32_t p[FP_LIMBS] = FP_P_INIT;
    FqGroup<T> g;
    g.lane = lane;
    g.base = base;
#pragma unroll
    for (int j = 0; j < L; ++j) {
        uint32_t v = p[j];
#pragma unroll
        for (int q = 1; q < T; ++q) v = fp_pick(lane == q, p[L * q + j], v);
        g.p[j] = v;
    }
    return g;
}

// this lane's limbs of a whole element
template <int T>
FP_WD void fq_slice(FqSlice<FP_LIMBS / T>& s, const Fq& x, const FqGroup<T>& g) {
    constexpr int L = FP_LIMBS / T;
#pragma unroll
    for (int j = 0; j < L; ++j) {
        uint32_t v = x.v[j];
#pragma unroll
        for (int q = 1; q < T; ++q) v = fp_pick(g.lane == q, x.v[L * q + j], v);
        s.v[j] = v;
    }
}

// the whole element on every lane of the group (12 shuffles)
template <int T>
FP_WD void fq_gather(Fq& x, const FqSlice<FP_LIMBS / T>& s, const FqGroup<T>& g) {
    constexpr int L = FP_LIMBS / T;
#pragma unroll
    for (int q = 0; q < T; ++q)
#pragma unroll
        for (int j = 0; j < L; ++j)
            x.v[L * q + j] = T == 1 ? s.v[j] : __shfl_sync(FP_WARP, s.v[j], g.base + q);
}

// w[0..L-1] += x * y[0..L-1]; returns the carry out, the word at limb L
template <int L>
FP_WD uint32_t fq_row(uint32_t* w, uint32_t x, const uint32_t* y) {
    uint64_t s = 0;
#pragma unroll
    for (int j = 0; j < L; ++j) {
        s = (uint64_t)x * y[j] + w[j] + (s >> 32);
        w[j] = (uint32_t)s;
    }
    return (uint32_t)(s >> 32);
}

// bit l: lane l's pred, for each lane of the group
template <int T>
FP_WD unsigned fq_ballot(bool pred, const FqGroup<T>& g) {
    if (T == 1) return pred;
    return __ballot_sync(FP_WARP, pred) >> g.base & ((1u << T) - 1);
}

// Carries of a group from its lanes' generate and propagate bits G and P
// (exclusive): bit l of the result is the carry into lane l, bit T the carry
// out of the group (A = G | P and B = G carry, added, exactly where the
// lanes do).
FP_WD unsigned fq_lookahead(unsigned G, unsigned P) { return ((G | P) + G) ^ (G | P) ^ G; }

// R = false leaves out the subtraction of p: r < 2p, in proper words (an
// input below 2p is as good as a canonical one: with 4p < 2^384 the CIOS
// value stays below 3p inside and 2p at the end).
template <int T, bool R = true>
FP_WD void fq_mul_split(FqSlice<FP_LIMBS / T>& r, const Fq& a, const FqSlice<FP_LIMBS / T>& b,
                        const FqGroup<T>& g) {
    constexpr int L = FP_LIMBS / T;
    const bool top = g.lane == T - 1;
    // the warp lanes above and below (self at the group's ends, masked out)
    const int up = top ? g.base + g.lane : g.base + g.lane + 1;
    const int down = g.lane == 0 ? g.base : g.base + g.lane - 1;
    uint32_t w[L];
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < L; ++j) w[j] = 0;
#pragma unroll
    for (int i = 0; i < FP_LIMBS; ++i) {
        c += fq_row<L>(w, a.v[i], b.v);
        uint32_t m = w[0] * FP_N0;
        if (T > 1) m = __shfl_sync(FP_WARP, m, g.base);
        c += fq_row<L>(w, m, g.p);
        uint32_t x = 0;
        if (T > 1) x = __shfl_sync(FP_WARP, w[0], up);
#pragma unroll
        for (int j = 0; j + 1 < L; ++j) w[j] = w[j + 1];
        c += top ? 0u : x;
        w[L - 1] = (uint32_t)c;
        c >>= 32;
    }
    // The carries between lanes resolve once. Lane l adds lane l-1's carry
    // word: s, its carry out (generate) and whether it is all ones
    // (propagate). With k, the carry that then reaches the lane, its words
    // are s + k, and their subtraction of p's limbs borrows out (generate)
    // or is 0 (propagate): for k = 0 as d = s - p says; for k = 1 where s +
    // 1 < p (s all ones wraps to 0, below p), and 0 where d is all ones and
    // borrows. One round of six ballots gives every lane the group's
    // carries, then (with each lane's k) its borrows; the group keeps s + k
    // where it borrows out (the value is below p), else s + k - p.
    uint32_t cin = 0;
    if (T > 1) cin = __shfl_sync(FP_WARP, (uint32_t)c, down);
    uint64_t s = g.lane == 0 ? 0u : cin, t = 0;
    if (!R) {   // the carries alone: one round of two ballots
        bool ones = true;
#pragma unroll
        for (int j = 0; j < L; ++j) {
            s += w[j];
            w[j] = (uint32_t)s;
            s >>= 32;
            ones = ones && w[j] == 0xffffffffu;
        }
        s = fq_lookahead(fq_ballot<T>(s != 0, g), fq_ballot<T>(ones, g)) >> g.lane & 1u;
#pragma unroll
        for (int j = 0; j < L; ++j) {
            s += w[j];
            r.v[j] = (uint32_t)s;
            s >>= 32;
        }
        return;
    }
    uint32_t d[L];
    bool ones = true, zero = true, dones = true;
#pragma unroll
    for (int j = 0; j < L; ++j) {
        s += w[j];
        w[j] = (uint32_t)s;
        s >>= 32;
        ones = ones && w[j] == 0xffffffffu;
        t = (uint64_t)w[j] - g.p[j] - (t >> 63);
        d[j] = (uint32_t)t;
        zero = zero && d[j] == 0;
        dones = dones && d[j] == 0xffffffffu;
    }
    const bool borrow = t >> 63;
    const unsigned K = fq_lookahead(fq_ballot<T>(s != 0, g), fq_ballot<T>(ones, g));
    const unsigned GB = (fq_ballot<T>(ones || (borrow && !dones), g) & K) |
                        (fq_ballot<T>(borrow, g) & ~K);
    const unsigned PB = (fq_ballot<T>(!ones && borrow && dones, g) & K) |
                        (fq_ballot<T>(zero, g) & ~K);
    const unsigned B = fq_lookahead(GB, PB);
    const bool keep = B >> T & 1u;
    // r = s + k, or s + k - p - (the borrow into the lane)
    int64_t e = (int64_t)(K >> g.lane & 1u) - (keep ? 0 : (int64_t)(B >> g.lane & 1u));
#pragma unroll
    for (int j = 0; j < L; ++j) {
        e += (int64_t)w[j] - (keep ? 0 : (int64_t)g.p[j]);
        r.v[j] = (uint32_t)e;
        e >>= 32;
    }
}

// r = x mod p for x < 2p, each lane's limbs: one subtraction of p, its
// borrows from the group's lookahead, kept unless the group borrows out
template <int T>
FP_WD void fq_reduce_split(FqSlice<FP_LIMBS / T>& r, const FqSlice<FP_LIMBS / T>& x,
                           const FqGroup<T>& g) {
    constexpr int L = FP_LIMBS / T;
    uint32_t d[L];
    uint64_t t = 0;
    bool zero = true;
#pragma unroll
    for (int j = 0; j < L; ++j) {
        t = (uint64_t)x.v[j] - g.p[j] - (t >> 63);
        d[j] = (uint32_t)t;
        zero = zero && d[j] == 0;
    }
    const unsigned B = fq_lookahead(fq_ballot<T>(t >> 63, g), fq_ballot<T>(zero, g));
    const bool keep = B >> T & 1u;
    t = (uint64_t)(B >> g.lane & 1u) << 63;
#pragma unroll
    for (int j = 0; j < L; ++j) {
        t = (uint64_t)d[j] - (t >> 63);
        r.v[j] = keep ? x.v[j] : (uint32_t)t;
    }
}

#endif  // __CUDACC__ || FP_WARP_FUNCTIONS
