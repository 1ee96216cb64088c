// ECDSA-P256 verification: the field, Jacobian point operations (a = -3)
// and the curve check.  p256_split.cuh builds the lane pieces of both
// kernels of p256_verify.cu on them.
//
// Every function here is __host__ __device__: the header compiles as
// plain C++ too (p256_host_check.cpp), so the arithmetic of the kernels
// can be run and tested on a host without a GPU.  On the device, the
// field's add, sub, product, square and reduction are PTX carry chains;
// on the host, portable C++ over 64-bit integers.  Both keep every field
// element canonical (value < p), so they give the same words, and
// fe_eq, fe_is_zero and the final check compare words.
//
// Field elements are 8 little-endian 32-bit words.  Point formulas,
// exception cases and the final check follow fabric_tpu/csp/tpu/
// pallas_ec.py (_dbl, _add_full, _add_mixed, _kernel_body); the
// coordinates of a point at infinity never reach a finite result, so the
// branches below give the verdicts of its selects.
#pragma once

#include <stdint.h>

#if defined(__CUDACC__)
#define P256_FN __host__ __device__ __forceinline__
#define P256_UNROLL _Pragma("unroll")
#else
#define P256_FN static inline
#define P256_UNROLL
#endif

namespace p256 {

constexpr int kKeyTab = 256;  // entries of the shared key table
constexpr int kWindows = 64;  // 4-bit windows of a 256-bit scalar

struct Fe {
  uint32_t w[8];
};

struct Jac {
  Fe x, y, z;
  bool inf;
};

P256_FN Fe fe_prime() {
  // p = 2^256 - 2^224 + 2^192 + 2^96 - 1
  Fe r;
  r.w[0] = 0xFFFFFFFFu; r.w[1] = 0xFFFFFFFFu; r.w[2] = 0xFFFFFFFFu;
  r.w[3] = 0u; r.w[4] = 0u; r.w[5] = 0u; r.w[6] = 1u; r.w[7] = 0xFFFFFFFFu;
  return r;
}

P256_FN Fe fe_order() {
  // n, the order of G (n < p, so it is a canonical field element)
  Fe r;
  r.w[0] = 0xFC632551u; r.w[1] = 0xF3B9CAC2u; r.w[2] = 0xA7179E84u;
  r.w[3] = 0xBCE6FAADu; r.w[4] = 0xFFFFFFFFu; r.w[5] = 0xFFFFFFFFu;
  r.w[6] = 0u; r.w[7] = 0xFFFFFFFFu;
  return r;
}

P256_FN Fe fe_curve_b() {
  // b of y^2 = x^3 - 3x + b
  Fe r;
  r.w[0] = 0x27D2604Bu; r.w[1] = 0x3BCE3C3Eu; r.w[2] = 0xCC53B0F6u;
  r.w[3] = 0x651D06B0u; r.w[4] = 0x769886BCu; r.w[5] = 0xB3EBBD55u;
  r.w[6] = 0xAA3A93E7u; r.w[7] = 0x5AC635D8u;
  return r;
}

P256_FN Fe fe_small(uint32_t v) {
  Fe r;
  P256_UNROLL for (int i = 0; i < 8; ++i) r.w[i] = 0u;
  r.w[0] = v;
  return r;
}

// a (+ hi * 2^256) < 2p  ->  a mod p.
P256_FN void fe_cond_sub_p(Fe& a, uint32_t hi) {
  const Fe p = fe_prime();
  uint32_t t[8];
  int64_t borrow = 0;
  P256_UNROLL for (int i = 0; i < 8; ++i) {
    const int64_t v = (int64_t)a.w[i] - (int64_t)p.w[i] + borrow;
    t[i] = (uint32_t)v;
    borrow = v >> 32;  // 0 or -1
  }
  if (hi != 0u || borrow == 0) {
    P256_UNROLL for (int i = 0; i < 8; ++i) a.w[i] = t[i];
  }
}

#if defined(__CUDA_ARCH__)

// The device field: carry chains in PTX.  Each asm statement holds whole
// chains, so no carry flag lives across statements.

// t[0..N-1] += v[0..N-1] as one carry chain; the carry out of word N-2
// goes into word N-1 and none leaves it (callers make sure it cannot).
template <int N>
__device__ __forceinline__ void fe_chain(uint32_t* t, const uint32_t* v) {
  if constexpr (N == 1) {
    asm("add.u32 %0, %0, %1;"
        : "+r"(t[0])
        : "r"(v[0]));
  } else if constexpr (N == 2) {
    asm("add.cc.u32 %0, %0, %2;\n\t"
        "addc.u32 %1, %1, %3;"
        : "+r"(t[0]), "+r"(t[1])
        : "r"(v[0]), "r"(v[1]));
  } else if constexpr (N == 3) {
    asm("add.cc.u32 %0, %0, %3;\n\t"
        "addc.cc.u32 %1, %1, %4;\n\t"
        "addc.u32 %2, %2, %5;"
        : "+r"(t[0]), "+r"(t[1]), "+r"(t[2])
        : "r"(v[0]), "r"(v[1]), "r"(v[2]));
  } else if constexpr (N == 4) {
    asm("add.cc.u32 %0, %0, %4;\n\t"
        "addc.cc.u32 %1, %1, %5;\n\t"
        "addc.cc.u32 %2, %2, %6;\n\t"
        "addc.u32 %3, %3, %7;"
        : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3])
        : "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(v[3]));
  } else if constexpr (N == 5) {
    asm("add.cc.u32 %0, %0, %5;\n\t"
        "addc.cc.u32 %1, %1, %6;\n\t"
        "addc.cc.u32 %2, %2, %7;\n\t"
        "addc.cc.u32 %3, %3, %8;\n\t"
        "addc.u32 %4, %4, %9;"
        : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4])
        : "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(v[3]), "r"(v[4]));
  } else if constexpr (N == 6) {
    asm("add.cc.u32 %0, %0, %6;\n\t"
        "addc.cc.u32 %1, %1, %7;\n\t"
        "addc.cc.u32 %2, %2, %8;\n\t"
        "addc.cc.u32 %3, %3, %9;\n\t"
        "addc.cc.u32 %4, %4, %10;\n\t"
        "addc.u32 %5, %5, %11;"
        : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]),
          "+r"(t[5])
        : "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(v[3]), "r"(v[4]),
          "r"(v[5]));
  } else if constexpr (N == 7) {
    asm("add.cc.u32 %0, %0, %7;\n\t"
        "addc.cc.u32 %1, %1, %8;\n\t"
        "addc.cc.u32 %2, %2, %9;\n\t"
        "addc.cc.u32 %3, %3, %10;\n\t"
        "addc.cc.u32 %4, %4, %11;\n\t"
        "addc.cc.u32 %5, %5, %12;\n\t"
        "addc.u32 %6, %6, %13;"
        : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]),
          "+r"(t[5]), "+r"(t[6])
        : "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(v[3]), "r"(v[4]),
          "r"(v[5]), "r"(v[6]));
  } else if constexpr (N == 8) {
    asm("add.cc.u32 %0, %0, %8;\n\t"
        "addc.cc.u32 %1, %1, %9;\n\t"
        "addc.cc.u32 %2, %2, %10;\n\t"
        "addc.cc.u32 %3, %3, %11;\n\t"
        "addc.cc.u32 %4, %4, %12;\n\t"
        "addc.cc.u32 %5, %5, %13;\n\t"
        "addc.cc.u32 %6, %6, %14;\n\t"
        "addc.u32 %7, %7, %15;"
        : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]),
          "+r"(t[5]), "+r"(t[6]), "+r"(t[7])
        : "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(v[3]), "r"(v[4]),
          "r"(v[5]), "r"(v[6]), "r"(v[7]));
  } else if constexpr (N == 9) {
    asm("add.cc.u32 %0, %0, %9;\n\t"
        "addc.cc.u32 %1, %1, %10;\n\t"
        "addc.cc.u32 %2, %2, %11;\n\t"
        "addc.cc.u32 %3, %3, %12;\n\t"
        "addc.cc.u32 %4, %4, %13;\n\t"
        "addc.cc.u32 %5, %5, %14;\n\t"
        "addc.cc.u32 %6, %6, %15;\n\t"
        "addc.cc.u32 %7, %7, %16;\n\t"
        "addc.u32 %8, %8, %17;"
        : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]),
          "+r"(t[5]), "+r"(t[6]), "+r"(t[7]), "+r"(t[8])
        : "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(v[3]), "r"(v[4]),
          "r"(v[5]), "r"(v[6]), "r"(v[7]), "r"(v[8]));
  }
}

// (w + hi 2^256) mod p for a value below 2p (hi 0 or 1): w - p when that
// does not borrow out of hi, else w.
__device__ __forceinline__ void fe_sub_p_select(Fe& r, const Fe& w,
                                                uint32_t hi) {
  Fe d;
  uint32_t keep;  // all ones when the value is below p
  asm("sub.cc.u32 %0, %9, 0xFFFFFFFF;\n\t"
      "subc.cc.u32 %1, %10, 0xFFFFFFFF;\n\t"
      "subc.cc.u32 %2, %11, 0xFFFFFFFF;\n\t"
      "subc.cc.u32 %3, %12, 0;\n\t"
      "subc.cc.u32 %4, %13, 0;\n\t"
      "subc.cc.u32 %5, %14, 0;\n\t"
      "subc.cc.u32 %6, %15, 1;\n\t"
      "subc.cc.u32 %7, %16, 0xFFFFFFFF;\n\t"
      "subc.u32 %8, %17, 0;"
      : "=r"(d.w[0]), "=r"(d.w[1]), "=r"(d.w[2]), "=r"(d.w[3]),
        "=r"(d.w[4]), "=r"(d.w[5]), "=r"(d.w[6]), "=r"(d.w[7]), "=r"(keep)
      : "r"(w.w[0]), "r"(w.w[1]), "r"(w.w[2]), "r"(w.w[3]), "r"(w.w[4]),
        "r"(w.w[5]), "r"(w.w[6]), "r"(w.w[7]), "r"(hi));
  P256_UNROLL for (int i = 0; i < 8; ++i) {
    r.w[i] = (w.w[i] & keep) | (d.w[i] & ~keep);
  }
}

P256_FN void fe_add(Fe& r, const Fe& a, const Fe& b) {
  Fe s;
  uint32_t hi = 0u;
  asm("add.cc.u32 %0, %9, %17;\n\t"
      "addc.cc.u32 %1, %10, %18;\n\t"
      "addc.cc.u32 %2, %11, %19;\n\t"
      "addc.cc.u32 %3, %12, %20;\n\t"
      "addc.cc.u32 %4, %13, %21;\n\t"
      "addc.cc.u32 %5, %14, %22;\n\t"
      "addc.cc.u32 %6, %15, %23;\n\t"
      "addc.cc.u32 %7, %16, %24;\n\t"
      "addc.u32 %8, %8, 0;"
      : "=r"(s.w[0]), "=r"(s.w[1]), "=r"(s.w[2]), "=r"(s.w[3]),
        "=r"(s.w[4]), "=r"(s.w[5]), "=r"(s.w[6]), "=r"(s.w[7]), "+r"(hi)
      : "r"(a.w[0]), "r"(a.w[1]), "r"(a.w[2]), "r"(a.w[3]), "r"(a.w[4]),
        "r"(a.w[5]), "r"(a.w[6]), "r"(a.w[7]), "r"(b.w[0]), "r"(b.w[1]),
        "r"(b.w[2]), "r"(b.w[3]), "r"(b.w[4]), "r"(b.w[5]), "r"(b.w[6]),
        "r"(b.w[7]));
  fe_sub_p_select(r, s, hi);
}

P256_FN void fe_sub(Fe& r, const Fe& a, const Fe& b) {
  Fe d;
  uint32_t neg = 0u;  // all ones when a < b
  asm("sub.cc.u32 %0, %9, %17;\n\t"
      "subc.cc.u32 %1, %10, %18;\n\t"
      "subc.cc.u32 %2, %11, %19;\n\t"
      "subc.cc.u32 %3, %12, %20;\n\t"
      "subc.cc.u32 %4, %13, %21;\n\t"
      "subc.cc.u32 %5, %14, %22;\n\t"
      "subc.cc.u32 %6, %15, %23;\n\t"
      "subc.cc.u32 %7, %16, %24;\n\t"
      "subc.u32 %8, %8, 0;"
      : "=r"(d.w[0]), "=r"(d.w[1]), "=r"(d.w[2]), "=r"(d.w[3]),
        "=r"(d.w[4]), "=r"(d.w[5]), "=r"(d.w[6]), "=r"(d.w[7]), "+r"(neg)
      : "r"(a.w[0]), "r"(a.w[1]), "r"(a.w[2]), "r"(a.w[3]), "r"(a.w[4]),
        "r"(a.w[5]), "r"(a.w[6]), "r"(a.w[7]), "r"(b.w[0]), "r"(b.w[1]),
        "r"(b.w[2]), "r"(b.w[3]), "r"(b.w[4]), "r"(b.w[5]), "r"(b.w[6]),
        "r"(b.w[7]));
  // add p & neg; the carry out cancels the borrow
  asm("add.cc.u32 %0, %0, %8;\n\t"
      "addc.cc.u32 %1, %1, %8;\n\t"
      "addc.cc.u32 %2, %2, %8;\n\t"
      "addc.cc.u32 %3, %3, 0;\n\t"
      "addc.cc.u32 %4, %4, 0;\n\t"
      "addc.cc.u32 %5, %5, 0;\n\t"
      "addc.cc.u32 %6, %6, %9;\n\t"
      "addc.u32 %7, %7, %8;"
      : "+r"(d.w[0]), "+r"(d.w[1]), "+r"(d.w[2]), "+r"(d.w[3]),
        "+r"(d.w[4]), "+r"(d.w[5]), "+r"(d.w[6]), "+r"(d.w[7])
      : "r"(neg), "r"(neg & 1u));
  r = d;
}

// The 512-bit product by rows: row i's 8 word products a_j b_i (wide
// multiplies), their low halves added at word i and their high halves at
// word i + 1, each as one carry chain.  The partial sum after row i is
// below 2^(32 (i + 9)), so no chain carries out of word i + 8.
P256_FN void fe_mul_wide(uint32_t t[16], const Fe& a, const Fe& b) {
  P256_UNROLL for (int i = 9; i < 16; ++i) t[i] = 0u;
  P256_UNROLL for (int i = 0; i < 8; ++i) {
    uint32_t lo[9], hi[8];
    P256_UNROLL for (int j = 0; j < 8; ++j) {
      const uint64_t p = (uint64_t)a.w[j] * b.w[i];
      lo[j] = (uint32_t)p;
      hi[j] = (uint32_t)(p >> 32);
    }
    lo[8] = 0u;
    if (i == 0) {
      P256_UNROLL for (int j = 0; j < 9; ++j) t[j] = lo[j];
    } else {
      fe_chain<9>(t + i, lo);  // the carry lands in word i + 8
    }
    fe_chain<8>(t + i + 1, hi);
  }
}

// Row I of the squaring's cross products a_I a_j, j > I (7 - I of them):
// low halves at word 2 I + 1 (carry into word I + 8), high halves at
// word 2 I + 2.
template <int I>
__device__ __forceinline__ void fe_sqr_row(uint32_t c[16], const Fe& a) {
  constexpr int kN = 7 - I;
  uint32_t lo[kN + 1], hi[kN];
  P256_UNROLL for (int k = 0; k < kN; ++k) {
    const uint64_t p = (uint64_t)a.w[I] * a.w[I + 1 + k];
    lo[k] = (uint32_t)p;
    hi[k] = (uint32_t)(p >> 32);
  }
  lo[kN] = 0u;
  if constexpr (I == 0) {
    P256_UNROLL for (int k = 0; k <= kN; ++k) c[1 + k] = lo[k];
  } else {
    fe_chain<kN + 1>(c + 2 * I + 1, lo);
  }
  fe_chain<kN>(c + 2 * I + 2, hi);
}

// a^2 as twice the 28 cross products plus the 8 squares: 36 word
// products in place of 64.
P256_FN void fe_sqr_wide(uint32_t t[16], const Fe& a) {
  uint32_t c[16];
  P256_UNROLL for (int i = 0; i < 16; ++i) c[i] = 0u;
  fe_sqr_row<0>(c, a);
  fe_sqr_row<1>(c, a);
  fe_sqr_row<2>(c, a);
  fe_sqr_row<3>(c, a);
  fe_sqr_row<4>(c, a);
  fe_sqr_row<5>(c, a);
  fe_sqr_row<6>(c, a);
  // the cross sum is below 2^479 (words 1..14): shifted left, then the
  // squares added in two chains.  Word 8 of the squares is the low word
  // of a_4^2, which is 0 or 1 mod 4, so the first chain's carry fits it.
  uint32_t d[16];
  d[0] = 0u;
  P256_UNROLL for (int i = 1; i < 16; ++i) {
    d[i] = (c[i] << 1) | (c[i - 1] >> 31);
  }
  P256_UNROLL for (int i = 0; i < 8; ++i) {
    const uint64_t p = (uint64_t)a.w[i] * a.w[i];
    t[2 * i] = (uint32_t)p;
    t[2 * i + 1] = (uint32_t)(p >> 32);
  }
  uint32_t lo[9];
  P256_UNROLL for (int i = 0; i < 8; ++i) lo[i] = d[i];
  lo[8] = 0u;
  fe_chain<9>(t, lo);
  fe_chain<8>(t + 8, d + 8);
}

// 512-bit product words c -> c mod p, canonical.  The Solinas sum of
// FIPS 186-4 D.2.3, s1 + 2 s2 + 2 s3 + s4 + s5 - s6 - s7 - s8 - s9 (the
// terms of pallas_ec._S_TERMS), plus 5p so that it stays positive, in a
// 9-word accumulator (w, top): the sum lies in (-4 2^256, 7 2^256) and 5p
// in (4 2^256, 5 2^256), so top ends in [0, 11].  Folding top through
// 2^256 = 2^224 - 2^192 - 2^96 + 1 (mod p) leaves a value below
// 2^256 + 12 2^224 < 2p, which one conditional subtraction of p makes
// canonical.
P256_FN void fe_reduce_wide(Fe& r, const uint32_t c[16]) {
  Fe w;
  uint32_t top = 4u;  // 5p = 4 2^256 + (5p mod 2^256)
  asm("add.cc.u32 %0, %9, 0xFFFFFFFB;\n\t"
      "addc.cc.u32 %1, %10, 0xFFFFFFFF;\n\t"
      "addc.cc.u32 %2, %11, 0xFFFFFFFF;\n\t"
      "addc.cc.u32 %3, %12, 4;\n\t"
      "addc.cc.u32 %4, %13, 0;\n\t"
      "addc.cc.u32 %5, %14, 0;\n\t"
      "addc.cc.u32 %6, %15, 5;\n\t"
      "addc.cc.u32 %7, %16, 0xFFFFFFFB;\n\t"
      "addc.u32 %8, %8, 0;"
      : "=r"(w.w[0]), "=r"(w.w[1]), "=r"(w.w[2]), "=r"(w.w[3]),
        "=r"(w.w[4]), "=r"(w.w[5]), "=r"(w.w[6]), "=r"(w.w[7]), "+r"(top)
      : "r"(c[0]), "r"(c[1]), "r"(c[2]), "r"(c[3]), "r"(c[4]), "r"(c[5]),
        "r"(c[6]), "r"(c[7]));
  // u = s2 + s3, nonzero at words 3..7, and its carry u8
  uint32_t u3, u4, u5, u6, u7, u8 = 0u;
  asm("add.cc.u32 %0, %6, %7;\n\t"
      "addc.cc.u32 %1, %7, %8;\n\t"
      "addc.cc.u32 %2, %8, %9;\n\t"
      "addc.cc.u32 %3, %9, %10;\n\t"
      "addc.cc.u32 %4, %10, 0;\n\t"
      "addc.u32 %5, %5, 0;"
      : "=r"(u3), "=r"(u4), "=r"(u5), "=r"(u6), "=r"(u7), "+r"(u8)
      : "r"(c[11]), "r"(c[12]), "r"(c[13]), "r"(c[14]), "r"(c[15]));
  // + 2 u
  asm("add.cc.u32 %0, %0, %6;\n\t"
      "addc.cc.u32 %1, %1, %7;\n\t"
      "addc.cc.u32 %2, %2, %8;\n\t"
      "addc.cc.u32 %3, %3, %9;\n\t"
      "addc.cc.u32 %4, %4, %10;\n\t"
      "addc.u32 %5, %5, %11;\n\t"
      "add.cc.u32 %0, %0, %6;\n\t"
      "addc.cc.u32 %1, %1, %7;\n\t"
      "addc.cc.u32 %2, %2, %8;\n\t"
      "addc.cc.u32 %3, %3, %9;\n\t"
      "addc.cc.u32 %4, %4, %10;\n\t"
      "addc.u32 %5, %5, %11;"
      : "+r"(w.w[3]), "+r"(w.w[4]), "+r"(w.w[5]), "+r"(w.w[6]),
        "+r"(w.w[7]), "+r"(top)
      : "r"(u3), "r"(u4), "r"(u5), "r"(u6), "r"(u7), "r"(u8));
  // + s4 = (c15, c14, 0, 0, 0, c10, c9, c8), then + s5 = (c8, c13, c15,
  // c14, c13, c11, c10, c9); operands 9..16 are c8..c15
  asm("add.cc.u32 %0, %0, %9;\n\t"
      "addc.cc.u32 %1, %1, %10;\n\t"
      "addc.cc.u32 %2, %2, %11;\n\t"
      "addc.cc.u32 %3, %3, 0;\n\t"
      "addc.cc.u32 %4, %4, 0;\n\t"
      "addc.cc.u32 %5, %5, 0;\n\t"
      "addc.cc.u32 %6, %6, %15;\n\t"
      "addc.cc.u32 %7, %7, %16;\n\t"
      "addc.u32 %8, %8, 0;\n\t"
      "add.cc.u32 %0, %0, %10;\n\t"
      "addc.cc.u32 %1, %1, %11;\n\t"
      "addc.cc.u32 %2, %2, %12;\n\t"
      "addc.cc.u32 %3, %3, %14;\n\t"
      "addc.cc.u32 %4, %4, %15;\n\t"
      "addc.cc.u32 %5, %5, %16;\n\t"
      "addc.cc.u32 %6, %6, %14;\n\t"
      "addc.cc.u32 %7, %7, %9;\n\t"
      "addc.u32 %8, %8, 0;"
      : "+r"(w.w[0]), "+r"(w.w[1]), "+r"(w.w[2]), "+r"(w.w[3]),
        "+r"(w.w[4]), "+r"(w.w[5]), "+r"(w.w[6]), "+r"(w.w[7]), "+r"(top)
      : "r"(c[8]), "r"(c[9]), "r"(c[10]), "r"(c[11]), "r"(c[12]),
        "r"(c[13]), "r"(c[14]), "r"(c[15]));
  // - s6 = (c10, c8, 0, 0, 0, c13, c12, c11), - s7 = (c11, c9, 0, 0, c15,
  // c14, c13, c12), - s8 = (c12, 0, c10, c9, c8, c15, c14, c13), - s9 =
  // (c13, 0, c11, c10, c9, 0, c15, c14)
  asm("sub.cc.u32 %0, %0, %12;\n\t"
      "subc.cc.u32 %1, %1, %13;\n\t"
      "subc.cc.u32 %2, %2, %14;\n\t"
      "subc.cc.u32 %3, %3, 0;\n\t"
      "subc.cc.u32 %4, %4, 0;\n\t"
      "subc.cc.u32 %5, %5, 0;\n\t"
      "subc.cc.u32 %6, %6, %9;\n\t"
      "subc.cc.u32 %7, %7, %11;\n\t"
      "subc.u32 %8, %8, 0;\n\t"
      "sub.cc.u32 %0, %0, %13;\n\t"
      "subc.cc.u32 %1, %1, %14;\n\t"
      "subc.cc.u32 %2, %2, %15;\n\t"
      "subc.cc.u32 %3, %3, %16;\n\t"
      "subc.cc.u32 %4, %4, 0;\n\t"
      "subc.cc.u32 %5, %5, 0;\n\t"
      "subc.cc.u32 %6, %6, %10;\n\t"
      "subc.cc.u32 %7, %7, %12;\n\t"
      "subc.u32 %8, %8, 0;\n\t"
      "sub.cc.u32 %0, %0, %14;\n\t"
      "subc.cc.u32 %1, %1, %15;\n\t"
      "subc.cc.u32 %2, %2, %16;\n\t"
      "subc.cc.u32 %3, %3, %9;\n\t"
      "subc.cc.u32 %4, %4, %10;\n\t"
      "subc.cc.u32 %5, %5, %11;\n\t"
      "subc.cc.u32 %6, %6, 0;\n\t"
      "subc.cc.u32 %7, %7, %13;\n\t"
      "subc.u32 %8, %8, 0;\n\t"
      "sub.cc.u32 %0, %0, %15;\n\t"
      "subc.cc.u32 %1, %1, %16;\n\t"
      "subc.cc.u32 %2, %2, 0;\n\t"
      "subc.cc.u32 %3, %3, %10;\n\t"
      "subc.cc.u32 %4, %4, %11;\n\t"
      "subc.cc.u32 %5, %5, %12;\n\t"
      "subc.cc.u32 %6, %6, 0;\n\t"
      "subc.cc.u32 %7, %7, %14;\n\t"
      "subc.u32 %8, %8, 0;"
      : "+r"(w.w[0]), "+r"(w.w[1]), "+r"(w.w[2]), "+r"(w.w[3]),
        "+r"(w.w[4]), "+r"(w.w[5]), "+r"(w.w[6]), "+r"(w.w[7]), "+r"(top)
      : "r"(c[8]), "r"(c[9]), "r"(c[10]), "r"(c[11]), "r"(c[12]),
        "r"(c[13]), "r"(c[14]), "r"(c[15]));
  // fold top: + top at words 0 and 7, - top at words 3 and 6
  uint32_t hi = 0u;
  asm("add.cc.u32 %0, %0, %9;\n\t"
      "addc.cc.u32 %1, %1, 0;\n\t"
      "addc.cc.u32 %2, %2, 0;\n\t"
      "addc.cc.u32 %3, %3, 0;\n\t"
      "addc.cc.u32 %4, %4, 0;\n\t"
      "addc.cc.u32 %5, %5, 0;\n\t"
      "addc.cc.u32 %6, %6, 0;\n\t"
      "addc.cc.u32 %7, %7, %9;\n\t"
      "addc.u32 %8, %8, 0;\n\t"
      "sub.cc.u32 %3, %3, %9;\n\t"
      "subc.cc.u32 %4, %4, 0;\n\t"
      "subc.cc.u32 %5, %5, 0;\n\t"
      "subc.cc.u32 %6, %6, %9;\n\t"
      "subc.cc.u32 %7, %7, 0;\n\t"
      "subc.u32 %8, %8, 0;"
      : "+r"(w.w[0]), "+r"(w.w[1]), "+r"(w.w[2]), "+r"(w.w[3]),
        "+r"(w.w[4]), "+r"(w.w[5]), "+r"(w.w[6]), "+r"(w.w[7]), "+r"(hi)
      : "r"(top));
  fe_sub_p_select(r, w, hi);
}

#else  // the host field: portable C++, the same canonical words

P256_FN void fe_add(Fe& r, const Fe& a, const Fe& b) {
  uint64_t c = 0;
  P256_UNROLL for (int i = 0; i < 8; ++i) {
    c += (uint64_t)a.w[i] + b.w[i];
    r.w[i] = (uint32_t)c;
    c >>= 32;
  }
  fe_cond_sub_p(r, (uint32_t)c);
}

P256_FN void fe_sub(Fe& r, const Fe& a, const Fe& b) {
  int64_t borrow = 0;
  P256_UNROLL for (int i = 0; i < 8; ++i) {
    const int64_t v = (int64_t)a.w[i] - (int64_t)b.w[i] + borrow;
    r.w[i] = (uint32_t)v;
    borrow = v >> 32;
  }
  if (borrow != 0) {  // a < b: add p back (the carry out cancels 2^256)
    const Fe p = fe_prime();
    uint64_t c = 0;
    P256_UNROLL for (int i = 0; i < 8; ++i) {
      c += (uint64_t)r.w[i] + p.w[i];
      r.w[i] = (uint32_t)c;
      c >>= 32;
    }
  }
}

// The 512-bit product a b, words least significant first: schoolbook
// rows through uint64_t.
P256_FN void fe_mul_wide(uint32_t t[16], const Fe& a, const Fe& b) {
  P256_UNROLL for (int i = 0; i < 16; ++i) t[i] = 0u;
  P256_UNROLL for (int i = 0; i < 8; ++i) {
    uint64_t carry = 0;
    P256_UNROLL for (int j = 0; j < 8; ++j) {
      // (2^32-1)^2 + 2 (2^32-1) = 2^64 - 1: no overflow
      const uint64_t v = (uint64_t)a.w[i] * b.w[j] + t[i + j] + carry;
      t[i + j] = (uint32_t)v;
      carry = v >> 32;
    }
    t[i + 8] = (uint32_t)carry;
  }
}

P256_FN void fe_sqr_wide(uint32_t t[16], const Fe& a) { fe_mul_wide(t, a, a); }

// Words of acc (signed, |acc[i]| < 2^40) plus fold * 2^256, folded through
// 2^256 = 2^224 - 2^192 - 2^96 + 1 (mod p), carried into r; returns the
// carry out of word 7.
P256_FN int64_t fe_carry(Fe& r, const int64_t acc[8], int64_t fold) {
  int64_t carry = 0;
  P256_UNROLL for (int i = 0; i < 8; ++i) {
    int64_t v = acc[i] + carry;
    if (i == 0 || i == 7) v += fold;
    if (i == 3 || i == 6) v -= fold;
    r.w[i] = (uint32_t)v;
    carry = v >> 32;  // arithmetic shift: floor division by 2^32
  }
  return carry;
}

// 512-bit product words t (least significant first) -> t mod p.
// Solinas reduction (FIPS 186-4 D.2.3): s1 + 2 s2 + 2 s3 + s4 + s5 - s6
// - s7 - s8 - s9, word by word (the terms of pallas_ec._S_TERMS).  The
// sum lies in (-4p, 7 * 2^256): its carry out f of word 7 is in [-4, 6];
// folding f leaves a carry in {-1, 0, 1}, folding that leaves none (the
// value is then in [0, 2^256)), and one conditional subtraction of p
// makes it canonical.
P256_FN void fe_reduce_wide(Fe& r, const uint32_t t[16]) {
  int64_t c[16];
  P256_UNROLL for (int i = 0; i < 16; ++i) c[i] = t[i];
  int64_t acc[8];
  acc[0] = c[0] + c[8] + c[9] - c[11] - c[12] - c[13] - c[14];
  acc[1] = c[1] + c[9] + c[10] - c[12] - c[13] - c[14] - c[15];
  acc[2] = c[2] + c[10] + c[11] - c[13] - c[14] - c[15];
  acc[3] = c[3] + 2 * c[11] + 2 * c[12] + c[13] - c[15] - c[8] - c[9];
  acc[4] = c[4] + 2 * c[12] + 2 * c[13] + c[14] - c[9] - c[10];
  acc[5] = c[5] + 2 * c[13] + 2 * c[14] + c[15] - c[10] - c[11];
  acc[6] = c[6] + 2 * c[14] + 2 * c[15] + c[14] + c[13] - c[8] - c[9];
  acc[7] = c[7] + 2 * c[15] + c[15] + c[8] - c[10] - c[11] - c[12] - c[13];
  int64_t f = fe_carry(r, acc, 0);
  P256_UNROLL for (int round = 0; round < 2; ++round) {
    P256_UNROLL for (int i = 0; i < 8; ++i) acc[i] = r.w[i];
    f = fe_carry(r, acc, f);
  }
  fe_cond_sub_p(r, 0u);
}

#endif  // __CUDA_ARCH__

#if defined(__CUDA_ARCH__)

// On the card a multiplication and a squaring are each one function in
// the SASS, called from every point operation.  Written out inline, four
// doublings are ~9,700 instructions (~155 KB), more than the instruction
// cache holds: a ladder's loop then ran at half the speed of a loop of
// one doubling, and the verify kernels took twice as long (PERF.md).
// The operands travel by value, in registers.
__device__ __noinline__ Fe fe_mul_call(Fe a, Fe b) {
  uint32_t t[16];
  fe_mul_wide(t, a, b);
  Fe r;
  fe_reduce_wide(r, t);
  return r;
}

__device__ __noinline__ Fe fe_sqr_call(Fe a) {
  uint32_t t[16];
  fe_sqr_wide(t, a);
  Fe r;
  fe_reduce_wide(r, t);
  return r;
}

P256_FN void fe_mul(Fe& r, const Fe& a, const Fe& b) { r = fe_mul_call(a, b); }

P256_FN void fe_sqr(Fe& r, const Fe& a) { r = fe_sqr_call(a); }

#else

P256_FN void fe_mul(Fe& r, const Fe& a, const Fe& b) {
  uint32_t t[16];
  fe_mul_wide(t, a, b);
  fe_reduce_wide(r, t);
}

P256_FN void fe_sqr(Fe& r, const Fe& a) {
  uint32_t t[16];
  fe_sqr_wide(t, a);
  fe_reduce_wide(r, t);
}

#endif  // __CUDA_ARCH__

P256_FN bool fe_is_zero(const Fe& a) {
  uint32_t acc = 0u;
  P256_UNROLL for (int i = 0; i < 8; ++i) acc |= a.w[i];
  return acc == 0u;
}

P256_FN bool fe_eq(const Fe& a, const Fe& b) {
  uint32_t acc = 0u;
  P256_UNROLL for (int i = 0; i < 8; ++i) acc |= a.w[i] ^ b.w[i];
  return acc == 0u;
}

// Word i of a lane's value at base[i * stride + lane], reduced mod p.
P256_FN Fe fe_load(const uint32_t* base, int stride, int lane) {
  Fe r;
  P256_UNROLL for (int i = 0; i < 8; ++i) r.w[i] = base[i * stride + lane];
  fe_cond_sub_p(r, 0u);
  return r;
}

// y^2 == x^3 - 3x + b for canonical x, y: (x, y) is an affine point of
// P-256 (the zero point is not).
P256_FN bool on_curve(const Fe& x, const Fe& y) {
  Fe lhs, rhs, t;
  fe_sqr(lhs, y);
  fe_sqr(rhs, x);
  fe_mul(rhs, rhs, x);
  fe_add(t, x, x);
  fe_add(t, t, x);
  fe_sub(rhs, rhs, t);
  fe_add(rhs, rhs, fe_curve_b());
  return fe_eq(lhs, rhs);
}

// -- point operations (a = -3) -----------------------------------------------

P256_FN Jac jac_dbl(const Jac& p) {
  Jac o;
  Fe delta, gamma, beta, alpha, t0, t1;
  fe_sqr(delta, p.z);
  fe_sqr(gamma, p.y);
  fe_mul(beta, p.x, gamma);
  fe_sub(t0, p.x, delta);
  fe_add(t1, p.x, delta);
  fe_mul(t0, t0, t1);
  fe_add(alpha, t0, t0);
  fe_add(alpha, alpha, t0);          // 3 (x - delta)(x + delta)
  fe_sqr(t0, alpha);
  fe_add(t1, beta, beta);
  fe_add(t1, t1, t1);                // 4 beta
  fe_add(o.x, t1, t1);               // 8 beta
  fe_sub(o.x, t0, o.x);              // x3 = alpha^2 - 8 beta
  fe_add(t0, p.y, p.z);
  fe_sqr(t0, t0);
  fe_sub(t0, t0, gamma);
  fe_sub(o.z, t0, delta);            // z3 = (y + z)^2 - gamma - delta
  fe_sub(t1, t1, o.x);
  fe_mul(t1, alpha, t1);             // alpha (4 beta - x3)
  fe_sqr(t0, gamma);
  fe_add(t0, t0, t0);
  fe_add(t0, t0, t0);
  fe_add(t0, t0, t0);                // 8 gamma^2
  fe_sub(o.y, t1, t0);
  o.inf = p.inf;
  return o;
}

// h == 0 after the generic setup: P + P doubles, P + (-P) is infinity.
P256_FN Jac jac_same_x(const Jac& p1, const Fe& rr) {
  if (fe_is_zero(rr)) return jac_dbl(p1);
  Jac o = p1;
  o.inf = true;
  return o;
}

// p1 + (ax, ay), the affine operand at infinity when ainf.
P256_FN Jac jac_add_mixed(const Jac& p1, const Fe& ax, const Fe& ay,
                          bool ainf) {
  Jac o;
  if (p1.inf) {
    o.x = ax;
    o.y = ay;
    o.z = fe_small(1u);
    o.inf = ainf;
    return o;
  }
  if (ainf) return p1;
  Fe z1z1, u2, s2, h, rr, hh, i4, j, v, t;
  fe_sqr(z1z1, p1.z);
  fe_mul(u2, ax, z1z1);
  fe_mul(s2, ay, p1.z);
  fe_mul(s2, s2, z1z1);
  fe_sub(h, u2, p1.x);
  fe_sub(rr, s2, p1.y);
  if (fe_is_zero(h)) return jac_same_x(p1, rr);
  fe_sqr(hh, h);
  fe_add(i4, hh, hh);
  fe_add(i4, i4, i4);                // i = 4 h^2
  fe_mul(j, h, i4);
  fe_add(rr, rr, rr);                // rr2
  fe_mul(v, p1.x, i4);
  fe_sqr(o.x, rr);
  fe_sub(o.x, o.x, j);
  fe_add(t, v, v);
  fe_sub(o.x, o.x, t);               // x3 = rr2^2 - j - 2v
  fe_mul(t, p1.y, j);
  fe_add(t, t, t);
  fe_sub(v, v, o.x);
  fe_mul(o.y, rr, v);
  fe_sub(o.y, o.y, t);               // y3 = rr2 (v - x3) - 2 y1 j
  fe_add(o.z, p1.z, h);
  fe_sqr(o.z, o.z);
  fe_sub(o.z, o.z, z1z1);
  fe_sub(o.z, o.z, hh);              // z3 = (z1 + h)^2 - z1z1 - hh
  o.inf = false;
  return o;
}

P256_FN Jac jac_add(const Jac& p1, const Jac& p2) {
  if (p1.inf) return p2;
  if (p2.inf) return p1;
  Jac o;
  Fe z1z1, z2z2, u1, u2, s1, s2, h, rr, i, j, v, t;
  fe_sqr(z1z1, p1.z);
  fe_sqr(z2z2, p2.z);
  fe_mul(u1, p1.x, z2z2);
  fe_mul(u2, p2.x, z1z1);
  fe_mul(s1, p1.y, p2.z);
  fe_mul(s1, s1, z2z2);
  fe_mul(s2, p2.y, p1.z);
  fe_mul(s2, s2, z1z1);
  fe_sub(h, u2, u1);
  fe_sub(rr, s2, s1);
  if (fe_is_zero(h)) return jac_same_x(p1, rr);
  fe_add(i, h, h);
  fe_sqr(i, i);                      // i = (2h)^2
  fe_mul(j, h, i);
  fe_add(rr, rr, rr);                // rr2
  fe_mul(v, u1, i);
  fe_sqr(o.x, rr);
  fe_sub(o.x, o.x, j);
  fe_add(t, v, v);
  fe_sub(o.x, o.x, t);               // x3 = rr2^2 - j - 2v
  fe_mul(t, s1, j);
  fe_add(t, t, t);
  fe_sub(v, v, o.x);
  fe_mul(o.y, rr, v);
  fe_sub(o.y, o.y, t);               // y3 = rr2 (v - x3) - 2 s1 j
  fe_add(o.z, p1.z, p2.z);
  fe_sqr(o.z, o.z);
  fe_sub(o.z, o.z, z1z1);
  fe_sub(o.z, o.z, z2z2);
  fe_mul(o.z, o.z, h);               // z3 = ((z1 + z2)^2 - z1z1 - z2z2) h
  o.inf = false;
  return o;
}

}  // namespace p256
