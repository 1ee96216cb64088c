// The idemix Schnorr commitments on BN254 G1 (a = 0, y^2 = x^3 + 3):
// field arithmetic, Jacobian point operations, and the two thread bodies
// of bn254_commit.cu -- one term's partial s_t B_t (term_lane) and one
// accumulator's sum of partials (reduce_lane).
//
// Every function here is __host__ __device__: the header compiles as
// plain C++ too (bn254_host_check.cpp), so the arithmetic of the kernel
// can be run and tested on a host without a GPU.  On the device, fe_add,
// fe_sub and fe_mul are PTX carry chains; on the host, portable C++ over
// 64-bit integers.  The two compute the same values: a Montgomery product
// without a final subtraction is (a b + m p) / R for the one m < R that
// makes it exact, whatever order the words are taken in.
//
// Field elements are 8 little-endian 32-bit words in Montgomery form at
// R = 2^256 (x R mod p), kept lazily in [0, 2p): p < 2^254, so 4p < R and
// a CIOS product of two such operands lands in [0, 2p) with no final
// subtraction; add and sub take one conditional correction by 2p.  Only
// what is stored (partials and output) is made canonical ([0, p)).  Point
// formulas and their degenerate cases follow
// fabric_tpu/csp/tpu/pallas_bn254.py (_dbl_a0, _add_full, _add_mixed); the
// plain PyTorch version is fabric_tpu_torch/csp/cuda/bn254_ec.py and
// bn254_kernel.py.
#pragma once

#include <stddef.h>
#include <stdint.h>

#if defined(__CUDACC__)
#define BN_FN __host__ __device__ __forceinline__
#define BN_UNROLL _Pragma("unroll")
#define BN_NO_UNROLL _Pragma("unroll 1")
#else
#define BN_FN static inline
#define BN_UNROLL
#define BN_NO_UNROLL
#endif

namespace bn254 {

constexpr int kTable = 16;      // 4-bit windows: multiples 0..15
constexpr int kWindows = 64;    // windows of a 256-bit scalar
constexpr int kLaneBases = 4;   // a', a_bar, b', nym
constexpr int kAccs = 3;        // T1, T2, T3
constexpr int kEntryWords = 16;  // x and y words of one comb entry
// comb entries of one shared base: d 16^k B at entry 16 k + d
constexpr int kCombEntries = kWindows * kTable;
// rows of one partial: x, y, z words, then the infinity flag
constexpr int kPartRows = 3 * 8 + 1;
// output rows: coordinate k (x, y, z) of accumulator a in words
// 8 (3 k + a) .. 8 (3 k + a) + 7, then the 3 infinity flags
constexpr int kOutRows = 9 * 8 + kAccs;
constexpr uint32_t kPInv = 0xE4866389u;  // -p^-1 mod 2^32

struct Fe {
  uint32_t w[8];
};

struct Jac {
  Fe x, y, z;
  bool inf;
};

BN_FN Fe fe_prime() {
  Fe r;
  r.w[0] = 0xD87CFD47u; r.w[1] = 0x3C208C16u; r.w[2] = 0x6871CA8Du;
  r.w[3] = 0x97816A91u; r.w[4] = 0x8181585Du; r.w[5] = 0xB85045B6u;
  r.w[6] = 0xE131A029u; r.w[7] = 0x30644E72u;
  return r;
}

BN_FN Fe fe_2p() {
  Fe r;
  r.w[0] = 0xB0F9FA8Eu; r.w[1] = 0x7841182Du; r.w[2] = 0xD0E3951Au;
  r.w[3] = 0x2F02D522u; r.w[4] = 0x0302B0BBu; r.w[5] = 0x70A08B6Du;
  r.w[6] = 0xC2634053u; r.w[7] = 0x60C89CE5u;
  return r;
}

// 1 in Montgomery form: R mod p = 2^256 mod p
BN_FN Fe fe_one() {
  Fe r;
  r.w[0] = 0xC58F0D9Du; r.w[1] = 0xD35D438Du; r.w[2] = 0xF5C70B3Du;
  r.w[3] = 0x0A78EB28u; r.w[4] = 0x7879462Cu; r.w[5] = 0x666EA36Fu;
  r.w[6] = 0x9A07DF2Fu; r.w[7] = 0x0E0A77C1u;
  return r;
}

BN_FN Fe fe_zero() {
  Fe r;
  BN_UNROLL for (int i = 0; i < 8; ++i) r.w[i] = 0u;
  return r;
}

// a - m when a >= m (returns true), else a unchanged.
BN_FN bool fe_cond_sub(Fe& a, const Fe& m) {
  uint32_t t[8];
  int64_t borrow = 0;
  BN_UNROLL for (int i = 0; i < 8; ++i) {
    const int64_t v = (int64_t)a.w[i] - (int64_t)m.w[i] + borrow;
    t[i] = (uint32_t)v;
    borrow = v >> 32;  // 0 or -1
  }
  if (borrow != 0) return false;
  BN_UNROLL for (int i = 0; i < 8; ++i) a.w[i] = t[i];
  return true;
}

#if defined(__CUDA_ARCH__)

// The device field: carry chains in PTX.  Each asm statement holds whole
// chains, so no carry flag lives across statements.

// a, b in [0, 2p): the sum is below 4p < 2^256, reduced into [0, 2p).
BN_FN void fe_add(Fe& r, const Fe& a, const Fe& b) {
  Fe s, d;
  const Fe m = fe_2p();
  uint32_t keep = 0u;
  asm("add.cc.u32 %0, %8, %16;\n\t"
      "addc.cc.u32 %1, %9, %17;\n\t"
      "addc.cc.u32 %2, %10, %18;\n\t"
      "addc.cc.u32 %3, %11, %19;\n\t"
      "addc.cc.u32 %4, %12, %20;\n\t"
      "addc.cc.u32 %5, %13, %21;\n\t"
      "addc.cc.u32 %6, %14, %22;\n\t"
      "addc.u32 %7, %15, %23;"
      : "=r"(s.w[0]), "=r"(s.w[1]), "=r"(s.w[2]), "=r"(s.w[3]),
        "=r"(s.w[4]), "=r"(s.w[5]), "=r"(s.w[6]), "=r"(s.w[7])
      : "r"(a.w[0]), "r"(a.w[1]), "r"(a.w[2]), "r"(a.w[3]), "r"(a.w[4]),
        "r"(a.w[5]), "r"(a.w[6]), "r"(a.w[7]), "r"(b.w[0]), "r"(b.w[1]),
        "r"(b.w[2]), "r"(b.w[3]), "r"(b.w[4]), "r"(b.w[5]), "r"(b.w[6]),
        "r"(b.w[7]));
  // keep = all ones when s - 2p borrows (s < 2p)
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
        "=r"(d.w[4]), "=r"(d.w[5]), "=r"(d.w[6]), "=r"(d.w[7]), "+r"(keep)
      : "r"(s.w[0]), "r"(s.w[1]), "r"(s.w[2]), "r"(s.w[3]), "r"(s.w[4]),
        "r"(s.w[5]), "r"(s.w[6]), "r"(s.w[7]), "r"(m.w[0]), "r"(m.w[1]),
        "r"(m.w[2]), "r"(m.w[3]), "r"(m.w[4]), "r"(m.w[5]), "r"(m.w[6]),
        "r"(m.w[7]));
  BN_UNROLL for (int i = 0; i < 8; ++i) {
    r.w[i] = (s.w[i] & keep) | (d.w[i] & ~keep);
  }
}

// a, b in [0, 2p): a - b in (-2p, 2p), plus 2p when negative.
BN_FN void fe_sub(Fe& r, const Fe& a, const Fe& b) {
  Fe s, q;
  const Fe m = fe_2p();
  uint32_t neg = 0u;
  asm("sub.cc.u32 %0, %9, %17;\n\t"
      "subc.cc.u32 %1, %10, %18;\n\t"
      "subc.cc.u32 %2, %11, %19;\n\t"
      "subc.cc.u32 %3, %12, %20;\n\t"
      "subc.cc.u32 %4, %13, %21;\n\t"
      "subc.cc.u32 %5, %14, %22;\n\t"
      "subc.cc.u32 %6, %15, %23;\n\t"
      "subc.cc.u32 %7, %16, %24;\n\t"
      "subc.u32 %8, %8, 0;"
      : "=r"(s.w[0]), "=r"(s.w[1]), "=r"(s.w[2]), "=r"(s.w[3]),
        "=r"(s.w[4]), "=r"(s.w[5]), "=r"(s.w[6]), "=r"(s.w[7]), "+r"(neg)
      : "r"(a.w[0]), "r"(a.w[1]), "r"(a.w[2]), "r"(a.w[3]), "r"(a.w[4]),
        "r"(a.w[5]), "r"(a.w[6]), "r"(a.w[7]), "r"(b.w[0]), "r"(b.w[1]),
        "r"(b.w[2]), "r"(b.w[3]), "r"(b.w[4]), "r"(b.w[5]), "r"(b.w[6]),
        "r"(b.w[7]));
  BN_UNROLL for (int i = 0; i < 8; ++i) q.w[i] = m.w[i] & neg;
  // the carry out of this addition cancels the borrow
  asm("add.cc.u32 %0, %0, %8;\n\t"
      "addc.cc.u32 %1, %1, %9;\n\t"
      "addc.cc.u32 %2, %2, %10;\n\t"
      "addc.cc.u32 %3, %3, %11;\n\t"
      "addc.cc.u32 %4, %4, %12;\n\t"
      "addc.cc.u32 %5, %5, %13;\n\t"
      "addc.cc.u32 %6, %6, %14;\n\t"
      "addc.u32 %7, %7, %15;"
      : "+r"(s.w[0]), "+r"(s.w[1]), "+r"(s.w[2]), "+r"(s.w[3]),
        "+r"(s.w[4]), "+r"(s.w[5]), "+r"(s.w[6]), "+r"(s.w[7])
      : "r"(q.w[0]), "r"(q.w[1]), "r"(q.w[2]), "r"(q.w[3]), "r"(q.w[4]),
        "r"(q.w[5]), "r"(q.w[6]), "r"(q.w[7]));
  r = s;
}

// CIOS Montgomery product a b R^-1 mod p, for a, b in [0, 2p): the
// result (a b + m p) / R < (4p^2 + R p) / R < 2p, so no final subtraction.
// Per word b_i: t += a b_i (low halves in one chain, high halves one word
// up in a second), then t += m p with m = t_0 (-p^-1) mod 2^32 the same
// way, and t shifts down a word.  t stays below 3p < 2^256 between words
// and below 2^288 within one, so 9 words hold it and no chain carries out
// of the ninth.
BN_FN void fe_mul(Fe& r, const Fe& a, const Fe& b) {
  const Fe p = fe_prime();
  uint32_t t0 = 0u, t1 = 0u, t2 = 0u, t3 = 0u, t4 = 0u, t5 = 0u, t6 = 0u,
           t7 = 0u, t8;
  BN_UNROLL for (int i = 0; i < 8; ++i) {
    t8 = 0u;
    asm("mad.lo.cc.u32 %0, %9, %17, %0;\n\t"
        "madc.lo.cc.u32 %1, %10, %17, %1;\n\t"
        "madc.lo.cc.u32 %2, %11, %17, %2;\n\t"
        "madc.lo.cc.u32 %3, %12, %17, %3;\n\t"
        "madc.lo.cc.u32 %4, %13, %17, %4;\n\t"
        "madc.lo.cc.u32 %5, %14, %17, %5;\n\t"
        "madc.lo.cc.u32 %6, %15, %17, %6;\n\t"
        "madc.lo.cc.u32 %7, %16, %17, %7;\n\t"
        "addc.u32 %8, %8, 0;\n\t"
        "mad.hi.cc.u32 %1, %9, %17, %1;\n\t"
        "madc.hi.cc.u32 %2, %10, %17, %2;\n\t"
        "madc.hi.cc.u32 %3, %11, %17, %3;\n\t"
        "madc.hi.cc.u32 %4, %12, %17, %4;\n\t"
        "madc.hi.cc.u32 %5, %13, %17, %5;\n\t"
        "madc.hi.cc.u32 %6, %14, %17, %6;\n\t"
        "madc.hi.cc.u32 %7, %15, %17, %7;\n\t"
        "madc.hi.u32 %8, %16, %17, %8;"
        : "+r"(t0), "+r"(t1), "+r"(t2), "+r"(t3), "+r"(t4), "+r"(t5),
          "+r"(t6), "+r"(t7), "+r"(t8)
        : "r"(a.w[0]), "r"(a.w[1]), "r"(a.w[2]), "r"(a.w[3]), "r"(a.w[4]),
          "r"(a.w[5]), "r"(a.w[6]), "r"(a.w[7]), "r"(b.w[i]));
    const uint32_t m = t0 * kPInv;
    asm("mad.lo.cc.u32 %0, %9, %10, %0;\n\t"
        "madc.lo.cc.u32 %1, %9, %11, %1;\n\t"
        "madc.lo.cc.u32 %2, %9, %12, %2;\n\t"
        "madc.lo.cc.u32 %3, %9, %13, %3;\n\t"
        "madc.lo.cc.u32 %4, %9, %14, %4;\n\t"
        "madc.lo.cc.u32 %5, %9, %15, %5;\n\t"
        "madc.lo.cc.u32 %6, %9, %16, %6;\n\t"
        "madc.lo.cc.u32 %7, %9, %17, %7;\n\t"
        "addc.u32 %8, %8, 0;\n\t"
        "mad.hi.cc.u32 %1, %9, %10, %1;\n\t"
        "madc.hi.cc.u32 %2, %9, %11, %2;\n\t"
        "madc.hi.cc.u32 %3, %9, %12, %3;\n\t"
        "madc.hi.cc.u32 %4, %9, %13, %4;\n\t"
        "madc.hi.cc.u32 %5, %9, %14, %5;\n\t"
        "madc.hi.cc.u32 %6, %9, %15, %6;\n\t"
        "madc.hi.cc.u32 %7, %9, %16, %7;\n\t"
        "madc.hi.u32 %8, %9, %17, %8;"
        : "+r"(t0), "+r"(t1), "+r"(t2), "+r"(t3), "+r"(t4), "+r"(t5),
          "+r"(t6), "+r"(t7), "+r"(t8)
        : "r"(m), "r"(p.w[0]), "r"(p.w[1]), "r"(p.w[2]), "r"(p.w[3]),
          "r"(p.w[4]), "r"(p.w[5]), "r"(p.w[6]), "r"(p.w[7]));
    // t0 is now 0: shift down a word
    t0 = t1; t1 = t2; t2 = t3; t3 = t4; t4 = t5; t5 = t6; t6 = t7; t7 = t8;
  }
  r.w[0] = t0; r.w[1] = t1; r.w[2] = t2; r.w[3] = t3;
  r.w[4] = t4; r.w[5] = t5; r.w[6] = t6; r.w[7] = t7;
}

#else  // the host field: portable C++

// a, b in [0, 2p): the sum is below 4p < 2^256, reduced into [0, 2p).
BN_FN void fe_add(Fe& r, const Fe& a, const Fe& b) {
  uint64_t c = 0;
  for (int i = 0; i < 8; ++i) {
    c += (uint64_t)a.w[i] + b.w[i];
    r.w[i] = (uint32_t)c;
    c >>= 32;
  }
  fe_cond_sub(r, fe_2p());
}

// a, b in [0, 2p): a - b in (-2p, 2p), plus 2p when negative.
BN_FN void fe_sub(Fe& r, const Fe& a, const Fe& b) {
  int64_t borrow = 0;
  for (int i = 0; i < 8; ++i) {
    const int64_t v = (int64_t)a.w[i] - (int64_t)b.w[i] + borrow;
    r.w[i] = (uint32_t)v;
    borrow = v >> 32;
  }
  if (borrow != 0) {  // the carry out of the addition cancels the borrow
    const Fe m = fe_2p();
    uint64_t c = 0;
    for (int i = 0; i < 8; ++i) {
      c += (uint64_t)r.w[i] + m.w[i];
      r.w[i] = (uint32_t)c;
      c >>= 32;
    }
  }
}

// CIOS Montgomery product a b R^-1 mod p, for a, b in [0, 2p): the
// result (a b + m p) / R < (4p^2 + R p) / R < 2p, so no final subtraction.
BN_FN void fe_mul(Fe& r, const Fe& a, const Fe& b) {
  const Fe p = fe_prime();
  uint32_t t[10];
  for (int i = 0; i < 10; ++i) t[i] = 0u;
  for (int i = 0; i < 8; ++i) {
    uint64_t c = 0;
    for (int j = 0; j < 8; ++j) {
      // (2^32-1)^2 + 2 (2^32-1) = 2^64 - 1: no overflow
      const uint64_t v = (uint64_t)a.w[j] * b.w[i] + t[j] + c;
      t[j] = (uint32_t)v;
      c = v >> 32;
    }
    uint64_t v = (uint64_t)t[8] + c;
    t[8] = (uint32_t)v;
    t[9] = (uint32_t)(v >> 32);
    const uint32_t m = t[0] * kPInv;
    v = (uint64_t)m * p.w[0] + t[0];  // low word is 0 by the choice of m
    c = v >> 32;
    for (int j = 1; j < 8; ++j) {
      v = (uint64_t)m * p.w[j] + t[j] + c;
      t[j - 1] = (uint32_t)v;
      c = v >> 32;
    }
    v = (uint64_t)t[8] + c;
    t[7] = (uint32_t)v;
    t[8] = t[9] + (uint32_t)(v >> 32);
  }
  for (int i = 0; i < 8; ++i) r.w[i] = t[i];
}

#endif  // __CUDA_ARCH__

BN_FN void fe_sqr(Fe& r, const Fe& a) { fe_mul(r, a, a); }

// a in [0, 2p): a == 0 mod p.
BN_FN bool fe_is_zero(const Fe& a) {
  const Fe p = fe_prime();
  uint32_t z = 0u, q = 0u;
  BN_UNROLL for (int i = 0; i < 8; ++i) {
    z |= a.w[i];
    q |= a.w[i] ^ p.w[i];
  }
  return z == 0u || q == 0u;
}

// a in [0, 2p) -> [0, p).
BN_FN void fe_canon(Fe& a) { fe_cond_sub(a, fe_prime()); }

// Word i of a value at base[i * stride + lane].
BN_FN Fe fe_load(const uint32_t* base, size_t stride, int lane) {
  Fe r;
  BN_UNROLL for (int i = 0; i < 8; ++i) r.w[i] = base[i * stride + lane];
  return r;
}

// -- point operations (a = 0) ------------------------------------------------

BN_FN Jac jac_infinity() {
  Jac o;
  o.x = fe_zero();
  o.y = o.x;
  o.z = o.x;
  o.inf = true;
  return o;
}

// dbl-2009-l.  The coordinates of a point at infinity are never read into
// a finite result, so its doubling is skipped.
BN_FN Jac jac_dbl(const Jac& p) {
  if (p.inf) return p;
  Jac o;
  Fe a, b, c, d, e, t;
  fe_sqr(a, p.x);
  fe_sqr(b, p.y);
  fe_sqr(c, b);
  fe_add(t, p.x, b);
  fe_sqr(t, t);
  fe_sub(t, t, a);
  fe_sub(t, t, c);
  fe_add(d, t, t);                 // d = 2 ((x + b)^2 - a - c)
  fe_add(e, a, a);
  fe_add(e, e, a);                 // e = 3 a
  fe_sqr(t, e);                    // f = e^2
  fe_add(o.x, d, d);
  fe_sub(o.x, t, o.x);             // x3 = f - 2 d
  fe_sub(t, d, o.x);
  fe_mul(o.y, e, t);
  fe_add(c, c, c);
  fe_add(c, c, c);
  fe_add(c, c, c);                 // 8 c
  fe_sub(o.y, o.y, c);             // y3 = e (d - x3) - 8 c
  fe_mul(o.z, p.y, p.z);
  fe_add(o.z, o.z, o.z);           // z3 = 2 y z
  o.inf = false;
  return o;
}

// h == 0 after the generic setup: P + P doubles, P + (-P) is infinity.
BN_FN Jac jac_same_x(const Jac& p1, const Fe& rr) {
  if (fe_is_zero(rr)) return jac_dbl(p1);
  Jac o = p1;
  o.inf = true;
  return o;
}

// madd-2007-bl: p1 + (ax, ay) with z = 1, the affine operand at infinity
// when ainf.
BN_FN Jac jac_add_mixed(const Jac& p1, const Fe& ax, const Fe& ay,
                        bool ainf) {
  if (p1.inf) {
    Jac o;
    o.x = ax;
    o.y = ay;
    o.z = fe_one();
    o.inf = ainf;
    return o;
  }
  if (ainf) return p1;
  Jac o;
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
  fe_add(i4, i4, i4);              // i = 4 h^2
  fe_mul(j, h, i4);
  fe_add(rr, rr, rr);              // rr2
  fe_mul(v, p1.x, i4);
  fe_sqr(o.x, rr);
  fe_sub(o.x, o.x, j);
  fe_add(t, v, v);
  fe_sub(o.x, o.x, t);             // x3 = rr2^2 - j - 2 v
  fe_mul(t, p1.y, j);
  fe_add(t, t, t);
  fe_sub(v, v, o.x);
  fe_mul(o.y, rr, v);
  fe_sub(o.y, o.y, t);             // y3 = rr2 (v - x3) - 2 y1 j
  fe_add(o.z, p1.z, h);
  fe_sqr(o.z, o.z);
  fe_sub(o.z, o.z, z1z1);
  fe_sub(o.z, o.z, hh);            // z3 = (z1 + h)^2 - z1z1 - hh
  o.inf = false;
  return o;
}

// add-2007-bl.
BN_FN Jac jac_add(const Jac& p1, const Jac& p2) {
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
  fe_sqr(i, i);                    // i = (2 h)^2
  fe_mul(j, h, i);
  fe_add(rr, rr, rr);              // rr2
  fe_mul(v, u1, i);
  fe_sqr(o.x, rr);
  fe_sub(o.x, o.x, j);
  fe_add(t, v, v);
  fe_sub(o.x, o.x, t);             // x3 = rr2^2 - j - 2 v
  fe_mul(t, s1, j);
  fe_add(t, t, t);
  fe_sub(v, v, o.x);
  fe_mul(o.y, rr, v);
  fe_sub(o.y, o.y, t);             // y3 = rr2 (v - x3) - 2 s1 j
  fe_add(o.z, p1.z, p2.z);
  fe_sqr(o.z, o.z);
  fe_sub(o.z, o.z, z1z1);
  fe_sub(o.z, o.z, z2z2);
  fe_mul(o.z, o.z, h);             // z3 = ((z1 + z2)^2 - z1z1 - z2z2) h
  o.inf = false;
  return o;
}

// Canonical words of c at rows[i * stride] (zeros for a point at
// infinity).
BN_FN void store_fe(uint32_t* rows, size_t stride, const Fe& c, bool inf) {
  Fe v = inf ? fe_zero() : c;
  fe_canon(v);
  BN_UNROLL for (int i = 0; i < 8; ++i) rows[i * stride] = v.w[i];
}

// Accumulator a of one lane into the output: x, y, z words at rows
// 8 (3 k + a) for coordinate k, the flag at row 72 + a.
BN_FN void store_point(uint32_t* out, int n, int lane, int a, const Jac& p) {
  const size_t s = (size_t)n;
  store_fe(out + 8 * a * s + lane, s, p.x, p.inf);
  store_fe(out + 8 * (3 + a) * s + lane, s, p.y, p.inf);
  store_fe(out + 8 * (6 + a) * s + lane, s, p.z, p.inf);
  out[(size_t)(9 * 8 + a) * s + lane] = p.inf ? 1u : 0u;
}

// -- the term bodies -----------------------------------------------------------
//
// The arrays, lanes on the last axis (n lanes):
//   lanes    (64, n): base b's x words at rows 16 b .. 16 b + 7, y words at
//            16 b + 8 .. 16 b + 15 (a', a_bar, b', nym; Montgomery form)
//   laneinf  (4, n): 1 where base b is infinity (bad and padding lanes)
//   digits   (8 n_terms, n): term t's 64 MSB-first 4-bit window digits,
//            8 per word (digit w in bits 4 (w % 8) of word 8 t + w / 8)
//   termmeta (n_terms, 2): [table, accumulator]; tables 0 .. n_shared - 1
//            are the shared bases, n_shared .. n_shared + 3 the lane bases
//   comb_xy  (n_shared 1024, 16): entry 1024 s + 16 k + d holds the affine
//            x then y words of d 16^k B_s, shared base s
//   comb_inf (n_shared 1024): 1 where a comb entry is infinity
//   part     (25 n_terms, n): term t's partial, x, y, z canonical words
//            at rows 25 t + 8 c .. 25 t + 8 c + 7, the flag at 25 t + 24
//   out      (kOutRows, n), see store_point

// Digit w (MSB first) of term t.
BN_FN int term_digit(const uint32_t* digits, int n, int lane, int t, int w) {
  const uint32_t word = digits[(size_t)(8 * t + (w >> 3)) * n + lane];
  return (int)((word >> (4 * (w & 7))) & 0xFu);
}

// s B for a shared base: one mixed add of comb entry d_w 16^(63 - w) B a
// window, no doublings.
BN_FN Jac comb_term(const uint32_t* digits, int n, int lane, int t,
                    const uint32_t* comb_xy, const uint32_t* comb_inf,
                    int s) {
  Jac acc = jac_infinity();
  BN_NO_UNROLL for (int w = 0; w < kWindows; ++w) {
    const int d = term_digit(digits, n, lane, t, w);
    const int e = kCombEntries * s + kTable * (kWindows - 1 - w) + d;
    const uint32_t* q = comb_xy + (size_t)kEntryWords * e;
    const Fe ax = fe_load(q, 1, 0);
    const Fe ay = fe_load(q + 8, 1, 0);
    acc = jac_add_mixed(acc, ax, ay, comb_inf[e] != 0u);
  }
  return acc;
}

// s B for a lane base (affine px, py): its 16-entry Jacobian table by a
// 14-step mixed-add chain (in local memory, indexed by digit), then 64
// MSB-first windows of 4 doublings and one full add.
BN_FN Jac ladder_term(const uint32_t* digits, int n, int lane, int t,
                      const Fe& px, const Fe& py, bool pinf) {
  Fe tx[kTable], ty[kTable], tz[kTable];
  uint32_t tinf = 1u | ((uint32_t)pinf << 1);  // bit k: entry k is infinity
  tx[0] = fe_zero();
  ty[0] = tx[0];
  tz[0] = tx[0];
  Jac e;
  e.x = px;
  e.y = py;
  e.z = fe_one();
  e.inf = pinf;
  tx[1] = e.x;
  ty[1] = e.y;
  tz[1] = e.z;
  BN_NO_UNROLL for (int k = 2; k < kTable; ++k) {
    e = jac_add_mixed(e, px, py, pinf);
    tx[k] = e.x;
    ty[k] = e.y;
    tz[k] = e.z;
    tinf |= (uint32_t)e.inf << k;
  }
  Jac acc = jac_infinity();
  BN_NO_UNROLL for (int w = 0; w < kWindows; ++w) {
    BN_NO_UNROLL for (int k = 0; k < 4; ++k) acc = jac_dbl(acc);
    const int d = term_digit(digits, n, lane, t, w);
    Jac q;
    q.x = tx[d];
    q.y = ty[d];
    q.z = tz[d];
    q.inf = ((tinf >> d) & 1u) != 0u;
    acc = jac_add(acc, q);
  }
  return acc;
}

// Term t's partial for one lane, stored canonical into part.  A term with
// a table or accumulator out of range is infinity (the host never packs
// one).
BN_FN void term_lane(const uint32_t* lanes, const uint32_t* laneinf,
                     const uint32_t* digits, const int32_t* termmeta,
                     const uint32_t* comb_xy, const uint32_t* comb_inf,
                     int n_shared, uint32_t* part, int n, int lane, int t) {
  const int tab = termmeta[2 * t];
  const int a = termmeta[2 * t + 1];
  const size_t s = (size_t)n;
  Jac p = jac_infinity();
  if (tab >= 0 && tab < n_shared + kLaneBases && a >= 0 && a < kAccs) {
    if (tab < n_shared) {
      p = comb_term(digits, n, lane, t, comb_xy, comb_inf, tab);
    } else {
      const int b = tab - n_shared;
      const Fe px = fe_load(lanes + (size_t)(16 * b) * s, s, lane);
      const Fe py = fe_load(lanes + (size_t)(16 * b + 8) * s, s, lane);
      p = ladder_term(digits, n, lane, t, px, py,
                      laneinf[(size_t)b * s + lane] != 0u);
    }
  }
  uint32_t* rows = part + (size_t)(kPartRows * t) * s + lane;
  store_fe(rows, s, p.x, p.inf);
  store_fe(rows + 8 * s, s, p.y, p.inf);
  store_fe(rows + 16 * s, s, p.z, p.inf);
  rows[24 * s] = p.inf ? 1u : 0u;
}

// Accumulator a of one lane: its terms' partials added in termmeta order
// by the full add (equal partials double, opposite ones cancel), then
// stored canonical into out.
BN_FN void reduce_lane(const uint32_t* part, const int32_t* termmeta,
                       int n_terms, uint32_t* out, int n, int lane, int a) {
  const size_t s = (size_t)n;
  Jac acc = jac_infinity();
  for (int t = 0; t < n_terms; ++t) {
    if (termmeta[2 * t + 1] != a) continue;
    const uint32_t* rows = part + (size_t)(kPartRows * t) * s;
    Jac q;
    q.x = fe_load(rows, s, lane);
    q.y = fe_load(rows + 8 * s, s, lane);
    q.z = fe_load(rows + 16 * s, s, lane);
    q.inf = rows[24 * s + lane] != 0u;
    acc = jac_add(acc, q);
  }
  store_point(out, n, lane, a, acc);
}

}  // namespace bn254
