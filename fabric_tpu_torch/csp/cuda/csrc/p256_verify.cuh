// ECDSA-P256 verification of one signature per thread: field arithmetic,
// Jacobian point operations and the lane body shared by the two kernels
// of p256_verify.cu.
//
// Every function here is __host__ __device__: the header compiles as
// plain C++ too (p256_host_check.cpp), so the arithmetic of the kernel
// can be run and tested on a host without a GPU.
//
// Field elements are 8 little-endian 32-bit words, always canonical
// (value < p).  Point formulas, exception cases and the final check
// follow fabric_tpu/csp/tpu/pallas_ec.py (_dbl, _add_full, _add_mixed,
// _kernel_body); the coordinates of a point at infinity never reach a
// finite result, so the branches below give the verdicts of its selects.
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

P256_FN void fe_mul(Fe& r, const Fe& a, const Fe& b) {
  uint32_t t[16];
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
  fe_reduce_wide(r, t);
}

P256_FN void fe_sqr(Fe& r, const Fe& a) { fe_mul(r, a, a); }

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

// -- the lane body --------------------------------------------------------------

// One signature: Q = (qx, qy); d1/d2 hold the lane's packed window digits
// of u1/u2 at d[word * stride + lane]; g is the fixed table of the
// multiples 0..15 of G as (2, 16, 8) words (x, then y; entry 0 is
// infinity).  Returns 1 when x(u1 G + u2 Q) == cand0 (or cand0 + n, when
// cand1_ok) mod n, checked as x == cand * z^2 (mod p) without inversion.
P256_FN uint8_t verify_lane(const Fe& qx, const Fe& qy, const uint32_t* d1,
                            const uint32_t* d2, const Fe& cand0,
                            bool cand1_ok, const uint32_t* g, int stride,
                            int lane) {
  // Q window table, entries 0 (infinity) and 1 direct, 2..15 by a chain
  // of 14 mixed adds; in local memory, indexed by the digits below.
  Fe tx[16], ty[16], tz[16];
  uint32_t tinf = 1u;  // bit k: entry k is at infinity
  tx[0] = fe_small(0u);
  ty[0] = fe_small(0u);
  tz[0] = fe_small(0u);
  Jac e;
  e.x = qx;
  e.y = qy;
  e.z = fe_small(1u);
  e.inf = false;
  tx[1] = e.x;
  ty[1] = e.y;
  tz[1] = e.z;
  for (int k = 2; k < 16; ++k) {
    e = jac_add_mixed(e, qx, qy, false);
    tx[k] = e.x;
    ty[k] = e.y;
    tz[k] = e.z;
    tinf |= (uint32_t)e.inf << k;
  }

  // joint ladder u1 G + u2 Q, 64 windows, most significant first
  Jac r;
  r.x = fe_small(0u);
  r.y = r.x;
  r.z = r.x;
  r.inf = true;
  for (int w = 0; w < kWindows; ++w) {
    if (!r.inf) {  // doubling infinity leaves infinity
      r = jac_dbl(r);
      r = jac_dbl(r);
      r = jac_dbl(r);
      r = jac_dbl(r);
    }
    const int row = (w >> 3) * stride + lane;
    const int shift = 4 * (w & 7);
    const uint32_t k1 = (d1[row] >> shift) & 0xFu;
    const uint32_t k2 = (d2[row] >> shift) & 0xFu;
    Fe gx, gy;
    P256_UNROLL for (int i = 0; i < 8; ++i) {
      gx.w[i] = g[k1 * 8 + i];
      gy.w[i] = g[128 + k1 * 8 + i];
    }
    r = jac_add_mixed(r, gx, gy, k1 == 0u);
    Jac qk;
    qk.x = tx[k2];
    qk.y = ty[k2];
    qk.z = tz[k2];
    qk.inf = ((tinf >> k2) & 1u) != 0u;
    r = jac_add(r, qk);
  }

  // x(R) == cand mod n  <=>  X == cand Z^2 (mod p) for cand in {r, r+n}
  // (r + n only when the host flagged r + n < p).  Z == 0 happens only
  // for inputs outside the group (a zero or off-curve key) and would
  // accept anything, so such lanes are rejected.
  if (r.inf || fe_is_zero(r.z)) return 0;
  Fe z2, t;
  fe_sqr(z2, r.z);
  fe_mul(t, cand0, z2);
  if (fe_eq(r.x, t)) return 1;
  if (!cand1_ok) return 0;
  Fe cand1;
  fe_add(cand1, cand0, fe_order());
  fe_mul(t, cand1, z2);
  return fe_eq(r.x, t) ? 1 : 0;
}

// The key-table layout: Q is entry kidx[lane] of the (8, kKeyTab) word
// tables; an index outside the table selects the zero point, which the
// z == 0 guard rejects.  flags is (2, n): [cand1_ok; valid].
P256_FN uint8_t verify_keytab(const uint32_t* ktabx, const uint32_t* ktaby,
                              const uint32_t* kidx, const uint32_t* d1,
                              const uint32_t* d2, const uint32_t* cand0,
                              const uint32_t* flags, const uint32_t* g,
                              int n, int lane) {
  if (flags[n + lane] == 0u) return 0;  // invalid or padding lane
  const uint32_t k = kidx[lane];
  Fe qx = fe_small(0u), qy = fe_small(0u);
  if (k < (uint32_t)kKeyTab) {
    qx = fe_load(ktabx, kKeyTab, (int)k);
    qy = fe_load(ktaby, kKeyTab, (int)k);
  }
  return verify_lane(qx, qy, d1, d2, fe_load(cand0, n, lane),
                     flags[lane] != 0u, g, n, lane);
}

// The per-lane key layout: Q from the (8, n) word arrays qx, qy.
P256_FN uint8_t verify_lanekeys(const uint32_t* qx, const uint32_t* qy,
                                const uint32_t* d1, const uint32_t* d2,
                                const uint32_t* cand0, const uint32_t* flags,
                                const uint32_t* g, int n, int lane) {
  if (flags[n + lane] == 0u) return 0;
  return verify_lane(fe_load(qx, n, lane), fe_load(qy, n, lane), d1, d2,
                     fe_load(cand0, n, lane), flags[lane] != 0u, g, n, lane);
}

}  // namespace p256
