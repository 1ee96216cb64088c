// The lane pieces of both verify kernels of p256_verify.cu: u1 G + u2 Q
// as 8 single-base ladders, then one sum and the final check.
//
// With u = sum_j u_j 2^(64 j) for the quarters j = 0..3 of a scalar,
//
//   u1 G + u2 Q = sum_j u1_j (2^(64 j) G) + sum_j u2_j (2^(64 j) Q).
//
// Parts 0..3 (u1_j G) are 16-window ladders over G's affine quarter
// tables d 2^(64 j) G, d = 0..15, built on the host once.  Parts 4..7
// differ by kernel:
//   - p256_verify_keytab (B1): a 16-window ladder over the key's affine
//     quarter tables, built on the host once per key of the table
//     (p256_kernel.key_quarter_tables);
//   - p256_verify_lanekeys (B2): the key is new in every flush, so part 4
//     builds the lane's Jacobian table of d Q, d = 1..15 (a doubling and
//     13 mixed adds) for all four Q parts; part 4 + j runs quarter j's 16
//     windows over it with full adds and doubles the result 64 j times.
// Partials and the tables of Q live in strided word buffers (shared
// memory on the card, local arrays on the host), so the kernels and the
// host build run the same functions.  Like p256_verify.cuh, everything
// is __host__ __device__ and compiles as plain C++ (p256_host_check.cpp).
#pragma once

#include "p256_verify.cuh"

namespace p256 {

constexpr int kQuarters = 4;  // parts per scalar, one table each
constexpr int kParts = 2 * kQuarters;  // u1's over G, then u2's over Q
constexpr int kPartWindows = kWindows / kQuarters;
constexpr int kEntryWords = 16;  // x then y, 8 words each
constexpr int kQuarterWords = 16 * kEntryWords;
constexpr int kBaseWords = kQuarters * kQuarterWords;  // 1024 (4 KiB)
constexpr int kPartialWords = 24;  // X, Y, Z
constexpr int kQTableWords = 15 * kPartialWords;  // a lane's table of Q

P256_FN Jac jac_infinity() {
  Jac r;
  r.x = fe_small(0u);
  r.y = r.x;
  r.z = r.x;
  r.inf = true;
  return r;
}

// The key-table lane guard: a padding or invalid lane, a key index
// outside the table, and a key that is not on P-256 (flagged by the host
// in keybad; no tables were built for it) are rejected before any
// arithmetic.
P256_FN bool keytab_lane_ok(const uint32_t* kidx, const uint32_t* keybad,
                            const uint32_t* flags, int n, int lane) {
  if (flags[n + lane] == 0u) return false;
  const uint32_t k = kidx[lane];
  return k < (uint32_t)kKeyTab && keybad[k] == 0u;
}

// The per-lane-key guard: a padding or invalid lane, and a key that is
// not on P-256 (read mod p, as fe_load does; the zero point among them),
// are rejected before any arithmetic.  The point formulas do not use b,
// so an off-curve key would otherwise run through them with G on one
// curve and Q on another, where the sum depends on the order of the
// additions.
P256_FN bool lanekeys_lane_ok(const uint32_t* qx, const uint32_t* qy,
                              const uint32_t* flags, int n, int lane) {
  if (flags[n + lane] == 0u) return false;
  return on_curve(fe_load(qx, n, lane), fe_load(qy, n, lane));
}

// Window w's digit (MSB-first windows) of the scalar packed in d.
P256_FN uint32_t window_digit(const uint32_t* d, int w, int stride,
                              int lane) {
  return (d[(w >> 3) * stride + lane] >> (4 * (w & 7))) & 0xFu;
}

// First window of quarter j (0 = least significant).
P256_FN int quarter_start(int j) { return kWindows - (j + 1) * kPartWindows; }

P256_FN void jac_dbl4(Jac& r) {
  if (r.inf) return;  // doubling infinity leaves infinity
  r = jac_dbl(r);
  r = jac_dbl(r);
  r = jac_dbl(r);
  r = jac_dbl(r);
}

// Quarter j of the scalar whose packed MSB-first digits are d[word *
// stride + lane], times the base of `tab` (16 affine entries of (x, y)
// words, entry 0 at infinity): a 16-window ladder, most significant
// window first, from infinity.
P256_FN Jac quarter_ladder(const uint32_t* tab, const uint32_t* d, int j,
                           int stride, int lane) {
  Jac r = jac_infinity();
  const int w0 = quarter_start(j);
  for (int w = w0; w < w0 + kPartWindows; ++w) {
    jac_dbl4(r);
    const uint32_t k = window_digit(d, w, stride, lane);
    Fe ax, ay;
    P256_UNROLL for (int i = 0; i < 8; ++i) {
      ax.w[i] = tab[k * kEntryWords + i];
      ay.w[i] = tab[k * kEntryWords + 8 + i];
    }
    r = jac_add_mixed(r, ax, ay, k == 0u);
  }
  return r;
}

// Point `slot` of a strided word buffer: its X, Y, Z words at
// w[(slot * 24 + i) * stride + lane].
P256_FN void store_xyz(uint32_t* w, int stride, int slot, int lane,
                       const Jac& p) {
  P256_UNROLL for (int i = 0; i < 8; ++i) {
    w[(slot * kPartialWords + i) * stride + lane] = p.x.w[i];
    w[(slot * kPartialWords + 8 + i) * stride + lane] = p.y.w[i];
    w[(slot * kPartialWords + 16 + i) * stride + lane] = p.z.w[i];
  }
}

P256_FN Jac load_xyz(const uint32_t* w, int stride, int slot, int lane) {
  Jac p;
  P256_UNROLL for (int i = 0; i < 8; ++i) {
    p.x.w[i] = w[(slot * kPartialWords + i) * stride + lane];
    p.y.w[i] = w[(slot * kPartialWords + 8 + i) * stride + lane];
    p.z.w[i] = w[(slot * kPartialWords + 16 + i) * stride + lane];
  }
  p.inf = false;
  return p;
}

// The lane's table of d Q for d = 1..15 in Jacobian coordinates, entry d
// at slot d - 1 of the strided buffer t (kQTableWords words a lane).  Q
// is on P-256 (the guard), of prime order, so no entry is at infinity and
// no mixed add meets its own operand.
P256_FN void build_q_table(uint32_t* t, int stride, int lane, const Fe& qx,
                           const Fe& qy) {
  Jac e;
  e.x = qx;
  e.y = qy;
  e.z = fe_small(1u);
  e.inf = false;
  store_xyz(t, stride, 0, lane, e);
  e = jac_dbl(e);
  for (int k = 1; k < 15; ++k) {
    if (k > 1) e = jac_add_mixed(e, qx, qy, false);
    store_xyz(t, stride, k, lane, e);
  }
}

// u2_j 2^(64 j) Q, part 4 + j of a per-lane-key lane: quarter j's 16
// windows over the lane's table (build_q_table; slots at t, tstride,
// tlane) with full adds, then 64 j doublings.  A quarter whose digits
// are all 0 is at infinity.
P256_FN Jac lane_q_quarter(const uint32_t* t, int tstride, int tlane,
                           const uint32_t* d2, int j, int stride, int lane) {
  Jac r = jac_infinity();
  const int w0 = quarter_start(j);
  // a quarter's 16 digits are packed words w0 / 8 and w0 / 8 + 1
  if ((d2[(w0 >> 3) * stride + lane] | d2[((w0 >> 3) + 1) * stride + lane])
      == 0u) {
    return r;
  }
  for (int w = w0; w < w0 + kPartWindows; ++w) {
    jac_dbl4(r);
    const uint32_t k = window_digit(d2, w, stride, lane);
    if (k == 0u) continue;
    r = jac_add(r, load_xyz(t, tstride, (int)k - 1, tlane));
  }
  for (int i = 0; i < j * kPartWindows; ++i) jac_dbl4(r);
  return r;
}

// Partial `slot` of a lane: its point at slot `slot` of w (store_xyz),
// its infinity flag at inf[slot * stride + lane].
P256_FN void store_partial(uint32_t* w, uint32_t* inf, int stride, int slot,
                           int lane, const Jac& p) {
  store_xyz(w, stride, slot, lane, p);
  inf[slot * stride + lane] = p.inf ? 1u : 0u;
}

P256_FN Jac load_partial(const uint32_t* w, const uint32_t* inf, int stride,
                         int slot, int lane) {
  Jac p = load_xyz(w, stride, slot, lane);
  p.inf = inf[slot * stride + lane] != 0u;
  return p;
}

// x(R) == cand mod n  <=>  X == cand Z^2 (mod p) for cand in {r, r + n}
// (r + n only when the host flagged r + n < p).  Infinity or Z == 0
// rejects.
P256_FN uint8_t final_check(const Jac& r, const Fe& cand0, bool cand1_ok) {
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

// The lane's 8 partials (slot j: u1_j G; slot 4 + j: u2_j Q) summed in
// one fixed order, most significant first,
//   u1_3 G, u2_3 Q, u1_2 G, u2_2 Q, u1_1 G, u2_1 Q, u1_0 G, u2_0 Q,
// with jac_add (equal summands take its doubling branch, opposite ones
// its infinity branch), then the final check.
P256_FN uint8_t reduce_and_check(const uint32_t* w, const uint32_t* inf,
                                 int stride, int lane, const Fe& cand0,
                                 bool cand1_ok) {
  Jac r = load_partial(w, inf, stride, kQuarters - 1, lane);
  r = jac_add(r, load_partial(w, inf, stride, kParts - 1, lane));
  for (int j = kQuarters - 2; j >= 0; --j) {
    r = jac_add(r, load_partial(w, inf, stride, j, lane));
    r = jac_add(r, load_partial(w, inf, stride, kQuarters + j, lane));
  }
  return final_check(r, cand0, cand1_ok);
}

// Part `part` of a key-table lane that passed keytab_lane_ok: parts
// 0..3 are u1_j G over the G tables `gq`, parts 4..7 are u2_j Q over the
// key's tables in qtab ((kKeyTab, kQuarters, 16, 2, 8) words).
P256_FN Jac keytab_part(const uint32_t* qtab, const uint32_t* kidx,
                        const uint32_t* d1, const uint32_t* d2,
                        const uint32_t* gq, int part, int n, int lane) {
  const bool over_q = part >= kQuarters;
  const int j = over_q ? part - kQuarters : part;
  const uint32_t* base = over_q ? qtab + (int)kidx[lane] * kBaseWords : gq;
  return quarter_ladder(base + j * kQuarterWords, over_q ? d2 : d1, j, n,
                        lane);
}

// Part `part` of a per-lane-key lane that passed lanekeys_lane_ok: parts
// 0..3 are u1_j G over the G tables `gq`, part 4 + j is lane_q_quarter
// over the lane's table of Q (at t, tstride, tlane), which part 4 built
// before any Q part reads it.
P256_FN Jac lanekeys_part(const uint32_t* t, int tstride, int tlane,
                          const uint32_t* d1, const uint32_t* d2,
                          const uint32_t* gq, int part, int n, int lane) {
  if (part < kQuarters) {
    return quarter_ladder(gq + part * kQuarterWords, d1, part, n, lane);
  }
  return lane_q_quarter(t, tstride, tlane, d2, part - kQuarters, n, lane);
}

}  // namespace p256
