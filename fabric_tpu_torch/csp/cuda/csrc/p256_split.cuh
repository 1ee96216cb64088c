// The lane pieces of the split key-table verify (p256_verify_keytab):
// u1 G + u2 Q as 8 single-base ladders over precomputed affine tables,
// then one sum and the final check.
//
// With u = sum_j u_j 2^(64 j) for the quarters j = 0..3 of a scalar,
//
//   u1 G + u2 Q = sum_j u1_j (2^(64 j) G) + sum_j u2_j (2^(64 j) Q),
//
// so each term is a 16-window ladder over the table of d 2^(64 j) B,
// d = 0..15 (entry 0 at infinity), built on the host once per key
// (p256_kernel.key_quarter_tables).  Partials live in a strided word
// buffer (shared memory on the card, a local array on the host), so the
// kernel and the host build run the same functions.  Like p256_verify.cuh, everything is
// __host__ __device__ and compiles as plain C++ (p256_host_check.cpp).
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

// Quarter j (0 = least significant) of the scalar whose packed MSB-first
// digits are d[word * stride + lane], times the base of `tab` (16 affine
// entries of (x, y) words, entry 0 at infinity): a 16-window ladder,
// most significant window first, from infinity (doublings skipped while
// at infinity).
P256_FN Jac quarter_ladder(const uint32_t* tab, const uint32_t* d, int j,
                           int stride, int lane) {
  Jac r;
  r.x = fe_small(0u);
  r.y = r.x;
  r.z = r.x;
  r.inf = true;
  const int w0 = kWindows - (j + 1) * kPartWindows;
  for (int w = w0; w < w0 + kPartWindows; ++w) {
    if (!r.inf) {
      r = jac_dbl(r);
      r = jac_dbl(r);
      r = jac_dbl(r);
      r = jac_dbl(r);
    }
    const uint32_t k = (d[(w >> 3) * stride + lane] >> (4 * (w & 7))) & 0xFu;
    Fe ax, ay;
    P256_UNROLL for (int i = 0; i < 8; ++i) {
      ax.w[i] = tab[k * kEntryWords + i];
      ay.w[i] = tab[k * kEntryWords + 8 + i];
    }
    r = jac_add_mixed(r, ax, ay, k == 0u);
  }
  return r;
}

// Partial `slot` of a lane: words at w[(slot * 24 + i) * stride + lane]
// (X, Y, Z), its infinity flag at inf[slot * stride + lane].
P256_FN void store_partial(uint32_t* w, uint32_t* inf, int stride, int slot,
                           int lane, const Jac& p) {
  P256_UNROLL for (int i = 0; i < 8; ++i) {
    w[(slot * kPartialWords + i) * stride + lane] = p.x.w[i];
    w[(slot * kPartialWords + 8 + i) * stride + lane] = p.y.w[i];
    w[(slot * kPartialWords + 16 + i) * stride + lane] = p.z.w[i];
  }
  inf[slot * stride + lane] = p.inf ? 1u : 0u;
}

P256_FN Jac load_partial(const uint32_t* w, const uint32_t* inf, int stride,
                         int slot, int lane) {
  Jac p;
  P256_UNROLL for (int i = 0; i < 8; ++i) {
    p.x.w[i] = w[(slot * kPartialWords + i) * stride + lane];
    p.y.w[i] = w[(slot * kPartialWords + 8 + i) * stride + lane];
    p.z.w[i] = w[(slot * kPartialWords + 16 + i) * stride + lane];
  }
  p.inf = inf[slot * stride + lane] != 0u;
  return p;
}

// x(R) == cand mod n, as at the end of verify_lane: infinity or Z == 0
// rejects, then X == cand0 Z^2, and X == (cand0 + n) Z^2 only when the
// host flagged r + n < p.
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

}  // namespace p256
