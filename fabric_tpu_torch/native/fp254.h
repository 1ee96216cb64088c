// Shared BN254 base-field layer (the port's copy of
// fabric_tpu/native/fp254.h): Montgomery Fp arithmetic over
// p = 21888242871839275222246405745257275088696311157297823662689037894645226208583
// (alt-bn128).  Single source of truth for the curve constants and the
// reduction code — included by bn254.cc (G1 scalar ops) and pairing.cc
// (tower/pairing); everything is `inline` so both TUs share one
// definition set with no ODR risk.

#ifndef FABRIC_TPU_TORCH_NATIVE_FP254_H_
#define FABRIC_TPU_TORCH_NATIVE_FP254_H_

#include <cstdint>
#include <cstring>

namespace fp254 {

typedef uint8_t u8;
typedef uint64_t u64;
typedef unsigned __int128 u128;

// little-endian 64-bit limbs
inline const u64 PRIME[4] = {0x3c208c16d87cfd47ULL, 0x97816a916871ca8dULL,
                             0xb85045b68181585dULL, 0x30644e72e131a029ULL};
inline const u64 N0INV = 0x87d20782e4866389ULL;  // -P^-1 mod 2^64
inline const u64 R2[4] = {0xf32cfc5b538afa89ULL, 0xb5e71911d44501fbULL,
                          0x47ab1eff0a417ff6ULL, 0x06d89f71cab8351fULL};
inline const u64 ONE_M[4] = {0xd35d438dc58f0d9dULL, 0x0a78eb28f5c70b3dULL,
                             0x666ea36f7879462cULL, 0x0e0a77c19a07df2fULL};

struct Fp {
  u64 v[4];
};

inline bool fp_is_zero(const Fp& a) {
  return (a.v[0] | a.v[1] | a.v[2] | a.v[3]) == 0;
}

inline int cmp_p(const u64* a) {
  for (int i = 3; i >= 0; --i)
    if (a[i] != PRIME[i]) return a[i] < PRIME[i] ? -1 : 1;
  return 0;
}

inline void sub_p(u64* a) {  // a -= P (caller ensures a >= P)
  u128 borrow = 0;
  for (int i = 0; i < 4; ++i) {
    u128 d = (u128)a[i] - PRIME[i] - (u64)borrow;
    a[i] = (u64)d;
    borrow = (d >> 64) ? 1 : 0;
  }
}

inline void fp_add(const Fp& a, const Fp& b, Fp* out) {
  u128 carry = 0;
  u64 t[4];
  for (int i = 0; i < 4; ++i) {
    u128 s = (u128)a.v[i] + b.v[i] + (u64)carry;
    t[i] = (u64)s;
    carry = s >> 64;
  }
  if (carry || cmp_p(t) >= 0) sub_p(t);
  memcpy(out->v, t, sizeof(t));
}

inline void fp_sub(const Fp& a, const Fp& b, Fp* out) {
  u128 borrow = 0;
  u64 t[4];
  for (int i = 0; i < 4; ++i) {
    u128 d = (u128)a.v[i] - b.v[i] - (u64)borrow;
    t[i] = (u64)d;
    borrow = (d >> 64) ? 1 : 0;
  }
  if (borrow) {  // += P
    u128 carry = 0;
    for (int i = 0; i < 4; ++i) {
      u128 s = (u128)t[i] + PRIME[i] + (u64)carry;
      t[i] = (u64)s;
      carry = s >> 64;
    }
  }
  memcpy(out->v, t, sizeof(t));
}

inline void fp_neg(const Fp& a, Fp* out) {
  Fp z = {{0, 0, 0, 0}};
  fp_sub(z, a, out);
}

inline void fp_dbl(const Fp& a, Fp* out) { fp_add(a, a, out); }

// Montgomery CIOS multiplication: out = a*b*R^-1 mod P.
inline void fp_mul(const Fp& a, const Fp& b, Fp* out) {
  u64 t[5] = {0, 0, 0, 0, 0};
  for (int i = 0; i < 4; ++i) {
    u128 carry = 0;
    for (int j = 0; j < 4; ++j) {
      u128 s = (u128)a.v[i] * b.v[j] + t[j] + (u64)carry;
      t[j] = (u64)s;
      carry = s >> 64;
    }
    u64 t4 = t[4] + (u64)carry;
    u64 m = t[0] * N0INV;
    carry = ((u128)m * PRIME[0] + t[0]) >> 64;
    for (int j = 1; j < 4; ++j) {
      u128 s = (u128)m * PRIME[j] + t[j] + (u64)carry;
      t[j - 1] = (u64)s;
      carry = s >> 64;
    }
    u128 s = (u128)t4 + (u64)carry;
    t[3] = (u64)s;
    t[4] = (u64)(s >> 64);
  }
  if (t[4] || cmp_p(t) >= 0) sub_p(t);
  memcpy(out->v, t, 4 * sizeof(u64));
}

inline void fp_sqr(const Fp& a, Fp* out) { fp_mul(a, a, out); }

// Montgomery inversion via Fermat: a^(P-2) (P odd and > 2: no borrow).
inline void fp_inv(const Fp& a, Fp* out) {
  u64 e[4];
  memcpy(e, PRIME, sizeof(e));
  e[0] -= 2;
  Fp result;
  bool started = false;
  for (int limb = 3; limb >= 0; --limb)
    for (int bit = 63; bit >= 0; --bit) {
      if (started) fp_sqr(result, &result);
      if ((e[limb] >> bit) & 1) {
        if (!started) {
          result = a;
          started = true;
        } else {
          fp_mul(result, a, &result);
        }
      }
    }
  *out = result;
}

inline void to_mont(const Fp& a, Fp* out) {
  Fp r2;
  memcpy(r2.v, R2, sizeof(R2));
  fp_mul(a, r2, out);
}

inline void from_mont(const Fp& a, Fp* out) {
  Fp one = {{1, 0, 0, 0}};
  fp_mul(a, one, out);
}

inline void load_fp_be(const u8* be, Fp* out) {
  for (int i = 0; i < 4; ++i) {
    u64 v = 0;
    for (int j = 0; j < 8; ++j) v = (v << 8) | be[(3 - i) * 8 + j];
    out->v[i] = v;
  }
}

inline void store_fp_be(const Fp& a, u8* be) {
  for (int i = 0; i < 4; ++i) {
    u64 v = a.v[3 - i];
    for (int j = 0; j < 8; ++j) be[i * 8 + j] = (u8)(v >> (56 - 8 * j));
  }
}

}  // namespace fp254

#endif  // FABRIC_TPU_TORCH_NATIVE_FP254_H_
