// Batch signature marshaller for the P-256 verify kernels (the port's
// copy of fabric_tpu/native/marshal.cc).
//
// One pass over a flush's signatures doing DER parsing, range/low-S
// prechecks (reference bccsp/sw/ecdsa.go:41-57, bccsp/utils/ecdsa.go:47-95),
// u1/u2 scalar math with a single Montgomery batch inversion, and the
// packed-array layout the kernels consume (32-bit words + 8-digits-per-word
// window nibbles).
//
// Built at first use by fabric_tpu_torch/native/__init__.py (g++, with
// bn254.cc and pairing.cc into one library, loaded via ctypes); its plain
// version is fabric_tpu_torch/csp/cuda/p256_kernel.py `prepare_packed`.

#include <cstdint>
#include <cstring>

typedef unsigned __int128 u128;
typedef uint64_t u64;
typedef uint32_t u32;
typedef uint8_t u8;

namespace {

struct U256 {
  u64 v[4];  // little-endian 64-bit limbs
};

// P-256 group order n and field prime p.
const U256 N = {{0xF3B9CAC2FC632551ULL, 0xBCE6FAADA7179E84ULL,
                 0xFFFFFFFFFFFFFFFFULL, 0xFFFFFFFF00000000ULL}};
const U256 P = {{0xFFFFFFFFFFFFFFFFULL, 0x00000000FFFFFFFFULL,
                 0x0000000000000000ULL, 0xFFFFFFFF00000001ULL}};
// n/2 (low-S bound: s <= HALF_N)
const U256 HALF_N = {{0x79DCE5617E3192A8ULL, 0xDE737D56D38BCF42ULL,
                      0x7FFFFFFFFFFFFFFFULL, 0x7FFFFFFF80000000ULL}};
// -n^{-1} mod 2^64 (Montgomery factor)
const u64 N_PRIME = 0xCCD1C8AAEE00BC4FULL;
// 2^512 mod n (to enter the Montgomery domain)
const U256 RR_N = {{0x83244C95BE79EEA2ULL, 0x4699799C49BD6FA6ULL,
                    0x2845B2392B6BEC59ULL, 0x66E12D94F3D95620ULL}};

inline int cmp(const U256& a, const U256& b) {
  for (int i = 3; i >= 0; --i) {
    if (a.v[i] < b.v[i]) return -1;
    if (a.v[i] > b.v[i]) return 1;
  }
  return 0;
}

inline bool is_zero(const U256& a) {
  return (a.v[0] | a.v[1] | a.v[2] | a.v[3]) == 0;
}

inline u64 sub_borrow(const U256& a, const U256& b, U256* out) {
  u64 borrow = 0;
  for (int i = 0; i < 4; ++i) {
    u128 d = (u128)a.v[i] - b.v[i] - borrow;
    out->v[i] = (u64)d;
    borrow = (d >> 64) ? 1 : 0;
  }
  return borrow;
}

inline u64 add_carry(const U256& a, const U256& b, U256* out) {
  u64 carry = 0;
  for (int i = 0; i < 4; ++i) {
    u128 s = (u128)a.v[i] + b.v[i] + carry;
    out->v[i] = (u64)s;
    carry = (u64)(s >> 64);
  }
  return carry;
}

// Montgomery multiplication mod n: returns a*b*2^-256 mod n (CIOS).
U256 mont_mul(const U256& a, const U256& b) {
  u64 t[6] = {0, 0, 0, 0, 0, 0};
  for (int i = 0; i < 4; ++i) {
    u64 carry = 0;
    for (int j = 0; j < 4; ++j) {
      u128 s = (u128)a.v[i] * b.v[j] + t[j] + carry;
      t[j] = (u64)s;
      carry = (u64)(s >> 64);
    }
    u128 s = (u128)t[4] + carry;
    t[4] = (u64)s;
    t[5] = (u64)(s >> 64);

    u64 m = t[0] * N_PRIME;
    carry = 0;
    for (int j = 0; j < 4; ++j) {
      u128 s2 = (u128)m * N.v[j] + t[j] + carry;
      t[j] = (u64)s2;
      carry = (u64)(s2 >> 64);
    }
    s = (u128)t[4] + carry;
    t[4] = (u64)s;
    t[5] += (u64)(s >> 64);
    // shift right one 64-bit word
    t[0] = t[1]; t[1] = t[2]; t[2] = t[3]; t[3] = t[4]; t[4] = t[5];
    t[5] = 0;
  }
  U256 r = {{t[0], t[1], t[2], t[3]}};
  if (t[4] || cmp(r, N) >= 0) {
    U256 tmp;
    sub_borrow(r, N, &tmp);
    r = tmp;
  }
  return r;
}

inline U256 to_mont(const U256& a) { return mont_mul(a, RR_N); }
inline U256 from_mont(const U256& a) {
  U256 one = {{1, 0, 0, 0}};
  return mont_mul(a, one);
}

// Modular inverse mod n via binary extended GCD (HAC Alg 14.61;
// plain domain; n odd and gcd(in, n) == 1 — s values are in (0, n)).
U256 inv_mod_n(const U256& in) {
  const U256 one = {{1, 0, 0, 0}};
  U256 u = in, w = N;
  U256 x1 = one, x2 = {{0, 0, 0, 0}};
  auto halve = [](U256* a) {
    U256 t = *a;
    u64 carry = 0;
    if (t.v[0] & 1) carry = add_carry(t, N, &t);
    for (int i = 0; i < 4; ++i) {
      u64 next = (i < 3) ? t.v[i + 1] : carry;
      t.v[i] = (t.v[i] >> 1) | (next << 63);
    }
    *a = t;
  };
  auto shr1 = [](U256* a) {
    for (int i = 0; i < 4; ++i) {
      u64 next = (i < 3) ? a->v[i + 1] : 0;
      a->v[i] = (a->v[i] >> 1) | (next << 63);
    }
  };
  while (cmp(u, one) != 0 && cmp(w, one) != 0) {
    while (!(u.v[0] & 1)) {
      shr1(&u);
      halve(&x1);
    }
    while (!(w.v[0] & 1)) {
      shr1(&w);
      halve(&x2);
    }
    if (cmp(u, w) >= 0) {
      sub_borrow(u, w, &u);
      if (sub_borrow(x1, x2, &x1)) add_carry(x1, N, &x1);
    } else {
      sub_borrow(w, u, &w);
      if (sub_borrow(x2, x1, &x2)) add_carry(x2, N, &x2);
    }
  }
  return cmp(u, one) == 0 ? x1 : x2;
}

U256 from_be(const u8* b) {  // 32 bytes big-endian
  U256 r;
  for (int i = 0; i < 4; ++i) {
    u64 w = 0;
    for (int j = 0; j < 8; ++j) w = (w << 8) | b[(3 - i) * 8 + j];
    r.v[i] = w;
  }
  return r;
}

// Strict-enough DER: SEQUENCE { INTEGER r, INTEGER s }.  Returns false on
// malformed input; *big is set when an INTEGER exceeds 256 bits (the
// caller then fails the range precheck, matching the Python path's
// "parse ok, range check fails" verdict for oversized values).
bool parse_der(const u8* sig, int len, U256* r, U256* s, bool* r_big,
               bool* s_big) {
  int pos = 0;
  auto read_len = [&](int* out) -> bool {
    if (pos >= len) return false;
    u8 b = sig[pos++];
    if (b < 0x80) {
      *out = b;
      return true;
    }
    int nb = b & 0x7F;
    if (nb == 0 || nb > 2 || pos + nb > len) return false;
    int v = 0;
    for (int i = 0; i < nb; ++i) v = (v << 8) | sig[pos++];
    if (v < 0x80) return false;  // non-minimal long form
    *out = v;
    return true;
  };
  auto read_int = [&](U256* out, bool* big) -> bool {
    if (pos >= len || sig[pos] != 0x02) return false;
    ++pos;
    int l;
    if (!read_len(&l) || l < 1 || pos + l > len) return false;
    const u8* b = sig + pos;
    if (b[0] & 0x80) return false;               // negative
    if (l > 1 && b[0] == 0 && !(b[1] & 0x80)) return false;  // non-minimal
    pos += l;
    int skip = (l > 0 && b[0] == 0) ? 1 : 0;
    int nbytes = l - skip;
    *big = nbytes > 32;
    u8 be[32];
    memset(be, 0, 32);
    if (!*big) memcpy(be + 32 - nbytes, b + skip, nbytes);
    *out = from_be(be);
    return true;
  };
  if (len < 2 || sig[0] != 0x30) return false;
  ++pos;
  int seq_len;
  if (!read_len(&seq_len) || pos + seq_len != len) return false;
  if (!read_int(r, r_big)) return false;
  if (!read_int(s, s_big)) return false;
  return pos == len;
}

void put_words(const U256& a, u32* dst, int n_items, int i) {
  // dst is (8, n_items) row-major; column i gets the 8 LE 32-bit words
  for (int w = 0; w < 8; ++w) {
    dst[w * n_items + i] = (u32)(a.v[w / 2] >> (32 * (w % 2)));
  }
}

void put_digits(const U256& a, u32* dst, int n_items, int i) {
  // 64 4-bit window digits, MSB first; digit k packed into word k/8 at
  // bit 4*(k%8).  Digit k = bits [4*(63-k), 4*(63-k)+4) of a.
  for (int w = 0; w < 8; ++w) {
    u32 word = 0;
    for (int j = 0; j < 8; ++j) {
      int k = 8 * w + j;
      int bit = 4 * (63 - k);
      u32 nib = (u32)((a.v[bit / 64] >> (bit % 64)) & 0xF);
      word |= nib << (4 * j);
    }
    dst[w * n_items + i] = word;
  }
}

}  // namespace

extern "C" {

// All output arrays are (8, n) row-major u32 except c1ok/valid ((n,) u8).
// xs/ys/digests: n*32 bytes big-endian.  sigs: concatenated DER with
// sig_off (n+1 int32 offsets).  (r+n words are NOT emitted: the device
// kernel rebuilds cand1 from c0; only the c1ok admissibility flag is.)
int fabric_marshal_batch(int n, const u8* xs, const u8* ys,
                         const u8* digests, const u8* sigs,
                         const int32_t* sig_off, u32* qx, u32* qy, u32* d1,
                         u32* d2, u32* c0, u8* c1ok, u8* valid) {
  if (n <= 0) return 0;
  U256* svals = new U256[n];
  U256* rvals = new U256[n];
  U256* prefix = new U256[n + 1];
  const U256 one = {{1, 0, 0, 0}};
  const U256 gen_x = from_be((const u8*)
      "\x6B\x17\xD1\xF2\xE1\x2C\x42\x47\xF8\xBC\xE6\xE5\x63\xA4\x40\xF2"
      "\x77\x03\x7D\x81\x2D\xEB\x33\xA0\xF4\xA1\x39\x45\xD8\x98\xC2\x96");
  const U256 gen_y = from_be((const u8*)
      "\x4F\xE3\x42\xE2\xFE\x1A\x7F\x9B\x8E\xE7\xEB\x4A\x7C\x0F\x9E\x16"
      "\x2B\xCE\x33\x57\x6B\x31\x5E\xCE\xCB\xB6\x40\x68\x37\xBF\x51\xF5");

  for (int i = 0; i < n; ++i) {
    U256 r, s;
    bool r_big = false, s_big = false;
    bool ok = parse_der(sigs + sig_off[i], sig_off[i + 1] - sig_off[i], &r,
                        &s, &r_big, &s_big);
    if (ok) {
      // prechecks: 0 < r < n, 0 < s <= n/2 (low-S), as the reference
      ok = !r_big && !s_big && !is_zero(r) && cmp(r, N) < 0 &&
           !is_zero(s) && cmp(s, HALF_N) <= 0;
    }
    valid[i] = ok ? 1 : 0;
    svals[i] = ok ? s : one;
    rvals[i] = ok ? r : one;
  }

  // Montgomery batch inversion of all s values
  prefix[0] = to_mont(one);
  for (int i = 0; i < n; ++i) {
    prefix[i + 1] = mont_mul(prefix[i], to_mont(svals[i]));
  }
  U256 inv = to_mont(inv_mod_n(from_mont(prefix[n])));

  for (int i = n - 1; i >= 0; --i) {
    U256 w_mont = mont_mul(inv, prefix[i]);  // s_i^{-1} (Montgomery)
    inv = mont_mul(inv, to_mont(svals[i]));
    if (!valid[i]) {
      put_words(gen_x, qx, n, i);
      put_words(gen_y, qy, n, i);
      put_digits(one, d1, n, i);
      put_digits(one, d2, n, i);
      put_words(one, c0, n, i);
      c1ok[i] = 0;
      continue;
    }
    // e = digest mod n (digest < 2^256 < 2n: one conditional subtract)
    U256 e = from_be(digests + 32 * i);
    if (cmp(e, N) >= 0) sub_borrow(e, N, &e);
    U256 u1 = from_mont(mont_mul(to_mont(e), w_mont));
    U256 u2 = from_mont(mont_mul(to_mont(rvals[i]), w_mont));
    put_digits(u1, d1, n, i);
    put_digits(u2, d2, n, i);
    put_words(from_be(xs + 32 * i), qx, n, i);
    put_words(from_be(ys + 32 * i), qy, n, i);
    put_words(rvals[i], c0, n, i);
    U256 rpn;
    u64 carry = add_carry(rvals[i], N, &rpn);
    c1ok[i] = (!carry && cmp(rpn, P) < 0) ? 1 : 0;
  }

  delete[] svals;
  delete[] rvals;
  delete[] prefix;
  return 0;
}

}  // extern "C"
