// SHA-256 (FIPS 180-4), for the card and for the host.
//
// The arithmetic of csrc/sha256.cu's kernel, in a header that builds
// under nvcc (__host__ __device__) and under a plain C++ compiler
// (csrc/sha256_host_check.cpp), so that tests without a GPU hold the
// kernel's own code against hashlib.  It is split along the kernel's
// two warps:
//
// - `block_words` forms the 16 big-endian words of one block of a
//   message: a full 64-byte block read by `load_block` with aligned
//   16-byte loads and put together with byte permutes, or the final
//   block or two, whose padding (0x80, zeros, the 64-bit bit length) is
//   formed in registers by `pad_block`;
// - `schedule_kw` expands the 16 words into the 64 round inputs
//   K[i] + W[i], which depend on the message alone;
// - `rounds` runs the 64 rounds on them and adds the result into the
//   state: the only dependent chain of a compression.
//
// `compress` is the textbook compression (schedule and rounds in one
// loop), kept as the reference the split is tested against; `digest`
// hashes a whole message from the split pieces, as the kernel's pair of
// warps does between them.  The loops here are unrolled, so the round
// constants and the word indices are known at compile time: constants
// become immediate or constant-bank operands and the arrays stay in
// registers.
#pragma once

#include <stdint.h>
#include <string.h>

#if defined(__CUDACC__)
#define SHA256_FN __host__ __device__ __forceinline__
#define SHA256_UNROLL _Pragma("unroll")
#else
#define SHA256_FN static inline
#define SHA256_UNROLL _Pragma("GCC unroll 64")
#endif

#define SHA256_K_VALUES                                                      \
  0x428a2f98u, 0x71374491u, 0xb5c0fbcfu, 0xe9b5dba5u, 0x3956c25bu,           \
      0x59f111f1u, 0x923f82a4u, 0xab1c5ed5u, 0xd807aa98u, 0x12835b01u,       \
      0x243185beu, 0x550c7dc3u, 0x72be5d74u, 0x80deb1feu, 0x9bdc06a7u,       \
      0xc19bf174u, 0xe49b69c1u, 0xefbe4786u, 0x0fc19dc6u, 0x240ca1ccu,       \
      0x2de92c6fu, 0x4a7484aau, 0x5cb0a9dcu, 0x76f988dau, 0x983e5152u,       \
      0xa831c66du, 0xb00327c8u, 0xbf597fc7u, 0xc6e00bf3u, 0xd5a79147u,       \
      0x06ca6351u, 0x14292967u, 0x27b70a85u, 0x2e1b2138u, 0x4d2c6dfcu,       \
      0x53380d13u, 0x650a7354u, 0x766a0abbu, 0x81c2c92eu, 0x92722c85u,       \
      0xa2bfe8a1u, 0xa81a664bu, 0xc24b8b70u, 0xc76c51a3u, 0xd192e819u,       \
      0xd6990624u, 0xf40e3585u, 0x106aa070u, 0x19a4c116u, 0x1e376c08u,       \
      0x2748774cu, 0x34b0bcb5u, 0x391c0cb3u, 0x4ed8aa4au, 0x5b9cca4fu,       \
      0x682e6ff3u, 0x748f82eeu, 0x78a5636fu, 0x84c87814u, 0x8cc70208u,       \
      0x90befffau, 0xa4506cebu, 0xbef9a3f7u, 0xc67178f2u

namespace sha256 {

// The round constants: in constant memory on the card (each read is an
// operand of the unrolled loop), a plain table on the host.
#if defined(__CUDACC__)
__constant__ uint32_t kRoundDev[64] = {SHA256_K_VALUES};
#endif
static const uint32_t kRoundHost[64] = {SHA256_K_VALUES};

SHA256_FN uint32_t round_k(int i) {
#if defined(__CUDA_ARCH__)
  return kRoundDev[i];
#else
  return kRoundHost[i];
#endif
}

SHA256_FN uint32_t rotr(uint32_t x, int n) {
#if defined(__CUDA_ARCH__)
  return __funnelshift_r(x, x, n);
#else
  return (x >> n) | (x << (32 - n));
#endif
}

// __byte_perm (PRMT): byte n of the result is byte s[4n+2:4n] of the
// eight bytes y:x (x's bytes 0-3, y's 4-7).  The host twin computes the
// same for the selectors used here (no sign-replicating nibble).
SHA256_FN uint32_t byte_perm(uint32_t x, uint32_t y, uint32_t s) {
#if defined(__CUDA_ARCH__)
  return __byte_perm(x, y, s);
#else
  const uint64_t v = ((uint64_t)y << 32) | x;
  uint32_t r = 0;
  for (int n = 0; n < 4; ++n) {
    const int k = (int)((s >> (4 * n)) & 7);
    r |= (uint32_t)((v >> (8 * k)) & 0xff) << (8 * n);
  }
  return r;
#endif
}

SHA256_FN uint32_t bswap(uint32_t x) { return byte_perm(x, 0, 0x0123); }

SHA256_FN void init(uint32_t h[8]) {
  h[0] = 0x6a09e667u;
  h[1] = 0xbb67ae85u;
  h[2] = 0x3c6ef372u;
  h[3] = 0xa54ff53au;
  h[4] = 0x510e527fu;
  h[5] = 0x9b05688cu;
  h[6] = 0x1f83d9abu;
  h[7] = 0x5be0cd19u;
}

// The 16-byte chunk at `chunk` (16-byte aligned) as four little-endian
// words.  On the card one 16-byte load through the read-only path; the
// caller loads only chunks that hold a byte of [lo, hi), and every such
// chunk lies inside the allocation that holds those bytes (CUDA's
// allocations start and end on 256-byte boundaries).  The host twin
// reads the bytes of [lo, hi) alone and puts 0xa5 in the others, so
// that the host tests catch a byte used that should have been masked.
SHA256_FN void load16(const uint8_t* chunk, const uint8_t* lo,
                      const uint8_t* hi, uint32_t out[4]) {
#if defined(__CUDA_ARCH__)
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(chunk));
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
#else
  uint8_t b[16];
  const uintptr_t c = (uintptr_t)chunk;
  for (int k = 0; k < 16; ++k) {
    const uintptr_t a = c + k;
    b[k] = (a >= (uintptr_t)lo && a < (uintptr_t)hi) ? chunk[k] : 0xa5;
  }
  memcpy(out, b, 16);  // the host is little-endian, as the card is
#endif
}

// The 16 big-endian words of the 64 bytes at p, any byte address, of
// which the first nvalid (0-64) belong to the message: bytes from nvalid
// on are unspecified (pad_block masks them).  Reads the aligned 16-byte
// chunks that hold those bytes (at most 5), moves them down by p's
// whole-word offset in two selects a word, and builds each word from two
// neighbours with one byte permute that also swaps it to big-endian.
SHA256_FN void load_block(const uint8_t* p, int nvalid, uint32_t w[16]) {
  const int m = (int)((uintptr_t)p & 15);
  const uint8_t* base = p - m;
  const uint8_t* end = p + nvalid;
  uint32_t u[20];
  SHA256_UNROLL
  for (int c = 0; c < 5; ++c) {
    if ((uintptr_t)(base + 16 * c) < (uintptr_t)end) {
      load16(base + 16 * c, p, end, &u[4 * c]);
    } else {
      u[4 * c] = u[4 * c + 1] = u[4 * c + 2] = u[4 * c + 3] = 0;
    }
  }
  const int q = m >> 2;  // whole words between the chunk and p
  SHA256_UNROLL
  for (int j = 0; j < 18; ++j) u[j] = (q & 2) ? u[j + 2] : u[j];
  SHA256_UNROLL
  for (int j = 0; j < 17; ++j) u[j] = (q & 1) ? u[j + 1] : u[j];
  const uint32_t o = (uint32_t)(m & 3);  // p's byte within its word
  const uint32_t sel = (o + 3) | ((o + 2) << 4) | ((o + 1) << 8) | (o << 12);
  SHA256_UNROLL
  for (int i = 0; i < 16; ++i) w[i] = byte_perm(u[i], u[i + 1], sel);
}

// The padding of a final block: k bytes of the message are left at its
// start (k < 64, and k < 0 for a second padding block), then 0x80 and
// zeros; the last block ends in the 64-bit bit length.
SHA256_FN void pad_block(uint32_t w[16], int k, uint64_t bits, bool last) {
  SHA256_UNROLL
  for (int i = 0; i < 16; ++i) {
    const int r = k - 4 * i;  // message bytes left at word i
    const uint32_t keep =
        r >= 4 ? 0xffffffffu : (r <= 0 ? 0u : 0xffffffffu << (32 - 8 * r));
    const uint32_t one = (r >= 0 && r < 4) ? 0x80000000u >> (8 * r) : 0u;
    w[i] = (w[i] & keep) | one;
  }
  if (last) {
    w[14] = (uint32_t)(bits >> 32);
    w[15] = (uint32_t)bits;
  }
}

// Compressions of a len-byte message, padding in.
SHA256_FN int64_t n_blocks(int64_t len) { return (len + 72) >> 6; }

// The 16 words of block b (0 <= b < n_blocks(len)) of the len bytes at
// msg: a full block, or a final one with its padding.
SHA256_FN void block_words(const uint8_t* msg, int64_t len, int64_t b,
                           uint32_t w[16]) {
  const int64_t left = len - (b << 6);  // message bytes from here on
  if (left > 0) {
    load_block(msg + (b << 6), left >= 64 ? 64 : (int)left, w);
  } else {
    SHA256_UNROLL
    for (int i = 0; i < 16; ++i) w[i] = 0;
  }
  if (left < 64) {
    pad_block(w, (int)left, (uint64_t)len << 3, b == n_blocks(len) - 1);
  }
}

SHA256_FN uint32_t small_sigma0(uint32_t x) {
  return rotr(x, 7) ^ rotr(x, 18) ^ (x >> 3);
}

SHA256_FN uint32_t small_sigma1(uint32_t x) {
  return rotr(x, 17) ^ rotr(x, 19) ^ (x >> 10);
}

// The message schedule of one block: kw[i] = K[i] + W[i] for the 64
// rounds.  w is the rolling window and is overwritten.
SHA256_FN void schedule_kw(uint32_t w[16], uint32_t kw[64]) {
  SHA256_UNROLL
  for (int i = 0; i < 16; ++i) kw[i] = w[i] + round_k(i);
  SHA256_UNROLL
  for (int i = 16; i < 64; ++i) {
    const uint32_t wi = w[i & 15] + small_sigma0(w[(i - 15) & 15]) +
                        w[(i - 7) & 15] + small_sigma1(w[(i - 2) & 15]);
    w[i & 15] = wi;
    kw[i] = wi + round_k(i);
  }
}

SHA256_FN uint32_t big_sigma0(uint32_t a) {
  return rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
}

SHA256_FN uint32_t big_sigma1(uint32_t e) {
  return rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
}

// The 64 rounds on kw, added into h: the compression's dependent chain
// and nothing else.
SHA256_FN void rounds(uint32_t h[8], const uint32_t kw[64]) {
  uint32_t a = h[0], b = h[1], c = h[2], d = h[3];
  uint32_t e = h[4], f = h[5], g = h[6], hh = h[7];
  SHA256_UNROLL
  for (int i = 0; i < 64; ++i) {
    const uint32_t t1 = hh + kw[i] + ((e & f) ^ (~e & g)) + big_sigma1(e);
    const uint32_t t2 = big_sigma0(a) + ((a & b) ^ (a & c) ^ (b & c));
    hh = g;
    g = f;
    f = e;
    e = d + t1;
    d = c;
    c = b;
    b = a;
    a = t1 + t2;
  }
  h[0] += a;
  h[1] += b;
  h[2] += c;
  h[3] += d;
  h[4] += e;
  h[5] += f;
  h[6] += g;
  h[7] += hh;
}

// One compression of the 16 big-endian words w into h, schedule and
// rounds in one loop (the textbook form).  w is overwritten.
SHA256_FN void compress(uint32_t h[8], uint32_t w[16]) {
  uint32_t a = h[0], b = h[1], c = h[2], d = h[3];
  uint32_t e = h[4], f = h[5], g = h[6], hh = h[7];
  SHA256_UNROLL
  for (int i = 0; i < 64; ++i) {
    uint32_t wi;
    if (i < 16) {
      wi = w[i];
    } else {
      wi = w[i & 15] + small_sigma0(w[(i - 15) & 15]) + w[(i - 7) & 15] +
           small_sigma1(w[(i - 2) & 15]);
      w[i & 15] = wi;
    }
    const uint32_t t1 =
        hh + big_sigma1(e) + ((e & f) ^ (~e & g)) + round_k(i) + wi;
    const uint32_t t2 = big_sigma0(a) + ((a & b) ^ (a & c) ^ (b & c));
    hh = g;
    g = f;
    f = e;
    e = d + t1;
    d = c;
    c = b;
    b = a;
    a = t1 + t2;
  }
  h[0] += a;
  h[1] += b;
  h[2] += c;
  h[3] += d;
  h[4] += e;
  h[5] += f;
  h[6] += g;
  h[7] += hh;
}

// The digest h as 32 big-endian bytes at out (16-byte aligned on the
// card: two 16-byte stores).
SHA256_FN void put_digest(const uint32_t h[8], uint8_t* out) {
#if defined(__CUDA_ARCH__)
  uint4* o = reinterpret_cast<uint4*>(out);
  o[0] = make_uint4(bswap(h[0]), bswap(h[1]), bswap(h[2]), bswap(h[3]));
  o[1] = make_uint4(bswap(h[4]), bswap(h[5]), bswap(h[6]), bswap(h[7]));
#else
  for (int i = 0; i < 8; ++i) {
    out[4 * i] = (uint8_t)(h[i] >> 24);
    out[4 * i + 1] = (uint8_t)(h[i] >> 16);
    out[4 * i + 2] = (uint8_t)(h[i] >> 8);
    out[4 * i + 3] = (uint8_t)h[i];
  }
#endif
}

// The digest of the len bytes at msg into out, one block after another.
SHA256_FN void digest(const uint8_t* __restrict__ msg, int64_t len,
                      uint8_t* __restrict__ out) {
  uint32_t h[8];
  init(h);
  const int64_t nb = n_blocks(len);
  for (int64_t b = 0; b < nb; ++b) {
    uint32_t w[16], kw[64];
    block_words(msg, len, b, w);
    schedule_kw(w, kw);
    rounds(h, kw);
  }
  put_digest(h, out);
}

}  // namespace sha256
