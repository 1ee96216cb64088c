// SHA-256 of one message (FIPS 180-4), for the card and for the host.
//
// The compression and the message walk of csrc/sha256.cu's kernel, in a
// header that builds under nvcc (__host__ __device__) and under a plain
// C++ compiler (csrc/sha256_host_check.cpp), so that tests without a GPU
// hold the kernel's own code against hashlib.
//
// A message is read straight from a byte buffer: its full 64-byte blocks
// as big-endian words, then one final block, or two when fewer than 9
// bytes are left for the 0x80 byte and the 64-bit bit length, formed in
// registers.  The 64 rounds are unrolled, so the round constants and the
// rolling 16-word schedule window index at compile time: the constants
// become constant-bank operands and the window stays in registers.
#pragma once

#include <stdint.h>

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
// operand of the unrolled round), a plain table on the host.
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

// One compression of the 16 big-endian words w into h.  w is the
// schedule window and is overwritten.
SHA256_FN void compress(uint32_t h[8], uint32_t w[16]) {
  uint32_t a = h[0], b = h[1], c = h[2], d = h[3];
  uint32_t e = h[4], f = h[5], g = h[6], hh = h[7];
  SHA256_UNROLL
  for (int i = 0; i < 64; ++i) {
    uint32_t wi;
    if (i < 16) {
      wi = w[i];
    } else {
      const uint32_t w15 = w[(i - 15) & 15], w2 = w[(i - 2) & 15];
      const uint32_t s0 = rotr(w15, 7) ^ rotr(w15, 18) ^ (w15 >> 3);
      const uint32_t s1 = rotr(w2, 17) ^ rotr(w2, 19) ^ (w2 >> 10);
      wi = w[i & 15] + s0 + w[(i - 7) & 15] + s1;
      w[i & 15] = wi;
    }
    const uint32_t t1 = hh + (rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25)) +
                        ((e & f) ^ (~e & g)) + round_k(i) + wi;
    const uint32_t t2 = (rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22)) +
                        ((a & b) ^ (a & c) ^ (b & c));
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

// The digest of the len bytes at msg, as 32 big-endian bytes into out.
SHA256_FN void digest(const uint8_t* __restrict__ msg, int64_t len,
                      uint8_t* __restrict__ out) {
  uint32_t h[8];
  init(h);
  uint32_t w[16];
  const int64_t full = len >> 6;
  for (int64_t blk = 0; blk < full; ++blk) {
    const uint8_t* p = msg + (blk << 6);
    SHA256_UNROLL
    for (int i = 0; i < 16; ++i) {
      w[i] = ((uint32_t)p[4 * i] << 24) | ((uint32_t)p[4 * i + 1] << 16) |
             ((uint32_t)p[4 * i + 2] << 8) | (uint32_t)p[4 * i + 3];
    }
    compress(h, w);
  }
  // the tail: rem bytes, then 0x80, zeros, and the bit length in the last
  // 8 bytes of the last block
  const int rem = (int)(len - (full << 6));
  const uint8_t* tail = msg + (full << 6);
  const uint64_t bits = (uint64_t)len << 3;
  const int last = rem < 56 ? 0 : 1;
  for (int f = 0; f <= last; ++f) {
    SHA256_UNROLL
    for (int i = 0; i < 16; ++i) {
      uint32_t word = 0;
      SHA256_UNROLL
      for (int k = 0; k < 4; ++k) {
        const int pos = 64 * f + 4 * i + k;  // byte of the tail region
        uint32_t byte = 0;
        if (pos < rem) {
          byte = tail[pos];
        } else if (pos == rem) {
          byte = 0x80;
        } else if (f == last && 4 * i + k >= 56) {
          byte = (uint32_t)(bits >> (8 * (63 - 4 * i - k))) & 0xff;
        }
        word = (word << 8) | byte;
      }
      w[i] = word;
    }
    compress(h, w);
  }
  SHA256_UNROLL
  for (int i = 0; i < 8; ++i) {
    out[4 * i] = (uint8_t)(h[i] >> 24);
    out[4 * i + 1] = (uint8_t)(h[i] >> 16);
    out[4 * i + 2] = (uint8_t)(h[i] >> 8);
    out[4 * i + 3] = (uint8_t)h[i];
  }
}

}  // namespace sha256
