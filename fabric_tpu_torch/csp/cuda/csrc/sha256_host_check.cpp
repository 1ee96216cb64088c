// The SHA-256 of csrc/sha256.cu, compiled for the host with a plain C++
// compiler, so that tests on a machine without a GPU can hold the
// kernel's own code against hashlib:
//
//   g++ -O2 -std=c++17 -shared -fPIC -o libsha256host.so sha256_host_check.cpp
//
// The entry points take the kernel's arguments (without the stream) and
// run one message after another, as the kernel's lanes do side by side,
// or expose one piece of the split arithmetic: the block loader, and the
// compression as the textbook loop and as schedule_kw then rounds.
#include <stdint.h>

#include "sha256.cuh"

extern "C" void sha256_host_digests(const uint8_t* buf, const int64_t* offs,
                                    int n, uint8_t* out) {
  for (int i = 0; i < n; ++i) {
    sha256::digest(buf + offs[i], offs[i + 1] - offs[i],
                   out + 32 * (int64_t)i);
  }
}

// The words of the 64 bytes at p, of which nvalid are the message's.
extern "C" void sha256_host_load_block(const uint8_t* p, int nvalid,
                                       uint32_t* w) {
  sha256::load_block(p, nvalid, w);
}

// One compression of w into h: split (schedule_kw, then rounds) when
// `split` is non-zero, else the textbook loop.
extern "C" void sha256_host_compress(uint32_t* h, const uint32_t* w,
                                     int split) {
  uint32_t win[16];
  for (int i = 0; i < 16; ++i) win[i] = w[i];
  if (split) {
    uint32_t kw[64];
    sha256::schedule_kw(win, kw);
    sha256::rounds(h, kw);
  } else {
    sha256::compress(h, win);
  }
}
