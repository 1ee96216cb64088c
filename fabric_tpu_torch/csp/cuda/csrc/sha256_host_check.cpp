// The SHA-256 of csrc/sha256.cu, compiled for the host with a plain C++
// compiler, so that tests on a machine without a GPU can hold the
// kernel's own code against hashlib:
//
//   g++ -O2 -std=c++17 -shared -fPIC -o libsha256host.so sha256_host_check.cpp
//
// The entry point takes the kernel's arguments (without the stream) and
// runs one message after another, as the kernel's threads do side by side.
#include <stdint.h>

#include "sha256.cuh"

extern "C" void sha256_host_digests(const uint8_t* buf, const int64_t* offs,
                                    int n, uint8_t* out) {
  for (int i = 0; i < n; ++i) {
    sha256::digest(buf + offs[i], offs[i + 1] - offs[i],
                   out + 32 * (int64_t)i);
  }
}
