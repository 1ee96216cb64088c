// The arithmetic and lane body of p256_verify.cu, compiled for the host
// with a plain C++ compiler, so that tests on a machine without a GPU can
// hold the kernel's code against the plain PyTorch version:
//
//   g++ -O2 -std=c++17 -shared -fPIC -o libp256host.so p256_host_check.cpp
//
// The entry points take the kernels' arguments (without the stream) and
// loop over the lanes.
#include <stdint.h>

#include "p256_verify.cuh"

extern "C" void p256_host_keytab(const uint32_t* ktabx, const uint32_t* ktaby,
                                 const uint32_t* kidx, const uint32_t* d1,
                                 const uint32_t* d2, const uint32_t* cand0,
                                 const uint32_t* flags, const uint32_t* gtab,
                                 uint8_t* out, int n) {
  for (int lane = 0; lane < n; ++lane) {
    out[lane] = p256::verify_keytab(ktabx, ktaby, kidx, d1, d2, cand0, flags,
                                    gtab, n, lane);
  }
}

extern "C" void p256_host_lanekeys(const uint32_t* qx, const uint32_t* qy,
                                   const uint32_t* d1, const uint32_t* d2,
                                   const uint32_t* cand0,
                                   const uint32_t* flags,
                                   const uint32_t* gtab, uint8_t* out, int n) {
  for (int lane = 0; lane < n; ++lane) {
    out[lane] = p256::verify_lanekeys(qx, qy, d1, d2, cand0, flags, gtab, n,
                                      lane);
  }
}

// Field operation op (0 add, 1 sub, 2 mul) on n pairs of 8-word operands,
// each reduced mod p on load as the kernel does: r[k] = a[k] op b[k].
extern "C" void p256_host_field(int op, const uint32_t* a, const uint32_t* b,
                                uint32_t* r, int n) {
  for (int k = 0; k < n; ++k) {
    const p256::Fe x = p256::fe_load(a + 8 * k, 1, 0);
    const p256::Fe y = p256::fe_load(b + 8 * k, 1, 0);
    p256::Fe z;
    if (op == 0) {
      p256::fe_add(z, x, y);
    } else if (op == 1) {
      p256::fe_sub(z, x, y);
    } else {
      p256::fe_mul(z, x, y);
    }
    for (int i = 0; i < 8; ++i) r[8 * k + i] = z.w[i];
  }
}
