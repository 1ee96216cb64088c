// The arithmetic and lane pieces of p256_verify.cu, compiled for the host
// with a plain C++ compiler, so that tests on a machine without a GPU can
// hold the kernel's code against the plain PyTorch version:
//
//   g++ -O2 -std=c++17 -shared -fPIC -o libp256host.so p256_host_check.cpp
//
// The entry points take the kernels' arguments (without the stream) and
// loop over the lanes; the key-table one runs a lane's 8 parts one
// after another into a local partial buffer, then its reduction, as the
// kernel's warps do in shared memory.
#include <stdint.h>

#include "p256_split.cuh"
#include "p256_verify.cuh"

extern "C" void p256_host_keytab(const uint32_t* qtab, const uint32_t* keybad,
                                 const uint32_t* kidx, const uint32_t* d1,
                                 const uint32_t* d2, const uint32_t* cand0,
                                 const uint32_t* flags, const uint32_t* gqtab,
                                 uint8_t* out, int n) {
  uint32_t w[p256::kParts * p256::kPartialWords];
  uint32_t inf[p256::kParts];
  for (int lane = 0; lane < n; ++lane) {
    out[lane] = 0;
    if (!p256::keytab_lane_ok(kidx, keybad, flags, n, lane)) continue;
    for (int part = 0; part < p256::kParts; ++part) {
      p256::store_partial(
          w, inf, 1, part, 0,
          p256::keytab_part(qtab, kidx, d1, d2, gqtab, part, n, lane));
    }
    out[lane] = p256::reduce_and_check(w, inf, 1, 0,
                                       p256::fe_load(cand0, n, lane),
                                       flags[lane] != 0u);
  }
}

// The 8 partials of each lane that passes the guard, as the kernel
// stores them: w is (n, 8, 24) words (X, Y, Z), inf (n, 8); a rejected
// lane's are left as they were.
extern "C" void p256_host_partials(const uint32_t* qtab, const uint32_t* keybad,
                                  const uint32_t* kidx, const uint32_t* d1,
                                  const uint32_t* d2, const uint32_t* flags,
                                  const uint32_t* gqtab, uint32_t* w,
                                  uint32_t* inf, int n) {
  for (int lane = 0; lane < n; ++lane) {
    if (!p256::keytab_lane_ok(kidx, keybad, flags, n, lane)) continue;
    for (int part = 0; part < p256::kParts; ++part) {
      p256::store_partial(
          w + lane * p256::kParts * p256::kPartialWords,
          inf + lane * p256::kParts, 1, part, 0,
          p256::keytab_part(qtab, kidx, d1, d2, gqtab, part, n, lane));
    }
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
