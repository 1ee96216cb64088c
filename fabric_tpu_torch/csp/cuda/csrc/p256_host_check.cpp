// The arithmetic and lane pieces of p256_verify.cu, compiled for the host
// with a plain C++ compiler, so that tests on a machine without a GPU can
// hold the kernels' code against the plain PyTorch version:
//
//   g++ -O2 -std=c++17 -shared -fPIC -o libp256host.so p256_host_check.cpp
//
// The entry points take the kernels' arguments (without the stream) and
// loop over the lanes: a lane that passes its guard runs its 8 parts one
// after another into a local partial buffer, then the reduction, as the
// kernels' warps do in shared memory.  A per-lane-key lane's part 4
// builds its table of Q into a local buffer first, as the kernel's part 4
// does into shared memory for parts 4-7.
#include <stdint.h>

#include "p256_split.cuh"
#include "p256_verify.cuh"

namespace {

using p256::kParts;
using p256::kPartialWords;

// The 8 partials of a lane, part(p, lane) for p = 0..7, into w (8, 24)
// words and inf (8,).
template <class Part>
void lane_partials(Part& part, int lane, uint32_t* w, uint32_t* inf) {
  for (int p = 0; p < kParts; ++p) {
    p256::store_partial(w, inf, 1, p, 0, part(p, lane));
  }
}

// Each lane's verdict: 0 when `ok` rejects it, else its partials' sum
// checked against cand0.
template <class Ok, class Part>
void verdicts(Ok ok, Part part, const uint32_t* cand0, const uint32_t* flags,
              uint8_t* out, int n) {
  uint32_t w[kParts * kPartialWords];
  uint32_t inf[kParts];
  for (int lane = 0; lane < n; ++lane) {
    out[lane] = 0;
    if (!ok(lane)) continue;
    lane_partials(part, lane, w, inf);
    out[lane] = p256::reduce_and_check(w, inf, 1, 0,
                                       p256::fe_load(cand0, n, lane),
                                       flags[lane] != 0u);
  }
}

// The 8 partials of each lane that passes `ok`, as the kernels store
// them: w is (n, 8, 24) words (X, Y, Z), inf (n, 8); a rejected lane's
// are left as they were.
template <class Ok, class Part>
void partials(Ok ok, Part part, uint32_t* w, uint32_t* inf, int n) {
  for (int lane = 0; lane < n; ++lane) {
    if (!ok(lane)) continue;
    lane_partials(part, lane, w + lane * kParts * kPartialWords,
                  inf + lane * kParts);
  }
}

// Part p of per-lane-key lane `lane`, in part order: part 4 first builds
// the lane's table of Q into `t`, which parts 4..7 then read.
struct LanekeysPart {
  const uint32_t *qx, *qy, *d1, *d2, *gqtab;
  int n;
  uint32_t t[p256::kQTableWords];

  p256::Jac operator()(int p, int lane) {
    if (p == p256::kQuarters) {
      p256::build_q_table(t, 1, 0, p256::fe_load(qx, n, lane),
                          p256::fe_load(qy, n, lane));
    }
    return p256::lanekeys_part(t, 1, 0, d1, d2, gqtab, p, n, lane);
  }
};

}  // namespace

extern "C" void p256_host_keytab(const uint32_t* qtab, const uint32_t* keybad,
                                 const uint32_t* kidx, const uint32_t* d1,
                                 const uint32_t* d2, const uint32_t* cand0,
                                 const uint32_t* flags, const uint32_t* gqtab,
                                 uint8_t* out, int n) {
  verdicts([&](int lane) {
             return p256::keytab_lane_ok(kidx, keybad, flags, n, lane);
           },
           [&](int p, int lane) {
             return p256::keytab_part(qtab, kidx, d1, d2, gqtab, p, n, lane);
           },
           cand0, flags, out, n);
}

extern "C" void p256_host_partials(const uint32_t* qtab, const uint32_t* keybad,
                                  const uint32_t* kidx, const uint32_t* d1,
                                  const uint32_t* d2, const uint32_t* flags,
                                  const uint32_t* gqtab, uint32_t* w,
                                  uint32_t* inf, int n) {
  partials([&](int lane) {
             return p256::keytab_lane_ok(kidx, keybad, flags, n, lane);
           },
           [&](int p, int lane) {
             return p256::keytab_part(qtab, kidx, d1, d2, gqtab, p, n, lane);
           },
           w, inf, n);
}

extern "C" void p256_host_lanekeys(const uint32_t* qx, const uint32_t* qy,
                                   const uint32_t* d1, const uint32_t* d2,
                                   const uint32_t* cand0,
                                   const uint32_t* flags,
                                   const uint32_t* gqtab, uint8_t* out,
                                   int n) {
  verdicts([&](int lane) {
             return p256::lanekeys_lane_ok(qx, qy, flags, n, lane);
           },
           LanekeysPart{qx, qy, d1, d2, gqtab, n, {}},
           cand0, flags, out, n);
}

extern "C" void p256_host_lanekeys_partials(
    const uint32_t* qx, const uint32_t* qy, const uint32_t* d1,
    const uint32_t* d2, const uint32_t* flags, const uint32_t* gqtab,
    uint32_t* w, uint32_t* inf, int n) {
  partials([&](int lane) {
             return p256::lanekeys_lane_ok(qx, qy, flags, n, lane);
           },
           LanekeysPart{qx, qy, d1, d2, gqtab, n, {}},
           w, inf, n);
}

// Field operation op (0 add, 1 sub, 2 mul, 3 sqr of a) on n pairs of
// 8-word operands, each reduced mod p on load as the kernels do: r[k] =
// a[k] op b[k].
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
    } else if (op == 2) {
      p256::fe_mul(z, x, y);
    } else {
      p256::fe_sqr(z, x);
    }
    for (int i = 0; i < 8; ++i) r[8 * k + i] = z.w[i];
  }
}
