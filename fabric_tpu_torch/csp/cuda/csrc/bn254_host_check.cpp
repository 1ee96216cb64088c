// The arithmetic, point operations and thread bodies of bn254_commit.cu,
// compiled for the host with a plain C++ compiler (the header's portable
// field), so that tests on a machine without a GPU can hold the kernel's
// code against Python ints and the plain PyTorch version:
//
//   g++ -O2 -std=c++17 -shared -fPIC -o libbn254host.so bn254_host_check.cpp
//
// bn254_host_terms and bn254_host_reduce run the bodies of the kernel's
// two phases over every (term, lane) and (accumulator, lane);
// bn254_host_commitments runs both, with the kernel's arguments (the
// scratch buffer is its own, there is no stream).
#include <stdint.h>

#include <vector>

#include "bn254_commit.cuh"

extern "C" void bn254_host_terms(const uint32_t* lanes,
                                 const uint32_t* laneinf,
                                 const uint32_t* digits,
                                 const int32_t* termmeta, int n_terms,
                                 const uint32_t* comb_xy,
                                 const uint32_t* comb_inf, int n_shared,
                                 uint32_t* part, int n) {
  for (int t = 0; t < n_terms; ++t) {
    for (int lane = 0; lane < n; ++lane) {
      bn254::term_lane(lanes, laneinf, digits, termmeta, comb_xy, comb_inf,
                       n_shared, part, n, lane, t);
    }
  }
}

extern "C" void bn254_host_reduce(const uint32_t* part,
                                  const int32_t* termmeta, int n_terms,
                                  uint32_t* out, int n) {
  for (int a = 0; a < bn254::kAccs; ++a) {
    for (int lane = 0; lane < n; ++lane) {
      bn254::reduce_lane(part, termmeta, n_terms, out, n, lane, a);
    }
  }
}

extern "C" void bn254_host_commitments(const uint32_t* lanes,
                                       const uint32_t* laneinf,
                                       const uint32_t* digits,
                                       const int32_t* termmeta, int n_terms,
                                       const uint32_t* comb_xy,
                                       const uint32_t* comb_inf,
                                       int n_shared, uint32_t* out, int n) {
  std::vector<uint32_t> part((size_t)bn254::kPartRows * n_terms * n);
  bn254_host_terms(lanes, laneinf, digits, termmeta, n_terms, comb_xy,
                   comb_inf, n_shared, part.data(), n);
  bn254_host_reduce(part.data(), termmeta, n_terms, out, n);
}

// Field operation op (0 add, 1 sub, 2 mul) on n pairs of 8-word operands
// in [0, 2p), the result made canonical: r[k] = canon(a[k] op b[k]).
extern "C" void bn254_host_field(int op, const uint32_t* a,
                                 const uint32_t* b, uint32_t* r, int n) {
  for (int k = 0; k < n; ++k) {
    const bn254::Fe x = bn254::fe_load(a + 8 * k, 1, 0);
    const bn254::Fe y = bn254::fe_load(b + 8 * k, 1, 0);
    bn254::Fe z;
    if (op == 0) {
      bn254::fe_add(z, x, y);
    } else if (op == 1) {
      bn254::fe_sub(z, x, y);
    } else {
      bn254::fe_mul(z, x, y);
    }
    bn254::fe_canon(z);
    for (int i = 0; i < 8; ++i) r[8 * k + i] = z.w[i];
  }
}

// Point operation op (0 double p1, 1 full add p1 + p2, 2 mixed add p1 +
// affine (x2, y2)) on n pairs of points given as 25 words (x, y, z, then
// the infinity flag); r[k] in the same 25 words, canonical.
extern "C" void bn254_host_point(int op, const uint32_t* p1,
                                 const uint32_t* p2, uint32_t* r, int n) {
  for (int k = 0; k < n; ++k) {
    bn254::Jac a, b;
    a.x = bn254::fe_load(p1 + 25 * k, 1, 0);
    a.y = bn254::fe_load(p1 + 25 * k + 8, 1, 0);
    a.z = bn254::fe_load(p1 + 25 * k + 16, 1, 0);
    a.inf = p1[25 * k + 24] != 0u;
    b.x = bn254::fe_load(p2 + 25 * k, 1, 0);
    b.y = bn254::fe_load(p2 + 25 * k + 8, 1, 0);
    b.z = bn254::fe_load(p2 + 25 * k + 16, 1, 0);
    b.inf = p2[25 * k + 24] != 0u;
    bn254::Jac o;
    if (op == 0) {
      o = bn254::jac_dbl(a);
    } else if (op == 1) {
      o = bn254::jac_add(a, b);
    } else {
      o = bn254::jac_add_mixed(a, b.x, b.y, b.inf);
    }
    uint32_t* row = r + 25 * k;
    bn254::store_fe(row, 1, o.x, o.inf);
    bn254::store_fe(row + 8, 1, o.y, o.inf);
    bn254::store_fe(row + 16, 1, o.z, o.inf);
    row[24] = o.inf ? 1u : 0u;
  }
}
