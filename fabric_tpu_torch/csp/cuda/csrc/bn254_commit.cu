// Batched idemix Schnorr commitments on Hopper (sm_90a): per signature the
// three G1 multi-scalar multiplications T1, T2, T3 on BN254, one thread per
// (signature, term), then one per (signature, accumulator).
//
// Replaces the Pallas TPU kernel fabric_tpu/csp/tpu/pallas_bn254.py
// `_make_kernel(n_terms, n_tables)` (launched by `_build_call`, driven by
// `commitments`).  The thread bodies are term_lane and reduce_lane of
// bn254_commit.cuh.
//
// What bounds it: the latency of one lane-base term's dependent chain.
// Each term is its own thread, so the kernel takes as long as its longest
// thread: a lane-base term's variable-base ladder, ~3,000 dependent field
// multiplications (its table's 14 mixed adds of 11, then 64 windows of 4
// doublings of 7 and one full add of 16), each a CIOS product of 64
// 32x32-bit multiply-adds and 72 for the reduction.  The card runs about
// one such warp per scheduler, so the latency of every instruction of the
// chain shows; a shared-base term's comb (64 mixed adds, ~700
// multiplications) and the reduction (at most a few full adds) hide under
// it.  The bytes moved are ~1 KB per signature plus the comb tables.
//
// What the design does about it:
//  1. Term-parallel MSMs.  term_kernel gives each (signature, term) its own
//     thread, which computes the term's scalar multiple s_t B_t as a
//     Jacobian partial into a scratch buffer (canonical words);
//     reduce_kernel then gives each (signature, accumulator) a thread that
//     adds its terms' partials in termmeta order with the full add
//     (add-2007-bl: equal partials double, opposite ones cancel, an
//     infinity partial passes the other through).
//  2. Fixed-base combs for the shared bases (G1, h_sk, h_rand, h_attrs),
//     which depend only on the issuer key: d 16^k B for d < 16 and each of
//     the 64 windows k, affine Montgomery words built once per issuer key
//     on the host (bn254_batch.shared_comb) and uploaded with each batch,
//     n_shared x 64 KB (448 KB at 4 attributes) in device memory, which the
//     50 MB L2 holds.  A shared-base term is then 64 mixed adds and no
//     doublings.
//  3. Lane-base terms keep the variable-base ladder; its 16-entry Jacobian
//     table (1.5 KB a thread) sits in local memory, read once a window.
//     Shared memory would be reserved for every block of the launch, comb
//     blocks included, and cap how many are resident for a read that is a
//     few hundred cycles of a window's tens of thousands.
//  4. No warp runs both programs: a block is 4 warps of 32 consecutive
//     signatures of one term (blockIdx.y), with lane-base terms ranked
//     first so that their blocks come first in the grid and spread one to
//     an SM; a warp reads consecutive lanes of `digits` and `lanes`.  At
//     1024 signatures and 15 terms that is 120 blocks of 4 warps for the
//     132 SMs, 40 of them of ladders.
//  5. The device field arithmetic is PTX carry chains (mad.lo.cc /
//     madc.hi.cc / add.cc / addc / sub.cc / subc) on 8 32-bit words in
//     Montgomery form at R = 2^256, kept lazily in [0, 2p): BN254's
//     p < 2^254 leaves room for no final subtraction per product and one
//     conditional correction per add or sub.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bn254_commit.cuh"

namespace {

constexpr int kThreads = 128;

// The term of rank r: lane-base terms first, then the rest, each in
// termmeta order.
__device__ int term_of_rank(const int32_t* termmeta, int n_terms,
                            int n_shared, int r) {
  int k = 0;
  for (int pass = 0; pass < 2; ++pass) {
    for (int t = 0; t < n_terms; ++t) {
      const int tab = termmeta[2 * t];
      const bool lane_base =
          tab >= n_shared && tab < n_shared + bn254::kLaneBases;
      if (lane_base == (pass == 0) && k++ == r) return t;
    }
  }
  return -1;
}

__global__ void __launch_bounds__(kThreads)
    term_kernel(const uint32_t* __restrict__ lanes,
                const uint32_t* __restrict__ laneinf,
                const uint32_t* __restrict__ digits,
                const int32_t* __restrict__ termmeta, int n_terms,
                const uint32_t* __restrict__ comb_xy,
                const uint32_t* __restrict__ comb_inf, int n_shared,
                uint32_t* __restrict__ part, int n) {
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  if (lane >= n) return;
  const int t = term_of_rank(termmeta, n_terms, n_shared, blockIdx.y);
  bn254::term_lane(lanes, laneinf, digits, termmeta, comb_xy, comb_inf,
                   n_shared, part, n, lane, t);
}

__global__ void __launch_bounds__(kThreads)
    reduce_kernel(const uint32_t* __restrict__ part,
                  const int32_t* __restrict__ termmeta, int n_terms,
                  uint32_t* __restrict__ out, int n) {
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  if (lane >= n) return;
  bn254::reduce_lane(part, termmeta, n_terms, out, n, lane, blockIdx.y);
}

}  // namespace

// C entry point (bound with ctypes).  lanes is (64, n), laneinf (4, n),
// digits (8 n_terms, n), termmeta (n_terms, 2) int32, comb_xy
// (1024 n_shared, 16), comb_inf (1024 n_shared), part (25 n_terms, n)
// scratch, out (bn254::kOutRows, n); lanes on the last axis.  Launches
// term_kernel (when there are terms) and then reduce_kernel on `stream`,
// does not synchronise, and returns cudaGetLastError().
extern "C" int bn254_commitments(const void* lanes, const void* laneinf,
                                 const void* digits, const void* termmeta,
                                 int n_terms, const void* comb_xy,
                                 const void* comb_inf, int n_shared,
                                 void* part, void* out, int n_lanes,
                                 void* stream) {
  if (n_lanes > 0) {
    const unsigned blocks = (unsigned)((n_lanes + kThreads - 1) / kThreads);
    cudaStream_t s = (cudaStream_t)stream;
    if (n_terms > 0) {
      term_kernel<<<dim3(blocks, (unsigned)n_terms), kThreads, 0, s>>>(
          (const uint32_t*)lanes, (const uint32_t*)laneinf,
          (const uint32_t*)digits, (const int32_t*)termmeta, n_terms,
          (const uint32_t*)comb_xy, (const uint32_t*)comb_inf, n_shared,
          (uint32_t*)part, n_lanes);
      const cudaError_t e = cudaGetLastError();
      if (e != cudaSuccess) return (int)e;
    }
    reduce_kernel<<<dim3(blocks, (unsigned)bn254::kAccs), kThreads, 0, s>>>(
        (const uint32_t*)part, (const int32_t*)termmeta, n_terms,
        (uint32_t*)out, n_lanes);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* bn254_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
