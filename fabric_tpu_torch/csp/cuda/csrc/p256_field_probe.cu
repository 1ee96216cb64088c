// A measurement probe of the P-256 field of p256_verify.cuh, not a kernel
// of the verify path: each thread runs one dependent chain of `iters`
// field operations on its own operands, so that the time of a launch over
// `iters` is the time of one operation on the chain, and the SASS of each
// probe_kernel<Op>'s loop is the code of exactly one operation (built by
// build.load_probe).  The probe calls only fe_load, fe_add, fe_sub,
// fe_mul, fe_sqr and fe_reduce_wide.
//
// Ops (r is the thread's running value, b its second operand):
//   0 mul      r = r b
//   1 sqr      r = r^2
//   2 reduce   r = (r 2^256 + r) mod p, by fe_reduce_wide alone
//   3 add      r = r + b
//   4 sub      r = r - b
#include <cuda_runtime.h>
#include <stdint.h>

#include "p256_verify.cuh"

namespace {

template <int Op>
__global__ void probe_kernel(const uint32_t* __restrict__ a,
                             const uint32_t* __restrict__ b,
                             uint32_t* __restrict__ out, int n, int iters) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  p256::Fe r = p256::fe_load(a, n, i);
  const p256::Fe y = p256::fe_load(b, n, i);
#pragma unroll 1
  for (int k = 0; k < iters; ++k) {
    if (Op == 0) {
      p256::fe_mul(r, r, y);
    } else if (Op == 1) {
      p256::fe_sqr(r, r);
    } else if (Op == 2) {
      uint32_t t[16];
#pragma unroll
      for (int w = 0; w < 8; ++w) t[w] = t[w + 8] = r.w[w];
      p256::fe_reduce_wide(r, t);
    } else if (Op == 3) {
      p256::fe_add(r, r, y);
    } else {
      p256::fe_sub(r, r, y);
    }
  }
#pragma unroll
  for (int w = 0; w < 8; ++w) out[w * n + i] = r.w[w];
}

template <int Op>
void launch(const void* a, const void* b, void* out, int n, int iters,
            int block, cudaStream_t s) {
  probe_kernel<Op><<<(n + block - 1) / block, block, 0, s>>>(
      (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, n, iters);
}

}  // namespace

// a, b, out: (8, n) words, lane i's word w at [w * n + i]; `block`
// threads a block.  Launches on `stream` and returns cudaGetLastError().
extern "C" int p256_field_probe(int op, const void* a, const void* b,
                                void* out, int n, int iters, int block,
                                void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (n > 0) {
    switch (op) {
      case 0: launch<0>(a, b, out, n, iters, block, s); break;
      case 1: launch<1>(a, b, out, n, iters, block, s); break;
      case 2: launch<2>(a, b, out, n, iters, block, s); break;
      case 3: launch<3>(a, b, out, n, iters, block, s); break;
      case 4: launch<4>(a, b, out, n, iters, block, s); break;
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}
