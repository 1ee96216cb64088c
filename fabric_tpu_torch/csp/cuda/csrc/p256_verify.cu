// Batched ECDSA-P256 verification on Hopper (sm_90a), one thread per
// signature.
//
// Replaces the Pallas TPU kernels fabric_tpu/csp/tpu/pallas_ec.py
// `_kernel_dedup` (key table + per-lane index; entry point
// p256_verify_keytab) and `_kernel` (per-lane keys; p256_verify_lanekeys),
// which share `_kernel_body`.  Here the two share verify_lane of
// p256_verify.cuh.
//
// What bounds it: integer multiply-add throughput.  A signature costs about
// 3,900 field multiplications (64 windows x (4 doublings x 8 + a mixed add
// of 11 + a full add of 16), plus 14 x 11 for the Q table), each 64
// 32x32->64-bit partial products plus a Solinas reduction of a few dozen
// adds; the bytes moved are ~110 per signature.  The work is one long
// dependent chain per signature, with no shape for tensor cores.
//
// What the design does about it: a field element is 8 32-bit words (the
// TPU's 16-bit limbs existed only because its vector unit has no 32x32->64
// multiply), so a product is 64 wide multiply-adds instead of 289 limb
// products; the Solinas reduction works on the product's words directly
// with one signed 64-bit accumulator per word; the key gather and the
// window selections are indexed loads, not the TPU's one-hot sums; the G
// table (1 KB) sits in shared memory, loaded once per block (constant
// memory would serialise a warp whose digits differ), and the per-thread
// Q table (1.5 KB) in local memory.  Blocks are one warp, so that the ~125
// warps of a 4000-lane block spread over the 132 SMs.  Filling each SM
// with more than one warp is left to later work.
#include <cuda_runtime.h>
#include <stdint.h>

#include "p256_verify.cuh"

namespace {

constexpr int kThreads = 32;
constexpr int kGWords = 2 * 16 * 8;  // x and y words of the G table

__device__ __forceinline__ void load_g(uint32_t* sg, const uint32_t* gtab) {
  for (int i = threadIdx.x; i < kGWords; i += blockDim.x) sg[i] = gtab[i];
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
    keytab_kernel(const uint32_t* __restrict__ ktabx,
                  const uint32_t* __restrict__ ktaby,
                  const uint32_t* __restrict__ kidx,
                  const uint32_t* __restrict__ d1,
                  const uint32_t* __restrict__ d2,
                  const uint32_t* __restrict__ cand0,
                  const uint32_t* __restrict__ flags,
                  const uint32_t* __restrict__ gtab,
                  uint8_t* __restrict__ out, int n) {
  __shared__ uint32_t sg[kGWords];
  load_g(sg, gtab);
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  out[lane] = p256::verify_keytab(ktabx, ktaby, kidx, d1, d2, cand0, flags,
                                  sg, n, lane);
}

__global__ void __launch_bounds__(kThreads)
    lanekeys_kernel(const uint32_t* __restrict__ qx,
                    const uint32_t* __restrict__ qy,
                    const uint32_t* __restrict__ d1,
                    const uint32_t* __restrict__ d2,
                    const uint32_t* __restrict__ cand0,
                    const uint32_t* __restrict__ flags,
                    const uint32_t* __restrict__ gtab,
                    uint8_t* __restrict__ out, int n) {
  __shared__ uint32_t sg[kGWords];
  load_g(sg, gtab);
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  out[lane] = p256::verify_lanekeys(qx, qy, d1, d2, cand0, flags, sg, n,
                                    lane);
}

int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

// C entry points (bound with ctypes).  Word arrays are (8, n) and flags
// (2, n), lanes on the last axis; ktabx/ktaby are (8, 256); gtab is the
// (2, 16, 8) G table; out is n bytes of 0/1.  Each launches on `stream`,
// does not synchronise, and returns cudaGetLastError().
extern "C" int p256_verify_keytab(const void* ktabx, const void* ktaby,
                                  const void* kidx, const void* d1,
                                  const void* d2, const void* cand0,
                                  const void* flags, const void* gtab,
                                  void* out, int n, void* stream) {
  if (n > 0) {
    keytab_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)ktabx, (const uint32_t*)ktaby, (const uint32_t*)kidx,
        (const uint32_t*)d1, (const uint32_t*)d2, (const uint32_t*)cand0,
        (const uint32_t*)flags, (const uint32_t*)gtab, (uint8_t*)out, n);
  }
  return (int)cudaGetLastError();
}

extern "C" int p256_verify_lanekeys(const void* qx, const void* qy,
                                    const void* d1, const void* d2,
                                    const void* cand0, const void* flags,
                                    const void* gtab, void* out, int n,
                                    void* stream) {
  if (n > 0) {
    lanekeys_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)qx, (const uint32_t*)qy, (const uint32_t*)d1,
        (const uint32_t*)d2, (const uint32_t*)cand0, (const uint32_t*)flags,
        (const uint32_t*)gtab, (uint8_t*)out, n);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* p256_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
