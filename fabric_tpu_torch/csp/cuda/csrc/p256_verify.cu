// Batched ECDSA-P256 verification on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels fabric_tpu/csp/tpu/pallas_ec.py
// `_kernel_dedup` (key table + per-lane index; entry point
// p256_verify_keytab) and `_kernel` (per-lane keys; p256_verify_lanekeys),
// which share `_kernel_body`.
//
// What bounds it: integer multiply-add throughput and, above all, the
// latency of one dependent chain.  A signature costs about 3,900 field
// multiplications as one joint ladder (64 windows x (4 doublings x 8 + a
// mixed add of 11 + a full add of 16), plus 14 x 11 for the Q table), each
// 64 32x32->64-bit partial products plus a Solinas reduction of a few
// dozen adds; the bytes moved are ~110 per signature.  There is no shape
// for tensor cores.
//
// The field (p256_verify.cuh): a field element is 8 32-bit words (the
// TPU's 16-bit limbs existed only because its vector unit has no 32x32->64
// multiply), so a product is 64 wide multiply-adds instead of 289 limb
// products; the Solinas reduction works on the product's words directly
// with one signed 64-bit accumulator per word.
//
// p256_verify_lanekeys (B2) runs one thread per signature: verify_lane of
// p256_verify.cuh, the G table (1 KB) in shared memory, the per-thread Q
// table (1.5 KB) in local memory, blocks of one warp.
//
// p256_verify_keytab (B1, the main path's kernel) splits each signature
// over 8 threads (p256_split.cuh): u1 and u2 are cut into 4 quarters of
// 16 windows, and warp p of a block runs part p for the block's 32
// lanes, a single-base ladder over an affine table of the part's base:
// G's (4 KiB, in shared memory) or the key's, built on the host once per
// key of the table (p256_kernel.key_quarter_tables; 4 KiB a key in device
// memory, the few keys of a launch in L2).  No thread builds a table.
// The partials meet in shared memory; after a barrier warp 0 sums each
// lane's 8 partials in a fixed order and runs the final check.  The
// longest chain is one part's ladder and the sum, ~760 multiplications
// against ~3,900, and 8 times the warps fill the card.  At most 128
// registers a thread (two 256-thread blocks an SM) beat halves of 32
// windows (~1,400 on the longest chain, 216 registers) on the card
// (PERF.md).
#include <cuda_runtime.h>
#include <stdint.h>

#include "p256_split.cuh"
#include "p256_verify.cuh"

namespace {

constexpr int kThreads = 32;
constexpr int kGWords = 2 * 16 * 8;  // x and y words of the G table

__device__ __forceinline__ void load_g(uint32_t* sg, const uint32_t* gtab) {
  for (int i = threadIdx.x; i < kGWords; i += blockDim.x) sg[i] = gtab[i];
  __syncthreads();
}

// B1: 32 lanes a block, warp p runs part p of each (see p256_split.cuh).
constexpr int kSplitLanes = 32;
constexpr int kSplitThreads = kSplitLanes * p256::kParts;

__global__ void __launch_bounds__(kSplitThreads, 2)
    keytab_kernel(const uint32_t* __restrict__ qtab,
                  const uint32_t* __restrict__ keybad,
                  const uint32_t* __restrict__ kidx,
                  const uint32_t* __restrict__ d1,
                  const uint32_t* __restrict__ d2,
                  const uint32_t* __restrict__ cand0,
                  const uint32_t* __restrict__ flags,
                  const uint32_t* __restrict__ gqtab,
                  uint8_t* __restrict__ out, int n) {
  __shared__ uint32_t sg[p256::kBaseWords];
  // partial slot p of lane l: words at [(p * 24 + i) * 32 + l], so that a
  // warp's stores and loads hit 32 banks
  __shared__ uint32_t spart[p256::kParts * p256::kPartialWords * kSplitLanes];
  __shared__ uint32_t sinf[p256::kParts * kSplitLanes];
  for (int i = threadIdx.x; i < p256::kBaseWords; i += blockDim.x) {
    sg[i] = gqtab[i];
  }
  __syncthreads();
  const int part = threadIdx.x / kSplitLanes;  // uniform in a warp
  const int l = threadIdx.x % kSplitLanes;
  const int lane = blockIdx.x * kSplitLanes + l;
  const bool ok =
      lane < n && p256::keytab_lane_ok(kidx, keybad, flags, n, lane);
  p256::Jac r;
  r.x = p256::fe_small(0u);
  r.y = r.x;
  r.z = r.x;
  r.inf = true;  // the partial of a rejected lane
  if (ok) r = p256::keytab_part(qtab, kidx, d1, d2, sg, part, n, lane);
  p256::store_partial(spart, sinf, kSplitLanes, part, l, r);
  __syncthreads();
  if (part != 0 || lane >= n) return;
  out[lane] = ok ? p256::reduce_and_check(spart, sinf, kSplitLanes, l,
                                          p256::fe_load(cand0, n, lane),
                                          flags[lane] != 0u)
                 : 0;
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
// (2, n), lanes on the last axis; gtab is the (2, 16, 8) G table; out is
// n bytes of 0/1.  p256_verify_keytab takes the key table's quarter
// tables qtab (256, 4, 16, 2, 8), its per-key bad flags keybad (256,),
// the per-lane index kidx (n,) and G's quarter tables gqtab (4, 16, 2, 8)
// in place of gtab.  Each launches on `stream`, does not synchronise, and
// returns cudaGetLastError().
extern "C" int p256_verify_keytab(const void* qtab, const void* keybad,
                                  const void* kidx, const void* d1,
                                  const void* d2, const void* cand0,
                                  const void* flags, const void* gqtab,
                                  void* out, int n, void* stream) {
  if (n > 0) {
    const int blocks = (n + kSplitLanes - 1) / kSplitLanes;
    keytab_kernel<<<blocks, kSplitThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)qtab, (const uint32_t*)keybad, (const uint32_t*)kidx,
        (const uint32_t*)d1, (const uint32_t*)d2, (const uint32_t*)cand0,
        (const uint32_t*)flags, (const uint32_t*)gqtab, (uint8_t*)out, n);
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
