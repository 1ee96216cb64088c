// Batched ECDSA-P256 verification on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels fabric_tpu/csp/tpu/pallas_ec.py
// `_kernel_dedup` (key table + per-lane index; entry point
// p256_verify_keytab, B1) and `_kernel` (per-lane keys;
// p256_verify_lanekeys, B2), which share `_kernel_body`.
//
// What bounds it: the instruction rate of the integer pipes (a warp's
// integer instruction takes 2 cycles of its scheduler) along one
// dependent chain of field multiplications, whose length the design
// sets.  A signature costs about 3,900 field multiplications as one joint
// ladder (64 windows x (4 doublings x 8 + a mixed add of 11 + a full add
// of 16), plus 14 x 11 for the Q table); the bytes moved are ~110 per
// signature.  There is no shape for tensor cores.
//
// The field (p256_verify.cuh): a field element is 8 32-bit words (the
// TPU's 16-bit limbs existed only because its vector unit has no 32x32->64
// multiply); on the card a product is 64 wide multiplies summed by PTX
// carry chains, a square 36, and the Solinas reduction is a few carry
// chains over the product's words (PERF.md has each piece's SASS and
// time against the portable C it replaced).  The multiplication and the
// squaring are called, not inlined, so that a ladder's loop fits the
// instruction cache; inlined, both kernels ran at half the speed.
//
// Both kernels split each signature over 8 threads (p256_split.cuh): u1
// and u2 are cut into 4 quarters of 16 windows, and warp p of a
// 256-thread block runs part p for the block's 32 lanes.  The partials
// meet in shared memory; after a barrier warp 0 sums each lane's 8
// partials in a fixed order and runs the final check (split_block
// below).  Parts 0..3 are u1_j G over G's affine quarter tables (4 KiB,
// in shared memory).  What parts 4..7 run differs:
//   - B1: u2_j Q over the key's affine quarter tables, built on the host
//     once per key of the table (p256_kernel.key_quarter_tables; 4 KiB a
//     key in device memory, the few keys of a launch in L2); the longest
//     chain is one 16-window ladder and the sum, ~760 multiplications.
//   - B2: part 4 builds the lane's Jacobian table of Q (~150
//     multiplications) into dynamic shared memory (45 KiB a block); after
//     a barrier of the four Q warps each runs its 16 windows over it with
//     full adds and doubles the result 64 j times.  The longest chain,
//     the top quarter's, is ~2,570 multiplications against ~3,930 for one
//     thread per signature.  A key not on P-256 is rejected before any
//     arithmetic (the curve check, 3 multiplications).
// Both at most 128 registers a thread (two 256-thread blocks an SM): for
// B1 that beat halves of 32 windows; for B2 it beat one block an SM (150
// registers, no spills) from 8000 lanes up, a flush of two blocks, and
// lost to it by ~12% at 4000.  One table of Q a lane in shared memory
// beat a copy a Q part in local memory by 1.3-2.4% from 8000 lanes up
// and lost by ~1% below (PERF.md).
#include <cuda_runtime.h>
#include <stdint.h>

#include "p256_split.cuh"
#include "p256_verify.cuh"

namespace {

// 32 lanes a block, warp p runs part p of each (see p256_split.cuh).
constexpr int kSplitLanes = 32;
constexpr int kSplitThreads = kSplitLanes * p256::kParts;
// B2's tables of Q, dynamic shared memory: kQTableWords words a lane
constexpr int kQTableBytes = p256::kQTableWords * kSplitLanes * 4;

// The lanes of B1: keys from the key table, with their quarter tables.
struct KeytabLanes {
  const uint32_t* qtab;
  const uint32_t* keybad;
  const uint32_t* kidx;
  const uint32_t* d1;
  const uint32_t* d2;
  const uint32_t* flags;
  int n;

  __device__ bool ok(int lane) const {
    return p256::keytab_lane_ok(kidx, keybad, flags, n, lane);
  }
  __device__ p256::Jac part(const uint32_t* gq, int part, int /*l*/,
                            int lane, bool ok) const {
    return ok ? p256::keytab_part(qtab, kidx, d1, d2, gq, part, n, lane)
              : p256::jac_infinity();
  }
};

// The lanes of B2: a key per lane.
struct LanekeysLanes {
  const uint32_t* qx;
  const uint32_t* qy;
  const uint32_t* d1;
  const uint32_t* d2;
  const uint32_t* flags;
  int n;

  __device__ bool ok(int lane) const {
    return p256::lanekeys_lane_ok(qx, qy, flags, n, lane);
  }
  // Part 4 builds each lane's table of Q in shared memory; the four Q
  // warps wait for it at barrier 1 (rejected lanes too), then read it.
  __device__ p256::Jac part(const uint32_t* gq, int part, int l, int lane,
                            bool ok) const {
    extern __shared__ uint32_t sq[];  // kQTableBytes, lane l at stride 32
    if (part >= p256::kQuarters) {
      if (part == p256::kQuarters && ok) {
        p256::build_q_table(sq, kSplitLanes, l, p256::fe_load(qx, n, lane),
                            p256::fe_load(qy, n, lane));
      }
      static_assert(p256::kQuarters * kSplitLanes == 128, "barrier 1");
      asm volatile("bar.sync 1, 128;" ::: "memory");
    }
    return ok ? p256::lanekeys_part(sq, kSplitLanes, l, d1, d2, gq, part, n,
                                    lane)
              : p256::jac_infinity();
  }
};

// One block of either kernel: G's quarter tables into shared memory, part
// p of each of the block's 32 lanes (infinity for a lane the guard
// rejects; every thread calls part), the partials into shared memory,
// and warp 0's sum and check.
template <class Lanes>
__device__ __forceinline__ void split_block(const Lanes& lanes,
                                            const uint32_t* gqtab,
                                            const uint32_t* cand0,
                                            const uint32_t* flags,
                                            uint8_t* out, int n) {
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
  const bool ok = lane < n && lanes.ok(lane);
  p256::store_partial(spart, sinf, kSplitLanes, part, l,
                      lanes.part(sg, part, l, lane, ok));
  __syncthreads();
  if (part != 0 || lane >= n) return;
  out[lane] = ok ? p256::reduce_and_check(spart, sinf, kSplitLanes, l,
                                          p256::fe_load(cand0, n, lane),
                                          flags[lane] != 0u)
                 : 0;
}

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
  split_block(KeytabLanes{qtab, keybad, kidx, d1, d2, flags, n}, gqtab,
              cand0, flags, out, n);
}

__global__ void __launch_bounds__(kSplitThreads, 2)
    lanekeys_kernel(const uint32_t* __restrict__ qx,
                    const uint32_t* __restrict__ qy,
                    const uint32_t* __restrict__ d1,
                    const uint32_t* __restrict__ d2,
                    const uint32_t* __restrict__ cand0,
                    const uint32_t* __restrict__ flags,
                    const uint32_t* __restrict__ gqtab,
                    uint8_t* __restrict__ out, int n) {
  split_block(LanekeysLanes{qx, qy, d1, d2, flags, n}, gqtab, cand0, flags,
              out, n);
}

int blocks_for(int n) { return (n + kSplitLanes - 1) / kSplitLanes; }

}  // namespace

// C entry points (bound with ctypes).  Word arrays are (8, n) and flags
// (2, n), lanes on the last axis; gqtab is G's quarter tables (4, 16, 2,
// 8); out is n bytes of 0/1.  p256_verify_keytab takes the key table's
// quarter tables qtab (256, 4, 16, 2, 8), its per-key bad flags keybad
// (256,) and the per-lane index kidx (n,); p256_verify_lanekeys the keys
// qx, qy.  Each launches on `stream`, does not synchronise, and returns
// cudaGetLastError().
extern "C" int p256_verify_keytab(const void* qtab, const void* keybad,
                                  const void* kidx, const void* d1,
                                  const void* d2, const void* cand0,
                                  const void* flags, const void* gqtab,
                                  void* out, int n, void* stream) {
  if (n > 0) {
    keytab_kernel<<<blocks_for(n), kSplitThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)qtab, (const uint32_t*)keybad, (const uint32_t*)kidx,
        (const uint32_t*)d1, (const uint32_t*)d2, (const uint32_t*)cand0,
        (const uint32_t*)flags, (const uint32_t*)gqtab, (uint8_t*)out, n);
  }
  return (int)cudaGetLastError();
}

extern "C" int p256_verify_lanekeys(const void* qx, const void* qy,
                                    const void* d1, const void* d2,
                                    const void* cand0, const void* flags,
                                    const void* gqtab, void* out, int n,
                                    void* stream) {
  if (n > 0) {
    // more than 48 KiB of shared memory a block needs the opt-in (on the
    // current device, so at every launch)
    const cudaError_t rc = cudaFuncSetAttribute(
        lanekeys_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kQTableBytes);
    if (rc != cudaSuccess) return (int)rc;
    lanekeys_kernel<<<blocks_for(n), kSplitThreads, kQTableBytes,
                      (cudaStream_t)stream>>>(
        (const uint32_t*)qx, (const uint32_t*)qy, (const uint32_t*)d1,
        (const uint32_t*)d2, (const uint32_t*)cand0, (const uint32_t*)flags,
        (const uint32_t*)gqtab, (uint8_t*)out, n);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* p256_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
