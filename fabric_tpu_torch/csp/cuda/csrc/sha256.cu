// Batched SHA-256 on Hopper (sm_90a).
//
// Replaces fabric_tpu/csp/tpu/sha256.py `sha256_kernel` (B4, an XLA
// function there, not a Pallas kernel): per message, its SHA-256 digest.
//
// The TPU version padded every message on the host into a static
// (B, n_blocks, 16) word tensor, because XLA compiles one program per
// shape, and ran all messages in lockstep for the longest one's blocks.
// Here the messages come as they are: one buffer of them concatenated and
// (B+1,) int64 offsets into it, and the final padding block or two is
// formed on the card, so the host does no padding and only slices.
//
// What bounds it: the operations, and of them one chain.  A message's
// compressions are serial (Merkle-Damgard), and each is 64 dependent
// rounds, so a batch takes at least its longest message's compressions
// times one compression's latency; the bytes (each message read once, 32
// bytes written) are far below that at the card's memory rate.  A batch
// of a block's messages (~4000) is one or two warps' worth of messages an
// SM, so the time is that chain, not the card's throughput.
//
// The design shortens the chain by taking everything off it that does
// not depend on the state.  Every 32 messages get a pair of warps, lane i
// of both serving message i:
// - the producer warp reads block b+1 of its message (aligned 16-byte
//   loads, byte permutes, the padding in registers), expands the message
//   schedule into the 64 round inputs K[i] + W[i], and writes them into a
//   ring of kStages stages in shared memory, while
// - the consumer warp, which holds the state, reads block b's 64 inputs
//   into registers with 16-byte shared loads, frees the stage, and runs
//   the 64 rounds.
// The two warps run on different schedulers of the SM, so the consumer's
// instruction stream carries the rounds alone.  They hand each stage over
// with two mbarriers (full: the producer's 32 lanes arrived; empty: the
// consumer's).  A stage is laid out [word / 4][lane][word % 4]: each
// warp's 16-byte access to a group of four words covers 512 contiguous
// bytes, free of bank conflicts.  Lanes whose message is done idle; the
// pair runs for its longest message's blocks.
//
// On the H100 the consumer's rounds are bound by its scheduler's integer
// pipe (16 lanes: a warp's add, logic or shift goes every other clock),
// ~2,100 clocks a compression; the producer's block takes ~1,500-1,800,
// so the hand-off hides it.  (A consumer that ran eight rounds a step
// from shared memory, a smaller loop, was ~10% slower: PERF.md.)  One
// pair a block, so 4000 messages spread 125 blocks over the 132 SMs, one
// consumer to an SM (2 pairs a block timed as 1, 4 slower: PERF.md).
#include <cuda_runtime.h>
#include <stdint.h>

#include "sha256.cuh"

namespace {

constexpr int kStages = 2;
constexpr int kStageWords = 64 * 32;  // the 64 inputs of 32 lanes

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                   shared_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n\t.reg .b64 state;\n\t"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n\t}" ::"r"(
          shared_addr(bar))
      : "memory");
}

// Waits until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n\t.reg .pred done;\n"
      "WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n\t"
      "@!done bra WAIT;\n\t}" ::"r"(shared_addr(bar)),
      "r"(parity)
      : "memory");
}

__global__ void __launch_bounds__(64)
    sha256_pair_kernel(const uint8_t* __restrict__ buf,
                       const int64_t* __restrict__ offs, int n,
                       uint8_t* __restrict__ out) {
  __shared__ uint4 ring_all[kStages * kStageWords / 4];  // [stage][16][32]
  __shared__ uint64_t bars[2 * kStages];  // full, then empty
  const int lane = threadIdx.x & 31;
  if (threadIdx.x < kStages) {
    bar_init(&bars[threadIdx.x], 32);
    bar_init(&bars[kStages + threadIdx.x], 32);
  }
  __syncthreads();
  uint64_t* full = &bars[0];
  uint64_t* empty = &bars[kStages];
  uint4* ring = ring_all + lane;

  const int i = blockIdx.x * 32 + lane;
  int64_t start = 0, len = 0;
  if (i < n) {
    start = offs[i];
    len = offs[i + 1] - start;
  }
  const int nblk = i < n ? (int)sha256::n_blocks(len) : 0;
  const int most = __reduce_max_sync(0xffffffffu, nblk);

  if (threadIdx.x >> 5) {  // producer
    for (int b = 0; b < most; ++b) {
      const int s = b % kStages;
      bar_wait(&empty[s], ((b / kStages) & 1) ^ 1);
      if (b < nblk) {
        uint32_t w[16], kw[64];
        sha256::block_words(buf + start, len, b, w);
        sha256::schedule_kw(w, kw);
        uint4* dst = ring + s * (kStageWords / 4);
#pragma unroll
        for (int g = 0; g < 16; ++g) {
          dst[32 * g] = make_uint4(kw[4 * g], kw[4 * g + 1], kw[4 * g + 2],
                                   kw[4 * g + 3]);
        }
      }
      bar_arrive(&full[s]);
    }
  } else {  // consumer
    uint32_t h[8];
    sha256::init(h);
    for (int b = 0; b < most; ++b) {
      const int s = b % kStages;
      bar_wait(&full[s], (b / kStages) & 1);
      uint32_t kw[64];
      const uint4* src = ring + s * (kStageWords / 4);
#pragma unroll
      for (int g = 0; g < 16; ++g) {
        const uint4 v = src[32 * g];
        kw[4 * g] = v.x;
        kw[4 * g + 1] = v.y;
        kw[4 * g + 2] = v.z;
        kw[4 * g + 3] = v.w;
      }
      bar_arrive(&empty[s]);
      if (b < nblk) sha256::rounds(h, kw);
    }
    if (i < n) sha256::put_digest(h, out + 32 * (int64_t)i);
  }
}

}  // namespace

// The digests of n messages, message i being buf[offs[i] .. offs[i+1]):
// out is (n, 32) bytes, 16-byte aligned.  Launches on `stream`, does not
// synchronise, and returns cudaGetLastError().
extern "C" int sha256_digests(const void* buf, const void* offs, int n,
                              void* out, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  sha256_pair_kernel<<<(n + 31) / 32, 64, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)buf, (const int64_t*)offs, n, (uint8_t*)out);
  return (int)cudaGetLastError();
}

extern "C" const char* sha256_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
