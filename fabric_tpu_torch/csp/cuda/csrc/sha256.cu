// Batched SHA-256 on Hopper (sm_90a).
//
// Replaces fabric_tpu/csp/tpu/sha256.py `sha256_kernel` (B4, an XLA
// function there, not a Pallas kernel): per message, its SHA-256 digest.
//
// The TPU version padded every message on the host into a static
// (B, n_blocks, 16) word tensor, because XLA compiles one program per
// shape, and ran all messages in lockstep for the longest one's blocks.
// Here the messages come as they are: one buffer of them concatenated and
// (B+1,) int64 offsets into it.  Each thread hashes one message: it reads
// its full blocks from the buffer as big-endian words, forms its own final
// padding block or two in registers (sha256.cuh), and writes the 32 digest
// bytes, so the host does no padding and only slices the result.
//
// What bounds it: the operations.  A compression is a chain of 64 rounds
// of ~25 32-bit integer operations, plus 48 schedule steps of ~13, and
// the rounds of one message cannot overlap, so a message's time is its
// block count times one compression's latency; the bytes (each message
// read once, 32 bytes written) are far below that at the card's memory
// rate.  One thread a message leaves a long message on one chain: a batch
// of a few multi-megabyte files runs on a few threads of the card
// (PERF.md).  Blocks of 32 threads spread a block's worth of messages
// (~4000) over all the SMs, one or two warps each.
#include <cuda_runtime.h>
#include <stdint.h>

#include "sha256.cuh"

namespace {

constexpr int kThreads = 32;

__global__ void __launch_bounds__(kThreads)
    sha256_kernel(const uint8_t* __restrict__ buf,
                  const int64_t* __restrict__ offs, int n,
                  uint8_t* __restrict__ out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int64_t start = offs[i];
  sha256::digest(buf + start, offs[i + 1] - start, out + 32 * (int64_t)i);
}

}  // namespace

// The digests of n messages, message i being buf[offs[i] .. offs[i+1]):
// out is (n, 32) bytes.  Launches on `stream`, does not synchronise, and
// returns cudaGetLastError().
extern "C" int sha256_digests(const void* buf, const void* offs, int n,
                              void* out, void* stream) {
  if (n > 0) {
    sha256_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                    (cudaStream_t)stream>>>(
        (const uint8_t*)buf, (const int64_t*)offs, n, (uint8_t*)out);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* sha256_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
