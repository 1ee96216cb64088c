"""Batched SHA-256: host helpers, the plain PyTorch version, and the
wrapper that launches the CUDA kernel.

Counterpart of `fabric_tpu/csp/tpu/sha256.py` (B4, an XLA function
there).  `pad_messages`, `digest_to_bytes` and `sha256_plain` keep the
JAX package's padded layout: every message padded on the host to a
common number of 64-byte blocks, `(B, n_blocks, 16)` big-endian words
and the per-message block count `nblk`.  That layout existed because XLA
needs static shapes.  The kernel (`csrc/sha256.cu`, replacing
`sha256.sha256_kernel`) takes the messages as they are instead: one
buffer of the messages concatenated and `(B+1,)` int64 offsets into it.
A pair of warps serves 32 messages: a producer that reads each block and
expands its schedule into shared memory, and a consumer that runs the
rounds; it forms each message's padding itself and writes the 32 digest
bytes, so the host only slices.

`sha256_digests` takes the buffer on its device and the offsets on the
host, where it checks them; it launches the kernel for a CUDA buffer, in
launches of at most `MAX_LAUNCH` messages, and runs `sha256_plain` only
for a CPU one.  A launch error raises; there is no hashlib fallback.
`launcher` gives the bare launch that it makes, for timing the kernel
apart from the wrapper.  `sha256_batch` is the provider's card route.
"""

from __future__ import annotations

import time

import numpy as np
import torch

_K = np.array(
    [
        0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1,
        0x923F82A4, 0xAB1C5ED5, 0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
        0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174, 0xE49B69C1, 0xEFBE4786,
        0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
        0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147,
        0x06CA6351, 0x14292967, 0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
        0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85, 0xA2BFE8A1, 0xA81A664B,
        0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
        0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A,
        0x5B9CCA4F, 0x682E6FF3, 0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
        0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
    ],
    dtype=np.uint32,
)

_H0 = np.array(
    [0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
     0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19],
    dtype=np.uint32,
)

# Largest single kernel launch: the JAX package's largest hash bucket.
MAX_LAUNCH = 8192

# Kernel launches by the wrapper (plain-version calls on CPU tensors do
# not count).
launches_sha256 = 0

_M32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Host helpers (copies of the JAX package's).
# ---------------------------------------------------------------------------


def pad_messages(msgs, n_blocks: int | None = None) -> tuple[np.ndarray, np.ndarray]:
    """Standard SHA-256 padding, each message inside its OWN final block.

    Returns (words (B, n_blocks, 16) uint32, nblk (B,) int32): batches mix
    lengths freely; `n_blocks` only sets the static width."""
    blocks = [(len(m) + 9 + 63) // 64 for m in msgs]
    need = max(blocks) if blocks else 1
    if n_blocks is None:
        n_blocks = need
    if need > n_blocks:
        raise ValueError("messages need %d blocks > %d" % (need, n_blocks))
    out = np.zeros((len(msgs), n_blocks * 64), dtype=np.uint8)
    for i, m in enumerate(msgs):
        out[i, : len(m)] = np.frombuffer(m, dtype=np.uint8)
        out[i, len(m)] = 0x80
        bitlen = (8 * len(m)).to_bytes(8, "big")
        out[i, blocks[i] * 64 - 8 : blocks[i] * 64] = np.frombuffer(bitlen, dtype=np.uint8)
    words = out.reshape(len(msgs), n_blocks, 16, 4)
    packed = (
        (words[..., 0].astype(np.uint32) << 24)
        | (words[..., 1].astype(np.uint32) << 16)
        | (words[..., 2].astype(np.uint32) << 8)
        | words[..., 3].astype(np.uint32)
    )
    return packed, np.asarray(blocks, dtype=np.int32)


def digest_to_bytes(dig: np.ndarray) -> list[bytes]:
    """(B, 8) uint32 words -> list of 32-byte digests."""
    dig = np.asarray(dig).astype(">u4")
    return [row.tobytes() for row in dig]


def join_messages(msgs) -> tuple[np.ndarray, np.ndarray]:
    """The kernel's input layout: (the messages concatenated as uint8,
    (B+1,) int64 offsets into it)."""
    offs = np.zeros(len(msgs) + 1, np.int64)
    np.cumsum([len(m) for m in msgs], out=offs[1:])
    return np.frombuffer(b"".join(msgs), np.uint8), offs


# ---------------------------------------------------------------------------
# The plain version (int64 tensors holding 32-bit words: CPU torch's uint32
# shifts and rotates are incomplete).
# ---------------------------------------------------------------------------


def _rotr(x: torch.Tensor, n: int) -> torch.Tensor:
    return ((x >> n) | (x << (32 - n))) & _M32


def _compress_block(h: torch.Tensor, w: torch.Tensor, k: torch.Tensor):
    """One 64-round compression; h (B, 8), w (B, 16) int64 words."""
    a, b, c, d, e, f, g, hh = h.unbind(-1)
    w = list(w.unbind(-1))
    for i in range(64):
        wi = w[0]
        s1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        ch = (e & f) ^ ((e ^ _M32) & g)
        t1 = (hh + s1 + ch + k[i] + wi) & _M32
        s0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        t2 = s0 + maj
        # the message schedule on a rolling 16-word window
        w15, w2 = w[1], w[14]
        sig0 = _rotr(w15, 7) ^ _rotr(w15, 18) ^ (w15 >> 3)
        sig1 = _rotr(w2, 17) ^ _rotr(w2, 19) ^ (w2 >> 10)
        w = w[1:] + [(wi + sig0 + w[9] + sig1) & _M32]
        a, b, c, d, e, f, g, hh = ((t1 + t2) & _M32, a, b, c,
                                   (d + t1) & _M32, e, f, g)
    return (h + torch.stack([a, b, c, d, e, f, g, hh], dim=-1)) & _M32


def sha256_plain(words: torch.Tensor, nblk: torch.Tensor) -> torch.Tensor:
    """words: (B, n_blocks, 16) big-endian padded message words (any
    integer dtype holding 32-bit values); nblk: (B,) blocks each message
    occupies (its padding inside them).  Messages freeze once their own
    block count is reached, as `sha256.sha256_kernel` does.  Returns (B,
    8) int64 digest words."""
    words = words.to(torch.int64) & _M32
    nblk = nblk.to(device=words.device, dtype=torch.int64)
    k = torch.as_tensor(_K.astype(np.int64), device=words.device)
    h = torch.as_tensor(_H0.astype(np.int64), device=words.device)
    h = h.expand(words.shape[0], 8).clone()
    for i in range(words.shape[1]):
        live = (i < nblk)[:, None]
        h = torch.where(live, _compress_block(h, words[:, i], k), h)
    return h


def _digests_plain(buf: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    """The plain version on the kernel's layout: (B, 32) uint8."""
    raw = buf.numpy().tobytes()
    o = offs.tolist()
    words, nblk = pad_messages([raw[a:b] for a, b in zip(o, o[1:])])
    dig = sha256_plain(torch.from_numpy(words.astype(np.int64)),
                       torch.from_numpy(nblk))
    out = dig.numpy().astype(">u4").view(np.uint8).reshape(-1, 32)
    return torch.from_numpy(out.copy())


# ---------------------------------------------------------------------------
# The wrapper.
# ---------------------------------------------------------------------------


def _check(buf: torch.Tensor, offs: torch.Tensor) -> int:
    """Raises unless `buf` is a contiguous (N,) uint8 tensor and `offs`
    contiguous (B+1,) int64 offsets into it, non-decreasing within
    [0, N], on the host; returns B."""
    if buf.dtype != torch.uint8 or buf.dim() != 1 or not buf.is_contiguous():
        raise ValueError("buf: expected a contiguous 1-D uint8 tensor")
    if (offs.device.type != "cpu" or offs.dtype != torch.int64
            or offs.dim() != 1 or offs.numel() < 1
            or not offs.is_contiguous()):
        raise ValueError("offs: expected a contiguous (B+1,) int64 tensor "
                         "on the host")
    o = offs.numpy()
    if o[0] < 0 or o[-1] > buf.numel() or (o[1:] < o[:-1]).any():
        raise ValueError("offs: not offsets into buf")
    return offs.numel() - 1


def launcher(buf: torch.Tensor, d_offs: torch.Tensor,
             out: torch.Tensor):
    """The kernel's launch on CUDA tensors, prepared: a call with no
    arguments that launches it once on the current stream over the
    messages buf[d_offs[i]:d_offs[i+1]] (offsets on buf's device, at most
    MAX_LAUNCH messages) into `out` ((B, 32) uint8, 16-byte aligned), and
    returns the CUDA error code.  Nothing is checked and nothing counted:
    the wrapper does both, and a timing calls this bare."""
    from fabric_tpu_torch.csp.cuda import build

    lib = build.load("sha256")
    args = (buf.data_ptr(), d_offs.data_ptr(), d_offs.numel() - 1,
            out.data_ptr(), torch.cuda.current_stream(buf.device).cuda_stream)
    return build.Launch(lib.sha256_digests, args, (buf, d_offs, out))


def _launch(buf: torch.Tensor, d_offs: torch.Tensor,
            out: torch.Tensor) -> None:
    """The kernel over every message, MAX_LAUNCH at a time, counted; a
    launch error raises."""
    global launches_sha256
    n = d_offs.numel() - 1
    for lo in range(0, n, MAX_LAUNCH):
        take = min(MAX_LAUNCH, n - lo)
        rc = launcher(buf, d_offs[lo:lo + take + 1], out[lo:lo + take])()
        launches_sha256 += 1
        if rc != 0:
            from fabric_tpu_torch.csp.cuda import build

            raise RuntimeError(
                f"sha256 kernel launch failed: CUDA error {rc} "
                f"({build.load('sha256').sha256_error_string(rc).decode()})")


def sha256_digests(buf: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    """(B, 32) uint8 digests of the messages buf[offs[i]:offs[i+1]].

    `buf` is a contiguous (N,) uint8 tensor on the CPU or a CUDA card;
    `offs` is a contiguous (B+1,) int64 tensor on the host, checked to be
    non-decreasing offsets within [0, N] before anything runs, then
    copied to buf's device (non_blocking: pin it for an asynchronous
    copy).  Messages go MAX_LAUNCH at a time: on a card the hand-written
    kernel launches on the current stream and the call returns without
    synchronising; on the CPU `sha256_plain` runs.  A launch error
    raises."""
    dev = buf.device
    n = _check(buf, offs)
    if dev.type == "cpu":
        out = torch.empty((n, 32), dtype=torch.uint8)
        for lo in range(0, n, MAX_LAUNCH):
            take = min(MAX_LAUNCH, n - lo)
            out[lo:lo + take] = _digests_plain(buf, offs[lo:lo + take + 1])
        return out
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    out = torch.empty((n, 32), dtype=torch.uint8, device=dev)
    _launch(buf, offs.to(dev, non_blocking=True), out)
    return out


def sha256_batch(msgs, device="cuda", times: dict | None = None
                 ) -> list[bytes]:
    """32-byte digests of `msgs` on `device`.  Each message is written
    once, straight into a host tensor (pinned for a card, and taken from
    PyTorch's caching host allocator, which reuses it once its copies are
    done); the messages go up in one copy, `sha256_digests` hashes them,
    and the digests come back in one copy into a pinned tensor.  With
    `times`, each stage ends in a synchronise and its seconds are added
    into times[stage]: stage, upload, kernel, readback, digests."""
    if not msgs:
        return []
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    clock = [time.perf_counter()]

    def lap(name):
        if times is not None:
            if cuda:
                torch.cuda.synchronize(dev)
            clock.append(time.perf_counter())
            times[name] = times.get(name, 0.0) + clock[-1] - clock[-2]

    n = len(msgs)
    offs = torch.empty(n + 1, dtype=torch.int64, pin_memory=cuda)
    o = offs.numpy()
    o[0] = 0
    np.cumsum(np.fromiter(map(len, msgs), np.int64, n), out=o[1:])
    buf = torch.empty(max(int(o[n]), 1), dtype=torch.uint8, pin_memory=cuda)
    view = memoryview(buf.numpy())
    starts, ends = o[:-1].tolist(), o[1:].tolist()
    for m, a, b in zip(msgs, starts, ends):
        view[a:b] = m
    lap("stage")
    if cuda:
        buf = buf.to(dev, non_blocking=True)
    lap("upload")
    out = sha256_digests(buf, offs)
    lap("kernel")
    if cuda:
        host = torch.empty(out.shape, dtype=torch.uint8, pin_memory=True)
        out = host.copy_(out, non_blocking=True)
        torch.cuda.current_stream(dev).synchronize()
    lap("readback")
    raw = out.numpy().tobytes()
    digests = [raw[i:i + 32] for i in range(0, n * 32, 32)]
    lap("digests")
    return digests


__all__ = [
    "MAX_LAUNCH",
    "pad_messages",
    "digest_to_bytes",
    "join_messages",
    "sha256_plain",
    "launcher",
    "sha256_digests",
    "sha256_batch",
]
