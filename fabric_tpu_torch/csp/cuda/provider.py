"""CUDA CSP provider: batched ECDSA-P256 verification on the card.

`CUDACSP` keeps the SPI and the batching behaviour of the JAX package's
`TPUCSP` (`fabric_tpu/csp/tpu/provider.py`): the `min_device_batch`
host cutoff, cross-call coalescing of `verify_batch_async` batches into
one flush with idempotent per-segment collectors, chunking under
`max_chunk`, a persistent SKI-keyed key table held on the device, and
the per-flush fallback to a per-batch key table and then to per-lane
keys when a flush holds more than 256 distinct keys.

Device work stays asynchronous: a flush packs on the host, copies up
through pinned buffers with non_blocking copies on the current stream,
launches the kernel and queues the mask's copy back; a CUDA event marks
its end.  Only a collector waits, on that event.  There is no fallback:
a kernel that fails to build or launch, or a CUDA error, propagates out
of the collector.

Each flush is packed by the port's C++ host library
(`fabric_tpu_torch.native.marshal_batch`: DER parse, prechecks, one
batch inversion, the digits), as `TPUCSP._marshal_native` packs; the
numpy `p256_kernel.prepare_packed` is its plain version.

`hash_batch` hashes on the card (`sha256.sha256_digests`, kernel B4) from
`min_device_batch` messages up, as `TPUCSP.hash_batch` does, but only for
a batch wide enough that one thread a message beats hashlib
(`hash_on_card`); hashlib answers the rest, and `hash` of one message.
A hash kernel that fails to build or launch raises: unlike the
reference, no hashlib fallback.

Key generation and signing are host-side, in `hostref` (the reference's
hot path is verification at commit time).
"""

from __future__ import annotations

import hashlib
import threading
import time
from typing import Sequence

import numpy as np
import torch

from fabric_tpu_torch.csp import hostref
from fabric_tpu_torch.csp.api import (
    CSP,
    Key,
    P256PrivateKey,
    P256PublicKey,
    VerifyBatchItem,
)
from fabric_tpu_torch.csp.cuda import p256_kernel, sha256

# Largest single kernel launch.  The TPU's bucket padding is gone: a CUDA
# kernel is not recompiled per shape and masks its own ragged edge, so a
# chunk is exactly its lanes.  The limit is the JAX package's, not yet
# re-swept on the card.
_MAX_CHUNK = 8192


# hash_batch's route.  B4 hashes each message on one thread, so a launch
# lasts as long as the longest message's chain of compressions (~2.6 us
# each), while hashlib's time is the sum of every message's (~0.06 us
# each, and ~0.8 us a message); the card's route also pays for the join,
# the pinned copy, the upload and the readback (~0.2 ms, then ~0.4 us a
# message and ~0.02-0.04 us a compression).  The card takes a batch only
# when its compressions outnumber the longest message's HASH_WIDTH times
# over, plus HASH_FIXED; where the two routes come close, hashlib keeps
# the batch.  (NVIDIA H100 80GB HBM3, 700 W: `chip_smoke.py`'s routing
# check, PERF.md.)
HASH_WIDTH = 192
HASH_FIXED = 1024


def hash_on_card(msgs: Sequence[bytes], min_device_batch: int = 16) -> bool:
    """Whether `hash_batch` sends `msgs` to the card (else hashlib)."""
    if len(msgs) < min_device_batch:
        return False
    blocks = [(len(m) + 72) >> 6 for m in msgs]  # compressions, padding in
    return sum(blocks) >= HASH_WIDTH * max(blocks) + HASH_FIXED


def _chunk_plan(n: int, max_chunk: int = _MAX_CHUNK) -> list[int]:
    """Lanes per kernel launch: full chunks of max_chunk, then the tail."""
    out = []
    left = n
    while left > 0:
        take = min(left, max_chunk)
        out.append(take)
        left -= take
    return out


class _KeyTable:
    """Persistent SKI-keyed table of distinct public keys for the
    key-table kernel.

    Blocks reuse a handful of client and endorser keys, so each lane
    carries a u32 index instead of its key, and the table lives on the
    device across flushes, uploaded again only when a key is added: the
    (8, KEYTAB) word tables of the plain version, and the kernel's
    per-key quarter tables and bad-key flags, built on the host when a
    key enters (one batched inversion for all the keys an `assign` adds).
    On overflow the table resets to the current batch's keys; a batch
    with more than KEYTAB distinct keys gets None.

    A key's quarter tables (~1.4 ms of host time to build) outlive its
    stay in the table: the last BUILT_CAP keys' are kept by SKI, so
    traffic that churns among more keys than the table holds rebuilds
    only keys it has not seen lately."""

    BUILT_CAP = 4096  # keys whose quarter tables are kept (4 KiB each)

    def __init__(self):
        self.cap = p256_kernel.KEYTAB
        # SKI -> (quarter tables, bad-key flag), least recently used first
        self._built: dict[bytes, tuple[np.ndarray, int]] = {}
        self._idx: dict[bytes, int] = {}
        self._ktabx = np.zeros((8, self.cap), np.uint32)
        self._ktaby = np.zeros((8, self.cap), np.uint32)
        self._qtab = np.zeros((self.cap, *p256_kernel.QTAB_SHAPE), np.uint32)
        self._keybad = np.ones(self.cap, np.uint32)  # no key: rejected
        self._dev: dict[str, dict[str, torch.Tensor]] = {}

    @staticmethod
    def _words(be32: bytes) -> np.ndarray:
        # 32 big-endian bytes -> 8 words, least significant first
        return np.frombuffer(be32, ">u4")[::-1].astype(np.uint32)

    def _add(self, key) -> int | None:
        j = len(self._idx)
        if j >= self.cap:
            return None
        self._idx[key.ski()] = j
        self._ktabx[:, j] = self._words(key.x_bytes)
        self._ktaby[:, j] = self._words(key.y_bytes)
        self._dev = {}  # every device copy is stale
        return j

    def _fill(self, added: list) -> None:
        """Quarter tables and bad-key flags for the entries `added`
        ([(index, SKI)]): kept ones copied, the others built in one
        call."""
        new = [(j, ski) for j, ski in added if ski not in self._built]
        if new:
            cols = [j for j, _ in new]
            tabs = p256_kernel.key_quarter_tables(
                self._ktabx[:, cols], self._ktaby[:, cols])
            for (_, ski), qtab, bad in zip(new, tabs["qtab"],
                                            tabs["keybad"]):
                self._built[ski] = (qtab.copy(), int(bad))
        for j, ski in added:
            entry = self._built.pop(ski)
            self._built[ski] = entry  # now the most recently used
            self._qtab[j], self._keybad[j] = entry
        while len(self._built) > self.BUILT_CAP:
            del self._built[next(iter(self._built))]

    def _reset(self) -> None:
        self._idx.clear()
        self._ktabx[:] = 0
        self._ktaby[:] = 0
        self._qtab[:] = 0
        self._keybad[:] = 1
        self._dev = {}

    def assign(self, keys) -> np.ndarray | None:
        """Per-lane table indexes for `keys`, or None when even a fresh
        table cannot hold this batch's distinct keys (the table is then
        left empty: no key stays in it without its quarter tables)."""
        for _attempt in (0, 1):
            kidx = np.empty(len(keys), np.uint32)
            added = []
            ok = True
            for i, k in enumerate(keys):
                j = self._idx.get(k.ski())
                if j is None:
                    j = self._add(k)
                    if j is None:
                        ok = False
                        break
                    added.append((j, k.ski()))
                kidx[i] = j
            if ok:
                if added:
                    self._fill(added)
                return kidx
            # overflow: reset to this batch's working set and retry once
            self._reset()
        return None

    def device_tables(self, device: torch.device) -> dict:
        """{"ktabx", "ktaby", "qtab", "keybad"}: the tables as int32
        tensors on `device`, uploaded once per change of the table."""
        key = str(device)
        if key not in self._dev:
            self._dev[key] = {
                name: torch.as_tensor(t.view(np.int32).copy(), device=device)
                for name, t in (("ktabx", self._ktabx),
                                ("ktaby", self._ktaby),
                                ("qtab", self._qtab),
                                ("keybad", self._keybad))
            }
        return dict(self._dev[key])


class _FlushResult:
    """One flushed (coalesced) dispatch: lazy per-chunk collectors, the
    mask materialized once however many segments collect it, and a count
    of unread lanes so the provider can drop it once every segment has
    read its slice.  A dispatch that raised stores its exception, which
    every collector of the flush then raises."""

    def __init__(self, pending, total_lanes: int,
                 error: Exception | None = None):
        self._pending = pending  # [(collect() -> list[bool], event or None)]
        self._mask: list[bool] | None = None
        self._exc = error
        self._outstanding = total_lanes
        self._lock = threading.Lock()

    def collect(self) -> list[bool]:
        with self._lock:
            if self._mask is None and self._exc is None:
                try:
                    out: list[bool] = []
                    for collect, _ in self._pending:
                        out.extend(collect())
                    self._mask = out
                except Exception as e:  # raised to every collector below
                    self._exc = e
                finally:
                    self._pending = ()
        if self._exc is not None:
            raise self._exc
        return self._mask

    def wait(self) -> None:
        """Block until the device has finished this flush (no readback)."""
        for _, event in list(self._pending):
            if event is not None:
                event.synchronize()

    def consume(self, lanes: int) -> bool:
        """Mark `lanes` result lanes as read; True once all are."""
        self._outstanding -= lanes
        return self._outstanding <= 0


class CUDACSP(CSP):
    """Batched ECDSA-P256 verification on a CUDA card (SPI of TPUCSP).

    `device` defaults to the card; on a host without CUDA the constructor
    raises.  `device="cpu"` runs the kernel's plain PyTorch version, for
    tests."""

    def __init__(
        self,
        device="cuda",
        min_device_batch: int = 16,
        coalesce_lanes: int = 6144,
        max_chunk: int = _MAX_CHUNK,
    ):
        dev = torch.device(device)
        if dev.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "CUDACSP: no CUDA device is available (pass "
                    "device='cpu' to run the plain version)"
                )
            if dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
        elif dev.type != "cpu":
            raise ValueError(f"CUDACSP: unsupported device {dev}")
        self.device = dev
        # below this size the host verifies: a launch and its copies cost
        # more than a few pure-Python verifies
        self._min_device_batch = min_device_batch
        # pending async batches flush together once this many lanes wait
        # (or at the first collector), so pipelined callers pay one launch
        # for about two blocks
        self._coalesce = max(1, coalesce_lanes)
        self._max_chunk = max_chunk
        self._key_table = _KeyTable()
        self._keys: dict[bytes, Key] = {}
        self._pend_lock = threading.RLock()
        self._pend_batches: list = []
        self._pend_lanes = 0
        self._flushed: dict[int, _FlushResult] = {}
        self._inflight: list[_FlushResult] = []
        self._gen = 0
        # host time spent packing and enqueueing flushes, and their lanes
        self.dispatch_seconds = 0.0
        self.dispatched_lanes = 0

    # -- lifecycle ---------------------------------------------------------

    def drain(self) -> None:
        """Flush anything buffered and wait until the device has finished
        every flush dispatched so far."""
        with self._pend_lock:
            if self._pend_batches:
                self._flush_locked()
            inflight, self._inflight = self._inflight, []
        for res in inflight:
            res.wait()

    def close(self) -> None:
        self.drain()

    # -- key management / signing: host side ------------------------------

    def key_gen(self) -> P256PrivateKey:
        key = hostref.key_gen()
        self._keys[key.ski()] = key
        return key

    def key_import(self, raw: bytes, private: bool = False) -> Key:
        """Public keys as the 65-byte uncompressed point; private keys as
        the 32-byte big-endian scalar."""
        if private:
            if len(raw) != 32:
                raise ValueError("expected a 32-byte private scalar")
            d = int.from_bytes(raw, "big")
            x, y = hostref.mul_g(d)
            key: Key = P256PrivateKey(d, P256PublicKey(x, y))
        else:
            key = P256PublicKey.from_raw(raw)
        self._keys[key.ski()] = key
        return key

    def get_key(self, ski: bytes) -> Key:
        return self._keys[ski]

    def sign(self, key: Key, digest: bytes) -> bytes:
        return hostref.sign(key, digest)

    # -- hashing -----------------------------------------------------------

    def hash(self, msg: bytes) -> bytes:
        return hashlib.sha256(msg).digest()

    def hash_batch(self, msgs: Sequence[bytes]) -> list[bytes]:
        """Digests of `msgs`: B4 on this provider's device where
        `hash_on_card` says so (no bucket padding: the kernel takes any
        count and lengths, 8192 messages a launch), else hashlib."""
        if hash_on_card(msgs, self._min_device_batch):
            return sha256.sha256_batch(msgs, self.device)
        return [hashlib.sha256(m).digest() for m in msgs]

    # -- verification ------------------------------------------------------

    def verify(self, key: Key, signature: bytes, digest: bytes) -> bool:
        return hostref.verify(key, signature, digest)

    def verify_batch(self, items: Sequence[VerifyBatchItem]) -> list[bool]:
        return self.verify_batch_async(items)()

    def verify_batch_async(self, items: Sequence[VerifyBatchItem]):
        """Enqueue a batch, return its collector.

        Batches coalesce across calls into one flush: when
        `coalesce_lanes` lanes are pending, or at the first collector
        invocation.  The device runs asynchronously after the flush; a
        collector blocks only on its own flush."""
        if len(items) < self._min_device_batch:
            result = hostref.verify_batch(items)
            return lambda: result
        with self._pend_lock:
            gen = self._gen
            seg_start = self._pend_lanes
            self._pend_batches.append(items)
            self._pend_lanes += len(items)
            if self._pend_lanes >= self._coalesce:
                self._flush_locked()
        n = len(items)
        memo: list = []

        def collector():
            with self._pend_lock:
                # memo check under the lock: two first calls racing would
                # otherwise consume the flush twice
                if memo:
                    return memo[0]
                res = self._flushed.get(gen)
                if res is None:
                    self._flush_locked()
                    res = self._flushed[gen]
            mask = res.collect()
            out = mask[seg_start:seg_start + n]
            with self._pend_lock:
                if memo:
                    return memo[0]
                memo.append(out)
                if res.consume(n):
                    self._flushed.pop(gen, None)
            return out

        return collector

    def _flush_locked(self) -> None:
        """Dispatch every pending batch as one flush and advance the
        generation.  Caller holds _pend_lock."""
        items: list = []
        for b in self._pend_batches:
            items.extend(b)
        self._pend_batches = []
        self._pend_lanes = 0
        gen = self._gen
        self._gen += 1
        t0 = time.perf_counter()
        try:
            res = self._dispatch(items)
        except Exception as e:  # every collector of this flush raises it
            res = _FlushResult([], len(items), error=e)
        self.dispatch_seconds += time.perf_counter() - t0
        self.dispatched_lanes += len(items)
        self._flushed[gen] = res
        # keep only flushes whose device work nobody has waited for yet
        self._inflight = [r for r in self._inflight if r._pending]
        self._inflight.append(res)

    def _dispatch(self, items) -> _FlushResult:
        packed = p256_kernel.pack_items(items)
        shared = None
        kidx = self._key_table.assign([
            it.key.public_key() if getattr(it.key, "is_private", False)
            else it.key
            for it in items
        ])
        if kidx is not None:
            packed = {k: v for k, v in packed.items() if k not in ("qx", "qy")}
            packed["kidx"] = kidx
            shared = self._key_table.device_tables(self.device)
        else:
            # more distinct keys than the table holds: a per-flush table,
            # else keys per lane
            packed = p256_kernel.dedup_keys(packed)
        pending = []
        off = 0
        for take in _chunk_plan(len(items), self._max_chunk):
            sl = {}
            for k, v in packed.items():
                if k in p256_kernel.TABLE_KEYS:
                    sl[k] = v
                elif v.ndim == 2:
                    sl[k] = v[:, off:off + take]
                else:
                    sl[k] = v[off:off + take]
            off += take
            pending.append(self._launch(sl, shared))
        return _FlushResult(pending, len(items))

    def _launch(self, packed: dict, shared):
        """Upload one chunk, launch, queue the mask's copy back; returns
        (collect, event)."""
        t = p256_kernel.upload(packed, self.device, shared)
        mask = p256_kernel.verify_packed(t)
        if self.device.type != "cuda":
            result = mask.tolist()
            return (lambda: result), None
        host = torch.empty(mask.shape, dtype=torch.bool, pin_memory=True)
        host.copy_(mask, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))

        def collect():
            event.synchronize()
            return host.tolist()

        return collect, event


__all__ = ["CUDACSP"]
