"""CUDA CSP provider: batched ECDSA-P256 verification on the card.

`CUDACSP` keeps the SPI and the batching behaviour of the JAX package's
`TPUCSP` (`fabric_tpu/csp/tpu/provider.py`): the `min_device_batch`
host cutoff, cross-call coalescing of `verify_batch_async` batches into
one flush with idempotent per-segment collectors, chunking under
`max_chunk` with chunks placed round-robin over the cards it is given, a
persistent SKI-keyed key table held on each card, and the per-flush
fallback to a per-batch key table and then to per-lane keys when a flush
holds more than 256 distinct keys.

Device work stays asynchronous: a flush packs on the host, copies up
through pinned buffers with non_blocking copies on the current stream,
launches the kernel and queues the mask's copy back; a CUDA event marks
its end.  Only a collector waits, on that event.

Each flush is packed by the port's C++ host library
(`fabric_tpu_torch.native.marshal_batch`: DER parse, prechecks, one
batch inversion, the digits), as `TPUCSP._marshal_native` packs; the
numpy `p256_kernel.prepare_packed` is its plain version.

`hash_batch` hashes on the card (`sha256.sha256_digests`, kernel B4) from
`min_device_batch` messages up, as `TPUCSP.hash_batch` does, but only for
a batch wide enough that hashing its messages side by side, a lane
each, beats hashlib (`hash_on_card`); hashlib answers the rest, and
`hash` of one message.

Degraded mode, after `TPUCSP`'s.  A runtime device fault (a dispatch or
a collect that raises after the kernel has loaded, a faultline fault at
``tpu.dispatch``, ``tpu.collect`` or ``tpu.hash``) counts one failure in
the circuit breaker; `threshold` consecutive failures open it.  While it
is open nothing is queued for the device, and every `probe_every`-th
call first sends a two-lane probe through the kernel, which closes the
breaker once the device answers it.  The breaker's state goes to
`metrics` (`common.metrics.CSPMetrics`) and `degraded_stats`.  While
tracing is armed a flush's dispatch and each collector run under the JAX
package's ``tpu.dispatch`` and ``tpu.collect`` spans (the latter with
``lane_wall_ewma_us``), so a trace reads the same from either package;
the port's ``tpu.dispatch`` adds the flush's ``device`` and the launches
the kernels' wrappers counted in it (``launches_keytab``,
``launches_lanekeys``), so a trace read from another process counts
them.

On a card the fault raises out of every collector of the flush (or out
of `hash_batch`), and an open breaker refuses the call
(`BreakerOpenError`): the host never answers in the card's place.  On
the CPU (`device="cpu"`) the host answers as TPUCSP's does: the flush's
lanes by the host verifier (`native.ecdsa_verify_host` through
libcrypto, else the `sw` oracle, `hostref` by default), a hash batch by
hashlib, a held call by the host; a collector that finds its flush
unfinished at its deadline (a latency budget from the measured walls and
host rate) races it on the host; and `host_fraction` verifies a tail of
each flush on the host.  Every lane and digest the host answers is
counted (`degraded_stats`) and logged.  A build failure is never a
device failure: `build.KernelBuildError` and `native.NativeBuildError`
reach every collector of the flush, and the breaker does not count them.

Key generation and signing are host-side, in `hostref` (the reference's
hot path is verification at commit time).
"""

from __future__ import annotations

import hashlib
import itertools
import threading
import time
from typing import Sequence

import numpy as np
import torch

from fabric_tpu_torch import native
from fabric_tpu_torch.common import tracing
from fabric_tpu_torch.common.flogging import must_get_logger
from fabric_tpu_torch.csp import api, hostref
from fabric_tpu_torch.csp.api import (
    CSP,
    Key,
    P256PrivateKey,
    VerifyBatchItem,
)
from fabric_tpu_torch.csp.cuda import build, p256_kernel, sha256
from fabric_tpu_torch.devtools import faultline, knob_registry
from fabric_tpu_torch.devtools.lockwatch import guarded, named_rlock

_logger = must_get_logger("csp.cuda")

# What the degraded mode lets through: a kernel or host library that
# cannot build is not a device fault.
BUILD_ERRORS = (build.KernelBuildError, native.NativeBuildError)

# Largest single kernel launch.  The TPU's bucket padding is gone: a CUDA
# kernel is not recompiled per shape and masks its own ragged edge, so a
# chunk is exactly its lanes.  The limit is the JAX package's, not yet
# re-swept on the card.
_MAX_CHUNK = 8192


# hash_batch's route.  B4 hashes the messages side by side, each one's
# compressions in a chain of ~1.08 us, so a launch lasts about as long as
# the longest message's chain, while hashlib's time is the sum of every
# message's (~0.07 us a compression and ~0.5-0.9 us a message); the
# card's route also pays for writing the messages into a pinned tensor,
# the upload, the wrapper and the readback (~0.3-0.45 ms, then ~0.5-0.6 us
# a message and ~0.02-0.03 us a compression).  The card takes a batch
# only when its compressions outnumber the longest message's HASH_WIDTH
# times over, plus HASH_FIXED.  hashlib's cost a message moved by half
# between two calls on the card machine, so batches of short messages
# near the boundary go either way; HASH_FIXED keeps them on hashlib up to
# ~4000 one-block messages.  (NVIDIA H100 80GB HBM3, 700.00 W:
# `chip_smoke.py`'s routing check, `phase_hash_route`, PERF.md.)
HASH_WIDTH = 48
HASH_FIXED = 4096


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




# Host verification rate (lanes/s) the deadlines assume until real host
# verifies have been measured: libcrypto's `ecdsa_verify_host` over a
# block-shaped 8000-lane flush (4 keys) on one core of the card machine,
# beside an NVIDIA H100 80GB HBM3 at 700 W (`chip_smoke.phase_degraded`,
# PERF.md).  The JAX package's 9000 was measured for another host.
HOST_RATE_HINT = 11681.0

# Process-wide measured host verification rate (lanes/s), fed by real
# host verifies of 256 lanes or more: deadline budgets reserve race time
# from what this host delivers under its current load, not from a hint.
_host_rate_lock = threading.Lock()
_host_rate_ewma: list = [None]


def _note_host_rate(lanes: int, secs: float) -> None:
    if secs <= 0:
        return
    rate = lanes / secs
    with _host_rate_lock:
        cur = _host_rate_ewma[0]
        _host_rate_ewma[0] = rate if cur is None else 0.7 * cur + 0.3 * rate


def _measured_host_rate(default: float) -> float:
    with _host_rate_lock:
        r = _host_rate_ewma[0]
    return r if r else default


def _host_verify_batch(sw, items) -> list[bool]:
    """Host verification: libcrypto's batch (`native.ecdsa_verify_host`,
    GIL released) where it loads, else the `sw` oracle.  Feeds the
    process-wide measured host rate."""
    if not items:
        return []
    t0 = time.perf_counter()
    mask = native.ecdsa_verify_host(items)
    if mask is None:
        mask = sw.verify_batch(items)
    if len(items) >= 256:
        _note_host_rate(len(items), time.perf_counter() - t0)
    return mask


def _knob_int(name: str, default: int) -> int:
    """A registered int knob's value, `default` when unset or
    unparsable (the breaker tolerates garbage rather than refusing to
    start over a tuning knob)."""
    raw = knob_registry.raw(name).strip()
    try:
        return int(raw)
    except ValueError:
        return default


class _Breaker:
    """Degraded-mode circuit breaker over the device path.  `threshold`
    consecutive device-path failures (a dispatch raising, a flush's
    collect dying, a device hash_batch failing) open it; while open,
    verify_batch / hash_batch queue nothing for the device (the provider
    refuses them on a card and answers them on the host on the CPU), and
    every `probe_every`-th held call first sends a two-lane
    probe through the device: a probe the device completes closes the
    breaker.  Knobs: constructor arguments, else
    FABRIC_TPU_BREAKER_THRESHOLD / FABRIC_TPU_BREAKER_PROBE_EVERY.  State,
    trips, failures and probes go to a common.metrics.CSPMetrics, and are
    kept here (`failures`, `probes`) for the provider's counters."""

    def __init__(self, threshold: int | None = None,
                 probe_every: int | None = None, metrics=None):
        self.threshold = (
            threshold if threshold is not None
            else _knob_int("FABRIC_TPU_BREAKER_THRESHOLD", 3)
        )
        self.probe_every = (
            probe_every if probe_every is not None
            else _knob_int("FABRIC_TPU_BREAKER_PROBE_EVERY", 8)
        )
        self._lock = threading.Lock()
        self._consecutive = 0
        self._held = 0  # host-served calls since the last probe
        self.open = False
        self.trips = 0
        self.failures = 0
        self.probes = {"ok": 0, "fail": 0}
        self.metrics = metrics

    def set_metrics(self, metrics) -> None:
        self.metrics = metrics
        if metrics is not None:
            metrics.breaker_state.set(1 if self.open else 0)

    def record(self, ok: bool) -> None:
        """One device-path outcome (any thread)."""
        with self._lock:
            if ok:
                self._consecutive = 0
                return
            self._consecutive += 1
            self.failures += 1
            if self.metrics is not None:
                self.metrics.device_failures.add()
            if not self.open and self._consecutive >= self.threshold:
                self.open = True
                self.trips += 1
                self._held = 0
                if self.metrics is not None:
                    self.metrics.breaker_state.set(1)
                    self.metrics.breaker_trips.add()
                _logger.warning(
                    "device circuit breaker OPEN after %d consecutive "
                    "device failures; verify/hash queue nothing for the "
                    "device (probe every %d calls)",
                    self._consecutive, self.probe_every,
                )

    def probe_due(self) -> bool:
        """Count one host-served call while open; True when it is this
        call's turn to probe the device."""
        with self._lock:
            if not self.open:
                return False
            self._held += 1
            if self._held >= self.probe_every:
                self._held = 0
                return True
            return False

    def note_probe(self, ok: bool) -> None:
        result = "ok" if ok else "fail"
        with self._lock:
            self.probes[result] += 1
        if self.metrics is not None:
            self.metrics.probes.With("result", result).add()

    def close(self) -> None:
        with self._lock:
            was_open = self.open
            self.open = False
            self._consecutive = 0
            if self.metrics is not None:
                self.metrics.breaker_state.set(0)
        if was_open:
            _logger.warning(
                "device circuit breaker CLOSED: recovery probe completed "
                "on the device; resuming device dispatch"
            )


class _ProbeKey:
    """Minimal P-256 public-key duck type for the breaker probe: the
    packer, the key table and the host verifiers read only the
    coordinates and the SKI."""

    def __init__(self, x: int, y: int):
        self.x = x
        self.y = y
        self.x_bytes = x.to_bytes(32, "big")
        self.y_bytes = y.to_bytes(32, "big")
        self._ski = hashlib.sha256(
            b"\x04" + self.x_bytes + self.y_bytes
        ).digest()

    def ski(self) -> bytes:
        return self._ski

    def public_key(self) -> "_ProbeKey":
        return self

    @property
    def is_private(self) -> bool:
        return False


class _Stats:
    """The provider's degraded-mode counters (any thread)."""

    NAMES = ("host_lanes", "host_hashes", "races", "race_wins")

    def __init__(self):
        self._lock = threading.Lock()
        self.counts = dict.fromkeys(self.NAMES, 0)

    def add(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.counts[name] += n


class _FlushResult:
    """One flushed (coalesced) dispatch: per-chunk collectors, the mask
    sealed once however many segments collect it, and a count of unread
    lanes so the provider can drop it once every segment has read its
    slice.

    Its first collector materializes it (the others wait on `_wait_lock`
    and read the seal): the host tail of `host_fraction` first, then the
    ``tpu.collect`` fault point, then each chunk's mask, waited on through
    its CUDA event (GIL released).  A device phase that raises counts one
    failure in the breaker; with a host oracle (`sw`, which the provider
    passes on the CPU only) the host then answers the whole flush (the
    reseal), else every collector raises the exception.  A build error
    is always sealed as the flush's exception.

    Deadline race (a host oracle and a deadline): the collector polls the
    chunks' events until the deadline, then verifies the device lanes on
    the host in mini-batches, checking between them whether the device
    has finished; whichever finishes first supplies the mask, and a device
    mask that comes later is never read.  A `delay` tripped at
    ``tpu.collect`` (`faultline.stall`) stalls the device: its chunks
    count as unfinished until the delay ends.  The reference parks a
    waiter thread on every flush, for a TPU runtime that runs a queued
    program only while a host thread waits on it; a CUDA stream runs
    without one."""

    # host mini-batch between device-completion checks: larger for the
    # libcrypto verifier, whose per-call key setup amortizes over it
    _RACE_STEP = 192
    _RACE_STEP_NATIVE = 1024

    def __init__(self, pending, total_lanes: int,
                 host_items=(), sw=None, device_items=None,
                 deadline: float | None = None, on_device_wall=None,
                 on_device_outcome=None, stats: _Stats | None = None,
                 error: Exception | None = None):
        # [(collect() -> list[bool], end event)], the event None on the
        # CPU
        self._pending = pending
        self._events = [c[1] for c in pending if c[1] is not None]
        self._mask: list[bool] | None = None
        self._exc = error
        self._outstanding = total_lanes
        # a tail verified on the host while the device runs (host_fraction)
        self._host_items = host_items
        self._sw = sw
        # the device portion's items in lane order: the reseal and the
        # race verify them on the host
        self._device_items = device_items
        self.deadline = deadline
        # deadline calibration: called (lanes) when the device part
        # supplied the mask; the provider holds the flush's wall (the
        # plain version's, on the CPU)
        self._on_device_wall = on_device_wall
        # breaker feedback: called (ok) once per flush with a device part
        self._on_device_outcome = on_device_outcome
        self._stats = stats
        # True once the device (not the host) produced the device lanes'
        # mask: the breaker probe's success criterion
        self.device_ok = False
        self._n_device_lanes = len(device_items) if device_items else 0
        # the tpu.collect fault point's verdict: a raised fault, or the
        # time.monotonic() until which the device counts as stalled
        self._fault: Exception | None = None
        self._stall_until = 0.0
        self._wait_lock = threading.Lock()
        self._done = threading.Event()
        if error is not None:
            self._done.set()
        # set by CUDACSP.drain(): a wall completed during teardown must
        # not feed the lane-wall EWMA
        self.cancelled = False

    def _seal(self, mask: list | None, exc: Exception | None = None,
              host_lanes: int = 0) -> None:
        """Seal the result (the materializer, under `_wait_lock`) and
        drop the input references; a host answer counts its lanes."""
        self._mask = mask
        self._exc = exc
        self._pending = ()
        self._host_items = ()
        self._device_items = None
        if host_lanes and self._stats is not None:
            self._stats.add("host_lanes", host_lanes)
        self._done.set()

    def _device_done(self) -> bool:
        return self._fault is not None or (
            time.monotonic() >= self._stall_until
            and all(ev.query() for ev in self._events))

    def _await_device(self, timeout: float) -> bool:
        """Poll the device up to `timeout` seconds; True once it is done."""
        until = time.monotonic() + timeout
        while not self._device_done():
            left = until - time.monotonic()
            if left <= 0:
                return False
            time.sleep(min(left, 0.0005))
        return True

    def collect(self, deadline: float | None = None) -> list[bool]:
        if not self._done.is_set():
            with self._wait_lock:
                if not self._done.is_set():
                    self._materialize(
                        self.deadline if deadline is None else deadline)
        if self._exc is not None:
            raise self._exc
        return self._mask

    def _materialize(self, deadline: float | None) -> None:
        pending, host_items = self._pending, self._host_items
        device_items = self._device_items
        try:
            host_mask = self._host_verify(host_items) if host_items else []
        except Exception as e:
            self._seal(None, e)  # the host tail, not the device, failed
            return
        if pending:
            # the device-loss injection seam: a raised fault exercises the
            # reseal below, a delay stalls the device
            try:
                stall = faultline.stall("tpu.collect",
                                        lanes=self._n_device_lanes)
                self._stall_until = time.monotonic() + stall
            except Exception as e:
                self._fault = e
        if (deadline is not None and self._sw is not None and device_items
                and not self._await_device(deadline)):
            raced = self._host_race(device_items)
            if raced is not None:
                self._seal(raced + host_mask,
                           host_lanes=len(raced) + len(host_mask))
                return
        try:
            if self._fault is not None:
                raise self._fault
            time.sleep(max(0.0, self._stall_until - time.monotonic()))
            out: list[bool] = []
            for chunk in pending:
                out.extend(chunk[0]())
        except BUILD_ERRORS as e:
            self._seal(None, e)
            return
        except Exception as e:
            self._device_failed(e, host_mask)
            return
        if pending:
            self.device_ok = True
            if self._on_device_outcome is not None:
                self._on_device_outcome(True)
        self._seal(out + host_mask, host_lanes=len(host_mask))
        if (self._on_device_wall is not None and self._n_device_lanes
                and not host_items and not self.cancelled):
            # feed the EWMA only from pure-device flushes whose mask the
            # device supplied
            self._on_device_wall(self._n_device_lanes)

    def _device_failed(self, exc: Exception, host_mask: list) -> None:
        """A device phase raised: the breaker counts it, and the host
        answers the flush where there is a host oracle; else every
        collector raises `exc`."""
        if self._on_device_outcome is not None:
            self._on_device_outcome(False)
        items = self._device_items
        if self._sw is None or items is None:
            _logger.warning("device collect of %d lanes failed; every "
                            "collector of the flush raises",
                            self._n_device_lanes, exc_info=exc)
            self._seal(None, exc)
            return
        _logger.warning("device collect of %d lanes failed; the host "
                        "answers the flush", len(items), exc_info=exc)
        try:
            out = list(self._host_verify(items)) + host_mask
        except Exception as e:
            self._seal(None, e)
            return
        self._seal(out, host_lanes=len(out))

    def _host_verify(self, items):
        return _host_verify_batch(self._sw, items)

    def _host_race(self, items) -> list[bool] | None:
        """Deadline expired: verify the device lanes on the host, yielding
        to device completion between mini-batches.  The host's mask, or
        None when the device finished first."""
        if self._stats is not None:
            self._stats.add("races")
        step = (self._RACE_STEP_NATIVE if native.ecdsa_impl() == "libcrypto"
                else self._RACE_STEP)
        out: list[bool] = []
        for off in range(0, len(items), step):
            if self._device_done():
                return None  # the device finished after all: use it
            out.extend(self._host_verify(items[off:off + step]))
        _logger.warning("device flush of %d lanes missed its deadline; the "
                        "host race answered it", len(items))
        if self._stats is not None:
            self._stats.add("race_wins")
        return out

    def busy(self) -> bool:
        """True while the device has chunks of this flush unfinished."""
        return not all(ev.query() for ev in self._events)

    def idle(self, until: float | None) -> bool:
        """Wait until the device's chunks are done; False at `until`
        (time.monotonic(), None = no limit)."""
        for ev in self._events:
            if until is None:
                # fabriclint: allow[device-hygiene] one wait a chunk of one
                # flush (the loop runs over its few chunks, never its lanes):
                # the flush's completion, not a per-item sync
                ev.synchronize()
                continue
            while not ev.query():
                if time.monotonic() >= until:
                    return False
                time.sleep(0.0005)
        return True

    def consume(self, lanes: int) -> bool:
        """Mark `lanes` result lanes as read; True once all are."""
        self._outstanding -= lanes
        return self._outstanding <= 0


class BreakerOpenError(RuntimeError):
    """verify/hash refused on a card while the circuit breaker is open:
    the card failed `threshold` times in a row and no probe has seen it
    answer since.  (On the CPU the host answers instead.)"""


class CUDACSP(CSP):
    """Batched ECDSA-P256 verification on CUDA cards (SPI of TPUCSP).

    `device` defaults to the card: "cuda" is the current card, "cuda:N"
    card N, and a list of cards places chunk after chunk, flush after
    flush, on the next card of the list; on a host without CUDA the
    constructor raises.  `device="cpu"` runs the kernel's plain PyTorch
    version, for tests, and only there does the host answer for a faulty
    device (see the module's docstring).  `sw` is the host oracle of small
    batches and of that host answer where no libcrypto loads (`hostref`
    by default); the other arguments are `TPUCSP`'s, and `host_fraction`
    must stay 0 on a card."""

    def __init__(
        self,
        device="cuda",
        min_device_batch: int = 16,
        coalesce_lanes: int = 6144,
        max_chunk: int = _MAX_CHUNK,
        sw=None,
        host_fraction: float = 0.0,
        stall_factor: float | None = 1.0,
        host_rate_hint: float = HOST_RATE_HINT,
        breaker_threshold: int | None = None,
        breaker_probe_every: int | None = None,
        metrics=None,
    ):
        devices = [torch.device(d) for d in (
            device if isinstance(device, (list, tuple)) else [device])]
        kinds = {d.type for d in devices}
        if kinds == {"cuda"}:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "CUDACSP: no CUDA device is available (pass "
                    "device='cpu' to run the plain version)"
                )
            devices = [d if d.index is not None
                       else torch.device("cuda", torch.cuda.current_device())
                       for d in devices]
        elif kinds != {"cpu"}:
            raise ValueError(f"CUDACSP: unsupported devices {devices}")
        self.device = devices[0]
        # each chunk takes the next device of the list, across flushes
        self._devices = devices
        self._place = itertools.count()
        self.last_dispatch_devices: tuple = ()
        # the degraded mode's host answers (the reseal, the race, the
        # breaker's host route, host_fraction, hashlib for a failed hash)
        # are the CPU's alone: on a card a runtime fault raises
        self._host_answers = self.device.type == "cpu"
        if host_fraction > 0 and not self._host_answers:
            raise ValueError("CUDACSP: host_fraction moves lanes off the "
                             "card; it needs device='cpu'")
        self._sw = sw if sw is not None else hostref
        # below this size the host verifies: a launch and its copies cost
        # more than a few host verifies
        self._min_device_batch = min_device_batch
        # pending async batches flush together once this many lanes wait
        # (or at the first collector), so pipelined callers pay one launch
        # for about two blocks
        self._coalesce = max(1, coalesce_lanes)
        self._max_chunk = max_chunk
        # share of each flush of 2048 lanes or more verified on the host
        # while the device runs; 0 by default, as the reference's
        self._host_fraction = host_fraction
        # stall deadline: 1.5x the EWMA-predicted flush wall (floor
        # 0.15 s), capped by the host anchor stall_factor * lanes /
        # host rate (see _deadline_for); None disarms the race
        self._stall_factor = stall_factor
        self._host_rate = host_rate_hint
        self._lane_wall_ewma: float | None = None  # s/lane, device flushes
        self._ewma_lock = threading.Lock()
        self._breaker = _Breaker(breaker_threshold, breaker_probe_every,
                                 metrics)
        self._stats = _Stats()
        self._probe_cache: list | None = None
        self._key_table = _KeyTable()
        # keys live in the host route's provider when `sw` is one (its
        # keystore: a node's file keystore), else in hostref's over an
        # in-memory keystore
        self._host = (sw if isinstance(sw, hostref.HostCSP)
                      else hostref.HostCSP())
        # the coalescing state behind this lock is asserted with
        # lockwatch.guarded under FABRIC_TPU_LOCKWATCH
        self._pend_lock = named_rlock("csp.tpu.pend")
        self._pend_batches: list = []
        self._pend_lanes = 0
        self._flushed: dict[int, _FlushResult] = {}
        self._inflight: list[_FlushResult] = []
        self._gen = 0
        # host time spent packing and enqueueing flushes, and their lanes
        self.dispatch_seconds = 0.0
        self.dispatched_lanes = 0

    # -- lifecycle ---------------------------------------------------------

    def set_metrics(self, metrics) -> None:
        """Bind a common.metrics.CSPMetrics so the breaker's state, trips,
        probes and device failures surface on /metrics."""
        self._breaker.set_metrics(metrics)

    @property
    def breaker(self) -> _Breaker:
        """The degraded-mode circuit breaker."""
        return self._breaker

    @property
    def breaker_open(self) -> bool:
        """True while verify/hash are served by the host."""
        return self._breaker.open

    def degraded_stats(self) -> dict:
        """What the host answered in the device's place: verify lanes
        (`host_lanes`: resealed flushes, race wins, the breaker's host
        route and host_fraction's tail), hash messages (`host_hashes`),
        deadline races started and won, and the breaker's device
        failures, trips and probes."""
        b = self._breaker
        with self._stats._lock:
            out = dict(self._stats.counts)
        out.update(device_failures=b.failures, trips=b.trips,
                   probes_ok=b.probes["ok"], probes_fail=b.probes["fail"])
        return out

    def health_checker(self):
        """A health check that fails while the breaker is open: an
        operator's health rollup surfaces it (on the CPU the provider
        still serves, from the host)."""

        def check() -> bool:
            if self._breaker.open:
                raise RuntimeError(
                    "CUDA degraded: circuit breaker open after "
                    f"{self._breaker.trips} trip(s); verify/hash "
                    + ("served by the host" if self._host_answers
                       else "refused until a probe sees the card answer")
                )
            return True

        return check

    def drain(self, timeout: float | None = 60.0) -> bool:
        """Flush anything buffered and wait until the device has finished
        every flush dispatched so far.  Each
        in-flight flush is marked cancelled first, so a wall completed
        during teardown never feeds the EWMA.  Returns True when all
        finished inside `timeout` (None = no limit); False leaves the
        stragglers running."""
        until = None if timeout is None else time.monotonic() + timeout
        while True:
            with self._pend_lock:
                if self._pend_batches:
                    self._flush_locked()
                for res in self._inflight:
                    res.cancelled = True
                live = [r for r in self._inflight if r.busy()]
                if not live:
                    self._inflight = []
                    return True
            for res in live:
                if not res.idle(until):
                    with self._pend_lock:
                        self._inflight = [r for r in self._inflight
                                          if r.busy()]
                    return False

    def close(self) -> None:
        """drain() with no time limit."""
        self.drain(timeout=None)

    # -- key management / signing: host side ------------------------------

    def key_gen(self) -> P256PrivateKey:
        return self._host.key_gen()

    def key_import(self, raw: bytes, private: bool = False) -> Key:
        """Public keys as the 65-byte uncompressed point; private keys as
        the 32-byte big-endian scalar."""
        return self._host.key_import(raw, private=private)

    def get_key(self, ski: bytes) -> Key:
        return self._host.get_key(ski)

    def sign(self, key: Key, digest: bytes) -> bytes:
        return self._host.sign(key, digest)

    # -- hashing -----------------------------------------------------------

    def hash(self, msg: bytes) -> bytes:
        return hashlib.sha256(msg).digest()

    def hash_batch(self, msgs: Sequence[bytes]) -> list[bytes]:
        """Digests of `msgs`: B4 on this provider's device where
        `hash_on_card` says so (no bucket padding: the kernel takes any
        count and lengths, 8192 messages a launch), else hashlib.  On the
        card's route a runtime fault of the device counts in the breaker
        and raises, and an open breaker raises BreakerOpenError; on the
        CPU hashlib answers both (counted).  A build failure raises."""
        if not hash_on_card(msgs, self._min_device_batch):
            return [hashlib.sha256(m).digest() for m in msgs]
        if self._breaker_gate():
            # open breaker: the gate ran the recovery probe when due, so
            # hash-only traffic can close it too
            self._refuse_on_card(len(msgs))
            self._stats.add("host_hashes", len(msgs))
            return [hashlib.sha256(m).digest() for m in msgs]
        try:
            faultline.point("tpu.hash", n=len(msgs))
            out = sha256.sha256_batch(msgs, self.device)
        except BUILD_ERRORS:
            raise
        except Exception:
            self._breaker.record(False)
            if not self._host_answers:
                raise
            _logger.warning(
                "device hash_batch failed; served %d digests from hashlib",
                len(msgs), exc_info=True,
            )
            self._stats.add("host_hashes", len(msgs))
            return [hashlib.sha256(m).digest() for m in msgs]
        self._breaker.record(True)
        return out

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
        collector blocks only on its own flush.  While the breaker is
        open nothing is queued for the device: on a card the call raises
        BreakerOpenError, on the CPU the host answers."""
        if len(items) < self._min_device_batch:
            result = _host_verify_batch(self._sw, list(items))
            return lambda: result
        if self._breaker_gate():
            # degraded mode: the gate ran this call's probe if it was due
            self._refuse_on_card(len(items))
            mask = _host_verify_batch(self._sw, list(items))
            self._stats.add("host_lanes", len(items))
            return lambda: mask
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
                # the sole flush in flight (a serial per-block caller):
                # the host is idle, so the tighter absolute budget applies
                sole = len(self._flushed) <= 1 and not self._pend_batches
            deadline = None
            if sole and res.deadline is not None:
                deadline = self._sole_deadline_for(res._n_device_lanes)
            # outside the lock: a race's host verify must not serialize
            # pipelined callers.  The span names are the JAX package's
            with tracing.span("tpu.collect", batch=gen, lanes=n,
                              device_lanes=res._n_device_lanes):
                mask = res.collect(deadline)
                if tracing.enabled():
                    with self._ewma_lock:
                        wall = self._lane_wall_ewma
                    if wall is not None:
                        tracing.annotate(lane_wall_ewma_us=wall * 1e6)
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
        guarded(self, "_pend_batches", by="csp.tpu.pend")
        items: list = []
        for b in self._pend_batches:
            items.extend(b)
        self._pend_batches = []
        self._pend_lanes = 0
        gen = self._gen
        self._gen += 1
        t0 = time.perf_counter()
        counts = (p256_kernel.launches_keytab, p256_kernel.launches_lanekeys)
        try:
            with tracing.span("tpu.dispatch", batch=gen, lanes=len(items)):
                try:
                    res = self._dispatch(items)
                finally:
                    if tracing.enabled():
                        # the launches the kernels' wrappers counted in
                        # this flush, and where it ran: what a reader of
                        # another process's trace counts launches by
                        tracing.annotate(
                            device=str(self.device),
                            launches_keytab=(p256_kernel.launches_keytab
                                             - counts[0]),
                            launches_lanekeys=(
                                p256_kernel.launches_lanekeys - counts[1]))
        except BUILD_ERRORS as e:
            # every collector of this flush raises it
            res = _FlushResult([], len(items), error=e)
        except Exception as e:
            # a failed dispatch must not strand the coalesced batches'
            # collectors: each raises it on a card; on the CPU the host
            # answers the whole flush, lazily
            self._breaker.record(False)
            if not self._host_answers:
                _logger.warning("device dispatch of %d lanes failed; every "
                                "collector of the flush raises", len(items),
                                exc_info=True)
                res = _FlushResult([], len(items), error=e)
            else:
                _logger.warning("device dispatch of %d lanes failed; the "
                                "host answers the flush", len(items),
                                exc_info=True)
                res = _FlushResult([], len(items), host_items=items,
                                   sw=self._sw, stats=self._stats)
        self.dispatch_seconds += time.perf_counter() - t0
        self.dispatched_lanes += len(items)
        self._flushed[gen] = res
        self._inflight = [r for r in self._inflight if r.busy()]
        self._inflight.append(res)

    # A fixed known-good P-256 vector (the reference's): key and signature
    # of digest SHA-256("faultline-breaker-probe"), so the probe needs no
    # signer.
    _PROBE_QX = 0x46464CED59A558637321A8AB0D957C71C46162990C1311469A8FC24032FEC1E3
    _PROBE_QY = 0xDE57524FDD4A8DBC03E77BE70FAA656B2F12A7B34BA3CCAADBC042640104E4ED
    _PROBE_R = 0x2C63F9FD69C2C999966BDF5ACEB3E114A42C852AB7AF88870E7D29CB4C5AC471
    _PROBE_S = 0x767B9BC011A2EC87635DFEAB8334A15995113A67176CA4D02F706D316C9EB86F

    def _probe_items(self) -> list:
        """The probe batch: one fixed key and signature on two lanes (the
        key takes one slot of the key table)."""
        if self._probe_cache is None:
            key = _ProbeKey(self._PROBE_QX, self._PROBE_QY)
            digest = self.hash(b"faultline-breaker-probe")
            sig = api.marshal_ecdsa_signature(self._PROBE_R, self._PROBE_S)
            item = VerifyBatchItem(key, digest, sig)
            self._probe_cache = [item, item]
        return self._probe_cache

    def _refuse_on_card(self, lanes: int) -> None:
        """The open breaker's answer on a card: raise, queue nothing."""
        if not self._host_answers:
            raise BreakerOpenError(
                f"CUDACSP: circuit breaker open after {self._breaker.trips} "
                f"trip(s); {lanes} lanes refused, nothing queued on "
                f"{self.device}")

    def _breaker_gate(self) -> bool:
        """While the breaker is open, run the recovery probe when due;
        True when this call must be served by the host (still open)."""
        if not self._breaker.open:
            return False
        if self._breaker.probe_due():
            ok = self._probe_device()
            self._breaker.note_probe(ok)
            if ok:
                self._breaker.close()
        return self._breaker.open

    def _probe_device(self) -> bool:
        """One probe batch through the kernel, collected at once; True
        only when the device (not the host) produced an all-valid mask.
        A build failure raises."""
        try:
            res = self._dispatch(list(self._probe_items()), race=False)
        except BUILD_ERRORS:
            raise
        except Exception:
            return False
        try:
            mask = res.collect()
        except BUILD_ERRORS:
            raise
        except Exception:
            return False
        return res.device_ok and all(mask)

    def _dispatch(self, items, race: bool = True) -> _FlushResult:
        faultline.point("tpu.dispatch", lanes=len(items))
        # host_fraction: a tail of the flush verified on the host while
        # the device runs
        host_items: Sequence[VerifyBatchItem] = ()
        if self._host_fraction > 0 and len(items) >= 2048:
            h = int(len(items) * self._host_fraction)
            if h:
                host_items = items[len(items) - h:]
                items = items[:len(items) - h]
        packed = p256_kernel.pack_items(items)
        kidx = self._key_table.assign([
            it.key.public_key() if getattr(it.key, "is_private", False)
            else it.key
            for it in items
        ])
        if kidx is not None:
            packed = {k: v for k, v in packed.items() if k not in ("qx", "qy")}
            packed["kidx"] = kidx
        else:
            # more distinct keys than the table holds: a per-flush table,
            # else keys per lane
            packed = p256_kernel.dedup_keys(packed)
        used: list = []
        pending = []
        off = 0
        t0 = time.perf_counter()
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
            dev = self._devices[next(self._place) % len(self._devices)]
            if len(self._devices) > 1:
                used.append(dev)
            pending.append(self._launch(sl, dev, kidx is not None))
        self.last_dispatch_devices = tuple(dict.fromkeys(used))
        wall = time.perf_counter() - t0  # the plain version ran in it
        host = self._host_answers
        return _FlushResult(
            pending, len(items) + len(host_items),
            host_items=host_items, sw=self._sw if host else None,
            device_items=list(items),
            deadline=self._deadline_for(len(items)) if host and race
            else None,
            on_device_wall=(lambda n: self._note_device_wall(n, wall))
            if host else None,
            on_device_outcome=self._breaker.record,
            stats=self._stats,
        )

    def _launch(self, packed: dict, dev: torch.device, keytab: bool):
        """Upload one chunk to `dev`, launch, queue the mask's copy back;
        returns (collect, end event), the event None on the CPU, where the
        plain version has run by the time this returns."""
        if dev.type != "cuda":
            shared = self._key_table.device_tables(dev) if keytab else None
            result = p256_kernel.verify_packed(
                p256_kernel.upload(packed, dev, shared)).tolist()
            return (lambda: result), None
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev)
            shared = self._key_table.device_tables(dev) if keytab else None
            mask = p256_kernel.verify_packed(
                p256_kernel.upload(packed, dev, shared))
            host = torch.empty(mask.shape, dtype=torch.bool, pin_memory=True)
            host.copy_(mask, non_blocking=True)
            end = torch.cuda.Event()
            end.record(stream)

        def collect():
            end.synchronize()
            return host.tolist()

        return collect, end

    # -- deadlines -----------------------------------------------------------

    def _note_device_wall(self, lanes: int, wall: float) -> None:
        """EWMA of the per-lane device flush wall, fed only by flushes the
        device completed."""
        if lanes <= 0 or wall <= 0:
            return
        per_lane = wall / lanes
        with self._ewma_lock:
            cur = self._lane_wall_ewma
            self._lane_wall_ewma = (
                per_lane if cur is None else 0.7 * cur + 0.3 * per_lane
            )

    def _deadline_for(self, lanes: int) -> float | None:
        """Per-flush latency budget: 1.5x the EWMA-predicted wall,
        floored at 0.15 s, capped by the host anchor (stall_factor x the
        host's time for the lanes, at least 0.2 s)."""
        if self._stall_factor is None:
            return None
        anchor = max(
            0.2,
            self._stall_factor * lanes / _measured_host_rate(self._host_rate),
        )
        with self._ewma_lock:
            per_lane = self._lane_wall_ewma
        if per_lane is None:
            return anchor
        return max(0.15, min(1.5 * per_lane * lanes, anchor))

    # absolute latency budget of a sole flush (a serial per-block caller,
    # the p99 path): deadline + the host race stay under ~420 ms, with
    # the race reserved at the measured host rate
    _SOLE_BUDGET_S = 0.42

    def _sole_deadline_for(self, lanes: int) -> float | None:
        base = self._deadline_for(lanes)
        if base is None:
            return None
        race_est = lanes / _measured_host_rate(self._host_rate)
        return max(0.05, min(base, self._SOLE_BUDGET_S - race_est))


__all__ = ["CUDACSP", "BreakerOpenError", "BUILD_ERRORS", "HOST_RATE_HINT"]
