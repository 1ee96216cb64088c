"""Gateway core: admission, dedup, pipelined broadcast, failover and
commit-status tracking (the port's copy of `fabric_tpu/gateway/core.py`;
reference gateway/gateway.go, gateway/api Submit and CommitStatus).

- **Admission with backpressure**: a bounded window of unresolved txids
  that follows the commit rate the deliver tail observes (``window =
  commit_rate x horizon``, clamped); past it, `submit` rejects with a
  retry-after hint.
- **Txid dedup**: an in-flight or recently resolved txid is answered
  from the dedup map; a duplicate that is ordered anyway is flagged by
  the validator, and the tracker keeps the first resolution.
- **Pipelined broadcast**: one duplex ``ab.BroadcastStream`` to the
  current orderer, envelopes written back to back under a credit cap on
  unacked frames, acks drained by a reader thread.
- **Failover in a fixed order**: on stream loss the sender moves to the
  next orderer by index behind a ``BackoffGate`` and resubmits every
  sent and unresolved envelope.
- **Commit status**: a ``DeliverClient`` tails a peer's blocks (their
  flags are the validator's) and resolves each txid to VALID or INVALID;
  a wait that expires, or `stop`, resolves it to TIMEOUT.

Seams: faultline points ``gateway.admission``, ``gateway.stream.write``,
``gateway.failover`` and ``gateway.status.resolve``; the
``gateway.submit`` and ``gateway.resolve`` spans; clockskew on every
wait.
"""

from __future__ import annotations

import collections
import dataclasses
import threading

from fabric_tpu_torch import protoutil
from fabric_tpu_torch.comm.backoff import BackoffGate
from fabric_tpu_torch.comm.rpc import RPCClient
from fabric_tpu_torch.common import tracing
from fabric_tpu_torch.devtools import clockskew, faultline
from fabric_tpu_torch.devtools.lockwatch import named_lock, spawn_thread
from fabric_tpu_torch.peer.deliverclient import DeliverClient
from fabric_tpu_torch.protos import common as cb

STATUS_PENDING = "PENDING"
STATUS_VALID = "VALID"
STATUS_INVALID = "INVALID"
STATUS_TIMEOUT = "TIMEOUT"


def txid_of(env_bytes: bytes) -> str:
    """The envelope's channel-header txid ("" when unparseable)."""
    try:
        env = cb.Envelope.decode(env_bytes)
        return protoutil.channel_header(env).tx_id
    except Exception:  # malformed envelope: admitted under txid ""
        return ""


def orderer_stream_connect(endpoint, timeout: float = 10.0, tls=None):
    """The connect factory of one orderer's ``ab.BroadcastStream`` over
    comm's framed RPC (mutual TLS with `tls`)."""

    def connect():
        return RPCClient(endpoint[0], int(endpoint[1]), timeout=timeout,
                         tls=tls).duplex("ab.BroadcastStream")

    return connect


class _TxRecord:
    __slots__ = ("txid", "env", "status", "event", "t_submit", "sent")

    def __init__(self, txid: str, env: bytes, now: float):
        self.txid = txid
        self.env = env
        self.status = STATUS_PENDING
        self.event = threading.Event()
        self.t_submit = now
        self.sent = False


@dataclasses.dataclass(frozen=True)
class SubmitResult:
    """What `submit` tells the client: accepted (queued or dedup-hit,
    with the txid's status as of the call) or rejected for
    backpressure (retry after the hinted delay)."""

    accepted: bool
    txid: str
    status: str = STATUS_PENDING
    retry_after_s: float = 0.0
    dedup: bool = False


class Gateway:
    """The embeddable gateway: construct, `start()`, then `submit` /
    `submit_and_wait` from any number of client threads.

    ``orderer_connects`` is an ordered list of zero-arg callables
    returning a duplex stream handle (``send``/``recv``/``finish``/
    ``close``) — :func:`orderer_stream_connect` for real orderers,
    in-process fakes in tests.  ``deliver_endpoints`` are
    ``DeliverClient``-style callables ``start_num -> iterator of
    Block`` and should point at PEERS: peer blocks carry
    post-validation flags, which is what makes a VALID/INVALID verdict
    possible.  Pass ``deliver_endpoints=None`` to run without the tail
    (tests resolve via :meth:`observe_block` directly)."""

    def __init__(
        self,
        channel_id: str,
        orderer_connects,
        deliver_endpoints=None,
        start_height: int = 0,
        name: str = "gateway",
        metrics=None,          # common.metrics.GatewayMetrics | None
        min_window: int = 64,
        max_window: int = 4096,
        initial_window: int = 256,
        window_horizon_s: float = 2.0,
        resolved_cache: int = 8192,
        max_backoff_s: float = 2.0,
        max_unacked: int = 256,
    ):
        self.channel_id = channel_id
        self.name = name
        self._connects = list(orderer_connects)
        if not self._connects:
            raise ValueError("gateway needs at least one orderer")
        self._metrics = metrics
        self._min_window = max(1, min_window)
        self._max_window = max(self._min_window, max_window)
        self._horizon = window_horizon_s
        self._resolved_cap = resolved_cache
        self._max_unacked = max_unacked

        # guards every mutable shared field below (records/resolved/
        # sendq/window state/credits); ordered before nothing — the
        # gateway never enters the ledger or gossip planes
        self._lock = named_lock("gateway.records")
        self._records: dict[str, _TxRecord] = {}
        self._resolved: collections.OrderedDict[str, str] = (
            collections.OrderedDict()
        )
        self._sendq: collections.deque[_TxRecord] = collections.deque()
        self._unacked = 0
        self._window = max(
            self._min_window, min(self._max_window, initial_window)
        )
        self._rate = 0.0            # EWMA committed tx/s off the tail
        self._last_block_t: float | None = None
        self._tail_height = start_height

        self._stop = threading.Event()
        self._work = threading.Event()      # sendq non-empty
        self._ack_event = threading.Event()  # credits released
        self._stream_dead = threading.Event()
        self._gen = 0                        # stream generation
        self._rot = 0                        # deterministic rotation pos
        self._gate = BackoffGate.for_key(
            f"{name}->orderers", cap=max_backoff_s
        )
        self._sender: threading.Thread | None = None
        # the orderer indices connected, in order, and the failovers
        self.endpoint_log: collections.deque = collections.deque(maxlen=64)
        self.failovers = 0

        self._deliver = None
        if deliver_endpoints:
            self._deliver = DeliverClient(
                channel_id,
                list(deliver_endpoints),
                height_fn=self._tail,
                sink=self.observe_block,
                max_backoff_s=max_backoff_s,
            )

    def _tail(self) -> int:
        with self._lock:
            return self._tail_height

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        self._sender = spawn_thread(
            target=self._sender_loop, name="gateway-sender",
            kind="service",
        )
        self._sender.start()
        if self._deliver is not None:
            self._deliver.start()

    def stop(self) -> None:
        """Stop threads and resolve every still-pending record to
        TIMEOUT — shutdown reports, it never silently drops."""
        self._stop.set()
        # wakeups move under the state lock (as everywhere): re-arms in
        # the sender/credit loops clear-then-recheck under the same
        # lock, so no set() can fall into a clear window
        with self._lock:
            self._work.set()
            self._ack_event.set()
        if self._sender is not None:
            self._sender.join(timeout=5)
        if self._deliver is not None:
            self._deliver.stop()
        now = clockskew.monotonic()
        with self._lock:
            for rec in list(self._records.values()):
                self._resolve_locked(rec, STATUS_TIMEOUT, now)

    # -- client surface ----------------------------------------------------

    def submit(self, env_bytes: bytes, txid: str | None = None) -> SubmitResult:
        """Admit one envelope.  Idempotent per txid; rejects with a
        retry-after hint once the adaptive in-flight window fills."""
        if txid is None:
            txid = txid_of(env_bytes)
        faultline.point("gateway.admission", txid=txid)
        now = clockskew.monotonic()
        m = self._metrics
        with tracing.span("gateway.submit", txid=txid), self._lock:
            rec = self._records.get(txid)
            if rec is not None:
                if m is not None:
                    m.dedup_hits.With("channel", self.channel_id).add()
                return SubmitResult(True, txid, rec.status, dedup=True)
            done = self._resolved.get(txid)
            if done is not None:
                if m is not None:
                    m.dedup_hits.With("channel", self.channel_id).add()
                return SubmitResult(True, txid, done, dedup=True)
            if len(self._records) >= self._window:
                retry = self._retry_after_locked()
                if m is not None:
                    m.rejections.With("channel", self.channel_id).add()
                return SubmitResult(
                    False, txid, STATUS_PENDING, retry_after_s=retry
                )
            rec = _TxRecord(txid, env_bytes, now)
            self._records[txid] = rec
            self._sendq.append(rec)
            if m is not None:
                m.in_flight.With("channel", self.channel_id).set(
                    len(self._records)
                )
                m.queue_depth.With("channel", self.channel_id).set(
                    len(self._sendq)
                )
            self._work.set()
        return SubmitResult(True, txid, STATUS_PENDING)

    def wait(self, txid: str, timeout: float) -> str:
        """Block (clockskew-routed) until the txid resolves; a wait
        that expires resolves the record to TIMEOUT — definitive
        either way."""
        with self._lock:
            rec = self._records.get(txid)
            if rec is None:
                return self._resolved.get(txid, STATUS_TIMEOUT)
        clockskew.wait(rec.event, timeout)
        if not rec.event.is_set():
            now = clockskew.monotonic()
            with self._lock:
                if rec.status == STATUS_PENDING:
                    self._resolve_locked(rec, STATUS_TIMEOUT, now)
        return rec.status

    def submit_and_wait(
        self, env_bytes: bytes, txid: str | None = None,
        timeout: float = 30.0,
    ) -> str:
        """The reference Gateway's SubmitTransaction in one call:
        admit (retrying through backpressure within the timeout
        budget), then wait for the commit status."""
        if txid is None:
            txid = txid_of(env_bytes)
        deadline = clockskew.monotonic() + timeout
        while True:
            res = self.submit(env_bytes, txid=txid)
            if res.accepted:
                break
            left = deadline - clockskew.monotonic()
            if left <= 0:
                return STATUS_TIMEOUT
            if clockskew.wait(self._stop, min(res.retry_after_s, left)):
                return STATUS_TIMEOUT
        left = deadline - clockskew.monotonic()
        if res.dedup and res.status != STATUS_PENDING:
            return res.status
        return self.wait(txid, max(left, 0.0))

    def status(self, txid: str) -> str | None:
        """Last known status for a txid (None = never seen)."""
        with self._lock:
            rec = self._records.get(txid)
            if rec is not None:
                return rec.status
            return self._resolved.get(txid)

    @property
    def in_flight(self) -> int:
        with self._lock:
            return len(self._records)

    @property
    def window(self) -> int:
        with self._lock:
            return self._window

    # -- commit-status tracker --------------------------------------------

    def observe_block(self, seq: int, block_bytes: bytes) -> None:
        """Deliver-tail sink: resolve every tracked txid the block
        carries and feed the adaptive window.  Blocks MUST come from a
        source whose metadata carries post-validation flags (a peer)."""
        faultline.point("gateway.status.resolve", block=seq)
        blk = cb.Block.decode(block_bytes)
        flags = list(protoutil.tx_filter(blk))
        now = clockskew.monotonic()
        with tracing.span(
            "gateway.resolve", block=seq, channel=self.channel_id,
        ), self._lock:
            if seq < self._tail_height:
                return  # replayed block: already accounted
            self._tail_height = seq + 1
            for i, env_bytes in enumerate(blk.data.data):
                txid = txid_of(env_bytes)
                rec = self._records.get(txid)
                if rec is None or rec.status != STATUS_PENDING:
                    continue  # untracked, or first copy already ruled
                ok = i < len(flags) and flags[i] == 0
                self._resolve_locked(
                    rec, STATUS_VALID if ok else STATUS_INVALID, now
                )
            self._observe_commit_locked(len(blk.data.data), now)

    def _resolve_locked(self, rec: _TxRecord, status: str, now: float) -> None:
        rec.status = status
        self._records.pop(rec.txid, None)
        self._resolved[rec.txid] = status
        while len(self._resolved) > self._resolved_cap:
            self._resolved.popitem(last=False)
        m = self._metrics
        if m is not None:
            m.resolved.With(
                "channel", self.channel_id, "status", status
            ).add()
            m.in_flight.With("channel", self.channel_id).set(
                len(self._records)
            )
            if status in (STATUS_VALID, STATUS_INVALID):
                m.submit_to_commit_seconds.With(
                    "channel", self.channel_id
                ).observe(max(now - rec.t_submit, 0.0))
        rec.event.set()

    def _observe_commit_locked(self, ntx: int, now: float) -> None:
        if self._last_block_t is not None:
            dt = max(now - self._last_block_t, 1e-6)
            inst = ntx / dt
            self._rate = (
                inst if self._rate == 0.0
                else 0.3 * inst + 0.7 * self._rate
            )
        self._last_block_t = now
        w = int(self._rate * self._horizon)
        self._window = max(self._min_window, min(self._max_window, w))
        if self._metrics is not None:
            self._metrics.window.With("channel", self.channel_id).set(
                self._window
            )

    def _retry_after_locked(self) -> float:
        # one commit-batch's worth of draining at the observed rate;
        # bounded so clients neither spin nor stall when rate is noisy
        if self._rate <= 0.0:
            return 0.05
        return min(1.0, max(0.005, 16.0 / self._rate))

    # -- sender / failover -------------------------------------------------

    def _sender_loop(self) -> None:
        stream = None
        reader: threading.Thread | None = None
        try:
            while not self._stop.is_set():
                if not self._work.wait(timeout=0.05):
                    continue
                if stream is not None and self._stream_dead.is_set():
                    stream, reader = self._failover(stream, reader)
                if stream is None:
                    stream, reader = self._connect()
                    if stream is None:
                        continue  # stop set, or backoff window armed
                rec = self._next_record()
                if rec is None:
                    # clear-then-recheck atomically under the state
                    # lock: submit()'s append+set holds the same lock,
                    # so a set() can never fall into the clear window
                    with self._lock:
                        self._work.clear()
                        if self._sendq:
                            self._work.set()
                    continue
                try:
                    # inside the try deliberately: an armed raise here
                    # IS a torn mid-stream write — it must take the
                    # same requeue-and-failover path a real one does
                    faultline.point("gateway.stream.write", txid=rec.txid)
                    stream.send(rec.env)
                except Exception:
                    # torn stream: requeue THIS record with the rest
                    with self._lock:
                        rec.sent = True
                        self._stream_dead.set()
                    continue
                with self._lock:
                    rec.sent = True
                    self._unacked += 1
                    if self._metrics is not None:
                        self._metrics.queue_depth.With(
                            "channel", self.channel_id
                        ).set(len(self._sendq))
                self._wait_credit()
        finally:
            if stream is not None:
                try:
                    stream.finish()
                except Exception:
                    pass
                stream.close()
            if reader is not None:
                reader.join(timeout=3)

    def _next_record(self) -> _TxRecord | None:
        with self._lock:
            while self._sendq:
                rec = self._sendq.popleft()
                if rec.status == STATUS_PENDING:
                    return rec
        return None

    def _wait_credit(self) -> None:
        """Flow control: cap unacked frames per stream so a slow or
        dead orderer cannot absorb the whole admission window."""
        while not self._stop.is_set():
            with self._lock:
                if self._unacked < self._max_unacked:
                    return
                # every _ack_event.set() holds this same lock, so the
                # re-arm cannot swallow a wakeup
                self._ack_event.clear()
            if self._stream_dead.is_set():
                return
            self._ack_event.wait(timeout=0.05)

    def _connect(self):
        """Deterministic rotation: next orderer in index order, gated
        by decorrelated backoff after failures."""
        n = len(self._connects)
        while not self._stop.is_set():
            if not self._gate.ready():
                if clockskew.wait(self._stop, 0.01):
                    return None, None
                continue
            pos = self._rot % n
            self._rot += 1
            self.endpoint_log.append(pos)
            try:
                stream = self._connects[pos]()
            except Exception:
                self._gate.arm()
                continue
            self._gate.reset()
            with self._lock:
                # clear + generation bump are atomic: a superseded
                # reader that still passes its gen check has done so
                # under this lock BEFORE the bump, so its dead-mark
                # lands before the clear, never after
                self._stream_dead.clear()
                self._gen += 1
                gen = self._gen
                self._unacked = 0
            reader = spawn_thread(
                target=self._ack_reader, args=(stream, gen),
                name="gateway-ack-reader", kind="worker",
            )
            reader.start()
            return stream, reader
        return None, None

    def _ack_reader(self, stream, gen: int) -> None:
        try:
            while not self._stop.is_set():
                body = stream.recv()
                if body is None:
                    break  # orderly END from the orderer
                with self._lock:
                    if self._gen != gen:
                        return  # superseded stream: credits are void
                    if self._unacked > 0:
                        self._unacked -= 1
                    self._ack_event.set()
        except Exception:
            pass  # torn stream: surfaced via _stream_dead below
        with self._lock:
            if self._gen == gen:
                # still the live stream: mark it dead and wake the
                # sender to fail over promptly
                self._stream_dead.set()
                self._ack_event.set()
                self._work.set()

    def _failover(self, stream, reader):
        """Stream loss: count the episode, requeue every sent-but-
        unresolved envelope (the dead orderer may have dropped them;
        duplicates are defused by the validator's txid dedup), and
        leave reconnection to the gated rotation."""
        self.failovers += 1
        if self._metrics is not None:
            self._metrics.failovers.With("channel", self.channel_id).add()
        faultline.point("gateway.failover", episode=self.failovers)
        try:
            stream.close()
        except Exception:
            pass
        if reader is not None:
            reader.join(timeout=3)
        with self._lock:
            queued = {id(r) for r in self._sendq}
            resub = [
                r for r in self._records.values()
                if r.sent and r.status == STATUS_PENDING
                and id(r) not in queued
            ]
            resub.sort(key=lambda r: r.t_submit)
            self._sendq.extendleft(reversed(resub))
            for r in resub:
                r.sent = False
            self._unacked = 0
            self._work.set()
        return None, None


__all__ = [
    "Gateway",
    "SubmitResult",
    "orderer_stream_connect",
    "txid_of",
    "STATUS_PENDING",
    "STATUS_VALID",
    "STATUS_INVALID",
    "STATUS_TIMEOUT",
]
