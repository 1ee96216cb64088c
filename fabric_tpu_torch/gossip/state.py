"""Gossip state transfer: ordered block delivery into the commit path
(the port's copy of `fabric_tpu/gossip/state.py`; reference
gossip/state).

Blocks arrive out of order from gossip push and pull, or in order from
the deliver client; a payload buffer holds them and the drain commits
strictly in sequence (a contiguous run through the committer's
`store_stream` when it has one, a lone block through `store_block`).
Anti-entropy asks the peer advertising the greatest height for the first
missing range (RemoteStateRequest / RemoteStateResponse), skipping blocks
already buffered, and a response that made progress chains the next
request at once (one level a thread).

Where the transport delivers on a connection's reader thread (TCP), a
block from a peer (a push or a state response) is buffered there and
committed by a worker of the provider's own, as the reference's state
provider commits on a goroutine of its own: a commit on the reader would
hold back every later message of that sender, its alive and leadership
messages too.  The in-process transport delivers on the sender's stack
and commits there, as the JAX package does.
"""

from __future__ import annotations

import collections
import threading

from fabric_tpu_torch.common.flogging import must_get_logger
from fabric_tpu_torch.devtools import faultline
from fabric_tpu_torch.devtools.lockwatch import named_lock, spawn_thread
from fabric_tpu_torch.protos import common as cb
from fabric_tpu_torch.protos import gossip as gpb


class PayloadBuffer:
    def __init__(self):
        self._by_seq: dict[int, bytes] = {}
        self._lock = named_lock("gossip.state.buffer")

    def push(self, seq: int, block_bytes: bytes) -> None:
        with self._lock:
            self._by_seq.setdefault(seq, block_bytes)

    def pop(self, seq: int) -> bytes | None:
        with self._lock:
            return self._by_seq.pop(seq, None)

    def __contains__(self, seq: int) -> bool:
        with self._lock:
            return seq in self._by_seq


class StateProvider:
    def __init__(self, channel_id: str, channel_gossip, committer, comm,
                 max_batch: int = 10):
        """committer: `store_block(Block)` and `height`, optionally
        `store_stream(blocks)` and `get_block_by_number(n)`."""
        self.channel_id = channel_id
        self._chan = channel_id.encode()
        self._gossip = channel_gossip
        self._committer = committer
        self._comm = comm
        self._buffer = PayloadBuffer()
        self._max_batch = max_batch
        # ordered before the ledger's commit lock (store_block enters the
        # committer while holding it)
        self._commit_lock = named_lock("gossip.state.commit")
        # the in-process transport dispatches on the sender's stack: one
        # level of chained catch-up a thread keeps it from recursing
        self._chaining = threading.local()
        # a peer's blocks commit on the worker where the comm delivers on
        # a reader thread; _kicked asks the worker for one more pass
        self._apart = getattr(comm, "delivers_on_reader", False)
        self._kick_lock = named_lock("gossip.state.kick")
        self._kicked = False
        self._worker = False
        self._metrics = None  # common.metrics.GossipMetrics
        self.requests_sent = 0
        # the last (start, end) ranges requested
        self.requests: collections.deque = collections.deque(maxlen=64)
        self.blocks_received = 0  # blocks taken from state responses
        channel_gossip.ledger_height = lambda: self._committer.height
        channel_gossip._on_block = self._on_gossip_block
        comm.subscribe(self._handle)

    def set_metrics(self, metrics) -> None:
        self._metrics = metrics

    # -- ingestion ---------------------------------------------------------

    def add_payload(self, seq: int, block_bytes: bytes,
                    from_orderer: bool = False) -> None:
        """A block from the deliver client (ordered) or a peer."""
        if not self._accept(seq, block_bytes):
            return
        if from_orderer:
            self._gossip.add_block(seq, block_bytes)  # disseminate it
        self._drain()

    def _on_gossip_block(self, seq: int, block_bytes: bytes) -> None:
        if not self._accept(seq, block_bytes):
            return
        if self._apart:
            self._kick()
        else:
            self._drain()

    def _accept(self, seq: int, block_bytes: bytes) -> bool:
        """Buffers a block not yet committed; False for one that is."""
        if seq < self._committer.height:
            return False
        # every path a block takes into the peer passes here
        faultline.point("gossip.state.payload", seq=seq)
        self._buffer.push(seq, block_bytes)
        return True

    # -- ordered commit ----------------------------------------------------

    def _drain(self) -> None:
        with self._commit_lock:
            while True:
                nxt = self._committer.height
                raw = self._buffer.pop(nxt)
                if raw is None:
                    return
                # a contiguous run goes through the pipeline, a lone
                # block through store_block
                run = [raw]
                if hasattr(self._committer, "store_stream"):
                    while True:
                        more = self._buffer.pop(nxt + len(run))
                        if more is None:
                            break
                        run.append(more)
                if len(run) == 1:
                    self._committer.store_block(cb.Block.decode(raw))
                else:
                    for _flags in self._committer.store_stream(
                            cb.Block.decode(r) for r in run):
                        pass

    def _kick(self) -> None:
        """Has the worker commit what is buffered, starting it if it is
        not running; it ends once a pass finds no new kick."""
        with self._kick_lock:
            self._kicked = True
            if self._worker:
                return
            self._worker = True
        # fabriclint: allow[thread-lifecycle] a bounded worker: it returns
        # once a pass finds no new kick, and a kick after that starts another
        spawn_thread(target=self._commit_apart, name="gossip-state-commit",
                     kind="worker").start()

    def _commit_apart(self) -> None:
        try:
            while True:
                with self._kick_lock:
                    if not self._kicked:
                        self._worker = False
                        return
                    self._kicked = False
                before = self._committer.height
                self._drain()
                # a pass that made progress chains the next request now
                if self._committer.height > before:
                    self._request_missing()
        except Exception:
            with self._kick_lock:
                self._worker = False
            must_get_logger("gossip.state").warning(
                "committing buffered blocks raised", exc_info=True)

    # -- anti-entropy ------------------------------------------------------

    def tick(self) -> None:
        """Request the missing range from the best-known peer if behind."""
        self._request_missing()

    def _request_missing(self) -> bool:
        """One request for the first missing range that is not already
        buffered; True when one went out."""
        ep, their_height = self._gossip.best_peer_height()
        my_height = self._committer.height
        if ep is None or their_height <= my_height:
            return False
        start = my_height
        while start < their_height and start in self._buffer:
            start += 1
        if start >= their_height:
            return False
        m = self._metrics
        if m is not None:
            m.state_requests_sent.add()
        end = min(their_height - 1, start + self._max_batch - 1)
        self.requests_sent += 1
        self.requests.append((start, end))
        self._comm.send(ep, gpb.GossipMessage(
            channel=self._chan,
            state_request=gpb.RemoteStateRequest(start_seq_num=start,
                                                 end_seq_num=end)))
        return True

    def _handle(self, rm) -> None:
        msg = rm.msg
        if msg.channel != self._chan:
            return
        kind = msg.which("content")
        if kind == "state_request":
            payloads = []
            for seq in range(msg.state_request.start_seq_num,
                             msg.state_request.end_seq_num + 1):
                raw = self._gossip.store.get(seq) or self._read_committed(seq)
                if raw is None:
                    break
                payloads.append(gpb.DataMessage(seq_num=seq, block=raw))
            ep = self._gossip._endpoint_for(rm.sender_pki)
            if ep and payloads:
                m = self._metrics
                if m is not None:
                    m.state_requests_served.add()
                    m.state_blocks_served.add(len(payloads))
                self._comm.send(ep, gpb.GossipMessage(
                    channel=self._chan,
                    state_response=gpb.RemoteStateResponse(
                        payloads=payloads)))
        elif kind == "state_response" and self._apart:
            for dm in msg.state_response.payloads:
                if dm.seq_num >= self._committer.height \
                        and dm.seq_num not in self._buffer:
                    self.blocks_received += 1
                self._accept(dm.seq_num, dm.block)
            if msg.state_response.payloads:
                self._kick()
        elif kind == "state_response":
            before = self._committer.height
            for dm in msg.state_response.payloads:
                if dm.seq_num >= self._committer.height \
                        and dm.seq_num not in self._buffer:
                    self.blocks_received += 1
                self.add_payload(dm.seq_num, dm.block)
            # a batch that made progress chains the next request now
            if (msg.state_response.payloads
                    and self._committer.height > before
                    and not getattr(self._chaining, "active", False)):
                self._chaining.active = True
                try:
                    self._request_missing()
                finally:
                    self._chaining.active = False

    def _read_committed(self, seq: int) -> bytes | None:
        reader = getattr(self._committer, "get_block_by_number", None)
        if reader is None:
            return None
        blk = reader(seq)
        return blk.encode() if blk is not None else None


__all__ = ["StateProvider", "PayloadBuffer"]
