"""Gossip core: a channel's block dissemination by push and pull (the
port's copy of `fabric_tpu/gossip/core.py`; reference gossip/gossip:
the channel's message store and state info, the pull engine, the push
emitter).

`tick()` runs one pull round and one height advertisement.  Push: a new
block goes to `fanout` channel peers drawn from `rng`.  Pull: a hello to
each of up to three peers, their digests (block numbers) back, a request
for what is missing, not already in flight and not below the ledger
height, the blocks back.  StateInfo messages advertise ledger heights, so
state transfer knows who is ahead.

A deliberate divergence from the JAX package, which requests every digest
its store lacks and stores every block pushed to it: a committed block
that left this store by its TTL would come back, by pull from a peer
whose copy has not expired yet or by a late push, so in a mesh the TTL
never empties the stores, and a peer that restarts behind catches up by
pull rather than by state transfer.  Here a block below the ledger
height is neither requested nor taken in (Fabric's block puller drops
such digests alike).
"""

from __future__ import annotations

import random

from fabric_tpu_torch.devtools.lockwatch import named_lock
from fabric_tpu_torch.protos import gossip as gpb


class MessageStore:
    """A channel's bounded store of blocks by number, expiring by TTL in
    gossip ticks (reference msgstore): `expire(now)` drops what was added
    `ttl_ticks` or more ago and reports each through
    `on_expire(seq, block_bytes)` outside the lock.  `ttl_ticks` 0 keeps
    the count bound only."""

    def __init__(self, capacity: int = 200, ttl_ticks: int = 0,
                 on_expire=None):
        self._cap = capacity
        self._ttl = ttl_ticks
        self._on_expire = on_expire
        self._by_seq: dict[int, bytes] = {}
        self._added: dict[int, int] = {}  # seq -> tick added
        self._now = 0
        self._lock = named_lock("gossip.blockcache")

    def add(self, seq: int, block_bytes: bytes) -> bool:
        with self._lock:
            if seq in self._by_seq:
                return False
            self._by_seq[seq] = block_bytes
            self._added[seq] = self._now
            while len(self._by_seq) > self._cap:
                oldest = min(self._by_seq)
                del self._by_seq[oldest]
                self._added.pop(oldest, None)
            return True

    def expire(self, now: int) -> None:
        expired: list[tuple[int, bytes]] = []
        with self._lock:
            self._now = now
            if self._ttl:
                for seq in [s for s, t in self._added.items()
                            if t <= now - self._ttl]:
                    blk = self._by_seq.pop(seq, None)
                    del self._added[seq]
                    if blk is not None:
                        expired.append((seq, blk))
        if self._on_expire is not None:
            for seq, blk in expired:
                self._on_expire(seq, blk)

    def digests(self) -> list[int]:
        with self._lock:
            return sorted(self._by_seq)

    def get(self, seq: int) -> bytes | None:
        with self._lock:
            return self._by_seq.get(seq)


class ChannelGossip:
    def __init__(self, channel_id: str, comm, membership, fanout: int = 3,
                 store_capacity: int = 200, store_ttl_ticks: int = 0,
                 on_block=None, on_expire=None,
                 rng: random.Random | None = None):
        """membership: () -> the channel's alive peer endpoints."""
        self.channel_id = channel_id
        self._chan_bytes = channel_id.encode()
        self._comm = comm
        self._membership = membership
        self._fanout = fanout
        self.store = MessageStore(store_capacity, ttl_ticks=store_ttl_ticks,
                                  on_expire=on_expire)
        self._on_block = on_block or (lambda seq, blk: None)
        self._rng = rng or random.Random()
        self._nonce = 0
        self._pending_pulls: dict[int, str] = {}
        # digest -> tick requested: concurrent pulls do not request a
        # block another in-flight request covers; entries expire after
        # two ticks, so a lost response never wedges a digest
        self._inflight: dict[int, int] = {}
        self._tick_no = 0
        self._heights: dict[bytes, int] = {}  # peer pki -> height
        self._height_eps: dict[bytes, str] = {}
        self._lock = named_lock("gossip.channel")
        self.ledger_height = lambda: 0  # wired by the state layer
        # blocks at or above the ledger height taken in, by route
        self.received = {"push": 0, "pull": 0}
        comm.subscribe(self._handle)

    # -- outbound ----------------------------------------------------------

    def _targets(self, k: int | None = None) -> list[str]:
        peers = list(self._membership())
        self._rng.shuffle(peers)
        return peers[:(k or self._fanout)]

    def add_block(self, seq: int, block_bytes: bytes, push: bool = True
                  ) -> bool:
        """A block from the deliver client or a peer: store it, hand it
        to the state layer, push it on.  False when already stored."""
        with self._lock:
            self._inflight.pop(seq, None)  # the pull is satisfied
        if not self.store.add(seq, block_bytes):
            return False
        self._on_block(seq, block_bytes)
        if push:
            msg = self._data_msg(seq, block_bytes)
            for ep in self._targets():
                self._comm.send(ep, msg)
        return True

    def _data_msg(self, seq: int, block_bytes: bytes) -> gpb.GossipMessage:
        return gpb.GossipMessage(
            channel=self._chan_bytes, tag=gpb.GossipMessage.CHAN_AND_ORG,
            data_msg=gpb.DataMessage(seq_num=seq, block=block_bytes))

    def advertise_state(self) -> None:
        m = gpb.GossipMessage(
            channel=self._chan_bytes, tag=gpb.GossipMessage.CHAN_ONLY,
            state_info=gpb.StateInfo(ledger_height=self.ledger_height(),
                                     pki_id=self._comm.pki_id))
        for ep in self._targets(len(self._membership())):
            self._comm.send(ep, m)

    def tick(self) -> None:
        """One pull round against up to three peers, then the height
        advertisement."""
        with self._lock:
            self._tick_no += 1
            tick_no = self._tick_no
            for d in [d for d, t in self._inflight.items()
                      if t < self._tick_no - 2]:
                del self._inflight[d]
        # expired blocks leave the digests; state transfer still serves
        # them from the ledger
        self.store.expire(tick_no)
        for target in self._targets(min(3, self._fanout)):
            self._nonce += 1
            hello = gpb.GossipMessage(
                channel=self._chan_bytes,
                hello=gpb.GossipHello(nonce=self._nonce,
                                      msg_type=gpb.PULL_BLOCK_MSG))
            with self._lock:
                self._pending_pulls[self._nonce] = target
                while len(self._pending_pulls) > 32:
                    del self._pending_pulls[min(self._pending_pulls)]
            self._comm.send(target, hello)
        self.advertise_state()

    # -- peers ahead of us -------------------------------------------------

    def best_peer_height(self) -> tuple[str | None, int]:
        with self._lock:
            if not self._heights:
                return None, 0
            pki = max(self._heights, key=lambda k: self._heights[k])
            return self._height_eps.get(pki), self._heights[pki]

    # -- inbound -----------------------------------------------------------

    def _handle(self, rm) -> None:
        msg = rm.msg
        if msg.channel != self._chan_bytes:
            return
        kind = msg.which("content")
        if kind == "data_msg":
            seq = msg.data_msg.seq_num
            if seq >= self.ledger_height() \
                    and self.add_block(seq, msg.data_msg.block):
                self.received["push"] += 1
        elif kind == "hello":
            resp = gpb.GossipMessage(
                channel=self._chan_bytes,
                data_dig=gpb.DataDigest(
                    nonce=msg.hello.nonce, msg_type=gpb.PULL_BLOCK_MSG,
                    digests=[str(s).encode() for s in self.store.digests()]))
            ep = self._endpoint_for(rm.sender_pki)
            if ep:
                self._comm.send(ep, resp)
        elif kind == "data_dig":
            with self._lock:
                target = self._pending_pulls.pop(msg.data_dig.nonce, None)
            if target is None:
                return
            have = set(self.store.digests())
            height = self.ledger_height()
            with self._lock:
                want = []
                for d in msg.data_dig.digests:
                    seq = int(d)
                    # below the ledger height: committed already
                    if seq < height or seq in have or seq in self._inflight:
                        continue
                    self._inflight[seq] = self._tick_no
                    want.append(d)
            if not want:
                return
            self._comm.send(target, gpb.GossipMessage(
                channel=self._chan_bytes,
                data_req=gpb.DataRequest(nonce=msg.data_dig.nonce,
                                         msg_type=gpb.PULL_BLOCK_MSG,
                                         digests=want)))
        elif kind == "data_req":
            data = []
            for d in msg.data_req.digests:
                blk = self.store.get(int(d))
                if blk is not None:
                    data.append(self._comm.wrap(self._data_msg(int(d), blk)))
            ep = self._endpoint_for(rm.sender_pki)
            if ep:
                self._comm.send(ep, gpb.GossipMessage(
                    channel=self._chan_bytes,
                    data_update=gpb.DataUpdate(nonce=msg.data_req.nonce,
                                               msg_type=gpb.PULL_BLOCK_MSG,
                                               data=data)))
        elif kind == "data_update":
            for signed in msg.data_update.data:
                inner = gpb.GossipMessage.decode(signed.payload)
                if inner.which("content") == "data_msg":
                    seq = inner.data_msg.seq_num
                    if seq >= self.ledger_height() and self.add_block(
                            seq, inner.data_msg.block, push=False):
                        self.received["pull"] += 1
        elif kind == "state_info":
            pki = msg.state_info.pki_id
            with self._lock:
                self._heights[pki] = msg.state_info.ledger_height
                ep = self._endpoint_for(pki)
                if ep:
                    self._height_eps[pki] = ep

    # the endpoint lookup is wired by the node (discovery knows it)
    endpoint_lookup = None

    def _endpoint_for(self, pki_id: bytes) -> str | None:
        if self.endpoint_lookup is not None:
            return self.endpoint_lookup(pki_id)
        return None


__all__ = ["ChannelGossip", "MessageStore"]
