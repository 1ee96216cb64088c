"""A channel's leader election over gossip (the port's copy of
`fabric_tpu/gossip/election.py`; reference gossip/election).

Each tick a node expires a silent leader, then declares itself leader if
it should lead (the smallest pki-id among the proposals seen, or the
standing leader), else proposes.  The elected peer runs the channel's
deliver client for its org.

`startup_ticks` (0 in the reference) makes a node only propose for its
first ticks, so that it hears the others before it may declare: without
it every node declares on its first tick, and several deliver clients
run until the declarations meet.
"""

from __future__ import annotations

import threading

from fabric_tpu_torch.protos import gossip as gpb


class LeaderElection:
    def __init__(self, channel_id: str, comm, membership,
                 on_leadership_change=None, leader_timeout_ticks: int = 5,
                 startup_ticks: int = 0):
        """membership: () -> the channel's endpoints;
        on_leadership_change(is_leader)."""
        self.channel_id = channel_id
        self._chan = channel_id.encode()
        self._comm = comm
        self._membership = membership
        self._on_change = on_leadership_change or (lambda is_leader: None)
        self._timeout = leader_timeout_ticks
        self._startup = startup_ticks
        self._tick = 0
        self._seq = 0
        self._leader: bytes | None = None
        self._leader_seen_tick = 0
        self._proposals: dict[bytes, int] = {}  # pki -> last tick seen
        self._lock = threading.Lock()
        self.is_leader = False
        comm.subscribe(self._handle)

    def _broadcast(self, declaration: bool) -> None:
        self._seq += 1
        m = gpb.GossipMessage(
            channel=self._chan, tag=gpb.GossipMessage.CHAN_ONLY,
            leadership_msg=gpb.LeadershipMessage(
                pki_id=self._comm.pki_id, seq_num=self._seq,
                is_declaration=declaration))
        for ep in self._membership():
            self._comm.send(ep, m)

    def tick(self) -> None:
        self._tick += 1
        with self._lock:
            leader_expired = (
                self._leader is not None
                and self._leader != self._comm.pki_id
                and self._tick - self._leader_seen_tick > self._timeout)
            if leader_expired:
                self._leader = None
            self._proposals = {p: t for p, t in self._proposals.items()
                               if self._tick - t <= self._timeout}
            candidates = set(self._proposals) | {self._comm.pki_id}
            if self._leader is not None and not leader_expired:
                should_lead = self._leader == self._comm.pki_id
            else:
                should_lead = (self._tick > self._startup
                               and min(candidates) == self._comm.pki_id)
        if should_lead:
            with self._lock:
                self._leader = self._comm.pki_id
                self._leader_seen_tick = self._tick
            self._broadcast(declaration=True)
            self._set_leader(True)
        else:
            self._broadcast(declaration=False)
            self._set_leader(False)

    def _set_leader(self, val: bool) -> None:
        if val != self.is_leader:
            self.is_leader = val
            self._on_change(val)

    def leader(self) -> bytes | None:
        with self._lock:
            return self._leader

    def _handle(self, rm) -> None:
        msg = rm.msg
        if msg.channel != self._chan \
                or msg.which("content") != "leadership_msg":
            return
        lm = msg.leadership_msg
        pki = lm.pki_id
        with self._lock:
            self._proposals[pki] = self._tick
            if lm.is_declaration:
                # yield to a declared leader with a smaller pki-id
                if self._leader is None or pki <= self._leader:
                    self._leader = pki
                    self._leader_seen_tick = self._tick
                relinquish = pki < self._comm.pki_id
        if lm.is_declaration and relinquish:
            self._set_leader(False)


__all__ = ["LeaderElection"]
