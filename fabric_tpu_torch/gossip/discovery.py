"""Gossip membership: signed alive messages over logical ticks (the
port's copy of `fabric_tpu/gossip/discovery.py`; reference
gossip/discovery).

Periodic alive broadcasts, dead-peer detection by expiration,
membership request and response, resurrection by a higher (incarnation,
sequence).  `DiscoveryCore` advances on explicit `tick()` calls; the
`Discovery` thread drives it in a deployment.
"""

from __future__ import annotations

import threading
import time

from fabric_tpu_torch.devtools.lockwatch import (
    guarded,
    named_lock,
    spawn_thread,
)
from fabric_tpu_torch.protos import gossip as gpb


class PeerState:
    __slots__ = ("endpoint", "pki_id", "inc", "seq", "last_seen_tick",
                 "alive")

    def __init__(self, endpoint, pki_id, inc, seq, tick):
        self.endpoint = endpoint
        self.pki_id = pki_id
        self.inc = inc
        self.seq = seq
        self.last_seen_tick = tick
        self.alive = True


class DiscoveryCore:
    def __init__(self, comm, bootstrap: list[str],
                 alive_interval_ticks: int = 1, expiration_ticks: int = 5,
                 on_membership_change=None):
        self._comm = comm
        self.endpoint = comm.endpoint
        self.pki_id = comm.pki_id
        self._bootstrap = [e for e in bootstrap if e != comm.endpoint]
        self._alive_every = alive_interval_ticks
        self._expire_after = expiration_ticks
        self._peers: dict[bytes, PeerState] = {}
        # fabriclint: allow[taint] the incarnation is the process's start
        # time by protocol (as the JAX package's): peers order one
        # member's alive messages by it and never recompute it
        self._inc = int(time.time() * 1000)  # incarnation: process start
        self._seq = 0
        self._tick = 0
        # guards the membership and the logical clock: the tick driver
        # and the comm handlers both touch them
        self._lock = named_lock("gossip.discovery.members")
        self._on_change = on_membership_change or (lambda: None)
        comm.subscribe(self._handle)

    # -- views -------------------------------------------------------------

    def alive_peers(self) -> list[PeerState]:
        with self._lock:
            return [p for p in self._peers.values() if p.alive]

    def dead_peers(self) -> list[PeerState]:
        with self._lock:
            return [p for p in self._peers.values() if not p.alive]

    def endpoint_of(self, pki_id: bytes) -> str | None:
        with self._lock:
            p = self._peers.get(pki_id)
            return p.endpoint if p else None

    # -- protocol ----------------------------------------------------------

    def _self_alive(self) -> gpb.AliveMessage:
        with self._lock:
            self._seq += 1
            seq = self._seq
        return gpb.AliveMessage(
            membership=gpb.Member(endpoint=self.endpoint, pki_id=self.pki_id,
                                  identity=self._comm.identity),
            inc_number=self._inc, seq_num=seq)

    def tick(self) -> None:
        """One logical step: broadcast alive, expire silent peers."""
        with self._lock:
            self._tick += 1
            now = self._tick
            know_no_one = not self._peers
        if now % self._alive_every == 0:
            am = self._self_alive()
            alive = gpb.GossipMessage(tag=gpb.GossipMessage.EMPTY,
                                      alive_msg=am)
            targets = {p.endpoint for p in self.alive_peers()}
            targets.update(self._bootstrap)
            for ep in targets:
                self._comm.send(ep, alive)
            # solicit membership from the bootstrap while alone
            if know_no_one:
                req = gpb.GossipMessage(
                    tag=gpb.GossipMessage.EMPTY,
                    mem_req=gpb.MembershipRequest(self_information=am))
                for ep in self._bootstrap:
                    self._comm.send(ep, req)
        changed = False
        with self._lock:
            for p in self._peers.values():
                if p.alive and self._tick - p.last_seen_tick \
                        > self._expire_after:
                    p.alive = False
                    changed = True
        if changed:
            self._on_change()

    def _learn(self, am: gpb.AliveMessage) -> bool:
        """True when the membership changed."""
        pki = am.membership.pki_id
        if pki == self.pki_id:
            return False
        if am.membership.identity:
            self._comm.learn_identity(am.membership.identity)
        with self._lock:
            guarded(self, "_peers", by="gossip.discovery.members")
            cur = self._peers.get(pki)
            if cur is None:
                self._peers[pki] = PeerState(am.membership.endpoint, pki,
                                             am.inc_number, am.seq_num,
                                             self._tick)
                return True
            if (am.inc_number, am.seq_num) <= (cur.inc, cur.seq):
                return False  # stale
            cur.inc, cur.seq = am.inc_number, am.seq_num
            cur.endpoint = am.membership.endpoint or cur.endpoint
            cur.last_seen_tick = self._tick
            resurrection = not cur.alive
            cur.alive = True
            return resurrection

    def _handle(self, rm) -> None:
        msg = rm.msg
        kind = msg.which("content")
        if kind == "alive_msg":
            if self._learn(msg.alive_msg):
                self._on_change()
        elif kind == "mem_req":
            if self._learn(msg.mem_req.self_information):
                self._on_change()
            with self._lock:
                peers = list(self._peers.values())
            alive = [self._self_alive()]
            dead = []
            for p in peers:
                ident = self._comm.identity_of(p.pki_id)
                am = gpb.AliveMessage(
                    membership=gpb.Member(endpoint=p.endpoint,
                                          pki_id=p.pki_id,
                                          **({"identity": ident}
                                             if ident else {})),
                    inc_number=p.inc, seq_num=p.seq)
                (alive if p.alive else dead).append(am)
            resp = gpb.GossipMessage(
                tag=gpb.GossipMessage.EMPTY,
                mem_res=gpb.MembershipResponse(alive=alive, dead=dead))
            ep = msg.mem_req.self_information.membership.endpoint
            if ep:
                self._comm.send(ep, resp)
        elif kind == "mem_res":
            changed = False
            for am in msg.mem_res.alive:
                changed |= self._learn(am)
            if changed:
                self._on_change()


class Discovery:
    """The thread driver around DiscoveryCore."""

    def __init__(self, core: DiscoveryCore, tick_interval_s: float = 1.0):
        self.core = core
        self._interval = tick_interval_s
        self._stop = threading.Event()
        self._thread = spawn_thread(target=self._run,
                                    name="gossip-discovery", kind="service")

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=3)

    def _run(self) -> None:
        while not self._stop.wait(self._interval):
            self.core.tick()


__all__ = ["DiscoveryCore", "Discovery", "PeerState"]
