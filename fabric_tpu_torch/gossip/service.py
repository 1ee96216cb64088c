"""The gossip service: one node's gossip stack, joined a channel at a
time (the port's copy of `fabric_tpu/gossip/service.py`; reference
gossip/service).

Binds comm, membership, the identity mapper and the certstore once a
node; a channel gets its ChannelGossip, leader election and state
provider, and its deliver client runs on the elected leader alone.
"""

from __future__ import annotations

import random
import threading

from fabric_tpu_torch.devtools.lockwatch import spawn_thread
from fabric_tpu_torch.gossip.certstore import CertStore
from fabric_tpu_torch.gossip.core import ChannelGossip
from fabric_tpu_torch.gossip.discovery import DiscoveryCore
from fabric_tpu_torch.gossip.election import LeaderElection
from fabric_tpu_torch.gossip.identity import IdentityMapper
from fabric_tpu_torch.gossip.state import StateProvider


class ChannelHandle:
    def __init__(self, gossip, election, state):
        self.gossip = gossip
        self.election = election
        self.state = state

    def tick(self) -> None:
        self.gossip.tick()
        self.election.tick()
        self.state.tick()


class GossipService:
    def __init__(self, comm, bootstrap: list[str],
                 alive_expiration_ticks: int = 5,
                 identity_ttl_s: float = 3600.0, rng=None):
        """rng: a `random.Random` from which the certstore and each
        channel's gossip draw their own (None: unseeded)."""
        self._comm = comm
        self._rng = rng
        self.discovery = DiscoveryCore(
            comm, bootstrap, expiration_ticks=alive_expiration_ticks)
        self.identities = IdentityMapper(
            comm.mcs, comm.identity, default_ttl_s=identity_ttl_s,
            on_purge=comm.forget_identity)
        self.certstore = CertStore(
            comm, self.identities,
            lambda: [p.endpoint for p in self.discovery.alive_peers()],
            rng=self._child_rng())
        self.certstore.endpoint_lookup = self.discovery.endpoint_of
        self._channels: dict[str, ChannelHandle] = {}
        self._lock = threading.Lock()
        self._metrics = None

    def _child_rng(self):
        if self._rng is None:
            return None
        return random.Random(self._rng.getrandbits(64))

    def set_metrics(self, metrics) -> None:
        """Bind a common.metrics.GossipMetrics across the stack: comm's
        message counts, each channel's state-transfer counts, and the
        membership gauge kept a tick."""
        self._metrics = metrics
        self._comm.set_metrics(metrics)
        with self._lock:
            handles = list(self._channels.values())
        for h in handles:
            h.state.set_metrics(metrics)

    @property
    def endpoint(self) -> str:
        return self._comm.endpoint

    def join_channel(self, channel_id: str, committer, deliver_client=None,
                     fanout: int = 3, store_capacity: int = 200,
                     store_ttl_ticks: int = 0, leader_timeout_ticks: int = 5,
                     election_startup_ticks: int = 0) -> ChannelHandle:
        """deliver_client: `.start()` / `.stop()`, run while this node
        leads the channel."""
        membership = lambda: [p.endpoint
                              for p in self.discovery.alive_peers()]
        gossip = ChannelGossip(channel_id, self._comm, membership,
                               fanout=fanout, store_capacity=store_capacity,
                               store_ttl_ticks=store_ttl_ticks,
                               rng=self._child_rng())
        gossip.endpoint_lookup = self.discovery.endpoint_of
        state = StateProvider(channel_id, gossip, committer, self._comm)
        if self._metrics is not None:
            state.set_metrics(self._metrics)

        def on_leadership(is_leader: bool) -> None:
            if deliver_client is None:
                return
            if is_leader:
                deliver_client.start()
            else:
                deliver_client.stop()

        election = LeaderElection(
            channel_id, self._comm, membership,
            on_leadership_change=on_leadership,
            leader_timeout_ticks=leader_timeout_ticks,
            startup_ticks=election_startup_ticks)
        handle = ChannelHandle(gossip, election, state)
        with self._lock:
            self._channels[channel_id] = handle
        return handle

    def channel(self, channel_id: str) -> ChannelHandle | None:
        with self._lock:
            return self._channels.get(channel_id)

    def tick(self) -> None:
        """One round of the node: membership, the identity pull and
        expiration sweep, then every channel."""
        self.discovery.tick()
        self.certstore.tick()
        self.identities.sweep()
        m = self._metrics
        if m is not None:
            m.membership.set(len(self.discovery.alive_peers()))
        with self._lock:
            handles = list(self._channels.values())
        for h in handles:
            h.tick()


class GossipRunner:
    """The thread driver: ticks a GossipService on an interval."""

    def __init__(self, service: GossipService, tick_interval_s: float = 1.0):
        self._svc = service
        self._interval = tick_interval_s
        self._stop = threading.Event()
        self._thread = spawn_thread(target=self._run, name="gossip-ticker",
                                    kind="service")

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=3)

    def _run(self) -> None:
        while not self._stop.wait(self._interval):
            self._svc.tick()


__all__ = ["GossipService", "GossipRunner", "ChannelHandle"]
