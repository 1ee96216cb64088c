"""The multichannel registrar: one ordering pipeline a channel (the port's
copy of `fabric_tpu/orderer/multichannel.py`; reference
orderer/common/multichannel).

`Registrar` maps a channel id to its `ChainSupport`: the channel's block
store (`<root>/chains/<channel>`), message processor, block writer and
consenter, made from a genesis block; the consenter is the channel
config's ConsensusType (solo or kafka).  A written config block swaps the
channel's bundle, processor and batch settings, and a change of the
consensus type (a migration through maintenance) replaces the consenter.

An `etcdraft` (or `raft`) channel runs a `RaftChain` with node id
`node_id` on the registrar's `transport` (a `ChannelStepRouter` over an
InProc or TCP transport), its consenters and options from the
ConsensusType's `ConfigMetadata`, its WAL in `<root>/raft/<channel>`.
"""

from __future__ import annotations

import os
import threading

from fabric_tpu_torch import protoutil
from fabric_tpu_torch.common.channelconfig import bundle_from_genesis
from fabric_tpu_torch.devtools.lockwatch import spawn_thread
from fabric_tpu_torch.ledger.blkstorage import BlockStore
from fabric_tpu_torch.orderer.blockcutter import BlockCutter
from fabric_tpu_torch.orderer.blockwriter import BlockWriter
from fabric_tpu_torch.orderer.msgprocessor import StandardChannelProcessor
from fabric_tpu_torch.orderer.solo import SoloChain
from fabric_tpu_torch.protos import common as cb
from fabric_tpu_torch.protos import orderer as ob


class ChainSupport:
    """What the broadcast and deliver handlers need of one channel."""

    def __init__(self, channel_id, bundle, store, writer, processor, chain,
                 cutter=None):
        self.channel_id = channel_id
        self.bundle = bundle
        self.store = store
        self.writer = writer
        self.processor = processor
        self.chain = chain
        self.cutter = cutter  # the running chain's cutter

    def halt(self) -> None:
        self.chain.halt()


class Registrar:
    def __init__(self, root_dir: str | None, csp, signer=None,
                 node_id: int = 1, transport=None,
                 consenter_overrides: dict | None = None,
                 raft_metrics=None):
        """`consenter_overrides`: "type" (forces a consensus type),
        "broker" (kafka's partitions), "kafka_start_offset",
        "eviction_suspicion_ticks" and "eviction_probe" (raft's eviction
        suspicion), "follower_puller" and "in_consenter_set" (the
        follower path of `demote_evicted`).  `raft_metrics`: a
        common.metrics.RaftMetrics handed to every raft chain."""
        self.root_dir = root_dir
        self.csp = csp
        self.signer = signer
        self.node_id = node_id
        self.transport = transport
        self._chains: dict[str, ChainSupport] = {}
        self._lock = threading.Lock()
        self._halted = False
        self._consenter_overrides = consenter_overrides or {}
        self._on_block_hooks: list = []
        self.raft_metrics = raft_metrics

    # -- lifecycle ---------------------------------------------------------

    def startup(self, genesis_blocks: list[cb.Block]) -> None:
        for blk in genesis_blocks:
            self.create_chain(blk)

    def create_chain(self, genesis: cb.Block, extra_blocks=None
                     ) -> ChainSupport:
        """`extra_blocks`: checked blocks 1..N to append after the genesis
        block before the consenter starts (cluster onboarding).  On a
        store that already holds blocks the chain resumes at its height,
        with the genesis block's bundle and last-config index 0, as the
        reference does."""
        bundle = bundle_from_genesis(genesis, self.csp)
        channel_id = bundle.channel_id
        with self._lock:
            if channel_id in self._chains:
                return self._chains[channel_id]
        store_dir = (os.path.join(self.root_dir, "chains", channel_id)
                     if self.root_dir else None)
        store = BlockStore(store_dir, name=f"orderer-{channel_id}")
        if store.height == 0:
            store.add_block(genesis)
        for blk in extra_blocks or []:
            if blk.header.number == store.height:
                store.add_block(blk)
        writer = BlockWriter(store, signer=self.signer)
        oc = bundle.orderer_config
        cutter = BlockCutter.from_orderer_config(oc) if oc else BlockCutter()
        processor = StandardChannelProcessor(channel_id, bundle, self.csp,
                                             signer=self.signer)
        try:
            chain = self._build_consenter(channel_id, bundle, cutter, writer)
        except Exception:
            store.close()
            raise
        cs = ChainSupport(channel_id, bundle, store, writer, processor, chain,
                          cutter)
        with self._lock:
            self._chains[channel_id] = cs
        chain.start()
        return cs

    def _build_consenter(self, channel_id, bundle, cutter, writer):
        oc = bundle.orderer_config
        ctype = (oc.consensus_type if oc else "solo") or "solo"
        ctype = self._consenter_overrides.get("type", ctype)
        timeout = oc.batch_timeout_s if oc else 2.0

        def on_block(blk):
            self._fan_out(channel_id, blk)

        if ctype in ("raft", "etcdraft"):
            from fabric_tpu_torch.orderer.raft import RaftChain

            meta = ob.ConfigMetadata()
            if oc and oc.consensus_metadata:
                meta = ob.ConfigMetadata.decode(oc.consensus_metadata)
            consenters = (list(meta.consenters)
                          or [ob.Consenter(id=self.node_id)])
            opts = meta.options
            wal_dir = (os.path.join(self.root_dir, "raft", channel_id)
                       if self.root_dir else None)
            chain = RaftChain(
                channel_id, self.node_id, consenters, cutter, writer,
                self.transport, wal_dir=wal_dir, batch_timeout_s=timeout,
                tick_interval_s=(opts.tick_interval_ms or 50) / 1000.0,
                election_tick=opts.election_tick or 10,
                heartbeat_tick=opts.heartbeat_tick or 1,
                snapshot_interval_size=(opts.snapshot_interval_size
                                        or (16 << 20)),
                on_block=on_block,
                eviction_suspicion_ticks=self._consenter_overrides.get(
                    "eviction_suspicion_ticks"),
                active_consenters_probe=self._consenter_overrides.get(
                    "eviction_probe"),
                on_eviction=lambda: self.demote_evicted(channel_id),
                metrics=self.raft_metrics)
            if self.transport is not None:
                self.transport.register_channel(channel_id,
                                                chain.handle_step)
            return chain
        if ctype == "kafka":
            from fabric_tpu_torch.orderer.kafka import KafkaChain

            broker = self._consenter_overrides.get("broker")
            if broker is None:
                raise ValueError(
                    "kafka consensus requires a broker in consenter_overrides "
                    "(InProcBroker or a client with the same partition "
                    "surface)")
            return KafkaChain(channel_id, cutter, writer, broker=broker,
                              batch_timeout_s=timeout, on_block=on_block,
                              start_offset=self._consenter_overrides.get(
                                  "kafka_start_offset"))
        return SoloChain(cutter, writer, timeout, on_block=on_block)

    # -- lookups -----------------------------------------------------------

    def get_chain(self, channel_id: str) -> ChainSupport | None:
        with self._lock:
            return self._chains.get(channel_id)

    def channel_list(self) -> list[str]:
        with self._lock:
            return sorted(self._chains)

    def broadcast_channel_support(self, env: cb.Envelope,
                                  chdr: cb.ChannelHeader | None = None
                                  ) -> ChainSupport:
        """`chdr`: the envelope's channel header, when the caller has it."""
        chdr = chdr or protoutil.channel_header(env)
        cs = self.get_chain(chdr.channel_id)
        if cs is None:
            raise KeyError(f"channel {chdr.channel_id!r} not found")
        return cs

    # -- block fan-out -----------------------------------------------------

    def add_block_listener(self, hook) -> None:
        """hook(channel_id, block) on every block any chain writes."""
        self._on_block_hooks.append(hook)

    def _fan_out(self, channel_id: str, blk: cb.Block) -> None:
        self._maybe_apply_config(channel_id, blk)
        for hook in self._on_block_hooks:
            hook(channel_id, blk)

    # -- config blocks: the bundle swap and consensus migration ------------

    def _maybe_apply_config(self, channel_id: str, blk: cb.Block) -> None:
        """On a written CONFIG block, swap the channel's bundle and
        processor to the new config; when the consensus type changed,
        replace the consenter (on a helper thread: this runs on the old
        chain's thread, which halt() joins); else adopt the new BatchSize
        in the shared cutter and the new BatchTimeout in place."""
        try:
            env = protoutil.extract_envelope(blk, 0)
            if protoutil.channel_header(env).type != cb.CONFIG:
                return
        except Exception:
            return
        cs = self.get_chain(channel_id)
        if cs is None:
            return
        try:
            new_bundle = bundle_from_genesis(blk, self.csp)
        except Exception:
            return
        old_type = (cs.bundle.orderer_config.consensus_type
                    if cs.bundle.orderer_config else "solo")
        cs.bundle = new_bundle
        cs.processor.update_bundle(new_bundle)
        oc = new_bundle.orderer_config
        if not oc:
            return
        new_type = oc.consensus_type or "solo"
        if new_type != old_type and "type" not in self._consenter_overrides:
            spawn_thread(target=self._migrate_consenter,
                         args=(channel_id, new_bundle,
                               BlockCutter.from_orderer_config(oc)),
                         name=f"consenter-migrate-{channel_id}",
                         kind="worker").start()
        else:
            if cs.cutter is not None:
                cs.cutter.update_from_orderer_config(oc)
            if hasattr(cs.chain, "set_batch_timeout"):
                cs.chain.set_batch_timeout(oc.batch_timeout_s)

    def _migrate_consenter(self, channel_id: str, bundle, cutter) -> None:
        cs = self.get_chain(channel_id)
        if cs is None:
            return
        try:
            cs.chain.halt()
        except Exception:
            pass  # the old chain is replaced whatever its halt did
        chain = self._build_consenter(channel_id, bundle, cutter, cs.writer)
        cs.cutter = cutter
        cs.chain = chain
        chain.start()

    def demote_evicted(self, channel_id: str) -> None:
        """Swap a channel's consenter for the follower path: a
        FollowerChain when a block puller is configured (it keeps
        replicating and rejoins when re-added), else an InactiveChain.
        Refused after `halt_all`."""
        from fabric_tpu_torch.orderer.follower import (
            FollowerChain,
            InactiveChain,
        )

        cs = self.get_chain(channel_id)
        if cs is None:
            return
        try:
            cs.chain.halt()
        except Exception:
            pass  # the old chain is replaced whatever its halt did
        with self._lock:
            if self._halted:
                return
            puller = self._consenter_overrides.get("follower_puller")
            if puller is not None:
                chain = FollowerChain(
                    channel_id, cs.store.height, puller,
                    # config blocks are written as such, so that the
                    # last-config index follows them
                    lambda blk, w=cs.writer: w.write_block(
                        blk, is_config=FollowerChain._is_config(blk)),
                    self._consenter_overrides.get("in_consenter_set",
                                                  lambda blk: False))
            else:
                chain = InactiveChain(channel_id)
            cs.chain = chain
            chain.start()

    def halt_all(self) -> None:
        with self._lock:
            self._halted = True
            chains = list(self._chains.values())
        for cs in chains:
            cs.halt()


class ChannelStepRouter:
    """A cluster transport shared by channels: Step requests go to the
    chain of their channel (reference orderer/common/cluster/service.go)."""

    def __init__(self, transport):
        self._transport = transport
        self._handlers: dict = {}
        if hasattr(transport, "set_handler"):
            transport.set_handler(self._route)

    def register_channel(self, channel_id: str, handler) -> None:
        self._handlers[channel_id] = handler

    def register(self, node_id: int, handler) -> None:
        # an in-process transport registers whole nodes
        self._transport.register(node_id, self._route)

    def _route(self, req: ob.StepRequest) -> None:
        h = self._handlers.get(req.channel)
        if h is not None:
            h(req)

    def send(self, frm: int, to: int, req: ob.StepRequest) -> None:
        self._transport.send(frm, to, req)

    def set_peer(self, node_id: int, addr) -> None:
        self._transport.set_peer(node_id, addr)


__all__ = ["Registrar", "ChainSupport", "ChannelStepRouter"]
