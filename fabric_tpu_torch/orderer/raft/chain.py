"""The raft consenter chain (the port's copy of
`fabric_tpu/orderer/raft/chain.py`; reference
orderer/consensus/etcdraft/chain.go).

The leader runs the block cutter and proposes whole marshaled blocks as
raft entries (a marker byte, `C` for a config block and `N` otherwise,
then the block); every node writes the committed blocks through its block
writer, so the block log is the replicated state machine.  Followers
forward client envelopes to the leader (a SubmitRequest).  One loop
thread owns the `RaftNode`: a tick a loop pass at the tick interval, and
each pass drains a Ready batch in etcd's order: persist to the WAL, then
apply, then send.  Snapshots record the last block covered; a node behind
the compaction point catches up through `block_puller` when it has one.
"""

from __future__ import annotations

import queue
import threading
import time

from fabric_tpu_torch import protoutil
from fabric_tpu_torch.common import tracing
from fabric_tpu_torch.common.flogging import must_get_logger
from fabric_tpu_torch.devtools.lockwatch import spawn_thread
from fabric_tpu_torch.orderer.blockcutter import BlockCutter
from fabric_tpu_torch.orderer.raft.raftcore import RaftNode
from fabric_tpu_torch.orderer.raft.wal import WAL
from fabric_tpu_torch.protos import common as cb
from fabric_tpu_torch.protos import orderer as ob


class RaftChain:
    def __init__(self, channel_id: str, node_id: int,
                 consenters: list[ob.Consenter], cutter: BlockCutter, writer,
                 transport, wal_dir: str | None = None,
                 batch_timeout_s: float = 1.0, tick_interval_s: float = 0.05,
                 election_tick: int = 10, heartbeat_tick: int = 1,
                 snapshot_interval_size: int = 16 << 20, on_block=None,
                 block_puller=None,
                 eviction_suspicion_ticks: int | None = None,
                 active_consenters_probe=None, on_eviction=None,
                 metrics=None):
        """Eviction suspicion (reference etcdraft/eviction.go): after
        `eviction_suspicion_ticks` ticks without a leader (by default ten
        minutes of ticks), the chain asks `active_consenters_probe()` for
        the cluster's consenter set (None: the peers are unreachable,
        keep waiting); absent from it, the chain halts and calls
        `on_eviction()`, with which the registrar demotes the node."""
        self.channel_id = channel_id
        self.node_id = node_id
        self._cutter = cutter
        self._writer = writer
        self._transport = transport
        self._timeout = batch_timeout_s
        self._tick_interval = tick_interval_s
        self._snap_interval = snapshot_interval_size
        self._on_block = on_block or (lambda blk: None)
        self._block_puller = block_puller
        self.consenters = {c.id: c for c in consenters}
        # common.metrics.RaftMetrics | None: the term, leader-change and
        # committed-index gauges, set on the loop thread
        self._metrics = metrics
        self._seen_term = -1
        self._seen_leader = 0
        # the last leader other than none: leader changes count only a
        # move to a different node (not the first election)
        self._seen_nonzero_leader = 0
        self._seen_commit = -1
        # detached trace roots of proposed blocks, by number: raft.propose
        # opens under the root, raft.apply joins it at commit
        self._block_roots: dict[int, object] = {}

        self._wal = WAL(wal_dir, metrics=metrics) if wal_dir else None
        hs, log, snap = (self._wal.load() if self._wal
                         else (ob.HardState(), None, None))
        voters = set(self.consenters)
        if snap is not None and snap.meta.voters:
            voters = set(snap.meta.voters)
        self.node = RaftNode(node_id, voters, log=log,
                             election_tick=election_tick,
                             heartbeat_tick=heartbeat_tick, term=hs.term,
                             voted_for=hs.voted_for, commit=hs.commit)
        self.node.snapshot_payload_fn = self._fill_snapshot
        self._applied_bytes_since_snap = 0

        self._probe = active_consenters_probe
        self._on_evicted = on_eviction
        self._suspicion_ticks = eviction_suspicion_ticks or max(
            1, int(600.0 / tick_interval_s))
        self._no_leader_ticks = 0
        self._probe_inflight = False
        self.evicted = threading.Event()

        self._creator_number: int | None = None  # set by _reset_creator
        self._creator_hash = b""
        self._was_leader = False
        self._waiting: list = []  # submissions held until a leader exists
        self._events: queue.Queue = queue.Queue()
        self._halted = threading.Event()
        self._thread = spawn_thread(target=self._run,
                                    name=f"raft-{channel_id}-{node_id}",
                                    kind="service")

    # -- the consenter interface -------------------------------------------

    def start(self) -> None:
        self._thread.start()

    def halt(self) -> None:
        self._halted.set()
        self._events.put(("halt", None))
        self._thread.join(timeout=5)
        # end the roots of blocks proposed and never applied, once the
        # loop thread is gone (a join that timed out leaves it running)
        if not self._thread.is_alive():
            roots, self._block_roots = self._block_roots, {}
            for root in roots.values():
                root.annotate(abandoned=True)
                root.end()
        if self._wal:
            self._wal.close()

    def set_metrics(self, metrics) -> None:
        """Bind a RaftMetrics after construction (the WAL's histograms
        too)."""
        self._metrics = metrics
        self._seen_term = -1
        self._seen_commit = -1
        if self._wal is not None:
            self._wal.set_metrics(metrics)

    def wait_ready(self) -> None:
        return

    def set_batch_timeout(self, seconds: float) -> None:
        """Adopt a committed BatchTimeout."""
        self._timeout = seconds

    @property
    def is_leader(self) -> bool:
        return self.node.is_leader

    @property
    def leader(self) -> int:
        return self.node.leader

    def order(self, env: cb.Envelope, config_seq: int = 0) -> None:
        if self._halted.is_set():
            raise RuntimeError("chain is halted")
        self._events.put(("submit", (env.encode(), False, config_seq)))

    def configure(self, env: cb.Envelope, config_seq: int = 0) -> None:
        if self._halted.is_set():
            raise RuntimeError("chain is halted")
        self._events.put(("submit", (env.encode(), True, config_seq)))

    def propose_conf_change(self, cc: ob.ConfChange) -> None:
        """Propose a consenter-set change; raises on a node that is not
        the leader (the caller resubmits to the leader)."""
        if self._halted.is_set():
            raise RuntimeError("chain is halted")
        if not self.node.is_leader:
            raise RuntimeError(
                f"node {self.node_id} is not the raft leader; submit the "
                "consenter change to the leader")
        self._events.put(("conf", cc))

    def handle_step(self, req: ob.StepRequest) -> None:
        """The transport's entry (reference cluster/comm.go
        DispatchConsensus)."""
        if req.which("payload") == "consensus":
            self._events.put(("raft", req.consensus))
        else:
            sub = req.submit
            self._events.put(("submit", (sub.envelope, sub.is_config,
                                         sub.config_seq)))

    # -- the loop ----------------------------------------------------------

    def _run(self) -> None:
        last_tick = time.monotonic()
        batch_deadline: float | None = None
        while not self._halted.is_set():
            now = time.monotonic()
            wait = max(0.0, (last_tick + self._tick_interval) - now)
            if batch_deadline is not None:
                wait = min(wait, max(0.0, batch_deadline - now))
            try:
                kind, payload = self._events.get(timeout=wait)
            except queue.Empty:
                kind, payload = "timer", None
            now = time.monotonic()
            if kind == "halt":
                break
            if kind == "raft":
                self.node.step(payload)
            elif kind == "conf":
                if self.node.is_leader:
                    self.node.propose_conf_change(payload)
                # else leadership moved since the call: the proposal is
                # lost, as if the leader had crashed before appending
            elif kind == "submit":
                batch_deadline = self._submit(payload, now, batch_deadline)
            if now - last_tick >= self._tick_interval:
                self.node.tick()
                last_tick = now
                self._tick_eviction_suspicion()
            if self._waiting and self.node.leader != 0:
                for p in self._waiting:
                    self._events.put(("submit", p))
                self._waiting = []
            if batch_deadline is not None and now >= batch_deadline:
                if self.node.is_leader and self._cutter.pending:
                    self._propose_batch(self._cutter.cut())
                batch_deadline = None
            self._drain_ready()
        self._drain_ready()  # the last outputs (the persisted state)

    def _submit(self, payload, now: float, batch_deadline):
        env_bytes, is_config, config_seq = payload
        if self.node.leader == 0 and len(self._waiting) < 10000:
            # no leader yet: hold the envelope rather than drop it
            self._waiting.append(payload)
        elif self.node.is_leader:
            if is_config:
                for batch in (self._cutter.cut(), [env_bytes]):
                    if batch:
                        self._propose_batch(batch,
                                            is_config=(batch == [env_bytes]))
                return None
            batches, pending = self._cutter.ordered(env_bytes)
            for b in batches:
                self._propose_batch(b)
            if pending and batch_deadline is None:
                return now + self._timeout
            if not pending:
                return None
        else:
            self._forward_to_leader(env_bytes, is_config, config_seq)
        return batch_deadline

    def _tick_eviction_suspicion(self) -> None:
        """One tick of the suspicion clock (the loop thread)."""
        if self._probe is None:
            return
        if self.node.leader != 0 or self.node.is_leader:
            self._no_leader_ticks = 0
            return
        self._no_leader_ticks += 1
        if self._no_leader_ticks < self._suspicion_ticks:
            return
        self._no_leader_ticks = 0  # probe once a suspicion period
        if self._probe_inflight:
            return
        self._probe_inflight = True
        # the probe is a cluster call: off the loop thread, so a slow
        # peer never stalls ticks and steps
        spawn_thread(target=self._confirm_eviction,
                     name=f"raft-eviction-probe-{self.channel_id}",
                     kind="worker").start()

    def _confirm_eviction(self) -> None:
        try:
            try:
                active = self._probe()
            except Exception:
                active = None  # unreachable: keep waiting
            if active is None or self.node.id in active:
                return
            # evicted: stop consenting; the registrar's callback may join
            # the loop thread through halt(), so it runs here
            self.evicted.set()
            self._halted.set()
            self._events.put(("halt", None))
            if self._on_evicted is not None:
                self._on_evicted()
        finally:
            self._probe_inflight = False

    # -- blocks on the leader ----------------------------------------------
    # The next block chains onto the last proposed block, which raft may
    # not have committed yet (reference etcdraft/blockcreator.go); reset
    # at each gain of leadership.

    def _reset_creator(self) -> None:
        h = self._writer.height
        last = self._writer.last_block() if h else None
        self._creator_number = h - 1
        self._creator_hash = (protoutil.block_header_hash(last.header)
                              if last is not None else b"")

    def _propose_batch(self, env_batch: list[bytes],
                       is_config: bool = False) -> None:
        if not env_batch:
            return
        if self._creator_number is None:
            self._reset_creator()
        blk = protoutil.new_block(self._creator_number + 1,
                                  self._creator_hash)
        blk.data.data.extend(env_batch)
        blk.header.data_hash = protoutil.block_data_hash(blk.data)
        self._creator_number = blk.header.number
        self._creator_hash = protoutil.block_header_hash(blk.header)
        data = (b"C" if is_config else b"N") + blk.encode()
        if not tracing.enabled():
            self.node.propose(data)
            return
        num = blk.header.number
        root = tracing.begin("raft.block", detach=True, cat="pipeline",
                             block=num, channel=self.channel_id)
        while len(self._block_roots) >= 128:
            stale = self._block_roots.pop(next(iter(self._block_roots)))
            stale.annotate(abandoned=True)
            stale.end()
        self._block_roots[num] = root
        with tracing.attached(root.ctx), tracing.span(
                "raft.propose", cat="stage", block=num,
                envelopes=len(env_batch), is_config=is_config):
            self.node.propose(data)

    def _forward_to_leader(self, env_bytes: bytes, is_config: bool,
                           seq: int) -> None:
        leader = self.node.leader
        if leader in (0, self.node.id):
            return  # no leader: the client retries
        req = ob.StepRequest(channel=self.channel_id, submit=ob.SubmitRequest(
            channel=self.channel_id, envelope=env_bytes,
            is_config=is_config, config_seq=seq))
        self._transport.send(self.node.id, leader, req)

    def _observe(self) -> None:
        m = self._metrics
        if m is None:
            return
        if self.node.term != self._seen_term:
            self._seen_term = self.node.term
            m.term.set(self._seen_term)
        leader = self.node.leader
        if leader != self._seen_leader:
            if leader != 0:
                if self._seen_nonzero_leader not in (0, leader):
                    m.leader_changes.add()
                self._seen_nonzero_leader = leader
            self._seen_leader = leader
        if self.node.commit != self._seen_commit:
            self._seen_commit = self.node.commit
            m.committed_index.set(self._seen_commit)

    def _drain_ready(self) -> None:
        """Drain one Ready batch: the hard state and entries to the WAL
        first, then apply, then send.  ready() moves the node's cursors
        at once, so a crash between it and the save loses only that
        in-memory step: nothing outside happened before the save, and a
        restart replays every committed entry not applied (`_apply`
        skips the blocks below the writer's height)."""
        if self.node.is_leader and not self._was_leader:
            self._reset_creator()
        self._was_leader = self.node.is_leader
        self._observe()
        rd = self.node.ready()
        if rd.empty():
            return
        if self._wal and (rd.hard_state is not None or rd.persist_entries):
            self._wal.save(rd.hard_state, rd.persist_entries)
        if rd.snapshot is not None:
            self._install_snapshot(rd.snapshot)
        for entry in rd.committed:
            self._apply(entry)
        for msg in rd.messages:
            self._transport.send(self.node.id, msg.to, ob.StepRequest(
                channel=self.channel_id, consensus=msg))

    def _apply(self, entry: ob.Entry) -> None:
        if entry.type == ob.ENTRY_CONF_CHANGE:
            cc = ob.ConfChange.decode(entry.data)
            self.node.apply_conf_change(cc)
            if cc.action == ob.ConfChange.ADD_NODE:
                self.consenters[cc.consenter.id] = cc.consenter
            else:
                self.consenters.pop(cc.consenter.id, None)
            return
        if not entry.data:
            return  # the leader's no-op
        is_config = entry.data[:1] == b"C"
        blk = cb.Block.decode(entry.data[1:])
        # raft.apply joins the block's root on the node that proposed it
        # (a follower's span has none); the root ends here
        root = self._block_roots.pop(blk.header.number, None)
        if not tracing.enabled():
            self._apply_block(blk, is_config, entry)
            return
        with tracing.attached(root.ctx if root is not None else None), \
                tracing.span("raft.apply", cat="stage",
                             block=blk.header.number, index=entry.index):
            self._apply_block(blk, is_config, entry)
        if root is not None:
            root.end()

    def _apply_block(self, blk: cb.Block, is_config: bool,
                     entry: ob.Entry) -> None:
        if blk.header.number < self._writer.height:
            tracing.annotate(replayed=True)
            return  # written already (a replay after a restart)
        last = self._writer.last_block() if self._writer.height else None
        if last is not None and blk.header.previous_hash != \
                protoutil.block_header_hash(last.header):
            # A leader elected with committed entries not yet applied
            # anchors its creator on a stale tail, and raft then commits
            # both the old leader's block and the new leader's of the same
            # number: appending the loser would fork the chain on every
            # replica.  The check reads only the applied prefix, so every
            # replica drops the same block; its envelopes come back when
            # clients resubmit.
            must_get_logger("orderer.consensus.raft").warning(
                "dropping non-chaining committed block %d on %s (stale "
                "leader creator); clients must resubmit",
                blk.header.number, self.channel_id)
            tracing.annotate(dropped=True)
            if self.node.is_leader:
                self._reset_creator()
            return
        self._writer.write_block(blk, is_config=is_config)
        if self.node.is_leader and self._creator_number is not None and (
                blk.header.number > self._creator_number
                or (blk.header.number == self._creator_number
                    and protoutil.block_header_hash(blk.header)
                    != self._creator_hash)):
            # a block this node did not create reached or passed its
            # predicted tail: chain the next proposal onto the real one
            self._reset_creator()
        self._on_block(blk)
        self._applied_bytes_since_snap += len(entry.data)
        if self._applied_bytes_since_snap >= self._snap_interval:
            self._take_snapshot(entry)

    # -- snapshots ---------------------------------------------------------

    def _fill_snapshot(self, snap: ob.Snapshot) -> None:
        h = self._writer.height
        snap.block_number = max(h - 1, 0)
        if h:
            last = self._writer.last_block()
            if last is not None:
                snap.block_hash = protoutil.block_header_hash(last.header)

    def _take_snapshot(self, at_entry: ob.Entry) -> None:
        self._applied_bytes_since_snap = 0
        self.node.compact(at_entry.index)
        snap = self.node._make_snapshot()
        if self._wal:
            self._wal.save_snapshot(snap)

    def _install_snapshot(self, snap: ob.Snapshot) -> None:
        """Behind the cluster's compaction point: pull the missing blocks
        from another orderer, when there is a puller (reference
        etcdraft/blockpuller.go)."""
        if self._wal:
            self._wal.save_snapshot(snap)
        target = snap.block_number
        if self._block_puller is None:
            return
        while self._writer.height <= target:
            blk = self._block_puller(self._writer.height)
            if blk is None:
                break
            self._writer.write_block(blk, is_config=False)
            self._on_block(blk)


__all__ = ["RaftChain"]
