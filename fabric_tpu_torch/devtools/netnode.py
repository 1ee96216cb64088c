"""netnode — one node of a netharness topology, run as its own OS
process (``python -m fabric_tpu_torch.devtools.netnode <config.json>``).

The multi-process sibling of ``node/peer_node.py`` / ``node/
orderer_node.py`` for hosts without the ``cryptography`` package: the
identity plane comes from :mod:`fabric_tpu_torch.devtools.netident`, but the
machinery under test is the production stack —

  orderer role: raft consensus over ``TCPTransport`` (WAL recovery on
    restart), blockcutter/blockwriter, ``ab.Broadcast``/``ab.Deliver``
    over the framed RPC transport;
  peer role: ``LedgerProvider`` (sqlite + block files, REAL crash
    recovery after kill -9), ``TxValidator`` -> ``Committer``, gossip
    over ``TCPGossipComm`` (push/pull/state transfer/leader election),
    the ``DeliverClient`` pulling from the orderer cluster, snapshot
    generation/serving, and the operations endpoint (``/traces``).

Lifecycle contract (what the harness relies on):

- startup is CRASH-TOLERANT: a peer restarted after SIGKILL reopens its
  ledger through normal recovery; a half-finished snapshot import is
  discarded (``discard_failed_import``) and the node rejoins from its
  configured snapshot;
- SIGTERM is a CLEAN stop: every component's stop path runs and the
  process exits 0 (the harness's graceful-stop schedule entries);
- SIGKILL needs no cooperation, which is the point.

The control surface rides the same RPC server the data plane uses:
``net.Status`` (readiness + heights), ``net.Check`` (the invariants
oracle run in-process, over THIS node's stores), ``net.TraceDump``,
``admin.SnapshotSubmit``/``admin.SnapshotFetch``/``admin.Height``.
"""

from __future__ import annotations

import json
import os
import signal
import sys
import threading


def _configure_env(cfg: dict) -> None:
    """Arm per-node chaos/trace seams BEFORE fabric imports: the
    harness plumbs per-node FABRIC_TPU_FAULTLINE / FABRIC_TPU_TRACE
    through the child environment (faultfuzz's multi-process mode), and
    those modules read the environment at import time."""
    for key, val in (cfg.get("env") or {}).items():
        os.environ.setdefault(key, str(val))


def main(argv: list[str]) -> int:
    with open(argv[0], "r", encoding="utf-8") as f:
        cfg = json.load(f)
    _configure_env(cfg)

    # imports AFTER env plumbing (faultline/tracing arm from env)
    from fabric_tpu_torch.common import tracing
    from fabric_tpu_torch.devtools import invariants, netident, netsplit

    # this process's vantage point for the netsplit seam — a plan
    # pushed later over net.Netsplit then judges links without having
    # to carry a per-node "node" field itself
    netsplit.set_local_node(cfg["name"])

    if cfg.get("trace"):
        tracing.arm(int(cfg["trace"]))
        # per-node id bases keep span/trace ids globally unique across
        # the topology, so merged network traces stay causally linked
        # instead of colliding at id 1 in every process
        tracing.reset_ids(int(cfg.get("trace_id_base", 0)))

    stop_evt = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop_evt.set())
    signal.signal(signal.SIGINT, lambda *_: stop_evt.set())

    role = cfg["role"]
    node = (
        _build_orderer(cfg, netident)
        if role == "orderer"
        else _build_peer(cfg, netident, invariants, tracing)
    )
    try:
        node.start()
        _touch(cfg.get("ready_file"))
        stop_evt.wait()
    finally:
        node.stop()
    return 0


def _touch(path: str | None) -> None:
    if path:
        with open(path, "w", encoding="utf-8") as f:
            f.write("ready\n")


def _netsplit_handler(body: bytes, stream) -> bytes:
    """``net.Netsplit``: arm/replace/heal this node's partition plan.
    Body: a netsplit plan JSON to arm; empty / ``null`` / ``{}`` heals
    (deactivates).  Shared by both roles — the harness's partition
    executor pushes per-node plan updates through this."""
    from fabric_tpu_torch.devtools import netsplit

    raw = body.decode("utf-8").strip() if body else ""
    if not raw or raw in ("null", "{}"):
        netsplit.deactivate()
        return json.dumps({"armed": False}, sort_keys=True).encode()
    plan = netsplit.activate(raw)
    return json.dumps({
        "armed": True,
        "label": plan.label,
        "mode": plan.mode,
        "groups": [list(g) for g in plan.groups],
    }, sort_keys=True).encode()


# -- orderer role -------------------------------------------------------------


class _OrdererSupport:
    """chain_getter target for the deliver service: the raft-ordered
    block store behind the fake channel bundle."""

    def __init__(self, store, bundle):
        self.store = store
        self.bundle = bundle


class NetOrderer:
    def __init__(self, cfg: dict):
        from fabric_tpu_torch.comm import RPCServer
        from fabric_tpu_torch.common.deliver import BlockNotifier, DeliverService
        from fabric_tpu_torch.devtools import netident
        from fabric_tpu_torch.ledger.blkstorage import BlockStore
        from fabric_tpu_torch.ledger.kvstore import open_kvstore
        from fabric_tpu_torch.orderer.blockcutter import BlockCutter
        from fabric_tpu_torch.orderer.blockwriter import BlockWriter
        from fabric_tpu_torch.orderer.raft import RaftChain
        from fabric_tpu_torch.orderer.raft.transport import TCPTransport
        from fabric_tpu_torch.protos import common as cb
        from fabric_tpu_torch.protos import orderer as ob

        self._ob = ob
        self._cb = cb
        self.cfg = cfg
        self.channel = cfg["channel"]
        root = cfg["root"]
        os.makedirs(root, exist_ok=True)
        # operations endpoint FIRST: the raft chain + WAL take their
        # metrics bundle at construction
        self.operations = None
        raft_metrics = None
        if cfg.get("ops_port") is not None:
            from fabric_tpu_torch.common.operations import System

            self.operations = System(
                ("127.0.0.1", int(cfg["ops_port"])), process_metrics=True
            )
            raft_metrics = self.operations.raft_metrics()
            from fabric_tpu_torch.common import profile

            if profile.enabled():
                profile.set_lock_metrics(self.operations.lock_metrics())
        self.kv = open_kvstore(os.path.join(root, "index.sqlite"))
        self.store = BlockStore(
            os.path.join(root, "chains"), self.kv, name=self.channel
        )
        genesis = netident.make_genesis(self.channel)
        if self.store.height == 0:
            self.store.add_block(genesis)
        self.writer = BlockWriter(self.store)
        node_id = int(cfg["node_id"])
        self.transport = TCPTransport(
            node_id, ("127.0.0.1", int(cfg["raft_port"])),
            metrics=raft_metrics,
        )
        consenters = []
        for cid, addr in sorted(
            cfg["consenters"].items(), key=lambda kv: int(kv[0])
        ):
            cid = int(cid)
            consenters.append(ob.Consenter(id=cid))
            if cid != node_id:
                self.transport.set_peer(cid, (addr[0], int(addr[1])))
        notifier = BlockNotifier()
        self.chain = RaftChain(
            self.channel,
            node_id,
            consenters,
            BlockCutter(
                max_message_count=int(cfg.get("max_message_count", 10))
            ),
            self.writer,
            self.transport,
            wal_dir=os.path.join(root, "wal"),
            batch_timeout_s=float(cfg.get("batch_timeout_s", 0.2)),
            tick_interval_s=float(cfg.get("tick_interval_s", 0.02)),
            on_block=lambda blk: (notifier.notify(),
                                  self._publish_height()),
            metrics=raft_metrics,
        )
        if self.operations is not None:
            # the orderer's height rides the same per-channel gauge
            # name the peers use, so netscope's lag/stall view sees
            # the ordering tip beside every peer's commit tip
            self._ledger_metrics = self.operations.ledger_metrics()
            self._publish_height()
            self.operations.register_checker(
                "raft", lambda: not self.chain._halted.is_set()
            )
        else:
            self._ledger_metrics = None
        self.transport.set_handler(self.chain.handle_step)
        bundle = netident.FakeBundle(k=1)
        self.deliver = DeliverService(
            lambda ch: (
                _OrdererSupport(self.store, bundle)
                if ch == self.channel else None
            ),
            netident.FakeCSP(),
            notifier=notifier,
        )
        self.rpc = RPCServer("127.0.0.1", int(cfg["rpc_port"]))
        if self.operations is not None:
            # same shape as the reference's grpc server interceptors:
            # per-method completed/duration series on the ops registry
            from fabric_tpu_torch.comm.instrument import instrument

            instrument(self.rpc, self.operations.metrics_provider)
        self.rpc.register("ab.Broadcast", self._broadcast)
        self.rpc.register("ab.BroadcastStream", self._broadcast_stream)
        self.rpc.register("ab.Deliver", self._deliver)
        self.rpc.register("net.Status", self._status)
        self.rpc.register("net.Netsplit", _netsplit_handler)
        self.rpc.register("net.TraceDump", self._trace_dump)

    def _publish_height(self) -> None:
        """The ordering tip on the same per-channel ``ledger_height``
        gauge the peers publish: netscope's derived lag then measures
        orderer tip minus slowest peer, and the stall detector covers
        orderers as subjects too."""
        lm = self._ledger_metrics
        if lm is not None:
            lm.height.With("channel", self.channel).set(
                self.store.height
            )

    def start(self) -> None:
        self.chain.start()
        self.rpc.start()
        if self.operations is not None:
            self.operations.start()

    def stop(self) -> None:
        self.rpc.stop()
        self.deliver.stop()
        self.chain.halt()
        self.transport.close()
        if self.operations is not None:
            self.operations.stop()
        self.kv.close()

    def _broadcast(self, body: bytes, stream) -> bytes:
        env = self._cb.Envelope.decode(body)
        self.chain.order(env)
        return self._ob.BroadcastResponse(status=self._cb.SUCCESS).encode()

    def _broadcast_stream(self, body: bytes, stream):
        """The gateway's pipelined submission path: client-streamed
        envelopes, one ack frame per ordered envelope (FIFO credits,
        not per-txid receipts), an empty frame ends the stream.  An
        ordering failure surfaces as the connection's ERR frame — the
        gateway fails over and resubmits its unresolved window."""
        ack = self._ob.BroadcastResponse(status=self._cb.SUCCESS).encode()
        while True:
            frame = stream.recv()
            if not frame:
                return None
            env = self._cb.Envelope.decode(frame)
            self.chain.order(env)
            stream.send(ack)

    def _deliver(self, body: bytes, stream):
        from fabric_tpu_torch.common.deliver import deliver_response_frames

        return deliver_response_frames(self.deliver, body)

    def _status(self, body: bytes, stream) -> bytes:
        return json.dumps({
            "role": "orderer",
            "name": self.cfg["name"],
            "height": self.store.height,
            "is_leader": self.chain.is_leader,
            "leader": self.chain.leader,
        }, sort_keys=True).encode()

    def _trace_dump(self, body: bytes, stream) -> bytes:
        from fabric_tpu_torch.common import tracing

        return json.dumps(tracing.export(), sort_keys=True).encode()


def _build_orderer(cfg: dict, netident) -> NetOrderer:
    return NetOrderer(cfg)


# -- peer role ----------------------------------------------------------------


class _PeerDeliverStore:
    """Durable-height view of the peer ledger for the deliver service:
    a gateway tailing this peer for commit statuses must only see
    blocks that are flushed and announced — a buffered group-commit
    block is neither readable nor guaranteed to survive a crash."""

    def __init__(self, ledger):
        self._ledger = ledger

    @property
    def height(self) -> int:
        return getattr(
            self._ledger, "durable_height", self._ledger.height
        )

    def get_block_by_number(self, num: int):
        return self._ledger.get_block_by_number(num)


class NetPeer:
    def __init__(self, cfg: dict, invariants, tracing):
        from fabric_tpu_torch.comm import RPCClient, RPCServer
        from fabric_tpu_torch.common.deliver import make_seek_info_envelope
        from fabric_tpu_torch.devtools import netident
        from fabric_tpu_torch.gossip import GossipRunner, GossipService
        from fabric_tpu_torch.gossip.comm import TCPGossipComm
        from fabric_tpu_torch.ledger import LedgerProvider, snapshot as snap
        from fabric_tpu_torch.peer.committer import Committer
        from fabric_tpu_torch.peer.deliverclient import DeliverClient
        from fabric_tpu_torch.peer.txvalidator import TxValidator
        from fabric_tpu_torch.protos import orderer as ob

        self._invariants = invariants
        self._tracing = tracing
        self._netident = netident
        self.cfg = cfg
        self.channel = cfg["channel"]
        self.name = cfg["name"]
        root = cfg["root"]
        os.makedirs(root, exist_ok=True)
        # operations endpoint FIRST (peer_node's ordering): the ledger
        # provider and validator take their metric bundles at
        # construction, and the checkers give /healthz?detail=1 real
        # per-component inputs for netscope's health timeline
        self.operations = None
        if cfg.get("ops_port") is not None:
            from fabric_tpu_torch.common import workpool
            from fabric_tpu_torch.common.operations import System

            self.operations = System(
                ("127.0.0.1", int(cfg["ops_port"])), process_metrics=True
            )
            workpool.set_metrics(self.operations.workpool_metrics())
            from fabric_tpu_torch.common import profile

            if profile.enabled():
                profile.set_lock_metrics(self.operations.lock_metrics())
            self.operations.register_checker(
                "workpool", workpool.health_checker()
            )
        self.provider = LedgerProvider(
            root,
            commit_metrics=(
                self.operations.commit_metrics()
                if self.operations is not None else None
            ),
            ledger_metrics=(
                self.operations.ledger_metrics()
                if self.operations is not None else None
            ),
        )
        genesis = netident.make_genesis(self.channel)
        join_dir = cfg.get("join_snapshot")
        try:
            if join_dir:
                self.ledger = self.provider.create_from_snapshot(join_dir)
            else:
                self.ledger = self.provider.create(genesis)
        except snap.SnapshotError:
            # crash-tolerant reopen: a kill -9 mid-import leaves the
            # half-import marker; discard the debris and retry (from
            # the snapshot when one is configured, else from genesis)
            self.provider.discard_failed_import(self.channel)
            self.ledger = (
                self.provider.create_from_snapshot(join_dir)
                if join_dir else self.provider.create(genesis)
            )
        orgs = int(cfg.get("orgs", 1))
        self.csp = netident.FakeCSP()
        bundle = netident.FakeBundle(k=1 if orgs < 2 else 2)
        self.validator = TxValidator(
            self.channel, self.ledger, bundle, self.csp,
            metrics=(
                self.operations.validate_metrics()
                if self.operations is not None else None
            ),
        )
        self.committer = Committer(self.validator, self.ledger)

        # deliver client over the orderer cluster's ab.Deliver, signed
        # with this node's fake identity (the orderer's deliver policy
        # verifies it)
        signer = netident.sign_as
        ident = b"cre:" + self.name.encode()

        class _Signer:
            def serialize(self):
                return ident

            def sign(self, msg: bytes) -> bytes:
                from fabric_tpu_torch.common.hashing import sha256

                return signer(ident, sha256(msg))

        def connect_fn(endpoint):
            def connect(start_num: int):
                client = RPCClient(endpoint[0], int(endpoint[1]),
                                   timeout=10.0)
                env = make_seek_info_envelope(
                    self.channel, start_num, 0x7FFFFFFFFFFFFFFF,
                    signer=_Signer(),
                )
                for raw in client.stream("ab.Deliver", env.encode()):
                    resp = ob.DeliverResponse.decode(raw)
                    if resp.which("Type") == "block":
                        yield resp.block
                    else:
                        return

            return connect

        self.deliver_client = DeliverClient(
            self.channel,
            [connect_fn(ep) for ep in cfg["orderer_endpoints"]],
            endpoint_addrs=[
                f"{ep[0]}:{int(ep[1])}"
                for ep in cfg["orderer_endpoints"]
            ],
            height_fn=lambda: self.ledger.height,
            sink=self._receive_block,
            max_backoff_s=2.0,
            metrics=(
                self.operations.deliver_metrics()
                if self.operations is not None else None
            ),
        )

        self.comm = TCPGossipComm(
            ("127.0.0.1", int(cfg["gossip_port"])),
            self.name.encode(),
            mcs=netident.NetMCS(bytes.fromhex(cfg["secret"])),
        )
        self.gossip = GossipService(
            self.comm, list(cfg.get("gossip_bootstrap") or [])
        )
        if self.operations is not None:
            self.gossip.set_metrics(self.operations.gossip_metrics())
        self.handle = self.gossip.join_channel(
            self.channel, self.committer,
            deliver_client=self.deliver_client,
        )
        self.runner = GossipRunner(
            self.gossip, float(cfg.get("gossip_tick_s", 0.1))
        )

        # peer-served ab.Deliver: the gateway's commit-status tail
        # reads blocks HERE, not from the orderer — peer blocks carry
        # the post-validation flags a VALID/INVALID verdict needs.
        # Access is 1-of-any (k=1) like the orderer's deliver gate;
        # the notifier fires from the commit listener, which runs
        # post-flush, so BLOCK_UNTIL_READY wakes only for durable
        # blocks (matching _PeerDeliverStore's height).
        from fabric_tpu_torch.common.deliver import BlockNotifier, DeliverService

        self._deliver_notifier = BlockNotifier()
        self.committer.add_commit_listener(
            lambda blk, flags: self._deliver_notifier.notify()
        )
        deliver_support = _OrdererSupport(
            _PeerDeliverStore(self.ledger), netident.FakeBundle(k=1)
        )
        self.deliver_service = DeliverService(
            lambda ch: deliver_support if ch == self.channel else None,
            self.csp,
            notifier=self._deliver_notifier,
        )

        self.rpc = RPCServer("127.0.0.1", int(cfg["rpc_port"]))
        if self.operations is not None:
            from fabric_tpu_torch.comm.instrument import instrument

            instrument(self.rpc, self.operations.metrics_provider)
        self.rpc.register("ab.Deliver", self._deliver)
        self.rpc.register("net.Status", self._status)
        self.rpc.register("net.Netsplit", _netsplit_handler)
        self.rpc.register("net.Check", self._check)
        self.rpc.register("net.TraceDump", self._trace_dump)
        self.rpc.register("admin.Height", self._height)
        self.rpc.register("admin.SnapshotSubmit", self._snapshot_submit)
        self.rpc.register("admin.SnapshotList", self._snapshot_list)
        self.rpc.register("admin.SnapshotCompleted", self._snapshot_completed)
        self.rpc.register("admin.SnapshotFetch", self._snapshot_fetch)

    def _receive_block(self, seq: int, block_bytes: bytes) -> None:
        self.handle.state.add_payload(seq, block_bytes, from_orderer=True)

    def _deliver(self, body: bytes, stream):
        from fabric_tpu_torch.common.deliver import deliver_response_frames

        return deliver_response_frames(self.deliver_service, body)

    def start(self) -> None:
        self.runner.start()
        self.rpc.start()
        if self.operations is not None:
            self.operations.start()

    def stop(self) -> None:
        self.rpc.stop()
        self.deliver_service.stop()
        self.runner.stop()
        self.deliver_client.stop()
        self.comm.close()
        if self.operations is not None:
            self.operations.stop()
        if self.ledger.snapshots is not None:
            self.ledger.snapshots.wait_idle(timeout=5.0)
        self.provider.close()

    # -- control surface ---------------------------------------------------

    def _status(self, body: bytes, stream) -> bytes:
        dc = self.deliver_client
        return json.dumps({
            "role": "peer",
            "name": self.name,
            "height": self.ledger.height,
            "durable_height": getattr(
                self.ledger, "durable_height", self.ledger.height
            ),
            "gossip_endpoint": self.comm.endpoint,
            "alive_peers": sorted(
                p.endpoint for p in self.gossip.discovery.alive_peers()
            ),
            "election_leader": self.handle.election.is_leader,
            "deliver_running": bool(
                dc._thread is not None and dc._thread.is_alive()
                and not dc._stop.is_set()
            ),
            "delivered": dc.delivered,
        }, sort_keys=True).encode()

    def _height(self, body: bytes, stream) -> bytes:
        return str(self.ledger.height).encode()

    def _check(self, body: bytes, stream) -> bytes:
        """The invariants oracle over THIS node's stores, plus a
        canonical state digest for cross-peer agreement and presence
        probes for harness-sampled keys."""
        req = json.loads(body.decode("utf-8")) if body else {}
        violations = self._invariants.check_ledger(self.ledger)
        missing = []
        for ns, key, value in req.get("expect", []):
            got = self.ledger.get_state(ns, key)
            if got != value.encode("utf-8"):
                missing.append([ns, key, repr(got)])
        return json.dumps({
            "name": self.name,
            "height": self.ledger.height,
            "violations": [v.as_dict() for v in violations],
            "missing": missing,
            "state_digest": self._invariants.state_digest(self.ledger),
        }, sort_keys=True).encode()

    def _trace_dump(self, body: bytes, stream) -> bytes:
        return json.dumps(
            self._tracing.export(), sort_keys=True
        ).encode()

    def _snapshot_submit(self, body: bytes, stream) -> bytes:
        req = json.loads(body.decode("utf-8"))
        res = self.ledger.snapshots.submit_request(
            int(req.get("block_number", 0))
        )
        return json.dumps(res).encode()

    def _snapshot_list(self, body: bytes, stream) -> bytes:
        return json.dumps(self.ledger.snapshots.list_pending()).encode()

    def _snapshot_completed(self, body: bytes, stream) -> bytes:
        from fabric_tpu_torch.ledger import snapshot as snap

        return json.dumps(snap.list_completed(
            self.provider.snapshots_root, self.channel
        )).encode()

    def _snapshot_fetch(self, body: bytes, stream):
        from fabric_tpu_torch.ledger import snapshot as snap

        req = json.loads(body.decode("utf-8"))
        sdir = snap.completed_snapshot_dir(
            self.provider.snapshots_root, self.channel,
            int(req["block_number"]),
        )
        return snap.stream_snapshot_dir(sdir)


def _build_peer(cfg: dict, netident, invariants, tracing) -> NetPeer:
    return NetPeer(cfg, invariants, tracing)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
