"""Orderer daemon: AtomicBroadcast over the framed RPC transport (the
port's copy of `fabric_tpu/node/orderer_node.py`).

Reference: orderer/common/server/main.go Main() assembles localconfig,
the multichannel registrar, and the Broadcast/Deliver gRPC handlers
(server.go:159,177); channel participation (join/remove without a system
channel, channelparticipation/restapi.go) is exposed as admin RPCs.

RPC surface:
  ab.Broadcast        Envelope -> BroadcastResponse
  ab.BroadcastStream  a duplex stream: a frame an Envelope, an ack frame
                      (BroadcastResponse) each, in order (the gateway's
                      pipelined submission; the JAX package's orderer
                      node serves no such method)
  ab.Deliver          signed SeekInfo Envelope -> stream DeliverResponse
  participation.Join  genesis Block -> channel id (join without system
                      channel)
  participation.Onboard  JSON {"channel", "from", "genesis"} -> JSON
                      {"channel", "height"} (replicate a channel)
  participation.List  "" -> ChannelQueryResponse (channel ids)

A restarted orderer resumes each channel with the config of the block it
is given (the genesis block), as the reference does: `Registrar.startup`
builds each chain's bundle from it.
"""

from __future__ import annotations

from fabric_tpu_torch.comm import RPCServer
from fabric_tpu_torch.common.deliver import BlockNotifier, DeliverService
from fabric_tpu_torch.orderer.broadcast import (
    BroadcastHandler,
    broadcast_stream_handler,
)
from fabric_tpu_torch.orderer.multichannel import Registrar
from fabric_tpu_torch.protos import common as cb
from fabric_tpu_torch.protos import orderer as ob
from fabric_tpu_torch.protos import peer as pb


class OrdererNode:
    def __init__(
        self,
        root_dir: str | None,
        csp,
        signer=None,
        host: str = "127.0.0.1",
        port: int = 0,
        genesis_blocks: list | None = None,
        consenter_overrides: dict | None = None,
        node_id: int = 1,
        transport=None,
        tls=None,
        keepalive=None,
        operations_port: int | None = None,
        operations_host: str = "127.0.0.1",
    ):
        self.tls = tls  # comm.tls.TLSCredentials | None
        # operations endpoint (reference orderer main.go serves the same
        # core/operations system): /metrics carries the raft metrics,
        # /healthz the registrar-halted checker
        self.operations = None
        raft_metrics = None
        if operations_port is not None:
            from fabric_tpu_torch.common.operations import System

            self.operations = System(
                (operations_host, operations_port), process_metrics=True
            )
            raft_metrics = self.operations.raft_metrics()
            if transport is not None and hasattr(transport, "set_metrics"):
                transport.set_metrics(raft_metrics)
            self.operations.register_checker(
                "registrar",
                lambda: not getattr(self.registrar, "_halted", False),
            )
            from fabric_tpu_torch.common import profile

            if profile.enabled():
                profile.set_lock_metrics(self.operations.lock_metrics())
        self.registrar = Registrar(
            root_dir,
            csp,
            signer=signer,
            node_id=node_id,
            transport=transport,
            consenter_overrides=consenter_overrides,
            raft_metrics=raft_metrics,
        )
        self._csp = csp
        notifier = BlockNotifier()
        self.deliver = DeliverService(
            self.registrar.get_chain,
            csp,
            policy_path="/Channel/Readers",
            notifier=notifier,
        )
        self.registrar.add_block_listener(
            lambda ch, blk: notifier.notify()
        )
        self.broadcast = BroadcastHandler(self.registrar)
        if genesis_blocks:
            self.registrar.startup(genesis_blocks)

        self._signer = signer
        self.rpc = RPCServer(host, port, tls=tls, keepalive=keepalive)
        self.rpc.register("ab.Broadcast", self._broadcast)
        self.rpc.register("ab.BroadcastStream",
                          broadcast_stream_handler(self.registrar))
        self.rpc.register("ab.Deliver", self._deliver)
        self.rpc.register("participation.Join", self._join)
        self.rpc.register("participation.Onboard", self._onboard)
        self.rpc.register("participation.List", self._list)

    @property
    def addr(self):
        return self.rpc.addr

    def start(self) -> None:
        self._warn_expiring_certs()
        self.rpc.start()
        if self.operations is not None:
            self.operations.start()

    def _warn_expiring_certs(self) -> None:
        """Week-ahead warnings for the orderer's signing and TLS certs
        (reference expiration.go TrackExpiration, orderer main.go)."""
        from fabric_tpu_torch.common.crypto import warn_node_cert_expirations
        from fabric_tpu_torch.common.flogging import must_get_logger

        warn_node_cert_expirations(
            self._signer, self.tls, "signing",
            must_get_logger("orderer").warning,
        )

    def stop(self) -> None:
        # idempotent: a process reaches stop() from its signal handler and
        # from its finally block
        if getattr(self, "_stopped", False):
            return
        self._stopped = True
        self.rpc.stop()
        self.deliver.stop()
        self.registrar.halt_all()
        if self.operations is not None:
            self.operations.stop()

    # -- handlers ----------------------------------------------------------

    def _broadcast(self, body: bytes, stream) -> bytes:
        status = self.broadcast.process_message(cb.Envelope.decode(body))
        return ob.BroadcastResponse(status=status).encode()

    def _deliver(self, body: bytes, stream):
        from fabric_tpu_torch.common.deliver import deliver_response_frames

        return deliver_response_frames(self.deliver, body)

    def _join(self, body: bytes, stream) -> bytes:
        cs = self.registrar.create_chain(cb.Block.decode(body))
        return cs.channel_id.encode("utf-8")

    def _onboard(self, body: bytes, stream) -> bytes:
        """Cluster replication/onboarding (reference orderer/common/
        cluster/replication.go): pull an existing channel's chain from
        another orderer, verify it — hash chain, data hashes, and
        orderer signatures under the config in force at each height,
        anchored at a locally supplied genesis block — then join with
        the replicated ledger.  Request: JSON {"channel", "from",
        "genesis": hex(Block)}; the genesis is the caller's trust
        anchor, never taken from the remote."""
        import binascii
        import json

        from fabric_tpu_torch import protoutil
        from fabric_tpu_torch.comm import RPCClient
        from fabric_tpu_torch.common.channelconfig import bundle_from_genesis
        from fabric_tpu_torch.common.deliver import make_seek_info_envelope
        from fabric_tpu_torch.orderer.blockwriter import (
            verify_block_signature,
        )

        req = json.loads(body)
        channel_id = req["channel"]
        genesis_raw = binascii.unhexlify(req["genesis"])
        genesis = cb.Block.decode(genesis_raw)
        if self.registrar.get_chain(channel_id) is not None:
            raise ValueError(f"channel {channel_id!r} already exists")
        host, _, port = req["from"].rpartition(":")
        client = RPCClient(
            host or "127.0.0.1", int(port), timeout=30.0, tls=self.tls
        )
        env = make_seek_info_envelope(
            channel_id, 0, "newest", signer=self._signer,
            behavior=ob.SeekInfo.FAIL_IF_NOT_READY,
        )
        blocks = []
        final_status = None
        for raw in client.stream("ab.Deliver", env.encode()):
            resp = ob.DeliverResponse.decode(raw)
            if resp.which("Type") == "block":
                blocks.append(resp.block)
            else:
                final_status = resp.status
        if final_status != cb.SUCCESS:
            raise ValueError(f"deliver ended with status {final_status}")
        if not blocks:
            raise ValueError(f"no blocks for channel {channel_id!r}")
        if blocks[0].encode() != genesis.encode():
            raise ValueError("remote genesis differs from the trust anchor")

        bundle = bundle_from_genesis(genesis, self._csp)
        policy = bundle.policy_manager.get_policy(
            "/Channel/Orderer/BlockValidation"
        )
        prev_hash = protoutil.block_header_hash(genesis.header)
        for i, blk in enumerate(blocks[1:], start=1):
            if blk.header.number != i:
                raise ValueError(
                    f"gap in pulled chain: got {blk.header.number}, want {i}"
                )
            if blk.header.previous_hash != prev_hash:
                raise ValueError(f"block {i} breaks the hash chain")
            if blk.header.data_hash != protoutil.block_data_hash(blk.data):
                raise ValueError(f"block {i} data hash mismatch")
            if policy is not None and not verify_block_signature(
                blk, policy, self._csp
            ):
                raise ValueError(
                    f"block {i} fails signature verification"
                )
            prev_hash = protoutil.block_header_hash(blk.header)
            # a config block changes the verifier for subsequent blocks
            # (reference replication re-derives per config)
            try:
                env0 = protoutil.extract_envelope(blk, 0)
                if protoutil.channel_header(env0).type == cb.CONFIG:
                    bundle = bundle_from_genesis(blk, self._csp)
                    policy = bundle.policy_manager.get_policy(
                        "/Channel/Orderer/BlockValidation"
                    )
            except Exception:
                pass
        cs = self.registrar.create_chain(genesis, extra_blocks=blocks[1:])
        return json.dumps(
            {"channel": channel_id, "height": cs.store.height}
        ).encode()

    def _list(self, body: bytes, stream) -> bytes:
        return pb.ChannelQueryResponse(channels=[
            pb.ChannelInfo(channel_id=ch)
            for ch in self.registrar.channel_list()]).encode()


__all__ = ["OrdererNode"]
