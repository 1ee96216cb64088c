"""The port's gateway and its `ab.BroadcastStream` handler against the JAX
package's, and the gossip slice as a whole.

- The scenarios of `tests/test_gateway.py`, each run on both packages
  with the same fakes (an RPC orderer that acks each frame, or dies after
  N; a socket-free stream) and a seeded virtual clock: dedup, backpressure
  and recovery, the adaptive window, failover in index order with no tx
  lost, a submit after a stream loss, TIMEOUT on a wait and at `stop`,
  the faultline points and a seeded torn write.  The observable results
  (statuses, acks, windows, endpoint logs, metric samples) are equal.
- The port's stream handler over the port's RPC acks each frame with
  the status the channel's filters give (the JAX `BroadcastHandler`'s on
  the same envelopes), where the JAX package's only server of the stream
  (`devtools/netnode.py`) acks SUCCESS without the filters: the
  divergence, pinned.  A JAX and a port `Gateway` both submit through
  it, and a torn stream fails over to the other endpoint.
- The slice: 2 blocks of 20 endorsed transactions (two with a failing
  endorsement) through a `Gateway` into a solo orderer with the stream
  handler, a leader's deliver client and two more peers fed by gossip on
  an `InProcGossipNet`, each committing through `PrivDataCoordinator`
  (the port's on `CUDACSP(device="cpu")`'s host route), the last peer
  joining late and catching up by state transfer: the same statuses,
  flags and states in both packages, every txid resolved.
- The port's gateway over mutual TLS: its sender and ack reader share
  one TLS connection (`DuplexStream` serializes the two).
"""

import threading
import time
import types

import numpy as np
import pytest

import chip_smoke
from fabric_tpu.comm import RPCClient as JaxRPCClient
from fabric_tpu.comm import RPCServer as JaxRPCServer
from fabric_tpu.common import deliver as jax_deliver
from fabric_tpu.common import privdata as jax_pd
from fabric_tpu.common.channelconfig import bundle_from_genesis as jax_bundle
from fabric_tpu.common.metrics import GatewayMetrics as JaxGatewayMetrics
from fabric_tpu.common.metrics import PrometheusProvider as JaxProm
from fabric_tpu.csp import SWCSP
from fabric_tpu.devtools import clockskew as jax_clock
from fabric_tpu.devtools import faultline as jax_fl
from fabric_tpu.devtools.netnode import NetOrderer
from fabric_tpu.devtools.netscope import parse_prometheus
from fabric_tpu.gateway import core as jax_gw
from fabric_tpu.gossip import GossipService as JaxService
from fabric_tpu.gossip import comm as jax_gcomm
from fabric_tpu.gossip import privdata as jax_privdata
from fabric_tpu.ledger import kvstore as jax_kv
from fabric_tpu.ledger.kvledger import LedgerProvider as JaxProvider
from fabric_tpu.ledger.transientstore import TransientStore as JaxTransient
from fabric_tpu.msp import SigningIdentity as JaxSigner
from fabric_tpu.orderer.broadcast import BroadcastHandler as JaxHandler
from fabric_tpu.orderer.multichannel import Registrar as JaxRegistrar
from fabric_tpu.peer.deliverclient import DeliverClient as JaxClient
from fabric_tpu.peer.txvalidator import TxValidator as JaxValidator
from fabric_tpu.protos.common import common_pb2
from fabric_tpu.protos.orderer import ab_pb2
from fabric_tpu_torch import protoutil as pu
from fabric_tpu_torch.comm import RPCClient as PortRPCClient
from fabric_tpu_torch.comm import RPCServer as PortRPCServer
from fabric_tpu_torch.common import deliver as port_deliver
from fabric_tpu_torch.common import privdata as port_pd
from fabric_tpu_torch.common import workpool
from fabric_tpu_torch.common.channelconfig import (
    bundle_from_genesis as port_bundle,
)
from fabric_tpu_torch.common.crypto import key_pem
from fabric_tpu_torch.common.hashing import sha256
from fabric_tpu_torch.common.metrics import (
    GatewayMetrics as PortGatewayMetrics,
)
from fabric_tpu_torch.common.metrics import PrometheusProvider as PortProm
from fabric_tpu_torch.csp.cuda.provider import CUDACSP
from fabric_tpu_torch.csp.hostref import HostCSP
from fabric_tpu_torch.devtools import clockskew as port_clock
from fabric_tpu_torch.devtools import faultline as port_fl
from fabric_tpu_torch.devtools import lockwatch as port_lw
from fabric_tpu_torch.gateway import core as port_gw
from fabric_tpu_torch.gossip import GossipService as PortService
from fabric_tpu_torch.gossip import comm as port_gcomm
from fabric_tpu_torch.gossip import privdata as port_privdata
from fabric_tpu_torch.ledger import kvstore as port_kv
from fabric_tpu_torch.ledger.kvledger import LedgerProvider as PortProvider
from fabric_tpu_torch.ledger.transientstore import TransientStore
from fabric_tpu_torch.orderer.broadcast import BroadcastHandler as PortHandler
from fabric_tpu_torch.orderer.broadcast import broadcast_stream_handler
from fabric_tpu_torch.orderer.multichannel import Registrar as PortRegistrar
from fabric_tpu_torch.peer.deliverclient import DeliverClient as PortClient
from fabric_tpu_torch.peer.txvalidator import TxValidator as PortValidator
from fabric_tpu_torch.protos import common as cb
from fabric_tpu_torch.protos import orderer as ob
from fabric_tpu_torch.protos import peer as pb

CHANNEL = "netchan"
CH = chip_smoke.VALIDATOR_CHANNEL

PKG = {
    "jax": types.SimpleNamespace(
        gw=jax_gw, RPCServer=JaxRPCServer, RPCClient=JaxRPCClient,
        Metrics=JaxGatewayMetrics, Prom=JaxProm, fl=jax_fl,
        clock=jax_clock),
    "port": types.SimpleNamespace(
        gw=port_gw, RPCServer=PortRPCServer, RPCClient=PortRPCClient,
        Metrics=PortGatewayMetrics, Prom=PortProm, fl=port_fl,
        clock=port_clock),
}
BOTH = ["jax", "port"]


@pytest.fixture(scope="module", autouse=True)
def _port_watch_gate():
    """The port's lockwatch ledgers are empty and its workers drained at
    the end of this file."""
    yield
    workpool.shutdown()
    assert not port_lw.drain_threads(timeout=15.0)
    assert not port_lw.violations and not port_lw.thread_violations


def _wait_until(pred, timeout=10.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.01)
    raise AssertionError(f"timeout waiting for {msg}")


def _env(key: str) -> bytes:
    """An envelope whose channel header carries a txid derived from key
    (the same bytes to both packages)."""
    chdr = cb.ChannelHeader(type=cb.ENDORSER_TRANSACTION, channel_id=CHANNEL,
                            tx_id=sha256(key.encode()).hex())
    return cb.Envelope(payload=cb.Payload(
        header=cb.Header(channel_header=chdr.encode()),
        data=key.encode()).encode()).encode()


def _block(envs, flags, num=0) -> bytes:
    blk = pu.new_block(num, b"")
    blk.data = cb.BlockData(data=list(envs))
    pu.set_tx_filter(blk, bytes(flags))
    return blk.encode()


class _MiniOrderer:
    """An `ab.BroadcastStream` endpoint of one package over its framed
    RPC: an ack a frame; `die_after` raises after N envelopes."""

    def __init__(self, pkg, die_after=None):
        self.p = PKG[pkg]
        self.received: list = []
        self._lock = threading.Lock()
        self._die_after = die_after
        self.srv = self.p.RPCServer("127.0.0.1", 0)
        self.srv.register("ab.BroadcastStream", self._handle)
        self.srv.start()

    def _handle(self, body, stream):
        while True:
            frame = stream.recv()
            if not frame:
                return None
            with self._lock:
                self.received.append(frame)
                n = len(self.received)
            if self._die_after is not None and n >= self._die_after:
                raise OSError("the orderer died mid-stream")
            stream.send(b"\x00")

    def count(self) -> int:
        with self._lock:
            return len(self.received)

    def txids(self) -> set:
        with self._lock:
            return {port_gw.txid_of(f) for f in self.received}

    def connect_factory(self):
        host, port = self.srv.addr
        return lambda: self.p.RPCClient(host, port, timeout=5).duplex(
            "ab.BroadcastStream")

    def stop(self):
        self.srv.stop()


class _FakeStream:
    """A socket-free duplex stream: sends are kept, recv blocks until
    close."""

    def __init__(self, sent: list):
        self._sent = sent
        self._closed = threading.Event()

    def send(self, body):
        self._sent.append(body)

    def finish(self):
        pass

    def recv(self):
        self._closed.wait()
        return None

    def close(self):
        self._closed.set()


def _samples(provider, name):
    return [v for n, _, v in parse_prometheus(provider.registry.expose())
            if n == name]


@pytest.mark.parametrize("pkg", BOTH)
def test_dedup_idempotent_resubmission(pkg):
    p = PKG[pkg]
    ord0 = _MiniOrderer(pkg)
    provider = p.Prom()
    gw = p.gw.Gateway(CHANNEL, [ord0.connect_factory()],
                      metrics=p.Metrics(provider))
    gw.start()
    try:
        env_a, env_b = _env("da"), _env("db")
        tx_a = p.gw.txid_of(env_a)
        r1 = gw.submit(env_a)
        assert r1.accepted and not r1.dedup and r1.txid == tx_a
        r2 = gw.submit(env_a)
        assert r2.accepted and r2.dedup and r2.status == p.gw.STATUS_PENDING
        r3 = gw.submit(env_b)
        assert r3.accepted and not r3.dedup
        _wait_until(lambda: ord0.count() == 2, msg="both ordered")
        time.sleep(0.05)  # a duplicate write would land now
        assert ord0.count() == 2
        assert ord0.txids() == {tx_a, p.gw.txid_of(env_b)}
        gw.observe_block(0, _block([env_a, env_b], [0, 1]))
        r4 = gw.submit(env_a)
        assert r4.accepted and r4.dedup and r4.status == p.gw.STATUS_VALID
        assert gw.submit_and_wait(env_a, timeout=1.0) == p.gw.STATUS_VALID
        assert gw.status(p.gw.txid_of(env_b)) == p.gw.STATUS_INVALID
        assert gw.in_flight == 0
        assert _samples(provider, "gateway_dedup_hits_total") == [3.0]
    finally:
        gw.stop()
        ord0.stop()


@pytest.mark.parametrize("pkg", BOTH)
def test_backpressure_reject_and_recover(pkg):
    p = PKG[pkg]
    ord0 = _MiniOrderer(pkg)
    provider = p.Prom()
    gw = p.gw.Gateway(CHANNEL, [ord0.connect_factory()],
                      metrics=p.Metrics(provider), min_window=1,
                      max_window=4, initial_window=2)
    gw.start()
    try:
        envs = [_env(f"bp{i}") for i in range(3)]
        assert gw.submit(envs[0]).accepted
        assert gw.submit(envs[1]).accepted
        rej = gw.submit(envs[2])
        assert not rej.accepted
        assert rej.retry_after_s == 0.05 and rej.status == "PENDING"
        assert gw.in_flight == 2
        gw.observe_block(0, _block(envs[:2], [0, 0]))
        assert gw.in_flight == 0
        ok = gw.submit(envs[2])
        assert ok.accepted and not ok.dedup
        assert _samples(provider, "gateway_rejections_total") == [1.0]
    finally:
        gw.stop()
        ord0.stop()


def test_adaptive_window_follows_commit_rate_as_the_reference():
    got = {}
    envs = [_env(f"aw{i}") for i in range(6)]
    for pkg in BOTH:
        p = PKG[pkg]
        gw = p.gw.Gateway(CHANNEL, [lambda: _FakeStream([])], min_window=2,
                          max_window=64, initial_window=8,
                          window_horizon_s=1.0)
        windows = []
        with p.clock.use_virtual(p.clock.VirtualClock(start=100.0)) as clk:
            for n, dt in enumerate((0.0, 0.1, 0.05)):
                clk.advance(dt)
                gw.observe_block(n, _block(envs[2 * n:2 * n + 2], [0, 0],
                                           num=n))
                windows.append((gw.window, gw._retry_after_locked()))
            gw.observe_block(0, _block(envs[:2], [0, 0]))  # a replay
            windows.append(gw.window)
        got[pkg] = windows
    assert got["port"] == got["jax"]
    assert 2 <= got["port"][1][0] <= 20


@pytest.mark.parametrize("pkg", BOTH)
def test_failover_orderer_death_mid_stream_zero_lost(pkg):
    p = PKG[pkg]
    ord_a = _MiniOrderer(pkg, die_after=3)
    ord_b = _MiniOrderer(pkg)
    gw = p.gw.Gateway(CHANNEL, [ord_a.connect_factory(),
                                ord_b.connect_factory()], max_backoff_s=0.05)
    gw.start()
    try:
        envs = [_env(f"fo{i}") for i in range(10)]
        for e in envs:
            assert gw.submit(e).accepted
        all_txids = {p.gw.txid_of(e) for e in envs}
        _wait_until(lambda: ord_b.txids() >= all_txids,
                    msg="the survivor ordered every accepted tx")
        assert gw.failovers >= 1
        log = list(gw.endpoint_log)
        assert log[0] == 0 and 1 in log
        gw.observe_block(0, _block(envs, [0] * len(envs)))
        assert gw.in_flight == 0
        assert all(gw.status(t) == p.gw.STATUS_VALID for t in all_txids)
    finally:
        gw.stop()
        ord_a.stop()
        ord_b.stop()


@pytest.mark.parametrize("pkg", BOTH)
def test_submit_after_stream_loss_still_delivers(pkg):
    p = PKG[pkg]
    ord_a = _MiniOrderer(pkg, die_after=1)
    ord_b = _MiniOrderer(pkg)
    gw = p.gw.Gateway(CHANNEL, [ord_a.connect_factory(),
                                ord_b.connect_factory()], max_backoff_s=0.05)
    gw.start()
    try:
        e0 = _env("ls0")
        gw.submit(e0)
        _wait_until(lambda: ord_a.count() >= 1, msg="the first tx ordered")
        _wait_until(lambda: gw.failovers >= 1, msg="the loss noticed")
        e1 = _env("ls1")
        gw.submit(e1)
        _wait_until(lambda: ord_b.txids() >= {p.gw.txid_of(e0),
                                              p.gw.txid_of(e1)},
                    msg="both on the survivor")
    finally:
        gw.stop()
        ord_a.stop()
        ord_b.stop()


@pytest.mark.parametrize("pkg", BOTH)
def test_wait_timeout_resolves_definitively_virtual_clock(pkg):
    p = PKG[pkg]
    sent: list = []
    gw = p.gw.Gateway(CHANNEL, [lambda: _FakeStream(sent)])
    gw.start()
    try:
        with p.clock.use_virtual(p.clock.VirtualClock(start=50.0)):
            env = _env("to0")
            txid = p.gw.txid_of(env)
            assert gw.submit(env).accepted
            t0 = time.monotonic()
            assert gw.wait(txid, timeout=30.0) == p.gw.STATUS_TIMEOUT
            assert time.monotonic() - t0 < 5.0
            assert gw.in_flight == 0
            gw.observe_block(0, _block([env], [0]))
            assert gw.status(txid) == p.gw.STATUS_TIMEOUT
            assert gw.submit(env).status == p.gw.STATUS_TIMEOUT
    finally:
        gw.stop()


@pytest.mark.parametrize("pkg", BOTH)
def test_stop_resolves_pending_to_timeout(pkg):
    p = PKG[pkg]
    sent: list = []
    gw = p.gw.Gateway(CHANNEL, [lambda: _FakeStream(sent)])
    gw.start()
    envs = [_env(f"sp{i}") for i in range(3)]
    for e in envs:
        assert gw.submit(e).accepted
    gw.stop()
    assert gw.in_flight == 0
    assert [gw.status(p.gw.txid_of(e)) for e in envs] == ["TIMEOUT"] * 3


@pytest.mark.parametrize("pkg", BOTH)
def test_observer_plan_discovers_gateway_points(pkg):
    p = PKG[pkg]
    p.fl.reset_registry()
    ord_a = _MiniOrderer(pkg, die_after=2)
    ord_b = _MiniOrderer(pkg)
    with p.fl.observe():
        gw = p.gw.Gateway(CHANNEL, [ord_a.connect_factory(),
                                    ord_b.connect_factory()],
                          max_backoff_s=0.05)
        gw.start()
        try:
            envs = [_env(f"ob{i}") for i in range(4)]
            for e in envs:
                gw.submit(e)
            _wait_until(lambda: gw.failovers >= 1, msg="failover")
            _wait_until(lambda: ord_b.txids() >= {p.gw.txid_of(e)
                                                  for e in envs},
                        msg="the survivor ordered everything")
            gw.observe_block(0, _block(envs, [0] * 4))
        finally:
            gw.stop()
            ord_a.stop()
            ord_b.stop()
        assert p.fl.trips() == []
    reg = p.fl.registry()
    for point in ("gateway.admission", "gateway.stream.write",
                  "gateway.failover", "gateway.status.resolve"):
        assert reg[point]["kinds"] == ["point"]
    p.fl.reset_registry()


@pytest.mark.parametrize("pkg", BOTH)
def test_seeded_raise_at_stream_write_takes_failover_path(pkg):
    p = PKG[pkg]
    ord_a = _MiniOrderer(pkg)
    ord_b = _MiniOrderer(pkg)
    gw = p.gw.Gateway(CHANNEL, [ord_a.connect_factory(),
                                ord_b.connect_factory()], max_backoff_s=0.05)
    gw.start()
    try:
        with p.fl.use_plan({"seed": 1, "label": "gw-arm", "faults": [
            {"point": "gateway.admission", "action": "delay",
             "delay_s": 0.0, "count": 100},
            {"point": "gateway.status.resolve", "action": "delay",
             "delay_s": 0.0, "count": 100},
            {"point": "gateway.failover", "action": "delay",
             "delay_s": 0.0, "count": 100},
            {"point": "gateway.stream.write", "action": "raise",
             "error": "OSError", "count": 1},
        ]}):
            envs = [_env(f"sr{i}") for i in range(5)]
            for e in envs:
                assert gw.submit(e).accepted
            all_txids = {p.gw.txid_of(e) for e in envs}
            _wait_until(lambda: gw.failovers >= 1, msg="the injected loss")
            _wait_until(lambda: ord_a.txids() | ord_b.txids() >= all_txids,
                        msg="every tx ordered despite the loss")
            gw.observe_block(0, _block(envs, [0] * 5))
            assert all(gw.status(t) == "VALID" for t in all_txids)
            tripped = {t["point"] for t in p.fl.trips()}
        assert tripped == {"gateway.admission", "gateway.status.resolve",
                           "gateway.failover", "gateway.stream.write"}
        assert list(gw.endpoint_log)[:2] == [0, 1]
        assert gw.in_flight == 0
    finally:
        gw.stop()
        ord_a.stop()
        ord_b.stop()


# -- the port's ab.BroadcastStream handler --------------------------------------

MAX_COUNT = 20


class OrderWorld:
    def __init__(self):
        w = self.w = chip_smoke.validator_world(73)
        pair = w.orderer_ca.issue("orderer0", ous=["orderer"])
        self.orderer = types.SimpleNamespace(
            port=chip_smoke.SigningIdentity("OrdererMSP", pair.cert,
                                            pair.key, w.rng),
            jax=JaxSigner.from_pem("OrdererMSP", pair.cert_pem,
                                   pair.key_pem, SWCSP()))
        self.genesis = chip_smoke.order_genesis(
            w, max_message_count=MAX_COUNT, preferred_max_bytes=1 << 20,
            absolute_max_bytes=1 << 20, batch_timeout="60s")
        # two blocks' worth: transactions 3 and 11 of each fail their
        # endorsement policy (two of three endorsements bad)
        self.envs, self.expect = [], []
        for b in range(2):
            for i in range(MAX_COUNT):
                bad = (0, 2) if i in (3, 11) else ()
                self.envs.append(chip_smoke.endorsed_tx(
                    w, b, i, chip_smoke.ENDORSERS, bad_endorsements=bad))
                self.expect.append(pb.ENDORSEMENT_POLICY_FAILURE if bad
                                   else pb.VALID)
        env = cb.Envelope.decode(self.envs[0])
        self.forged = cb.Envelope(payload=env.payload, signature=w.client.sign(
            b"not the payload")).encode()
        other = chip_smoke.signed_tx(w, "benchcc", [b"x"], b"",
                                     chip_smoke.VALIDATOR_TS)
        pl = cb.Payload.decode(cb.Envelope.decode(other).payload)
        chdr = cb.ChannelHeader.decode(pl.header.channel_header)
        chdr.channel_id = "nochannel"
        pl.header.channel_header = chdr.encode()
        self.wrong_channel = cb.Envelope(payload=pl.encode(),
                                         signature=b"").encode()


@pytest.fixture(scope="module")
def oworld():
    return OrderWorld()


def _port_orderer(ow, root):
    reg = PortRegistrar(str(root), HostCSP(), signer=ow.orderer.port)
    reg.startup([cb.Block.decode(ow.genesis)])
    return reg


def _jax_orderer(ow, root):
    reg = JaxRegistrar(str(root), SWCSP(), signer=ow.orderer.jax)
    reg.startup([common_pb2.Block.FromString(ow.genesis)])
    return reg


def _stream_server(handler):
    srv = PortRPCServer("127.0.0.1", 0)
    srv.register("ab.BroadcastStream", handler)
    srv.start()
    return srv


def _acks(client_cls, srv, frames) -> list:
    stream = client_cls(*srv.addr, timeout=10).duplex("ab.BroadcastStream")
    out = []
    for f in frames:
        stream.send(f)
        out.append(ob.BroadcastResponse.decode(stream.recv()).status)
    stream.finish()
    assert stream.recv() is None
    stream.close()
    return out


def test_stream_handler_acks_each_frame_with_the_filters_status(oworld,
                                                                tmp_path):
    frames = [oworld.envs[0], oworld.forged, oworld.wrong_channel,
              b"\xff\x01", oworld.envs[1]]
    reg = _port_orderer(oworld, tmp_path / "port")
    srv = _stream_server(broadcast_stream_handler(reg))
    try:
        got = _acks(PortRPCClient, srv, frames)
    finally:
        srv.stop()
        reg.halt_all()
    jreg = _jax_orderer(oworld, tmp_path / "jax")
    try:
        handler = JaxHandler(jreg)
        want = [handler.process_message(common_pb2.Envelope.FromString(f))
                for f in frames[:3]]
        want_last = handler.process_message(
            common_pb2.Envelope.FromString(frames[4]))
    finally:
        jreg.halt_all()
    assert got == want + [cb.BAD_REQUEST, want_last]
    assert got == [cb.SUCCESS, cb.FORBIDDEN, cb.NOT_FOUND, cb.BAD_REQUEST,
                   cb.SUCCESS]


def test_the_reference_stream_server_orders_without_the_filters(oworld):
    """The divergence of placement, pinned: the JAX package's only server
    of `ab.BroadcastStream` (`NetOrderer._broadcast_stream`) hands every
    envelope to the chain and acks SUCCESS, a forged one too; the port's
    handler refuses it (previous test)."""
    ordered = []
    fake = types.SimpleNamespace(
        _ab=ab_pb2, _common=common_pb2,
        chain=types.SimpleNamespace(order=ordered.append))
    frames = [oworld.envs[0], oworld.forged, b""]
    sent = []
    stream = types.SimpleNamespace(recv=lambda: frames.pop(0),
                                   send=sent.append)
    NetOrderer._broadcast_stream(fake, b"", stream)
    assert [ob.BroadcastResponse.decode(s).status for s in sent] == [
        cb.SUCCESS, cb.SUCCESS]
    assert len(ordered) == 2


def _recording(inner, received: list):
    """The handler, with each frame it reads kept in `received`."""
    def serve(body, stream):
        class Recorded:
            def recv(self):
                frame = stream.recv()
                if frame:
                    received.append(frame)
                return frame

            def send(self, raw):
                stream.send(raw)

        return inner(body, Recorded())
    return serve


@pytest.mark.parametrize("gw_pkg", BOTH)
def test_gateways_submit_through_the_port_handler_and_fail_over(
        oworld, tmp_path, gw_pkg):
    """Two RPC endpoints over one port registrar; a seeded raise tears the
    gateway's stream at its 5th write: it fails over to endpoint 1 and
    resubmits its unresolved window there, so endpoint 1 reads all 20
    envelopes once, after the few the torn stream carried, and acks
    each SUCCESS."""
    p = PKG[gw_pkg]
    reg = _port_orderer(oworld, tmp_path / "orderer")
    received = ([], [])
    srvs = [_stream_server(_recording(broadcast_stream_handler(reg),
                                      received[k])) for k in range(2)]
    envs = oworld.envs[:MAX_COUNT]
    acked = []
    gw = p.gw.Gateway(CH, [p.gw.orderer_stream_connect(s.addr)
                           for s in srvs], max_backoff_s=0.05)
    reader = gw._ack_reader

    def ack_reader(stream, gen):
        recv = stream.recv

        def counted():
            body = recv()
            if body is not None:
                acked.append((gen, ob.BroadcastResponse.decode(body).status))
            return body

        stream.recv = counted
        return reader(stream, gen)

    gw._ack_reader = ack_reader
    try:
        gw.start()
        with p.fl.use_plan({"faults": [{
                "point": "gateway.stream.write", "action": "raise",
                "error": "OSError", "nth": 5}]}):
            for e in envs:
                assert gw.submit(e).accepted
            _wait_until(lambda: sum(g == 2 for g, _ in acked) == MAX_COUNT,
                        msg="endpoint 1 acked the window")
        assert gw.failovers == 1 and list(gw.endpoint_log) == [0, 1]
        assert received[1] == envs
        assert 1 <= len(received[0]) <= 4
        assert received[0] == envs[:len(received[0])]
        assert {s for _, s in acked} == {cb.SUCCESS}
    finally:
        gw.stop()
        for s in srvs:
            s.stop()
        reg.halt_all()


# -- the slice ------------------------------------------------------------------------


def _tail(ledger, stop):
    """A deliver endpoint over a peer's ledger: its committed blocks from
    `start`, as they land."""
    def connect(start):
        n = start
        while not stop.is_set():
            if n < ledger.height:
                yield ledger.get_block_by_number(n)
                n += 1
            else:
                time.sleep(0.005)
    return connect


def _jax_stream_handler(reg):
    """The stream's server half on the JAX package: the port handler's
    loop around the JAX `BroadcastHandler`."""
    handler = JaxHandler(reg)

    def serve(body, stream):
        while True:
            frame = stream.recv()
            if not frame:
                return None
            status = handler.process_message(
                common_pb2.Envelope.FromString(frame))
            stream.send(ab_pb2.BroadcastResponse(
                status=status).SerializeToString())

    return serve


def _port_peer_csp(k):
    """`CUDACSP(device="cpu")` on its host route (B1's plain version,
    seconds a block here, is held against the JAX validator in
    tests/test_torch_committer.py)."""
    return CUDACSP(device="cpu", min_device_batch=1 << 30)


SLICE = {
    "jax": types.SimpleNamespace(
        Registrar=JaxRegistrar, csp=SWCSP, peer_csp=lambda k: SWCSP(),
        block=common_pb2.Block.FromString, bundle=lambda g: jax_bundle(
            common_pb2.Block.FromString(g), SWCSP()),
        deliver=jax_deliver, Provider=JaxProvider, Validator=JaxValidator,
        pd=jax_pd, kv=jax_kv, Transient=JaxTransient,
        Coordinator=jax_privdata.PrivDataCoordinator, comm=jax_gcomm,
        Service=JaxService, Client=JaxClient, stream=_jax_stream_handler,
        RPCServer=JaxRPCServer, gw=jax_gw, signer="jax"),
    "port": types.SimpleNamespace(
        Registrar=PortRegistrar, csp=HostCSP,
        peer_csp=_port_peer_csp, block=cb.Block.decode,
        bundle=lambda g: port_bundle(cb.Block.decode(g)),
        deliver=port_deliver, Provider=PortProvider, Validator=PortValidator,
        pd=port_pd, kv=port_kv, Transient=TransientStore,
        Coordinator=port_privdata.PrivDataCoordinator, comm=port_gcomm,
        Service=PortService, Client=PortClient,
        stream=broadcast_stream_handler, RPCServer=PortRPCServer,
        gw=port_gw, signer="port"),
}


def _slice(pkg, ow, root):
    s = SLICE[pkg]
    stop = threading.Event()
    reg = s.Registrar(str(root / "orderer"), s.csp(),
                      signer=getattr(ow.orderer, s.signer))
    reg.startup([s.block(ow.genesis)])
    svc = s.deliver.DeliverService(reg.get_chain, s.csp())
    reg.add_block_listener(lambda ch, blk: svc.notifier.notify())
    srv = s.RPCServer("127.0.0.1", 0)
    srv.register("ab.BroadcastStream", s.stream(reg))
    srv.start()
    client = ow.w.client
    if pkg == "jax":
        client = JaxSigner.from_pem(client.mspid, client.cert.pem(),
                                    key_pem(client._key), SWCSP())
    bundle = s.bundle(ow.genesis)
    net = s.comm.InProcGossipNet()
    peers = []

    def orderer_endpoint(start):
        env = s.deliver.make_seek_info_envelope(CH, start, 1 << 62,
                                                signer=client)
        for kind, value in svc.deliver(env):
            if stop.is_set():
                return
            if kind == "block":
                yield value

    def start_peer(k, deliver=True):
        provider = s.Provider(str(root / f"peer{k}"))
        ledger = provider.create(s.block(ow.genesis))
        me = ow.w.peers[k].serialize()
        coord = s.Coordinator(
            s.Validator(CH, ledger, bundle, s.peer_csp(k)), ledger,
            s.Transient(s.kv.MemKVStore(), CH),
            s.pd.CollectionStore(bundle.msp_manager), me)
        comm = s.comm.InProcGossipComm(f"p{k}", net, me)
        gsvc = s.Service(comm, bootstrap=["p0"])
        holder = {}
        dc = s.Client(CH, [orderer_endpoint], lambda: coord.height,
                      lambda seq, raw: holder["h"].state.add_payload(
                          seq, raw, from_orderer=True))
        h = holder["h"] = gsvc.join_channel(
            CH, coord, deliver_client=dc if deliver else None)
        h.gossip.store._ttl = 3
        peers.append(types.SimpleNamespace(provider=provider, ledger=ledger,
                                           svc=gsvc, h=h, dc=dc))

    def tick(n=1):
        for _ in range(n):
            for p in peers:
                p.svc.tick()

    for k in range(2):
        start_peer(k)
    tick(3)  # membership, then one leader
    gw = s.gw.Gateway(CH, [s.gw.orderer_stream_connect(srv.addr)],
                      deliver_endpoints=[_tail(peers[0].ledger, stop)],
                      start_height=1)
    gw.start()
    try:
        txids = [s.gw.txid_of(e) for e in ow.envs]
        results = [gw.submit(e) for e in ow.envs[:5]]
        results.append(gw.submit(ow.envs[2]))  # in flight: a dedup hit
        results += [gw.submit(e) for e in ow.envs[5:]]
        deadline = time.monotonic() + 120
        while any(gw.status(t) == "PENDING" for t in txids) \
                and time.monotonic() < deadline:
            tick()
            time.sleep(0.01)
        while min(p.ledger.durable_height for p in peers) < 3 \
                and time.monotonic() < deadline:
            tick()
            time.sleep(0.01)
        # the blocks leave the gossip stores (TTL 3); cut apart, the two
        # peers cannot pull them back from each other
        net.partition("p0", "p1")
        tick(4)
        net.heal()
        leaders = [p.h.election.is_leader for p in peers]
        start_peer(2, deliver=False)  # late, by state transfer alone
        deadline = time.monotonic() + 60
        while peers[2].ledger.durable_height < 3 \
                and time.monotonic() < deadline:
            tick()
            time.sleep(0.01)
        assert [p.ledger.durable_height for p in peers] == [3, 3, 3]
        out = types.SimpleNamespace(
            results=[(r.accepted, r.dedup) for r in results],
            statuses=[gw.status(t) for t in txids],
            flags=[[list(pu.tx_filter(cb.Block.decode(_enc(
                p.ledger.get_block_by_number(n))))) for n in (1, 2)]
                for p in peers],
            states=[list(p.ledger.get_state_range(chip_smoke.VALIDATOR_CC,
                                                  "", "")) for p in peers],
            heights=[p.ledger.durable_height for p in peers],
            leaders=leaders,
            late_stored=peers[2].h.gossip.store.digests(),
            late_by_state=getattr(peers[2].h.state, "blocks_received", 2))
    finally:
        stop.set()
        gw.stop()
        srv.stop()
        svc.stop()
        for p in peers:
            p.dc.stop()
        reg.halt_all()
        for p in peers:
            p.provider.close()
    return out


def _enc(m) -> bytes:
    return m.SerializeToString() if hasattr(m, "SerializeToString") \
        else m.encode()


def test_the_gateway_gossip_slice_as_the_reference(oworld, tmp_path):
    got = {pkg: _slice(pkg, oworld, tmp_path / pkg) for pkg in BOTH}
    port, jax = got["port"], got["jax"]
    want = ["VALID" if f == pb.VALID else "INVALID" for f in oworld.expect]
    assert port.statuses == jax.statuses == want
    assert port.results == jax.results
    assert port.results[5] == (True, True)
    flat = oworld.expect[:MAX_COUNT], oworld.expect[MAX_COUNT:]
    assert port.flags == jax.flags == [list(flat)] * 3
    assert port.states == jax.states
    assert port.states[0] == port.states[1] == port.states[2]
    assert len(port.states[0]) == oworld.expect.count(pb.VALID)
    assert port.heights == jax.heights == [3, 3, 3]
    assert sum(port.leaders) == 1 and port.leaders == jax.leaders
    # the late peer took nothing from gossip's stores
    assert port.late_stored == jax.late_stored == []
    assert port.late_by_state == 2


def test_the_port_gateway_streams_over_mutual_tls(oworld, tmp_path):
    """The gateway's sender and ack reader share one TLS connection:
    every envelope is acked SUCCESS, then `stop` ends the stream."""
    from fabric_tpu_torch.comm.tls import credentials_from_ca

    ca = chip_smoke.CA("tlsca.gateway.example.com", "gateway.example.com",
                       rng=np.random.default_rng(79))
    reg = _port_orderer(oworld, tmp_path / "orderer")
    received: list = []
    srv = PortRPCServer("127.0.0.1", 0, tls=credentials_from_ca(ca, "orderer"))
    srv.register("ab.BroadcastStream",
                 _recording(broadcast_stream_handler(reg), received))
    srv.start()
    gw = port_gw.Gateway(CH, [port_gw.orderer_stream_connect(
        srv.addr, tls=credentials_from_ca(ca, "client"))])
    try:
        gw.start()
        for e in oworld.envs[:MAX_COUNT]:
            assert gw.submit(e).accepted
        _wait_until(lambda: len(received) == MAX_COUNT and gw._unacked == 0,
                    msg="every envelope acked")
        assert received == oworld.envs[:MAX_COUNT]
        assert gw.failovers == 0 and list(gw.endpoint_log) == [0]
    finally:
        gw.stop()
        srv.stop()
        reg.halt_all()
