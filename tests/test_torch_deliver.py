"""The port's deliver leg against the JAX package's, and the slice as a
whole.

- `DeliverService`: one chain (blocks cut and signed by the port's solo
  orderer from chip_smoke's 5-org channel) in a block store of each
  package; the same seek envelopes (oldest, newest, specified, past the
  height, reversed, fail-if-not-ready and block-until-ready, an unknown
  channel, an unsigned and an outside reader, a malformed SeekInfo) and a
  config change mid-stream that drops the reader's org give the same
  events; `deliver_response_frames` / `deliver_filtered_frames` the same
  frames, byte for byte; `filter_block` the same FilteredBlock on crafted
  transactions (events with and without payloads, other header types,
  undecodable envelopes, transactions and actions).
- `DeliverClient`: from two endpoints whose first stream carries a block
  with a flipped signature, and under a faultline raise at
  `deliver.connect`, both packages' clients rotate alike (seeded
  shuffle), refuse the bad blocks and deliver the good ones; the port's
  client counts its blocks in `DeliverMetrics` and a `deliver.block` span.
- The slice: 3 blocks of 8 transactions with the validator's planted
  faults go through each package's orderer -> DeliverService ->
  DeliverClient -> TxValidator -> Committer; the statuses, the flags, the
  TRANSACTIONS_FILTER of each block and every KV pair (of the block
  index, whose values hold file offsets, the keys) are equal, exactly,
  and each admitted transaction's flag is the one planted.
"""

import contextlib
import random
import threading
import time
import types

import pytest

import chip_smoke
from fabric_tpu.common import deliver as jax_deliver
from fabric_tpu.common.channelconfig import Bundle as JaxBundle
from fabric_tpu.common.channelconfig import bundle_from_genesis as jax_bundle
from fabric_tpu.csp import SWCSP
from fabric_tpu.devtools import faultline as jax_fl
from fabric_tpu.ledger.blkstorage import BlockStore as JaxStore
from fabric_tpu.ledger.kvledger import LedgerProvider as JaxProvider
from fabric_tpu.msp import SigningIdentity as JaxSigner
from fabric_tpu.orderer.broadcast import BroadcastHandler as JaxHandler
from fabric_tpu.orderer.multichannel import Registrar as JaxRegistrar
from fabric_tpu.peer.committer import Committer as JaxCommitter
from fabric_tpu.peer.deliverclient import DeliverClient as JaxClient
from fabric_tpu.peer.txvalidator import TxValidator as JaxValidator
from fabric_tpu.protos.common import common_pb2, configtx_pb2
from fabric_tpu_torch import protoutil as pu
from fabric_tpu_torch.common import deliver as port_deliver
from fabric_tpu_torch.common import tracing, workpool
from fabric_tpu_torch.common.channelconfig import Bundle as PortBundle
from fabric_tpu_torch.common.channelconfig import (
    bundle_from_genesis as port_bundle,
)
from fabric_tpu_torch.common.crypto import CA
from fabric_tpu_torch.common.metrics import DeliverMetrics, PrometheusProvider
from fabric_tpu_torch.csp.cuda.provider import CUDACSP
from fabric_tpu_torch.csp.hostref import HostCSP
from fabric_tpu_torch.devtools import faultline as port_fl
from fabric_tpu_torch.devtools import lockwatch as port_lw
from fabric_tpu_torch.ledger.blkstorage import BlockStore as PortStore
from fabric_tpu_torch.ledger.kvledger import LedgerProvider
from fabric_tpu_torch.msp.identity import SigningIdentity as PortSigner
from fabric_tpu_torch.orderer.broadcast import BroadcastHandler as PortHandler
from fabric_tpu_torch.orderer.multichannel import Registrar as PortRegistrar
from fabric_tpu_torch.peer.committer import Committer
from fabric_tpu_torch.peer.deliverclient import DeliverClient as PortClient
from fabric_tpu_torch.peer.txvalidator import TxValidator
from fabric_tpu_torch.protos import common as cb
from fabric_tpu_torch.protos import orderer as ob
from fabric_tpu_torch.protos import peer as pb

CH = chip_smoke.VALIDATOR_CHANNEL
BLOCK_TXS = 4  # the deliver chain's MaxMessageCount
FAIL = ob.SeekInfo.FAIL_IF_NOT_READY
WAIT = ob.SeekInfo.BLOCK_UNTIL_READY


@pytest.fixture(scope="module", autouse=True)
def _port_watch_gate():
    """The port's lockwatch ledgers are empty and its workers drained at
    the end of this file."""
    yield
    workpool.shutdown()
    assert not port_lw.drain_threads(timeout=15.0)
    assert not port_lw.violations and not port_lw.thread_violations


def _pair(w, name, ou):
    pair = w.orderer_ca.issue(name, ous=[ou])
    return types.SimpleNamespace(
        port=PortSigner("OrdererMSP", pair.cert, pair.key, w.rng),
        jax=JaxSigner.from_pem("OrdererMSP", pair.cert_pem, pair.key_pem,
                               SWCSP()))


def _wait_height(reg, height: int, timeout: float = 30.0) -> int:
    cs = reg.get_chain(CH)
    deadline = time.monotonic() + timeout
    while cs.store.height < height and time.monotonic() < deadline:
        time.sleep(0.01)
    return cs.store.height


class World:
    """A chain of 7 blocks (the genesis block and 6 of BLOCK_TXS
    transactions) cut and signed by the port's solo orderer."""

    def __init__(self, tmp):
        self.w = chip_smoke.validator_world(41)
        self.orderer = _pair(self.w, "orderer0", "orderer")
        blocks, self.expect, _ = chip_smoke.validator_blocks(
            self.w, 4, 8, self.w.genesis_hash)
        every = [e for raw in blocks for e in cb.Block.decode(raw).data.data]
        self.envs = every[:24]  # 3 blocks of 8, the faults in the third
        self.genesis = chip_smoke.order_genesis(
            self.w, max_message_count=BLOCK_TXS, preferred_max_bytes=1 << 20,
            absolute_max_bytes=1 << 20, batch_timeout="60s")
        valid = [e for k, e in enumerate(every)
                 if (k // 8, k % 8) not in self.expect][:6 * BLOCK_TXS]
        reg = PortRegistrar(tmp, HostCSP(), signer=self.orderer.port)
        reg.startup([cb.Block.decode(self.genesis)])
        try:
            h = PortHandler(reg)
            for raw in valid:
                assert h.process_message(cb.Envelope.decode(raw)) == \
                    cb.SUCCESS
            assert _wait_height(reg, 7) == 7
            store = reg.get_chain(CH).store
            self.chain = [store.get_block_by_number(n).encode()
                          for n in range(7)]
        finally:
            reg.halt_all()
        ca = CA("ca.org9", "Org9MSP", rng=self.w.rng)
        pair = ca.issue("outsider", ous=["client"])
        self.outsider = PortSigner("Org9MSP", pair.cert, pair.key, self.w.rng)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return World(str(tmp_path_factory.mktemp("chain")))


class _Support:
    def __init__(self, store, bundle):
        self.store = store
        self.bundle = bundle


def _support(pkg, world, n_blocks: int = 6):
    """A support holding blocks 0..n_blocks-1 of the chain."""
    if pkg == "jax":
        store = JaxStore(None)
        for raw in world.chain[:n_blocks]:
            store.add_block(common_pb2.Block.FromString(raw))
        return _Support(store, jax_bundle(
            common_pb2.Block.FromString(world.genesis), SWCSP()))
    store = PortStore(None)
    for raw in world.chain[:n_blocks]:
        store.add_block(cb.Block.decode(raw))
    return _Support(store, port_bundle(world.genesis))


def _service(pkg, support):
    if pkg == "jax":
        return jax_deliver.DeliverService(
            lambda ch: support if ch == CH else None, SWCSP())
    return port_deliver.DeliverService(
        lambda ch: support if ch == CH else None, HostCSP())


def _seek(start, stop, behavior=FAIL, signer="client", channel=CH,
          world=None) -> bytes:
    who = {"client": world.w.client, "outsider": world.outsider,
           None: None}[signer]
    return port_deliver.make_seek_info_envelope(
        channel, start, stop, signer=who, behavior=behavior).encode()


def _events(pkg, service, env_bytes) -> list[tuple]:
    env = (common_pb2.Envelope.FromString(env_bytes) if pkg == "jax"
           else cb.Envelope.decode(env_bytes))
    out = []
    for kind, value in service.deliver(env):
        if kind == "block":
            value = (value.SerializeToString() if pkg == "jax"
                     else value.encode())
        out.append((kind, value))
    return out


SEEKS = {
    "oldest_to_newest": dict(start="oldest", stop="newest"),
    "specified": dict(start=2, stop=4),
    "newest": dict(start="newest", stop="newest"),
    "past_the_height": dict(start=3, stop=9),
    "reversed": dict(start=4, stop=2),
    "beyond": dict(start=7, stop=7),
    "wait_but_ready": dict(start="oldest", stop=1, behavior=WAIT),
    "unknown_channel": dict(start=0, stop=0, channel="ghost"),
    "unsigned": dict(start=0, stop=0, signer=None),
    "outsider": dict(start=0, stop=0, signer="outsider"),
}


@pytest.mark.parametrize("case", sorted(SEEKS))
def test_deliver_events_as_the_reference(world, case):
    raw = _seek(world=world, **SEEKS[case])
    got = {pkg: _events(pkg, _service(pkg, _support(pkg, world)), raw)
           for pkg in ("jax", "port")}
    assert got["port"] == got["jax"]
    want_status = {"past_the_height": cb.NOT_FOUND, "reversed":
                   cb.BAD_REQUEST, "beyond": cb.NOT_FOUND,
                   "unknown_channel": cb.NOT_FOUND, "unsigned": cb.FORBIDDEN,
                   "outsider": cb.FORBIDDEN}.get(case, cb.SUCCESS)
    assert got["port"][-1] == ("status", want_status)
    blocks = [v for k, v in got["port"] if k == "block"]
    assert blocks == [world.chain[n] for n in {
        "oldest_to_newest": range(6), "specified": range(2, 5),
        "newest": [5], "past_the_height": range(3, 6),
        "wait_but_ready": range(2)}.get(case, [])]


def _malformed_seeks(world) -> list[bytes]:
    """A SeekInfo that does not decode, and one without a start."""
    client = world.w.client
    out = []
    for data in (b"\xff\xff", ob.SeekInfo(stop=ob.SeekPosition(
            newest=ob.SeekNewest())).encode()):
        raw = pu.make_payload_bytes(
            pu.make_channel_header(cb.DELIVER_SEEK_INFO, CH, timestamp=3),
            pu.make_signature_header(client.serialize(), b"s" * 24), data)
        out.append(pu.make_envelope(raw, client).encode())
    return out


def test_malformed_seek_info_and_frames_as_the_reference(world):
    for raw in _malformed_seeks(world):
        got = {pkg: _events(pkg, _service(pkg, _support(pkg, world)), raw)
               for pkg in ("jax", "port")}
        assert got["port"] == got["jax"] == [("status", cb.BAD_REQUEST)]
    for case in ("oldest_to_newest", "outsider", "reversed"):
        raw = _seek(world=world, **SEEKS[case])
        for name in ("deliver_response_frames", "deliver_filtered_frames"):
            frames = {
                pkg: list(getattr(mod, name)(
                    _service(pkg, _support(pkg, world)), raw))
                for pkg, mod in (("jax", jax_deliver),
                                 ("port", port_deliver))}
            assert frames["port"] == frames["jax"] and frames["port"]
    # the builders write the same SeekInfo
    for start, stop in (("oldest", "newest"), (0, 5), ("newest", 3)):
        jenv = jax_deliver.make_seek_info_envelope(CH, start, stop,
                                                   behavior=FAIL)
        penv = port_deliver.make_seek_info_envelope(CH, start, stop,
                                                    behavior=FAIL)
        jdata = common_pb2.Payload.FromString(jenv.payload).data
        assert cb.Payload.decode(penv.payload).data == jdata


def test_block_until_ready_and_a_config_change_mid_stream(world):
    """A stream waits for block 6, which arrives from another thread;
    another stream is refused once the channel's config drops the
    reader's org (the sequence moves)."""
    got = {}
    for pkg in ("jax", "port"):
        support = _support(pkg, world)
        svc = _service(pkg, support)
        raw = _seek(5, 6, behavior=WAIT, world=world)

        def grow(support=support, svc=svc, pkg=pkg):
            time.sleep(0.3)
            blk = (common_pb2.Block.FromString(world.chain[6])
                   if pkg == "jax" else cb.Block.decode(world.chain[6]))
            support.store.add_block(blk)
            svc.notifier.notify()

        t = threading.Thread(target=grow)
        t.start()
        waited = _events(pkg, svc, raw)
        t.join()
        support = _support(pkg, world)
        svc = _service(pkg, support)
        env = _seek(0, 5, world=world)
        env = (common_pb2.Envelope.FromString(env) if pkg == "jax"
               else cb.Envelope.decode(env))
        stream = svc.deliver(env)
        first = next(stream)
        support.bundle = _without_org1(pkg, world)
        rest = [(k, v if k == "status" else v.header.number)
                for k, v in stream]
        got[pkg] = (waited, first[0], rest)
    assert got["port"] == got["jax"]
    waited, first, rest = got["port"]
    assert waited == [("block", world.chain[5]), ("block", world.chain[6]),
                      ("status", cb.SUCCESS)]
    assert first == "block" and rest == [("status", cb.FORBIDDEN)]


def _without_org1(pkg, world):
    cfg = configtx_pb2.Config()
    cfg.CopyFrom(jax_bundle(common_pb2.Block.FromString(world.genesis),
                            SWCSP()).config)
    cfg.sequence = 1
    del cfg.channel_group.groups["Application"].groups["Org1"]
    raw = cfg.SerializeToString()
    if pkg == "jax":
        return JaxBundle(CH, configtx_pb2.Config.FromString(raw), SWCSP())
    return PortBundle(CH, cb.Config.decode(raw), HostCSP())


# -- filter_block ------------------------------------------------------------------


def _event_tx(world, events: bytes, n_actions: int = 1) -> bytes:
    """An endorsed transaction whose action carries `events`."""
    client, peer = world.w.client, world.w.peers[0]
    prop, _ = pu.create_chaincode_proposal(client.serialize(), CH, "cc",
                                           [b"a"], nonce=b"e" * 24,
                                           timestamp=5)
    resp = pu.create_proposal_response(prop, b"", events,
                                       pb.Response(status=200),
                                       pb.ChaincodeID(name="cc"), peer)
    env = cb.Envelope.decode(pu.create_signed_tx(prop, client, [resp])
                             .encode())
    payload = cb.Payload.decode(env.payload)
    tx = pb.Transaction.decode(payload.data)
    tx.actions = list(tx.actions) * n_actions
    payload.data = tx.encode()
    return cb.Envelope(payload=payload.encode(),
                       signature=env.signature).encode()


def _crafted_block(world) -> bytes:
    event = pb.ChaincodeEvent(chaincode_id="cc", tx_id="t1",
                              event_name="moved", payload=b"secret")
    bare = pb.ChaincodeEvent(payload=b"only a payload")
    chdr = pu.make_channel_header(cb.ENDORSER_TRANSACTION, CH, tx_id="bad",
                                  timestamp=5)
    shdr = pu.make_signature_header(b"c", b"n")
    bad_tx = cb.Envelope(payload=pu.make_payload_bytes(
        chdr, shdr, b"\xff\xff")).encode()
    odd = cb.Envelope.decode(_event_tx(world, event.encode()))
    p = cb.Payload.decode(odd.payload)
    tx = pb.Transaction.decode(p.data)
    tx.actions = [pb.TransactionAction(header=b"h", payload=b"\xff\x01"),
                  tx.actions[0]]
    p.data = tx.encode()
    bad_action = cb.Envelope(payload=p.encode()).encode()
    no_actions = cb.Payload.decode(odd.payload)
    no_actions.data = pb.Transaction().encode()
    config = cb.Envelope(payload=pu.make_payload_bytes(
        pu.make_channel_header(cb.CONFIG, CH, timestamp=5), shdr,
        b"cfg")).encode()
    envs = [_event_tx(world, event.encode(), 2), _event_tx(world, b""),
            _event_tx(world, bare.encode()), bad_tx, bad_action,
            cb.Envelope(payload=no_actions.encode()).encode(), config,
            b"\xff\xfe not an envelope", world.envs[0]]
    blk = pu.new_block(9, b"p" * 32)
    blk.data = cb.BlockData(data=envs)
    blk.header.data_hash = pu.block_data_hash(blk.data)
    pu.set_tx_filter(blk, bytes([0, 11, 0, 2, 0, 0, 0, 1, 10]))
    return blk.encode()


@pytest.mark.parametrize("which", ["crafted", "chain"])
def test_filter_block_as_the_reference(world, which):
    raws = [_crafted_block(world)] if which == "crafted" else world.chain
    for raw in raws:
        want = jax_deliver.filter_block(common_pb2.Block.FromString(raw))
        got = port_deliver.filter_block(cb.Block.decode(raw))
        assert got.encode() == want.SerializeToString()
    if which == "crafted":
        txs = got.filtered_transactions
        assert len(txs) == 9 and txs[0].transaction_actions \
            .chaincode_actions[1].chaincode_event.event_name == "moved"
        assert txs[0].transaction_actions.chaincode_actions[0] \
            .chaincode_event.payload == b""
        assert txs[2].transaction_actions.chaincode_actions[0] \
            .has("chaincode_event")
        assert not txs[5].has("transaction_actions")


# -- the deliver client ------------------------------------------------------------


def _flip_signature(pkg, blk):
    raw = (blk.SerializeToString() if pkg == "jax" else blk.encode())
    bad = cb.Block.decode(raw)
    meta = cb.Metadata.decode(bad.metadata.metadata[cb.SIGNATURES])
    sig = bytearray(meta.signatures[0].signature)
    sig[8] ^= 0x40
    meta.signatures[0].signature = bytes(sig)
    bad.metadata.metadata[cb.SIGNATURES] = meta.encode()
    return (common_pb2.Block.FromString(bad.encode()) if pkg == "jax"
            else bad)


def _endpoints(pkg, world, support, tamper_first: bool):
    """Two in-process endpoints over one DeliverService; with
    `tamper_first`, each one's first stream starts with a block whose
    signature is flipped."""
    svc = _service(pkg, support)
    mod = jax_deliver if pkg == "jax" else port_deliver
    opened = [0, 0]

    def endpoint(k):
        def connect(start):
            opened[k] += 1
            env = mod.make_seek_info_envelope(CH, start, "newest",
                                              signer=world.w.client,
                                              behavior=FAIL)
            for kind, blk in svc.deliver(env):
                if kind != "block":
                    return
                if tamper_first and opened[k] == 1:
                    blk = _flip_signature(pkg, blk)
                yield blk
        return connect

    return [endpoint(0), endpoint(1)]


def _run_client(pkg, world, tamper_first=False, plan=None, metrics=None):
    support = _support(pkg, world, n_blocks=7)
    got, heights = [], [1]
    bundle = support.bundle
    Client = JaxClient if pkg == "jax" else PortClient
    csp = SWCSP() if pkg == "jax" else HostCSP()

    def sink(seq, raw):
        got.append((seq, raw))
        heights[0] = seq + 1

    client = Client(CH, _endpoints(pkg, world, support, tamper_first),
                    lambda: heights[0], sink, bundle=bundle, csp=csp,
                    max_backoff_s=0.4, metrics=metrics)
    fl = jax_fl if pkg == "jax" else port_fl
    state = random.getstate()  # the rotation's shuffle, seeded alike
    random.seed(3)
    try:
        with fl.use_plan(plan) if plan else contextlib.nullcontext():
            client.start()
            deadline = time.monotonic() + 20
            while len(got) < 6 and time.monotonic() < deadline:
                time.sleep(0.02)
            client.stop()
    finally:
        random.setstate(state)
    return (got, list(client.endpoint_log)[:3], list(client.backoff_log)[:2],
            client.delivered)


@pytest.mark.parametrize("fault", ["tampered", "connect_raise"])
def test_deliver_client_rotates_as_the_reference(world, fault):
    plan = ({"faults": [{"point": "deliver.connect", "action": "raise",
                         "nth": 1}]} if fault == "connect_raise" else None)
    got = {pkg: _run_client(pkg, world, tamper_first=fault == "tampered",
                            plan=plan) for pkg in ("jax", "port")}
    assert got["port"] == got["jax"]
    blocks, log, backoffs, delivered = got["port"]
    assert blocks == [(n, world.chain[n]) for n in range(1, 7)]
    assert delivered == 6 and backoffs[:1] == [0.1]
    if fault == "tampered":  # both first streams refused, then the first
        assert log[0] != log[1] and log[2] == log[0]
        assert backoffs == [0.1, 0.2]
    else:
        assert log[0] != log[1]


def test_port_deliver_client_counts_and_traces_its_blocks(world):
    provider = PrometheusProvider()
    with tracing.scope() as rec:
        got = _run_client("port", world, metrics=DeliverMetrics(provider))
        spans = [e for e in rec.snapshot()
                 if e.get("name") == "deliver.block"]
    assert got[3] == 6 and len(spans) == 6
    text = provider.registry.expose()
    assert f'deliver_blocks_total{{channel="{CH}"}} 6' in text


# -- the slice: orderer -> deliver -> deliver client -> validator -> committer --


def _slice(pkg, world, tmp, envs):
    """Order `envs`, deliver the blocks through a DeliverClient and commit
    them; returns (statuses, flags, TRANSACTIONS_FILTERs, KV pairs)."""
    jax = pkg == "jax"
    genesis_raw = chip_smoke.order_genesis(
        world.w, max_message_count=11, preferred_max_bytes=1 << 20,
        absolute_max_bytes=1 << 20, batch_timeout="60s")
    genesis = (common_pb2.Block.FromString(genesis_raw) if jax
               else cb.Block.decode(genesis_raw))
    Registrar, Handler = ((JaxRegistrar, JaxHandler) if jax
                          else (PortRegistrar, PortHandler))
    csp = SWCSP() if jax else CUDACSP(device="cpu")
    reg = Registrar(f"{tmp}/orderer", SWCSP() if jax else HostCSP(),
                    signer=getattr(world.orderer, pkg))
    reg.startup([genesis])
    provider = (JaxProvider if jax else LedgerProvider)(f"{tmp}/peer")
    try:
        h = Handler(reg)
        decode = common_pb2.Envelope.FromString if jax else cb.Envelope.decode
        statuses = [h.process_message(decode(raw)) for raw in envs]
        assert _wait_height(reg, 3) == 3
        mod = jax_deliver if jax else port_deliver
        svc = mod.DeliverService(reg.get_chain, SWCSP() if jax else HostCSP())
        ledger = provider.create(genesis)
        bundle = (jax_bundle(genesis, SWCSP()) if jax
                  else port_bundle(genesis_raw))
        delivered = []

        def connect(start):
            env = mod.make_seek_info_envelope(CH, start, "newest",
                                              signer=world.w.client,
                                              behavior=FAIL)
            for kind, blk in svc.deliver(env):
                if kind == "block":
                    yield blk

        Client = JaxClient if jax else PortClient
        client = Client(CH, [connect], lambda: ledger.height + len(delivered),
                        lambda seq, raw: delivered.append(raw),
                        bundle=bundle, csp=SWCSP() if jax else HostCSP())
        client.start()
        deadline = time.monotonic() + 20
        while len(delivered) < 2 and time.monotonic() < deadline:
            time.sleep(0.02)
        client.stop()
        assert len(delivered) == 2
        committer = (JaxCommitter if jax else Committer)(
            (JaxValidator if jax else TxValidator)(CH, ledger, bundle, csp),
            ledger)
        blocks = ([common_pb2.Block.FromString(b) for b in delivered] if jax
                  else delivered)
        flags = [list(f) for f in committer.store_stream(blocks, depth=3)]
        filters = [bytes(ledger.get_block_by_number(n).metadata.metadata[
            cb.TRANSACTIONS_FILTER]) for n in (1, 2)]
        # the block index's values hold file offsets, which follow the
        # length of each block's orderer signature (DER, 70-72 bytes): its
        # keys are compared, every other pair whole
        pairs = [(k, None if k.startswith(b"blkindex/") else v)
                 for k, v in provider.kv.iterate()]
    finally:
        reg.halt_all()
        provider.close()
    return statuses, flags, filters, pairs


def test_the_slice_end_to_end_as_the_reference(world, tmp_path):
    envs = world.envs  # 3 blocks of 8 with the planted faults in block 3
    got = {pkg: _slice(pkg, world, str(tmp_path / pkg), envs)
           for pkg in ("jax", "port")}
    assert got["port"] == got["jax"]
    statuses, flags, filters, _ = got["port"]
    admitted = [k for k, s in enumerate(statuses) if s == cb.SUCCESS]
    assert [(k, s) for k, s in enumerate(statuses) if s != cb.SUCCESS] == \
        [(17, cb.FORBIDDEN), (22, cb.BAD_REQUEST)]
    want = [world.expect.get((k // 8, k % 8), pb.VALID) for k in admitted]
    assert [f for block in flags for f in block] == want
    assert filters == [bytes(f) for f in flags]


class _RacingStore:
    """A store where the writer lands block `n` (and notifies) just after
    the reader's height check has found it missing, before the reader
    waits: the moment a concurrent orderer can hit."""

    def __init__(self, store, blk, notify):
        self._store = store
        self._blk = blk
        self._notify = notify
        self._armed = False

    @property
    def height(self):
        h = self._store.height
        if self._armed and self._blk is not None:
            self._store.add_block(self._blk)
            self._blk = None
            self._notify()
        return h

    def get_block_by_number(self, num):
        self._armed = True  # the next height check races the writer
        return self._store.get_block_by_number(num)


def test_a_block_written_between_the_check_and_the_wait_waits_out_the_poll(
        world):
    """The reference's deliver loop checks the height and then waits on
    the notifier, not under one lock: a block written and notified in
    between is delivered only when the 0.25 s wait times out.  The port
    does the same (ROADMAP Queue C)."""
    gaps = {}
    for pkg in ("jax", "port"):
        support = _support(pkg, world)
        svc = _service(pkg, support)
        blk = (common_pb2.Block.FromString(world.chain[6]) if pkg == "jax"
               else cb.Block.decode(world.chain[6]))
        support.store = _RacingStore(support.store, blk, svc.notifier.notify)
        env = _seek(5, 6, behavior=WAIT, world=world)
        env = (common_pb2.Envelope.FromString(env) if pkg == "jax"
               else cb.Envelope.decode(env))
        times = []
        for kind, _ in svc.deliver(env):
            times.append((kind, time.monotonic()))
        assert [k for k, _ in times] == ["block", "block", "status"]
        gaps[pkg] = times[1][1] - times[0][1]
    assert gaps["jax"] >= 0.2 and gaps["port"] >= 0.2, gaps


@pytest.mark.parametrize("on_disk", [False, True], ids=["memory", "files"])
def test_a_reader_never_sees_a_height_whose_block_it_cannot_read(
        world, tmp_path, on_disk):
    """The reference's store moves its height before it writes the block's
    index entry, so a deliver stream that reads in that window gets no
    block and ends NOT_FOUND (ROADMAP Queue C); the port's moves it after.
    What a reader sees while block 1's index is being written."""
    seen = {}
    for pkg, Store, decode in (
            ("jax", JaxStore, common_pb2.Block.FromString),
            ("port", PortStore, cb.Block.decode)):
        root = str(tmp_path / pkg) if on_disk else None
        store = Store(root)
        store.add_block(decode(world.chain[0]))
        index_block = store._index_block

        def reading(blk, *a, _store=store, _index=index_block, **kw):
            h = _store.height
            seen[pkg] = (h, _store.get_block_by_number(h - 1) is not None)
            return _index(blk, *a, **kw)

        store._index_block = reading
        store.add_block(decode(world.chain[1]))
        assert store.height == 2
        assert store.get_block_by_number(1).header.number == 1
        store.close()
    assert seen["jax"] == (2, False)  # height 2, block 1 unreadable
    assert seen["port"] == (1, True)  # height 1, block 0 readable
