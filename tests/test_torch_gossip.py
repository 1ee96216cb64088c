"""The port's gossip against the JAX package's.

- A mesh of four nodes on each package's `InProcGossipNet`, driven by the
  same tick schedule with the same seeded rngs (certstore and channel),
  with blocks pushed from the orderer, a partition and a heal: the same
  messages sent (alive incarnations aside, which are clock-derived), the
  same alive and dead sets, store digests, block heights and elected
  leader at every node.
- State transfer: a peer 25 blocks behind at `max_batch` 10 issues the
  same request ranges in both packages and ends at the same height.
- `identity_expiration` equals the JAX value on the world's certificates
  and is None on garbage; `SignerMCS` signatures verify across packages.
- `PrivDataCoordinator` over each package's ledger on the same blocks
  (one transaction with private data in the transient store, one whose
  data is missing): the same flags, KV pairs, private-data store and
  missing records, and byte-equal block files.
- `TCPGossipComm` over mutual TLS carries a block from a JAX node to a
  port node and back, and in both packages a handshake replayed over
  another TLS session is refused.
- A deliberate divergence, pinned on TCP: the port's state provider
  commits a state response's blocks on a worker of its own (as Fabric's
  does), so a leadership message sent after the response is delivered
  while the commit runs; the JAX package's commits on the reader.
- A reference fault, matched and pinned: a node healed from a partition
  rejoins the bootstrap's view alone.  A deliberate divergence, pinned:
  the port's pull requests no block below its ledger height, so blocks
  leave the stores at their TTL, where the JAX package's come back.
- MessageStore's TTL and count bound and the pull's in-flight filter, on
  a spy comm, as the JAX tests drive them.

The gossip wire schemas themselves are held byte for byte against upb in
`tests/test_torch_protos.py`.
"""

import random
import socket
import struct
import threading
import time
import types
from pathlib import Path

import numpy as np
import pytest

import chip_smoke
from fabric_tpu.comm import tls as jax_tls
from fabric_tpu.common.channelconfig import bundle_from_genesis as jax_bundle
from fabric_tpu.common import privdata as jax_pd
from fabric_tpu.csp import SWCSP
from fabric_tpu.gossip import GossipService as JaxService
from fabric_tpu.gossip import comm as jax_comm
from fabric_tpu.gossip import core as jax_core
from fabric_tpu.gossip import identity as jax_identity
from fabric_tpu.gossip import privdata as jax_privdata
from fabric_tpu.gossip import state as jax_state
from fabric_tpu.ledger import kvstore as jax_kv
from fabric_tpu.ledger.kvledger import LedgerProvider as JaxProvider
from fabric_tpu.ledger.transientstore import TransientStore as JaxTransient
from fabric_tpu.msp import SigningIdentity as JaxSigner
from fabric_tpu.peer.txvalidator import TxValidator as JaxValidator
from fabric_tpu.protos.common import common_pb2
from fabric_tpu.protos.gossip import message_pb2 as jgpb
from fabric_tpu_torch import protoutil as pu
from fabric_tpu_torch.comm import tls as port_tls
from fabric_tpu_torch.common import privdata as port_pd
from fabric_tpu_torch.common import workpool
from fabric_tpu_torch.common.channelconfig import (
    bundle_from_genesis as port_bundle,
)
from fabric_tpu_torch.common.crypto import key_pem
from fabric_tpu_torch.common.hashing import sha256
from fabric_tpu_torch.csp.cuda.provider import CUDACSP
from fabric_tpu_torch.csp.hostref import HostCSP
from fabric_tpu_torch.devtools import lockwatch as port_lw
from fabric_tpu_torch.gossip import GossipService as PortService
from fabric_tpu_torch.gossip import comm as port_comm
from fabric_tpu_torch.gossip import core as port_core
from fabric_tpu_torch.gossip import identity as port_identity
from fabric_tpu_torch.gossip import privdata as port_privdata
from fabric_tpu_torch.gossip import state as port_state
from fabric_tpu_torch.ledger import kvstore as port_kv
from fabric_tpu_torch.ledger.kvledger import LedgerProvider as PortProvider
from fabric_tpu_torch.ledger.transientstore import TransientStore
from fabric_tpu_torch.peer.txvalidator import TxValidator as PortValidator
from fabric_tpu_torch.protos import common as cb
from fabric_tpu_torch.protos import gossip as pgpb
from fabric_tpu_torch.protos import peer as pb
from fabric_tpu_torch.protos import rwset as rw

CH = chip_smoke.VALIDATOR_CHANNEL
CC = chip_smoke.VALIDATOR_CC

PKG = {
    "jax": types.SimpleNamespace(
        Service=JaxService, comm=jax_comm, gpb=jgpb,
        block=common_pb2.Block.FromString,
        enc=lambda m: m.SerializeToString()),
    "port": types.SimpleNamespace(
        Service=PortService, comm=port_comm, gpb=pgpb,
        block=cb.Block.decode, enc=lambda m: m.encode()),
}


@pytest.fixture(scope="module", autouse=True)
def _port_watch_gate():
    """The port's lockwatch ledgers are empty and its workers drained at
    the end of this file."""
    yield
    workpool.shutdown()
    assert not port_lw.drain_threads(timeout=15.0)
    assert not port_lw.violations and not port_lw.thread_violations


@pytest.fixture(scope="module")
def world():
    return chip_smoke.validator_world(61)


class FakeCommitter:
    """store_block, height and the committed-block reader."""

    def __init__(self):
        self.blocks = {}
        self.lock = threading.Lock()

    @property
    def height(self) -> int:
        with self.lock:
            return max(self.blocks) + 1 if self.blocks else 0

    def store_block(self, blk) -> None:
        with self.lock:
            self.blocks[blk.header.number] = blk

    def get_block_by_number(self, n):
        with self.lock:
            return self.blocks.get(n)


def _block(num: int) -> bytes:
    blk = pu.new_block(num, b"prev")
    blk.data = cb.BlockData(data=[b"tx-%d" % num])
    return blk.encode()


def _normal(raw: bytes) -> bytes:
    """A sent GossipMessage with its alive incarnations zeroed (they are
    the process's start time in milliseconds)."""
    m = jgpb.GossipMessage.FromString(raw)
    kind = m.WhichOneof("content")
    alives = {"alive_msg": [m.alive_msg],
              "mem_req": [m.mem_req.self_information],
              "mem_res": list(m.mem_res.alive) + list(m.mem_res.dead)
              }.get(kind, [])
    for am in alives:
        am.inc_number = 0
    return m.SerializeToString()


def _mesh(pkg: str, n: int, ttl: int = 0):
    """n nodes on one net, the certstore's and each channel's rng seeded
    per node, every send logged."""
    p = PKG[pkg]
    net = p.comm.InProcGossipNet()
    log: list = []
    nodes, handles, committers = [], [], []
    for i in range(n):
        comm = p.comm.InProcGossipComm(f"n{i}", net, b"identity-n%d" % i)
        send = comm.send

        def logged(ep, m, _ep=comm.endpoint, _send=send):
            log.append((_ep, ep, _normal(p.enc(m))))
            _send(ep, m)

        comm.send = logged
        svc = p.Service(comm, bootstrap=["n0"])
        svc.certstore._rng = random.Random(f"cert-{i}")
        c = FakeCommitter()
        h = svc.join_channel("ch", c)
        h.gossip._rng = random.Random(f"ch-{i}")
        h.gossip.store._ttl = ttl
        nodes.append(svc)
        handles.append(h)
        committers.append(c)
    return net, nodes, handles, committers, log


def _view(nodes, handles, committers):
    return [(sorted(p.endpoint for p in svc.discovery.alive_peers()),
             sorted(p.endpoint for p in svc.discovery.dead_peers()),
             h.gossip.store.digests(), c.height, h.election.is_leader,
             h.election.leader(), svc.certstore.known_pkis())
            for svc, h, c in zip(nodes, handles, committers)]


def _run_mesh(pkg: str, cut: int):
    """Node `cut` is cut off from the rest at round 6, while blocks 0-2
    arrive at n1 from the orderer, and the net heals at round 16."""
    net, nodes, handles, committers, log = _mesh(pkg, 4)
    views = []
    for rnd in range(24):
        if rnd == 6:
            for i in range(4):
                if i != cut:
                    net.partition(f"n{cut}", f"n{i}")
        if rnd in (7, 8, 9):
            handles[1].state.add_payload(rnd - 7, _block(rnd - 7),
                                         from_orderer=True)
        if rnd == 16:
            net.heal()
        for svc in nodes:
            svc.tick()
        if rnd in (5, 10, 15, 23):
            views.append(_view(nodes, handles, committers))
    return log, views


def test_mesh_sends_and_converges_as_the_reference():
    """The bootstrap node n0 is cut off and comes back: every node
    re-learns it, the mesh agrees on one leader, and the cut node pulls
    the blocks it missed."""
    got = {pkg: _run_mesh(pkg, cut=0) for pkg in ("jax", "port")}
    assert len(got["port"][0]) == len(got["jax"][0])
    assert got["port"][0] == got["jax"][0]
    assert got["port"][1] == got["jax"][1]
    views = got["port"][1]
    assert [v[1] for v in views[2]] == [["n1", "n2", "n3"], ["n0"],
                                        ["n0"], ["n0"]]
    last = views[-1]
    assert [v[0] for v in last] == [
        [f"n{j}" for j in range(4) if j != i] for i in range(4)]
    assert [v[3] for v in last] == [3] * 4
    assert sum(v[4] for v in last) == 1
    assert len({v[5] for v in last}) == 1


def test_a_healed_peer_rejoins_the_bootstrap_alone_as_the_reference():
    """A reference fault, matched: after a heal, a node that is not the
    bootstrap sends its alive messages to the bootstrap and the peers it
    still holds alive, and membership is exchanged only by a node that
    knows no one; so n3 comes back in n0's view alone, and n1 and n2
    keep it dead (JAX `gossip/discovery.py` `tick`, `_handle`)."""
    got = {pkg: _run_mesh(pkg, cut=3) for pkg in ("jax", "port")}
    assert got["port"][0] == got["jax"][0]
    assert got["port"][1] == got["jax"][1]
    last = got["port"][1][-1]
    assert [v[1] for v in last] == [[], ["n3"], ["n3"], ["n1", "n2"]]
    assert [v[3] for v in last] == [3] * 4


def _state_catch_up(pkg: str):
    net, nodes, handles, committers, log = _mesh(pkg, 2)
    p = PKG[pkg]
    for seq in range(25):
        committers[0].store_block(p.block(_block(seq)))
    for _ in range(8):
        for svc in nodes:
            svc.tick()
    kinds = [jgpb.GossipMessage.FromString(raw) for frm, _, raw in log
             if frm == "n1"]
    ranges = [(m.state_request.start_seq_num, m.state_request.end_seq_num)
              for m in kinds if m.WhichOneof("content") == "state_request"]
    return ranges, committers[1].height


def test_state_transfer_requests_ranges_as_the_reference():
    got = {pkg: _state_catch_up(pkg) for pkg in ("jax", "port")}
    assert got["port"] == got["jax"]
    ranges, height = got["port"]
    assert height == 25
    assert ranges[0] == (0, 9) and all(e - s < 10 for s, e in ranges)


def test_identity_expiration_as_the_reference(world):
    ids = [world.client.serialize()] + [p.serialize() for p in world.peers]
    port = [port_identity.identity_expiration(i) for i in ids]
    assert port == [jax_identity.identity_expiration(i) for i in ids]
    assert all(isinstance(t, float) and t > time.time() for t in port)
    for junk in (b"", b"garbage", b"\x0a\x03abc\x12\x05nopem"):
        assert port_identity.identity_expiration(junk) is None
        assert jax_identity.identity_expiration(junk) is None


def test_signer_mcs_signatures_verify_across_packages(world):
    signer = world.peers[1]
    jax_signer = JaxSigner.from_pem(signer.mspid, signer.cert.pem(),
                                    key_pem(signer._key), SWCSP())
    jb = jax_bundle(common_pb2.Block.FromString(world.genesis), SWCSP())
    ptb = port_bundle(cb.Block.decode(world.genesis))
    mcs = {"jax": jax_comm.SignerMCS(jax_signer, jb.msp_manager, SWCSP()),
           "port": port_comm.SignerMCS(signer, ptb.msp_manager, HostCSP())}
    ident = signer.serialize()
    payload = b"a gossip payload"
    for by in mcs:
        sig = mcs[by].sign(payload)
        for check in mcs:
            assert mcs[check].verify(ident, sig, payload)
            assert not mcs[check].verify(ident, sig, payload + b"x")
            assert not mcs[check].verify(b"garbage", sig, payload)
    assert mcs["port"].get_pki_id(ident) == mcs["jax"].get_pki_id(ident)


# -- the private-data coordinator ---------------------------------------------

COLL = "coll"


def _pvt_tx(world, b: int, i: int, pvt_value: bytes):
    """An endorsed transaction of block index b that writes key
    p{b}-{i} of collection COLL (its hashed rwset rides the public one)
    and its cleartext TxPvtReadWriteSet."""
    key = f"p{b}-{i}"
    kv = rw.KVRWSet(writes=[rw.KVWrite(key=key, value=pvt_value)]).encode()
    hashed = rw.HashedRWSet(hashed_writes=[rw.KVWriteHash(
        key_hash=sha256(key.encode()),
        value_hash=sha256(pvt_value))]).encode()
    results = rw.TxReadWriteSet(ns_rwset=[rw.NsReadWriteSet(
        namespace=CC, rwset=chip_smoke.tx_rwset(b, i).encode(),
        collection_hashed_rwset=[rw.CollectionHashedReadWriteSet(
            collection_name=COLL, hashed_rwset=hashed,
            pvt_rwset_hash=sha256(kv))])]).encode()
    env = chip_smoke.signed_tx(world, CC, [b"pvt", key.encode()], results,
                               chip_smoke.VALIDATOR_TS + b)
    pvt = rw.TxPvtReadWriteSet(ns_pvt_rwset=[rw.NsPvtReadWriteSet(
        namespace=CC, collection_pvt_rwset=[rw.CollectionPvtReadWriteSet(
            collection_name=COLL, rwset=kv)])]).encode()
    return env, pvt


@pytest.fixture(scope="module")
def pvt_blocks(world):
    """Two blocks of 6: block 1 plain, block 2 with private writes at
    transactions 2 (data in the transient store) and 4 (missing)."""
    prev = world.genesis_hash
    blocks, pvts = [], {}
    for b in range(2):
        envs = [chip_smoke.endorsed_tx(world, b, i, chip_smoke.ENDORSERS)
                for i in range(6)]
        if b == 1:
            for i in (2, 4):
                envs[i], pvts[i] = _pvt_tx(world, b, i, b"secret-%d" % i)
        blocks.append(chip_smoke.seal_block(1 + b, prev, envs))
        prev = pu.block_header_hash(cb.Block.decode(blocks[-1]).header)
    return blocks, pvts


def _txid(env: bytes) -> str:
    return pu.channel_header(cb.Envelope.decode(env)).tx_id


def _coordinate(pkg, world, root, blocks, pvts):
    collections = port_pd.collection_package(port_pd.static_collection(
        COLL, ["Org1MSP", "Org2MSP"])).encode()
    me = world.peers[0].serialize()
    envs = cb.Block.decode(blocks[1]).data.data
    if pkg == "jax":
        provider = JaxProvider(str(root))
        ledger = provider.create(common_pb2.Block.FromString(world.genesis))
        bundle = jax_bundle(common_pb2.Block.FromString(world.genesis),
                            SWCSP())
        store = jax_pd.CollectionStore(bundle.msp_manager)
        transient = JaxTransient(jax_kv.MemKVStore(), CH)
        validator = JaxValidator(CH, ledger, bundle, SWCSP())
        coord = jax_privdata.PrivDataCoordinator(validator, ledger, transient,
                                                 store, me)
        decode = common_pb2.Block.FromString
    else:
        provider = PortProvider(str(root))
        ledger = provider.create(cb.Block.decode(world.genesis))
        bundle = port_bundle(cb.Block.decode(world.genesis))
        store = port_pd.CollectionStore(bundle.msp_manager)
        transient = TransientStore(port_kv.MemKVStore(), CH)
        validator = PortValidator(CH, ledger, bundle,
                                  CUDACSP(device="cpu"))
        coord = port_privdata.PrivDataCoordinator(validator, ledger,
                                                  transient, store, me)
        decode = cb.Block.decode
    store.set_collections(CC, collections)
    transient.persist(_txid(envs[2]), 2, pvts[2])
    flags = [coord.store_block(decode(raw)) for raw in blocks]
    out = (flags, list(provider.kv.iterate()),
           ledger.pvt_store.get_pvt_data_by_block(2),
           list(ledger.pvt_store.get_missing()),
           transient.get_tx_pvt_rwsets(_txid(envs[2])),
           {p.name: p.read_bytes()
            for p in sorted((Path(root) / CH / "chains").iterdir())})
    provider.close()
    return out


def test_privdata_coordinator_commits_as_the_reference(world, pvt_blocks,
                                                       tmp_path):
    blocks, pvts = pvt_blocks
    got = {pkg: _coordinate(pkg, world, tmp_path / pkg, blocks, pvts)
           for pkg in ("jax", "port")}
    assert got["port"][0] == got["jax"][0] == [[pb.VALID] * 6] * 2
    assert got["port"][1] == got["jax"][1]
    assert got["port"][2] == got["jax"][2]
    assert set(got["port"][2]) == {2}  # tx 2's data, from the transient store
    assert got["port"][3] == got["jax"][3] == [(2, 4, CC, COLL)]
    assert got["port"][4] == got["jax"][4] == []  # purged after the commit
    assert got["port"][5] == got["jax"][5]


# -- TCP over mutual TLS --------------------------------------------------------


class _ToyMCS:
    """A shared-secret signer, so that the handshakes' signatures are
    real in both packages."""

    def __init__(self, base):
        self._base = base

    def __getattr__(self, name):
        return getattr(self._base, name)

    def sign(self, payload: bytes) -> bytes:
        return sha256(b"toy-secret" + payload)

    def verify(self, identity: bytes, signature: bytes,
               payload: bytes) -> bool:
        return signature == sha256(b"toy-secret" + payload)


@pytest.fixture(scope="module")
def tls_ca():
    return chip_smoke.CA("tlsca.gossip.example.com", "Org1MSP",
                         rng=np.random.default_rng(67))


def _tcp(pkg, ca, name, identity):
    creds = (jax_tls if pkg == "jax" else port_tls).credentials_from_ca(
        ca, name)
    comm = PKG[pkg].comm
    return comm.TCPGossipComm(
        ("127.0.0.1", 0), identity,
        mcs=_ToyMCS(comm.MessageCryptoService()), tls=creds)


def _wait(pred, timeout=10.0) -> bool:
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if pred():
            return True
        time.sleep(0.02)
    return False


def test_tcp_gossip_carries_blocks_between_the_packages(tls_ca):
    a = _tcp("jax", tls_ca, "peer-jax", b"id-jax")
    b = _tcp("port", tls_ca, "peer-port", b"id-port")
    got = {"jax": [], "port": []}
    a.subscribe(lambda rm: got["jax"].append(
        (rm.msg.data_msg.seq_num, bytes(rm.msg.data_msg.block),
         rm.sender_pki)))
    b.subscribe(lambda rm: got["port"].append(
        (rm.msg.data_msg.seq_num, rm.msg.data_msg.block, rm.sender_pki)))
    try:
        jm = jgpb.GossipMessage(channel=b"ch")
        jm.data_msg.seq_num = 7
        jm.data_msg.block = _block(7)
        a.send(b.endpoint, jm)
        assert _wait(lambda: got["port"])
        b.send(a.endpoint, pgpb.GossipMessage(
            channel=b"ch", data_msg=pgpb.DataMessage(seq_num=8,
                                                     block=_block(8))))
        assert _wait(lambda: got["jax"])
        assert got["port"] == [(7, _block(7), a.pki_id)]
        assert got["jax"] == [(8, _block(8), b.pki_id)]
        assert b.identity_of(a.pki_id) == b"id-jax"
        assert a.identity_of(b.pki_id) == b"id-port"
    finally:
        a.close()
        b.close()


class _GatedCommitter(FakeCommitter):
    """A committer whose store_block waits for `release`."""

    def __init__(self):
        super().__init__()
        self.busy, self.release = threading.Event(), threading.Event()

    def store_block(self, blk) -> None:
        self.busy.set()
        self.release.wait(10)
        super().store_block(blk)


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_a_state_response_commits_off_the_tcp_reader(pkg, tls_ca):
    """A deliberate divergence, pinned: over TCP the port's state
    provider buffers a state response's blocks on the connection's reader
    and commits them on a worker of its own, as Fabric's commits on a
    goroutine of its own, so a leadership message sent after the response
    is delivered while the commit still runs; the JAX package's commits
    on the reader, and the declaration waits for the commit.  Both commit
    the blocks in order."""
    g = PKG[pkg].gpb
    a = _tcp(pkg, tls_ca, "peer-a", b"id-a")
    b = _tcp(pkg, tls_ca, "peer-b", b"id-b")
    committer = _GatedCommitter()
    gossip = types.SimpleNamespace(
        best_peer_height=lambda: (None, 0), add_block=lambda *_: None,
        store={}, _endpoint_for=lambda _: None)
    (jax_state if pkg == "jax" else port_state).StateProvider(
        "ch", gossip, committer, b)
    leaders = []

    def on_message(rm):
        kind = (rm.msg.WhichOneof("content") if pkg == "jax"
                else rm.msg.which("content"))
        if kind == "leadership_msg":
            leaders.append(rm.msg.leadership_msg.is_declaration)

    b.subscribe(on_message)
    if pkg == "jax":
        response = g.GossipMessage(channel=b"ch")
        for seq in (0, 1):
            response.state_response.payloads.add(seq_num=seq,
                                                 block=_block(seq))
        declaration = g.GossipMessage(channel=b"ch")
        declaration.leadership_msg.pki_id = a.pki_id
        declaration.leadership_msg.is_declaration = True
    else:
        response = g.GossipMessage(
            channel=b"ch", state_response=g.RemoteStateResponse(payloads=[
                g.DataMessage(seq_num=seq, block=_block(seq))
                for seq in (0, 1)]))
        declaration = g.GossipMessage(
            channel=b"ch", leadership_msg=g.LeadershipMessage(
                pki_id=a.pki_id, is_declaration=True))
    try:
        a.send(b.endpoint, response)
        a.send(b.endpoint, declaration)
        assert committer.busy.wait(10)
        if pkg == "port":
            assert _wait(lambda: leaders == [True])
        else:
            assert not _wait(lambda: leaders, timeout=1.0)
        assert not committer.blocks
        committer.release.set()
        assert _wait(lambda: sorted(committer.blocks) == [0, 1]
                     and leaders == [True])
    finally:
        committer.release.set()
        a.close()
        b.close()


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_a_handshake_replayed_over_another_session_is_refused(pkg, tls_ca):
    """Mallory's TLS session carries a validly signed handshake whose
    certificate hash is the victim's: the listener drops it; the same
    handshake with Mallory's own hash is served."""
    listener = _tcp(pkg, tls_ca, "listener", b"id-listener")
    got = []
    listener.subscribe(lambda rm: got.append(rm.sender_pki))
    mallory = port_tls.credentials_from_ca(tls_ca, "mallory")
    victim = port_tls.credentials_from_ca(tls_ca, "victim")
    mcs = _ToyMCS(port_comm.MessageCryptoService())
    lenp = struct.Struct(">I")

    def attempt(cert_hash):
        pki = mcs.get_pki_id(b"id-victim")
        ce = pgpb.ConnEstablish(
            pki_id=pki, identity=b"id-victim", tls_cert_hash=cert_hash,
            endpoint="127.0.0.1:1",
            signature=mcs.sign(pki + cert_hash + b"127.0.0.1:1"))
        host, port = listener.endpoint.rsplit(":", 1)
        sock = mallory.client_context().wrap_socket(
            socket.create_connection((host, int(port)), timeout=3),
            server_hostname=host)
        msg = pgpb.GossipMessage(data_msg=pgpb.DataMessage(seq_num=1))
        signed = pgpb.SignedGossipMessage(
            payload=msg.encode(), signature=mcs.sign(msg.encode())).encode()
        for raw in (ce.encode(), signed):
            sock.sendall(lenp.pack(len(raw)) + raw)
        return sock

    try:
        s1 = attempt(victim.cert_hash)
        assert not _wait(lambda: got, timeout=1.0)
        s2 = attempt(mallory.cert_hash)
        assert _wait(lambda: got)
        s1.close()
        s2.close()
    finally:
        listener.close()


def _ping_pong(pkg: str):
    net, nodes, handles, committers, log = _mesh(pkg, 3, ttl=2)
    for _ in range(3):
        for svc in nodes:
            svc.tick()
    handles[0].state.add_payload(0, _block(0), from_orderer=True)
    stores = []
    for _ in range(12):
        for svc in nodes:
            svc.tick()
        stores.append([h.gossip.store.digests() for h in handles])
    msgs = [jgpb.GossipMessage.FromString(raw) for _, _, raw in log]
    pulls = sum(m.WhichOneof("content") == "data_req"
                and m.data_req.msg_type == jgpb.PULL_BLOCK_MSG for m in msgs)
    return stores, pulls, [c.height for c in committers], log


def test_expired_blocks_stay_out_of_the_stores_unlike_the_reference():
    """A deliberate divergence, pinned.  In the JAX package a pull
    requests every digest its store lacks, committed or not, so three
    peers with a TTL of 2 ticks pass block 0 back and forth and still
    hold it twelve ticks on (JAX `gossip/core.py` `_handle`, data_dig).
    The port requests no digest below its ledger height (Fabric's block
    puller does the same), so the TTL empties the stores.  Up to the
    first re-request the two packages send the same messages."""
    got = {pkg: _ping_pong(pkg) for pkg in ("jax", "port")}
    jstores, jpulls, jheights, jlog = got["jax"]
    pstores, ppulls, pheights, plog = got["port"]
    assert jheights == pheights == [1, 1, 1]
    assert any(0 in s for s in jstores[-1]) and jpulls > 0
    assert pstores[-1] == [[], [], []] and ppulls == 0
    first = next(i for i, (_, _, raw) in enumerate(jlog)
                 if (lambda m: m.WhichOneof("content") == "data_req"
                     and m.data_req.msg_type == jgpb.PULL_BLOCK_MSG)(
                         jgpb.GossipMessage.FromString(raw)))
    assert plog[:first] == jlog[:first]


class _SpyComm:
    pki_id = b"spy"

    def __init__(self, pkg):
        self.pkg = pkg
        self.sent = []

    def subscribe(self, fn):
        self.handler = fn

    def send(self, ep, msg):
        self.sent.append((ep, PKG[self.pkg].enc(msg)))

    def wrap(self, m):
        return PKG[self.pkg].gpb.SignedGossipMessage(
            payload=PKG[self.pkg].enc(m))


def test_message_store_ttl_and_inflight_filter_as_the_reference():
    """The JAX tests' MessageStore TTL case and in-flight digest filter,
    on both packages: the same digests, expiry callbacks and requests."""
    got = {}
    for pkg in ("jax", "port"):
        core = jax_core if pkg == "jax" else port_core
        expired = []
        cg = core.ChannelGossip(
            "ch", _SpyComm(pkg), lambda: [], store_ttl_ticks=3,
            on_expire=lambda seq, blk: expired.append((seq, blk)))
        seen = []
        cg.add_block(1, b"b1", push=False)
        for t in range(4):
            cg.tick()
            if t == 0:
                cg.add_block(2, b"b2", push=False)
            seen.append(cg.store.digests())
        capped = core.ChannelGossip("ch", _SpyComm(pkg), lambda: [],
                                    store_capacity=2)
        for s in (1, 2, 3):
            capped.add_block(s, b"x", push=False)
        comm = _SpyComm(pkg)
        pull = core.ChannelGossip("ch", comm, lambda: ["a", "b"],
                                  rng=random.Random(3))
        pull.tick()
        hellos = [jgpb.GossipMessage.FromString(raw) for _, raw in comm.sent]
        comm.sent.clear()
        pull._endpoint_for = lambda pki: "a"
        gpb = PKG[pkg].gpb
        for h in hellos:
            if h.WhichOneof("content") != "hello":
                continue
            dig = gpb.GossipMessage.FromString if pkg == "jax" else \
                gpb.GossipMessage.decode
            raw = jgpb.GossipMessage(channel=b"ch", data_dig=jgpb.DataDigest(
                nonce=h.hello.nonce, msg_type=jgpb.PULL_BLOCK_MSG,
                digests=[b"7"])).SerializeToString()
            pull._handle(types.SimpleNamespace(msg=dig(raw), sender_pki=b"x"))
        got[pkg] = (seen, expired, capped.store.digests(), comm.sent)
    assert got["port"] == got["jax"]
    seen, expired, capped, sent = got["port"]
    assert seen == [[1, 2], [1, 2], [2], []]
    assert expired == [(1, b"b1"), (2, b"b2")]
    assert capped == [2, 3]
    reqs = [raw for _, raw in sent
            if jgpb.GossipMessage.FromString(raw).WhichOneof("content")
            == "data_req"]
    assert len(reqs) == 1
