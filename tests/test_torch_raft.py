"""The port's raft ordering against the JAX package's.

- raftcore: the reference's protocol cases and a seeded fuzz of steps,
  drops and partitions drive both packages' `RaftNode`s with the same
  seeds and schedule; every `Ready` (messages as bytes, entries to
  persist, the hard state, committed entries, a snapshot) is equal;
- the WAL: the same calls write equal files, each package loads the
  other's directory, torn at every byte of its last record too, and the
  snapshot and rotation cases;
- the TCP transport: pinned, unpinned and `set_pinned` links, and a
  mixed cluster (two JAX nodes, one port node) over loopback mutual TLS;
- the chain and the registrar: each package's 3-node cluster on an
  in-process transport orders the same envelopes through a leader
  failover to equal blocks; a consenter added and removed; eviction; a
  restart from the WAL; the two crash-contract cases; the stale leader's
  non-chaining block dropped; a node behind a compaction point with no
  block puller stays behind in both; each package's Registrar resumes on
  the other's root, its raft WAL included.

Raft is driven by ticks and steps where the case allows; the chains run
their own loop threads at a 10 ms tick.
"""

import os
import random
import threading
import time
import types

import numpy as np
import pytest

import chip_smoke
from fabric_tpu.comm.tls import TLSCredentials as JaxCreds
from fabric_tpu.csp import SWCSP
from fabric_tpu.ledger.blkstorage import BlockStore as JaxStore
from fabric_tpu.msp import SigningIdentity as JaxSigner
from fabric_tpu.orderer import raft as jax_raft
from fabric_tpu.orderer.blockcutter import BlockCutter as JaxCutter
from fabric_tpu.orderer.blockwriter import BlockWriter as JaxWriter
from fabric_tpu.orderer.blockwriter import (
    verify_block_signature as jax_verify,
)
from fabric_tpu.orderer.multichannel import ChannelStepRouter as JaxRouter
from fabric_tpu.orderer.multichannel import Registrar as JaxRegistrar
from fabric_tpu.orderer.raft import raftcore as jax_core
from fabric_tpu.orderer.raft import transport as jax_transport
from fabric_tpu.protos.common import common_pb2
from fabric_tpu.protos.orderer import raft_pb2 as rpb
from fabric_tpu_torch import protoutil as pu
from fabric_tpu_torch.comm.tls import credentials_from_ca
from fabric_tpu_torch.common import workpool
from fabric_tpu_torch.common.crypto import CA
from fabric_tpu_torch.csp.hostref import HostCSP
from fabric_tpu_torch.devtools import lockwatch as port_lw
from fabric_tpu_torch.ledger.blkstorage import BlockStore as PortStore
from fabric_tpu_torch.msp.identity import SigningIdentity as PortSigner
from fabric_tpu_torch.orderer import raft as port_raft
from fabric_tpu_torch.orderer.blockcutter import BlockCutter as PortCutter
from fabric_tpu_torch.orderer.blockwriter import BlockWriter as PortWriter
from fabric_tpu_torch.orderer.blockwriter import (
    verify_block_signature as port_verify,
)
from fabric_tpu_torch.orderer.multichannel import (
    ChannelStepRouter as PortRouter,
)
from fabric_tpu_torch.orderer.multichannel import Registrar as PortRegistrar
from fabric_tpu_torch.orderer.raft import raftcore as port_core
from fabric_tpu_torch.orderer.raft import transport as port_transport
from fabric_tpu_torch.protos import common as cb
from fabric_tpu_torch.protos import orderer as ob

CH = "testchannel"


@pytest.fixture(scope="module", autouse=True)
def _port_watch_gate():
    """The port's lockwatch ledgers are empty and its workers drained at
    the end of this file."""
    yield
    workpool.shutdown()
    assert not port_lw.drain_threads(timeout=15.0)
    assert not port_lw.violations and not port_lw.thread_violations


PKG = {
    "jax": types.SimpleNamespace(
        core=jax_core, raft=jax_raft, pb=rpb, transport=jax_transport,
        Store=JaxStore, Writer=JaxWriter, Cutter=JaxCutter,
        Registrar=JaxRegistrar, Router=JaxRouter, csp=SWCSP,
        decode=lambda cls, raw: cls.FromString(raw),
        block=common_pb2.Block.FromString,
        env=lambda raw: common_pb2.Envelope(payload=raw)),
    "port": types.SimpleNamespace(
        core=port_core, raft=port_raft, pb=ob, transport=port_transport,
        Store=PortStore, Writer=PortWriter, Cutter=PortCutter,
        Registrar=PortRegistrar, Router=PortRouter, csp=HostCSP,
        decode=lambda cls, raw: cls.decode(raw),
        block=cb.Block.decode,
        env=lambda raw: cb.Envelope(payload=raw)),
}


def _enc(m) -> bytes:
    return m.SerializeToString() if hasattr(m, "SerializeToString") \
        else m.encode()


def _conf_change(pkg: str, action: int, nid: int):
    pb = PKG[pkg].pb
    return pb.ConfChange(action=action, consenter=pb.Consenter(id=nid))


# -- raftcore --------------------------------------------------------------------


class Cluster:
    """Deterministic in-test cluster of one package's RaftNodes (the
    reference's `tests/test_raft.py` harness), recording every Ready as
    bytes."""

    def __init__(self, pkg: str, n: int, seed: int = 7):
        self.p = PKG[pkg]
        self.nodes = {i: self.p.core.RaftNode(i, set(range(1, n + 1)),
                                              rng=random.Random(seed + i))
                      for i in range(1, n + 1)}
        self.dropped: set[int] = set()
        self.applied = {i: [] for i in self.nodes}
        self.record: list = []
        self.drop_mask = None  # a per-message drop schedule (the fuzz)
        self._sent = 0

    def _ready(self, nid, node):
        rd = node.ready()
        self.record.append((
            nid, [_enc(m) for m in rd.messages],
            [_enc(e) for e in rd.persist_entries],
            None if rd.hard_state is None else _enc(rd.hard_state),
            [_enc(e) for e in rd.committed],
            None if rd.snapshot is None else _enc(rd.snapshot),
            rd.soft_leader))
        return rd

    def flush(self, rounds: int = 20) -> None:
        pb = self.p.pb
        for _ in range(rounds):
            moved = False
            for nid, node in self.nodes.items():
                rd = self._ready(nid, node)
                for e in rd.committed:
                    if e.type == pb.ENTRY_CONF_CHANGE:
                        node.apply_conf_change(
                            self.p.decode(pb.ConfChange, e.data))
                    elif e.data:
                        self.applied[nid].append(e.data)
                for m in rd.messages:
                    moved = True
                    k, self._sent = self._sent, self._sent + 1
                    if nid in self.dropped or m.to in self.dropped:
                        continue
                    if self.drop_mask is not None and \
                            self.drop_mask[k % len(self.drop_mask)]:
                        continue
                    if m.to in self.nodes:
                        self.nodes[m.to].step(m)
            if not moved:
                return

    def tick_all(self, n: int = 1) -> None:
        for _ in range(n):
            for nid, node in self.nodes.items():
                if nid not in self.dropped:
                    node.tick()
            self.flush()

    def leader(self):
        for i, n in self.nodes.items():
            if n.state == self.p.core.LEADER and i not in self.dropped:
                return n
        return None

    def elect(self, max_ticks: int = 200):
        for _ in range(max_ticks):
            self.tick_all()
            if self.leader() is not None:
                return self.leader()
        raise AssertionError("no leader elected")


def _case_single(c):
    leader = c.elect()
    assert leader.propose(b"tx1")
    c.flush()
    assert c.applied[leader.id] == [b"tx1"]


def _case_three(c):
    leader = c.elect()
    for i in range(5):
        assert leader.propose(b"tx%d" % i)
    c.flush()
    for nid in c.nodes:
        assert c.applied[nid] == [b"tx%d" % i for i in range(5)]


def _case_reelection(c):
    leader = c.elect()
    leader.propose(b"before")
    c.flush()
    c.dropped.add(leader.id)
    new = c.elect()
    assert new.id != leader.id
    new.propose(b"after")
    c.flush()
    c.dropped.clear()
    c.tick_all(5)
    assert c.applied[leader.id] == [b"before", b"after"]


def _case_stale_leader(c):
    leader = c.elect()
    leader.propose(b"committed")
    c.flush()
    c.dropped.add(leader.id)
    leader.propose(b"lost")
    new = c.elect()
    new.propose(b"won")
    c.flush()
    c.dropped.clear()
    c.tick_all(10)
    for nid in c.nodes:
        assert c.applied[nid] == [b"committed", b"won"]


def _case_conf_change(c):
    pkg = "jax" if c.p is PKG["jax"] else "port"
    pb = c.p.pb
    leader = c.elect()
    assert leader.propose_conf_change(
        _conf_change(pkg, pb.ConfChange.ADD_NODE, 4))
    c.flush()
    assert 4 in leader.voters
    leader.propose_conf_change(_conf_change(pkg, pb.ConfChange.REMOVE_NODE, 4))
    c.flush()
    assert 4 not in leader.voters


def _case_quorum_loss(c):
    leader = c.elect()
    c.dropped.update(set(c.nodes) - {leader.id})
    leader.propose(b"stuck")
    c.tick_all(5)
    assert c.applied[leader.id] == []


CASES = {"single_node_self_elects": (1, _case_single),
         "three_node_replication": (3, _case_three),
         "leader_failure_reelection": (3, _case_reelection),
         "stale_leader_proposal_discarded": (3, _case_stale_leader),
         "conf_change_add_and_remove": (3, _case_conf_change),
         "quorum_loss_blocks_commit": (3, _case_quorum_loss)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_raftcore_cases_give_equal_readies(case):
    n, fn = CASES[case]
    records = {}
    for pkg in ("jax", "port"):
        c = Cluster(pkg, n)
        fn(c)
        records[pkg] = c.record
    assert len(records["port"]) == len(records["jax"])
    assert records["port"] == records["jax"]


def _fuzz(pkg: str, seed: int, steps: int = 200):
    """A seeded schedule: ticks, proposals on the leader, partitions and
    heals, with a per-message drop mask; every decision is drawn before
    the run, so both packages see the same schedule."""
    rng = np.random.default_rng(seed)
    c = Cluster(pkg, 3, seed=seed)
    c.drop_mask = rng.random(4096) < 0.1
    ops = rng.integers(0, 10, size=steps)
    who = rng.integers(1, 4, size=steps)
    for k in range(steps):
        op, nid = int(ops[k]), int(who[k])
        if op < 5:
            node = c.nodes[nid]
            if nid not in c.dropped:
                node.tick()
        elif op < 8:
            lead = c.leader()
            if lead is not None:
                lead.propose(b"e%d" % k)
        elif op == 8:
            c.dropped = {nid}
        else:
            c.dropped = set()
        c.flush()
    c.dropped = set()
    c.tick_all(30)
    return c


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_raftcore_seeded_fuzz_gives_equal_readies(seed):
    got = {pkg: _fuzz(pkg, seed) for pkg in ("jax", "port")}
    assert got["port"].record == got["jax"].record
    assert got["port"].applied == got["jax"].applied
    # replicas agree on their applied prefix
    logs = list(got["port"].applied.values())
    short = min(len(x) for x in logs)
    assert short > 0 and all(x[:short] == logs[0][:short] for x in logs)


# -- the WAL -----------------------------------------------------------------------


def _wal_calls(pkg: str, path: str):
    pb = PKG[pkg].pb
    w = PKG[pkg].raft.WAL(path)
    w.load()
    w.save(pb.HardState(term=1, voted_for=2, commit=0), [
        pb.Entry(index=1, term=1, data=b"a"),
        pb.Entry(index=2, term=1, type=pb.ENTRY_CONF_CHANGE, data=b"b")])
    w.save(pb.HardState(term=2, voted_for=2, commit=2),
           [pb.Entry(index=3, term=2, data=b"c" * 300)])
    w.save(None, [])
    w.close()


def _wal_view(pkg: str, path: str):
    w = PKG[pkg].raft.WAL(path)
    hs, log, snap = w.load()
    w.close()
    return (_enc(hs), log.snap_index, log.snap_term,
            [_enc(e) for e in log.entries],
            None if snap is None else _enc(snap))


def test_wal_files_are_equal_and_load_across(tmp_path):
    raws = {}
    for pkg in ("jax", "port"):
        _wal_calls(pkg, str(tmp_path / pkg))
        raws[pkg] = (tmp_path / pkg / "raft.wal").read_bytes()
    assert raws["port"] == raws["jax"]
    for reader in ("jax", "port"):
        views = {w: _wal_view(reader, str(tmp_path / w))
                 for w in ("jax", "port")}
        assert views["jax"] == views["port"]
        assert len(views["jax"][3]) == 3


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_wal_torn_at_each_byte_of_its_last_record(tmp_path, writer, reader):
    _wal_calls(writer, str(tmp_path / "full"))
    raw = (tmp_path / "full" / "raft.wal").read_bytes()
    # the last record: the second save's hard state
    last = len(PKG["port"].pb.WALRecord(
        hard_state=ob.HardState(term=2, voted_for=2, commit=2)).encode()) + 8
    for cut in range(len(raw) - last, len(raw)):
        views = {}
        for pkg in ("jax", "port") if cut % 7 == 0 else (reader,):
            d = tmp_path / f"cut{cut}-{pkg}"
            d.mkdir()
            (d / "raft.wal").write_bytes(raw[:cut])
            views[pkg] = _wal_view(pkg, str(d))
            # the torn tail is cut off the file
            assert (d / "raft.wal").stat().st_size == len(raw) - last
        view = views[reader]
        hs = PKG[reader].pb.HardState
        assert view[0] == _enc(hs(term=1, voted_for=2, commit=0))
        assert len(view[3]) == 3
        if len(views) == 2:
            assert views["jax"] == views["port"]


@pytest.mark.parametrize("rotate", [False, True])
def test_wal_snapshot_and_rotate_as_the_reference(tmp_path, rotate):
    raws, views = {}, {}
    for pkg in ("jax", "port"):
        pb = PKG[pkg].pb
        path = str(tmp_path / pkg)
        w = PKG[pkg].raft.WAL(path)
        w.load()
        big = b"x" * (5 << 20) if rotate else b"e"
        w.save(None, [pb.Entry(index=i, term=1, data=big + b"%d" % i)
                      for i in (1, 2, 3)])
        snap = pb.Snapshot(meta=pb.SnapshotMeta(index=2, term=1,
                                                voters=[1, 2, 3]),
                           block_number=7, block_hash=b"h" * 32)
        w.save_snapshot(snap)
        w.save(pb.HardState(term=1, voted_for=1, commit=3), [])
        w.close()
        raws[pkg] = (tmp_path / pkg / "raft.wal").read_bytes()
        views[pkg] = {r: _wal_view(r, path) for r in ("jax", "port")}
    assert raws["port"] == raws["jax"]
    assert views["port"] == views["jax"]
    for view in views["port"].values():
        assert view[1:3] == (2, 1)
        # rotated, the file lost entry 3; else it replays above the snapshot
        assert len(view[3]) == (0 if rotate else 1)
    if rotate:
        assert len(raws["port"]) < 1 << 10


# -- the TCP transport over pinned mutual TLS ----------------------------------------


@pytest.fixture(scope="module")
def tls_ca():
    return CA("tlsca.orderer.example.com", "orderer",
              rng=np.random.default_rng(23))


def _creds(pkg: str, ca, cn: str):
    c = credentials_from_ca(ca, cn)
    if pkg == "jax":
        c = JaxCreds(cert_pem=c.cert_pem, key_pem=c.key_pem,
                     ca_pems=list(c.ca_pems))
    return c


def _wait(pred, timeout=10.0):
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if pred():
            return True
        time.sleep(0.01)
    return False


def _step(pkg: str, frm: int):
    pb = PKG[pkg].pb
    return pb.StepRequest(channel="tlsch", consensus=pb.RaftMessage(
        type=pb.MSG_APPEND, sender=frm, term=7))


@pytest.mark.parametrize("sender,receiver",
                         [("jax", "port"), ("port", "jax"), ("port", "port")])
def test_pinned_unpinned_and_set_pinned(tls_ca, sender, receiver):
    """A pinned consenter's frame arrives; a node of the same CA that is
    not pinned is refused; `set_pinned` admits it."""
    creds = {1: _creds(sender, tls_ca, "orderer1"),
             2: _creds(receiver, tls_ca, "orderer2")}
    pinned = [c.cert_der for c in creds.values()]
    for c in creds.values():
        c.pinned_certs = list(pinned)
    rogue = _creds(sender, tls_ca, "orderer3")
    rogue.pinned_certs = list(pinned)
    tr = PKG[receiver].transport
    ts = PKG[sender].transport
    t2 = tr.TCPTransport(2, ("127.0.0.1", 0), tls=creds[2])
    got = []
    t2.set_handler(lambda req: got.append(req.consensus.sender))
    t1 = ts.TCPTransport(1, ("127.0.0.1", 0), tls=creds[1])
    t3 = ts.TCPTransport(3, ("127.0.0.1", 0), tls=rogue)
    try:
        t1.set_peer(2, t2.addr)
        t1.send(1, 2, _step(sender, 1))
        assert _wait(lambda: got == [1])
        t3.set_peer(2, t2.addr)
        t3.send(3, 2, _step(sender, 3))
        assert not _wait(lambda: len(got) > 1, timeout=1.0)
        t2.set_pinned(pinned + [rogue.cert_der])
        t3.remove_peer(2)
        t3.set_peer(2, t2.addr)
        t3.send(3, 2, _step(sender, 3))
        assert _wait(lambda: got == [1, 3])
    finally:
        for t in (t1, t3, t2):
            t.close()


def test_frames_are_the_references_byte_for_byte():
    """A StepRequest carrying entries frames to the same bytes."""
    frames = {}
    for pkg in ("jax", "port"):
        pb = PKG[pkg].pb
        req = pb.StepRequest(channel=CH, consensus=pb.RaftMessage(
            type=pb.MSG_APPEND, sender=1, to=2, term=3, prev_log_index=4,
            prev_log_term=3, leader_commit=4, entries=[
                pb.Entry(index=5, term=3, data=b"N" + bytes(range(256)))]))
        frames[pkg] = _enc(req)
    assert frames["port"] == frames["jax"]
    sub = {pkg: _enc(PKG[pkg].pb.StepRequest(
        channel=CH, submit=PKG[pkg].pb.SubmitRequest(
            channel=CH, envelope=b"env", is_config=True, config_seq=2)))
        for pkg in ("jax", "port")}
    assert sub["port"] == sub["jax"]


# -- the chain -------------------------------------------------------------------------


def _genesis(pkg: str):
    p = PKG[pkg]
    raw = pu.new_block(0, b"")
    raw.data.data.append(b"genesis-config")
    raw.header.data_hash = pu.block_data_hash(raw.data)
    return p.block(raw.encode())


def _mk_chain(pkg, nid, transport, root, consenters, store=None, **kw):
    p = PKG[pkg]
    if store is None:
        store = p.Store(None, name=f"orderer{nid}")
        store.add_block(_genesis(pkg))
    delivered = []
    chain = p.raft.RaftChain(
        CH, nid, consenters, p.Cutter(max_message_count=2),
        p.Writer(store), transport, wal_dir=str(root / f"wal{nid}"),
        batch_timeout_s=0.2, tick_interval_s=0.01,
        on_block=delivered.append, **kw)
    transport.register(nid, chain.handle_step)
    return chain, store, delivered


def _chains(pkg, root, ids=(1, 2, 3), **kw):
    p = PKG[pkg]
    transport = p.raft.InProcTransport()
    consenters = [p.pb.Consenter(id=i) for i in ids]
    chains = {nid: _mk_chain(pkg, nid, transport, root, consenters, **kw)
              for nid in ids}
    for c, _, _ in chains.values():
        c.start()
    return transport, chains


def _halt(chains):
    for c, _, _ in chains.values():
        if not c._halted.is_set():
            c.halt()


def _leader(chains, among=None):
    ids = among or list(chains)
    assert _wait(lambda: any(chains[n][0].is_leader for n in ids))
    return next(n for n in ids if chains[n][0].is_leader)


def _blocks(pkg, store, start=1):
    """(number, previous hash, data hash, data, last config) of each
    block."""
    out = []
    for n in range(start, store.height):
        blk = store.get_block_by_number(n)
        raw = blk.metadata.metadata[cb.SIGNATURES]
        meta = cb.Metadata.decode(raw)
        last = cb.OrdererBlockMetadata.decode(meta.value).last_config.index
        out.append((blk.header.number, bytes(blk.header.previous_hash),
                    bytes(blk.header.data_hash),
                    [bytes(d) for d in blk.data.data], last))
    return out


def _env(pkg, data: bytes):
    return PKG[pkg].env(data)


def test_clusters_order_equal_blocks_through_a_failover(tmp_path):
    views = {}
    for pkg in ("jax", "port"):
        _, chains = _chains(pkg, tmp_path / pkg)
        try:
            lead = _leader(chains)
            for i in range(4):
                chains[lead][0].order(_env(pkg, b"tx-%d" % i))
            assert _wait(lambda: all(s.height == 3
                                     for _, s, _ in chains.values()))
            chains[lead][0].halt()
            rest = [n for n in chains if n != lead]
            new = _leader(chains, rest)
            assert new != lead
            for i in range(4, 8):
                chains[new][0].order(_env(pkg, b"tx-%d" % i))
            assert _wait(lambda: all(chains[n][1].height == 5 for n in rest))
            got = [_blocks(pkg, chains[n][1]) for n in rest]
            assert got[0] == got[1]
            views[pkg] = got[0]
        finally:
            _halt(chains)
    assert views["port"] == views["jax"]
    assert [b[3] for b in views["port"]] == [
        [_enc(_env("port", b"tx-%d" % i)) for i in (j, j + 1)]
        for j in range(0, 8, 2)]


def test_a_consenter_added_then_removed(tmp_path):
    seen = {}
    for pkg in ("jax", "port"):
        pb = PKG[pkg].pb
        transport, chains = _chains(pkg, tmp_path / pkg)
        try:
            lead = _leader(chains)
            c = chains[lead][0]
            c.propose_conf_change(pb.ConfChange(
                action=pb.ConfChange.ADD_NODE,
                consenter=pb.Consenter(id=4, host="127.0.0.1", port=7054)))
            assert _wait(lambda: all(4 in x.consenters
                                     for x, _, _ in chains.values()))
            added = {n: sorted(x.node.voters) for n, (x, _, _)
                     in chains.items()}
            # four voters, three alive: quorum 3 still orders
            c.order(_env(pkg, b"a"))
            c.order(_env(pkg, b"b"))
            assert _wait(lambda: all(s.height == 2
                                     for _, s, _ in chains.values()))
            c.propose_conf_change(pb.ConfChange(
                action=pb.ConfChange.REMOVE_NODE,
                consenter=pb.Consenter(id=4)))
            assert _wait(lambda: all(4 not in x.consenters
                                     for x, _, _ in chains.values()))
            seen[pkg] = (added, _enc(chains[1][0].consenters.get(1)),
                         {n: sorted(x.node.voters)
                          for n, (x, _, _) in chains.items()},
                         _blocks(pkg, chains[1][1]))
        finally:
            _halt(chains)
    assert seen["port"] == seen["jax"]
    assert seen["port"][0] == {n: [1, 2, 3, 4] for n in (1, 2, 3)}


def test_eviction_demotes_a_node(tmp_path):
    outcome = {}
    for pkg in ("jax", "port"):
        pb = PKG[pkg].pb
        evicted = threading.Event()
        partitioned = threading.Event()
        holder = {}

        def probe():
            if partitioned.is_set():
                return None
            return set(holder["chains"][1][0].consenters)

        p = PKG[pkg]
        transport = p.raft.InProcTransport()
        consenters = [pb.Consenter(id=i) for i in (1, 2, 3)]
        chains = {}
        for nid in (1, 2, 3):
            kw = (dict(eviction_suspicion_ticks=10,
                       active_consenters_probe=probe,
                       on_eviction=evicted.set) if nid == 3 else {})
            chains[nid] = _mk_chain(pkg, nid, transport, tmp_path / pkg,
                                    consenters, **kw)
        holder["chains"] = chains
        for c, _, _ in chains.values():
            c.start()
        try:
            lead = _leader(chains)
            partitioned.set()
            transport.partition(3, 1)
            transport.partition(3, 2)
            if lead == 3:
                lead = _leader(chains, [1, 2])
            chains[lead][0].propose_conf_change(pb.ConfChange(
                action=pb.ConfChange.REMOVE_NODE,
                consenter=pb.Consenter(id=3)))
            assert _wait(lambda: 3 not in chains[lead][0].consenters)
            transport.heal()
            partitioned.clear()
            assert evicted.wait(10.0)
            h0 = chains[1][1].height
            chains[lead][0].order(_env(pkg, b"after-eviction"))
            chains[lead][0].order(_env(pkg, b"after-eviction-2"))
            assert _wait(lambda: chains[1][1].height > h0)
            outcome[pkg] = (chains[3][0].evicted.is_set(),
                            chains[3][0]._halted.is_set(),
                            sorted(chains[lead][0].consenters))
        finally:
            _halt(chains)
    assert outcome["port"] == outcome["jax"] == (True, True, [1, 2])


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax"),
                                           ("port", "port")])
def test_restart_replays_the_other_packages_wal(tmp_path, writer, reader):
    """A single node orders a block and halts; a chain of the reader's
    package over the same WAL and a store holding only the genesis block
    replays the block, equal to the writer's, and orders on."""
    pw, pr = PKG[writer], PKG[reader]
    transport = pw.raft.InProcTransport()
    chain, store, _ = _mk_chain(writer, 1, transport, tmp_path,
                                [pw.pb.Consenter(id=1)])
    chain.start()
    chain.order(_env(writer, b"a"))
    chain.order(_env(writer, b"b"))
    assert _wait(lambda: store.height == 2)
    chain.halt()
    hs = (chain.node.term, chain.node.voted_for, chain.node.commit)
    transport2 = pr.raft.InProcTransport()
    chain2, store2, _ = _mk_chain(reader, 1, transport2, tmp_path,
                                  [pr.pb.Consenter(id=1)])
    assert (chain2.node.term, chain2.node.voted_for,
            chain2.node.commit) == hs
    chain2.start()
    try:
        assert _wait(lambda: store2.height == 2)
        assert _enc(store2.get_block_by_number(1)) == \
            _enc(store.get_block_by_number(1))
        chain2.order(_env(reader, b"c"))
        chain2.order(_env(reader, b"d"))
        assert _wait(lambda: store2.height == 3)
        assert store2.get_block_by_number(2).header.previous_hash == \
            pu.block_header_hash(cb.Block.decode(
                _enc(store2.get_block_by_number(1))).header)
    finally:
        chain2.halt()


def test_ready_persist_crash_contract(tmp_path):
    """A Ready that was never saved is lost on restart, in both packages;
    the entries of a saved one replay as committed."""
    out = {}
    for pkg in ("jax", "port"):
        p = PKG[pkg]
        path = str(tmp_path / pkg)
        w = p.raft.WAL(path)
        n = p.core.RaftNode(1, {1}, rng=random.Random(5))
        while not n.is_leader:
            n.tick()
        rd = n.ready()
        w.save(rd.hard_state, rd.persist_entries)
        assert n.propose(b"E1") and n.propose(b"E2")
        rd = n.ready()
        w.save(rd.hard_state, rd.persist_entries)
        assert n.propose(b"E3")
        n.ready()  # never saved: the crash
        w.close()
        w2 = p.raft.WAL(path)
        hs, log, _ = w2.load()
        n2 = p.core.RaftNode(1, {1}, log=log, term=hs.term,
                             voted_for=hs.voted_for, commit=hs.commit,
                             rng=random.Random(5))
        while not n2.is_leader:
            n2.tick()
        datas = [e.data for e in n2.ready().committed if e.data]
        w2.close()
        assert b"E1" in datas and b"E2" in datas and b"E3" not in datas
        out[pkg] = ((tmp_path / pkg / "raft.wal").read_bytes(), datas)
    assert out["port"] == out["jax"]


def test_chain_crash_between_apply_and_next_ready_is_idempotent(tmp_path):
    heights = {}
    for pkg in ("jax", "port"):
        p = PKG[pkg]
        root = tmp_path / pkg
        transport = p.raft.InProcTransport()
        consenters = [p.pb.Consenter(id=1)]
        chain, store, _ = _mk_chain(pkg, 1, transport, root, consenters)
        chain.start()
        try:
            assert _wait(lambda: chain.is_leader)
            for i in range(4):
                chain.order(_env(pkg, b"tx-%d" % i))
            assert _wait(lambda: store.height == 3)
        finally:
            chain.halt()
        chain2, _, _ = _mk_chain(pkg, 1, p.raft.InProcTransport(), root,
                                 consenters, store=store)
        chain2.start()
        try:
            assert _wait(lambda: chain2.is_leader)
            assert store.height == 3
            chain2.order(_env(pkg, b"post-restart"))
            chain2.order(_env(pkg, b"post-restart-2"))
            assert _wait(lambda: store.height == 4)
        finally:
            chain2.halt()
        heights[pkg] = _blocks(pkg, store)
    assert heights["port"] == heights["jax"]
    assert [b[0] for b in heights["port"]] == [1, 2, 3]


def _entry(pkg, index, marker, blk_raw: bytes):
    return PKG[pkg].pb.Entry(index=index, term=2, data=marker + blk_raw)


def test_a_stale_leaders_non_chaining_block_is_dropped(tmp_path):
    """The reference's case: raft commits the old leader's block 1, then
    the new leader's block 1 (its creator anchored on the stale tail) and
    its block 2 on it.  Every replica writes the first block 1, skips the
    second as written, and drops the block 2 that does not chain."""
    g = _genesis("port")
    gh = pu.block_header_hash(g.header)

    def block(num, prev, data):
        blk = pu.new_block(num, prev)
        blk.data.data.append(data)
        blk.header.data_hash = pu.block_data_hash(blk.data)
        return blk

    b1 = block(1, gh, b"old-leader")
    b1x = block(1, gh, b"new-leader")
    b2x = block(2, pu.block_header_hash(b1x.header), b"new-leader-2")
    b2 = block(2, pu.block_header_hash(b1.header), b"resubmitted")
    seen = {}
    for pkg in ("jax", "port"):
        p = PKG[pkg]
        chain, store, delivered = _mk_chain(
            pkg, 1, p.raft.InProcTransport(), tmp_path / pkg,
            [p.pb.Consenter(id=1)])
        for k, blk in enumerate((b1, b1x, b2x, b2)):
            chain._apply(_entry(pkg, 3 + k, b"N", blk.encode()))
        seen[pkg] = (_blocks(pkg, store), len(delivered))
        chain._wal.close()  # the loop never started
    assert seen["port"] == seen["jax"]
    assert [v[3] for v in seen["port"][0]] == [[b"old-leader"],
                                               [b"resubmitted"]]


def test_a_node_behind_the_compaction_point_stays_behind(tmp_path):
    """Snapshots after every block (a 1-byte interval): node 3 halts after
    block 1, the others order blocks 2-3 and compact past its log; node 3
    restarts from its WAL and store, receives a snapshot and, with no
    block puller (the registrar passes none), writes no block: its height
    stays 2 while the others reach 5, in both packages (ROADMAP Queue C)."""
    out = {}
    for pkg in ("jax", "port"):
        p = PKG[pkg]
        root = tmp_path / pkg
        transport, chains = _chains(pkg, root, snapshot_interval_size=1)
        try:
            lead = _leader(chains)
            chains[lead][0].order(_env(pkg, b"a"))
            chains[lead][0].order(_env(pkg, b"b"))
            assert _wait(lambda: all(s.height == 2
                                     for _, s, _ in chains.values()))
            chains[3][0].halt()
            transport.unregister(3)
            if lead == 3:
                lead = _leader(chains, [1, 2])
            for i in range(2, 8):
                chains[lead][0].order(_env(pkg, b"x%d" % i))
            assert _wait(lambda: all(chains[n][1].height >= 4
                                     for n in (1, 2)))
            h3 = chains[3][1].height
            consenters = [p.pb.Consenter(id=i) for i in (1, 2, 3)]
            c3, s3, _ = _mk_chain(pkg, 3, transport, root, consenters,
                                  store=chains[3][1],
                                  snapshot_interval_size=1)
            chains[3] = (c3, s3, [])
            c3.start()
            assert _wait(lambda: c3.node.commit >= chains[lead][0].node.log
                         .snap_index)
            chains[lead][0].order(_env(pkg, b"late-1"))
            chains[lead][0].order(_env(pkg, b"late-2"))
            assert _wait(lambda: all(chains[n][1].height >= 5
                                     for n in (1, 2)))
            time.sleep(0.2)
            out[pkg] = (h3, s3.height, chains[1][1].height)
        finally:
            _halt(chains)
    assert out["port"] == out["jax"]
    h3, after, others = out["port"]
    assert after == h3 < others


# -- the registrar ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def world():
    w = chip_smoke.validator_world(37)
    pair = w.orderer_ca.issue("orderer0", ous=["orderer"])
    signer = types.SimpleNamespace(
        port=PortSigner("OrdererMSP", pair.cert, pair.key, w.rng),
        jax=JaxSigner.from_pem("OrdererMSP", pair.cert_pem, pair.key_pem,
                               SWCSP()))
    blocks, _, _ = chip_smoke.validator_blocks(w, 2, 6, b"", plant=False)
    envs = [e for raw in blocks for e in cb.Block.decode(raw).data.data]
    return types.SimpleNamespace(w=w, signer=signer, envs=envs)


def _raft_genesis(world, consenters=((1, 7050),), tick_ms=10) -> bytes:
    meta = ob.ConfigMetadata(
        consenters=[ob.Consenter(id=i, host="127.0.0.1", port=port)
                    for i, port in consenters],
        options=ob.Options(tick_interval_ms=tick_ms, election_tick=10,
                           heartbeat_tick=1, max_inflight_blocks=5,
                           snapshot_interval_size=16 << 20))
    return chip_smoke.order_genesis(
        world.w, max_message_count=4, preferred_max_bytes=1 << 20,
        absolute_max_bytes=6000, batch_timeout="60s",
        consensus_type="etcdraft", consensus_metadata=meta.encode())


def _registrar(pkg, root, genesis: bytes, world):
    p = PKG[pkg]
    router = p.Router(p.raft.InProcTransport())
    reg = p.Registrar(str(root), p.csp(), signer=getattr(world.signer, pkg),
                      node_id=1, transport=router)
    router.register(1, None)
    reg.startup([p.block(genesis)])
    return reg


def _reg_view(reg, start=1):
    store = reg.get_chain(chip_smoke.VALIDATOR_CHANNEL).store
    out = []
    for n in range(start, store.height):
        blk = store.get_block_by_number(n)
        meta = cb.Metadata.decode(blk.metadata.metadata[cb.SIGNATURES])
        out.append((blk.header.number, bytes(blk.header.previous_hash),
                    bytes(blk.header.data_hash),
                    [bytes(d) for d in blk.data.data],
                    cb.OrdererBlockMetadata.decode(meta.value)
                    .last_config.index))
    return out


def _order(pkg, reg, envs, height):
    cs = reg.get_chain(chip_smoke.VALIDATOR_CHANNEL)
    assert _wait(lambda: cs.chain.is_leader)
    for raw in envs:
        cs.chain.order(common_pb2.Envelope.FromString(raw) if pkg == "jax"
                       else cb.Envelope.decode(raw))
    assert _wait(lambda: cs.store.height == height)


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_registrar_resumes_on_the_other_packages_root(world, tmp_path,
                                                      writer, reader):
    genesis = _raft_genesis(world)
    root = tmp_path / "root"
    reg = _registrar(writer, root, genesis, world)
    try:
        _order(writer, reg, world.envs[:8], 3)
        node = reg.get_chain(chip_smoke.VALIDATOR_CHANNEL).chain.node
    finally:
        reg.halt_all()
    state = (node.term, node.voted_for, node.commit)
    wrote = _reg_view(reg)
    assert os.path.exists(root / "raft" / chip_smoke.VALIDATOR_CHANNEL /
                          "raft.wal")
    reg2 = _registrar(reader, root, genesis, world)
    try:
        chain = reg2.get_chain(chip_smoke.VALIDATOR_CHANNEL).chain
        assert (chain.node.term, chain.node.voted_for,
                chain.node.commit) == state
        assert _reg_view(reg2) == wrote
        _order(reader, reg2, world.envs[8:12], 4)
        view = _reg_view(reg2)
        assert view[:2] == wrote
        assert view[2][1] == pu.block_header_hash(
            reg2.get_chain(chip_smoke.VALIDATOR_CHANNEL).store
            .get_block_by_number(2).header)
        assert view[2][3] == world.envs[8:12]
    finally:
        reg2.halt_all()


def test_single_node_etcdraft_channels_order_the_same_blocks(world,
                                                             tmp_path):
    """Equal block data, headers and last-config indices; each package's
    block signatures verify under the other's check."""
    views, regs = {}, {}
    for pkg in ("jax", "port"):
        reg = regs[pkg] = _registrar(pkg, tmp_path / pkg,
                                     _raft_genesis(world), world)
        try:
            _order(pkg, reg, world.envs[:8], 3)
            views[pkg] = _reg_view(reg)
        finally:
            reg.halt_all()
    assert views["port"] == views["jax"]
    assert [v[3] for v in views["port"]] == [world.envs[:4],
                                             world.envs[4:8]]
    verify = {"jax": jax_verify, "port": port_verify}
    for signer, checker in (("jax", "port"), ("port", "jax")):
        store = regs[signer].get_chain(chip_smoke.VALIDATOR_CHANNEL).store
        policy = regs[checker].get_chain(chip_smoke.VALIDATOR_CHANNEL) \
            .bundle.policy_manager.get_policy(
                "/Channel/Orderer/BlockValidation")
        for n in (1, 2):
            blk = PKG[checker].block(_enc(store.get_block_by_number(n)))
            assert verify[checker](blk, policy, PKG[checker].csp())


# -- a mixed cluster: two JAX nodes and one port node -------------------------------


def test_a_mixed_cluster_orders_the_same_blocks(world, tmp_path, tls_ca):
    """Orderers 1 and 2 run the JAX package, orderer 3 the port, each a
    Registrar with a TCPTransport over loopback mutual TLS pinned to the
    three consenters' certificates; the channel's blocks are equal on
    all three, whoever leads."""
    pkgs = {1: "jax", 2: "jax", 3: "port"}
    creds = {i: _creds(pkgs[i], tls_ca, f"orderer{i}") for i in pkgs}
    pinned = [c.cert_der for c in creds.values()]
    transports = {}
    for i, pkg in pkgs.items():
        creds[i].pinned_certs = list(pinned)
        transports[i] = PKG[pkg].transport.TCPTransport(
            i, ("127.0.0.1", 0), tls=creds[i])
    genesis = _raft_genesis(world, [(i, transports[i].addr[1])
                                    for i in pkgs], tick_ms=20)
    regs = {}
    try:
        for i, pkg in pkgs.items():
            p = PKG[pkg]
            router = p.Router(transports[i])
            for j in pkgs:
                if j != i:
                    router.set_peer(j, transports[j].addr)
            regs[i] = p.Registrar(str(tmp_path / f"o{i}"), p.csp(),
                                  signer=getattr(world.signer, pkg),
                                  node_id=i, transport=router)
            regs[i].startup([p.block(genesis)])
        chains = {i: r.get_chain(chip_smoke.VALIDATOR_CHANNEL)
                  for i, r in regs.items()}
        assert _wait(lambda: any(c.chain.is_leader
                                 for c in chains.values()), 20)
        # broadcast to the port node: it forwards to a JAX leader, or leads
        for raw in world.envs[:8]:
            chains[3].chain.order(cb.Envelope.decode(raw))
        assert _wait(lambda: all(c.store.height == 3
                                 for c in chains.values()), 20)
        views = [_reg_view(r) for r in regs.values()]
        assert views[0] == views[1] == views[2]
        assert [v[3] for v in views[2]] == [world.envs[:4], world.envs[4:8]]
    finally:
        for r in regs.values():
            r.halt_all()
        for t in transports.values():
            t.close()
