"""The port's fault seams that only a pinned chaos plan arms, each armed
here in the port and in the JAX package alike.

The port's fabriclint (`chaos-coverage`) counts a seam as armable when
the canned campaign reaches it or a literal plan rule in the tree names
it; the JAX package's own chaos tests pin these, and the port's pin them
here, so that the port's `faultmap_registry.json` is the JAX package's
point for point.  Each test drives the same plan through both packages'
code and holds the trips and what the code did after them equal:

- the block store's recovery truncation skipped, and a crash at each
  segment lifecycle point, recovered alike;
- the sharded store's roll-forward skipped on reopen, then done;
- the validator's per-transaction collect seam raising and delaying;
- the deliver client's read faults and reconnect episodes;
- gossip's dial and link faults, raft's dial gate and link flap, over
  TCP;
- netsplit's deny and cut seams;
- the state provider's payload seam, which refuses a block.
"""

from __future__ import annotations

import os
import random
import socket
import struct
import threading
import time

import pytest

import chip_smoke
from fabric_tpu import protoutil as jax_pu
from fabric_tpu.devtools import faultline as jax_fl
from fabric_tpu.devtools import netsplit as jax_ns
from fabric_tpu.gossip import comm as jax_gcomm
from fabric_tpu.gossip import state as jax_state
from fabric_tpu.ledger import blkstorage as jax_blk
from fabric_tpu.ledger import kvstore as jax_kv
from fabric_tpu.orderer.raft import transport as jax_tr
from fabric_tpu.peer import deliverclient as jax_dc
from fabric_tpu.protos.common import common_pb2
from fabric_tpu.protos.gossip import message_pb2 as jax_gpb
from fabric_tpu.protos.orderer import raft_pb2 as jax_rpb
from fabric_tpu_torch import protoutil as port_pu
from fabric_tpu_torch.common import workpool
from fabric_tpu_torch.devtools import faultline as port_fl
from fabric_tpu_torch.devtools import lockwatch as port_lw
from fabric_tpu_torch.devtools import netsplit as port_ns
from fabric_tpu_torch.gossip import comm as port_gcomm
from fabric_tpu_torch.gossip import state as port_state
from fabric_tpu_torch.ledger import blkstorage as port_blk
from fabric_tpu_torch.ledger import kvstore as port_kv
from fabric_tpu_torch.orderer.raft import transport as port_tr
from fabric_tpu_torch.peer import deliverclient as port_dc
from fabric_tpu_torch.protos import common as cb
from fabric_tpu_torch.protos import gossip as port_gpb
from fabric_tpu_torch.protos import orderer as port_ob

PKGS = ("jax", "port")
FL = {"jax": jax_fl, "port": port_fl}


@pytest.fixture(scope="module", autouse=True)
def _port_watch_gate():
    """The port's lockwatch ledgers are empty and its workers drained at
    the end of this file."""
    yield
    workpool.shutdown()
    assert not port_lw.drain_threads(timeout=15.0)
    assert not port_lw.violations and not port_lw.thread_violations


def _points(fl) -> list:
    return [t["point"] for t in fl.trips() if t["plan"] != "soak"]


# -- the block store ---------------------------------------------------------


def _chain(n: int, payload: int) -> list:
    """n chained blocks of one `payload`-byte envelope, as JAX blocks."""
    out, prev = [], b""
    for num in range(n):
        blk = common_pb2.Block()
        blk.header.number = num
        blk.header.previous_hash = prev
        blk.data.data.append(bytes([num % 251]) * payload)
        blk.header.data_hash = jax_pu.block_data_hash(blk.data)
        jax_pu.init_block_metadata(blk)
        prev = jax_pu.block_header_hash(blk.header)
        out.append(blk)
    return out


def _store(pkg, d, kv, segment):
    mod = jax_blk if pkg == "jax" else port_blk
    return mod.BlockStore(str(d), kv, name="ch", segment=segment)


def _block(pkg, blk):
    return blk if pkg == "jax" else cb.Block.decode(blk.SerializeToString())


def _kv(pkg, path):
    return (jax_kv if pkg == "jax" else port_kv).SqliteKVStore(str(path))


def test_a_skipped_recovery_truncation_leaves_the_torn_tail(tmp_path):
    """A torn record past the last block: with the guard skipped the
    reopened store keeps the bytes but ignores them, and its next block
    overwrites them from the checkpoint; both packages alike."""
    blocks = _chain(4, 300)
    got = {}
    for pkg in PKGS:
        d, kv = tmp_path / pkg, _kv(pkg, tmp_path / f"{pkg}.sqlite")
        s = _store(pkg, d, kv, 1 << 16)
        for blk in blocks[:3]:
            s.add_block(_block(pkg, blk))
        s.close()
        path = d / sorted(os.listdir(d))[-1]
        data = path.read_bytes()
        end = len(data.rstrip(b"\x00"))
        with open(path, "r+b") as f:  # a torn header: promises 500 bytes
            f.seek(end)
            f.write(struct.pack(">I", 500) + b"GARBAGE")
        with FL[pkg].use_plan({"seed": 1, "faults": [
            {"point": "blkstorage.recovery_truncate", "action": "skip"},
        ]}):
            s = _store(pkg, d, kv, 1 << 16)
            trips = _points(FL[pkg])
        torn_kept = path.read_bytes()[end + 4:end + 11] == b"GARBAGE"
        height = s.height
        s.add_block(_block(pkg, blocks[3]))
        s.close()
        s = _store(pkg, d, kv, 1 << 16)
        got[pkg] = (trips, torn_kept, height, s.height,
                    s.get_block_by_number(3).header.number)
        s.close()
    assert got["port"] == got["jax"] == (
        ["blkstorage.recovery_truncate"], True, 3, 4, 3)


# literal plan rules: the pins that arm the two segment lifecycle seams
SEGMENT_LIFECYCLE_PLANS = [
    {"seed": 1, "faults": [
        {"point": "blkstorage.segment_prealloc", "action": "crash"},
    ]},
    {"seed": 1, "faults": [
        {"point": "blkstorage.segment_roll", "action": "crash"},
    ]},
]


@pytest.mark.parametrize(
    "plan", SEGMENT_LIFECYCLE_PLANS,
    ids=[p["faults"][0]["point"] for p in SEGMENT_LIFECYCLE_PLANS])
def test_a_crash_at_a_segment_lifecycle_point_recovers(tmp_path, plan):
    """A 4 KiB segment holds one ~3 KB record: the second block rolls.
    A crash while sealing the full segment or preallocating the next
    leaves the committed chain whole, and the block commits again."""
    blocks = _chain(2, 3000)
    got = {}
    for pkg in PKGS:
        d, kv = tmp_path / pkg, _kv(pkg, tmp_path / f"{pkg}.sqlite")
        s = _store(pkg, d, kv, 4096)
        s.add_block(_block(pkg, blocks[0]))
        with FL[pkg].use_plan(plan):
            with pytest.raises(FL[pkg].FaultCrash):
                s.add_block(_block(pkg, blocks[1]))
            trips = _points(FL[pkg])
        s.close()
        s = _store(pkg, d, kv, 4096)
        height = s.height
        s.add_block(_block(pkg, blocks[1]))
        got[pkg] = (trips, height, s.height, sorted(os.listdir(d)))
        s.close()
    assert got["port"] == got["jax"]
    assert got["port"][:3] == ([plan["faults"][0]["point"]], 1, 2)


# -- the sharded store ---------------------------------------------------------


def _state_key(ns: str, key: str) -> bytes:
    return b"statedb/ch\x00\xff\x02" + ns.encode() + b"\x00" + key.encode()


FIRST = {_state_key(ns, f"k{i}"): b"v%d" % i
         for ns in ("checking", "savings", "lscc") for i in range(3)}
SECOND = {_state_key(ns, f"k{i}"): b"w%d" % i
          for ns in ("checking", "savings") for i in (1, 3)}


def test_a_skipped_shard_roll_forward_is_done_at_the_next_reopen(
        tmp_path, monkeypatch):
    """A flush cut after the coordinator's transaction: the shards hold
    a pending epoch to roll forward.  A reopen with the guard skipped
    leaves it pending; the next reopen rolls it forward."""
    monkeypatch.setenv("FABRIC_TPU_STORE_POOL", "0")
    got = {}
    for pkg, mod in (("jax", jax_kv), ("port", port_kv)):
        fl = FL[pkg]
        root = str(tmp_path / pkg)
        store = mod.ShardedKVStore(root, shards=4)
        store.write_batch(FIRST)
        with fl.use_plan({"seed": 1, "faults": [{
                "point": "store.shard_flush", "action": "crash", "nth": 1,
                "ctx": {"stage": "apply"}}]}):
            with pytest.raises(fl.FaultCrash):
                store.write_batch(SECOND)
        store.close()
        with fl.use_plan({"seed": 1, "faults": [
            {"point": "store.shard_recover", "action": "skip",
             "count": 8},
        ]}):
            store = mod.ShardedKVStore(root)
            skipped = len(_points(fl))
        pending = sum(s.pending_epoch() is not None for s in store._stores)
        store.close()
        store = mod.ShardedKVStore(root)
        after = sum(s.pending_epoch() is not None for s in store._stores)
        values = [store.get(k) for k in sorted(SECOND)]
        store.close()
        got[pkg] = (skipped, pending, after, values)
    assert got["port"] == got["jax"]
    skipped, pending, after, values = got["port"]
    assert skipped == pending > 0 and after == 0
    assert values == [SECOND[k] for k in sorted(SECOND)]


# -- the validator's collect stage ---------------------------------------------


N_COLLECT = 36  # transactions: a block wide enough to fan out (32)


def test_the_collect_seam_raises_out_of_validate_and_a_delay_changes_nothing():
    """`collect.tx` is armed inside the port's collect stage: a raise
    rule's error comes out of `validate`, and a delay leaves the flags
    as they were."""
    from fabric_tpu_torch.common.channelconfig import bundle_from_genesis
    from fabric_tpu_torch.csp.cuda.provider import CUDACSP
    from fabric_tpu_torch.ledger.kvledger import LedgerProvider
    from fabric_tpu_torch.peer.txvalidator import TxValidator

    world = chip_smoke.validator_world(5)
    raw = chip_smoke.validator_blocks(world, 1, N_COLLECT,
                                      world.genesis_hash, plant=False)[0][0]
    ledger = LedgerProvider(None).create(cb.Block.decode(world.genesis))
    # the rwset decode fanned out over a pool of 3: the seam's place
    v = TxValidator(chip_smoke.VALIDATOR_CHANNEL, ledger,
                    bundle_from_genesis(world.genesis),
                    CUDACSP(device="cpu", min_device_batch=1 << 30),
                    collect_pool=workpool.default_pool(), collect_width=3)
    base = v.validate(cb.Block.decode(raw))
    with port_fl.use_plan({"seed": 5, "faults": [{
        "point": "collect.tx", "action": "raise", "error": "OSError",
        "message": "injected collect fault", "nth": 7,
    }]}):
        with pytest.raises(OSError, match="injected collect fault"):
            v.validate(cb.Block.decode(raw))
        assert "collect.tx" in _points(port_fl)
    with port_fl.use_plan({"seed": 6, "faults": [{
        "point": "collect.tx", "action": "delay", "delay_s": 0.0,
        "every": 3, "count": 50,
    }]}):
        assert v.validate(cb.Block.decode(raw)) == base
        assert _points(port_fl) == ["collect.tx"] * (N_COLLECT // 3)


# -- the deliver client --------------------------------------------------------


def test_deliver_read_faults_grow_the_backoff_and_reconnect_alike():
    """The first four reads die: the backoff grows to its cap across
    endpoint rotations, each reconnect episode trips once, and after a
    delivered block the backoff resets; both clients alike."""
    got = {}
    for pkg in PKGS:
        committed: list = []
        tried: list = []

        def endpoint(name, committed=committed, tried=tried, pkg=pkg):
            def connect(start):
                tried.append(name)
                for n in range(start, 3):
                    if pkg == "jax":
                        blk = common_pb2.Block()
                        blk.header.number = n
                    else:
                        blk = cb.Block(header=cb.BlockHeader(number=n))
                    yield blk
            return connect

        Client = (jax_dc if pkg == "jax" else port_dc).DeliverClient
        dc = Client("ch", [endpoint("a"), endpoint("b")],
                    height_fn=lambda c=committed: len(c),
                    sink=lambda seq, raw, c=committed: c.append(seq),
                    max_backoff_s=0.25)
        state = random.getstate()
        random.seed(3)
        try:
            with FL[pkg].use_plan({"faults": [
                {"point": "deliver.read", "action": "raise",
                 "error": "OSError", "every": 1, "count": 4},
                {"point": "deliver.reconnect", "action": "delay",
                 "delay_s": 0.0, "count": 10000},
            ]}):
                dc.start()
                deadline = time.monotonic() + 10
                while time.monotonic() < deadline and len(committed) < 3:
                    time.sleep(0.02)
                time.sleep(0.3)
                dc.stop()
                reconnects = _points(FL[pkg]).count("deliver.reconnect")
        finally:
            random.setstate(state)
        log = list(dc.backoff_log)
        got[pkg] = (committed, set(tried), reconnects >= 4, log[0],
                    max(log), 0.2 in log)
    assert got["port"] == got["jax"] == (
        [0, 1, 2], {"a", "b"}, True, 0.1, 0.25, True)


# -- gossip over TCP -----------------------------------------------------------


def _gossip_pair(pkg):
    comm = jax_gcomm if pkg == "jax" else port_gcomm
    recv = comm.TCPGossipComm(("127.0.0.1", 0), b"id-recv")
    send = comm.TCPGossipComm(("127.0.0.1", 0), b"id-send")
    return recv, send


def _alive(pkg, endpoint: str):
    if pkg == "jax":
        m = jax_gpb.GossipMessage()
        m.alive_msg.membership.endpoint = endpoint
        return m
    return port_gpb.GossipMessage(alive_msg=port_gpb.AliveMessage(
        membership=port_gpb.Member(endpoint=endpoint)))


def test_a_gossip_dial_fault_backs_off_and_recovers():
    for pkg in PKGS:
        recv, send = _gossip_pair(pkg)
        seen: list = []
        recv.subscribe(
            lambda rm, seen=seen: seen.append(
                rm.msg.alive_msg.membership.endpoint))
        try:
            with FL[pkg].use_plan({"faults": [
                {"point": "gossip.dial", "action": "raise",
                 "error": "ConnectionRefusedError", "nth": 1},
            ]}):
                send.send(recv.endpoint, _alive(pkg, "e0"))
                deadline = time.monotonic() + 10
                while time.monotonic() < deadline and not _points(FL[pkg]):
                    time.sleep(0.02)
                assert _points(FL[pkg]) == ["gossip.dial"], pkg
            deadline = time.monotonic() + 10
            n = 1
            while time.monotonic() < deadline and not seen:
                send.send(recv.endpoint, _alive(pkg, f"e{n}"))
                n += 1
                time.sleep(0.05)
            assert seen, pkg
        finally:
            send.close()
            recv.close()


def test_a_gossip_link_reset_mid_stream_reconnects():
    """The prefix wildcard arms both halves of the `gossip.conn` pair:
    the reset half trips, and the sender's reconnect restores delivery."""
    for pkg in PKGS:
        recv, send = _gossip_pair(pkg)
        seen: list = []
        recv.subscribe(
            lambda rm, seen=seen: seen.append(
                rm.msg.alive_msg.membership.endpoint))
        try:
            with FL[pkg].use_plan({"faults": [
                {"point": "gossip.conn.*", "action": "raise",
                 "error": "ECONNRESET", "nth": 2},
            ]}):
                deadline = time.monotonic() + 10
                n = 0
                while time.monotonic() < deadline and (
                        not _points(FL[pkg]) or len(seen) < 3):
                    send.send(recv.endpoint, _alive(pkg, f"e{n}"))
                    n += 1
                    time.sleep(0.05)
                tripped = [p for p in _points(FL[pkg])
                           if p.startswith("gossip.conn.")]
                assert tripped, f"{pkg}: the link was never reset"
            assert len(seen) >= 3, pkg
        finally:
            send.close()
            recv.close()


# -- raft over TCP -------------------------------------------------------------


def _step(pkg, n: int):
    if pkg == "jax":
        return jax_rpb.StepRequest(channel="ch", submit=jax_rpb.SubmitRequest(
            channel="ch", envelope=b"m%d" % n))
    return port_ob.StepRequest(channel="ch", submit=port_ob.SubmitRequest(
        channel="ch", envelope=b"m%d" % n))


def test_a_raft_link_flap_reconnects_and_delivers():
    """A reset on the outbound link (`raft.conn.*`, armed by prefix)
    drops what the flap swallowed, counted, and delivery resumes."""
    for pkg in PKGS:
        tr = jax_tr if pkg == "jax" else port_tr
        t1 = tr.TCPTransport(1, ("127.0.0.1", 0))
        t2 = tr.TCPTransport(2, ("127.0.0.1", 0))
        got: list = []
        t2.set_handler(lambda req, got=got: got.append(req.submit.envelope))
        t1.set_peer(2, t2.addr)
        try:
            with FL[pkg].use_plan({"faults": [
                {"point": "raft.conn.*", "action": "raise",
                 "error": "ECONNRESET", "nth": 3},
            ]}):
                deadline = time.monotonic() + 10
                sent = 0
                while time.monotonic() < deadline and len(got) < 9:
                    t1.send(1, 2, _step(pkg, sent))
                    sent += 1
                    time.sleep(0.05)
                assert "raft.conn.write" in _points(FL[pkg]), pkg
            assert len(got) >= 9, pkg
            with t1._lock:
                conn = t1._peers[2]
            assert conn.dropped >= 1, pkg
        finally:
            t1.close()
            t2.close()


def test_raft_dials_to_a_dead_peer_are_gated_by_the_backoff():
    """Fifty sends in a second to a dead peer dial a handful of times,
    one trip a dial, and the messages the gate discards are counted."""
    for pkg in PKGS:
        tr = jax_tr if pkg == "jax" else port_tr
        probe = socket.socket()
        probe.bind(("127.0.0.1", 0))
        dead = probe.getsockname()
        probe.close()
        with FL[pkg].use_plan({"faults": [
            {"point": "raft.connect", "action": "delay", "delay_s": 0.0,
             "count": 10000},
        ]}):
            conn = tr.OutboundConn(dead, peer_id=3)
            try:
                for n in range(50):
                    conn.send(b"m%d" % n)
                time.sleep(1.0)
                dials = _points(FL[pkg]).count("raft.connect")
                assert 1 <= dials < 15, (pkg, dials)
                assert conn.dropped > 0, pkg
            finally:
                conn.close()


# -- netsplit --------------------------------------------------------------------


def _split(node: str) -> dict:
    return {"seed": 3, "node": node, "mode": "full",
            "groups": [["a", "b"], ["c"]]}


def test_the_deny_seam_fires_inside_the_denial():
    got = {}
    for pkg, ns in (("jax", jax_ns), ("port", port_ns)):
        with FL[pkg].use_plan({"seed": 3, "label": "netsplit-deny-arm",
                               "faults": [{"point": "netsplit.deny",
                                           "action": "raise",
                                           "count": 1}]}):
            with ns.use_plan(_split("a")):
                with pytest.raises(FL[pkg].FaultInjected):
                    ns.connect("c")
            trips = FL[pkg].trips()
            got[pkg] = [(t["point"], t["ctx"]) for t in trips]
    assert got["port"] == got["jax"] == [
        ("netsplit.deny", {"src": "a", "dst": "c", "mode": "full"})]


def test_a_cut_seam_fault_does_not_save_the_connection():
    for pkg, ns in (("jax", jax_ns), ("port", port_ns)):
        ns.reset_log()
        sa, sb = socket.socketpair()
        try:
            tok = ns.track(sa, addr="c")
            with FL[pkg].use_plan({"seed": 3, "label": "netsplit-cut-arm",
                                   "faults": [{"point": "netsplit.cut",
                                               "action": "raise",
                                               "count": 1}]}):
                ns.activate(_split("a"))
                try:
                    assert sa.fileno() == -1, pkg
                    assert ns.cut_log(), pkg
                    assert _points(FL[pkg]) == ["netsplit.cut"], pkg
                finally:
                    ns.deactivate()
            ns.untrack(tok)
        finally:
            for s in (sa, sb):
                try:
                    s.close()
                except OSError:
                    pass


# -- the state provider ----------------------------------------------------------


class _Ledger:
    def __init__(self):
        self.blocks: list = []

    @property
    def height(self) -> int:
        return len(self.blocks)

    def store_block(self, blk) -> None:
        self.blocks.append(blk.header.number)


class _Gossip:
    def __init__(self):
        self.ledger_height = None
        self._on_block = None
        self.added: list = []

    def add_block(self, seq, raw) -> None:
        self.added.append(seq)


class _Comm:
    def subscribe(self, fn) -> None:
        self.handler = fn


def test_the_payload_seam_refuses_a_block_at_the_state_provider():
    """A raise at `gossip.state.payload` refuses the block before it is
    buffered: nothing commits; the next delivery of it commits."""
    got = {}
    for pkg in PKGS:
        if pkg == "jax":
            blk = common_pb2.Block()
            blk.header.number = 0
            raw = blk.SerializeToString()
            mod = jax_state
        else:
            raw = cb.Block(header=cb.BlockHeader(number=0)).encode()
            mod = port_state
        ledger, gossip = _Ledger(), _Gossip()
        sp = mod.StateProvider("ch", gossip, ledger, _Comm())
        with FL[pkg].use_plan({"seed": 1, "faults": [
            {"point": "gossip.state.payload", "action": "raise",
             "error": "RuntimeError", "nth": 1},
        ]}):
            with pytest.raises(RuntimeError):
                sp.add_payload(0, raw, from_orderer=True)
            refused = (list(ledger.blocks), list(gossip.added))
            sp.add_payload(0, raw, from_orderer=True)
            trips = _points(FL[pkg])
        got[pkg] = (refused, list(ledger.blocks), list(gossip.added), trips)
    assert got["port"] == got["jax"] == (
        ([], []), [0], [0], ["gossip.state.payload"])


def test_every_registry_seam_of_this_file_is_a_seam_of_both_trees():
    """The points pinned above are production seams of both packages
    (their names appear at a faultline call of each)."""
    here = open(__file__, encoding="utf-8").read()
    pinned = {"blkstorage.recovery_truncate", "blkstorage.segment_roll",
              "blkstorage.segment_prealloc", "store.shard_recover",
              "collect.tx", "deliver.read", "deliver.reconnect",
              "gossip.dial", "gossip.conn", "raft.conn", "raft.connect",
              "netsplit.deny", "netsplit.cut", "gossip.state.payload"}
    roots = {"jax": os.path.dirname(jax_fl.__file__).rsplit(os.sep, 1)[0],
             "port": os.path.dirname(port_fl.__file__).rsplit(os.sep, 1)[0]}
    for name in pinned:
        assert f'"{name}' in here, name
        for pkg, root in roots.items():
            found = False
            for dirpath, _, files in os.walk(root):
                for f in files:
                    if f.endswith(".py") and f'"{name}"' in open(
                            os.path.join(dirpath, f),
                            encoding="utf-8").read():
                        found = True
                        break
                if found:
                    break
            assert found, (pkg, name)
    assert threading.active_count() >= 1
