"""The port's ledger remainder against the JAX package's: the
namespace-sharded store (storage engine v2), the transient store,
chaincode event management and the offline admin tools.

The workload is SmallBank with real signatures (chip_smoke's 5-org
channel: a seed block of 40 accounts, then 2 blocks of 36 payments over
the `checking` and `savings` namespaces, which route to different shards
at widths 2 and 4), committed through each package's `Committer` into its
own on-disk ledger.  Flags, every KV pair and every sqlite file's rows
must be equal between the packages; the KV pairs, less the sharded
store's own two records, must be equal at widths 1, 2 and 4; each package
opens the other's sharded root; a flush cut between its phases reopens
to the same state in both; the admin tools leave the same heights, KV
pairs and block files.
"""

import logging
import os
import re
import shutil
import sqlite3
from pathlib import Path

import pytest

import chip_smoke
from fabric_tpu.common.channelconfig import bundle_from_genesis
from fabric_tpu.csp import SWCSP
from fabric_tpu.devtools import faultline as jax_faultline
from fabric_tpu.ledger import admin as jax_admin
from fabric_tpu.ledger import kvstore as jax_kvstore
from fabric_tpu.ledger.cceventmgmt import ChaincodeEventMgr as JaxEventMgr
from fabric_tpu.ledger.kvledger import LedgerProvider as JaxProvider
from fabric_tpu.ledger.transientstore import TransientStore as JaxTransient
from fabric_tpu.peer.committer import Committer as JaxCommitter
from fabric_tpu.peer.txvalidator import TxValidator as JaxValidator
from fabric_tpu.protos.common import common_pb2
from fabric_tpu_torch.common import workpool
from fabric_tpu_torch.common.channelconfig import (
    bundle_from_genesis as port_bundle_from_genesis,
)
from fabric_tpu_torch.csp.cuda.provider import CUDACSP
from fabric_tpu_torch.devtools import faultline
from fabric_tpu_torch.ledger import admin, kvstore
from fabric_tpu_torch.ledger.cceventmgmt import ChaincodeEventMgr
from fabric_tpu_torch.ledger.kvledger import LedgerProvider
from fabric_tpu_torch.ledger.transientstore import TransientStore
from fabric_tpu_torch.peer.committer import Committer
from fabric_tpu_torch.peer.txvalidator import TxValidator
from fabric_tpu_torch.protos import common as cb

CH = chip_smoke.VALIDATOR_CHANNEL
META = b"\x00storev2\x00"  # the sharded store's records (count, epoch)
TABLES = ("kv", "pending", "shardmeta")


class World:
    def __init__(self):
        self.world = chip_smoke.validator_world(9)
        self.genesis = self.world.genesis
        self.seed, self.blocks, _, self.flags = chip_smoke.smallbank_blocks(
            self.world, self.world.genesis_hash, n_accounts=40, n_txs=36,
            n_blocks=2)
        self.jax_bundle = bundle_from_genesis(
            common_pb2.Block.FromString(self.genesis), SWCSP())
        self.port_bundle = port_bundle_from_genesis(self.genesis)


@pytest.fixture(scope="module")
def world():
    yield World()
    workpool.shutdown()


def _commit_jax(w, root, n_blocks=None):
    provider = JaxProvider(str(root))
    ledger = provider.create(common_pb2.Block.FromString(w.genesis))
    committer = JaxCommitter(
        JaxValidator(CH, ledger, w.jax_bundle, SWCSP()), ledger)
    blocks = w.blocks[:n_blocks]
    flags = [committer.store_block(common_pb2.Block.FromString(w.seed))]
    flags += list(committer.store_stream(
        [common_pb2.Block.FromString(b) for b in blocks], depth=2))
    return provider, ledger, flags


def _commit_port(w, root, n_blocks=None):
    provider = LedgerProvider(str(root))
    ledger = provider.create(cb.Block.decode(w.genesis))
    committer = Committer(TxValidator(
        CH, ledger, w.port_bundle,
        CUDACSP(device="cpu", min_device_batch=1 << 30)), ledger)
    flags = [committer.store_block(w.seed)]
    flags += list(committer.store_stream(w.blocks[:n_blocks], depth=2))
    return provider, ledger, flags


def _rows(root) -> dict:
    """Every sqlite file's tables under `root`, row for row."""
    out = {}
    for path in sorted(Path(root).glob("*.sqlite")):
        with sqlite3.connect(path) as conn:
            names = {r[0] for r in conn.execute(
                "SELECT name FROM sqlite_master WHERE type = 'table'")}
            out[path.name] = {t: conn.execute(
                f"SELECT * FROM {t} ORDER BY 1").fetchall()
                for t in TABLES if t in names}
        conn.close()
    return out


def _chain_files(root) -> dict:
    chains = Path(root) / CH / "chains"
    return {p.name: p.read_bytes() for p in sorted(chains.iterdir())}


def _pairs(kv) -> list:
    return [(k, v) for k, v in kv.iterate() if not k.startswith(META)]


@pytest.fixture(scope="module")
def width1(world, tmp_path_factory):
    """The port's single-file ledger: the KV pairs every width must
    match."""
    os.environ.pop("FABRIC_TPU_STORE_SHARDS", None)
    provider, _, flags = _commit_port(world, tmp_path_factory.mktemp("w1"))
    assert isinstance(provider.kv, kvstore.SqliteKVStore)
    pairs = list(provider.kv.iterate())
    provider.close()
    return flags, pairs


# -- the sharded store --------------------------------------------------------


@pytest.mark.parametrize("shards,pool", [(1, "0"), (2, "0"), (4, "0"),
                                         (4, "3")],
                         ids=["w1", "w2", "w4", "w4-pool3"])
def test_sharded_commit_matches_the_reference(world, width1, tmp_path,
                                              monkeypatch, shards, pool):
    monkeypatch.setenv("FABRIC_TPU_STORE_SHARDS", str(shards))
    monkeypatch.setenv("FABRIC_TPU_STORE_POOL", pool)
    jp, jl, jflags = _commit_jax(world, tmp_path / "jax")
    pp, pl, pflags = _commit_port(world, tmp_path / "port")
    assert pflags == jflags == width1[0]
    assert pflags[1:] == world.flags
    sharded = shards > 1
    assert isinstance(pp.kv, kvstore.ShardedKVStore) == sharded
    assert isinstance(jp.kv, jax_kvstore.ShardedKVStore) == sharded
    assert list(pp.kv.iterate()) == list(jp.kv.iterate())
    assert _pairs(pp.kv) == width1[1]
    assert pl.height == jl.height == 4
    if sharded:
        assert pp.kv.shards == shards
        assert pl.commit_stage_seconds.keys() >= {
            "kv_prepare", "kv_commit", "kv_apply", "kv_shard0", "kv_shard1"}
    else:
        assert not any(k.startswith("kv_") and k != "kv_txn"
                       for k in pl.commit_stage_seconds)
    pp.close()
    jp.close()
    files = _rows(tmp_path / "port")
    assert sorted(files) == (["index.sqlite"] + [
        f"state_{i:02d}.sqlite" for i in range(shards)] if sharded
        else ["index.sqlite"])
    assert files == _rows(tmp_path / "jax")
    assert _chain_files(tmp_path / "port") == _chain_files(tmp_path / "jax")


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_each_package_opens_the_others_sharded_root(world, tmp_path,
                                                    monkeypatch, writer):
    monkeypatch.setenv("FABRIC_TPU_STORE_SHARDS", "4")
    root = tmp_path / writer
    commit = _commit_port if writer == "port" else _commit_jax
    provider, ledger, _ = commit(world, root)
    want = (ledger.height, list(provider.kv.iterate()))
    provider.close()
    # the other package reopens it with the knob unset: the layout on
    # disk decides
    monkeypatch.delenv("FABRIC_TPU_STORE_SHARDS")
    other = JaxProvider(str(root)) if writer == "port" else \
        LedgerProvider(str(root))
    reopened = other.open(CH)
    assert other.kv.shards == 4
    assert (reopened.height, list(other.kv.iterate())) == want
    assert reopened.get_state("checking", "acct0001") is not None
    other.close()


def test_the_persisted_width_wins_over_the_knob(world, tmp_path,
                                                monkeypatch):
    monkeypatch.setenv("FABRIC_TPU_STORE_SHARDS", "4")
    provider, ledger, _ = _commit_port(world, tmp_path, n_blocks=0)
    want = list(provider.kv.iterate())
    provider.close()
    for knob in ("2", "1", None):
        if knob is None:
            monkeypatch.delenv("FABRIC_TPU_STORE_SHARDS")
        else:
            monkeypatch.setenv("FABRIC_TPU_STORE_SHARDS", knob)
        for opener in (LedgerProvider, JaxProvider):
            p = opener(str(tmp_path))
            assert p.kv.shards == 4, (opener, knob)
            assert list(p.kv.iterate()) == want
            p.close()
    assert sorted(f for f in os.listdir(tmp_path) if f.endswith(".sqlite")) \
        == ["index.sqlite"] + [f"state_{i:02d}.sqlite" for i in range(4)]


def test_key_routing_and_the_knob_match_the_reference(monkeypatch):
    keys = [b"blkindex/ch\x00\xffn5", b"statedb/ch\x00\xff\x01",
            b"statedb/ch\x00\xff\x03idx", b"statedb/ch\x00\xff\x05meta",
            b"statedb/ch", b"statedb/ch\x00\xff\x02cc",
            b"statedb/ch\x00\xff\x02cc\x00key",
            b"statedb/ch\x00\xff\x02cc\x00pvt\x00col\x00k",
            b"statedb/ch\x00\xff\x02checking\x00acct0001",
            b"statedb/ch\x00\xff\x02savings\x00acct0001",
            b"historydb/ch\x00\xff\x02cc\x00k"]
    for n in (1, 2, 3, 4, 7, 64):
        assert [kvstore.state_shard(k, n) for k in keys] == \
            [jax_kvstore.state_shard(k, n) for k in keys]
        for ns in ("cc", "cc\x00pvt\x00col", "checking", "savings", "lscc",
                   "_lifecycle", ""):
            assert kvstore.shard_of_namespace(ns, n) == \
                jax_kvstore.shard_of_namespace(ns, n)
    assert kvstore.shard_of_namespace("cc\x00hash\x00col", 4) == \
        kvstore.shard_of_namespace("cc", 4)
    for raw in ("", "1", "2", "0", "-3", "65", "1000"):
        monkeypatch.setenv("FABRIC_TPU_STORE_SHARDS", raw)
        assert kvstore.store_shards() == jax_kvstore.store_shards()
    assert kvstore.store_shards(9) == jax_kvstore.store_shards(9) == 9
    monkeypatch.setenv("FABRIC_TPU_STORE_SHARDS", "nope")
    with pytest.raises(ValueError, match="not an integer shard count"):
        kvstore.store_shards()


def _state_key(ns: str, key: str) -> bytes:
    return b"statedb/ch\x00\xff\x02" + ns.encode() + b"\x00" + key.encode()


FIRST = {_state_key(ns, f"k{i}"): b"v%d" % i
         for ns in ("checking", "savings", "lscc", "_lifecycle")
         for i in range(3)}
FIRST[b"statedb/ch\x00\xff\x01"] = b"savepoint-1"
SECOND = {_state_key(ns, f"k{i}"): b"w%d" % i
          for ns in ("checking", "savings", "_lifecycle") for i in (1, 3)}
SECOND[b"statedb/ch\x00\xff\x01"] = b"savepoint-2"
SECOND_DELETES = [_state_key("lscc", "k0"), _state_key("checking", "k2")]


@pytest.mark.parametrize("stage,nth,forward", [
    ("prepare", 2, False), ("commit", 1, False), ("apply", 1, True),
    ("apply", 3, True)],
    ids=["prepare", "commit", "apply-first", "apply-third"])
def test_a_flush_cut_between_its_phases_reopens_as_the_reference(
        tmp_path, monkeypatch, stage, nth, forward):
    """A crash inside the two-phase flush: before the coordinator's
    transaction the reopen rolls the staged shards back, after it rolls
    them forward; each package reopens its own root and the other's to
    the same pairs."""
    monkeypatch.setenv("FABRIC_TPU_STORE_POOL", "0")
    plan = {"seed": 1, "faults": [{
        "point": "store.shard_flush", "action": "crash", "nth": nth,
        "ctx": {"stage": stage}}]}
    for name, mod, fl in (("port", kvstore, faultline),
                          ("jax", jax_kvstore, jax_faultline)):
        store = mod.ShardedKVStore(str(tmp_path / name), shards=4)
        store.write_batch(FIRST)
        with fl.use_plan(plan):
            with pytest.raises(fl.FaultCrash):
                store.write_batch(SECOND, SECOND_DELETES)
        store.close()
    pending = {name: [f for f, t in _rows(tmp_path / name).items()
                      if t.get("pending")] for name in ("port", "jax")}
    assert pending["port"] == pending["jax"] != []
    for name in ("port", "jax"):
        shutil.copytree(tmp_path / name, tmp_path / f"{name}-by-other")
    want = dict(FIRST)
    if forward:
        want.update(SECOND)
        for k in SECOND_DELETES:
            del want[k]
    got = {}
    for root, mod in (("port", kvstore), ("jax", jax_kvstore),
                      ("port-by-other", jax_kvstore),
                      ("jax-by-other", kvstore)):
        store = mod.ShardedKVStore(str(tmp_path / root))
        got[root] = [(k, v) for k, v in store.iterate()
                     if not k.startswith(META)]
        store.close()
        # recovery leaves no stage behind
        assert not any(t["pending"] or t["shardmeta"]
                       for f, t in _rows(tmp_path / root).items()
                       if f != "index.sqlite")
    assert got["port"] == got["jax"] == got["port-by-other"] == \
        got["jax-by-other"] == sorted(want.items())


def test_a_crashed_sharded_commit_recovers_as_the_reference(
        world, tmp_path, monkeypatch):
    """The ledger's view: block 3's group flush dies after the
    coordinator's transaction, before any shard applies; the reopened
    ledger holds block 3 with its state, in both packages."""
    monkeypatch.setenv("FABRIC_TPU_STORE_SHARDS", "4")
    monkeypatch.setenv("FABRIC_TPU_STORE_POOL", "0")
    plan = {"seed": 1, "faults": [{
        "point": "store.shard_flush", "action": "crash", "nth": 1,
        "ctx": {"stage": "apply"}}]}
    jp, _, _ = _commit_jax(world, tmp_path / "jax", n_blocks=1)
    pp, _, _ = _commit_port(world, tmp_path / "port", n_blocks=1)
    for fl, provider, block in (
            (jax_faultline, jp,
             common_pb2.Block.FromString(world.blocks[1])),
            (faultline, pp, cb.Block.decode(world.blocks[1]))):
        with fl.use_plan(plan):
            with pytest.raises(fl.FaultCrash):
                provider.open(CH).commit(block)
        provider.close()
    reopened = {}
    for name, opener in (("port", LedgerProvider), ("jax", JaxProvider)):
        p = opener(str(tmp_path / name))
        ledger = p.open(CH)
        reopened[name] = (ledger.height, list(p.kv.iterate()),
                          ledger.get_state("checking", "acct0000"))
        p.close()
    assert reopened["port"] == reopened["jax"]
    assert reopened["port"][0] == 4


# -- the transient store and chaincode events ---------------------------------


def _transient_ops(store):
    store.persist("tx1", 5, b"a")
    store.persist("tx1", 9, b"b")
    store.persist("tx2", 3, b"c")
    store.persist("tx3", 12, b"d")
    store.persist("tx\xe9", 7, b"e")
    out = [sorted(store.get_tx_pvt_rwsets("tx1")), store.min_height()]
    store.purge_by_txids(["tx2", "absent"])
    out += [store.get_tx_pvt_rwsets("tx2"), store.min_height()]
    store.purge_below_height(8)
    out += [sorted(store.get_tx_pvt_rwsets("tx1")),
            store.get_tx_pvt_rwsets("tx\xe9"), store.min_height()]
    store.purge_below_height(100)
    out.append(store.min_height())
    return out


@pytest.mark.parametrize("on_disk", [False, True], ids=["memory", "sqlite"])
def test_the_transient_store_matches_the_reference(tmp_path, on_disk):
    def kv(mod, name):
        return mod.open_kvstore(str(tmp_path / name / "t.sqlite")
                                if on_disk else None)

    jkv, pkv = kv(jax_kvstore, "jax"), kv(kvstore, "port")
    got = _transient_ops(TransientStore(pkv, "ch"))
    assert got == _transient_ops(JaxTransient(jkv, "ch"))
    assert got[0] == [(5, b"a"), (9, b"b")] and got[-1] is None
    # keys differ only in their uuid: the same (txid, height) prefixes
    TransientStore(pkv, "ch").persist("tx4", 1, b"x")
    JaxTransient(jkv, "ch").persist("tx4", 1, b"x")
    assert [(k[:-32], v) for k, v in pkv.iterate()] == \
        [(k[:-32], v) for k, v in jkv.iterate()]
    pkv.close()
    jkv.close()


class _Records(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def test_chaincode_events_match_the_reference():
    from fabric_tpu.common.flogging import must_get_logger as jax_logger
    from fabric_tpu_torch.common.flogging import must_get_logger

    seen = {"port": [], "jax": []}
    logged = {}

    def drive(mgr, out):
        mgr.register(None, lambda e: out.append(("all", e.channel_id,
                                                 e.name, e.version,
                                                 e.sequence)))
        mgr.register("ch1", lambda e: out.append(("ch1", e.name)))
        mgr.register("ch1", lambda e: 1 / 0)  # logged, never raised
        mgr.handle_definition_committed("ch1", "cc", "1.0", 3)
        mgr.handle_definition_committed("ch2", "cc2", "2.0", 1)
        mgr.handle_installed("ch1", "cc", "1.1")

    for name, mgr, get in (("port", ChaincodeEventMgr, must_get_logger),
                           ("jax", JaxEventMgr, jax_logger)):
        logger = get("ledger.cceventmgmt")
        handler = _Records()
        logger.addHandler(handler)
        try:
            drive(mgr(), seen[name])
        finally:
            logger.removeHandler(handler)
        logged[name] = [re.sub(r" at 0x[0-9a-f]+", "", m)
                        for m in handler.messages]
    assert seen["port"] == seen["jax"]
    assert seen["port"][:2] == [("all", "ch1", "cc", "1.0", 3),
                                ("ch1", "cc")]
    assert logged["port"] == logged["jax"]
    assert len(logged["port"]) == 2  # the two firings on ch1
    assert logged["port"][0].endswith("failed: division by zero")


# -- the admin tools ----------------------------------------------------------


@pytest.fixture
def chains(world, tmp_path, monkeypatch):
    """The same chain (genesis, SmallBank's seed and 2 blocks) committed
    by each package into its own root, single-file layout."""
    monkeypatch.delenv("FABRIC_TPU_STORE_SHARDS", raising=False)
    for name, commit in (("jax", _commit_jax), ("port", _commit_port)):
        provider, _, _ = commit(world, tmp_path / name)
        provider.close()
    return str(tmp_path / "jax"), str(tmp_path / "port")


def _index_pairs(mod, root) -> list:
    kv = mod.open_kvstore(os.path.join(root, "index.sqlite"))
    try:
        return list(kv.iterate())
    finally:
        kv.close()


def _reopened(root) -> tuple:
    """Height, state and blocks after the port's provider reopened the
    root (which replays what a repair dropped)."""
    provider = LedgerProvider(root)
    ledger = provider.open(CH)
    out = (ledger.height, list(provider.kv.iterate()), _chain_files(root))
    provider.close()
    return out


def _same_roots(jroot, proot):
    assert _index_pairs(kvstore, proot) == _index_pairs(jax_kvstore, jroot)
    assert _chain_files(proot) == _chain_files(jroot)


def test_admin_rebuild_dbs_matches_the_reference(chains):
    jroot, proot = chains
    before = _reopened(proot)
    assert admin.list_channels(proot) == jax_admin.list_channels(jroot) \
        == [CH]
    assert admin.rebuild_dbs(proot) == jax_admin.rebuild_dbs(jroot) == [CH]
    _same_roots(jroot, proot)
    assert not any(k.startswith(b"statedb/") or k.startswith(b"historydb/")
                   for k, _ in _index_pairs(kvstore, proot))
    assert admin.verify_rebuild(proot, CH) == \
        jax_admin.verify_rebuild(jroot, CH) == 4
    _same_roots(jroot, proot)
    assert _reopened(proot) == before


def test_admin_rollback_matches_the_reference(chains):
    jroot, proot = chains
    assert admin.rollback(proot, CH, 2) == \
        jax_admin.rollback(jroot, CH, 2) == 3
    _same_roots(jroot, proot)
    for bad in (3, 7):
        with pytest.raises(ValueError, match="target block"):
            admin.rollback(proot, CH, bad)
        with pytest.raises(ValueError, match="target block"):
            jax_admin.rollback(jroot, CH, bad)
    assert admin.verify_rebuild(proot, CH) == \
        jax_admin.verify_rebuild(jroot, CH) == 3
    _same_roots(jroot, proot)
    height, _, files = _reopened(proot)
    assert height == 3
    provider = LedgerProvider(proot)
    ledger = provider.open(CH)
    # the seed block (1) stays, the second payment block (3) is gone
    assert ledger.get_state("savings", "acct0000") is not None
    assert ledger.get_block_by_number(3) is None
    provider.close()


def test_admin_reset_matches_the_reference(chains):
    jroot, proot = chains
    assert admin.reset(proot) == jax_admin.reset(jroot) == {CH: 1}
    _same_roots(jroot, proot)
    assert admin.verify_rebuild(proot, CH) == \
        jax_admin.verify_rebuild(jroot, CH) == 1
    _same_roots(jroot, proot)
    # a second reset of a genesis-only chain keeps it
    assert admin.reset(proot) == jax_admin.reset(jroot) == {CH: 1}
    provider = LedgerProvider(proot)
    assert provider.open(CH).get_state("checking", "acct0000") is None
    provider.close()


def test_admin_pause_resume_and_upgrade_match_the_reference(chains):
    jroot, proot = chains
    for mod, root in ((admin, proot), (jax_admin, jroot)):
        mod.pause(root, "ch1")
        mod.pause(root, "ch2")
        assert mod.paused_channels(root) == {"ch1", "ch2"}
        mod.resume(root, "ch1")
        assert mod.paused_channels(root) == {"ch2"}
    _same_roots(jroot, proot)
    assert admin.upgrade_dbs(proot) == jax_admin.upgrade_dbs(jroot) == [CH]
    _same_roots(jroot, proot)
    assert admin.upgrade_dbs(proot) == jax_admin.upgrade_dbs(jroot) == []
    assert admin.DATA_FORMAT_VERSION == jax_admin.DATA_FORMAT_VERSION
    assert admin.verify_rebuild(proot, CH) == \
        jax_admin.verify_rebuild(jroot, CH) == 4
    _same_roots(jroot, proot)


# -- faults of the reference on the sharded layout, refused by the port ------


def test_a_single_file_root_with_state_is_not_mounted_sharded(tmp_path,
                                                              monkeypatch):
    """A fault of the reference the port refuses: a root written as one
    file and reopened under FABRIC_TPU_STORE_SHARDS > 1 mounts the
    sharded store over it in the JAX package, whose reads of state keys
    go to the (empty) shard files while the savepoint in the coordinator
    says the state is current.  The port raises, makes no shard file,
    and opens the root as before with the knob unset; a single-file root
    without state entries still mounts sharded."""
    key = b"statedb/ch\x00\xff\x02cc\x00key"
    save = b"statedb/ch\x00\xff\x01"
    for name, mod in (("port", kvstore), ("jax", jax_kvstore)):
        for sub, puts in (("state", {key: b"v", save: b"savepoint"}),
                          ("bare", {save: b"savepoint"})):
            monkeypatch.delenv("FABRIC_TPU_STORE_SHARDS", raising=False)
            kv = mod.open_store_root(str(tmp_path / name / sub))
            kv.write_batch(puts)
            kv.close()
    monkeypatch.setenv("FABRIC_TPU_STORE_SHARDS", "4")
    kv = jax_kvstore.open_store_root(str(tmp_path / "jax" / "state"))
    assert (type(kv).__name__, kv.get(key), kv.get(save)) == \
        ("ShardedKVStore", None, b"savepoint")
    kv.close()
    root = tmp_path / "port" / "state"
    with pytest.raises(ValueError, match="holds state in its single file"):
        kvstore.open_store_root(str(root))
    with pytest.raises(ValueError, match="holds state in its single file"):
        LedgerProvider(str(root))
    assert sorted(p.name for p in root.glob("*.sqlite")) == ["index.sqlite"]
    for name, mod in (("port", kvstore), ("jax", jax_kvstore)):
        kv = mod.open_store_root(str(tmp_path / name / "bare"))
        assert (type(kv).__name__, kv.shards, kv.get(save)) == \
            ("ShardedKVStore", 4, b"savepoint")
        kv.close()
    monkeypatch.delenv("FABRIC_TPU_STORE_SHARDS")
    kv = kvstore.open_store_root(str(root))
    assert isinstance(kv, kvstore.SqliteKVStore)
    assert (kv.get(key), kv.get(save)) == (b"v", b"savepoint")
    kv.close()


def test_admin_tools_refuse_a_sharded_root(world, tmp_path, monkeypatch):
    """A fault of the reference the port refuses: the admin tools open
    `index.sqlite` alone, so the JAX package's rollback of a sharded root
    wipes the coordinator's state records (the savepoint) but leaves the
    shard files' state entries; the replay on reopen rewrites the kept
    blocks' keys, and a key only the rolled-off blocks wrote survives.
    The port's rollback, reset and rebuild raise and leave the root as it
    was; pause and resume, which touch the coordinator alone, run."""
    w = world.world
    blocks, _, _ = chip_smoke.validator_blocks(w, 3, 8, w.genesis_hash,
                                               plant=False)
    monkeypatch.setenv("FABRIC_TPU_STORE_SHARDS", "4")
    roots = {"port": str(tmp_path / "port"), "jax": str(tmp_path / "jax")}
    provider = JaxProvider(roots["jax"])
    ledger = provider.create(common_pb2.Block.FromString(w.genesis))
    list(JaxCommitter(JaxValidator(CH, ledger, world.jax_bundle, SWCSP()),
                      ledger).store_stream(
        [common_pb2.Block.FromString(b) for b in blocks], depth=2))
    provider.close()
    provider = LedgerProvider(roots["port"])
    ledger = provider.create(cb.Block.decode(w.genesis))
    list(Committer(TxValidator(
        CH, ledger, world.port_bundle,
        CUDACSP(device="cpu", min_device_batch=1 << 30)),
        ledger).store_stream(blocks, depth=2))
    provider.close()
    monkeypatch.delenv("FABRIC_TPU_STORE_SHARDS")

    def seen(name, opener):
        p = opener(roots[name])
        ledger = p.open(CH)
        out = (ledger.height, ledger.get_state(
            chip_smoke.VALIDATOR_CC, "k0-0"), ledger.get_state(
            chip_smoke.VALIDATOR_CC, "k2-0"), list(p.kv.iterate()))
        p.close()
        return out

    before = seen("port", LedgerProvider)
    assert before[:3] == (4, b"v0", b"v0")
    assert jax_admin.rollback(roots["jax"], CH, 1) == 2
    # block 1 (k0-*) is kept; block 3's k2-0 is rolled off but still read
    assert seen("jax", JaxProvider)[:3] == (2, b"v0", b"v0")
    files = _chain_files(roots["port"])
    for op, call in (("rollback", lambda: admin.rollback(roots["port"], CH,
                                                          1)),
                     ("reset", lambda: admin.reset(roots["port"])),
                     ("rebuild-dbs", lambda: admin.rebuild_dbs(
                         roots["port"])),
                     ("rebuild-dbs", lambda: admin.upgrade_dbs(
                         roots["port"]))):
        with pytest.raises(ValueError, match=f"sharded root: {op} drops"):
            call()
    assert _chain_files(roots["port"]) == files
    assert seen("port", LedgerProvider) == before
    admin.pause(roots["port"], CH)
    assert admin.paused_channels(roots["port"]) == {CH}
    admin.resume(roots["port"], CH)
    assert admin.paused_channels(roots["port"]) == set()


@pytest.fixture(autouse=True, scope="module")
def _port_watch_gate():
    """The port's lockwatch ledgers are empty and its workers drained at
    the end of this file (the session's own gate watches the JAX
    package's module only)."""
    yield
    from fabric_tpu_torch.common import workpool as _pool
    from fabric_tpu_torch.devtools import lockwatch as _watch

    _pool.shutdown()
    assert not _watch.drain_threads(timeout=15.0)
    assert not _watch.violations and not _watch.thread_violations
