"""The port's ledger modules against the JAX package's, on seeded inputs.

- KV stores: a seeded sequence of puts, deletes, conditional inserts,
  prefix wipes, collector flushes and discards leaves equal `iterate()`
  output (and equal reads through the collector's buffer) in the JAX and
  port `SqliteKVStore`, `MemKVStore` and `WriteBatchCollector`.
- State DB: `Height` and value encodings, and `VersionedDB.apply_updates`
  on seeded batches, give equal KV pairs.
- MVCC: `MVCCValidator.validate_and_prepare` gives equal flags and batches
  on seeded rwsets (reads at right and stale versions, in-block
  read-after-write, range and phantom reads, metadata writes, deletes,
  hashed collection writes and private cleartext), block after block.
- Block store: the same blocks give equal file bytes, index pairs and
  readers, through segment rolls and commit groups; after a torn tail
  both recover to the same height and bytes.
"""

import random
import struct
from pathlib import Path

import pytest

from fabric_tpu import protoutil as jax_pu
from fabric_tpu.ledger import blkstorage as jax_blk
from fabric_tpu.ledger import history as jax_hist
from fabric_tpu.ledger import kvstore as jax_kv
from fabric_tpu.ledger import pvtdatastorage as jax_pvt
from fabric_tpu.ledger import statedb as jax_sdb
from fabric_tpu.ledger import txmgmt as jax_tx
from fabric_tpu.protos.common import common_pb2
from fabric_tpu.protos.ledger.rwset import rwset_pb2
from fabric_tpu.protos.ledger.rwset.kvrwset import kv_rwset_pb2
from fabric_tpu_torch import protoutil as port_pu
from fabric_tpu_torch.ledger import blkstorage as port_blk
from fabric_tpu_torch.ledger import history as port_hist
from fabric_tpu_torch.ledger import kvstore as port_kv
from fabric_tpu_torch.ledger import pvtdatastorage as port_pvt
from fabric_tpu_torch.ledger import statedb as port_sdb
from fabric_tpu_torch.ledger import txmgmt as port_tx
from fabric_tpu_torch.peer.validation_plugins import parse_footprint
from fabric_tpu_torch.protos import common as cb


# -- KV stores ----------------------------------------------------------------


def _rand_key(rng) -> bytes:
    # few distinct keys, with prefixes that collide and 0x00 / 0xff bytes
    return bytes(rng.choice([0x00, 0x01, 0x61, 0x62, 0xFF])
                 for _ in range(rng.randrange(1, 4)))


def _stores(kind, tmp_path):
    if kind == "mem":
        return jax_kv.MemKVStore(), port_kv.MemKVStore()
    return (jax_kv.SqliteKVStore(str(tmp_path / "jax.sqlite")),
            port_kv.SqliteKVStore(str(tmp_path / "port.sqlite")))


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("kind", ["sqlite", "mem"])
def test_kv_stores_and_collectors_equal_the_reference(kind, seed, tmp_path):
    rng = random.Random(seed)
    jbase, pbase = _stores(kind, tmp_path)
    jcol, pcol = (jax_kv.WriteBatchCollector(jbase),
                  port_kv.WriteBatchCollector(pbase))
    jnamed, pnamed = (jax_kv.NamedDB(jcol, "ns/a"),
                      port_kv.NamedDB(pcol, "ns/a"))
    for _ in range(300):
        op = rng.randrange(9)
        on_base = rng.random() < 0.3
        pair = (jbase, pbase) if on_base else (jcol, pcol)
        if op < 3:
            puts = {_rand_key(rng): bytes([rng.randrange(256)])
                    for _ in range(rng.randrange(4))}
            dels = [_rand_key(rng) for _ in range(rng.randrange(3))]
            for s in pair:
                s.write_batch(dict(puts), list(dels))
        elif op == 3:
            puts = {_rand_key(rng): b"first" for _ in range(3)}
            for s in pair:
                s.write_batch_if_absent(dict(puts))
        elif op == 4:
            k, v = _rand_key(rng), bytes([rng.randrange(256)])
            jnamed.put(k, v)
            pnamed.put(k, v)
        elif op == 5:
            prefix = _rand_key(rng)[:1]
            assert (jax_kv.wipe_prefix(pair[0], prefix)
                    == port_kv.wipe_prefix(pair[1], prefix))
        elif op == 6:
            assert jcol.pending == pcol.pending
            jcol.flush()
            pcol.flush()
        elif op == 7 and rng.random() < 0.3:
            jcol.discard()
            pcol.discard()
        keys = [_rand_key(rng) for _ in range(4)]
        assert jcol.get_many(keys) == pcol.get_many(keys)
        assert [jcol.get(k) for k in keys] == [pcol.get(k) for k in keys]
        lo, hi = sorted((_rand_key(rng), _rand_key(rng)))
        assert list(jcol.iterate(lo, hi)) == list(pcol.iterate(lo, hi))
        assert list(jnamed.iterate()) == list(pnamed.iterate())
        assert list(jbase.iterate()) == list(pbase.iterate())
    jcol.flush()
    pcol.flush()
    assert list(jbase.iterate()) == list(pbase.iterate())
    assert list(jbase.iterate(b"\x01")) == list(pbase.iterate(b"\x01"))
    jbase.close()
    pbase.close()


@pytest.mark.parametrize("name,raw,want", [
    ("FABRIC_TPU_SQLITE_SYNC", "", "NORMAL"),
    ("FABRIC_TPU_SQLITE_SYNC", " full ", "FULL"),
    ("FABRIC_TPU_SQLITE_SYNC", "fast", ValueError),
    ("FABRIC_TPU_WAL_CHECKPOINT", "", 1000),
    ("FABRIC_TPU_WAL_CHECKPOINT", "4000", 4000),
    ("FABRIC_TPU_WAL_CHECKPOINT", "-3", 0),
    ("FABRIC_TPU_WAL_CHECKPOINT", "4k", ValueError),
    ("FABRIC_TPU_STORE_SEGMENT", "", 16 * 1024 * 1024),
    ("FABRIC_TPU_STORE_SEGMENT", "64k", 65536),
    ("FABRIC_TPU_STORE_SEGMENT", "100", 4096),
    ("FABRIC_TPU_STORE_SEGMENT", "1g", ValueError),
])
def test_settings_parse_as_the_reference(monkeypatch, name, raw, want):
    monkeypatch.setenv(name, raw)
    pairs = {
        "FABRIC_TPU_SQLITE_SYNC": (lambda: jax_kv._sqlite_sync_level(None),
                                   port_kv.sqlite_sync_level),
        "FABRIC_TPU_WAL_CHECKPOINT": (
            lambda: jax_kv._sqlite_wal_checkpoint(None),
            port_kv.sqlite_wal_checkpoint),
        "FABRIC_TPU_STORE_SEGMENT": (jax_blk.segment_size,
                                     port_blk.segment_size),
    }[name]
    if want is ValueError:
        msgs = []
        for fn in pairs:
            with pytest.raises(ValueError) as err:
                fn()
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1]
        return
    assert pairs[0]() == pairs[1]() == want


def test_sqlite_store_applies_the_settings(monkeypatch, tmp_path):
    monkeypatch.setenv("FABRIC_TPU_SQLITE_SYNC", "FULL")
    monkeypatch.setenv("FABRIC_TPU_WAL_CHECKPOINT", "4000")
    s = port_kv.SqliteKVStore(str(tmp_path / "s.sqlite"))
    assert (s.sync_level, s.wal_autocheckpoint) == ("FULL", 4000)
    assert s._conn.execute("PRAGMA synchronous").fetchone()[0] == 2
    assert s._conn.execute("PRAGMA wal_autocheckpoint").fetchone()[0] == 4000
    assert s._conn.execute("PRAGMA journal_mode").fetchone()[0] == "wal"
    s.close()


# -- state DB -----------------------------------------------------------------


def _vv(mod, value, height, meta=b""):
    return mod.VersionedValue(value, mod.Height(*height), meta)


@pytest.mark.parametrize("seed", range(3))
def test_versioned_db_writes_the_reference_pairs(seed):
    rng = random.Random(seed)
    jstore, pstore = jax_kv.MemKVStore(), port_kv.MemKVStore()
    jdb = jax_sdb.VersionedDB(jstore, "statedb/ch")
    pdb = port_sdb.VersionedDB(pstore, "statedb/ch")
    namespaces = ["cc", "cc2", jax_tx.hash_ns("cc", "coll"),
                  jax_tx.pvt_ns("cc", "coll")]
    for block in range(1, 6):
        batch_j, batch_p = {}, {}
        for _ in range(rng.randrange(1, 8)):
            ns = rng.choice(namespaces)
            key = rng.choice(["a", "b", "a\x00b", "é", "k%d" % rng.randrange(5)])
            if rng.random() < 0.2:
                vj = vp = None
            else:
                h = (block, rng.randrange(100))
                value = bytes(rng.randrange(256) for _ in range(rng.randrange(6)))
                meta = b"" if rng.random() < 0.7 else bytes([rng.randrange(256)])
                vj, vp = _vv(jax_sdb, value, h, meta), _vv(port_sdb, value, h, meta)
            batch_j.setdefault(ns, {})[key] = vj
            batch_p.setdefault(ns, {})[key] = vp
        height = (block, 10) if rng.random() < 0.8 else None
        jdb.apply_updates(batch_j, None if height is None
                          else jax_sdb.Height(*height))
        pdb.apply_updates(batch_p, None if height is None
                          else port_sdb.Height(*height))
        assert list(pstore.iterate()) == list(jstore.iterate())
        for ns in namespaces:
            assert pdb.may_have_metadata(ns) == jdb.may_have_metadata(ns)
            got = [(k, v.value, v.version.pack(), v.metadata)
                   for k, v in pdb.get_state_range(ns, "", "")]
            assert got == [(k, v.value, v.version.pack(), v.metadata)
                           for k, v in jdb.get_state_range(ns, "", "")]
            assert [(k, v.version.pack()) for k, v in
                    pdb.get_state_range(ns, "a", "k3")] == [
                (k, v.version.pack()) for k, v in
                jdb.get_state_range(ns, "a", "k3")]
        sp, jsp = pdb.savepoint(), jdb.savepoint()
        assert (sp and sp.pack()) == (jsp and jsp.pack())
    h = port_sdb.Height(2 ** 40 + 3, 7)
    assert h.pack() == jax_sdb.Height(2 ** 40 + 3, 7).pack()
    assert port_sdb.Height.unpack(h.pack()) == h
    assert port_sdb._encode_value(_vv(port_sdb, b"v", (1, 2), b"m")) == \
        jax_sdb._encode_value(_vv(jax_sdb, b"v", (1, 2), b"m"))


def test_versioned_db_refuses_a_store_with_rich_query_indexes():
    """A store whose indexes the JAX package defined: the port no longer
    refuses it, it maintains the index entries in apply_updates as the
    JAX package does (the pairs of both stores stay equal)."""
    store = jax_kv.MemKVStore()
    jdb = jax_sdb.VersionedDB(store, "statedb/ch")
    jdb.define_index("cc", "color")
    jdb.define_index("cc", ["color", "size"])
    port_store = port_kv.MemKVStore()
    port_store.write_batch(dict(store.iterate()))
    pdb = port_sdb.VersionedDB(port_store, "statedb/ch")
    batches = [
        {"cc": {"a": b'{"color": "red", "size": 1}', "b": b'{"color": 2}',
                "c": b"not json", "d": b'{"size": 3}'}},
        {"cc": {"a": b'{"color": "blue", "size": 1}', "b": None,
                "d": b'{"color": null, "size": 3}'}, "other": {"x": b"{}"}},
    ]
    for n, raw in enumerate(batches, 1):
        for db, mod in ((jdb, jax_sdb), (pdb, port_sdb)):
            db.apply_updates({ns: {k: None if v is None else _vv(
                mod, v, (n, 0)) for k, v in kvs.items()}
                for ns, kvs in raw.items()}, mod.Height(n, 0))
        assert list(port_store.iterate()) == list(store.iterate())
    for spec in ("color", "color\x1fsize"):
        assert list(pdb.index_scan("cc", spec, None, None)) == list(
            jdb.index_scan("cc", spec, None, None))


def test_metadata_helpers_encode_as_the_reference():
    entries = {"VALIDATION_PARAMETER": b"\x01\x02", "a": b"", "z": b"zz"}
    raw = port_tx.encode_metadata(entries)
    assert raw == jax_tx.encode_metadata(entries)
    assert port_tx.decode_metadata(raw) == jax_tx.decode_metadata(raw) == entries
    assert port_tx.decode_metadata(b"") == {}
    assert port_tx.key_hash("k") == jax_tx.key_hash("k")
    assert port_tx.value_hash(b"v") == jax_tx.value_hash(b"v")
    assert port_tx.pvt_ns("a", "b") == jax_tx.pvt_ns("a", "b")


# -- MVCC ---------------------------------------------------------------------

NS = "cc"
COLL = "coll"
KEYS = ["a", "b", "c", "d", "e", "f"]


def _version(rng, block, committed):
    """A version to read: the committed one mostly, else stale or absent."""
    r = rng.random()
    if r < 0.6:
        return committed
    if r < 0.8:
        return None
    return (max(0, block - 1), rng.randrange(4))


def _rwset(rng, block, committed, pvt_out, tx) -> bytes:
    kv = kv_rwset_pb2.KVRWSet()
    for _ in range(rng.randrange(3)):
        k = rng.choice(KEYS)
        r = kv.reads.add(key=k)
        v = _version(rng, block, committed.get((NS, k)))
        if v is not None:
            r.version.block_num, r.version.tx_num = v
    if rng.random() < 0.3:
        lo, hi = sorted(rng.sample(KEYS + [""], 2))
        rq = kv.range_queries_info.add(start_key=lo, end_key=hi,
                                       itr_exhausted=True)
        for k in KEYS:
            if lo <= k and (not hi or k < hi) and (NS, k) in committed:
                if rng.random() < 0.9:  # a missed key is a phantom
                    b, t = committed[(NS, k)]
                    rd = rq.raw_reads.kv_reads.add(key=k)
                    rd.version.block_num, rd.version.tx_num = b, t
        if rng.random() < 0.05:
            rq.reads_merkle_hashes.max_degree = 2
    for _ in range(rng.randrange(3)):
        kv.writes.add(key=rng.choice(KEYS), is_delete=rng.random() < 0.2,
                      value=bytes([rng.randrange(256)]))
    for _ in range(rng.randrange(2) if rng.random() < 0.3 else 0):
        mw = kv.metadata_writes.add(key=rng.choice(KEYS))
        mw.entries.add(name="VALIDATION_PARAMETER",
                       value=bytes([rng.randrange(256)]))
    ns = rwset_pb2.NsReadWriteSet(namespace=NS, rwset=kv.SerializeToString())
    if rng.random() < 0.4:
        h = kv_rwset_pb2.HashedRWSet()
        pkv = kv_rwset_pb2.KVRWSet()
        for _ in range(rng.randrange(1, 3)):
            k = rng.choice(KEYS)
            hk = jax_tx.key_hash(k)
            if rng.random() < 0.5:
                rd = h.hashed_reads.add(key_hash=hk)
                v = _version(rng, block, committed.get(
                    (jax_tx.hash_ns(NS, COLL), hk.hex())))
                if v is not None:
                    rd.version.block_num, rd.version.tx_num = v
            dele = rng.random() < 0.2
            value = bytes([rng.randrange(256)])
            h.hashed_writes.add(key_hash=hk, is_delete=dele,
                                value_hash=jax_tx.value_hash(value))
            pkv.writes.add(key=k, is_delete=dele, value=value)
        if rng.random() < 0.3:
            mw = h.metadata_writes.add(key_hash=jax_tx.key_hash(rng.choice(KEYS)))
            mw.entries.add(name="x", value=b"y")
        raw_pkv = pkv.SerializeToString()
        forged = rng.random() < 0.2
        ns.collection_hashed_rwset.add(
            collection_name=COLL, hashed_rwset=h.SerializeToString(),
            pvt_rwset_hash=jax_tx.value_hash(b"other" if forged else raw_pkv))
        if rng.random() < 0.7:
            txpvt = rwset_pb2.TxPvtReadWriteSet()
            nsp = txpvt.ns_pvt_rwset.add(namespace=NS)
            nsp.collection_pvt_rwset.add(collection_name=COLL, rwset=raw_pkv)
            pvt_out[tx] = txpvt.SerializeToString()
    return rwset_pb2.TxReadWriteSet(ns_rwset=[ns]).SerializeToString()


def _batch(batch) -> list:
    return [(ns, [(k, None if v is None else
                   (v.value, v.version.pack(), v.metadata))
                  for k, v in kvs.items()]) for ns, kvs in batch.items()]


@pytest.mark.parametrize("footprints", [False, True],
                         ids=["decode", "footprints"])
@pytest.mark.parametrize("seed", range(4))
def test_mvcc_flags_and_batches_equal_the_reference(seed, footprints):
    rng = random.Random(seed)
    jstore, pstore = jax_kv.MemKVStore(), port_kv.MemKVStore()
    jdb = jax_sdb.VersionedDB(jstore, "statedb/ch")
    pdb = port_sdb.VersionedDB(pstore, "statedb/ch")
    jm, pm = jax_tx.MVCCValidator(jdb, fanout=0), port_tx.MVCCValidator(pdb)
    committed: dict = {}
    seen_codes = set()
    for block in range(1, 9):
        pvt: dict = {}
        rwsets = [_rwset(rng, block, committed, pvt, i) for i in range(12)]
        rwsets[rng.randrange(12)] = None  # not an endorser transaction
        if rng.random() < 0.5:
            rwsets[rng.randrange(12)] = b"\x0a\x05bad"  # BAD_RWSET
        flags = [0 if rng.random() < 0.9 else 10 for _ in rwsets]
        jflags, pflags = list(flags), list(flags)
        fps = None
        if footprints:
            fps = []
            for raw, f in zip(rwsets, flags):
                try:
                    fps.append(parse_footprint(raw) if raw and f == 0 else None)
                except Exception:
                    fps.append(None)
        jb = jm.validate_and_prepare(block, rwsets, jflags, pvt)
        pb_ = pm.validate_and_prepare(block, rwsets, pflags, pvt,
                                      footprints=fps)
        assert pflags == jflags
        assert _batch(pb_) == _batch(jb)
        assert set(pm.last_stage_seconds) == {"preload", "check", "prepare"}
        seen_codes.update(jflags)
        jdb.apply_updates(jb, jax_sdb.Height(block, len(flags)))
        pdb.apply_updates(pb_, port_sdb.Height(block, len(flags)))
        assert list(pstore.iterate()) == list(jstore.iterate())
        for ns, kvs in jb.items():
            for k, v in kvs.items():
                if v is None:
                    committed.pop((ns, k), None)
                else:
                    committed[(ns, k)] = (v.version.block_num,
                                          v.version.tx_num)
    # the seeds reach every code the pass sets
    assert {0, 10, 11, 12, 22} <= seen_codes


def test_mvcc_in_block_read_after_write_and_phantoms():
    """The planted cases of chip_smoke's block 4, on both validators."""
    def kv(reads=(), ranges=(), writes=()):
        m = kv_rwset_pb2.KVRWSet()
        for k, v in reads:
            r = m.reads.add(key=k)
            if v is not None:
                r.version.block_num, r.version.tx_num = v
        for lo, hi, got in ranges:
            rq = m.range_queries_info.add(start_key=lo, end_key=hi)
            rq.raw_reads.SetInParent()
            for k, (b, t) in got:
                rd = rq.raw_reads.kv_reads.add(key=k)
                rd.version.block_num, rd.version.tx_num = b, t
        for k in writes:
            m.writes.add(key=k, value=b"x")
        return rwset_pb2.TxReadWriteSet(ns_rwset=[rwset_pb2.NsReadWriteSet(
            namespace=NS, rwset=m.SerializeToString())]).SerializeToString()

    rwsets = [
        kv(reads=[("k7", (1, 7))], ranges=[("k6", "k60", [("k6", (1, 6))])]),
        kv(reads=[("k8", (1, 9))]),
        kv(writes=["fresh"]),
        kv(reads=[("fresh", None)]),
        kv(ranges=[("k5", "k50", [])]),
        kv(ranges=[("k6", "k60", [("k6", (1, 6))])], writes=["k6-x"]),
        kv(ranges=[("k6", "k60", [("k6", (1, 6))])]),  # k6-x is a phantom now
    ]
    want = [0, 11, 0, 11, 12, 0, 12]
    for mod, kvmod, m_cls in ((jax_sdb, jax_kv, jax_tx.MVCCValidator),
                              (port_sdb, port_kv, port_tx.MVCCValidator)):
        db = mod.VersionedDB(kvmod.MemKVStore())
        db.apply_updates({NS: {f"k{i}": mod.VersionedValue(b"v", mod.Height(1, i))
                               for i in range(10)}}, mod.Height(1, 9))
        flags = [0] * len(rwsets)
        m_cls(db).validate_and_prepare(2, rwsets, flags)
        assert flags == want


# -- history and private data -------------------------------------------------


def test_history_and_pvt_store_write_the_reference_pairs():
    jstore, pstore = jax_kv.MemKVStore(), port_kv.MemKVStore()
    jh = jax_hist.HistoryDB(jstore, "historydb/ch")
    ph = port_hist.HistoryDB(pstore, "historydb/ch")
    btl = {("cc", "c1"): 2, ("cc", "c2"): 0, ("cc2", "c1"): 1}
    jp = jax_pvt.PvtDataStore(jstore, "ch", lambda n, c: btl.get((n, c), 0))
    pp = port_pvt.PvtDataStore(pstore, "ch", lambda n, c: btl.get((n, c), 0))

    def txpvt(colls):
        t = rwset_pb2.TxPvtReadWriteSet()
        for ns, coll in colls:
            nsp = next((n for n in t.ns_pvt_rwset if n.namespace == ns), None)
            if nsp is None:
                nsp = t.ns_pvt_rwset.add(namespace=ns)
            nsp.collection_pvt_rwset.add(collection_name=coll, rwset=b"\x1a\x00")
        return t.SerializeToString()

    for block in range(1, 8):
        writes = [[("cc", f"k{block % 3}"), ("cc2", "x")], [], [("cc", "z")]]
        jh.commit(block, writes)
        ph.commit(block, writes)
        pvt = {0: txpvt([("cc", "c1"), ("cc", "c2"), ("cc2", "c1")]),
               2: txpvt([("cc", "c1")])}
        missing = [(1, "cc", "c1"), (1, "cc2", "c1"), (2, "cc", "c9")]
        jcol = jax_kv.WriteBatchCollector(jstore)
        pcol = port_kv.WriteBatchCollector(pstore)
        jp.commit(block, pvt, missing, into=jcol)
        pp.commit(block, pvt, missing, into=pcol)
        jcol.flush()
        pcol.flush()
        assert list(pstore.iterate()) == list(jstore.iterate())
        assert pp.get_pvt_data_by_block(block - 2) == \
            jp.get_pvt_data_by_block(block - 2)
    assert ph.get_history_for_key("cc", "k1") == \
        jh.get_history_for_key("cc", "k1") == [(1, 0), (4, 0), (7, 0)]
    assert ph.savepoint() == jh.savepoint() == 7
    assert pp.get_missing(2) == jp.get_missing(2)
    jp.resolve_missing(7, 1, txpvt([("cc", "c1")]))
    pp.resolve_missing(7, 1, txpvt([("cc", "c1")]))
    jp.resolve_missing(6, 0, txpvt([("cc", "c3"), ("cc3", "c1")]))
    pp.resolve_missing(6, 0, txpvt([("cc", "c3"), ("cc3", "c1")]))
    assert list(pstore.iterate()) == list(jstore.iterate())


# -- block store --------------------------------------------------------------


def _envelope(txid: str, size: int, rng) -> bytes:
    chdr = common_pb2.ChannelHeader(type=3, channel_id="ch", tx_id=txid)
    payload = common_pb2.Payload(
        header=common_pb2.Header(channel_header=chdr.SerializeToString()),
        data=bytes(rng.randrange(256) for _ in range(size)))
    return common_pb2.Envelope(payload=payload.SerializeToString(),
                               signature=b"s").SerializeToString()


def _blocks(n, rng):
    """n chained blocks of 0-6 envelopes (repeated txids, a garbled
    envelope), with metadata and filters, as JAX pb2 blocks."""
    out = []
    prev = b""
    for num in range(n):
        blk = common_pb2.Block()
        blk.header.number = num
        blk.header.previous_hash = prev
        for i in range(rng.randrange(7)):
            txid = rng.choice([f"tx{num}-{i}", f"tx{max(0, num - 1)}-0", ""])
            blk.data.data.append(_envelope(txid, rng.randrange(400), rng)
                                 if rng.random() < 0.9 else b"\xff\x01")
        blk.header.data_hash = jax_pu.block_data_hash(blk.data)
        jax_pu.init_block_metadata(blk)
        jax_pu.set_tx_filter(blk, bytes(rng.randrange(3)
                                        for _ in blk.data.data))
        prev = jax_pu.block_header_hash(blk.header)
        out.append(blk)
    return out


def _block_files(d: Path) -> dict:
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())}


def _same_block_stores(js, ps, jkv, pkv, jdir, pdir, blocks):
    assert ps.height == js.height
    assert ps.last_block_hash == js.last_block_hash
    assert ps.info() == js.info()
    assert list(pkv.iterate()) == list(jkv.iterate())
    if jdir is not None:
        assert _block_files(pdir) == _block_files(jdir)
    for blk in blocks[:js.height]:
        n = blk.header.number
        pb_ = ps.get_block_by_number(n)
        assert pb_.encode() == js.get_block_by_number(n).SerializeToString()
        h = jax_pu.block_header_hash(blk.header)
        assert ps.get_block_by_hash(h).encode() == \
            js.get_block_by_hash(h).SerializeToString()
        for raw in blk.data.data:
            txid = port_blk.BlockStore._parse_txid(raw)
            if txid:
                assert ps.get_tx_loc(txid) == js.get_tx_loc(txid)
                assert ps.get_tx_validation_code(txid) == \
                    js.get_tx_validation_code(txid)
                assert ps.get_tx_by_id(txid).encode() == \
                    js.get_tx_by_id(txid).SerializeToString()
    ids = [f"tx{n}-{i}" for n in range(len(blocks)) for i in range(3)] + ["x"]
    assert ps.tx_ids_exist(ids) == js.tx_ids_exist(ids)
    assert ps.get_block_by_number(js.height) is None


@pytest.mark.parametrize("on_disk", [True, False], ids=["files", "memory"])
def test_block_store_equals_the_reference(tmp_path, on_disk):
    rng = random.Random(5)
    blocks = _blocks(24, rng)
    jdir = tmp_path / "jax" if on_disk else None
    pdir = tmp_path / "port" if on_disk else None
    jkv, pkv = jax_kv.MemKVStore(), port_kv.MemKVStore()
    js = jax_blk.BlockStore(jdir and str(jdir), jkv, name="ch", segment=4096)
    ps = port_blk.BlockStore(pdir and str(pdir), pkv, name="ch", segment=4096)
    i = 0
    while i < len(blocks):
        # groups of 1-4 blocks through a collector, as the ledger commits
        n = rng.randrange(1, 5)
        jcol = jax_kv.WriteBatchCollector(jkv)
        pcol = port_kv.WriteBatchCollector(pkv)
        jfiles, pfiles = set(), set()
        for blk in blocks[i:i + n]:
            pblk = cb.Block.decode(blk.SerializeToString())
            txids = None
            if rng.random() < 0.5:
                txids = [port_blk.BlockStore._parse_txid(e)
                         for e in blk.data.data]
            jfiles.add(js.add_block(blk, txids=txids, into=jcol, sync=False))
            pfiles.add(ps.add_block(pblk, txids=txids,
                                    env_bytes=list(pblk.data.data),
                                    into=pcol, sync=False))
        assert pfiles == jfiles
        js.sync_files(jfiles - {None})
        ps.sync_files(pfiles - {None})
        jcol.flush()
        pcol.flush()
        i += n
        _same_block_stores(js, ps, jkv, pkv, jdir, pdir, blocks)
    with pytest.raises(port_blk.BlockStoreError):
        ps.add_block(cb.Block.decode(blocks[3].SerializeToString()))
    assert [b.encode() for b in ps.iterator(20)] == [
        b.SerializeToString() for b in js.iterator(20)]
    js.close()
    ps.close()


@pytest.mark.parametrize("damage", ["torn", "garbage", "gap", "rollback"])
def test_block_store_recovers_as_the_reference(tmp_path, damage):
    """Blocks appended past the committed checkpoint, then damaged: a torn
    last record, garbage in the middle, a record of a later number, or a
    rolled-back group; both stores recover to the same height and bytes."""
    rng = random.Random(7)
    blocks = _blocks(12, rng)
    stores = {}
    for side, blk_mod, kv_mod in (("jax", jax_blk, jax_kv),
                                  ("port", port_blk, port_kv)):
        d = tmp_path / side
        kv = kv_mod.SqliteKVStore(str(tmp_path / f"{side}.sqlite"))
        s = blk_mod.BlockStore(str(d), kv, name="ch", segment=8192)
        for blk in blocks[:5]:
            s.add_block(blk if side == "jax"
                        else cb.Block.decode(blk.SerializeToString()))
        col = kv_mod.WriteBatchCollector(kv)
        for blk in blocks[5:9]:  # a group never flushed
            s.add_block(blk if side == "jax"
                        else cb.Block.decode(blk.SerializeToString()),
                        into=col, sync=False)
        if damage == "rollback":
            col.discard()
            s.truncate_to_checkpoint()
        s.close()
        stores[side] = (d, kv, blk_mod)
    jd = stores["jax"][0]
    files = sorted(jd.iterdir())
    last = files[-1]
    data = bytearray(last.read_bytes())
    end = len(data.rstrip(b"\x00"))
    if damage == "torn":
        data = data[:end - 7]
    elif damage == "garbage":
        mid = end // 2
        data[mid:mid + 20] = b"\xff" * 20
    elif damage == "gap":
        # a record whose number skips: the scan must stop before it
        rec = blocks[11].SerializeToString()
        data[end:end + 4 + len(rec)] = struct.pack(">I", len(rec)) + rec
    for side in ("jax", "port"):
        target = stores[side][0] / last.name
        target.write_bytes(bytes(data))
    reopened = {}
    for side, (d, kv, blk_mod) in stores.items():
        reopened[side] = blk_mod.BlockStore(str(d), kv, name="ch",
                                            segment=8192)
    js, ps = reopened["jax"], reopened["port"]
    if damage == "rollback":
        assert js.height == 5
    _same_block_stores(js, ps, stores["jax"][1], stores["port"][1],
                       stores["jax"][0], stores["port"][0], blocks)
    js.close()
    ps.close()


def test_block_header_hash_and_splice_equal_the_reference():
    rng = random.Random(3)
    for blk in _blocks(8, rng):
        blk.header.number = rng.choice([0, 1, 127, 128, 255, 2 ** 63, 2 ** 64 - 1])
        pblk = cb.Block.decode(blk.SerializeToString())
        assert port_pu.block_header_bytes(pblk.header) == \
            jax_pu.block_header_bytes(blk.header)
        assert port_pu.block_header_hash(pblk.header) == \
            jax_pu.block_header_hash(blk.header)
        assert port_pu.serialize_block(pblk) == pblk.encode() == \
            jax_pu.serialize_block(blk)
        assert bytes(port_pu.tx_filter(pblk)) == bytes(jax_pu.tx_filter(blk))
    empty = common_pb2.Block()
    assert port_pu.serialize_block(cb.Block()) == jax_pu.serialize_block(empty)
    # a filter of the wrong length reads as all VALID
    short = cb.Block(data=cb.BlockData(data=[b"a", b"b"]))
    port_pu.set_tx_filter(short, b"\x01")
    assert port_pu.tx_filter(short) == bytearray(2)


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
