"""The port's read side of the ledger against the JAX package's.

Seeded states (JSON documents, plain values, key metadata, a private
collection with its hashed namespace) are written into a JAX and a port
`VersionedDB`; then the same seeded operation sequences run through the
JAX `TxSimulator` and the port's: every answer, the marshaled
TxReadWriteSet and TxPvtReadWriteSet must be equal byte for byte, and so
must the stores after both commit the results through their MVCC
validators (index entries included).  The query executors' answers, and
`execute_query` / `execute_query_indexed` over seeded documents and
selectors, with and without single-field and compound indexes, must be
equal too.  Every comparison is exact.
"""

import json
import random

import pytest

from fabric_tpu.ledger import kvledger as jax_kvl
from fabric_tpu.ledger import kvstore as jax_kv
from fabric_tpu.ledger import richquery as jax_rq
from fabric_tpu.ledger import statedb as jax_sdb
from fabric_tpu.ledger import txmgmt as jax_tx
from fabric_tpu_torch.common import workpool
from fabric_tpu_torch.ledger import kvledger as port_kvl
from fabric_tpu_torch.ledger import kvstore as port_kv
from fabric_tpu_torch.ledger import richquery as port_rq
from fabric_tpu_torch.ledger import statedb as port_sdb
from fabric_tpu_torch.ledger import txmgmt as port_tx

NS = "cc"
COLL = "coll"
COLORS = ["red", "blue", "green", "Red", ""]
INDEXES = ["color", "size", ["color", "size"], "owner.name",
           ["owner.name", "color"]]


@pytest.fixture(scope="module", autouse=True)
def _shut_the_port_pool():
    yield
    workpool.shutdown()


def _doc(rng) -> bytes:
    r = rng.random()
    if r < 0.08:
        return b"not json"
    if r < 0.12:
        return b"[1, 2]"
    doc = {}
    if rng.random() < 0.9:
        doc["color"] = rng.choice(COLORS + [None, 3, True])
    if rng.random() < 0.8:
        doc["size"] = rng.choice([rng.randrange(-5, 20), rng.random() * 10,
                                  0, 1, True, False, None, "7"])
    if rng.random() < 0.5:
        doc["owner"] = {"name": rng.choice(["ann", "bob", "eve", 1])}
    if rng.random() < 0.3:
        doc["tags"] = [rng.choice(COLORS) for _ in range(rng.randrange(3))]
    return json.dumps(doc, sort_keys=rng.random() < 0.5).encode()


def _keys(n: int) -> list[str]:
    return [f"k{i:02d}" for i in range(n)]


def _seed_state(rng, n: int = 24) -> dict:
    """{ns: {key: (value, (block, tx), metadata)}}: documents under NS, a
    private collection's cleartext and hashed namespaces, and a second
    public namespace."""
    batch = {NS: {}, "other": {}}
    for i, k in enumerate(_keys(n)):
        if rng.random() < 0.85:
            meta = (jax_tx.encode_metadata({"VALIDATION_PARAMETER": b"p%d" % i})
                    if rng.random() < 0.2 else b"")
            batch[NS][k] = (_doc(rng), (1, i), meta)
        if rng.random() < 0.3:
            batch["other"][k] = (b"o%d" % i, (1, i), b"")
    pvt, hashed = jax_tx.pvt_ns(NS, COLL), jax_tx.hash_ns(NS, COLL)
    batch[pvt], batch[hashed] = {}, {}
    for i, k in enumerate(_keys(8)):
        if rng.random() < 0.7:
            v = _doc(rng)
            batch[pvt][k] = (v, (1, 50 + i), b"")
            meta = jax_tx.encode_metadata({"x": b"y"}) if i % 3 == 0 else b""
            batch[hashed][jax_tx.key_hash(k).hex()] = (
                jax_tx.value_hash(v), (1, 50 + i), meta)
    return batch


def _apply(db, mod, batch: dict, height) -> None:
    db.apply_updates({ns: {k: None if v is None else mod.VersionedValue(
        v[0], mod.Height(*v[1]), v[2]) for k, v in kvs.items()}
        for ns, kvs in batch.items()}, mod.Height(*height))


def _pair(rng, indexed: bool):
    """A JAX and a port state DB over stores with equal pairs."""
    jstore, pstore = jax_kv.MemKVStore(), port_kv.MemKVStore()
    jdb = jax_sdb.VersionedDB(jstore, "statedb/ch")
    pdb = port_sdb.VersionedDB(pstore, "statedb/ch")
    if indexed:  # defined before the state: entries from apply_updates
        for spec in INDEXES[:2]:
            jdb.define_index(NS, spec)
            pdb.define_index(NS, spec)
    batch = _seed_state(rng)
    _apply(jdb, jax_sdb, batch, (1, 99))
    _apply(pdb, port_sdb, batch, (1, 99))
    if indexed:  # defined after it: entries from the backfill
        for spec in INDEXES[2:]:
            jdb.define_index(NS, spec)
            pdb.define_index(NS, spec)
    assert list(pstore.iterate()) == list(jstore.iterate())
    return jstore, jdb, pstore, pdb


def _selector(rng, depth: int = 0) -> dict:
    field = rng.choice(["color", "size", "owner.name", "tags", "missing"])
    value = rng.choice(COLORS + [rng.randrange(-3, 12), 0, 1, True, None,
                                 "ann", 2.5])
    r = rng.random()
    if depth < 2 and r < 0.15:
        return {"$and": [_selector(rng, depth + 1)
                         for _ in range(rng.randrange(1, 3))]}
    if depth < 2 and r < 0.25:
        return {"$or": [_selector(rng, depth + 1)
                        for _ in range(rng.randrange(1, 3))]}
    if r < 0.45:
        return {field: value}
    op = rng.choice(["$eq", "$ne", "$gt", "$gte", "$lt", "$lte", "$in",
                     "$nin", "$exists", "range"])
    if op in ("$in", "$nin"):
        return {field: {op: [rng.choice(COLORS + [1, 0, True, 4])
                             for _ in range(rng.randrange(1, 4))]}}
    if op == "$exists":
        return {field: {op: rng.random() < 0.5}}
    if op == "range":
        lo, hi = sorted([rng.randrange(-3, 12), rng.randrange(-3, 12)])
        return {field: {rng.choice(["$gt", "$gte"]): lo,
                        rng.choice(["$lt", "$lte"]): hi}}
    out = {field: {op: value}}
    if rng.random() < 0.3:  # a second field, conjunctive
        out["color"] = rng.choice(COLORS)
    return out


def _query(rng) -> str:
    q = {"selector": _selector(rng)}
    if rng.random() < 0.3:
        q["limit"] = rng.randrange(0, 6)
    return json.dumps(q)


def _run_ops(rng, sims, n_ops: int, keys) -> None:
    """The same seeded operations on both simulators; answers equal."""
    for _ in range(n_ops):
        op = rng.randrange(15)
        k = rng.choice(keys)
        coll_key = rng.choice(_keys(10))
        if op == 0:
            got = [s.get_state(NS, k) for s in sims]
        elif op == 1:
            v = _doc(rng)
            got = [s.set_state(NS, k, v) for s in sims]
        elif op == 2:
            ns = rng.choice([NS, "other"])
            got = [s.delete_state(ns, k) for s in sims]
        elif op == 3:
            got = [s.get_state_metadata(NS, k) for s in sims]
        elif op == 4:
            e = {rng.choice(["VALIDATION_PARAMETER", "a", "b"]):
                 bytes([rng.randrange(256)])}
            got = [s.set_state_metadata(NS, k, e) for s in sims]
        elif op == 5:
            name = rng.choice(["VALIDATION_PARAMETER", "a"])
            got = [s.delete_state_metadata(NS, k, name) for s in sims]
        elif op == 6:
            got = [s.get_private_data(NS, COLL, coll_key) for s in sims]
        elif op == 7:
            v = _doc(rng)
            got = [s.set_private_data(NS, COLL, coll_key, v) for s in sims]
        elif op == 8:
            got = [s.delete_private_data(NS, COLL, coll_key) for s in sims]
        elif op == 9:
            got = [s.get_private_data_hash(NS, COLL, coll_key) for s in sims]
        elif op == 10:
            e = {"m": bytes([rng.randrange(9)])}
            got = [s.set_private_data_metadata(NS, COLL, coll_key, e)
                   for s in sims]
            got += [s.get_private_data_metadata(NS, COLL, coll_key)
                    for s in sims]
        elif op == 11:
            lo, hi = sorted(rng.sample(keys + [""], 2))
            ns = rng.choice([NS, "other", "empty"])
            got = [s.get_state_range(ns, lo, hi) for s in sims]
        elif op == 12:
            lo, hi = sorted(rng.sample(_keys(10) + [""], 2))
            got = [s.get_private_data_range(NS, COLL, lo, hi) for s in sims]
        elif op == 13:
            q = _query(rng)
            got = [s.get_query_result(NS, q) for s in sims]
        else:
            q = _query(rng)
            got = [s.get_private_data_query_result(NS, COLL, q) for s in sims]
        assert got[0] == got[1], op


@pytest.mark.parametrize("indexed", [False, True], ids=["scan", "indexed"])
@pytest.mark.parametrize("seed", range(5))
def test_simulation_results_equal_the_reference_bytes(seed, indexed):
    rng = random.Random(seed)
    jstore, jdb, pstore, pdb = _pair(rng, indexed)
    keys = _keys(30)
    jm, pm = jax_tx.MVCCValidator(jdb, fanout=0), port_tx.MVCCValidator(pdb)
    for block in range(2, 6):
        rwsets, pvt = [], {}
        for tx in range(4):
            sims = [jax_tx.TxSimulator(jdb), port_tx.TxSimulator(pdb)]
            _run_ops(rng, sims, rng.randrange(1, 25), keys)
            raw = [s.get_tx_simulation_results() for s in sims]
            assert raw[1] == raw[0]
            praw = [s.get_pvt_simulation_results() for s in sims]
            assert praw[1] == praw[0]
            rwsets.append(raw[0])
            if praw[0] is not None:
                pvt[tx] = praw[0]
        jflags, pflags = [0] * len(rwsets), [0] * len(rwsets)
        jb = jm.validate_and_prepare(block, rwsets, jflags, pvt)
        pb_ = pm.validate_and_prepare(block, rwsets, pflags, pvt)
        assert pflags == jflags
        jdb.apply_updates(jb, jax_sdb.Height(block, len(rwsets)))
        pdb.apply_updates(pb_, port_sdb.Height(block, len(rwsets)))
        # the state, the savepoint and every index entry
        assert list(pstore.iterate()) == list(jstore.iterate())


def test_an_empty_range_and_a_delete_encode_as_the_reference():
    """Fields the reference leaves unset: an empty range's raw reads, a
    delete's value, an absent key's read version, the data model."""
    rng = random.Random(7)
    _, jdb, _, pdb = _pair(rng, indexed=False)
    sims = [jax_tx.TxSimulator(jdb), port_tx.TxSimulator(pdb)]
    for s in sims:
        assert s.get_state_range(NS, "zz", "zzz") == []
        assert s.get_state(NS, "absent") is None
        s.delete_state(NS, "k01")
        s.set_state(NS, "k02", b"")
        assert s.get_pvt_simulation_results() is None
    assert sims[1].get_tx_simulation_results() == \
        sims[0].get_tx_simulation_results()


@pytest.mark.parametrize("seed", range(3))
def test_query_executors_answer_as_the_reference(seed):
    rng = random.Random(100 + seed)
    _, jdb, _, pdb = _pair(rng, indexed=bool(seed % 2))
    jq, pq = jax_kvl.QueryExecutor(jdb), port_kvl.QueryExecutor(pdb)
    keys = _keys(30)
    for _ in range(60):
        k = rng.choice(keys)
        ck = rng.choice(_keys(10))
        lo, hi = sorted(rng.sample(keys + [""], 2))
        ns = rng.choice([NS, "other", jax_tx.hash_ns(NS, COLL)])
        assert pq.get_state(NS, k) == jq.get_state(NS, k)
        some = rng.sample(keys, 5)
        assert pq.get_state_multiple(ns, some) == jq.get_state_multiple(ns,
                                                                         some)
        assert list(pq.get_state_range(ns, lo, hi)) == list(
            jq.get_state_range(ns, lo, hi))
        assert pq.get_private_data(NS, COLL, ck) == jq.get_private_data(
            NS, COLL, ck)
        assert pq.get_private_data_hash(NS, COLL, ck) == \
            jq.get_private_data_hash(NS, COLL, ck)
        assert pq.get_state_metadata(NS, k) == jq.get_state_metadata(NS, k)
        hk = jax_tx.key_hash(ck).hex()
        hns = jax_tx.hash_ns(NS, COLL)
        assert pq.get_state_metadata(hns, hk) == jq.get_state_metadata(hns,
                                                                       hk)
    pq.done()


def _versioned(rows):
    return None if rows is None else [(k, v, ver.pack()) for k, v, ver in rows]


@pytest.mark.parametrize("seed", range(4))
def test_rich_queries_equal_the_reference(seed):
    """Seeded documents and selectors: the scan and the index-assisted
    execution answer as the JAX package's, with and without indexes.  (The
    two paths of either package need not agree with each other: the scan
    of NS also meets its collections' derived namespaces, and a limit of
    0 still returns one indexed match.)"""
    rng = random.Random(200 + seed)
    _, jdb, _, pdb = _pair(rng, indexed=True)
    _, jdb0, _, pdb0 = _pair(random.Random(200 + seed), indexed=False)
    pairs = [(k, vv.value) for k, vv in jdb.get_state_range(NS, "", "")]
    served = 0
    for _ in range(150):
        q = _query(rng)
        want = jax_rq.execute_query(iter(pairs), q)
        assert port_rq.execute_query(iter(pairs), q) == want
        for j, p in ((jdb, pdb), (jdb0, pdb0)):
            jgot = _versioned(jax_rq.execute_query_indexed(j, NS, q))
            pgot = _versioned(port_rq.execute_query_indexed(p, NS, q))
            assert pgot == jgot
            if pgot is not None:
                served += 1
        sel = json.loads(q)["selector"]
        specs = {s if isinstance(s, str) else "\x1f".join(s) for s in INDEXES}
        assert port_rq.plan_index(sel, specs) == jax_rq.plan_index(sel, specs)
    assert served > 20


def test_index_entries_and_scans_equal_the_reference():
    """Index entries of scalars of every type, strings holding \\x00,
    keys holding \\x00, and their scans over inclusive and open bounds."""
    docs = [{"f": v} for v in (None, True, False, -2.5, -0.0, 0, 1, 7,
                               1e300, "", "a", "a\x00b", "b", "\xe9")]
    docs += [{"f": [1]}, {"f": {"g": 1}}, {"g": 1}]
    jstore, pstore = jax_kv.MemKVStore(), port_kv.MemKVStore()
    jdb = jax_sdb.VersionedDB(jstore, "s")
    pdb = port_sdb.VersionedDB(pstore, "s")
    batch = {NS: {f"d{i}\x00x": (json.dumps(d).encode(), (1, i), b"")
                  for i, d in enumerate(docs)}}
    for db, mod in ((jdb, jax_sdb), (pdb, port_sdb)):
        db.define_index(NS, "f")
        db.define_index(NS, ["f", "f"])
        _apply(db, mod, batch, (1, 99))
    assert list(pstore.iterate()) == list(jstore.iterate())
    vals = [d["f"] for d in docs if "f" in d]
    for v in vals:
        assert port_sdb.encode_scalar(v) == jax_sdb.encode_scalar(v)
        assert port_sdb.encode_composite([v, "x"]) == \
            jax_sdb.encode_composite([v, "x"])
    encs = [None] + [jax_sdb.encode_scalar(v) for v in vals
                     if jax_sdb.encode_scalar(v) is not None]
    for lo in encs:
        for hi in encs:
            assert list(pdb.index_scan(NS, "f", lo, hi)) == list(
                jdb.index_scan(NS, "f", lo, hi))
    assert pdb.indexes_for(NS) == jdb.indexes_for(NS)
    assert pdb.indexed_namespaces() == jdb.indexed_namespaces()
    with pytest.raises(ValueError, match="reserved"):
        pdb.define_index(NS, ["a\x1fb"])
