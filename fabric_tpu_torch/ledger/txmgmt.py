"""Transaction management: the simulator that builds read-write sets, and
MVCC validation of a block's read-write sets (the port's copy of
`fabric_tpu/ledger/txmgmt.py`).

Reference: core/ledger/kvledger/txmgmt (rwsetutil/rwset_builder.go, the
lockbased_txmgr simulator, and validation/validator.go:82-260
validateAndPrepareBatch, validateKVRead, validateRangeQuery).  A
transaction sees conflicts against committed state and against the
writes of the earlier valid transactions of its block.  The read-write
sets are written by the port's codec, byte for byte as `upb` writes the
JAX package's.
"""

from __future__ import annotations

import time

from fabric_tpu_torch.common import workpool
from fabric_tpu_torch.common.hashing import sha256 as _sha256
from fabric_tpu_torch.ledger import richquery
from fabric_tpu_torch.ledger.statedb import Height, VersionedDB, VersionedValue
from fabric_tpu_torch.protos import peer as pb
from fabric_tpu_torch.protos import rwset as rw
from fabric_tpu_torch.protos.wire import DecodeError

VALID = pb.VALID
MVCC_READ_CONFLICT = pb.MVCC_READ_CONFLICT
PHANTOM_READ_CONFLICT = pb.PHANTOM_READ_CONFLICT
BAD_RWSET = pb.BAD_RWSET

# a key's state-based endorsement policy lives in its metadata under this
# entry (reference core/ledger/kvledger/txmgmt/statemetadata)
VALIDATION_PARAMETER = "VALIDATION_PARAMETER"


# A collection's private and hashed keys live in the same VersionedDB under
# derived namespaces ('\x00' cannot appear in a chaincode name).
def pvt_ns(ns: str, coll: str) -> str:
    return f"{ns}\x00pvt\x00{coll}"


def hash_ns(ns: str, coll: str) -> str:
    """The namespace of collection `coll`'s hashed keys in `ns`."""
    return f"{ns}\x00hash\x00{coll}"


def key_hash(key: str) -> bytes:
    return _sha256(key.encode())


def value_hash(value: bytes) -> bytes:
    return _sha256(value)


def encode_metadata(entries: dict[str, bytes]) -> bytes:
    """A key's metadata entries as a StateMetadataResult, names sorted."""
    return pb.StateMetadataResult(entries=[
        pb.StateMetadata(metakey=name, value=entries[name])
        for name in sorted(entries)]).encode()


def decode_metadata(raw: bytes) -> dict[str, bytes]:
    if not raw:
        return {}
    return {e.metakey: e.value
            for e in pb.StateMetadataResult.decode(raw).entries}


def _height_of(v) -> Height | None:
    return None if v is None else Height(v.block_num, v.tx_num)


def _read_version(read) -> Height | None:
    return _height_of(read.version) if read.has("version") else None


def _version_msg(h: Height | None) -> dict:
    """The `version` keyword of a KVRead or KVReadHash: none for an absent
    key, as the reference leaves the field unset."""
    if h is None:
        return {}
    return {"version": rw.Version(block_num=h.block_num, tx_num=h.tx_num)}


class TxSimulator:
    """Collects a read-write set while chaincode reads and writes state
    (reference TxSimulator, core/ledger/ledger_interface.go:270)."""

    def __init__(self, db: VersionedDB):
        self._db = db
        self._reads: dict[tuple[str, str], Height | None] = {}
        self._writes: dict[tuple[str, str], bytes | None] = {}
        self._range_queries: list[tuple[str, rw.RangeQueryInfo]] = []
        # private data: reads are recorded against the hashed key space
        # (what peers outside the collection validate); a write becomes a
        # hashed write in the transaction and a cleartext write beside it
        self._pvt_reads: dict[tuple[str, str, str], Height | None] = {}
        self._pvt_writes: dict[tuple[str, str, str], bytes | None] = {}
        # metadata writes carry a key's whole entry map: SetStateMetadata
        # is a per-entry upsert, merged here with the committed map
        self._meta_writes: dict[tuple[str, str], dict[str, bytes]] = {}
        self._pvt_meta_writes: dict[tuple[str, str, str],
                                    dict[str, bytes]] = {}
        self._done = False

    def get_state(self, ns: str, key: str) -> bytes | None:
        if (ns, key) in self._writes:
            return self._writes[(ns, key)]
        vv = self._db.get_state(ns, key)
        self._reads.setdefault((ns, key), vv.version if vv else None)
        return vv.value if vv else None

    def set_state(self, ns: str, key: str, value: bytes) -> None:
        self._writes[(ns, key)] = value

    def delete_state(self, ns: str, key: str) -> None:
        self._writes[(ns, key)] = None

    def get_state_metadata(self, ns: str, key: str) -> dict[str, bytes]:
        """A key's committed metadata entries (reference GetStateMetadata);
        records no read: the key-level validator checks metadata, not
        MVCC."""
        if (ns, key) in self._meta_writes:
            return dict(self._meta_writes[(ns, key)])
        vv = self._db.get_state(ns, key)
        return decode_metadata(vv.metadata) if vv else {}

    def set_state_metadata(self, ns: str, key: str,
                           entries: dict[str, bytes]) -> None:
        """Merge entries into the key's metadata (reference
        SetStateMetadata upserts per entry)."""
        cur = self.get_state_metadata(ns, key)
        cur.update(entries)
        self._meta_writes[(ns, key)] = cur

    def delete_state_metadata(self, ns: str, key: str, name: str) -> None:
        cur = self.get_state_metadata(ns, key)
        cur.pop(name, None)
        self._meta_writes[(ns, key)] = cur

    def get_private_data_metadata(self, ns: str, coll: str,
                                  key: str) -> dict[str, bytes]:
        if (ns, coll, key) in self._pvt_meta_writes:
            return dict(self._pvt_meta_writes[(ns, coll, key)])
        vv = self._db.get_state(hash_ns(ns, coll), key_hash(key).hex())
        return decode_metadata(vv.metadata) if vv else {}

    def set_private_data_metadata(self, ns: str, coll: str, key: str,
                                  entries: dict[str, bytes]) -> None:
        cur = self.get_private_data_metadata(ns, coll, key)
        cur.update(entries)
        self._pvt_meta_writes[(ns, coll, key)] = cur

    def get_private_data(self, ns: str, coll: str, key: str) -> bytes | None:
        if (ns, coll, key) in self._pvt_writes:
            return self._pvt_writes[(ns, coll, key)]
        # the hashed key space is keyed by hex(sha256(key)); its version
        # is what peers outside the collection validate
        hv = self._db.get_state(hash_ns(ns, coll), key_hash(key).hex())
        self._pvt_reads.setdefault((ns, coll, key),
                                   hv.version if hv else None)
        vv = self._db.get_state(pvt_ns(ns, coll), key)
        return vv.value if vv else None

    def set_private_data(self, ns: str, coll: str, key: str,
                         value: bytes) -> None:
        self._pvt_writes[(ns, coll, key)] = value

    def delete_private_data(self, ns: str, coll: str, key: str) -> None:
        self._pvt_writes[(ns, coll, key)] = None

    def get_private_data_hash(self, ns: str, coll: str, key: str):
        """A hash-only read, allowed outside the collection (reference
        GetPrivateDataHash); records no read."""
        vv = self._db.get_state(hash_ns(ns, coll), key_hash(key).hex())
        return vv.value if vv else None

    def get_private_data_range(self, ns: str, coll: str, start: str,
                               end: str):
        """[(key, value)] over the private key space; as in the reference,
        a private range query records no phantom protection."""
        return [(key, vv.value) for key, vv in
                self._db.get_state_range(pvt_ns(ns, coll), start, end)]

    def get_query_result(self, ns: str, query: str):
        """A rich JSON-selector query (reference GetQueryResult on the
        CouchDB backend), on an index where one serves it, else a scan.
        Every returned key enters the read set (reference queryHelper);
        phantoms go unprotected, as the reference's CouchDB caveat says."""
        got = richquery.execute_query_indexed(self._db, ns, query)
        if got is not None:
            out = []
            for key, value, version in got:
                self._reads.setdefault((ns, key), version)
                out.append((key, value))
            return out
        versions = {}

        def pairs():
            for key, vv in self._db.get_state_range(ns, "", ""):
                versions[key] = vv.version
                yield key, vv.value

        out = richquery.execute_query(pairs(), query)
        for key, _ in out:
            self._reads.setdefault((ns, key), versions[key])
        return out

    def get_private_data_query_result(self, ns: str, coll: str, query: str):
        pairs = ((key, vv.value) for key, vv in
                 self._db.get_state_range(pvt_ns(ns, coll), "", ""))
        return richquery.execute_query(pairs, query)

    def get_state_range(self, ns: str, start: str, end: str):
        """[(key, value)]; the range query is recorded with its raw reads
        for phantom detection at validation."""
        reads, out = [], []
        for key, vv in self._db.get_state_range(ns, start, end):
            reads.append(rw.KVRead(key=key, **_version_msg(vv.version)))
            out.append((key, vv.value))
        # an empty range leaves `raw_reads` unset, as the reference does
        extra = {"raw_reads": rw.QueryReads(kv_reads=reads)} if reads else {}
        self._range_queries.append((ns, rw.RangeQueryInfo(
            start_key=start, end_key=end, itr_exhausted=True, **extra)))
        return out

    @staticmethod
    def _kv_write(key: str, value: bytes | None) -> rw.KVWrite:
        return rw.KVWrite(key=key, is_delete=value is None,
                          value=value or b"")

    def _pvt_collection_rwsets(self) -> dict[str, dict[str, bytes]]:
        """{ns: {coll: marshaled private KVRWSet}} of the collections with
        private writes."""
        per_coll: dict[tuple[str, str], list] = {}
        for (ns, coll, key), value in sorted(self._pvt_writes.items()):
            per_coll.setdefault((ns, coll), []).append(
                self._kv_write(key, value))
        out: dict[str, dict[str, bytes]] = {}
        for (ns, coll), writes in per_coll.items():
            out.setdefault(ns, {})[coll] = rw.KVRWSet(writes=writes).encode()
        return out

    def get_tx_simulation_results(self) -> bytes:
        """The marshaled TxReadWriteSet: public reads and writes, and per
        collection touched, the hashed read-write set and the hash of the
        private one (reference rwset_builder.go GetTxSimulationResults)."""
        self._done = True
        by_ns: dict[str, dict[str, list]] = {}

        def ns_set(ns: str) -> dict[str, list]:
            return by_ns.setdefault(ns, {
                "reads": [], "range_queries_info": [], "writes": [],
                "metadata_writes": []})

        for (ns, key), ver in sorted(self._reads.items()):
            ns_set(ns)["reads"].append(rw.KVRead(key=key,
                                                 **_version_msg(ver)))
        for ns, rqi in self._range_queries:
            ns_set(ns)["range_queries_info"].append(rqi)
        for (ns, key), value in sorted(self._writes.items()):
            ns_set(ns)["writes"].append(self._kv_write(key, value))
        for (ns, key), entries in sorted(self._meta_writes.items()):
            ns_set(ns)["metadata_writes"].append(rw.KVMetadataWrite(
                key=key, entries=[rw.KVMetadataEntry(name=n, value=entries[n])
                                  for n in sorted(entries)]))

        # the hashed read-write set of each (ns, collection)
        hashed: dict[tuple[str, str], dict[str, list]] = {}

        def coll_set(ns: str, coll: str) -> dict[str, list]:
            return hashed.setdefault((ns, coll), {
                "hashed_reads": [], "hashed_writes": [],
                "metadata_writes": []})

        for (ns, coll, key), ver in sorted(self._pvt_reads.items()):
            coll_set(ns, coll)["hashed_reads"].append(rw.KVReadHash(
                key_hash=key_hash(key), **_version_msg(ver)))
        for (ns, coll, key), value in sorted(self._pvt_writes.items()):
            coll_set(ns, coll)["hashed_writes"].append(rw.KVWriteHash(
                key_hash=key_hash(key), is_delete=value is None,
                value_hash=value_hash(value) if value is not None else b""))
        for (ns, coll, key), entries in sorted(self._pvt_meta_writes.items()):
            coll_set(ns, coll)["metadata_writes"].append(
                rw.KVMetadataWriteHash(key_hash=key_hash(key), entries=[
                    rw.KVMetadataEntry(name=n, value=entries[n])
                    for n in sorted(entries)]))

        pvt = self._pvt_collection_rwsets()
        ns_rwsets = []
        for ns in sorted(set(by_ns) | {ns for ns, _ in hashed}):
            colls = []
            for (hns, coll), hrw in sorted(hashed.items()):
                if hns != ns:
                    continue
                pvt_bytes = pvt.get(ns, {}).get(coll)
                colls.append(rw.CollectionHashedReadWriteSet(
                    collection_name=coll,
                    hashed_rwset=rw.HashedRWSet(**hrw).encode(),
                    pvt_rwset_hash=(_sha256(pvt_bytes)
                                    if pvt_bytes is not None else b"")))
            kv = by_ns.get(ns)
            ns_rwsets.append(rw.NsReadWriteSet(
                namespace=ns,
                rwset=rw.KVRWSet(**kv).encode() if kv else b"",
                collection_hashed_rwset=colls))
        return rw.TxReadWriteSet(data_model=rw.TxReadWriteSet.KV,
                                 ns_rwset=ns_rwsets).encode()

    def get_pvt_simulation_results(self) -> bytes | None:
        """The marshaled TxPvtReadWriteSet of the cleartext private
        writes, or None where the transaction touched no collection.  It
        never enters the transaction (the transient store and gossip
        carry it)."""
        pvt = self._pvt_collection_rwsets()
        if not pvt:
            return None
        return rw.TxPvtReadWriteSet(
            data_model=rw.TxReadWriteSet.KV,
            ns_pvt_rwset=[rw.NsPvtReadWriteSet(
                namespace=ns,
                collection_pvt_rwset=[rw.CollectionPvtReadWriteSet(
                    collection_name=coll, rwset=pvt[ns][coll])
                    for coll in sorted(pvt[ns])])
                for ns in sorted(pvt)]).encode()


def parse_rwset(raw: bytes) -> list:
    """[(ns, KVRWSet, [(coll, HashedRWSet, pvt_rwset_hash)])]: the decode
    the validator's footprint carries (`RwsetFootprint.parsed`)."""
    out = []
    for nsrw in rw.TxReadWriteSet.decode(raw).ns_rwset:
        out.append((nsrw.namespace, rw.KVRWSet.decode(nsrw.rwset), [
            (ch.collection_name, rw.HashedRWSet.decode(ch.hashed_rwset),
             ch.pvt_rwset_hash)
            for ch in nsrw.collection_hashed_rwset]))
    return out


# a block of fewer write operations prepares serially whatever the width:
# the chunks would cost more than they save
_PARALLEL_MIN_WRITES = 32


class MVCCValidator:
    """Block-level MVCC validation that builds the state update batch
    (reference validator.go:82 validateAndPrepareBatch), in two passes:

    1. **check**, serial in commit order: the read, range and hashed-read
       conflict checks and the block's version bookkeeping, whose results
       feed the later transactions' checks;
    2. **prepare**, per top-level namespace: the batch
       {ns: {key: VersionedValue | None}}, with metadata kept and
       cleartext private writes applied.  A namespace group owns its
       derived hash and pvt namespaces, so no two groups write one batch
       key, and the merge puts the namespaces in the order the serial
       loop meets them: flags and batch are the same at every width.

    `fanout` chunks the groups across `pool` (default: the process
    workpool); None reads FABRIC_TPU_MVCC_POOL, 0 keeps the prepare
    serial.  The preload fans out per namespace at the same width."""

    def __init__(self, db: VersionedDB, pool=None, fanout: int | None = None):
        self._db = db
        self._pool = pool
        if fanout is None:
            fanout = workpool.stage_width("FABRIC_TPU_MVCC_POOL")
        self._fanout = max(0, fanout)
        # seconds of the last call's stages: preload, check, prepare (the
        # ledger adds them to commit_stage_seconds as mvcc_*)
        self.last_stage_seconds: dict[str, float] = {}
        # blocks whose prepare fanned out
        self.parallel_prepare_blocks = 0

    @property
    def fanout(self) -> int:
        return self._fanout

    def _committed_version(self, ns: str, key: str, updates: dict,
                           cache: dict) -> Height | None:
        if (ns, key) in updates:
            return updates[(ns, key)]
        if (ns, key) in cache:
            vv = cache[(ns, key)]
            return None if vv is None else vv.version
        return self._db.get_version(ns, key)

    def _preload(self, parsed_per_tx: list) -> dict:
        """The block's whole point read set in get_state_many round trips:
        every read key and hashed read, and, in namespaces that may carry
        metadata, every written key (a value write keeps the key's
        metadata).  Range queries are scanned, not preloaded.  A cache
        entry of None means known absent.  With a width and enough keys,
        each namespace is one round trip on the pool."""
        keys: list[tuple[str, str]] = []
        may_meta: dict[str, bool] = {}

        def meta(ns: str) -> bool:
            got = may_meta.get(ns)
            if got is None:
                got = may_meta[ns] = self._db.may_have_metadata(ns)
            return got

        for parsed in parsed_per_tx:
            if not parsed:
                continue
            for ns, kvrw, colls in parsed:
                keys.extend((ns, r.key) for r in kvrw.reads)
                if meta(ns):
                    keys.extend((ns, w.key) for w in kvrw.writes)
                    keys.extend((ns, mw.key) for mw in kvrw.metadata_writes)
                for coll, hrw, _ in colls:
                    hns = hash_ns(ns, coll)
                    keys.extend((hns, hr.key_hash.hex())
                                for hr in hrw.hashed_reads)
                    if meta(hns):
                        keys.extend((hns, hw.key_hash.hex())
                                    for hw in hrw.hashed_writes)
                        keys.extend((hns, mw.key_hash.hex())
                                    for mw in hrw.metadata_writes)
        if not keys:
            return {}
        width = self._fanout
        if width > 1 and len(keys) >= 2 * _PARALLEL_MIN_WRITES:
            by_ns: dict[str, list] = {}
            for pair in keys:
                by_ns.setdefault(pair[0], []).append(pair)
            if len(by_ns) >= 2:
                # the namespace is part of every key: the groups are
                # disjoint, and their maps merge to the one round trip's
                maps = workpool.run_chunked(
                    self._pool or workpool.default_pool(),
                    lambda off, chunk: [self._db.get_state_many(pairs)
                                        for pairs in chunk],
                    list(by_ns.values()), min(width, len(by_ns)))
                merged: dict = {}
                for m in maps:
                    merged.update(m)
                return merged
        return self._db.get_state_many(keys)

    def validate_and_prepare(self, block_num: int, rwsets: list,
                             flags: list[int],
                             pvt_data: dict[int, bytes] | None = None,
                             footprints: list | None = None) -> dict:
        """rwsets[i]: the marshaled TxReadWriteSet of transaction i (None:
        not an endorser transaction).  Sets the MVCC codes in `flags` and
        returns the update batch {ns: {key: VersionedValue | None}}.

        pvt_data maps a transaction's number to its marshaled
        TxPvtReadWriteSet; a collection's cleartext writes apply only
        where the cleartext hashes to the endorsed pvt_rwset_hash.
        footprints[i], when given, is the validator's RwsetFootprint, whose
        `.parsed` is this method's own decode."""
        pvt_data = pvt_data or {}
        parsed_per_tx: list = [None] * len(rwsets)
        for tx_num, raw in enumerate(rwsets):
            if flags[tx_num] != VALID or raw is None:
                continue
            fp = footprints[tx_num] if footprints is not None else None
            if fp is not None:
                parsed_per_tx[tx_num] = fp.parsed
                continue
            try:
                parsed_per_tx[tx_num] = parse_rwset(raw)
            except DecodeError:
                flags[tx_num] = BAD_RWSET
        t = time.perf_counter
        t0 = t()
        cache = self._preload(parsed_per_tx)
        t1 = t()

        # pass 1: conflict checks and the block's version bookkeeping
        # (updated_versions: every in-block write's version, None for a
        # delete).  Pass 2's work is grouped by the parsed entry's
        # (top-level) namespace; ns_order keeps the serial loop's order of
        # the batch's namespaces and ns_owner the group of each.
        updated_versions: dict[tuple[str, str], Height | None] = {}
        ns_order: list[str] = []
        ns_owner: dict[str, str] = {}
        groupwork: dict[str, list] = {}
        all_items: list = []  # every item in (tx, entry) order
        collided = False
        n_writes = 0

        def order(ns: str, owner: str) -> None:
            # the owner is recorded, never derived from the string: a
            # crafted rwset may name a top-level namespace that equals
            # another's derived hash or pvt namespace.  Then two groups
            # share a batch key, and pass 2 runs one serial group over
            # every item, as a single batch dict would.
            nonlocal collided
            if ns not in ns_owner:
                ns_owner[ns] = owner
                ns_order.append(ns)
            elif ns_owner[ns] != owner:
                collided = True

        for tx_num, parsed in enumerate(parsed_per_tx):
            if parsed is None or flags[tx_num] != VALID:
                continue
            code = self._check_tx(parsed, updated_versions, cache)
            flags[tx_num] = code
            if code != VALID:
                continue
            h = Height(block_num, tx_num)
            pvt_by_coll = self._parse_pvt(pvt_data.get(tx_num))
            # cleartext that hashes to the endorsed pvt_rwset_hash (an
            # empty endorsed hash means none was endorsed); pass 2 applies
            # it without hashing again
            pvt_ok: dict = {}
            for ns, kvrw, colls in parsed:
                order(ns, ns)
                item = (h, ns, kvrw, colls, pvt_ok)
                groupwork.setdefault(ns, []).append(item)
                all_items.append(item)
                for w in kvrw.writes:
                    n_writes += 1
                    updated_versions[(ns, w.key)] = None if w.is_delete else h
                for mw in kvrw.metadata_writes:
                    n_writes += 1
                    self._meta_write_version(ns, mw.key, h, updated_versions,
                                             cache)
                for coll, hrw, expected_hash in colls:
                    hns = hash_ns(ns, coll)
                    order(hns, ns)
                    for hw in hrw.hashed_writes:
                        n_writes += 1
                        updated_versions[(hns, hw.key_hash.hex())] = (
                            None if hw.is_delete else h)
                    for mw in hrw.metadata_writes:
                        n_writes += 1
                        self._meta_write_version(hns, mw.key_hash.hex(), h,
                                                 updated_versions, cache)
                    clear = pvt_by_coll.get((ns, coll))
                    if (clear is not None and expected_hash
                            and _sha256(clear[0]) == expected_hash):
                        pvt_ok[(ns, coll)] = clear
                        order(pvt_ns(ns, coll), ns)
        t2 = t()

        # pass 2: the write-set prepare, per namespace group
        if collided:
            groups = [("", all_items)]
        else:
            groups = list(groupwork.items())
        width = self._fanout
        if width > 1 and len(groups) >= 2 and n_writes >= _PARALLEL_MIN_WRITES:
            # fill the metadata-namespace cache on this thread, so that the
            # workers only read it
            self._db.may_have_metadata("")
            width = min(width, len(groups))
            self.parallel_prepare_blocks += 1
            pool = self._pool or workpool.default_pool()
        else:
            width, pool = 1, None
        maps = workpool.run_chunked(
            pool, lambda off, chunk: self._prepare_groups(chunk, cache),
            groups, width)
        if collided:
            batch = {ns: maps[0].get(ns, {}) for ns in ns_order}
        else:
            by_group = {gns: m for (gns, _), m in zip(groups, maps)}
            batch = {ns: by_group[ns_owner[ns]].get(ns, {})
                     for ns in ns_order}
        self.last_stage_seconds = {
            "preload": t1 - t0, "check": t2 - t1, "prepare": t() - t2}
        return batch

    def _prepare_groups(self, groups: list, cache: dict) -> list[dict]:
        """Pass 2 for a chunk of namespace groups: each group's items in
        commit order into a batch dict of its own."""
        out = []
        for _ns, items in groups:
            m: dict[str, dict] = {}
            for h, ns, kvrw, colls, pvt_ok in items:
                self._build_ns_writes(ns, kvrw, colls, h, pvt_ok, m, cache)
            out.append(m)
        return out

    def _check_tx(self, parsed, updated_versions, cache) -> int:
        for ns, kvrw, colls in parsed:
            for read in kvrw.reads:
                if _read_version(read) != self._committed_version(
                        ns, read.key, updated_versions, cache):
                    return MVCC_READ_CONFLICT
            for rqi in kvrw.range_queries_info:
                if not self._validate_range_query(ns, rqi, updated_versions):
                    return PHANTOM_READ_CONFLICT
            for coll, hrw, _ in colls:
                hns = hash_ns(ns, coll)
                for hread in hrw.hashed_reads:
                    if _read_version(hread) != self._committed_version(
                            hns, hread.key_hash.hex(), updated_versions,
                            cache):
                        return MVCC_READ_CONFLICT
        return VALID

    def _build_ns_writes(self, ns, kvrw, colls, h, pvt_ok, out,
                         cache) -> None:
        """One transaction's writes for one namespace entry."""
        ns_batch = out.setdefault(ns, {})
        for w in kvrw.writes:
            if w.is_delete:
                ns_batch[w.key] = None
            else:
                # a value write keeps the key's metadata (reference tx_ops)
                ns_batch[w.key] = VersionedValue(
                    w.value, h,
                    self._existing_metadata(ns, w.key, ns_batch, cache))
        for mw in kvrw.metadata_writes:
            self._apply_metadata_write(
                ns, mw.key, {e.name: e.value for e in mw.entries},
                ns_batch, h, cache)
        for coll, hrw, _ in colls:
            hns = hash_ns(ns, coll)
            h_batch = out.setdefault(hns, {})
            for hw in hrw.hashed_writes:
                hkey = hw.key_hash.hex()
                if hw.is_delete:
                    h_batch[hkey] = None
                else:
                    h_batch[hkey] = VersionedValue(
                        hw.value_hash, h,
                        self._existing_metadata(hns, hkey, h_batch, cache))
            for mw in hrw.metadata_writes:
                self._apply_metadata_write(
                    hns, mw.key_hash.hex(),
                    {e.name: e.value for e in mw.entries}, h_batch, h, cache)
            clear = pvt_ok.get((ns, coll))
            if clear is None:
                continue
            p_batch = out.setdefault(pvt_ns(ns, coll), {})
            for w in clear[1].writes:
                p_batch[w.key] = None if w.is_delete else VersionedValue(
                    w.value, h)

    def _meta_write_version(self, ns, key, h, updated_versions,
                            cache) -> None:
        """A metadata write bumps the key's version only when the key
        exists (an earlier in-block write that was no delete, else
        committed state)."""
        if (ns, key) in updated_versions:
            if updated_versions[(ns, key)] is None:
                return  # deleted earlier in the block
        else:
            if (ns, key) in cache:
                vv = cache[(ns, key)]
            else:
                vv = cache[(ns, key)] = self._db.get_state(ns, key)
            if vv is None:
                return  # absent: the metadata write does nothing
        updated_versions[(ns, key)] = h

    def _existing_metadata(self, ns: str, key: str, ns_batch: dict,
                           cache: dict) -> bytes:
        """A key's current metadata: the block's writes first, then
        committed state; empty for new or deleted keys."""
        if key in ns_batch:
            base = ns_batch[key]
            return base.metadata if base is not None else b""
        if not self._db.may_have_metadata(ns):
            return b""
        if (ns, key) in cache:
            vv = cache[(ns, key)]
        else:
            vv = self._db.get_state(ns, key)
        return vv.metadata if vv is not None else b""

    def _apply_metadata_write(self, ns: str, key: str,
                              entries: dict[str, bytes], ns_batch: dict,
                              h: Height, cache: dict) -> None:
        """Replace a key's metadata, keeping its value; a no-op on an
        absent or deleted key."""
        if key in ns_batch:
            base = ns_batch[key]
        elif (ns, key) in cache:
            base = cache[(ns, key)]
        else:
            base = self._db.get_state(ns, key)
        if base is None:
            return
        ns_batch[key] = VersionedValue(base.value, h,
                                       encode_metadata(entries))

    @staticmethod
    def _parse_pvt(raw: bytes | None) -> dict:
        """{(ns, coll): (KVRWSet bytes, KVRWSet)}; unparsable cleartext
        gives nothing (the hashed writes still record the keys)."""
        out: dict = {}
        if not raw:
            return out
        try:
            for nsp in rw.TxPvtReadWriteSet.decode(raw).ns_pvt_rwset:
                for cp in nsp.collection_pvt_rwset:
                    out[(nsp.namespace, cp.collection_name)] = (
                        cp.rwset, rw.KVRWSet.decode(cp.rwset))
        except DecodeError:
            return {}
        return out

    def _validate_range_query(self, ns: str, rqi, updated_versions) -> bool:
        """Re-scan the range and compare with the recorded raw reads
        (reference validateRangeQuery; a Merkle summary fails)."""
        if rqi.which("reads_info") == "reads_merkle_hashes":
            return False
        current: list[tuple[str, Height | None]] = []
        seen = set()
        for key, vv in self._db.get_state_range(ns, rqi.start_key,
                                                rqi.end_key):
            ver = updated_versions.get((ns, key), vv.version)
            if ver is not None:
                current.append((key, ver))
                seen.add(key)
        # keys that earlier transactions of the block created in the range
        # are phantoms too
        for (uns, ukey), uver in updated_versions.items():
            if uns != ns or ukey in seen or uver is None:
                continue
            if rqi.start_key <= ukey and (not rqi.end_key
                                          or ukey < rqi.end_key):
                current.append((ukey, uver))
        current.sort()
        recorded = [(r.key, _read_version(r))
                    for r in rqi.raw_reads.kv_reads]
        return current == recorded


__all__ = [
    "TxSimulator", "MVCCValidator", "VALID", "MVCC_READ_CONFLICT", "PHANTOM_READ_CONFLICT",
    "BAD_RWSET", "pvt_ns", "hash_ns", "key_hash", "value_hash",
    "VALIDATION_PARAMETER", "encode_metadata", "decode_metadata",
    "parse_rwset",
]
