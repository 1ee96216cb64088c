"""MVCC validation of a block's read-write sets (the port's copy of
`fabric_tpu/ledger/txmgmt.py`: its naming helpers and the serial path of
`MVCCValidator`).

Reference: core/ledger/kvledger/txmgmt/validation/validator.go:82-260
(validateAndPrepareBatch, validateKVRead, validateRangeQuery).  A
transaction sees conflicts against committed state and against the
writes of the earlier valid transactions of its block.  The JAX package's
fan-out of the write-set prepare over a worker pool, and the simulator
that builds read-write sets for the endorser, are not ported.
"""

from __future__ import annotations

import time

from fabric_tpu_torch.common.hashing import sha256 as _sha256
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


class MVCCValidator:
    """Block-level MVCC validation that builds the state update batch
    (reference validator.go:82 validateAndPrepareBatch), in two passes as
    in the JAX package: the conflict checks with the block's version
    bookkeeping, in commit order, then the write-set prepare, whose batch
    holds its namespaces in the order the first pass met them."""

    def __init__(self, db: VersionedDB):
        self._db = db
        # seconds of the last call's stages: preload, check, prepare (the
        # ledger adds them to commit_stage_seconds as mvcc_*)
        self.last_stage_seconds: dict[str, float] = {}

    def _committed_version(self, ns: str, key: str, updates: dict,
                           cache: dict) -> Height | None:
        if (ns, key) in updates:
            return updates[(ns, key)]
        if (ns, key) in cache:
            vv = cache[(ns, key)]
            return None if vv is None else vv.version
        return self._db.get_version(ns, key)

    def _preload(self, parsed_per_tx: list) -> dict:
        """The block's whole point read set in one get_state_many: every
        read key and hashed read, and, in namespaces that may carry
        metadata, every written key (a value write keeps the key's
        metadata).  Range queries are scanned, not preloaded.  A cache
        entry of None means known absent."""
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
        return self._db.get_state_many(keys) if keys else {}

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
        # delete); each valid transaction's entries are queued for pass 2
        updated_versions: dict[tuple[str, str], Height | None] = {}
        ns_order: list[str] = []
        seen_ns: set[str] = set()
        items: list = []

        def order(ns: str) -> None:
            if ns not in seen_ns:
                seen_ns.add(ns)
                ns_order.append(ns)

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
            # empty endorsed hash means none was endorsed)
            pvt_ok: dict = {}
            for ns, kvrw, colls in parsed:
                order(ns)
                items.append((h, ns, kvrw, colls, pvt_ok))
                for w in kvrw.writes:
                    updated_versions[(ns, w.key)] = None if w.is_delete else h
                for mw in kvrw.metadata_writes:
                    self._meta_write_version(ns, mw.key, h, updated_versions,
                                             cache)
                for coll, hrw, expected_hash in colls:
                    hns = hash_ns(ns, coll)
                    order(hns)
                    for hw in hrw.hashed_writes:
                        updated_versions[(hns, hw.key_hash.hex())] = (
                            None if hw.is_delete else h)
                    for mw in hrw.metadata_writes:
                        self._meta_write_version(hns, mw.key_hash.hex(), h,
                                                 updated_versions, cache)
                    clear = pvt_by_coll.get((ns, coll))
                    if (clear is not None and expected_hash
                            and _sha256(clear[0]) == expected_hash):
                        pvt_ok[(ns, coll)] = clear
                        order(pvt_ns(ns, coll))
        t2 = t()

        # pass 2: the write-set prepare
        out: dict[str, dict] = {}
        for h, ns, kvrw, colls, pvt_ok in items:
            self._build_ns_writes(ns, kvrw, colls, h, pvt_ok, out, cache)
        batch = {ns: out.get(ns, {}) for ns in ns_order}
        self.last_stage_seconds = {
            "preload": t1 - t0, "check": t2 - t1, "prepare": t() - t2}
        return batch

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
    "MVCCValidator", "VALID", "MVCC_READ_CONFLICT", "PHANTOM_READ_CONFLICT",
    "BAD_RWSET", "pvt_ns", "hash_ns", "key_hash", "value_hash",
    "VALIDATION_PARAMETER", "encode_metadata", "decode_metadata",
    "parse_rwset",
]
