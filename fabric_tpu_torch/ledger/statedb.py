"""Versioned state database with rich-query indexes (the port's copy of
`fabric_tpu/ledger/statedb.py`).

Reference SPI: core/ledger/kvledger/txmgmt/statedb/statedb.go (GetState,
GetStateMultipleKeys, GetStateRangeScanIterator, ApplyUpdates with a
savepoint height), over the KVStore SPI.  Keys and values are encoded as
the JAX package encodes them, byte for byte:

    \\x02 ns \\x00 key  ->  Height.pack() | len(metadata) >I | metadata | value
    \\x01savepoint       ->  Height.pack()
    \\x03 ns \\x00 field \\x00 enc(value) \\x00 key  ->  b"" (an index entry)
    \\x04 ns \\x00 field ->  b"" (an index definition)
    \\x05metans          ->  JSON list of namespaces that ever stored metadata

An index on (ns, field), the CouchDB backend's index-backed Mango query
(statecouchdb.go:53), keeps order-preserving entries in the same store,
so an indexed selector runs as a range scan; `apply_updates` maintains
them in its one write batch.  `enc` is a type-tagged order-preserving
encoding (null < bool < number < string); the planner in `richquery`
rechecks every candidate document, so an index only has to over-select.
"""

from __future__ import annotations

import dataclasses
import json
import struct

from fabric_tpu_torch.ledger.kvstore import KVStore, NamedDB


@dataclasses.dataclass(frozen=True, order=True)
class Height:
    """Commit height (block, tx): the MVCC version (reference
    txmgmt/version/version.go)."""

    block_num: int
    tx_num: int

    def pack(self) -> bytes:
        return struct.pack(">QQ", self.block_num, self.tx_num)

    @classmethod
    def unpack(cls, raw: bytes) -> "Height":
        b, t = struct.unpack(">QQ", raw)
        return cls(b, t)


@dataclasses.dataclass
class VersionedValue:
    value: bytes
    version: Height
    metadata: bytes = b""


_NS_SEP = b"\x00"
_SAVEPOINT_KEY = b"\x01savepoint"
_IDX_PREFIX = b"\x03"
_IDX_DEF_PREFIX = b"\x04"
_META_NS_KEY = b"\x05metans"

# the separator of a compound index's fields ("color\x1fsize"): the unit
# separator never appears in a JSON field path
INDEX_SPEC_SEP = "\x1f"


def _state_key(ns: str, key: str) -> bytes:
    return b"\x02" + ns.encode() + _NS_SEP + key.encode()


def _esc(raw: bytes) -> bytes:
    """Order-preserving escape, so that \x00 can end a component."""
    return raw.replace(b"\x00", b"\x00\xff")


def encode_scalar(v) -> bytes | None:
    """The type-tagged order-preserving encoding of a JSON scalar; None
    for objects and arrays, which no index holds."""
    if v is None:
        return b"\x01"
    if isinstance(v, bool):
        return b"\x02" + (b"\x01" if v else b"\x00")
    if isinstance(v, (int, float)):
        f = float(v)
        if f == 0.0:
            f = 0.0  # -0.0 == 0.0 in Python, so their keys must agree
        bits = struct.unpack(">Q", struct.pack(">d", f))[0]
        # IEEE 754 total order: flip the sign bit of a positive number,
        # every bit of a negative one
        bits = (bits ^ 0x8000000000000000 if bits < 1 << 63
                else ~bits & (1 << 64) - 1)
        return b"\x03" + struct.pack(">Q", bits)
    if isinstance(v, str):
        return b"\x04" + _esc(v.encode("utf-8"))
    return None


def encode_composite(values) -> bytes | None:
    """The order-preserving concatenation of scalar encodings of a
    compound index entry; None when a component cannot be indexed.  A
    string component ends with \x00 (its escaped content holds no bare
    \x00), which both delimits it and keeps the concatenation in tuple
    order: ("ab", y) < ("abc", x) for every y and x."""
    parts = []
    for v in values:
        e = encode_scalar(v)
        if e is None:
            return None
        if e[:1] == b"\x04":
            e += b"\x00"
        parts.append(e)
    return b"".join(parts)


def _idx_entry_state_key(rest: bytes, n_components: int = 1) -> str | None:
    """The state key of an index entry's tail `enc \x00 key` (after the
    ns and field prefix).  The encoding's length comes from its type tag:
    number encodings and state keys may hold \x00, so a plain split would
    misparse.  `n_components` > 1 reads a compound entry."""
    pos = 0
    for _ in range(n_components):
        tag = rest[pos:pos + 1]
        if tag == b"\x01":
            ln = 1
        elif tag == b"\x02":
            ln = 2
        elif tag == b"\x03":
            ln = 9
        elif tag == b"\x04":  # an escaped string ends at the first bare \x00
            i = pos + 1
            while True:
                j = rest.find(b"\x00", i)
                if j < 0:
                    return None
                if rest[j + 1:j + 2] == b"\xff":
                    i = j + 2
                    continue
                break
            ln = j - pos
            if n_components > 1:
                ln += 1  # a compound entry's strings keep their terminator
        else:
            return None
        pos += ln
    if rest[pos:pos + 1] != b"\x00":
        return None
    try:
        return rest[pos + 1:].decode()
    except UnicodeDecodeError:
        return None


def _idx_key(ns: str, field: str, enc: bytes, key: str) -> bytes:
    return (_IDX_PREFIX + _esc(ns.encode()) + b"\x00" + _esc(field.encode())
            + b"\x00" + enc + b"\x00" + key.encode())


def _idx_prefix(ns: str, field: str, enc: bytes = b"") -> bytes:
    return (_IDX_PREFIX + _esc(ns.encode()) + b"\x00" + _esc(field.encode())
            + b"\x00" + enc)


def _doc_field(value: bytes, path: str):
    """A dotted field of a JSON document; (None, False) when the value is
    not a JSON object or the path is absent."""
    try:
        doc = json.loads(value.decode("utf-8"))
    except (ValueError, RecursionError):  # not UTF-8, not JSON, too deep
        return None, False
    if not isinstance(doc, dict):
        return None, False
    cur = doc
    for part in path.split("."):
        if not isinstance(cur, dict) or part not in cur:
            return None, False
        cur = cur[part]
    return cur, True


def _encode_value(vv: VersionedValue) -> bytes:
    return (vv.version.pack() + struct.pack(">I", len(vv.metadata))
            + vv.metadata + vv.value)


def _decode_value(raw: bytes) -> VersionedValue:
    version = Height.unpack(raw[:16])
    (mlen,) = struct.unpack(">I", raw[16:20])
    return VersionedValue(raw[20 + mlen:], version, raw[20:20 + mlen])


class VersionedDB:
    """KV-backed versioned state (reference stateleveldb.VersionedDB),
    with rich-query indexes per (ns, field)."""

    def __init__(self, store: KVStore, name: str = "statedb"):
        self._db = NamedDB(store, name)
        self._indexes: dict[str, set[str]] | None = None  # lazy
        self._meta_ns: set[str] | bool | None = None  # lazy; True = unknown

    def rebased(self, base: KVStore) -> "VersionedDB":
        """The same namespace over another base (a commit group's
        collector): apply_updates buffers into the group's transaction and
        reads see earlier blocks of the group.  The index definitions are
        shared with the parent (they only grow); the metadata-namespace
        cache is not: the view reloads it through the buffer."""
        c = VersionedDB.__new__(VersionedDB)
        c._db = self._db.rebase(base)
        c._indexes = self._load_indexes()
        c._meta_ns = None
        return c

    # -- metadata presence ---------------------------------------------------

    def _load_meta_ns(self):
        """Namespaces that have ever stored key metadata; True when the
        store predates the record (unknown)."""
        if self._meta_ns is None:
            raw = self._db.get(_META_NS_KEY)
            if raw is not None:
                self._meta_ns = set(json.loads(raw.decode()))
            elif self._db.get(_SAVEPOINT_KEY) is not None:
                self._meta_ns = True
            else:
                self._meta_ns = set()
        return self._meta_ns

    def invalidate_caches(self) -> None:
        """Drop what was cached from the store (after a group flush).  The
        index definitions stay: they only grow, and no commit adds one."""
        self._meta_ns = None

    def may_have_metadata(self, ns: str) -> bool:
        """False guarantees that no key under `ns` carries metadata."""
        m = self._load_meta_ns()
        return True if m is True else ns in m

    # -- index definitions ---------------------------------------------------

    def _load_indexes(self) -> dict[str, set[str]]:
        if self._indexes is None:
            out: dict[str, set[str]] = {}
            for k, _ in self._db.iterate(_IDX_DEF_PREFIX,
                                         _IDX_DEF_PREFIX + b"\xff"):
                ns_b, field_b = k[len(_IDX_DEF_PREFIX):].split(b"\x00", 1)
                out.setdefault(ns_b.decode(), set()).add(field_b.decode())
            self._indexes = out
        return self._indexes

    def indexes_for(self, ns: str) -> set[str]:
        return self._load_indexes().get(ns, set())

    def indexed_namespaces(self) -> set[str]:
        """The namespaces with at least one index (a snapshot records
        their definitions, so that an import rebuilds them)."""
        return set(self._load_indexes())

    def define_index(self, ns: str, field) -> None:
        """Create and backfill an index on a dotted JSON field, or, given
        a list or tuple of fields (or one string of them joined by
        INDEX_SPEC_SEP), a compound index over them.  A document enters a
        compound index only when every field is present with a scalar
        value; the planner uses such an index only for conditions that
        require exactly that.  Idempotent."""
        if isinstance(field, (list, tuple)):
            fields_in = list(field)
            for f in fields_in:
                if INDEX_SPEC_SEP in f:
                    raise ValueError(
                        f"index field {f!r} contains the reserved "
                        "separator \\x1f")
        else:
            fields_in = field.split(INDEX_SPEC_SEP)
        spec = INDEX_SPEC_SEP.join(fields_in)
        if spec in self.indexes_for(ns):
            return
        fields = spec.split(INDEX_SPEC_SEP)
        puts = {_IDX_DEF_PREFIX + ns.encode() + b"\x00" + spec.encode(): b""}
        for key, vv in self.get_state_range(ns, "", ""):
            enc = self._index_encoding(vv.value, fields)
            if enc is not None:
                puts[_idx_key(ns, spec, enc, key)] = b""
        self._db.write_batch(puts, [])
        self._load_indexes().setdefault(ns, set()).add(spec)

    @staticmethod
    def _index_encoding(value: bytes, fields: list[str]) -> bytes | None:
        """One document's entry encoding under an index, or None when the
        document does not belong in it."""
        vals = []
        for f in fields:
            v, present = _doc_field(value, f)
            if not present:
                return None
            vals.append(v)
        if len(fields) == 1:
            return encode_scalar(vals[0])
        return encode_composite(vals)

    def index_scan(self, ns: str, field: str, lo: bytes | None,
                   hi: bytes | None):
        """The state keys whose entry encoding under index `field` (a spec,
        compound ones INDEX_SPEC_SEP-joined) lies in [lo, hi], inclusive,
        None leaving an end open; the caller rechecks each document."""
        start = _idx_prefix(ns, field, lo if lo is not None else b"")
        if hi is None:
            end = _idx_prefix(ns, field) + b"\xfe\xff"
        else:
            end = _idx_prefix(ns, field, hi) + b"\x01"
        plen = len(_idx_prefix(ns, field))
        n_comp = field.count(INDEX_SPEC_SEP) + 1
        for k, _ in self._db.iterate(start, end):
            key = _idx_entry_state_key(k[plen:], n_comp)
            if key is not None:
                yield key

    def _index_mutations(self, batch: dict, puts: dict, deletes: list) -> None:
        """The index entries of a batch: the old value's out, the new
        value's in, for the namespaces with indexes."""
        idx = self._load_indexes()
        dels: set[bytes] = set()
        for ns, kvs in batch.items():
            specs = idx.get(ns)
            if not specs:
                continue
            split = {s: s.split(INDEX_SPEC_SEP) for s in specs}
            for key, vv in kvs.items():
                old = self.get_state(ns, key)
                for spec, fields in split.items():
                    if old is not None:
                        oenc = self._index_encoding(old.value, fields)
                        if oenc is not None:
                            dels.add(_idx_key(ns, spec, oenc, key))
                    if vv is not None:
                        nenc = self._index_encoding(vv.value, fields)
                        if nenc is not None:
                            puts[_idx_key(ns, spec, nenc, key)] = b""
        # an unchanged entry would be deleted after its re-put (a batch
        # applies puts before deletes): keep it
        deletes.extend(dels - puts.keys())

    # -- reads ---------------------------------------------------------------

    def get_state(self, ns: str, key: str) -> VersionedValue | None:
        raw = self._db.get(_state_key(ns, key))
        return None if raw is None else _decode_value(raw)

    def get_version(self, ns: str, key: str) -> Height | None:
        vv = self.get_state(ns, key)
        return None if vv is None else vv.version

    def get_state_multiple(self, ns: str, keys) -> list[VersionedValue | None]:
        return [self.get_state(ns, k) for k in keys]

    def get_state_many(self, pairs) -> dict:
        """{(ns, key): VersionedValue | None} for every pair asked (None:
        known absent), in one store round trip: the MVCC preload."""
        pairs = list(dict.fromkeys(pairs))
        raw_keys = [_state_key(ns, k) for ns, k in pairs]
        got = self._db.get_many(raw_keys)
        return {pair: (_decode_value(got[rk]) if rk in got else None)
                for pair, rk in zip(pairs, raw_keys)}

    def get_state_range(self, ns: str, start_key: str, end_key: str):
        """(key, VersionedValue) over [start, end); an empty end is open."""
        start = _state_key(ns, start_key)
        if end_key:
            end = _state_key(ns, end_key)
        else:
            end = b"\x02" + ns.encode() + b"\x01"  # past the \x00 separator
        prefix_len = len(b"\x02" + ns.encode() + _NS_SEP)
        for k, v in self._db.iterate(start, end):
            yield k[prefix_len:].decode(), _decode_value(v)

    # -- writes --------------------------------------------------------------

    def apply_updates(self, batch: dict, height: Height | None) -> None:
        """batch: {ns: {key: VersionedValue | None}} (None deletes), in
        one write batch with its index entries and the savepoint
        (reference ApplyUpdates)."""
        puts: dict[bytes, bytes] = {}
        deletes: list[bytes] = []
        self._index_mutations(batch, puts, deletes)  # reads the old state
        # re-read the namespace set from the store, so that the record
        # below merges with flags another writer added since
        self._meta_ns = None
        meta_ns = self._load_meta_ns()
        for ns, kvs in batch.items():
            for key, vv in kvs.items():
                if vv is None:
                    deletes.append(_state_key(ns, key))
                else:
                    puts[_state_key(ns, key)] = _encode_value(vv)
                    if vv.metadata and meta_ns is not True:
                        meta_ns.add(ns)
        if meta_ns is not True:
            # always written, even empty: without it the next load would
            # take the store for one that predates the record
            puts[_META_NS_KEY] = json.dumps(
                sorted(meta_ns), sort_keys=True).encode()
        if height is not None:
            puts[_SAVEPOINT_KEY] = height.pack()
        self._db.write_batch(puts, deletes)
        self._meta_ns = None

    def savepoint(self) -> Height | None:
        raw = self._db.get(_SAVEPOINT_KEY)
        return None if raw is None else Height.unpack(raw)

    # -- snapshot export and import ------------------------------------------

    def export_records(self):
        """Every state entry as a raw (key, value) pair in key order, the
        stream a snapshot is built from.  Keys keep the whole
        `\x02 ns \x00 key` encoding, so that an import writes them back
        verbatim; index entries, definitions and housekeeping keys are
        left out."""
        return self._db.iterate(b"\x02", b"\x03")

    @staticmethod
    def split_state_key(raw_key: bytes) -> tuple[str, str]:
        """(ns, key) of a raw key from export_records.  A collection's
        derived namespace holds \x00 itself ('cc\x00hash\x00coll', see
        txmgmt.hash_ns and pvt_ns), so that shape is recognised before the
        plain split."""
        s = raw_key[1:]
        parts = s.split(b"\x00")
        if len(parts) >= 4 and parts[1] in (b"pvt", b"hash"):
            ns, key = b"\x00".join(parts[:3]), b"\x00".join(parts[3:])
        else:
            ns, _, key = s.partition(b"\x00")
        return ns.decode(), key.decode()

    def import_records(self, records, savepoint: Height,
                       batch_size: int = 10000) -> int:
        """Load a snapshot's raw state records into an empty state DB and
        set the savepoint, recomputing the metadata namespaces on the way;
        returns the record count."""
        if self._db.get(_SAVEPOINT_KEY) is not None:
            raise ValueError(
                "cannot import a snapshot into a non-empty state DB")
        meta_ns: set[str] = set()
        puts: dict[bytes, bytes] = {}
        count = 0
        for k, v in records:
            puts[k] = v
            count += 1
            if _decode_value(v).metadata:
                meta_ns.add(self.split_state_key(k)[0])
            if len(puts) >= batch_size:
                self._db.write_batch(puts, [])
                puts = {}
        puts[_META_NS_KEY] = json.dumps(sorted(meta_ns),
                                        sort_keys=True).encode()
        puts[_SAVEPOINT_KEY] = savepoint.pack()
        self._db.write_batch(puts, [])
        self._meta_ns = None
        return count


__all__ = ["Height", "VersionedValue", "VersionedDB", "encode_scalar",
           "encode_composite", "INDEX_SPEC_SEP"]
