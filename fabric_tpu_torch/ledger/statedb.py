"""Versioned state database (the port's copy of
`fabric_tpu/ledger/statedb.py`, without rich-query indexes).

Reference SPI: core/ledger/kvledger/txmgmt/statedb/statedb.go (GetState,
GetStateMultipleKeys, GetStateRangeScanIterator, ApplyUpdates with a
savepoint height), over the KVStore SPI.  Keys and values are encoded as
the JAX package encodes them, byte for byte:

    \\x02 ns \\x00 key  ->  Height.pack() | len(metadata) >I | metadata | value
    \\x01savepoint       ->  Height.pack()
    \\x05metans          ->  JSON list of namespaces that ever stored metadata

Index definitions (`\\x04` keys) and entries (`\\x03`) belong to the rich
queries, which are not ported: a store that holds a definition raises
when it is committed to.
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
_IDX_DEF_PREFIX = b"\x04"
_META_NS_KEY = b"\x05metans"


def _state_key(ns: str, key: str) -> bytes:
    return b"\x02" + ns.encode() + _NS_SEP + key.encode()


def _encode_value(vv: VersionedValue) -> bytes:
    return (vv.version.pack() + struct.pack(">I", len(vv.metadata))
            + vv.metadata + vv.value)


def _decode_value(raw: bytes) -> VersionedValue:
    version = Height.unpack(raw[:16])
    (mlen,) = struct.unpack(">I", raw[16:20])
    return VersionedValue(raw[20 + mlen:], version, raw[20:20 + mlen])


class VersionedDB:
    """KV-backed versioned state (reference stateleveldb.VersionedDB)."""

    def __init__(self, store: KVStore, name: str = "statedb"):
        self._db = NamedDB(store, name)
        self._meta_ns: set[str] | bool | None = None  # lazy; True = unknown
        self._no_indexes = False

    def rebased(self, base: KVStore) -> "VersionedDB":
        """The same namespace over another base (a commit group's
        collector): apply_updates buffers into the group's transaction and
        reads see earlier blocks of the group.  The metadata-namespace
        cache is not shared: the view reloads it through the buffer."""
        c = VersionedDB.__new__(VersionedDB)
        c._db = self._db.rebase(base)
        c._meta_ns = None
        c._no_indexes = self._no_indexes
        return c

    def _check_no_indexes(self) -> None:
        """Rich-query indexes are maintained inside apply_updates in the
        JAX package; the port has none, so it refuses a store that
        defines one rather than let the entries go stale."""
        if not self._no_indexes:
            for _ in self._db.iterate(_IDX_DEF_PREFIX, b"\x05"):
                raise NotImplementedError(
                    "the state DB defines rich-query indexes, which the port "
                    "does not maintain")
            self._no_indexes = True

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
        """Drop what was cached from the store (after a group flush)."""
        self._meta_ns = None

    def may_have_metadata(self, ns: str) -> bool:
        """False guarantees that no key under `ns` carries metadata."""
        m = self._load_meta_ns()
        return True if m is True else ns in m

    # -- reads ---------------------------------------------------------------

    def get_state(self, ns: str, key: str) -> VersionedValue | None:
        raw = self._db.get(_state_key(ns, key))
        return None if raw is None else _decode_value(raw)

    def get_version(self, ns: str, key: str) -> Height | None:
        vv = self.get_state(ns, key)
        return None if vv is None else vv.version

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
        one write batch with the savepoint (reference ApplyUpdates)."""
        self._check_no_indexes()
        puts: dict[bytes, bytes] = {}
        deletes: list[bytes] = []
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


__all__ = ["Height", "VersionedValue", "VersionedDB"]
