"""Names shared by the validator and the state database (from
`fabric_tpu/ledger/txmgmt.py`): the metadata entry that holds a key-level
endorsement policy, and the namespace of a collection's hashed keys."""

# a key's state-based endorsement policy lives in its metadata under this
# entry (reference core/ledger/kvledger/txmgmt/statemetadata)
VALIDATION_PARAMETER = "VALIDATION_PARAMETER"


def hash_ns(ns: str, coll: str) -> str:
    """The namespace of collection `coll`'s hashed keys in `ns`."""
    return f"{ns}\x00hash\x00{coll}"


__all__ = ["VALIDATION_PARAMETER", "hash_ns"]
