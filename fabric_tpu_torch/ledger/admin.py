"""Offline ledger repair (reference internal/peer/node/{reset,rollback,
rebuild_dbs,pause,resume,upgrade_dbs}.go and core/ledger/kvledger's
rollback and reset; the port's copy of `fabric_tpu/ledger/admin.py`), run
against a stopped peer's storage root as the reference's CLIs are:

- rebuild_dbs: drop the derived DBs (state, history); the next open
  replays them from the block store (kvledger's recovery);
- rollback: truncate a channel's chain after a target block, then drop
  the derived DBs;
- reset: roll every channel back to its genesis block;
- pause / resume: mark a channel skipped at startup, and unmark it;
- upgrade_dbs: rebuild the derived DBs when the data-format stamp is not
  the current one.

Like the JAX package's, these open the root's `index.sqlite` alone
(`open_kvstore`), so on a sharded root the state entries in the shard
files are out of their reach.  The JAX package's rebuild, rollback and
reset drop the coordinator's state records there and leave the shard
files' entries, which the replay then reads as current: a key that only
the rolled-off blocks wrote survives.  The port refuses them on a
sharded root instead; pause, resume and the data-format stamp touch the
coordinator alone and run on either layout.
"""

from __future__ import annotations

import os
import shutil

from fabric_tpu_torch.ledger.blkstorage import (
    BlockStore,
    read_bootstrap_height,
)
from fabric_tpu_torch.ledger.kvledger import LedgerProvider
from fabric_tpu_torch.ledger.kvstore import open_kvstore, wipe_prefix


def _derived_prefixes(ledger_id: str) -> list[bytes]:
    return [
        f"statedb/{ledger_id}".encode() + b"\x00\xff",
        f"historydb/{ledger_id}".encode() + b"\x00\xff",
    ]


def _index_prefix(ledger_id: str) -> bytes:
    return f"blkindex/{ledger_id}".encode() + b"\x00\xff"


def _open_kv(root_dir: str):
    return open_kvstore(os.path.join(root_dir, "index.sqlite"))


def _check_single_file(root_dir: str, op: str) -> None:
    """Refuse an operation that drops the derived DBs of a sharded root:
    the state entries in its shard files would outlive it."""
    if os.path.exists(os.path.join(root_dir, "state_00.sqlite")):
        raise ValueError(
            f"{root_dir} is a sharded root: {op} drops the state records "
            "of index.sqlite alone, and the state entries in its shard "
            "files would be read as current by the replay"
        )


def list_channels(root_dir: str) -> list[str]:
    return sorted(
        e for e in os.listdir(root_dir)
        if os.path.isdir(os.path.join(root_dir, e, "chains"))
    )


def _check_not_snapshot_bootstrapped(kv, ledger_id: str, op: str) -> None:
    """Refuse an operation that would truncate or rebuild through a
    snapshot bootstrap: the blocks below the bootstrap height do not exist
    here, so neither a rollback below it nor a replay from block 0 is
    possible (the reference refuses bootstrapped channels the same
    way)."""
    bh = read_bootstrap_height(kv, ledger_id)
    if bh:
        raise ValueError(
            f"channel {ledger_id!r} was bootstrapped from a snapshot at "
            f"block {bh - 1}: {op} would truncate it below its bootstrap "
            f"height {bh}, and blocks before the snapshot do not exist "
            "locally to replay"
        )


def rebuild_dbs(root_dir: str, ledger_id: str | None = None) -> list[str]:
    """Drop the state and history DBs of one channel (or every one); the
    next open replays them from the blocks (reference rebuild-dbs)."""
    _check_single_file(root_dir, "rebuild-dbs")
    ids = [ledger_id] if ledger_id else list_channels(root_dir)
    kv = _open_kv(root_dir)
    try:
        for lid in ids:
            _check_not_snapshot_bootstrapped(kv, lid, "rebuild-dbs")
        for lid in ids:
            for p in _derived_prefixes(lid):
                wipe_prefix(kv, p)
    finally:
        kv.close()
    return ids


def rollback(root_dir: str, ledger_id: str, target_block: int) -> int:
    """Truncate the channel's chain so that `target_block` is its last
    block, then drop the derived DBs for replay (reference peer node
    rollback, kvledger/rollback.go).  Returns the new height."""
    _check_single_file(root_dir, "rollback")
    kv = _open_kv(root_dir)
    try:
        _check_not_snapshot_bootstrapped(kv, ledger_id, "rollback")
        chains_dir = os.path.join(root_dir, ledger_id, "chains")
        store = BlockStore(chains_dir, kv, name=ledger_id)
        if store.height == 0:
            raise ValueError(f"channel {ledger_id!r} has no blocks")
        if target_block >= store.height:
            raise ValueError(
                f"target block {target_block} >= height {store.height}"
            )
        # the kept blocks stream through a sidecar chain directory, so
        # memory stays flat on a long chain; then the directories swap
        tmp_dir = chains_dir + ".rollback"
        if os.path.isdir(tmp_dir):
            shutil.rmtree(tmp_dir)
        tmp_name = f"{ledger_id}.rollback"
        wipe_prefix(kv, _index_prefix(tmp_name))
        store2 = BlockStore(tmp_dir, kv, name=tmp_name)
        for n in range(target_block + 1):
            store2.add_block(store.get_block_by_number(n))
        store.close()
        store2.close()
        wipe_prefix(kv, _index_prefix(ledger_id))
        wipe_prefix(kv, _index_prefix(tmp_name))
        shutil.rmtree(chains_dir)
        os.rename(tmp_dir, chains_dir)
        # reindex under the real name from the swapped files
        store3 = BlockStore(chains_dir, kv, name=ledger_id)
        store3.close()
        for p in _derived_prefixes(ledger_id):
            wipe_prefix(kv, p)
        return store3.height
    finally:
        kv.close()


def reset(root_dir: str) -> dict[str, int]:
    """Roll every channel back to its genesis block (reference peer node
    reset)."""
    out = {}
    _check_single_file(root_dir, "reset")
    channels = list_channels(root_dir)
    # check every channel before truncating the first: a failure in the
    # loop would leave an irreversible half-reset
    kv = _open_kv(root_dir)
    try:
        for lid in channels:
            _check_not_snapshot_bootstrapped(kv, lid, "reset")
    finally:
        kv.close()
    for lid in channels:
        kv = _open_kv(root_dir)
        try:
            store = BlockStore(os.path.join(root_dir, lid, "chains"), kv,
                               name=lid)
            height = store.height
            store.close()
        finally:
            kv.close()
        out[lid] = rollback(root_dir, lid, 0) if height > 1 else height
    return out


def verify_rebuild(root_dir: str, ledger_id: str) -> int:
    """Open the ledger (which replays what was dropped) and return its
    height: the check after a repair."""
    provider = LedgerProvider(root_dir)
    try:
        return provider.open(ledger_id).height
    finally:
        provider.close()


# -- pause / resume / upgrade-dbs (reference internal/peer/node/
# {pause,resume,upgrade_dbs}.go) ----------------------------------------------

_PAUSED_KEY = b"admin/paused/"
# the data-format stamp (reference dataformat.Version in kvledger's
# upgrade_dbs): bumped when a derived DB's encoding changes
DATA_FORMAT_VERSION = b"fabric-tpu/2.0"
_FORMAT_KEY = b"admin/dataformat"


def pause(root_dir: str, ledger_id: str) -> None:
    """Mark a channel paused: the peer skips it at startup until resumed
    (reference pauseChannelCmd -> kvledger.PauseChannel)."""
    kv = _open_kv(root_dir)
    try:
        kv.put(_PAUSED_KEY + ledger_id.encode(), b"1")
    finally:
        kv.close()


def resume(root_dir: str, ledger_id: str) -> None:
    kv = _open_kv(root_dir)
    try:
        kv.delete(_PAUSED_KEY + ledger_id.encode())
    finally:
        kv.close()


def paused_channels(root_dir: str) -> set[str]:
    kv = _open_kv(root_dir)
    try:
        return {
            k[len(_PAUSED_KEY):].decode()
            for k, _ in kv.iterate(_PAUSED_KEY, _PAUSED_KEY + b"\xff")
        }
    finally:
        kv.close()


def upgrade_dbs(root_dir: str) -> list[str]:
    """Bring the derived DBs to the current data format: when the stored
    stamp differs, rebuild every derived DB from the block store (the
    reference's upgradeDBs drops and replays them) and stamp the current
    version."""
    kv = _open_kv(root_dir)
    try:
        current = kv.get(_FORMAT_KEY)
    finally:
        kv.close()
    if current == DATA_FORMAT_VERSION:
        return []
    rebuilt = rebuild_dbs(root_dir)
    kv = _open_kv(root_dir)
    try:
        kv.put(_FORMAT_KEY, DATA_FORMAT_VERSION)
    finally:
        kv.close()
    return rebuilt


__all__ = ["rebuild_dbs", "rollback", "reset", "list_channels",
           "verify_rebuild", "pause", "resume", "paused_channels",
           "upgrade_dbs", "DATA_FORMAT_VERSION"]
