"""The reviewed registry of the port's ``FABRIC_TPU_*`` environment knobs.

The port's copy of the JAX package's ``fabric_tpu/devtools/knob_registry.py``:
the same entries, one per knob (name, type, default, subsystem, one-line
doc), so one environment arms both packages alike, plus the ONE
sanctioned ``os.environ`` read (:func:`raw`): a read of an unregistered
name raises, so a typo'd knob fails at its first read instead of
silently reading the default.  The port's fabriclint
(``devtools/lint.py``, rule ``knob-conformance``) closes the loop
statically: every ``FABRIC_TPU_*`` env read in the port's tree must
route through this module's helpers and resolve to a registered entry,
every entry must have a read site, and the README's port table (between
the ``knob-table-torch`` markers) must be byte-identical to
:func:`render_table`.

A leaf module (standard library only): the import-time env readers
(tracing, profile, lockwatch, faultline) pull it in first.
"""

from __future__ import annotations

import dataclasses
import os

__all__ = ["Knob", "KNOBS", "spec", "raw", "render_table"]


@dataclasses.dataclass(frozen=True)
class Knob:
    """One reviewed env knob.

    ``kind`` is documentation-grade typing for the table and the lint
    artifact: ``int`` / ``width`` (int fan-out, 0 = serial, unset =
    auto) / ``size`` (byte size with k/m suffixes) / ``enum`` /
    ``flag`` (tree-wide falsy convention: unset/0/false/off/no
    disarm) / ``plan`` (inline JSON or ``@/path``).  ``default`` is
    the *effective* default as a display string ("" = disarmed)."""

    name: str
    kind: str
    default: str
    subsystem: str
    doc: str
    choices: tuple = ()


def _k(name, kind, default, subsystem, doc, choices=()):
    return Knob(name, kind, default, subsystem, doc, choices)


# Sorted by name; render_table() and the --knobs-out artifact preserve
# this order, so the README table diff is stable under insertion.
KNOBS: dict[str, Knob] = {
    k.name: k
    for k in (
        _k("FABRIC_TPU_BREAKER_PROBE_EVERY", "int", "8", "csp.tpu",
           "held verify calls between device probes while the TPU "
           "breaker is open"),
        _k("FABRIC_TPU_BREAKER_THRESHOLD", "int", "3", "csp.tpu",
           "consecutive device failures that trip the TPU breaker"),
        _k("FABRIC_TPU_COLLECT_POOL", "width", "auto", "peer.validation",
           "collect fan-out width in chunks per block (0 = serial)"),
        _k("FABRIC_TPU_DIAL_TIMEOUT_S", "int", "2", "gossip.comm",
           "gossip sender dial timeout in seconds (fractions "
           "accepted)"),
        _k("FABRIC_TPU_FAULTLINE", "plan", "", "devtools.faultline",
           "arm a fault plan: inline JSON or `@/path/plan.json`"),
        _k("FABRIC_TPU_LOCKWATCH", "flag", "", "devtools.lockwatch",
           "arm the lock-order watchdog (`record` logs instead of "
           "raising)"),
        _k("FABRIC_TPU_MVCC_POOL", "width", "auto", "ledger.txmgmt",
           "MVCC prepare/preload fan-out width (0 = serial)"),
        _k("FABRIC_TPU_NETSPLIT", "plan", "", "devtools.netsplit",
           "arm a network-partition plan: inline JSON or "
           "`@/path/plan.json`"),
        _k("FABRIC_TPU_PROFILE", "flag", "", "common.profile",
           "arm profscope: `1` = 100 Hz sampler, a number > 1 = "
           "sampling rate in Hz"),
        _k("FABRIC_TPU_RECOVERY_GROUP", "int", "32", "ledger.kvledger",
           "blocks replayed per recovery KV transaction (1 = "
           "per-block)"),
        _k("FABRIC_TPU_SOAK", "int", "", "devtools.faultline",
           "arm `faultline.soak_plan(seed)` (ignored when "
           "FABRIC_TPU_FAULTLINE is set; falsy disables)"),
        _k("FABRIC_TPU_SQLITE_SYNC", "enum", "NORMAL", "ledger.kvstore",
           "`PRAGMA synchronous` for the index store (and every "
           "statedb shard)",
           choices=("OFF", "NORMAL", "FULL", "EXTRA")),
        _k("FABRIC_TPU_STORE_POOL", "width", "auto", "ledger.kvstore",
           "per-shard prepare/apply fan-out width (0 = serial; never "
           "changes results)"),
        _k("FABRIC_TPU_STORE_SEGMENT", "size", "16m", "ledger.blkstorage",
           "block segment preallocation size, `k`/`m` suffixes "
           "(floor 4096)"),
        _k("FABRIC_TPU_STORE_SHARDS", "int", "1", "ledger.kvstore",
           "statedb shard files (persisted count wins on reopen)"),
        _k("FABRIC_TPU_THREADWATCH", "flag", "", "devtools.lockwatch",
           "register spawned workers in the threadwatch live "
           "registry and violation ledger"),
        _k("FABRIC_TPU_TRACE", "flag", "", "common.tracing",
           "arm tracelens: `1` = default 8192-event ring, an integer "
           "= ring capacity"),
        _k("FABRIC_TPU_WAL_CHECKPOINT", "int", "1000", "ledger.kvstore",
           "`PRAGMA wal_autocheckpoint` pages (0 disables "
           "auto-checkpoints)"),
    )
}


def spec(name: str) -> Knob:
    """The registered entry for `name`; KeyError (with the full knob
    list) for anything unregistered — a typo'd knob name fails loudly
    at its first read instead of silently reading the default."""
    try:
        return KNOBS[name]
    except KeyError:
        raise KeyError(
            f"{name} is not a registered FABRIC_TPU knob of the port "
            f"(see fabric_tpu_torch/devtools/knob_registry.py; "
            f"registered: {', '.join(sorted(KNOBS))})"
        ) from None


def raw(name: str) -> str:
    """The knob's raw environment value, "" when unset — the ONE
    sanctioned ``os.environ`` read for ``FABRIC_TPU_*`` names.  Callers
    keep their own parse/validation (their error messages are part of
    the tree's contract); this helper pins registration."""
    spec(name)
    return os.environ.get(name, "")


def render_table() -> str:
    """The README env-knob table, generated (markdown, one row per
    registered knob, name order).  ``knob-conformance`` fails the tree
    when the README block between the ``knob-table`` markers is not
    byte-identical to this."""
    lines = [
        "| env knob | type | default | subsystem | effect |",
        "|---|---|---|---|---|",
    ]
    for name in sorted(KNOBS):
        k = KNOBS[name]
        kind = k.kind if not k.choices else f"enum({'/'.join(k.choices)})"
        default = f"`{k.default}`" if k.default else "unset"
        lines.append(
            f"| `{k.name}` | {kind} | {default} | {k.subsystem} "
            f"| {k.doc} |"
        )
    return "\n".join(lines) + "\n"
