"""The registry of the port's ``FABRIC_TPU_*`` environment knobs read
through the devtools seam.

The port's copy of the JAX package's `fabric_tpu/devtools/knob_registry.py`,
holding only the knobs the port reads through it: the CSP's circuit
breaker, the gossip sender's dial timeout, faultline's and netsplit's
plan variables, and the lockwatch,
threadwatch, tracing and profiling switches.  One entry per knob (name, type,
default, subsystem, one-line doc) plus the one sanctioned ``os.environ``
read (:func:`raw`): a read of an unregistered name raises, so a typo'd
knob fails at its first read instead of silently reading the default.
The names, defaults and docs are the JAX package's, so one environment
arms both packages alike.

A leaf module (standard library only): faultline reads it at import.
"""

from __future__ import annotations

import dataclasses
import os

__all__ = ["Knob", "KNOBS", "spec", "raw"]


@dataclasses.dataclass(frozen=True)
class Knob:
    """One registered env knob.

    ``kind`` is documentation-grade typing: ``int``, ``plan`` (inline
    JSON or ``@/path``).  ``default`` is the effective default as a
    display string ("" = disarmed)."""

    name: str
    kind: str
    default: str
    subsystem: str
    doc: str


# Sorted by name.
KNOBS: dict[str, Knob] = {
    k.name: k
    for k in (
        Knob("FABRIC_TPU_BREAKER_PROBE_EVERY", "int", "8", "csp.tpu",
             "held verify calls between device probes while the TPU "
             "breaker is open"),
        Knob("FABRIC_TPU_BREAKER_THRESHOLD", "int", "3", "csp.tpu",
             "consecutive device failures that trip the TPU breaker"),
        Knob("FABRIC_TPU_DIAL_TIMEOUT_S", "int", "2", "gossip.comm",
             "gossip sender dial timeout in seconds (fractions "
             "accepted)"),
        Knob("FABRIC_TPU_FAULTLINE", "plan", "", "devtools.faultline",
             "arm a fault plan: inline JSON or `@/path/plan.json`"),
        Knob("FABRIC_TPU_LOCKWATCH", "flag", "", "devtools.lockwatch",
             "arm the lock-order watchdog (`record` logs instead of "
             "raising)"),
        Knob("FABRIC_TPU_NETSPLIT", "plan", "", "devtools.netsplit",
             "arm a network-partition plan: inline JSON or "
             "`@/path/plan.json`"),
        Knob("FABRIC_TPU_PROFILE", "flag", "", "common.profile",
             "arm profscope: `1` = 100 Hz sampler, a number > 1 = "
             "sampling rate in Hz"),
        Knob("FABRIC_TPU_SOAK", "int", "", "devtools.faultline",
             "arm `faultline.soak_plan(seed)` (ignored when "
             "FABRIC_TPU_FAULTLINE is set; falsy disables)"),
        Knob("FABRIC_TPU_THREADWATCH", "flag", "", "devtools.lockwatch",
             "register spawned workers in the threadwatch live "
             "registry and violation ledger"),
        Knob("FABRIC_TPU_TRACE", "flag", "", "common.tracing",
             "arm tracelens: `1` = default 8192-event ring, an integer "
             "= ring capacity"),
    )
}


def spec(name: str) -> Knob:
    """The registered entry for `name`; KeyError (with the knob list)
    for anything unregistered."""
    try:
        return KNOBS[name]
    except KeyError:
        raise KeyError(
            f"{name} is not a registered FABRIC_TPU knob of the port "
            f"(see fabric_tpu_torch/devtools/knob_registry.py; "
            f"registered: {', '.join(sorted(KNOBS))})"
        ) from None


def raw(name: str) -> str:
    """The knob's raw environment value, "" when unset.  Callers keep
    their own parsing; this pins registration."""
    spec(name)
    return os.environ.get(name, "")
