"""fabriclint over the port — domain-aware invariant checker (intra- +
interprocedural) for ``fabric_tpu_torch/``.

The port's copy of the JAX package's ``fabric_tpu/devtools/lint.py``:
the same rules, pragma grammar, allowlist, profiles, baseline ratchet,
``LintReport`` artifacts and CLI, pointed at the port's tree, on the
port's engine (``devtools/dataflow.py``).  It imports the standard
library only.  Block-validation crypto routes through the pluggable CSP
seam so it can batch onto the card, and the commit path's lock/fsync
discipline is load-bearing.  Those invariants are enforced here by
machine, not reviewer memory: the port's tests run this linter over the
port's tree (``tests/test_torch_lint.py``) and fail on any unsuppressed
violation.

Where the port differs from the JAX package's linter:

* ``device-hygiene`` replaces ``jax-hygiene`` (the port imports no JAX):
  the host syncs it looks for are ``synchronize()`` (``torch.cuda``, an
  ``Event`` or a ``Stream``), ``.item()``, ``.tolist()`` and ``.cpu()``.
* The taint rule's marshal sink is ``.encode()`` on a value tied to a
  schema class of the port's codec (``protos/wire.py``'s
  ``Message.encode``), not ``SerializeToString`` (see dataflow.py).
* ``fabric_tpu_torch/protos/`` is LINTED: it is the port's hand-written
  codec, not generated code, and its findings are the codec's own.
* The default targets are ``fabric_tpu_torch`` (strict), the port's
  tests ``tests/test_torch_*.py`` and ``chip_smoke.py`` (relaxed).
* knob-conformance holds the port's ``knob_registry`` against the
  README table between ``<!-- knob-table-torch:begin -->`` and
  ``<!-- knob-table-torch:end -->``.
* The cache is ``.fabriclint_torch_cache/``, with its own engine
  fingerprint; the registry is the port's ``faultmap_registry.json``.

Since v2, rules are INTERPROCEDURAL where it matters: a whole-program
pass (``devtools/dataflow.py``) resolves imports/aliases, builds a call
graph, and computes per-function summaries (returns-digest,
sinks-to-consensus-bytes, spawns-thread, acquires-lock,
performs-blocking-io), so csp-seam sees digests computed via locals and
helper functions, lock-discipline sees blocking I/O reached through any
resolvable call chain under ``commit_lock``, and the taint rule follows
wall-clock values through assignments, calls, and f-strings into
protoutil marshaling.

Rules
-----
csp-seam
    No direct ``hashlib`` use outside ``fabric_tpu_torch/csp/`` and
    ``fabric_tpu_torch/common/hashing.py``/``crypto.py`` — including local
    aliases (``h = hashlib``) and calls to helper functions whose
    bodies reach hashlib outside the seam (interprocedural; propagation
    stops at reviewed/suppressed uses and at the seam itself).

exception-discipline
    No ``except Exception`` (or bare ``except``) in ``peer/``,
    ``policies/``, ``ledger/`` whose handler swallows without a
    structured sentinel (re-raise, sentinel assignment, logger call, or
    named error return).  ``faultline.*`` calls are a reviewed seam and
    TRANSPARENT to this analysis: an injection point inside a handler
    neither counts as the sentinel nor fires on its own.

determinism
    In validation/commit/policy paths where peers must agree (``peer/``,
    ``policies/``, ``ledger/``, ``protoutil/``): ban ``time.time()``,
    ``datetime.now()``/``utcnow()``, module-level ``random.*`` calls,
    and ``json.dumps`` without ``sort_keys=True``.

taint
    (interprocedural, whole tree) wall-clock/random values —
    ``time.time()``, ``datetime.now()``, module-level ``random.*`` —
    tracked through assignments, attribute fills, f-strings, and
    resolvable calls, flagged where they flow INTO consensus bytes:
    protoutil marshaling, protobuf (block-header) construction,
    ``SerializeToString``.  Catches the cross-function smuggle the
    determinism rule's call-site ban cannot see.

lock-discipline
    (a) bare ``x.acquire()`` outside try/finally; (b) lexically nested
    ``with`` acquisitions inverting ``commit_lock -> _lock -> _idle``;
    (c) blocking I/O (fsync, sqlite execute, sleep) — directly, through
    a same-class helper, or through ANY statically resolvable call
    chain (interprocedural) — while lexically holding ``commit_lock``,
    outside the approved group-commit seam.

racecheck
    (v3 tentpole; whole tree) lockset inference + shared-state race
    detection.  Every ``self._x`` / declared module-global access gets
    a lockset (the lock ROLES statically held there, extended
    interprocedurally by a meet over call paths, with type-informed
    resolution of attribute calls on annotated params/fields); every
    field gets a guarded-by role from the reviewed table in
    ``devtools/guards.py`` or by strict majority across its access
    sites.  An access on a path from a THREAD ENTRY POINT
    (``lockwatch.spawn_thread``/``spawn_timer`` targets,
    ``Thread``/``Timer`` ctors, ``executor.submit``, ``.register``/
    ``.subscribe`` handlers) whose lockset misses the guard is an
    error.  ``__init__`` bodies are pre-publication and exempt; fields
    never written outside ``__init__`` cannot race; an unresolvable
    lock-shaped ``with`` context suppresses rather than fabricates.
    The runtime cross-check is ``lockwatch.guarded(obj, field,
    by=role)`` at the declared hot fields — tier-1 verifies the static
    guard map against what threads actually hold.

    Since v4 ("hbcheck") the rule is HAPPENS-BEFORE aware: the engine
    models synchronization edges — ``Thread.start()`` (pre-spawn writes
    publish to the target), ``join()``/``drain_threads`` (the target's
    writes publish to the joiner), ``Event.set()→wait()``,
    ``Queue.put()→get()``, ``workpool.run_chunked`` submit→result —
    and an access ordered against every counterpart write needs no
    lock: it neither fires nor votes in guard inference (fields whose
    every access is publication-ordered show as source ``hb-publish``
    in the guard map).  Two NEW error classes ride the same machinery:
    a write that races PAST its publication point (mutating a field
    after ``start()`` that the spawned thread also touches, with no
    common lock and no later edge), and re-arming a shared ``Event``
    (``clear()``) concurrently with another thread's ``set()``/
    ``clear()`` — the lost-wakeup class behind a deliver-client
    wedge.  A declared guards.py entry whose every access is HB-proven
    (with at least one access actually thread-reachable) is flagged
    STALE so the reviewed table only shrinks.

lock-order
    (v4; whole tree) the static twin of lockwatch's runtime
    ``LockOrderError``: the lockset pass records every lexical
    acquisition with the roles already held, an interprocedural
    MAY-held union extends the edges across resolvable call chains,
    and any cycle in the resulting role-level acquisition-order graph
    is an error (one finding per cycle).  The graph is exported as a
    CI artifact (``devtools/lintci.py --lockgraph-out``) and the tests
    cross-checks that every edge runtime lockwatch observes during a
    live commit+snapshot session is present in it (runtime ⊆ static).

thread-lifecycle
    (v4; whole tree) every ``spawn_thread``/``spawn_timer``/``Thread``/
    ``Timer``/executor registration needs a statically reachable stop
    path: a ``join()``/``cancel()``/``shutdown()`` on whatever holds
    the handle, a stop-signal loop in the spawned entry (``Event``
    wait/is_set, queue get, ``clockskew.wait``), or a provably bounded
    worker body (no unbounded loop).  A handle returned or handed to
    another callable transfers ownership with the reference.  The
    static rule fails the leak at REVIEW time; the runtime threadwatch
    drain gate remains the interpreter-exit backstop.

thread-hygiene
    No daemonized ``threading.Thread``/``Timer`` created outside the
    threadwatch seam (``devtools/lockwatch.spawn_thread``/
    ``spawn_timer``).  A daemon thread nobody can drain is exactly the
    flush waiter that the interpreter kills mid-kernel at exit:
    registration makes every worker joinable before
    interpreter exit, and the runtime threadwatch ledger (see
    lockwatch.py) asserts they actually drained.

device-hygiene
    No host synchronization (``synchronize()``, ``.item()``,
    ``.tolist()``, ``.cpu()``) inside per-item ``for``/``while`` loops.

Profiles
--------
``fabric_tpu_torch/`` lints under the strict profile (everything at error
severity).  ``tests/``, ``scripts/`` and ``chip_smoke.py`` lint under the
RELAXED profile: determinism, taint, and device-hygiene are off (tests fabricate
timestamps and sync per-item by design), csp-seam is advisory
(warning severity — tests hash directly to build expectations), and
everything else stays at error.  ``tests/lint_fixtures/`` is skipped
entirely (deliberately-dirty fixtures for the engine's own tests).

Suppression
-----------
Inline pragma: a ``fabriclint: allow[<rule>] <reason>`` comment on the
offending line, the contiguous comment block above it, or the comment
block opening the flagged statement's body.  A pragma MUST carry a
reason and MUST suppress something.  Cross-file entries live in
``devtools/allowlist.py``; unused entries are violations, so the
surface only shrinks.

Baseline ratchet
----------------
``--baseline FILE`` reads a JSON ``{"rule": count}`` budget: up to
``count`` unsuppressed errors per rule are tolerated (reported, but not
fatal), so a new rule can land in warn mode and be tightened in the
same PR once the tree is clean.  ``--write-baseline FILE`` records the
current per-rule counts.  The ratchet only goes DOWN: a budget above
the observed count is itself an error, so the carve-out cannot outlive
the violations it covered.

Dataflow cache
--------------
``lint_tree`` caches finished reports (violations + per-function
summaries + the guard map) in ``.fabriclint_torch_cache/`` keyed by a digest
of the engine sources, the allowlist, the targets, and every target
file's content hash — editing any single file (or the linter itself)
changes the key, which IS the per-file invalidation.  A cache hit
serves the identical JSON in ~0.3s instead of a ~8s whole-program
pass; ``--no-cache`` (CLI and ``devtools/lintci.py``) bypasses it.

CLI
---
``python -m fabric_tpu_torch.devtools.lint [--json] [--baseline FILE]
[--guards] [--no-cache] [targets...]`` — exits non-zero on any
over-budget unsuppressed error; ``--json`` emits one JSON object per
violation plus a summary line; ``--guards`` dumps the racecheck
guarded-by map.
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import glob
import io
import json
import os
import re
import sys
import tokenize

from fabric_tpu_torch.devtools import dataflow
from fabric_tpu_torch.devtools.dataflow import BLOCKING_CALLS, CSP_SEAM_ALLOWED

RULES = (
    "csp-seam",
    "exception-discipline",
    "determinism",
    "taint",
    "lock-discipline",
    "racecheck",
    "lock-order",
    "thread-lifecycle",
    "thread-hygiene",
    "device-hygiene",
    "chaos-coverage",
    "rpc-conformance",
    "knob-conformance",
    "metrics-conformance",
)

# meta rules: problems with the suppression machinery itself; never
# themselves suppressible
META_RULES = ("pragma", "allowlist")

PRAGMA_RE = re.compile(
    r"#\s*fabriclint:\s*allow\[([a-z, -]+)\]\s*(.*?)\s*$"
)

# -- scopes ------------------------------------------------------------------

EXC_SCOPE = (
    "fabric_tpu_torch/peer/",
    "fabric_tpu_torch/policies/",
    "fabric_tpu_torch/ledger/",
)

# the port's protoutil is one module where the JAX package's is a package
DET_SCOPE = EXC_SCOPE + ("fabric_tpu_torch/protoutil",)

# lint_fixtures are the JAX package's linter's deliberately-dirty test
# corpus; the port's protos/ is its hand-written codec and is linted
SKIP_PREFIXES = ("tests/lint_fixtures/",)

# the one module allowed to construct daemon threads directly: it IS
# the registration seam
THREADWATCH_SEAM = "fabric_tpu_torch/devtools/lockwatch.py"

# a target is a file, a directory, or a glob of files
DEFAULT_TARGETS = ("fabric_tpu_torch", "tests/test_torch_*.py", "chip_smoke.py")

LOCK_RANKS = {
    "commit_lock": 0,
    "_commit_lock": 0,
    "_lock": 1,
    "_idle": 2,
}

COMMIT_LOCK_NAMES = ("commit_lock", "_commit_lock")

# host syncs: torch.cuda / Event / Stream synchronize(), and a tensor's
# .item() / .tolist() / .cpu()
DEVICE_SYNC_CALLS = frozenset({"synchronize", "item", "tolist", "cpu"})

# -- chaos-coverage (v5) -----------------------------------------------------

# fault actions that only make sense against particular seam kinds: a
# pinned plan wiring `torn` to a plain point can never tear anything
CHAOS_ACTION_KINDS = {
    "torn": frozenset({"write"}),
    "partial": frozenset({"io"}),
    "skip": frozenset({"guard"}),
}

# the checked-in campaign-registry export (python -m
# fabric_tpu_torch.devtools.faultfuzz --export-registry): every
# production seam the chaos campaign can arm — via observer-plan
# discovery on the canned workload or a pinned plan somewhere in the
# tree at export time
FAULTMAP_REGISTRY_PATH = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "faultmap_registry.json"
)


def load_faultmap_registry(path: str | None = None) -> dict:
    """``{point name: {"kinds": [...]}}`` from the checked-in registry
    export; empty when the artifact is absent (fixture projects and
    bootstrap runs check only their own plan rules then)."""
    try:
        with open(path or FAULTMAP_REGISTRY_PATH, "r",
                  encoding="utf-8") as f:
            data = json.load(f)
    except (OSError, ValueError):
        return {}
    pts = data.get("points") if isinstance(data, dict) else None
    return pts if isinstance(pts, dict) else {}


def _chaos_coverage(
    project: "dataflow.Project",
    pinned_registry: dict | None,
) -> list["Violation"]:
    """Cross-check the statically enumerated faultline seams against
    everything that could ever arm them: exact plan rules and prefix
    wildcards pinned anywhere in the tree (a chaos test IS coverage),
    plus the checked-in campaign-registry export.  The bare ``"*"``
    soak wildcard proves nothing by itself — it arms only what the
    workload reaches, which is exactly what the registry records."""
    pinned = pinned_registry or {}
    seam_kinds: dict[str, set] = {}
    for s in project.faultline_seams:
        seam_kinds.setdefault(s["name"], set()).add(s["kind"])
    exact: set = set()
    prefixes: list = []
    for p in project.faultline_plans:
        if p["wildcard"]:
            if p["point"] != "*":
                prefixes.append(p["point"][:-1])  # keep trailing dot
        else:
            exact.add(p["point"])
    known = set(seam_kinds) | set(pinned)
    out: list[Violation] = []
    for d in project.faultline_dynamic:
        out.append(Violation(
            rule="chaos-coverage", path=d["module"], line=d["line"],
            message=(
                f"faultline.{d['kind']}() name is not a string literal "
                "— the seam cannot be enumerated into the faultmap or "
                "targeted by any pinned plan; use a literal dotted name"
            ),
        ))
    for s in project.faultline_seams:
        nm = s["name"]
        if (
            nm in exact
            or nm in pinned
            or any(nm.startswith(pre) for pre in prefixes)
        ):
            continue
        out.append(Violation(
            rule="chaos-coverage", path=s["module"], line=s["line"],
            message=(
                f"fault seam {nm!r} ({s['kind']}) can never be armed: "
                "no pinned plan rule, prefix wildcard, or campaign-"
                "registry entry matches it — add a chaos test / plan "
                "that arms it, then refresh the registry export "
                "(python -m fabric_tpu_torch.devtools.faultfuzz "
                "--export-registry)"
            ),
        ))
    for p in project.faultline_plans:
        strict_file = profile_for(p["module"]) is STRICT_PROFILE
        if p["wildcard"]:
            if (
                strict_file
                and p["point"] != "*"
                and not any(
                    n.startswith(p["point"][:-1]) for n in known
                )
            ):
                out.append(Violation(
                    rule="chaos-coverage", path=p["module"],
                    line=p["line"],
                    message=(
                        f"prefix wildcard {p['point']!r} matches no "
                        "known fault seam — the rule is an orphan "
                        "(the seams it covered were renamed or "
                        "removed); fix the prefix or delete the rule"
                    ),
                ))
            continue
        kinds = set(seam_kinds.get(p["point"], ()))
        kinds.update((pinned.get(p["point"]) or {}).get("kinds", ()))
        if not kinds:
            if strict_file:
                out.append(Violation(
                    rule="chaos-coverage", path=p["module"],
                    line=p["line"],
                    message=(
                        f"plan rule names dead point {p['point']!r}: "
                        "no fault seam or campaign-registry entry has "
                        "that name — the injection it pinned has "
                        "rotted; fix the name or delete the rule"
                    ),
                ))
            continue
        need = CHAOS_ACTION_KINDS.get(p["action"])
        if need is not None and not (kinds & need):
            out.append(Violation(
                rule="chaos-coverage", path=p["module"], line=p["line"],
                message=(
                    f"action {p['action']!r} cannot fire at "
                    f"{p['point']!r} (kind "
                    f"{'/'.join(sorted(kinds))}): it only applies to "
                    f"{'/'.join(sorted(need))} seams — the plan can "
                    "never trip; fix the action or the point"
                ),
            ))
    return out


# -- surface conformance (v6) ------------------------------------------------

# the response shape each client verb commits to; a register site whose
# handler provably has a different shape can never satisfy the call
RPC_VERB_SHAPES = {"call": "unary", "stream": "stream", "duplex": "duplex"}

KNOB_REGISTRY_REL = "fabric_tpu_torch/devtools/knob_registry.py"
KNOB_TABLE_BEGIN = "<!-- knob-table-torch:begin -->"
KNOB_TABLE_END = "<!-- knob-table-torch:end -->"


def _rpc_conformance(project: "dataflow.Project") -> list["Violation"]:
    """Cross-check the RPC register plane against the call plane: every
    statically-resolvable call site must hit a registered method, every
    registered handler must have at least one caller (tests count — a
    harness driving a handler IS its consumer), and a call verb must be
    satisfiable by at least one register site's inferred handler shape."""
    methods: dict[str, dict] = {}
    for r in project.rpc_registers:
        m = methods.setdefault(r["method"], {"regs": [], "calls": []})
        m["regs"].append(r)
    for c in project.rpc_calls:
        m = methods.setdefault(c["method"], {"regs": [], "calls": []})
        m["calls"].append(c)
    out: list[Violation] = []
    for name in sorted(methods):
        regs, calls = methods[name]["regs"], methods[name]["calls"]
        if calls and not regs:
            for c in calls:
                out.append(Violation(
                    rule="rpc-conformance", path=c["module"],
                    line=c["line"],
                    message=(
                        f"RPC {c['verb']} site targets {name!r} but no "
                        "component registers that method — the call can "
                        "only ever raise method-not-found; fix the name "
                        "or register the handler"
                    ),
                ))
        if regs and not calls:
            for r in regs:
                out.append(Violation(
                    rule="rpc-conformance", path=r["module"],
                    line=r["line"],
                    message=(
                        f"RPC handler {name!r} ({r['component']}) has "
                        "no caller anywhere in the tree — dead service "
                        "surface; add a consumer (CLI subcommand, "
                        "harness probe, or test) or delete the handler"
                    ),
                ))
        shapes = {r["shape"] for r in regs} - {"unknown"}
        if not shapes:
            continue
        for c in calls:
            want = RPC_VERB_SHAPES[c["verb"]]
            if want not in shapes:
                out.append(Violation(
                    rule="rpc-conformance", path=c["module"],
                    line=c["line"],
                    message=(
                        f"client {c['verb']}s {name!r} (a {want} "
                        "exchange) but every register site's handler "
                        f"is {'/'.join(sorted(shapes))}-shaped — the "
                        "framing can never line up; match the client "
                        "verb to the handler shape"
                    ),
                ))
    return out


def _knob_conformance(
    project: "dataflow.Project",
    sources: dict[str, str],
    readme_text: str | None,
) -> list["Violation"]:
    """Close the env-knob loop: every ``FABRIC_TPU_*`` read resolves to
    a knob_registry entry AND routes through the registry helper; every
    entry has a read site; the README table between the ``knob-table``
    markers is byte-identical to ``render_table()``.  The dead-entry and
    README checks only run when the registry module itself is in the
    linted set (partial runs can't see the whole read plane)."""
    from fabric_tpu_torch.devtools import knob_registry

    out: list[Violation] = []
    for d in project.knob_dynamic:
        out.append(Violation(
            rule="knob-conformance", path=d["module"], line=d["line"],
            message=(
                "knob name is not a string literal — the read cannot "
                "be checked against the registry or enumerated into "
                "the --knobs artifact; use a literal FABRIC_TPU_* name"
            ),
        ))
    for s in project.knob_sites:
        if s["name"] not in knob_registry.KNOBS:
            out.append(Violation(
                rule="knob-conformance", path=s["module"],
                line=s["line"],
                message=(
                    f"env read of unregistered knob {s['name']!r} — "
                    "every FABRIC_TPU_* knob ships with a reviewed "
                    "entry (name/type/default/subsystem/doc) in "
                    "devtools/knob_registry.py; register it"
                ),
            ))
        elif s["via"] == "environ":
            out.append(Violation(
                rule="knob-conformance", path=s["module"],
                line=s["line"],
                message=(
                    f"{s['name']} read bypasses knob_registry.raw() — "
                    "direct os.environ reads skip the registration "
                    "check that keeps the knob table honest; route "
                    "the read through the registry helper"
                ),
            ))
    if KNOB_REGISTRY_REL not in sources:
        return out
    reg_lines = sources[KNOB_REGISTRY_REL].splitlines()

    def _entry_line(name: str) -> int:
        needle = f'"{name}"'
        for i, ln in enumerate(reg_lines):
            if needle in ln:
                return i + 1
        return 0

    read_names = {s["name"] for s in project.knob_sites}
    for name in sorted(set(knob_registry.KNOBS) - read_names):
        out.append(Violation(
            rule="knob-conformance", path=KNOB_REGISTRY_REL,
            line=_entry_line(name),
            message=(
                f"registry entry {name!r} has no read site anywhere "
                "in the tree — the knob is dead (its reader was "
                "removed or renamed); delete the entry or fix the "
                "reader"
            ),
        ))
    if readme_text is not None:
        i = readme_text.find(KNOB_TABLE_BEGIN)
        j = readme_text.find(KNOB_TABLE_END)
        if i < 0 or j < i:
            out.append(Violation(
                rule="knob-conformance", path=KNOB_REGISTRY_REL,
                line=0,
                message=(
                    "README.md has no knob-table marker block "
                    f"({KNOB_TABLE_BEGIN} … {KNOB_TABLE_END}) — the "
                    "generated env-knob table is part of the "
                    "registry's contract; add the block"
                ),
            ))
        else:
            block = readme_text[i + len(KNOB_TABLE_BEGIN):j]
            if block != "\n" + knob_registry.render_table():
                out.append(Violation(
                    rule="knob-conformance", path=KNOB_REGISTRY_REL,
                    line=0,
                    message=(
                        "README.md knob table has drifted from "
                        "knob_registry.render_table() — regenerate the "
                        "block between the knob-table markers "
                        "(python -c 'from fabric_tpu_torch.devtools import "
                        "knob_registry; print(knob_registry."
                        "render_table(), end=\"\")')"
                    ),
                ))
    return out


def _metrics_conformance(project: "dataflow.Project") -> list["Violation"]:
    """Cross-check the metric producer plane against its consumers:
    every Counter/Gauge/Histogram Opts lands in a provider ``new_*``
    call (else the series silently never exists), every series name a
    rollup/SLO/bench consumes is one a scrape can expose, and every
    producer is constructed on some production path (orphan producers
    are advisory — instrumentation wired ahead of its consumer)."""
    out: list[Violation] = []
    for d in project.metric_dynamic:
        out.append(Violation(
            rule="metrics-conformance", path=d["module"], line=d["line"],
            message=(
                "metric name is not resolvable to a string literal — "
                "the series cannot be checked against its consumers "
                "or enumerated into the --metricmap artifact; use "
                "literal namespace/subsystem/name parts"
            ),
        ))
    exposed: set = set()
    for p in project.metric_producers:
        if not p["registered"]:
            out.append(Violation(
                rule="metrics-conformance", path=p["module"],
                line=p["line"],
                message=(
                    f"{p['kind']} Opts for {p['name']!r} never reaches "
                    "a provider new_* call — the series is configured "
                    "but never constructed, so no scrape will ever "
                    "carry it; register it with a provider"
                ),
            ))
        exposed.add(p["name"])
        if p["kind"] == "histogram":
            for suf in dataflow._HISTOGRAM_SUFFIXES:
                exposed.add(p["name"] + suf)
    for d in project.metric_derived:
        exposed.add(d["name"])
    for c in project.metric_consumers:
        if c["name"] not in exposed:
            out.append(Violation(
                rule="metrics-conformance", path=c["module"],
                line=c["line"],
                message=(
                    f"consumer reads series {c['name']!r} "
                    f"({c['context']}) but no producer or derived "
                    "series carries that name — the rollup/threshold "
                    "can only ever see an absent series; fix the name "
                    "or add the producer"
                ),
            ))
    for p in project.metric_producers:
        if p["registered"] and not p["reachable"]:
            out.append(Violation(
                rule="metrics-conformance", path=p["module"],
                line=p["line"], severity="warning",
                message=(
                    f"producer {p['name']!r} is only constructed from "
                    f"{p['owner']} which no production path "
                    "instantiates — the series exists in code but no "
                    "deployed process exposes it; wire the owner into "
                    "a node/harness path (advisory)"
                ),
            ))
    return out


def build_knob_artifact(knob_map: dict) -> dict:
    """The ``--knobs-out`` artifact: the reviewed registry joined with
    the statically-enumerated read plane."""
    from fabric_tpu_torch.devtools import knob_registry

    registry = {
        name: {
            "kind": k.kind, "default": k.default,
            "subsystem": k.subsystem, "doc": k.doc,
            "choices": list(k.choices),
        }
        for name, k in sorted(knob_registry.KNOBS.items())
    }
    return {
        "registry": registry,
        "reads": knob_map["reads"],
        "dynamic": knob_map["dynamic"],
    }


# -- profiles ----------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Profile:
    name: str
    disabled: tuple = ()
    advisory: tuple = ()


STRICT_PROFILE = Profile("strict")
RELAXED_PROFILE = Profile(
    "relaxed",
    # racecheck and its v4 siblings are off with determinism/taint:
    # tests drive production objects from the pytest thread without
    # the production locks by design, fixtures seed deliberate races
    # and inversions, and test helpers manage thread lifecycles
    # dynamically (start/join inline) in shapes the static rule need
    # not model
    # the v6 surface-conformance rules are whole-program checks over
    # the PRODUCTION surface: their violations anchor at production
    # sites (tests count as consumers/callers, never as the surface),
    # so test/script files carry none of their own
    disabled=("determinism", "taint", "device-hygiene", "racecheck",
              "lock-order", "thread-lifecycle", "rpc-conformance",
              "knob-conformance", "metrics-conformance"),
    advisory=("csp-seam",),
)


def profile_for(rel: str) -> Profile:
    if rel.startswith(dataflow.RELAXED_PREFIXES):
        return RELAXED_PROFILE
    return STRICT_PROFILE


@dataclasses.dataclass
class Violation:
    rule: str
    path: str
    line: int
    message: str
    suppressed: bool = False
    suppression: str | None = None  # "pragma: <reason>" / "allowlist: <reason>"
    severity: str = "error"  # "error" | "warning" (advisory profiles)

    def __str__(self) -> str:
        tag = f" (suppressed: {self.suppression})" if self.suppressed else ""
        sev = " [warning]" if self.severity == "warning" else ""
        return f"{self.path}:{self.line}: [{self.rule}]{sev} {self.message}{tag}"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class AllowEntry:
    """One reviewed cross-file suppression.  `match` must be a substring
    of the flagged source line, so entries survive line-number drift but
    die (as unused-entry violations) when the code they covered goes
    away."""

    rule: str
    path: str
    match: str
    reason: str


# -- per-module pre-pass: which class methods (transitively) block -----------


def _method_blocking_map(tree: ast.Module) -> dict[str, set[str]]:
    """class name -> names of its methods that perform a blocking call
    directly or through other methods of the same class (fixpoint over
    ``self.x()`` edges).  The dataflow engine subsumes this for
    resolvable calls; this lexical map stays as the zero-setup fallback
    for single-snippet lint_source runs."""
    out: dict[str, set[str]] = {}
    for cls in ast.walk(tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        direct: set[str] = set()
        calls: dict[str, set[str]] = {}
        for fn in cls.body:
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            calls[fn.name] = set()
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                f = node.func
                if isinstance(f, ast.Attribute):
                    if f.attr in BLOCKING_CALLS:
                        direct.add(fn.name)
                    if (
                        isinstance(f.value, ast.Name)
                        and f.value.id == "self"
                    ):
                        calls[fn.name].add(f.attr)
        blocking = set(direct)
        changed = True
        while changed:
            changed = False
            for name, callees in calls.items():
                if name not in blocking and callees & blocking:
                    blocking.add(name)
                    changed = True
        out[cls.name] = blocking
    return out


# -- the checker -------------------------------------------------------------


def _in_scope(rel: str, prefixes) -> bool:
    return any(rel.startswith(p) for p in prefixes)


def _is_trivial_return_value(v) -> bool:
    """True for values whose return carries no information: None,
    constants, tuples of constants, and empty containers."""
    if v is None or isinstance(v, ast.Constant):
        return True
    if isinstance(v, ast.Tuple):
        return all(isinstance(e, ast.Constant) for e in v.elts)
    if isinstance(v, (ast.List, ast.Set)):
        return not v.elts
    if isinstance(v, ast.Dict):
        return not v.keys
    return False


def _is_faultline_stmt(stmt) -> bool:
    """Expression statements calling the faultline seam
    (``faultline.point(...)`` etc.) are TRANSPARENT to the swallow
    analysis: an injection point inside an except handler is a reviewed
    seam (like the lockwatch seam) — it neither launders the swallow
    into "handled" (it is not a structured sentinel) nor constitutes a
    violation of its own."""
    if not (isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Call)):
        return False
    f = stmt.value.func
    return (
        isinstance(f, ast.Attribute)
        and isinstance(f.value, ast.Name)
        and f.value.id == "faultline"
    )


def _swallows(handler: ast.ExceptHandler) -> bool:
    if any(isinstance(n, ast.Raise) for n in ast.walk(handler)):
        return False
    for stmt in handler.body:
        if isinstance(stmt, (ast.Pass, ast.Continue, ast.Break)):
            continue
        if _is_faultline_stmt(stmt):
            continue
        if isinstance(stmt, ast.Return) and _is_trivial_return_value(
            stmt.value
        ):
            continue
        if isinstance(stmt, ast.Expr) and isinstance(
            stmt.value, ast.Constant
        ):
            continue  # docstring / ellipsis
        return False
    return True


def _catches_broad(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    if t is None:
        return True
    names = []
    if isinstance(t, ast.Name):
        names = [t.id]
    elif isinstance(t, ast.Tuple):
        names = [e.id for e in t.elts if isinstance(e, ast.Name)]
    return any(n in ("Exception", "BaseException") for n in names)


def _lock_name(expr) -> str | None:
    if isinstance(expr, ast.Attribute):
        return expr.attr
    if isinstance(expr, ast.Name):
        return expr.id
    return None


def _finally_releases(node: ast.Try) -> bool:
    return any(
        isinstance(n, ast.Call)
        and isinstance(n.func, ast.Attribute)
        and n.func.attr == "release"
        for stmt in node.finalbody
        for n in ast.walk(stmt)
    )


def _acquires_before_try_finally(tree: ast.Module) -> set[int]:
    """Node ids of `x.acquire()` statements whose immediately-following
    sibling is a try whose finally releases — the canonical safe idiom
    (acquire OUTSIDE the try: a failed acquire must not reach the
    finally and release a lock it never took)."""
    ok: set[int] = set()
    for node in ast.walk(tree):
        for field in ("body", "orelse", "finalbody"):
            stmts = getattr(node, field, None)
            if not isinstance(stmts, list):
                continue
            for a, b in zip(stmts, stmts[1:]):
                if (
                    isinstance(a, ast.Expr)
                    and isinstance(a.value, ast.Call)
                    and isinstance(a.value.func, ast.Attribute)
                    and a.value.func.attr == "acquire"
                    and isinstance(b, ast.Try)
                    and _finally_releases(b)
                ):
                    ok.add(id(a))
    return ok


def _dotted_name(expr) -> str | None:
    """`a.b.c` as the string "a.b.c"; None for non-Name/Attribute chains."""
    parts = []
    while isinstance(expr, ast.Attribute):
        parts.append(expr.attr)
        expr = expr.value
    if not isinstance(expr, ast.Name):
        return None
    parts.append(expr.id)
    return ".".join(reversed(parts))


class _FileChecker(ast.NodeVisitor):
    def __init__(self, rel: str, tree: ast.Module,
                 project: dataflow.Project | None = None):
        self.rel = rel
        self.violations: list[Violation] = []
        self._seen: set[tuple[str, int]] = set()
        self._hashlib_aliases: set[str] = set()
        self._threading_aliases: set[str] = set()
        self._thread_ctor_aliases: set[str] = set()
        self._time_fn_aliases: set[str] = set()
        self._random_fn_aliases: set[str] = set()
        self._datetime_aliases: set[str] = {"datetime", "date"}
        self._func_stack: list[str] = []
        self._class_stack: list[str] = []
        self._with_locks: list[str] = []
        self._loop_depth = 0
        self._protected_depth = 0  # inside a try whose finally releases
        self._blocking = _method_blocking_map(tree)
        self._preacquire_ok = _acquires_before_try_finally(tree)
        self._project = project

    # -- helpers -----------------------------------------------------------

    def _flag(self, rule: str, node, message: str) -> None:
        key = (rule, node.lineno)
        if key in self._seen:
            return
        self._seen.add(key)
        self.violations.append(
            Violation(rule=rule, path=self.rel, line=node.lineno,
                      message=message)
        )

    def _resolved_callee(self, node: ast.Call):
        if self._project is None:
            return None
        q = self._project.call_resolutions.get(
            (self.rel, node.lineno, node.col_offset)
        )
        return self._project.symbols.get(q) if q else None

    # -- imports (alias tracking) ------------------------------------------

    def visit_Import(self, node: ast.Import) -> None:
        for alias in node.names:
            if alias.name == "hashlib":
                self._hashlib_aliases.add(alias.asname or "hashlib")
            if alias.name == "threading":
                self._threading_aliases.add(alias.asname or "threading")
        self.generic_visit(node)

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        if node.module == "hashlib" and not _in_scope(
            self.rel, CSP_SEAM_ALLOWED
        ):
            self._flag(
                "csp-seam", node,
                "from-import of hashlib outside the CSP seam "
                "(route through common.hashing.sha256/sha256_many or a "
                "CSP hash/hash_batch)",
            )
        if node.module == "threading":
            for alias in node.names:
                if alias.name in ("Thread", "Timer"):
                    self._thread_ctor_aliases.add(alias.asname or alias.name)
        if node.module == "time":
            for alias in node.names:
                if alias.name == "time":
                    self._time_fn_aliases.add(alias.asname or "time")
        if node.module == "random":
            # module-level functions share the hidden global Random();
            # the class constructors are fine (callers seed their own)
            for alias in node.names:
                if alias.name not in ("Random", "SystemRandom"):
                    self._random_fn_aliases.add(alias.asname or alias.name)
        if node.module == "datetime":
            for alias in node.names:
                if alias.name in ("datetime", "date"):
                    self._datetime_aliases.add(alias.asname or alias.name)
        self.generic_visit(node)

    def visit_Attribute(self, node: ast.Attribute) -> None:
        if (
            isinstance(node.value, ast.Name)
            and node.value.id in self._hashlib_aliases
            and not _in_scope(self.rel, CSP_SEAM_ALLOWED)
        ):
            self._flag(
                "csp-seam", node,
                f"direct hashlib.{node.attr} outside the CSP seam — "
                "invisible to hash_batch/card batching (route through "
                "common.hashing.sha256/sha256_many or the CSP)",
            )
        self.generic_visit(node)

    # -- exception discipline ----------------------------------------------

    def visit_ExceptHandler(self, node: ast.ExceptHandler) -> None:
        if (
            _in_scope(self.rel, EXC_SCOPE)
            and _catches_broad(node)
            and _swallows(node)
        ):
            self._flag(
                "exception-discipline", node,
                "broad except swallows without a structured sentinel, "
                "re-raise, or logged reason",
            )
        self.generic_visit(node)

    # -- assignments: thread-hygiene daemon flips ---------------------------

    def visit_Assign(self, node: ast.Assign) -> None:
        if self.rel != THREADWATCH_SEAM:
            for t in node.targets:
                if (
                    isinstance(t, ast.Attribute)
                    and t.attr == "daemon"
                    and isinstance(node.value, ast.Constant)
                    and node.value.value is True
                ):
                    self._flag(
                        "thread-hygiene", node,
                        "thread daemonized by attribute flip without "
                        "threadwatch registration — create it through "
                        "devtools.lockwatch.spawn_thread/spawn_timer so "
                        "it can be drained before interpreter exit",
                    )
        self.generic_visit(node)

    # -- calls: determinism + lock blocking + threads + device hygiene ------

    def visit_Call(self, node: ast.Call) -> None:
        f = node.func
        attr = f.attr if isinstance(f, ast.Attribute) else None
        # full dotted base so `datetime.datetime.now()` resolves — a
        # Name-only base would see None and let the qualified spelling
        # through the gate
        base = (
            _dotted_name(f.value) if isinstance(f, ast.Attribute) else None
        )
        base_tail = base.rsplit(".", 1)[-1] if base else None

        if _in_scope(self.rel, DET_SCOPE):
            if (base == "time" and attr == "time") or (
                isinstance(f, ast.Name) and f.id in self._time_fn_aliases
            ):
                self._flag(
                    "determinism", node,
                    "time.time() on a consensus path — wall-clock "
                    "differs across peers (use an explicit timestamp "
                    "argument, or time.monotonic/perf_counter for "
                    "intervals)",
                )
            elif (
                attr in ("now", "utcnow", "today")
                and base_tail in self._datetime_aliases
            ):
                self._flag(
                    "determinism", node,
                    f"datetime.{attr}() on a consensus path",
                )
            elif (base == "random" and attr not in ("Random", "SystemRandom")
                  ) or (
                isinstance(f, ast.Name) and f.id in self._random_fn_aliases
            ):
                name = attr if attr is not None else f.id
                self._flag(
                    "determinism", node,
                    f"module-level random.{name}() on a consensus path "
                    "(inject a seeded random.Random instead)",
                )
            elif base == "json" and attr == "dumps":
                sorted_kw = any(
                    kw.arg == "sort_keys"
                    and isinstance(kw.value, ast.Constant)
                    and kw.value.value is True
                    for kw in node.keywords
                )
                if not sorted_kw:
                    self._flag(
                        "determinism", node,
                        "json.dumps without sort_keys=True on a "
                        "consensus path — dict order leaks into bytes",
                    )

        # thread-hygiene: daemonized Thread/Timer outside the seam
        is_thread_ctor = (
            base in self._threading_aliases
            and attr in ("Thread", "Timer")
        ) or (
            isinstance(f, ast.Name) and f.id in self._thread_ctor_aliases
        )
        if is_thread_ctor and self.rel != THREADWATCH_SEAM:
            daemonized = any(
                kw.arg == "daemon"
                and isinstance(kw.value, ast.Constant)
                and kw.value.value is True
                for kw in node.keywords
            )
            if daemonized:
                self._flag(
                    "thread-hygiene", node,
                    "daemonized thread created outside the threadwatch "
                    "seam — a daemon thread nobody registered cannot be "
                    "drained and dies mid-kernel at interpreter exit; "
                    "create it through "
                    "devtools.lockwatch.spawn_thread/spawn_timer",
                )

        callee = self._resolved_callee(node)

        if attr is not None and any(
            n in COMMIT_LOCK_NAMES for n in self._with_locks
        ):
            cls = self._class_stack[-1] if self._class_stack else None
            if attr in BLOCKING_CALLS:
                self._flag(
                    "lock-discipline", node,
                    f"blocking call .{attr}() while holding the commit "
                    "lock, outside the approved group-commit seam",
                )
            elif (
                base == "self"
                and cls is not None
                and attr in self._blocking.get(cls, ())
            ):
                self._flag(
                    "lock-discipline", node,
                    f"self.{attr}() performs blocking I/O (transitively) "
                    "while holding the commit lock, outside the approved "
                    "group-commit seam",
                )
        if (
            callee is not None
            and callee.blocking_transitive
            and any(n in COMMIT_LOCK_NAMES for n in self._with_locks)
        ):
            self._flag(
                "lock-discipline", node,
                f"call to {callee.qname} performs blocking I/O "
                "(interprocedurally) while holding the commit lock, "
                "outside the approved group-commit seam",
            )

        if attr in DEVICE_SYNC_CALLS and self._loop_depth > 0:
            self._flag(
                "device-hygiene", node,
                f".{attr}() inside a per-item loop — host sync per "
                "item serializes the device; sync once per batch",
            )

        self.generic_visit(node)

    # -- lock discipline: bare acquire + with-order -------------------------

    def visit_Try(self, node: ast.Try) -> None:
        if _finally_releases(node):
            self._protected_depth += 1
            for stmt in node.body + node.orelse:
                self.visit(stmt)
            self._protected_depth -= 1
            for h in node.handlers:
                self.visit(h)
            for stmt in node.finalbody:
                self.visit(stmt)
        else:
            self.generic_visit(node)

    def visit_Expr(self, node: ast.Expr) -> None:
        v = node.value
        if (
            isinstance(v, ast.Call)
            and isinstance(v.func, ast.Attribute)
            and v.func.attr == "acquire"
            and self._protected_depth == 0
            and id(node) not in self._preacquire_ok
            and (not self._func_stack or self._func_stack[-1] != "__enter__")
        ):
            self._flag(
                "lock-discipline", node,
                "bare .acquire() without try/finally release "
                "(use `with`, or release in a finally)",
            )
        self.generic_visit(node)

    def visit_With(self, node: ast.With) -> None:
        names = []
        for item in node.items:
            n = _lock_name(item.context_expr)
            if n is not None and n in LOCK_RANKS:
                for outer in self._with_locks:
                    if LOCK_RANKS[n] < LOCK_RANKS[outer]:
                        self._flag(
                            "lock-discipline", node,
                            f"lock-order inversion: {n!r} (rank "
                            f"{LOCK_RANKS[n]}) acquired while holding "
                            f"{outer!r} (rank {LOCK_RANKS[outer]}); "
                            f"canonical order is commit_lock -> _lock "
                            f"-> _idle",
                        )
                names.append(n)
                self._with_locks.append(n)
        for item in node.items:
            self.visit(item)
        for stmt in node.body:
            self.visit(stmt)
        for _ in names:
            self._with_locks.pop()

    # -- structure tracking -------------------------------------------------

    def visit_FunctionDef(self, node) -> None:
        self._func_stack.append(node.name)
        self.generic_visit(node)
        self._func_stack.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self._class_stack.append(node.name)
        self.generic_visit(node)
        self._class_stack.pop()

    def visit_For(self, node) -> None:
        self._loop_depth += 1
        self.generic_visit(node)
        self._loop_depth -= 1

    visit_AsyncFor = visit_For
    visit_While = visit_For


# -- suppression -------------------------------------------------------------


def _parse_pragmas(source: str, rel: str):
    """Tokenize-based pragma scan: only REAL comment tokens count, so
    pragma-shaped text inside strings/docstrings never registers.

    Returns (pragmas, comment_only, meta) where `pragmas` maps line
    number -> (rules, reason), `comment_only` is the set of lines whose
    sole content is a comment (used to associate a pragma with the
    statement its comment block annotates), and `meta` lists violations
    for malformed pragmas (unknown rule, missing reason)."""
    pragmas: dict[int, tuple[set[str], str]] = {}
    comment_only: set[int] = set()
    meta: list[Violation] = []
    try:
        tokens = list(
            tokenize.generate_tokens(io.StringIO(source).readline)
        )
    except (tokenize.TokenError, IndentationError):
        tokens = []
    for tok in tokens:
        if tok.type != tokenize.COMMENT:
            continue
        i = tok.start[0]
        if not tok.line[: tok.start[1]].strip():
            comment_only.add(i)
        m = PRAGMA_RE.search(tok.string)
        if not m:
            continue
        rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
        reason = m.group(2).strip()
        unknown = rules - set(RULES)
        if unknown:
            meta.append(Violation(
                rule="pragma", path=rel, line=i,
                message=f"pragma names unknown rule(s): "
                        f"{', '.join(sorted(unknown))}",
            ))
        if not reason:
            meta.append(Violation(
                rule="pragma", path=rel, line=i,
                message="pragma without a reason — every suppression "
                        "must say why it was reviewed",
            ))
        pragmas[i] = (rules, reason)
    return pragmas, comment_only, meta


def _pragma_candidate_lines(line: int, comment_only: set[int],
                            lines: list[str]):
    """Lines whose pragma may suppress a violation on `line`: the line
    itself (trailing comment), the contiguous comment-only block
    immediately above it (comments wrap; the pragma may sit a couple of
    lines up), and — ONLY when the flagged line opens a block (``except
    Exception:``) — the comment block at the top of that block's body.
    The body scan requires deeper indentation than the opener so a
    pragma written for the NEXT statement at the same level never leaks
    upward onto a neighboring, unreviewed violation."""
    yield line
    ln = line - 1
    while ln >= 1 and ln in comment_only:
        yield ln
        ln -= 1
    src = lines[line - 1] if 0 < line <= len(lines) else ""
    if src.split("#", 1)[0].rstrip().endswith(":"):
        opener_indent = len(src) - len(src.lstrip())
        ln = line + 1
        while ln <= len(lines) and ln in comment_only:
            body = lines[ln - 1]
            if len(body) - len(body.lstrip()) <= opener_indent:
                break
            yield ln
            ln += 1


def _apply_suppressions(
    violations: list[Violation],
    pragmas: dict[int, tuple[set[str], str]],
    comment_only: set[int],
    lines: list[str],
    allowlist: list[AllowEntry],
    used_entries: set[int],
    used_pragmas: set[int],
) -> None:
    """Mark violations suppressed in place; accumulates used pragma
    lines into `used_pragmas`."""
    for v in violations:
        if v.suppressed:
            continue
        for ln in _pragma_candidate_lines(v.line, comment_only, lines):
            p = pragmas.get(ln)
            if p and v.rule in p[0]:
                v.suppressed = True
                v.suppression = f"pragma: {p[1]}"
                used_pragmas.add(ln)
                break
        if v.suppressed:
            continue
        src = lines[v.line - 1] if 0 < v.line <= len(lines) else ""
        for idx, e in enumerate(allowlist):
            if e.rule == v.rule and e.path == v.path and e.match in src:
                v.suppressed = True
                v.suppression = f"allowlist: {e.reason}"
                used_entries.add(idx)
                break


# -- entry points ------------------------------------------------------------


@dataclasses.dataclass
class _FileState:
    rel: str
    source: str
    lines: list[str]
    tree: ast.Module | None
    pragmas: dict
    comment_only: set
    meta: list
    violations: list = dataclasses.field(default_factory=list)
    used_pragmas: set = dataclasses.field(default_factory=set)


def _interprocedural_csp_seam(
    project: dataflow.Project,
    states: dict[str, _FileState],
    allowlist: list[AllowEntry],
    used_entries: set[int],
) -> None:
    """Flag callers of helpers whose bodies reach hashlib outside the
    seam — but only helpers whose own direct use is UNSUPPRESSED: a
    reviewed pragma on the helper is the reviewed design decision, and
    propagating past it would demand a pragma per caller for one
    reviewed fact.  Runs to a fixpoint so a dirty helper's caller that
    itself goes unsuppressed taints ITS callers in turn."""
    # call site index: callee qname -> [(rel, line)]
    sites: dict[str, list] = {}
    for (rel, line, col), q in project.call_resolutions.items():
        sites.setdefault(q, []).append((rel, line))
    for _ in range(8):
        dirty: set[str] = set()
        for q, fn in project.symbols.items():
            st = states.get(fn.rel)
            if st is None or dataflow._in_seam(fn.rel):
                continue
            end = getattr(fn.node, "end_lineno", fn.lineno)
            for v in st.violations:
                if (
                    v.rule == "csp-seam"
                    and not v.suppressed
                    and fn.lineno <= v.line <= end
                ):
                    dirty.add(q)
                    break
        new = []
        for q in dirty:
            for rel, line in sites.get(q, ()):
                st = states.get(rel)
                if st is None or dataflow._in_seam(rel):
                    continue
                if any(
                    v.rule == "csp-seam" and v.line == line
                    for v in st.violations
                ):
                    continue
                v = Violation(
                    rule="csp-seam", path=rel, line=line,
                    message=(
                        f"digest computed via helper {q} whose body "
                        "uses hashlib outside the CSP seam "
                        "(interprocedural) — route the helper through "
                        "common.hashing or the CSP"
                    ),
                )
                prof = profile_for(rel)
                if "csp-seam" in prof.disabled:
                    continue
                if "csp-seam" in prof.advisory:
                    v.severity = "warning"
                st.violations.append(v)
                new.append((st, v))
        if not new:
            break
        for st, v in new:
            _apply_suppressions(
                [v], st.pragmas, st.comment_only, st.lines,
                allowlist, used_entries, st.used_pragmas,
            )


def _lock_order_cycles(graph: dict):
    """Cycles in the static role-level acquisition-order graph
    (``dataflow.Project.lock_graph()`` shape).  Yields ``(cycle_roles,
    anchor_site)`` per strongly connected component with more than one
    role: the cycle is a deterministic role path around the component,
    the anchor the lexically-LAST acquisition site contributing to any
    of its edges (in file order that is the cycle-closing side,
    mirroring where runtime lockwatch would raise) — one finding per
    deadlock class, not one per contributing line."""
    edges = graph.get("edges", {})
    adj = {s: sorted(d) for s, d in edges.items()}
    # Tarjan SCC, iterative (the graph is tiny but recursion depth must
    # not depend on lock count)
    index: dict[str, int] = {}
    low: dict[str, int] = {}
    on: set[str] = set()
    stack: list[str] = []
    sccs: list[list[str]] = []
    counter = [0]

    def strongconnect(v0: str) -> None:
        work = [(v0, iter(adj.get(v0, ())))]
        index[v0] = low[v0] = counter[0]
        counter[0] += 1
        stack.append(v0)
        on.add(v0)
        while work:
            v, it = work[-1]
            advanced = False
            for w in it:
                if w not in index:
                    index[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on.add(w)
                    work.append((w, iter(adj.get(w, ()))))
                    advanced = True
                    break
                if w in on:
                    low[v] = min(low[v], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                pv = work[-1][0]
                low[pv] = min(low[pv], low[v])
            if low[v] == index[v]:
                comp = []
                while True:
                    w = stack.pop()
                    on.discard(w)
                    comp.append(w)
                    if w == v:
                        break
                sccs.append(comp)

    for v in sorted(set(adj) | {d for ds in adj.values() for d in ds}):
        if v not in index:
            strongconnect(v)
    for comp in sccs:
        if len(comp) < 2:
            continue
        comp_set = set(comp)
        # a deterministic cycle path: BFS shortest walk from the min
        # role back to itself inside the component
        start = min(comp)
        prev: dict[str, str] = {start: start}
        queue = [start]
        path = [start]
        while queue:
            node = queue.pop(0)
            hit = False
            for d in adj.get(node, ()):
                if d not in comp_set:
                    continue
                if d == start and node != start:
                    walk = [node]
                    while walk[-1] != start:
                        walk.append(prev[walk[-1]])
                    path = list(reversed(walk))
                    hit = True
                    break
                if d not in prev:
                    prev[d] = node
                    queue.append(d)
            if hit:
                break
        # anchor at the lexically-LAST contributing acquisition — in
        # file order that is the cycle-closing side, mirroring where
        # runtime lockwatch would raise
        anchor = max(
            tuple(site)
            for i, s in enumerate(path)
            for site in edges.get(s, {}).get(
                path[(i + 1) % len(path)], ()
            )
        )
        yield path, anchor


def lint_sources(
    sources: dict[str, str],
    allowlist: list[AllowEntry] | None = None,
    used_entries: set[int] | None = None,
    pinned_registry: dict | None = None,
    readme_text: str | None = None,
) -> "LintReport":
    """Lint a set of modules as one program (keys are repo-relative
    paths; interprocedural rules see across all of them).

    ``pinned_registry`` is the campaign-registry export consulted by
    chaos-coverage; ``lint_tree`` passes the checked-in artifact, while
    direct callers (fixture tests) default to None so a fixture project
    is judged against its own plan rules only.  ``readme_text`` is the
    README contents for knob-conformance's table-drift check — None
    (the direct-caller default) skips it."""
    allowlist = allowlist if allowlist is not None else []
    used_entries = used_entries if used_entries is not None else set()
    states: dict[str, _FileState] = {}
    trees: dict[str, ast.Module] = {}
    for rel, source in sorted(sources.items()):
        pragmas, comment_only, meta = _parse_pragmas(source, rel)
        try:
            tree = ast.parse(source)
        except SyntaxError as exc:
            meta = [Violation(
                rule="pragma", path=rel, line=exc.lineno or 0,
                message=f"file does not parse: {exc.msg}",
            )]
            states[rel] = _FileState(
                rel=rel, source=source, lines=source.splitlines(),
                tree=None, pragmas={}, comment_only=set(), meta=meta,
            )
            continue
        trees[rel] = tree
        states[rel] = _FileState(
            rel=rel, source=source, lines=source.splitlines(),
            tree=tree, pragmas=pragmas, comment_only=comment_only,
            meta=meta,
        )
    # reviewed wall-clock sources: lines covered by an allow[determinism]
    # / allow[taint] pragma do not SEED taint (see dataflow.Project)
    sanctioned: dict[str, set] = {}
    for rel, st in states.items():
        relevant = {
            ln for ln, (rules, _r) in st.pragmas.items()
            if rules & {"determinism", "taint"}
        }
        if not relevant:
            continue
        covered = set()
        for v_line in range(1, len(st.lines) + 1):
            for ln in _pragma_candidate_lines(
                v_line, st.comment_only, st.lines
            ):
                if ln in relevant:
                    covered.add(v_line)
                    break
        sanctioned[rel] = covered
    project = dataflow.Project(trees, sanctioned_sources=sanctioned)

    for rel, st in states.items():
        if st.tree is None:
            continue
        checker = _FileChecker(rel, st.tree, project)
        checker.visit(st.tree)
        st.violations = checker.violations

    # merge whole-program emissions into their files
    for flow in project.alias_violations:
        st = states.get(flow.rel)
        if st is not None and not any(
            v.rule == "csp-seam" and v.line == flow.line
            for v in st.violations
        ):
            st.violations.append(Violation(
                rule="csp-seam", path=flow.rel, line=flow.line,
                message=flow.message,
            ))
    for flow in project.taint_flows:
        st = states.get(flow.rel)
        if st is not None and not any(
            v.rule == "taint" and v.line == flow.line
            for v in st.violations
        ):
            st.violations.append(Violation(
                rule="taint", path=flow.rel, line=flow.line,
                message=flow.message,
            ))
    for flow in project.race_flows + project.stale_guard_flows:
        st = states.get(flow.rel)
        if st is not None and not any(
            v.rule == "racecheck" and v.line == flow.line
            for v in st.violations
        ):
            st.violations.append(Violation(
                rule="racecheck", path=flow.rel, line=flow.line,
                message=flow.message,
            ))
    for flow in project.lifecycle_flows:
        st = states.get(flow.rel)
        if st is not None and not any(
            v.rule == "thread-lifecycle" and v.line == flow.line
            for v in st.violations
        ):
            st.violations.append(Violation(
                rule="thread-lifecycle", path=flow.rel, line=flow.line,
                message=flow.message,
            ))
    # chaos-coverage (v5): seams nothing can arm, rotted plan rules
    for v in _chaos_coverage(project, pinned_registry):
        st = states.get(v.path)
        if st is not None:
            st.violations.append(v)
    # surface conformance (v6): the RPC register/call planes, the env-
    # knob read plane vs the reviewed registry, and the metric
    # producer/consumer planes
    for v in (
        _rpc_conformance(project)
        + _knob_conformance(project, sources, readme_text)
        + _metrics_conformance(project)
    ):
        st = states.get(v.path)
        if st is not None:
            st.violations.append(v)
    # static lock-order cycles (v4): one violation per cycle, anchored
    # at the lexically-last contributing acquisition (the cycle-closing
    # side in file order)
    for cycle, site in _lock_order_cycles(project.lock_graph()):
        rel, line = site
        st = states.get(rel)
        if st is not None:
            st.violations.append(Violation(
                rule="lock-order", path=rel, line=line,
                message=(
                    "static lock-order cycle: "
                    + " -> ".join(cycle + [cycle[0]])
                    + " — a thread following one order and a thread "
                    "following the other can deadlock (the static twin "
                    "of lockwatch's runtime LockOrderError); pick one "
                    "canonical order and restructure the off-order "
                    "acquisition"
                ),
            ))

    # profiles: drop disabled rules, downgrade advisory ones
    for rel, st in states.items():
        prof = profile_for(rel)
        if prof.disabled or prof.advisory:
            kept = []
            for v in st.violations:
                if v.rule in prof.disabled:
                    continue
                if v.rule in prof.advisory:
                    v.severity = "warning"
                kept.append(v)
            st.violations = kept

    for rel, st in states.items():
        _apply_suppressions(
            st.violations, st.pragmas, st.comment_only, st.lines,
            allowlist, used_entries, st.used_pragmas,
        )

    _interprocedural_csp_seam(project, states, allowlist, used_entries)

    # pragmas whose job was sanctioning a taint source count as used
    for rel, src_line in project.sanctioned_used:
        st = states.get(rel)
        if st is None:
            continue
        for ln in _pragma_candidate_lines(
            src_line, st.comment_only, st.lines
        ):
            p = st.pragmas.get(ln)
            if p and p[0] & {"determinism", "taint"}:
                st.used_pragmas.add(ln)
                break

    violations: list[Violation] = []
    for rel in sorted(states):
        st = states[rel]
        for ln in sorted(set(st.pragmas) - st.used_pragmas):
            st.meta.append(Violation(
                rule="pragma", path=rel, line=ln,
                message="unused pragma — it suppresses nothing; remove "
                        "it (or it is masking a rule that moved)",
            ))
        st.violations.sort(key=lambda v: v.line)
        violations.extend(st.violations + st.meta)
    return LintReport(
        files=len(states), violations=violations, project=project,
    )


def lint_source(
    source: str,
    rel: str,
    allowlist: list[AllowEntry] | None = None,
    used_entries: set[int] | None = None,
) -> list[Violation]:
    """Lint one module's source as if it lived at repo-relative `rel`
    (single-module program: interprocedural rules see same-file helpers
    only)."""
    report = lint_sources(
        {rel: source}, allowlist=allowlist, used_entries=used_entries
    )
    return report.violations


def repo_root() -> str:
    return os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )


def iter_target_files(root: str, targets) -> list[str]:
    rels: list[str] = []
    for target in targets:
        abs_t = os.path.join(root, target)
        if any(c in target for c in "*?["):
            hits = sorted(
                os.path.relpath(p, root).replace(os.sep, "/")
                for p in glob.glob(abs_t)
                if p.endswith(".py") and os.path.isfile(p)
            )
            hits = [r for r in hits if not _in_scope(r, SKIP_PREFIXES)]
            if not hits:
                raise FileNotFoundError(
                    f"lint target {target!r} matches no lintable .py "
                    f"file under {root}"
                )
            rels.extend(hits)
            continue
        if os.path.isfile(abs_t):
            rels.append(target.replace(os.sep, "/"))
            continue
        # a typo'd / renamed target must not silently report "clean"
        if not os.path.isdir(abs_t):
            raise FileNotFoundError(
                f"lint target {target!r} matches no file or directory "
                f"under {root}"
            )
        before = len(rels)
        for dirpath, dirnames, filenames in os.walk(abs_t):
            dirnames[:] = [
                d for d in sorted(dirnames) if d != "__pycache__"
            ]
            for fn in sorted(filenames):
                if not fn.endswith(".py"):
                    continue
                rel = os.path.relpath(
                    os.path.join(dirpath, fn), root
                ).replace(os.sep, "/")
                if not _in_scope(rel, SKIP_PREFIXES):
                    rels.append(rel)
        if len(rels) == before:
            raise FileNotFoundError(
                f"lint target {target!r} contains no lintable .py files"
            )
    return rels


@dataclasses.dataclass
class LintReport:
    files: int
    violations: list[Violation]
    project: dataflow.Project | None = None
    # populated on a dataflow-cache hit (project is None then)
    cached_summaries: list | None = None
    cached_guards: dict | None = None
    cached_lockgraph: dict | None = None
    cached_faultmap: dict | None = None
    cached_rpcmap: dict | None = None
    cached_knobmap: dict | None = None
    cached_metricmap: dict | None = None
    cache_state: str = "off"  # "off" | "miss" | "hit"

    def function_summaries(self) -> list[dict]:
        """Per-function dataflow summaries, from the live project or
        the cache — callers must not care which run produced them."""
        if self.project is not None:
            return self.project.summaries()
        return list(self.cached_summaries or [])

    def guard_map(self) -> dict:
        """The racecheck guarded-by map (declared + inferred), live or
        cached."""
        if self.project is not None:
            return dict(self.project.guard_map)
        return dict(self.cached_guards or {})

    def lock_graph(self) -> dict:
        """The static role-level acquisition-order graph (production
        sites only — what the CI artifact and the runtime-⊆-static
        cross-check consume), live or cached."""
        if self.project is not None:
            return self.project.lock_graph()
        return dict(self.cached_lockgraph or {"edges": {}, "roles": []})

    def faultmap(self) -> dict:
        """The chaos-coverage faultmap artifact (every production
        injection seam + every pinned plan rule), live or cached."""
        if self.project is not None:
            return self.project.faultmap()
        return dict(
            self.cached_faultmap
            or {"seams": [], "dynamic": [], "plans": []}
        )

    def rpcmap(self) -> dict:
        """The rpc-conformance artifact (every method with its register
        and call sites), live or cached."""
        if self.project is not None:
            return self.project.rpcmap()
        return dict(self.cached_rpcmap or {"methods": {}})

    def knobmap(self) -> dict:
        """The knob-conformance artifact (the reviewed registry joined
        with the read plane), live or cached."""
        if self.project is not None:
            return build_knob_artifact(self.project.knob_map())
        return dict(
            self.cached_knobmap
            or {"registry": {}, "reads": [], "dynamic": []}
        )

    def metricmap(self) -> dict:
        """The metrics-conformance artifact (producer/derived/consumer
        planes + the exposable series set), live or cached."""
        if self.project is not None:
            return self.project.metricmap()
        return dict(
            self.cached_metricmap
            or {"producers": [], "derived": [], "consumers": [],
                "dynamic": [], "exposed": []}
        )

    @property
    def unsuppressed(self) -> list[Violation]:
        """Unsuppressed ERROR-severity violations (the gate)."""
        return [
            v for v in self.violations
            if not v.suppressed and v.severity == "error"
        ]

    @property
    def warnings(self) -> list[Violation]:
        """Unsuppressed advisory (warning-severity) violations."""
        return [
            v for v in self.violations
            if not v.suppressed and v.severity == "warning"
        ]

    @property
    def suppressed(self) -> list[Violation]:
        return [v for v in self.violations if v.suppressed]

    def summary(self) -> dict:
        by_rule: dict[str, int] = {}
        for v in self.unsuppressed:
            by_rule[v.rule] = by_rule.get(v.rule, 0) + 1
        warn_by_rule: dict[str, int] = {}
        for v in self.warnings:
            warn_by_rule[v.rule] = warn_by_rule.get(v.rule, 0) + 1
        return {
            "tool": "fabriclint",
            "files": self.files,
            "violations": len(self.unsuppressed),
            "warnings": len(self.warnings),
            "suppressed": len(self.suppressed),
            "by_rule": dict(sorted(by_rule.items())),
            "warn_by_rule": dict(sorted(warn_by_rule.items())),
            "clean": not self.unsuppressed,
            "cache": self.cache_state,
        }


# -- dataflow-summary cache --------------------------------------------------
#
# The whole-program pass re-parses and re-analyzes ~250 files on every
# lint_tree() call; tier-1 runs several (the self-gate, CLI subprocess
# tests, the wrapper).  Results are a pure function of (engine source,
# target file contents, allowlist, targets), so lint_tree caches the
# finished report under `.fabriclint_cache/` keyed by a digest of all
# of them — any single-file edit (or an engine/allowlist change)
# changes the key, which IS the per-file invalidation.

_CACHE_DIR_NAME = ".fabriclint_torch_cache"
# v6 (surfcheck): the rpcmap/knobs/metricmap conformance artifacts
# joined the cached report (v5 added CFG summaries, flow-sensitive
# locksets, and the faultmap) — an earlier-schema entry must never
# serve
_CACHE_SCHEMA = 4
_CACHE_KEEP = 8
_engine_fp_memo: list = []


def _engine_fingerprint() -> str:
    """Digest of the analysis engine's own sources: a rule change must
    never serve a stale cached verdict."""
    if _engine_fp_memo:
        return _engine_fp_memo[0]
    import hashlib

    from fabric_tpu_torch.devtools import allowlist as _al
    from fabric_tpu_torch.devtools import guards as _guards
    from fabric_tpu_torch.devtools import knob_registry as _kr

    # fabriclint: allow[csp-seam] cache-key fingerprint of the linter's
    # own sources — tooling metadata, not consensus bytes; routing it
    # through the CSP would make the cache key depend on the backend
    h = hashlib.sha256(f"torch-{_CACHE_SCHEMA}".encode())
    # ast/parsing behavior shifts across interpreter versions: a cached
    # verdict must not outlive the interpreter that computed it
    h.update(repr(sys.version_info).encode())
    for m in (dataflow, _guards, _al, _kr):
        with open(m.__file__, "rb") as f:
            # fabriclint: allow[csp-seam] cache-key fingerprint (see above)
            h.update(hashlib.sha256(f.read()).digest())
    with open(os.path.abspath(__file__), "rb") as f:
        # fabriclint: allow[csp-seam] cache-key fingerprint (see above)
        h.update(hashlib.sha256(f.read()).digest())
    # the campaign-registry export feeds chaos-coverage verdicts: a
    # refreshed export must invalidate cached reports
    try:
        with open(FAULTMAP_REGISTRY_PATH, "rb") as f:
            # fabriclint: allow[csp-seam] cache-key fingerprint (see above)
            h.update(hashlib.sha256(f.read()).digest())
    except OSError:
        h.update(b"no-faultmap-registry")
    # knob-conformance's table-drift verdict depends on README bytes,
    # which are not in the linted source set
    try:
        with open(os.path.join(repo_root(), "README.md"), "rb") as f:
            # fabriclint: allow[csp-seam] cache-key fingerprint (see above)
            h.update(hashlib.sha256(f.read()).digest())
    except OSError:
        h.update(b"no-readme")
    _engine_fp_memo.append(h.hexdigest())
    return _engine_fp_memo[0]


def _cache_key(sources: dict[str, str], allowlist, targets) -> str:
    import hashlib

    # fabriclint: allow[csp-seam] cache key over target file contents —
    # invalidation metadata, not consensus bytes
    h = hashlib.sha256(_engine_fingerprint().encode())
    h.update(repr(sorted(targets)).encode())
    for e in allowlist:
        h.update(repr((e.rule, e.path, e.match, e.reason)).encode())
    for rel in sorted(sources):
        h.update(rel.encode())
        # fabriclint: allow[csp-seam] per-file content hash (cache key)
        h.update(hashlib.sha256(sources[rel].encode()).digest())
    return h.hexdigest()


def _cache_load(cache_dir: str, key: str) -> dict | None:
    path = os.path.join(cache_dir, f"{key[:40]}.json")
    try:
        with open(path, "r", encoding="utf-8") as f:
            entry = json.load(f)
    except (OSError, ValueError):
        return None
    if entry.get("key") != key:
        return None
    return entry


def _cache_store(cache_dir: str, key: str, entry: dict) -> None:
    try:
        os.makedirs(cache_dir, exist_ok=True)
        path = os.path.join(cache_dir, f"{key[:40]}.json")
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(entry, f, sort_keys=True)
        os.replace(tmp, path)
        # prune: newest _CACHE_KEEP entries survive
        names = [
            n for n in os.listdir(cache_dir) if n.endswith(".json")
        ]
        if len(names) > _CACHE_KEEP:
            full = sorted(
                (os.path.getmtime(os.path.join(cache_dir, n)), n)
                for n in names
            )
            for _, n in full[: len(names) - _CACHE_KEEP]:
                os.remove(os.path.join(cache_dir, n))
    except OSError:
        # a read-only checkout must not fail the lint run over a cache
        return


def lint_tree(
    root: str | None = None,
    targets=DEFAULT_TARGETS,
    allowlist: list[AllowEntry] | None = None,
    cache: bool = True,
) -> LintReport:
    root = root or repo_root()
    if allowlist is None:
        from fabric_tpu_torch.devtools.allowlist import ALLOWLIST

        allowlist = list(ALLOWLIST)
    used_entries: set[int] = set()
    rels = iter_target_files(root, targets)
    sources: dict[str, str] = {}
    for rel in rels:
        with open(os.path.join(root, rel), "r", encoding="utf-8") as f:
            sources[rel] = f.read()
    cache_dir = os.path.join(root, _CACHE_DIR_NAME)
    key = _cache_key(sources, allowlist, targets) if cache else None
    if key is not None:
        entry = _cache_load(cache_dir, key)
        if entry is not None:
            return LintReport(
                files=entry["files"],
                violations=[Violation(**v) for v in entry["violations"]],
                project=None,
                cached_summaries=entry["summaries"],
                cached_guards=entry["guards"],
                cached_lockgraph=entry["lockgraph"],
                cached_faultmap=entry["faultmap"],
                cached_rpcmap=entry["rpcmap"],
                cached_knobmap=entry["knobs"],
                cached_metricmap=entry["metricmap"],
                cache_state="hit",
            )
    try:
        with open(os.path.join(root, "README.md"), "r",
                  encoding="utf-8") as f:
            readme_text = f.read()
    except OSError:
        readme_text = None
    report = lint_sources(
        sources, allowlist, used_entries,
        pinned_registry=load_faultmap_registry(),
        readme_text=readme_text,
    )
    # an entry is in this run's scope if its file was linted, or if it
    # falls under a directory target (so full-tree runs flag entries
    # whose file was DELETED, while partial runs — one file, one subdir —
    # don't false-positive on entries they never had a chance to use)
    linted = set(rels)
    dir_prefixes = tuple(
        t.rstrip("/") + "/" for t in targets
        if not os.path.isfile(os.path.join(root, t))
    )
    for idx, e in enumerate(allowlist):
        in_scope = e.path in linted or e.path.startswith(dir_prefixes)
        if idx not in used_entries and in_scope:
            report.violations.append(Violation(
                rule="allowlist",
                path="fabric_tpu_torch/devtools/allowlist.py",
                line=0,
                message=f"unused allowlist entry ({e.rule} @ {e.path} "
                        f"matching {e.match!r}) — the code it covered "
                        f"is gone; remove the entry",
            ))
    if key is not None:
        _cache_store(cache_dir, key, {
            "key": key,
            "files": report.files,
            "violations": [v.to_dict() for v in report.violations],
            "summaries": report.function_summaries(),
            "guards": report.guard_map(),
            "lockgraph": report.lock_graph(),
            "faultmap": report.faultmap(),
            "rpcmap": report.rpcmap(),
            "knobs": report.knobmap(),
            "metricmap": report.metricmap(),
        })
        report.cache_state = "miss"
    return report


# -- baseline ratchet --------------------------------------------------------


def load_baseline(path: str) -> dict[str, int]:
    with open(path, "r", encoding="utf-8") as f:
        budgets = json.load(f)
    if not isinstance(budgets, dict) or not all(
        isinstance(k, str) and isinstance(v, int) and v >= 0
        for k, v in budgets.items()
    ):
        raise ValueError(
            f"baseline {path!r} must be a JSON object of "
            "non-negative per-rule counts"
        )
    return budgets


def apply_baseline(report: LintReport, budgets: dict[str, int]) -> dict:
    """Ratchet evaluation: per-rule unsuppressed-error counts vs the
    budget.  Over-budget rules fail; a budget LOOSER than reality also
    fails (the ratchet only tightens — stale carve-outs must die the
    moment the tree is cleaner than they claim)."""
    counts = report.summary()["by_rule"]
    over = {
        r: c - budgets.get(r, 0)
        for r, c in counts.items()
        if c > budgets.get(r, 0)
    }
    stale = {
        r: b for r, b in budgets.items()
        if b > counts.get(r, 0)
    }
    return {
        "budgets": budgets,
        "ratcheted": sum(min(counts.get(r, 0), b)
                         for r, b in budgets.items()),
        "over_budget": over,
        "stale_budget": stale,
        "ok": not over and not stale,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m fabric_tpu_torch.devtools.lint",
        description="fabriclint: invariant checker for the port's tree",
    )
    ap.add_argument(
        "targets", nargs="*", default=list(DEFAULT_TARGETS),
        help="repo-relative files/dirs to lint "
             f"(default: {' '.join(DEFAULT_TARGETS)})",
    )
    ap.add_argument("--root", default=None, help="repo root override")
    ap.add_argument(
        "--json", action="store_true",
        help="one JSON object per violation + a JSON summary line",
    )
    ap.add_argument(
        "--show-suppressed", action="store_true",
        help="also print suppressed violations",
    )
    ap.add_argument(
        "--baseline", default=None, metavar="FILE",
        help="JSON {rule: count} ratchet: tolerate up to COUNT "
             "unsuppressed errors per rule (stale budgets fail)",
    )
    ap.add_argument(
        "--write-baseline", default=None, metavar="FILE",
        help="record current per-rule unsuppressed-error counts and "
             "exit 0",
    )
    ap.add_argument(
        "--summaries", action="store_true",
        help="dump the dataflow engine's per-function summaries (JSON)",
    )
    ap.add_argument(
        "--guards", action="store_true",
        help="dump the racecheck guarded-by map (declared + inferred) "
             "as JSON and exit",
    )
    ap.add_argument(
        "--lockgraph", action="store_true",
        help="dump the static role-level lock acquisition-order graph "
             "(production sites) as JSON and exit",
    )
    ap.add_argument(
        "--faultmap", action="store_true",
        help="dump the chaos-coverage faultmap (every production "
             "faultline seam + every pinned plan rule) as JSON and exit",
    )
    ap.add_argument(
        "--rpcmap", action="store_true",
        help="dump the rpc-conformance map (every RPC method with its "
             "register and call sites) as JSON and exit",
    )
    ap.add_argument(
        "--knobs", action="store_true",
        help="dump the knob-conformance map (the reviewed FABRIC_TPU_* "
             "registry joined with every read site) as JSON and exit",
    )
    ap.add_argument(
        "--metricmap", action="store_true",
        help="dump the metrics-conformance map (producer/derived/"
             "consumer planes + the exposable series set) as JSON and "
             "exit",
    )
    ap.add_argument(
        "--no-cache", action="store_true",
        help="skip the .fabriclint_torch_cache dataflow cache (escape "
             "hatch)",
    )
    args = ap.parse_args(argv)

    try:
        report = lint_tree(
            root=args.root, targets=tuple(args.targets),
            cache=not args.no_cache,
        )
    except FileNotFoundError as exc:
        print(json.dumps({"tool": "fabriclint", "error": str(exc)})
              if args.json else f"fabriclint: error: {exc}",
              file=sys.stderr)
        return 2

    if args.summaries:
        for s in report.function_summaries():
            print(json.dumps(s))
        return 0
    if args.guards:
        print(json.dumps(report.guard_map(), indent=2, sort_keys=True))
        return 0
    if args.lockgraph:
        print(json.dumps(report.lock_graph(), indent=2, sort_keys=True))
        return 0
    if args.faultmap:
        print(json.dumps(report.faultmap(), indent=2, sort_keys=True))
        return 0
    if args.rpcmap:
        print(json.dumps(report.rpcmap(), indent=2, sort_keys=True))
        return 0
    if args.knobs:
        print(json.dumps(report.knobmap(), indent=2, sort_keys=True))
        return 0
    if args.metricmap:
        print(json.dumps(report.metricmap(), indent=2, sort_keys=True))
        return 0

    shown = list(report.unsuppressed) + list(report.warnings)
    if args.show_suppressed:
        shown += report.suppressed
    for v in shown:
        print(json.dumps(v.to_dict()) if args.json else str(v))

    summary = report.summary()
    if args.write_baseline:
        with open(args.write_baseline, "w", encoding="utf-8") as f:
            json.dump(summary["by_rule"], f, indent=2, sort_keys=True)
            f.write("\n")
        print(json.dumps({**summary, "baseline_written":
                          args.write_baseline}))
        return 0
    if args.baseline:
        ratchet = apply_baseline(report, load_baseline(args.baseline))
        summary["baseline"] = ratchet
        print(json.dumps(summary))
        return 0 if ratchet["ok"] else 1
    print(json.dumps(summary))
    return 0 if not report.unsuppressed else 1


if __name__ == "__main__":
    sys.exit(main())
