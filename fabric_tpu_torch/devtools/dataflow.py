"""fabriclint dataflow — the whole-program half of the port's checker.

The port's copy of the JAX package's ``fabric_tpu/devtools/dataflow.py``,
pointed at ``fabric_tpu_torch/``: the same engine with the port's
constants (the CSP seam is ``fabric_tpu_torch/csp/``, ``csp/cuda/``
included, with ``common/hashing.py`` and ``common/crypto.py``; the
lockwatch, workpool, clockskew, faultline, knob, metric and RPC helpers
are the port's).  It imports the standard library only.

A per-function linter sees one function at a time, so a digest
computed in a helper, wall-clock smuggled through two assignments into
an encoded header, or an fsync three calls below ``commit_lock`` would
all slip past the gate.  This module closes that class: it parses every
module in the lint target set ONCE, resolves module-level imports and
aliases (``import hashlib as h``, ``from time import time``, relative
imports), builds a call graph over names it can resolve statically
(module-level functions, same-module helpers, ``self.`` methods of the
enclosing class), and computes per-function summaries to a fixpoint:

``uses_hashlib`` / ``uses_hashlib_transitive``
    touches ``hashlib`` directly / reaches it through helpers whose own
    modules are outside the CSP seam (propagation STOPS at seam modules:
    calling ``common.hashing.sha256`` is the fix, not a violation).

``returns_digest``
    returns a value produced by a hash call (hashlib, the seam's
    sha256/sha256_many, a CSP ``hash``/``hash_batch``) — directly or via
    a digest-returning callee.

``blocking`` / ``blocking_transitive``
    performs blocking I/O (fsync/flush/execute/sleep...) directly / via
    any resolvable call chain.  lint.py uses this to extend the
    under-``commit_lock`` rule across function and module boundaries.

``spawns_thread`` / ``acquires_locks``
    creates ``threading.Thread``s / lexically ``with``-acquires known
    lock roles — thread-lifecycle and lock-order context for reviewers
    and the thread-hygiene rule.

``returns_wallclock`` / ``param_to_return`` / ``param_to_sink``
    the taint summaries: the function returns a wall-clock-derived
    value; parameter *i* flows to the return value; parameter *i* flows
    into a consensus-bytes sink (protoutil call, construction of a schema
    class of the port's codec, ``.encode()`` of such a message).

``returns_proto``
    the function returns a message of the codec's schema classes
    (constructed, decoded, annotated, or returned by such a callee) —
    what ties a caller's ``.encode()`` to the codec rather than to
    ``str.encode``.

On top of the summaries run the interprocedural emissions:

taint
    ``time.time()`` / ``datetime.now()`` / module-level ``random.*``
    values tracked through assignments, attribute fills
    (``hdr.timestamp = ts``), f-strings, arithmetic, and resolvable
    calls, flagged where they ENTER a sink — protoutil marshaling or
    protobuf (block-header) construction — whichever module that happens
    in.  The codec marshals with ``Message.encode(deterministic=...)``
    (``protos/wire.py``), a name ``str.encode`` shares, so ``.encode()``
    is a sink only on a value the engine has tied to a schema class of
    ``fabric_tpu_torch.protos``: constructed from it, annotated with it,
    decoded through it, or returned by a summarised callee that returns
    one.  A bare ``.encode()`` on anything else stays silent.  Tainted
    ``self`` attributes propagate across methods of the
    same class (``self._inc = int(time.time()*1000)`` in ``__init__``
    taints ``self._inc`` in every other method).

csp-seam (alias half)
    a local binding to ``hashlib`` (``h = hashlib``;
    ``digest = h.sha256``) used outside the seam — the spelling the
    intraprocedural attribute check cannot see.  The helper-call half
    (callers of hashlib-using helpers) is emitted by lint.py's checker
    using ``call_resolutions`` + the summaries here.

racecheck (v3)
    whole-program lockset inference + shared-state race detection.  A
    CLASS REGISTRY records, per class, which ``self.<attr>`` members
    are locks (``named_lock/named_rlock/named_condition`` roles, or a
    ``<Class>.<attr>`` pseudo-role for plain ``threading.Lock()``
    members) and which carry a statically known class type (annotated
    params/fields, direct constructor assignments) — the latter powers
    TYPE-INFORMED CALL RESOLUTION, so ``ledger.commit(...)`` on a
    ``ledger: KVLedger`` parameter lands in the call graph instead of
    falling off it.  A LOCKSET PASS then records, for every
    ``self._x`` (and declared module-global) read or write, the set of
    lock roles lexically held at that point, plus the lockset held at
    every resolvable call site; an interprocedural meet (set
    intersection over all incoming call paths) extends those locksets
    across function boundaries.  Fields acquire a GUARDED-BY role from
    the reviewed declaration table (``devtools/guards.py``) or, for
    undeclared mutable fields, by majority inference across their
    access sites.  Any access on a path from a THREAD ENTRY POINT
    (``lockwatch.spawn_thread``/``spawn_timer`` targets,
    ``threading.Thread``/``Timer`` ctors, ``executor.submit``, RPC/
    gossip ``.register``/``.subscribe`` handlers) whose lockset misses
    the field's guard is emitted as a racecheck flow.  ``__init__``
    bodies are excluded (the object is unpublished), a with-context
    that looks like a lock but cannot be resolved contributes an
    UNKNOWN token that suppresses rather than fabricates findings, and
    fields never written outside ``__init__`` are immune — three
    precision rules that keep the rule deployable at error severity.

hbcheck (v4)
    the happens-before layer.  The lockset walk additionally records
    POSITIONAL synchronization events per function — thread
    ``start()``/``join()``/``cancel()`` resolved to their entry qnames
    (through locals, ``self`` attrs, container joins, and chained
    ``spawn(...).start()``), ``drain_threads`` as a join of every
    entry, ``Event.set/clear/wait`` and ``Queue.put/get`` resolved to
    per-object sync tokens (class members and function-locals shared
    with closures), and ``workpool.run_chunked`` as a start+join pair
    at the call line.  A thread-entry SET (union over call paths,
    unlike the lockset meet) tells each access WHO can run it; a
    pairwise order check then proves accesses safe: same single
    domain, start-edge before every entry the counterpart runs under,
    join-edge after it completed, or a matching release→acquire token
    pair.  Proven-safe sites are exempt from racecheck emission (they
    still vote in guard inference), fully-ordered fields resolve as
    ``hb-publish`` in the guard map, and the same machinery emits
    post-``start()`` writes that race their publication point,
    cross-thread ``Event`` re-arms, and stale declared guards.  Two
    more passes ride the recorded facts: the role-level lock
    ACQUISITION-ORDER GRAPH (lexical held-sets + an interprocedural
    may-held union over production callers; ``lock_graph()`` exports
    it, lint.py fails cycles, tier-1 asserts the runtime lockwatch
    graph is a subgraph) and THREAD-LIFECYCLE reachability (every
    spawn site is classified by what happens to its handle —
    attr/local/container binding with an observed join/cancel/
    shutdown, ownership transfer by return/handoff, a stop-signal
    probe in the entry, or a bounded worker body — and anything else
    is an error).

The engine is deliberately static and approximate: only statically
resolvable names participate in the call graph, attribute calls on
foreign objects fall back to the per-name heuristics, and taint is
flow-insensitively accumulated (two body iterations per round).  The
approximations are all CONSERVATIVE for the rules built on top, and
every false positive costs exactly one reviewed pragma — the currency
this linter already trades in.
"""

from __future__ import annotations

import ast
import dataclasses
import re

# modules allowed to touch hashlib directly — the canonical definition
# (lint.py imports it from here so the two passes can never disagree)
CSP_SEAM_ALLOWED = (
    "fabric_tpu_torch/csp/",
    "fabric_tpu_torch/common/hashing.py",
    "fabric_tpu_torch/common/crypto.py",
)

# files linted under the relaxed profile: the port's tests, the card
# script at the root, and `scripts/` as the JAX package's linter treats
# it (lint.py's profile_for reads this too)
RELAXED_PREFIXES = ("tests/", "scripts/", "chip_smoke.py")

BLOCKING_CALLS = frozenset(
    {"fsync", "sync_files", "sleep", "flush", "execute", "executemany"}
)

# taint sinks: consensus bytes are born in these places — a call into
# protoutil, the construction of a schema class of the codec, and
# `.encode(...)` on a value tied to such a class (`_PROTO_ENCODE_ATTRS`;
# `str.encode` shares the name, so the attribute alone is no sink)
_PROTOUTIL_PREFIX = "fabric_tpu_torch.protoutil"
_PROTO_MODULE_PREFIX = "fabric_tpu_torch.protos."
_PROTO_ENCODE_ATTRS = frozenset({"encode"})
# the codec's own plumbing modules: their names are functions and base
# classes, not schema classes
_PROTO_PLUMBING = ("fabric_tpu_torch.protos.wire.",
                   "fabric_tpu_torch.protos.jsonpb.")

# hash producers for the returns-digest summary
_SEAM_HASH_FNS = (
    "fabric_tpu_torch.common.hashing.sha256",
    "fabric_tpu_torch.common.hashing.sha256_many",
    "fabric_tpu_torch.common.crypto.sha256",
    "fabric_tpu_torch.common.crypto.sha256_many",
)
_HASH_ATTRS = frozenset({"hash", "hash_batch", "digest", "hexdigest"})

_WALL = "wall"
_MAX_ROUNDS = 12

# -- racecheck vocabulary ----------------------------------------------------

# lock constructors recognized on `self.<attr> = ...` / module globals;
# named_* carry an explicit lockwatch role, plain threading primitives
# get a `<owner>.<attr>` pseudo-role so their guarded fields still
# participate in lockset inference
_NAMED_LOCK_FNS = frozenset({
    "fabric_tpu_torch.devtools.lockwatch.named_lock",
    "fabric_tpu_torch.devtools.lockwatch.named_rlock",
    "fabric_tpu_torch.devtools.lockwatch.named_condition",
})
_PLAIN_LOCK_FNS = frozenset({
    "threading.Lock",
    "threading.RLock",
    "threading.Condition",
})

_SPAWN_THREAD_FNS = frozenset({
    "fabric_tpu_torch.devtools.lockwatch.spawn_thread",
    "threading.Thread",
})
_SPAWN_TIMER_FNS = frozenset({
    "fabric_tpu_torch.devtools.lockwatch.spawn_timer",
    "threading.Timer",
})
# attribute calls whose function-valued arguments run on foreign
# threads: executor submissions and RPC/gossip handler registration
_SUBMIT_ATTRS = frozenset({"submit"})
_HANDLER_REG_ATTRS = frozenset({"register", "subscribe"})

# a with-context that names a lock we cannot resolve to a role: it MAY
# be the guard, so accesses under it are never flagged and never feed
# majority inference
_UNKNOWN_LOCK = "?"

# gossip payload digests are consensus-adjacent bytes: peers compare /
# request private data by these digests, so a wall-clock-derived value
# entering one forks the gossip view exactly like a forked block header.
# Sink = the seam hash functions when called from gossip modules.
_GOSSIP_SINK_SCOPE = "fabric_tpu_torch/gossip/"

# -- happens-before vocabulary (v4) ------------------------------------------

# synchronization-object constructors recognized on members/locals: an
# Event's set()->wait() and a Queue's put()->get() are publication
# edges (everything sequenced before the release side is visible after
# the matching acquire side)
_EVENT_CTOR_FNS = frozenset({"threading.Event"})
_QUEUE_CTOR_FNS = frozenset({
    "queue.Queue", "queue.SimpleQueue", "queue.LifoQueue",
    "queue.PriorityQueue",
})
# executor factories: their registration is a thread-lifecycle site of
# its own (shutdown() is the stop path the rule demands)
_EXECUTOR_FNS = frozenset({
    "fabric_tpu_torch.devtools.lockwatch.tracked_executor",
    "concurrent.futures.ThreadPoolExecutor",
})
# run_chunked(fn, ...) is a synchronous submit->result fan-out: the
# chunk callable is a thread entry (it runs on pool workers,
# concurrently with its sibling chunks), and the CALL SITE is both a
# start edge (caller's prior writes are published to the workers) and
# a join edge (workers' writes are published back before the call
# returns)
_RUN_CHUNKED_FNS = frozenset({"fabric_tpu_torch.common.workpool.run_chunked"})
# drain_threads joins every registered worker: a join edge from ALL
# spawn_thread entries to the statements after it
_DRAIN_FNS = frozenset({"fabric_tpu_torch.devtools.lockwatch.drain_threads"})
_CLOCKSKEW_WAIT = "fabric_tpu_torch.devtools.clockskew.wait"

# the faultline injection API: callee qname -> seam kind.  `io` wraps a
# socket and registers TWO derived points (`<name>.read`/`<name>.write`)
_FAULTLINE_FNS = {
    "fabric_tpu_torch.devtools.faultline.point": "point",
    # the port's `stall` is a point whose tripped delay is handed back
    # to the caller (a device's stall) instead of slept
    "fabric_tpu_torch.devtools.faultline.stall": "point",
    "fabric_tpu_torch.devtools.faultline.guard": "guard",
    "fabric_tpu_torch.devtools.faultline.write": "write",
    "fabric_tpu_torch.devtools.faultline.io": "io",
}
# the chaos seam's own implementation files: their faultline calls are
# plumbing, not production injection points (mirrors lint._CHAOS_SEAM)
_FAULTLINE_IMPL = (
    "fabric_tpu_torch/devtools/faultline.py",
    "fabric_tpu_torch/devtools/faultfuzz.py",
    "fabric_tpu_torch/devtools/clockskew.py",
    "fabric_tpu_torch/common/tracing.py",
)

# -- v6 surface scans (rpc / knob / metric conformance raw facts) ------------

# RPC method names are `svc.Method` — lowercase service, capitalized
# method (the reference's gRPC naming).  The regex is the discriminator
# that keeps unrelated `.register(...)`/`.call(...)` attribute calls
# (atexit.register, plan.call, ...) out of the map.
_RPC_METHOD_RE = re.compile(r"^[a-z][A-Za-z0-9]*\.[A-Z][A-Za-z0-9]*$")
_RPC_VERBS = ("call", "stream", "duplex")
# verb a client must use per statically inferred handler shape
_RPC_SHAPE_FOR_VERB = {"call": "unary", "stream": "stream",
                       "duplex": "duplex"}
# returned-call attr names that are bytes-producing, not
# iterator-producing: a handler `return X.SerializeToString()` is
# unary even though the callee does not resolve statically
_RPC_BYTES_ATTRS = ("encode", "SerializeToString", "digest", "dumps",
                    "to_bytes", "pack", "getvalue", "join")
# component classification for rpcmap sites: exact rels first, then
# path prefixes, else the file's package segment
_RPC_COMPONENT_FILES = {
    "fabric_tpu_torch/node/peer_node.py": "peer",
    "fabric_tpu_torch/node/orderer_node.py": "orderer",
    "fabric_tpu_torch/node/devnode.py": "devnode",
    "fabric_tpu_torch/devtools/netnode.py": "netnode",
    "fabric_tpu_torch/devtools/netharness.py": "netharness",
    "fabric_tpu_torch/csp/custody.py": "custody",
}
_RPC_COMPONENT_PREFIXES = (
    ("tests/", "tests"),
    ("scripts/", "scripts"),
    ("fabric_tpu_torch/cmd/", "cli"),
    ("fabric_tpu_torch/gateway/", "gateway"),
)

_KNOB_PREFIX = "FABRIC_TPU_"
# the one sanctioned env-read path (devtools/knob_registry.py) and the
# raw reads every other site must not use
_KNOB_IMPL = ("fabric_tpu_torch/devtools/knob_registry.py",)
_KNOB_HELPER_FNS = (
    "fabric_tpu_torch.devtools.knob_registry.raw",
    "fabric_tpu_torch.devtools.knob_registry.spec",
)
_ENV_READ_FNS = ("os.environ.get", "os.getenv")

_METRIC_OPTS = {
    "fabric_tpu_torch.common.metrics.CounterOpts": "counter",
    "fabric_tpu_torch.common.metrics.GaugeOpts": "gauge",
    "fabric_tpu_torch.common.metrics.HistogramOpts": "histogram",
}
_METRIC_NEW_FNS = ("new_counter", "new_gauge", "new_histogram")
# netscope's rollup/SLO code consumes series by name through string
# comparisons and `("_derived", name, ...)` ring keys; only there do
# bare snake_case literals count as metric-name consumption
_NETSCOPE_REL = "fabric_tpu_torch/devtools/netscope.py"
_METRIC_NAME_RE = re.compile(r"^[a-z][a-z0-9]*(?:_[a-z0-9]+)+$")
_HISTOGRAM_SUFFIXES = ("_bucket", "_sum", "_count")


def _proto_parts(target: str | None) -> list | None:
    """The segments of `target` after ``fabric_tpu_torch.protos.<module>``
    when it names a schema class of the codec (or an attribute of one:
    ``Block.decode``), else None.  The codec's plumbing modules and the
    schema modules' own functions name no class."""
    if (
        target is None
        or not target.startswith(_PROTO_MODULE_PREFIX)
        or target.startswith(_PROTO_PLUMBING)
    ):
        return None
    parts = target[len(_PROTO_MODULE_PREFIX):].split(".")
    if len(parts) < 2 or not parts[1][:1].isupper():
        return None
    return parts[1:]


def _proto_value_target(target: str | None) -> bool:
    """True when calling `target` yields a message of the codec: a schema
    class (nested classes too) or its ``decode``."""
    parts = _proto_parts(target)
    if parts is None:
        return False
    return all(p[:1].isupper() for p in parts) or parts[-1] == "decode"


def _rpc_component(rel: str) -> str:
    comp = _RPC_COMPONENT_FILES.get(rel)
    if comp is not None:
        return comp
    for prefix, name in _RPC_COMPONENT_PREFIXES:
        if rel.startswith(prefix):
            return name
    parts = rel.split("/")
    return parts[1] if len(parts) > 2 else parts[-1].rsplit(".", 1)[0]


def _literal_strs(expr) -> set:
    """The string values `expr` can statically take: a literal, or an
    IfExp whose both branches are literals (cmd/peer.py picks
    `deliver.Deliver` vs `ab.Deliver` that way)."""
    if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
        return {expr.value}
    if isinstance(expr, ast.IfExp):
        a, b = _literal_strs(expr.body), _literal_strs(expr.orelse)
        if a and b:
            return a | b
    return set()


def _str_consts(nodes) -> dict:
    """name -> possible string literal values, from single-target
    assignments in a scope's own statements (flow-insensitive)."""
    out: dict[str, set] = {}
    for n in nodes:
        if (
            isinstance(n, ast.Assign)
            and len(n.targets) == 1
            and isinstance(n.targets[0], ast.Name)
        ):
            vals = _literal_strs(n.value)
            if vals:
                out.setdefault(n.targets[0].id, set()).update(vals)
    return out


def _resolve_str_arg(expr, local_consts: dict, mod_consts: dict) -> set:
    vals = _literal_strs(expr)
    if vals:
        return vals
    if isinstance(expr, ast.Name):
        return set(
            local_consts.get(expr.id) or mod_consts.get(expr.id) or ()
        )
    return set()

def _own_nodes(root):
    """AST nodes of `root` excluding nested function subtrees — a
    closure's statements run on the closure's schedule, not inline in
    the enclosing function (nested defs get their own scans)."""
    yield root
    stack = list(ast.iter_child_nodes(root))
    while stack:
        n = stack.pop()
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        yield n
        stack.extend(ast.iter_child_nodes(n))


# the chaos/observability seams: their blocking calls (faultline.
# write's torn-path flush, clockskew/faultline injected sleeps,
# tracing's flight-recorder dump/export I/O) only execute under an
# armed plan / virtual clock / armed tracer — with nothing armed every
# seam call is a no-op, so their blocking-io summaries must not
# propagate into callers (mirror of the decision that faultline.*
# is transparent to exception-discipline)
_CHAOS_SEAM = (
    "fabric_tpu_torch/devtools/faultline.py",
    "fabric_tpu_torch/devtools/clockskew.py",
    "fabric_tpu_torch/common/tracing.py",
)


def _in_seam(rel: str) -> bool:
    return any(rel.startswith(p) for p in CSP_SEAM_ALLOWED)


def _module_dotted(rel: str) -> str:
    """Repo-relative path -> dotted module name."""
    if rel.endswith("/__init__.py"):
        rel = rel[: -len("/__init__.py")]
    elif rel.endswith(".py"):
        rel = rel[:-3]
    return rel.replace("/", ".")


def _iter_nested_defs(stmts):
    """Function definitions nested one level down inside a statement
    list (descending through control flow but not into the found defs
    themselves — recursion registers deeper levels — nor into nested
    classes, which are out of model)."""
    for s in stmts:
        if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield s
        elif isinstance(s, ast.ClassDef):
            continue
        else:
            for attr in ("body", "orelse", "finalbody"):
                sub = getattr(s, attr, None)
                if sub:
                    yield from _iter_nested_defs(sub)
            for h in getattr(s, "handlers", ()):
                yield from _iter_nested_defs(h.body)
            for c in getattr(s, "cases", ()):  # match statements
                yield from _iter_nested_defs(c.body)


def _dotted(expr) -> str | None:
    """``a.b.c`` as a string; None for anything fancier."""
    parts = []
    while isinstance(expr, ast.Attribute):
        parts.append(expr.attr)
        expr = expr.value
    if not isinstance(expr, ast.Name):
        return None
    parts.append(expr.id)
    return ".".join(reversed(parts))


@dataclasses.dataclass
class FunctionInfo:
    rel: str
    qname: str  # dotted: module[.Class].name
    name: str
    cls: str | None
    lineno: int
    params: list[str]
    node: object  # ast.FunctionDef | ast.AsyncFunctionDef
    # direct facts
    uses_hashlib: bool = False
    blocking: bool = False
    spawns_thread: bool = False
    acquires_locks: set = dataclasses.field(default_factory=set)
    calls: list = dataclasses.field(default_factory=list)  # resolved qnames
    # fixpoint facts
    uses_hashlib_transitive: bool = False
    blocking_transitive: bool = False
    returns_digest: bool = False
    returns_wallclock: bool = False
    # the function returns a message of the codec's schema classes: a
    # caller's `.encode()` on its result is a consensus-bytes sink
    returns_proto: bool = False
    param_to_return: set = dataclasses.field(default_factory=set)
    param_to_sink: set = dataclasses.field(default_factory=set)
    # racecheck facts: (field qname, "read"|"write", line, frozenset of
    # lock roles lexically held) and (callee qname, frozenset held)
    accesses: list = dataclasses.field(default_factory=list)
    call_locks: list = dataclasses.field(default_factory=list)
    # lock-order facts (v4): every lexical acquisition with the roles
    # already held at that point — the static acquisition-order graph
    # is assembled from these plus the interprocedural may-held set
    lock_acquires: list = dataclasses.field(default_factory=list)
    # happens-before events (v4), all positional within this function:
    # (entry qname | None, line) thread starts; (entry qname | "*",
    # line) joins; (sync token, line, heldset) event set/clear and
    # queue put on the release side, event wait and queue get on the
    # acquire side
    hb_starts: list = dataclasses.field(default_factory=list)
    hb_joins: list = dataclasses.field(default_factory=list)
    hb_rel: list = dataclasses.field(default_factory=list)
    hb_acq: list = dataclasses.field(default_factory=list)
    hb_clears: list = dataclasses.field(default_factory=list)
    # thread-lifecycle facts: this function blocks on a stop signal
    # (event wait/is_set, queue get on a known queue) / contains an
    # unbounded while loop
    stop_probe: bool = False
    has_while: bool = False
    # v5 "flowcheck": the function's control-flow graph (built during
    # the lockset pass) and the lock roles proven held somewhere by the
    # explicit acquire/release dataflow rather than a `with` scope
    cfg: object = None
    flow_lock_roles: set = dataclasses.field(default_factory=set)

    def summary(self) -> dict:
        """JSON-shaped summary (CLI ``--summaries``, tests)."""
        out = {
            "function": self.qname,
            "file": self.rel,
            "line": self.lineno,
            "returns_digest": self.returns_digest,
            "returns_wallclock": self.returns_wallclock,
            "uses_hashlib": self.uses_hashlib_transitive,
            "blocking_io": self.blocking_transitive,
            "spawns_thread": self.spawns_thread,
            "acquires_locks": sorted(self.acquires_locks),
            "param_to_sink": sorted(self.param_to_sink),
            "accesses": len(self.accesses),
        }
        # happens-before facts (v4) ride the artifact only where they
        # exist — most functions have none and the lines stay diffable
        if (self.hb_starts or self.hb_joins or self.hb_rel
                or self.hb_acq or self.stop_probe):
            out["hb"] = {
                "starts": len(self.hb_starts),
                "joins": len(self.hb_joins),
                "releases": len(self.hb_rel),
                "acquires": len(self.hb_acq),
                "stop_probe": self.stop_probe,
            }
        # CFG shape facts (v5) ride wherever a graph was built and is
        # non-trivial — straight-line helpers stay one diffable line
        if self.cfg is not None and getattr(self.cfg, "n", 0) > 1:
            out["cfg"] = self.cfg.stats()
            if self.flow_lock_roles:
                out["cfg"]["flow_locks"] = sorted(self.flow_lock_roles)
        return out


@dataclasses.dataclass
class ClassInfo:
    """Per-class registry entry for racecheck + typed call resolution."""

    rel: str
    qname: str
    name: str
    # attr -> lock role (lockwatch role string, or qname pseudo-role)
    lock_roles: dict = dataclasses.field(default_factory=dict)
    # attr -> class qname (annotated params/fields, ctor assignments)
    field_types: dict = dataclasses.field(default_factory=dict)
    # every attr assigned through `self.` anywhere in the class
    fields: set = dataclasses.field(default_factory=set)
    # attr -> "event" | "queue" (synchronization members: HB edges)
    sync_types: dict = dataclasses.field(default_factory=dict)
    # attr -> thread-entry qname (or None when the target does not
    # resolve) for members assigned from spawn_thread/spawn_timer/
    # Thread/Timer — lets `self._thread.start()`/`.join()` in OTHER
    # methods resolve to the spawned entry
    spawn_attrs: dict = dataclasses.field(default_factory=dict)
    # attrs assigned from tracked_executor/ThreadPoolExecutor
    exec_attrs: set = dataclasses.field(default_factory=set)


@dataclasses.dataclass
class ModuleInfo:
    rel: str
    dotted: str
    tree: ast.Module
    imports: dict = dataclasses.field(default_factory=dict)  # name -> dotted
    functions: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class TaintFlow:
    """One wall-clock value entering a consensus-bytes sink."""

    rel: str
    line: int
    message: str


# -- per-function control-flow graph (v5 "flowcheck") ----------------------

_TRY_STAR = getattr(ast, "TryStar", ())
_MATCH_STMT = getattr(ast, "Match", ())


class _CFG:
    """Basic blocks + edges over ONE function's own statements.

    Built once per function during the lockset pass; every source line
    of the function maps to a program point ``(block, stmt)`` so the
    happens-before engine can ask order questions that respect branch
    structure and loop back edges instead of comparing line numbers:

    * ``event_precedes(e, a)`` — the HB event at line ``e`` (a join,
      ``Event.wait``, ``Queue.get``) is sequenced before the access at
      line ``a`` on every execution that reaches the access: same
      block in statement order, a dominating block, or a block that
      strictly precedes the access block (reaches it, never reached
      back).  Per-iteration order inside one block of a loop counts —
      a consumer that gets then reads each iteration is ordered.
    * ``access_precedes(a, e)`` — the access at ``a`` runs strictly
      before the HB event at ``e`` on EVERY execution containing both.
      A back edge defeats this: a write and a thread start in the same
      loop body are NOT ordered, because iteration 2's write races
      iteration 1's started thread.
    * ``may_follow(e, a)`` — some execution performs the event at
      ``e`` and later reaches ``a`` (the post-publication direction).

    ``with`` bodies stay inline (no branching — the lexical lockset
    scan already IS the meet-over-paths answer for them); ``try``
    bodies edge into every handler and into ``finally``; ``while
    True`` loops exit only through ``break``.  Lines the builder could
    not map (decorators, nested defs) fall back to positional order,
    so a partial graph can only make the analysis more conservative.
    """

    __slots__ = ("n", "succs", "preds", "back_edges", "_counts",
                 "_points", "_reach_memo", "_dom")

    def __init__(self):
        self.n = 0
        self.succs: list[set] = []
        self.preds: list[set] = []
        self.back_edges: set = set()
        self._counts: list[int] = []
        self._points: dict[int, tuple] = {}
        self._reach_memo: dict[int, frozenset] = {}
        self._dom: list | None = None

    # -- construction ------------------------------------------------------

    @classmethod
    def build(cls, fnnode) -> "_CFG":
        cfg = cls()
        try:
            entry = cfg._new_block()
            cfg._seq(fnnode.body, entry, [])
        except RecursionError:  # pragma: no cover - pathological nesting
            cfg._points.clear()
        return cfg

    def _new_block(self) -> int:
        self.succs.append(set())
        self.preds.append(set())
        self._counts.append(0)
        self.n += 1
        return self.n - 1

    def _edge(self, a: int, b: int, back: bool = False) -> None:
        self.succs[a].add(b)
        self.preds[b].add(a)
        if back:
            self.back_edges.add((a, b))

    def _place(self, block: int, stmt, hi: int | None = None) -> None:
        """Assign ``stmt``'s lines to the next point of ``block``.

        ``hi`` caps the claimed range for compound statements so body
        lines stay claimable by the body's own blocks (first writer
        wins via setdefault)."""
        idx = self._counts[block]
        self._counts[block] += 1
        lo = stmt.lineno
        if hi is None:
            hi = getattr(stmt, "end_lineno", None) or lo
        for ln in range(lo, max(lo, hi) + 1):
            self._points.setdefault(ln, (block, idx))

    def _join(self, outs: list) -> int | None:
        outs = [b for b in dict.fromkeys(outs) if b is not None]
        if not outs:
            return None
        if len(outs) == 1:
            return outs[0]
        j = self._new_block()
        for b in outs:
            self._edge(b, j)
        return j

    def _seq(self, stmts, cur: int | None, loops: list) -> int | None:
        """Thread ``stmts`` through the graph; returns the fallthrough
        block, or None when every path ended (return/raise/break)."""
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue  # nested scopes own their lines
            if cur is None:
                cur = self._new_block()  # unreachable tail: orphan block
            if isinstance(stmt, ast.If):
                self._place(cur, stmt, stmt.test.end_lineno)
                t0 = self._new_block()
                self._edge(cur, t0)
                t_end = self._seq(stmt.body, t0, loops)
                if stmt.orelse:
                    e0 = self._new_block()
                    self._edge(cur, e0)
                    e_end = self._seq(stmt.orelse, e0, loops)
                    cur = self._join([t_end, e_end])
                else:
                    cur = self._join([t_end, cur])
            elif isinstance(stmt, (ast.While, ast.For, ast.AsyncFor)):
                hdr = self._new_block()
                self._edge(cur, hdr)
                cond = stmt.test if isinstance(stmt, ast.While) else stmt.iter
                self._place(hdr, stmt, cond.end_lineno)
                b0 = self._new_block()
                self._edge(hdr, b0)
                breaks: list = []
                b_end = self._seq(stmt.body, b0, loops + [(hdr, breaks)])
                if b_end is not None:
                    self._edge(b_end, hdr, back=True)
                infinite = (isinstance(stmt, ast.While)
                            and isinstance(stmt.test, ast.Constant)
                            and bool(stmt.test.value))
                outs = list(breaks)
                if not infinite:
                    o_end: int | None = hdr
                    if stmt.orelse:
                        o0 = self._new_block()
                        self._edge(hdr, o0)
                        o_end = self._seq(stmt.orelse, o0, loops)
                    outs.append(o_end)
                cur = self._join(outs)
            elif isinstance(stmt, (ast.With, ast.AsyncWith)):
                hi = max((it.context_expr.end_lineno or stmt.lineno)
                        for it in stmt.items)
                self._place(cur, stmt, max(stmt.lineno, hi))
                cur = self._seq(stmt.body, cur, loops)
            elif isinstance(stmt, ast.Try) or isinstance(stmt, _TRY_STAR):
                self._place(cur, stmt, stmt.lineno)
                b0 = self._new_block()
                self._edge(cur, b0)
                b_end = self._seq(stmt.body, b0, loops)
                body_hi = self.n  # blocks [b0, body_hi) can raise
                h_entries = []
                for h in stmt.handlers:
                    h0 = self._new_block()
                    self._place(h0, h, h.lineno)
                    h_entries.append(h0)
                    self._edge(cur, h0)
                    for bb in range(b0, body_hi):
                        self._edge(bb, h0)
                h_ends = [self._seq(h.body, h0, loops)
                          for h, h0 in zip(stmt.handlers, h_entries)]
                o_end = b_end
                if stmt.orelse and b_end is not None:
                    o_end = self._seq(stmt.orelse, b_end, loops)
                outs = [o_end] + h_ends
                if stmt.finalbody:
                    f0 = self._new_block()
                    for b in outs:
                        if b is not None:
                            self._edge(b, f0)
                    # exceptional entry: any body/handler block may
                    # unwind straight into the finally suite
                    for bb in range(b0, body_hi):
                        self._edge(bb, f0)
                    for h0 in h_entries:
                        self._edge(h0, f0)
                    self._edge(cur, f0)
                    cur = self._seq(stmt.finalbody, f0, loops)
                else:
                    cur = self._join(outs)
            elif isinstance(stmt, _MATCH_STMT):
                self._place(cur, stmt, stmt.subject.end_lineno)
                outs = [cur]  # conservative no-match fallthrough
                for case in stmt.cases:
                    c0 = self._new_block()
                    self._edge(cur, c0)
                    outs.append(self._seq(case.body, c0, loops))
                cur = self._join(outs)
            elif isinstance(stmt, (ast.Return, ast.Raise)):
                self._place(cur, stmt)
                cur = None
            elif isinstance(stmt, ast.Break):
                self._place(cur, stmt)
                if loops:
                    loops[-1][1].append(cur)
                cur = None
            elif isinstance(stmt, ast.Continue):
                self._place(cur, stmt)
                if loops:
                    self._edge(cur, loops[-1][0], back=True)
                cur = None
            else:
                self._place(cur, stmt)
        return cur

    # -- queries -----------------------------------------------------------

    def point(self, line: int) -> tuple | None:
        return self._points.get(line)

    def _reach(self, b: int) -> frozenset:
        """Blocks reachable from ``b`` through one or more edges."""
        memo = self._reach_memo.get(b)
        if memo is None:
            seen: set = set()
            stack = list(self.succs[b])
            while stack:
                x = stack.pop()
                if x not in seen:
                    seen.add(x)
                    stack.extend(self.succs[x] - seen)
            memo = self._reach_memo[b] = frozenset(seen)
        return memo

    def _cyclic(self, b: int) -> bool:
        return b in self._reach(b)

    def _dominators(self) -> list:
        if self._dom is None:
            every = frozenset(range(self.n))
            dom = [every] * self.n
            if self.n:
                dom[0] = frozenset([0])
            changed = True
            while changed:
                changed = False
                for b in range(1, self.n):
                    ps = self.preds[b]
                    if ps:
                        new = frozenset.intersection(
                            *[dom[p] for p in ps]) | {b}
                    else:
                        new = frozenset([b])  # orphan: its own entry
                    if new != dom[b]:
                        dom[b] = new
                        changed = True
            self._dom = dom
        return self._dom

    def event_precedes(self, event_line: int, access_line: int) -> bool:
        pe, pa = self.point(event_line), self.point(access_line)
        if pe is None or pa is None:
            return event_line < access_line  # positional fallback
        (be, se), (ba, sa) = pe, pa
        if be == ba:
            return se < sa  # per-iteration order holds in a cycle too
        if be in self._dominators()[ba]:
            return True
        return ba in self._reach(be) and be not in self._reach(ba)

    def access_precedes(self, access_line: int, event_line: int) -> bool:
        pe, pa = self.point(event_line), self.point(access_line)
        if pe is None or pa is None:
            return access_line < event_line
        (be, se), (ba, sa) = pe, pa
        if be == ba:
            return sa < se and not self._cyclic(ba)
        return be in self._reach(ba) and ba not in self._reach(be)

    def may_follow(self, event_line: int, access_line: int) -> bool:
        pe, pa = self.point(event_line), self.point(access_line)
        if pe is None or pa is None:
            return event_line < access_line
        (be, se), (ba, sa) = pe, pa
        if be == ba:
            return se < sa or self._cyclic(ba)
        return ba in self._reach(be)

    def stats(self) -> dict:
        return {
            "blocks": self.n,
            "edges": sum(len(s) for s in self.succs),
            "back_edges": len(self.back_edges),
        }


def _flow_locksets(cfg: _CFG, ops: list):
    """Forward must-hold dataflow over explicit ``.acquire()`` /
    ``.release()`` calls (``ops``: ``(line, "acq"|"rel", role)``).

    Returns ``at(line) -> frozenset(roles)`` — the roles PROVEN held at
    that program point on every path from the function entry.  IN of a
    block is the meet (intersection) over predecessor OUTs; within a
    block, ops apply in statement order, and an op's effect becomes
    visible from the NEXT statement (the acquire call itself does not
    guard its own line).  Lines outside the graph prove nothing."""
    if not ops or not cfg.n:
        empty = frozenset()
        return lambda line: empty
    block_ops: dict[int, list] = {}
    for i, (line, op, role) in enumerate(ops):
        p = cfg.point(line)
        if p is not None:
            block_ops.setdefault(p[0], []).append((p[1], i, op, role))
    for v in block_ops.values():
        v.sort()

    def transfer(b: int, held: frozenset) -> frozenset:
        for _s, _i, op, role in block_ops.get(b, ()):
            held = held | {role} if op == "acq" else held - {role}
        return held

    n = cfg.n
    in_sets: list = [None] * n
    out_sets: list = [None] * n
    for _round in range(4 * n + 8):
        changed = False
        for b in range(n):
            preds = cfg.preds[b]
            if b == 0 or not preds:
                inb: frozenset | None = frozenset()
            else:
                pouts = [out_sets[p] for p in preds
                         if out_sets[p] is not None]
                inb = frozenset.intersection(*pouts) if pouts else None
            if inb is None:
                continue
            in_sets[b] = inb
            ob = transfer(b, inb)
            if ob != out_sets[b]:
                out_sets[b] = ob
                changed = True
        if not changed:
            break

    empty = frozenset()

    def at(line: int) -> frozenset:
        p = cfg.point(line)
        if p is None or in_sets[p[0]] is None:
            return empty
        b, s = p
        held = in_sets[b]
        for si, _i, op, role in block_ops.get(b, ()):
            if si >= s:
                break
            held = held | {role} if op == "acq" else held - {role}
        return held

    return at


class Project:
    """Whole-program model over the lint target set.

    ``sanctioned_sources`` maps rel -> line numbers whose wall-clock
    source calls are covered by a reviewed ``allow[determinism]`` or
    ``allow[taint]`` pragma: a REVIEWED source does not propagate —
    otherwise one sanctioned client-side timestamp would demand a
    pragma at every downstream marshal site, and the suppression
    surface would grow instead of shrink."""

    def __init__(self, trees: dict[str, ast.Module],
                 sanctioned_sources: dict[str, set] | None = None,
                 declared_guards: dict[str, str] | None = None):
        if declared_guards is None:
            from fabric_tpu_torch.devtools.guards import DECLARED_GUARDS

            declared_guards = DECLARED_GUARDS
        self.declared_guards = dict(declared_guards)
        self.sanctioned_sources = sanctioned_sources or {}
        # (rel, line) of sanctioned sources the engine actually hit —
        # lint.py counts their pragmas as used (the pragma's job was to
        # stop propagation, not to suppress a same-line violation)
        self.sanctioned_used: set[tuple] = set()
        self.modules: dict[str, ModuleInfo] = {}
        self.symbols: dict[str, FunctionInfo] = {}
        # (rel, lineno, col_offset) of a Call node -> resolved callee qname
        self.call_resolutions: dict[tuple, str] = {}
        # csp-seam alias violations found during the facts pass
        self.alias_violations: list[TaintFlow] = []
        self.taint_flows: list[TaintFlow] = []
        # racecheck emissions + the inferred guarded-by map behind them
        self.race_flows: list[TaintFlow] = []
        self.guard_map: dict[str, dict] = {}
        # v4: thread-lifecycle emissions, stale-guard emissions, the
        # static lock-order graph ((src role, dst role) -> sorted
        # acquisition sites), and the spawn-site registry feeding the
        # lifecycle rule
        self.lifecycle_flows: list[TaintFlow] = []
        self.stale_guard_flows: list[TaintFlow] = []
        self.lock_order_edges: dict[tuple, list] = {}
        self.spawn_sites: list[dict] = []
        # (owner qname | None, attr) pairs a join/cancel/shutdown call
        # is observed on anywhere in the program; None-owner entries
        # match by attr name (the conservative fallback when the base
        # object's class cannot be resolved)
        self._attr_joins: set = set()
        self._attr_shutdowns: set = set()
        # local sync objects (events/queues) visible to a function and
        # its closures: per-fn qname -> {name: (kind, token)}; lookup
        # walks the enclosing-scope chain, tokens are keyed by the
        # DEFINING function so sibling closures' same-named locals
        # never unify
        self._fn_local_sync: dict[str, dict] = {}
        # (field, kind, line, fn qname) -> True for accesses proven
        # safe by happens-before edges (exposed for tests/artifacts)
        self.hb_safe_sites: set = set()
        self._spawn_seen: set = set()
        # entry qnames that can run as several concurrent threads at
        # once (pool chunks, executor jobs, handlers, loop-spawned
        # workers): a shared single domain is NOT thread confinement
        self._multi_entries: set = set()
        # class registry (racecheck + typed call resolution)
        self.classes: dict[str, ClassInfo] = {}
        self.module_lock_roles: dict[str, str] = {}  # dotted name -> role
        self._attr_role_unique: dict[str, str | None] = {}
        # fn qname -> how it becomes a thread entry (for messages)
        self.thread_entries: dict[str, str] = {}
        # ClassDef qname -> names of self attributes holding wall-clock
        self._class_taint: dict[str, set] = {}
        # v5 chaos-coverage raw facts: every faultline seam call in
        # production code, seam calls whose name is not a string
        # literal, and every literal fault-plan rule anywhere
        self.faultline_seams: list[dict] = []
        self.faultline_dynamic: list[dict] = []
        self.faultline_plans: list[dict] = []
        # v6 surface-scan raw facts: the RPC register/call planes, the
        # FABRIC_TPU env-knob read sites, and the metric producer/
        # consumer planes (rules 12-14 + the --rpcmap/--knobs/
        # --metricmap artifacts consume these)
        self.rpc_registers: list[dict] = []
        self.rpc_calls: list[dict] = []
        self.knob_sites: list[dict] = []
        self.knob_dynamic: list[dict] = []
        self.metric_producers: list[dict] = []
        self.metric_derived: list[dict] = []
        self.metric_consumers: list[dict] = []
        self.metric_dynamic: list[dict] = []
        for rel, tree in sorted(trees.items()):
            self._load_module(rel, tree)
        self._collect_classes()
        self._collect_facts()
        self._fixpoint_booleans()
        self._fixpoint_taint()
        self._lockset_pass_all()
        self._interproc_lock_edges()
        self._racecheck()
        self._lifecycle()
        self._chaos_scan()
        self._rpc_scan()
        self._knob_scan()
        self._metric_scan()

    # -- module loading ----------------------------------------------------

    def _load_module(self, rel: str, tree: ast.Module) -> None:
        mod = ModuleInfo(rel=rel, dotted=_module_dotted(rel), tree=tree)
        pkg = mod.dotted.rsplit(".", 1)[0] if "." in mod.dotted else ""
        if rel.endswith("/__init__.py"):
            pkg = mod.dotted
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    mod.imports[a.asname or a.name.split(".")[0]] = (
                        a.name if a.asname else a.name.split(".")[0]
                    )
                    if a.asname:
                        mod.imports[a.asname] = a.name
            elif isinstance(node, ast.ImportFrom):
                base = node.module or ""
                if node.level:
                    up = pkg.split(".") if pkg else []
                    up = up[: len(up) - (node.level - 1)]
                    base = ".".join(up + ([node.module] if node.module else []))
                for a in node.names:
                    if a.name == "*":
                        continue
                    mod.imports[a.asname or a.name] = (
                        f"{base}.{a.name}" if base else a.name
                    )
        for stmt in tree.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._add_function(mod, stmt, cls=None)
            elif isinstance(stmt, ast.ClassDef):
                for sub in stmt.body:
                    if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        self._add_function(mod, sub, cls=stmt.name)
        self.modules[rel] = mod

    def _add_function(self, mod: ModuleInfo, node, cls: str | None,
                      parent: str | None = None) -> None:
        if parent is not None:
            qname = f"{parent}.<locals>.{node.name}"
        else:
            qname = (
                f"{mod.dotted}.{cls}.{node.name}" if cls
                else f"{mod.dotted}.{node.name}"
            )
        a = node.args
        params = [p.arg for p in a.posonlyargs + a.args]
        fn = FunctionInfo(
            rel=mod.rel, qname=qname, name=node.name, cls=cls,
            lineno=node.lineno, params=params, node=node,
        )
        mod.functions.append(fn)
        self.symbols[qname] = fn
        # locally-defined functions get their own symbols under a
        # `<qname>.<locals>.` scope: closures passed to spawn_thread /
        # Thread (the committer's commit_loop, rpc's stream pull) are
        # real thread entries racecheck must see.  They keep the
        # enclosing `cls` so closed-over `self.x` accesses resolve into
        # the class registry.
        for sub in _iter_nested_defs(node.body):
            self._add_function(mod, sub, cls=cls, parent=qname)

    # -- name resolution ---------------------------------------------------

    def _resolve_expr(self, mod: ModuleInfo, expr, cls: str | None,
                      local: dict, types: dict | None = None) -> str | None:
        """Resolve a Name/Attribute chain to a dotted target through
        local bindings, module imports, and (when `types` maps names to
        class qnames) annotated-parameter/field types.  ``self.x``
        resolves into the enclosing class; ``self.f.m`` and ``p.m``
        resolve through the class registry when ``f``/``p`` have a
        statically known class.  Returns e.g. "hashlib.sha256",
        "time.time", "fabric_tpu_torch.ledger.kvledger.KVLedger.commit"."""
        dotted = _dotted(expr)
        if dotted is None:
            return None
        head, _, rest = dotted.partition(".")
        if head == "self" and cls is not None:
            if not rest:
                return None
            first, _, tail = rest.partition(".")
            if tail:
                # typed self-field chain: self._ledger.commit resolves
                # through the field's declared/constructed class
                ci = self.classes.get(f"{mod.dotted}.{cls}")
                ft = ci.field_types.get(first) if ci else None
                if ft is not None:
                    return f"{ft}.{tail}"
            return f"{mod.dotted}.{cls}.{rest}"
        if types and rest and head in types:
            return f"{types[head]}.{rest}"
        target = local.get(head) or mod.imports.get(head)
        if target is None:
            # same-module symbol?
            cand = f"{mod.dotted}.{dotted}"
            if cand in self.symbols:
                return cand
            return None
        return f"{target}.{rest}" if rest else target

    # -- class registry (racecheck + typed resolution) ---------------------

    def _annotation_class(self, mod: ModuleInfo, ann) -> str | None:
        """The class qname an annotation statically names, or None.
        Handles Name/Attribute, string annotations, ``X | None`` unions
        and ``Optional[X]`` — anything fancier is out of model."""
        if ann is None:
            return None
        if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
            try:
                ann = ast.parse(ann.value, mode="eval").body
            except SyntaxError:
                return None
        if isinstance(ann, ast.BinOp) and isinstance(ann.op, ast.BitOr):
            return (self._annotation_class(mod, ann.left)
                    or self._annotation_class(mod, ann.right))
        if isinstance(ann, ast.Subscript):
            base = _dotted(ann.value)
            if base is not None and base.rsplit(".", 1)[-1] == "Optional":
                return self._annotation_class(mod, ann.slice)
            return None
        if not isinstance(ann, (ast.Name, ast.Attribute)):
            return None
        target = self._resolve_expr(mod, ann, None, {})
        if target in self.classes:
            return target
        return None

    @staticmethod
    def _role_from_ctor(target: str | None, call: ast.Call,
                        pseudo: str) -> str | None:
        """Lock role for a `<member> = <lock ctor>(...)` assignment:
        the named_* role string when constant, else the member's own
        qname as a pseudo-role (plain threading primitives included)."""
        if target in _NAMED_LOCK_FNS:
            if (
                call.args
                and isinstance(call.args[0], ast.Constant)
                and isinstance(call.args[0].value, str)
            ):
                return call.args[0].value
            return pseudo
        if target in _PLAIN_LOCK_FNS:
            return pseudo
        return None

    @staticmethod
    def _spawn_api(target: str | None) -> str | None:
        """"thread" / "timer" / "executor" when `target` is a thread-
        creating callable; None otherwise."""
        if target in _SPAWN_THREAD_FNS:
            return "thread"
        if target in _SPAWN_TIMER_FNS:
            return "timer"
        if target in _EXECUTOR_FNS:
            return "executor"
        return None

    @staticmethod
    def _spawn_kind(target: str | None, call: ast.Call) -> str:
        """The threadwatch kind of a spawn call (explicit kind= or the
        seam's default: workers from spawn_thread, services from
        spawn_timer)."""
        for k in call.keywords:
            if k.arg == "kind" and isinstance(k.value, ast.Constant):
                return str(k.value.value)
        return "service" if target in _SPAWN_TIMER_FNS else "worker"

    def _scoped_symbol(self, scope: str, name: str) -> str | None:
        """`name` resolved against `scope`'s ``<locals>`` chain: probe
        ``scope.<locals>.name``, then each enclosing function scope —
        the ONE closure-resolution rule (spawn targets, sibling-closure
        calls, and thread-entry registration all share it)."""
        while True:
            cand = f"{scope}.<locals>.{name}"
            if cand in self.symbols:
                return cand
            if ".<locals>." not in scope:
                return None
            scope = scope.rsplit(".<locals>.", 1)[0]

    def _spawn_entry(self, mod: ModuleInfo, call: ast.Call, cls,
                     local: dict, types: dict,
                     scope: str | None = None) -> str | None:
        """The thread-entry qname a spawn/Thread/Timer ctor targets (a
        known symbol, including `<locals>` closures when `scope` gives
        the enclosing function), or None when unresolvable."""
        target = self._resolve_expr(mod, call.func, cls, local, types)
        kw_name = "function" if target in _SPAWN_TIMER_FNS else "target"
        expr = None
        for k in call.keywords:
            if k.arg == kw_name:
                expr = k.value
        if expr is None:
            if target in _SPAWN_TIMER_FNS and len(call.args) >= 2:
                expr = call.args[1]
            elif (
                target in _SPAWN_THREAD_FNS
                and target != "threading.Thread"
                and call.args
            ):
                expr = call.args[0]
        if expr is None:
            return None
        if isinstance(expr, ast.Name) and scope is not None:
            scoped = self._scoped_symbol(scope, expr.id)
            if scoped is not None:
                return scoped
        q = self._resolve_expr(mod, expr, cls, local, types)
        return q if q in self.symbols else None

    def _collect_classes(self) -> None:
        # phase 1: every class must exist before any annotation can
        # resolve to it (cross-module field types)
        for mod in self.modules.values():
            for stmt in mod.tree.body:
                if isinstance(stmt, ast.ClassDef):
                    q = f"{mod.dotted}.{stmt.name}"
                    self.classes[q] = ClassInfo(
                        rel=mod.rel, qname=q, name=stmt.name
                    )
                elif (
                    isinstance(stmt, ast.Assign)
                    and len(stmt.targets) == 1
                    and isinstance(stmt.targets[0], ast.Name)
                    and isinstance(stmt.value, ast.Call)
                ):
                    # module-level locks guard module-level state
                    name = stmt.targets[0].id
                    target = self._resolve_expr(mod, stmt.value.func, None, {})
                    role = self._role_from_ctor(
                        target, stmt.value, f"{mod.dotted}.{name}"
                    )
                    if role is not None:
                        self.module_lock_roles[f"{mod.dotted}.{name}"] = role
        # phase 2: member scan (locks, field types, assigned attrs)
        for mod in self.modules.values():
            for stmt in mod.tree.body:
                if not isinstance(stmt, ast.ClassDef):
                    continue
                ci = self.classes[f"{mod.dotted}.{stmt.name}"]
                for fnnode in stmt.body:
                    if not isinstance(
                        fnnode, (ast.FunctionDef, ast.AsyncFunctionDef)
                    ):
                        continue
                    a = fnnode.args
                    ann_params = {
                        p.arg: p.annotation
                        for p in a.posonlyargs + a.args + a.kwonlyargs
                        if p.annotation is not None
                    }
                    for node in ast.walk(fnnode):
                        if isinstance(node, ast.Assign):
                            # every `self.X = ...` target registers,
                            # including chained assigns like
                            # `self._stop = stop = Event()`
                            attrs = [
                                t.attr for t in node.targets
                                if isinstance(t, ast.Attribute)
                                and isinstance(t.value, ast.Name)
                                and t.value.id == "self"
                            ]
                            if not attrs:
                                continue
                            for attr in attrs:
                                ci.fields.add(attr)
                            v = node.value
                            if isinstance(v, ast.Call):
                                target = self._resolve_expr(
                                    mod, v.func, stmt.name, {}
                                )
                                for attr in attrs:
                                    role = self._role_from_ctor(
                                        target, v, f"{ci.qname}.{attr}"
                                    )
                                    if role is not None:
                                        ci.lock_roles[attr] = role
                                    elif target in self.classes:
                                        ci.field_types.setdefault(
                                            attr, target
                                        )
                                    elif target in _EVENT_CTOR_FNS:
                                        ci.sync_types[attr] = "event"
                                    elif target in _QUEUE_CTOR_FNS:
                                        ci.sync_types[attr] = "queue"
                                    elif target in _EXECUTOR_FNS:
                                        ci.exec_attrs.add(attr)
                                    elif self._spawn_api(target) in (
                                        "thread", "timer"
                                    ):
                                        ci.spawn_attrs[attr] = (
                                            self._spawn_entry(
                                                mod, v, stmt.name, {}, {}
                                            )
                                        )
                            elif (
                                isinstance(v, ast.Name)
                                and v.id in ann_params
                            ):
                                tq = self._annotation_class(
                                    mod, ann_params[v.id]
                                )
                                if tq is not None:
                                    for attr in attrs:
                                        ci.field_types.setdefault(attr, tq)
                        elif (
                            isinstance(node, (ast.AnnAssign, ast.AugAssign))
                            and isinstance(node.target, ast.Attribute)
                            and isinstance(node.target.value, ast.Name)
                            and node.target.value.id == "self"
                        ):
                            ci.fields.add(node.target.attr)
                            if isinstance(node, ast.AnnAssign):
                                tq = self._annotation_class(
                                    mod, node.annotation
                                )
                                if tq is not None:
                                    ci.field_types[node.target.attr] = tq
        # attr name -> role when ONE role owns that spelling across the
        # whole program: lets `with self._ledger.commit_lock:` resolve
        # even where the field's type is unannotated
        unique: dict[str, str | None] = {}
        for ci in self.classes.values():
            for attr, role in ci.lock_roles.items():
                if attr in unique and unique[attr] != role:
                    unique[attr] = None
                else:
                    unique[attr] = role
        self._attr_role_unique = unique

    # -- facts pass --------------------------------------------------------

    def _collect_facts(self) -> None:
        for mod in self.modules.values():
            for fn in mod.functions:
                self._facts_for(mod, fn)

    def _facts_for(self, mod: ModuleInfo, fn: FunctionInfo) -> None:
        local: dict[str, str] = {}
        seam = _in_seam(mod.rel)
        # annotated params with statically known classes: the type env
        # behind type-informed call resolution
        a = fn.node.args
        types: dict[str, str] = {}
        for p in a.posonlyargs + a.args + a.kwonlyargs:
            tq = self._annotation_class(mod, p.annotation)
            if tq is not None:
                types[p.arg] = tq
        fn._types = types
        for node in ast.walk(fn.node):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                # `types` rides along so a local bound from an annotated
                # param's field (`lk = ledger.commit_lock`) resolves to
                # the field's qname — the lockset pass then maps the
                # bare `with lk:` to the field's lock role
                bound = self._resolve_expr(
                    mod, node.value, fn.cls, local, types
                )
                if bound is not None and not isinstance(node.value, ast.Call):
                    local[node.targets[0].id] = bound
                    if not seam and (
                        bound == "hashlib" or bound.startswith("hashlib.")
                    ):
                        self.alias_violations.append(TaintFlow(
                            rel=mod.rel, line=node.lineno,
                            message=f"local alias "
                                    f"{node.targets[0].id!r} binds "
                                    f"{bound} outside the CSP seam — "
                                    "aliasing does not launder a direct "
                                    "hashlib dependency (route through "
                                    "common.hashing or the CSP)",
                        ))
            elif isinstance(node, ast.Call):
                target = self._resolve_expr(
                    mod, node.func, fn.cls, local, types
                )
                if target is None and isinstance(node.func, ast.Name):
                    # closure-to-closure resolution (v4): a bare-name
                    # call probes the enclosing `<locals>` scopes, so a
                    # nested def calling its own nested defs or sibling
                    # closures stays on the call graph — thread targets
                    # defined as closures keep their callees' lockset/
                    # HB facts
                    nm = node.func.id
                    if nm not in local and nm not in fn.params:
                        target = self._scoped_symbol(fn.qname, nm)
                if target is not None:
                    if target in self.symbols:
                        fn.calls.append(target)
                        self.call_resolutions[
                            (mod.rel, node.lineno, node.col_offset)
                        ] = target
                    if target == "hashlib" or target.startswith("hashlib."):
                        fn.uses_hashlib = True
                    if target in (
                        "threading.Thread",
                        "threading.Timer",
                        "fabric_tpu_torch.devtools.lockwatch.spawn_thread",
                        "fabric_tpu_torch.devtools.lockwatch.spawn_timer",
                    ):
                        fn.spawns_thread = True
                f = node.func
                if isinstance(f, ast.Attribute):
                    if f.attr in BLOCKING_CALLS:
                        fn.blocking = True
                    if (
                        isinstance(f.value, ast.Name)
                        and local.get(f.value.id, "").startswith("hashlib")
                    ):
                        fn.uses_hashlib = True
            elif isinstance(node, ast.With):
                for item in node.items:
                    name = None
                    ctx = item.context_expr
                    if isinstance(ctx, ast.Attribute):
                        name = ctx.attr
                    elif isinstance(ctx, ast.Name):
                        name = ctx.id
                    if name is not None and (
                        "lock" in name.lower() or name in ("_idle",)
                    ):
                        fn.acquires_locks.add(name)
        fn.uses_hashlib_transitive = fn.uses_hashlib and not seam
        fn.blocking_transitive = fn.blocking and fn.rel not in _CHAOS_SEAM
        fn.returns_digest = self._returns_digest_direct(mod, fn, local)
        fn._local_bindings = local  # reused by the taint pass
        # names stored more than once anywhere in this function: a lock
        # ALIAS among them is ambiguous — the binding map is flow-
        # insensitive (last write wins), so crediting it would attach
        # the WRONG lock's role to earlier with-blocks.  _role_of_ctx
        # degrades rebound aliases to the UNKNOWN lockset instead.
        store_counts: dict[str, int] = {}
        for node in ast.walk(fn.node):
            if isinstance(node, ast.Name) and isinstance(
                node.ctx, ast.Store
            ):
                store_counts[node.id] = store_counts.get(node.id, 0) + 1
        fn._rebound = {k for k, c in store_counts.items() if c > 1}
        # unbounded-loop fact for the thread-lifecycle rule's bounded-
        # worker heuristic (own statements only: a closure's loop runs
        # on the closure's thread, not this one)
        def _has_while(n) -> bool:
            for child in ast.iter_child_nodes(n):
                if isinstance(
                    child, (ast.FunctionDef, ast.AsyncFunctionDef)
                ):
                    continue
                if isinstance(child, ast.While) or _has_while(child):
                    return True
            return False

        fn.has_while = _has_while(fn.node)
        # callee qnames appearing inside Return expressions, computed
        # once — the returns-digest fixpoint is a set lookup, not a
        # re-walk of the caller's AST per round
        ret_calls: set = set()
        for node in ast.walk(fn.node):
            if isinstance(node, ast.Return) and node.value is not None:
                for sub in ast.walk(node.value):
                    if isinstance(sub, ast.Call):
                        q = self.call_resolutions.get(
                            (mod.rel, sub.lineno, sub.col_offset)
                        )
                        if q is not None:
                            ret_calls.add(q)
        fn._return_callees = ret_calls

    def _returns_digest_direct(self, mod: ModuleInfo, fn: FunctionInfo,
                               local: dict) -> bool:
        for node in ast.walk(fn.node):
            if not isinstance(node, ast.Return) or node.value is None:
                continue
            for sub in ast.walk(node.value):
                if not isinstance(sub, ast.Call):
                    continue
                target = self._resolve_expr(mod, sub.func, fn.cls, local)
                if target is not None and (
                    target.startswith("hashlib.")
                    or target in _SEAM_HASH_FNS
                ):
                    return True
                if isinstance(sub.func, ast.Attribute) \
                        and sub.func.attr in _HASH_ATTRS:
                    return True
        return False

    # -- boolean fixpoints -------------------------------------------------

    def _fixpoint_booleans(self) -> None:
        changed = True
        rounds = 0
        while changed and rounds < _MAX_ROUNDS:
            changed = False
            rounds += 1
            for fn in self.symbols.values():
                for callee_q in fn.calls:
                    callee = self.symbols.get(callee_q)
                    if callee is None:
                        continue
                    if callee.blocking_transitive and not fn.blocking_transitive:
                        fn.blocking_transitive = True
                        changed = True
                    # hashlib reach propagates only through NON-seam
                    # callees: calling the seam is the sanctioned route
                    if (
                        callee.uses_hashlib_transitive
                        and not _in_seam(callee.rel)
                        and not _in_seam(fn.rel)
                        and not fn.uses_hashlib_transitive
                    ):
                        fn.uses_hashlib_transitive = True
                        changed = True
                    if (
                        callee.returns_digest
                        and not fn.returns_digest
                        and callee_q in fn._return_callees
                    ):
                        fn.returns_digest = True
                        changed = True

    # -- taint -------------------------------------------------------------

    def _fixpoint_taint(self) -> None:
        for _ in range(_MAX_ROUNDS):
            changed = False
            for mod in self.modules.values():
                for fn in mod.functions:
                    if self._taint_pass(mod, fn, emit=False):
                        changed = True
            if not changed:
                break
        seen = set()
        for mod in self.modules.values():
            for fn in mod.functions:
                self._taint_pass(mod, fn, emit=True, seen=seen)

    def _is_wall_source(self, target: str | None) -> bool:
        if target is None:
            return False
        if target == "time.time":
            return True
        if target.startswith("datetime.") and target.rsplit(".", 1)[-1] in (
            "now", "utcnow", "today"
        ):
            return True
        if target.startswith("random.") and target.rsplit(".", 1)[-1] not in (
            "Random", "SystemRandom"
        ):
            return True
        return False

    def _proto_annotation(self, mod: ModuleInfo, ann) -> bool:
        """True when an annotation names a schema class of the codec
        (string annotations, ``X | None`` and ``Optional[X]`` included)."""
        if ann is None:
            return False
        if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
            try:
                ann = ast.parse(ann.value, mode="eval").body
            except SyntaxError:
                return False
        if isinstance(ann, ast.BinOp) and isinstance(ann.op, ast.BitOr):
            return (self._proto_annotation(mod, ann.left)
                    or self._proto_annotation(mod, ann.right))
        if isinstance(ann, ast.Subscript):
            base = _dotted(ann.value)
            if base is not None and base.rsplit(".", 1)[-1] == "Optional":
                return self._proto_annotation(mod, ann.slice)
            return False
        if not isinstance(ann, (ast.Name, ast.Attribute)):
            return False
        parts = _proto_parts(self._resolve_expr(mod, ann, None, {}))
        return parts is not None and all(p[:1].isupper() for p in parts)

    def _sink_for(self, mod: ModuleInfo, node: ast.Call, cls, local,
                  proto_base: bool = False):
        """(kind, detail) when this call consumes its arguments into
        consensus bytes; None otherwise.  `proto_base` says the engine
        has tied the receiver of an attribute call to a schema class of
        the codec, which makes its ``.encode()`` the marshal."""
        f = node.func
        if (
            isinstance(f, ast.Attribute)
            and f.attr in _PROTO_ENCODE_ATTRS
            and proto_base
        ):
            return ("serialize", f.attr)
        target = self._resolve_expr(mod, f, cls, local)
        if target is not None and (
            target.startswith(_PROTOUTIL_PREFIX)
            or _proto_parts(target) is not None
        ):
            tail = target.rsplit(".", 1)[-1]
            kind = "proto-ctor" if tail[:1].isupper() else "protoutil"
            return (kind, target)
        # gossip payload digests: peers dedupe/pull/verify by these
        # bytes, so a wall-clock-derived input forks the gossip view
        if (
            mod.rel.startswith(_GOSSIP_SINK_SCOPE)
            and target is not None
            and (target in _SEAM_HASH_FNS
                 or target.startswith("hashlib."))
        ):
            return ("gossip-digest", target)
        return None

    def _taint_pass(self, mod: ModuleInfo, fn: FunctionInfo,
                    emit: bool, seen: set | None = None) -> bool:
        env: dict[str, frozenset] = {
            p: frozenset({("param", i)}) for i, p in enumerate(fn.params)
        }
        if fn.cls is not None and fn.params and fn.params[0] == "self":
            env["self"] = frozenset()
        cls_q = f"{mod.dotted}.{fn.cls}" if fn.cls else None
        local = getattr(fn, "_local_bindings", {})
        changed = [False]
        # names the engine has tied to a schema class of the codec
        a = fn.node.args
        proto_vars: set[str] = {
            p.arg for p in a.posonlyargs + a.args + a.kwonlyargs
            if self._proto_annotation(mod, p.annotation)
        }
        if self._proto_annotation(mod, fn.node.returns) \
                and not fn.returns_proto:
            fn.returns_proto = True
            changed[0] = True

        def is_proto(node) -> bool:
            if isinstance(node, ast.Name):
                return node.id in proto_vars
            if isinstance(node, ast.Call):
                if _proto_value_target(self._resolve_expr(
                    mod, node.func, fn.cls, local
                )):
                    return True
                q = self.call_resolutions.get(
                    (mod.rel, node.lineno, node.col_offset)
                )
                callee = self.symbols.get(q) if q else None
                return callee is not None and callee.returns_proto
            return False

        def note_proto(target, value) -> None:
            if isinstance(target, ast.Name) and is_proto(value):
                proto_vars.add(target.id)

        def note_param_summary(labels, add_to: set) -> None:
            for lb in labels:
                if isinstance(lb, tuple) and lb[0] == "param":
                    if lb[1] not in add_to:
                        add_to.add(lb[1])
                        changed[0] = True

        def ev(node) -> frozenset:
            if isinstance(node, ast.Name):
                return env.get(node.id, frozenset())
            if isinstance(node, ast.Constant):
                return frozenset()
            if isinstance(node, ast.Call):
                return ev_call(node)
            if isinstance(node, ast.Attribute):
                base = ev(node.value)
                dotted = _dotted(node)
                if dotted is not None and dotted in env:
                    base = base | env[dotted]
                if (
                    cls_q is not None
                    and isinstance(node.value, ast.Name)
                    and node.value.id == "self"
                    and node.attr in self._class_taint.get(cls_q, ())
                ):
                    base = base | frozenset({_WALL})
                return base
            if isinstance(node, ast.JoinedStr):
                out = frozenset()
                for v in node.values:
                    out |= ev(v)
                return out
            if isinstance(node, ast.FormattedValue):
                return ev(node.value)
            out = frozenset()
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.expr):
                    out |= ev(child)
            return out

        def arg_labels(node: ast.Call, callee: FunctionInfo | None):
            """position -> labels, including keywords mapped through the
            callee's parameter names (methods: skip the self slot)."""
            out: dict[int, frozenset] = {}
            shift = 1 if callee is not None and callee.params[:1] == ["self"] \
                else 0
            for i, a in enumerate(node.args):
                out[i + shift] = ev(a)
            for kw in node.keywords:
                labels = ev(kw.value)
                if callee is not None and kw.arg in (callee.params or ()):
                    out[callee.params.index(kw.arg)] = labels
                else:
                    out.setdefault(-1, frozenset())
                    out[-1] |= labels
            return out

        def ev_call(node: ast.Call) -> frozenset:
            callee_q = self.call_resolutions.get(
                (mod.rel, node.lineno, node.col_offset)
            )
            callee = self.symbols.get(callee_q) if callee_q else None
            target = self._resolve_expr(mod, node.func, fn.cls, local)
            if self._is_wall_source(target):
                if node.lineno in self.sanctioned_sources.get(mod.rel, ()):
                    self.sanctioned_used.add((mod.rel, node.lineno))
                else:
                    return frozenset({_WALL})
            labels_by_pos = arg_labels(node, callee)
            sink = self._sink_for(
                mod, node, fn.cls, local,
                proto_base=isinstance(node.func, ast.Attribute)
                and is_proto(node.func.value),
            )
            flowing = frozenset()
            for labels in labels_by_pos.values():
                flowing |= labels
            if isinstance(node.func, ast.Attribute) and sink:
                flowing |= ev(node.func.value)
                # a proto object filled field-by-field: any tainted
                # `obj.field` entry counts against `obj.Serialize...()`
                base_d = _dotted(node.func.value)
                if base_d is not None:
                    for k, v in env.items():
                        if k.startswith(base_d + "."):
                            flowing |= v
            if sink is not None:
                if _WALL in flowing:
                    if emit:
                        key = ("taint", mod.rel, node.lineno)
                        if seen is not None and key not in seen:
                            seen.add(key)
                            self.taint_flows.append(TaintFlow(
                                rel=mod.rel, line=node.lineno,
                                message=(
                                    "wall-clock-derived value flows into "
                                    f"consensus bytes ({sink[0]}: "
                                    f"{sink[1]}) — peers recomputing "
                                    "these bytes will disagree; thread "
                                    "an explicit timestamp argument "
                                    "instead"
                                ),
                            ))
                note_param_summary(flowing, fn.param_to_sink)
            if callee is not None:
                # arguments reaching the callee's sink-flowing params
                for pos, labels in labels_by_pos.items():
                    if pos in callee.param_to_sink:
                        if _WALL in labels and emit:
                            key = ("taint", mod.rel, node.lineno)
                            if seen is not None and key not in seen:
                                seen.add(key)
                                self.taint_flows.append(TaintFlow(
                                    rel=mod.rel, line=node.lineno,
                                    message=(
                                        "wall-clock-derived argument "
                                        f"reaches a consensus-bytes sink "
                                        f"inside {callee.qname} (param "
                                        f"{pos}) — peers recomputing "
                                        "these bytes will disagree"
                                    ),
                                ))
                        note_param_summary(labels, fn.param_to_sink)
                out = frozenset()
                if callee.returns_wallclock:
                    out |= frozenset({_WALL})
                for pos in callee.param_to_return:
                    out |= labels_by_pos.get(pos, frozenset())
                return out
            # unresolved call: conservatively propagate every input
            out = flowing
            if isinstance(node.func, ast.Attribute):
                out |= ev(node.func.value)
            return out

        def assign_to(target, labels: frozenset) -> None:
            if isinstance(target, ast.Name):
                prev = env.get(target.id, frozenset())
                if labels - prev:
                    env[target.id] = prev | labels
            elif isinstance(target, ast.Attribute):
                dotted = _dotted(target)
                if dotted is not None:
                    prev = env.get(dotted, frozenset())
                    if labels - prev:
                        env[dotted] = prev | labels
                # filling a field of a LOCAL object taints the object —
                # `hdr.timestamp = ts; return hdr` must carry the taint
                # out.  `self` is the exception: class-level attribute
                # taint tracks the individual attribute instead, so one
                # tainted field doesn't poison every self access.
                base = target.value
                while isinstance(base, (ast.Attribute, ast.Subscript)):
                    base = base.value
                if isinstance(base, ast.Name) and base.id != "self":
                    prev = env.get(base.id, frozenset())
                    if labels - prev:
                        env[base.id] = prev | labels
                if (
                    cls_q is not None
                    and isinstance(target.value, ast.Name)
                    and target.value.id == "self"
                    and _WALL in labels
                ):
                    attrs = self._class_taint.setdefault(cls_q, set())
                    if target.attr not in attrs:
                        attrs.add(target.attr)
                        changed[0] = True
            elif isinstance(target, ast.Subscript):
                assign_to(target.value, labels)
            elif isinstance(target, (ast.Tuple, ast.List)):
                for elt in target.elts:
                    assign_to(elt, labels)

        def walk(stmts) -> None:
            for stmt in stmts:
                if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                     ast.ClassDef)):
                    # nested defs are outside the summary model (rare
                    # on the paths these rules guard)
                    continue
                elif isinstance(stmt, ast.Assign):
                    for t in stmt.targets:
                        note_proto(t, stmt.value)
                    labels = ev(stmt.value)
                    for t in stmt.targets:
                        assign_to(t, labels)
                elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
                    if (
                        isinstance(stmt, ast.AnnAssign)
                        and isinstance(stmt.target, ast.Name)
                        and self._proto_annotation(mod, stmt.annotation)
                    ):
                        proto_vars.add(stmt.target.id)
                    elif stmt.value is not None:
                        note_proto(stmt.target, stmt.value)
                    if stmt.value is not None:
                        assign_to(stmt.target, ev(stmt.value))
                elif isinstance(stmt, ast.Return):
                    if stmt.value is not None:
                        if is_proto(stmt.value) and not fn.returns_proto:
                            fn.returns_proto = True
                            changed[0] = True
                        labels = ev(stmt.value)
                        if _WALL in labels and not fn.returns_wallclock:
                            fn.returns_wallclock = True
                            changed[0] = True
                        note_param_summary(labels, fn.param_to_return)
                elif isinstance(stmt, ast.For):
                    assign_to(stmt.target, ev(stmt.iter))
                    walk(stmt.body)
                    walk(stmt.orelse)
                elif isinstance(stmt, (ast.While, ast.If)):
                    ev(stmt.test)
                    walk(stmt.body)
                    walk(stmt.orelse)
                elif isinstance(stmt, (ast.With, ast.AsyncWith)):
                    for item in stmt.items:
                        labels = ev(item.context_expr)
                        if item.optional_vars is not None:
                            assign_to(item.optional_vars, labels)
                    walk(stmt.body)
                elif isinstance(stmt, ast.Try):
                    walk(stmt.body)
                    for h in stmt.handlers:
                        walk(h.body)
                    walk(stmt.orelse)
                    walk(stmt.finalbody)
                elif isinstance(stmt, ast.Expr):
                    ev(stmt.value)
                elif isinstance(stmt, (ast.Raise, ast.Assert)):
                    for child in ast.iter_child_nodes(stmt):
                        if isinstance(child, ast.expr):
                            ev(child)

        # two body iterations: taint born late in a loop body reaches
        # uses earlier in the (next) iteration; env only grows, so the
        # second sweep is the loop-closure
        walk(fn.node.body)
        walk(fn.node.body)
        return changed[0]

    # -- racecheck: lockset-at-access + guarded-by inference ---------------

    def _role_of_ctx(self, mod: ModuleInfo, ctx, ci: ClassInfo | None,
                     types: dict, local: dict | None = None,
                     rebound=()) -> str | None:
        """Lock role of a with-context expression.  None = not a lock;
        _UNKNOWN_LOCK = lock-shaped but unresolvable (suppresses rather
        than fabricates racecheck findings)."""
        dotted = _dotted(ctx)
        if dotted is None:
            return None
        parts = dotted.split(".")
        attr = parts[-1]
        lockish = (
            "lock" in attr.lower()
            or "cond" in attr.lower()
            or attr in ("_idle",)
        )
        if len(parts) == 1:
            # a bare local bound from a field/param chain (`lock =
            # self._mu; with lock:`): resolve the BINDING's qname to its
            # owner's lock role, so these scopes stop degrading to the
            # UNKNOWN lockset (which both hides dirty accesses and
            # excludes clean ones from majority inference)
            bound = (local or {}).get(attr)
            if bound is not None:
                role = self.module_lock_roles.get(bound)
                if role is None and "." in bound:
                    owner_q, _, leaf = bound.rpartition(".")
                    owner = self.classes.get(owner_q)
                    if owner is not None:
                        role = owner.lock_roles.get(leaf)
                if role is not None:
                    # a REBOUND alias (the name is stored more than
                    # once) resolved a lock role through its LAST
                    # binding — earlier with-blocks may hold a
                    # different lock, so suppress rather than credit
                    # the wrong role
                    return _UNKNOWN_LOCK if attr in rebound else role
            role = self.module_lock_roles.get(f"{mod.dotted}.{attr}")
            if role is not None:
                return role
            return _UNKNOWN_LOCK if lockish else None
        head = parts[0]
        owner: ClassInfo | None = None
        if head == "self" and ci is not None:
            if len(parts) == 2:
                owner = ci
            elif len(parts) == 3:
                ft = ci.field_types.get(parts[1])
                owner = self.classes.get(ft) if ft else None
        elif head in types and len(parts) == 2:
            owner = self.classes.get(types[head])
        if owner is not None:
            role = owner.lock_roles.get(attr)
            if role is not None:
                return role
        if lockish:
            return self._attr_role_unique.get(attr) or _UNKNOWN_LOCK
        return None

    def _spawn_scan(self, mod: ModuleInfo, fn: FunctionInfo, ci,
                    types: dict, local: dict) -> dict:
        """Classify every spawn/Thread/Timer/executor creation in this
        function by what the caller does with the handle — bound to a
        `self` attr, a local, a container append, returned/handed off,
        or discarded — registering each as a spawn SITE for the thread-
        lifecycle rule.  Returns the local-name -> entry-qname map the
        HB walk uses to resolve `t.start()`/`t.join()`.

        All three scans cover OWN statements only (``_own_nodes``): a
        nested def's spawns/joins belong to the closure's own scan — a
        closure-local ``t`` leaking into the parent's map would let an
        unrelated parent variable of the same name fabricate HB
        edges."""
        parent: dict[int, object] = {}
        for node in ast.walk(fn.node):
            for child in ast.iter_child_nodes(node):
                parent[id(child)] = node
        returned: set[str] = set()
        attr_of_local: dict[str, tuple] = {}
        for node in _own_nodes(fn.node):
            if isinstance(node, ast.Return) and isinstance(
                node.value, ast.Name
            ):
                returned.add(node.value.id)
            elif isinstance(node, ast.Assign) and isinstance(
                node.value, ast.Name
            ):
                for t in node.targets:
                    if (
                        isinstance(t, ast.Attribute)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "self"
                        and ci is not None
                    ):
                        attr_of_local[node.value.id] = (ci.qname, t.attr)
        local_spawn: dict[str, str | None] = {}
        for node in _own_nodes(fn.node):
            if not isinstance(node, ast.Call):
                continue
            target = self._resolve_expr(
                mod, node.func, fn.cls, local, types
            )
            api = self._spawn_api(target)
            if api is None:
                continue
            key = (mod.rel, node.lineno, node.col_offset)
            entry = None
            if api != "executor":
                entry = self._spawn_entry(
                    mod, node, fn.cls, local, types, scope=fn.qname
                )
                if entry is not None:
                    # a spawn site inside a loop creates N concurrent
                    # instances of one entry: never thread-confined
                    anc = parent.get(id(node))
                    while anc is not None and anc is not fn.node:
                        if isinstance(
                            anc, (ast.For, ast.AsyncFor, ast.While)
                        ):
                            self._multi_entries.add(entry)
                            break
                        anc = parent.get(id(anc))
            binding: tuple = ("discard",)
            p = parent.get(id(node))
            # unwrap `spawn(...).start()` chains — the binding is
            # decided by what happens to the chain's result
            if isinstance(p, ast.Attribute) and p.attr == "start":
                pc = parent.get(id(p))
                if isinstance(pc, ast.Call):
                    p = parent.get(id(pc))
            if isinstance(p, (ast.List, ast.Tuple)):
                p = parent.get(id(p))
            if isinstance(p, ast.Assign):
                for t in p.targets:
                    if isinstance(t, ast.Name):
                        if binding[0] == "discard":
                            binding = ("local", t.id)
                        if api != "executor":
                            local_spawn[t.id] = entry
                    elif (
                        isinstance(t, ast.Attribute)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "self"
                        and ci is not None
                    ):
                        binding = ("attr", ci.qname, t.attr)
            elif (
                isinstance(p, ast.Call)
                and isinstance(p.func, ast.Attribute)
                and p.func.attr == "append"
            ):
                base = p.func.value
                if (
                    isinstance(base, ast.Attribute)
                    and isinstance(base.value, ast.Name)
                    and base.value.id == "self"
                    and ci is not None
                ):
                    binding = ("attr", ci.qname, base.attr)
                elif isinstance(base, ast.Name):
                    # `threads.append(spawn(...))`: the LOCAL list owns
                    # the handle — a `for t in threads: t.join()` loop
                    # satisfies it via loop_attr
                    binding = ("local", base.id)
                else:
                    # appended into a container someone else owns:
                    # ownership transfers with the reference, like the
                    # generic call-argument case below
                    binding = ("returned",)
            elif isinstance(p, ast.Return):
                binding = ("returned",)
            elif isinstance(p, (ast.Call, ast.keyword)):
                # handed to another callable: ownership transfers with
                # the reference — the receiver owns the stop path
                binding = ("returned",)
            if binding[0] == "local" and binding[1] in returned:
                binding = ("returned",)
            elif binding[0] == "local" and binding[1] in attr_of_local:
                # `t = spawn(...); ...; self._thr = t`: the attr owns it
                binding = ("attr",) + attr_of_local[binding[1]]
            if key in self._spawn_seen:
                continue  # parent already registered this closure site
            self._spawn_seen.add(key)
            self.spawn_sites.append({
                "rel": mod.rel, "line": node.lineno, "fn": fn.qname,
                "entry": entry, "api": api,
                "kind": self._spawn_kind(target, node),
                # seam spawns register with threadwatch; raw
                # threading.Thread/Timer objects are invisible to
                # drain_threads, so the drain join edge must not
                # cover them
                "seam": target not in (
                    "threading.Thread", "threading.Timer"
                ),
                "binding": binding,
            })
        return local_spawn

    def _lockset_pass_all(self) -> None:
        for mod in self.modules.values():
            for fn in mod.functions:
                # __init__ still registers spawn targets and call
                # edges, but its accesses are pre-publication: the
                # object is not shared yet, so they neither need
                # guards nor vote in majority inference
                self._lockset_pass(
                    mod, fn, record_accesses=fn.name != "__init__"
                )

    def _lockset_pass(self, mod: ModuleInfo, fn: FunctionInfo,
                      record_accesses: bool = True) -> None:
        ci = self.classes.get(f"{mod.dotted}.{fn.cls}") if fn.cls else None
        types = getattr(fn, "_types", {})
        local = getattr(fn, "_local_bindings", {})
        local_spawn = self._spawn_scan(mod, fn, ci, types, local)
        # local events/queues are shared with closures: a closure's
        # lookup walks the ENCLOSING scopes' maps (parents are
        # processed first — mod.functions is registration order), but
        # each function REGISTERS into its own map with a token keyed
        # by its own qname, so same-named locals in sibling closures
        # stay distinct objects instead of unifying into one token
        lsync = self._fn_local_sync.setdefault(fn.qname, {})

        def _lookup_local_sync(name):
            scope = fn.qname
            while True:
                ent = self._fn_local_sync.get(scope, {}).get(name)
                if ent is not None:
                    return ent
                if ".<locals>." not in scope:
                    return None
                scope = scope.rsplit(".<locals>.", 1)[0]
        # loop var -> (owner qname, attr) when iterating a self/typed
        # container field (`for t in self._threads: t.join()`)
        loop_attr: dict[str, tuple] = {}
        held: list[str] = []
        seen_access: set = set()
        # v5 flowcheck: the function's CFG plus a forward must-hold
        # dataflow over explicit .acquire()/.release() calls — `with`
        # scoping stays lexical (its push/pop IS the meet-over-paths
        # answer), while conditional acquires, early-return releases
        # and try/finally pairs resolve per program point
        cfg = _CFG.build(fn.node)
        fn.cfg = cfg
        flow_ops: list = []
        for fnode in _own_nodes(fn.node):
            if (
                isinstance(fnode, ast.Call)
                and isinstance(fnode.func, ast.Attribute)
                and fnode.func.attr in ("acquire", "release")
            ):
                role = self._role_of_ctx(
                    mod, fnode.func.value, ci, types, local,
                    getattr(fn, "_rebound", ()),
                )
                if role is not None:
                    op = "acq" if fnode.func.attr == "acquire" else "rel"
                    flow_ops.append((fnode.lineno, op, role))
                    if role != _UNKNOWN_LOCK:
                        fn.flow_lock_roles.add(role)
        flow_ops.sort()
        flow_at = _flow_locksets(cfg, flow_ops)

        def fs_held(line: int) -> frozenset:
            extra = flow_at(line)
            return frozenset(held) | extra if extra else frozenset(held)

        def sync_token(expr):
            """(kind, token) for an event/queue-valued expression, or
            None when it is not a known synchronization object."""
            if isinstance(expr, ast.Attribute) and isinstance(
                expr.value, ast.Name
            ):
                base = expr.value.id
                owner = None
                if base == "self" and ci is not None:
                    owner = ci
                elif base in types:
                    owner = self.classes.get(types[base])
                if owner is not None:
                    k = owner.sync_types.get(expr.attr)
                    if k is not None:
                        return k, f"{owner.qname}.{expr.attr}"
            elif isinstance(expr, ast.Name):
                ent = _lookup_local_sync(expr.id)
                if ent is not None:
                    return ent
            return None

        _NOSPAWN = ("<nospawn>",)

        def spawn_subject(expr):
            """The entry qname behind a `<subject>.start()/join()` —
            None when the subject IS a spawned thread whose entry did
            not resolve, _NOSPAWN when it is not a thread at all."""
            if isinstance(expr, ast.Call):
                t_ = self._resolve_expr(mod, expr.func, fn.cls, local,
                                        types)
                if self._spawn_api(t_) in ("thread", "timer"):
                    return self._spawn_entry(
                        mod, expr, fn.cls, local, types, scope=fn.qname
                    )
                return _NOSPAWN
            if isinstance(expr, ast.Name):
                if expr.id in local_spawn:
                    return local_spawn[expr.id]
                return _NOSPAWN
            if isinstance(expr, ast.Attribute) and isinstance(
                expr.value, ast.Name
            ):
                owner = None
                if expr.value.id == "self" and ci is not None:
                    owner = ci
                elif expr.value.id in types:
                    owner = self.classes.get(types[expr.value.id])
                if owner is not None and expr.attr in owner.spawn_attrs:
                    return owner.spawn_attrs[expr.attr]
            return _NOSPAWN

        def record_stop_path(base, into: set) -> None:
            """A join/cancel/shutdown observed on `base`: remember the
            (owner, attr) — and the conservative by-name fallback — so
            the lifecycle rule accepts the binding as managed."""
            if isinstance(base, ast.Attribute) and isinstance(
                base.value, ast.Name
            ):
                owner = None
                if base.value.id == "self" and ci is not None:
                    owner = ci.qname
                elif base.value.id in types:
                    owner = types[base.value.id]
                into.add((owner, base.attr))
                into.add((None, base.attr))
            elif isinstance(base, ast.Name):
                la = loop_attr.get(base.id)
                if la is not None:
                    into.add(la)
                    into.add((None, la[1]))
                # a bare name: local (same-function) management, or the
                # `global _pool` singleton pattern
                into.add((None, base.id))

        def note_field(owner: ClassInfo | None, attr: str, kind: str,
                       line: int) -> None:
            if owner is None or attr in owner.lock_roles:
                return
            if attr not in owner.fields:
                return  # inherited/foreign attr: out of model
            q = f"{owner.qname}.{attr}"
            if q in self.symbols:
                return  # a method, not state
            key = (q, kind, line)
            if key in seen_access:
                return
            seen_access.add(key)
            fn.accesses.append((q, kind, line, fs_held(line)))

        def note_attr(node: ast.Attribute, kind: str) -> None:
            base = node.value
            if isinstance(base, ast.Name):
                if base.id == "self":
                    note_field(ci, node.attr, kind, node.lineno)
                elif base.id in types:
                    note_field(
                        self.classes.get(types[base.id]), node.attr,
                        kind, node.lineno,
                    )
            elif (
                isinstance(base, ast.Attribute)
                and isinstance(base.value, ast.Name)
                and base.value.id == "self"
                and ci is not None
            ):
                ft = ci.field_types.get(base.attr)
                if ft is not None:
                    note_field(
                        self.classes.get(ft), node.attr, kind, node.lineno
                    )

        def note_global(node: ast.Name, kind: str) -> None:
            q = f"{mod.dotted}.{node.id}"
            if q not in self.declared_guards:
                return
            key = (q, kind, node.lineno)
            if key in seen_access:
                return
            seen_access.add(key)
            fn.accesses.append((q, kind, node.lineno, fs_held(node.lineno)))

        def entry(reason: str, expr) -> str | None:
            # a bare name may be a locally-defined function (the
            # committer's commit_loop): its symbol lives under this
            # function's `<locals>` scope — or an enclosing one when a
            # closure spawns a sibling closure
            q = None
            if isinstance(expr, ast.Name):
                q = self._scoped_symbol(fn.qname, expr.id)
            if q is None:
                q = self._resolve_expr(mod, expr, fn.cls, local, types)
                if q is not None and q not in self.symbols:
                    q = None
            if q is None:
                return None
            self.thread_entries.setdefault(q, reason)
            # entries that run as MANY concurrent instances of one
            # qname (pool chunks, executor jobs, RPC/gossip handlers)
            # must never count as "the same thread" in the HB order
            # check — two sibling chunks share a domain but race
            if (
                reason in ("pool chunk", "executor submission")
                or reason.endswith("() handler")
            ):
                self._multi_entries.add(q)
            return q

        def handle_call(node: ast.Call) -> None:
            q = self.call_resolutions.get(
                (mod.rel, node.lineno, node.col_offset)
            )
            if q is not None:
                fn.call_locks.append((q, fs_held(node.lineno)))
            target = self._resolve_expr(mod, node.func, fn.cls, local, types)
            if target in _SPAWN_THREAD_FNS:
                for kw in node.keywords:
                    if kw.arg == "target":
                        entry("thread target", kw.value)
                # lockwatch.spawn_thread(target, ...) takes the target
                # as its first positional (threading.Thread's is
                # `group` — keyword-only there in practice)
                if target != "threading.Thread" and node.args:
                    entry("thread target", node.args[0])
            elif target in _SPAWN_TIMER_FNS:
                for kw in node.keywords:
                    if kw.arg == "function":
                        entry("timer callback", kw.value)
                if len(node.args) >= 2:
                    entry("timer callback", node.args[1])
            elif target in _RUN_CHUNKED_FNS and node.args:
                # run_chunked is a synchronous fan-out: the chunk fn is
                # a thread entry, and the call line is both the start
                # edge (prior writes published to workers) and the join
                # edge (worker writes published back on return)
                eq = entry("pool chunk", node.args[0])
                if eq is not None:
                    fn.hb_starts.append((eq, node.lineno))
                    fn.hb_joins.append((eq, node.lineno))
            elif target in _DRAIN_FNS:
                fn.hb_joins.append(("*", node.lineno))
            elif isinstance(node.func, ast.Attribute):
                if node.func.attr in _SUBMIT_ATTRS and node.args:
                    entry("executor submission", node.args[0])
                elif node.func.attr in _HANDLER_REG_ATTRS:
                    for arg in node.args:
                        if isinstance(arg, (ast.Attribute, ast.Name)):
                            entry(f".{node.func.attr}() handler", arg)
            if target == _CLOCKSKEW_WAIT and node.args:
                st = sync_token(node.args[0])
                if st is not None and st[0] == "event":
                    fn.hb_acq.append(
                        (st[1], node.lineno, fs_held(node.lineno))
                    )
                fn.stop_probe = True
            f_ = node.func
            if not isinstance(f_, ast.Attribute):
                return
            a_ = f_.attr
            if a_ == "acquire":
                # an explicit acquire joins the static acquisition-order
                # graph exactly like a `with` scope: every role already
                # held (lexically or flow-proven) orders before it
                role = self._role_of_ctx(
                    mod, f_.value, ci, types, local,
                    getattr(fn, "_rebound", ()),
                )
                if role is not None and role != _UNKNOWN_LOCK:
                    already = (set(held) | flow_at(node.lineno)) - {role}
                    for h in sorted(already):
                        if h != _UNKNOWN_LOCK:
                            self.lock_order_edges.setdefault(
                                (h, role), []
                            ).append((mod.rel, node.lineno))
                    fn.lock_acquires.append((
                        role,
                        frozenset(
                            h for h in already if h != _UNKNOWN_LOCK
                        ),
                        node.lineno,
                    ))
            if a_ == "start":
                se = spawn_subject(f_.value)
                if se != _NOSPAWN:
                    fn.hb_starts.append((se, node.lineno))
            elif a_ in ("join", "cancel"):
                se = spawn_subject(f_.value)
                if se is not None and se != _NOSPAWN:
                    # an UNRESOLVED spawned subject (se is None)
                    # contributes no HB edge: joining one unknown
                    # thread proves nothing about any particular entry
                    fn.hb_joins.append((se, node.lineno))
                record_stop_path(f_.value, self._attr_joins)
            elif a_ == "shutdown":
                record_stop_path(f_.value, self._attr_shutdowns)
            elif a_ in (
                "set", "clear", "wait", "is_set",
                "put", "put_nowait", "get", "get_nowait",
            ):
                st = sync_token(f_.value)
                if st is not None:
                    k_, tok = st
                    entry_rec = (tok, node.lineno, fs_held(node.lineno))
                    if k_ == "event":
                        if a_ == "set":
                            fn.hb_rel.append(entry_rec)
                        elif a_ == "clear":
                            fn.hb_clears.append(entry_rec)
                        elif a_ == "wait":
                            fn.hb_acq.append(entry_rec)
                            fn.stop_probe = True
                        else:  # is_set
                            fn.stop_probe = True
                    else:  # queue
                        if a_ in ("put", "put_nowait"):
                            fn.hb_rel.append(entry_rec)
                        elif a_ in ("get", "get_nowait"):
                            fn.hb_acq.append(entry_rec)
                            fn.stop_probe = True
                elif a_ in ("wait", "is_set"):
                    # a wait/is_set on something we cannot type is
                    # still a stop-signal probe for the lifecycle rule
                    # (loose on purpose: false negatives only)
                    fn.stop_probe = True

        def scan_expr(expr) -> None:
            if expr is None:
                return
            for node in ast.walk(expr):
                if isinstance(node, ast.Call):
                    handle_call(node)
                elif isinstance(node, ast.Attribute) and isinstance(
                    node.ctx, ast.Load
                ):
                    if record_accesses:
                        note_attr(node, "read")
                elif isinstance(node, ast.Name) and isinstance(
                    node.ctx, ast.Load
                ):
                    if record_accesses:
                        note_global(node, "read")

        def note_target(t) -> None:
            if isinstance(t, ast.Attribute):
                if record_accesses:
                    note_attr(t, "write")
                scan_expr(t.value)
            elif isinstance(t, ast.Subscript):
                v = t.value
                if isinstance(v, ast.Attribute):
                    # mutating a container field IS writing the field
                    if record_accesses:
                        note_attr(v, "write")
                    scan_expr(v.value)
                elif isinstance(v, ast.Name):
                    if record_accesses:
                        note_global(v, "write")
                else:
                    scan_expr(v)
                scan_expr(t.slice)
            elif isinstance(t, (ast.Tuple, ast.List)):
                for e in t.elts:
                    note_target(e)
            elif isinstance(t, ast.Starred):
                note_target(t.value)
            elif isinstance(t, ast.Name):
                if record_accesses:
                    note_global(t, "write")

        def walk(stmts) -> None:
            for stmt in stmts:
                if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                     ast.ClassDef)):
                    continue
                if isinstance(stmt, (ast.With, ast.AsyncWith)):
                    pushed = 0
                    for item in stmt.items:
                        scan_expr(item.context_expr)
                        if item.optional_vars is not None:
                            note_target(item.optional_vars)
                        role = self._role_of_ctx(
                            mod, item.context_expr, ci, types, local,
                            getattr(fn, "_rebound", ()),
                        )
                        if role is not None:
                            # the static acquisition-order graph: every
                            # role already held orders before the one
                            # being acquired (UNKNOWN contributes no
                            # edges — it has no runtime counterpart)
                            if role != _UNKNOWN_LOCK:
                                already = (
                                    set(held) | flow_at(stmt.lineno)
                                )
                                for h in sorted(already):
                                    if h != role and h != _UNKNOWN_LOCK:
                                        self.lock_order_edges.setdefault(
                                            (h, role), []
                                        ).append((mod.rel, stmt.lineno))
                                fn.lock_acquires.append((
                                    role,
                                    frozenset(
                                        h for h in already
                                        if h != _UNKNOWN_LOCK
                                        and h != role
                                    ),
                                    stmt.lineno,
                                ))
                            held.append(role)
                            pushed += 1
                    walk(stmt.body)
                    for _ in range(pushed):
                        held.pop()
                elif isinstance(stmt, ast.Assign):
                    if isinstance(stmt.value, ast.Call):
                        # local Event/Queue ctors register as sync
                        # objects shared with this function's closures
                        t_ = self._resolve_expr(
                            mod, stmt.value.func, fn.cls, local, types
                        )
                        k_ = (
                            "event" if t_ in _EVENT_CTOR_FNS
                            else "queue" if t_ in _QUEUE_CTOR_FNS
                            else None
                        )
                        if k_ is not None:
                            for t in stmt.targets:
                                if isinstance(t, ast.Name):
                                    lsync[t.id] = (
                                        k_, f"{fn.qname}::{t.id}"
                                    )
                    elif isinstance(stmt.value, ast.Name) and (
                        stmt.value.id in local_spawn
                    ):
                        # `self._thr = t` after `t = spawn_thread(...)`:
                        # the attr inherits the spawn binding
                        for t in stmt.targets:
                            if (
                                isinstance(t, ast.Attribute)
                                and isinstance(t.value, ast.Name)
                                and t.value.id == "self"
                                and ci is not None
                            ):
                                ci.spawn_attrs.setdefault(
                                    t.attr, local_spawn[stmt.value.id]
                                )
                    scan_expr(stmt.value)
                    for t in stmt.targets:
                        note_target(t)
                elif isinstance(stmt, ast.AugAssign):
                    scan_expr(stmt.value)
                    note_target(stmt.target)
                elif isinstance(stmt, ast.AnnAssign):
                    scan_expr(stmt.value)
                    note_target(stmt.target)
                elif isinstance(stmt, (ast.For, ast.AsyncFor)):
                    it = stmt.iter
                    if (
                        isinstance(it, ast.Call)
                        and isinstance(it.func, ast.Name)
                        and it.func.id in ("list", "tuple")
                        and len(it.args) == 1
                    ):
                        it = it.args[0]
                    if (
                        isinstance(stmt.target, ast.Name)
                        and isinstance(it, ast.Attribute)
                        and isinstance(it.value, ast.Name)
                    ):
                        owner = None
                        if it.value.id == "self" and ci is not None:
                            owner = ci.qname
                        elif it.value.id in types:
                            owner = types[it.value.id]
                        if owner is not None:
                            loop_attr[stmt.target.id] = (owner, it.attr)
                    elif isinstance(stmt.target, ast.Name) and isinstance(
                        it, ast.Name
                    ):
                        # `for t in threads:` over a LOCAL container —
                        # joins on the loop var satisfy a ('local',
                        # 'threads') spawn binding
                        loop_attr[stmt.target.id] = (None, it.id)
                    scan_expr(stmt.iter)
                    note_target(stmt.target)
                    walk(stmt.body)
                    walk(stmt.orelse)
                elif isinstance(stmt, (ast.While, ast.If)):
                    scan_expr(stmt.test)
                    walk(stmt.body)
                    walk(stmt.orelse)
                elif isinstance(stmt, ast.Try):
                    walk(stmt.body)
                    for h in stmt.handlers:
                        walk(h.body)
                    walk(stmt.orelse)
                    walk(stmt.finalbody)
                else:
                    for child in ast.iter_child_nodes(stmt):
                        if isinstance(child, ast.expr):
                            scan_expr(child)

        walk(fn.node.body)

    def _interproc_lock_edges(self) -> None:
        """Extend the static acquisition-order graph across call
        boundaries: a MAY-held set (union over every incoming call
        path — the graph must be a superset of anything runtime
        lockwatch can observe, or the runtime-⊆-static contract breaks)
        flows down the call graph, and every recorded acquisition
        orders each may-held role before itself.  Relaxed-profile
        callers (tests, scripts, the card script) do not contribute: a
        fixture lock held around a production call must not become a
        tree-wide ordering edge."""
        may: dict[str, frozenset] = {q: frozenset() for q in self.symbols}
        for _ in range(_MAX_ROUNDS * 4):
            changed = False
            for q, fn in self.symbols.items():
                if fn.rel.startswith(RELAXED_PREFIXES):
                    continue
                for callee, heldset in fn.call_locks:
                    if callee not in may:
                        continue
                    add = (may[q] | heldset) - {_UNKNOWN_LOCK}
                    if not add <= may[callee]:
                        may[callee] = may[callee] | add
                        changed = True
            if not changed:
                break
        for q, fn in self.symbols.items():
            amb = may.get(q)
            if not amb:
                continue
            for role, _heldb4, line in fn.lock_acquires:
                for h in amb:
                    if h != role:
                        self.lock_order_edges.setdefault(
                            (h, role), []
                        ).append((fn.rel, line))
        for k in list(self.lock_order_edges):
            self.lock_order_edges[k] = sorted(
                set(self.lock_order_edges[k])
            )

    def _racecheck(self) -> None:
        # incoming call edges annotated with the caller's held lockset
        incoming: dict[str, list] = {q: [] for q in self.symbols}
        for fn in self.symbols.values():
            for callee, heldset in fn.call_locks:
                if callee in incoming:
                    incoming[callee].append((fn.qname, heldset))
        # ambient locks: the meet (intersection) over every incoming
        # call path; roots (no resolvable callers) hold nothing.  Used
        # by guard INFERENCE so helper bodies reached only under a lock
        # count as locked sites.
        ambient: dict[str, frozenset | None] = {
            q: (frozenset() if not incoming[q] else None)
            for q in self.symbols
        }
        for _ in range(_MAX_ROUNDS * 4):
            changed = False
            for q, fn in self.symbols.items():
                amb = ambient[q]
                if amb is None:
                    continue
                for callee, heldset in fn.call_locks:
                    if callee not in ambient:
                        continue
                    cand = amb | heldset
                    cur = ambient[callee]
                    new = cand if cur is None else cur & cand
                    if new != cur:
                        ambient[callee] = new
                        changed = True
            if not changed:
                break
        # thread context: the lockset guaranteed on EVERY path from a
        # thread entry point (meet again); functions absent from tctx
        # are not thread-reachable and are never flagged
        tctx: dict[str, frozenset] = {}
        origin: dict[str, str] = {}
        for q, reason in self.thread_entries.items():
            tctx[q] = frozenset()
            origin[q] = f"{q} ({reason})"
        for _ in range(_MAX_ROUNDS * 4):
            changed = False
            for q, fn in list(self.symbols.items()):
                if q not in tctx:
                    continue
                for callee, heldset in fn.call_locks:
                    if callee not in self.symbols:
                        continue
                    cand = tctx[q] | heldset
                    cur = tctx.get(callee)
                    new = cand if cur is None else cur & cand
                    if new != cur:
                        tctx[callee] = new
                        origin.setdefault(callee, origin[q])
                        changed = True
            if not changed:
                break
        # entry SETS (union, unlike the tctx meet): which thread
        # entries can reach each function — the happens-before pass
        # reasons about WHO runs an access, not just whether someone
        # does
        entry_sets: dict[str, frozenset] = {
            q: frozenset({q}) for q in self.thread_entries
        }
        for _ in range(_MAX_ROUNDS * 4):
            changed = False
            for q, fn in list(self.symbols.items()):
                es = entry_sets.get(q)
                if es is None:
                    continue
                for callee, _h in fn.call_locks:
                    if callee not in self.symbols:
                        continue
                    cur = entry_sets.get(callee, frozenset())
                    if not es <= cur:
                        entry_sets[callee] = cur | es
                        changed = True
            if not changed:
                break
        self._entry_sets = entry_sets

        # -- happens-before machinery (v4) ---------------------------------

        def _site_tokens(fn: FunctionInfo, line: int):
            """(acquire, release) HB tokens ordered around `line` in
            `fn`: joins/waits/gets sequenced BEFORE it (on every path
            reaching it) order earlier work in, starts/sets/puts the
            access strictly precedes (on EVERY path — a loop back edge
            that could replay the event first defeats the claim, v5)
            order this work out."""
            acq = set()
            rel = set()
            cfg = fn.cfg if isinstance(fn.cfg, _CFG) else None

            def before(l):  # event at l precedes the access
                return (cfg.event_precedes(l, line) if cfg is not None
                        else l < line)

            def after(l):  # the access strictly precedes the event at l
                return (cfg.access_precedes(line, l) if cfg is not None
                        else line < l)

            for e, l in fn.hb_joins:
                if before(l):
                    acq.add(("join", e))
            for tok, l, _h in fn.hb_acq:
                if before(l):
                    acq.add(("sync", tok))
            for e, l in fn.hb_starts:
                if e is not None and after(l):
                    rel.add(("start", e))
            for tok, l, _h in fn.hb_rel:
                if after(l):
                    rel.add(("sync", tok))
            return acq, rel

        multi = self._multi_entries
        # the drain_threads wildcard join only covers entries that
        # register with threadwatch as kind="worker" at EVERY spawn
        # site — drain_threads(kinds=("worker",)) joins exactly those;
        # services keep running and raw Thread/Timer objects are
        # invisible to the registry
        entry_spawns: dict[str, list] = {}
        for s in self.spawn_sites:
            if s["entry"] is not None:
                entry_spawns.setdefault(s["entry"], []).append(s)
        drained = {
            e for e, ss in entry_spawns.items()
            if all(s["seam"] and s["kind"] == "worker" for s in ss)
        }

        def _same_thread(da, db) -> bool:
            """Both main, or the same SINGLE-instance entry — an entry
            that runs as many concurrent threads (pool chunks, executor
            jobs, handlers, loop-spawned workers) shares a domain
            across racing instances and proves nothing."""
            return da == db and len(da) <= 1 and not (da & multi)

        def _joined(e, acq) -> bool:
            return ("join", e) in acq or (
                ("join", "*") in acq and e in drained
            )

        def _ordered(a, b) -> bool:
            """True when the two (domain, acq, rel) access profiles are
            sequenced by a happens-before edge: same single thread,
            thread start (a precedes every entry b runs under),
            join/drain (every entry b runs under completed before a),
            or a matching Event set→wait / Queue put→get publication
            pair."""
            da, acqa, rela = a
            db, acqb, relb = b
            if _same_thread(da, db):
                return True
            if db and all(("start", e) in rela for e in db):
                return True
            if da and all(("start", e) in relb for e in da):
                return True
            if db and all(_joined(e, acqa) for e in db):
                return True
            if da and all(_joined(e, acqb) for e in da):
                return True
            if {t for k, t in rela if k == "sync"} & {
                t for k, t in acqb if k == "sync"
            }:
                return True
            if {t for k, t in relb if k == "sync"} & {
                t for k, t in acqa if k == "sync"
            }:
                return True
            return False

        # guarded-by map: reviewed declarations first, majority next —
        # both rebuilt UNDER happens-before: ordered accesses neither
        # need a guard nor vote in the inference
        sites: dict[str, list] = {}
        for fn in self.symbols.values():
            amb = ambient.get(fn.qname) or frozenset()
            for field, kind, line, heldset in fn.accesses:
                sites.setdefault(field, []).append(
                    (fn, kind, line, amb | heldset)
                )
        field_profs: dict[str, list] = {}
        for field, ss in sites.items():
            profs = []
            for fn, kind, line, ls in ss:
                acq, rel = _site_tokens(fn, line)
                profs.append({
                    "fn": fn, "kind": kind, "line": line, "ls": ls,
                    "dom": entry_sets.get(fn.qname, frozenset()),
                    "acq": acq, "rel": rel, "safe": False,
                })
            # pairwise pruning: an access ordered against every
            # counterpart write (and, for a write, every counterpart
            # access) cannot race.  `checked` guards the vacuous case —
            # an access with NO counterpart pair (a lone write, a read
            # with no writes) is not "proven" anything and must not
            # override a declared guard
            for i, a in enumerate(profs):
                ok = True
                checked = False
                for j, b in enumerate(profs):
                    if i == j:
                        continue
                    if a["kind"] != "write" and b["kind"] != "write":
                        continue
                    checked = True
                    if not _ordered(
                        (a["dom"], a["acq"], a["rel"]),
                        (b["dom"], b["acq"], b["rel"]),
                    ):
                        ok = False
                        break
                if ok and checked:
                    a["safe"] = True
                    self.hb_safe_sites.add(
                        (field, a["kind"], a["line"], a["fn"].qname)
                    )
            field_profs[field] = profs
        self.guard_map = {}
        for field, profs in sorted(field_profs.items()):
            n_sites = len(profs)
            n_safe = sum(1 for p in profs if p["safe"])
            has_write = any(p["kind"] == "write" for p in profs)
            declared = self.declared_guards.get(field)
            if declared is not None:
                held_n = sum(1 for p in profs if declared in p["ls"])
                g = {
                    "guard": declared, "source": "declared",
                    "sites": n_sites, "held": held_n,
                }
                if n_safe:
                    g["hb_safe"] = n_safe
                threaded = any(p["dom"] for p in profs)
                if (
                    threaded
                    and n_safe == n_sites
                    and has_write
                    and held_n < n_sites
                ):
                    # every access is HB-ordered yet the declaration
                    # still demands a lock somewhere it is not held:
                    # racecheck can never fire for this field again, so
                    # the guards.py entry is dead weight to remove.
                    # `threaded` gates the call: when NO access is
                    # thread-entry-reachable the pairwise proof is
                    # vacuous (the analyzer simply cannot see the
                    # threads, e.g. a commit path reached through
                    # unresolvable indirection) and the declaration
                    # stays as the reviewed contract
                    g["stale"] = True
                    first = min(
                        profs, key=lambda p: (p["fn"].rel, p["line"])
                    )
                    self.stale_guard_flows.append(TaintFlow(
                        rel=first["fn"].rel, line=first["line"],
                        message=(
                            f"declared guard {declared!r} on {field} "
                            "is stale: every access is ordered by "
                            "happens-before edges (spawn/join/Event/"
                            "Queue publication) — remove the guards.py "
                            "declaration"
                        ),
                    ))
                self.guard_map[field] = g
                continue
            if not has_write:
                continue  # never mutated post-init: cannot race
            if n_safe == n_sites:
                # fully publication-ordered: no guard needed — named in
                # the artifact so reviewers see why no inference ran
                self.guard_map[field] = {
                    "guard": None, "source": "hb-publish",
                    "sites": n_sites, "held": 0, "hb_safe": n_safe,
                }
                continue
            # HB-safe sites are exempt from EMISSION but still vote in
            # the inference: a lock-free-but-published reader must not
            # dissolve the majority its locked siblings establish
            counted = [
                p["ls"] for p in profs if _UNKNOWN_LOCK not in p["ls"]
            ]
            if len(counted) < 2:
                continue
            tally: dict[str, int] = {}
            for ls in counted:
                for role in ls:
                    tally[role] = tally.get(role, 0) + 1
            for role, n in sorted(
                tally.items(), key=lambda kv: (-kv[1], kv[0])
            ):
                if n >= 2 and n * 2 > len(counted):
                    g = {
                        "guard": role, "source": "inferred",
                        "sites": len(counted), "held": n,
                    }
                    if n_safe:
                        g["hb_safe"] = n_safe
                    self.guard_map[field] = g
                break  # only the top role can hold a majority
        # declared guards with no observed sites still surface in the
        # artifact so a stale declaration is visible to reviewers
        for field, role in sorted(self.declared_guards.items()):
            self.guard_map.setdefault(field, {
                "guard": role, "source": "declared", "sites": 0, "held": 0,
            })
        # emission: thread-reachable accesses whose lockset misses the
        # field's guard — unless a happens-before edge from every
        # writer already orders the access
        seen: set = set()
        for fn in self.symbols.values():
            T = tctx.get(fn.qname)
            if T is None:
                continue
            for field, kind, line, heldset in fn.accesses:
                g = self.guard_map.get(field)
                if g is None or not g["sites"] or g.get("guard") is None:
                    continue
                if (field, kind, line, fn.qname) in self.hb_safe_sites:
                    continue
                eff = T | heldset
                if g["guard"] in eff or _UNKNOWN_LOCK in eff:
                    continue
                key = (fn.rel, line)
                if key in seen:
                    continue
                seen.add(key)
                self.race_flows.append(TaintFlow(
                    rel=fn.rel, line=line,
                    message=(
                        f"{kind} of {field} misses its guard lock "
                        f"{g['guard']!r} ({g['source']}, held at "
                        f"{g['held']}/{g['sites']} sites) on a thread "
                        f"path from {origin.get(fn.qname, fn.qname)} — "
                        "hold the guard across this access, move the "
                        "field behind it, or pragma a reviewed benign "
                        "race"
                    ),
                ))
        # post-publication writes (v4): a write AFTER this function
        # started a thread that accesses the same field races with it
        # unless a lock or a later publication edge covers the pair —
        # the spawner is concurrent with its target from start() on,
        # whether or not the spawner is itself thread-reachable
        for field, profs in sorted(field_profs.items()):
            for a in profs:
                if a["kind"] != "write" or a["safe"]:
                    continue
                if _UNKNOWN_LOCK in a["ls"]:
                    continue
                a_cfg = a["fn"].cfg if isinstance(a["fn"].cfg, _CFG) else None
                starts = {
                    e for e, l in a["fn"].hb_starts
                    if e is not None and (
                        a_cfg.may_follow(l, a["line"])
                        if a_cfg is not None else l < a["line"]
                    )
                }
                if not starts:
                    continue
                for b in profs:
                    if b is a:
                        continue
                    common = b["dom"] & starts
                    if not common or _UNKNOWN_LOCK in b["ls"]:
                        continue
                    if a["ls"] & b["ls"]:
                        continue  # mutual exclusion covers the pair
                    if _ordered(
                        (a["dom"], a["acq"], a["rel"]),
                        (b["dom"], b["acq"], b["rel"]),
                    ):
                        continue
                    key = (a["fn"].rel, a["line"])
                    if key in seen:
                        break
                    seen.add(key)
                    e = sorted(common)[0]
                    self.race_flows.append(TaintFlow(
                        rel=a["fn"].rel, line=a["line"],
                        message=(
                            f"write of {field} races past its "
                            f"publication point: {e} was started "
                            "earlier in this function and "
                            f"{b['kind']}s the field at "
                            f"{b['fn'].rel}:{b['line']} — move the "
                            "write before start(), hold a common lock "
                            "on both sides, or publish it through an "
                            "Event/Queue edge"
                        ),
                    ))
                    break
        # shared-Event re-arm (v4): clear() re-arms a waiter contract;
        # doing it concurrently with another thread's set()/clear()
        # loses wakeups (the deliver-client wedge class) — flag unless
        # a common lock or an HB edge sequences the pair
        clear_map: dict[str, list] = {}
        rel_map: dict[str, list] = {}
        for fn in self.symbols.values():
            dom = entry_sets.get(fn.qname, frozenset())
            for tok, line, heldset in fn.hb_clears:
                clear_map.setdefault(tok, []).append(
                    (fn, line, heldset, dom)
                )
            for tok, line, heldset in fn.hb_rel:
                rel_map.setdefault(tok, []).append(
                    (fn, line, heldset, dom)
                )
        for tok, clears in sorted(clear_map.items()):
            counters = rel_map.get(tok, []) + clears
            for cfn, cline, cheld, cdom in clears:
                for sfn, sline, sheld, sdom in counters:
                    if (sfn.qname, sline) == (cfn.qname, cline):
                        continue
                    if _same_thread(cdom, sdom):
                        continue
                    if cheld & sheld:
                        continue
                    if _UNKNOWN_LOCK in cheld or _UNKNOWN_LOCK in sheld:
                        continue
                    ca, cr = _site_tokens(cfn, cline)
                    sa, sr = _site_tokens(sfn, sline)
                    if _ordered((cdom, ca, cr), (sdom, sa, sr)):
                        continue
                    key = (cfn.rel, cline)
                    if key in seen:
                        break
                    seen.add(key)
                    self.race_flows.append(TaintFlow(
                        rel=cfn.rel, line=cline,
                        message=(
                            f"re-arming shared Event {tok} (clear) "
                            "races with its set()/clear() at "
                            f"{sfn.rel}:{sline} on a different thread "
                            "— a waiter can miss the set entirely; "
                            "use a fresh per-generation Event instead "
                            "of re-arming, or hold one lock around "
                            "both sides"
                        ),
                    ))
                    break
        self.race_flows.sort(key=lambda f: (f.rel, f.line))

    def _lifecycle(self) -> None:
        """Thread-lifecycle reachability (v4): every spawn_thread/
        spawn_timer/Thread/Timer/executor registration needs a
        statically findable stop path — a join()/cancel()/shutdown()
        on whatever holds the handle, a stop-signal loop in the
        spawned entry (Event wait/is_set, queue get, clockskew.wait),
        or a provably bounded worker body.  A handle that is returned
        or passed onward transfers ownership with the reference."""
        # stop-probe reachability as a call-graph FIXPOINT (a DFS with
        # a memoized-False cycle guard poisons members of a cycle that
        # only reach their probe through the in-progress node)
        can_stop = {
            q for q, fn in self.symbols.items() if fn.stop_probe
        }
        changed = True
        while changed:
            changed = False
            for q, fn in self.symbols.items():
                if q not in can_stop and any(
                    c in can_stop for c in fn.calls
                ):
                    can_stop.add(q)
                    changed = True

        def probe(q: str) -> bool:
            return q in can_stop

        for site in self.spawn_sites:
            api = site["api"]
            binding = site["binding"]
            entry = site["entry"]
            stops = (
                self._attr_shutdowns if api == "executor"
                else self._attr_joins
            )
            ok = False
            if binding[0] == "returned":
                ok = True
            elif binding[0] == "attr":
                ok = (
                    (binding[1], binding[2]) in stops
                    or (None, binding[2]) in stops
                )
            elif binding[0] == "local":
                ok = (None, binding[1]) in stops
            if not ok and api != "executor" and entry is not None:
                ok = probe(entry)
                if not ok and site["kind"] == "worker":
                    # a worker whose body provably terminates (no
                    # unbounded loop) drains on its own; the session
                    # threadwatch gate covers the long tail
                    efn = self.symbols.get(entry)
                    ok = efn is not None and not efn.has_while
            if ok:
                continue
            what = (
                f"its entry {entry} never blocks on a stop signal "
                "(Event wait/is_set, queue get)"
                if entry is not None
                else "its target does not resolve statically"
            )
            self.lifecycle_flows.append(TaintFlow(
                rel=site["rel"], line=site["line"],
                message=(
                    f"{api} spawned here (kind={site['kind']}) has no "
                    "statically reachable stop/join path: nothing "
                    "join()s/cancel()s/shutdown()s its handle, and "
                    f"{what} — keep the handle and join/cancel it on "
                    "the owner's stop path, loop on a stop Event, or "
                    "pragma a reviewed exemption"
                ),
            ))
        self.lifecycle_flows.sort(key=lambda f: (f.rel, f.line))

    # -- chaos-coverage raw facts (v5) -------------------------------------

    def _chaos_scan(self) -> None:
        """Statically enumerate every faultline seam in production code
        and every literal fault-plan rule anywhere in the target set —
        the raw facts behind the chaos-coverage rule and the
        ``--faultmap-out`` artifact.

        A seam is an ``ast.Call`` resolving to ``faultline.point/guard/
        write/io`` in a strict-profile file outside the seam's own
        implementation; its name must be a string literal (``io`` takes
        the name second and derives ``<name>.read``/``<name>.write``).
        A plan rule is any dict literal with a ``"point"`` string key —
        test plans count: a pinned chaos test IS coverage."""
        seams: list[dict] = []
        dynamic: list[dict] = []
        plans: list[dict] = []
        for mod in self.modules.values():
            production = (
                mod.rel.startswith("fabric_tpu_torch/")
                and mod.rel not in _FAULTLINE_IMPL
            )
            for node in ast.walk(mod.tree):
                if isinstance(node, ast.Call) and production:
                    q = self._resolve_expr(mod, node.func, None, {}, {})
                    kind = _FAULTLINE_FNS.get(q)
                    if kind is None:
                        continue
                    idx = 1 if kind == "io" else 0
                    arg = node.args[idx] if len(node.args) > idx else None
                    if isinstance(arg, ast.Constant) and isinstance(
                        arg.value, str
                    ):
                        names = (
                            [f"{arg.value}.read", f"{arg.value}.write"]
                            if kind == "io" else [arg.value]
                        )
                        for name in names:
                            seams.append({
                                "name": name, "kind": kind,
                                "module": mod.rel, "line": node.lineno,
                            })
                    else:
                        dynamic.append({
                            "kind": kind, "module": mod.rel,
                            "line": node.lineno,
                        })
                elif isinstance(node, ast.Dict):
                    point = action = None
                    for k, v in zip(node.keys, node.values):
                        if isinstance(k, ast.Constant):
                            if k.value == "point":
                                point = v
                            elif k.value == "action":
                                action = v
                    if not (
                        isinstance(point, ast.Constant)
                        and isinstance(point.value, str)
                    ):
                        continue  # no/computed point key: not a pin
                    act = (
                        action.value
                        if isinstance(action, ast.Constant)
                        and isinstance(action.value, str)
                        else "raise"
                    )
                    plans.append({
                        "point": point.value, "action": act,
                        "module": mod.rel, "line": node.lineno,
                        "wildcard": (
                            point.value == "*"
                            or point.value.endswith(".*")
                        ),
                    })
        seams.sort(key=lambda s: (s["name"], s["module"], s["line"]))
        dynamic.sort(key=lambda d: (d["module"], d["line"]))
        plans.sort(key=lambda p: (p["module"], p["line"], p["point"]))
        self.faultline_seams = seams
        self.faultline_dynamic = dynamic
        self.faultline_plans = plans

    def faultmap(self) -> dict:
        """The JSON-shaped chaos-coverage artifact (``--faultmap-out``):
        every production injection seam and every pinned plan rule, both
        in deterministic order."""
        return {
            "seams": self.faultline_seams,
            "dynamic": self.faultline_dynamic,
            "plans": self.faultline_plans,
        }

    # -- surface scans (v6): rpc / knob / metric raw facts -----------------

    def _scope_items(self):
        """(mod, fn|None, cls, params, own nodes) per lexical scope:
        each module's top level (function bodies excluded — they get
        their own entries), then every function including closures.
        The shared walk for the three surface scans."""
        for mod in sorted(self.modules.values(), key=lambda m: m.rel):
            yield mod, None, None, [], list(_own_nodes(mod.tree))
            for fn in mod.functions:
                yield mod, fn, fn.cls, fn.params, list(_own_nodes(fn.node))

    def _mod_consts(self, mod) -> dict:
        cached = getattr(self, "_mod_consts_cache", None)
        if cached is None:
            cached = self._mod_consts_cache = {}
        if mod.rel not in cached:
            cached[mod.rel] = _str_consts(list(_own_nodes(mod.tree)))
        return cached[mod.rel]

    def _handler_shape(self, qname: str | None) -> str:
        """The statically inferred wire shape of a registered handler:
        ``duplex`` (reads its stream param), ``stream`` (yields, or
        returns a call to a resolvable generator), ``unary`` (returns
        bytes/None), or ``unknown`` — which never fires a mismatch."""
        fn = self.symbols.get(qname) if qname else None
        if fn is None:
            return "unknown"
        params = [p for p in fn.params if p != "self"]
        stream_param = params[1] if len(params) > 1 else None
        own = list(_own_nodes(fn.node))
        for n in own:
            if (
                isinstance(n, ast.Call)
                and isinstance(n.func, ast.Attribute)
                and n.func.attr == "recv"
                and isinstance(n.func.value, ast.Name)
                and n.func.value.id == stream_param
            ):
                return "duplex"
        if any(isinstance(n, (ast.Yield, ast.YieldFrom)) for n in own):
            return "stream"
        mod = self.modules[fn.rel]
        for n in own:
            if not (isinstance(n, ast.Return)
                    and isinstance(n.value, ast.Call)):
                continue
            ret = n.value
            q = self._resolve_expr(mod, ret.func, fn.cls, {}, {})
            callee = self.symbols.get(q) if q else None
            if callee is not None:
                if any(
                    isinstance(x, (ast.Yield, ast.YieldFrom))
                    for x in _own_nodes(callee.node)
                ):
                    return "stream"
                continue  # resolvable non-generator helper: unary-ish
            if (
                isinstance(ret.func, ast.Attribute)
                and ret.func.attr in _RPC_BYTES_ATTRS
            ):
                continue  # bytes-producing call: not iterator evidence
            return "unknown"
        return "unary"

    def _rpc_scan(self) -> None:
        """Every `register("svc.Method", handler)` site and every
        `call/stream/duplex("svc.Method", ...)` site in the tree —
        through function-local literal bindings (including IfExp
        branches) and one-level forwarders (a method passing its own
        param into a verb call, e.g. custody's `_call`)."""
        registers: list[dict] = []
        calls: list[dict] = []
        # fn qname -> (verb, call-site arg index of the method name)
        forwarders: dict[str, tuple] = {}
        for mod, fn, cls, params, nodes in self._scope_items():
            mconsts = self._mod_consts(mod)
            local = _str_consts(nodes) if fn is not None else {}
            comp = _rpc_component(mod.rel)
            for n in nodes:
                if not (
                    isinstance(n, ast.Call)
                    and isinstance(n.func, ast.Attribute)
                    and n.args
                ):
                    continue
                attr = n.func.attr
                if attr == "register":
                    methods = [
                        m for m in sorted(
                            _resolve_str_arg(n.args[0], local, mconsts)
                        )
                        if _RPC_METHOD_RE.match(m)
                    ]
                    handler_q = (
                        self._resolve_expr(
                            mod, n.args[1], cls, {}, {}
                        ) if len(n.args) > 1 else None
                    )
                    for m in methods:
                        registers.append({
                            "method": m, "component": comp,
                            "module": mod.rel, "line": n.lineno,
                            "handler": handler_q,
                            "shape": self._handler_shape(handler_q),
                        })
                elif attr in _RPC_VERBS:
                    methods = [
                        m for m in sorted(
                            _resolve_str_arg(n.args[0], local, mconsts)
                        )
                        if _RPC_METHOD_RE.match(m)
                    ]
                    for m in methods:
                        calls.append({
                            "method": m, "verb": attr,
                            "component": comp,
                            "module": mod.rel, "line": n.lineno,
                        })
                    if (
                        not methods
                        and isinstance(n.args[0], ast.Name)
                        and fn is not None
                        and n.args[0].id in params
                    ):
                        idx = params.index(n.args[0].id)
                        if cls is not None and params[:1] == ["self"]:
                            idx -= 1
                        forwarders[fn.qname] = (attr, idx)
        # second pass: literal call sites of the forwarders count as
        # RPC sites with the forwarded verb
        for mod, fn, cls, params, nodes in self._scope_items():
            mconsts = self._mod_consts(mod)
            local = _str_consts(nodes) if fn is not None else {}
            comp = _rpc_component(mod.rel)
            for n in nodes:
                if not (isinstance(n, ast.Call) and n.args):
                    continue
                q = self._resolve_expr(mod, n.func, cls, {}, {})
                fwd = forwarders.get(q) if q else None
                if fwd is None:
                    continue
                verb, idx = fwd
                if idx >= len(n.args):
                    continue
                for m in sorted(
                    _resolve_str_arg(n.args[idx], local, mconsts)
                ):
                    if _RPC_METHOD_RE.match(m):
                        calls.append({
                            "method": m, "verb": verb,
                            "component": comp,
                            "module": mod.rel, "line": n.lineno,
                        })
        registers.sort(
            key=lambda r: (r["method"], r["module"], r["line"])
        )
        calls.sort(key=lambda c: (c["method"], c["module"], c["line"]))
        self.rpc_registers = registers
        self.rpc_calls = calls

    def _knob_scan(self) -> None:
        """Every FABRIC_TPU env read: through the knob registry
        (``via: registry``), or raw (``via: environ`` — a bypass the
        knob-conformance rule fails).  Names resolve through literals,
        module/function string constants (the ``_ENV = "..."``
        convention), and one-level forwarders passing a param into
        ``knob_registry.raw`` (workpool's ``stage_width``)."""
        sites: list[dict] = []
        dynamic: list[dict] = []
        forwarders: dict[str, int] = {}
        for mod, fn, cls, params, nodes in self._scope_items():
            if mod.rel in _KNOB_IMPL:
                continue  # the registry's own environ read is the seam
            mconsts = self._mod_consts(mod)
            local = _str_consts(nodes) if fn is not None else {}
            for n in nodes:
                via = arg = None
                if isinstance(n, ast.Call) and n.args:
                    q = self._resolve_expr(mod, n.func, cls, {}, {})
                    if q in _ENV_READ_FNS:
                        via, arg = "environ", n.args[0]
                    elif q in _KNOB_HELPER_FNS:
                        via, arg = "registry", n.args[0]
                elif (
                    isinstance(n, ast.Subscript)
                    and isinstance(n.ctx, ast.Load)
                ):
                    base = self._resolve_expr(mod, n.value, cls, {}, {})
                    if base == "os.environ":
                        via, arg = "environ", n.slice
                if via is None:
                    continue
                names = _resolve_str_arg(arg, local, mconsts)
                if names:
                    for name in sorted(names):
                        if name.startswith(_KNOB_PREFIX):
                            sites.append({
                                "name": name, "via": via,
                                "module": mod.rel, "line": n.lineno,
                            })
                elif via == "registry":
                    if (
                        isinstance(arg, ast.Name)
                        and fn is not None
                        and arg.id in params
                    ):
                        idx = params.index(arg.id)
                        if cls is not None and params[:1] == ["self"]:
                            idx -= 1
                        forwarders[fn.qname] = idx
                    else:
                        dynamic.append({
                            "module": mod.rel, "line": n.lineno,
                        })
        for mod, fn, cls, params, nodes in self._scope_items():
            mconsts = self._mod_consts(mod)
            local = _str_consts(nodes) if fn is not None else {}
            for n in nodes:
                if not (isinstance(n, ast.Call) and n.args):
                    continue
                q = self._resolve_expr(mod, n.func, cls, {}, {})
                idx = forwarders.get(q) if q else None
                if idx is None or idx >= len(n.args):
                    continue
                for name in sorted(
                    _resolve_str_arg(n.args[idx], local, mconsts)
                ):
                    if name.startswith(_KNOB_PREFIX):
                        sites.append({
                            "name": name, "via": "registry",
                            "module": mod.rel, "line": n.lineno,
                        })
        sites.sort(key=lambda s: (s["name"], s["module"], s["line"]))
        dynamic.sort(key=lambda d: (d["module"], d["line"]))
        self.knob_sites = sites
        self.knob_dynamic = dynamic

    def _metric_scan(self) -> None:
        """Metric producers (Counter/Gauge/HistogramOpts constructions
        in production code, with whether each is registered through a
        provider ``new_*`` call and which class/function owns it),
        netscope's derived series, and every consumer site — literal
        names passed to ``.series(...)`` anywhere, plus rollup-code
        string comparisons and ``*_series`` parameter defaults inside
        netscope itself."""
        producers: list[dict] = []
        derived: list[dict] = []
        consumers: list[dict] = []
        dynamic: list[dict] = []
        opts_sites: list[tuple] = []  # (mod, node, kind, owner)
        wrapped: set = set()  # id() of Opts calls passed to new_*
        for mod, fn, cls, params, nodes in self._scope_items():
            production = mod.rel.startswith("fabric_tpu_torch/")
            owner = None
            if cls is not None:
                owner = f"{mod.dotted}.{cls}"
            elif fn is not None:
                owner = fn.qname
            for n in nodes:
                if isinstance(n, ast.Call):
                    if (
                        isinstance(n.func, ast.Attribute)
                        and n.func.attr in _METRIC_NEW_FNS
                    ):
                        for a in list(n.args) + [
                            kw.value for kw in n.keywords
                        ]:
                            if isinstance(a, ast.Call):
                                wrapped.add(id(a))
                    kind = self._opts_kind(mod, n)
                    if kind is not None and production:
                        opts_sites.append((mod, n, kind, owner))
                    if (
                        isinstance(n.func, ast.Attribute)
                        and n.func.attr == "series"
                        and len(n.args) >= 2
                    ):
                        for name in sorted(_literal_strs(n.args[1])):
                            consumers.append({
                                "name": name, "context": "series",
                                "module": mod.rel, "line": n.lineno,
                            })
                elif mod.rel == _NETSCOPE_REL and isinstance(
                    n, ast.Tuple
                ):
                    if (
                        len(n.elts) >= 2
                        and isinstance(n.elts[0], ast.Constant)
                        and n.elts[0].value == "_derived"
                        and isinstance(n.elts[1], ast.Constant)
                        and isinstance(n.elts[1].value, str)
                    ):
                        derived.append({
                            "name": n.elts[1].value,
                            "module": mod.rel, "line": n.lineno,
                        })
                elif mod.rel == _NETSCOPE_REL and isinstance(
                    n, ast.Compare
                ):
                    if not all(
                        isinstance(op, (ast.Eq, ast.NotEq))
                        for op in n.ops
                    ):
                        continue
                    for side in [n.left] + list(n.comparators):
                        if (
                            isinstance(side, ast.Constant)
                            and isinstance(side.value, str)
                            and _METRIC_NAME_RE.match(side.value)
                        ):
                            consumers.append({
                                "name": side.value,
                                "context": "rollup",
                                "module": mod.rel, "line": n.lineno,
                            })
            if fn is not None and mod.rel == _NETSCOPE_REL:
                # `height_series: str = "ledger_height"`-style defaults
                a = fn.node.args
                pos = a.posonlyargs + a.args
                for p, d in zip(pos[len(pos) - len(a.defaults):],
                                a.defaults):
                    if (
                        p.arg.endswith("_series")
                        and isinstance(d, ast.Constant)
                        and isinstance(d.value, str)
                    ):
                        consumers.append({
                            "name": d.value, "context": "default",
                            "module": mod.rel, "line": fn.lineno,
                        })
        for mod, n, kind, owner in opts_sites:
            kwargs = {
                kw.arg: kw.value for kw in n.keywords
                if kw.arg is not None
            }
            parts = []
            literal = True
            for key in ("namespace", "subsystem", "name"):
                v = kwargs.get(key)
                if v is None:
                    continue
                if isinstance(v, ast.Constant) and isinstance(
                    v.value, str
                ):
                    if v.value:
                        parts.append(v.value)
                else:
                    literal = False
            if not literal or "name" not in kwargs:
                dynamic.append({
                    "kind": kind, "module": mod.rel, "line": n.lineno,
                })
                continue
            producers.append({
                "name": "_".join(parts), "kind": kind,
                "module": mod.rel, "line": n.lineno,
                "registered": id(n) in wrapped, "owner": owner,
            })
        # owner reachability: an Opts-owning class/function nothing in
        # PRODUCTION instantiates/calls is dead instrumentation — its
        # metrics can never appear on a real node's scrape (orphan
        # producers; a test-only reference does not count)
        owners = {p["owner"] for p in producers if p["owner"]}
        referenced: set = set()
        if owners:
            for mod in self.modules.values():
                if not mod.rel.startswith("fabric_tpu_torch/"):
                    continue
                for n in ast.walk(mod.tree):
                    if isinstance(n, ast.Call):
                        q = self._resolve_expr(mod, n.func, None, {}, {})
                        if q in owners:
                            referenced.add(q)
        for p in producers:
            p["reachable"] = p["owner"] is None or p["owner"] in referenced
        producers.sort(
            key=lambda p: (p["name"], p["module"], p["line"])
        )
        derived.sort(key=lambda d: (d["name"], d["module"], d["line"]))
        consumers.sort(
            key=lambda c: (c["name"], c["module"], c["line"],
                           c["context"])
        )
        dynamic.sort(key=lambda d: (d["module"], d["line"]))
        self.metric_producers = producers
        self.metric_derived = derived
        self.metric_consumers = consumers
        self.metric_dynamic = dynamic

    def _opts_kind(self, mod, call: ast.Call) -> str | None:
        """counter/gauge/histogram when `call` constructs a metric
        Opts (by import or same-module class reference); else None."""
        q = self._resolve_expr(mod, call.func, None, {}, {})
        if q is None:
            dotted = _dotted(call.func)
            if dotted is not None:
                cand = f"{mod.dotted}.{dotted}"
                if cand in _METRIC_OPTS:
                    q = cand
        return _METRIC_OPTS.get(q) if q else None

    def rpcmap(self) -> dict:
        """The JSON-shaped RPC-conformance artifact (``--rpcmap-out``):
        every method with its register and call sites, both in
        deterministic order."""
        methods: dict[str, dict] = {}
        for r in self.rpc_registers:
            m = methods.setdefault(
                r["method"], {"registers": [], "calls": []}
            )
            m["registers"].append({
                k: r[k] for k in
                ("component", "module", "line", "handler", "shape")
            })
        for c in self.rpc_calls:
            m = methods.setdefault(
                c["method"], {"registers": [], "calls": []}
            )
            m["calls"].append({
                k: c[k] for k in ("component", "module", "line", "verb")
            })
        return {"methods": {k: methods[k] for k in sorted(methods)}}

    def knob_map(self) -> dict:
        """The read-site half of the ``--knobs-out`` artifact (lint.py
        joins it with the registry entries)."""
        return {"reads": self.knob_sites, "dynamic": self.knob_dynamic}

    def metricmap(self) -> dict:
        """The JSON-shaped metrics-conformance artifact
        (``--metricmap-out``).  ``exposed`` is every series name a
        scrape can legally produce: registered producers (histograms
        expanded to their ``_bucket``/``_sum``/``_count`` series) plus
        netscope's derived series."""
        exposed: set = set()
        for p in self.metric_producers:
            exposed.add(p["name"])
            if p["kind"] == "histogram":
                for suf in _HISTOGRAM_SUFFIXES:
                    exposed.add(p["name"] + suf)
        for d in self.metric_derived:
            exposed.add(d["name"])
        return {
            "producers": self.metric_producers,
            "derived": self.metric_derived,
            "consumers": self.metric_consumers,
            "dynamic": self.metric_dynamic,
            "exposed": sorted(exposed),
        }

    # -- public API --------------------------------------------------------

    def lock_graph(self, strict_only: bool = True) -> dict:
        """The static role-level acquisition-order graph as a JSON-
        shaped artifact: ``edges[src][dst]`` lists the [rel, line]
        acquisition sites establishing src -> dst.  With
        ``strict_only`` (the default, and what the CI artifact and the
        runtime-⊆-static cross-check consume) only production sites
        count — tests may nest fixture locks in orders production
        never uses."""
        edges: dict[str, dict] = {}
        for (src, dst), site_list in sorted(self.lock_order_edges.items()):
            kept = [
                [rel, line] for rel, line in site_list
                if not strict_only
                or not rel.startswith(RELAXED_PREFIXES)
            ]
            if kept:
                edges.setdefault(src, {})[dst] = kept
        roles = sorted(
            set(edges) | {d for v in edges.values() for d in v}
        )
        return {"edges": edges, "roles": roles}

    def function(self, qname: str) -> FunctionInfo | None:
        return self.symbols.get(qname)

    def summaries(self) -> list[dict]:
        return [
            fn.summary()
            for _, fn in sorted(self.symbols.items())
        ]


__all__ = [
    "Project",
    "FunctionInfo",
    "ModuleInfo",
    "ClassInfo",
    "TaintFlow",
    "CSP_SEAM_ALLOWED",
    "BLOCKING_CALLS",
]
