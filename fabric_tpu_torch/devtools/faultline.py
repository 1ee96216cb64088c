"""faultline: deterministic fault injection at named points.

The port's copy of the JAX package's `fabric_tpu/devtools/faultline.py`,
with the points the port visits: the CSP provider's, the ledger's
(``commit.stage``, ``blkstorage.*``, ``snapshot.*``, ``store.*``), the
validator's ``collect.tx`` and the RPC layer's (``rpc.*``).  Plans are
data that operators and tests write, so the plan format, its actions
and triggers, and the point names are the JAX package's: one plan,
armed in both packages, drives both alike.  The points are no-ops
unless a plan is armed: `point()` / `guard()` / `write()` are a
module-global load and an ``is None`` test, and `io()` hands back the
very socket it was given.

A PLAN is a JSON document (inline in ``FABRIC_TPU_FAULTLINE``, or
``@/path/to/plan.json``, or passed to :func:`activate` /
:func:`use_plan`)::

    {"seed": 7, "faults": [
        {"point": "tpu.dispatch", "action": "raise",
         "error": "DeviceUnavailable", "nth": 1},
        {"point": "tpu.collect", "action": "raise",
         "error": "DeviceUnavailable", "count": 3},
        {"point": "tpu.collect", "action": "delay", "delay_s": 2.0,
         "nth": 1},
        {"point": "tpu.hash", "action": "raise", "every": 5}
    ]}

Actions: ``raise`` (named error class, default :class:`FaultInjected`),
``crash`` (:class:`FaultCrash`, simulated process death, a
BaseException so no recovery handler may swallow it), ``delay``
(``delay_s`` seconds; :func:`stall` hands it back to the caller instead
of sleeping), ``skew`` (jumps the :mod:`clockskew` clock by
``skew_s``), ``torn`` (at :func:`write` points: a prefix lands, then
FaultCrash), ``partial`` (at :func:`io` points: a truncated read or
write, then a reset) and ``skip`` (at :func:`guard` points: the guarded
operation is skipped); a plain point raises for the last three.  Triggers: ``nth`` (fire on the
Nth matching hit), ``every`` (every Kth), ``prob`` (seeded probability),
default every hit; ``count`` caps total trips (default 1 for ``nth``,
unlimited otherwise); ``ctx`` restricts to call sites whose keyword
context matches.  All randomness comes from
``random.Random(f"{seed}:{rule_index}")``, never the wall clock, so the
same plan over the same workload yields the same trip ledger.

Every fired fault is recorded in a process-wide TRIP LEDGER
(:func:`trips`); :func:`use_plan` drains its own plan's trips on exit.
While a plan is armed every point consulted registers its name, kind and
a bounded sample of its context (:func:`registry`).  Plans nest:
:func:`use_plan` inside another plan arms the inner one for its scope
and restores the outer one, trigger state intact.
``FABRIC_TPU_SOAK=<seed>`` arms :func:`soak_plan`, a low-probability
background plan of tiny delays.
"""

from __future__ import annotations

import contextlib
import json
import random
import threading

from fabric_tpu_torch.devtools import clockskew, knob_registry

_ENV = "FABRIC_TPU_FAULTLINE"
_SOAK_ENV = "FABRIC_TPU_SOAK"


class PlanError(ValueError):
    """A fault plan that does not validate."""


class FaultInjected(OSError):
    """Generic injected failure.  An OSError so the transports' and
    storage layers' real error paths route it like the failures it
    stands in for."""


class FaultCrash(BaseException):
    """Simulated process death.  Deliberately NOT an Exception: a broad
    ``except Exception`` recovery handler must never swallow it, and the
    ledger's group-rollback seam explicitly skips cleanup for it
    (``faultline.is_crash``) — a real crash gets no unwind, so the test
    that catches this and reopens the store exercises the REAL recovery
    path, not the graceful one."""


class DeviceUnavailable(RuntimeError):
    """Injected accelerator loss (the device vanished mid-flush)."""


_ERRORS = {
    "FaultInjected": FaultInjected,
    "FaultCrash": FaultCrash,
    "OSError": OSError,
    "IOError": OSError,
    "ConnectionResetError": ConnectionResetError,
    "ECONNRESET": ConnectionResetError,
    "BrokenPipeError": BrokenPipeError,
    "ConnectionRefusedError": ConnectionRefusedError,
    "TimeoutError": TimeoutError,
    "RuntimeError": RuntimeError,
    "ValueError": ValueError,
    "DeviceUnavailable": DeviceUnavailable,
}

_ACTIONS = ("raise", "crash", "delay", "torn", "partial", "skip", "skew")

# the armed plan; the point()/stall() fast paths test ONLY this global
_plan = None
_state_lock = threading.Lock()

# process-wide trip ledger (survives deactivate; use_plan drains its own
# plan's entries).  _trip_owners runs parallel to _trips carrying the
# recording Plan's id() so nested use_plan scopes drain only their own
# trips — the ids never appear in the public records (they are not
# deterministic across runs; the plan LABEL is, and is public).
_trips: list[dict] = []
_trip_owners: list[int] = []
_trips_lock = threading.Lock()

# live fault-point registry: name -> {"kinds": set, "ctx": {key: set of
# sample values}}.  Populated ONLY while a plan is armed,
# so the unarmed hot path stays a global load + None test.
_registry: dict[str, dict] = {}
_registry_lock = threading.Lock()
_CTX_SAMPLES = 8  # bounded per-key value samples (fuzzer targeting)

# plan consultations — stays 0 while no plan is armed, which is the
# acceptance test for "every fault point is a no-op when unset"
_lookups = [0]


class _Rule:
    """One fault specification, with its deterministic trigger state."""

    def __init__(self, index: int, spec: dict, seed: int):
        if not isinstance(spec, dict):
            raise PlanError(f"fault #{index} is not an object")
        point = spec.get("point")
        if not isinstance(point, str) or not point:
            raise PlanError(f"fault #{index}: missing point name")
        self.index = index
        self.point = point
        self.action = spec.get("action", "raise")
        if self.action not in _ACTIONS:
            raise PlanError(
                f"fault #{index}: unknown action {self.action!r} "
                f"(one of {', '.join(_ACTIONS)})"
            )
        self.error = spec.get("error", "FaultInjected")
        if self.error not in _ERRORS:
            raise PlanError(
                f"fault #{index}: unknown error {self.error!r} "
                f"(one of {', '.join(sorted(_ERRORS))})"
            )
        self.message = spec.get(
            "message", f"faultline: injected fault at {point}"
        )
        try:
            self.delay_s = float(spec.get("delay_s", 0.01))
            self.cut = float(spec.get("cut", 0.5))
            self.skew_s = float(spec.get("skew_s", 5.0))
            raw_wall = spec.get("skew_wall_s")
            self.skew_wall_s = None if raw_wall is None else float(raw_wall)
        except (TypeError, ValueError):
            raise PlanError(
                f"fault #{index}: delay_s/cut/skew_s must be numbers"
            ) from None
        if not 0.0 <= self.cut <= 1.0:
            raise PlanError(f"fault #{index}: cut must be in [0, 1]")
        ctx = spec.get("ctx") or {}
        if not isinstance(ctx, dict):
            raise PlanError(f"fault #{index}: ctx must be an object")
        self.ctx = ctx
        def typed(key, conv, minimum=None):
            """Coerce a trigger field at PARSE time — a bad value must
            be a PlanError at activate(), not a TypeError mid-commit
            inside the injected production path."""
            v = spec.get(key)
            if v is None:
                return None
            try:
                v = conv(v)
            except (TypeError, ValueError):
                raise PlanError(
                    f"fault #{index}: {key} must be a {conv.__name__}"
                ) from None
            if minimum is not None and v < minimum:
                raise PlanError(
                    f"fault #{index}: {key} must be >= {minimum}"
                )
            return v

        self.nth = typed("nth", int, minimum=1)
        self.every = typed("every", int, minimum=1)
        self.prob = typed("prob", float)
        if self.prob is not None and not 0.0 <= self.prob <= 1.0:
            raise PlanError(f"fault #{index}: prob must be in [0, 1]")
        if sum(x is not None for x in (self.nth, self.every, self.prob)) > 1:
            raise PlanError(
                f"fault #{index}: nth/every/prob are mutually exclusive"
            )
        default_count = 1 if self.nth is not None else None
        self.count = typed("count", int, minimum=1)
        if self.count is None:
            self.count = default_count
        self.hits = 0
        self.trips = 0
        # seeded from the PLAN, never wall-clock: chaos runs replay
        self._rng = random.Random(f"{seed}:{index}")

    def matches(self, ctx: dict) -> bool:
        return all(ctx.get(k) == v for k, v in self.ctx.items())

    @property
    def wildcard(self) -> bool:
        return self.point == "*" or self.point.endswith(".*")

    def matches_point(self, name: str) -> bool:
        """Wildcard point matching: ``*`` hits every point, a trailing
        ``.*`` matches the dotted prefix — how a soak plan covers the
        whole registry without enumerating it."""
        if self.point == "*":
            return True
        if self.point.endswith(".*"):
            return name.startswith(self.point[:-1])
        return name == self.point

    def fire(self) -> bool:
        """Count a matching hit and decide whether this rule's trigger
        fires on it (caller holds the plan lock).  Does NOT record the
        trip — when several rules on one point fire on the same hit,
        only the first in plan order wins and Plan.visit records it."""
        self.hits += 1
        if self.count is not None and self.trips >= self.count:
            return False
        if self.nth is not None:
            return self.hits == self.nth
        if self.every is not None:
            return self.hits % self.every == 0
        if self.prob is not None:
            return self._rng.random() < self.prob
        return True

    def cut_len(self, n: int) -> int:
        """Strict-prefix length for torn/partial payloads of n bytes."""
        if n <= 0:
            return 0
        return max(0, min(n - 1, int(n * self.cut)))

    def execute(self):
        """Perform the point-level action: raise, crash, delay, or skew.
        torn/partial/skip reached through a point that cannot honor
        their semantics degrade to a loud raise."""
        if self.action == "delay":
            if self.delay_s > 0:
                # through the clockskew seam: under a virtual clock an
                # injected delay advances time instead of sleeping
                clockskew.sleep(self.delay_s)
            return
        if self.action == "skew":
            # jump the virtual clock mid-operation (no-op on the system
            # clock — real time cannot be skewed; the trip still lands)
            clockskew.advance(self.skew_s, self.skew_wall_s)
            return
        if self.action == "crash":
            raise FaultCrash(self.message)
        if self.action == "raise":
            raise _ERRORS[self.error](self.message)
        raise FaultInjected(
            f"{self.message} ({self.action} fault at a non-data point)"
        )

def _register(name: str, kind: str, ctx: dict) -> None:
    """Self-registration at first (and every) armed hit: the fuzzer's
    view of the injectable surface.  Bounded ctx value sampling gives
    the generator concrete targets (e.g. commit.stage stage=pvt)."""
    with _registry_lock:
        ent = _registry.get(name)
        if ent is None:
            ent = _registry[name] = {"kinds": set(), "ctx": {}}
        ent["kinds"].add(kind)
        for k, v in ctx.items():
            if not isinstance(v, (str, int, bool)):
                continue
            vals = ent["ctx"].setdefault(k, set())
            if len(vals) < _CTX_SAMPLES:
                vals.add(v)


class Plan:
    """A parsed, armed fault schedule.  ``label`` (optional in the
    spec, default ``plan:<seed>``) tags every trip this plan records —
    how soak-background trips and test-local trips stay attributable
    when plans nest."""

    def __init__(self, spec):
        if isinstance(spec, (str, bytes)):
            try:
                spec = json.loads(spec)
            except ValueError as exc:
                raise PlanError(f"plan is not valid JSON: {exc}") from exc
        if not isinstance(spec, dict):
            raise PlanError("plan must be a JSON object")
        try:
            self.seed = int(spec.get("seed", 0))
        except (TypeError, ValueError):
            raise PlanError("plan seed must be an integer") from None
        self.label = spec.get("label", f"plan:{self.seed}")
        if not isinstance(self.label, str) or not self.label:
            raise PlanError("plan label must be a non-empty string")
        # registry feeding is opt-out: a long-running soak plan would
        # otherwise pay a registry-lock acquire + dict mutation on EVERY
        # hit for data only fuzz discovery ever reads
        self.register_points = bool(spec.get("register", True))
        faults = spec.get("faults")
        if not isinstance(faults, list) or not faults:
            raise PlanError("plan must carry a non-empty 'faults' list")
        self.rules: list[_Rule] = [
            _Rule(i, fs, self.seed) for i, fs in enumerate(faults)
        ]
        self._by_point: dict[str, list[_Rule]] = {}
        self._wild: list[_Rule] = []
        for r in self.rules:
            if r.wildcard:
                self._wild.append(r)
            else:
                self._by_point.setdefault(r.point, []).append(r)
        # merged exact+wildcard rule list per point name, memoized on
        # first hit: the rule set is static for the plan's lifetime,
        # and a long-running soak plan must not pay a sort per hit
        self._merged: dict[str, list[_Rule]] = {}
        self._lock = threading.Lock()

    def visit(self, name: str, ctx: dict, kind: str = "point"):
        """Consult the schedule for one hit of `name`; returns the
        tripped rule (trip already recorded in the ledger) or None.
        EVERY matching rule counts the hit — a later rule's nth/every
        trigger must not drift just because an earlier rule fired on
        the same hit; when several fire at once the first in plan
        order wins and only it records a trip."""
        if self.register_points:
            _register(name, kind, ctx)
        winner = None
        with self._lock:
            _lookups[0] += 1
            if self._wild:
                rules = self._merged.get(name)
                if rules is None:
                    extra = [
                        r for r in self._wild if r.matches_point(name)
                    ]
                    rules = sorted(
                        [*self._by_point.get(name, ()), *extra],
                        key=lambda r: r.index,
                    )
                    self._merged[name] = rules
            else:
                rules = self._by_point.get(name, ())
            for r in rules:
                if r.matches(ctx) and r.fire() and winner is None:
                    winner = r
            if winner is not None:
                winner.trips += 1
                rec = {
                    "plan": self.label,
                    "point": name,
                    "action": winner.action,
                    "rule": winner.index,
                    "hit": winner.hits,
                    "trip": winner.trips,
                }
                if ctx:
                    rec["ctx"] = dict(ctx)
                with _trips_lock:
                    _trips.append(rec)
                    _trip_owners.append(id(self))
                # a tripped fault annotates the active span and drops an
                # instant mark, so a trace shows which stage it landed
                # in (lazy import: faultline stays importable first)
                from fabric_tpu_torch.common import tracing

                if tracing.enabled():
                    tracing.annotate(fault=name, fault_action=winner.action)
                    tracing.instant(
                        "fault", point=name, action=winner.action,
                        plan=self.label, rule=winner.index,
                        trip=winner.trips,
                    )
        return winner


# -- fault points -------------------------------------------------------------


def point(name: str, **ctx) -> None:
    """A named fault point.  No plan armed: a global load + None test.
    Armed: consult the schedule; a tripped rule raises (raise/crash) or
    delays in place."""
    p = _plan
    if p is None:
        return
    r = p.visit(name, ctx)
    if r is not None:
        r.execute()


def stall(name: str, **ctx) -> float:
    """A named fault point whose tripped ``delay`` is handed back in
    seconds instead of slept: the caller models it as a stall of work
    that runs elsewhere (a device's), so that no thread of its own sits
    the delay out.  Any other tripped action raises as at `point`; 0.0
    when nothing trips."""
    p = _plan
    if p is None:
        return 0.0
    r = p.visit(name, ctx)
    if r is None:
        return 0.0
    if r.action == "delay":
        return max(0.0, r.delay_s)
    r.execute()
    return 0.0


def guard(name: str, **ctx) -> bool:
    """A guarded-operation fault point: the caller performs a SAFETY
    operation (recovery truncation, verify-on-import, an fsync) only
    when this returns True.  No plan armed: always True, same fast path
    as :func:`point`.  A tripped ``skip`` rule returns False; any other
    tripped action executes as usual."""
    p = _plan
    if p is None:
        return True
    r = p.visit(name, ctx, kind="guard")
    if r is None:
        return True
    if r.action == "skip":
        return False
    r.execute()
    return True


def write(name: str, fh, *chunks: bytes, **ctx) -> None:
    """File-write fault point that honours torn-write-then-crash.  No
    plan: writes the chunks straight through.  A tripped ``torn`` rule
    writes a strict prefix of the joined payload, flushes it so the tear
    is really on disk, and raises :class:`FaultCrash`; other actions
    execute BEFORE anything is written."""
    p = _plan
    if p is None:
        for c in chunks:
            fh.write(c)
        return
    r = p.visit(name, ctx, kind="write")
    if r is not None:
        if r.action == "torn":
            data = b"".join(chunks)
            cut = r.cut_len(len(data))
            fh.write(data[:cut])
            fh.flush()
            raise FaultCrash(
                f"faultline: torn write at {name} "
                f"({cut}/{len(data)} bytes), then crash"
            )
        r.execute()
    for c in chunks:
        fh.write(c)


class _FaultSocket:
    """Socket proxy visiting ``<name>.read`` / ``<name>.write`` fault
    points around recv/send.  A ``partial`` read returns a truncated
    chunk and marks the connection dead (the next read resets); a
    ``partial``/``torn`` write sends a prefix then resets.  Everything
    else passes through untouched."""

    def __init__(self, inner, name: str):
        self._fl_inner = inner
        self._fl_name = name
        self._fl_dead = False

    def __getattr__(self, attr):
        return getattr(self._fl_inner, attr)

    def _fl_visit(self, kind: str):
        if self._fl_dead:
            raise ConnectionResetError(
                f"faultline: {self._fl_name} connection reset (injected)"
            )
        p = _plan
        if p is None:
            return None
        return p.visit(f"{self._fl_name}.{kind}", {}, kind="io")

    def recv(self, bufsize: int, *args):
        r = self._fl_visit("read")
        if r is not None:
            if r.action == "partial":
                data = self._fl_inner.recv(bufsize, *args)
                self._fl_dead = True
                return data[: r.cut_len(len(data))]
            r.execute()
        return self._fl_inner.recv(bufsize, *args)

    def _fl_send(self, data, send_fn):
        r = self._fl_visit("write")
        if r is not None:
            if r.action in ("partial", "torn"):
                cut = r.cut_len(len(data))
                if cut:
                    self._fl_inner.sendall(data[:cut])
                self._fl_dead = True
                raise ConnectionResetError(
                    f"faultline: {self._fl_name} write torn at "
                    f"{cut}/{len(data)} bytes (injected)"
                )
            r.execute()
        return send_fn(data)

    def sendall(self, data):
        return self._fl_send(data, self._fl_inner.sendall)

    def send(self, data):
        return self._fl_send(data, self._fl_inner.send)


def io(sock, name: str):
    """Wrap a socket in read/write fault points ``<name>.read`` /
    ``<name>.write``.  Returns the socket UNCHANGED when no plan is
    armed: the wrapper only exists while a plan is."""
    if _plan is None:
        return sock
    return _FaultSocket(sock, name)


def is_crash(exc: BaseException) -> bool:
    """True for the simulated-process-death exception — cleanup/rollback
    seams skip their unwind for it so reopen exercises real recovery."""
    return isinstance(exc, FaultCrash)


# -- plan lifecycle -----------------------------------------------------------


def active() -> bool:
    return _plan is not None


def current_plan():
    return _plan


def lookup_count() -> int:
    """Total plan consultations so far — provably 0 while no plan has
    ever been armed (the zero-overhead acceptance probe)."""
    return _lookups[0]


def trips() -> list[dict]:
    """Snapshot of the process-wide trip ledger."""
    with _trips_lock:
        return [dict(t) for t in _trips]


def reset_trips() -> None:
    with _trips_lock:
        _trips.clear()
        _trip_owners.clear()


def _drain_plan(p: Plan) -> None:
    """Remove exactly the trips `p` recorded (nesting-safe: an outer
    plan's trips survive an inner use_plan scope's exit)."""
    with _trips_lock:
        keep = [
            (t, o) for t, o in zip(_trips, _trip_owners) if o != id(p)
        ]
        _trips[:] = [t for t, _ in keep]
        _trip_owners[:] = [o for _, o in keep]


def registry() -> dict[str, dict]:
    """Snapshot of the live fault-point registry: every point name
    consulted while a plan was armed, with the kinds it
    was hit as and bounded per-key ctx value samples — the surface the
    faultfuzz generator enumerates."""
    with _registry_lock:
        return {
            name: {
                "kinds": sorted(ent["kinds"]),
                "ctx": {
                    k: sorted(vs, key=repr)
                    for k, vs in sorted(ent["ctx"].items())
                },
            }
            for name, ent in sorted(_registry.items())
        }


def reset_registry() -> None:
    with _registry_lock:
        _registry.clear()


def activate(plan) -> Plan:
    """Arm a plan (dict, JSON string, or Plan).  Replaces any armed
    plan; trigger state starts fresh."""
    p = plan if isinstance(plan, Plan) else Plan(plan)
    global _plan
    with _state_lock:
        _plan = p
    return p


def deactivate() -> None:
    global _plan
    with _state_lock:
        _plan = None


@contextlib.contextmanager
def use_plan(plan):
    """Arm a plan for a scope and DRAIN on exit: the plan is disarmed
    and ITS trips removed from the ledger, so a test suite's gate
    (which asserts no armed plan and an empty ledger) stays green for
    every test that keeps its chaos inside this context.

    Nesting/re-arm semantics (the soak + test-local composition): if a
    plan is already armed on entry, the inner plan WINS for the scope —
    every point consults only it — and the outer plan is restored on
    exit with its trigger state intact (hit counters, rng position, and
    its already-recorded trips all survive; trips are attributed per
    plan via their ``label``)."""
    p = plan if isinstance(plan, Plan) else Plan(plan)
    with _state_lock:
        global _plan
        outer, _plan = _plan, p
    try:
        yield p
    finally:
        with _state_lock:
            _plan = outer
        _drain_plan(p)


def soak_plan(seed: int, label: str = "soak") -> dict:
    """A low-probability background plan over the WHOLE registry
    (wildcard points), benign by construction: tiny seeded delays that
    perturb scheduling/timing everywhere without breaking any
    correctness contract — the tier-1 soak workload must finish with a
    green invariant oracle under it.  Armed via ``FABRIC_TPU_SOAK=
    <seed>`` or ``use_plan(soak_plan(seed))``."""
    return {
        "seed": int(seed),
        "label": label,
        # a long-running background plan skips registry feeding (pure
        # per-hit overhead for data only fuzz discovery consumes)
        "register": False,
        "faults": [
            # a whisper of latency anywhere, occasionally
            {"point": "*", "action": "delay", "delay_s": 0.0002,
             "prob": 0.02, "count": 2000},
            # commit stages see a slightly hotter rate: the lock-order
            # and group-flush seams are where timing bugs hide
            {"point": "commit.stage", "action": "delay", "delay_s": 0.001,
             "prob": 0.05, "count": 500},
            # io wrappers stay installed for the whole run (io() only
            # wraps while armed), so socket paths get coverage too
            {"point": "rpc.*", "action": "delay", "delay_s": 0.0002,
             "prob": 0.02, "count": 500},
        ],
    }


def _init_from_env() -> None:
    raw = knob_registry.raw(_ENV)
    if raw and raw not in ("0", "false", "off"):
        if raw.startswith("@"):
            with open(raw[1:], "r", encoding="utf-8") as f:
                raw = f.read()
        activate(raw)
        return
    soak = knob_registry.raw(_SOAK_ENV)
    if soak and soak not in ("0", "false", "off"):
        try:
            seed = int(soak)
        except ValueError:
            raise PlanError(
                f"{_SOAK_ENV} must be an integer seed, got {soak!r}"
            ) from None
        activate(soak_plan(seed))


_init_from_env()


__all__ = [
    "PlanError",
    "FaultInjected",
    "FaultCrash",
    "DeviceUnavailable",
    "Plan",
    "point",
    "stall",
    "guard",
    "write",
    "io",
    "is_crash",
    "active",
    "current_plan",
    "lookup_count",
    "trips",
    "reset_trips",
    "registry",
    "reset_registry",
    "activate",
    "deactivate",
    "use_plan",
    "soak_plan",
]
