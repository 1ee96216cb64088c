"""netsplit: deterministic network-partition injection on the transports.

The port's copy of the JAX package's `fabric_tpu/devtools/netsplit.py`:
the same plan format, modes and ledgers, so one plan judges both
packages' links alike.  faultline injects faults inside a process; this
module injects *asymmetric connectivity*.  It is a connection-policy
seam in the faultline/clockskew style, a no-op unless a plan is armed
(:func:`connect`/:func:`accept` are a module-global load and an ``is
None`` test), through which the port's outbound connects and inbound
accepts are routed (``comm/rpc.py``: client connect and server accept).

A PLAN is a JSON document (inline in ``FABRIC_TPU_NETSPLIT``, or
``@/path/to/plan.json``, or passed to :func:`activate` /
:func:`use_plan`)::

    {"seed": 7, "mode": "full",
     "groups": [["orderer0", "orderer1", "org1-peer0"],
                ["orderer2", "org2-peer0"]],
     "node": "org1-peer0",
     "addrs": {"127.0.0.1:9101": "orderer0",
               "127.0.0.1:9201": "org2-peer0"}}

``groups`` partitions node ids.  Links WITHIN a group, links touching a
node in no group, and links whose endpoints cannot be resolved are
always allowed.  Cross-group links obey ``mode``:

- ``full``   — denied in both directions (a symmetric split).
- ``oneway`` — denied only from an earlier-listed group toward a
  later-listed one (``groups[0]`` cannot reach ``groups[1]``; the
  reverse direction stays up).
- ``flaky``  — each attempt drops with probability ``p`` drawn from a
  per-link stream ``random.Random(f"{seed}:{src}:{dst}")``, never the
  wall clock, so a run replays exactly.

``node`` pins the local node id (or :func:`set_local_node`); ``addrs``
maps listener ``host:port`` strings to node ids so the seam can judge
links it only knows by address (an RPC client dialing a listener).

Denied links fail FAST with :class:`NetsplitDenied`, an ``OSError``, so
a transport's connect-failure path routes it like a refused
connection.  Arming a ``full``/``oneway`` plan also CUTS established
connections on a severed link: transports register long-lived sockets
via :func:`track`/:func:`untrack` and :func:`activate` closes the
matching ones.

Both decision points are also faultline seams: ``netsplit.deny`` fires
on every denial and ``netsplit.cut`` on every mid-stream cut.
"""

from __future__ import annotations

import contextlib
import json
import random
import threading

from fabric_tpu_torch.devtools import knob_registry

_ENV = "FABRIC_TPU_NETSPLIT"

_MODES = ("full", "oneway", "flaky")


class PlanError(ValueError):
    """A partition plan that does not validate."""


class NetsplitDenied(OSError):
    """A connect/accept denied by the armed partition plan.  An
    OSError so the transports' real connect-failure paths route it
    like ECONNREFUSED — fast, no connect-timeout stall."""


# the armed plan; connect()/accept() fast paths test ONLY this global
_plan = None
_state_lock = threading.Lock()

# process-local node identity (a plan's "node" field overrides it)
_local_node: str | None = None

# live tracked connections for mid-stream cut: token -> (sock, peer,
# addr).  Transports register long-lived sockets tagged with whatever
# identity they have (a node id after a handshake, else the remote
# listener address) and unregister on teardown.
_conns: dict[int, tuple] = {}
_conns_lock = threading.Lock()
_next_token = [0]

# process-wide denial/cut ledgers (test observability, deterministic
# given a deterministic workload; reset via reset_log())
_denials: list[dict] = []
_cuts: list[dict] = []
_log_lock = threading.Lock()

# plan consultations — stays 0 while no plan is armed (the
# zero-overhead acceptance probe, mirroring faultline.lookup_count)
_lookups = [0]


class Plan:
    """A parsed, armed partition schedule."""

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
        self.label = spec.get("label", f"netsplit:{self.seed}")
        if not isinstance(self.label, str) or not self.label:
            raise PlanError("plan label must be a non-empty string")
        self.mode = spec.get("mode", "full")
        if self.mode not in _MODES:
            raise PlanError(
                f"unknown mode {self.mode!r} (one of {', '.join(_MODES)})"
            )
        groups = spec.get("groups")
        if not isinstance(groups, list) or len(groups) < 2:
            raise PlanError("plan must carry >= 2 'groups'")
        self.groups: list[tuple[str, ...]] = []
        self._group_of: dict[str, int] = {}
        for gi, members in enumerate(groups):
            if not isinstance(members, list) or not members:
                raise PlanError(f"group #{gi} must be a non-empty list")
            for m in members:
                if not isinstance(m, str) or not m:
                    raise PlanError(
                        f"group #{gi}: node ids must be non-empty strings"
                    )
                if m in self._group_of:
                    raise PlanError(
                        f"node {m!r} appears in more than one group"
                    )
                self._group_of[m] = gi
            self.groups.append(tuple(members))
        try:
            self.p = float(spec.get("p", 0.5))
        except (TypeError, ValueError):
            raise PlanError("plan p must be a number") from None
        if not 0.0 <= self.p <= 1.0:
            raise PlanError("plan p must be in [0, 1]")
        node = spec.get("node")
        if node is not None and (not isinstance(node, str) or not node):
            raise PlanError("plan node must be a non-empty string")
        self.node = node
        addrs = spec.get("addrs") or {}
        if not isinstance(addrs, dict) or not all(
            isinstance(k, str) and isinstance(v, str)
            for k, v in addrs.items()
        ):
            raise PlanError("plan addrs must map 'host:port' -> node id")
        self.addrs = dict(addrs)
        # per-link flaky streams, created lazily; keyed (src, dst) so
        # each direction of a link draws its own deterministic sequence
        self._rngs: dict[tuple[str, str], random.Random] = {}
        self._lock = threading.Lock()

    def group_of(self, node: str) -> int | None:
        return self._group_of.get(node)

    def node_for(self, node=None, addr=None) -> str | None:
        """Resolve an endpoint to a node id: an explicit id wins, else
        the plan's address map; None when the plan cannot judge it."""
        if node:
            return node
        if addr is None:
            return None
        if isinstance(addr, (tuple, list)) and len(addr) >= 2:
            addr = f"{addr[0]}:{addr[1]}"
        mapped = self.addrs.get(addr)
        if mapped is not None:
            return mapped
        # a transport may know its remote only by an id the plan's
        # groups already name (deliver endpoint labels, unit tests)
        if addr in self._group_of:
            return addr
        return None

    def severed(self, src: str, dst: str) -> bool:
        """True when the plan DETERMINISTICALLY denies src -> dst
        (full/oneway cross-group links) — the predicate behind
        mid-stream cuts; flaky links are never severed outright."""
        gs, gd = self._group_of.get(src), self._group_of.get(dst)
        if gs is None or gd is None or gs == gd:
            return False
        if self.mode == "full":
            return True
        if self.mode == "oneway":
            return gs < gd
        return False

    def denies(self, src: str, dst: str) -> bool:
        """Decide one connect/accept attempt on the link src -> dst.
        Stateful for flaky mode (each attempt advances that link's
        seeded stream); pure for full/oneway."""
        gs, gd = self._group_of.get(src), self._group_of.get(dst)
        if gs is None or gd is None or gs == gd:
            return False
        if self.mode == "flaky":
            with self._lock:
                rng = self._rngs.get((src, dst))
                if rng is None:
                    rng = self._rngs[(src, dst)] = random.Random(
                        f"{self.seed}:{src}:{dst}"
                    )
                return rng.random() < self.p
        return self.severed(src, dst)

    def as_dict(self) -> dict:
        d = {
            "seed": self.seed,
            "label": self.label,
            "mode": self.mode,
            "groups": [list(g) for g in self.groups],
            "p": self.p,
        }
        if self.node is not None:
            d["node"] = self.node
        if self.addrs:
            d["addrs"] = dict(sorted(self.addrs.items()))
        return d


# -- the policy checks --------------------------------------------------------


def _judge(p: Plan, src, src_addr, dst, dst_addr, direction: str) -> None:
    _lookups[0] += 1
    s = p.node_for(src, src_addr)
    d = p.node_for(dst, dst_addr)
    if s is None or d is None:
        return
    if not p.denies(s, d):
        return
    rec = {
        "plan": p.label, "src": s, "dst": d,
        "mode": p.mode, "direction": direction,
    }
    with _log_lock:
        _denials.append(rec)
    # a faultline seam on the denial path (lazy import keeps netsplit
    # importable first, like tracing's)
    from fabric_tpu_torch.devtools import faultline

    faultline.point("netsplit.deny", src=s, dst=d, mode=p.mode)
    raise NetsplitDenied(
        f"netsplit: {direction} {s} -> {d} denied by {p.label} "
        f"(mode={p.mode})"
    )


def connect(dst: str | None = None, *, addr=None) -> None:
    """Outbound policy check (local node -> dst).  No plan armed: a
    global load + None test.  Armed and the link is cross-group:
    raises :class:`NetsplitDenied` before any socket is opened."""
    p = _plan
    if p is None:
        return
    local = p.node if p.node is not None else _local_node
    _judge(p, local, None, dst, addr, "connect")


def accept(src: str | None = None, *, addr=None) -> None:
    """Inbound policy check (src -> local node), consulted at accept
    time or right after a protocol handshake reveals the remote's
    identity.  Same fast path and denial semantics as
    :func:`connect`."""
    p = _plan
    if p is None:
        return
    local = p.node if p.node is not None else _local_node
    _judge(p, src, addr, local, None, "accept")


# -- mid-stream cut -----------------------------------------------------------


def track(sock, *, peer: str | None = None, addr=None) -> int:
    """Register a long-lived connection for mid-stream cut, tagged
    with whatever remote identity the transport has (a node id after
    a handshake, else the remote listener address).  Returns a token
    for :func:`untrack`.  Cheap and unconditional — a dict insert —
    because the plan may arrive AFTER the connection is up."""
    with _conns_lock:
        _next_token[0] += 1
        tok = _next_token[0]
        _conns[tok] = (sock, peer, addr)
    return tok


def untrack(token: int) -> None:
    with _conns_lock:
        _conns.pop(token, None)


def _cut_severed(p: Plan) -> None:
    """Close every tracked connection whose link the (full/oneway)
    plan severs — in either direction: a TCP stream closed by one end
    is dead for both, and a half-open pipe across a partition is
    exactly the pathology this models."""
    if p.mode == "flaky":
        return
    local = p.node if p.node is not None else _local_node
    if local is None:
        return
    with _conns_lock:
        live = list(_conns.items())
    from fabric_tpu_torch.devtools import faultline

    for tok, (sock, peer, addr) in live:
        remote = p.node_for(peer, addr)
        if remote is None:
            continue
        if not (p.severed(local, remote) or p.severed(remote, local)):
            continue
        with _log_lock:
            _cuts.append({"plan": p.label, "src": local, "dst": remote})
        try:
            faultline.point("netsplit.cut", src=local, dst=remote)
        except OSError:
            pass  # an injected fault on the cut seam must not save
            # the connection — the cut still happens
        try:
            sock.close()
        except OSError:
            pass
        untrack(tok)


# -- plan lifecycle -----------------------------------------------------------


def active() -> bool:
    return _plan is not None


def current_plan():
    return _plan


def lookup_count() -> int:
    """Total policy consultations so far — provably 0 while no plan
    has ever been armed (the zero-overhead acceptance probe)."""
    return _lookups[0]


def set_local_node(name: str | None) -> None:
    """Pin this process's node id.  A plan-carried ``node`` field
    still wins."""
    global _local_node
    _local_node = name


def local_node() -> str | None:
    return _local_node


def denial_log() -> list[dict]:
    with _log_lock:
        return [dict(d) for d in _denials]


def cut_log() -> list[dict]:
    with _log_lock:
        return [dict(c) for c in _cuts]


def reset_log() -> None:
    with _log_lock:
        _denials.clear()
        _cuts.clear()


def activate(plan) -> Plan:
    """Arm a plan (dict, JSON string, or Plan), replacing any armed
    one, and cut established connections on severed links."""
    p = plan if isinstance(plan, Plan) else Plan(plan)
    global _plan
    with _state_lock:
        _plan = p
    _cut_severed(p)
    return p


def deactivate() -> None:
    """Heal: disarm the plan.  Cut connections stay cut — their
    owners' reconnect paths re-dial through the (now permissive)
    seam."""
    global _plan
    with _state_lock:
        _plan = None


@contextlib.contextmanager
def use_plan(plan):
    """Arm a plan for a scope; restore whatever was armed before on
    exit (nesting: the inner plan wins for the scope, faultline
    use_plan semantics)."""
    p = plan if isinstance(plan, Plan) else Plan(plan)
    with _state_lock:
        global _plan
        outer, _plan = _plan, p
    _cut_severed(p)
    try:
        yield p
    finally:
        with _state_lock:
            _plan = outer


# the plan _init_from_env armed, if any — consumers key off THIS, not
# a re-parse of the environment
_env_plan: Plan | None = None


def session_env_plan() -> Plan | None:
    """The plan the environment armed at import, if any."""
    return _env_plan


def _init_from_env() -> None:
    global _env_plan
    raw = knob_registry.raw(_ENV)
    if raw and raw not in ("0", "false", "off"):
        if raw.startswith("@"):
            with open(raw[1:], "r", encoding="utf-8") as f:
                raw = f.read()
        _env_plan = activate(raw)


_init_from_env()


__all__ = [
    "PlanError",
    "NetsplitDenied",
    "Plan",
    "connect",
    "accept",
    "track",
    "untrack",
    "active",
    "current_plan",
    "lookup_count",
    "set_local_node",
    "local_node",
    "denial_log",
    "cut_log",
    "reset_log",
    "activate",
    "deactivate",
    "use_plan",
    "session_env_plan",
]
