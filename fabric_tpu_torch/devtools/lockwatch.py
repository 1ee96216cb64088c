"""Runtime lock-order and thread-lifecycle watchdog.

The port's copy of the JAX package's `fabric_tpu/devtools/lockwatch.py`.
Code creates its coordination locks through ``named_lock`` /
``named_rlock`` / ``named_condition``, which return plain ``threading``
objects normally (no overhead) and instrumented wrappers when
``FABRIC_TPU_LOCKWATCH`` is set.  The wrapper keeps a process-wide
acquisition-order graph over lock ROLES (names, not instances):
acquiring B while holding A records the edge ``A -> B``; if a path
``B -> ... -> A`` already exists, the acquisition is a deadlock-capable
inversion, recorded in ``violations`` and raised as ``LockOrderError``.
Mode ``record`` only observes and does not perturb the program.
Re-entrant acquisition of the same lock object is fine (RLock
semantics); two INSTANCES sharing a role name are not ordered against
each other.  Cross-thread release of a watched plain Lock raises in the
default mode, so the held-stack bookkeeping never silently rots.
``guarded(obj, field, by=role)`` asserts, under the watch, that the
calling thread holds a lock of that role.

THREADWATCH (the thread-lifecycle half): workers are created through
``spawn_thread`` / ``spawn_timer`` / ``tracked_executor``.  Normally they
are plain ``threading`` objects.  Under ``FABRIC_TPU_THREADWATCH`` each
thread registers in a process-wide live registry when started, records
any unhandled exception into ``thread_violations`` and deregisters on
exit; ``drain_threads`` joins live registered threads against a
deadline and records stragglers.  A test suite that asserts both
ledgers empty at its end turns a leaked worker or a lock inversion into
a deterministic failure.  Threads register with a ``kind``: ``"worker"``
for bounded jobs that must be gone once their owner drains (flush
waiters, snapshot exports, stream committers) and ``"service"`` for
run-until-stopped loops (acceptors); ``drain_threads`` drains workers by
default.

CONDITION ORDERING: ``named_condition`` wraps a condition variable in
the same order graph.  ``wait()`` while holding a lock that is an
order-PREDECESSOR of the condition's own lock is flagged: the wait
releases only the condition's lock, so a waker that follows the
canonical order blocks on the held predecessor and the wait never ends.

Under ``FABRIC_TPU_PROFILE`` (without the watch) named locks time their
contention for `common.profile`, which is bound lazily: it imports
``spawn_thread`` from here.
"""

from __future__ import annotations

import os
import sys
import threading
import time

from fabric_tpu_torch.devtools import knob_registry

_ENV = "FABRIC_TPU_LOCKWATCH"
_PROFILE_ENV = "FABRIC_TPU_PROFILE"
_PROFILE_FALSY = ("", "0", "false", "off", "no")

# guards the graph + violations; a plain lock that is itself never
# watched, held only for short pure-python critical sections
_state_lock = threading.Lock()
_edges: dict[str, set[str]] = {}
violations: list[dict] = []
_tls = threading.local()


class LockOrderError(RuntimeError):
    """A lock acquisition that closes a cycle in the order graph."""


def enabled() -> bool:
    return knob_registry.raw(_ENV) not in ("", "0", "false", "off")


def _raise_mode() -> bool:
    return knob_registry.raw(_ENV) != "record"


_profmod = None


def _profile_mod():
    """profscope, bound lazily — profile imports spawn_thread from
    this module, so a top-level import would be circular (the
    _trace_note pattern)."""
    global _profmod
    if _profmod is None:
        from fabric_tpu_torch.common import profile

        _profmod = profile
    return _profmod


def _profile_on() -> bool:
    """Is profscope armed (or about to be, via its env knob)?  Checked
    at lock CREATION only; never imports profile on the disarmed
    path."""
    mod = sys.modules.get("fabric_tpu_torch.common.profile")
    if mod is not None:
        try:
            return bool(mod.enabled())
        except Exception:
            return False
    raw = knob_registry.raw(_PROFILE_ENV)
    return raw.strip().lower() not in _PROFILE_FALSY


def _trace_note(kind: str, event: dict) -> None:
    """Mirror a recorded violation into the tracelens flight recorder
    (an instant mark on the active span), so a trace dump shows the
    sanitizer finding in causal context next to the spans that led to
    it.  No-op unless tracing is armed."""
    from fabric_tpu_torch.common import tracing

    if tracing.enabled():
        tracing.instant(kind, **{k: str(v) for k, v in event.items()})


def reset() -> None:
    """Clear the graph and recorded violations (tests)."""
    with _state_lock:
        _edges.clear()
        violations.clear()


def edges() -> dict[str, set[str]]:
    """Snapshot of the acquisition-order graph (tests/diagnostics)."""
    with _state_lock:
        return {k: set(v) for k, v in _edges.items()}


def _held():
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []  # [[WatchedLock, count], ...]
    return st


def _find_path(src: str, dst: str) -> list[str] | None:
    """DFS path src -> dst over _edges (caller holds _state_lock)."""
    stack = [(src, [src])]
    seen = {src}
    while stack:
        node, path = stack.pop()
        if node == dst:
            return path
        for nxt in _edges.get(node, ()):
            if nxt not in seen:
                seen.add(nxt)
                stack.append((nxt, path + [nxt]))
    return None


class WatchedLock:
    """Lock wrapper that feeds the acquisition-order graph.  Wraps a
    Lock or RLock; re-entrancy is tracked by object identity so RLock
    recursion never reports against itself."""

    def __init__(self, name: str, factory=threading.Lock):
        self.name = name
        self._reentrant = factory is threading.RLock
        self._inner = factory()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        st = _held()
        for entry in st:
            if entry[0] is self:
                if not self._reentrant and blocking:
                    # a blocking re-acquire of a plain Lock the SAME
                    # thread already holds can never succeed — diagnose
                    # the self-deadlock instead of wedging inside the
                    # watchdog (a non-blocking try just returns False)
                    bad = {
                        "acquiring": self.name,
                        "holding": self.name,
                        "cycle": [self.name, self.name],
                        "thread": threading.current_thread().name,
                    }
                    with _state_lock:
                        violations.append(bad)
                        _trace_note("lockwatch.violation", bad)
                    if _raise_mode():
                        raise LockOrderError(
                            "self-deadlock: blocking re-acquire of "
                            f"non-reentrant lock {self.name!r}"
                        )
                # re-entrant: same object, no new edge (RLock recursion)
                got = self._inner.acquire(blocking, timeout)
                if got:
                    entry[1] += 1
                return got
        # Check/record ordering BEFORE the (possibly blocking) inner
        # acquire: in a live contended inversion both threads would
        # otherwise sit inside _inner.acquire() forever and the cycle
        # would never be observed — the watchdog must raise instead of
        # inheriting the deadlock it exists to diagnose.  Only an
        # INDEFINITE blocking acquire can wedge forever, so only it
        # pre-records; a try-lock or timed wait records its edges after
        # success — a failed attempt must not poison the graph with an
        # ordering that was never actually held.
        record_now = blocking and timeout == -1
        bad = None
        with _state_lock:
            pending = []
            for held_entry in st:
                h = held_entry[0].name
                if h == self.name:
                    # same ROLE, different instance: role-level ordering
                    # cannot rank an instance against itself; skip
                    continue
                path = _find_path(self.name, h)
                if path is not None:
                    bad = {
                        "acquiring": self.name,
                        "holding": h,
                        "cycle": path + [self.name],
                        "thread": threading.current_thread().name,
                    }
                    violations.append(bad)
                    _trace_note("lockwatch.violation", bad)
                    break
                pending.append(h)
            if bad is None and record_now:
                # commit edges only for an acquisition that will really
                # be attempted — a REFUSED acquisition must not leave
                # partial edges from the held locks scanned before the
                # violating one
                for h in pending:
                    _edges.setdefault(h, set()).add(self.name)
        if bad is not None and _raise_mode():
            raise LockOrderError(
                "lock-order inversion: acquiring "
                f"{bad['acquiring']!r} while holding {bad['holding']!r} "
                f"(established order: {' -> '.join(bad['cycle'])})"
            )
        # profscope contention timing: wall time blocked inside the
        # inner acquire (the wait), plus an acquire timestamp on the
        # held-stack entry so _record_release can report hold time.
        # One enabled() check per acquire when profiling is disarmed.
        prof = _profile_mod() if _profile_on() else None
        if prof is not None and prof.enabled():
            t0 = time.monotonic()
            got = self._inner.acquire(blocking, timeout)
            t1 = time.monotonic()
            if got:
                prof.note_lock_wait(self.name, t1 - t0)
                st.append([self, 1, t1])
        else:
            got = self._inner.acquire(blocking, timeout)
            if got:
                st.append([self, 1])
        if got and not record_now:
            with _state_lock:
                for held_entry in st[:-1]:
                    if held_entry[0].name != self.name:
                        _edges.setdefault(
                            held_entry[0].name, set()
                        ).add(self.name)
        return got

    def release(self) -> None:
        if not self._record_release():
            # threading.Lock legally allows cross-thread release
            # (handoff), but under watch the acquirer's held-stack
            # would keep this lock forever and later acquisitions
            # would record bogus edges
            bad = {
                "event": "cross-thread-release",
                "lock": self.name,
                "thread": threading.current_thread().name,
            }
            with _state_lock:
                violations.append(bad)
                _trace_note("lockwatch.violation", bad)
            if _raise_mode():
                # refuse deterministically (inner stays held: the
                # pattern is unsupported and the test run must fail
                # here, not on a later bogus-edge inversion)
                raise LockOrderError(
                    f"cross-thread release of watched lock {self.name!r} "
                    "(acquired on a different thread); handoff patterns "
                    "are unsupported under FABRIC_TPU_LOCKWATCH"
                )
            # record mode observes without perturbing: perform the
            # legal handoff (the acquirer's stale stack entry is a
            # documented best-effort gap of observe-only mode)
        self._inner.release()

    def __enter__(self) -> "WatchedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> bool:
        self.release()
        return False

    def __repr__(self) -> str:
        return f"<WatchedLock {self.name!r}>"

    def _record_release(self) -> bool:
        """Pop this lock from the current thread's held-stack; False if
        it was not acquired on this thread (cross-thread release).
        Entries carrying an acquire timestamp (profiling was armed at
        acquire) report hold time on the final release."""
        st = _held()
        for i in range(len(st) - 1, -1, -1):
            entry = st[i]
            if entry[0] is self:
                entry[1] -= 1
                if entry[1] == 0:
                    del st[i]
                    if len(entry) == 3:
                        prof = _profile_mod()
                        if prof.enabled():
                            prof.note_lock_hold(
                                self.name, time.monotonic() - entry[2]
                            )
                return True
        return False


def guarded(obj, field: str, *, by: str) -> None:
    """Runtime guard assertion: code states, at an access site, which
    lock ROLE guards ``obj.field``.  A no-op unless FABRIC_TPU_LOCKWATCH
    is set; then the calling thread must hold a watched lock with that
    role, or the violation lands in ``violations`` beside lock
    inversions."""
    if not enabled():
        return
    for entry in _held():
        if entry[0].name == by:
            return
    bad = {
        "event": "unguarded-access",
        "object": type(obj).__name__,
        "field": field,
        "required": by,
        "thread": threading.current_thread().name,
    }
    with _state_lock:
        violations.append(bad)
        _trace_note("lockwatch.violation", bad)
    if _raise_mode():
        raise LockOrderError(
            f"unguarded access: {type(obj).__name__}.{field} requires "
            f"lock role {by!r}, which this thread does not hold"
        )


class _ProfiledLock:
    """Plain lock plus profscope contention timing — what named_lock
    returns when profiling is armed but lockwatch is off (production
    profiling runs), so ``lock_wait_seconds{role}`` exists without the
    order-graph overhead.  Per-thread acquire timestamps live in
    ``_tacq`` keyed by thread ident; each thread only ever touches its
    own key, and it does so while HOLDING the inner lock."""

    __slots__ = ("name", "_inner", "_tacq")

    def __init__(self, name: str, factory=threading.Lock):
        self.name = name
        self._inner = factory()
        self._tacq: dict[int, list] = {}

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        prof = _profile_mod()
        if not prof.enabled():
            return self._inner.acquire(blocking, timeout)
        t0 = time.monotonic()
        got = self._inner.acquire(blocking, timeout)
        if got:
            t1 = time.monotonic()
            prof.note_lock_wait(self.name, t1 - t0)
            self._tacq.setdefault(
                threading.get_ident(), []
            ).append(t1)
        return got

    def release(self) -> None:
        ident = threading.get_ident()
        stack = self._tacq.get(ident)
        if stack:
            t1 = stack.pop()
            if not stack:
                self._tacq.pop(ident, None)
            prof = _profile_mod()
            if prof.enabled():
                prof.note_lock_hold(
                    self.name, time.monotonic() - t1
                )
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self) -> "_ProfiledLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> bool:
        self.release()
        return False

    def __repr__(self) -> str:
        return f"<_ProfiledLock {self.name!r}>"


def named_lock(name: str):
    """A threading.Lock, watched when FABRIC_TPU_LOCKWATCH is set;
    contention-timed (wrapper only, no order graph) when profscope is
    armed without lockwatch."""
    if enabled():
        return WatchedLock(name, threading.Lock)
    if _profile_on():
        return _ProfiledLock(name, threading.Lock)
    return threading.Lock()


def named_rlock(name: str):
    """A threading.RLock, watched when FABRIC_TPU_LOCKWATCH is set;
    contention-timed when profscope is armed without lockwatch."""
    if enabled():
        return WatchedLock(name, threading.RLock)
    if _profile_on():
        return _ProfiledLock(name, threading.RLock)
    return threading.RLock()


# -- condition-variable wait ordering ----------------------------------------


class WatchedCondition:
    """Condition variable whose wait() participates in the order graph.

    Composed of a WatchedLock (enter/exit bookkeeping feeds the same
    acquisition-order edges as any lock) and a plain Condition sharing
    the SAME underlying lock object.  ``wait()`` first checks the
    thread's held-stack: holding any lock with an established path TO
    this condition's role is a deadlock-capable wait (the waker follows
    the canonical order, blocks on the held predecessor, and the notify
    never comes) — recorded and raised like a lock inversion.  During
    the wait the condition's own entry leaves the held-stack (the wait
    releases the lock) and returns afterwards."""

    def __init__(self, name: str, factory=threading.RLock):
        self.name = name
        self._wlock = WatchedLock(name, factory)
        self._cond = threading.Condition(self._wlock._inner)

    def acquire(self, *a, **k):
        return self._wlock.acquire(*a, **k)

    def release(self):
        self._wlock.release()

    def __enter__(self) -> "WatchedCondition":
        self._wlock.acquire()
        return self

    def __exit__(self, *exc) -> bool:
        self._wlock.release()
        return False

    def wait(self, timeout: float | None = None) -> bool:
        st = _held()
        bad = None
        with _state_lock:
            for held_entry in st:
                held = held_entry[0]
                if held is self._wlock or held.name == self.name:
                    continue
                path = _find_path(held.name, self.name)
                if path is not None:
                    bad = {
                        "event": "wait-while-holding-predecessor",
                        "condition": self.name,
                        "holding": held.name,
                        "cycle": path + [self.name],
                        "thread": threading.current_thread().name,
                    }
                    violations.append(bad)
                    _trace_note("lockwatch.violation", bad)
                    break
        if bad is not None and _raise_mode():
            raise LockOrderError(
                f"wait on condition {self.name!r} while holding its "
                f"order-predecessor {bad['holding']!r} (established "
                f"order: {' -> '.join(bad['cycle'])}); the waker cannot "
                "reach notify without the held lock"
            )
        entry = None
        for i in range(len(st) - 1, -1, -1):
            if st[i][0] is self._wlock:
                entry = st.pop(i)
                break
        try:
            return self._cond.wait(timeout)
        finally:
            if entry is not None:
                st.append(entry)

    def wait_for(self, predicate, timeout: float | None = None):
        import time as _time

        endtime = None
        result = predicate()
        while not result:
            if timeout is not None:
                if endtime is None:
                    endtime = _time.monotonic() + timeout
                waittime = endtime - _time.monotonic()
                if waittime <= 0:
                    break
                self.wait(waittime)
            else:
                self.wait()
            result = predicate()
        return result

    def notify(self, n: int = 1) -> None:
        self._cond.notify(n)

    def notify_all(self) -> None:
        self._cond.notify_all()

    def __repr__(self) -> str:
        return f"<WatchedCondition {self.name!r}>"


def named_condition(name: str, factory=threading.RLock):
    """A threading.Condition, wait-order-watched when
    FABRIC_TPU_LOCKWATCH is set."""
    if enabled():
        return WatchedCondition(name, factory)
    return threading.Condition(factory())


# -- threadwatch: thread-lifecycle registry ----------------------------------

_THREAD_ENV = "FABRIC_TPU_THREADWATCH"

_threads_lock = threading.Lock()
_live_threads: dict[int, dict] = {}  # id(thread) -> info
thread_violations: list[dict] = []


def threads_enabled() -> bool:
    return knob_registry.raw(_THREAD_ENV) not in ("", "0", "false", "off")


def reset_threads() -> None:
    """Clear recorded thread violations (tests).  The live registry is
    left alone — threads that exist keep existing."""
    with _threads_lock:
        thread_violations.clear()


def threads_alive(kinds=None) -> list[dict]:
    """Snapshot of live registered threads (name/kind/thread).  Entries
    whose thread ran and finished without the wrapper's deregistration
    (a timer cancelled after start: its callback — and thus the
    wrapper — never executes) are pruned here; entries registered but
    not yet scheduled (ident is None) are kept, which is the whole
    point of registering before start()."""
    with _threads_lock:
        dead = [
            key for key, info in _live_threads.items()
            if not info["thread"].is_alive()
            and info["thread"].ident is not None
        ]
        for key in dead:
            del _live_threads[key]
        return [
            dict(info) for info in _live_threads.values()
            if kinds is None or info["kind"] in kinds
        ]


def _register(t, kind: str) -> None:
    with _threads_lock:
        _live_threads[id(t)] = {"name": t.name, "kind": kind, "thread": t}


def _deregister(t) -> None:
    with _threads_lock:
        _live_threads.pop(id(t), None)


def _wrap_target(cell: dict, kind: str, target):
    """The shared watched-thread body: run the real target, record any
    unhandled exception into the ledger (a daemon worker dying silently
    is how green runs become teardown aborts), deregister on exit."""

    def run(*a, **k):
        t = cell["thread"]
        try:
            target(*a, **k)
        except BaseException as exc:
            with _threads_lock:
                bad = {
                    "event": "unhandled-exception",
                    "thread": t.name,
                    "kind": kind,
                    "error": repr(exc),
                }
                thread_violations.append(bad)
            _trace_note("threadwatch.violation", bad)
            raise
        finally:
            _deregister(t)

    return run


def _registering_start(t, super_start) -> None:
    """start() that registers BEFORE the OS thread exists, so a drain
    sweep can never miss a started-but-not-yet-scheduled worker
    (registering inside the target would leave exactly that window).
    A double-start must not touch the registry: the rollback is only
    for a start() that registered THIS call — deregistering on the
    'already started' RuntimeError would erase the live thread's entry
    and hide it from the drain gate."""
    if t.ident is not None or t.is_alive():
        super_start()  # raises "threads can only be started once"
        return
    _register(t, t._tw_kind)
    try:
        super_start()
    except BaseException:
        _deregister(t)
        raise


class _WatchedThread(threading.Thread):
    _tw_kind = "worker"

    def start(self) -> None:
        _registering_start(self, super().start)


class _WatchedTimer(threading.Timer):
    _tw_kind = "service"

    def start(self) -> None:
        _registering_start(self, super().start)


def spawn_thread(target, *, name: str | None = None, args=(),
                 kwargs=None, daemon: bool = True,
                 kind: str = "worker") -> threading.Thread:
    """Create (NOT start) a daemonized thread through the threadwatch
    seam.  Plain Thread normally; under
    FABRIC_TPU_THREADWATCH the thread registers in the live registry
    when ``start()`` is called (before the OS thread exists), records
    unhandled exceptions into ``thread_violations``, and deregisters on
    exit.

    kind="worker": a bounded job the owner must drain before exit
    (flush waiter, snapshot export, stream committer).
    kind="service": a run-until-stopped loop with its own stop/close
    path (acceptor, gossip, consensus); exempt from the default
    drain_threads sweep."""
    if kind not in ("worker", "service"):
        raise ValueError(f"unknown thread kind {kind!r}")
    kwargs = kwargs or {}
    if not threads_enabled():
        return threading.Thread(
            target=target, name=name, args=args, kwargs=kwargs,
            daemon=daemon,
        )
    cell: dict = {}
    run = _wrap_target(cell, kind, target)
    t = _WatchedThread(
        target=run, name=name, args=args, kwargs=kwargs, daemon=daemon
    )
    t._tw_kind = kind
    cell["thread"] = t
    return t


def spawn_timer(interval: float, function, *, name: str | None = None,
                args=(), kwargs=None,
                kind: str = "service") -> threading.Timer:
    """threading.Timer through the threadwatch seam (daemonized).  A
    timer cancelled after start() skips its callback, so the wrapper's
    deregistration never runs — the registry prunes such dead entries
    on every read (threads_alive), which is exactly the drain
    semantics a cancel-on-halt timer needs."""
    if kind not in ("worker", "service"):
        raise ValueError(f"unknown thread kind {kind!r}")
    kwargs = kwargs or {}
    if not threads_enabled():
        t = threading.Timer(interval, function, args=args, kwargs=kwargs)
        t.daemon = True
        if name:
            t.name = name
        return t
    cell: dict = {}
    run = _wrap_target(cell, kind, function)
    t = _WatchedTimer(interval, run, args=args, kwargs=kwargs)
    t._tw_kind = kind
    t.daemon = True
    if name:
        t.name = name
    cell["thread"] = t
    return t


def tracked_executor(max_workers=None, *, name: str = "executor",
                     kind: str = "worker", initializer=None,
                     initargs=()):
    """A ``concurrent.futures.ThreadPoolExecutor`` through the
    threadwatch seam.  Pool workers are invisible to the session-end
    drain gate when created raw — they are plain threads spawned deep
    inside the executor — so a leaked executor (nobody called
    ``shutdown``) keeps live threads past the tests without anything
    noticing.  Under FABRIC_TPU_THREADWATCH each pool worker registers
    itself (via the executor's initializer hook) in the same live
    registry as spawn_thread workers: the drain gate then joins them,
    and an executor whose owner never shut it down fails the session
    deterministically.  Registry entries of exited workers are pruned
    on read (threads_alive), so a properly shut-down pool leaves no
    residue.  Without threadwatch this returns a plain executor —
    zero overhead."""
    from concurrent.futures import ThreadPoolExecutor

    if kind not in ("worker", "service"):
        raise ValueError(f"unknown thread kind {kind!r}")
    if not threads_enabled():
        return ThreadPoolExecutor(
            max_workers, thread_name_prefix=name,
            initializer=initializer, initargs=initargs,
        )

    def _register_worker(*args):
        _register(threading.current_thread(), kind)
        if initializer is not None:
            initializer(*args)

    return ThreadPoolExecutor(
        max_workers, thread_name_prefix=name,
        initializer=_register_worker, initargs=initargs,
    )


def drain_threads(timeout: float = 10.0, kinds=("worker",)) -> list[str]:
    """Join every live registered thread of the given kinds against one
    shared deadline.  Stragglers are recorded in ``thread_violations``
    (event "drain-timeout") and returned — the session-end gate turns
    them into failures, because a worker still running at interpreter
    exit is precisely the thread the runtime kills mid-kernel."""
    import time as _time

    deadline = _time.monotonic() + timeout
    stragglers: list[str] = []
    for info in threads_alive(kinds):
        t = info["thread"]
        remaining = deadline - _time.monotonic()
        if remaining > 0:
            try:
                t.join(remaining)
            except RuntimeError:
                # registered but its start() is still in flight on the
                # owning thread (registration happens-before start);
                # give the bootstrap a beat and fall through to the
                # is_alive check
                _time.sleep(0.01)
        if t.is_alive():
            stragglers.append(info["name"])
            with _threads_lock:
                thread_violations.append({
                    "event": "drain-timeout",
                    "thread": info["name"],
                    "kind": info["kind"],
                    "timeout": timeout,
                })
    return stragglers


__all__ = [
    "LockOrderError",
    "WatchedLock",
    "WatchedCondition",
    "named_lock",
    "named_rlock",
    "named_condition",
    "guarded",
    "enabled",
    "reset",
    "edges",
    "violations",
    "spawn_thread",
    "spawn_timer",
    "tracked_executor",
    "threads_enabled",
    "threads_alive",
    "thread_violations",
    "reset_threads",
    "drain_threads",
]
