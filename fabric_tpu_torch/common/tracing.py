"""tracelens: end-to-end span tracing that costs nothing when disarmed.

The port's copy of the JAX package's `fabric_tpu/common/tracing.py`,
with the same span names, attributes, wire token and export format, so
that a trace reads the same from either package.  The stage histograms
say how long a stage takes in aggregate; spans say which stage sat on
the CRITICAL PATH of one block (:func:`critical_path_ms`), whether
``verify_wait`` overlapped the device dispatch, and what the pipeline
did just before a failure.

- :func:`span`/:func:`begin` are a module-global load and an ``is
  None`` test when ``FABRIC_TPU_TRACE`` is unset: they return one
  shared no-op object, allocate nothing, and no ring buffer exists.
  Traced and untraced commits are byte-identical (spans only observe
  timing).
- Armed, every finished span lands in a process-wide bounded
  ring-buffer **flight recorder** (old spans fall off).
- Span and trace ids come from a seeded process counter and timestamps
  from the ``clockskew`` provider, so virtual-clock runs produce
  identical traces.
- Trace context crosses async hops explicitly: :func:`wire_token` /
  :func:`from_wire` carry it inside RPC frames, :func:`current` +
  :func:`attached` carry it onto committer and workpool threads.

Export is Chrome trace-event JSON (``chrome://tracing`` and Perfetto
load it directly).
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import threading

from fabric_tpu_torch.devtools import clockskew, knob_registry

_ENV = "FABRIC_TPU_TRACE"
_FALSY = ("", "0", "false", "off", "no")

DEFAULT_CAPACITY = 8192


class SpanContext:
    """The carryable half of a span: (trace_id, span_id).  This is what
    crosses threads and wires — never the Span object itself."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: int, span_id: int):
        self.trace_id = trace_id
        self.span_id = span_id

    def __repr__(self) -> str:
        return f"SpanContext({self.trace_id:x}.{self.span_id:x})"

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, SpanContext)
            and other.trace_id == self.trace_id
            and other.span_id == self.span_id
        )

    def __hash__(self) -> int:
        return hash((self.trace_id, self.span_id))


class FlightRecorder:
    """Process-wide bounded ring buffer of finished span / instant
    events (Chrome trace-event dicts).  Old events fall off the front —
    the recorder answers "what was the pipeline doing just now", like a
    cockpit flight recorder, not "everything since boot"."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self.capacity = int(capacity)
        self._buf: collections.deque = collections.deque(
            maxlen=self.capacity
        )
        self._lock = threading.Lock()
        # monotonically increasing per-event cursor: `GET
        # /traces?since=<id>` streams only what landed after a previous
        # poll
        self._seq = 0

    def record(self, event: dict) -> None:
        with self._lock:
            self._seq += 1
            event["id"] = self._seq
            self._buf.append(event)

    def snapshot(self, since: int | None = None) -> list[dict]:
        with self._lock:
            if since is None:
                return list(self._buf)
            return [ev for ev in self._buf if ev.get("id", 0) > since]

    def snapshot_with_cursor(
        self, since: int | None = None
    ) -> tuple[list[dict], int]:
        """(events after ``since``, cursor) taken under ONE lock — a
        cursor read after a separate snapshot() would advertise events
        recorded in between without containing them, and an incremental
        poller would skip them forever.  A ``since`` AHEAD of the
        current cursor means the recorder was cleared since the caller
        last polled: the stale cursor is invalid, so the full buffer is
        returned and the caller resyncs on the fresh cursor."""
        with self._lock:
            if since is not None and since > self._seq:
                since = None  # stale cursor from before a clear()
            events = (
                list(self._buf) if since is None
                else [ev for ev in self._buf if ev.get("id", 0) > since]
            )
            return events, self._seq

    @property
    def last_event_id(self) -> int:
        with self._lock:
            return self._seq

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()
            self._seq = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._buf)


# the armed recorder; None = tracing disarmed.  EVERY entry point's
# fast path tests only this global (the faultline `_plan` pattern).
_recorder: FlightRecorder | None = None
_state_lock = threading.Lock()

# deterministic id source: a plain counter, reset by reset_ids() so a
# chaos campaign's per-plan traces replay to identical sequences
_ids = [0]
_ids_lock = threading.Lock()

# armed-path consultations — stays 0 while tracing has never been
# armed, which is the zero-overhead acceptance probe
_lookups = [0]

_tls = threading.local()  # .stack: list[Span | _Remote]

# Cross-thread view of the per-thread span stacks, keyed by thread
# ident: the SAME list objects as _tls.stack, so the profscope sampler
# can read another thread's innermost span under the GIL without that
# thread's cooperation.  Only ever populated from _stack(), which runs
# exclusively on armed paths — the disarmed zero-overhead pin holds.
_stacks_by_thread: dict[int, list] = {}


def _stack() -> list:
    s = getattr(_tls, "stack", None)
    if s is None:
        s = _tls.stack = []
        _stacks_by_thread[threading.get_ident()] = s
    return s


def active_span_of(tid: int) -> "Span | None":
    """Innermost live span on thread ``tid``, or None.  A cross-thread
    read for samplers: list snapshot + attribute reads are GIL-atomic,
    and a span that ended between reads reports ``_ended`` and is
    skipped — worst case a sample lands on the parent span, never on a
    corrupt one."""
    stack = _stacks_by_thread.get(tid)
    if not stack:
        return None
    for item in reversed(list(stack)):
        if isinstance(item, Span) and not item._ended:
            return item
    return None


def _next_id() -> int:
    with _ids_lock:
        _ids[0] += 1
        return _ids[0]


class _Remote:
    """Stack marker for a context attached from another thread/process
    hop: parents spans opened in this scope without being a span."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, ctx: SpanContext):
        self.trace_id = ctx.trace_id
        self.span_id = ctx.span_id


class Span:
    """A live span.  Use as a context manager (exception-safe) or via
    explicit :meth:`end`.  ``end`` repairs the thread-local stack: any
    child a crash left open is closed at the same instant and marked
    ``abandoned`` so an injected FaultCrash mid-stage cannot corrupt
    later spans' parenting."""

    __slots__ = (
        "name", "trace_id", "span_id", "parent_id", "attrs", "cat",
        "start", "_tid", "_detached", "_ended",
    )

    def __init__(self, name: str, trace_id: int, span_id: int,
                 parent_id: int | None, cat: str, attrs: dict,
                 detached: bool):
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.cat = cat
        self.attrs = attrs
        self.start = clockskew.monotonic()
        self._tid = threading.current_thread().name
        self._detached = detached
        self._ended = False

    @property
    def ctx(self) -> SpanContext:
        return SpanContext(self.trace_id, self.span_id)

    def annotate(self, **attrs) -> None:
        self.attrs.update(attrs)

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc) -> bool:
        self.end()
        return False

    def end(self) -> None:
        if self._ended:
            return
        rec = _recorder
        end_ts = clockskew.monotonic()
        if not self._detached:
            stack = _stack()
            # repair: close any child an exception left open above us
            while stack:
                top = stack.pop()
                if top is self:
                    break
                if isinstance(top, Span) and not top._ended:
                    top._ended = True
                    top.attrs["abandoned"] = True
                    if rec is not None:
                        rec.record(top._event(end_ts))
        self._ended = True
        if rec is not None:
            rec.record(self._event(end_ts))

    def _event(self, end_ts: float) -> dict:
        args = {
            "trace": f"{self.trace_id:x}",
            "span": f"{self.span_id:x}",
        }
        if self.parent_id is not None:
            args["parent"] = f"{self.parent_id:x}"
        args.update(self.attrs)
        # round, not truncate: 0.01s on a virtual clock must be exactly
        # 10000µs, or determinism tests chase float dust
        ts = round(self.start * 1e6)
        return {
            "ph": "X",
            "name": self.name,
            "cat": self.cat,
            "ts": ts,
            "dur": max(0, round(end_ts * 1e6) - ts),
            "pid": 0,
            "tid": self._tid,
            "args": args,
        }


class _Noop:
    """The shared disarmed span/scope: every method is a no-op and
    every entry point returns THIS singleton — no allocation on the
    disarmed path."""

    __slots__ = ()
    ctx = None

    def __enter__(self) -> "_Noop":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def annotate(self, **attrs) -> None:
        pass

    def end(self) -> None:
        pass


_NOOP = _Noop()


# -- span entry points --------------------------------------------------------


def begin(name: str, parent: SpanContext | None = None,
          detach: bool = False, cat: str = "span", **attrs):
    """Open a span.  Disarmed: returns the shared no-op.  Armed: the
    parent is `parent` if given, else the innermost span/attached
    context on this thread; a parentless span roots a new trace.
    ``detach=True`` keeps the span OFF the thread-local stack (for
    per-block roots whose children start on other threads/iterations) —
    children then attach via ``attached(span.ctx)`` or ``parent=``."""
    if _recorder is None:
        return _NOOP
    _lookups[0] += 1
    parent_id = None
    trace_id = None
    if parent is not None:
        trace_id = parent.trace_id
        parent_id = parent.span_id
    else:
        stack = _stack()
        if stack:
            top = stack[-1]
            trace_id = top.trace_id
            parent_id = top.span_id
    span_id = _next_id()
    if trace_id is None:
        trace_id = span_id  # root: the trace is named after its root
    sp = Span(name, trace_id, span_id, parent_id, cat, attrs, detach)
    if not detach:
        _stack().append(sp)
    return sp


# `with tracing.span(...)` reads better at call sites; same function.
span = begin


def instant(name: str, **attrs) -> None:
    """Record a zero-duration marker event (faultline trips, lockwatch
    violations, chaos-oracle annotations) parented to the innermost
    active span.  Disarmed: a global load + None test."""
    rec = _recorder
    if rec is None:
        return
    _lookups[0] += 1
    args = dict(attrs)
    stack = _stack()
    if stack:
        top = stack[-1]
        args["trace"] = f"{top.trace_id:x}"
        args["parent"] = f"{top.span_id:x}"
    rec.record({
        "ph": "i",
        "name": name,
        "cat": "mark",
        "ts": round(clockskew.monotonic() * 1e6),
        "pid": 0,
        "tid": threading.current_thread().name,
        "s": "p",
        "args": args,
    })


def annotate(**attrs) -> None:
    """Merge attrs into the innermost active span (no-op when disarmed
    or no span is open)."""
    if _recorder is None:
        return
    stack = _stack()
    if stack and isinstance(stack[-1], Span):
        stack[-1].attrs.update(attrs)


def current() -> SpanContext | None:
    """The innermost active span context on this thread, carryable to
    another thread via :func:`attached`."""
    if _recorder is None:
        return None
    stack = _stack()
    if not stack:
        return None
    top = stack[-1]
    return SpanContext(top.trace_id, top.span_id)


class _Attach:
    __slots__ = ("_ctx",)

    def __init__(self, ctx: SpanContext):
        self._ctx = ctx

    def __enter__(self):
        _stack().append(_Remote(self._ctx))
        return self._ctx

    def __exit__(self, *exc) -> bool:
        stack = _stack()
        if stack:
            stack.pop()
        return False


def attached(ctx: SpanContext | None):
    """Adopt a context carried from another thread/hop for a scope:
    spans opened inside parent to it.  ``attached(None)`` (and the
    disarmed path) is the shared no-op."""
    if _recorder is None or ctx is None:
        return _NOOP
    return _Attach(ctx)


# -- wire propagation ---------------------------------------------------------


def wire_token() -> str | None:
    """The active context as a compact wire token (``trace.span`` hex),
    or None when tracing is disarmed / no span is active — callers emit
    byte-identical frames in that case."""
    ctx = current()
    if ctx is None:
        return None
    return f"{ctx.trace_id:x}.{ctx.span_id:x}"


def from_wire(token: str) -> SpanContext | None:
    """Parse a :func:`wire_token`; malformed tokens are None (a traced
    peer must never be able to crash an untraced server)."""
    try:
        t, _, s = token.partition(".")
        return SpanContext(int(t, 16), int(s, 16))
    except ValueError:
        return None


# Binary-frame piggyback (the gossip TCP transport; the RPC transport
# carries the same token inside its str method field): a traced sender
# prefixes the frame with b"\x01<token>\x01".  Serialized protobuf
# frames always start with a field-tag byte (never 0x01), so receivers
# can ALWAYS strip; untraced senders emit byte-identical frames.  Kept
# HERE beside wire_token/from_wire so the token format has one owner.
FRAME_MARK = b"\x01"


def frame_with_token(data: bytes, ctx: SpanContext | None) -> bytes:
    """Prefix a binary frame with the context's wire token (the frame
    unchanged when ``ctx`` is None — the untraced path)."""
    if ctx is None:
        return data
    token = f"{ctx.trace_id:x}.{ctx.span_id:x}"
    return FRAME_MARK + token.encode("ascii") + FRAME_MARK + data


def split_frame_token(frame: bytes) -> tuple[bytes, SpanContext | None]:
    """(payload, SpanContext | None) — strips the optional trace
    prefix; malformed prefixes fall back to the raw frame so a traced
    peer can never wedge an untraced server."""
    if not frame.startswith(FRAME_MARK):
        return frame, None
    end = frame.find(FRAME_MARK, 1)
    if end < 0:
        return frame, None
    try:
        token = frame[1:end].decode("ascii")
    except UnicodeDecodeError:
        return frame, None
    return frame[end + 1:], from_wire(token)


# -- lifecycle ----------------------------------------------------------------


def enabled() -> bool:
    return _recorder is not None


def recorder() -> FlightRecorder | None:
    return _recorder


def lookup_count() -> int:
    """Armed-path consultations so far — provably 0 while tracing has
    never been armed (the zero-overhead acceptance probe)."""
    return _lookups[0]


def arm(capacity: int = DEFAULT_CAPACITY) -> FlightRecorder:
    """Arm tracing process-wide (idempotent per capacity: re-arming
    replaces the recorder)."""
    global _recorder
    with _state_lock:
        _recorder = FlightRecorder(capacity)
        return _recorder


def disarm() -> None:
    global _recorder
    with _state_lock:
        _recorder = None


def reset_ids(start: int = 0) -> None:
    """Reset the deterministic id counter — a same-seed chaos plan run
    then replays to an identical span sequence."""
    with _ids_lock:
        _ids[0] = int(start)


def reset() -> None:
    """Clear the recorder and the id counter (armed runs that need
    per-pass / per-plan reproducible traces: bench passes, fuzz plans)."""
    rec = _recorder
    if rec is not None:
        rec.clear()
    reset_ids()


@contextlib.contextmanager
def scope(capacity: int = DEFAULT_CAPACITY):
    """Arm tracing for a lexical scope (tests), restoring the previous
    recorder — and the previous id counter — on exit, so a traced test
    leaves the disarmed world exactly as it found it."""
    global _recorder
    with _state_lock:
        prev, _recorder = _recorder, FlightRecorder(capacity)
    with _ids_lock:
        prev_ids = _ids[0]
        _ids[0] = 0
    try:
        yield _recorder
    finally:
        with _state_lock:
            _recorder = prev
        with _ids_lock:
            _ids[0] = prev_ids


# -- export -------------------------------------------------------------------


def export(rec: FlightRecorder | None = None,
           since: int | None = None) -> dict:
    """The flight recorder as a Chrome trace-event document
    (object form: chrome://tracing and Perfetto load it directly).
    ``since`` is an event-id cursor: only events recorded AFTER it are
    included, and ``otherData.last_event_id`` is the cursor for the
    next incremental poll (``GET /traces?since=``); a cursor from
    before a recorder reset is detected (it is ahead of the fresh
    cursor) and answered with the full buffer so the poller resyncs."""
    rec = rec if rec is not None else _recorder
    if rec is not None:
        events, cursor = rec.snapshot_with_cursor(since)
    else:
        events, cursor = [], 0
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "armed": _recorder is not None,
            "source": "fabric_tpu_torch.tracelens",
            "last_event_id": cursor,
        },
    }


def dump_doc(path: str, doc: dict) -> str:
    """Write an already-exported trace document as the canonical
    artifact format (one serialization owned here)."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")
        # the dump is usually written on the way down from a failure —
        # push it to the OS now so a crash right after still leaves a
        # complete artifact
        f.flush()
    return path


def dump_to(path: str, rec: FlightRecorder | None = None) -> str:
    """Write :func:`export` as JSON (the chaos-repro trace artifact)."""
    return dump_doc(path, export(rec))


def span_sequence(doc: dict) -> list[tuple]:
    """The determinism view of a trace: (name, trace, span, parent)
    per event in recorded order, timestamps stripped — what same-seed
    campaign runs must reproduce byte-identically."""
    out = []
    for ev in doc.get("traceEvents", []):
        args = ev.get("args", {})
        out.append((
            ev.get("name"), args.get("trace"), args.get("span"),
            args.get("parent"),
        ))
    return out


# -- critical path ------------------------------------------------------------


def critical_path_ms(events, group_attr: str = "block",
                     cat: str = "stage") -> dict[str, float]:
    """Per-stage critical-path milliseconds over `events` (Chrome
    trace dicts), grouped by the ``group_attr`` span attribute (one
    group per block).

    Within each group the chain is built backwards from the latest
    finisher: repeatedly take the span with the latest end among those
    starting before the cursor, attribute ``min(end, cursor) - start``
    to its stage, and move the cursor to its start.  Gaps (no span
    covering the cursor) are skipped.  The result sums each stage's
    contribution across all groups — the "which stage actually gated
    the wall clock" number aggregate percentiles cannot produce."""
    groups: dict = {}
    for ev in events:
        if ev.get("ph", "X") != "X" or ev.get("cat") != cat:
            continue
        g = ev.get("args", {}).get(group_attr)
        if g is None:
            continue
        start = ev["ts"] / 1e3
        groups.setdefault(g, []).append(
            (start, start + ev.get("dur", 0) / 1e3, ev["name"])
        )
    out: dict[str, float] = {}
    for spans in groups.values():
        # deterministic ordering regardless of recorder interleaving
        remaining = sorted(spans, key=lambda s: (-s[1], s[0], s[2]))
        cursor = remaining[0][1]
        while remaining:
            pick = None
            for i, s in enumerate(remaining):
                if s[0] < cursor:
                    pick = i
                    break  # latest end among starts-before-cursor
            if pick is None:
                break
            start, end, name = remaining.pop(pick)
            contrib = min(end, cursor) - start
            if contrib > 0:
                out[name] = out.get(name, 0.0) + contrib
            cursor = min(cursor, start)
    return out


# -- env arming ---------------------------------------------------------------


def _init_from_env() -> None:
    raw = knob_registry.raw(_ENV).strip().lower()
    if raw in _FALSY:
        return
    try:
        cap = int(raw)
    except ValueError:
        cap = DEFAULT_CAPACITY
    arm(cap if cap > 1 else DEFAULT_CAPACITY)


_init_from_env()


__all__ = [
    "SpanContext",
    "FlightRecorder",
    "Span",
    "span",
    "begin",
    "instant",
    "annotate",
    "current",
    "attached",
    "wire_token",
    "from_wire",
    "frame_with_token",
    "split_frame_token",
    "FRAME_MARK",
    "active_span_of",
    "enabled",
    "recorder",
    "lookup_count",
    "arm",
    "disarm",
    "reset",
    "reset_ids",
    "scope",
    "export",
    "dump_doc",
    "dump_to",
    "span_sequence",
    "critical_path_ms",
    "DEFAULT_CAPACITY",
]
