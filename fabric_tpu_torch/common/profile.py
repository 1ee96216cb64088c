"""profscope: the profiling plane.

The port's copy of the JAX package's `fabric_tpu/common/profile.py`.
Tracing spans say WHICH stage is slow; profscope says WHY: where the
interpreter spends its time, which lock roles threads wait behind, and
how long workpool chunks sit queued before they run.  It follows the
tracing and faultline seam discipline:

* ``FABRIC_TPU_PROFILE`` unset (the default): ``_profiler`` is None and
  every entry point is a shared no-op whose fast path is one
  module-global load plus an ``is None`` test.  The armed-path counter
  (:func:`lookup_count`) stays 0 across a commit and an RPC.
* armed (env knob, :func:`arm`, or :func:`scope`): a sampler service
  thread (started with ``lockwatch.spawn_thread``) walks
  ``sys._current_frames()`` on a cadence routed through clockskew,
  folding each thread's stack into a BOUNDED aggregate of collapsed
  stacks.  A frame that moved since the previous sample (``(id(frame),
  f_lasti)`` changed) counts as on-CPU; one that did not is treated as
  waiting.  Samples landing inside a live tracing span are attributed
  to it, so each stage gets a ``self_cpu_ms``.  Lock acquire-wait and
  hold (fed by lockwatch's named locks) and workpool queue-wait and
  run time (fed by ``workpool.run_chunked``) aggregate here too, and
  mirror into ``lock_wait_seconds{role=...}`` histograms when a
  :class:`~fabric_tpu_torch.common.metrics.LockMetrics` bundle is
  attached via :func:`set_lock_metrics`.

:func:`export` returns a speedscope-format document (loadable at
speedscope.app) whose ``otherData`` carries the collapsed stacks, the
``self_cpu_ms`` map and the lock-role and workpool aggregates;
:func:`sample_for` runs an on-demand session in the calling thread and
:func:`heap_doc` gives tracemalloc's allocation attribution.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import threading

from fabric_tpu_torch.common import tracing
from fabric_tpu_torch.devtools import clockskew, knob_registry
from fabric_tpu_torch.devtools.lockwatch import spawn_thread

_ENV = "FABRIC_TPU_PROFILE"
_FALSY = ("", "0", "false", "off", "no")

DEFAULT_INTERVAL_S = 0.01  # 100 Hz
DEFAULT_MAX_STACKS = 4096  # distinct collapsed stacks kept per session
_MAX_DEPTH = 64            # frames kept per stack walk

SPEEDSCOPE_SCHEMA = "https://www.speedscope.app/file-format-schema.json"

# idents of threads currently running a sampling loop: every session
# (background or inline) skips them, so the profiler never profiles
# itself or a concurrent session's loop
_sampler_idents: set[int] = set()


class Profiler:
    """One profiling session: a bounded aggregate plus (optionally) a
    background sampler service thread.  All shared aggregate state
    moves under ``_lock``; ``_last``
    is confined to whichever single thread drives sample_once."""

    def __init__(self, interval_s: float = DEFAULT_INTERVAL_S,
                 max_stacks: int = DEFAULT_MAX_STACKS,
                 name: str = "profscope"):
        self.interval_s = max(1e-4, float(interval_s))
        self.max_stacks = int(max_stacks)
        self.name = name
        self._lock = threading.Lock()
        # collapsed "f (file:line);..." -> [wall_samples, cpu_samples]
        self._stacks: dict[str, list] = {}
        # (span name, span cat) -> [wall_samples, cpu_samples]
        self._spans: dict[tuple, list] = {}
        # lock role -> wait/hold aggregate dict
        self._locks: dict[str, dict] = {}
        self._chunks = {"chunks": 0, "queue_wait_s": 0.0, "run_s": 0.0}
        self._samples = 0
        self._dropped = 0
        self._t0 = clockskew.monotonic()
        # sampler-thread-confined: last seen (frame id, f_lasti) per tid
        self._last: dict[int, tuple] = {}
        self._stop_evt = threading.Event()
        self._thread: threading.Thread | None = None

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        """Start the background sampler (idempotent)."""
        if self._thread is not None:
            return
        self._stop_evt.clear()
        t = spawn_thread(
            self._run, name="profscope-sampler", kind="service",
        )
        self._thread = t
        t.start()

    def stop(self) -> None:
        """Stop the sampler and join it."""
        t = self._thread
        if t is None:
            return
        self._stop_evt.set()
        t.join(timeout=10.0)
        self._thread = None

    @property
    def running(self) -> bool:
        return self._thread is not None

    def _run(self) -> None:
        ident = threading.get_ident()
        _sampler_idents.add(ident)
        try:
            while not self._stop_evt.is_set():
                self.sample_once()
                if clockskew.wait(self._stop_evt, self.interval_s):
                    break
        finally:
            _sampler_idents.discard(ident)

    # -- sampling -----------------------------------------------------------

    def sample_once(self) -> None:
        """Fold one ``sys._current_frames()`` sweep into the aggregate.
        Must be driven from ONE thread per profiler (the background
        sampler, or the caller of sample_rounds/sample_for)."""
        me = threading.get_ident()
        trace_on = tracing.enabled()
        frames = sys._current_frames()
        rows = []
        try:
            for tid, frame in frames.items():
                if tid == me or tid in _sampler_idents:
                    continue
                top = (id(frame), frame.f_lasti)
                on_cpu = self._last.get(tid) != top
                self._last[tid] = top
                parts = []
                f = frame
                depth = 0
                while f is not None and depth < _MAX_DEPTH:
                    code = f.f_code
                    parts.append(
                        f"{code.co_name} "
                        f"({code.co_filename.rsplit(os.sep, 1)[-1]}"
                        f":{f.f_lineno})"
                    )
                    f = f.f_back
                    depth += 1
                parts.reverse()
                span = tracing.active_span_of(tid) if trace_on else None
                rows.append((";".join(parts), on_cpu, span))
            if len(self._last) > 2 * len(frames) + 8:
                self._last = {
                    t: v for t, v in self._last.items() if t in frames
                }
        finally:
            del frames  # frames hold other threads' locals; drop fast
        with self._lock:
            self._samples += 1
            for key, on_cpu, span in rows:
                cell = self._stacks.get(key)
                if cell is None:
                    if len(self._stacks) >= self.max_stacks:
                        self._dropped += 1
                        continue
                    cell = self._stacks[key] = [0, 0]
                cell[0] += 1
                if on_cpu:
                    cell[1] += 1
                if span is not None:
                    skey = (span.name, span.cat)
                    scell = self._spans.get(skey)
                    if scell is None and len(self._spans) < self.max_stacks:
                        scell = self._spans[skey] = [0, 0]
                    if scell is not None:
                        scell[0] += 1
                        if on_cpu:
                            scell[1] += 1

    def sample_rounds(self, n: int) -> None:
        """n synchronous sweeps with no cadence wait — deterministic
        test hook for an un-started profiler."""
        for _ in range(n):
            self.sample_once()

    # -- feed points (called via the module-level no-op seam) ---------------

    def _note_lock(self, role: str, wait_s: float | None = None,
                   hold_s: float | None = None) -> None:
        with self._lock:
            cell = self._locks.get(role)
            if cell is None:
                cell = self._locks[role] = {
                    "wait_s": 0.0, "wait_count": 0, "max_wait_s": 0.0,
                    "hold_s": 0.0, "hold_count": 0,
                }
            if wait_s is not None:
                cell["wait_s"] += wait_s
                cell["wait_count"] += 1
                if wait_s > cell["max_wait_s"]:
                    cell["max_wait_s"] = wait_s
            if hold_s is not None:
                cell["hold_s"] += hold_s
                cell["hold_count"] += 1

    def _note_chunk(self, queue_wait_s: float, run_s: float) -> None:
        with self._lock:
            c = self._chunks
            c["chunks"] += 1
            c["queue_wait_s"] += queue_wait_s
            c["run_s"] += run_s

    # -- export -------------------------------------------------------------

    def reset(self) -> None:
        """Clear the aggregates (bench resets per measured pass, like
        tracing.reset)."""
        with self._lock:
            self._stacks.clear()
            self._spans.clear()
            self._locks.clear()
            self._chunks = {
                "chunks": 0, "queue_wait_s": 0.0, "run_s": 0.0,
            }
            self._samples = 0
            self._dropped = 0
            self._t0 = clockskew.monotonic()

    def export(self, name: str | None = None) -> dict:
        """Snapshot the aggregate as one speedscope-format document.
        ``shared.frames``/``profiles[0]`` load directly in the
        speedscope app; everything fabric-specific (collapsed stacks,
        per-stage ``self_cpu_ms``, lock-role waits, workpool chunk
        attribution) rides in ``otherData``."""
        with self._lock:
            stacks = {k: list(v) for k, v in self._stacks.items()}
            spans = {k: list(v) for k, v in self._spans.items()}
            locks = {
                r: {k: round(v, 6) if isinstance(v, float) else v
                    for k, v in c.items()}
                for r, c in self._locks.items()
            }
            chunks = {
                k: round(v, 6) if isinstance(v, float) else v
                for k, v in self._chunks.items()
            }
            samples = self._samples
            dropped = self._dropped
            duration = max(0.0, clockskew.monotonic() - self._t0)
        frames: list[str] = []
        index: dict[str, int] = {}
        sample_rows: list[list[int]] = []
        weights: list[float] = []
        collapsed: list[str] = []
        for key in sorted(stacks):
            wall, _cpu = stacks[key]
            idxs = []
            for fr in key.split(";"):
                i = index.get(fr)
                if i is None:
                    i = index[fr] = len(frames)
                    frames.append(fr)
                idxs.append(i)
            sample_rows.append(idxs)
            weights.append(round(wall * self.interval_s, 6))
            collapsed.append(f"{key} {wall}")
        total = round(sum(weights), 6)
        span_rows = []
        self_cpu: dict[str, float] = {}
        for skey in sorted(spans):
            sname, cat = skey
            wall, cpu = spans[skey]
            cpu_ms = round(cpu * self.interval_s * 1e3, 3)
            span_rows.append({
                "name": sname, "cat": cat,
                "wall_samples": wall, "cpu_samples": cpu,
                "self_wall_ms": round(wall * self.interval_s * 1e3, 3),
                "self_cpu_ms": cpu_ms,
            })
            self_cpu[sname] = round(self_cpu.get(sname, 0.0) + cpu_ms, 3)
        return {
            "$schema": SPEEDSCOPE_SCHEMA,
            "exporter": "fabric-tpu profscope",
            "name": name or self.name,
            "activeProfileIndex": 0,
            "shared": {"frames": [{"name": fr} for fr in frames]},
            "profiles": [{
                "type": "sampled",
                "name": name or self.name,
                "unit": "seconds",
                "startValue": 0,
                "endValue": total,
                "samples": sample_rows,
                "weights": weights,
            }],
            "otherData": {
                "armed": _profiler is self,
                "interval_s": self.interval_s,
                "samples": samples,
                "duration_s": round(duration, 6),
                "dropped_stacks": dropped,
                "collapsed": collapsed,
                "self_cpu_ms": self_cpu,
                "span_cpu": span_rows,
                "locks": locks,
                "workpool": chunks,
            },
        }


# the armed profiler; None = profiling disarmed.  EVERY entry point's
# fast path tests only this global (the tracing `_recorder` pattern).
_profiler: Profiler | None = None
_state_lock = threading.Lock()

# armed-path consultations — stays 0 while profiling has never been
# armed, which is the zero-overhead acceptance probe
_lookups = [0]

# optional live LockMetrics bundle:
# armed lock waits/holds mirror into its histograms for /metrics
_lock_metrics = None


def enabled() -> bool:
    return _profiler is not None


def profiler() -> Profiler | None:
    return _profiler


def lookup_count() -> int:
    return _lookups[0]


def arm(interval_s: float | None = None,
        max_stacks: int | None = None) -> Profiler:
    """Arm profiling process-wide and start the sampler; replaces (and
    stops) any previous profiler."""
    global _profiler
    prof = Profiler(
        interval_s=DEFAULT_INTERVAL_S if interval_s is None else interval_s,
        max_stacks=DEFAULT_MAX_STACKS if max_stacks is None else max_stacks,
    )
    with _state_lock:
        prev = _profiler
        _profiler = prof
    if prev is not None:
        prev.stop()
    prof.start()
    return prof


def disarm() -> None:
    global _profiler
    with _state_lock:
        prof = _profiler
        _profiler = None
    if prof is not None:
        prof.stop()


@contextlib.contextmanager
def scope(interval_s: float | None = None,
          max_stacks: int | None = None, sampler: bool = True):
    """Temporarily armed profiler for tests/benches; restores the
    previous armed state (without stopping it) on exit and always
    joins its own sampler.  ``sampler=False`` arms the seam without a
    background thread — feed points and sample_rounds still work,
    deterministically."""
    global _profiler
    prof = Profiler(
        interval_s=DEFAULT_INTERVAL_S if interval_s is None else interval_s,
        max_stacks=DEFAULT_MAX_STACKS if max_stacks is None else max_stacks,
    )
    with _state_lock:
        prev = _profiler
        _profiler = prof
    if sampler:
        prof.start()
    try:
        yield prof
    finally:
        with _state_lock:
            _profiler = prev
        prof.stop()


def reset() -> None:
    p = _profiler
    if p is None:
        return
    _lookups[0] += 1
    p.reset()


def set_lock_metrics(bundle) -> None:
    """Attach a LockMetrics bundle: armed lock waits/holds observe
    into its ``lock_wait_seconds{role}`` / ``lock_hold_seconds{role}``
    histograms."""
    global _lock_metrics
    _lock_metrics = bundle


def note_lock_wait(role: str, seconds: float) -> None:
    """Feed point for lockwatch: time a thread spent blocked acquiring
    the lock with this role.  No-op disarmed; the profiler's own lock
    roles are excluded so metric observation can never recurse."""
    p = _profiler
    if p is None:
        return
    if role.startswith("profile."):
        return
    _lookups[0] += 1
    p._note_lock(role, wait_s=seconds)
    m = _lock_metrics
    if m is not None:
        try:
            m.wait.With("role", role).observe(seconds)
        except Exception:
            pass


def note_lock_hold(role: str, seconds: float) -> None:
    """Feed point for lockwatch: how long the lock was held once
    acquired (outermost acquire to final release)."""
    p = _profiler
    if p is None:
        return
    if role.startswith("profile."):
        return
    _lookups[0] += 1
    p._note_lock(role, hold_s=seconds)
    m = _lock_metrics
    if m is not None:
        try:
            m.hold.With("role", role).observe(seconds)
        except Exception:
            pass


def note_chunk(queue_wait_s: float, run_s: float) -> None:
    """Feed point for workpool.run_chunked: per-chunk queue-wait vs
    run-time attribution."""
    p = _profiler
    if p is None:
        return
    _lookups[0] += 1
    p._note_chunk(queue_wait_s, run_s)


def export(name: str | None = None) -> dict:
    """The armed profiler's accumulated document, or a valid (empty)
    disarmed speedscope doc — the /traces 'armed: false' convention."""
    p = _profiler
    if p is None:
        return {
            "$schema": SPEEDSCOPE_SCHEMA,
            "exporter": "fabric-tpu profscope",
            "name": "profscope (disarmed)",
            "activeProfileIndex": 0,
            "shared": {"frames": []},
            "profiles": [],
            "otherData": {"armed": False},
        }
    _lookups[0] += 1
    return p.export(name)


def sample_for(seconds: float, interval_s: float | None = None,
               name: str = "profscope.session") -> dict:
    """Synchronous sampling session in the CALLING thread (no spawn):
    backs ``GET /profile?seconds=N``, works armed or disarmed, and
    under a virtual clock completes instantly with the same number of
    rounds.  Always takes at least one sample."""
    prof = Profiler(
        interval_s=DEFAULT_INTERVAL_S if interval_s is None else interval_s,
        name=name,
    )
    ident = threading.get_ident()
    _sampler_idents.add(ident)
    try:
        deadline = clockskew.monotonic() + max(0.0, float(seconds))
        while True:
            prof.sample_once()
            if clockskew.monotonic() >= deadline:
                break
            clockskew.sleep(prof.interval_s)
    finally:
        _sampler_idents.discard(ident)
    return prof.export()


def heap_doc(limit: int = 50) -> dict:
    """Allocation attribution via tracemalloc (``GET /profile/heap``).
    Starts tracemalloc on first call if nobody else did — that first
    document only covers allocations from this point on, flagged by
    ``tracemalloc_started_now``."""
    import tracemalloc

    started_now = False
    if not tracemalloc.is_tracing():
        tracemalloc.start()
        started_now = True
    snapshot = tracemalloc.take_snapshot()
    current, peak = tracemalloc.get_traced_memory()
    stats = snapshot.statistics("lineno")[: max(0, int(limit))]
    top = [
        {
            "site": (
                f"{s.traceback[0].filename.rsplit(os.sep, 1)[-1]}"
                f":{s.traceback[0].lineno}"
            ),
            "size_bytes": s.size,
            "count": s.count,
        }
        for s in stats
    ]
    return {
        "source": "fabric_tpu_torch.profscope.heap",
        "tracemalloc_started_now": started_now,
        "current_bytes": current,
        "peak_bytes": peak,
        "top": top,
    }


def dump_to(path: str, doc: dict | None = None) -> str:
    """Write a profile document (default: :func:`export`) as JSON."""
    doc = export() if doc is None else doc
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f, sort_keys=True)
    return path


def _init_from_env() -> None:
    """FABRIC_TPU_PROFILE: unset/falsy = disarmed; truthy = armed at
    the default 100 Hz; a number > 1 = that sampling rate in Hz (the
    FABRIC_TPU_TRACE sizing convention)."""
    raw = knob_registry.raw(_ENV)
    if raw.strip().lower() in _FALSY:
        if _profiler is not None:
            disarm()
        return
    try:
        hz = float(raw)
    except ValueError:
        hz = 0.0
    arm(interval_s=(1.0 / hz) if hz > 1.0 else DEFAULT_INTERVAL_S)


_init_from_env()


__all__ = [
    "Profiler",
    "enabled",
    "profiler",
    "lookup_count",
    "arm",
    "disarm",
    "scope",
    "reset",
    "export",
    "sample_for",
    "heap_doc",
    "dump_to",
    "set_lock_metrics",
    "note_lock_wait",
    "note_lock_hold",
    "note_chunk",
    "DEFAULT_INTERVAL_S",
    "DEFAULT_MAX_STACKS",
    "SPEEDSCOPE_SCHEMA",
]
