"""The process's bounded host work pool for the commit path's parallel
stages (the port's copy of `fabric_tpu/common/workpool.py`).

Two host loops fan out over one shared executor: the validator's collect
(`FABRIC_TPU_COLLECT_POOL`) and MVCC's per-namespace preload and
write-set prepare (`FABRIC_TPU_MVCC_POOL`).  One pool keeps the process's
host-thread budget fixed however many validators and ledgers exist, as
the reference's single validation worker pool does
(core/committer/txvalidator validationWorkersSemaphore).

A stage's width is its knob, else the auto width; "0", "false", "off"
and "no" keep it serial.  Widths are chunk counts, not thread counts: a
stage splits its items into `width` contiguous chunks and submits each,
so the results merge back in chunk order whatever the width, and the
executor's worker cap bounds the real concurrency.

The pool is made at first use through ``lockwatch.tracked_executor``, so
under ``FABRIC_TPU_THREADWATCH`` its workers register with the drain
gate; whoever may have started it calls `shutdown` on the way out.  While
tracing is armed each chunk runs under a ``workpool.chunk`` span in the
caller's trace; while profiling is armed each chunk's queue wait and run
time go to `profile.note_chunk`; `set_metrics` attaches a
`common.metrics.WorkpoolMetrics` bundle.
"""

from __future__ import annotations

import os
import threading
from concurrent.futures import wait as _wait

from fabric_tpu_torch.common import profile, tracing
from fabric_tpu_torch.devtools import clockskew, knob_registry
from fabric_tpu_torch.devtools.lockwatch import tracked_executor

_FALSY = ("0", "false", "off", "no")

# the shared executor; it moves only under _pool_lock
_pool = None
_pool_lock = threading.Lock()

# an optional WorkpoolMetrics bundle and the fan-out counters (chunks
# submitted, peak chunks in flight), all under one lock
_metrics = None
_stats_lock = threading.Lock()
_stats = {"chunks": 0, "in_flight": 0, "max_in_flight": 0}


def set_metrics(metrics) -> None:
    """Attach a common.metrics.WorkpoolMetrics bundle: run_chunked then
    keeps its queue-depth, in-flight and saturation gauges current."""
    global _metrics
    with _stats_lock:
        _metrics = metrics


def stats() -> dict:
    """Chunks submitted and the most in flight at once since the last
    `reset_stats`."""
    with _stats_lock:
        return {k: v for k, v in _stats.items() if k != "in_flight"}


def reset_stats() -> None:
    with _stats_lock:
        _stats["chunks"] = 0
        _stats["max_in_flight"] = 0


def _note_submit(pool, n_chunks: int) -> None:
    with _stats_lock:
        _stats["chunks"] += n_chunks
        _stats["in_flight"] += n_chunks
        _stats["max_in_flight"] = max(_stats["max_in_flight"],
                                      _stats["in_flight"])
        m = _metrics
        inflight = _stats["in_flight"]
    if m is not None:
        m.in_flight.set(inflight)
        q = getattr(pool, "_work_queue", None)
        if q is not None:
            m.queue_depth.set(q.qsize())
        workers = getattr(pool, "_max_workers", 0) or 1
        m.saturation.set(min(1.0, inflight / workers))


def _note_done(n_chunks: int) -> None:
    with _stats_lock:
        _stats["in_flight"] = max(0, _stats["in_flight"] - n_chunks)
        m = _metrics
        inflight = _stats["in_flight"]
    if m is not None:
        m.in_flight.set(inflight)


def _auto_width() -> int:
    cpus = os.cpu_count() or 4
    return min(8, max(2, cpus // 3))


def stage_width(env: str) -> int:
    """A stage's fan-out width: its knob, else the auto width; 0 keeps the
    stage serial."""
    raw = knob_registry.raw(env).strip().lower()
    if not raw:
        return _auto_width()
    if raw in _FALSY:
        return 0
    try:
        n = int(raw)
    except ValueError:
        raise ValueError(
            f"{env}={raw!r} is not an integer fan-out width "
            "(0 disables the stage's parallelism)"
        ) from None
    return max(0, n)


def default_pool():
    """The shared executor, made at first use with the widest auto width's
    workers (at least 4) and never resized: a wider stage queues, which
    keeps its results the same.  A "service" to threadwatch: its stop
    path is `shutdown`."""
    global _pool
    with _pool_lock:
        if _pool is None:
            _pool = tracked_executor(max_workers=max(_auto_width(), 4),
                                     name="fabric-workpool", kind="service")
        return _pool


def saturation() -> tuple[int, int, int]:
    """Instantaneous pool pressure: ``(in_flight chunks, worker cap,
    executor queue depth)``; all zeros while the shared pool has never
    been made (probing does not make it)."""
    with _pool_lock:
        pool = _pool
    if pool is None:
        return 0, 0, 0
    workers = getattr(pool, "_max_workers", 0) or 0
    q = getattr(pool, "_work_queue", None)
    depth = q.qsize() if q is not None else 0
    with _stats_lock:
        inflight = _stats["in_flight"]
    return inflight, workers, depth


def health_checker():
    """A /healthz checker (`operations.System.register_checker`) that
    fails while fan-outs queue behind each other: more chunks in flight
    than the pool has workers and tasks waiting in the executor's
    queue."""

    def check() -> bool:
        inflight, workers, depth = saturation()
        if workers and inflight > workers and depth > 0:
            raise RuntimeError(
                f"workpool saturated: {inflight} chunks in flight over "
                f"{workers} workers, {depth} queued"
            )
        return True

    return check


def shutdown(wait: bool = True) -> None:
    """Shut the shared executor down (idempotent); the next use makes a
    new one."""
    global _pool
    with _pool_lock:
        pool, _pool = _pool, None
    if pool is not None:
        pool.shutdown(wait=wait)


class scoped_pool:
    """An executor of its own for a `with` block, so that a test sweeps
    pool sizes without touching the shared one::

        with scoped_pool(3) as pool:
            validator = TxValidator(..., collect_pool=pool)
    """

    def __init__(self, max_workers: int, name: str = "scoped-pool"):
        self._pool = tracked_executor(max_workers=max_workers, name=name,
                                      kind="worker")

    def __enter__(self):
        return self._pool

    def __exit__(self, *exc) -> bool:
        self._pool.shutdown(wait=True)
        return False


def run_chunked(pool, fn, items, width: int) -> list:
    """`fn` over `items` in `width` contiguous chunks on `pool`; the
    per-item results in input order.

    `fn(chunk_start, [item, ...])` returns a list of per-item results.
    Chunk boundaries depend only on `len(items)` and `width`, and results
    join in chunk order, so the output is the same at every width.  A
    chunk's exception reaches the caller (the first in chunk order) after
    every chunk has settled."""
    n = len(items)
    if n == 0:
        return []
    width = min(width, n)
    if width <= 1:
        return fn(0, items)
    ctx = tracing.current() if tracing.enabled() else None
    if ctx is not None:
        # the caller's span flows into the pooled work: every chunk runs
        # under a child span, so spans opened inside parent across the
        # thread hop
        caller_fn = fn

        def fn(off, chunk, _fn=caller_fn, _ctx=ctx):
            with tracing.attached(_ctx):
                with tracing.span("workpool.chunk", offset=off,
                                  items=len(chunk)):
                    return _fn(off, chunk)

    if profile.enabled():
        # queue wait against run time: every chunk is submitted in the
        # loop below, so one submit timestamp serves them all
        submitted_fn = fn
        t_submit = clockskew.monotonic()

        def fn(off, chunk, _fn=submitted_fn, _ts=t_submit):
            t_start = clockskew.monotonic()
            try:
                return _fn(off, chunk)
            finally:
                profile.note_chunk(t_start - _ts,
                                   clockskew.monotonic() - t_start)

    per = (n + width - 1) // width
    futures = [pool.submit(fn, off, items[off:off + per])
               for off in range(0, n, per)]
    _note_submit(pool, len(futures))
    out: list = []
    try:
        for f in futures:
            out.extend(f.result())
    except BaseException:
        for f in futures:
            f.cancel()
        # no chunk may still run once this call has returned
        _wait(futures)
        raise
    finally:
        _note_done(len(futures))
    return out


__all__ = ["default_pool", "scoped_pool", "shutdown", "stage_width",
           "run_chunked", "set_metrics", "stats", "reset_stats",
           "saturation", "health_checker"]
