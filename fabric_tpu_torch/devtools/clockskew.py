"""clockskew: one patchable time provider.

The port's copy of the JAX package's `fabric_tpu/devtools/clockskew.py`,
which faultline imports: a ``delay`` rule sleeps through :func:`sleep`
and a ``skew`` rule jumps the clock through :func:`advance`.

Default behaviour is the system clock: :func:`monotonic`/:func:`wall`
are one module-global load away from ``time.monotonic()``/
``time.time()``, :func:`sleep`/:func:`wait` really sleep, and
:func:`io_timeout` returns its argument unchanged.  Installing a
:class:`VirtualClock` (``with clockskew.use_virtual() as clk``) flips
all of them to the virtual time base:

- ``monotonic()``/``wall()`` read the manual clock (monotonic never
  goes backwards; wall may jump either way, as an NTP step does),
- ``sleep(s)``/``wait(event, s)`` advance the clock instead of
  sleeping (``wait`` still yields the GIL so the signalling thread
  runs), and every virtual sleep is recorded on ``clk.sleeps``,
- ``io_timeout(s)`` scales socket/queue deadlines by
  ``clk.timeout_scale`` (floored at 10 ms).

On the system clock a ``skew`` rule's jump is recorded as a trip but
moves nothing: real time cannot be skewed.
"""

from __future__ import annotations

import contextlib
import threading
import time as _time

# minimum REAL deadline io_timeout may hand to the kernel — a scaled-to-
# zero timeout would turn poll loops into busy spins
_IO_FLOOR = 0.01


class VirtualClock:
    """A deterministic, manually advanced clock.

    ``start``/``wall`` seed the monotonic and wall bases; ``auto_step``
    adds that many seconds on every ``monotonic()`` READ, which drives
    deadline-polling loops forward without any explicit advance calls;
    ``timeout_scale`` compresses :func:`io_timeout` deadlines."""

    def __init__(self, start: float = 1000.0, wall: float = 1.7e9,
                 timeout_scale: float = 1.0, auto_step: float = 0.0):
        self._lock = threading.Lock()
        self._mono = float(start)
        self._wall = float(wall)
        self.timeout_scale = float(timeout_scale)
        self._auto = float(auto_step)
        # every virtual sleep/wait duration, in order — the observable
        # timeline tests assert against
        self.sleeps: list[float] = []

    def monotonic(self) -> float:
        with self._lock:
            self._mono += self._auto
            return self._mono

    def wall(self) -> float:
        with self._lock:
            return self._wall

    def advance(self, dt: float, wall_dt: float | None = None) -> None:
        """Jump the clock: monotonic moves forward by max(dt, 0) — a
        monotonic source never runs backwards — while wall moves by
        ``wall_dt`` (defaults to ``dt``) in EITHER direction, modeling
        an NTP step."""
        with self._lock:
            if dt > 0:
                self._mono += dt
            self._wall += dt if wall_dt is None else wall_dt

    def sleep(self, seconds: float) -> None:
        if seconds > 0:
            self.sleeps.append(seconds)
            self.advance(seconds)

    def wait(self, event: threading.Event, timeout: float | None) -> bool:
        if event.is_set():
            return True
        if timeout is None:
            # the blocking-forever form has no virtual meaning — only a
            # real signal can end it, so block for real (a zero-length
            # poll here would turn `while not wait(stop, None)` loops
            # into hot spins)
            return event.wait()
        if timeout > 0:
            self.sleeps.append(timeout)
            self.advance(timeout)
        # zero-length REAL wait: yields the GIL so the setter thread can
        # run, without consuming real time proportional to `timeout`
        return event.wait(0.0)

    def io_timeout(self, seconds: float | None) -> float | None:
        if seconds is None:
            return None
        return max(seconds * self.timeout_scale, _IO_FLOOR)


# the installed provider; None = system time.  Every accessor below is
# a single global load + branch, cheap enough for reconnect loops (none
# of these sit on the ledger commit hot path).
_clock: VirtualClock | None = None


def installed() -> VirtualClock | None:
    return _clock


def install(clock: VirtualClock | None) -> None:
    global _clock
    _clock = clock


@contextlib.contextmanager
def use_virtual(clock: VirtualClock | None = None):
    """Install a virtual clock for a scope (restores the previous
    provider on exit, so nested scopes compose)."""
    c = clock if clock is not None else VirtualClock()
    prev = _clock
    install(c)
    try:
        yield c
    finally:
        install(prev)


def monotonic() -> float:
    c = _clock
    return _time.monotonic() if c is None else c.monotonic()


def wall() -> float:
    c = _clock
    return _time.time() if c is None else c.wall()


def sleep(seconds: float) -> None:
    c = _clock
    if c is None:
        if seconds > 0:
            _time.sleep(seconds)
    else:
        c.sleep(seconds)


def wait(event: threading.Event, timeout: float | None) -> bool:
    """``event.wait(timeout)`` through the provider: virtual clocks
    advance instead of blocking.  Returns the event state."""
    c = _clock
    return event.wait(timeout) if c is None else c.wait(event, timeout)


def io_timeout(seconds: float | None) -> float | None:
    """A deadline handed to the kernel/queue layer (``sock.settimeout``,
    ``queue.get``): real seconds on the system clock, scaled by the
    virtual clock's ``timeout_scale`` otherwise."""
    c = _clock
    return seconds if c is None else c.io_timeout(seconds)


def advance(dt: float, wall_dt: float | None = None) -> None:
    """Skew injection (faultline ``skew`` rules land here): jump the
    virtual clock; a no-op on the system clock — real time cannot be
    skewed, the trip is still recorded by faultline."""
    c = _clock
    if c is not None:
        c.advance(dt, wall_dt)


__all__ = [
    "VirtualClock",
    "install",
    "installed",
    "use_virtual",
    "monotonic",
    "wall",
    "sleep",
    "wait",
    "io_timeout",
    "advance",
]
