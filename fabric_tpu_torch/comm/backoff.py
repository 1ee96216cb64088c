"""Deterministic decorrelated-jitter backoff for reconnect loops.

The port's copy of the JAX package's `fabric_tpu/comm/backoff.py`:
exponential backoff with decorrelated jitter, ``sleep = min(cap,
uniform(base, prev * 3))``, with one twist: the jitter rng is seeded from a STABLE
key (local identity + peer address — see ``for_key``; peer-only keys
would synchronize every dialer of one downed node), never wall-clock,
so a chaos run under a faultline plan replays the exact same dial
cadence every time, and two runs of a failing test show identical
timelines."""

from __future__ import annotations

import random

from fabric_tpu_torch.devtools import clockskew


class DecorrelatedBackoff:
    """Deterministic decorrelated jitter: same seed -> same sequence."""

    def __init__(self, base: float = 0.05, cap: float = 2.0, seed: int = 0):
        if base <= 0 or cap < base:
            raise ValueError("need 0 < base <= cap")
        self._base = base
        self._cap = cap
        self._seed = seed
        self._rng = random.Random(seed)
        self._prev = base
        self._dirty = False

    @classmethod
    def for_key(cls, key: str, base: float = 0.05,
                cap: float = 2.0) -> "DecorrelatedBackoff":
        """The standard reconnect policy, seeded from a stable key —
        the one place the base/cap tuning and the seed scheme live for
        every transport.  Callers build the key as
        ``f"{local_identity}->{peer}"``: the LOCAL half matters — if N
        peers seeded only from the downed peer's address, every process
        would replay the identical jitter sequence and their dial
        windows would align into the synchronized retry bursts
        decorrelated jitter exists to prevent."""
        import zlib

        return cls(base=base, cap=cap, seed=zlib.crc32(key.encode()))

    def next(self) -> float:
        """The next wait in seconds; grows toward `cap` with jitter."""
        self._dirty = True
        self._prev = min(
            self._cap,
            self._rng.uniform(self._base, max(self._base, self._prev * 3)),
        )
        return self._prev

    def reset(self) -> None:
        """Back to the initial state (after a proven-healthy exchange) —
        including the rng, so the next failure episode replays the same
        jitter sequence.  No-op when already pristine (callers reset on
        every successful send; per-message rng construction would be
        waste)."""
        if not self._dirty:
            return
        self._rng = random.Random(self._seed)
        self._prev = self._base
        self._dirty = False


class BackoffGate:
    """A dial/redial gate over a :class:`DecorrelatedBackoff`, clocked
    through the ``devtools.clockskew`` monotonic source — the one place
    the "am I still inside the backoff window?" comparison lives, so
    every transport gates the same way and a virtual clock (or a
    faultline ``skew`` rule jumping it) drives the window open
    deterministically in tests with no real sleeps.

    ``ready()`` is True when no window is armed or the armed window has
    passed; ``arm()`` draws the next jitter interval and opens a new
    window; ``clear()`` closes it without touching the jitter sequence
    (a successful dial); ``reset()`` additionally rewinds the jitter rng
    (a PROVEN-healthy exchange, same contract as
    :meth:`DecorrelatedBackoff.reset`)."""

    def __init__(self, backoff: DecorrelatedBackoff):
        self._backoff = backoff
        self._until = 0.0

    @classmethod
    def for_key(cls, key: str, base: float = 0.05,
                cap: float = 2.0) -> "BackoffGate":
        return cls(DecorrelatedBackoff.for_key(key, base=base, cap=cap))

    def ready(self) -> bool:
        return clockskew.monotonic() >= self._until

    def arm(self) -> float:
        """Open the next backoff window; returns its length in seconds."""
        wait = self._backoff.next()
        self._until = clockskew.monotonic() + wait
        return wait

    def clear(self) -> None:
        self._until = 0.0

    def reset(self) -> None:
        self._backoff.reset()
        self._until = 0.0


__all__ = ["DecorrelatedBackoff", "BackoffGate"]
