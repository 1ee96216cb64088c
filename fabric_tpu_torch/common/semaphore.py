"""Weighted semaphore (the port's copy of `fabric_tpu/common/semaphore.py`;
reference common/semaphore/semaphore.go:19 — a channel-based counting
semaphore used for validator concurrency and gRPC limiters; here it caps
RPC handler and chaincode-execution concurrency)."""

from __future__ import annotations

import threading


class Semaphore:
    """Counting semaphore with try-acquire and context-manager use."""

    def __init__(self, permits: int):
        if permits <= 0:
            raise ValueError("permits must be positive")
        self._sem = threading.Semaphore(permits)
        self.permits = permits

    def acquire(self, timeout: float | None = None) -> bool:
        return self._sem.acquire(timeout=timeout)

    def try_acquire(self) -> bool:
        return self._sem.acquire(blocking=False)

    def release(self) -> None:
        self._sem.release()

    def __enter__(self):
        self._sem.acquire()
        return self

    def __exit__(self, *exc):
        self._sem.release()
        return False


__all__ = ["Semaphore"]
