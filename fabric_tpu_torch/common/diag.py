"""Diagnostics: thread dump on SIGUSR1 (the port's copy of
`fabric_tpu/common/diag.py`; reference common/diag/
goroutine.go:19-28 dumps goroutines; Python daemons dump thread stacks
to the log stream)."""

from __future__ import annotations

import signal
import sys
import threading
import traceback


def dump_threads(out=None) -> str:
    out = out or sys.stderr
    frames = sys._current_frames()
    lines = []
    for t in threading.enumerate():
        lines.append(f"--- thread {t.name} (daemon={t.daemon}) ---")
        frame = frames.get(t.ident)
        if frame is not None:
            lines.extend(
                line.rstrip()
                for line in traceback.format_stack(frame)
            )
    text = "\n".join(lines) + "\n"
    out.write(text)
    out.flush()
    return text


def install_signal_handler(sig=signal.SIGUSR1) -> None:
    """Register the dump on SIGUSR1 (reference internal/peer/node/
    signals.go wires the same signal)."""
    signal.signal(sig, lambda *_: dump_threads())


__all__ = ["dump_threads", "install_signal_handler"]
