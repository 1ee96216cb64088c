"""Structured logging with runtime per-logger level specs.

The port's copy of the JAX package's `fabric_tpu/common/flogging.py`
(reference common/flogging: a global registry, per-logger level specs
parsed from strings like "gossip=debug:warning", a metrics observer
counting emitted entries), built on the stdlib logging module: one shared
handler, a level registry that applies spec rules by longest-prefix
logger-name match, and an optional metrics hook.  Loggers live under
``fabric_tpu_torch``.  Span tracing is not ported yet, so log lines
carry no trace ids.
"""

from __future__ import annotations

import logging
import sys
import threading

_NAME = "fabric_tpu_torch"

_LEVELS = {
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warning": logging.WARNING,
    "warn": logging.WARNING,
    "error": logging.ERROR,
    "critical": logging.CRITICAL,
    "panic": logging.CRITICAL,
    "fatal": logging.CRITICAL,
}
_LEVEL_NAMES = {
    logging.DEBUG: "debug",
    logging.INFO: "info",
    logging.WARNING: "warning",
    logging.ERROR: "error",
    logging.CRITICAL: "critical",
}


class LogSpecError(ValueError):
    pass


def parse_spec(spec: str) -> tuple[int, dict[str, int]]:
    """Parse "logger1,logger2=level:logger3=level:defaultlevel" into
    (default_level, {prefix: level}) (reference loggerlevels.go
    ActivateSpec)."""
    default = logging.INFO
    overrides: dict[str, int] = {}
    for field in (spec or "").split(":"):
        field = field.strip()
        if not field:
            continue
        if "=" in field:
            names, _, lvl = field.partition("=")
            level = _LEVELS.get(lvl.strip().lower())
            if level is None:
                raise LogSpecError(f"invalid log level {lvl!r}")
            for name in names.split(","):
                name = name.strip().rstrip(".")
                if name:
                    overrides[name] = level
        else:
            level = _LEVELS.get(field.lower())
            if level is None:
                raise LogSpecError(f"invalid log level {field!r}")
            default = level
    return default, overrides


class LoggerLevels:
    """Longest-prefix level resolution (reference loggerlevels.go)."""

    def __init__(self):
        self._default = logging.INFO
        self._overrides: dict[str, int] = {}
        self._lock = threading.Lock()
        self._spec = "info"

    def activate_spec(self, spec: str) -> None:
        default, overrides = parse_spec(spec)
        with self._lock:
            self._default = default
            self._overrides = overrides
            self._spec = spec or "info"

    def spec(self) -> str:
        with self._lock:
            return self._spec

    def level_for(self, name: str) -> int:
        with self._lock:
            best, best_len = self._default, -1
            for prefix, lvl in self._overrides.items():
                if (
                    name == prefix or name.startswith(prefix + ".")
                ) and len(prefix) > best_len:
                    best, best_len = lvl, len(prefix)
            return best


class _LevelFilter(logging.Filter):
    def __init__(self, registry: "Registry"):
        super().__init__()
        self._registry = registry

    def filter(self, record: logging.LogRecord) -> bool:
        name = record.name
        if name.startswith(_NAME + "."):
            name = name[len(_NAME) + 1 :]
        ok = record.levelno >= self._registry.levels.level_for(name)
        if ok and self._registry.observer is not None:
            self._registry.observer(record)
        return ok


class Registry:
    """Global logging state (reference global.go / logging.go Logging)."""

    def __init__(self):
        self.levels = LoggerLevels()
        self.observer = None  # callable(record), e.g. metrics counter
        self._root = logging.getLogger(_NAME)
        self._root.setLevel(logging.DEBUG)  # filtering happens in _LevelFilter
        self._root.propagate = False
        self._handler = logging.StreamHandler(sys.stderr)
        self._handler.setFormatter(
            logging.Formatter(
                "%(asctime)s %(levelname).4s [%(name)s] %(message)s",
                "%Y-%m-%d %H:%M:%S",
            )
        )
        self._handler.addFilter(_LevelFilter(self))
        self._root.addHandler(self._handler)

    def logger(self, name: str) -> logging.Logger:
        return logging.getLogger(f"{_NAME}.{name}")

    def activate_spec(self, spec: str) -> None:
        self.levels.activate_spec(spec)

    def spec(self) -> str:
        return self.levels.spec()

    def set_writer(self, stream) -> None:
        self._handler.setStream(stream)

    def set_observer_counter(self, counter) -> None:
        """Count emitted entries per level (reference metrics/observer.go
        CheckedEntry counter with a level label)."""

        def observe(record: logging.LogRecord) -> None:
            counter.with_labels(
                "level", _LEVEL_NAMES.get(record.levelno, "info")
            ).add(1)

        self.observer = observe


_registry = Registry()


def must_get_logger(name: str) -> logging.Logger:
    """The module-level entry point (reference flogging.MustGetLogger)."""
    return _registry.logger(name)


def activate_spec(spec: str) -> None:
    _registry.activate_spec(spec)


def spec() -> str:
    return _registry.spec()


def global_registry() -> Registry:
    return _registry


__all__ = [
    "must_get_logger",
    "activate_spec",
    "spec",
    "parse_spec",
    "LoggerLevels",
    "LogSpecError",
    "Registry",
    "global_registry",
]
