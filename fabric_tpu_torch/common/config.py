"""Configuration loading: YAML + environment overrides + decode hooks.

The reference reads core.yaml / orderer.yaml through viper with an
enhanced unmarshal (common/viperutil/config_util.go:34-240): nested env
overrides (`CORE_PEER_LISTENADDRESS`), byte-size strings ("100 MB"),
duration strings ("5s"), and `file:` indirection for PEM blobs; config
files resolve via FABRIC_CFG_PATH (core/config/config.go).  This module
is the port's copy of `fabric_tpu/common/config.py`, used by the peer and
orderer CLIs; it reads YAML with the port's own reader of the subset the
configuration files use (`common.yamlsub`), where the JAX package calls
`yaml.safe_load`.

Resolution order (viper semantics): explicit flag > environment
variable > config file value > default.
"""

from __future__ import annotations

import os
import re
from typing import Any

from fabric_tpu_torch.common import yamlsub

_CFG_ENV = "FABRIC_CFG_PATH"

_SIZE_RE = re.compile(r"^\s*(\d+(?:\.\d+)?)\s*([kmg]?)b?\s*$", re.I)
_DUR_RE = re.compile(r"^\s*(\d+(?:\.\d+)?)\s*(ns|us|ms|s|m|h)\s*$", re.I)
_DUR_SCALE = {"ns": 1e-9, "us": 1e-6, "ms": 1e-3, "s": 1.0, "m": 60.0, "h": 3600.0}
_SIZE_SCALE = {"": 1, "k": 1 << 10, "m": 1 << 20, "g": 1 << 30}


def cfg_path() -> str:
    """Directory config files resolve against (FABRIC_CFG_PATH, else cwd)."""
    return os.environ.get(_CFG_ENV, ".")


def parse_bytesize(v) -> int:
    """'100 MB' / '16k' / 1024 -> bytes (viperutil byte-size hook)."""
    if isinstance(v, (int, float)):
        return int(v)
    m = _SIZE_RE.match(str(v))
    if not m:
        raise ValueError(f"not a byte size: {v!r}")
    return int(float(m.group(1)) * _SIZE_SCALE[m.group(2).lower()])


def parse_duration(v) -> float:
    """'250ms' / '5s' / '2m' / 1.5 -> seconds (time.Duration strings)."""
    if isinstance(v, (int, float)):
        return float(v)
    m = _DUR_RE.match(str(v))
    if not m:
        raise ValueError(f"not a duration: {v!r}")
    return float(m.group(1)) * _DUR_SCALE[m.group(2).lower()]


def resolve_file_ref(v, base_dir: str | None = None):
    """`file:relative/or/abs.pem` -> file contents (viperutil file: hook)."""
    if isinstance(v, str) and v.startswith("file:"):
        path = v[5:]
        if not os.path.isabs(path):
            path = os.path.join(base_dir or cfg_path(), path)
        with open(path, "rb") as f:
            return f.read()
    return v


def load_yaml(name: str, path: str | None = None) -> dict:
    """Load `<FABRIC_CFG_PATH>/<name>.yaml` (missing file -> {})."""
    p = path or os.path.join(cfg_path(), name + ".yaml")
    if not os.path.exists(p):
        return {}
    return yamlsub.load(p) or {}


def _env_overrides(prefix: str) -> dict[tuple[str, ...], str]:
    """CORE_PEER_LISTENADDRESS=... -> {("peer","listenaddress"): ...}."""
    out = {}
    pre = prefix.upper() + "_"
    for k, v in os.environ.items():
        if k.startswith(pre):
            out[tuple(k[len(pre):].lower().split("_"))] = v
    return out


class Config:
    """Nested config with case-insensitive dotted lookup and env
    overrides, mirroring viper's `GetString("peer.listenAddress")` +
    `CORE_PEER_LISTENADDRESS` behavior."""

    def __init__(self, data: dict | None = None, env_prefix: str = "CORE"):
        self._data = data or {}
        self._env = _env_overrides(env_prefix)

    @classmethod
    def load(cls, name: str, env_prefix: str, path: str | None = None) -> "Config":
        return cls(load_yaml(name, path), env_prefix)

    def get(self, dotted: str, default: Any = None) -> Any:
        keys = tuple(k.lower() for k in dotted.split("."))
        if keys in self._env:
            return self._env[keys]
        node: Any = self._data
        for k in keys:
            if not isinstance(node, dict):
                return default
            hit = None
            for kk, vv in node.items():
                if str(kk).lower() == k:
                    hit = vv
                    break
            else:
                return default
            node = hit
        return node

    def get_bool(self, dotted: str, default: bool = False) -> bool:
        v = self.get(dotted, default)
        if isinstance(v, str):
            return v.strip().lower() in ("1", "true", "yes", "on")
        return bool(v)

    def get_int(self, dotted: str, default: int = 0) -> int:
        v = self.get(dotted, default)
        return int(v)

    def get_duration(self, dotted: str, default: float = 0.0) -> float:
        v = self.get(dotted, None)
        return default if v is None else parse_duration(v)

    def get_bytesize(self, dotted: str, default: int = 0) -> int:
        v = self.get(dotted, None)
        return default if v is None else parse_bytesize(v)

    def get_file(self, dotted: str, default: bytes | None = None) -> bytes | None:
        v = self.get(dotted, None)
        if v is None:
            return default
        return resolve_file_ref(v)


__all__ = [
    "Config",
    "cfg_path",
    "load_yaml",
    "parse_bytesize",
    "parse_duration",
    "resolve_file_ref",
]
