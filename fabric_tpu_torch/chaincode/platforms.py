"""Chaincode platforms: language packagers (the port's copy of
`fabric_tpu/chaincode/platforms.py`; reference
core/chaincode/platforms/{golang,java,node}).

Each platform validates a source tree and produces the install package
format the lifecycle expects — a .tar.gz with `metadata.json`
({"label", "type", "path"}) plus the source files (reference
persistence/chaincode_package.go layout; the reference nests a second
code.tar.gz, which this build flattens — the package store and
external builders consume files directly).

Platforms here:
- `python`: chaincode as a python module (the in-process and external
  shim runtime); entrypoint `main.py` or any `*.py` tree.
- `external`: chaincode-as-a-service — only metadata + optional
  connection.json travel (reference externalbuilder asset flow).
"""

from __future__ import annotations

import io
import json
import os
import tarfile


class PlatformError(Exception):
    pass


class PythonPlatform:
    name = "python"

    def validate(self, files: dict[str, bytes]) -> None:
        if not any(f.endswith(".py") for f in files):
            raise PlatformError("python chaincode needs at least one .py file")


class ExternalPlatform:
    name = "external"

    def validate(self, files: dict[str, bytes]) -> None:
        if "connection.json" in files:
            try:
                json.loads(files["connection.json"])
            except ValueError as exc:
                raise PlatformError(f"bad connection.json: {exc}") from exc


_PLATFORMS = {p.name: p for p in (PythonPlatform(), ExternalPlatform())}


def platform(cc_type: str):
    p = _PLATFORMS.get(cc_type.lower())
    if p is None:
        raise PlatformError(
            f"unknown chaincode type {cc_type!r} "
            f"(have: {sorted(_PLATFORMS)})"
        )
    return p


def package_chaincode(src_path: str, label: str, cc_type: str = "python") -> bytes:
    """Build an install package from a source directory (the
    `peer lifecycle chaincode package` operation)."""
    if not label or any(c.isspace() for c in label):
        raise PlatformError(f"invalid label {label!r}")
    files: dict[str, bytes] = {}
    if os.path.isfile(src_path):
        with open(src_path, "rb") as f:
            files[os.path.basename(src_path)] = f.read()
    else:
        for root, _, names in os.walk(src_path):
            for n in sorted(names):
                full = os.path.join(root, n)
                rel = os.path.relpath(full, src_path)
                with open(full, "rb") as f:
                    files[rel] = f.read()
    platform(cc_type).validate(files)

    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w:gz") as tf:
        meta = json.dumps(
            {"label": label, "type": cc_type, "path": src_path}
        ).encode()
        ti = tarfile.TarInfo("metadata.json")
        ti.size = len(meta)
        tf.addfile(ti, io.BytesIO(meta))
        for rel in sorted(files):
            ti = tarfile.TarInfo(os.path.join("src", rel))
            ti.size = len(files[rel])
            tf.addfile(ti, io.BytesIO(files[rel]))
    return buf.getvalue()


def parse_package(pkg: bytes) -> tuple[dict, dict[str, bytes]]:
    """Install package -> (metadata, {relative path: content})."""
    meta: dict = {}
    files: dict[str, bytes] = {}
    with tarfile.open(fileobj=io.BytesIO(pkg), mode="r:gz") as tf:
        for m in tf.getmembers():
            if not m.isfile():
                continue
            name = os.path.normpath(m.name)
            if name.startswith(("..", "/")):
                raise PlatformError(f"unsafe path in package: {m.name}")
            data = tf.extractfile(m).read()
            if name == "metadata.json":
                meta = json.loads(data)
            elif name.startswith("src" + os.sep) or name.startswith("src/"):
                files[name.split(os.sep, 1)[1] if os.sep in name
                      else name.split("/", 1)[1]] = data
    if not meta.get("label"):
        raise PlatformError("package has no metadata.json label")
    return meta, files


__all__ = [
    "PlatformError",
    "PythonPlatform",
    "ExternalPlatform",
    "platform",
    "package_chaincode",
    "parse_package",
]
