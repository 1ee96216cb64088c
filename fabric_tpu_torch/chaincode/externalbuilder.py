"""External builders (the port's copy of
`fabric_tpu/chaincode/externalbuilder.py`; reference
core/container/externalbuilder/externalbuilder.go) — the docker-free
chaincode build/run path.

An external builder is a directory the operator provides with four
executables under `bin/`:

    detect  <ccsrc> <metadata-dir>            exit 0 = "I handle this"
    build   <ccsrc> <metadata-dir> <output>   compile into <output>
    release <build-output> <release-dir>      export metadata (optional)
    run     <build-output> <run-metadata-dir> launch; run-metadata holds
                                              chaincode.json with
                                              {chaincode_id, peer_address}

The detector walks the configured builders in order and uses the first
whose `detect` accepts the package (reference externalbuilder.go
CreateBuildContext/Detect).  The launched process connects back to the
peer's TCP chaincode listener (chaincode.support
TCPChaincodeListener), exactly like the reference's external chaincode
server flow.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import tarfile


class BuildError(Exception):
    pass


class ExternalBuilder:
    """One operator-provided builder directory."""

    def __init__(self, path: str, name: str | None = None,
                 propagate_environment: tuple[str, ...] = ("PATH", "HOME",
                                                           "TMPDIR")):
        self.path = path
        self.name = name or os.path.basename(path.rstrip("/"))
        self._env_keys = propagate_environment

    def _bin(self, tool: str) -> str | None:
        p = os.path.join(self.path, "bin", tool)
        return p if os.access(p, os.X_OK) else None

    def _env(self) -> dict:
        return {k: os.environ[k] for k in self._env_keys if k in os.environ}

    def _run_tool(self, tool: str, args: list[str],
                  check: bool = True) -> int:
        exe = self._bin(tool)
        if exe is None:
            raise BuildError(f"builder {self.name!r} has no {tool} binary")
        proc = subprocess.run(
            [exe] + args, env=self._env(), capture_output=True
        )
        if check and proc.returncode != 0:
            raise BuildError(
                f"{self.name}/{tool} failed ({proc.returncode}): "
                f"{proc.stderr.decode(errors='replace')[:500]}"
            )
        return proc.returncode

    def detect(self, ccsrc: str, metadata_dir: str) -> bool:
        exe = self._bin("detect")
        if exe is None:
            return False
        return self._run_tool("detect", [ccsrc, metadata_dir], check=False) == 0

    def build(self, ccsrc: str, metadata_dir: str, output_dir: str) -> None:
        self._run_tool("build", [ccsrc, metadata_dir, output_dir])

    def release(self, build_output: str, release_dir: str) -> None:
        if self._bin("release") is None:
            return  # optional, like the reference
        self._run_tool("release", [build_output, release_dir])

    def run(self, build_output: str, run_metadata_dir: str) -> subprocess.Popen:
        exe = self._bin("run")
        if exe is None:
            raise BuildError(f"builder {self.name!r} has no run binary")
        return subprocess.Popen(
            [exe, build_output, run_metadata_dir], env=self._env()
        )


class BuilderRegistry:
    """Detect/build/run across the configured builders, caching builds
    per package id (reference BuildRegistry in core/container)."""

    def __init__(self, builders: list[ExternalBuilder], build_root: str):
        self.builders = builders
        self.build_root = build_root
        os.makedirs(build_root, exist_ok=True)
        self._built: dict[str, tuple[ExternalBuilder, str]] = {}

    @staticmethod
    def _explode(package_bytes: bytes, dest: str) -> tuple[str, str]:
        """Unpack a .tar.gz chaincode package into src + metadata dirs.
        Members under a leading "src/" (the platforms.package_chaincode
        layout) are flattened into the src dir; flat members land there
        directly."""
        import io

        src = os.path.join(dest, "src")
        meta = os.path.join(dest, "metadata")
        os.makedirs(src, exist_ok=True)
        os.makedirs(meta, exist_ok=True)
        with tarfile.open(fileobj=io.BytesIO(package_bytes), mode="r:gz") as tf:
            for m in tf.getmembers():
                if not m.isfile():
                    continue
                name = os.path.normpath(m.name)
                if name.startswith(("..", "/")):
                    raise BuildError(f"unsafe path in package: {m.name}")
                if name == "metadata.json":
                    out = os.path.join(meta, "metadata.json")
                else:
                    rel = name.split(os.sep, 1)[1] if (
                        name.startswith("src" + os.sep)
                    ) else name
                    out = os.path.join(src, rel)
                os.makedirs(os.path.dirname(out), exist_ok=True)
                with tf.extractfile(m) as fsrc, open(out, "wb") as fdst:
                    shutil.copyfileobj(fsrc, fdst)
        return src, meta

    def build(self, package_id: str, package_bytes: bytes) -> tuple[ExternalBuilder, str]:
        """Returns (builder, build_output_dir); cached per package id."""
        if package_id in self._built:
            return self._built[package_id]
        work = os.path.join(self.build_root, package_id.replace(":", "_"))
        src, meta = self._explode(package_bytes, work)
        for b in self.builders:
            if b.detect(src, meta):
                out = os.path.join(work, "bld")
                os.makedirs(out, exist_ok=True)
                b.build(src, meta, out)
                release = os.path.join(work, "release")
                os.makedirs(release, exist_ok=True)
                b.release(out, release)
                self._built[package_id] = (b, out)
                return b, out
        raise BuildError(f"no builder detected package {package_id!r}")

    def run(self, package_id: str, package_bytes: bytes, chaincode_id: str,
            peer_address: str, auth_token: str) -> subprocess.Popen:
        """`auth_token` (ChaincodeSupport.issue_launch_token) rides in
        chaincode.json like the reference's launch-issued client
        key/cert pair does (externalbuilder writes client_cert/client_key
        there); the shim presents it in the listener handshake.  It is
        REQUIRED: the TCP listener refuses un-handshaked streams, so a
        token-less launch would silently never register.  The run dir
        and chaincode.json are owner-only — the token is the launch
        credential and must not be readable by other local users."""
        if not auth_token:
            raise ValueError(
                "auth_token is required: mint one with "
                "ChaincodeSupport.issue_launch_token(chaincode_id)"
            )
        builder, out = self.build(package_id, package_bytes)
        run_meta = os.path.join(
            self.build_root, package_id.replace(":", "_"), "run"
        )
        os.makedirs(run_meta, exist_ok=True)
        os.chmod(run_meta, 0o700)
        meta = {
            "chaincode_id": chaincode_id,
            "peer_address": peer_address,
            "auth_token": auth_token,
        }
        path = os.path.join(run_meta, "chaincode.json")
        fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
        with os.fdopen(fd, "w") as f:
            json.dump(meta, f)
        os.chmod(path, 0o600)  # pre-existing file: tighten regardless
        return builder.run(out, run_meta)


__all__ = ["ExternalBuilder", "BuilderRegistry", "BuildError"]
