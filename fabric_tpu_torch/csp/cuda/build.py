"""Build and bind the CUDA kernels of the port.

Each `csrc/*.cu` source is compiled by `nvcc` at first use into a shared
library with a plain C interface, under `build/<name>-<hash>/` beside
this file, where the hash covers that source, the headers it includes,
the flags and the compiler path: a changed source builds anew, an
unchanged one loads, and one source's change leaves the others' builds
in place.  The libraries are bound with `ctypes`.  The sources that need
a build compile in parallel, one `nvcc` each.  On a host without `nvcc`,
when a build fails, or when a built library will not load, this raises
`KernelBuildError` with the compiler's or the loader's output: there is
no fallback, and the CSP's degraded mode, which counts runtime device
faults, lets it through.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"

# the kernels' translation units; headers are hashed, not compiled
SOURCES = ("p256_verify.cu", "bn254_commit.cu", "sha256.cu")
# a measurement probe of the P-256 field, built apart (load_probe)
PROBE = "p256_field_probe.cu"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, spills and shared memory, into the log
)

_DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"

_VOID = ctypes.c_void_p
_INT = ctypes.c_int

# C signatures of the entry points, by library
_SIGNATURES = {
    "p256_verify": {
        "p256_verify_keytab": ([_VOID] * 9 + [_INT, _VOID], _INT),
        "p256_verify_lanekeys": ([_VOID] * 8 + [_INT, _VOID], _INT),
        "p256_error_string": ([_INT], ctypes.c_char_p),
    },
    "bn254_commit": {
        "bn254_commitments": (
            [_VOID] * 4 + [_INT] + [_VOID] * 2 + [_INT] + [_VOID] * 2
            + [_INT, _VOID],
            _INT,
        ),
        "bn254_error_string": ([_INT], ctypes.c_char_p),
    },
    "sha256": {
        "sha256_digests": ([_VOID, _VOID, _INT, _VOID, _VOID], _INT),
        "sha256_error_string": ([_INT], ctypes.c_char_p),
    },
}

_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)


class KernelBuildError(RuntimeError):
    """A kernel's library could not be built or loaded (no nvcc, a
    compile error, a library that will not load or lacks a symbol).  Never
    a device failure: no breaker counts it and no host path answers in
    its place."""


class Launch:
    """A prepared kernel launch: a call launches it once, with the
    arguments it was prepared with, and returns the CUDA error code.  It
    holds the tensors whose addresses those arguments pass, so their
    memory lives as long as the launch does."""

    def __init__(self, fn, args, tensors):
        self._fn = fn
        self._args = tuple(args)
        self._tensors = tuple(tensors)

    def __call__(self) -> int:
        return self._fn(*self._args)


_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_logs: dict[str, str] = {}
_seconds: dict[str, float] = {}


def find_nvcc() -> str | None:
    """`$CUDA_HOME/bin/nvcc`, else `nvcc` on PATH, else the toolkit's
    default location; None when none exists."""
    home = os.environ.get("CUDA_HOME")
    for cand in (
        os.path.join(home, "bin", "nvcc") if home else None,
        shutil.which("nvcc"),
        _DEFAULT_NVCC,
    ):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    return None


def _build_key(src: str, nvcc: str) -> str:
    """Hash of a source, the csrc headers it includes (transitively), the
    flags and the compiler."""
    texts: dict[str, bytes] = {}
    todo = [src]
    while todo:
        name = todo.pop()
        if name in texts or not (CSRC / name).is_file():
            continue
        texts[name] = (CSRC / name).read_bytes()
        todo.extend(_INCLUDE.findall(texts[name].decode()))
    h = hashlib.sha256()
    for name in sorted(texts):
        h.update(name.encode())
        h.update(texts[name])
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(nvcc.encode())
    return h.hexdigest()[:16]


def build_all() -> dict[str, Path]:
    """Compile every source whose library is missing, all at once; returns
    {name: library path}.  Raises KernelBuildError without nvcc or when a
    compile fails (with its output)."""
    nvcc = find_nvcc()
    if nvcc is None:
        raise KernelBuildError(
            "nvcc not found ($CUDA_HOME/bin, PATH, /usr/local/cuda/bin): "
            "the CUDA kernels cannot be built on this host"
        )
    paths = {}
    running = []
    t0 = time.perf_counter()
    for src in SOURCES:
        name = Path(src).stem
        out_dir = BUILD_DIR / f"{name}-{_build_key(src, nvcc)}"
        paths[name] = out_dir / f"lib{name}.so"
        if paths[name].exists():
            log = out_dir / f"{name}.log"
            _logs.setdefault(name, log.read_text() if log.exists() else "")
            continue
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out_dir / f"lib{name}.{os.getpid()}.tmp.so"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        running.append((name, tmp, cmd, proc))
    failed = []
    for name, tmp, cmd, proc in running:
        log, _ = proc.communicate()
        _seconds[name] = time.perf_counter() - t0
        _logs[name] = log
        (paths[name].parent / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"$ {' '.join(cmd)}\n{log}")
            continue
        os.replace(tmp, paths[name])
    if failed:
        raise KernelBuildError("nvcc failed:\n" + "\n".join(failed))
    return paths


def load(name: str = "p256_verify") -> ctypes.CDLL:
    """The bound library of `csrc/<name>.cu`, built at first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = build_all()[name]
            try:
                lib = ctypes.CDLL(str(path))
                for fn, (args, res) in _SIGNATURES[name].items():
                    getattr(lib, fn).argtypes = args
                    getattr(lib, fn).restype = res
            except (OSError, AttributeError) as e:
                raise KernelBuildError(f"{path} does not load: {e}") from e
            _libs[name] = lib
        return lib


def load_probe() -> tuple[ctypes.CDLL, Path]:
    """The P-256 field probe (`csrc/p256_field_probe.cu`, a measurement
    tool, not a kernel of the verify), built at first use; returns the
    bound library and its path (for `sass`).  Cached by the probe, the
    headers it includes, the flags and the compiler; raises as
    `build_all` does."""
    nvcc = find_nvcc()
    if nvcc is None:
        raise KernelBuildError("nvcc not found: the field probe cannot be "
                               "built")
    out = BUILD_DIR / f"p256_field_probe-{_build_key(PROBE, nvcc)}"
    path = out / "libp256_field_probe.so"
    with _lock:
        if not path.exists():
            out.mkdir(parents=True, exist_ok=True)
            tmp = out / f"probe.{os.getpid()}.tmp.so"
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / PROBE)]
            proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
            if proc.returncode != 0:
                raise KernelBuildError(f"nvcc failed:\n$ {' '.join(cmd)}\n"
                                       f"{proc.stdout}")
            os.replace(tmp, path)
        try:
            lib = ctypes.CDLL(str(path))
            probe = lib.p256_field_probe
        except (OSError, AttributeError) as e:
            raise KernelBuildError(f"{path} does not load: {e}") from e
    probe.argtypes = [_INT] + [_VOID] * 3 + [_INT] * 3 + [_VOID]
    probe.restype = _INT
    return lib, path


def sass(path: Path) -> dict[str, list[str]]:
    """The SASS of every kernel in the built library `path`, by
    `cuobjdump -sass` (beside nvcc): {mangled name: ["/*addr*/ OPCODE
    operands ;", ...]}.  Raises when cuobjdump is missing or fails."""
    nvcc = find_nvcc()
    tool = Path(nvcc).parent / "cuobjdump" if nvcc else None
    if tool is None or not tool.is_file():
        raise RuntimeError("cuobjdump not found beside nvcc")
    proc = subprocess.run([str(tool), "-sass", str(path)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"cuobjdump failed: {proc.stderr}")
    out: dict[str, list[str]] = {}
    name = None
    for line in proc.stdout.splitlines():
        m = re.match(r"\s*Function\s*:\s*(\S+)", line)
        if m:
            name = m.group(1)
            out[name] = []
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?;)", line)
        if m and name is not None:
            out[name].append(f"/*{m.group(1)}*/ {m.group(2).strip()}")
    return out


def build_log(name: str = "p256_verify") -> str:
    """The compiler's output (with -Xptxas -v) of the last build of
    `name` in this process, or of the cached build it loaded."""
    return _logs.get(name, "")


def build_seconds(name: str = "p256_verify") -> float | None:
    """Wall seconds of this process's compile of `name`; None when the
    library came from the build cache."""
    return _seconds.get(name)


__all__ = ["KernelBuildError", "build_all", "load", "load_probe", "sass",
           "find_nvcc", "build_log", "build_seconds"]
