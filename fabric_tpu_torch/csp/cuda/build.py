"""Build and bind the CUDA kernels of the port.

Each `csrc/*.cu` source is compiled by `nvcc` at first use into a shared
library with a plain C interface, under `build/<hash>/` beside this
file, where the hash covers every source and header, the flags and the
compiler path: a changed source builds anew, an unchanged one loads.
The libraries are bound with `ctypes`.  All sources compile in parallel,
one `nvcc` each.  On a host without `nvcc`, or when a build fails, this
raises with the compiler's output: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"

# the kernels' translation units; headers are hashed, not compiled
SOURCES = ("p256_verify.cu",)

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
}

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


def _build_key(nvcc: str) -> str:
    h = hashlib.sha256()
    for path in sorted(CSRC.iterdir()):
        if path.suffix in (".cu", ".cuh", ".h"):
            h.update(path.name.encode())
            h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(nvcc.encode())
    return h.hexdigest()[:16]


def build_all() -> dict[str, Path]:
    """Compile every source whose library is missing, all at once; returns
    {name: library path}.  Raises RuntimeError without nvcc or when a
    compile fails (with its output)."""
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found ($CUDA_HOME/bin, PATH, /usr/local/cuda/bin): "
            "the CUDA kernels cannot be built on this host"
        )
    out_dir = BUILD_DIR / _build_key(nvcc)
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = {Path(s).stem: out_dir / f"lib{Path(s).stem}.so" for s in SOURCES}
    running = []
    t0 = time.perf_counter()
    for src in SOURCES:
        name = Path(src).stem
        if paths[name].exists():
            log = out_dir / f"{name}.log"
            _logs.setdefault(name, log.read_text() if log.exists() else "")
            continue
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
        (out_dir / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"$ {' '.join(cmd)}\n{log}")
            continue
        os.replace(tmp, paths[name])
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return paths


def load(name: str = "p256_verify") -> ctypes.CDLL:
    """The bound library of `csrc/<name>.cu`, built at first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_all()[name]))
            for fn, (args, res) in _SIGNATURES[name].items():
                getattr(lib, fn).argtypes = args
                getattr(lib, fn).restype = res
            _libs[name] = lib
        return lib


def build_log(name: str = "p256_verify") -> str:
    """The compiler's output (with -Xptxas -v) of the last build of
    `name` in this process, or of the cached build it loaded."""
    return _logs.get(name, "")


def build_seconds(name: str = "p256_verify") -> float | None:
    """Wall seconds of this process's compile of `name`; None when the
    library came from the build cache."""
    return _seconds.get(name)


__all__ = ["build_all", "load", "find_nvcc", "build_log", "build_seconds"]
