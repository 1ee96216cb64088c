"""The port stands alone: no JAX, nothing of the JAX package, no
`cryptography` or `protobuf`; the card by default, and no silent CPU or
build fallback.

The import check runs in a subprocess: tests/conftest.py imports jax for
the whole session.
"""

import pytest

torch = pytest.importorskip("torch")

import ast  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

from fabric_tpu_torch.csp.cuda import build  # noqa: E402
from fabric_tpu_torch.csp.cuda import p256_kernel as pk  # noqa: E402
from fabric_tpu_torch.csp.cuda.provider import CUDACSP  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "fabric_tpu_torch"
SMOKE = ROOT / "chip_smoke.py"
FORBIDDEN = ("jax", "jaxlib", "fabric_tpu", "cryptography", "google.protobuf")

_BLOCKED_RUN = """
import sys
for name in ("jax", "jaxlib", "fabric_tpu", "cryptography", "google.protobuf"):
    sys.modules[name] = None
import importlib, pkgutil
import fabric_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(
    fabric_tpu_torch.__path__, "fabric_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
import chip_smoke
import numpy as np
from fabric_tpu_torch.csp import hostref
from fabric_tpu_torch.csp.api import VerifyBatchItem
from fabric_tpu_torch.csp.cuda.provider import CUDACSP
rng = np.random.default_rng(1)
key = hostref.key_gen(rng)
items = []
for i in range(3):
    d = bytes([i]) * 32
    items.append(VerifyBatchItem(key.public_key(), d, hostref.sign(key, d, rng)))
items[1] = VerifyBatchItem(items[1].key, bytes(32), items[1].signature)
mask = CUDACSP(device="cpu", min_device_batch=1).verify_batch(items)
assert mask == [True, False, True], mask
assert not any(k == "jax" or k.startswith(("jax.", "fabric_tpu."))
               for k, v in sys.modules.items() if v is not None)
print("modules", len(mods))
"""


def _port_files():
    return sorted(PORT.rglob("*.py")) + [SMOKE]


def test_port_imports_and_verifies_without_jax():
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_RUN], cwd=ROOT,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "modules" in proc.stdout
    assert int(proc.stdout.split()[-1]) >= 10


def _imported(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_file_of_the_port_imports_forbidden_modules():
    bad = []
    for path in _port_files():
        for name in _imported(path):
            if any(name == f or name.startswith(f + ".") for f in FORBIDDEN):
                bad.append(f"{path.relative_to(ROOT)}: {name}")
    assert not bad, bad


def test_cudacsp_defaults_to_the_card_and_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CUDACSP()
    with pytest.raises(ValueError):
        CUDACSP(device="meta")


def test_build_raises_without_nvcc(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "_DEFAULT_NVCC", str(tmp_path / "nvcc"))
    monkeypatch.setattr(build, "_libs", {})
    assert build.find_nvcc() is None
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.load()
    assert build._libs == {}


def test_build_reports_compiler_failure(tmp_path, monkeypatch):
    """A failing nvcc raises with its output; nothing is cached."""
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: no card here' >&2\nexit 2\n")
    fake.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path.parent / "none"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "_libs", {})
    with pytest.raises(RuntimeError, match="no card here"):
        build.load()
    assert build._libs == {}
    assert not list((tmp_path / "build").rglob("*.so"))


def test_wrapper_refuses_other_devices():
    t = {k: torch.zeros((8, 4), dtype=torch.int32, device="meta")
         for k in ("qx", "qy", "d1", "d2", "cand0")}
    t["flags"] = torch.zeros((2, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        pk.verify_packed(t)


def test_chip_smoke_fails_without_a_card(tmp_path):
    """No result without CUDA, from the repo and from a directory that
    holds chip_smoke.py alone."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(SMOKE, alone / "chip_smoke.py")
    for cwd in (ROOT, alone):
        proc = subprocess.run(
            [sys.executable, "chip_smoke.py"], cwd=cwd,
            capture_output=True, text=True, timeout=300,
        )
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout
