"""The port's batched SHA-256 (B4, fabric_tpu_torch/csp/cuda/sha256.py)
held against the JAX package's and hashlib, exactly.

The same messages go through both packages: the padding helpers, the
plain PyTorch version against the JAX `sha256_kernel` on the same padded
words, the CUDA kernel's own source (csrc/sha256.cuh) built for the host
by g++ on the kernel's raw-buffer layout, and `CUDACSP.hash_batch` on the
CPU: its routing rule, hashlib below `min_device_batch` and for narrow
batches, the plain version for wide ones and across the 8192-message
launch limit.  The cases are those of tests/test_csp_tpu.py::test_hash_batch_parity
(37 seeded random messages, the empty message and the 55/56/64/119/120-byte
padding edges) and a mixed-length batch.
"""

import pytest

torch = pytest.importorskip("torch")

import ctypes  # noqa: E402
import hashlib  # noqa: E402
import random  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

from fabric_tpu.csp.tpu import sha256 as jsha  # noqa: E402
from fabric_tpu_torch.csp.cuda import provider as prov  # noqa: E402
from fabric_tpu_torch.csp.cuda import sha256 as sha  # noqa: E402
from fabric_tpu_torch.csp.cuda.provider import CUDACSP  # noqa: E402

CSRC = Path(sha.__file__).resolve().parent / "csrc"


def _parity_cases():
    rng = random.Random(3)
    msgs = [bytes(rng.randrange(256) for _ in range(rng.randrange(0, 200)))
            for _ in range(37)]
    return msgs + [b"", b"a" * 55, b"a" * 56, b"a" * 64, b"a" * 119,
                   b"a" * 120]


def _mixed_cases():
    """Lengths around every padding edge up to three blocks, in a
    shuffled order, so that messages of 1, 2 and 3 blocks share a batch."""
    rng = np.random.default_rng(4)
    lens = [0, 1, 54, 55, 56, 57, 63, 64, 65, 118, 119, 120, 121, 127, 128,
            129, 183, 184, 191, 192]
    rng.shuffle(lens)
    return [rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in lens]


CASES = {"parity": _parity_cases, "mixed": _mixed_cases}


def _hashlib(msgs):
    return [hashlib.sha256(m).digest() for m in msgs]


@pytest.mark.parametrize("case", sorted(CASES))
def test_pad_messages_and_digest_to_bytes_match_jax(case):
    msgs = CASES[case]()
    for n_blocks in (None, 4):
        got_w, got_n = sha.pad_messages(msgs, n_blocks)
        want_w, want_n = jsha.pad_messages(msgs, n_blocks)
        assert got_w.dtype == want_w.dtype and got_n.dtype == want_n.dtype
        np.testing.assert_array_equal(got_w, want_w)
        np.testing.assert_array_equal(got_n, want_n)
    with pytest.raises(ValueError, match="blocks"):
        sha.pad_messages([bytes(200)], 1)
    words = np.random.default_rng(5).integers(0, 2**32, (len(msgs), 8),
                                              dtype=np.uint32)
    assert sha.digest_to_bytes(words) == jsha.digest_to_bytes(words)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_jax_kernel(case):
    """sha256_plain and the JAX sha256_kernel on the same padded words,
    word for word, at the exact width and padded to a wider one (frozen
    lanes); both equal hashlib."""
    msgs = CASES[case]()
    for n_blocks in (None, 5):
        words, nblk = sha.pad_messages(msgs, n_blocks)
        want = np.asarray(jsha._jit_sha()(words, nblk))
        got = sha.sha256_plain(torch.from_numpy(words.astype(np.int64)),
                               torch.from_numpy(nblk))
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
        assert sha.digest_to_bytes(got.numpy()) == _hashlib(msgs)


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """The kernel's source as it ships, built for the host by g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the kernel source for the host")
    out = tmp_path_factory.mktemp("sha256host") / "libsha256host.so"
    subprocess.run(
        [gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-o", str(out),
         str(CSRC / "sha256_host_check.cpp")],
        check=True, capture_output=True, text=True,
    )
    lib = ctypes.CDLL(str(out))
    vp = ctypes.c_void_p
    lib.sha256_host_digests.argtypes = [vp, vp, ctypes.c_int, vp]
    lib.sha256_host_digests.restype = None
    return lib


def _host_digests(lib, buf: np.ndarray, offs: np.ndarray) -> list[bytes]:
    n = len(offs) - 1
    out = np.zeros((n, 32), np.uint8)
    lib.sha256_host_digests(ctypes.c_void_p(buf.ctypes.data),
                            ctypes.c_void_p(offs.ctypes.data), n,
                            ctypes.c_void_p(out.ctypes.data))
    return [row.tobytes() for row in out]


@pytest.mark.parametrize("case", sorted(CASES))
def test_host_built_kernel_source_matches_hashlib(case, host_lib):
    """sha256.cuh on the kernel's layout: the messages concatenated with
    their offsets, then the same buffer behind a 3-byte prefix (messages
    at odd addresses, offsets not from 0), and a 70,000-byte message."""
    msgs = CASES[case]() + [bytes(range(256)) * 273 + b"x" * 112]
    buf, offs = sha.join_messages(msgs)
    assert _host_digests(host_lib, buf.copy(), offs) == _hashlib(msgs)
    shifted = np.concatenate([np.full(3, 0xEE, np.uint8), buf])
    assert _host_digests(host_lib, shifted, offs + 3) == _hashlib(msgs)


def test_wrapper_on_cpu_runs_the_plain_version_on_the_raw_layout():
    msgs = _mixed_cases()
    buf, offs = sha.join_messages(msgs)
    shifted = torch.from_numpy(np.concatenate([np.zeros(5, np.uint8), buf]))
    got = sha.sha256_digests(shifted, torch.from_numpy(offs + 5))
    assert got.dtype == torch.uint8 and tuple(got.shape) == (len(msgs), 32)
    assert [bytes(r) for r in got.numpy()] == _hashlib(msgs)
    assert sha.launches_sha256 == 0  # the plain version is no launch
    with pytest.raises(ValueError, match="offsets"):
        sha.sha256_digests(torch.from_numpy(buf.copy()),
                           torch.from_numpy(offs + 1))
    with pytest.raises(ValueError, match="uint8"):
        sha.sha256_digests(torch.zeros(4, dtype=torch.int32),
                           torch.zeros(1, dtype=torch.int64))


def test_wrapper_refuses_other_devices():
    """A buffer off the CPU and the card is refused, and so are offsets
    off the host: the wrapper checks them there before anything runs."""
    with pytest.raises(ValueError, match="unsupported device"):
        sha.sha256_digests(torch.zeros(4, dtype=torch.uint8, device="meta"),
                           torch.zeros(2, dtype=torch.int64))
    with pytest.raises(ValueError, match="on the host"):
        sha.sha256_digests(torch.zeros(4, dtype=torch.uint8),
                           torch.zeros(2, dtype=torch.int64, device="meta"))


def _short_messages(n: int, seed: int = 7) -> list[bytes]:
    """n messages of 0-55 bytes: one compression each."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, 56, n)
    raw = rng.integers(0, 256, int(lens.sum()), dtype=np.uint8).tobytes()
    ends = np.cumsum(lens)
    return [raw[e - n_:e] for e, n_ in zip(ends, lens)]


def _wide_batch() -> list[bytes]:
    """The parity cases (up to 4 compressions) among enough one-block
    messages for the card route: 1,800 compressions in all."""
    msgs = _short_messages(1800 - 91) + _parity_cases()
    assert sum((len(m) + 72) >> 6 for m in msgs) == 1800
    return msgs


def test_hash_on_card_rule():
    """The card takes a batch from min_device_batch messages up, and only
    where its compressions reach HASH_WIDTH times the longest message's
    plus HASH_FIXED; the callers' shapes (a transaction's endorsement
    messages, a snapshot's five files) stay on hashlib, and so do a few
    long messages however many there are over min_device_batch."""
    width, fixed = prov.HASH_WIDTH, prov.HASH_FIXED
    on_card = prov.hash_on_card
    assert not on_card([bytes(1500)] * 3)
    assert not on_card([bytes(n) for n in (23898, 0, 0, 2411560, 79800)])
    assert not on_card([bytes(1 << 20)] * 32)
    assert not on_card([bytes(1 << 20)] * width)
    assert on_card([bytes(1 << 20)] * (width + 1))  # 16385 x 193 >= +1024
    assert not on_card([b""] * (width + fixed - 1))
    assert on_card([b""] * (width + fixed))
    # 119 bytes take two compressions, the longest: 2 x width + fixed
    edge = [bytes(119)] + [b""] * (2 * width + fixed - 2)
    assert on_card(edge) and not on_card(edge[:-1])
    assert not on_card(edge, min_device_batch=len(edge) + 1)
    assert not on_card([])


def test_hash_batch_matches_hashlib_and_jax(monkeypatch):
    """Below min_device_batch, and from it up where the batch is too
    narrow for the card, hashlib answers and the hash path is not
    entered; a wide batch goes to the plain version; all equal hashlib
    and the JAX package's sha256_batch."""
    calls = []
    real = sha.sha256_digests

    def recording(buf, offs):
        calls.append(offs.numel() - 1)
        return real(buf, offs)

    monkeypatch.setattr(sha, "sha256_digests", recording)
    csp = CUDACSP(device="cpu")
    msgs = _parity_cases()
    assert csp.hash_batch(msgs[:15]) == _hashlib(msgs[:15])
    assert csp.hash_batch(msgs) == _hashlib(msgs)
    assert calls == []
    wide = _wide_batch()
    assert csp.hash_batch(wide) == _hashlib(wide) == jsha.sha256_batch(wide)
    assert calls == [len(wide)]
    few = CUDACSP(device="cpu", min_device_batch=len(wide) + 1)
    assert few.hash_batch(wide) == _hashlib(wide)
    assert calls == [len(wide)]
    assert csp.hash_batch([]) == []


def test_hash_batch_across_the_launch_limit(monkeypatch):
    """Two full launches and a tail (16,389 messages of 0-40 bytes):
    every digest in its place."""
    chunks = []
    real = sha._digests_plain

    def recording(buf, offs):
        chunks.append(offs.numel() - 1)
        return real(buf, offs)

    monkeypatch.setattr(sha, "_digests_plain", recording)
    rng = np.random.default_rng(6)
    n = 2 * sha.MAX_LAUNCH + 5
    lens = rng.integers(0, 41, n)
    raw = rng.integers(0, 256, int(lens.sum()), dtype=np.uint8).tobytes()
    ends = np.cumsum(lens)
    msgs = [raw[e - n_:e] for e, n_ in zip(ends, lens)]
    got = CUDACSP(device="cpu").hash_batch(msgs)
    assert chunks == [sha.MAX_LAUNCH, sha.MAX_LAUNCH, 5]
    assert got == _hashlib(msgs)


def test_hash_batch_has_no_hashlib_fallback(monkeypatch):
    """A hash kernel that fails at run time has hashlib answer, as
    TPUCSP.hash_batch does: the digests are hashlib's, the breaker counts
    the failure, and the messages are counted.  A build failure still
    raises, and hashlib does not answer in its place."""
    from fabric_tpu_torch.csp.cuda import build

    def broken(buf, offs):
        raise RuntimeError("sha256 kernel launch failed")

    msgs = _wide_batch()
    monkeypatch.setattr(sha, "sha256_digests", broken)
    csp = CUDACSP(device="cpu", breaker_threshold=3)
    assert csp.hash_batch(msgs) == _hashlib(msgs)
    assert (csp.breaker.open, csp.breaker._consecutive) == (False, 1)
    assert csp.degraded_stats()["host_hashes"] == len(msgs)

    def unbuildable(buf, offs):
        raise build.KernelBuildError("nvcc failed: sha256.cu")

    class NoHashlib:
        @staticmethod
        def sha256(data=b""):
            raise AssertionError("hashlib answered")

    monkeypatch.setattr(sha, "sha256_digests", unbuildable)
    monkeypatch.setattr(prov, "hashlib", NoHashlib)
    with pytest.raises(build.KernelBuildError, match="nvcc failed"):
        csp.hash_batch(msgs)
    assert csp.breaker._consecutive == 1  # the build error is not counted


@pytest.fixture(autouse=True, scope="module")
def _port_watch_gate():
    """The port's lockwatch ledgers are empty and its workers drained at
    the end of this file (the session's own gate watches the JAX
    package's module only)."""
    yield
    from fabric_tpu_torch.common import workpool as _pool
    from fabric_tpu_torch.devtools import lockwatch as _watch

    _pool.shutdown()
    assert not _watch.drain_threads(timeout=15.0)
    assert not _watch.violations and not _watch.thread_violations
