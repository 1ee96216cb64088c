"""The port's C++ host library (fabric_tpu_torch/native) held against its
plain versions and the JAX package's library, exactly.

- The signature packer (`marshal.cc`): the port's `marshal_batch` against
  the JAX package's `fabric_tpu.native.marshal_batch` on the same
  buffers, and the provider's packing of items (`p256_kernel.pack_items`)
  against the numpy `prepare_packed`, array for array, on the corpus of
  tests/test_torch_p256.py (malformed DER, high-S, r >= n, the r + n < p
  branch, digests of the wrong length, off-curve and zero keys).
  `CUDACSP(device="cpu")`'s verdicts on that corpus against `TPUCSP`'s
  are in tests/test_torch_provider.py, beside the other TPUCSP
  comparison (one compile of the JAX kernel serves both).
- BN254 (`bn254.cc`, `pairing.cc`): MSM, independent multiplications and
  the pairing check against the port's pure-Python functions and the JAX
  package's library, on the cases of tests/test_bn254_native.py.
- The build: one library however many processes build it at once, and
  no fallback where it cannot build (the JAX package falls back to
  Python there).
"""

import pytest

torch = pytest.importorskip("torch")

import random  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402
from test_torch_p256 import corpus  # noqa: E402,F401

from fabric_tpu import native as jnative  # noqa: E402
from fabric_tpu_torch import native  # noqa: E402
from fabric_tpu_torch.csp import api  # noqa: E402
from fabric_tpu_torch.csp.api import VerifyBatchItem  # noqa: E402
from fabric_tpu_torch.csp.cuda import p256_kernel as pk  # noqa: E402
from fabric_tpu_torch.idemix import bn254 as bn  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", autouse=True)
def _built():
    """The port's library, built (or loaded) once for the module."""
    native.load()


def _items(lanes):
    return [VerifyBatchItem(api.P256PublicKey(x, y), d, der)
            for x, y, d, der in lanes]


# -- the packer ---------------------------------------------------------------


def test_marshal_batch_matches_jax_native(corpus):
    """The same buffers through both libraries: every array equal (a
    digest of the wrong length goes in zeroed, as both providers send
    it)."""
    if not jnative.available():
        pytest.skip("the JAX package's native library is unavailable")
    _, lanes, _ = corpus
    sigs = [der for *_, der in lanes]
    args = (
        b"".join(x.to_bytes(32, "big") for x, *_ in lanes),
        b"".join(y.to_bytes(32, "big") for _, y, *_ in lanes),
        b"".join(d if len(d) == 32 else bytes(32) for _, _, d, _ in lanes),
        b"".join(sigs),
        np.cumsum([0] + [len(s) for s in sigs]).astype(np.int32),
    )
    got, want = native.marshal_batch(*args), jnative.marshal_batch(*args)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_pack_items_matches_prepare_packed(corpus):
    """The provider's packing through the C++ packer equals the numpy
    plain version on every lane, the wrong-length digests' lanes too
    (both pack them as invalid lanes)."""
    names, lanes, _ = corpus
    items = _items(lanes)
    got = pk.pack_items(items)
    want = pk.prepare_packed(pk.lane_tuples(items))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    bad_digest = [n for n, lane in zip(names, lanes) if len(lane[2]) != 32]
    assert len(bad_digest) >= 2
    assert not any(got["valid"][names.index(n)] for n in bad_digest)
    # a private key stands for its point
    key = api.P256PrivateKey(7, api.P256PublicKey(*pk.hostref.mul_g(7)))
    priv = pk.pack_items([VerifyBatchItem(key, lanes[0][2], lanes[0][3])])
    pub = pk.pack_items([VerifyBatchItem(key.public_key(), lanes[0][2],
                                         lanes[0][3])])
    for k in pub:
        np.testing.assert_array_equal(priv[k], pub[k], err_msg=k)


def test_marshal_batch_rejects_short_buffers():
    with pytest.raises(ValueError, match="32 bytes"):
        native.marshal_batch(bytes(32), bytes(32), bytes(31), b"",
                             np.zeros(2, np.int32))
    with pytest.raises(ValueError, match="offsets"):
        native.marshal_batch(bytes(32), bytes(32), bytes(32), b"\x30",
                             np.array([0, 2], np.int32))


# -- BN254 --------------------------------------------------------------------

RNG_SEED = 99


def _rand_points(rng, n):
    return [bn._g1_mul_py(bn.G1_GEN, bn.rand_zr(rng)) for _ in range(n)]


def _msm_cases(rng):
    """(points, scalars, expected) from the pure-Python MSM."""
    pts = _rand_points(rng, 6)
    ks = [bn.rand_zr(rng) for _ in range(6)]
    p = pts[0]
    cases = [(pts, ks)]
    cases += [([p], [k]) for k in (0, 1, bn.R - 1, bn.R, bn.R + 5, -3)]
    cases += [([p, bn.g1_neg(p)], [7, 7]),  # cancels to infinity
              ([None, p], [3, 2]),  # an infinity input is skipped
              ([], []),
              ([p, p], [3, 3]),  # the doubling chain
              ([p], [2])]
    return [(pt, k, bn._g1_msm_py(list(zip(pt, k)))) for pt, k in cases]


def test_bn254_msm_matches_python_and_jax_native():
    rng = random.Random(RNG_SEED)
    for pts, ks, want in _msm_cases(rng):
        got = native.bn254_msm(pts, ks)
        assert got == want, (pts, ks)
        assert bn.g1_msm(list(zip(pts, ks))) == want
        if jnative.available():
            assert jnative.bn254_msm(pts, ks) == want
    p = _rand_points(rng, 1)[0]
    assert native.bn254_msm([p], [2]) == bn.g1_add(p, p)
    assert native.bn254_msm([p, bn.g1_neg(p)], [7, 7]) is None


def test_bn254_mul_many_matches_python_and_jax_native():
    rng = random.Random(RNG_SEED + 1)
    pts = _rand_points(rng, 5) + [None, bn.G1_GEN, bn.G1_GEN]
    ks = [bn.rand_zr(rng) for _ in range(5)] + [11, 0, bn.R]
    want = [bn._g1_mul_py(p, k) for p, k in zip(pts, ks)]
    assert want[5:] == [None, None, None]
    assert native.bn254_mul_many(pts, ks) == want
    assert bn.g1_mul_many(pts, ks) == want
    assert [bn.g1_mul(p, k) for p, k in zip(pts, ks)] == want
    if jnative.available():
        assert jnative.bn254_mul_many(pts, ks) == want
    assert native.bn254_mul_many([], []) == []


def _pairing_cases(rng):
    """(name, pairs, whether the product is one)."""
    a, b, c = (bn.rand_zr(rng) for _ in range(3))
    p1 = bn._g1_mul_py(bn.G1_GEN, a)
    q1 = bn.g2_mul(bn.G2_GEN, b)
    p2 = bn.g1_neg(bn._g1_mul_py(bn.G1_GEN, a * b % bn.R))
    p5 = bn._g1_mul_py(bn.G1_GEN, 5)
    three = [
        (bn._g1_mul_py(bn.G1_GEN, a), bn.g2_mul(bn.G2_GEN, b)),
        (bn._g1_mul_py(bn.G1_GEN, b), bn.g2_mul(bn.G2_GEN, c)),
        (bn.g1_neg(bn.G1_GEN), bn.g2_mul(bn.G2_GEN, (a * b + b * c) % bn.R)),
    ]
    return [
        ("bilinear", [(p1, q1), (p2, bn.G2_GEN)], True),
        ("tampered", [(p1, q1), (bn.g1_neg(p1), bn.G2_GEN)], False),
        ("g1_identity", [(None, bn.G2_GEN)], True),
        ("g2_identity", [(p5, None)], True),
        ("empty", [], True),
        ("one_pairing", [(p5, bn.G2_GEN)], False),
        ("three_way_split", three, True),
    ]


def test_bn254_pairing_check_matches_python_and_jax_native():
    rng = random.Random(RNG_SEED + 2)
    for name, pairs, want in _pairing_cases(rng):
        py = bn.multi_pairing([pq for pq in pairs
                               if pq[0] is not None and pq[1] is not None])
        assert (py == bn.FP12_ONE) is want, name
        assert native.bn254_pairing_check(pairs) is want, name
        assert bn.pairing_check(pairs) is want, name
        if jnative.available():
            assert jnative.bn254_pairing_check(pairs) is want, name


# -- the build ----------------------------------------------------------------

_BUILD_AND_USE = """
import sys
from pathlib import Path
from fabric_tpu_torch import native
native.BUILD_DIR = Path(sys.argv[1])
path = native.build()
g = (1, 2)
assert native.bn254_msm([g, g], [3, 4]) == native.bn254_mul_many([g], [7])[0]
print(path)
"""


def test_workers_building_at_once_share_one_library(tmp_path):
    """Six processes start the build into one empty directory together:
    one compile, one library, and every process loads and uses it."""
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_AND_USE,
                               str(tmp_path)], cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(6)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert all(p.returncode == 0 for p in procs), [e[-2000:] for _, e in outs]
    assert len({o.strip() for o, _ in outs}) == 1
    assert [p.name for p in tmp_path.glob("*.so")] == [
        Path(outs[0][0].strip()).name]
    assert len(list(tmp_path.glob("*.log"))) == 1
    assert not list(tmp_path.glob("*.tmp.so"))


def test_build_key_follows_the_sources(tmp_path, monkeypatch):
    key = native._build_key("/usr/bin/g++", "g++ 12")
    assert native._build_key("/other/g++", "g++ 12") != key
    assert native._build_key("/usr/bin/g++", "g++ 13") != key
    src = tmp_path / "src"
    src.mkdir()
    for name in (*native.SOURCES, *native.HEADERS):
        (src / name).write_bytes((native.SRC_DIR / name).read_bytes())
    monkeypatch.setattr(native, "SRC_DIR", src)
    assert native._build_key("/usr/bin/g++", "g++ 12") == key
    (src / "fp254.h").write_text((src / "fp254.h").read_text() + "\n")
    assert native._build_key("/usr/bin/g++", "g++ 12") != key


@pytest.mark.parametrize("compiler", ["missing", "failing"])
def test_no_python_fallback_when_the_library_cannot_build(
        compiler, tmp_path, monkeypatch):
    """Without a working g++ every entry point raises, with the
    compiler's output, and the pure-Python functions do not answer in its
    place (the JAX package's bn254 and TPUCSP fall back to Python)."""
    bindir = tmp_path / "bin"
    bindir.mkdir()
    if compiler == "failing":
        fake = bindir / "g++"
        fake.write_text("#!/bin/sh\necho 'fp254.h:1: error: no luck' >&2\n"
                        "exit 1\n")
        fake.chmod(0o755)
    monkeypatch.setenv("PATH", str(bindir))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)

    def oracle(*a, **k):
        raise AssertionError("the pure-Python oracle answered")

    monkeypatch.setattr(bn, "_g1_mul_py", oracle)
    monkeypatch.setattr(bn, "_g1_msm_py", oracle)
    monkeypatch.setattr(bn, "multi_pairing", oracle)
    match = "g\\+\\+ not found" if compiler == "missing" else "no luck"
    g = bn.G1_GEN
    calls = [
        lambda: bn.g1_mul(g, 3),
        lambda: bn.g1_mul_many([g], [3]),
        lambda: bn.g1_msm([(g, 3)]),
        lambda: bn.pairing_check([(g, bn.G2_GEN)]),
        lambda: pk.pack_items([]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match=match):
            call()
    assert native._lib is None
    assert not list((tmp_path / "build").glob("*.so"))


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
