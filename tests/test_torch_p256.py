"""The PyTorch port's P-256 verify (fabric_tpu_torch) held against the JAX
package, exactly.

The same inputs go through both packages: signatures from the JAX
package's SWCSP (the OpenSSL oracle), scalars and operands from seeded
generators.  The JAX side runs the Pallas kernel in interpret mode on the
CPU, as tests/test_pallas_ec.py does; the port runs its plain PyTorch
version on the CPU and, where g++ is present, the CUDA kernel's own
source compiled for the host (csrc/p256_host_check.cpp).  Every
comparison is exact: masks, packed words, canonical field values.

The lanes are those of tests/test_pallas_ec.py (valid, tampered digest,
high-S, r out of range, the cand1 = r + n branch, a zero key), lanes
crafted for the kernels' split ladders and their reduction (Q = G with
u1 = u2, Q = -G with equal digits, three off-curve keys, a padding lane)
and the Wycheproof-style corpus of tests/test_wycheproof.py, in one
batch, so that each Pallas layout compiles once.
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
from test_wycheproof import _vectors  # noqa: E402

from fabric_tpu import native  # noqa: E402
from fabric_tpu.csp import SWCSP  # noqa: E402
from fabric_tpu.csp import api as japi  # noqa: E402
from fabric_tpu.csp.tpu import pallas_ec  # noqa: E402
from fabric_tpu_torch.csp import api, hostref  # noqa: E402
from fabric_tpu_torch.csp.cuda import convert, limbs  # noqa: E402
from fabric_tpu_torch.csp.cuda import p256_kernel as pk  # noqa: E402
from fabric_tpu_torch.csp.cuda.limbs import FpP256  # noqa: E402
from fabric_tpu_torch.csp.cuda.provider import CUDACSP  # noqa: E402

P = api.P256_P
N = api.P256_N
CSRC = Path(pk.__file__).resolve().parent / "csrc"
OUT_OF_TABLE = 300  # a key index the key table does not hold
# lanes whose key is a random point off P-256: (name, seed)
OFF_CURVE = (("off_curve_key", 17), ("off_curve_key_2", 18),
             ("off_curve_key_3", 19))
# lanes crafted for the split kernels' guards and their reduction
CRAFTED = ("q_eq_g", "q_neg_g", "zero_key", *(n for n, _ in OFF_CURVE),
           "padding")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain version runs many small tensor ops: one intra-op thread
    keeps parallel test workers from oversubscribing the shared cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- the corpus --------------------------------------------------------------


def _cand1_point():
    """A curve point with x >= n (tests/test_pallas_ec.py)."""
    x = N
    while True:
        x += 1
        t = (pow(x, 3, P) - 3 * x + api.P256_B) % P
        y = pow(t, (P + 1) // 4, P)
        if y * y % P == t:
            return x, y


def _q_eq_g_lane():
    """Q = G (private key 1) and a digest equal to r, so e = r and u1 =
    u2: the key-table kernel's partials u1_j G and u2_j Q are equal and
    its reduction doubles.  The signature is valid."""
    rng = random.Random(0x5EED)
    while True:
        k = rng.randrange(1, N)  # u1 = u2 = k / 2: every part nonzero
        r = hostref.mul_g(k)[0] % N
        s = 2 * r * pow(k, -1, N) % N  # k^-1 (e + r d) with e = r, d = 1
        if r and s:
            return (api.P256_GX, api.P256_GY, r.to_bytes(32, "big"),
                    japi.marshal_ecdsa_signature(r, api.to_low_s(s)))


def _off_curve_key(seed=17):
    rng = random.Random(seed)
    while True:
        x, y = rng.randrange(P), rng.randrange(P)
        if not api.on_curve(x, y):
            return x, y


def _parse(sig: bytes):
    try:
        return japi.unmarshal_ecdsa_signature(sig)
    except ValueError:
        return -1, -1  # prepare_packed marks the lane invalid


@pytest.fixture(scope="module")
def corpus():
    """(names, lanes as (x, y, digest, der), expected verdicts)."""
    sw = SWCSP()
    names, lanes, expect = [], [], []

    def add(name, x, y, digest, der, ok):
        names.append(name)
        lanes.append((x, y, digest, der))
        expect.append(ok)

    keys = [sw.key_gen() for _ in range(3)]
    for i in range(9):
        key = keys[i % 3]
        pub = key.public_key()
        digest = sw.hash(b"torch-p256-%d" % i)
        r, s = japi.unmarshal_ecdsa_signature(sw.sign(key, digest))
        name, ok = "valid", True
        if i == 1:
            digest, name, ok = sw.hash(b"other"), "tampered_digest", False
        elif i == 3:
            s, name, ok = N - s, "high_s", False
        elif i == 4:
            r, name, ok = N, "r_eq_n", False
        elif i == 7:
            r, name, ok = r + 1, "r_plus_1", False
        add(name, pub.x, pub.y, digest, japi.marshal_ecdsa_signature(r, s), ok)
    x, y = _cand1_point()
    r = x - N
    add("cand1", x, y, N.to_bytes(32, "big"),
        japi.marshal_ecdsa_signature(r, r), True)
    add("cand1_tampered", x, y, N.to_bytes(32, "big"),
        japi.marshal_ecdsa_signature(r + 1, r), False)
    add("zero_key", 0, 0, sw.hash(b"zk"), japi.marshal_ecdsa_signature(5, 7),
        False)
    add("q_eq_g", *_q_eq_g_lane(), True)
    # Q = -G, signed with its key n - 1: valid as it stands; `layouts`
    # then gives it u2 = u1, so that R = u1 G - u1 G is infinity
    neg_g = api.P256PrivateKey(N - 1, api.P256PublicKey(api.P256_GX,
                                                        P - api.P256_GY))
    digest = sw.hash(b"neg-g")
    add("q_neg_g", api.P256_GX, P - api.P256_GY, digest,
        hostref.sign(neg_g, digest, np.random.default_rng(5)), True)
    r, s = japi.unmarshal_ecdsa_signature(lanes[0][3])
    for name, seed in OFF_CURVE:
        add(name, *_off_curve_key(seed), lanes[0][2],
            japi.marshal_ecdsa_signature(r, s), False)
    # a padding lane, as the provider marks one (invalid DER)
    add("padding", keys[0].public_key().x, keys[0].public_key().y,
        lanes[0][2], b"", False)
    wkey = sw.key_gen()
    wpub = wkey.public_key()
    wdigest = hashlib.sha256(b"wycheproof").digest()
    wr, ws = japi.unmarshal_ecdsa_signature(sw.sign(wkey, wdigest))
    for name, der, digest, ok in _vectors(wr, ws, wdigest):
        add("wycheproof_" + name, wpub.x, wpub.y, digest, der, ok)
    # the oracle agrees wherever it can load the key
    for lane, ok in zip(lanes, expect):
        if api.on_curve(lane[0], lane[1]):
            pub = sw.key_import(
                b"\x04" + lane[0].to_bytes(32, "big")
                + lane[1].to_bytes(32, "big")
            )
            assert sw.verify(pub, lane[3], lane[2]) == ok
    return names, lanes, expect


def _tuples(lanes):
    return [(x, y, d, *_parse(der)) for x, y, d, der in lanes]


@pytest.fixture(scope="module")
def layouts(corpus):
    """The JAX package's packed inputs per layout, and their verdicts:
    the Q = -G lane gets d2 = d1 in both (u2 = u1, so R is infinity),
    and the key-table layout moves one valid lane's index outside the
    table (the one-hot gather then selects the zero point)."""
    names, lanes, expect = corpus
    per_lane = pallas_ec.prepare_packed(_tuples(lanes))
    table = pallas_ec.dedup_keys(pallas_ec.prepare_packed(_tuples(lanes)))
    assert "kidx" in table
    expect = list(expect)
    neg = names.index("q_neg_g")
    for packed in (per_lane, table):
        packed["d2"][:, neg] = packed["d1"][:, neg]
    expect[neg] = False
    moved = expect.index(True)
    table["kidx"][moved] = OUT_OF_TABLE
    expect_table = list(expect)
    expect_table[moved] = False
    return {
        "lanekeys": (per_lane, expect),
        "keytab": (table, expect_table),
    }


@pytest.fixture(scope="module")
def jax_masks(layouts):
    return {
        name: [bool(v) for v in pallas_ec.verify_packed(p, interpret=True)()]
        for name, (p, _) in layouts.items()
    }


# -- the plain field ------------------------------------------------------


def _operands(seed, n=40):
    rng = random.Random(seed)
    edges = [0, 1, P - 1, P, P + 1, 2**256 - 1, 2**255, 2**224]
    xs = edges + [rng.randrange(2**256) for _ in range(n)]
    ys = list(reversed(edges)) + [rng.randrange(2**256) for _ in range(n)]
    return xs, ys


FIELD_OPS = {
    "add": (lambda fp, a, b: fp.add(a, b), lambda x, y: x + y),
    "sub": (lambda fp, a, b: fp.sub(a, b), lambda x, y: x - y),
    "mul": (lambda fp, a, b: fp.mul(a, b), lambda x, y: x * y),
    "sqr": (lambda fp, a, b: fp.sqr(a), lambda x, y: x * x),
    "mul_const3": (lambda fp, a, b: fp.mul_const(a, 3), lambda x, y: 3 * x),
    "mul_const8": (lambda fp, a, b: fp.mul_const(a, 8), lambda x, y: 8 * x),
}


@pytest.mark.parametrize("op", sorted(FIELD_OPS))
def test_plain_field_matches_python_ints(op):
    """Each op, and a 60-step chain of it with mul/sub, against Python
    ints; outputs keep the relaxed-limb invariant [-8, 2^16 + 8]."""
    fp = FpP256("cpu")
    xs, ys = _operands(sorted(FIELD_OPS).index(op))
    a, b = fp.from_ints(xs), fp.from_ints(ys)
    dev_op, int_op = FIELD_OPS[op]
    out = dev_op(fp, a, b)
    assert fp.to_ints(fp.canon(out)) == [int_op(x, y) % P for x, y in zip(xs, ys)]
    vals = [int_op(x, y) % P for x, y in zip(xs, ys)]
    for step in range(60):
        if step % 3 == 0:
            out, vals = fp.mul(out, b), [v * y % P for v, y in zip(vals, ys)]
        elif step % 3 == 1:
            out, vals = fp.sub(out, a), [(v - x) % P for v, x in zip(vals, xs)]
        else:
            out = dev_op(fp, out, b)
            vals = [int_op(v, y) % P for v, y in zip(vals, ys)]
        assert int(out.min()) >= -8 and int(out.max()) <= (1 << 16) + 8
    assert fp.to_ints(fp.canon(out)) == vals


def test_plain_field_is_zero_and_eq():
    fp = FpP256("cpu")
    xs, ys = _operands(7)
    a, b = fp.from_ints(xs), fp.from_ints(ys)
    assert fp.is_zero(a).tolist() == [x % P == 0 for x in xs]
    # relaxed forms of the same values: a + b - b
    same = fp.sub(fp.add(a, b), b)
    assert fp.eq(same, a).all()
    assert fp.is_zero(fp.sub(same, a)).all()
    assert fp.is_zero(same).tolist() == [x % P == 0 for x in xs]
    assert not fp.eq(a, fp.add(a, fp.from_ints([1] * len(xs)))).any()
    assert fp.to_ints(fp.canon(same)) == [x % P for x in xs]


# -- constants and packing -------------------------------------------------


def test_consts_match_jax():
    assert limbs.S_TERMS == pallas_ec._S_TERMS
    got = convert.consts_from_jax(pallas_ec._consts())
    want = pk.consts()
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_solinas_matrix_reduces_mod_p():
    """The limb-level Solinas matrix maps every product column 2^(16i),
    i < 32, to a value congruent to it."""
    m = limbs.solinas_matrix()
    for i in range(32):
        got = sum(int(m[k, i]) << (16 * k) for k in range(16))
        assert (got - (1 << (16 * i))) % P == 0, i


def test_prepare_packed_and_dedup_match_jax(corpus):
    _, lanes, _ = corpus
    tuples = _tuples(lanes)
    want = pallas_ec.prepare_packed(tuples)
    got = pk.prepare_packed(tuples)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    want_d = pallas_ec.dedup_keys(want)
    got_d = pk.dedup_keys(got)
    # the port's key table also carries the kernel's quarter tables
    assert sorted(got_d) == sorted([*want_d, "qtab", "keybad"])
    for k in want_d:
        np.testing.assert_array_equal(got_d[k], want_d[k], err_msg=k)
    tabs = pk.key_quarter_tables(want_d["ktabx"], want_d["ktaby"])
    for k in ("qtab", "keybad"):
        np.testing.assert_array_equal(got_d[k], tabs[k], err_msg=k)


def test_prepare_packed_matches_native_marshal(corpus):
    """native/marshal.cc (the JAX package's hot-path packer) and the port's
    numpy packing agree array for array.  Lanes whose digest is not 32
    bytes are the exception in their words: the native path packs them
    with a zero digest and marks them invalid afterwards
    (provider._marshal_native), the numpy path substitutes G."""
    if not native.available():
        pytest.skip("native marshaller unavailable (no g++)")
    _, lanes, _ = corpus
    bad_digest = [i for i, lane in enumerate(lanes) if len(lane[2]) != 32]
    sigs = [lane[3] for lane in lanes]
    offs = np.cumsum([0] + [len(s) for s in sigs]).astype(np.int32)
    packed = native.marshal_batch(
        b"".join(x.to_bytes(32, "big") for x, *_ in lanes),
        b"".join(y.to_bytes(32, "big") for _, y, *_ in lanes),
        b"".join(d if len(d) == 32 else b"\0" * 32 for _, _, d, _ in lanes),
        b"".join(sigs), offs,
    )
    packed["valid"][bad_digest] = False
    got = pk.prepare_packed(_tuples(lanes))
    keep = np.ones(len(lanes), bool)
    keep[bad_digest] = False
    for k in got:
        a, b = np.asarray(got[k]), np.asarray(packed[k])
        if a.ndim == 2:
            a, b = a[:, keep], b[:, keep]
        np.testing.assert_array_equal(a, b, err_msg=k)
    np.testing.assert_array_equal(got["valid"], packed["valid"])


def test_packed_from_jax_layout(layouts):
    table, _ = layouts["keytab"]
    t = convert.packed_from_jax(table, "cpu")
    b = table["kidx"].shape[0]
    assert t["ktabx"].shape == (8, pk.KEYTAB) and t["kidx"].shape == (b,)
    assert t["qtab"].shape == (pk.KEYTAB, *pk.QTAB_SHAPE)
    assert t["keybad"].shape == (pk.KEYTAB,)
    assert t["flags"].shape == (2, b)
    assert all(v.dtype == torch.int32 for v in t.values())
    np.testing.assert_array_equal(
        t["d1"].numpy().view(np.uint32), table["d1"]
    )
    assert int(t["kidx"][table["kidx"].tolist().index(OUT_OF_TABLE)]) == (
        OUT_OF_TABLE
    )


# -- the verify ------------------------------------------------------------


@pytest.mark.parametrize("layout", ["keytab", "lanekeys"])
def test_plain_verify_matches_pallas(layout, layouts, jax_masks, corpus):
    names = corpus[0]
    packed, expect = layouts[layout]
    got = pk.verify_packed(convert.packed_from_jax(packed, "cpu")).tolist()
    want = jax_masks[layout]
    assert want == expect
    diff = [n for n, g, w in zip(names, got, want) if g != w]
    assert not diff, f"port disagrees with pallas_ec on {diff}"


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """The kernel source as it ships, built for the host by g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the kernel source for the host")
    out = tmp_path_factory.mktemp("p256host") / "libp256host.so"
    subprocess.run(
        [gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-o", str(out),
         str(CSRC / "p256_host_check.cpp")],
        check=True, capture_output=True, text=True,
    )
    lib = ctypes.CDLL(str(out))
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.p256_host_keytab.argtypes = [vp] * 9 + [i32]
    lib.p256_host_partials.argtypes = [vp] * 9 + [i32]
    lib.p256_host_lanekeys.argtypes = [vp] * 8 + [i32]
    lib.p256_host_lanekeys_partials.argtypes = [vp] * 8 + [i32]
    lib.p256_host_field.argtypes = [i32, vp, vp, vp, i32]
    return lib


def _ptr(a):
    return ctypes.c_void_p(a.ctypes.data)


def _host_arrays(packed):
    """The kernel's uint32 arrays of a packed dict: the words, flags, G's
    quarter tables, and for a key table its keys' quarter tables."""
    arr = {k: np.ascontiguousarray(v, np.uint32) for k, v in packed.items()
           if k not in ("cand1_ok", "valid")}
    arr["flags"] = np.ascontiguousarray(
        np.stack([packed["cand1_ok"], packed["valid"]]).astype(np.uint32)
    )
    arr["gqtab"] = np.ascontiguousarray(pk.g_quarter_table())
    if "ktabx" in packed:
        arr.update(pk.key_quarter_tables(packed["ktabx"], packed["ktaby"]))
    return arr


def _host_verdicts(lib, packed):
    arr = _host_arrays(packed)
    n = arr["flags"].shape[1]
    out = np.zeros(n, np.uint8)
    common = [_ptr(arr["d1"]), _ptr(arr["d2"]), _ptr(arr["cand0"]),
              _ptr(arr["flags"])]
    if "kidx" in arr:
        lib.p256_host_keytab(_ptr(arr["qtab"]), _ptr(arr["keybad"]),
                             _ptr(arr["kidx"]), *common, _ptr(arr["gqtab"]),
                             _ptr(out), n)
    else:
        lib.p256_host_lanekeys(_ptr(arr["qx"]), _ptr(arr["qy"]), *common,
                               _ptr(arr["gqtab"]), _ptr(out), n)
    return [bool(v) for v in out]


@pytest.mark.parametrize("layout", ["keytab", "lanekeys"])
def test_kernel_source_on_host_matches_pallas(layout, layouts, jax_masks,
                                              host_lib):
    """The CUDA kernels' lane code, built for the host, gives the Pallas
    kernel's verdicts and the plain version's on the same packed inputs:
    the split pieces of p256_split.cuh (a lane's 8 parts one after
    another, then the reduction), over the key table's quarter tables or
    over each lane's own table of its key."""
    packed, _ = layouts[layout]
    got = _host_verdicts(host_lib, packed)
    assert got == jax_masks[layout]
    plain = pk.verify_packed(convert.packed_from_jax(packed, "cpu"))
    assert got == plain.tolist()


def test_lanekeys_crafted_lanes_on_host_pallas_and_plain(
        layouts, jax_masks, corpus, host_lib):
    """The per-lane-key lanes crafted for the split kernel, on the g++
    build of its pieces, on Pallas interpret and on the plain version:
    Q = G with u1 = u2 verifies (its reduction doubles), Q = -G with d2 =
    d1 does not (its partials cancel), and the zero key, the three
    off-curve keys and the padding lane are rejected (by the guard, before
    any arithmetic, in the kernel)."""
    names = corpus[0]
    packed, expect = layouts["lanekeys"]
    rows = [names.index(n) for n in CRAFTED]
    host = _host_verdicts(host_lib, packed)
    plain = pk.verify_packed(convert.packed_from_jax(packed, "cpu")).tolist()
    for i in rows:
        assert host[i] == jax_masks["lanekeys"][i] == plain[i] == expect[i], (
            names[i])
    assert [expect[i] for i in rows] == [True] + [False] * (len(rows) - 1)
    xs, ys = packed["qx"], packed["qy"]
    for i in rows[2:-1]:  # the keys the guard rejects
        assert not api.on_curve(limbs.words_to_int(xs[:, i]) % P,
                                limbs.words_to_int(ys[:, i]) % P)


def _ints(words) -> list[int]:
    return [limbs.words_to_int(words[:, i]) for i in range(words.shape[1])]


def _scalars(digit_words) -> list[int]:
    """(8, B) packed MSB-first digit words -> the B scalars."""
    out = []
    for lane in range(digit_words.shape[1]):
        u = 0
        for k in range(64):
            u = 16 * u + (int(digit_words[k // 8, lane]) >> (4 * (k % 8)) & 0xF)
        out.append(u)
    return out


def _affine(words, inf):
    if inf:
        return None
    x, y, z = (limbs.words_to_int(words[8 * i:8 * i + 8]) for i in range(3))
    zi = pow(z, -1, P)
    return x * zi * zi % P, y * zi * zi * zi % P


def test_quarter_tables_match_hostref():
    """Every entry of 2 keys' tables and of G's is d 2^(64 j) B; an
    off-curve key and the zero point are flagged and get no tables."""
    rng = np.random.default_rng(21)
    keys = [hostref.key_gen(rng).public_key() for _ in range(2)]
    pts = [(k.x, k.y) for k in keys] + [_off_curve_key(), (0, 0)]
    ktabx = np.stack([limbs.int_to_words(x) for x, _ in pts], axis=1)
    ktaby = np.stack([limbs.int_to_words(y) for _, y in pts], axis=1)
    tabs = pk.key_quarter_tables(ktabx, ktaby)
    assert tabs["qtab"].shape == (4, *pk.QTAB_SHAPE)
    assert tabs["keybad"].tolist() == [0, 0, 1, 1]
    assert not tabs["qtab"][2:].any()
    g = (api.P256_GX, api.P256_GY)
    for base, tab in [*zip(pts[:2], tabs["qtab"][:2]),
                      (g, pk.g_quarter_table())]:
        for j in range(pk.QUARTERS):
            for d in range(16):
                want = hostref.affine_mul(d << (64 * j), base) or (0, 0)
                got = (limbs.words_to_int(tab[j, d, 0]),
                       limbs.words_to_int(tab[j, d, 1]))
                assert got == want, (j, d)


def _check_split_partials(names, arr, w, inf, keys, ok):
    """Each of an accepted lane's 8 partials, made affine, is u_j 2^(64 j)
    B for the quarter u_j of u1 (B = G) or u2 (B = the lane's key in
    `keys`); a rejected lane has none (inf 7: untouched).  The crafted
    lanes meet in the reduction's doubling (Q = G, u1 = u2) and infinity
    (Q = -G, d2 = d1) branches, and the cand1 lane's G partials (u1 = 0)
    are at infinity.  Returns the rejected lanes."""
    n = len(ok)
    split = pk.QUARTERS
    w = w.reshape(n, 2 * split, 24)
    inf = inf.reshape(n, 2 * split)
    width = 256 // split
    u1s, u2s = _scalars(arr["d1"]), _scalars(arr["d2"])
    got = {}
    for lane in range(n):
        if not ok[lane]:
            assert (inf[lane] == 7).all(), lane
            continue
        got[lane] = [_affine(w[lane, p], inf[lane, p])
                     for p in range(2 * split)]
        for p, part in enumerate(got[lane]):
            j = p % split
            u, base = ((u1s[lane], (api.P256_GX, api.P256_GY)) if p < split
                       else (u2s[lane], keys[lane]))
            digits = (u >> (width * j)) & ((1 << width) - 1)
            assert part == hostref.affine_mul(digits << (width * j), base), (
                names[lane], p)
    eq = got[names.index("q_eq_g")]
    assert eq[split - 1] is not None and eq[split - 1] == eq[2 * split - 1]
    neg = got[names.index("q_neg_g")]
    for j in range(split):
        a, b = neg[j], neg[split + j]
        assert a == b is None or (a[0] == b[0] and a[1] == P - b[1])
    assert got[names.index("cand1")][:split] == [None] * split
    return {i for i in range(n) if i not in got}


def _partial_buffers(n):
    return (np.zeros(n * 2 * pk.QUARTERS * 24, np.uint32),
            np.full(n * 2 * pk.QUARTERS, 7, np.uint32))  # 7: untouched


def test_kernel_partials_on_host_are_the_split_products(layouts, corpus,
                                                        host_lib):
    """The key-table kernel's 8 partials of each lane (see
    _check_split_partials); the lanes its guard rejects are the invalid
    ones, the zero and off-curve keys (keybad) and the one outside the
    table."""
    names = corpus[0]
    table, _ = layouts["keytab"]
    arr = _host_arrays(table)
    n = arr["flags"].shape[1]
    w, inf = _partial_buffers(n)
    host_lib.p256_host_partials(
        _ptr(arr["qtab"]), _ptr(arr["keybad"]), _ptr(arr["kidx"]),
        _ptr(arr["d1"]), _ptr(arr["d2"]), _ptr(arr["flags"]),
        _ptr(arr["gqtab"]), _ptr(w), _ptr(inf), n)
    kx, ky = _ints(arr["ktabx"]), _ints(arr["ktaby"])
    kidx = arr["kidx"].tolist()
    ok = [bool(table["valid"][i]) and kidx[i] < pk.KEYTAB
          and not arr["keybad"][kidx[i]] for i in range(n)]
    keys = [(kx[k], ky[k]) if k < pk.KEYTAB else None for k in kidx]
    skipped = _check_split_partials(names, arr, w, inf, keys, ok)
    assert skipped == {i for i in range(n) if not table["valid"][i]} | {
        names.index("zero_key"), *(names.index(n) for n, _ in OFF_CURVE),
        kidx.index(OUT_OF_TABLE)}


def test_lanekeys_partials_on_host_are_the_split_products(layouts, corpus,
                                                          host_lib):
    """The per-lane-key kernel's 8 partials of each lane, its Q parts
    over the lane's own table scaled by 2^(64 j) (see
    _check_split_partials); the lanes its guard rejects are the invalid
    ones and those whose key is not on P-256."""
    names = corpus[0]
    packed, _ = layouts["lanekeys"]
    arr = _host_arrays(packed)
    n = arr["flags"].shape[1]
    w, inf = _partial_buffers(n)
    host_lib.p256_host_lanekeys_partials(
        _ptr(arr["qx"]), _ptr(arr["qy"]), _ptr(arr["d1"]), _ptr(arr["d2"]),
        _ptr(arr["flags"]), _ptr(arr["gqtab"]), _ptr(w), _ptr(inf), n)
    keys = [(x % P, y % P) for x, y in zip(_ints(arr["qx"]),
                                           _ints(arr["qy"]))]
    ok = [bool(packed["valid"][i]) and api.on_curve(*keys[i])
          for i in range(n)]
    skipped = _check_split_partials(names, arr, w, inf, keys, ok)
    assert skipped == {i for i in range(n) if not packed["valid"][i]} | {
        names.index("zero_key"), *(names.index(n) for n, _ in OFF_CURVE)}


def test_provider_key_table_after_overflow_matches_plain_on_host(
        host_lib, monkeypatch):
    """After a flush over more keys than the key table holds, a flush over
    4 of those keys runs the key-table layout with every index it uses
    backed by quarter tables (keybad 0), and the kernel's lane code, built
    for the host, gives the plain version's verdicts on exactly what
    CUDACSP hands the kernel."""
    seen = []
    real = pk.verify_packed

    def recording(t):
        out = real(t)
        seen.append((t, out))
        return out

    monkeypatch.setattr(pk, "verify_packed", recording)
    rng = np.random.default_rng(5)
    keys = [hostref.key_gen(rng) for _ in range(pk.KEYTAB + 1)]
    items = []
    for i, key in enumerate(keys):
        d = hashlib.sha256(b"overflow-%d" % i).digest()
        items.append(api.VerifyBatchItem(key.public_key(), d,
                                         hostref.sign(key, d, rng)))
    csp = CUDACSP(device="cpu", min_device_batch=1)
    assert all(csp.verify_batch(items))
    few = items[:4] * 2
    k, _, s = few[5]
    few[5] = api.VerifyBatchItem(k, hashlib.sha256(b"forged").digest(), s)
    assert csp.verify_batch(few) == [i != 5 for i in range(len(few))]
    assert ["kidx" in t for t, _ in seen] == [False, True]
    t, want = seen[1]
    arr = {k: np.ascontiguousarray(v.numpy().view(np.uint32))
           for k, v in t.items()}
    assert not arr["keybad"][arr["kidx"]].any()
    gq = np.ascontiguousarray(pk.g_quarter_table())
    n = len(few)
    out = np.zeros(n, np.uint8)
    host_lib.p256_host_keytab(
        _ptr(arr["qtab"]), _ptr(arr["keybad"]), _ptr(arr["kidx"]),
        _ptr(arr["d1"]), _ptr(arr["d2"]), _ptr(arr["cand0"]),
        _ptr(arr["flags"]), _ptr(gq), _ptr(out), n)
    assert out.astype(bool).tolist() == want.tolist()


@pytest.mark.parametrize("op", ["add", "sub", "mul", "sqr"])
def test_kernel_field_on_host_matches_python_ints(op, host_lib):
    """The kernel's word arithmetic, operands reduced mod p on load as the
    kernel does (inputs up to 2^256 - 1)."""
    xs, ys = _operands(11, n=300)
    a = np.stack([limbs.int_to_words(x) for x in xs])
    b = np.stack([limbs.int_to_words(y) for y in ys])
    r = np.zeros_like(a)
    code = ["add", "sub", "mul", "sqr"].index(op)
    host_lib.p256_host_field(code, _ptr(a), _ptr(b), _ptr(r), len(xs))
    int_op = FIELD_OPS[op][1]
    got = [limbs.words_to_int(w) for w in r]
    assert got == [int_op(x % P, y % P) % P for x, y in zip(xs, ys)]


@pytest.mark.slow
def test_plain_verify_random_sweep_matches_sw():
    """64 random lanes with random tampering, keys per lane."""
    sw = SWCSP()
    rng = random.Random(5)
    lanes, expect = [], []
    for i in range(64):
        key = sw.key_gen()
        pub = key.public_key()
        digest = sw.hash(b"sweep-%d" % i)
        der = sw.sign(key, digest)
        if rng.random() < 0.3:
            digest = sw.hash(b"sweep-tampered-%d" % i)
        lanes.append((pub.x, pub.y, digest, der))
        expect.append(sw.verify(pub, der, digest))
    packed = pk.prepare_packed(_tuples(lanes))
    got = pk.verify_packed(pk.upload(packed, "cpu")).tolist()
    assert got == expect
