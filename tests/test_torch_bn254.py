"""The PyTorch port's BN254 Schnorr commitments (fabric_tpu_torch) held
against the JAX package, exactly.

The same inputs go through both packages: an issuer key and signatures of
the JAX package (native host backend), and lanes crafted from them.  The
JAX side runs the Pallas kernel in interpret mode on the CPU, once, as
tests/test_pallas_bn254.py does; the port runs its plain PyTorch version
on the CPU.  Jacobian triples are not unique (the Pallas kernel runs one
interleaved ladder at R = 2^272, the port sums per-term partials, the
shared bases' from a fixed-base comb, at R = 2^256), so the two are
compared at the affine level; every other case is held against the host
oracles (`schnorr.recompute_commitments`, `bn254.g1_msm`, `g1_mul`).
Every comparison is exact.
"""

import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402
import random  # noqa: E402

import numpy as np  # noqa: E402

from fabric_tpu.csp.tpu import bn254_batch as jbatch  # noqa: E402
from fabric_tpu.csp.tpu import pallas_bn254  # noqa: E402
from fabric_tpu.idemix import bn254 as jbn  # noqa: E402
from fabric_tpu.idemix import schnorr as jschnorr  # noqa: E402
from fabric_tpu.idemix import signature as jsig  # noqa: E402
from fabric_tpu.idemix.credential import (  # noqa: E402
    new_cred_request,
    new_credential,
)
from fabric_tpu.idemix.issuer import IssuerKey  # noqa: E402
from fabric_tpu_torch.csp.cuda import bn254_batch as bb  # noqa: E402
from fabric_tpu_torch.csp.cuda import bn254_kernel as bk  # noqa: E402
from fabric_tpu_torch.csp.cuda import convert, fp254  # noqa: E402
from fabric_tpu_torch.csp.cuda.fp254 import FpBN254  # noqa: E402

P = fp254.P
R_INV = pow(fp254.R, -1, P)
N_ATTRS = 3
PAD_LANES = 10  # the port's batch: 8 lanes and 2 padding lanes


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain version runs many small tensor ops: one intra-op thread
    keeps parallel test workers from oversubscribing the shared cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- the plain field ---------------------------------------------------------


def _operands(seed, n=40):
    rng = random.Random(seed)
    edges = [0, 1, P - 1, P, 2 * P - 1, 2**254 - 1, 2**254, 2**254 + 1,
             2**255, 2**256 - 1]
    xs = edges + [rng.randrange(2**256) for _ in range(n)]
    ys = list(reversed(edges)) + [rng.randrange(2**256) for _ in range(n)]
    return xs, ys


def _limbs(vals):
    return torch.as_tensor(np.stack([fp254.int_to_limbs(v) for v in vals]))


FIELD_OPS = {
    "add": (lambda fp, a, b: fp.add(a, b), lambda x, y: x + y),
    "sub": (lambda fp, a, b: fp.sub(a, b), lambda x, y: x - y),
    "mul": (lambda fp, a, b: fp.mul(a, b), lambda x, y: x * y * R_INV),
    "sqr": (lambda fp, a, b: fp.sqr(a), lambda x, y: x * x * R_INV),
    "mul_const3": (lambda fp, a, b: fp.mul_const(a, 3), lambda x, y: 3 * x),
    "mul_const8": (lambda fp, a, b: fp.mul_const(a, 8), lambda x, y: 8 * x),
}


def _assert_invariant(out):
    assert int(out.min()) >= 0 and int(out.max()) <= fp254.LIMB_MAX
    assert max(fp254.limbs_to_int(r) for r in out.numpy()) < 1.1 * 2**256


@pytest.mark.parametrize("op", sorted(FIELD_OPS))
def test_plain_field_matches_python_ints(op):
    """Each op (Montgomery product at R = 2^256), and a 60-step chain of
    it with mul and sub, against Python ints mod p, on random operands
    and the edges 0, 1, p - 1, 2p - 1 and values near 2^254 and 2^256;
    every output keeps the invariant the module docstring states."""
    fp = FpBN254("cpu")
    xs, ys = _operands(sorted(FIELD_OPS).index(op))
    a, b = _limbs(xs), _limbs(ys)
    dev_op, int_op = FIELD_OPS[op]
    out = dev_op(fp, a, b)
    vals = [int_op(x, y) % P for x, y in zip(xs, ys)]
    assert fp.to_ints(fp.canon(out)) == vals
    _assert_invariant(out)
    for step in range(60):
        if step % 3 == 0:
            out = fp.mul(out, b)
            vals = [v * y * R_INV % P for v, y in zip(vals, ys)]
        elif step % 3 == 1:
            out, vals = fp.sub(out, a), [(v - x) % P for v, x in zip(vals, xs)]
        else:
            out = dev_op(fp, out, b)
            vals = [int_op(v, y) % P for v, y in zip(vals, ys)]
        _assert_invariant(out)
    assert fp.to_ints(fp.canon(out)) == vals


def test_plain_field_is_zero_canon_and_words():
    fp = FpBN254("cpu")
    xs, ys = _operands(7)
    a, b = _limbs(xs), _limbs(ys)
    assert fp.is_zero(a).tolist() == [x % P == 0 for x in xs]
    same = fp.sub(fp.add(a, b), b)  # relaxed forms of the same values
    assert fp.eq(same, a).all()
    assert fp.is_zero(fp.sub(same, a)).all()
    assert fp.is_zero(same).tolist() == [x % P == 0 for x in xs]
    assert not fp.eq(a, fp.add(a, fp.from_ints([1] * len(xs)))).any()
    canon = fp.canon(same)
    assert fp.to_ints(canon) == [x % P for x in xs]
    words = fp.to_words(canon)
    assert words.dtype == torch.int32 and words.shape == (8, len(xs))
    assert fp254.words_to_ints(words.numpy()) == [x % P for x in xs]
    assert torch.equal(fp.from_words(words), canon)


# -- constants and packing ---------------------------------------------------


def test_words_and_digits_match_pallas():
    xs, _ = _operands(3)
    np.testing.assert_array_equal(
        fp254.words_from_ints(xs), pallas_bn254._words_from_ints(xs)
    )
    np.testing.assert_array_equal(
        bk.digits_from_ints(xs), pallas_bn254._digits_from_ints(xs)
    )


def test_consts_match_jax():
    got = convert.bn254_consts_from_jax(pallas_bn254._consts())
    want = bk.consts()
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert fp254.words_to_ints(want["p"][:, None]) == [jbn.P]


# -- the shared batch ----------------------------------------------------------


@pytest.fixture(scope="module")
def world():
    rng = random.Random(7)
    isk = IssuerKey.generate(["a0", "a1", "a2"], rng=rng)
    sk = jbn.rand_zr(rng)
    req = new_cred_request(sk, b"nonce", isk.ipk, rng=rng)
    cred = new_credential(isk, req, [11, 22, 33], rng=rng)
    sigs = [
        jsig.new_signature(cred, sk, isk.ipk, b"torch-bn254-%d" % i,
                           disclosure=d, rng=rng)
        for i, d in enumerate([[False] * 3, [True, False, True],
                               [True] * 3, [False] * 3, [False] * 3])
    ]
    return isk.ipk, sigs, rng


def _crafted(ipk, rng, negate: bool):
    """A lane whose a_bar is +-h_rand with the scalar of h_rand: T1's
    first two terms (h_rand, then a_bar) meet at the first nonzero window
    and take the doubling branch, or, negated, cancel to infinity; with
    b' and a' at scalar 0, T1 is 2 s h_rand or infinity."""
    g = jbn.G1_GEN
    hr = ipk.h_rand
    pts = (jbn.g1_mul(g, 5), jbn.g1_neg(hr) if negate else hr,
           jbn.g1_mul(g, 7), jbn.g1_mul(g, 9))
    _, term_acc = bb.term_layout(N_ATTRS)
    sc = [jbn.rand_zr(rng) for _ in term_acc]
    sc[1] = sc[0]  # a_bar's scalar = h_rand's
    sc[2] = sc[3] = 0  # b', a'
    return pts, sc


@pytest.fixture(scope="module")
def batch(world):
    """8 lanes: valid (3 disclosures), tampered challenge, off-curve a',
    missing response, the doubling lane and the infinity lane; the port
    pads to PAD_LANES, Pallas to its block."""
    ipk, sigs, rng = world
    lane_sigs = [
        sigs[0], sigs[1], sigs[2],
        dataclasses.replace(sigs[3], challenge=sigs[3].challenge + 1),
        dataclasses.replace(
            sigs[4], a_prime=(sigs[4].a_prime[0], sigs[4].a_prime[1] + 1)),
        dataclasses.replace(
            sigs[0], responses={k: v for k, v in sigs[0].responses.items()
                                if k != "sk"}),
    ]
    pts, sc, ok = bb.prepare_sigs(lane_sigs, N_ATTRS)
    for negate in (False, True):
        p, s = _crafted(ipk, rng, negate)
        pts.append(p)
        sc.append(s)
        ok.append(True)
    return lane_sigs, pts, sc, ok


@pytest.fixture(scope="module")
def port_out(world, batch):
    ipk, _, _ = world
    _, pts, sc, ok = batch
    tt, ta = bb.term_layout(N_ATTRS)
    packed = bk.pack(pts, sc, ok, tt, ta, lanes=PAD_LANES)
    t = bk.upload(packed, bb.shared_comb(bb.shared_points(ipk)), "cpu")
    before = bk.launches_bn254
    out = bk.commitments(t)
    assert bk.launches_bn254 == before  # plain-version calls do not count
    assert out.dtype == torch.int32 and out.shape == (bk.OUT_ROWS, PAD_LANES)
    return out


@pytest.fixture(scope="module")
def pallas_jac(world, batch):
    """The Pallas kernel in interpret mode, once for the module (~80 s)."""
    ipk, _, _ = world
    _, pts, sc, ok = batch
    tt, ta = bb.term_layout(N_ATTRS)
    shared_pts = (jbn.G1_GEN, ipk.h_sk, ipk.h_rand, *ipk.h_attrs)
    return pallas_bn254.commitments(pts, sc, ok, tt, ta, shared_pts,
                                    interpret=True)


def test_prepare_sigs_matches_jax(world, batch):
    lane_sigs = batch[0]
    assert bb.prepare_sigs(lane_sigs, N_ATTRS) == jbatch._prepare_sigs(
        lane_sigs, None, N_ATTRS)
    assert bb.term_layout(N_ATTRS)[0][0] == 2  # T1 opens with h_rand


def test_shared_tables_match_jax(world):
    """Window 0 of the port's comb, the multiples 0..15 of each shared
    base, is the JAX package's 16-entry shared table."""
    ipk, _, _ = world
    key = bb.shared_points(ipk)
    assert key == (jbn.G1_GEN, ipk.h_sk, ipk.h_rand, *ipk.h_attrs)
    got = convert.bn254_shared_from_jax(*pallas_bn254._shared_limbs(key))
    comb = bb.shared_comb(key)
    n_shared = len(key)
    want = {
        "xy": comb["xy"].reshape(n_shared, bk.NWINDOWS, bk.TABLE, 16)[:, 0]
        .reshape(n_shared * bk.TABLE, 16),
        "inf": comb["inf"].reshape(n_shared, bk.NWINDOWS, bk.TABLE)[:, 0]
        .reshape(-1),
    }
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_shared_comb_matches_g1_mul(world):
    """Comb entry (s, k, d) is d 16^k B_s, in Montgomery words, on
    sampled windows and digits of every shared base (d = 0 at
    infinity)."""
    ipk, _, _ = world
    key = bb.shared_points(ipk)
    comb = bb.shared_comb(key)
    assert comb["xy"].shape == (len(key) * bk.COMB_ENTRIES, 16)
    assert comb["xy"].dtype == np.uint32
    rng = random.Random(11)
    picks = [(s, k, d) for s in range(len(key))
             for k, d in ((0, 1), (63, 15), (rng.randrange(64), 0),
                          (rng.randrange(64), rng.randrange(1, 16)))]
    for s, k, d in picks:
        row = bk.COMB_ENTRIES * s + bk.TABLE * k + d
        want = jbn.g1_mul(key[s], d * 16**k)
        if want is None:
            assert comb["inf"][row] == 1 and not comb["xy"][row].any()
            continue
        assert comb["inf"][row] == 0
        got = fp254.words_to_ints(comb["xy"][row].reshape(2, 8).T)
        assert [fp254.from_mont(v) for v in got] == list(want), (s, k, d)


def test_plain_matches_pallas_interpret(batch, port_out, pallas_jac):
    """Affine T1..T3 of every lane, valid, tampered, degenerate and
    malformed alike (the malformed ones run with infinity bases)."""
    ok = batch[3]
    n = len(ok)
    everyone = [True] * n
    got = bb.to_affine(bk.unpack(port_out, n), everyone)
    want = bb.to_affine(pallas_jac, everyone)
    assert got == want


def _oracle(ipk, pts, sc, layout):
    """Per accumulator, sum of base^scalar over its terms (host MSM)."""
    shared = bb.shared_points(ipk)
    tables = (*shared, *pts)
    out = []
    for a in range(3):
        out.append(jbn.g1_msm([(tables[t], s) for (t, acc), s in
                               zip(zip(*layout), sc) if acc == a]))
    return tuple(out)


def test_plain_matches_host_oracle(world, batch, port_out):
    ipk, _, _ = world
    lane_sigs, pts, sc, ok = batch
    got = bb.to_affine(bk.unpack(port_out, len(ok)), ok)
    layout = bb.term_layout(N_ATTRS)
    for j, sig in enumerate(lane_sigs):
        if not ok[j]:
            assert got[j] is None, j
            continue
        rels = jsig._relations(ipk, sig.a_prime, sig.a_bar, sig.b_prime,
                               sig.nym, sig.disclosure, sig.disclosed_attrs)
        want = jschnorr.recompute_commitments(rels, sig.challenge,
                                              sig.responses)
        assert list(got[j]) == list(want), j
    assert [ok[3], ok[4], ok[5]] == [True, False, False]
    doubled, cancelled = got[6], got[7]
    assert doubled == _oracle(ipk, pts[6], sc[6], layout)
    assert doubled[0] == jbn.g1_mul(ipk.h_rand, 2 * sc[6][0])
    assert cancelled == _oracle(ipk, pts[7], sc[7], layout)
    assert cancelled[0] is None
    # the padding lanes: every base and digit at infinity
    inf_rows = port_out[bk.OUT_ROWS - 3:, len(ok):]
    assert bool((inf_rows == 1).all())
    assert not bool(port_out[:bk.OUT_ROWS - 3, len(ok):].any())


def test_custom_layout_matches_host_oracle(world):
    """A layout of the caller's own: T2 left empty (it stays at
    infinity), a lane base used twice, a shared base on two accumulators,
    and a lane whose T3 doubles in the reduction: its a_bar equals
    h_attrs[1], with the same scalar, right after the h_attrs[1] term, so
    the comb partial and the ladder partial are equal."""
    ipk, _, rng = world
    n_shared = 3 + N_ATTRS
    layout = ((0, 4, n_shared + 1, n_shared + 1, 0), (0, 2, 2, 0, 2))
    g = jbn.G1_GEN
    lanes, scs = [], []
    for j in range(3):
        pts = tuple(jbn.g1_mul(g, 3 + 10 * j + b) for b in range(4))
        sc = [jbn.rand_zr(rng) for _ in layout[0]]
        if j == 2:
            pts = (pts[0], ipk.h_attrs[1], pts[2], pts[3])
            sc[2] = sc[1]
            sc[4] = 0
        lanes.append(pts)
        scs.append(sc)
    packed = bk.pack(lanes, scs, [True] * 3, *layout)
    comb = bb.shared_comb(bb.shared_points(ipk))
    out = bk.commitments(bk.upload(packed, comb, "cpu"))
    got = bb.to_affine(bk.unpack(out), [True] * 3)
    for j in range(3):
        assert got[j] == _oracle(ipk, lanes[j], scs[j], layout), j
        assert got[j][1] is None  # T2 has no term
    assert got[2][2] == jbn.g1_mul(ipk.h_attrs[1], 2 * scs[2][1])


def test_upload_rejects_bad_term_metadata(world):
    ipk, _, _ = world
    shared = bb.shared_comb(bb.shared_points(ipk))
    packed = bk.pack([], [], [], (3 + N_ATTRS + 4,), (0,))
    with pytest.raises(ValueError, match="out of range"):
        bk.upload(packed, shared, "cpu")
    packed = bk.pack([], [], [], (0,), (3,))
    with pytest.raises(ValueError, match="out of range"):
        bk.upload(packed, shared, "cpu")


def test_wrapper_refuses_other_devices():
    t = {k: torch.zeros((8, 4), dtype=torch.int32, device="meta")
         for k in ("lanes", "laneinf", "digits", "termmeta", "comb_xy",
                   "comb_inf")}
    with pytest.raises(ValueError, match="unsupported device"):
        bk.commitments(t)
