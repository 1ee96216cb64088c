"""The port's legacy lifecycle SCC (`chaincode.lscc`), chaincode packages
(`chaincode.platforms`) and external builders
(`chaincode.externalbuilder`) against the JAX package's.

- lscc: the same invocations on equal state give the same responses
  (status, message, payload bytes) and the same writes, in both
  packages, each over its own package store.
- platforms: the same source tree packs into packages with the same
  members and metadata, each package's parses in the other, and the same
  inputs are refused with the same messages.
- external builders: a scripted builder folder (detect, build, release,
  run as shell scripts that record their arguments) is called with the
  same arguments and leaves the same outputs in both packages.
"""

import io
import os
import stat
import tarfile

import pytest

from fabric_tpu.chaincode import externalbuilder as jax_eb
from fabric_tpu.chaincode import lscc as jax_lscc
from fabric_tpu.chaincode import platforms as jax_plat
from fabric_tpu.chaincode.lifecycle import PackageStore as JaxStore
from fabric_tpu_torch.chaincode import externalbuilder as port_eb
from fabric_tpu_torch.chaincode import lscc as port_lscc
from fabric_tpu_torch.chaincode import platforms as port_plat
from fabric_tpu_torch.chaincode.lifecycle import PackageStore as PortStore
from fabric_tpu_torch.protos import peer as pb


class Stub:
    """A chaincode stub over a dict: the calls lscc makes."""

    def __init__(self, state: dict, args: list[bytes]):
        self.state = state
        self.args = args

    def get_function_and_parameters(self):
        return self.args[0].decode(), self.args[1:]

    def get_state(self, key):
        return self.state.get(key, b"")

    def put_state(self, key, value):
        self.state[key] = bytes(value)

    def get_state_by_range(self, start, end):
        for k in sorted(self.state):
            yield k, self.state[k]


def _cds(name: str, version: str, code: bytes = b"code") -> bytes:
    return pb.ChaincodeDeploymentSpec(
        chaincode_spec=pb.ChaincodeSpec(
            type=pb.ChaincodeSpec.GOLANG,
            chaincode_id=pb.ChaincodeID(name=name, version=version)),
        code_package=code).encode()


POLICY = b"\x12\x0c\x12\x0a\x08\x01\x12\x02\x08\x00\x1a\x00"
CALLS = [
    [b"install", _cds("mycc", "1.0")],
    [b"install", _cds("othercc", "2.1", b"other")],
    [b"install", b"\xff\xff"],
    [b"install", _cds("9bad", "1.0")],
    [b"install"],
    [b"deploy", b"ch", _cds("mycc", "1.0"), POLICY, b"escc", b"vscc"],
    [b"deploy", b"ch", _cds("mycc", "1.0"), POLICY],
    [b"deploy", b"ch", _cds("bad name", "1.0")],
    [b"deploy", b"ch", _cds("newcc", "v/1")],
    [b"deploy", b"ch"],
    [b"upgrade", b"ch", _cds("ghost", "1.0")],
    [b"upgrade", b"ch", _cds("mycc", "1.1", b"v2"), POLICY, b"", b"vscc2"],
    [b"deploy", b"ch", _cds("othercc", "2.1", b"other"), b"", b"e", b"v"],
    [b"getid", b"ch", b"mycc"],
    [b"getccdata", b"ch", b"mycc"],
    [b"getdepspec", b"ch", b"othercc"],
    [b"getdepspec", b"ch", b"mycc"],
    [b"getid", b"ch", b"nope"],
    [b"getid", b"ch"],
    [b"getchaincodes"],
    [b"GetChaincodesResult"],
    [b"getinstalledchaincodes"],
    [b"frobnicate"],
]


def _run_lscc(mod, store_cls, root) -> tuple[list, dict]:
    cc = mod.LSCC(store_cls(str(root)))
    state: dict = {"zz-not-data": b"\x01\x02"}
    out = []
    for args in CALLS:
        resp = cc.invoke(Stub(state, args))
        out.append((resp.status, resp.message, bytes(resp.payload)))
    bare = mod.LSCC(None).invoke(Stub({}, [b"install", _cds("x", "1")]))
    out.append((bare.status, bare.message, bytes(bare.payload)))
    return out, state


def test_lscc_answers_as_the_reference(tmp_path):
    jax_out, jax_state = _run_lscc(jax_lscc, JaxStore, tmp_path / "jax")
    port_out, port_state = _run_lscc(port_lscc, PortStore, tmp_path / "port")
    assert port_out == jax_out
    assert port_state == jax_state
    statuses = [s for s, _, _ in port_out]
    assert statuses.count(200) == 11 and statuses.count(404) == 2
    # the deployed records decode the same, through each package's
    # definition provider
    for mod in (jax_lscc, port_lscc):
        class Ledger:
            def new_query_executor(self):
                class QE:
                    def get_state(self, ns, key):
                        assert ns == mod.NAMESPACE
                        return port_state.get(key)
                return QE()

        prov = mod.LegacyDefinitionProvider(Ledger())
        assert prov.validation_info("mycc") == ("vscc2", POLICY)
        assert prov.validation_info("othercc") == ("v", b"")
        assert prov.validation_info("nope") is None
        assert prov.collection_config("mycc", "c") is None


@pytest.fixture()
def src(tmp_path):
    d = tmp_path / "src"
    (d / "pkg").mkdir(parents=True)
    (d / "main.py").write_bytes(b"print('cc')\n")
    (d / "pkg" / "util.py").write_bytes(b"X = 1\n")
    (d / "connection.json").write_bytes(b'{"address": "127.0.0.1:9999"}')
    return d


def _members(pkg: bytes) -> list[tuple[str, bytes]]:
    with tarfile.open(fileobj=io.BytesIO(pkg), mode="r:gz") as tf:
        return [(m.name, tf.extractfile(m).read()) for m in tf.getmembers()]


@pytest.mark.parametrize("cc_type", ["python", "external"])
def test_packages_have_the_same_members_and_metadata(src, cc_type):
    pkgs = {name: mod.package_chaincode(str(src), "mycc_1", cc_type)
            for name, mod in (("jax", jax_plat), ("port", port_plat))}
    assert _members(pkgs["port"]) == _members(pkgs["jax"])
    for reader in (jax_plat, port_plat):
        parsed = [reader.parse_package(p) for p in pkgs.values()]
        assert parsed[0] == parsed[1]
        meta, files = parsed[0]
        assert meta == {"label": "mycc_1", "type": cc_type, "path": str(src)}
        assert sorted(files) == ["connection.json", "main.py",
                                 os.path.join("pkg", "util.py")]
    single = {name: mod.package_chaincode(str(src / "main.py"), "one")
              for name, mod in (("jax", jax_plat), ("port", port_plat))}
    assert _members(single["port"]) == _members(single["jax"])


def _bad_package() -> bytes:
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w:gz") as tf:
        ti = tarfile.TarInfo("../evil")
        ti.size = 1
        tf.addfile(ti, io.BytesIO(b"x"))
    return buf.getvalue()


REFUSALS = [
    ("package", ("{src}", "bad label", "python")),
    ("package", ("{src}", "", "python")),
    ("package", ("{src}", "l", "cobol")),
    ("package", ("{src}/connection.json", "l", "python")),
    ("package", ("{bad}", "l", "external")),
    ("parse", None),
]


@pytest.mark.parametrize("kind,args", REFUSALS)
def test_the_same_inputs_are_refused_with_the_same_messages(src, tmp_path,
                                                           kind, args):
    bad = tmp_path / "bad"
    bad.mkdir()
    (bad / "connection.json").write_bytes(b"{not json")
    got = {}
    for name, mod in (("jax", jax_plat), ("port", port_plat)):
        with pytest.raises(mod.PlatformError) as exc:
            if kind == "parse":
                mod.parse_package(_bad_package())
            else:
                mod.package_chaincode(*[a.format(src=src, bad=bad)
                                        for a in args])
        got[name] = str(exc.value)
    assert got["port"] == got["jax"]
    assert port_plat.platform("PYTHON").name == "python"


SCRIPTS = {
    "detect": '#!/bin/sh\ngrep -q \'"type": "python"\' "$2/metadata.json"\n',
    "build": '#!/bin/sh\necho "build $(basename $1) $(basename $2)" > '
             '"$3/build.txt"\ncp -r "$1/." "$3/"\n',
    "release": '#!/bin/sh\necho "release $(basename $1)" > "$2/rel.txt"\n',
    "run": '#!/bin/sh\ncp "$2/chaincode.json" "$1/ran.json"\n'
           'echo "run $(basename $1) $(basename $2)" > "$1/run.txt"\n',
}


def _builder(root, name, tools=SCRIPTS):
    b = root / name / "bin"
    b.mkdir(parents=True)
    for tool, text in tools.items():
        p = b / tool
        p.write_text(text)
        p.chmod(p.stat().st_mode | stat.S_IXUSR)
    return str(root / name)


def _tree(path: str) -> dict:
    out = {}
    for dirpath, _, names in os.walk(path):
        for n in names:
            full = os.path.join(dirpath, n)
            with open(full, "rb") as f:
                out[os.path.relpath(full, path)] = f.read()
    return out


def test_external_builders_are_called_and_leave_the_same_outputs(src,
                                                               tmp_path):
    pkg = port_plat.package_chaincode(str(src), "mycc_1", "python")
    ext = port_plat.package_chaincode(str(src), "svc", "external")
    trees = {}
    for name, mod in (("jax", jax_eb), ("port", port_eb)):
        root = tmp_path / name
        skip = _builder(root, "never", {"detect": "#!/bin/sh\nexit 1\n"})
        good = _builder(root, "pybuilder")
        reg = mod.BuilderRegistry(
            [mod.ExternalBuilder(skip), mod.ExternalBuilder(good)],
            str(root / "builds"))
        b, out = reg.build("mycc_1:abcd", pkg)
        assert b.name == "pybuilder"
        assert reg.build("mycc_1:abcd", pkg)[1] == out  # cached
        proc = reg.run("mycc_1:abcd", pkg, "mycc_1:abcd", "127.0.0.1:7052",
                       "tok")
        assert proc.wait(timeout=30) == 0
        with pytest.raises(mod.BuildError, match="no builder detected"):
            reg.build("svc:ef", ext)
        with pytest.raises(ValueError, match="auth_token is required"):
            reg.run("mycc_1:abcd", pkg, "mycc_1:abcd", "127.0.0.1:7052", "")
        with pytest.raises(mod.BuildError, match="has no run binary"):
            mod.ExternalBuilder(skip).run(out, out)
        assert not mod.ExternalBuilder(str(root / "absent")).detect(out, out)
        trees[name] = _tree(str(root / "builds"))
        mode = os.stat(root / "builds" / "mycc_1_abcd" / "run"
                       / "chaincode.json").st_mode & 0o777
        assert mode == 0o600
    assert trees["port"] == trees["jax"]
    assert trees["port"]["mycc_1_abcd/bld/build.txt"] == b"build src metadata\n"
    assert trees["port"]["mycc_1_abcd/release/rel.txt"] == b"release bld\n"
    assert trees["port"]["mycc_1_abcd/bld/run.txt"] == b"run bld run\n"
