"""The `_lifecycle` system chaincode (the port's copy of
`fabric_tpu/chaincode/lifecycle.py`; reference core/chaincode/lifecycle).

- Install: the package (.tar.gz bytes) is stored on disk under its
  package id `<label>:<sha256>`.
- Approve: an org's approval is the hash of the marshaled definition at
  `approvals/<name>/<sequence>/<mspid>` in `_lifecycle`'s namespace.
- CheckCommitReadiness compares each org's approval with the definition.
- Commit needs the approvals of a majority of the channel's application
  orgs and writes `chaincodes/<name>` -> ChaincodeDefinition.

`DefinitionProvider` reads the committed definitions from the state DB:
the validator's `definition_provider` (the endorsement policy of a
namespace, its collections).
"""

from __future__ import annotations

import gzip
import io
import json
import os
import tarfile

from fabric_tpu_torch.chaincode.shim import Chaincode, ChaincodeStub, error, \
    success
from fabric_tpu_torch.common.hashing import sha256 as _sha256
from fabric_tpu_torch.protos import lifecycle as lc
from fabric_tpu_torch.protos import peer as pb

NAMESPACE = "_lifecycle"


class PackageStore:
    """Chaincode packages on disk (reference core/chaincode/persistence):
    `<sha256>.tar.gz` files and an `index.json` of their labels."""

    def __init__(self, dir_path: str):
        self.dir = dir_path
        os.makedirs(dir_path, exist_ok=True)

    @staticmethod
    def package_id(label: str, package_bytes: bytes) -> str:
        return f"{label}:{_sha256(package_bytes).hex()}"

    def _path(self, package_id: str) -> str:
        return os.path.join(self.dir,
                            package_id.rsplit(":", 1)[1] + ".tar.gz")

    def _index_path(self) -> str:
        return os.path.join(self.dir, "index.json")

    def _read_index(self) -> dict:
        try:
            with open(self._index_path()) as f:
                return json.load(f)
        except (OSError, ValueError):
            return {}

    def save(self, label: str, package_bytes: bytes) -> str:
        pid = self.package_id(label, package_bytes)
        path = self._path(pid)
        if not os.path.exists(path):
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                f.write(package_bytes)
            os.replace(tmp, path)
        idx = self._read_index()
        if pid not in idx:
            idx[pid] = label
            tmp = self._index_path() + ".tmp"
            with open(tmp, "w") as f:
                json.dump(idx, f)
            os.replace(tmp, self._index_path())
        return pid

    def load(self, package_id: str) -> bytes | None:
        if package_id not in self._read_index():
            return None
        try:
            with open(self._path(package_id), "rb") as f:
                return f.read()
        except OSError:
            return None

    def list(self) -> list[tuple[str, str]]:
        """[(package_id, label)]"""
        return sorted(self._read_index().items())


def _definition_hash(d: lc.ChaincodeDefinition) -> bytes:
    return _sha256(d.encode())


def _approval_key(name: str, sequence: int, mspid: str) -> str:
    return f"approvals/{name}/{sequence}/{mspid}"


def _definition_key(name: str) -> str:
    return f"chaincodes/{name}"


class LifecycleSCC(Chaincode):
    def __init__(self, package_store: PackageStore, org_lister=None):
        """org_lister() -> the MSP ids of the channel's application orgs
        (the majority of commit readiness)."""
        self._store = package_store
        self._org_lister = org_lister or (lambda: [])

    def invoke(self, stub: ChaincodeStub):
        fn, params = stub.get_function_and_parameters()
        handler = {
            "InstallChaincode": self._install,
            "QueryInstalledChaincodes": self._query_installed,
            "GetInstalledChaincodePackage": self._get_package,
            "ApproveChaincodeDefinitionForMyOrg": self._approve,
            "CheckCommitReadiness": self._check_readiness,
            "CommitChaincodeDefinition": self._commit,
            "QueryChaincodeDefinition": self._query_definition,
            "QueryChaincodeDefinitions": self._query_definitions,
        }.get(fn)
        if handler is None:
            return error(f"unknown lifecycle function {fn!r}")
        try:
            return handler(stub, params[0] if params else b"")
        except Exception as exc:
            return error(str(exc))

    # -- install: the node's own, no channel state -------------------------

    def _install(self, stub, raw):
        args = lc.InstallChaincodeArgs.decode(raw)
        pkg = bytes(args.chaincode_install_package)
        label = self._package_label(pkg)
        pid = self._store.save(label, pkg)
        return success(lc.InstallChaincodeResult(package_id=pid,
                                                 label=label).encode())

    @staticmethod
    def _package_label(pkg: bytes) -> str:
        """The label of the package's metadata.json (a tar.gz), else a
        prefix of its hash."""
        try:
            with tarfile.open(fileobj=io.BytesIO(pkg), mode="r:gz") as tf:
                for m in tf.getmembers():
                    if os.path.basename(m.name) == "metadata.json":
                        meta = json.loads(tf.extractfile(m).read())
                        return meta.get("label", "unlabeled")
        except (tarfile.TarError, gzip.BadGzipFile, OSError, ValueError):
            pass
        return "pkg-" + _sha256(pkg).hex()[:12]

    def _query_installed(self, stub, raw):
        # a label "cds:..." is a legacy lscc package (not a .tar.gz)
        return success(lc.QueryInstalledChaincodesResult(
            installed_chaincodes=[
                lc.InstalledChaincode(package_id=pid, label=label)
                for pid, label in self._store.list()
                if not label.startswith("cds:")]).encode())

    def _get_package(self, stub, raw):
        pid = raw.decode()
        pkg = self._store.load(pid)
        if pkg is None:
            return error(f"package {pid!r} not installed", status=404)
        return success(pkg)

    # -- approvals and commit: channel state --------------------------------

    def _next_sequence(self, stub, name: str) -> int:
        committed = self._load_definition(stub, name)
        return (committed.sequence + 1) if committed else 1

    def _approve(self, stub, raw):
        d = lc.ApproveChaincodeDefinitionForMyOrgArgs.decode(raw).definition
        mspid = stub.creator_mspid()
        if not mspid:
            return error("cannot determine approving org")
        expected_seq = self._next_sequence(stub, d.name)
        if d.sequence > expected_seq:
            return error(f"requested sequence {d.sequence}, next "
                         f"committable is {expected_seq}")
        stub.put_state(_approval_key(d.name, d.sequence, mspid),
                       _definition_hash(d))
        return success(lc.ApproveChaincodeDefinitionForMyOrgResult().encode())

    def _approvals_for(self, stub, d: lc.ChaincodeDefinition
                       ) -> dict[str, bool]:
        want = _definition_hash(d)
        out = {}
        for mspid in self._org_lister():
            got = stub.get_state(_approval_key(d.name, d.sequence, mspid))
            out[mspid] = bool(got) and got == want
        return out

    def _check_readiness(self, stub, raw):
        d = lc.CheckCommitReadinessArgs.decode(raw).definition
        return success(lc.CheckCommitReadinessResult(
            approvals=dict(sorted(self._approvals_for(stub, d).items()))
        ).encode())

    def _commit(self, stub, raw):
        d = lc.CommitChaincodeDefinitionArgs.decode(raw).definition
        expected_seq = self._next_sequence(stub, d.name)
        if d.sequence != expected_seq:
            return error(f"requested sequence {d.sequence}, next "
                         f"committable is {expected_seq}")
        approvals = self._approvals_for(stub, d)
        yes = sum(approvals.values())
        if not approvals or yes * 2 <= len(approvals):
            return error(
                f"chaincode definition not agreed to by majority: "
                f"{approvals}")
        stub.put_state(_definition_key(d.name), d.encode())
        stub.set_event("CommitChaincodeDefinition", d.name.encode())
        return success(lc.CommitChaincodeDefinitionResult().encode())

    def _load_definition(self, stub, name: str
                         ) -> lc.ChaincodeDefinition | None:
        raw = stub.get_state(_definition_key(name))
        if not raw:
            return None
        return lc.ChaincodeDefinition.decode(raw)

    def _query_definition(self, stub, raw):
        args = lc.QueryChaincodeDefinitionArgs.decode(raw)
        d = self._load_definition(stub, args.name)
        if d is None:
            return error(f"namespace {args.name} is not defined", status=404)
        return success(lc.QueryChaincodeDefinitionResult(
            definition=d,
            approvals=dict(sorted(self._approvals_for(stub, d).items()))
        ).encode())

    def _query_definitions(self, stub, raw):
        return success(lc.QueryChaincodeDefinitionsResult(
            chaincode_definitions=[
                lc.ChaincodeInfo(name=key.split("/", 1)[1],
                                 definition=lc.ChaincodeDefinition.decode(
                                     value))
                for key, value in stub.get_state_by_range(
                    "chaincodes/", "chaincodes0")]).encode())


class DefinitionProvider:
    """Committed chaincode definitions read from the state DB: the
    validator's seam (reference lifecycle/deployedcc_infoprovider.go)."""

    def __init__(self, ledger):
        self._ledger = ledger

    def definition(self, name: str) -> lc.ChaincodeDefinition | None:
        raw = self._ledger.new_query_executor().get_state(
            NAMESPACE, _definition_key(name))
        if not raw:
            return None
        return lc.ChaincodeDefinition.decode(raw)

    def validation_info(self, name: str) -> tuple[str, bytes] | None:
        d = self.definition(name)
        if d is None:
            return None
        return (d.validation_plugin or "vscc", bytes(d.validation_parameter))

    def collection_config(self, name: str, collection: str):
        """A collection's StaticCollectionConfig, or None."""
        d = self.definition(name)
        if d is None or not d.collections:
            return None
        for c in pb.CollectionConfigPackage.decode(d.collections).config:
            if c.which("payload") == "static_collection_config" \
                    and c.static_collection_config.name == collection:
                return c.static_collection_config
        return None


__all__ = ["LifecycleSCC", "PackageStore", "DefinitionProvider", "NAMESPACE"]
