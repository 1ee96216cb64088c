"""lscc — the legacy (pre-2.0) lifecycle system chaincode.

Capability parity with the reference's core/scc/lscc/lscc.go (1.15k LoC):

- `install`: store a ChaincodeDeploymentSpec-wrapped package in the
  node-local package store (legacy packages are CDS bytes, not the new
  .tar.gz format; both share the store, namespaced by format).
- `deploy` / `upgrade`: write a ChaincodeData record into the lscc
  namespace of CHANNEL STATE via the invoking stub (the reference does
  exactly this: putChaincodeData -> stub.PutState under "lscc"), after
  checking the name/version rules (lscc.go isValidChaincodeName/Version)
  and instantiation policy bytes are present.
- `getid`, `getdepspec`, `getccdata`: per-chaincode queries.
- `getchaincodes`: instantiated chaincodes on the channel (reads the
  lscc namespace range).
- `getinstalledchaincodes`: node-local installed packages.

The port's copy of `fabric_tpu/chaincode/lscc.py`, on the port's codec.

The v2.0 `_lifecycle` SCC (chaincode.lifecycle) supersedes
this for new networks; lscc exists so operators migrating from 1.x find
the same query/deploy surface.  Validator integration: channels whose
definitions come from lscc resolve endorsement policy through
LegacyDefinitionProvider (ChaincodeData.policy), like the reference's
lscc-backed DeployedChaincodeInfoProvider.
"""

from __future__ import annotations

import re

from fabric_tpu_torch.chaincode.shim import Chaincode, error, success
from fabric_tpu_torch.common.hashing import sha256 as _sha256
from fabric_tpu_torch.protos import peer as pb

NAMESPACE = "lscc"

_NAME_RE = re.compile(r"^[A-Za-z][A-Za-z0-9_-]*$")
_VERSION_RE = re.compile(r"^[A-Za-z0-9_.+-]+$")


class LSCC(Chaincode):
    """Legacy lifecycle SCC (reference core/scc/lscc/lscc.go)."""

    def __init__(self, package_store=None):
        # reuse the lifecycle PackageStore; legacy CDS packages are
        # stored under a "cds:" label prefix so both formats coexist
        self._store = package_store

    # -- helpers -----------------------------------------------------------

    @staticmethod
    def _check_name(name: str) -> bool:
        return bool(_NAME_RE.match(name))

    @staticmethod
    def _check_version(version: str) -> bool:
        return bool(_VERSION_RE.match(version))

    def invoke(self, stub):
        fn, params = stub.get_function_and_parameters()
        if fn == "install":
            return self._install(params)
        if fn in ("deploy", "upgrade"):
            return self._deploy(stub, fn, params)
        if fn in ("getid", "getdepspec", "getccdata"):
            return self._get_one(stub, fn, params)
        if fn in ("getchaincodes", "GetChaincodesResult"):
            return self._get_chaincodes(stub)
        if fn == "getinstalledchaincodes":
            return self._get_installed()
        return error(f"lscc: unknown function {fn!r}")

    # -- install (node-local) ---------------------------------------------

    def _install(self, params):
        if self._store is None:
            return error("lscc: no package store on this node")
        if len(params) < 1:
            return error("lscc: install requires a deployment spec")
        try:
            cds = pb.ChaincodeDeploymentSpec.decode(params[0])
        except Exception:
            return error("lscc: malformed ChaincodeDeploymentSpec")
        name = cds.chaincode_spec.chaincode_id.name
        version = cds.chaincode_spec.chaincode_id.version
        if not self._check_name(name) or not self._check_version(version):
            return error("lscc: invalid chaincode name/version")
        self._store.save(f"cds:{name}:{version}", params[0])
        return success()

    # -- deploy / upgrade (channel state) ---------------------------------

    def _deploy(self, stub, fn: str, params):
        # reference signature: deploy(channel, cds, policy, escc, vscc, ...)
        if len(params) < 2:
            return error(f"lscc: {fn} requires channel and deployment spec")
        try:
            cds = pb.ChaincodeDeploymentSpec.decode(params[1])
        except Exception:
            return error("lscc: malformed ChaincodeDeploymentSpec")
        name = cds.chaincode_spec.chaincode_id.name
        version = cds.chaincode_spec.chaincode_id.version
        if not self._check_name(name):
            return error(f"lscc: invalid chaincode name {name!r}")
        if not self._check_version(version):
            return error(f"lscc: invalid chaincode version {version!r}")
        existing = stub.get_state(name)
        if fn == "deploy" and existing:
            return error(f"lscc: chaincode {name!r} already deployed")
        if fn == "upgrade" and not existing:
            return error(f"lscc: cannot upgrade {name!r}: not deployed")
        data = pb.ChaincodeData(
            name=name,
            version=version,
            escc=params[3].decode() if len(params) > 3 and params[3] else "escc",
            vscc=params[4].decode() if len(params) > 4 and params[4] else "vscc",
            policy=bytes(params[2]) if len(params) > 2 else b"",
            id=_sha256(params[1]),
        )
        stub.put_state(name, data.encode())
        return success(data.encode())

    # -- queries -----------------------------------------------------------

    def _get_one(self, stub, fn: str, params):
        if len(params) < 2:
            return error(f"lscc: {fn} requires channel and chaincode name")
        name = params[1].decode()
        raw = stub.get_state(name)
        if not raw:
            return error(f"lscc: chaincode {name!r} not found", status=404)
        if fn == "getccdata":
            return success(raw)
        data = pb.ChaincodeData.decode(raw)
        if fn == "getid":
            return success(data.id)
        # getdepspec: the stored package, when this node has it
        if self._store is not None:
            for pid, label in self._store.list():
                if label == f"cds:{data.name}:{data.version}":
                    return success(self._store.load(pid))
        return error("lscc: deployment spec not available on this node",
                     status=404)

    def _get_chaincodes(self, stub):
        infos = []
        for key, raw in stub.get_state_by_range("", ""):
            try:
                data = pb.ChaincodeData.decode(raw)
            except Exception:
                continue
            if data.name != key:
                continue
            infos.append(pb.ChaincodeInfo(
                name=data.name, version=data.version,
                escc=data.escc, vscc=data.vscc, id=data.id,
            ))
        return success(pb.ChaincodeQueryResponse(chaincodes=infos).encode())

    def _get_installed(self):
        infos = []
        if self._store is not None:
            for pid, label in self._store.list():
                if not label.startswith("cds:"):
                    continue
                _, name, version = label.split(":", 2)
                infos.append(pb.ChaincodeInfo(
                    name=name, version=version,
                    id=bytes.fromhex(pid.rsplit(":", 1)[1]),
                ))
        return success(pb.ChaincodeQueryResponse(chaincodes=infos).encode())


class LegacyDefinitionProvider:
    """Definition provider over lscc ChaincodeData records — the
    validator seam for channels still running pre-2.0 lifecycle
    (reference lscc.go ChaincodeDefinition / getCCData path)."""

    def __init__(self, ledger):
        self._ledger = ledger

    def definition(self, name: str):
        sim = self._ledger.new_query_executor()
        raw = sim.get_state(NAMESPACE, name)
        if not raw:
            return None
        return pb.ChaincodeData.decode(raw)

    def validation_info(self, name: str) -> tuple[str, bytes] | None:
        d = self.definition(name)
        if d is None:
            return None
        return (d.vscc or "vscc", bytes(d.policy))

    def collection_config(self, name: str, collection: str):
        return None  # legacy collections live in the lscc CDS; not ported


__all__ = ["LSCC", "LegacyDefinitionProvider", "NAMESPACE"]
