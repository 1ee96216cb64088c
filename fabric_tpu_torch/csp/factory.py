"""CSP factory: provider selection and the process-wide default (the
port's copy of `fabric_tpu/csp/factory.py`; reference
bccsp/factory/factory.go:42 GetDefault, nopkcs11.go:28 InitFactories).

The providers, by the names the configuration uses:

- "TPU", the port's default: `CUDACSP` over the host route, on
  `bccsp.tpu.device` ("cuda" by default: the card; without one the
  constructor raises, it never falls back; "cpu" runs the kernels' plain
  versions, as the CPU tests ask with `CORE_BCCSP_TPU_DEVICE=cpu`).  A
  config without a `bccsp` block, `get_default()` and `init_factories()`
  all give it, where the JAX package's give `SWCSP`.
  `bccsp.tpu.batchBuckets` is read by nobody: the port pads no buckets.
- "SW", only where a config names it: the host route, `HostRouteCSP`
  (`hostref.HostCSP`'s keys and signing, the provider's host verify:
  libcrypto's batch where it loads, else `hostref`'s).  The JAX
  package's "sw" is `SWCSP` over `cryptography`, which the card machine
  lacks.
- "CUSTODY": `CustodyCSP`, verifying on the host route or on `CUDACSP`.

`CUDACSP` and `CustodyCSP` are imported when they are asked for."""

from __future__ import annotations

import threading
from typing import Optional

from fabric_tpu_torch.csp import hostref
from fabric_tpu_torch.csp.api import CSP

_lock = threading.Lock()
_default: Optional[CSP] = None


class HostRouteCSP(hostref.HostCSP):
    """The "SW" provider: `hostref.HostCSP` whose batch verify is the one
    `CUDACSP`'s small batches take (`provider._host_verify_batch`:
    libcrypto where it loads, else `hostref`'s)."""

    def verify_batch(self, items) -> list[bool]:
        from fabric_tpu_torch.csp.cuda.provider import _host_verify_batch

        return list(_host_verify_batch(hostref, list(items)))


def _install_default(csp: CSP) -> CSP:
    """Record the process default and hand it to the hash seam, probe
    first: a provider the seam refuses is not left installed."""
    global _default
    from fabric_tpu_torch.common import hashing

    hashing.set_hash_backend(csp)
    _default = csp
    return csp


def init_factories(provider: str = "tpu", force: bool = False, **kwargs) -> CSP:
    """Initialize the process default CSP: the first call wins and later
    calls return it (the reference's sync.Once), unless `force`.  The
    provider is `CUDACSP` on the card unless the caller names another
    (the JAX package's default is "sw")."""
    with _lock:
        if _default is None or force:
            _install_default(_new_csp(provider, **kwargs))
        return _default


def get_default() -> CSP:
    """The process default; when none was configured, the provider of an
    empty config with the environment layer on top (reference
    factory.go:42-62, whose default is SW): `CUDACSP` on the card, unless
    `CORE_BCCSP_TPU_DEVICE` or `CORE_BCCSP_DEFAULT` asks otherwise."""
    from fabric_tpu_torch.common.config import Config

    with _lock:
        if _default is None:
            _install_default(_build(Config({}, env_prefix="CORE"), "bccsp"))
        return _default


def _maybe_install(csp: CSP) -> CSP:
    """The first configured CSP becomes the process default and the hash
    seam's backend, unless one is installed already."""
    with _lock:
        if _default is None:
            _install_default(csp)
    return csp


def _new_csp(provider: str, **kwargs) -> CSP:
    if provider == "sw":
        return HostRouteCSP(**kwargs)
    if provider == "tpu":
        from fabric_tpu_torch.csp.cuda.provider import CUDACSP

        return CUDACSP(**kwargs)
    if provider == "custody":
        from fabric_tpu_torch.csp.custody import CustodyCSP

        return CustodyCSP(**kwargs)
    raise ValueError(f"unknown CSP provider {provider!r}")


def _tpu_kwargs(cfg, prefix: str) -> dict:
    """The card provider's knobs from the config block, shared by the
    TPU and custody-verify constructions."""
    kwargs = {"device": str(cfg.get(f"{prefix}.tpu.device") or "cuda")}
    mdb = cfg.get(f"{prefix}.tpu.minDeviceBatch")
    if mdb is not None:
        kwargs["min_device_batch"] = int(mdb)
    return kwargs


def csp_from_config(cfg, prefix: str = "bccsp") -> CSP:
    """Build a CSP from a config's BCCSP block (`_build`); the first one
    built becomes the process default and the hash seam's backend."""
    return _maybe_install(_build(cfg, prefix))


def _build(cfg, prefix: str) -> CSP:
    """Build a CSP from a core.yaml/orderer.yaml BCCSP block (reference
    bccsp/factory/opts.go + sampleconfig/core.yaml:290-315):

        bccsp:
          default: TPU | SW | CUSTODY   # absent -> TPU
          sw:
            fileKeyStore:
              keyStorePath: <dir>     # empty/absent -> in-memory
          tpu:
            minDeviceBatch: <n>
            device: cuda | cuda:N | cpu
          custody:
            endpoint: host:port
            tokenFile: <path>
            verify: SW | TPU
            tls: {certFile, keyFile, caFiles: [..]}

    The file keystore keeps generated keys across restarts; it backs the
    host route's keys, and so `CUDACSP`'s, which delegates its key half
    to the host route it is given."""
    provider = str(cfg.get(f"{prefix}.default", "TPU")).lower()
    ks_path = cfg.get(f"{prefix}.sw.fileKeyStore.keyStorePath")
    keystore = None
    if ks_path:
        from fabric_tpu_torch.csp.keystore import FileKeyStore

        keystore = FileKeyStore(str(ks_path))
    sw = HostRouteCSP(keystore=keystore)
    if provider == "tpu":
        from fabric_tpu_torch.csp.cuda.provider import CUDACSP

        return CUDACSP(sw=sw, **_tpu_kwargs(cfg, prefix))
    if provider == "custody":
        from fabric_tpu_torch.cmd.common import parse_endpoint
        from fabric_tpu_torch.csp.custody import CustodyCSP, load_token

        endpoint = cfg.get(f"{prefix}.custody.endpoint")
        token_file = cfg.get(f"{prefix}.custody.tokenFile")
        if not endpoint:
            raise ValueError(
                f"{prefix}.default is CUSTODY but "
                f"{prefix}.custody.endpoint is not set"
            )
        if not token_file:
            raise ValueError(
                f"{prefix}.default is CUSTODY but "
                f"{prefix}.custody.tokenFile is not set"
            )
        tls = None
        cert = cfg.get(f"{prefix}.custody.tls.certFile")
        key = cfg.get(f"{prefix}.custody.tls.keyFile")
        cas = cfg.get(f"{prefix}.custody.tls.caFiles")
        if cert or key or cas:
            if not (cert and key):
                raise ValueError(
                    f"{prefix}.custody.tls needs BOTH certFile and "
                    "keyFile (partial TLS config would silently send "
                    "the token in plaintext)"
                )
            from fabric_tpu_torch.comm.tls import credentials_from_files

            tls = credentials_from_files(
                str(cert), str(key), [str(c) for c in (cas or [])]
            )
        verify: CSP = sw
        if str(cfg.get(f"{prefix}.custody.verify", "SW")).lower() == "tpu":
            from fabric_tpu_torch.csp.cuda.provider import CUDACSP

            verify = CUDACSP(sw=sw, **_tpu_kwargs(cfg, prefix))
        return CustodyCSP(
            parse_endpoint(str(endpoint)),
            load_token(str(token_file)),
            verify_csp=verify,
            tls=tls,
        )
    if provider == "sw":
        return sw
    raise ValueError(f"unknown CSP provider {provider!r}")


__all__ = ["HostRouteCSP", "csp_from_config", "get_default",
           "init_factories"]
