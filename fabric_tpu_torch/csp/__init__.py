"""Crypto service provider of the port: the SPI, a pure-Python P-256
reference, the CUDA provider (`csp.cuda.provider.CUDACSP`), and the
factory that picks one from a node's configuration (`csp.factory`)."""

from fabric_tpu_torch.csp.factory import (
    HostRouteCSP,
    csp_from_config,
    get_default,
    init_factories,
)

__all__ = ["HostRouteCSP", "csp_from_config", "get_default",
           "init_factories"]
