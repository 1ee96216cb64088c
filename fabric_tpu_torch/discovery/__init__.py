"""The port's service discovery (a copy of `fabric_tpu/discovery/`):
clients ask a peer for a channel's config, its peers, and endorsement
descriptors (the endorser sets that satisfy a chaincode's policy)."""

from fabric_tpu_torch.discovery.client import (  # noqa: F401
    DiscoveryClient,
    select_endorsers,
)
from fabric_tpu_torch.discovery.endorsement import (  # noqa: F401
    PeerInfo,
    compute_descriptor,
)
from fabric_tpu_torch.discovery.inquire import satisfaction_sets  # noqa: F401
from fabric_tpu_torch.discovery.service import (  # noqa: F401
    DiscoveryService,
    DiscoverySupport,
)
