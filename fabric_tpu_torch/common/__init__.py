"""Shared host pieces of the port: the SHA-256 seam (`hashing`), the
channel-config bundle (`channelconfig`), capabilities and the config
transaction engine (`capabilities`, `configtx`), the in-memory CA and
config-tree builder that mint a channel (`crypto`, `configtx_builder`),
the block-delivery service (`deliver`), the shared host work pool
(`workpool`), the metrics providers and logging registry
(`metrics`, `flogging`), the nodes' configuration (`config` over the YAML
reader `yamlsub`), operations endpoint (`operations`), limiter
(`semaphore`) and thread dump (`diag`)."""
