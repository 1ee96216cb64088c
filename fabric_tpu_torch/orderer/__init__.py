"""The ordering service of the port (copies of the JAX package's
`fabric_tpu/orderer/` modules of the same names): the block cutter and
writer, the broadcast filters and handler, the solo and kafka consenters,
the follower and inactive chains, and the multichannel registrar."""
