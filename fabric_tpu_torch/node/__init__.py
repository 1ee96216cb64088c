"""The port's node daemons (copies of `fabric_tpu/node/`): the orderer
(`orderer_node`), the peer (`peer_node`) and the single-process
development node (`devnode`)."""
