"""Peer-side block validation of the port: the transaction validator and
its validation plugins."""
