"""Peer-side validation and commit of the port: the transaction validator,
its validation plugins, the committer, and the deliver client that pulls
blocks from the ordering service."""
