"""Peer-side validation and commit of the port: the transaction validator,
its validation plugins, and the committer."""
