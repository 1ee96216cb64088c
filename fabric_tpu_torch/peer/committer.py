"""Commit orchestration: validate, commit, announce (the port's copy of
`fabric_tpu/peer/committer.py`, without metrics or tracing).

Reference: gossip/privdata/coordinator.go:149 StoreBlock (the validator,
then CommitLegacy) and core/committer/committer_impl.go.

`store_stream` overlaps three stages across blocks: the validator's host
collect, the device verify (the CSP's asynchronous batch), and MVCC with
persistence on a committer thread that commits up to `depth` blocks as one
group (one block-file fdatasync and one KV transaction), flushing early at
a block with a pending snapshot request.
"""

from __future__ import annotations

import collections
import queue
import threading

from fabric_tpu_torch import protoutil
from fabric_tpu_torch.protos import common as cb


class Committer:
    def __init__(self, validator, ledger):
        self._validator = validator
        self._ledger = ledger
        self._listeners: list = []
        self._lock = threading.Lock()

    def add_commit_listener(self, fn) -> None:
        """`fn(block, flags)` after each block is durable."""
        self._listeners.append(fn)

    def store_block(self, block) -> list[int]:
        """Validate and commit one block (a `Block` or its bytes); returns
        its final flags."""
        if not isinstance(block, cb.Block):
            block = cb.Block.decode(block)
        self._validator.validate(block)  # signature and policy flags
        with self._lock:
            self._ledger.commit(block)  # MVCC and persistence
        flags = list(protoutil.tx_filter(block))
        for fn in self._listeners:
            fn(block, flags)
        return flags

    def store_stream(self, blocks, depth: int = 3):
        """Validate and commit a stream of blocks (`Block`s or their bytes);
        yields each block's final (post-MVCC) flags in order.

        Key-level policy reads for block k+1 may precede block k's commit,
        as in `validate_pipeline`; depth=1 keeps strict adjacency.  The
        committer thread buffers up to `depth` blocks into one CommitGroup
        and flushes when `depth` are buffered, its queue is empty, or a
        buffered block has a pending snapshot request.
        Listeners, the release of each block's txids from the validator's
        duplicate window, and the yielded flags all wait for the flush:
        nothing is announced before it is durable.  An error on the
        committer thread (a raising listener too) reaches the consumer,
        and no later block commits."""
        pending: collections.deque = collections.deque()
        releases: collections.deque = collections.deque()
        assists: collections.deque = collections.deque()

        def tee(it):
            for b in it:
                if not isinstance(b, cb.Block):
                    b = cb.Block.decode(b)
                pending.append(b)
                yield b

        commit_q: queue.Queue = queue.Queue(maxsize=depth)
        done_q: queue.Queue = queue.Queue()

        def commit_loop():
            failed = False
            group = self._ledger.begin_commit_group()
            grouped: list = []  # (block, release) awaiting the flush

            def announce():
                # outside self._lock: a listener may re-enter the committer
                for blk, release in grouped:
                    release()  # the ledger's index now holds these txids
                    flags = list(protoutil.tx_filter(blk))
                    for fn in self._listeners:
                        fn(blk, flags)
                    done_q.put(flags)
                grouped.clear()

            while True:
                item = commit_q.get()
                if item is None:
                    if not failed and grouped:
                        try:
                            with self._lock:
                                self._ledger.commit_group_flush(group)
                            announce()
                        except Exception as e:
                            done_q.put(e)
                    return
                if failed:
                    continue  # drain, committing nothing past a failure
                blk, release, assist = item
                try:
                    flushed = False
                    with self._lock:
                        self._ledger.commit(blk, assist=assist, group=group)
                        grouped.append((blk, release))
                        # a buffered block with a pending snapshot request
                        # flushes here: the export is at that height
                        if (len(grouped) >= depth or commit_q.empty()
                                or group.boundary_hint):
                            self._ledger.commit_group_flush(group)
                            flushed = True
                    if flushed:
                        announce()
                except Exception as e:  # reaches the consumer
                    failed = True
                    done_q.put(e)

        th = threading.Thread(target=commit_loop, name="committer-stream",
                              daemon=True)
        th.start()
        n_in = n_out = 0
        try:
            for _flags in self._validator.validate_pipeline(
                    tee(blocks), depth=depth, release=releases.append,
                    rwsets_out=assists.append):
                commit_q.put((pending.popleft(), releases.popleft(),
                              assists.popleft()))
                n_in += 1
                while not done_q.empty():
                    r = done_q.get()
                    if isinstance(r, Exception):
                        raise r
                    n_out += 1
                    yield r
            while n_out < n_in:
                r = done_q.get()
                if isinstance(r, Exception):
                    raise r
                n_out += 1
                yield r
        finally:
            commit_q.put(None)
            th.join()

    @property
    def height(self) -> int:
        """The durable height: a buffered group's blocks are neither
        readable nor sure to survive (a failed flush rolls them back)."""
        return self._ledger.durable_height


__all__ = ["Committer"]
