"""A deterministic Raft state machine for the ordering service (the
port's copy of `fabric_tpu/orderer/raft/raftcore.py`; reference
orderer/consensus/etcdraft over etcd's raft library).

`RaftNode` has etcd's Ready-style API: `tick()` advances the logical
clock, `step(msg)` feeds one RaftMessage from a peer, `propose(data)`
appends a normal entry on the leader, `ready()` drains the messages to
send, the entries and hard state to persist, the entries to apply and a
snapshot to install; no threads, sockets or clocks.  Pre-vote, randomized
election timeouts (drawn from the caller's `rng: random.Random`, so the
same seed, schedule and inputs give the same messages as the JAX
package's), log replication with conflict back-off hints, commit by
quorum match, single-node conf changes and snapshot install.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field

from fabric_tpu_torch.protos import orderer as ob

FOLLOWER, CANDIDATE, LEADER, PRE_CANDIDATE = range(4)


class MemoryLog:
    """The in-memory raft log, offset by the last compaction: entries[i]
    holds raft index `first_index + i`; the index of the snapshot (0 at
    first) is the sentinel before the log."""

    def __init__(self):
        self.entries: list[ob.Entry] = []
        self.snap_index = 0  # compacted up to and including this index
        self.snap_term = 0

    @property
    def first_index(self) -> int:
        return self.snap_index + 1

    @property
    def last_index(self) -> int:
        return self.snap_index + len(self.entries)

    def term(self, index: int) -> int | None:
        """The term of `index`, or None if compacted away or past the
        log."""
        if index == self.snap_index:
            return self.snap_term
        if index < self.snap_index or index > self.last_index:
            return None
        return self.entries[index - self.first_index].term

    def last_term(self) -> int:
        return self.term(self.last_index) or 0

    def slice(self, lo: int, hi: int | None = None) -> list[ob.Entry]:
        hi = self.last_index if hi is None else hi
        if lo < self.first_index:
            raise KeyError(f"slice({lo}) below first_index {self.first_index}")
        return self.entries[lo - self.first_index: hi - self.first_index + 1]

    def append(self, entries: list[ob.Entry]) -> None:
        self.entries.extend(entries)

    def truncate_from(self, index: int) -> None:
        """Drop the entries at `index` and after (a conflict)."""
        del self.entries[index - self.first_index:]

    def compact(self, index: int) -> None:
        """Discard the entries up to and including `index`."""
        term = self.term(index)
        if term is None:
            return
        del self.entries[: index - self.first_index + 1]
        self.snap_index, self.snap_term = index, term

    def reset_to_snapshot(self, index: int, term: int) -> None:
        self.entries = []
        self.snap_index, self.snap_term = index, term


@dataclass
class Ready:
    messages: list = field(default_factory=list)  # RaftMessages to send
    persist_entries: list = field(default_factory=list)  # to the WAL
    hard_state: ob.HardState | None = None  # to persist when set
    committed: list = field(default_factory=list)  # to apply
    snapshot: ob.Snapshot | None = None  # to install (a follower)
    soft_leader: int | None = None  # the current leader's id

    def empty(self) -> bool:
        return not (self.messages or self.persist_entries or self.hard_state
                    or self.committed or self.snapshot)


class RaftNode:
    # the chain fills a snapshot's application payload through this
    snapshot_payload_fn = None

    def __init__(self, node_id: int, voters: set[int],
                 log: MemoryLog | None = None, election_tick: int = 10,
                 heartbeat_tick: int = 1, rng: random.Random | None = None,
                 term: int = 0, voted_for: int = 0, commit: int = 0,
                 applied: int | None = None, max_batch_entries: int = 64):
        self.id = node_id
        self.voters = set(voters)
        self.log = log or MemoryLog()
        self.term = term
        self.voted_for = voted_for
        self.commit = max(commit, self.log.snap_index)
        self.applied = self.log.snap_index if applied is None else applied
        self.state = FOLLOWER
        self.leader = 0
        self.election_tick = election_tick
        self.heartbeat_tick = heartbeat_tick
        self._rng = rng or random.Random()
        self._elapsed = 0
        self._timeout = self._rand_timeout()
        self._max_batch = max_batch_entries
        self.match: dict[int, int] = {}
        self.next: dict[int, int] = {}
        self._votes: dict[int, bool] = {}
        self._msgs: list[ob.RaftMessage] = []
        self._unpersisted: list[ob.Entry] = []
        self._pending_snapshot: ob.Snapshot | None = None
        self._hs_dirty = True  # persist the first hard state

    # -- helpers -----------------------------------------------------------

    def _rand_timeout(self) -> int:
        return self.election_tick + self._rng.randrange(self.election_tick)

    def _quorum(self) -> int:
        return len(self.voters) // 2 + 1

    def _msg(self, mtype, to, **kw) -> ob.RaftMessage:
        m = ob.RaftMessage(type=mtype, to=to, term=self.term, sender=self.id)
        for k, v in kw.items():
            setattr(m, k, list(v) if k == "entries" else v)
        return m

    def _send(self, m: ob.RaftMessage) -> None:
        self._msgs.append(m)

    def _become_follower(self, term: int, leader: int) -> None:
        if term > self.term:
            self.term, self.voted_for = term, 0
            self._hs_dirty = True
        self.state = FOLLOWER
        self.leader = leader
        self._elapsed = 0
        self._timeout = self._rand_timeout()

    def _become_leader(self) -> None:
        self.state = LEADER
        self.leader = self.id
        self._elapsed = 0
        self.match = {v: 0 for v in self.voters}
        self.match[self.id] = self.log.last_index
        self.next = {v: self.log.last_index + 1 for v in self.voters}
        # a leader commits entries of earlier terms only through one of
        # its own (Raft 5.4.2): a no-op
        self._append_as_leader([ob.Entry(type=ob.ENTRY_NORMAL, data=b"")])
        self._broadcast_append()

    # -- public API --------------------------------------------------------

    @property
    def is_leader(self) -> bool:
        return self.state == LEADER

    def tick(self) -> None:
        self._elapsed += 1
        if self.state == LEADER:
            if self._elapsed >= self.heartbeat_tick:
                self._elapsed = 0
                self._broadcast_append()
        elif self._elapsed >= self._timeout:
            self._campaign(pre=True)

    def propose(self, data: bytes, etype=ob.ENTRY_NORMAL) -> bool:
        if self.state != LEADER:
            return False
        self._append_as_leader([ob.Entry(type=etype, data=data)])
        self._broadcast_append()
        return True

    def propose_conf_change(self, cc: ob.ConfChange) -> bool:
        return self.propose(cc.encode(), ob.ENTRY_CONF_CHANGE)

    def apply_conf_change(self, cc: ob.ConfChange) -> None:
        """Called by the caller once a conf-change entry is committed."""
        nid = cc.consenter.id
        if cc.action == ob.ConfChange.ADD_NODE:
            self.voters.add(nid)
            if self.state == LEADER and nid not in self.next:
                self.next[nid] = self.log.last_index + 1
                self.match[nid] = 0
        else:
            self.voters.discard(nid)
            self.next.pop(nid, None)
            self.match.pop(nid, None)
            if self.state == LEADER:
                self._maybe_advance_commit()

    def ready(self) -> Ready:
        rd = Ready(soft_leader=self.leader or None)
        rd.messages, self._msgs = self._msgs, []
        rd.persist_entries, self._unpersisted = self._unpersisted, []
        rd.snapshot, self._pending_snapshot = self._pending_snapshot, None
        if self._hs_dirty:
            rd.hard_state = ob.HardState(term=self.term,
                                         voted_for=self.voted_for,
                                         commit=self.commit)
            self._hs_dirty = False
        if self.commit > self.applied:
            lo = max(self.applied + 1, self.log.first_index)
            if lo <= self.commit:
                rd.committed = list(self.log.slice(lo, self.commit))
            self.applied = self.commit
        return rd

    def advance(self) -> None:
        return  # state advances in ready(); kept for the API's symmetry

    # -- election ----------------------------------------------------------

    def _campaign(self, pre: bool) -> None:
        if self.id not in self.voters:
            self._elapsed = 0  # a removed node never campaigns
            return
        self._elapsed = 0
        self._timeout = self._rand_timeout()
        self._votes = {self.id: True}
        # an election means the leader was lost: eviction suspicion
        # keys off leader == 0
        self.leader = 0
        if pre:
            # probe electability at term + 1 without moving the term
            self.state = PRE_CANDIDATE
            if len(self.voters) == 1:
                self._campaign(pre=False)
                return
            for v in self.voters - {self.id}:
                m = self._msg(ob.MSG_PRE_VOTE_REQUEST, v,
                              last_log_index=self.log.last_index,
                              last_log_term=self.log.last_term())
                m.term = self.term + 1
                self._send(m)
            return
        self.state = CANDIDATE
        self.term += 1
        self.voted_for = self.id
        self._hs_dirty = True
        if len(self.voters) == 1:
            self._become_leader()
            return
        for v in self.voters - {self.id}:
            self._send(self._msg(ob.MSG_VOTE_REQUEST, v,
                                 last_log_index=self.log.last_index,
                                 last_log_term=self.log.last_term()))

    def _log_up_to_date(self, m: ob.RaftMessage) -> bool:
        lt, li = self.log.last_term(), self.log.last_index
        return (m.last_log_term, m.last_log_index) >= (lt, li)

    # -- message handling --------------------------------------------------

    def step(self, m: ob.RaftMessage) -> None:
        if m.term > self.term:
            if m.type in (ob.MSG_PRE_VOTE_REQUEST, ob.MSG_PRE_VOTE_RESPONSE):
                pass  # pre-vote traffic never moves the term
            elif m.type in (ob.MSG_APPEND, ob.MSG_SNAPSHOT):
                self._become_follower(m.term, m.sender)
            else:
                self._become_follower(m.term, 0)
        elif m.term < self.term:
            if m.type == ob.MSG_APPEND:
                # a stale leader: tell it the current term
                self._send(self._msg(ob.MSG_APPEND_RESPONSE, m.sender,
                                     success=False))
            return
        handler = {
            ob.MSG_PRE_VOTE_REQUEST: self._on_pre_vote_request,
            ob.MSG_PRE_VOTE_RESPONSE: self._on_pre_vote_response,
            ob.MSG_VOTE_REQUEST: self._on_vote_request,
            ob.MSG_VOTE_RESPONSE: self._on_vote_response,
            ob.MSG_APPEND: self._on_append,
            ob.MSG_APPEND_RESPONSE: self._on_append_response,
            ob.MSG_SNAPSHOT: self._on_snapshot,
        }[m.type]
        handler(m)

    def _on_pre_vote_request(self, m: ob.RaftMessage) -> None:
        # grant as a real vote would be: no leader heard from lately, and
        # the candidate's log up to date
        grant = (m.term > self.term and self._log_up_to_date(m)
                 and (self.leader == 0 or self._elapsed >= self.election_tick))
        resp = self._msg(ob.MSG_PRE_VOTE_RESPONSE, m.sender,
                         vote_granted=grant)
        resp.term = m.term
        self._send(resp)

    def _on_pre_vote_response(self, m: ob.RaftMessage) -> None:
        if self.state != PRE_CANDIDATE:
            return
        self._votes[m.sender] = m.vote_granted
        if sum(self._votes.values()) >= self._quorum():
            self._campaign(pre=False)

    def _on_vote_request(self, m: ob.RaftMessage) -> None:
        can_vote = self.voted_for in (0, m.sender)
        grant = can_vote and self._log_up_to_date(m)
        if grant:
            self.voted_for = m.sender
            self._hs_dirty = True
            self._elapsed = 0
        self._send(self._msg(ob.MSG_VOTE_RESPONSE, m.sender,
                             vote_granted=grant))

    def _on_vote_response(self, m: ob.RaftMessage) -> None:
        if self.state != CANDIDATE:
            return
        self._votes[m.sender] = m.vote_granted
        if sum(self._votes.values()) >= self._quorum():
            self._become_leader()
        elif sum(1 for g in self._votes.values() if not g) >= self._quorum():
            self._become_follower(self.term, 0)

    # -- replication, the follower's side ---------------------------------

    def _on_append(self, m: ob.RaftMessage) -> None:
        self._become_follower(m.term, m.sender)
        prev_term = self.log.term(m.prev_log_index)
        if prev_term is None or prev_term != m.prev_log_term:
            self._send(self._msg(ob.MSG_APPEND_RESPONSE, m.sender,
                                 success=False,
                                 reject_hint=self.log.last_index))
            return
        new = list(m.entries)
        # skip the entries already held; truncate at the first conflict
        for i, e in enumerate(new):
            t = self.log.term(e.index)
            if t is None and e.index > self.log.last_index:
                new = new[i:]
                break
            if t != e.term:
                self.log.truncate_from(e.index)  # never committed
                new = new[i:]
                break
        else:
            new = []
        if new:
            self.log.append(new)
            self._unpersisted.extend(new)
        if m.leader_commit > self.commit:
            self.commit = min(m.leader_commit, self.log.last_index)
            self._hs_dirty = True
        self._send(self._msg(ob.MSG_APPEND_RESPONSE, m.sender, success=True,
                             match_index=m.prev_log_index + len(m.entries)))

    def _on_snapshot(self, m: ob.RaftMessage) -> None:
        self._become_follower(m.term, m.sender)
        snap = m.snapshot
        if snap.meta.index <= self.commit:
            # a stale snapshot: acknowledge our progress
            self._send(self._msg(ob.MSG_APPEND_RESPONSE, m.sender,
                                 success=True, match_index=self.commit))
            return
        self.log.reset_to_snapshot(snap.meta.index, snap.meta.term)
        self.commit = snap.meta.index
        self.applied = snap.meta.index
        self.voters = set(snap.meta.voters)
        self._hs_dirty = True
        self._pending_snapshot = snap
        self._send(self._msg(ob.MSG_APPEND_RESPONSE, m.sender, success=True,
                             match_index=snap.meta.index))

    # -- replication, the leader's side -----------------------------------

    def _append_as_leader(self, entries: list[ob.Entry]) -> None:
        base = self.log.last_index
        for i, e in enumerate(entries):
            e.index = base + 1 + i
            e.term = self.term
        self.log.append(entries)
        self._unpersisted.extend(entries)
        self.match[self.id] = self.log.last_index
        if len(self.voters) == 1:
            self._maybe_advance_commit()

    def _send_append(self, to: int) -> None:
        nxt = self.next[to]
        prev = nxt - 1
        prev_term = self.log.term(prev)
        if prev_term is None:
            # the follower is behind the compaction point: a snapshot
            self._send(self._msg(ob.MSG_SNAPSHOT, to,
                                 snapshot=self._make_snapshot()))
            return
        entries = self.log.slice(nxt)[: self._max_batch]
        self._send(self._msg(ob.MSG_APPEND, to, prev_log_index=prev,
                             prev_log_term=prev_term, entries=entries,
                             leader_commit=self.commit))

    def _make_snapshot(self) -> ob.Snapshot:
        snap = ob.Snapshot(meta=ob.SnapshotMeta(
            index=self.log.snap_index, term=self.log.snap_term,
            voters=sorted(self.voters)))
        fn = self.snapshot_payload_fn
        if fn:
            fn(snap)
        return snap

    def _broadcast_append(self) -> None:
        for v in self.voters:
            if v != self.id:
                self._send_append(v)

    def _on_append_response(self, m: ob.RaftMessage) -> None:
        if self.state != LEADER:
            return
        if not m.success:
            # back off with the follower's hint and retry
            self.next[m.sender] = max(1, min(self.next.get(m.sender, 1) - 1,
                                             m.reject_hint + 1))
            self._send_append(m.sender)
            return
        if m.sender not in self.match:
            return  # not a voter (just removed)
        if m.match_index > self.match[m.sender]:
            self.match[m.sender] = m.match_index
        self.next[m.sender] = max(self.next[m.sender], m.match_index + 1)
        self._maybe_advance_commit()
        if self.next[m.sender] <= self.log.last_index:
            self._send_append(m.sender)  # stream the backlog

    def _maybe_advance_commit(self) -> None:
        matches = sorted((self.match.get(v, 0) for v in self.voters),
                         reverse=True)
        candidate = matches[self._quorum() - 1]
        # commit only the current term's entries directly (Raft 5.4.2)
        if candidate > self.commit and self.log.term(candidate) == self.term:
            self.commit = candidate
            self._hs_dirty = True
            self._broadcast_append()  # spread the commit index at once

    def compact(self, index: int) -> None:
        self.log.compact(index)


__all__ = ["RaftNode", "MemoryLog", "Ready", "FOLLOWER", "CANDIDATE", "LEADER"]
