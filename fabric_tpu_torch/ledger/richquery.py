"""Rich (JSON selector) state queries, the CouchDB backend's capability
(the port's copy of `fabric_tpu/ledger/richquery.py`; reference
core/ledger/kvledger/txmgmt/statedb/statecouchdb, Mango selector queries,
GetQueryResult to chaincode).

The selector subset: implicit equality, $eq $ne $gt $gte $lt $lte $in
$nin $exists, dotted field paths, $and and $or, and an optional "limit".

A selector runs on an index when the state DB defines one on a field it
constrains conjunctively (`statedb.VersionedDB.define_index`): the
planner prefers a compound index whose fields are all covered by
equalities (the last may carry one $in or range; more fields win), then
a single field ($eq, then $in, then a range).  It range-scans the index
for candidate keys and rechecks every candidate document against the
whole selector, so an imprecise index can only over-select.  Results
are in key order and cut by the limit as the scan's are, so endorsement
read-write sets are the same with or without an index.  Without a usable
index the selector scans the namespace.

As in the reference, rich-query results have no phantom protection
(statecouchdb documents the caveat); only range queries do.
"""

from __future__ import annotations

import json
from typing import Iterable

from fabric_tpu_torch.ledger.statedb import INDEX_SPEC_SEP, encode_scalar


def _field(doc, path: str):
    cur = doc
    for part in path.split("."):
        if not isinstance(cur, dict) or part not in cur:
            return None, False
        cur = cur[part]
    return cur, True


def _cmp_ok(a, b, op: str) -> bool:
    try:
        if op == "$gt":
            return a > b
        if op == "$gte":
            return a >= b
        if op == "$lt":
            return a < b
        if op == "$lte":
            return a <= b
    except TypeError:
        return False
    return False


def _match_cond(value, present: bool, cond) -> bool:
    if not isinstance(cond, dict):
        return present and value == cond
    for op, operand in cond.items():
        if op == "$eq":
            if not (present and value == operand):
                return False
        elif op == "$ne":
            if present and value == operand:
                return False
        elif op in ("$gt", "$gte", "$lt", "$lte"):
            if not (present and _cmp_ok(value, operand, op)):
                return False
        elif op == "$in":
            if not (present and value in operand):
                return False
        elif op == "$nin":
            if present and value in operand:
                return False
        elif op == "$exists":
            if bool(operand) != present:
                return False
        else:
            raise ValueError(f"unsupported operator {op!r}")
    return True


def match_selector(doc, selector: dict) -> bool:
    for key, cond in selector.items():
        if key == "$and":
            if not all(match_selector(doc, s) for s in cond):
                return False
        elif key == "$or":
            if not any(match_selector(doc, s) for s in cond):
                return False
        else:
            value, present = _field(doc, key)
            if not _match_cond(value, present, cond):
                return False
    return True


def _parse_query(query: str) -> tuple[dict, int | None]:
    q = json.loads(query)
    selector = q.get("selector", {}) if isinstance(q, dict) else {}
    limit = q.get("limit") if isinstance(q, dict) else None
    if limit is not None:
        if not isinstance(limit, int) or isinstance(limit, bool) or limit < 0:
            raise ValueError(f"invalid limit {limit!r}")
    return selector, limit


def _conjunctive_conds(selector: dict) -> list[tuple[str, object]]:
    """(field, condition) pairs that must ALL hold — top-level fields
    plus $and arms; $or arms contribute nothing (any single-field
    prefilter would under-select a disjunction)."""
    out: list[tuple[str, object]] = []
    for key, cond in selector.items():
        if key == "$and":
            for sub in cond:
                if isinstance(sub, dict):
                    out.extend(_conjunctive_conds(sub))
        elif key != "$or":
            out.append((key, cond))
    return out


def _field_conds(selector: dict) -> dict:
    """field -> first usable condition kind for index planning:
    ("eq", v) | ("in", [vs]) | ("range", lo|None, hi|None).  eq wins
    over in over range when a field carries several conjuncts."""
    out: dict = {}

    def rank(kind):  # lower is better
        return {"eq": 0, "in": 1, "range": 2}[kind]

    for f, cond in _conjunctive_conds(selector):
        cand = None
        if not isinstance(cond, dict):
            cand = ("eq", cond)
        elif "$eq" in cond:
            cand = ("eq", cond["$eq"])
        elif isinstance(cond.get("$in"), list):
            cand = ("in", cond["$in"])
        else:
            lo = cond.get("$gte", cond.get("$gt"))
            hi = cond.get("$lte", cond.get("$lt"))
            if lo is not None or hi is not None:
                cand = ("range", lo, hi)
        if cand is None:
            continue
        cur = out.get(f)
        if cur is None or rank(cand[0]) < rank(cur[0]):
            out[f] = cand
    return out


def plan_compound(selector: dict, indexed: set) -> tuple | None:
    """Best compound-index prefilter: ("comp", spec, fields, eq_values,
    last|None) where eq_values cover fields[:len(eq_values)] and `last`
    is an ("in", vs) / ("range", lo, hi) condition on the LAST field.

    A compound index is usable ONLY when the selector constrains EVERY
    field of the index (equalities on all but optionally the last,
    which may carry one in/range): a document missing any indexed
    field is absent from the index, so a selector that leaves a field
    unconstrained could match documents the index cannot return —
    CouchDB's well-known partial-index under-selection gotcha, which
    this planner must never reproduce.  Every planned condition
    requires presence of a scalar, so index membership covers exactly
    the candidate set.  More fields win; all-eq beats a trailing
    range."""
    conds = _field_conds(selector)
    best = None  # (score, plan)
    for spec in indexed:
        if INDEX_SPEC_SEP not in spec:
            continue
        fields = spec.split(INDEX_SPEC_SEP)
        eq_values: list = []
        last = None
        for pos, f in enumerate(fields):
            c = conds.get(f)
            if c is None:
                break
            if c[0] == "eq":
                eq_values.append(c[1])
                continue
            if pos == len(fields) - 1:
                last = c  # non-eq allowed only on the final field
            break
        if len(eq_values) + (1 if last is not None else 0) != len(fields):
            continue  # not fully covered: unusable (see docstring)
        score = (len(fields), 1 if last is None else 0)
        if best is None or score > best[0]:
            best = (score, ("comp", spec, fields, eq_values, last))
    return best[1] if best else None


def plan_index(selector: dict, indexed: set) -> tuple | None:
    """Pick the best indexed prefilter: ("comp", ...) (see
    plan_compound) | ("eq", field, value) | ("in", field, values) |
    ("range", field, lo|None, hi|None) | None.  Range bounds are
    widened to inclusive (the recheck restores exactness)."""
    comp = plan_compound(selector, indexed)
    if comp is not None:
        return comp
    return plan_single(selector, indexed)


def plan_single(selector: dict, indexed: set) -> tuple | None:
    """The single-field arm of plan_index — also the EXECUTION-TIME
    fallback when a compound plan turns out unservable (non-scalar
    operand, probe fan-out): a query a single-field index served before
    a compound index existed must keep being served after."""
    conds = [
        (f, c) for f, c in _conjunctive_conds(selector) if f in indexed
    ]
    for field, cond in conds:
        if not isinstance(cond, dict):
            return ("eq", field, cond)
        if "$eq" in cond:
            return ("eq", field, cond["$eq"])
    for field, cond in conds:
        if isinstance(cond, dict) and isinstance(cond.get("$in"), list):
            return ("in", field, cond["$in"])
    for field, cond in conds:
        if not isinstance(cond, dict):
            continue
        lo = cond.get("$gte", cond.get("$gt"))
        hi = cond.get("$lte", cond.get("$lt"))
        if lo is not None or hi is not None:
            return ("range", field, lo, hi)
    return None


def _eq_encodings(v) -> list[bytes] | None:
    """All index encodings an equality operand must probe, or None when
    the index cannot serve it (caller falls back to the full scan).

    Two invariants keep "index can only over-select" true: (a) docs with
    non-scalar values (arrays/objects) are never indexed, so an
    unencodable operand means the index would silently drop matches;
    (b) match_selector compares with Python ==, under which True == 1
    and False == 0, while bool and number encode under different type
    tags — so bool operands also probe the numeric entry and 0/1
    numeric operands also probe the bool entry."""
    enc = encode_scalar(v)
    if enc is None:
        return None
    probes = [enc]
    if isinstance(v, bool):
        probes.append(encode_scalar(int(v)))
    elif isinstance(v, (int, float)) and v in (0, 1):
        probes.append(encode_scalar(bool(v)))
    return probes


def _component_probes(v) -> list[bytes] | None:
    """_eq_encodings in compound-component form (strings carry their
    composite terminator)."""
    probes = _eq_encodings(v)
    if probes is None:
        return None
    return [p + b"\x00" if p[:1] == b"\x04" else p for p in probes]


def _compound_keys(db, ns: str, plan) -> list | None:
    """Candidate state keys for a ("comp", ...) plan, or None when an
    operand cannot ride the index (caller falls back to the scan)."""
    _, spec, _fields, eq_values, last = plan
    # cartesian product of per-component probe sets (bool/number twin
    # probes give at most 2 per component; cap the fan-out anyway)
    prefixes = [b""]
    for v in eq_values:
        probes = _component_probes(v)
        if probes is None:
            return None
        prefixes = [p + e for p in prefixes for e in probes]
        if len(prefixes) > 32:
            return None
    keys: list = []
    if last is None:
        for p in prefixes:
            keys.extend(db.index_scan(ns, spec, p, p))
        return keys
    if last[0] == "in":
        for v in last[1]:
            probes = _component_probes(v)
            if probes is None:
                return None
            for p in prefixes:
                for e in probes:
                    keys.extend(db.index_scan(ns, spec, p + e, p + e))
        return keys
    # trailing range on the next component
    _, lo, hi = last
    if isinstance(lo, bool) or isinstance(hi, bool):
        return None  # bool bounds cross-compare with numbers: scan
    lo_enc = encode_scalar(lo) if lo is not None else None
    hi_enc = encode_scalar(hi) if hi is not None else None
    if (lo is not None and lo_enc is None) or (
        hi is not None and hi_enc is None
    ):
        return None
    if lo_enc is not None and lo_enc[:1] == b"\x04":
        lo_enc += b"\x00"
    if hi_enc is not None and hi_enc[:1] == b"\x04":
        hi_enc += b"\x00"
    for p in prefixes:
        # open ends stay INSIDE this eq-prefix: every component
        # encoding starts with a tag <= \x04, so \xfd\xff caps the
        # prefix's region without crossing into the next prefix
        start = p + (lo_enc if lo_enc is not None else b"")
        end = p + (hi_enc if hi_enc is not None else b"\xfd\xff")
        keys.extend(db.index_scan(ns, spec, start, end))
        lo_num = lo if isinstance(lo, (int, float)) else None
        hi_num = hi if isinstance(hi, (int, float)) else None
        if (lo_num is not None or hi_num is not None) and (
            lo_num is None or lo_num <= 1
        ) and (hi_num is None or hi_num >= 0):
            # bool doc values order-compare with numeric bounds under
            # Python but live under a different type tag (see the
            # single-field sweep below)
            bool_lo = p + encode_scalar(False)
            bool_hi = p + encode_scalar(True)
            keys.extend(db.index_scan(ns, spec, bool_lo, bool_hi))
    return keys


def execute_query_indexed(db, ns: str, query: str):
    """Index-assisted execution against a statedb.VersionedDB; returns
    [(key, value, version)] in key order, or None when no defined index
    matches the selector (caller falls back to the scan path)."""
    selector, limit = _parse_query(query)
    indexed = db.indexes_for(ns)
    p = plan_index(selector, indexed)
    if p is not None and p[0] == "comp":
        keys = _compound_keys(db, ns, p)
        if keys is None:
            # compound plan unservable at execution time (non-scalar
            # operand, probe fan-out): retry the single-field planner
            # before surrendering to the full scan
            p = plan_single(selector, indexed)
        else:
            p = ("_done",)
    if p is None:
        return None
    if p[0] == "_done":
        pass
    elif p[0] in ("eq", "in"):
        operands = [p[2]] if p[0] == "eq" else list(p[2])
        keys = []
        for v in operands:
            probes = _eq_encodings(v)
            if probes is None:
                return None  # index can't serve this operand: full scan
            for enc in probes:
                keys.extend(db.index_scan(ns, p[1], enc, enc))
    else:
        _, field, lo, hi = p
        if isinstance(lo, bool) or isinstance(hi, bool):
            return None  # bool bounds cross-compare with numbers: scan
        lo_enc = encode_scalar(lo) if lo is not None else None
        hi_enc = encode_scalar(hi) if hi is not None else None
        if (lo is not None and lo_enc is None) or (
            hi is not None and hi_enc is None
        ):
            return None  # unencodable bound: fall back to the scan
        keys = list(db.index_scan(ns, field, lo_enc, hi_enc))
        lo_num = lo if isinstance(lo, (int, float)) else None
        hi_num = hi if isinstance(hi, (int, float)) else None
        if (lo_num is not None or hi_num is not None) and (
            lo_num is None or lo_num <= 1
        ) and (hi_num is None or hi_num >= 0):
            # bool doc values order-compare with numeric bounds under
            # Python (True >= 1), but live under a different type tag —
            # sweep the (two-value) bool region when the bounds overlap
            # [False, True] ≡ [0, 1]; the recheck is exact
            keys.extend(
                db.index_scan(ns, field, encode_scalar(False), encode_scalar(True))
            )
    out = []
    for key in sorted(set(keys)):
        vv = db.get_state(ns, key)
        if vv is None:
            continue
        try:
            doc = json.loads(vv.value.decode("utf-8"))
        except (ValueError, RecursionError):
            continue  # a value that is no JSON never matches (CouchDB)
        if isinstance(doc, dict) and match_selector(doc, selector):
            out.append((key, vv.value, vv.version))
            if limit is not None and len(out) >= limit:
                break
    return out


def execute_query(
    pairs: Iterable[tuple[str, bytes]], query: str
) -> list[tuple[str, bytes]]:
    """Filter (key, value) pairs by a JSON selector query string."""
    selector, limit = _parse_query(query)
    out = []
    for key, value in pairs:
        if limit is not None and len(out) >= limit:
            break
        try:
            doc = json.loads(value.decode("utf-8"))
        except (ValueError, RecursionError):
            continue  # a value that is no JSON never matches (CouchDB)
        if not isinstance(doc, dict):
            continue
        if match_selector(doc, selector):
            out.append((key, value))
    return out


__all__ = [
    "match_selector",
    "execute_query",
    "execute_query_indexed",
    "plan_index",
    "plan_compound",
]
