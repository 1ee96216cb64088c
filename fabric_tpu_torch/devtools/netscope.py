"""netscope — the cluster-wide telemetry plane for netharness runs (the
port's copy of `fabric_tpu/devtools/netscope.py`).

A netharness topology is an N-org × M-peer × K-orderer network of OS
processes with per-node metric islands (`GET /metrics`), health checks, and tracelens
flight recorders — and nothing watching any of it over time.  Netscope
is the harness-side collector that turns those islands into one
observable cluster:

- a SCRAPER that polls every node's ``/metrics``, ``/healthz?detail=1``
  and ``/traces?since=<cursor>`` on a seeded cadence routed through the
  clockskew provider, so a virtual-clock session scrapes (and
  timestamps) deterministically — two same-seed virtual-clock sessions
  produce byte-identical series;
- a Prometheus TEXT PARSER (:func:`parse_prometheus`) that turns the
  exposition format back into exact samples — round-trip fidelity with
  ``PrometheusRegistry.expose`` is pinned by tests/test_metrics.py;
- a TSDB-LITE: one bounded ring buffer per (node, series, labelset),
  plus derived series computed per scrape round — cross-peer commit
  lag (``max(height) - min(height)`` over the scraped ``ledger_height``
  gauges) stops being a harness-internal sample and becomes data;
- a STALL DETECTOR: when one node's height stops advancing for
  ``stall_window`` rounds while a quorum of its peers advances, the
  node is flagged (with the evidence window), a tracelens instant mark
  is dropped, and the verdict JSON carries the node name — the
  deliver-client-wedge class, detected;
- SLO ROLLUPS (:meth:`Netscope.slo`): p99 cross-peer lag, catch-up
  seconds after restart markers, sustained committed tx/s — judged
  against caller thresholds for the netbench verdict;
- ARTIFACTS: ``netscope.jsonl`` (one self-describing JSON line per
  series/health-timeline/event/rollup) and a self-contained single-file
  HTML report (inline SVG sparklines per series, per-node health
  timeline, kill/restart/stall markers) written next to the bench JSON
  line and trace dumps.

The scraper thread registers through ``lockwatch.spawn_thread``
(threadwatch kind=service) and every shared mutable structure moves
under the ``netscope.state`` lock (declared in ``devtools/guards.py``
for fabriclint's racecheck).
"""

from __future__ import annotations

import collections
import html as _html
import http.client
import json
import os
import random

from fabric_tpu_torch.common import tracing
from fabric_tpu_torch.devtools import clockskew
from fabric_tpu_torch.devtools.lockwatch import named_lock, spawn_thread

# exposition series whose cardinality explodes per scrape (one sample
# per histogram bucket); the ring buffers keep the _sum/_count pair,
# which is what rate/latency rollups need
_DROP_SUFFIX = "_bucket"


# -- prometheus text parsing --------------------------------------------------


def _unescape_label_value(raw: str) -> str:
    out = []
    i = 0
    while i < len(raw):
        c = raw[i]
        if c == "\\" and i + 1 < len(raw):
            nxt = raw[i + 1]
            if nxt == "\\":
                out.append("\\")
            elif nxt == '"':
                out.append('"')
            elif nxt == "n":
                out.append("\n")
            else:  # unknown escape: keep verbatim (spec-compatible)
                out.append(c)
                out.append(nxt)
            i += 2
            continue
        out.append(c)
        i += 1
    return "".join(out)


def _parse_labels(raw: str) -> tuple[tuple[str, str], ...]:
    """``name="value",...`` -> sorted ((name, value), ...).  Values may
    contain escaped quotes/backslashes/newlines and literal commas."""
    labels: list[tuple[str, str]] = []
    i = 0
    n = len(raw)
    while i < n:
        eq = raw.index("=", i)
        name = raw[i:eq].strip()
        i = eq + 1
        if raw[i] != '"':
            raise ValueError(f"unquoted label value at {i} in {raw!r}")
        i += 1
        start = i
        while i < n:
            if raw[i] == "\\":
                i += 2
                continue
            if raw[i] == '"':
                break
            i += 1
        labels.append((name, _unescape_label_value(raw[start:i])))
        i += 1  # closing quote
        while i < n and raw[i] in ", ":
            i += 1
    return tuple(sorted(labels))


def parse_prometheus(text: str) -> list[tuple[str, tuple, float]]:
    """Parse the Prometheus text exposition format back into samples:
    ``[(metric_name, ((label, value), ...), float_value), ...]``.
    Inverse of ``PrometheusRegistry.expose`` (including label-value
    escaping) — the round trip is pinned byte-faithful by
    tests/test_metrics.py."""
    samples: list[tuple[str, tuple, float]] = []
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        if "{" in line:
            try:
                name, rest = line.split("{", 1)
                labels_raw, value_raw = rest.rsplit("}", 1)
                labels = _parse_labels(labels_raw)
            except ValueError:
                continue  # malformed labeled line: skip it too
        else:
            parts = line.rsplit(None, 1)
            if len(parts) != 2:
                continue  # malformed line: skip, never kill the scrape
            name, value_raw = parts
            labels = ()
        try:
            value = float(value_raw)
        except ValueError:
            continue
        samples.append((name.strip(), labels, value))
    return samples


# -- the collector ------------------------------------------------------------


class Netscope:
    """Harness-side telemetry collector over a set of operations
    endpoints (``targets``: node name -> (host, port)).

    Two driving modes share :meth:`scrape_once`:

    - threaded (:meth:`start`/:meth:`stop`) for live netbench/chaos
      runs — the loop waits through ``clockskew.wait`` so a virtual
      clock compresses the cadence deterministically;
    - synchronous (:meth:`run_rounds`) for deterministic sessions —
      each round scrapes then advances the clock by the next seeded
      interval.
    """

    def __init__(
        self,
        targets: dict[str, tuple[str, int]],
        interval_s: float = 0.25,
        seed: int = 0,
        window: int = 512,
        stall_window: int = 4,
        height_series: str = "ledger_height",
        trace_capacity: int = 20000,
        http_timeout_s: float = 2.0,
        keep_buckets: bool = False,
    ):
        self.targets = dict(targets)
        self.interval_s = float(interval_s)
        self.seed = int(seed)
        self.window = int(window)
        self.stall_window = int(stall_window)
        self.height_series = height_series
        self._http_timeout = float(http_timeout_s)
        self._keep_buckets = keep_buckets
        self._cadence = random.Random(f"netscope:{seed}")
        self._t0 = clockskew.monotonic()
        self._lock = named_lock("netscope.state")
        # (node, name, labels) -> deque[(t, value)]
        self._series: dict[tuple, collections.deque] = {}
        # node -> deque[(t, status, failed_or_none)]
        self._health: dict[str, collections.deque] = {}
        # markers: kill/restart (from the harness), stall/stall_clear
        self._events: list[dict] = []
        # incremental trace collection (bounded, newest kept)
        self._trace_capacity = trace_capacity
        self._trace_events: dict[str, collections.deque] = {
            n: collections.deque(maxlen=trace_capacity) for n in targets
        }
        self._trace_cursor: dict[str, int] = {n: 0 for n in targets}
        # stall-detector state
        self._stalls: dict[str, dict] = {}  # node -> episode record
        self._height_window: collections.deque = collections.deque(
            maxlen=max(stall_window + 2, 8)
        )
        self.rounds = 0
        self._stop = None
        self._thread = None

    def add_target(self, name: str, addr: tuple[str, int]) -> None:
        """Register an extra scrape target after construction — e.g.
        the driver-embedded gateway's operations endpoint, which is not
        a topology node but publishes the gateway_* series the SLO
        rollup and html render like any other node's.  Safe while the
        collector thread runs (scrape rounds snapshot the target set)."""
        with self._lock:
            self.targets[name] = addr
            self._trace_events.setdefault(
                name, collections.deque(maxlen=self._trace_capacity)
            )
            self._trace_cursor.setdefault(name, 0)

    # -- time & cadence ----------------------------------------------------

    def _now(self) -> float:
        return round(clockskew.monotonic() - self._t0, 6)

    def _next_interval(self) -> float:
        """Seeded jitter around the base cadence (±12.5%) — the seed
        pins the whole scrape timeline, so a virtual-clock replay lands
        every sample at the identical virtual microsecond."""
        return self.interval_s * (0.875 + 0.25 * self._cadence.random())

    # -- scraping ----------------------------------------------------------

    def _get(self, node: str, path: str) -> tuple[int, bytes] | None:
        host, port = self.targets[node]
        try:
            conn = http.client.HTTPConnection(
                host, port,
                timeout=clockskew.io_timeout(self._http_timeout),
            )
            try:
                conn.request("GET", path)
                resp = conn.getresponse()
                return resp.status, resp.read()
            finally:
                conn.close()
        except Exception:
            return None  # node down/unreachable: recorded as such

    def scrape_once(self) -> float:
        """One scrape round over every target; returns the round's
        timestamp (seconds since the collector was created)."""
        t = self._now()
        with self._lock:
            cursors = dict(self._trace_cursor)
            round_targets = sorted(self.targets)
        fetched: dict[str, dict] = {}
        for node in round_targets:
            got: dict = {"metrics": None, "health": None, "traces": None}
            raw = self._get(node, "/metrics")
            if raw is not None and raw[0] == 200:
                got["metrics"] = parse_prometheus(
                    raw[1].decode("utf-8", "replace")
                )
            hz = self._get(node, "/healthz?detail=1")
            if hz is not None:
                try:
                    got["health"] = (hz[0], json.loads(hz[1]))
                except ValueError:
                    pass
            tr = self._get(node, f"/traces?since={cursors[node]}")
            if tr is not None and tr[0] == 200:
                try:
                    got["traces"] = json.loads(tr[1])
                except ValueError:
                    pass
            fetched[node] = got
        with self._lock:
            self._ingest(t, fetched)
            self.rounds += 1
        return t

    def _ingest(self, t: float, fetched: dict[str, dict]) -> None:
        heights: dict[str, float] = {}
        for node in sorted(fetched):
            got = fetched[node]
            samples = got["metrics"]
            if samples is not None:
                for name, labels, value in samples:
                    if not self._keep_buckets and name.endswith(
                        _DROP_SUFFIX
                    ):
                        continue
                    key = (node, name, labels)
                    ring = self._series.get(key)
                    if ring is None:
                        ring = collections.deque(maxlen=self.window)
                        self._series[key] = ring
                    ring.append((t, value))
                    if name == self.height_series:
                        # multi-channel nodes: the max across channels
                        # drives the stall/lag view
                        heights[node] = max(
                            heights.get(node, 0.0), value
                        )
            # health timeline: ok / unhealthy (503 with reasons) / down
            hring = self._health.get(node)
            if hring is None:
                hring = collections.deque(maxlen=self.window)
                self._health[node] = hring
            hz = got["health"]
            if samples is None and hz is None:
                hring.append((t, "down", None))
            elif hz is None:
                # /metrics answered but /healthz did not (hung checker,
                # timeout, unparseable body) — that is NOT "ok": record
                # the distinct state so a wedged health endpoint cannot
                # render a green timeline
                hring.append((t, "unknown", None))
            else:
                code, body = hz
                status = "ok" if code == 200 else "unhealthy"
                hring.append(
                    (t, status, body.get("failed_checks") or None)
                )
            doc = got["traces"]
            if doc is not None:
                events = doc.get("traceEvents", [])
                nxt = doc.get("otherData", {}).get("last_event_id", 0)
                if nxt < self._trace_cursor[node]:
                    # recorder reset on the node (restart): resync
                    self._trace_events[node].clear()
                self._trace_cursor[node] = nxt
                self._trace_events[node].extend(events)
        if heights:
            lag = max(heights.values()) - min(heights.values())
            key = ("_derived", "cross_peer_lag_blocks", ())
            ring = self._series.get(key)
            if ring is None:
                ring = collections.deque(maxlen=self.window)
                self._series[key] = ring
            ring.append((t, lag))
        self._height_window.append((t, dict(heights)))
        self._detect_stalls(t, heights)

    # -- stall detector ----------------------------------------------------

    def _detect_stalls(self, t: float, heights: dict[str, float]) -> None:
        """Windowed comparison, not per-round deltas: a node is
        STALLED when its height has not advanced over the last
        ``stall_window`` scrape rounds while a quorum (strict majority)
        of the OTHER height-bearing nodes advanced over that same
        window.  Comparing across the window keeps the detector honest
        when the scrape cadence outpaces block production — peers that
        only commit every few rounds still count as advancing."""
        window = list(self._height_window)
        if len(window) <= self.stall_window:
            return
        base_t, base = window[-(self.stall_window + 1)]
        for node in sorted(heights):
            episode = self._stalls.get(node)
            if episode is not None and not episode.get("cleared") and \
                    heights[node] > episode["height"]:
                episode["cleared"] = True
                self._events.append({
                    "t": t, "event": "stall_clear", "node": node,
                })
            if node not in base:
                continue
            others = [n for n in heights if n != node and n in base]
            quorum = len(others) // 2 + 1 if others else 0
            peers_advancing = sum(
                1 for n in others if heights[n] > base[n]
            )
            stalled_now = (
                heights[node] <= base[node]
                # strictly behind the cluster tip: a node that stops
                # because it IS the tip (an orderer done ordering, a
                # peer fully caught up) is quiescent, not stalled —
                # the others are converging toward it, not past it
                and heights[node] < max(heights.values())
                and quorum
                and peers_advancing >= quorum
            )
            if stalled_now and (
                episode is None or episode.get("cleared")
            ):
                # evidence: the raw height window the verdict (and a
                # chaos repro artifact) can replay the decision from
                self._stalls[node] = {
                    "node": node,
                    "t": t,
                    "height": heights[node],
                    "rounds": self.stall_window,
                    "cleared": False,
                    "evidence": [
                        {"t": wt, "heights": dict(hs)}
                        for wt, hs in window
                    ],
                }
                self._events.append({
                    "t": t, "event": "stall", "node": node,
                    "height": heights[node],
                })
                tracing.instant(
                    "netscope.stall", node=node,
                    height=heights[node],
                    rounds=self.stall_window,
                )

    def trace_event_count(self) -> int:
        with self._lock:
            return sum(len(q) for q in self._trace_events.values())

    def stalled_nodes(self) -> list[str]:
        """Nodes currently flagged (stalled and never recovered)."""
        with self._lock:
            return sorted(
                n for n, ep in self._stalls.items()
                if not ep.get("cleared")
            )

    def stall_episodes(self) -> list[dict]:
        with self._lock:
            return [
                dict(self._stalls[n]) for n in sorted(self._stalls)
            ]

    # -- harness event markers ---------------------------------------------

    def mark(self, event: str, node: str, **extra) -> None:
        """Record a harness-side marker (kill/restart from the kill
        schedule executor, partition/heal from the netsplit executor)
        on the collector's timeline."""
        doc = {"t": self._now(), "event": event, "node": node}
        doc.update(extra)
        with self._lock:
            self._events.append(doc)

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        import threading

        if self._thread is not None and self._thread.is_alive():
            return
        self._stop = threading.Event()
        self._thread = spawn_thread(
            target=self._run, args=(self._stop,),
            name="netscope-scraper", kind="service",
        )
        self._thread.start()

    def stop(self, final_scrape: bool = True) -> None:
        if self._stop is not None:
            self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
        if final_scrape:
            self.scrape_once()

    def _run(self, stop) -> None:
        while not stop.is_set():
            try:
                self.scrape_once()
            except Exception:
                # the observer must never kill a run it observes; a
                # scrape bug shows up as missing rounds in the
                # artifact, not a crash
                pass
            if clockskew.wait(stop, self._next_interval()):
                return

    def run_rounds(self, rounds: int) -> None:
        """Deterministic synchronous driving: scrape, then advance the
        (virtual) clock by the next seeded interval, `rounds` times."""
        for _ in range(rounds):
            self.scrape_once()
            clockskew.sleep(self._next_interval())

    # -- queries -----------------------------------------------------------

    def series(self, node: str, name: str,
               labels: tuple = ()) -> list[tuple[float, float]]:
        with self._lock:
            ring = self._series.get((node, name, tuple(labels)))
            return list(ring) if ring is not None else []

    def series_keys(self) -> list[tuple]:
        with self._lock:
            return sorted(self._series)

    def latest(self, node: str, name: str, labels: tuple = ()):
        pts = self.series(node, name, labels)
        return pts[-1][1] if pts else None

    def _peer_heights(self) -> dict[str, list[tuple[float, float]]]:
        out: dict[str, list] = {}
        with self._lock:
            for (node, name, labels), ring in self._series.items():
                if name == self.height_series and node != "_derived":
                    cur = out.get(node)
                    if cur is None or len(ring) > len(cur):
                        out[node] = list(ring)
        return out

    # -- SLO rollups -------------------------------------------------------

    @staticmethod
    def _percentile(values: list[float], q: float) -> float:
        if not values:
            return 0.0
        vs = sorted(values)
        idx = min(len(vs) - 1, max(0, round(q * (len(vs) - 1))))
        return vs[idx]

    def _catch_up_seconds(self) -> dict[str, float]:
        """Per rejoining node: seconds from its restart marker — or its
        partition-heal marker, a heal being a rejoin over the SAME
        catch-up machinery — to the first scrape round its height
        matches the cluster maximum.  Walks the FULL height series
        rings (window points per node), not the stall detector's short
        height window — that one only retains ~stall_window rounds, so
        a run outlasting it would report the earliest *retained* round
        and grossly inflate the value."""
        heights = self._peer_heights()
        rounds: dict[float, dict[str, float]] = {}
        for node, pts in heights.items():
            for t, v in pts:
                rounds.setdefault(t, {})[node] = v
        with self._lock:
            restarts = [
                e for e in self._events
                if e["event"] in ("restart", "heal")
            ]
        out: dict[str, float] = {}
        for ev in restarts:
            node = ev["node"]
            if node in out or node not in heights:
                continue
            for wt in sorted(rounds):
                hs = rounds[wt]
                if wt <= ev["t"] or node not in hs:
                    continue
                if hs[node] >= max(hs.values()):
                    out[node] = round(wt - ev["t"], 3)
                    break
        return out

    def _sustained_tx_per_s(self) -> float:
        """Best peer's committed-VALID-tx counter slope over the whole
        scrape session."""
        best = 0.0
        with self._lock:
            rings = [
                list(ring)
                for (node, name, labels), ring in self._series.items()
                if name == "ledger_transactions_total"
            ]
        for pts in rings:
            if len(pts) < 2:
                continue
            (t0, v0), (t1, v1) = pts[0], pts[-1]
            if t1 > t0:
                best = max(best, (v1 - v0) / (t1 - t0))
        return round(best, 2)

    def slo(self, thresholds: dict | None = None) -> dict:
        """SLO judgment over the recorded series.  ``thresholds`` keys
        (all optional): ``p99_cross_peer_lag_blocks`` (max),
        ``catch_up_s`` (max), ``min_tx_per_s`` (min).  A currently
        stalled node always fails the rollup."""
        thresholds = thresholds or {}
        lag_pts = self.series("_derived", "cross_peer_lag_blocks")
        p99_lag = self._percentile([v for _, v in lag_pts], 0.99)
        catch_up = self._catch_up_seconds()
        max_catch_up = max(catch_up.values(), default=0.0)
        tx_rate = self._sustained_tx_per_s()
        stalled = self.stalled_nodes()
        judgments: dict[str, dict] = {}
        if "p99_cross_peer_lag_blocks" in thresholds:
            lim = thresholds["p99_cross_peer_lag_blocks"]
            judgments["p99_cross_peer_lag_blocks"] = {
                "value": p99_lag, "limit": lim, "ok": p99_lag <= lim,
            }
        if "catch_up_s" in thresholds:
            lim = thresholds["catch_up_s"]
            judgments["catch_up_s"] = {
                "value": max_catch_up, "limit": lim,
                "ok": max_catch_up <= lim,
            }
        if "min_tx_per_s" in thresholds:
            lim = thresholds["min_tx_per_s"]
            judgments["min_tx_per_s"] = {
                "value": tx_rate, "limit": lim, "ok": tx_rate >= lim,
            }
        ok = all(j["ok"] for j in judgments.values()) and not stalled
        return {
            "p99_cross_peer_lag_blocks": p99_lag,
            "catch_up_s": catch_up,
            "sustained_tx_per_s": tx_rate,
            "stalled_nodes": stalled,
            "judgments": judgments,
            "pass": ok,
            "rounds": self.rounds,
        }

    # -- artifacts ---------------------------------------------------------

    def fetch_profiles(self, out_dir: str,
                       prefix: str = "netscope") -> dict[str, str]:
        """Pull each live node's profscope aggregate (``GET /profile``
        on its operations endpoint — the continuous sampler's collapsed
        stacks, span CPU attribution, lock contention and workpool
        rows as one speedscope document) and write it beside the other
        artifacts as ``<prefix>.profile.<node>.json``.  Nodes that are
        down, have no ops endpoint, or run with profiling disarmed
        (``otherData.armed`` false) are skipped — a disarmed doc has no
        samples to render.  Returns ``{node: path}`` for the HTML
        report's profile links."""
        os.makedirs(out_dir, exist_ok=True)
        paths: dict[str, str] = {}
        for node in sorted(self.targets):
            raw = self._get(node, "/profile")
            if raw is None or raw[0] != 200:
                continue
            try:
                doc = json.loads(raw[1])
            except ValueError:
                continue
            if not doc.get("otherData", {}).get("armed"):
                continue
            path = os.path.join(out_dir, f"{prefix}.profile.{node}.json")
            with open(path, "w", encoding="utf-8") as f:
                json.dump(doc, f, indent=1, sort_keys=True)
            paths[node] = path
        return paths

    def write_jsonl(self, path: str,
                    thresholds: dict | None = None) -> str:
        """The replayable time-series artifact: one JSON line per
        series ring / health timeline / event marker, a meta header and
        an SLO-rollup trailer.  Lines are emitted in sorted key order,
        so a deterministic scrape session serializes byte-identically."""
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with self._lock:
            series = {
                k: list(ring) for k, ring in self._series.items()
            }
            health = {
                n: list(ring) for n, ring in self._health.items()
            }
            events = sorted(
                self._events,
                key=lambda e: (e["t"], e["event"], e["node"]),
            )
            trace_counts = {
                n: len(q) for n, q in self._trace_events.items()
            }
        lines = [json.dumps({
            "kind": "netscope-meta",
            "nodes": sorted(self.targets),
            "interval_s": self.interval_s,
            "seed": self.seed,
            "window": self.window,
            "stall_window": self.stall_window,
            "rounds": self.rounds,
            "trace_events": {
                n: trace_counts[n] for n in sorted(trace_counts)
            },
        }, sort_keys=True)]
        for node, name, labels in sorted(series):
            lines.append(json.dumps({
                "kind": "series",
                "node": node,
                "name": name,
                "labels": dict(labels),
                "points": [[t, v] for t, v in
                           series[(node, name, labels)]],
            }, sort_keys=True))
        for node in sorted(health):
            lines.append(json.dumps({
                "kind": "health",
                "node": node,
                "points": [
                    [t, status, failed]
                    for t, status, failed in health[node]
                ],
            }, sort_keys=True))
        for ev in events:
            doc = {"kind": "event"}
            doc.update(ev)
            lines.append(json.dumps(doc, sort_keys=True))
        # stall episodes WITH their raw height evidence windows: the
        # artifact (shipped beside a failing chaos plan's repro JSON)
        # must let an operator replay the flag decision offline
        for episode in self.stall_episodes():
            doc = {"kind": "stall_episode"}
            doc.update(episode)
            lines.append(json.dumps(doc, sort_keys=True))
        slo = self.slo(thresholds)
        slo["kind"] = "slo"
        lines.append(json.dumps(slo, sort_keys=True))
        with open(path, "w", encoding="utf-8") as f:
            f.write("\n".join(lines) + "\n")
        return path

    def write_trace(self, path: str) -> str:
        """The incrementally-collected per-node trace events merged
        into one Chrome trace document (node name -> pid metadata),
        beside the jsonl artifact."""
        events: list[dict] = []
        with self._lock:
            per_node = {
                n: list(q) for n, q in self._trace_events.items()
            }
        for pid, node in enumerate(sorted(per_node), start=1):
            if not per_node[node]:
                continue
            events.append({
                "ph": "M", "name": "process_name", "pid": pid,
                "tid": 0, "args": {"name": node},
            })
            for ev in per_node[node]:
                ev = dict(ev)
                ev["pid"] = pid
                events.append(ev)
        doc = {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {"source": "fabric_tpu_torch.netscope"},
        }
        tracing.dump_doc(path, doc)
        return path

    # -- HTML report -------------------------------------------------------

    _SPARK_W, _SPARK_H = 260, 42

    def _sparkline(self, pts: list, t_lo: float, t_hi: float,
                   events: list[dict]) -> str:
        w, h = self._SPARK_W, self._SPARK_H
        span_t = max(t_hi - t_lo, 1e-9)
        xs = lambda t: 2 + (t - t_lo) / span_t * (w - 4)
        parts = [
            f'<svg width="{w}" height="{h}" viewBox="0 0 {w} {h}">'
        ]
        colors = {"kill": "#c0392b", "restart": "#2980b9",
                  "stall": "#e67e22", "stall_clear": "#27ae60",
                  "partition": "#8e44ad", "heal": "#16a085"}
        for ev in events:
            x = round(xs(ev["t"]), 1)
            c = colors.get(ev["event"], "#888")
            parts.append(
                f'<line x1="{x}" y1="0" x2="{x}" y2="{h}" '
                f'stroke="{c}" stroke-width="1" opacity="0.7">'
                f'<title>{_html.escape(ev["event"])} '
                f'{_html.escape(ev["node"])}</title></line>'
            )
        if pts:
            vs = [v for _, v in pts]
            lo, hi = min(vs), max(vs)
            span_v = max(hi - lo, 1e-9)
            ys = lambda v: (h - 4) - (v - lo) / span_v * (h - 8) + 2
            coords = " ".join(
                f"{xs(t):.1f},{ys(v):.1f}" for t, v in pts
            )
            parts.append(
                f'<polyline points="{coords}" fill="none" '
                f'stroke="#34495e" stroke-width="1.2"/>'
            )
        parts.append("</svg>")
        return "".join(parts)

    def _health_bar(self, pts: list, t_lo: float, t_hi: float) -> str:
        w, h = self._SPARK_W, 14
        span_t = max(t_hi - t_lo, 1e-9)
        xs = lambda t: 2 + (t - t_lo) / span_t * (w - 4)
        color = {"ok": "#27ae60", "unhealthy": "#e67e22",
                 "down": "#c0392b", "unknown": "#95a5a6"}
        parts = [
            f'<svg width="{w}" height="{h}" viewBox="0 0 {w} {h}">'
        ]
        for i, (t, status, failed) in enumerate(pts):
            x0 = xs(t)
            x1 = xs(pts[i + 1][0]) if i + 1 < len(pts) else w - 2
            title = status + (
                ": " + "; ".join(map(str, failed)) if failed else ""
            )
            parts.append(
                f'<rect x="{x0:.1f}" y="2" '
                f'width="{max(x1 - x0, 1.0):.1f}" height="{h - 4}" '
                f'fill="{color.get(status, "#888")}">'
                f'<title>{_html.escape(title)}</title></rect>'
            )
        parts.append("</svg>")
        return "".join(parts)

    def write_html(self, path: str,
                   thresholds: dict | None = None,
                   profiles: dict[str, str] | None = None) -> str:
        """Self-contained single-file report: per-series sparklines
        grouped by node, a per-node health timeline, and kill/restart/
        stall markers from the run — openable from the artifact
        directory with no server and no external assets.  ``profiles``
        (``{node: artifact path}`` from :meth:`fetch_profiles`) adds a
        per-node link to the speedscope CPU/lock profile document."""
        with self._lock:
            series = {
                k: list(ring) for k, ring in self._series.items()
            }
            health = {
                n: list(ring) for n, ring in self._health.items()
            }
            events = sorted(
                self._events,
                key=lambda e: (e["t"], e["event"], e["node"]),
            )
        slo = self.slo(thresholds)
        all_t = [t for pts in series.values() for t, _ in pts] + [
            t for pts in health.values() for t, *_ in pts
        ] + [e["t"] for e in events]
        t_lo, t_hi = (min(all_t), max(all_t)) if all_t else (0.0, 1.0)
        by_node: dict[str, list] = {}
        for node, name, labels in sorted(series):
            by_node.setdefault(node, []).append((name, labels))
        out = [
            "<!doctype html><html><head><meta charset='utf-8'>",
            "<title>netscope report</title><style>",
            "body{font:13px/1.4 system-ui,sans-serif;margin:18px;"
            "color:#2c3e50}",
            "table{border-collapse:collapse}",
            "td,th{padding:2px 10px;text-align:left;"
            "border-bottom:1px solid #eee}",
            "h2{margin:18px 0 6px}code{background:#f4f6f7;"
            "padding:1px 4px}",
            ".pass{color:#27ae60}.fail{color:#c0392b}",
            "</style></head><body>",
            "<h1>netscope report</h1>",
            f"<p>{len(self.targets)} nodes · {self.rounds} scrape "
            f"rounds · seed {self.seed} · interval "
            f"{self.interval_s}s · window {t_lo:.2f}–{t_hi:.2f}s</p>",
        ]
        verdict_cls = "pass" if slo["pass"] else "fail"
        out.append(
            f"<h2>SLO rollup: <span class='{verdict_cls}'>"
            f"{'PASS' if slo['pass'] else 'FAIL'}</span></h2><ul>"
        )
        out.append(
            f"<li>p99 cross-peer lag: "
            f"{slo['p99_cross_peer_lag_blocks']} blocks</li>"
            f"<li>sustained tx/s: {slo['sustained_tx_per_s']}</li>"
            f"<li>catch-up: {_html.escape(json.dumps(slo['catch_up_s']))}"
            f"</li><li>stalled nodes: "
            f"{_html.escape(', '.join(slo['stalled_nodes']) or 'none')}"
            "</li></ul>"
        )
        if events:
            out.append("<h2>Events</h2><table><tr><th>t (s)</th>"
                       "<th>event</th><th>node</th></tr>")
            for ev in events:
                out.append(
                    f"<tr><td>{ev['t']:.3f}</td>"
                    f"<td>{_html.escape(ev['event'])}</td>"
                    f"<td>{_html.escape(ev['node'])}</td></tr>"
                )
            out.append("</table>")
        for node in sorted(set(by_node) | set(health)):
            out.append(f"<h2>{_html.escape(node)}</h2>")
            prof_path = (profiles or {}).get(node)
            if prof_path:
                rel = os.path.basename(prof_path)
                out.append(
                    f"<p>profscope: <a href='{_html.escape(rel)}'>"
                    f"{_html.escape(rel)}</a> (speedscope CPU/lock "
                    "profile)</p>"
                )
            if node in health:
                out.append(
                    "<div>health "
                    + self._health_bar(health[node], t_lo, t_hi)
                    + "</div>"
                )
            rows = []
            node_events = [
                e for e in events
                if e["node"] == node or node == "_derived"
            ]
            for name, labels in by_node.get(node, []):
                pts = series[(node, name, labels)]
                label_txt = ",".join(f"{k}={v}" for k, v in labels)
                rows.append(
                    "<tr><td><code>"
                    + _html.escape(name)
                    + (f"{{{_html.escape(label_txt)}}}"
                       if label_txt else "")
                    + "</code></td><td>"
                    + self._sparkline(pts, t_lo, t_hi, node_events)
                    + f"</td><td>{pts[-1][1]:g}</td></tr>"
                )
            if rows:
                out.append(
                    "<table><tr><th>series</th><th>timeline</th>"
                    "<th>last</th></tr>" + "".join(rows) + "</table>"
                )
        out.append("</body></html>")
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w", encoding="utf-8") as f:
            f.write("".join(out))
        return path


def write_artifacts(scope: Netscope, out_dir: str,
                    thresholds: dict | None = None,
                    prefix: str = "netscope",
                    profiles: dict[str, str] | None = None,
                    fetch_profiles: bool = False) -> dict:
    """The standard artifact bundle beside a bench/chaos JSON line:
    ``<prefix>.jsonl`` + ``<prefix>.html`` (+ ``<prefix>.trace.json``
    when any trace events were collected, + per-node
    ``<prefix>.profile.<node>.json`` speedscope docs when profiling
    was armed).  ``fetch_profiles=True`` pulls the profiles live —
    only valid while the nodes are still up, so callers that write
    artifacts after network teardown must fetch inside their ``with
    Network`` block and pass the result as ``profiles`` instead."""
    os.makedirs(out_dir, exist_ok=True)
    if fetch_profiles:
        fetched = scope.fetch_profiles(out_dir, prefix)
        profiles = {**fetched, **(profiles or {})}
    paths = {
        "jsonl": scope.write_jsonl(
            os.path.join(out_dir, f"{prefix}.jsonl"), thresholds
        ),
        "html": scope.write_html(
            os.path.join(out_dir, f"{prefix}.html"), thresholds,
            profiles=profiles,
        ),
    }
    if scope.trace_event_count():
        paths["trace"] = scope.write_trace(
            os.path.join(out_dir, f"{prefix}.trace.json")
        )
    if profiles:
        paths["profiles"] = dict(profiles)
    return paths


__all__ = ["Netscope", "parse_prometheus", "write_artifacts"]
