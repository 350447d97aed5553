"""Fleet federation: one public scrape covering every loopback replica —
a copy of ``dllama_tpu/router/fleet.py``.

The pod's replicas serve rich ``/metrics`` / ``/debug/trace`` /
``/debug/events`` surfaces — on loopback ephemeral ports an external
scraper can never reach.  This module runs inside the router/pod
process (stdlib only, like the rest of ``router/``) and federates them:

* :meth:`FleetScraper.federated_json` / ``federated_prometheus`` —
  concurrently scrape every *registered* replica (ejected and retiring
  ones included: their process may still be alive and their last state
  is exactly what an incident review needs) and re-expose every family
  with a ``replica`` label.  The router's own families ride along under
  ``replica="router"`` so one scrape is the whole fleet.  A replica
  that fails its scrape is **marked, never dropped**:
  ``dllama_fleet_replica_up{replica=...} 0`` in the Prometheus text,
  ``"up": false`` (plus the last good snapshot flagged ``"stale":
  true``) in the JSON.
* :meth:`FleetScraper.fleet_trace` — stitch the per-replica span rings
  into ONE Perfetto timeline.  Each process exports its ring with a
  paired ``(perf_now, wall_now)`` clock sample (``obs/trace.py
  raw()``); the stitcher computes ``offset = wall_now − perf_now`` per
  process and shifts every span onto the shared wall-clock axis — a
  track (pid) per replica, the router's own spans on pid 1, and
  instant-event markers from each process's event journal (hand-offs,
  respawns, preemptions) laid over the spans.  ``?trace=<id>`` narrows
  to one request's fleet-wide story.
* :meth:`FleetScraper.fleet_events` — the per-process event journals,
  keyed by replica.

Scrapes fan out on a small thread pool with a short per-replica
timeout: the slowest replica bounds the scrape, a dead one costs one
timeout, and the public ``/metrics`` stays serveable throughout.
"""

from __future__ import annotations

import http.client
import json
import re
import threading
import time
from concurrent.futures import ThreadPoolExecutor

from ..obs import events as obs_events, metrics as obs_metrics, \
    trace as obs_trace
from ..obs.log import get_logger

_log = get_logger("router.fleet")

#: per-replica scrape deadline, seconds — a hung replica must not stall
#: the public scrape for upstream_timeout.
SCRAPE_TIMEOUT = 2.0

#: ``name{labels} value [timestamp]`` — one Prometheus 0.0.4 sample.
_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{.*\})?\s+(\S+)(\s+\S+)?$")

#: a pre-existing ``replica`` label inside a scraped sample (the
#: router's own fleet_* families carry one) — renamed to
#: ``exported_replica`` on federation, the Prometheus convention, so
#: the injected label is never duplicated.
_INNER_REPLICA_RE = re.compile(r'(?<![a-zA-Z0-9_])replica=')


def _label_value(raw: str) -> str:
    """Escape a replica address for use inside a label value."""
    return raw.replace("\\", r"\\").replace('"', r'\"')


def parse_prometheus(text: str) -> dict[str, dict]:
    """Parse exposition text into ``{family: {"help", "type",
    "samples": [(sample_name, labels_or_None, value_text)]}}``.

    Sample names may extend the family name (``_bucket``/``_sum``/
    ``_count``); a sample line with no preceding header becomes its own
    family (type ``untyped``) so nothing is silently lost."""
    families: dict[str, dict] = {}
    current = None

    def fam(name: str) -> dict:
        return families.setdefault(
            name, {"help": None, "type": None, "samples": []})

    for line in text.splitlines():
        if not line.strip():
            continue
        if line.startswith("# HELP "):
            parts = line.split(" ", 3)
            f = fam(parts[2])
            f["help"] = parts[3] if len(parts) > 3 else ""
            current = parts[2]
        elif line.startswith("# TYPE "):
            parts = line.split(" ", 3)
            f = fam(parts[2])
            f["type"] = parts[3].strip() if len(parts) > 3 else "untyped"
            current = parts[2]
        elif line.startswith("#"):
            continue
        else:
            m = _SAMPLE_RE.match(line)
            if not m:
                continue
            name, labels, value = m.group(1), m.group(2), m.group(3)
            owner = current if current and name.startswith(current) \
                else name
            fam(owner)["samples"].append((name, labels, value))
    return families


def merge_prometheus(per_replica: list[tuple[str, str]]) -> str:
    """Merge ``(replica_label, exposition_text)`` pairs into one text
    with ``replica=...`` injected as the first label of every sample;
    HELP/TYPE emitted once per family, all samples grouped under it."""
    merged: dict[str, dict] = {}
    order: list[str] = []
    for replica, text in per_replica:
        rl = f'replica="{_label_value(replica)}"'
        for name, f in parse_prometheus(text).items():
            m = merged.get(name)
            if m is None:
                m = merged[name] = {"help": f["help"], "type": f["type"],
                                    "samples": []}
                order.append(name)
            else:
                m["help"] = m["help"] or f["help"]
                m["type"] = m["type"] or f["type"]
            for sname, labels, value in f["samples"]:
                inner = labels[1:-1] if labels else ""
                inner = _INNER_REPLICA_RE.sub("exported_replica=", inner)
                lab = "{" + rl + ("," + inner if inner else "") + "}"
                m["samples"].append(f"{sname}{lab} {value}")
    out: list[str] = []
    for name in order:
        f = merged[name]
        if f["help"] is not None:
            out.append(f"# HELP {name} {f['help']}")
        out.append(f"# TYPE {name} {f['type'] or 'untyped'}")
        out.extend(f["samples"])
    return "\n".join(out) + "\n"


def fleet_perf(replicas: dict) -> dict:
    """Fleet performance-economics rollup for the federated JSON: mean
    MFU/MBU across replicas that reported one, and class chip-time
    summed fleet-wide with per-class shares — the block a fleet dashboard's
    footer renders, computed once here instead of in every dashboard."""
    mfus: list[float] = []
    mbus: list[float] = []
    by_class: dict[str, float] = {}
    for entry in (replicas or {}).values():
        snap = entry.get("metrics") or {}
        for key, acc in (("mfu", mfus), ("mbu", mbus)):
            v = snap.get(key)
            if isinstance(v, (int, float)) and v > 0:
                acc.append(float(v))
        cc = snap.get("class_chip_ms")
        if isinstance(cc, dict):
            for k, v in cc.items():
                if isinstance(v, (int, float)):
                    by_class[k] = by_class.get(k, 0.0) + float(v)
    total = sum(by_class.values())
    return {
        "mfu_mean": round(sum(mfus) / len(mfus), 6) if mfus else None,
        "mbu_mean": round(sum(mbus) / len(mbus), 6) if mbus else None,
        "class_chip_ms": {k: round(v, 3)
                          for k, v in sorted(by_class.items())},
        "class_chip_share": {k: round(v / total, 4)
                             for k, v in sorted(by_class.items())}
        if total else {},
    }


class FleetScraper:
    """Concurrent scraper over the registry's full backend list."""

    def __init__(self, registry, *, timeout: float = SCRAPE_TIMEOUT):
        self.registry = registry
        self.timeout = float(timeout)
        self._lock = threading.Lock()
        # addr → last successful JSON metrics snapshot (ts, dict), kept
        # so a momentarily-unreachable replica is served stale-marked
        # instead of vanishing from the JSON federation
        self._last_good: dict[str, tuple[float, dict]] = {}

    # -- plumbing --------------------------------------------------------

    def _get(self, b, path: str, headers: dict | None = None):
        """(status, body_bytes) or None on any transport failure."""
        try:
            conn = http.client.HTTPConnection(b.host, b.port,
                                              timeout=self.timeout)
            try:
                conn.request("GET", path, headers=headers or {})
                resp = conn.getresponse()
                return resp.status, resp.read()
            finally:
                conn.close()
        except (OSError, http.client.HTTPException):
            return None

    def _fan_out(self, fn) -> list[tuple[object, object]]:
        """Run ``fn(backend)`` for every registered backend (ejected and
        retiring included) concurrently; returns ``[(backend, result)]``
        in registry order."""
        backends = list(self.registry.backends)
        if not backends:
            return []
        with ThreadPoolExecutor(
                max_workers=min(8, len(backends)),
                thread_name_prefix="fleet-scrape") as pool:
            results = list(pool.map(fn, backends))
        return list(zip(backends, results))

    def _mark(self, b, ok: bool) -> None:
        obs_metrics.FLEET_REPLICA_UP.set(b.addr, 1.0 if ok else 0.0)
        if not ok:
            obs_metrics.FLEET_SCRAPE_ERRORS.inc(b.addr)

    # -- metrics federation ----------------------------------------------

    def federated_json(self, router_metrics: dict | None = None) -> dict:
        """Fleet-scope JSON: the router's own registry plus every
        replica's, keyed by address, failures stale-marked."""
        t0 = time.perf_counter()

        def one(b):
            got = self._get(b, "/metrics")
            if got is None or got[0] != 200:
                return None
            try:
                return json.loads(got[1])
            except ValueError:
                return None

        replicas: dict[str, dict] = {}
        for b, snap in self._fan_out(one):
            ok = snap is not None
            self._mark(b, ok)
            entry = {"up": ok, "ejected": bool(b.ejected),
                     "retiring": bool(getattr(b, "retiring", False))}
            if ok:
                entry["metrics"] = snap
                with self._lock:
                    self._last_good[b.addr] = (time.time(), snap)
            else:
                with self._lock:
                    last = self._last_good.get(b.addr)
                if last is not None:
                    entry["stale"] = True
                    entry["stale_age_s"] = round(time.time() - last[0], 3)
                    entry["metrics"] = last[1]
            replicas[b.addr] = entry
        obs_metrics.FLEET_SCRAPE_SECONDS.observe(time.perf_counter() - t0)
        return {"scope": "fleet",
                "router": router_metrics or obs_metrics.snapshot_json(),
                "replicas": replicas,
                "perf": fleet_perf(replicas)}

    def federated_prometheus(self) -> str:
        """Fleet-scope Prometheus text: every sample — the router's own
        included — carries a ``replica`` label; a failed scrape shows up
        as ``dllama_fleet_replica_up{replica=...} 0`` (bumped *before*
        the router's own exposition is rendered, so the mark is in this
        very scrape, not the next one)."""
        t0 = time.perf_counter()

        def one(b):
            got = self._get(b, "/metrics?format=prometheus",
                            headers={"Accept": "text/plain"})
            if got is None or got[0] != 200:
                return None
            try:
                return got[1].decode("utf-8", "replace")
            except Exception:  # noqa: BLE001
                return None

        texts: list[tuple[str, str]] = []
        for b, text in self._fan_out(one):
            self._mark(b, text is not None)
            if text is not None:
                texts.append((b.addr, text))
        obs_metrics.FLEET_SCRAPE_SECONDS.observe(time.perf_counter() - t0)
        # the router's own registry renders AFTER the marks so
        # fleet_replica_up/scrape_errors reflect this fan-out
        texts.insert(0, ("router", obs_metrics.render_prometheus()))
        return merge_prometheus(texts)

    # -- event journals --------------------------------------------------

    def fleet_events(self, since: int | None = None) -> dict:
        """The router's journal plus every replica's, keyed by address.
        ``since`` applies to the *router* journal only — per-replica
        cursors live with the poller (each entry carries its own
        ``next_seq``)."""

        def one(b):
            got = self._get(b, "/debug/events")
            if got is None or got[0] != 200:
                return None
            try:
                return json.loads(got[1])
            except ValueError:
                return None

        replicas = {}
        for b, snap in self._fan_out(one):
            replicas[b.addr] = snap if snap is not None else {"up": False}
        return {"scope": "fleet",
                "router": obs_events.snapshot(since),
                "replicas": replicas}

    # -- cross-replica trace stitching -----------------------------------

    def fleet_trace(self, trace: str | None = None) -> dict:
        """One Perfetto timeline from every process's span ring.

        Each source exports ``raw()`` — spans in perf_counter seconds
        plus a ``(perf_now, wall_now)`` sample taken at export; the
        per-source offset shifts spans onto the shared wall-clock axis.
        The router is pid 1, each replica its own pid (named track);
        event-journal entries become instant-event markers on their
        process's track.  ``trace`` filters spans to one trace id
        (journal markers without a trace field — respawns, scale — are
        kept: they are the fleet context the filter exists to show)."""

        def one(b):
            spans = self._get(b, "/debug/trace?since=0")
            events = self._get(b, "/debug/events")

            def decode(got):
                if got is None or got[0] != 200:
                    return None
                try:
                    return json.loads(got[1])
                except ValueError:
                    return None
            return decode(spans), decode(events)

        sources: list[tuple[str, dict | None, dict | None]] = [
            ("router", obs_trace.TRACER.raw(), obs_events.snapshot())]
        scraped = self._fan_out(one)
        for b, (spans, events) in scraped:
            self._mark(b, spans is not None)
            sources.append((b.addr, spans, events))

        out: list[dict] = []
        fleet_meta: dict[str, dict] = {}
        for pid, (name, dump, journal) in enumerate(sources, start=1):
            fleet_meta[name] = {"up": dump is not None,
                                "spans": len((dump or {}).get("spans", ()))}
            out.append({"name": "process_name", "ph": "M", "pid": pid,
                        "args": {"name": name if name == "router"
                                 else f"replica {name}"}})
            if dump is None:
                continue
            offset = dump.get("wall_now", 0.0) - dump.get("perf_now", 0.0)
            tids: dict = {}
            for s in dump.get("spans", ()):
                if trace and s.get("trace") != trace:
                    continue
                raw_tid = s.get("tid", 0)
                if raw_tid not in tids:
                    tids[raw_tid] = len(tids) + 1
                    out.append({"name": "thread_name", "ph": "M",
                                "pid": pid, "tid": tids[raw_tid],
                                "args": {"name": f"{s.get('thread', '?')} "
                                                 f"({raw_tid})"}})
                args = dict(s.get("args") or {})
                if s.get("rid"):
                    args["request_id"] = s["rid"]
                if s.get("trace"):
                    args["trace_id"] = s["trace"]
                out.append({"name": s["name"], "cat": "dllama", "ph": "X",
                            "ts": round((s["ts"] + offset) * 1e6, 3),
                            "dur": round(s["dur"] * 1e6, 3),
                            "pid": pid, "tid": tids[raw_tid],
                            "args": args})
            for ev in (journal or {}).get("events", ()):
                ev_trace = ev.get("trace")
                if trace and ev_trace and ev_trace != trace:
                    continue
                args = {k: v for k, v in ev.items()
                        if k not in ("ts", "kind")}
                out.append({"name": f"event:{ev['kind']}", "cat": "fleet",
                            "ph": "i", "s": "p", "pid": pid, "tid": 0,
                            "ts": round(ev["ts"] * 1e6, 3), "args": args})
        return {"traceEvents": out, "displayTimeUnit": "ms",
                "fleet": fleet_meta}
