"""In-process HTTP observability plane for a RaftNode (stdlib only).

The reference ships zero observability beyond logback debug lines
(SURVEY §5); this server exposes the TPU build's three surfaces over
plain HTTP so a node under test or in production can be inspected with
curl and scraped by Prometheus, with no new dependencies:

* ``GET /metrics``            — the whole Metrics registry in text
  exposition format 0.0.4 (``utils/metrics.render_prometheus``, guarded
  against non-finite values and validated by the strict parser in
  ``utils/metrics.validate_exposition``);
* ``GET /healthz``            — peer-health gate state as JSON: how many
  groups this node leads and how many of those pass the readiness gate
  (reference Leader.isReady, Leader.java:52-64), plus tick/uptime vitals;
* ``GET /timeline?group=N``   — the flight recorder's decoded per-group
  event timeline (``utils/tracelog.TraceLog``), the "which replica did
  what when" view; empty unless ``cfg.trace_depth > 0`` — plus the
  striped host tier's recent per-worker utilization intervals;
* ``GET /latency``            — the sampled commit-path latency plane
  (``utils/latency.py``): sampler state, SLO burn, per-phase and
  end-to-end percentile tables, recent sampled spans with per-phase
  breakdowns, and the WAL engines' per-stripe stage/fsync/pack stats —
  plus the cross-node hop decomposition (``hops`` subdocument);
* ``GET /heatmap?k=N``        — the per-group heat registry
  (``utils/heat.py``): top-K hot groups by decayed work score, the
  active-set size gauge, and the idleness-age distribution;
* ``GET /hops``               — the hop tracer alone: per-peer and
  aggregate segment summaries (leader_pack / wire / follower_fsync /
  ack_return / quorum_wait), bookkeeping counters, recent traces.

Malformed query parameters and unknown paths return typed 4xx JSON
documents (``{"error": <kind>, ...}``); handler bugs degrade to a typed
500 — never a traceback on the socket.

Handlers only READ tick-refreshed host mirrors (``h_role``/``h_ready``/
``metrics``/``tracelog``) — the same bounded one-tick staleness contract
as ``RaftNode.submit`` — so serving never blocks or mutates the tick
thread's state.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

from ..core.types import LEADER

PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


class ObservabilityServer:
    """Serve /metrics, /healthz and /timeline for one RaftNode.

    ``port=0`` binds an ephemeral port (read :attr:`port` after
    :meth:`start`).  The server runs daemon threads and is closed by
    :meth:`close` (RaftNode.close closes an attached server)."""

    def __init__(self, node, host: str = "127.0.0.1", port: int = 0):
        self.node = node
        self._t0 = time.monotonic()
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # quiet by default
                pass

            def _reply(self, code: int, body: bytes, ctype: str) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _json(self, code: int, doc: dict) -> None:
                self._reply(code, json.dumps(doc).encode(),
                            "application/json")

            def _bad(self, kind: str, detail: str) -> None:
                """Typed 4xx: machine-matchable ``error`` kind + a human
                detail line — malformed input is a client problem and
                must never surface as a 500/traceback."""
                self._json(400, {"error": kind, "detail": detail})

            def _int_param(self, q, name: str, default: int, lo: int,
                           hi: int):
                """Parse an integer query param with bounds.  Returns
                the value, or None AFTER replying 400 (typed) — callers
                just ``return`` on None."""
                raw = q.get(name, [None])[0]
                if raw is None:
                    return default
                try:
                    v = int(raw)
                except ValueError:
                    self._bad("bad_param",
                              f"{name}={raw!r} is not an integer")
                    return None
                if not lo <= v <= hi:
                    self._bad("param_out_of_range",
                              f"{name}={v} outside [{lo}, {hi}]")
                    return None
                return v

            def do_GET(self):
                try:
                    url = urlparse(self.path)
                    q = parse_qs(url.query)
                    if url.path == "/metrics":
                        body = outer.node.metrics.render_prometheus()
                        self._reply(200, body.encode(), PROM_CONTENT_TYPE)
                    elif url.path == "/healthz":
                        self._json(200, outer.healthz())
                    elif url.path == "/timeline":
                        g = self._int_param(
                            q, "group", 0, 0,
                            outer.node.cfg.n_groups - 1)
                        if g is None:
                            return
                        self._json(200, outer.timeline(g))
                    elif url.path == "/latency":
                        self._json(200, outer.node.latency_snapshot())
                    elif url.path == "/heatmap":
                        k = self._int_param(q, "k", 16, 1, 1024)
                        if k is None:
                            return
                        self._json(200, outer.node.heatmap_snapshot(k))
                    elif url.path == "/hops":
                        self._json(200, outer.node.hops_snapshot())
                    else:
                        self._json(404, {"error": "unknown_path",
                                         "paths": ["/metrics", "/healthz",
                                                   "/timeline?group=N",
                                                   "/latency",
                                                   "/heatmap?k=N",
                                                   "/hops"]})
                except BrokenPipeError:
                    pass
                except Exception as e:  # noqa: BLE001 — a handler bug
                    # must degrade to a typed 500 document, not a
                    # half-written traceback on the socket.
                    try:
                        self._json(500, {"error": "internal",
                                         "detail": f"{type(e).__name__}: "
                                                   f"{e}"})
                    except Exception:
                        pass

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name=f"raft-obsrv-{node.node_id}", daemon=True)

    # ------------------------------------------------------------- views --

    def healthz(self) -> dict:
        """Peer-health gate state: the vital signs a load balancer or
        operator needs before routing to this node."""
        n = self.node
        led = int((n.h_role == LEADER).sum())
        ready = int(np.asarray(n.h_ready).sum())
        # Storage vitals (the storage-fault nemesis surface): quarantined
        # WAL stripes, ENOSPC admission backpressure, and the slow-I/O
        # gray-failure watchdog.  ``ok`` stays a liveness bit — a node
        # with one poisoned stripe still serves its healthy groups.
        storage = {
            "poisoned_stripes": sorted(getattr(n, "_poisoned_stripes",
                                               ()) or ()),
            "backpressure": bool(getattr(n, "_io_backpressure", False)),
            "io_slow": bool(getattr(n, "_io_slow", False)),
        }
        # Latency vitals (the PR 13 latency plane): is the fleet meeting
        # its end-to-end SLO?  p999 + burn come from the same registry
        # gauges /metrics exports; sampling=0 means the plane is off.
        tr = getattr(n, "_lat", None)
        gauges = n.metrics._gauges
        latency = {
            "sampling_rate": tr.rate if tr is not None else 0,
            "slo_target_s": (tr.slo_s if tr is not None else 0.0),
            "e2e_p999_s": float(gauges.get("lat_e2e_p999_s", 0.0)),
            "slo_burn_ratio": float(gauges.get("lat_slo_burn_ratio", 0.0)),
            "io_slow": bool(getattr(n, "_io_slow", False)),
        }
        # Overload vitals (the admission-control plane, runtime/
        # admission.py): shedding is DEGRADED, not unhealthy — ``ok``
        # stays True while the controller keeps admitted-request latency
        # bounded by refusing the excess; a load balancer should weigh
        # this node down, not eject it.
        adm = getattr(n, "admission", None)
        overload = adm.snapshot() if adm is not None else {
            "enabled": False, "shedding": False}
        overload["degraded"] = bool(overload.get("shedding", False))
        # Gray-failure scorecards (utils/health.py): per-peer + self
        # decayed health, degraded flags, evacuation audit.  A degraded
        # self is DEGRADED, not unhealthy — the node is actively handing
        # leadership away; weigh it down, don't eject it.
        peers = n.health_snapshot()
        return {
            "ok": True,
            "node_id": int(n.node_id),
            "ticks": int(n.ticks),
            "groups_active": int(n.h_active.sum()),
            "groups_led": led,
            "groups_ready": ready,
            "storage": storage,
            "latency": latency,
            "overload": overload,
            "peers": peers,
            "trace_depth": int(n.cfg.trace_depth),
            "uptime_s": round(time.monotonic() - self._t0, 3),
        }

    def timeline(self, g: int) -> dict:
        n = self.node
        return {
            "group": g,
            "trace_depth": int(n.cfg.trace_depth),
            "events": n.tracelog.timeline(g),
            "dropped_total": int(n.tracelog.dropped_total),
            # Striped host tier: recent per-worker (stage, fsync, send,
            # apply) wall seconds per tick — empty in serial mode.
            "worker_util": list(getattr(n, "_worker_util", ())),
        }

    # --------------------------------------------------------- lifecycle --

    def start(self) -> "ObservabilityServer":
        self._thread.start()
        return self

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def close(self) -> None:
        # shutdown() blocks on an event only serve_forever() sets — never
        # call it unless start() actually ran the serve thread.
        if self._thread.is_alive():
            self._httpd.shutdown()
            self._thread.join(timeout=5)
        self._httpd.server_close()
