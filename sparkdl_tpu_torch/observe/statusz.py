"""The live tier of gang observability: a driver-side HTTP status
server for a running gang.

Counterpart of ``sparkdl_tpu/observe/statusz.py``. It serves, over plain
HTTP on the driver, the telemetry that already arrives with every flush
and every beat:

``GET /metrics``
    The live gang-merged Prometheus text:
    :func:`~sparkdl_tpu_torch.observe.metrics.render_prometheus` over
    :meth:`GangTelemetry.live_labeled`, merged as the run dir's
    ``metrics.prom`` will be, with the driver's series and
    ``build_info``.
``GET /statusz``
    One JSON document (:meth:`StatuszServer.status_doc`, what
    :mod:`~sparkdl_tpu_torch.observe.top` renders): each rank's step,
    progress, last collective, card memory and beat age (the hang
    detector's live state), the supervisor's counters, a rolling
    attribution window per rank (median step time, component fractions,
    overlap efficiency, MFU), the alert engine's rules and firings, the
    perf forensics' captures, each registered fleet's replica table, and
    the elastic controller's current and available cards, pending plan
    and newest decisions (``elastic=``).
``GET /events``
    A server-sent-events tail of the merged live timeline: each journal
    event one ``data:`` line, its sequence the SSE ``id``.
``POST /capturez?rank=N``
    The manual perf-forensics trigger: the forensics manager sends
    PROFILE_REQ down rank N's control socket.

**Off by default.** The switch is the module setting :data:`PORT`, read
at call time (the JAX module's ``SPARKDL_TPU_STATUSZ_PORT``): None opens
no socket and starts no thread (:func:`maybe_start_statusz` returns
None); ``0`` binds an ephemeral port (the server's ``port``). The
handlers only read, except ``/capturez``.

Fleets register here weakly (:func:`register_fleet`, by
:meth:`~sparkdl_tpu_torch.models.fleet.FleetFrontend.start`), so any
status server of the process renders them and the alert engine's
``server_ttft`` and ``queue_depth_growth`` rules read them.
"""

import json
import threading
import time
import weakref

from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from sparkdl_tpu_torch.observe import alerts as alerts_mod
from sparkdl_tpu_torch.observe.alerts import RULES as ALERT_RULES

# the switch: the port the gang's status server binds (None: none; 0:
# an ephemeral one)
PORT = None

STATUSZ_SCHEMA = "sparkdl_tpu_torch.observe.statusz/1"

# -- fleet registration -------------------------------------------------------
#
# A FleetFrontend registers itself here when it starts (weakly: the
# status server never keeps a closed fleet alive), so any statusz server
# of the process renders its per-replica table.

_fleets = []
_fleets_lock = threading.Lock()


def register_fleet(frontend):
    """Called by :meth:`FleetFrontend.start`; idempotent (a restarted
    frontend never duplicates its row), and a dead ref is pruned on
    the next read."""
    with _fleets_lock:
        if not any(ref() is frontend for ref in _fleets):
            _fleets.append(weakref.ref(frontend))


def unregister_fleet(frontend):
    """Called by :meth:`FleetFrontend.close`: a CLOSED fleet must
    leave the table immediately — the weakref only dies when the
    object is collected, and callers routinely keep the variable
    around after close(), which would render a dead fleet's replica
    rows indistinguishable from a crashed live one."""
    with _fleets_lock:
        _fleets[:] = [ref for ref in _fleets
                      if ref() is not None and ref() is not frontend]


def fleet_status():
    """Per-replica state of every live registered fleet, or None when
    none registered (the /statusz key is absent rather than empty —
    gang-only runs have no fleet section at all)."""
    out = []
    # the rows are built outside the registry lock: replica_states()
    # and queue_depth() take each fleet's own locks
    for fleet in live_fleets():
        try:
            out.append({
                "address": list(fleet.address),
                "replicas": fleet.replica_states(),
                "restarts": fleet._restarts,
                "max_queue": fleet.max_queue,
                "queue_depth": fleet.queue_depth(),
            })
        except Exception:
            continue
    return out or None


def live_fleets():
    """The live registered :class:`FleetFrontend` OBJECTS (not status
    rows): what the ``server_ttft`` alert rule reads histograms from. Prunes dead
    refs like :func:`fleet_status`; returns a (possibly empty) list."""
    out = []
    with _fleets_lock:
        live = []
        for ref in _fleets:
            fleet = ref()
            if fleet is None:
                continue
            live.append(ref)
            out.append(fleet)
        _fleets[:] = live
    return out


def _reset_fleets_for_tests():
    with _fleets_lock:
        _fleets.clear()


# -- the server ---------------------------------------------------------------


def statusz_port():
    """:data:`PORT` as it stands (None: the server is off)."""
    return None if PORT is None else int(PORT)


def maybe_start_statusz(telemetry, detector=None, num_workers=None,
                        alerts=None, elastic=None, forensics=None):
    """A running :class:`StatuszServer` when :data:`PORT` is set and
    telemetry is live, None otherwise. A port already taken logs and
    returns None: the gang matters more than its page."""
    port = statusz_port()
    if port is None or telemetry is None:
        return None
    try:
        return StatuszServer(
            telemetry, detector=detector, num_workers=num_workers,
            alerts=alerts, elastic=elastic, forensics=forensics,
            port=port).start()
    except OSError as e:
        import logging

        logging.getLogger("HorovodRunner").warning(
            "statusz server failed to bind port %s: %s; continuing "
            "without the live page", port, e)
        return None


class StatuszServer:
    """The driver-side HTTP server. Construction binds the socket;
    :meth:`start` begins serving on a daemon thread; :meth:`close` is
    idempotent and joins the serve thread."""

    def __init__(self, telemetry, detector=None, num_workers=None,
                 alerts=None, elastic=None, forensics=None,
                 host="127.0.0.1", port=0):
        self._telemetry = telemetry
        self._elastic = elastic
        self._detector = detector
        self._alerts = alerts
        self._forensics = forensics
        self.num_workers = num_workers
        self._t0 = time.time()
        self._closed = threading.Event()
        # the alert engine's window: the two live views describe one
        self.window_s = float(alerts_mod.WINDOW_S)
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):    # scrapes stay out of stderr
                pass

            def do_GET(self):
                path = self.path.split("?", 1)[0]
                if path == "/metrics":
                    server._serve_metrics(self)
                elif path == "/statusz":
                    server._serve_statusz(self)
                elif path == "/events":
                    server._serve_events(self)
                elif path == "/healthz":
                    server._send(self, 200, b"ok\n", "text/plain")
                else:
                    self.send_error(404)

            def do_POST(self):
                path, _, query = self.path.partition("?")
                if path == "/capturez":
                    server._serve_capturez(self, query)
                else:
                    self.send_error(404)

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self.address = f"{host}:{self.port}"
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="sparkdl-torch-statusz", daemon=True)

    def start(self):
        self._thread.start()
        from sparkdl_tpu_torch import observe

        observe.instant("statusz.start", cat="statusz",
                        address=self.address)
        return self

    def close(self):
        if self._closed.is_set():
            return
        self._closed.set()
        try:
            self._httpd.shutdown()
            self._httpd.server_close()
        except OSError:
            pass
        self._thread.join(timeout=5.0)

    # -- handlers ------------------------------------------------------------

    @staticmethod
    def _send(handler, code, body, content_type):
        handler.send_response(code)
        handler.send_header("Content-Type", content_type)
        handler.send_header("Content-Length", str(len(body)))
        handler.end_headers()
        handler.wfile.write(body)

    def _serve_metrics(self, handler):
        from sparkdl_tpu_torch.observe.metrics import render_prometheus

        body = render_prometheus(self._telemetry.live_labeled()).encode()
        self._send(handler, 200, body,
                   "text/plain; version=0.0.4; charset=utf-8")

    def status_doc(self):
        """The /statusz JSON document (also what ``observe.top``
        renders). Pure reads — safe at any moment of the run."""
        doc = {
            "schema": STATUSZ_SCHEMA,
            "ts": time.time(),
            "uptime_s": round(time.time() - self._t0, 1),
            "gang": {"num_workers": self.num_workers},
            "ranks": {},
            "supervisor": self._supervisor_state(),
            "perf": self._perf_window(),
        }
        if self._detector is not None:
            doc["ranks"] = {
                str(r): info
                for r, info in self._detector.live_state().items()
            }
            doc["gang"]["stall_s"] = self._detector.stall_s
            doc["gang"]["hang_verdict"] = self._detector.hang_verdict
            # the beacon mem samples lifted into a table of their own
            memory = {}
            for r, info in doc["ranks"].items():
                mem = info.get("mem") or {}
                if mem:
                    memory[r] = {
                        "rss_bytes": mem.get("rss"),
                        "hbm_bytes": mem.get("hbm"),
                        "unattributed_bytes": mem.get("unattributed"),
                        "categories": mem.get("categories") or {},
                    }
            if memory:
                doc["memory"] = memory
        if self._alerts is not None:
            doc["alerts"] = {
                "enabled": True,
                "fired": self._alerts.records(),
                "rules": [r for r, _s, _m, _d in ALERT_RULES],
            }
        else:
            doc["alerts"] = {"enabled": False, "fired": []}
        if self._forensics is not None:
            try:
                doc["captures"] = self._forensics.captures_status()
            except Exception:
                pass
        fleet = fleet_status()
        if fleet is not None:
            doc["fleet"] = fleet
        if self._elastic is not None:
            try:
                doc["elastic"] = self._elastic.status()
            except Exception:
                pass
        return doc

    def _serve_statusz(self, handler):
        body = (json.dumps(self.status_doc(), indent=2, sort_keys=True)
                + "\n").encode()
        self._send(handler, 200, body, "application/json")

    def _supervisor_state(self):
        """Driver-side supervision counters as they stand: attempts,
        restarts, classified failures (the supervisor already counts
        them on the driver registry; reading a counter that was never
        written returns 0), and the world size of each attempt the
        launcher recorded."""
        from sparkdl_tpu_torch import observe
        from sparkdl_tpu_torch.horovod.supervisor import (
            attempt_chip_hours,
            attempt_world_sizes,
        )

        reg = observe.metrics()
        worlds = attempt_world_sizes()
        chip_hours = attempt_chip_hours()
        out = {
            "attempts_total": reg.counter("gang_attempts_total").value,
            "restarts_total": reg.counter("gang_restarts_total").value,
            "world_size": worlds[-1] if worlds else self.num_workers,
            "previous_world_size":
                worlds[-2] if len(worlds) > 1 else None,
            "world_sizes": worlds,
        }
        if chip_hours:
            out["chip_hours"] = chip_hours
            known = [e["chip_hours"] for e in chip_hours
                     if e.get("chip_hours") is not None]
            if known:
                out["chip_hours_total"] = round(sum(known), 6)
        return out

    def _perf_window(self):
        """Rolling attribution over the journal window, per rank:
        median step time, component fractions, overlap efficiency —
        plus the live MFU gauges from the merged snapshots."""
        from sparkdl_tpu_torch.observe.alerts import _median
        from sparkdl_tpu_torch.observe.perf import attribution_report

        events = self._telemetry.recent_events(self.window_s)
        per_rank = {}
        for rank, evs in sorted(events.items()):
            rep = attribution_report(evs)
            if not rep.get("steps"):
                continue
            median = _median(
                [r["dur_s"] for r in rep.get("per_step", ())])
            per_rank[str(rank)] = {
                "steps": rep["steps"],
                "median_step_s": round(median, 6),
                "fractions": rep.get("fractions"),
                "overlap_efficiency": rep.get("overlap_efficiency"),
            }
        # live MFU: newest mfu gauge per rank from the merged view
        try:
            for extra, snap in self._telemetry.live_labeled():
                rank = extra.get("rank")
                if rank in per_rank:
                    for g in snap.get("gauges", ()):
                        if g["name"] == "mfu":
                            per_rank[rank]["mfu"] = g["value"]
                            break
        except Exception:
            pass
        return {"window_s": self.window_s, "per_rank": per_rank}

    def _serve_capturez(self, handler, query):
        """``POST /capturez?rank=N`` — the one deliberate exception to
        the handlers-only-read rule: the manual perf-forensics trigger
        (``python -m sparkdl_tpu_torch.observe.capture URL`` posts
        here).
        The capture itself runs on the target worker; this only asks
        the forensics manager to send the PROFILE_REQ frame. Omitting
        ``rank`` targets rank 0."""
        from urllib.parse import parse_qs

        if self._forensics is None:
            self._send(handler, 503,
                       b'{"ok": false, "detail": '
                       b'"perf forensics unavailable"}\n',
                       "application/json")
            return
        rank = (parse_qs(query).get("rank") or ["0"])[0]
        ok, why = self._forensics.request_capture(rank, reason="manual")
        body = (json.dumps(
            {"ok": ok, "detail": why, "rank": rank},
            sort_keys=True) + "\n").encode()
        self._send(handler, 200 if ok else 409, body,
                   "application/json")

    def _serve_events(self, handler):
        """SSE tail of the live journal. Streams until the client
        disconnects or the server closes; polls the journal at the
        telemetry flush cadence (new events only arrive on flushes)."""
        handler.send_response(200)
        handler.send_header("Content-Type", "text/event-stream")
        handler.send_header("Cache-Control", "no-cache")
        handler.end_headers()
        seq = 0
        try:
            # Resume support: Last-Event-ID picks up where a dropped
            # client left off (the journal ring bounds how far back).
            last = handler.headers.get("Last-Event-ID")
            if last:
                seq = int(last)
        except (TypeError, ValueError):
            seq = 0
        try:
            while not self._closed.is_set():
                newest, batch = self._telemetry.events_since(
                    seq, limit=256)
                # advance past what was SENT, not past the journal's
                # newest — a limit-truncated batch must not skip the
                # remainder on the next poll
                seq = batch[-1][0] if batch else newest
                for ev_seq, rank, event in batch:
                    payload = json.dumps(
                        {"rank": rank, "event": event},
                        sort_keys=True)
                    handler.wfile.write(
                        f"id: {ev_seq}\ndata: {payload}\n\n".encode())
                if not batch:
                    # comment line = keepalive; also how a dead client
                    # is detected between event batches
                    handler.wfile.write(b": keepalive\n\n")
                handler.wfile.flush()
                self._closed.wait(0.5)
        except (BrokenPipeError, ConnectionResetError, OSError):
            return


__all__ = [
    "StatuszServer", "maybe_start_statusz", "statusz_port",
    "register_fleet", "unregister_fleet", "fleet_status", "live_fleets",
    "PORT", "STATUSZ_SCHEMA",
]
