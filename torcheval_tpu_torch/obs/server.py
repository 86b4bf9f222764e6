# tev: scope=host — the health endpoint is a host-side daemon HTTP
# server by design: nothing in this module runs on the update path.
"""Live health endpoint: a pull-based scrape surface for serving-scale eval.

Counterpart of ``torcheval_tpu/obs/server.py``, the same endpoints and
``/healthz`` body. Everything else in ``obs/`` ends up in files or return
values; an online multi-tenant eval service is scraped, probed, and paged
— it needs the state served live. :class:`ObsServer` is a stdlib
``http.server`` running on a background daemon thread (no new
dependencies, one import), serving:

- ``GET /metrics`` — ``render_prometheus()`` text exposition (counters,
  the flight/watchdog/slo sources when armed, latency histograms) —
  point a Prometheus scraper at it;
- ``GET /healthz`` — JSON liveness summary with an HTTP status a load
  balancer understands: **200** healthy, **503** when the stall watchdog
  is tripped or any SLO alert is active (sync-degradation/quorum state
  is reported but does not fail the probe — a degraded quorum still
  serves); each probe also runs ``Monitor.check()`` so SLOs are
  evaluated at scrape cadence with no loop code;
- ``GET /flight`` — the collective flight rings as JSON (the hang
  forensics a ``kubectl exec curl`` can fetch from a wedged pod);
- ``GET /report`` — ``format_report()`` plain text for humans.

Lifecycle: :func:`start_server` binds (port 0 = ephemeral, the test
default), serves until :func:`stop_server` — or scope exit when started
via ``config.observability(serve=<port>)``, which is the recommended
form (the server never outlives the eval it reports on). Binding is on
the caller's thread so a bad port fails loudly at start, not inside the
daemon.

The admission section reads the live armed metric tables
(``table._admission.shedding_status``): a shedding intake reports status
``shedding`` and stays healthy (degradation by design). The federation,
sync plane and failover sections read the last-armed
``federation.Federation``, ``syncplane.SyncPlane`` and
``failover.FailureDomain`` (``stale-region``, ``stale-plane`` and the
non-failing ``degraded-world``), and ``{"armed": 0}`` while none is open.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional

__all__ = [
    "ObsServer",
    "current_server",
    "healthz_payload",
    "start_server",
    "stop_server",
]


def healthz_payload() -> Dict[str, Any]:
    """The ``/healthz`` body: watchdog + flight + quorum/sync +
    federation-staleness + sync-plane-staleness + admission-ladder +
    failover + alert status with an overall ``status`` of ``ok`` /
    ``stalled`` / ``stale-region`` / ``stale-plane`` / ``alerting`` /
    ``shedding`` / ``degraded-world`` / ``degraded`` (first match wins;
    ``shedding`` — an armed
    :class:`~torcheval_tpu_torch.table.AdmissionController` above the full
    rung — does NOT fail the probe: a shedding intake still serves
    reweighted numbers; ``degraded-world`` — a
    :class:`~torcheval_tpu_torch.failover.FailureDomain` recovery in flight or
    a world re-formed onto survivors — likewise stays 200: the
    survivors serve with the loss declared in provenance;
    ``stalled``, ``stale-region``, ``stale-plane`` and ``alerting`` fail
    the probe — a region staler than the federation's ``staleness_503``
    bound means the "global" numbers this process serves silently
    exclude that region, and an armed sync plane whose freshest merged
    snapshot has aged past its ``stale_after`` bound means every
    bounded-staleness read this process serves is older than the
    operator declared acceptable; a load balancer must see both).
    Usable without the server — tests and non-HTTP health integrations
    call it directly."""
    from torcheval_tpu_torch.obs import flight as _flight
    from torcheval_tpu_torch.obs import monitor as _monitor
    from torcheval_tpu_torch.obs import watchdog as _watchdog
    from torcheval_tpu_torch.resilience import default_sync_health

    wd = _watchdog.current_watchdog()
    mon = _monitor.current_monitor()
    fed = _current_federation()
    alerts = []
    if mon is not None:
        mon.check()
        alerts = mon.active_alerts()
    health = default_sync_health()
    with health._lock:
        sync = {
            "world_size": health.world_size,
            "participating_ranks": list(health.participating_ranks),
            "degraded_syncs": health.degraded_syncs,
            "full_syncs": health.full_syncs,
            "consecutive_missing": list(health.consecutive_missing),
            "reforms": health.reforms,
            "reformed_to": list(health.reformed_to),
        }
    federation: Dict[str, Any] = {"armed": 0}
    stale_region = False
    if fed is not None:
        stale_region = fed.stale_for_healthz()
        federation = {
            "armed": 1,
            "epoch": fed.epoch,
            "staleness_503": fed.staleness_503,
            "regions": [
                {
                    "name": s.name,
                    "epoch": s.epoch,
                    "staleness_epochs": s.staleness_epochs,
                    "age_seconds": (
                        -1.0
                        if s.age_seconds == float("inf")
                        else round(s.age_seconds, 3)
                    ),
                    "dark": s.dark,
                    "self": s.is_self,
                }
                for s in fed.region_statuses()
            ],
        }
    pln = _current_plane()
    plane: Dict[str, Any] = {"armed": 0}
    stale_plane = False
    if pln is not None:
        stale_plane = pln.stale_for_healthz()
        plane = {"armed": 1, **pln.staleness()}
    admission = _shedding_status()
    domain = _current_domain()
    failover: Dict[str, Any] = (
        domain.status() if domain is not None else {"armed": 0}
    )
    # a rank-loss recovery in flight (or a world serving on a reformed
    # survivor subgroup) is GRACEFUL like shedding: the survivors still
    # serve, with loss declared in provenance — the probe stays 200
    world_degraded = bool(sync["reformed_to"]) or (
        domain is not None and domain.state != "armed"
    )
    stalled = wd is not None and wd.tripped
    degraded = bool(sync["consecutive_missing"])
    if stalled:
        status = "stalled"
    elif stale_region:
        status = "stale-region"
    elif stale_plane:
        status = "stale-plane"
    elif alerts:
        status = "alerting"
    elif admission["shedding"]:
        # overload degradation is GRACEFUL by design: a shedding intake
        # still serves (Horvitz-Thompson reweighted) numbers, so the
        # probe stays 200 — but the rung is visible to dashboards and
        # the status string tells an operator why variance grew
        status = "shedding"
    elif world_degraded:
        status = "degraded-world"
    elif degraded:
        status = "degraded"
    else:
        status = "ok"
    return {
        "status": status,
        "healthy": status
        not in ("stalled", "stale-region", "stale-plane", "alerting"),
        "watchdog": wd.status() if wd is not None else {"armed": 0},
        "flight": _flight.FLIGHT.counters(),
        "sync": sync,
        "federation": federation,
        "syncplane": plane,
        "admission": admission,
        "failover": failover,
        "alerts": alerts,
    }


# The live subsystems /healthz reports on, read through their modules'
# last-armed handles (imported on call: those modules import obs).


def _current_federation():
    from torcheval_tpu_torch.federation import current_federation

    return current_federation()


def _current_plane():
    from torcheval_tpu_torch.syncplane import current_plane

    return current_plane()


def _shedding_status() -> Dict[str, Any]:
    # the admission ladder over the live armed metric tables
    from torcheval_tpu_torch.table._admission import shedding_status

    return shedding_status()


def _current_domain():
    from torcheval_tpu_torch.failover import current_domain

    return current_domain()


class _Handler(BaseHTTPRequestHandler):
    # quiet by default: per-request stderr lines do not belong in an
    # eval job's output (the server object keeps a request counter)
    def log_message(self, *args: Any) -> None:
        pass

    def _send(
        self, status: int, content_type: str, body: str
    ) -> None:
        payload = body.encode("utf-8")
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)

    def do_GET(self) -> None:  # noqa: N802 — BaseHTTPRequestHandler API
        from torcheval_tpu_torch.obs import flight as _flight
        from torcheval_tpu_torch.obs.export import format_report, render_prometheus

        server: "ObsServer" = self.server.obs_server  # type: ignore[attr-defined]
        server.requests += 1
        path = self.path.split("?", 1)[0].rstrip("/") or "/"
        try:
            if path == "/metrics":
                self._send(
                    200,
                    "text/plain; version=0.0.4; charset=utf-8",
                    render_prometheus(),
                )
            elif path == "/healthz" or path == "/":
                payload = healthz_payload()
                self._send(
                    200 if payload["healthy"] else 503,
                    "application/json",
                    json.dumps(payload),
                )
            elif path == "/flight":
                snapshot = _flight.FLIGHT.snapshot()
                self._send(
                    200,
                    "application/json",
                    json.dumps(
                        {str(tid): ring for tid, ring in snapshot.items()}
                    ),
                )
            elif path == "/report":
                self._send(200, "text/plain; charset=utf-8", format_report())
            else:
                self._send(
                    404,
                    "text/plain; charset=utf-8",
                    "not found; endpoints: /metrics /healthz /flight /report\n",
                )
        except BrokenPipeError:
            pass  # scraper went away mid-response
        except Exception as e:  # noqa: BLE001 — a scrape must not die silent
            try:
                self._send(
                    500, "text/plain; charset=utf-8",
                    f"{type(e).__name__}: {e}\n",
                )
            except Exception:  # noqa: BLE001 — connection already gone
                pass


class ObsServer:
    """The background health/metrics HTTP server (module docstring)."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1") -> None:
        self._httpd = ThreadingHTTPServer((host, int(port)), _Handler)
        self._httpd.daemon_threads = True
        self._httpd.obs_server = self  # type: ignore[attr-defined]
        self.host = host
        self.port = int(self._httpd.server_address[1])
        self.requests = 0
        self._thread: Optional[threading.Thread] = None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def start(self) -> "ObsServer":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._httpd.serve_forever,
                kwargs={"poll_interval": 0.05},
                daemon=True,
                name="torcheval-obs-http",
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        """Shut down cleanly: stop accepting, join the serve loop, close
        the socket (idempotent)."""
        thread, self._thread = self._thread, None
        if thread is not None:
            self._httpd.shutdown()
            thread.join(timeout=5.0)
        self._httpd.server_close()


_SERVER: Optional[ObsServer] = None  # tev: guarded-by=_SERVER_LOCK
_SERVER_LOCK = threading.Lock()


def current_server() -> Optional[ObsServer]:
    """The running process-global server, or ``None``."""
    srv = _SERVER  # tev: disable=guarded-field -- single-reference read, atomic under the GIL; a probe racing stop_server tolerates one stale answer
    return srv if srv is not None and srv.running else None


def start_server(port: int = 0, host: str = "127.0.0.1") -> ObsServer:
    """Start the process-global health server (replacing any running
    one). ``port=0`` binds an ephemeral port — read it off the returned
    server's ``.port``. Scoped use: ``config.observability(serve=<port>)``."""
    global _SERVER
    with _SERVER_LOCK:
        if _SERVER is not None:
            _SERVER.stop()  # tev: disable=blocking-under-lock -- bounded serve-loop join (5 s); the HTTP threads never take _SERVER_LOCK, so this is a bounded wait, not a deadlock edge
        _SERVER = ObsServer(port, host).start()
        return _SERVER


def stop_server() -> None:
    """Stop the process-global health server (no-op when none runs)."""
    global _SERVER
    with _SERVER_LOCK:
        if _SERVER is not None:
            _SERVER.stop()  # tev: disable=blocking-under-lock -- bounded serve-loop join (5 s); the HTTP threads never take _SERVER_LOCK, so this is a bounded wait, not a deadlock edge
            _SERVER = None
