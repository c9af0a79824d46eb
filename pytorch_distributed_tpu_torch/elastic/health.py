"""Agent health-check server: the launcher's monitoring hook (torch
``distributed/launcher/api.py`` starts a health-check server next to the
agent; the interface lives in ``elastic/agent/server/
health_check_server.py``). Port of
``pytorch_distributed_tpu/elastic/health.py``.

External orchestrators (k8s liveness probes, cluster tooling) poll this endpoint to distinguish "agent alive and supervising"
from "agent wedged": the agent bumps a heartbeat every monitor tick, and
``GET /health`` returns 200 while the heartbeat is fresh, 503 once it
goes stale — so a hung agent flips unhealthy without any cooperation
from the hung code path. Implementation is a stdlib ``http.server`` on a
daemon thread: the health plane must never take down the data plane.
"""

from __future__ import annotations

import http.server
import json
import threading
import time
from typing import Callable, Optional

__all__ = ["HealthCheckServer"]


class HealthCheckServer:
    """Tiny HTTP liveness endpoint for an elastic agent.

    Args:
      status_fn: callable returning a JSON-able dict merged into the
        response body (agent state, restart count, ...).
      port: TCP port; 0 picks a free one (read it back via ``.port``).
      host: bind address — default ``0.0.0.0`` because the stated
        consumers (k8s liveness probes, off-node pollers) connect to the
        node/pod IP, not the agent's loopback; pass ``127.0.0.1`` to
        keep it local.
      stale_after: seconds without a ``heartbeat()`` before /health
        reports 503 (default 10 — generous vs the agent's 0.1 s monitor
        interval, tight vs any orchestrator probe period).
    """

    def __init__(
        self,
        status_fn: Optional[Callable[[], dict]] = None,
        *,
        port: int = 0,
        host: str = "0.0.0.0",
        stale_after: float = 10.0,
    ):
        self._status_fn = status_fn or (lambda: {})
        self._requested_port = port
        self._host = host
        self.stale_after = float(stale_after)
        self._beat = time.monotonic()
        self._started_at = time.time()
        self._phase: Optional[str] = None
        self._httpd: Optional[http.server.ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    # -- agent side --------------------------------------------------------
    def heartbeat(self) -> None:
        """Call from the supervision loop; freshness IS the health."""
        self._beat = time.monotonic()

    def blocking_phase(self, name: str):
        """Context manager marking an EXPECTED-blocking period
        (rendezvous wait for replacement nodes, exit barrier): the agent
        cannot heartbeat from inside the blocking call, but killing it
        there would turn every slow rendezvous into a restart loop — so
        /health stays 200 for the phase's duration and reports the
        phase name."""
        outer = self

        class _Phase:
            def __enter__(self):
                outer._phase = name
                outer.heartbeat()

            def __exit__(self, *exc):
                outer._phase = None
                outer.heartbeat()

        return _Phase()

    @property
    def port(self) -> int:
        if self._httpd is None:
            raise RuntimeError("health server not started")
        return self._httpd.server_address[1]

    def start(self) -> "HealthCheckServer":
        outer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (stdlib API)
                if self.path not in ("/health", "/healthz", "/"):
                    self.send_error(404)
                    return
                age = time.monotonic() - outer._beat
                phase = outer._phase
                healthy = age <= outer.stale_after or phase is not None
                try:
                    extra = outer._status_fn()
                except Exception as e:  # status must not break liveness
                    extra = {"status_error": repr(e)}
                body = json.dumps({
                    "healthy": healthy,
                    "heartbeat_age_s": round(age, 3),
                    "blocking_phase": phase,
                    "uptime_s": round(time.time() - outer._started_at, 1),
                    **extra,
                }).encode()
                self.send_response(200 if healthy else 503)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # keep agent logs clean
                pass

        self._httpd = http.server.ThreadingHTTPServer(
            (self._host, self._requested_port), Handler
        )
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="agent-health",
            daemon=True,
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
