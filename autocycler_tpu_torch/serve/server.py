"""The `autocycler serve` HTTP surface: a loopback daemon over the
scheduler, as the JAX package's serve/server.py has it (the same routes,
token auth and ``serve.json``).

Routes (all JSON unless noted):

- ``POST /jobs``            submit a job spec -> 202 job record
                            (400 invalid spec; 503 + ``Retry-After`` when
                            the queue is full or burn-rate admission
                            control is shedding)
- ``GET  /jobs``            every job record this daemon has seen
- ``GET  /jobs/<id>``       one job record (404 unknown)
- ``GET  /jobs/<id>/trace`` raw ``trace.jsonl`` bytes from ``?offset=N``
                            (``X-Autocycler-Trace-Offset`` header carries
                            the next offset) — the span stream a remote
                            follower polls; local followers can equally
                            run `autocycler watch <run_dir>` on the path
                            in the job record
- ``GET  /metrics``         live Prometheus text exposition of the
                            process-wide metrics registry
- ``GET  /healthz``         daemon liveness + queue/job counts + the
                            card's probe report
- ``POST /shutdown``        graceful stop (finish running jobs, exit)

``POST /jobs`` also accepts a batch body (``{"batch": [...]}``): the
daemon fans it into child jobs under one parent id and ``GET
/jobs/<parent>`` aggregates the children.

The daemon binds TCP loopback by default (``--host``/``--port``) or a Unix
domain socket (``--socket``), and writes ``serve.json`` into its root so
`autocycler submit --dir <root>` discovers the endpoint without flags.
Binding beyond loopback requires a shared secret
(``AUTOCYCLER_SERVE_TOKEN``); when a token is configured every request
must carry it (``Authorization: Bearer <token>`` or
``X-Autocycler-Token``) or it is refused with 401. The token value is
never logged and never written into ``serve.json``.

The daemon runs its jobs on CUDA unless the caller asks for the CPU (the
tests do): it resolves the device before it binds a socket, so with no
card `autocycler serve` exits 1 with ``Error: ...`` and admits nothing,
and it never serves on the CPU in place of the card. :func:`serve` also
builds and loads both kernel libraries before the first job, so no job
pays ``nvcc``, and points the warm-start cache at ``<root>/.cache``.
"""

from __future__ import annotations

import contextlib
import hmac
import json
import os
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Optional
from urllib.parse import parse_qs, urlparse

from .. import __version__
from .. import device as device_mod
from ..obs import metrics_registry
from ..obs.timeseries import TimeseriesSampler, timeseries_enabled
from ..utils import log
from ..utils.env import env_str
from ..utils.resilience import InputError
from .protocol import (DEFAULT_PORT, SERVE_INFO_JSON, TRACE_HEADER,
                       is_batch_spec, is_fleet_batch, parse_batch_spec,
                       parse_job_spec, sanitize_trace_id,
                       validate_fleet_batch)
from .scheduler import SHED_TOTAL, QueueFullError, Scheduler

# a sampler whose last tick is older than this many intervals is stale —
# wedged or dead, either way the continuous telemetry has stopped
SAMPLER_STALE_INTERVALS = 3.0

REQUESTS_TOTAL = "autocycler_serve_requests_total"

# Retry-After hint on 503 responses (shed or queue-full): long enough for
# a few window samples to age out, short enough to keep clients live
RETRY_AFTER_S = 15

TOKEN_ENV = "AUTOCYCLER_SERVE_TOKEN"

# hosts a daemon may bind WITHOUT a shared-secret token; anything else is
# reachable from off-box and refuses to start unauthenticated
_LOOPBACK_HOSTS = ("localhost", "::1")


def _is_loopback(host: Optional[str]) -> bool:
    if host is None:            # unix socket: filesystem permissions apply
        return True
    return host in _LOOPBACK_HOSTS or host.startswith("127.")


class _UnixHTTPServer(ThreadingHTTPServer):
    address_family = socket.AF_UNIX

    def server_bind(self):
        # a stale socket file from a dead daemon would fail the bind
        with contextlib.suppress(OSError):
            os.unlink(self.server_address)
        self.socket.bind(self.server_address)


class _Handler(BaseHTTPRequestHandler):
    server_version = f"autocycler-serve/{__version__}"

    # the ThreadingHTTPServer subclass carries the scheduler + daemon state
    @property
    def state(self) -> "ServeHandle":
        return self.server.serve_state  # type: ignore[attr-defined]

    def log_message(self, format, *args):  # noqa: A002 — stdlib signature
        pass                               # request logging goes via metrics

    def address_string(self) -> str:
        # AF_UNIX hands a str/bytes client_address; the default
        # implementation indexes it like a (host, port) tuple
        addr = self.client_address
        return addr[0] if isinstance(addr, tuple) and addr else "unix"

    # ---- plumbing ----

    def _send_json(self, code: int, payload: dict, route: str,
                   headers: Optional[dict] = None) -> None:
        body = (json.dumps(payload, indent=2, sort_keys=True) + "\n").encode()
        self._send_bytes(code, body, "application/json", route,
                         headers=headers)

    def _send_bytes(self, code: int, body: bytes, ctype: str, route: str,
                    headers: Optional[dict] = None) -> None:
        metrics_registry.counter_inc(
            REQUESTS_TOTAL, 1, help="serve HTTP requests",
            route=route, code=str(code))
        with contextlib.suppress(BrokenPipeError, ConnectionResetError,
                                 OSError):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for key, value in (headers or {}).items():
                self.send_header(key, str(value))
            self.end_headers()
            self.wfile.write(body)

    def _read_json(self):
        length = int(self.headers.get("Content-Length") or 0)
        raw = self.rfile.read(length) if length else b""
        try:
            return json.loads(raw.decode() or "null")
        except (json.JSONDecodeError, UnicodeDecodeError) as e:
            raise InputError(f"request body is not valid JSON: {e}")

    def _authorized(self) -> bool:
        """Shared-secret check. With no token configured every request
        passes (loopback-only daemons); with one configured EVERY request
        must present it. Comparison is constant-time and the token value
        never reaches a log line or an error body."""
        token = self.state.token
        if not token:
            return True
        supplied = self.headers.get("X-Autocycler-Token") or ""
        auth = self.headers.get("Authorization") or ""
        if not supplied and auth.startswith("Bearer "):
            supplied = auth[len("Bearer "):].strip()
        if hmac.compare_digest(supplied.encode(), token.encode()):
            return True
        self._send_json(
            401, {"error": "missing or invalid serve token"}, "unauthorized",
            headers={"WWW-Authenticate": "Bearer"})
        return False

    # ---- routes ----

    def do_GET(self):  # noqa: N802 — stdlib casing
        if not self._authorized():
            return
        parsed = urlparse(self.path)
        parts = [p for p in parsed.path.split("/") if p]
        if parsed.path == "/healthz":
            return self._send_json(200, self.state.health(), "/healthz")
        if parsed.path == "/metrics":
            # ?format=json serves the registry snapshot (full histogram
            # bucket state incl. min/max) — what the fleet federation
            # scraper merges; the default stays Prometheus text
            query = parse_qs(parsed.query)
            if query.get("format", [""])[0] == "json":
                return self._send_json(200, metrics_registry.snapshot(),
                                       "/metrics")
            body = metrics_registry.to_prometheus().encode()
            return self._send_bytes(200, body,
                                    "text/plain; version=0.0.4", "/metrics")
        if parts and parts[0] == "jobs":
            if len(parts) == 1:
                jobs = [j.to_dict() for j in self.state.scheduler.jobs()]
                return self._send_json(
                    200,
                    {"jobs": jobs, "batches": self.state.scheduler.batches()},
                    "/jobs")
            job = self.state.scheduler.job(parts[1])
            if job is None:
                # batch parents live beside jobs in the same id namespace
                batch = self.state.scheduler.batch_record(parts[1])
                if batch is not None and len(parts) == 2:
                    return self._send_json(200, batch, "/jobs/<id>")
                return self._send_json(
                    404, {"error": f"unknown job {parts[1]!r}"}, "/jobs/<id>")
            if len(parts) == 2:
                return self._send_json(200, job.to_dict(), "/jobs/<id>")
            if len(parts) == 3 and parts[2] == "trace":
                return self._send_trace(job, parsed)
        return self._send_json(404, {"error": f"no route {parsed.path!r}"},
                               "unknown")

    def _send_trace(self, job, parsed) -> None:
        """Raw trace.jsonl bytes from ?offset=N — enough for a remote
        TraceFollower; the next offset rides a response header so the
        client never re-reads."""
        query = parse_qs(parsed.query)
        try:
            offset = max(0, int(query.get("offset", ["0"])[0]))
        except ValueError:
            offset = 0
        path = Path(job.run_dir) / "trace.jsonl"
        chunk = b""
        with contextlib.suppress(OSError):
            with open(path, "rb") as f:
                f.seek(offset)
                chunk = f.read(1 << 20)
        self._send_bytes(
            200, chunk, "application/x-ndjson", "/jobs/<id>/trace",
        )

    def do_POST(self):  # noqa: N802
        if not self._authorized():
            return
        parsed = urlparse(self.path)
        if parsed.path == "/jobs":
            # correlation id: optional client-minted header, sanitized so a
            # hostile value can never become a label or path fragment; it
            # threads through the scheduler into trace/QC/ledger artifacts
            trace_id = sanitize_trace_id(self.headers.get(TRACE_HEADER))
            try:
                body = self._read_json()
                batch = is_batch_spec(body)
                fleet = is_fleet_batch(body)
                specs = parse_batch_spec(body) if batch \
                    else [parse_job_spec(body)]
                if fleet:
                    validate_fleet_batch(specs)
            except InputError as e:
                metrics_registry.counter_inc(
                    "autocycler_serve_rejected_total", 1,
                    help="jobs rejected at admission", reason="bad_request")
                return self._send_json(400, {"error": str(e)}, "/jobs")
            # burn-rate admission control: when the SLO window burns error
            # budget faster than AUTOCYCLER_SLO_SHED_BURN allows, shed the
            # submission before it costs a queue slot — the window drains
            # on its own, so Retry-After is an honest hint
            slo_report = self.state.scheduler.slo.report()
            if slo_report.get("shedding"):
                metrics_registry.counter_inc(
                    SHED_TOTAL, len(specs),
                    help="submissions shed by burn-rate admission control")
                metrics_registry.counter_inc(
                    "autocycler_serve_rejected_total", len(specs),
                    help="jobs rejected at admission", reason="shed")
                return self._send_json(
                    503,
                    {"error": "shedding load: latency burn rate "
                              f"{slo_report.get('burn_rate')} exceeds "
                              f"threshold {slo_report.get('shed_burn')}",
                     "burn_rate": slo_report.get("burn_rate"),
                     "shed_burn": slo_report.get("shed_burn"),
                     "retry_after_s": RETRY_AFTER_S},
                    "/jobs", headers={"Retry-After": RETRY_AFTER_S})
            try:
                if fleet:
                    # one admission, one queue slot: the worker fans the
                    # items over the device mesh via the fleet runner
                    record = self.state.scheduler.submit_fleet(
                        specs, trace_id=trace_id).to_dict()
                elif batch:
                    record = self.state.scheduler.submit_batch(
                        specs, trace_id=trace_id)
                else:
                    record = self.state.scheduler.submit(
                        specs[0], trace_id=trace_id).to_dict()
            except QueueFullError as e:
                return self._send_json(503, {"error": str(e)}, "/jobs",
                                       headers={"Retry-After": RETRY_AFTER_S})
            return self._send_json(202, record, "/jobs")
        if parsed.path == "/shutdown":
            self._send_json(200, {"status": "shutting down"}, "/shutdown")
            self.state.request_shutdown()
            return
        return self._send_json(404, {"error": f"no route {parsed.path!r}"},
                               "unknown")


class ServeHandle:
    """A running daemon: the HTTP server thread + scheduler, stoppable.

    `serve()` builds one and blocks on it; tests and ``chip_smoke.py``
    build one in-process and drive it over real loopback HTTP. ``device``
    None means CUDA (an error without a card, raised before any socket is
    bound); the tests pass ``"cpu"``."""

    def __init__(self, root, host: str = "127.0.0.1",
                 port: int = DEFAULT_PORT, socket_path=None,
                 queue_size: int = 16, workers: Optional[int] = None,
                 device=None):
        dev = device_mod.resolve_device(device)
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.t0 = time.time()
        # shared-secret auth: read once at startup so a daemon's policy is
        # stable for its lifetime. Held in memory only — never logged,
        # never echoed into serve.json or an error body.
        self.token = env_str(TOKEN_ENV) or None
        if not socket_path and not _is_loopback(host) and not self.token:
            raise InputError(
                f"refusing to bind {host!r} (reachable beyond loopback) "
                f"without {TOKEN_ENV} set — configure a shared-secret "
                "token or bind loopback")
        self.scheduler = Scheduler(self.root, capacity=queue_size,
                                   workers=workers, device=dev)
        # a device error in a job stops the daemon (scheduler docstring)
        self.scheduler.on_failure = self.request_shutdown
        self.socket_path = str(socket_path) if socket_path else None
        if self.socket_path:
            self.server = _UnixHTTPServer(self.socket_path, _Handler)
            self.endpoint = f"unix:{self.socket_path}"
            self.host, self.port = None, None
        else:
            self.server = ThreadingHTTPServer((host, port), _Handler)
            self.host, self.port = self.server.server_address[:2]
            self.endpoint = f"http://{self.host}:{self.port}"
        self.server.serve_state = self  # type: ignore[attr-defined]
        self.server.daemon_threads = True
        self._server_thread: Optional[threading.Thread] = None
        self._shutdown_requested = threading.Event()
        # continuous telemetry: one sampler per daemon, writing
        # timeseries.jsonl into the serve root. Its extra() hook reads the
        # SLO tracker and job-table lock only — never the run lock, so a
        # tick can never stall job execution.
        self.sampler: Optional[TimeseriesSampler] = None
        if timeseries_enabled():
            self.sampler = TimeseriesSampler(
                self.root, extra=self._sampler_extra)

    def _sampler_extra(self) -> dict:
        return {"serve": {"queue_depth": self.scheduler._queue.qsize(),
                          "jobs": self.scheduler.counts(),
                          "idle": self.scheduler.idle(),
                          "workers": self.scheduler.workers,
                          "busy_workers": self.scheduler.busy_count()},
                "slo": self.scheduler.slo.report()}

    # ---- lifecycle ----

    def start(self) -> "ServeHandle":
        """Start the scheduler worker and the HTTP accept loop (on a
        background thread) and write the discovery file."""
        # version info rides every /metrics export so a federated scrape
        # can flag replica version skew
        from ..obs.federate import record_build_info
        record_build_info()
        self.scheduler.start()
        if self.sampler is not None:
            self.sampler.start()
        self._server_thread = threading.Thread(
            target=self.server.serve_forever,
            name="autocycler-serve-http", daemon=True)
        self._server_thread.start()
        self._write_info()
        return self

    def request_shutdown(self) -> None:
        self._shutdown_requested.set()

    def wait(self, poll_s: float = 0.2) -> None:
        """Block until a shutdown is requested (POST /shutdown or signal)."""
        while not self._shutdown_requested.wait(poll_s):
            pass

    def stop(self) -> None:
        """Graceful stop: no new connections, finish the running job."""
        self.server.shutdown()
        self.server.server_close()
        self.scheduler.shutdown(wait=True)
        if self.sampler is not None:
            self.sampler.stop()   # takes the series' final tick
        if self.socket_path:
            with contextlib.suppress(OSError):
                os.unlink(self.socket_path)
        with contextlib.suppress(OSError):
            (self.root / SERVE_INFO_JSON).unlink()

    def _write_info(self) -> None:
        info = {"pid": os.getpid(), "endpoint": self.endpoint,
                "host": self.host, "port": self.port,
                "socket": self.socket_path,
                "started_epoch": round(self.t0, 3),
                "workers": self.scheduler.workers,
                "auth": "token" if self.token else "none",
                "version": __version__}
        path = self.root / SERVE_INFO_JSON
        tmp = path.with_suffix(".json.tmp")
        with contextlib.suppress(OSError):
            tmp.write_text(json.dumps(info, indent=2, sort_keys=True) + "\n")
            os.replace(tmp, path)

    # ---- health ----

    def health(self) -> dict:
        """Daemon health: liveness basics, queue state, the latency-SLO
        verdict and sampler liveness. ``status`` degrades (never errors —
        the daemon IS serving) when the rolling latency window violates a
        configured objective or the telemetry sampler has gone stale, and
        when a device error is stopping the daemon."""
        now = time.time()
        slo_report = self.scheduler.slo.report()
        busy = self.scheduler.busy_count()
        health = {
            "status": "ok",
            "version": __version__,
            "pid": os.getpid(),
            "uptime_s": round(now - self.t0, 3),
            "queue_capacity": self.scheduler.capacity,
            "queue_depth": self.scheduler._queue.qsize(),
            "jobs": self.scheduler.counts(),
            "idle": self.scheduler.idle(),
            "workers": self.scheduler.workers,
            "busy_workers": busy,
            "utilization": round(busy / self.scheduler.workers, 4),
            "last_job_finished_epoch": slo_report.get("last_finished_epoch"),
            "slo": slo_report,
        }
        sampler = {"enabled": self.sampler is not None}
        if self.sampler is not None:
            last = self.sampler.last_tick_epoch
            age = round(now - last, 3) if last is not None else None
            stale_after = self.sampler.interval * SAMPLER_STALE_INTERVALS
            sampler.update(
                running=self.sampler.running(),
                interval_s=self.sampler.interval,
                last_tick_epoch=round(last, 3) if last else None,
                tick_age_s=age,
                stale=(not self.sampler.running()
                       or (age is not None and age > stale_after)))
        health["sampler"] = sampler
        degraded = []
        if slo_report.get("violated"):
            degraded.append("slo")
        if slo_report.get("shedding"):
            degraded.append("shedding")
        if sampler.get("stale"):
            degraded.append("sampler")
        if self.scheduler.failure is not None:
            degraded.append("device")
        if degraded:
            health["status"] = "degraded"
            health["degraded"] = degraded
            health["burn_rate"] = slo_report.get("burn_rate")
        health["probe"] = device_mod.probe_report()
        return health


def warm_process(root, device=None):
    """What a daemon does once before its first job: resolve the device
    (an error without a card), point the warm-start cache at
    ``<root>/.cache`` unless ``AUTOCYCLER_CACHE_DIR`` names one, and on the
    card build and load both kernel libraries, so that no job pays
    ``nvcc``. A kernel that fails to build is an error, not a degrade.
    Returns the device."""
    t0 = time.perf_counter()
    dev = device_mod.resolve_device(device)
    from ..utils import cache as warm_cache
    if warm_cache.shared_cache_dir() is None:
        warm_cache.set_shared_cache_dir(Path(root) / ".cache")
    if dev.type == "cuda":
        from ..ops import _build, dotplot_grid, sortnet
        _build.build()
        sortnet._lib()
        dotplot_grid._lib()
        device_mod.note_attach_seconds(time.perf_counter() - t0)
    return dev


def serve(serve_dir, host: str = "127.0.0.1", port: int = DEFAULT_PORT,
          socket_path=None, queue_size: int = 16,
          workers: Optional[int] = None, device=None) -> int:
    """CLI entry for `autocycler serve`: warm the process once, then block
    serving jobs until SIGINT/SIGTERM or POST /shutdown. Raises
    :class:`AutocyclerError` (exit 1) without a card, and after a job's
    device error once the daemon has stopped."""
    root = Path(serve_dir)
    dev = warm_process(root, device)
    root.mkdir(parents=True, exist_ok=True)

    handle = ServeHandle(root, host=host, port=port,
                         socket_path=socket_path, queue_size=queue_size,
                         workers=workers, device=dev)
    handle.start()

    import signal

    def _on_signal(signum, frame):
        handle.request_shutdown()

    with contextlib.suppress(ValueError):  # not the main thread
        signal.signal(signal.SIGTERM, _on_signal)
        signal.signal(signal.SIGINT, _on_signal)

    log.section_header("autocycler serve")
    log.explanation("The daemon keeps the CUDA context, the loaded kernels, the "
                    "parse/repair caches and the worker pool warm across jobs, so "
                    "every request after the first skips the CLI's cold-start cost.")
    log.message(f"listening on {handle.endpoint}")
    log.message(f"serve root:   {root}")
    log.message(f"device:       {dev}")
    log.message(f"work queue:   {queue_size} job(s)")
    log.message(f"workers:      {handle.scheduler.workers} "
                f"(auth: {'token' if handle.token else 'none'})")
    if handle.sampler is not None:
        log.message(f"telemetry:    {handle.sampler.path} "
                    f"(every {handle.sampler.interval:g}s)")
    log.message(f"submit with:  autocycler submit -i <assemblies_dir> "
                f"--dir {root}")
    log.message()
    try:
        handle.wait()
    except KeyboardInterrupt:
        pass
    log.message("serve: shutting down (finishing running jobs)")
    handle.stop()
    if handle.scheduler.failure is not None:
        raise handle.scheduler.failure
    return 0
