"""Thin client for the serve daemon: `autocycler submit`.

Submits one isolate job over loopback HTTP (TCP or Unix socket), prints
the job record, and can wait for completion (``--wait``) or follow the
job's span stream live (``--follow`` — reuses the `autocycler watch`
renderer on the job's run directory, which the daemon creates shortly
after admission; the follower polls until it appears).

Endpoint resolution order: ``--server`` URL > ``--socket`` path >
``--dir`` (reads the daemon's ``serve.json`` discovery file) >
``AUTOCYCLER_SERVE`` env > ``http://127.0.0.1:8642``.
"""

from __future__ import annotations

import http.client
import json
import socket
import time
from pathlib import Path
from typing import Optional, Tuple
from urllib.parse import urlparse

from ..utils import AutocyclerError, log
from .protocol import (DEFAULT_PORT, SERVE_INFO_JSON, TRACE_HEADER, JobSpec,
                       mint_trace_id, sanitize_trace_id)


class _UnixHTTPConnection(http.client.HTTPConnection):
    def __init__(self, path: str, timeout: float = 10.0):
        super().__init__("localhost", timeout=timeout)
        self._unix_path = path

    def connect(self):
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        sock.settimeout(self.timeout)
        sock.connect(self._unix_path)
        self.sock = sock


def _read_serve_info(path) -> dict:
    """Never-raise ``serve.json`` reader, mirroring ``read_manifest``: a
    missing, torn (daemon mid-write or crashed), or non-object discovery
    file yields {} — the CALLER decides whether that's fatal, with one
    clear error at the decision point instead of a JSONDecodeError
    traceback from whichever byte the tear landed on."""
    try:
        data = json.loads(Path(path).read_text())
    except (OSError, ValueError):
        return {}
    return data if isinstance(data, dict) else {}


def resolve_endpoint(server: Optional[str] = None,
                     socket_path: Optional[str] = None,
                     serve_dir=None) -> str:
    """The daemon endpoint as ``http://host:port`` or ``unix:<path>``."""
    if server:
        return server
    if socket_path:
        return f"unix:{socket_path}"
    if serve_dir is not None:
        info_path = Path(serve_dir) / SERVE_INFO_JSON
        endpoint = _read_serve_info(info_path).get("endpoint")
        if isinstance(endpoint, str) and endpoint:
            return endpoint
        raise AutocyclerError(
            f"cannot resolve a daemon endpoint from {info_path} "
            f"(missing, unreadable, or torn discovery file) — is "
            f"`autocycler serve` running with that root?")
    from ..utils.env import env_str
    env = (env_str("AUTOCYCLER_SERVE") or "").strip()
    if env:
        return env
    return f"http://127.0.0.1:{DEFAULT_PORT}"


def _connect(endpoint: str, timeout: float = 10.0
             ) -> http.client.HTTPConnection:
    if endpoint.startswith("unix:"):
        return _UnixHTTPConnection(endpoint[len("unix:"):], timeout=timeout)
    parsed = urlparse(endpoint if "://" in endpoint
                      else f"http://{endpoint}")
    return http.client.HTTPConnection(parsed.hostname or "127.0.0.1",
                                      parsed.port or DEFAULT_PORT,
                                      timeout=timeout)


def request_json(endpoint: str, method: str, path: str,
                 body: Optional[dict] = None,
                 timeout: float = 10.0,
                 headers: Optional[dict] = None) -> Tuple[int, dict]:
    """One JSON request/response round trip; raises AutocyclerError when
    the daemon is unreachable. ``headers`` are extra request headers
    (e.g. the X-Autocycler-Trace correlation id)."""
    conn = _connect(endpoint, timeout=timeout)
    try:
        payload = json.dumps(body).encode() if body is not None else None
        extra = dict(headers or {})
        headers = {"Content-Type": "application/json"} if payload else {}
        headers.update(extra)
        # shared-secret auth rides automatically when the client's
        # environment carries the daemon's token knob; the value is sent
        # on the wire only, never logged
        from ..utils.env import env_str
        token = env_str("AUTOCYCLER_SERVE_TOKEN") or None
        if token:
            headers["Authorization"] = f"Bearer {token}"
        try:
            conn.request(method, path, body=payload, headers=headers)
            resp = conn.getresponse()
            raw = resp.read()
        except (OSError, http.client.HTTPException) as e:
            raise AutocyclerError(
                f"cannot reach autocycler serve at {endpoint} "
                f"({type(e).__name__}: {e}) — is the daemon running?")
        try:
            data = json.loads(raw.decode() or "{}")
        except (json.JSONDecodeError, UnicodeDecodeError):
            data = {"raw": raw.decode(errors="replace")}
        return resp.status, data
    finally:
        conn.close()


def wait_for_job(endpoint: str, job_id: str, poll_s: float = 0.5,
                 timeout: Optional[float] = None) -> dict:
    """Poll ``/jobs/<id>`` until the job reaches a terminal state."""
    t0 = time.monotonic()
    while True:
        status, record = request_json(endpoint, "GET", f"/jobs/{job_id}")
        if status != 200:
            raise AutocyclerError(
                f"job {job_id} lookup failed (HTTP {status}): "
                f"{record.get('error', record)}")
        if record.get("state") in ("done", "failed"):
            return record
        if timeout is not None and time.monotonic() - t0 > timeout:
            raise AutocyclerError(
                f"timed out after {timeout}s waiting for {job_id} "
                f"(last state: {record.get('state')})")
        time.sleep(poll_s)


def submit(assemblies_dir, server: Optional[str] = None,
           socket_path: Optional[str] = None, serve_dir=None,
           fleet_dir=None,
           command: str = "compress", out_dir=None, kmer: int = 51,
           max_contigs: int = 25, threads: int = 8,
           wait: bool = False, follow: bool = False,
           poll_s: float = 0.5, timeout: Optional[float] = None,
           trace_id: Optional[str] = None) -> int:
    """CLI entry for `autocycler submit`. Returns the exit code: 0 for an
    admitted (or, with --wait/--follow, completed) job, 1 for a failed one.

    With ``fleet_dir``, the endpoint comes from the client-side router
    (least-loaded healthy replica) instead of a single daemon's
    discovery file. Every submission mints (or sanitizes the caller's)
    correlation id and sends it as the X-Autocycler-Trace header; the
    daemon threads it into the job's trace/QC/ledger so
    `autocycler report --correlate <id>` can reassemble the whole story."""
    if fleet_dir is not None:
        from .router import pick_replica
        picked = pick_replica(fleet_dir=fleet_dir)
        endpoint = picked["endpoint"]
        log.message(
            f"routed to {picked['name']} ({endpoint}; "
            f"queue {picked['queue_depth']}, "
            f"busy {picked['busy_workers']}/{picked['workers']}, "
            f"{picked['candidates']} healthy)")
    else:
        endpoint = resolve_endpoint(server, socket_path, serve_dir)
    cid = sanitize_trace_id(trace_id) or mint_trace_id()
    spec = JobSpec(assemblies_dir=str(assemblies_dir), command=command,
                   out_dir=str(out_dir) if out_dir else None, kmer=kmer,
                   max_contigs=max_contigs, threads=threads)
    status, record = request_json(endpoint, "POST", "/jobs",
                                  body=spec.to_dict(),
                                  headers={TRACE_HEADER: cid})
    if status != 202:
        raise AutocyclerError(
            f"job submission rejected (HTTP {status}): "
            f"{record.get('error', record)}")
    job_id = record["id"]
    log.message(f"submitted {job_id} [{record['state']}] to {endpoint}")
    log.message(f"  trace id: {cid} "
                f"(autocycler report --correlate {cid})")
    log.message(f"  run dir: {record['run_dir']}")
    log.message(f"  outputs: {record['out_dir']}")
    if follow:
        # the daemon creates the run dir once the job starts; the follower
        # polls until trace.jsonl appears, then renders frames until the
        # job's run finishes
        from ..obs.watch import watch as watch_run
        watch_run(record["run_dir"], follow=True)
        record = wait_for_job(endpoint, job_id, poll_s=poll_s,
                              timeout=timeout)
    elif wait:
        record = wait_for_job(endpoint, job_id, poll_s=poll_s,
                              timeout=timeout)
    else:
        return 0
    state = record.get("state")
    wall = record.get("wall_s")
    log.message(f"{job_id} {state}"
                + (f" in {wall:.2f}s" if isinstance(wall, (int, float))
                   else ""))
    if state == "failed":
        log.message(f"  error: {record.get('error')}")
        return 1
    return 0
