"""The port's serve daemon on the CPU against the JAX package's: both
packages' ``ServeHandle`` in this process on ``port=0`` (the port's with
``device="cpu"``), the same specs submitted to each over loopback HTTP.
Job outputs compare byte for byte (compress, pipeline, batch and fleet
bodies, at one and two workers); job records, parent records and
``serve_manifest.json`` compare apart from times, ids and paths; each
package replays the other's manifest; rejections, token auth, the device
token, the cluster memo under two threads and the device-error shutdown
are checked on the port alone. Every wait has its own timeout and every
daemon stops in a ``finally``."""

import contextlib
import inspect
import json
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from synthetic import make_assemblies, make_isolate_dirs

pytestmark = pytest.mark.serve

JOB_TIMEOUT_S = 120.0
TINY = dict(n_assemblies=3, chromosome_len=160, plasmid_len=70)
# the record keys that carry times, ids or paths
VOLATILE = {"id", "run_dir", "out_dir", "submitted_epoch", "started_epoch",
            "finished_epoch", "wall_s", "queue_wait_s", "parent",
            "agg_queue_wait_s", "children"}


def _pkg(name: str):
    """The serve modules of one package: ``jax`` or ``port``."""
    if name == "jax":
        from autocycler_tpu.serve import client, protocol, scheduler, server
    else:
        from autocycler_tpu_torch.serve import (client, protocol, scheduler,
                                                server)
    return {"client": client, "protocol": protocol, "scheduler": scheduler,
            "server": server}


@contextlib.contextmanager
def daemon(name: str, root: Path, **kwargs):
    """A running daemon of package ``name`` on an ephemeral loopback port;
    the port's runs on the CPU. Stopped on the way out, whatever happened."""
    server = _pkg(name)["server"]
    if name == "port":
        kwargs.setdefault("device", "cpu")
    handle = server.ServeHandle(root, port=0, **kwargs).start()
    try:
        yield handle
    finally:
        handle.stop()


def request(name: str, handle, method: str, path: str, body=None,
            headers=None):
    return _pkg(name)["client"].request_json(handle.endpoint, method, path,
                                             body=body, headers=headers)


def wait_job(name: str, handle, job_id: str) -> dict:
    return _pkg(name)["client"].wait_for_job(handle.endpoint, job_id,
                                             poll_s=0.05,
                                             timeout=JOB_TIMEOUT_S)


def raw_request(endpoint: str, method: str, path: str, body=None,
                headers=None):
    """One request with its status, headers and raw body (the client's
    request_json hides the headers, and attaches the token itself)."""
    import http.client
    from urllib.parse import urlparse

    u = urlparse(endpoint)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=30)
    try:
        payload = json.dumps(body).encode() if body is not None else None
        conn.request(method, path, body=payload, headers=dict(headers or {}))
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def _wait_until(predicate, timeout: float = 30.0, interval: float = 0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(interval)
    return False


def out_files(out: Path) -> dict:
    """{relative path: bytes} under an out dir; the warm-start cache and the
    stream's spill dir left out."""
    return {str(p.relative_to(out)): p.read_bytes()
            for p in sorted(out.rglob("*"))
            if p.is_file() and not {".cache", ".stream"} &
            set(p.relative_to(out).parts)}


def stable(record: dict) -> dict:
    """A job or parent record without its times, ids and paths."""
    out = {k: v for k, v in record.items() if k not in VOLATILE}
    if isinstance(out.get("spec"), dict):
        out["spec"] = {k: v for k, v in out["spec"].items()
                       if k not in ("assemblies_dir", "out_dir")}
    if "children" in record:
        out["children"] = [stable(c) for c in record["children"]]
    return out


def stable_manifest(root: Path) -> dict:
    """``serve_manifest.json``'s items in submission order, without times,
    ids and paths."""
    items = json.loads((root / "serve_manifest.json").read_text())["items"]
    out = []
    for name in sorted(items):
        entry = dict(items[name])
        for key in ("submitted_epoch", "out_dir", "parent", "children",
                    "error"):
            entry.pop(key, None)
        if isinstance(entry.get("spec"), dict):
            entry["spec"] = {k: v for k, v in entry["spec"].items()
                             if k not in ("assemblies_dir", "out_dir")}
        if isinstance(entry.get("fleet_specs"), list):
            entry["fleet_specs"] = [
                {k: v for k, v in s.items()
                 if k not in ("assemblies_dir", "out_dir")}
                for s in entry["fleet_specs"]]
        entry["stages"] = sorted(entry.get("stages") or {})
        out.append((name.split("-")[0], entry))
    return out


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    base = tmp_path_factory.mktemp("serve_inputs")
    asm = make_assemblies(base / "one", n_assemblies=3, chromosome_len=3000,
                          plasmid_len=600, seed=5)
    isolates = make_isolate_dirs(base / "isolates", 3, seed0=40, **TINY)
    corrupt = base / "corrupt"
    corrupt.mkdir()
    (corrupt / "assembly_1.fasta").write_text(">broken_record\n")
    return {"asm": asm, "isolates": isolates, "corrupt": corrupt}


def _run_jobs(name: str, root: Path, bodies, workers: int):
    """Submit ``bodies`` (in order, all at once) to a fresh daemon of
    package ``name``; returns the finished records (a batch body's: its
    parent record) and the manifest."""
    records = []
    with daemon(name, root, workers=workers) as h:
        admitted = []
        for body in bodies:
            status, rec = request(name, h, "POST", "/jobs", body=body)
            assert status == 202, rec
            admitted.append(rec)
        for rec in admitted:
            if rec.get("kind") == "batch":
                for child in rec["children"]:
                    wait_job(name, h, child["id"])
                status, rec = request(name, h, "GET", f"/jobs/{rec['id']}")
                assert status == 200
                records.append(rec)
            else:
                records.append(wait_job(name, h, rec["id"]))
    return records, stable_manifest(root)


def _bodies(inputs, out: Path):
    isolates = sorted(inputs["isolates"].iterdir())
    return [
        {"assemblies_dir": str(inputs["asm"]), "command": "compress",
         "threads": 2, "out_dir": str(out / "compress")},
        {"assemblies_dir": str(inputs["asm"]), "command": "pipeline",
         "threads": 2, "out_dir": str(out / "pipeline")},
        {"batch": [{"assemblies_dir": str(d), "out_dir": str(out / d.name)}
                   for d in isolates[:2]], "command": "pipeline",
         "kmer": 21},
        {"batch": [{"assemblies_dir": str(d),
                    "out_dir": str(out / "fleet" / d.name)}
                   for d in isolates], "command": "pipeline", "kmer": 21,
         "fleet": True},
        {"assemblies_dir": str(inputs["corrupt"]), "command": "compress"},
    ]


@pytest.mark.parametrize("workers", [1, 2])
def test_jobs_match_jax_daemon(inputs, tmp_path, workers, capsys):
    """Compress, pipeline, batch and fleet bodies and a corrupt isolate
    through both daemons: every output file equal byte for byte, the
    records and the manifest equal apart from times, ids and paths, the
    corrupt job quarantined while the daemon keeps serving."""
    got = {}
    for name in ("jax", "port"):
        out = tmp_path / name / "out"
        got[name] = _run_jobs(name, tmp_path / name / "root",
                              _bodies(inputs, out), workers)
        got[name] = (*got[name], out_files(out))
    (jax_records, jax_manifest, jax_files) = got["jax"]
    (records, manifest, files) = got["port"]
    assert files == jax_files
    assert "pipeline/consensus_assembly.fasta" in files
    assert sum(k.startswith("fleet/") for k in files) >= 3 * 10
    assert [stable(r) for r in records] == [stable(r) for r in jax_records]
    assert [r["state"] for r in records] == \
        ["done", "done", "done", "done", "failed"]
    assert records[2]["states"] == {"done": 2} and records[3]["fleet"] == 3
    assert records[4]["error"] == jax_records[4]["error"]
    assert manifest == jax_manifest
    capsys.readouterr()


def test_concurrent_jobs_scoped_and_equal_to_one_worker(inputs, tmp_path,
                                                        capsys):
    """Two workers, four jobs: each run dir holds only its job's spans and
    its QC and ledger entries (each carrying the job's trace id), and the
    outputs equal a one-worker daemon's."""
    isolates = sorted(inputs["isolates"].iterdir())
    files = {}
    for workers in (1, 2):
        out = tmp_path / f"w{workers}"
        bodies = [{"assemblies_dir": str(d), "command": "pipeline",
                   "kmer": 21, "out_dir": str(out / d.name)}
                  for d in isolates] + [
            {"assemblies_dir": str(inputs["asm"]), "command": "pipeline",
             "out_dir": str(out / "asm")}]
        with daemon("port", tmp_path / f"root{workers}",
                    workers=workers) as h:
            ids = []
            for i, body in enumerate(bodies):
                status, rec = request("port", h, "POST", "/jobs", body=body,
                                      headers={"X-Autocycler-Trace":
                                               f"t-{workers}-{i}"})
                assert status == 202
                ids.append(rec["id"])
            records = [wait_job("port", h, i) for i in ids]
        files[workers] = out_files(out)
        for i, rec in enumerate(records):
            assert rec["state"] == "done"
            run_dir = Path(rec["run_dir"])
            lines = [json.loads(x) for x in
                     (run_dir / "trace.jsonl").read_text().splitlines()]
            assert lines[0]["trace_id"] == f"t-{workers}-{i}"
            job_spans = {r["name"] for r in lines
                         if r.get("type") == "span"
                         and r["name"].startswith("job/")}
            assert job_spans == {f"job/{rec['id']}"}
            qc = json.loads((run_dir / "qc_report.json").read_text())
            ledger = json.loads((run_dir / "ledger.json").read_text())
            assert qc["trace_id"] == ledger["trace_id"] == f"t-{workers}-{i}"
            assert {e["isolate"] for e in qc["entries"]} == {rec["id"]}
            assert {s["isolate"] for s in ledger["stages"]} == {rec["id"]}
            assert ledger["inputs"] and all(
                p.startswith(bodies[i]["assemblies_dir"])
                for p in ledger["inputs"])
    assert files[2] == files[1] and len(files[1]) > 40
    # the jobs' entries were drained from the shared tables
    from autocycler_tpu_torch.obs import ledger, qc
    assert not any(str(e.get("isolate")).startswith("job-")
                   for e in qc.entries())
    assert not any(str(e.get("isolate")).startswith("job-")
                   for e in ledger.build_ledger()["stages"])
    capsys.readouterr()


def test_rejections_match_jax(tmp_path, capsys):
    """400 on a bad spec (the same messages as the JAX daemon), 404 on an
    unknown job, and 503 with Retry-After at queue capacity."""
    bad = [{"zap": 1}, {"assemblies_dir": "/x", "kmer": 50},
           {"assemblies_dir": "/x", "command": "nope"},
           {"batch": []}, {"batch": [{"assemblies_dir": "/x"}], "fleet": True}]
    answers = {}
    for name in ("jax", "port"):
        with daemon(name, tmp_path / name, workers=1) as h:
            answers[name] = [request(name, h, "POST", "/jobs", body=b)
                             for b in bad]
            answers[name].append(request(name, h, "GET", "/jobs/job-999999"))
    assert answers["port"] == answers["jax"]
    assert [s for s, _ in answers["port"]] == [400] * 5 + [404]

    gate = threading.Event()
    with daemon("port", tmp_path / "full", queue_size=1, workers=1) as h:
        h.scheduler._run_spec = lambda spec, out_dir, **kw: gate.wait(30)
        try:
            spec = {"assemblies_dir": str(tmp_path)}
            _, first = request("port", h, "POST", "/jobs", body=spec)
            assert _wait_until(lambda: request(
                "port", h, "GET", f"/jobs/{first['id']}")[1]["state"]
                == "running")
            assert request("port", h, "POST", "/jobs", body=spec)[0] == 202
            status, headers, body = raw_request(h.endpoint, "POST", "/jobs",
                                                body=spec)
            assert status == 503 and "full" in json.loads(body)["error"]
            assert headers.get("Retry-After") == "15"
        finally:
            gate.set()
        assert _wait_until(h.scheduler.idle)
    capsys.readouterr()


def test_token_auth(tmp_path, monkeypatch, capsys):
    """With AUTOCYCLER_SERVE_TOKEN set: 401 without it, 200 with it, and
    the token in neither serve.json nor the log."""
    monkeypatch.setenv("AUTOCYCLER_SERVE_TOKEN", "s3cret-t0ken")
    with daemon("port", tmp_path / "root", workers=1) as h:
        status, headers, _ = raw_request(h.endpoint, "GET", "/healthz")
        assert status == 401 and headers.get("WWW-Authenticate") == "Bearer"
        status, _, _ = raw_request(
            h.endpoint, "GET", "/healthz",
            headers={"X-Autocycler-Token": "s3cret-t0ken"})
        assert status == 200
        assert request("port", h, "GET", "/healthz")[0] == 200
        info = (h.root / "serve.json").read_text()
        assert json.loads(info)["auth"] == "token"
        assert "s3cret-t0ken" not in info
    out = capsys.readouterr()
    assert "s3cret-t0ken" not in out.out + out.err


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_replay_of_the_other_packages_manifest(inputs, tmp_path, writer,
                                               reader, capsys):
    """A daemon of one package admits a compress job and a fleet body and
    dies before running them; the other package's daemon on the same root
    replays both and writes what the writer's own daemon would have."""
    root, out = tmp_path / "root", tmp_path / "out"
    sched = _pkg(writer)["scheduler"].Scheduler(
        root, workers=1, **({"device": "cpu"} if writer == "port" else {}))
    proto = _pkg(writer)["protocol"]
    sched.submit(proto.parse_job_spec({
        "assemblies_dir": str(inputs["asm"]), "out_dir": str(out / "asm")}))
    sched.submit_fleet(proto.parse_batch_spec({
        "batch": [{"assemblies_dir": str(d), "out_dir": str(out / d.name)}
                  for d in sorted(inputs["isolates"].iterdir())[:2]],
        "command": "pipeline", "kmer": 21}))
    with daemon(reader, root, workers=1) as h:
        assert _wait_until(lambda: len(h.scheduler.jobs()) == 2 and all(
            j.state == "done" for j in h.scheduler.jobs()),
            timeout=JOB_TIMEOUT_S)
    replayed = out_files(out)
    fresh = tmp_path / "fresh"
    _run_jobs(writer, tmp_path / "fresh_root", [
        {"assemblies_dir": str(inputs["asm"]),
         "out_dir": str(fresh / "asm")},
        {"batch": [{"assemblies_dir": str(d), "out_dir": str(fresh / d.name)}
                   for d in sorted(inputs["isolates"].iterdir())[:2]],
         "command": "pipeline", "kmer": 21, "fleet": True}], workers=1)
    assert replayed == out_files(fresh) and len(replayed) > 20
    counts = json.loads((root / "serve_manifest.json").read_text())["items"]
    assert sorted(e["status"] for e in counts.values()) == ["done", "done"]
    capsys.readouterr()


def test_metrics_healthz_and_slo_match_jax(inputs, tmp_path, monkeypatch,
                                          capsys):
    """After the same job, /metrics carries the same serve families and
    /healthz the same keys (the probe apart); the probe report has the JAX
    probe's keys; the SLO trackers give the same report from the same
    samples."""
    from autocycler_tpu.obs import metrics_registry as jax_registry
    from autocycler_tpu_torch.obs import metrics_registry
    # the registries are process-wide: only this test's series are compared
    jax_registry.registry()._reset_for_tests()
    metrics_registry.reset()
    body = {"assemblies_dir": str(inputs["asm"]), "command": "compress"}
    metrics, health = {}, {}
    for name in ("jax", "port"):
        with daemon(name, tmp_path / name, workers=2) as h:
            _, rec = request(name, h, "POST", "/jobs", body=body)
            assert wait_job(name, h, rec["id"])["state"] == "done"
            _, raw = request(name, h, "GET", "/metrics")
            _, health[name] = request(name, h, "GET", "/healthz")
        metrics[name] = {line.split()[2] for line in raw["raw"].splitlines()
                         if line.startswith("# TYPE autocycler_serve_")}
    # the JAX package on the CPU runs compress's device steps on the host,
    # outside its token; the port's CPU run takes the card's code path, so
    # its token counts the wait of every device block
    token = "autocycler_serve_device_token_wait_seconds_total"
    assert token in metrics["port"]
    assert metrics["port"] - {token} == metrics["jax"] - {token}
    assert {"autocycler_serve_jobs_total", "autocycler_serve_workers",
            "autocycler_serve_busy_workers"} <= metrics["port"]
    assert set(health["port"]) == set(health["jax"])
    assert set(health["port"]["slo"]) == set(health["jax"]["slo"])
    assert health["port"]["workers"] == 2 and health["port"]["status"] == "ok"
    probe = health["port"]["probe"]
    # the JAX probe's keys that a report of what the port did can fill
    assert set(probe) - {"name"} == {"state", "kind", "resolve_s", "wait_s"}
    assert set(probe) - {"name"} <= set(health["jax"]["probe"])
    assert probe["kind"] == "cuda" and probe["wait_s"] == 0.0

    from autocycler_tpu.obs.metrics_registry import \
        MetricsRegistry as JaxRegistry
    from autocycler_tpu.serve.slo import SloTracker as JaxTracker
    from autocycler_tpu_torch.obs.metrics_registry import MetricsRegistry
    from autocycler_tpu_torch.serve.slo import SloTracker
    monkeypatch.setenv("AUTOCYCLER_SLO_P50_S", "0.8")
    monkeypatch.setenv("AUTOCYCLER_SLO_P95_S", "1.0")
    now = time.time()
    reports = []
    for tracker_cls, registry_cls in ((JaxTracker, JaxRegistry),
                                      (SloTracker, MetricsRegistry)):
        registry = registry_cls()
        tracker = tracker_cls(registry=registry)
        tracker.set_capacity(2)
        for i in range(40):
            tracker.record(0.01 * i, 0.5 + 0.1 * (i % 7),
                           finished_epoch=now - 40 + i, command="compress")
        report = tracker.report()
        assert report["burn_rate"] is not None and report["violated"]
        quantiles = [registry.quantile(name, q, command="compress")
                     for name in ("autocycler_serve_queue_wait_seconds",
                                  "autocycler_serve_exec_seconds")
                     for q in (0.5, 0.95)]
        reports.append((report, quantiles))
    assert reports[1] == reports[0]
    capsys.readouterr()


def test_registry_and_records_survive_jobs(inputs, tmp_path, capsys):
    """No job path resets the registry: after N jobs /metrics counts all N,
    and each job's dispatch records are folded into the device series
    (none of a job's left behind), while a record made outside every job
    is not a job's to fold."""
    from autocycler_tpu_torch import device
    from autocycler_tpu_torch.obs import metrics_registry
    from autocycler_tpu_torch.utils import timing
    device.reset_counts()
    with device.dp_dispatch("trim_overlap_dp", torch.device("cpu"), rows=1):
        pass                        # a record of no job

    def dispatched():
        reg = metrics_registry.registry()
        per_kind = {e["labels"]["what"]: e["count"] for e in
                    reg.snapshot()[timing.DEVICE_DISPATCH_HIST]["values"]} \
            if timing.DEVICE_DISPATCH_HIST in reg.snapshot() else {}
        return reg.value(timing.DEVICE_DISPATCHES), per_kind

    total0, kinds0 = dispatched()
    before = metrics_registry.registry().value(
        "autocycler_serve_jobs_total", state="done", command="pipeline")
    body = {"assemblies_dir": str(inputs["asm"]), "command": "pipeline"}
    with daemon("port", tmp_path / "root", workers=2) as h:
        ids = [request("port", h, "POST", "/jobs", body=dict(
            body, out_dir=str(tmp_path / f"o{i}")))[1]["id"]
            for i in range(3)]
        for job_id in ids:
            assert wait_job("port", h, job_id)["state"] == "done"
        assert _wait_until(h.scheduler.idle)
        _, raw = request("port", h, "GET", "/metrics")
    assert metrics_registry.registry().value(
        "autocycler_serve_jobs_total", state="done",
        command="pipeline") == before + 3
    assert 'autocycler_serve_jobs_total{command="pipeline",state="done"}' \
        in raw["raw"]
    # the one record left is the one no job made
    assert [len(r) for r in device.dp_dispatches.values()] == \
        [1, 0, 0, 0, 0, 0]
    assert not any(device.work_blocks.values())
    total, kinds = dispatched()
    # each compress groups three times (end repair, windows, grams)
    assert kinds.get("sortnet_pack_rank", 0) >= \
        kinds0.get("sortnet_pack_rank", 0) + 9
    assert total >= total0 + 9 + 3 * 2   # + adjacency, chains a compress
    capsys.readouterr()


def test_device_error_stops_the_daemon_and_replays(inputs, tmp_path,
                                                   monkeypatch, capsys):
    """A RuntimeError (what a CUDA error is) is not quarantined: the job
    fails in the manifest with the error, the daemon stops admitting (503)
    and asks to shut down, `serve` exits 1 with Error:, and a restarted
    daemon replays the job left pending. An input error is quarantined
    and the daemon keeps serving."""
    from autocycler_tpu_torch.commands import compress as compress_mod
    from autocycler_tpu_torch.serve import server
    real = compress_mod.compress
    calls = []

    def flaky(*args, **kwargs):
        calls.append(args)
        if len(calls) == 1:
            raise RuntimeError("CUDA error: an illegal memory access")
        return real(*args, **kwargs)

    monkeypatch.setattr(compress_mod, "compress", flaky)
    root = tmp_path / "root"
    gate = threading.Event()
    with daemon("port", root, workers=1) as h:
        run_spec = h.scheduler._run_spec

        def gated(spec, out_dir, job_id=None):
            gate.wait(30)
            return run_spec(spec, out_dir, job_id=job_id)

        h.scheduler._run_spec = gated
        body = {"assemblies_dir": str(inputs["asm"])}
        _, first = request("port", h, "POST", "/jobs", body=body)
        _, second = request("port", h, "POST", "/jobs", body=body)
        gate.set()
        rec = wait_job("port", h, first["id"])
        assert rec["state"] == "failed" and "device error" in rec["error"]
        assert h._shutdown_requested.wait(10)
        status, answer = request("port", h, "POST", "/jobs", body=body)
        assert status == 503 and "device error" in answer["error"]
        _, health = request("port", h, "GET", "/healthz")
        assert "device" in health.get("degraded", [])
    items = json.loads((root / "serve_manifest.json").read_text())["items"]
    assert items[first["id"]]["status"] == "failed"
    assert "CUDA error" in items[first["id"]]["error"]
    assert items[second["id"]]["status"] == "pending"

    with daemon("port", root, workers=1) as h:
        assert wait_job("port", h, second["id"])["state"] == "done"
        _, bad = request("port", h, "POST", "/jobs",
                         body={"assemblies_dir": str(inputs["corrupt"])})
        assert wait_job("port", h, bad["id"])["state"] == "failed"
        _, health = request("port", h, "GET", "/healthz")
        assert health["status"] == "ok" and h.scheduler.failure is None

    # through serve(): the daemon stops and the command exits 1 with Error:
    calls.clear()
    monkeypatch.setattr(server.ServeHandle, "wait", lambda self, poll_s=0.2:
                        self._shutdown_requested.wait(JOB_TIMEOUT_S))
    from autocycler_tpu_torch import cli
    thread_rc = []

    def run():
        with monkeypatch.context() as m:
            m.setattr(server, "warm_process",
                      lambda root, device=None: torch.device("cpu"))
            thread_rc.append(cli.main(["serve", "-a", str(tmp_path / "s2"),
                                       "--port", "0", "--workers", "1"]))

    t = threading.Thread(target=run, daemon=True)
    t.start()
    from autocycler_tpu_torch.serve.client import (resolve_endpoint,
                                                   request_json)
    assert _wait_until(lambda: (tmp_path / "s2" / "serve.json").exists())
    endpoint = resolve_endpoint(serve_dir=tmp_path / "s2")
    request_json(endpoint, "POST", "/jobs", body=body)
    t.join(JOB_TIMEOUT_S)
    assert thread_rc == [1]
    assert "Error:" in capsys.readouterr().err


@pytest.mark.parametrize("error,prefix", [
    (torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate "
                                 "26.00 GiB"),
     "device memory exhausted: OutOfMemoryError: CUDA out of memory"),
    (NotImplementedError("no such path"),
     "unexpected error: NotImplementedError: no such path"),
    (RecursionError("maximum recursion depth exceeded"),
     "unexpected error: RecursionError: maximum recursion depth")],
    ids=["out_of_memory", "not_implemented", "recursion"])
def test_memory_and_bug_errors_fail_only_their_job(inputs, tmp_path,
                                                   monkeypatch, capsys,
                                                   error, prefix):
    """Three RuntimeError subclasses are no sticky device fault: the card
    running out of memory, and two bugs. Each fails its own job, with its
    kind in the error, and the daemon keeps serving the next one."""
    from autocycler_tpu_torch.commands import compress as compress_mod
    real = compress_mod.compress
    calls = []

    def failing_once(*args, **kwargs):
        calls.append(args)
        if len(calls) == 1:
            raise error
        return real(*args, **kwargs)

    monkeypatch.setattr(compress_mod, "compress", failing_once)
    root = tmp_path / "root"
    with daemon("port", root, workers=1) as h:
        body = {"assemblies_dir": str(inputs["asm"])}
        _, first = request("port", h, "POST", "/jobs", body=body)
        rec = wait_job("port", h, first["id"])
        _, second = request("port", h, "POST", "/jobs", body=body)
        assert wait_job("port", h, second["id"])["state"] == "done"
        assert rec["state"] == "failed" and rec["error"].startswith(prefix)
        _, health = request("port", h, "GET", "/healthz")
        assert health["status"] == "ok" and h.scheduler.failure is None
        assert not h._shutdown_requested.is_set()
    items = json.loads((root / "serve_manifest.json").read_text())["items"]
    assert items[first["id"]]["status"] == "failed"
    assert items[first["id"]]["error"].startswith(prefix)
    assert items[second["id"]]["status"] == "done"
    assert "quarantined" in capsys.readouterr().err


def test_cluster_memo_is_per_thread(monkeypatch):
    """Two clusterings on two threads: thread A stops on the last line of
    its memo lookup until thread B has filled its own memo. A memo shared
    by the process hands A B's matrix; the port's per-thread memo does
    not."""
    from autocycler_tpu_torch.commands import cluster as cl

    def distances_for(seed, n):
        rng = np.random.default_rng(seed)
        return {(a, b): float(rng.random()) for a in range(n)
                for b in range(n)}

    dist_a, ids_a = distances_for(1, 5), tuple(range(5))
    dist_b, ids_b = distances_for(2, 7), tuple(range(7))

    def expected(d, ids):
        pos = {a: i for i, a in enumerate(ids)}
        D = cl._distances_to_matrix(d, pos, len(ids))
        return (D < D.T) & (D < 0.5)

    want_a = expected(dist_a, ids_a)
    lines, start = inspect.getsourcelines(cl._contain_ab_cached)
    last_line = start + len(lines) - 1
    at_return, b_done = threading.Event(), threading.Event()
    results = {}

    def tracer(frame, event, arg):
        if frame.f_code is cl._contain_ab_cached.__code__:
            def local(frame, event, arg):
                if event == "line" and frame.f_lineno == last_line:
                    at_return.set()
                    b_done.wait(10)
                return local
            return local
        return None

    def thread_a():
        sys.settrace(tracer)
        try:
            results["a"] = cl._contain_ab_cached(dist_a, 0.5, ids_a)
        finally:
            sys.settrace(None)

    def thread_b():
        at_return.wait(10)
        results["b"] = cl._contain_ab_cached(dist_b, 0.5, ids_b)
        b_done.set()

    threads = [threading.Thread(target=f, daemon=True)
               for f in (thread_a, thread_b)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(20)
    assert at_return.is_set() and b_done.is_set()
    assert np.array_equal(results["a"], want_a)
    assert np.array_equal(results["b"], expected(dist_b, ids_b))


@pytest.mark.parametrize("kind", ["dp_dispatch", "device_work"])
def test_device_token_serializes_device_blocks(kind):
    """With the token on, device blocks on two threads never overlap (an
    event log of entries and exits); with it off they do, and nothing
    waits."""
    from autocycler_tpu_torch import device
    from autocycler_tpu_torch.utils import timing

    cpu = torch.device("cpu")

    def block(tag):
        if kind == "dp_dispatch":
            return device.dp_dispatch("trim_overlap_dp", cpu, rows=1)
        return device.device_work(f"work {tag}", cpu)

    def run(enabled: bool):
        timing.enable_device_token(enabled)
        log, lock = [], threading.Lock()
        both_in = threading.Barrier(2, timeout=1.0)

        def one(tag):
            with block(tag):
                with lock:
                    log.append(("in", tag))
                try:
                    both_in.wait()
                except threading.BrokenBarrierError:
                    pass
                time.sleep(0.02)
                with lock:
                    log.append(("out", tag))

        threads = [threading.Thread(target=one, args=(t,), daemon=True)
                   for t in "ab"]
        for t in threads:
            t.start()
        for t in threads:
            t.join(10)
        return log

    try:
        wait_before = timing.token_wait_seconds()
        on = run(True)
        assert [e[0] for e in on] == ["in", "out", "in", "out"]
        assert timing.token_wait_seconds() > wait_before
        off = run(False)
        assert [e[0] for e in off][:2] == ["in", "in"]
    finally:
        timing.enable_device_token(False)
        device.reset_counts()


@pytest.mark.parametrize("kind", ["device_token", "kernel_launch",
                                  "dp_dispatch", "device_work"])
def test_device_token_synchronises_before_release(kind, monkeypatch):
    """With the token on, each block's stream synchronise runs while the
    token is still held: the other thread's block enters only after it.
    The fake synchronise sleeps before it notes itself, so a release
    before the synchronise would let the other thread in first. With the
    token off, the synchronise is never called."""
    from autocycler_tpu_torch import device
    from autocycler_tpu_torch.utils import timing

    log, lock = [], threading.Lock()

    def note(event):
        with lock:
            log.append(event)

    def fake_sync(dev):
        tag = threading.current_thread().name
        return lambda: (time.sleep(0.1), note(("sync", tag)))

    class FakeEvent:
        def __init__(self, enable_timing=False):
            pass

        def record(self, stream=None):
            pass

    monkeypatch.setattr(device, "_stream_sync", fake_sync)
    # kernel_launch times with CUDA events on the current stream: fakes
    # here, so the block runs on the CPU
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: type("S", (), {"cuda_stream": 0}))
    cpu = torch.device("cpu")

    def block():
        if kind == "device_token":
            return timing.device_token("k", fake_sync(cpu))
        if kind == "kernel_launch":
            return device.kernel_launch("sortnet_pack_rank", cpu)
        if kind == "dp_dispatch":
            return device.dp_dispatch("trim_overlap_dp", cpu, rows=1)
        return device.device_work("adjacency", cpu)

    def run(enabled: bool):
        timing.enable_device_token(enabled)
        log.clear()
        a_in = threading.Event()

        def one(tag):
            if tag == "b":
                assert a_in.wait(10)
            with block():
                note(("in", tag))
                if tag == "a":
                    a_in.set()
                    time.sleep(0.05)    # b is waiting for the token now
        threads = [threading.Thread(target=one, args=(t,), name=t,
                                    daemon=True) for t in "ab"]
        for t in threads:
            t.start()
        for t in threads:
            t.join(10)
        return list(log)

    try:
        assert run(True) == [("in", "a"), ("sync", "a"), ("in", "b"),
                             ("sync", "b")]
        assert [e for e in run(False) if e[0] == "sync"] == []
    finally:
        timing.enable_device_token(False)
        device.reset_counts()


def test_scheduler_turns_the_token_on_with_workers(tmp_path):
    from autocycler_tpu_torch.serve.scheduler import Scheduler
    from autocycler_tpu_torch.utils import timing
    try:
        Scheduler(tmp_path / "two", workers=2, device="cpu")
        assert timing.device_token_enabled()
        Scheduler(tmp_path / "one", workers=1, device="cpu")
        assert not timing.device_token_enabled()
    finally:
        timing.enable_device_token(False)


def test_manifest_extras_match_jax(tmp_path):
    """RunManifest's scheduler extras write the JAX package's file."""
    from autocycler_tpu.utils.resilience import RunManifest as JaxManifest
    from autocycler_tpu_torch.utils.resilience import RunManifest
    for cls, name in ((JaxManifest, "jax.json"), (RunManifest, "port.json")):
        m = cls.load(tmp_path / name)
        m.annotate("job-000001", spec={"kmer": 51}, out_dir="o")
        m.start("job-000001")
        m.advance("job-000001", "compress")
        m.pending("job-000002")
        m.fail("job-000002", "bad input")
        assert m.attempts("job-000001") == 1
        assert m.last_stage("job-000001") == "compress"
        assert m.stage_outputs("job-000001", "compress") == {}
        assert m.counts() == {"running": 1, "failed": 1}
    assert (tmp_path / "port.json").read_text() == \
        (tmp_path / "jax.json").read_text()
