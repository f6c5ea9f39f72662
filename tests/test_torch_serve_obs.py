"""The run record under the port's serve daemon, against the JAX package's
readers: scoped trace runs and the pool tasks that run under them, the
time series beside a daemon and a traced CLI run, `report --json` and
`watch` frames of the same run dir from both packages, the CLI's `submit`,
`report` and `watch`, the daemon's build info and the card's probe report.
Every wait has its own timeout and every daemon stops in a ``finally``."""

import contextlib
import json
import threading
from pathlib import Path

import pytest
import torch

from synthetic import make_assemblies

pytestmark = pytest.mark.serve

JOB_TIMEOUT_S = 120.0


@pytest.fixture(scope="module")
def asm(tmp_path_factory):
    return make_assemblies(tmp_path_factory.mktemp("serve_obs"),
                           n_assemblies=3, chromosome_len=3000,
                           plasmid_len=600, seed=5)


@contextlib.contextmanager
def port_daemon(root: Path, **kwargs):
    from autocycler_tpu_torch.serve.server import ServeHandle
    handle = ServeHandle(root, port=0, device="cpu", **kwargs).start()
    try:
        yield handle
    finally:
        handle.stop()


def run_job(handle, body: dict) -> dict:
    from autocycler_tpu_torch.serve.client import request_json, wait_for_job
    status, record = request_json(handle.endpoint, "POST", "/jobs",
                                  body=body,
                                  headers={"X-Autocycler-Trace": "t-obs"})
    assert status == 202, record
    return wait_for_job(handle.endpoint, record["id"], poll_s=0.05,
                        timeout=JOB_TIMEOUT_S)


def test_scoped_runs_are_disjoint_beside_the_process_run(tmp_path):
    """Two scoped runs bound on two threads and the process-wide run on a
    third record into three files; abort_run closes them all."""
    from autocycler_tpu_torch.obs import trace
    trace.abort_run()
    trace.start_run(tmp_path / "cli", name="cli")
    runs = {tag: trace.open_run(tmp_path / tag, name=tag, trace_id=f"t-{tag}")
            for tag in ("a", "b")}
    barrier = threading.Barrier(2, timeout=10)

    def job(tag):
        with trace.bind_run(runs[tag]):
            assert trace.current_run() is runs[tag]
            assert trace.trace_dir() == tmp_path / tag
            barrier.wait()
            with trace.span(f"job/{tag}", cat="command"):
                with trace.span("stage", cat="stage"):
                    barrier.wait()

    threads = [threading.Thread(target=job, args=(t,)) for t in "ab"]
    for t in threads:
        t.start()
    with trace.span("cli-only", cat="command"):
        pass
    for t in threads:
        t.join(10)
    for tag, run in runs.items():
        assert trace.close_run(run) == tmp_path / tag
        assert trace.close_run(run) is None
        records = [json.loads(x) for x in
                   (tmp_path / tag / "trace.jsonl").read_text().splitlines()]
        assert records[0]["trace_id"] == f"t-{tag}"
        names = [r["name"] for r in records if r["type"] == "span"]
        assert names == ["stage", f"job/{tag}"]
        assert records[-1]["type"] == "finish"
        assert (tmp_path / tag / "trace.chrome.json").is_file()
    stray = trace.open_run(tmp_path / "stray")
    assert trace.tracing_active()
    trace.abort_run()
    assert not trace.tracing_active() and stray.closed
    cli = (tmp_path / "cli" / "trace.jsonl").read_text()
    assert "cli-only" in cli and "job/" not in cli


def test_pool_tasks_run_under_the_job_context(tmp_path):
    """pool_map, the ordered lane and the read-ahead run their tasks under
    the submitting thread's bound run and scopes: a job's pooled spans and
    QC entries are its own, an isolate inside it is ``<job>/<isolate>``."""
    from autocycler_tpu_torch.obs import qc, trace
    from autocycler_tpu_torch.utils import pool
    run = trace.open_run(tmp_path / "job", name="job")
    other = trace.open_run(tmp_path / "other", name="other")

    def task(i):
        with trace.span(f"task-{i}", cat="substage"):
            qc.record("compress", i=i)
        return qc.current_scope()

    try:
        with trace.bind_run(run), qc.job_scope("job-000009"):
            assert pool.pool_map(task, range(4), workers=3) == \
                ["job-000009"] * 4
            with qc.scope("iso_a"):
                assert list(pool.prefetch_iter(task, [4, 5], workers=3)) == \
                    ["job-000009/iso_a"] * 2
                lane = pool.OrderedSubmitter(workers=3)
                lane.submit(task, 6)
                lane.drain()
    finally:
        trace.close_run(run)
        trace.close_run(other)
    spans = [json.loads(x)["name"] for x in
             (tmp_path / "job" / "trace.jsonl").read_text().splitlines()
             if '"span"' in x]
    assert sorted(spans) == [f"task-{i}" for i in range(7)]
    assert "task-" not in (tmp_path / "other" / "trace.jsonl").read_text()
    mine = [e for e in qc.entries()
            if str(e.get("isolate")).startswith("job-000009")]
    assert sorted(e["isolate"] for e in mine) == \
        ["job-000009"] * 4 + ["job-000009/iso_a"] * 3
    assert qc.drain_scope("job-000009") == 7
    assert qc.current_scope() is None


def test_timeseries_report_and_watch_match_jax_readers(asm, tmp_path,
                                                       monkeypatch, capsys):
    """A daemon job's run dir and the daemon root's time series, read by
    both packages: the same series and summary, the same `report --json`
    and the same `watch` frame; the ticks carry the probe report."""
    from autocycler_tpu.obs import report as jax_report
    from autocycler_tpu.obs import timeseries as jax_ts
    from autocycler_tpu.obs import watch as jax_watch
    from autocycler_tpu_torch.obs import report, timeseries, watch
    monkeypatch.setenv("AUTOCYCLER_TIMESERIES_INTERVAL_S", "0.05")
    root = tmp_path / "root"
    with port_daemon(root, workers=2) as h:
        record = run_job(h, {"assemblies_dir": str(asm),
                             "command": "pipeline"})
        assert record["state"] == "done"
        assert h.sampler.last_tick_epoch is not None
    series = timeseries.read_timeseries(root / "timeseries.jsonl")
    assert series and series == jax_ts.read_timeseries(
        root / "timeseries.jsonl")
    assert all(t["probe"]["kind"] == "cuda" and "serve" in t for t in series)
    assert timeseries.summarize_timeseries(series) == \
        jax_ts.summarize_timeseries(series)
    run_dir = Path(record["run_dir"])
    got, want = report.build_report(run_dir), jax_report.build_report(run_dir)
    assert got == want and got["qc"] and got["ledger"]
    records = [json.loads(x) for x in
               (run_dir / "trace.jsonl").read_text().splitlines()]
    frame = watch.render_frame(run_dir, records)
    assert frame == jax_watch.render_frame(run_dir, records)
    assert "finished" in frame and "QC" in frame
    capsys.readouterr()


def test_cli_samples_beside_a_traced_run(asm, tmp_path, monkeypatch, capsys):
    """A traced CLI command writes timeseries.jsonl beside its trace, as the
    JAX CLI does; report, watch, top, serve and submit own no run."""
    from autocycler_tpu_torch import cli
    from autocycler_tpu_torch.commands.compress import compress
    compress(asm, tmp_path / "o", device="cpu")
    monkeypatch.setenv("AUTOCYCLER_TRACE_DIR", str(tmp_path / "trace"))
    monkeypatch.setenv("AUTOCYCLER_TIMESERIES_INTERVAL_S", "0.05")
    real = cli.dispatch

    def slow(args):                 # outlast a few sampler ticks
        try:
            return real(args)
        finally:
            threading.Event().wait(0.3)

    monkeypatch.setattr(cli, "dispatch", slow)
    assert cli.main(["decompress", "-i",
                     str(tmp_path / "o" / "input_assemblies.gfa"),
                     "-o", str(tmp_path / "recon")]) == 0
    ticks = (tmp_path / "trace" / "timeseries.jsonl").read_text().splitlines()
    assert len(ticks) >= 2 and json.loads(ticks[-1])["tick"] == len(ticks)
    assert (tmp_path / "trace" / "trace.jsonl").is_file()
    assert cli.NO_RUN_COMMANDS == {"report", "watch", "top", "serve",
                                   "submit"}
    capsys.readouterr()


def test_report_watch_and_submit_through_the_cli(asm, tmp_path, capsys):
    """`submit --wait` needs no card and runs the job on the daemon;
    `report --json` prints the JAX CLI's document for its run dir, and
    `watch` the JAX CLI's frame."""
    from autocycler_tpu import cli as jax_cli
    from autocycler_tpu_torch import cli
    root = tmp_path / "root"
    with port_daemon(root, workers=1) as h:
        capsys.readouterr()
        assert cli.main(["submit", "-i", str(asm), "--dir", str(root),
                         "--wait", "--timeout", str(JOB_TIMEOUT_S),
                         "--trace-id", "t-cli"]) == 0
        err = capsys.readouterr().err
        assert "done" in err and "trace id: t-cli" in err
        job = h.scheduler.jobs()[0]
        assert job.state == "done" and job.trace_id == "t-cli"
    run_dir = str(job.run_dir)
    outputs = {}
    for name, main in (("port", cli.main), ("jax", jax_cli.main)):
        assert main(["report", run_dir, "--json"]) in (0, None)
        report_json = json.loads(capsys.readouterr().out)
        assert main(["watch", run_dir]) == 0
        outputs[name] = (report_json, capsys.readouterr().out)
    assert outputs["port"] == outputs["jax"]
    assert sorted(p.name for p in Path(run_dir).iterdir()) == [
        "ledger.json", "metrics.json", "metrics.prom", "out",
        "qc_report.json", "trace.chrome.json", "trace.jsonl"]


def test_build_info_and_probe_report(monkeypatch):
    """The daemon's build info names the port, torch, CUDA and numpy; the
    probe report takes the JAX probe's keys that a report of what the port
    did can fill, and says when CUDA was attached."""
    from autocycler_tpu.ops.distance import probe_overlap_report
    from autocycler_tpu_torch import device
    from autocycler_tpu_torch.obs import federate, metrics_registry
    info = federate.build_info()
    assert set(info) == {"autocycler_tpu_torch", "torch", "numpy", "cuda"}
    assert info["torch"] == torch.__version__
    federate.record_build_info()
    assert 'autocycler_build_info{cuda="' in metrics_registry.to_prometheus()

    for key in ("state", "name", "resolve_s"):
        if key in device._probe:
            monkeypatch.setitem(device._probe, key, device._probe[key])
    shared = {"state", "kind", "resolve_s", "wait_s"}
    assert shared <= set(probe_overlap_report())
    unstarted = device.probe_report()
    assert set(unstarted) == shared and unstarted["resolve_s"] is None
    monkeypatch.setitem(device._probe, "state", "unstarted")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "Card X")
    assert device.resolve_device(None).type == "cuda"
    report = device.probe_report()
    assert report["state"] == "attached" and report["name"] == "Card X"
    assert report["resolve_s"] >= 0.0 and report["wait_s"] == 0.0
    assert set(report) == shared | {"name"}
    device._probe.pop("name", None)
    monkeypatch.setitem(device._probe, "state", "unstarted")


def test_serve_cli_flags_match_jax():
    """`serve`, `submit`, `report` and `watch` take the JAX CLI's flags."""
    from autocycler_tpu import cli as jax_cli
    from autocycler_tpu_torch import cli

    def flags(parser, command):
        sub = next(a for a in parser._actions
                   if a.__class__.__name__ == "_SubParsersAction")
        return sorted((a.dest, tuple(a.option_strings), a.default)
                      for a in sub.choices[command]._actions)

    for command in ("serve", "submit", "report", "watch"):
        assert flags(cli.build_parser(), command) == \
            flags(jax_cli.build_parser(), command), command


def test_unix_socket_fleet_routing_and_html_report(asm, tmp_path, capsys):
    """The daemon on a Unix socket, found through its serve.json; `submit
    --fleet-dir` routes to the least-loaded of two replicas; `report
    --html` writes a run_report.html naming the port."""
    from autocycler_tpu_torch import cli
    from autocycler_tpu_torch.serve.client import (request_json,
                                                   resolve_endpoint)
    from autocycler_tpu_torch.serve.server import ServeHandle
    sock = tmp_path / "d.sock"
    handle = ServeHandle(tmp_path / "sock_root", socket_path=sock,
                         workers=1, device="cpu").start()
    try:
        endpoint = resolve_endpoint(serve_dir=tmp_path / "sock_root")
        assert endpoint == f"unix:{sock}"
        status, health = request_json(endpoint, "GET", "/healthz")
        assert status == 200 and health["workers"] == 1
    finally:
        handle.stop()
    assert not sock.exists()

    fleet = tmp_path / "fleet"
    with port_daemon(fleet / "a", workers=1) as a, \
            port_daemon(fleet / "b", workers=2) as b:
        capsys.readouterr()
        assert cli.main(["submit", "-i", str(asm), "--fleet-dir",
                         str(fleet), "--wait",
                         "--timeout", str(JOB_TIMEOUT_S)]) == 0
        assert "routed to" in capsys.readouterr().err
        jobs = a.scheduler.jobs() + b.scheduler.jobs()
        assert [j.state for j in jobs] == ["done"]
    run_dir = jobs[0].run_dir
    assert cli.main(["report", str(run_dir), "--html", ""]) == 0
    page = (run_dir / "run_report.html").read_text()
    assert "Provenance" in page and "autocycler_tpu_torch" in page
    capsys.readouterr()
