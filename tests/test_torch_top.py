"""The port's `top` (obs/top.py) and the rest of fleet federation
(obs/federate.py) against the JAX package's: the same frame text from both
packages' renderers over the same serve root and run dirs (times masked),
with the Device/host and Spill lines of a port daemon that streamed;
merged histogram quantiles against numpy, merged counters and gauges, the
never-raise scraper, the scale verdicts' hysteresis, cooldown and
scale-in; and `top --fleet` over two port daemons on the CPU."""

import contextlib
import io
import json
import random
import re
import time
from pathlib import Path

import numpy as np
import pytest

from autocycler_tpu.obs import federate as jax_fed
from autocycler_tpu.obs import top as jax_top
from autocycler_tpu.obs.metrics_registry import MetricsRegistry as JaxRegistry
from autocycler_tpu_torch.obs import federate, top
from autocycler_tpu_torch.obs.metrics_registry import (DEFAULT_BUCKETS,
                                                       SECONDS_BUCKETS,
                                                       MetricsRegistry)
from autocycler_tpu_torch.obs.timeseries import TimeseriesSampler

from synthetic import make_assemblies

pytestmark = pytest.mark.serve

JOB_TIMEOUT_S = 120.0
SCALE_KNOBS = ("AUTOCYCLER_FED_STALE_S", "AUTOCYCLER_FED_TIMEOUT_S",
               "AUTOCYCLER_SCALE_OUT_BURN", "AUTOCYCLER_SCALE_OUT_UTIL",
               "AUTOCYCLER_SCALE_OUT_QUEUE", "AUTOCYCLER_SCALE_IN_UTIL",
               "AUTOCYCLER_SCALE_COOLDOWN_S", "AUTOCYCLER_SCALE_HYSTERESIS")


@pytest.fixture(autouse=True)
def _default_knobs(monkeypatch):
    for name in SCALE_KNOBS:
        monkeypatch.delenv(name, raising=False)


def _masked(frame):
    """A frame with what depends on the clock at render time masked."""
    frame = re.sub(r" up [^ \]]+", " up T", frame)
    frame = re.sub(r"\[STALE: last tick .* ago\]", "[STALE]", frame)
    return re.sub(r"\[cooldown [^\]]+\]", "[cooldown T]", frame)


def _both(root, fleet=False):
    """Both packages' frames of ``root``, masked."""
    if fleet:
        return (_masked(top.render_fleet_frame(root) or ""),
                _masked(jax_top.render_fleet_frame(root) or ""))
    return (_masked(top.render_top_frame(root) or ""),
            _masked(jax_top.render_top_frame(root) or ""))


# ---------------------------------------------------------------- top


def _mini_series(tmp_path, reg=None):
    reg = reg or MetricsRegistry()
    sampler = TimeseriesSampler(tmp_path, interval=0.05, registry=reg)
    for depth in (0, 2, 1):
        reg.gauge_set("autocycler_serve_queue_depth", depth, help="h")
        reg.counter_inc("autocycler_serve_jobs_total", 1, help="h",
                        state="done", command="compress")
        reg.observe("autocycler_serve_job_seconds", 1.5,
                    buckets=SECONDS_BUCKETS, command="compress", help="h")
        reg.counter_inc("autocycler_device_seconds_total", 0.25, help="h")
        sampler.sample()
    return reg


def test_top_renders_frame_from_artifacts(tmp_path, capsys):
    _mini_series(tmp_path)
    (tmp_path / "serve_manifest.json").write_text(
        json.dumps({"items": {"job-000001": {"status": "done"}}}))
    frame = top.render_top_frame(tmp_path)
    assert "Queue depth" in frame and "Throughput" in frame
    assert "Latency" in frame and "1 done" in frame
    assert "Device/host  device" in frame and "0.75s in view" in frame
    got, want = _both(tmp_path)
    assert got == want
    assert top.top(tmp_path) == 0
    assert "Autocycler top" in capsys.readouterr().out


def test_top_once_errors_on_empty_dir(tmp_path, capsys):
    assert top.top(tmp_path) == 1
    assert "nothing to show" in capsys.readouterr().err
    assert top.top(tmp_path, fleet=True) == 1
    assert "nothing to federate" in capsys.readouterr().err


def test_top_follow_bounded_cycles(tmp_path, capsys):
    _mini_series(tmp_path)
    assert top.top(tmp_path, follow=True, interval=0.01, cycles=2) == 0
    assert capsys.readouterr().out.count("Autocycler top") == 2


def test_top_cli_subcommand_owns_no_run(tmp_path, capsys, monkeypatch):
    from autocycler_tpu.cli import build_parser as jax_parser
    from autocycler_tpu_torch import cli
    _mini_series(tmp_path)
    monkeypatch.setenv("AUTOCYCLER_TRACE_DIR", str(tmp_path / "run"))
    assert cli.main(["top", str(tmp_path), "--once"]) == 0
    assert "Autocycler top" in capsys.readouterr().out
    assert not (tmp_path / "run").exists()
    assert "top" in cli.NO_RUN_COMMANDS

    def flags(parser):
        sub = next(a for a in parser._actions
                   if a.__class__.__name__ == "_SubParsersAction")
        return sorted((a.dest, a.default, a.nargs) for a in
                      sub.choices["top"]._actions if a.dest != "help")
    assert flags(cli.build_parser()) == flags(jax_parser())


def test_sparkline():
    assert top.sparkline([]) == ""
    assert top.sparkline([1.0, 1.0]) == "▁▁"
    line = top.sparkline([0, 1, 2, 3])
    assert len(line) == 4 and line[0] == "▁" and line[-1] == "█"
    assert len(top.sparkline(list(range(100)), width=16)) == 16
    values = [random.Random(3).random() for _ in range(40)]
    assert top.sparkline(values) == jax_top.sparkline(values)


def test_top_renders_spill_line(tmp_path):
    entries = [
        {"ts": 100.0 + i, "interval_s": 1.0,
         "gauges": {"autocycler_stream_spill_bytes": float(i) * 2**20},
         "counters": {"autocycler_stream_bins_total": float(i % 2)},
         "host": {"rss_bytes": 10.0 * 2**20}}
        for i in range(5)
    ]
    with open(tmp_path / "timeseries.jsonl", "w") as f:
        for e in entries:
            f.write(json.dumps(e) + "\n")
    frame = top.render_top_frame(tmp_path)
    assert "Spill" in frame and "bins +2 in view" in frame
    got, want = _both(tmp_path)
    assert got == want


def test_top_omits_spill_line_when_never_spilled(tmp_path):
    with open(tmp_path / "timeseries.jsonl", "w") as f:
        f.write(json.dumps({"ts": 1.0, "gauges": {}, "counters": {},
                            "host": {"rss_bytes": 1.0}}) + "\n")
    assert "Spill" not in top.render_top_frame(tmp_path)
    got, want = _both(tmp_path)
    assert got == want


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
                                  body=body)
    assert status == 202, record
    return wait_for_job(handle.endpoint, record["id"], poll_s=0.05,
                        timeout=JOB_TIMEOUT_S)


@pytest.mark.parametrize("streamed", [True, False])
def test_daemon_frames_equal_the_jax_packages(tmp_path, monkeypatch,
                                              streamed):
    """A port daemon's root after two compress jobs, read by both
    packages' top: the same frame. Its device seconds are in view, and
    the Spill line is there when the jobs streamed (a forced plan) and
    absent when they did not."""
    asm = make_assemblies(tmp_path / "asm", n_assemblies=2,
                          chromosome_len=3000, plasmid_len=500, seed=21)
    monkeypatch.setenv("AUTOCYCLER_TIMESERIES_INTERVAL_S", "0.05")
    if streamed:
        monkeypatch.setenv("AUTOCYCLER_STREAM_KMERS", "on")
        monkeypatch.setenv("AUTOCYCLER_STREAM_BINS", "5")
        monkeypatch.setenv("AUTOCYCLER_STREAM_CHUNK", "1000")
    else:
        monkeypatch.setenv("AUTOCYCLER_STREAM_KMERS", "off")
    root = tmp_path / "root"
    from autocycler_tpu_torch.obs import metrics_registry
    metrics_registry.reset()        # a daemon's process starts with none
    with contextlib.redirect_stderr(io.StringIO()), \
            port_daemon(root, workers=1) as h:
        for i in range(2):
            record = run_job(h, {"assemblies_dir": str(asm),
                                 "command": "compress",
                                 "out_dir": str(tmp_path / f"out{i}")})
            assert record["state"] == "done"
        time.sleep(0.2)             # a tick after the last job's fold
    got, want = _both(root)         # the sampler has stopped: no race
    assert got == want
    lines = {line.split()[0]: line for line in got.splitlines()}
    assert "Jobs:" in lines and "2 done" in lines["Jobs:"]
    seconds = float(re.search(r"device \S* ([0-9.]+)s in view",
                              lines["Device/host"]).group(1))
    assert seconds > 0
    assert ("Spill" in lines) == streamed
    if streamed:
        bins = int(re.search(r"bins \+(\d+) in view",
                             lines["Spill"]).group(1))
        assert bins >= 2


# ---------------------------------------------------------------- merging


def _bucket_width(edges, value):
    prev = 0.0
    for edge in edges:
        if value <= edge:
            return edge - prev
        prev = edge
    return float("inf")


def _both_snapshots(fill):
    """Per-replica snapshots of each package's registry, filled alike."""
    out = {}
    for name, cls in (("port", MetricsRegistry), ("jax", JaxRegistry)):
        regs = fill(cls)
        out[name] = {r: reg.snapshot() for r, reg in regs.items()}
    return out


@pytest.mark.parametrize("q,n_replicas", [(0.5, 2), (0.95, 2), (0.5, 5),
                                          (0.95, 5)])
def test_merged_hist_quantiles_vs_numpy(q, n_replicas):
    pooled = []

    def fill(cls):
        rng = random.Random(7 * n_replicas)
        pooled.clear()
        regs = {}
        for r in range(n_replicas):
            reg = cls()
            for _ in range(100 + 400 * r):      # uneven load per replica
                v = rng.lognormvariate(0.5, 0.9)
                pooled.append(v)
                reg.observe("autocycler_serve_job_seconds", v,
                            buckets=SECONDS_BUCKETS, help="h",
                            command="compress")
            regs[f"r{r}"] = reg
        return regs

    snaps = _both_snapshots(fill)
    merged = federate.merge_metrics(snaps["port"])
    assert merged == jax_fed.merge_metrics(snaps["jax"])
    entry = merged["hists"]["autocycler_serve_job_seconds{command=compress}"]
    assert entry["count"] == len(pooled)
    assert entry["replicas"] == n_replicas and entry["skipped"] == 0
    assert entry["min"] == pytest.approx(min(pooled))
    assert entry["max"] == pytest.approx(max(pooled))
    est = entry["p50"] if q == 0.5 else entry["p95"]
    exact = float(np.percentile(pooled, q * 100))
    assert abs(est - exact) <= _bucket_width(SECONDS_BUCKETS, exact)
    assert min(pooled) <= est <= max(pooled)


def test_merge_counters_gauges_and_info():
    def fill(cls):
        a, b = cls(), cls()
        a.counter_inc("autocycler_serve_jobs_total", 3, help="h",
                      state="done")
        b.counter_inc("autocycler_serve_jobs_total", 4, help="h",
                      state="done")
        b.counter_inc("autocycler_serve_jobs_total", 1, help="h",
                      state="failed")
        a.gauge_set("autocycler_serve_queue_depth", 2, help="h")
        b.gauge_set("autocycler_serve_queue_depth", 5, help="h")
        a.info_set("autocycler_build_info", "1", help="h", torch="x")
        return {"a": a, "b": b}

    snaps = _both_snapshots(fill)
    merged = federate.merge_metrics(snaps["port"])
    assert merged == jax_fed.merge_metrics(snaps["jax"])
    assert merged["counters"]["autocycler_serve_jobs_total{state=done}"] == 7
    assert merged["counters"][
        "autocycler_serve_jobs_total{state=failed}"] == 1
    depth = merged["gauges"]["autocycler_serve_queue_depth"]
    assert depth["replicas"] == {"a": 2.0, "b": 5.0}
    assert depth["sum"] == 7.0 and depth["min"] == 2.0 and depth["max"] == 5.0


def test_merge_hist_mismatched_edges_skipped():
    big, small = MetricsRegistry(), MetricsRegistry()
    for _ in range(10):
        big.observe("autocycler_x_seconds", 1.0, buckets=SECONDS_BUCKETS,
                    help="h")
    small.observe("autocycler_x_seconds", 1.0, buckets=DEFAULT_BUCKETS,
                  help="h")
    entries = [big.snapshot()["autocycler_x_seconds"]["values"][0],
               small.snapshot()["autocycler_x_seconds"]["values"][0]]
    merged = federate.merge_hist_entries(entries)
    assert merged == jax_fed.merge_hist_entries(entries)
    assert merged["count"] == 10
    assert merged["replicas"] == 1 and merged["skipped"] == 1
    assert federate.merge_hist_entries([]) is None


def _health(queue, busy, workers, burn=None, version="0.1.0", jobs=None):
    return {"status": "ok", "queue_depth": queue, "busy_workers": busy,
            "workers": workers, "version": version, "jobs": jobs or {},
            "slo": {"burn_rate": burn}}


def test_build_summary_equals_the_jax_packages():
    now = time.time()
    blocks = {
        "r0": {"healthy": True, "health": _health(1, 2, 2, burn=0.4,
                                                  jobs={"done": 3})},
        "r1": {"healthy": False, "stale": True, "scraped_epoch": now,
               "health": _health(4, 1, 2, burn=1.5, version="0.2.0",
                                 jobs={"done": 1, "failed": 1})},
        "r2": {"healthy": False, "stale": True, "health": None},
    }
    summary = federate.build_summary(blocks)
    assert summary == jax_fed.build_summary(blocks)
    assert (summary["healthy"], summary["stale"], summary["down"]) == \
        (1, 1, 1)
    assert summary["utilization"] == 0.75 and summary["burn_rate"] == 1.5
    assert summary["version_skew"] is True
    assert summary["jobs"] == {"done": 4, "failed": 1}


# ---------------------------------------------------------------- registry


def test_read_serve_and_fleet_status_never_raise(tmp_path):
    for path in (tmp_path / "missing.json", tmp_path / "torn.json",
                 tmp_path / "list.json"):
        if path.name == "torn.json":
            path.write_text('{"endpoint": "http://127.0.0.1:1')
        elif path.name == "list.json":
            path.write_text('["not", "an", "object"]')
        assert federate.read_serve_info(path) == {}
        assert federate.read_fleet_status(path) == {}
    assert federate.read_fleet_status(None) == {}
    out = federate.write_fleet_status(tmp_path / "f" / "fleet_status.json",
                                      {"schema": 1})
    assert json.loads(out.read_text()) == {"schema": 1}
    assert not [p for p in out.parent.iterdir() if ".tmp" in p.name]


def test_scraper_dead_replica_never_raises(tmp_path, monkeypatch):
    """A dead endpoint costs one timeout and a down mark, never an
    exception, and its last-known health carries forward (stale) within
    AUTOCYCLER_FED_STALE_S."""
    monkeypatch.setenv("AUTOCYCLER_FED_TIMEOUT_S", "0.2")
    dead = "http://127.0.0.1:9"     # the discard port: nothing listens
    assert "error" in federate.scrape_replica(dead)
    (tmp_path / "r0").mkdir()
    (tmp_path / "r0" / "serve.json").write_text(
        json.dumps({"endpoint": dead}))
    out = tmp_path / "fleet_status.json"
    out.write_text(json.dumps({
        "replicas": {"r0": {"scraped_epoch": time.time(),
                            "health": {"status": "ok", "workers": 2}}}}))
    snap = federate.FleetScraper(fleet_dir=tmp_path, out_path=out).poll()
    block = snap["replicas"]["r0"]
    assert block["healthy"] is False and block["stale"] is True
    assert block["health"]["workers"] == 2      # carried forward
    assert snap["summary"]["stale"] == 1 and snap["summary"]["down"] == 0
    monkeypatch.setenv("AUTOCYCLER_FED_STALE_S", "0")
    snap = federate.FleetScraper(fleet_dir=tmp_path, out_path=out).poll()
    assert snap["replicas"]["r0"]["health"] is None
    assert snap["summary"]["down"] == 1
    assert json.loads(out.read_text())["summary"]["down"] == 1


# ---------------------------------------------------------------- verdicts


def _summary(burn=None, util=0.0, queue=0, healthy=2):
    return {"healthy": healthy, "burn_rate": burn, "utilization": util,
            "queue_depth": queue, "queue_per_replica": queue / max(1, healthy)}


def _engines(state=None):
    return (federate.ScaleVerdictEngine(state=state),
            jax_fed.ScaleVerdictEngine(state=state))


def _evaluate(engines, summary, now=None):
    got, want = (e.evaluate(summary, now=now) for e in engines)
    if now is None:
        for v in (got, want):
            v.pop("since_epoch")
            v.pop("last_flip_epoch")
    assert got == want
    return got


def test_scale_knobs_are_the_jax_packages(monkeypatch):
    assert federate.scale_knobs() == jax_fed.scale_knobs()
    assert federate.fed_stale_s() == jax_fed.fed_stale_s() == 30.0
    monkeypatch.setenv("AUTOCYCLER_SCALE_HYSTERESIS", "0")
    monkeypatch.setenv("AUTOCYCLER_SCALE_COOLDOWN_S", "-5")
    assert federate.scale_knobs() == jax_fed.scale_knobs()
    assert federate.scale_knobs()["hysteresis"] == 1


def test_verdict_hysteresis_and_flip(monkeypatch):
    monkeypatch.setenv("AUTOCYCLER_SCALE_HYSTERESIS", "2")
    monkeypatch.setenv("AUTOCYCLER_SCALE_COOLDOWN_S", "0")
    eng = _engines()
    # one hot poll is not enough (hysteresis 2) ...
    assert _evaluate(eng, _summary())["verdict"] == "steady"
    v = _evaluate(eng, _summary(burn=2.0))
    assert v["verdict"] == "steady" and v["desired"] == "scale_out"
    assert v["streak"] == 1 and "burn 2 > 1" in v["reasons"][0]
    # ... two agreeing polls flip
    assert _evaluate(eng, _summary(burn=2.0))["verdict"] == "scale_out"
    # and the way back down needs two calm polls too
    assert _evaluate(eng, _summary())["verdict"] == "scale_out"
    assert _evaluate(eng, _summary())["verdict"] == "steady"


def test_verdict_cooldown_blocks_flip(monkeypatch):
    monkeypatch.setenv("AUTOCYCLER_SCALE_HYSTERESIS", "1")
    monkeypatch.setenv("AUTOCYCLER_SCALE_COOLDOWN_S", "3600")
    eng = _engines()
    assert _evaluate(eng, _summary(burn=2.0), now=1000.0)[
        "verdict"] == "scale_out"
    # desired flips back at once, but the cooldown holds the verdict
    v = _evaluate(eng, _summary(), now=1001.0)
    assert v["verdict"] == "scale_out" and v["desired"] == "steady"
    assert v["cooldown_remaining_s"] > 0
    # once the cooldown has passed the queued flip lands
    assert _evaluate(eng, _summary(), now=1000.0 + 3601)[
        "verdict"] == "steady"


def test_verdict_scale_in_and_state_roundtrip(monkeypatch):
    monkeypatch.setenv("AUTOCYCLER_SCALE_HYSTERESIS", "1")
    monkeypatch.setenv("AUTOCYCLER_SCALE_COOLDOWN_S", "0")
    monkeypatch.setenv("AUTOCYCLER_SCALE_IN_UTIL", "0.5")
    assert _evaluate(_engines(), _summary(util=0.1))["verdict"] == "scale_in"
    # a single-replica fleet never proposes scale_in
    assert _evaluate(_engines(), _summary(util=0.1, healthy=1))[
        "verdict"] == "steady"
    # the default in_util 0.0 turns scale_in off
    monkeypatch.delenv("AUTOCYCLER_SCALE_IN_UTIL")
    assert _evaluate(_engines(), _summary(util=0.0))["verdict"] == "steady"
    # the state round-trips through the persisted verdict block: a fresh
    # engine resumes mid-streak
    monkeypatch.setenv("AUTOCYCLER_SCALE_HYSTERESIS", "2")
    state = federate.ScaleVerdictEngine().evaluate(_summary(burn=2.0),
                                                   now=50.0)
    assert _evaluate(_engines(state=state), _summary(burn=2.0), now=51.0)[
        "verdict"] == "scale_out"


# ---------------------------------------------------------------- live fleet


@pytest.fixture
def fleet(tmp_path):
    """Two port daemons on the CPU under one fleet dir."""
    from autocycler_tpu_torch.serve.server import ServeHandle
    fleet_dir = tmp_path / "fleet"
    handles = []
    try:
        for i in range(2):
            handles.append(ServeHandle(fleet_dir / f"r{i}", port=0,
                                       device="cpu").start())
        yield fleet_dir, handles
    finally:
        for handle in handles:
            handle.stop()


def test_fleet_scrape_merge_and_build_info(fleet, monkeypatch):
    fleet_dir, handles = fleet
    monkeypatch.setenv("AUTOCYCLER_SCALE_COOLDOWN_S", "0")
    snap = federate.FleetScraper(fleet_dir=fleet_dir).poll()
    assert sorted(snap["replicas"]) == ["r0", "r1"]
    assert snap["summary"]["healthy"] == 2 and snap["summary"]["down"] == 0
    assert snap["summary"]["workers"] == sum(
        h.scheduler.workers for h in handles)
    assert snap["summary"]["version_skew"] is False
    info = snap["metrics"]["info"]
    key = next(k for k in info if k.startswith("autocycler_build_info"))
    assert sorted(info[key]) == ["r0", "r1"]
    on_disk = json.loads((fleet_dir / federate.FLEET_STATUS_JSON).read_text())
    assert on_disk["summary"]["replicas"] == 2
    assert on_disk["verdict"]["verdict"] in federate.VERDICTS
    # the JAX package's merge and summary of what the scrape saw
    assert jax_fed.build_summary(on_disk["replicas"]) == on_disk["summary"]
    from autocycler_tpu_torch.obs import metrics_registry
    reg = metrics_registry.registry()
    assert reg.value(federate.REPLICAS_GAUGE, state="healthy") == 2
    assert reg.value(federate.SCRAPES_TOTAL, replica="r0",
                     outcome="ok") >= 1


def test_top_fleet_frame(fleet, monkeypatch):
    fleet_dir, handles = fleet
    monkeypatch.setenv("AUTOCYCLER_SCALE_COOLDOWN_S", "0")
    frame = top.render_fleet_frame(fleet_dir)
    assert frame is not None
    assert "2 healthy" in frame
    assert "r0" in frame and "r1" in frame
    assert "Verdict      STEADY" in frame
    # the JAX package's renderer of the snapshot the port's poll wrote
    # renders the same frame once both have polled
    got, want = _both(fleet_dir, fleet=True)
    got = re.sub(r"\[pending [^\]]+\]", "", got)
    want = re.sub(r"\[pending [^\]]+\]", "", want)
    assert got == want
    # an empty dir renders nothing (top --fleet exits 1)
    assert top.render_fleet_frame(fleet_dir / "r0" / "jobs") is None
