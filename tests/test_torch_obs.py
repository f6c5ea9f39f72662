"""The port's run record (autocycler_tpu_torch/obs) against the JAX
package's: the unit cases of tests/test_obs.py and tests/test_qc_ledger.py
on the port's tracer, registry, memory sample, QC journal and ledger; then
both CLIs over compress → cluster → trim → resolve → combine, each command
with its own AUTOCYCLER_TRACE_DIR: the same QC numbers, the same input and
stage sha256s, the same AUTOCYCLER_* knobs in the ledger, the same stage
span names; the stream-spill stage on a forced plan; and nothing written
without a trace dir."""

import contextlib
import gc
import hashlib
import io
import json
import re
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from autocycler_tpu import cli as jax_cli
from autocycler_tpu_torch import cli, device
from autocycler_tpu_torch.commands import cluster as cluster_mod
from autocycler_tpu_torch.commands import compress as compress_mod
from autocycler_tpu_torch.commands import resolve as resolve_mod
from autocycler_tpu_torch.commands import trim as trim_mod
from autocycler_tpu_torch.obs import ledger, memory, metrics_registry, qc, trace
from autocycler_tpu_torch.obs.metrics_registry import MetricsRegistry
from autocycler_tpu_torch.utils import pool, timing

from synthetic import make_assemblies

RUN_FILES = ["ledger.json", "metrics.json", "metrics.prom", "qc_report.json",
             "trace.chrome.json", "trace.jsonl"]
# substages the port times that the JAX package does not: its grouping
# kernels' own steps, the write of compress's files and combine's work
PORT_ONLY_SUBSTAGES = {"k-mer grouping", "gram grouping", "write", "combine",
                       # the port's spans below the JAX package's stages,
                       # and the run record's own cost
                       "encode", "kmer-index", "chain-emit", "chain-seqs",
                       "graph-index", "simplify-fixed", "simplify-expand",
                       "simplify-renumber", "compress-qc", "ledger",
                       "cluster-read", "cluster-parse", "cluster-paths",
                       "cluster-distance-product", "cluster-save-matrix",
                       "cluster-upgma", "cluster-newick", "cluster-generate",
                       "cluster-subset", "cluster-save-gfa",
                       "cluster-save-tsv", "cluster-qc", "trim-load",
                       "trim-paths", "trim-signed-paths", "trim-overlap-jobs",
                       "trim-overlap-screen", "trim-overlap-align",
                       "trim-start-end", "trim-hairpin", "trim-choose-type",
                       "trim-exclude-outliers", "trim-clean-up", "trim-save",
                       "trim-qc", "resolve-load", "resolve-anchors",
                       "resolve-bridges", "bridge-paths", "medoid-distances",
                       "bridge-build", "resolve-ambiguity",
                       "resolve-apply", "resolve-save", "resolve-merge",
                       "resolve-cull", "resolve-reload", "resolve-qc"}


@pytest.fixture(autouse=True)
def _clean_obs(monkeypatch):
    for name in ("AUTOCYCLER_TRACE_DIR", "AUTOCYCLER_METRICS",
                 "AUTOCYCLER_STREAM_KMERS"):
        monkeypatch.delenv(name, raising=False)
    trace.abort_run()
    qc.reset()
    ledger.reset()
    yield
    trace.abort_run()
    qc.reset()
    ledger.reset()


def _load_jsonl(path):
    return [json.loads(line) for line in
            Path(path).read_text().splitlines() if line.strip()]


def _sha256(path) -> str:
    return hashlib.sha256(Path(path).read_bytes()).hexdigest()


# ---------------- tracer ----------------

def test_noop_span_is_shared_singleton_with_no_io(tmp_path):
    assert not trace.tracing_active()
    spans = [trace.span(f"s{i}", cat="stage", k=i) for i in range(100)]
    assert all(s is trace.NOOP_SPAN for s in spans)
    with trace.span("anything") as s:
        assert s is None
    assert list(tmp_path.iterdir()) == []


def test_nested_spans_record_parent_child_chain(tmp_path):
    trace.start_run(tmp_path, name="nesting")
    with trace.span("outer", cat="stage"):
        with trace.span("mid", cat="substage"):
            with trace.span("inner", cat="device"):
                pass
        with trace.span("sibling", cat="substage"):
            pass
    assert trace.finish_run() == tmp_path
    records = _load_jsonl(tmp_path / trace.TRACE_JSONL)
    assert records[0]["type"] == "run" and records[0]["name"] == "nesting"
    assert records[-1]["type"] == "finish"
    spans = {r["name"]: r for r in records if r["type"] == "span"}
    outer, mid = spans["outer"], spans["mid"]
    assert outer["parent"] is None and mid["parent"] == outer["id"]
    assert spans["inner"]["parent"] == mid["id"]
    assert spans["sibling"]["parent"] == outer["id"]
    assert mid["ts"] + mid["dur"] <= outer["ts"] + outer["dur"] + 1e-6
    assert "mem" in outer and outer["mem"]["peak_rss_bytes"] > 0
    assert "mem" not in mid


def test_span_records_error_and_attrs(tmp_path):
    trace.start_run(tmp_path, name="err")
    with pytest.raises(ValueError):
        with trace.span("boom", cat="stage", path="x.gfa"):
            raise ValueError("nope")
    trace.finish_run()
    rec = [r for r in _load_jsonl(tmp_path / trace.TRACE_JSONL)
           if r["type"] == "span"][0]
    assert rec["error"] == "ValueError" and rec["attrs"] == {"path": "x.gfa"}


def test_spans_are_thread_safe_under_the_shared_pool(tmp_path):
    trace.start_run(tmp_path, name="pool")

    def work(i):
        with trace.span(f"task{i}", cat="substage"):
            with trace.span(f"task{i}/inner", cat="device"):
                return i * i

    assert pool.pool_map(work, range(64), workers=8) == \
        [i * i for i in range(64)]
    trace.finish_run()
    spans = [r for r in _load_jsonl(tmp_path / trace.TRACE_JSONL)
             if r["type"] == "span"]
    assert len({s["id"] for s in spans}) == len(spans) == 128
    by_name = {s["name"]: s for s in spans}
    for i in range(64):
        inner, outer = by_name[f"task{i}/inner"], by_name[f"task{i}"]
        assert inner["parent"] == outer["id"] and outer["parent"] is None
        assert inner["tid"] == outer["tid"]


def test_chrome_trace_schema(tmp_path):
    trace.start_run(tmp_path, name="chrome")
    with trace.span("stage_a", cat="stage", foo="bar"):
        with trace.span("sub_b", cat="substage"):
            pass
    trace.finish_run()
    data = json.loads((tmp_path / trace.TRACE_CHROME).read_text())
    assert data["displayTimeUnit"] == "ms"
    meta, rest = data["traceEvents"][0], data["traceEvents"][1:]
    assert meta["ph"] == "M" and "autocycler chrome" in meta["args"]["name"]
    assert {e["name"] for e in rest} == {"stage_a", "sub_b"}
    assert all(e["ph"] == "X" and e["ts"] >= 0 and e["dur"] >= 0
               for e in rest)
    a = next(e for e in rest if e["name"] == "stage_a")
    assert a["args"]["foo"] == "bar" and "mem" in a["args"]


def test_in_memory_run_writes_nothing_and_hashes_nothing(tmp_path,
                                                         monkeypatch):
    """A run opened with no directory keeps its spans in memory: no file
    appears, the ledger hashes nothing, and closing returns the spans on
    the absolute clock."""
    monkeypatch.chdir(tmp_path)
    ledger.reset()
    fasta = tmp_path / "a.fasta"
    fasta.write_text(">a\nACGT\n")
    before = sorted(tmp_path.rglob("*"))
    run = trace.open_run(None, name="memory")
    assert trace.tracing_active() and trace.trace_dir() is None
    with trace.span("outer", cat="stage"):
        with timing.substage("inner"):
            ledger.record_inputs([fasta])
            assert ledger.record_stage("s", inputs=[fasta],
                                       outputs=[fasta]) is None
    spans = trace.close_run(run)
    assert not trace.tracing_active() and trace.close_run(run) is None
    assert sorted(tmp_path.rglob("*")) == before
    built = ledger.build_ledger()
    assert built["inputs"] == {} and built["stages"] == []
    inner, outer = spans
    assert (inner["name"], outer["name"]) == ("inner", "outer")
    assert inner["parent"] == outer["id"] and "mem" not in outer
    assert outer["t0_ns"] <= inner["t0_ns"] <= inner["t1_ns"] \
        <= outer["t1_ns"]


def test_directory_run_adds_the_absolute_clock(tmp_path):
    """A run with a directory writes its files as before, each span with
    ``t0_ns``/``t1_ns`` beside ``ts``/``dur`` (in trace.jsonl and among the
    Chrome event's args), and times the ledger's hashing as a substage."""
    ledger.reset()
    fasta = tmp_path / "a.fasta"
    fasta.write_text(">a\nACGT\n")
    t_before = time.time_ns()
    trace.start_run(tmp_path / "run", name="clock")
    with trace.span("outer", cat="stage"):
        ledger.record_inputs([fasta])
    trace.finish_run()
    t_after = time.time_ns()
    ledger.write_ledger(tmp_path / "run")
    assert sorted(p.name for p in (tmp_path / "run").iterdir()) == [
        "ledger.json", "metrics.json", "metrics.prom", "trace.chrome.json",
        "trace.jsonl"]
    records = _load_jsonl(tmp_path / "run" / trace.TRACE_JSONL)
    header = records[0]
    spans = {r["name"]: r for r in records if r["type"] == "span"}
    assert set(spans) == {"outer", "ledger"}
    for s in spans.values():
        assert t_before <= header["t0_ns"] <= s["t0_ns"] <= s["t1_ns"] \
            <= t_after
        assert abs(s["t0_ns"] - header["t0_ns"] - s["ts"] * 1e9) <= 1e3
        assert abs(s["t1_ns"] - s["t0_ns"] - s["dur"] * 1e9) <= 1e3
    assert spans["ledger"]["parent"] == spans["outer"]["id"]
    chrome = json.loads((tmp_path / "run" / trace.TRACE_CHROME).read_text())
    outer = next(e for e in chrome["traceEvents"] if e["name"] == "outer")
    assert (outer["args"]["t0_ns"], outer["args"]["t1_ns"]) == \
        (spans["outer"]["t0_ns"], spans["outer"]["t1_ns"])
    got = json.loads((tmp_path / "run" / ledger.LEDGER_JSON).read_text())
    assert got["inputs"][str(fasta)]["sha256"] == _sha256(fasta)


def test_span_clock_is_the_profilers():
    """A torch op run inside a program span lies, on the profiler's own
    clock, inside the span's [t0_ns, t1_ns]."""
    x = torch.randn(256, 256)
    run = trace.open_run(None, name="clock")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with trace.span("mm", cat="device"):
            torch.mm(x, x)
    (span,) = trace.close_run(run)
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name() == "aten::mm"]
    assert events
    for e in events:
        assert span["t0_ns"] <= e.start_ns() \
            <= e.start_ns() + e.duration_ns() <= span["t1_ns"]


def test_to_host_counts_bytes_and_copies_by_site():
    _reset_registries()
    a = torch.arange(10, dtype=torch.int32)
    out = device.to_host(a, "site-a", np.int64)
    assert out.dtype == np.int64 and out.tolist() == list(range(10))
    assert device.to_host(torch.zeros(3, 4, dtype=torch.float64),
                          "site-b").shape == (3, 4)
    assert device.to_host(a, "site-a").dtype == np.int32
    reg = metrics_registry.registry()
    assert reg.labeled(device.TO_HOST_BYTES, "site") == {"site-a": 80.0,
                                                         "site-b": 96.0}
    assert reg.labeled(device.TO_HOST_COPIES, "site") == {"site-a": 2.0,
                                                          "site-b": 1.0}
    assert device.to_host_bytes() == 176.0


def test_second_start_is_an_error_and_maybe_start_owns_one(tmp_path,
                                                          monkeypatch):
    assert trace.maybe_start_run() is False            # no trace dir set
    monkeypatch.setenv("AUTOCYCLER_TRACE_DIR", str(tmp_path / "r"))
    assert trace.maybe_start_run("x") is True
    assert trace.maybe_start_run("y") is False         # one run at a time
    with pytest.raises(RuntimeError, match="already active"):
        trace.start_run(tmp_path / "other")
    assert trace.finish_run() == tmp_path / "r"
    assert trace.finish_run() is None


def test_stage_substage_and_device_spans(tmp_path):
    """stage_timer, substage and dp_dispatch open stage, substage and
    device spans, and the stage span agrees with stage_seconds()."""
    timing.reset()
    trace.start_run(tmp_path, name="cats")
    # inside a command span, as the CLI runs stages: a top-level span's
    # memory sample is taken inside it, and so inside a stage's timer
    with trace.span("compress", cat="command"):
        with timing.stage_timer("compress/build_graph"):
            with timing.substage("k-mer grouping"):
                with device.dp_dispatch("trim_overlap_dp",
                                        torch.device("cpu"), jobs=1):
                    pass
    trace.finish_run()
    spans = {r["name"]: r for r in _load_jsonl(tmp_path / trace.TRACE_JSONL)
             if r["type"] == "span"}
    assert spans["compress/build_graph"]["cat"] == "stage"
    assert spans["k-mer grouping"]["cat"] == "substage"
    assert spans["trim_overlap_dp"]["cat"] == "device"
    assert spans["trim_overlap_dp"]["parent"] == spans["k-mer grouping"]["id"]
    # the span runs inside the timer, which adds only the span's own
    # bookkeeping (a scheduler's preemption under load included)
    secs = timing.stage_seconds()["compress/build_graph"]
    assert -1e-6 <= secs - spans["compress/build_graph"]["dur"] <= 0.01
    device.reset_counts()


def test_write_metrics_file(tmp_path):
    timing.reset()
    with timing.stage_timer("x"):
        pass
    trace.write_metrics_file(tmp_path / "m" / "metrics.prom")
    text = (tmp_path / "m" / "metrics.prom").read_text()
    assert 'autocycler_stage_seconds_total{stage="x"}' in text


# ---------------- metrics registry ----------------

def test_prometheus_text_format():
    reg = MetricsRegistry()
    reg.counter_inc("demo_total", 2, help="a demo counter", kind="x")
    reg.counter_inc("demo_total", 3, kind="x")
    reg.gauge_set("demo_gauge", 1.5)
    reg.observe("demo_seconds", 0.004, buckets=(0.001, 0.01, 1.0))
    reg.observe("demo_seconds", 5.0, buckets=(0.001, 0.01, 1.0))
    text = reg.to_prometheus()
    lines = text.splitlines()
    for want in ("# HELP demo_total a demo counter", "# TYPE demo_total counter",
                 'demo_total{kind="x"} 5.0', "demo_gauge 1.5",
                 'demo_seconds_bucket{le="0.001"} 0',
                 'demo_seconds_bucket{le="0.01"} 1',
                 'demo_seconds_bucket{le="+Inf"} 2',
                 "demo_seconds_sum 5.004", "demo_seconds_count 2"):
        assert want in lines, want
    sample = re.compile(r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^{}]*\})? \S+$')
    assert all(sample.match(line) for line in lines if not line.startswith("#"))


def test_registry_snapshot_views_and_reset():
    reg = MetricsRegistry()
    reg.counter_inc("c_total", 1, stage="a")
    reg.counter_inc("c_total", 2, stage="b")
    json.dumps(reg.snapshot())
    assert reg.labeled("c_total", "stage") == {"a": 1.0, "b": 2.0}
    assert reg.value("c_total", stage="b") == 2.0
    assert reg.value("missing") == 0.0
    with pytest.raises(ValueError):
        reg.counter_inc("c_total", -1, stage="a")
    with pytest.raises(ValueError):
        reg.gauge_set("c_total", 1.0)
    reg.reset()
    assert reg.snapshot() == {}


def test_registry_thread_safety():
    reg = MetricsRegistry()

    def hammer():
        for _ in range(1000):
            reg.counter_inc("hits_total", 1, who="t")
            reg.observe("lat_seconds", 0.01)

    threads = [threading.Thread(target=hammer) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert reg.value("hits_total", who="t") == 8000
    assert reg.snapshot()["lat_seconds"]["values"][0]["count"] == 8000


def test_timing_keeps_its_names_on_the_registry():
    timing.reset()
    with timing.stage_timer("s"), timing.substage("a"):
        pass
    assert set(timing.stage_seconds()) == {"s"}
    assert set(timing.substage_snapshot()) == {"a"}
    snap = metrics_registry.snapshot()
    assert {timing.STAGE_SECONDS, timing.STAGE_LATENCY_HIST,
            timing.SUBSTAGE_SECONDS} <= set(snap)
    timing.reset()
    assert timing.stage_seconds() == {} == timing.substage_snapshot()


# ---------------- memory ----------------

def test_memory_sample_has_rss_and_no_device_key_before_cuda():
    sample = memory.memory_sample()
    assert sample["peak_rss_bytes"] > 0 and sample["rss_bytes"] > 0
    assert "device_bytes_in_use" not in sample       # CUDA never came up
    from autocycler_tpu.obs.memory import memory_sample as jax_sample
    assert set(sample) <= set(jax_sample()) | {"device_bytes_in_use"}


def test_memory_sample_reads_cuda_only_when_initialised(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    monkeypatch.setattr(torch.cuda, "memory_allocated",
                        lambda d=None: calls.append(d) or 0)
    assert memory.cuda_memory_sample() == {} and calls == []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "memory_allocated",
                        lambda d=None: {0: 100, 1: 23}[d])
    assert memory.cuda_memory_sample() == {"device_bytes_in_use": 123}


# ---------------- qc ----------------

def test_n50_definition():
    assert qc.n50([]) == 0
    assert qc.n50([100]) == 100
    assert qc.n50([40, 100, 60]) == 100
    assert qc.n50([50, 50, 50, 50]) == 50


def test_record_journals_registers_and_scopes():
    qc.record("compress", unitigs=5, total_bp=1000, note="x", hist={"a": 1})
    assert qc.entries()[-1]["metrics"]["unitigs"] == 5
    snap = metrics_registry.snapshot()
    assert "autocycler_qc_compress_unitigs" in snap
    assert "autocycler_qc_compress_note" not in snap
    assert "autocycler_qc_compress_hist" not in snap
    with qc.scope("isolate_A"):
        assert qc.current_scope() == "isolate_A"
        qc.record("compress", unitigs=7)
    assert qc.current_scope() is None
    assert qc.entries()[-1]["isolate"] == "isolate_A"


def test_summary_sums_numerics_and_groups_isolates():
    qc.record("trim", cluster="cluster_001", trimmed_bp=10, contigs=4)
    qc.record("trim", cluster="cluster_002", trimmed_bp=5, contigs=4)
    with qc.scope("iso1"):
        qc.record("compress", unitigs=3)
    s = qc.summary()
    assert s["trim"] == {"entries": 2, "trimmed_bp": 15, "contigs": 8}
    assert s["isolates"]["iso1"]["compress"]["unitigs"] == 3


def test_write_qc_report_atomic_and_empty(tmp_path):
    assert qc.write_qc_report(tmp_path) is None
    qc.record("combine", consensus_bp=123)
    path = qc.write_qc_report(tmp_path)
    data = json.loads(path.read_text())
    assert data["schema"] == 1
    assert data["summary"]["combine"]["consensus_bp"] == 123
    assert not list(tmp_path.glob("*.tmp*"))


def test_qc_rides_the_innermost_span(tmp_path):
    trace.start_run(tmp_path, name="qc")
    with trace.span("resolve", cat="command"):
        qc.record("resolve", cluster="cluster_001", anchors=3)
    trace.finish_run()
    rec = [r for r in _load_jsonl(tmp_path / trace.TRACE_JSONL)
           if r["type"] == "span"][0]
    assert rec["attrs"]["qc"] == {"resolve/cluster_001": {"anchors": 3}}


# ---------------- ledger ----------------

def test_ledger_noop_without_active_run(tmp_path):
    f = tmp_path / "in.fasta"
    f.write_text(">x\nACGT\n")
    ledger.record_inputs([f])
    ledger.record_stage("compress", outputs=[f])
    assert ledger.write_ledger(tmp_path) is None
    assert not (tmp_path / ledger.LEDGER_JSON).exists()


def test_ledger_hashes_inputs_stages_versions_env_and_caches(tmp_path,
                                                             monkeypatch):
    f = tmp_path / "in.fasta"
    f.write_text(">x\nACGT\n")
    out = tmp_path / "out.gfa"
    out.write_text("H\tVN:Z:1.0\n")
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0")
    monkeypatch.setenv("AUTOCYCLER_SERVE_TOKEN", "secret")
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    trace.start_run(tmp_path / "run", name="t")
    ledger.record_inputs([f, tmp_path / "missing.fasta"])
    ledger.record_stage("compress", inputs=[f], outputs=[out], extra_flag=True)
    built = ledger.build_ledger(command="compress")
    trace.abort_run()
    assert built["inputs"][str(f)]["sha256"] == _sha256(f)
    assert str(tmp_path / "missing.fasta") not in built["inputs"]
    stage = built["stages"][0]
    assert stage["outputs"][str(out)]["sha256"] == _sha256(out)
    assert stage["extra"] == {"extra_flag": True}
    assert built["command"] == "compress"
    versions = built["versions"]
    assert versions["autocycler_tpu_torch"] and "python" in versions
    assert "cuda" in versions and "torch" in versions["packages"]
    assert not any("jax" in name for name in versions["packages"])
    assert built["env"]["CUDA_VISIBLE_DEVICES"] == "0"
    assert built["env"]["AUTOCYCLER_SERVE_TOKEN"] == "<redacted>"
    assert "JAX_PLATFORMS" not in built["env"]
    assert set(built["caches"]) == {"parse", "repair", "compile", "probe"}
    assert {"recoveries", "overlap"} <= set(built["caches"]["probe"])
    assert built["caches"]["compile"]["dir"].endswith(
        "autocycler_tpu_torch/_build")


# ---------------- the CLI's run lifecycle ----------------

def test_gc_disabled_commands_are_the_jax_packages():
    assert cli.GC_DISABLED_COMMANDS == jax_cli.GC_DISABLED_COMMANDS


def _on_cpu(monkeypatch):
    for module in (compress_mod, cluster_mod, trim_mod, resolve_mod):
        monkeypatch.setattr(module, "resolve_device",
                            lambda dev=None: torch.device("cpu"))


def _cli(main, monkeypatch, run_dir, argv):
    """One CLI command with its own trace dir (None: no trace dir)."""
    if run_dir is None:
        monkeypatch.delenv("AUTOCYCLER_TRACE_DIR", raising=False)
    else:
        monkeypatch.setenv("AUTOCYCLER_TRACE_DIR", str(run_dir))
    try:
        with contextlib.redirect_stderr(io.StringIO()) as err:
            rc = main([str(a) for a in argv])
    finally:
        gc.enable()
    assert rc == 0, err.getvalue()[-2000:]
    return run_dir


def _pipeline(main, monkeypatch, asm, out, runs):
    """compress → cluster → trim → resolve → combine, one run dir each;
    returns {command label: run dir}."""
    done = {"compress": _cli(main, monkeypatch, runs and runs / "compress",
                             ["compress", "-i", asm, "-a", out, "-t", "2"])}
    done["cluster"] = _cli(main, monkeypatch, runs and runs / "cluster",
                           ["cluster", "-a", out])
    clusters = sorted((out / "clustering/qc_pass").iterdir())
    for c in clusters:
        for command in ("trim", "resolve"):
            label = f"{command}_{c.name}"
            done[label] = _cli(main, monkeypatch, runs and runs / label,
                               [command, "-c", c])
    done["combine"] = _cli(main, monkeypatch, runs and runs / "combine",
                           ["combine", "-a", out, "-i",
                            *[c / "5_final.gfa" for c in clusters]])
    return done


def _qc_entries(run_dir):
    return [{k: v for k, v in e.items() if k != "ts_epoch"} for e in
            json.loads((run_dir / qc.QC_REPORT_JSON).read_text())["entries"]]


def _relative_hashes(table, root):
    """{path relative to root: sha256} of a ledger's input/output table."""
    return {str(Path(p).relative_to(root)): d["sha256"]
            for p, d in table.items()}


def _span_names(run_dir):
    names = {}
    for r in _load_jsonl(run_dir / trace.TRACE_JSONL):
        if r["type"] == "span":
            names.setdefault(r["cat"], set()).add(r["name"])
    return names


@pytest.fixture(scope="module")
def traced_pipelines(tmp_path_factory):
    """Both packages' CLIs over the same assemblies, a trace dir a command."""
    tmp = tmp_path_factory.mktemp("traced")
    asm = make_assemblies(tmp, n_assemblies=3, chromosome_len=3000,
                          plasmid_len=600, seed=7)
    mp = pytest.MonkeyPatch()
    try:
        _on_cpu(mp)
        runs = {name: _pipeline(main, mp, asm, tmp / name, tmp / f"runs_{name}")
                for name, main in (("jax", jax_cli.main), ("port", cli.main))}
    finally:
        mp.undo()
    return asm, tmp, runs


def test_every_command_writes_its_run_record(traced_pipelines):
    _, _, runs = traced_pipelines
    assert len(runs["port"]) == 7 and set(runs["port"]) == set(runs["jax"])
    for run_dir in runs["port"].values():
        # the sampler's series is there too when the command outlasted one
        # tick (AUTOCYCLER_TIMESERIES_INTERVAL_S), as in the JAX package
        names = sorted(p.name for p in run_dir.iterdir())
        assert [n for n in names if n != "timeseries.jsonl"] == RUN_FILES
        if "timeseries.jsonl" in names:
            assert _load_jsonl(run_dir / "timeseries.jsonl")[0]["tick"] == 1
        records = _load_jsonl(run_dir / trace.TRACE_JSONL)
        assert records[0]["type"] == "run" and records[-1]["type"] == "finish"
        json.loads((run_dir / "metrics.json").read_text())


def test_qc_reports_equal_the_jax_packages(traced_pipelines):
    _, _, runs = traced_pipelines
    for label, run_dir in runs["port"].items():
        assert _qc_entries(run_dir) == _qc_entries(runs["jax"][label]), label


def test_ledger_hashes_equal_the_jax_packages(traced_pipelines):
    asm, tmp, runs = traced_pipelines
    for label, run_dir in runs["port"].items():
        got = json.loads((run_dir / ledger.LEDGER_JSON).read_text())
        want = json.loads((runs["jax"][label] / ledger.LEDGER_JSON).read_text())
        assert got["inputs"] == want["inputs"], label
        assert [s["stage"] for s in got["stages"]] == \
            [s["stage"] for s in want["stages"]], label
        for g, w in zip(got["stages"], want["stages"]):
            for side in ("inputs", "outputs"):
                assert _relative_hashes(g[side], tmp / "port") == \
                    _relative_hashes(w[side], tmp / "jax"), (label, side)
            assert g.get("cluster") == w.get("cluster")
            assert g.get("extra") == w.get("extra"), label
        assert {k for k in got["env"] if k.startswith("AUTOCYCLER_")} == \
            {k for k in want["env"] if k.startswith("AUTOCYCLER_")}
        assert got["command"] == want["command"]
    compress_ledger = json.loads(
        (runs["port"]["compress"] / ledger.LEDGER_JSON).read_text())
    fastas = sorted(asm.glob("*.fasta"))
    assert sorted(compress_ledger["inputs"]) == [str(f) for f in fastas]
    for f in fastas:
        assert compress_ledger["inputs"][str(f)]["sha256"] == _sha256(f)


def test_span_names_equal_the_jax_packages(traced_pipelines):
    _, _, runs = traced_pipelines
    for label, run_dir in runs["port"].items():
        got, want = _span_names(run_dir), _span_names(runs["jax"][label])
        assert got["command"] == want["command"] == {label.split("_")[0]}
        assert got.get("stage", set()) == want.get("stage", set()), label
        assert got.get("substage", set()) - PORT_ONLY_SUBSTAGES == \
            want.get("substage", set()), label
    assert {"load", "repair"} <= _span_names(
        runs["port"]["compress"])["substage"]


def test_trace_stage_spans_agree_with_stage_seconds(tmp_path, monkeypatch):
    asm = make_assemblies(tmp_path, n_assemblies=2, chromosome_len=3000,
                          plasmid_len=500, seed=3)
    _on_cpu(monkeypatch)
    timing.reset()
    run = _cli(cli.main, monkeypatch, tmp_path / "run",
               ["compress", "-i", asm, "-a", tmp_path / "out"])
    spans = [r for r in _load_jsonl(run / trace.TRACE_JSONL)
             if r["type"] == "span" and r["cat"] == "stage"]
    seconds = timing.stage_seconds()
    assert {s["name"] for s in spans} == set(seconds)
    for s in spans:                  # within 5 %, as chip_smoke's [warm]
        assert -1e-6 <= seconds[s["name"]] - s["dur"] <= \
            0.05 * seconds[s["name"]] + 0.01
    command = next(r for r in _load_jsonl(run / trace.TRACE_JSONL)
                   if r["type"] == "span" and r["cat"] == "command")
    assert command["parent"] is None and "peak_rss_bytes" in command["mem"]


STREAM_FAMILIES = ("autocycler_stream_spill_bytes",
                   "autocycler_stream_spill_bytes_total",
                   "autocycler_stream_rle_ratio",
                   "autocycler_stream_bins_total",
                   "autocycler_stream_quarantined_bins_total",
                   "autocycler_stream_orphans_swept_total")


def _prom_values(path, names):
    """{family: summed sample value} of ``names`` in a Prometheus dump."""
    out = {}
    for line in Path(path).read_text().splitlines():
        if line.startswith("#") or not line.strip():
            continue
        sample, _, value = line.rpartition(" ")
        family = sample.split("{", 1)[0]
        if family in names:
            out[family] = out.get(family, 0.0) + float(value)
    return out


def _reset_registries():
    from autocycler_tpu.obs import metrics_registry as jax_registry
    jax_registry.registry()._reset_for_tests()
    metrics_registry.reset()


def _plant_dead_spill(out):
    """A killed run's spill dir under ``out/.stream``: a manifest whose pid
    cannot be alive."""
    run = out / ".stream" / "run-4194303-deadbeef"
    run.mkdir(parents=True)
    (run / "manifest.json").write_text(json.dumps(
        {"version": 1, "format": 2, "pid": 2 ** 22 + 12345, "k": 51,
         "sig_k": 11, "n_bins": 5, "counts": None, "spill_bytes": 0}))


def _streamed_compresses(tmp_path, monkeypatch, asm):
    """Both CLIs' compress on a forced five-bin plan, each into an out dir
    that holds one dead spill dir, each with a trace dir and a
    Prometheus dump; returns {package: (run dir, {family: value})}."""
    _on_cpu(monkeypatch)
    monkeypatch.setenv("AUTOCYCLER_STREAM_KMERS", "on")
    monkeypatch.setenv("AUTOCYCLER_STREAM_BINS", "5")
    monkeypatch.setenv("AUTOCYCLER_STREAM_CHUNK", "1000")
    runs = {}
    for name, main in (("jax", jax_cli.main), ("port", cli.main)):
        _reset_registries()
        _plant_dead_spill(tmp_path / name)
        dump = tmp_path / f"{name}.prom"
        monkeypatch.setenv("AUTOCYCLER_METRICS", str(dump))
        run = _cli(main, monkeypatch, tmp_path / f"run_{name}",
                   ["compress", "-i", asm, "-a", tmp_path / name, "-t", "1"])
        runs[name] = (run, _prom_values(dump, STREAM_FAMILIES))
        assert not list((tmp_path / name / ".stream").iterdir())
    return runs


def test_stream_spill_stage_on_a_forced_plan(tmp_path, monkeypatch):
    asm = make_assemblies(tmp_path, n_assemblies=2, chromosome_len=3000,
                          plasmid_len=500, seed=8)
    runs = _streamed_compresses(tmp_path, monkeypatch, asm)
    stages = {}
    for name, (run, _) in runs.items():
        led = json.loads((run / ledger.LEDGER_JSON).read_text())
        stages[name] = [s for s in led["stages"]
                        if s["stage"] == "stream-spill"]
    assert len(stages["port"]) == 1
    assert stages["port"][0]["extra"] == stages["jax"][0]["extra"]
    assert stages["port"][0]["extra"]["n_bins"] == 5
    # the stream's registry families, the JAX package's values: the gauge
    # back at 0 once the run dir is gone, and the dead spill dir swept
    got, want = runs["port"][1], runs["jax"][1]
    assert got == want
    assert set(got) == set(STREAM_FAMILIES) - {
        "autocycler_stream_quarantined_bins_total"}
    assert got["autocycler_stream_spill_bytes"] == 0
    assert got["autocycler_stream_orphans_swept_total"] == 1
    assert got["autocycler_stream_bins_total"] == \
        stages["port"][0]["extra"]["bins"]
    assert got["autocycler_stream_spill_bytes_total"] == \
        stages["port"][0]["extra"]["spill_bytes"] > 0


def test_stream_quarantine_families_equal_the_jax_packages(tmp_path,
                                                          monkeypatch):
    """A bin read the fault plan corrupts is quarantined and the compress
    groups in memory, in both packages: the six families and the files
    are the same."""
    asm = make_assemblies(tmp_path, n_assemblies=2, chromosome_len=3000,
                          plasmid_len=500, seed=9)
    monkeypatch.setenv("AUTOCYCLER_FAULTS", "stream_read:bin-::1")
    from autocycler_tpu.utils import resilience as jax_rz
    from autocycler_tpu_torch.utils import resilience as rz
    rz.reset_degrades()
    jax_rz._reset_degrades_for_tests()
    runs = _streamed_compresses(tmp_path, monkeypatch, asm)
    got, want = runs["port"][1], runs["jax"][1]
    assert got == want and set(got) == set(STREAM_FAMILIES)
    assert got["autocycler_stream_quarantined_bins_total"] == 1
    assert [e["to"] for e in rz.degrade_events("stream-kmers")] == \
        ["in-memory"]
    for name in ("input_assemblies.gfa", "input_assemblies.yaml"):
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes()


# JAX dispatch sites ↔ the port's that run on the CPU in one pipeline (the
# JAX package with AUTOCYCLER_DEVICE_GROUPING=direct, so that its grouping
# goes through device_dispatch on the CPU): one to one, the same count a
# stage
DISPATCH_SITES = {"k-mer grouping sort": "sortnet_pack_rank",
                  "adjacency segment ops": "adjacency segment ops",
                  "chain pointer doubling": "chain pointer doubling"}
# the port's sites with no JAX dispatch on the CPU: there the JAX package
# takes its host product and its host DPs
PORT_ONLY_SITES = {"cluster distance matmul", "trim_overlap_dp",
                   "resolve_medoid_dp"}


def _dispatches(run_dir):
    """(dispatch total, {kernel: count over both phases}, device seconds)
    of a run's dump: the process's registry so far."""
    snap = json.loads((run_dir / "metrics.json").read_text())

    def total(name):
        return sum(v["value"] for v in
                   (snap.get(name) or {}).get("values", []))
    per_site = {}
    for v in (snap.get("autocycler_device_kernel_seconds") or {}).get(
            "values", []):
        kernel = v["labels"]["kernel"]
        per_site[kernel] = per_site.get(kernel, 0) + v["count"]
    return (total("autocycler_device_dispatches_total"), per_site,
            total("autocycler_device_seconds_total"))


def _device_line(render, run_dir):
    line = next(l for l in render(run_dir).splitlines()
                if l.startswith("Device vs host:"))
    return int(re.search(r"across (\d+) dispatch", line).group(1))


def test_device_families_and_report_line_equal_the_jax_packages(
        tmp_path, monkeypatch):
    from autocycler_tpu.obs import report as jax_report
    from autocycler_tpu_torch.obs import report
    asm = make_assemblies(tmp_path, n_assemblies=3, chromosome_len=3000,
                          plasmid_len=600, seed=5)
    _on_cpu(monkeypatch)
    runs = {}
    for name, main in (("jax", jax_cli.main), ("port", cli.main)):
        _reset_registries()
        if name == "jax":
            monkeypatch.setenv("AUTOCYCLER_DEVICE_GROUPING", "direct")
        else:
            monkeypatch.delenv("AUTOCYCLER_DEVICE_GROUPING", raising=False)
        runs[name] = _pipeline(main, monkeypatch, asm, tmp_path / name,
                               tmp_path / f"runs_{name}")
    assert list(runs["port"]) == list(runs["jax"])
    # the stages ran one after the other in this process: a stage's own
    # dispatches are its dump's less the previous stage's
    stages = {}
    for name, done in runs.items():
        prev = (0, {}, 0.0)
        for label, run_dir in done.items():
            cur = _dispatches(run_dir)
            stages[name, label] = (
                cur[0] - prev[0],
                {k: v - prev[1].get(k, 0) for k, v in cur[1].items()
                 if v - prev[1].get(k, 0)},
                cur[2] - prev[2])
            prev = cur
    for label, run_dir in runs["port"].items():
        total, sites, seconds = stages["port", label]
        jtotal, jsites, jseconds = stages["jax", label]
        # every dispatch of the stage is one of the mapped sites, with the
        # JAX package's count where the sites map one to one
        assert set(sites) <= set(DISPATCH_SITES.values()) | PORT_ONLY_SITES
        assert set(jsites) <= set(DISPATCH_SITES), label
        for jsite, site in DISPATCH_SITES.items():
            assert sites.get(site, 0) == jsites.get(jsite, 0), (label, site)
        assert total == sum(sites.values()), label
        assert (seconds > 0) == (total > 0), label
        # each report's device line reads its dump
        assert _device_line(lambda d: report.render_report(
            report.build_report(d)), run_dir) == _dispatches(run_dir)[0]
        assert _device_line(lambda d: jax_report.render_report(
            jax_report.build_report(d)), runs["jax"][label]) == \
            _dispatches(runs["jax"][label])[0]
    total, sites, seconds = stages["port", "compress"]
    jtotal, _, jseconds = stages["jax", "compress"]
    assert total == jtotal == 5 and seconds > 0 and jseconds > 0
    assert sites["sortnet_pack_rank"] == 3
    assert stages["port", "cluster"][1] == {"cluster distance matmul": 1}
    # per kernel, the process's first call and the steady ones apart, as
    # in JAX: at most one first call a kernel
    snap = json.loads((runs["port"]["compress"] / "metrics.json").read_text())
    phases = {}
    for v in snap["autocycler_device_kernel_seconds"]["values"]:
        assert v["labels"]["phase"] in ("first", "steady")
        assert v["labels"]["phase"] == "steady" or v["count"] == 1
        kernel = v["labels"]["kernel"]
        phases[kernel] = phases.get(kernel, 0) + v["count"]
    assert phases == sites


def test_device_failures_count_once_and_raise(monkeypatch):
    """A dispatch that raises counts once in the failures counter (also
    inside another device block), names itself in the last-failure info,
    is still a dispatch of the run record, and raises on."""
    _reset_registries()
    device.reset_counts()
    cpu = torch.device("cpu")
    reg = metrics_registry.registry()
    with pytest.raises(ValueError, match="bad rows"):
        with device.device_work("adjacency segment ops", cpu):
            with device.dp_dispatch("trim_overlap_dp", cpu, rows=1):
                raise ValueError("bad rows")
    assert reg.value(timing.DEVICE_FAILURES) == 1
    last = reg.snapshot()[timing.DEVICE_FAILURE_LAST]["values"][0]["value"]
    assert last.startswith("adjacency segment ops raised ValueError")
    assert device.fold_records() == 2
    assert reg.value(timing.DEVICE_DISPATCHES) == 2
    assert device.fold_records() == 0          # each record folds once
    device.reset_counts()


def _masked_log(text, out):
    """LOG_JSON records with the time stamp, the out dir and the run time
    masked."""
    records = []
    for line in text.splitlines():
        record = json.loads(line)
        record["ts"] = "T"
        record["text"] = re.sub(r"Time to run: .*", "Time to run: T",
                                record["text"].replace(str(out), "OUT"))
        records.append(record)
    return records


def test_log_json_lines_equal_the_jax_packages(tmp_path, monkeypatch):
    asm = make_assemblies(tmp_path, n_assemblies=2, chromosome_len=3000,
                          plasmid_len=500, seed=6)
    _on_cpu(monkeypatch)
    monkeypatch.setenv("AUTOCYCLER_LOG_JSON", "1")
    logs = {}
    for name, main in (("jax", jax_cli.main), ("port", cli.main)):
        out = tmp_path / name
        try:
            with contextlib.redirect_stderr(io.StringIO()) as err:
                assert main(["compress", "-i", str(asm), "-a", str(out)]) == 0
        finally:
            gc.enable()
        logs[name] = _masked_log(err.getvalue(), out)
    assert logs["port"] == logs["jax"]
    assert {r["type"] for r in logs["port"]} == {"section", "explanation",
                                                "message"}
    assert all(set(r) == {"ts", "type", "text"} for r in logs["port"])


def test_nothing_is_written_without_a_trace_dir(tmp_path, monkeypatch):
    asm = make_assemblies(tmp_path, n_assemblies=2, chromosome_len=3000,
                          plasmid_len=500, seed=4)
    _on_cpu(monkeypatch)
    monkeypatch.chdir(tmp_path)
    before = set(p.name for p in tmp_path.iterdir())
    _pipeline(cli.main, monkeypatch, asm, tmp_path / "out", None)
    assert set(p.name for p in tmp_path.iterdir()) == before | {"out"}
    found = [p for p in tmp_path.rglob("*") if p.name in RUN_FILES]
    assert found == [] and not trace.tracing_active()


def test_metrics_file_knob(tmp_path, monkeypatch):
    monkeypatch.setenv("AUTOCYCLER_METRICS", str(tmp_path / "m.prom"))
    _cli(cli.main, monkeypatch, None, ["table"])
    assert (tmp_path / "m.prom").is_file()
