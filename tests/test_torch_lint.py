"""The port's static analysis (``autocycler_tpu_torch/analysis/``,
``commands/lint.py``) and its knob registry (``utils/knobs.py``) against the
JAX package's, on the CPU.

Every case of the JAX package's ``tests/test_lint.py`` has a counterpart
here. Where the rule family is shared as it is (the engine's parse
findings, ``locks.*``, ``readers.*``, ``metrics.*``, ``faults.*``,
suppressions, selectors and baselines), each fixture runs through both
engines and the findings must be identical: rule, path, line, message and
fingerprint. The knobs and purity families read the port's accessors and
the port's roots (``torch.compile``, ``torch.jit``, ``vmap``, CUDA-graph
captures): each has a positive, a suppressed and a baselined case. Then
the accessors parse as the JAX package's do, both registries agree on every
knob they share, the knob table of ``docs_torch/cli.md`` is the generated
one, the shipped tree lints clean, and the CLI exits 0, 1 and 2 where it
should."""

import contextlib
import io
import json
import textwrap
from pathlib import Path

import pytest

from autocycler_tpu import analysis as jax_analysis
from autocycler_tpu.utils import knobs as jax_knobs
from autocycler_tpu_torch import cli
from autocycler_tpu_torch.analysis import (LintContext, load_baseline,
                                           run_lint, split_baseline,
                                           write_baseline)
from autocycler_tpu_torch.analysis.engine import rule_matches
from autocycler_tpu_torch.analysis.rules import rule_ids
from autocycler_tpu_torch.commands import doctor
from autocycler_tpu_torch.commands import lint as lint_cmd
from autocycler_tpu_torch.obs import report as report_mod
from autocycler_tpu_torch.utils import knobs as knobs_mod
from autocycler_tpu_torch.utils.knobs import (KNOBS, knob_bool, knob_float,
                                              knob_int, knob_str,
                                              knobs_markdown)

pytestmark = pytest.mark.lint

REPO = Path(__file__).resolve().parents[1]


def lint_source(tmp_path, source, name="fixture.py", selectors=None,
                docs=None):
    """Write one fixture module and lint it with the port's engine."""
    path = tmp_path / name
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(textwrap.dedent(source))
    ctx = LintContext(root=tmp_path, docs_path=docs)
    findings, n_files = run_lint([path], ctx, selectors=selectors)
    assert n_files == 1
    return findings


def lint_both(tmp_path, source, name="fixture.py", selectors=None,
              docs=None):
    """The port's findings, after holding them equal to the JAX engine's
    on the same fixture (rule, path, line, message, fingerprint)."""
    port = lint_source(tmp_path, source, name, selectors, docs)
    ctx = jax_analysis.LintContext(root=tmp_path, docs_path=docs)
    jax, n_files = jax_analysis.run_lint([tmp_path / name], ctx,
                                         selectors=selectors)
    assert n_files == 1
    assert [f.to_dict() for f in port] == [f.to_dict() for f in jax]
    return port


def rules_of(findings):
    return [f.rule for f in findings]


def baselined(tmp_path, findings):
    """Accept ``findings`` in a baseline file, then split them again."""
    path = tmp_path / "lint_baseline_torch.json"
    write_baseline(findings, path)
    return split_baseline(findings, load_baseline(path))


# ---- knobs family ----

PRE_MIGRATION_ENV_READ = """
    import os

    def _probe_neg_ttl() -> float:
        raw = os.environ.get("AUTOCYCLER_PROBE_NEG_TTL_S", "300")
        try:
            return float(raw or "300")
        except ValueError:
            return 300.0
"""


def test_knobs_direct_read_flagged(tmp_path):
    findings = lint_both(tmp_path, PRE_MIGRATION_ENV_READ)
    assert rules_of(findings) == ["knobs.direct-read"]
    assert "AUTOCYCLER_PROBE_NEG_TTL_S" in findings[0].message


def test_knobs_direct_read_suppressed(tmp_path):
    src = PRE_MIGRATION_ENV_READ.replace(
        '"300")',
        '"300")  # lint: ignore[knobs.direct-read]', 1)
    assert lint_both(tmp_path, src) == []


def test_knobs_direct_read_baselined(tmp_path):
    findings = lint_both(tmp_path, PRE_MIGRATION_ENV_READ)
    new, old = baselined(tmp_path, findings)
    assert new == [] and rules_of(old) == ["knobs.direct-read"]


def test_knobs_direct_read_variants(tmp_path):
    findings = lint_both(tmp_path, """
        import os
        from os import getenv

        NAME = "AUTOCYCLER_METRICS"
        a = os.getenv("AUTOCYCLER_TIMINGS")
        b = os.environ["AUTOCYCLER_TRACE_DIR"]
        c = os.environ.get(NAME)
    """)
    assert rules_of(findings) == ["knobs.direct-read"] * 3


def test_knobs_env_writes_are_legal(tmp_path):
    findings = lint_both(tmp_path, """
        import os

        os.environ["AUTOCYCLER_TIMINGS"] = "1"
        os.environ.setdefault("AUTOCYCLER_METRICS", "m.json")
        os.environ.pop("AUTOCYCLER_TIMINGS", None)
        del os.environ["AUTOCYCLER_METRICS"]
    """)
    assert findings == []


def test_knobs_direct_read_exempts_only_the_port_registry(tmp_path):
    """The port's registry module may read the environment; a module of
    the same name elsewhere (the JAX package's) may not."""
    src = 'import os\nx = os.environ.get("AUTOCYCLER_TIMINGS")\n'
    assert lint_source(tmp_path, src,
                       name="autocycler_tpu_torch/utils/knobs.py") == []
    assert rules_of(lint_source(tmp_path, src,
                                name="autocycler_tpu/utils/knobs.py")) == \
        ["knobs.direct-read"]


# the port declares only the knobs it reads: the JAX package's host radix
# knob is undeclared here
UNDECLARED_ACCESSORS = """
    from autocycler_tpu_torch.utils.knobs import knob_float, knob_int

    x = knob_float("AUTOCYCLER_NOT_A_REAL_KNOB")
    y = knob_int("AUTOCYCLER_RADIX_MIN_WINDOWS")
    z = knob_int("AUTOCYCLER_XPROF_LIMIT")
"""


def test_knobs_undeclared_accessor(tmp_path):
    findings = lint_source(tmp_path, UNDECLARED_ACCESSORS)
    assert rules_of(findings) == ["knobs.undeclared"] * 2
    assert "AUTOCYCLER_NOT_A_REAL_KNOB" in findings[0].message
    assert "AUTOCYCLER_RADIX_MIN_WINDOWS" in findings[1].message


def test_knobs_undeclared_suppressed(tmp_path):
    src = UNDECLARED_ACCESSORS.replace(
        '_KNOB")', '_KNOB")  # lint: ignore[knobs]').replace(
        '_WINDOWS")', '_WINDOWS")  # lint: ignore[knobs.undeclared]')
    assert lint_source(tmp_path, src) == []


def test_knobs_undeclared_baselined(tmp_path):
    findings = lint_source(tmp_path, UNDECLARED_ACCESSORS)
    new, old = baselined(tmp_path, findings)
    assert new == [] and len(old) == 2


def test_knobs_docs_drift_both_directions(tmp_path):
    docs = tmp_path / "cli.md"
    docs.write_text("usage: autocycler -a AUTOCYCLER_DIR\n"
                    "<!-- knobs:begin -->\n"
                    "| `AUTOCYCLER_NOT_A_REAL_KNOB` | str | unset | x |\n"
                    "<!-- knobs:end -->\n")
    findings = lint_source(tmp_path, "x = 1\n", docs=docs)
    assert set(rules_of(findings)) == {"knobs.docs-drift"}
    messages = " ".join(f.message for f in findings)
    assert "AUTOCYCLER_NOT_A_REAL_KNOB is not declared" in messages
    assert "AUTOCYCLER_DIR is not declared" not in messages
    missing = [f for f in findings if "missing from the knob table"
               in f.message]
    assert len(missing) == len(KNOBS)


def test_knobs_docs_markers_required(tmp_path):
    docs = tmp_path / "cli.md"
    docs.write_text("no markers here\n")
    findings = lint_both(tmp_path, "x = 1\n", docs=docs)
    assert rules_of(findings) == ["knobs.docs-drift"]
    assert "markers" in findings[0].message


def test_knobs_docs_round_trip(tmp_path):
    docs = tmp_path / "cli.md"
    docs.write_text("<!-- knobs:begin -->\n" + knobs_markdown()
                    + "<!-- knobs:end -->\n")
    assert lint_source(tmp_path, "x = 1\n", docs=docs) == []
    # the JAX table documents knobs the port does not declare
    docs.write_text("<!-- knobs:begin -->\n" + jax_knobs.knobs_markdown()
                    + "<!-- knobs:end -->\n")
    extra = {f.message.split()[2] for f in
             lint_source(tmp_path, "x = 1\n", docs=docs)}
    assert extra == set(jax_knobs.KNOBS) - set(KNOBS)


# ---- faults family ----

def _faults_docs(tmp_path, table_rows):
    docs_dir = tmp_path / "docs_torch"
    docs_dir.mkdir(parents=True, exist_ok=True)
    cli_md = docs_dir / "cli.md"
    cli_md.write_text("no knob markers\n")
    (docs_dir / "failure-modes.md").write_text(
        "`stream_write` mentioned in prose must not count\n"
        "<!-- faults:begin -->\n"
        "| Site | Hook | Injected failure | Containment / recovery |\n"
        "|---|---|---|---|\n"
        + "".join(f"| `{site}` | h | f | r |\n" for site in table_rows)
        + "<!-- faults:end -->\n")
    return cli_md


def _faults(findings):
    return [f for f in findings if f.rule == "faults.documented"]


def test_faults_documented_both_directions(tmp_path):
    from autocycler_tpu_torch.utils.resilience import FAULT_SITES

    rows = [s for s in FAULT_SITES if s != "post-stage"] + ["made-up-site"]
    docs = _faults_docs(tmp_path, rows)
    faults = _faults(lint_source(tmp_path, "x = 1\n", docs=docs))
    messages = " ".join(f.message for f in faults)
    assert "post-stage" in messages and "no row" in messages
    assert "made-up-site is not registered" in messages
    assert "stream_write" not in messages
    assert len(faults) == 2


def test_faults_documented_markers_required(tmp_path):
    docs = _faults_docs(tmp_path, [])
    (docs.parent / "failure-modes.md").write_text("no markers\n")
    faults = _faults(lint_both(tmp_path, "x = 1\n", docs=docs))
    assert len(faults) == 1 and "markers" in faults[0].message


def test_faults_documented_round_trip(tmp_path):
    """The port's registry against its own table: its sites lint clean;
    the JAX package's native_* sites, which the port does not have, are
    not registered; a missing page means nothing to check."""
    from autocycler_tpu.utils.resilience import FAULT_SITES as JAX_SITES
    from autocycler_tpu_torch.utils.resilience import FAULT_SITES

    docs = _faults_docs(tmp_path, list(FAULT_SITES))
    assert _faults(lint_source(tmp_path, "x = 1\n", docs=docs)) == []
    _faults_docs(tmp_path, list(JAX_SITES))
    extra = _faults(lint_source(tmp_path, "x = 1\n", docs=docs))
    assert sorted(f.message.split()[3] for f in extra) == \
        sorted(set(JAX_SITES) - set(FAULT_SITES))
    (docs.parent / "failure-modes.md").unlink()
    assert _faults(lint_source(tmp_path, "x = 1\n", docs=docs)) == []


# ---- locks family ----

PRE_MIGRATION_UNLOCKED_WRITE = """
    import threading

    _fault_lock = threading.Lock()
    _policy = None

    def set_policy(p):
        global _policy
        _policy = p
"""


def test_locks_unguarded_global(tmp_path):
    findings = lint_both(tmp_path, PRE_MIGRATION_UNLOCKED_WRITE)
    assert rules_of(findings) == ["locks.unguarded-global"]
    assert "_policy" in findings[0].message


def test_locks_guarded_write_is_clean(tmp_path):
    findings = lint_both(tmp_path, """
        import threading

        _lock = threading.Lock()
        _state = None

        def set_state(s):
            global _state
            with _lock:
                _state = s
    """)
    assert findings == []


def test_locks_locked_suffix_contract(tmp_path):
    findings = lint_both(tmp_path, """
        import threading

        _lib_lock = threading.Lock()
        _lib = None

        def _get_lib_locked():
            global _lib
            _lib = object()

        def get_lib():
            with _lib_lock:
                _get_lib_locked()
    """)
    assert findings == []


def test_locks_no_module_lock_no_findings(tmp_path):
    findings = lint_both(tmp_path, """
        _state = None

        def set_state(s):
            global _state
            _state = s
    """)
    assert findings == []


PRE_FIX_UNLOCKED_FIELD = """
    import threading

    class Sched:
        _GUARDED_BY = {"_lock": ("_jobs", "_busy")}

        def __init__(self):
            self._lock = threading.Lock()
            self._jobs = {}
            self._busy = {}

        def set_busy(self, worker, job_id):
            self._busy[worker] = job_id

        def clear_busy(self, worker):
            self._busy.pop(worker, None)
"""


def test_locks_guarded_field_unlocked(tmp_path):
    findings = lint_both(tmp_path, PRE_FIX_UNLOCKED_FIELD)
    assert rules_of(findings) == ["locks.guarded-field"] * 2
    assert all("_busy" in f.message for f in findings)


def test_locks_guarded_field_clean(tmp_path):
    findings = lint_both(tmp_path, """
        import threading

        class Sched:
            _GUARDED_BY = {"_lock": ("_jobs",)}

            def __init__(self):
                self._lock = threading.Lock()
                self._jobs = {}

            def add(self, job):
                with self._lock:
                    self._jobs[job.id] = job

            def _admit_locked(self, job):
                self._jobs[job.id] = job

            def note(self, text):
                self._note = text
    """)
    assert findings == []


def test_locks_guarded_field_without_declaration_is_silent(tmp_path):
    findings = lint_both(tmp_path, """
        class Plain:
            def set(self, k, v):
                self._jobs = {k: v}
    """)
    assert findings == []


def test_locks_thread_daemon(tmp_path):
    findings = lint_both(tmp_path, """
        import threading

        a = threading.Thread(target=print)
        b = threading.Thread(target=print, daemon=True)
        c = threading.Thread(target=print)  # lint: ignore[locks]
    """)
    assert rules_of(findings) == ["locks.thread-daemon"]
    assert findings[0].line == 4


# ---- purity family (the port's roots) ----

PURITY_FIXTURE = """
    import time
    from functools import partial

    import torch

    def _log_progress(x):
        t = time.perf_counter()
        print("step", t)
        return x

    @torch.compile
    def step(x):
        return _log_progress(x) + 1

    @partial(torch.compile, dynamic=False)
    def step2(n, gen):
        return torch.rand(n, generator=gen)

    def host_only():
        return time.perf_counter()
"""


def test_purity_reachable_impurity_flagged(tmp_path):
    findings = lint_source(tmp_path, PURITY_FIXTURE)
    reasons = [f.message for f in findings]
    assert rules_of(findings) == ["purity.impure-call"] * 2
    assert any("time.perf_counter" in r for r in reasons)
    assert any("print()" in r for r in reasons)
    assert all("_log_progress" in r and "reachable" in r for r in reasons)
    assert not any("host_only" in r for r in reasons)


def test_purity_generator_is_legal(tmp_path):
    findings = lint_source(tmp_path, """
        import torch

        @torch.compile(mode="reduce-overhead")
        def draw(gen):
            return torch.randn(4, generator=gen)
    """)
    assert findings == []


@pytest.mark.parametrize("wrap", ["torch.compile(kernel)",
                                  "torch.jit.script(kernel)",
                                  "torch.jit.trace(kernel, (x,))",
                                  "torch.func.vmap(kernel)",
                                  "vmap(kernel)"])
def test_purity_wrapper_call_roots(tmp_path, wrap):
    findings = lint_source(tmp_path, f"""
        import os

        import torch
        from torch.func import vmap

        def kernel(x):
            flag = os.environ
            return x

        x = torch.zeros(4)
        fast = {wrap}
    """)
    assert rules_of(findings) == ["purity.impure-call"]
    assert "os.environ" in findings[0].message


def test_purity_cuda_graph_capture_roots(tmp_path):
    findings = lint_source(tmp_path, """
        import numpy as np
        import torch

        def body(x):
            scale = np.random.rand()
            return x * scale + x.sum().item()

        def replay_only(x):
            return x.sum().item()

        static = torch.zeros(4)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            out = body(static)
    """)
    assert rules_of(findings) == ["purity.impure-call"] * 2
    assert all("'body'" in f.message for f in findings)


def test_purity_suppressed(tmp_path):
    src = PURITY_FIXTURE.replace(
        "t = time.perf_counter()",
        "t = time.perf_counter()  # lint: ignore[purity]"
    ).replace('print("step", t)',
              'print("step", t)  # lint: ignore[purity.impure-call]')
    assert lint_source(tmp_path, src) == []


def test_purity_baselined(tmp_path):
    findings = lint_source(tmp_path, PURITY_FIXTURE)
    new, old = baselined(tmp_path, findings)
    assert new == [] and len(old) == 2


def test_purity_jax_roots_are_not_the_ports(tmp_path):
    """A jax.jit root binds the JAX rule, not the port's."""
    src = """
        import time

        import jax

        @jax.jit
        def step(x):
            return x + time.time()
    """
    assert lint_source(tmp_path, src) == []
    ctx = jax_analysis.LintContext(root=tmp_path)
    jax, _ = jax_analysis.run_lint([tmp_path / "fixture.py"], ctx)
    assert rules_of(jax) == ["purity.impure-call"]


# ---- readers family ----

READER_FIXTURE = """
    import json

    def read_status(path):
        data = json.loads(open(path).read())
        if not data:
            raise ValueError("empty status")
        return data
"""


def test_readers_raise_and_unguarded_io(tmp_path):
    findings = lint_both(tmp_path, READER_FIXTURE)
    assert sorted(rules_of(findings)) == [
        "readers.raise", "readers.unguarded-io", "readers.unguarded-io"]


def test_readers_guarded_reader_is_clean(tmp_path):
    findings = lint_both(tmp_path, """
        import json

        def read_status(path):
            try:
                with open(path) as fh:
                    return json.load(fh)
            except (OSError, ValueError):
                return {}
    """)
    assert findings == []


def test_readers_writers_exempt(tmp_path):
    findings = lint_both(tmp_path, """
        import json

        def write_status(path, data):
            if not data:
                raise ValueError("refusing to write nothing")
            open(path, "w").write(json.dumps(data))

        def render_report(data):
            raise NotImplementedError
    """)
    assert findings == []


def test_readers_suppressed(tmp_path):
    src = READER_FIXTURE.replace(
        "json.loads(open(path).read())",
        "json.loads(open(path).read())  # lint: ignore[readers]"
    ).replace('raise ValueError("empty status")',
              'raise ValueError("empty status")  # lint: ignore')
    assert lint_both(tmp_path, src) == []


# ---- metrics family ----

def test_metrics_name_rules(tmp_path):
    findings = lint_both(tmp_path, """
        from autocycler_tpu_torch.obs import metrics_registry as mr

        CACHE_HITS = "autocycler_cache_hits"

        mr.counter_inc(CACHE_HITS)
        mr.counter_inc("autocycler_jobs_total")
        mr.gauge_set("autocycler_queue_total", 3)
        mr.observe("autocycler_wait", 0.5)
        mr.observe("autocycler_wait_seconds", 0.5)
        mr.counter_inc("badprefix_things_total")
    """)
    msgs = [f.message for f in findings]
    assert rules_of(findings) == ["metrics.name"] * 4
    assert any("'autocycler_cache_hits' must end with _total" in m
               for m in msgs)
    assert any("'autocycler_queue_total' must not end with _total" in m
               for m in msgs)
    assert any("'autocycler_wait' needs a unit suffix" in m for m in msgs)
    assert any("'badprefix_things_total' does not match" in m for m in msgs)


def test_metrics_label_rules(tmp_path):
    findings = lint_both(tmp_path, """
        from autocycler_tpu_torch.obs import metrics_registry as mr

        mr.counter_inc("autocycler_jobs_total", le="0.5")
        mr.counter_inc("autocycler_jobs_total", Stage="trim")
        mr.counter_inc("autocycler_jobs_total", stage="trim",
                       help="jobs", value=2)
    """)
    msgs = [f.message for f in findings]
    assert rules_of(findings) == ["metrics.label"] * 2
    assert any("'le' is reserved" in m for m in msgs)
    assert any("'Stage' does not match" in m for m in msgs)


def test_metrics_span_rules(tmp_path):
    findings = lint_both(tmp_path, """
        import os

        from autocycler_tpu_torch.obs import trace

        def work(cmd):
            with trace.span("Compress Stage"):
                pass
            with trace.span(f"subprocess {os.path.basename(cmd[0])}"):
                pass
            with trace.span("cluster qc"):
                pass
    """)
    assert rules_of(findings) == ["metrics.span"]
    assert "Compress Stage" in findings[0].message


# the port's own families, with no JAX counterpart: the copies to the host
# that ``device.to_host`` counts by site, and the device batches of the
# stream's pass 1
PORT_ONLY_METRICS = {"autocycler_device_to_host_bytes_total",
                     "autocycler_device_to_host_copies_total",
                     "autocycler_stream_pass1_batches_total"}


def test_metrics_the_ports_names_are_the_jax_names():
    """Every metric name the port's source registers statically is one the
    JAX package's source registers too, but the port's own families, and
    both engines find the port's sites clean."""
    import ast

    from autocycler_tpu_torch.analysis.engine import Module
    from autocycler_tpu_torch.analysis.rules.metrics import (
        KIND_BY_METHOD, _resolve_name)

    def names(root, package):
        out = set()
        for path in sorted((root / package).rglob("*.py")):
            mod = Module(path, path.as_posix(), path.read_text())
            consts = mod.module_str_constants()
            for node in ast.walk(mod.tree):
                if isinstance(node, ast.Call) and node.args and getattr(
                        node.func, "attr", None) in KIND_BY_METHOD:
                    name = _resolve_name(node.args[0], consts)
                    if name:
                        out.add(name)
        return out

    port = names(REPO, "autocycler_tpu_torch")
    assert len(port) > 30
    assert sorted(port - names(REPO, "autocycler_tpu")) == \
        sorted(PORT_ONLY_METRICS)
    result = lint_cmd.run(rules=["metrics"])
    assert result["findings"] == []


# ---- engine: selectors, baseline, parse errors ----

def test_rule_selector_family_prefix(tmp_path):
    findings = lint_both(tmp_path, PRE_MIGRATION_ENV_READ
                         + PRE_MIGRATION_UNLOCKED_WRITE,
                         selectors=["locks"])
    assert rules_of(findings) == ["locks.unguarded-global"]


def test_rule_matches():
    assert rule_matches("knobs", "knobs.direct-read")
    assert rule_matches("knobs.direct-read", "knobs.direct-read")
    assert not rule_matches("knobs.direct", "knobs.direct-read")
    assert not rule_matches("locks", "knobs.direct-read")


def test_baseline_roundtrip(tmp_path):
    findings = lint_both(tmp_path, PRE_MIGRATION_UNLOCKED_WRITE)
    assert len(findings) == 1
    baseline_path = tmp_path / "lint_baseline_torch.json"
    write_baseline(findings, baseline_path)
    keys = load_baseline(baseline_path)
    new, old = split_baseline(findings, keys)
    assert new == [] and len(old) == 1
    other = lint_both(tmp_path, PRE_MIGRATION_UNLOCKED_WRITE,
                      name="other.py")
    new, old = split_baseline(other, keys)
    assert len(new) == 1 and old == []
    # either package's engine reads the other's baseline file
    jax_path = tmp_path / "lint_baseline.json"
    jax_analysis.write_baseline(findings, jax_path)
    assert jax_path.read_bytes() == baseline_path.read_bytes()
    assert jax_analysis.load_baseline(baseline_path) == keys


def test_baseline_fingerprint_survives_line_moves(tmp_path):
    before = lint_both(tmp_path, PRE_MIGRATION_UNLOCKED_WRITE)
    after = lint_both(tmp_path, "# a new comment up top\n"
                      + textwrap.dedent(PRE_MIGRATION_UNLOCKED_WRITE))
    assert before[0].line != after[0].line
    assert before[0].fingerprint() == after[0].fingerprint()


def test_broken_baseline_hides_nothing(tmp_path):
    path = tmp_path / "lint_baseline_torch.json"
    path.write_text("{not json")
    assert load_baseline(path) == set()


def test_syntax_error_becomes_finding(tmp_path):
    findings = lint_both(tmp_path, "def broken(:\n    pass\n")
    assert rules_of(findings) == ["engine.parse"]


# ---- knob accessor semantics: the JAX package's grammar ----

ACCESSOR_CASES = [
    ("AUTOCYCLER_TIMESERIES", "bool"), ("AUTOCYCLER_TIMINGS", "bool"),
    ("AUTOCYCLER_XPROF_LIMIT", "int"), ("AUTOCYCLER_SERVE_WORKERS", "int"),
    ("AUTOCYCLER_PROBE_NEG_TTL_S", "float"),
    ("AUTOCYCLER_PROBE_WATCH", "float"),
    ("AUTOCYCLER_TRACE_DIR", "str"), ("AUTOCYCLER_SKETCH_DISTANCE", "str")]
RAW_VALUES = [None, "", "   ", " 0 ", "0", "OFF", "No", "false", "yes",
              "anything", "1", " 5 ", "12", "-3", "1e3", "45.5", "12.5.3",
              "not-a-number", "/runs"]


@pytest.mark.parametrize("raw", RAW_VALUES, ids=repr)
@pytest.mark.parametrize("name,kind", ACCESSOR_CASES)
def test_accessors_parse_as_the_jax_package(monkeypatch, name, kind, raw):
    if raw is None:
        monkeypatch.delenv(name, raising=False)
    else:
        monkeypatch.setenv(name, raw)
    port = getattr(knobs_mod, f"knob_{kind}")
    jax = getattr(jax_knobs, f"knob_{kind}")
    with contextlib.redirect_stderr(io.StringIO()):
        assert port(name) == jax(name)
        assert port(name, default=7) == jax(name, default=7)
        assert knobs_mod.knob_raw(name) == jax_knobs.knob_raw(name)
        assert knobs_mod.knob_set(name) == jax_knobs.knob_set(name)


def test_knob_bool_grammar(monkeypatch):
    for false_spelling in ("0", "false", "FALSE", "No", "off", " Off "):
        monkeypatch.setenv("AUTOCYCLER_TIMESERIES", false_spelling)
        assert knob_bool("AUTOCYCLER_TIMESERIES") is False, false_spelling
    for true_spelling in ("1", "true", "yes", "on", "anything"):
        monkeypatch.setenv("AUTOCYCLER_TIMESERIES", true_spelling)
        assert knob_bool("AUTOCYCLER_TIMESERIES") is True, true_spelling
    monkeypatch.delenv("AUTOCYCLER_TIMESERIES", raising=False)
    assert knob_bool("AUTOCYCLER_TIMESERIES") is True
    monkeypatch.setenv("AUTOCYCLER_TIMESERIES", "")
    assert knob_bool("AUTOCYCLER_TIMESERIES") is True
    assert knob_bool("AUTOCYCLER_TIMESERIES", default=False) is False


def test_knob_numeric_malformed_falls_back(monkeypatch, capsys):
    """One warning per knob per process, in either package."""
    for mod in (knobs_mod, jax_knobs):
        mod._warned.clear()
        monkeypatch.setenv("AUTOCYCLER_XPROF_LIMIT", "not-a-number")
        assert mod.knob_int("AUTOCYCLER_XPROF_LIMIT") == 2
        assert mod.knob_int("AUTOCYCLER_XPROF_LIMIT", default=7) == 7
        monkeypatch.setenv("AUTOCYCLER_PROBE_NEG_TTL_S", "12.5.3")
        assert mod.knob_float("AUTOCYCLER_PROBE_NEG_TTL_S") == 300.0
        assert mod.knob_float("AUTOCYCLER_PROBE_NEG_TTL_S") == 300.0
        err = capsys.readouterr().err
        assert err.count("AUTOCYCLER_XPROF_LIMIT") == 1
        assert err.count("AUTOCYCLER_PROBE_NEG_TTL_S") == 1


def test_knob_numeric_valid_values(monkeypatch):
    monkeypatch.setenv("AUTOCYCLER_XPROF_LIMIT", " 5 ")
    assert knob_int("AUTOCYCLER_XPROF_LIMIT") == 5
    monkeypatch.setenv("AUTOCYCLER_PROBE_NEG_TTL_S", "45.5")
    assert knob_float("AUTOCYCLER_PROBE_NEG_TTL_S") == 45.5


def test_knob_str_empty_is_unset(monkeypatch):
    monkeypatch.setenv("AUTOCYCLER_TRACE_DIR", "  ")
    assert knob_str("AUTOCYCLER_TRACE_DIR") is None
    monkeypatch.setenv("AUTOCYCLER_TRACE_DIR", "/runs")
    assert knob_str("AUTOCYCLER_TRACE_DIR") == "/runs"


def test_undeclared_knob_raises():
    for reader in (knob_str, knob_int, knob_bool, knob_float):
        with pytest.raises(KeyError):
            reader("AUTOCYCLER_NOT_A_REAL_KNOB")
    with pytest.raises(KeyError):
        knob_int("AUTOCYCLER_RADIX_MIN_WINDOWS")   # a JAX-only knob


def test_registry_shape():
    assert len(KNOBS) >= 40
    for name, knob in KNOBS.items():
        assert name.startswith("AUTOCYCLER_")
        assert knob.kind in ("str", "bool", "int", "float")
        assert knob.doc


# the JAX package's knobs that the port does not read (ROADMAP.md)
NOT_READ = {"AUTOCYCLER_BENCH_LOAD_MAX", "AUTOCYCLER_BENCH_THREADS",
            "AUTOCYCLER_COMPILE_CACHE", "AUTOCYCLER_DEVICE_PROBE_TIMEOUT",
            "AUTOCYCLER_DEVICE_PROBE_TTL", "AUTOCYCLER_PROBE_MODE",
            "AUTOCYCLER_DISTANCE_BLOCK", "AUTOCYCLER_HOST_GROUPING",
            "AUTOCYCLER_RADIX_MIN_WINDOWS", "AUTOCYCLER_MESH_INIT_TIMEOUT",
            "AUTOCYCLER_NATIVE_DEBUG", "AUTOCYCLER_NATIVE_LIB"}


def test_registry_parity_with_the_jax_package():
    """Every knob both packages declare has the same kind and default; the
    port declares no knob of its own, and leaves out exactly the knobs it
    does not read; its order is the JAX package's."""
    assert set(KNOBS) <= set(jax_knobs.KNOBS)
    assert set(jax_knobs.KNOBS) - set(KNOBS) == NOT_READ
    for name, knob in KNOBS.items():
        jax = jax_knobs.KNOBS[name]
        assert (knob.kind, knob.default) == (jax.kind, jax.default), name
    assert list(KNOBS) == [n for n in jax_knobs.KNOBS if n in KNOBS]


def test_knobs_markdown_covers_registry():
    md = knobs_markdown()
    for name in KNOBS:
        assert f"`{name}`" in md


def test_knob_table_is_the_generated_one():
    """docs_torch/cli.md holds knobs_markdown() between its markers."""
    text = (REPO / "docs_torch" / "cli.md").read_text()
    begin, end = "<!-- knobs:begin -->\n", "<!-- knobs:end -->"
    table = text[text.index(begin) + len(begin):text.index(end)]
    assert table == knobs_markdown()


# ---- the bar: the shipped tree lints clean ----

def test_repo_self_lint_is_clean():
    result = lint_cmd.run()
    rendered = "\n".join(
        f"{f['path']}:{f['line']}: [{f['rule']}] {f['message']}"
        for f in result["findings"])
    assert result["findings"] == [], f"new lint findings:\n{rendered}"
    assert result["files"] > 50
    # an empty baseline: nothing is accepted
    assert result["baseline"] == str(REPO / "lint_baseline_torch.json")
    assert result["baselined"] == 0
    assert load_baseline(REPO / "lint_baseline_torch.json") == set()


def test_chip_smoke_reads_knobs_through_the_registry():
    """chip_smoke.py read AUTOCYCLER_FLEET_BUCKETS from os.environ; it
    reads it through the port's accessor, so neither package's knobs
    rule finds a direct read there."""
    path = REPO / "chip_smoke.py"
    findings, _ = run_lint([path], LintContext(root=REPO),
                           selectors=["knobs"])
    assert findings == []
    jax, _ = jax_analysis.run_lint([path], jax_analysis.LintContext(
        root=REPO), selectors=["knobs.direct-read"])
    assert jax == []


def test_rule_ids_are_stable():
    assert rule_ids() == jax_analysis.rule_ids()
    assert set(rule_ids()) == {
        "knobs.direct-read", "knobs.undeclared", "knobs.docs-drift",
        "locks.unguarded-global", "locks.thread-daemon",
        "locks.guarded-field",
        "purity.impure-call",
        "readers.raise", "readers.unguarded-io",
        "metrics.name", "metrics.label", "metrics.span",
        "faults.documented",
    }


# ---- the command ----

def _cli(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["lint", *argv])
    return rc, out.getvalue()


def test_lint_cli_exit_codes(tmp_path):
    rc, out = _cli(["--json"])
    assert rc == 0 and json.loads(out)["findings"] == []
    bad = tmp_path / "bad.py"
    bad.write_text(textwrap.dedent(PRE_MIGRATION_UNLOCKED_WRITE))
    rc, out = _cli([str(bad)])
    assert rc == 1 and "[locks.unguarded-global]" in out
    rc, out = _cli([str(bad), "--write-baseline", str(tmp_path / "b.json")])
    assert rc == 0
    rc, out = _cli([str(bad), "--baseline", str(tmp_path / "b.json")])
    assert rc == 0 and "1 baselined" in out
    rc, out = _cli(["--rule", "nope"])
    assert rc == 2 and "unknown rule 'nope'" in out
    rc, out = _cli(["--knobs-md"])
    assert rc == 0 and out == knobs_markdown()


def test_lint_report_feeds_report_and_doctor(tmp_path):
    run_dir = tmp_path / "run"
    run_dir.mkdir()
    rc, _ = _cli(["--report", str(run_dir / "lint_report.json")])
    assert rc == 0
    data = json.loads((run_dir / "lint_report.json").read_text())
    assert data["findings"] == [] and data["files"] > 50
    built = report_mod.build_report(run_dir)
    assert built["lint"]["files"] == data["files"]
    assert "lint:" in report_mod.render_report(built)
    state = doctor.lint_state(str(run_dir))
    assert state["baseline"] == str(REPO / "lint_baseline_torch.json")
    assert state["report"] == {"findings": 0, "files": data["files"],
                               "wall_s": data["wall_s"]}
