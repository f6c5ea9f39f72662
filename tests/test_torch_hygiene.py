"""What the port may not do: import jax or the JAX package, carry on on the
CPU when the CLI finds no CUDA device, or fall back from its kernel to the
plain version for a tensor that is not on the card."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "autocycler_tpu_torch"
FORBIDDEN_IMPORT = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|autocycler_tpu)(?:\.|\s|$)", re.MULTILINE)


def test_port_runs_compress_without_jax(tmp_path):
    from synthetic import make_assemblies, make_isolate_dirs
    asm = make_assemblies(tmp_path, n_assemblies=2, chromosome_len=3000,
                          plasmid_len=500)
    isolates = make_isolate_dirs(tmp_path / "isolates", 2, seed0=5,
                                 n_assemblies=3, chromosome_len=160,
                                 plasmid_len=70)
    code = (
        "import sys\n"
        "from autocycler_tpu_torch.commands.compress import compress\n"
        "from autocycler_tpu_torch.commands.decompress import decompress\n"
        "from autocycler_tpu_torch.commands.cluster import cluster\n"
        "from autocycler_tpu_torch.commands.dotplot import dotplot\n"
        "from autocycler_tpu_torch.commands.trim import trim\n"
        "from autocycler_tpu_torch.commands.resolve import resolve\n"
        "from autocycler_tpu_torch.commands.combine import combine\n"
        f"compress({str(asm)!r}, {str(tmp_path / 'out')!r}, device='cpu')\n"
        f"decompress({str(tmp_path / 'out' / 'input_assemblies.gfa')!r}, "
        f"{str(tmp_path / 'recon')!r})\n"
        f"cluster({str(tmp_path / 'out')!r}, device='cpu')\n"
        f"dotplot({str(tmp_path / 'out' / 'input_assemblies.gfa')!r}, "
        f"{str(tmp_path / 'plot.png')!r}, res=500, kmer=12, "
        "grid_mode='device', device='cpu')\n"
        "from pathlib import Path\n"
        f"out = Path({str(tmp_path / 'out')!r})\n"
        "clusters = sorted((out / 'clustering' / 'qc_pass').iterdir())\n"
        "for c in clusters:\n"
        "    trim(c, device='cpu')\n"
        "    resolve(c, device='cpu')\n"
        "combine(out, [c / '5_final.gfa' for c in clusters])\n"
        "import os\n"
        "from autocycler_tpu_torch import device\n"
        "os.environ['AUTOCYCLER_SKETCH_DISTANCE'] = 'on'\n"
        f"sk = Path({str(tmp_path / 'sketch')!r})\n"
        f"compress({str(asm)!r}, sk, device='cpu')\n"
        "handoff = cluster(sk, device='cpu', collect_handoff=True)\n"
        "for c in sorted(handoff):\n"
        "    trimmed = trim(c, device='cpu', preloaded=handoff.pop(c))\n"
        "    resolve(c, device='cpu', preloaded=trimmed)\n"
        "combine(sk, sorted(sk.glob('clustering/qc_pass/*/5_final.gfa')))\n"
        "print('SKETCH', device.dp_summary('cluster_sketch_grid')"
        "['dispatches'])\n"
        "os.environ['AUTOCYCLER_STREAM_KMERS'] = 'on'\n"
        f"streamed = Path({str(tmp_path / 'streamed')!r})\n"
        f"compress({str(asm)!r}, streamed, device='cpu')\n"
        "print('STREAM', (streamed / 'input_assemblies.gfa').read_bytes()\n"
        "      == (out / 'input_assemblies.gfa').read_bytes(),\n"
        "      sorted(p.name for p in streamed.iterdir()))\n"
        "from autocycler_tpu_torch import cli\n"
        "from autocycler_tpu_torch.commands import compress as compress_mod\n"
        "from autocycler_tpu_torch.utils import cache\n"
        "os.environ['AUTOCYCLER_STREAM_KMERS'] = 'auto'\n"
        "s0 = cache.cache_stats()\n"
        f"compress({str(asm)!r}, out, device='cpu')\n"
        "s1 = cache.cache_stats()\n"
        "print('WARM', s1['parse_hits'] - s0['parse_hits'],\n"
        "      s1['repair_hits'] - s0['repair_hits'],\n"
        "      s1['parse_misses'] - s0['parse_misses'])\n"
        "import torch\n"
        "compress_mod.resolve_device = lambda dev=None: torch.device('cpu')\n"
        f"tmp = Path({str(tmp_path)!r})\n"
        "os.environ['AUTOCYCLER_TRACE_DIR'] = str(tmp / 'trace')\n"
        "assert cli.main(['compress', '-i', "
        f"{str(asm)!r}, '-a', str(tmp / 'traced')]) == 0\n"
        "del os.environ['AUTOCYCLER_TRACE_DIR']\n"
        "# timeseries.jsonl: only when the run outlasted a sampler tick\n"
        "print('TRACED', sorted(p.name for p in (tmp / 'trace').iterdir()\n"
        "                       if p.name != 'timeseries.jsonl'))\n"
        "reads = tmp / 'reads.fastq'\n"
        "reads.write_text(''.join(f'@r{i}\\n' + 'ACGT' * (50 + i) + '\\n+\\n'\n"
        "                         + 'I' * (200 + 4 * i) + '\\n' for i in range(40)))\n"
        "for argv in (['subsample', '-r', reads, '-o', tmp / 'subs', '-g', '1k',\n"
        "              '--min_read_depth', '2'],\n"
        "             ['table', '-a', out, '-n', 'x'],\n"
        "             ['gfa2fasta', '-i', clusters[0] / '5_final.gfa',\n"
        "              '-o', tmp / 'final.fasta'],\n"
        "             ['clean', '-i', clusters[0] / '5_final.gfa',\n"
        "              '-o', tmp / 'clean.gfa', '--cache', out]):\n"
        "    assert cli.main([str(a) for a in argv]) == 0, argv\n"
        "print('TOOLS', sorted(p.name for p in (tmp / 'subs').iterdir()),\n"
        "      (tmp / 'final.fasta').is_file(), (tmp / 'clean.gfa').is_file(),\n"
        "      sorted(p.name for p in (out / '.cache').iterdir()))\n"
        "from autocycler_tpu_torch.commands.batch import batch\n"
        f"print('BATCH', batch({str(isolates)!r}, tmp / 'batch', k_size=21,\n"
        "                      device='cpu'),\n"
        f"      batch({str(isolates)!r}, tmp / 'fleet', k_size=21, fleet='on',\n"
        "            device='cpu'))\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'autocycler_tpu' or m.startswith('autocycler_tpu.')]\n"
        "print('LOADED', bad)\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO)] + ([os.environ["PYTHONPATH"]]
                       if os.environ.get("PYTHONPATH") else [])))
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "LOADED []" in res.stdout
    assert "WARM 2 1 0" in res.stdout
    assert "TRACED ['ledger.json', 'metrics.json', 'metrics.prom', " \
        "'qc_report.json', 'trace.chrome.json', 'trace.jsonl']" in res.stdout
    assert "TOOLS ['sample_01.fastq', 'sample_02.fastq', 'sample_03.fastq', " \
        "'sample_04.fastq', 'subsample.yaml'] True True []" in res.stdout
    assert "\nx\t" in res.stdout                   # table's row
    assert "SKETCH 1" in res.stdout
    assert "BATCH 0 0" in res.stdout
    for out in ("batch", "fleet"):
        for iso in ("iso_000", "iso_001"):
            assert (tmp_path / out / iso / "consensus_assembly.fasta").is_file()
    assert "STREAM True ['.cache', '.stream', 'input_assemblies.gfa', " \
        "'input_assemblies.yaml']" in res.stdout
    assert (tmp_path / "sketch/consensus_assembly.fasta").read_text().count(
        "circular=true") == 2
    assert (tmp_path / "recon" / "assembly_1.fasta").read_bytes() == \
        (asm / "assembly_1.fasta").read_bytes()
    assert (tmp_path / "out/clustering/clustering.tsv").is_file()
    assert (tmp_path / "plot.png").is_file()
    assert (tmp_path / "out/consensus_assembly.fasta").read_text().count(
        "circular=true") == 2


def test_no_port_file_imports_jax_or_the_jax_package():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    names = {str(f.relative_to(PORT)) for f in files if PORT in f.parents}
    assert {f"serve/{m}.py" for m in ("__init__", "protocol", "slo",
                                      "scheduler", "server", "client",
                                      "router")} <= names
    assert {f"obs/{m}.py" for m in ("timeseries", "report", "watch",
                                    "federate", "top")} <= names
    assert "utils/chaos.py" in names
    offenders = [str(f.relative_to(REPO)) for f in files
                 if FORBIDDEN_IMPORT.search(f.read_text())]
    assert offenders == []


KNOB_READ = re.compile(r"""(?:env_(?:str|int|bool|float)|environ\.get|"""
                       r"""getenv|setdefault)\(\s*["'](AUTOCYCLER_\w+)["']""")


def test_every_knob_the_port_reads_has_the_jax_default():
    """Each AUTOCYCLER_* knob the port reads is in utils/env.py's DEFAULTS,
    with the default of the JAX package's knob registry, and every reader
    of the port takes it from there."""
    from autocycler_tpu.utils.knobs import KNOBS
    from autocycler_tpu_torch.utils.env import DEFAULTS
    read = set()
    for f in PORT.rglob("*.py"):
        read |= set(KNOB_READ.findall(f.read_text()))
    assert {"AUTOCYCLER_LOG_JSON", "AUTOCYCLER_FAULTS",
            "AUTOCYCLER_FED_STALE_S", "AUTOCYCLER_SCALE_OUT_BURN",
            "AUTOCYCLER_SCALE_OUT_UTIL", "AUTOCYCLER_SCALE_OUT_QUEUE",
            "AUTOCYCLER_SCALE_IN_UTIL", "AUTOCYCLER_SCALE_COOLDOWN_S",
            "AUTOCYCLER_SCALE_HYSTERESIS"} <= read
    assert sorted(read - set(DEFAULTS)) == []
    for name in read:
        knob = KNOBS[name]
        default = DEFAULTS[name]
        assert default == (knob.default or type(default)()), name
    # a reader passes no default of its own: DEFAULTS is the one source
    own = re.compile(r"""env_(?:str|int|bool|float)\(\s*["']AUTOCYCLER_\w+["']"""
                     r"""\s*,""")
    offenders = [str(f.relative_to(REPO)) for f in PORT.rglob("*.py")
                 if own.search(f.read_text())]
    assert offenders == []


def test_new_modules_run_without_jax(tmp_path):
    """top, the fleet scraper and the chaos harness's scan in a process
    with no jax loaded."""
    code = (
        "import json, sys\n"
        "from pathlib import Path\n"
        "from autocycler_tpu_torch.obs import federate, top\n"
        "from autocycler_tpu_torch.utils import chaos\n"
        "root = Path(sys.argv[1])\n"
        "(root / 'timeseries.jsonl').write_text(json.dumps({'ts': 1.0, "
        "'gauges': {}, 'counters': {}, 'host': {'rss_bytes': 1.0}}) + "
        "'\\n')\n"
        "assert top.render_top_frame(root)\n"
        "assert top.render_fleet_frame(root) is None\n"
        "assert chaos.scan_orphans(root) == []\n"
        "assert 'jax' not in sys.modules\n"
        "assert not [m for m in sys.modules if m.startswith("
        "'autocycler_tpu.') or m == 'autocycler_tpu']\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]


def test_cli_without_cuda_exits_1(tmp_path, monkeypatch, capsys):
    from synthetic import make_assemblies

    from autocycler_tpu_torch import cli
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    asm = make_assemblies(tmp_path, n_assemblies=2, chromosome_len=3000,
                          plasmid_len=500)
    rc = cli.main(["compress", "-i", str(asm), "-a", str(tmp_path / "out")])
    assert rc == 1
    err = capsys.readouterr().err
    assert "Error:" in err and "CUDA" in err
    assert not (tmp_path / "out" / "input_assemblies.gfa").exists()


def test_cluster_and_dotplot_without_cuda_exit_1(tmp_path, monkeypatch,
                                                 capsys):
    from synthetic import make_assemblies

    from autocycler_tpu_torch import cli
    from autocycler_tpu_torch.commands.compress import compress
    asm = make_assemblies(tmp_path, n_assemblies=2, chromosome_len=3000,
                          plasmid_len=500)
    compress(asm, tmp_path / "out", device="cpu")
    capsys.readouterr()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["cluster", "-a", str(tmp_path / "out")],
                 ["dotplot", "-i", str(tmp_path / "out/input_assemblies.gfa"),
                  "-o", str(tmp_path / "plot.png")]):
        assert cli.main(argv) == 1
        err = capsys.readouterr().err
        assert "Error:" in err and "CUDA" in err
    assert not (tmp_path / "out" / "clustering").exists()
    assert not (tmp_path / "plot.png").exists()


def test_trim_and_resolve_without_cuda_exit_1(tmp_path, monkeypatch, capsys):
    from synthetic import make_assemblies

    from autocycler_tpu_torch import cli
    from autocycler_tpu_torch.commands.cluster import cluster
    from autocycler_tpu_torch.commands.compress import compress
    from autocycler_tpu_torch.commands.trim import trim
    asm = make_assemblies(tmp_path, n_assemblies=2, chromosome_len=3000,
                          plasmid_len=500)
    compress(asm, tmp_path / "out", device="cpu")
    cluster(tmp_path / "out", device="cpu")
    clusters = sorted((tmp_path / "out/clustering/qc_pass").iterdir())
    trim(clusters[0], device="cpu")      # resolve's input, in one cluster
    capsys.readouterr()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["trim", "-c", str(clusters[1])],
                 ["resolve", "-c", str(clusters[0])]):
        assert cli.main(argv) == 1
        err = capsys.readouterr().err
        assert "Error:" in err and "CUDA" in err
    assert not (clusters[1] / "2_trimmed.gfa").exists()
    assert not (clusters[0] / "3_bridged.gfa").exists()
    assert not (clusters[0] / "5_final.gfa").exists()


def test_cli_reports_user_errors(tmp_path, capsys):
    from autocycler_tpu_torch import cli
    rc = cli.main(["decompress", "-i", str(tmp_path / "missing.gfa"),
                   "-o", str(tmp_path / "o")])
    assert rc == 1
    assert "Error: file does not exist" in capsys.readouterr().err


def test_kernel_wrapper_raises_on_cpu_tensor():
    from autocycler_tpu_torch.ops import sortnet
    codes = torch.zeros(100, dtype=torch.uint8)
    starts = torch.arange(10, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        sortnet.pack_rank_cuda(codes, starts, 11)


def test_match_grid_wrappers_raise_on_cpu_tensors():
    from autocycler_tpu_torch.ops import dotplot_grid
    words = torch.zeros((2, 300), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        dotplot_grid.match_grid_cuda(words, words, 128, 128)
    for dtype in ("bfloat16", "int8"):
        with pytest.raises(ValueError, match="CUDA"):
            dotplot_grid.match_grid_mxu_cuda(words, words, 32, 128,
                                             in_dtype=dtype)


def test_kmer_index_has_no_cpu_default():
    """The index's later device stages run where build_kmer_index put them; a
    KmerIndex made without a device is an error, not a silent CPU run."""
    import dataclasses

    from autocycler_tpu_torch.ops.kmers import KmerIndex
    field = {f.name: f for f in dataclasses.fields(KmerIndex)}["device"]
    assert field.default is dataclasses.MISSING
    assert field.default_factory is dataclasses.MISSING


def test_device_resolution(monkeypatch):
    from autocycler_tpu_torch import device
    from autocycler_tpu_torch.utils import AutocyclerError
    assert device.resolve_device("cpu").type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(AutocyclerError, match="CUDA"):
        device.resolve_device(None)
    with pytest.raises(AutocyclerError, match="CUDA"):
        device.resolve_device("cuda")
    with pytest.raises(AutocyclerError, match="unsupported"):
        device.resolve_device("meta")


def test_build_paths_are_git_ignored():
    from autocycler_tpu_torch.ops import _build
    assert _build.BUILD_DIR.parent == PORT
    ignored = (REPO / ".gitignore").read_text().splitlines()
    assert "autocycler_tpu_torch/_build/" in ignored
    for name in _build.SOURCES:
        assert (_build.CSRC_DIR / f"{name}.cu").is_file()
    assert set(_build.SOURCES) == {"sortnet", "match_grid"}


def test_port_daemon_serves_a_job_without_jax(tmp_path):
    """The port's daemon on the CPU, in a fresh process: one compress job
    over HTTP, then shutdown, with neither jax nor the JAX package loaded."""
    from synthetic import make_assemblies
    asm = make_assemblies(tmp_path, n_assemblies=2, chromosome_len=3000,
                          plasmid_len=500)
    code = (
        "import sys\n"
        "from autocycler_tpu_torch.serve.server import ServeHandle\n"
        "from autocycler_tpu_torch.serve.client import request_json, "
        "wait_for_job\n"
        f"h = ServeHandle({str(tmp_path / 'root')!r}, port=0, workers=2,\n"
        "                device='cpu').start()\n"
        "try:\n"
        "    status, rec = request_json(h.endpoint, 'POST', '/jobs', body={\n"
        f"        'assemblies_dir': {str(asm)!r}}})\n"
        "    rec = wait_for_job(h.endpoint, rec['id'], poll_s=0.05, "
        "timeout=120)\n"
        "    print('JOB', status, rec['state'])\n"
        "    print('SHUTDOWN', request_json(h.endpoint, 'POST', "
        "'/shutdown')[0])\n"
        "finally:\n"
        "    h.stop()\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'autocycler_tpu' or m.startswith('autocycler_tpu.')]\n"
        "print('LOADED', bad)\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO)] + ([os.environ["PYTHONPATH"]]
                       if os.environ.get("PYTHONPATH") else [])))
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "JOB 202 done" in res.stdout and "SHUTDOWN 200" in res.stdout
    assert "LOADED []" in res.stdout
    assert (tmp_path / "root" / "jobs" / "job-000001" / "out" /
            "input_assemblies.gfa").is_file()
    assert not (tmp_path / "root" / "serve.json").exists()


def test_serve_without_cuda_exits_1_before_binding(tmp_path, monkeypatch,
                                                   capsys):
    """`serve` with no card: exit 1 with Error:, no serve.json, no root."""
    from autocycler_tpu_torch import cli
    from autocycler_tpu_torch.serve.server import ServeHandle
    from autocycler_tpu_torch.utils import AutocyclerError
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    root = tmp_path / "root"
    assert cli.main(["serve", "-a", str(root), "--port", "0"]) == 1
    err = capsys.readouterr().err
    assert "Error:" in err and "CUDA" in err
    assert not root.exists()
    with pytest.raises(AutocyclerError, match="CUDA"):
        ServeHandle(root, port=0)
    assert not (root / "serve.json").exists()


def test_submit_needs_no_cuda(tmp_path, monkeypatch, capsys):
    """`submit` is a thin client: with no card it submits and waits."""
    from synthetic import make_assemblies

    from autocycler_tpu_torch import cli
    from autocycler_tpu_torch.serve.server import ServeHandle
    asm = make_assemblies(tmp_path, n_assemblies=2, chromosome_len=3000,
                          plasmid_len=500)
    handle = ServeHandle(tmp_path / "root", port=0, workers=1,
                         device="cpu").start()
    try:
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        assert cli.main(["submit", "-i", str(asm), "--dir",
                         str(tmp_path / "root"), "--wait",
                         "--timeout", "120"]) == 0
    finally:
        handle.stop()
    assert "job-000001 done" in capsys.readouterr().err
