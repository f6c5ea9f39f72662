"""The port's host commands of the user pipeline against the JAX package's:
the StdRng shuffle (utils/rust_rand.py) and its self-test, `subsample`,
`table`, `gfa2fasta`, `clean` (remove, duplicate, min_depth, --cache) and
`helper` with stub assemblers on PATH, through both CLIs. Every output
file, every printed line and every exit code must be the JAX package's."""

import contextlib
import gc
import io
import os
import random
import stat
from pathlib import Path

import pytest

from autocycler_tpu import cli as jax_cli
from autocycler_tpu.utils import rust_rand as jax_rr
from autocycler_tpu_torch import cli
from autocycler_tpu_torch.commands.cluster import cluster
from autocycler_tpu_torch.commands.combine import combine
from autocycler_tpu_torch.commands.compress import compress
from autocycler_tpu_torch.commands.resolve import resolve
from autocycler_tpu_torch.commands.subsample import parse_genome_size
from autocycler_tpu_torch.commands.trim import trim
from autocycler_tpu_torch.utils import AutocyclerError
from autocycler_tpu_torch.utils import rust_rand as rr

from fixtures_gfa import (TEST_GFA_1, TEST_GFA_2, TEST_GFA_4, TEST_GFA_5,
                          TEST_GFA_8, TEST_GFA_9, TEST_GFA_10, TEST_GFA_13,
                          TEST_GFA_14)
from synthetic import make_assemblies

PACKAGES = (("jax", jax_cli.main), ("port", cli.main))


def _run(main, argv, capsys):
    """One CLI call: (exit code, stdout)."""
    capsys.readouterr()
    try:
        with contextlib.redirect_stderr(io.StringIO()):
            rc = main([str(a) for a in argv])
    finally:
        gc.enable()
    return rc, capsys.readouterr().out


def _files(root: Path):
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def _both(tmp_path, capsys, argv_for):
    """Runs ``argv_for(out_dir)`` through both CLIs, each into its own
    directory; returns {package: (rc, stdout, files)}."""
    got = {}
    for name, main in PACKAGES:
        out = tmp_path / name
        out.mkdir(exist_ok=True)
        rc, stdout = _run(main, argv_for(out), capsys)
        got[name] = (rc, stdout, _files(out))
    return got


# ---------------- the StdRng shuffle ----------------

def test_self_test_passes_in_both():
    assert rr.self_test() is True and jax_rr.self_test() is True


@pytest.mark.parametrize("n,seed", [(0, 0), (1, 3), (2, 0), (17, 1),
                                    (1000, 0), (1000, 42), (4099, 2**63 + 5)])
def test_shuffled_order_equals_jax(n, seed):
    assert rr.std_rng_shuffled_order(n, seed) == \
        jax_rr.std_rng_shuffled_order(n, seed)


@pytest.mark.parametrize("seed", [0, 1, 12345, 2**64 - 1])
def test_rng_pieces_equal_jax(seed):
    assert rr.seed_from_u64(seed) == jax_rr.seed_from_u64(seed)
    key = [int.from_bytes(rr.seed_from_u64(seed)[i:i + 4], "little")
           for i in range(0, 32, 4)]
    for rounds in (12, 20):
        assert rr.chacha_block(key, [seed & 0xFFFFFFFF, 0, 0, 0], rounds) == \
            jax_rr.chacha_block(key, [seed & 0xFFFFFFFF, 0, 0, 0], rounds)
    a = rr.ChaCha12Rng(rr.seed_from_u64(seed))
    b = jax_rr.ChaCha12Rng(jax_rr.seed_from_u64(seed))
    for bound in (1, 2, 3, 1000, 2**31 + 1, 2**32):
        assert rr.random_range_u32(a, bound) == jax_rr.random_range_u32(b, bound)
    assert [rr._calculate_bound_u32(m) for m in (1, 2, 9, 1000, 70000)] == \
        [jax_rr._calculate_bound_u32(m) for m in (1, 2, 9, 1000, 70000)]


# ---------------- subsample ----------------

def _fastq(path: Path, n_reads: int, seed: int) -> Path:
    rng = random.Random(seed)
    with open(path, "w") as f:
        for i in range(n_reads):
            seq = "".join(rng.choice("ACGT")
                          for _ in range(rng.randint(200, 900)))
            qual = "".join(rng.choice("!+5?I") for _ in seq)
            f.write(f"@read_{i} extra={i % 7}\n{seq}\n+\n{qual}\n")
    return path


@pytest.mark.parametrize("count,depth,seed", [(4, 25.0, 0), (2, 3.0, 7),
                                              (5, 10.0, 99)])
def test_subsample_files_equal_jax(tmp_path, capsys, count, depth, seed):
    reads = _fastq(tmp_path / "reads.fastq", 240, seed=count)
    got = _both(tmp_path, capsys, lambda out: [
        "subsample", "-r", reads, "-o", out / "subs", "-g", "2k",
        "--count", count, "--min_read_depth", depth, "--seed", seed])
    assert got["port"] == got["jax"]
    rc, _, files = got["port"]
    assert rc == 0 and "subs/subsample.yaml" in files
    assert b"shuffle: rust-stdrng-0.9" in files["subs/subsample.yaml"]
    assert len([f for f in files if f.endswith(".fastq")]) == count


@pytest.mark.parametrize("argv", [
    ["-g", "0"], ["-g", "15kg"], ["-g", "2k", "--count", "1"],
    ["-g", "2k", "--min_read_depth", "0"],
    ["-g", "100m"]])                     # too shallow to subset
def test_subsample_errors_equal_jax(tmp_path, capsys, argv):
    reads = _fastq(tmp_path / "reads.fastq", 20, seed=1)
    got = _both(tmp_path, capsys, lambda out: [
        "subsample", "-r", reads, "-o", out / "subs", *argv])
    assert got["port"][:2] == got["jax"][:2] == (1, "")


@pytest.mark.parametrize("text", ["100", "5000.9", " 435 ", "12.0k", "47K",
                                  "13.1M", "1.23456G"])
def test_parse_genome_size_equals_jax(text):
    from autocycler_tpu.commands.subsample import parse_genome_size as jax_pgs
    assert parse_genome_size(text) == jax_pgs(text)


# ---------------- table ----------------

@pytest.fixture(scope="module")
def pipeline_dir(tmp_path_factory):
    """The port's whole small pipeline on the CPU, with a subsample.yaml."""
    tmp = tmp_path_factory.mktemp("pipeline")
    asm = make_assemblies(tmp, n_assemblies=3, chromosome_len=3000,
                          plasmid_len=600, seed=21)
    out = tmp / "out"
    with contextlib.redirect_stderr(io.StringIO()):
        compress(asm, out, device="cpu")
        cluster(out, device="cpu")
        clusters = sorted((out / "clustering/qc_pass").iterdir())
        for c in clusters:
            trim(c, device="cpu")
            resolve(c, device="cpu")
        combine(out, [c / "5_final.gfa" for c in clusters])
        reads = _fastq(tmp / "reads.fastq", 120, seed=3)
        cli.main(["subsample", "-r", str(reads), "-o", str(out / "subs"),
                  "-g", "2k", "--min_read_depth", "5"])
    return out


@pytest.mark.parametrize("argv", [
    [],
    ["-n", "sample1"],
    ["-n", "s2", "-s", "2"],
    ["-n", "s3", "-f", "input_assemblies_count,compressed_unitig_count,"
     "input_assembly_details,untrimmed_cluster_size,output_reads,"
     "consensus_assembly_clusters,shuffle"],
    ["-n", "s4", "-f", "pass_cluster_count , cluster_balance_score", "-s", "5"]])
def test_table_equals_jax(pipeline_dir, capsys, argv):
    results = {}
    for name, main in PACKAGES:
        extra = ["-a", pipeline_dir] if argv else []
        results[name] = _run(main, ["table", *extra, *argv], capsys)
    assert results["port"] == results["jax"]
    rc, out = results["port"]
    assert rc == 0 and out.count("\n") == 1


def test_table_row_fields_are_the_yaml_values(pipeline_dir, capsys):
    _, header = _run(cli.main, ["table"], capsys)
    _, row = _run(cli.main, ["table", "-a", pipeline_dir, "-n", "x"], capsys)
    fields = dict(zip(header.rstrip("\n").split("\t"),
                      row.rstrip("\n").split("\t")))
    assert fields["name"] == "x"
    yaml_text = (pipeline_dir / "clustering/clustering.yaml").read_text()
    assert f"pass_cluster_count: {fields['pass_cluster_count']}\n" in yaml_text
    consensus = (pipeline_dir / "consensus_assembly.yaml").read_text()
    assert "consensus_assembly_fully_resolved: " \
        f"{fields['consensus_assembly_fully_resolved']}" in consensus
    assert fields["input_read_count"] == "120"


@pytest.mark.parametrize("argv", [["-f", "bogus"], ["-s", "0"],
                                  ["-a", "missing_dir"], ["-n", "a\tb", "-a", "."]])
def test_table_errors_equal_jax(tmp_path, capsys, argv, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert _run(cli.main, ["table", *argv], capsys) == \
        _run(jax_cli.main, ["table", *argv], capsys) == (1, "")


# ---------------- gfa2fasta ----------------

@pytest.mark.parametrize("text", [TEST_GFA_1, TEST_GFA_2, TEST_GFA_5,
                                  TEST_GFA_8, TEST_GFA_9, TEST_GFA_10,
                                  TEST_GFA_13, TEST_GFA_14])
def test_gfa2fasta_equals_jax(tmp_path, capsys, text):
    (tmp_path / "in.gfa").write_text(text)
    got = _both(tmp_path, capsys, lambda out: [
        "gfa2fasta", "-i", tmp_path / "in.gfa", "-o", out / "out.fasta"])
    assert got["port"] == got["jax"] and got["port"][0] == 0


def test_gfa2fasta_of_a_final_graph(pipeline_dir, tmp_path, capsys):
    final = sorted(pipeline_dir.glob("clustering/qc_pass/*/5_final.gfa"))[0]
    got = _both(tmp_path, capsys, lambda out: [
        "gfa2fasta", "-i", final, "-o", out / "final.fasta"])
    assert got["port"] == got["jax"]
    assert b"circular=true topology=circular" in \
        got["port"][2]["final.fasta"]


# ---------------- clean ----------------

@pytest.mark.parametrize("text,options", [
    (TEST_GFA_5, ["-r", "2,4"]), (TEST_GFA_4, ["-d", "2"]),
    (TEST_GFA_5, ["-m", "1.5"]), (TEST_GFA_1, ["-r", "3", "-m", "0.5"]),
    (TEST_GFA_4, ["-r", "99"]), (TEST_GFA_4, ["-r", "1,x"])])
def test_clean_equals_jax(tmp_path, capsys, text, options):
    (tmp_path / "in.gfa").write_text(text)
    got = _both(tmp_path, capsys, lambda out: [
        "clean", "-i", tmp_path / "in.gfa", "-o", out / "out.gfa", *options])
    assert got["port"] == got["jax"]


def _stale_cache_dir(root: Path) -> Path:
    """An autocycler dir holding everything `clean --cache` purges and
    things it keeps."""
    cache = root / ".cache"
    cache.mkdir(parents=True)
    for name in ("asm-aa-k51.npz", "repair-bb-k51.npz", "sketch-cc-k21w11s8.npz",
                 "asm-dd-k51.npz.999999999.ab.tmp", "notes.txt"):
        (cache / name).write_bytes(b"x" * 10)
    (root / "timeseries.jsonl").write_text("{}\n")
    (root / "lint_report.json").write_text("{}\n")
    (root / "lint_baseline.json").write_text("{}\n")
    run = root / ".stream" / "run-12345-ab"
    run.mkdir(parents=True)
    (run / "bin_0000.bin").write_bytes(b"y" * 20)
    (run / "manifest.json").write_text('{"pid": 999999999}')
    (root / "input_assemblies.gfa").write_text("H\tVN:Z:1.0\n")
    return root


def test_clean_cache_equals_jax(tmp_path, capsys):
    got = {}
    for name, main in PACKAGES:
        root = _stale_cache_dir(tmp_path / name)
        capsys.readouterr()
        err = io.StringIO()
        try:
            with contextlib.redirect_stderr(err):
                rc = main(["clean", "--cache", str(root)])
        finally:
            gc.enable()
        # the JAX CLI prints its banner first
        got[name] = (rc, _files(root), err.getvalue().replace(
            jax_cli.BANNER + "\n", "").replace(str(root), "<dir>"))
    assert got["port"] == got["jax"]
    rc, files, err = got["port"]
    assert rc == 0 and sorted(files) == [
        ".cache/notes.txt", "input_assemblies.gfa", "lint_baseline.json"]
    assert "Purged warm-start cache under <dir>: 4 entries" in err


def test_clean_cache_and_graph_together(tmp_path, capsys):
    (tmp_path / "in.gfa").write_text(TEST_GFA_5)
    got = _both(tmp_path, capsys, lambda out: [
        "clean", "--cache", _stale_cache_dir(out / "auto"),
        "-i", tmp_path / "in.gfa", "-o", out / "out.gfa", "-r", "2"])
    assert got["port"] == got["jax"] and got["port"][0] == 0
    assert "out.gfa" in got["port"][2]


# ---------------- helper, with stub assemblers on PATH ----------------

FLYE = r"""
out_dir=""
while [[ $# -gt 0 ]]; do
  case "$1" in
    --out-dir) out_dir=$2; shift 2;;
    *) shift;;
  esac
done
mkdir -p "$out_dir"
printf '>contig_1\nACGTACGTAC\n>contig_2\nGGGGCCCC\n' > "$out_dir/assembly.fasta"
printf '#seq_name\tlength\tcov.\tcirc.\ncontig_1\t10\t30\tY\ncontig_2\t8\t2\tN\n' > "$out_dir/assembly_info.txt"
printf 'log line\n' > "$out_dir/flye.log"
printf 'H\tVN:Z:1.0\n' > "$out_dir/assembly_graph.gfa"
"""


def _stub(bin_dir: Path, name: str, script: str) -> None:
    path = bin_dir / name
    path.write_text("#!/usr/bin/env bash\n" + script)
    path.chmod(path.stat().st_mode | stat.S_IEXEC)


@pytest.fixture
def stub_path(tmp_path, monkeypatch):
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    monkeypatch.setenv("PATH", f"{bin_dir}:{os.environ['PATH']}")
    reads = tmp_path / "reads.fastq"
    reads.write_text("@r1\nACGTACGTACGT\n+\nIIIIIIIIIIII\n")
    return bin_dir, reads


@pytest.mark.parametrize("stubs,argv", [
    ({"flye": FLYE}, ["flye", "-o", "{out}/asm/flye_01"]),
    ({"flye": FLYE}, ["flye", "-o", "{out}/f", "--min_depth_rel", "0.1",
                      "--read_type", "pacbio_hifi"]),
    ({"raven": 'printf ">c1\\nACGTACGTACGTACGTACGT\\n"\n'}, ["genome_size"]),
    ({"raven": "echo oops >&2; exit 3\n"}, ["raven", "-o", "{out}/r"]),
    ({"raven": "exit 3\n"}, ["raven", "-o", "{out}/r", "--retries", "1",
                            "--timeout", "30"]),
    ({}, ["raven", "-o", "{out}/r"]),                 # not on PATH
    ({"flye": FLYE}, ["flye"]),                       # no --out_prefix
    ({}, ["bogus", "-o", "{out}/x"])])
def test_helper_equals_jax(tmp_path, capsys, stub_path, stubs, argv):
    bin_dir, reads = stub_path
    for name, script in stubs.items():
        _stub(bin_dir, name, script)
    got = {}
    for name, main in PACKAGES:
        out = tmp_path / name
        out.mkdir()
        args = [a.replace("{out}", str(out)) for a in argv]
        got[name] = (*_run(main, ["helper", *args[:1], "-r", reads,
                                  "-d", tmp_path / f"work_{name}", *args[1:]],
                           capsys), _files(out))
    assert got["port"] == got["jax"]
    if not stubs or argv[0] == "bogus" or argv == ["flye"]:
        assert got["port"][0] == 1


@pytest.mark.parametrize("flags,env,attempts", [
    ([], {}, 1),
    (["--retries", "2"], {}, 3),
    ([], {"AUTOCYCLER_SUBPROCESS_RETRIES": "1"}, 2),
    (["--retries", "0"], {"AUTOCYCLER_SUBPROCESS_RETRIES": "2"}, 1)])
def test_helper_retries_reach_every_assembler_call(tmp_path, capsys, stub_path,
                                                   monkeypatch, flags, env,
                                                   attempts):
    """--retries, else AUTOCYCLER_SUBPROCESS_RETRIES, sets the attempts of
    the assembler's launch; the flag wins over the knob."""
    from autocycler_tpu_torch.utils import resilience
    monkeypatch.setattr(resilience, "_BACKOFF_SECONDS", 0.0)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    bin_dir, reads = stub_path
    calls = tmp_path / "calls"
    _stub(bin_dir, "raven", f'echo x >> "{calls}"; exit 3\n')
    rc, _ = _run(cli.main, ["helper", "raven", "-r", reads, "-o", tmp_path / "r",
                            "-d", tmp_path / "w", *flags], capsys)
    assert rc == 0          # a failed assembler is logged, not fatal
    assert calls.read_text().count("x") == attempts


def test_helper_missing_program_message(tmp_path, stub_path):
    from autocycler_tpu_torch.commands.helper import helper
    _, reads = stub_path
    with pytest.raises(AutocyclerError,
                       match="required program 'raven' not found"):
        helper("raven", reads, out_prefix=tmp_path / "r",
               directory=tmp_path / "w")
