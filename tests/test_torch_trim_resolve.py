"""The port's trim, resolve and combine against the JAX package's on the CPU:
a JAX compress and cluster, then both packages' trim → resolve → combine on
copies of the same tree, must write byte-identical files (2_trimmed.gfa and
.yaml, 3_bridged.gfa, 4_merged.gfa, 5_final.gfa and
consensus_assembly.{gfa,fasta,yaml}). The inputs trim start-end overlaps and
hairpins (one at both ends, which needs the port's second device round) and
make resolve cull conflicting bridges."""

import contextlib
import io
import random
import re
import shutil

import numpy as np
import pytest

from autocycler_tpu.commands.cluster import cluster as jax_cluster
from autocycler_tpu.commands.combine import combine as jax_combine
from autocycler_tpu.commands.compress import compress as jax_compress
from autocycler_tpu.commands.resolve import resolve as jax_resolve
from autocycler_tpu.commands.trim import trim as jax_trim
from autocycler_tpu_torch import cli, device
from autocycler_tpu_torch.commands.combine import combine
from autocycler_tpu_torch.commands.resolve import resolve
from autocycler_tpu_torch.commands.trim import trim

from synthetic import make_assemblies, mutate, random_genome, revcomp

STAGE_FILES = ("2_trimmed.gfa", "2_trimmed.yaml", "3_bridged.gfa",
               "4_merged.gfa", "5_final.gfa")
COMBINE_FILES = ("consensus_assembly.gfa", "consensus_assembly.fasta",
                 "consensus_assembly.yaml")


def _logged(fn, *args, **kwargs) -> str:
    """What ``fn`` logs, without the section headers' clock times."""
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        fn(*args, **kwargs)
    return re.sub(r"\d{4}-\d\d-\d\d \d\d:\d\d:\d\d", "", err.getvalue())


def _write_assemblies(root, contigs_per_assembly):
    asm = root / "assemblies"
    asm.mkdir()
    for i, contigs in enumerate(contigs_per_assembly, start=1):
        (asm / f"assembly_{i}.fasta").write_text("".join(
            f">contig_{j}\n{seq}\n" for j, seq in enumerate(contigs, start=1)))
    return asm


def append_start_overlaps(asm_dir, rng, chromosome_range, plasmid_range):
    """Append to each contig its own first L bases, L uniform in the range
    of its replicon (chromosome first in each file, then plasmid), in
    assembly order: the start-end overlap a circular contig's assembler
    leaves."""
    for path in sorted(asm_dir.glob("assembly_*.fasta"),
                       key=lambda p: int(p.stem.split("_")[1])):
        lines = path.read_text().splitlines()
        for i, (low, high) in zip((1, 3), (chromosome_range, plasmid_range)):
            lines[i] += lines[i][:int(rng.integers(low, high + 1))]
        path.write_text("\n".join(lines) + "\n")
    return asm_dir


def _clean(root):
    return make_assemblies(root, n_assemblies=4, seed=42)


def _snps(root):
    return make_assemblies(root, n_assemblies=5, n_snps=5, seed=13)


def _start_end_overlaps(root):
    asm = make_assemblies(root, n_assemblies=4, n_snps=3, seed=5)
    return append_start_overlaps(asm, np.random.default_rng(11),
                                 (200, 2000), (100, 600))


def _stem_loop(root):
    rng = random.Random(1)
    stem = random_genome(rng, 600)
    loop = random_genome(rng, 200)
    genome = stem + loop + revcomp(stem)
    return _write_assemblies(root, [[genome], [mutate(rng, genome, 2)],
                                    [mutate(rng, genome, 2)]])


def _hairpin_both_ends(root):
    rng = random.Random(1)
    body = random_genome(rng, 3000)
    contig = revcomp(body[:300]) + body + revcomp(body[-400:])
    return _write_assemblies(root, [[mutate(rng, contig, 2)]
                                    for _ in range(3)])


def _inversion(root):
    rng = random.Random(0)
    a, b, c = (random_genome(rng, 2000) for _ in range(3))
    return _write_assemblies(root, [[a + b + c]] * 3 + [
        [mutate(rng, a + revcomp(b) + c, 3)] for _ in range(2)])


def _tandem_repeat(root):
    rng = random.Random(0)
    unit = random_genome(rng, 120)
    core = random_genome(rng, 800) + unit * 8 + random_genome(rng, 800)
    return _write_assemblies(root, [[core], [mutate(rng, core, 2)],
                                    [mutate(rng, core, 2)]])


def _clustered(tmp_path, make):
    """JAX compress + cluster, copied: (jax tree, port tree, cluster names)."""
    asm = make(tmp_path)
    _logged(jax_compress, asm, tmp_path / "jax", 51, threads=1)
    _logged(jax_cluster, tmp_path / "jax")
    shutil.copytree(tmp_path / "jax", tmp_path / "port")
    names = sorted(p.name for p in
                   (tmp_path / "jax/clustering/qc_pass").iterdir())
    assert names
    return tmp_path / "jax", tmp_path / "port", names


def _assert_same(jax_dir, port_dir, names, files=STAGE_FILES):
    for name in names:
        for f in files:
            rel = f"clustering/qc_pass/{name}/{f}"
            assert (port_dir / rel).read_bytes() == \
                (jax_dir / rel).read_bytes(), rel


def _pipelines(jax_dir, port_dir, names):
    """Both packages' trim → resolve → combine; returns the logs."""
    logs = {"jax": "", "port": ""}
    device.reset_counts()
    for name in names:
        jc = jax_dir / "clustering/qc_pass" / name
        pc = port_dir / "clustering/qc_pass" / name
        logs["jax"] += _logged(jax_trim, jc) + _logged(jax_resolve, jc)
        logs["port"] += _logged(trim, pc, device="cpu") + \
            _logged(resolve, pc, device="cpu")
    for key, root, fn in (("jax", jax_dir, jax_combine),
                          ("port", port_dir, combine)):
        gfas = [root / "clustering/qc_pass" / n / "5_final.gfa" for n in names]
        logs[key] += _logged(fn, root, gfas)
    return logs


CASES = {"clean": _clean, "snps": _snps,
         "start_end_overlaps": _start_end_overlaps, "stem_loop": _stem_loop,
         "hairpin_both_ends": _hairpin_both_ends, "inversion": _inversion,
         "tandem_repeat": _tandem_repeat}


@pytest.mark.parametrize("case", sorted(CASES))
def test_trim_resolve_combine_byte_identical_to_jax(tmp_path, case):
    jax_dir, port_dir, names = _clustered(tmp_path, CASES[case])
    logs = _pipelines(jax_dir, port_dir, names)
    _assert_same(jax_dir, port_dir, names)
    for f in COMBINE_FILES:
        assert (port_dir / f).read_bytes() == (jax_dir / f).read_bytes(), f
    assert logs["port"] == logs["jax"].replace("/jax/", "/port/")
    trim_dp = device.dp_summary("trim_overlap_dp")
    if case == "start_end_overlaps":
        assert logs["port"].count("trimmed to ") == 8
        assert trim_dp["dispatches"] >= 1
    if case == "stem_loop":
        assert "trimmed from start to" in logs["port"]
    if case == "hairpin_both_ends":
        assert logs["port"].count("trimmed from start and end to 3000 bp") == 3
        # the hairpin-end DPs on the start-trimmed paths: a second round
        assert trim_dp["dispatches"] >= 2
    if case == "inversion":
        assert "Conflicting bridges: 4" in logs["port"]
        assert "2 conflicting bridges culled" in logs["port"]
    if case == "clean":
        assert "Consensus assembly is fully resolved" in logs["port"]
    if case == "snps":
        assert device.dp_summary("resolve_medoid_dp")["dispatches"] >= 1


@pytest.mark.parametrize("options", [dict(min_identity=0.99),
                                     dict(max_unitigs=0),
                                     dict(max_unitigs=3),
                                     dict(mad=0.0), dict(mad=0.5)])
def test_trim_options_byte_identical_to_jax(tmp_path, options):
    jax_dir, port_dir, names = _clustered(tmp_path, _start_end_overlaps)
    for name in names:
        _logged(jax_trim, jax_dir / "clustering/qc_pass" / name, **options)
        _logged(trim, port_dir / "clustering/qc_pass" / name, device="cpu",
                **options)
    _assert_same(jax_dir, port_dir, names, ("2_trimmed.gfa", "2_trimmed.yaml"))


def test_cli_trim_resolve_combine(tmp_path, monkeypatch):
    """The CLI's subcommands, with their device resolved to the CPU: flags
    reach the commands, and the files equal the JAX package's."""
    from autocycler_tpu_torch.commands import resolve as resolve_mod
    from autocycler_tpu_torch.commands import trim as trim_mod

    jax_dir, port_dir, names = _clustered(tmp_path, _hairpin_both_ends)
    for module in (trim_mod, resolve_mod):
        monkeypatch.setattr(module, "resolve_device",
                            lambda dev=None: device.torch.device("cpu"))
    gfas = []
    for name in names:
        jc = jax_dir / "clustering/qc_pass" / name
        pc = port_dir / "clustering/qc_pass" / name
        _logged(jax_trim, jc, min_identity=0.8, mad=4.0)
        _logged(jax_resolve, jc, verbose=True)
        for argv in (["trim", "-c", pc, "--min_identity", "0.8", "--mad",
                      "4.0", "-t", "2"], ["resolve", "-c", pc, "--verbose"]):
            with contextlib.redirect_stderr(io.StringIO()):
                assert cli.main([str(a) for a in argv]) == 0
        gfas.append(str(pc / "5_final.gfa"))
    _logged(jax_combine, jax_dir,
            [jax_dir / "clustering/qc_pass" / n / "5_final.gfa" for n in names])
    with contextlib.redirect_stderr(io.StringIO()):
        assert cli.main(["combine", "-a", str(port_dir), "-i", *gfas]) == 0
    _assert_same(jax_dir, port_dir, names)
    for f in COMBINE_FILES:
        assert (port_dir / f).read_bytes() == (jax_dir / f).read_bytes(), f
