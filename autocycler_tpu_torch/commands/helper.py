"""`autocycler helper`: uniform wrappers around 14 long-read assembler
toolchains.

Parity target: reference helper.rs — tasks genome_size (via Raven) plus 13
assembler pipelines (Canu, Flye, Hifiasm, Ilesta+Minipolish, LJA, metaMDBG,
miniasm+minimap2+Minipolish, Myloasm, NECAT, NextDenovo+NextPolish,
Plassembler, Raven, Redbean/wtdbg2). Outputs are normalised to
``prefix.fasta`` (plus ``.gfa``/``.log`` where available) with depth and
circularity stamped into headers; a depth filter (--min_depth_abs /
--min_depth_rel) can drop low-coverage contigs; subprocess failures are
reported but not fatal — the consensus design tolerates individual assembler
failures (reference helper.rs:645-654).
"""

from __future__ import annotations

import functools
import os
import random
import re
import shutil
import signal
import sys
import tempfile
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

from ..utils import is_fasta_empty, load_fasta, log, quit_with_error, total_fasta_length
from ..utils import resilience
from ..utils.resilience import SubprocessError
from .subsample import parse_genome_size

READ_TYPES = ("ont_r9", "ont_r10", "pacbio_clr", "pacbio_hifi")


# ---------------- subprocess plumbing ----------------

def check_requirements(programs: List[str]) -> None:
    for cmd in programs:
        if shutil.which(cmd) is None:
            quit_with_error(f"required program '{cmd}' not found in $PATH")


def run_command(cmd: List[str], stdout_file=None, cwd=None, timeout=None,
                retries=None) -> None:
    """Run a subprocess; failure is printed but NOT fatal
    (reference helper.rs:645-654).

    Execution goes through the hardened resilience runner
    (utils.resilience.run_command): per-command timeout and bounded
    retries with backoff (``--timeout``/``--retries`` flags or the
    AUTOCYCLER_SUBPROCESS_* env vars), stderr tails captured into the
    logged :class:`SubprocessError`, and partial stdout files removed on
    failure so `copy_output_file` never mistakes them for real output."""
    log.message()
    log.message(" ".join(f'"{c}"' if " " in str(c) else str(c) for c in cmd))
    log.message()
    try:
        resilience.run_command(cmd, stdout_file=stdout_file, cwd=cwd,
                               timeout=timeout, retries=retries)
    except SubprocessError as e:
        log.message(str(e))
    except FileNotFoundError as e:
        quit_with_error(f"failed to launch {cmd[0]}: {e}")


def add_extension(prefix, extension: str) -> Path:
    return Path(str(prefix) + "." + extension)


def copy_output_file(src, dest) -> None:
    src, dest = Path(src), Path(dest)
    if not src.exists() or src.stat().st_size == 0:
        if Path(dest).exists():
            os.remove(dest)
        return
    shutil.copy(src, dest)


def copy_fasta(src, dest) -> None:
    """Copy a (possibly gzipped, possibly wrapped) FASTA to an uncompressed
    one-line-per-sequence FASTA (reference helper.rs:622-631)."""
    src = Path(src)
    if not src.exists() or is_fasta_empty(src):
        if Path(dest).exists():
            os.remove(dest)
        return
    with open(dest, "w") as f:
        for _, header, seq in load_fasta(src):
            f.write(f">{header}\n{seq}\n")


# ---------------- output normalisation ----------------

def gfa_to_fasta(gfa, fasta) -> None:
    """GFA S-lines -> FASTA with circularity (name ending 'c') and depth
    (dp:f: / rd:i: tags) in headers (reference helper.rs:682-698)."""
    gfa = Path(gfa)
    if not gfa.exists() or gfa.stat().st_size == 0:
        return
    with open(gfa) as r, open(fasta, "w") as w:
        for line in r:
            if not line.startswith("S"):
                continue
            cols = line.rstrip("\n").split("\t")
            name = cols[1] if len(cols) > 1 else ""
            seq = cols[2] if len(cols) > 2 else ""
            depth = None
            for field in cols[3:]:
                if field.startswith("dp:f:"):
                    depth = field[5:]
                    break
            if depth is None:
                for field in cols[3:]:
                    if field.startswith("rd:i:"):
                        depth = field[5:]
                        break
            header = f">{name}"
            if name.endswith("c"):
                header += " circular=true"
            if depth is not None:
                header += f" depth={depth}"
            w.write(f"{header}\n{seq}\n")


def load_flye_assembly_info(assembly_info) -> Dict[str, Tuple[bool, str]]:
    info: Dict[str, Tuple[bool, str]] = {}
    with open(assembly_info) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            cols = line.rstrip("\n").split("\t")
            if len(cols) < 4:
                continue
            info[cols[0]] = (cols[3] == "Y", cols[2])
    return info


def copy_flye_fasta(src, assembly_info, dest) -> None:
    """Stamp Flye's circularity/depth info into the FASTA headers
    (reference helper.rs:701-715)."""
    src = Path(src)
    if not src.exists() or is_fasta_empty(src):
        return
    info = load_flye_assembly_info(assembly_info)
    with open(dest, "w") as f:
        for name, _, seq in load_fasta(src):
            header = name
            if name in info:
                circ, depth = info[name]
                if circ:
                    header += " circular=true"
                header += f" depth={depth}"
            f.write(f">{header}\n{seq}\n")


def load_canu_assembly_depth(assembly_info) -> Dict[str, str]:
    info: Dict[str, str] = {}
    with open(assembly_info) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            cols = line.rstrip("\n").split("\t")
            if len(cols) < 3:
                continue
            try:
                tig_id = int(cols[0])
            except ValueError:
                continue
            info[f"tig{tig_id:08d}"] = cols[2]
    return info


def trim_canu_contig(header: str, seq: str) -> Tuple[str, str]:
    """Trim the overlap off circular Canu contigs using the trim=start-end
    header hint (reference helper.rs:756-774)."""
    if "suggestCircular=yes" not in header:
        return header, seq
    m = re.search(r"trim=(\d+)-(\d+)", header)
    if m:
        start, end = int(m.group(1)), int(m.group(2))
        if start < end and end <= len(seq):
            seq = seq[start:end]
            header = re.sub(r"trim=\d+-\d+", f"trim=0-{len(seq)}", header)
            header = re.sub(r"len=\d+", f"len={len(seq)}", header)
    return header, seq


def copy_canu_fasta(src, assembly_info, dest) -> None:
    """Copy Canu output: drop repeat/bubble contigs, trim circular overlaps,
    stamp depth (reference helper.rs:733-753)."""
    src = Path(src)
    if not src.exists() or is_fasta_empty(src):
        return
    depth = load_canu_assembly_depth(assembly_info)
    with open(dest, "w") as f:
        for name, header, seq in load_fasta(src):
            if "suggestRepeat=yes" in header or "suggestBubble=yes" in header:
                continue
            header, seq = trim_canu_contig(header, seq)
            if name in depth:
                header += f" depth={depth[name]}"
            f.write(f">{header}\n{seq}\n")


def rotate_plassembler_contigs(src, dest, seed: int = 0) -> None:
    """Randomly (seeded) rotate circular plasmids so their start points vary
    between subsamples (reference helper.rs:904-917)."""
    src = Path(src)
    if not src.exists() or is_fasta_empty(src):
        return
    rng = random.Random(seed)
    with open(dest, "w") as f:
        for _, header, seq in load_fasta(src):
            if "circular=true" in header.lower() and len(seq) > 1:
                r = rng.randrange(1, len(seq))
                seq = seq[r:] + seq[:r]
            f.write(f">{header}\n{seq}\n")


def replace_underscores_with_spaces(filename) -> None:
    filename = Path(filename)
    if not filename.exists() or filename.stat().st_size == 0:
        return
    text = filename.read_text().replace("_", " ")
    filename.write_text(text)


def depth_from_header(header: str) -> Optional[float]:
    """Extract depth=/depth-/coverage= from a contig header
    (reference helper.rs:984-993)."""
    for marker in ("depth=", "depth-", "coverage="):
        i = header.find(marker)
        if i >= 0:
            token = re.split(r"[-_ ]", header[i + len(marker):])[0]
            try:
                return float(token)
            except ValueError:
                return None
    return None


def depth_filter(out_prefix, min_depth_abs: Optional[float],
                 min_depth_rel: Optional[float]) -> None:
    """Drop contigs below the depth threshold; a missing depth on any contig
    disables filtering (reference helper.rs:932-974)."""
    if min_depth_abs is None and min_depth_rel is None:
        return
    fasta = add_extension(out_prefix, "fasta")
    if not fasta.exists() or is_fasta_empty(fasta):
        return
    records = []
    longest_len, longest_depth = 0, 0.0
    for name, header, seq in load_fasta(fasta):
        depth = depth_from_header(header)
        if depth is None:
            return
        if len(seq) > longest_len:
            longest_len, longest_depth = len(seq), depth
        records.append((name, header, seq, depth))
    threshold = min_depth_abs or 0.0
    if min_depth_rel is not None:
        threshold = max(threshold, min_depth_rel * longest_depth)
    log.message(f"Autocycler helper depth filter: threshold = {threshold:.3f}")
    kept = []
    for name, header, seq, depth in records:
        passed = depth >= threshold
        log.message(f"{name}: depth={depth:.3f}, {'PASS' if passed else 'FAIL'}")
        if passed:
            kept.append((header, seq))
    if not kept:
        os.remove(fasta)
        return
    with open(fasta, "w") as f:
        for header, seq in kept:
            f.write(f">{header}\n{seq}\n")


def delete_fasta_if_empty(out_prefix) -> None:
    fasta = add_extension(out_prefix, "fasta")
    if fasta.exists() and is_fasta_empty(fasta):
        os.remove(fasta)


# ---------------- config-file generation ----------------

def make_necat_files(reads, directory, genome_size: int, threads: int) -> None:
    """NECAT read list + config (reference helper.rs:790-825)."""
    directory = Path(directory)
    (directory / "read_list.txt").write_text(f"{Path(reads).resolve()}\n")
    (directory / "config.txt").write_text("\n".join([
        "PROJECT=necat",
        "ONT_READ_LIST=read_list.txt",
        f"GENOME_SIZE={genome_size}",
        f"THREADS={threads}",
        "MIN_READ_LENGTH=3000",
        "PREP_OUTPUT_COVERAGE=40",
        "OVLP_FAST_OPTIONS=-n 500 -z 20 -b 2000 -e 0.5 -j 0 -u 1 -a 1000",
        "OVLP_SENSITIVE_OPTIONS=-n 500 -z 10 -e 0.5 -j 0 -u 1 -a 1000",
        "CNS_FAST_OPTIONS=-a 2000 -x 4 -y 12 -l 1000 -e 0.5 -p 0.8 -u 0",
        "CNS_SENSITIVE_OPTIONS=-a 2000 -x 4 -y 12 -l 1000 -e 0.5 -p 0.8 -u 0",
        "TRIM_OVLP_OPTIONS=-n 100 -z 10 -b 2000 -e 0.5 -j 1 -u 1 -a 400",
        "ASM_OVLP_OPTIONS=-n 100 -z 10 -b 2000 -e 0.5 -j 1 -u 0 -a 400",
        "NUM_ITER=2",
        "CNS_OUTPUT_COVERAGE=30",
        "CLEANUP=1",
        "USE_GRID=false",
        "GRID_NODE=0",
        "GRID_OPTIONS=",
        "SMALL_MEMORY=0",
        "FSA_OL_FILTER_OPTIONS=",
        "FSA_ASSEMBLE_OPTIONS=",
        "FSA_CTG_BRIDGE_OPTIONS=",
        "POLISH_CONTIGS=true",
    ]) + "\n")


def make_nextdenovo_files(directory, reads, genome_size: int, threads: int,
                          read_type: str) -> None:
    """NextDenovo + NextPolish configs (reference helper.rs:828-867)."""
    directory = Path(directory)
    lgs_or_hifi, nd_read_type, map_preset = {
        "ont_r9": ("lgs", "ont", "map-ont"),
        "ont_r10": ("lgs", "ont", "map-ont"),  # lr:hq breaks NextPolish
        "pacbio_clr": ("lgs", "clr", "map-pb"),
        "pacbio_hifi": ("hifi", "hifi", "map-hifi"),
    }[read_type]
    (directory / "input.fofn").write_text(f"{Path(reads).resolve()}\n")
    (directory / "nextdenovo_run.cfg").write_text(
        "[General]\n"
        "job_type = local\njob_prefix = nextDenovo\ntask = all\n"
        "rewrite = yes\ndeltmp = yes\nparallel_jobs = 1\ninput_type = raw\n"
        f"read_type = {nd_read_type}\n"
        "input_fofn = input.fofn\nworkdir = nextdenovo\n\n"
        "[correct_option]\n"
        "read_cutoff = 1k\n"
        f"genome_size = {genome_size}\n"
        f"sort_options = -m 20g -t {threads}\n"
        f"minimap2_options_raw = -t {threads}\n"
        "pa_correction = 1\n"
        f"correction_options = -p {threads}\n\n"
        "[assemble_option]\n"
        f"minimap2_options_cns = -t {threads}\n"
        "nextgraph_options = -a 1\n")
    (directory / "nextpolish_run.cfg").write_text(
        "[General]\n"
        "job_type = local\njob_prefix = nextPolish\ntask = best\n"
        "rewrite = yes\ndeltmp = yes\nrerun = 3\nparallel_jobs = 1\n"
        f"multithread_jobs = {threads}\n"
        "genome = nextdenovo/03.ctg_graph/nd.asm.fasta\n"
        "genome_size = auto\nworkdir = nextpolish\n"
        f"polish_options = -p {threads}\n\n"
        f"[{lgs_or_hifi}_option]\n"
        f"{lgs_or_hifi}_fofn = input.fofn\n"
        f"{lgs_or_hifi}_options = -min_read_len 1k -max_depth 100\n"
        f"{lgs_or_hifi}_minimap2_options = -x {map_preset} -t {threads}\n")


def find_plassembler_db() -> Path:
    db = os.environ.get("PLASSEMBLER_DB")
    if db and Path(db).is_dir():
        return Path(db)
    conda = os.environ.get("CONDA_PREFIX")
    if conda and (Path(conda) / "plassembler_db").is_dir():
        return Path(conda) / "plassembler_db"
    quit_with_error("No Plassembler database found. Set PLASSEMBLER_DB or ensure "
                    "$CONDA_PREFIX/plassembler_db exists.")


def find_log_file(directory, prefix: str) -> Path:
    for p in Path(directory).iterdir():
        if p.name.startswith(prefix) and p.name.endswith(".log"):
            return p
    quit_with_error(f"{prefix} log file not found")


# ---------------- assembler runners ----------------

def _decompress_if_gzipped(reads, directory) -> Path:
    from ..utils import is_file_gzipped
    reads = Path(reads)
    if not is_file_gzipped(reads):
        return reads
    import gzip
    name = reads.name[:-3] if reads.name.endswith(".gz") else reads.name
    out = Path(directory) / name
    with gzip.open(reads, "rb") as r, open(out, "wb") as w:
        shutil.copyfileobj(r, w)
    return out


def _run_genome_size(reads, out_prefix, genome_size, threads, directory, read_type,
                     extra_args, run):
    check_requirements(["raven"])
    assembly = Path(directory) / "assembly.fasta"
    run(["raven", "--threads", threads, "--disable-checkpoints", reads]
        + extra_args, stdout_file=assembly)
    if is_fasta_empty(assembly):
        quit_with_error("Raven assembly failed")
    print(total_fasta_length(assembly))


def _run_canu(reads, out_prefix, genome_size, threads, directory, read_type,
              extra_args, run):
    gs = _require_genome_size(genome_size, "Canu")
    check_requirements(["canu"])
    input_flag = {"ont_r9": "-nanopore", "ont_r10": "-nanopore",
                  "pacbio_clr": "-pacbio", "pacbio_hifi": "-pacbio-hifi"}[read_type]
    run(["canu", "-p", "canu", "-d", directory, "-fast", f"genomeSize={gs}",
         "useGrid=false", f"maxThreads={threads}", input_flag, reads]
        + extra_args)
    d = Path(directory)
    copy_canu_fasta(d / "canu.contigs.fasta", d / "canu.contigs.layout.tigInfo",
                    add_extension(out_prefix, "fasta"))
    copy_output_file(d / "canu.report", add_extension(out_prefix, "log"))


def _run_flye(reads, out_prefix, genome_size, threads, directory, read_type,
              extra_args, run):
    check_requirements(["flye"])
    input_flag = {"ont_r9": "--nano-raw", "ont_r10": "--nano-hq",
                  "pacbio_clr": "--pacbio-raw", "pacbio_hifi": "--pacbio-hifi"}[read_type]
    run(["flye", input_flag, reads, "--threads", threads, "--out-dir",
         directory] + extra_args)
    d = Path(directory)
    copy_flye_fasta(d / "assembly.fasta", d / "assembly_info.txt",
                    add_extension(out_prefix, "fasta"))
    copy_output_file(d / "assembly_graph.gfa", add_extension(out_prefix, "gfa"))
    copy_output_file(d / "flye.log", add_extension(out_prefix, "log"))


def _run_hifiasm(reads, out_prefix, genome_size, threads, directory, read_type,
                 extra_args, run):
    check_requirements(["hifiasm"])
    cmd = ["hifiasm", "-t", threads, "-o", Path(directory) / "hifiasm", "-l", "0",
           "-f", "0"]
    if read_type != "pacbio_hifi":
        cmd.append("--ont")
    cmd += extra_args + [reads]
    run(cmd)
    d = Path(directory)
    gfa_to_fasta(d / "hifiasm.bp.p_ctg.gfa", add_extension(out_prefix, "fasta"))
    copy_output_file(d / "hifiasm.bp.p_ctg.gfa", add_extension(out_prefix, "gfa"))


_MAP_PRESET = {"ont_r9": "map-ont", "ont_r10": "lr:hq", "pacbio_clr": "map-pb",
               "pacbio_hifi": "map-hifi"}


def _run_ilesta(reads, out_prefix, genome_size, threads, directory, read_type,
                extra_args, run):
    check_requirements(["Ilesta", "minipolish", "minimap2", "racon"])
    input_reads = _decompress_if_gzipped(reads, directory)
    run(["Ilesta", "assemble", "--output-dir", directory, "--reads-fq",
         input_reads, "--threads", threads] + extra_args)
    run(["minipolish", "--threads", threads, "--minimap2-preset",
         _MAP_PRESET[read_type], reads, Path(directory) / "unitigs.gfa"],
        stdout_file=add_extension(out_prefix, "gfa"))
    gfa_to_fasta(add_extension(out_prefix, "gfa"), add_extension(out_prefix, "fasta"))


def _run_lja(reads, out_prefix, genome_size, threads, directory, read_type,
             extra_args, run):
    check_requirements(["lja"])
    run(["lja", "--output-dir", directory, "--reads", reads, "--threads",
         threads] + extra_args)
    d = Path(directory)
    copy_fasta(d / "assembly.fasta", add_extension(out_prefix, "fasta"))
    copy_output_file(d / "mdbg.gfa", add_extension(out_prefix, "gfa"))
    copy_output_file(d / "dbg.log", add_extension(out_prefix, "log"))


def _run_metamdbg(reads, out_prefix, genome_size, threads, directory, read_type,
                  extra_args, run):
    check_requirements(["metaMDBG"])
    input_flag = "--in-hifi" if read_type == "pacbio_hifi" else "--in-ont"
    run(["metaMDBG", "asm", "--out-dir", directory, input_flag, reads,
         "--threads", threads] + extra_args)
    d = Path(directory)
    copy_fasta(d / "contigs.fasta.gz", add_extension(out_prefix, "fasta"))
    copy_output_file(d / "metaMDBG.log", add_extension(out_prefix, "log"))


def _run_miniasm(reads, out_prefix, genome_size, threads, directory, read_type,
                 extra_args, run):
    check_requirements(["miniasm", "minipolish", "minimap2", "racon"])
    ava = {"ont_r9": "ava-ont", "ont_r10": "-k19 -Xw7 -e0 -m100",
           "pacbio_clr": "ava-pb", "pacbio_hifi": "-k23 -Xw11 -e0 -m100"}[read_type]
    d = Path(directory)
    cmd = ["minimap2", "-t", threads]
    if ava.startswith("-"):
        cmd += ava.split()
    else:
        cmd += ["-x", ava]
    cmd += [reads, reads]
    run(cmd, stdout_file=d / "overlap.paf")
    run(["miniasm", "-f", reads, d / "overlap.paf"] + extra_args,
        stdout_file=d / "unpolished.gfa")
    run(["minipolish", "--threads", threads, "--minimap2-preset",
         _MAP_PRESET[read_type], reads, d / "unpolished.gfa"],
        stdout_file=add_extension(out_prefix, "gfa"))
    gfa_to_fasta(add_extension(out_prefix, "gfa"), add_extension(out_prefix, "fasta"))


def _run_myloasm(reads, out_prefix, genome_size, threads, directory, read_type,
                 extra_args, run):
    check_requirements(["myloasm"])
    cmd = ["myloasm", "--output-dir", directory, reads, "--threads", threads]
    if read_type == "pacbio_hifi":
        cmd.append("--hifi")
    elif read_type == "ont_r10":
        cmd.append("--nano-r10")
    run(cmd + extra_args)
    d = Path(directory)
    copy_fasta(d / "assembly_primary.fa", add_extension(out_prefix, "fasta"))
    replace_underscores_with_spaces(add_extension(out_prefix, "fasta"))
    copy_output_file(d / "final_contig_graph.gfa", add_extension(out_prefix, "gfa"))
    copy_output_file(find_log_file(d, "myloasm"), add_extension(out_prefix, "log"))


def _find_necat() -> str:
    for cmd in ("necat", "necat.pl"):
        if shutil.which(cmd):
            return cmd
    quit_with_error("required program 'necat' (or 'necat.pl') not found in $PATH")


def _run_necat(reads, out_prefix, genome_size, threads, directory, read_type,
               extra_args, run):
    gs = _require_genome_size(genome_size, "NECAT")
    make_necat_files(reads, directory, gs, threads)
    run([_find_necat(), "bridge", "config.txt"] + extra_args, cwd=directory)
    copy_fasta(Path(directory) / "necat/6-bridge_contigs/polished_contigs.fasta",
               add_extension(out_prefix, "fasta"))


def _run_nextdenovo(reads, out_prefix, genome_size, threads, directory, read_type,
                    extra_args, run):
    gs = _require_genome_size(genome_size, "NextDenovo")
    check_requirements(["nextDenovo", "nextPolish"])
    make_nextdenovo_files(directory, reads, gs, threads, read_type)
    run(["nextDenovo", "nextdenovo_run.cfg"] + extra_args, cwd=directory)
    run(["nextPolish", "nextpolish_run.cfg"], cwd=directory)
    d = Path(directory)
    copy_fasta(d / "nextpolish/genome.nextpolish.fasta",
               add_extension(out_prefix, "fasta"))
    logs = sorted(d.glob("pid*.log.info"), key=lambda p: p.stat().st_mtime)
    if logs:
        with open(add_extension(out_prefix, "log"), "w") as out:
            for p in logs:
                out.write(p.read_text())


def _run_plassembler(reads, out_prefix, genome_size, threads, directory, read_type,
                     extra_args, run):
    check_requirements(["plassembler", "chopper", "dnaapler", "fastp", "mash",
                        "minimap2", "raven", "samtools", "unicycler"])
    db = find_plassembler_db()
    cmd = ["plassembler", "long", "-d", db, "-l", reads, "-o", directory, "-t",
           threads, "--force", "--skip_qc"]
    if read_type == "ont_r9":
        cmd.append("--raw_flag")
    if read_type == "pacbio_clr":
        cmd += ["--pacbio_model", "pacbio-raw"]
    if read_type == "pacbio_hifi":
        cmd += ["--pacbio_model", "pacbio-hifi"]
    run(cmd + extra_args)
    d = Path(directory)
    copy_output_file(d / "plassembler_plasmids.gfa", add_extension(out_prefix, "gfa"))
    rotate_plassembler_contigs(d / "plassembler_plasmids.fasta",
                               add_extension(out_prefix, "fasta"))
    copy_output_file(find_log_file(d, "plassembler"), add_extension(out_prefix, "log"))


def _run_raven(reads, out_prefix, genome_size, threads, directory, read_type,
               extra_args, run):
    check_requirements(["raven"])
    run(["raven", "--threads", threads, "--disable-checkpoints",
         "--graphical-fragment-assembly", add_extension(out_prefix, "gfa"),
         reads] + extra_args, stdout_file=add_extension(out_prefix, "fasta"))


def _run_redbean(reads, out_prefix, genome_size, threads, directory, read_type,
                 extra_args, run):
    gs = _require_genome_size(genome_size, "Redbean")
    check_requirements(["wtdbg2", "wtpoa-cns"])
    preset = {"ont_r9": "preset2", "ont_r10": "preset2", "pacbio_clr": "preset1",
              "pacbio_hifi": "preset4"}[read_type]
    d = Path(directory)
    run(["wtdbg2", "-x", preset, "-g", gs, "-i", reads, "-t", threads, "-f",
         "-o", d / "dbg"] + extra_args)
    run(["wtpoa-cns", "-t", threads, "-i", d / "dbg.ctg.lay.gz", "-f", "-o",
         d / "assembly.fasta"])
    copy_fasta(d / "assembly.fasta", add_extension(out_prefix, "fasta"))


def _require_genome_size(genome_size: Optional[str], assembler_name: str) -> int:
    if genome_size is None:
        quit_with_error(f"assembly with {assembler_name} requires --genome_size")
    return parse_genome_size(genome_size)


TASKS: Dict[str, Callable] = {
    "genome_size": _run_genome_size,
    "canu": _run_canu,
    "flye": _run_flye,
    "hifiasm": _run_hifiasm,
    "ilesta": _run_ilesta,
    "lja": _run_lja,
    "metamdbg": _run_metamdbg,
    "miniasm": _run_miniasm,
    "myloasm": _run_myloasm,
    "necat": _run_necat,
    "nextdenovo": _run_nextdenovo,
    "plassembler": _run_plassembler,
    "raven": _run_raven,
    "redbean": _run_redbean,
}


def helper(task: str, reads, out_prefix=None, genome_size: Optional[str] = None,
           threads: int = 8, directory=None, read_type: str = "ont_r10",
           min_depth_abs: Optional[float] = None,
           min_depth_rel: Optional[float] = None,
           extra_args: Optional[List[str]] = None,
           timeout: Optional[float] = None,
           retries: Optional[int] = None) -> None:
    # every assembler invocation of this run gets the CLI's --timeout and
    # --retries; None falls back to the AUTOCYCLER_SUBPROCESS_* knobs
    run = functools.partial(run_command, timeout=timeout, retries=retries)
    if task not in TASKS:
        quit_with_error(f"unknown helper task: {task} "
                        f"(choose from {', '.join(sorted(TASKS))})")
    if read_type not in READ_TYPES:
        quit_with_error(f"unknown read type: {read_type}")
    if not os.path.isfile(reads):
        quit_with_error(f"file does not exist: {reads}")
    extra_args = list(extra_args or [])

    temp_guard = None
    if directory is None:
        temp_guard = tempfile.TemporaryDirectory(prefix="autocycler_helper_")
        directory = temp_guard.name
        # clean up on Ctrl-C like the reference (helper.rs:599-609)
        previous = signal.getsignal(signal.SIGINT)

        def _cleanup(signum, frame):
            temp_guard.cleanup()
            signal.signal(signal.SIGINT, previous)
            sys.exit(130)

        try:
            signal.signal(signal.SIGINT, _cleanup)
        except ValueError:
            pass  # not the main thread
    os.makedirs(directory, exist_ok=True)

    try:
        if task == "genome_size":
            TASKS[task](reads, None, genome_size, threads, directory, read_type,
                        extra_args, run)
            return
        if out_prefix is None:
            quit_with_error("assembly helper commands require --out_prefix")
        prefix_parent = Path(out_prefix).parent
        if prefix_parent and not prefix_parent.exists():
            os.makedirs(prefix_parent, exist_ok=True)
        TASKS[task](reads, out_prefix, genome_size, threads, directory, read_type,
                    extra_args, run)
        depth_filter(out_prefix, min_depth_abs, min_depth_rel)
        delete_fasta_if_empty(out_prefix)
    finally:
        if temp_guard is not None:
            temp_guard.cleanup()
