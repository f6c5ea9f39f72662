"""The one generator of the benchmark's traffic: isolates drawn from a seed.

A configuration file (``benchmark/configs/<name>.json``) gives the shape of
one isolate: ``n_assemblies``, ``chromosome_len`` and ``n_snps`` (a
chromosome's), and either ``plasmid_len`` (one plasmid; 0 for none) or
``plasmid_lens`` (a list of plasmids), with ``plasmid_snps_per_mbp`` (SNPs
on every copy of a plasmid; 0 if absent). Its ``warmup`` gives a shape of
the same keys. A traffic file
(``benchmark/traffic/<name>.json``) gives what the assemblers leave on the
contigs (``overlap``: the ranges of start-end overlap lengths, or null).
Isolate ``i`` of seed ``s`` is drawn from its own random stream, so every
seed gives the same sizes and only the sequence, rotations, SNP sites and
overlap lengths change.
"""

from __future__ import annotations

import numpy as np

from . import synthetic

SHAPE_KEYS = ("n_assemblies", "chromosome_len", "n_snps")
WARMUP_STREAM = 1 << 40
# the shortest plasmid that scaled() leaves (bp), and why: see its docstring
PLASMID_FLOOR = 2_000


def _rng(seed: int, stream: int):
    return np.random.default_rng(np.random.SeedSequence([seed % (1 << 64),
                                                         stream]))


def isolate(shape: dict, traffic: dict, seed: int, index: int):
    """[(file name, [(header, sequence)])] of isolate ``index``."""
    rng = _rng(seed, index)
    files = synthetic.make_isolate(
        rng, **{k: shape[k] for k in SHAPE_KEYS}, plasmid_lens=plasmid_lens(shape),
        plasmid_snps_per_mbp=shape.get("plasmid_snps_per_mbp", 0))
    overlap = traffic.get("overlap")
    if overlap:
        files = synthetic.append_start_overlaps(
            files, rng, tuple(overlap["chromosome"]), tuple(overlap["plasmid"]))
    return files


def warmup_isolate(config: dict, traffic: dict, seed: int):
    """The small isolate that set-up runs through the window's path."""
    return isolate(config["warmup"], traffic, seed, WARMUP_STREAM)


def plasmid_lens(shape: dict) -> list:
    """The shape's plasmid lengths: ``plasmid_lens``, or ``plasmid_len``
    as a list of one (none where it is 0). A shape gives one of the two."""
    if ("plasmid_len" in shape) == ("plasmid_lens" in shape):
        raise ValueError("a shape gives plasmid_len or plasmid_lens, not "
                         f"both or neither: {sorted(shape)}")
    if "plasmid_lens" in shape:
        lens = list(shape["plasmid_lens"])
        if not all(isinstance(n, int) and n > 0 for n in lens):
            raise ValueError(f"plasmid_lens holds a length that is no "
                             f"positive whole number: {lens}")
        return lens
    return [shape["plasmid_len"]] if shape["plasmid_len"] else []


def _scaled_shape(shape: dict, factor: float) -> dict:
    """The shape with its plasmids as ``plasmid_lens``, each at the floor
    or above, and its other lengths and SNP counts divided."""
    out = {k: v for k, v in shape.items()
           if k not in ("plasmid_len", "plasmid_lens")}
    for key in ("chromosome_len", "n_snps"):
        out[key] = int(shape[key] / factor)
    out["plasmid_lens"] = [max(int(n / factor), min(n, PLASMID_FLOOR))
                           for n in plasmid_lens(shape)]
    return out


def scaled(config: dict, factor: float) -> dict:
    """The configuration with every length and SNP count, its warm-up's
    too, divided by ``factor`` (the CPU tests' tiny runs); the assemblies
    and ``plasmid_snps_per_mbp`` (a rate) stay, and a configuration that
    streams at its own size is made to stream at the scaled one too.

    Every plasmid, ``plasmid_len``'s or each of ``plasmid_lens``, comes out
    in ``plasmid_lens``, divided down to no less than :data:`PLASMID_FLOOR`,
    2,000 bp (one that is shorter at its own size keeps its length): two
    copies of a plasmid that differ by a SNP each share all but about
    2 x 51 of their k-mers at k 51, which at 2,000 bp is 95 % of them, so
    the copies stay one replicon, well inside cluster's cutoff of 0.2 in
    either distance, and apart from every other replicon (random sequence
    shares none). A plasmid of a few hundred bp would be broken by its own
    SNPs into copies that cluster apart."""
    out = _scaled_shape(config, factor)
    if config.get("streams"):
        out["env"] = {**config.get("env", {}), "AUTOCYCLER_STREAM_KMERS": "on"}
    if "warmup" in config:
        out["warmup"] = _scaled_shape(config["warmup"], factor)
    return out


def scaled_traffic(traffic: dict, factor: float) -> dict:
    """The traffic with its overlap lengths divided by ``factor``."""
    out = dict(traffic)
    if traffic.get("overlap"):
        out["overlap"] = {name: [int(v / factor) for v in span]
                          for name, span in traffic["overlap"].items()}
    return out
