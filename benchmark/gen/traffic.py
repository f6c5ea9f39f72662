"""The one generator of the benchmark's traffic: isolates drawn from a seed.

A configuration file (``benchmark/configs/<name>.json``) gives the shape of
one isolate (assemblies, replicon lengths, SNPs); a traffic file
(``benchmark/traffic/<name>.json``) gives what the assemblers leave on the
contigs (``overlap``: the ranges of start-end overlap lengths, or null).
Isolate ``i`` of seed ``s`` is drawn from its own random stream, so every
seed gives the same sizes and only the sequence, rotations, SNP sites and
overlap lengths change.
"""

from __future__ import annotations

import numpy as np

from . import synthetic

SHAPE_KEYS = ("n_assemblies", "chromosome_len", "plasmid_len", "n_snps")
WARMUP_STREAM = 1 << 40


def _rng(seed: int, stream: int):
    return np.random.default_rng(np.random.SeedSequence([seed % (1 << 64),
                                                         stream]))


def isolate(shape: dict, traffic: dict, seed: int, index: int):
    """[(file name, [(header, sequence)])] of isolate ``index``."""
    rng = _rng(seed, index)
    files = synthetic.make_assemblies_fast(rng, **{k: shape[k] for k in SHAPE_KEYS})
    overlap = traffic.get("overlap")
    if overlap:
        files = synthetic.append_start_overlaps(
            files, rng, tuple(overlap["chromosome"]), tuple(overlap["plasmid"]))
    return files


def warmup_isolate(config: dict, traffic: dict, seed: int):
    """The small isolate that set-up runs through the window's path."""
    return isolate(config["warmup"], traffic, seed, WARMUP_STREAM)


def scaled(config: dict, factor: float) -> dict:
    """The configuration with every length and SNP count, its warm-up's
    too, divided by ``factor`` (the CPU tests' tiny runs); the assemblies
    stay, and a configuration that streams at its own size is made to
    stream at the scaled one too."""
    out = dict(config)
    if config.get("streams"):
        out["env"] = {"AUTOCYCLER_STREAM_KMERS": "on"}
    for key in ("chromosome_len", "plasmid_len", "n_snps"):
        out[key] = int(config[key] / factor)
    if "warmup" in config:
        out["warmup"] = dict(config["warmup"])
        for key in ("chromosome_len", "plasmid_len", "n_snps"):
            out["warmup"][key] = int(config["warmup"][key] / factor)
    return out


def scaled_traffic(traffic: dict, factor: float) -> dict:
    """The traffic with its overlap lengths divided by ``factor``."""
    out = dict(traffic)
    if traffic.get("overlap"):
        out["overlap"] = {name: [int(v / factor) for v in span]
                          for name, span in traffic["overlap"].items()}
    return out
