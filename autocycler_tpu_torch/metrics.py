"""Per-stage metrics, serialized to YAML.

Parity target: reference metrics.rs:24-273 — one dataclass per pipeline stage
and a save_to_yaml helper. YAML is emitted without external dependencies (the
structures are simple: scalars, lists, nested records). The port carries the
metrics of its ported stages: subsample, compress, cluster, trim and
combine.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

from .utils import mad, median


def _yaml_scalar(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, float):
        return repr(v)
    if isinstance(v, str):
        if v == "" or any(c in v for c in ":#{}[],&*!|>'\"%@`") or v.strip() != v:
            return "'" + v.replace("'", "''") + "'"
        return v
    return str(v)


def _to_yaml(obj, indent: int = 0) -> List[str]:
    pad = "  " * indent
    lines: List[str] = []
    if dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            if dataclasses.is_dataclass(v):
                lines.append(f"{pad}{f.name}:")
                lines.extend(_to_yaml(v, indent + 1))
            elif isinstance(v, list):
                if not v:
                    lines.append(f"{pad}{f.name}: []")
                else:
                    lines.append(f"{pad}{f.name}:")
                    for item in v:
                        if dataclasses.is_dataclass(item):
                            # "- " occupies one indent level, so the item's
                            # remaining keys keep the same column as its first
                            sub = _to_yaml(item, indent + 1)
                            lines.append(f"{pad}- {sub[0].strip()}")
                            lines.extend(sub[1:])
                        else:
                            lines.append(f"{pad}- {_yaml_scalar(item)}")
            else:
                lines.append(f"{pad}{f.name}: {_yaml_scalar(v)}")
    return lines


class MetricsBase:
    def save_to_yaml(self, filename) -> None:
        with open(filename, "w") as f:
            f.write("\n".join(_to_yaml(self)) + "\n")

    @classmethod
    def get_field_names(cls) -> List[str]:
        return sorted(f.name for f in dataclasses.fields(cls))


@dataclass
class ReadSetDetails(MetricsBase):
    count: int = 0
    bases: int = 0
    n50: int = 0

    @classmethod
    def from_sorted_lengths(cls, sorted_read_lengths: List[int]) -> "ReadSetDetails":
        """N50 over lengths sorted descending (reference metrics.rs:43-60)."""
        bases = sum(sorted_read_lengths)
        target = bases // 2
        running, n50 = 0, 0
        for length in sorted_read_lengths:
            running += length
            if running >= target:
                n50 = length
                break
        return cls(count=len(sorted_read_lengths), bases=bases, n50=n50)


@dataclass
class SubsampleMetrics(MetricsBase):
    input_read_count: int = 0
    input_read_bases: int = 0
    input_read_n50: int = 0
    # which shuffle made the read partition: "rust-stdrng-0.9" is the
    # reference's own for the same seed (utils/rust_rand.py);
    # "python-fisher-yates" is the fallback when its self-test fails
    shuffle: str = ""
    output_reads: List[ReadSetDetails] = field(default_factory=list)


@dataclass
class InputContigDetails(MetricsBase):
    name: str = ""
    description: str = ""
    length: int = 0


@dataclass
class InputAssemblyDetails(MetricsBase):
    filename: str = ""
    contigs: List[InputContigDetails] = field(default_factory=list)


@dataclass
class InputAssemblyMetrics(MetricsBase):
    input_assemblies_count: int = 0
    input_assemblies_total_contigs: int = 0
    input_assemblies_total_length: int = 0
    compressed_unitig_count: int = 0
    compressed_unitig_total_length: int = 0
    input_assembly_details: List[InputAssemblyDetails] = field(default_factory=list)


@dataclass
class ClusteringMetrics(MetricsBase):
    pass_cluster_count: int = 0
    fail_cluster_count: int = 0
    pass_contig_count: int = 0
    fail_contig_count: int = 0
    pass_contig_fraction: float = 0.0
    fail_contig_fraction: float = 0.0
    cluster_balance_score: float = 0.0
    cluster_tightness_score: float = 0.0
    overall_clustering_score: float = 0.0

    def calculate_fractions(self) -> None:
        total = self.pass_contig_count + self.fail_contig_count
        if total > 0:
            self.pass_contig_fraction = self.pass_contig_count / total
            self.fail_contig_fraction = self.fail_contig_count / total

    def calculate_scores(self, cluster_filenames: Dict[int, List[str]],
                         pass_cluster_stats: List[Tuple[float, int]]) -> None:
        self.calculate_balance(cluster_filenames)
        self.calculate_tightness(pass_cluster_stats)
        self.overall_clustering_score = (self.cluster_balance_score
                                         + self.cluster_tightness_score) / 2.0

    def calculate_balance(self, cluster_filenames: Dict[int, List[str]]) -> None:
        """How evenly input files are distributed over clusters: per cluster,
        each known filename scores 1.0 iff it appears exactly once; cluster
        scores are size-weighted-averaged (reference metrics.rs:140-168)."""
        all_filenames = {f for cluster in cluster_filenames.values() for f in cluster}
        if not all_filenames:
            self.cluster_balance_score = 0.0
            return
        weighted_sum, total_weight = 0.0, 0.0
        for cluster in cluster_filenames.values():
            counts: Dict[str, int] = {}
            for f in cluster:
                counts[f] = counts.get(f, 0) + 1
            score = sum(1.0 if counts.get(f, 0) == 1 else 0.0
                        for f in all_filenames) / len(all_filenames)
            weighted_sum += score * len(cluster)
            total_weight += len(cluster)
        self.cluster_balance_score = weighted_sum / total_weight

    def calculate_tightness(self, pass_cluster_stats: List[Tuple[float, int]]) -> None:
        """Size-weighted mean of 1 - sqrt(cluster distance)
        (reference metrics.rs:170-187)."""
        if not pass_cluster_stats:
            self.cluster_tightness_score = 0.0
            return
        weighted_sum = sum((1.0 - distance ** 0.5) * size
                           for distance, size in pass_cluster_stats)
        total_weight = sum(size for _, size in pass_cluster_stats)
        self.cluster_tightness_score = weighted_sum / total_weight


@dataclass
class UntrimmedClusterMetrics(MetricsBase):
    untrimmed_cluster_size: int = 0
    untrimmed_cluster_lengths: List[int] = field(default_factory=list)
    untrimmed_cluster_median: int = 0
    untrimmed_cluster_mad: int = 0
    untrimmed_cluster_distance: float = 0.0

    @classmethod
    def new(cls, sequence_lengths: List[int], distance: float):
        return cls(untrimmed_cluster_size=len(sequence_lengths),
                   untrimmed_cluster_lengths=sequence_lengths,
                   untrimmed_cluster_median=median(sequence_lengths),
                   untrimmed_cluster_mad=mad(sequence_lengths),
                   untrimmed_cluster_distance=distance)


@dataclass
class TrimmedClusterMetrics(MetricsBase):
    trimmed_cluster_size: int = 0
    trimmed_cluster_lengths: List[int] = field(default_factory=list)
    trimmed_cluster_median: int = 0
    trimmed_cluster_mad: int = 0

    @classmethod
    def new(cls, sequence_lengths: List[int]):
        return cls(trimmed_cluster_size=len(sequence_lengths),
                   trimmed_cluster_lengths=sequence_lengths,
                   trimmed_cluster_median=median(sequence_lengths),
                   trimmed_cluster_mad=mad(sequence_lengths))


@dataclass
class ResolvedClusterDetails(MetricsBase):
    length: int = 0
    unitigs: int = 0
    topology: str = ""


@dataclass
class CombineMetrics(MetricsBase):
    consensus_assembly_bases: int = 0
    consensus_assembly_unitigs: int = 0
    consensus_assembly_fully_resolved: bool = False
    consensus_assembly_clusters: List[ResolvedClusterDetails] = field(default_factory=list)
