"""`autocycler table`: flatten per-stage metrics YAMLs into one TSV row.

Parity target: reference table.rs — discover stage YAMLs under a directory
(skipping qc_fail/ for the multi-copy cluster metrics), flatten to one row
per sample with significant-figure formatting; with no directory, print just
the header row.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, List, Optional

import yaml

from ..metrics import (ClusteringMetrics, CombineMetrics, InputAssemblyMetrics,
                       SubsampleMetrics, TrimmedClusterMetrics, UntrimmedClusterMetrics)
from ..utils import format_float_sigfigs, log, quit_with_error

# default field list, reference main.rs:287-294
DEFAULT_FIELDS = ("input_read_count,input_read_bases,input_read_n50,"
                  "pass_cluster_count,fail_cluster_count,overall_clustering_score,"
                  "untrimmed_cluster_size,untrimmed_cluster_distance,"
                  "trimmed_cluster_size,trimmed_cluster_median,trimmed_cluster_mad,"
                  "consensus_assembly_bases,consensus_assembly_unitigs,"
                  "consensus_assembly_fully_resolved")


def parse_fields(comma_delimited: str) -> List[str]:
    fields = [f for f in comma_delimited.replace(" ", "").split(",") if f]
    valid = set()
    for cls in (SubsampleMetrics, InputAssemblyMetrics, ClusteringMetrics,
                CombineMetrics, UntrimmedClusterMetrics, TrimmedClusterMetrics):
        valid.update(cls.get_field_names())
    for field in fields:
        if field not in valid:
            quit_with_error(f"{field} is not a valid field name")
    return fields


def find_all_yaml_files(autocycler_dir) -> List[Path]:
    out = []
    for root, _dirs, files in os.walk(autocycler_dir):
        for f in files:
            if f.endswith(".yaml"):
                out.append(Path(root) / f)
    out.sort()
    return out


def get_one_copy_yaml(yaml_files: List[Path], filename: str) -> Optional[Path]:
    found = [p for p in yaml_files if p.name == filename]
    if not found:
        log.message(f"Warning: {filename} not found")
        return None
    if len(found) > 1:
        quit_with_error(f"Multiple {filename} files found")
    return found[0]


def get_multi_copy_yaml(yaml_files: List[Path], filename: str) -> List[Path]:
    found = [p for p in yaml_files
             if p.name == filename and "/qc_fail/" not in str(p)]
    if not found:
        log.message(f"Warning: {filename} not found")
    return found


def format_value(value, sigfigs: int) -> str:
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, float):
        return format_float_sigfigs(value, sigfigs)
    if isinstance(value, int):
        return str(value)
    if isinstance(value, str):
        return value
    if isinstance(value, list):
        return "[" + ",".join(format_value(v, sigfigs) for v in value) + "]"
    if isinstance(value, dict):
        return "{" + ",".join(f"{format_value(k, sigfigs)}:{format_value(v, sigfigs)}"
                              for k, v in value.items()) + "}"
    return ""


def table_row(autocycler_dir, name: str, fields: List[str], sigfigs: int) -> str:
    if "\t" in name:
        quit_with_error("--name cannot contain tab characters")
    yaml_files = find_all_yaml_files(autocycler_dir)
    merged: Dict[str, object] = {}
    for filename in ("subsample.yaml", "input_assemblies.yaml", "clustering.yaml",
                     "consensus_assembly.yaml"):
        path = get_one_copy_yaml(yaml_files, filename)
        if path is not None:
            with open(path) as f:
                merged.update(yaml.safe_load(f) or {})
    for filename in ("1_untrimmed.yaml", "2_trimmed.yaml"):
        paths = get_multi_copy_yaml(yaml_files, filename)
        combined: Dict[str, list] = {}
        for path in paths:
            with open(path) as f:
                for key, value in (yaml.safe_load(f) or {}).items():
                    combined.setdefault(key, []).append(value)
        merged.update(combined)
    cells = [name]
    for field in fields:
        value = merged.get(field)
        cells.append(format_value(value, sigfigs) if value is not None else "")
    return "\t".join(cells)


def table(autocycler_dir=None, name: str = "", fields: str = DEFAULT_FIELDS,
          sigfigs: int = 3) -> None:
    if sigfigs == 0:
        quit_with_error("--sigfigs must be 1 or greater")
    field_list = parse_fields(fields)
    if autocycler_dir is None:
        print("name\t" + "\t".join(field_list))
    else:
        if not os.path.isdir(autocycler_dir):
            quit_with_error(f"directory does not exist: {autocycler_dir}")
        print(table_row(autocycler_dir, name, field_list, sigfigs))
