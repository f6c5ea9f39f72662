"""Per-stage metrics, serialized to YAML.

Parity target: reference metrics.rs:24-273 — one dataclass per pipeline stage
and a save_to_yaml helper. YAML is emitted without external dependencies (the
structures are simple: scalars, lists, nested records). This slice of the port
carries the compress metrics only.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import List


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
