"""Wire format of the serve daemon: job specs, job records, endpoints.

Everything is plain JSON over HTTP so any client (curl, a workflow engine,
`autocycler submit`) can drive the daemon. A *job spec* is what the client
POSTs to ``/jobs``; a *job record* is what the daemon returns from
``/jobs`` and ``/jobs/<id>`` — the spec plus lifecycle state, timestamps,
and the paths of the run directory (trace/QC/ledger artifacts) and the
assembly output directory.

Validation mirrors the CLI flag checks (`cli.py` / `commands/compress.py`)
so a spec the daemon accepts is exactly one the CLI would have accepted —
a rejected spec costs an HTTP 400, never a quarantined job.
"""

from __future__ import annotations

import re
import uuid
from dataclasses import dataclass
from typing import Optional

from ..utils.resilience import InputError

PROTOCOL_VERSION = 1
DEFAULT_PORT = 8642

# daemon discovery file written into the serve root so local clients
# (`autocycler submit --dir <root>`) find the endpoint without flags
SERVE_INFO_JSON = "serve.json"

# cross-process correlation id header: the client mints one id per
# submission and the daemon threads it into the job's trace run header,
# QC scope, ledger and fleet-shard spans — `autocycler report --correlate
# <id>` then merges every matching trace.jsonl into one Chrome trace. It
# rides a header (not the spec body) so pre-federation daemons ignore it
# instead of rejecting the spec.
TRACE_HEADER = "X-Autocycler-Trace"
TRACE_ID_MAX = 64
_TRACE_ID_RE = re.compile(r"[^A-Za-z0-9._-]+")


def mint_trace_id() -> str:
    """A fresh correlation id: short, URL/filename/label-safe."""
    return f"t-{uuid.uuid4().hex[:12]}"


def sanitize_trace_id(raw) -> Optional[str]:
    """Normalize a client-supplied correlation id: keep only
    ``[A-Za-z0-9._-]``, cap the length, and return None for anything
    empty — a hostile or torn header value can never become a path
    component or an unbounded label."""
    if not isinstance(raw, str):
        return None
    cleaned = _TRACE_ID_RE.sub("", raw.strip())[:TRACE_ID_MAX]
    return cleaned or None

# job lifecycle: queued -> running -> done | failed. "failed" covers
# quarantined jobs — the job is recorded and the daemon keeps serving.
JOB_STATES = ("queued", "running", "done", "failed")

# what a job runs: "compress" is the single-isolate unitig-graph build;
# "pipeline" continues through cluster -> trim -> resolve -> combine,
# mirroring one isolate of `autocycler batch`.
JOB_COMMANDS = ("compress", "pipeline")

# fan-out bound for one batch submission (POST /jobs with a "batch" array)
BATCH_MAX = 64


@dataclass
class JobSpec:
    """One validated isolate job."""

    assemblies_dir: str
    command: str = "compress"
    out_dir: Optional[str] = None     # default: <run_dir>/out
    kmer: int = 51
    max_contigs: int = 25
    threads: int = 8
    cutoff: float = 0.2               # pipeline only
    min_assemblies: Optional[int] = None

    def to_dict(self) -> dict:
        return {
            "assemblies_dir": self.assemblies_dir,
            "command": self.command,
            "out_dir": self.out_dir,
            "kmer": self.kmer,
            "max_contigs": self.max_contigs,
            "threads": self.threads,
            "cutoff": self.cutoff,
            "min_assemblies": self.min_assemblies,
        }


def parse_job_spec(data) -> JobSpec:
    """Validate a decoded JSON body into a :class:`JobSpec`; raises
    :class:`InputError` with a client-renderable message on any problem
    (the server maps it to HTTP 400)."""
    if not isinstance(data, dict):
        raise InputError("job spec must be a JSON object")
    unknown = set(data) - {"assemblies_dir", "command", "out_dir", "kmer",
                           "max_contigs", "threads", "cutoff",
                           "min_assemblies"}
    if unknown:
        raise InputError(f"unknown job spec field(s): "
                         f"{', '.join(sorted(unknown))}")
    assemblies_dir = data.get("assemblies_dir")
    if not assemblies_dir or not isinstance(assemblies_dir, str):
        raise InputError("job spec requires a string 'assemblies_dir'")
    command = data.get("command", "compress")
    if command not in JOB_COMMANDS:
        raise InputError(f"unknown job command {command!r} "
                         f"(choose from {', '.join(JOB_COMMANDS)})")
    out_dir = data.get("out_dir")
    if out_dir is not None and not isinstance(out_dir, str):
        raise InputError("'out_dir' must be a string when given")

    def _int(name, default, lo, hi):
        value = data.get(name, default)
        if value is None:
            return None
        if isinstance(value, bool) or not isinstance(value, int):
            raise InputError(f"'{name}' must be an integer")
        if not lo <= value <= hi:
            raise InputError(f"'{name}' must be between {lo} and {hi} "
                             f"(inclusive)")
        return value

    kmer = _int("kmer", 51, 11, 501)
    if kmer % 2 == 0:
        raise InputError("'kmer' must be odd")
    max_contigs = _int("max_contigs", 25, 1, 10000)
    threads = _int("threads", 8, 1, 100)
    cutoff = data.get("cutoff", 0.2)
    if isinstance(cutoff, bool) or not isinstance(cutoff, (int, float)) \
            or not 0.0 < float(cutoff) < 1.0:
        raise InputError("'cutoff' must be a number between 0 and 1 "
                         "(exclusive)")
    min_assemblies = data.get("min_assemblies")
    if min_assemblies is not None:
        min_assemblies = _int("min_assemblies", None, 1, 10000)
    return JobSpec(assemblies_dir=assemblies_dir, command=command,
                   out_dir=out_dir, kmer=kmer, max_contigs=max_contigs,
                   threads=threads, cutoff=float(cutoff),
                   min_assemblies=min_assemblies)


def is_batch_spec(data) -> bool:
    """True when a POST /jobs body is a multi-isolate batch submission."""
    return isinstance(data, dict) and "batch" in data


def is_fleet_batch(data) -> bool:
    """True when a batch body opts into the fleet runner: a truthy
    top-level ``"fleet"`` next to the ``"batch"`` array. The batch then
    admits as ONE scheduler job whose execution fans the items over the
    mesh (commands.batch.run_fleet_jobs) instead of N child jobs."""
    return is_batch_spec(data) and bool(data.get("fleet"))


def validate_fleet_batch(specs) -> None:
    """Constraints the fleet runner adds on top of batch validation: the
    items share one device plan, so kmer and max_contigs must be uniform
    across the batch, and every item must run the full pipeline (a
    compress-only fleet item would silently skip its cluster/consensus
    outputs). Raises :class:`InputError` (HTTP 400)."""
    if len({s.kmer for s in specs}) > 1:
        raise InputError("fleet batch requires a uniform 'kmer' "
                         "across all items")
    if len({s.max_contigs for s in specs}) > 1:
        raise InputError("fleet batch requires a uniform 'max_contigs' "
                         "across all items")
    bad = [i for i, s in enumerate(specs) if s.command != "pipeline"]
    if bad:
        raise InputError(f"fleet batch items must use command='pipeline' "
                         f"(item {bad[0]} is "
                         f"{specs[bad[0]].command!r})")


def parse_batch_spec(data) -> list:
    """Validate a batch body into a list of :class:`JobSpec`.

    The body carries a ``"batch"`` array of per-isolate spec objects;
    every other top-level field is a shared default merged under each
    child (a child's own field wins). The whole batch validates or the
    whole batch is rejected — partial admission would leave a client
    guessing which isolates were accepted."""
    if not isinstance(data, dict):
        raise InputError("batch spec must be a JSON object")
    items = data.get("batch")
    if not isinstance(items, list) or not items:
        raise InputError("'batch' must be a non-empty JSON array of "
                         "job specs")
    if len(items) > BATCH_MAX:
        raise InputError(f"batch fan-out is capped at {BATCH_MAX} jobs "
                         f"(got {len(items)})")
    shared = {k: v for k, v in data.items() if k not in ("batch", "fleet")}
    specs = []
    for i, item in enumerate(items):
        if not isinstance(item, dict):
            raise InputError(f"batch item {i} must be a JSON object")
        merged = dict(shared)
        merged.update(item)
        try:
            specs.append(parse_job_spec(merged))
        except InputError as e:
            raise InputError(f"batch item {i}: {e}") from None
    return specs
