"""Assembly as a service: the `autocycler serve` daemon and its client, as
the JAX package's serve/ has them, on the card.

A long-lived process pays once for what the CLI pays per invocation — the
CUDA context, the kernels' build and load, the parse and end-repair
warm-start caches and the shared worker pool — across a stream of isolate
jobs submitted over a local HTTP endpoint (TCP loopback or a Unix domain
socket). Modules:

- :mod:`.protocol` — the job-spec / job-record wire format and validation;
- :mod:`.scheduler` — the bounded work queue with per-job fault isolation
  (``utils.resilience.RunManifest`` + quarantine) and per-job run dirs;
- :mod:`.slo` — latency objectives, window quantiles, burn rate, shedding;
- :mod:`.server` — the HTTP surface (``/jobs``, ``/metrics``, ``/healthz``,
  per-job trace streaming) and the `autocycler serve` entry point;
- :mod:`.client` and :mod:`.router` — the thin `autocycler submit` client.
"""

from .protocol import DEFAULT_PORT, JobSpec, parse_job_spec  # noqa: F401
