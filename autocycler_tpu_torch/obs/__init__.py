"""The run record, as the JAX package's obs/ keeps it: span tracing
(``trace``, one process-wide run or one scoped run per serve job), the
metrics registry (``metrics_registry``), memory sampling (``memory``),
per-stage assembly QC (``qc``), the provenance ledger (``ledger``), the
background sampler (``timeseries``), and the readers ``report`` and
``watch``; ``federate`` gives the serve daemon its build info and
``submit``'s router its replicas. With ``AUTOCYCLER_TRACE_DIR`` set, one
CLI command writes ``trace.jsonl``, ``trace.chrome.json``,
``metrics.json``/``.prom``, ``qc_report.json``, ``ledger.json`` and
``timeseries.jsonl`` into that directory."""
