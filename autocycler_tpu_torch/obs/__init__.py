"""The run record, as the JAX package's obs/ keeps it: span tracing
(``trace``), the metrics registry (``metrics_registry``), memory sampling
(``memory``), per-stage assembly QC (``qc``) and the provenance ledger
(``ledger``). With ``AUTOCYCLER_TRACE_DIR`` set, one CLI command writes
``trace.jsonl``, ``trace.chrome.json``, ``metrics.json``/``.prom``,
``qc_report.json`` and ``ledger.json`` into that directory."""
