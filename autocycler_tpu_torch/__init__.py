"""autocycler-tpu-torch: the PyTorch/CUDA port of autocycler-tpu.

A second package beside the JAX one, which stays as the reference: the same
subcommands, flags and output bytes, with arrays as torch tensors on an
NVIDIA GPU and every Pallas kernel of the JAX package rewritten by hand for
Hopper (CUDA C++ under ``csrc/``, built on first use by ``ops/_build.py``).
It imports neither jax nor the JAX package.

Layering (bottom → top):

- ``utils``    — I/O, logging, small helpers, stage timing, the worker
                 pool, the warm-start cache, the subprocess runner
- ``obs``      — the run record: spans, metrics, QC, provenance ledger
- ``models``   — Sequence / Position / Unitig / UnitigGraph data model
- ``device``   — device resolution, the kernels' launch counters and the
                 DPs' dispatch records
- ``ops``      — device grouping (the sort-network kernel), k-mer index,
                 chains, end repair, graph assembly, cluster distances,
                 the dotplot match grids (two match-grid kernels), the
                 trim and resolve alignment DPs (torch ops)
- ``commands`` — the ported subcommands: compress, decompress, cluster,
                 trim, resolve, combine, dotplot, and the host commands
                 subsample, helper, table, gfa2fasta, clean
- ``cli``      — argparse front-end
"""

__version__ = "0.1.0"
