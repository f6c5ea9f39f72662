"""State carried across from the JAX package.

The k-mer index crosses as its fields: the per-occurrence ``KmerIndex`` of
the JAX package (ops/kmers.py, built there with ``use_fused=False``) holds
the same fields as the port's, as numpy arrays, so a caller hands them over
as a dict (``dataclasses.asdict`` or ``vars``) and the port's later stages
(chains, unitig graph) run on the JAX package's own index. The graph state
crosses as a GFA file, which ``UnitigGraph.from_gfa_file`` loads.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from .device import resolve_device
from .ops.kmers import KmerIndex

_SCALARS = ("k", "half_k")


def kmer_index_from_reference(arrays: Dict[str, np.ndarray],
                              device=None) -> KmerIndex:
    """The port's KmerIndex from the fields of a per-occurrence reference
    index; its device stages will run on ``device``. Raises KeyError when a
    per-occurrence field is missing (an index of the fused native layout
    has none)."""
    fields = {f.name for f in dataclasses.fields(KmerIndex)} - {"device"}
    kwargs = {}
    for name in sorted(fields):
        value = arrays[name]
        if value is None:
            raise KeyError(f"reference index has no {name!r}: build it with "
                           "the per-occurrence layout")
        kwargs[name] = int(value) if name in _SCALARS else np.asarray(value)
    return KmerIndex(**kwargs, device=resolve_device(device))
