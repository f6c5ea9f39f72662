"""Peak-fraction accounting for the port's device work on one H100, as the
JAX package's ops/mfu.py keeps it for one TPU v5e: every rate the port
reports (Gcells/s of the match grids, bytes/s of the grouping, a declared
dispatch's work over its seconds) converts to a share of the card's peak
here, so ``chip_smoke.py``'s bounds, the recovery capture and
``report``'s rates use one set of numbers.

Peaks of one H100 SXM part (NVIDIA H100 data sheet, dense figures):

- tensor cores: 989e12 FLOP/s bf16, 1979e12 OP/s int8, 67e12 FLOP/s f64
  (the data sheet's FP64 tensor-core rate: cuBLAS's f64 products run
  there);
- CUDA cores: 128 lanes per SM a clock (4 schedulers x 32 lanes) x 132
  SMs x 1.98 GHz boost = 33.5e12 instructions/s, the data sheet's float32
  rate (67 TFLOP/s) counted as one instruction per FMA; no integer or
  logic instruction issues faster;
- HBM3: 3.35e12 B/s.

Work per cell, counted as ``PERF.md`` §6's bounds count it:

- the +-1 product (``dotplot_grid.match_grid_mxu``): a 2k-deep dot
  product, 4k operations a cell (the JAX package's count);
- the word compare (``dotplot_grid.match_grid``): W + 1 instructions a
  cell, W = ceil(k / 16) word compares chained through one predicate, then
  one predicated add. The JAX package counts ~2W VPU operations a cell;
- the k-mer grouping (``sortnet.pack_rank``): each input read once (the
  code bytes its windows cover, the int32 starts) and each output written
  once (int32 order and group ids).

With these counts ``pct_peak / 100 x kernel ms`` is the bound ``PERF.md``
§6 gives the kernel.
"""

from __future__ import annotations

H100_BF16_FLOPS = 989e12
H100_INT8_OPS = 1979e12
H100_F64_FLOPS = 67e12
H100_INT_OPS = 132 * 128 * 1.98e9          # ~33.5e12
H100_HBM_BYTES = 3.35e12

# the peak each declared dispatch's flops are rated against, by the name it
# runs under (device.py); any other name is rated against bf16, as the JAX
# package rates every declared flop
PEAKS = {"bf16": H100_BF16_FLOPS, "int8": H100_INT8_OPS,
         "f64": H100_F64_FLOPS, "int": H100_INT_OPS}
KERNEL_PEAK = {
    "cluster distance matmul": "f64",
    "batch_membership_contraction": "f64",
    "fleet_membership_contraction": "f64",
    "cluster_sketch_grid": "int",
    "dotplot_match_grid": "int",
    "dotplot_match_grid_mxu": "bf16",
}


def word_compare_ops(cells: float, k: int) -> float:
    """Instructions of the word compare over ``cells`` cells at ``k``."""
    return cells * ((k + 15) // 16 + 1)


def pm1_product_ops(cells: float, k: int) -> float:
    """Operations of the +-1 product over ``cells`` cells at ``k``."""
    return cells * 4.0 * k


def grouping_bytes(covered_code_bytes: int, n_windows: int) -> int:
    """Bytes the k-mer grouping must move: the code bytes its windows cover
    and the int32 starts read once, the int32 order and group ids written
    once."""
    return covered_code_bytes + 4 * n_windows + 8 * n_windows


def mxu_grid_mfu(rate_gcells: float, k: int, int8: bool = False) -> dict:
    """The +-1 product's Gcells/s -> {tflops, pct_peak} against the tensor
    cores' bf16 (or int8) peak."""
    flops = pm1_product_ops(rate_gcells * 1e9, k)
    peak = H100_INT8_OPS if int8 else H100_BF16_FLOPS
    return {"tflops": round(flops / 1e12, 2),
            "pct_peak": round(100.0 * flops / peak, 1)}


def vpu_grid_mfu(rate_gcells: float, k: int) -> dict:
    """The word compare's Gcells/s -> {tops, pct_peak}: instructions/s
    against the CUDA cores' issue rate (the JAX package's name, whose VPU
    is the TPU's vector unit)."""
    ops = word_compare_ops(rate_gcells * 1e9, k)
    return {"tops": round(ops / 1e12, 2),
            "pct_peak": round(100.0 * ops / H100_INT_OPS, 1)}


def kernel_rates(kernels: dict) -> dict:
    """Rates the per-name dispatch record
    (``utils.timing.device_kernel_snapshot``: ``{name: {phase: {count,
    total_s, flops?, bytes?}}}``) against the card's peaks. Prefers the
    steady phase (the first call of a name carries the kernel's load),
    else the first. Returns ``{name: {phase, count, total_s, mean_s,
    tflops?, pct_peak_bf16?, gb_per_s?, pct_peak_hbm?, peak?,
    pct_peak?}}``: the JAX package's keys, where the dispatch site declared
    its work, and ``pct_peak``, the larger share against the name's own
    peak (``KERNEL_PEAK``) and the memory rate, with ``peak`` naming it.

    The seconds are the CUDA events around a block, which span the host's
    gaps inside it (a host loop of small device steps, a launch's
    bookkeeping), so each rate is a lower bound on the device's own."""
    out: dict = {}
    for kernel, phases in kernels.items():
        stats = phases.get("steady") or phases.get("first")
        phase = "steady" if "steady" in phases else "first"
        if not stats or not stats.get("count"):
            continue
        total = stats.get("total_s", 0.0)
        row = {"phase": phase, "count": stats["count"],
               "total_s": round(total, 6),
               "mean_s": round(total / stats["count"], 6)}
        shares = {}
        if total > 0 and stats.get("flops"):
            flops_rate = stats["flops"] / total
            row["tflops"] = round(flops_rate / 1e12, 3)
            row["pct_peak_bf16"] = round(
                100.0 * flops_rate / H100_BF16_FLOPS, 2)
            peak = KERNEL_PEAK.get(kernel, "bf16")
            shares[peak] = 100.0 * flops_rate / PEAKS[peak]
        if total > 0 and stats.get("bytes"):
            byte_rate = stats["bytes"] / total
            row["gb_per_s"] = round(byte_rate / 1e9, 2)
            row["pct_peak_hbm"] = round(100.0 * byte_rate / H100_HBM_BYTES,
                                        2)
            shares["hbm"] = 100.0 * byte_rate / H100_HBM_BYTES
        if shares:
            row["peak"] = max(shares, key=shares.get)
            row["pct_peak"] = shares[row["peak"]]
        out[kernel] = row
    return out


def sort_bandwidth(n_elements: int, n_passes: int, seconds: float,
                   n_arrays: int = 2) -> dict:
    """A multi-pass device sort's effective traffic -> {gb_per_s,
    pct_peak} of the memory rate: each pass reads and writes ``n_arrays``
    parallel 4-byte streams (8 B per array per element per pass), the JAX
    package's model. A lower bound on the real traffic (scratch is not
    counted), so the share is conservative."""
    if seconds <= 0:
        return {"gb_per_s": 0.0, "pct_peak": 0.0}
    bytes_moved = 8.0 * n_arrays * n_elements * n_passes
    rate = bytes_moved / seconds
    return {"gb_per_s": round(rate / 1e9, 1),
            "pct_peak": round(100.0 * rate / H100_HBM_BYTES, 1)}
