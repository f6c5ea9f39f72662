"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates), the yardstick of every roofline share the benchmark reports.

The CUDA cores issue 128 lanes a clock on each of 132 SMs at the 1.98 GHz
boost clock: 33.5e12 instructions/s, the data sheet's float32 rate (67
TFLOP/s) counted as one instruction per FMA. No integer or logic
instruction issues faster, so a count of integer operations over this rate
is a lower bound on their time. HBM3 moves 3.35e12 B/s. Both assume the
card's full power limit of 700 W.
"""

H100_INSTRUCTIONS_PER_S = 132 * 128 * 1.98e9
H100_HBM_BYTES_PER_S = 3.35e12


def least_seconds(instructions: float, bytes_moved: float):
    """(seconds, what binds): the larger of the two bounds."""
    by_ops = instructions / H100_INSTRUCTIONS_PER_S
    by_bytes = bytes_moved / H100_HBM_BYTES_PER_S
    return (by_ops, "operations") if by_ops >= by_bytes else (by_bytes, "bytes")
