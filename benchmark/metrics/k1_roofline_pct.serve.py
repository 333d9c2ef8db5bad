"""K1 (csrc/grid_pool_fwd.cu) over the profiled steps: the least time its
bytes need at the card's memory bandwidth (costs/grid_pool.py, each byte
once) as a share of its device time."""

from benchmark import harness


def read(record):
    trace = record.get("trace")
    if not trace:
        return None
    n, seconds = harness.kernel_time(trace, "grid_pool_fwd_kernel")
    if n == 0 or seconds <= 0 or n != record["k1_launches"]:
        return None
    bound = record["k1_bytes"] / harness.peaks()["hbm_bytes_per_s"]
    return 100.0 * bound / seconds
