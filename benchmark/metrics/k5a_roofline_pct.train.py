"""K5a (csrc/grid_pool_bwd.cu pass 1) over the profiled updates: the least
time its bytes need at the card's memory bandwidth (costs/grid_pool.py,
each step's active points) as a share of its device time."""

from benchmark import harness


def read(record):
    trace = record.get("trace")
    if not trace:
        return None
    n, seconds = harness.kernel_time(trace, "grid_pool_bwd1_kernel")
    if n == 0 or seconds <= 0 or n != record["k5a_launches"]:
        return None
    bound = record["k5a_bytes"] / harness.peaks()["hbm_bytes_per_s"]
    return 100.0 * bound / seconds
