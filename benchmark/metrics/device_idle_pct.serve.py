"""Share of the profiled stretch of steps in which no operation ran on the
device."""


def read(record):
    trace = record.get("trace")
    if not trace or trace["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
