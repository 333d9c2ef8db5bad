"""Mean host time from the call of `engine.step` to its return (row
assembly, pinned copies, the replay's enqueue), over the traced window."""


def read(record):
    spans = record.get("spans", {}).get("step")
    return 1e3 * sum(spans) / len(spans) if spans else None
