"""Host time of the optimizer's step (torch.optim's `Optimizer.step`
annotation in the profiled updates), per update."""


def read(record):
    trace = record.get("trace")
    spans = (trace or {}).get("spans", {}).get("Optimizer.step")
    if not spans:
        return None
    return 1e3 * sum(spans) / record["trace_updates"]
