"""Share of the rows an admission's language forward encodes that it admits,
over the profiled stretch of steps: the program's counters
`serve.admit.rows_admitted` over `serve.admit.rows_encoded` (its recorder,
gridmm_tpu_torch/utils/logging.py)."""


def read(record):
    if not record.get("trace"):
        return None
    try:
        from gridmm_tpu_torch.utils.logging import profiled_stretch
    except ImportError:  # a program without the recorder
        return None
    c = profiled_stretch().counters
    if not c.get("serve.admit.rows_encoded"):
        return None
    return (100.0 * c.get("serve.admit.rows_admitted", 0)
            / c["serve.admit.rows_encoded"])
