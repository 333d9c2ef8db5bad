"""Share of the admissions that replay a CUDA graph of the language
forward, over the profiled stretch of steps: the program's counters
`serve.admit.replays` over `serve.admit.calls` (its recorder,
gridmm_tpu_torch/utils/logging.py)."""


def read(record):
    if not record.get("trace"):
        return None
    try:
        from gridmm_tpu_torch.utils.logging import profiled_stretch
    except ImportError:  # a program without the recorder
        return None
    c = profiled_stretch().counters
    if not c.get("serve.admit.calls"):
        return None
    return 100.0 * c.get("serve.admit.replays", 0) / c["serve.admit.calls"]
