"""Mean device time of the serving step's graph over the profiled stretch of
steps: the two timing events of the program's `serve.step.replay` span (its
recorder, gridmm_tpu_torch/utils/logging.py) around `graph.replay()`, the
first processed after the step's copies. None without a card or without the
recorder."""


def read(record):
    if not record.get("trace"):
        return None
    try:
        from gridmm_tpu_torch.utils.logging import profiled_stretch
    except ImportError:  # a program without the recorder
        return None
    times = [s.device_ms()
             for s in profiled_stretch().named("serve.step.replay")]
    if not times or None in times:
        return None
    return sum(times) / len(times)
