"""Megabytes a serving step copies to the device, over the profiled stretch
of steps: the program's counter `serve.step.h2d_bytes` over its
`serve.step` spans (its recorder, gridmm_tpu_torch/utils/logging.py)."""


def read(record):
    if not record.get("trace"):
        return None
    try:
        from gridmm_tpu_torch.utils.logging import profiled_stretch
    except ImportError:  # a program without the recorder
        return None
    stretch = profiled_stretch()
    steps = len(stretch.named("serve.step"))
    moved = stretch.counters.get("serve.step.h2d_bytes")
    return moved / steps / 1e6 if steps and moved is not None else None
