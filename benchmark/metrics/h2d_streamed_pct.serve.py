"""Share of the bytes a serving step copies to the device that went up on
the engine's copy stream, over the profiled stretch of steps: the program's
counter `serve.step.h2d_streamed_bytes` over its `serve.step.h2d_bytes`
(its recorder, gridmm_tpu_torch/utils/logging.py). A program that counts
no streamed bytes reads nothing."""


def read(record):
    if not record.get("trace"):
        return None
    try:
        from gridmm_tpu_torch.utils.logging import profiled_stretch
    except ImportError:  # a program without the recorder
        return None
    c = profiled_stretch().counters
    moved = c.get("serve.step.h2d_bytes")
    streamed = c.get("serve.step.h2d_streamed_bytes")
    if not moved or streamed is None:
        return None
    return 100.0 * streamed / moved
