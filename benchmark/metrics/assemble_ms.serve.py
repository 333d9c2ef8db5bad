"""Mean host time of the serving step's assembly over the profiled stretch of
steps: the program's `serve.step.assemble` span (its recorder,
gridmm_tpu_torch/utils/logging.py), the rows concatenated into the pinned
buffers and the copies enqueued."""


def read(record):
    if not record.get("trace"):
        return None
    try:
        from gridmm_tpu_torch.utils.logging import profiled_stretch
    except ImportError:  # a program without the recorder
        return None
    spans = profiled_stretch().named("serve.step.assemble")
    return 1e3 * sum(s.seconds for s in spans) / len(spans) if spans else None
