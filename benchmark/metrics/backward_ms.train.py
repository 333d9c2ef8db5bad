"""Mean host time of an update's backward (`loss.backward()`, and the
gradients' reduction under a mesh) over the profiled updates: the program's
`train.backward` span (its recorder, gridmm_tpu_torch/utils/logging.py)."""


def read(record):
    if not record.get("trace"):
        return None
    try:
        from gridmm_tpu_torch.utils.logging import profiled_stretch
    except ImportError:  # a program without the recorder
        return None
    spans = profiled_stretch().named("train.backward")
    return 1e3 * sum(s.seconds for s in spans) / len(spans) if spans else None
