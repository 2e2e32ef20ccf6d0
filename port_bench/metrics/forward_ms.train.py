"""Device milliseconds of a train step's ``forward`` span (``diffusion_loss``:
the draws, the noising, both UNets forward and the loss): the median over
the traced steps, from the span's CUDA events on the profiler's clock
(``utils/profiling.py``'s recorder; none without it). Layer: train step
(``train/steps.py::make_train_step``)."""

import statistics


def read(rec):
    if rec.get("kind") != "train":
        return None
    try:
        from mikudance_tpu_torch.utils.profiling import recorded
    except ImportError:
        return None
    spans = [s.device_ms for s in recorded() if s.name == "forward" and s.device_ns]
    return statistics.median(spans) if spans else None
