"""How far the card trails the host at the end of a train step's
``backward`` span (``loss.backward()``): the median over the traced steps of
the span's device end less its host end, in milliseconds, on the profiler's
clock (``utils/profiling.py``'s recorder). Large, the host dispatched the
backward well ahead of the card; near zero, the backward's launches set its
pace. Layer: train step (``train/steps.py::make_train_step``)."""

import statistics


def read(rec):
    if rec.get("kind") != "train":
        return None
    try:
        from mikudance_tpu_torch.utils.profiling import recorded
    except ImportError:
        return None
    lags = [(s.device_ns[1] - s.host_ns[1]) / 1e6 for s in recorded()
            if s.name == "backward" and s.device_ns]
    return statistics.median(lags) if lags else None
