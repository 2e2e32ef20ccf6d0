"""Device milliseconds of one denoise step: the median, over the traced
clips' steps, of the program's own ``denoise_step`` spans (``VideoPipeline``
``_denoise``: the window gather, the denoiser, the fusion and the DDIM
update), from their CUDA events on the profiler's clock
(``utils/profiling.py``'s recorder; none without it). Layer: pipeline
(``pipelines/video.py``)."""

import statistics


def read(rec):
    if rec.get("kind") != "serve":
        return None
    try:
        from mikudance_tpu_torch.utils.profiling import recorded
    except ImportError:
        return None
    steps = [s.device_ms for s in recorded() if s.name == "denoise_step" and s.device_ns]
    return statistics.median(steps) if steps else None
