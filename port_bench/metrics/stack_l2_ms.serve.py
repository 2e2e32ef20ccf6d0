"""Device milliseconds a denoise step spends in the level-2 spatial
transformer stacks (SDXL's 60 blocks at 1024 tokens): the sum of the
program's ``spatial_stack_l2`` spans inside each ``denoise_step`` span, from
their CUDA events on the profiler's clock, the median over the traced
clips' steps (none where the program has no such span). Layer: models
(``models/unet.py``, ``models/layers.py``'s ``SpatialTransformer``)."""

import statistics


def read(rec):
    if rec.get("kind") != "serve":
        return None
    try:
        from mikudance_tpu_torch.utils.profiling import recorded
    except ImportError:
        return None
    spans = recorded()
    by_index = {s.index: s for s in spans}
    steps = {s.index: 0.0 for s in spans if s.name == "denoise_step" and s.device_ns}
    for s in spans:
        if s.name != "spatial_stack_l2" or not s.device_ns:
            continue
        up = s.parent
        while up is not None and up not in steps:
            up = by_index[up].parent
        if up is not None:
            steps[up] += s.device_ms
    held = [ms for ms in steps.values() if ms > 0]
    return statistics.median(held) if held else None
