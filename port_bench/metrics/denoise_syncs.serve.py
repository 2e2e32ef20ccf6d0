"""Host synchronisations in one denoise step: the ``host_syncs`` counter of
the program's ``denoise_step`` spans (every blocking copy, ``.item()`` and
the like that the host waited on inside the step, as PyTorch's sync debug
mode reports them), the mean over the traced clips' steps. Counted on the
card only. Layer: pipeline (``pipelines/video.py``, ``diffusion/ddim.py``)."""


def read(rec):
    if rec.get("kind") != "serve":
        return None
    try:
        from mikudance_tpu_torch.utils.profiling import HOST_SYNCS, recorded
    except ImportError:
        return None
    steps = [s.counters.get(HOST_SYNCS, 0) for s in recorded()
             if s.name == "denoise_step" and s.device_ns]
    return sum(steps) / len(steps) if steps else None
