"""Host synchronisations in one train step: the ``host_syncs`` counter of
the program's ``train_step`` span and every span inside it (forward,
backward, gradients, optimizer), as PyTorch's sync debug mode reports them,
the mean over the traced steps. Counted on the card only. Layer: train step
(``train/steps.py``, ``diffusion/ddim.py``)."""


def read(rec):
    if rec.get("kind") != "train":
        return None
    try:
        from mikudance_tpu_torch.utils.profiling import HOST_SYNCS, recorded
    except ImportError:
        return None
    spans = recorded()
    steps = {s.request for s in spans if s.name == "train_step" and s.device_ns}
    if not steps:
        return None
    return sum(s.counters.get(HOST_SYNCS, 0) for s in spans if s.request in steps) / len(steps)
