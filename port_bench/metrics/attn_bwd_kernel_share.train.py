"""Share of the attention backward's calls in the traced train steps that
took K16, in %: the ``attn_bwd_kernel`` counter over it and
``attn_bwd_plain`` (a plain-math backward on the card), summed over the
program's spans of the ``train_step`` requests. None where the program
counts neither. Counted on the card only. Layer: attention kernels
(``kernels/_autograd.py::flash_backward``, ``csrc/flash_backward.cu``)."""


def read(rec):
    if rec.get("kind") != "train":
        return None
    try:
        from mikudance_tpu_torch.utils.profiling import recorded
    except ImportError:
        return None
    spans = recorded()
    steps = {s.request for s in spans if s.name == "train_step" and s.device_ns}
    kernel = sum(s.counters.get("attn_bwd_kernel", 0) for s in spans if s.request in steps)
    plain = sum(s.counters.get("attn_bwd_plain", 0) for s in spans if s.request in steps)
    if kernel + plain == 0:
        return None
    return 100.0 * kernel / (kernel + plain)
