"""Percent of its roofline that the attention group reaches: the least time
of the attention the port's kernels compute in a clip (``work.py``'s
``serve_attention_calls``: for each call the larger of its operations over
the bf16 peak and its bytes over the memory bandwidth), over the device time
of the group "attention" (``categories/*.json``: K1-K4, K9-K13), both over
the traced clips. Layer: attention kernels (``kernels/flash_attention.py``,
``temporal_attention.py``; ``csrc/flash_*.cu``, ``temporal_attention.cu``)."""


def read(rec):
    peaks = rec.get("peaks")
    if rec.get("kind") != "serve" or not peaks:
        return None
    spent = rec["groups"].get("attention", 0.0)
    if spent <= 0:
        return None
    least = sum(max(f / peaks["bf16_flops_per_s"], b / peaks["hbm_bytes_per_s"]) * n
                for f, b, n in rec["attention_calls"]) * rec["requests"]
    return 100.0 * least / spent
