"""Percent of its roofline that K2 reaches at heads of 64: the least time of
a clip's hd-64 cross-attention against the CLIP tokens (the SDXL driver's
``hd64_attention["cross"]``: the larger of operations over the bf16 peak and
bytes over the memory bandwidth, a call), over the device time of category
``k02_cross_hd64``, both over the traced clips; none in a cell without
such attention. Layer: attention kernels (``csrc/flash_cross.cu``)."""


def read(rec):
    peaks = rec.get("peaks")
    calls = rec.get("hd64_attention", {}).get("cross")
    spent = rec.get("categories", {}).get("k02_cross_hd64", 0.0)
    if rec.get("kind") != "serve" or not peaks or not calls or spent <= 0:
        return None
    least = sum(max(f / peaks["bf16_flops_per_s"], b / peaks["hbm_bytes_per_s"]) * n
                for f, b, n in calls) * rec["requests"]
    return 100.0 * least / spent
