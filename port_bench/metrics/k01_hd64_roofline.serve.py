"""Percent of its roofline that K1 reaches at heads of 64: the least time of
a clip's hd-64 self-attention (the SDXL driver's ``hd64_attention["self"]``:
for each call the larger of its operations over the bf16 peak and its bytes
over the memory bandwidth), over the device time of category
``k01_attention_hd64``, both over the traced clips; none in a cell without
such attention. Layer: attention kernels (``csrc/flash_anchor_wg.cu``)."""


def read(rec):
    peaks = rec.get("peaks")
    calls = rec.get("hd64_attention", {}).get("self")
    spent = rec.get("categories", {}).get("k01_attention_hd64", 0.0)
    if rec.get("kind") != "serve" or not peaks or not calls or spent <= 0:
        return None
    least = sum(max(f / peaks["bf16_flops_per_s"], b / peaks["hbm_bytes_per_s"]) * n
                for f, b, n in calls) * rec["requests"]
    return 100.0 * least / spent
