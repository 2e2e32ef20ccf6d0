"""GiB of reference-attention banks the denoise loop holds: the program's
``bank_bytes`` counter on its ``bank_kv`` span (the raw banks of every
(window, position) and their K/V over both CFG halves) over 2^30, the
largest over the traced clips (none where the program has no such counter).
Layer: pipeline (``pipelines/video.py``, ``VideoPipeline._denoise``)."""


def read(rec):
    if rec.get("kind") != "serve":
        return None
    try:
        from mikudance_tpu_torch.utils.profiling import recorded
    except ImportError:
        return None
    held = [s.counters["bank_bytes"] for s in recorded()
            if s.name == "bank_kv" and "bank_bytes" in s.counters]
    return max(held) / 2**30 if held else None
