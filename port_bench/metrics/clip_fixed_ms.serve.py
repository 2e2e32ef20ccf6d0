"""Milliseconds a clip spends outside the denoise loop: the pipeline's
``h2d_normalize`` + ``vae_encode`` + ``guidance_banks`` + ``decode_d2h``
phases (the benchmark's timer), averaged over the traced clips. Layer:
pipeline (``pipelines/video.py``)."""

FIXED = ("h2d_normalize", "vae_encode", "guidance_banks", "decode_d2h")


def read(rec):
    if rec.get("kind") != "serve":
        return None
    clips = [p for p in rec["phases"] if all(k in p for k in FIXED)]
    if not clips:
        return None
    return 1e3 * sum(sum(p[k] for k in FIXED) for p in clips) / len(clips)
