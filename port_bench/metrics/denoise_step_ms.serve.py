"""Milliseconds of one denoise step: the pipeline's ``denoise`` phase (the
benchmark's timer, handed to ``VideoPipeline.__call__(timer=)``) summed over
the traced clips, over their steps. Layer: pipeline
(``pipelines/video.py``, ``VideoPipeline._denoise``)."""


def read(rec):
    if rec.get("kind") != "serve":
        return None
    steps = [p["denoise"] for p in rec["phases"] if "denoise" in p]
    if not steps:
        return None
    return 1e3 * sum(steps) / (len(steps) * rec["steps"])
