"""Percent of the card's bf16 peak that whole clips reach: the model
operations of a clip (``work.py``'s ``serve_model_flops``: both UNets and
the VAE as ``VideoPipeline`` runs them) times the traced clips, over their
wall time times the peak. Layer: the model step (both UNets and the VAE)."""


def read(rec):
    peaks = rec.get("peaks")
    if rec.get("kind") != "serve" or not peaks or not rec.get("busy_s"):
        return None
    flops = rec["model_flops"] * rec["requests"]
    return 100.0 * flops / (sum(rec["walls"]) * peaks["bf16_flops_per_s"])
