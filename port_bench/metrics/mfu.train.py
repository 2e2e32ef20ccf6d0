"""Percent of the card's bf16 peak that whole optimizer steps reach: the
operations of a step's forward and backward (``work.py``'s
``train_model_flops``: input gradients through every layer the loss reaches,
weight gradients of the trainable partition only; no remat recompute, no
batch preparation) times the traced steps, over their wall time (batch
preparation included) times the peak. Layer: model step."""


def read(rec):
    peaks = rec.get("peaks")
    if rec.get("kind") != "train" or not peaks or not rec.get("busy_s"):
        return None
    flops = rec["model_flops"] * rec["requests"]
    return 100.0 * flops / (sum(rec["walls"]) * peaks["bf16_flops_per_s"])
