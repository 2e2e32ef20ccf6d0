"""Milliseconds of a step's batch preparation (the trainer's VAE encodes and
CLIP tower, as ``scripts/train_stage2.py`` wires ``make_encoder_fns``): a
span with a device sync in the benchmark's driver, averaged over the traced
steps. Layer: trainer's batch preparation (``train/runner.py``)."""


def read(rec):
    if rec.get("kind") != "train":
        return None
    prep = [p["batch preparation"] for p in rec["phases"] if "batch preparation" in p]
    return 1e3 * sum(prep) / len(prep) if prep else None
