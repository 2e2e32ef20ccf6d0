"""Milliseconds of ``make_train_step``'s step (``diffusion_loss``, backward,
``Optimizer.update``): a span with a device sync in the benchmark's driver,
averaged over the traced steps. Layer: train step (``train/steps.py``)."""


def read(rec):
    if rec.get("kind") != "train":
        return None
    step = [p["train step"] for p in rec["phases"] if "train step" in p]
    return 1e3 * sum(step) / len(step) if step else None
