"""Device milliseconds an optimizer step of the "elementwise / copies" group
(``categories/elementwise.json``), over the traced steps. Layer: models
(``models/*.py``), forward and backward."""


def read(rec):
    if rec.get("kind") != "train" or not rec.get("busy_s"):
        return None
    s = rec["groups"].get("elementwise")
    return None if s is None else 1e3 * s / rec["requests"]
