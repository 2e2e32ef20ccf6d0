"""Device milliseconds a clip of the "elementwise / copies" group
(``categories/elementwise.json``: ATen's elementwise, copy, cat, index and
upsample kernels), over the traced clips. Layer: models
(``models/layers.py``, ``resnet.py``, ``motion_module.py``, ``unet.py``,
``vae.py``)."""


def read(rec):
    if rec.get("kind") != "serve" or not rec.get("busy_s"):
        return None
    ms = rec["groups"].get("elementwise")
    return None if ms is None else 1e3 * ms / rec["requests"]
