"""Percent of the traced window in which no kernel, copy or memset ran on
the card: 1 - (the union of the device records' intervals) / the window.
Layer: device."""


def read(rec):
    if rec.get("kind") != "serve" or not rec.get("busy_s"):
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])
