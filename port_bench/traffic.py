"""The one traffic generator. A traffic mix is a JSON file of parameters
under ``traffic/``; what a request or a batch holds is drawn from (seed,
request index) alone, so every seed gives the same sizes in every run and
two runs of one seed the same inputs.

- ``serve``: a video request as ``VideoPipeline.__call__`` takes it: uint8
  reference picture and skeleton (H, W, 3), uint8 pose frames (T, H, W, 3),
  face and hand streams absent (None) or drawn, scene motion zero
  ("none") or drawn (N(0, 0.1), as the trainer's synthetic batches), CLIP tokens N(0, 1) (1, tokens, 768) and the initial
  noise N(0, 1) (T, H/8, W/8, 4).
- ``train``: a host batch in the trainer's format (``tgt_vdo``,
  ``tgt_pose``, ``tgt_face``, ``tgt_hand``, ``scene_motion``, ``ref_img``,
  ``ref_skel_img``, ``clip_img``; float32, channels last), its condition
  drop (``uncond``) and its draws (the noise, the noise offset, the
  timestep).
"""

from __future__ import annotations

import numpy as np

from .weights import derive

SERVE, TRAIN = 1, 2  # stream keys


def rng(seed: int, stream: int, index: int) -> np.random.Generator:
    return np.random.default_rng(derive(seed, stream, index))


def serve_request(traffic: dict, seed: int, index: int):
    """The positional inputs of request ``index``."""
    r = rng(seed, SERVE, index)
    T, H, W = traffic["frames"], traffic["height"], traffic["width"]
    h, w = H // 8, W // 8

    def pictures(n):
        return r.integers(0, 256, (n, H, W, 3), dtype=np.uint8)

    ref, skel, pose = pictures(1)[0], pictures(1)[0], pictures(T)
    face = pictures(T) if traffic["face"] == "drawn" else None
    hand = pictures(T) if traffic["hand"] == "drawn" else None
    motion = (r.normal(0, 0.1, (T, h, w, 2)).astype(np.float32)
              if traffic["scene_motion"] == "drawn" else np.zeros((T, h, w, 2), np.float32))
    ctx = r.standard_normal((1, traffic["clip_tokens"], 768), dtype=np.float32)
    noise = r.standard_normal((T, h, w, 4), dtype=np.float32)
    return ref, skel, pose, face, hand, motion, ctx, noise


def train_batch(traffic: dict, seed: int, index: int) -> dict:
    """Host batch ``index``: the trainer's arrays, ``uncond`` (0.0 or 1.0,
    drawn at the mix's ``uncond_ratio``) and ``draws`` as numpy: ``noise``
    (B, T, h, w, 4), ``offset`` (B, 1, 1, 1, 4), ``t`` (B,) int64."""
    r = rng(seed, TRAIN, index)
    B, T, S = traffic["batch"], traffic["frames"], traffic["size"]
    h, C = S // 8, traffic["clip_size"]

    def u(lo, shape):
        return r.uniform(lo, 1, shape).astype(np.float32)

    batch = {
        "tgt_vdo": u(-1, (B, T, S, S, 3)),
        "tgt_pose": u(0, (B, T, S, S, 3)),
        "tgt_face": u(0, (B, T, S, S, 3)),
        "tgt_hand": u(0, (B, T, S, S, 3)),
        "scene_motion": r.normal(0, 0.1, (B, T, h, h, 2)).astype(np.float32),
        "ref_img": u(-1, (B, S, S, 3)),
        "ref_skel_img": u(0, (B, S, S, 3)),
        "clip_img": r.standard_normal((B, C, C, 3), dtype=np.float32),
    }
    uncond = float(r.random() < traffic["uncond_ratio"])
    draws = {
        "noise": r.standard_normal((B, T, h, h, 4), dtype=np.float32),
        "offset": r.standard_normal((B, 1, 1, 1, 4), dtype=np.float32),
        "t": r.integers(0, traffic["num_train_timesteps"], (B,)).astype(np.int64),
    }
    return {"batch": batch, "uncond": uncond, "draws": draws}
