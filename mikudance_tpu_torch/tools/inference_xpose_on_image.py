"""Skeleton-map extraction from a single image.

Port of ``tools/inference_xpose_on_image.py``, the counterpart of the
reference XPose image driver (``inference_xpose_on_image.py:555-685``): run
UniPose on one image for the chosen vocabulary (person / face / hand or any
category), filter with sigmoid-threshold + NMS, and render the skeleton map on
a black canvas, producing the ``skel-*.png`` reference-character
conditioning image consumed by ``scripts/inference_video.py``.

Weights and devices as in ``inference_xpose_on_video``. Without weights pass
--synthetic_keypoints for the renderer-only smoke path. Needs PIL.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np

from .inference_xpose_on_video import (
    Detector, resize_short_side, synthetic_track, vocab_and_renderer)


def main(argv: Optional[Sequence[str]] = None) -> str:
    from PIL import Image

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--image_path", "-i", required=True)
    p.add_argument("--save_dir", "-o", required=True)
    p.add_argument("--unipose_ckpt", default="./pretrained_weights/unipose_swint.pth")
    p.add_argument("--clip_dir", default="./pretrained_weights/clip-vit-base-patch32")
    p.add_argument(
        "--model_config", default=None,
        help="reference-style python model config with _base_ inheritance "
             "(XPose config_model grammar); default = shipped SwinT geometry")
    p.add_argument(
        "--instance", default="person",
        help="any of the 28 predefined categories or arbitrary free text "
             "(open-vocabulary; 'animal' keypoint set unless "
             "--keypoint_example overrides)")
    p.add_argument("--keypoint_example", default=None,
                   help="predefined keypoint vocabulary to pair with a "
                        "free-text --instance (reference -k flag)")
    p.add_argument("--synthetic_keypoints", action="store_true")
    p.add_argument("--box_threshold", type=float, default=0.2)
    p.add_argument("--iou_threshold", type=float, default=0.4)
    p.add_argument("--device", default=None,
                   help="torch device of the networks; default: the CUDA card")
    args = p.parse_args(argv)

    img = Image.open(args.image_path).convert("RGB")
    W, H = img.size
    name = os.path.splitext(os.path.basename(args.image_path))[0]
    os.makedirs(args.save_dir, exist_ok=True)

    names, render = vocab_and_renderer(args.instance, args.keypoint_example)
    if args.synthetic_keypoints:
        kpts = synthetic_track(1, len(names), 0)[0][None]  # (1, K, 2)
    else:
        if not os.path.exists(args.unipose_ckpt):
            raise SystemExit(
                f"UniPose checkpoint not found at {args.unipose_ckpt} — see "
                "tools/download_weights.py, or pass --synthetic_keypoints.")
        frames = resize_short_side([img])
        det = Detector.from_files(args.unipose_ckpt, args.clip_dir, args.model_config,
                                  args.device)
        kpts = det.detect(frames, args.instance, names,
                          args.box_threshold, args.iou_threshold)[0]
        kpts = np.asarray(kpts).reshape(-1, len(names), 2)

    canvas = render(kpts, W, H)
    out = os.path.join(
        args.save_dir, f"{args.instance.replace(' ', '_')}-{name}.png")
    Image.fromarray(canvas).save(out)
    print(f"saved {out}")
    return out


if __name__ == "__main__":
    main()
