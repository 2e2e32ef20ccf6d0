"""Camera-trajectory extraction from a driving video (DROID-SLAM wrapper).

Port of ``tools/get_camera_from_video.py``, the rebuild of the reference's
``DROID-SLAM/get_camera_from_video.py``: streams frames into an
externally-installed DROID-SLAM tracker (install from
https://github.com/princeton-vl/DROID-SLAM, as the reference requires), then
post-processes keyframe poses with the port's ``toolbox.camera`` (per-frame
linear+SLERP interpolation, w2c/c2w export, frustum OBJ). Without the
``droid`` package it exits with the JAX driver's message.

Usage: python -m mikudance_tpu_torch.tools.get_camera_from_video -i video.mp4 -o out_dir/
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np

from ..toolbox.camera import export_camera_files
from ..utils.media import read_frames

CALIB = [512.0, 512.0, 256.0, 256.0]  # fixed intrinsics (reference ``:486``)


def run_droid(frames, calib):
    """(keyframe timestamps, keyframe poses) from the DROID-SLAM tracker."""
    try:
        from droid import Droid  # external, not vendored (as in the reference)
    except ImportError as e:
        raise SystemExit(
            "DROID-SLAM is not installed. Install it from "
            "https://github.com/princeton-vl/DROID-SLAM (needs CUDA), run this "
            "tool there, and feed the exported w2c/c2w npys to inference."
        ) from e
    import torch

    class _Args:
        stereo = False
        weights = "droid.pth"
        buffer = 512
        beta = 0.3
        filter_thresh = 2.4
        warmup = 8
        keyframe_thresh = 4.0
        frontend_thresh = 16.0
        frontend_window = 25
        frontend_radius = 2
        frontend_nms = 1
        backend_thresh = 22.0
        backend_radius = 2
        backend_nms = 3
        upsample = False

    droid = Droid(_Args())
    intr = torch.as_tensor(calib)
    for t, frame in enumerate(frames):
        img = torch.as_tensor(np.asarray(frame)).permute(2, 0, 1)[None]
        droid.track(t, img, intrinsics=intr)
    n = droid.video.counter.value
    return (
        droid.video.tstamp[:n].cpu().numpy(),
        droid.video.poses[:n].cpu().numpy(),
    )


def main(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser("DROID SLAM camera extraction")
    p.add_argument("--video_path", "-i", required=True)
    p.add_argument("--save_path", "-o", required=True)
    args = p.parse_args(argv)

    frames = read_frames(args.video_path)
    name = os.path.splitext(os.path.basename(args.video_path))[0]
    steps, poses = run_droid(frames, CALIB)
    w2c_path, c2w_path = export_camera_files(
        args.save_path, name, steps, poses, len(frames)
    )
    print(f"saved {w2c_path} and {c2w_path}")
    return w2c_path, c2w_path


if __name__ == "__main__":
    main()
