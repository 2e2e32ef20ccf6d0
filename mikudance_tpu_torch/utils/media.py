"""Media IO and image preprocessing.

The port's own copy of ``mikudance_tpu/utils/media.py`` (that module imports
the JAX CLIP tower). It mirrors the reference's util surface
(`src/utils/util.py`: ``read_frames:106``, ``get_fps:123``,
``save_videos_grid:86``) with PIL, cv2 and imageio, each imported inside the
functions that need it: the sampler itself needs none of them.

Preprocessing parity:
- VAE streams use lanczos resize (diffusers ``VaeImageProcessor`` default);
  the reference normalizes the ref image to [-1, 1] and leaves skeleton /
  pose / face / hand in [0, 1] (``do_normalize=False`` cond processor,
  `pipeline_mikudance.py:71-79`).
- CLIP input: bicubic resize to 224 + CLIP mean/std normalization
  (`pipeline_mikudance.py:405-408`), ``models.clip_vision.to_clip_input``.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np
import torch

from ..models.clip_vision import to_clip_input  # noqa: F401  (part of this surface)


def read_frames(path: str) -> list:
    """All frames of a video file as PIL images (cv2 backend; the reference
    uses PyAV, `src/utils/util.py:106`)."""
    import cv2
    from PIL import Image

    cap = cv2.VideoCapture(path)
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(Image.fromarray(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)))
    cap.release()
    return frames


def get_fps(path: str) -> float:
    import cv2

    cap = cv2.VideoCapture(path)
    fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
    cap.release()
    return float(fps)


def write_video(frames_u8: np.ndarray, path: str, fps: float = 30.0) -> None:
    """(T, H, W, 3) uint8 RGB -> mp4/gif."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if os.path.splitext(path)[1].lower() == ".gif":
        import imageio.v2 as iio

        iio.mimsave(path, list(frames_u8), fps=fps)
        return
    import cv2

    _, H, W, _ = frames_u8.shape
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (W, H))
    for f in frames_u8:
        w.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    w.release()


def save_video_grid(rows: List[np.ndarray], path: str, fps: float = 30.0) -> None:
    """Stack (T, H, W, 3) float [0, 1] arrays vertically and write a video:
    the reference's 3-row comparison mp4 (`scripts/inference_video.py:228-234`)."""
    T = rows[0].shape[0]
    assert all(r.shape[0] == T for r in rows)
    grid = np.concatenate(rows, axis=1)
    write_video((np.clip(grid, 0, 1) * 255).astype(np.uint8), path, fps)


# ------------------------------------------------------------- preprocessing

def load_image(path: str):
    from PIL import Image

    return Image.open(path).convert("RGB")


def to_u8_frame(img, height: int, width: int) -> np.ndarray:
    """PIL image -> (H, W, 3) uint8, resized only (1 is PIL's LANCZOS). The
    pipeline scales on the device (``pipelines/video.py::to_unit_float``), so
    frames travel at one byte a pixel."""
    return np.asarray(img.resize((width, height), 1), np.uint8)


def frames_to_u8(frames: list, height: int, width: int) -> np.ndarray:
    return np.stack([to_u8_frame(f, height, width) for f in frames])


def resize_depth(depth: np.ndarray, h: int, w: int) -> np.ndarray:
    """Depth map -> (h, w) float32, bilinear (the reference uses
    skimage.resize, `scripts/inference_video.py:184`)."""
    from PIL import Image

    d = np.asarray(depth, dtype=np.float32)
    if d.ndim == 3:
        d = d[0]
    return np.array(Image.fromarray(d).resize((w, h), Image.BILINEAR), dtype=np.float32)


def torch_seed_noise(seed: int, shape, dtype_half: bool = True) -> np.ndarray:
    """Initial latent noise from torch's CPU generator, for bit-parity with
    the reference (`randn_tensor` with a manual-seed CPU generator and fp16
    latents: `pipeline_mikudance.py:440-450`, `inference_video.py:105`).
    A generator of its own: the global one is left alone."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    dt = torch.float16 if dtype_half else torch.float32
    return torch.randn(shape, generator=g, dtype=dt).float().numpy()
