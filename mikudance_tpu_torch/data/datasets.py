"""Training datasets (image stage & video stage), numpy/PIL host-side.

Copy of ``mikudance_tpu/data/datasets.py`` (it is numpy and PIL only), with
PIL imported inside the functions that need it. The reference's data
semantics (``src/dataset/anime_image_dataset.py``, ``anime_video_dataset.py``):

- one RandomResizedCrop parameter draw per SAMPLE, applied identically to the
  reference image, target, and every condition stream (the reference shares
  torch RNG state across transforms; here
  the crop params are sampled once, explicitly);
- target/ref normalized to [-1, 1]; skeleton/pose/face/hand stay [0, 1]
  (transform vs cond_transform);
- per-condition dropout to black at ``drop_ratio`` and whole-stream dropout
  for videos;
- CLIP preprocessing of the UN-augmented reference image;
- per-sample scene-motion field from cameras+depth;
- optional style-data branch (``style_ratio``) and camera-video branch
  (``cam_ratio``) by providing secondary sample lists.

Batches come out in this package's NHWC train-step schema.
"""

from __future__ import annotations

import dataclasses
import math
import random
import threading
import queue as queue_mod
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..models.clip_vision import to_clip_input
from ..pipelines.scene_motion import scene_motion_flow_np
from ..utils import media


@dataclasses.dataclass
class CropParams:
    top: float
    left: float
    height: float
    width: float  # fractions of the source image


def sample_crop(
    rng: random.Random, scale=(1.0, 1.0), ratio=(1.0, 1.1)
) -> CropParams:
    """torchvision RandomResizedCrop-style parameter draw (fractional)."""
    area = rng.uniform(*scale)
    log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
    aspect = math.exp(rng.uniform(*log_ratio))
    w = min(1.0, math.sqrt(area * aspect))
    h = min(1.0, math.sqrt(area / aspect))
    top = rng.uniform(0, 1.0 - h)
    left = rng.uniform(0, 1.0 - w)
    return CropParams(top, left, h, w)


def apply_crop(img, crop: CropParams, size_hw, normalize: bool) -> np.ndarray:
    """A PIL image cropped to ``crop`` and resized (bilinear) to ``size_hw``:
    float32 in [-1, 1] where ``normalize``, else in [0, 1]."""
    from PIL import Image

    W, H = img.size
    box = (
        crop.left * W,
        crop.top * H,
        (crop.left + crop.width) * W,
        (crop.top + crop.height) * H,
    )
    out = img.convert("RGB").resize(
        (size_hw[1], size_hw[0]), Image.BILINEAR, box=box
    )
    x = np.asarray(out, np.float32) / 255.0
    return x * 2.0 - 1.0 if normalize else x


@dataclasses.dataclass
class ImageSample:
    ref_image: str
    ref_skel: str
    tgt_image: str
    tgt_pose: str
    tgt_face: Optional[str] = None
    tgt_hand: Optional[str] = None


@dataclasses.dataclass
class VideoSample:
    ref_image: str
    ref_skel: str
    ref_depth: Optional[str]  # npy
    frames: List[str]  # target frame image paths (or a video path via loader)
    poses: List[str]
    faces: Optional[List[str]] = None
    hands: Optional[List[str]] = None
    w2c: Optional[str] = None  # npy (T,4,4)
    c2w: Optional[str] = None


class AnimeImageDataset:
    """Stage-1 dataset: single-frame samples."""

    def __init__(
        self,
        samples: Sequence[ImageSample],
        img_size=(768, 768),  # (H, W)
        img_scale=(1.0, 1.0),
        img_ratio=(1.0, 1.1),
        drop_ratio: float = 0.1,
        style_samples: Optional[Sequence[ImageSample]] = None,
        style_ratio: float = 0.01,
        seed: int = 0,
    ):
        self.samples = list(samples)
        self.style_samples = list(style_samples or [])
        self.img_size = img_size
        self.img_scale = img_scale
        self.img_ratio = img_ratio
        self.drop_ratio = drop_ratio
        self.style_ratio = style_ratio
        self.rng = random.Random(seed)

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        from PIL import Image

        rng = self.rng
        if self.style_samples and rng.random() < self.style_ratio:
            s = self.style_samples[rng.randrange(len(self.style_samples))]
        else:
            s = self.samples[index % len(self.samples)]

        ref_pil = media.load_image(s.ref_image)
        skel_pil = media.load_image(s.ref_skel)
        tgt_pil = media.load_image(s.tgt_image)
        pose_pil = media.load_image(s.tgt_pose)
        face_pil = media.load_image(s.tgt_face) if s.tgt_face else None
        hand_pil = media.load_image(s.tgt_hand) if s.tgt_hand else None
        black = Image.new("RGB", tgt_pil.size, (0, 0, 0))
        if face_pil is None or rng.random() < self.drop_ratio:
            face_pil = black
        if hand_pil is None or rng.random() < self.drop_ratio:
            hand_pil = black

        crop = sample_crop(rng, self.img_scale, self.img_ratio)
        hw = self.img_size
        out = {
            "ref_img": apply_crop(ref_pil, crop, hw, True),
            "tgt_img": apply_crop(tgt_pil, crop, hw, True),
            "ref_skel_img": apply_crop(skel_pil, crop, hw, False),
            "tgt_pose_img": apply_crop(pose_pil, crop, hw, False),
            "tgt_face_img": apply_crop(face_pil, crop, hw, False),
            "tgt_hand_img": apply_crop(hand_pil, crop, hw, False),
            "clip_img": to_clip_input(ref_pil)[0],
        }
        return out


class AnimeVideoDataset:
    """Stage-2 dataset: clip sampling with stride (sample_rate) + scene motion."""

    def __init__(
        self,
        samples: Sequence[VideoSample],
        img_size=(576, 576),
        n_sample_frames: int = 20,
        sample_rate: int = 3,
        img_scale=(1.0, 1.0),
        img_ratio=(1.0, 1.1),
        drop_ratio: float = 0.1,
        drop_vdo_ratio: float = 0.1,
        camera_samples: Optional[Sequence[VideoSample]] = None,
        cam_ratio: float = 0.15,
        seed: int = 0,
    ):
        self.samples = list(samples)
        self.camera_samples = list(camera_samples or [])
        self.img_size = img_size
        self.n_sample_frames = n_sample_frames
        self.sample_rate = sample_rate
        self.img_scale = img_scale
        self.img_ratio = img_ratio
        self.drop_ratio = drop_ratio
        self.drop_vdo_ratio = drop_vdo_ratio
        self.cam_ratio = cam_ratio
        self.rng = random.Random(seed)

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        from PIL import Image

        rng = self.rng
        if self.camera_samples and rng.random() < self.cam_ratio:
            s = self.camera_samples[rng.randrange(len(self.camera_samples))]
        else:
            s = self.samples[index % len(self.samples)]

        T = self.n_sample_frames
        span = (T - 1) * self.sample_rate + 1
        start = rng.randrange(max(1, len(s.frames) - span + 1))
        idx = [min(start + i * self.sample_rate, len(s.frames) - 1) for i in range(T)]

        frames = [media.load_image(s.frames[i]) for i in idx]
        poses = [media.load_image(s.poses[i]) for i in idx]
        black = Image.new("RGB", frames[0].size, (0, 0, 0))
        faces = (
            [media.load_image(s.faces[i]) for i in idx]
            if s.faces and rng.random() >= self.drop_vdo_ratio
            else [black] * T
        )
        hands = (
            [media.load_image(s.hands[i]) for i in idx]
            if s.hands and rng.random() >= self.drop_vdo_ratio
            else [black] * T
        )

        H, W = self.img_size
        h, w = H // 8, W // 8
        if s.w2c and s.c2w and s.ref_depth:
            w2c = np.load(s.w2c)[idx]
            c2w = np.load(s.c2w)[idx]
            depth = media.resize_depth(np.load(s.ref_depth), h, w)
        else:
            w2c = np.tile(np.eye(4)[None], (T, 1, 1))
            c2w = np.tile(np.eye(4)[None], (T, 1, 1))
            depth = np.zeros((h, w), np.float32)
        motion = scene_motion_flow_np(w2c, c2w, depth)
        if rng.random() < self.drop_vdo_ratio:
            motion = np.zeros_like(motion)

        ref_pil = media.load_image(s.ref_image)
        skel_pil = media.load_image(s.ref_skel)
        crop = sample_crop(rng, self.img_scale, self.img_ratio)
        hw = self.img_size
        out = {
            "tgt_vdo": np.stack([apply_crop(f, crop, hw, True) for f in frames]),
            "tgt_pose": np.stack([apply_crop(p, crop, hw, False) for p in poses]),
            "tgt_face": np.stack([apply_crop(f, crop, hw, False) for f in faces]),
            "tgt_hand": np.stack([apply_crop(hh, crop, hw, False) for hh in hands]),
            "scene_motion": motion.astype(np.float32),
            "ref_img": apply_crop(ref_pil, crop, hw, True),
            "ref_skel_img": apply_crop(skel_pil, crop, hw, False),
            "clip_img": to_clip_input(ref_pil)[0],
        }
        return out


class PrefetchLoader:
    """Minimal threaded batcher (the reference uses torch DataLoader with 4
    workers; host-side IO overlaps the device's steps)."""

    def __init__(self, dataset, batch_size: int, num_workers: int = 2, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)
        self.rng = random.Random(seed)

    def __iter__(self):
        q: queue_mod.Queue = queue_mod.Queue(maxsize=4)
        order = list(range(len(self.dataset)))
        self.rng.shuffle(order)

        def worker():
            for i in range(0, len(order) - self.batch_size + 1, self.batch_size):
                items = [self.dataset[j] for j in order[i : i + self.batch_size]]
                batch = {
                    k: np.stack([it[k] for it in items]) for k in items[0]
                }
                q.put(batch)
            q.put(None)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            b = q.get()
            if b is None:
                return
            yield b
