"""Pose/face/hand skeleton-map extraction from a driving video.

Port of ``tools/inference_xpose_on_video.py``, the counterpart of the
reference XPose video driver (``inference_xpose_on_video.py:985-1135``): run
the UniPose open-vocabulary detector per frame for each vocabulary
(person-17 / face-68 / hand-21), filter with sigmoid-threshold + NMS
(``get_unipose_output_batch:853-925``), and render the skeleton maps on a
black canvas with the exact colormaps, producing the pose-/face-/hand-*.mp4
conditioning videos consumed by ``scripts/inference_video.py``.

Detection path (the reference's preprocessing): frames resized to short side
800 keeping aspect (T.RandomResize([800]), rounded to /32 here as the JAX
driver does), ImageNet normalization, CLIP ViT-B/32 text embeddings of
"a photo of {name}" (``text_encoding:22-45``), UniPose forward per frame,
per-image NMS.

Weights: --unipose_ckpt (unipose_swint.pth, loaded as it is, strict, less its
dead keys) + --clip_dir (openai/clip-vit-base-patch32 snapshot with
pytorch_model.bin and tokenizer files; the tokenizer comes from
``transformers``). Without weights pass --synthetic_keypoints to render a
synthetic keypoint track, which exercises the renderer contract end to end.
The networks run on the CUDA card in fp32 (cuDNN's TF32 convolutions, PyTorch's
default, are turned off around UniPose); ``--device cpu`` asks for the CPU by
name. Reading and writing video needs cv2 and PIL.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np
import torch

from ..toolbox import keypoints as kp
from ..toolbox._modules import fp32_convolutions
from ..toolbox import skeleton_render as sr
from ..toolbox.vocabularies import resolve_vocabulary

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)

# The three contract renderers (colormaps are part of the conditioning
# distribution). Every other category, and any free-text instance prompt,
# resolves through toolbox.vocabularies and renders with the generic renderer.
VOCABS = {
    "person": (kp.PERSON_KEYPOINTS, sr.render_pose),
    "face": (kp.FACE_KEYPOINTS, sr.render_face),
    "hand": (kp.HAND_KEYPOINTS, sr.render_hand),
}


def vocab_and_renderer(instance: str, keypoint_example=None):
    """(keypoint names, renderer(kpts, W, H)) for any instance prompt."""
    if instance in VOCABS and keypoint_example is None:
        return VOCABS[instance]
    names, skeleton = resolve_vocabulary(instance, keypoint_example)
    return names, (
        lambda kpts, w, h: sr.render_generic(kpts, w, h, skeleton)
    )


def synthetic_track(T: int, n: int, seed: int = 0) -> np.ndarray:
    """Smoothly-moving synthetic keypoints (renderer smoke path)."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(0.3, 0.7, size=(n, 2))
    out = []
    for t in range(T):
        drift = 0.05 * np.sin(2 * np.pi * (t / max(T, 1)) + np.arange(n)[:, None])
        out.append(np.clip(base + drift * rng.uniform(0.5, 1.0, (n, 1)), 0, 1))
    return np.stack(out)


class Detector:
    """UniPose + CLIP-text on one device, reused across the person/face/hand
    vocabularies. Static shapes as the JAX driver's: N_TXT instance slots,
    keypoint slots padded to num_body_points=68 with vis=0 (the reference
    pads to 100 and slices, ``get_unipose_output:810-818``)."""

    N_TXT = 4
    K = 68

    def __init__(self, unipose, text_model, tokenizer, device):
        self.device = torch.device(device)
        self.model = unipose.to(self.device).eval()
        self.text_model = text_model.to(self.device).eval()
        self.tokenizer = tokenizer

    @classmethod
    def from_files(cls, unipose_ckpt: str, clip_dir: str, model_config: Optional[str] = None,
                   device=None) -> "Detector":
        """The released UniPose checkpoint and a Hugging Face CLIP snapshot."""
        from transformers import CLIPTokenizer

        from ..core.params import resolve_device
        from ..toolbox.clip_text import CLIPTextEncoder, text_state_dict
        from ..toolbox.unipose import UniPose, live_state_dict
        from ..toolbox.xpose_config import build_unipose_from_config

        device = resolve_device(device)
        ckpt = torch.load(unipose_ckpt, map_location="cpu", weights_only=False)
        model = build_unipose_from_config(model_config) if model_config else UniPose()
        model.load_state_dict(live_state_dict(ckpt.get("model", ckpt)), strict=True)
        text = CLIPTextEncoder()
        text.load_state_dict(text_state_dict(torch.load(
            os.path.join(clip_dir, "pytorch_model.bin"), map_location="cpu",
            weights_only=False)), strict=True)
        return cls(model, text, CLIPTokenizer.from_pretrained(clip_dir), device)

    @torch.no_grad()
    def encode_text(self, names) -> torch.Tensor:
        """CLIP embeddings of "a photo of {name}" (``text_encoding:22-45``)."""
        prompts = [f"a photo of {n.lower().replace('_', ' ').replace('-', ' ')}"
                   for n in names]
        toks = self.tokenizer(prompts, padding="max_length", max_length=77,
                              return_tensors="np")
        ids = torch.as_tensor(np.asarray(toks["input_ids"]), dtype=torch.long,
                              device=self.device)
        return self.text_model(ids)  # (n, width)

    @torch.no_grad()
    def detect(self, frames_np, instance: str, kpt_names,
               box_threshold: float, iou_threshold: float):
        """frames_np: (T, h, w, 3) float in [0,1] resized; returns per-frame
        list of (n_i, len(kpt_names), 2) normalized keypoints."""
        from ..toolbox.unipose import postprocess

        inst_emb = self.encode_text([instance])
        kpt_emb = self.encode_text(kpt_names)
        n, width, dev = len(kpt_names), inst_emb.shape[-1], self.device

        obj = torch.zeros(1, self.N_TXT, width, device=dev)
        obj[0, :1] = inst_emb
        mask = torch.zeros(1, self.N_TXT, dtype=torch.bool, device=dev)
        mask[0, :1] = True
        kpt = torch.zeros(1, self.K, width, device=dev)
        kpt[0, :n] = kpt_emb
        vis = torch.zeros(1, self.K, device=dev)
        vis[0, :n] = 1.0

        results = []
        imgs = (frames_np - IMAGENET_MEAN) / IMAGENET_STD
        for t in range(imgs.shape[0]):
            frame = torch.as_tensor(np.ascontiguousarray(imgs[t: t + 1]), device=dev)
            with fp32_convolutions():
                out = self.model(frame, obj, mask, kpt, vis)
            res = postprocess(out, num_keypoints=n, score_threshold=box_threshold,
                              iou_threshold=iou_threshold)[0]
            results.append(res["keypoints"])
        return results


def resized_size(W: int, H: int, short: int = 800, multiple: int = 32):
    """(w, h) of a W x H frame resized to short side ~800 (reference's
    T.RandomResize([800])), dims rounded to a multiple as the JAX driver does."""
    scale = short / min(W, H)
    return (max(multiple, int(round(W * scale / multiple)) * multiple),
            max(multiple, int(round(H * scale / multiple)) * multiple))


def resize_short_side(frames, short: int = 800, multiple: int = 32):
    """PIL frames -> (T, h, w, 3) float array at ``resized_size``."""
    w, h = resized_size(*frames[0].size, short, multiple)
    return np.stack(
        [np.asarray(f.resize((w, h)), np.float32) / 255.0 for f in frames])


def main(argv: Optional[Sequence[str]] = None):
    from ..utils import media

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--video_path", "-i", required=True)
    p.add_argument("--save_dir", "-o", required=True)
    p.add_argument("--unipose_ckpt", default="./pretrained_weights/unipose_swint.pth")
    p.add_argument("--clip_dir", default="./pretrained_weights/clip-vit-base-patch32")
    p.add_argument(
        "--model_config", default=None,
        help="reference-style python model config with _base_ inheritance "
             "(XPose config_model/UniPose_SwinT.py grammar); default = the "
             "shipped SwinT geometry")
    p.add_argument(
        "--instance", default="all",
        help="'all' = the person/face/hand MikuDance conditioning trio; any "
             "of the 28 predefined categories (see toolbox.vocabularies.VOCAB)"
             " or arbitrary free text (open-vocabulary; uses the 'animal' "
             "keypoint set unless --keypoint_example overrides it)")
    p.add_argument(
        "--keypoint_example", default=None,
        help="name of a predefined keypoint vocabulary to pair with a "
             "free-text --instance (reference inference_xpose_on_image.py "
             "-k flag)")
    p.add_argument("--synthetic_keypoints", action="store_true")
    p.add_argument("--box_threshold", type=float, default=0.2)
    p.add_argument("--iou_threshold", type=float, default=0.4)
    p.add_argument("--real_human", action="store_true",
                   help="driving video shows a real human (use the human-"
                        "calibrated pose/face renderers)")
    p.add_argument("--device", default=None,
                   help="torch device of the networks; default: the CUDA card")
    args = p.parse_args(argv)

    frames = media.read_frames(args.video_path)
    fps = media.get_fps(args.video_path)
    W, H = frames[0].size
    T = len(frames)
    name = os.path.splitext(os.path.basename(args.video_path))[0]
    os.makedirs(args.save_dir, exist_ok=True)

    wanted = list(VOCABS) if args.instance == "all" else [args.instance]
    sel = {v: vocab_and_renderer(v, args.keypoint_example) for v in wanted}

    if args.synthetic_keypoints:
        tracks = {
            v: synthetic_track(T, len(sel[v][0]), seed=i)[:, None]
            for i, v in enumerate(wanted)
        }  # (T, 1 instance, K, 2)
        if "face" in tracks:
            tracks["face"] = tracks["face"] * 0.3 + 0.35
        if "hand" in tracks:
            tracks["hand"] = tracks["hand"] * 0.2 + 0.4
        dets = {k: [tracks[k][t] for t in range(T)] for k in wanted}
    else:
        if not os.path.exists(args.unipose_ckpt):
            raise SystemExit(
                f"UniPose checkpoint not found at {args.unipose_ckpt} — see "
                "tools/download_weights.py for sources, or pass "
                "--synthetic_keypoints for the renderer-only smoke path.")
        imgs = resize_short_side(frames)
        det = Detector.from_files(args.unipose_ckpt, args.clip_dir, args.model_config,
                                  args.device)
        dets = {}
        for vocab in wanted:
            names, _ = sel[vocab]
            print(f"detecting '{vocab}' ({len(names)} keypoints) on {T} frames")
            dets[vocab] = det.detect(imgs, vocab, names,
                                     args.box_threshold, args.iou_threshold)

    outs = []
    for vocab in wanted:
        names, render = sel[vocab]
        if vocab == "person" and args.real_human:
            render = sr.render_human_pose
        elif vocab == "face" and args.real_human:
            render = sr.render_human_face
        video = np.stack([
            render(np.asarray(dets[vocab][t]).reshape(-1, len(names), 2), W, H)
            for t in range(T)
        ])
        safe = vocab.replace(" ", "_")
        out = os.path.join(args.save_dir, f"{safe}-{name}.mp4")
        media.write_video(video, out, fps)
        print(f"saved {out}")
        outs.append(out)
    return outs


if __name__ == "__main__":
    main()
