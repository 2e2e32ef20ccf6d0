"""Depth-map tool: character image -> depm-*.npy + depi-* preview.

Port of ``tools/depth_from_image.py`` (its default backend): the rebuild of
the reference's ``tools/depth_from_image.py``. DPT-hybrid-MiDaS depth from the
port's ``toolbox.dpt`` with the ``Intel/dpt-hybrid-midas`` ``pytorch_model.bin``
loaded as it is (``dpt.live_state_dict``, strict), bicubic-resized to the
image size, min-max normalized to [0,1], saved as npy (the reference-depth
input of the pipeline) plus a grayscale preview image.

Runs on the CUDA card in fp32 (cuDNN's TF32 convolutions, PyTorch's default,
are turned off around the network); ``--device cpu`` asks for the CPU by
name. Needs PIL.

Usage: python -m mikudance_tpu_torch.tools.depth_from_image --image_path char.jpg --save_dir out/
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np
import torch

from ..core.params import resolve_device
from ..toolbox._modules import fp32_convolutions
from ..toolbox.dpt import DPTHybridConfig, DPTHybridDepth, live_state_dict, preprocess

DEFAULT_WEIGHTS = "./pretrained_weights/dpt-hybrid-midas/pytorch_model.bin"


def load_dpt(weights_path: str, device) -> DPTHybridDepth:
    """The released ``.bin`` state_dict in the port's DPT, on ``device``."""
    sd = torch.load(weights_path, map_location="cpu", weights_only=True)
    model = DPTHybridDepth(DPTHybridConfig())
    model.load_state_dict(live_state_dict(sd), strict=True)
    return model.to(device).eval()


@torch.no_grad()
def run_depth(model: DPTHybridDepth, pixels: torch.Tensor) -> np.ndarray:
    """The network on preprocessed (1, 384, 384, 3) pixels: (384, 384)
    relative depth, fp32 with cuDNN's TF32 convolutions off."""
    with fp32_convolutions():
        return model(pixels.to(model.dpt.embeddings.cls_token.device))[0].float().cpu().numpy()


def predict_depth(model: DPTHybridDepth, frame) -> np.ndarray:
    """(H, W) relative depth at the model's 384^2 grid, fp32."""
    return run_depth(model, preprocess(np.asarray(frame)))


def resize_bicubic(depth: np.ndarray, H: int, W: int) -> np.ndarray:
    """Upsample the raw depth grid to the image size (the reference uses
    torch bicubic, ``depth_from_image.py:21-26``; PIL bicubic matches to within
    resampling-kernel tolerance, and the output is min-max normalized)."""
    from PIL import Image

    lo, hi = float(depth.min()), float(depth.max())
    scaled = (depth - lo) / max(hi - lo, 1e-12)
    img = Image.fromarray((scaled * 65535.0).astype(np.float32), mode="F")
    out = np.asarray(img.resize((W, H), Image.BICUBIC), dtype=np.float32)
    return out / 65535.0 * (hi - lo) + lo


def main(argv: Optional[Sequence[str]] = None) -> str:
    from PIL import Image

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--image_path", required=True)
    p.add_argument("--save_dir", default="./demo_samples/chars/")
    p.add_argument("--model", default=None, help="weights .bin path")
    p.add_argument("--device", default=None,
                   help="torch device; default: the CUDA card (raises without one)")
    args = p.parse_args(argv)

    frame = Image.open(args.image_path).convert("RGB")
    name = os.path.splitext(os.path.basename(args.image_path))[0]
    W, H = frame.size

    weights = args.model or DEFAULT_WEIGHTS
    if not os.path.exists(weights):
        raise SystemExit(f"weights not found at {weights}; see tools/download_weights.py "
                         "(--only dpt) for the source")
    depth = predict_depth(load_dpt(weights, resolve_device(args.device)), frame)

    depth = resize_bicubic(depth, H, W)
    dmin, dmax = float(depth.min()), float(depth.max())
    depth = (depth - dmin) / max(dmax - dmin, 1e-12)
    depth_np = depth[None]  # (1, H, W), [0,1]

    os.makedirs(args.save_dir, exist_ok=True)
    out = os.path.join(args.save_dir, f"depm-{name}.npy")
    np.save(out, depth_np)
    preview = (np.repeat(depth_np.transpose(1, 2, 0), 3, axis=-1) * 255).clip(0, 255)
    Image.fromarray(preview.astype(np.uint8)).save(
        os.path.join(args.save_dir, f"depi-{name}.png")
    )
    print(f"saved depm-{name}.npy and depi-{name}.png to {args.save_dir}")
    return out


if __name__ == "__main__":
    main()
