"""Camera matrices + depth -> scene-motion flow npy (latent resolution).

Port of ``tools/scene_motion_tracking.py``: a thin CLI over the port's
``pipelines.scene_motion.scene_motion_flow_np`` (the rebuild of the
reference's ``tools/scene_motion_tracking.py``).

Usage:
    python -m mikudance_tpu_torch.tools.scene_motion_tracking --w2c w2c.npy \
        --c2w c2w.npy --depth depm.npy -W 768 -H 768 -o scene_motion.npy
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np

from ..pipelines.scene_motion import scene_motion_flow_np
from ..utils.media import resize_depth


def main(argv: Optional[Sequence[str]] = None) -> str:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--w2c", required=True)
    p.add_argument("--c2w", required=True)
    p.add_argument("--depth", default=None)
    p.add_argument("-W", type=int, default=768)
    p.add_argument("-H", type=int, default=768)
    p.add_argument("-o", "--output", required=True)
    args = p.parse_args(argv)

    h, w = args.H // 8, args.W // 8
    w2c, c2w = np.load(args.w2c), np.load(args.c2w)
    depth = (
        resize_depth(np.load(args.depth), h, w) if args.depth else np.zeros((h, w))
    )
    flow = scene_motion_flow_np(w2c, c2w, depth)  # (T, h, w, 2) NHWC
    np.save(args.output, flow)
    print(f"saved {args.output}: {flow.shape}")
    return args.output


if __name__ == "__main__":
    main()
