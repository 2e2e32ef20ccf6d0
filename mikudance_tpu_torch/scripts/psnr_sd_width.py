"""The SD-width fidelity gate on the card: the port's pipeline against the
reference's algorithm at SD1.5 widths.

The counterpart of the JAX package's ``scripts/psnr_sd_width.py``. The port's
``VideoPipeline`` runs the SD1.5 UNet geometry, (320, 640, 1280, 1280)
channels, 8 heads (8 motion-module heads), on 2 frames at 768^2 (9216-token
attention: K1, K2 and K3 at SD widths), with 257 context tokens, windows of 3
with an overlap of 1, ``--steps`` DDIM steps (default 2) and the tiny VAE,
on the weights of seeded twins (``torch.manual_seed(3)``, the denoiser's
temporal ``proj_out`` drawn from N(0, 0.05)) loaded through
``core/loaders.py``. The oracle (``scripts/_oracle.py``: the reference's
inference algorithm in plain PyTorch) runs on the same device in fp32 with
TF32 off. The gate passes at 35 dB of PSNR between the two decoded videos.

    python -m mikudance_tpu_torch.scripts.psnr_sd_width              # the fp32 gate
    python -m mikudance_tpu_torch.scripts.psnr_sd_width --dtype bf16 # the serving gate

``--dtype fp32`` (the default gate): the port's UNets in fp32 through the
attention kernels' fp32 path, with TF32 off for matmuls and cuDNN (the JAX
gate's "highest", for this gate only). ``--dtype bf16``: the port's UNets in
bf16 with PyTorch's own TF32 switches (matmul off, cuDNN on), what a serving
run uses. The autoencoder stays fp32 in both, as in the JAX gate.

Prints one JSON record (the JAX script's keys, plus the card's name and
power limit as nvidia-smi gives them, the kernels' launches and the peak
device memory of the port's run); writes it to ``--out`` only where given.
Exits non-zero under the bar. ``--device`` defaults to the card and raises
where there is none.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time

import numpy as np
import torch

BAR_DB = 35.0
# The gate's geometry (the JAX script's, :73-93)
SD_GATE = dict(T=2, H=768, W=768, s_ctx=257, ctx_frames=3, overlap=1)
# PyTorch's own switches (what a process that sets nothing runs): fp32
# matmuls in full fp32, cuDNN's fp32 convolutions in TF32
TORCH_TF32_DEFAULTS = (False, True)


@contextlib.contextmanager
def tf32(matmul: bool, cudnn: bool):
    """TF32 for fp32 matmuls and cuDNN convolutions as given, restored after."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = matmul, cudnn
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def card_name(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or the device."""
    if device.type != "cuda":
        return str(device)
    return subprocess.run(["nvidia-smi", "-i", str(device.index or 0),
                           "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def port_kernels():
    """The port's kernels, K1-K14, whose launches the gate records."""
    from ..kernels import conv2d, flash_attention as fa, group_norm, layer_norm, linear
    from ..kernels import mega_block, temporal_attention as ta

    return (fa.K1, fa.K2, ta.K3, fa.K4, group_norm.K5, layer_norm.K6, linear.K7, conv2d.K8,
            fa.K9, fa.K10, fa.K11, fa.K12, ta.K13, mega_block.K14)


def run_gate(dtypes=("fp32",), steps: int = 2, device=None, log=None, unet_cfg=None,
             geometry=None) -> list:
    """Build the twins once (SD1.5 widths unless ``unet_cfg``), run the oracle
    once (fp32, TF32 off), then the port once per dtype of ``dtypes`` against
    it, at ``geometry`` (default ``SD_GATE``); free the twins. Returns one
    record a dtype."""
    from ..core.configs import UNetConfig
    from ..core.params import resolve_device
    from . import _oracle as o

    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    dev = resolve_device(device)
    sd = unet_cfg or UNetConfig()  # SD1.5: (320, 640, 1280, 1280), 8 heads
    heads = sd.attention_heads
    t0 = time.perf_counter()
    tvae, tguide, tden = o.make_twins(sd.block_out_channels, heads, dev)
    log(f"psnr_sd_width: twins of widths {sd.block_out_channels} built on {dev} in "
        f"{time.perf_counter() - t0:.1f} s")
    g = dict(geometry or SD_GATE, steps=steps)
    t0 = time.perf_counter()
    with tf32(False, False):
        want_lat, want_video = o.run_oracle(tvae, tguide, tden, device=dev, **g)
    oracle_s = time.perf_counter() - t0
    log(f"psnr_sd_width: the oracle (fp32, TF32 off) in {oracle_s:.1f} s")
    kernels = port_kernels()
    records = []
    for dtype in dtypes:
        fp32 = dtype == "fp32"
        with tf32(*((False, False) if fp32 else TORCH_TF32_DEFAULTS)):
            pipe = o.port_pipeline(
                tvae, tguide, tden, unet_cfg=sd, vae_cfg=o.TINY_VAE, motion_heads=heads,
                H=g["H"], W=g["W"], steps=steps, scale=o.SCALE, ctx_frames=g["ctx_frames"],
                overlap=g["overlap"], unet_dtype=torch.float32 if fp32 else torch.bfloat16,
                device=dev)
            for k in kernels:
                k.launches = 0
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
                torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            got_video, got_lat = o.run_port(pipe, T=g["T"], H=g["H"], W=g["W"],
                                            s_ctx=g["s_ctx"])
            elapsed = time.perf_counter() - t0
        del pipe
        peak = torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda" else None
        psnr = o.psnr(got_video, want_video, 255.0)
        lat_err = float(np.max(np.abs(got_lat - want_lat.transpose(0, 2, 3, 1))))
        prec = ("fp32 through the kernels, TF32 off" if fp32
                else "bf16 (serving dtype), PyTorch's TF32 defaults")
        records.append({
            "metric": f"e2e PSNR vs torch oracle ({g['H']}x{g['W']}, {g['T']} frames, {steps} "
                      f"DDIM steps, UNet widths {sd.block_out_channels}, {prec})",
            "psnr_db": float(psnr),
            "latent_max_abs_err": lat_err,
            "bar_db": BAR_DB,
            "pass": bool(psnr >= BAR_DB),
            "elapsed_s": elapsed,
            "oracle_s": oracle_s,
            "peak_gib": peak,
            "device": card_name(dev),
            "launches": {k.name.split(" ")[0]: k.launches for k in kernels if k.launches},
        })
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    del tvae, tguide, tden
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=2, help="DDIM steps")
    ap.add_argument("--dtype", choices=("fp32", "bf16"), default="fp32",
                    help="the port's UNet dtype: fp32 with TF32 off (the default gate) or "
                         "bf16 with PyTorch's TF32 defaults (the serving gate)")
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    ap.add_argument("--out", default=None, help="also write the JSON record here")
    args = ap.parse_args(argv)
    (record,) = run_gate((args.dtype,), args.steps, args.device)
    line = json.dumps(record)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0 if record["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
