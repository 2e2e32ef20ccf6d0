"""The weights-day parity gate of the port: key grammar -> module parity ->
end-to-end PSNR against the reference's algorithm.

The counterpart of the JAX package's ``scripts/verify_parity.py``, with the
same stages and verdict line:

1. ``convert``: the checkpoints' key grammar. With ``--selfcheck``, the tiny
   twins' state dicts load strictly into the port's modules through
   ``core/loaders.py``; with released weights, the files load with
   ``strict=True`` into the SD-width twins (``scripts/_oracle.py``), whose
   grammar is the released one, and their key counts are held to the
   expected ones;
2. ``module_parity`` (weights only): the guidance banks of the twin and of
   the port's ``GuidanceUNet`` (loaded from the same file) on the same
   inputs;
3. ``e2e_psnr``: the port's ``VideoPipeline`` against the oracle, the
   reference's inference algorithm in plain PyTorch, on the same inputs:
   PSNR of the decoded videos against the 35 dB bar;
4. one JSON verdict line (also written to ``--out``). A stage that raises is
   reported in the verdict as failed, with its error; the exit code is
   non-zero whenever ``pass`` is false.

    python -m mikudance_tpu_torch.scripts.verify_parity --selfcheck --device cpu
    python -m mikudance_tpu_torch.scripts.verify_parity --selfcheck        # on the card
    python -m mikudance_tpu_torch.scripts.verify_parity --weights_dir ./pretrained_weights

The weights mode needs the released ``{denoising_unet,reference_unet,
motion_module}-*.pth`` and the ``sd-vae-ft-mse`` directory under
``--weights_dir``; without them its ``convert`` stage fails and so does the
verdict (the JAX script falls back to the selfcheck there: this one reports
what was asked). ``--device`` defaults to the card and raises where there is
none.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

import numpy as np
import torch

BAR_DB = 35.0
# Key counts of the released files, from the twins' grammar at SD1.5 widths
EXPECTED_KEYS = {"reference_unet": 710, "denoising_unet": 686, "motion_module": 546}


def _stage(verdict, name, fn):
    try:
        verdict["stages"][name] = fn()
    except Exception as e:  # the gate always emits a verdict; pass is then false
        verdict["stages"][name] = {"ok": False, "error": f"{type(e).__name__}: {e}"}


def _e2e(tvae, tguide, tden, device, **geometry):
    from . import _oracle as o

    got, want, got_lat, want_lat = o.run_pipeline_vs_oracle(tvae, tguide, tden, device=device,
                                                            **geometry)
    p = o.psnr(got, want, 255.0)
    lat_p = o.psnr(got_lat, want_lat.transpose(0, 2, 3, 1), float(np.abs(want_lat).max()))
    return {"ok": bool(p >= BAR_DB), "psnr_db": round(p, 2), "latent_psnr_db": round(lat_p, 2)}


def run_selfcheck(device) -> dict:
    """The tiny twins: the gate's machinery end to end without checkpoints."""
    from ..core import loaders
    from ..core.configs import MotionModuleConfig
    from . import _oracle as o

    verdict = {"mode": "selfcheck", "stages": {}}
    tvae, tguide, tden = o.make_twins(o.TINY.block_out_channels, 4, device)

    def grammar():
        guide = loaders.load_guidance(tguide.state_dict(), device=device, unet_config=o.TINY)
        den = loaders.load_denoising(tden.state_dict(), device=device, unet_config=o.TINY,
                                     motion_config=MotionModuleConfig(num_attention_heads=4))
        return {"ok": True, "guide_keys": len(guide.state_dict()),
                "den_keys": len(den.state_dict())}

    _stage(verdict, "convert", grammar)
    _stage(verdict, "e2e_psnr", lambda: _e2e(tvae, tguide, tden, device))
    verdict["pass"] = all(s.get("ok", False) for s in verdict["stages"].values())
    return verdict


def run_real(args, device) -> dict:
    """The released checkpoints: the weights-day gate."""
    from ..core import loaders
    from ..core.configs import UNetConfig, VAEConfig
    from . import _oracle as o

    wd = args.weights_dir
    verdict = {"mode": "real", "weights_dir": wd, "stages": {}}
    sd_cfg = UNetConfig()  # SD1.5 widths
    twins = {}

    def find(pat):
        hits = sorted(glob.glob(os.path.join(wd, "**", pat), recursive=True))
        if not hits:
            raise FileNotFoundError(f"{pat} not under {wd}")
        return hits[-1]

    def grammar():
        files = {"reference_unet": find("reference_unet*.pth"),
                 "denoising_unet": find("denoising_unet*.pth"),
                 "motion_module": find("motion_module*.pth")}
        sds = {k: loaders.load_torch_state_dict(p) for k, p in files.items()}
        with torch.device(device):
            tguide = o.TUNet(sd_cfg.block_out_channels, 2, 8, 768, in_ch=20, man=True)
            tden = o.TUNet(sd_cfg.block_out_channels, 2, 8, 768, in_ch=4, motion=True)
        # the released dicts into the twins, strict: a key the twin grammar does
        # not produce is a blind spot of the port's loaders
        tguide.load_state_dict(sds["reference_unet"], strict=True)
        tden.load_state_dict({**sds["denoising_unet"], **sds["motion_module"]}, strict=True)
        twins.update(guide=tguide.eval(), den=tden.eval(), ref_sd=sds["reference_unet"])
        counts = {k: len(v) for k, v in sds.items()}
        return {"ok": True, **{f"{k}_keys": v for k, v in counts.items()},
                "expected_keys": EXPECTED_KEYS, "key_counts_match": counts == EXPECTED_KEYS}

    _stage(verdict, "convert", grammar)
    if not verdict["stages"]["convert"].get("ok"):
        verdict["pass"] = False
        return verdict

    def module_parity():
        # guidance banks: twin against the port's module from the same file
        h, w = args.height // 8, args.width // 8
        rng = np.random.default_rng(0)
        cond = rng.normal(0, 1, (1, h, w, 20)).astype(np.float32)
        mot = rng.normal(0, 1, (1, h, w, 2)).astype(np.float32)
        ctx = rng.normal(0, 1, (1, 257, 768)).astype(np.float32)
        guide = loaders.load_guidance(twins["ref_sd"], device=device)
        with torch.no_grad():
            banks = guide(*(torch.from_numpy(a).to(device) for a in (cond, mot)),
                          torch.zeros((1,), dtype=torch.int32, device=device),
                          torch.from_numpy(ctx).to(device))
            _, tbanks = twins["guide"](o._nchw(cond, device), torch.zeros(1, device=device),
                                       torch.from_numpy(ctx).to(device),
                                       motion_map=o._nchw(mot, device), write=True)
        worst = max(float((banks[k].float() - tv).abs().max()) for k, tv in tbanks.items())
        return {"ok": bool(worst < 5e-2), "worst_bank_abs_err": worst}

    _stage(verdict, "module_parity", module_parity)

    def full():
        vae_sd = loaders.load_torch_state_dict(
            loaders._find_weights(os.path.join(wd, "sd-vae-ft-mse")))
        with torch.device(device):
            tvae = o.TAutoencoderKL(**o.SD_VAE)
        tvae.load_state_dict(vae_sd, strict=True)
        return _e2e(tvae.eval(), twins["guide"], twins["den"], device, unet_cfg=sd_cfg,
                    vae_cfg=VAEConfig(), motion_heads=8, s_ctx=257, T=args.frames,
                    H=args.height, W=args.width, steps=args.steps)

    _stage(verdict, "e2e_psnr", full)
    verdict["pass"] = all(s.get("ok", False) for s in verdict["stages"].values())
    return verdict


def main(argv=None) -> int:
    from ..core.params import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--weights_dir", default="./pretrained_weights")
    ap.add_argument("--selfcheck", action="store_true",
                    help="the tiny twins (no checkpoints needed)")
    ap.add_argument("--height", type=int, default=256)
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--frames", type=int, default=5)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    ap.add_argument("--out", default=None, help="also write the verdict JSON here")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    verdict = run_selfcheck(device) if args.selfcheck else run_real(args, device)
    line = json.dumps(verdict)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0 if verdict["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
