"""What the two trainers share: arguments, YAML -> configs, the validation
batch holder."""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import torch


def parse_args(doc: str, argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description=doc.splitlines()[0])
    p.add_argument("--config", required=True)
    p.add_argument("--synthetic", type=int, default=0,
                   help="train on this many seeded random batches instead of a dataset")
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--device", default=None,
                   help='where to run; default: the CUDA card (an error where there is '
                        'none); "cpu" runs on the CPU')
    return p.parse_args(argv)


def read_yaml(path: str) -> dict:
    import yaml

    with open(path) as f:
        return yaml.safe_load(f)


def compute_dtype(solver: dict) -> torch.dtype:
    mixed = solver.get("mixed_precision", "fp16") in ("fp16", "bf16")
    return torch.bfloat16 if mixed else torch.float32


def unet_overrides(cfg: dict):
    """``unet_overrides:`` (tiny widths for smoke runs) -> UNetConfig or None."""
    if not cfg.get("unet_overrides"):
        return None
    from ..core.configs import UNetConfig

    ov = cfg["unet_overrides"]
    return UNetConfig(
        block_out_channels=tuple(ov.get("block_out_channels", (320, 640, 1280, 1280))),
        attention_heads=int(ov.get("attention_heads", 8)),
    )


def make_schedule(cfg: dict):
    from ..diffusion.ddim import DDIMSchedule

    kw = cfg.get("noise_scheduler_kwargs", {})
    zero_snr = bool(cfg.get("enable_zero_snr", True))
    return DDIMSchedule.create(
        num_train_timesteps=int(kw.get("num_train_timesteps", 1000)),
        beta_start=float(kw.get("beta_start", 0.00085)),
        beta_end=float(kw.get("beta_end", 0.012)),
        beta_schedule=kw.get("beta_schedule", "scaled_linear"),
        prediction_type="v_prediction" if zero_snr else "epsilon",
        rescale_betas_zero_snr=zero_snr,
    )


def make_train_config(cfg: dict, batch_size: int, trainable_substrings):
    from ..train.steps import TrainConfig

    solver = cfg.get("solver", {})
    accum = int(solver.get("gradient_accumulation_steps", 1))
    lr = float(solver.get("learning_rate", 1e-5))
    if solver.get("scale_lr"):
        # the batch is global (the ranks split it): no device-count factor
        lr *= accum * batch_size
    zero_snr = bool(cfg.get("enable_zero_snr", True))
    return TrainConfig(
        learning_rate=lr,
        adam_b1=float(solver.get("adam_beta1", 0.9)),
        adam_b2=float(solver.get("adam_beta2", 0.999)),
        adam_eps=float(solver.get("adam_epsilon", 1e-8)),
        weight_decay=float(solver.get("adam_weight_decay", 1e-2)),
        max_grad_norm=float(solver.get("max_grad_norm", 1.0)),
        uncond_ratio=float(cfg.get("uncond_ratio", 0.1)),
        noise_offset=float(cfg.get("noise_offset", 0.05)),
        snr_gamma=float(cfg.get("snr_gamma", 5.0)),
        prediction_type="v_prediction" if zero_snr else "epsilon",
        trainable_substrings=trainable_substrings,
        lr_scheduler=solver.get("lr_scheduler", "constant"),
        lr_warmup_steps=int(solver.get("lr_warmup_steps", 0)),
        max_train_steps=int(solver.get("max_train_steps", 0)),
        gradient_accumulation_steps=accum,
    )


def validation_steps(cfg: dict) -> int:
    return int(cfg.get("validation_steps", cfg.get("val", {}).get("validation_steps", 3000)))


class FirstBatch:
    """Keeps the first batch that passes through, for the validation run."""

    def __init__(self):
        self.batch = None

    def capture(self, it):
        for bt in it:
            if self.batch is None:
                self.batch = bt
            yield bt
