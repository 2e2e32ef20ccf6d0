"""Zero-SNR v-prediction DDIM: numpy schedule, torch fp32 step.

Semantics match the diffusers ``DDIMScheduler`` configuration used by the
reference (``configs/inference/mikudance_config.yaml:24-33``: linear betas
0.00085..0.012, ``rescale_betas_zero_snr``, ``timestep_spacing "trailing"``,
``prediction_type "v_prediction"``, ``clip_sample false``). The schedule math
is copied from ``mikudance_tpu/diffusion/ddim.py:26-68`` and stays numpy; the
per-step update runs in torch fp32 on the latents' device, and so does the
training half (``add_noise``, ``get_velocity``, ``snr``,
``min_snr_loss_weight``).
"""

from __future__ import annotations

import dataclasses
from typing import Literal, Tuple

import numpy as np
import torch

BetaSchedule = Literal["linear", "scaled_linear"]
PredictionType = Literal["epsilon", "v_prediction"]


def make_betas(
    num_train_timesteps: int = 1000,
    beta_start: float = 0.00085,
    beta_end: float = 0.012,
    beta_schedule: BetaSchedule = "linear",
) -> np.ndarray:
    if beta_schedule == "linear":
        return np.linspace(beta_start, beta_end, num_train_timesteps, dtype=np.float64)
    if beta_schedule == "scaled_linear":
        return (
            np.linspace(
                beta_start**0.5, beta_end**0.5, num_train_timesteps, dtype=np.float64
            )
            ** 2
        )
    raise ValueError(f"unknown beta_schedule {beta_schedule!r}")


def rescale_zero_terminal_snr(betas: np.ndarray) -> np.ndarray:
    """Rescale betas so the terminal SNR is exactly zero (Lin et al. 2023).

    Mirrors diffusers' ``rescale_zero_terminal_snr``: shift & scale
    sqrt(alpha_bar) so sqrt(alpha_bar[T]) == 0 and sqrt(alpha_bar[0]) is kept.
    """
    alphas = 1.0 - betas
    alphas_cumprod = np.cumprod(alphas)
    alphas_bar_sqrt = np.sqrt(alphas_cumprod)

    alphas_bar_sqrt_0 = alphas_bar_sqrt[0].copy()
    alphas_bar_sqrt_T = alphas_bar_sqrt[-1].copy()

    alphas_bar_sqrt = alphas_bar_sqrt - alphas_bar_sqrt_T
    alphas_bar_sqrt = alphas_bar_sqrt * alphas_bar_sqrt_0 / (
        alphas_bar_sqrt_0 - alphas_bar_sqrt_T
    )

    alphas_bar = alphas_bar_sqrt**2
    alphas = np.empty_like(alphas_bar)
    alphas[0] = alphas_bar[0]
    alphas[1:] = alphas_bar[1:] / alphas_bar[:-1]
    return 1.0 - alphas


@dataclasses.dataclass(frozen=True)
class DDIMSchedule:
    """Immutable DDIM noise schedule; ``alphas_cumprod`` is float32 numpy."""

    alphas_cumprod: np.ndarray  # [num_train_timesteps]
    num_train_timesteps: int
    prediction_type: PredictionType
    final_alpha_cumprod: float  # alpha_bar for the "t=-1" step (1.0: set_alpha_to_one)

    @classmethod
    def create(
        cls,
        num_train_timesteps: int = 1000,
        beta_start: float = 0.00085,
        beta_end: float = 0.012,
        beta_schedule: BetaSchedule = "linear",
        prediction_type: PredictionType = "v_prediction",
        rescale_betas_zero_snr: bool = True,
        set_alpha_to_one: bool = True,
    ) -> "DDIMSchedule":
        betas = make_betas(num_train_timesteps, beta_start, beta_end, beta_schedule)
        if rescale_betas_zero_snr:
            betas = rescale_zero_terminal_snr(betas)
        alphas_cumprod = np.cumprod(1.0 - betas)
        final = 1.0 if set_alpha_to_one else float(alphas_cumprod[0])
        return cls(
            alphas_cumprod=alphas_cumprod.astype(np.float32),
            num_train_timesteps=num_train_timesteps,
            prediction_type=prediction_type,
            final_alpha_cumprod=final,
        )

    def timesteps(
        self, num_inference_steps: int, spacing: str = "trailing"
    ) -> np.ndarray:
        """Inference timestep sequence (descending), static numpy.

        "trailing" spacing per diffusers: arange(T, 0, -T/steps).round()-1.
        """
        T = self.num_train_timesteps
        if spacing == "trailing":
            step_ratio = T / num_inference_steps
            return np.round(np.arange(T, 0, -step_ratio)).astype(np.int64) - 1
        if spacing == "leading":
            step_ratio = T // num_inference_steps
            ts = (np.arange(0, num_inference_steps) * step_ratio).round()[::-1]
            return ts.astype(np.int64) + 1  # steps_offset=1
        raise ValueError(f"unknown timestep spacing {spacing!r}")

    def step(
        self,
        model_output: torch.Tensor,
        timestep: int,
        prev_timestep: int,
        sample: torch.Tensor,
    ) -> torch.Tensor:
        """One deterministic (eta=0) DDIM update x_t -> x_{t_prev}, in fp32.

        ``prev_timestep`` may be negative, selecting ``final_alpha_cumprod``.
        """
        def f32(a):
            return torch.tensor(a, dtype=torch.float32, device=sample.device)

        a_t = f32(self.alphas_cumprod[int(timestep)])
        a_prev = f32(self.alphas_cumprod[int(prev_timestep)] if prev_timestep >= 0
                     else self.final_alpha_cumprod)
        b_t = 1.0 - a_t

        x = sample.float()
        out = model_output.float()
        sqrt_a, sqrt_b = torch.sqrt(a_t), torch.sqrt(b_t)
        if self.prediction_type == "v_prediction":
            pred_x0 = sqrt_a * x - sqrt_b * out
            pred_eps = sqrt_a * out + sqrt_b * x
        elif self.prediction_type == "epsilon":
            pred_x0 = (x - sqrt_b * out) / sqrt_a
            pred_eps = out
        else:
            raise ValueError(self.prediction_type)

        prev = torch.sqrt(a_prev) * pred_x0 + torch.sqrt(1.0 - a_prev) * pred_eps
        return prev.to(sample.dtype)

    # ------------------------------------------------------------- training
    def _gather(self, t: torch.Tensor) -> torch.Tensor:
        """alpha_bar at integer timesteps ``t`` (B,), fp32 on t's device."""
        table = torch.from_numpy(self.alphas_cumprod).to(t.device)
        return table[t.long()]

    def _signal_and_noise(self, x0: torch.Tensor, t: torch.Tensor):
        a = self._gather(t).reshape((-1,) + (1,) * (x0.ndim - 1))
        return torch.sqrt(a), torch.sqrt(1.0 - a)

    def add_noise(self, x0: torch.Tensor, noise: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        sa, sb = self._signal_and_noise(x0, t)
        return (sa * x0.float() + sb * noise.float()).to(x0.dtype)

    def get_velocity(self, x0: torch.Tensor, noise: torch.Tensor,
                     t: torch.Tensor) -> torch.Tensor:
        sa, sb = self._signal_and_noise(x0, t)
        return (sa * noise.float() - sb * x0.float()).to(x0.dtype)

    def snr(self, t: torch.Tensor) -> torch.Tensor:
        """SNR(t) = alpha_bar / (1 - alpha_bar); 0 at the last timestep of a
        zero-terminal-SNR schedule."""
        a = self._gather(t)
        return a / (1.0 - a)


def inference_step_pairs(
    schedule: DDIMSchedule, num_inference_steps: int, spacing: str = "trailing"
) -> Tuple[np.ndarray, np.ndarray]:
    """(timesteps, prev_timesteps) int32 arrays for the loop over DDIM steps."""
    ts = schedule.timesteps(num_inference_steps, spacing)
    prev = ts - schedule.num_train_timesteps // num_inference_steps
    return ts.astype(np.int32), prev.astype(np.int32)


def min_snr_loss_weight(schedule: DDIMSchedule, t: torch.Tensor, gamma: float,
                        prediction_type: PredictionType) -> torch.Tensor:
    """Min-SNR-gamma per-sample loss weights (Hang et al.): ``min(snr, gamma) /
    snr`` for epsilon prediction, ``min(snr, gamma) / (snr + 1)`` for
    v-prediction."""
    snr = schedule.snr(t)
    capped = torch.clamp(snr, max=gamma)
    if prediction_type == "v_prediction":
        return capped / (snr + 1.0)
    return capped / torch.clamp(snr, min=1e-8)
