"""The diffusion schedule and the sliding windows, in numpy, as the
reference's diffusers ``DDIMScheduler`` and AnimateDiff "uniform" context
scheduler define them (MikuDance ``configs/inference/mikudance_config.yaml``:
linear betas 0.00085..0.012, ``rescale_betas_zero_snr``, ``timestep_spacing
"trailing"``, v-prediction; context 30 frames, overlap 8, stride 1, closed
loop, always at step 0).
"""

from __future__ import annotations

import numpy as np


def alphas_cumprod(sc: dict) -> np.ndarray:
    """alpha_bar over the training timesteps, float64."""
    n = int(sc["num_train_timesteps"])
    if sc["beta_schedule"] == "linear":
        betas = np.linspace(sc["beta_start"], sc["beta_end"], n, dtype=np.float64)
    elif sc["beta_schedule"] == "scaled_linear":
        betas = np.linspace(sc["beta_start"] ** 0.5, sc["beta_end"] ** 0.5, n,
                            dtype=np.float64) ** 2
    else:
        raise ValueError(f"unknown beta_schedule {sc['beta_schedule']!r}")
    ac = np.cumprod(1.0 - betas)
    if sc.get("rescale_betas_zero_snr"):
        # Lin et al. 2023: shift and scale sqrt(alpha_bar) so that its last
        # value is 0 and its first is kept
        s = np.sqrt(ac)
        s0, sT = s[0], s[-1]
        ac = ((s - sT) * s0 / (s0 - sT)) ** 2
    return ac


def step_pairs(sc: dict, steps: int):
    """(t, t_prev) of each inference step, trailing spacing; t_prev < 0 means
    alpha_bar = 1 (set_alpha_to_one)."""
    n = int(sc["num_train_timesteps"])
    if sc.get("timestep_spacing", "trailing") != "trailing":
        raise ValueError("only trailing spacing is defined here")
    ts = np.round(np.arange(n, 0, -n / steps)).astype(np.int64) - 1
    return list(zip(ts.tolist(), (ts - n // steps).tolist()))


def ddim_step(v, t: int, t_prev: int, x, ac: np.ndarray):
    """Deterministic DDIM (eta 0) with a v-prediction ``v``."""
    a_t = float(ac[t])
    a_prev = float(ac[t_prev]) if t_prev >= 0 else 1.0
    pred_x0 = a_t ** 0.5 * x - (1.0 - a_t) ** 0.5 * v
    pred_eps = a_t ** 0.5 * v + (1.0 - a_t) ** 0.5 * x
    return a_prev ** 0.5 * pred_x0 + (1.0 - a_prev) ** 0.5 * pred_eps


def _bit_reversed_fraction(val: int) -> float:
    out, scale = 0.0, 0.5
    while val:
        if val & 1:
            out += scale
        val >>= 1
        scale *= 0.5
    return out


def windows(frames: int, size: int, overlap: int, stride: int = 1, step: int = 0):
    """The uniform context windows of one denoise step (closed loop)."""
    if frames <= size:
        return [list(range(frames))]
    frac = _bit_reversed_fraction(step)
    stride = min(stride, int(np.ceil(np.log2(frames / size))) + 1)
    out = []
    for s in range(stride):
        st = 1 << s
        pad = int(round(frames * frac))
        for j in range(int(frac * st) + pad, frames + pad, size * st - overlap):
            out.append([e % frames for e in range(j, j + size * st, st)])
    return out


def min_snr_weight(ac: np.ndarray, t: int, gamma: float) -> float:
    """Min-SNR-gamma weight of a v-prediction loss: min(snr, gamma) / (snr + 1)."""
    snr = float(ac[t]) / (1.0 - float(ac[t]))
    return min(snr, gamma) / (snr + 1.0)
