"""The port's long-clip bank tiers against the JAX package's, on the CPU.

The tiny bundle and inputs of ``test_torch_port_pipeline.py`` (same seeded
weights in both packages) go through ``VideoPipeline`` under the configs that
select each tier: per-step banks, cached-grouped, the deduplicated int8
cache in both ``guidance_clip_mode``s, and ``auto`` past its budget. Latents
agree with the JAX pipeline within 1e-3, and inside the port every tier
agrees with the cached path. ``quantize_banks`` and ``choose_bank_group`` are
held to the JAX functions exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mikudance_tpu.core.configs import ContextConfig, PipelineConfig
from mikudance_tpu.pipelines import video as jvideo
from mikudance_tpu_torch.pipelines import video
from test_torch_port_pipeline import H, T, W, h, inputs, pipes, w  # noqa: F401 (pipes: fixture)

def tier_config(**change):
    return PipelineConfig(width=W, height=H, num_inference_steps=3, guidance_scale=3.5,
                          context=ContextConfig(frames=3, overlap=1), **change)


# 5 frames in three 3-frame windows are 9 positions. Three windows allow groups
# of one or three: a budget of 3 or 4 positions gives groups of one window, a
# budget of 9 one group of three.
TIERS = {
    "per_step": dict(bank_mode="per_step", cached_bank_positions=3),
    "per_step_one_group": dict(bank_mode="per_step", cached_bank_positions=9),
    "auto_past_budget": dict(bank_mode="auto", cached_bank_positions=4),
    "cached_grouped": dict(bank_mode="cached", max_denoise_frame_batch=4),
    "cached_q8_reference_inference": dict(bank_mode="cached_q8", max_denoise_frame_batch=3),
    "cached_q8_cond": dict(bank_mode="cached_q8", guidance_clip_mode="cond",
                           cached_bank_positions=4),
}


@pytest.mark.parametrize("tier", sorted(set(TIERS) - {"per_step_one_group"}))
def test_long_clip_tier_matches_jax(pipes, tier):
    """Each bank tier of the port against the JAX pipeline under the same
    config: latents within 1e-3 (fp32; the int8 rounding is the same in
    both, so q8 holds to the same tolerance)."""
    port, jpipe = pipes
    cfg = tier_config(**TIERS[tier])
    args = inputs(3)
    want = np.asarray(jvideo.VideoPipeline(jpipe.bundle, cfg)(*args, decode=False))
    got = video.VideoPipeline(port.bundle, cfg, device="cpu")(*args, decode=False)
    assert got.dtype == torch.float32 and got.shape == (T, h, w, 4)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3, rtol=0)


@pytest.mark.parametrize("tier,atol", [("per_step", 1e-4), ("per_step_one_group", 1e-4),
                                       ("cached_grouped", 1e-4),
                                       ("auto_past_budget", 1e-4),
                                       ("cached_q8_reference_inference", 5e-2)])
def test_long_clip_tier_equals_cached(pipes, tier, atol):
    """Inside the port: the streamed tiers give the cached path's latents
    (two CFG passes against the doubled batch, raw banks against projected
    ones: fp32 summation order, 1e-4 as the JAX package's own test); the int8
    cache stays within 5e-2 of them and is not identical."""
    port = pipes[0]
    args = inputs(4)
    cached = port(*args, decode=False)
    got = video.VideoPipeline(port.bundle, tier_config(**TIERS[tier]), device="cpu")(
        *args, decode=False)
    np.testing.assert_allclose(got.numpy(), cached.numpy(), atol=atol, rtol=0)
    if "q8" in tier:
        assert (got - cached).abs().max() > 1e-6


def test_streamed_path_frees_and_groups(pipes, monkeypatch):
    """Which path a config takes: per-step banks call the guidance UNet once
    per (step, group), the cached tiers once (q8: once per chunk of unique
    banks), and the denoiser runs two CFG passes per (step, group)."""
    port = pipes[0]
    calls = {"guide": [], "den": []}
    guide_fwd, den_fwd = port.bundle.guide.forward, port.bundle.den.forward
    monkeypatch.setattr(port.bundle.guide, "forward", lambda *a, **k: (
        calls["guide"].append(a[0].shape[0]), guide_fwd(*a, **k))[1])
    monkeypatch.setattr(port.bundle.den, "forward", lambda *a, **k: (
        calls["den"].append((a[0].shape[0], "banks" in k)), den_fwd(*a, **k))[1])

    def run(**change):
        calls["guide"].clear(), calls["den"].clear()
        video.VideoPipeline(port.bundle, tier_config(**change), device="cpu")(
            *inputs(0), num_inference_steps=2, decode=False)
        return list(calls["guide"]), list(calls["den"])

    guide, den = run(**TIERS["per_step"])
    assert guide == [3] * 6 and den == [(1, False), (1, True)] * 6
    guide, den = run(**TIERS["cached_grouped"])
    assert guide == [9] and den == [(1, False), (1, True)] * 6
    guide, den = run(**TIERS["cached_q8_cond"])  # 5 unique banks, chunks of 4
    assert guide == [4, 1] and den == [(3, False), (3, True)] * 2
    guide, den = run(bank_mode="auto")  # everything fits: one doubled batch
    assert guide == [9] and den == [(6, False)] * 2


@pytest.mark.parametrize("mode", ["reference_inference", "cond"])
def test_unique_bank_index_mirrors_the_window_context(mode):
    """The q8 cache holds one bank per (frame, context variant); gathering the
    unique contexts by its index gives ``guidance_context_for_windows``."""
    windows = np.array([[0, 1, 2], [2, 3, 4], [4, 0, 1]])
    c = torch.from_numpy(np.random.default_rng(5).normal(size=(1, 2, 3)).astype(np.float32))
    frames, uncond, idx = video.unique_bank_index(windows, mode)
    assert len(frames) == (5 if mode == "cond" else len(set(zip(
        windows.reshape(-1), video.context_variants(windows, mode)))))
    np.testing.assert_array_equal(frames[idx], windows.reshape(-1))
    ctx_u = torch.where(torch.from_numpy(uncond)[:, None, None], torch.zeros_like(c), c)
    want = video.guidance_context_for_windows(windows, c, torch.zeros_like(c), mode)
    np.testing.assert_array_equal(ctx_u[torch.from_numpy(idx)].numpy(), want.numpy())


def test_quantize_banks_matches_jax():
    """Per-position scales, round half to even, clip to +-127; an all-zero
    position keeps the 1e-8 floor on its scale."""
    rng = np.random.default_rng(6)
    banks = {"a": rng.normal(0, 2, (4, 6, 8)).astype(np.float32),
             "b": rng.normal(0, 1, (4, 3, 5)).astype(np.float32)}
    banks["a"][1] = 0.0
    banks["b"][0] = np.round(banks["b"][0] * 4) / 4  # ties after scaling, when amax allows
    banks["b"][0, 0, 0] = 127 / 8  # scale 1/8: multiples of 1/16 land on .5
    banks["b"][0, 0, 1:] = [1 / 16, 3 / 16, -5 / 16, 7 / 16]
    jqv, jqs = jvideo.quantize_banks({k: jnp.asarray(v) for k, v in banks.items()})
    qv, qs = video.quantize_banks({k: torch.from_numpy(v) for k, v in banks.items()})
    for k in banks:
        assert qv[k].dtype == torch.int8 and qs[k].shape == (4, 1, 1)
        np.testing.assert_array_equal(qv[k].numpy(), np.asarray(jqv[k]))
        np.testing.assert_array_equal(qs[k].numpy(), np.asarray(jqs[k]))
    np.testing.assert_array_equal(qv["b"][0, 0, 1:].numpy(), [0, 2, -2, 4])  # half to even
    back = video.dequantize_banks(qv, qs, torch.float32)
    jback = jvideo.dequantize_banks(jqv, jqs, jnp.float32)
    for k in banks:
        np.testing.assert_array_equal(back[k].numpy(), np.asarray(jback[k]))
        assert np.abs(back[k].numpy() - banks[k]).max() <= float(qs[k].max()) / 2 + 1e-7


@pytest.mark.parametrize("args", [(4, 30, 64), (4, 30, 60), (3, 30, 64), (6, 30, 100),
                                  (2, 30, 16), (8, 3, 6, 2), (3, 3, 3, 2), (1, 16, 64)])
def test_choose_bank_group_matches_jax(args):
    assert video.choose_bank_group(*args) == jvideo.choose_bank_group(*args)


def test_unknown_bank_mode_raises(pipes):
    pipe = video.VideoPipeline(pipes[0].bundle, tier_config(bank_mode="int4"), device="cpu")
    with pytest.raises(ValueError, match="unknown bank_mode"):
        pipe(*inputs(0))
