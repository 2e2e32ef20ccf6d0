"""The port at SDXL's geometry on the CPU, with no JAX: the guidance UNet,
the denoiser and a 2-step ``VideoPipeline`` against the plain reference
(``scripts/_oracle_xl.py``) on seeded random weights, at a tiny SDXL-shaped
configuration (3 levels, no attention at level 0, transformer stacks 2 and
3 deep at levels 1 and 2 and 3 in the mid block, heads of 64, linear
projections, the "text_time" added conditioning, motion modules at every
level and none in the mid block, a VAE scale of 0.13025); SD1.5's defaults
building today's modules and bank keys; the byte budget of the banks; the
``spatial_stack_l<level>`` spans and the ``bank_bytes`` counter.

The limit 1e-3 (fp32 on both sides): the two compute the same function
through different orders of summation (the port's one-pass LayerNorm
variance, its GroupNorm, its fused K/V of the banks), which leaves
differences near 1e-5 here; a wrong wiring (a bank read by the wrong block,
the added embedding left out, a motion module at the wrong level) moves the
outputs by far more. Torch runs on 2 threads.
"""

import dataclasses
import hashlib

import numpy as np
import pytest
import torch

from mikudance_tpu_torch.core import loaders
from mikudance_tpu_torch.core.configs import (DENOISING_3D, GUIDANCE_MIX, SD15_UNET,
                                              SDXL_DENOISING, SDXL_GUIDANCE, SDXL_UNET,
                                              ContextConfig, MotionModuleConfig, PipelineConfig,
                                              UNetConfig)
from mikudance_tpu_torch.diffusion.ddim import inference_step_pairs
from mikudance_tpu_torch.models import unet
from mikudance_tpu_torch.pipelines.context import uniform_windows
from mikudance_tpu_torch.pipelines.video import ModelBundle, VideoPipeline, schedule_for
from mikudance_tpu_torch.scripts import _oracle as o
from mikudance_tpu_torch.scripts import _oracle_xl as ox
from mikudance_tpu_torch.utils import profiling as pf

CH, HEADS, DEPTHS = (32, 64, 128), (1, 1, 2), (1, 2, 3)
MID = DEPTHS[-1]  # the mid block stacks as many blocks as the last level
CTX, TIME_DIM, POOLED = 32, 8, 16
TINY_XL = UNetConfig(block_out_channels=CH, cross_attention_dim=CTX, level_heads=HEADS,
                     attention_levels=(1, 2), transformer_layers=DEPTHS,
                     use_linear_projection=True,
                     addition_embed_type="text_time", addition_time_embed_dim=TIME_DIM,
                     projection_class_embeddings_input_dim=POOLED + 6 * TIME_DIM)
TINY_MOTION = MotionModuleConfig(num_attention_heads=4, resolutions=(1, 2, 4), mid_block=False)
TINY_VAE = dataclasses.replace(o.TINY_VAE, scaling_factor=0.13025)
T, H, W, STEPS, SCALE, S_CTX = 5, 64, 64, 2, 3.5, 5
LIMIT = 1e-3


@pytest.fixture(autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def nets():
    """The twins (seeded) and the port's UNets and VAE loaded from them
    through ``core/loaders.py``, in fp32 on the CPU."""
    tg, td = ox.make_twins_xl(CH, HEADS, DEPTHS, (1, 2), CTX, (0, 1, 2), "cpu",
                              motion_heads=4, added=(TIME_DIM, POOLED))
    torch.manual_seed(4)
    tvae = o.TAutoencoderKL().eval()
    guide = loaders.load_guidance(tg.state_dict(), use_man=True, device="cpu",
                                  unet_config=TINY_XL)
    den = loaders.load_denoising(td.state_dict(), device="cpu", unet_config=TINY_XL,
                                 motion_config=TINY_MOTION)
    enc, dec = loaders.load_vae(tvae.state_dict(), device="cpu", config=TINY_VAE)
    return dict(tg=tg, td=td, tvae=tvae, guide=guide, den=den, enc=enc, dec=dec)


def rel(got, want) -> float:
    got = torch.as_tensor(got, dtype=torch.float64)
    want = torch.as_tensor(want, dtype=torch.float64)
    return float((got - want).norm() / want.norm())


def added_inputs(rng, n: int):
    time_ids = torch.from_numpy(np.tile(ox.sdxl_time_ids(H, W), (n, 1)))
    pooled = torch.from_numpy(rng.normal(size=(n, POOLED)).astype(np.float32))
    return time_ids, pooled


@torch.no_grad()
def test_guidance_unet_writes_the_references_banks(nets):
    """One bank a transformer block (28 at this geometry), each within the
    limit of the reference's; MAN and the added embedding on the path."""
    rng = np.random.default_rng(0)
    n = 3
    cond = rng.normal(size=(n, 20, 8, 8)).astype(np.float32)
    motion = rng.normal(size=(n, 2, 8, 8)).astype(np.float32)
    ctx = torch.from_numpy(rng.normal(size=(n, S_CTX, CTX)).astype(np.float32))
    added = added_inputs(rng, n)
    _, want = nets["tg"](torch.from_numpy(cond), torch.zeros(n), ctx,
                         motion_map=torch.from_numpy(motion), write=True, added=added)
    g = nets["guide"]
    got = g(torch.from_numpy(cond.transpose(0, 2, 3, 1).copy()),
            torch.from_numpy(motion.transpose(0, 2, 3, 1).copy()),
            torch.zeros(n, dtype=torch.int32), ctx, add_emb=g.added_embedding(*added))
    assert list(got) == unet.bank_keys(TINY_XL) and set(want) == set(got)
    assert len(got) == 2 * 2 + 2 * 3 + MID + 3 * 3 + 3 * 2
    for key, bank in got.items():
        assert rel(bank, want[key]) < LIMIT, key
    # the added embedding is on the path: without it the banks move
    off = g(torch.from_numpy(cond.transpose(0, 2, 3, 1).copy()),
            torch.from_numpy(motion.transpose(0, 2, 3, 1).copy()),
            torch.zeros(n, dtype=torch.int32), ctx,
            add_emb=torch.zeros_like(g.added_embedding(*added)))
    assert rel(off["up_0_0.0"], want["up_0_0.0"]) > 100 * LIMIT


@torch.no_grad()
def test_denoiser_reads_a_bank_a_block(nets):
    """The denoiser with raw banks (every block's own), the motion modules
    at all three levels and the added embedding, against the reference."""
    rng = np.random.default_rng(1)
    frames = 3
    x = rng.normal(size=(frames, 4, 8, 8)).astype(np.float32)
    ctx = torch.from_numpy(rng.normal(size=(1, S_CTX, CTX)).astype(np.float32))
    added = added_inputs(rng, 1)
    banks = {k: torch.from_numpy(rng.normal(size=(frames, s, c)).astype(np.float32))
             for k, (s, c) in bank_shapes(TINY_XL, 8, 8).items()}
    t = torch.full((1,), 501.0)
    want, _ = nets["td"](torch.from_numpy(x), t, ctx, banks=banks, T=frames, added=added)
    d = nets["den"]
    got = d(torch.from_numpy(x.transpose(0, 2, 3, 1).copy())[None], t.int(), ctx, banks=banks,
            add_emb=d.added_embedding(*added))[0]
    assert rel(got.permute(0, 3, 1, 2), want) < LIMIT
    # a bank read by another block's reader is another function
    swapped = dict(banks, **{"mid.0": banks["mid.1"], "mid.1": banks["mid.0"]})
    other = d(torch.from_numpy(x.transpose(0, 2, 3, 1).copy())[None], t.int(), ctx,
              banks=swapped, add_emb=d.added_embedding(*added))[0]
    assert rel(other.permute(0, 3, 1, 2), want) > 10 * LIMIT


def bank_shapes(cfg, h, w):
    out = {}
    for key in unet.transformer_keys(cfg):
        lv = unet.key_level(cfg, key)
        for bk in unet.block_keys(cfg, key):
            out[bk] = ((h >> lv) * (w >> lv), cfg.block_out_channels[lv])
    return out


@pytest.mark.parametrize("bank_mode", ["cached", "per_step"])
def test_video_pipeline_matches_the_reference(nets, bank_mode):
    """Two steps of ``VideoPipeline.__call__`` (two windows of 3 frames,
    overlap 1, CFG; the banks cached, or made again each step a window at a
    time) with the time ids and a pooled vector, against
    ``torch_oracle_xl``: latents within the limit, frames within one level
    of rounding."""
    pipe = VideoPipeline(ModelBundle(nets["guide"], nets["den"], nets["enc"], nets["dec"]),
                         PipelineConfig(width=W, height=H, num_inference_steps=STEPS,
                                        guidance_scale=SCALE,
                                        context=ContextConfig(frames=3, overlap=1),
                                        guidance_clip_mode="cond", bank_mode=bank_mode,
                                        cached_bank_positions=3), device="cpu")
    rng = np.random.default_rng(2)
    inputs = o.gate_inputs(T, H, W, S_CTX, 11)
    inputs = inputs[:6] + (rng.normal(size=(1, S_CTX, CTX)).astype(np.float32),) + inputs[7:]
    tid, pooled = ox.sdxl_time_ids(H, W), rng.normal(size=(1, POOLED)).astype(np.float32)
    lat = pipe(*inputs, decode=False, time_ids=tid, pooled=pooled).numpy()
    video = pipe(*inputs, to_host=True, time_ids=tid, pooled=pooled)
    sched = schedule_for(PipelineConfig())
    with torch.no_grad():
        want_lat, want_video = ox.torch_oracle_xl(
            nets["tvae"], nets["tg"], nets["td"], inputs, (tid[None], pooled),
            np.asarray(sched.alphas_cumprod, np.float64), inference_step_pairs(sched, STEPS),
            uniform_windows(0, T, 3, 1, 1), "cpu", 0.13025, SCALE)
    assert rel(lat, want_lat.transpose(0, 2, 3, 1)) < LIMIT
    assert np.abs(video.astype(int) - want_video).max() <= 1
    with pytest.raises(ValueError, match="added conditioning"):
        pipe(*inputs, decode=False)  # an SDXL UNet without its time ids and pooled vector


def _keys_digest(module) -> str:
    return hashlib.sha256(repr(sorted((k, tuple(v.shape)) for k, v in
                                      module.state_dict().items())).encode()).hexdigest()[:16]


def test_sd15_defaults_build_the_same_modules_and_bank_keys():
    """SD1.5's defaults: the state-dict keys and shapes of both UNets as
    before SDXL's fields existed (their digests pinned), 16 bank keys, one a
    transformer, and no added embedding."""
    with torch.device("meta"):
        g, d = unet.GuidanceUNet(GUIDANCE_MIX), unet.DenoisingUNet(DENOISING_3D)
    assert (_keys_digest(g), len(g.state_dict())) == ("15b354e3811b85c9", 706)
    assert (_keys_digest(d), len(d.state_dict())) == ("d87dba5c42400aff", 1232)
    assert unet.bank_keys(SD15_UNET) == [
        "down_0_0", "down_0_1", "down_1_0", "down_1_1", "down_2_0", "down_2_1", "mid",
        "up_1_0", "up_1_1", "up_1_2", "up_2_0", "up_2_1", "up_2_2", "up_3_0", "up_3_1", "up_3_2"]
    assert not hasattr(g, "add_embedding") and not hasattr(d, "add_embedding")


def test_sdxl_presets_at_the_published_widths():
    """``SDXL_UNET``: 70 bank keys (levels 1 and 2 only), the published
    parameter counts (the SDXL UNet's 2.567 G plus MAN, or plus the motion
    adapter's modules), SDXL's key grammar, the pooled width 1280."""
    keys = unet.bank_keys(SDXL_UNET)
    assert len(keys) == 70 and keys[:2] == ["down_1_0.0", "down_1_0.1"]
    assert {unet.key_level(SDXL_UNET, k.split(".")[0]) for k in keys} == {1, 2}
    assert SDXL_UNET.pooled_dim == 1280
    with torch.device("meta"):
        g, d = unet.GuidanceUNet(SDXL_GUIDANCE), unet.DenoisingUNet(SDXL_DENOISING)
    assert sum(p.numel() for p in g.parameters()) == 2_572_670_336
    assert sum(p.numel() for p in d.parameters()) == 2_804_242_884
    sd = d.state_dict()
    assert sd["down_blocks.2.attentions.0.proj_in.weight"].shape == (1280, 1280)
    assert "up_blocks.0.attentions.2.transformer_blocks.9.attn1.to_q.weight" in sd
    assert sd["add_embedding.linear_1.weight"].shape == (1280, 2816)
    assert "mid_block.motion_modules.0.temporal_transformer.norm.weight" not in sd
    assert "down_blocks.0.motion_modules.1.temporal_transformer.norm.weight" in sd
    assert not hasattr(d.down_blocks[0], "attentions")


@pytest.mark.parametrize("h,w", [(96, 96), (128, 128), (72, 72), (64, 64), (33, 35)])
def test_bank_budget_keeps_every_sd15_choice(h, w):
    """The bank budget in bytes: SD1.5 keeps ``cached_bank_positions`` at
    every size (so every cached / per-step / q8-chunk choice is as before),
    so do smaller UNets (the long-clip tests' tiny ones), and SDXL's
    positions, about 2.3x the bytes at one size, get that many fewer (84 of
    192)."""
    for n in (192, 96, 4, 3, 1):
        assert unet.bank_position_budget(n, SD15_UNET, h, w) == n
        assert unet.bank_position_budget(n, o.TINY, h, w) == n
    ratio = unet.bank_elements(SDXL_UNET, h, w) / unet.bank_elements(SD15_UNET, h, w)
    assert 2.2 < ratio < 2.5
    assert unet.bank_position_budget(192, SDXL_UNET, h, w) == \
        192 * unet.bank_elements(SD15_UNET, h, w) // unet.bank_elements(SDXL_UNET, h, w)
    if (h, w) == (128, 128):  # 1024^2: a position's raw banks in bf16, 0.195 GiB
        assert abs(2 * unet.bank_elements(SDXL_UNET, h, w) / 2**30 - 0.1953) < 1e-3
        assert unet.bank_position_budget(192, SDXL_UNET, h, w) == 84


def test_stack_spans_and_bank_bytes_under_a_profiler(nets, monkeypatch):
    """Under a profiler session each spatial transformer call is a
    ``spatial_stack_l<level>`` span (a denoiser call: 5 at level 1, 6 at
    level 2, none at level 0), and the ``bank_kv`` span counts the bytes of
    the raw banks and their K/V that the denoise loop holds."""
    from torch.profiler import ProfilerActivity, profile

    monkeypatch.setattr(pf, "RECORDER", pf.Recorder())
    pipe = VideoPipeline(ModelBundle(nets["guide"], nets["den"], nets["enc"], nets["dec"]),
                         PipelineConfig(width=W, height=H, num_inference_steps=STEPS,
                                        context=ContextConfig(frames=3, overlap=1)),
                         device="cpu")
    inputs = o.gate_inputs(3, H, W, S_CTX, 12)
    inputs = inputs[:6] + (np.zeros((1, S_CTX, CTX), np.float32),) + inputs[7:]
    with profile(activities=[ProfilerActivity.CPU]):
        pipe(*inputs, decode=False, time_ids=ox.sdxl_time_ids(H, W),
             pooled=np.ones((1, POOLED), np.float32))
    spans = pf.recorded()
    by_index = {s.index: s for s in spans}
    steps = [s for s in spans if s.name == "denoise_step"]
    assert len(steps) == STEPS
    for step in steps:
        inside = [s.name for s in spans if s.parent is not None
                  and _ancestor(by_index, s, step.index)]
        assert inside.count("spatial_stack_l1") == 5 and inside.count("spatial_stack_l2") == 6
        assert "spatial_stack_l0" not in inside
    (kv,) = [s for s in spans if s.name == "bank_kv"]
    per_position = unet.bank_elements(TINY_XL, 8, 8) * 4  # fp32
    # 3 positions of raw banks, their K and V over both CFG halves (6 rows)
    assert kv.counters["bank_bytes"] == per_position * (3 + 2 * 6)


def _ancestor(by_index, span, index) -> bool:
    while span.parent is not None:
        if span.parent == index:
            return True
        span = by_index[span.parent]
    return False


@pytest.mark.slow
def test_sdxl_width_stack_matches_the_reference():
    """One SDXL-width level-2 spatial transformer (1280 channels, 20 heads
    of 64, 10 blocks, linear projections) at an 8 x 8 map, port against the
    reference twin, fp32."""
    from mikudance_tpu_torch.models.layers import SpatialTransformer

    torch.manual_seed(0)
    twin = ox.TTransformer2DXL(1280, 20, 2048, depth=10, linear=True).eval()
    port = SpatialTransformer(1280, 20, 2048, 32, depth=10, linear=True).eval()
    port.load_state_dict(twin.state_dict())
    x, ctx = torch.randn(2, 1280, 8, 8), torch.randn(2, 7, 2048)
    with torch.no_grad():
        want, _ = twin(x, ctx, [None] * 10, write=False)
        got, _ = port.stack(x.permute(0, 2, 3, 1).contiguous(), ctx)
    assert rel(got.permute(0, 3, 1, 2), want) < LIMIT
