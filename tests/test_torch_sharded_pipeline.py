"""The port's sampler on a mesh of gloo ranks, against JAX and itself.

Four ranks (``core.mesh.spawn``, CPU, gloo, one thread each) run the tiny
``VideoPipeline`` of ``_torch_sharded_ranks.py`` on the same inputs with
``mesh=make_mesh()``. The geometry is ``tests/test_sharded_pipeline.py``'s
(6, 128, 4) case: three 4-frame windows, a CFG batch of 6, so the mesh is
(win 2, frame 2) and every motion module reshards by ``all_to_all``.

- Latents against the JAX ``VideoPipeline(devices=jax.devices()[:4])`` at
  1e-3, against the port's one-rank run at 2e-4; decoded frames within one
  uint8 step of both; every rank returns the whole result.
- A mesh of one is no mesh: the same bits.
- The long-clip tier ``per_step`` on a mesh (64^2): three windows do not
  split over four ranks, so a zero-weight pad window is added and the fusion
  sums are added over the ranks; held to the port's one-rank run at 2e-4.
- Cached banks stay sharded: a clip between ``cached_bank_positions`` and
  the rank count times it caches its banks on the mesh (one rank streams
  them); each rank's guidance UNet runs a quarter of the positions and keeps
  only the banks its block or its windows need, and a rank's UNet batch past
  ``max_denoise_frame_batch`` takes window groups split over the ranks.
- ``slow``: the (4, 64, 8) case, whose deepest level (one position) takes
  the motion module's gather path, and ``cached_q8`` on a mesh, each against
  the port's one-rank run.

One JAX pipeline configuration (the (6, 128, 4) one) is compiled here.
"""

import jax
import numpy as np
import pytest
import torch

import _torch_sharded_ranks as ranks
from mikudance_tpu.core import convert as jconvert
from mikudance_tpu.core import configs as jconfigs
from mikudance_tpu.models import unet as junet
from mikudance_tpu.models import vae as jvae
from mikudance_tpu.pipelines import video as jvideo
from mikudance_tpu_torch.core import mesh
from mikudance_tpu_torch.core.configs import ContextConfig, PipelineConfig
from mikudance_tpu_torch.models import unet, vae
from mikudance_tpu_torch.pipelines import video

RANKS = 4


def seeded(module, seed):
    """PyTorch's init under a seed, zero tensors refilled, every weight
    matrix or kernel halved (as tests/test_torch_port_pipeline.py: a random
    network at full scale amplifies fp32 rounding over the CFG steps)."""
    torch.manual_seed(seed)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for p in module.parameters():
            if not p.any():
                p.copy_(torch.from_numpy(rng.normal(0, 0.05, p.shape).astype(np.float32)))
            if p.ndim > 1:
                p.mul_(0.5)
    return module.eval()


def config(size: int, frames: int, **change) -> PipelineConfig:
    return PipelineConfig(width=size, height=size, num_inference_steps=2, guidance_scale=3.5,
                          context=ContextConfig(frames=frames, overlap=2),
                          guidance_clip_mode="cond", **change)


def inputs(seed: int, T: int, H: int):
    h = H // 8
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (H, H, 3), dtype=np.uint8),
            rng.integers(0, 256, (H, H, 3), dtype=np.uint8),
            rng.integers(0, 256, (T, H, H, 3), dtype=np.uint8),
            rng.integers(0, 256, (T, H, H, 3), dtype=np.uint8),
            np.zeros((T, H, H, 3), np.uint8),
            rng.normal(0, 0.1, (T, h, h, 2)).astype(np.float32),
            rng.normal(0, 1, (1, 5, 768)).astype(np.float32),
            rng.normal(0, 1, (T, h, h, 4)).astype(np.float32))


@pytest.fixture(scope="module")
def states():
    return {"guide": ranks.numpy_state(seeded(unet.GuidanceUNet(ranks.TINY_GUIDE), 0)),
            "den": ranks.numpy_state(seeded(unet.DenoisingUNet(ranks.TINY_DEN), 1)),
            "enc": ranks.numpy_state(seeded(vae.Encoder(ranks.TINY_VAE), 2)),
            "dec": ranks.numpy_state(seeded(vae.Decoder(ranks.TINY_VAE), 3))}


def one_rank(states, cfg, args, **kw):
    pipe = video.VideoPipeline(ranks.tiny_bundle(states), cfg, device="cpu")
    out = pipe(*args, **kw)
    return out.numpy() if isinstance(out, torch.Tensor) else out


def on_ranks(states, cfg, args, calls):
    return mesh.spawn(RANKS, ranks.pipeline_shards, (states, cfg, args, calls))


def within_one_step(got, want):
    assert got.shape == want.shape
    assert np.abs(got.astype(np.int16) - want.astype(np.int16)).max() <= 1


# ------------------------------------------------------------ (6, 128, 4)

T, H, CTX = 6, 128, 4


@pytest.fixture(scope="module")
def headline(states):
    cfg, args = config(H, CTX), inputs(1, T, H)
    got = on_ranks(states, cfg, args, [dict(decode=False), dict(to_host=True)])
    return cfg, args, got


@pytest.fixture(scope="module")
def jax_sharded(states):
    """The JAX pipeline on 4 of the 8 CPU devices, the same weights."""
    t = {k: {n: torch.from_numpy(v) for n, v in s.items()} for k, s in states.items()}
    jcfg = jconfigs.PipelineConfig(width=H, height=H, num_inference_steps=2, guidance_scale=3.5,
                                   context=jconfigs.ContextConfig(frames=CTX, overlap=2),
                                   guidance_clip_mode="cond")
    guide_cfg = jconfigs.GuidanceUNetConfig(unet=jconfigs.UNetConfig(
        block_out_channels=(32, 64, 96, 96), attention_heads=4), use_man=True)
    den_cfg = jconfigs.DenoisingUNetConfig(unet=guide_cfg.unet,
                                           motion=jconfigs.MotionModuleConfig(num_attention_heads=4))
    vae_cfg = jconfigs.VAEConfig(block_out_channels=(16, 32, 32, 32), norm_num_groups=8)
    bundle = jvideo.ModelBundle(
        junet.GuidanceUNet(guide_cfg),
        {"params": jconvert.convert_unet(t["guide"], with_man=True, with_conv_out=False)},
        junet.DenoisingUNet(den_cfg),
        {"params": jconvert.convert_unet(t["den"], with_motion=True)},
        jvae.Encoder(vae_cfg), {"params": jconvert.convert_vae_encoder(t["enc"])},
        jvae.Decoder(vae_cfg), {"params": jconvert.convert_vae_decoder(t["dec"])})
    pipe = jvideo.VideoPipeline(bundle, jcfg, devices=jax.devices()[:4])
    args = inputs(1, T, H)
    return np.asarray(pipe(*args, decode=False)), np.asarray(pipe(*args))


def test_sharded_pipeline_matches_jax_sharded(headline, jax_sharded):
    _, _, got = headline
    want_lat, want_vid = jax_sharded
    for (lat, vid), _, _ in got:
        assert lat.shape == want_lat.shape == (T, H // 8, H // 8, 4)
        np.testing.assert_allclose(lat, want_lat, atol=1e-3, rtol=0)
        within_one_step(vid, want_vid)


def test_sharded_pipeline_matches_one_rank(states, headline):
    cfg, args, got = headline
    want_lat = one_rank(states, cfg, args, decode=False)
    want_vid = one_rank(states, cfg, args, to_host=True)
    for (lat, vid), shapes, calls in got:
        np.testing.assert_allclose(lat, want_lat, atol=2e-4, rtol=0)
        assert isinstance(vid, np.ndarray) and vid.dtype == np.uint8
        within_one_step(vid, want_vid)
        # the CFG x window batch on (win 2, frame 2): the motion modules reshard
        assert shapes == {(2 * 3, CTX): {"win": 2, "frame": 2}}
        assert calls["all_to_all"] > 0 and calls["all_gather"] > 0


def test_mesh_of_one_is_no_mesh(states):
    cfg, args = config(64, 4), inputs(2, 5, 64)
    pipe = video.VideoPipeline(ranks.tiny_bundle(states), cfg, device="cpu",
                               mesh=mesh.make_mesh())
    assert pipe.mesh.size == 1 and pipe.mesh_for(6, 4) is None
    np.testing.assert_array_equal(pipe(*args, decode=False).numpy(),
                                  one_rank(states, cfg, args, decode=False))


def test_per_step_stream_mesh_with_pad_windows(states):
    """Three windows over four ranks: no group size splits, so one pad
    window of weight 0 makes four groups of one."""
    cfg, args = config(64, 4, bank_mode="per_step", cached_bank_positions=8), inputs(3, 6, 64)
    assert video.choose_bank_group(3, 4, 8, RANKS) is None
    want = one_rank(states, cfg, args, decode=False)
    for (lat,), shapes, calls in on_ranks(states, cfg, args, [dict(decode=False)]):
        np.testing.assert_allclose(lat, want, atol=2e-4, rtol=0)
        assert calls["psum"] == 2 * 2  # the two fusion sums at each of 2 steps


def test_cached_banks_stay_sharded_on_a_mesh(states):
    """Budgets under the clip, over a quarter of it. (6, 64, 4): 12 positions
    over a budget of 4, one UNet batch on (win 2, frame 2), each rank's
    guidance UNet running 3 positions; the cond ranks hold the 6 banks of
    their block, the uncond ranks none. (10, 64, 4): 5 windows, 20 positions
    over a budget of 8; a rank's share of one UNet batch (5 positions) passes
    max_denoise_frame_batch 4, so the windows, padded to 8, go two a rank in
    groups of one, and each rank holds the 8 banks of its two windows."""
    spmd = config(64, 4, cached_bank_positions=4), inputs(6, 6, 64)
    grouped = config(64, 4, cached_bank_positions=8, max_denoise_frame_batch=4), inputs(7, 10, 64)
    got = mesh.spawn(RANKS, ranks.bank_residency, (states, [spmd, grouped]))
    for k, (cfg, args) in enumerate((spmd, grouped)):
        want = one_rank(states, cfg, args, decode=False)  # one rank: banks per step
        for r, runs in enumerate(got):
            lat, guided, held = runs[k]
            np.testing.assert_allclose(lat, want, atol=2e-4, rtol=0)
            if k == 0:
                assert guided == [3]
                assert held == [("_denoise", 6 if r in (2, 3) else 0)]
            else:
                assert guided == [8]
                assert held == [("_denoise_streamed", 8)]


@pytest.mark.slow
def test_gather_path_pipeline_matches_one_rank(states):
    """(4, 64, 8): one window, (win 2, frame 2); the 1 x 1 deepest level does
    not split two ways, so its motion modules gather the frames."""
    cfg, args = config(64, 8), inputs(4, 4, 64)
    want = one_rank(states, cfg, args, decode=False)
    for (lat,), shapes, calls in on_ranks(states, cfg, args, [dict(decode=False)]):
        np.testing.assert_allclose(lat, want, atol=2e-4, rtol=0)
        assert shapes == {(2, 4): {"win": 2, "frame": 2}}


@pytest.mark.slow
def test_cached_q8_on_a_mesh_matches_one_rank(states):
    """int8 banks quantized a share a rank and gathered whole on every rank;
    window groups split over the ranks, with a pad window."""
    cfg = config(64, 4, bank_mode="cached_q8", max_denoise_frame_batch=8)
    args = inputs(5, 6, 64)
    want = one_rank(states, cfg, args, decode=False)
    for (lat,), _, calls in on_ranks(states, cfg, args, [dict(decode=False)]):
        np.testing.assert_allclose(lat, want, atol=2e-4, rtol=0)
        assert calls["psum"] == 2 * 2
