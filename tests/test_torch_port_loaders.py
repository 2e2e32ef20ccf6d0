"""The port's checkpoint loaders, media helpers and inference CLI, on the CPU.

Tiny modules' state dicts are saved as ``.pth`` / ``.bin`` / ``.safetensors``
into ``tmp_path`` the way the released files lie on disk; the loaders bring
them back strictly (same tensors, same output), merge the denoiser's three
files in the reference's order, and fall back to a seeded random init where a
path is absent. The CLI's ``main([...])`` runs on synthetic PNG / npy / mp4
inputs at 64 x 64 with tiny networks and writes a video. The media helpers
are held to the JAX package's.
"""

import numpy as np
import pytest
import torch

from mikudance_tpu.utils import media as jmedia
from mikudance_tpu_torch.core import loaders
from mikudance_tpu_torch.core.configs import (CLIPVisionConfig, MotionModuleConfig, UNetConfig,
                                              VAEConfig)
from mikudance_tpu_torch.core.convert import merge_state_dicts
from mikudance_tpu_torch.scripts import inference_video
from mikudance_tpu_torch.utils import media

TINY = UNetConfig(block_out_channels=(32, 64, 96, 96), attention_heads=4)
TINY_VAE = VAEConfig(block_out_channels=(8, 8, 8, 8), norm_num_groups=4)
TINY_CLIP = CLIPVisionConfig(image_size=28, hidden_size=32, intermediate_size=64, num_layers=1,
                             num_heads=2)
CPU = dict(device="cpu")


def save(sd, path):
    path.parent.mkdir(parents=True, exist_ok=True)
    if path.suffix == ".safetensors":
        from safetensors.torch import save_file

        save_file({k: v.contiguous() for k, v in sd.items()}, str(path))
    else:
        torch.save(sd, str(path))
    return str(path)


def same(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    return set(sa) == set(sb) and all(torch.equal(sa[k], sb[k]) for k in sa)


def other(seed):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("ext", [".pth", ".safetensors"])
def test_guidance_loads_back_strictly(ext, tmp_path):
    src = loaders.load_guidance(None, unet_config=TINY, generator=other(7), **CPU)
    sd = dict(src.state_dict())
    sd["conv_out.weight"] = torch.zeros(4, 32, 3, 3)  # the released file's dead output head
    path = save({"state_dict": sd} if ext == ".pth" else sd, tmp_path / f"reference_unet{ext}")
    got = loaders.load_guidance(path, unet_config=TINY, **CPU)
    assert same(got, src) and not same(got, loaders.load_guidance(None, unet_config=TINY, **CPU))
    x, m, c = torch.randn(1, 8, 8, 20), torch.randn(1, 8, 8, 2), torch.randn(1, 5, 768)
    t0 = torch.zeros(1, dtype=torch.int32)
    with torch.no_grad():
        a, b = src(x, m, t0, c), got(x, m, t0, c)
    assert all(torch.equal(a[k], b[k]) for k in a)
    del sd["man_blocks.0.mlp_shared.0.weight"]  # a key the module needs
    with pytest.raises(RuntimeError, match="man_blocks.0.mlp_shared.0.weight"):
        loaders.load_guidance(save(sd, tmp_path / f"cut{ext}"), unet_config=TINY, **CPU)
    # a stage-1 file (no MAN) loads into the stage-1 module
    assert same(loaders.load_guidance(path, use_man=False, unet_config=TINY, **CPU),
                loaders.load_guidance(path, use_man=False, unet_config=TINY, **CPU))


def test_denoising_merges_sd_then_motion_then_denoising(tmp_path):
    """Later files override earlier ones; every key of the module comes from
    the last file that has it."""
    mcfg = MotionModuleConfig(num_attention_heads=4)
    kw = dict(unet_config=TINY, motion_config=mcfg, **CPU)
    full = loaders.load_denoising(None, generator=other(1), **kw).state_dict()
    motion_keys = {k for k in full if "motion_modules" in k}
    sd_file = {k: torch.full_like(v, 1.0) for k, v in full.items() if k not in motion_keys}
    mm_file = {k: torch.full_like(v, 2.0) for k, v in full.items() if k in motion_keys}
    den_keys = sorted(full)[::3]  # the denoising file overrides a third of everything
    den_file = {k: torch.full_like(full[k], 3.0) for k in den_keys}
    paths = [save(sd_file, tmp_path / "unet" / "diffusion_pytorch_model.safetensors"),
             save(mm_file, tmp_path / "motion_module.pth"),
             save(den_file, tmp_path / "denoising_unet.pth")]
    assert loaders._find_weights(str(tmp_path / "unet")) == paths[0]
    got = loaders.load_denoising(paths[2], paths[1], paths[0], **kw).state_dict()
    for k, v in got.items():
        want = 3.0 if k in den_file else 2.0 if k in motion_keys else 1.0
        assert bool((v == want).all()), k
    assert merge_state_dicts({"a": 1, "b": 1}, {"b": 2, "c": 2}) == {"a": 1, "b": 2, "c": 2}
    # without the denoising file nothing is read: random init, as the reference CLI's
    # smoke mode; without the SD file the merge misses keys and the strict load says so
    assert same(loaders.load_denoising(None, paths[1], paths[0], **kw),
                loaders.load_denoising(None, **kw))
    with pytest.raises(RuntimeError, match="Missing key"):
        loaders.load_denoising(paths[2], paths[1], None, **kw)
    # a stage-1 denoiser takes the same files and skips the motion keys
    flat = loaders.load_denoising(paths[2], paths[1], paths[0], use_motion=False, unet_config=TINY,
                                  motion_config=MotionModuleConfig(enabled=False), **CPU)
    assert not any("motion_modules" in k for k in flat.state_dict())


@pytest.mark.parametrize("name", ["diffusion_pytorch_model.safetensors",
                                  "diffusion_pytorch_model.bin"])
def test_vae_clip_and_temporal_decoder_load_from_directories(name, tmp_path):
    enc, dec = loaders.load_vae(None, config=TINY_VAE, generator=other(3), **CPU)
    save({**enc.state_dict(), **dec.state_dict()}, tmp_path / "vae" / name)
    enc2, dec2 = loaders.load_vae(str(tmp_path / "vae"), config=TINY_VAE, **CPU)
    assert same(enc, enc2) and same(dec, dec2)
    x = torch.randn(1, 16, 16, 3)
    with torch.no_grad():
        assert torch.equal(dec2(enc2(x)[..., :4]), dec(enc(x)[..., :4]))

    tower = loaders.load_clip(None, config=TINY_CLIP, generator=other(4), **CPU)
    save(tower.state_dict(), tmp_path / "clip" / name.replace("diffusion_pytorch_model", "model"))
    assert same(loaders.load_clip(str(tmp_path / "clip"), config=TINY_CLIP, **CPU), tower)

    tdec = loaders.load_temporal_decoder(None, config=TINY_VAE, generator=other(5), **CPU)
    save(tdec.state_dict(), tmp_path / "tvae" / name)
    assert same(loaders.load_temporal_decoder(str(tmp_path / "tvae"), config=TINY_VAE, **CPU), tdec)
    # an empty directory or a missing one: random init
    (tmp_path / "empty").mkdir()
    assert same(loaders.load_clip(str(tmp_path / "empty"), config=TINY_CLIP, **CPU),
                loaders.load_clip("/nonexistent", config=TINY_CLIP, **CPU))


def test_random_init_is_seeded_cast_and_leaves_the_global_generator():
    torch.manual_seed(123)
    before = torch.random.get_rng_state()
    a = loaders.load_guidance(None, unet_config=TINY, dtype=torch.bfloat16, **CPU)
    assert torch.equal(torch.random.get_rng_state(), before)
    assert all(p.dtype == torch.bfloat16 for p in a.parameters()) and not a.training
    assert same(a, loaders.load_guidance(None, unet_config=TINY, dtype=torch.bfloat16, **CPU))
    b = loaders.load_guidance(None, unet_config=TINY, dtype=torch.bfloat16, generator=other(9),
                              **CPU)
    assert not same(a, b)
    if not torch.cuda.is_available():  # no device named, no card: raises, as every entry point
        with pytest.raises(RuntimeError, match='device="cpu"'):
            loaders.load_clip(None, config=TINY_CLIP)


def test_pickled_files_are_read_weights_only(tmp_path):
    path = tmp_path / "evil.pth"
    torch.save({"state_dict": {"w": torch.ones(2)}, "hook": print}, str(path))
    with pytest.raises(Exception, match="(?i)weights_only|unsupported|unpickl"):
        loaders.load_torch_state_dict(str(path))


# -------------------------------------------------------------------- media

def test_media_helpers_match_the_jax_package(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(media.torch_seed_noise(100, (1, 4, 3, 8, 8)),
                                  jmedia.torch_seed_noise(100, (1, 4, 3, 8, 8)))
    np.testing.assert_array_equal(media.torch_seed_noise(5, (2, 3), dtype_half=False),
                                  jmedia.torch_seed_noise(5, (2, 3), dtype_half=False))
    depth = rng.uniform(0, 1, (1, 64, 48)).astype(np.float32)
    np.testing.assert_array_equal(media.resize_depth(depth, 8, 6), jmedia.resize_depth(depth, 8, 6))
    img = Image.fromarray(rng.integers(0, 256, (50, 70, 3), dtype=np.uint8))
    np.testing.assert_array_equal(media.to_u8_frame(img, 32, 40), jmedia.to_u8_frame(img, 32, 40))
    np.testing.assert_array_equal(media.frames_to_u8([img, img], 16, 24),
                                  jmedia.frames_to_u8([img, img], 16, 24))
    np.testing.assert_allclose(media.to_clip_input(img), jmedia.to_clip_input(img), atol=1e-6)
    frames = rng.integers(0, 256, (4, 32, 48, 3), dtype=np.uint8)
    media.write_video(frames, str(tmp_path / "a" / "clip.mp4"), fps=12)
    back = media.read_frames(str(tmp_path / "a" / "clip.mp4"))
    assert len(back) == 4 and back[0].size == (48, 32)
    assert media.get_fps(str(tmp_path / "a" / "clip.mp4")) == pytest.approx(12)
    media.save_video_grid([frames / 255.0, frames / 255.0], str(tmp_path / "grid.gif"), fps=5)
    assert (tmp_path / "grid.gif").stat().st_size > 0


# ---------------------------------------------------------------------- CLI

@pytest.fixture
def tiny_loaders(monkeypatch):
    """The CLI's loaders at tiny widths (full SD1.5 widths do not fit a CPU
    test); each records the arguments the CLI gave it."""
    seen = {}

    def tiny(name, real, **fixed):
        def load(*paths, **kw):
            seen[name] = (paths, kw)
            return real(*paths, **{**kw, **fixed})
        monkeypatch.setattr(loaders, name, load)

    tiny("load_guidance", loaders.load_guidance, unet_config=TINY)
    tiny("load_denoising", loaders.load_denoising, unet_config=TINY,
         motion_config=MotionModuleConfig(num_attention_heads=4))
    tiny("load_vae", loaders.load_vae, config=TINY_VAE)
    tiny("load_clip", loaders.load_clip, config=TINY_CLIP)
    tiny("load_temporal_decoder", loaders.load_temporal_decoder, config=TINY_VAE)
    return seen


def write_request(tmp_path, frames, **extra):
    """Synthetic PNG / mp4 / npy inputs and the YAML that names them."""
    import yaml
    from PIL import Image

    rng = np.random.default_rng(1)
    for name in ("char.png", "skel.png"):
        Image.fromarray(rng.integers(0, 256, (80, 72, 3), dtype=np.uint8)).save(tmp_path / name)
    media.write_video(rng.integers(0, 256, (frames, 64, 64, 3), dtype=np.uint8),
                      str(tmp_path / "pose.mp4"), fps=10)
    eye = np.tile(np.eye(4, dtype=np.float32), (frames, 1, 1))
    c2w = eye.copy()
    c2w[:, 0, 3] = np.linspace(0, 1, frames)
    np.save(tmp_path / "w2c.npy", np.linalg.inv(c2w))
    np.save(tmp_path / "c2w.npy", c2w)
    np.save(tmp_path / "depth.npy", rng.uniform(0.2, 1, (1, 64, 64)).astype(np.float32))
    cfg = {"ref_image_path": str(tmp_path / "char.png"), "ref_skel_path": str(tmp_path / "skel.png"),
           "tgt_pose_path": str(tmp_path / "pose.mp4"), "tgt_face_path": None,
           "tgt_hand_path": "None", "tgt_w2c_path": str(tmp_path / "w2c.npy"),
           "tgt_c2w_path": str(tmp_path / "c2w.npy"), "ref_depth_path": str(tmp_path / "depth.npy"),
           "weight_dtype": "fp32", "reference_unet_path": "./no/such/file.pth", **extra}
    (tmp_path / "request.yaml").write_text(yaml.safe_dump(cfg))
    return str(tmp_path / "request.yaml")


@pytest.mark.parametrize("video_decoder", [False, True], ids=["sd-decoder", "temporal-decoder"])
def test_cli_main_writes_a_video(video_decoder, tiny_loaders, tmp_path, capsys):
    config = write_request(tmp_path, 6)
    out = str(tmp_path / "out" / "result.mp4")
    argv = ["--config", config, "-W", "64", "-H", "64", "--steps", "2", "--seed", "7", "-L", "5",
            "--device", "cpu", "--output", out] + (["--video_decoder"] if video_decoder else [])
    assert inference_video.main(argv) == out
    grid = media.read_frames(out)
    assert len(grid) == 5 and grid[0].size == (64, 3 * 64)  # reference, poses, result
    assert np.asarray(grid[0])[128:].std() > 0
    said = capsys.readouterr().out
    assert "Total frames: 5" in said and "smoke mode" in said and f"saved: {out}" in said
    assert ("load_temporal_decoder" in tiny_loaders) == video_decoder
    paths, kw = tiny_loaders["load_denoising"]
    assert kw["dtype"] == torch.float32 and kw["device"] == torch.device("cpu")


def test_cli_reads_the_inference_config_and_refuses_unbuilt_variants(tmp_path):
    import yaml

    path = tmp_path / "mikudance_config.yaml"
    path.write_text(yaml.safe_dump({
        "unet_additional_kwargs": {"motion_module_kwargs": {
            "num_attention_heads": 4, "temporal_position_encoding_max_len": 24,
            "attention_block_types": ["Temporal_Self"]}},
        "noise_scheduler_kwargs": {"beta_end": 0.02, "timestep_spacing": "leading"}}))
    motion_cfg, sched_cfg = inference_video.read_inference_config(str(path))
    assert (motion_cfg.num_attention_heads, motion_cfg.temporal_position_encoding_max_len,
            motion_cfg.attention_layers_per_block) == (4, 24, 1)
    assert sched_cfg.beta_end == 0.02 and sched_cfg.timestep_spacing == "leading"
    # the repository's own file gives the defaults
    from mikudance_tpu_torch.core.configs import SchedulerConfig
    repo = inference_video.read_inference_config("configs/inference/mikudance_config.yaml")
    assert repo == (MotionModuleConfig(), SchedulerConfig())
    for bad in ({"unet_additional_kwargs": {"unet_use_temporal_attention": True}},
                {"unet_additional_kwargs": {"motion_module_type": "Other"}},
                {"unet_additional_kwargs": {"use_inflated_groupnorm": False}}):
        path.write_text(yaml.safe_dump(bad))
        with pytest.raises(NotImplementedError):
            inference_video.read_inference_config(str(path))
    path.write_text(yaml.safe_dump({"sampler": "Euler"}))
    with pytest.raises(ValueError, match="DDIM"):
        inference_video.read_inference_config(str(path))


def test_cli_runs_on_the_card_unless_asked(tiny_loaders, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device exists")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        inference_video.main(["--config", write_request(tmp_path, 2), "-W", "64", "-H", "64"])
    assert not tiny_loaders  # refused before anything was loaded
