"""The port's tool drivers against the JAX package's ``tools/``, on the CPU.

Each driver runs as ``main([...])`` (``--device cpu`` where it runs a
network) on synthetic files in ``tmp_path``, and the JAX driver on the same
files. Scene motion and the camera post-processing agree to 1e-6; the
synthetic-keypoint skeleton videos and pictures are the same pixels; the
depth tool, on a tiny DPT saved as a ``.bin`` state_dict, agrees to 1e-3
(the normalized depth). The detector behind the XPose drivers, on a tiny
UniPose and CLIP-text built from files, agrees with the JAX driver's to
1e-3. ``get_camera_from_video`` exits as the JAX driver does without
``droid``.
"""

import argparse
import functools
import sys
import types

import numpy as np
import pytest
import torch

from mikudance_tpu.core import convert as jconvert
from mikudance_tpu.toolbox import clip_text as jclip
from mikudance_tpu.toolbox import dpt as jdpt
from mikudance_tpu.toolbox import xpose_config as jxcfg
from mikudance_tpu_torch.toolbox import clip_text, dpt, unipose, xpose_config
from mikudance_tpu_torch.tools import (depth_from_image, get_camera_from_video,
                                       inference_xpose_on_image, inference_xpose_on_video,
                                       scene_motion_tracking)
from mikudance_tpu_torch.utils import media
from tools import depth_from_image as jdepth_tool
from tools import get_camera_from_video as jcamera_tool
from tools import inference_xpose_on_image as jimage_tool
from tools import inference_xpose_on_video as jvideo_tool
from tools import scene_motion_tracking as jscene_tool

torch.set_num_threads(2)


def run_jax_main(monkeypatch, module, argv):
    monkeypatch.setattr(sys, "argv", [module.__name__] + list(argv))
    return module.main()


def write_clip(path, frames=3, height=48, width=64, seed=0):
    rng = np.random.default_rng(seed)
    media.write_video(rng.integers(0, 256, (frames, height, width, 3), dtype=np.uint8),
                      str(path), fps=8.0)
    return str(path)


def write_picture(path, height=50, width=70, seed=1):
    from PIL import Image

    rng = np.random.default_rng(seed)
    Image.fromarray(rng.integers(0, 256, (height, width, 3), dtype=np.uint8)).save(path)
    return str(path)


# ------------------------------------------------------------ scene motion


def _cameras(T, seed):
    rng = np.random.default_rng(seed)
    w2c = np.tile(np.eye(4), (T, 1, 1))
    for t in range(T):
        a = 0.02 * rng.normal(size=3)
        K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
        w2c[t, :3, :3] = np.eye(3) + K + K @ K / 2
        w2c[t, :3, 3] = 0.5 * rng.normal(size=3)
    return w2c, np.linalg.inv(w2c)


@pytest.mark.parametrize("with_depth", [True, False])
def test_scene_motion_tracking(tmp_path, monkeypatch, with_depth):
    w2c, c2w = _cameras(5, 0)
    np.save(tmp_path / "w2c.npy", w2c)
    np.save(tmp_path / "c2w.npy", c2w)
    args = ["--w2c", str(tmp_path / "w2c.npy"), "--c2w", str(tmp_path / "c2w.npy"),
            "-W", "96", "-H", "80"]
    if with_depth:
        depth = np.random.default_rng(1).uniform(0, 1, (1, 40, 48)).astype(np.float32)
        np.save(tmp_path / "depth.npy", depth)
        args += ["--depth", str(tmp_path / "depth.npy")]
    out = scene_motion_tracking.main(args + ["-o", str(tmp_path / "port.npy")])
    run_jax_main(monkeypatch, jscene_tool, args + ["-o", str(tmp_path / "jax.npy")])
    got, want = np.load(out), np.load(tmp_path / "jax.npy")
    assert got.shape == (5, 10, 12, 2) and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    assert np.abs(got[1:]).max() > 0


# ------------------------------------------------------------ camera


def test_get_camera_without_droid(tmp_path, monkeypatch):
    clip = write_clip(tmp_path / "dance.mp4")
    monkeypatch.setitem(sys.modules, "droid", None)  # absent, as on both machines
    with pytest.raises(SystemExit) as got:
        get_camera_from_video.main(["-i", clip, "-o", str(tmp_path / "port")])
    with pytest.raises(SystemExit) as want:
        run_jax_main(monkeypatch, jcamera_tool, ["-i", clip, "-o", str(tmp_path / "jax")])
    assert str(got.value) == str(want.value) and "DROID-SLAM is not installed" in str(got.value)


def test_get_camera_post_processing(tmp_path, monkeypatch):
    """The tracker's keyframes (here synthetic) through each driver's export."""
    clip = write_clip(tmp_path / "dance.mp4", frames=6)
    rng = np.random.default_rng(2)
    q = rng.normal(size=(3, 4))
    keyframes = (np.array([0.0, 2.0, 5.0]),
                 np.concatenate([rng.normal(size=(3, 3)),
                                 q / np.linalg.norm(q, axis=1, keepdims=True)], axis=1))
    seen = []

    def fake_droid(frames, calib):
        seen.append((len(frames), list(calib)))
        return keyframes

    monkeypatch.setattr(get_camera_from_video, "run_droid", fake_droid)
    monkeypatch.setattr(jcamera_tool, "run_droid", fake_droid)
    got = get_camera_from_video.main(["-i", clip, "-o", str(tmp_path / "port")])
    run_jax_main(monkeypatch, jcamera_tool, ["-i", clip, "-o", str(tmp_path / "jax")])
    assert seen == [(6, jcamera_tool.CALIB)] * 2
    for path, name in zip(got, ("w2c", "c2w")):
        want = np.load(tmp_path / "jax" / "dance" / f"{name}-dance.npy")
        assert np.load(path).shape == (6, 4, 4)
        np.testing.assert_allclose(np.load(path), want, atol=1e-6, rtol=0)


# ------------------------------------------------------------ depth


TINY_DPT = dict(hidden_size=32, num_layers=2, num_heads=2, mlp_dim=64, patch_grid=24,
                bit_embed=16, bit_depths=(1, 1, 1), bit_hidden=(32, 32, 64),
                neck_hidden=(32, 32, 32, 32), fusion_hidden=32, vit_out_layers=(0, 1),
                gn_groups=4)


def test_depth_from_image(tmp_path, monkeypatch):
    """A tiny DPT at the depth tool's 384^2 grid, saved as the released file is
    (its two dead tensors included), through both drivers."""
    torch.manual_seed(0)
    model = dpt.DPTHybridDepth(dpt.DPTHybridConfig(**TINY_DPT))
    rng = np.random.default_rng(3)
    with torch.no_grad():
        for p in model.parameters():
            if not p.any():
                p.copy_(torch.from_numpy(rng.normal(0, 0.05, p.shape).astype(np.float32)))
    sd = dict(model.state_dict())
    sd["dpt.layernorm.weight"] = sd["dpt.layernorm.bias"] = torch.zeros(32)
    for c in (1, 2):
        sd[f"neck.fusion_stage.layers.0.residual_layer1.convolution{c}.weight"] = \
            torch.zeros(32, 32, 3, 3)
    weights = str(tmp_path / "pytorch_model.bin")
    torch.save(sd, weights)
    picture = write_picture(tmp_path / "char.png")

    monkeypatch.setattr(depth_from_image, "DPTHybridConfig",
                        lambda: dpt.DPTHybridConfig(**TINY_DPT))
    out = depth_from_image.main(["--image_path", picture, "--save_dir", str(tmp_path / "port"),
                                 "--model", weights, "--device", "cpu"])
    monkeypatch.setattr(jdpt, "DPTHybridDepth", functools.partial(
        jdpt.DPTHybridDepth, cfg=jdpt.DPTHybridConfig(**TINY_DPT)))
    monkeypatch.setattr(jconvert, "convert_dpt", functools.partial(
        jconvert.convert_dpt, depths=(1, 1, 1), num_layers=2))
    jdepth_tool.main(argparse.Namespace(image_path=picture, save_dir=str(tmp_path / "jax"),
                                        model=weights, backend="flax"))
    got, want = np.load(out), np.load(tmp_path / "jax" / "depm-char.npy")
    assert got.shape == (1, 50, 70) and got.min() == 0.0 and got.max() == 1.0
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)
    from PIL import Image

    previews = [np.asarray(Image.open(tmp_path / d / "depi-char.png"), np.int16)
                for d in ("port", "jax")]
    assert np.abs(previews[0] - previews[1]).max() <= 1
    with pytest.raises(SystemExit, match="weights not found"):
        depth_from_image.main(["--image_path", picture, "--model", str(tmp_path / "none.bin"),
                               "--device", "cpu"])


# ------------------------------------------------------------ skeleton maps


@pytest.mark.parametrize("extra", [
    [], ["--real_human"], ["--instance", "locust"],
    ["--instance", "a red dragon", "--keypoint_example", "hand"],
])
def test_xpose_video_synthetic_keypoints(tmp_path, monkeypatch, extra):
    clip = write_clip(tmp_path / "dance.mp4", frames=4)
    args = ["-i", clip, "--synthetic_keypoints"] + extra
    got = inference_xpose_on_video.main(args + ["-o", str(tmp_path / "port")])
    run_jax_main(monkeypatch, jvideo_tool, args + ["-o", str(tmp_path / "jax")])
    assert len(got) == (3 if not extra or extra == ["--real_human"] else 1)
    for path in got:
        want = tmp_path / "jax" / path.split("/")[-1]
        a = np.stack([np.asarray(f) for f in media.read_frames(path)])
        b = np.stack([np.asarray(f) for f in media.read_frames(str(want))])
        assert a.shape == (4, 48, 64, 3)
        np.testing.assert_array_equal(a, b)
        assert a.any()


@pytest.mark.parametrize("instance", ["person", "face", "hand", "car"])
def test_xpose_image_synthetic_keypoints(tmp_path, monkeypatch, instance):
    from PIL import Image

    picture = write_picture(tmp_path / "char.png")
    args = ["-i", picture, "--synthetic_keypoints", "--instance", instance]
    got = inference_xpose_on_image.main(args + ["-o", str(tmp_path / "port")])
    run_jax_main(monkeypatch, jimage_tool, args + ["-o", str(tmp_path / "jax")])
    a = np.asarray(Image.open(got))
    want = np.asarray(Image.open(tmp_path / "jax" / f"{instance}-char.png"))
    np.testing.assert_array_equal(a, want)
    assert a.shape == (50, 70, 3) and a.any()


def test_resize_short_side():
    from PIL import Image

    rng = np.random.default_rng(4)
    frames = [Image.fromarray(rng.integers(0, 256, (50, 70, 3), dtype=np.uint8)) for _ in range(2)]
    got = inference_xpose_on_video.resize_short_side(frames, short=64)
    np.testing.assert_array_equal(got, jvideo_tool.resize_short_side(frames, short=64))
    assert got.shape == (2, 64, 96, 3)


@pytest.mark.parametrize("size", [(720, 1280), (1920, 1080), (70, 50)])
def test_resized_size(size):
    """The driver's resize arithmetic alone: the frame size the JAX driver's
    ``resize_short_side`` gives (800 x 1408 for a 720 x 1280 portrait clip)."""
    from PIL import Image

    want = jvideo_tool.resize_short_side([Image.new("RGB", size)]).shape[1:3]
    assert inference_xpose_on_video.resized_size(*size) == want[::-1]
    if size == (720, 1280):
        assert want == (1408, 800)


class _Recorder(torch.nn.Module):
    """Stands in for UniPose and DPT: records cuDNN's TF32 setting at each call."""

    def __init__(self):
        super().__init__()
        self.seen = []
        self.dpt = types.SimpleNamespace(embeddings=types.SimpleNamespace(
            cls_token=torch.zeros(1)))

    def forward(self, x, *rest):
        self.seen.append(torch.backends.cudnn.allow_tf32)
        if not rest:  # DPT: (B, 384, 384) depth
            return x.mean(-1)
        G, n_txt, k = 3, rest[0].shape[1], rest[2].shape[1]
        return {"pred_logits": torch.zeros(1, G, n_txt), "pred_boxes": torch.rand(1, G, 4),
                "pred_keypoints": torch.rand(1, G, 3 * k)}


def test_drivers_run_convolutions_in_fp32(monkeypatch):
    """The depth driver's ``run_depth`` and the video driver's ``detect`` run
    their network with cuDNN's TF32 convolutions off, whatever the process
    has set, and leave the setting as they found it."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    model = _Recorder()
    depth = depth_from_image.run_depth(model, torch.ones(1, 8, 8, 3))
    assert depth.shape == (8, 8)

    text = lambda ids: torch.zeros(ids.shape[0], 16)  # noqa: E731
    det = inference_xpose_on_video.Detector(model, torch.nn.Identity(), _Tokenizer(), "cpu")
    det.text_model = text
    frames = np.zeros((2, 32, 32, 3), np.float32)
    names = inference_xpose_on_video.VOCABS["hand"][0]
    kpts = det.detect(frames, "hand", names, 0.2, 0.4)
    assert len(kpts) == 2 and kpts[0].shape[1:] == (len(names), 2)
    assert model.seen == [False] * 3
    assert torch.backends.cudnn.allow_tf32 is True


# ------------------------------------------------------------ the detector

TINY_SWIN = dict(embed_dim=16, depths=(1, 1, 1, 1), heads=(2, 2, 4, 4), window=7)
TINY_CONFIG = ("modelname = 'UniPose'\ntwo_stage_type = 'standard'\ndecoder_sa_type = 'sa'\n"
               "hidden_dim = 64\nenc_layers = 1\ndec_layers = 3\nnheads = 4\n"
               "dim_feedforward = 128\nnum_queries = 60\nnum_select = 4\n"
               "enc_n_points = 2\ndec_n_points = 2\n")
TINY_CLIP = dict(vocab_size=1000, width=512, layers=1, heads=8)


class _Tokenizer:
    """Stands in for ``CLIPTokenizer``: ids from the prompt's characters,
    then the EOT id (the largest) as padding to 77."""

    def __call__(self, prompts, padding, max_length, return_tensors):
        ids = [[ord(c) % 990 for c in p][: max_length - 1] for p in prompts]
        return {"input_ids": np.array([row + [999] * (max_length - len(row)) for row in ids],
                                      np.int32)}

    @classmethod
    def from_pretrained(cls, path):
        return cls()


def test_detector_from_files(tmp_path, monkeypatch):
    """A tiny UniPose checkpoint (``module.`` prefixes and dead keys as the
    released file has them) and a tiny CLIP ``pytorch_model.bin`` (a whole
    CLIPModel's keys) through each driver's Detector: the same keypoints."""
    monkeypatch.setitem(sys.modules, "transformers",
                        types.SimpleNamespace(CLIPTokenizer=_Tokenizer))
    monkeypatch.setitem(xpose_config.SWIN_VARIANTS, "swin_T_224_1k", TINY_SWIN)
    monkeypatch.setitem(jxcfg.SWIN_VARIANTS, "swin_T_224_1k", TINY_SWIN)
    config = tmp_path / "tiny.py"
    config.write_text(TINY_CONFIG)

    torch.manual_seed(0)
    model = xpose_config.build_unipose_from_config(str(config))
    rng = np.random.default_rng(5)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if not p.any() or name.endswith(("gamma_v", "gamma_l")):
                p.copy_(torch.from_numpy(rng.normal(0, 0.05, p.shape).astype(np.float32)))
    ckpt = {f"module.{k}": v for k, v in model.state_dict().items()}
    ckpt["module.label_enc.weight"] = torch.zeros(3, 64)
    ckpt["module.bbox_embed.1.layers.0.weight"] = torch.zeros(64, 64)
    torch.save({"model": ckpt}, tmp_path / "unipose.pth")
    clip_dir = tmp_path / "clip"
    clip_dir.mkdir()
    torch.manual_seed(1)
    text = clip_text.CLIPTextEncoder(**TINY_CLIP)
    torch.save(dict(text.state_dict(), logit_scale=torch.ones(()),
                    **{"visual_projection.weight": torch.ones(4, 4)}),
               clip_dir / "pytorch_model.bin")

    monkeypatch.setattr(clip_text, "CLIPTextEncoder",
                        functools.partial(clip_text.CLIPTextEncoder, **TINY_CLIP))
    det = inference_xpose_on_video.Detector.from_files(
        str(tmp_path / "unipose.pth"), str(clip_dir), str(config), device="cpu")
    monkeypatch.setattr(jclip, "CLIPTextEncoder", functools.partial(jclip.CLIPTextEncoder,
                                                                    **TINY_CLIP))
    monkeypatch.setattr(jconvert, "convert_unipose", functools.partial(
        jconvert.convert_unipose, enc_layers=1, dec_layers=3, depths=(1, 1, 1, 1)))
    monkeypatch.setattr(jconvert, "convert_clip_text_hf", functools.partial(
        jconvert.convert_clip_text_hf, num_layers=1))
    jdet = jvideo_tool.Detector(str(tmp_path / "unipose.pth"), str(clip_dir), (64, 64),
                                model_config=str(config))

    frames = np.random.default_rng(6).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    names = inference_xpose_on_video.VOCABS["person"][0]
    got = det.detect(frames, "person", names, -1.0, 1.0)  # keep every group, no NMS
    want = jdet.detect(frames, "person", names, -1.0, 1.0)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.shape == (4, 17, 2)
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-3, rtol=0)
    assert type(det.model) is unipose.UniPose
