"""The port's framework-free toolbox against the JAX package's, on the CPU.

Vocabularies, keypoint colours, the skeleton renderers (cv2 is present
here), the camera post-processing, the XPose config loader and the native
C++ deformable-attention kernel. Exact for the integer, colour, pixel and
config outputs; 1e-6 for the camera floats; 2e-4 for the port's C++ kernel
against the JAX package's jnp op. No JAX network is built here.
"""

import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mikudance_tpu.toolbox import camera as jcam
from mikudance_tpu.toolbox import keypoints as jkp
from mikudance_tpu.toolbox import skeleton_render as jsr
from mikudance_tpu.toolbox import vocabularies as jvocab
from mikudance_tpu.toolbox import xpose_config as jxcfg
from mikudance_tpu.toolbox.deformable import ms_deform_attn as jms_deform_attn
from mikudance_tpu_torch.toolbox import camera, keypoints, native, skeleton_render, vocabularies
from mikudance_tpu_torch.toolbox import xpose_config

torch.set_num_threads(2)


# ------------------------------------------------------------ vocabularies


def test_catalog_is_the_jax_packages():
    assert vocabularies.VOCAB == jvocab.VOCAB
    assert len(vocabularies.VOCAB) == 28


@pytest.mark.parametrize("instance, example", [
    ("person", None), ("face", None), ("locust", None), ("a red dragon", None),
    ("a red dragon", "hand"), ("person", "not a category"), ("car", "fly"),
])
def test_resolve_vocabulary(instance, example):
    assert vocabularies.resolve_vocabulary(instance, example) == \
        jvocab.resolve_vocabulary(instance, example)


# ------------------------------------------------------------ keypoints


def test_keypoint_constants():
    for name in ("PERSON_KEYPOINTS", "PERSON_SKELETON", "FACE_KEYPOINTS", "FACE_SKELETON",
                 "HAND_KEYPOINTS", "HAND_SKELETON", "POSE_KPT_COLORS", "POSE_LINK_COLORS"):
        assert getattr(keypoints, name) == getattr(jkp, name), name


def test_keypoint_colours():
    names = keypoints.FACE_KEYPOINTS + keypoints.HAND_KEYPOINTS + ["elbow", "", "eyebrowless"]
    for n in names:
        assert keypoints.face_kpt_color(n) == jkp.face_kpt_color(n), n
        assert keypoints.hand_kpt_color(n) == jkp.hand_kpt_color(n), n


# ------------------------------------------------------------ renderers


def _points(seed, k, persons=None, lo=0.15, hi=0.85):
    rng = np.random.default_rng(seed)
    shape = (k, 2) if persons is None else (persons, k, 2)
    return rng.uniform(lo, hi, size=shape)


@pytest.mark.parametrize("fn, k, persons", [
    ("render_pose", 17, None), ("render_pose", 17, 2), ("render_face", 68, None),
    ("render_hand", 21, 2), ("render_human_pose", 17, 2), ("render_human_face", 68, None),
    ("render_human_face", 68, 2),  # the multi-face bail-out: a blank canvas
])
def test_renderers_draw_the_same_pixels(fn, k, persons):
    pts = _points(k + (persons or 0), k, persons)
    got = getattr(skeleton_render, fn)(pts.copy(), 160, 120)
    want = getattr(jsr, fn)(pts.copy(), 160, 120)
    assert got.dtype == np.uint8 and got.shape == (120, 160, 3)
    np.testing.assert_array_equal(got, want)
    assert got.any() == (fn != "render_human_face" or persons is None)


def test_pose_visibility_and_canvas():
    pts = _points(3, 17)
    vis = np.ones(17, bool)
    vis[[0, 5, 11]] = False
    canvas = np.full((96, 128, 3), 7, np.uint8)
    got = skeleton_render.render_pose(pts, 128, 96, canvas=canvas.copy(), visibility=vis)
    want = jsr.render_pose(pts, 128, 96, canvas=canvas.copy(), visibility=vis)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("category", ["animal", "car", "fly", "short_sleeved_shirt", "table"])
def test_generic_renderer(category):
    names, skel = vocabularies.resolve_vocabulary(category)
    pts = _points(len(names), len(names), 2)
    np.testing.assert_array_equal(skeleton_render.render_generic(pts, 128, 96, skel),
                                  jsr.render_generic(pts, 128, 96, skel))


def test_human_adjustments():
    pts = _points(5, 68) * 200
    got = skeleton_render.adjust_human_eyes(pts[:, 0].copy(), pts[:, 1].copy())
    want = jsr.adjust_human_eyes(pts[:, 0].copy(), pts[:, 1].copy())
    np.testing.assert_array_equal(np.stack(got), np.stack(want))
    pose = _points(6, 17) * 200
    got = skeleton_render.adjust_human_pose(pose[:, 0].copy(), pose[:, 1].copy())
    want = jsr.adjust_human_pose(pose[:, 0].copy(), pose[:, 1].copy())
    np.testing.assert_array_equal(np.stack(got), np.stack(want))


# ------------------------------------------------------------ camera


def _quats(seed, n):
    q = np.random.default_rng(seed).normal(size=(n, 4))
    return q / np.linalg.norm(q, axis=1, keepdims=True)


@pytest.mark.parametrize("t", [0.0, 0.3, 0.5, 1.0])
def test_slerp(t):
    q0, q1 = _quats(0, 2)
    cases = [(q0, q1), (q0, -q1),  # the antipodal flip
             (q0, q0 + 1e-5)]  # the near-parallel linear branch
    for a, b in cases:
        np.testing.assert_allclose(camera.slerp_quat(t, a, b), jcam.slerp_quat(t, a, b),
                                   atol=1e-6, rtol=0)


def _keyframes(seed, k):
    rng = np.random.default_rng(seed)
    steps = np.sort(rng.choice(np.arange(2, 30), size=k, replace=False)).astype(np.float64)
    poses = np.concatenate([rng.normal(size=(k, 3)), _quats(seed + 1, k)], axis=1)
    return steps, poses


def test_interpolation_and_matrices():
    steps, poses = _keyframes(1, 5)
    got = camera.interpolate_camera_poses(steps, poses, 34)
    want = jcam.interpolate_camera_poses(steps, poses, 34)
    assert got.shape == (34, 7)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    for a, b in zip(camera.poses_to_matrices(got), jcam.poses_to_matrices(want)):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)
    for q in _quats(2, 4):
        np.testing.assert_allclose(camera.quat_to_rotation(q), jcam.quat_to_rotation(q),
                                   atol=1e-6, rtol=0)


def test_export_camera_files(tmp_path):
    steps, poses = _keyframes(3, 4)
    got = camera.export_camera_files(str(tmp_path / "port"), "clip", steps, poses, 12)
    want = jcam.export_camera_files(str(tmp_path / "jax"), "clip", steps, poses, 12)
    for a, b in zip(got, want):
        np.testing.assert_allclose(np.load(a), np.load(b), atol=1e-6, rtol=0)
    np.testing.assert_allclose(np.load(tmp_path / "port/clip/cps-clip.npy"),
                               np.load(tmp_path / "jax/clip/cps-clip.npy"), atol=1e-6, rtol=0)
    obj = [(tmp_path / d / "clip/cam-clip.obj").read_text().split("\n") for d in ("port", "jax")]
    assert len(obj[0]) == len(obj[1]) == 12 * (5 + 8) + 1
    for a, b in zip(*obj):
        if a.startswith("v "):
            np.testing.assert_allclose(np.array(a.split()[1:], float),
                                       np.array(b.split()[1:], float), atol=1e-6, rtol=0)
        else:
            assert a == b


# ------------------------------------------------------------ XPose configs


def _write(tmp_path, name, body):
    p = tmp_path / name
    p.write_text(textwrap.dedent(body))
    return str(p)


def test_config_chain_and_kwargs(tmp_path):
    _write(tmp_path, "base.py", """
        modelname = 'UniPose'
        hidden_dim = 256
        nheads = 8
        backbone = 'swin_T_224_1k'
        two_stage_type = 'standard'
        decoder_sa_type = 'sa'
        num_body_points = 68
        nested = dict(a=1, b=dict(c=2, d=3))
        replaced = dict(a=1, b=2)
    """)
    _write(tmp_path, "mid.py", """
        _base_ = 'base.py'
        nested = dict(b=dict(c=20))
        replaced = dict(_delete_=True, z=9)
        dec_layers = 4
    """)
    child = _write(tmp_path, "child.py", """
        _base_ = ['mid.py']
        backbone = 'swin_B_384_22k'
        num_box_decoder_layers = 3
    """)
    cfg = xpose_config.load_model_config(child)
    assert cfg == jxcfg.load_model_config(child)
    assert cfg["nested"] == {"a": 1, "b": {"c": 20, "d": 3}} and cfg["replaced"] == {"z": 9}
    assert xpose_config.unipose_kwargs(cfg) == jxcfg.unipose_kwargs(cfg)
    assert xpose_config.SWIN_VARIANTS == jxcfg.SWIN_VARIANTS


@pytest.mark.parametrize("line", [
    "modelname = 'DINO'", "two_stage_type = 'no'", "decoder_sa_type = 'ca_label'",
    "use_deformable_box_attn = True", "binary_query_selection = True",
    "use_text_enhancer = False", "use_fusion_layer = False", "num_patterns = 2",
    "unic_layers = 1", "return_interm_indices = [0, 1, 2, 3]", "backbone = 'resnet50'",
    "enc_n_points = 4\ndec_n_points = 8",
])
def test_config_rejections(tmp_path, line):
    valid = "modelname = 'UniPose'\ntwo_stage_type = 'standard'\ndecoder_sa_type = 'sa'\n"
    body = valid + line + "\n"  # the line overrides a valid value
    cfg = xpose_config.load_model_config(_write(tmp_path, "bad.py", body))
    with pytest.raises(ValueError, match="unsupported XPose") as got:
        xpose_config.unipose_kwargs(cfg)
    with pytest.raises(ValueError, match="unsupported XPose") as want:
        jxcfg.unipose_kwargs(cfg)
    key = line.split("=")[0].strip()
    assert key in str(got.value) or "backbone" in str(got.value), (got.value, want.value)


# ------------------------------------------------------------ native C++ kernel

SHAPES = [(8, 8), (4, 4), (2, 2)]  # tests/test_deformable.py's
B, HEADS, D, Q, P = 2, 4, 16, 10, 4


def _deform_inputs(seed):
    rng = np.random.default_rng(seed)
    S = sum(h * w for h, w in SHAPES)
    value = rng.normal(size=(B, S, HEADS, D)).astype(np.float32)
    locs = rng.uniform(-0.1, 1.1, size=(B, Q, HEADS, len(SHAPES), P, 2)).astype(np.float32)
    w = rng.uniform(size=(B, Q, HEADS, len(SHAPES), P)).astype(np.float32)
    return value, locs, w / w.sum(axis=(-2, -1), keepdims=True)


def test_native_kernel_matches_the_jnp_op():
    value, locs, w = _deform_inputs(1)
    want = np.asarray(jms_deform_attn(jnp.asarray(value), SHAPES, jnp.asarray(locs),
                                      jnp.asarray(w)))
    got = native.ms_deform_attn_cpu(value, SHAPES, locs, w)
    assert got.shape == (B, Q, HEADS * D)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)
    lib = native.library_path()
    assert lib.parent.name == "native" and lib.parent.parent.name == "build" and lib.exists()


def test_native_source_is_the_jax_packages_kernel():
    """The port's copy differs from the JAX package's source only in its
    header comment."""
    def body(path):
        text = path.read_text()
        return text[text.index("#include"):]

    jax_src = native.SRC.parents[3] / "mikudance_tpu" / "toolbox" / "native" / "ms_deform_attn.cpp"
    assert body(native.SRC) == body(jax_src)


def test_native_kernel_refuses_bad_shapes():
    value, locs, w = _deform_inputs(2)
    with pytest.raises(ValueError, match="tile"):
        native.ms_deform_attn_cpu(value, SHAPES[:2], locs, w)
    with pytest.raises(ValueError, match="match"):
        native.ms_deform_attn_cpu(value, SHAPES, locs[:, :, :2], w)


# ------------------------------------------------------------ imports


def test_toolbox_and_tools_import_without_cv2_and_pil():
    """The card's machine has neither cv2 nor PIL: every toolbox and tools
    module imports with both hidden, and the networks' modules run."""
    code = (
        "import importlib, pkgutil, sys\n"
        "sys.modules['cv2'] = None\n"
        "sys.modules['PIL'] = None\n"
        "import mikudance_tpu_torch.toolbox as tb, mikudance_tpu_torch.tools as tl\n"
        "for pkg in (tb, tl):\n"
        "    for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "        importlib.import_module(m.name)\n"
        "import mikudance_tpu_torch.toolbox.unipose, mikudance_tpu_torch.toolbox.dpt\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stdout + res.stderr
