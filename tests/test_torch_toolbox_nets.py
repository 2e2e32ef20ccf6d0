"""The port's toolbox networks against the JAX package's, on the CPU, in fp32.

Deformable attention on ``tests/test_deformable.py``'s shapes, Swin at
``embed_dim=32, depths=(1, 1, 1, 1)`` (``tests/test_unipose.py:37``) on a map
whose sides need the window padding, CLIP-text at ``width=64, layers=2``, the
tiny UniPose of ``tests/test_unipose.py:70`` (both decoder phases run) and a
tiny ``DPTHybridConfig`` at 64^2. Each network in both directions of the
weight bridge: the port's ``state_dict`` through the converter into the JAX
module, and a JAX init tree through the inverse into the port's module with
``strict=True``; the round trip is the identity. Limits: 2e-4 per module,
1e-3 for UniPose and DPT.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mikudance_tpu.core import convert as jconvert
from mikudance_tpu.toolbox import clip_text as jclip
from mikudance_tpu.toolbox import dpt as jdpt
from mikudance_tpu.toolbox import swin as jswin
from mikudance_tpu.toolbox import unipose as juni
from mikudance_tpu.toolbox.deformable import ms_deform_attn as jms_deform_attn
from mikudance_tpu_torch.core import convert
from mikudance_tpu_torch.toolbox import clip_text, dpt, native, swin, unipose, xpose_config
from mikudance_tpu_torch.toolbox.deformable import ms_deform_attn

torch.set_num_threads(2)


def seeded(module: torch.nn.Module, seed: int) -> torch.nn.Module:
    """PyTorch's default init under a seed, then every all-zero tensor and
    the fusion blocks' 1e-4 layer scales refilled with seeded normals, so no
    branch is silently off."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if not p.any() or name.endswith(("gamma_v", "gamma_l")):
                p.copy_(torch.from_numpy(rng.normal(0, 0.05, p.shape).astype(np.float32)))
    return module.eval()


def build(cls, *args, seed=0, **kwargs):
    torch.manual_seed(seed)
    return seeded(cls(*args, **kwargs), seed)


def close(got, want, atol, name):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    fin = np.isfinite(want)
    assert (np.isfinite(got) == fin).all(), f"{name}: non-finite entries differ"
    assert (got[~fin] == want[~fin]).all(), f"{name}: infinities differ"
    err = float(np.max(np.abs(got[fin] - want[fin])))
    assert err < atol, f"{name}: max abs err {err:.2e} >= {atol}"


def as_torch(sd):
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def assert_round_trip(sd, back):
    assert set(back) == set(sd), set(back) ^ set(sd)
    for k, v in sd.items():
        assert np.array_equal(np.asarray(back[k]), v.numpy()), k
        assert np.asarray(back[k]).dtype == v.numpy().dtype, k


def from_jax(module, sd_np):
    module.load_state_dict(as_torch(sd_np), strict=True)
    return module.eval()


def jax_init(module, *inputs):
    return jax.device_get(jax.jit(module.init)(jax.random.PRNGKey(0), *inputs))["params"]


# ------------------------------------------------------------ deformable attention

SHAPES = [(8, 8), (4, 4), (2, 2)]  # tests/test_deformable.py's
B, HEADS, D, Q, P = 2, 4, 16, 10, 4


def _deform_inputs(seed):
    rng = np.random.default_rng(seed)
    S = sum(h * w for h, w in SHAPES)
    value = rng.normal(size=(B, S, HEADS, D)).astype(np.float32)
    locs = rng.uniform(-0.1, 1.1, size=(B, Q, HEADS, len(SHAPES), P, 2)).astype(np.float32)
    w = rng.uniform(size=(B, Q, HEADS, len(SHAPES), P)).astype(np.float32)
    return value, locs, w / w.sum(axis=(-2, -1), keepdims=True)


@pytest.mark.parametrize("q_chunk", [None, 3])
def test_deformable_matches_jax(q_chunk):
    value, locs, w = _deform_inputs(0)
    want = np.asarray(jms_deform_attn(jnp.asarray(value), SHAPES, jnp.asarray(locs),
                                      jnp.asarray(w), q_chunk))
    got = ms_deform_attn(torch.from_numpy(value), SHAPES, torch.from_numpy(locs),
                         torch.from_numpy(w), q_chunk)
    assert got.shape == (B, Q, HEADS * D)
    close(got, want, 2e-4, "ms_deform_attn")
    close(got, native.ms_deform_attn_cpu(value, SHAPES, locs, w), 2e-4, "against C++")


# ------------------------------------------------------------ Swin

SWIN = dict(embed_dim=32, depths=(1, 1, 1, 1), heads=(2, 2, 4, 4))


def test_swin_both_directions():
    x = np.random.default_rng(1).normal(size=(1, 60, 76, 3)).astype(np.float32)  # 15 x 19
    jm = jswin.SwinTransformer(**SWIN)
    port = build(swin.SwinTransformer, **SWIN)
    sd = {f"backbone.0.{k}": v for k, v in port.state_dict().items()}
    tree = convert.convert_swin(sd, depths=SWIN["depths"])
    want = jax.jit(jm.apply)({"params": tree}, jnp.asarray(x))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert [tuple(g.shape) for g in got] == [(1, 8, 10, 64), (1, 4, 5, 128), (1, 2, 3, 256)]
    for i, (g, w) in enumerate(zip(got, want)):
        close(g, w, 2e-4, f"swin out {i}")
    assert_round_trip(sd, convert.swin_state_dict_from_jax(tree))

    init = jax_init(jm, jnp.asarray(x))
    back = convert.swin_state_dict_from_jax(init, prefix="")
    other = from_jax(swin.SwinTransformer(**SWIN), back)
    with torch.no_grad():
        got = other(torch.from_numpy(x))
    for i, (g, w) in enumerate(zip(got, jax.jit(jm.apply)({"params": init}, jnp.asarray(x)))):
        close(g, w, 2e-4, f"swin from the JAX init, out {i}")


def test_swin_helpers():
    for w in (3, 7):
        np.testing.assert_array_equal(swin.relative_position_index(w),
                                      jswin.relative_position_index(w))
    np.testing.assert_array_equal(swin.shift_mask(21, 28, 7, 3), jswin.shift_mask(21, 28, 7, 3))


# ------------------------------------------------------------ CLIP-text

CLIP = dict(vocab_size=1000, width=64, layers=2, heads=4)


def _ids():
    ids = np.random.default_rng(2).integers(0, 998, (3, 8)).astype(np.int32)
    ids[0, 5] = 999  # the EOT id, then EOT padding: pooled at its first place
    ids[0, 6:] = 999
    return ids


def test_clip_text_both_directions():
    ids = _ids()
    jm = jclip.CLIPTextEncoder(**CLIP)
    port = build(clip_text.CLIPTextEncoder, **CLIP)
    sd = port.state_dict()
    tree = convert.convert_clip_text_hf(sd, num_layers=2)
    want = jax.jit(jm.apply)({"params": tree}, jnp.asarray(ids))
    with torch.no_grad():
        got = port(torch.from_numpy(ids).long())
    assert got.shape == (3, 64)
    close(got, want, 2e-4, "clip text")
    assert_round_trip(sd, convert.clip_text_state_dict_from_jax(tree))

    init = jax_init(jm, jnp.asarray(ids))
    other = from_jax(clip_text.CLIPTextEncoder(**CLIP), convert.clip_text_state_dict_from_jax(init))
    with torch.no_grad():
        got = other(torch.from_numpy(ids).long())
    close(got, jax.jit(jm.apply)({"params": init}, jnp.asarray(ids)), 2e-4,
          "clip text from the JAX init")


def test_clip_text_converters_and_checkpoint_filter():
    port = build(clip_text.CLIPTextEncoder, **CLIP)
    sd = port.state_dict()
    jax.tree_util.tree_map(np.testing.assert_array_equal, convert.convert_clip_text_hf(sd, 2),
                           jconvert.convert_clip_text_hf(sd, 2))
    # the OpenAI grammar of the same tensors converts to the same tree
    openai = {"token_embedding.weight": sd["text_model.embeddings.token_embedding.weight"],
              "positional_embedding": sd["text_model.embeddings.position_embedding.weight"],
              "ln_final.weight": sd["text_model.final_layer_norm.weight"],
              "ln_final.bias": sd["text_model.final_layer_norm.bias"],
              "text_projection": sd["text_projection.weight"].T}
    for i in range(2):
        p, h = f"transformer.resblocks.{i}", f"text_model.encoder.layers.{i}"
        for a, b in (("ln_1", "layer_norm1"), ("ln_2", "layer_norm2"),
                     ("attn.out_proj", "self_attn.out_proj"), ("mlp.c_fc", "mlp.fc1"),
                     ("mlp.c_proj", "mlp.fc2")):
            for leaf in ("weight", "bias"):
                openai[f"{p}.{a}.{leaf}"] = sd[f"{h}.{b}.{leaf}"]
        for leaf in ("weight", "bias"):
            openai[f"{p}.attn.in_proj_{leaf}"] = torch.cat(
                [sd[f"{h}.self_attn.{n}.{leaf}"] for n in ("q_proj", "k_proj", "v_proj")])
    got = convert.convert_clip_text(openai, 2)
    jax.tree_util.tree_map(np.testing.assert_array_equal, got, convert.convert_clip_text_hf(sd, 2))
    jax.tree_util.tree_map(np.testing.assert_array_equal, got,
                           jconvert.convert_clip_text(openai, 2))
    # a whole CLIPModel file: the text tower's tensors are kept, nothing else
    whole = dict(sd, **{"vision_model.post_layernorm.weight": torch.ones(3),
                        "visual_projection.weight": torch.ones(2, 2),
                        "logit_scale": torch.ones(()),
                        "text_model.embeddings.position_ids": torch.arange(77)[None]})
    assert set(clip_text.text_state_dict(whole)) == set(sd)


# ------------------------------------------------------------ UniPose

UNIPOSE = dict(hidden_dim=64, enc_layers=1, dec_layers=3, heads=4, points=2, ffn_dim=128,
               num_queries=60, num_groups=4, num_body_points=20, text_dim=16,
               swin_embed_dim=16, swin_depths=(1, 1, 1, 1), swin_heads=(2, 2, 4, 4))
OUTPUTS = ("pred_logits", "pred_boxes", "pred_keypoints")


def _unipose_inputs():
    rng = np.random.default_rng(3)
    img = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    obj = rng.normal(size=(2, 3, 16)).astype(np.float32)
    mask = np.array([[True, True, False], [True, False, False]])
    kpt = rng.normal(size=(2, 20, 16)).astype(np.float32)
    vis = np.ones((2, 20), np.float32)
    vis[:, 15:] = 0.0
    return img, obj, mask, kpt, vis


@pytest.fixture(scope="module")
def unipose_pair():
    return juni.UniPose(**UNIPOSE), build(unipose.UniPose, **UNIPOSE)


def _run_port(model, inputs):
    with torch.no_grad():
        return model(*map(torch.from_numpy, inputs))


def test_unipose_from_port_weights(unipose_pair):
    jm, port = unipose_pair
    inputs = _unipose_inputs()
    sd = port.state_dict()
    tree = convert.convert_unipose(sd, enc_layers=1, dec_layers=3, depths=(1, 1, 1, 1))
    want = jax.jit(jm.apply)({"params": tree}, *map(jnp.asarray, inputs))
    got = _run_port(port, inputs)
    assert got["pred_keypoints"].shape == (2, 4, 60) and got["group_indices"].shape == (2, 4)
    assert got["query_indices"].shape == (2, 60)
    for k in OUTPUTS:
        close(got[k], want[k], 1e-3, k)
    assert bool(torch.isinf(got["pred_logits"][0, :, 2]).all())
    assert_round_trip(sd, convert.unipose_state_dict_from_jax(tree))


def test_unipose_from_jax_init(unipose_pair):
    jm, _ = unipose_pair
    inputs = _unipose_inputs()
    init = jax_init(jm, *map(jnp.asarray, inputs))
    port = from_jax(unipose.UniPose(**UNIPOSE), convert.unipose_state_dict_from_jax(init))
    want = jax.jit(jm.apply)({"params": init}, *map(jnp.asarray, inputs))
    got = _run_port(port, inputs)
    for k in OUTPUTS:
        close(got[k], want[k], 1e-3, f"{k} from the JAX init")


def test_unipose_checkpoint_dead_keys(unipose_pair):
    """A released checkpoint's layout: ``module.`` prefixes, the dead DN and
    CLIP tensors and the shared heads' aliases drop; the rest loads strictly."""
    _, port = unipose_pair
    sd = port.state_dict()
    ckpt = {f"module.{k}": v for k, v in sd.items()}
    junk = torch.zeros(2)
    for k in ("label_enc.weight", "pos_proj.weight", "padding", "clip_model.visual.proj",
              "transformer.decoder.bbox_embed.0.layers.0.weight",
              "transformer.decoder.pose_embed.3.layers.2.bias",
              "transformer.decoder.pose_hw_embed.1.layers.0.weight",
              "transformer.enc_out_bbox_embed.layers.1.bias", "bbox_embed.5.layers.0.weight",
              "pose_embed.1.layers.2.weight", "pose_hw_embed.3.layers.1.bias"):
        ckpt[f"module.{k}"] = junk
    live = unipose.live_state_dict(ckpt)
    assert set(live) == set(sd)
    other = unipose.UniPose(**UNIPOSE)
    other.load_state_dict(live, strict=True)
    with pytest.raises(RuntimeError, match="Unexpected"):
        other.load_state_dict(dict(live, **{"transformer.extra.weight": junk}), strict=True)


def test_unipose_helpers():
    rng = np.random.default_rng(4)
    np.testing.assert_allclose(unipose.sine_pos_embed_hw(5, 7, 16),
                               juni.sine_pos_embed_hw(5, 7, 16), atol=0, rtol=0)
    boxes = rng.uniform(0, 1, (2, 6, 4)).astype(np.float32)
    close(unipose.gen_sineembed_for_position(torch.from_numpy(boxes)),
          juni.gen_sineembed_for_position(jnp.asarray(boxes)), 2e-4, "gen_sineembed")
    pos = rng.uniform(0, 1, (2, 3, 1)).astype(np.float32)
    close(unipose.get_sine_pos_embed(torch.from_numpy(pos), 32),
          juni.get_sine_pos_embed(jnp.asarray(pos), 32), 2e-4, "get_sine_pos_embed")
    x = np.concatenate([rng.uniform(-0.5, 1.5, 20), [0.0, 1.0, 1e-4, 1 - 1e-4]]).astype(np.float32)
    close(unipose.inverse_sigmoid(torch.from_numpy(x)), juni.inverse_sigmoid(jnp.asarray(x)),
          1e-6, "inverse_sigmoid")
    kpt_mask = np.array([[1.0, 1.0, 1.0, 0.0], [1.0, 0.0, 1.0, 0.0]], np.float32)
    np.testing.assert_array_equal(unipose.keypoint_group_mask(torch.from_numpy(kpt_mask), 3),
                                  juni.keypoint_group_mask(jnp.asarray(kpt_mask), 3))
    xyz = rng.normal(size=(2, 3, 12)).astype(np.float32)
    for g, w in zip(unipose.keypoint_xyzxyz_to_xyxyzz(torch.from_numpy(xyz)),
                    juni.keypoint_xyzxyz_to_xyxyzz(jnp.asarray(xyz))):
        np.testing.assert_array_equal(g, w)
    mem = rng.normal(size=(1, 16 + 4 + 1, 8)).astype(np.float32)
    shapes = [(4, 4), (2, 2), (1, 1)]
    for g, w in zip(unipose.gen_encoder_output_proposals(torch.from_numpy(mem), shapes),
                    juni.gen_encoder_output_proposals(jnp.asarray(mem), shapes)):
        np.testing.assert_array_equal(g, w)


def test_top_k_orders_ties_as_jax():
    """The invalid border proposals share one logit: ties are common, and
    their order decides which queries the decoder starts from."""
    x = np.array([[0.5, 2.0, 2.0, -1.0, 2.0, 0.5, 3.0, 0.5],
                  [1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0]], np.float32)
    for k in (1, 3, 5, 8):
        np.testing.assert_array_equal(unipose.top_k(torch.from_numpy(x), k),
                                      jax.lax.top_k(jnp.asarray(x), k)[1])


def test_postprocess_matches_jax():
    rng = np.random.default_rng(5)
    out = {"pred_logits": rng.normal(size=(2, 6, 3)).astype(np.float32),
           "pred_boxes": rng.uniform(0.2, 0.4, (2, 6, 4)).astype(np.float32),
           "pred_keypoints": rng.uniform(0, 1, (2, 6, 15)).astype(np.float32)}
    out["pred_boxes"][0, 3] = out["pred_boxes"][0, 1]  # a duplicate NMS drops
    got = unipose.postprocess({k: torch.from_numpy(v) for k, v in out.items()}, 5, 0.4, 0.5)
    want = juni.postprocess(out, 5, 0.4, 0.5)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            np.testing.assert_array_equal(g[k], w[k])


def test_build_unipose_from_config(tmp_path):
    path = tmp_path / "tiny.py"
    path.write_text("modelname = 'UniPose'\ntwo_stage_type = 'standard'\ndecoder_sa_type = 'sa'\n"
                    "hidden_dim = 64\nenc_layers = 1\ndec_layers = 3\nnheads = 4\n"
                    "dim_feedforward = 128\nnum_queries = 60\nnum_select = 4\n"
                    "num_body_points = 20\nenc_n_points = 2\ndec_n_points = 2\n")
    model = xpose_config.build_unipose_from_config(str(path), dtype=torch.float64)
    kw = xpose_config.unipose_kwargs(xpose_config.load_model_config(str(path)))
    want = unipose.UniPose(**kw)
    assert {k: v.shape for k, v in model.state_dict().items()} == \
        {k: v.shape for k, v in want.state_dict().items()}
    assert model.transformer.level_embed.dtype == torch.float64
    table = model.backbone[0].layers[2].blocks[0].attn.relative_position_bias_table
    assert table.shape == (169, 12)  # Swin-T's third stage: window 7, 12 heads


# ------------------------------------------------------------ DPT

DPT = dict(hidden_size=32, num_layers=2, num_heads=2, mlp_dim=64, patch_grid=4, bit_embed=16,
           bit_depths=(1, 1, 1), bit_hidden=(32, 32, 64), neck_hidden=(32, 32, 32, 32),
           fusion_hidden=32, vit_out_layers=(0, 1), gn_groups=4)


def test_dpt_both_directions():
    x = np.random.default_rng(6).normal(size=(2, 64, 64, 3)).astype(np.float32)
    jm = jdpt.DPTHybridDepth(jdpt.DPTHybridConfig(**DPT))
    port = build(dpt.DPTHybridDepth, dpt.DPTHybridConfig(**DPT))
    sd = port.state_dict()
    tree = convert.convert_dpt(sd, depths=(1, 1, 1), num_layers=2)
    jax.tree_util.tree_map(np.testing.assert_array_equal, tree,
                           jconvert.convert_dpt(sd, depths=(1, 1, 1), num_layers=2))
    want = jax.jit(jm.apply)({"params": tree}, jnp.asarray(x))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got.shape == (2, 64, 64)
    close(got, want, 1e-3, "dpt")
    assert_round_trip(sd, convert.dpt_state_dict_from_jax(tree))

    init = jax_init(jm, jnp.asarray(x))
    other = from_jax(dpt.DPTHybridDepth(dpt.DPTHybridConfig(**DPT)),
                     convert.dpt_state_dict_from_jax(init))
    with torch.no_grad():
        got = other(torch.from_numpy(x))
    close(got, jax.jit(jm.apply)({"params": init}, jnp.asarray(x)), 1e-3, "dpt from the JAX init")
    with pytest.raises(ValueError, match="fixed"):
        port(torch.zeros(1, 80, 80, 3))


def test_dpt_upsample_and_key_grammar(monkeypatch):
    """The port's keys are ``DPTForDepthEstimation``'s, less the two dead
    tensors, at the same shapes."""
    x = np.random.default_rng(7).normal(size=(1, 3, 5, 4)).astype(np.float32)
    close(dpt.upsample2x_ac(torch.from_numpy(x)).permute(0, 2, 3, 1),
          jdpt._upsample2x_ac(jnp.asarray(x.transpose(0, 2, 3, 1))), 1e-6, "upsample2x_ac")
    monkeypatch.setenv("USE_TF", "0")  # transformers' torch half only
    transformers = pytest.importorskip("transformers")
    cfg = transformers.DPTConfig(
        is_hybrid=True, hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
        intermediate_size=64, image_size=64, neck_hidden_sizes=[32, 32, 32, 32],
        reassemble_factors=[1, 1, 1, 0.5], fusion_hidden_size=32, backbone_out_indices=[0, 0, 0, 1],
        backbone_featmap_shape=[1, 64, 4, 4],
        backbone_config=transformers.BitConfig(
            global_padding="same", layer_type="bottleneck", depths=[1, 1, 1],
            hidden_sizes=[32, 32, 64], embedding_size=16, num_groups=4,
            out_features=["stage1", "stage2", "stage3"], embedding_dynamic_padding=True))
    hf = transformers.DPTForDepthEstimation(cfg).state_dict()
    ours = dpt.DPTHybridDepth(dpt.DPTHybridConfig(**DPT)).state_dict()
    live = dpt.live_state_dict(hf)
    assert set(hf) - set(live) == {"dpt.layernorm.weight", "dpt.layernorm.bias"} | {
        f"neck.fusion_stage.layers.0.residual_layer1.convolution{c}.{leaf}"
        for c in (1, 2) for leaf in ("weight", "bias")}
    assert {k: tuple(v.shape) for k, v in live.items()} == \
        {k: tuple(v.shape) for k, v in ours.items()}
