"""The port's frame-sharded modules and CLI on gloo ranks, against JAX.

Ranks are processes spawned by ``core.mesh.spawn`` on the CPU (gloo, one
thread each, rendezvous through a file in a fresh directory); their bodies
live in the torch-only ``_torch_sharded_ranks.py``. Each rank holds its share
of the frames; its outputs, put side by side, are held to the JAX module run
unsharded on the whole input:

- ``MotionModule`` with its frames split over 4 ranks, on the ``all_to_all``
  path (positions split over the ranks) and on the gather path (a 3 x 3 map:
  9 positions do not split 4 ways), 2e-4;
- ``TemporalDecoder`` with a chunk's 8 frames split over 4 ranks (halos,
  summed GroupNorm moments, zeros at the chunk's ends) and ``decode_frames``
  on a mesh (whole chunks a rank; a chunk's frames a rank plus a remainder
  chunk), 2e-4 as the unsharded parity tests;
- the CLI under ``torchrun`` on 3 ranks, of which the chosen mesh takes 2:
  rank 0 alone writes the video, which is the one-process CLI's;
- ``spawn``'s report when a rank fails: every rank stopped, the first to
  fail named and its traceback last.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_sharded_ranks as ranks
import jax.numpy as jnp
from mikudance_tpu.core import convert as jconvert
from mikudance_tpu.core.configs import VAEConfig
from mikudance_tpu.models import motion_module as jmotion
from mikudance_tpu.models import vae_temporal as jvae_temporal
from mikudance_tpu.pipelines import video as jvideo
from mikudance_tpu_torch.core import mesh
from mikudance_tpu_torch.models import motion_module, vae_temporal

RANKS = 4
TINY_VAE = VAEConfig(block_out_channels=(16, 32, 32, 32), norm_num_groups=8)


def seeded(module, seed):
    """PyTorch's init under a seed, every all-zero tensor refilled (the
    motion module's zero-init ``proj_out`` would hide the attention)."""
    torch.manual_seed(seed)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for p in module.parameters():
            if not p.any():
                p.copy_(torch.from_numpy(rng.normal(0, 0.05, p.shape).astype(np.float32)))
    return module.eval()


def close(got, want, atol, name):
    err = float(np.max(np.abs(np.asarray(got, np.float32) - np.asarray(want, np.float32))))
    assert err < atol, f"{name}: max abs err {err:.2e} >= {atol}"


# ------------------------------------------------------------ motion module

@pytest.fixture(scope="module")
def motion():
    """One spawn: two inputs of 8 frames through the module on 4 ranks; the
    JAX module unsharded on each."""
    tm = seeded(motion_module.MotionModule(64, 4), 5)
    params = {}
    jconvert._convert_motion_module({f"m.{k}": v for k, v in tm.state_dict().items()}, "m",
                                    params, ())
    rng = np.random.default_rng(5)
    inputs = [rng.normal(size=(2, 8, 4, 4, 64)).astype(np.float32),  # 16 positions: all_to_all
              rng.normal(size=(1, 8, 3, 3, 64)).astype(np.float32)]  # 9 positions: gather
    want = [np.asarray(jmotion.MotionModule(64, heads=4).apply({"params": params},
                                                              jnp.asarray(x)))
            for x in inputs]
    got = mesh.spawn(RANKS, ranks.motion_module_shards, (64, 4, ranks.numpy_state(tm), inputs))
    return want, got


@pytest.mark.parametrize("case,path", [(0, "all_to_all"), (1, "all_gather")])
def test_motion_module_sharded_matches_jax(motion, case, path):
    want, got = motion
    out = np.concatenate([outs[case] for outs, _ in got], axis=1)  # frames in rank order
    assert out.shape == want[case].shape
    close(out, want[case], 2e-4, f"motion module, {path} path")
    for _, calls in got:  # one reshard and its inverse, or one gather
        assert calls[case] == ({"all_to_all": 2} if path == "all_to_all" else {"all_gather": 1})


# -------------------------------------------------------- temporal decoder

def test_temporal_decoder_frame_sharded_matches_jax():
    tm = seeded(vae_temporal.TemporalDecoder(TINY_VAE), 15)
    rng = np.random.default_rng(15)
    with torch.no_grad():  # the blend away from 0.5
        for name, p in tm.named_parameters():
            if name.endswith("mix_factor"):
                p.copy_(torch.from_numpy(rng.uniform(-2, 2, p.shape).astype(np.float32)))
    params = {"params": jconvert.convert_temporal_decoder(tm.state_dict())}
    z = rng.normal(size=(8, 4, 4, 4)).astype(np.float32)
    # 16 frames: four chunks of 4, one a rank; 10: two chunks of 4 split a
    # frame a rank, then a remainder of 2 decoded on every rank
    stacks = [rng.normal(0, 0.2, (n, 4, 4, 4)).astype(np.float32) for n in (16, 10)]
    got = mesh.spawn(RANKS, ranks.temporal_decoder_shards, (ranks.numpy_state(tm), z, stacks, 4))

    jdec = jvae_temporal.TemporalDecoder(TINY_VAE, decode_chunk=4)
    want = np.asarray(jdec.apply(params, jnp.asarray(z)))
    out = np.concatenate([mine for mine, _, _ in got])
    assert out.shape == want.shape == (8, 32, 32, 3)
    close(out, want, 2e-4, "temporal decoder, 2 frames a rank")
    for lat, k in zip(stacks, range(2)):
        want_k = np.asarray(jvideo.decode_frames(jdec, params, jnp.asarray(lat)))
        for _, whole, _ in got:
            close(whole[k], want_k, 2e-4, f"decode_frames of {lat.shape[0]} frames on a mesh")
    # halos point to point (one exchange a temporal convolution), moments
    # summed, the decoded parts gathered
    assert all(calls["halo"] > 0 and calls["psum"] > 0 and calls["all_gather"] > 0
               for _, _, calls in got)


# --------------------------------------------------------------------- CLI


def write_request(tmp_path, frames):
    """A pose video, reference and skeleton pictures, and the YAML naming them."""
    import yaml
    from PIL import Image

    from mikudance_tpu_torch.utils import media

    rng = np.random.default_rng(1)
    for name in ("char.png", "skel.png"):
        Image.fromarray(rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)).save(tmp_path / name)
    media.write_video(rng.integers(0, 256, (frames, 64, 64, 3), dtype=np.uint8),
                      str(tmp_path / "pose.mp4"), fps=10)
    cfg = {"ref_image_path": str(tmp_path / "char.png"), "ref_skel_path": str(tmp_path / "skel.png"),
           "tgt_pose_path": str(tmp_path / "pose.mp4"), "weight_dtype": "fp32"}
    (tmp_path / "request.yaml").write_text(yaml.safe_dump(cfg))
    return str(tmp_path / "request.yaml")


def test_cli_under_torchrun_rank_zero_writes(tmp_path, monkeypatch):
    from mikudance_tpu_torch.core import loaders
    from mikudance_tpu_torch.scripts import inference_video
    from mikudance_tpu_torch.utils import media

    config = write_request(tmp_path, 5)
    argv = ["--config", config, "-W", "64", "-H", "64", "--steps", "2", "--seed", "7",
            "--device", "cpu"]
    # 5 frames, one window: a (win 2, frame 1) mesh takes ranks 0 and 1,
    # rank 2 receives the video by broadcast
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([root, os.environ.get("PYTHONPATH", "")]),
           "OMP_NUM_THREADS": "1"}
    subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                    "--nproc-per-node", "3", ranks.__file__, str(tmp_path)]
                   + argv + ["--output", str(tmp_path / "ranks.mp4")],
                   env=env, check=True, timeout=600)
    got = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(3)]
    assert [out for out, _ in got] == [str(tmp_path / "ranks.mp4"), None, None]
    assert all(grouped for _, grouped in got)

    for name, fixed in ranks.LOADERS.items():  # the one-process CLI on the same request
        real = getattr(loaders, name)
        monkeypatch.setattr(loaders, name, lambda *p, _r=real, _f=fixed, **kw: _r(
            *p, **{**kw, **_f}))
    one = inference_video.main(argv + ["--output", str(tmp_path / "one.mp4")])
    a, b = (np.stack([np.asarray(f, np.float32) for f in media.read_frames(p)])
            for p in (str(tmp_path / "ranks.mp4"), one))
    assert a.shape == b.shape == (5, 3 * 64, 64, 3)  # reference, poses, result
    assert np.abs(a - b).mean() < 0.5  # the same frames, through the same encoder


def test_spawn_reports_the_rank_that_failed_first():
    # rank 1 raises; ranks 0 and 2 lose it in a barrier and fail after it
    with pytest.raises(RuntimeError) as err:
        mesh.spawn(3, ranks.fail_on, (1,), timeout=120)
    lines = str(err.value).rstrip().splitlines()
    assert lines[-1].endswith("rank 1 failed first")
    assert lines[-2] == "ValueError: rank 1 fails on purpose"
