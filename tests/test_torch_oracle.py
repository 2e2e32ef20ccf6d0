"""The port's fidelity gate on the CPU: ``scripts/_oracle.py`` (the twins and
the reference's inference algorithm in plain PyTorch, with no JAX),
``run_pipeline_vs_oracle``, ``scripts/psnr_sd_width.py`` and
``scripts/verify_parity.py``.

The copied twins are held to the JAX package's test twins (same seed: same
keys, values and outputs); the port's pipeline to the oracle at the JAX
test's tiny geometry (``tests/test_e2e_psnr.py:57-67``: 5 frames, 128^2, 3
steps, 5 context tokens) in fp32, where the JAX test asks 50 dB and latents
within 5e-3 / 1e-3; the SD-width gate itself (768^2) is ``slow``. Torch runs
on 2 threads; no JAX program is compiled (the twins are torch).
"""

import json

import numpy as np
import pytest
import torch

from mikudance_tpu_torch.pipelines import context
from mikudance_tpu_torch.scripts import _oracle as o
from mikudance_tpu_torch.scripts import psnr_sd_width, verify_parity

TINY_GATE = dict(T=5, H=128, W=128, s_ctx=5, ctx_frames=3, overlap=1)


@pytest.fixture(autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _same(a: torch.nn.Module, b: torch.nn.Module) -> None:
    sa, sb = a.state_dict(), b.state_dict()
    assert list(sa) == list(sb)
    for key in sa:
        torch.testing.assert_close(sa[key], sb[key], rtol=0, atol=0, msg=key)


@pytest.mark.parametrize("variant", ["guidance", "denoising"])
def test_unet_twin_copy_equals_the_test_twin(variant):
    """``_oracle.TUNet`` is ``tests/test_torch_parity.TUNet``: the same seed
    gives the same state dict and the same outputs (banks included)."""
    from test_torch_parity import TUNet

    kw = dict(in_ch=20, man=True) if variant == "guidance" else dict(in_ch=4, motion=True)
    nets = []
    for cls in (TUNet, o.TUNet):
        torch.manual_seed(5)
        nets.append(cls((32, 64, 96, 96), 2, 4, 768, **kw).eval())
    _same(*nets)
    rng = np.random.default_rng(0)
    T = 3
    x = torch.from_numpy(rng.normal(size=(T, kw["in_ch"], 16, 16)).astype(np.float32))
    ctx = torch.from_numpy(rng.normal(size=(1 if variant == "denoising" else T, 5, 768))
                           .astype(np.float32))
    with torch.no_grad():
        if variant == "guidance":
            motion = torch.from_numpy(rng.normal(size=(T, 2, 16, 16)).astype(np.float32))
            outs = [n(x, torch.zeros(T), ctx, motion_map=motion, write=True) for n in nets]
        else:
            outs = [n(x, torch.full((1,), 501.0), ctx, T=T) for n in nets]
    torch.testing.assert_close(outs[1][0], outs[0][0], rtol=0, atol=0)
    assert outs[0][1].keys() == outs[1][1].keys()
    for key, bank in outs[0][1].items():
        if bank is not None:
            torch.testing.assert_close(outs[1][1][key], bank, rtol=0, atol=0)


def test_vae_twin_copy_equals_the_test_twin():
    """``_oracle.TAutoencoderKL()`` (the tiny widths by default) is
    ``tests/test_vae_parity.TAutoencoderKL``: same keys, values, encodes and
    decodes."""
    from test_vae_parity import TAutoencoderKL

    nets = []
    for cls in (TAutoencoderKL, o.TAutoencoderKL):
        torch.manual_seed(7)
        nets.append(cls().eval())
    _same(*nets)
    rng = np.random.default_rng(1)
    img = torch.from_numpy(rng.uniform(-1, 1, (2, 3, 64, 64)).astype(np.float32))
    z = torch.from_numpy(rng.normal(size=(2, 4, 8, 8)).astype(np.float32))
    with torch.no_grad():
        enc = [o.torch_encode_mean(n, img) for n in nets]
        dec = [n.decoder(n.post_quant_conv(z)) for n in nets]
    torch.testing.assert_close(enc[1], enc[0], rtol=0, atol=0)
    torch.testing.assert_close(dec[1], dec[0], rtol=0, atol=0)


@pytest.mark.parametrize("frames,size,overlap", [(2, 3, 1), (5, 3, 1)])
def test_oracle_windows_are_the_jax_package_windows(frames, size, overlap):
    """The oracle's windows (the port's ``uniform_windows``, schedule data)
    are the JAX package's at the gate's (2 frames) and the tiny test's (5)
    geometry."""
    from mikudance_tpu.pipelines.context import uniform_windows

    want = uniform_windows(0, frames, size, 1, overlap)
    assert context.uniform_windows(0, frames, size, 1, overlap) == want
    assert want == ([[0, 1]] if frames == 2 else [[0, 1, 2], [2, 3, 4], [4, 0, 1]])


def test_pipeline_matches_the_oracle_at_tiny_width():
    """The port's ``VideoPipeline`` on the tiny twins' weights (loaded through
    ``core/loaders.py``) against the oracle: the JAX test's bars."""
    tvae, tguide, tden = o.make_twins(o.TINY.block_out_channels, 4, "cpu")
    got_video, want_video, got_lat, want_lat = o.run_pipeline_vs_oracle(
        tvae, tguide, tden, device="cpu")
    assert got_video.shape == want_video.shape == (5, 128, 128, 3)
    np.testing.assert_allclose(got_lat, want_lat.transpose(0, 2, 3, 1), atol=5e-3, rtol=1e-3)
    psnr = o.psnr(got_video, want_video, 255.0)
    assert psnr >= 50.0, f"PSNR {psnr:.1f} dB"


def test_gate_at_tiny_width_in_both_dtypes():
    """``psnr_sd_width.run_gate`` at the tiny geometry: one oracle, the port
    in fp32 and in bf16, each record over the bar with the script's keys."""
    records = psnr_sd_width.run_gate(("fp32", "bf16"), steps=3, device="cpu", unet_cfg=o.TINY,
                                     geometry=TINY_GATE, log=lambda msg: None)
    assert [("fp32" in r["metric"], "bf16" in r["metric"]) for r in records] == \
        [(True, False), (False, True)]
    for r in records:
        assert {"psnr_db", "latent_max_abs_err", "bar_db", "pass", "elapsed_s", "device",
                "launches"} <= r.keys()
        assert r["pass"] and r["psnr_db"] >= 35.0 and r["device"] == "cpu"
        assert r["launches"] == {}  # the CPU takes the plain versions
    assert records[0]["psnr_db"] > records[1]["psnr_db"]
    json.dumps(records)


def test_verify_parity_selfcheck_passes(capsys):
    assert verify_parity.main(["--selfcheck", "--device", "cpu"]) == 0
    verdict = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert verdict["mode"] == "selfcheck" and verdict["pass"] is True
    assert verdict["stages"]["convert"]["ok"] and verdict["stages"]["e2e_psnr"]["psnr_db"] >= 50


def test_verify_parity_weights_mode_without_weights_fails(tmp_path, capsys):
    """No checkpoints under ``--weights_dir``: the verdict says so, ``pass``
    is false and the exit code non-zero (no quiet switch to the selfcheck)."""
    out = tmp_path / "verdict.json"
    assert verify_parity.main(["--weights_dir", str(tmp_path), "--device", "cpu",
                               "--out", str(out)]) == 1
    verdict = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert verdict == json.loads(out.read_text())
    assert verdict["mode"] == "real" and verdict["pass"] is False
    assert "FileNotFoundError" in verdict["stages"]["convert"]["error"]


def test_gate_scripts_raise_without_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        psnr_sd_width.main([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        verify_parity.main(["--selfcheck"])


@pytest.mark.slow
def test_sd_width_gate_on_the_cpu():
    """The SD-width gate (768^2, SD1.5 UNet widths, 2 steps) in fp32 on the
    CPU: tens of GB and many minutes of one host."""
    (record,) = psnr_sd_width.run_gate(("fp32",), steps=2, device="cpu", log=lambda m: None)
    assert record["pass"], record
