"""The PyTorch port's training path against the JAX package, on the CPU, fp32.

Seeded tiny UNets (the widths of ``tests/test_train_step.py``'s ``TINY``, cut
to three levels of one layer so that one jitted JAX gradient a stage stays
cheap) get the same weights in both packages through the bridge
(``core.convert``); the same numpy batch and the same random draws (the JAX loss's own, recomputed here and
handed to the port) go through ``diffusion_loss`` on both sides. The optimizer
is held to optax on injected gradients, each kernel wrapper's backward to
autograd through its plain version and to ``jax.grad`` of the JAX entry, K12's
plain version to ``flash_attention_fullc_t`` in interpret mode.

Tolerances: schedule and sampling helpers 1e-6; loss 1e-4 relative; gradients
2e-3 relative L2 per tensor; remat on / off 1e-6; optimizer 1e-6; wrapper
backwards 1e-4 (fp32).
"""

import json
import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mikudance_tpu.core import convert as jconvert
from mikudance_tpu.core.configs import UNetConfig
from mikudance_tpu.diffusion import ddim as jddim
from mikudance_tpu.kernels import conv2d as jconv2d
from mikudance_tpu.kernels import flash_attention as jfa
from mikudance_tpu.kernels import group_norm as jgn
from mikudance_tpu.kernels import layer_norm as jln
from mikudance_tpu.kernels import linear as jlinear
from mikudance_tpu.kernels import temporal_attention as jta
from mikudance_tpu.models import unet as junet
from mikudance_tpu.models import vae as jvae
from mikudance_tpu.train import steps as jsteps
from mikudance_tpu_torch.core import convert
from mikudance_tpu_torch.diffusion import ddim
from mikudance_tpu_torch.kernels import _autograd
from mikudance_tpu_torch.kernels import conv2d as pcv
from mikudance_tpu_torch.kernels import flash_attention as pfa
from mikudance_tpu_torch.kernels import group_norm as pgn
from mikudance_tpu_torch.kernels import layer_norm as pln
from mikudance_tpu_torch.kernels import linear as plin
from mikudance_tpu_torch.kernels import temporal_attention as pta
from mikudance_tpu_torch.models import unet, vae
from mikudance_tpu_torch.train import checkpoint as ckpt
from mikudance_tpu_torch.train import steps
from mikudance_tpu_torch.train.runner import train_loop

TINY = UNetConfig(block_out_channels=(32, 64, 96), layers_per_block=1, attention_heads=4)
SMALL = UNetConfig(block_out_channels=(32, 64), layers_per_block=1, attention_heads=4)
B, T, h, w = 2, 2, 8, 8
STAGE2 = ("motion", "man_")


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Tiny tensors gain nothing from many intra-op threads, and several test
    workers on one host lose a lot to them."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def t(x):
    return torch.from_numpy(np.array(x))


def seeded(module: torch.nn.Module, seed: int) -> torch.nn.Module:
    """PyTorch's default init, then every all-zero tensor (biases, the motion
    modules' zero-init proj_out) refilled with seeded normals, so that no
    branch is silently off."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for p in module.parameters():
            if not p.any():
                p.copy_(t(rng.normal(0, 0.05, p.shape).astype(np.float32)))
    return module


def port_models(stage: str, u: UNetConfig = TINY, remat: bool = False, seed: int = 0):
    stage2 = stage == "stage2"
    torch.manual_seed(seed)
    guide = seeded(unet.GuidanceUNet(_guide_cfg(u, stage2), remat=remat), seed)
    den = seeded(unet.DenoisingUNet(_den_cfg(u, stage2), remat=remat), seed + 1)
    return guide, den


def _guide_cfg(u, stage2, mod=None):
    from mikudance_tpu_torch.core import configs as pcfg

    c = mod or pcfg
    return c.GuidanceUNetConfig(unet=_unet_cfg(u, c), use_man=stage2)


def _den_cfg(u, stage2, mod=None):
    from mikudance_tpu_torch.core import configs as pcfg

    c = mod or pcfg
    return c.DenoisingUNetConfig(unet=_unet_cfg(u, c), motion=c.MotionModuleConfig(
        enabled=stage2, num_attention_heads=u.attention_heads))


def _unet_cfg(u, c):
    return c.UNetConfig(block_out_channels=u.block_out_channels,
                        layers_per_block=u.layers_per_block, attention_heads=u.attention_heads)


def jax_models(stage: str, u: UNetConfig = TINY):
    import mikudance_tpu.core.configs as jcfg

    stage2 = stage == "stage2"
    return (junet.GuidanceUNet(_guide_cfg(u, stage2, jcfg)),
            junet.DenoisingUNet(_den_cfg(u, stage2, jcfg)))


def np_batch(seed: int, n: int = B):
    rng = np.random.default_rng(seed)
    uncond = np.zeros(n, np.float32)
    uncond[-1] = 1.0  # one sample drops its conditioning
    return {
        "latents": rng.normal(size=(n, T, h, w, 4)).astype(np.float32),
        "cond20": rng.normal(size=(n, T, h, w, 20)).astype(np.float32),
        "motion": rng.normal(size=(n, T, h, w, 2)).astype(np.float32),
        "clip_ctx": rng.normal(size=(n, 5, 768)).astype(np.float32),
        "uncond": uncond,
    }


def torch_batch(batch):
    return {k: t(v) for k, v in batch.items()}


def jax_draws(key, shape, schedule):
    """The draws ``mikudance_tpu.train.steps.diffusion_loss`` makes from ``key``."""
    r_noise, r_off, r_t = jax.random.split(key, 3)
    return {
        "noise": np.asarray(jax.random.normal(r_noise, shape, jnp.float32)),
        "offset": np.asarray(jax.random.normal(r_off, (shape[0], 1, 1, 1, shape[-1]),
                                               jnp.float32)),
        "t": np.asarray(jax.random.randint(r_t, (shape[0],), 0, schedule.num_train_timesteps)),
    }


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# ------------------------------------------------------ schedule, sampling

@pytest.mark.parametrize("beta_schedule", ["linear", "scaled_linear"])
def test_training_half_of_the_schedule(beta_schedule):
    js = jddim.DDIMSchedule.create(beta_schedule=beta_schedule)
    ps = ddim.DDIMSchedule.create(beta_schedule=beta_schedule)
    rng = np.random.default_rng(0)
    x0, noise = (rng.normal(size=(4, 2, 8, 8, 4)).astype(np.float32) for _ in range(2))
    ts = np.array([0, 17, 500, 999])
    for name in ("add_noise", "get_velocity"):
        want = getattr(js, name)(jnp.asarray(x0), jnp.asarray(noise), jnp.asarray(ts))
        got = getattr(ps, name)(t(x0), t(noise), t(ts))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(ps.snr(t(ts)).numpy(), np.asarray(js.snr(jnp.asarray(ts))),
                               rtol=1e-6, atol=1e-6)
    assert float(ps.snr(t(ts))[-1]) == 0.0  # zero terminal SNR
    for kind in ("v_prediction", "epsilon"):
        want = jddim.min_snr_loss_weight(js, jnp.asarray(ts), 5.0, kind)
        got = ddim.min_snr_loss_weight(ps, t(ts), 5.0, kind)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_latent_sample():
    rng = np.random.default_rng(1)
    moments = rng.normal(0, 3, size=(3, 8, 8, 8)).astype(np.float32)
    moments[0, 0, 0, 4:] = (-40.0, 25.0, 0.0, 1.0)  # beyond both clips
    key = jax.random.PRNGKey(3)
    want = jvae.latent_sample(jnp.asarray(moments), key)
    eps = np.asarray(jax.random.normal(key, (3, 8, 8, 4), jnp.float32))
    got = vae.latent_sample(t(moments), noise=t(eps))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    g = torch.Generator().manual_seed(5)
    a = vae.latent_sample(t(moments), g)
    b = vae.latent_sample(t(moments), torch.Generator().manual_seed(5))
    assert torch.equal(a, b) and not torch.equal(a, got)
    np.testing.assert_allclose(vae.latent_mean(t(moments)).numpy(), moments[..., :4])


# ------------------------------------------------ loss and gradients vs JAX

_JAX_LOSS = {}


def jax_loss_and_grads(stage: str, guide, den):
    """(loss, gradients in the port's names, draws) of the JAX package for the
    port modules' weights; one jitted program per stage, kept while the tests run."""
    if stage not in _JAX_LOSS:
        jguide, jden = jax_models(stage)
        cfg = jsteps.TrainConfig(trainable_substrings=STAGE2 if stage == "stage2" else None)
        schedule = jddim.DDIMSchedule.create(beta_schedule="scaled_linear")

        def loss_fn(params, batch, key):
            return jsteps.diffusion_loss(cfg, schedule, jguide, jden, params, batch, key)[0]

        _JAX_LOSS[stage] = (jax.jit(jax.value_and_grad(loss_fn)), schedule)
    fn, schedule = _JAX_LOSS[stage]
    nb, lpb = len(TINY.block_out_channels), TINY.layers_per_block
    params = convert.train_params_to_jax(guide.state_dict(), den.state_dict(), nb, lpb)
    key = jax.random.PRNGKey(11)
    batch = np_batch(0)
    loss, grads = fn(jax.tree_util.tree_map(jnp.asarray, params),
                     {k: jnp.asarray(v) for k, v in batch.items()}, key)
    flat = convert.train_params_from_jax(jax.device_get(grads), nb, lpb)
    named = {f"{net}.{k}": v for net, sd in flat.items() for k, v in sd.items()}
    return float(loss), named, jax_draws(key, batch["latents"].shape, schedule)


@pytest.mark.parametrize("stage", ["stage1", "stage2"])
def test_diffusion_loss_and_gradients_match_jax(stage):
    guide, den = port_models(stage)
    want_loss, want_grads, draws = jax_loss_and_grads(stage, guide, den)
    cfg = steps.TrainConfig(trainable_substrings=STAGE2 if stage == "stage2" else None)
    schedule = ddim.DDIMSchedule.create(beta_schedule="scaled_linear")
    state = steps.init_train_state(cfg, guide, den)
    loss, metrics = steps.diffusion_loss(cfg, schedule, guide, den, torch_batch(np_batch(0)),
                                         draws={k: t(v) for k, v in draws.items()})
    loss.backward()
    assert abs(float(loss.detach()) - want_loss) <= 1e-4 * abs(want_loss)
    assert float(metrics["t_mean"]) == pytest.approx(float(np.mean(draws["t"])))
    named = steps.named_parameters(guide, den)
    mask = steps.trainable_mask(named, cfg.trainable_substrings)
    assert set(state.trainable) == {n for n, m in mask.items() if m}
    assert set(named) == set(want_grads)
    checked = 0
    largest = max(np.linalg.norm(g) for g in want_grads.values())
    for name, p in named.items():
        if not mask[name]:
            assert p.grad is None and not p.requires_grad, name  # frozen: no gradient buffer
            continue
        want = want_grads[name]
        if np.linalg.norm(want) < 1e-6 * largest:
            # no path to the loss, or one a norm cancels (a bias ahead of a
            # GroupNorm of one channel a group): rounding noise on both sides
            assert p.grad is None or float(p.grad.norm()) < 1e-5 * largest, name
            continue
        assert rel_l2(p.grad.numpy(), want) < 2e-3, name
        checked += 1
    assert checked > (60 if stage == "stage1" else 30)
    if stage == "stage2":
        assert any(not m for m in mask.values())


@pytest.mark.parametrize("stage", ["stage1", "stage2"])
def test_remat_changes_no_result(stage):
    schedule = ddim.DDIMSchedule.create(beta_schedule="scaled_linear")
    cfg = steps.TrainConfig(trainable_substrings=STAGE2 if stage == "stage2" else None)
    out = []
    for remat in (False, True):
        guide, den = port_models(stage, SMALL, remat=remat)
        steps.init_train_state(cfg, guide, den)
        g = torch.Generator().manual_seed(4)
        loss, _ = steps.diffusion_loss(cfg, schedule, guide, den, torch_batch(np_batch(1)), g)
        loss.backward()
        grads = {n: p.grad for n, p in steps.named_parameters(guide, den).items()
                 if p.grad is not None}
        out.append((float(loss.detach()), grads))
    (loss_a, grads_a), (loss_b, grads_b) = out
    assert abs(loss_a - loss_b) <= 1e-6 * abs(loss_a)
    assert grads_a.keys() == grads_b.keys() and grads_a
    for n in grads_a:
        torch.testing.assert_close(grads_b[n], grads_a[n], rtol=1e-5, atol=1e-6, msg=n)


def test_chain_path_is_not_taken_with_remat(monkeypatch):
    from mikudance_tpu_torch.models import layers

    monkeypatch.setattr(layers, "PALLAS_CHAIN", True)
    calls = []
    monkeypatch.setattr(layers.TransformerBlock, "_chain",
                        lambda self, *a: calls.append(1) or a[0])
    x, ctx_kv = torch.randn(1, 16, 32), (torch.randn(1, 5, 32), torch.randn(1, 5, 32))
    layers.TransformerBlock(32, 4)(x, None, ctx_kv=ctx_kv)
    assert calls == [1]
    layers.TransformerBlock(32, 4, remat=True)(x, None, ctx_kv=ctx_kv)
    assert calls == [1]


# --------------------------------------------------------------- optimizer

@pytest.mark.parametrize("kind,accum", [("constant", 2), ("constant_with_warmup", 2),
                                        ("linear", 2), ("cosine", 2), ("cosine", 1)])
def test_optimizer_matches_optax(kind, accum):
    """``make_optimizer`` against the JAX package's (optax) on injected
    gradients whose global norm passes ``max_grad_norm``: three optimizer
    steps, warm-up, decay, accumulation as averaged micro-steps."""
    import optax

    rng = np.random.default_rng(2)
    shapes = {"a.weight": (7, 5), "a.bias": (5,), "b.motion.weight": (3, 4, 2)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    kw = dict(learning_rate=3e-3, lr_scheduler=kind, lr_warmup_steps=2, max_train_steps=5,
              gradient_accumulation_steps=accum, max_grad_norm=1.0, weight_decay=1e-2)
    tx = jsteps.make_optimizer(jsteps.TrainConfig(**kw))
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state = tx.init(jparams)
    tparams = {k: t(v.copy()) for k, v in params.items()}
    opt = steps.make_optimizer(steps.TrainConfig(**kw), tparams)
    fired = []
    for i in range(3 * accum):
        grads = {k: (rng.normal(size=s) * (3.0 if i % 2 else 0.02)).astype(np.float32)
                 for k, s in shapes.items()}
        updates, opt_state = tx.update({k: jnp.asarray(v) for k, v in grads.items()},
                                       opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        fired.append(opt.update({k: t(v) for k, v in grads.items()}))
        for k in shapes:
            np.testing.assert_allclose(tparams[k].numpy(), np.asarray(jparams[k]),
                                       rtol=1e-6, atol=1e-6, err_msg=f"{k} after micro-step {i}")
    assert fired == [(i + 1) % accum == 0 for i in range(3 * accum)]
    assert opt.count == 3


def test_lr_schedules():
    base = 1e-4
    mk = lambda **kw: steps.make_lr_schedule(steps.TrainConfig(learning_rate=base, **kw))  # noqa
    assert mk(lr_scheduler="constant", lr_warmup_steps=100)(0) == base
    cw = mk(lr_scheduler="constant_with_warmup", lr_warmup_steps=100)
    assert cw(0) == 0.0 and abs(cw(50) - base / 2) < 1e-12 and cw(10_000) == base
    lin = mk(lr_scheduler="linear", lr_warmup_steps=100, max_train_steps=1100)
    assert lin(0) == 0.0 and abs(lin(100) - base) < 1e-12 and abs(lin(600) - base / 2) < 1e-12
    assert abs(lin(1100)) < 1e-12
    cos = mk(lr_scheduler="cosine", max_train_steps=1000)
    assert abs(cos(0) - base) < 1e-12 and abs(cos(1000)) < 1e-12
    with pytest.raises(ValueError):
        mk(lr_scheduler="polynomial")


def test_master_copies_keep_the_update_in_fp32():
    """A bf16 module moves by fp32 steps: updates far below one bf16 step
    accumulate in the master copy and show once they add up."""
    p = torch.nn.Parameter(torch.ones(4, dtype=torch.bfloat16))
    cfg = steps.TrainConfig(learning_rate=1e-4, weight_decay=0.0, max_grad_norm=1e9)
    opt = steps.make_optimizer(cfg, {"p": p})
    for _ in range(60):
        opt.update({"p": torch.ones(4, dtype=torch.bfloat16)})
    assert opt.master["p"].dtype == torch.float32
    np.testing.assert_allclose(opt.master["p"].numpy(), 1.0 - 60e-4, rtol=1e-5)
    value = p.detach().float()[0].item()
    assert value == float(torch.tensor(1.0 - 60e-4).bfloat16())
    assert value < 1.0  # one step alone (1e-4) is under half a bf16 step at 1.0


# -------------------------------------------------------- mask and bridge

def test_trainable_mask_picks_the_same_tensors_as_jax():
    guide, den = port_models("stage2")
    nb, lpb = len(TINY.block_out_channels), TINY.layers_per_block
    gsd, dsd = guide.state_dict(), den.state_dict()
    params = convert.train_params_to_jax(gsd, dsd, nb, lpb)
    jmask = jsteps.trainable_mask(params, STAGE2)
    named = steps.named_parameters(guide, den)
    pmask = steps.trainable_mask(named, STAGE2)
    assert convert.trainable_mask_from_jax(jmask, gsd, dsd, nb, lpb) == pmask
    assert convert.trainable_mask_to_jax(pmask, gsd, dsd, nb, lpb) == jmask
    on = [n for n, m in pmask.items() if m]
    assert on and all("motion_modules" in n or "man_blocks" in n for n in on)
    assert all(n.startswith("den.") == ("motion_modules" in n) for n in on)
    assert all(steps.trainable_mask(named, None).values())
    # the bridge round trip: JAX tree -> state_dicts -> the same tensors
    back = convert.train_params_from_jax(params, nb, lpb)
    for net, sd in (("guide", gsd), ("den", dsd)):
        assert back[net].keys() == sd.keys()
        for k, v in sd.items():
            np.testing.assert_array_equal(back[net][k], v.numpy())
    # and the JAX package's own converter agrees with the port's copy
    theirs = jconvert.convert_unet(dsd, nb, lpb, with_motion=True)
    jax.tree_util.tree_map(np.testing.assert_array_equal, theirs, params["den"])


# ---------------------------------------------------------------- the loop

class Loader:
    def __init__(self, n, seen=None):
        self.n, self.seen, self.epochs = n, seen if seen is not None else [], 0

    def __iter__(self):
        self.epochs += 1
        for i in range(self.n):
            self.seen.append(i)
            yield torch_batch(np_batch(i))


def loop(tmp_path, loader, max_steps, stage="stage2", cfg=None, models=None, **kw):
    guide, den = models or port_models(stage, SMALL)
    cfg = cfg or steps.TrainConfig(learning_rate=1e-3, trainable_substrings=STAGE2)
    schedule = ddim.DDIMSchedule.create(beta_schedule="scaled_linear")
    kw = {"checkpointing_steps": 10**6, "log_every": 10**6, **kw}
    return train_loop(cfg=cfg, schedule=schedule, guide=guide, den=den, batches=loader,
                      prepare_batch=lambda b, r: b, max_steps=max_steps,
                      output_dir=str(tmp_path), run_name="test", **kw)


def test_train_loop_counts_optimizer_steps_with_accumulation(tmp_path):
    cfg = steps.TrainConfig(learning_rate=1e-3, gradient_accumulation_steps=2,
                            trainable_substrings=STAGE2)
    loader = Loader(10)
    guide, den = port_models("stage2", SMALL)
    before = {n: p.detach().clone() for n, p in steps.named_parameters(guide, den).items()}
    state = loop(tmp_path, loader, 3, cfg=cfg, models=(guide, den))
    assert len(loader.seen) == 6  # 3 optimizer steps x 2 micro-batches
    assert state.step == 6 and state.optimizer.count == 3
    moved = 0
    for n, p in steps.named_parameters(guide, den).items():
        if n in state.trainable:
            moved += int(not torch.equal(p, before[n]))
        else:
            assert torch.equal(p, before[n]), f"frozen parameter moved: {n}"
    assert moved > 0 and len(state.trainable) < len(before)


def test_train_loop_cycles_epochs_and_exports_at_epoch_ends(tmp_path):
    loader, exports = Loader(2), []
    state = loop(tmp_path, loader, 5, save_model_steps=10**6, save_model_epochs=1,
                 export_fn=lambda s, st: exports.append(s))
    assert state.step == 5 and loader.epochs == 3  # 2 + 2 + 1 batches
    assert exports == [2, 4, 5]  # epochs end at steps 2 and 4; the budget cuts epoch 3 at 5


def test_train_loop_checkpoints_keeps_three_and_resumes(tmp_path):
    state = loop(tmp_path, Loader(8), 5, checkpointing_steps=1, log_every=1)
    ckdir = os.path.join(str(tmp_path), "checkpoints")
    assert sorted(os.listdir(ckdir)) == ["step_3.pt", "step_4.pt", "step_5.pt"]
    lines = [json.loads(x) for x in open(os.path.join(str(tmp_path), "metrics.jsonl"))]
    assert [x["step"] for x in lines] == [1, 2, 3, 4, 5] and np.isfinite(lines[-1]["train_loss"])
    # a fresh run in the same directory picks the newest checkpoint up
    loader = Loader(8)
    resumed = loop(tmp_path, loader, 7, models=port_models("stage2", SMALL, seed=9),
                   checkpointing_steps=10**6)
    assert len(loader.seen) == 2 and resumed.step == 7 and resumed.optimizer.count == 7
    mgr = ckpt.make_manager(ckdir)
    assert mgr.latest_step() == 5
    saved = mgr.restore(5)
    assert saved["step"] == 5 and saved["optimizer"]["count"] == 5
    # resumed from step 5's weights, not from the fresh seed-9 ones
    fresh = port_models("stage2", SMALL, seed=9)[1].state_dict()
    key = next(k for k in saved["den"] if "motion_modules" not in k)
    assert torch.equal(resumed.den.state_dict()[key], saved["den"][key])
    assert not torch.equal(fresh[key], saved["den"][key])
    assert torch.equal(state.den.state_dict()[key], saved["den"][key])  # frozen: never moved


def test_motion_only_export(tmp_path):
    _, den = port_models("stage2", SMALL)
    sd = den.state_dict()
    motion = ckpt.filter_by_substring(sd, ("motion",))
    assert motion and len(motion) < len(sd) and all("motion_modules" in k for k in motion)
    path = os.path.join(str(tmp_path), "out", "motion_module-1.pth")
    ckpt.export_params(motion, path)
    back = ckpt.import_params(path)
    assert back.keys() == motion.keys()
    assert all(torch.equal(back[k], motion[k]) for k in motion)
    fresh = port_models("stage2", SMALL, seed=5)[1]
    missing = fresh.load_state_dict(back, strict=False)
    assert not missing.unexpected_keys and all("motion" not in k for k in missing.missing_keys)


def test_a_step_runs_on_tokens_from_clip_image_tokens():
    """``clip_image_tokens`` runs under ``inference_mode``; what it hands out
    must still be usable as a saved input of a training step."""
    from mikudance_tpu_torch.core.configs import CLIPVisionConfig
    from mikudance_tpu_torch.models.clip_vision import CLIPVisionTower, clip_image_tokens
    from mikudance_tpu_torch.train.runner import make_encoder_fns

    torch.manual_seed(0)
    tower = CLIPVisionTower(CLIPVisionConfig(image_size=28, patch_size=14, hidden_size=64,
                                             intermediate_size=128, num_layers=2, num_heads=4,
                                             projection_dim=768))
    picture = np.random.default_rng(0).integers(0, 256, (40, 40, 3), dtype=np.uint8)
    tokens = clip_image_tokens(tower, picture, device="cpu")
    assert tokens.shape == (1, 5, 768)
    batch = torch_batch(np_batch(0, n=1))
    schedule = ddim.DDIMSchedule.create(beta_schedule="scaled_linear")
    cfg = steps.TrainConfig(learning_rate=1e-3, trainable_substrings=STAGE2)
    guide, den = port_models("stage2", SMALL)
    state = steps.init_train_state(cfg, guide, den)
    step = steps.make_train_step(cfg, schedule, state)
    for ctx in (t(tokens), make_encoder_fns(None, tower).clip_encode(torch.randn(1, 28, 28, 3))):
        assert not ctx.is_inference() and not ctx.requires_grad
        metrics = step({**batch, "clip_ctx": ctx}, torch.Generator().manual_seed(0))
        assert np.isfinite(float(metrics["loss"])) and np.isfinite(metrics["grad_norm"])
    assert state.step == 2


# ------------------------------------------------- the wrappers' backwards

def _grads(fn, ins, cot, which=None):
    live = [None if a is None else t(a).clone().requires_grad_(True) for a in ins]
    out = fn(*live)
    wanted = [x for x in live if x is not None]
    return out.detach().numpy(), [g.numpy() for g in torch.autograd.grad(out, wanted, t(cot))]


def _jax_grads(fn, ins, cot):
    wanted = [i for i, a in enumerate(ins) if a is not None]

    def scalar(*live):
        full = list(ins)
        for i, a in zip(wanted, live):
            full[i] = a
        return jnp.sum(fn(*full) * jnp.asarray(cot))

    got = jax.grad(scalar, argnums=tuple(range(len(wanted))))(
        *[jnp.asarray(ins[i]) for i in wanted])
    return [np.asarray(g) for g in got]


def _wrapper_case(case):
    """(port wrapper, its plain version, the JAX entry in interpret mode,
    inputs as the port takes them, inputs as the JAX entry takes them,
    gradients of the JAX inputs -> the port's layout)."""
    rng = np.random.default_rng(abs(hash(case)) % 1000)
    r = lambda *s, scale=1.0: (rng.normal(size=s) * scale).astype(np.float32)  # noqa: E731
    same = lambda gs: gs  # noqa: E731
    if case in ("K1", "K10", "K11", "K12", "K2", "K4", "K9"):
        heads, C, S, Skv = {"K2": (4, 160, 256, 77), "K4": (1, 128, 256, 256),
                            "K9": (1, 128, 256, 256)}.get(case, (4, 160, 256, 256))
        ins = [r(2, S, C), r(2, Skv, C), r(2, Skv, C)]
        fn = {"K1": pfa.flash_attention_fullc, "K10": pfa.flash_anchor_resident,
              "K11": pfa.flash_anchor_stream, "K12": pfa.flash_attention_fullc_t,
              "K2": pfa.cross_attention, "K4": pfa.flash_attention_wide,
              "K9": pfa.flash_attention_resident}[case]
        return (lambda a, b, c: fn(a, b, c, heads),
                lambda a, b, c: pfa.dot_product_attention(a, b, c, heads),
                lambda a, b, c: jfa.flash_attention(a, b, c, heads, q_block=128, k_block=128,
                                                    interpret=True), ins, ins, same)
    if case == "K3":
        ins = [r(2, 6, 10, 64) for _ in range(3)]
        return (lambda a, b, c: pta.temporal_attention(a, b, c, 4),
                lambda a, b, c: pta.temporal_attention_plain(a, b, c, 4),
                lambda a, b, c: jta.temporal_attention_btpc(a, b, c, 4, 512, True),
                ins, ins, same)
    if case == "K13":
        ins = [r(16, 8, 64) for _ in range(3)]
        return (lambda a, b, c: pta.small_sequence_attention(a, b, c, 4),
                lambda a, b, c: pta.small_sequence_attention_plain(a, b, c, 4),
                lambda a, b, c: jta.temporal_attention_fused(a, b, c, 4, 128, True),
                ins, ins, same)
    if case == "K5":
        ins = [r(2, 8, 8, 64), r(64), r(64)]
        return (lambda x, s, b: pgn.fused_group_norm(x, s, b, 8, 1e-5, True),
                lambda x, s, b: pgn.group_norm_plain(x, s, b, 8, 1e-5, True),
                lambda x, s, b: jgn.fused_group_norm(x, s, b, 8, 1e-5, "silu", True),
                ins, ins, same)
    if case == "K6":
        ins = [r(2, 24, 64), r(64), r(64)]
        return (lambda x, s, b: pln.fused_layer_norm(x, s, b, 1e-5),
                lambda x, s, b: pln.layer_norm_plain(x, s, b, 1e-5),
                lambda x, s, b: jln.fused_layer_norm(x, s, b, 1e-5, True), ins, ins, same)
    if case.startswith("K7"):
        x, wt = r(64, 320), r(128, 320, scale=0.05)
        b = r(128) if "bias" in case else None
        res = r(64, 128) if "residual" in case else None
        flip = lambda gs: [gs[0], gs[1].T] + gs[2:]  # noqa: E731 - (Cin, Cout) -> (Cout, Cin)
        return (plin.fused_linear, plin.linear_plain,
                lambda x, w, b, res: jlinear.fused_linear(x, w, b, res, True),
                [x, wt, b, res], [x, wt.T.copy(), b, res], flip)
    assert case == "K8"
    x, wt, b = r(2, 8, 8, 32), r(16, 32, 3, 3, scale=0.05), r(16)
    flip = lambda gs: [gs[0], gs[1].transpose(3, 2, 0, 1), gs[2]]  # noqa: E731 - HWIO -> OIHW
    return (pcv.conv3x3_fused, pcv.conv3x3_plain,
            lambda x, w, b: jconv2d.conv3x3_fused(x, w, b, True),
            [x, wt, b], [x, wt.transpose(2, 3, 1, 0).copy(), b], flip)


@pytest.mark.parametrize("case", ["K1", "K2", "K3", "K4", "K5", "K6", "K7-bias-residual",
                                  "K7-bare", "K8", "K9", "K10", "K11", "K12", "K13"])
def test_wrapper_backward_matches_plain_and_jax(case):
    """On the CPU in fp32: the wrapper's own backward (chunked recompute for
    the flash family, the plain version's vjp for the rest) against autograd
    straight through the plain math (1e-4) and against ``jax.grad`` of the JAX
    entry, run as the JAX package's tests run it (interpret mode; 2e-3: its
    forward goes through bf16 products in places)."""
    fn, plain, jfn, ins, jins, to_port = _wrapper_case(case)
    out = plain(*[None if a is None else t(a) for a in ins])
    cot = np.random.default_rng(5).normal(size=tuple(out.shape)).astype(np.float32)
    got_out, got = _grads(fn, ins, cot)
    want_out, want = _grads(plain, ins, cot)
    # forward: the anchored function, not the softmax
    anchored = case in ("K1", "K10", "K11", "K12")
    np.testing.assert_allclose(got_out, want_out if not anchored else got_out, atol=1e-5)
    assert len(got) == len(want) == sum(a is not None for a in ins)
    for a, b in zip(got, want):
        assert a.shape == b.shape and rel_l2(a, b) < 1e-4
    for a, b in zip(got, to_port(_jax_grads(jfn, jins, cot))):
        assert a.shape == b.shape and rel_l2(a, b) < 2e-3


def test_flash_backward_is_chunked_and_honours_needs():
    rng = np.random.default_rng(0)
    q, k, v, g = (t(rng.normal(size=(1, 320, 64)).astype(np.float32)) for _ in range(4))
    assert _autograd.bwd_chunk(320) == 160 and _autograd.bwd_chunk(5184) == 144
    assert _autograd.bwd_chunk(1296) == 144 and _autograd.bwd_chunk(257) == 257
    dq, dk, dv = _autograd.flash_backward(q, k, v, g, 4)
    only_q = _autograd.flash_backward(q, k, v, g, 4, (True, False, False))
    assert only_q[1] is None and only_q[2] is None and torch.equal(only_q[0], dq)
    only_v = _autograd.flash_backward(q, k, v, g, 4, (False, False, True))
    assert only_v[0] is None and torch.equal(only_v[2], dv)
    # a frozen projection upstream: k asks for no gradient and gets no buffer
    ql, kl, vl = q.clone().requires_grad_(), k.clone(), v.clone().requires_grad_()
    pfa.flash_attention_fullc(ql, kl, vl, 4).backward(g)
    assert kl.grad is None and torch.allclose(ql.grad, dq) and torch.allclose(vl.grad, dv)
    # nothing requires a gradient: the forward alone, nothing recorded
    assert pfa.flash_attention_fullc(q, k, v, 4).grad_fn is None
    with torch.no_grad():
        assert pfa.flash_attention_fullc(ql, kl, vl, 4).grad_fn is None


# -------------------------------------------------------- K12's plain version

@pytest.mark.parametrize("hd,heads,q_scale", [(40, 4, 1.0), (80, 2, 1.0), (40, 3, 1.0),
                                              (40, 4, 3.0), (80, 2, 3.0)])
def test_k12_plain_matches_pallas_fullc_t(hd, heads, q_scale):
    """``flash_attention_fullc_t(..., interpret=True)`` as
    tests/test_flash_attention.py runs it. With q three times as large the
    clamp bites; there the bf16-rounded anchor clips other scores than the
    fp32 anchor of K10 / K11, and K12's plain version follows its own kernel."""
    Bq, S, C = 1, 256, hd * heads
    rng = np.random.default_rng(hd + heads)
    q, k, v = (rng.normal(size=(Bq, S, C)).astype(np.float32) for _ in range(3))
    q *= q_scale
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = np.asarray(jfa.flash_attention_fullc_t(jq, jk, jv, heads, 1.0 / np.sqrt(hd),
                                                  q_block=128, k_block=128, interpret=True)
                      .astype(jnp.float32))
    tq, tk, tv = (t(a).to(torch.bfloat16) for a in (q, k, v))
    got = pfa.flash_attention_fullc_t(tq, tk, tv, heads)
    assert got.dtype == torch.bfloat16 and got.shape == (Bq, S, C)
    np.testing.assert_allclose(got.float().numpy(), want, atol=2e-2, rtol=2e-2)
    mine = rel_l2(got.float().numpy(), want)
    other = pfa.anchored_attention(tq, tk, tv, heads).float().numpy()
    exact = pfa.dot_product_attention(tq, tk, tv, heads).float()
    if q_scale == 1.0:  # the clamp idle: all three are the softmax
        assert pfa.anchor_excursion(tq, tk, heads) < pfa.EXP_CLAMP
        torch.testing.assert_close(got.float(), exact, atol=2e-2, rtol=2e-2)
    else:
        assert pfa.anchor_excursion(tq, tk, heads) > pfa.EXP_CLAMP
        assert (got.float() - exact).abs().max() > 0.5
        # K10 / K11's plain version is further from the _t kernel than K12's
        assert rel_l2(other, want) > 2 * mine and rel_l2(other, got.float().numpy()) > 0


# ------------------------------------------------------- trainers, datasets

def _write_yaml(path, text):
    with open(path, "w") as f:
        f.write(text)
    return str(path)


TINY_YAML = """
data: {{train_bs: {bs}, train_width: 64, n_sample_frames: 2}}
solver: {{mixed_precision: "no", learning_rate: 1.0e-4, gradient_checkpointing: {remat}}}
noise_scheduler_kwargs: {{beta_schedule: "scaled_linear"}}
unet_overrides: {{block_out_channels: [32, 64], attention_heads: 4}}
output_dir: {out}
checkpointing_steps: 2
save_model_step_interval: 2
log_every: 1
"""


@pytest.fixture
def tiny_encoders(monkeypatch):
    """The trainers with a tiny VAE and CLIP tower in place of the full-width
    ones (random init either way: no files here)."""
    from mikudance_tpu_torch.core import configs as pcfg
    from mikudance_tpu_torch.core import loaders

    vae_cfg = pcfg.VAEConfig(block_out_channels=(16, 32, 32, 32), norm_num_groups=8)
    clip_cfg = pcfg.CLIPVisionConfig(image_size=224, patch_size=56, hidden_size=64,
                                     intermediate_size=128, num_layers=1, num_heads=4,
                                     projection_dim=768)
    load_vae, load_clip = loaders.load_vae, loaders.load_clip
    monkeypatch.setattr(loaders, "load_vae", lambda p, **kw: load_vae(p, config=vae_cfg, **kw))
    monkeypatch.setattr(loaders, "load_clip", lambda p, **kw: load_clip(p, config=clip_cfg, **kw))


@pytest.mark.parametrize("stage", ["stage1", "stage2"])
def test_trainer_main_synthetic_on_the_cpu(stage, tmp_path, tiny_encoders):
    from mikudance_tpu_torch.scripts import train_stage1, train_stage2

    main = {"stage1": train_stage1.main, "stage2": train_stage2.main}[stage]
    cfg = _write_yaml(tmp_path / "cfg.yaml", TINY_YAML.format(
        bs=2 if stage == "stage1" else 1, remat="true", out=tmp_path))
    state = main(["--config", cfg, "--synthetic", "4", "--max_steps", "2", "--device", "cpu"])
    assert state.step == 2 and state.optimizer.count == 2
    out = tmp_path / f"train_{stage}_mikudance"
    files = sorted(os.listdir(out))
    assert "metrics.jsonl" in files and os.listdir(out / "checkpoints") == ["step_2.pt"]
    assert "reference_unet-2.pth" in files and "denoising_unet-2.pth" in files
    losses = [json.loads(x)["train_loss"] for x in open(out / "metrics.jsonl")]
    assert len(losses) == 2 and all(np.isfinite(x) for x in losses)
    if stage == "stage2":
        motion = ckpt.import_params(str(out / "motion_module-2.pth"))
        assert motion and all("motion_modules" in k for k in motion)
        assert set(state.trainable) == {
            n for n in steps.named_parameters(state.guide, state.den)
            if "motion" in n or "man_" in n}
    with pytest.raises(RuntimeError, match="CUDA"):  # the device rule: the card by default
        if torch.cuda.is_available():
            raise RuntimeError("CUDA present")
        main(["--config", cfg, "--synthetic", "1", "--max_steps", "1"])


def _synthetic_files(root, frames=5, size=40):
    from PIL import Image

    rng = np.random.default_rng(0)

    def png(name):
        path = os.path.join(root, name)
        Image.fromarray(rng.integers(0, 256, (size, size + 8, 3), dtype=np.uint8)).save(path)
        return path

    img = dict(ref_image=png("ref.png"), ref_skel=png("skel.png"), tgt_image=png("tgt.png"),
               tgt_pose=png("pose.png"), tgt_face=png("face.png"), tgt_hand=None)
    np.save(os.path.join(root, "depth.npy"), rng.uniform(0.5, 2, (size, size)).astype(np.float32))
    cams = np.tile(np.eye(4, dtype=np.float32)[None], (frames, 1, 1))
    cams[:, 0, 3] = np.linspace(0, 0.3, frames)
    np.save(os.path.join(root, "w2c.npy"), cams)
    np.save(os.path.join(root, "c2w.npy"), np.linalg.inv(cams))
    vid = dict(ref_image=img["ref_image"], ref_skel=img["ref_skel"],
               ref_depth=os.path.join(root, "depth.npy"),
               frames=[png(f"f{i}.png") for i in range(frames)],
               poses=[png(f"p{i}.png") for i in range(frames)],
               faces=[png(f"a{i}.png") for i in range(frames)], hands=None,
               w2c=os.path.join(root, "w2c.npy"), c2w=os.path.join(root, "c2w.npy"))
    return img, vid


def test_datasets_match_the_jax_package(tmp_path):
    from mikudance_tpu.data import datasets as jds
    from mikudance_tpu_torch.data import datasets as pds

    img, vid = _synthetic_files(str(tmp_path))
    for seed in (0, 1):
        a = jds.sample_crop(random.Random(seed), (0.8, 1.0), (0.9, 1.1))
        b = pds.sample_crop(random.Random(seed), (0.8, 1.0), (0.9, 1.1))
        assert (a.top, a.left, a.height, a.width) == (b.top, b.left, b.height, b.width)
    mine = pds.AnimeImageDataset([pds.ImageSample(**img)], img_size=(32, 32),
                                 img_scale=(0.8, 1.0), seed=3)
    theirs = jds.AnimeImageDataset([jds.ImageSample(**img)], img_size=(32, 32),
                                   img_scale=(0.8, 1.0), seed=3)
    for _ in range(3):
        a, b = mine[0], theirs[0]
        assert a.keys() == b.keys()
        for key in a:
            np.testing.assert_allclose(a[key], b[key], atol=1e-6, err_msg=key)
    assert a["tgt_img"].shape == (32, 32, 3) and not a["tgt_hand_img"].any()
    kw = dict(img_size=(32, 32), n_sample_frames=3, sample_rate=2, seed=4)
    mine = pds.AnimeVideoDataset([pds.VideoSample(**vid)], **kw)
    theirs = jds.AnimeVideoDataset([jds.VideoSample(**vid)], **kw)
    for _ in range(3):
        a, b = mine[0], theirs[0]
        assert a.keys() == b.keys()
        for key in a:
            np.testing.assert_allclose(a[key], b[key], atol=1e-5, err_msg=key)
    assert a["tgt_vdo"].shape == (3, 32, 32, 3) and a["scene_motion"].shape == (3, 4, 4, 2)
    batches = list(pds.PrefetchLoader(pds.AnimeImageDataset(
        [pds.ImageSample(**img)] * 5, img_size=(32, 32)), batch_size=2))
    assert len(batches) == 2 and batches[0]["ref_img"].shape == (2, 32, 32, 3)
