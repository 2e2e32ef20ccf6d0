"""The port's multi-rank training on gloo ranks, against itself and JAX.

Ranks are processes spawned by ``core.mesh.spawn`` on the CPU (gloo, one
thread each); their bodies live in the torch-only
``_torch_sharded_train_ranks.py``. The UNets are ``tests/test_train_step_sp.py``'s
tiny ones; the batches and the random draws are made here, globally, with
numpy, and every rank keeps its slice.

- the motion module's gradients with its frames split over 4 ranks, on the
  ``all_to_all`` path and on the gather path, against the unsharded backward
  (2e-4); without the collectives' backward (the control) they are wrong;
  ``psum``'s backward;
- the sequence-parallel step on (data 2 x frame 2), remat on, both trainable
  sets, against the port's one-rank step and, for the stage-2 set, JAX's
  ``make_train_step`` on one device with the same draws: loss rtol 1e-5,
  parameters rtol 2e-5 with atol 2 x lr (``test_train_step_sp.py``'s limits:
  Adam's first update is lr * g / |g|, so a weight whose gradient is rounding
  noise may move by lr either way, and a gradient of any scale passes them),
  and Adam's first moment, which holds the gradient itself
  (``assert_moments_close``);
- the ZeRO step on 2 ranks against the replicated one (same limits; the
  UNets of ``tests/test_zero_sharding.py``), its
  optimizer state at most 0.55x the replicated bytes a rank, a checkpoint
  written under ZeRO holding the whole state and resumed on one rank;
- ``zero_shard_plan`` against the JAX ``zero_shard_state`` specs, leaf by leaf;
- ``train_stage2`` under ``torchrun`` on 2 CPU ranks (a frame mesh): rank 0
  alone writes the metrics and the checkpoints, both ranks end with the same
  weights, and the losses are the one-process trainer's.

``slow``: the SP step against JAX's sharded step on the conftest's 8 CPU
devices, ZeRO on 4 ranks with accumulation, ``graft_entry.dryrun_multichip(4,
"cpu")`` and ``graft_entry.entry("cpu")``.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_sharded_train_ranks as ranks
from mikudance_tpu.core import mesh as jmesh
from mikudance_tpu.diffusion import ddim as jddim
from mikudance_tpu.models import unet as junet
from mikudance_tpu.train import steps as jsteps
from mikudance_tpu_torch.core import convert
from mikudance_tpu_torch.core import mesh
from mikudance_tpu_torch.core.configs import (DenoisingUNetConfig, GuidanceUNetConfig,
                                              MotionModuleConfig)
from mikudance_tpu_torch.models import motion_module, unet
from mikudance_tpu_torch.train import checkpoint as ckpt

LR = 1e-5
B, T, h, w = 2, 4, 8, 8


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def seeded(module: torch.nn.Module, seed: int) -> torch.nn.Module:
    """PyTorch's init under a seed, every all-zero tensor refilled (the
    motion modules' zero-init ``proj_out`` would hide their attention)."""
    torch.manual_seed(seed)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for p in module.parameters():
            if not p.any():
                p.copy_(torch.from_numpy(rng.normal(0, 0.05, p.shape).astype(np.float32)))
    return module


def numpy_state(module: torch.nn.Module) -> dict:
    return {k: v.detach().cpu().numpy() for k, v in module.state_dict().items()}


def unet_states(stage2: bool = True, u=ranks.TINY) -> dict:
    torch.manual_seed(0)
    guide = seeded(unet.GuidanceUNet(GuidanceUNetConfig(unet=u, use_man=stage2)), 0)
    den = seeded(unet.DenoisingUNet(DenoisingUNetConfig(
        unet=u, motion=MotionModuleConfig(enabled=stage2, num_attention_heads=4))), 1)
    return {"guide": numpy_state(guide), "den": numpy_state(den)}


def np_batch(n: int, frames: int, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    uncond = np.zeros(n, np.float32)
    uncond[1::2] = 1.0  # every other sample drops its conditioning
    return {
        "latents": rng.normal(size=(n, frames, h, w, 4)).astype(np.float32),
        "cond20": rng.normal(size=(n, frames, h, w, 20)).astype(np.float32),
        "motion": rng.normal(size=(n, frames, h, w, 2)).astype(np.float32),
        "clip_ctx": rng.normal(size=(n, 5, 768)).astype(np.float32),
        "uncond": uncond,
    }


def jax_draws(key, shape, schedule) -> dict:
    """The draws ``mikudance_tpu.train.steps.diffusion_loss`` makes from ``key``."""
    r_noise, r_off, r_t = jax.random.split(key, 3)
    return {
        "noise": np.asarray(jax.random.normal(r_noise, shape, jnp.float32)),
        "offset": np.asarray(jax.random.normal(r_off, (shape[0], 1, 1, 1, shape[-1]),
                                               jnp.float32)),
        "t": np.asarray(jax.random.randint(r_t, (shape[0],), 0, schedule.num_train_timesteps)),
    }


def adam_mu(opt_state):
    """The first moment of the optax adam state inside ``opt_state``."""
    if hasattr(opt_state, "mu"):
        return opt_state.mu
    if isinstance(opt_state, (tuple, list)):
        for inner in opt_state:
            mu = adam_mu(inner)
            if mu is not None:
                return mu
    return None


def assert_params_close(got: dict, want: dict, lr: float, what: str) -> None:
    assert got.keys() == want.keys() and got, what
    for n in want:
        np.testing.assert_allclose(got[n], want[n], rtol=2e-5, atol=2 * lr,
                                   err_msg=f"{what}: {n}")


def assert_moments_close(got: dict, want: dict, what: str) -> None:
    """Adam's first moment after one step, (1 - b1) times the clipped summed
    gradient: unlike the first update, lr g / (|g| + eps), it keeps the
    gradient's scale and sign, so a wrong gradient fails it. Each leaf
    within 1e-3 of its largest |value| (the leaves read up to 3.7e-4), plus
    1e-4 of the largest of all (leaves whose gradient is zero but for
    rounding, ~1e-11, carry no signal); all of it by relative L2 1e-3
    (read 5e-5 to 1.4e-4)."""
    assert got.keys() == want.keys() and got, what
    top = max(float(np.abs(v).max()) for v in want.values())
    for n in want:
        atol = 1e-3 * float(np.abs(want[n]).max()) + 1e-4 * top
        np.testing.assert_allclose(got[n], want[n], rtol=0, atol=atol, err_msg=f"{what}: {n}")
    dist = sum(float(np.sum((got[n] - want[n]).astype(np.float64) ** 2)) for n in want)
    norm = sum(float(np.sum(want[n].astype(np.float64) ** 2)) for n in want)
    assert np.sqrt(dist / norm) < 1e-3, f"{what}: relative L2 {np.sqrt(dist / norm):.2e}"


# ------------------------------------------------------------ motion module

@pytest.fixture(scope="module")
def motion_grads():
    """One spawn: two inputs of 8 frames through the module on 4 ranks, each
    with a cotangent, with and without the collectives' backward; the
    unsharded backward of each here."""
    m = seeded(motion_module.MotionModule(64, 4), 5)
    rng = np.random.default_rng(5)
    inputs = [rng.normal(size=(2, 8, 4, 4, 64)).astype(np.float32),  # 16 positions: all_to_all
              rng.normal(size=(1, 8, 3, 3, 64)).astype(np.float32)]  # 9 positions: gather
    cots = [rng.normal(size=x.shape).astype(np.float32) for x in inputs]
    want = []
    for x, cot in zip(inputs, cots):
        m.zero_grad(set_to_none=True)
        xt = torch.from_numpy(x).requires_grad_(True)
        (m(xt) * torch.from_numpy(cot)).sum().backward()
        want.append((xt.grad.numpy(), {n: p.grad.numpy() for n, p in m.named_parameters()}))
    got = mesh.spawn(4, ranks.motion_module_grads, (64, 4, numpy_state(m), inputs, cots, False))
    return want, got


@pytest.mark.parametrize("case,path", [(0, "all_to_all"), (1, "all_gather")])
def test_motion_module_gradients_sharded_match_unsharded(motion_grads, case, path):
    want, got = motion_grads
    x_grad = np.concatenate([sharded[case][0] for sharded, _, _ in got], axis=1)
    err = float(np.abs(x_grad - want[case][0]).max())
    assert err < 2e-4, f"{path}: input gradient, max abs err {err:.2e}"
    worst = 0.0
    for n, g in want[case][1].items():  # the ranks' parameter gradients, summed
        summed = sum(sharded[case][1][n] for sharded, _, _ in got)
        worst = max(worst, float(np.abs(summed - g).max() / max(np.abs(g).max(), 1e-30)))
    assert worst < 2e-4, f"{path}: parameter gradients, worst relative err {worst:.2e}"
    # the control: the forward without its backward cuts the graph
    controls = [control[case] for _, control, _ in got]
    summed = sum(c[1]["temporal_transformer.proj_in.weight"] for c in controls)
    want_w = want[case][1]["temporal_transformer.proj_in.weight"]
    assert np.abs(summed - want_w).max() > 1e-2 * np.abs(want_w).max()


def test_psum_backward_sums_the_cotangents(motion_grads):
    """The transpose of a psum is a psum: each rank's x gets the sum of every
    rank's cotangent (1 + 2 + 3 + 4)."""
    for _, _, grad in motion_grads[1]:
        np.testing.assert_array_equal(grad, np.full(3, 10.0, np.float32))


# ------------------------------------------------------ sequence parallelism

@pytest.fixture(scope="module")
def sp_setup():
    import mikudance_tpu.core.configs as jcfg

    states = unet_states()
    schedule = jddim.DDIMSchedule.create(beta_schedule="scaled_linear")
    key = jax.random.PRNGKey(7)
    draws = jax_draws(key, (B, T, h, w, 4), schedule)
    return states, np_batch(B, T), draws, key, jcfg


def jax_step(states, batch, key, jcfg, substrings, mesh_=None):
    """JAX's ``make_train_step`` on the same weights (one device, or
    ``mesh_``): the trainable parameters after the step and Adam's first
    moment, both in the port's names, and the loss."""
    u = jcfg.UNetConfig(block_out_channels=ranks.TINY.block_out_channels, attention_heads=4)
    guide = junet.GuidanceUNet(jcfg.GuidanceUNetConfig(unet=u, use_man=True))
    den = junet.DenoisingUNet(jcfg.DenoisingUNetConfig(
        unet=u, motion=jcfg.MotionModuleConfig(num_attention_heads=4)))
    params = convert.train_params_to_jax(states["guide"], states["den"], 4, 2)
    cfg = jsteps.TrainConfig(trainable_substrings=substrings, learning_rate=LR)
    schedule = jddim.DDIMSchedule.create(beta_schedule="scaled_linear")
    state, tx = jsteps.init_train_state(
        cfg, {"params": jax.tree_util.tree_map(jnp.asarray, params["guide"])},
        {"params": jax.tree_util.tree_map(jnp.asarray, params["den"])})
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    if mesh_ is not None:
        jbatch = jmesh.shard_train_batch(jbatch, mesh_)
        state = jmesh.replicate(state, mesh_)
    new, metrics = jax.jit(jsteps.make_train_step(cfg, schedule, guide, den, tx, mesh=mesh_))(
        state, jbatch, key)
    whole = jax.device_get(new.params)
    # the frozen leaves are None in the moment's tree: zeros in their place
    mu = jsteps._combine(jax.device_get(adam_mu(new.opt_state)),
                         jax.tree_util.tree_map(np.zeros_like, whole))

    def named(tree):
        flat = convert.train_params_from_jax(tree, 4, 2)
        return {f"{net}.{k}": np.asarray(v) for net, sd in flat.items() for k, v in sd.items()}

    return named(whole), named(mu), float(metrics["loss"])


SETS = [None, ranks.STAGE2]


@pytest.fixture(scope="module")
def sp_runs(sp_setup):
    """One spawn of (data 2, frame 2), both trainable sets."""
    states, batch, draws, _, _ = sp_setup
    return mesh.spawn(4, ranks.train_steps, (states, SETS, batch, draws, (2, 2), True))


@pytest.mark.parametrize("case", [0, 1], ids=["stage1-set", "stage2-set"])
def test_sp_step_matches_one_rank_and_jax(sp_setup, sp_runs, case):
    states, batch, draws, key, jcfg = sp_setup
    substrings = SETS[case]
    loss_1, params_1, norm_1, mu_1 = ranks.train_step(states, substrings, batch, draws, (1, 1),
                                                      True)
    got = [per_rank[case] for per_rank in sp_runs]
    for loss, params, norm, _ in got:  # every rank: the global loss, the same step
        np.testing.assert_allclose(loss, loss_1, rtol=1e-5)
        np.testing.assert_allclose(norm, norm_1, rtol=1e-3)
        for n in params:
            np.testing.assert_array_equal(params[n], got[0][1][n], err_msg=n)
    assert_params_close(got[0][1], params_1, LR, "4 ranks against one")
    assert_moments_close(got[0][3], mu_1, "4 ranks against one")
    if substrings is not None:  # one JAX train-step configuration
        want, mu_j, loss_j = jax_step(states, batch, key, jcfg, substrings)
        np.testing.assert_allclose(got[0][0], loss_j, rtol=1e-5)
        assert_params_close(got[0][1], {n: want[n] for n in got[0][1]}, LR, "4 ranks against JAX")
        assert_moments_close(got[0][3], {n: mu_j[n] for n in got[0][3]}, "4 ranks against JAX")


@pytest.mark.slow
def test_sp_step_matches_jax_sharded_step(sp_setup):
    """(data 2, frame 4): JAX's sharded step on the conftest's 8 CPU devices
    and the port's on 8 ranks."""
    states, batch, draws, key, jcfg = sp_setup
    jm = jmesh.choose_train_mesh(jax.devices(), batch=B, frames=T)
    assert dict(jm.shape) == {"data": 2, "frame": 4}
    want, mu_j, loss_j = jax_step(states, batch, key, jcfg, ranks.STAGE2, jm)
    got = mesh.spawn(8, ranks.train_step, (states, ranks.STAGE2, batch, draws, (2, 4), True))
    np.testing.assert_allclose(got[0][0], loss_j, rtol=1e-5)
    assert_params_close(got[0][1], {n: want[n] for n in got[0][1]}, LR, "8 ranks against JAX")
    assert_moments_close(got[0][3], {n: mu_j[n] for n in got[0][3]}, "8 ranks against JAX")


# --------------------------------------------------------------------- ZeRO

def stage1_setup(n: int):
    states = unet_states(stage2=False, u=ranks.ZERO_TINY)
    batch = np_batch(n, 1, seed=3)
    rng = np.random.default_rng(4)
    draws = {"noise": rng.normal(size=(n, 1, h, w, 4)).astype(np.float32),
             "offset": rng.normal(size=(n, 1, 1, 1, 4)).astype(np.float32),
             "t": rng.integers(0, 1000, n)}
    return states, batch, draws


def test_zero_step_matches_replicated_and_resumes_on_one_rank(tmp_path):
    states, batch, draws = stage1_setup(2)
    rep_dir, zero_dir = str(tmp_path / "replicated"), str(tmp_path / "zero")
    runs = mesh.spawn(2, ranks.zero_runs, (states, batch, draws, rep_dir, zero_dir))
    loss_r, params_r, norm_r, bytes_r, plan_r, _ = runs[0]["replicated"]
    for loss, params, norm, nbytes, plan, shapes in (r["zero"] for r in runs):
        np.testing.assert_allclose(loss, loss_r, rtol=1e-6)
        np.testing.assert_allclose(norm, norm_r, rtol=1e-5)  # only the norm's sum order differs
        assert_params_close(params, params_r, 1e-3, "ZeRO against replicated")
        assert nbytes <= 0.55 * bytes_r, (nbytes, bytes_r)
        sharded = [n for n, d in plan.items() if d is not None]
        assert len(sharded) > 0.9 * len(plan)
        for n in sharded:  # half of the leaf along the planned dimension
            assert shapes[n][plan[n]] * 2 == params_r[n].shape[plan[n]], n
    assert all(d is None for d in plan_r.values())
    # the files hold the whole state, equal under ZeRO and replicated
    want = ckpt.make_manager(rep_dir).restore(1)
    saved = ckpt.make_manager(zero_dir).restore(1)
    assert sorted(os.listdir(zero_dir)) == ["step_1.pt"]  # rank 0 alone writes
    for field in ("master", "mu", "nu"):
        for n, v in want["optimizer"][field].items():
            assert saved["optimizer"][field][n].shape == v.shape, n
            torch.testing.assert_close(saved["optimizer"][field][n], v, rtol=1e-5, atol=1e-8)
    # resumed on one rank (no process group): the whole state, then a step
    at, params_1, whole_1 = ranks.resume_step(states, zero_dir, batch, draws, False)
    assert at == 1
    for field in ("master", "mu", "nu"):
        for n, v in saved["optimizer"][field].items():
            np.testing.assert_array_equal(whole_1["restored"][field][n], v.numpy(), err_msg=n)
    # and on two ZeRO ranks: the same step; the state gathers to rank 0 alone
    two = [r["resume"] for r in runs]
    assert two[0][0] == two[1][0] == 1 and two[1][2]["restored"] is None
    for n, v in saved["optimizer"]["master"].items():
        np.testing.assert_array_equal(two[0][2]["restored"]["master"][n], v.numpy(), err_msg=n)
    for r in two:
        assert_params_close(r[1], params_1, 1e-3, "ZeRO resume against one-rank resume")


@pytest.mark.slow
def test_zero_step_on_four_ranks_with_accumulation():
    states, batch, draws = stage1_setup(4)
    rep = mesh.spawn(4, ranks.zero_step, (states, batch, draws, False, "", 2))
    zer = mesh.spawn(4, ranks.zero_step, (states, batch, draws, True, "", 2))
    assert zer[0][3] <= 0.3 * rep[0][3]
    for r in zer:
        np.testing.assert_allclose(r[0], rep[0][0], rtol=1e-6)
        assert_params_close(r[1], rep[0][1], 1e-3, "ZeRO on 4 ranks against replicated")


@pytest.mark.parametrize("n", [2, 8])
def test_zero_shard_plan_matches_jax_specs(n):
    """The rule on every leaf of the JAX tree of both tiny UNets: the
    dimension ``zero_shard_plan`` picks is the one ``zero_shard_state``'s
    ``PartitionSpec`` shards (None where it replicates)."""
    states = unet_states()
    tree = convert.train_params_to_jax(states["guide"], states["den"], 4, 2)
    jm = jmesh.make_mesh(jax.devices()[:n])
    placed = jmesh.zero_shard_state(jax.tree_util.tree_map(np.asarray, tree), jm)
    leaves = jax.tree_util.tree_leaves_with_path(placed)
    flat = {jax.tree_util.keystr(p): leaf for p, leaf in leaves}
    plan = mesh.zero_shard_plan(flat, n)
    sharded = 0
    for name, leaf in flat.items():
        spec = tuple(leaf.sharding.spec)
        want = spec.index("data") if "data" in spec else None
        assert plan[name] == want, (name, leaf.shape, spec)
        sharded += want is not None
    assert sharded > 0
    assert n == 2 or sharded < len(flat)  # over 8, some leaves replicate (no dimension 8 divides)


# ---------------------------------------------------------------- trainers

TINY_YAML = """
data: {{train_bs: 1, train_width: 64, n_sample_frames: 2}}
solver: {{mixed_precision: "no", learning_rate: 1.0e-4, gradient_checkpointing: true}}
noise_scheduler_kwargs: {{beta_schedule: "scaled_linear"}}
unet_overrides: {{block_out_channels: [32, 64], attention_heads: 4}}
output_dir: {out}
checkpointing_steps: 2
save_model_step_interval: 2
log_every: 1
"""


def test_train_stage2_under_torchrun_rank_zero_writes(tmp_path, monkeypatch):
    from mikudance_tpu_torch.scripts import train_stage2

    argv = ["--synthetic", "2", "--max_steps", "2", "--device", "cpu"]
    (tmp_path / "ranks").mkdir()
    (tmp_path / "one").mkdir()
    for where in ("ranks", "one"):
        (tmp_path / where / "cfg.yaml").write_text(TINY_YAML.format(out=tmp_path / where))
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([root, os.environ.get("PYTHONPATH", "")]),
           "OMP_NUM_THREADS": "1"}
    subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                    "--nproc-per-node", "2", ranks.__file__, str(tmp_path / "ranks"),
                    "--config", str(tmp_path / "ranks" / "cfg.yaml")] + argv,
                   env=env, check=True, timeout=600)
    got = [torch.load(tmp_path / "ranks" / f"rank{r}.pt", weights_only=False) for r in range(2)]
    assert all(grouped and count == 2 for _, count, grouped in got)
    for n, v in got[0][0].items():  # 2 frames of the clip a rank, the same step on both
        np.testing.assert_array_equal(got[1][0][n], v, err_msg=n)
    out = tmp_path / "ranks" / "train_stage2_mikudance"
    lines = [json.loads(x) for x in open(out / "metrics.jsonl")]
    assert [x["step"] for x in lines] == [1, 2]  # rank 0 alone logs
    assert os.listdir(out / "checkpoints") == ["step_2.pt"]
    saved = ckpt.make_manager(str(out / "checkpoints")).restore(2)
    assert saved["optimizer"]["count"] == 2 and saved["step"] == 2

    # the one-process trainer on the same request
    ranks.tiny_loaders(monkeypatch.setattr)
    state = train_stage2.main(["--config", str(tmp_path / "one" / "cfg.yaml")] + argv)
    one = [json.loads(x) for x in open(tmp_path / "one" / "train_stage2_mikudance" /
                                         "metrics.jsonl")]
    np.testing.assert_allclose([x["train_loss"] for x in lines],
                               [x["train_loss"] for x in one], rtol=1e-4)
    params_1 = ranks.numpy_params(state)
    assert_params_close(got[0][0], params_1, 1e-4, "2 ranks against one process")


# --------------------------------------------------------------- graft entry

@pytest.mark.slow
def test_dryrun_multichip_on_four_cpu_ranks():
    from mikudance_tpu_torch import graft_entry

    lines = graft_entry.dryrun_multichip(4, device="cpu")
    assert len(lines) == 5 and "sequence-parallel train ok" in lines[1]


@pytest.mark.slow
def test_entry_forward_on_the_cpu():
    from mikudance_tpu_torch import graft_entry

    fn, args = graft_entry.entry(device="cpu")
    out = fn(*args)
    assert out.shape == (1, 4, 64, 64, 4) and out.dtype == torch.bfloat16
    assert bool(torch.isfinite(out.float()).all())
