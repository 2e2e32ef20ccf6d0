"""The reference's stage-2 training step (MikuDance ``train_stage2.py``),
in plain PyTorch on the reference networks, fp32:

batch preparation (the VAE's latent sample of the target clip, drawn with
the encoder noise the program's generator gives, the latent means of the
pose, face, hand, reference and skeleton pictures, the CLIP tower's tokens);
the v-prediction loss on a zero-terminal-SNR schedule with the noise offset
and min-SNR-gamma weights, a dropped condition zeroing the CLIP tokens and
the banks; the gradients of the motion modules and the MAN blocks; AdamW
after a clip of the global norm, with optax's formulas (the clip divides by
the norm where it passes the limit; the learning rate constant), on fp32
masters of the trainable tensors.

The configuration computes in its ``dtype`` from those masters: a trainable
weight as a product sees it is its master rounded to that type, as a bf16
module holding the rounded masters has it (and as flax casts fp32 parameters
at use). So the reference's networks hold the masters rounded to the
configuration's type, in fp32, and compute in fp32. An update of lr = 1e-5
lies under half a bf16 step of most weights and leaves their computed value
where it was until the master has moved that far; fp32 compute weights would
take every update at once, and the later steps' losses and gradients would
then follow another model.
"""

from __future__ import annotations

import torch

from .. import traffic, weights
from . import schedule as sch
from . import twins

PARTS = ("vae", "guide", "den", "clip")


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.movedim(-1, -3)


def prepare(nets: dict, host: dict, gen: torch.Generator, scale: float, device) -> dict:
    """The prepared batch, channels first: latents (B, T, 4, h, w), cond20
    (B, T, 20, h, w), motion (B, T, 2, h, w), ctx (B, S, 768), uncond."""
    vae, clip = nets["vae"], nets["clip"]
    b = host["batch"]
    B, T = b["tgt_vdo"].shape[:2]

    def dev(k):
        return torch.from_numpy(b[k]).to(device)

    def moments(x):  # (N, H, W, 3) -> (N, 8, h, w)
        x = _nchw(x)
        return torch.cat([vae.quant_conv(vae.encoder(x[i:i + 4])) for i in range(0, len(x), 4)])

    def mean(x):
        return moments(x)[:, :4] * scale

    m = moments(dev("tgt_vdo").flatten(0, 1))
    eps = torch.randn((B * T,) + tuple(m.shape[2:]) + (4,), generator=gen, device=device,
                      dtype=torch.float32)
    lat = (m[:, :4] + torch.exp(0.5 * m[:, 4:].clamp(-30.0, 20.0)) * _nchw(eps)) * scale
    pose, face, hand = (mean(dev(k).flatten(0, 1)).unflatten(0, (B, T))
                        for k in ("tgt_pose", "tgt_face", "tgt_hand"))
    rs = mean(torch.cat([dev("ref_img"), dev("ref_skel_img")]))
    ref_rep = rs[:B, None].expand(B, T, -1, -1, -1)
    skel_rep = rs[B:, None].expand(B, T, -1, -1, -1)
    return {
        "latents": lat.unflatten(0, (B, T)),
        "cond20": torch.cat([ref_rep, skel_rep, pose, face, hand], dim=2),
        "motion": _nchw(dev("scene_motion")),
        "ctx": clip(dev("clip_img")),
        "uncond": host["uncond"],
    }


def loss_of(nets: dict, batch: dict, draws: dict, tr: dict, ac) -> torch.Tensor:
    """The weighted v-prediction loss of one prepared batch."""
    guide, den = nets["guide"], nets["den"]
    x0 = batch["latents"]
    B, T = x0.shape[:2]
    noise = _nchw(draws["noise"]) + tr["noise_offset"] * _nchw(draws["offset"])
    t = draws["t"]
    a = torch.tensor([float(ac[int(s)]) for s in t], device=x0.device).view(B, 1, 1, 1, 1)
    noisy = a.sqrt() * x0 + (1 - a).sqrt() * noise
    target = a.sqrt() * noise - (1 - a).sqrt() * x0
    keep = 1.0 - batch["uncond"]
    ctx = batch["ctx"] * keep
    _, banks = guide(batch["cond20"].flatten(0, 1), torch.zeros(B * T, device=x0.device),
                     ctx.repeat_interleave(T, 0), motion_map=batch["motion"].flatten(0, 1),
                     write=True)
    banks = {k: v * keep for k, v in banks.items()}
    pred, _ = den(noisy.flatten(0, 1), t.float(), ctx, banks=banks, T=T)
    se = (pred.unflatten(0, (B, T)) - target).square().flatten(1).mean(dim=1)
    w = torch.tensor([sch.min_snr_weight(ac, int(s), tr["snr_gamma"]) for s in t],
                     device=x0.device)
    return (se * w).mean()


def run(config: dict, traffic_: dict, seed: int, steps: int, gen_state, device,
        control: bool = False) -> dict:
    """``steps`` optimizer steps on batches 0 .. steps - 1: {"losses",
    "first_grad" (each leaf's norm of the clipped first gradient),
    "change" (each leaf's norm of its change over the steps)}; leaves named
    as the program's optimizer names them."""
    tr = config["train"]
    made = weights.make(config, PARTS, seed, device,
                        {"bfloat16": torch.bfloat16, "float32": torch.float32}[config["dtype"]])
    with torch.device(device):
        nets = weights.reference_nets(config, PARTS)
    for p, net in nets.items():
        net.load_state_dict({k: v.float() for k, v in made[p].items()}, strict=True)
        net.requires_grad_(False)
    del made
    params = {f"{part}.{n}": p for part in ("guide", "den")
              for n, p in nets[part].named_parameters()
              if any(s in n for s in tr["trainable"])}
    for p in params.values():
        p.requires_grad_(True)
    master = {k: v.detach().clone() for k, v in params.items()}
    if control:
        for net in nets.values():
            twins.fp8_products(net)
    nets["guide"].remat = nets["den"].remat = True
    p0 = {k: v.clone() for k, v in master.items()}
    mu = {k: torch.zeros_like(v) for k, v in master.items()}
    nu = {k: torch.zeros_like(v) for k, v in master.items()}
    compute = {"bfloat16": torch.bfloat16, "float32": torch.float32}[config["dtype"]]
    gen = torch.Generator(device=device)
    gen.set_state(gen_state)
    ac = sch.alphas_cumprod(config["scheduler"])
    scale = float(config["vae"]["scaling_factor"])
    losses, first = [], None
    b1, b2, eps = tr["adam_b1"], tr["adam_b2"], tr["adam_eps"]
    for k in range(steps):
        host = traffic.train_batch(traffic_, seed, k)
        draws = {n: torch.from_numpy(v).to(device) for n, v in host["draws"].items()}
        with torch.no_grad():
            batch = prepare(nets, host, gen, scale, device)
        loss = loss_of(nets, batch, draws, tr, ac)
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        losses.append(float(loss.detach()))
        with torch.no_grad():
            norm = float(torch.sqrt(sum(g.square().sum() for g in grads.values())))
            if norm >= tr["max_grad_norm"]:
                grads = {n: g * (tr["max_grad_norm"] / norm) for n, g in grads.items()}
            if k == 0:
                first = {n: float(g.norm()) for n, g in grads.items()}
            for n, m in master.items():
                g = grads[n]
                mu[n].mul_(b1).add_(g, alpha=1 - b1)
                nu[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                upd = (mu[n] / (1 - b1 ** (k + 1))) / ((nu[n] / (1 - b2 ** (k + 1))).sqrt() + eps)
                m.sub_(tr["learning_rate"] * (upd + tr["weight_decay"] * m))
                params[n].copy_(m.to(compute))
        del grads, batch, loss
    change = {n: float((m - p0[n]).norm()) for n, m in master.items()}
    return {"losses": losses, "first_grad": first, "change": change}
