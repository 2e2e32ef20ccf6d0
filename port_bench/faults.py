"""Faults planted under a run, for the tests and for the limits' readings:
each a (owner, attribute, replacement) that ``planted`` patches in place of
the program's own for the length of a block.

- ``step_unchanged``: a step returns its state unchanged (serving: the DDIM
  update returns its input; training: the optimizer takes no step);
- ``half_batch``: half of the batch left out, the mean taken over the rest
  (serving: the denoiser runs the uncond half of the CFG batch and its
  prediction stands for both; training: the loss over the first half of the
  clip's frames);
- ``answer_altered``: an answer altered where it is produced (serving: the
  first decoded frame inverted; training: the gradient of the leaf with
  the largest one doubled as the optimizer receives it).

A run on one card has no exchange between chips to leave out.
"""

from __future__ import annotations

import contextlib

import torch


def serve_faults() -> dict:
    from mikudance_tpu_torch.diffusion.ddim import DDIMSchedule
    from mikudance_tpu_torch.models.unet import DenoisingUNet
    from mikudance_tpu_torch.pipelines.video import VideoPipeline

    def unchanged(self, model_output, timestep, prev_timestep, sample):
        return sample.float()

    den_forward = DenoisingUNet.forward

    def half_batch(self, x, *args, **kw):
        # the uncond half alone, its prediction standing in for the whole CFG batch
        n, f = x.shape[0] // 2, x.shape[1]
        kw = dict(kw)
        kw["banks_kv"] = {k: (a[:n * f], b[:n * f]) for k, (a, b) in kw["banks_kv"].items()}
        kw["ctx_kv"] = {k: (a[:n], b[:n]) for k, (a, b) in kw["ctx_kv"].items()}
        out = den_forward(self, x[:n], args[0][:n], *args[1:], **kw)
        return torch.cat([out, out])

    decode = VideoPipeline._decode

    def altered(self, latents, mesh=None):
        out = decode(self, latents, mesh)
        out[0] = 255 - out[0]
        return out

    return {"step_unchanged": (DDIMSchedule, "step", unchanged),
            "half_batch": (DenoisingUNet, "forward", half_batch),
            "answer_altered": (VideoPipeline, "_decode", altered)}


def train_faults() -> dict:
    from mikudance_tpu_torch.train import steps

    update = steps.Optimizer.update

    def unchanged(self, grads):
        self.count += 1
        return True

    loss = steps.diffusion_loss

    def half_batch(cfg, schedule, guide, den, batch, generator=None, draws=None, mesh=None):
        n = batch["latents"].shape[1] // 2
        batch = {k: (v[:, :n] if v.dim() == 5 else v) for k, v in batch.items()}
        draws = dict(draws, noise=draws["noise"][:, :n])
        return loss(cfg, schedule, guide, den, batch, generator, draws, mesh)

    def altered(self, grads):
        top = max(grads, key=lambda k: float(grads[k].float().norm()))
        return update(self, {k: (g * 2 if k == top else g) for k, g in grads.items()})

    return {"step_unchanged": (steps.Optimizer, "update", unchanged),
            "half_batch": (steps, "diffusion_loss", half_batch),
            "answer_altered": (steps.Optimizer, "update", altered)}


FAULTS = {"serve": serve_faults, "train": train_faults}


@contextlib.contextmanager
def planted(kind: str, fault: str):
    """The program with ``fault`` (of ``FAULTS[kind]``) in place for the block."""
    owner, attr, fn = FAULTS[kind]()[fault]
    saved = owner.__dict__[attr]
    setattr(owner, attr, fn)
    try:
        yield
    finally:
        setattr(owner, attr, saved)
