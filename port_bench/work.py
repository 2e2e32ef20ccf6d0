"""The work a request or a step needs, from the configuration's shapes alone.

- ``serve_model_flops``, ``train_model_flops``: the products' operations
  (matrix products, convolutions, attention's two products) of the
  reference networks run on the meta device under PyTorch's FLOP counter, at
  the shapes the program computes: a serving clip's VAE encode of every
  picture it sends (an absent stream is one black frame), the guidance UNet
  once over every (window, position), the denoiser over the CFG batch of
  every window at every step, the decode of every frame; a stage-2 step's
  forward through both UNets and the backward that autograd needs for the
  trainable partition's gradients (the input gradients of every layer the
  loss reaches through a trainable tensor, the weight gradients of the
  trainable tensors only). Remat recompute and batch preparation are not
  counted.
- ``serve_attention_calls``: the attention that the port's kernels compute
  in a clip today, fixed by shape (self-attention at 1024 tokens and more,
  cross-attention of 1024 queries and more against the CLIP tokens, every
  temporal attention, the VAE mid blocks at 1024 tokens and more), each as
  (operations, bytes, calls): 4 B Sq Skv C operations; q, k, v and o read or
  written once in bf16.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

from . import weights as W
from .reference import schedule as sch

FLASH_MIN_TOKENS = 1024  # the kernels' threshold for self- and cross-attention
BF16 = 2


def _count(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return int(fc.get_total_flops())


def _serve_geometry(config: dict, traffic: dict):
    T = traffic["frames"]
    c = config["context"]
    wins = sch.windows(T, c["frames"], c["overlap"], c.get("stride", 1))
    return T, len(wins), len(wins[0]), traffic["height"] // 8, traffic["width"] // 8


def serve_model_flops(config: dict, traffic: dict) -> int:
    """Operations of one clip."""
    T, nw, wf, h, w = _serve_geometry(config, traffic)
    H, Wd = traffic["height"], traffic["width"]
    pictures = 2 + T + (T if traffic["face"] == "drawn" else 1) + \
        (T if traffic["hand"] == "drawn" else 1)
    tokens, ctx_dim = traffic["clip_tokens"], config["unet"]["cross_attention_dim"]
    cin = config["guidance"]["cond_channels"]
    with torch.device("meta"), torch.no_grad():
        nets = W.reference_nets(config, ("vae", "guide", "den"))
        vae, guide, den = nets["vae"], nets["guide"], nets["den"]
        enc = _count(lambda: vae.quant_conv(vae.encoder(torch.empty(1, 3, H, Wd))))
        dec = _count(lambda: vae.decoder(vae.post_quant_conv(torch.empty(1, 4, h, w))))
        P = nw * wf
        g = _count(lambda: guide(torch.empty(P, cin, h, w), torch.zeros(P),
                                 torch.empty(P, tokens, ctx_dim),
                                 motion_map=torch.empty(P, 2, h, w), write=True))
        d = _count(lambda: den(torch.empty(wf, 4, h, w), torch.zeros(1),
                               torch.empty(1, tokens, ctx_dim), T=wf))
    return pictures * enc + g + traffic["steps"] * 2 * nw * d + T * dec


def train_model_flops(config: dict, traffic: dict, trainable=("motion", "man_")) -> int:
    """Operations of one optimizer step's forward and backward."""
    B, T, S = traffic["batch"], traffic["frames"], traffic["size"]
    h = S // 8
    tokens, ctx_dim = 257, config["unet"]["cross_attention_dim"]
    cin = config["guidance"]["cond_channels"]
    with torch.device("meta"):
        nets = W.reference_nets(config, ("guide", "den"))
        guide, den = nets["guide"], nets["den"]
        for m in (guide, den):
            for n, p in m.named_parameters():
                p.requires_grad_(any(s in n for s in trainable))

        def step():
            ctx = torch.empty(B, tokens, ctx_dim)
            _, banks = guide(torch.empty(B * T, cin, h, h), torch.zeros(B * T),
                             ctx.repeat_interleave(T, 0), motion_map=torch.empty(B * T, 2, h, h),
                             write=True)
            pred, _ = den(torch.empty(B * T, 4, h, h), torch.zeros(B), ctx, banks=banks, T=T)
            pred.square().mean().backward()
        return _count(step)


def serve_attention_calls(config: dict, traffic: dict) -> List[Tuple[int, int, int]]:
    """(operations, bytes, calls) of a clip's kernel-computed attention."""
    T, nw, wf, h, w = _serve_geometry(config, traffic)
    u = config["unet"]
    ch, layers = u["block_out_channels"], u["layers_per_block"]
    n = len(ch)
    tokens = traffic["clip_tokens"]
    steps = traffic["steps"]
    out: List[Tuple[int, int, int]] = []

    def attn(B, sq, skv, C, calls):
        out.append((4 * B * sq * skv * C, BF16 * B * (2 * sq * C + 2 * skv * C), calls))

    # transformer blocks a UNet forward holds at each level: down (levels
    # 0 .. n-2), mid (level n-1), up (levels n-2 .. 0, one more a level)
    blocks = [0] * n
    for lv in range(n - 1):
        blocks[lv] += layers + layers + 1
    blocks[n - 1] += 1
    # motion modules a denoiser forward holds at each level
    motion = [layers + layers + 1 for _ in range(n)]
    motion[n - 1] += 1
    for lv in range(n):
        S, C = (h >> lv) * (w >> lv), ch[lv]
        for B, calls in ((nw * wf, 1), (2 * nw * wf, steps)):  # guidance once; denoiser
            if S >= FLASH_MIN_TOKENS:
                attn(B, S, S, C, blocks[lv] * calls)
                attn(B, S, tokens, C, blocks[lv] * calls)
        # two temporal attentions a motion module over (2 nw) windows' positions
        seqs = 2 * nw * S
        out.append((4 * seqs * wf * wf * ch[lv], BF16 * 4 * seqs * wf * ch[lv],
                    2 * motion[lv] * steps))
    vae_c = config["vae"]["block_out_channels"][-1]
    if h * w >= FLASH_MIN_TOKENS:
        pictures = 2 + T + (T if traffic["face"] == "drawn" else 1) + \
            (T if traffic["hand"] == "drawn" else 1)
        attn(pictures + T, h * w, h * w, vae_c, 1)
    return out
