"""The reference at SDXL's geometry: the two MikuDance UNets as plain PyTorch
twins with SDXL's wiring, and the reference's inference algorithm with
SDXL's added conditioning, with no kernel of the port and no JAX.

The leaf twins (attention, transformer block, resnet, motion module, MAN,
time embedding, the KL autoencoder) are ``_oracle.py``'s; what SDXL adds is
here:

- ``TTransformer2DXL``: diffusers ``Transformer2DModel`` with
  ``use_linear_projection`` (Linear ``proj_in`` / ``proj_out`` after the
  GroupNorm, on tokens) or 1x1 convs, and ``depth`` blocks
  (``transformer_blocks.0..depth-1``), each writing and reading its own bank;
- ``TUNetXL``: ``UNet2DConditionModel``'s wiring with spatial attention at
  the levels named (SDXL: not level 0), heads and depth by level, the mid
  block's own depth, motion modules (``motion_heads`` heads) at the levels
  named and optionally in the mid block, MAN after every down block, and the
  "text_time" added embedding: the sinusoids (256 each) of the time ids
  after the pooled vector, through ``add_embedding`` (2816 -> 1280), added
  to the timestep's embedding;
- ``torch_oracle_xl``: ``_oracle.torch_oracle``'s algorithm (per-stream
  encodes, banks per window at t = 0 with the cond context, per-window CFG,
  counter-averaged fusion, DDIM in numpy, frame-wise decode) with the added
  conditioning handed to both UNets: the uncond pass takes a zero pooled
  vector as it takes a zero context, the time ids are the same in both; and
  the VAE's own latent scale.

Departures from the published description, as the port has them: MikuDance
on SDXL is this repository's configuration (the guidance UNet at SDXL's
widths with the 20-channel ``conv_in`` and MAN, a bank a block); the
sampler is MikuDance's DDIM, not SDXL's Euler; the banks are written once
per clip at t = 0 (the reference recomputes them every step, bit for bit
the same).

Bank keys follow the port's ``models.unet.bank_keys``: ``down_i_j``,
``mid``, ``up_i_j`` for a one-block transformer, ``key.b`` for block b of a
deeper one.
"""

from __future__ import annotations

import numpy as np
import torch

from ._oracle import (TBasicTransformerBlock, TMANModule, TResnetBlock, TTimeEmbedding,
                      TVanillaTemporalModule, _Blank, _nchw, ddim_step_np,
                      timestep_embedding_torch)


class TTransformer2DXL(torch.nn.Module):
    """Transformer2DModel with ``depth`` blocks and Linear (``linear``) or
    1x1-conv projections."""

    def __init__(self, ch, heads, ctx_dim, depth=1, linear=False, groups=32):
        super().__init__()
        self.linear = linear
        self.norm = torch.nn.GroupNorm(groups, ch, eps=1e-6)
        self.proj_in = torch.nn.Linear(ch, ch) if linear else torch.nn.Conv2d(ch, ch, 1)
        self.transformer_blocks = torch.nn.ModuleList(
            [TBasicTransformerBlock(ch, heads, ctx_dim) for _ in range(depth)])
        self.proj_out = torch.nn.Linear(ch, ch) if linear else torch.nn.Conv2d(ch, ch, 1)

    def forward(self, x, ctx, refs, write=False):
        """``refs``: one bank (or None) a block. Returns (h, [bank a block])."""
        B, C, H, W = x.shape
        h = self.norm(x)
        if self.linear:
            h = self.proj_in(h.permute(0, 2, 3, 1).reshape(B, H * W, C))
        else:
            h = self.proj_in(h).permute(0, 2, 3, 1).reshape(B, H * W, C)
        banks = []
        for blk, ref in zip(self.transformer_blocks, refs):
            h, bank = blk(h, ctx, ref=ref, write=write)
            banks.append(bank)
        if self.linear:
            h = self.proj_out(h).reshape(B, H, W, C).permute(0, 3, 1, 2)
        else:
            h = self.proj_out(h.reshape(B, H, W, C).permute(0, 3, 1, 2))
        return h + x, banks


class TUNetXL(torch.nn.Module):
    """The UNet twin at a configurable geometry (``heads``, ``depths``:
    per level; ``attn_levels``: the levels with spatial attention;
    ``motion_levels``: those with motion modules). ``added``: (time-id
    sinusoid width, add_embedding input width), SDXL's (256, 2816), or None.
    Checkpoint keys match diffusers / the reference."""

    def __init__(self, ch, layers, heads, ctx_dim, in_ch, attn_levels, depths, mid_depth,
                 out_ch=4, groups=32, eps=1e-5, linear=False, motion=False, motion_levels=(),
                 motion_heads=8, motion_mid=False, man=False, max_len=32, added=None):
        super().__init__()
        n = len(ch)
        self.n, self.layers, self.man, self.added = n, layers, man, added
        self.attn_levels, self.depths, self.mid_depth = tuple(attn_levels), depths, mid_depth
        self.motion_levels = tuple(motion_levels) if motion else ()
        self.motion_mid = motion and motion_mid
        temb_dim = ch[0] * 4
        self.conv_in = torch.nn.Conv2d(in_ch, ch[0], 3, padding=1)
        self.time_embedding = TTimeEmbedding(ch[0], temb_dim)
        if added is not None:
            self.add_embedding = TTimeEmbedding(added[1], temb_dim)

        def st(c, lv, depth):
            return TTransformer2DXL(c, heads[lv], ctx_dim, depth, linear, groups)

        def mm(c):
            return TVanillaTemporalModule(c, motion_heads, max_len)

        skips, cur = [ch[0]], ch[0]
        self.down_blocks = torch.nn.ModuleList()
        for i in range(n):
            blk = _Blank()
            blk.resnets = torch.nn.ModuleList()
            if i in self.attn_levels:
                blk.attentions = torch.nn.ModuleList()
            if i in self.motion_levels:
                blk.motion_modules = torch.nn.ModuleList()
            for _ in range(layers):
                blk.resnets.append(TResnetBlock(cur, ch[i], temb_dim, groups, eps))
                cur = ch[i]
                if i in self.attn_levels:
                    blk.attentions.append(st(ch[i], i, depths[i]))
                if i in self.motion_levels:
                    blk.motion_modules.append(mm(ch[i]))
                skips.append(ch[i])
            if i < n - 1:
                ds = _Blank()
                ds.conv = torch.nn.Conv2d(ch[i], ch[i], 3, stride=2, padding=1)
                blk.downsamplers = torch.nn.ModuleList([ds])
                skips.append(ch[i])
            self.down_blocks.append(blk)
        if man:
            self.man_blocks = torch.nn.ModuleList([TMANModule(ch[i]) for i in range(n)])

        mid = _Blank()
        mid.resnets = torch.nn.ModuleList(
            [TResnetBlock(ch[-1], ch[-1], temb_dim, groups, eps) for _ in range(2)])
        mid.attentions = torch.nn.ModuleList([st(ch[-1], n - 1, mid_depth)])
        if self.motion_mid:
            mid.motion_modules = torch.nn.ModuleList([mm(ch[-1])])
        self.mid_block = mid

        self.up_blocks = torch.nn.ModuleList()
        for i in range(n):
            lv = n - 1 - i
            out_c = ch[lv]
            blk = _Blank()
            blk.resnets = torch.nn.ModuleList()
            if lv in self.attn_levels:
                blk.attentions = torch.nn.ModuleList()
            if lv in self.motion_levels:
                blk.motion_modules = torch.nn.ModuleList()
            for _ in range(layers + 1):
                blk.resnets.append(TResnetBlock(cur + skips.pop(), out_c, temb_dim, groups, eps))
                cur = out_c
                if lv in self.attn_levels:
                    blk.attentions.append(st(out_c, lv, depths[lv]))
                if lv in self.motion_levels:
                    blk.motion_modules.append(mm(out_c))
            if i < n - 1:
                us = _Blank()
                us.conv = torch.nn.Conv2d(out_c, out_c, 3, padding=1)
                blk.upsamplers = torch.nn.ModuleList([us])
            self.up_blocks.append(blk)

        self.conv_norm_out = torch.nn.GroupNorm(groups, ch[0], eps=eps)
        self.conv_out = torch.nn.Conv2d(ch[0], out_ch, 3, padding=1)

    def forward(self, x, t, ctx, banks=None, motion_map=None, T=1, write=False, added=None):
        """x: (B*T, C_in, H, W); ``added``: (time ids (B, k), pooled (B, P))
        where the UNet has the added embedding; banks keyed like the port's
        ``models.unet.bank_keys``."""
        out_banks = {}
        B = x.shape[0] // T
        temb = self.time_embedding(timestep_embedding_torch(t, self.conv_in.out_channels))
        if self.added is not None:
            time_ids, pooled = added
            te = timestep_embedding_torch(time_ids.reshape(-1), self.added[0]).reshape(B, -1)
            temb = temb + self.add_embedding(torch.cat([pooled, te], dim=-1))
        temb_f = temb.repeat_interleave(T, 0)
        ctx_f = ctx.repeat_interleave(T, 0)

        def mm(mod, h):
            bt, c, hh, ww = h.shape
            v = mod(h.reshape(B, T, c, hh, ww).permute(0, 2, 1, 3, 4))
            return v.permute(0, 2, 1, 3, 4).reshape(bt, c, hh, ww)

        def attn(mod, key, h):
            depth = len(mod.transformer_blocks)
            keys = [key] if depth == 1 else [f"{key}.{b}" for b in range(depth)]
            refs = [None if banks is None else banks.get(k) for k in keys]
            h, written = mod(h, ctx_f, refs, write=write)
            out_banks.update(zip(keys, written))
            return h

        h = self.conv_in(x)
        skips = [h]
        for i, blk in enumerate(self.down_blocks):
            for j in range(self.layers):
                h = blk.resnets[j](h, temb_f)
                if hasattr(blk, "attentions"):
                    h = attn(blk.attentions[j], f"down_{i}_{j}", h)
                if hasattr(blk, "motion_modules"):
                    h = mm(blk.motion_modules[j], h)
                skips.append(h)
            if hasattr(blk, "downsamplers"):
                h = blk.downsamplers[0].conv(h)
                skips.append(h)
            if self.man and motion_map is not None:
                h = self.man_blocks[i](h, motion_map)

        h = self.mid_block.resnets[0](h, temb_f)
        h = attn(self.mid_block.attentions[0], "mid", h)
        if self.motion_mid:
            h = mm(self.mid_block.motion_modules[0], h)
        h = self.mid_block.resnets[1](h, temb_f)

        for i, blk in enumerate(self.up_blocks):
            for j in range(self.layers + 1):
                h = blk.resnets[j](torch.cat([h, skips.pop()], dim=1), temb_f)
                if hasattr(blk, "attentions"):
                    h = attn(blk.attentions[j], f"up_{i}_{j}", h)
                if hasattr(blk, "motion_modules"):
                    h = mm(blk.motion_modules[j], h)
            if hasattr(blk, "upsamplers"):
                h = torch.nn.functional.interpolate(h, scale_factor=2, mode="nearest")
                h = blk.upsamplers[0].conv(h)

        h = self.conv_out(torch.nn.functional.silu(self.conv_norm_out(h)))
        return h, out_banks


def make_twins_xl(ch, heads, depths, attn_levels, ctx_dim, motion_levels,
                  device, motion_heads=8, added=(256, None), linear=True, groups=32,
                  seed: int = 3):
    """The guidance UNet (MAN, 20 input channels) and the denoiser (motion
    modules at ``motion_levels``, none in the mid block) at SDXL's wiring
    on ``device`` under ``seed``, the denoiser's temporal ``proj_out`` drawn
    from N(0, 0.05) (it starts at zero, which would hide the motion
    modules); the mid block as deep as the last level (diffusers').
    ``added``: (time-id width, pooled width); the add_embedding takes pooled
    + 6 time ids' sinusoids."""
    time_dim, pooled = added
    add = (time_dim, pooled + 6 * time_dim)
    common = dict(ch=ch, layers=2, heads=heads, ctx_dim=ctx_dim, attn_levels=attn_levels,
                  depths=depths, mid_depth=depths[-1], groups=groups, linear=linear,
                  added=add)
    dev = torch.device(device)
    with torch.random.fork_rng(devices=[dev] if dev.type == "cuda" else []), dev:
        torch.manual_seed(seed)
        guide = TUNetXL(in_ch=20, man=True, **common).eval()
        den = TUNetXL(in_ch=4, motion=True, motion_levels=motion_levels,
                      motion_heads=motion_heads, **common).eval()
        for name, p in den.named_parameters():
            if "proj_out" in name and "temporal_transformer" in name:
                torch.nn.init.normal_(p, std=0.05)
    return guide, den


def torch_oracle_xl(tvae, tguide, tden, inputs, added, alphas_cumprod, step_pairs, windows,
                    device, latent_scale: float, scale: float):
    """The reference inference algorithm with the added conditioning
    ``added`` = (time ids (1, 6), pooled (1, P)) as numpy, on ``device``;
    the guidance UNet takes the cond context and pooled vector at every
    position (the port's ``guidance_clip_mode="cond"``). Returns the final
    latents (T, 4, h, w) and the uint8 video (T, H, W, 3), as numpy."""
    ref_img, skel, pose, face, hand, motion, clip_ctx, noise = inputs
    T = pose.shape[0]

    def enc(x):  # scaled latent means
        return tvae.quant_conv(tvae.encoder(_nchw(x, device)))[:, :4] * latent_scale

    cond20 = torch.cat([enc(ref_img[None]).expand(T, -1, -1, -1),
                        enc(skel[None]).expand(T, -1, -1, -1), enc(pose), enc(face), enc(hand)],
                       dim=1)
    motion_t = _nchw(motion, device)
    ctx_c = torch.from_numpy(clip_ctx).to(device)
    ctx_u = torch.zeros_like(ctx_c)
    tid = torch.from_numpy(np.asarray(added[0], np.float32)).to(device).reshape(1, -1)
    pool_c = torch.from_numpy(np.asarray(added[1], np.float32)).to(device).reshape(1, -1)
    pool_u = torch.zeros_like(pool_c)

    banks_per_window = []
    for win in windows:
        wf = len(win)
        _, banks = tguide(cond20[win], torch.zeros(wf, device=device), ctx_c.expand(wf, -1, -1),
                          motion_map=motion_t[win], write=True,
                          added=(tid.expand(wf, -1), pool_c.expand(wf, -1)))
        banks_per_window.append(banks)

    ts, prev_ts = step_pairs
    latents = torch.from_numpy(noise.transpose(0, 3, 1, 2).copy()).to(device)
    h, w = latents.shape[2:]
    for t, t_prev in zip(ts, prev_ts):
        sum_u, sum_c = torch.zeros_like(latents), torch.zeros_like(latents)
        counter = torch.zeros(T, 1, 1, 1, device=device)
        for win, banks in zip(windows, banks_per_window):
            wf = len(win)
            lat_w = latents[win].reshape(wf, 4, h, w)
            t_b = torch.full((1,), float(t), device=device)
            pred_u, _ = tden(lat_w, t_b, ctx_u, banks=None, T=wf, added=(tid, pool_u))
            pred_c, _ = tden(lat_w, t_b, ctx_c, banks=banks, T=wf, added=(tid, pool_c))
            for j, fidx in enumerate(win):
                sum_u[fidx] += pred_u[j]
                sum_c[fidx] += pred_c[j]
                counter[fidx] += 1
        mean_u, mean_c = sum_u / counter, sum_c / counter
        latents = ddim_step_np(mean_u + scale * (mean_c - mean_u), t, t_prev, latents,
                               alphas_cumprod)

    frames = [tvae.decoder(tvae.post_quant_conv(latents[i:i + 1] / latent_scale))
              for i in range(T)]
    video = ((torch.cat(frames).clamp(-1, 1) / 2 + 0.5).clamp(0, 1) * 255.0).round()
    return (latents.cpu().numpy(),
            video.permute(0, 2, 3, 1).cpu().numpy().astype(np.uint8))


def sdxl_time_ids(height: int, width: int) -> np.ndarray:
    """SDXL's time ids of an uncropped picture served at its own size:
    (original h, w, crop top, left, target h, w)."""
    return np.array([height, width, 0, 0, height, width], np.float32)


