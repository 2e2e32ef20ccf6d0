"""The plain reference networks at SDXL's geometry, fp32, with no kernel of
the program: a frozen copy of ``mikudance_tpu_torch/scripts/_oracle_xl.py``'s
twins built on ``twins.py``'s leaf modules (attention in blocks of query
rows, the plain GroupNorm, the fp8 control's hooks).

- ``TTransformer2DXL``: diffusers ``Transformer2DModel`` with
  ``use_linear_projection`` (Linear ``proj_in`` / ``proj_out``) and ``depth``
  blocks, each writing and reading its own bank;
- ``TUNetXL``: ``UNet2DConditionModel``'s wiring at a configurable geometry:
  spatial attention at the levels named (SDXL: levels 1 and 2), heads and
  depth by level (SDXL: 10 and 20 heads of 64; 2 and 10 blocks), the mid
  block's depth (10), motion modules at the levels named (the AnimateDiff
  SDXL adapter: all three; none in the mid block), MAN after every down
  block (the guidance UNet), and the "text_time" added embedding: the
  sinusoids (256 each) of the six time ids after the pooled vector (1280),
  through ``add_embedding`` (2816 -> 1280), added to the timestep's
  embedding.

Departures from the published description: MikuDance on SDXL's widths is
this repository's configuration (the guidance UNet at SDXL's widths with a
20-channel ``conv_in`` and MAN; a bank a transformer block, added to the
reader's self-attention K/V input). Bank keys are the port's
``models.unet.bank_keys``: ``key`` for a one-block transformer, ``key.b``
for block b of a deeper one.
"""

from __future__ import annotations

import torch

from . import twins


class TTransformer2DXL(torch.nn.Module):
    def __init__(self, ch, heads, ctx_dim, depth=1, linear=False, groups=32):
        super().__init__()
        self.linear = linear
        self.norm = twins.GroupNorm(groups, ch, eps=1e-6)
        self.proj_in = torch.nn.Linear(ch, ch) if linear else torch.nn.Conv2d(ch, ch, 1)
        self.transformer_blocks = torch.nn.ModuleList(
            [twins.TBasicTransformerBlock(ch, heads, ctx_dim) for _ in range(depth)])
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
    """``heads``, ``depths``: per level; ``attn_levels``, ``motion_levels``:
    the levels with spatial attention, with motion modules; ``added``:
    (time-id sinusoid width, add_embedding input width) or None."""

    def __init__(self, ch, layers, heads, ctx_dim, in_ch, attn_levels, depths, mid_depth,
                 out_ch=4, groups=32, eps=1e-5, linear=False, motion=False, motion_levels=(),
                 motion_heads=8, motion_mid=False, man=False, max_len=32, added=None):
        super().__init__()
        n = len(ch)
        self.n, self.layers, self.man, self.added = n, layers, man, added
        self.attn_levels = tuple(attn_levels)
        self.motion_levels = tuple(motion_levels) if motion else ()
        self.motion_mid = motion and motion_mid
        temb_dim = ch[0] * 4
        self.conv_in = torch.nn.Conv2d(in_ch, ch[0], 3, padding=1)
        self.time_embedding = twins.TTimeEmbedding(ch[0], temb_dim)
        if added is not None:
            self.add_embedding = twins.TTimeEmbedding(added[1], temb_dim)

        def st(c, lv, depth):
            return TTransformer2DXL(c, heads[lv], ctx_dim, depth, linear, groups)

        def mm(c):
            return twins.TVanillaTemporalModule(c, motion_heads, max_len)

        skips, cur = [ch[0]], ch[0]
        self.down_blocks = torch.nn.ModuleList()
        for i in range(n):
            blk = twins._Blank()
            blk.resnets = torch.nn.ModuleList()
            if i in self.attn_levels:
                blk.attentions = torch.nn.ModuleList()
            if i in self.motion_levels:
                blk.motion_modules = torch.nn.ModuleList()
            for _ in range(layers):
                blk.resnets.append(twins.TResnetBlock(cur, ch[i], temb_dim, groups, eps))
                cur = ch[i]
                if i in self.attn_levels:
                    blk.attentions.append(st(ch[i], i, depths[i]))
                if i in self.motion_levels:
                    blk.motion_modules.append(mm(ch[i]))
                skips.append(ch[i])
            if i < n - 1:
                ds = twins._Blank()
                ds.conv = torch.nn.Conv2d(ch[i], ch[i], 3, stride=2, padding=1)
                blk.downsamplers = torch.nn.ModuleList([ds])
                skips.append(ch[i])
            self.down_blocks.append(blk)
        if man:
            self.man_blocks = torch.nn.ModuleList([twins.TMANModule(ch[i]) for i in range(n)])

        mid = twins._Blank()
        mid.resnets = torch.nn.ModuleList(
            [twins.TResnetBlock(ch[-1], ch[-1], temb_dim, groups, eps) for _ in range(2)])
        mid.attentions = torch.nn.ModuleList([st(ch[-1], n - 1, mid_depth)])
        if self.motion_mid:
            mid.motion_modules = torch.nn.ModuleList([mm(ch[-1])])
        self.mid_block = mid

        self.up_blocks = torch.nn.ModuleList()
        for i in range(n):
            lv = n - 1 - i
            out_c = ch[lv]
            blk = twins._Blank()
            blk.resnets = torch.nn.ModuleList()
            if lv in self.attn_levels:
                blk.attentions = torch.nn.ModuleList()
            if lv in self.motion_levels:
                blk.motion_modules = torch.nn.ModuleList()
            for _ in range(layers + 1):
                blk.resnets.append(twins.TResnetBlock(cur + skips.pop(), out_c, temb_dim,
                                                      groups, eps))
                cur = out_c
                if lv in self.attn_levels:
                    blk.attentions.append(st(out_c, lv, depths[lv]))
                if lv in self.motion_levels:
                    blk.motion_modules.append(mm(out_c))
            if i < n - 1:
                us = twins._Blank()
                us.conv = torch.nn.Conv2d(out_c, out_c, 3, padding=1)
                blk.upsamplers = torch.nn.ModuleList([us])
            self.up_blocks.append(blk)

        self.conv_norm_out = twins.GroupNorm(groups, ch[0], eps=eps)
        self.conv_out = torch.nn.Conv2d(ch[0], out_ch, 3, padding=1)

    def forward(self, x, t, ctx, banks=None, motion_map=None, T=1, write=False, added=None):
        """x: (B*T, C_in, H, W); ``added``: (time ids (B, 6), pooled (B, P))."""
        out_banks = {}
        B = x.shape[0] // T
        temb = self.time_embedding(twins.timestep_embedding_torch(t, self.conv_in.out_channels))
        if self.added is not None:
            time_ids, pooled = added
            te = twins.timestep_embedding_torch(time_ids.reshape(-1), self.added[0])
            temb = temb + self.add_embedding(torch.cat([pooled, te.reshape(B, -1)], dim=-1))
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


def unet_twin(config: dict, part: str) -> TUNetXL:
    """The guidance UNet (``part`` "guide") or the denoiser ("den") of a
    configuration file at this geometry."""
    u, m = config["unet"], config["motion"]
    ch = tuple(u["block_out_channels"])
    time_dim = u["addition_time_embed_dim"]
    common = dict(ch=ch, layers=u["layers_per_block"], heads=tuple(u["level_heads"]),
                  ctx_dim=u["cross_attention_dim"], attn_levels=u["attention_levels"],
                  depths=tuple(u["transformer_layers"]), mid_depth=u["mid_transformer_layers"],
                  groups=u["norm_num_groups"], eps=u["norm_eps"],
                  linear=u["use_linear_projection"],
                  added=(time_dim, u["projection_class_embeddings_input_dim"]))
    if part == "guide":
        return TUNetXL(in_ch=config["guidance"]["cond_channels"], man=True, **common)
    levels = [i for i in range(len(ch)) if (1 << i) in m["resolutions"]]
    return TUNetXL(in_ch=4, motion=True, motion_levels=levels,
                   motion_heads=m["num_attention_heads"], motion_mid=m["mid_block"],
                   max_len=m["temporal_position_encoding_max_len"], **common)
