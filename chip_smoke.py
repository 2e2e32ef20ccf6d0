#!/usr/bin/env python3
"""Drive the PyTorch port's paths once on one CUDA card.

    python3 chip_smoke.py             # the smoke, below
    python3 chip_smoke.py --profile   # device-time breakdown of requests A, B, E, one F step
    python3 chip_smoke.py --kernels K12,K14   # phases 1-3 for the named kernels, ptxas's report
    python3 chip_smoke.py --budgets   # peak memory, phase by phase, as the clip grows
    python3 chip_smoke.py --train     # phases 1-2, then requests F and G alone
    python3 chip_smoke.py --train --profile   # one request-F train step under the profiler
    python3 chip_smoke.py --request-h   # phases 1-2, then request H alone
    python3 chip_smoke.py --request-i   # phases 1-2, then request I (the toolbox) alone
    python3 chip_smoke.py --request-i --profile   # ... with UniPose's device time by part
                                                  # and a driver frame's host time by op
    python3 chip_smoke.py --request-j   # phases 1-2, then request J (fp32, the SD-width gate) alone
    python3 chip_smoke.py --request-k   # phases 1-2, the NCCL and all_to_all probes, then
                                        # request K (4 ranks on the card) alone
    python3 chip_smoke.py --request-l   # phases 1-2, then request L (the trainers on gloo
                                        # ranks of the card, the graft entry) alone
    python3 chip_smoke.py --request-d   # phases 1-2, then request D alone, D_RUNS times

Phases, in order, one line each; any failure exits non-zero:

1. card: the device and its power limit (nvidia-smi), TF32 switches;
2. build: nvcc builds the kernel library from ``mikudance_tpu_torch/csrc``;
3. kernels: K1-K15 against their plain PyTorch versions at the
   paths' shapes, atol = rtol = 2e-2 and a relative-L2 limit, each with a
   control that the limit must reject (attention: softmax scale off by 9% on
   bf16 N(0, 1) inputs;
   K5: the wrong group size, K6: a row width miscounted by 20%, both on
   inputs with a per-channel offset and spread, K6's with a per-row offset
   too; K7: the bias or the residual left out; K8: the taps transposed; K14:
   the bank K/V left out; K15: the halves swapped),
   median times of the
   kernel, its plain version and the one library call that computes the
   same function, and the least time the card could take (``bound_ms``).
   K5 and K6 must give the same bits on a second run, K15 the plain
   version's bits (its four UNet levels in bf16, level 0 in fp32); each K5 shape prints
   its variant (R: clusters of how many blocks, the slab, shared memory a
   block and ``cudaOccupancyMaxActiveClusters``; S: splits), its device time
   against the smallest slab's where the plan widened it, and K5 and K6 their
   host and device time a call by kernel (where a call costs its host time,
   (32, 12, 12, 2560) and (1, 257, 1024), where that host time goes).
   K14 logs, at each level, its plan (chunk, barriers, scratch), its device
   time by phase and the chunk table: its time at chunks of 1, 2, 4, 8 and
   32 batch elements, in turns.
   K3 and K13 are held to ``temporal_attention_rounded`` (the TPU bodies'
   bf16 rounding of q' and of the weights; a one-token case's control reads
   v's channels shifted by one, since the scale does not matter there), with
   the CPU route's plain version's distance and, for K13, host and device
   time a call beside the library call's.
   K1 is held to ``anchored_attention_t`` (the TPU kernel's anchor and
   clamp), also where the clamp bites and the exact softmax is another
   function, and to K12 on the same inputs, which must give the same bits
   (two tags of one kernel; both timed in that line), as K10 is held to K11
   (at each head width); the anchored kernels' log lines also give the exp2
   floor. Heads of 160 (level 2 at 1024^2) have their cases for K1, K2 and
   K10-K12. Each attention kernel of K1-K4, K9-K13 has an fp32 case at a
   model shape (fp32 q, k and v: ``FP32_CASES``, also K1 at the tiny VAE's
   head of 32 and K3 at the tiny twins' heads of 8 and 24), held to the
   plain version that rounds where its TPU body does, its bound counting 4
   bytes for q and o; the anchored kernels also run on bf16-rounded q, which
   must land farther from it. The record keeps these under ``fp32``;
3b. request K, multi-GPU serving on the one card: each part once in a
    process of a world of one (the reference; the process then runs request
    L's references too) and on 4 gloo (ranks that then run request L1)
    ranks, each running ``VideoPipeline(..., mesh=make_mesh())`` on the same
    seeded weights and inputs, 2 steps: K1 request B's geometry in bf16
    (mesh win 2 x frame 2: an all_to_all pair a motion module, the 16-frame
    chunk decoded 4 frames a rank with halos and summed moments); then the
    same modules in fp32, TF32 off: K1 fp32 (B's geometry at 384^2), K2
    request D's geometry with per-step banks, with cached banks between the
    budget and 4x it (sharded on the ranks, streamed on one) and with
    cached_q8 (two windows padded to four of weight 0, fusion sums
    all-reduced), K3 a 64^2 clip (its 1 x 1 level gathers frames). Every
    rank's latents must be bit-identical and its frames' digest equal; each
    part's latents and decoded frames (floats) are held to the reference's
    by relative L2 (``K_BF16_REL_L2`` for K1; the fp32 parts
    ``K_F32_REL_L2``, ``K_F32_FRAMES_REL_L2``), with controls that must land
    above (the all_to_all left out in K1 and K1 fp32, K2 per_step's pad
    windows at weight 1, K1 fp32 decoded with zero halos), and K1's
    attention and LayerNorm launches a rank must equal the reference's. The
    line before the parts gives world size, backend, each rank's memory
    cap (an equal share of the card, ``K_CONTEXT_GIB``) and the meshes (with
    ``--request-k``, first the probes: NCCL with two ranks on the card,
    refused, and gloo's all_to_all on CUDA tensors against a host-staged
    one); each rank logs wall, phases, peak and launches. The ranks
    time-share one card: the seconds measure no scaling;
3c. request L, multi-GPU training on the one card: each part once in a
    process of a world of one (the references of all parts in request K's
    reference process) and on gloo ranks (L1's: request K's four) capped as request K's, every one running the trainer's ``main``
    on synthetic batches from the same seeds (so the same global batch and
    draws; the seeded init's all-zero tensors refilled, as everywhere in the
    smoke, so that the motion modules' interior and their collectives'
    backward carry a gradient from the first step). L1: request F's
    geometry (``train_stage2``, 20 x 576^2, batch 1, bf16, remat on) on 4
    ranks, the mesh ``choose_train_mesh`` picks (data 1 x frame 4: the
    motion modules reshard by ``all_to_all`` and gather at 9 x 9), two
    default steps and one inside ``kernels.transposed()``; L2: the same in
    fp32, TF32 off, at 256^2 on 2 ranks; L3: ``train_stage1`` at 384^2, full
    widths, batch 2 on 2 ranks, replicated and ZeRO. Held to the reference:
    losses and gradient norms (the global ones every rank logs) and the
    relative L2 of Adam's first moment, (1 - b1) times the clipped summed
    gradient, over every trained tensor; L3's ZeRO step to the replicated
    one (its final master values; its optimizer state at most 0.55x the
    replicated bytes a rank); every rank's trained weights identical.
    Controls beyond the limits: the all_to_all without its backward (L1, L2,
    a step of its own), the gradients not all-reduced (L1, L2: the moment
    the first step would take from this rank's gradients alone, read in the
    default run), the clip's norm from the local shards alone (L3: the
    moment rescaled by that clip). Each rank logs its phases (batch, forward, backward,
    all-reduce, optimizer), peaks, optimizer-state bytes and launches (K1-K6,
    K10 and K12 must launch on L's ranks). L4: ``graft_entry.entry()``'s
    forward and ``graft_entry.dryrun_multichip(4)`` on the card's ranks;
4. request A: ``VideoPipeline.__call__`` at the headline geometry (16 uint8
   frames at 768^2, SD1.5 widths, context 30/8, CFG 3.5, 20 DDIM steps,
   absent face/hand streams, ready-made CLIP tokens and zero flow, SD-VAE
   decode to the host) with random seeded weights in bf16; checks shape,
   dtype, finite latents and that every kernel launched;
5. request A again, warm, with another seed and 4 steps;
5b. request A at 2 steps through ``scripts/profile_pipeline.py``'s body
    (warm-up, steady state, phases with their peaks, a call under the
    profiler), the report logged, then checked: (a) each kernel's calls in
    the profile (its device symbol, by ``PROFILE_CATEGORIES``' tags) equal
    its wrapper's launches over the traced call, K1 at hd 40 and 80; the
    control, the table without K1's tags, must fail it; (b) the categories
    add up to every kernel's device time, "other" under 2% of it; (c) each
    category's depth-3 rows (the elementwise ones named by the ATen op that
    launched them, with dtypes and shapes) add up to it within 1%; (d) the
    busy share in (0, 1]; (e) the phases start with h2d_normalize and add up
    to their call's wall within 5%;
6. request B, the CLI-shaped one: camera matrices and a depth map ->
   ``scene_motion_flow`` on the card; a reference picture -> CLIP tower
   (ViT-L/14 widths) -> tokens; the same sampler, 20 steps, with the
   temporal decoder; checks as for A plus the flow and the tokens;
7. an image request: ``ImagePipeline`` at 768^2, 20 steps, stage-1 networks
   (no MAN, no motion modules), SD VAE;
8. interpolation: a small request with ``interpolation_factor = 2``;
9. check: a small request (256^2, 4 frames, one step) through the kernels
   and through the plain versions, same weights and inputs, its latents
   decoded by each decoder both ways;
10. request C, long clips at 768^2 with context 30/8 and 2 steps, explicit
    budgets: 48 frames with ``bank_mode="auto"`` past 64 cached positions
    (three windows, per-step banks), the same clip with ``"cached_q8"``, and
    40 frames with ``max_denoise_frame_batch=32`` (two windows,
    cached-grouped). The tiers are held to one another on the same clip:
    q8 against per-step under a limit that a control (the int8 banks read
    back with scales off by 2x) must exceed, cached-grouped against per-step;
11. request D, the CLI's steps for ``-W 256 -H 256 -L 40`` (depth resize,
    scene motion, CLIP tower, seeded noise, sampler, temporal decode) with
    both windows in one UNet batch of 120 frames: the VAE goes through K9
    and the UNet mid-block through K13, and K4 must not launch;
12. request E, the row-major configuration: the warm request A of phase 5
    (same weights, inputs, seed and steps) inside ``kernels.row_major()``: the
    transformer blocks as the chain through K6 and K7, the stride-1 3x3
    convolutions through K8, packed-heads self-attention through K10 (2304
    tokens) and K11 (9216 tokens), K1 not launched. Its latents and decoded
    frames are held to warm request A's under relative-L2 limits that a
    control (the bank K/V left out of the chain) must exceed; the largest
    ``|s - off|`` of one level-0 self-attention call says whether the +-100
    clamp of K10 / K11, which the default configuration does not have, was
    idle; K7's and K8's launches whose grid of output tiles is under one wave
    of the card's multiprocessors are counted. Then the small request of
    phase 9 once more inside ``row_major()``.
13. request H, 1024^2: 16 frames, SD1.5 widths, CFG 3.5, 2 steps, the SD
    decoder, in the default configuration (K1 and K2 at heads of 160, K4 at
    the encoder's (8, 16384, 512), K5 at the VAE's 1024^2 maps) and inside
    ``row_major()`` (K10 at heads of 160, K11 at 40 and 80, K8 at 1024^2), the
    launches' shape arguments recorded; the row-major latents held to the
    default ones as request E's are (control: the bank K/V left out);
14. request I, the toolbox's networks (stock PyTorch ops, fp32, random seeded
    weights; no kernel of K1-K15 may launch): UniPose-SwinT on bench.py's
    XPose batch (10 frames at 800^2, 4 instance slots, 68 keypoints, 900
    queries), median seconds of 3 forwards after a warm-up, peak memory,
    shapes and finite outputs; the video driver's ``Detector.detect`` on a
    10-frame 720 x 1280 clip at its resize (800 x 1408, one frame a forward)
    for the person, face and hand vocabularies, seconds per frame and per
    vocabulary, keypoints finite; one 384^2 frame on the card and on the CPU,
    the encoder memory held to 1e-4 (control: the level embedding left out)
    and the outputs to 1e-3 where the selected top-900 / top-50 indices
    agree (their counts logged); DPT-hybrid at its full geometry on one
    384^2 picture, card against CPU, depth and the ViT's last hidden state
    to 1e-3 (control: the ViT's LayerNorm eps at 1e-5), and the depth
    driver's ``run_depth`` (fp32 whatever the process sets) timed and held
    to the same limit; with cuDNN's TF32 convolutions, which neither driver
    runs, UniPose's and DPT's distance from the CPU is logged; CLIP-text at
    ViT-B/32 widths on 72 prompts of 77 ids, 1e-4 (control: the erf GELU for
    quick_gelu); the deformable-attention op at the 800^2 encoder's shapes
    against the port's C++ kernel on the CPU, max abs 1e-5 (control: the
    value's channels shifted by one);
15. request F, training: ``scripts.train_stage2.main`` on synthetic batches at
    the reference's geometry (20 frames at 576^2, batch 1, SD1.5 widths, MAN
    and motion modules on, bf16 with fp32 master copies, remat on), three
    optimizer steps in the default configuration (K1) and three inside
    ``kernels.transposed()`` (K12 at level 0, K10 at level 1), same seeds and
    so the same draws: each must launch K2, K3, K4 (the frozen VAE encoder),
    K5, K6 and its own self-attention kernels and none of the others; finite
    losses, the trainable partition moved, the frozen one bit-identical;
    losses and gradient norms of the two runs held to one another, with
    another step's draws as the control; seconds and peak memory per phase.
    Then a small train step (4 frames at 256^2, the same networks) through
    the kernels and with every wrapper forced to its plain version, loss and
    gradients held to one another (control: the conditioning dropped); then
    two ``train_stage1`` steps at 768^2 (batch cut from 8 to 1).
14b. request J, fp32 and fidelity: J1, the SD-width gate
    (``scripts/psnr_sd_width.run_gate``): SD-width twins built once on the
    card, the oracle once (fp32, TF32 off), then the port's pipeline in fp32
    (TF32 off) and in bf16 (PyTorch's TF32 defaults) against it, each at 35
    dB or more, with K1, K2 and K3 launched (the latents' max abs error, the
    wall seconds, peak memory and launches logged); J2, ``verify_parity
    --selfcheck`` on the card (``pass`` must be true); J3, request A in fp32
    (the bundle cast to fp32: UNets and SD VAE) at 2 steps: finite frames and
    latents of the right shapes, every kernel's launches equal to the same
    2-step request in bf16 (the routes do not depend on the dtype), K1-K4
    launched;
16. request G: the mega-block probe K14 at (32, 2304, 640) in one launch
    against the port's ``TransformerBlock`` read path on the same weights,
    both timed (control: the bank K/V left out), and K14's device time by
    phase (block 0's %globaltimer stamps after each grid barrier).

The kernel counts are set to 0 just before each request and read just after;
K3's and K13's must equal the counts read before the two were rebuilt on
one kernel (``K3_K13_LAUNCHES``),
K1's and K4's must equal the counts the smoke read before the dispatcher
took the JAX block rule (``K1_K4_LAUNCHES``), K2's and K10's those read
before the two were rebuilt (``K2_K10_LAUNCHES``), K11's and K12's those read
before the two moved onto K10's kernel (``K11_K12_LAUNCHES``), request H's
those read when it was added (``H_LAUNCHES``).
It prints the kernel record (one JSON object; ``ms``, ``plain_ms``,
``library_ms`` and ``bound_ms`` at each kernel's first shape; ``launches``
from request B, for K9 and K13 from request D, for K7, K8, K10 and K11 from
request E, for K12 from request F, for K14 from request G; request L's rank
0 beside them), the nvidia-smi line, and
last the result line. Uses one card, the first visible one; imports nothing
of JAX.

``--profile`` runs phases 1-2, then torch.profiler over a 2-step and a
20-step request A and a 20-step request B (after a 1-step warm-up), then a
2-step and a 6-step request E (request A inside ``row_major()``), and prints
device time by kernel category, per request and per denoise step, and the
top kernels; then one request-F train step (forward, backward and optimizer
shares, device time by category). The categories, the per-op rows and the
trace are ``mikudance_tpu_torch/utils/profiling.py``'s; a user's command for
one request's profile is ``python -m mikudance_tpu_torch.scripts.profile_pipeline``.
"""

import argparse
import contextlib
import functools
import json
import math
import os
import subprocess
import sys
import time
from collections import defaultdict

import numpy as np
import torch

from mikudance_tpu_torch.scripts._synthetic import build_bundle, make_inputs, seeded_modules
from mikudance_tpu_torch.utils.profiling import (ELEMENTWISE, PROFILE_CATEGORIES, RUN_IN,
                                                 PeakTimer, category, device_ms,
                                                 host_and_kernels_ms, kernel_calls,
                                                 op_profile_rows, profile_request, profile_text,
                                                 trace)

STEPS = 20  # DDIM steps of each request, as the headline configuration
T, H, W = 16, 768, 768
ATOL = RTOL = 2e-2  # bf16 kernel against its plain version, as tests/test_flash_attention.py
# N(0, 1) inputs leave the softmax over thousands of keys nearly flat, so
# outputs are small (std ~0.017 at S = 9216) and ATOL alone would pass a
# wrong kernel. Each kernel's output is also held to a relative L2 distance
# from its plain version's, and a control proves the limit can fail: the
# plain version with the softmax scale off by 9% (1/sqrt(48) for 1/sqrt(40),
# the padded width for the real one) must land above it.
REL_L2 = 1e-2
CONTROL_Q_SCALE = math.sqrt(40 / 48)
# Small request, kernels vs plain versions, relative L2 of the latents: bf16
# rounding differences grow through the random full-width network (2.7e-2
# measured on an H100); a kernel that computes the wrong thing gives O(1).
SMALL_REL_L2 = 1e-1
# The same latents decoded through the kernels and through the plain versions
# differ by the decoder's bf16 rounding alone (7e-3 measured on an H100 for
# either decoder): their own limit, about four times that reading.
SMALL_DECODED_REL_L2 = 3e-2
# K5's control runs the plain version with half the groups; K6's with the row
# width miscounted as 48/40 of what it is (statistics divided by the wrong
# count), the norms' counterpart of the padded head width above.
CONTROL_GROUPS = 16
CONTROL_WIDTH = 48 / 40
WARM_STEPS = 4  # the second, warm request A
LONG_STEPS = 2  # request C, the long clips
# cached_q8 against per-step banks on the same clip, relative L2 of the
# latents: the int8 rounding of the banks (under half a percent of each
# position's largest value) on top of bf16 rounding; the control reads the
# same cache back with its scales doubled and must land above the limit.
Q8_REL_L2 = 1e-1
D_FRAMES, D_SIZE, D_STEPS = 40, 256, 4  # request D, the CLI-shaped long clip
D_RUNS = 3  # --request-d: request D alone, this many times in one process
# Request E against warm request A, relative L2: the same function through
# other kernels and another order of bf16 roundings, four steps deep at full
# size (1.6e-2 for the latents and 1.1e-2 for the decoded frames measured on
# an H100): the small request's limits hold. The control (the bank K/V left
# out of the chain: 6.3e-1) must land above.
E_REL_L2 = SMALL_REL_L2
E_DECODED_REL_L2 = SMALL_DECODED_REL_L2
PROFILE_E_STEPS = 6
# The default smoke's profiled request A (scripts/profile_pipeline.py's body at
# 2 steps), held to the kernels' own counters: the categories may leave at
# most OTHER_SHARE of the device time to "other"; the depth-3 rows of a
# category add up to its total (by the profiler's per-kernel averages)
# within ROWS_REL; the phases add up to the call's wall within PHASES_REL.
PROFILED_STEPS = 2
OTHER_SHARE = 0.02
ROWS_REL = 0.01
PHASES_REL = 0.05
# Request H: SD1.5's level 2 (1280 channels in 8 heads of 160) takes a flash
# route from 1024 tokens, so 16 frames at 1024^2, 2 DDIM steps, the SD decoder
H_SIZE, H_STEPS = 1024, 2
# Launches of every kernel on request H in each configuration as the smoke
# read them when the request was added (kernels not named: 0); K15, added
# later: two denoiser calls of 37 feed-forwards and the guidance UNet's 16
H_LAUNCHES = {"request H": {"K1": 45, "K2": 45, "K3": 84, "K4": 7, "K5": 410, "K6": 270,
                            "K15": 90},
              "request H (row-major)": {"K2": 45, "K3": 84, "K4": 7, "K5": 410, "K6": 270,
                                        "K7": 256, "K8": 342, "K10": 15, "K11": 30, "K15": 90}}
# Request J: the SD-width gate's DDIM steps (the JAX gate's), request A's in
# fp32 (J3)
J_GATE_STEPS = 2
J3_STEPS = 2
# The card's published peaks (H100 SXM): device memory, dense bf16 tensor
# cores, fp32 outside the tensor cores.
PEAK_BYTES, PEAK_BF16, PEAK_FP32 = 3.35e12, 989e12, 67e12
# exp2 a clock on one SM's special-function units (Hopper: 4 quadrants of 4):
# the anchored attention's other floor beside its flops
EXP2_PER_CLOCK_SM = 16
# Request F, the stage-2 trainer's geometry (configs/train/train_stage2.yaml):
# 20 frames at 576^2, batch 1; its level-0 self-attention shape
TRAIN_FRAMES, TRAIN_SIZE = 20, 576
TRAIN_LEVEL0 = (TRAIN_FRAMES, (TRAIN_SIZE // 8) ** 2, 320)
TRAIN_STEPS = 3
# Request F in the transposed configuration (K12, K10) against the default one
# (K1), same seeds and so the same draws: relative difference of each step's
# loss and gradient norm (3.6e-5 and 4.7e-5 at most, measured on an H100).
# The control is the loss under another step's draws.
F_LOSS_REL = 1e-3
F_NORM_REL = 1e-3
# The small train step through the kernels against the plain versions: the
# loss, and the relative L2 of all gradients taken as one vector (bf16
# rounding through the full-width networks, forwards and backwards: 3.4e-5
# and 1.2e-2 measured on an H100; the control, the conditioning dropped, 4.6e-1).
SMALL_STEP_LOSS_REL = 1e-3
SMALL_STEP_GRAD_REL_L2 = 5e-2
# Request G: the mega-block probe against the block's read path
G_REL_L2 = 2e-2
# Launches of K1 and K4 on each path as the smoke read them before the
# dispatcher took the JAX block rule (PERF.md section 6): the rule changes no
# route of these geometries, so they must stay as they were.
K1_K4_LAUNCHES = {"request A": (210, 7), "request B": (210, 4), "image request": (210, 2),
                  "request C, per-step": (180, 19), "request C, cached_q8": (130, 19),
                  "request C, cached-grouped": (90, 16), "request D": (25, 0),
                  "request F (default)": (111, 63), "request F (transposed)": (0, 63),
                  "stage-1 steps": (40, 6)}
# Launches of K2 and K10 on each path as the smoke read them before the two
# kernels were rebuilt (PERF.md section 6): the rebuild changes no route.
K2_K10_LAUNCHES = {"request A": (210, 0), "request B": (210, 0), "image request": (210, 0),
                   "request C, per-step": (180, 0), "request C, cached_q8": (130, 0),
                   "request C, cached-grouped": (90, 0), "request D": (25, 0),
                   "request E": (None, 25), "request F (default)": (111, 0),
                   "request F (transposed)": (111, 60), "stage-1 steps": (40, 0)}
# Launches of K11 and K12 on each path as the smoke read them before the two
# moved onto K10's kernel (PERF.md section 6); every other path launches neither.
K11_K12_LAUNCHES = {"request E": (25, 0), "request F (transposed)": (0, 51)}
# Launches of K3 and K13 on each path as the smoke read them before the two
# were rebuilt on one kernel (PERF.md section 6): the rebuild changes no route.
K3_K13_LAUNCHES = {"request A": (840, 0), "request B": (840, 0), "image request": (0, 0),
                   "request C, per-step": (504, 0), "request C, cached_q8": (504, 0),
                   "request C, cached-grouped": (336, 0), "request D": (168, 4),
                   "request F (default)": (378, 0), "request F (transposed)": (378, 0),
                   "stage-1 steps": (0, 0)}


# Request K: multi-GPU serving on the one card. K_RANKS processes share it
# over gloo (NCCL refuses two ranks on one device), each running the sampler
# on a mesh of all of them, K_STEPS DDIM steps, against the same inputs'
# one-rank run (a process of its own, no process group).
# - K1: request B's geometry in bf16, the serving dtype. The ranks' UNet
#   batches are a quarter of one device's, so bf16 roundings differ (2.4e-2
#   measured on an H100): its limit K_BF16_REL_L2 and its control (the
#   motion modules' all_to_all left out: 6.5e-2) show that the path runs,
#   and no more.
# - The gate is the fp32 parts, TF32 off, where only the order of fp32 sums
#   differs (1.1e-4 to 4.1e-4 measured on an H100: the attention kernels
#   still round K, V and P to bf16): K1 fp32, B's geometry at
#   K1_F32_SIZE^2 (four fp32 ranks at 768^2 would not fit the card, one
#   takes 33 GiB); K2 request D's geometry with per-step
#   banks, with cached banks (a budget between the clip and K_RANKS times
#   it: cached sharded on the ranks, streamed on one) and with cached_q8; K3
#   a K3_SIZE^2 clip. Latents are held to the one-rank run at K_F32_REL_L2,
#   the decoded frames (float, before the uint8 rounding) at
#   K_F32_FRAMES_REL_L2. Controls, each of which must land above its limit:
#   K1 fp32 without the all_to_all and K2 per_step with its pad windows at
#   weight 1 (latents), K1 fp32's latents decoded with zero halos (frames).
# Each rank's caching allocator is capped at an equal share of what the card
# has free when the ranks start, less K_CONTEXT_GIB a rank for what lies
# outside the allocator (its CUDA context, library handles). Without a cap
# cuDNN's fp32 convolutions (TF32 off) take the largest workspace they can
# allocate, the first rank to ask keeps it in its cache, and a later
# allocation of another rank runs the card out of memory (K2 cached's banks
# phase peaked at 13.75 to 20.57 GiB a rank, measured on an H100, and a run
# could fail there); under a cap cuDNN takes a plan whose workspace fits
# (17.11 GiB on every rank).
K_RANKS, K_STEPS, K3_SIZE, K1_F32_SIZE = 4, 2, 64, 384
K_CONTEXT_GIB = 1.5
K_PARTS = ("K1", "K1 fp32", "K2 per_step", "K2 cached", "K2 cached_q8", "K3")
K_BF16_REL_L2 = 4e-2
K_F32_REL_L2 = 1e-3
K_F32_FRAMES_REL_L2 = 1e-3

# Request L: multi-GPU training on the one card, gloo ranks time-sharing it
# (capped as request K's), each part against its one-rank run (one process
# for every part's reference, no process group) on the same seeds, so the
# same global batch and draws:
# - L1: request F's geometry, train_stage2 --synthetic (20 x 576^2, batch 1,
#   remat on, bf16) on L1_RANKS ranks, the mesh choose_train_mesh picks (data
#   1 x frame 4: the motion modules reshard by all_to_all at 5184, 1296 and
#   324 positions and gather the frames at 81); L1_STEPS default steps and
#   one inside kernels.transposed();
# - L2: the same in fp32 (TF32 off) at L2_SIZE^2 on L2_RANKS ranks (four
#   fp32 ranks do not fit the caps); its spread sets L1's limits;
# - L3: train_stage1 --synthetic at L3_SIZE^2, full widths, batch L3_RANKS
#   (one a rank: 768^2 does not fit two ranks), ZeRO against the replicated
#   step on the same ranks (only the norm's sum order differs) and against
#   the one-rank batch-2 step.
# Held: the losses and gradient norms (the global ones every rank logs), and
# the relative L2 of Adam's first moment mu after the steps, (1 - b1) times
# the clipped summed gradient (after one step), over every trained tensor:
# unlike the first update, lr g / (|g| + eps), it keeps the gradient's scale
# and does not lift sum-order noise near eps. Controls, which must land
# beyond the limits: the motion modules' all_to_all without its backward
# (L1, L2); the gradients not all-reduced (L1, L2: the first moment this
# rank's own gradients give, read in the default run); the clip on the
# local shard's norm (L3: the moment rescaled by that clip over the global
# one).
L1_RANKS, L2_RANKS, L3_RANKS = 4, 2, 2
L1_STEPS = 2
L2_SIZE, L3_SIZE = 256, 384
L_LIMITS = {  # relative: loss, gradient norm, first moment (relative L2)
    "L2": (1e-5, 1e-5, 1e-3),
    "L1": (1e-4, 1e-4, 6e-2),
    "L3": (3e-4, 1e-3, 6e-2),
}
L3_ZERO_REL_L2, L3_ZERO_NORM_REL = 1e-5, 1e-5
L_ZERO_BYTES = 0.55
L_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke",
                      "request_l")

# Request I: the toolbox's networks, fp32 with random seeded weights, as the
# tool wrappers run them. UniPose: bench.py's XPose batch (10 frames at
# 800^2, 4 instance slots, 68 keypoint slots; no driver runs this batch), the
# median of 3 timed forwards after a warm-up; one frame at 384^2 on the card
# and on the CPU, whose encoder memory (before the top-k) and outputs (where
# the selected indices agree) are held to one another.
I_FRAMES, I_SIZE, I_N_TXT, I_K, I_RUNS = 10, 800, 4, 68, 3
# The XPose video driver's own entry point, ``Detector.detect``, as it runs a
# clip: a 9:16 portrait dance clip of 720 x 1280 at the driver's resize (short
# side 800, dims rounded to /32: 800 x 1408), one frame a forward, the
# person, face and hand vocabularies in turn, each encoding its prompts with
# CLIP-text and reading every frame's outputs back for postprocess and NMS.
I_CLIP_FRAMES, I_CLIP_SOURCE = 10, (720, 1280)
I_CHECK_SIZE = 384
I_MEMORY_REL_L2 = 1e-4
I_OUTPUT_REL_L2 = 1e-3
# DPT-hybrid at its full geometry: the depth and the ViT encoder's last hidden
# state, card against CPU. The BiT features feed the neck directly, so at
# random weights the depth hardly depends on the ViT's LayerNorm eps (the
# control: 1e-5 for 1e-12); the ViT's residual stream (patch projection,
# position and class embeddings, the two output projections of each layer)
# is drawn at I_VIT_SCALE of the default init, where the eps does matter.
I_DPT_REL_L2 = 1e-3
I_VIT_SCALE = 1e-2
# CLIP-text at ViT-B/32 widths: 72 prompts of 77 seeded ids with one EOT id
# each (control: quick_gelu read as the erf GELU).
I_CLIP_PROMPTS, I_CLIP_REL_L2, I_EOT = 72, 1e-4, 49407
# Deformable attention at the 800^2 encoder's shapes (Swin strides 8-64:
# 100^2, 50^2, 25^2, 13^2 = 13294 queries, 7 chunks of 2048; 8 heads of 32,
# 4 points), on the inputs UniPose's first encoder layer gives it, on the
# card against the port's C++ kernel on the CPU (control: the value's
# channels shifted by one).
I_LEVELS = ((100, 100), (50, 50), (25, 25), (13, 13))
I_DEFORM_ATOL = 1e-5

def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    """Fail the run (also under ``python -O``, which strips asserts)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.float(), want.float()
    return ((got - want).norm() / want.norm()).item()


def cuda_ms(fn, reps: int) -> float:
    """Median milliseconds of ``fn`` over ``reps`` timed runs, after one warm-up."""
    fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def build_slice_b_parts(seed: int, device):
    """The CLI-shaped request's extra networks at full width: the CLIP
    ViT-L/14 tower and the temporal decoder."""
    from mikudance_tpu_torch.core.configs import CLIPVisionConfig
    from mikudance_tpu_torch.models.clip_vision import CLIPVisionTower
    from mikudance_tpu_torch.models.vae_temporal import TemporalDecoder

    return seeded_modules(seed, device, lambda: [CLIPVisionTower(CLIPVisionConfig()),
                                                 TemporalDecoder()])


def build_stage1_unets(seed: int, device):
    """The stage-1 image networks: guidance UNet without MAN, denoising UNet
    without motion modules, SD1.5 widths."""
    from mikudance_tpu_torch.core.configs import DENOISING_2D, GUIDANCE_MIX_CHAR
    from mikudance_tpu_torch.models.unet import DenoisingUNet, GuidanceUNet

    return seeded_modules(seed, device, lambda: [GuidanceUNet(GUIDANCE_MIX_CHAR),
                                                 DenoisingUNet(DENOISING_2D)])


def make_camera(seed: int, frames: int, height: int, width: int):
    """A seeded camera path (a slow pan: yaw of 0.01 rad and a drift of up to
    0.5 units a frame) as world-to-camera and camera-to-world matrices
    (frames, 4, 4), a latent-resolution depth map in [0, 1], and a reference
    picture."""
    rng = np.random.default_rng(seed)
    c2w = np.tile(np.eye(4), (frames, 1, 1))
    yaw = np.cumsum(rng.normal(0.01, 0.002, frames))
    c2w[:, 0, 0], c2w[:, 0, 2] = np.cos(yaw), np.sin(yaw)
    c2w[:, 2, 0], c2w[:, 2, 2] = -np.sin(yaw), np.cos(yaw)
    c2w[:, :3, 3] = np.cumsum(rng.uniform(-0.5, 0.5, (frames, 3)), axis=0)
    depth = rng.uniform(0, 1, (height // 8, width // 8)).astype(np.float32)
    picture = rng.integers(0, 256, (height, width, 3), dtype=np.uint8)
    return np.linalg.inv(c2w), c2w, depth, picture


@contextlib.contextmanager
def plain_kernels():
    """Route every kernel to its plain version (reference run)."""
    from mikudance_tpu_torch.kernels import conv2d as cv
    from mikudance_tpu_torch.kernels import flash_attention as fa
    from mikudance_tpu_torch.kernels import geglu as gg
    from mikudance_tpu_torch.kernels import group_norm as gn
    from mikudance_tpu_torch.kernels import layer_norm as ln
    from mikudance_tpu_torch.kernels import linear as lin
    from mikudance_tpu_torch.kernels import temporal_attention as ta
    from mikudance_tpu_torch.models import layers

    patches = [(fa, n, fa.dot_product_attention)
               for n in ("cross_attention", "flash_attention_wide", "flash_attention_resident")]
    patches += [(fa, "flash_attention_fullc", fa.anchored_attention_t),
                (fa, "flash_attention_fullc_anchored", fa.anchored_attention),
                (fa, "flash_attention_fullc_t", fa.anchored_attention_t),
                (layers, "fused_linear", lin.linear_plain),
                (cv, "conv3x3_fused", lambda x, w, b, packed=None: cv.conv3x3_plain(x, w, b)),
                (fa, "temporal_attention", ta.temporal_attention_plain),
                (fa, "small_sequence_attention", ta.small_sequence_attention_plain),
                (layers, "fused_group_norm", gn.group_norm_plain),
                (layers, "fused_layer_norm", ln.layer_norm_plain),
                (layers, "fused_geglu", gg.geglu_plain)]
    saved = [(mod, n, getattr(mod, n)) for mod, n, _ in patches]
    for mod, n, f in patches:
        setattr(mod, n, f)
    try:
        yield
    finally:
        for mod, n, f in saved:
            setattr(mod, n, f)


def library_kernel_name(fn) -> str:
    """The device kernel that takes most of ``fn``'s time (which backend a
    library call chose), or "" if the profiler recorded none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(e.self_device_time_total, e.key) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    return max(rows)[1][:60] if rows else ""


def sdpa_backend_times(fn) -> str:
    """``fn`` (one scaled_dot_product_attention call) under each backend alone:
    its median ms, or "refused". The default call's time beside these says
    which backend PyTorch chose."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    out = []
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel([backend]):
                out.append(f"{backend.name} {cuda_ms(fn, 3):.3f} ms")
        except RuntimeError:
            out.append(f"{backend.name} refused")
    return "backends alone: " + ", ".join(out)


def norm_input(shape, g, dev, row_offset: bool = False) -> torch.Tensor:
    """bf16 data with a per-channel mean in [-8, 8] and spread in [0.25, 4]
    and, for LayerNorm, a per-row offset in [-8, 8] on top (channel means
    average out along a row), so that a wrong mean or a lost variance shows;
    filled in slabs to bound the fp32 temporaries."""
    C = shape[-1]
    mean = torch.rand(C, generator=g, device=dev) * 16 - 8
    std = torch.rand(C, generator=g, device=dev) * 3.75 + 0.25
    x = torch.empty(shape, dtype=torch.bfloat16, device=dev)
    rows = x.view(-1, C)
    for i in range(0, rows.shape[0], 1 << 22):
        slab = rows[i:i + (1 << 22)]
        values = torch.randn(slab.shape, generator=g, device=dev) * std + mean
        if row_offset:
            values += torch.rand((slab.shape[0], 1), generator=g, device=dev) * 16 - 8
        slab.copy_(values)
    return x


@functools.cache
def max_sm_clock_hz() -> float:
    """The card's highest SM clock (nvidia-smi ``clocks.max.sm``), in Hz."""
    out = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True,
                         check=True).stdout
    return float(out.split()[0]) * 1e6


def exp2_floor_ms(n: int) -> float:
    """The least time ``n`` exp2 take on the special-function units: 16 a
    clock on each SM at the card's highest SM clock."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return n / (EXP2_PER_CLOCK_SM * sms * max_sm_clock_hz()) * 1e3


def gemm_tiles_k7(args) -> int:
    """Output tiles (blocks) of one md_linear launch: x, w, bias, residual, y,
    rows, cin, cout, bias_fp32, tile width, stream."""
    return -(-args[5] // 128) * -(-args[7] // args[9])


def gemm_tiles_k8(args) -> int:
    """Output tiles (blocks) of one md_conv3x3 launch: x, packed weight,
    bias, y, images, height, width, cin, cout, bias_fp32, tile width, box
    width, box height, stream; a box is 128 pixels of ``nb`` images."""
    n, h, w, cout, bn, wb, hb = *args[4:7], args[8], *args[10:13]
    return -(-n // (128 // (wb * hb))) * (w // wb) * -(-h // hb) * -(-cout // bn)


def host_and_device_ms(fn, reps: int = 100) -> tuple[float, float]:
    """``fn``'s host time a call (wall clock over ``reps`` calls with no
    synchronisation between them) and its device time a call (torch.profiler's
    device time of the kernels the same number of calls launch), in ms."""
    host, by_kernel = host_and_kernels_ms(fn, reps)
    return host, sum(by_kernel.values())


def host_parts_ms(parts: dict, reps: int = 1000) -> str:
    """Wall-clock ms a call of each named callable, run ``reps`` times with no
    synchronisation: where a wrapper's host time goes."""
    out = []
    for name, fn in parts.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        out.append(f"{name} {(time.perf_counter() - t0) / reps * 1e3:.4f}")
        torch.cuda.synchronize()
    return "host ms a call: " + ", ".join(out)


def norm_split(fn, parts=None, reps: int = 20) -> str:
    """A norm call's host time and device time a call by kernel, and where
    given, the host time of its parts."""
    host, by_kernel = host_and_kernels_ms(fn, reps)
    text = (f"host {host:.4f} ms a call, device " + ", ".join(
        f"{k} {v:.4f}" for k, v in sorted(by_kernel.items())) + " ms a call")
    return text + ("; " + host_parts_ms(parts) if parts else "")


def launch_spy(launch, what, seen: list):
    """``launch`` that first appends ``what(args)`` (its grid's tile count, its
    shape arguments) to ``seen``."""
    def spy(*args):
        seen.append(what(args))
        launch(*args)
    return spy


# The shape arguments of an entry point's launch, after its pointers: (batch,
# seq, heads, hd) of the self-attention kernels; (batch, q_len, kv_len, heads,
# hd) of K2; (images, rows, channels) of K5; (images, height, width, cin,
# cout) of K8.
SHAPE_ARGS = {"md_flash_fullc": slice(4, 8), "md_flash_cross": slice(4, 9),
              "md_flash_wide": slice(4, 8), "md_flash_anchor_resident": slice(4, 8),
              "md_flash_anchor_stream": slice(4, 8), "md_group_norm": slice(5, 8),
              "md_conv3x3": slice(4, 9)}


def wanted(kern, only) -> bool:
    """Whether ``only`` (kernel numbers such as "K9"; empty: all) names ``kern``."""
    return not only or kern.name.split(" ")[0] in only


def attention_cases(dev, only=()):
    """K1-K4, K9 and K13 at the sampler's shapes: (kernel, label, run, plain,
    control, library, flops, bytes, peak rate); ``only`` keeps the kernels
    whose names it lists. K1 is held to ``anchored_attention_t``, also on an
    input where the clamp bites (q three times as large)."""
    import torch.nn.functional as F

    from mikudance_tpu_torch.kernels import flash_attention as fa
    from mikudance_tpu_torch.kernels import temporal_attention as ta

    g = torch.Generator(device=dev).manual_seed(0)

    def r(*s):
        return torch.randn(s, generator=g, device=dev).to(torch.bfloat16)

    # (kernel, wrapper, plain, shapes of q, k, v, heads[, q scale]); batch =
    # the main path's (2 CFG halves x 16 frames; B=2 for the motion modules;
    # the VAE encode chunk of 8 frames, 4 pictures at 576^2 in training)
    cases = [
        (fa.K1, fa.flash_attention_fullc, fa.anchored_attention_t, [(32, 9216, 320)] * 3, 8),
        (fa.K1, fa.flash_attention_fullc, fa.anchored_attention_t, [(32, 2304, 640)] * 3, 8),
        (fa.K1, fa.flash_attention_fullc, fa.anchored_attention_t, [(8, 2304, 320)] * 3, 8, 3.0),
        # level 2 at 1024^2 (heads of 160), where the clamp bites, and at 1280 x 832
        (fa.K1, fa.flash_attention_fullc, fa.anchored_attention_t, [(32, 1024, 1280)] * 3, 8),
        (fa.K1, fa.flash_attention_fullc, fa.anchored_attention_t, [(8, 1024, 1280)] * 3, 8, 3.0),
        (fa.K1, fa.flash_attention_fullc, fa.anchored_attention_t, [(32, 1040, 1280)] * 3, 8),
        # SDXL at 1024^2: heads of 64, 10 at level 1 and 20 at level 2; the clamp biting
        (fa.K1, fa.flash_attention_fullc, fa.anchored_attention_t, [(32, 4096, 640)] * 3, 10),
        (fa.K1, fa.flash_attention_fullc, fa.anchored_attention_t, [(32, 1024, 1280)] * 3, 20),
        (fa.K1, fa.flash_attention_fullc, fa.anchored_attention_t, [(8, 1024, 1280)] * 3, 20,
         3.0),
        (fa.K2, fa.cross_attention, fa.dot_product_attention,
         [(32, 9216, 320), (32, 257, 320), (32, 257, 320)], 8),
        (fa.K2, fa.cross_attention, fa.dot_product_attention,
         [(32, 2304, 640), (32, 257, 640), (32, 257, 640)], 8),
        # request F's levels: 20 frames at 576^2
        (fa.K2, fa.cross_attention, fa.dot_product_attention,
         [(20, 5184, 320), (20, 257, 320), (20, 257, 320)], 8),
        (fa.K2, fa.cross_attention, fa.dot_product_attention,
         [(20, 1296, 640), (20, 257, 640), (20, 257, 640)], 8),
        # heads of 160 (level 2 at 1024^2): the CLIP context in one chunk of
        # keys, the most keys K2 takes (two chunks), a text context
        (fa.K2, fa.cross_attention, fa.dot_product_attention,
         [(32, 1024, 1280), (32, 257, 1280), (32, 257, 1280)], 8),
        (fa.K2, fa.cross_attention, fa.dot_product_attention,
         [(2, 1024, 1280), (2, 512, 1280), (2, 512, 1280)], 8),
        (fa.K2, fa.cross_attention, fa.dot_product_attention,
         [(32, 1024, 1280), (32, 77, 1280), (32, 77, 1280)], 8),
        # SDXL at 1024^2: heads of 64 against the 257 image tokens, levels 1 and 2
        (fa.K2, fa.cross_attention, fa.dot_product_attention,
         [(32, 4096, 640), (32, 257, 640), (32, 257, 640)], 10),
        (fa.K2, fa.cross_attention, fa.dot_product_attention,
         [(32, 1024, 1280), (32, 257, 1280), (32, 257, 1280)], 20),
        # K3 and K13 are held to the TPU bodies' function (q' and P rounded to
        # bf16), temporal_attention_rounded
        (ta.K3, ta.temporal_attention, ta.temporal_attention_rounded, [(2, 16, 9216, 320)] * 3, 8),
        (ta.K3, ta.temporal_attention, ta.temporal_attention_rounded, [(2, 16, 2304, 640)] * 3, 8),
        (ta.K3, ta.temporal_attention, ta.temporal_attention_rounded, [(2, 16, 576, 1280)] * 3, 8),
        (ta.K3, ta.temporal_attention, ta.temporal_attention_rounded, [(2, 16, 144, 1280)] * 3, 8),
        # the 30-frame windows of a long clip: one window, and four at 256^2
        (ta.K3, ta.temporal_attention, ta.temporal_attention_rounded, [(1, 30, 9216, 320)] * 3, 8),
        (ta.K3, ta.temporal_attention, ta.temporal_attention_rounded, [(4, 30, 1024, 320)] * 3, 8),
        # request F's 20-frame clip at level 0; 32 frames at heads of 160; one frame
        (ta.K3, ta.temporal_attention, ta.temporal_attention_rounded, [(1, 20, 5184, 320)] * 3, 8),
        (ta.K3, ta.temporal_attention, ta.temporal_attention_rounded, [(1, 32, 576, 1280)] * 3, 8),
        (ta.K3, ta.temporal_attention, ta.temporal_attention_rounded, [(2, 1, 2304, 640)] * 3, 8),
        # request K, one rank of B's geometry on (win 2, frame 2): after the
        # motion modules' all_to_all a rank holds every frame of half the
        # positions of one CFG half
        (ta.K3, ta.temporal_attention, ta.temporal_attention_rounded, [(1, 16, 4608, 320)] * 3, 8),
        (ta.K3, ta.temporal_attention, ta.temporal_attention_rounded, [(1, 16, 1152, 640)] * 3, 8),
        (ta.K3, ta.temporal_attention, ta.temporal_attention_rounded, [(1, 16, 288, 1280)] * 3, 8),
        (ta.K3, ta.temporal_attention, ta.temporal_attention_rounded, [(1, 16, 72, 1280)] * 3, 8),
        # request L1, one rank of the stage-2 step on (data 1, frame 4) at 576^2:
        # after the all_to_all a rank holds all 20 frames of a quarter of the
        # positions of levels 0-2 (5184, 1296, 324 -> 1296, 324, 81); the 9 x 9
        # level gathers the frames (81 % 4 != 0), the last shape again
        (ta.K3, ta.temporal_attention, ta.temporal_attention_rounded, [(1, 20, 1296, 320)] * 3, 8),
        (ta.K3, ta.temporal_attention, ta.temporal_attention_rounded, [(1, 20, 324, 640)] * 3, 8),
        (ta.K3, ta.temporal_attention, ta.temporal_attention_rounded, [(1, 20, 81, 1280)] * 3, 8),
        (fa.K4, fa.flash_attention_wide, fa.dot_product_attention, [(8, 9216, 512)] * 3, 1),
        (fa.K4, fa.flash_attention_wide, fa.dot_product_attention, [(4, 5184, 512)] * 3, 1),
        # the VAE encoder's chunk of 8 frames at 1024^2 (request H)
        (fa.K4, fa.flash_attention_wide, fa.dot_product_attention, [(8, 16384, 512)] * 3, 1),
        # the VAE mid-block under 512^2: 256^2, 384^2, the largest S K9 takes,
        # and a ragged S (a 33 x 35 latent map)
        (fa.K9, fa.flash_attention_resident, fa.dot_product_attention, [(8, 1024, 512)] * 3, 1),
        (fa.K9, fa.flash_attention_resident, fa.dot_product_attention, [(8, 2304, 512)] * 3, 1),
        (fa.K9, fa.flash_attention_resident, fa.dot_product_attention, [(8, 3072, 512)] * 3, 1),
        (fa.K9, fa.flash_attention_resident, fa.dot_product_attention, [(2, 1155, 512)] * 3, 1),
        # the UNet mid-block on a 4 x 4 map (256^2, four 30-frame windows),
        # then the other head widths, 32 tokens, T off the multiples of 8
        (ta.K13, ta.small_sequence_attention, ta.small_sequence_attention_rounded,
         [(120, 16, 1280)] * 3, 8),
        (ta.K13, ta.small_sequence_attention, ta.small_sequence_attention_rounded,
         [(64, 32, 320)] * 3, 8),
        (ta.K13, ta.small_sequence_attention, ta.small_sequence_attention_rounded,
         [(256, 16, 640)] * 3, 8),
        (ta.K13, ta.small_sequence_attention, ta.small_sequence_attention_rounded,
         [(64, 30, 1280)] * 3, 8),
        (ta.K13, ta.small_sequence_attention, ta.small_sequence_attention_rounded,
         [(64, 20, 640)] * 3, 8),
        (ta.K13, ta.small_sequence_attention, ta.small_sequence_attention_rounded,
         [(64, 1, 320)] * 3, 8),
    ]
    for kern, fn, plain, shapes, heads, *q_scale in cases:
        if not wanted(kern, only):
            continue
        q, k, v = (r(*s) for s in shapes)
        what = f"{kern.name} q{shapes[0]} kv{shapes[1][1]} heads {heads}"
        if q_scale:
            q = (q.float() * q_scale[0]).to(torch.bfloat16)
        if kern is fa.K1:
            excursion = fa.anchor_excursion(q[:1], k[:1], heads)
            check((excursion > fa.EXP_CLAMP) == bool(q_scale),
                  f"{what}: largest |s - off| {excursion:.1f} with q x {q_scale}")
            what += f" q x {q_scale[0] if q_scale else 1.0} (largest |s - off| {excursion:.1f}"
            if q_scale:  # the exact softmax is another function here
                apart = rel_l2(fa.dot_product_attention(q, k, v, heads), plain(q, k, v, heads))
                check(apart > REL_L2, f"{what}: the softmax and K1's function agree")
                what += f"; the exact softmax against it: relative L2 {apart:.3e}"
            what += f"; exp2 floor {exp2_floor_ms(q.shape[0] * heads * q.shape[1] ** 2):.3f} ms)"
        if kern in (ta.K3, ta.K13):  # the CPU route's function (fp32 q', P) differs
            cpu_route = (ta.temporal_attention_plain if kern is ta.K3
                         else ta.small_sequence_attention_plain)
            what += (f" (the CPU route's plain version against the kernel: relative L2 "
                     f"{rel_l2(fn(q, k, v, heads), cpu_route(q, k, v, heads)):.3e}")
            if kern is ta.K13:  # host and device time a call, the library's device time
                host, device = host_and_device_ms(lambda: fn(q, k, v, heads))
                lib_host, lib_device = host_and_device_ms(
                    lambda: F.scaled_dot_product_attention(
                        *(t.view(t.shape[0], t.shape[1], heads, -1).transpose(1, 2)
                          for t in (q, k, v))))
                what += (f"; host {host:.4f} ms a call, device {device:.4f} ms; library host "
                         f"{lib_host:.4f}, device {lib_device:.4f} ms")
            what += ")"
        C = q.shape[-1]
        hd = C // heads
        if q.ndim == 4:  # K3: one T x T attention per (batch, position, head)
            B, T, P, _ = q.shape
            flops = 4 * B * P * T * T * C
            lib = [t.reshape(B, T, P, heads, hd).permute(0, 2, 3, 1, 4)
                   .reshape(B * P, heads, T, hd).contiguous() for t in (q, k, v)]
        else:
            flops = 4 * q.shape[0] * q.shape[1] * k.shape[1] * C
            lib = [t.view(t.shape[0], t.shape[1], heads, hd).transpose(1, 2) for t in (q, k, v)]
        if kern in (ta.K3, ta.K13) and k.shape[-3 if k.ndim == 4 else 1] == 1:
            # one token: softmax is 1 whatever the scale, o = v; the control
            # reads v's channels shifted by one
            def control(q=q, k=k, v=v, heads=heads, plain=plain):
                return plain(q, k, v.roll(1, -1), heads)
        else:
            def control(q=q, k=k, v=v, heads=heads, plain=plain):
                return plain(q * CONTROL_Q_SCALE, k, v, heads)
        yield (kern, what,
               lambda: fn(q, k, v, heads), lambda: plain(q, k, v, heads), control,
               lambda: F.scaled_dot_product_attention(*lib),
               flops, 2 * (2 * q.numel() + k.numel() + v.numel()), PEAK_BF16)


def norm_cases(dev, only=()):
    """K5 and K6 at the shapes the UNets, the VAEs (the temporal decoder's
    joint norm over 16 frames included) and the CLIP tower give them."""
    import torch.nn.functional as F

    from mikudance_tpu_torch.kernels import group_norm as gn
    from mikudance_tpu_torch.kernels import layer_norm as ln

    g = torch.Generator(device=dev).manual_seed(1)
    eps, groups = 1e-6, 32
    group_norm_shapes = (((32, 96, 96, 320), True), ((32, 96, 96, 960), False),
                         ((32, 96, 96, 640), False), ((32, 48, 48, 640), True),
                         ((32, 24, 24, 1280), False), ((32, 12, 12, 2560), False),
                         ((8, 768, 768, 128), True), ((1, 12288, 768, 128), True))
    for shape, silu in group_norm_shapes if wanted(gn.K5, only) else ():
        x = norm_input(shape, g, dev)
        w, b = (torch.randn(shape[-1], generator=g, device=dev) for _ in range(2))

        def library(x=x, w=w.bfloat16(), b=b.bfloat16(), silu=silu):
            y = F.group_norm(x.permute(0, 3, 1, 2), groups, w, b, eps)
            return F.silu(y) if silu else y

        def run(x=x, w=w, b=b, silu=silu):
            return gn.fused_group_norm(x, w, b, groups, eps, silu)

        parts = None
        if shape == (32, 12, 12, 2560):  # a call that costs its host time
            parts = {"the wrapper": run, "checks": lambda: gn._check_operands(x, w, b, groups),
                     "empty_like": lambda: torch.empty_like(x),
                     "current_stream": lambda: torch.cuda.current_stream(x.device).cuda_stream,
                     "library": library}
        images, rows, C = shape[0], math.prod(shape[1:-1]), shape[-1]
        plan, held = gn.plan_for(x.device.index, images, rows, C, groups, False, True, silu)
        variant = (f"variant R, clusters of {plan.cluster}, slab {plan.slab}, {plan.smem} B "
                   f"a block, cudaOccupancyMaxActiveClusters {held}" if plan.variant == "R" else
                   f"variant S, slab {plan.slab}, {plan.splits} splits, {plan.apply_blocks} "
                   "apply blocks an image")
        smallest = gn.group_norm_plan(images, rows, C, groups, 2, aligned=False)
        if smallest != plan and (smallest.variant == "S" or gn.max_active_clusters(
                smallest, False, True, silu)):  # the slab of whole sectors against the smallest
            _, chosen = host_and_kernels_ms(run, 10)
            _, other = host_and_kernels_ms(lambda x=x, w=w, b=b, silu=silu, other=smallest: (
                gn.launch(x, w, b, groups, eps, silu, other)), 10)
            variant += (f"; device {sum(chosen.values()):.4f} ms a call against "
                        f"{sum(other.values()):.4f} with the smallest slab ({smallest.slab}, "
                        f"{smallest.variant}{smallest.cluster or ''})")
        yield (gn.K5, f"{gn.K5.name} x{shape} silu {silu} ({variant}; "
                      f"{norm_split(run, parts)})", run,
               lambda x=x, w=w, b=b, silu=silu: gn.group_norm_plain(x, w, b, groups, eps, silu),
               lambda x=x, w=w, b=b, silu=silu: gn.group_norm_plain(x, w, b, CONTROL_GROUPS,
                                                                     eps, silu),
               library, 8 * x.numel(), 2 * 2 * x.numel(), PEAK_FP32)
        del x
    layer_norm_shapes = ((32, 9216, 320), (32, 2304, 640), (32, 576, 1280), (2, 16, 9216, 320),
                         (1, 257, 1024))
    for shape in layer_norm_shapes if wanted(ln.K6, only) else ():
        x = norm_input(shape, g, dev, row_offset=True)
        C = shape[-1]
        w, b = (torch.randn(C, generator=g, device=dev) for _ in range(2))

        def control(x=x, w=w, b=b, C=C):  # statistics divided by the wrong count
            xf = x.float()
            mu = xf.sum(-1, keepdim=True) / (C * CONTROL_WIDTH)
            var = xf.square().sum(-1, keepdim=True) / (C * CONTROL_WIDTH) - mu.square()
            return ((xf - mu) * torch.rsqrt(var + 1e-5) * w + b).to(x.dtype)

        run = lambda x=x, w=w, b=b: ln.fused_layer_norm(x, w, b, 1e-5)  # noqa: E731
        library = lambda x=x, w=w.bfloat16(), b=b.bfloat16(), C=C: F.layer_norm(  # noqa: E731
            x, (C,), w, b, 1e-5)
        parts = None
        if shape == (1, 257, 1024):  # a call that costs its host time
            y = torch.empty_like(x)
            lanes, _, vectors = ln.lane_plan(C, 8)
            stream = torch.cuda.current_stream(x.device).cuda_stream
            parts = {"the wrapper": run, "checks": lambda: ln._check_operands(x, w, b),
                     "empty_like": lambda: torch.empty_like(x),
                     "current_stream": lambda: torch.cuda.current_stream(x.device).cuda_stream,
                     "current_stream(index)": lambda: torch.cuda.current_stream(
                         x.device.index).cuda_stream,
                     "the launch": lambda: ln.K6.launch(
                         x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), 257, C, lanes,
                         vectors, 1e-5, False, True, stream),
                     "library": library}
        yield (ln.K6, f"{ln.K6.name} x{shape} ({norm_split(run, parts)}; library: "
                      f"{norm_split(library)})", run,
               lambda x=x, w=w, b=b: ln.layer_norm_plain(x, w, b, 1e-5), control, library,
               8 * x.numel(), 2 * 2 * x.numel(), PEAK_FP32)
        del x


def anchored_cases(dev, only=()):
    """K10 and K11, each at both UNet levels (first the one the byte rule gives
    it) and on an input where the clamp bites: q three times as large, so
    that many rows' scores all lie more than 100 log2 units under the anchor;
    K12 at the trainer's and the sampler's level 0, heads of 80, the clamp.
    The three are one kernel (``csrc/flash_anchor_wg.cu``) under three entry
    points."""
    import torch.nn.functional as F

    from mikudance_tpu_torch.kernels import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(2)
    level0, level1 = (32, 9216, 320), (32, 2304, 640)
    cases = [(fa.K10, fa.flash_anchor_resident, level1, 1.0),
             (fa.K10, fa.flash_anchor_resident, level0, 1.0),
             (fa.K10, fa.flash_anchor_resident, (8, 2304, 640), 3.0),
             # the transposed trainer's level 1 (request F, 20 frames at 576^2)
             (fa.K10, fa.flash_anchor_resident, (20, 1296, 640), 1.0),
             (fa.K11, fa.flash_anchor_stream, level0, 1.0),
             (fa.K11, fa.flash_anchor_stream, level1, 1.0),
             (fa.K11, fa.flash_anchor_stream, (8, 2304, 320), 3.0),
             # K12: the 576^2 trainer's level 0 (5184 = 40.5 x 128 tokens), the
             # 768^2 level beside K1 and K11, heads of 80 on a ragged S, the clamp
             (fa.K12, fa.flash_attention_fullc_t, TRAIN_LEVEL0, 1.0),
             (fa.K12, fa.flash_attention_fullc_t, level0, 1.0),
             (fa.K12, fa.flash_attention_fullc_t, (20, 1296, 640), 1.0),
             (fa.K12, fa.flash_attention_fullc_t, (8, 2304, 320), 3.0),
             # K10 with an odd number of heads of 40: the last one has no partner
             (fa.K10, fa.flash_anchor_resident, (8, 2304, 120), 1.0, 3),
             # heads of 160: level 2 at 1024^2 (resident: K10 in the row-major
             # configuration; K11 on the same shape), the transposed
             # configuration's level 2 at 1280^2 (1600 tokens, above the limit)
             (fa.K10, fa.flash_anchor_resident, (32, 1024, 1280), 1.0),
             (fa.K11, fa.flash_anchor_stream, (32, 1024, 1280), 1.0),
             (fa.K12, fa.flash_attention_fullc_t, (20, 1600, 1280), 1.0)]
    check(fa.fullc_resident(2304, 640, 8) and not fa.fullc_resident(9216, 320, 8)
          and fa.fullc_resident(1024, 1280, 8) and not fa.fullc_resident(1600, 1280, 8),
          "the byte rule gives K10 the 2304- and 1024-token levels, K11 / K12 the 9216- and "
          "1600-token levels")
    for kern, fn, shape, q_scale, *heads in cases:
        if not wanted(kern, only):
            continue
        heads = heads[0] if heads else 8
        q, k, v = (torch.randn(shape, generator=g, device=dev) for _ in range(3))
        q, k, v = (q * q_scale).to(torch.bfloat16), k.to(torch.bfloat16), v.to(torch.bfloat16)
        hd = shape[-1] // heads
        lib = [t.view(t.shape[0], t.shape[1], heads, hd).transpose(1, 2) for t in (q, k, v)]
        excursion = fa.anchor_excursion(q[:1], k[:1], heads)
        check((excursion > fa.EXP_CLAMP) == (q_scale > 1.0),
              f"{kern.name} {shape}: largest |s - off| {excursion:.1f} with q x {q_scale}")
        plain = fa.anchored_attention_t if kern is fa.K12 else fa.anchored_attention
        what = (f"{kern.name} q{shape} heads {heads} q x {q_scale} (largest |s - off| "
                f"{excursion:.1f}; exp2 floor "
                f"{exp2_floor_ms(shape[0] * heads * shape[1] ** 2):.3f} ms")
        if kern is fa.K12 and q_scale > 1.0:
            # the anchor rounded to bf16 moves which scores the clamp clips:
            # here K12's function is no longer K10 / K11's
            apart = rel_l2(plain(q, k, v, heads), fa.anchored_attention(q, k, v, heads))
            check(apart > 0.0, f"{kern.name} {shape}: its plain version equals K10 / K11's "
                               "on an input where the clamp bites")
            what += f"; plain version against K10 / K11's: relative L2 {apart:.3e}"
        yield (kern, what + ")",
               lambda: fn(q, k, v, heads), lambda: plain(q, k, v, heads),
               lambda: plain(q * CONTROL_Q_SCALE, k, v, heads),
               lambda: F.scaled_dot_product_attention(*lib),
               4 * shape[0] * shape[1] * shape[1] * shape[2], 2 * 4 * q.numel(), PEAK_BF16)


# fp32 requests through the attention kernels, one model shape a kernel: (kernel,
# wrapper, rounded plain version, q shape, k / v shape, heads)
FP32_CASES = (
    ("K1", "flash_attention_fullc", "anchored_attention_t", (32, 9216, 320), None, 8),
    ("K2", "cross_attention", "cross_attention_rounded", (32, 9216, 320), (32, 257, 320), 8),
    ("K3", "temporal_attention", "temporal_attention_rounded", (2, 16, 9216, 320), None, 8),
    ("K4", "flash_attention_wide", "wide_attention_rounded", (8, 9216, 512), None, 1),
    ("K9", "flash_attention_resident", "wide_attention_rounded", (8, 2304, 512), None, 1),
    ("K10", "flash_anchor_resident", "anchored_attention", (32, 2304, 640), None, 8),
    ("K11", "flash_anchor_stream", "anchored_attention", (32, 9216, 320), None, 8),
    ("K12", "flash_attention_fullc_t", "anchored_attention_t", (32, 9216, 320), None, 8),
    ("K13", "small_sequence_attention", "small_sequence_attention_rounded", (120, 16, 1280),
     None, 8),
    # request J's narrow heads: the tiny VAE's mid-block (one head of 32 at 768^2,
    # an encode chunk of 8 frames) and the tiny twins' motion modules (heads of 8
    # and 24, windows of 3 frames at 128^2)
    ("K1", "flash_attention_fullc", "anchored_attention_t", (8, 9216, 32), None, 1),
    ("K3", "temporal_attention", "temporal_attention_rounded", (2, 3, 256, 32), None, 4),
    ("K3", "temporal_attention", "temporal_attention_rounded", (2, 3, 256, 96), None, 4),
)
# fp32 against the same kernel fed bf16-rounded q (the anchored kernels): the
# rounded q must land at least this many times farther from the rounded plain
# version on fp32 q than the fp32 kernel does, or the kernel did not read the
# unrounded q (q' and the anchor)
FP32_ROUNDED_Q_RATIO = 4.0


def fp32_cases(dev, only=()):
    """K1-K4 and K9-K13 on fp32 q, k and v (N(0, 1), which bf16 does not hold
    exactly) at one model shape each, held to the plain version that rounds
    where the TPU body does (the anchored functions with the anchor from the
    unrounded q; ``cross_attention_rounded``; ``temporal_attention_rounded``;
    ``wide_attention_rounded``); the output must be fp32. The bound counts 4
    bytes for q and o and 2 for k and v (the wrappers' casts are part of the
    timed call); the library call is ``scaled_dot_product_attention`` on the
    same fp32 tensors. The anchored kernels also run on bf16-rounded q, which
    must land measurably farther from the plain version (``FP32_ROUNDED_Q_RATIO``)."""
    import torch.nn.functional as F

    from mikudance_tpu_torch.kernels import flash_attention as fa
    from mikudance_tpu_torch.kernels import temporal_attention as ta

    g = torch.Generator(device=dev).manual_seed(11)
    for name, wrapper, plain_name, q_shape, kv_shape, heads in FP32_CASES:
        mod = ta if wrapper in ("temporal_attention", "small_sequence_attention") else fa
        kern = getattr(ta if name in ("K3", "K13") else fa, name)
        if not wanted(kern, only):
            continue
        fn, plain = getattr(mod, wrapper), getattr(mod, plain_name)
        q = torch.randn(q_shape, generator=g, device=dev)
        k, v = (torch.randn(kv_shape or q_shape, generator=g, device=dev) for _ in range(2))
        what = f"{kern.name} fp32 q{q_shape} kv{(kv_shape or q_shape)[-2]} heads {heads}"
        out = fn(q, k, v, heads)
        check(out.dtype == torch.float32 and out.shape == q.shape,
              f"{what}: output {out.dtype} {tuple(out.shape)}")
        if name in ("K1", "K10", "K11", "K12"):
            want = plain(q, k, v, heads)
            rel = rel_l2(out, want)
            rel_rounded = rel_l2(fn(q.bfloat16().float(), k, v, heads), want)
            check(rel_rounded > FP32_ROUNDED_Q_RATIO * rel,
                  f"{what}: the kernel on bf16-rounded q lies {rel_rounded:.3e} from the plain "
                  f"version on fp32 q, the kernel on fp32 q {rel:.3e}")
            what += f" (on bf16-rounded q: relative L2 {rel_rounded:.3e} against {rel:.3e})"
            del want
        del out
        C = q.shape[-1]
        hd = C // heads
        if q.ndim == 4:
            B, T, P, _ = q.shape
            flops = 4 * B * P * T * T * C
            lib = [t.reshape(B, T, P, heads, hd).permute(0, 2, 3, 1, 4)
                   .reshape(B * P, heads, T, hd).contiguous() for t in (q, k, v)]
        else:
            flops = 4 * q.shape[0] * q.shape[1] * k.shape[1] * C
            lib = [t.view(t.shape[0], t.shape[1], heads, hd).transpose(1, 2) for t in (q, k, v)]
        yield (kern, what,
               lambda fn=fn, q=q, k=k, v=v, heads=heads: fn(q, k, v, heads),
               lambda plain=plain, q=q, k=k, v=v, heads=heads: plain(q, k, v, heads),
               lambda plain=plain, q=q, k=k, v=v, heads=heads: plain(q * CONTROL_Q_SCALE, k, v,
                                                                     heads),
               lambda lib=lib: F.scaled_dot_product_attention(*lib),
               flops, 4 * 2 * q.numel() + 2 * (k.numel() + v.numel()), PEAK_BF16)


def linear_cases(dev, only=()):
    """K7 at the chain's products: (rows, Cin, Cout, residual); the control
    leaves out the residual where there is one, else the bias."""
    import torch.nn.functional as F

    from mikudance_tpu_torch.kernels import linear as lin

    g = torch.Generator(device=dev).manual_seed(3)
    shapes = ((294912, 320, 320, False), (294912, 320, 320, True), (294912, 320, 2560, False),
              (294912, 1280, 320, True), (18432, 1280, 10240, False), (4321, 640, 640, True),
              (4321, 640, 136, True))  # the last: tiles of 128, the second column tile masked
    for rows, cin, cout, with_res in shapes if wanted(lin.K7, only) else ():
        x = torch.randn((rows, cin), generator=g, device=dev).to(torch.bfloat16)
        w = (torch.randn((cout, cin), generator=g, device=dev) / math.sqrt(cin)).to(torch.bfloat16)
        b = torch.randn(cout, generator=g, device=dev).to(torch.bfloat16)
        r = (torch.randn((rows, cout), generator=g, device=dev).to(torch.bfloat16)
             if with_res else None)

        def library(x=x, w=w, b=b, r=r):
            y = F.linear(x, w, b)
            return y if r is None else y + r

        yield (lin.K7, f"{lin.K7.name} x({rows}, {cin}) -> {cout}"
                       + (" + residual" if with_res else ""),
               lambda x=x, w=w, b=b, r=r: lin.fused_linear(x, w, b, r),
               lambda x=x, w=w, b=b, r=r: lin.linear_plain(x, w, b, r),
               lambda x=x, w=w, b=b, r=r: lin.linear_plain(x, w, b if with_res else None, None),
               library, 2 * rows * cin * cout,
               2 * (rows * cin + cin * cout + cout + rows * cout * (2 if with_res else 1)),
               PEAK_BF16)
        del x, r


def conv_cases(dev, only=()):
    """K8 at convolutions of the UNets (down path, an up-path width change, the
    widest up-path input), of the VAE at 768^2, and the widest up-path input
    of one image (its 24 rows not a multiple of the box's 16); the control
    runs the plain version with the taps transposed."""
    import torch.nn.functional as F

    from mikudance_tpu_torch.kernels import conv2d as cv

    g = torch.Generator(device=dev).manual_seed(4)
    shapes = (((32, 96, 96, 320), 320), ((32, 48, 48, 1280), 640), ((32, 24, 24, 2560), 1280),
              ((8, 768, 768, 128), 128),
              ((1, 24, 24, 2560), 1280))  # 8 x 16 boxes, the last half-empty
    for shape, cout in shapes if wanted(cv.K8, only) else ():
        cin = shape[-1]
        x = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
        w = (torch.randn((cout, cin, 3, 3), generator=g, device=dev)
             / math.sqrt(9 * cin)).to(torch.bfloat16)
        b = torch.randn(cout, generator=g, device=dev).to(torch.bfloat16)
        packed = cv.pack_weight(w)  # as the model path keeps it: packed once

        def library(x=x.permute(0, 3, 1, 2), w=w.contiguous(memory_format=torch.channels_last),
                    b=b):
            return F.conv2d(x, w, b, padding=1)

        yield (cv.K8, f"{cv.K8.name} x{shape} -> {cout}",
               lambda x=x, w=w, b=b, packed=packed: cv.conv3x3_fused(x, w, b, packed),
               lambda x=x, w=w, b=b: cv.conv3x3_plain(x, w, b),
               lambda x=x, w=w, b=b: cv.conv3x3_plain(x, w.transpose(2, 3), b),
               library, 2 * 9 * x.numel() * cout,
               2 * (x.numel() + w.numel() + cout + x.numel() // cin * cout), PEAK_BF16)
        del x


def mega_inputs(dev, level, seed: int = 5):
    """The probe's inputs at one of its levels, (B, S, C): bank K/V and context
    K/V N(0, 0.5), the 257 context rows padded with zeros to 320, and a seeded
    ``TransformerBlock`` of that width whose weights the probe and the block's
    read path share. The hidden states are N(0, 0.1), not the probe's N(0, 1):
    LayerNorm makes the sublayers blind to their scale, so this only shrinks
    the residual that the output carries along, and a wrong sublayer (the
    control: the bank K/V left out) moves the output by 2e-1 and not 2e-2."""
    from mikudance_tpu_torch.kernels import mega_block as mb
    from mikudance_tpu_torch.models import layers

    B, S, C = level
    g = torch.Generator(device=dev).manual_seed(seed)

    def r(*s, scale=1.0):
        return (torch.randn(s, generator=g, device=dev) * scale).to(torch.bfloat16)

    (block,) = seeded_modules(seed, dev, lambda: [layers.TransformerBlock(C, mb.HEADS)])
    x, rk, rv = r(B, S, C, scale=0.1), r(B, S, C, scale=0.5), r(B, S, C, scale=0.5)
    ck, cv = (torch.zeros(B, 320, C, dtype=torch.bfloat16, device=dev) for _ in range(2))
    ck[:, :mb.CTX_LEN], cv[:, :mb.CTX_LEN] = (r(B, mb.CTX_LEN, C, scale=0.5) for _ in range(2))
    return block, (x, rk, rv, ck, cv), mb.weights_from_block(block)


def block_read_path(block, x, rk, rv, ck, cv):
    """What the probe spans, through the port's ``TransformerBlock`` as the
    denoising UNet calls it (K6, library products, K1, K2)."""
    from mikudance_tpu_torch.kernels import mega_block as mb

    ctx_kv = (ck[:, :mb.CTX_LEN].contiguous(), cv[:, :mb.CTX_LEN].contiguous())

    def run():
        with torch.inference_mode():
            return block(x, None, ref_kv=(rk, rv), ctx_kv=ctx_kv)[0]

    return run


MEGA_LEVELS = ((32, 2304, 640), (32, 576, 1280), (32, 9216, 320))  # the probe's own, mid, big
MEGA_CHUNKS = (1, 2, 4, 8, 32)  # the chunk table: batch elements a pass of K14's phases


def mega_split_text(ins, w) -> str:
    """K14's device time by phase under its plan, from the %globaltimer
    stamps block 0 writes after each of its grid barriers (one launch, not
    counted as a path's: the counts are read before or reset after)."""
    from mikudance_tpu_torch.kernels import _mega_plan
    from mikudance_tpu_torch.kernels import mega_block as mb

    plan = _mega_plan.mega_plan(*ins[0].shape)
    stamps = torch.zeros(2 + _mega_plan.BARRIERS_PER_CHUNK * plan.chunks, dtype=torch.int64,
                         device=ins[0].device)
    mb.launch_planned(*ins, w, plan=plan, stamps=stamps)
    split = mb.phase_split(stamps.cpu(), plan.chunks)
    total = sum(split.values())
    return (f"chunk {plan.chunk} x {plan.chunks}, {plan.barriers} barriers, scratch "
            f"{plan.scratch_bytes / 2**20:.1f} MiB; by phase {total:.3f} ms: "
            + ", ".join(f"{k} {v:.3f} ({100 * v / total:.0f}%)" for k, v in split.items()))


def mega_chunk_table(ins, w, rounds: int = 2) -> str:
    """K14's time at each chunk of ``MEGA_CHUNKS`` (capped at the batch),
    the chunks in turns, forwards then backwards, ``rounds`` times; the
    median of each chunk's readings."""
    from mikudance_tpu_torch.kernels import _mega_plan
    from mikudance_tpu_torch.kernels import mega_block as mb

    B, S, C = ins[0].shape
    plans = {c: _mega_plan.mega_plan(B, S, C, c) for c in sorted({min(c, B) for c in MEGA_CHUNKS})}
    times = {c: [] for c in plans}
    for r in range(rounds):
        for c in (list(plans) if r % 2 == 0 else list(plans)[::-1]):
            times[c].append(cuda_ms(lambda: mb.launch_planned(*ins, w, plan=plans[c]), 3))
    return ", ".join(f"chunk {c} ({plans[c].barriers} barriers) "
                     f"{float(np.median(times[c])):.3f} ms" for c in plans)


# K15's (rows, I) at the denoiser's four levels (16 frames at 768^2, CFG
# batch 32): its input is the feed-forward projection's (rows, 2I) output
GEGLU_SHAPES = ((294912, 1280), (73728, 2560), (18432, 5120), (4608, 5120))


def geglu_cases(dev, only=()):
    """K15 at the four levels in bf16, then level 0 in fp32; plain: the two
    ATen passes the port ran before (gelu over the gate half, the product);
    the control swaps the halves. Bound by bytes alone (y read once, the
    output written once); no library call computes it."""
    from mikudance_tpu_torch.kernels import geglu as gg

    g = torch.Generator(device=dev).manual_seed(12)
    cases = [(shape, torch.bfloat16) for shape in GEGLU_SHAPES] + [(GEGLU_SHAPES[0], torch.float32)]
    for (rows, half), dtype in cases if wanted(gg.K15, only) else ():
        y = (torch.randn((rows, 2 * half), generator=g, device=dev) * 2).to(dtype)
        fp32 = " fp32" if dtype is torch.float32 else ""
        yield (gg.K15, f"{gg.K15.name}{fp32} x({rows}, {2 * half}) -> ({rows}, {half})",
               lambda y=y: gg.fused_geglu(y), lambda y=y: gg.geglu_plain(y),
               lambda y=y, half=half: gg.geglu_plain(y.roll(half, -1)), None, 0,
               3 * rows * half * y.element_size(), PEAK_FP32)
        del y


def mega_cases(dev, only=()):
    """K14 at the probe's three levels; the control leaves the bank K/V out.
    No single library call computes the block: the read path is timed beside.
    Each level logs its phase split and the chunk table first."""
    from mikudance_tpu_torch.kernels import mega_block as mb

    for level in MEGA_LEVELS if wanted(mb.K14, only) else ():
        block, ins, w = mega_inputs(dev, level)
        x, rk, rv, ck, cv = ins
        log(f"kernels: {mb.K14.name} x{level}: {mega_split_text(ins, w)}")
        log(f"kernels: {mb.K14.name} x{level}: chunk table (in turns): {mega_chunk_table(ins, w)}")
        B, S, C = level
        FF, SC = 4 * C, mb.CTX_LEN
        flops = B * 2 * (4 * S * C * C + 2 * S * S * C + 2 * S * SC * C + 2 * S * C * C
                         + S * C * 2 * FF + S * FF * C)
        nbytes = (2 * (4 * x.numel() + 2 * ck.numel() + sum(w[n].numel() for n in mb.MATRICES))
                  + 4 * sum(w[n].numel() for n in mb.VECTORS))
        zero = torch.zeros_like(rk)
        yield (mb.K14, f"{mb.K14.name} x{level} heads {mb.HEADS} context {SC} of {ck.shape[1]}",
               lambda: mb.mega_block(*ins, w), lambda: mb.mega_block_plain(*ins, w),
               lambda: mb.mega_block_plain(x, zero, zero, ck, cv, w), None, flops, nbytes,
               PEAK_BF16, {"the block's read path": block_read_path(block, *ins)})
        del block, ins, w, x, rk, rv, ck, cv, zero


def train_config_file(stage: str, out_dir: str, **sections) -> str:
    """The repo's ``configs/train/train_<stage>.yaml`` as it is, with the run's
    output under ``out_dir``, a log line every step, no checkpoint, export or
    validation inside these few steps, and ``sections`` merged over its
    sections; written to ``out_dir`` and returned as a path."""
    import yaml

    root = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(root, "configs", "train", f"train_{stage}.yaml")) as f:
        cfg = yaml.safe_load(f)
    never = 10**9
    cfg.update(output_dir=out_dir, log_every=1, checkpointing_steps=never,
               save_model_step_interval=never, validation_steps=never)
    cfg.pop("val", None)
    for name, values in sections.items():
        cfg.setdefault(name, {}).update(values)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"train_{stage}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def run_training(stage: str, n_steps: int, out_dir: str, dev, **sections):
    """The trainer's ``main([...])`` on ``n_steps`` synthetic batches, with a
    clock and a peak-memory reading at the borders of a step's phases: batch
    (host data, VAE and CLIP encoders), forward (``diffusion_loss``), backward,
    optimizer. Returns (the final TrainState, the log's records, {phase:
    [seconds per step]}, {phase: peak GiB}); the first step's batch phase
    holds the build of the networks."""
    import shutil

    from mikudance_tpu_torch.scripts import train_stage1, train_stage2
    from mikudance_tpu_torch.train import steps as tsteps

    shutil.rmtree(out_dir, ignore_errors=True)
    path = train_config_file(stage, out_dir, **sections)
    phases, peaks = defaultdict(list), defaultdict(float)
    clock = {"t": time.perf_counter()}
    torch.cuda.reset_peak_memory_stats(dev)

    def mark(name):
        torch.cuda.synchronize(dev)
        now = time.perf_counter()
        phases[name].append(now - clock["t"])
        peaks[name] = max(peaks[name], torch.cuda.max_memory_allocated(dev) / 2**30)
        torch.cuda.reset_peak_memory_stats(dev)
        clock["t"] = now

    loss_fn, update = tsteps.diffusion_loss, tsteps.Optimizer.update

    def timed_loss(*args, **kwargs):
        mark("batch")
        out = loss_fn(*args, **kwargs)
        mark("forward")
        return out

    def timed_update(self, grads):
        mark("backward")
        fired = update(self, grads)
        mark("optimizer")
        return fired

    tsteps.diffusion_loss, tsteps.Optimizer.update = timed_loss, timed_update
    try:
        main = {"stage1": train_stage1.main, "stage2": train_stage2.main}[stage]
        state = main(["--config", path, "--synthetic", str(n_steps), "--max_steps",
                      str(n_steps)])
    finally:
        tsteps.diffusion_loss, tsteps.Optimizer.update = loss_fn, update
    with open(os.path.join(out_dir, f"train_{stage}_mikudance", "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    check(len(records) == n_steps == state.optimizer.count,
          f"{stage}: {len(records)} log records, {state.optimizer.count} optimizer steps")
    return state, records, dict(phases), dict(peaks)


def training_text(phases, peaks) -> str:
    """First step | later steps (median seconds a phase) | peak GiB a phase."""
    later = {k: float(np.median(v[1:])) for k, v in phases.items() if len(v) > 1}
    first = " ".join(f"{k} {v[0]:.2f}s" for k, v in phases.items())
    return (f"first step (build and warm-up in it): {first} | later steps, median: "
            + " ".join(f"{k} {v:.3f}s" for k, v in later.items())
            + f" = {sum(later.values()):.3f} s a step | peak "
            + " ".join(f"{k} {v:.2f} GiB" for k, v in peaks.items()))


def initial_stage2_weights(dev):
    """The stage-2 trainer's networks as it builds them (seeded random init,
    no files), cast to bf16: what its parameters were before the first step
    (on the host)."""
    from mikudance_tpu_torch.core import loaders

    guide = loaders.load_guidance(None, use_man=True, device=dev)
    den = loaders.load_denoising(None, None, use_motion=True, device=dev)
    out = {f"guide.{k}": v.to(torch.bfloat16).cpu() for k, v in guide.state_dict().items()}
    out.update({f"den.{k}": v.to(torch.bfloat16).cpu() for k, v in den.state_dict().items()})
    return out  # on the host: the runs' peak-memory readings stay their own


def small_train_batch(dev, seed: int, frames: int = 4, size: int = 256):
    """A ready stage-2 batch at a small geometry (no encoders), and its draws."""
    g = torch.Generator(device=dev).manual_seed(seed)
    h = size // 8

    def r(*s, scale=1.0):
        return torch.randn(s, generator=g, device=dev) * scale

    batch = {"latents": r(1, frames, h, h, 4), "cond20": r(1, frames, h, h, 20),
             "motion": r(1, frames, h, h, 2, scale=0.1), "clip_ctx": r(1, 257, 768),
             "uncond": torch.zeros(1, device=dev)}
    draws = {"noise": r(1, frames, h, h, 4), "offset": r(1, 1, 1, 1, 4),
             "t": torch.tensor([400], device=dev)}
    return batch, draws


def loss_and_gradients(state, cfg, schedule, batch, draws):
    """(loss, {name: gradient}) of one loss evaluation on ``state``'s modules."""
    from mikudance_tpu_torch.train import steps as tsteps

    for p in state.trainable.values():
        p.grad = None
    loss, _ = tsteps.diffusion_loss(cfg, schedule, state.guide, state.den, batch, draws=draws)
    loss.backward()
    grads = {n: p.grad.float().clone() for n, p in state.trainable.items() if p.grad is not None}
    for p in state.trainable.values():
        p.grad = None
    return float(loss.detach()), grads


def flat(grads) -> torch.Tensor:
    return torch.cat([g.reshape(-1) for _, g in sorted(grads.items())])


def check_k1_against_k12(dev) -> None:
    """K1 and K12 compute one function (``anchored_attention_t``) and are two
    tags of one kernel (``csrc/flash_anchor_wg.cu``): on the same inputs, at
    each head width and where the clamp bites, their outputs must be
    identical (relative L2 0); K12 with the softmax scale off by 9% is the
    control, which must land above the relative-L2 limit. Both are timed on
    those inputs (median of 5)."""
    from mikudance_tpu_torch.kernels import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(7)
    for shape, q_scale in (((32, 9216, 320), 1.0), ((8, 2304, 320), 3.0), ((32, 2304, 640), 1.0),
                           ((32, 1024, 1280), 1.0)):
        q, k, v = (torch.randn(shape, generator=g, device=dev) for _ in range(3))
        q, k, v = (q * q_scale).to(torch.bfloat16), k.to(torch.bfloat16), v.to(torch.bfloat16)
        k1, k12 = fa.flash_attention_fullc(q, k, v, 8), fa.flash_attention_fullc_t(q, k, v, 8)
        rel = rel_l2(k1, k12)
        ctl = rel_l2(k1, fa.flash_attention_fullc_t(q * CONTROL_Q_SCALE, k, v, 8))
        ms_k1 = cuda_ms(lambda: fa.flash_attention_fullc(q, k, v, 8), 5)
        ms_k12 = cuda_ms(lambda: fa.flash_attention_fullc_t(q, k, v, 8), 5)
        log(f"kernels: K1 against K12 on the same inputs q{shape} heads 8 q x {q_scale}: "
            f"relative L2 {rel:.3e} (identical: {torch.equal(k1, k12)}; control {ctl:.3e}, "
            f"limit {REL_L2}); K1 {ms_k1:.3f} ms, K12 {ms_k12:.3f} ms")
        check(torch.equal(k1, k12) and ctl > REL_L2,
              f"K1 against K12 {shape}: {rel:.3e}, control {ctl:.3e}")
        del q, k, v, k1, k12


def check_k10_against_k11(dev) -> None:
    """K10 and K11 compute one function (``anchored_attention``): both kernels
    on the same inputs, at the 2304-token level, at the 9216-token level (where
    K11 runs) and where the clamp bites, held to each other under the
    relative-L2 limit, and at heads of 160 (level 2 at 1024^2); K11 with the
    softmax scale off by 9% is the control."""
    from mikudance_tpu_torch.kernels import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(8)
    for shape, q_scale in (((32, 2304, 640), 1.0), ((32, 9216, 320), 1.0),
                           ((8, 2304, 640), 3.0), ((32, 1024, 1280), 1.0)):
        q, k, v = (torch.randn(shape, generator=g, device=dev) for _ in range(3))
        q, k, v = (q * q_scale).to(torch.bfloat16), k.to(torch.bfloat16), v.to(torch.bfloat16)
        check((fa.anchor_excursion(q[:1], k[:1], 8) > fa.EXP_CLAMP) == (q_scale > 1.0),
              f"K10 against K11 {shape}: the clamp bites only with q x 3")
        k10 = fa.flash_anchor_resident(q, k, v, 8)
        rel = rel_l2(k10, fa.flash_anchor_stream(q, k, v, 8))
        ctl = rel_l2(k10, fa.flash_anchor_stream(q * CONTROL_Q_SCALE, k, v, 8))
        log(f"kernels: K10 against K11 on the same inputs q{shape} heads 8 q x {q_scale}: "
            f"relative L2 {rel:.3e} (limit {REL_L2}; control {ctl:.3e})")
        check(rel < REL_L2 < ctl, f"K10 against K11 {shape}: {rel:.3e}, control {ctl:.3e}")
        del q, k, v, k10


def ptxas_report(log_text: str, kernels) -> str:
    """ptxas's registers and spills of each instantiation of the named kernels
    (substrings of the mangled entry names), with its integer template
    arguments; their shared memory is dynamic, sized by each source's
    ``Plan``, and ptxas reports only static memory."""
    import re

    lines, out, entry = log_text.splitlines(), [], None
    for line in lines:
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            args = re.match(r"I((?:L[ib]-?\d+E)+)E",
                            name[name.find("ILi"):] if "ILi" in name else "")
            targs = "<" + ", ".join(re.findall(r"L[ib](-?\d+)E", args.group(1))) + ">" if args \
                else ""
            entry = next((k + targs for k in kernels if k in name), None)
        elif entry and ("spill" in line or "Used" in line):
            out.append(f"{entry}: {line.split(':', 1)[-1].strip()}")
            if "Used" in line:
                entry = None
    return "; ".join(out)


def phase_kernels(dev, only=()):
    """Every kernel against its plain version at the paths' shapes. Returns
    the kernel record: per kernel the times at its first shape."""
    import itertools

    from mikudance_tpu_torch.kernels import flash_attention as fa

    if wanted(fa.K1, only) or wanted(fa.K12, only):
        check_k1_against_k12(dev)
    if wanted(fa.K10, only) or wanted(fa.K11, only):
        check_k10_against_k11(dev)
    record = {}
    for kern, what, run, plain, control, library, flops, nbytes, peak, *rest in itertools.chain(
            attention_cases(dev, only), norm_cases(dev, only), anchored_cases(dev, only),
            fp32_cases(dev, only), linear_cases(dev, only), conv_cases(dev, only),
            mega_cases(dev, only), geglu_cases(dev, only)):
        got = run()
        torch.cuda.synchronize()
        want = plain()
        err = (got.float() - want.float()).abs().max().item()
        rel = rel_l2(got, want)
        torch.testing.assert_close(got.float(), want.float(), atol=ATOL, rtol=RTOL,
                                   msg=lambda m: f"{what}: {m}")
        del want
        ctl = rel_l2(got, control())
        check(rel < REL_L2, f"{what}: relative L2 {rel:.3e} >= {REL_L2}")
        check(ctl > REL_L2, f"{what}: the control reads {ctl:.3e}, under the limit "
                            f"{REL_L2}: the check cannot fail")
        if kern.name.startswith("K15"):  # the plain version's arithmetic, step for step
            check(torch.equal(got, plain()), f"{what}: not the plain version's bits")
        if kern.name.startswith(("K5", "K6")):  # no atomics: the same bits on a second run
            check(torch.equal(got, run()), f"{what}: two runs give different bits")
        del got
        ms = cuda_ms(run, 5)
        plain_ms = cuda_ms(plain, 3)
        library_ms = cuda_ms(library, 5) if library is not None else None
        also = {name: cuda_ms(fn, 5) for name, fn in (rest[0] if rest else {}).items()}
        # the least time the card could take: every input read once and every
        # output written once at the memory rate, or the operations at the
        # peak rate of their type, whichever is longer
        t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / peak * 1e3
        bound_ms, bound_by = max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"
        if library is None:
            lib_text = "no library call computes this; " + ", ".join(
                f"{name} {t:.3f} ms" for name, t in also.items())
        else:
            chose = library_kernel_name(library)
            if kern.name.startswith("K4"):  # head width 512: which backend takes it
                chose = f"{chose}; {sdpa_backend_times(library)}"
            lib_text = f"library {library_ms:.3f} ms ({chose})"
        log(f"kernels: {what}: max_abs_err {err:.3e}  rel_l2 {rel:.3e} (limit {REL_L2}; "
            f"control {ctl:.3e})  kernel {ms:.3f} ms  plain {plain_ms:.3f} ms  {lib_text}  "
            f"bound {bound_ms:.3f} ms by {bound_by}")
        if " fp32 " in what:  # the fp32 case's readings, beside the bf16 ones
            record[kern.name].setdefault("fp32", {
                "shape": what.split(" ", 2)[2], "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
                "max_abs_err": err, "rel_l2": rel})
            torch.cuda.empty_cache()
            continue
        # the record keeps each kernel's first (largest) shape's times
        rec = record.setdefault(kern.name, {
            "name": kern.name, "route": "cuda", "source": kern.source,
            "replaces": kern.replaces, "launches": 0, "max_abs_err": 0.0, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "shape": what.split(" ", 2)[2],
            **{name.replace(" ", "_").replace("'", "") + "_ms": t for name, t in also.items()}})
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        torch.cuda.empty_cache()
    return record


def profile_train_step(dev) -> None:
    """One request-F step under torch.profiler: stage 2 at 20 x 576^2 in the
    transposed configuration, on a ready batch (random latents, condition
    stack and tokens of the trainer's shapes; the encoders are not part of the
    step). Wall shares of forward, backward and optimizer between device
    synchronisations, and device time by kernel category."""
    from types import SimpleNamespace

    from mikudance_tpu_torch.core import loaders
    from mikudance_tpu_torch.diffusion.ddim import DDIMSchedule
    from mikudance_tpu_torch.kernels import transposed
    from mikudance_tpu_torch.train import steps as tsteps

    cfg = tsteps.TrainConfig(trainable_substrings=("motion", "man_"))
    schedule = DDIMSchedule.create(beta_schedule="linear")
    state = tsteps.init_train_state(
        cfg, loaders.load_guidance(None, use_man=True, device=dev, remat=True),
        loaders.load_denoising(None, None, use_motion=True, device=dev, remat=True),
        frozen_dtype=torch.bfloat16)
    step = tsteps.make_train_step(cfg, schedule, state)
    batch, _ = small_train_batch(dev, 12, TRAIN_FRAMES, TRAIN_SIZE)
    g = torch.Generator(device=dev).manual_seed(0)
    phases = {}
    loss_fn, update = tsteps.diffusion_loss, tsteps.Optimizer.update
    clock = {}

    def mark(name):
        torch.cuda.synchronize(dev)
        now = time.perf_counter()
        phases[name] = now - clock["t"]
        clock["t"] = now

    def timed_loss(*a, **k):
        mark("before")
        out = loss_fn(*a, **k)
        mark("forward")
        return out

    def timed_update(self, grads):
        mark("backward")
        fired = update(self, grads)
        mark("optimizer")
        return fired

    def one_step(_steps):
        clock["t"] = time.perf_counter()
        step(batch, g)
        return SimpleNamespace(phases={k: v for k, v in phases.items() if k != "before"})

    tsteps.diffusion_loss, tsteps.Optimizer.update = timed_loss, timed_update
    try:
        with transposed():
            one_step(1)  # warm-up
            torch.cuda.reset_peak_memory_stats(dev)
            res = profile_request(one_step, 1)
    finally:
        tsteps.diffusion_loss, tsteps.Optimizer.update = loss_fn, update
    log(profile_text("request F, one stage-2 step (transposed)", 1, res))
    total = sum(res[1].values())
    log("profile: request F shares of the step: " + ", ".join(
        f"{k} {v / total:.1%}" for k, v in res[1].items())
        + f"; peak {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    log("profile: top kernels, request F step (ms, calls, name)")
    for ms, n, name in res[3][:25]:
        log(f"   {ms:10.1f} {n:6d}  {name[:110]}")


def phase_profile(pipe, request_b) -> None:
    """Device time by kernel category of a 2-step and a 20-step request A at
    the headline geometry, per denoise step from their difference, and of a
    20-step request B."""
    def request_a(steps):
        return run_request(pipe, make_inputs(steps, T, H, W), steps)[2]

    request_a(1)  # warm-up
    res = {s: profile_request(request_a, s) for s in (2, 20)}
    for s, r in res.items():
        log(profile_text("request A", s, r))
    s2, s20 = res[2][2], res[20][2]
    per_step = {c: (s20.get(c, 0.0) - s2.get(c, 0.0)) / 18 for c in set(s2) | set(s20)}
    tot = sum(per_step.values())
    log(f"profile: per denoise step ((20-step - 2-step) / 18): {tot:.1f} ms")
    for cat, ms in sorted(per_step.items(), key=lambda kv: -kv[1]):
        log(f"   {cat:44s} {ms:10.1f} ms  {ms / tot:6.1%}")
    log("profile: top kernels, request A, 20 steps (ms, calls, name)")
    for ms, n, name in res[20][3][:30]:
        log(f"   {ms:10.1f} {n:6d}  {name[:110]}")
    del res
    request_b(1)  # warm-up: the CLIP tower, the temporal decoder's convolutions
    res_b = profile_request(lambda steps: request_b(steps)[2], STEPS)
    log(profile_text("request B", STEPS, res_b))
    log("profile: top kernels, request B, 20 steps (ms, calls, name)")
    for ms, n, name in res_b[3][:20]:
        log(f"   {ms:10.1f} {n:6d}  {name[:110]}")
    del res_b
    # request E: request A inside row_major(), per step from 6 and 2 steps
    from mikudance_tpu_torch.kernels import row_major

    with row_major():
        request_a(1)  # warm-up: the packed conv weights
        res_e = {s: profile_request(request_a, s) for s in (2, PROFILE_E_STEPS)}
    for s, r in res_e.items():
        log(profile_text("request E (row-major)", s, r))
    e2, e6 = res_e[2][2], res_e[PROFILE_E_STEPS][2]
    per_step = {c: (e6.get(c, 0.0) - e2.get(c, 0.0)) / (PROFILE_E_STEPS - 2)
                for c in set(e2) | set(e6)}
    tot = sum(per_step.values())
    log(f"profile: request E per denoise step (({PROFILE_E_STEPS}-step - 2-step) / "
        f"{PROFILE_E_STEPS - 2}): {tot:.1f} ms")
    for cat, ms in sorted(per_step.items(), key=lambda kv: -kv[1]):
        log(f"   {cat:44s} {ms:10.1f} ms  {ms / tot:6.1%}")
    log(f"profile: top kernels, request E, {PROFILE_E_STEPS} steps (ms, calls, name)")
    for ms, n, name in res_e[PROFILE_E_STEPS][3][:20]:
        log(f"   {ms:10.1f} {n:6d}  {name[:110]}")


def launch_mismatches(res: dict, kernels, categories=PROFILE_CATEGORIES) -> list:
    """Check (a) of the profiled request: the kernels whose profiler calls
    (their device symbols, by ``categories``' tags) differ from the wrappers'
    launches over the same call."""
    calls = kernel_calls(res["kernels_by_key"], categories)
    return [f"{k.name}: {calls.get(k.name.split(' ')[0], 0)} calls in the profile, "
            f"{res['launches'][k.name]} launches" for k in kernels
            if calls.get(k.name.split(" ")[0], 0) != res["launches"][k.name]]


def profiled_request_a(pipe, kernels, expect) -> dict:
    """Request A at PROFILED_STEPS steps through ``profile_pipeline`` (warm-up,
    steady state, phases, a traced call), checked: (a) each kernel's calls
    in the profile equal its launches over the traced call, K1 at hd 40 and
    80 (control: the category table without K1's tags must fail it); (b) the
    categories add up to the device time of every kernel, "other" under
    OTHER_SHARE of it; (c) each category's depth-3 rows add up to it within
    ROWS_REL; (d) the busy share in (0, 1]; (e) the phases start with
    h2d_normalize and add up to their call's wall within PHASES_REL. Logs the
    report and the elementwise category's rows; returns the result."""
    from mikudance_tpu_torch.scripts.profile_pipeline import profile_pipeline, profile_report

    t0 = time.perf_counter()
    res = profile_pipeline(pipe, make_inputs(0, T, H, W), PROFILED_STEPS, kernels=kernels)
    seconds = time.perf_counter() - t0
    log(f"profiled request A: {T}x{H}x{W} {PROFILED_STEPS} steps, profile_pipeline in "
        f"{seconds:.1f} s (warm-up, steady state, phases, traced call)")
    log(profile_report(res, top=20))
    cats, total = res["categories"], res["total_ms"]
    # (a) against the wrappers' own counters, and its control
    missing = [k.name for k in expect if res["launches"][k.name] == 0]
    stray = [k.name for k in kernels if k not in expect and res["launches"][k.name]]
    check(not missing and not stray, f"profiled request A: kernels not launched {missing}, "
                                     f"launched off the path {stray}")
    wrong = launch_mismatches(res, kernels)
    hd = {w: cats.get(next((c for c, _ in PROFILE_CATEGORIES if c.startswith(f"K1 hd {w} ")),
                           ""), [0.0, 0])[1] for w in (40, 80)}
    control = [c for c in PROFILE_CATEGORIES if not c[0].startswith("K1 ")]
    wrong_ctl = launch_mismatches(res, kernels, control)
    log(f"profiled request A, (a): launches {res['launches']}; profiler calls by the category "
        f"tags {kernel_calls(res['kernels_by_key'])}, K1 at hd 40 / 80 {hd[40]} / {hd[80]}; "
        f"mismatches {wrong}; control, the table without K1's tags: {wrong_ctl}; records of "
        f"the trace's run-in the profiler dropped: {res['run_in_lost']} of {RUN_IN}")
    check(not wrong and hd[40] > 0 and hd[80] > 0, f"profiled request A, (a): {wrong}, K1 {hd}")
    check(any(m.startswith("K1 ") for m in wrong_ctl),
          f"profiled request A, (a)'s control passed: {wrong_ctl}")
    # (b) the categories cover every kernel's time (the profiler's averages by kernel)
    by_key = sum(ms for ms, _, _ in res["kernels_by_key"])
    other = cats.get("other", [0.0, 0])[0]
    log(f"profiled request A, (b): categories {total:.3f} ms, every kernel {by_key:.3f} ms, "
        f"other {other:.3f} ms ({other / total:.2%}, limit {OTHER_SHARE:.0%})")
    check(abs(total - by_key) <= 1e-3 * by_key and other < OTHER_SHARE * total,
          f"profiled request A, (b): {total} against {by_key}, other {other}")
    # (c) each category's rows against its total by kernel
    of_keys = {}
    for ms, _, key in res["kernels_by_key"]:
        of_keys[category(key)] = of_keys.get(category(key), 0.0) + ms
    apart = {c: abs(v[0] - of_keys.get(c, 0.0)) / max(of_keys.get(c, 0.0), 1e-9)
             for c, v in cats.items()}
    rows = [r for r in res["rows"] if r[2] == ELEMENTWISE]
    log(f"profiled request A, (c): {ELEMENTWISE} {cats[ELEMENTWISE][0]:.3f} ms in {len(rows)} "
        f"rows, by kernel {of_keys.get(ELEMENTWISE, 0.0):.3f} ms; largest gap of a category "
        f"{max(apart.values()):.2e} (limit {ROWS_REL}); its top rows (ms, calls, op):")
    for ms, n, _, name in rows[:15]:
        log(f"   {ms:10.3f} {n:6d}  {name[:150]}")
    check(max(apart.values()) < ROWS_REL, f"profiled request A, (c): {apart}")
    # (d) the busy share; (e) the phases
    phases = list(res["phases"])
    gap = abs(sum(res["phases"].values()) - res["phase_wall_s"]) / res["phase_wall_s"]
    log(f"profiled request A, (d): busy {res['busy']:.1%}; (e): phases {phases}, their sum "
        f"{gap:.2%} from the call's wall {res['phase_wall_s']:.3f} s (limit {PHASES_REL:.0%})")
    check(0 < res["busy"] <= 1, f"profiled request A, (d): busy {res['busy']}")
    check(phases[:1] == ["h2d_normalize"] and gap < PHASES_REL,
          f"profiled request A, (e): {phases}, {gap}")
    return res


def phase_text(timer) -> str:
    peaks = getattr(timer, "peaks", None) or {}
    return " ".join(f"{k} {v:.3f}s" + (f" ({peaks[k]:.2f} GiB)" if k in peaks else "")
                    for k, v in timer.phases.items())


def run_request(pipe, inputs, steps: int, decode: bool = True):
    """One ``__call__`` (decode to the host, or the latents alone); returns
    (frames or None, latents, timer)."""
    timer = PeakTimer(pipe.device)
    if not decode:
        return None, pipe(*inputs, num_inference_steps=steps, decode=False, timer=timer), timer
    seen = []
    decode_to_host = pipe.decode_to_host

    def spy(latents, *mesh):  # the latents on their way to the decoder
        seen.append(latents)
        return decode_to_host(latents, *mesh)

    pipe.decode_to_host = spy
    try:
        frames = pipe(*inputs, num_inference_steps=steps, to_host=True, timer=timer)
    finally:
        del pipe.decode_to_host
    return frames, seen[0], timer


def row_major_without_bank(pipe, inputs, steps: int):
    """The latents of a request inside ``row_major()`` with the bank K/V left
    out of every transformer block's chain: the control that a comparison of
    the row-major and the default configuration must reject."""
    from mikudance_tpu_torch.kernels import row_major
    from mikudance_tpu_torch.models import layers

    chain = layers.TransformerBlock._chain
    layers.TransformerBlock._chain = lambda self, x, ref_kv, ctx_kv: chain(self, x, None, ctx_kv)
    try:
        with row_major():
            return run_request(pipe, inputs, steps, decode=False)[1]
    finally:
        layers.TransformerBlock._chain = chain


def run_request_b(pipe, seed: int, steps: int, decode: bool = True, size: int = 0):
    """The CLI-shaped request: camera matrices and depth -> flow on the card,
    reference picture -> CLIP tokens through the bundle's tower, then the
    sampler with the bundle's decoder. Returns (frames, latents, timer, flow,
    tokens); the timer's phases start with scene_motion and clip."""
    from mikudance_tpu_torch.pipelines.scene_motion import scene_motion_flow
    from mikudance_tpu_torch.utils.profiling import Timer

    height, width = (size, size) if size else (H, W)
    w2c, c2w, depth, picture = make_camera(seed, T, height, width)
    inputs = list(make_inputs(seed, T, height, width))
    before = Timer(pipe.device)
    before.start()
    flow = scene_motion_flow(w2c, c2w, depth, device=pipe.device)
    before.mark("scene_motion")
    tokens = pipe.clip_context(picture)
    before.mark("clip")
    inputs[0], inputs[5], inputs[6] = picture, flow, tokens
    frames, latents, timer = run_request(pipe, inputs, steps, decode)
    timer.phases = {**before.phases, **timer.phases}
    return frames, latents, timer, flow, tokens


def run_request_d(pipe, seed: int, steps: int, frames: int, size: int):
    """The CLI's steps for ``-W size -H size -L frames``: a full-resolution
    depth map resized to the latent grid (bilinear, in torch: the CLI's PIL is
    not needed here), camera matrices -> flow on the card, the reference
    picture -> CLIP tokens, noise from torch's seeded CPU generator in the
    reference's (1, 4, T, h, w) fp16 layout, then the sampler and the decode
    to the host. Returns (frames, latents, timer, flow)."""
    import torch.nn.functional as F

    from mikudance_tpu_torch.pipelines.scene_motion import scene_motion_flow
    from mikudance_tpu_torch.utils.media import torch_seed_noise
    from mikudance_tpu_torch.utils.profiling import Timer

    h = w = size // 8
    w2c, c2w, _, picture = make_camera(seed, frames, size, size)
    depth_full = np.random.default_rng(seed).uniform(0, 1, (1, 1, size, size)).astype(np.float32)
    inputs = list(make_inputs(seed, frames, size, size))
    before = Timer(pipe.device)
    before.start()
    depth = F.interpolate(torch.from_numpy(depth_full), size=(h, w), mode="bilinear",
                          antialias=True)[0, 0].numpy()
    flow = scene_motion_flow(w2c, c2w, depth, device=pipe.device)
    before.mark("scene_motion")
    tokens = pipe.clip_context(picture)
    before.mark("clip")
    noise = np.moveaxis(torch_seed_noise(seed, (1, 4, frames, h, w))[0], 0, -1)
    inputs[0], inputs[5], inputs[6], inputs[7] = picture, flow, tokens, noise
    out, latents, timer = run_request(pipe, inputs, steps)
    timer.phases = {**before.phases, **timer.phases}
    return out, latents, timer, flow


def phase_budgets(bundle, dev) -> None:
    """Peak device memory, phase by phase, of one-step 768^2 requests
    (latents only) as the clip grows: what ``cached_bank_positions`` and
    ``max_denoise_frame_batch`` are derived from. Positions = windows x 30
    frames (16 and 30 frames are one window)."""
    from mikudance_tpu_torch.core.configs import ContextConfig, PipelineConfig
    from mikudance_tpu_torch.pipelines.video import VideoPipeline

    log(f"budgets: weights on the card {torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB")
    big = 1 << 20
    cases = [
        ("cached, one UNet batch with CFG folded in", 16, dict(bank_mode="cached")),
        ("cached, one UNet batch with CFG folded in", 30, dict(bank_mode="cached")),
        ("cached, one UNet batch with CFG folded in", 40, dict(bank_mode="cached")),
        ("cached-grouped, one window a group", 40, dict(bank_mode="cached",
                                                        max_denoise_frame_batch=32)),
        ("cached-grouped, one window a group", 48, dict(bank_mode="cached",
                                                        max_denoise_frame_batch=32)),
        ("per-step, one window a group", 48, dict(bank_mode="per_step",
                                                  cached_bank_positions=32)),
        ("per-step, three windows a group", 48, dict(bank_mode="per_step",
                                                     cached_bank_positions=96)),
        ("cached_q8, one window a group", 48, dict(bank_mode="cached_q8",
                                                   cached_bank_positions=64,
                                                   max_denoise_frame_batch=32)),
        # the largest last: a case that does not fit is reported, not fatal
        ("cached-grouped, two windows a group", 74, dict(bank_mode="cached",
                                                         max_denoise_frame_batch=64)),
        ("cached, one UNet batch with CFG folded in", 48, dict(bank_mode="cached")),
        # PipelineConfig's own budgets: three windows in one batch; six windows
        # cached and denoised in two groups; seven windows past the bank budget
        ("the default budgets", 66, None),
        ("the default budgets", 130, None),
        ("the default budgets", 150, None),
    ]
    for what, frames, change in cases:
        base = dict(width=W, height=H, num_inference_steps=1,
                    context=ContextConfig(frames=30, overlap=8))
        if change is None:
            cfg = PipelineConfig(**base)
            what += (f" ({cfg.bank_mode}, cached_bank_positions {cfg.cached_bank_positions}, "
                     f"max_denoise_frame_batch {cfg.max_denoise_frame_batch})")
        else:
            cfg = PipelineConfig(**{**base, "cached_bank_positions": big,
                                    "max_denoise_frame_batch": big, **change})
        pipe = VideoPipeline(bundle, cfg)
        from mikudance_tpu_torch.pipelines import context as ctx_sched
        nw, wf = ctx_sched.window_matrix(frames, 30, 1, 8).shape
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        try:
            _, latents, timer = run_request(pipe, make_inputs(frames, frames, H, W), 1,
                                            decode=False)
        except torch.OutOfMemoryError:
            log(f"budgets: {frames} frames = {nw * wf} positions, {what}: out of memory")
            continue
        check(bool(torch.isfinite(latents).all()), f"budgets: {what}, {frames} frames")
        log(f"budgets: {frames} frames = {nw} x {wf} = {nw * wf} positions, {what}: "
            f"{time.perf_counter() - t0:.2f} s | {phase_text(timer)} | whole-request peak "
            f"{max(timer.peaks.values()):.2f} GiB")
        del latents, pipe


def check_video(frames, latents, n_frames: int, what: str, height: int = H,
                width: int = W) -> None:
    check(frames is None or (isinstance(frames, np.ndarray) and frames.dtype == np.uint8
                             and frames.shape == (n_frames, height, width, 3)),
          f"{what}: frames {type(frames)} {getattr(frames, 'shape', '')}")
    check(latents.shape == (n_frames, height // 8, width // 8, 4)
          and bool(torch.isfinite(latents).all()), f"{what}: latents {tuple(latents.shape)} finite")


def seeded_fp32(seed: int, make):
    """``make()`` on the CPU under PyTorch's default init and a seed, every
    tensor that starts at zero refilled with seeded N(0, 1e-2); fp32, eval."""
    torch.manual_seed(seed)
    module = make()
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for p in module.parameters():
            if p.is_floating_point() and not p.any():
                p.normal_(0.0, 1e-2, generator=g)
    return module.eval()


def unipose_inputs(seed: int, frames: int, size: int, real_tokens: int, real_points: int,
                   width: int | None = None):
    """Normalized frames of ``size`` x ``width`` (square by default),
    CLIP-width instance and keypoint embeddings, the instance slots' mask and
    the keypoint slots' visibility (bench.py's XPose case at ``real_tokens =
    4, real_points = 68``)."""
    rng = np.random.default_rng(seed)
    mask = np.zeros((frames, I_N_TXT), bool)
    mask[:, :real_tokens] = True
    vis = np.zeros((frames, I_K), np.float32)
    vis[:, :real_points] = 1.0
    return tuple(torch.from_numpy(a) for a in (
        rng.normal(0, 1, (frames, size, width or size, 3)).astype(np.float32),
        rng.normal(0, 1, (frames, I_N_TXT, 512)).astype(np.float32), mask,
        rng.normal(0, 1, (frames, I_K, 512)).astype(np.float32), vis))


def kernel_categories(fn) -> dict:
    """Device milliseconds of one ``fn()`` by kernel category (torch.profiler)."""
    with trace(None) as prof:
        fn()
        torch.cuda.synchronize()
    return dict(device_ms(prof)[0])


def unipose_split_ms(model, inputs, reps: int = 3) -> dict:
    """Device milliseconds of one forward's Swin backbone, the rest of the
    encoder (input projections, fusion, text and deformable layers) and the
    decoder (query selection included): CUDA events, median of ``reps``."""
    img, obj, mask, kpt, vis = inputs
    ev = {k: torch.cuda.Event(enable_timing=True) for k in ("start", "swin0", "swin1", "enc",
                                                             "dec")}
    swin = model.backbone[0]
    hooks = [swin.register_forward_pre_hook(lambda m, a: ev["swin0"].record()),
             swin.register_forward_hook(lambda m, a, o: ev["swin1"].record())]
    rows = []
    try:
        for _ in range(reps):
            ev["start"].record()
            memory, txt, shapes = model.encode(img, obj, mask)
            ev["enc"].record()
            model.decode(memory, txt, shapes, mask, kpt, vis)
            ev["dec"].record()
            torch.cuda.synchronize()
            t_swin = ev["swin0"].elapsed_time(ev["swin1"])
            rows.append((t_swin, ev["start"].elapsed_time(ev["enc"]) - t_swin,
                         ev["enc"].elapsed_time(ev["dec"])))
    finally:
        for h in hooks:
            h.remove()
    return dict(zip(("Swin", "encoder", "decoder"), np.median(np.array(rows), axis=0)))


class StubTokenizer:
    """Stands in for ``CLIPTokenizer`` (no tokenizer files are in the repo):
    ids from each prompt's characters, then the EOT id (the largest) as
    padding to 77."""

    def __call__(self, prompts, padding, max_length, return_tensors):
        rows = [[ord(c) for c in p][: max_length - 1] for p in prompts]
        return {"input_ids": np.array([r + [I_EOT] * (max_length - len(r)) for r in rows])}


def detect_clip(det, frames, vocabs) -> dict:
    """``det.detect`` over ``frames`` for each vocabulary, as the video
    driver calls it (its default thresholds): {vocabulary: (wall s, device s
    of the UniPose forwards (CUDA events), per-frame keypoints)}."""
    model, pairs = det.model, []

    def timed(*a):
        pairs.append((torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)))
        pairs[-1][0].record()
        res = model(*a)
        pairs[-1][1].record()
        return res

    out = {}
    det.model = timed
    try:
        for vocab, names in vocabs.items():
            pairs.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            kpts = det.detect(frames, vocab, names, box_threshold=0.2, iou_threshold=0.4)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            out[vocab] = (wall, sum(a.elapsed_time(b) for a, b in pairs) / 1e3, kpts)
    finally:
        det.model = model
    return out


@contextlib.contextmanager
def tf32_convolutions():
    """cuDNN convolutions with TF32 allowed (PyTorch's default, which phase 1
    turns off for the fp32 comparisons), restored after."""
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = before


def request_i(dev, profile: bool = False) -> dict:
    """Request I: the toolbox's networks on the card, stock PyTorch ops (no
    kernel of K1-K15 is on this path, as in the JAX package). UniPose on
    bench.py's 10 x 800^2 batch and through the video driver's ``Detector``
    on a clip, then one 384^2 frame, DPT-hybrid, CLIP-text and the
    deformable-attention op each held to the port's own CPU run, each with a
    control the limit must reject. Returns the readings."""
    import copy

    from mikudance_tpu_torch.toolbox import clip_text, dpt, native, unipose
    from mikudance_tpu_torch.toolbox.deformable import ms_deform_attn
    from mikudance_tpu_torch.toolbox.unipose import UniPose
    from mikudance_tpu_torch.tools import depth_from_image as depth_tool
    from mikudance_tpu_torch.tools import inference_xpose_on_video as video_driver

    out: dict = {}
    with torch.inference_mode():
        # 1. UniPose, 10 frames at 800^2
        t0 = time.perf_counter()
        model = seeded_fp32(21, UniPose)
        card = copy.deepcopy(model).to(dev)
        log(f"request I: UniPose-SwinT (hidden 256, 6 + 6 layers, 900 queries, 68 points), "
            f"{sum(p.numel() for p in model.parameters()) / 1e6:.1f} M parameters, fp32, "
            f"built in {time.perf_counter() - t0:.1f} s")
        inputs = [x.to(dev) for x in unipose_inputs(22, I_FRAMES, I_SIZE, I_N_TXT, I_K)]
        # the warm-up keeps the first deformable-attention call's inputs (the
        # first encoder layer's, first frame) for the op's own check below
        captured = []

        def spy(value, levels, loc, weights, q_chunk=None):
            if not captured:
                captured.append((value[:1].clone(), list(levels), loc[:1].clone(),
                                 weights[:1].clone()))
            return ms_deform_attn(value, levels, loc, weights, q_chunk)

        torch.cuda.reset_peak_memory_stats(dev)
        unipose.ms_deform_attn = spy
        try:
            t0 = time.perf_counter()
            res = card(*inputs)
            torch.cuda.synchronize()
            first = time.perf_counter() - t0
        finally:
            unipose.ms_deform_attn = ms_deform_attn
        times = []
        for _ in range(I_RUNS):
            t0 = time.perf_counter()
            res = card(*inputs)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        G = card.num_groups
        shapes = {k: tuple(res[k].shape) for k in ("pred_logits", "pred_boxes", "pred_keypoints")}
        check(shapes == {"pred_logits": (I_FRAMES, G, I_N_TXT), "pred_boxes": (I_FRAMES, G, 4),
                         "pred_keypoints": (I_FRAMES, G, 3 * I_K)},
              f"request I: UniPose output shapes {shapes}")
        check(all(bool(torch.isfinite(res[k]).all()) for k in shapes),
              "request I: UniPose outputs finite")
        out["unipose_s"] = float(np.median(times))
        out["unipose_peak_gib"] = peak
        log(f"request I: UniPose {I_FRAMES}x{I_SIZE}x{I_SIZE}: {out['unipose_s']:.4f} s per "
            f"{I_FRAMES}-frame forward (median of {I_RUNS}: "
            f"{' '.join(f'{t:.4f}' for t in times)}; first call {first:.3f} s) | peak "
            f"{peak:.2f} GiB | shapes {shapes}, finite")
        if profile:
            split = unipose_split_ms(card, inputs)
            cats = kernel_categories(lambda: card(*inputs))
            busy = sum(cats.values())
            log(f"request I, profile: UniPose {I_FRAMES}x{I_SIZE}^2 device ms by part (events, "
                f"median of 3): " + ", ".join(f"{k} {v:.1f}" for k, v in split.items()))
            log(f"request I, profile: kernel time {busy:.1f} ms by category: " + ", ".join(
                f"{k} {v:.1f} ms ({v / busy:.1%})" for k, v in
                sorted(cats.items(), key=lambda kv: -kv[1])))
            out["unipose_split_ms"] = split
            out["unipose_categories_ms"] = cats
        del res, inputs
        torch.cuda.empty_cache()

        # 1b. the video driver's Detector on a clip at its resize, each vocabulary
        text = seeded_fp32(41, clip_text.CLIPTextEncoder)
        text_card = copy.deepcopy(text).to(dev)
        det = video_driver.Detector(card, text_card, StubTokenizer(), dev)
        w, h = video_driver.resized_size(*I_CLIP_SOURCE)
        frames = np.random.default_rng(24).random((I_CLIP_FRAMES, h, w, 3), np.float32)
        vocabs = {v: names for v, (names, _) in video_driver.VOCABS.items()}
        torch.cuda.reset_peak_memory_stats(dev)
        # under PyTorch's default of TF32 convolutions, as a user's process
        # has it: the driver turns them off around UniPose itself
        with tf32_convolutions():
            detect_clip(det, frames[:1], {"person": vocabs["person"]})  # warm-up
            runs = detect_clip(det, frames, vocabs)
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        for vocab, (wall, fwd, kpts) in runs.items():
            n = len(vocabs[vocab])
            check(len(kpts) == I_CLIP_FRAMES and all(
                k.ndim == 3 and k.shape[1:] == (n, 2) and np.isfinite(k).all()
                for k in kpts), f"request I: Detector '{vocab}' keypoints per frame")
        total = sum(r[0] for r in runs.values())
        log(f"request I: the video driver's Detector.detect, {I_CLIP_FRAMES} frames of "
            f"{I_CLIP_SOURCE[0]}x{I_CLIP_SOURCE[1]} at its resize {w}x{h}, one frame a forward: "
            f"{total:.4f} s for the three vocabularies, {total / I_CLIP_FRAMES:.4f} s per frame "
            f"of video, peak {peak:.2f} GiB | " + ", ".join(
                f"{v} {r[0]:.4f} s ({r[0] / I_CLIP_FRAMES:.4f} s a frame, UniPose forwards "
                f"{r[1]:.4f} s on the device, {np.mean([len(k) for k in r[2]]):.1f} "
                f"detections a frame)" for v, r in runs.items()))
        out.update(detect_s_per_frame=total / I_CLIP_FRAMES, detect_peak_gib=peak,
                   detect_by_vocabulary_s={v: r[0] for v, r in runs.items()})
        if profile:  # one driver frame, its forward alone
            one = [x.to(dev) for x in unipose_inputs(25, 1, h, 1, 17, width=w)]
            split = unipose_split_ms(card, one)
            cats = kernel_categories(lambda: card(*one))
            log(f"request I, profile: UniPose 1x{h}x{w} (a driver frame) device ms by part "
                f"(events, median of 3): " + ", ".join(f"{k} {v:.1f}" for k, v in split.items())
                + f"; kernel time {sum(cats.values()):.1f} ms by category: " + ", ".join(
                    f"{k} {v:.1f} ms" for k, v in sorted(cats.items(), key=lambda kv: -kv[1])))
            out["detect_frame_split_ms"] = split
            out["detect_frame_categories_ms"] = cats
            del one
            # a whole driver frame (person vocabulary): its host time by op
            with tf32_convolutions(), trace(None, dev) as prof:
                t0 = time.perf_counter()
                detect_clip(det, frames[:1], {"person": vocabs["person"]})
                wall = time.perf_counter() - t0
            rows = op_profile_rows(prof, depth=3, host=True)
            log(f"request I, profile: a driver frame (Detector.detect, person), wall "
                f"{wall * 1e3:.1f} ms under the profiler, ops' self CPU time "
                f"{sum(r[0] for r in rows):.1f} ms; top host rows (ms, calls, op):")
            for ms, n, _, name in rows[:20]:
                log(f"   {ms:10.3f} {n:6d}  {name[:150]}")
            out["detect_frame_host_rows"] = rows[:20]
        del det, frames
        torch.cuda.empty_cache()

        # 2. UniPose, one 384^2 frame on the card and on the CPU
        small = unipose_inputs(23, 1, I_CHECK_SIZE, 2, 17)
        small_dev = [x.to(dev) for x in small]
        img, obj, mask, kpt, vis = small
        t0 = time.perf_counter()
        mem_c, txt_c, levels = model.encode(img, obj, mask)
        res_c = model.decode(mem_c, txt_c, levels, mask, kpt, vis)
        cpu_s = time.perf_counter() - t0
        mem_g, txt_g, _ = card.encode(*small_dev[:3])
        res_g = card.decode(mem_g, txt_g, levels, *small_dev[2:])
        level_embed = card.transformer.level_embed
        saved = level_embed.clone()
        level_embed.zero_()
        mem_x = card.encode(*small_dev[:3])[0]
        level_embed.copy_(saved)
        rel_mem, rel_mem_ctl = rel_l2(mem_g.cpu(), mem_c), rel_l2(mem_x.cpu(), mem_c)
        q_c, q_g = res_c["query_indices"][0], res_g["query_indices"][0].cpu()
        g_c, g_g = res_c["group_indices"][0], res_g["group_indices"][0].cpu()
        same_q = len(set(q_c.tolist()) & set(q_g.tolist()))
        rows = g_c == g_g
        rels = {k: rel_l2(res_g[k][0].cpu()[rows][..., sl], res_c[k][0][rows][..., sl])
                for k, sl in (("pred_boxes", slice(None)), ("pred_keypoints", slice(None)),
                              ("pred_logits", slice(0, 2)))}
        log(f"request I: UniPose 1x{I_CHECK_SIZE}^2, card against CPU ({cpu_s:.2f} s there): "
            f"encoder memory relative L2 {rel_mem:.3e} (limit {I_MEMORY_REL_L2}; control "
            f"without the level embedding {rel_mem_ctl:.3e}) | top-{card.num_queries} indices "
            f"shared {same_q} of {card.num_queries} | top-{card.num_groups} in the same place "
            f"{int(rows.sum())} of {card.num_groups} | outputs there, relative L2 "
            + ", ".join(f"{k} {v:.3e}" for k, v in rels.items())
            + f" (limit {I_OUTPUT_REL_L2}; logits of the 2 real tokens)")
        check(rel_mem < I_MEMORY_REL_L2 < rel_mem_ctl,
              f"request I: UniPose memory {rel_mem:.3e} and the control {rel_mem_ctl:.3e} on "
              f"either side of {I_MEMORY_REL_L2}")
        check(bool(rows.any()) and max(rels.values()) < I_OUTPUT_REL_L2,
              f"request I: UniPose outputs {rels} where {int(rows.sum())} groups agree")
        with tf32_convolutions():
            mem_t, txt_t, _ = card.encode(*small_dev[:3])
            res_t = card.decode(mem_t, txt_t, levels, *small_dev[2:])
        rows_t = g_c == res_t["group_indices"][0].cpu()
        rels_t = {k: rel_l2(res_t[k][0].cpu()[rows_t][..., sl], res_c[k][0][rows_t][..., sl])
                  for k, sl in (("pred_boxes", slice(None)), ("pred_keypoints", slice(None)),
                                ("pred_logits", slice(0, 2)))}
        log(f"request I: UniPose 1x{I_CHECK_SIZE}^2 with cuDNN's TF32 convolutions (no driver's "
            f"path), card against CPU: encoder memory {rel_l2(mem_t.cpu(), mem_c):.3e}, top-900 shared "
            f"{len(set(q_c.tolist()) & set(res_t['query_indices'][0].cpu().tolist()))}, top-50 "
            f"in place {int(rows_t.sum())}, outputs " + ", ".join(
                f"{k} {v:.3e}" for k, v in rels_t.items()))
        out.update(unipose_memory_rel_l2=rel_mem, unipose_memory_control=rel_mem_ctl,
                   unipose_top_queries_shared=same_q, unipose_groups_agreeing=int(rows.sum()),
                   unipose_output_rel_l2=rels)
        del model, card, mem_g, mem_x, res_g, mem_t, res_t, small_dev
        torch.cuda.empty_cache()

        # 3. DPT-hybrid, one reference picture at 384^2
        depth_model = seeded_fp32(31, dpt.DPTHybridDepth)
        emb = depth_model.dpt.embeddings
        for p in [emb.projection.weight, emb.projection.bias, emb.position_embeddings,
                  emb.cls_token] + [t for layer in depth_model.dpt.encoder.layer
                                    for lin in (layer.attention.output.dense, layer.output.dense)
                                    for t in (lin.weight, lin.bias)]:
            p.mul_(I_VIT_SCALE)  # the ViT's residual stream (see I_VIT_SCALE)
        rng = np.random.default_rng(32)
        picture = rng.integers(0, 256, (dpt.IMAGE_SIZE, dpt.IMAGE_SIZE, 3)).astype(np.float32)
        pixels = torch.from_numpy((picture / 255.0 - dpt.IMAGE_MEAN) / dpt.IMAGE_STD)[None]

        def with_tap(m, x):
            taps = []
            hook = m.dpt.encoder.layer[-1].register_forward_hook(lambda *a: taps.append(a[2]))
            try:
                return m(x), taps[0]
            finally:
                hook.remove()

        t0 = time.perf_counter()
        depth_c, tap_c = with_tap(depth_model, pixels)
        cpu_s = time.perf_counter() - t0
        depth_card = copy.deepcopy(depth_model).to(dev)
        pixels_dev = pixels.to(dev)
        depth_g, tap_g = with_tap(depth_card, pixels_dev)
        # the depth driver's run_depth under PyTorch's default of TF32
        # convolutions, as a user's process has it (the driver turns them off
        # around the network), held to the CPU; the module alone with TF32 on
        # for comparison, not on any driver's path
        with tf32_convolutions():
            depth_drv = torch.from_numpy(depth_tool.run_depth(depth_card, pixels_dev))[None]
            dpt_ms = cuda_ms(lambda: depth_tool.run_depth(depth_card, pixels_dev), 3)
            dpt_tf32_ms = cuda_ms(lambda: depth_card(pixels_dev), 3)
            depth_t, tap_t = with_tap(depth_card, pixels_dev)
        rel_drv = rel_l2(depth_drv, depth_c)
        log(f"request I: DPT with cuDNN's TF32 convolutions (no driver's path), card against "
            f"CPU: relative L2 of the depth {rel_l2(depth_t.cpu(), depth_c):.3e}, of the hidden "
            f"state {rel_l2(tap_t.cpu(), tap_c):.3e}; {dpt_tf32_ms / 1e3:.4f} s per image")
        if profile:
            for what, context in (("TF32 off", contextlib.nullcontext),
                                  ("cuDNN TF32 on", tf32_convolutions)):
                with context():
                    cats = kernel_categories(lambda: depth_card(pixels_dev))
                log(f"request I, profile: DPT 1x{dpt.IMAGE_SIZE}^2, {what}: kernel time "
                    f"{sum(cats.values()):.1f} ms: " + ", ".join(
                        f"{k} {v:.1f} ms" for k, v in sorted(cats.items(), key=lambda kv: -kv[1])))
                out[f"dpt_categories_ms ({what})"] = cats
        for layer in depth_card.dpt.encoder.layer:
            layer.layernorm_before.eps = layer.layernorm_after.eps = 1e-5
        depth_x, tap_x = with_tap(depth_card, pixels_dev)
        rel = max(rel_l2(depth_g.cpu(), depth_c), rel_l2(tap_g.cpu(), tap_c))
        rel_ctl = max(rel_l2(depth_x.cpu(), depth_c), rel_l2(tap_x.cpu(), tap_c))
        check(tuple(depth_g.shape) == (1, dpt.IMAGE_SIZE, dpt.IMAGE_SIZE)
              and bool(torch.isfinite(depth_g).all()), "request I: DPT depth shape, finite")
        log(f"request I: DPT-hybrid 1x{dpt.IMAGE_SIZE}^2, full geometry: {dpt_ms / 1e3:.4f} s per "
            f"image through the depth driver's run_depth (fp32, median of 3; {cpu_s:.2f} s on "
            f"the CPU) | card against CPU, relative L2 of the driver's depth {rel_drv:.3e}, of "
            f"the module's depth {rel_l2(depth_g.cpu(), depth_c):.3e} and of the ViT's last "
            f"hidden state {rel_l2(tap_g.cpu(), tap_c):.3e} (limit {I_DPT_REL_L2}; control with "
            f"the ViT LayerNorm eps at 1e-5: depth {rel_l2(depth_x.cpu(), depth_c):.3e}, hidden "
            f"state {rel_l2(tap_x.cpu(), tap_c):.3e})")
        check(max(rel, rel_drv) < I_DPT_REL_L2 < rel_ctl,
              f"request I: DPT {rel:.3e} (the driver's {rel_drv:.3e}) and the control "
              f"{rel_ctl:.3e} on either side of {I_DPT_REL_L2}")
        out.update(dpt_s=dpt_ms / 1e3, dpt_tf32_conv_s=dpt_tf32_ms / 1e3, dpt_rel_l2=rel,
                   dpt_driver_rel_l2=rel_drv, dpt_control=rel_ctl)
        del depth_model, depth_card, depth_g, tap_g, depth_x, tap_x, depth_t, tap_t
        torch.cuda.empty_cache()

        # 4. CLIP-text, ViT-B/32 widths
        rng = np.random.default_rng(42)
        ids = rng.integers(0, I_EOT, (I_CLIP_PROMPTS, 77))
        ids[np.arange(I_CLIP_PROMPTS), rng.integers(1, 77, I_CLIP_PROMPTS)] = I_EOT
        ids = torch.from_numpy(ids)
        emb_c = text(ids)
        ids_dev = ids.to(dev)
        emb_g = text_card(ids_dev)
        clip_ms = cuda_ms(lambda: text_card(ids_dev), 3)
        quick_gelu = clip_text.quick_gelu
        clip_text.quick_gelu = torch.nn.functional.gelu
        try:
            emb_x = text_card(ids_dev)
        finally:
            clip_text.quick_gelu = quick_gelu
        rel, rel_ctl = rel_l2(emb_g.cpu(), emb_c), rel_l2(emb_x.cpu(), emb_c)
        log(f"request I: CLIP-text {I_CLIP_PROMPTS} prompts x 77 tokens (12 layers, 512 wide): "
            f"{clip_ms:.3f} ms on the card (median of 3) | card against CPU, relative L2 "
            f"{rel:.3e} (limit {I_CLIP_REL_L2}; control with the erf GELU for quick_gelu "
            f"{rel_ctl:.3e})")
        check(tuple(emb_g.shape) == (I_CLIP_PROMPTS, 512) and rel < I_CLIP_REL_L2 < rel_ctl,
              f"request I: CLIP-text {rel:.3e} and the control {rel_ctl:.3e} on either side of "
              f"{I_CLIP_REL_L2}")
        out.update(clip_ms=clip_ms, clip_rel_l2=rel, clip_control=rel_ctl)
        del text, text_card

        # 5. deformable attention at the 800^2 encoder's shapes, on the inputs
        # UniPose's first encoder layer gave it for the first frame above
        v, levels, l, w = captured[0]
        S, heads, head_dim = v.shape[1:]
        points = l.shape[4]
        check(levels == list(I_LEVELS), f"request I: the encoder's levels {levels}")
        t0 = time.perf_counter()
        want = native.ms_deform_attn_cpu(v.cpu().numpy(), levels, l.cpu().numpy(),
                                         w.cpu().numpy())
        cpp_s = time.perf_counter() - t0
        got = ms_deform_attn(v, levels, l, w).cpu().numpy()
        deform_ms = cuda_ms(lambda: ms_deform_attn(v, levels, l, w), 5)
        ctl = ms_deform_attn(v.roll(1, dims=-1), levels, l, w).cpu().numpy()
        err, err_ctl = float(np.abs(got - want).max()), float(np.abs(ctl - want).max())
        log(f"request I: ms_deform_attn at the 800^2 encoder (the first layer's inputs, frame "
            f"0: levels {levels}, {S} queries in chunks of 2048, {heads} heads of {head_dim}, "
            f"{points} points; value std {v.std().item():.3f}, largest weight "
            f"{w.max().item():.3f}): {deform_ms:.3f} ms on the card (median of 5; the C++ "
            f"kernel {cpp_s:.3f} s on the CPU) | max abs against C++ {err:.3e} (limit "
            f"{I_DEFORM_ATOL}; control with the value's channels shifted by one {err_ctl:.3e})")
        check(got.shape == (1, S, heads * head_dim) and err < I_DEFORM_ATOL < err_ctl,
              f"request I: ms_deform_attn {err:.3e} and the control {err_ctl:.3e} on either "
              f"side of {I_DEFORM_ATOL}")
        out.update(deform_ms=deform_ms, deform_max_abs=err, deform_control=err_ctl)
    return out


def kernel_list():
    """K1-K15, in order."""
    from mikudance_tpu_torch.kernels import conv2d as cv
    from mikudance_tpu_torch.kernels import flash_attention as fa
    from mikudance_tpu_torch.kernels import geglu as gg
    from mikudance_tpu_torch.kernels import group_norm as gn
    from mikudance_tpu_torch.kernels import layer_norm as ln
    from mikudance_tpu_torch.kernels import linear as lin
    from mikudance_tpu_torch.kernels import mega_block as mb
    from mikudance_tpu_torch.kernels import temporal_attention as ta

    return (fa.K1, fa.K2, ta.K3, fa.K4, gn.K5, ln.K6, lin.K7, cv.K8, fa.K9, fa.K10, fa.K11,
            fa.K12, ta.K13, mb.K14, gg.K15)


def request_k_rank(control: bool, probe: bool, memory_fraction: float = 1.0) -> dict:
    """One rank of request K (in a world of one, its reference): the bundles
    of requests A and B built from their seeds; K1 in bf16, then the same
    modules in fp32 for K1 fp32, K2 (per_step, cached, cached_q8) and K3,
    each through ``VideoPipeline`` with ``mesh=make_mesh()`` and decoded to
    the host, the kernel counts at 0 before each; the rank's allocator capped
    at ``memory_fraction`` of the card. Returns, per part, the
    latents, the decoded frames as floats (rank 0), the uint8 frames'
    digest, launches, wall seconds, phases and peak memory; with
    ``control``, the controls' latents and frames; with ``probe``, gloo's
    all_to_all on CUDA tensors against a host-staged one."""
    import hashlib

    import torch.distributed as dist

    from mikudance_tpu_torch.core import mesh as mesh_lib
    from mikudance_tpu_torch.core.configs import ContextConfig, PipelineConfig
    from mikudance_tpu_torch.kernels import _build
    from mikudance_tpu_torch.pipelines import video as video_lib
    from mikudance_tpu_torch.pipelines.video import ModelBundle, VideoPipeline

    torch.backends.cuda.matmul.allow_tf32 = False  # as the parent process
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.cuda.set_per_process_memory_fraction(memory_fraction, dev)
    _build.load()
    kernels = kernel_list()
    mesh = mesh_lib.make_mesh()
    out = {"rank": mesh.rank, "world": mesh.size, "backend": mesh.backend}
    if probe and mesh.size > 1:
        # a rank's level-0 motion-module tokens in K1
        x = torch.randn(1, 8, 9216, 320, device=dev).to(torch.bfloat16)
        src = x.movedim(2, 0).reshape((mesh.size, -1) + x.shape[:2] + x.shape[3:]).contiguous()

        def seconds(fn):
            times = []
            for _ in range(3):
                dist.barrier()
                torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize(dev)
                times.append(time.perf_counter() - t0)
            return float(np.median(times))

        def staged():
            host = src.cpu()
            got = torch.empty_like(host)
            dist.all_to_all_single(got, host)
            return got.to(dev)

        native_s = seconds(lambda: dist.all_to_all_single(torch.empty_like(src), src))
        out["all_to_all"] = (f"{src.numel() * 2 / 2**20:.0f} MiB a rank: on the CUDA tensors "
                             f"{native_s * 1e3:.1f} ms, staged through host memory "
                             f"{seconds(staged) * 1e3:.1f} ms")
        del x, src
    t0 = time.perf_counter()
    bundle = build_bundle(0, dev)
    clip, temporal = build_slice_b_parts(10, dev)
    bundle_b = ModelBundle(bundle.guide, bundle.den, bundle.vae_enc, temporal, clip)
    out["built_s"] = time.perf_counter() - t0

    decoded = []  # the decoder's float output, chunk by chunk
    decode_frames = video_lib.decode_frames

    def spy_decode(*args, **kwargs):
        y = decode_frames(*args, **kwargs)
        decoded.append(y)
        return y

    video_lib.decode_frames = spy_decode

    def pipe(b, size, **change):
        return VideoPipeline(b, PipelineConfig(
            width=size, height=size, num_inference_steps=K_STEPS, guidance_scale=3.5,
            context=ContextConfig(frames=30, overlap=8), **change), device=dev, mesh=mesh)

    def run_part(name, p, run):
        for k in kernels:
            k.launches = 0
        decoded.clear()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        frames, latents, timer = run(p)
        wall = time.perf_counter() - t0
        chosen = [m.shape for m in p._meshes.values() if m is not None]
        floats = torch.cat(decoded).float().cpu().numpy()
        out[name] = {"latents": latents.float().cpu().numpy(),
                     "frames": floats if mesh.rank == 0 else None,
                     "frames_sha": hashlib.sha256(frames.tobytes()).hexdigest(),
                     "frames_shape": frames.shape,
                     "launches": {k.name: k.launches for k in kernels}, "wall": wall,
                     "phases": phase_text(timer), "peak": max(timer.peaks.values()),
                     "mesh": chosen[0] if chosen else None}
        decoded.clear()
        return latents

    def without(cls, name, replacement, run):
        """``run()`` with ``cls.name`` replaced (a control)."""
        kept = getattr(cls, name)
        setattr(cls, name, replacement)
        try:
            return run()
        finally:
            setattr(cls, name, kept)

    # K1 in bf16, the serving dtype, and its control
    k1 = pipe(bundle_b, H)
    run_part("K1", k1, lambda p: run_request_b(p, 2, K_STEPS)[:3])
    if control:
        lat = without(mesh_lib.Mesh, "all_to_all", lambda self, x, *args: x,
                      lambda: run_request_b(k1, 2, K_STEPS, decode=False)[1])
        out["K1 control"] = lat.float().cpu().numpy()
    del k1
    torch.cuda.empty_cache()

    # the same modules in fp32
    for m in (bundle.guide, bundle.den, bundle.vae_enc, bundle.vae_dec, temporal, clip):
        m.float()
    torch.cuda.empty_cache()
    d_budgets = dict(max_denoise_frame_batch=64, cached_bank_positions=64)
    k1f = pipe(bundle_b, K1_F32_SIZE)

    def request_b_f32(p, decode=True):
        return run_request_b(p, 2, K_STEPS, decode, size=K1_F32_SIZE)

    lat_k1f = run_part("K1 fp32", k1f, lambda p: request_b_f32(p)[:3])
    k2 = pipe(bundle_b, D_SIZE, bank_mode="per_step", **d_budgets)
    parts = (
        ("K2 per_step", k2, lambda p: run_request_d(p, 8, K_STEPS, D_FRAMES, D_SIZE)[:3]),
        ("K2 cached", pipe(bundle_b, D_SIZE, max_denoise_frame_batch=64,
                           cached_bank_positions=32),
         lambda p: run_request_d(p, 8, K_STEPS, D_FRAMES, D_SIZE)[:3]),
        ("K2 cached_q8", pipe(bundle_b, D_SIZE, bank_mode="cached_q8", **d_budgets),
         lambda p: run_request_d(p, 8, K_STEPS, D_FRAMES, D_SIZE)[:3]),
        ("K3", pipe(bundle, K3_SIZE),
         lambda p: run_request(p, make_inputs(11, T, K3_SIZE, K3_SIZE), K_STEPS)))
    for name, p, run in parts:
        run_part(name, p, run)
        torch.cuda.empty_cache()
    video_lib.decode_frames = decode_frames
    if control:
        # the motion modules' all_to_all left out
        lat = without(mesh_lib.Mesh, "all_to_all", lambda self, x, *args: x,
                      lambda: request_b_f32(k1f, decode=False)[1])
        out["K1 fp32 control"] = lat.float().cpu().numpy()
        # the pad windows at weight 1
        streamed = k2._denoise_streamed

        def padded_at_one(*args, win_w=None, **kwargs):
            return streamed(*args, win_w=None if win_w is None else np.ones_like(win_w),
                            **kwargs)

        k2._denoise_streamed = padded_at_one
        lat = run_request_d(k2, 8, K_STEPS, D_FRAMES, D_SIZE)[1]
        del k2._denoise_streamed
        out["K2 per_step control"] = lat.float().cpu().numpy()
        # K1 fp32's latents decoded with zero halos
        k1_mesh = next(m for m in k1f._meshes.values() if m is not None)
        torch.cuda.empty_cache()
        with torch.inference_mode():  # as the pipeline decodes
            frames = without(mesh_lib.Mesh, "halo",
                             lambda self, x, axis=None: (torch.zeros_like(x[:1]),) * 2,
                             lambda: decode_frames(k1f.bundle.vae_dec, lat_k1f, k1_mesh))
        out["K1 fp32 halo control"] = frames.float().cpu().numpy()
    return out


def nccl_probe_rank() -> float:
    """One all_reduce over NCCL, every rank on card 0."""
    x = torch.ones(8, device=torch.device("cuda", 0))
    torch.distributed.all_reduce(x)
    torch.cuda.synchronize()
    return x[0].item()


def request_k(dev, probe: bool = False, ref: dict = None, ranks: tuple = None) -> dict:
    """Request K on the one card: the one-rank reference, then K_RANKS ranks
    over gloo (``ref`` and ``ranks``, ``shared_processes``' readings, where
    they were run, else processes of their own); each part's latents and
    decoded frames held to the reference's, every rank's result identical,
    the controls beyond the limits. With ``probe``: first NCCL with two ranks
    on the card (refused) and gloo's all_to_all on CUDA tensors timed
    against a host-staged one. Returns rank 0's launches in K1."""
    from mikudance_tpu_torch.core import mesh as mesh_lib
    from mikudance_tpu_torch.kernels import flash_attention as fa
    from mikudance_tpu_torch.kernels import layer_norm as ln
    from mikudance_tpu_torch.kernels import temporal_attention as ta

    torch.cuda.empty_cache()
    probes = ""
    if probe:
        try:
            mesh_lib.spawn(2, nccl_probe_rank, backend="nccl", timeout=120)
            nccl = "accepted"
        except (RuntimeError, TimeoutError) as e:
            # the last line of the first failing rank's traceback, before the
            # message's closing line
            lines = [s.strip() for s in str(e).splitlines() if s.strip()]
            nccl = "refused: " + lines[-2 if len(lines) > 1 else -1][:300]
        probes = f" | NCCL with 2 ranks on one card: {nccl}"
    ref_text = "one-rank reference in request L's references' process"
    if ref is None:
        t0 = time.perf_counter()
        ref = mesh_lib.spawn(1, request_k_rank, (False, False), timeout=600)[0]
        ref_text = f"one-rank process {time.perf_counter() - t0:.1f} s"
    if ranks is None:
        share, free, total = rank_share(dev, K_RANKS)
        t0 = time.perf_counter()
        got = mesh_lib.spawn(K_RANKS, request_k_rank, (True, probe, share * 2**30 / total),
                             timeout=900)
        ranks_text = f"{K_RANKS} ranks {time.perf_counter() - t0:.1f} s"
    else:
        got, share, free, total, ranks_s = ranks
        ranks_text = f"{K_RANKS} ranks with L1's {ranks_s:.1f} s"
    r0 = got[0]
    if probe:
        probes += f" | gloo's all_to_all of {r0['all_to_all']}"
    log(f"request K: world {r0['world']}, backend {r0['backend']}; CUDA tensors staged "
        f"through host memory for point-to-point only (the halos), gloo's collectives take "
        f"them{probes} | each rank's allocator capped at {share:.2f} GiB ({free / 2**30:.2f} "
        f"of {total / 2**30:.2f} GiB free, less {K_CONTEXT_GIB} GiB a rank, in "
        f"{K_RANKS}) | meshes { {p: r0[p]['mesh'] for p in K_PARTS} } | {ref_text}, "
        f"{ranks_text} (processes, bundles built in "
        f"{[round(r['built_s'], 1) for r in got]} s); the ranks time-share one card and "
        f"move their collectives through the host: no scaling is measured")
    controls = {"K1": ("K1 control", "the all_to_all left out"),
                "K1 fp32": ("K1 fp32 control", "the all_to_all left out"),
                "K2 per_step": ("K2 per_step control", "the pad windows at weight 1")}
    for part in K_PARTS:
        want, mine = ref[part], r0[part]
        for r in got:
            check(np.array_equal(r[part]["latents"], mine["latents"])
                  and r[part]["frames_sha"] == mine["frames_sha"],
                  f"request K, {part}: rank {r['rank']}'s result differs from rank 0's")
        lat, lat_ref = torch.from_numpy(mine["latents"]), torch.from_numpy(want["latents"])
        check(lat.shape == lat_ref.shape and bool(torch.isfinite(lat).all())
              and mine["frames_shape"] == want["frames_shape"]
              and mine["frames"].shape == want["frames"].shape,
              f"request K, {part}: latents {tuple(lat.shape)}, frames {mine['frames_shape']}")
        fp32 = part != "K1"
        limit = K_F32_REL_L2 if fp32 else K_BF16_REL_L2
        rel = rel_l2(lat, lat_ref)
        frames_rel = rel_l2(torch.from_numpy(mine["frames"]), torch.from_numpy(want["frames"]))
        frames_max = float(np.abs(mine["frames"] - want["frames"]).max())
        text = (f"request K, {part}: {mine['frames_shape'][0]}x{mine['frames_shape'][1]}^2, "
                f"mesh {mine['mesh']}; against the one-rank run: latents relative L2 "
                f"{rel:.3e} (limit {limit}), decoded frames relative L2 {frames_rel:.3e}"
                + (f" (limit {K_F32_FRAMES_REL_L2})" if fp32 else "")
                + f", max abs {frames_max:.3e} (frames in [-1, 1])"
                + f" | one rank: {want['wall']:.3f} s | {want['phases']} | peak "
                f"{want['peak']:.2f} GiB | launches {want['launches']}")
        if part in controls:
            key, what = controls[part]
            rel_ctl = rel_l2(torch.from_numpy(r0[key]), lat_ref)
            text += f" | control, {what}: {rel_ctl:.3e}"
            check(rel_ctl > limit, f"request K, {part}: the control ({what}) {rel_ctl:.3e} "
                                   f"under the limit {limit}")
        if part == "K1 fp32":
            halo_ctl = rel_l2(torch.from_numpy(r0["K1 fp32 halo control"]),
                              torch.from_numpy(want["frames"]))
            text += f" | control, the frames decoded with zero halos: {halo_ctl:.3e}"
            check(halo_ctl > K_F32_FRAMES_REL_L2,
                  f"request K, K1 fp32: the zero-halo control {halo_ctl:.3e} under the limit "
                  f"{K_F32_FRAMES_REL_L2}")
        log(text)
        for r in got:
            log(f"request K, {part}, rank {r['rank']}: {r[part]['wall']:.3f} s | "
                f"{r[part]['phases']} | peak {r[part]['peak']:.2f} GiB | launches "
                f"{r[part]['launches']}")
        check(rel < limit, f"request K, {part}: latents {rel:.3e} from the one-rank run")
        check(not fp32 or frames_rel < K_F32_FRAMES_REL_L2,
              f"request K, {part}: decoded frames {frames_rel:.3e} from the one-rank run")
        check(all(r[part]["launches"][ta.K3.name] > 0 for r in got),
              f"request K, {part}: K3 launched on every rank")
    # K1: every rank runs the UNets as often as one device does, at the same
    # token counts, so the attention and LayerNorm kernels launch as often
    for r in got:
        for kern in (fa.K1, fa.K2, ta.K3, ln.K6):
            n, n_ref = r["K1"]["launches"][kern.name], ref["K1"]["launches"][kern.name]
            check(n == n_ref, f"request K, K1, rank {r['rank']}: {kern.name} launched {n} "
                              f"times, the one-rank run {n_ref}")
        ran = {k for k, n in r["K1"]["launches"].items() if n}
        check(ran == {k for k, n in ref["K1"]["launches"].items() if n},
              f"request K, K1, rank {r['rank']}: kernels {sorted(ran)}")
    return r0["K1"]["launches"]


def local_copy(tensors: dict) -> dict:
    """This rank's fp32 ``tensors`` (an optimizer's master values or first
    moment: the whole tensors, or under ZeRO its shards), copied to host
    memory."""
    return {n: t.detach().to("cpu", torch.float32, copy=True) for n, t in tensors.items()}


def l_training(stage: str, n_steps: int, out_dir: str, dev, keep=(), snap_steps=(),
               **sections) -> dict:
    """The trainer's ``main([...])`` on ``n_steps`` synthetic batches on every
    rank of the process group (one rank without one), with a clock at the
    borders of a step's phases: batch (host data, VAE and CLIP encoders),
    forward, backward, all-reduce (none on one rank), optimizer. Returns the
    losses and gradient norms of each optimizer step (the global ones on
    every rank), the norm the clip would take from this rank's shards alone
    (``local_norms``), phases, peaks, launches, the optimizer's state bytes,
    the chosen mesh, a digest of the trained weights (and of the master
    values where they are whole), the ZeRO plan and whole shapes, the clip's
    ``max_grad_norm``, and on the host this rank's part of what ``keep``
    names: ``"moment"``, Adam's first moment of the trained tensors (final,
    and at ``snap_steps`` under ``"snaps"``); ``"unreduced"``, the first
    moment the first step would take from this rank's gradients alone, not
    all-reduced (``(1 - b1)`` times them, clipped by their own norm);
    ``"update"``, the update of the trained tensors (final master values
    less the initial ones); ``"final"``, their final master values."""
    import hashlib
    import shutil

    from mikudance_tpu_torch.core import loaders
    from mikudance_tpu_torch.scripts import train_stage1, train_stage2
    from mikudance_tpu_torch.train import runner
    from mikudance_tpu_torch.train import steps as tsteps

    kernels = kernel_list()
    shutil.rmtree(out_dir, ignore_errors=True)
    path = train_config_file(stage, out_dir, **sections)
    phases, peaks = defaultdict(list), defaultdict(float)
    clock = {"t": time.perf_counter(), "last": None}
    losses, norms, local_norms, snaps, initial, chosen, kept = [], [], [], {}, {}, [], {}
    for k in kernels:
        k.launches = 0
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)

    def mark(name):
        torch.cuda.synchronize(dev)
        now = time.perf_counter()
        phases[name].append(now - clock["t"])
        peaks[name] = max(peaks[name], torch.cuda.max_memory_allocated(dev) / 2**30)
        torch.cuda.reset_peak_memory_stats(dev)
        clock["t"], clock["last"] = now, name

    loss_fn, reduce_fn = tsteps.diffusion_loss, tsteps.sum_gradients
    update, global_norm = tsteps.Optimizer.update, tsteps.Optimizer._global_norm
    init, make_step = runner.init_train_state, runner.make_train_step

    def timed_loss(*args, **kwargs):
        mark("batch")
        out = loss_fn(*args, **kwargs)
        losses.append(float(out[1]["loss"]))
        mark("forward")
        return out

    def timed_reduce(grads, mesh, optimizer):
        mark("backward")
        out = reduce_fn(grads, mesh, optimizer)
        mark("all-reduce")
        if "unreduced" in keep and "unreduced" not in kept:  # no phase
            cfg = optimizer.cfg
            norm = float(torch.linalg.vector_norm(torch.stack(
                [torch.linalg.vector_norm(g.float()) for g in grads.values()])))
            clip = 1.0 if norm < cfg.max_grad_norm else cfg.max_grad_norm / norm
            kept["unreduced"] = {n: (g.float() * ((1.0 - cfg.adam_b1) * clip)).cpu()
                                 for n, g in grads.items()}
            clock["t"] = time.perf_counter()
        return out

    def both_norms(self, g):
        """The norm the step takes, and the one this rank's shards give alone
        (request L3's control; the same where nothing is sharded)."""
        sum_over_shards = self.sum_over_shards
        self.sum_over_shards = lambda x: x
        try:
            local_norms.append(global_norm(self, g))
        finally:
            del self.sum_over_shards
        return global_norm(self, g)

    def timed_update(self, grads):
        if clock["last"] == "forward":
            mark("backward")
        fired = update(self, grads)
        mark("optimizer")
        if fired:
            norms.append(self.last_grad_norm)
            if "moment" in keep and self.count in snap_steps:
                snaps[self.count] = local_copy(self.mu)
            clock["t"] = time.perf_counter()  # the snapshot is no phase
        return fired

    def recording_init(*args, **kwargs):
        state = init(*args, **kwargs)
        if "update" in keep:
            initial.update(local_copy(state.optimizer.master))
        return state

    def recording_step(cfg, schedule, state, mesh=None):
        chosen.append(None if mesh is None else dict(mesh.shape))
        return make_step(cfg, schedule, state, mesh)

    def refilled(load, seed):
        """The loader's seeded module with every all-zero tensor (the motion
        modules' proj_out above all) refilled with seeded N(0, 1e-2), as
        ``seeded_modules`` does: at zero, proj_out would leave the motion
        modules' interior, and so their collectives' backward, without a
        gradient in the first step."""
        def load_refilled(*args, **kwargs):
            module = load(*args, **kwargs)
            g = None
            with torch.no_grad():
                for p in module.parameters():
                    if not p.any():
                        g = g or torch.Generator(device=p.device).manual_seed(seed)
                        p.normal_(0.0, 1e-2, generator=g)
            return module
        return load_refilled

    load_guidance, load_denoising = loaders.load_guidance, loaders.load_denoising
    loaders.load_guidance = refilled(load_guidance, 11)
    loaders.load_denoising = refilled(load_denoising, 12)
    tsteps.diffusion_loss, tsteps.sum_gradients = timed_loss, timed_reduce
    tsteps.Optimizer.update, tsteps.Optimizer._global_norm = timed_update, both_norms
    runner.init_train_state, runner.make_train_step = recording_init, recording_step
    t0 = time.perf_counter()
    try:
        main = {"stage1": train_stage1.main, "stage2": train_stage2.main}[stage]
        state = main(["--config", path, "--synthetic", str(n_steps), "--max_steps",
                      str(n_steps)])
    finally:
        tsteps.diffusion_loss, tsteps.sum_gradients = loss_fn, reduce_fn
        tsteps.Optimizer.update, tsteps.Optimizer._global_norm = update, global_norm
        runner.init_train_state, runner.make_train_step = init, make_step
        loaders.load_guidance, loaders.load_denoising = load_guidance, load_denoising
    wall = time.perf_counter() - t0
    opt = state.optimizer
    digest = hashlib.sha256()
    for n in opt.names:
        digest.update(opt.params[n].detach().float().cpu().numpy().tobytes())
        if opt.mesh is None:
            digest.update(opt.master[n].detach().cpu().numpy().tobytes())
    out = {"losses": losses, "norms": norms, "local_norms": local_norms,
           "phases": dict(phases), "peaks": dict(peaks),
           "launches": {k.name: k.launches for k in kernels}, "wall": wall,
           "state_bytes": opt.state_bytes, "mesh": chosen[0] if chosen else None,
           "digest": digest.hexdigest(), "trained": len(opt.names),
           "elements": sum(p.numel() for p in opt.params.values()),
           "plan": dict(opt.plan) if opt.mesh is not None else {n: None for n in opt.names},
           "shapes": {n: tuple(p.shape) for n, p in opt.params.items()},
           "max_grad_norm": opt.cfg.max_grad_norm, **kept}
    check(len(losses) == n_steps == len(norms) == opt.count
          and all(math.isfinite(v) for v in losses + norms),
          f"{stage}: losses {losses}, gradient norms {norms}")
    if "moment" in keep:
        out["moment"], out["snaps"] = local_copy(opt.mu), snaps
    if "update" in keep or "final" in keep:
        final = local_copy(opt.master)
        if "update" in keep:
            out["update"] = {n: final[n] - initial.pop(n) for n in list(final)}
        if "final" in keep:
            out["final"] = final
        del final
    del state, opt
    torch.cuda.empty_cache()
    return out


def save_flat(path: str, tensors: dict) -> None:
    """Whole tensors as one flat fp32 array, in name order."""
    total = sum(t.numel() for t in tensors.values())
    flat = np.lib.format.open_memmap(path, mode="w+", dtype=np.float32, shape=(total,))
    at = 0
    for n in sorted(tensors):
        size = tensors[n].numel()
        flat[at:at + size] = tensors[n].reshape(-1).numpy()
        at += size
    flat.flush()
    del flat


def distance(run: dict, ref, key: str, den=None, scale: float = 1.0) -> tuple:
    """Relative L2 of the whole ``run[key]`` times ``scale`` from ``ref`` (a
    path to ``save_flat``'s array, or a dict of whole tensors), the ranks'
    parts summed over the process group (this rank's shards of the sharded
    leaves; rank 0 the whole ones), over ``den`` where given (a squared
    norm) or ``ref``'s; on rank 0, the tensors that hold most of the squared
    distance; and ``ref``'s squared norm."""
    import torch.distributed as dist

    mine_all = run.get(key)
    rank = dist.get_rank() if dist.is_initialized() else 0
    world = dist.get_world_size() if dist.is_initialized() else 1
    flat = np.load(ref, mmap_mode="r") if isinstance(ref, str) else None
    sums, per = np.zeros(2), []
    at = 0
    for n in sorted(run["shapes"]):
        shape, d = run["shapes"][n], run["plan"][n]
        size = int(np.prod(shape))
        if mine_all is not None and (d is not None or rank == 0):
            want = (ref[n] if flat is None else
                    torch.from_numpy(np.array(flat[at:at + size])).view(shape))
            if d is not None:  # this rank's shard of the whole leaf
                part = shape[d] // world
                want = want.narrow(d, rank * part, part)
            diff = mine_all[n] * scale - want
            sq = float(diff.square().sum(dtype=torch.float64))
            sums += (sq, float(want.square().sum(dtype=torch.float64)))
            per.append((sq, n))
        at += size
    if dist.is_initialized():
        t = torch.from_numpy(sums)
        dist.all_reduce(t)
        sums = t.numpy()
    per.sort(reverse=True)
    top = "; ".join(f"{n} {sq / max(sums[0], 1e-300):.0%}" for sq, n in per[:3])
    return math.sqrt(sums[0] / (sums[1] if den is None else den)), top, float(sums[1])


def clip_factor(norm: float, max_norm: float) -> float:
    """The factor the clip scales a gradient of this norm by (optax's rule)."""
    return 1.0 if norm < max_norm else max_norm / norm


# (stage, sections of the YAML, ranks)
L_PARTS = {
    "L1": ("stage2", {}, L1_RANKS),
    "L2": ("stage2", {"data": {"train_width": L2_SIZE, "train_height": L2_SIZE},
                      "solver": {"mixed_precision": "no"}}, L2_RANKS),
    "L3": ("stage1", {"data": {"train_bs": L3_RANKS, "train_width": L3_SIZE,
                               "train_height": L3_SIZE}}, L3_RANKS),
}
UNREDUCED = "control: gradients not all-reduced"


def request_l_rank(parts: tuple, ref_dir: str, memory_fraction: float = 1.0) -> dict:
    """One rank of request L's ``parts`` (in a world of one, their
    reference), one after the other. The reference trains and writes its
    first moments to ``ref_dir``; the ranks train, and the distances of
    their moments are summed over them. Runs: L1 two default steps and one
    inside ``kernels.transposed()``; L2 one step; L3 the replicated step,
    then the ZeRO one; and on the ranks L1's and L2's all_to_all control
    (one step each; the not-all-reduced control is read in the default
    run, L3's in the ZeRO step). Returns per part and run what
    ``l_training`` reads, without the tensors, and the distances."""
    import torch.distributed as dist

    from mikudance_tpu_torch.core import mesh as mesh_lib
    from mikudance_tpu_torch.kernels import _build, transposed

    torch.backends.cuda.matmul.allow_tf32 = False  # as the parent process
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.cuda.set_per_process_memory_fraction(memory_fraction, dev)
    _build.load()
    mesh = mesh_lib.make_mesh()
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // mesh.size))  # the host math
    out = {"rank": mesh.rank, "world": mesh.size, "backend": mesh.backend}
    work = os.path.join(ref_dir, f"rank{mesh.rank}")
    nullcontext = contextlib.nullcontext

    def without(obj, attr, replacement):
        kept = getattr(obj, attr)
        setattr(obj, attr, replacement)
        return lambda: setattr(obj, attr, kept)

    no_backward = lambda: without(mesh_lib.Mesh, "all_to_all",  # noqa: E731
                                  mesh_lib.Mesh.all_to_all_values)
    for part in parts:
        stage, sections, _ = L_PARTS[part]
        part_dir = os.path.join(ref_dir, part)
        os.makedirs(part_dir, exist_ok=True)
        out[part] = {}
        if mesh.size == 1:  # the reference
            runs = {"L1": [("default", L1_STEPS, nullcontext, (1,)),
                           ("transposed", 1, transposed, ())],
                    "L2": [("default", 1, nullcontext, ())],
                    "L3": [("one rank, batch 2", 1, nullcontext, ())]}[part]
            for name, n, configuration, snap in runs:
                with configuration():
                    got = l_training(stage, n, work, dev, ("moment",), snap, **sections)
                save_flat(os.path.join(part_dir, f"{name}.npy"), got.pop("moment"))
                for count, moment in got.pop("snaps").items():
                    save_flat(os.path.join(part_dir, f"{name}_{count}.npy"), moment)
                out[part][name] = got
            continue
        # (run, steps, configuration, patch, YAML solver changes, held to)
        runs = {
            "L1": [("default", L1_STEPS, nullcontext, None, {}, "default"),
                   ("transposed", 1, transposed, None, {}, "transposed"),
                   ("control: all_to_all without its backward", 1, nullcontext, no_backward,
                    {}, "default_1")],
            "L2": [("default", 1, nullcontext, None, {}, "default"),
                   ("control: all_to_all without its backward", 1, nullcontext, no_backward,
                    {}, "default")],
            "L3": [("replicated", 1, nullcontext, None, {"optimizer_state_sharding": False},
                    "one rank, batch 2"),
                   ("zero", 1, nullcontext, None, {"optimizer_state_sharding": True},
                    "one rank, batch 2")],
        }[part]
        replicated = None
        for name, n, configuration, patch, solver, against in runs:
            restore = patch() if patch else None
            if part != "L3":  # the sharded steps' moments: rank 0 holds them whole
                keep = ("moment",) + (("unreduced",) if name == "default" else ())
                keep = keep if mesh.rank == 0 else ()
            elif name == "replicated":  # rank 0 the whole moment; every rank the final values
                keep = ("final",) + (("moment", "update") if mesh.rank == 0 else ())
            else:  # ZeRO: every rank its shards of the moment and of the final values
                keep = ("final", "moment")
            try:
                with configuration():
                    run_sections = dict(sections,
                                        solver={**sections.get("solver", {}), **solver})
                    got = l_training(stage, n, work, dev, keep, (), **run_sections)
            finally:
                if restore:
                    restore()
            got["rel_l2"], got["top"], _ = distance(
                got, os.path.join(part_dir, f"{against}.npy"), "moment")
            if name == "default":  # the not-all-reduced control, from its first step
                first = "default_1" if part == "L1" else "default"
                control = {k: v for k, v in got.items() if k != "unreduced"}
                control["moment"] = got.pop("unreduced", None)
                control["rel_l2"], control["top"], _ = distance(
                    control, os.path.join(part_dir, f"{first}.npy"), "moment")
                out[part][UNREDUCED] = {k: control[k] for k in ("rel_l2", "top")}
            if name == "replicated":  # the update's squared norm, the final values
                got["update_sq"] = distance(got, got.get("update"), "update")[2]
                replicated = got.pop("final")
            elif name == "zero":
                # ZeRO's final values against the replicated step's
                rep_sq = out[part]["replicated"]["update_sq"]
                got["rel_l2_replicated"], got["top_replicated"], _ = distance(
                    got, replicated, "final", den=rep_sq)
                replicated = None
                # the control: the clip from this rank's shards alone
                cap = got["max_grad_norm"]
                scale = (clip_factor(got["local_norms"][0], cap)
                         / clip_factor(got["norms"][0], cap))
                got["rel_l2_local_clip"], _, _ = distance(
                    got, os.path.join(part_dir, f"{against}.npy"), "moment", scale=scale)
            for key in ("moment", "snaps", "update", "final"):
                got.pop(key, None)
            dist.barrier()
            out[part][name] = got
        torch.cuda.empty_cache()
    return out


def l_phase_text(run: dict) -> str:
    """Seconds of each phase, step by step (the first step's batch phase
    holds the build of the networks), and each phase's peak GiB."""
    return (" ".join(f"{k} {[round(x, 3) for x in v]}" for k, v in run["phases"].items())
            + " s | peak " + " ".join(f"{k} {v:.2f}" for k, v in run["peaks"].items()) + " GiB")


def fresh_l_root() -> str:
    """Request L's working directory, emptied: the references write their
    first moments there, the ranks read them."""
    import shutil

    shutil.rmtree(L_ROOT, ignore_errors=True)
    os.makedirs(L_ROOT)
    return L_ROOT


def references_rank(l_root: str) -> tuple:
    """Request K's one-rank reference, then request L's (writing L's first
    moments under ``l_root``), in one process of a world of one."""
    import gc

    ref_k = request_k_rank(False, False)
    gc.collect()
    torch.cuda.empty_cache()
    return ref_k, request_l_rank(tuple(L_PARTS), l_root)


def k_and_l1_rank(l_root: str, memory_fraction: float) -> tuple:
    """One of K_RANKS (= L1_RANKS) gloo ranks: request K's parts, then request
    L1's, in one process, process group and memory cap."""
    import gc

    got_k = request_k_rank(True, False, memory_fraction)
    gc.collect()
    torch.cuda.empty_cache()
    return got_k, request_l_rank(("L1",), l_root, memory_fraction)


def rank_share(dev, n: int) -> tuple:
    """A rank's memory cap for ``n`` ranks on the card, in GiB: an equal share
    of the free memory less K_CONTEXT_GIB a rank; and the free and total
    bytes."""
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info(dev)
    return (free / 2**30 - n * K_CONTEXT_GIB) / n, free, total


def shared_processes(dev) -> tuple:
    """The processes requests K and L can share: the one-rank references of
    both in one process, then K's and L1's ranks in one spawn of K_RANKS.
    Returns K's reference, L's, and for K and for L1 the ranks' readings with
    (cap GiB, free, total bytes, seconds of the spawn)."""
    from mikudance_tpu_torch.core import mesh as mesh_lib

    check(K_RANKS == L1_RANKS, f"K and L1 share their ranks: {K_RANKS} and {L1_RANKS}")
    root = fresh_l_root()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ref_k, ref_l = mesh_lib.spawn(1, references_rank, (root,), timeout=1500)[0]
    log(f"requests K and L: the one-rank references of K's parts and of "
        f"{', '.join(L_PARTS)} in one process, {time.perf_counter() - t0:.1f} s (the "
        f"process and its builds included)")
    share, free, total = rank_share(dev, K_RANKS)
    t0 = time.perf_counter()
    got = mesh_lib.spawn(K_RANKS, k_and_l1_rank, (root, share * 2**30 / total), timeout=2100)
    placed = (share, free, total, time.perf_counter() - t0)
    return (ref_k, ref_l, ([g[0] for g in got],) + placed, ([g[1] for g in got],) + placed)


def request_l(dev, ref: dict = None, l1: tuple = None) -> dict:
    """Request L on the one card: the one-rank reference of every part, then
    for each group of parts the gloo ranks, each capped at an equal share of
    the card (``ref`` and L1's ranks ``l1``, ``shared_processes``' readings,
    where they were run, else processes of their own); every rank's trained
    weights identical, the losses, gradient norms and first moments held to
    the reference's, the controls beyond the limits; then L4, the graft
    entry. Returns rank 0's launches by run."""
    import shutil

    from mikudance_tpu_torch import graft_entry
    from mikudance_tpu_torch.core import mesh as mesh_lib
    from mikudance_tpu_torch.kernels import flash_attention as fa
    from mikudance_tpu_torch.kernels import group_norm as gn
    from mikudance_tpu_torch.kernels import layer_norm as ln
    from mikudance_tpu_torch.kernels import temporal_attention as ta

    kernels = kernel_list()
    root = L_ROOT
    failures, launches, ran = [], {}, set()

    def hold(ok: bool, what: str) -> None:
        log(("" if ok else "FAILED: ") + what)
        if not ok:
            failures.append(what)

    rel = lambda a, b: abs(a - b) / abs(b)  # noqa: E731
    apart = lambda a, b: max(rel(x, y) for x, y in zip(a, b))  # noqa: E731
    nonzero = lambda counts: {k: v for k, v in counts.items() if v}  # noqa: E731
    if ref is None:
        fresh_l_root()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ref = mesh_lib.spawn(1, request_l_rank, (tuple(L_PARTS), root), timeout=900)[0]
        log(f"request L: the one-rank references of {', '.join(L_PARTS)} in one process, "
            f"{time.perf_counter() - t0:.1f} s (the process and its builds included)")
    for parts in (("L1",), ("L2", "L3")):
        n = L_PARTS[parts[0]][2]
        if parts == ("L1",) and l1 is not None:
            got, share, free, total, ranks_s = l1
            ranks_text = f"{n} ranks with K's {ranks_s:.1f} s"
        else:
            share, free, total = rank_share(dev, n)
            t0 = time.perf_counter()
            got = mesh_lib.spawn(n, request_l_rank, (parts, root, share * 2**30 / total),
                                 timeout=1500)
            ranks_text = f"{n} ranks {time.perf_counter() - t0:.1f} s"
        if parts == ("L1",):  # one rank, one step through K1 and through K10 / K12
            routes, _, _ = distance(
                {"moment": {"all": torch.from_numpy(np.load(os.path.join(root, "L1",
                                                                         "transposed.npy")))},
                 "shapes": {"all": (-1,)}, "plan": {"all": None}},
                {"all": torch.from_numpy(np.load(os.path.join(root, "L1", "default_1.npy")))},
                "moment")
            log(f"request L, L1: one rank, the first step's moment through K1 against through "
                f"K10 / K12 (transposed()): relative L2 {routes:.3e}, the spread of bf16 "
                f"rounding over two routes of one function")
        r0 = got[0]
        log(f"request L, {' and '.join(parts)}: world {r0['world']}, backend {r0['backend']}, "
            f"each rank's allocator capped at {share:.2f} GiB ({free / 2**30:.2f} of "
            f"{total / 2**30:.2f} GiB free, less {K_CONTEXT_GIB} GiB a rank) | {ranks_text} "
            f"(processes and builds included); the ranks time-share one card "
            f"and move their collectives through the host: no scaling is measured")
        for part in parts:
            stage, sections, _ = L_PARTS[part]
            loss_lim, norm_lim, moment_lim = L_LIMITS[part]
            logged = set()
            for name, mine in r0[part].items():
                if name == UNREDUCED:
                    hold(mine["rel_l2"] > moment_lim,
                         f"request L, {part}, {name}, the first step's moment from rank 0's "
                         f"own gradients (read in the default run): relative L2 "
                         f"{mine['rel_l2']:.3e} (limit {moment_lim}) | control beyond the limit")
                    continue
                control = name.startswith("control")
                base = {"L1": "transposed" if name == "transposed" else "default",
                        "L2": "default", "L3": "one rank, batch 2"}[part]
                want = ref[part][base]
                k = len(mine["losses"])
                d_loss = apart(mine["losses"], want["losses"][:k])
                d_norm = apart(mine["norms"], want["norms"][:k])
                text = (f"request L, {part} ({stage} {sections}), {name}: mesh {mine['mesh']}, "
                        f"{mine['trained']} trained tensors ({mine['elements'] / 1e9:.3f} G "
                        f"elements), optimizer state {mine['state_bytes'] / 2**30:.3f} GiB a rank "
                        f"(one rank: {want['state_bytes'] / 2**30:.3f}) | losses "
                        f"{mine['losses']} against {want['losses'][:k]} (apart by {d_loss:.3e}, "
                        f"limit {loss_lim}), gradient norms {mine['norms']} against "
                        f"{want['norms'][:k]} (apart by {d_norm:.3e}, limit {norm_lim}) | first "
                        f"moment relative L2 {mine['rel_l2']:.3e} (limit {moment_lim}; most of "
                        f"it in: {mine['top']})")
                if control:
                    hold(mine["rel_l2"] > moment_lim, text + " | control beyond the limit")
                    continue
                same = all(r[part][name]["digest"] == mine["digest"] for r in got)
                text += f" | every rank's trained weights identical: {same}"
                ok = (same and d_loss < loss_lim and d_norm < norm_lim
                      and mine["rel_l2"] < moment_lim)
                if part == "L1" and name == "default":
                    ok = ok and mine["mesh"] == {"data": 1, "frame": L1_RANKS}
                if part == "L3" and name == "zero":
                    rep = r0[part]["replicated"]
                    l_rep, n_rep = apart(mine["losses"], rep["losses"]), apart(mine["norms"],
                                                                               rep["norms"])
                    ratio = mine["state_bytes"] / rep["state_bytes"]
                    ctl = mine["rel_l2_local_clip"]
                    text += (f" | against the replicated step: final master values relative "
                             f"to its update {mine['rel_l2_replicated']:.3e} (limit "
                             f"{L3_ZERO_REL_L2}; most of it in: {mine['top_replicated']}), loss "
                             f"apart by {l_rep:.3e}, gradient norm by {n_rep:.3e} (limits "
                             f"{L3_ZERO_NORM_REL}); state {ratio:.3f}x the replicated (limit "
                             f"{L_ZERO_BYTES}) | control, the clip's norm from the local "
                             f"shards alone ({mine['local_norms']}): first moment relative L2 "
                             f"{ctl:.3e} (limit {moment_lim})")
                    ok = (ok and mine["rel_l2_replicated"] < L3_ZERO_REL_L2
                          and l_rep < L3_ZERO_NORM_REL and n_rep < L3_ZERO_NORM_REL
                          and ratio <= L_ZERO_BYTES and ctl > moment_lim)
                hold(ok, text)
                if base not in logged:
                    logged.add(base)
                    log(f"request L, {part}, {base}, one rank: {want['wall']:.1f} s | "
                        f"{l_phase_text(want)} | launches {nonzero(want['launches'])}")
                for r in got:
                    run = r[part][name]
                    log(f"request L, {part}, {name}, rank {r['rank']}: {run['wall']:.1f} s | "
                        f"{l_phase_text(run)} | launches {nonzero(run['launches'])}")
                    ran |= {k for k, v in run["launches"].items() if v}
                launches[f"{part} {name}"] = mine["launches"]
        del got
    shutil.rmtree(root, ignore_errors=True)
    del ref
    on_l = [fa.K1, fa.K2, ta.K3, fa.K4, gn.K5, ln.K6, fa.K10, fa.K12]
    hold(all(k.name in ran for k in on_l),
         f"request L: kernels launched on the ranks: {sorted(ran)}")

    # L4: the graft entry's forward, then its dry run on 4 ranks of the card
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    fn, args = graft_entry.entry()
    for k in kernels:
        k.launches = 0
    out = fn(*args)
    torch.cuda.synchronize(dev)
    entry_s = time.perf_counter() - t0
    launches["L4 entry"] = {k.name: k.launches for k in kernels}
    hold(out.shape == (1, 4, 64, 64, 4) and out.dtype == torch.bfloat16
         and bool(torch.isfinite(out.float()).all()),
         f"request L, L4: entry() forward {tuple(out.shape)} {out.dtype}, finite, built and "
         f"run in {entry_s:.1f} s, launches {nonzero(launches['L4 entry'])}")
    del fn, args, out
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    lines = graft_entry.dryrun_multichip(4)
    hold(len(lines) == 5, f"request L, L4: dryrun_multichip(4) on the card in "
                          f"{time.perf_counter() - t0:.1f} s: {lines}")
    check(not failures, f"request L: {failures}")
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="device-time breakdown of requests A, B, E and of one request-F "
                         "train step instead of the smoke")
    ap.add_argument("--train", action="store_true",
                    help="build, then requests F and G alone (the trainers, the mega-block)")
    ap.add_argument("--budgets", action="store_true",
                    help="peak memory of one-step 768^2 requests as the clip grows")
    ap.add_argument("--kernels", metavar="K7,K8",
                    help="build, hold the named kernels to their plain versions, and stop")
    ap.add_argument("--request-h", action="store_true",
                    help="build, then request H (1024^2, both configurations) alone")
    ap.add_argument("--request-i", action="store_true",
                    help="build, then request I (the toolbox's networks) alone; with "
                         "--profile, UniPose's device time by part and kernel category")
    ap.add_argument("--request-j", action="store_true",
                    help="build, then request J (fp32 requests, the SD-width fidelity gate, "
                         "verify_parity --selfcheck) alone")
    ap.add_argument("--request-k", action="store_true",
                    help="build, then request K (4 ranks on the card over gloo: the sharded "
                         "sampler against its one-rank run) alone")
    ap.add_argument("--request-l", action="store_true",
                    help="build, then request L (gloo ranks on the card: the sharded trainers "
                         "against their one-rank runs, the graft entry) alone")
    ap.add_argument("--request-d", action="store_true",
                    help=f"build, then request D alone, {D_RUNS} times in one process (its "
                         f"run-to-run spread)")
    args = ap.parse_args()
    # one card, the first visible one, fixed before CUDA initialises
    card = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0].strip()
    os.environ["CUDA_VISIBLE_DEVICES"] = card
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs on the card")
    check(torch.cuda.device_count() == 1, f"one card, got {torch.cuda.device_count()}")
    from mikudance_tpu_torch.core.configs import ContextConfig, PipelineConfig
    from mikudance_tpu_torch.kernels import _build, row_major, transposed
    from mikudance_tpu_torch.kernels import mega_block as mb
    from mikudance_tpu_torch.kernels import conv2d as cv
    from mikudance_tpu_torch.kernels import flash_attention as fa
    from mikudance_tpu_torch.kernels import geglu as gg
    from mikudance_tpu_torch.kernels import group_norm as gn
    from mikudance_tpu_torch.kernels import layer_norm as ln
    from mikudance_tpu_torch.kernels import linear as lin
    from mikudance_tpu_torch.kernels import temporal_attention as ta
    from mikudance_tpu_torch.pipelines.image import ImagePipeline
    from mikudance_tpu_torch.pipelines.video import ModelBundle, VideoPipeline

    dev = torch.device("cuda", 0)
    kernels = kernel_list()
    # the row-major configuration's kernels launch only inside row_major();
    # K12 only inside transposed(); K14 is the probe's and on no model's path
    row_major_only = (lin.K7, cv.K8, fa.K10, fa.K11)
    off_the_sampler = (fa.K12, mb.K14)
    default_kernels = [k for k in kernels if k not in row_major_only + off_the_sampler]
    # K9 and K13 take only maps under 512^2: requests A, B and C run at 768^2
    at_768 = [k for k in default_kernels if k not in (fa.K9, ta.K13)]

    def reset_counts() -> None:
        for k in kernels:
            k.launches = 0

    def same_launches(what: str, counts: dict) -> None:
        if what in K1_K4_LAUNCHES:
            got = (counts[fa.K1.name], counts[fa.K4.name])
            check(got == K1_K4_LAUNCHES[what],
                  f"{what}: K1 / K4 launched {got} times, {K1_K4_LAUNCHES[what]} before")
        want = K2_K10_LAUNCHES[what]
        got = tuple(None if n is None else counts[k.name]
                    for n, k in zip(want, (fa.K2, fa.K10)))
        check(got == want, f"{what}: K2 / K10 launched {got} times, {want} before")
        want = K11_K12_LAUNCHES.get(what, (0, 0))
        got = (counts[fa.K11.name], counts[fa.K12.name])
        check(got == want, f"{what}: K11 / K12 launched {got} times, {want} before")
        if what in K3_K13_LAUNCHES:
            got = (counts[ta.K3.name], counts[ta.K13.name])
            check(got == K3_K13_LAUNCHES[what],
                  f"{what}: K3 / K13 launched {got} times, {K3_K13_LAUNCHES[what]} before")

    def read_counts(what: str, expect=default_kernels, absent=row_major_only,
                    also_absent=off_the_sampler) -> dict:
        counts = {k.name: k.launches for k in kernels}
        missing = [k.name for k in expect if k.launches == 0]
        check(not missing, f"{what}: kernels not launched: {missing}")
        stray = [k.name for k in tuple(absent) + tuple(also_absent) if k.launches]
        check(not stray, f"{what}: kernels launched that are not on this path: {stray}")
        return counts

    # 1. card
    smi = subprocess.run(["nvidia-smi", "-i", card, "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions' fp32 scores
    torch.backends.cudnn.allow_tf32 = False
    log(f"card: {torch.cuda.get_device_name(0)} | {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda} | matmul.allow_tf32=False cudnn.allow_tf32=False")

    # 2. build
    t0 = time.perf_counter()
    lib = _build.build()
    _build.load()
    log(f"build: {lib.name} in {time.perf_counter() - t0:.1f} s "
        f"(ptxas report: {lib.with_suffix('.log')})")
    log("ptxas: " + ptxas_report(lib.with_suffix(".log").read_text(),
                                 ("anchor_wg_kernel", "flash_cross_kernel", "flash_wide_kernel",
                                  "linear_kernel", "conv3x3_kernel", "short_attention_kernel",
                                  "gn_resident_kernel", "gn_stream_stats_kernel",
                                  "gn_stream_apply_kernel", "ln_kernel", "mega_kernel",
                                  "geglu_kernel")))
    log("kernels: " + "; ".join(f"{k.name} = {k.symbol} in {k.source}, replaces {k.replaces}"
                                for k in kernels))

    cfg = PipelineConfig(width=W, height=H, num_inference_steps=STEPS, guidance_scale=3.5,
                         context=ContextConfig(frames=30, overlap=8))
    d_config = PipelineConfig(  # request D
        width=D_SIZE, height=D_SIZE, num_inference_steps=D_STEPS, guidance_scale=3.5,
        context=ContextConfig(frames=30, overlap=8), max_denoise_frame_batch=64,
        cached_bank_positions=64)

    def headline_pipes():
        """Request A's pipeline (SD VAE) and request B's (same UNets and
        encoder, the temporal decoder and the CLIP tower)."""
        t0 = time.perf_counter()
        bundle = build_bundle(0, dev)
        clip, temporal = build_slice_b_parts(10, dev)
        bundle_b = ModelBundle(bundle.guide, bundle.den, bundle.vae_enc, temporal, clip)
        log(f"bundles: SD1.5 widths, CLIP ViT-L/14 tower, both decoders, bf16, built in "
            f"{time.perf_counter() - t0:.1f} s")
        return bundle, VideoPipeline(bundle, cfg), bundle_b, VideoPipeline(bundle_b, cfg)

    def training_phases():
        """Requests F and G; returns their launch counts (F transposed, F
        default, the stage-1 steps, G)."""
        # 15. request F: the stage-2 trainer at the reference's geometry, a few
        # optimizer steps, in the transposed configuration and in the default one
        train_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                                 "chip_smoke")
        before = initial_stage2_weights(dev)
        runs = {}
        # the default configuration first: the transposed run's state is kept
        # for the small step below, the default run's is dropped at once
        for name, configuration in (("default", contextlib.nullcontext),
                                    ("transposed", transposed)):
            reset_counts()
            t0 = time.perf_counter()
            with configuration():
                state, records, phases, peaks = run_training("stage2", TRAIN_STEPS,
                                                             os.path.join(train_dir, name), dev)
            wall = time.perf_counter() - t0
            on_f = [fa.K2, ta.K3, fa.K4, gn.K5, ln.K6, gg.K15] + (
                [fa.K12, fa.K10] if name == "transposed" else [fa.K1])
            launches = read_counts(f"request F ({name})", on_f,
                                   absent=[k for k in kernels if k not in on_f], also_absent=())
            same_launches(f"request F ({name})", launches)
            losses = [r["train_loss"] for r in records]
            norms = [r["grad_norm"] for r in records]
            check(all(math.isfinite(v) for v in losses + norms), f"request F ({name}): {records}")
            named = {**{f"guide.{k}": v.cpu() for k, v in state.guide.state_dict().items()},
                     **{f"den.{k}": v.cpu() for k, v in state.den.state_dict().items()}}
            trainable = set(state.trainable)
            check(trainable == {n for n in named if "motion" in n or "man_" in n}
                  and 0 < len(trainable) < len(named),
                  f"request F ({name}): the trainable partition")
            moved = sum(not torch.equal(named[n], before[n]) for n in trainable)
            frozen_moved = [n for n in named if n not in trainable
                            and not torch.equal(named[n], before[n])]
            check(not frozen_moved,
                  f"request F ({name}): frozen parameters moved: {frozen_moved[:3]}")
            check(moved > len(trainable) // 2,
                  f"request F ({name}): {moved} of {len(trainable)} trainable tensors moved")
            check(all(p.dtype == torch.bfloat16 for p in state.den.parameters())
                  and all(m.dtype == torch.float32 for m in state.optimizer.master.values()),
                  f"request F ({name}): bf16 modules, fp32 master copies")
            log(f"request F ({name}): stage 2, {TRAIN_FRAMES}x{TRAIN_SIZE}x{TRAIN_SIZE}, batch "
                f"1, bf16, remat on, {TRAIN_STEPS} optimizer steps in {wall:.1f} s | "
                f"{training_text(phases, peaks)} | losses {losses} | gradient norms {norms} | "
                f"{moved} of {len(trainable)} trainable tensors moved, "
                f"{len(named) - len(trainable)} frozen ones bit-identical | launches {launches}")
            runs[name] = (losses, norms, launches, state if name == "transposed" else None)
            del named, state
        del before
        (loss_t, norm_t, launches_f, state), (loss_d, norm_d, launches_f_default, _) = \
            runs["transposed"], runs["default"]
        runs.clear()
        # the same draws through K12 + K10 and through K1: the first step's loss and
        # gradient norm come from identical weights; later steps follow weights that
        # already differ by one bf16-rounded update. The control: another step's
        # draws (step 2 against step 1).
        rel = lambda a, b: abs(a - b) / abs(b)  # noqa: E731
        d_loss = [rel(a, b) for a, b in zip(loss_t, loss_d)]
        d_norm = [rel(a, b) for a, b in zip(norm_t, norm_d)]
        ctl_loss = rel(loss_t[1], loss_d[0])
        log(f"request F, transposed against default, same draws: loss apart by {d_loss} (limit "
            f"{F_LOSS_REL}; control, another step's draws, {ctl_loss:.3e}), gradient norm apart "
            f"by {d_norm} (limit {F_NORM_REL})")
        check(max(d_loss) < F_LOSS_REL < ctl_loss,
              f"request F: losses {d_loss}, control {ctl_loss}")
        check(max(d_norm) < F_NORM_REL, f"request F: gradient norms {d_norm}")

        # a small train step (stage 2, full widths, 4 frames at 256^2) through the
        # kernels and with every wrapper forced to its plain version
        from mikudance_tpu_torch.diffusion.ddim import DDIMSchedule
        from mikudance_tpu_torch.train.steps import TrainConfig

        tcfg = TrainConfig(trainable_substrings=("motion", "man_"))
        schedule = DDIMSchedule.create(beta_schedule="linear")
        batch, draws = small_train_batch(dev, 11)
        reset_counts()
        loss_k, grads_k = loss_and_gradients(state, tcfg, schedule, batch, draws)
        used = [k.name for k in kernels if k.launches > 0]
        with plain_kernels():
            counts = {k.name: k.launches for k in kernels}
            loss_p, grads_p = loss_and_gradients(state, tcfg, schedule, batch, draws)
            check(counts == {k.name: k.launches for k in kernels},
                  "the plain step launched a kernel")
        # the control: the sample's banks and tokens switched off
        zero_bank = {**batch, "uncond": torch.ones(1, device=dev)}
        loss_c, grads_c = loss_and_gradients(state, tcfg, schedule, zero_bank, draws)
        rel_g, rel_c = rel_l2(flat(grads_k), flat(grads_p)), rel_l2(flat(grads_c), flat(grads_p))
        log(f"check, train step: stage 2, 4x256x256, kernels {used} vs plain versions: loss "
            f"{loss_k:.6f} vs {loss_p:.6f} (apart by {rel(loss_k, loss_p):.3e}, limit "
            f"{SMALL_STEP_LOSS_REL}), relative L2 of all {len(grads_k)} gradients {rel_g:.3e} "
            f"(limit {SMALL_STEP_GRAD_REL_L2}; control, the conditioning dropped: loss "
            f"{loss_c:.6f}, gradients {rel_c:.3e})")
        check(rel(loss_k, loss_p) < SMALL_STEP_LOSS_REL and grads_k.keys() == grads_p.keys()
              and rel_g < SMALL_STEP_GRAD_REL_L2 < rel_c,
              f"small train step: loss {loss_k} vs {loss_p}, gradients {rel_g} (control {rel_c})")
        check(used == [k.name for k in (fa.K1, fa.K2, ta.K3, gn.K5, ln.K6, gg.K15)],
              f"small train step: kernels {used}")
        del state, grads_k, grads_p, grads_c, batch, draws
        torch.cuda.empty_cache()

        # one stage-1 step at 768^2 (both UNets train; batch cut from 8 to 1)
        reset_counts()
        t0 = time.perf_counter()
        state1, records1, phases1, peaks1 = run_training(
            "stage1", 2, os.path.join(train_dir, "stage1"), dev, data={"train_bs": 1})
        wall = time.perf_counter() - t0
        launches_s1 = read_counts("stage-1 steps", [fa.K1, fa.K2, fa.K4, gn.K5, ln.K6],
                                  absent=[ta.K3, fa.K9, ta.K13])
        same_launches("stage-1 steps", launches_s1)
        check(all(math.isfinite(r["train_loss"]) and math.isfinite(r["grad_norm"])
                  for r in records1)
              and len(state1.trainable) == len(list(state1.guide.parameters()))
              + len(list(state1.den.parameters())), f"stage-1 steps: {records1}")
        log(f"stage-1 steps: 768x768, batch 1, bf16, 2 optimizer steps in {wall:.1f} s | "
            f"{training_text(phases1, peaks1)} | losses {[r['train_loss'] for r in records1]} | "
            f"launches {launches_s1}")
        del state1
        torch.cuda.empty_cache()

        # 16. request G: the mega-block probe against the block's read path
        block, ins, w = mega_inputs(dev, MEGA_LEVELS[0], seed=6)
        read_path = block_read_path(block, *ins)
        reset_counts()
        out_g = mb.mega_block(*ins, w)
        torch.cuda.synchronize()
        launches_g = {k.name: k.launches for k in kernels}
        check(launches_g[mb.K14.name] == 1 and sum(launches_g.values()) == 1,
              f"request G: one launch of K14 and nothing else, got {launches_g}")
        want_g = read_path()
        zero = torch.zeros_like(ins[1])
        rel_g = rel_l2(out_g, want_g)
        rel_g_ctl = rel_l2(mb.mega_block(ins[0], zero, zero, ins[3], ins[4], w), want_g)
        check(out_g.shape == ins[0].shape and bool(torch.isfinite(out_g.float()).all()),
              "request G: finite output of the input's shape")
        ms_g, ms_read = cuda_ms(lambda: mb.mega_block(*ins, w), 5), cuda_ms(read_path, 5)
        log(f"request G: mega-block probe x{MEGA_LEVELS[0]} in one launch {ms_g:.3f} ms; the "
            f"port's TransformerBlock read path on the same weights {ms_read:.3f} ms; relative L2 "
            f"between them {rel_g:.3e} (limit {G_REL_L2}: tanh for erf GELU, an fp32 for a bf16 residual "
            f"stream; control without the bank K/V {rel_g_ctl:.3e})")
        check(rel_g < G_REL_L2 < rel_g_ctl, f"request G: {rel_g:.3e} and the control "
                                            f"{rel_g_ctl:.3e} on either side of {G_REL_L2}")
        log(f"request G: K14 {mega_split_text(ins, w)}")
        del block, ins, w, out_g, want_g, zero

        return launches_f, launches_f_default, launches_s1, launches_g

    def request_h(bundle):
        """Request H: 16 frames at 1024^2 (SD1.5 widths, CFG 3.5, 2 steps, the SD
        decoder), once in the default configuration and once inside
        ``row_major()``, with the shape arguments of the launches of K1, K2,
        K4, K5, K8, K10 and K11 recorded: heads of 160 at level 2 (1024
        tokens) reach K1 and K2, or K10 in row-major; K4 takes the VAE
        encoder's (8, 16384, 512); K5 and K8 the VAE's 1024^2 maps. The
        row-major latents are held to the default ones as request E's are to
        warm request A's (control: the bank K/V left out of the chain).
        Returns the launches of both runs."""
        pipe_h = VideoPipeline(bundle, PipelineConfig(
            width=H_SIZE, height=H_SIZE, num_inference_steps=H_STEPS, guidance_scale=3.5,
            context=ContextConfig(frames=30, overlap=8)))
        inputs = make_inputs(9, T, H_SIZE, H_SIZE)
        spied = (fa.K1, fa.K2, fa.K4, gn.K5, cv.K8, fa.K10, fa.K11)
        on_default = list(at_768)
        on_row_major = [k for k in at_768 if k is not fa.K1] + list(row_major_only)
        runs = {}
        for name, configuration, expect in (
                ("request H", contextlib.nullcontext, on_default),
                ("request H (row-major)", row_major, on_row_major)):
            shapes = {k.name: [] for k in spied}
            for k in spied:
                k.launch = launch_spy(k.launch, lambda a, sl=SHAPE_ARGS[k.symbol]: tuple(a[sl]),
                                      shapes[k.name])
            try:
                with configuration():
                    reset_counts()
                    torch.cuda.reset_peak_memory_stats(dev)
                    t0 = time.perf_counter()
                    frames, latents, timer = run_request(pipe_h, inputs, H_STEPS)
                    wall = time.perf_counter() - t0
                    counts = read_counts(name, expect, absent=[
                        k for k in kernels if k not in expect])
            finally:
                for k in spied:
                    del k.launch
            check_video(frames, latents, T, name, H_SIZE, H_SIZE)
            shapes = {n: sorted(set(v)) for n, v in shapes.items()}
            big_map = H_SIZE * H_SIZE
            attn = {n: v for n, v in shapes.items() if n not in (gn.K5.name, cv.K8.name)}
            log(f"{name}: {T}x{H_SIZE}x{H_SIZE} {H_STEPS} steps in {wall:.3f} s | "
                f"{phase_text(timer)} | peak {max(timer.peaks.values()):.2f} GiB | launches "
                f"{counts} | shapes {attn} | K5 at the {H_SIZE}^2 maps (images, rows, channels) "
                f"{[x for x in shapes[gn.K5.name] if x[1] == big_map]} | K8 at the {H_SIZE}^2 "
                f"maps (images, height, width, cin, cout) "
                f"{[x for x in shapes[cv.K8.name] if x[1:3] == (H_SIZE, H_SIZE)]} | latents std "
                f"{latents.std().item():.4f}")

            def took(kern, index, value):
                return any(x[index] == value for x in shapes[kern.name])

            check(took(gn.K5, 1, big_map), f"{name}: K5 at the {H_SIZE}^2 maps")
            if configuration is row_major:
                check(took(fa.K10, 3, 160) and took(fa.K11, 3, 40) and took(fa.K11, 3, 80)
                      and any(x[1:3] == (H_SIZE, H_SIZE) for x in shapes[cv.K8.name]),
                      f"{name}: K10 at heads of 160, K11 at 40 and 80, K8 at {H_SIZE}^2")
            else:
                check(took(fa.K1, 3, 160) and took(fa.K1, 3, 40) and took(fa.K1, 3, 80)
                      and took(fa.K2, 4, 160)
                      and (8, (H_SIZE // 8) ** 2, 1, 512) in shapes[fa.K4.name],
                      f"{name}: K1 at heads of 40, 80 and 160, K2 at 160, K4 at the encoder's "
                      f"(8, {(H_SIZE // 8) ** 2}, 512)")
            runs[name] = (frames, latents, counts)
        (frames_d, lat_d, launches_h), (frames_r, lat_r, launches_h_rm) = runs.values()
        lat_ctl = row_major_without_bank(pipe_h, inputs, H_STEPS)
        rel, rel_ctl = rel_l2(lat_r, lat_d), rel_l2(lat_ctl, lat_d)
        rel_frames = rel_l2(torch.from_numpy(frames_r), torch.from_numpy(frames_d))
        log(f"request H, row-major against default, relative L2: latents {rel:.3e} (limit "
            f"{E_REL_L2}; control without the bank K/V {rel_ctl:.3e}), decoded frames "
            f"{rel_frames:.3e}")
        check(rel < E_REL_L2 < rel_ctl, f"request H latents {rel:.3e} and the control "
                                        f"{rel_ctl:.3e} on either side of {E_REL_L2}")
        for name, (_, _, counts) in runs.items():
            got = {k.name.split(" ")[0]: n for k in kernels if (n := counts[k.name])}
            check(got == H_LAUNCHES.get(name), f"{name}: launches {got}, recorded "
                                               f"{H_LAUNCHES.get(name)}")
        del runs, frames_d, lat_d, frames_r, lat_r, lat_ctl, pipe_h
        torch.cuda.empty_cache()
        return launches_h, launches_h_rm

    def request_j(bundle) -> dict:
        """Request J: J1 the SD-width gate in both dtypes, J2 verify_parity
        --selfcheck, J3 request A in fp32 against its bf16 launches. Returns
        J3's fp32 launches."""
        import copy

        from mikudance_tpu_torch.scripts import psnr_sd_width, verify_parity

        # J1: the SD-width twins once, the oracle once, the port in fp32 and bf16
        t0 = time.perf_counter()
        records = psnr_sd_width.run_gate(("fp32", "bf16"), steps=J_GATE_STEPS, device=dev,
                                         log=log)
        for rec in records:
            log(f"request J1: {rec['metric']}: PSNR {rec['psnr_db']:.3f} dB (bar "
                f"{rec['bar_db']}), latents max abs error {rec['latent_max_abs_err']:.3e}, "
                f"port {rec['elapsed_s']:.3f} s (oracle {rec['oracle_s']:.3f} s), peak "
                f"{rec['peak_gib']:.2f} GiB, launches {rec['launches']} | {rec['device']}")
            check(all(rec["launches"].get(k, 0) > 0 for k in ("K1", "K2", "K3")),
                  f"request J1: K1, K2 and K3 launched: {rec['launches']}")
            check(rec["pass"], f"request J1: PSNR {rec['psnr_db']:.3f} dB under the "
                               f"{rec['bar_db']} dB bar ({rec['metric']})")
        log(f"request J1: both gates in {time.perf_counter() - t0:.1f} s")
        torch.cuda.empty_cache()

        # J2: the tiny twins' selfcheck on the card
        t0 = time.perf_counter()
        verdict = verify_parity.run_selfcheck(dev)
        log(f"request J2: verify_parity --selfcheck on the card in "
            f"{time.perf_counter() - t0:.1f} s: {json.dumps(verdict)}")
        check(verdict["pass"], f"request J2: verify_parity --selfcheck: {verdict}")

        # J3: request A in fp32 against the same request in bf16, 2 steps
        inputs = make_inputs(0, T, H, W)
        runs = {}
        for name, b in (("bf16", bundle), ("fp32", None)):
            if b is None:  # the same weights in fp32: UNets and SD VAE
                b = ModelBundle(*(copy.deepcopy(m).float() for m in (
                    bundle.guide, bundle.den, bundle.vae_enc, bundle.vae_dec)))
            pipe_j = VideoPipeline(b, cfg)
            reset_counts()
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            frames, latents, timer = run_request(pipe_j, inputs, J3_STEPS)
            wall = time.perf_counter() - t0
            counts = read_counts(f"request J3 ({name})", at_768)
            check_video(frames, latents, T, f"request J3 ({name})")
            check(latents.dtype == torch.float32, f"request J3 ({name}): latents {latents.dtype}")
            log(f"request J3 ({name}): {T}x{H}x{W} {J3_STEPS} steps in {wall:.3f} s | "
                f"{phase_text(timer)} | peak {max(timer.peaks.values()):.2f} GiB | launches "
                f"{counts} | latents std {latents.std().item():.4f}")
            runs[name] = (latents, counts)
            del pipe_j, frames, b
        (lat_b, counts_b), (lat_f, counts_f) = runs["bf16"], runs["fp32"]
        check(counts_f == counts_b, f"request J3: fp32 launches {counts_f} against bf16 "
                                    f"{counts_b}")
        check(all(counts_f[k.name] > 0 for k in (fa.K1, fa.K2, ta.K3, fa.K4)),
              f"request J3: K1-K4 launched in fp32: {counts_f}")
        log(f"request J3: fp32 against bf16 latents, relative L2 {rel_l2(lat_f, lat_b):.3e} "
            f"(both finite; launches equal)")
        del runs, lat_b, lat_f
        torch.cuda.empty_cache()
        return counts_f

    def run_request_i() -> dict:
        """Request I with the kernel counts at 0 before it: no kernel of K1-K15
        may launch on the toolbox's path."""
        reset_counts()
        readings = request_i(dev, profile=args.profile)
        read_counts("request I", expect=(), absent=kernels, also_absent=())
        log(f"request I: launches of K1-K15: {sum(k.launches for k in kernels)}")
        return readings

    if args.request_i:
        run_request_i()
        return 0
    if args.budgets:
        phase_budgets(build_bundle(0, dev), dev)
        return 0
    if args.profile and args.train:  # the train step's profile alone
        profile_train_step(dev)
        return 0
    if args.profile:
        _, pipe, _, pipe_b = headline_pipes()
        phase_profile(pipe, lambda steps: run_request_b(pipe_b, 5, steps))
        del pipe, pipe_b
        torch.cuda.empty_cache()
        profile_train_step(dev)
        return 0

    if args.train:
        training_phases()
        return 0
    if args.request_h:
        request_h(build_bundle(0, dev))
        return 0
    if args.request_j:
        request_j(build_bundle(0, dev))
        return 0
    if args.request_k:
        request_k(dev, probe=True)
        return 0
    if args.request_l:
        request_l(dev)
        return 0
    if args.request_d:
        bundle = build_bundle(0, dev)
        clip, temporal = build_slice_b_parts(10, dev)
        d_pipe = VideoPipeline(ModelBundle(bundle.guide, bundle.den, bundle.vae_enc, temporal,
                                           clip), d_config)
        for i in range(D_RUNS):
            t0 = time.perf_counter()
            _, latents, timer, _ = run_request_d(d_pipe, 8, D_STEPS, D_FRAMES, D_SIZE)
            log(f"request D, run {i + 1} of {D_RUNS}: {time.perf_counter() - t0:.3f} s | "
                f"{phase_text(timer)} | latents std {latents.std().item():.4f}")
        return 0
    if args.kernels:
        log((lib.with_suffix(".log")).read_text())
        phase_kernels(dev, tuple(args.kernels.split(",")))
        return 0

    # 3. kernels against plain versions
    record = phase_kernels(dev)

    # 3b. request K: the sampler on 4 ranks of the card, before the bundles
    # below take the card's memory; its one-rank reference and request L's
    # in one process, its ranks and request L1's in one spawn
    ref_k, ref_l, ranks_k, ranks_l1 = shared_processes(dev)
    launches_k = request_k(dev, ref=ref_k, ranks=ranks_k)

    # 3c. request L: the trainers on gloo ranks of the card, the graft entry
    launches_l = request_l(dev, ref=ref_l, l1=ranks_l1)

    # 4. request A at the headline geometry
    bundle, pipe, bundle_b, pipe_b = headline_pipes()
    reset_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    frames, latents, timer = run_request(pipe, make_inputs(0, T, H, W), STEPS)
    wall = time.perf_counter() - t0
    launches_a = read_counts("request A", at_768)
    same_launches("request A", launches_a)
    check_video(frames, latents, T, "request A")
    phases = phase_text(timer)
    log(f"request A: {T}x{H}x{W} {STEPS} steps in {wall:.3f} s | {phases} | peak "
        f"{max(timer.peaks.values()):.2f} GiB | launches {launches_a} | "
        f"latents std {latents.std().item():.4f} | frames mean {frames.mean():.2f}")

    # 5. request A again, warm, fewer steps
    t0 = time.perf_counter()
    frames_warm, lat_warm, timer = run_request(pipe, make_inputs(1, T, H, W), WARM_STEPS)
    wall = time.perf_counter() - t0
    check_video(frames_warm, lat_warm, T, "request A, warm")
    phases = phase_text(timer)
    log(f"request A, warm, {WARM_STEPS} steps: {wall:.3f} s | {phases}")

    # 5b. request A at 2 steps through the profile script's body, the profile
    # checked against the kernels' own counters
    profiled_request_a(pipe, kernels, at_768)

    # 6. request B: scene motion, CLIP tower, sampler, temporal decoder
    reset_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    frames, latents, timer, flow, tokens = run_request_b(pipe_b, 2, STEPS)
    wall = time.perf_counter() - t0
    launches_b = read_counts("request B", at_768)
    same_launches("request B", launches_b)
    check_video(frames, latents, T, "request B")
    check(flow.shape == (T, H // 8, W // 8, 2) and bool(torch.isfinite(flow).all())
          and bool(flow.any()), f"request B: flow {tuple(flow.shape)} finite and not all zero")
    check(tokens.shape == (1, 257, 768) and bool(np.isfinite(tokens).all()),
          f"request B: CLIP tokens {tokens.shape} finite")
    phases = phase_text(timer)
    log(f"request B: {T}x{H}x{W} {STEPS} steps, temporal decoder, in {wall:.3f} s | {phases} | "
        f"peak {max(timer.peaks.values()):.2f} GiB | launches {launches_b} | "
        f"flow abs max {flow.abs().max().item():.3f} | tokens std {tokens.std():.4f} | "
        f"latents std {latents.std().item():.4f} | frames mean {frames.mean():.2f}")
    del frames, latents, flow

    # 7. the stage-1 image request
    t0 = time.perf_counter()
    guide1, den1 = build_stage1_unets(20, dev)
    image_pipe = ImagePipeline(ModelBundle(guide1, den1, bundle.vae_enc, bundle.vae_dec), cfg)
    built = time.perf_counter() - t0
    rng = np.random.default_rng(3)
    pictures = [rng.integers(0, 256, (H, W, 3), dtype=np.uint8) for _ in range(5)]
    noise = rng.normal(0, 1, (1, H // 8, W // 8, 4)).astype(np.float32)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    image = image_pipe(*pictures, tokens, noise).cpu().numpy()
    wall = time.perf_counter() - t0
    # no motion modules at stage 1: K3 is not on this path
    launches_i = read_counts("image request", [k for k in at_768 if k is not ta.K3])
    same_launches("image request", launches_i)
    check(image.shape == (1, H, W, 3) and image.dtype == np.uint8, f"image {image.shape}")
    lat = image_pipe(*pictures, tokens, noise, num_inference_steps=2, decode=False)
    check(lat.shape == (1, H // 8, W // 8, 4) and bool(torch.isfinite(lat).all()),
          "image request: finite latents")
    log(f"image request: {H}x{W} {STEPS} steps in {wall:.3f} s (networks built in {built:.1f} s)"
        f" | launches {launches_i} | image mean {image.mean():.2f}")
    del image_pipe, guide1, den1

    # 8. interpolation: 4 frames become 7
    small = make_inputs(2, 4, 256, 256)
    small_cfg = PipelineConfig(width=256, height=256, num_inference_steps=1,
                               context=ContextConfig(frames=30, overlap=8))
    interp_cfg = PipelineConfig(width=256, height=256, num_inference_steps=1,
                                interpolation_factor=2,
                                context=ContextConfig(frames=30, overlap=8))
    frames = VideoPipeline(bundle, interp_cfg)(*small, to_host=True)
    check(frames.shape == (7, 256, 256, 3), f"interpolation: frames {frames.shape}")
    log(f"interpolation: 4 frames at 256x256, factor 2 -> {frames.shape[0]} frames")

    # 9. small request through the kernels and through the plain versions
    small_pipe = VideoPipeline(bundle, small_cfg)
    reset_counts()
    lat_k = small_pipe(*small, decode=False)
    decoded_k = [VideoPipeline(b, small_cfg)._decode(lat_k).float() for b in (bundle, bundle_b)]
    used = [k.name for k in kernels if k.launches > 0]
    with plain_kernels():
        before = {k.name: k.launches for k in kernels}
        lat_p = small_pipe(*small, decode=False)
        decoded_p = [VideoPipeline(b, small_cfg)._decode(lat_k).float()
                     for b in (bundle, bundle_b)]
        check(before == {k.name: k.launches for k in kernels},
              "the plain run launched a kernel")
    rel = rel_l2(lat_k, lat_p)
    rel_sd, rel_temporal = (rel_l2(a, b) for a, b in zip(decoded_k, decoded_p))
    log(f"check: 4x256x256, 1 step, kernels {used} vs plain versions: relative L2 of the "
        f"latents {rel:.3e}, of the same latents decoded by the SD decoder {rel_sd:.3e}, by "
        f"the temporal decoder {rel_temporal:.3e} (limits {SMALL_REL_L2} for the latents, "
        f"{SMALL_DECODED_REL_L2} for the decoded frames)")
    # 256^2: the VAE takes K9, not K4; a UNet batch of 8 frames stays under K13's 64
    small_kernels = [k.name for k in default_kernels if k not in (fa.K4, ta.K13)]
    check(rel < SMALL_REL_L2 and max(rel_sd, rel_temporal) < SMALL_DECODED_REL_L2
          and used == small_kernels,
          f"small request: rel {rel} {rel_sd} {rel_temporal}, kernels {used}")

    # 10. request C: long clips at 768^2 through the three bank tiers
    def tier_pipe(**change):
        return VideoPipeline(bundle, PipelineConfig(
            width=W, height=H, num_inference_steps=LONG_STEPS, guidance_scale=3.5,
            context=ContextConfig(frames=30, overlap=8), **change))

    def long_request(what, pipe, inputs, decode=True, expect=at_768):
        reset_counts()
        t0 = time.perf_counter()
        frames, latents, timer = run_request(pipe, inputs, LONG_STEPS, decode=decode)
        wall = time.perf_counter() - t0
        counts = read_counts(what, expect)
        n = inputs[2].shape[0]
        check_video(frames, latents, n, what)
        log(f"{what}: {n}x{H}x{W} {LONG_STEPS} steps in {wall:.3f} s | {phase_text(timer)} | "
            f"peak {max(timer.peaks.values()):.2f} GiB | launches {counts} | latents std "
            f"{latents.std().item():.4f}")
        return latents, counts

    from mikudance_tpu_torch.pipelines import video as video_mod

    clip48, clip40 = make_inputs(6, 48, H, W), make_inputs(7, 40, H, W)
    lat_step, launches_c = long_request(
        "request C, 48 frames, auto past 64 cached positions (3 windows, per-step banks)",
        tier_pipe(bank_mode="auto", cached_bank_positions=64), clip48)
    same_launches("request C, per-step", launches_c)
    q8_pipe = tier_pipe(bank_mode="cached_q8", cached_bank_positions=64,
                        max_denoise_frame_batch=32)
    lat_q8, launches_q8 = long_request("request C, 48 frames, cached_q8", q8_pipe, clip48)
    same_launches("request C, cached_q8", launches_q8)
    dequantize = video_mod.dequantize_banks
    video_mod.dequantize_banks = lambda qv, qs, dtype: dequantize(
        qv, {k: 2 * v for k, v in qs.items()}, dtype)
    try:  # the control: the int8 banks read back with scales off by 2x
        lat_ctl, _ = long_request("request C, control (q8 scales off by 2x)", q8_pipe, clip48,
                                  decode=False)
    finally:
        video_mod.dequantize_banks = dequantize
    lat_grouped, launches_grouped = long_request(
        "request C, 40 frames, max_denoise_frame_batch 32 (2 windows, cached-grouped)",
        tier_pipe(bank_mode="auto", cached_bank_positions=64, max_denoise_frame_batch=32), clip40)
    same_launches("request C, cached-grouped", launches_grouped)
    lat_step40, _ = long_request(
        "request C, 40 frames, per-step banks", tier_pipe(bank_mode="per_step",
                                                          cached_bank_positions=32), clip40,
        decode=False)
    rel_q8, rel_ctl = rel_l2(lat_q8, lat_step), rel_l2(lat_ctl, lat_step)
    rel_grouped = rel_l2(lat_grouped, lat_step40)
    log(f"request C, tiers against one another (relative L2 of the latents): cached_q8 vs "
        f"per-step {rel_q8:.3e} (limit {Q8_REL_L2}; control {rel_ctl:.3e}), cached-grouped vs "
        f"per-step {rel_grouped:.3e} (limit {SMALL_REL_L2})")
    check(rel_q8 < Q8_REL_L2 < rel_ctl, f"cached_q8 {rel_q8:.3e} and its control {rel_ctl:.3e} "
                                        f"on either side of {Q8_REL_L2}")
    check(rel_grouped < SMALL_REL_L2, f"cached-grouped vs per-step {rel_grouped:.3e}")
    del lat_step, lat_q8, lat_ctl, lat_grouped, lat_step40, clip48, clip40

    # 11. request D: the CLI's steps at 256^2, 40 frames, both windows in one batch
    d_pipe = VideoPipeline(bundle_b, d_config)
    reset_counts()
    t0 = time.perf_counter()
    frames, latents, timer, flow = run_request_d(d_pipe, 8, D_STEPS, D_FRAMES, D_SIZE)
    wall = time.perf_counter() - t0
    launches_d = read_counts("request D", [k for k in default_kernels if k is not fa.K4])
    same_launches("request D", launches_d)
    check(launches_d[fa.K4.name] == 0, f"request D launched K4: {launches_d}")
    check_video(frames, latents, D_FRAMES, "request D", D_SIZE, D_SIZE)
    check(bool(flow.any()) and bool(torch.isfinite(flow).all()), "request D: flow")
    log(f"request D: {D_FRAMES}x{D_SIZE}x{D_SIZE} {D_STEPS} steps, temporal decoder, in "
        f"{wall:.3f} s | {phase_text(timer)} | peak {max(timer.peaks.values()):.2f} GiB | "
        f"launches {launches_d} | latents std {latents.std().item():.4f} | frames mean "
        f"{frames.mean():.2f}")

    # 12. request E: warm request A inside the row-major configuration
    seen = {}
    stream = fa.flash_anchor_stream

    def spy(q, k, v, heads):  # one batch element of the first 9216-token call
        if not seen:
            seen["qk"] = (q[:1].clone(), k[:1].clone(), heads)
        return stream(q, k, v, heads)

    fa.flash_anchor_stream = spy
    grids = {lin.K7.name: [], cv.K8.name: []}  # output tiles of each GEMM-core launch
    for kern, tiles in ((lin.K7, gemm_tiles_k7), (cv.K8, gemm_tiles_k8)):
        kern.launch = launch_spy(kern.launch, tiles, grids[kern.name])
    try:
        with row_major():
            reset_counts()
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            frames, latents, timer = run_request(pipe, make_inputs(1, T, H, W), WARM_STEPS)
            wall = time.perf_counter() - t0
            on_e = [k for k in at_768 if k is not fa.K1] + list(row_major_only)
            launches_e = read_counts("request E", on_e, absent=(fa.K1, fa.K9, ta.K13))
            same_launches("request E", launches_e)
    finally:
        fa.flash_anchor_stream = stream
        del lin.K7.launch, cv.K8.launch
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    under_wave = {name: sum(t < sms for t in g) for name, g in grids.items()}
    log("request E: K7 / K8 launches whose grid is under one wave of tiles ("
        f"{sms} multiprocessors): " + ", ".join(
            f"{name} {under_wave[name]} of {len(g)} (fewest tiles {min(g)})"
            for name, g in grids.items()))
    check_video(frames, latents, T, "request E")
    excursion = fa.anchor_excursion(*seen.pop("qk"))
    rel_e = rel_l2(latents, lat_warm)
    rel_e_frames = rel_l2(torch.from_numpy(frames), torch.from_numpy(frames_warm))
    lat_ctl = row_major_without_bank(pipe, make_inputs(1, T, H, W), WARM_STEPS)
    rel_e_ctl = rel_l2(lat_ctl, lat_warm)
    log(f"request E (row-major): {T}x{H}x{W} {WARM_STEPS} steps in {wall:.3f} s | "
        f"{phase_text(timer)} | peak {max(timer.peaks.values()):.2f} GiB | launches "
        f"{launches_e} | against warm request A, relative L2: latents {rel_e:.3e} (limit "
        f"{E_REL_L2}; control without the bank K/V {rel_e_ctl:.3e}), decoded frames "
        f"{rel_e_frames:.3e} (limit {E_DECODED_REL_L2}) | largest |s - off| of one level-0 "
        f"self-attention call {excursion:.1f} log2 units (the clamp bites past "
        f"{fa.EXP_CLAMP:.0f})")
    check(rel_e < E_REL_L2 < rel_e_ctl, f"request E latents {rel_e:.3e} and the control "
                                        f"{rel_e_ctl:.3e} on either side of {E_REL_L2}")
    check(rel_e_frames < E_DECODED_REL_L2, f"request E decoded frames {rel_e_frames:.3e}")
    del frames, latents, lat_ctl, frames_warm

    # the small request of phase 9 once more, inside row_major()
    with row_major():
        reset_counts()
        lat_k = small_pipe(*small, decode=False)
        used = [k.name for k in kernels if k.launches > 0]
        with plain_kernels():
            before = {k.name: k.launches for k in kernels}
            lat_p = small_pipe(*small, decode=False)
            check(before == {k.name: k.launches for k in kernels},
                  "the plain row-major run launched a kernel")
    rel = rel_l2(lat_k, lat_p)
    log(f"check, row-major: 4x256x256, 1 step, kernels {used} vs plain versions: relative L2 "
        f"of the latents {rel:.3e} (limit {SMALL_REL_L2})")
    # 256^2: 1024 tokens at level 0 stay under the resident limit (K10, not K11)
    small_row_major = [k.name for k in kernels
                       if k not in (fa.K1, fa.K4, fa.K11, ta.K13) + off_the_sampler]
    check(rel < SMALL_REL_L2 and used == small_row_major,
          f"small row-major request: rel {rel}, kernels {used}")

    # 13. request H: 1024^2, heads of 160, both configurations
    del pipe, bundle_b, pipe_b, small_pipe, d_pipe, q8_pipe, lat_k, lat_p, lat_warm
    torch.cuda.empty_cache()
    launches_h, launches_h_rm = request_h(bundle)

    # 14b. request J: fp32 requests and the SD-width fidelity gate
    launches_j3 = request_j(bundle)
    del bundle
    torch.cuda.empty_cache()

    # 14. request I: the toolbox's networks
    run_request_i()

    # 15-16. requests F and G
    launches_f, launches_f_default, launches_s1, launches_g = training_phases()

    for rec in record.values():
        # launches: from the main path that runs the kernel, request B at
        # 768^2, request D for the two kernels of smaller maps, request E for
        # the row-major configuration's
        on_d = rec["name"] in (fa.K9.name, ta.K13.name)
        rec["launches_request_e"] = launches_e[rec["name"]]
        rec["launches_request_b"] = launches_b[rec["name"]]
        rec["launches_request_c_per_step"] = launches_c[rec["name"]]
        rec["launches_request_c_q8"] = launches_q8[rec["name"]]
        rec["launches_request_c_grouped"] = launches_grouped[rec["name"]]
        rec["launches_request_d"] = launches_d[rec["name"]]
        rec["launches"] = (launches_d if on_d else launches_b)[rec["name"]]
        if rec["name"] in [k.name for k in row_major_only]:
            rec["launches"] = launches_e[rec["name"]]
        rec["launches_request_f"] = launches_f[rec["name"]]
        rec["launches_request_f_default"] = launches_f_default[rec["name"]]
        rec["launches_stage1_steps"] = launches_s1[rec["name"]]
        rec["launches_request_g"] = launches_g[rec["name"]]
        if rec["name"] == fa.K12.name:
            rec["launches"] = launches_f[rec["name"]]
        if rec["name"] == mb.K14.name:
            rec["launches"] = launches_g[rec["name"]]
        rec["launches_request_a"] = launches_a[rec["name"]]
        rec["launches_request_h"] = launches_h[rec["name"]]
        rec["launches_request_h_row_major"] = launches_h_rm[rec["name"]]
        rec["launches_image_request"] = launches_i[rec["name"]]
        rec["launches_request_j3_fp32"] = launches_j3[rec["name"]]
        rec["launches_request_k1_rank0"] = launches_k[rec["name"]]
        for run, key in (("L1 default", "l1"), ("L1 transposed", "l1_transposed"),
                         ("L2 default", "l2"), ("L3 zero", "l3_zero"), ("L4 entry", "l4_entry")):
            rec[f"launches_request_{key}" + ("" if key == "l4_entry" else "_rank0")] = \
                launches_l[run][rec["name"]]
    kern_line = {"kernels": list(record.values())}
    print(json.dumps(kern_line))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
