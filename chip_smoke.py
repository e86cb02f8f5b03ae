#!/usr/bin/env python3
"""Smoke check of the PyTorch/CUDA port (ccdm_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each announced on a flushed line before it starts:
  1. device: the card's name and power limit (nvidia-smi), torch and CUDA;
  2. build: the five kernel libraries, one nvcc each, in parallel
     (seconds, ptxas report);
  3. kernel #1 (the single-pass attention block) against its plain PyTorch
     version at every shape of the attention blocks of the RC-49 64x64, the
     128x128 and the 192x192 UNet (N 9 to 36864, C 64 to 512) and of the
     Cell-200 teacher (64x64, dim 32, mults 1_2_2_4: C 32 to 128), B 64:
     bf16 against the plain version in f32 on the same bf16-rounded inputs
     (rtol = atol = 3e-2, rtol relative to max(|y|, |y - x|), x ~ N(0, 1);
     at C <= 256 and at the 64x64 UNet's shapes) and against the plain
     version at the kernel's bf16 rounding points (same bound, every
     shape), and f32 with TF32 off (rtol 2e-3, atol 2e-4, x ~ N(0, 2)), the
     bounds and inputs of the JAX kernel's tests; each shape timed in bf16
     with CUDA events, with the route the plan took (asserted: fused at
     N <= 128, else split with its splits), the wrapper's host time,
     TFLOP/s and the share of the bound; then the same per attention level
     of one B-64 forward of the 64x64 UNet; then bf16 at every shape again
     at the other batches the main paths give #1 (128, 72, 8, 1, 4), the
     same checks (the f32 one at C <= 256) and route assertion, untimed;
     then f32 at B 128 at the 64x64 UNet's levels (phase 21's f32 UNets),
     and at B 80 and B 40 at the Cell-200 teacher's (phase 23's CFG rows
     and guided batch), the f32 bounds above;
  4. the full-width UNet in f32 (TF32 off) with the kernel and with the
     plain attention: one forward (max abs diff <= 1e-3) and a 5-step CFG
     DDIM run from the same noise ([0,1] images, max abs diff <= 1e-3);
  5. the serving main path: the port's SamplerService at full width in bf16
     (batch 32, 250 DDIM steps, cond_scale 1.5) behind its own HTTP server on
     127.0.0.1 in a daemon thread, GET /healthz and two POST /generate
     (uint8 [n, 64, 64, 3], not constant; the service refuses a sample that
     is not finite before quantising it); kernel #1's launch count over
     this phase must be 10 x 250 x batches; then one CFG forward of the
     service's model (B 64) timed with CUDA events;
  6. kernels #2-#5 (two-pass forward, fused backward) against their plain
     versions at every two-pass shape of the three UNets and the Cell-200
     teacher's top level, B 128: (N, C) (4096, 64), (2048, 64), (16384, 64),
     (4096, 128), (36864, 64) at B 32, and (4096, 32), in bf16 and in f32,
     and (4096, 32) in f32 at B 64 (phase 23's class UNet training):
     forward bounds as phase 3 (a and s relative
     to their largest value), kmax within 1e-5 of its largest value (in
     bf16 against the plain version at the tensor route's rounding points,
     ctx_large_tensor_reference, and against ctx_large_reference by
     kmax_check, at every shape), backward bounds of
     tests/test_attn_block.py:301-308 (f32 rtol = atol = 2e-3; bf16 rtol
     1e-1, atol 0.02 max(|g|, 1)); in f32 also #4 + #5 through the autograd
     Function against autograd through the plain block; in bf16 #5 nearer
     its plain version than one with d_a rounded to bf16 (check_rounding),
     and #2-#5 on their tensor-core route (asserted, with tile and
     splits); each timed in bf16 (event and host time, TFLOP/s, share of
     the bound); then #2 + #3 against #1 at sampling time (B 64, bf16, N
     4096 and 16384); then the block at dim_head 64 (2 heads; B 8, N 4096,
     C 64; bf16 and f32) through its kernels' CUDA-core routes (asserted,
     one launch each of #1-#5 counted) against the plain block and autograd
     through it (dim_head_vs_plain);
  7. one loss + backward of the full-width f32 UNet (TF32 off) with the
     kernels and with plain attention on the same batch and draws: every
     gradient leaf within 1e-3 of its largest |g| (the two biases feeding a
     train-mode BatchNorm, whose exact gradient is zero, within 1e-3 of the
     model's largest |g|), the loss to 1e-5; then the same with use_Hy,
     H(y) from a ModelY2Cov of random weights (12288 outputs, f32);
  8. the training main path: `python -m ccdm_tpu_torch.main` at full width,
     batch 128, bf16, 30 steps, a milestone at the end (run folder
     build/smoke_run, deleted after), then 2 eval labels x 4 images, 10
     DDIM steps, as main.py samples after training: losses finite,
     parameters moved, ema_step 30, launches exactly 8 of #1 and 2 each of
     #2-#5 per step, 10 of #1 per sampling forward and none of #10 and
     #11; warm train images/s; then SamplerService --serve_milestone serves
     4 labels x 25 DDIM steps from that milestone (uint8, not constant);
  9. kernels #10 and #11 (the fused resnet block's halves) against their
     plain versions at the 11 shapes of the UNet's 23 resnet blocks, at
     every batch the main paths give them (64 served, 128 trained, 72 for
     the EMA grid, 8 for the eval sampling and the ddpm request): f32 with
     TF32 off (rtol 2e-3, atol 2e-4) and bf16 (rtol = atol = 4e-2), the
     bounds of tests/test_resnet_block.py; at B 64 (and B 128 at 64x64)
     each shape timed in bf16 beside its plain versions, each half's
     composition in resnet_block_reference (library_ms), its bare cuDNN
     convs (cudnn_conv_ms) and the cuDNN composition of the whole block (the
     route of the switch off), with the route the kernels took (fused or
     split, tile, K splits), the wrappers' host time, TFLOP/s and the share
     of the bound; then the same per level (H = W) over one B-64 forward;
  10. the full-width f32 UNet (TF32 off) with CCDM_TPU_FUSED_RESBLOCK on
     against off: one forward and a 5-step CFG DDIM run from the same noise,
     each within 1e-3 (phase 4's check); 23 launches of each kernel per
     switch-on forward;
  11. serving with the switch on: SamplerService at full width in bf16,
     batch 32, 25 DDIM steps, over HTTP; launches exactly 23 x 25 x batches
     of #10 and #11 (and 10 x 25 x batches of #1); phase 5's CFG forward
     timed with the switch on, then with the switch off and on in turns
     (event and host time); then one request to a --sampler ddpm service
     with 10 ancestral steps (uint8, not constant);
  12. training with the switch on: `python -m ccdm_tpu_torch.main` at full
     width, batch 128, bf16, 5 steps, --sample_every 5 (one EMA grid of 36
     images, 10 DDIM steps), a milestone, then 2 eval labels x 4 images,
     10 DDIM steps: losses finite, the PNG grids decode to images that are
     not constant, launches exactly 23 of #10 and #11 per UNet forward
     (and #1-#5 as in phase 8, plus 10 of #1 per EMA-grid forward);
  13. kernels #6 and #9 (standalone linear attention) against their plain
     versions at the UNet's attention levels (N 4096 to 16, H 4, D 32) at
     B 64 and B 128, and at (H, D) (2, 64), (8, 16), (1, 128), N 1024: f32
     with TF32 off (rtol 2e-3, atol 1e-4) and bf16 (rtol 3e-2, atol 3e-2 of
     the largest |y|), the bounds of tests/test_linear_attention.py; in
     bf16 each kernel's mean distance to its plain version at most a quarter
     of that to the other's, which rounds at other points; #6's route
     (la_plan: tensor cores in bf16, CUDA cores in f32; asserted) and #9's
     (per_head_plan: whole rows in f32 in bf16, CUDA cores in f32;
     asserted) with their splits, and #6 timed in bf16 at every shape (#9
     at B 64), with the wrapper's host time, TFLOP/s and the share of the
     bound (#9's products at the f32 rate); each the same bits on two
     calls at B 64, N 4096;
  14. kernels #7 + #8 (its two-pass form) against their plain versions at
     (B 64, N 16384), (B 128, N 4096), (B 16, N 36864), (B 16, N 6144) and
     (B 16, N 4096, chunks of 1024), same bounds (a and s relative to their
     largest value) and the same test of rounding points (a from the
     unrounded exp(k - m), s from the rounded one, q' of #8 in f32); #7's
     route (twopass_plan: tensor cores in bf16) and #8's asserted, each
     timed at every shape (TFLOP/s, share of the bound) and the same bits
     on two calls at B 64, N 16384, where the dispatcher's two-pass route,
     the plain reference and #9 are timed on the same q, k, v;
  15. kernel #12 (bias_act) against its plain version: all 9 activations,
     bias or not, clamp none or 1.5, default gain or 0.5, f32 (rtol 1e-5,
     atol 1e-6) and bf16 (8e-3, one unit), at GAN feature maps of batch 64
     and 1003 rows; lrelu timed per shape, and beside F.leaky_relu where
     the case is that one call, each by events, host time and the card's
     own time (kernel durations from torch.profiler);
  16. this slice's path (module docstring of la_main_path): the
     PreNormResidual(LinearAttention) module at the UNet's ten attention
     levels (#6: its bf16 calls on the tensor route, its f32 calls on the
     CUDA cores, asserted), the module on the two-pass route (#7 + #8),
     linear_attention_per_head (#9), bias_act(impl="auto") (#12); exact
     launch counts; in f32 the module within 1e-4 of kernel #1's
     FusedLinearAttentionBlock on the same weights;
  17. one f32 loss + backward through the module at B 128, N 4096 (#6
     forward, plain backward) against the all-plain route: every gradient
     within 1e-3 of its largest |g|;
  18. the CCDM recipe (the launch scripts' --use_Hy --y2h_embed_type
     resnet --y2cov_embed_type resnet; recipe_main_path): `python -m
     ccdm_tpu_torch.main` at phase 8's width, batch and data with
     --hy_max_log 4.0 and the ILI epochs cut to 2 CNN and 20 MLP epochs
     for y2h and 1 and 20 for y2cov (the ILI nets train on the card in
     f32), 20 steps, then the sampling after training: losses finite, the
     four cache entries written, launches exactly 8 of #1 and 2 each of
     #2-#5 per step and 10 of #1 per sampling forward, none of the rest;
     seconds per epoch of each ILI stage, fn_y2cov's time for a micro-batch
     of 128, warm train images/s beside phase 8's; then SamplerService
     --serve_milestone 20 with the embeddings loaded from the cache only
     (its fn_y2cov equal to the trainer's) answers one HTTP request of 32
     labels at 25 DDIM steps (10 launches of #1 per forward; served
     images/s), and a service pointed at a setting folder without
     embed_models/ raises FileNotFoundError;
  19. the rest of main.py's training entry (multidim_checks, aux_checks):
     (a) `python -m ccdm_tpu_torch.main --data_name synthetic_power
     --label_dim 8 --synthetic_n 64` (64x64, 1 channel) at phase 8's width,
     batch and dtype with --vicinity_type shv (3 projections, auto-set),
     the resnet ILI y2h at phase 18's cut epochs over 8 dims combined by
     --dim_combination cross_attention, 20 steps, then all 64 label rows x
     2 images, 10 DDIM steps: losses finite, labels of width 8 at the
     sliced vicinal weights every step, launches exactly 8 of #1 and 2 each
     of #2-#5 per step and 10 of #1 per sampling forward, none of the rest,
     64 index-keyed grids sample_000xx.png that decode (grayscale) to
     images that are not constant, the combiner's weights written under
     embed_models/, fn_y2h loaded on the card equal to the CPU's on the 64
     rows (rtol = atol = 1e-4); warm train images/s beside phase 8's; (a')
     the same with the sinusoidal y2h (it depends on y untrained, where (a)'s
     cut ILI MLP is constant in y) on 8 rows, 5 steps: exact launches, the
     combiner's file, fn_y2h on the card equal to the CPU's and different
     for every two rows, and the 8 grids, sampled from the same seeded
     noise, different for every two rows, so the labels reach the UNet's
     conditioning; (b) phase 8's run
     with --pred_objective pred_noise --lambda_aux 0.1 --net_aux ResNet18
     --epoch_aux 1 --gif_trajectory --interpolation, 10 steps: the aux
     cache written, the aux term in the train log finite and not zero on
     some step, the GIF a GIF89a of 10 frames (100 ms, looping), the
     interpolation PNG 8 panels that are not constant, exactly 10 launches
     of #1 per forward of the GIF pass (10 forwards) and of the
     interpolation pass (8 x 250 unguided forwards of B 1), and the whole run's
     counts as phase 8's plus those; seconds per aux epoch, seconds of
     each pass; every (B, N, C) at which #1 launched in (a), (a') and (b)
     among those phase 3 checked;
  20. the eval protocol (eval_checks): `python -m ccdm_tpu_torch.main
     --data_name SteeringAngle` on a 64x64 bundle built in memory (only
     the h5 read is replaced: examples/make_fixture_sa64.py's road
     renderer, 40 images for each of 100 signed angles in (-80, 80); the
     port's steeringangle_from_arrays shifts the labels) at phase 8's
     width, batch and dtype, 20 steps, then every raw label x 4 images at
     10 DDIM steps (CFG forwards of B 8), then --comp_FID --FID_radius 2
     with PRDC, NIQE, intra-class FID and the kNN, FFT and t-SNE analyses,
     the eval backbones trained 1 epoch each on the card: launches exactly
     8 of #1 and 2 each of #2-#5 per step and 10 of #1 per sampling
     forward, none of the rest; every metric finite; seconds per epoch of
     the AE, the classifier and the regressor, images/s of feature
     extraction through the AE encoder and ResNet34, the NIQE fit's and
     the protocol's seconds; the AE features of 64 real images on the
     card within 1e-4 of the CPU's; a second run_ccgm_eval on the same
     fakes loads the pinned checkpoint and gives the same fingerprint,
     SFID, FID and LS bit for bit; every (B, N, C) of #1 among phase 3's;
  21. DMD2-M one-step distillation (dmd_main_path): `python -m
     ccdm_tpu_torch.dmd_main` on phase 20's run folder (kept for it, then
     deleted): its milestone the teacher, an f32 Unet as JAX's dmd_main
     builds it, and a deep copy the fake UNet; SNGAN at JAX's default widths
     (gene_ch = disc_ch = 64, dim_z 256), batch 128, 2 D steps, hinge,
     DiffAugment, 12 iterations with a grid and a milestone at 6 and 12,
     then every raw label x 4 one-step images (the h5 write recorded: the
     card's machine has no h5py), --comp_FID against phase 20's pinned
     backbones with the windows cut from 157 to 10, --interpolation and
     --sefa; then SAGAN, 2 iterations: launches exactly 36 of #1 and 4
     each of #2-#5 per iteration (20 f32 forwards of the G step without a
     gradient, 2 x 8 in the D steps), none of the rest; every (B, N, C,
     dtype) of #1 among phase 3's, all f32; losses finite, netG moved,
     the one-step images uint8 and not constant, the grids and analysis
     PNGs decode, every metric finite under phase 20's fingerprint; SNGAN's
     D on the card (full f32) within 1e-5 of the CPU's, G within 5e-5 (the
     CPU's own f32 G is ~1.2e-5 from its f64 one, printed beside); the G and D
     steps and the one-step generator at batch 200 timed with CUDA events;
     serve_dmd's GeneratorService over HTTP (5 and 40 labels, batch 32,
     host clock; no kernel launched) and a request with cond_scale
     answered 400;
  22. the ADM and ViT denoisers (denoisers_main_path, arch_checks):
     `python -m ccdm_tpu_torch.main --architecture adm` at JAX's default
     widths (model_channels 64, channel_mult 1_2_4_8, 2 resnet blocks a
     level, 8 groups, 4 heads; 67.1 M parameters at 4_8) with
     --attention_resolutions 4_8 (attention at 16x16 and 8x8, down, mid and
     up) on phase 8's data, --train_amp, batch 128, 20 steps, then 2 labels
     x 4 images at 10 DDIM steps, then SamplerService over HTTP on the
     milestone, one request of 4 labels at 25 steps without and one with
     --samp_precast_bf16; then `--architecture vit` at the flagship's
     widths (64 x 8 = 512 wide, 8 blocks, 4096 tokens, 4 heads of 128; its
     token attention through SDPA pinned to the memory-efficient backend),
     batch 32, 5 steps, 2 labels x 4 images at 5 DDIM steps and one served
     request at 5 steps: no kernel of #1-#12 launched, counted from 0 and
     read apart for each architecture's training and sampling and for its
     serving and card forwards; losses
     finite, the weights moved (ADM's frozen null embedding did not), the
     grids decode to images that are not constant, the milestone reloads
     and serves uint8 images that are not constant; the milestone's EMA
     weights in an f32 model on the card against the CPU within 1e-4 (ADM
     at B 2 at full width, the ViT cut to 2 blocks at B 1); warm train
     images/s, ms per sampling step, served images/s, each train step's
     torch.cuda.max_memory_allocated, and the ViT's attention kernels by
     torch.profiler (the SDPA backend that ran);
  23. the baselines (baselines_main_path): (a) `python -m
     ccdm_tpu_torch.ccgan_main` on phase 8's data at JAX's default SNGAN
     widths (64/64/256), batch 64, 2 D steps, hinge, the hard vicinity,
     DiffAugment, Dual-NDA a 0.8, b 0.1, c 0.1 from iteration 10, the resnet
     ILI y2h at phase 18's cut epochs, 10 iterations, then 10 more from its
     milestone (--resume_niter 10), grids and milestones at 10 and 20, each
     call sampling 2 eval labels x 4 images (the h5 writes recorded: the
     card's machine has no h5py); (a') SAGAN, the soft vicinity, the
     vanilla loss, 2 iterations; (b) `classgan_main --method studiogan`
     (64/64, dim_z 128, batch 64) with the D2D-CE head, 20 iterations, and
     the ADC head, 2; (c) `--method cfg` and (d) `--method admg`: the class
     UNet at classgan_main's widths (32, 1_2_2_4; f32, as JAX builds it),
     batch 64, 20 steps, then 10 classes x 4 fakes at 250 steps (CFG DDIM
     at 1.5 on 80 rows; ADM-G's noisy classifier trained 1 epoch, then
     classifier-guided ancestral steps on 40): launches, counted from 0 for
     each run, exactly none of #1-#12 in (a), (a') and (b), and in (c) and
     (d) 6 of #1 and 2 each of #2-#5 per step plus 8 of #1 per sampling
     forward, each (B, N, C, dtype) of #1 among phase 3's and of #2-#5
     among phase 6's; losses finite, the nets moved, the fakes uint8 and not
     constant, the grids decode; SNGAN's D (a) on the card within 1e-5 of
     the CPU's, the class UNet's EMA forward (c) within 1e-4, the guided
     sampler's classifier gradient (d) within 1e-4 of its largest |g| in
     f64 copies with the CPU's timestep embedding on both sides, in f32 each
     with its own within 5e-2 (L2; the ReLU net's input gradient jumps where
     rounding moves a unit across 0: classifier_grad_card_vs_cpu); ms a
     GAN iteration (events), warm train images/s, ms a CFG and a guided
     step, the noisy classifier's seconds an epoch;
  24. the share of the timed CFG forwards that the 23 blocks take (the
     cuDNN composition with the switch off, #10 + #11 with it on, each
     timed alone in phase 9), #10 + #11 against that composition and per
     level, then one JSON line {"kernels": [...]} with errors, times and
     bounds of all 12 kernels (#1 with its route per shape, #12 with the
     card's own time beside F.leaky_relu's);
  25. the card's name and power limit;
  26. data parallelism (data_parallel_path, build/smoke_dp, deleted
     after): (a) `python -m ccdm_tpu_torch.main` at phase 8's width, batch
     and dtype (the Gaussian-Fourier label embedding), 5 steps, in its own
     process three times: twice without and once under the env triplet
     (CCDM_COORD_ADDR, CCDM_NUM_PROCS 1, CCDM_PROC_ID 0), the first two at
     once: the backend NCCL, and the milestone's parameters and BatchNorm
     statistics within twice the spread of the two runs without it; (b) two
     ranks on cuda:0 joined over gloo (NCCL refuses two ranks on one card)
     pass their mesh to main.py's Trainer (build_trainer): 3 steps at 64
     rows a rank against one process on the same 128 rows: the first loss
     within 2^-7 relative and the later ones within 1e-2, the first step's
     gradients summed over the ranks (before the clip and Adam) within
     DP_GRAD_RTOL of each leaf's scale, the parameters by the CPU tests'
     Adam rule (_adam_rule), losses, gradients, parameters and statistics
     bit for bit across the ranks, launches exactly 8 of #1 and 2 each of
     #2-#5 a step on each rank, every (B, N, C, dtype) among phase 3's (#1)
     and phase 6's (#2-#5); (c) one CcGAN iteration (SNGAN 64/64/256,
     batch 64, 2 D steps, the global ConditionalBatchNorm) on the same two
     ranks against one process: the first loss within 1e-5 and the later
     ones within 1e-3, each step's summed gradients within DP_GRAD_RTOL of
     each leaf's scale, statistics within 1e-4, parameters by the Adam rule; (d) the
     synthetic bundle written to a native cache (data/native_loader.py),
     a batch of 128 gathered into pinned memory and copied to the card,
     equal to the bank there (and, flipped, the bank's or its mirror), the
     gather and the copy timed; (e) the flagship's Upsample levels of
     source 32^2 and up, each fold variant against the reference route (f32
     within 2e-5 and bf16 within 5e-2 of max(1, |y|)), both timed in bf16
     (the UNet keeps the reference: the fold loses on the card); then one
     JSON line {"data_parallel": ...}, the card's line
     again and the last line {"ok": true, "device": {...}}.
The five kernel libraries build in parallel, one nvcc each (phase 2). Each
main path (phases 5, 8, 11, 12, 16, 18, 19, 20, 21, 22, 23, 26) starts from
launch counts set to 0 and reads them just after; the paths of phases 5,
8, 11, 12, 18, 19, 20, 21 and 23 launch none of #6-#9 and #12, phase 22's
and phase 23's GANs none of #1-#12. TF32 is off for the
whole run (it only touches the f32 checks and the f32 convolutions). Any failed phase raises and the script
exits non-zero; a hang becomes a stack dump and a non-zero exit after
1100 s. It writes nothing outside build/.
"""

from __future__ import annotations

import base64
import contextlib
import copy
import faulthandler
import io
import json
import math
import os
import shutil
import socket
import struct
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from ccdm_tpu_torch.diffusion.gaussian import DiffusionConfig, GaussianDiffusion
from ccdm_tpu_torch.embedding import ili
from ccdm_tpu_torch.embedding.analytic import COMBINER_SEED_OFFSET, Y2H_SEED, make_fn_y2h
from ccdm_tpu_torch.models.layers import FusedLinearAttentionBlock, LinearAttention, PreNormResidual
from ccdm_tpu_torch.models.resnet_embed import ModelY2Cov
from ccdm_tpu_torch.models.unet import Unet
from ccdm_tpu_torch.ops import _build, attn_block, resnet_block
from ccdm_tpu_torch.ops import linear_attention as la
from ccdm_tpu_torch.ops import style_ops as so
from ccdm_tpu_torch.opts import parse_opts
from ccdm_tpu_torch.serve import SamplerService, serve
from ccdm_tpu_torch.utils.convert import prenorm_linear_attention_from_fused

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
BF16_FLOPS = 989e12        # dense bf16 tensor-core peak, same source
HEADS, DIM_HEAD = 4, 32
F = HEADS * DIM_HEAD
SERVE_BATCH = 32
BATCH = 2 * SERVE_BATCH    # the cond and null rows of one CFG forward
STEPS = 250
# (N, C) of the ten attention blocks of one RC-49 64x64 UNet forward
# (dim 64, mults 1_2_2_4_8): down levels 0-4, then up levels 0-4
FORWARD_SHAPES = [(4096, 64), (1024, 64), (256, 128), (64, 128), (16, 256),
                  (16, 512), (64, 256), (256, 128), (1024, 128), (4096, 64)]
UNET = dict(dim=64, dim_mults=(1, 2, 2, 4, 8), in_channels=3)


def unet_attn_shapes(size: int, mults: tuple, dim: int = 64) -> list:
    """(N, C) of a UNet's attention blocks (models/unet.py): each down level
    at its input width, then each up level at its output width."""
    dims = [dim] + [dim * m for m in mults]
    pairs = list(zip(dims[:-1], dims[1:]))
    down = [((size >> i) ** 2, c_in) for i, (c_in, _) in enumerate(pairs)]
    up = [((size >> (len(pairs) - 1 - i)) ** 2, c_out)
          for i, (_, c_out) in enumerate(reversed(pairs))]
    return down + up


assert unet_attn_shapes(64, UNET["dim_mults"]) == FORWARD_SHAPES
# the 64x64 UNet's shapes and the top levels of the 128x128 (uk128, mults
# 1_2_4_4_8_8) and 192x192 (uk192, mults 1_2_2_4_4_8_8) UNets, then the other
# shapes of those two: every shape #1 meets on the three models. A shape's
# index seeds its inputs.
CHECK_SHAPES = sorted(set(FORWARD_SHAPES), reverse=True) + [(16384, 64), (36864, 64)]
CHECK_SHAPES += sorted(set(unet_attn_shapes(128, (1, 2, 4, 4, 8, 8)) +
                           unet_attn_shapes(192, (1, 2, 2, 4, 4, 8, 8))) - set(CHECK_SHAPES),
                       reverse=True)
# then those of the Cell-200 teacher (64x64, dim 32, mults 1_2_2_4; C 32 to
# 128) that the three UNets lack
CELL200_SHAPES = unet_attn_shapes(64, (1, 2, 2, 4), dim=32)
CHECK_SHAPES += sorted(set(CELL200_SHAPES) - set(CHECK_SHAPES), reverse=True)
# blocks of the split route's passes: two an SM on the H100's 132 SMs
ATTN_SPLIT_BLOCKS = 2 * 132
SERVE_ARGV = ["--image_size", "64", "--model_channels", "64",
              "--channel_mult", "1_2_2_4_8", "--train_amp", "--pred_objective", "pred_x0",
              "--sample_timesteps", str(STEPS), "--sample_cond_scale", "1.5",
              "--seed", "0"]


def phase(text: str) -> None:
    print(f"== {text}", flush=True)


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """The host's time per call (Python, checks, allocation, the launch),
    with no synchronisation inside the loop: where time_ms is no larger,
    the card waited on the host between back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(reps):
        fn()
    elapsed = time.perf_counter() - start
    torch.cuda.synchronize()
    return elapsed / reps * 1e3


def device_ms(fn, reps: int = 20, warmup: int = 3) -> dict:
    """The card's own time per call, by kernel name: the durations that
    torch.profiler's trace gives the kernels (and copies) that `reps`
    calls launched, summed per name and divided by reps (ms). Unlike
    time_ms, the gaps in which the card waited on the host do not count."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / reps / 1e3 for e in prof.key_averages()
            if e.self_device_time_total > 0}


def bound_parts(n: int, c: int, batch: int = BATCH, itemsize: int = 2) -> tuple[float, float]:
    """Least times (ms) of one call: the bytes it must move (x read, y
    written, the weights read once) over HBM bandwidth, and its operations
    over the bf16 peak. The bound is the larger."""
    nbytes = (2 * batch * n * c + c * 3 * F + F * c + 3 * c) * itemsize
    flops = 2 * batch * n * (3 * c * F + 2 * F * DIM_HEAD + F * c)
    return nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS * 1e3


def block_inputs(n: int, c: int, batch: int, device, seed: int, x_std: float):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(batch, n, c, generator=g) * x_std
    weights = (1 + 0.5 * torch.randn(c, generator=g), 0.1 * torch.randn(c, 3 * F, generator=g),
               0.1 * torch.randn(F, c, generator=g), 0.1 * torch.randn(c, generator=g),
               1 + 0.5 * torch.randn(c, generator=g))
    return x.to(device), [w.to(device) for w in weights]


def check_close(got: torch.Tensor, want: torch.Tensor, rtol: float, atol: float,
                what: str, scale: torch.Tensor | None = None) -> float:
    """|got - want| <= atol + rtol * scale elementwise (scale |want| by
    default); returns the max abs error."""
    diff = (got.float() - want.float()).abs()
    if not bool(torch.isfinite(got.float()).all()):
        raise AssertionError(f"{what}: non-finite output")
    bad = diff > atol + rtol * (want.float().abs() if scale is None else scale)
    if bool(bad.any()):
        raise AssertionError(f"{what}: {int(bad.sum())} elements beyond rtol {rtol}, "
                             f"atol {atol}; max abs err {diff.max().item():.3e}")
    return diff.max().item()


def attn_route_of(batch: int, n: int, c: int) -> tuple[str, int]:
    """The route and splits that #1's plan must give a UNet shape in bf16:
    fused where a block holds the row (N <= 128), else split, with as many
    blocks a row as fill ATTN_SPLIT_BLOCKS in one wave, at most one a tile
    of 64 tokens."""
    pl = attn_block.plan(batch, n, c, HEADS, torch.bfloat16)
    want = ("fused", 1) if n <= 128 else \
        ("split", min(-(-n // 64), max(1, ATTN_SPLIT_BLOCKS // batch)))
    if (pl.route, pl.splits) != want:
        raise AssertionError(f"#1's plan at B {batch}, N {n}, C {c}: {pl.route} x{pl.splits}, "
                             f"expected {want[0]} x{want[1]}")
    return want


def attn_rounded_reference(x, g_pre, wqkv, wout, bout, g_out):
    """The plain version of #1 in bf16 at its rounding points, the rest in
    f32: the plain #2 (xn, exp(k - m) and v as bf16 operands, s unrounded)
    and the plain #3 (q' and the attention output as bf16 operands) with
    ctx = a / s rounded to bf16 between them, as csrc/attn_block.cu does."""
    a, s, _ = attn_block.ctx_large_reference(x, g_pre, wqkv, HEADS)
    ctx = (a / s.clamp_min(1e-30).view(*a.shape[:3], 1)).to(x.dtype)
    return attn_block.out_large_reference(x, g_pre, wqkv, ctx, wout, bout, g_out, HEADS)


def holds_f32_plain(n: int, c: int, batch: int) -> bool:
    """Whether phase 3 holds #1 in bf16 to its plain version in f32 at this
    shape: at C <= 256, and at the 64x64 UNet's shapes at B 64, as before.
    At C 512 the bf16 rounding points themselves, the TPU kernel's
    included, reach that bound (scripts/attn_bf16_margin.py, PERF.md):
    there the kernel is held to its plain version at those points only."""
    return c <= 256 or (batch == BATCH and (n, c) in FORWARD_SHAPES)


def attn_bf16_check(n: int, c: int, batch: int, device, seed: int) -> tuple:
    """#1 in bf16 (x ~ N(0, 1), the JAX kernel's tests) against its plain
    version at its rounding points (attn_rounded_reference) and, where
    holds_f32_plain, against its plain version in f32 on the same
    bf16-rounded inputs; each at rtol = atol = 3e-2, rtol relative to the
    larger of |y| and the block's own term |y - x| (where x cancels that
    term, the bf16 operand roundings, about 1% of it at C 512, stand beside
    a small |y|). Returns the two max abs errors (the second None where not
    held) and the bf16 inputs."""
    x, w = block_inputs(n, c, batch, device, seed=seed, x_std=1.0)
    xb, wb = x.bfloat16(), [t.bfloat16() for t in w]
    del x, w
    got, xf = attn_block.fused_attn_block(xb, *wb, HEADS, DIM_HEAD), xb.float()

    def err(want, what: str) -> float:
        return check_close(got, want, 3e-2, 3e-2, f"bf16 B={batch} N={n} C={c} ({what})",
                           scale=torch.maximum(want.abs(), (want - xf).abs()))

    rounded = err(attn_rounded_reference(xb, *wb).float(), "plain at its rounding points")
    plain = err(attn_block.attn_block_reference(xf, *(t.float() for t in wb), HEADS, DIM_HEAD),
                "plain in f32") if holds_f32_plain(n, c, batch) else None
    return rounded, plain, xb, wb


@torch.no_grad()
def kernel_vs_plain(device) -> tuple[dict, dict]:
    """Phase 3: per shape, errors in bf16 and f32 and times in bf16 at B 64;
    then bf16 errors at the other batches the main paths give #1. Returns
    the rows by shape and the errors by batch."""
    rows = {}
    for i, (n, c) in enumerate(CHECK_SHAPES):
        # x ~ N(0, 1) in bf16 and N(0, 2) in f32, the inputs of the JAX
        # kernel's own tests (tests/test_attn_block.py:61-101)
        route, splits = attn_route_of(BATCH, n, c)
        err_r, err_b, xb, wb = attn_bf16_check(n, c, BATCH, device, seed=i)
        kernel_b = lambda: attn_block.fused_attn_block(xb, *wb, HEADS, DIM_HEAD)
        plain_b = lambda: attn_block.attn_block_reference(xb, *wb, HEADS, DIM_HEAD)
        x, w = block_inputs(n, c, BATCH, device, seed=i, x_std=2.0)
        err_f = check_close(attn_block.fused_attn_block(x, *w, HEADS, DIM_HEAD),
                            attn_block.attn_block_reference(x, *w, HEADS, DIM_HEAD),
                            2e-3, 2e-4, f"f32 N={n} C={c}")
        del x, w
        t_bytes, t_ops = bound_parts(n, c)
        row = {"max_err_bf16": err_b, "max_err_bf16_rounded": err_r, "max_err_f32": err_f,
               **timing(kernel_b, plain_b, (t_bytes, t_ops)), "route": route, "splits": splits}
        row["tflops"] = t_ops * BF16_FLOPS / row["ms"] / 1e12
        row["bound_share"] = row["bound_ms"] / row["ms"]
        rows[f"N{n}_C{c}"] = row
        print(f"   N={n:5d} C={c:3d} B={BATCH}: {json.dumps(row)}", flush=True)
        del xb, wb
        torch.cuda.empty_cache()
    print_attn_levels(rows)
    # the other batches of the main paths (ATTN_BATCHES): bf16 only, untimed
    by_batch = {}
    for batch in ATTN_BATCHES[1:]:
        errs = {}
        for i, (n, c) in enumerate(CHECK_SHAPES):
            route, splits = attn_route_of(batch, n, c)
            errs[f"N{n}_C{c} {route} x{splits}"] = attn_bf16_check(n, c, batch, device,
                                                                   seed=100 + i)[:2]
            torch.cuda.empty_cache()
        by_batch[f"B{batch}"] = errs
        print(f"   B={batch} bf16: {len(errs)} shapes within the bound, max abs err "
              f"{max(e for pair in errs.values() for e in pair if e is not None):.3e} "
              f"(against the rounded plain version, then the f32 one); {json.dumps(errs)}",
              flush=True)
    # f32 at the training batch, every level of the 64x64 UNet: the DMD
    # phase's teacher and fake UNet run #1 in f32 there
    errs = {}
    for i, (n, c) in enumerate(sorted(set(FORWARD_SHAPES), reverse=True)):
        x, w = block_inputs(n, c, TRAIN_BATCH, device, seed=200 + i, x_std=2.0)
        errs[f"N{n}_C{c}"] = (check_close(attn_block.fused_attn_block(x, *w, HEADS, DIM_HEAD),
                                          attn_block.attn_block_reference(x, *w, HEADS,
                                                                          DIM_HEAD),
                                          2e-3, 2e-4, f"f32 B={TRAIN_BATCH} N={n} C={c}"), None)
        del x, w
        torch.cuda.empty_cache()
    by_batch[f"B{TRAIN_BATCH}_f32"] = errs
    print(f"   B={TRAIN_BATCH} f32: {len(errs)} shapes within rtol 2e-3, atol 2e-4, max abs "
          f"err {max(e for e, _ in errs.values()):.3e}; {json.dumps(errs)}", flush=True)
    # f32 at the class-conditional baselines' sampling batches (phase 23's
    # f32 class UNet at the Cell-200 teacher's shapes): CFG's 2B rows and
    # ADM-G's guided batch
    for batch in BASE_F32_BATCHES:
        errs = {}
        for i, (n, c) in enumerate(sorted(set(CELL200_SHAPES), reverse=True)):
            x, w = block_inputs(n, c, batch, device, seed=300 + i, x_std=2.0)
            errs[f"N{n}_C{c}"] = (check_close(
                attn_block.fused_attn_block(x, *w, HEADS, DIM_HEAD),
                attn_block.attn_block_reference(x, *w, HEADS, DIM_HEAD), 2e-3, 2e-4,
                f"f32 B={batch} N={n} C={c}"), None)
            del x, w
            torch.cuda.empty_cache()
        by_batch[f"B{batch}_f32"] = errs
        print(f"   B={batch} f32 (the Cell-200 teacher's shapes): {len(errs)} shapes within "
              f"rtol 2e-3, atol 2e-4, max abs err {max(e for e, _ in errs.values()):.3e}; "
              f"{json.dumps(errs)}", flush=True)
    return rows, by_batch


def print_attn_levels(rows: dict) -> None:
    """Kernel #1 per attention level of one B-64 forward (down 0-4, then up
    0-4), and the sum of the ten launches."""
    total = {"ms": 0.0, "host_ms": 0.0, "bound_ms": 0.0, "plain_ms": 0.0}
    for i, (n, c) in enumerate(FORWARD_SHAPES):
        r = rows[f"N{n}_C{c}"]
        for key in total:
            total[key] += r[key]
        print(f"   {'down' if i < 5 else 'up'} {i % 5} N={n:5d} C={c:3d}: {r['ms']:.4f} ms "
              f"({r['tflops']:.1f} TFLOP/s, {100 * r['bound_share']:.1f}% of the bound "
              f"{r['bound_ms']:.4f}), host {r['host_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms; "
              f"{r['route']} route, {r['splits']} split(s)", flush=True)
    print(f"   the ten: {total['ms']:.4f} ms ({100 * total['bound_ms'] / total['ms']:.1f}% of the "
          f"bound {total['bound_ms']:.4f}), host {total['host_ms']:.4f} ms, plain "
          f"{total['plain_ms']:.4f} ms", flush=True)


@contextlib.contextmanager
def plain_attention():
    """Route the model's attention blocks through the plain version."""
    kernel = attn_block.fused_attn_block
    attn_block.fused_attn_block = attn_block.attn_block_reference
    try:
        yield
    finally:
        attn_block.fused_attn_block = kernel


@torch.no_grad()
def model_parity(device, kernels=contextlib.nullcontext, plain=plain_attention,
                 what: str = "kernel and plain attention") -> dict:
    """Phases 4 and 10: the full-width f32 UNet, one forward and a 5-step CFG
    DDIM run from the same weights and noise, under `kernels()` and under
    `plain()`; each within 1e-3."""
    model = Unet(**UNET, dtype=torch.float32, seed=0).to(
        device, memory_format=torch.channels_last).eval()
    g = torch.Generator().manual_seed(1)
    b = 4
    x = torch.randn(b, 64, 64, 3, generator=g).to(device)
    t = torch.tensor([0, 250, 500, 999], device=device)
    emb = make_fn_y2h(128)(torch.linspace(0.1, 0.9, b, device=device))
    keep = torch.tensor([True, False, True, False], device=device)
    with kernels():
        out_k = model(x, t, emb, keep)
    with plain():
        out_p = model(x, t, emb, keep)
    fwd = (out_k - out_p).abs().max().item()

    diffusion = GaussianDiffusion(model, DiffusionConfig(
        image_size=64, channels=3, timesteps=1000, sampling_timesteps=5,
        objective="pred_x0"), device=device)
    noise = torch.randn(2, 64, 64, 3, generator=g).to(device)
    with kernels():
        img_k = diffusion.ddim_sample(emb[:2], cond_scale=1.5, noise=noise)
    with plain():
        img_p = diffusion.ddim_sample(emb[:2], cond_scale=1.5, noise=noise)
    ddim = (img_k - img_p).abs().max().item()
    print(f"   forward max abs diff {fwd:.3e}; 5-step DDIM max abs diff {ddim:.3e}",
          flush=True)
    if not (fwd <= 1e-3 and ddim <= 1e-3):
        raise AssertionError(f"{what} disagree in the model: "
                             f"forward {fwd:.3e}, DDIM {ddim:.3e} (bound 1e-3)")
    return {"forward_max_abs_diff": fwd, "ddim5_max_abs_diff": ddim}


def _request(url: str, body: dict | None = None) -> dict:
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as resp:
        return json.loads(resp.read())


def _serve_requests(service, requests, image_size: int,
                    refused=()) -> tuple[int, int, float]:
    """POST each (n labels, seed) of `requests` to /generate of `service`
    (a SamplerService or a GeneratorService) behind its HTTP server on
    127.0.0.1, then each body of `refused`, which must be answered 400;
    checks /healthz and every reply (uint8 [n, size, size, 3], not
    constant) and stops the server. Returns (batches sampled, images,
    seconds spent in the requests)."""
    httpd = serve(service, 0, host="127.0.0.1", block=False)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    batches, n_images, req_s = 0, 0, 0.0
    try:
        health = _request(url + "/healthz")
        if health.get("status") != "ok" or health.get("warm") != service.warm:
            raise AssertionError(f"/healthz answered {health}")
        for n, seed in requests:
            labels = np.linspace(0.05, 0.95, n).round(4).tolist()
            t0 = time.perf_counter()
            reply = _request(url + "/generate", {"labels": labels, "seed": seed})
            req_s += time.perf_counter() - t0
            images = np.load(io.BytesIO(base64.b64decode(reply["images_b64"])))["images"]
            if images.dtype != np.uint8 or images.shape != (n, image_size, image_size, 3):
                raise AssertionError(f"/generate gave {images.dtype} {images.shape}")
            if images.std() == 0:
                raise AssertionError("/generate gave constant images")
            n_images += n
            batches += -(-n // service.max_batch)
        for body in refused:
            try:
                _request(url + "/generate", body)
            except urllib.error.HTTPError as e:
                if e.code != 400:
                    raise
            else:
                raise AssertionError(f"/generate accepted {body}")
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=60)
    if thread.is_alive():
        raise AssertionError("the HTTP server thread did not stop")
    return batches, n_images, req_s


@torch.no_grad()
def cfg_forward_ms(service: SamplerService) -> float:
    """One sampling step's CFG forward of `service`'s model: SERVE_BATCH
    labels, so B = BATCH rows, timed with CUDA events."""
    device, c = service.diffusion.device, service.diffusion.config
    g = torch.Generator().manual_seed(5)
    x = torch.randn(SERVE_BATCH, c.image_size, c.image_size, c.channels, generator=g).to(device)
    t = torch.full((SERVE_BATCH,), 500, device=device)
    emb = service.fn_y2h(torch.linspace(0.05, 0.95, SERVE_BATCH, device=device)[:, None])
    return time_ms(lambda: service.diffusion.model_predictions(x, t, emb, cond_scale=1.5),
                   reps=10)


def cfg_forward_turns(service: SamplerService) -> dict:
    """The same CFG forward with the resnet switch off and on in turns (off,
    on, on, off): per switch, the mean event time and the mean host time
    (the Python and the enqueue of 10 forwards, no synchronisation inside).
    Where the two are equal, the forward waits on the host."""
    device, c = service.diffusion.device, service.diffusion.config
    g = torch.Generator().manual_seed(5)
    x = torch.randn(SERVE_BATCH, c.image_size, c.image_size, c.channels, generator=g).to(device)
    t = torch.full((SERVE_BATCH,), 500, device=device)
    emb = service.fn_y2h(torch.linspace(0.05, 0.95, SERVE_BATCH, device=device)[:, None])
    fwd = lambda: service.diffusion.model_predictions(x, t, emb, cond_scale=1.5)
    out = {"off": {"ms": [], "host_ms": []}, "on": {"ms": [], "host_ms": []}}
    for on in (False, True, True, False):
        with fused_resnet(on):
            r = out["on" if on else "off"]
            r["ms"].append(time_ms(fwd, reps=10))
            r["host_ms"].append(host_ms(fwd, reps=10))
    return {k: {m: sum(v) / len(v) for m, v in r.items()} for k, r in out.items()}


def serve_main_path(device, card: str) -> dict:
    """Phase 5: requests through the port's HTTP server; returns the
    kernel's launch count over the phase and the throughput."""
    args = parse_opts(SERVE_ARGV)
    _reset_counts()
    t0 = time.perf_counter()
    service = SamplerService(args, max_batch=SERVE_BATCH, warm=True, device=str(device))
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    batches, n_images, req_s = _serve_requests(service, ((5, 0), (40, 1)), args.image_size)
    batches += 1  # the warm-up batch
    counts = _counts()
    launches = counts["attn_block"]
    expected = 10 * STEPS * batches
    ips = n_images / req_s
    print(f"   {batches} batches of {SERVE_BATCH} (warm-up {warm_s:.1f} s), "
          f"{n_images} images in {req_s:.2f} s: {ips:.2f} images/s on {card}; "
          f"attention kernel launches {launches} (expected {expected}); resnet kernel "
          f"launches {counts['resnet_half_a']}, {counts['resnet_half_b']} (expected 0)",
          flush=True)
    if launches != expected:
        raise AssertionError(f"the serving path launched the attention kernel "
                             f"{launches} times, expected {expected}")
    if any(counts[name] for name in (*RESNET, *NEW_KERNELS)):
        raise AssertionError(f"the serving path ran a kernel not on it: {counts}")
    forward_ms = cfg_forward_ms(service)
    print(f"   one CFG forward (B {BATCH}, bf16): {forward_ms:.4f} ms", flush=True)
    return {"launches": launches, "batches": batches, "images_per_s": ips,
            "requested_images": n_images, "request_s": req_s, "cfg_forward_ms": forward_ms}


# ------------------------------------------------- the training slice

TRAIN_BATCH = 128
TRAIN_STEPS = 30
# (N, C) of kernels #2-#5: the two N 4096 blocks of the 64x64 training step
# first (the main path's shape), then N 2048, the 128x128 UNet's 128^2 and
# 64^2 up levels (N 16384 C 64, N 4096 C 128) and the 192x192 UNet's 192^2
# level: every two-pass shape of the three UNets; then the Cell-200 teacher's
# top level (N 4096, C 32). A shape's index seeds its inputs.
LARGE_SHAPES = [(4096, 64), (2048, 64), (16384, 64), (4096, 128), (36864, 64), (4096, 32)]
# the batch of each shape: TRAIN_BATCH, but B 32 at N 36864, where the plain
# versions' f32 intermediates ([B, N, 3F] and more) at B 128 would take tens of GB
LARGE_BATCH = {(36864, 64): 32}
# each shape at its batch in bf16 and f32, then the extra cases: the
# Cell-200 teacher's top level in f32 at B 64, phase 23's class UNet
# training, and the flagship's top level in bf16 at B 64, a rank's rows in
# phase 26's two-rank training
LARGE_CASES = ([(n, c, LARGE_BATCH.get((n, c), TRAIN_BATCH), (torch.bfloat16, torch.float32))
                for n, c in LARGE_SHAPES] + [(4096, 32, 64, (torch.float32,)),
                                             (4096, 64, 64, (torch.bfloat16,))])
LARGE = ("attn_ctx_large", "attn_out_large", "attn_bwd_a", "attn_bwd_b")
LARGE_OUTPUTS = {"attn_ctx_large": ("kmax", "a", "s"), "attn_out_large": ("y",),
                 "attn_bwd_a": ("do", "d_ctx", "d_wout", "d_bout", "d_gout"),
                 "attn_bwd_b": ("dx", "d_wqkv", "d_gpre")}
LARGE_REPLACES = {"attn_ctx_large": "ccdm_tpu/ops/attn_block.py:146",
                  "attn_out_large": "ccdm_tpu/ops/attn_block.py:198",
                  "attn_bwd_a": "ccdm_tpu/ops/attn_block.py:360",
                  "attn_bwd_b": "ccdm_tpu/ops/attn_block.py:413"}
TRAIN_ARGV = ["--data_name", "synthetic", "--image_size", "64", "--model_channels", "64",
              "--channel_mult", "1_2_2_4_8", "--train_amp", "--pred_objective", "pred_x0",
              "--vicinity_type", "hv", "--train_batch_size", str(TRAIN_BATCH),
              "--train_lr", "1e-4", "--niters", str(TRAIN_STEPS),
              "--save_every", str(TRAIN_STEPS), "--log_every", "5", "--seed", "0",
              # the sampling main.py runs after training: 2 eval labels x 4
              # images in one batch each, 10 DDIM steps
              "--eval_mode", "4", "--FID_num_centers", "2", "--nfake_per_label", "4",
              "--sample_timesteps", "10"]
EVAL_FORWARDS = 2 * 10  # UNet forwards of that sampling


def large_bound_parts(name: str, n: int, c: int, batch: int = TRAIN_BATCH,
                      itemsize: int = 2) -> tuple[float, float]:
    """Least times (ms) of one call of kernel `name`: each input read and
    each output written once (activations, matrices and ctx in the
    activation type; do, the residuals, vectors and weight grads in f32),
    over HBM bandwidth; its products' operations over the bf16 peak."""
    f, d = F, DIM_HEAD
    act, act32 = batch * n * c * itemsize, batch * n * c * 4
    cxd, cx32, sf = batch * f * d * itemsize, batch * f * d * 4, batch * f * 4
    wq, wkv, wout, vec = c * f * itemsize, 2 * c * f * itemsize, f * c * itemsize, c * 4
    nbytes = {"attn_ctx_large": act + wkv + vec + cx32 + 2 * sf,
              "attn_out_large": 2 * act + cxd + wq + wout + 3 * vec,
              "attn_bwd_a": 2 * act + cxd + wq + wout + 3 * vec + act32 + cx32 + f * c * 4
              + 2 * vec,
              "attn_bwd_b": 3 * act + act32 + cxd + wq + wkv + wout + vec + cx32 + 2 * sf
              + 3 * c * f * 4 + vec}[name]
    return nbytes / HBM_BYTES_PER_S * 1e3, large_flops(name, n, c, batch) / BF16_FLOPS * 1e3


def large_flops(name: str, n: int, c: int, batch: int = TRAIN_BATCH) -> float:
    """Operations of the products of one call of kernel `name` (2 per
    multiply-add)."""
    f, d = F, DIM_HEAD
    per_token = {"attn_ctx_large": 2 * c * f + f * d, "attn_out_large": 2 * c * f + f * d,
                 "attn_bwd_a": 4 * c * f + 2 * f * d,
                 "attn_bwd_b": 10 * c * f + 3 * f * d}[name]
    return 2 * batch * n * per_token


def kmax_check(kmax, rkmax, x, g_pre, wqkv, what: str) -> tuple[float, int]:
    """#2's kmax in bf16 against ctx_large_reference's (rkmax), at every
    shape: within 1e-5 of the largest |kmax|, except where the two round one
    element of xn = bf16(x / rms(x) g_pre) to different neighbours: their
    f32 sums of squares differ in order, so 1 / rms can differ in its last
    bit, and a token at the column's max then moves k by up to one bf16 step
    of that element times its weight. Such a column must lie within that
    step (the largest over the batch row's tokens and channels) and be at
    most one in a thousand. (The kernel's own rounding points are held to
    1e-5 everywhere by ctx_large_tensor_reference.) Returns the max abs
    error and the count of those columns."""
    atol = 1e-5 * float(rkmax.abs().max())
    diff = (kmax.float() - rkmax.float()).abs()
    if not bool(torch.isfinite(kmax).all()):
        raise AssertionError(f"{what}: non-finite output")
    bad = diff > atol + 1e-5 * rkmax.abs()
    if bool(bad.any()):
        _, _, xn = attn_block._prenorm(x, g_pre)
        xn = xn.bfloat16().float().abs()
        step = torch.where(xn > 0, torch.exp2(torch.floor(torch.log2(xn)) - 7),
                           torch.zeros_like(xn)).amax(1)  # [B, C]: the largest bf16 step
        wk = wqkv[:, F:2 * F].float().abs()
        flip = (step[:, :, None] * wk[None]).amax(1)  # [B, F]: one element's step times its weight
        beyond = bad & (diff > atol + flip)
        if bool(beyond.any()) or int(bad.sum()) > max(1, bad.numel() // 1000):
            raise AssertionError(f"{what}: {int(bad.sum())} of {bad.numel()} beyond 1e-5 "
                                 f"({int(beyond.sum())} beyond one bf16 step of xn); max abs "
                                 f"err {diff.max().item():.3e}")
    return diff.max().item(), int(bad.sum())


def _check_grad(got, want, dtype, what) -> float:
    """The backward bounds of tests/test_attn_block.py:301-308: f32 rtol =
    atol = 2e-3; bf16 rtol 1e-1, atol 0.02 max(|g|, 1)."""
    if dtype == torch.float32:
        return check_close(got, want, 2e-3, 2e-3, what)
    return check_close(got, want, 1e-1, 0.02 * max(float(want.float().abs().max()), 1.0), what)


def large_vs_plain(device) -> dict:
    """Kernels #2-#5 against their plain versions at LARGE_CASES (each of
    LARGE_SHAPES in bf16 and f32, TF32 off, then the extra f32 batches),
    timed in bf16 (event and host time, TFLOP/s and share of
    the bound; each kernel's route, asserted the tensor cores, tile and
    splits from its plan); #2's bf16 kmax against the plain version at the
    route's rounding points and against ctx_large_reference (kmax_check);
    #4 + #5 in f32 also
    against autograd through attn_block_reference; #5 in bf16 nearer its
    plain version than one with d_a rounded to bf16 (check_rounding)."""
    rows = {}
    for i, (n, c, batch, dtypes) in enumerate(LARGE_CASES):
        for dt in dtypes:
            x, w = block_inputs(n, c, batch, device, seed=20 + i, x_std=1.0)
            g = torch.Generator().manual_seed(40 + i)
            x = x.to(dt)
            dy = torch.randn(batch, n, c, generator=g).to(device).to(dt)
            g_pre, wqkv, wout, bout, g_out = w
            tag = f"N={n} C={c} {str(dt)[6:]}"
            if i >= len(LARGE_SHAPES):  # an extra case: its batch in the tag
                tag += f" B={batch}"
            err = {}
            a, s, kmax = attn_block.attn_ctx_large(x, g_pre, wqkv, HEADS)
            ra, rs, rkmax = attn_block.ctx_large_reference(x, g_pre, wqkv, HEADS)
            fwd = (2e-3, 2e-4) if dt == torch.float32 else (3e-2, 3e-2)
            if dt == torch.bfloat16:
                # the plain version at the tensor route's rounding points (its
                # xn as warp_norm16 forms it), then ctx_large_reference
                own = attn_block.ctx_large_tensor_reference(x, g_pre, wqkv, HEADS)[2]
                err["kmax"] = check_close(kmax, own, 1e-5, 1e-5 * float(own.abs().max()),
                                          f"#2 kmax {tag}")
                del own
                err["kmax_plain"], row_flips = kmax_check(kmax, rkmax, x, g_pre, wqkv,
                                                          f"#2 kmax against the plain #2 {tag}")
            else:
                err["kmax"] = check_close(kmax, rkmax, 1e-5, 1e-5 * float(rkmax.abs().max()),
                                          f"#2 kmax {tag}")
            err["a"] = check_close(a, ra, fwd[0], fwd[1] * float(ra.abs().max()), f"#2 a {tag}")
            err["s"] = check_close(s, rs, fwd[0], fwd[1] * float(rs.abs().max()), f"#2 s {tag}")
            ctx = attn_block.finalize_ctx(ra, rs, dt)
            out_args = (x, g_pre, wqkv, ctx, wout, bout, g_out, HEADS)
            want = attn_block.out_large_reference(*out_args)
            scale = None if dt == torch.float32 else torch.maximum(
                want.float().abs(), (want.float() - x.float()).abs())
            err["y"] = check_close(attn_block.attn_out_large(*out_args), want, *fwd,
                                   f"#3 y {tag}", scale=scale)
            bwd_a_args = (x, dy, g_pre, wqkv, ctx, wout, bout, g_out, HEADS)
            want_a = attn_block.bwd_a_reference(*bwd_a_args)
            for name, gv, wv in zip(("do", "d_ctx", "d_wout", "d_bout", "d_gout"),
                                    attn_block.attn_bwd_a(*bwd_a_args), want_a):
                err[name] = _check_grad(gv, wv, dt, f"#4 {name} {tag}")
            d_a, d_s = attn_block.finalize_ctx_backward(want_a[1], ra, rs)
            bwd_b_args = (x, dy, want_a[0], g_pre, wqkv, ctx, wout, rkmax, d_a, d_s, HEADS)
            got_b = attn_block.attn_bwd_b(*bwd_b_args)
            want_b = attn_block.bwd_b_reference(*bwd_b_args)
            for name, gv, wv in zip(("dx", "d_wqkv", "d_gpre"), got_b, want_b):
                err[name] = _check_grad(gv, wv, dt, f"#5 {name} {tag}")
            row = {"batch": batch, "max_err": err}
            if dt == torch.bfloat16:
                row["kmax_rounding_flips"] = row_flips
            if dt == torch.float32:
                row["autograd_max_err"] = autograd_vs_reference(x, dy, w)
            else:
                # d_a stays f32 in d_e and d_v: rounded to bf16 it moves every output
                other = attn_block.bwd_b_reference(*bwd_b_args[:8], d_a.bfloat16().float(),
                                                   *bwd_b_args[9:])
                row["d_a_rounding_ratio"] = {
                    name: check_rounding(gv, wv, ov, f"#5 {name} {tag}: d_a's precision")
                    for name, gv, wv, ov in zip(("dx", "d_wqkv", "d_gpre"), got_b, want_b, other)}
                del other
                reps = 5 if n * batch > 4096 * TRAIN_BATCH else 20
                calls = {"attn_ctx_large": ((lambda: attn_block.attn_ctx_large(x, g_pre, wqkv, HEADS)),
                                            (lambda: attn_block.ctx_large_reference(x, g_pre, wqkv, HEADS))),
                         "attn_out_large": ((lambda: attn_block.attn_out_large(*out_args)),
                                            (lambda: attn_block.out_large_reference(*out_args))),
                         "attn_bwd_a": ((lambda: attn_block.attn_bwd_a(*bwd_a_args)),
                                        (lambda: attn_block.bwd_a_reference(*bwd_a_args))),
                         "attn_bwd_b": ((lambda: attn_block.attn_bwd_b(*bwd_b_args)),
                                        (lambda: attn_block.bwd_b_reference(*bwd_b_args)))}
                for name, (kernel, plain) in calls.items():
                    parts = large_bound_parts(name, n, c, batch)
                    t = timing(kernel, plain, parts, reps=reps)
                    t["tflops"] = large_flops(name, n, c, batch) / t["ms"] / 1e9
                    t["share_of_bound"] = t["bound_ms"] / t["ms"]
                    pl = attn_block.large_plan(2 + LARGE.index(name), batch, n, c, HEADS, dt)
                    if pl.route != "tensor":
                        raise AssertionError(f"{name} {tag} took the {pl.route} route")
                    t.update(route=pl.route, tile=pl.tile, splits=pl.splits)
                    if name == "attn_bwd_b":
                        t["wgrad_splits"] = pl.wgrad_splits
                    row[name] = t
            rows[tag] = row
            print(f"   {tag} B={batch}: {json.dumps(row)}", flush=True)
            del x, w, dy, a, s, kmax, ra, rs, rkmax, ctx, want, want_a, d_a, d_s, got_b, want_b
            torch.cuda.empty_cache()
    return rows


def autograd_vs_reference(x, dy, w) -> float:
    """#4 + #5 through the autograd Function against autograd through the
    plain composition, all six gradients, f32 (bound 2e-3)."""
    fused = [t.detach().clone().requires_grad_() for t in (x, *w)]
    plain = [t.detach().clone().requires_grad_() for t in (x, *w)]
    y = attn_block.fused_attn_block(*fused, HEADS, DIM_HEAD)
    if type(y.grad_fn).__name__ != "_TwoPassBlockBackward":
        raise AssertionError(f"the training route took {type(y.grad_fn).__name__}")
    y.backward(dy)
    attn_block.attn_block_reference(*plain, HEADS, DIM_HEAD).backward(dy)
    return max(_check_grad(t.grad, r.grad, torch.float32, f"autograd {name}")
               for name, t, r in zip(("dx", "d_gpre", "d_wqkv", "d_wout", "d_bout", "d_gout"),
                                     fused, plain))


@torch.no_grad()
def two_pass_vs_single_pass(device) -> dict:
    """Sampling-time forward (B 64, bf16): #2 + #3 against #1."""
    out = {}
    for n in (4096, 16384):
        x, w = block_inputs(n, 64, BATCH, device, seed=60, x_std=1.0)
        xb, (g_pre, wqkv, wout, bout, g_out) = x.bfloat16(), w

        def two_pass():
            a, s, _ = attn_block.attn_ctx_large(xb, g_pre, wqkv, HEADS)
            return attn_block.attn_out_large(xb, g_pre, wqkv, attn_block.finalize_ctx(
                a, s, xb.dtype), wout, bout, g_out, HEADS)

        err = check_close(two_pass(), attn_block._launch(xb, *w, HEADS, DIM_HEAD), 3e-2, 3e-2,
                          f"#2+#3 against #1 N={n}")
        out[f"N{n}"] = {"two_pass_ms": time_ms(two_pass),
                        "single_pass_ms": time_ms(lambda: attn_block._launch(xb, *w, HEADS,
                                                                            DIM_HEAD)),
                        "max_abs_diff": err}
        print(f"   N={n} B={BATCH} bf16: {json.dumps(out[f'N{n}'])}", flush=True)
    return out


# --attn_dim_head 64: heads and dim_head (F 128, as at 4 x 32) and (B, N, C)
# of its check, N % 2048 == 0 so that training takes the two-pass kernels
OTHER_DIM_HEAD = (2, 64)
OTHER_DIM_HEAD_SHAPE = (8, 4096, 64)


def dim_head_vs_plain(device) -> dict:
    """The block at dim_head 64 through its kernels, bf16 and f32 (TF32
    off): every kernel's plan takes the CUDA cores (asserted); without a
    gradient one launch of #1, with one #2 + #3 and then #4 + #5, one launch
    each (counted); y against the plain block in f32 at phase 3's bounds,
    the six gradients against autograd through it at phase 6's. In bf16
    timed: the forward without a gradient (#1's CUDA-core route) and one
    forward + backward (#2-#5's), each against the plain block."""
    heads, dim_head = OTHER_DIM_HEAD
    b, n, c = OTHER_DIM_HEAD_SHAPE
    f = heads * dim_head
    out = {}
    for dt in (torch.bfloat16, torch.float32):
        tag = f"B={b} N={n} C={c} heads={heads} dim_head={dim_head} {str(dt)[6:]}"
        routes = [attn_block.plan(b, n, c, heads, dt, dim_head).route] + [
            attn_block.large_plan(k, b, n, c, heads, dt, dim_head).route for k in (2, 3, 4, 5)]
        if routes != ["cores"] * 5:
            raise AssertionError(f"{tag}: routes {routes}")
        x, w = block_inputs(n, c, b, device, seed=70, x_std=1.0)
        if w[1].shape[1] != 3 * f:
            raise AssertionError("OTHER_DIM_HEAD must keep F at HEADS x DIM_HEAD")
        x = x.to(dt)
        dy = torch.randn(b, n, c, generator=torch.Generator().manual_seed(71)).to(device)
        counters = (attn_block.fused_attn_block, *(getattr(attn_block, k) for k in LARGE))
        before = [fn.launches for fn in counters]
        with torch.no_grad():
            y0 = attn_block.fused_attn_block(x, *w, heads, dim_head)
        leaves = [t.clone().requires_grad_() for t in (x, *w)]
        y = attn_block.fused_attn_block(*leaves, heads, dim_head)
        y.backward(dy.to(dt))
        torch.cuda.synchronize()
        launches = [fn.launches - n0 for fn, n0 in zip(counters, before)]
        if launches != [1, 1, 1, 1, 1]:
            raise AssertionError(f"{tag}: launches of #1-#5 {launches}, not one each")
        plain = [t.detach().float().requires_grad_() for t in (x, *w)]
        want = attn_block.attn_block_reference(*plain, heads, dim_head)
        want.backward(dy)
        fwd = (2e-3, 2e-4) if dt == torch.float32 else (3e-2, 3e-2)
        scale = None if dt == torch.float32 else torch.maximum(
            want.detach().abs(), (want.detach() - x.float()).abs())
        err = {"y_no_grad": check_close(y0, want.detach(), *fwd, f"#1 y {tag}", scale=scale),
               "y": check_close(y.detach(), want.detach(), *fwd, f"#2 + #3 y {tag}",
                                scale=scale)}
        for name, got, ref in zip(("dx", "d_gpre", "d_wqkv", "d_wout", "d_bout", "d_gout"),
                                  leaves, plain):
            err[name] = _check_grad(got.grad, ref.grad, dt, f"#4 + #5 {name} {tag}")
        out[tag] = {"routes": routes, "launches": launches, "max_err": err}
        if dt == torch.bfloat16:
            def step(block):
                y = block(*leaves, heads, dim_head)
                y.backward(dy.to(dt))
            with torch.no_grad():
                out[tag]["forward_ms"] = time_ms(lambda: attn_block.fused_attn_block(
                    x, *w, heads, dim_head))
                out[tag]["forward_plain_ms"] = time_ms(lambda: attn_block.attn_block_reference(
                    x, *w, heads, dim_head))
            out[tag]["train_ms"] = time_ms(lambda: step(attn_block.fused_attn_block))
            out[tag]["train_plain_ms"] = time_ms(lambda: step(attn_block.attn_block_reference))
        print(f"   {tag}: {json.dumps(out[tag])}", flush=True)
        del x, w, dy, y0, y, leaves, plain, want
        torch.cuda.empty_cache()
    return out


BN_FED_BIASES = ("cond_dense_1.bias", "cond_dense_2.bias")


def grad_parity(device, use_hy: bool = False) -> dict:
    """One loss + backward of the full-width f32 UNet (TF32 off), with the
    kernels and with plain attention, on the same batch and draws. Every
    gradient leaf within 1e-3 of its largest |g|; the two biases that feed
    a train-mode BatchNorm have zero gradient in exact arithmetic (rounding
    noise on both sides) and are held to 1e-3 of the model's largest |g|.
    With `use_hy`, H(y) from a frozen ModelY2Cov of random weights."""
    model = Unet(**UNET, dtype=torch.float32, seed=0).to(device, memory_format=torch.channels_last)
    fn_y2cov = ili.frozen_embedding(ModelY2Cov(3 * 64 * 64, seed=0), device) if use_hy else None
    diffusion = GaussianDiffusion(model, DiffusionConfig(
        image_size=64, channels=3, timesteps=1000, objective="pred_x0", vicinity_type="hv",
        use_Hy=use_hy), device=device, fn_y2cov=fn_y2cov)
    g = torch.Generator().manual_seed(3)
    b = 8
    images01 = torch.rand(b, 64, 64, 3, generator=g).to(device)
    labels = torch.rand(b, 1, generator=g).to(device)
    draws = {"t": torch.randint(0, 1000, (b,), generator=g), "keep_mask": torch.rand(b, generator=g) < 0.9,
             "noise": torch.randn(b, 64, 64, 3, generator=g)}
    emb = make_fn_y2h(128)(labels)

    def loss_and_grads():
        model.zero_grad(set_to_none=True)
        loss = diffusion.loss(images01, labels, emb, vicinal_weights=torch.ones(b, device=device),
                              kappa=0.05, draws=draws)
        loss.backward()
        return float(loss.detach()), {n: p.grad.detach().clone() for n, p in model.named_parameters()}

    launches = attn_block.attn_ctx_large.launches
    loss_k, grads_k = loss_and_grads()
    if attn_block.attn_ctx_large.launches - launches != 2:
        raise AssertionError("the f32 training step did not take the two-pass kernels")
    with plain_attention():
        loss_p, grads_p = loss_and_grads()
    largest = max(float(v.abs().max()) for v in grads_p.values())
    worst = 0.0
    for name, want in grads_p.items():
        scale = largest if name in BN_FED_BIASES else float(want.abs().max())
        diff = float((grads_k[name] - want).abs().max())
        if not diff <= 1e-3 * scale:
            raise AssertionError(f"grad {name}: max abs diff {diff:.3e} beyond 1e-3 x {scale:.3e}")
        worst = max(worst, diff / max(scale, 1e-30))
    print(f"   {'use_Hy: ' if use_hy else ''}loss {loss_k:.6f} (plain {loss_p:.6f}); worst "
          f"gradient leaf {worst:.3e} of its largest |g|", flush=True)
    if abs(loss_k - loss_p) > 1e-5 * abs(loss_p):
        raise AssertionError(f"loss {loss_k} against plain {loss_p}")
    return {"loss": loss_k, "loss_plain": loss_p, "worst_leaf_rel_diff": worst}


RESNET = ("resnet_half_a", "resnet_half_b")


def _counters() -> dict:
    """Every kernel wrapper by its name in the kernels line."""
    return {"attn_block": attn_block.fused_attn_block,
            **{name: getattr(attn_block, name) for name in LARGE},
            **{name: getattr(resnet_block, name) for name in RESNET},
            **{name: getattr(la, name) for name in LA}, "bias_act_fused": so.bias_act_fused}


def _counts() -> dict:
    return {name: fn.launches for name, fn in _counters().items()}


def _reset_counts() -> None:
    for fn in _counters().values():
        fn.launches = 0


def train_main_path(device, card: str, argv_tail: list, steps: int, expected: dict,
                    fused: bool, checks, keep: bool = False) -> dict:
    """Phases 8 and 12: `python -m ccdm_tpu_torch.main` with `argv_tail` and
    the resnet switch `fused`, in build/smoke_run[_fused] (deleted after,
    unless `keep`: phase 21 distils phase 20's run, then deletes it).
    The launch counts must be exactly `expected`, every loss finite and the
    last logged step `steps`; `checks(trainer, argv, log)` runs the phase's
    own checks and returns its entries of the result."""
    from ccdm_tpu_torch import main as port_main

    run = Path(__file__).resolve().parent / "build" / ("smoke_run_fused" if fused else "smoke_run")
    shutil.rmtree(run, ignore_errors=True)
    argv = ["--root_path", str(run), "--device", str(device), *argv_tail]
    try:
        with fused_resnet(fused):
            _reset_counts()
            trainer = port_main.main(argv)
            torch.cuda.synchronize()
            counts = _counts()
        log = [json.loads(line) for line in
               open(Path(port_main.results_folder(parse_opts(argv))) / "train_log.jsonl")]
        print(f"   {steps} steps of batch {parse_opts(argv).train_batch_size}: losses "
              f"{[round(r['loss'], 4) for r in log]}; launches {counts} (expected {expected})",
              flush=True)
        if not all(np.isfinite(r["loss"]) for r in log) or log[-1]["step"] != steps:
            raise AssertionError(f"training log {log}")
        if counts != expected:
            raise AssertionError(f"kernel launches {counts}, expected {expected}")
        return {"launches": counts, "steps": steps, "losses": [r["loss"] for r in log],
                **checks(trainer, argv, log)}
    finally:
        if not keep:
            shutil.rmtree(run, ignore_errors=True)


def train_checks(card: str):
    """Phase 8's own checks: the parameters moved, the EMA took every step,
    the warm images/s; then a short request served from the milestone."""
    initial = Unet(**UNET, dtype=torch.bfloat16, seed=0).state_dict()

    def checks(trainer, argv, log) -> dict:
        state = trainer.state
        moved = max(float((p.detach().cpu() - initial[name]).abs().max())
                    for name, p in state.model.named_parameters())
        warm = [r["imgs_per_sec"] for r in log if r["step"] > TRAIN_STEPS // 3]
        ips = sum(warm) / len(warm)
        print(f"   params moved by up to {moved:.3e}; ema_step {state.ema_step}; warm train "
              f"{ips:.2f} images/s (steps {TRAIN_STEPS // 3 + 1}-{TRAIN_STEPS}, batch "
              f"{TRAIN_BATCH}, bf16) on {card}", flush=True)
        if not moved > 0 or state.step != TRAIN_STEPS or state.ema_step != TRAIN_STEPS:
            raise AssertionError(f"params moved {moved}, step {state.step}, "
                                 f"ema_step {state.ema_step}")
        args = parse_opts([*argv, "--serve_milestone", str(TRAIN_STEPS),
                           "--sample_timesteps", "25", "--sample_cond_scale", "1.5"])
        service = SamplerService(args, max_batch=4, warm=False, device=args.device)
        images = service.generate(np.linspace(0.1, 0.9, 4).astype(np.float32))
        if images.dtype != np.uint8 or images.shape != (4, 64, 64, 3) or images.std() == 0:
            raise AssertionError(f"serving milestone {TRAIN_STEPS} gave {images.dtype} "
                                 f"{images.shape}, std {images.std()}")
        print(f"   served 4 labels x 25 DDIM steps from milestone {TRAIN_STEPS}: uint8 "
              f"{images.shape}, std {images.std():.2f}", flush=True)
        return {"train_images_per_s": ips}

    return checks


# ------------------------------------------------------ the CCDM recipe

RECIPE_STEPS = 20
RECIPE_SERVE_STEPS = 25
# the launch scripts' embedding flags, with the ILI epochs cut from 200 and
# 500 (y2h) and 10 and 500 (y2cov) to keep the phase near two minutes
RECIPE_FLAGS = ["--use_Hy", "--y2h_embed_type", "resnet", "--y2cov_embed_type", "resnet",
                "--hy_max_log", "4.0", "--epoch_cnn_embed", "2", "--epoch_net_y2h", "20",
                "--epoch_cnn_embed_y2cov", "1", "--epoch_net_y2cov", "20"]
RECIPE_ARGV = [*TRAIN_ARGV, *RECIPE_FLAGS, "--niters", str(RECIPE_STEPS),
               "--save_every", str(RECIPE_STEPS)]


def recipe_checks(card: str, phase8_ips: float):
    """Phase 18's own checks: the ILI cache, fn_y2cov's output and time,
    the warm rate; then one request served from the milestone with the
    embeddings loaded from the cache only, and the refusal without one."""
    def checks(trainer, argv, log) -> dict:
        from ccdm_tpu_torch.main import results_folder

        setting = Path(results_folder(parse_opts(argv))).parent
        cache = sorted(p.name for p in (setting / "embed_models").iterdir())
        tags = ["y2h_d128_e2_m20_seed0", f"y2cov_d{3 * 64 * 64}_e1_m20_seed0"]
        if not all(f"model-{t}" in cache and f"datafp-{t}.txt" in cache for t in tags):
            raise AssertionError(f"embed_models/ holds {cache}")
        stages = dict(ili.STAGE_SECONDS)
        if sorted(stages) != ["y2cov_cnn", "y2cov_mlp", "y2h_cnn", "y2h_mlp"]:
            raise AssertionError(f"ILI stage times {stages}")
        fn_y2cov = trainer.diffusion.fn_y2cov
        labels = torch.linspace(0.0, 1.0, TRAIN_BATCH, device=trainer.device)[:, None]
        h = fn_y2cov(labels)
        if h.shape != (TRAIN_BATCH, 3 * 64 * 64) or not bool(torch.isfinite(h).all()) \
                or float(h.min()) < 0:
            raise AssertionError(f"fn_y2cov gave {tuple(h.shape)}, min {float(h.min())}")
        y2cov_ms = time_ms(lambda: fn_y2cov(labels))
        warm = [r["imgs_per_sec"] for r in log if r["step"] > RECIPE_STEPS // 3]
        ips = sum(warm) / len(warm)
        print(f"   ILI seconds per epoch: y2h CNN {stages['y2h_cnn']:.3f}, y2h MLP "
              f"{stages['y2h_mlp']:.4f}, y2cov CNN {stages['y2cov_cnn']:.3f}, y2cov MLP "
              f"{stages['y2cov_mlp']:.4f} on {card}", flush=True)
        print(f"   fn_y2cov for a micro-batch of {TRAIN_BATCH}: {y2cov_ms:.4f} ms; h mean "
              f"{float(h.mean()):.4f}, max {float(h.max()):.3f} on {card}", flush=True)
        print(f"   warm train {ips:.2f} images/s with use_Hy (steps {RECIPE_STEPS // 3 + 1}-"
              f"{RECIPE_STEPS}, batch {TRAIN_BATCH}, bf16) against {phase8_ips:.2f} in phase 8 "
              f"on {card}", flush=True)

        args = parse_opts([*argv, "--serve_milestone", str(RECIPE_STEPS), "--sample_timesteps",
                           str(RECIPE_SERVE_STEPS), "--sample_cond_scale", "1.5"])
        service = SamplerService(args, max_batch=SERVE_BATCH, warm=True, device=args.device)
        torch.testing.assert_close(service.diffusion.fn_y2cov(labels), h, rtol=0, atol=0)
        torch.cuda.synchronize()
        _reset_counts()
        batches, n_images, req_s = _serve_requests(service, ((SERVE_BATCH, 3),), 64)
        counts = _counts()
        expected = {"attn_block": ATTN_BLOCKS * RECIPE_SERVE_STEPS * batches,
                    **{k: 0 for k in (*LARGE, *RESNET, *NEW_KERNELS)}}
        served_ips = n_images / req_s
        print(f"   served {n_images} labels x {RECIPE_SERVE_STEPS} DDIM steps over HTTP from "
              f"milestone {RECIPE_STEPS}, embeddings from the cache: {served_ips:.2f} images/s "
              f"on {card}; launches {counts} (expected {expected})", flush=True)
        if counts != expected:
            raise AssertionError(f"serving launches {counts}, expected {expected}")
        empty = setting.parent / "no_embed_models"
        try:
            SamplerService(parse_opts(["--root_path", str(empty), *argv[2:]]), warm=False,
                           device=args.device)
        except FileNotFoundError as e:
            print(f"   a service without embed_models/ refused: {e}", flush=True)
        else:
            raise AssertionError("a service without embed_models/ did not raise")
        return {"ili_seconds_per_epoch": stages, "fn_y2cov_ms": y2cov_ms,
                "train_images_per_s": ips, "phase8_train_images_per_s": phase8_ips,
                "served_images_per_s": served_ips, "served_images": n_images,
                "serve_launches": counts, "card": card}

    return checks


# ------------------------------ the rest of main.py's training entry

MULTIDIM_STEPS = 20
MULTIDIM_ROWS = 64  # synthetic_power rows, all unique: the eval labels at --eval_mode 1
MULTIDIM_DIMS = 8
# phase 8's width, batch and dtype on Sliced-CCDM's synthetic multi-dim set
# (64x64, 1 channel): the sliced hard vicinity (3 projections, auto-set for
# 8 dims), label dims combined by cross attention; then every label row x 2
# images, 10 DDIM steps
MULTIDIM_COMMON = ["--data_name", "synthetic_power", "--label_dim", str(MULTIDIM_DIMS),
                   "--image_size", "64", "--num_channels", "1", "--model_channels", "64",
                   "--channel_mult", "1_2_2_4_8", "--train_amp", "--pred_objective", "pred_x0",
                   "--vicinity_type", "shv", "--num_projections", "0",
                   "--train_batch_size", str(TRAIN_BATCH), "--train_lr", "1e-4",
                   "--log_every", "5", "--seed", "0", "--dim_combination", "cross_attention",
                   "--eval_mode", "1", "--nfake_per_label", "2", "--sample_timesteps", "10"]
# (a): the resnet ILI y2h with phase 18's cut epochs over 8 dims
MULTIDIM_ARGV = [*MULTIDIM_COMMON, "--synthetic_n", str(MULTIDIM_ROWS),
                 "--niters", str(MULTIDIM_STEPS), "--save_every", str(MULTIDIM_STEPS),
                 "--y2h_embed_type", "resnet", "--epoch_cnn_embed", "2", "--epoch_net_y2h", "20"]
MULTIDIM_FORWARDS = MULTIDIM_ROWS * 10  # UNet forwards of its sampling
# (a'): the sinusoidal y2h, which depends on y with no training (at (a)'s
# cut the ILI MLP is constant in y), on 8 rows for 5 steps
ANALYTIC_STEPS = 5
ANALYTIC_ROWS = 8
ANALYTIC_ARGV = [*MULTIDIM_COMMON, "--synthetic_n", str(ANALYTIC_ROWS),
                 "--niters", str(ANALYTIC_STEPS), "--save_every", str(ANALYTIC_STEPS),
                 "--y2h_embed_type", "sinusoidal"]
ANALYTIC_FORWARDS = ANALYTIC_ROWS * 10
EMBED_TOL = 1e-4  # fn_y2h on the card against the CPU, f32 with TF32 off: rtol = atol
AUX_STEPS = 10
GIF_STEPS = 10           # min(--sample_timesteps, 50) DDIM steps of the trajectory
INTERP_LAMBDAS = 8
INTERP_T = 250           # min(T // 4, 250) at T 1000
# phase 8's run with the elastic aux loss (pred_noise) and both artifacts
AUX_ARGV = [*TRAIN_ARGV, "--pred_objective", "pred_noise", "--lambda_aux", "0.1",
            "--net_aux", "ResNet18", "--epoch_aux", "1", "--gif_trajectory", "--interpolation",
            "--niters", str(AUX_STEPS), "--save_every", str(AUX_STEPS), "--log_every", "1"]
AUX_FORWARDS = GIF_STEPS + INTERP_LAMBDAS * INTERP_T + EVAL_FORWARDS


@contextlib.contextmanager
def sliced_widths():
    """The label widths that reach the sliced vicinal weights, recorded."""
    from ccdm_tpu_torch.diffusion import gaussian

    widths, sliced = [], gaussian.sliced_batch_weights

    def spy(labels2d, *args, **kwargs):
        widths.append(int(labels2d.shape[1]))
        return sliced(labels2d, *args, **kwargs)

    gaussian.sliced_batch_weights = spy
    try:
        yield widths
    finally:
        gaussian.sliced_batch_weights = sliced


@contextlib.contextmanager
def attn_shapes():
    """The (B, N, C, dtype) of every launch of #1, recorded."""
    shapes, launch = set(), attn_block._launch

    def spy(x2d, *args, **kwargs):
        shapes.add((*x2d.shape, str(x2d.dtype).removeprefix("torch.")))
        return launch(x2d, *args, **kwargs)

    attn_block._launch = spy
    try:
        yield shapes
    finally:
        attn_block._launch = launch


def checked_in_phase_3(shapes: set) -> list:
    """The (B, N, C, dtype) launched, each asserted to be among those phase
    3 held #1 to its plain version at: bf16 at ATTN_BATCHES x CHECK_SHAPES,
    f32 at B BATCH x CHECK_SHAPES, B TRAIN_BATCH x FORWARD_SHAPES and
    BASE_F32_BATCHES x CELL200_SHAPES."""
    checked = ({(b, n, c, "bfloat16") for b in ATTN_BATCHES for n, c in CHECK_SHAPES}
               | {(BATCH, n, c, "float32") for n, c in CHECK_SHAPES}
               | {(TRAIN_BATCH, n, c, "float32") for n, c in FORWARD_SHAPES}
               | {(b, n, c, "float32") for b in BASE_F32_BATCHES for n, c in CELL200_SHAPES})
    if not shapes <= checked:
        raise AssertionError(f"#1 launched at (B, N, C, dtype) {sorted(shapes - checked)}, "
                             f"which phase 3 did not check against its plain version")
    return sorted(shapes)


@torch.no_grad()
def embedding_on_card(argv: list, rows: torch.Tensor, what: str) -> dict:
    """fn_y2h of a finished run, loaded from its embed_models/ on the card
    and on the CPU, on the run's label rows: the two at EMBED_TOL, and the
    least distance between the embeddings of two rows."""
    from ccdm_tpu_torch import main as port_main
    from ccdm_tpu_torch.embedding.resolve import build_label_embedding

    args = parse_opts(argv)
    setting = str(Path(port_main.results_folder(args)).parent)
    on = {dev: build_label_embedding(args, setting, bundle=None, require_cached=True,
                                     device=dev)[0] for dev in (args.device, "cpu")}
    got, want = on[args.device](rows), on["cpu"](rows.cpu())
    err = check_close(got.cpu(), want, EMBED_TOL, EMBED_TOL, f"{what} fn_y2h on the card")
    least = float(torch.cdist(got.float(), got.float()).fill_diagonal_(float("inf")).min())
    print(f"   {what}: fn_y2h on the card against the CPU on the {len(rows)} label rows, "
          f"max abs err {err:.3e} (rtol = atol = {EMBED_TOL}); least distance between two "
          f"rows' embeddings {least:.3e}", flush=True)
    return {"max_abs_err": err, "least_row_distance": least}


@contextlib.contextmanager
def artifact_passes(record: dict):
    """main.py's GIF and interpolation passes, each timed (host clock to a
    synchronize) with the launches of #1 it made."""
    from ccdm_tpu_torch import main as port_main

    saved = {name: getattr(port_main, name)
             for name in ("save_trajectory_gif", "save_interpolation")}

    def timed(name, fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            before, t0 = attn_block.fused_attn_block.launches, time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            record[name] = {"seconds": time.perf_counter() - t0,
                            "attn_block": attn_block.fused_attn_block.launches - before}
            return out
        return run

    for name, fn in saved.items():
        setattr(port_main, name, timed(name, fn))
    try:
        yield record
    finally:
        for name, fn in saved.items():
            setattr(port_main, name, fn)


def gif_info(path: Path) -> dict:
    """Frame count, delays (ms) and loop count of a GIF89a, read block by
    block (the card's machine has no PIL)."""
    data = path.read_bytes()
    if data[:6] != b"GIF89a":
        raise AssertionError(f"{path.name} is not a GIF89a file")
    flags = data[10]
    pos = 13 + (3 << ((flags & 7) + 1) if flags & 0x80 else 0)
    frames, delays, loop = 0, [], None

    def skip_blocks(p):
        while data[p]:
            p += data[p] + 1
        return p + 1

    while data[pos] != 0x3B:
        if data[pos] == 0x21:
            label = data[pos + 1]
            if label == 0xF9:
                delays.append(10 * struct.unpack("<H", data[pos + 4:pos + 6])[0])
            if label == 0xFF and data[pos + 3:pos + 14] == b"NETSCAPE2.0":
                loop = struct.unpack("<H", data[pos + 16:pos + 18])[0]
            pos = skip_blocks(pos + 2)
        elif data[pos] == 0x2C:
            frames += 1
            local = data[pos + 9]
            pos += 10 + (3 << ((local & 7) + 1) if local & 0x80 else 0)
            pos = skip_blocks(pos + 1)  # the LZW minimum code size, then the data
        else:
            raise AssertionError(f"{path.name}: unknown block 0x{data[pos]:02x} at {pos}")
    return {"frames": frames, "delays_ms": sorted(set(delays)), "loop": loop}


def multidim_checks(card: str, phase8_ips: float, widths: list):
    """Phase 19 (a)'s own checks: the sliced path took labels of width 8,
    the index-keyed grids decode to images that are not constant, the
    combiner's weights were written; the warm rate."""
    from ccdm_tpu_torch import main as port_main

    def checks(trainer, argv, log) -> dict:
        args = parse_opts(argv)
        setting = Path(port_main.results_folder(args)).parent
        if sorted(set(widths)) != [MULTIDIM_DIMS] or len(widths) != MULTIDIM_STEPS:
            raise AssertionError(f"label widths at the sliced weights: {widths}")
        grids = sorted(Path(port_main.fake_data_folder(args, MULTIDIM_ROWS)).glob("sample_*.png"))
        names = [p.name for p in grids]
        if names != [f"sample_{i:05d}.png" for i in range(MULTIDIM_ROWS)]:
            raise AssertionError(f"grids {names}")
        stds = [float(read_png(p).std()) for p in grids]
        shapes = {read_png(p).shape for p in grids}
        if not all(v > 0 for v in stds) or shapes != {(66, 391, 1)}:
            raise AssertionError(f"grid shapes {shapes}, pixel std {stds}")
        combiner = setting / "embed_models" / "combiner-y2h_cross_attention_d128_n8_seed7.pt"
        if not combiner.is_file():
            raise AssertionError(f"no {combiner.name} in {sorted(combiner.parent.iterdir())}")
        warm = [r["imgs_per_sec"] for r in log if r["step"] > MULTIDIM_STEPS // 3]
        ips = sum(warm) / len(warm)
        stages = dict(ili.STAGE_SECONDS)
        embedding = embedding_on_card(argv, trainer.unique_labels, "(a) resnet ILI")
        print(f"   sliced weights got labels of width {MULTIDIM_DIMS} at all {len(widths)} "
              f"steps; {len(grids)} index-keyed grids (pixel std {min(stds):.2f} to "
              f"{max(stds):.2f}); {combiner.name} written", flush=True)
        print(f"   ILI seconds per epoch: y2h CNN {stages['y2h_cnn']:.3f}, y2h MLP "
              f"{stages['y2h_mlp']:.4f}; warm train {ips:.2f} images/s (steps "
              f"{MULTIDIM_STEPS // 3 + 1}-{MULTIDIM_STEPS}, batch {TRAIN_BATCH}, bf16, 1 "
              f"channel) against {phase8_ips:.2f} in phase 8 on {card}", flush=True)
        return {"label_widths": sorted(set(widths)), "grids": len(grids), "grid_std": stds,
                "ili_seconds_per_epoch": stages, "embedding": embedding,
                "train_images_per_s": ips, "phase8_train_images_per_s": phase8_ips,
                "card": card}

    return checks


def analytic_checks(widths: list):
    """Phase 19 (a')'s own checks: labels of width 8 at the sliced weights;
    fn_y2h on the card equal to the CPU's and different for every two label
    rows; the grids of every two rows different, though every row starts
    from the same seeded noise, so the labels reached the UNet's
    conditioning."""
    from ccdm_tpu_torch import main as port_main

    def checks(trainer, argv, log) -> dict:
        args = parse_opts(argv)
        if sorted(set(widths)) != [MULTIDIM_DIMS] or len(widths) != ANALYTIC_STEPS:
            raise AssertionError(f"label widths at the sliced weights: {widths}")
        setting = Path(port_main.results_folder(args)).parent
        combiner = setting / "embed_models" / (f"combiner-y2h_cross_attention_d128_n8_seed"
                                                f"{Y2H_SEED + COMBINER_SEED_OFFSET}.pt")
        if not combiner.is_file():
            raise AssertionError(f"no {combiner.name} in {sorted(combiner.parent.iterdir())}")
        embedding = embedding_on_card(argv, trainer.unique_labels, "(a') sinusoidal")
        if not embedding["least_row_distance"] > 1e-3:
            raise AssertionError(f"two label rows share an embedding: {embedding}")
        grids = sorted(Path(port_main.fake_data_folder(args, ANALYTIC_ROWS)).glob("sample_*.png"))
        pixels = [read_png(p) for p in grids]
        distinct = len({p.tobytes() for p in pixels})
        if len(grids) != ANALYTIC_ROWS or distinct != ANALYTIC_ROWS:
            raise AssertionError(f"{len(grids)} grids, {distinct} distinct")
        print(f"   {ANALYTIC_ROWS} index-keyed grids, every two different (pixel std "
              f"{min(float(p.std()) for p in pixels):.2f} to "
              f"{max(float(p.std()) for p in pixels):.2f})", flush=True)
        return {"embedding": embedding, "distinct_grids": distinct}

    return checks


def aux_checks(card: str, passes: dict):
    """Phase 19 (b)'s own checks: the aux cache, the aux term in the log,
    the GIF's frames, the interpolation's panels, and 10 launches of #1 per
    forward of both passes."""
    from ccdm_tpu_torch import main as port_main

    def checks(trainer, argv, log) -> dict:
        args = parse_opts(argv)
        results = Path(port_main.results_folder(args))
        cache = results.parent / "aux_models" / "model-aux_ResNet18_e1_seed0" / "state.pt"
        aux = [r.get("aux") for r in log]
        if not cache.is_file() or not all(v is not None and np.isfinite(v) for v in aux) \
                or not any(v > 0 for v in aux):
            raise AssertionError(f"aux cache {cache.is_file()}, aux terms {aux}")
        gif = gif_info(results / f"trajectory_niters{AUX_STEPS}.gif")
        if gif != {"frames": GIF_STEPS, "delays_ms": [100], "loop": 0}:
            raise AssertionError(f"trajectory GIF {gif}")
        png = read_png(results / f"interpolation_niters{AUX_STEPS}.png")
        panels = [png[1:65, 1 + 65 * i:65 * (i + 1)] for i in range(INTERP_LAMBDAS)]
        stds = [float(p.std()) for p in panels]
        if png.shape != (66, 65 * INTERP_LAMBDAS + 1, 3) or not all(v > 0 for v in stds):
            raise AssertionError(f"interpolation grid {png.shape}, panel std {stds}")
        want = {"save_trajectory_gif": ATTN_BLOCKS * GIF_STEPS,
                "save_interpolation": ATTN_BLOCKS * INTERP_LAMBDAS * INTERP_T}
        got = {name: passes[name]["attn_block"] for name in want}
        if got != want:
            raise AssertionError(f"launches of #1 in the GIF and interpolation passes {got}, "
                                 f"expected {want}")
        aux_s = trainer.aux_info["apply"].seconds_per_epoch
        interp_s = passes["save_interpolation"]["seconds"]
        gif_s = passes["save_trajectory_gif"]["seconds"]
        print(f"   aux terms {[round(v, 5) for v in aux]}; ResNet18 aux net {aux_s:.3f} s per "
              f"epoch on {card}", flush=True)
        print(f"   trajectory GIF: {gif['frames']} frames, {gif_s:.2f} s; interpolation: "
              f"{INTERP_LAMBDAS} panels (pixel std {min(stds):.2f} to {max(stds):.2f}), "
              f"{INTERP_LAMBDAS * INTERP_T} forwards of B 1 in {interp_s:.2f} s on {card}; "
              f"launches of #1 {got}", flush=True)
        return {"aux": aux, "aux_seconds_per_epoch": aux_s, "gif": gif, "gif_seconds": gif_s,
                "interpolation_seconds": interp_s, "interpolation_panel_std": stds,
                "pass_launches": got, "card": card}

    return checks


# ------------------------------------------------------------ the eval protocol

EVAL_ANGLES = np.linspace(-79.6, 79.6, 100)  # signed, inside the loader's open (-80, 80)
EVAL_PER_ANGLE = 40                          # 4000 images of 64x64x3, ~49 MB of uint8
EVAL_STEPS = 20
EVAL_NFAKE = 4                               # one batch of 4 a label: CFG forwards of B 8
EVAL_SAMPLE_FORWARDS = len(EVAL_ANGLES) * 10  # 10 DDIM steps for each of the 100 labels
EVAL_FEATURE_IMAGES = 64
# AE features on the card against the CPU, f32 (the port sets TF32 off): rtol = atol.
# On an H100 they agree to ~2e-7; the same forward with cuDNN's TF32 on is
# ~8e-5 off, so 1e-5 tells the two apart where 1e-4 would not
EVAL_FEATURE_TOL = 1e-5
EVAL_RUN = Path(__file__).resolve().parent / "build" / "smoke_run"  # train_main_path's folder
# phase 8's UNet, batch and dtype on a SteeringAngle 64x64 bundle built in
# memory; then every raw label x 4 images at 10 DDIM steps, scored by the
# whole protocol with the eval backbones' epochs cut from 10 and 20 to 1
EVAL_ARGV = ["--data_name", "SteeringAngle", "--min_label", "-80", "--max_label", "80",
             "--image_size", "64", "--model_channels", "64", "--channel_mult", "1_2_2_4_8",
             "--train_amp", "--pred_objective", "pred_x0", "--vicinity_type", "hv",
             "--train_batch_size", str(TRAIN_BATCH), "--train_lr", "1e-4",
             "--niters", str(EVAL_STEPS), "--save_every", str(EVAL_STEPS), "--log_every", "5",
             "--seed", "0", "--eval_mode", "2", "--nfake_per_label", str(EVAL_NFAKE),
             "--samp_batch_size", str(EVAL_NFAKE), "--sample_timesteps", "10",
             "--comp_FID", "--FID_radius", "2", "--comp_prdc", "--comp_niqe",
             "--comp_intra_fid", "--knn_analysis", "--frequency_analysis", "--tsne_analysis",
             "--epochs_eval_ae", "1", "--epochs_eval_cnn", "1",
             "--eval_ckpt_path", str(EVAL_RUN)]


def render_steering_angle() -> tuple:
    """(images [4000, 3, 64, 64] uint8, signed labels): the repo's road
    renderer (examples/make_fixture_sa64.py, numpy only), 40 images for
    each of 100 angles, from a fixed seed."""
    import importlib.util

    path = Path(__file__).resolve().parent / "examples" / "make_fixture_sa64.py"
    spec = importlib.util.spec_from_file_location("make_fixture_sa64", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    rng = np.random.default_rng(2026)
    labels = np.repeat(EVAL_ANGLES, EVAL_PER_ANGLE)
    return np.stack([module.render_road(float(a), 64, rng) for a in labels]), labels


@contextlib.contextmanager
def eval_in_memory(record: dict):
    """The SteeringAngle h5 read replaced by the rendered arrays (the
    port's steeringangle_from_arrays builds the bundle); run_ccgm_eval and
    the NIQE fit wrapped to record their arguments and seconds."""
    from ccdm_tpu_torch.data import datasets
    from ccdm_tpu_torch.eval import niqe, protocol

    arrays = render_steering_angle()
    read, run, fit = datasets.read_steeringangle, protocol.run_ccgm_eval, niqe.fit_niqe_model

    def run_spy(*args, **kwargs):
        t0 = time.perf_counter()
        out = run(*args, **kwargs)
        record["call"], record["protocol_s"] = args, time.perf_counter() - t0
        return out

    def fit_spy(*args, **kwargs):
        t0 = time.perf_counter()
        out = fit(*args, **kwargs)
        record["niqe_fit_s"] = time.perf_counter() - t0
        return out

    datasets.read_steeringangle = lambda data_path, image_size: arrays
    protocol.run_ccgm_eval, niqe.fit_niqe_model = run_spy, fit_spy
    record["run_ccgm_eval"] = run
    try:
        yield record
    finally:
        datasets.read_steeringangle, protocol.run_ccgm_eval, niqe.fit_niqe_model = read, run, fit


@contextlib.contextmanager
def pytorch_precision_defaults():
    """PyTorch's own TF32 defaults (cuDNN may use it, cuBLAS may not), the
    setting a user's run has, in place of this script's TF32 off."""
    before = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = before


def _finite_metrics(result: dict) -> dict:
    """Every metric of a run_ccgm_eval result, flattened; raises on one
    that is not finite."""
    flat = {}
    for name in ("sfid", "ls", "diversity", "niqe", "niqe_ctrl", "ifid"):
        flat[f"{name}_mean"], flat[f"{name}_std"] = result[name]
    flat["fid"] = result["fid"]
    for name in ("prdc", "prdc_ctrl"):
        flat.update({f"{name}_{k}": v for k, v in result[name].items()})
    bad = {k: v for k, v in flat.items() if not np.isfinite(v)}
    if bad:
        raise AssertionError(f"metrics not finite: {bad}")
    return flat


def images_per_s(fn, images: np.ndarray) -> float:
    """fn over the images (a warm-up on 200 first), host clock to the
    returned numpy array."""
    fn(images[:200])
    t0 = time.perf_counter()
    fn(images)
    return len(images) / (time.perf_counter() - t0)


def eval_checks(card: str, record: dict):
    """Phase 20's own checks: every metric finite; the backbones' epochs,
    feature extraction rates and the NIQE fit timed; the AE features on
    the card against the CPU's (under PyTorch's TF32 defaults, so they
    hold only because the port turns TF32 off for its eval nets); a
    second run_ccgm_eval on the same fakes loads the pinned checkpoint and
    gives the same fingerprint, SFID, FID and LS bit for bit."""
    import argparse

    from ccdm_tpu_torch.eval import metrics
    from ccdm_tpu_torch.eval import train_backbones as tb

    def checks(trainer, argv, log) -> dict:
        result = trainer.eval_results
        args, bundle, fakes, flabels, setting, total_time = record["call"]
        if not torch.backends.cudnn.allow_tf32:
            raise AssertionError("phase 20 runs under PyTorch's TF32 defaults; the eval "
                                 "left cuDNN's TF32 off")
        flat = _finite_metrics(result)
        stages = dict(tb.STAGE_SECONDS)
        if sorted(stages) != ["ae", "cls", "reg"]:
            raise AssertionError(f"eval backbone stage times {stages}")
        lines = Path(result["eval_path"]).read_text()
        if f" Eval backbones: {result['fingerprint']}." not in lines:
            raise AssertionError(f"no fingerprint line in {result['eval_path']}")
        real = bundle.eval_images
        num_classes = min(49, len(np.unique(bundle.eval_labels_raw)))
        eval_dir = str(Path(args.eval_ckpt_path) / "eval_models")
        nets = tb.get_eval_models(bundle, eval_dir, num_classes, seed=args.seed,
                                  device=trainer.device)
        ae_ips = images_per_s(lambda x: metrics.extract_features(nets["fid"], x), real)
        resnet_ips = images_per_s(lambda x: metrics.extract_features(nets["div"], x), real)
        cpu_ae = tb.get_eval_models(bundle, eval_dir, num_classes, seed=args.seed,
                                    device="cpu")["fid"]
        probe = real[:EVAL_FEATURE_IMAGES]
        cpu_feats = torch.from_numpy(metrics.extract_features(cpu_ae, probe))
        feat_err = check_close(torch.from_numpy(metrics.extract_features(nets["fid"], probe)),
                               cpu_feats, EVAL_FEATURE_TOL, EVAL_FEATURE_TOL,
                               "AE features on the card against the CPU")
        # what the check guards against: the same forward with cuDNN's TF32
        # left on (outside the port's eval, which turns it off)
        with torch.no_grad():
            x = torch.from_numpy(probe).to(trainer.device).float() / 255.0 * 2.0 - 1.0
            tf32_err = float((nets["fid"](x).cpu() - cpu_feats).abs().max())
        # the reload: the same fakes, the pinned checkpoint, the window metrics
        light = argparse.Namespace(**{**vars(args), "comp_prdc": False, "comp_niqe": False,
                                      "comp_intra_fid": False, "knn_analysis": False,
                                      "frequency_analysis": False, "tsne_analysis": False})
        t0 = time.perf_counter()
        again = record["run_ccgm_eval"](light, bundle, fakes, flabels, setting, total_time)
        reload_s = time.perf_counter() - t0
        same = {k: (again[k], result[k]) for k in ("fingerprint", "sfid", "fid", "ls")}
        if any(a != b for a, b in same.values()):
            raise AssertionError(f"the reloaded protocol differs: {same}")
        analysis = sorted(p.name for p in (Path(setting) / "analysis").iterdir())
        print(f"   {len(fakes)} fakes of {len(np.unique(flabels))} signed labels "
              f"({flabels.min():.1f} to {flabels.max():.1f}) scored against {len(real)} real "
              f"images; backbones {result['fingerprint']}", flush=True)
        print("   metrics (all finite): " + ", ".join(f"{k} {v:.4f}" for k, v in flat.items()),
              flush=True)
        print(f"   seconds per epoch: AE {stages['ae']:.3f}, classifier {stages['cls']:.3f}, "
              f"regressor {stages['reg']:.3f}; feature extraction {ae_ips:.1f} images/s (AE "
              f"encoder), {resnet_ips:.1f} (ResNet34); NIQE fit {record['niqe_fit_s']:.2f} s; "
              f"the protocol {record['protocol_s']:.2f} s, its reload (window metrics only) "
              f"{reload_s:.2f} s on {card}", flush=True)
        print(f"   AE features of {EVAL_FEATURE_IMAGES} real images on the card against the "
              f"CPU, the phase under PyTorch's TF32 defaults: max abs err {feat_err:.3e} "
              f"(rtol = atol = {EVAL_FEATURE_TOL}; the same forward with TF32 left on: "
              f"{tf32_err:.3e}); the reload "
              f"read the same fingerprint, SFID, FID and LS bit for bit; analysis {analysis}",
              flush=True)
        return {"metrics": flat, "fingerprint": result["fingerprint"],
                "backbone_seconds_per_epoch": stages, "ae_features_images_per_s": ae_ips,
                "resnet34_features_images_per_s": resnet_ips,
                "niqe_fit_s": record["niqe_fit_s"], "protocol_s": record["protocol_s"],
                "reload_s": reload_s, "ae_features_max_abs_err": feat_err,
                "ae_features_tf32_max_abs_err": tf32_err,
                "sampling_s": total_time, "fakes": len(fakes), "card": card}

    return checks


# ----------------------------------------------- DMD2-M distillation

DMD_STEPS = 12
DMD_SAGAN_STEPS = 2
DMD_NFAKE = 4          # one-step images of each of the 100 eval labels
DMD_CENTERS = 10       # the student's sliding windows (phase 20: 157 at radius 2)
DMD_GEN_BATCH = 200
# SNGAN's D on the card against the CPU, full f32: rtol = atol. G's bound is
# five times that: its own f32 rounding is ~1.2e-5 from its f64 forward on
# the CPU alone (the running variances ~0.05-0.3 after the run amplify it
# through nine BatchNorms), so two f32 implementations meet ~2e-5 apart;
# the phase prints the CPU's f32 distance to f64 beside the check
DMD_TOL = {"G": 5e-5, "D": 1e-5}
# launches per DMD iteration (num_D_steps 2): the G step's teacher and fake
# UNet forwards without a gradient (#1 at all ten blocks each), then each
# D step's fake-UNet forward with a gradient (#1 at the eight blocks off
# the two-pass route, #2 + #3 at the two N-4096 blocks) and its backward
# (#4 + #5 there)
DMD_TWO_PASS = sum(attn_block.takes_two_pass(n, F) for n, _ in FORWARD_SHAPES)
DMD_PER_STEP = {"attn_block": 2 * len(FORWARD_SHAPES) + 2 * (len(FORWARD_SHAPES) - DMD_TWO_PASS),
                **{k: 2 * DMD_TWO_PASS for k in LARGE}}
assert DMD_PER_STEP["attn_block"] == 36 and DMD_TWO_PASS == 2


def dmd_argv(arch: str, steps: int) -> list:
    """dmd_main's flags: phase 20's SteeringAngle bundle, seed and setting
    folder (its milestone the teacher, f32 as JAX's dmd_main builds it, its
    pinned eval backbones), JAX's default GAN widths, batch TRAIN_BATCH,
    hinge, DiffAugment; the SNGAN run with grids and milestones inside the
    run, the protocol cut to DMD_CENTERS windows, both analyses; the SAGAN
    run under a setting of its own with phase 20's as the teacher's."""
    argv = ["--root_path", str(EVAL_RUN), "--data_name", "SteeringAngle", "--min_label", "-80",
            "--max_label", "80", "--image_size", "64", "--model_channels", "64",
            "--channel_mult", "1_2_2_4_8", "--seed", "0", "--teacher_milestone",
            str(EVAL_STEPS), "--gan_arch", arch, "--gene_ch", "64", "--disc_ch", "64",
            "--dim_z", "256", "--train_batch_size", str(TRAIN_BATCH), "--num_D_steps", "2",
            "--gan_DiffAugment", "--adv_loss_type", "hinge", "--niters", str(steps),
            "--nfake_per_label", str(DMD_NFAKE), "--samp_batch_size", str(DMD_NFAKE),
            "--eval_mode", "2"]
    if arch == "sngan":
        return argv + ["--save_every", str(steps // 2), "--sample_every", str(steps // 2),
                       "--comp_FID", "--FID_radius", "2", "--FID_num_centers", str(DMD_CENTERS),
                       "--eval_ckpt_path", str(EVAL_RUN), "--interpolation", "--sefa"]
    # SAGAN in a setting folder of its own, the teacher's named
    return argv + ["--save_every", str(10 * steps), "--sample_every", str(10 * steps),
                   "--setting_name", "Setup_SAGAN", "--teacher_setting_name", "Setup1"]


@contextlib.contextmanager
def dmd_records():
    """dmd_main's h5 write replaced by a record of each label's images (the
    card's machine has no h5py); the trainer's steps wrapped to record
    their losses."""
    from ccdm_tpu_torch import dmd_main
    from ccdm_tpu_torch.training.dmd import DMD2Trainer

    record = {"dumps": [], "g": [], "d": []}
    write, g_step, d_step = dmd_main.write_dump, DMD2Trainer.g_step, DMD2Trainer.d_step

    def g_spy(self, *args, **kwargs):
        out = g_step(self, *args, **kwargs)
        record["g"].append([float(v) for v in out])
        return out

    def d_spy(self, *args, **kwargs):
        out = d_step(self, *args, **kwargs)
        record["d"].append([float(v) for v in out])
        return out

    dmd_main.write_dump = lambda path, images, labels: record["dumps"].append(
        (Path(path).name, images, labels))
    DMD2Trainer.g_step, DMD2Trainer.d_step = g_spy, d_spy
    try:
        yield record
    finally:
        dmd_main.write_dump = write
        DMD2Trainer.g_step, DMD2Trainer.d_step = g_step, d_step


def dmd_run(device, arch: str, steps: int) -> tuple:
    """dmd_main in process: (trainer, launch counts, the step and dump
    records, seconds); the launch counts must be DMD_PER_STEP x steps and
    none of the rest, every loss finite."""
    from ccdm_tpu_torch import dmd_main

    expected = {**{k: v * steps for k, v in DMD_PER_STEP.items()},
                **{k: 0 for k in (*RESNET, *NEW_KERNELS)}}
    with dmd_records() as record:
        t0 = time.perf_counter()
        _reset_counts()
        trainer = dmd_main.main(["--device", str(device), *dmd_argv(arch, steps)])
        torch.cuda.synchronize()
        counts = _counts()
        seconds = time.perf_counter() - t0
    losses = record["g"] + record["d"]
    print(f"   {arch}: {steps} iterations of batch {TRAIN_BATCH} in {seconds:.1f} s; G losses "
          f"{[round(g[0], 4) for g in record['g']]}, D losses "
          f"{[round(d[0], 4) for d in record['d']]}; launches {counts} (expected {expected})",
          flush=True)
    if counts != expected:
        raise AssertionError(f"DMD launches {counts}, expected {expected}")
    if (len(record["g"]), len(record["d"])) != (steps, 2 * steps) \
            or not np.isfinite(losses).all():
        raise AssertionError(f"DMD losses {record['g']}, {record['d']}")
    return trainer, counts, record, seconds


@torch.no_grad()
def gan_on_card_vs_cpu(netG, netD, z_dim: int, fn_y2h, device, seed: int = 7,
                       nets=("G", "D")) -> dict:
    """SNGAN's G and D (eval mode, which stores nothing; `nets` names which)
    on the card in full f32 against copies on the CPU, on the same z,
    labels and images, each at DMD_TOL; beside each, the CPU's own f32
    forward against its f64 one."""
    from ccdm_tpu_torch.utils.device import full_f32

    g = torch.Generator().manual_seed(seed)
    z = torch.randn(8, z_dim, generator=g)
    y = fn_y2h(torch.linspace(0.05, 0.95, 8, device=device)[:, None]).cpu()
    x = torch.rand(8, 3, 64, 64, generator=g) * 2 - 1
    out = {}
    for name, net, args in (("G", netG, (z, y)), ("D", netD, (x, y))):
        if name not in nets:
            continue
        cpu = copy.deepcopy(net).cpu()
        with full_f32():
            got = net(*(a.to(device) for a in args), train=False).cpu()
        want = cpu(*args, train=False)
        tol = DMD_TOL[name]
        out[name] = check_close(got, want, tol, tol, f"SNGAN {name} on the card against the CPU")
        # the largest share of its element's bound atol + rtol |want| an error takes
        out[f"{name}_bound_share"] = float(((got - want).abs() / (tol + tol * want.abs())).max())
        f64 = cpu.double()(*(a.double() for a in args), train=False)
        out[f"{name}_cpu_f32_vs_f64"] = float((want.double() - f64).abs().max())
    return out


def dmd_main_path(device, card: str, eval_run: dict) -> dict:
    """Phase 21: dmd_main on phase 20's setting folder (SNGAN, then SAGAN),
    its artifacts, metrics and times, and serve_dmd's GeneratorService
    over HTTP; deletes the run folder after."""
    from ccdm_tpu_torch import dmd_main
    from ccdm_tpu_torch.serve import GeneratorService

    t_phase = time.perf_counter()
    try:
        args = dmd_main.parse_opts_dmd(dmd_argv("sngan", DMD_STEPS))
        initial = dmd_main.build_gan(args, 3, 64)[0].state_dict()
        with attn_shapes() as shapes, eval_in_memory({}) as evals:
            trainer, counts, record, run_s = dmd_run(device, "sngan", DMD_STEPS)
            sagan, sagan_counts, sagan_record, sagan_s = dmd_run(device, "sagan",
                                                                 DMD_SAGAN_STEPS)
        attn = checked_in_phase_3(shapes)
        if {s[3] for s in attn} != {"float32"}:
            raise AssertionError(f"#1 launched at {attn}: the DMD UNets run in f32")
        moved = max(float((p.detach().cpu() - initial[name]).abs().max())
                    for name, p in trainer.netG.named_parameters())
        dumps = record["dumps"]
        images = np.stack([d[1] for d in dumps])
        if (len(dumps) != len(EVAL_ANGLES) or images.dtype != np.uint8
                or images.shape[1:] != (DMD_NFAKE, 64, 64, 3) or images.std() == 0
                or len(sagan_record["dumps"]) != len(EVAL_ANGLES) or not moved > 0):
            raise AssertionError(f"{len(dumps)} label dumps {images.dtype} {images.shape}, "
                                 f"std {images.std()}; netG moved {moved}")
        results = Path(dmd_main.dmd_results_folder(args))
        pngs = [results / f"sample_{DMD_STEPS // 2}.png", results / f"sample_{DMD_STEPS}.png",
                *map(Path, trainer.analysis)]
        stds = [float(read_png(p).std()) for p in pngs]
        if len(trainer.analysis) != 2 or not all(v > 0 for v in stds):
            raise AssertionError(f"grids and analysis PNGs {pngs}: pixel std {stds}")
        result = trainer.eval_results
        flat = {"fid": result["fid"]}
        for name in ("sfid", "ls", "diversity"):
            flat[f"{name}_mean"], flat[f"{name}_std"] = result[name]
        if not np.isfinite(list(flat.values())).all():
            raise AssertionError(f"student metrics not finite: {flat}")
        if result["fingerprint"] != eval_run["fingerprint"]:
            raise AssertionError(f"the student was scored under {result['fingerprint']}, "
                                 f"phase 20 under {eval_run['fingerprint']}")
        print(f"   {len(dumps)} labels x {DMD_NFAKE} one-step images (uint8, pixel std "
              f"{images.std():.2f}); netG moved by up to {moved:.3e}; grids and analysis "
              f"{[p.name for p in pngs]} (pixel std {[round(v, 2) for v in stds]})", flush=True)
        print(f"   student metrics under {result['fingerprint']} (phase 20's), "
              f"{DMD_CENTERS} windows: " + ", ".join(f"{k} {v:.4f}" for k, v in flat.items())
              + f"; the protocol {evals['protocol_s']:.2f} s on {card}", flush=True)
        parity = gan_on_card_vs_cpu(trainer.netG, trainer.netD, trainer.cfg.z_dim,
                                    trainer.fn_y2h, trainer.device)
        print(f"   SNGAN on the card against the CPU (full f32, eval mode): max abs err G "
              f"{parity['G']:.3e}, D {parity['D']:.3e} (rtol = atol = {DMD_TOL['G']} and "
              f"{DMD_TOL['D']}; the largest share of an element's bound G "
              f"{parity['G_bound_share']:.3f}, D {parity['D_bound_share']:.3f}); the CPU's f32 "
              f"against its f64: G {parity['G_cpu_f32_vs_f64']:.3e}, D "
              f"{parity['D_cpu_f32_vs_f64']:.3e}", flush=True)

        # the steps and the one-step generator, timed after the run's warm-up
        gen = torch.Generator(device=device).manual_seed(3)
        g_ms = time_ms(lambda: trainer.g_step(gen), reps=5, warmup=1)
        d_ms = time_ms(lambda: trainer.d_step(gen), reps=5, warmup=1)
        z = torch.randn(DMD_GEN_BATCH, args.dim_z, generator=gen, device=device)
        y = torch.linspace(0.0, 1.0, DMD_GEN_BATCH, device=device)
        imgs = trainer.generate(y, z)
        if imgs.shape != (DMD_GEN_BATCH, 64, 64, 3) or not bool(torch.isfinite(imgs).all()):
            raise AssertionError(f"the one-step generator gave {tuple(imgs.shape)}, "
                                 "not all finite")
        gen_ms = time_ms(lambda: trainer.generate(y, z), reps=20)
        gen_ips = DMD_GEN_BATCH / gen_ms * 1e3

        serve_args = dmd_main.parse_opts_dmd([*dmd_argv("sngan", DMD_STEPS), "--device",
                                              str(device), "--serve_milestone", str(DMD_STEPS)])
        service = GeneratorService(serve_args, max_batch=SERVE_BATCH, warm=True,
                                   device=str(device))
        torch.cuda.synchronize()
        _reset_counts()
        batches, n_images, req_s = _serve_requests(
            service, ((5, 0), (40, 1)), 64, refused=({"labels": [0.5], "cond_scale": 1.5},))
        serve_counts = _counts()
        if any(serve_counts.values()):
            raise AssertionError(f"serving the one-step student launched {serve_counts}")
        served_ips = n_images / req_s
        phase_s = time.perf_counter() - t_phase
        print(f"   G step {g_ms:.2f} ms, D step {d_ms:.2f} ms (f32, batch {TRAIN_BATCH}, "
              f"events); one-step generator {gen_ips:.1f} images/s at batch {DMD_GEN_BATCH} "
              f"(events); served {n_images} images in {batches} batches of {SERVE_BATCH} over "
              f"HTTP: {served_ips:.1f} images/s (host clock), cond_scale refused with 400, no "
              f"kernel launched; SAGAN {DMD_SAGAN_STEPS} iterations {sagan_s:.1f} s; the phase "
              f"{phase_s:.1f} s on {card}", flush=True)
        return {"launches": counts, "launches_sagan": sagan_counts, "steps": DMD_STEPS,
                "attn_shapes": attn, "g_losses": record["g"], "d_losses": record["d"],
                "sagan_g_losses": sagan_record["g"], "sagan_d_losses": sagan_record["d"],
                "metrics": flat, "fingerprint": result["fingerprint"],
                "protocol_s": evals["protocol_s"], "windows": DMD_CENTERS,
                "on_card_vs_cpu_max_abs_err": parity, "g_step_ms": g_ms, "d_step_ms": d_ms,
                "onestep_images_per_s": gen_ips, "served_images_per_s": served_ips,
                "served_images": n_images, "run_s": run_s, "sagan_run_s": sagan_s,
                "phase_s": phase_s, "card": card}
    finally:
        shutil.rmtree(EVAL_RUN, ignore_errors=True)


# ------------------------------------------- the ADM and ViT denoisers

ADM_STEPS = 20
VIT_STEPS = 5
VIT_BATCH = 32
VIT_SAMPLE_STEPS = 5  # DDIM steps of the ViT's sampling after training (ADM: 10)
ARCH_SERVE_STEPS = {"adm": 25, "vit": 5}
# JAX's default ADM widths with attention at ds 4 and 8 (16x16 and 8x8), so
# that the down and up paths attend and not only mid_attn
ADM_ARGV = [*TRAIN_ARGV, "--architecture", "adm", "--channel_mult", "1_2_4_8",
            "--num_res_blocks", "2", "--num_groups", "8", "--num_heads", "4",
            "--attention_resolutions", "4_8", "--niters", str(ADM_STEPS),
            "--save_every", str(ADM_STEPS), "--log_every", "1"]
# the flagship's widths: width 64 x 8 = 512, 8 blocks over 4096 tokens
VIT_ARGV = [*TRAIN_ARGV, "--architecture", "vit", "--num_heads", "4",
            "--train_batch_size", str(VIT_BATCH), "--niters", str(VIT_STEPS),
            "--save_every", str(VIT_STEPS), "--log_every", "1",
            "--sample_timesteps", str(VIT_SAMPLE_STEPS)]
ARCH_TOL = 1e-4  # the card's f32 EMA forward against the CPU's: rtol = atol
ARCH_CPU_ROWS = {"adm": 2, "vit": 1}
VIT_CPU_BLOCKS = 2  # the ViT cut for the CPU side of the comparison


@contextlib.contextmanager
def step_peaks():
    """torch.cuda.max_memory_allocated (GiB) of every train step, recorded
    around Trainer.train_step."""
    from ccdm_tpu_torch.training.trainer import Trainer

    peaks, step = [], Trainer.train_step

    def recorded(self, *args, **kwargs):
        torch.cuda.reset_peak_memory_stats()
        loss = step(self, *args, **kwargs)
        peaks.append(torch.cuda.max_memory_allocated() / 2 ** 30)
        return loss

    Trainer.train_step = recorded
    try:
        yield peaks
    finally:
        Trainer.train_step = step


def arch_model_inputs(rows: int, device, seed: int = 9) -> list:
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(rows, 64, 64, 3, generator=g)
    t = torch.tensor([10, 700][:rows])
    emb = torch.rand(rows, 128, generator=g) * 2 - 1
    keep = torch.tensor([True, False][:rows])
    return [a.to(device) for a in (x, t, emb, keep)]


@torch.no_grad()
def ema_card_vs_cpu(arch: str, argv: list, steps: int) -> float:
    """The milestone's EMA weights in an f32 model (no --train_amp) on the
    card and on the CPU, one eval forward on the same inputs: the max abs
    difference, within ARCH_TOL. The ViT is cut to its first
    VIT_CPU_BLOCKS blocks so that the CPU side stays within seconds."""
    from ccdm_tpu_torch import main as port_main
    from ccdm_tpu_torch.models.vit import ViT
    from ccdm_tpu_torch.opts import parse_channel_mult
    from ccdm_tpu_torch.serve import ema_model_from_milestone

    args = parse_opts([a for a in argv if a != "--train_amp"])
    model = ema_model_from_milestone(port_main.build_model(args, 64, 3),
                                     port_main.results_folder(args), steps)
    if arch == "vit":
        cut = ViT(dim=args.model_channels, dim_mults=parse_channel_mult(args.channel_mult),
                  in_channels=3, attn_heads=args.num_heads, num_blocks=VIT_CPU_BLOCKS)
        kept = {f"block_{i}." for i in range(VIT_CPU_BLOCKS)}
        cut.load_state_dict({k: v for k, v in model.state_dict().items()
                             if not k.startswith("block_") or k[:k.index(".") + 1] in kept})
        model = cut
    model.eval()
    rows = ARCH_CPU_ROWS[arch]
    want = copy.deepcopy(model).cpu()(*arch_model_inputs(rows, "cpu"))
    card = model.to(args.device, memory_format=torch.channels_last)
    got = card(*arch_model_inputs(rows, args.device))
    return check_close(got.cpu(), want, ARCH_TOL, ARCH_TOL,
                       f"{arch} EMA forward, card against CPU (f32, B {rows})")


def vit_attention_kernels(device) -> list:
    """The names of the card's attention kernels in one f32 forward and
    backward of the cut ViT (B 1): the SDPA backend that ran, by
    torch.profiler."""
    from ccdm_tpu_torch.models.vit import ViT

    model = ViT(dim=64, dim_mults=(1, 2, 2, 4, 8), in_channels=3, attn_heads=4,
                num_blocks=VIT_CPU_BLOCKS).to(device, memory_format=torch.channels_last)
    inputs = arch_model_inputs(1, device)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        model(*inputs, train=True).square().mean().backward()
        torch.cuda.synchronize()
    names = sorted({e.key for e in prof.key_averages() if e.self_device_time_total > 0
                    and ("fmha" in e.key or "attention" in e.key.lower())})
    if not any("fmha" in n or "efficient" in n.lower() for n in names):
        raise AssertionError(f"no memory-efficient attention kernel ran: {names}")
    return names


def arch_checks(card: str, arch: str, steps: int, batch: int, peaks: list):
    """The phase's checks of one denoiser's run: the state took every
    step, the weights moved (ADM's frozen null embedding did not), the
    sampling's grids decode to images that are not constant, the
    milestone serves over HTTP (ADM: a second service with
    --samp_precast_bf16), the EMA forward on the card against the CPU's;
    warm train images/s, ms per sampling step, served images/s and each
    train step's peak memory. The launch counts, read by train_main_path
    after training, start again at 0 here and are read after the last
    forward on the card: every one must still be 0."""
    from ccdm_tpu_torch import main as port_main

    def checks(trainer, argv, log) -> dict:
        _reset_counts()
        args = parse_opts(argv)
        state = trainer.state
        fresh = port_main.build_model(args, 64, 3).state_dict()
        named = dict(state.model.named_parameters())
        moved = max(float((p.detach().cpu() - fresh[k]).abs().max()) for k, p in named.items())
        if not moved > 0 or state.step != steps or state.ema_step != steps:
            raise AssertionError(f"{arch}: params moved {moved}, step {state.step}, "
                                 f"ema_step {state.ema_step}")
        if arch == "adm":
            for m in (state.model, state.ema_model):
                if not torch.equal(m.null_classes_emb.cpu(), fresh["null_classes_emb"]):
                    raise AssertionError("ADM's frozen null embedding moved")
        grids = sorted(Path(port_main.fake_data_folder(args, 2)).glob("sample_*.png"))
        stds = [float(read_png(p).std()) for p in grids]
        if len(grids) != 2 or not all(v > 0 for v in stds):
            raise AssertionError(f"{arch}: grids {grids}, pixel std {stds}")
        warm = [r["imgs_per_sec"] for r in log if r["step"] > max(1, steps // 3)]
        ips = sum(warm) / len(warm)
        served = {}
        for precast in ((False, True) if arch == "adm" else (False,)):
            sargs = parse_opts([*argv, "--serve_milestone", str(steps), "--sample_timesteps",
                                str(ARCH_SERVE_STEPS[arch]),
                                *(["--samp_precast_bf16"] if precast else [])])
            service = SamplerService(sargs, max_batch=4, warm=False, device=args.device)
            if type(service.diffusion.model).__name__ != type(state.model).__name__:
                raise AssertionError(f"the service built {type(service.diffusion.model)}")
            batches, n_images, req_s = _serve_requests(service, ((4, int(precast)),), 64)
            served["precast_bf16" if precast else "f32_weights"] = {
                "images_per_s": n_images / req_s,
                "ms_per_step": req_s * 1e3 / (batches * ARCH_SERVE_STEPS[arch]),
                "cfg_rows": 2 * service.max_batch}
            del service
        parity = ema_card_vs_cpu(arch, argv, steps)
        out = {"params_m": sum(p.numel() for p in named.values()) / 1e6, "moved": moved,
               "grid_std": stds, "train_images_per_s": ips, "step_peak_gib": list(peaks),
               "served": served, "ema_card_vs_cpu_max_abs_err": parity}
        if arch == "vit":
            out["sdpa_kernels"] = vit_attention_kernels(args.device)
        torch.cuda.synchronize()
        out["serve_launches"] = _counts()
        if any(out["serve_launches"].values()):
            raise AssertionError(f"{arch}: serving and the card's forwards launched a kernel: "
                                 f"{out['serve_launches']}")
        print(f"   {arch}: {out['params_m']:.2f} M parameters; warm train {ips:.2f} images/s "
              f"(batch {batch}); peak memory per step {[round(v, 2) for v in peaks]} GiB; "
              f"served {json.dumps(served)}; grids {[p.name for p in grids]} (pixel std "
              f"{[round(v, 2) for v in stds]}); EMA forward card vs CPU max abs err "
              f"{parity:.3e}{'; SDPA kernels ' + str(out['sdpa_kernels']) if arch == 'vit' else ''}"
              f" on {card}", flush=True)
        return out

    return checks


def denoisers_main_path(device, card: str) -> dict:
    """Phase 22: `python -m ccdm_tpu_torch.main --architecture adm`, then
    `vit`, each trained, sampled, served and held against the CPU
    (arch_checks). No kernel of #1-#12 launches: each architecture's
    training and sampling (train_main_path) and its serving and card
    forwards (arch_checks) are counted from 0 and read apart."""
    t_phase = time.perf_counter()
    zero = {name: 0 for name in _counters()}
    out = {}
    for arch, argv, steps, batch in (("adm", ADM_ARGV, ADM_STEPS, TRAIN_BATCH),
                                     ("vit", VIT_ARGV, VIT_STEPS, VIT_BATCH)):
        t0 = time.perf_counter()
        with step_peaks() as peaks:
            out[arch] = train_main_path(device, card, argv, steps, zero, False,
                                        arch_checks(card, arch, steps, batch, peaks))
        out[arch]["run_s"] = time.perf_counter() - t0
        if out[arch]["launches"] != zero or out[arch]["serve_launches"] != zero:
            raise AssertionError(f"{arch} launched a kernel: {out[arch]['launches']}, "
                                 f"{out[arch]['serve_launches']}")
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"   no kernel of #1-#12 launched in the ADM's or the ViT's training, sampling, "
          f"serving or card forwards; ADM {out['adm']['run_s']:.1f} s, ViT "
          f"{out['vit']['run_s']:.1f} s, the phase {out['phase_s']:.1f} s on {card}", flush=True)
    return out


# ------------------------------------------- the class-conditional and CcGAN baselines

BASE_GAN_STEPS = 20     # CcGAN (in two calls of 10, the second resuming) and StudioGAN D2D-CE
BASE_SHORT_STEPS = 2    # SAGAN soft-vicinity CcGAN and StudioGAN ADC
BASE_DIFF_STEPS = 20    # the class UNet's training steps (cfg, admg)
BASE_CLASSES, BASE_PER_CLASS = 10, 4
BASE_FAKES = BASE_CLASSES * BASE_PER_CLASS
BASE_SAMPLE_STEPS = 250  # classgan_main's default --sample_timesteps
BASE_TIMED_STEPS = 5     # sampling steps of the timed CFG and guided calls
# classgan_main's default --samp_batch_size 50 over the 40 fakes: one CFG
# chunk of 40 (2B = 80 rows a forward) and one guided batch of 40; the class
# UNet is f32 (JAX's classgan_main builds it at the Unet's default dtype)
CFG_ROWS = 2 * min(50, BASE_FAKES)
ADMG_BATCH = min(50, BASE_FAKES)
BASE_F32_BATCHES = (CFG_ROWS, ADMG_BATCH)
BASE_TRAIN_BATCH = 64
# launches per training step of the class UNet (64x64, dim 32, 1_2_2_4): #1
# at the blocks off the two-pass route, #2-#5 at the two N-4096 blocks;
# every sampling forward runs #1 at all eight
BASE_TWO_PASS = sum(attn_block.takes_two_pass(n, F) for n, _ in CELL200_SHAPES)
BASE_PER_STEP = {"attn_block": len(CELL200_SHAPES) - BASE_TWO_PASS,
                 **{k: BASE_TWO_PASS for k in LARGE}}
BASE_PER_FORWARD = len(CELL200_SHAPES)
assert BASE_PER_STEP["attn_block"] == 6 and BASE_TWO_PASS == 2 and BASE_PER_FORWARD == 8
GRAD_TOL = 1e-4  # the classifier gradient, card against CPU: of its largest |g|
# the f32 gradient, card against CPU, each with its own timestep embedding:
# a sanity bound on the L2 distance (scripts/classifier_grad_conditioning.py
# reads ~8e-3 on the CPU alone between an f32 and an f64 embedding)
GRAD_L2_SANITY = 5e-2
BASE_COMMON = ["--data_name", "synthetic", "--image_size", "64", "--num_channels", "3",
               "--seed", "0"]
# (a) CcGAN at JAX's default SNGAN widths with Dual-NDA from iteration 10,
# the resnet ILI y2h at phase 18's cut epochs; 2 eval labels x 4 images
CCGAN_ARGV = [*BASE_COMMON, "--gan_arch", "sngan", "--gene_ch", "64", "--disc_ch", "64",
              "--dim_gan", "256", "--batch_size_disc", "64", "--batch_size_gene", "64",
              "--num_D_steps", "2", "--loss_type", "hinge", "--threshold_type", "hard",
              "--gan_DiffAugment", "--nda_a", "0.8", "--nda_b", "0.1", "--nda_c", "0.1",
              "--nda_start_iter", str(BASE_GAN_STEPS // 2), "--y2h_embed_type", "resnet",
              "--epoch_cnn_embed", "2", "--epoch_net_y2h", "20",
              "--visualize_freq", str(BASE_GAN_STEPS // 2),
              "--save_niters_freq", str(BASE_GAN_STEPS // 2),
              "--log_every", "1", "--eval_mode", "4", "--FID_num_centers", "2",
              "--nfake_per_label", "4", "--samp_batch_size", "4", "--dump_fake_data"]
# (a') SAGAN, the soft vicinity, the vanilla loss
SAGAN_ARGV = [*CCGAN_ARGV, "--gan_arch", "sagan", "--threshold_type", "soft", "--loss_type",
              "vanilla", "--nda_b", "0", "--nda_c", "0", "--niters", str(BASE_SHORT_STEPS)]
CLASSGAN_ARGV = [*BASE_COMMON, "--num_classes", str(BASE_CLASSES), "--nfake_per_class",
                 str(BASE_PER_CLASS), "--log_every", "1", "--dump_fake_data"]
# (b) StudioGAN at classgan_main's default widths and batch
STUDIOGAN_ARGV = [*CLASSGAN_ARGV, "--method", "studiogan", "--cond_loss", "d2dce", "--niters",
                  str(BASE_GAN_STEPS), "--visualize_freq", str(BASE_GAN_STEPS // 2),
                  "--save_niters_freq", str(BASE_GAN_STEPS // 2)]
ADC_ARGV = [*CLASSGAN_ARGV, "--method", "studiogan", "--cond_loss", "adc", "--niters",
            str(BASE_SHORT_STEPS), "--setting_name", "Setup_ADC"]
# (c), (d) the class UNet at classgan_main's default widths (32, 1_2_2_4),
# batch 64, T 1000, then 250 sampling steps
CFG_ARGV = [*CLASSGAN_ARGV, "--method", "cfg", "--niters", str(BASE_DIFF_STEPS)]
ADMG_ARGV = [*CLASSGAN_ARGV, "--method", "admg", "--niters", str(BASE_DIFF_STEPS),
             "--classifier_epochs", "1"]
BASE_RUN = Path(__file__).resolve().parent / "build" / "smoke_baselines"


@contextlib.contextmanager
def large_shapes():
    """The (B, N, C, dtype) of every launch of #2-#5, recorded."""
    shapes, inputs = set(), attn_block._large_inputs

    def spy(x2d, *args, **kwargs):
        shapes.add((*x2d.shape, str(x2d.dtype).removeprefix("torch.")))
        return inputs(x2d, *args, **kwargs)

    attn_block._large_inputs = spy
    try:
        yield shapes
    finally:
        attn_block._large_inputs = inputs


def checked_in_phase_6(shapes: set) -> list:
    """The (B, N, C, dtype) at which #2-#5 launched, each asserted to be
    among those phase 6 held them to their plain versions at (LARGE_CASES)."""
    checked = {(batch, n, c, str(dt).removeprefix("torch."))
               for n, c, batch, dtypes in LARGE_CASES for dt in dtypes}
    if not shapes <= checked:
        raise AssertionError(f"#2-#5 launched at (B, N, C, dtype) {sorted(shapes - checked)}, "
                             f"which phase 6 did not check against their plain versions")
    return sorted(shapes)


@contextlib.contextmanager
def baseline_records():
    """The entries' h5 writes replaced by records (the card's machine has
    no h5py), the GAN trainers' steps wrapped to record their losses."""
    from ccdm_tpu_torch import classgan_main, dmd_main
    from ccdm_tpu_torch.training.ccgan import CcGANTrainer
    from ccdm_tpu_torch.training.classgan import ClassGANTrainer

    record = {"dumps": [], "losses": []}
    saved = [(dmd_main, "write_dump"), (classgan_main, "write_fake_h5"),
             *[(cls, name) for cls in (CcGANTrainer, ClassGANTrainer)
               for name in ("d_step", "g_step")]]
    originals = [getattr(owner, name) for owner, name in saved]

    def stepped(step):
        def spy(self, *args, **kwargs):
            loss = step(self, *args, **kwargs)
            record["losses"].append(float(loss))
            return loss
        return spy

    dmd_main.write_dump = lambda path, images, labels: record["dumps"].append(
        (Path(path).name, images, labels))
    classgan_main.write_fake_h5 = lambda path, images, labels: record["dumps"].append(
        (Path(path).name, images, labels))
    for (owner, name), original in zip(saved[2:], originals[2:]):
        setattr(owner, name, stepped(original))
    try:
        yield record
    finally:
        for (owner, name), original in zip(saved, originals):
            setattr(owner, name, original)


def baseline_run(entry, argv: list, expected: dict, what: str) -> tuple:
    """One entry point in process from launch counts of 0: (its return,
    the counts, the record of dumps and losses, seconds); the counts must
    be `expected` (every kernel not named there 0), every loss finite, the
    dumps uint8 and not constant."""
    want = {name: expected.get(name, 0) for name in _counters()}
    with baseline_records() as record:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _reset_counts()
        out = entry.main(["--root_path", str(BASE_RUN), *argv])
        torch.cuda.synchronize()
        counts = _counts()
        seconds = time.perf_counter() - t0
    images = [d[1] for d in record["dumps"]]
    print(f"   {what}: {seconds:.1f} s; {len(record['losses'])} GAN step losses "
          f"{[round(v, 4) for v in record['losses'][:4]]}...; dumps "
          f"{[(d[0], d[1].shape) for d in record['dumps']]}; launches {counts}", flush=True)
    if counts != want:
        raise AssertionError(f"{what}: launches {counts}, expected {want}")
    if not np.isfinite(record["losses"]).all() or not images or any(
            im.dtype != np.uint8 or im.std() == 0 for im in images):
        raise AssertionError(f"{what}: losses {record['losses']}, dumps "
                             f"{[(d[0], d[1].dtype, float(d[1].std())) for d in record['dumps']]}")
    return out, counts, record, seconds


def _grids(folder: Path, names: list) -> list:
    stds = [float(read_png(folder / name).std()) for name in names]
    if not all(v > 0 for v in stds):
        raise AssertionError(f"grids {names} in {folder}: pixel std {stds}")
    return stds


def _train_log(folder: Path, steps: int) -> list:
    log = [json.loads(line) for line in open(folder / "train_log.jsonl")]
    if log[-1]["step"] != steps or not all(np.isfinite(
            [v for r in log for k, v in r.items() if k != "step"])):
        raise AssertionError(f"train log of {folder}: {log}")
    return log


def _moved(net, fresh: dict) -> float:
    return max(float((p.detach().cpu() - fresh[k]).abs().max())
               for k, p in net.named_parameters())


def ccgan_sub_runs(device, card: str) -> dict:
    """(a) and (a'): ccgan_main, SNGAN hard in two calls (the second
    resuming from the first's milestone), then SAGAN soft."""
    from ccdm_tpu_torch import ccgan_main
    from ccdm_tpu_torch.dmd_main import build_gan

    args = ccgan_main.parse_opts_ccgan(["--device", str(device), *CCGAN_ARGV])
    fresh_g = build_gan(args, 3, 64, dim_z=args.dim_gan)[0].state_dict()
    results = BASE_RUN / "output" / "synthetic_64" / "Setup_CcGAN" / "ccgan_results"
    half = BASE_GAN_STEPS // 2
    first, c1, r1, s1 = baseline_run(ccgan_main, ["--device", str(device), *CCGAN_ARGV,
                                                  "--niters", str(half)], {},
                                     f"(a) CcGAN SNGAN hard, iterations 1-{half}")
    trainer, c2, r2, s2 = baseline_run(
        ccgan_main, ["--device", str(device), *CCGAN_ARGV, "--niters", str(BASE_GAN_STEPS),
                     "--resume_niter", str(half)], {},
        f"(a) CcGAN resumed at {half}, iterations {half + 1}-{BASE_GAN_STEPS}")
    if first.step != half or trainer.step != BASE_GAN_STEPS or not trainer.uses_nda(half) \
            or first.uses_nda(half - 1):
        raise AssertionError(f"CcGAN steps {first.step}, {trainer.step}")
    log = _train_log(results, BASE_GAN_STEPS)
    dumps = r1["dumps"] + r2["dumps"]
    if len(dumps) != 4 or any(d[1].shape != (4, 64, 64, 3) for d in dumps):
        raise AssertionError(f"CcGAN dumps {[(d[0], d[1].shape) for d in dumps]}")
    grids = _grids(results, [f"sample_{half}.png", f"sample_{BASE_GAN_STEPS}.png"])
    moved = _moved(trainer.netG, fresh_g)
    if not moved > 0:
        raise AssertionError("CcGAN's netG did not move")
    parity = gan_on_card_vs_cpu(trainer.netG, trainer.netD, trainer.cfg.dim_gan,
                                trainer.fn_y2h, trainer.device, nets=("D",))
    gen = torch.Generator(device=device).manual_seed(5)
    iter_ms = time_ms(lambda: [trainer.d_step(True, gen), trainer.d_step(True, gen),
                               trainer.g_step(gen)], reps=5, warmup=1)
    sagan, c3, r3, s3 = baseline_run(ccgan_main, ["--device", str(device), *SAGAN_ARGV], {},
                                     "(a') CcGAN SAGAN soft vanilla")
    if sagan.step != BASE_SHORT_STEPS or type(sagan.netG).__name__ != "SAGANGenerator":
        raise AssertionError(f"SAGAN run: step {sagan.step}, {type(sagan.netG).__name__}")
    print(f"   (a) netG moved by up to {moved:.3e}; D losses of the log "
          f"{[round(r['d_loss'], 4) for r in log[::5]]}; grids (pixel std "
          f"{[round(v, 2) for v in grids]}); SNGAN D card vs CPU (full f32) max abs err "
          f"{parity['D']:.3e} (rtol = atol = {DMD_TOL['D']}); {iter_ms:.2f} ms an iteration "
          f"(2 D steps with Dual-NDA b and c, 1 G step, batch 64, events) on {card}",
          flush=True)
    return {"launches": [c1, c2, c3], "seconds": [s1, s2, s3], "moved": moved,
            "d_losses": [r["d_loss"] for r in log], "g_losses": [r["g_loss"] for r in log],
            "grid_std": grids, "D_card_vs_cpu": parity, "iteration_ms": iter_ms}


def studiogan_sub_runs(device, card: str) -> dict:
    """(b): classgan_main --method studiogan, D2D-CE then ADC."""
    from ccdm_tpu_torch import classgan_main

    results = BASE_RUN / "output" / "synthetic_64" / "Setup_ClassCond" / "studiogan_results"
    out, c1, r1, s1 = baseline_run(classgan_main, ["--device", str(device), *STUDIOGAN_ARGV],
                                   {}, "(b) StudioGAN D2D-CE")
    trainer = out["trainer"]
    log = _train_log(results, BASE_GAN_STEPS)
    grids = _grids(results, [f"sample_{BASE_GAN_STEPS // 2}.png",
                             f"sample_{BASE_GAN_STEPS}.png", "sample_studiogan.png"])
    if r1["dumps"][0][1].shape != (BASE_FAKES, 64, 64, 3) or trainer.step != BASE_GAN_STEPS:
        raise AssertionError(f"StudioGAN dump {r1['dumps'][0][1].shape}, step {trainer.step}")
    args = classgan_main.parse_opts_classgan(STUDIOGAN_ARGV)
    from ccdm_tpu_torch.models.sngan import SNGANGenerator

    fresh = SNGANGenerator(dim_embed=BASE_CLASSES, dim_z=args.dim_z, nc=3, img_size=64,
                           gene_ch=args.gene_ch, seed=args.seed).state_dict()
    moved = _moved(trainer.netG, fresh)
    gen = torch.Generator(device=device).manual_seed(6)
    iter_ms = time_ms(lambda: [trainer.d_step(gen), trainer.g_step(gen)], reps=5, warmup=1)
    adc, c2, r2, s2 = baseline_run(classgan_main, ["--device", str(device), *ADC_ARGV], {},
                                   "(b) StudioGAN ADC")
    if not moved > 0 or type(adc["trainer"].head).__name__ != "ADCHead":
        raise AssertionError(f"StudioGAN netG moved {moved}, head {adc['trainer'].head}")
    d_losses, g_losses = ([round(r[k], 4) for r in log[::5]] for k in ("d_loss", "g_loss"))
    print(f"   (b) netG moved by up to {moved:.3e}; losses d {d_losses}, g {g_losses}; grids "
          f"(pixel std "
          f"{[round(v, 2) for v in grids]}); {iter_ms:.2f} ms an iteration (1 D step with the "
          f"D2D-CE head, 1 G step, batch 64, events) on {card}", flush=True)
    return {"launches": [c1, c2], "seconds": [s1, s2], "moved": moved, "grid_std": grids,
            "d_losses": [r["d_loss"] for r in log], "g_losses": [r["g_loss"] for r in log],
            "iteration_ms": iter_ms}


def class_unet_checks(out: dict, method: str, card: str) -> dict:
    """The class UNet's run: the state took every step and moved, warm
    train images/s, the fakes and grid; its EMA forward on the card against
    the CPU (f32, ARCH_TOL)."""
    from ccdm_tpu_torch.models.unet import Unet

    trainer = out["trainer"]
    results = BASE_RUN / "output" / "synthetic_64" / "Setup_ClassCond" / f"{method}_results"
    log = _train_log(results, BASE_DIFF_STEPS)
    state = trainer.state
    fresh = Unet(dim=32, dim_mults=(1, 2, 2, 4), in_channels=3, seed=0).state_dict()
    moved = _moved(state.model, fresh)
    if not moved > 0 or state.step != BASE_DIFF_STEPS or out["fakes"].shape != (
            BASE_FAKES, 64, 64, 3):
        raise AssertionError(f"{method}: moved {moved}, step {state.step}, fakes "
                             f"{out['fakes'].shape}")
    grid = _grids(results, [f"sample_{method}.png"])
    warm = [r["imgs_per_sec"] for r in log if r["step"] > BASE_DIFF_STEPS // 4]
    ema = state.ema_model.eval()
    with torch.no_grad():
        want = copy.deepcopy(ema).cpu()(*arch_model_inputs(2, "cpu"))
        got = ema(*arch_model_inputs(2, trainer.device)).cpu()
    err = check_close(got, want, ARCH_TOL, ARCH_TOL, f"{method} class UNet EMA forward, card "
                      "against CPU (f32, B 2)")
    return {"moved": moved, "train_images_per_s": sum(warm) / len(warm), "grid_std": grid,
            "losses": [r["loss"] for r in log], "ema_card_vs_cpu_max_abs_err": err}


@contextlib.contextmanager
def cpu_timestep_embedding(dtype):
    """The NoisyClassifier's sinusoidal timestep embedding computed on the
    CPU (the port's function, f32) and moved to t's device in `dtype`."""
    from ccdm_tpu_torch.eval import backbones

    embed = backbones.sinusoidal_pos_emb
    backbones.sinusoidal_pos_emb = lambda t, dim: embed(t.cpu(), dim).to(t.device, dtype)
    try:
        yield
    finally:
        backbones.sinusoidal_pos_emb = embed


def classifier_grad_card_vs_cpu(classifier, device, seed: int = 8) -> dict:
    """The guided sampler's cond_fn through the run's NoisyClassifier on the
    card against a copy on the CPU, at t < 250 on q_sample'd synthetic
    images. Held within GRAD_TOL of the largest |g| in f64 copies on both
    sides with one timestep embedding (the CPU's): the port's function,
    computed by both. The f32 path the sampler runs, each side with its own
    embedding, is recorded and held to GRAD_L2_SANITY only: a ReLU net's
    input gradient is piecewise constant in which units are on, so f32
    rounding that moves a unit across 0 (the two sides' convs, or their
    sin, cos and exp in the embedding) moves the gradient by up to a few
    1e-2 of its largest |g| at the pixels behind it
    (scripts/classifier_grad_conditioning.py shows it on the CPU alone)."""
    from ccdm_tpu_torch.data.datasets import make_synthetic
    from ccdm_tpu_torch.diffusion.guided import classifier_grad_fn
    from ccdm_tpu_torch.models.layers import sinusoidal_pos_emb
    from ccdm_tpu_torch.ops.image import normalize_images
    from ccdm_tpu_torch.ops.schedule import make_schedule, q_sample

    g = torch.Generator().manual_seed(seed)
    x0 = normalize_images(torch.from_numpy(make_synthetic(n=8, seed=seed).images),
                          to_neg_one_to_one=True)
    t = torch.randint(0, 250, (8,), generator=g)
    y = torch.randint(0, BASE_CLASSES, (8,), generator=g)
    x = q_sample(make_schedule(1000, "cosine", "pred_noise"), x0, t,
                 torch.randn(x0.shape, generator=g))
    cpu = copy.deepcopy(classifier).cpu()

    def grad(net, dev, dtype):
        return classifier_grad_fn(net, takes_t=True)(
            x.to(dev, dtype), t.to(dev), y.to(dev)).double().cpu()

    with cpu_timestep_embedding(torch.float64):
        want = grad(copy.deepcopy(cpu).double(), "cpu", torch.float64)
        got = grad(copy.deepcopy(classifier).double(), device, torch.float64)
    scale = float(want.abs().max())
    err = check_close(got, want, 0.0, GRAD_TOL * scale,
                      "classifier gradient, card against CPU (f64, one timestep embedding)")
    want32 = grad(cpu, "cpu", torch.float32)
    own = grad(classifier, device, torch.float32) - want32
    l2 = float(own.norm() / want32.norm())
    if not l2 <= GRAD_L2_SANITY:
        raise AssertionError(f"classifier gradient in f32, card against CPU: {l2:.3e} "
                             "relative (L2)")
    emb = float((sinusoidal_pos_emb(t.to(device), 128).cpu() - sinusoidal_pos_emb(t, 128))
                .abs().max())
    return {"max_abs_err": err, "largest_abs_grad": scale,
            "f32": {"max_abs_err": float(own.abs().max()), "l2_relative": l2,
                    "share_beyond_tol": float((own.abs() > GRAD_TOL * scale).float().mean())},
            "embedding_max_abs_err": emb}


def sampling_step_ms(out: dict, method: str, device) -> float:
    """ms per sampling step of the run's EMA weights at its batch: CFG's
    DDIM at --sample_cond_scale 1.5 (2B rows), or one guided ancestral step
    (the UNet forward and the classifier's gradient), BASE_TIMED_STEPS
    steps a call, events."""
    from ccdm_tpu_torch.diffusion.guided import classifier_grad_fn, classifier_guided_sample

    diffusion = out["trainer"].ema_diffusion()
    g = torch.Generator(device=device).manual_seed(4)
    emb = torch.randn(ADMG_BATCH, 128, generator=g, device=device)
    if method == "cfg":
        call = lambda: diffusion.ddim_sample(emb, cond_scale=1.5,
                                             sampling_timesteps=BASE_TIMED_STEPS, generator=g)
    else:
        cond_fn = classifier_grad_fn(out["classifier"], takes_t=True)
        classes = torch.arange(ADMG_BATCH, device=device) % BASE_CLASSES
        call = lambda: classifier_guided_sample(diffusion, emb, classes, cond_fn,
                                                sampling_timesteps=BASE_TIMED_STEPS,
                                                generator=g)
    return time_ms(call, reps=3, warmup=1) / BASE_TIMED_STEPS


def class_diffusion_sub_runs(device, card: str) -> dict:
    """(c) and (d): classgan_main --method cfg, then --method admg."""
    from ccdm_tpu_torch import classgan_main

    train = {k: v * BASE_DIFF_STEPS for k, v in BASE_PER_STEP.items()}
    sampled = BASE_PER_FORWARD * BASE_SAMPLE_STEPS  # one CFG chunk, one guided batch
    expected = {**train, "attn_block": train["attn_block"] + sampled}
    out, shapes, two_pass = {}, set(), set()
    for method, argv in (("cfg", CFG_ARGV), ("admg", ADMG_ARGV)):
        with attn_shapes() as launched, large_shapes() as launched_two_pass:
            run, counts, record, seconds = baseline_run(
                classgan_main, ["--device", str(device), *argv], expected,
                f"({'c' if method == 'cfg' else 'd'}) {method}: {BASE_DIFF_STEPS} steps of "
                f"batch {BASE_TRAIN_BATCH}, then {BASE_FAKES} fakes at {BASE_SAMPLE_STEPS} steps")
        shapes |= launched
        two_pass |= launched_two_pass
        out[method] = {"launches": counts, "seconds": seconds,
                       **class_unet_checks(run, method, card)}
        if method == "admg":
            out[method]["classifier_seconds_per_epoch"] = run["classifier"].seconds_per_epoch
            out[method]["classifier_grad"] = classifier_grad_card_vs_cpu(run["classifier"],
                                                                         device)
        out[method]["ms_per_sampling_step"] = sampling_step_ms(run, method, device)
        del run
    out["attn_shapes"] = checked_in_phase_3(shapes)
    out["two_pass_shapes"] = checked_in_phase_6(two_pass)
    if {s[3] for s in out["attn_shapes"]} != {"float32"}:
        raise AssertionError(f"#1 launched at {out['attn_shapes']}: the class UNet is f32")
    c, d = out["cfg"], out["admg"]
    print(f"   (c) cfg: warm train {c['train_images_per_s']:.2f} images/s (batch "
          f"{BASE_TRAIN_BATCH}, f32); {c['ms_per_sampling_step']:.2f} ms a CFG step ({CFG_ROWS} "
          f"rows); EMA forward card vs CPU {c['ema_card_vs_cpu_max_abs_err']:.3e}; (d) admg: "
          f"warm train {d['train_images_per_s']:.2f} images/s; noisy classifier "
          f"{d['classifier_seconds_per_epoch']:.2f} s an epoch; {d['ms_per_sampling_step']:.2f} "
          f"ms a guided step (batch {ADMG_BATCH}); classifier gradient card vs CPU "
          f"{d['classifier_grad']['max_abs_err']:.3e} (largest |g| "
          f"{d['classifier_grad']['largest_abs_grad']:.3e}; f64, one timestep embedding), in "
          f"f32 {json.dumps(d['classifier_grad']['f32'])} (the embeddings "
          f"{d['classifier_grad']['embedding_max_abs_err']:.3e} apart); #1 at "
          f"{out['attn_shapes']}, #2-#5 at {out['two_pass_shapes']}, each checked in phases 3 "
          f"and 6, on {card}", flush=True)
    return out


def baselines_main_path(device, card: str) -> dict:
    """Phase 23: the CcGAN/Dual-NDA and class-conditional baselines
    (ccgan_main, classgan_main) in build/smoke_baselines, deleted after."""
    t_phase = time.perf_counter()
    shutil.rmtree(BASE_RUN, ignore_errors=True)
    try:
        out = {"ccgan": ccgan_sub_runs(device, card),
               "studiogan": studiogan_sub_runs(device, card),
               **class_diffusion_sub_runs(device, card)}
    finally:
        shutil.rmtree(BASE_RUN, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"   the baselines: no kernel launched by the GANs, #1-#5 exactly as counted by the "
          f"class UNet's training and sampling; the phase {out['phase_s']:.1f} s on {card}",
          flush=True)
    return out


# ------------------------------------------- the fused resnet block slice

# (H = W, Cin, Cout) of the 23 resnet blocks of one RC-49 64x64 UNet forward
# (dim 64, mults 1_2_2_4_8), with the blocks that share each shape
RESNET_SHAPES = {(64, 64, 64): 2, (64, 128, 64): 3, (32, 64, 64): 2, (32, 192, 128): 2,
                 (16, 128, 128): 2, (16, 256, 128): 2, (8, 128, 128): 2, (8, 384, 256): 2,
                 (4, 256, 256): 2, (4, 512, 512): 2, (4, 768, 512): 2}
RESNET_BLOCKS = sum(RESNET_SHAPES.values())  # 23: launches of #10 and of #11 per forward
ATTN_BLOCKS = 10  # launches of #1 per sampling forward (FORWARD_SHAPES)
RESNET_REPLACES = {"resnet_half_a": "ccdm_tpu/ops/resnet_block.py:106",
                   "resnet_half_b": "ccdm_tpu/ops/resnet_block.py:130"}
# the batches the main paths give #1, #10 and #11: a CFG forward of 32 served
# labels; a training step; the EMA grid's CFG forward of 36 labels; the
# eval sampling's and the ddpm request's CFG forward of 4 labels
RESNET_BATCHES = (BATCH, TRAIN_BATCH, 2 * 36, 2 * 4)
# and #1's alone: phase 19's interpolation, an unguided forward of one
# image (cond_scale 1, as in the JAX package), and its multi-dim eval
# sampling, a CFG forward of one label row x --nfake_per_label 2
ATTN_BATCHES = (*RESNET_BATCHES, 1, 2 * 2)
FUSED_STEPS = 25   # DDIM steps of the switch-on serving phase
DDPM_STEPS = 10
FUSED_TRAIN_STEPS = 5
FUSED_TRAIN_ARGV = [*TRAIN_ARGV, "--niters", str(FUSED_TRAIN_STEPS), "--save_every",
                    str(FUSED_TRAIN_STEPS), "--sample_every", str(FUSED_TRAIN_STEPS),
                    "--log_every", "1"]
# UNet forwards of that run: one per step, the 10 DDIM steps of the EMA grid
# (36 images in one batch), then EVAL_FORWARDS
FUSED_TRAIN_FORWARDS = FUSED_TRAIN_STEPS + 10 + EVAL_FORWARDS


@contextlib.contextmanager
def fused_resnet(on: bool):
    """Set CCDM_TPU_FUSED_RESBLOCK's module switch for the block."""
    before = resnet_block.USE_FUSED
    resnet_block.USE_FUSED = on
    try:
        yield
    finally:
        resnet_block.USE_FUSED = before


def resnet_bound_parts(name: str, hw: int, cin: int, cout: int, batch: int,
                       itemsize: int = 2) -> tuple[float, float]:
    """Least times (ms) of one call of kernel `name`: each input read and each
    output written once (activations and matrices in the activation type,
    scale/shift and the vectors in f32), over HBM bandwidth; its products'
    operations over the bf16 peak."""
    act = lambda c: batch * hw * c * itemsize
    has_res = cin != cout
    if name == "resnet_half_a":
        nbytes = act(cin) + act(cout) + 9 * cin * cout * itemsize + 2 * batch * cout * 4 \
            + 2 * cout * 4
        flops = 2 * batch * hw * 9 * cin * cout
    else:
        nbytes = 2 * act(cout) + act(cin) + 9 * cout * cout * itemsize + 2 * cout * 4 \
            + (cin * cout * itemsize + cout * 4 if has_res else 0)
        flops = 2 * batch * hw * (9 * cout * cout + (cin * cout if has_res else 0))
    return nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS * 1e3


def resnet_inputs(hh: int, cin: int, cout: int, batch: int, device, seed: int):
    """Kernel inputs in the JAX layout, f32: x ~ N(0, 1) [B, HW, Cin]; conv
    weights tap-major at 1/sqrt(fan-in); gains 1 + N(0, 0.5); FiLM N(0, 0.3)."""
    g = torch.Generator().manual_seed(seed)
    n = lambda *shape, s=1.0: torch.randn(*shape, generator=g) * s
    has_res = cin != cout
    t = {"x": n(batch, hh * hh, cin), "scale": n(batch, cout, s=0.3),
         "shift": n(batch, cout, s=0.3), "w1": n(9 * cin, cout, s=(9 * cin) ** -0.5),
         "b1": n(cout, s=0.1), "g1": 1 + n(cout, s=0.5),
         "w2": n(9 * cout, cout, s=(9 * cout) ** -0.5), "b2": n(cout, s=0.1),
         "g2": 1 + n(cout, s=0.5), "wres": n(cin, cout, s=cin ** -0.5) if has_res else None,
         "bres": n(cout, s=0.1) if has_res else None}
    return {k: None if v is None else v.to(device) for k, v in t.items()}


def _as_block(t: dict, hh: int, dt):
    """The same inputs as resnet_block_reference takes them: x NCHW
    (channels_last) in dt, OIHW kernels."""
    b, _, cin = t["x"].shape
    cout = t["b1"].shape[0]
    oihw = lambda w, ci: w.reshape(3, 3, ci, cout).permute(3, 2, 0, 1).contiguous()
    return (t["x"].to(dt).view(b, hh, hh, cin).permute(0, 3, 1, 2), t["scale"], t["shift"],
            oihw(t["w1"], cin), t["b1"], t["g1"], oihw(t["w2"], cout), t["b2"], t["g2"],
            None if t["wres"] is None else t["wres"].t().reshape(cout, cin, 1, 1), t["bres"])


def resnet_yardsticks(t: dict, hh: int, dt) -> dict:
    """Per half, (its composition in resnet_block_reference, its bare convs)
    as callables on the same inputs in NCHW channels_last: cuDNN convs plus
    the eager norm, FiLM, SiLU and residual; and the products alone."""
    x, scale, shift, w1, b1, g1, w2, b2, g2, wres, bres = _as_block(t, hh, dt)
    h = resnet_block.reference_half_a(x, scale, shift, w1, b1, g1)
    w1c, w2c = w1.to(dt), w2.to(dt)
    wresc = None if wres is None else wres.to(dt)
    conv = torch.nn.functional.conv2d
    return {"resnet_half_a": (
                lambda: resnet_block.reference_half_a(x, scale, shift, w1, b1, g1),
                lambda: conv(x, w1c, padding=1)),
            "resnet_half_b": (
                lambda: resnet_block.reference_half_b(h, x, w2, b2, g2, wres, bres),
                (lambda: conv(h, w2c, padding=1)) if wresc is None else
                (lambda: (conv(h, w2c, padding=1), conv(x, wresc))))}


@torch.no_grad()
def resnet_vs_plain(device) -> dict:
    """Phase 9: #10 and #11 against their plain versions per shape, f32 and
    bf16, at every batch the main paths give them (RESNET_BATCHES); bf16
    times at B 64 (and B 128 at 64x64) beside the plain versions, each
    half's composition (library_ms), its bare cuDNN convs (cudnn_conv_ms)
    and the cuDNN composition of the whole block, with the route taken, the
    wrapper's host time, TFLOP/s and the share of the bound."""
    rows = {}
    cases = [(shape, batch) for batch in RESNET_BATCHES for shape in RESNET_SHAPES]
    for i, ((hh, cin, cout), batch) in enumerate(cases):
        timed = batch == BATCH or (batch == TRAIN_BATCH and hh == 64)
        t = resnet_inputs(hh, cin, cout, batch, device, seed=80 + i)
        row = {"max_err": {}, "plan": {
            name: resnet_block.plan(name[-1], batch, hh, hh, cin, cout, cin != cout,
                                    torch.bfloat16)._asdict() for name in RESNET}}
        for dt in (torch.float32, torch.bfloat16):
            tol = (2e-3, 2e-4) if dt == torch.float32 else (4e-2, 4e-2)
            tag = f"H={hh} Cin={cin} Cout={cout} B={batch} {str(dt)[6:]}"
            x = t["x"].to(dt)
            w1, w2 = t["w1"].to(dt), t["w2"].to(dt)
            wres = None if t["wres"] is None else t["wres"].to(dt)
            a_args = (x, t["scale"], t["shift"], w1, t["b1"], t["g1"], hh, hh)
            h1 = resnet_block.resnet_half_a(*a_args)
            b_args = (h1, x, w2, t["b2"], t["g2"], wres, t["bres"], hh, hh)
            key = str(dt)[6:]
            row["max_err"][f"h1_{key}"] = check_close(
                h1, resnet_block.half_a_reference(*a_args), *tol, f"#10 {tag}")
            row["max_err"][f"y_{key}"] = check_close(
                resnet_block.resnet_half_b(*b_args), resnet_block.half_b_reference(*b_args),
                *tol, f"#11 {tag}")
            if dt == torch.bfloat16 and timed:
                yard = resnet_yardsticks(t, hh, dt)
                calls = {"resnet_half_a": (lambda: resnet_block.resnet_half_a(*a_args),
                                           lambda: resnet_block.half_a_reference(*a_args)),
                         "resnet_half_b": (lambda: resnet_block.resnet_half_b(*b_args),
                                           lambda: resnet_block.half_b_reference(*b_args))}
                for name, (kernel, plain) in calls.items():
                    parts = resnet_bound_parts(name, hh * hh, cin, cout, batch)
                    r = timing(kernel, plain, parts, library=yard[name][0])
                    r["cudnn_conv_ms"] = time_ms(yard[name][1])
                    r["tflops"] = parts[1] * BF16_FLOPS / r["ms"] / 1e12
                    r["bound_share"] = r["bound_ms"] / r["ms"]
                    row[name] = r
                block = _as_block(t, hh, dt)
                row["cudnn_block_ms"] = time_ms(
                    lambda: resnet_block.resnet_block_reference(*block))
        rows[f"H{hh}_Cin{cin}_Cout{cout}_B{batch}"] = row
        print(f"   H={hh:2d} Cin={cin:3d} Cout={cout:3d} B={batch}: {json.dumps(row)}",
              flush=True)
        del t, x, h1, a_args, b_args
        torch.cuda.empty_cache()
    print_resnet_levels(resnet_levels(rows))
    return rows


def resnet_levels(rows: dict) -> dict:
    """Per level (H = W) and half, over the blocks of one B-64 forward: the
    summed times, bound, TFLOP/s, share of the bound, host time and routes."""
    levels = {}
    for (hh, cin, cout), k in RESNET_SHAPES.items():
        r = rows[f"H{hh}_Cin{cin}_Cout{cout}_B{BATCH}"]
        for name in RESNET:
            lv = levels.setdefault(f"H{hh}", {}).setdefault(name, {
                "ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0, "cudnn_conv_ms": 0.0,
                "host_ms": 0.0, "tflop": 0.0, "routes": []})
            for key in ("ms", "bound_ms", "library_ms", "cudnn_conv_ms", "host_ms"):
                lv[key] += k * r[name][key]
            lv["tflop"] += k * r[name]["tflops"] * r[name]["ms"] * 1e-3
            pl = r["plan"][name]
            lv["routes"].append(f"{k}x Cin {cin} Cout {cout}: {pl['route']} "
                                f"{pl['tile'][0]}x{pl['tile'][1]} splits {pl['splits']}")
    for lv in levels.values():
        for r in lv.values():
            r["tflops"] = r["tflop"] / (r["ms"] * 1e-3)
            r["bound_share"] = r["bound_ms"] / r["ms"]
    return levels


def print_resnet_levels(levels: dict) -> None:
    for level, halves in levels.items():
        for name, r in halves.items():
            print(f"   {level} {name}: {r['ms']:.4f} ms ({r['tflops']:.1f} TFLOP/s, "
                  f"{100 * r['bound_share']:.1f}% of the bound {r['bound_ms']:.4f}); composition "
                  f"{r['library_ms']:.4f}, bare cuDNN convs {r['cudnn_conv_ms']:.4f}, host "
                  f"{r['host_ms']:.4f} ms; {'; '.join(r['routes'])}", flush=True)


def fused_model_parity(device) -> dict:
    """Phase 10: model_parity with the switch on against off; the six
    switch-on forwards launch each kernel 23 times."""
    _reset_counts()
    out = model_parity(device, lambda: fused_resnet(True), lambda: fused_resnet(False),
                       "switch on and off")
    counts = {k: _counts()[k] for k in RESNET}
    if counts != {k: 6 * RESNET_BLOCKS for k in RESNET}:
        raise AssertionError(f"six switch-on forwards launched {counts}, expected "
                             f"{RESNET_BLOCKS} of each kernel per forward")
    return out


def fused_serve_main_path(device, card: str) -> dict:
    """Phase 11: the serving main path with the switch on, then one request
    to an ancestral (--sampler ddpm) service."""
    argv = [*SERVE_ARGV, "--sample_timesteps", str(FUSED_STEPS)]
    with fused_resnet(True):
        _reset_counts()
        service = SamplerService(parse_opts(argv), max_batch=SERVE_BATCH, warm=True,
                                 device=str(device))
        batches, n_images, req_s = _serve_requests(service, ((40, 2),), 64)
        batches += 1  # the warm-up batch
        counts = _counts()
        expected = {"attn_block": ATTN_BLOCKS * FUSED_STEPS * batches,
                    "resnet_half_a": RESNET_BLOCKS * FUSED_STEPS * batches,
                    "resnet_half_b": RESNET_BLOCKS * FUSED_STEPS * batches,
                    **{k: 0 for k in NEW_KERNELS}}
        got = {k: counts[k] for k in expected}
        ips = n_images / req_s
        print(f"   {batches} batches of {SERVE_BATCH} x {FUSED_STEPS} DDIM steps, {n_images} "
              f"images in {req_s:.2f} s: {ips:.2f} images/s on {card}; launches {got} "
              f"(expected {expected})", flush=True)
        if got != expected:
            raise AssertionError(f"switch-on serving launched {got}, expected {expected}")
        forward_ms = cfg_forward_ms(service)
        print(f"   one CFG forward (B {BATCH}, bf16): {forward_ms:.4f} ms", flush=True)
        turns = cfg_forward_turns(service)
        print(f"   the same forward in turns: switch off {turns['off']['ms']:.4f} ms (host "
              f"{turns['off']['host_ms']:.4f}), on {turns['on']['ms']:.4f} ms (host "
              f"{turns['on']['host_ms']:.4f})", flush=True)

        ddpm = SamplerService(parse_opts([*argv, "--sampler", "ddpm", "--sample_timesteps",
                                          str(DDPM_STEPS)]),
                              max_batch=4, warm=False, device=str(device))
        ddpm_batches, _, ddpm_s = _serve_requests(ddpm, ((4, 3),), 64)
        print(f"   --sampler ddpm: 4 labels x {DDPM_STEPS} ancestral steps over HTTP in "
              f"{ddpm_s:.2f} s: uint8, not constant", flush=True)
    return {"launches": got, "batches": batches, "images_per_s": ips,
            "requested_images": n_images, "request_s": req_s, "ddpm_request_s": ddpm_s,
            "cfg_forward_ms": forward_ms, "cfg_forward_turns": turns}


def read_png(path: Path) -> np.ndarray:
    """The pixels [H, W, C] of an 8-bit grayscale or RGB PNG with one IDAT
    chunk and no filters, as utils/viz.py writes it (the card's machine has
    no PIL)."""
    data = path.read_bytes()
    w, h, depth, color = struct.unpack(">IIBB", data[16:26])
    if data[12:16] != b"IHDR" or depth != 8 or color not in (0, 2) or data[37:41] != b"IDAT":
        raise AssertionError(f"{path.name} is not the grayscale or RGB PNG the port writes")
    c = 3 if color == 2 else 1
    size = struct.unpack(">I", data[33:37])[0]
    rows = np.frombuffer(zlib.decompress(data[41:41 + size]), np.uint8).reshape(h, 1 + c * w)
    return rows[:, 1:].reshape(h, w, c)


def fused_train_checks(card: str):
    """Phase 12's own checks: the EMA grid and the eval labels' grids decode
    to images that are not constant."""
    from ccdm_tpu_torch import main as port_main

    def checks(trainer, argv, log) -> dict:
        args = parse_opts(argv)
        results = Path(port_main.results_folder(args))
        grids = [results / f"sample_{FUSED_TRAIN_STEPS}.png",
                 *sorted(Path(port_main.fake_data_folder(args, 2)).glob("sample_*.png"))]
        stds = [float(read_png(p).std()) for p in grids]
        print(f"   {log[-1]['imgs_per_sec']:.2f} train images/s at step {FUSED_TRAIN_STEPS} "
              f"on {card}; grids {[p.name for p in grids]} (pixel std "
              f"{[round(v, 2) for v in stds]})", flush=True)
        if len(log) != FUSED_TRAIN_STEPS or len(grids) != 3 or not all(v > 0 for v in stds):
            raise AssertionError(f"{len(log)} log lines, grids {grids}, pixel std {stds}")
        return {"forwards": FUSED_TRAIN_FORWARDS, "grid_std": stds,
                "train_images_per_s_last_step": log[-1]["imgs_per_sec"]}

    return checks


def resnet_kernel_rows(rows: dict, served: dict, trained: dict, parity: dict, card: str,
                       forward_off_ms: float):
    """The kernels-line entries of #10 and #11: times summed over the 23
    launches of one B-64 forward, and their share of that forward, timed
    whole with the switch off (phase 5) and on (phase 11)."""
    out = []
    fwd = [(rows[f"H{h}_Cin{ci}_Cout{co}_B{BATCH}"], k)
           for (h, ci, co), k in RESNET_SHAPES.items()]
    for name in RESNET:
        total = lambda key: sum(r[name][key] * k for r, k in fwd)
        by_bytes = sum(r[name]["bound_ms"] * k for r, k in fwd if r[name]["bound_by"] == "bytes")
        out.append({
            "name": name, "route": "cuda", "source": "ccdm_tpu_torch/csrc/resnet_block.cu",
            "replaces": RESNET_REPLACES[name], "launches": served["launches"][name],
            "max_abs_err": max(r["max_err"]["h1_bfloat16" if name == "resnet_half_a"
                                            else "y_bfloat16"] for r in rows.values()),
            "ms": total("ms"), "plain_ms": total("plain_ms"), "bound_ms": total("bound_ms"),
            "bound_by": "bytes" if 2 * by_bytes >= total("bound_ms") else "operations",
            "library_ms": total("library_ms"),
            "library_ms_is": "the half's composition in resnet_block_reference (cuDNN conv, "
                             "eager norm, FiLM or residual, SiLU), bf16, summed over the 23",
            "cudnn_conv_ms": total("cudnn_conv_ms"),
            "cudnn_conv_ms_is": "the half's bare F.conv2d (and #11's 1x1 projection), "
                                "channels_last, bf16, summed over the 23",
            "host_ms": total("host_ms"),
            "cudnn_block_ms": sum(r["cudnn_block_ms"] * k for r, k in fwd),
            "cudnn_block_ms_is": "the whole block (both halves) as resnet_block_reference "
                                 "in bf16 (cuDNN convs), summed over the 23 blocks",
            "ms_is": f"sum over the 23 launches of one UNet forward, B {BATCH}, bf16",
            "launches_in_training": trained["launches"][name],
            "max_err_f32": max(r["max_err"]["h1_float32" if name == "resnet_half_a"
                                            else "y_float32"] for r in rows.values()),
            "by_shape": {tag: {**r.get(name, {}), "max_err": r["max_err"]}
                         for tag, r in rows.items()},
            "card": card})
    cudnn = out[0]["cudnn_block_ms"]
    kernels = out[0]["ms"] + out[1]["ms"]
    turns = served["cfg_forward_turns"]
    out[0]["cfg_forward"] = {
        "switch_off_ms": forward_off_ms, "switch_on_ms": served["cfg_forward_ms"],
        "cudnn_blocks_share_of_switch_off": cudnn / forward_off_ms,
        "kernels_share_of_switch_on": kernels / served["cfg_forward_ms"],
        "in_turns_phase_11": turns}
    print(f"   one CFG forward (B {BATCH}, bf16): {forward_off_ms:.4f} ms with the switch off, "
          f"of which the 23 blocks' cuDNN composition (timed alone) {cudnn:.4f} ms "
          f"({100 * cudnn / forward_off_ms:.1f}%); {served['cfg_forward_ms']:.4f} ms with "
          f"the switch on, of which #10 + #11 (timed alone) {kernels:.4f} ms "
          f"({100 * kernels / served['cfg_forward_ms']:.1f}%); in turns in phase 11: off "
          f"{turns['off']['ms']:.4f} ms (host {turns['off']['host_ms']:.4f}), on "
          f"{turns['on']['ms']:.4f} ms (host {turns['on']['host_ms']:.4f})", flush=True)
    print(f"   #10 + #11 over the 23 blocks: {kernels:.4f} ms against the cuDNN composition "
          f"of the same blocks {cudnn:.4f} ms ({kernels / cudnn:.2f}x); per half: #10 "
          f"{out[0]['ms']:.4f} (composition {out[0]['library_ms']:.4f}, bare convs "
          f"{out[0]['cudnn_conv_ms']:.4f}), #11 {out[1]['ms']:.4f} (composition "
          f"{out[1]['library_ms']:.4f}, bare convs {out[1]['cudnn_conv_ms']:.4f})", flush=True)
    levels = resnet_levels(rows)
    print_resnet_levels(levels)
    out[0]["levels"] = levels
    out[0]["model_parity"] = parity
    out[0]["serve"] = served
    out[1]["train"] = trained
    out[0]["by_shape_cudnn_block_ms"] = {tag: r["cudnn_block_ms"] for tag, r in rows.items()
                                         if "cudnn_block_ms" in r}
    return out


# ------------------ standalone linear attention (#6-#9) and bias_act (#12)

LA = ("linear_attention_fulllane", "linear_attention_ctx_twopass",
      "linear_attention_out_twopass", "linear_attention_per_head")
LA_REPLACES = {"linear_attention_fulllane": "ccdm_tpu/ops/linear_attention.py:106",
               "linear_attention_ctx_twopass": "ccdm_tpu/ops/linear_attention.py:180",
               "linear_attention_out_twopass": "ccdm_tpu/ops/linear_attention.py:222",
               "linear_attention_per_head": "ccdm_tpu/ops/linear_attention.py:56"}
NEW_KERNELS = (*LA, "bias_act_fused")
F32_FLOPS = 67e12  # f32 outside the tensor cores, same data sheet
# (B, N, H, D) of #6 and #9: the UNet's attention levels, served (B 64) and
# trained (B 128), then the other head widths JAX's route takes, at N 1024
LA_SHAPES = ([(b, n, HEADS, DIM_HEAD) for b in (BATCH, TRAIN_BATCH)
              for n in sorted({n for n, _ in FORWARD_SHAPES}, reverse=True)]
             + [(BATCH, 1024, h, d) for h, d in ((2, 64), (8, 16), (1, 128))])
LA_MAIN = (BATCH, 4096, HEADS, DIM_HEAD)  # the shape of the kernels line
# (B, N, chunk) of #7 + #8: the 128x128 top level when sampling (the
# kernels line), the 64x64 level when training, the 192x192 top level, three
# chunks, chunks of 1024
TWOPASS_SHAPES = [(BATCH, 16384, 2048), (TRAIN_BATCH, 4096, 2048), (16, 36864, 2048),
                  (16, 6144, 2048), (16, 4096, 1024)]
# [rows, C] of #12: GAN feature maps at batch 64 (64x64x128, 32x32x256 for the
# kernels line, 8x8x512), then a row count off the kernel's 256-thread tile
BIAS_ACT_SHAPES = [(64 * 64 * 64, 128), (64 * 32 * 32, 256), (64 * 8 * 8, 512), (1003, 128)]
BIAS_ACT_MAIN = (64 * 32 * 32, 256)


def la_bound_parts(name: str, b: int, n: int, h: int, d: int,
                   itemsize: int = 2) -> tuple[float, float]:
    """Least times (ms) of one call of kernel `name`: each input read and each
    output written once over HBM bandwidth (q, k, v, out and ctx in the
    operand type; m, a and s in f32), and its per-head products (the H
    blocks of D x D, not the TPU kernels' F x F, la_flops) over the bf16
    peak, #9's over the f32 peak: it computes in f32."""
    act, f = b * n * h * d * itemsize, h * d
    nbytes = {"linear_attention_fulllane": 4 * act, "linear_attention_per_head": 4 * act,
              "linear_attention_ctx_twopass": 2 * act + 2 * b * f * 4 + b * f * d * 4,
              "linear_attention_out_twopass": 2 * act + b * f * d * itemsize}[name]
    rate = F32_FLOPS if name == "linear_attention_per_head" else BF16_FLOPS
    return nbytes / HBM_BYTES_PER_S * 1e3, la_flops(name, b, n, h, d) / rate * 1e3


def bias_act_bound_parts(rows: int, c: int, bias: bool, gain: bool,
                         itemsize: int = 2) -> tuple[float, float]:
    """Least times (ms) of one lrelu call of #12: x read and y written once
    (and the bias), over HBM bandwidth; its f32 operations (compare and
    multiply of lrelu, the bias add, the gain) over the f32 peak."""
    nbytes = (2 * rows * c + (c if bias else 0)) * itemsize
    return nbytes / HBM_BYTES_PER_S * 1e3, rows * c * (2 + bias + gain) / F32_FLOPS * 1e3


def la_flops(name: str, b: int, n: int, h: int, d: int) -> float:
    """The per-head products of one call of kernel `name` (la_bound_parts)."""
    products = 2 if name in ("linear_attention_fulllane", "linear_attention_per_head") else 1
    return 2 * products * b * n * h * d * d


def checked_plan(what: str, plan, shape, dt, fast: str) -> dict:
    """`plan` (of kernels `what` at q `shape` of `dt`) as a dict, its route
    asserted to be `fast` in bf16 at D % 16 == 0 and the CUDA cores
    otherwise."""
    want = fast if dt == torch.bfloat16 and shape[3] % 16 == 0 else "cores"
    if plan.route != want:
        raise AssertionError(f"{what} at {shape} {dt}: route {plan.route}, expected {want}")
    return plan._asdict()


def la_route(shape, dt) -> dict:
    """la_plan of #6 and #8: the tensor route in bf16 at D % 16 == 0."""
    return checked_plan("#6/#8", la.la_plan(*shape, dt), shape, dt, "tensor")


def per_head_route(shape, dt) -> dict:
    """per_head_plan of #9: the whole-row f32 route in bf16 at D % 16 == 0."""
    return checked_plan("#9", la.per_head_plan(*shape, dt), shape, dt, "rows")


def twopass_route(shape, chunk: int, dt) -> dict:
    """twopass_plan of #7: the tensor route in bf16 at D % 16 == 0."""
    return checked_plan("#7", la.twopass_plan(*shape, chunk, dt), shape, dt, "tensor")


def with_rates(row: dict, flops: float) -> dict:
    """timing()'s row with TFLOP/s and the share of the bound."""
    return {**row, "tflops": flops / (row["ms"] * 1e-3) / 1e12,
            "share_of_bound": row["bound_ms"] / row["ms"]}


def timing(kernel, plain, parts: tuple[float, float], reps: int = 20, library=None) -> dict:
    """The kernel's and its plain version's times (and a library call's),
    with the bound of `parts` (bytes, operations) and the wrapper's host time."""
    t_bytes, t_ops = parts
    row = {"ms": time_ms(kernel, reps=reps), "host_ms": host_ms(kernel, reps=reps),
           "plain_ms": time_ms(plain, reps=reps),
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    if library is not None:
        row["library_ms"] = time_ms(library, reps=reps)
    return row


def la_inputs(shape, dt, device, seed: int) -> list:
    """q, k, v ~ N(0, 2) in f32 and N(0, 1) in bf16 (the inputs of
    tests/test_linear_attention.py), drawn on the card."""
    g = torch.Generator(device).manual_seed(seed)
    std = 2.0 if dt == torch.float32 else 1.0
    return [(torch.randn(*shape, generator=g, device=device) * std).to(dt) for _ in range(3)]


def la_check(got: torch.Tensor, want: torch.Tensor, what: str, scale_atol: bool = True) -> float:
    """The bounds of tests/test_linear_attention.py: f32 (TF32 off) rtol
    2e-3, atol 1e-4; bf16 rtol 3e-2 and atol 3e-2 of max |want|. Outputs of
    N(0, 1) inputs lie near 1e-2, so a fixed bf16 atol of 3e-2 would pass a
    kernel that wrote zeros. With scale_atol (a and s of #7) the f32 atol
    is taken of max |want| too. Returns the max abs error."""
    rtol, atol = (2e-3, 1e-4) if want.dtype == torch.float32 else (3e-2, 3e-2)
    if want.dtype != torch.float32 or scale_atol:
        atol *= float(want.float().abs().max())
    return check_close(got, want, rtol, atol, what)


def check_rounding(got: torch.Tensor, own: torch.Tensor, other: torch.Tensor,
                   what: str) -> float:
    """In bf16 a kernel keeps its own rounding points: its mean abs difference
    to `own` (its plain version) is at most a quarter of that to `other`, the
    same function on the same inputs rounded at other points. The outputs'
    own rounding hides such a change from an elementwise bound. Returns the
    ratio of the two means."""
    near = float((got.float() - own.float()).abs().mean())
    far = float((got.float() - other.float()).abs().mean())
    if not near <= 0.25 * far:
        raise AssertionError(f"{what}: mean abs diff {near:.3e} to its plain version, "
                             f"{far:.3e} to the other rounding points; beyond a quarter")
    return near / far if far > 0 else 0.0


@torch.no_grad()
def la_vs_plain(device) -> dict:
    """Phase 13: #6 and #9 against their plain versions at LA_SHAPES, f32
    with TF32 off and bf16 (la_check), and in bf16 each nearer its own plain
    version than the other's, which rounds elsewhere (check_rounding); #6's
    and #9's routes asserted (la_route, per_head_route) and #6 timed in
    bf16 at every shape, #9 at B 64; each the same bits on two calls at
    LA_MAIN."""
    rows = {}
    for i, shape in enumerate(LA_SHAPES):
        b, n, h, d = shape
        row = {"max_err": {}, "plan": {}, "plan9": {}}
        for dt in (torch.float32, torch.bfloat16):
            q, k, v = la_inputs(shape, dt, device, seed=100 + i)
            key, tag = str(dt)[6:], f"B={b} N={n} H={h} D={d} {str(dt)[6:]}"
            row["plan"][key] = la_route(shape, dt)
            row["plan9"][key] = per_head_route(shape, dt)
            calls = {"linear_attention_fulllane": (
                         lambda: la.linear_attention_fulllane(q, k, v),
                         lambda: la.fulllane_reference(q, k, v)),
                     "linear_attention_per_head": (
                         lambda: la.linear_attention_per_head(q, k, v),
                         lambda: la.linear_attention_reference(q, k, v))}
            # #6 rounds k', v, ctx and q'; #9 only its output: each is the
            # other's plain version rounded elsewhere
            others = {"linear_attention_fulllane": la.linear_attention_reference,
                      "linear_attention_per_head": la.fulllane_reference}
            for name, (kernel, plain) in calls.items():
                got, want = kernel(), plain()
                row["max_err"][f"{name}_{key}"] = la_check(got, want, f"{name} {tag}")
                if dt == torch.bfloat16:
                    row.setdefault("rounding", {})[name] = check_rounding(
                        got, want, others[name](q, k, v), f"{name} {tag}")
                if dt == torch.bfloat16 and (b == BATCH or name == "linear_attention_fulllane"):
                    row[name] = with_rates(timing(kernel, plain, la_bound_parts(name, *shape)),
                                           la_flops(name, *shape))
                if dt == torch.bfloat16 and shape == LA_MAIN:
                    if not torch.equal(kernel(), got):
                        raise AssertionError(f"{name} {tag}: two calls on the same inputs differ")
                    row.setdefault("same_bits_twice", {})[name] = True
        rows[f"B{b}_N{n}_H{h}_D{d}"] = row
        print(f"   B={b} N={n:5d} H={h} D={d:3d}: {json.dumps(row)}", flush=True)
    return rows


@torch.no_grad()
def twopass_vs_plain(device) -> dict:
    """Phase 14: #7 and #8 against their plain versions at TWOPASS_SHAPES, f32
    (TF32 off) and bf16 (la_check; a and s relative to their largest value),
    and in bf16 each nearer its plain version than a version rounded
    elsewhere (check_rounding); #7's and #8's routes asserted (twopass_route,
    la_route), each timed in bf16 at every shape and the same bits on two
    calls at the first, where the dispatcher's two-pass route is timed
    against the plain reference (and #9) on the same q, k, v."""
    rows = {}
    for i, (b, n, chunk) in enumerate(TWOPASS_SHAPES):
        shape = (b, n, HEADS, DIM_HEAD)
        row = {"max_err": {}, "plan": {}, "plan7": {}}
        for dt in (torch.float32, torch.bfloat16):
            q, k, v = la_inputs(shape, dt, device, seed=150 + i)
            key, tag = str(dt)[6:], f"B={b} N={n} chunk={chunk} {str(dt)[6:]}"
            row["plan"][key] = la_route(shape, dt)
            row["plan7"][key] = twopass_route(shape, chunk, dt)
            m = k.amax(1).float().reshape(b, F)
            a, s = la.linear_attention_ctx_twopass(k, v, m, chunk)
            ra, rs = la.ctx_twopass_reference(k, v, m)
            row["max_err"][f"a_{key}"] = la_check(a, ra, f"#7 a {tag}")
            row["max_err"][f"s_{key}"] = la_check(s, rs, f"#7 s {tag}")
            ctx = la.finalize_ctx(ra, rs, dt)
            out, want = la.linear_attention_out_twopass(q, ctx), la.out_twopass_reference(q, ctx)
            row["max_err"][f"out_{key}"] = la_check(out, want, f"#8 {tag}", scale_atol=False)
            if dt == torch.bfloat16:
                # the other rounding points: #7's a from the unrounded exp(k - m)
                # and s from the rounded one; #8's q' in f32
                e = torch.exp(k.float() - m.view(b, 1, HEADS, DIM_HEAD))
                row["rounding"] = {
                    "a": check_rounding(a, ra, torch.einsum("bnhd,bnhe->bhde", e, v.float()),
                                        f"#7 a {tag}"),
                    "s": check_rounding(s, rs, e.bfloat16().float().sum(1).reshape(b, F),
                                        f"#7 s {tag}"),
                    "out": check_rounding(out, want, torch.einsum(
                        "bnhd,bhde->bnhe", la._q_prime(q, torch.float32), ctx.float()).to(dt),
                        f"#8 {tag}")}
                del e
            if dt == torch.bfloat16:
                name = "linear_attention_out_twopass"
                row[name] = with_rates(timing(
                    lambda: la.linear_attention_out_twopass(q, ctx),
                    lambda: la.out_twopass_reference(q, ctx),
                    la_bound_parts(name, *shape), reps=10), la_flops(name, *shape))
                name = "linear_attention_ctx_twopass"
                row[name] = with_rates(timing(
                    lambda: la.linear_attention_ctx_twopass(k, v, m, chunk),
                    lambda: la.ctx_twopass_reference(k, v, m),
                    la_bound_parts(name, *shape), reps=10), la_flops(name, *shape))
            if dt == torch.bfloat16 and i == 0:
                if not torch.equal(la.linear_attention_out_twopass(q, ctx), out):
                    raise AssertionError(f"#8 {tag}: two calls on the same inputs differ")
                a2, s2 = la.linear_attention_ctx_twopass(k, v, m, chunk)
                if not (torch.equal(a2, a) and torch.equal(s2, s)):
                    raise AssertionError(f"#7 {tag}: two calls on the same inputs differ")
                row["same_bits_twice"] = {"linear_attention_ctx_twopass": True,
                                          "linear_attention_out_twopass": True}
                del a2, s2
                row["route_ms"] = {
                    "twopass": time_ms(lambda: la.linear_attention_twopass(q, k, v, chunk), 10),
                    "reference": time_ms(lambda: la.linear_attention_reference(q, k, v), 10),
                    "per_head": time_ms(lambda: la.linear_attention_per_head(q, k, v), 10)}
            del q, k, v, m, a, s, ra, rs, ctx, out, want
            torch.cuda.empty_cache()
        rows[f"B{b}_N{n}_chunk{chunk}"] = row
        print(f"   B={b} N={n:5d} chunk={chunk}: {json.dumps(row)}", flush=True)
    return rows


@torch.no_grad()
def bias_act_vs_plain(device) -> dict:
    """Phase 15: #12 against its plain version at BIAS_ACT_SHAPES, f32 (rtol
    1e-5, atol 1e-6) and bf16 (rtol = atol = 8e-3: both compute in f32 and
    round once, so a rounding may flip one unit): all 9 activations, with
    and without bias, clamp none and 1.5, default gain and 0.5. lrelu timed
    in bf16 per shape: the StyleGAN default (bias, gain sqrt 2) beside its
    plain version, and no bias, gain 1, no clamp beside F.leaky_relu, the one
    PyTorch call of that function, each by events, host time and the card's
    own time (device_ms)."""
    rows = {}
    for i, (r, c) in enumerate(BIAS_ACT_SHAPES):
        g = torch.Generator(device).manual_seed(200 + i)
        x32 = 2 * torch.randn(r, c, generator=g, device=device)
        b = torch.randn(c, generator=g, device=device)
        row = {"max_err": {}}
        for dt in (torch.float32, torch.bfloat16):
            x = x32.to(dt)
            tol = (1e-5, 1e-6) if dt == torch.float32 else (8e-3, 8e-3)
            worst = 0.0
            for act in so.activation_funcs:
                for bias in (None, b):
                    for clamp in (None, 1.5):
                        for gain in (None, 0.5):
                            _, alpha, gn, cl = so._resolve(act, None, gain, clamp)
                            worst = max(worst, check_close(
                                so.bias_act_fused(x, bias, act, alpha, gn, cl),
                                so.bias_act_fused_reference(x, bias, act, alpha, gn, cl), *tol,
                                f"#12 {act} bias={bias is not None} clamp={clamp} gain={gain} "
                                f"[{r}, {c}] {str(dt)[6:]}"))
            row["max_err"][str(dt)[6:]] = worst
        xb, gain = x32.bfloat16(), math.sqrt(2)
        row["lrelu_default"] = timing(
            lambda: so.bias_act_fused(xb, b, "lrelu", 0.2, gain, -1.0),
            lambda: so.bias_act_fused_reference(xb, b, "lrelu", 0.2, gain, -1.0),
            bias_act_bound_parts(r, c, True, True))
        kernel = lambda: so.bias_act_fused(xb, None, "lrelu", 0.2, 1.0, -1.0)
        library = lambda: torch.nn.functional.leaky_relu(xb, 0.2)
        row["bias_act_fused"] = timing(
            kernel, lambda: so.bias_act_fused_reference(xb, None, "lrelu", 0.2, 1.0, -1.0),
            bias_act_bound_parts(r, c, False, False), library=library)
        # the card's own time of each (kernel durations from torch.profiler),
        # and the host's time to issue the library call: device against
        # device, host against host
        row["bias_act_fused"].update(
            device_ms=sum(device_ms(kernel).values()),
            library_device_ms=sum(device_ms(library).values()),
            library_host_ms=host_ms(library))
        rows[f"{r}x{c}"] = row
        print(f"   [{r}, {c}]: {json.dumps(row)}", flush=True)
    return rows


@contextlib.contextmanager
def la_switches(kernels: bool = True, twopass: bool = False):
    """Set CCDM_TPU_FUSED_ATTN's and CCDM_TPU_TWOPASS_ATTN's module switches
    for the block."""
    before = la.USE_KERNELS, la.USE_TWOPASS
    la.USE_KERNELS, la.USE_TWOPASS = kernels, twopass
    try:
        yield
    finally:
        la.USE_KERNELS, la.USE_TWOPASS = before


def la_modules(c: int, seed: int, device):
    """FusedLinearAttentionBlock(c) with phase 3's weights (f32), and
    PreNormResidual(c, LinearAttention(c, 4, 32)) holding the same function
    (utils/convert.prenorm_linear_attention_from_fused)."""
    g = torch.Generator().manual_seed(seed)
    block = FusedLinearAttentionBlock(c, HEADS, DIM_HEAD)
    block.load_state_dict({"norm_g": 1 + 0.5 * torch.randn(c, generator=g),
                           "qkv_kernel": 0.1 * torch.randn(c, 3 * F, generator=g),
                           "out_kernel": 0.1 * torch.randn(F, c, generator=g),
                           "out_bias": 0.1 * torch.randn(c, generator=g),
                           "out_norm_g": 1 + 0.5 * torch.randn(c, generator=g)})
    module = PreNormResidual(c, LinearAttention(c, HEADS, DIM_HEAD))
    module.load_state_dict(prenorm_linear_attention_from_fused(block.state_dict()))
    return block.to(device), module.to(device)


def _image(batch: int, n: int, c: int, device, seed: int) -> torch.Tensor:
    """x ~ N(0, 1) [B, C, H, W] in channels_last memory, H = W = sqrt(N)."""
    side = math.isqrt(n)
    g = torch.Generator(device).manual_seed(seed)
    return torch.randn(batch, side, side, c, generator=g, device=device).permute(0, 3, 1, 2)


TWOPASS_MODULE = (16, 16384, 64)  # B, N, C of the module on the two-pass route


@torch.no_grad()
def la_main_path(device) -> dict:
    """Phase 16: this slice's path through its public entry points, launch
    counts set to 0 just before and read just after:
    - PreNormResidual(LinearAttention) (the UNet's attention before its fused
      block) at the ten attention levels of the UNet, B 64, f32 and bf16:
      the dispatcher's default route, #6;
    - the module at N 16384 (B 16, C 64) with CCDM_TPU_TWOPASS_ATTN's switch
      on: #7 + #8;
    - linear_attention_per_head on q, k, v at B 64, N 4096, bf16: #9;
    - bias_act(impl="auto") (lrelu, bias, default gain) at the three GAN
      maps, bf16: #12.
    Exactly one launch per call, none of #1-#5, #10, #11. Then the checks:
    per level, the module in f32 (TF32 off) against FusedLinearAttentionBlock
    on the same weights and x (kernel #6 against kernel #1), max abs diff
    <= 1e-4; in bf16 the module against itself on the plain route
    (CCDM_TPU_FUSED_ATTN=0) at phase 3's bound (rtol = atol = 3e-2, relative
    to max(|y|, |y - x|)), and its distance to #1's block recorded (the
    module's own bf16 layers round where #1 does not); the two-pass module
    against the plain route at the same bound; #9 and #12 against their
    plain versions as in phases 13 and 15."""
    levels = [(la_modules(c, 300 + i, device), _image(BATCH, n, c, device, 320 + i))
              for i, (n, c) in enumerate(FORWARD_SHAPES)]
    tb, tn, tc = TWOPASS_MODULE
    (_, tp_module), tp_x = la_modules(tc, 340, device), _image(tb, tn, tc, device, 341).bfloat16()
    q, k, v = la_inputs(LA_MAIN, torch.bfloat16, device, seed=342)
    g = torch.Generator(device).manual_seed(343)
    gan = [(torch.randn(64, math.isqrt(r // 64), math.isqrt(r // 64), c, generator=g,
                        device=device).bfloat16(), torch.randn(c, generator=g, device=device))
           for r, c in BIAS_ACT_SHAPES[:3]]

    routes = {f"N{n}_C{c}": {str(dt)[6:]: la_route((BATCH, n, HEADS, DIM_HEAD), dt)["route"]
                             for dt in (torch.float32, torch.bfloat16)}
              for n, c in FORWARD_SHAPES}
    _reset_counts()
    outs = [(module(x), module(x.bfloat16())) for (_, module), x in levels]
    with la_switches(twopass=True):
        tp_y = tp_module(tp_x)
    y9 = la.linear_attention_per_head(q, k, v)
    y12 = [so.bias_act(x, b, act="lrelu") for x, b in gan]
    torch.cuda.synchronize()
    counts = _counts()

    expected = {**{name: 0 for name in counts}, "linear_attention_fulllane": 2 * len(levels),
                "linear_attention_ctx_twopass": 1, "linear_attention_out_twopass": 1,
                "linear_attention_per_head": 1, "bias_act_fused": len(gan)}
    print(f"   launches {counts}", flush=True)
    if counts != expected:
        raise AssertionError(f"this slice's path launched {counts}, expected {expected}")

    result = {"launches": counts, "routes_of_6": routes, "levels": {}}
    for i, (((block, module), x), (y32, y16), (n, c)) in enumerate(zip(levels, outs,
                                                                      FORWARD_SHAPES)):
        xb = x.bfloat16()
        f32 = float((y32 - block(x)).abs().max())
        if not f32 <= 1e-4:
            raise AssertionError(f"module through #6 against #1's block, N={n} C={c}: f32 max "
                                 f"abs diff {f32:.3e} beyond 1e-4")
        with la_switches(kernels=False):
            want = module(xb)
        scale = torch.maximum(want.float().abs(), (want.float() - xb.float()).abs())
        bf16 = check_close(y16, want, 3e-2, 3e-2, f"module bf16 N={n} C={c}", scale=scale)
        result["levels"][f"{i}_N{n}_C{c}"] = {
            "f32_vs_block": f32, "bf16_vs_plain_route": bf16,
            "bf16_vs_block": float((y16.float() - block(xb).float()).abs().max())}
    with la_switches(kernels=False):
        want = tp_module(tp_x)
    scale = torch.maximum(want.float().abs(), (want.float() - tp_x.float()).abs())
    result["twopass_module_bf16_vs_plain_route"] = check_close(
        tp_y, want, 3e-2, 3e-2, "module on the two-pass route", scale=scale)
    want = la.linear_attention_reference(q, k, v)
    result["per_head_max_err"] = la_check(y9, want, "#9 on the path")
    result["per_head_rounding"] = check_rounding(y9, want, la.fulllane_reference(q, k, v),
                                                 "#9 on the path")
    result["bias_act_max_err"] = max(
        check_close(y, so.bias_act_fused_reference(x, b, "lrelu", 0.2, math.sqrt(2), -1.0),
                    8e-3, 8e-3, "#12 on the path") for y, (x, b) in zip(y12, gan))
    print(f"   {json.dumps(result)}", flush=True)
    return result


def la_grad_parity(device) -> dict:
    """Phase 17: one loss (mean squared error to a drawn target) + backward
    of PreNormResidual(LinearAttention(64)) at B 128 on the 64x64 map (N
    4096), f32 with TF32 off: kernel #6 forward with the plain backward
    against the all-plain route (CCDM_TPU_FUSED_ATTN=0) on the same x and
    target; every gradient (x and the five parameters) within 1e-3 of its
    largest |g|, the loss to 1e-5; one launch of #6, none on the plain route."""
    _, module = la_modules(64, 400, device)
    x = _image(TRAIN_BATCH, 4096, 64, device, 401)
    target = _image(TRAIN_BATCH, 4096, 64, device, 402)

    def loss_and_grads():
        module.zero_grad(set_to_none=True)
        xx = x.detach().clone().requires_grad_()
        loss = (module(xx) - target).square().mean()
        loss.backward()
        return loss.item(), {"x": xx.grad, **{name: p.grad.clone()
                                              for name, p in module.named_parameters()}}

    before = la.linear_attention_fulllane.launches
    loss_k, grads_k = loss_and_grads()
    with la_switches(kernels=False):
        loss_p, grads_p = loss_and_grads()
    if la.linear_attention_fulllane.launches - before != 1:
        raise AssertionError("the training step did not launch #6 exactly once")
    worst = 0.0
    for name, want in grads_p.items():
        scale = float(want.abs().max())
        diff = float((grads_k[name] - want).abs().max())
        if not diff <= 1e-3 * scale:
            raise AssertionError(f"grad {name}: max abs diff {diff:.3e} beyond 1e-3 x {scale:.3e}")
        worst = max(worst, diff / max(scale, 1e-30))
    print(f"   loss {loss_k:.6f} (plain {loss_p:.6f}); worst gradient {worst:.3e} of its "
          f"largest |g|", flush=True)
    if abs(loss_k - loss_p) > 1e-5 * abs(loss_p):
        raise AssertionError(f"loss {loss_k} against plain {loss_p}")
    return {"loss": loss_k, "loss_plain": loss_p, "worst_grad_rel_diff": worst}


PLAN_KEY = {"linear_attention_ctx_twopass": "plan7", "linear_attention_per_head": "plan9"}


def route_text(plan: dict) -> str:
    """A plan of #7 or #9 as its route and splits (#9: statistics/context/out)."""
    if "splits" in plan:
        return f"{plan['route']} x{plan['splits']}"
    return f"{plan['route']} {plan['stat_splits']}/{plan['ctx_splits']}/{plan['out_splits']}"


def slice4_kernel_rows(la_rows: dict, tp_rows: dict, ba_rows: dict, path: dict, grads: dict,
                       card: str) -> list:
    """The kernels-line entries of #6-#9 and #12."""
    b, n, h, d = LA_MAIN
    main = la_rows[f"B{b}_N{n}_H{h}_D{d}"]
    tp_main = tp_rows["B{}_N{}_chunk{}".format(*TWOPASS_SHAPES[0])]
    worst = lambda rows, keys: max(v for r in rows.values() for k, v in r["max_err"].items()
                                   if any(k.startswith(p) for p in keys) and k.endswith("bfloat16"))
    out = []
    for name in LA:
        timed = tp_main[name] if "twopass" in name else main[name]
        rows = tp_rows if "twopass" in name else la_rows
        keys = {"linear_attention_ctx_twopass": ("a_", "s_"),
                "linear_attention_out_twopass": ("out_",)}.get(name, (name,))
        out.append({
            "name": name, "route": "cuda", "source": "ccdm_tpu_torch/csrc/linear_attention.cu",
            "replaces": LA_REPLACES[name], "launches": path["launches"][name],
            "max_abs_err": worst(rows, keys), **timed, "library_ms": None,
            "ms_is": ("one call at B {}, N {}, H 4, D 32, chunk {}, bf16".format(
                *TWOPASS_SHAPES[0]) if "twopass" in name
                else f"one call at B {b}, N {n}, H {h}, D {d}, bf16"),
            **({"routes": {tag: route_text(r[PLAN_KEY[name]]["bfloat16"])
                           for tag, r in rows.items()}} if name in PLAN_KEY else {}),
            "by_shape": {tag: {**r.get(name, {}), "max_err": r["max_err"]}
                         for tag, r in rows.items()},
            "card": card})
    out[0]["module_path"] = path
    out[0]["module_grad_parity"] = grads
    out[1]["route_ms"] = tp_main["route_ms"]
    ba = ba_rows["{}x{}".format(*BIAS_ACT_MAIN)]
    out.append({
        "name": "bias_act_fused", "route": "cuda", "source": "ccdm_tpu_torch/csrc/style_ops.cu",
        "replaces": "ccdm_tpu/ops/style_ops.py:92", "launches": path["launches"]["bias_act_fused"],
        "max_abs_err": max(r["max_err"]["bfloat16"] for r in ba_rows.values()),
        **ba["bias_act_fused"],
        "ms_is": "one lrelu call, no bias, gain 1, no clamp (F.leaky_relu's function), "
                 "[{}, {}] bf16".format(*BIAS_ACT_MAIN),
        "by_shape": ba_rows, "card": card})
    return out


# ------------------------------------------------------ data parallelism

DP_RUN = Path(__file__).resolve().parent / "build" / "smoke_dp"
DP_WORLD1_STEPS = 5
DP_STEPS = 3   # the two-rank steps, 64 rows a rank
DP_LR = 1e-4   # TRAIN_ARGV's --train_lr
# the Gaussian-Fourier label embedding (what --label_embed random selects):
# with the sinusoidal one a batch's conditioning BatchNorm input varies so
# little that mean(x^2) - mean(x)^2 is mostly rounding, and the weights
# upstream of it move apart under any two reduction orders
# (scripts/dp_grad_gap.py on the CPU at dim 8: their mean error 0.31 of
# their movement after 3 steps, against 8.4e-03 with this embedding)
DP_ARGV = [*TRAIN_ARGV, "--niters", str(DP_WORLD1_STEPS), "--save_every", str(DP_WORLD1_STEPS),
           "--log_every", "1", "--y2h_embed_type", "gaussian"]
# one CcGAN iteration at JAX's default SNGAN widths, batch 64 (32 a rank),
# 2 D steps, the sinusoidal y2h (no ILI nets to train)
DP_CCGAN_ARGV = [*BASE_COMMON, "--gan_arch", "sngan", "--gene_ch", "64", "--disc_ch", "64",
                 "--dim_gan", "256", "--batch_size_disc", "64", "--batch_size_gene", "64",
                 "--num_D_steps", "2", "--loss_type", "hinge", "--threshold_type", "hard",
                 "--gan_DiffAugment", "--y2h_embed_type", "sinusoidal", "--niters", "1"]
DP_CCGAN_LR = 1e-4  # ccgan_main's default --lr_g and --lr_d
# the two ranks against one process: a rank runs its convs on half the
# batch and the BatchNorm sums over the ranks, so they round apart.
# - the losses: the first (no update yet) within 2^-7 relative in bf16 (two
#   bf16 units) and 1e-5 in f32 (TF32 off); the later ones, after Adam's
#   sign steps on the elements whose gradient lies within rounding of 0
#   parted the weights, within DP_LATER_RTOL (about 3x and 10x the H100
#   readings, 3.72e-03 in bf16 and 9.16e-05 in f32);
# - the gradients summed over the ranks, before the clip and Adam: the
#   UNet's first step, and each of CcGAN's three (its G step is the one
#   through the ConditionalBatchNorm): each leaf within DP_GRAD_RTOL of
#   max(its largest |g|, DP_GRAD_FLOOR of the step's largest). Both are
#   ReLU nets: where a leaf's gradient sums few terms (a bias at 4x4), a
#   unit that f32 rounding moves across 0 moves it by ~1e-3 of its scale,
#   so two reductions of one batch part by 1e-2 (the readings: 1.55e-02
#   bf16, 1.96e-02 f32 on an H100; 1.11e-02 for CcGAN on the CPU at these
#   widths). 5e-2 lies below what a wrong reduction gives (H100 readings
#   of scripts/dp_grad_gap.py, which puts each fault in at run time):
#   gradients averaged where they are summed 0.5, the gather's backward on
#   the other rank's rows 0.345 and up, BatchNorm sums whose backward is
#   not all-reduced 51 and up;
# - the parameters by tests/test_torch_parallel_trainers.py's Adam rule:
#   every element within 2.006 lr a step (Adam's bias-corrected step is at
#   most 1.003 lr at t <= 3), and each leaf's mean error within 0.1 of its
#   mean movement where its first moment is at least 1e-4 of the largest;
# - the f32 statistics within 1e-4 relative to max(1, |x|).
DP_LOSS_RTOL = {"bf16": 2.0 ** -7, "f32": 1e-5}
DP_LATER_RTOL = {"bf16": 1e-2, "f32": 1e-3}
DP_GRAD_RTOL = 5e-2
DP_GRAD_FLOOR = 1e-3
DP_ADAM_CEILING = 2.006
DP_PER_STEP = {"attn_block": 8, **{k: 2 for k in LARGE}}  # launches a train step, each rank
FOLD_TOL = {"float32": 2e-5, "bfloat16": 5e-2}  # tests/test_upsample_fold.py's bounds


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _cuda_env() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _main_run(root: Path, env: dict, device) -> dict:
    """`python -m ccdm_tpu_torch.main` with DP_ARGV in its own process; its
    stdout and the milestone's parameters and statistics."""
    repo = Path(__file__).resolve().parent
    proc = subprocess.run([sys.executable, "-m", "ccdm_tpu_torch.main", "--root_path", str(root),
                           "--device", device.type, *DP_ARGV], cwd=repo, capture_output=True,
                          text=True, timeout=300, env={**os.environ, **env})
    if proc.returncode != 0:
        raise AssertionError(f"main.py failed ({proc.returncode}):\n{proc.stdout[-3000:]}\n"
                             f"{proc.stderr[-3000:]}")
    from ccdm_tpu_torch import main as port_main

    results = Path(port_main.results_folder(parse_opts(
        ["--root_path", str(root), "--device", device.type, *DP_ARGV])))
    tree = torch.load(results / f"model-{DP_WORLD1_STEPS}" / "state.pt", weights_only=False)
    return {"stdout": proc.stdout, "tensors": [*tree["params"], *tree["batch_stats"]]}


def _max_diff(a: list, b: list) -> float:
    return max(float((x.float() - y.float()).abs().max()) for x, y in zip(a, b))


def world1_nccl(device, card: str) -> dict:
    """(a) main.py under the env triplet at world size 1 (NCCL), against the
    same argv without it; the bound is twice the spread of two runs without
    it (cuDNN's weight-gradient algorithms need not be deterministic), and
    exact equality where that spread is 0."""
    with ThreadPoolExecutor(2) as pool:  # the two runs without it share the card at once
        plain = list(pool.map(lambda i: _main_run(DP_RUN / f"plain{i}", {}, device), range(2)))
    triplet = _main_run(DP_RUN / "world1", {"CCDM_COORD_ADDR": f"localhost:{_free_port()}",
                                           "CCDM_NUM_PROCS": "1", "CCDM_PROC_ID": "0"},
                        device)
    line = [ln for ln in triplet["stdout"].splitlines() if "torch.distributed:" in ln]
    want = "nccl" if device.type == "cuda" else "gloo"
    backend = want if line and f"({want})" in line[0] else (line[0] if line else "none")
    spread = _max_diff(plain[0]["tensors"], plain[1]["tensors"])
    diff = _max_diff(plain[0]["tensors"], triplet["tensors"])
    bound = 2 * spread
    print(f"   (a) {line[0].strip() if line else 'no bootstrap line'}; {DP_WORLD1_STEPS} steps, "
          f"batch {TRAIN_BATCH}, bf16: parameters and BatchNorm statistics differ from the "
          f"run without the triplet by {diff:.3e} (bound {bound:.3e}: twice the spread "
          f"{spread:.3e} of two runs without it) on {card}", flush=True)
    if backend != want or diff > bound:
        raise AssertionError(f"world 1: backend {backend}, diff {diff} > bound {bound}")
    return {"backend": backend, "max_abs_diff": diff, "spread": spread, "bound": bound}


def _cpu(ts) -> list:
    """f32 copies on the host (copies on the CPU too: the steps work in place)."""
    return [t.detach().to("cpu", torch.float32, copy=True) for t in ts]


@contextlib.contextmanager
def summed_grads(module, first: int):
    """The gradients that `module`'s steps take from all_reduce_grads
    (summed over the ranks, before the clip and Adam): CPU f32 copies of
    its first `first` calls."""
    real, seen = module.all_reduce_grads, []

    def spy(mesh, grads):
        out = real(mesh, grads)
        if len(seen) < first:
            seen.append(_cpu(out))
        return out

    module.all_reduce_grads = spy
    try:
        yield seen
    finally:
        module.all_reduce_grads = real


def dp_unet_steps(device, mesh, root: Path, argv: list) -> dict:
    """DP_STEPS train steps of main.py's Trainer on `mesh`, each drawn from
    the generator Trainer.train gives it; #1-#5 counted from 0 and their
    launch shapes recorded; the first step's summed gradients."""
    from ccdm_tpu_torch import main as port_main
    from ccdm_tpu_torch.training import trainer as trainer_mod
    from ccdm_tpu_torch.training.trainer import chunk_seed

    args = parse_opts(["--root_path", str(root), "--device", str(device), *argv])
    trainer, _, fn_y2h, _ = port_main.build_trainer(args, device, mesh)
    losses, step_ms = [], []
    init = _cpu(trainer.state.model.parameters())
    _reset_counts()
    with attn_shapes() as shapes, large_shapes() as big, summed_grads(trainer_mod, 1) as summed:
        for step in range(DP_STEPS):
            gen = torch.Generator(device=device).manual_seed(chunk_seed(args.seed, step))
            t0 = time.perf_counter()
            losses.append(float(trainer.train_step(fn_y2h, gen)))  # float() waits for the card
            step_ms.append((time.perf_counter() - t0) * 1e3)
    counts = {k: v for k, v in _counts().items() if k in ("attn_block", *LARGE)}
    s = trainer.state
    out = {"losses": losses, "step_ms": step_ms}
    if mesh.size > 1:  # the gradients' all-reduce alone, host clock, 3 calls after one
        from ccdm_tpu_torch.parallel.mesh import all_reduce_grads

        grads = [torch.zeros_like(p) for p in s.model.parameters()]
        all_reduce_grads(mesh, grads)
        t0 = time.perf_counter()
        for _ in range(3):
            all_reduce_grads(mesh, grads)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        out["all_reduce_ms"] = (time.perf_counter() - t0) / 3 * 1e3
        out["all_reduce_bytes"] = sum(g.numel() * g.element_size() for g in grads)
    return {**out, "params": _cpu(s.model.parameters()), "init": init, "mu": _cpu(s.mu),
            "steps": [DP_STEPS] * len(init), "grads": summed,
            "stats": _cpu(b for b in s.model.buffers() if b.is_floating_point()),
            "counts": counts, "shapes": sorted(shapes), "large_shapes": sorted(big)}


def dp_ccgan_iteration(device, mesh, root: Path, argv: list) -> dict:
    """One CcGAN iteration (2 D steps, one G step) of ccgan_main's trainer on
    `mesh`, drawn from step_generator(seed, 0) as CcGANTrainer.train does."""
    from ccdm_tpu_torch import ccgan_main
    from ccdm_tpu_torch.training import ccgan as ccgan_mod
    from ccdm_tpu_torch.training.dmd import stats_of
    from ccdm_tpu_torch.training.optim import step_generator

    args = ccgan_main.parse_opts_ccgan(["--root_path", str(root), "--device", str(device),
                                        *argv])
    trainer = ccgan_main.build_trainer(args, device, mesh)[0]
    gen = step_generator(args.seed, 0, device)
    init = _cpu([*trainer.g_params, *trainer.d_params])
    with summed_grads(ccgan_mod, args.num_D_steps + 1) as grads:
        d = [float(trainer.d_step(trainer.uses_nda(0), gen)) for _ in range(args.num_D_steps)]
        g = float(trainer.g_step(gen))
    steps = [1] * len(trainer.g_params) + [args.num_D_steps] * len(trainer.d_params)
    return {"losses": [*d, g], "params": _cpu([*trainer.g_params, *trainer.d_params]),
            "init": init, "mu": _cpu([*trainer.g_opt.mu, *trainer.d_opt.mu]), "steps": steps,
            "grads": grads, "stats": _cpu([*stats_of(trainer.netG), *stats_of(trainer.netD)])}


def _dp_rank(rank: int, port: int, out: str, device: str, argv: list,
             ccgan_argv: list) -> None:
    """One of two ranks on `device` (cuda:0), joined over gloo (NCCL refuses
    two ranks on one card): dp_unet_steps and dp_ccgan_iteration on their
    mesh."""
    import torch.distributed as dist
    from ccdm_tpu_torch.parallel.mesh import create_mesh

    _cuda_env()
    device = torch.device(device)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=2,
                            rank=rank)
    try:
        mesh = create_mesh(devices=[device, device])
        result = {"unet": dp_unet_steps(device, mesh, Path(out) / f"unet_rank{rank}", argv),
                  "ccgan": dp_ccgan_iteration(device, mesh, Path(out) / f"ccgan_rank{rank}",
                                              ccgan_argv)}
        torch.save(result, Path(out) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _two_ranks(out: Path, device) -> list:
    """Spawn the two ranks and wait for them (at most 600 s); the ranks'
    results."""
    import torch.multiprocessing as mp

    device = "cuda:0" if device.type == "cuda" else str(device)
    ctx = mp.start_processes(_dp_rank, args=(_free_port(), str(out), device, DP_ARGV,
                                             DP_CCGAN_ARGV), nprocs=2, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + 600
    try:
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                raise TimeoutError("the two ranks did not finish within 600 s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(2)]


def _grad_errors(got: list, want: list) -> list:
    """Each leaf's max |got - want| over max(its largest |want|,
    DP_GRAD_FLOOR of the list's largest)."""
    largest = max(float(w.abs().max()) for w in want)
    return [float((g - w).abs().max()) / max(float(w.abs().max()), DP_GRAD_FLOOR * largest)
            for g, w in zip(got, want)]


def _adam_rule(got: dict, one: dict, lr: float) -> dict:
    """tests/test_torch_parallel_trainers.py's Adam rule: each element
    within DP_ADAM_CEILING lr a step, and each leaf's mean error within 0.1
    of its mean movement where its first moment is at least 1e-4 of the
    largest (elsewhere the gradient is ~0 and Adam's step is its sign)."""
    largest = max(float(m.abs().max()) for m in one["mu"])
    ceiling, mean_ratio, checked = 0.0, 0.0, 0
    for g, w, p0, m, n in zip(got["params"], one["params"], one["init"], one["mu"],
                              one["steps"]):
        err = (g - w).abs()
        ceiling = max(ceiling, float(err.max()) / (DP_ADAM_CEILING * lr * n))
        if float(m.abs().max()) >= 1e-4 * largest:
            mean_ratio = max(mean_ratio, float(err.mean()) / float((w - p0).abs().mean()))
            checked += 1
    return {"ceiling": ceiling, "mean_ratio": mean_ratio, "checked": checked,
            "leaves": len(one["params"])}


def _hold_ranks(what: str, ranks: list, one: dict, dtype: str, lr: float,
                stat_tol: float | None, held_grads: int = 1) -> dict:
    """The two ranks bit for bit against each other (losses, summed
    gradients, parameters, statistics), and against the one process: the
    first loss within DP_LOSS_RTOL, the later ones within DP_LATER_RTOL, the
    first `held_grads` steps' summed gradients by leaf within DP_GRAD_RTOL,
    the parameters by _adam_rule, the statistics within stat_tol (relative
    to max(1, |x|)) where given."""
    a, b = ranks
    equal = (all(torch.equal(x, y) for key in ("params", "stats")
                 for x, y in zip(a[key], b[key])) and a["losses"] == b["losses"]
             and all(torch.equal(x, y) for ga, gb in zip(a["grads"], b["grads"])
                     for x, y in zip(ga, gb)))
    rel = [abs(x - y) / max(abs(y), 1e-12) for x, y in zip(a["losses"], one["losses"])]
    grads = [max(_grad_errors(ga, g1)) for ga, g1 in zip(a["grads"], one["grads"])]
    adam = _adam_rule(a, one, lr)
    stat_err = max(float(((x - y).abs() / y.abs().clamp_min(1.0)).max())
                   for x, y in zip(a["stats"], one["stats"]))
    print(f"   {what}: losses two ranks {[round(v, 6) for v in a['losses']]}, one process "
          f"{[round(v, 6) for v in one['losses']]} (rel {[f'{v:.2e}' for v in rel]}; bounds "
          f"{DP_LOSS_RTOL[dtype]:.2e} first, {DP_LATER_RTOL[dtype]:.0e} after an update); "
          f"summed gradients, the worst leaf of each step {[f'{v:.2e}' for v in grads]} (bound "
          f"{DP_GRAD_RTOL:.0e} on the first {held_grads}); parameters: the worst element "
          f"{adam['ceiling']:.3f} of {DP_ADAM_CEILING} lr a step, the worst leaf's mean error "
          f"{adam['mean_ratio']:.3e} of its movement (bound 0.1, {adam['checked']} of "
          f"{adam['leaves']} leaves held); statistics max rel {stat_err:.2e}; ranks bit-equal: "
          f"{equal}", flush=True)
    if not equal:
        raise AssertionError(f"{what}: the two ranks disagree")
    if rel[0] > DP_LOSS_RTOL[dtype] or max(rel[1:]) > DP_LATER_RTOL[dtype]:
        raise AssertionError(f"{what}: loss rel {rel}")
    if max(grads[:held_grads]) > DP_GRAD_RTOL:
        raise AssertionError(f"{what}: summed gradients {grads}")
    if adam["ceiling"] > 1 or adam["mean_ratio"] > 0.1 or 2 * adam["checked"] < adam["leaves"]:
        raise AssertionError(f"{what}: parameters {adam}")
    if stat_tol is not None and stat_err > stat_tol:
        raise AssertionError(f"{what}: statistics {stat_err} > {stat_tol}")
    return {"ranks_equal": equal, "loss_rel": rel, "grad_rel": grads, "adam": adam,
            "stat_max_rel": stat_err, "losses": a["losses"], "losses_one": one["losses"]}


def two_ranks_and_ccgan(device, card: str, record: dict, parts) -> None:
    """(b) two ranks on cuda:0 over gloo against one process: DP_STEPS train
    steps at the flagship's width, 64 rows a rank; (c) one CcGAN iteration."""
    from ccdm_tpu_torch.parallel.mesh import Mesh

    ranks = _two_ranks(DP_RUN / "ranks", device)
    one_mesh = Mesh(device=device)
    if "two_ranks" in parts:
        one = dp_unet_steps(device, one_mesh, DP_RUN / "unet_one", DP_ARGV)
        got = _hold_ranks("(b) train steps", [r["unet"] for r in ranks], one, "bf16", DP_LR,
                          None)
        per_step = {k: v * DP_STEPS for k, v in DP_PER_STEP.items()}
        for r, rank in enumerate(ranks):
            counts = rank["unet"]["counts"]
            if counts != per_step:
                raise AssertionError(f"rank {r}: launches {counts}, expected {per_step}")
        shapes = {tuple(s) for r in ranks for s in r["unet"]["shapes"]}
        big = {tuple(s) for r in ranks for s in r["unet"]["large_shapes"]}
        rank0 = ranks[0]["unet"]
        got.update(launches_per_rank=rank0["counts"], attn_shapes=checked_in_phase_3(shapes),
                   large_shapes=checked_in_phase_6(big), step_ms=rank0["step_ms"],
                   step_ms_one=one["step_ms"], all_reduce_ms=rank0["all_reduce_ms"],
                   all_reduce_bytes=rank0["all_reduce_bytes"])
        print(f"   (b) launches per rank {got['launches_per_rank']} over {DP_STEPS} steps; #1 "
              f"at {got['attn_shapes']} (phase 3), #2-#5 at {got['large_shapes']} (phase 6); "
              f"steps {[round(v, 1) for v in rank0['step_ms']]} ms on two ranks, "
              f"{[round(v, 1) for v in one['step_ms']]} on one (host clock); the gradients' "
              f"all-reduce over gloo {rank0['all_reduce_ms']:.1f} ms for "
              f"{rank0['all_reduce_bytes'] / 1e6:.1f} MB on {card}", flush=True)
        record["two_ranks"] = got
    if "ccgan" in parts:
        one = dp_ccgan_iteration(device, one_mesh, DP_RUN / "ccgan_one", DP_CCGAN_ARGV)
        record["ccgan"] = _hold_ranks("(c) CcGAN iteration", [r["ccgan"] for r in ranks], one,
                                      "f32", DP_CCGAN_LR, 1e-4, held_grads=3)


def native_gather_check(device, record: dict, folder: str) -> None:
    """(d) the synthetic bundle written to a native cache, a batch of
    TRAIN_BATCH gathered into pinned memory, copied to the card and held to
    the bank there (exact; with the flip, each image the bank's or its
    mirror)."""
    from ccdm_tpu_torch.data.datasets import load_dataset
    from ccdm_tpu_torch.data.native_loader import NativeDatasetCache

    bundle = load_dataset("synthetic", None, image_size=64, channels=3)
    path = str(Path(folder) / "bank.ccdmcache")
    NativeDatasetCache.write(path, bundle.images, bundle.labels_norm)
    cache = NativeDatasetCache(path)
    bank = torch.from_numpy(bundle.images).to(device)
    idx = np.random.default_rng(0).integers(0, len(bundle.images), TRAIN_BATCH)
    pin = device.type == "cuda"
    imgs = torch.empty((TRAIN_BATCH, *bundle.images.shape[1:]), dtype=torch.uint8,
                       pin_memory=pin)
    labs = torch.empty((TRAIN_BATCH, cache.ldim), dtype=torch.float32, pin_memory=pin)
    gather_ms = host_ms(lambda: cache.gather(idx, out=(imgs, labs)), reps=10, warmup=2)
    copy_ms = time_ms(lambda: imgs.to(device, non_blocking=True), reps=10, warmup=2)
    on_card = imgs.to(device, non_blocking=True)
    want = bank[torch.from_numpy(idx).to(device)]
    exact = bool(torch.equal(on_card, want)) and bool(torch.equal(
        labs, torch.from_numpy(np.asarray(bundle.labels_norm, np.float32).reshape(
            len(bundle.images), -1)[idx])))
    flipped = cache.gather(idx, hflip=True, seed=1, out=(imgs, labs))[0].to(device)
    mirror = bool(((flipped == want).flatten(1).all(1) | (flipped == want.flip(2)).flatten(1)
                   .all(1)).all())
    nbytes = imgs.numel()
    print(f"   (d) native cache of {len(bundle.images)} images: a batch of {TRAIN_BATCH} "
          f"gathered into pinned memory in {gather_ms:.3f} ms (host clock), copied to the card "
          f"in {copy_ms:.3f} ms ({nbytes / copy_ms / 1e6:.2f} GB/s); equal to the bank on the "
          f"card: {exact}; flipped batch the bank's or its mirror: {mirror}", flush=True)
    if not (exact and mirror):
        raise AssertionError("the native gather disagrees with the bank")
    record["native_gather"] = {"exact": exact, "mirror": mirror, "gather_ms": gather_ms,
                               "copy_ms": copy_ms, "bytes": nbytes}


def upsample_fold_check(device, record: dict, variants=("conv3", "conv2x3")) -> None:
    """(e) the flagship UNet's Upsample levels with a source of 32^2 and up
    (its B-64 forward's shapes): the fold of each variant against the
    reference route, f32 (TF32 off) and bf16, both timed in bf16. The UNet
    itself keeps the reference route (ops/upsample_fold.py)."""
    from ccdm_tpu_torch.models.layers import Upsample
    from ccdm_tpu_torch.ops import upsample_fold as uf

    model = Unet(**UNET, seed=0).to(device, memory_format=torch.channels_last).eval()
    levels, hooks = [], []
    for m in model.modules():
        if isinstance(m, Upsample):
            hooks.append(m.register_forward_hook(
                lambda mod, inp, out: levels.append((mod, tuple(inp[0].shape)))))
    gen = torch.Generator(device=device).manual_seed(3)
    x = torch.randn(BATCH, 64, 64, 3, device=device, generator=gen)
    t = torch.randint(0, 1000, (BATCH,), device=device, generator=gen)
    emb = torch.randn(BATCH, 128, device=device, generator=gen)
    keep = torch.ones(BATCH, dtype=torch.bool, device=device)
    with torch.no_grad():  # the levels' input shapes
        model(x, t, emb, keep)
    for h in hooks:
        h.remove()
    big = [(m, s) for m, s in levels if s[2] * s[3] >= 32 * 32]
    rows, out = {}, {"bound": max(FOLD_TOL.values())}
    for variant in variants:
        for m, shape in big:
            tag = f"{variant} B{shape[0]} C{shape[1]}->{m.conv.out_channels} {shape[2]}x{shape[3]}"
            row = {}
            for dt in (torch.float32, torch.bfloat16):
                xin = torch.randn(shape, device=device, generator=gen).to(dt)
                with torch.no_grad():
                    got = uf.upsample_conv3x3_folded(xin, m.conv.weight, m.conv.bias, variant)
                    ref = uf.upsample_conv3x3_reference(xin, m.conv.weight, m.conv.bias)
                name = str(dt).removeprefix("torch.")
                err = float((got.float() - ref.float()).abs().max() /
                            max(1.0, float(ref.float().abs().max())))
                row[f"err_{name}"] = err
                if err > FOLD_TOL[name]:
                    raise AssertionError(f"fold {tag} {name}: {err} > {FOLD_TOL[name]}")
                if dt == torch.bfloat16:
                    with torch.no_grad():
                        row["ms"] = time_ms(lambda: uf.upsample_conv3x3_folded(
                            xin, m.conv.weight, m.conv.bias, variant))
                        row["reference_ms"] = time_ms(lambda: uf.upsample_conv3x3_reference(
                            xin, m.conv.weight, m.conv.bias))
            rows[tag] = row
            print(f"   (e) {tag}: f32 err {row['err_float32']:.2e} (bound "
                  f"{FOLD_TOL['float32']:.0e}), bf16 err {row['err_bfloat16']:.2e} (bound "
                  f"{FOLD_TOL['bfloat16']:.0e}); bf16 fold {row['ms']:.4f} ms, reference "
                  f"{row['reference_ms']:.4f} ms", flush=True)
        out[variant] = {"levels": {k: v for k, v in rows.items() if k.startswith(variant)},
                        "max_abs_err": max(v["err_bfloat16"] for k, v in rows.items()
                                           if k.startswith(variant))}
    record["upsample_fold"] = out


def data_parallel_path(device, card: str, record: dict,
                       parts=("world1", "two_ranks", "ccgan", "native", "fold")) -> dict:
    """Phase 26 (module docstring); build/smoke_dp is deleted after."""
    shutil.rmtree(DP_RUN, ignore_errors=True)
    DP_RUN.mkdir(parents=True)
    if device.type == "cuda":  # the earlier phases' cached blocks, for the phase's processes
        torch.cuda.empty_cache()
        free, total = torch.cuda.mem_get_info(device)
        print(f"   this process holds {torch.cuda.memory_allocated(device) / 2**30:.2f} GiB; "
              f"{free / 2**30:.2f} of {total / 2**30:.2f} GiB free on the card", flush=True)
    t0 = time.perf_counter()
    try:
        if "world1" in parts:
            record["world1"] = world1_nccl(device, card)
        if "two_ranks" in parts or "ccgan" in parts:
            two_ranks_and_ccgan(device, card, record, parts)
        if "native" in parts:
            native_gather_check(device, record, str(DP_RUN))
        if "fold" in parts:
            upsample_fold_check(device, record)
    finally:
        shutil.rmtree(DP_RUN, ignore_errors=True)
    record["seconds"] = time.perf_counter() - t0
    print(f"   phase 26 took {record['seconds']:.1f} s", flush=True)
    return record


def main() -> int:
    faulthandler.dump_traceback_later(1100, exit=True)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on the card",
              file=sys.stderr)
        return 1
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase("1/26 device")
    card = card_line()
    print(f"   {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)

    phase("2/26 build")
    libraries = ("attn_block", "attn_block_large", "resnet_block", "linear_attention",
                 "style_ops")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libraries)) as pool:  # one nvcc per source, all at once
        list(pool.map(_build.build, libraries))
    for name in libraries:
        _build.load(name)
    print(f"   {', '.join(libraries)} built and loaded in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for name in libraries:
        for line in _build.BUILD_LOGS.get(name, "").splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print("   " + line.strip(), flush=True)

    phase("3/26 attn_block kernel against its plain version")
    rows, rows_by_batch = kernel_vs_plain(device)

    phase("4/26 full-width UNet and sampler, kernel against plain attention (f32)")
    parity = model_parity(device)

    phase("5/26 main path: SamplerService over HTTP, bf16, batch 32, 250 DDIM steps")
    served = serve_main_path(device, card)

    phase("6/26 kernels #2-#5 against their plain versions at the UNets' two-pass shapes, "
          "bf16 and f32")
    large_rows = large_vs_plain(device)
    two_vs_one = two_pass_vs_single_pass(device)
    other_dim_head = dim_head_vs_plain(device)

    phase("7/26 full-width f32 UNet, one loss + backward, kernels against plain attention")
    grads = grad_parity(device)
    grads_hy = grad_parity(device, use_hy=True)

    phase(f"8/26 main path: training, batch {TRAIN_BATCH}, bf16, {TRAIN_STEPS} steps, then "
          "serving from its milestone")
    trained = train_main_path(
        device, card, TRAIN_ARGV, TRAIN_STEPS,
        {"attn_block": 8 * TRAIN_STEPS + ATTN_BLOCKS * EVAL_FORWARDS,
         **{k: 2 * TRAIN_STEPS for k in LARGE}, **{k: 0 for k in (*RESNET, *NEW_KERNELS)}},
        False, train_checks(card))

    phase("9/26 kernels #10 and #11 (the fused resnet block) against their plain versions, "
          "f32 and bf16")
    resnet_rows = resnet_vs_plain(device)

    phase("10/26 full-width f32 UNet and sampler, CCDM_TPU_FUSED_RESBLOCK on against off")
    fused_parity = fused_model_parity(device)

    phase(f"11/26 main path with the switch on: SamplerService over HTTP, bf16, batch "
          f"{SERVE_BATCH}, {FUSED_STEPS} DDIM steps; then --sampler ddpm")
    fused_served = fused_serve_main_path(device, card)

    phase(f"12/26 main path with the switch on: training, batch {TRAIN_BATCH}, bf16, "
          f"{FUSED_TRAIN_STEPS} steps, its EMA grid and the sampling after training")
    fused_trained = train_main_path(
        device, card, FUSED_TRAIN_ARGV, FUSED_TRAIN_STEPS,
        {"attn_block": 8 * FUSED_TRAIN_STEPS
         + ATTN_BLOCKS * (FUSED_TRAIN_FORWARDS - FUSED_TRAIN_STEPS),
         **{k: 2 * FUSED_TRAIN_STEPS for k in LARGE},
         **{k: RESNET_BLOCKS * FUSED_TRAIN_FORWARDS for k in RESNET},
         **{k: 0 for k in NEW_KERNELS}},
        True, fused_train_checks(card))

    phase("13/26 kernels #6 and #9 (standalone linear attention) against their plain versions")
    la_rows = la_vs_plain(device)

    phase("14/26 kernels #7 + #8 (its two-pass form) against their plain versions")
    tp_rows = twopass_vs_plain(device)

    phase("15/26 kernel #12 (bias_act) against its plain version")
    ba_rows = bias_act_vs_plain(device)

    phase("16/26 this slice's path: PreNormResidual(LinearAttention) at the UNet's ten levels, "
          "the two-pass route, linear_attention_per_head, bias_act")
    la_path = la_main_path(device)

    phase("17/26 PreNormResidual(LinearAttention), one f32 loss + backward, B 128, N 4096, "
          "kernel forward against the plain route")
    la_grads = la_grad_parity(device)

    phase(f"18/26 the CCDM recipe: resnet ILI + H(y) through training, batch {TRAIN_BATCH}, "
          f"bf16, {RECIPE_STEPS} steps, then serving from its milestone")
    recipe = train_main_path(
        device, card, RECIPE_ARGV, RECIPE_STEPS,
        {"attn_block": 8 * RECIPE_STEPS + ATTN_BLOCKS * EVAL_FORWARDS,
         **{k: 2 * RECIPE_STEPS for k in LARGE}, **{k: 0 for k in (*RESNET, *NEW_KERNELS)}},
        False, recipe_checks(card, trained["train_images_per_s"]))

    phase(f"19/26 the rest of main.py's training entry: (a) multi-dim labels (synthetic_power, "
          f"{MULTIDIM_DIMS} dims, shv, resnet ILI, cross_attention), batch {TRAIN_BATCH}, bf16, "
          f"{MULTIDIM_STEPS} steps; (a') the same with the sinusoidal y2h, {ANALYTIC_STEPS} "
          f"steps; (b) the elastic aux loss, the trajectory GIF and the interpolation, "
          f"{AUX_STEPS} steps")
    others = {k: 0 for k in (*RESNET, *NEW_KERNELS)}
    with attn_shapes() as shapes:
        with sliced_widths() as widths:
            multidim = train_main_path(
                device, card, MULTIDIM_ARGV, MULTIDIM_STEPS,
                {"attn_block": 8 * MULTIDIM_STEPS + ATTN_BLOCKS * MULTIDIM_FORWARDS,
                 **{k: 2 * MULTIDIM_STEPS for k in LARGE}, **others},
                False, multidim_checks(card, trained["train_images_per_s"], widths))
        with sliced_widths() as widths:
            analytic = train_main_path(
                device, card, ANALYTIC_ARGV, ANALYTIC_STEPS,
                {"attn_block": 8 * ANALYTIC_STEPS + ATTN_BLOCKS * ANALYTIC_FORWARDS,
                 **{k: 2 * ANALYTIC_STEPS for k in LARGE}, **others},
                False, analytic_checks(widths))
        with artifact_passes({}) as passes:
            aux_run = train_main_path(
                device, card, AUX_ARGV, AUX_STEPS,
                {"attn_block": 8 * AUX_STEPS + ATTN_BLOCKS * AUX_FORWARDS,
                 **{k: 2 * AUX_STEPS for k in LARGE}, **others},
                False, aux_checks(card, passes))
    multidim["analytic_y2h"] = analytic
    multidim["attn_shapes"] = checked_in_phase_3(shapes)
    print(f"   #1 launched at (B, N, C, dtype) {multidim['attn_shapes']} in this phase, each "
          f"checked against its plain version in phase 3", flush=True)

    phase(f"20/26 the eval protocol: SteeringAngle 64x64 built in memory (signed labels), "
          f"training, batch {TRAIN_BATCH}, bf16, {EVAL_STEPS} steps, {len(EVAL_ANGLES)} labels x "
          f"{EVAL_NFAKE} images at 10 DDIM steps, then --comp_FID with PRDC, NIQE, iFID and "
          f"the analyses")
    try:
        with attn_shapes() as shapes, eval_in_memory({}) as record, \
                pytorch_precision_defaults():
            eval_run = train_main_path(
                device, card, EVAL_ARGV, EVAL_STEPS,
                {"attn_block": 8 * EVAL_STEPS + ATTN_BLOCKS * EVAL_SAMPLE_FORWARDS,
                 **{k: 2 * EVAL_STEPS for k in LARGE}, **others},
                False, eval_checks(card, record), keep=True)
        eval_run["attn_shapes"] = checked_in_phase_3(shapes)
        print(f"   #1 launched at (B, N, C, dtype) {eval_run['attn_shapes']} in this phase, each "
              f"checked against its plain version in phase 3", flush=True)
    except BaseException:
        shutil.rmtree(EVAL_RUN, ignore_errors=True)
        raise

    phase(f"21/26 DMD2-M: dmd_main on phase 20's run (its milestone the f32 teacher, its "
          f"backbones), SNGAN 64/64/256, batch {TRAIN_BATCH}, 2 D steps, DiffAugment, "
          f"{DMD_STEPS} iterations, {len(EVAL_ANGLES)} labels x {DMD_NFAKE} one-step images, "
          f"--comp_FID ({DMD_CENTERS} windows), --interpolation --sefa; SAGAN "
          f"{DMD_SAGAN_STEPS} iterations; serve_dmd over HTTP")
    dmd = dmd_main_path(device, card, eval_run)
    print(f"   #1 launched at (B, N, C, dtype) {dmd['attn_shapes']} in this phase, each checked "
          f"against its plain version in phase 3", flush=True)

    phase(f"22/26 the ADM and ViT denoisers: main.py --architecture adm (64, 1_2_4_8, attention "
          f"at 4_8), batch {TRAIN_BATCH}, {ADM_STEPS} steps, then --architecture vit (width 512, "
          f"8 blocks, 4096 tokens), batch {VIT_BATCH}, {VIT_STEPS} steps; each sampled, served "
          f"over HTTP and held against the CPU")
    denoisers = denoisers_main_path(device, card)

    phase(f"23/26 the baselines: (a) ccgan_main SNGAN 64/64/256, batch 64, hard, Dual-NDA "
          f"from iteration 10, {BASE_GAN_STEPS} iterations in two calls, (a') SAGAN soft "
          f"vanilla, {BASE_SHORT_STEPS} iterations; (b) classgan_main studiogan D2D-CE "
          f"{BASE_GAN_STEPS} and ADC {BASE_SHORT_STEPS} iterations; (c) cfg and (d) admg: the "
          f"class UNet (32, 1_2_2_4, f32), batch {BASE_TRAIN_BATCH}, {BASE_DIFF_STEPS} steps, "
          f"{BASE_FAKES} fakes at {BASE_SAMPLE_STEPS} steps")
    baselines = baselines_main_path(device, card)

    phase("24/26 kernels")
    fwd = [rows[f"N{n}_C{c}"] for n, c in FORWARD_SHAPES]
    # the ten launches run one after another: their least time is the sum
    # of theirs, bound by whichever of bytes or operations gives more of it
    by_bytes = sum(r["bound_ms"] for r in fwd if r["bound_by"] == "bytes")
    kernels = [{
        "name": "attn_block", "route": "cuda",
        "source": "ccdm_tpu_torch/csrc/attn_block.cu",
        "replaces": "ccdm_tpu/ops/attn_block.py:65",
        "launches": served["launches"],
        "max_abs_err": max([e for r in rows.values()
                            for e in (r["max_err_bf16"], r["max_err_bf16_rounded"])
                            if e is not None] +
                           [e for errs in rows_by_batch.values() for pair in errs.values()
                            for e in pair if e is not None]),
        "ms": sum(r["ms"] for r in fwd),
        "plain_ms": sum(r["plain_ms"] for r in fwd),
        "bound_ms": sum(r["bound_ms"] for r in fwd),
        "bound_by": "bytes" if 2 * by_bytes >= sum(r["bound_ms"] for r in fwd) else "operations",
        "library_ms": None,
        "host_ms": sum(r["host_ms"] for r in fwd),
        "routes": [f"N{n} C{c}: {rows[f'N{n}_C{c}']['route']} x{rows[f'N{n}_C{c}']['splits']}"
                   for n, c in FORWARD_SHAPES],
        "ms_is": f"sum over the 10 launches of one UNet forward, B {BATCH}, bf16",
        "launches_in_training": trained["launches"]["attn_block"],
        "launches_in_ccdm_recipe": recipe["launches"]["attn_block"],
        "launches_in_multidim": multidim["launches"]["attn_block"],
        "launches_in_multidim_sinusoidal": analytic["launches"]["attn_block"],
        "launches_in_aux_gif_interpolation": aux_run["launches"]["attn_block"],
        "launches_in_eval": eval_run["launches"]["attn_block"],
        "launches_in_dmd": dmd["launches"]["attn_block"],
        "launches_in_dmd_sagan": dmd["launches_sagan"]["attn_block"],
        "launches_in_baselines_cfg": baselines["cfg"]["launches"]["attn_block"],
        "launches_in_baselines_admg": baselines["admg"]["launches"]["attn_block"],
        "max_err_bf16": max(r["max_err_bf16"] for r in rows.values()
                            if r["max_err_bf16"] is not None),
        "max_err_f32": max(r["max_err_f32"] for r in rows.values()),
        "by_shape": rows,
        "bf16_by_batch": rows_by_batch,
        "model_parity": parity,
        "serve": served,
        "card": card,
    }]
    main_tag = "N={} C={} bfloat16".format(*LARGE_SHAPES[0])
    for name in LARGE:
        timing = large_rows[main_tag][name]
        kernels.append({
            "name": name, "route": "cuda", "source": "ccdm_tpu_torch/csrc/attn_block_large.cu",
            "replaces": LARGE_REPLACES[name], "launches": trained["launches"][name],
            "max_abs_err": max(r["max_err"][out] for tag, r in large_rows.items()
                               if tag.endswith("bfloat16") for out in LARGE_OUTPUTS[name]),
            "ms": timing["ms"], "plain_ms": timing["plain_ms"], "bound_ms": timing["bound_ms"],
            "bound_by": timing["bound_by"], "library_ms": None,
            "ms_is": f"one call at B {TRAIN_BATCH}, N {LARGE_SHAPES[0][0]}, "
                     f"C {LARGE_SHAPES[0][1]}, bf16",
            "launches_in_ccdm_recipe": recipe["launches"][name],
            "launches_in_multidim": multidim["launches"][name],
            "launches_in_multidim_sinusoidal": analytic["launches"][name],
            "launches_in_aux_gif_interpolation": aux_run["launches"][name],
            "launches_in_eval": eval_run["launches"][name],
            "launches_in_dmd": dmd["launches"][name],
            "launches_in_dmd_sagan": dmd["launches_sagan"][name],
            "launches_in_baselines_cfg": baselines["cfg"]["launches"][name],
            "launches_in_baselines_admg": baselines["admg"]["launches"][name],
            "routes": {tag: f"{r[name]['route']} x{r[name]['splits']}"
                       for tag, r in large_rows.items() if name in r},
            "by_shape": {tag: r.get(name, {}) for tag, r in large_rows.items()},
            "card": card})
    kernels[1]["two_pass_vs_single_pass"] = two_vs_one
    kernels[1]["dim_head_64"] = other_dim_head
    kernels[3]["grad_parity"] = grads
    kernels[3]["grad_parity_use_Hy"] = grads_hy
    kernels[3]["max_err_by_shape"] = {tag: r["max_err"] for tag, r in large_rows.items()}
    kernels[4]["train"] = trained
    kernels[4]["ccdm_recipe"] = recipe
    kernels[4]["multidim"] = multidim
    kernels[4]["aux_gif_interpolation"] = aux_run
    kernels[4]["eval"] = eval_run
    kernels[4]["dmd"] = dmd
    kernels[4]["adm_vit"] = denoisers
    kernels[4]["baselines"] = baselines
    kernels += resnet_kernel_rows(resnet_rows, fused_served, fused_trained, fused_parity, card,
                                  served["cfg_forward_ms"])
    kernels += slice4_kernel_rows(la_rows, tp_rows, ba_rows, la_path, la_grads, card)
    print(json.dumps({"kernels": kernels}), flush=True)

    phase("25/26 the card")
    print(card, flush=True)

    phase(f"26/26 data parallelism: (a) main.py under the env triplet at world 1 over NCCL, "
          f"{DP_WORLD1_STEPS} steps, against the same run without it; (b) two ranks on one card "
          f"over gloo, {DP_STEPS} train steps at 64 rows a rank, against one process; (c) one "
          f"CcGAN iteration on two ranks; (d) the native dataset cache; (e) the folded upsample")
    parallel = data_parallel_path(device, card, {})
    print(json.dumps({"data_parallel": parallel}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    faulthandler.cancel_dump_traceback_later()
    return 0


if __name__ == "__main__":
    sys.exit(main())
