#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``yat_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (exit code 1) when it fails:

1. device: a CUDA device must be present; prints the card's name and power
   limit and turns TF32 off for fp32 matmuls and convolutions;
2. build: compiles every CUDA kernel of the port from
   ``yat_tpu_torch/csrc`` with nvcc (one process per source, in parallel);
   prints ptxas's registers and spills by kernel, and the registers,
   shared bytes and blocks per SM of the bf16 launches of K6 and K2 (the
   forwards), of K6b and K2b, of K5's and K5b's quantize and GEMM at
   every w8a8 case with the GEMM grid the launcher chooses, and of K3's
   (tensor-core and CUDA-core paths, each padded head dim), K1's (the row
   in registers, the generic loop) and K1b's (the ring, the generic loop)
   launches;
3. kernels: holds each kernel (K1, K2, K3, K4 through K2's kernel and K6
   forward; K1b, K2b, K4b through K2b's kernel and K6b backward) against
   its plain PyTorch version at the serving and training paths' shapes and
   at ragged and masked shapes (the forwards also at masks whose kept keys
   fill one middle or the last key tile only; K1 also at PixArt-Sigma's
   serving shape and on its generic-width path; K1b at SANA's and
   PixArt-Sigma's training shapes, ragged, at another width and on a view
   off the vectors, a backward without its xhat * m2 term rejected; K3
   also at head dim 64, at N = 17, with an fp32 state, and with NaN
   inputs, whose NaN outputs must fall where the plain version's do), in
   bf16 and fp32, naming the path each K1, K1b and K3 launch took, and
   times the kernel, the plain version and (where one exists) one PyTorch
   call computing the same function (and the kernel's multiple of it and
   of the bound; for K1b LayerNorm's fused backward on the same bytes with
   one weight shared across the batch), beside the least time the card
   could take (for the masked forwards, counting the kept keys only), at
   the main path's shape and, for K1, K1b and K3, at every case (K1b also
   the host's time a call), K2 and K2b also at the self-attention of
   SANA's softmax-patched blocks in training (q/k/v ``[16,256,36,32]``,
   no key bias); K5 and K5b
   (the w8a8 matmul and its backward) must equal their plain versions bit
   for bit (int8 payload, row scales, output) at SANA's and PixArt's
   shapes and with zero rows and one-large-value rows; at the main case
   their quantize and GEMM launches are timed apart (a profiler window),
   beside ``torch._int_mm`` with the weight K-major and row-major and the
   host's time a call (the two tensor maps' encoding included);
4. reference: two-block full-width SANA and PixArt-Sigma denoisers on the
   card against the same modules on the CPU (the plain versions), fp32;
5. gradient reference: the same two SANA blocks with each adapter kind
   (LoRA, LoHa, LoKr, FourierFT, DoRA; every zero-initialised leaf drawn
   nonzero), one flow-matching loss and every adapter leaf's gradient on
   the card (kernels) against the CPU (plain versions), fp32, once the
   share of the ReLU kinks that fall on different sides of 0 on the two
   devices is counted and added (each kind's own backward of the flipped
   entries' gradient); every gradient nonzero.  Then two PixArt-Sigma
   blocks with LoRA and one epsilon loss the same way (K6/K6b, K4/K4b,
   K1/K1b; no ReLU, so no kinks).  Then the two SANA blocks with an int8
   base and w8a8 (K5/K5b): the int8 roundings that land on the other side
   on the two devices are counted (each one step at a near-tie) and the
   CPU takes the card's step there, the kinks as before.  Then the two
   SANA blocks under full fine-tuning: every parameter's gradient, the
   CPU taking the card's side of each flipped ReLU kink (so no leaf
   upstream of it sees the flip), the softmax key biases (0 in exact
   arithmetic) against the largest gradient;
6. serve: the port's SANA-0.6B 512px server (Gemma-2-2B caption encoder,
   SANA-0.6B denoiser with CFG 5.0 and 20 flow-match Euler steps, fp32
   DC-AE decoder) with random weights from a seed, on 127.0.0.1: four
   concurrent /generate requests and one more; checks the images and that
   the kernels' launch counters rose by their per-denoiser-call counts;
   then one more batch of 4 under ``torch.profiler`` for the device time by
   layer and the device's idle share (after the counters are read; every
   profile checks its port kernels' records against their counters);
   then the same for PixArt-Sigma XL-2 512px (T5-XXL caption encoder,
   20 DDIM steps with CFG 5.0 and PAG 2.0, fp32 SD KL-VAE decoder): K6 runs
   its self-attention, K2's kernel its cross-attention in K4's place, and
   the XLA attention branch must not run;
6b. pretrained: SANA-0.6B 512px (8 of its 28 blocks, ``DEPTH_CUTS``)
   served from a seeded synthetic diffusers
   pipe directory in a temporary directory (``tools/synth_checkpoint.py``:
   ``transformer/`` with the full key space and its ``config.json``,
   ``text_encoder/`` Gemma-2-2B, ``vae/`` the DC-AE f32c32 with both
   halves; BF16, deleted at the end) through ``make_pipeline``: every
   parameter must equal its synthesized value after the same casts (a
   bias the published layout leaves out: zero); the seconds each model
   took from file to card and the host's peak RSS; the HTTP main path of
   phase 6 (K1, K2, K3 by their per-call counts); a batch of 4 with
   Euler, DPM-Solver++(2M) and the velocity cache at interval 2 (12
   denoiser calls over 20 steps, counted on K1/K2/K3), each with its
   latency and the denoiser's device time; refiner gating with a random
   nonzero LoRA (no active step: the latents of the pipeline without
   LoRA, every step active: those of the ungated LoRA pipeline, bit for
   bit); one ``low_vram`` batch of 2 prompts (encoder and decoder weights
   on the host after it, one prompt at a time, device memory at rest and
   peak beside the normal batch's).  Then PixArt-Sigma XL-2 the same way with
   ``transformer/`` and ``vae/`` (the SD KL-VAE) from files and DDIM and
   DPM batches (2 denoiser calls a step under PAG; K1, K4, K6); T5-XXL
   stays random (its encoder file is about 9.5 GB in bf16; its loader is
   held against the JAX package on the CPU).  The hash tokenizer stands
   in for the pipe's (the card's machine has no ``transformers``);
7. train: SANA-0.6B 512px LoRA training (8 of its 28 blocks, as in
   phases 7b-12: ``DEPTH_CUTS``) through the port's entry point
   ``yat_tpu_torch.frontends.sana.main`` on a synthetic feature shard
   (batch 16, bf16, rank-8 LoRA on to_q/to_k/to_v/to_out, AdamW with
   warmup, EMA, caption-length buckets), 6 steps; checks the losses, the
   adapters and their export, and the launches per step; its
   ``checkpoint_dir`` writes at steps 3 and 6, and the last checkpoint is
   held against the live state and restored into a wiped state, bit for
   bit; then one more step with remat (``low_vram``) on the same batch and
   draws, whose loss and gradients must equal the step without, and one
   step under ``torch.profiler``;
7b. adapter kinds: phase 7's configuration with LoHa, LoKr, FourierFT
   (1000 frequencies) and LoRA with DoRA, 2 steps each through the entry
   point: finite losses, every leaf changed, the export, phase 7's
   launches a step; each export reloaded through ``lora_pretrained`` into
   ``make_pipeline``, whose denoiser equals the live one bit for bit on a
   fixed input; DoRA under the refiner gate at 0 gives the scale-0 output
   (``m W / |W|``), not the base's;
8. PixArt-Sigma XL-2 512px (8 of 28 blocks) LoRA training through
   ``yat_tpu_torch.frontends.pixart.main`` on a synthetic feature shard
   (batch 8, bf16, rank-32 LoRA on to_q/to_k/to_v/to_out, 6 steps over the
   caption rungs 128 and 256/300): the same checks, with the launches per
   step by caption rung (K6/K6b for the self-attention; K4/K4b at rungs
   256 and 300, K2/K2b at rung 128 for the cross-attention), a remat step
   and a profiled step;
9. int8 train: phase 7's configuration with ``lora_base_model_8bit``,
   ``int8_w8a8`` and ``use_adamw_8bit`` (an int8 base quantized from the
   fp32 weights, its products through K5/K5b, Lion with 8-bit momentum):
   the same checks, 254 K5 and 193 K5b launches a step beside slice 2's,
   the int8 base's bytes and the peak memory beside phase 7's, the int8
   payloads and Lion's through the checkpoint's save and restore;
10. full fine-tune: ``configs/sana_softmax_patch.yaml`` through the entry
   point (SANA-0.6B cut to 16 blocks, ``DEPTH_CUTS``, with softmax
   self-attention in blocks 12-15, only
   those unfrozen, batch 16, bf16 compute over fp32 leaves, EMA, lr 1e-5),
   16 steps with checkpoints at 8 and 16 and the profiler window of steps
   10-14: 33 K1b, 20 K2/K2b, 12 K3 launches a step, every leaf outside
   blocks 12-15 bit-unchanged, the export and its ``config.json``, one
   checkpoint's bytes and seconds, the save and restore bit for bit; then
   the step-16 checkpoint removed (a run killed between its writes) and a
   run of the same config with ``resume`` from step 8 to 16 on the first
   run's batches; each trace names K2, K2b and K1b;
11. exploration and preservation: SANA-0.6B LoRA (phase 7's config) with
   ``exploration_steps: 4`` and ``use_preservation``, 3 steps (7 forwards
   and 2 backwards a step, counted), and PixArt-Sigma XL-2 LoRA (phase
   8's) with ``use_preservation``, 2 steps (3 forwards, 2 backwards);
12. raw images: which decoder runs (the native libjpeg decoder where it
   builds, else cv2; printed with the reason) on 64 seeded JPEGs at four
   512px buckets in two local ``{jpg, txt}`` shards (SANA-0.6B and
   PixArt-Sigma XL-2 at 8 of 28 blocks), and the host's decode
   and resize of a batch of 16; ``configs/sana_extract_features.yaml``
   through ``yat_tpu_torch.frontends.sana.main`` without its R2 account
   (a stand-in S3 endpoint on 127.0.0.1, served from a thread here, checks
   each upload's SigV4 signature) and pretrained pipe (random Gemma-2-2B
   in bf16 and DC-AE f32c32 in fp32), batch 16 in chunks of 8: the
   uploaded feature shards' fields, buckets and shapes against the
   bucketing and the extractor's report, the DC-AE latent of one image
   against the CPU (fp32, 1e-4), both encoders' device time per chunk of
   8, images/s, the peak memory; phase 7's training (3 steps) on those
   shards; ``configs/sana_512_lora.yaml`` (without its files and
   validation prompts) encoding on the fly for 6 steps, then from its
   step-3 checkpoint a resume whose ``skip_batches`` runs no encoder, and
   one profiled step with the cache encoding behind it;
   ``configs/pixart_repa.yaml`` as written but for its files and depth
   (T5-XXL, the SD KL-VAE encoder, PixArt-Sigma XL-2 at 8 blocks random;
   a random DINOv2
   ViT-B/14 for the missing checkpoint): LoKr rank 32 on an int8 base with
   8-bit Lion, REPA at 0.05 after block 4, encoding on the fly, 3 steps,
   each step's DINO targets ``[8, 256, 768]`` and a finite nonzero
   alignment term, every LoKr leaf changed, the frozen projector
   unchanged, DINOv2's device time a batch of 8; SANA with generic REPA
   on ``blocks_7`` on the fly, 2 steps (the head trains; the hooks launch
   nothing); a 2-step SANA Dreambooth run
   over an instance and a regularization folder.  Every run's launches
   are checked by step, on the attention branch each step's latent grid
   gives (the non-square buckets' cross-attentions take the XLA branch,
   as in the JAX package).

13. the UNet families: the kernel phase also holds K6/K6b, K4/K4b and
   K2/K2b at the UNet's shapes (``UNET_CASES``: SD1.5's head dims 40 and
   80 at 4096 and 1024 tokens, SDXL's 64; CLIP's 77 keys all kept or
   partly masked; timed in bf16).  Then SD1.5 512 px (CLIP-L, the UNet,
   the fp32 KL-VAE decoder; 20 DDIM steps, CFG 5.0) and SDXL 1024 px
   (CLIP-L and OpenCLIP-G with pooled text and time_ids) served as in
   phase 6, each attention counted on the branch its shape gives (SD1.5:
   10 K6, 5 K4, 5 K2 and 12 XLA-branch calls a denoiser call; SDXL 70 K6,
   10 K4, 60 K2); the full-width SD1.5 UNet's LoRA gradients on the card
   against the CPU (fp32, 64x64 latent); a synthesized CompVis SD1.5
   single file (F16) whose UNet loads through ``load_pretrained_backbone``
   with every parameter checked and the seconds from file to card;
   ``configs/sd15_single_file_lora.yaml`` as written but for its files
   (raw JPEGs on the fly, batch 8, 6 steps), which must fit as written;
   ``configs/sdxl_dreambooth.yaml`` as written but for its files (batch 4
   at 1024 px, preservation, 3 steps; the peak memory, or the peak where
   it does not fit), then with ``low_vram``, which must fit; an SDXL
   extraction pass whose samples carry ``pooled.npy`` ``[1280]``.
   Launches are checked by step on each step's latent grid.

14. SD3.5 (MMDiT): the kernel phase also holds K6 and K6b at the joint
   attention's ``[B, 4429, 24, 64]`` (34 key blocks of 128 and one of 77,
   a last query block of 77 rows) and the MMDiT-X attention's
   ``[B, 4096, 24, 64]``, called directly without a mask (K6 at the CFG
   batch 8; K6b held at batch 2 and timed at 8), and K1 and K1b at
   ``[8, 4096, 1536]`` and ``[8, 333, 1536]`` (the generic path), bf16
   and fp32.  Then SD3.5-medium cut to 4 blocks (``DEPTH_CUTS``: two
   MMDiT-X blocks, a plain one and the last)
   served at 1024 px as in phase 6 (CLIP-L, OpenCLIP-G and T5-XXL in
   fp32, the MMDiT in bf16, the 16-channel fp32 KL-VAE; 20 Euler steps at
   shift 3.0, CFG 5.0; 6 K6 and 8 K1 a CFG call at 4 blocks, nothing
   else of the port's) and ``configs/sd35_flow_lokr.yaml``
   as written but for its files and its mesh (batch 8, LoKr rank 16,
   EMA, ``low_vram``; 4 steps with the validation at the last): every
   LoKr leaf a gradient reaches changed and exported, the validation
   image, the launches by step (each block's forward again in the
   backward), the step time, the peak and one profiled step.  The
   modulation layers, which flax initialises to zero, are drawn from the
   seed (``drawn_modulation``), so the random blocks reach the image and
   the gradients.

15. Flux-2 Klein: the kernel phase also holds K6 and K6b at the joint
   attention's ``[B, 4608, 24, 128]`` (head dim 128 over 4096 image and
   512 caption tokens; K6 held at batch 2 and timed at the CFG batch 8,
   K6b held at 2 and timed at the training batch 4), K1 at ``[8, 4096,
   3072]``, ``[8, 512, 3072]`` and ``[8, 4608, 3072]`` and K1b at
   ``[4, 4096, 3072]`` and ``[4, 512, 3072]`` (the generic path), bf16 and
   fp32.  Then Flux-2 Klein served at 1024 px as in phase 6 (Gemma-2-2B
   and the 16-channel KL-VAE in fp32, the transformer in bf16 with
   ``text_dim`` 2304; 20 Euler steps with the dynamic shift, CFG 7.0 and
   the guidance embedding at 7.0; at 2 double and 4 single blocks
   (``DEPTH_CUTS``) 6 K6 and 13 K1 a CFG call, nothing else
   of the port's) and ``configs/flux_klein_lora.yaml`` as written but for
   its files, its mesh and ``text_dim``: raw JPEGs in the config's two R2
   shards served by the stand-in S3 endpoint (signed GETs), encoded on the
   fly, batch 4 at 1024 px, LoRA rank 16 on the 32 projections of the
   double blocks, 3 steps with the validation at the last; every LoRA
   leaf changed and exported, the validation image, the launches by step
   (6 K6, 13 K1, 6 K6b, 11 K1b), the step time and the peak (a run
   that does not fit fails the phase); then one step split into its
   batch's encode and its denoiser step, each timed and profiled alone,
   with each part's memory above what the run keeps resident.  The
   modulation is drawn from the seed as for SD3.5.

16. PixelDiT: the kernel phase also holds K6/K6b at the patch stage's
   ``[B, 1024, 16, 64]`` (through the gate) and at the pixel stage's
   ``[B, 16384, 4, 64]`` and ``[B, 15552, 4, 64]`` (called directly; a
   last block of 64 rows; held at batch 2, timed at 8 and 4), K4/K4b over
   the 300-token caption padded to 384 keys with the caption masks, and
   K1/K1b at ``[B, 1024, 1024]`` and ``[B, 16384, 256]``, bf16 and fp32.
   Then PixelDiT served at 512 px at full width as in phase 6, its 24
   patch and 4 pixel blocks cut to 14 and 2 (``DEPTH_CUTS``; Gemma-2-2B in
   bf16 at 300 tokens, no VAE; DPM-Solver++(2M) in flow form, 20 steps,
   CFG 4.0; 16 K6, 14 K4 and 32 K1 a CFG call at the cut, nothing
   else of the port's; the modulation drawn), the LoRA gradients of 2 + 1
   full-width blocks on a 4-bit base at 512 px against the CPU, and
   ``configs/pixeldit_repa.yaml`` as written but for its files: a
   synthesized BF16 ``.pth`` in DiT naming (every base value checked
   after the run), raw JPEGs at the square and the 864x288 bucket (15552
   pixel tokens, no multiple of 128; its patch stage on the XLA branch),
   REPA against a random DINOv2, 3 steps with a validation: the launches
   by step, the REPA term by step and the leaves it reaches (blocks
   0-12), the step time, the peak, one step split into encode and
   denoiser step, and the pixel stage's attention at 864x288 on the
   gate's XLA branch beside K6/K6b at the training batch.

17. Training across processes (after phase 7): ``configs/sana_512_lora.yaml``
   as written but for its files, its mesh and the training depth cut,
   3 steps with the validation and the checkpoint at the last, trained by
   four processes of ``frontends.sana.main`` under
   ``torch.distributed.run`` (this script's ``--mp-train`` mode), which
   share the card over gloo, first at ``{fsdp: 2, tp: 2}`` and then at
   ``{dp: 2, sp: 2}``, each data index reading its own shard (its caption
   lengths over the rungs 128/256/384) through ``WindowedBucketSync``:
   the backend line, every process's adapters and EMA bit-equal, the
   launches of each process's steps (K1 17, K1b 16, K2/K2b 8 a step at 8
   blocks, and K3 8 at ``tp``, 18 heads, or K3s and K3a 8 each at ``sp``,
   128 tokens) and of its validation (4 of the sampler's 20 steps), one
   export and one checkpoint, both by rank 0, the checkpoint restored,
   one step's reduced gradients against a one-process copy's step on
   2 x 4 rows, in fp32 (a copy split as the trainer's model) and
   in bf16 (the trainer's own), the step time, the
   gradient all-reduce's milliseconds, the tp/sp collectives' calls,
   bytes and milliseconds a step, the peak per process and each process's
   resident frozen base; then ``context_parallel_attention`` and
   ``ring_attention`` at q/k/v [2, 4096, 8, 64] over the four processes
   against one-process SDPA; then PixArt-Sigma's LoRA config at ``{sp:
   2}`` (4 blocks) by two processes of its entry point, 2 steps: equal
   states, one export, one step's reduced gradients against the
   one-process step as above, the launches by the whole token count's
   branches (K6/K6b over the gathered keys, K4/K4b for the captions).

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Imports nothing of JAX or of the JAX
package.
"""

from __future__ import annotations

import contextlib
import datetime
import json
import math
import os
import shutil
import struct
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# peak rates of one H100 SXM (NVIDIA data sheet, dense): HBM3 bytes/s,
# bf16 tensor-core FLOP/s, int8 tensor-core operations/s, fp32
# (non-tensor) FLOP/s
HBM_BYTES_S = 3.35e12
BF16_FLOPS = 989e12
INT8_OPS = 1979e12
FP32_FLOPS = 67e12

# tolerances |kernel - plain| <= atol + rtol * |plain|
TOL = {
    # bf16: one storage-type rounding step (2^-8 relative) flips where the
    # fp32 reductions sum in another order
    "bfloat16": {"adaln_layernorm": (2e-2, 2e-2),
                 "dot_product_attention": (2e-2, 2e-2),
                 "dot_product_attention_folded": (2e-2, 2e-2),
                 "flash_attention": (2e-2, 2e-2),
                 "linear_attention": (2e-2, 2e-2),
                 "linear_attention_apply": (2e-2, 2e-2)},
    # fp32: reduction order only
    "float32": {"adaln_layernorm": (1e-5, 1e-5),
                "dot_product_attention": (1e-4, 1e-4),
                "dot_product_attention_folded": (1e-4, 1e-4),
                "flash_attention": (1e-4, 1e-4),
                "linear_attention": (1e-4, 1e-4),
                # K3s's output is the fp32 state whatever the input's type
                "linear_attention_state": (1e-4, 1e-4),
                "linear_attention_apply": (1e-4, 1e-4)},
}
# backward kernels, each output against the plain backward.  bf16: rtol
# 2^-7 is one bf16 step of the element itself, where the stored result
# rounds the other way; atol (None here) is 2^-8 of that output's largest
# magnitude, for the fp32 sums run in another order and the dS entries that
# round the other way before the dq/dk products.  fp32: reduction order only
BWD_BF16_ATOL_SHARE = 2.0 ** -8
TOL["bfloat16"].update({"adaln_layernorm_bwd": (None, 2.0 ** -7),
                        "dot_product_attention_bwd": (None, 2.0 ** -7),
                        "dot_product_attention_folded_bwd": (None, 2.0 ** -7),
                        "flash_attention_bwd": (None, 2.0 ** -7)})
# K1b's dscale and dshift in fp32 are sums over a batch row's N tokens,
# which the kernel adds in another order than the plain version: N
# roundings of up to half an fp32 unit (2^-24) of the sum, a random walk
# of sqrt(N) of them at the largest sum's scale.  Their atol is the larger
# of fp32's 1e-4 and 2^-24 sqrt(N) max|plain|
FP32_SUM_ULP = 2.0 ** -24
TOL["float32"].update({"adaln_layernorm_bwd": (1e-4, 1e-4),
                       "dot_product_attention_bwd": (2e-4, 2e-4),
                       "dot_product_attention_folded_bwd": (2e-4, 2e-4),
                       "flash_attention_bwd": (2e-4, 2e-4)})
# the gradient reference (fp32, TF32 off): every entry of every LoRA leaf's
# gradient within this share of the leaf's largest entry, once the share of
# the ReLU kinks that fell on different sides on the two devices is added
GRAD_REF_TOL = 1e-4
# the case of each kernel that is timed and reported: the main path's shape
MAIN_CASE = {"adaln_layernorm": "serve", "dot_product_attention": "serve",
             "dot_product_attention_folded": "serve",
             "flash_attention": "serve", "linear_attention": "serve",
             "linear_attention_state": "sp-train",
             "linear_attention_apply": "sp-train",
             "adaln_layernorm_bwd": "train",
             "dot_product_attention_bwd": "train-512",
             "dot_product_attention_folded_bwd": "train-300",
             "flash_attention_bwd": "train"}

PROMPTS = ["a red fox in fresh snow", "a lighthouse at dusk",
           "a bowl of ramen on a wooden table", "a city street in the rain"]
# largest |difference| of the [0, 1] image of one prompt sampled in a batch
# of 4 and alone (bf16); an H100 80GB reads about 6.5e-3 for SANA and
# 2.5e-2 for PixArt-Sigma.  PixelDiT's sample is the image itself, with no
# decoder after the sampler: its batch-size roundings, carried through 28
# blocks with drawn modulation and CFG 4.0 over 20 DPM steps, read
# 2.127e-1 on an H100 80GB in bf16, the same bits in two calls, and
# 2.3e-5 with the run in fp32 (TF32 off), where the GEMMs round alike at
# both batch sizes
REPEAT_TOL = {"sana": 2e-2, "pixart": 5e-2, "sd15": 5e-2, "sdxl": 5e-2,
              "sd35": 5e-2, "flux": 5e-2, "pixeldit": 0.5}


# depth cuts of earlier paths that pay for the Flux, PixelDiT and
# multi-process phases inside the run's time (PERF.md section 4): the
# blocks of a denoiser, never its width
DEPTH_CUTS = {
    # SANA-0.6B and PixArt-Sigma XL-2 served from synthesized files: 28 of
    # their 28 blocks cut to 8
    "pretrained": {"num_layers": "8"},
    # configs/sana_softmax_patch.yaml: SANA-0.6B's 28 blocks cut to 16, so
    # its softmax blocks 12-15 (the only ones unfrozen) are the last four
    "full_ft": {"num_layers": "16"},
    # SD3.5-medium's 24 blocks cut to 4: blocks 0-1 MMDiT-X (of its 0-12),
    # 2 a plain MMDiT block and 3 the published last block (no second
    # attention, no text output), so every kind of block still runs
    "sd35": {"num_layers": "4", "dual_attention_layers": [0, 1]},
    # the SANA-0.6B and PixArt-Sigma XL-2 training runs (phases 7-9, 11
    # and 12, so phase 12's on-the-fly rate compares with phase 7's at one
    # depth): 8 of 28 blocks, so that phase 12's PixArt-Sigma REPA tap
    # after block 4 and SANA's generic REPA on blocks_7 still run
    "train": {"num_layers": "8"},
    # PixArt-Sigma XL-2's token-sharded run of phase 17 (two processes
    # at {sp: 2}): 4 of 28 blocks, each block the same sp path
    "mp_pixart": {"num_layers": "4"},
    # Flux-2 Klein's 8 double and 16 single blocks cut to 2 and 4 (both
    # kinds still run), served and trained
    "flux": {"num_double_blocks": "2", "num_single_blocks": "4"},
    # PixelDiT's 24 patch and 4 pixel blocks cut to 14 and 2, served and
    # trained: the REPA projector still taps block 12, and block 13 is
    # one it must not reach
    "pixeldit": {"num_layers": "14", "num_pixel_layers": "2"},
}


def depth_cut(key, **extra):
    """The configuration keys of a depth cut (``DEPTH_CUTS[key]``) with
    ``extra`` keys beside them."""
    return {"model_config_overrides": dict(DEPTH_CUTS[key]), **extra}


# the run's clock, which every log line carries
_T0 = time.perf_counter()


def log(msg: str) -> None:
    print(f"[chip_smoke {time.perf_counter() - _T0:7.1f}s] {msg}",
          flush=True)


def fail(msg: str) -> None:
    log(f"FAIL: {msg}")
    sys.exit(1)


# ---------------------------------------------------------------------------
# 1. device
# ---------------------------------------------------------------------------

def phase_device():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a "
             "CUDA device")
    if not os.path.isdir(os.path.join(REPO, "yat_tpu_torch")):
        fail(f"yat_tpu_torch/ not found beside {__file__}")
    sys.path.insert(0, REPO)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        and smi.stdout.strip() else "nvidia-smi unavailable"
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"device {torch.cuda.get_device_name(0)} x"
        f"{torch.cuda.device_count()}, torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}; TF32 off for fp32 matmuls and convolutions")
    return card


# ---------------------------------------------------------------------------
# 2. build
# ---------------------------------------------------------------------------

def phase_build():
    import yat_tpu_torch.ops.attention  # noqa: F401  (registers K2, K2b, K3)
    import yat_tpu_torch.ops.norm  # noqa: F401  (registers K1, K1b)
    import yat_tpu_torch.ops.quant  # noqa: F401  (registers K5, K5b)
    from yat_tpu_torch.kernels.build import KERNELS, build_all
    out = build_all()
    log(f"built {sorted({k.source for k in KERNELS.values()})} in "
        f"{out['seconds']:.1f} s")
    # ptxas's registers and spills of each entry function, by name
    spilled = []
    for source, text in out["logs"].items():
        entry = "?"
        for line in text.splitlines():
            if "Compiling entry function" in line:
                entry = entry_name(line.split("'")[1])
            elif "Used" in line or "spill" in line:
                log(f"  {source}: {entry}: {line.strip()}")
                if " 0 bytes spill stores" not in line and "spill" in line:
                    spilled.append(entry)
    log(f"entry functions with register spills: {spilled or 'none'}")
    log_fwd_launch_info()
    log_bwd_launch_info()
    log_w8a8_launch_info()
    log_k1_k3_launch_info()


def entry_name(mangled: str) -> str:
    """A kernel's name and integer template arguments from its mangled
    name, e.g. ``flash_bwd_dq_bf16<1,5,5>``."""
    import re
    names, i = [], mangled.find("N") + 1 if mangled.startswith("_ZN") else 2
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        n = int(mangled[i:j])
        names.append(mangled[j:j + n])
        i = j + n
    args = re.findall(r"L[a-z](-?\d+)E", mangled[i:].split("EEv")[0]) \
        if mangled[i:i + 1] == "I" else []
    name = names[-1] if names else mangled
    return f"{name}<{','.join(args)}>" if args else name


# head dims of each redesigned forward and backward whose launches are
# reported: the main paths' 72 and the card tests' others
FWD_INFO_DIMS = {"flash_attention": (32, 64, 72, 128, 256),
                 "dot_product_attention": (32, 64, 72, 128)}
BWD_INFO_DIMS = {"flash_attention_bwd": (32, 64, 72, 128, 256),
                 "dot_product_attention_bwd": (32, 64, 72, 128)}


def fwd_launch_info(name, d):
    """The 128-query bf16 launch of K6 or K2 (with 16-byte loads) at head
    dim d: ((registers, local bytes, shared bytes, blocks per SM) without
    a key bias, the same with one), from the CUDA runtime."""
    import ctypes

    from yat_tpu_torch.kernels.build import KERNELS
    prefix = ("yat_flash_attention" if name == "flash_attention"
              else "yat_attention")
    buf = (ctypes.c_longlong * 8)()
    err = KERNELS[name].function(f"{prefix}_launch_info",
                                 [ctypes.c_int, ctypes.c_int,
                                  ctypes.c_void_p])(
        d, 1, ctypes.addressof(buf))
    if err != 0:
        fail(f"{name}: launch info at D={d} failed with CUDA error {err}")
    return tuple(buf[0:4]), tuple(buf[4:8])


def log_fwd_launch_info():
    """Registers, spills, shared bytes and blocks per SM of the bf16
    forwards K6 and K2 (K4 runs K2's) at 128 queries a block (8 warps)."""
    for name, dims in FWD_INFO_DIMS.items():
        for d in dims:
            for variant, (regs, local, smem, blocks) in zip(
                    ("no bias", "key bias"), fwd_launch_info(name, d)):
                log(f"  {name} bf16 D={d} {variant}: {regs} registers, "
                    f"{local} local (spill) bytes a thread, {smem} shared "
                    f"bytes, {blocks} blocks ({8 * blocks} warps) per SM")


def bwd_launch_info(name, d):
    """Both bf16 launches of K6b or K2b (with 16-byte loads) at head dim d:
    ((registers, local bytes, shared bytes, blocks per SM) of the dq launch,
    the same of the dk/dv launch), from the CUDA runtime."""
    import ctypes

    from yat_tpu_torch.kernels.build import KERNELS
    kern = KERNELS[name]
    prefix = ("yat_flash_attention_bwd" if name == "flash_attention_bwd"
              else "yat_attention_bwd")
    buf = (ctypes.c_longlong * 8)()
    err = kern.function(f"{prefix}_launch_info",
                        [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])(
        d, 1, ctypes.addressof(buf))
    if err != 0:
        fail(f"{name}: launch info at D={d} failed with CUDA error {err}")
    return tuple(buf[0:4]), tuple(buf[4:8])


def log_bwd_launch_info():
    """Registers, spills, shared bytes and blocks per SM of each bf16 launch
    of K6b and K2b (K4b runs K2b's)."""
    for name, dims in BWD_INFO_DIMS.items():
        for d in dims:
            for launch, (regs, local, smem, blocks) in zip(
                    ("dq", "dk/dv"), bwd_launch_info(name, d)):
                log(f"  {name} bf16 D={d} {launch} launch: {regs} registers, "
                    f"{local} local (spill) bytes a thread, {smem} shared "
                    f"bytes, {blocks} blocks ({4 * blocks} warps) per SM")


# K3's launches reported by the build phase: (dtype, implementation, head
# dim); "auto" below N = 4096 rounds the state (bf16: the tensor cores),
# "pallas" keeps it in fp32 (the CUDA cores)
K3_INFO = [(dt, impl, d) for dt in ("bfloat16", "float32")
           for impl in ("auto", "pallas") for d in (16, 32, 48, 64)
           if dt == "bfloat16" or impl == "auto"]
# K1's and K1b's: (dtype, width); 1152 holds the row in registers (K1) or
# streams it through the warps' rings (K1b)
K1_INFO = [(dt, d) for dt in ("bfloat16", "float32") for d in (1152, 1000)]


def log_k1_k3_launch_info():
    """The path, registers, spills, shared bytes and blocks per SM of K3's
    launches (each dtype, state and padded head dim), K1's and K1b's (the
    width of the register and ring paths, and another), with 16-byte
    aligned rows."""
    import torch

    from yat_tpu_torch.ops import attention as A
    from yat_tpu_torch.ops import norm as N
    dev = torch.device("cuda", 0)
    for dt, impl, d in K3_INFO:
        q = torch.zeros((1, 16, 1, d), dtype=getattr(torch, dt), device=dev)
        log(f"  linear_attention {dt} {impl} D={d}: "
            + launch_text(A.linear_attention_launch_info(q, q, q, impl)))
    for dt, d in K1_INFO:
        x = torch.zeros((1, 8, d), dtype=getattr(torch, dt), device=dev)
        m = torch.zeros((1, 1, d), dtype=x.dtype, device=dev)
        log(f"  adaln_layernorm {dt} D={d}: "
            + launch_text(N.adaln_launch_info(x, m, m)))
        log(f"  adaln_layernorm_bwd {dt} D={d}: "
            + launch_text(N.adaln_bwd_launch_info(x, m, x)))


# ---------------------------------------------------------------------------
# 3. kernels
# ---------------------------------------------------------------------------

def _rotations(make, nbytes):
    """Enough copies of one call's inputs that cycling through them reads
    about 100 MB, twice the 50 MB L2: each launch finds its inputs cold,
    as the serving path does."""
    return [make() for _ in range(max(2, min(16, math.ceil(100e6 / nbytes))))]


def time_ms(fn, inputs, iters, hold_cycles=50_000_000, hold=True):
    """Device milliseconds of one call: CUDA events around ``iters`` calls.
    A spin kernel holds the stream while the host enqueues the calls, so
    they run back to back and the host's cost per launch (Python, checks,
    ctypes) stays out of the time; if the hold ran out before the last
    call was queued, it doubles and the measurement is repeated.  Without
    ``hold`` the events bracket the calls as the host issues them: for a
    plain version of many milliseconds whose gigabytes of temporaries make
    the allocator wait on the device, which no hold survives."""
    import torch
    for args in inputs * 2:
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if not hold:
        start.record()
        for i in range(iters):
            fn(*inputs[i % len(inputs)])
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters
    torch.cuda._sleep(hold_cycles)
    start.record()
    for i in range(iters):
        fn(*inputs[i % len(inputs)])
    end.record()
    held = not start.query()
    torch.cuda.synchronize()
    if not held:
        if hold_cycles > 5_000_000_000:
            fail("the host could not queue the timed calls within a "
                 "seconds-long hold of the stream")
        return time_ms(fn, inputs, iters, 2 * hold_cycles)
    return start.elapsed_time(end) / iters


def compare(name, got, want):
    """Largest |kernel - plain| over every output, the largest share of its
    allowance ``atol + rtol * |plain|`` that any element uses (at most 1 to
    pass), whether all pass, and the tolerance as text."""
    import torch
    if not isinstance(got, tuple):
        got, want = (got,), (want,)
    dtype = str(want[0].dtype).replace("torch.", "")
    atol, rtol = TOL[dtype][name]
    # K1b's fp32 token sums (FP32_SUM_ULP): outputs 1 and 2 of x [B, N, D]
    sums = (FP32_SUM_ULP * want[0].shape[1] ** 0.5
            if name == "adaln_layernorm_bwd" and dtype == "float32" else None)
    err_max, used, ok = 0.0, 0.0, True
    for i, (a, b) in enumerate(zip(got, want)):
        g, w = a.float(), b.float()
        err = (g - w).abs()
        limit = (BWD_BF16_ATOL_SHARE * float(w.abs().max()) if atol is None
                 else max(atol, sums * float(w.abs().max()))
                 if sums is not None and i > 0 else atol) + rtol * w.abs()
        ok = ok and bool(torch.isfinite(g).all())
        err_max = max(err_max, float(err.max()))
        used = max(used, float((err / limit.clamp_min(1e-30)).max()))
    text = (f"atol {BWD_BF16_ATOL_SHARE:g} x max|plain|" if atol is None
            else f"atol {atol:g}" + (
                "" if sums is None else
                f" (the sums' the larger with {sums:.3g} x max|plain|)")
            ) + f", rtol {rtol:g}"
    return err_max, used, ok and used <= 1.0, text


def compare_nan(name, got, want):
    """``compare`` for outputs that hold NaN: the NaN count of the plain
    version, whether the kernel's NaN fall on exactly the plain version's
    positions, and the other entries against the tolerance:
    (count, same positions, max |kernel - plain|, share used, ok, tol)."""
    import torch
    gn, wn = torch.isnan(got), torch.isnan(want)
    where = bool(torch.equal(gn, wn))
    err, used, ok, tol = compare(name, got.masked_fill(gn, 0),
                                 want.masked_fill(wn, 0))
    return int(wn.sum()), where, err, used, ok and where, tol


def _mask(keep, nk, device):
    """[B, N_k] int32 keep-mask: an int keeps that many leading keys, a
    (lo, hi) pair the keys [lo, hi)."""
    import torch
    idx = torch.arange(nk, device=device)
    return torch.stack([
        (idx >= x[0]) & (idx < x[1]) if isinstance(x, tuple) else idx < x
        for x in keep]).to(torch.int32)


def poison_masked_tiles(k, v, kept):
    """k and v with NaN in every 64-key tile whose keys are all masked
    (``kept`` [B, N_k] false), in each batch element that keeps a key: a
    forward that never reads such tiles gives the same bits on them as on
    the clean inputs."""
    k, v = k.clone(), v.clone()
    for i in range(kept.shape[0]):
        if not bool(kept[i].any()):
            continue
        for k0 in range(0, kept.shape[1], 64):
            if not bool(kept[i, k0:k0 + 64].any()):
                k[i, k0:k0 + 64] = float("nan")
                v[i, k0:k0 + 64] = float("nan")
    return k, v


# the forwards whose bf16 body skips fully masked key tiles, and what
# their fourth argument is: a keep-mask (K2, K4) or K6's additive bias
FWD_SKIP = {"dot_product_attention": "mask",
            "dot_product_attention_folded": "mask",
            "flash_attention": "bias"}


def attention_work(b, nq, nk, h, d, es, keep, elementwise=0):
    """(bytes, operations) that a masked attention forward's function needs:
    q read, o written and the key bias read whole; for a batch element
    that keeps keys, k and v read at those keys and the two products over
    them (plus ``elementwise`` operations per score); for one that keeps
    none, whose rows are the mean of V, v read once and summed, with no
    product."""
    n = [nk] * b if keep is None else [
        x[1] - x[0] if isinstance(x, tuple) else x for x in keep]
    kept = sum(n)
    empty = n.count(0)
    nbytes = es * h * d * (2 * b * nq + 2 * kept + nk * empty) + (
        4 * b * nk if keep is not None else 0)
    return nbytes, (4 * d + elementwise) * h * nq * kept + h * d * nk * empty


def layer_norm_bwd_yardstick():
    """K1b's library yardstick: ``native_layer_norm_backward`` on K1b's
    bytes, x viewed as [B*N, D] with one weight ``1 + scale[0]`` shared
    across the batch (dx, dweight, dbias).  Its mean, rstd and weight are
    made at the first call on each input and kept, so the timed calls run
    the backward alone."""
    import torch
    made = {}

    def call(x, sc, g):
        key = (x.data_ptr(), tuple(x.shape))
        if key not in made:
            x2 = x.reshape(-1, x.shape[-1])
            w = 1.0 + sc[0]
            bias = torch.zeros_like(w)
            _, mean, rstd = torch.ops.aten.native_layer_norm(
                x2, [x.shape[-1]], w, bias, 1e-6)
            made[key] = (x2, w, bias, mean, rstd)
        x2, w, bias, mean, rstd = made[key]
        return torch.ops.aten.native_layer_norm_backward(
            g.reshape(x2.shape), x2, [x2.shape[-1]], mean, rstd, w, bias,
            [True, True, True])
    return call


# the UNet's attentions (SD1.5 at 512 px: 8 heads, dims 40 and 80; SDXL at
# 1024 px: dims 64), each as (label, (b, n_q, n_k, h, d, keep)): serving
# forwards at the CFG batch of 4 requests (8), the backwards at the
# training batches (SD1.5 8, SDXL 4); CLIP's 77 keys all kept (the UNet's
# caption mask) and, for K2/K4/K2b, a partial mask.  Head dims 40 and 64
# run the kernels' 4-chunk instances (40 padded by 24 zero columns), 80
# the 5-chunk ones.  Timed in bf16 (TIMED_BF16_CASES)
_ALL77 = [77] * 8
_PART77 = [1, 5, 20, 33, 50, 64, 76, 77]
UNET_CASES = {
    "flash_attention": (
        ("sd15-l0", (8, 4096, 4096, 8, 40, None)),
        ("sd15-l1", (8, 1024, 1024, 8, 80, None)),
        ("sdxl-l1", (8, 4096, 4096, 10, 64, None)),
        ("sdxl-l2", (8, 1024, 1024, 20, 64, None))),
    "dot_product_attention_folded": (
        ("sd15-l0-cross", (8, 4096, 77, 8, 40, _ALL77)),
        ("sd15-l0-cross-masked", (8, 4096, 77, 8, 40, _PART77)),
        ("sdxl-l1-cross", (8, 4096, 77, 10, 64, _ALL77)),
        ("sdxl-l1-cross-masked", (8, 4096, 77, 10, 64, _PART77))),
    "dot_product_attention": (
        ("sd15-l1-cross", (8, 1024, 77, 8, 80, _ALL77)),
        ("sd15-l1-cross-masked", (8, 1024, 77, 8, 80, _PART77)),
        ("sdxl-l2-cross", (8, 1024, 77, 20, 64, _ALL77)),
        ("sdxl-l2-cross-masked", (8, 1024, 77, 20, 64, _PART77))),
    "flash_attention_bwd": (
        ("sd15-l0", (8, 4096, 4096, 8, 40, None)),
        ("sd15-l1", (8, 1024, 1024, 8, 80, None)),
        ("sdxl-l1", (4, 4096, 4096, 10, 64, None)),
        ("sdxl-l2", (4, 1024, 1024, 20, 64, None))),
    "dot_product_attention_folded_bwd": (
        ("sd15-l0-cross", (8, 4096, 77, 8, 40, _ALL77)),
        ("sdxl-l1-cross", (4, 4096, 77, 10, 64, _ALL77[:4])),
        ("sdxl-l1-cross-masked", (4, 4096, 77, 10, 64, _PART77[::2]))),
    "dot_product_attention_bwd": (
        ("sd15-l1-cross", (8, 1024, 77, 8, 80, _ALL77)),
        ("sd15-l1-cross-masked", (8, 1024, 77, 8, 80, _PART77)),
        ("sdxl-l2-cross", (4, 1024, 77, 20, 64, _ALL77[:4]))),
}
# SD3.5-medium at 1024 px (24 heads of 64, width 1536): K6 at the joint
# attention over 4096 + 333 tokens (34 key blocks of 128 and one of 77,
# a last query block of 77 rows) and at the MMDiT-X image-only attention
# over 4096, called directly without a mask, at the CFG batch of 4
# requests (8); K6b the same shapes, held at batch 2 (its plain version
# keeps four [B, 24, 4429, 4429] fp32 tensors) and timed at the training
# batch (SD35_TIMED_BATCH); K1 and K1b at the image and text streams, x
# [8, 4096, 1536] and [8, 333, 1536] (the generic path: the row in
# registers and the ring take D = 1152)
SD35_CASES = {
    "flash_attention": (("sd35-joint", (8, 4429, 4429, 24, 64, None)),
                        ("sd35-dual", (8, 4096, 4096, 24, 64, None))),
    "flash_attention_bwd": (("sd35-joint", (2, 4429, 4429, 24, 64, None)),
                            ("sd35-dual", (2, 4096, 4096, 24, 64, None))),
    "adaln_layernorm": (("sd35-image", (8, 4096, 1536)),
                        ("sd35-text", (8, 333, 1536))),
    "adaln_layernorm_bwd": (("sd35-image", (8, 4096, 1536)),
                            ("sd35-text", (8, 333, 1536))),
}
SD35_TIMED_BATCH = 8
# Flux-2 Klein at 1024 px (24 heads of 128, width 3072): K6 at the joint
# attention over 4096 image and 512 caption tokens (36 blocks of 128, the
# forward's key sub-step halved to 16 at this head dim), the same in every
# double and single block, timed at the CFG batch of 4 requests (8) and
# held at batch 2 (its plain version's fp32 scores are 16 GiB at 8); K6b
# held at 2 and timed at the training batch (4); K1 at the image stream,
# the caption stream and the single blocks' whole sequence, x
# [8, 4096, 3072], [8, 512, 3072] and [8, 4608, 3072]; K1b at the
# training batch's image and caption streams (the generic path)
FLUX_CASES = {
    "flash_attention": (("flux-joint", (2, 4608, 4608, 24, 128, None)),),
    "flash_attention_bwd": (("flux-joint", (2, 4608, 4608, 24, 128,
                                            None)),),
    "adaln_layernorm": (("flux-image", (8, 4096, 3072)),
                        ("flux-text", (8, 512, 3072)),
                        ("flux-single", (8, 4608, 3072))),
    "adaln_layernorm_bwd": (("flux-image", (4, 4096, 3072)),
                            ("flux-text", (4, 512, 3072))),
}
FLUX_TIMED_BATCH = {"flash_attention": 8, "flash_attention_bwd": 4}
# PixelDiT at 512 px (patch stage: width 1024, 16 heads of 64, 1024 tokens;
# pixel stage: width 256, 4 heads of 64, 16384 tokens): K6 at the patch
# stage's self-attention at the CFG batch of 4 requests (8), and K6b at
# the training batch (4); K6 and K6b at the pixel stage's self-attention,
# called directly without a mask, over 16384 tokens and over the 15552 of
# the 864x288 bucket (121 blocks of 128 and a last one of 64), held at
# batch 2 (the plain version's fp32 scores are 8 GiB there, its backward
# keeps five such tensors) and timed at 8 (K6) and 4 (K6b); K4 (K2's kernel, folded: the native backward's blocks
# would take 15 MiB at width 1024) and K4b at the cross-attention over
# the 300-token caption padded to 384 keys, with the caption masks of the
# CFG batch (the unconditional half keeps one key) and a full caption
# (keys up to the padding inside the last 128-key tile); K1 and K1b at both
# widths, x [8, 1024, 1024] and [8, 16384, 256] (training: batch 4)
_CAPTIONS = [1, 1, 1, 1, 9, 15, 131, 300]
PIXELDIT_CASES = {
    "flash_attention": (
        ("pixeldit-patch", (8, 1024, 1024, 16, 64, None)),
        ("pixeldit-pixel", (2, 16384, 16384, 4, 64, None)),
        ("pixeldit-pixel-15552", (2, 15552, 15552, 4, 64, None))),
    "flash_attention_bwd": (
        ("pixeldit-patch", (4, 1024, 1024, 16, 64, None)),
        ("pixeldit-pixel", (2, 16384, 16384, 4, 64, None)),
        ("pixeldit-pixel-15552", (2, 15552, 15552, 4, 64, None))),
    "dot_product_attention_folded": (
        ("pixeldit-cross", (8, 1024, 300, 16, 64, _CAPTIONS)),),
    "dot_product_attention_folded_bwd": (
        ("pixeldit-cross", (4, 1024, 300, 16, 64, _CAPTIONS[4:])),),
    "adaln_layernorm": (("pixeldit-patch", (8, 1024, 1024)),
                        ("pixeldit-pixel", (8, 16384, 256))),
    "adaln_layernorm_bwd": (("pixeldit-patch", (4, 1024, 1024)),
                            ("pixeldit-pixel", (4, 16384, 256))),
}
PIXELDIT_TIMED_BATCH = {"flash_attention": 8, "flash_attention_bwd": 4}
# cases timed in bf16 only, their plain versions unheld (gigabytes of fp32
# scores): the UNet's, SD3.5's, Flux's and PixelDiT's attentions
TIMED_BF16_CASES = {(name, label)
                    for cases in (UNET_CASES, SD35_CASES, FLUX_CASES,
                                  PIXELDIT_CASES)
                    for name, pairs in cases.items() if "adaln" not in name
                    for label, _ in pairs}
# one process's shapes under tp and sp: K2 at 8 of 16 heads and at 128 of
# 256 queries, K6 and K6b at 512 of PixArt-Sigma's 1024 queries
TIMED_BF16_CASES |= {("dot_product_attention", "tp-cross"),
                     ("dot_product_attention", "sp-cross"),
                     ("flash_attention", "sp-self"),
                     ("flash_attention_bwd", "sp-self")}
# cases held at a smaller batch than they are timed at
TIMED_AT_BATCH = {("flash_attention_bwd", label): SD35_TIMED_BATCH
                  for label, _ in SD35_CASES["flash_attention_bwd"]}
TIMED_AT_BATCH.update({(name, label): FLUX_TIMED_BATCH[name]
                       for name in FLUX_TIMED_BATCH
                       for label, _ in FLUX_CASES[name]})
TIMED_AT_BATCH.update({(name, label): PIXELDIT_TIMED_BATCH[name]
                       for name in PIXELDIT_TIMED_BATCH
                       for label, _ in PIXELDIT_CASES[name]
                       if label.startswith("pixeldit-pixel")})


def kernel_cases(device):
    """(kernel name, case label, dtype, make_inputs, kernel_fn, plain_fn,
    library_fn, a (fwd+bwd, fwd) pair or None, bytes, flops, info_fn or
    None) for every case; the first case of each kernel is its main path's
    shape (``MAIN_CASE``), timed in bf16.  ``info_fn(*inputs)`` (K1, K1b, K3)
    describes the launch the kernel makes: its path, registers, local
    bytes, shared bytes and blocks per SM."""
    import torch
    import torch.nn.functional as F

    from yat_tpu_torch.ops import attention as A
    from yat_tpu_torch.ops import norm as N

    gen = torch.Generator(device=device).manual_seed(0)

    def randn(shape, dtype, scale=1.0):
        return (scale * torch.randn(shape, generator=gen, device=device)
                ).to(dtype)

    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        es = torch.finfo(dtype).bits // 8
        # K1: serving shape x [8, 256, 1152], modulators [8, 1, 1152];
        # training shape x [16, 256, 1152]; ragged: one batch element,
        # N = 77 rows; PixArt-Sigma's serving shape [8, 1024, 1152]; the
        # generic loop at another width, D = 1000 (the row in registers
        # takes D = 1152)
        for label, (b, n, d) in (("serve", (8, 256, 1152)),
                                 ("train", (16, 256, 1152)),
                                 ("ragged", (1, 77, 1152)),
                                 ("pixart-serve", (8, 1024, 1152)),
                                 ("generic", (4, 77, 1000)),
                                 *SD35_CASES["adaln_layernorm"],
                                 *FLUX_CASES["adaln_layernorm"],
                                 *PIXELDIT_CASES["adaln_layernorm"]):
            def make(b=b, n=n, d=d, dtype=dtype):
                return (randn((b, n, d), dtype), randn((b, 1, d), dtype, 0.1),
                        randn((b, 1, d), dtype, 0.1))

            def plain(x, sc, sh):
                return N.adaln_ref(x, sc.reshape(sc.shape[0], -1),
                                   sh.reshape(sh.shape[0], -1))
            cases.append(("adaln_layernorm", label, dtype, make,
                          N.adaln_layernorm, plain, None,
                          es * (2 * b * n * d + 2 * b * d),
                          8 * b * n * d,
                          getattr(N, "adaln_launch_info", None)))
        # K2: serving shape q [8, 256, 16, 72], k/v [8, 512, 16, 72] with
        # caption masks (uncond keeps 1 key, cond ~150); training shape
        # q [16, 256, 16, 72], k/v [16, 512, 16, 72] with the training
        # shard's captions (100-500 of 512 keys kept); ragged: N_k = 300
        # keeping 1-300 keys with N_q = 100, and N_k = 16 without a mask;
        # one request's CFG pair (batch 2, below one 128-query block per
        # SM); at the serving shape, kept keys in one middle or the last
        # 64-key tile only, or none (the tile walk of the forward body);
        # the self-attention of SANA's softmax-patched blocks in training,
        # q/k/v [16, 256, 36, 32], no key bias; the training cross-attention
        # of one process at {tp: 2} (8 of the 16 heads) and at {sp: 2} (128
        # of the 256 queries).  The ragged shapes lie outside the
        # short-sequence gate, so they reach the kernel through
        # implementation="vmem"
        for label, (b, nq, nk, h, d, keep) in (
                ("serve", (8, 256, 512, 16, 72,
                           [1, 1, 1, 1, 143, 151, 139, 160])),
                ("train-512", (16, 256, 512, 16, 72,
                               [100 + 400 * i // 15 for i in range(16)])),
                ("ragged-300", (4, 100, 300, 16, 72, [1, 37, 150, 300])),
                ("ragged-16", (2, 64, 16, 2, 32, None)),
                ("serve-1", (2, 256, 512, 16, 72, [1, 143])),
                ("serve-tiles", (8, 256, 512, 16, 72,
                                 [(130, 190), (200, 201), (480, 512),
                                  (500, 512), 0, (64, 128), 512, 0])),
                ("self-train", (16, 256, 256, 36, 32, None)),
                ("tp-cross", (16, 256, 512, 8, 72,
                              [100 + 400 * i // 15 for i in range(16)])),
                ("sp-cross", (16, 128, 512, 16, 72,
                              [100 + 400 * i // 15 for i in range(16)])),
                *UNET_CASES["dot_product_attention"]):
            def make(b=b, nq=nq, nk=nk, h=h, d=d, keep=keep, dtype=dtype):
                m = _mask(keep, nk, device) if keep is not None else None
                return (randn((b, nq, h, d), dtype),
                        randn((b, nk, h, d), dtype),
                        randn((b, nk, h, d), dtype), m)

            def plain(q, k, v, m):
                return A.attention_ref(q, k, v, A._key_bias(m, q.shape[0]))

            def library(q, k, v, m):
                am = None if m is None else m.bool()[:, None, None, :]
                return F.scaled_dot_product_attention(
                    q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                    attn_mask=am).transpose(1, 2)
            cases.append(("dot_product_attention", label, dtype, make,
                          _vmem_attention, plain, library,
                          *attention_work(b, nq, nk, h, d, es, keep, 5)))
        # K4 (K2's kernel where the JAX package folds heads): PixArt-Sigma
        # cross-attention q [8, 1024, 16, 72] over T5 captions k/v
        # [8, 300, 16, 72] keeping 10-300 keys; the longest key sequence
        # the short-sequence gate admits, N_k = 4096 at N_q = 128; at the
        # serving shape, kept keys in one middle or the last tile only, or
        # none
        for label, (b, nq, nk, h, d, keep) in (
                ("serve", (8, 1024, 300, 16, 72,
                           [10 + 290 * i // 7 for i in range(8)])),
                ("long-keys", (2, 128, 4096, 4, 72, [4096, 77])),
                ("serve-tiles", (8, 1024, 300, 16, 72,
                                 [(64, 128), (70, 80), (256, 300),
                                  (299, 300), 0, 300, (0, 64), 1])),
                *UNET_CASES["dot_product_attention_folded"],
                *PIXELDIT_CASES["dot_product_attention_folded"]):
            def make(b=b, nq=nq, nk=nk, h=h, d=d, keep=keep, dtype=dtype):
                return (randn((b, nq, h, d), dtype), randn((b, nk, h, d), dtype),
                        randn((b, nk, h, d), dtype), _mask(keep, nk, device))

            def plain(q, k, v, m):
                return A.attention_ref(q, k, v, A._key_bias(m, q.shape[0]))
            cases.append(("dot_product_attention_folded", label, dtype, make,
                          A.dot_product_attention, plain, _sdpa_masked,
                          *attention_work(b, nq, nk, h, d, es, keep)))
        # K6: PixArt-Sigma 512px self-attention q/k/v [8, 1024, 16, 72]
        # (the CFG call); 1024px, [2, 4096, 16, 72] in four key blocks;
        # masks keeping 0-1024 of 1024 keys (0: a fully masked row); a
        # ragged N_k = 1000 in eight key blocks of 128; kept keys in one
        # middle or the last tile only; 1024px with the first (or the
        # second) of the four key blocks fully masked; one process's
        # queries of PixArt-Sigma's self-attention at {sp: 2}, 512 of them
        # over the 1024 gathered keys
        for label, (b, nq, nk, h, d, keep) in (
                ("serve", (8, 1024, 1024, 16, 72, None)),
                ("1024px", (2, 4096, 4096, 16, 72, None)),
                ("masked", (4, 1024, 1024, 16, 72, [0, 1, 517, 1024])),
                ("ragged", (2, 1024, 1000, 16, 72, [1000, 333])),
                ("masked-tiles", (4, 1024, 1024, 16, 72,
                                  [(500, 520), (960, 1024), (1023, 1024),
                                   (0, 64)])),
                ("masked-blocks", (2, 4096, 4096, 16, 72,
                                   [(1024, 4096), (0, 1100)])),
                ("sp-self", (8, 512, 1024, 16, 72, None)),
                *UNET_CASES["flash_attention"],
                *SD35_CASES["flash_attention"],
                *FLUX_CASES["flash_attention"],
                *PIXELDIT_CASES["flash_attention"]):
            def make(b=b, nq=nq, nk=nk, h=h, d=d, keep=keep, dtype=dtype):
                bias = (None if keep is None else A._key_bias(
                    _mask(keep, nk, device), b, A.FLASH_MASK_VALUE))
                return (randn((b, nq, h, d), dtype),
                        randn((b, nk, h, d), dtype),
                        randn((b, nk, h, d), dtype), bias)
            cases.append(("flash_attention", label, dtype, make,
                          A._flash_attention_cuda, A.flash_attention_ref,
                          _sdpa_biased,
                          *attention_work(b, nq, nk, h, d, es, keep)))
        # K3: serving shape q/k/v [8, 256, 36, 32], training shape
        # [16, 256, 36, 32]; ragged: N = 100 and 17; head dim 64 at the
        # same width; the fp32 state (implementation "pallas", the JAX
        # package's Pallas math); NaN in one k entry (its head's outputs
        # all NaN) and one q entry (its row NaN).  Below N = 4096 "auto"
        # takes the JAX package's einsum branch, which rounds the state to
        # the compute dtype (round_kv)
        for label, (b, n, h, d), impl in (
                ("serve", (8, 256, 36, 32), "auto"),
                ("train", (16, 256, 36, 32), "auto"),
                ("ragged", (2, 100, 36, 32), "auto"),
                ("ragged-17", (2, 17, 36, 32), "auto"),
                ("d64", (8, 256, 18, 64), "auto"),
                ("fp32-state", (8, 256, 36, 32), "pallas"),
                ("nan", (8, 256, 36, 32), "auto"),
                ("tp-train", (16, 256, 18, 32), "auto")):
            def make(b=b, n=n, h=h, d=d, dtype=dtype, label=label):
                q, k, v = (randn((b, n, h, d), dtype) for _ in range(3))
                if label == "nan":
                    k[1, 100, 5, 7] = float("nan")
                    q[3, 200, 10, 3] = float("nan")
                return q, k, v

            def kern(q, k, v, impl=impl):
                return A.linear_attention(q, k, v, implementation=impl)

            def plain(q, k, v, impl=impl):
                return A.linear_attention_ref(
                    q, k, v,
                    round_kv=A.kv_rounding(q.shape[1], q.shape[3], impl))

            def info(q, k, v, impl=impl):
                return A.linear_attention_launch_info(q, k, v, impl)
            cases.append(("linear_attention", label, dtype, make, kern,
                          plain, None, es * 4 * b * n * h * d,
                          b * h * (4 * n * d * d + 4 * n * d),
                          info if hasattr(A, "linear_attention_launch_info")
                          else None))
        # K3s and K3a, K3's two products for token-sharded blocks: one
        # process's tokens of a SANA-0.6B training step at {sp: 2}, k/v and
        # q [16, 128, 36, 32]; ragged: N = 17 at head dim 64 (two state
        # columns a lane).  K3s reads k and v and writes the fp32 state
        # [B, H, D, D] and key sum; K3a reads q and the state (rounded to
        # the storage type: round_kv at the whole 256 tokens) and writes o
        for label, (b, n, h, d) in (("sp-train", (16, 128, 36, 32)),
                                    ("ragged-17", (2, 17, 4, 64))):
            state_bytes = 4 * b * h * (d * d + d)

            def make_kv(b=b, n=n, h=h, d=d, dtype=dtype):
                return (randn((b, n, h, d), dtype),
                        randn((b, n, h, d), dtype))
            cases.append(("linear_attention_state", label, dtype, make_kv,
                          A.linear_attention_state,
                          A.linear_attention_state_ref, None,
                          es * 2 * b * n * h * d + state_bytes,
                          b * h * n * (2 * d * d + d)))

            def make_q(b=b, n=n, h=h, d=d, dtype=dtype):
                kv, ksum = A.linear_attention_state_ref(
                    randn((b, n, h, d), dtype),
                    randn((b, n, h, d), dtype))
                return randn((b, n, h, d), dtype), kv, ksum

            def apply(q, kv, ksum):
                return A.linear_attention_apply(q, kv, ksum, 1e-15, True)

            def apply_ref(q, kv, ksum):
                return A.linear_attention_apply_ref(q, kv, ksum, 1e-15, True)
            cases.append(("linear_attention_apply", label, dtype, make_q,
                          apply, apply_ref, None,
                          es * 2 * b * n * h * d + state_bytes,
                          b * h * n * (2 * d * d + 3 * d)))
        # K1b: SANA's training shape x, g [16, 256, 1152], scale
        # [16, 1152]; PixArt-Sigma's [8, 1024, 1152]; ragged: one batch
        # element, N = 100; the generic loop at D = 1000 and on a D = 1152
        # view whose rows start one value off the vectors.  ~17 flops per
        # element.  The yardstick: LayerNorm's fused backward on the same
        # bytes (x as [B*N, D], one weight 1 + scale[0] shared across the
        # batch; mean and rstd made before the timing)
        for label, (b, n, d) in (("train", (16, 256, 1152)),
                                 ("pixart-train", (8, 1024, 1152)),
                                 ("ragged", (1, 100, 1152)),
                                 ("generic", (4, 77, 1000)),
                                 ("unaligned", (2, 100, 1152)),
                                 *SD35_CASES["adaln_layernorm_bwd"],
                                 *FLUX_CASES["adaln_layernorm_bwd"],
                                 *PIXELDIT_CASES["adaln_layernorm_bwd"]):
            def make(b=b, n=n, d=d, dtype=dtype, label=label):
                wide = d + (label == "unaligned")
                x = randn((b, n, wide), dtype)[..., wide - d:]
                return x, randn((b, d), dtype, 0.1), randn((b, n, d), dtype)

            def kern(x, sc, g):
                return N._adaln_bwd_cuda(x, sc, g, 1e-6)

            def plain(x, sc, g):
                return N.adaln_bwd_ref(x, sc, g, 1e-6)
            cases.append(("adaln_layernorm_bwd", label, dtype, make, kern,
                          plain, layer_norm_bwd_yardstick(),
                          es * (3 * b * n * d + 3 * b * d), 17 * b * n * d,
                          getattr(N, "adaln_bwd_launch_info", None)))
        # K2b: training shapes q/g [16, 256, 16, 72], k/v [16, L, 16, 72]
        # at the caption rungs L = 512 (the training shard's 100-500 kept
        # keys) and 128 (100-115 kept); ragged: L = 300 keeping 1-300 keys,
        # and L = 16 unmasked; the softmax-patched blocks' self-attention,
        # q/k/v/g [16, 256, 36, 32], no key bias
        for label, (b, nq, nk, h, d, keep) in (
                ("train-512", (16, 256, 512, 16, 72,
                               [100 + 400 * i // 15 for i in range(16)])),
                ("train-128", (16, 256, 128, 16, 72,
                               [100 + i for i in range(16)])),
                ("ragged-300", (4, 100, 300, 16, 72, [1, 37, 150, 300])),
                ("ragged-16", (2, 64, 16, 2, 32, None)),
                ("self-train", (16, 256, 256, 36, 32, None)),
                *UNET_CASES["dot_product_attention_bwd"]):
            def make(b=b, nq=nq, nk=nk, h=h, d=d, keep=keep, dtype=dtype):
                m = _mask(keep, nk, device) if keep is not None else None
                return (randn((b, nq, h, d), dtype),
                        randn((b, nk, h, d), dtype),
                        randn((b, nk, h, d), dtype), A._key_bias(m, b),
                        randn((b, nq, h, d), dtype))
            # the library yardstick: SDPA forward+backward, minus its
            # forward (both with inputs that require grad)
            cases.append(("dot_product_attention_bwd", label, dtype, make,
                          A._attention_bwd_cuda, A.attention_bwd_ref,
                          (_sdpa_fwd_bwd, _sdpa_fwd),
                          es * b * h * d * (3 * nq + 4 * nk)
                          + (4 * b * nk if keep is not None else 0),
                          10 * b * h * nq * nk * d + 8 * b * h * nq * nk))
        # K4b (K2b's kernel where the JAX package folds heads): PixArt-Sigma
        # cross-attention q/g [8, 1024, 16, 72] at the caption rungs
        # L = 300 and 256, keeping 10-L keys
        for label, nk in (("train-300", 300), ("train-256", 256)):
            b, nq, h, d = 8, 1024, 16, 72

            def make(nk=nk, dtype=dtype):
                m = _mask([10 + (nk - 10) * i // 7 for i in range(8)], nk,
                          device)
                return (randn((8, 1024, 16, 72), dtype),
                        randn((8, nk, 16, 72), dtype),
                        randn((8, nk, 16, 72), dtype), A._key_bias(m, 8),
                        randn((8, 1024, 16, 72), dtype))

            def kern(q, k, v, bias, g):
                return A._attention_bwd_cuda(q, k, v, bias, g, folded=True)
            cases.append(("dot_product_attention_folded_bwd", label, dtype,
                          make, kern, A.attention_bwd_ref,
                          (_sdpa_fwd_bwd, _sdpa_fwd),
                          es * b * h * d * (3 * nq + 4 * nk) + 4 * b * nk,
                          10 * b * h * nq * nk * d + 8 * b * h * nq * nk))
        # K4b at the UNet's and PixelDiT's folded cross-attentions
        # (UNET_CASES, PIXELDIT_CASES)
        for label, (b, nq, nk, h, d, keep) in (
                *UNET_CASES["dot_product_attention_folded_bwd"],
                *PIXELDIT_CASES["dot_product_attention_folded_bwd"]):
            def make(b=b, nq=nq, nk=nk, h=h, d=d, keep=keep, dtype=dtype):
                m = _mask(keep, nk, device)
                return (randn((b, nq, h, d), dtype),
                        randn((b, nk, h, d), dtype),
                        randn((b, nk, h, d), dtype), A._key_bias(m, b),
                        randn((b, nq, h, d), dtype))

            def kern(q, k, v, bias, g):
                return A._attention_bwd_cuda(q, k, v, bias, g, folded=True)
            cases.append(("dot_product_attention_folded_bwd", label, dtype,
                          make, kern, A.attention_bwd_ref,
                          (_sdpa_fwd_bwd, _sdpa_fwd),
                          es * b * h * d * (3 * nq + 4 * nk) + 4 * b * nk,
                          10 * b * h * nq * nk * d + 8 * b * h * nq * nk))
        # K6b: PixArt-Sigma 512px self-attention q/k/v/o/g [8, 1024, 16,
        # 72]; 1024px, [2, 4096, 16, 72] in four key blocks; a masked flash
        # case at PixArt-1024px's cross-attention shape, q [8, 4096, 16, 72]
        # over k/v [8, 256, 16, 72] keeping 0-256 keys (0: a fully masked
        # row); shapes the flash gate admits with several key blocks (N_k =
        # 640: five; head dim 256: three); a ragged N = 1000, called
        # directly; one process's queries at PixArt-Sigma's {sp: 2}, 512
        # over 1024 keys.  o, l and m come from K6's plain version
        for label, (b, nq, nk, h, d, keep) in (
                ("train", (8, 1024, 1024, 16, 72, None)),
                ("1024px", (2, 4096, 4096, 16, 72, None)),
                ("masked-cross", (8, 4096, 256, 16, 72,
                                  [0, 1, 37, 100, 128, 200, 255, 256])),
                ("blocks-640", (2, 1280, 640, 16, 72, [640, 311])),
                ("d256", (2, 1024, 384, 2, 256, [384, 100])),
                ("ragged", (2, 1000, 1000, 16, 72, [1000, 333])),
                ("sp-self", (8, 512, 1024, 16, 72, None)),
                *UNET_CASES["flash_attention_bwd"],
                *SD35_CASES["flash_attention_bwd"],
                *FLUX_CASES["flash_attention_bwd"],
                *PIXELDIT_CASES["flash_attention_bwd"]):
            def make(b=b, nq=nq, nk=nk, h=h, d=d, keep=keep, dtype=dtype):
                bias = (None if keep is None else A._key_bias(
                    _mask(keep, nk, device), b, A.FLASH_MASK_VALUE))
                q, k, v = (randn((b, n, h, d), dtype) for n in (nq, nk, nk))
                o, l, m = A.flash_attention_ref(q, k, v, bias,
                                                residuals=True)
                return q, k, v, bias, o, l, m, randn((b, nq, h, d), dtype)
            cases.append(("flash_attention_bwd", label, dtype, make,
                          A._flash_attention_bwd_cuda,
                          A.flash_attention_bwd_ref,
                          (_flash_sdpa_fwd_bwd, _flash_sdpa_fwd),
                          es * b * h * d * (4 * nq + 4 * nk) + 8 * b * h * nq
                          + (4 * b * nk if keep is not None else 0),
                          10 * b * h * nq * nk * d + 8 * b * h * nq * nk))
    return cases


def w8a8_inputs(t, k, n, dtype, device, seed=0, special=False):
    """An activation x ``[t, k]`` and an upstream gradient g ``[t, n]`` in
    ``dtype``, and an int8 base ``[k -> n]``: the payload q ``[n, k]`` and
    its fp32 scale, quantized from a lecun-normal weight.  ``special``
    zeroes rows 0-1 of x and g and puts one large value among the normal
    ones of rows 2-3."""
    import torch

    from yat_tpu_torch.ops import quant as Q
    gen = torch.Generator(device=device).manual_seed(seed)
    q, w_scale = Q.quantize_kernel(
        torch.randn((n, k), generator=gen, device=device) * k ** -0.5, 8)
    x = torch.randn((t, k), generator=gen, device=device)
    g = torch.randn((t, n), generator=gen, device=device)
    if special:
        for a in (x, g):
            a[0:2] = 0.0
            a[2, 5] = 1e4
            a[3, -1] = -3e4
    return x.to(dtype), q, w_scale, g.to(dtype)


def _bits(t):
    """A float tensor's bits, so that equality means bit equality."""
    import torch
    return t.view({torch.bfloat16: torch.int16, torch.float32: torch.int32,
                   torch.int8: torch.int8}[t.dtype])


def w8a8_mismatch(got, want):
    """The first step at which a K5/K5b result ``(out, payload, row
    scales)`` differs from its plain version's, in the order they are
    computed (payload, row scales, output), or None when all three are equal
    bit for bit."""
    (y, p, s), (yw, pw, sw) = got, want
    for step, a, b in (("int8 payload", p, pw), ("row scales", s, sw),
                       ("output", y, yw)):
        if a.shape != b.shape or a.dtype != b.dtype:
            return f"{step}: {a.dtype} {tuple(a.shape)} against {b.dtype} " \
                   f"{tuple(b.shape)}"
        differ = _bits(a) != _bits(b)
        if bool(differ.any()):
            worst = float((a.float() - b.float()).abs().max())
            return (f"{step}: {int(differ.sum())} of {a.numel()} entries "
                    f"differ (largest |difference| {worst:.3e})")
    return None


def _vmem_attention(q, k, v, m):
    """The public function, sent to K2's kernel whatever the shape."""
    from yat_tpu_torch.ops import attention as A
    return A.dot_product_attention(q, k, v, m, implementation="vmem")


def _sdpa_masked(q, k, v, m):
    """SDPA with a [B, N_k] keep-mask, on the [B, N, H, D] layout."""
    import torch.nn.functional as F
    return F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=m.bool()[:, None, None, :]).transpose(1, 2)


def _sdpa_biased(q, k, v, bias):
    """SDPA with K6's additive key bias (or none)."""
    import torch.nn.functional as F
    am = None if bias is None else bias[:, None, None, :].to(q.dtype)
    return F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=am).transpose(1, 2)


def _sdpa(q, k, v, bias):
    import torch.nn.functional as F
    am = None if bias is None else (bias > -1.0)[:, None, None, :]
    return F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=am)


def _sdpa_fwd(q, k, v, bias, g):
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    return _sdpa(*leaves, bias)


def _sdpa_fwd_bwd(q, k, v, bias, g):
    import torch
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    return torch.autograd.grad(_sdpa(*leaves, bias), leaves,
                               g.transpose(1, 2))


def _flash_sdpa_fwd(q, k, v, bias, o, l, m, g):
    return _sdpa_fwd(q, k, v, bias, g)


def _flash_sdpa_fwd_bwd(q, k, v, bias, o, l, m, g):
    return _sdpa_fwd_bwd(q, k, v, bias, g)


def flash_attention_bwd_without_di(q, k, v, bias, o, l, m, g):
    """A wrong K6b, for checking that the bf16 tolerance catches it: the
    plain flash backward with ``di = rowsum(o dO)`` dropped from ``ds``
    (a zero ``o``)."""
    import torch

    from yat_tpu_torch.ops import attention as A
    return A.flash_attention_bwd_ref(q, k, v, bias, torch.zeros_like(o), l,
                                     m, g)


def attention_bwd_without_row_term(q, k, v, bias, g):
    """A wrong K2b, for checking that the bf16 tolerance catches it: the
    plain backward with ``dS = P dP``, the ``rowsum(dP P)`` term dropped."""
    import torch

    from yat_tpu_torch.ops import attention as A
    acc = torch.float32
    scale = 1.0 / (q.shape[-1] ** 0.5)
    p = A._probs(q, k, bias, acc)
    dp = torch.einsum("bqhd,bkhd->bhqk", g.to(acc), v.to(acc))
    ds_c = (p * dp).to(q.dtype).to(acc)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds_c, k.to(acc)) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds_c, q.to(acc)) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(g.dtype).to(acc), g.to(acc))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def adaln_bwd_without_m2(x, scale, g, eps=1e-6):
    """A wrong K1b, for checking that the bf16 tolerance catches it: the
    plain backward with the ``xhat * m2`` term of dx dropped."""
    import torch

    from yat_tpu_torch.ops import norm as N
    x32, g32 = x.float(), g.float()
    d = x.shape[-1]
    mean = x32.sum(-1, keepdim=True) / d
    xc = x32 - mean
    inv = torch.rsqrt((xc * xc).sum(-1, keepdim=True) / d + eps)
    dxh = g32 * (1.0 + scale.float()[:, None, :])
    dx = inv * (dxh - dxh.sum(-1, keepdim=True) / d)
    _, dscale, dshift = N.adaln_bwd_ref(x, scale, g, eps)
    return dx.to(x.dtype), dscale, dshift


# name: (a backward without its row term, that term) for the power check
WRONG_BWD = {
    "adaln_layernorm_bwd": (adaln_bwd_without_m2, "xhat * m2"),
    "dot_product_attention_bwd": (attention_bwd_without_row_term,
                                  "rowsum(dP P)"),
    "dot_product_attention_folded_bwd": (attention_bwd_without_row_term,
                                         "rowsum(dP P)"),
    "flash_attention_bwd": (flash_attention_bwd_without_di,
                            "di = rowsum(o dO)")}


# kernels timed at every case of the kernel phase, both dtypes, beside
# their main case
TIMED_EVERY_CASE = ("adaln_layernorm", "linear_attention",
                    "adaln_layernorm_bwd", "linear_attention_state",
                    "linear_attention_apply")
# other cases timed in both dtypes and reported under their kernel's
# "cases": K2 and K2b at the softmax-patched SANA blocks' self-attention
TIMED_CASES = {("dot_product_attention", "self-train"),
               ("dot_product_attention_bwd", "self-train")}
# cases whose outputs hold NaN on purpose: their NaN must fall where the
# plain version's do (compare_nan); not timed
NAN_CASES = {("linear_attention", "nan")}


def launch_text(info):
    """A K1, K1b or K3 launch (``adaln_launch_info``, ``adaln_bwd_launch_
    info``, ``linear_attention_launch_info``) as text."""
    copy = (f", {info['copy_bytes']}-byte copies" if "copy_bytes" in info
            else "")
    return (f"path {info['path']}{copy}: {info['registers']} registers, "
            f"{info['local_bytes']} local (spill) bytes a thread, "
            f"{info['shared_bytes']} shared bytes, {info['blocks_per_sm']} "
            "blocks per SM")


# K1b's fp32 cases are held on this many draws, each against fp64 too
K1B_FP32_DRAWS = 4


def k1b_fp32_draws(name, label, make, kern, plain, args, got, want):
    """K1b's fp32 case ``label`` held on ``K1B_FP32_DRAWS`` draws (the
    first is the case's own, ``args``), and on each the token sums of the
    kernel and of the plain version against the plain version in fp64:
    the kernel's error is of the same kind as the plain version's, the
    order of the sums."""
    for draw in range(K1B_FP32_DRAWS):
        if draw:
            args = make()
            got, want = kern(*args), plain(*args)
        err, used, ok, tol = compare(name, got, want)
        exact = plain(*(t.double() for t in args))
        off = [max(float((o[i].double() - exact[i]).abs().max())
                   for i in (1, 2)) for o in (got, want)]
        log(f"{name} [{label}, float32] draw {draw}: max_abs_err "
            f"{err:.3e}, {used:.3f} of the allowance ({tol}) "
            f"{'ok' if ok else 'MISMATCH'}; the token sums off fp64 by "
            f"{off[0]:.3e} (kernel) and {off[1]:.3e} (plain)")
        if not ok:
            fail(f"{name} [{label}, float32] draw {draw} disagrees with its "
                 "plain version")


def phase_kernels(device, names=None, skip_labels=()):
    """Every kernel case (those of ``names`` only, when given, less the
    labels in ``skip_labels``) against its plain version; the main cases
    timed, and every case of K1, K1b and K3, each with the path its
    launch took."""
    import torch

    results = {}
    for case in kernel_cases(device):
        name, label, dtype, make, kern, plain, library, nbytes, flops = \
            case[:9]
        info_fn = case[9] if len(case) > 9 else None
        if (names is not None and name not in names) or label in skip_labels:
            continue
        args = make()
        got = kern(*args)
        want = plain(*args)
        torch.cuda.synchronize()
        dt = str(dtype).replace("torch.", "")
        path = "" if info_fn is None else launch_text(info_fn(*args))
        if (name, label) in NAN_CASES:
            count, where, err, used, ok, tol = compare_nan(name, got, want)
            log(f"{name} [{label}, {dt}] {count} NaN outputs "
                + ("where the plain version has them" if where
                   else "MISPLACED against the plain version's")
                + f"; the rest max_abs_err {err:.3e}, {used:.3f} of the "
                f"allowance ({tol}) {'ok' if ok else 'MISMATCH'}; {path}")
        else:
            err, used, ok, tol = compare(name, got, want)
            log(f"{name} [{label}, {dt}] max_abs_err {err:.3e}, {used:.3f} of "
                f"the allowance ({tol}) {'ok' if ok else 'MISMATCH'}"
                + (f"; {path}" if path else ""))
        if not ok:
            fail(f"{name} [{label}, {dt}] disagrees with its plain version")
        if name == "adaln_layernorm_bwd" and dtype == torch.float32:
            k1b_fp32_draws(name, label, make, kern, plain, args, got, want)
        if FWD_SKIP.get(name) and dtype == torch.bfloat16 \
                and args[3] is not None:
            # the tile walk: NaN in the K and V rows of every fully masked
            # 64-key tile changes no bit
            kept = (args[3] > -1.0 if FWD_SKIP[name] == "bias"
                    else args[3].bool())
            pk, pv = poison_masked_tiles(args[1], args[2], kept)
            if not torch.equal(kern(args[0], pk, pv, args[3]), got):
                fail(f"{name} [{label}, {dt}] reads a fully masked key "
                     "tile")
            log(f"{name} [{label}, {dt}] fully masked key tiles: never read")
        wrong = WRONG_BWD.get(name)
        if wrong is not None and dtype == torch.bfloat16:
            # the tolerance's power: a backward without its row term (K2b's
            # rowsum(dP P), K6b's di = rowsum(o dO)) must fail
            w_err, w_used, w_ok, _ = compare(name, wrong[0](*args), want)
            log(f"{name} [{label}, {dt}] a backward without {wrong[1]}: "
                f"max_abs_err {w_err:.3e}, {w_used:.1f} of the allowance "
                f"{'ACCEPTED' if w_ok else 'rejected'}")
            if w_ok:
                fail(f"{name} [{label}, {dt}]: the tolerance accepts a "
                     "backward without the row term")
        main = label == MAIN_CASE[name] and dtype == torch.bfloat16
        every = (name in TIMED_EVERY_CASE and (name, label) not in NAN_CASES
                 or (name, label) in TIMED_CASES
                 or ((name, label) in TIMED_BF16_CASES
                     and dtype == torch.bfloat16))
        if not (main or every):
            continue
        inputs = _rotations(make, nbytes)
        # the UNet's, SD3.5's and Flux's plain versions hold gigabytes of
        # fp32 scores and take 25-125 ms a call: timed unheld over 5
        # calls, and those held at a smaller batch (K6b's SD3.5 ones,
        # Flux's K6 and K6b) at that batch
        big = (name, label) in TIMED_BF16_CASES
        plain_ms = time_ms(plain, inputs, 5 if big else 20, hold=not big)
        held_b = args[0].shape[0]
        timed_b = TIMED_AT_BATCH.get((name, label), held_b)
        if timed_b != held_b:
            del inputs
            nbytes, flops = (x * timed_b // held_b for x in (nbytes, flops))
            inputs = _rotations(lambda: make(b=timed_b), nbytes)
        ms = time_ms(kern, inputs, 50)
        lib_ms = None
        if isinstance(library, tuple):
            lib_ms = time_ms(library[0], inputs, 50) - time_ms(
                library[1], inputs, 50)
        elif library:
            lib_ms = time_ms(library, inputs, 50)
        # the softmax attentions' products are tensor-core work on bf16
        # inputs; K1's, K1b's and K3's arithmetic is fp32 whatever the
        # storage type
        peak = (BF16_FLOPS if name.startswith(("dot_product_attention",
                                               "flash_attention"))
                else FP32_FLOPS)
        t_bytes = nbytes / HBM_BYTES_S * 1e3
        t_ops = flops / peak * 1e3
        bound = max(t_bytes, t_ops)
        bound_by = "bytes" if t_bytes >= t_ops else "operations"
        if main:
            results[name] = {"max_abs_err": err, "ms": ms,
                             "plain_ms": plain_ms, "library_ms": lib_ms,
                             "bound_ms": bound, "bound_by": bound_by,
                             "bytes": nbytes, "flops": flops,
                             **({"cases": results[name]["cases"]}
                                if "cases" in results.get(name, {}) else {})}
            if name == "adaln_layernorm_bwd":   # the wrapper's host time
                host = results[name]["host_us"] = w8a8_host_us(kern, inputs)
                log(f"{name} [{label}, {dt}] host {host:.1f} us a call (the "
                    "stream held)")
        at = ({} if timed_b == held_b else
              {"batch": timed_b, "plain_batch": held_b})
        if every:
            results.setdefault(name, {}).setdefault("cases", []).append(
                {"case": label, "dtype": dt, "path": path, "ms": ms,
                 "plain_ms": plain_ms, "library_ms": lib_ms,
                 "bound_ms": bound, "bound_by": bound_by, "max_abs_err": err,
                 **at})
        log(f"{name} [{label}, {dt}]"
            + ("" if not at else f" timed at batch {timed_b} (plain at "
               f"{held_b}, held there)")
            + f" kernel_ms {ms:.4f}  plain_ms "
            f"{plain_ms:.4f}  library_ms "
            f"{'null' if lib_ms is None else f'{lib_ms:.4f}'}  bound_ms "
            f"{bound:.4f} ({bound_by}: {nbytes / 1e6:.2f} MB, "
            f"{flops / 1e9:.3f} GFLOP)  kernel/bound {ms / bound:.2f}x"
            + ("" if lib_ms is None else
               f"  kernel/library {ms / lib_ms:.2f}x"))
    return results


# K5/K5b cases, [T, K] x [K -> N]: SANA-0.6B's attention projections on the
# image tokens (the main case) and on the caption, its GLUMB up-projection;
# PixArt-Sigma XL-2's MLP up and down; the gate's largest K at the smallest
# T, with zero rows and rows holding one large value
W8A8_CASES = (("sana-attn", (4096, 1152, 1152), False),
              ("sana-caption", (8192, 1152, 1152), False),
              ("sana-glumb-up", (4096, 1152, 5760), False),
              ("pixart-mlp-up", (8192, 1152, 4608), False),
              ("pixart-mlp-down", (8192, 4608, 1152), False),
              ("k6144-special", (128, 6144, 6144), True))


def w8a8_launch_info(t, k, n, bwd, dtype):
    """The launches of one K5 (or K5b, ``bwd``) call at [t, k] x [k -> n]:
    the GEMM's grid, its 128x128 tiles and ring stages, registers, local
    (spill) bytes a thread, shared bytes and blocks per SM, and the chunks
    of 16 values a lane of the quantize holds, its registers, local bytes,
    shared bytes and blocks per SM, from the CUDA runtime."""
    import ctypes

    from yat_tpu_torch.kernels.build import DTYPE_CODES, KERNELS
    fn = KERNELS["w8a8_matmul"].function(
        "yat_w8a8_launch_info", [ctypes.c_int] * 5 + [ctypes.c_void_p])
    buf = (ctypes.c_longlong * 12)()
    err = fn(t, k, n, int(bwd), DTYPE_CODES[str(dtype)],
             ctypes.addressof(buf))
    if err != 0:
        fail(f"w8a8 launch info at [{t}, {k}] x [{k} -> {n}] failed with "
             f"CUDA error {err}")
    keys = ("grid", "tiles", "stages", "regs", "local", "smem", "blocks",
            "q_hold", "q_regs", "q_local", "q_smem", "q_blocks")
    return dict(zip(keys, buf))


def w8a8_info_text(info):
    return (f"GEMM grid {info['grid']} blocks for {info['tiles']} tiles of "
            f"128x128, {info['stages']} ring stages")


def log_w8a8_launch_info():
    """Registers, spills, shared bytes and blocks per SM of K5's and K5b's
    bf16 launches at every case's shape, with the grid the launcher
    chooses."""
    import torch
    for label, (t, k, n), _ in W8A8_CASES:
        for name, bwd in (("w8a8_matmul", False), ("w8a8_matmul_bwd", True)):
            i = w8a8_launch_info(t, k, n, bwd, torch.bfloat16)
            log(f"  {name} bf16 [{label} {t}x{k}->{n}]: {w8a8_info_text(i)},"
                f" {i['regs']} registers, {i['local']} local (spill) bytes "
                f"a thread, {i['smem']} shared bytes, {i['blocks']} blocks "
                f"(12 warps) per SM; quantize holding {i['q_hold']} chunks "
                f"of 16 values a lane, {i['q_regs']} registers, "
                f"{i['q_local']} local bytes, {i['q_blocks']} blocks (8 "
                "warps) per SM")


def w8a8_split(call, inputs, iters=20):
    """Device milliseconds of the quantize launch and of the GEMM launch of
    one call, from a profiler window over ``iters`` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for args in inputs:
        call(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            call(*inputs[i % len(inputs)])
        torch.cuda.synchronize()
    sums = {"quantize": [0, 0.0], "gemm": [0, 0.0]}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        for part, acc in sums.items():
            if part in e.name:
                acc[0] += 1
                acc[1] += e.time_range.end - e.time_range.start
    if any(n != iters for n, _ in sums.values()):
        log(f"w8a8 split: the profiler holds {sums['quantize'][0]} quantize "
            f"and {sums['gemm'][0]} GEMM records of {iters} calls")
    return tuple(t / 1e3 / max(n, 1) for n, t in sums.values())


def w8a8_host_us(call, inputs, calls=200):
    """Host microseconds a call takes to enqueue, the stream held so the
    queue never drains."""
    import torch
    for args in inputs:
        call(*args)
    torch.cuda.synchronize()
    torch.cuda._sleep(2_000_000_000)
    t0 = time.perf_counter()
    for i in range(calls):
        call(*inputs[i % len(inputs)])
    host = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return host


def w8a8_host_parts(name, inputs):
    """The parts of a K5 (or K5b) wrapper's host time at one case, in
    microseconds a call: the C entry point through ctypes (its checks, the
    two tensor maps' encoding and the two launches) and the wrapper's three
    ``torch.empty`` (output, payload, row scales); the rest of the
    wrapper's time is its Python."""
    import torch

    from yat_tpu_torch.kernels.build import dtype_code, stream_of
    from yat_tpu_torch.ops import quant as Q
    x, q, s, g = inputs[0]
    a = x if name == "w8a8_matmul" else g
    t, c = a.shape
    out_w = q.shape[0] if name == "w8a8_matmul" else q.shape[1]
    entry = (Q.W8A8_MATMUL if name == "w8a8_matmul"
             else Q.W8A8_MATMUL_BWD).function()
    out = torch.empty((t, out_w), dtype=a.dtype, device=a.device)
    a8 = torch.empty((t, c), dtype=torch.int8, device=a.device)
    rs = torch.empty((t,), dtype=torch.float32, device=a.device)
    ptrs = (a.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr(),
            a8.data_ptr(), rs.data_ptr(), t, q.shape[1], q.shape[0],
            dtype_code(a), stream_of(a))
    entry_us = w8a8_host_us(lambda: entry(*ptrs), [()])
    empty_us = w8a8_host_us(
        lambda: (torch.empty((t, out_w), dtype=a.dtype, device=a.device),
                 torch.empty((t, c), dtype=torch.int8, device=a.device),
                 torch.empty((t,), dtype=torch.float32, device=a.device)),
        [()])
    return entry_us, empty_us


def phase_w8a8_kernels(device):
    """K5 and K5b against their plain versions, bit for bit (the int8
    payload, the row scales, the output), on every case in bf16 and fp32,
    with the grid the launcher chose; then the main case timed in bf16
    beside its bound, the quantize's and the GEMM's device time apart, the
    host's cost per call, and three labelled library times:
    ``torch._int_mm`` on the already quantized operands (the int8 GEMM
    alone) with the weight K-major (the layout cuBLAS's int8 GEMM wants;
    ``library_ms``) and row-major, and bf16 ``F.linear`` on the dequantized
    weight (what the path runs without ``int8_w8a8``)."""
    import torch
    import torch.nn.functional as F

    from yat_tpu_torch.ops import quant as Q

    # name: (kernel, plain version, the case's input it takes)
    kinds = {"w8a8_matmul": (Q._w8a8_cuda, Q.w8a8_matmul_ref, 0),
             "w8a8_matmul_bwd": (Q._w8a8_bwd_cuda, Q.w8a8_matmul_bwd_ref, 3)}
    results = {}
    for dtype in (torch.bfloat16, torch.float32):
        dt = str(dtype).replace("torch.", "")
        for label, (t, k, n), special in W8A8_CASES:
            case = w8a8_inputs(t, k, n, dtype, device, seed=t + k + n,
                               special=special)
            x, q, w_scale = case[:3]
            for name, (kern, plain, arg) in kinds.items():
                got = kern(case[arg], q, w_scale, quantized=True)
                want = plain(case[arg], q, w_scale, quantized=True)
                torch.cuda.synchronize()
                bad = w8a8_mismatch(got, want)
                info = w8a8_launch_info(t, k, n, arg == 3, dtype)
                log(f"{name} [{label} {t}x{k}->{n}, {dt}] payload, row "
                    f"scales and output {'bit-equal' if bad is None else 'DIFFER: ' + bad}"
                    f" ({w8a8_info_text(info)})")
                if bad is not None:
                    fail(f"{name} [{label}, {dt}] differs from its plain "
                         f"version at the {bad}")
                if label != "sana-attn" or dtype != torch.bfloat16:
                    continue
                es = 2
                act, out = (k, n) if name == "w8a8_matmul" else (n, k)
                nbytes = es * t * (act + out) + n * k + 4 * n
                ops = 2 * t * k * n
                inputs = _rotations(
                    lambda: w8a8_inputs(t, k, n, dtype, device,
                                        seed=len(results))[:4], nbytes)
                call = (lambda x, q, s, g, kern=kern, arg=arg:
                        kern((x, q, s, g)[arg], q, s))
                ms = time_ms(call, inputs, 50)
                quantize_ms, gemm_ms = w8a8_split(call, inputs)
                host_us = w8a8_host_us(call, inputs)
                entry_us, empty_us = w8a8_host_parts(name, inputs)
                plain_ms = time_ms(
                    lambda x, q, s, g, plain=plain, arg=arg:
                    plain((x, q, s, g)[arg], q, s), inputs, 5)
                # the library: the int8 GEMM of the quantized operands
                # (x8 [T, K] . qᵀ forward, g8 [T, N] . q backward) with the
                # weight K-major (copies made here, outside the timed calls)
                # and row-major, and the bf16 matmul with the dequantized
                # weight w [N, K]
                fwd = name == "w8a8_matmul"
                lib_in = []
                for x_, q_, s_, g_ in inputs:
                    a8 = Q.row_quantize(x_.float() if fwd else
                                        g_.float() * s_[None, :])[0]
                    # B [contraction, out] in both layouts
                    b_kmajor = q_.t() if fwd else q_.t().contiguous().t()
                    b_rowmajor = q_.t().contiguous() if fwd else q_
                    lib_in.append((a8, b_kmajor, b_rowmajor,
                                   Q.dequantize_kernel(q_, s_, dtype),
                                   x_ if fwd else g_))
                int_mm_ms = time_ms(
                    lambda a8, bk, br, w, a: torch._int_mm(a8, bk), lib_in, 50)
                int_mm_row_ms = time_ms(
                    lambda a8, bk, br, w, a: torch._int_mm(a8, br), lib_in,
                    50)
                linear_ms = time_ms(
                    (lambda a8, bk, br, w, a: F.linear(a, w)) if fwd else
                    (lambda a8, bk, br, w, a: a @ w), lib_in, 50)
                t_bytes = nbytes / HBM_BYTES_S * 1e3
                t_ops = ops / INT8_OPS * 1e3
                bound = max(t_bytes, t_ops)
                results[name] = {
                    "max_abs_err": float((got[0].float()
                                          - want[0].float()).abs().max()),
                    "ms": ms, "plain_ms": plain_ms, "library_ms": int_mm_ms,
                    "library": "torch._int_mm on the quantized operands, "
                               "the weight K-major",
                    "int_mm_row_major_ms": int_mm_row_ms,
                    "bf16_linear_ms": linear_ms,
                    "quantize_ms": quantize_ms, "gemm_ms": gemm_ms,
                    "host_us": host_us, "host_entry_us": entry_us,
                    "host_empty_us": empty_us,
                    "bound_ms": bound,
                    "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                    "bytes": nbytes, "flops": ops}
                log(f"{name} [{label}, bf16] kernel_ms {ms:.4f} "
                    f"({ms / bound:.1f}x the bound; profiled: quantize "
                    f"{quantize_ms:.4f} ms + GEMM {gemm_ms:.4f} ms)  plain_ms "
                    f"{plain_ms:.4f}  bound_ms {bound:.4f} "
                    f"({results[name]['bound_by']}: {nbytes / 1e6:.2f} MB, "
                    f"{ops / 1e9:.3f} G int8 operations)  library: "
                    f"torch._int_mm {int_mm_ms:.4f} ms with the weight "
                    f"K-major, {int_mm_row_ms:.4f} ms row-major (the int8 "
                    f"GEMM alone), bf16 matmul on the dequantized weight "
                    f"{linear_ms:.4f} ms; host {host_us:.1f} us a call "
                    f"(the C entry point {entry_us:.1f}, three torch.empty "
                    f"{empty_us:.1f}, the wrapper's Python the rest)")
    return results


# ---------------------------------------------------------------------------
# 4. reference: the CUDA path against the CPU path on a small input
# ---------------------------------------------------------------------------

def phase_reference(device):
    import copy
    import dataclasses

    import torch

    from yat_tpu_torch.kernels.build import launch_counts, reset_launch_counts
    from yat_tpu_torch.models.layers import init_params
    from yat_tpu_torch.models.pixart import PIXART_SIGMA_XL2, \
        PixArtTransformer2D
    from yat_tpu_torch.models.sana import SANA_600M, SanaTransformer2D

    rng = np.random.default_rng(0)
    t = np.array([999.0, 412.5], np.float32)
    mask = (np.arange(300)[None] < np.array([[1], [217]])).astype(np.int32)
    sana = dataclasses.replace(SANA_600M, num_layers=2,
                               softmax_self_attn_blocks=(1,))
    pixart = dataclasses.replace(PIXART_SIGMA_XL2, num_layers=2)
    # (label, denoiser, latent grid, kernel launches on the card)
    for label, cls, cfg, grid, kernels in (
            ("SANA (one softmax self-attention block)", SanaTransformer2D,
             sana, 16, {"dot_product_attention": 3, "linear_attention": 1}),
            ("PixArt-Sigma XL-2 512px", PixArtTransformer2D, pixart, 64,
             {"flash_attention": 2, "dot_product_attention_folded": 2,
              "attention_xla": 0})):
        cpu = cls(cfg, dtype=torch.float32)
        init_params(cpu, torch.Generator().manual_seed(0))
        gpu = copy.deepcopy(cpu).to(device)
        lat = rng.standard_normal((2, grid, grid, cfg.in_channels),
                                  np.float32)
        emb = rng.standard_normal((2, 300, cfg.caption_channels), np.float32)
        with torch.inference_mode():
            want = cpu(*(torch.from_numpy(a) for a in (lat, emb, t)),
                       torch.from_numpy(mask))
            reset_launch_counts()
            got = gpu(*(torch.from_numpy(a).to(device) for a in (lat, emb, t)),
                      torch.from_numpy(mask).to(device)).cpu()
        counts = launch_counts()
        err = float((got - want).abs().max())
        # fp32 throughout (TF32 off): reduction order only
        ok = bool(torch.isfinite(got).all()) and err <= 1e-3 + 1e-3 * float(
            want.abs().max())
        log(f"reference: 2-block full-width {label}, CUDA vs CPU, fp32: "
            f"max_abs_err {err:.3e} (tol 1e-3 + 1e-3 * max|ref|) "
            f"{'ok' if ok else 'MISMATCH'}; launches "
            f"{ {k: counts[k] for k in kernels} }")
        if not ok:
            fail(f"the CUDA {label} denoiser disagrees with the CPU one")
        if any(counts[k] != n for k, n in kernels.items()):
            fail(f"reference {label}: launches {counts}, expected {kernels}")
        del cpu, gpu


# ---------------------------------------------------------------------------
# 5. gradient reference: LoRA gradients through the kernels against the CPU
# ---------------------------------------------------------------------------

LORA_TARGETS = ["to_q", "to_k", "to_v", "to_out"]
# the adapter kinds beside LoRA, by the config keys that select them
ADAPTER_KINDS = {"loha": {"lora_algo": "loha"},
                 "lokr": {"lora_algo": "lokr"},
                 "fourierft": {"lora_algo": "fourierft",
                               "fourierft_n_frequency": "1000"},
                 "dora": {"lora_algo": "lora", "lora_use_dora": "true"}}


def seeded_state(cls, cfg):
    """The parameters of an fp32 ``cls(cfg)`` initialised from seed 0 (a
    state dict: cases that share the base build it once)."""
    import torch

    from yat_tpu_torch.models.layers import init_params

    model = cls(cfg, dtype=torch.float32)
    init_params(model, torch.Generator().manual_seed(0))
    return model.state_dict()


def lora_pair(cls, cfg, rank, device, kind="lora", base=None):
    """An fp32 ``cls(cfg)`` on the CPU from seeds (``base``: its
    :func:`seeded_state`, when the caller holds it), with a rank-``rank``
    adapter of ``kind`` (a key of ``ADAPTER_KINDS``, or LoRA) on
    ``LORA_TARGETS`` whose zero-initialised leaves (LoRA's ``lora_b``, and
    the others' ``hada_w2_b``, ``lokr_w2_b``, ``fft_spectrum``) are drawn
    nonzero (so every leaf gets gradients), and its copy on ``device``;
    returns both and the number of adapted modules."""
    import copy

    import torch

    from yat_tpu_torch.adapters.builder import (
        AdapterSpec, adapter_parameters, build_adapter_params)

    cpu = cls(cfg, dtype=torch.float32)
    cpu.load_state_dict(seeded_state(cls, cfg) if base is None else base)
    keys = ADAPTER_KINDS.get(kind, {})
    spec = AdapterSpec(keys.get("lora_algo", "lora"), rank=rank, alpha=rank,
                       target_modules=LORA_TARGETS,
                       use_dora="lora_use_dora" in keys,
                       n_frequency=int(keys.get("fourierft_n_frequency",
                                                1000)))
    n = build_adapter_params(cpu, spec, torch.Generator().manual_seed(1))
    gen = torch.Generator().manual_seed(2)
    with torch.no_grad():
        for _, p in adapter_parameters(cpu):
            if not bool((p != 0).any()):
                p.normal_(0.0, 0.02, generator=gen)
    return cpu, copy.deepcopy(cpu).to(device), n


def phase_grad_reference(device, width=None,
                         kinds=("lora",) + tuple(ADAPTER_KINDS)):
    """Two full-width SANA blocks (block 1 with softmax self-attention)
    with an adapter of each of ``kinds`` on ``LORA_TARGETS``: one
    flow-matching loss and every adapter leaf's gradient on the card
    against the CPU, fp32, within ``GRAD_REF_TOL`` of each leaf's largest
    entry once the flipped ReLU kinks' share is added.  ``width`` shrinks
    the blocks for a rehearsal on the CPU."""
    import dataclasses

    import torch

    from yat_tpu_torch.models.sana import SANA_600M, SanaTransformer2D
    from yat_tpu_torch.ops.schedulers import FlowMatchSchedule

    cfg = dataclasses.replace(SANA_600M, num_layers=2,
                              softmax_self_attn_blocks=(1,), **(width or {}))
    rng = np.random.default_rng(0)
    lat = rng.standard_normal((2, 16, 16, cfg.in_channels), np.float32)
    emb = rng.standard_normal((2, 300, cfg.caption_channels), np.float32)
    mask = (np.arange(300)[None] < np.array([[1], [217]])).astype(np.int32)
    sched = FlowMatchSchedule(shift=3.0)
    ts, sig = sched.training_draw(torch.Generator().manual_seed(3), 2)
    noise = rng.standard_normal(lat.shape, np.float32)
    base = seeded_state(SanaTransformer2D, cfg)
    for kind in kinds:
        _grad_reference_case(device, cfg, kind, sched, lat, emb, mask, ts,
                             sig, noise, base)


def _grad_reference_case(device, cfg, kind, sched, lat, emb, mask, ts, sig,
                         noise, base=None):
    import torch

    from yat_tpu_torch.adapters.builder import adapter_parameters
    from yat_tpu_torch.models.sana import SanaTransformer2D
    from yat_tpu_torch.train.step import loss_and_grads
    from yat_tpu_torch.train.tasks import make_flow_matching_loss

    cpu, gpu, n = lora_pair(SanaTransformer2D, cfg, 8, device, kind, base)
    results = []
    for model, dev in ((cpu, torch.device("cpu")), (gpu, device)):
        batch = {"latents": torch.from_numpy(lat).to(dev),
                 "embeddings": torch.from_numpy(emb).to(dev),
                 "text_mask": torch.from_numpy(mask).to(dev)}
        draws = {"timesteps": ts.to(dev), "sigmas": sig.to(dev),
                 "noise": torch.from_numpy(noise).to(dev)}
        leaves = [p for _, p in adapter_parameters(model)]
        seen = {}
        hooks = _relu_input_hooks(model.blocks[0].attn1, seen)
        loss, grads = loss_and_grads(make_flow_matching_loss(model, sched),
                                     leaves, batch, torch.Generator(), draws)
        for h in hooks:
            h.remove()
        results.append((float(loss), [g.detach().cpu() for g in grads],
                        {k: {n: t.cpu() for n, t in v.items()}
                         for k, v in seen.items()}))
    (loss_c, grads_c, seen_c), (loss_g, grads_g, seen_g) = results
    names = [name for name, _ in adapter_parameters(cpu)]
    loss_err = abs(loss_g - loss_c) / abs(loss_c)
    # ReLU(q) and ReLU(k) of block 0's linear attention pass a gradient only
    # where the pre-activation is > 0.  A pre-activation within rounding of
    # 0 can fall on either side on the two devices; its whole gradient then
    # reaches to_q's (to_k's) leaves on one device only.  Each such flip is
    # counted, and its share of the leaves' gradients (the adapter's own
    # backward of Δg, the card's minus the CPU's gradient at the flipped
    # entries) is added to the CPU's gradients; then every entry of every
    # leaf must agree
    expected, flips = with_flips_share(cpu.blocks[0].attn1, "blocks_0.attn1",
                                       dict(zip(names, grads_c)), seen_c,
                                       seen_g)
    zero, rows, ok = [], [], loss_err <= 1e-4
    for name, gc, gg in zip(names, grads_c, grads_g):
        scale = float(gc.abs().max())
        raw = float((gg - gc).abs().max()) / scale
        fixed = float((gg.double() - expected[name]).abs().max()) / scale
        rows.append((fixed, raw, name, scale))
        ok = ok and fixed <= GRAD_REF_TOL and bool(torch.isfinite(gg).all())
        if not bool((gg != 0).any()):
            zero.append(name)
    for fixed, raw, name, scale in sorted(rows, key=lambda r: -r[1])[:3]:
        log(f"grad reference {kind}:   {name}: max|g| {scale:.3e}; "
            f"max|dg|/max|g| {raw:.2e} as measured, {fixed:.2e} with the "
            "flips' share")
    log(f"grad reference {kind}: 2-block full-width SANA with {kind} on {n} "
        f"modules ({len(names)} leaves), {device.type} vs CPU, fp32: loss "
        f"{loss_g:.6f} vs {loss_c:.6f} (rel {loss_err:.2e}, tol 1e-4); ReLU "
        f"kinks flipped between the devices in block 0's linear attention: "
        f"{flips.get('to_q', 0)} of q, {flips.get('to_k', 0)} of k; worst "
        f"leaf max|dg|/max|g| {max(r[1] for r in rows):.2e} as measured, "
        f"{max(r[0] for r in rows):.2e} with the flips' share (tol "
        f"{GRAD_REF_TOL:g}); zero gradients on the card: {len(zero)}")
    if zero:
        fail(f"{kind} leaves with no gradient on the card: {zero[:4]}")
    if not ok:
        fail(f"{kind} gradients on the card disagree with the CPU")


def phase_full_ft_grad_reference(device, width=None):
    """The two SANA blocks of :func:`phase_grad_reference` (block 1 with
    softmax self-attention) under full fine-tuning: every parameter's
    gradient on the card against the CPU's, fp32.  The card runs first and
    keeps block 0's ReLU(q), ReLU(k) pre-activations; where the CPU's fall
    on the other side of 0, the CPU takes the card's value (its gradient
    passed through), so a kink's flip reaches no leaf upstream of it.  Each
    leaf within ``GRAD_REF_TOL`` of its largest entry; the softmax
    attentions' key biases, whose gradient is 0 in exact arithmetic (the
    bias shifts a whole row of logits), within it of the largest entry of
    every leaf.  ``width`` shrinks the blocks for a rehearsal on the
    CPU."""
    import copy
    import dataclasses

    import torch

    from yat_tpu_torch.convert import flax_named_parameters
    from yat_tpu_torch.models.layers import init_params
    from yat_tpu_torch.models.sana import SANA_600M, SanaTransformer2D
    from yat_tpu_torch.ops.schedulers import FlowMatchSchedule
    from yat_tpu_torch.train.step import loss_and_grads
    from yat_tpu_torch.train.tasks import make_flow_matching_loss

    cfg = dataclasses.replace(SANA_600M, num_layers=2,
                              softmax_self_attn_blocks=(1,), **(width or {}))
    cpu = SanaTransformer2D(cfg, dtype=torch.float32)
    init_params(cpu, torch.Generator().manual_seed(0))
    gpu = copy.deepcopy(cpu).to(device)
    rng = np.random.default_rng(0)
    lat = rng.standard_normal((2, 16, 16, cfg.in_channels), np.float32)
    emb = rng.standard_normal((2, 300, cfg.caption_channels), np.float32)
    mask = (np.arange(300)[None] < np.array([[1], [217]])).astype(np.int32)
    sched = FlowMatchSchedule(shift=3.0)
    ts, sig = sched.training_draw(torch.Generator().manual_seed(3), 2)
    noise = rng.standard_normal(lat.shape, np.float32)
    attn = {"card": gpu.blocks[0].attn1, "cpu": cpu.blocks[0].attn1}
    card_y, flips, runs = {}, {}, {}
    for where, model, dev in (("card", gpu, device),
                              ("cpu", cpu, torch.device("cpu"))):
        for p in model.parameters():
            p.requires_grad_(True)

        def hook(proj, where=where):
            def run(module, inputs, out):
                if where == "card":
                    card_y[proj] = out.detach().cpu()
                    return out
                y = card_y[proj]
                flip = (out > 0) != (y > 0)
                flips[proj] = int(flip.sum())
                return torch.where(flip, y + (out - out.detach()), out)
            return run
        hooks = [getattr(attn[where], p).register_forward_hook(hook(p))
                 for p in ("to_q", "to_k")]
        batch = {"latents": torch.from_numpy(lat).to(dev),
                 "embeddings": torch.from_numpy(emb).to(dev),
                 "text_mask": torch.from_numpy(mask).to(dev)}
        draws = {"timesteps": ts.to(dev), "sigmas": sig.to(dev),
                 "noise": torch.from_numpy(noise).to(dev)}
        named = flax_named_parameters(model)
        loss, grads = loss_and_grads(make_flow_matching_loss(model, sched),
                                     [p for _, p in named], batch,
                                     torch.Generator(), draws)
        for h in hooks:
            h.remove()
        runs[where] = (float(loss), {n: g.detach().cpu() for (n, _), g
                                     in zip(named, grads)})
    (loss_g, grads_g), (loss_c, grads_c) = runs["card"], runs["cpu"]
    loss_err = abs(loss_g - loss_c) / abs(loss_c)
    top = max(float(g.abs().max()) for g in grads_c.values())
    rows, zero, ok = [], [], loss_err <= 1e-4
    for name, gc in grads_c.items():
        gg = grads_g[name]
        diff = float((gg - gc).abs().max())
        key_bias = name.endswith("to_k.bias")
        scale = top if key_bias else float(gc.abs().max())
        rows.append((diff / scale, name, key_bias))
        ok = ok and diff <= GRAD_REF_TOL * scale and bool(
            torch.isfinite(gg).all())
        if not key_bias and not bool((gg != 0).any()):
            zero.append(name)
    for err, name, key_bias in sorted(rows, reverse=True)[:3]:
        log(f"full-FT grad reference:   {name}: max|dg| / "
            f"{'the largest gradient' if key_bias else 'max|g|'} {err:.2e}")
    worst = max(r[0] for r in rows if not r[2])
    worst_bias = max((r[0] for r in rows if r[2]), default=0.0)
    log(f"full-FT grad reference: 2-block full-width SANA, every one of "
        f"{len(rows)} parameters trained, CUDA vs CPU, fp32: loss "
        f"{loss_g:.6f} vs {loss_c:.6f} (rel {loss_err:.2e}, tol 1e-4); "
        f"ReLU kinks on the other side on the CPU, set to the card's: "
        f"{flips.get('to_q', 0)} of q, {flips.get('to_k', 0)} of k; worst "
        f"leaf max|dg|/max|g| {worst:.2e}, softmax key biases "
        f"{worst_bias:.2e} of the largest gradient (tol {GRAD_REF_TOL:g}); "
        f"zero gradients on the card: {len(zero)}")
    if zero:
        fail(f"parameters with no gradient on the card: {zero[:4]}")
    if not ok:
        fail("full fine-tuning gradients on the card disagree with the CPU")


def with_flips_share(attn, path, grads, seen_a, seen_b):
    """``grads`` (name → the adapter gradients of run a), in fp64, plus
    the share of the ReLU kinks of the linear attention ``attn`` (named
    ``path``) that fall on the other side in run b: for each of to_q and
    to_k, Δg is b's minus a's gradient at the entries whose pre-activation
    is > 0 in one run only, and each adapter leaf gains the gradient of
    ``⟨x W'ᵀ, Δg⟩`` with respect to it (``W'`` the layer's adapted
    weight; for LoRA ``s xᵀ (Δg Bᵀ)`` for A and ``s (xA)ᵀ Δg`` for B).
    Returns those gradients and the flips per projection."""
    import torch
    import torch.nn.functional as F

    from yat_tpu_torch.models.layers import adapter_delta
    out = {name: g.detach().double() for name, g in grads.items()}
    flips = {}
    for proj, a_run in seen_a.items():
        b_run = seen_b[proj]
        flip = (a_run["y"] > 0) != (b_run["y"] > 0)
        flips[proj] = int(flip.sum())
        dg = torch.where(flip, b_run["g"] - a_run["g"], 0.0).double()
        dg = dg.reshape(-1, dg.shape[-1])
        x = a_run["x"].double().reshape(-1, a_run["x"].shape[-1])
        m = getattr(attn, proj)
        names = [n for n, _ in m.adapter_leaves()]
        leaves = [p.detach().cpu().double().requires_grad_()
                  for _, p in m.adapter_leaves()]
        w = m.base_weight(torch.float64).cpu()
        if m.adapter_kind == "lora":
            weff = w + m.lora_scale * (leaves[0] @ leaves[1]).t()
        else:
            weff = adapter_delta(m.adapter_kind, leaves, m.lora_scale, w,
                                 torch.float64, m.fft_indices)
        share = torch.autograd.grad((F.linear(x, weff) * dg).sum(), leaves)
        for name, g in zip(names, share):
            out[f"{path}.{proj}.{name}"] += g
    return out, flips


def _relu_input_hooks(attn, seen):
    """Hooks that keep, for the linear attention ``attn``'s to_q and to_k,
    the input, the output (the pre-activation of ReLU(q), ReLU(k)) and the
    loss's gradient with respect to that output."""
    def keep(proj):
        def hook(module, inputs, out):
            seen[proj] = {"x": inputs[0].detach(), "y": out.detach()}
            out.register_hook(
                lambda g: seen[proj].__setitem__("g", g.detach()))
        return hook
    return [getattr(attn, p).register_forward_hook(keep(p))
            for p in ("to_q", "to_k")]


# an int8 rounding that lands on the other side in two runs is a flip only
# where the unrounded value lies within this share of a step of the midpoint
# between the two steps (the runs' values differ by a few fp32 ulps)
FLIP_TIE = 1e-2


class W8A8Payloads:
    """The int8 payloads of every kernel-shape ``w8a8_matmul`` call of the
    given models (the activation rows forward, the rows of g * w_scale
    backward), keyed by (the calling module's path, "fwd" or "bwd", the
    call's number for that module).

    ``recording()``: a run keeps its payloads in ``seen`` (the card's, read
    back from K5/K5b, or the plain versions'). ``forcing(reference)``: the
    plain versions of a CPU run hold each payload against the reference's.
    An entry rounded to the other side must differ by one step, with its
    unrounded value within ``FLIP_TIE`` of a step of the midpoint: it is
    counted in ``flips``, and this run takes the reference's step there, so
    that the rest of the run sees the same rounding.  Any other difference
    goes to ``bad``."""

    def __init__(self, models):
        self.paths = {}
        for model in models:
            for path, m in model.named_modules():
                if getattr(m, "qweight", None) is not None:
                    self.paths[m.qweight.data_ptr()] = path
        self.seen, self.reference = {}, None
        self.flips, self.worst_tie, self.bad = 0, 0.0, []
        self._calls = {}

    def _key(self, q, kind):
        path = self.paths[q.data_ptr()]
        n = self._calls.get((path, kind), 0)
        self._calls[(path, kind)] = n + 1
        return path, kind, n

    def _take(self, key, mine, unrounded):
        import torch
        ref = self.reference.get(key)
        if ref is None or ref.shape != mine.shape:
            self.bad.append(f"{key}: no reference payload of its shape")
            return mine
        ref = ref.to(mine.device)
        differ = mine != ref
        if bool(differ.any()):
            step = int((mine[differ].int() - ref[differ].int()).abs().max())
            v = unrounded[differ].abs()
            tie = float(((v - v.floor()) - 0.5).abs().max())
            self.worst_tie = max(self.worst_tie, tie)
            self.flips += int(differ.sum())
            if step != 1 or tie > FLIP_TIE:
                self.bad.append(f"{key}: {int(differ.sum())} entries differ, "
                                f"by up to {step} steps, up to {tie:.3g} of "
                                "a step off the midpoint")
            mine = torch.where(differ, ref, mine)
        return mine

    def _record(self, kind, orig):
        def run(a, q, w_scale, quantized=False):
            out, payload, scale = orig(a, q, w_scale, quantized=True)
            self.seen[self._key(q, kind)] = payload.cpu()
            return (out, payload, scale) if quantized else out
        return run

    def _forced_fwd(self, x, q, w_scale, quantized=False):
        """K5's plain version with its payload held to the reference."""
        from yat_tpu_torch.ops import quant as Q
        x32 = x.float()
        x8, xs = Q.row_quantize(x32)
        x8 = self._take(self._key(q, "fwd"), x8, x32 / xs[:, None])
        y = ((Q.int8_product(x8, q.t()) * xs[:, None])
             * w_scale[None, :].float()).to(x.dtype)
        return (y, x8, xs) if quantized else y

    def _forced_bwd(self, g, q, w_scale, quantized=False):
        """K5b's plain version with its payload held to the reference."""
        from yat_tpu_torch.ops import quant as Q
        g32 = g.float() * w_scale[None, :].float()
        g8, gs = Q.row_quantize(g32)
        g8 = self._take(self._key(q, "bwd"), g8, g32 / gs[:, None])
        dx = (Q.int8_product(g8, q) * gs[:, None]).to(g.dtype)
        return (dx, g8, gs) if quantized else dx

    def recording(self):
        """A ``with`` context in which K5/K5b and their plain versions keep
        their payloads."""
        from unittest import mock

        from yat_tpu_torch.ops import quant as Q
        self._calls, self.reference = {}, None
        return mock.patch.multiple(
            Q, _w8a8_cuda=self._record("fwd", Q._w8a8_cuda),
            _w8a8_bwd_cuda=self._record("bwd", Q._w8a8_bwd_cuda),
            w8a8_matmul_ref=self._record("fwd", Q.w8a8_matmul_ref),
            w8a8_matmul_bwd_ref=self._record("bwd", Q.w8a8_matmul_bwd_ref))

    def forcing(self, reference):
        """A ``with`` context in which the plain versions are held to the
        ``reference`` payloads."""
        from unittest import mock

        from yat_tpu_torch.ops import quant as Q
        self._calls, self.reference = {}, reference
        return mock.patch.multiple(Q, w8a8_matmul_ref=self._forced_fwd,
                                   w8a8_matmul_bwd_ref=self._forced_bwd)


def phase_int8_grad_reference(device, width=None):
    """Two SANA-0.6B blocks (one linear, one softmax self-attention) with
    an int8 base quantized from the fp32 weights, w8a8 on and rank-8 LoRA
    (nonzero ``lora_b``), at 512 image and 1024 caption tokens so that
    every projection, the caption projection included, takes K5: one
    flow-matching loss and every LoRA gradient on ``device`` (K5/K5b)
    against the CPU (the plain versions), fp32.  The card runs first and
    keeps its int8 payloads; the CPU run counts the entries it rounds to
    the other side (``W8A8Payloads``) and takes the card's step there.
    ReLU kinks are counted and their share added as in
    ``phase_grad_reference``; then every entry of every leaf must agree to
    ``GRAD_REF_TOL``.  ``width`` overrides the config's widths for a
    rehearsal on the CPU."""
    import copy
    import dataclasses

    import torch

    from yat_tpu_torch.adapters.builder import adapter_parameters
    from yat_tpu_torch.kernels.build import launch_counts, reset_launch_counts
    from yat_tpu_torch.models.layers import AdapterDense
    from yat_tpu_torch.models.sana import SANA_600M, SanaTransformer2D
    from yat_tpu_torch.ops.quant import quantize_params
    from yat_tpu_torch.ops.schedulers import FlowMatchSchedule
    from yat_tpu_torch.train.step import loss_and_grads
    from yat_tpu_torch.train.tasks import make_flow_matching_loss

    cfg = dataclasses.replace(SANA_600M, num_layers=2,
                              softmax_self_attn_blocks=(1,), **(width or {}))
    cpu, _, n = lora_pair(SanaTransformer2D, cfg, 8, torch.device("cpu"))
    n_q = quantize_params(cpu, 8)
    for m in cpu.modules():
        if isinstance(m, AdapterDense):
            m.w8a8 = True
    gpu = copy.deepcopy(cpu).to(device)
    rng = np.random.default_rng(0)
    grid, cap = 16, 512
    lat = rng.standard_normal((2, grid, grid, cfg.in_channels), np.float32)
    emb = rng.standard_normal((2, cap, cfg.caption_channels), np.float32)
    mask = (np.arange(cap)[None] < np.array([[100], [500]])).astype(np.int32)
    sched = FlowMatchSchedule(shift=3.0)
    ts, sig = sched.training_draw(torch.Generator().manual_seed(3), 2)
    noise = rng.standard_normal(lat.shape, np.float32)
    tap = W8A8Payloads([cpu, gpu])
    results = {}
    # the card first: the CPU run is held to its payloads
    for label, model, dev in (("card", gpu, device),
                              ("cpu", cpu, torch.device("cpu"))):
        batch = {"latents": torch.from_numpy(lat).to(dev),
                 "embeddings": torch.from_numpy(emb).to(dev),
                 "text_mask": torch.from_numpy(mask).to(dev)}
        draws = {"timesteps": ts.to(dev), "sigmas": sig.to(dev),
                 "noise": torch.from_numpy(noise).to(dev)}
        leaves = [p for _, p in adapter_parameters(model)]
        seen = {}
        hooks = _relu_input_hooks(model.blocks[0].attn1, seen)
        reset_launch_counts()
        with (tap.recording() if label == "card"
              else tap.forcing(dict(tap.seen))):
            loss, grads = loss_and_grads(
                make_flow_matching_loss(model, sched), leaves, batch,
                torch.Generator(), draws)
        for h in hooks:
            h.remove()
        results[label] = (float(loss), [g.detach().cpu() for g in grads],
                          {k: {n_: t.cpu() for n_, t in v.items()}
                           for k, v in seen.items()}, launch_counts())
    loss_g, grads_g, seen_g, counts = results["card"]
    loss_c, grads_c, seen_c, _ = results["cpu"]
    names = [name for name, _ in adapter_parameters(cpu)]
    loss_err = abs(loss_g - loss_c) / abs(loss_c)
    expected, kinks = with_flips_share(cpu.blocks[0].attn1, "blocks_0.attn1",
                                       dict(zip(names, grads_c)), seen_c,
                                       seen_g)
    zero, rows, ok = [], [], loss_err <= 1e-4 and not tap.bad
    for name, gc, gg in zip(names, grads_c, grads_g):
        scale = float(gc.abs().max())
        fixed = float((gg.double() - expected[name]).abs().max()) / scale
        rows.append((fixed, name, scale))
        ok = ok and fixed <= GRAD_REF_TOL and bool(torch.isfinite(gg).all())
        if not bool((gg != 0).any()):
            zero.append(name)
    for fixed, name, scale in sorted(rows, reverse=True)[:3]:
        log(f"int8 grad reference:   {name}: max|g| {scale:.3e}; "
            f"max|dg|/max|g| {fixed:.2e}")
    # K5 per block: attn1 q/k/v/out, attn2 q/out and k/v on the caption,
    # GLUMB's up-projection (its down-projection's K = 2880 is off the
    # gate); plus the caption projection's two layers.  K5b: the same but
    # attn2's k/v (nothing trainable upstream of the caption) and block 0's
    # attn1 q/k/v (their input comes from frozen modules only)
    want = {"w8a8_matmul": 9 * cfg.num_layers + 2,
            "w8a8_matmul_bwd": 7 * cfg.num_layers - 3}
    if device.type != "cuda":
        want = {k: 0 for k in want}
    log(f"int8 grad reference: 2-block {cfg.hidden_dim}-wide SANA, int8 base "
        f"({n_q} dense layers), w8a8, LoRA on {n} modules ({len(names)} "
        f"leaves), {device.type} vs CPU, fp32: loss {loss_g:.6f} vs "
        f"{loss_c:.6f} (rel {loss_err:.2e}, tol 1e-4); {len(tap.seen)} "
        f"payloads, int8 roundings flipped between the devices: "
        f"{tap.flips} (each one step, at most {tap.worst_tie:.2e} of a step "
        f"off the midpoint; tie limit {FLIP_TIE:g}); ReLU kinks flipped: "
        f"{kinks.get('to_q', 0)} of q, {kinks.get('to_k', 0)} of k; worst "
        f"leaf max|dg|/max|g| {max(r[0] for r in rows):.2e} with the kinks' "
        f"share (tol {GRAD_REF_TOL:g}); zero gradients: {len(zero)}; "
        f"launches { {k: counts[k] for k in want} }")
    if tap.bad:
        fail(f"int8 payloads that differ by more than a flip: {tap.bad[:4]}")
    if zero:
        fail(f"int8: LoRA leaves with no gradient: {zero[:4]}")
    if not ok:
        fail("int8: LoRA gradients on the card disagree with the CPU")
    if any(counts[k] != v for k, v in want.items()):
        fail(f"int8 grad reference: launches {counts}, expected {want}")
    return tap.flips


def phase_pixart_grad_reference(device, width=None):
    """Two PixArt-Sigma XL-2 512px blocks with LoRA (nonzero ``lora_b``) at
    1024 image tokens over a 300-token caption, one epsilon loss with the
    learned-sigma half sliced off, every LoRA gradient on ``device`` against
    the CPU, fp32.  On the card the self-attention runs K6/K6b, the
    cross-attention K4/K4b and the norms K1/K1b.  ``width`` overrides the
    config's widths for a rehearsal on the CPU."""
    import dataclasses

    import torch

    from yat_tpu_torch.adapters.builder import adapter_parameters
    from yat_tpu_torch.kernels.build import launch_counts, reset_launch_counts
    from yat_tpu_torch.models.pixart import PIXART_SIGMA_XL2, \
        PixArtTransformer2D
    from yat_tpu_torch.ops.schedulers import DDPMSchedule
    from yat_tpu_torch.train.step import loss_and_grads
    from yat_tpu_torch.train.tasks import make_epsilon_loss

    cfg = dataclasses.replace(PIXART_SIGMA_XL2, num_layers=2, **(width or {}))
    cpu, gpu, n = lora_pair(PixArtTransformer2D, cfg, 32, device)
    rng = np.random.default_rng(0)
    grid = cfg.sample_size
    lat = rng.standard_normal((2, grid, grid, cfg.in_channels), np.float32)
    emb = rng.standard_normal((2, cfg.max_caption_len, cfg.caption_channels),
                              np.float32)
    mask = (np.arange(cfg.max_caption_len)[None]
            < np.array([[1], [217]])).astype(np.int32)
    sched = DDPMSchedule()
    ts = sched.training_draw(torch.Generator().manual_seed(3), 2)
    noise = rng.standard_normal(lat.shape, np.float32)
    learned_sigma = cfg.out_channels == 2 * cfg.in_channels
    results = []
    for model, dev in ((cpu, torch.device("cpu")), (gpu, device)):
        batch = {"latents": torch.from_numpy(lat).to(dev),
                 "embeddings": torch.from_numpy(emb).to(dev),
                 "text_mask": torch.from_numpy(mask).to(dev)}
        draws = {"timesteps": ts.to(dev),
                 "noise": torch.from_numpy(noise).to(dev)}
        leaves = [p for _, p in adapter_parameters(model)]
        reset_launch_counts()
        loss, grads = loss_and_grads(
            make_epsilon_loss(model, sched, learned_sigma=learned_sigma),
            leaves, batch, torch.Generator(), draws)
        results.append((float(loss), [g.detach().cpu() for g in grads],
                        launch_counts()))
    (loss_c, grads_c, _), (loss_g, grads_g, counts) = results
    names = [name for name, _ in adapter_parameters(cpu)]
    loss_err = abs(loss_g - loss_c) / abs(loss_c)
    zero, rows, ok = [], [], loss_err <= 1e-4
    for name, gc, gg in zip(names, grads_c, grads_g):
        scale = float(gc.abs().max())
        rel = float((gg - gc).abs().max()) / scale
        rows.append((rel, name, scale))
        ok = ok and rel <= GRAD_REF_TOL and bool(torch.isfinite(gg).all())
        if not bool((gg != 0).any()):
            zero.append(name)
    for rel, name, scale in sorted(rows, reverse=True)[:3]:
        log(f"pixart grad reference:   {name}: max|g| {scale:.3e}; "
            f"max|dg|/max|g| {rel:.2e}")
    # two blocks: per block one self- and one cross-attention forward and
    # backward, two norms forward and backward, plus the output norm
    # forward; block 0's first norm needs no backward
    want = {"flash_attention": 2, "flash_attention_bwd": 2,
            "dot_product_attention_folded": 2,
            "dot_product_attention_folded_bwd": 2, "adaln_layernorm": 5,
            "adaln_layernorm_bwd": 4, "attention_xla": 0}
    if device.type != "cuda":
        want = {k: 0 for k in want}
    log(f"pixart grad reference: 2-block {cfg.hidden_dim}-wide PixArt-Sigma "
        f"with LoRA on {n} modules ({len(names)} leaves), {device.type} vs "
        f"CPU, fp32: loss {loss_g:.6f} vs {loss_c:.6f} (rel {loss_err:.2e}, "
        f"tol 1e-4); worst leaf max|dg|/max|g| {max(r[0] for r in rows):.2e} "
        f"(tol {GRAD_REF_TOL:g}); zero gradients: {len(zero)}; launches "
        f"{ {k: counts[k] for k in want} }")
    if zero:
        fail(f"pixart: LoRA leaves with no gradient: {zero[:4]}")
    if not ok:
        fail("pixart: LoRA gradients on the card disagree with the CPU")
    if any(counts[k] != v for k, v in want.items()):
        fail(f"pixart grad reference: launches {counts}, expected {want}")


# ---------------------------------------------------------------------------
# 6. serve
# ---------------------------------------------------------------------------

def png_shape(body: bytes, ctype: str):
    """(H, W, C) of a PNG from its IHDR chunk, or of a raw .npy body."""
    if ctype == "application/x-npy":
        import io
        return np.load(io.BytesIO(body)).shape
    if body[:8] != b"\x89PNG\r\n\x1a\n" or body[12:16] != b"IHDR":
        raise ValueError("not a PNG")
    w, h, depth, color = struct.unpack(">IIBB", body[16:26])
    channels = {0: 1, 2: 3, 4: 2, 6: 4}[color]
    if depth != 8:
        raise ValueError(f"PNG bit depth {depth}")
    return (h, w, channels)


def _post(port, prompt, out, i):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate",
        data=json.dumps({"prompt": prompt}).encode(), method="POST")
    with urllib.request.urlopen(req, timeout=900) as resp:
        out[i] = (resp.status, resp.headers["Content-Type"], resp.read())


def serve_params(**extra):
    """The serving configuration: the family's 512px defaults (SANA-0.6B or
    PixArt-Sigma XL-2), bf16, random weights from dataset_seed 0."""
    from yat_tpu_torch.config import TrainingParameters
    return TrainingParameters.from_dict({
        "batch_size": "1", "learning_rate": "1e-4", "steps": "1",
        "num_steps_per_validation": "1", "bfloat16": "true",
        "dataset_seed": "0", **extra})


def per_step_launches(family, vp):
    """Kernel launches per denoise step of the family's serving path (and
    counts that must stay 0)."""
    cfg = vp.model.cfg
    if family == "pixeldit":
        # one CFG call at batch 2B over the 300-token caption: each patch
        # block's attentions on the branch the gate gives them, each pixel
        # block's self-attention on K6 directly, K1 for every block norm
        # (models.pixeldit.kernel_calls); no K3
        side = vp.latent_shape[0] // cfg.patch_size
        return {**pixeldit_launches(cfg, (side, side), cfg.max_caption_len,
                                    (1, 0)), "linear_attention": 0}
    if family == "flux":
        # one CFG call of the transformer at batch 2B over 512 caption
        # tokens: K6 for every block's attention, K1 for every norm
        # (models.flux.kernel_calls); nothing else of the port's
        from yat_tpu_torch.frontends.flux import FLUX_CAPTION_LEN
        return {**flux_launches(cfg, vp.grid_hw, FLUX_CAPTION_LEN, (1, 0)),
                "dot_product_attention": 0,
                "dot_product_attention_folded": 0, "linear_attention": 0}
    if family == "sd35":
        # one CFG call of the MMDiT at batch 2B: K6 for every joint and
        # MMDiT-X attention, K1 for the second norms and the final one
        # (models.mmdit.kernel_calls); nothing else of the port's
        return {**sd35_launches(cfg, vp.latent_shape[:2], (1, 0)),
                "dot_product_attention": 0,
                "dot_product_attention_folded": 0, "linear_attention": 0}
    if family in ("sd15", "sdxl"):
        # one CFG call of the UNet at batch 2B: each attention takes the
        # branch its shape gives (unet_launches); no adaLN, no K3
        return {**unet_launches(cfg, vp.latent_shape[:2]),
                "adaln_layernorm": 0, "linear_attention": 0}
    n = cfg.num_layers
    if family == "sana":
        # one CFG call: K1 twice a block and once at the output, K2 for the
        # cross-attention and the softmax self-attention blocks, K3 for
        # the others
        n_soft = len(cfg.softmax_self_attn_blocks)
        return {"adaln_layernorm": 2 * n + 1,
                "dot_product_attention": n + n_soft,
                "linear_attention": n - n_soft}
    # PixArt-Sigma: one CFG call at batch 2B and one PAG call at batch B;
    # K6 for every self-attention but the perturbed blocks' of the PAG
    # call, K2's kernel as K4 for every cross-attention; no native K2, no
    # XLA branch
    n_pag = len(vp.model.pag_layers(True))
    return {"adaln_layernorm": 2 * (2 * n + 1),
            "flash_attention": 2 * n - n_pag,
            "dot_product_attention_folded": 2 * n,
            "dot_product_attention": 0, "attention_xla": 0}


def phase_serve(params, device, card, family="sana", px=512, profile=False,
                window_ms=100.0, on_built=None, after=None):
    """The serving main path through HTTP.  The batch window only has to
    cover the arrival of 4 concurrent requests: ``window_ms`` widens it for
    a rehearsal on a loaded CPU, where the arrivals spread further.
    ``on_built(vp)`` runs once the pipeline is built, ``after(vp)`` once
    the main path's counts are read (before the server stops)."""
    import torch

    from yat_tpu_torch.kernels.build import launch_counts, reset_launch_counts
    from yat_tpu_torch.serve import build_sampler, make_server

    cuda = device.type == "cuda"
    t0 = time.perf_counter()
    sampler = build_sampler(params, family, max_batch=4,
                            batch_window_ms=window_ms, device=device)
    vp = sampler.pipeline
    cfg = vp.model.cfg
    if cuda:
        torch.cuda.synchronize()
    blocks = getattr(cfg, "num_layers", None) or (
        getattr(cfg, "num_double_blocks", 0)
        + getattr(cfg, "num_single_blocks", 0))
    shape = (f"{cfg.hidden_dim}-wide, {blocks} blocks"
             if hasattr(cfg, "hidden_dim") else
             f"UNet {cfg.block_out_channels}, {unet_blocks(cfg)} "
             "transformer blocks")
    log(f"serve {family}: built the denoiser ({shape}), caption encoder "
        "and decoder "
        f"{'from ' + params.pretrained_pipe_path if params.pretrained_pipe_path else 'with random weights'}"
        f" in {time.perf_counter() - t0:.1f} s")
    if on_built is not None:
        on_built(vp)
    server = make_server(sampler, host="127.0.0.1", port=0)
    port = server.server_address[1]
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    try:
        t0 = time.perf_counter()
        sampler.warmup()
        log(f"serve {family}: warm-up (batch 4 + batch 1) "
            f"{time.perf_counter() - t0:.2f} s")

        seen = []

        def recording(prompts):
            out = vp(prompts)
            seen.append(out)
            return out
        sampler.pipeline = recording

        batches0 = sampler.stats["batches"]
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        # main path: 4 concurrent requests, then 1 more
        results = [None] * 5
        t0 = time.perf_counter()
        threads = [threading.Thread(target=_post,
                                    args=(port, PROMPTS[i], results, i))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        t4 = time.perf_counter() - t0
        t0 = time.perf_counter()
        _post(port, PROMPTS[0], results, 4)
        t1 = time.perf_counter() - t0
        counts = launch_counts()
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        batches = sampler.stats["batches"] - batches0
        if profile:
            profile_batch(vp, card, PROFILE_STEPS.get(family))
        if after is not None:
            after(vp)
    finally:
        server.shutdown()
        server.server_close()
        sampler.stop()

    for i, r in enumerate(results):
        if r is None or r[0] != 200:
            fail(f"request {i} failed: {r and r[0]}")
        shape = png_shape(r[2], r[1])
        if shape != (px, px, 3):
            fail(f"request {i}: image {shape}, expected {(px, px, 3)}")
    floats = [img for out in seen for img in out.values()]
    if len(floats) != 5:
        fail(f"expected 5 sampled images, got {len(floats)}")
    for img in floats:
        if img.shape != (px, px, 3) or not np.isfinite(img).all():
            fail(f"image {img.shape} not finite / not {px}x{px}x3")
    first = {k.split("/", 2)[2]: v for k, v in seen[0].items()}
    again = next(iter(seen[-1].values()))
    diff = float(np.abs(first[PROMPTS[0]] - again).max())
    # the same prompt and seed, sampled in a batch of 4 and alone: the
    # kernels are batch-invariant, the library GEMMs may round differently
    # at another batch size.  PixArt-Sigma carries those bf16 roundings
    # through 24 T5-XXL layers and a guidance of 1 + 5.0 + 2.0 on every
    # step, SANA through 26 Gemma layers and CFG 5.0 alone
    tol = REPEAT_TOL[family]
    log(f"serve {family}: repeated prompt max |diff| {diff:.3e} (tol {tol:g})")
    if diff > tol:
        fail("the repeated prompt did not reproduce its image")
    if batches != 2:
        fail(f"expected 2 batches (4 coalesced + 1), got {batches}")

    per_step = per_step_launches(family, vp)
    steps = batches * vp.num_steps
    for name, n in per_step.items():
        want = n * steps if cuda else 0
        log(f"serve {family}: {name} launches {counts[name]} (expected {n} "
            f"per denoise step x {steps} steps = {want})")
        if counts[name] != want:
            fail(f"{name}: {counts[name]} launches, expected {want}")
    log(f"serve {family} [{card}]: batch of 4 in {t4:.3f} s "
        f"({4 / t4:.3f} images/s), batch of 1 in {t1:.3f} s; peak device "
        f"memory {peak / 2**30:.2f} GiB; {vp.num_steps} steps, CFG "
        f"{vp.guidance_scale}, PAG {getattr(vp, 'pag_scale', 0.0)}")
    return {name: counts[name] for name in per_step}


# kernel-name fragments → the layer they belong to
KERNEL_FAMILIES = (
    ("K1 adaln_layernorm", ("adaln_fwd",)),
    ("K1b adaln_layernorm_bwd", ("adaln_bwd",)),
    # before K2: K6's kernel name contains K2's
    ("K6 flash_attention", ("flash_attention_fwd",)),
    ("K2/K4 dot_product_attention", ("attention_fwd_bf16",
                                     "attention_fwd_f32")),
    ("K6b flash_attention_bwd", ("flash_bwd_",)),
    ("K2b/K4b dot_product_attention_bwd", ("attention_bwd_dq",
                                           "attention_bwd_dkdv")),
    ("K3 linear_attention", ("linear_attention_fwd",)),
    # before cuBLAS: K5's and K5b's GEMMs carry "gemm" too
    ("K5 w8a8_matmul", ("w8a8_fwd_",)),
    ("K5b w8a8_matmul_bwd", ("w8a8_bwd_",)),
    # convolutions first: cuDNN's implicit-GEMM kernels carry "gemm" too
    ("convolution (cuDNN)", ("conv", "cudnn", "depthwise", "implicit",
                             "fprop")),
    ("matmul (cuBLAS)", ("gemm", "gemv", "nvjet", "xmma", "cutlass")),
)


# the port's kernel families (KERNEL_FAMILIES) → (the counters of their
# wrappers, device records per counted call), for the trace's completeness
FAMILY_COUNTERS = {
    "K1 adaln_layernorm": (("adaln_layernorm",), 1),
    "K1b adaln_layernorm_bwd": (("adaln_layernorm_bwd",), 1),
    "K6 flash_attention": (("flash_attention",), 1),
    "K2/K4 dot_product_attention": (("dot_product_attention",
                                     "dot_product_attention_folded"), 1),
    "K6b flash_attention_bwd": (("flash_attention_bwd",), 2),
    "K2b/K4b dot_product_attention_bwd": (
        ("dot_product_attention_bwd", "dot_product_attention_folded_bwd"), 2),
    "K3 linear_attention": (("linear_attention",), 1),
    "K5 w8a8_matmul": (("w8a8_matmul",), 2),
    "K5b w8a8_matmul_bwd": (("w8a8_matmul_bwd",), 2),
}


def trace_shortfall(families, calls):
    """{family: (records expected from the counters, records traced)} for
    every port kernel family whose trace holds another number of records
    than its launch counters say ran."""
    out = {}
    for fam, (names, per_call) in FAMILY_COUNTERS.items():
        want = per_call * sum(calls.get(n, 0) for n in names)
        got = families.get(fam, (0, 0.0))[0]
        if got != want:
            out[fam] = (want, got)
    return out


# denoise steps of the profiled serving batch of the 1024 px families
# and of PixelDiT (16384 pixel tokens), whose batches of 4 take seconds at
# 20 steps: 5 of the 20 (the encoders'
# and the decoder's share of the trace then weighs 4x more); the others
# are profiled at the pipeline's own ladder
PROFILE_STEPS = {"sdxl": 5, "sd35": 5, "flux": 5, "pixeldit": 5}


def profile_batch(vp, card, steps=None):
    """One batch of 4 prompts under torch.profiler, at ``steps`` denoise
    steps when given (the pipeline's own otherwise)."""
    full = vp.num_steps
    vp.num_steps = steps or full
    try:
        profile_run(f"batch of 4 ({vp.num_steps} of {full} steps)",
                    lambda: vp(PROMPTS), card)
    finally:
        vp.num_steps = full


def busy_union(spans):
    """The length of the union of ``(start, end)`` intervals."""
    busy, end = 0.0, -1.0
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def profile_run(label, fn, card):
    """``fn()`` under torch.profiler: device time by layer and by kernel,
    and the share of the wall time the device sat idle.  Only the device
    is traced: the host's operator records would slow the host under the
    profiler (inflating the idle share) and take seconds to collect."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from yat_tpu_torch.kernels.build import launch_counts

    torch.cuda.synchronize()
    before = launch_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    calls = {k: n - before.get(k, 0) for k, n in launch_counts().items()
             if n != before.get(k, 0)}
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dur = e.time_range.end - e.time_range.start
        spans.append((e.time_range.start, e.time_range.end))
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + dur)
    log(f"profile: {sum(n for n, _ in by_name.values())} device records; "
        f"the port's counters rose by {sorted(calls.items())}")
    busy = busy_union(spans)
    log(f"profile [{card}]: {label} in {wall_us / 1e3:.1f} ms (profiler "
        f"on), device busy {busy / 1e3:.1f} ms, idle share "
        f"{1 - busy / wall_us:.3f}")
    families = {}
    for name, (n, t) in by_name.items():
        fam = next((f for f, keys in KERNEL_FAMILIES
                    if any(k in name.lower() for k in keys)), "other")
        c, tt = families.get(fam, (0, 0.0))
        families[fam] = (c + n, tt + t)
    for fam, (n, t) in sorted(families.items(), key=lambda x: -x[1][1]):
        log(f"profile:   {fam:28s} {t / 1e3:9.2f} ms  {n:6d} launches  "
            f"{t / busy:.3f} of busy")
    # the trace's completeness: the profiler can lose device records (a
    # whole K5 call's two in one step of a long run) though the kernels
    # ran; the port's counters say how many records each family should hold
    short = trace_shortfall(families, calls)
    log("profile: trace check: every port kernel's records match its "
        "launch counter" if not short else
        f"profile: trace check: records against the counters (expected, "
        f"traced): {short}; the device time above is off by them")
    for name, (n, t) in sorted(by_name.items(), key=lambda x: -x[1][1])[:12]:
        log(f"profile:     {t / 1e3:9.2f} ms {n:6d}x  {name[:90]}")
    # every kernel of the port by name, so its records can be set against
    # its counter (K5/K5b: a quantize and a GEMM record per call)
    for name, (n, t) in sorted(by_name.items()):
        fam = next((f for f, keys in KERNEL_FAMILIES
                    if any(k in name.lower() for k in keys)), "")
        if fam.startswith("K"):
            log(f"profile:     {fam.split()[0]:6s} {n:6d}x {t / 1e3:9.2f} ms"
                f"  {name[:90]}")
    PROFILES[label] = (wall_us / 1e3, busy / 1e3)
    return PROFILES[label]



# ---------------------------------------------------------------------------
# 6b. pretrained serving from files, the samplers, gating, low_vram
# ---------------------------------------------------------------------------

SYNTH_SEED = 7


def synth_module():
    from tools import synth_checkpoint
    return synth_checkpoint


@contextlib.contextmanager
def hash_tokenizer():
    """The hash tokenizer in place of the pipe directory's: the card's
    machine has no ``transformers`` and the repository no tokenizer
    files, so the synthesized pipe directory holds none."""
    from yat_tpu_torch.utils import tokenizer as T
    real = T.load_tokenizer

    def load(path, subfolder="tokenizer", vocab_size=256, max_length=77,
             require=False):
        return T.HashTokenizer(vocab_size=vocab_size, max_length=max_length)
    T.load_tokenizer = load
    try:
        yield
    finally:
        T.load_tokenizer = real


def host_rss_bytes():
    """The process's resident set now, from /proc/self/statm (None where
    the kernel does not provide it)."""
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        return None


class HostPeak:
    """The largest resident set seen between :meth:`start` and
    :meth:`stop`, sampled every 20 ms on a thread (/proc/self/status has
    no VmHWM in some sandboxes); ``gib`` is None where the resident set
    cannot be read."""

    def start(self):
        self.peak = host_rss_bytes()
        self._stop = threading.Event()

        def poll():
            while not self._stop.wait(0.02):
                now = host_rss_bytes()
                if now is not None:
                    self.peak = max(self.peak or 0, now)
        self._thread = threading.Thread(target=poll, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        self._thread.join()

    @property
    def gib(self):
        return None if self.peak is None else self.peak / 2**30


def pipe_entries(family, params):
    """``[(subdirectory, module on the meta device, rules, file name,
    config.json)]`` of the family's synthesized pipe directory: the
    denoiser, and for SANA Gemma-2 and the DC-AE decoder, for
    PixArt-Sigma the KL-VAE decoder (T5-XXL stays random: its encoder
    file is about 9.5 GB in bf16)."""
    import torch

    from yat_tpu_torch.models import text_encoders as TE
    from yat_tpu_torch.models import vae as V

    S = synth_module()
    tiny = bool(params.model_config_overrides.get("tiny_encoders"))
    main = "diffusion_pytorch_model.safetensors"
    with torch.device("meta"):
        if family == "sana":
            from yat_tpu_torch.frontends.sana import build_sana_config
            from yat_tpu_torch.models.sana import SanaTransformer2D
            cfg = build_sana_config(params)
            vae_cfg = V.DCAE_TINY_TEST if tiny else V.DCAE_SANA
            return [
                ("transformer", SanaTransformer2D(cfg), S.SANA_RULES, main,
                 S.sana_config_json(cfg)),
                ("text_encoder", TE.Gemma2Encoder(
                    TE.GEMMA_TINY_TEST if tiny else TE.GEMMA2_2B),
                 S.GEMMA2_RULES, "model.safetensors", None),
                ("vae", V.DCAE(vae_cfg), S.dcae_rules(vae_cfg), main, None)]
        from yat_tpu_torch.frontends.pixart import build_pixart_config
        from yat_tpu_torch.models.pixart import PixArtTransformer2D
        cfg = build_pixart_config(params)
        return [
            ("transformer", PixArtTransformer2D(cfg),
             S.pixart_rules(cfg.patch_size), main, None),
            ("vae", V.AutoencoderKL(V.KLVAE_TINY_TEST if tiny
                                    else V.KLVAE_SDXL),
             S.VAE_KL_RULES, main, None)]


def write_pipe(pipe, family, params):
    """Synthesize the family's pipe directory (BF16 files, seeded);
    returns ``{subdirectory: rules}``."""
    from yat_tpu_torch.convert import flax_params

    S = synth_module()
    rules = {}
    for sub, module, sub_rules, name, config in pipe_entries(family, params):
        t0 = time.perf_counter()
        # a VAE's both halves, as the published files hold them
        shapes = {k: tuple(v.shape) for k, v in flax_params(module).items()}
        info = S.write_checkpoint(os.path.join(pipe, sub), shapes, sub_rules,
                                  SYNTH_SEED, "BF16", name=name,
                                  config=config)
        log(f"pretrained {family}: synthesized {sub}/{name}: "
            f"{info['tensors']} tensors, {info['bytes'] / 2**30:.2f} GiB "
            f"BF16 ({len(info['dropped'])} biases left out, as the "
            f"published layout does) in {time.perf_counter() - t0:.1f} s")
        rules[sub] = sub_rules
    return rules


def check_loaded(label, module, rules, grid="BF16"):
    """Every parameter of ``module`` equals its synthesized value (on the
    file's ``grid``) after the same casts (a left-out bias: exactly
    zero)."""
    import torch

    from yat_tpu_torch.convert import flax_params

    S = synth_module()
    params = flax_params(module)

    def differs(item):
        path, t = item
        _, kind = S.match(path, rules)
        v = S.leaf_value(SYNTH_SEED, path, tuple(t.shape), kind, grid)
        want = torch.from_numpy(v).to(device=t.device, dtype=t.dtype)
        return not torch.equal(t, want)

    # the leaves' values are drawn on the host: numpy and the copies
    # release the GIL, so the leaves run in threads
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        flags = list(pool.map(differs, params.items()))
    bad = [path for path, bad in zip(params, flags) if bad]
    n = sum(t.numel() for t in params.values())
    if bad:
        fail(f"{label}: {len(bad)} parameters differ from the checkpoint, "
             f"e.g. {bad[:4]}")
    log(f"{label}: all {n:,} parameters ({len(params)} "
        "tensors) equal the synthesized values after the same casts")


def prepared(vp, prompts):
    """The conditioning a pipeline call builds for ``prompts``."""
    from yat_tpu_torch.train.validation import tile_batch
    enhanced = [vp.prompt_transform(p) if vp.prompt_transform else p
                for p in prompts]
    return (tile_batch(vp.encode_prompts(enhanced), len(prompts)),
            tile_batch(vp.encode_prompts([""]), len(prompts)))


def denoiser_device_ms(vp, cond, uncond):
    """The device's busy time (union of kernel records) of one
    ``sample_latents`` under torch.profiler, and the wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with torch.inference_mode(), profile(
            activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        vp.sample_latents(cond, uncond)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = [(e.time_range.start, e.time_range.end) for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    return busy_union(spans) / 1e3, wall * 1e3


def sampler_runs(family, vp, card, px):
    """A batch of 4 with each sampler of the family: the default ladder,
    DPM-Solver++(2M) and, for SANA, the velocity cache at interval 2;
    latency, launches (one count per evaluated step) and the denoiser's
    device time.  Returns the default batch's peak device memory."""
    import torch

    from yat_tpu_torch.kernels.build import launch_counts, reset_launch_counts
    from yat_tpu_torch.ops.sampling import cache_eval_mask
    from yat_tpu_torch.train.validation import set_cache_interval, set_sampler

    cuda = vp.device.type == "cuda"
    runs = [("euler" if family == "sana" else "ddim", None, 1),
            ("dpm", "dpm", 1)]
    if family == "sana":
        runs.append(("cache-2", None, 2))
    per_step = per_step_launches(family, vp)
    peak = 0
    for label, sampler, interval in runs:
        vp.sampler, vp.cache_interval = "auto", 1
        if sampler:
            set_sampler(vp, sampler)
        set_cache_interval(vp, interval)
        calls = sum(cache_eval_mask(vp.num_steps, vp.cache_interval))
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        images = vp(PROMPTS)
        if cuda:
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = launch_counts()
        if label in ("euler", "ddim") and cuda:
            peak = torch.cuda.max_memory_allocated()
        for img in images.values():
            if img.shape != (px, px, 3) or not np.isfinite(img).all():
                fail(f"sampler {family} {label}: image {img.shape} not "
                     f"finite / not {px}x{px}x3")
        for name, n in per_step.items():
            want = n * calls if cuda else 0
            if counts[name] != want:
                fail(f"sampler {family} {label}: {name} {counts[name]} "
                     f"launches, expected {n} x {calls} denoiser steps")
        busy = "not measured (CPU)"
        if cuda:
            ms, wall = denoiser_device_ms(vp, *prepared(vp, PROMPTS))
            busy = f"{ms:.1f} ms busy of {wall:.1f} ms (profiler on)"
        log(f"sampler {family} {label} [{card}]: batch of 4 in {dt:.3f} s; "
            f"{calls} denoiser steps of {vp.num_steps} "
            f"({', '.join(f'{k} {counts[k]}' for k in per_step)}); "
            f"denoiser device time {busy}")
    vp.sampler, vp.cache_interval = "auto", 1
    return peak


def gating_invariants(vp):
    """Refiner gating on SANA with a random nonzero LoRA: active timesteps
    holding none of the ladder's steps give the latents of the pipeline
    without LoRA bit for bit, holding all of them those of the ungated
    LoRA pipeline.  All four runs skip the caption K/V cache (a gated run
    must), so each pair runs the same GEMM shapes."""
    import torch

    from yat_tpu_torch.adapters.builder import AdapterSpec, \
        build_adapter_params
    from yat_tpu_torch.models.layers import AdapterDense

    cond, uncond = prepared(vp, PROMPTS)
    ladder = vp.schedule.inference_sigmas(vp.num_steps)[:-1]
    steps = sorted({int(torch.round(s * vp.schedule.num_train_timesteps))
                    for s in ladder})
    # shadow the class attribute on the instance for the four runs
    vp.model.supports_context_cache = False

    def latents(active):
        vp.active_timesteps = active
        with torch.inference_mode():
            return vp.sample_latents(cond, uncond).float().cpu()

    try:
        plain = latents(None)
        gen = torch.Generator(device=vp.device).manual_seed(3)
        n = build_adapter_params(vp.model, AdapterSpec(
            "lora", rank=8, alpha=8.0, target_modules=LORA_TARGETS), gen)
        with torch.no_grad():
            for m in vp.model.modules():
                if isinstance(m, AdapterDense) and m.lora_b is not None:
                    m.lora_b.normal_(0.0, 0.05, generator=gen)
        lora = latents(None)
        off = latents((max(steps) + 1,))
        on = latents(tuple(steps))
    finally:
        vp.active_timesteps = None
        del vp.model.supports_context_cache
    moved = float((lora - plain).abs().max())
    log(f"gating: {n} LoRA modules move the latents by {moved:.3e}; "
        f"ladder steps {steps}")
    if not moved > 0:
        fail("gating: the random LoRA does not change the latents")
    if not torch.equal(off, plain):
        fail(f"gating: no active step differs from the pipeline without "
             f"LoRA by {float((off - plain).abs().max()):.3e}")
    if not torch.equal(on, lora):
        fail(f"gating: every step active differs from the ungated LoRA "
             f"pipeline by {float((on - lora).abs().max()):.3e}")
    log("gating: no step active == no LoRA, bit for bit; every step active "
        "== ungated LoRA, bit for bit")


# the prompts of the low_vram batch: two of PROMPTS (each moves the
# caption encoder's weights to the card and back, seconds a prompt)
LOW_VRAM_PROMPTS = PROMPTS[:2]


def low_vram_batch(family, params, device, card, peak_normal):
    """One ``low_vram`` batch of ``LOW_VRAM_PROMPTS`` from the same pipe
    directory: the caption encoder's and decoder's weights rest on the
    host, the prompts go one at a time, the decoder tiles; the device's
    memory at rest and its peak beside the normal batch's."""
    import torch

    from yat_tpu_torch.frontends.sana import make_pipeline

    cuda = device.type == "cuda"
    low = serve_params(**{**raw_of(params), "low_vram": ""})
    low.bfloat16 = params.bfloat16
    with hash_tokenizer():
        vp = make_pipeline(low, device)
    modules = {"caption encoder": vp.encode_prompts.encode_captions.module,
               "decoder": vp.decode_latents.module}
    batches = []
    sample = vp.sample_latents

    def recording(cond, uncond, x0=None):
        batches.append(int(cond["embeddings"].shape[0]))
        return sample(cond, uncond, x0)
    vp.sample_latents = recording
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    rest = torch.cuda.memory_allocated() if cuda else 0
    t0 = time.perf_counter()
    images = vp(LOW_VRAM_PROMPTS)
    if cuda:
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    for name, m in modules.items():
        where = {p.device.type for p in m.parameters()}
        if where != {"cpu"}:
            fail(f"low_vram: the {name}'s parameters sit on {where} after "
                 "the batch")
    if batches != [1] * len(LOW_VRAM_PROMPTS):
        fail(f"low_vram: sampling runs of batch {batches}, expected one "
             "prompt at a time")
    if len(images) != len(LOW_VRAM_PROMPTS) or not all(
            np.isfinite(i).all() for i in images.values()):
        fail("low_vram: images missing or not finite")
    log(f"low_vram {family} [{card}]: batch of {len(LOW_VRAM_PROMPTS)} (one "
        f"prompt at a time) in "
        f"{dt:.3f} s; device memory at rest {rest / 2**30:.2f} GiB, peak "
        f"{peak / 2**30:.2f} GiB (normal batch's peak "
        f"{peak_normal / 2**30:.2f} GiB); the caption encoder's and "
        "decoder's parameters sit on the host after the batch")


def raw_of(params):
    """The configuration keys of a serving ``params`` built by
    :func:`serve_params`."""
    return {"pretrained_pipe_path": params.pretrained_pipe_path,
            "model_config_overrides": dict(params.model_config_overrides),
            **({"aspect_ratio": str(params.aspect_ratios)}
               if params.aspect_ratios else {})}


def phase_pretrained(device, card, family="sana", extra=None, px=512,
                     window_ms=100.0, bfloat16=True):
    """Serving from a synthesized diffusers pipe directory (BF16 files in
    a temporary directory, deleted at the end) through ``make_pipeline``:
    every parameter checked against its synthesized value, the seconds
    each model took from file to the device and the host's peak RSS, the
    HTTP main path (launch counts as in the serve phase), then each
    sampler's batch, and for SANA the gating invariants and one
    ``low_vram`` batch.  ``extra``: configuration keys of a rehearsal
    (tiny overrides).  Returns the serve main path's launch counts."""
    import gc

    import torch

    cuda = device.type == "cuda"
    extra = dict(extra or {})
    pipe = tempfile.mkdtemp(prefix=f"pipe-{family}-")
    peak, rss = {}, None
    try:
        rules = write_pipe(pipe, family, serve_params(**extra))
        params = serve_params(pretrained_pipe_path=pipe, **extra)
        params.bfloat16 = bfloat16
        before = host_rss_bytes()
        rss_before = ("not readable" if before is None
                      else f"{before / 2**30:.2f} GiB")
        rss = HostPeak().start()

        def on_built(vp):
            rss.stop()
            peak_rss = ("not readable" if rss.gib is None
                        else f"{rss.gib:.2f} GiB")
            modules = {"transformer": vp.model,
                       "text_encoder": vp.encode_prompts.encode_captions.module,
                       "vae": vp.decode_latents.module}
            seconds = {k: getattr(m, "load_seconds", None)
                       for k, m in modules.items()}
            loaded = {k for k, v in seconds.items() if v is not None}
            if loaded != set(rules):
                fail(f"pretrained {family}: loaded {sorted(loaded)}, the "
                     f"pipe holds {sorted(rules)}")
            log(f"pretrained {family}: from file to {device.type} "
                + ", ".join(f"{k} {seconds[k]:.1f} s" for k in rules)
                + f"; peak host RSS while the pipeline was built {peak_rss}"
                f" (before it {rss_before})")
            t0 = time.perf_counter()
            check_loaded(f"pretrained {family} transformer", vp.model,
                         rules["transformer"])
            if "text_encoder" in rules:
                check_loaded(f"pretrained {family} text_encoder",
                             vp.encode_prompts.encode_captions.module,
                             rules["text_encoder"])
            check_loaded(f"pretrained {family} vae",
                         vp.decode_latents.module, rules["vae"])
            log(f"pretrained {family}: parameter checks took "
                f"{time.perf_counter() - t0:.1f} s")

        def after(vp):
            peak["normal"] = sampler_runs(family, vp, card, px)
            if family == "sana":
                gating_invariants(vp)

        with hash_tokenizer():
            counts = phase_serve(params, device, card, family=family, px=px,
                                 window_ms=window_ms, on_built=on_built,
                                 after=after)
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        if family == "sana":
            low_vram_batch(family, params, device, card, peak["normal"])
    finally:
        if rss is not None:
            rss.stop()
        shutil.rmtree(pipe, ignore_errors=True)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# 7. train
# ---------------------------------------------------------------------------

TRAIN_STEPS = 6


def write_train_shard(path, n=48, latent=(16, 16, 32), dim=2304,
                      lengths=(100, 500), seed=0, caption_lengths=None):
    """``n`` feature samples, by default SANA-0.6B 512px ones: ratio "1.0",
    latents [16, 16, 32] fp32, caption embeddings [L_i, 2304] fp32 with L_i
    spread over 100-500 tokens (or ``caption_lengths``, in file order)."""
    from yat_tpu_torch.data.tar import TarShardWriter
    rng = np.random.default_rng(seed)
    ls = (caption_lengths if caption_lengths is not None else
          rng.permutation(np.linspace(*lengths, n).round().astype(int)))
    with TarShardWriter(path) as w:
        for i, length in enumerate(ls):
            w.write({"__key__": f"{i:06d}", "ratio": "1.0",
                     "latent.npy": rng.standard_normal(latent,
                                                       dtype=np.float32),
                     "emb.npy": rng.standard_normal((int(length), dim),
                                                    dtype=np.float32)})


def train_config(shard, out_dir, **extra):
    """configs/sana_512_lora.yaml without what needs files (pretrained
    weights, validation prompts, the TPU mesh) and without caption
    dropout, for ``TRAIN_STEPS`` steps, with its ``checkpoint_dir`` beside
    the shard and the validation (and checkpoint) cadence cut from 500 to
    3 steps, so the run writes two checkpoints."""
    cfg = {"local_shard_paths": [shard], "batch_size": "16",
           "learning_rate": "1e-4", "steps": str(TRAIN_STEPS),
           "warmup_steps": "2", "num_steps_per_validation": "3",
           "checkpoint_dir": os.path.join(os.path.dirname(shard), "ckpt"),
           "validation_prompts": [], "bfloat16": "true", "use_ema": "true",
           "gradient_accumulation_steps": "1",
           "train_unconditional_prob": "0", "lora_rank": "8",
           "lora_alpha": "8", "lora_algo": "lora",
           "lora_target_modules": LORA_TARGETS,
           "caption_length_bucketing": "true", "output_dir": out_dir,
           "dataset_seed": "0", **extra}
    return cfg


def run_entry_point(label, main_fn, device, tmp, cfg, shard_args):
    """Write the feature shard and the config under ``tmp``, then run the
    entry point as a user does (:func:`drive_entry_point`)."""
    t0 = time.perf_counter()
    write_train_shard(cfg["local_shard_paths"][0], **shard_args)
    log(f"{label}: wrote a "
        f"{os.path.getsize(cfg['local_shard_paths'][0]) / 1e6:.1f} MB "
        f"feature shard in {time.perf_counter() - t0:.1f} s")
    return drive_entry_point(label, main_fn, device, tmp, cfg)


def drive_entry_point(label, main_fn, device, tmp, cfg):
    """Write ``cfg`` under ``tmp`` and run the entry point as a user does,
    the launch counts set to 0 just before.  Returns the trainer, the
    launch counts, the wall seconds and the peak device memory."""
    import torch
    import yaml

    from yat_tpu_torch.kernels.build import launch_counts, reset_launch_counts

    cuda = device.type == "cuda"
    cfg_path = os.path.join(tmp, f"{label.replace(' ', '_')}.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    # main path: the entry point, as a user runs it
    t0 = time.perf_counter()
    trainer = main_fn(["--config", cfg_path, "--device", device.type])
    if cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    return trainer, counts, wall, peak


# adapter leaves that start at zero (so any update moves them off it)
ZERO_INIT_LEAVES = ("lora_b", "hada_w2_b", "lokr_w2_b", "fft_spectrum")


@contextlib.contextmanager
def initial_state():
    """Every trainer initialised in the block keeps its trainable leaves
    as they were after ``initialize`` (``initial_leaves``) and the state of
    its REPA projector, where it has one (``initial_projector``)."""
    from yat_tpu_torch.train.engine import Trainer

    init = Trainer.initialize

    def keeping(self):
        init(self)
        self.initial_leaves = [p.detach().clone()
                               for p in self.trainable_leaves()]
        proj = getattr(self.model, "repa_projector", None)
        self.initial_projector = None if proj is None else {
            k: v.clone() for k, v in proj.state_dict().items()}
    Trainer.initialize = keeping
    try:
        yield
    finally:
        Trainer.initialize = init


def exported_array(name, p):
    """``(key, array)`` the adapter export holds for the trainable leaf
    ``name`` (``adapters.io._PEFT_NAMES``; a REPA head's kernel in the
    flax layout)."""
    from yat_tpu_torch.adapters.io import _PEFT_NAMES
    dotted, leaf = name.rsplit(".", 1)
    suffix, transpose = _PEFT_NAMES.get(leaf, (leaf, leaf == "kernel"))
    arr = p.detach().float().cpu().numpy()
    return (f"base_model.model.{dotted}.{suffix}",
            arr.T if transpose and arr.ndim == 2 else arr)


def check_trained_leaves(label, trainer, dead=()):
    """Every trainable leaf changed by the run (against ``initial_state``'s
    snapshot; without one, the zero-initialised leaves moved off zero),
    but those of the modules in ``dead``, which no gradient reaches.
    Returns the snapshot or None."""
    import torch
    names, leaves = trainer.trainable_names(), trainer.trainable_leaves()
    live = [not n.startswith(tuple(f"{m}." for m in dead)) for n in names]
    initial = getattr(trainer, "initial_leaves", None)
    if initial is not None:
        same = [n for n, p, p0, ok in zip(names, leaves, initial, live)
                if ok and torch.equal(p, p0)]
        what = "unchanged by the updates"
    else:
        same = [n for n, p, ok in zip(names, leaves, live)
                if ok and n.rsplit(".", 1)[-1] in ZERO_INIT_LEAVES
                and not bool((p != 0).any())]
        what = "still zero after the updates"
    if same:
        fail(f"{label}: leaves {what}: {same[:4]}")
    if initial is not None:
        log(f"{label}: all {sum(live)} trainable leaves a gradient reaches "
            "changed" + (f" ({len(live) - sum(live)} of {list(dead)} get "
                         "none)" if dead else ""))
    return initial


def check_trained(label, trainer, cfg, n_layers, n_adapted=None, dead=()):
    """Finite losses, the warmup, an adapter on to_q/to_k/to_v/to_out of
    attn1 and attn2 in every block (or on ``n_adapted`` modules) with
    every leaf changed by the updates (without ``initial_state``: the
    zero-initialised leaves moved off zero; ``dead``: modules no gradient
    reaches), and the PEFT export equal to the live leaves (a REPA
    head's too)."""
    from yat_tpu_torch.adapters.builder import adapted_modules
    from yat_tpu_torch.adapters.io import read_safetensors

    steps = int(cfg["steps"])
    hist = trainer.history
    for h in hist:
        log(f"{label}: step {h['step']} caption rung {h['caption_len']} "
            f"loss {h['loss']:.6f} grad_norm {h['grad_norm']:.4f} "
            f"lr {h['lr']:.3g}")
    if len(hist) != steps or not all(
            math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
            for h in hist):
        fail(f"{label}: expected {steps} finite losses, got {hist}")
    warmup = int(cfg.get("warmup_steps") or 0)
    if warmup and (hist[0]["lr"] != 0.0 or hist[1]["lr"] <= 0.0):
        fail(f"{label}: warmup should give lr 0 on the first update only")
    adapted = adapted_modules(trainer.model)
    want = 8 * n_layers if n_adapted is None else n_adapted
    if len(adapted) != want:
        fail(f"{label}: {len(adapted)} adapted modules, expected {want}")
    initial = check_trained_leaves(label, trainer, dead)
    names, leaves = trainer.trainable_names(), trainer.trainable_leaves()
    path = os.path.join(cfg["output_dir"], str(steps),
                        "adapter_model.safetensors")
    tensors, meta = read_safetensors(path)
    if len(tensors) != len(leaves) or "yat_meta" not in meta:
        fail(f"{label}: adapter file holds {len(tensors)} tensors, "
             f"expected {len(leaves)}")
    for name, p in zip(names, leaves):
        key, want = exported_array(name, p)
        if not np.array_equal(tensors[key], want):
            fail(f"{label}: exported {key} differs from the live leaf")
    log(f"{label}: {len(adapted)} adapted modules "
        f"({adapted[0][1].adapter_kind}), every leaf "
        f"{'changed' if initial is not None else 'trained'}; adapter export "
        f"{os.path.basename(path)} holds {len(tensors)} tensors")


def check_launches(label, counts, want, how):
    for name, n in want.items():
        log(f"{label}: {name} launches {counts[name]} (expected {how(name)}"
            f" = {n})")
        if counts[name] != n:
            fail(f"{label}: {name}: {counts[name]} launches, expected {n}")


def log_step_rate(label, trainer, wall, peak, card):
    """The run's step rate over its steps but the first (mean and median:
    a step after a validation cadence carries the export and the
    checkpoint's copy to the host) and its peak device memory."""
    import statistics
    steps = len(trainer.history)
    # a one-step rehearsal has only its first step
    first = 1 if steps > 1 else 0
    times = trainer._step_times[first:]
    step_s = sum(times) / len(times)
    log(f"{label} [{card}]: {steps} steps in {wall:.2f} s through the "
        f"entry point (shard read included); steps {first + 1}-{steps}: "
        f"{step_s:.4f} s a step (median {statistics.median(times):.4f}), "
        f"{1 / step_s:.3f} steps/s, "
        f"{trainer.params.batch_size / step_s:.2f} images/s; first "
        f"step {trainer._step_times[0]:.3f} s; peak device memory "
        f"{peak / 2**30:.2f} GiB")
    IMAGES_PER_S[label] = trainer.params.batch_size / step_s


def remat_step(label, trainer, device, card, batch, draws, in_blocks,
               bwd_names):
    """One step's loss and gradients on ``batch`` and ``draws`` with and
    without remat (``gradient_checkpointing``): the same bits, the forward
    launches inside the blocks (``in_blocks``, per step) twice, the
    backward launches (``bwd_names``) once; then one optimizer step under
    torch.profiler on the card."""
    import torch

    from yat_tpu_torch.adapters.builder import adapter_parameters
    from yat_tpu_torch.kernels.build import launch_counts, reset_launch_counts
    from yat_tpu_torch.train.step import loss_and_grads

    cuda = device.type == "cuda"
    model = trainer.model
    gen = torch.Generator(device=device).manual_seed(5)
    rung = batch["embeddings"].shape[1]
    leaves = [p for _, p in adapter_parameters(model)]
    runs = {}
    for remat in (False, True):
        model.gradient_checkpointing = remat
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        loss, grads = loss_and_grads(trainer.task_loss, leaves, batch, gen,
                                     draws)
        if cuda:
            torch.cuda.synchronize()
        runs[remat] = (loss, grads, launch_counts(),
                       time.perf_counter() - t0,
                       torch.cuda.max_memory_allocated() if cuda else 0)
    model.gradient_checkpointing = False
    (l0, g0, c0, t_0, m0), (l1, g1, c1, t_1, m1) = runs[False], runs[True]
    same = bool(torch.equal(l0, l1)) and all(
        bool(torch.equal(a, c)) for a, c in zip(g0, g1))
    worst = max(float((a.float() - c.float()).abs().max()) for a, c in
                zip(g0, g1))
    log(f"{label}: remat step loss {float(l1):.6f} vs {float(l0):.6f}, "
        f"largest gradient difference {worst:.3e}: "
        f"{'bit-identical' if same else 'DIFFERENT'}; forward launches "
        f"{ {k: (c1[k], c0[k]) for k in in_blocks} } (with, without), "
        f"backward { {k: (c1[k], c0[k]) for k in bwd_names} }")
    log(f"{label} [{card}]: loss and gradients of one step at rung {rung}: "
        f"{t_0:.3f} s and peak {m0 / 2**30:.2f} GiB without remat, "
        f"{t_1:.3f} s and peak {m1 / 2**30:.2f} GiB with remat")
    if not same:
        fail(f"{label}: the remat step's loss or gradients differ")
    for name, n in in_blocks.items():
        want = c0[name] + (n if cuda else 0)
        if c1[name] != want:
            fail(f"{label}: remat forward launches of {name}: {c1[name]}, "
                 f"expected {want}")
    for name in bwd_names:
        if c1[name] != c0[name]:
            fail(f"{label}: remat backward launches of {name} changed")
    if cuda:
        profile_run(f"one {label} step at rung {rung}",
                    lambda: trainer._step_fn(batch, gen, draws), card)


def _caption_mask(b, rung, device):
    """[B, rung] keep-masks from the whole rung down to three quarters."""
    import torch
    return (torch.arange(rung, device=device)[None]
            < torch.tensor([rung - i * rung // (4 * b) for i in range(b)],
                           device=device)[:, None]).to(torch.int32)


# the quantized-base LoRA trainer's keys: an int8 base quantized from the
# fp32 weights, its products through K5/K5b, Lion with 8-bit momentum
INT8_KEYS = {"lora_base_model_8bit": "true", "int8_w8a8": "true",
             "use_adamw_8bit": "true"}
# peak device memory of each training phase's run, by label
TRAIN_PEAKS = {}
# images/s of each run by label (log_step_rate), and the wall and busy ms
# of each profiled window by label (profile_run): phase 12 sets the step
# that encodes on the fly beside phase 7's on pre-extracted features
IMAGES_PER_S = {}
PROFILES = {}
# SANA LoRA with best-of-4 exploration and the preservation term, 3 steps;
# PixArt-Sigma LoRA with the preservation term, 2 steps
EXPLORE_KEYS = {"exploration_steps": "4", "use_preservation": "true",
                "steps": "3"}
PIXART_PRESERVE_KEYS = {"use_preservation": "true", "steps": "2"}


def sana_step_launches(cfg_model, w8a8, full_ft=False):
    """Kernel launches of one SANA training step (no remat) with one
    forward and one backward, and those inside the blocks (which remat runs
    twice).  Under LoRA the first norm of block 0 gets no backward: its
    input and modulation come from the frozen patch and timestep
    embeddings, so no trainable leaf lies upstream of it; under full
    fine-tuning (``full_ft``) those embeddings train, and it does."""
    n_layers = cfg_model.num_layers
    n_soft = len(cfg_model.softmax_self_attn_blocks)
    per_step = {"adaln_layernorm": 2 * n_layers + 1,
                "dot_product_attention": n_layers + n_soft,
                "linear_attention": n_layers - n_soft,
                "adaln_layernorm_bwd": 2 * n_layers + bool(full_ft),
                "dot_product_attention_bwd": n_layers + n_soft}
    in_blocks = {"adaln_layernorm": 2 * n_layers,
                 "dot_product_attention": n_layers + n_soft,
                 "linear_attention": n_layers - n_soft}
    if w8a8:
        # K5 per block: attn1 q/k/v/out, attn2 q/out and k/v on the caption,
        # GLUMB's up-projection (its down-projection's K = 2880 is off the
        # gate), plus the caption projection's two layers outside the
        # blocks; the timestep MLP (T = batch), the patch embedding (K = 32)
        # and proj_out (N = 32) fall back.  K5b: the same in the blocks but
        # attn2's k/v (nothing trainable upstream of the caption) and block
        # 0's attn1 q/k/v (their input comes from frozen modules only)
        per_step["w8a8_matmul"] = 9 * n_layers + 2
        per_step["w8a8_matmul_bwd"] = 7 * n_layers - 3
        in_blocks["w8a8_matmul"] = 9 * n_layers
    return per_step, in_blocks


def step_passes(params):
    """(forwards, backwards) of one training step: the task loss's, one
    no-grad forward per exploration candidate, and with the preservation
    term the adapted model's forward and backward and the base's no-grad
    forward."""
    pres = bool(params.use_preservation)
    return 1 + (params.exploration_steps or 0) + 2 * pres, 1 + pres


def scale_launches(per_step, passes):
    """One forward's and one backward's launches (``per_step``) times the
    step's (forwards, backwards)."""
    fwd, bwd = passes
    return {k: n * (bwd if k.endswith("_bwd") else fwd)
            for k, n in per_step.items()}


def state_leaves(node, path=""):
    """(path, leaf) of a train state (``Trainer.train_state``)."""
    if isinstance(node, dict):
        for k, v in node.items():
            yield from state_leaves(v, f"{path}/{k}")
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            yield from state_leaves(v, f"{path}[{i}]")
    else:
        yield path, node


def host_state(trainer):
    """The trainer's state, every tensor copied to the host."""
    import torch
    return {k: v.detach().cpu().clone() if isinstance(v, torch.Tensor)
            else v for k, v in state_leaves(trainer.train_state())}


def same_state(label, what, got, want):
    """Fail unless two host states hold the same leaves, bit for bit."""
    import torch
    if list(got) != list(want):
        fail(f"{label}: {what}: the leaves differ "
             f"({sorted(set(got) ^ set(want))[:4]})")
    for k, v in want.items():
        g = got[k]
        same = (torch.equal(g, v) and g.dtype == v.dtype
                if isinstance(v, torch.Tensor) else g == v)
        if not same:
            fail(f"{label}: {what}: {k} differs")


def checkpoint_round_trip(label, trainer, card):
    """The run's last checkpoint (``checkpoint_dir``, written at the step
    it ended on) against the live state, bit for bit; then the live state
    wiped to 0 and restored from it by ``Trainer.restore_checkpoint``, bit
    for bit again.  Returns the checkpoint's bytes and the restore's
    seconds."""
    import torch

    from yat_tpu_torch.train.checkpoint import checkpoint_steps

    cuda = trainer.device.type == "cuda"
    d = trainer.params.checkpoint_dir
    steps = checkpoint_steps(d)
    if not steps or steps[-1] != trainer.global_step:
        fail(f"{label}: checkpoints {steps} in {d}; expected the last at "
             f"step {trainer.global_step}")
    path = os.path.join(d, f"{steps[-1]}.pt")
    live = host_state(trainer)
    saved = dict(state_leaves(torch.load(path, map_location="cpu",
                                         weights_only=True)))
    same_state(label, f"checkpoint {os.path.basename(path)} against the "
               "live state", saved, live)
    with torch.no_grad():
        for _, v in state_leaves(trainer.train_state()):
            if isinstance(v, torch.Tensor):
                v.zero_()
    trainer.global_step = trainer.optimizer.count = 0
    trainer.optimizer.mini_step = 0
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.restore_checkpoint()
    if cuda:
        torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    same_state(label, "the restored state against the saved one",
               host_state(trainer), live)
    nbytes = os.path.getsize(path)
    n = sum(1 for v in live.values() if hasattr(v, "dtype"))
    log(f"{label} [{card}]: checkpoint steps {steps}; step {steps[-1]} "
        f"holds {n} tensors in {nbytes / 2**30:.3f} GiB; restored to the "
        f"{'card' if cuda else 'host'} in {restore_s:.2f} s; every restored "
        "tensor bit-equal to the one saved")
    return nbytes, restore_s


def log_int8_base(label, trainer, peak, card):
    """The quantized base's bytes against the same weights in bf16, and the
    peak memory beside the bf16 run's."""
    from yat_tpu_torch.models.layers import AdapterDense
    dense = [m for m in trainer.model.modules()
             if isinstance(m, AdapterDense) and m.qweight is not None]
    n = sum(m.qweight.numel() for m in dense)
    scales = sum(m.weight_scale.numel() for m in dense)
    w8a8 = sum(m.w8a8 for m in dense)
    bf16 = TRAIN_PEAKS.get("train")
    log(f"{label} [{card}]: {len(dense)} dense layers hold an int8 base "
        f"({w8a8} with w8a8 on): {n / 2**20:.1f} MiB of payload + "
        f"{4 * scales / 2**20:.2f} MiB of fp32 scales, against "
        f"{2 * n / 2**20:.1f} MiB in bf16; peak device memory "
        f"{peak / 2**30:.2f} GiB"
        + ("" if bf16 is None else
           f" against {bf16 / 2**30:.2f} GiB for the bf16 base"))
    if not dense or w8a8 != len(dense):
        fail(f"{label}: the trainer left {len(dense) - w8a8} int8 layers "
             "without w8a8")


def phase_train(device, card, shard_args=None, cfg_extra=None,
                label="train", remat=True):
    """The SANA training main path through the entry point; returns the
    launch counts of its run.  With ``INT8_KEYS`` among ``cfg_extra`` it is
    the quantized-base trainer, whose K5/K5b launches are checked too; with
    exploration steps or the preservation term, the launches of each extra
    forward and backward.  The run's last checkpoint goes through a save
    and a restore.  ``remat`` adds the remat and profiled step.
    ``shard_args``/``cfg_extra`` shrink it for a rehearsal on the CPU."""
    import torch

    from yat_tpu_torch.frontends.sana import main as train_main

    cuda = device.type == "cuda"
    with tempfile.TemporaryDirectory() as tmp:
        cfg = {k: v for k, v in train_config(
            os.path.join(tmp, "shard-000000.tar"), os.path.join(tmp, "out"),
            **(cfg_extra or {})).items()
            if v is not None}              # None drops a key
        trainer, counts, wall, peak = run_entry_point(
            label, train_main, device, tmp, cfg, shard_args or {})
        TRAIN_PEAKS[label] = peak
        steps = int(cfg["steps"])
        cfg_model = trainer.sana_config
        n_layers = cfg_model.num_layers
        check_trained(label, trainer, cfg, n_layers)

        w8a8 = trainer.params.int8_w8a8
        one, in_blocks = sana_step_launches(cfg_model, w8a8)
        passes = step_passes(trainer.params)
        per_step = scale_launches(one, passes)
        check_launches(label, counts,
                       {k: n * steps if cuda else 0
                        for k, n in per_step.items()},
                       lambda k: f"{per_step[k]} per step ({passes[0]} "
                       f"forwards, {passes[1]} backwards) x {steps} steps")
        log_step_rate(label, trainer, wall, peak, card)
        if trainer.params.lora_base_model_8bit:
            log_int8_base(label, trainer, peak, card)
        checkpoint_round_trip(label, trainer, card)

        # one more step with remat (low_vram), on one batch and one set of
        # draws, against the step without: the same loss and gradients;
        # without remat, one step under torch.profiler
        gen, batch, draws = sana_batch(trainer, device)
        if remat:
            bwd = ("adaln_layernorm_bwd", "dot_product_attention_bwd") + (
                ("w8a8_matmul_bwd",) if w8a8 else ())
            remat_step(label, trainer, device, card, batch, draws, in_blocks,
                       bwd)
        elif cuda:
            profile_run(f"one {label} step at rung "
                        f"{batch['embeddings'].shape[1]}",
                        lambda: trainer._step_fn(batch, gen, draws), card)
    return {name: counts[name] for name in per_step}


def sana_batch(trainer, device):
    """A seeded SANA training batch at the longest caption rung (masks
    from the whole rung down to three quarters) and one set of draws, with
    their generator."""
    import torch
    cfg_model = trainer.sana_config
    gen = torch.Generator(device=device).manual_seed(5)
    b, rung = trainer.params.batch_size, cfg_model.max_caption_len
    lat_dtype = torch.bfloat16 if trainer.params.bfloat16 else torch.float32
    batch = {
        "latents": torch.randn((b, cfg_model.sample_size,
                                cfg_model.sample_size,
                                cfg_model.in_channels), generator=gen,
                               device=device).to(lat_dtype),
        "embeddings": torch.randn((b, rung, cfg_model.caption_channels),
                                  generator=gen, device=device),
        "text_mask": _caption_mask(b, rung, device)}
    ts, sig = trainer.schedule.training_draw(gen, b)
    draws = {"timesteps": ts, "sigmas": sig,
             "noise": torch.randn(batch["latents"].shape, generator=gen,
                                  device=device)}
    return gen, batch, draws


# ---------------------------------------------------------------------------
# 7b. the adapter kinds beside LoRA
# ---------------------------------------------------------------------------

def phase_adapter_kinds(device, card, shard_args=None, cfg_extra=None,
                        kinds=tuple(ADAPTER_KINDS)):
    """Phase 7's SANA-0.6B configuration (batch 16, bf16) with LoHa,
    LoKr, FourierFT (1000 frequencies) and LoRA with DoRA, 2 steps each
    through the entry point (no warmup, so both steps update): finite
    losses, every leaf changed, the export equal to the live leaves, the
    launches per step as phase 7's; the export reloaded through
    ``lora_pretrained`` into ``make_pipeline``, whose denoiser must equal
    the live model's bit for bit on one fixed input; for DoRA, the
    refiner gate at 0 gives the scale-0 output (``m · W / ‖W‖``), not the
    base's.  Returns the launch counts by kind."""
    import gc

    import torch

    from yat_tpu_torch.frontends.sana import main as sana_main

    cuda = device.type == "cuda"
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        shard = os.path.join(tmp, "shard-000000.tar")
        write_train_shard(shard, **(shard_args or {}))
        for kind in kinds:
            label = f"{kind} train"
            cfg = train_config(shard, os.path.join(tmp, f"out-{kind}"),
                               steps="2", warmup_steps="0",
                               checkpoint_dir=None,
                               num_steps_per_validation="100",
                               **ADAPTER_KINDS[kind], **(cfg_extra or {}))
            cfg = {k: v for k, v in cfg.items() if v is not None}
            with initial_state():
                trainer, counts, wall, peak = drive_entry_point(
                    label, sana_main, device, tmp, cfg)
            n_layers = trainer.sana_config.num_layers
            check_trained(label, trainer, cfg, n_layers)
            one, _ = sana_step_launches(trainer.sana_config, False)
            check_launches(label, counts,
                           {k: 2 * n if cuda else 0 for k, n in one.items()},
                           lambda k: f"{one[k]} per step x 2 steps")
            log_step_rate(label, trainer, wall, peak, card)
            reload_through_lora_pretrained(label, trainer, cfg, device)
            out[kind] = {k: counts[k] for k in one}
            del trainer
            gc.collect()
            if cuda:
                torch.cuda.empty_cache()
    return out


def reload_through_lora_pretrained(label, trainer, cfg, device):
    """The run's export through ``lora_pretrained`` into ``make_pipeline``:
    the served denoiser against the live one on one fixed input, bit for
    bit; for DoRA (its magnitudes scaled by a seeded factor in [0.5, 1.5])
    the refiner gate at 0 against the adapter at scale 0 (bit for bit) and
    against the base (different)."""
    import torch

    from yat_tpu_torch.adapters.builder import adapted_modules
    from yat_tpu_torch.config import TrainingParameters
    from yat_tpu_torch.frontends import sana
    from yat_tpu_torch.models.layers import adapters_off, set_adapter_gate

    path = os.path.join(cfg["output_dir"], cfg["steps"],
                        "adapter_model.safetensors")
    params = TrainingParameters.from_dict(dict(cfg, lora_pretrained=path))
    vp = sana.make_pipeline(params, device)
    c = trainer.sana_config
    gen = torch.Generator(device=device).manual_seed(11)
    args = (torch.randn((2, c.sample_size, c.sample_size, c.in_channels),
                        generator=gen, device=device).to(torch.bfloat16),
            torch.randn((2, 300, c.caption_channels), generator=gen,
                        device=device),
            torch.tensor([250.0, 750.0], device=device),
            _caption_mask(2, 300, device))
    served = vp.model
    with torch.no_grad():
        live, got = trainer.model(*args), served(*args)
        same = torch.equal(live, got)
        log(f"{label}: the export through lora_pretrained into "
            f"make_pipeline: denoiser output {tuple(got.shape)} "
            f"{'equals' if same else 'DIFFERS FROM'} the live model's bit "
            f"for bit")
        if not same:
            fail(f"{label}: the reloaded adapters serve another model "
                 f"(max |diff| {float((live - got).abs().max()):.3e})")
        if adapted_modules(served)[0][1].adapter_kind == "dora":
            # two steps at lr 1e-4 move m by less than a bf16 step of
            # m / |W|: scale it as a longer run would, so that m W / |W|
            # and W differ
            g = torch.Generator(device=device).manual_seed(12)
            for _, m in adapted_modules(served):
                m.dora_m.mul_(0.5 + torch.rand(m.dora_m.shape, generator=g,
                                               device=device))
            set_adapter_gate(served, 0.0)
            gated = served(*args)
            set_adapter_gate(served, None)
            scales = [(m, m.lora_scale) for _, m in adapted_modules(served)]
            for m, _ in scales:
                m.lora_scale = 0.0
            zero = served(*args)
            for m, s0 in scales:
                m.lora_scale = s0
            with adapters_off(served):
                base = served(*args)
            ok = torch.equal(gated, zero) and not torch.equal(gated, base)
            log(f"{label}: DoRA under the refiner gate at 0: "
                f"{'equals' if torch.equal(gated, zero) else 'DIFFERS FROM'}"
                f" the scale-0 output (m W / |W|), max |diff| to the base "
                f"{float((gated - base).abs().max()):.3e}")
            if not ok:
                fail(f"{label}: the gated DoRA layer is not m W / |W|")
    del vp, served


# ---------------------------------------------------------------------------
# 8. PixArt-Sigma training
# ---------------------------------------------------------------------------

# attention branch → (forward kernel, backward kernel); the XLA branch is
# plain tensor code that counts its calls on the card
BRANCH_KERNELS = {
    "flash": ("flash_attention", "flash_attention_bwd"),
    "folded": ("dot_product_attention_folded",
               "dot_product_attention_folded_bwd"),
    "native": ("dot_product_attention", "dot_product_attention_bwd"),
    "xla": ("attention_xla", None)}
PIXART_TRAIN_KERNELS = ("adaln_layernorm", "adaln_layernorm_bwd") + tuple(
    name for pair in BRANCH_KERNELS.values() for name in pair if name)


def pixart_caption_lengths(cfg, n, tmp):
    """T5 caption lengths of ``n`` samples, in file order, such that of the
    ``steps`` batches that ``cfg``'s sampler draws the middle one holds only
    captions of 128 tokens or fewer (rung 128), the last one only captions
    of 256 or fewer with one longer than 128 (rung 256), and the others
    129-300 tokens (rungs 256 and 300).  The sampler's draws (a shuffle
    buffer of 1000 filled by cycling over the shard, from ``dataset_seed``)
    do not depend on the contents, so they are read off a probe shard whose
    i-th sample has i + 1 caption tokens."""
    from yat_tpu_torch.config import TrainingParameters
    from yat_tpu_torch.data.tar import TarShardWriter
    from yat_tpu_torch.frontends.common import build_feature_sampler

    probe = os.path.join(tmp, "probe.tar")
    with TarShardWriter(probe) as w:
        for i in range(n):
            w.write({"__key__": f"{i:06d}", "ratio": "1.0",
                     "latent.npy": np.zeros((1, 1, 1), np.float32),
                     "emb.npy": np.zeros((i + 1, 1), np.float32)})
    params = TrainingParameters.from_dict({**cfg,
                                           "local_shard_paths": [probe]})
    draws = iter(build_feature_sampler(params, n))
    batches = [set((next(draws).text_mask.sum(1) - 1).tolist())
               for _ in range(int(cfg["steps"]))]
    short = batches[len(batches) // 2]
    mid = batches[-1] - short
    rng = np.random.default_rng(0)
    lengths = rng.permutation(np.linspace(129, 300, n).round().astype(int))
    lengths[sorted(mid)] = np.linspace(129, 256, len(mid)).round()
    lengths[sorted(short)] = np.linspace(40, 128, len(short)).round()
    return [int(x) for x in lengths]


def pixart_train_config(shard, out_dir, **extra):
    """configs/pixart_repa.yaml (batch 8, lr 2e-5, bf16, rank 32, alpha 32,
    to_q/to_k/to_v/to_out) without what needs files (the pretrained
    pipeline, the DINOv2 checkpoint, validation prompts), with LoRA for
    LoKr and on a feature shard, so without REPA (its DINO tokens come
    from the on-the-fly encode; phase 12 runs the file as written) and
    without its 8-bit base and optimizer (this cell keeps a bf16 base;
    phase 9 drives them on SANA), with 2 warmup steps,
    caption-length buckets and no caption dropout, for ``TRAIN_STEPS``
    steps."""
    return {"local_shard_paths": [shard], "batch_size": "8",
            "learning_rate": "2e-5", "steps": str(TRAIN_STEPS),
            "warmup_steps": "2", "num_steps_per_validation": "1000",
            "validation_prompts": [], "bfloat16": "true",
            "train_unconditional_prob": "0", "lora_rank": "32",
            "lora_alpha": "32", "lora_algo": "lora",
            "lora_target_modules": LORA_TARGETS,
            "caption_length_bucketing": "true", "output_dir": out_dir,
            "dataset_seed": "0", **extra}


def pixart_branches(cfg, rung, tokens=None):
    """The branches of the self-attention and of the cross-attention at
    caption rung ``rung`` (``tokens`` image tokens; the square grid of
    ``sample_size`` by default)."""
    from yat_tpu_torch.ops.attention import attention_branch
    tokens = tokens or (cfg.sample_size // cfg.patch_size) ** 2
    return tuple(attention_branch(tokens, nk, cfg.num_attention_heads,
                                  cfg.attention_head_dim)
                 for nk in (tokens, rung))


def pixart_step_launches(cfg, rung, tokens=None):
    """Kernel launches of one PixArt-Sigma training step (no remat) at
    caption rung ``rung`` (and ``tokens`` image tokens): K1 twice a block
    and at the output, K1b twice a block (block 0's first norm needs no
    gradient: its input and modulation come from frozen embeddings), and
    per block one self- and one cross-attention forward and backward, by
    branch."""
    n = cfg.num_layers
    want = dict.fromkeys(PIXART_TRAIN_KERNELS, 0)
    want["adaln_layernorm"] = 2 * n + 1
    want["adaln_layernorm_bwd"] = 2 * n
    for branch in pixart_branches(cfg, rung, tokens):
        fwd, bwd = BRANCH_KERNELS[branch]
        want[fwd] += n
        if bwd:
            want[bwd] += n
    return want


def phase_pixart_train(device, card, shard_args=None, cfg_extra=None,
                       label="pixart train", remat=True):
    """The PixArt-Sigma training main path through the entry point; returns
    the launch counts of its run (with the preservation term, those of its
    extra forwards and backward).  ``remat`` adds the remat and profiled
    step.  ``shard_args``/``cfg_extra`` shrink it for a rehearsal on the
    CPU."""
    import torch

    from yat_tpu_torch.data.sampler import caption_length_buckets
    from yat_tpu_torch.frontends.pixart import main as train_main

    cuda = device.type == "cuda"
    with tempfile.TemporaryDirectory() as tmp:
        cfg = {k: v for k, v in pixart_train_config(
            os.path.join(tmp, "shard-000000.tar"), os.path.join(tmp, "out"),
            **(cfg_extra or {})).items()
            if v is not None}              # None drops a key
        # 48 PixArt-Sigma 512px samples: latents [64, 64, 4] fp32, T5-XXL
        # captions [L_i, 4096] fp32 of 40-300 tokens
        shard = {"n": 48, "latent": (64, 64, 4), "dim": 4096,
                 **(shard_args or {})}
        shard["caption_lengths"] = pixart_caption_lengths(cfg, shard["n"],
                                                          tmp)
        trainer, counts, wall, peak = run_entry_point(
            label, train_main, device, tmp, cfg, shard)
        cfg_model = trainer.pixart_config
        n_layers = cfg_model.num_layers
        check_trained(label, trainer, cfg, n_layers)

        rungs = [h["caption_len"] for h in trainer.history]
        ladder = caption_length_buckets(cfg_model.max_caption_len)
        if not set(rungs) <= set(ladder) or len(ladder) > 1 and (
                min(ladder) not in rungs or max(rungs) == min(ladder)):
            fail(f"{label}: steps on rungs {rungs}; expected the ladder "
                 f"{ladder}'s lowest rung and a higher one")
        if cuda:
            # on the card the self-attention takes the flash branch, the
            # cross-attention the native one at rung 128 and the folded one
            # at 256 and 300, and nothing the XLA branch
            for rung in sorted(set(rungs)):
                got = pixart_branches(cfg_model, rung)
                want = ("flash", "native" if rung <= 128 else "folded")
                if got != want:
                    fail(f"{label}: branches at rung {rung}: {got}, "
                         f"expected {want}")
        want = dict.fromkeys(PIXART_TRAIN_KERNELS, 0)
        per_rung = {}
        passes = step_passes(trainer.params)
        for rung in rungs:
            per_rung[rung] = scale_launches(
                pixart_step_launches(cfg_model, rung), passes)
            for name, n in per_rung[rung].items():
                want[name] += n if cuda else 0
        check_launches(label, counts, want, lambda k: " + ".join(
            f"{per_rung[r][k]} at rung {r} x {rungs.count(r)}"
            for r in sorted(per_rung)) + f" ({passes[0]} forwards, "
            f"{passes[1]} backwards a step)")
        log_step_rate(label, trainer, wall, peak, card)

        # one more step with remat (low_vram) at the longest rung (without
        # remat, one step under torch.profiler)
        gen = torch.Generator(device=device).manual_seed(5)
        b, rung = trainer.params.batch_size, cfg_model.max_caption_len
        lat_dtype = torch.bfloat16 if trainer.params.bfloat16 else torch.float32
        grid = cfg_model.sample_size
        batch = {
            "latents": torch.randn((b, grid, grid, cfg_model.in_channels),
                                   generator=gen, device=device
                                   ).to(lat_dtype),
            "embeddings": torch.randn((b, rung, cfg_model.caption_channels),
                                      generator=gen, device=device),
            "text_mask": _caption_mask(b, rung, device)}
        draws = {"timesteps": trainer.schedule.training_draw(gen, b),
                 "noise": torch.randn(batch["latents"].shape, generator=gen,
                                      device=device)}
        if not remat:
            if cuda:
                profile_run(f"one {label} step at rung {rung}",
                            lambda: trainer._step_fn(batch, gen, draws), card)
            return {name: counts[name] for name in PIXART_TRAIN_KERNELS}
        (self_f, self_b), (cross_f, cross_b) = (
            BRANCH_KERNELS[br] for br in pixart_branches(cfg_model, rung))
        in_blocks = {"adaln_layernorm": 2 * n_layers}
        for name in (self_f, cross_f):
            in_blocks[name] = in_blocks.get(name, 0) + n_layers
        remat_step(label, trainer, device, card, batch, draws, in_blocks,
                   ("adaln_layernorm_bwd",) + tuple(
                       n for n in (self_b, cross_b) if n))
    return {name: counts[name] for name in PIXART_TRAIN_KERNELS}


# ---------------------------------------------------------------------------
# 10. full fine-tuning, checkpoints, resume, the profiler window
# ---------------------------------------------------------------------------

FULL_FT_STEPS = 16
# kernel names a trace must hold (KERNEL_FAMILIES' keys): K2, K2b, K1b
TRACE_KERNELS = {"K2": "attention_fwd_bf16", "K2b": "attention_bwd_dq",
                 "K1b": "adaln_bwd"}


def full_ft_config(shard, tmp, **extra):
    """configs/sana_softmax_patch.yaml without what needs files (the
    validation prompt; the shard is synthetic), for ``FULL_FT_STEPS``
    steps with the validation (export and checkpoint) cadence cut from
    1000 to 8, SANA-0.6B cut to 16 blocks (``DEPTH_CUTS``), and
    ``checkpoint_dir`` and ``profile_dir`` beside the shard."""
    return {"local_shard_paths": [shard], "batch_size": "16",
            "learning_rate": "1e-5", "steps": str(FULL_FT_STEPS),
            "num_steps_per_validation": "8", "validation_prompts": [],
            "bfloat16": "true", "use_ema": "true",
            "model_config_overrides": {
                "preset": "600M", "softmax_self_attn_blocks": [12, 13, 14,
                                                               15],
                **DEPTH_CUTS["full_ft"]},
            "unfreeze_modules": [f"blocks_{i}" for i in (12, 13, 14, 15)],
            "warmup_compile": "true", "caption_length_bucketing": "true",
            "checkpoint_dir": os.path.join(tmp, "ckpt"),
            "profile_dir": os.path.join(tmp, "prof"),
            "output_dir": os.path.join(tmp, "out"), "dataset_seed": "0",
            **extra}


def check_frozen(label, trainer, init, patterns):
    """Every leaf outside ``patterns`` bit-equal to ``init`` (host
    tensors, flax paths); returns how many of the unfrozen ones moved."""
    import torch

    from yat_tpu_torch.convert import flax_params
    from yat_tpu_torch.train.state import unfreeze_mask
    moved = 0
    for name, t in flax_params(trainer.model).items():
        same = torch.equal(t.detach().cpu(), init[name])
        if unfreeze_mask([name], patterns)[0]:
            moved += not same
        elif not same:
            fail(f"{label}: {name} changed, though outside "
                 f"unfreeze_modules {patterns}")
    return moved


def check_traces(label, prof_dir, cuda=True):
    """The profiler's traces under ``prof_dir``: each must hold K2's, K2b's
    and K1b's kernels (on the CPU, which runs none: PyTorch's operators);
    returns their count."""
    traces = sorted(os.listdir(prof_dir)) if os.path.isdir(prof_dir) else []
    traces = [t for t in traces if t.endswith(".pt.trace.json")]
    if not traces:
        fail(f"{label}: no profiler trace in {prof_dir}")
    for t in traces:
        with open(os.path.join(prof_dir, t)) as f:
            text = f.read()
        names = TRACE_KERNELS if cuda else {"operators": "aten::"}
        found = {k: text.count(v) for k, v in names.items()}
        log(f"{label}: trace {t} ({len(text) / 2**20:.1f} MiB): kernel "
            f"names by count {found}")
        missing = [k for k, n in found.items() if not n]
        if missing:
            fail(f"{label}: trace {t} names no {missing}")
    return len(traces)


def phase_full_finetune(device, card, shard_args=None, cfg_extra=None):
    """configs/sana_softmax_patch.yaml's full fine-tuning through the entry
    point (SANA-0.6B, blocks 12-15 with softmax self-attention and the only
    ones unfrozen, batch 16, bf16 compute over fp32 leaves, EMA, lr 1e-5),
    16 steps with checkpoints at 8 and 16 and the profiler over steps
    10-14; then the run is cut back to its step-8 checkpoint (the step-16
    file removed, as a run killed between the two writes leaves it) and a
    second run of the same config with ``resume`` carries on from step 8 to
    16.  Checks the losses, the launches per step, every leaf outside
    blocks 12-15 bit-unchanged, the export and its ``config.json``, the
    checkpoint against the live state, the restore bit for bit, the resumed
    run's caption rungs against the first run's (the data fast-forward) and
    the traces.  Returns the first run's launch counts.
    ``shard_args``/``cfg_extra`` shrink it for a rehearsal on the CPU."""
    import gc

    import torch

    from yat_tpu_torch.convert import flax_params
    from yat_tpu_torch.frontends.sana import build_denoiser
    from yat_tpu_torch.frontends.sana import main as train_main
    from yat_tpu_torch.train.checkpoint import (save_train_state,
                                                wait_for_checkpoints)
    from yat_tpu_torch.train.state import unfreeze_mask

    cuda = device.type == "cuda"
    label = "full fine-tune"
    with tempfile.TemporaryDirectory() as tmp:
        shard = os.path.join(tmp, "shard-000000.tar")
        cfg = {k: v for k, v in full_ft_config(shard, tmp,
                                               **(cfg_extra or {})).items()
               if v is not None}
        steps = int(cfg["steps"])
        half = int(cfg["num_steps_per_validation"])
        patterns = cfg["unfreeze_modules"]
        trainer, counts, wall, peak = run_entry_point(
            label, train_main, device, tmp, cfg, shard_args or {})
        hist = trainer.history
        if [h["step"] for h in hist] != list(range(1, steps + 1)) or not all(
                math.isfinite(h["loss"]) for h in hist):
            fail(f"{label}: expected {steps} finite losses, got {hist}")
        for h in hist:
            log(f"{label}: step {h['step']} caption rung {h['caption_len']} "
                f"loss {h['loss']:.6f} grad_norm {h['grad_norm']:.4f}")
        cfg_model = trainer.sana_config
        one, _ = sana_step_launches(cfg_model, False, full_ft=True)
        check_launches(label, counts,
                       {k: n * steps if cuda else 0 for k, n in one.items()},
                       lambda k: f"{one[k]} per step x {steps} steps")
        log_step_rate(label, trainer, wall, peak, card)
        n_leaves = len(trainer.trainable_leaves())
        log(f"{label}: {n_leaves} fp32 leaves "
            f"({sum(p.numel() for p in trainer.trainable_leaves()):,} "
            f"values), {len(trainer.optimizer.active)} updated by "
            f"unfreeze_modules {patterns}; peak device memory "
            f"{peak / 2**30:.2f} GiB")
        if any(p.dtype != torch.float32 for p in trainer.trainable_leaves()):
            fail(f"{label}: full fine-tuning leaves not stored in fp32")

        init_model = build_denoiser(trainer.params, cfg_model, device)
        init = {k: v.detach().cpu() for k, v in
                flax_params(init_model).items()}
        del init_model
        moved = check_frozen(label, trainer, init, patterns)
        log(f"{label}: every leaf outside {patterns} bit-unchanged after "
            f"{steps} steps; {moved} of the "
            f"{sum(unfreeze_mask(list(init), patterns))} leaves inside "
            "moved")
        if not moved:
            fail(f"{label}: no leaf of {patterns} moved")
        out = os.path.join(cfg["output_dir"], str(steps))
        with open(os.path.join(out, "config.json")) as f:
            exported = json.load(f)
        size = os.path.getsize(os.path.join(out, "model.safetensors"))
        log(f"{label}: export {out}: model.safetensors "
            f"{size / 2**30:.3f} GiB, config.json {exported}")
        if exported.get("modified_blocks") != list(
                cfg_model.softmax_self_attn_blocks):
            fail(f"{label}: config.json records {exported}")

        # one checkpoint's bytes and seconds: the host copy (before
        # save_train_state returns) and the write (the background thread)
        timing = os.path.join(tmp, "timing")
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_train_state(timing, trainer.train_state(), steps)
        t1 = time.perf_counter()
        wait_for_checkpoints(timing)
        t2 = time.perf_counter()
        nbytes = os.path.getsize(os.path.join(timing, f"{steps}.pt"))
        shutil.rmtree(timing)
        log(f"{label} [{card}]: one checkpoint {nbytes / 2**30:.3f} GiB: "
            f"copy to the host {t1 - t0:.2f} s, write {t2 - t1:.2f} s "
            f"({nbytes / 2**30 / max(t2 - t1, 1e-9):.2f} GiB/s)")
        checkpoint_round_trip(label, trainer, card)
        first_rungs = [h["caption_len"] for h in hist]
        if cuda:
            gen, batch, draws = sana_batch(trainer, device)
            profile_run(f"one {label} step at rung "
                        f"{batch['embeddings'].shape[1]}",
                        lambda: trainer._step_fn(batch, gen, draws), card)
        del trainer
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

        # the run killed between its step-8 and step-16 writes
        os.remove(os.path.join(cfg["checkpoint_dir"], f"{steps}.pt"))
        resumed = dict(cfg, resume="true")
        t0 = time.perf_counter()
        again, counts2, wall2, peak2 = run_entry_point(
            f"{label} (resumed)", train_main, device, tmp, resumed,
            shard_args or {})
        hist2 = again.history
        if [h["step"] for h in hist2] != list(range(half + 1, steps + 1)):
            fail(f"{label}: the resumed run took steps "
                 f"{[h['step'] for h in hist2]}, expected {half + 1}-"
                 f"{steps}")
        rungs2 = [h["caption_len"] for h in hist2]
        if rungs2 != first_rungs[half:]:
            fail(f"{label}: the resumed run's caption rungs {rungs2} are "
                 f"not the first run's {first_rungs[half:]}")
        check_launches(f"{label} (resumed)", counts2,
                       {k: n * (steps - half) if cuda else 0
                        for k, n in one.items()},
                       lambda k: f"{one[k]} per step x {steps - half} steps")
        log_step_rate(f"{label} (resumed)", again, wall2, peak2, card)
        check_frozen(f"{label} (resumed)", again, init, patterns)
        log(f"{label}: resumed from step {half} to {again.global_step}; "
            f"rungs {rungs2} as the first run's; every leaf outside "
            f"{patterns} still bit-unchanged")
        checkpoint_round_trip(f"{label} (resumed)", again, card)
        n = check_traces(label, cfg["profile_dir"], cuda)
        log(f"{label}: {n} profiler traces (steps 10-14 of each run)")
        del again
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return {name: counts[name] for name in one}


# ---------------------------------------------------------------------------
# 12. raw images: decode, the encoders, extraction, on-the-fly training,
#     resume through skip_batches, PixArt-Sigma on the fly, Dreambooth
# ---------------------------------------------------------------------------

# source images per 512px bucket: (source height, width), 1.25x the bucket
# so every image is resized; the buckets "1.0", "0.78", "1.29" and "0.5"
RAW_SOURCES = ((640, 640), (560, 720), (720, 560), (440, 880))
# the stand-in R2 account of the extraction (the config's own is left out)
S3_KEYS = ("AKIDSTANDIN", "stand-in-secret", "my-dataset")
# captions of 8 to 240 words (Gemma-2's and T5's rungs 64 to 256)
CAPTION_WORDS = ("a photo of a small red fox sitting in fresh snow near an "
                 "old wooden fence under a pale winter sky with pine trees "
                 "and distant hills").split()


def raw_caption(i, n_words):
    words = [CAPTION_WORDS[(i + k) % len(CAPTION_WORDS)]
             for k in range(n_words)]
    return f"image {i}: " + " ".join(words)


def jpeg_bytes(img):
    """RGB uint8 → JPEG bytes through cv2, else PIL (the card's machine has
    both; a machine without either cannot make the phase's data)."""
    try:
        import cv2
        ok, enc = cv2.imencode(".jpg", img[..., ::-1],
                               [cv2.IMWRITE_JPEG_QUALITY, 90])
        if not ok:
            fail("cv2 could not encode a JPEG")
        return enc.tobytes()
    except ImportError:
        import io

        from PIL import Image
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format="JPEG", quality=90)
        return buf.getvalue()


def raw_image(rng, h, w):
    """A smooth seeded RGB image (gradients and a few discs) with noise."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([x / w, y / h, 0.5 + 0.5 * np.sin((x + y) / 37.0)], -1)
    for _ in range(3):
        cy, cx, r = rng.uniform(0, h), rng.uniform(0, w), rng.uniform(20, 90)
        img[(y - cy) ** 2 + (x - cx) ** 2 < r * r] = rng.uniform(0, 1, 3)
    img = img * 255.0 + rng.normal(0, 6, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def write_raw_shards(tmp, per_bucket, scale=1.0, shards=2, seed=0,
                     sources=RAW_SOURCES):
    """``per_bucket`` JPEG samples at each of ``sources`` (times
    ``scale``), interleaved, with captions of 8-240 words, over ``shards``
    local ``{jpg, txt}`` shards.  Returns the paths and each sample's
    source size."""
    from yat_tpu_torch.data.tar import TarShardWriter

    rng = np.random.default_rng(seed)
    n = per_bucket * len(sources)
    words = rng.permutation(np.linspace(8, 240, n).round().astype(int))
    paths = [os.path.join(tmp, f"raw-{i:06d}.tar") for i in range(shards)]
    sizes = []
    writers = [TarShardWriter(p) for p in paths]
    try:
        for i in range(n):
            h, w = (int(d * scale) for d in sources[i % len(sources)])
            sizes.append((h, w))
            writers[i * shards // n].write({
                "__key__": f"{i:06d}",
                "jpg": jpeg_bytes(raw_image(rng, h, w)),
                "txt": raw_caption(i, int(words[i]))})
    finally:
        for wr in writers:
            wr.close()
    return paths, sizes


def write_image_folder(path, n, size, seed, caption=None):
    os.makedirs(path, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        with open(os.path.join(path, f"{i:03d}.jpg"), "wb") as f:
            f.write(jpeg_bytes(raw_image(rng, *size)))
        if caption and i == 0:
            with open(os.path.join(path, f"{i:03d}.txt"), "w") as f:
                f.write(caption)
    return path


class StandInS3:
    """An S3 endpoint on 127.0.0.1, served from a thread of this process:
    each PUT's and GET's presigned query must carry the SigV4 signature
    that the credentials give for its method, bucket, key, date and expiry
    (else 403); accepted PUT bodies are stored under ``root/<key>``, and a
    GET serves ``root/<key>`` (404 where there is none)."""

    def __init__(self, root, access_key, secret_key, bucket):
        import http.server
        import urllib.parse

        from yat_tpu_torch.data.r2 import R2Client

        self.root, self.bucket = root, bucket
        self.stored, self.served, self.rejected = [], [], 0
        outer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def _signed(self, method):
                """The request's key parts, or None when its signature is
                not the one the credentials give."""
                url = urllib.parse.urlsplit(self.path)
                q = dict(urllib.parse.parse_qsl(url.query))
                parts = [urllib.parse.unquote(p)
                         for p in url.path.lstrip("/").split("/")]
                if parts[0] == outer.bucket and "X-Amz-Date" in q:
                    when = datetime.datetime.strptime(
                        q["X-Amz-Date"], "%Y%m%dT%H%M%SZ").replace(
                        tzinfo=datetime.timezone.utc)
                    want = R2Client(access_key, secret_key, outer.url).presign(
                        method, outer.bucket, "/".join(parts[1:]),
                        int(q.get("X-Amz-Expires", 0)), now=when)
                    if want == f"{outer.url}{self.path}":
                        return parts
                outer.rejected += 1
                self.send_response(403)
                self.end_headers()
                return None

            def do_GET(self):
                parts = self._signed("GET")
                if parts is None:
                    return
                src = os.path.join(outer.root, *parts[1:])
                if not os.path.isfile(src):
                    self.send_response(404)
                    self.end_headers()
                    return
                with open(src, "rb") as f:
                    body = f.read()
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                outer.served.append(("/".join(parts[1:]), len(body)))

            def do_PUT(self):
                body = self.rfile.read(int(self.headers["Content-Length"]))
                parts = self._signed("PUT")
                if parts is None:
                    return
                dest = os.path.join(outer.root, *parts[1:])
                os.makedirs(os.path.dirname(dest), exist_ok=True)
                with open(dest, "wb") as f:
                    f.write(body)
                outer.stored.append(("/".join(parts[1:]), len(body)))
                self.send_response(200)
                self.end_headers()

            def log_message(self, *a):
                pass

        self.srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.srv.server_address[1]}"
        self.thread = threading.Thread(target=self.srv.serve_forever,
                                       daemon=True)

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.srv.shutdown()
        self.srv.server_close()
        self.thread.join(timeout=30)


@contextlib.contextmanager
def working_dir(path):
    """Run the block in ``path`` (the extraction writes ``features/`` under
    the working directory)."""
    old = os.getcwd()
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(old)


@contextlib.contextmanager
def recorded_batches():
    """The latent grid and caption rung of every batch the trainers of the
    block move to the device, in order (one a step without accumulation):
    which attention branch a step takes depends on them."""
    from yat_tpu_torch.train.engine import Trainer

    seen = []
    move = Trainer._device_batch

    def recording(self, batch):
        out = move(self, batch)
        seen.append((tuple(out["latents"].shape[1:3]),
                     int(out["embeddings"].shape[1])))
        return out
    Trainer._device_batch = recording
    try:
        yield seen
    finally:
        Trainer._device_batch = move


def sana_launches_at(cfg, grid, rung):
    """One SANA LoRA step's launches at latent ``grid`` and caption
    ``rung``: ``sana_step_launches``, with the cross-attention (and the
    softmax self-attention) taking the branch its sizes give; the XLA
    branch launches no kernel and counts its calls."""
    from yat_tpu_torch.ops.attention import attention_branch
    per_step, _ = sana_step_launches(cfg, False)
    per_step["attention_xla"] = 0
    tokens = (grid[0] // cfg.patch_size) * (grid[1] // cfg.patch_size)
    n_soft = len(cfg.softmax_self_attn_blocks)
    for n_k, heads, dim, n in (
            (rung, cfg.num_cross_attention_heads,
             cfg.cross_attention_head_dim, cfg.num_layers),
            (tokens, cfg.num_attention_heads, cfg.attention_head_dim,
             n_soft)):
        if n and attention_branch(tokens, n_k, heads, dim) == "xla":
            per_step["dot_product_attention"] -= n
            per_step["dot_product_attention_bwd"] -= n
            per_step["attention_xla"] += n
    return per_step


@contextlib.contextmanager
def counted_encoders():
    """Count the image and caption encoders' calls (direct or through
    ``.dispatch``) of the SANA and PixArt trainers built in the block
    (``calls``), and those made inside each ``skip_batches``
    (``calls["in_skip"]``); ``calls["tf32"]`` holds the (matmul, cuDNN)
    TF32 flags in force at each image encode."""
    import torch

    from yat_tpu_torch.frontends import pixart, sana
    from yat_tpu_torch.train.encode import OnTheFlyEncodingSampler

    calls = {"images": 0, "captions": 0, "in_skip": [], "skipped": [],
             "tf32": set()}

    def counting(make, key):
        def build(*a, **kw):
            fn = make(*a, **kw)
            if fn is None:
                return None

            def counted(f):
                def call(x):
                    calls[key] += 1
                    if key == "images":
                        calls["tf32"].add((
                            torch.backends.cuda.matmul.allow_tf32,
                            torch.backends.cudnn.allow_tf32))
                    return f(x)
                return call
            call = counted(fn)
            call.dispatch, call.module = counted(fn.dispatch), fn.module
            return call
        return build

    saved = [(sana, "make_image_encoder"), (sana, "make_caption_encoder"),
             (pixart, "build_t5_vae_encoders"),
             (OnTheFlyEncodingSampler, "skip_batches")]
    old = {(id(m), n): getattr(m, n) for m, n in saved}
    sana.make_image_encoder = counting(sana.make_image_encoder, "images")
    sana.make_caption_encoder = counting(sana.make_caption_encoder,
                                         "captions")
    t5_vae = pixart.build_t5_vae_encoders

    def counted_t5_vae(*a, **kw):
        ei, ec, dl = t5_vae(*a, **kw)
        return (counting(lambda: ei, "images")(),
                counting(lambda: ec, "captions")(), dl)
    pixart.build_t5_vae_encoders = counted_t5_vae
    skip = OnTheFlyEncodingSampler.skip_batches

    def counted_skip(self, n):
        before = calls["images"] + calls["captions"]
        skip(self, n)
        calls["in_skip"].append(calls["images"] + calls["captions"] - before)
        calls["skipped"].append(n)
    OnTheFlyEncodingSampler.skip_batches = counted_skip
    try:
        yield calls
    finally:
        for m, n in saved:
            setattr(m, n, old[(id(m), n)])


def cuda_ms(fn, reps=3):
    """Median device milliseconds of ``fn()`` by CUDA events, after one
    warm-up call."""
    import statistics

    import torch
    fn()
    out = []
    for _ in range(reps):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)


def decode_ms(datas, th, tw, decoder, reps=3):
    """Host milliseconds to decode and resize one batch of JPEG bytes to
    ``(th, tw)`` uint8 by ``decoder`` (median of ``reps``)."""
    import statistics

    from yat_tpu_torch.data import native
    from yat_tpu_torch.data.sampler import decode_image, resize_u8

    def run():
        if decoder == "native":
            out, status = native.decode_batch(datas, th, tw)
            if status.any():
                fail(f"native decode failed: status {status}")
            return out
        return np.stack([resize_u8(decode_image(d), th, tw) for d in datas])

    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = run()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), out


def raw_train_keys(tiny):
    """The SANA model keys of phase 12's runs: SANA-0.6B 512px at 8 of its
    28 blocks (``DEPTH_CUTS``); the tiny model, encoders and 256px bins for
    the rehearsal."""
    if tiny is None:
        return depth_cut("train")
    return {"model_config_overrides": dict(tiny["sana"]),
            "aspect_ratio": str(tiny["resolution"])}


def extract_config(raw, s3, batch, chunk, tiny):
    """configs/sana_extract_features.yaml without its R2 account (the
    stand-in endpoint's instead) and its pretrained pipe (random Gemma-2-2B
    and DC-AE from the seed), on local raw shards, with Gemma-2-2B in bf16
    (the slice's width; the file runs it in fp32)."""
    ak, sk, bucket = S3_KEYS
    return {"extract_features": "true", "compute_features": "true",
            "vae_max_batch_size": str(chunk),
            "text_encoder_max_batch_size": str(chunk),
            "local_shard_paths": raw, "r2_endpoint": s3.url,
            "r2_access_key": ak, "r2_secret_key": sk,
            "r2_bucket_name": bucket, "r2_dataset_folder": "raw",
            "r2_upload_key": "features", "r2_upload_shard_size": "1000",
            "num_shards": "128", "batch_size": str(batch),
            "learning_rate": "1e-4", "steps": "1",
            "num_steps_per_validation": "1000", "validation_prompts": [],
            "bfloat16": "true", "dataset_seed": "0", **raw_train_keys(tiny)}


def expected_extraction(sizes, bins, batch):
    """The samples a one-pass, unshuffled bucketing of sources of ``sizes``
    emits, by bucket (only full batches leave a bucket)."""
    from yat_tpu_torch.data.bins import find_closest_ratio
    per = {}
    for h, w in sizes:
        key = find_closest_ratio(h / w, bins)
        per[key] = per.get(key, 0) + 1
    return {k: n - n % batch for k, n in per.items() if n >= batch}


def check_feature_shards(label, root, names, bins, comp, dim, max_len,
                         want):
    """The uploaded feature shards: every sample ``{ratio, latent.npy,
    emb.npy}``, latents ``[h/comp, w/comp, C]`` of the bucket, captions
    ``[L, dim]`` with 0 < L <= ``max_len``, finite, and the samples by
    bucket as the bucketing gives them.  Returns the shard paths."""
    from yat_tpu_torch.data.tar import iter_tar_samples

    got, paths, channels = {}, [], set()
    for name in names:
        path = os.path.join(root, name)
        paths.append(path)
        for elem in iter_tar_samples(path):
            if set(elem) != {"__key__", "ratio", "latent.npy", "emb.npy"}:
                fail(f"{label}: sample fields {sorted(elem)}")
            key, lat, emb = elem["ratio"], elem["latent.npy"], elem["emb.npy"]
            h, w = bins[key]
            channels.add(lat.shape[-1])
            if lat.shape[:2] != (h // comp, w // comp) or lat.ndim != 3:
                fail(f"{label}: bucket {key} latent {lat.shape}")
            if emb.ndim != 2 or emb.shape[1] != dim or not (
                    0 < emb.shape[0] <= max_len):
                fail(f"{label}: caption embedding {emb.shape}")
            if not (np.isfinite(lat).all() and np.isfinite(emb).all()):
                fail(f"{label}: non-finite features in bucket {key}")
            got[key] = got.get(key, 0) + 1
    if got != want:
        fail(f"{label}: samples by bucket {got}, expected {want}")
    log(f"{label}: {sum(got.values())} samples in {len(names)} uploaded "
        f"shard(s), by bucket {got}; latents [h/{comp}, w/{comp}, "
        f"{sorted(channels)}], captions [L <= {max_len}, {dim}]")
    return paths


def phase_raw_images(device, card, tiny=None):
    """Phase 12: training from raw images through the port's entry points.
    ``tiny`` (the CPU rehearsal) shrinks the models, bins, batches and
    images; on the card everything runs at full width: the DC-AE f32c32
    encoder at 512px in fp32 (TF32 off), Gemma-2-2B in bf16, SANA-0.6B (28
    blocks, width 1152), and for PixArt the SD KL-VAE encoder, T5-XXL and
    PixArt-Sigma XL-2 (all its 28 blocks, 2 steps).  Returns the launch
    counts of the on-the-fly SANA and PixArt-Sigma runs."""
    import copy
    import gc

    import torch

    from yat_tpu_torch.data import native
    from yat_tpu_torch.data.bins import bin_for_resolution
    from yat_tpu_torch.data.sampler import (DreamboothSampler,
                                            ImageBucketSampler)
    from yat_tpu_torch.frontends.common import slice_caption_rung, u8_to_unit
    from yat_tpu_torch.frontends.pixart import main as pixart_main
    from yat_tpu_torch.frontends.sana import main as sana_main
    from yat_tpu_torch.train.encode import FeatureCache
    from yat_tpu_torch.utils.tokenizer import load_tokenizer

    cuda = device.type == "cuda"
    t = tiny or {}
    batch, chunk = t.get("batch", 16), t.get("chunk", 8)
    res = t.get("resolution", 512)
    bins = bin_for_resolution(res)
    out = {}
    if cuda:
        # TF32 on, as a user's process may have it (cuDNN's default): the
        # entry points must turn it off for the fp32 encoders themselves
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
    with tempfile.TemporaryDirectory() as tmp:
        # (a) the decoder, and real JPEG bytes to decode
        decoder = "native" if native.available() else "cv2"
        why = native.unavailable_reason()
        log(f"raw images: decoder: {decoder}"
            + (f" (native unavailable: {why})" if why else ""))
        t0 = time.perf_counter()
        raw, sizes = write_raw_shards(tmp, t.get("per_bucket", 16),
                                      scale=res / 512)
        log(f"raw images: wrote {len(sizes)} JPEGs at sources "
            f"{sorted(set(sizes))} into {len(raw)} shards "
            f"({sum(os.path.getsize(p) for p in raw) / 1e6:.1f} MB) in "
            f"{time.perf_counter() - t0:.1f} s")
        sampler = ImageBucketSampler(raw, batch, bins, shuffle_buffer=1)
        if sampler.decoder != decoder:
            fail(f"the sampler decodes through {sampler.decoder}, "
                 f"native.available() says {decoder}")
        first = next(iter(sampler))
        th, tw = bins[first.ratio]
        if first.images.shape != (batch, th, tw, 3) or \
                first.images.dtype != np.uint8:
            fail(f"raw images: batch {first.images.shape} "
                 f"{first.images.dtype}")
        from yat_tpu_torch.data.tar import iter_tar_samples
        datas = [e["jpg"] for e in iter_tar_samples(raw[0])][:batch]
        timings = {}
        for dec in ("native", "cv2") if decoder == "native" else ("cv2",):
            timings[dec], _ = decode_ms(datas, th, tw, dec)
        log(f"raw images [{card}]: host decode + resize of a batch of "
            f"{len(datas)} to {th}x{tw}: "
            + ", ".join(f"{k} {v:.1f} ms" for k, v in timings.items()))

        # (b) the extraction pass through the entry point, uploading to the
        # stand-in endpoint
        with StandInS3(os.path.join(tmp, "s3"), *S3_KEYS) as s3, \
                working_dir(tmp), counted_encoders() as calls:
            cfg = extract_config(raw, s3, batch, chunk, tiny)
            trainer, counts, wall, peak = drive_entry_point(
                "extract", sana_main, device, tmp, cfg)
        check_fp32_encodes("extract", calls, cuda)
        ex = trainer.extraction
        if s3.rejected or sorted(n for n, _ in s3.stored) != sorted(
                f"features/{n}" for n in ex.uploaded) or not ex.uploaded:
            fail(f"extract: uploads {s3.stored}, rejected {s3.rejected}, "
                 f"the extractor reports {ex.uploaded}")
        want = expected_extraction(sizes, bins, batch)
        if ex.written != sum(want.values()):
            fail(f"extract: {ex.written} samples written, the bucketing "
                 f"gives {want}")
        enc_i, enc_c = trainer.encode_images, trainer.encode_captions
        vae, gemma = enc_i.module, enc_c.module
        comp, lat_c = vae.cfg.compression, vae.cfg.latent_channels
        shards = check_feature_shards(
            "extract", os.path.join(tmp, "s3"),
            [n for n, _ in s3.stored], bins, comp,
            trainer.sana_config.caption_channels,
            trainer.sana_config.max_caption_len, want)
        phases = {k: round(v / 1e3, 3) for k, v in ex.phase_ms.items()}
        log(f"extract [{card}]: {ex.written} images in {wall:.1f} s through "
            f"the entry point (models built); the pass "
            f"{ex.images_per_sec:.2f} images/s; phase seconds {phases}; "
            f"{len(s3.stored)} signed PUTs accepted "
            f"({sum(b for _, b in s3.stored) / 1e6:.1f} MB), 0 rejected; "
            f"peak device memory {peak / 2**30:.2f} GiB with the encoders "
            f"and SANA resident")
        # the encoders are plain PyTorch, and the pass runs no denoiser
        launched = {k: n for k, n in counts.items() if n}
        if launched:
            fail(f"extract: the pass launched port kernels {launched}")

        # the DC-AE latent of one image on the device against the CPU, fp32
        img = torch.as_tensor(first.images[:1])
        with torch.inference_mode():
            got = vae.encode_mode(u8_to_unit(img.to(device))).cpu()
            cpu_vae = copy.deepcopy(vae).to("cpu")
            ref = cpu_vae.encode_mode(u8_to_unit(img))
        del cpu_vae
        err = float((got - ref).abs().max())
        ok = bool(torch.isfinite(got).all()) and bool(
            ((got - ref).abs() <= 1e-4 + 1e-4 * ref.abs()).all())
        log(f"extract: DC-AE latent {tuple(got.shape)} of one {th}x{tw} "
            f"image, {device.type} vs CPU, fp32: max_abs_err {err:.3e} "
            f"(tol 1e-4 + 1e-4 * |ref|, the decoder's) "
            f"{'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail("the DC-AE encoder on the device disagrees with the CPU")
        if got.shape[-1] != lat_c:
            fail(f"latent channels {got.shape[-1]}, expected {lat_c}")
        if cuda:
            x8 = u8_to_unit(torch.as_tensor(first.images[:chunk]).to(device))
            caps = first.captions[:chunk]
            with torch.inference_mode():
                vae_ms = cuda_ms(lambda: vae.encode_mode(x8))
            max_len = trainer.sana_config.max_caption_len
            tok = load_tokenizer(None, vocab_size=gemma.cfg.vocab_size,
                                 max_length=max_len)
            ids, mask = slice_caption_rung(*tok(caps, max_length=max_len))
            ids, mask = (torch.as_tensor(a, device=device) for a in (ids,
                                                                     mask))
            with torch.inference_mode():
                te_ms = cuda_ms(lambda: gemma(ids, mask))
            log(f"encoders [{card}]: device ms per chunk of {chunk}: DC-AE "
                f"encoder {vae_ms:.2f} ms at {th}x{tw} (fp32), Gemma-2-2B "
                f"{te_ms:.2f} ms (bf16, {len(caps)} captions at rung "
                f"{ids.shape[1]})")
        # the extractor holds the encoders too (Gemma-2-2B, the DC-AE)
        del trainer, ex, vae, gemma, enc_i, enc_c
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

        # (c) phase 7's training on the shards (b) wrote
        cfg = train_config(shards[0], os.path.join(tmp, "out-c"),
                           local_shard_paths=shards, steps="3",
                           checkpoint_dir=None, **raw_train_keys(tiny))
        cfg = {k: v for k, v in cfg.items() if v is not None}
        with recorded_batches() as grids:
            trainer, counts, wall, peak = drive_entry_point(
                "train on extracted", sana_main, device, tmp, cfg)
        check_sana_run("train on extracted", trainer, cfg, counts, cuda,
                       grids)
        log_step_rate("train on extracted", trainer, wall, peak, card)
        del trainer
        gc.collect()

        # (d) configs/sana_512_lora.yaml encoding on the fly, 6 steps, then
        # a resume from step 3 through skip_batches
        cfg = otf_config(raw, os.path.join(tmp, "out-d"),
                         os.path.join(tmp, "ckpt-d"), chunk, batch, tiny)
        with counted_encoders() as calls, recorded_batches() as grids:
            trainer, counts, wall, peak = drive_entry_point(
                "on the fly", sana_main, device, tmp, cfg)
            check_sana_run("on the fly", trainer, cfg, counts, cuda, grids)
            log_step_rate("on the fly", trainer, wall, peak, card)
            log(f"on the fly: encoder calls {calls['images']} image chunks, "
                f"{calls['captions']} caption chunks (the cache encodes "
                "ahead of the steps)")
            out["raw_sana"] = counts
            del trainer
            gc.collect()
            os.remove(os.path.join(cfg["checkpoint_dir"], "6.pt"))
            before = calls["images"] + calls["captions"]
            del grids[:]
            cfg = dict(cfg, resume="true")
            trainer, counts, wall, peak = drive_entry_point(
                "on the fly resumed", sana_main, device, tmp, cfg)
            if calls["skipped"] != [3] or calls["in_skip"] != [0]:
                fail(f"resume: skipped {calls['skipped']} batches with "
                     f"{calls['in_skip']} encoder calls; expected [3] and "
                     "[0]")
            log(f"on the fly resumed: skip_batches skipped 3 batches with 0 "
                f"encoder calls; the run's encoder calls "
                f"{calls['images'] + calls['captions'] - before}")
            if [h["step"] for h in trainer.history] != [4, 5, 6]:
                fail(f"resume: steps {[h['step'] for h in trainer.history]}")
            check_sana_run("on the fly resumed", trainer, cfg, counts, cuda,
                           grids, steps=3)
        check_fp32_encodes("on the fly", calls, cuda)
        if cuda:
            # one step under the profiler while a cache's thread encodes the
            # next batches on the same device (the run's cache is stopped)
            gen = torch.Generator(device=device).manual_seed(5)
            cache = FeatureCache(trainer.sampler.sampler,
                                 cache_size=trainer.sampler.q.maxsize)
            it = iter(cache)
            next(it)

            def one_step():
                trainer._step_fn(trainer._device_batch(next(it)), gen)
            try:
                wall_ms, busy_ms = profile_run(
                    f"one on-the-fly step (batch {batch}, the cache "
                    "encoding behind it)", one_step, card)
            finally:
                cache.stop()
                # the cache holds the run's encoders (Gemma-2-2B, the
                # DC-AE) on the card: let them go before the next run
                del cache, it, one_step
            log(f"on the fly [{card}]: a profiled step {wall_ms:.1f} ms, "
                f"device busy {busy_ms:.1f} ms, idle share "
                f"{1 - busy_ms / wall_ms:.3f}")
            base = next((v for k, v in PROFILES.items()
                         if k.startswith("one train step")), None)
            if base is not None and "train" in IMAGES_PER_S:
                log(f"on the fly [{card}]: {IMAGES_PER_S['on the fly']:.2f} "
                    f"images/s, idle share {1 - busy_ms / wall_ms:.3f}; "
                    f"phase 7 on pre-extracted features "
                    f"{IMAGES_PER_S['train']:.2f} images/s, idle share "
                    f"{1 - base[1] / base[0]:.3f}")
        del trainer
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

        # (e) configs/pixart_repa.yaml: PixArt-Sigma XL-2, LoKr on an int8
        # base, REPA against a random DINOv2 ViT-B/14, encoding on the fly
        cfg = pixart_otf_config(raw, os.path.join(tmp, "out-e"), chunk,
                                tiny)
        if cuda:
            log(f"pixart_repa: {torch.cuda.memory_allocated() / 2**30:.2f} "
                "GiB allocated on the card before the run")
        with recorded_batches() as grids, counted_encoders() as calls, \
                recorded_repa_terms() as terms, initial_state():
            trainer, counts, wall, peak = drive_entry_point(
                "pixart_repa", pixart_main, device, tmp, cfg)
        check_fp32_encodes("pixart_repa", calls, cuda)
        check_pixart_run("pixart_repa", trainer, cfg, counts, cuda, grids)
        dino = trainer.encode_repa.module
        n_tok = dino.cfg.grid ** 2
        check_repa_terms("pixart_repa", terms, int(cfg["steps"]),
                         (int(cfg["batch_size"]), n_tok, dino.cfg.hidden_dim))
        check_trained_leaves("pixart_repa", trainer)
        proj = trainer.model.repa_projector
        moved = [k for k, v in proj.state_dict().items()
                 if not torch.equal(v, trainer.initial_projector[k])]
        log(f"pixart_repa: the projector after block "
            f"{trainer.pixart_config.repa_depth} "
            f"({'int8' if proj.fc1.qweight is not None else 'float'} "
            f"fc1/fc2/fc3) {'unchanged' if not moved else 'CHANGED'} by "
            "the steps")
        if moved:
            fail(f"pixart_repa: the frozen projector changed: {moved[:4]}")
        log_step_rate("pixart_repa", trainer, wall, peak, card)
        if cuda:
            px = torch.as_tensor(first.images[:int(cfg["batch_size"])])
            from yat_tpu_torch.models.dinov2 import preprocess_for_dino
            with torch.inference_mode():
                x = preprocess_for_dino(u8_to_unit(px.to(device)),
                                        size=dino.cfg.image_size)
                dino_ms = cuda_ms(lambda: dino(x))
            log(f"encoders [{card}]: DINOv2 ViT-B/14 (fp32, TF32 off) "
                f"{dino_ms:.2f} ms a batch of {x.shape[0]} at "
                f"{x.shape[1]}x{x.shape[2]} ({n_tok} tokens)")
        out["raw_pixart"] = counts
        del trainer, dino, proj
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

        # (g) SANA with generic REPA on blocks_{layers // 4}, on the fly
        cfg = otf_config(raw, os.path.join(tmp, "out-g"), None, chunk,
                         batch, tiny)
        cfg.update(steps="2", use_repa="true", checkpoint_dir=None,
                   repa_pretrained_model="/models/dinov2_vitb14.pth")
        cfg = {k: v for k, v in cfg.items() if v is not None}
        with recorded_batches() as grids, recorded_repa_terms() as terms:
            trainer, counts, wall, peak = drive_entry_point(
                "sana repa", sana_main, device, tmp, cfg)
        check_sana_run("sana repa", trainer, cfg, counts, cuda, grids)
        dino = trainer.encode_repa.module
        check_repa_terms("sana repa", terms, 2,
                         (batch, dino.cfg.grid ** 2, dino.cfg.hidden_dim))
        from yat_tpu_torch.ops.repa import init_repa_head
        head = trainer.repa_head
        init = init_repa_head(trainer.repa_config, head.fc1.in_features,
                              trainer.params.dataset_seed + 7, device)
        same = [n for (n, a), b in zip(head.named_parameters(),
                                       init.parameters())
                if torch.equal(a, b)]
        log(f"sana repa: target {list(trainer.repa_config.target_modules)}"
            f"; the head's leaves {'all changed' if not same else 'UNCHANGED: ' + str(same)}")
        if same:
            fail(f"sana repa: head leaves unchanged: {same}")
        log_step_rate("sana repa", trainer, wall, peak, card)
        out["raw_sana_repa"] = counts
        del trainer, dino, head, init
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

        # (f) Dreambooth: an instance folder and a regularization folder
        size = tuple(int(d * res / 512) for d in RAW_SOURCES[0])
        inst = write_image_folder(os.path.join(tmp, "inst"), batch, size, 1)
        reg = write_image_folder(os.path.join(tmp, "reg"), batch, size, 2,
                                 caption="a dog on a beach")
        flags = [b.is_regularization for _, b in zip(range(2), iter(
            DreamboothSampler(inst, reg, "sks", "dog", 1, batch, bins)))]
        if flags != [False, True]:
            fail(f"dreambooth: batches {flags}, expected instance then "
                 "regularization")
        cfg = train_config(raw[0], os.path.join(tmp, "out-f"),
                           local_shard_paths=None, steps="2",
                           checkpoint_dir=None,
                           dreambooth_dataset_folder=inst,
                           dreambooth_regularization_folder=reg,
                           dreambooth_instance="sks",
                           dreambooth_class="dog",
                           dreambooth_lambda="0.5",
                           batch_size=str(batch), **raw_train_keys(tiny))
        cfg = {k: v for k, v in cfg.items() if v is not None}
        with recorded_batches() as grids:
            trainer, counts, wall, peak = drive_entry_point(
                "dreambooth", sana_main, device, tmp, cfg)
        check_sana_run("dreambooth", trainer, cfg, counts, cuda, grids)
        log_step_rate("dreambooth", trainer, wall, peak, card)
        del trainer
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
    return out


def check_fp32_encodes(label, calls, cuda):
    """On the card, every image encode of the entry point's run saw TF32
    off for matmuls and convolutions (phase 12 turns it on before the
    runs, so the entry point turned it off)."""
    if not calls["images"]:
        fail(f"{label}: the image encoder never ran")
    if not cuda:
        return
    if calls["tf32"] != {(False, False)}:
        fail(f"{label}: TF32 (matmul, cuDNN) at the image encodes: "
             f"{sorted(calls['tf32'])}; the entry point must turn it off")
    log(f"{label}: TF32 off for matmuls and convolutions at each of "
        f"{calls['images']} image encodes (set by the entry point)")


def otf_config(raw, out_dir, ckpt, chunk, batch, tiny):
    """configs/sana_512_lora.yaml encoding raw shards on the fly
    (``compute_features`` with chunks of ``chunk``) without what needs
    files (pretrained weights), its validation prompts (their sampling
    would add denoiser launches to the steps') and the TPU mesh, for 6
    steps with the checkpoint cadence cut from 500 to 3."""
    return {"local_shard_paths": raw, "batch_size": str(batch),
            "learning_rate": "1e-4", "steps": "6", "warmup_steps": "200",
            "num_steps_per_validation": "3", "checkpoint_dir": ckpt,
            "validation_prompts": [], "bfloat16": "true", "use_ema": "true",
            "gradient_accumulation_steps": "1",
            "train_unconditional_prob": "0.1", "lora_rank": "8",
            "lora_alpha": "8", "lora_algo": "lora",
            "lora_target_modules": LORA_TARGETS,
            "caption_length_bucketing": "true", "output_dir": out_dir,
            "compute_features": "true", "vae_max_batch_size": str(chunk),
            "text_encoder_max_batch_size": str(chunk), "dataset_seed": "0",
            **raw_train_keys(tiny)}


def pixart_otf_config(raw, out_dir, chunk, tiny):
    """configs/pixart_repa.yaml as written, but for its files: the raw
    shards stand in for ``/data/raw``, the pretrained pipe is left out
    (T5-XXL, the KL-VAE and PixArt-Sigma XL-2 random from the seed) and its
    DINOv2 file ``/models/dinov2_vitb14.pth`` is missing (a random
    ViT-B/14 at full width, as the file's comment allows); 3 steps
    (validation every 1000, so its prompt builds the encoders and samples
    nothing).  LoKr rank 32, alpha 32 on to_q/to_k/to_v/to_out, the int8
    base, 8-bit Lion, REPA at lambda 0.05 after block 4, batch 8 in
    chunks of 8, encoding on the fly; PixArt-Sigma XL-2 at 8 of its 28
    blocks (``DEPTH_CUTS``).  ``tiny`` (the CPU rehearsal) taps block 0 and
    projects to the tiny DINOv2's 32-wide tokens."""
    extra = depth_cut("train")
    if tiny is not None:
        extra = {"model_config_overrides": dict(
                     tiny["pixart"], repa_depth="0", repa_target_dim="32"),
                 "aspect_ratio": str(tiny["resolution"])}
    return {"local_shard_paths": raw, "compute_features": "true",
            "vae_max_batch_size": str(chunk),
            "text_encoder_max_batch_size": str(chunk),
            "batch_size": str(tiny["batch"] if tiny else 8),
            "learning_rate": "2e-5", "steps": "3",
            "num_steps_per_validation": "1000",
            "validation_prompts": ["a cat wearing a tiny hat"],
            "bfloat16": "true", "use_repa": "true", "repa_lambda": "0.05",
            "repa_pretrained_model": "/models/dinov2_vitb14.pth",
            "lora_rank": "32", "lora_alpha": "32", "lora_algo": "lokr",
            "lora_target_modules": LORA_TARGETS,
            "lora_base_model_8bit": "true", "use_adamw_8bit": "true",
            "output_dir": out_dir, "dataset_seed": "0", **extra}


@contextlib.contextmanager
def recorded_repa_terms():
    """The DINO targets' shape and the alignment term of every REPA loss
    computed in the block (``(shape, term)``, the term a detached tensor
    read after the run)."""
    from yat_tpu_torch.train import tasks

    seen = []
    align = tasks.repa_alignment_loss

    def recording(proj, target):
        term = align(proj, target)
        seen.append((tuple(target.shape), term.detach()))
        return term
    tasks.repa_alignment_loss = recording
    try:
        yield seen
    finally:
        tasks.repa_alignment_loss = align


def check_repa_terms(label, seen, steps, shape):
    """One finite, nonzero REPA term a step, on DINO targets of
    ``shape``."""
    terms = [float(t) for _, t in seen]
    shapes = sorted({s for s, _ in seen})
    log(f"{label}: REPA targets {shapes}; alignment terms by step "
        f"{[round(t, 6) for t in terms]}")
    if len(seen) != steps or shapes != [shape] or not all(
            math.isfinite(t) and t > 0 for t in terms):
        fail(f"{label}: expected {steps} finite nonzero REPA terms on "
             f"targets {shape}, got {list(zip(shapes, terms))}")


def check_sana_run(label, trainer, cfg, counts, cuda, grids, steps=None):
    """Finite losses, the adapters and their export (``check_trained``)
    and the SANA kernels' launches: one forward and one backward a step, on
    the branches each step's latent grid and caption rung (``grids``)
    give."""
    steps = steps or int(cfg["steps"])
    cfg_model = trainer.sana_config
    if len(trainer.history) != steps or not all(
            math.isfinite(h["loss"]) for h in trainer.history):
        fail(f"{label}: expected {steps} finite losses, got "
             f"{trainer.history}")
    if steps == int(cfg["steps"]):
        check_trained(label, trainer, cfg, cfg_model.num_layers)
    else:
        for h in trainer.history:
            log(f"{label}: step {h['step']} caption rung "
                f"{h['caption_len']} loss {h['loss']:.6f} grad_norm "
                f"{h['grad_norm']:.4f}")
    if len(grids) != steps:
        fail(f"{label}: {len(grids)} batches moved for {steps} steps")
    want, how = {}, {}
    for grid, rung in grids:
        for k, n in sana_launches_at(cfg_model, grid, rung).items():
            want[k] = want.get(k, 0) + (n if cuda else 0)
            how.setdefault(k, []).append(n)
    check_launches(label, counts, want,
                   lambda k: " + ".join(map(str, how[k])) + " by step "
                   f"(grids {[g for g, _ in grids]})")


def check_pixart_run(label, trainer, cfg, counts, cuda, grids):
    """Finite losses and the PixArt-Sigma kernels' launches, by each step's
    latent grid and caption rung (``grids``)."""
    cfg_model = trainer.pixart_config
    steps = int(cfg["steps"])
    hist = trainer.history
    if len(hist) != steps or not all(math.isfinite(h["loss"])
                                     for h in hist) or len(grids) != steps:
        fail(f"{label}: expected {steps} finite losses, got {hist}")
    want = dict.fromkeys(PIXART_TRAIN_KERNELS, 0)
    for h, (grid, rung) in zip(hist, grids):
        tokens = (grid[0] // cfg_model.patch_size) * (
            grid[1] // cfg_model.patch_size)
        log(f"{label}: step {h['step']} latent grid {grid} caption rung "
            f"{rung} branches {pixart_branches(cfg_model, rung, tokens)} "
            f"loss {h['loss']:.6f} grad_norm {h['grad_norm']:.4f}")
        for name, n in pixart_step_launches(cfg_model, rung,
                                            tokens).items():
            want[name] += n if cuda else 0
    check_launches(label, counts, want,
                   lambda k: f"by step, at grids {[g for g, _ in grids]}")


# ---------------------------------------------------------------------------
# 13. the UNet families: SD1.5 and SDXL
# ---------------------------------------------------------------------------

# an attention branch → the counter of its forward kernel (the XLA branch
# counts its calls); the backward kernel's counter adds "_bwd"
UNET_BRANCH_KERNEL = {"native": "dot_product_attention",
                      "folded": "dot_product_attention_folded",
                      "flash": "flash_attention", "xla": "attention_xla"}
UNET_KERNELS = ("flash_attention", "flash_attention_bwd",
                "dot_product_attention_folded",
                "dot_product_attention_folded_bwd", "dot_product_attention",
                "dot_product_attention_bwd", "attention_xla",
                "adaln_layernorm", "adaln_layernorm_bwd", "linear_attention")


def unet_blocks(cfg):
    """The UNet's transformer blocks (one self- and one cross-attention
    each): the down levels' attention blocks, the mid block's, the up
    levels' (one more a level)."""
    lpb, t = cfg.layers_per_block, cfg.transformer_layers
    return (2 * lpb + 1) * sum(t) + max(1, t[-1])


def unet_launches(cfg, grid, n_ctx=77, passes=(1, 0)):
    """The kernel launches of ``passes`` = (forwards, backwards) of the
    UNet on a latent ``grid``: every attention on the branch the JAX gate
    gives its shape (``models.unet.attention_calls``,
    ``ops.attention.attention_branch``); every backward of an adapted
    attention launches its branch's backward kernel (the XLA branch none).
    """
    from yat_tpu_torch.models.unet import attention_calls
    from yat_tpu_torch.ops.attention import attention_branch

    fwd, bwd = passes
    out = dict.fromkeys(UNET_KERNELS, 0)
    for _, nq, nk, h, d in attention_calls(cfg, grid[0], grid[1], n_ctx):
        name = UNET_BRANCH_KERNEL[attention_branch(nq, nk, h, d)]
        out[name] += fwd
        if name != "attention_xla":
            out[name + "_bwd"] += bwd
    return out


def unet_branches(cfg, grid):
    """``{(kind, branch): calls}`` of one forward on ``grid``."""
    from yat_tpu_torch.models.unet import attention_calls
    from yat_tpu_torch.ops.attention import attention_branch
    out = {}
    for kind, nq, nk, h, d in attention_calls(cfg, grid[0], grid[1]):
        key = f"{kind}:{attention_branch(nq, nk, h, d)}"
        out[key] = out.get(key, 0) + 1
    return out


def check_unet_run(label, trainer, cfg, counts, cuda, grids, passes):
    """Finite losses, the adapters and their export (``check_trained``),
    and the attention kernels' launches of each step on the branches its
    latent grid gives, times the step's (forwards, backwards)."""
    model_cfg = trainer.unet_config
    check_trained(label, trainer, cfg, unet_blocks(model_cfg))
    steps = int(cfg["steps"])
    if len(grids) != steps:
        fail(f"{label}: {len(grids)} batches moved for {steps} steps")
    want = dict.fromkeys(UNET_KERNELS, 0)
    for grid, _ in grids:
        for k, n in unet_launches(model_cfg, grid, passes=passes).items():
            want[k] += n if cuda else 0
    log(f"{label}: branches by step: "
        f"{[(g, unet_branches(model_cfg, g)) for g, _ in grids]}")
    check_launches(label, counts, want,
                   lambda k: f"by step at grids {[g for g, _ in grids]}, "
                   f"{passes[0]} forwards and {passes[1]} backwards a step")


def train_unet_runs(label, main_fn, make_cfg, device, card, tmp, passes,
                    remat_passes=None):
    """Run an entry point's config as written (``make_cfg(out_dir,
    **keys)``), its launches checked by step (``passes``: forwards and
    backwards a step).  With ``remat_passes`` the same config follows with
    ``low_vram`` (the config's remat switch; the recomputed forwards
    counted in ``remat_passes``), which must fit, and only then may the
    run as written not fit: it says so with the peak.  Returns each run's
    launch counts by its label."""
    import gc

    import torch

    cuda = device.type == "cuda"
    out = {}
    runs = [(label, {}, passes)]
    if remat_passes is not None:
        runs.append((f"{label} low_vram", {"low_vram": "true"},
                     remat_passes))
    for run_label, keys, run_passes in runs:
        cfg = make_cfg(os.path.join(tmp, run_label.replace(" ", "_")),
                       **keys)
        try:
            with recorded_batches() as grids:
                trainer, counts, wall, peak = drive_entry_point(
                    run_label, main_fn, device, tmp, cfg)
        except torch.cuda.OutOfMemoryError as e:
            if keys or remat_passes is None:
                raise
            peak = torch.cuda.max_memory_allocated()
            log(f"{run_label} [{card}]: does not fit as configured: "
                f"{str(e).splitlines()[0]} (peak {peak / 2**30:.2f} GiB "
                "before the failed allocation)")
            TRAIN_PEAKS[run_label] = None
            gc.collect()
            torch.cuda.empty_cache()
            continue
        check_unet_run(run_label, trainer, cfg, counts, cuda, grids,
                       run_passes)
        log_step_rate(run_label, trainer, wall, peak, card)
        TRAIN_PEAKS[run_label] = peak
        out[run_label] = {k: counts[k] for k in UNET_KERNELS}
        del trainer
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
    return out


def sd15_train_config(raw, out_dir, **extra):
    """``configs/sd15_single_file_lora.yaml`` as written but for its files:
    the seeded raw shards for ``/data/raw``, no single file (the modules
    random from the seed), 6 steps."""
    import yaml
    with open(os.path.join(REPO, "configs", "sd15_single_file_lora.yaml")) \
            as f:
        cfg = yaml.safe_load(f)
    cfg.pop("pretrained_pipe_single_file")
    cfg.update({"local_shard_paths": list(raw), "steps": str(TRAIN_STEPS),
                "output_dir": out_dir, "dataset_seed": "0", **extra})
    return {k: (str(v) if isinstance(v, (int, float, bool)) else v)
            for k, v in cfg.items()}


def phase_sd15_train(device, card, tiny=None):
    """SD1.5 512 px LoRA training through ``frontends.sd15.main`` as
    ``configs/sd15_single_file_lora.yaml`` configures it but for its files:
    raw JPEGs at four buckets encoded on the fly by CLIP-L (captions
    compressed to 77 tokens) and the KL-VAE, batch 8, rank-8 LoRA, bf16,
    caption dropout 0.1, 6 steps; the steps/s, the peak memory, and the
    launches of each step by its latent grid (the non-square buckets'
    self-attentions at 4032 and 3872 tokens take the XLA branch, which
    recomputes its N x N scores in the backward).  The config must fit as
    written.  ``tiny``: the overrides of a rehearsal on the CPU."""
    from yat_tpu_torch.frontends.sd15 import main as sd15_main

    with tempfile.TemporaryDirectory() as tmp:
        raw, _ = write_raw_shards(tmp, 16 if tiny is None else 2,
                                  scale=1.0 if tiny is None else 0.4)
        extra = {} if tiny is None else {
            "batch_size": "2", "vae_max_batch_size": "2",
            "text_encoder_max_batch_size": "2", "aspect_ratio": "256",
            "steps": "2", "model_config_overrides": tiny}
        return train_unet_runs(
            "sd15 train", sd15_main,
            lambda out, **keys: sd15_train_config(raw, out, **extra, **keys),
            device, card, tmp, (1, 1))


def phase_sd15_grad_reference(device, cfg_over=None, side=64):
    """The full-width SD1.5 UNet (860M parameters, every level) with
    rank-8 LoRA on ``LORA_TARGETS`` (nonzero ``lora_b``) at a 64x64 latent
    (512 px) over a 77-token caption: one epsilon loss and every LoRA
    gradient through the kernels on the card (K6/K6b at head dims 40 and
    80, K4/K4b at 40, K2/K2b at 80) against the same step through the
    plain versions on the CPU, fp32: the loss within 1e-4 and the worst
    leaf's max|dg| within ``GRAD_REF_TOL`` of its largest entry."""
    import dataclasses

    import torch

    from yat_tpu_torch.adapters.builder import adapter_parameters
    from yat_tpu_torch.kernels.build import launch_counts, reset_launch_counts
    from yat_tpu_torch.models.unet import SD15_UNET, UNet2DCondition
    from yat_tpu_torch.ops.schedulers import DDPMSchedule
    from yat_tpu_torch.train.step import loss_and_grads
    from yat_tpu_torch.train.tasks import make_epsilon_loss

    cfg = dataclasses.replace(SD15_UNET, **(cfg_over or {}))
    t0 = time.perf_counter()
    cpu, gpu, n = lora_pair(UNet2DCondition, cfg, 8, device)
    rng = np.random.default_rng(0)
    lat = rng.standard_normal((1, side, side, cfg.in_channels), np.float32)
    emb = rng.standard_normal((1, 77, cfg.cross_attention_dim), np.float32)
    mask = np.ones((1, 77), np.int32)
    sched = DDPMSchedule()
    ts = sched.training_draw(torch.Generator().manual_seed(3), 1)
    noise = rng.standard_normal(lat.shape, np.float32)
    results = []
    for model, dev in ((gpu, device), (cpu, torch.device("cpu"))):
        t1 = time.perf_counter()
        batch = {"latents": torch.from_numpy(lat).to(dev),
                 "embeddings": torch.from_numpy(emb).to(dev),
                 "text_mask": torch.from_numpy(mask).to(dev)}
        draws = {"timesteps": ts.to(dev),
                 "noise": torch.from_numpy(noise).to(dev)}
        leaves = [p for _, p in adapter_parameters(model)]
        reset_launch_counts()
        loss, grads = loss_and_grads(make_epsilon_loss(model, sched), leaves,
                                     batch, torch.Generator(), draws)
        results.append((float(loss), [g.detach().cpu() for g in grads],
                        launch_counts(), time.perf_counter() - t1))
    (loss_g, grads_g, counts, sec_g), (loss_c, grads_c, _, sec_c) = results
    names = [name for name, _ in adapter_parameters(cpu)]
    loss_err = abs(loss_g - loss_c) / abs(loss_c)
    zero, rows, ok = [], [], loss_err <= 1e-4
    for name, gc, gg in zip(names, grads_c, grads_g):
        scale = float(gc.abs().max())
        rel = float((gg - gc).abs().max()) / scale
        rows.append((rel, name, scale))
        ok = ok and rel <= GRAD_REF_TOL and bool(torch.isfinite(gg).all())
        if not bool((gg != 0).any()):
            zero.append(name)
    for rel, name, scale in sorted(rows, reverse=True)[:3]:
        log(f"sd15 grad reference:   {name}: max|g| {scale:.3e}; "
            f"max|dg|/max|g| {rel:.2e}")
    want = unet_launches(cfg, (side, side), passes=(1, 1))
    if device.type != "cuda":
        want = {k: 0 for k in want}
    log(f"sd15 grad reference: the SD1.5 UNet {cfg.block_out_channels} with "
        f"LoRA on {n} modules ({len(names)} leaves) at {side}x{side}, "
        f"{device.type} ({sec_g:.1f} s) vs CPU ({sec_c:.1f} s), fp32: loss "
        f"{loss_g:.6f} vs {loss_c:.6f} (rel {loss_err:.2e}, tol 1e-4); "
        f"worst leaf max|dg|/max|g| {max(r[0] for r in rows):.2e} (tol "
        f"{GRAD_REF_TOL:g}); zero gradients: {len(zero)}; launches "
        f"{ {k: counts[k] for k in want if want[k] or counts[k]} }; "
        f"{time.perf_counter() - t0:.1f} s in all")
    if zero:
        fail(f"sd15: LoRA leaves with no gradient: {zero[:4]}")
    if not ok:
        fail("sd15: LoRA gradients on the card disagree with the CPU")
    if any(counts[k] != v for k, v in want.items()):
        fail(f"sd15 grad reference: launches {counts}, expected {want}")


def phase_single_file(device, card, cfg_over=None):
    """A synthesized CompVis SD1.5 single file (fp16; the published LDM
    keys of the UNet, the KL-VAE and CLIP-L), its UNet loaded through
    ``load_pretrained_backbone`` (via ``build_backbone``, the loader's
    coverage rules: no orphan, no missing leaf): every parameter on the
    card equal to its synthesized value, and the seconds from file to
    card.  The single file carries no tokenizer (``load_tokenizer``
    raises without a pipe directory), so the pipeline is not built."""
    import dataclasses

    import torch

    from yat_tpu_torch.config import TrainingParameters
    from yat_tpu_torch.convert import flax_params
    from yat_tpu_torch.frontends.common import build_backbone
    from yat_tpu_torch.models.text_encoders import CLIP_L_14, \
        CLIP_TINY_TEST, CLIPTextModel
    from yat_tpu_torch.models.unet import SD15_UNET, UNet2DCondition
    from yat_tpu_torch.models.vae import KLVAE_SD15, KLVAE_TINY_TEST, \
        AutoencoderKL

    S = synth_module()
    tiny = cfg_over is not None
    cfg = dataclasses.replace(SD15_UNET, **(cfg_over or {}))
    with torch.device("meta"):
        shapes = [S.leaf_shapes(flax_params(m())) for m in (
            lambda: UNet2DCondition(cfg),
            lambda: AutoencoderKL(KLVAE_TINY_TEST if tiny else KLVAE_SD15),
            lambda: CLIPTextModel(CLIP_TINY_TEST if tiny else CLIP_L_14))]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "v1-5-synth.safetensors")
        t0 = time.perf_counter()
        wrote = S.write_compvis_single_file(path, shapes[0], cfg, SYNTH_SEED,
                                            "F16", shapes[1], shapes[2])
        log(f"single file: wrote {wrote['tensors']} tensors, "
            f"{wrote['bytes'] / 2**30:.2f} GiB (F16) in "
            f"{time.perf_counter() - t0:.1f} s")
        params = TrainingParameters.from_dict({
            "batch_size": "1", "learning_rate": "1e-4", "steps": "1",
            "num_steps_per_validation": "1", "bfloat16": "true",
            "pretrained_pipe_single_file": path})
        t0 = time.perf_counter()
        model = build_backbone(
            lambda: UNet2DCondition(cfg, dtype=torch.bfloat16), params,
            "sd15", cfg, device, dtype=torch.bfloat16)
        sec = time.perf_counter() - t0
    check_loaded("single file", model,
                 S.unet_rules(len(cfg.block_out_channels), conv_proj=True),
                 grid="F16")
    n = sum(p.numel() for p in model.parameters())
    log(f"single file [{card}]: the SD1.5 UNet ({n / 1e6:.1f}M parameters) "
        f"from the CompVis file to {device.type} in {sec:.1f} s "
        f"(load_seconds {model.load_seconds:.1f} s); every parameter as "
        "synthesized")


def sdxl_dreambooth_config(inst, reg, out_dir, **extra):
    """``configs/sdxl_dreambooth.yaml`` as written but for its files: the
    seeded instance and regularization folders, no pretrained pipe (the
    modules random from the seed), 3 steps."""
    import yaml
    with open(os.path.join(REPO, "configs", "sdxl_dreambooth.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg.pop("pretrained_pipe_path")
    cfg.update({"dreambooth_dataset_folder": inst,
                "dreambooth_regularization_folder": reg, "steps": "3",
                "output_dir": out_dir, "dataset_seed": "0", **extra})
    return {k: (str(v) if isinstance(v, (int, float, bool)) else v)
            for k, v in cfg.items()}


def phase_sdxl_train(device, card, tiny=None):
    """SDXL 1024 px Dreambooth LoRA through ``frontends.sdxl.main`` as
    ``configs/sdxl_dreambooth.yaml`` configures it but for its files:
    seeded instance and class folders, batch 4, rank-16 LoRA, preservation
    at 0.3 (3 forwards, 2 backwards a step), CLIP-L + OpenCLIP-G and the
    KL-VAE encoding on the fly, 3 steps: the peak memory (a run that does
    not fit says so with the number), then the same with ``low_vram`` (the
    config's remat switch; every spatial transformer and resnet
    recomputed, 5 forwards a step), each with its launches by step; then a
    short extraction pass writing ``pooled.npy`` (``[1280]``) beside each
    sample."""
    from yat_tpu_torch.frontends.sdxl import main as sdxl_main

    with tempfile.TemporaryDirectory() as tmp:
        size = (1024, 1024) if tiny is None else (256, 256)
        inst = write_image_folder(os.path.join(tmp, "instance"), 4, size, 1)
        reg = write_image_folder(os.path.join(tmp, "reg"), 8, size, 2)
        # a rehearsal takes one step of each run (no warmup to check)
        extra = {} if tiny is None else {
            "batch_size": "2", "vae_max_batch_size": "2",
            "text_encoder_max_batch_size": "2", "aspect_ratio": "256",
            "steps": "1", "model_config_overrides": tiny}
        out = train_unet_runs(
            "sdxl train", sdxl_main,
            lambda o, **keys: sdxl_dreambooth_config(inst, reg, o, **extra,
                                                     **keys),
            device, card, tmp, (3, 2), (5, 2))
        phase_sdxl_extract(device, card, tmp, tiny)
    return out


def phase_sdxl_extract(device, card, tmp, tiny=None):
    """SDXL's extraction pass through ``frontends.sdxl.main``
    (``extract_features``) on 16 seeded JPEGs at four 1024 px buckets,
    batch 4: each sample's
    ``pooled.npy`` holds OpenCLIP-G's projected pooled vector, as wide as
    the UNet's ``addition_embed_dim`` (``[1280]``), finite, beside its
    latent and its ``[77, 2048]`` caption states."""
    import io
    import tarfile

    from yat_tpu_torch.frontends.sdxl import main as sdxl_main

    batch = "4" if tiny is None else "2"
    raw, _ = write_raw_shards(tmp, int(batch), shards=1, seed=5,
                              scale=1.6 if tiny is None else 0.4)
    feats = os.path.join(tmp, "features")
    cfg = {"local_shard_paths": raw, "batch_size": batch,
           "vae_max_batch_size": batch, "text_encoder_max_batch_size": batch,
           "extract_features": "true", "learning_rate": "1e-4",
           "steps": "1", "num_steps_per_validation": "1",
           "bfloat16": "true", "aspect_ratio": "1024",
           "r2_dataset_folder": feats, "dataset_seed": "0"}
    if tiny is not None:
        cfg.update(aspect_ratio="256", model_config_overrides=tiny)
    # CLIP's 77 positions (the tiny test CLIP's 16)
    n_tok = 77 if tiny is None else 16
    t0 = time.perf_counter()
    trainer, _, wall, peak = drive_entry_point("sdxl extract", sdxl_main,
                                               device, tmp, cfg)
    pooled_dim = trainer.unet_config.addition_embed_dim
    n = 0
    for name in sorted(os.listdir(feats)):
        with tarfile.open(os.path.join(feats, name)) as tf:
            members = {m.name: m for m in tf.getmembers()}
            for key in {m.split(".")[0] for m in members}:
                pooled, emb = (np.load(io.BytesIO(tf.extractfile(
                    members[f"{key}.{f}.npy"]).read())) for f in ("pooled",
                                                                  "emb"))
                if pooled.shape != (pooled_dim,) or not np.isfinite(
                        pooled).all():
                    fail(f"sdxl extract: {key} pooled {pooled.shape}")
                if emb.shape[0] != n_tok or not np.isfinite(emb).all():
                    fail(f"sdxl extract: {key} caption states {emb.shape}")
                n += 1
    if n != trainer.extraction.written or n == 0:
        fail(f"sdxl extract: {n} samples with pooled.npy, "
             f"{trainer.extraction.written} written")
    log(f"sdxl extract [{card}]: {n} samples with pooled.npy "
        f"[{pooled_dim}] and caption states [{n_tok}, {emb.shape[1]}] in "
        f"{wall:.1f} s ({trainer.extraction.images_per_sec:.2f} images/s); "
        f"peak device memory {peak / 2**30:.2f} GiB; "
        f"{time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# 14. SD3.5 (MMDiT)
# ---------------------------------------------------------------------------

SD35_KERNELS = ("flash_attention", "flash_attention_bwd", "adaln_layernorm",
                "adaln_layernorm_bwd", "attention_xla")
SD35_TRAIN_STEPS = 4


def sd35_launches(cfg, grid, passes, remat=False):
    """The launches of ``passes`` = (forwards, backwards) of the MMDiT on a
    latent ``grid`` with ``max_caption_len`` caption tokens
    (``models.mmdit.kernel_calls``): K6 and K1 once a forward, K6b and K1b
    once a backward; under ``remat`` each block runs its forward again in
    the backward (every attention, every norm but the final one); the XLA
    branch never."""
    from yat_tpu_torch.models.mmdit import kernel_calls
    calls = kernel_calls(cfg, grid[0], grid[1], cfg.max_caption_len)
    n_attn = len(calls["flash_attention"])
    n_norm = len(calls["adaln_layernorm"])
    fwd, bwd = passes
    again = bwd if remat else 0
    return {"flash_attention": n_attn * (fwd + again),
            "adaln_layernorm": n_norm * fwd + (n_norm - 1) * again,
            "flash_attention_bwd": n_attn * bwd,
            "adaln_layernorm_bwd": n_norm * bwd, "attention_xla": 0}


def sd35_adapted(cfg):
    """The MMDiT's projections that ``[to_q, to_k, to_v, to_out]`` adapt:
    both streams' q/k/v/out (the last block has no text output) and each
    MMDiT-X block's second attention."""
    n = cfg.num_layers
    dual = sum(i < n for i in cfg.dual_attention_layers)
    return 8 * n - 1 + 4 * dual


@contextlib.contextmanager
def drawn_modulation():
    """The modulation layers of the MMDiT and of Flux drawn from the seed
    like their other dense layers (lecun-normal) inside the block, where
    flax's ``zeros_init`` (the JAX package's, and the port's) leaves every
    gate at 0: on random weights every block would then add nothing to
    the image or to the adapters' gradients."""
    from yat_tpu_torch.models import layers
    zero = layers.ZeroDense.reset_parameters
    layers.ZeroDense.reset_parameters = layers.AdapterDense.reset_parameters
    try:
        yield
    finally:
        layers.ZeroDense.reset_parameters = zero


def phase_sd35_serve(device, card, params=None, px=1024, window_ms=100.0):
    """SD3.5-medium served at 1024 px through HTTP (``phase_serve``):
    CLIP-L, OpenCLIP-G and T5-XXL in fp32, the MMDiT in bf16 cut to 4
    blocks (``DEPTH_CUTS``), the fp32 16-channel KL-VAE; 20 Euler steps
    at shift 3.0, CFG 5.0; the modulation drawn (``drawn_modulation``)."""
    with drawn_modulation():
        return phase_serve(params or serve_params(
            model_config_overrides=dict(DEPTH_CUTS["sd35"])), device, card,
                           family="sd35", px=px,
                           profile=device.type == "cuda",
                           window_ms=window_ms)


def write_sd35_shard(path, n, side, cfg, seed=0):
    """``n`` SD3.5 feature samples: ratio "1.0", latents ``[side, side,
    in_channels]`` fp32, the joined CLIP/T5 states ``[77 + L, caption_dim]``
    fp32 with L spread over 64-256 T5 tokens (cut to ``max_caption_len``),
    ``pooled.npy`` ``[pooled_dim]``."""
    from yat_tpu_torch.data.tar import TarShardWriter
    rng = np.random.default_rng(seed)
    lengths = rng.permutation(np.linspace(64, 256, n).round().astype(int))
    with TarShardWriter(path) as w:
        for i, t5 in enumerate(lengths):
            w.write({"__key__": f"{i:06d}", "ratio": "1.0",
                     "latent.npy": rng.standard_normal(
                         (side, side, cfg.in_channels), dtype=np.float32),
                     "emb.npy": rng.standard_normal(
                         (min(77 + int(t5), cfg.max_caption_len),
                          cfg.caption_dim), dtype=np.float32),
                     "pooled.npy": rng.standard_normal(
                         (cfg.pooled_dim,), dtype=np.float32)})


def sd35_train_config(shard, out_dir, ckpt, **extra):
    """``configs/sd35_flow_lokr.yaml`` as written but for its files and
    its mesh: the seeded shard for ``/data/sd35_features``, no pretrained
    pipe (the modules random from the seed), no ``mesh_shape`` (the port
    trains on one card), ``checkpoint_dir`` in a temporary directory,
    ``SD35_TRAIN_STEPS`` steps with validation (and a checkpoint) at the
    last."""
    import yaml
    with open(os.path.join(REPO, "configs", "sd35_flow_lokr.yaml")) as f:
        cfg = yaml.safe_load(f)
    for key in ("pretrained_pipe_path", "mesh_shape"):
        cfg.pop(key)
    cfg.update({"local_shard_paths": [shard], "checkpoint_dir": ckpt,
                "steps": str(SD35_TRAIN_STEPS),
                "num_steps_per_validation": str(SD35_TRAIN_STEPS),
                "output_dir": out_dir, "dataset_seed": "0", **extra})
    return {k: (str(v) if isinstance(v, (int, float, bool)) else v)
            for k, v in cfg.items()}


def sd35_batch(trainer, device, side):
    """A seeded SD3.5 training batch (the longest caption, pooled text)
    and one set of draws, with their generator."""
    import torch
    cfg = trainer.mmdit_config
    gen = torch.Generator(device=device).manual_seed(5)
    b = trainer.params.batch_size
    lat_dtype = torch.bfloat16 if trainer.params.bfloat16 else torch.float32
    batch = {"latents": torch.randn((b, side, side, cfg.in_channels),
                                    generator=gen, device=device
                                    ).to(lat_dtype),
             "embeddings": torch.randn((b, cfg.max_caption_len,
                                        cfg.caption_dim), generator=gen,
                                       device=device),
             "text_mask": torch.ones((b, cfg.max_caption_len),
                                     dtype=torch.int32, device=device),
             "pooled_text": torch.randn((b, cfg.pooled_dim), generator=gen,
                                        device=device)}
    ts, sig = trainer.schedule.training_draw(gen, b)
    draws = {"timesteps": ts, "sigmas": sig,
             "noise": torch.randn(batch["latents"].shape, generator=gen,
                                  device=device)}
    return gen, batch, draws


def phase_sd35_train(device, card, tiny=None):
    """``configs/sd35_flow_lokr.yaml`` through ``frontends.sd35.main`` as
    written but for its files and mesh (``sd35_train_config``): SD3.5-
    medium cut to 4 blocks (``DEPTH_CUTS``) at 1024 px, batch 8,
    LoKr rank 16 on to_q/to_k/to_v/to_out,
    EMA, ``low_vram`` (each block recomputed in the backward; T5-XXL,
    the CLIPs and the VAE on the host between validation calls; the tiled
    decode), the modulation drawn (``drawn_modulation``), on a seeded
    feature shard at SD3.5's shapes: finite losses, every LoKr leaf
    changed and exported, the validation image at the last step, the
    launches by step (K6 37 and K1 48 a forward at full depth, 6 and 8
    at 4 blocks, each block's again in the backward, K6b and K1b once a
    backward; the validation's 20 CFG calls), the step time (mean and median), the peak (the run as written
    fits or fails) and one profiled step."""
    import torch

    from yat_tpu_torch.config import TrainingParameters
    from yat_tpu_torch.frontends.sd35 import build_config
    from yat_tpu_torch.frontends.sd35 import main as sd35_main
    from yat_tpu_torch.train.validation import ValidationPipeline

    label = "sd35 train"
    cuda = device.type == "cuda"
    with tempfile.TemporaryDirectory() as tmp:
        shard = os.path.join(tmp, "sd35-000000.tar")
        extra = {"model_config_overrides": dict(DEPTH_CUTS["sd35"])} \
            if tiny is None else {"batch_size": "2", "aspect_ratio": "256",
                                  "model_config_overrides": tiny}
        cfg = sd35_train_config(shard, os.path.join(tmp, "out"),
                                os.path.join(tmp, "ckpt"), **extra)
        params = TrainingParameters.from_dict(cfg)
        model_cfg = build_config(params)
        side = (params.aspect_ratios or 1024) // 8
        t0 = time.perf_counter()
        write_sd35_shard(shard, 5 * params.batch_size, side, model_cfg)
        log(f"{label}: wrote a {os.path.getsize(shard) / 1e6:.1f} MB "
            f"feature shard in {time.perf_counter() - t0:.1f} s")
        images = []
        validate = ValidationPipeline.validate

        def recording(self, trainer, x0=None):
            out = validate(self, trainer, x0)
            images.append(out)
            return out
        ValidationPipeline.validate = recording
        try:
            with drawn_modulation(), initial_state(), \
                    recorded_batches() as grids:
                trainer, counts, wall, peak = drive_entry_point(
                    label, sd35_main, device, tmp, cfg)
        finally:
            ValidationPipeline.validate = validate
        model_cfg = trainer.mmdit_config
        # the last block's text queries: their rows of the joint
        # attention feed only the dropped text output, so no gradient
        # reaches its c_to_q (in the JAX package too)
        check_trained(label, trainer, cfg, None, sd35_adapted(model_cfg),
                      dead=(f"blocks_{model_cfg.num_layers - 1}.c_to_q",))
        steps = int(cfg["steps"])
        if len(grids) != steps or len(images) != 1:
            fail(f"{label}: {len(grids)} batches for {steps} steps, "
                 f"{len(images)} validations (expected 1)")
        px = side * trainer.decode_latents.module.cfg.compression
        for tag, img in images[0].items():
            if img.shape != (px, px, 3) or not np.isfinite(img).all():
                fail(f"{label}: validation image {tag} {img.shape} not "
                     f"finite / not {px}x{px}x3")
        want = dict.fromkeys(SD35_KERNELS, 0)
        vp = trainer.validation_pipeline
        runs = [(g, (1, 1), True) for g, _ in grids] + [
            (vp.latent_shape[:2], (1, 0), False)] * vp.num_steps
        for grid, passes, remat in runs:
            for k, n in sd35_launches(model_cfg, grid, passes,
                                      remat).items():
                want[k] += n if cuda else 0
        check_launches(label, counts, want,
                       lambda k: f"{steps} steps at grids "
                       f"{sorted(set(g for g, _ in grids))} with remat and "
                       f"{vp.num_steps} validation CFG calls")
        log_step_rate(label, trainer, wall, peak, card)
        TRAIN_PEAKS[label] = peak
        if cuda:
            total = torch.cuda.get_device_properties(0).total_memory
            log(f"{label} [{card}]: as written (batch {params.batch_size}, "
                f"low_vram) the run fits: peak {peak / 2**30:.2f} GiB of "
                f"the card's {total / 2**30:.2f} GiB")
        if cuda:
            gen, batch, draws = sd35_batch(trainer, device, side)
            profile_run(f"one {label} step",
                        lambda: trainer._step_fn(batch, gen, draws), card)
        out = {k: counts[k] for k in SD35_KERNELS}
        del trainer
    return out


# ---------------------------------------------------------------------------
# 15. Flux-2 Klein
# ---------------------------------------------------------------------------

FLUX_KERNELS = SD35_KERNELS
FLUX_TRAIN_STEPS = 3
# the width of the caption encoder the config pairs with (Gemma-2-2B), where
# the preset holds 4096: the JAX package fails on the config as written
FLUX_OVERRIDES = {"text_dim": "2304"}
# the overrides of the Flux phases: the caption width and the depth cut
FLUX_PHASE_OVERRIDES = {**FLUX_OVERRIDES, **DEPTH_CUTS["flux"]}


def flux_launches(cfg, grid, n_txt, passes):
    """The launches of ``passes`` = (forwards, backwards) of the Flux
    transformer, without remat, on a token ``grid`` with ``n_txt`` caption
    tokens (``models.flux.kernel_calls``): K6 and K1 once a forward, K6b
    once a backward, K1b once a backward but for double block 0's two
    first norms, whose inputs are all frozen under adapters (the embedders
    and the modulation are no targets); the XLA branch never."""
    from yat_tpu_torch.models.flux import kernel_calls
    calls = kernel_calls(cfg, grid[0], grid[1], n_txt)
    n_attn = len(calls["flash_attention"])
    n_norm = len(calls["adaln_layernorm"])
    fwd, bwd = passes
    return {"flash_attention": n_attn * fwd,
            "adaln_layernorm": n_norm * fwd,
            "flash_attention_bwd": n_attn * bwd,
            "adaln_layernorm_bwd": (n_norm - 2) * bwd, "attention_xla": 0}


def flux_adapted(cfg):
    """The projections ``[to_q, to_k, to_v, to_out]`` adapt: both streams'
    q/k/v/out in every double block; the single blocks' fused ``linear1``
    and ``linear2`` match no target (in both packages)."""
    return 8 * cfg.num_double_blocks


def phase_flux_serve(device, card, params=None, px=1024, window_ms=100.0):
    """Flux-2 Klein served at 1024 px through HTTP (``phase_serve``):
    Gemma-2-2B and the 16-channel KL-VAE in fp32, the transformer in bf16
    (``text_dim`` 2304, Gemma-2-2B's width); 20 Euler steps with the
    dynamic shift, CFG 7.0 and the guidance embedding at 7.0, 4096 + 512
    tokens; the modulation drawn (``drawn_modulation``)."""
    with drawn_modulation():
        return phase_serve(
            params or serve_params(model_config_overrides=dict(
                FLUX_PHASE_OVERRIDES)), device, card, family="flux", px=px,
            profile=device.type == "cuda", window_ms=window_ms)


def flux_train_config(s3_url, out_dir, **extra):
    """``configs/flux_klein_lora.yaml`` as written but for its files, its
    mesh and ``text_dim``: the stand-in S3 endpoint for its R2 account's
    (the config's keys, bucket and shard names kept), no pretrained pipe
    (the modules random from the seed), no ``mesh_shape`` (the port trains
    on one card), ``text_dim`` 2304 (``FLUX_OVERRIDES``) and the depth
    cut (``DEPTH_CUTS``),
    ``FLUX_TRAIN_STEPS`` steps with validation at the last."""
    import yaml
    with open(os.path.join(REPO, "configs", "flux_klein_lora.yaml")) as f:
        cfg = yaml.safe_load(f)
    for key in ("pretrained_pipe_path", "mesh_shape"):
        cfg.pop(key)
    cfg.update({"r2_endpoint": s3_url, "steps": str(FLUX_TRAIN_STEPS),
                "num_steps_per_validation": str(FLUX_TRAIN_STEPS),
                "model_config_overrides": dict(FLUX_PHASE_OVERRIDES),
                "output_dir": out_dir, "dataset_seed": "0", **extra})
    return {k: (str(v) if isinstance(v, (int, float, bool)) else v)
            for k, v in cfg.items()}


def encode_and_step(label, trainer, device, card, run_peak):
    """One training step with its batch's encode in front of it, as the
    run does both on one device (the feature cache's thread encodes the
    next batches while a step runs): a batch of seeded images at the
    square bucket (the run's largest token grid) and their captions
    through the run's on-the-fly encoder (Flux: Gemma-2-2B and the KL-VAE
    encoder in fp32; PixelDiT: Gemma-2-2B, the identity and DINOv2), then
    the step.  Each part is timed
    alone (the host synchronised) and, on the card, profiled alone, so the
    step time the run reports splits into the encode and the denoiser
    step.  On the card each part's memory above what the run keeps
    resident is read too: resident + encode + step is the most the run
    can hold when the cache's encode meets a step's peak, whatever the
    thread's timing (the reason the run's peak moves between runs whose
    batches and losses are the same)."""
    import torch

    from yat_tpu_torch.data.sampler import Batch
    from yat_tpu_torch.train.encode import OnTheFlyEncodingSampler

    cuda = device.type == "cuda"
    enc = getattr(trainer.sampler, "sampler", trainer.sampler)
    if not isinstance(enc, OnTheFlyEncodingSampler):
        fail(f"{label}: the run's sampler {type(enc).__name__} does not "
             "encode on the fly")
    key = "1.0"
    h, w = (int(d) for d in enc.image_sampler.aspect_ratios[key])
    b = trainer.params.batch_size
    rng = np.random.default_rng(5)
    raw = Batch(ratio=key, captions=[f"a photograph of object {i} on a "
                                     "wooden table" for i in range(b)],
                images=rng.integers(0, 256, (b, h, w, 3), np.uint8))
    gen = torch.Generator(device=device).manual_seed(5)
    held = {}

    def encode():
        held["encoded"] = enc._encode_batch(raw)

    def step():
        trainer._step_fn(trainer._device_batch(held.pop("encoded")), gen)

    ms, extra = {}, {}
    if cuda:
        torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated() if cuda else 0
    for part, fn in (("encode", encode), ("denoiser step", step)):
        if cuda:
            torch.cuda.reset_peak_memory_stats()
            ms[part] = profile_run(
                f"one {label} step's {part} ({b} images at {h}x{w})", fn,
                card)[0]
            extra[part] = torch.cuda.max_memory_allocated() - resident
        else:
            t0 = time.perf_counter()
            fn()
            ms[part] = (time.perf_counter() - t0) * 1e3
    log(f"{label} [{card}]: one step's encode {ms['encode']:.1f} ms and "
        f"denoiser step {ms['denoiser step']:.1f} ms at {h}x{w}"
        f"{' (profiler on)' if cuda else ''}, "
        f"{sum(ms.values()):.1f} ms together")
    if cuda:
        total = torch.cuda.get_device_properties(0).total_memory
        worst = resident + sum(extra.values())
        log(f"{label} [{card}]: resident {resident / 2**30:.2f} GiB, the "
            f"encode {extra['encode'] / 2**30:.2f} GiB above it, the step "
            f"{extra['denoiser step'] / 2**30:.2f} GiB; both at once "
            f"{worst / 2**30:.2f} GiB of the card's {total / 2**30:.2f} GiB "
            f"(the run's peak {run_peak / 2**30:.2f} GiB)")
    return ms


def phase_flux_train(device, card, tiny=None):
    """``configs/flux_klein_lora.yaml`` through ``frontends.flux.main`` as
    written but for its files, mesh and ``text_dim``
    (``flux_train_config``): Flux-2 Klein at 1024 px, batch 4, LoRA rank
    16 / alpha 16 on to_q/to_k/to_v/to_out (32 projections at the depth
    cut, ``DEPTH_CUTS``), bf16, no
    remat, raw JPEGs at four 1024 px buckets in the config's two R2
    shards, fetched through presigned GETs from a stand-in S3 endpoint on
    127.0.0.1 and encoded on the fly (Gemma-2-2B and the KL-VAE in fp32),
    the modulation drawn (``drawn_modulation``), ``FLUX_TRAIN_STEPS`` steps
    with validation at the last: finite losses, every LoRA leaf changed and
    exported, the validation image, the launches by step (6 K6, 13 K1, 6
    K6b and 11 K1b a step at the cut; 6 K6 and 13 K1 for each of the
    validation's 20 CFG calls), the step time and the peak; then one step split into its
    encode and its denoiser step (``encode_and_step``).  A run that
    does not fit in the card's memory fails the phase."""
    import gc

    import torch

    from yat_tpu_torch.frontends.flux import main as flux_main
    from yat_tpu_torch.train.validation import ValidationPipeline

    label = "flux train"
    cuda = device.type == "cuda"
    with tempfile.TemporaryDirectory() as tmp:
        written = flux_train_config("", "")
        keys = (written["r2_access_key"], written["r2_secret_key"],
                written["r2_bucket_name"])
        names = written["r2_tar_files"]
        t0 = time.perf_counter()
        raw, sizes = write_raw_shards(tmp, 4 if tiny is None else 2,
                                      scale=2.0 if tiny is None else 0.5,
                                      shards=len(names))
        root = os.path.join(tmp, "s3")
        os.makedirs(root)
        for path, name in zip(raw, names):
            os.replace(path, os.path.join(root, name))
        log(f"{label}: wrote {len(sizes)} JPEGs at sources "
            f"{sorted(set(sizes))} into the config's shards {names} "
            f"({sum(os.path.getsize(os.path.join(root, n)) for n in names) / 1e6:.1f}"
            f" MB) in {time.perf_counter() - t0:.1f} s")
        extra = {} if tiny is None else {
            "batch_size": "2", "vae_max_batch_size": "2",
            "text_encoder_max_batch_size": "2", "aspect_ratio": "256",
            "model_config_overrides": tiny}
        images = []
        validate = ValidationPipeline.validate

        def recording(self, trainer, x0=None):
            got = validate(self, trainer, x0)
            images.append(got)
            return got
        ValidationPipeline.validate = recording
        try:
            with StandInS3(root, *keys) as s3, working_dir(tmp), \
                    drawn_modulation(), initial_state():
                cfg = flux_train_config(s3.url, os.path.join(tmp, "out"),
                                        **extra)
                with recorded_batches() as grids:
                    trainer, counts, wall, peak = drive_entry_point(
                        label, flux_main, device, tmp, cfg)
                out = {label: check_flux_run(label, trainer, cfg, counts,
                                             cuda, grids, images, s3, names,
                                             wall, peak, card)}
                encode_and_step(label, trainer, device, card, peak)
        finally:
            ValidationPipeline.validate = validate
        del trainer
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
    return out


def check_flux_run(label, trainer, cfg, counts, cuda, grids, images, s3,
                   names, wall, peak, card):
    """The checks of one Flux training run (``phase_flux_train``)."""
    import torch

    model_cfg = trainer.flux_config
    check_trained(label, trainer, cfg, None, flux_adapted(model_cfg))
    steps = int(cfg["steps"])
    if len(grids) != steps or len(images) != 1:
        fail(f"{label}: {len(grids)} batches for {steps} steps, "
             f"{len(images)} validations (expected 1)")
    fetched = sorted({k for k, _ in s3.served})
    if s3.rejected or not fetched or not set(fetched) <= set(names):
        fail(f"{label}: the stand-in endpoint served {fetched} of {names} "
             f"and rejected {s3.rejected} requests")
    log(f"{label}: {len(s3.served)} signed GETs of the shards {fetched}, "
        "none rejected")
    vp = trainer.validation_pipeline
    px = vp.grid_hw[0] * 2 * trainer.decode_latents.module.cfg.compression
    for tag, img in images[0].items():
        if img.shape != (px, px, 3) or not np.isfinite(img).all():
            fail(f"{label}: validation image {tag} {img.shape} not "
                 f"finite / not {px}x{px}x3")
    from yat_tpu_torch.frontends.flux import FLUX_CAPTION_LEN
    want = dict.fromkeys(FLUX_KERNELS, 0)
    runs = [((h // 2, w // 2), rung, (1, 1)) for (h, w), rung in grids]
    runs += [(vp.grid_hw, FLUX_CAPTION_LEN, (1, 0))] * vp.num_steps
    for grid, rung, passes in runs:
        for k, n in flux_launches(model_cfg, grid, rung, passes).items():
            want[k] += n if cuda else 0
    check_launches(label, counts, want,
                   lambda k: f"{steps} steps at latent grids "
                   f"{sorted(set(g for g, _ in grids))} and {vp.num_steps} "
                   "validation CFG calls")
    log_step_rate(label, trainer, wall, peak, card)
    TRAIN_PEAKS[label] = peak
    if cuda:
        total = torch.cuda.get_device_properties(0).total_memory
        log(f"{label} [{card}]: batch {trainer.params.batch_size} at "
            f"{trainer.params.aspect_ratios or 1024} px, as written: fits, "
            f"peak {peak / 2**30:.2f} GiB of the card's "
            f"{total / 2**30:.2f} GiB")
    return {k: counts[k] for k in FLUX_KERNELS}


# ---------------------------------------------------------------------------
# 16. PixelDiT
# ---------------------------------------------------------------------------

PIXELDIT_KERNELS = PIXART_TRAIN_KERNELS
PIXELDIT_TRAIN_STEPS = 3
# the training run's raw sources at 512 px: the square bucket (512x512,
# 32x32 patch tokens, 16384 pixel tokens) and the 3.0 bucket (864x288:
# 18x54 patch tokens, whose attentions the gate sends to the XLA branch,
# and 15552 pixel tokens, no multiple of 128)
PIXELDIT_SOURCES = ((640, 640), (1080, 360))


def pixel_tokens(cfg, hw):
    """PixelDiT's pixel-stage tokens on an image of ``hw`` pixels."""
    return hw[0] // cfg.patch_size * (hw[1] // cfg.patch_size) * cfg.ratio ** 2


def pixeldit_launches(cfg, grid, n_txt, passes):
    """The launches of ``passes`` = (forwards, backwards) of PixelDiT, without
    remat, on a ``grid`` of patch tokens with ``n_txt`` caption keys
    (``models.pixeldit.kernel_calls``): each patch block's self- and
    cross-attention on the kernel of the branch the gate gives its sizes
    (``ops.attention.attention_branch``; the XLA branch counts its
    forwards and launches no backward kernel), each pixel block's
    self-attention on K6 and K6b directly, K1 once a forward and K1b once a
    backward but for block 0's first norm, whose inputs are all frozen
    under adapters (the patch embed and the modulation are no targets)."""
    from yat_tpu_torch.models.pixeldit import kernel_calls
    from yat_tpu_torch.ops.attention import attention_branch

    calls = kernel_calls(cfg, grid[0], grid[1], n_txt)
    fwd, bwd = passes
    out = dict.fromkeys(PIXELDIT_KERNELS, 0)
    for _, nq, nk, h, d in calls["dot_product_attention"]:
        f, b = BRANCH_KERNELS[attention_branch(nq, nk, h, d)]
        out[f] += fwd
        if b:
            out[b] += bwd
    n_px = len(calls["flash_attention"])
    n_norm = len(calls["adaln_layernorm"])
    out["flash_attention"] += n_px * fwd
    out["flash_attention_bwd"] += n_px * bwd
    out["adaln_layernorm"] += n_norm * fwd
    out["adaln_layernorm_bwd"] += (n_norm - 1) * bwd
    return out


def pixeldit_adapted(cfg):
    """The projections ``[to_q, to_k, to_v, to_out]`` adapt: a patch
    block's self- and cross-attention, a pixel block's self-attention."""
    return 8 * cfg.num_layers + 4 * cfg.num_pixel_layers


def phase_pixeldit_serve(device, card, params=None, px=512,
                         window_ms=100.0):
    """PixelDiT served at 512 px through HTTP (``phase_serve``): the
    denoiser at full width in bf16, cut to 14 of its 24 patch blocks and
    2 of its 4 pixel blocks (``DEPTH_CUTS``; patch blocks at width
    1024, 4 pixel blocks at width 256 over 16384 pixel tokens), Gemma-2-2B
    in bf16 at 300 tokens, no VAE (the sample is the image);
    DPM-Solver++(2M) in flow form, 20 steps, CFG 4.0; the modulation
    drawn (``drawn_modulation``)."""
    with drawn_modulation():
        return phase_serve(params or serve_params(
            aspect_ratio=str(px),
            model_config_overrides=dict(DEPTH_CUTS["pixeldit"])),
                           device, card, family="pixeldit", px=px,
                           profile=device.type == "cuda",
                           window_ms=window_ms)


def phase_pixeldit_grad_reference(device, cfg_over=None, side=512):
    """PixelDiT at full width cut to 2 patch blocks (the REPA tap after
    block 1) and 1 pixel block, with rank-8 LoRA on ``LORA_TARGETS``
    (nonzero ``lora_b``) over a 4-bit base quantized once, at ``side`` px
    (512: 1024 patch tokens, 16384 pixel tokens) over a 300-token caption
    of which 120 are kept: one flow-matching loss with the REPA term at
    0.1 and every LoRA gradient through the kernels on the card (K6/K6b
    through the gate and directly, K4/K4b, K1/K1b) against the same step
    through the plain versions on the CPU, fp32: the loss within 1e-4 and
    the worst leaf's max|dg| within ``GRAD_REF_TOL`` of its largest
    entry.  The modulation is drawn (``drawn_modulation``)."""
    import dataclasses
    import functools

    import torch

    from yat_tpu_torch.adapters.builder import adapter_parameters
    from yat_tpu_torch.frontends.pixeldit import REPA_LOSS_WEIGHT
    from yat_tpu_torch.kernels.build import launch_counts, reset_launch_counts
    from yat_tpu_torch.models.layers import AdapterDense
    from yat_tpu_torch.models.pixeldit import PIXELDIT_BASE, PixelDiT
    from yat_tpu_torch.ops.quant import quantize_params
    from yat_tpu_torch.ops.schedulers import FlowMatchSchedule
    from yat_tpu_torch.train.step import loss_and_grads
    from yat_tpu_torch.train.tasks import make_flow_matching_loss

    label = "pixeldit grad reference"
    cfg = dataclasses.replace(PIXELDIT_BASE, num_layers=2,
                              num_pixel_layers=1, repa_depth=1,
                              **(cfg_over or {}))
    t0 = time.perf_counter()
    with drawn_modulation():
        cpu, gpu, n = lora_pair(functools.partial(PixelDiT, repa=True), cfg,
                                8, device)
    quantize_params(cpu, 4)
    on_device = dict(gpu.named_modules())
    for name, m in cpu.named_modules():
        if isinstance(m, AdapterDense) and m.qweight is not None:
            on_device[name].set_quantized(m.qweight, m.weight_scale, 4)
    rng = np.random.default_rng(0)
    n_txt, grid = cfg.max_caption_len, side // cfg.patch_size
    tokens = grid ** 2
    pixels = rng.uniform(-1, 1, (1, side, side, 3)).astype(np.float32)
    emb = rng.standard_normal((1, n_txt, cfg.caption_channels), np.float32)
    mask = (np.arange(n_txt) < min(120, n_txt)).astype(np.int32)[None]
    dino = rng.standard_normal((1, 256, cfg.repa_target_dim), np.float32)
    sched = FlowMatchSchedule(shift=1.0)
    ts, sig = sched.training_draw(torch.Generator().manual_seed(3), 1)
    noise = rng.standard_normal(pixels.shape, np.float32)
    results = []
    for model, dev in ((gpu, device), (cpu, torch.device("cpu"))):
        t1 = time.perf_counter()
        batch = {"latents": torch.from_numpy(pixels).to(dev),
                 "embeddings": torch.from_numpy(emb).to(dev),
                 "text_mask": torch.from_numpy(mask).to(dev),
                 "repa_features": torch.from_numpy(dino).to(dev)}
        draws = {"timesteps": ts.to(dev), "sigmas": sig.to(dev),
                 "noise": torch.from_numpy(noise).to(dev)}
        leaves = [p for _, p in adapter_parameters(model)]
        reset_launch_counts()
        loss, grads = loss_and_grads(
            make_flow_matching_loss(model, sched,
                                    repa_lambda=REPA_LOSS_WEIGHT),
            leaves, batch, torch.Generator(), draws)
        results.append((float(loss), [g.detach().cpu() for g in grads],
                        launch_counts(), time.perf_counter() - t1))
    (loss_g, grads_g, counts, sec_g), (loss_c, grads_c, _, sec_c) = results
    names = [name for name, _ in adapter_parameters(cpu)]
    loss_err = abs(loss_g - loss_c) / abs(loss_c)
    zero, rows, ok = [], [], loss_err <= 1e-4
    for name, gc, gg in zip(names, grads_c, grads_g):
        scale = float(gc.abs().max())
        rel = float((gg - gc).abs().max()) / scale
        rows.append((rel, name, scale))
        ok = ok and rel <= GRAD_REF_TOL and bool(torch.isfinite(gg).all())
        if not bool((gg != 0).any()):
            zero.append(name)
    for rel, name, scale in sorted(rows, reverse=True)[:3]:
        log(f"{label}:   {name}: max|g| {scale:.3e}; max|dg|/max|g| "
            f"{rel:.2e}")
    want = pixeldit_launches(cfg, (grid, grid), n_txt, (1, 1))
    if device.type != "cuda":
        want = {k: 0 for k in want}
    log(f"{label}: PixelDiT at width {cfg.hidden_dim}/{cfg.pixel_hidden_dim}"
        f", {cfg.num_layers} + {cfg.num_pixel_layers} blocks, 4-bit base, "
        f"LoRA on {n} modules ({len(names)} leaves) at {side} px ({tokens} "
        f"patch, {tokens * cfg.ratio ** 2} pixel tokens), {device.type} "
        f"({sec_g:.1f} s)"
        f" vs CPU ({sec_c:.1f} s), fp32: loss {loss_g:.6f} vs {loss_c:.6f} "
        f"(rel {loss_err:.2e}, tol 1e-4); worst leaf max|dg|/max|g| "
        f"{max(r[0] for r in rows):.2e} (tol {GRAD_REF_TOL:g}); zero "
        f"gradients: {len(zero)}; launches "
        f"{ {k: counts[k] for k in want if want[k] or counts[k]} }; "
        f"{time.perf_counter() - t0:.1f} s in all")
    if zero:
        fail(f"{label}: LoRA leaves with no gradient: {zero[:4]}")
    if not ok:
        fail(f"{label}: LoRA gradients on the card disagree with the CPU")
    if any(counts[k] != v for k, v in want.items()):
        fail(f"{label}: launches {counts}, expected {want}")


def pixeldit_train_config(shards, ckpt, out_dir, **extra):
    """``configs/pixeldit_repa.yaml`` as written but for its files and the
    run's length: the raw shards written here for its
    ``local_shard_paths``, the synthesized ``.pth`` for its
    ``pretrained_model_path``, ``PIXELDIT_TRAIN_STEPS`` steps with the
    validation at the last; no ``repa_pretrained_model`` is configured, so
    DINOv2 is random from the seed."""
    import yaml
    with open(os.path.join(REPO, "configs", "pixeldit_repa.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg.update({"local_shard_paths": list(shards),
                "pretrained_model_path": ckpt,
                "steps": str(PIXELDIT_TRAIN_STEPS),
                "num_steps_per_validation": str(PIXELDIT_TRAIN_STEPS),
                "output_dir": out_dir, "dataset_seed": "0", **extra})
    return {k: (str(v) if isinstance(v, (int, float, bool)) else v)
            for k, v in cfg.items()}


def write_pixeldit_pth(path, cfg):
    """A seeded PixelDiT ``.pth`` of ``cfg`` in DiT naming
    (``synth_checkpoint.pixeldit_rules``; BF16 values and storage; no REPA
    projector, as a published file has none).  Returns the rules."""
    import torch

    from yat_tpu_torch.convert import flax_params
    from yat_tpu_torch.models.pixeldit import PixelDiT

    S = synth_module()
    with torch.device("meta"):
        shapes = {k: tuple(v.shape) for k, v in flax_params(
            PixelDiT(cfg, dtype=torch.float32)).items()}
    rules = S.pixeldit_rules(cfg.patch_size)
    t0 = time.perf_counter()
    info = S.write_pth(path, shapes, rules, SYNTH_SEED, "BF16")
    log(f"pixeldit train: synthesized {path}: {info['tensors']} tensors, "
        f"{info['bytes'] / 1e9:.2f} GB (BF16) in "
        f"{time.perf_counter() - t0:.1f} s")
    return rules


def check_pixeldit_load(label, model, rules):
    """Every base parameter of the trained ``model`` equals its value in
    the synthesized file after the same casts (the quantized weights:
    their 4-bit payload and scale equal the quantization of that value);
    the REPA projector and the adapters are not in the file."""
    import torch

    from yat_tpu_torch.models.layers import AdapterDense
    from yat_tpu_torch.ops.quant import quantize_kernel

    S = synth_module()
    entries = []
    for name, m in model.named_modules():
        for pname, t in m.named_parameters(recurse=False):
            if pname in ("weight", "bias"):     # not the adapters' leaves
                entries.append((f"{name}.{pname}", t))
        if isinstance(m, AdapterDense) and m.qweight is not None:
            entries.append((f"{name}.weight", m))
    checked, bad, n = 0, [], 0
    for tname, t in entries:
        path = tname.replace(".weight", ".kernel")
        try:
            _, kind = S.match(path, rules)
        except KeyError:
            continue                    # the projector, the adapters
        if isinstance(t, AdapterDense):
            v = S.leaf_value(SYNTH_SEED, path, (t.in_features, t.features),
                             kind, "BF16")
            q, scale = quantize_kernel(torch.from_numpy(
                np.ascontiguousarray(v.T)).to(t.qweight.device), t.bits)
            same = torch.equal(q, t.qweight) and torch.equal(
                scale, t.weight_scale)
            n += q.numel()
        else:
            flax = t.T if t.ndim == 2 and path.endswith(".kernel") else t
            v = S.leaf_value(SYNTH_SEED, path, tuple(flax.shape), kind,
                             "BF16")
            same = torch.equal(flax, torch.from_numpy(v).to(
                device=t.device, dtype=t.dtype))
            n += t.numel()
        checked += 1
        if not same:
            bad.append(path)
    if bad or not checked:
        fail(f"{label}: {len(bad)} base tensors differ from the .pth, e.g. "
             f"{bad[:4]}")
    log(f"{label}: all {n:,} base values ({checked} tensors, the 4-bit "
        "payloads and scales among them) are the .pth's after the same "
        "casts and quantization")


def check_repa_reach(label, trainer, device):
    """The REPA term's gradient on one image at 4x4 patch tokens reaches
    the LoRA leaves of blocks 0 to ``repa_depth`` and no other."""
    import torch

    from yat_tpu_torch.frontends.common import dino_config
    from yat_tpu_torch.train.tasks import repa_alignment_loss

    cfg = trainer.pixeldit_config
    dino = dino_config(trainer.params)
    gen = torch.Generator(device=device).manual_seed(9)
    side = 4 * cfg.patch_size
    x = torch.rand((1, side, side, 3), generator=gen, device=device) * 2 - 1
    emb = torch.randn((1, cfg.max_caption_len, cfg.caption_channels),
                      generator=gen, device=device)
    mask = torch.ones((1, cfg.max_caption_len), dtype=torch.int32,
                      device=device)
    target = torch.randn((1, dino.grid ** 2, dino.hidden_dim),
                         generator=gen, device=device)
    _, proj = trainer.model(x, emb, torch.full((1,), 500.0, device=device),
                            mask, return_repa=True)
    names, leaves = trainer.trainable_names(), trainer.trainable_leaves()
    grads = torch.autograd.grad(repa_alignment_loss(proj, target), leaves,
                                allow_unused=True)
    reached = {n for n, g in zip(names, grads)
               if g is not None and bool((g != 0).any())}
    want = {n for n in names if n.startswith("blocks_")
            and int(n.split(".")[0].split("_")[1]) <= cfg.repa_depth}
    log(f"{label}: the REPA term's gradient reaches {len(reached)} LoRA "
        f"leaves (blocks 0-{cfg.repa_depth}: {len(want)}) of {len(names)}")
    if reached != want:
        fail(f"{label}: the REPA term reaches {sorted(reached ^ want)[:4]} "
             "against blocks 0 to the tap")


def xla_probe(label, device, n, batch, heads=4, head_dim=64):
    """The pixel stage's self-attention at ``n`` tokens (no multiple of
    128) on the gate's XLA branch, as the JAX model's gate takes it, and on
    K6/K6b as the port calls it: one bf16 forward and backward each at
    ``batch``, the peak device memory above what the run holds resident,
    or the allocation that did not fit."""
    import torch

    from yat_tpu_torch.ops.attention import attention_xla, flash_attention

    gen = torch.Generator(device=device).manual_seed(4)
    total = torch.cuda.get_device_properties(0).total_memory
    for name, fn in (("the XLA branch", attention_xla),
                     ("K6/K6b", flash_attention)):
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        q, k, v, g = (torch.randn((batch, n, heads, head_dim), generator=gen,
                                  device=device).to(torch.bfloat16)
                      for _ in range(4))
        for t in (q, k, v):
            t.requires_grad_()
        t0 = time.perf_counter()
        try:
            fn(q, k, v).backward(g)
            torch.cuda.synchronize()
            log(f"{label}: {name} at [{batch}, {n}, {heads}, {head_dim}] "
                f"forward and backward: fits, peak "
                f"{(torch.cuda.max_memory_allocated() - resident) / 2**30:.2f}"
                f" GiB above the resident {resident / 2**30:.2f} GiB "
                f"({time.perf_counter() - t0:.3f} s)")
        except torch.cuda.OutOfMemoryError as e:
            log(f"{label}: {name} at [{batch}, {n}, {heads}, {head_dim}] "
                f"forward and backward: does not fit in the card's "
                f"{total / 2**30:.2f} GiB beside the resident "
                f"{resident / 2**30:.2f} GiB (peak before the failure "
                f"{(torch.cuda.max_memory_allocated() - resident) / 2**30:.2f}"
                f" GiB): {str(e).splitlines()[0]}")
        del q, k, v, g
        torch.cuda.empty_cache()


def phase_pixeldit_train(device, card, tiny=None):
    """``configs/pixeldit_repa.yaml`` through ``frontends.pixeldit.main``
    as written but for its files and length (``pixeldit_train_config``):
    PixelDiT at full width, cut to 14 patch and 2 pixel blocks
    (``DEPTH_CUTS``), from a synthesized BF16 ``.pth`` in
    DiT naming (the REPA projector drawn from the seed), rank-8 LoRA on
    to_q/to_k/to_v/to_out (120 projections at the cut) over a 4-bit
    base, bf16,
    REPA at 0.1 through the projector after block 12 against a random
    DINOv2 ViT-B/14 (no file), batch 4 of raw JPEGs at the square and the
    864x288 bucket of 512 px encoded on the fly (the identity, Gemma-2-2B
    at 300 tokens), ``PIXELDIT_TRAIN_STEPS`` steps with the DPM CFG 4.0
    validation at the last: every parameter loaded from the file, finite
    losses, one REPA term a step, every LoRA leaf changed and exported,
    the REPA term reaching the leaves of blocks 0-12 alone, the validation
    image, the launches by step on the branch each bucket gives (K6 and K4
    at the square bucket's patch stage, the XLA branch at 864x288's, K6/K6b
    directly for every pixel stage), the step time, the peak and whether
    the step fits; then one step split into its encode and its denoiser
    step, each profiled (``encode_and_step``), and the pixel stage's
    attention at the 864x288 bucket on the gate's XLA branch beside K6/K6b
    at the training batch (``xla_probe``)."""
    import gc

    import torch

    from yat_tpu_torch.config import TrainingParameters
    from yat_tpu_torch.frontends import pixeldit
    from yat_tpu_torch.train.validation import ValidationPipeline

    label = "pixeldit train"
    cuda = device.type == "cuda"
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        raw, sizes = write_raw_shards(
            tmp, 4 if tiny is None else 2, scale=1.0 if tiny is None
            else 0.5, shards=1, sources=PIXELDIT_SOURCES)
        log(f"{label}: wrote {len(sizes)} JPEGs at sources "
            f"{sorted(set(sizes))} in {time.perf_counter() - t0:.1f} s")
        extra = depth_cut("pixeldit") if tiny is None else {
            "batch_size": "2", "vae_max_batch_size": "2",
            "text_encoder_max_batch_size": "2", "aspect_ratio": "256",
            "model_config_overrides": tiny}
        ckpt = os.path.join(tmp, "checkpoint.pth")
        cfg = pixeldit_train_config(raw, ckpt, os.path.join(tmp, "out"),
                                    **extra)
        rules = write_pixeldit_pth(ckpt, pixeldit.build_config(
            TrainingParameters.from_dict(cfg)))
        images = []
        validate = ValidationPipeline.validate

        def recording(self, trainer, x0=None):
            got = validate(self, trainer, x0)
            images.append(got)
            return got
        ValidationPipeline.validate = recording
        try:
            with working_dir(tmp), initial_state(), \
                    recorded_repa_terms() as terms:
                with recorded_batches() as grids:
                    trainer, counts, wall, peak = drive_entry_point(
                        label, pixeldit.main, device, tmp, cfg)
                out = {label: check_pixeldit_run(
                    label, trainer, cfg, counts, cuda, grids, images, terms,
                    wall, peak, card)}
                check_pixeldit_load(label, trainer.model, rules)
                check_repa_reach(label, trainer, device)
                encode_and_step(label, trainer, device, card, peak)
                if cuda:
                    xla_probe(label, device, min(
                        n for n in (pixel_tokens(trainer.pixeldit_config, g)
                                    for g, _ in grids) if n % 128),
                        trainer.params.batch_size)
        finally:
            ValidationPipeline.validate = validate
        del trainer
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
    return out


def check_pixeldit_run(label, trainer, cfg, counts, cuda, grids, images,
                       terms, wall, peak, card):
    """The checks of one PixelDiT training run (``phase_pixeldit_train``)."""
    import torch

    from yat_tpu_torch.frontends.common import dino_config

    model_cfg = trainer.pixeldit_config
    check_trained(label, trainer, cfg, None, pixeldit_adapted(model_cfg))
    steps = int(cfg["steps"])
    if len(grids) != steps or len(images) != 1:
        fail(f"{label}: {len(grids)} batches for {steps} steps, "
             f"{len(images)} validations (expected 1)")
    p = model_cfg.patch_size
    px_tokens = {g: pixel_tokens(model_cfg, g) for g, _ in grids}
    square = [g for g in px_tokens if g[0] == g[1]]
    ragged = [g for g, n in px_tokens.items() if n % 128]
    log(f"{label}: buckets by step {[g for g, _ in grids]}; pixel tokens "
        f"{px_tokens}")
    if not square or not ragged:
        fail(f"{label}: the run met the buckets {sorted(px_tokens)}: "
             "expected the square one and one whose pixel-token count is "
             "no multiple of 128")
    dino = dino_config(trainer.params)
    check_repa_terms(label, terms, steps, (trainer.params.batch_size,
                                           dino.grid ** 2, dino.hidden_dim))
    vp = trainer.validation_pipeline
    res = vp.latent_shape[0]
    for tag, img in images[0].items():
        if img.shape != (res, res, 3) or not np.isfinite(img).all():
            fail(f"{label}: validation image {tag} {img.shape} not "
                 f"finite / not {res}x{res}x3")
    want = dict.fromkeys(PIXELDIT_KERNELS, 0)
    side = res // p
    runs = [((h // p, w // p), rung, (1, 1)) for (h, w), rung in grids]
    runs += [((side, side), model_cfg.max_caption_len, (1, 0))] \
        * vp.num_steps
    for grid, rung, passes in runs:
        for k, n in pixeldit_launches(model_cfg, grid, rung,
                                      passes).items():
            want[k] += n if cuda else 0
    check_launches(label, counts, want,
                   lambda k: f"{steps} steps at buckets "
                   f"{sorted(set(g for g, _ in grids))} and {vp.num_steps} "
                   "validation CFG calls")
    log_step_rate(label, trainer, wall, peak, card)
    TRAIN_PEAKS[label] = peak
    if cuda:
        total = torch.cuda.get_device_properties(0).total_memory
        log(f"{label} [{card}]: batch {trainer.params.batch_size} at "
            f"{trainer.params.aspect_ratios} px, as written: fits, peak "
            f"{peak / 2**30:.2f} GiB of the card's {total / 2**30:.2f} GiB")
    return {k: counts[k] for k in PIXELDIT_KERNELS}


# ---------------------------------------------------------------------------
# 17. training across processes (torchrun, four processes on the card)
# ---------------------------------------------------------------------------

MP_WORLD = 4
MP_STEPS = 3
# the meshes of the phase: the card is one, so the four processes share it;
# each mesh has two data indices (the rows), its tp or sp peers the same
MP_MESHES = {"fsdp-tp": {"fsdp": 2, "tp": 2}, "dp-sp": {"dp": 2, "sp": 2}}
MP_DATA = 2
# PixArt-Sigma's token-sharded step: two processes at {sp: 2}
PIXART_SP_WORLD = 2
PIXART_SP_STEPS = 2
# validation in the SANA runs: 4 of the sampler's 20 steps (each step is
# the same collective path), the CFG calls' launches counted as before
MP_VAL_STEPS = 4
# the processes' step against a one-process copy's on the whole global
# batch, for each run.  fp32 (TF32 off), a copy split as the trainer's
# model is: the split's own arithmetic, summation order only; the whole
# gradient within 1e-4 of its norm and each leaf within 1e-3.  bf16, the
# trainer's own step: the whole gradient within one bf16 step (2^-7) of
# the one-process bf16 step's norm, the loss within the bf16 forward
# tolerance (2e-2), and each leaf no further from the one-process fp32
# step than twice the one-process bf16 step's worst leaf is: bf16 alone
# moves the leaves whose B is still near 0 (small gradients) by 3.5e-2 of
# their norm on one process (an H100 80GB at 4 rows a data index)
MP_FP32_GRAD_RTOL, MP_FP32_LEAF_RTOL = 1e-4, 1e-3
MP_GRAD_RTOL, MP_LOSS_RTOL, MP_BF16_LEAF_FACTOR = 2.0 ** -7, 2e-2, 2.0
# the rows of each data index in that step (the fp32 copies' activations
# of four processes at the runs' 16 rows would not fit beside the
# trainers on the one card)
MP_SAME_ROWS = 4
# the ring and the all-reduce form of context-parallel attention at
# q/k/v [2, 4096, 8, 64] fp32 (the keys and values over the four
# processes) against one-process attention
CP_SHAPE = (2, 4096, 8, 64)
CP_TOL = 1e-4


def mp_train_config(shards, tmp, label, mesh, cfg_extra=None):
    """``configs/sana_512_lora.yaml`` as written but for its files
    (``shards``, no pretrained paths: the modules are random from the
    seed), its ``mesh_shape`` (``mesh``: one card holds the four
    processes), the training depth cut and ``MP_STEPS`` steps with the
    validation and the checkpoint at the last."""
    import yaml
    with open(os.path.join(REPO, "configs", "sana_512_lora.yaml")) as f:
        cfg = yaml.safe_load(f)
    for key in ("pretrained_pipe_path", "pretrained_model_path"):
        cfg.pop(key)
    cfg.update({"local_shard_paths": shards, "mesh_shape": dict(mesh),
                "steps": MP_STEPS, "num_steps_per_validation": MP_STEPS,
                "checkpoint_dir": os.path.join(tmp, f"ckpt-{label}"),
                "output_dir": os.path.join(tmp, f"out-{label}"),
                **depth_cut("train")})
    for k, v in (cfg_extra or {}).items():
        if k == "model_config_overrides":
            cfg[k] = {**cfg[k], **v}
        else:
            cfg[k] = v
    return cfg


def _digest(tensors):
    import hashlib
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def _model_copy(trainer, state, fp32, split):
    """A copy of the trainer's model from ``state`` (its whole leaves),
    computing in fp32 or in the trainer's dtype, split over the trainer's
    mesh as the trainer's model is (``split``: collective) or whole on
    this process: (its loss, its trainable leaves, its GradSync or
    None)."""
    import dataclasses

    import torch

    from yat_tpu_torch.adapters.builder import (adapter_parameters,
                                                build_adapter_params)
    from yat_tpu_torch.parallel.tensor import parallelize
    from yat_tpu_torch.train.engine import adapter_spec_from_params
    from yat_tpu_torch.train.tasks import (make_epsilon_loss,
                                           make_flow_matching_loss)

    params = trainer.params
    if fp32:
        params = dataclasses.replace(params, bfloat16=False)
    pixart = hasattr(trainer, "pixart_config")
    if pixart:
        from yat_tpu_torch.frontends import pixart as front
        ref = front.build_denoiser(params, trainer.pixart_config,
                                   trainer.device)
    else:
        from yat_tpu_torch.frontends import sana as front
        ref = front.build_denoiser(params, trainer.sana_config,
                                   trainer.device)
    build_adapter_params(ref, adapter_spec_from_params(params),
                         torch.Generator(device=trainer.device).manual_seed(0),
                         merged=params.lora_fused_matmul)
    ref.load_state_dict(state)
    if pixart:
        task = make_epsilon_loss(ref, trainer.schedule, learned_sigma=(
            front._pred_slice(trainer.pixart_config) is not None))
    else:
        task = make_flow_matching_loss(ref, trainer.schedule)
    leaves = [p for _, p in adapter_parameters(ref)]
    sync = parallelize(ref, trainer.mesh, leaves)[3] if split else None
    return task, leaves, sync


def mp_same_step(trainer):
    """One seeded global batch (``MP_SAME_ROWS`` rows for each data
    index, at the longest caption rung) and one set of global draws.  Each
    process takes its data index's rows, and its gradients and loss are
    reduced over the mesh (the step's path): the trainer's own (bf16),
    then an fp32 copy split as the trainer's model is.  On process 0,
    one-process copies (bf16 and fp32) take the step on the whole batch.
    Returns process 0's comparison (collective)."""
    import torch

    from yat_tpu_torch.parallel.multihost import barrier, process_index
    from yat_tpu_torch.train.step import loss_and_grads

    dev = trainer.device
    b = MP_SAME_ROWS
    pixart = hasattr(trainer, "pixart_config")
    cfg = trainer.pixart_config if pixart else trainer.sana_config
    data = trainer.mesh.data_count
    gen = torch.Generator(device=dev).manual_seed(5)
    n, rung = data * b, cfg.max_caption_len
    lat_dtype = torch.bfloat16 if trainer.params.bfloat16 else torch.float32
    batch = {"latents": torch.randn(
                 (n, cfg.sample_size, cfg.sample_size, cfg.in_channels),
                 generator=gen, device=dev).to(lat_dtype),
             "embeddings": torch.randn((n, rung, cfg.caption_channels),
                                       generator=gen, device=dev),
             "text_mask": _caption_mask(n, rung, dev)}
    drawn = trainer.schedule.training_draw(gen, n)
    draws = ({"timesteps": drawn[0], "sigmas": drawn[1]}
             if isinstance(drawn, tuple) else {"timesteps": drawn})
    draws["noise"] = torch.randn(batch["latents"].shape, generator=gen,
                                 device=dev)
    mine = slice(trainer.mesh.data_rank * b, (trainer.mesh.data_rank + 1) * b)

    def step(task, leaves, sync, rows):
        loss, grads = loss_and_grads(
            task, leaves, {k: v[rows] for k, v in batch.items()}, gen,
            {k: v[rows] for k, v in draws.items()})
        loss = loss.float().reshape(1)
        if sync is not None:
            sync.reduce_grads_(grads, loss)
        return grads, float(loss[0])

    def errors(got, want):
        leaf = max(float((g.float() - w.float()).norm() / w.float().norm())
                   for g, w in zip(got, want))
        diff = sum(float((g.float() - w.float()).square().sum())
                   for g, w in zip(got, want))
        whole = sum(float(w.float().square().sum()) for w in want)
        return (diff / whole) ** 0.5, leaf

    t0 = time.perf_counter()
    if dev.type == "cuda":
        # the run's cached blocks back to the card for the copies
        torch.cuda.empty_cache()
    with trainer.whole():
        state = {k: v.detach().clone()
                 for k, v in trainer.model.state_dict().items()}
    g16, l16 = step(trainer.task_loss, trainer.trainable_leaves(),
                    trainer.grad_sync, mine)
    g32, l32 = step(*_model_copy(trainer, state, True, True), mine)
    out = {}
    if process_index() == 0:
        one16, lone16 = step(*_model_copy(trainer, state, False, False),
                             slice(None))
        one32, lone32 = step(*_model_copy(trainer, state, True, False),
                             slice(None))
        out = {"rows": b, "data": data,
               "loss": [l16, lone16, l32, lone32],
               "bf16": errors(g16, one16), "fp32": errors(g32, one32),
               "bf16_fp32": errors(g16, one32),
               "one_bf16_fp32": errors(one16, one32),
               "seconds": time.perf_counter() - t0}
    del state, g16, g32
    barrier()
    return out


def check_same_step(label, same):
    """The processes' step against the one-process step on the same
    global batch (``mp_same_step``), in fp32 and in bf16."""
    l16, lone16, l32, lone32 = same["loss"]
    bf16_leaf = MP_BF16_LEAF_FACTOR * same["one_bf16_fp32"][1]
    log(f"{label}: one step on {same['data']} x {same['rows']} rows, the "
        f"processes' reduced gradients against the one-process step on all "
        f"of them ({same['seconds']:.1f} s): fp32 (a copy split as the "
        f"trainer's model, TF32 off) the gradient off by "
        f"{same['fp32'][0]:.3e} of its norm (tol {MP_FP32_GRAD_RTOL:g}), the "
        f"worst leaf by {same['fp32'][1]:.3e} (tol {MP_FP32_LEAF_RTOL:g}), "
        f"loss {l32:.6f} vs {lone32:.6f}; bf16 (the trainer's) "
        f"{same['bf16'][0]:.3e} (tol {MP_GRAD_RTOL:.3e}), the worst leaf "
        f"{same['bf16'][1]:.3e}, loss {l16:.6f} vs {lone16:.6f}; against the "
        f"one-process fp32 step: the trainer's bf16 worst leaf "
        f"{same['bf16_fp32'][1]:.3e} (tol {bf16_leaf:.3e}, "
        f"{MP_BF16_LEAF_FACTOR:g} x the one-process bf16 step's "
        f"{same['one_bf16_fp32'][1]:.3e}; its "
        f"whole gradient {same['one_bf16_fp32'][0]:.3e})")
    if same["fp32"][0] > MP_FP32_GRAD_RTOL or \
            same["fp32"][1] > MP_FP32_LEAF_RTOL or \
            abs(l32 - lone32) > MP_FP32_GRAD_RTOL * abs(lone32) or \
            same["bf16"][0] > MP_GRAD_RTOL or \
            same["bf16_fp32"][1] > bf16_leaf or \
            abs(l16 - lone16) > MP_LOSS_RTOL * abs(lone16):
        fail(f"{label}: the processes' step differs from the one-process "
             "step")


def mp_context_parallel(rank, world, device):
    """``context_parallel_attention`` (the queries whole) and
    ``ring_attention`` (the queries sharded) at ``CP_SHAPE`` over the
    processes, each with its key and value shard, against one-process
    attention (SDPA, fp32) on process 0; device ms a call."""
    import torch
    import torch.nn.functional as F

    from yat_tpu_torch.ops.context_parallel import (
        context_parallel_attention, ring_attention)
    from yat_tpu_torch.parallel.multihost import barrier

    gen = torch.Generator(device=device).manual_seed(3)
    q, k, v = (torch.randn(CP_SHAPE, generator=gen, device=device)
               for _ in range(3))
    part = CP_SHAPE[1] // world
    mine = slice(rank * part, (rank + 1) * part)
    ks, vs = k[:, mine].contiguous(), v[:, mine].contiguous()
    rec = {}
    for name, fn, qq in (("context_parallel", context_parallel_attention, q),
                         ("ring", ring_attention, q[:, mine].contiguous())):
        out = fn(qq, ks, vs, None)
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        for _ in range(3):
            fn(qq, ks, vs, None)
        torch.cuda.synchronize(device)
        rec[name] = {"ms": (time.perf_counter() - t0) / 3 * 1e3,
                     "out": out}
    barrier()
    res = {}
    if rank == 0:
        want = F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2),
            v.transpose(1, 2)).transpose(1, 2)
        for name, r in rec.items():
            w = want if name == "context_parallel" else want[:, mine]
            res[name] = {"ms": r["ms"],
                         "max_abs_err": float((r["out"] - w).abs().max())}
    else:
        res = {name: {"ms": r["ms"]} for name, r in rec.items()}
    barrier()
    return res


def _family_main(cfg_path):
    """The entry point of the config's family (PixArt's files are named
    ``mp-pixart-*``)."""
    if os.path.basename(cfg_path).startswith("mp-pixart"):
        from yat_tpu_torch.frontends.pixart import main
    else:
        from yat_tpu_torch.frontends.sana import main
    return main


def mp_train_worker(out_dir, device, cfg_paths):
    """One torchrun process of the phase: each config through its
    family's entry point, its launch counts set to 0 just before and read
    just after (those inside validation apart), then the checks that need
    the live trainer; ``{out_dir}/{label}-rank{rank}.json`` holds what it
    saw.  The SANA processes then run the context-parallel attentions
    (``context-rank{rank}.json``)."""
    import torch

    sys.path.insert(0, REPO)
    from yat_tpu_torch.kernels.build import launch_counts, reset_launch_counts
    from yat_tpu_torch.parallel import tensor as tensor_mod
    from yat_tpu_torch.parallel.mesh import frozen_bytes
    from yat_tpu_torch.parallel.multihost import barrier
    from yat_tpu_torch.train import checkpoint as ckpt_mod
    from yat_tpu_torch.train import engine, validation

    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    cuda = device == "cuda"
    writes = {}
    save, export = ckpt_mod.save_train_state, engine.Trainer._write_export
    validate = validation.ValidationPipeline.validate
    val_counts = {}

    def counted_save(*a, **k):
        writes["checkpoint"] += 1
        return save(*a, **k)

    def counted_export(self, *a, **k):
        writes["export"] += 1
        return export(self, *a, **k)

    def counted_validate(self, trainer, *a, **k):
        self.num_steps = MP_VAL_STEPS
        before = launch_counts()
        t0 = time.perf_counter()
        out = validate(self, trainer, *a, **k)
        val_counts["_seconds"] = time.perf_counter() - t0
        for name, c in launch_counts().items():
            val_counts[name] = val_counts.get(name, 0) + c - before[name]
        val_counts["_calls"] = val_counts.get("_calls", 0) + 1
        val_counts["_steps"] = self.num_steps
        return out

    # which process writes and what validation launches (observed), and
    # validation's sampler cut to MP_VAL_STEPS steps
    ckpt_mod.save_train_state = counted_save
    engine.Trainer._write_export = counted_export
    validation.ValidationPipeline.validate = counted_validate
    sana = False
    for cfg_path in cfg_paths:
        label = os.path.splitext(os.path.basename(cfg_path))[0]
        train_main = _family_main(cfg_path)
        pixart = label.startswith("mp-pixart")
        sana = sana or not pixart
        writes.update(checkpoint=0, export=0)
        val_counts.clear()
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        tensor_mod.COLLECTIVES.update(calls=0, seconds=0.0, bytes=0)
        # main path: the entry point, as torchrun's processes run it
        t0 = time.perf_counter()
        trainer = train_main(["--config", cfg_path, "--device", device])
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        collectives = dict(tensor_mod.COLLECTIVES)
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        leaves, ema = trainer.trainable_leaves(), trainer.ema or []
        cfg_model = trainer.pixart_config if pixart else trainer.sana_config
        rec = {"rank": rank, "world": world, "wall": wall, "peak": peak,
               "backend": torch.distributed.get_backend(),
               "device": str(trainer.device), "counts": counts,
               "validation_counts": dict(val_counts), "writes": dict(writes),
               "history": trainer.history, "step_times": trainer._step_times,
               "allreduce_ms": list(trainer.grad_sync.ms),
               "allreduce_bytes": sum(p.numel() * 4 for p in leaves) + 4,
               "collectives": collectives, "mesh": str(trainer.mesh),
               "digest": _digest(leaves), "ema_digest": _digest(ema),
               "resident": frozen_bytes(trainer.model),
               "sharded": trainer.sharded is not None,
               "n_layers": cfg_model.num_layers, "adapted": len(leaves),
               "batch": trainer.params.batch_size}
        with trainer.whole():
            rec["whole"] = frozen_bytes(trainer.model)
        barrier()
        rec["exports"] = sorted(os.listdir(trainer.params.output_dir))
        if not pixart:
            rec["checkpoints"] = sorted(
                os.listdir(trainer.params.checkpoint_dir))
            # the checkpoint restores: the state moved off, then restored
            kept = [t.detach().clone() for t in leaves + ema]
            with torch.no_grad():
                for t in leaves + ema:
                    t.add_(1.0)
            trainer.global_step = 0
            trainer.restore_checkpoint()
            rec["restored"] = (trainer.global_step == MP_STEPS and all(
                torch.equal(a, b) for a, b in zip(leaves + ema, kept)))
        rec["same_step"] = mp_same_step(trainer)
        with open(os.path.join(out_dir, f"{label}-rank{rank}.json"),
                  "w") as f:
            json.dump(rec, f)
        del trainer
        if cuda:
            torch.cuda.empty_cache()
        barrier()
    if sana and cuda:
        res = mp_context_parallel(rank, world, torch.device("cuda", 0))
        with open(os.path.join(out_dir, f"context-rank{rank}.json"),
                  "w") as f:
            json.dump(res, f)
    torch.distributed.destroy_process_group()


def mp_expected_launches(label, n_layers, sp):
    """(per step, per validation CFG call) launches of one process: as one
    process's at 8 blocks (tp keeps every launch, on fewer heads), but
    under ``sp`` K3's two halves (K3s, K3a) in place of K3."""
    from yat_tpu_torch.models.sana import SanaConfig
    one, _ = sana_step_launches(SanaConfig(num_layers=n_layers), False)
    per_step = scale_launches(one, (1, 1))
    per_call = {"adaln_layernorm": 2 * n_layers + 1,
                "dot_product_attention": n_layers,
                "linear_attention": n_layers}
    for want in (per_step, per_call):
        want["linear_attention_state"] = want["linear_attention_apply"] = 0
        if sp:
            want["linear_attention_state"] = want["linear_attention"]
            want["linear_attention_apply"] = want["linear_attention"]
            want["linear_attention"] = 0
    return per_step, per_call


def check_mp_run(label, recs, out, cuda, card, sp):
    """The phase's checks on what the processes of one SANA config saw."""
    import statistics

    r0 = recs[0]
    if any(r["backend"] != "gloo" for r in recs) or \
            out.count("backend gloo (processes share a card)"
                      if cuda else "backend gloo (the CPU)") < MP_WORLD:
        fail(f"{label}: the processes should share the card over gloo "
             f"({[r['backend'] for r in recs]})")
    for what in ("digest", "ema_digest"):
        if len({r[what] for r in recs}) != 1:
            fail(f"{label}: the processes' {what[:-7] or 'leaves'} differ "
                 "after the run")
    if not all(r["restored"] for r in recs):
        fail(f"{label}: the checkpoint did not restore on every process")
    n_layers = r0["n_layers"]
    if r0["adapted"] != 2 * 8 * n_layers:
        fail(f"{label}: {r0['adapted']} adapter leaves")
    hist = r0["history"]
    if len(hist) != MP_STEPS or any(r["history"] != hist for r in recs) \
            or not all(math.isfinite(h["loss"]) for h in hist):
        fail(f"{label}: the processes' logged steps differ or are not "
             f"finite: {[r['history'] for r in recs]}")
    for h in hist:
        log(f"{label}: step {h['step']} caption rung {h['caption_len']} "
            f"global loss {h['loss']:.6f} grad_norm {h['grad_norm']:.4f} "
            f"lr {h['lr']:.3g}")
    if [r["writes"] for r in recs] != [{"checkpoint": 1, "export": 1}] + [
            {"checkpoint": 0, "export": 0}] * (len(recs) - 1) or \
            r0["exports"] != [str(MP_STEPS)] or \
            r0["checkpoints"] != [f"{MP_STEPS}.pt"]:
        fail(f"{label}: expected one export and one checkpoint, both by "
             f"rank 0: writes {[r['writes'] for r in recs]}, exports "
             f"{r0['exports']}, checkpoints {r0['checkpoints']}")
    check_same_step(label, r0["same_step"])
    rows = r0["batch"]
    per_step, per_call = mp_expected_launches(label, n_layers, sp)
    for r in recs:
        val = r["validation_counts"]
        for name, n in per_step.items():
            got = r["counts"][name] - val.get(name, 0)
            want = n * MP_STEPS if cuda else 0
            log(f"{label}: rank {r['rank']}: {name} launches {got} in the "
                f"steps (expected {n} per step x {MP_STEPS}), "
                f"{val.get(name, 0)} in validation")
            if got != want:
                fail(f"{label}: rank {r['rank']}: {name}: {got} launches "
                     f"in the steps, expected {want}")
            if name in per_call and val.get(name, 0) != (
                    per_call[name] * val["_steps"] * val["_calls"]
                    if cuda else 0):
                fail(f"{label}: rank {r['rank']}: {name}: {val.get(name)} "
                     f"launches in validation")
        times = r["step_times"][1:]
        ar, col = r["allreduce_ms"], r["collectives"]
        log(f"{label} [{card}]: rank {r['rank']} on {r['device']} ({r['mesh']})"
            f": {MP_STEPS} steps in {r['wall']:.2f} s through the entry "
            f"point (first step {r['step_times'][0]:.2f} s with the data's "
            f"first window, validation {val.get('_seconds', 0):.2f} s); "
            f"steps 2-{MP_STEPS} {statistics.mean(times):.4f} s a "
            f"step ({MP_DATA * rows / statistics.mean(times):.2f} "
            "images/s of the global batch); the gradient all-reduce "
            f"({r['allreduce_bytes']} bytes) median "
            f"{statistics.median(ar):.3f} ms over {len(ar)} calls; the tp/sp "
            f"collectives {col['calls']} calls, {col['bytes'] / 1e6:.1f} MB, "
            f"{col['seconds'] * 1e3 / MP_STEPS:.1f} ms a step (host clock, "
            f"validation's included); peak device memory "
            f"{r['peak'] / 2**30:.2f} GiB; frozen base resident "
            f"{r['resident'] / 2**20:.1f} MiB of {r['whole'] / 2**20:.1f} "
            "MiB whole")
    return r0["counts"]


def check_pixart_sp_run(label, recs, cuda, card):
    """The PixArt-Sigma ``{sp: 2}`` run's checks: equal states, finite
    logged steps, one export by rank 0, the processes' step against the
    one-process step (``check_same_step``), and each process's launches a
    step (the attention branches of the whole token count, K6/K6b for the
    self-attention over the gathered keys)."""
    import statistics

    from yat_tpu_torch.models.pixart import PixArtConfig
    r0 = recs[0]
    for what in ("digest", "ema_digest"):
        if len({r[what] for r in recs}) != 1:
            fail(f"{label}: the processes' {what[:-7] or 'leaves'} differ")
    hist = r0["history"]
    if len(hist) != PIXART_SP_STEPS or any(r["history"] != hist
                                           for r in recs) or \
            not all(math.isfinite(h["loss"]) for h in hist):
        fail(f"{label}: the logged steps differ or are not finite")
    if [r["writes"]["export"] for r in recs] != [1, 0]:
        fail(f"{label}: expected one export, by rank 0")
    check_same_step(label, r0["same_step"])
    cfg = PixArtConfig(num_layers=r0["n_layers"])
    want = dict.fromkeys(PIXART_TRAIN_KERNELS, 0)
    for h in hist:
        for name, n in pixart_step_launches(cfg, h["caption_len"]).items():
            want[name] += n
    for r in recs:
        for name, n in want.items():
            got = r["counts"][name] - r["validation_counts"].get(name, 0)
            if got != (n if cuda else 0):
                fail(f"{label}: rank {r['rank']}: {name}: {got} launches, "
                     f"expected {n}")
        times = r["step_times"][1:] or r["step_times"]
        col = r["collectives"]
        log(f"{label} [{card}]: rank {r['rank']}: steps {[h['caption_len'] for h in hist]} "
            f"rungs, losses {[round(h['loss'], 6) for h in hist]}, "
            f"{statistics.mean(times):.4f} s a step after the first; "
            f"launches {dict((k, r['counts'][k]) for k in want if want[k])}"
            f"; the sp collectives {col['calls']} calls, "
            f"{col['bytes'] / 1e6:.1f} MB, {col['seconds'] * 1e3 / len(hist):.1f}"
            f" ms a step; peak {r['peak'] / 2**30:.2f} GiB")
    return r0["counts"]


def phase_multiprocess_train(device, card, shard_args=None, cfg_extra=None,
                             timeout=600, pixart_shard=None,
                             pixart_extra=None):
    """``configs/sana_512_lora.yaml`` trained by four processes of the SANA
    entry point under ``torch.distributed.run`` (``mp_train_worker``),
    first at ``{fsdp: 2, tp: 2}``, then at ``{dp: 2, sp: 2}``, each data
    index reading its own shard (the config's two paths split between
    them) with its own caption lengths over the rungs 128/256/300; then
    the context-parallel attentions over the four; then PixArt-Sigma's
    LoRA config at ``{sp: 2}`` by two processes of its entry point.
    Returns the launch counts of rank 0 of each run, by label."""
    import yaml

    cuda = device.type == "cuda"
    out_counts = {}
    with tempfile.TemporaryDirectory() as tmp:
        shards = [os.path.join(tmp, f"shard-{r:06d}.tar")
                  for r in range(MP_DATA)]
        t0 = time.perf_counter()
        for r, path in enumerate(shards):
            write_train_shard(path, seed=10 + r,
                              **{"lengths": ((60, 300), (110, 290))[r],
                                 **(shard_args or {})})
        pix_shard = os.path.join(tmp, "pixart-000000.tar")
        pix_cfg = {k: v for k, v in pixart_train_config(
            pix_shard, os.path.join(tmp, "out-pixart"),
            steps=str(PIXART_SP_STEPS), mesh_shape={"sp": PIXART_SP_WORLD},
            **{**depth_cut("mp_pixart"), **(pixart_extra or {})}).items()
            if v is not None}
        # 12 PixArt-Sigma 512px samples, T5-XXL captions of 129-300
        # tokens (the rungs 256 and 300: K4/K4b for the cross-attention)
        pix = {"n": 12, "latent": (64, 64, 4), "dim": 4096,
               "lengths": (129, 300), **(pixart_shard or {})}
        write_train_shard(pix_shard, seed=30, **pix)
        log(f"multiprocess train: wrote {MP_DATA + 1} feature shards in "
            f"{time.perf_counter() - t0:.1f} s")
        cfg_paths = []
        for label, mesh in MP_MESHES.items():
            path = os.path.join(tmp, f"mp-{label}.yaml")
            with open(path, "w") as f:
                yaml.safe_dump(mp_train_config(shards, tmp, label, mesh,
                                               cfg_extra), f)
            cfg_paths.append(path)
        pix_path = os.path.join(tmp, "mp-pixart-sp.yaml")
        with open(pix_path, "w") as f:
            yaml.safe_dump(pix_cfg, f)
        outs = []
        for world, paths in ((MP_WORLD, cfg_paths),
                             (PIXART_SP_WORLD, [pix_path])):
            cmd = [sys.executable, "-m", "torch.distributed.run",
                   "--standalone", "--nproc_per_node", str(world),
                   os.path.abspath(__file__), "--mp-train", tmp,
                   device.type, *paths]
            t0 = time.perf_counter()
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True,
                                      timeout=timeout, cwd=tmp)
            except subprocess.TimeoutExpired as e:
                fail(f"multiprocess train: the processes outlived {timeout}"
                     f" s:\n{(e.stdout or '')[-3000:]}")
            out = proc.stdout + proc.stderr
            for line in proc.stdout.splitlines():
                if line.startswith(("[dist]", "[engine] mesh",
                                    "[engine] step")):
                    log(f"multiprocess train: {line}")
            if proc.returncode != 0:
                fail(f"multiprocess train: torchrun exited "
                     f"{proc.returncode}:\n{out[-4000:]}")
            log(f"multiprocess train: torchrun ran {len(paths)} config(s) "
                f"over {world} processes in "
                f"{time.perf_counter() - t0:.1f} s")
            outs.append(out)

        def recs_of(label, world):
            return [json.load(open(os.path.join(tmp,
                                                f"mp-{label}-rank{r}.json")))
                    for r in range(world)]
        for label, mesh in MP_MESHES.items():
            out_counts[label] = check_mp_run(
                f"multiprocess train {mesh}", recs_of(label, MP_WORLD),
                outs[0], cuda, card, sp="sp" in mesh)
        ft, dsp = (recs_of(k, MP_WORLD)[0] for k in MP_MESHES)
        # fsdp halves every leaf of two dimensions and more, tp the split
        # layers' again; the 1-D leaves and the modulation stay whole
        if not ft["sharded"] or dsp["sharded"] or not \
                ft["resident"] < 0.35 * dsp["resident"]:
            fail(f"multiprocess train: {{fsdp: 2, tp: 2}} should hold about "
                 f"a quarter of the frozen base "
                 f"({ft['resident']} of {dsp['resident']})")
        log(f"multiprocess train [{card}]: resident frozen base per "
            f"process {ft['resident'] / 2**20:.1f} MiB at {{fsdp: 2, tp: 2}} "
            f"against {dsp['resident'] / 2**20:.1f} MiB at {{dp: 2, sp: 2}} "
            "(one process holds as much)")
        out_counts["pixart-sp"] = check_pixart_sp_run(
            f"multiprocess train pixart {{sp: {PIXART_SP_WORLD}}}",
            recs_of("pixart-sp", PIXART_SP_WORLD), cuda, card)
        if cuda:
            cp = [json.load(open(os.path.join(tmp, f"context-rank{r}.json")))
                  for r in range(MP_WORLD)]
            for name in ("context_parallel", "ring"):
                err = cp[0][name]["max_abs_err"]
                ms = [round(c[name]["ms"], 3) for c in cp]
                log(f"multiprocess train [{card}]: {name} attention at "
                    f"{list(CP_SHAPE)} fp32 over {MP_WORLD} processes: "
                    f"max_abs_err {err:.3e} against one-process SDPA (tol "
                    f"{CP_TOL}), {ms} ms a call by process (host clock)")
                if not err <= CP_TOL:
                    fail(f"multiprocess train: {name} attention disagrees "
                         "with one-process attention")
    return out_counts


def main() -> None:
    import gc

    t_start = time.perf_counter()
    card = phase_device()
    import torch
    device = torch.device("cuda", 0)
    seconds = {}

    def timed(name, fn, *args, **kw):
        """Run one phase, free what it left on the card, keep its
        seconds."""
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        gc.collect()
        torch.cuda.empty_cache()
        seconds[name] = round(time.perf_counter() - t0, 1)
        return out

    timed("build", phase_build)
    kernels = timed("kernels", phase_kernels, device)
    kernels.update(timed("w8a8 kernels", phase_w8a8_kernels, device))
    timed("reference", phase_reference, device)
    timed("grad reference", phase_grad_reference, device)
    timed("pixart grad reference", phase_pixart_grad_reference, device)
    timed("int8 grad reference", phase_int8_grad_reference, device)
    timed("full-ft grad reference", phase_full_ft_grad_reference, device)
    counts = {}
    for family in ("sana", "pixart"):
        counts[family] = timed(f"serve {family}", phase_serve,
                               serve_params(), device, card, family=family,
                               profile=True)
    for family in ("sana", "pixart"):
        counts[f"pretrained_{family}"] = timed(
            f"pretrained {family}", phase_pretrained, device, card, family,
            extra={"model_config_overrides": dict(DEPTH_CUTS["pretrained"])})
    counts["train"] = timed("train", phase_train, device, card,
                            cfg_extra=depth_cut("train"))
    mp = timed("multiprocess train", phase_multiprocess_train, device, card)
    counts["mp_train"] = mp["fsdp-tp"]
    counts["mp_train_sp"] = mp["dp-sp"]
    counts["pixart_sp"] = mp["pixart-sp"]
    counts["adapter_kinds"] = timed("adapter kinds", phase_adapter_kinds,
                                    device, card,
                                    cfg_extra=depth_cut("train"))
    counts["pixart_train"] = timed("pixart train", phase_pixart_train,
                                   device, card,
                                   cfg_extra=depth_cut("train"))
    counts["int8_train"] = timed("int8 train", phase_train, device, card,
                                 cfg_extra=depth_cut("train", **INT8_KEYS),
                                 label="int8 train")
    counts["full_ft"] = timed("full fine-tune", phase_full_finetune, device,
                              card)
    counts["explore_train"] = timed(
        "explore+preserve train", phase_train, device, card,
        cfg_extra=depth_cut("train", **EXPLORE_KEYS),
        label="explore+preserve train", remat=False)
    counts["pixart_preserve_train"] = timed(
        "pixart preserve train", phase_pixart_train, device, card,
        cfg_extra=depth_cut("train", **PIXART_PRESERVE_KEYS),
        label="pixart preserve train", remat=False)
    counts.update(timed("raw images", phase_raw_images, device, card))
    counts["sd15"] = timed("serve sd15", phase_serve, serve_params(), device,
                           card, family="sd15", profile=True)
    counts["sdxl"] = timed("serve sdxl", phase_serve, serve_params(), device,
                           card, family="sdxl", px=1024, profile=True)
    timed("sd15 grad reference", phase_sd15_grad_reference, device)
    timed("single file", phase_single_file, device, card)
    for phase, fn in (("sd15 train", phase_sd15_train),
                      ("sdxl train", phase_sdxl_train)):
        for label, c in timed(phase, fn, device, card).items():
            counts[label.replace(" ", "_")] = c
    counts["sd35"] = timed("serve sd35", phase_sd35_serve, device, card)
    counts["sd35_train"] = timed("sd35 train", phase_sd35_train, device,
                                 card)
    counts["flux"] = timed("serve flux", phase_flux_serve, device, card)
    for label, c in timed("flux train", phase_flux_train, device,
                          card).items():
        counts[label.replace(" ", "_")] = c
    counts["pixeldit"] = timed("serve pixeldit", phase_pixeldit_serve,
                               device, card)
    timed("pixeldit grad reference", phase_pixeldit_grad_reference, device)
    for label, c in timed("pixeldit train", phase_pixeldit_train, device,
                          card).items():
        counts[label.replace(" ", "_")] = c
    log(f"seconds by phase: {seconds}; "
        f"{time.perf_counter() - t_start:.1f} s in all")

    rows = []
    # name: (source, the TPU kernel it replaces, the run whose launches
    # count: the serving path of its family for the forward kernels, the
    # training path of its family for the backward kernels)
    meta = {"adaln_layernorm": ("yat_tpu_torch/csrc/adaln.cu",
                                "yat_tpu/ops/norm.py:111", "sana"),
            "adaln_layernorm_bwd": ("yat_tpu_torch/csrc/adaln.cu",
                                    "yat_tpu/ops/norm.py:132", "train"),
            "dot_product_attention": ("yat_tpu_torch/csrc/softmax_attention.cu",
                                      "yat_tpu/ops/attention.py:311", "sana"),
            "dot_product_attention_bwd": (
                "yat_tpu_torch/csrc/softmax_attention_bwd.cu",
                "yat_tpu/ops/attention.py:334", "train"),
            "dot_product_attention_folded_bwd": (
                "yat_tpu_torch/csrc/softmax_attention_bwd.cu",
                "yat_tpu/ops/attention.py:209", "pixart_train"),
            "flash_attention_bwd": (
                "yat_tpu_torch/csrc/flash_attention_bwd.cu",
                "yat_tpu/ops/attention.py:122", "pixart_train"),
            "linear_attention": ("yat_tpu_torch/csrc/linear_attention.cu",
                                 "yat_tpu/ops/attention.py:424", "sana"),
            # K3's halves for token-sharded blocks: phase 17's {dp: 2,
            # sp: 2} run
            "linear_attention_state": (
                "yat_tpu_torch/csrc/linear_attention.cu",
                "yat_tpu/ops/attention.py:424", "mp_train_sp"),
            "linear_attention_apply": (
                "yat_tpu_torch/csrc/linear_attention.cu",
                "yat_tpu/ops/attention.py:424", "mp_train_sp"),
            "dot_product_attention_folded": (
                "yat_tpu_torch/csrc/softmax_attention.cu",
                "yat_tpu/ops/attention.py:186", "pixart"),
            "flash_attention": ("yat_tpu_torch/csrc/flash_attention.cu",
                                "yat_tpu/ops/attention.py:122", "pixart"),
            "w8a8_matmul": ("yat_tpu_torch/csrc/w8a8_matmul.cu",
                            "yat_tpu/ops/quant.py:168", "int8_train"),
            "w8a8_matmul_bwd": ("yat_tpu_torch/csrc/w8a8_matmul.cu",
                                "yat_tpu/ops/quant.py:191", "int8_train")}
    for name, (source, replaces, run) in meta.items():
        k = kernels[name]
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": counts[run][name]}
        # K1 launches on every path: its counts on the others beside
        for other in ("pixart", "train", "mp_train", "mp_train_sp",
                      "pixart_sp", "pixart_train",
                      "int8_train",
                      "full_ft", "explore_train", "pixart_preserve_train",
                      "raw_sana", "raw_pixart", "sd15", "sdxl",
                      "sd15_train", "sdxl_train",
                      "sdxl_train_low_vram", "sd35", "sd35_train", "flux",
                      "flux_train", "pixeldit", "pixeldit_train"):
            if other != run and name in counts.get(other, {}) \
                    and counts[other][name]:
                row[f"launches_{other}"] = counts[other][name]
        row.update({"max_abs_err": k["max_abs_err"], "ms": k["ms"],
                    "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                    "bound_by": k["bound_by"],
                    "library_ms": k["library_ms"]})
        # K5/K5b: which call library_ms times, _int_mm with the weight
        # row-major, the bf16 matmul on the dequantized weight (the path
        # without int8_w8a8), the quantize's and the GEMM's device time
        # and the host's time a call with its parts
        # K1/K3: every kernel-phase case's time and path ("cases")
        for key in ("library", "int_mm_row_major_ms", "bf16_linear_ms",
                    "quantize_ms", "gemm_ms", "host_us", "host_entry_us",
                    "host_empty_us", "cases"):
            if key in k:
                row[key] = k[key]
        rows.append(row)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mp-train"]:
        mp_train_worker(sys.argv[2], sys.argv[3], sys.argv[4:])
    else:
        main()
