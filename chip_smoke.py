#!/usr/bin/env python3
"""Smoke run of the PyTorch port (skinjax_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's paths at full width with random weights from a seed,
through the entry points a user calls: the flagship (ResNet-50 + one-hot
metadata MLP + RG-ATT, 224×224, common_dim 512, bf16), served (the inference
engine and the HTTP service) and trained (the train step and ``run_kfold``);
the same model with a DaViT-tiny tower (``skinjax_torch.DAVIT``), served
and trained at B=64; with a BEiT-v2-large tower (``skinjax_torch.BEIT``),
served and trained at B=32, and with a ViT-large tower, served; with an
MViTv2-small tower (``skinjax_torch.MVIT``), served and trained at B=64; with
a CAFormer-b36 tower (``skinjax_torch.CAFORMER``), served and trained at
B=32, and a CoaT-lite-small one (``skinjax_torch.COAT``) at B=64; the
DaViT model with its channel attention through K8 (skinjax's
``SKINJAX_CHATTN=pallas``), served and trained at B=64; with a Swin-tiny
tower (``skinjax_torch.SWIN``), served and trained at B=64, and trained
through K7's padded entry; with a NextViT-small tower
(``skinjax_torch.NEXTVIT``) on K6's BatchNorm route, served and trained at
B=64, and the CNN zoo (DenseNet-169, MobileNet-V2, EfficientNet-B0/B7,
VGG16) served and trained; the sentence datasets' tokens model (DaViT-tiny + BERT-base, and + GPT-2 small) trained at
B=32 over 512 and 256 tokens; all 18 fusion mechanisms; and the train CLI
from a dataset on disk, whose checkpoint the service then serves, and on a
sentence dataset. Phases, each printing its lines:

  1. card     nvidia-smi name and power limit, CUDA version
  2. build    nvcc builds of skinjax_torch/csrc/fusion_kernels.cu,
              augment_kernel.cu, window_attention.cu, global_attention.cu,
              pooled_attention.cu, fused_mlp.cu, channel_attention.cu and
              bn_kernels.cu, started together; seconds, ptxas registers
  3. kernels  K1-K4 against their plain PyTorch twins at the flagship shapes
              (K4 at Vd in {2048, 768, 512}), B in {1, 3, 8, 32}, fp32 (TF32
              off) and bf16 activations; the two routes of K1, K2, K4 and K3
              (the cluster kernel at the served widths: D=512, Vd in {2048,
              768, 512}, K3's K1 in {1024, 2048}; the one-block kernel at
              D=768, Vd=2560, K1=4096) each against its twin also at B=16 and
              33 (a part-empty tile, two tiles), two calls bit-identical, the
              kernel each profiled call ran the one its plan chose, the C
              entry point refusing the cluster route at the one-block width;
              ptxas's spills of mlp_head_cluster_kernel; K5 bit for bit its twin at B in
              {1, 7, 128} (224×224), a 300×400 batch and a 37×45 one (scalar
              loads), bf16 and fp32, with drawn parameters and with every
              gate on, two calls bit-identical, and its normalize against the
              IEEE quotient for every value clip01 returns; K7 forward and
              backward against their twins at DaViT-tiny's four stage shapes,
              B in {1, 64}, bf16 and fp32, and with a relative-position bias
              and 64 per-window masks (dbias checked), two bf16 backward
              calls bit-identical at stage 1 (B=64) and with bias + masks;
              K12 forward (o and P),
              stored-P backward and recompute backward (dq, dk, dv, dbias)
              against their twins at BEiT-large's shape with a bias,
              ViT-large's, BERT-base's at 128 and 512 tokens with a padding
              mask and dropout multiplier, GPT-2's at 1024 tokens with the
              causal bias and a padding mask, and N=50 with all three, bf16
              and fp32; the recompute backward against the stored-P one where
              P is within the 256 MB limit, two bf16 forward calls at
              BEiT-large (P emitted) and BERT-base T=512 bit-identical, the
              forward's o against the recompute rows kernel's of (bit for
              bit, logged), two bf16 recompute calls at
              BERT-base T=512 bit-identical, and two bf16 stored-P backward
              calls at BEiT-large (bias gradient summed in groups) and
              BERT-base (kmask + pmult); K11 forward (o and P) and backward
              (dq, dk, dv, dbias_h, dbias_w) against their twins at
              MViTv2-small's seven attention shapes (B=64 bf16, B=8 fp32), a
              rectangular key grid with a ragged query edge and a one-row
              key grid too wide for the bias sums in shared memory, two bf16
              forward calls at stage 0 and two backward calls at stages 0 and
              2 bit-identical; K10 and K9
              forward and backward (dx, dw1, dw2 and ds/db or db1/db2)
              against their twins at every (D, H) of CAFormer-b36 and
              CoaT-lite-small with 1000 tokens, and K10 at CAFormer-b36's
              stage-0 shape at B=32, bf16 and fp32: two backward calls
              bit-identical (and at the record shapes, CAFormer-b36's stage
              2 at B=32 and CoaT-lite-small's stage 3 at B=64), zero dy rows
              adding nothing, the wrappers
              raising on a bad dtype or width; K8 forward and backward (y,
              dqkv, of) against their twins at DaViT-tiny's four stage shapes
              (B=64 bf16, B=8 fp32), two forward and two backward calls
              bit-identical; K7's
              padded forward and its backward core (K12's recompute kernel
              with the window mask: dq, dk, dv, of, dbias) against their
              twins at Swin-tiny's four stage shapes (B=64 bf16, B=8 fp32)
              with the relative-position bias and, at stages 0-2, the
              shifted windows' mask, two backward calls bit-identical; K6
              (bn_stats, bn_grad_stats) against its twins, as phase 13f says
  4. slice    fused against plain engine; launches per fused forward; the
              fp32 engine on the card against the same model on the CPU
  5. server   the engine run_service builds, served on a localhost port:
              /health and four POST /predict/ (one needs a resize); K1-K3's
              launches are counted over them
  6. train    the flagship train step at B=128 (augment on, bf16 autocast):
              finite loss, the loss falls over 10 steps on one batch, frozen
              mode keeps the image encoder bit-identical while its BatchNorm
              statistics move, K5 launches once per step; one fp32 step of a
              small model on the card against the same step on the CPU
  7. fold     run_kfold, k=2, 2 epochs, B=32, on synthetic 224×224 data;
              K5's launches are counted over it; its artifacts are checked
  8. times    engine p50/p95 fused and plain; K1-K3 and K5 against their
              twins, bounds and (K1-K3) the same function as PyTorch calls it,
              K1-K3 (K3 also at metablock's 2048 → 512 → 256 → 6) with their
              weights L2-warm and L2-cold; train images/s unfrozen
              and frozen; the augment
              stage with and without K5; a profiled train step
  9. davit    the DaViT model: fused against plain engine (K7 launched 6
              times per forward), the fp32 engine on the card against the CPU;
              run_service with CNN_MODEL_NAME=davit_tiny; the train step at
              B=64 (augment on, bf16): the loss falls over 10 steps on one
              batch, K7 6 + 6 launches per unfrozen step and 6 + 0 per frozen
              one; one fp32 step of a small DaViT on the card against the CPU
 10. times    the DaViT engine's p50/p95; DaViT train images/s unfrozen and
              frozen; a profiled DaViT train step. (K12's times at BEiT-large's
              shape, its forward's at every shape (P emitted where the
              stored-P route emits it), its stored-P backward's also at every
              other shape within the stored-P limit, split by kernel, its
              recompute backward's at BERT-base's T=512 one, and
              K7's at each stage and with bias + masks at Swin-tiny's stage
              0, against their twins and bounds, with
              F.scaled_dot_product_attention on the same q, k, v, forward and
              backward, as a yardstick: each time's share of its bound and its
              factor against the same run's SDPA call; and K4's at each Vd,
              run right after phase 3.)
 11. beit     the BEiT-v2-large model (307 M parameters drawn once on the
              CPU): fused against plain engine (K12 launched 24 times per
              forward); run_service with CNN_MODEL_NAME=beitv2_large_patch16_224;
              the train step at B=32 (augment on, bf16): the loss falls over
              10 steps on one batch, K12 24 + 24 launches per unfrozen step and
              24 + 0 per frozen one; one fp32 step of a small BEiT on the card
              against the CPU; the engine's p50/p95; train images/s unfrozen
              and frozen; a profiled train step
 12. vit      the ViT-large model served: fused against plain engine, K12
              (no bias) launched 24 times per forward at B=1 and 8
 13. mvit     the MViTv2-small model: fused against plain engine (K11
              launched 16 times per forward), the fp32 engine on the card
              against the CPU; run_service with CNN_MODEL_NAME=mvitv2_small;
              the train step at B=64 (augment on, bf16): the loss falls over
              10 steps on one batch, K11 16 + 16 launches per unfrozen step and
              16 + 0 per frozen one; one fp32 step of a small MViTv2 on the
              card against the CPU; the engine's p50/p95; train images/s
              unfrozen and frozen (mvitv2_small_images_per_sec) and a
              profiled train step. (K11's
              times at the seven shapes, against twins, bounds and
              F.scaled_dot_product_attention with the expanded bias, forward
              and backward, its backward split by kernel at stages 0 and 2,
              run right after phase 3.)
 13b. caformer the CAFormer-b36 model: fused against plain engine (K10
              launched 36 times and K12 21 times per forward), the fp32 engine
              on the card against the CPU; run_service with
              CNN_MODEL_NAME=caformer_b36; the train step at B=32 (augment on,
              bf16): the loss falls over 10 steps on one batch, K10 36 + 36
              and K12 21 + 21 launches per unfrozen step, 36 + 0 and 21 + 0
              frozen; one fp32 step of a small CAFormer on the card against
              the CPU; the engine's p50/p95; train images/s unfrozen and frozen
              (caformer_b36_images_per_sec) and a profiled step with K10's and
              K12's device-time shares
 13c. coat    the CoaT-lite-small model, the same at B=64 with K9 16 + 16
              launches per unfrozen step (coat_lite_small_images_per_sec).
              (K10's and K9's times at each model's four shapes, against
              their twins, bounds and the unfused F.linear → activation →
              F.linear chain, forward and backward, with each backward
              launch's device time, run right after phase 3.)
 13d. davit+k8 the DaViT model with SKINJAX_CHATTN=pallas: run_service (K8
              6 launches a request), the train step at B=64 (the loss falls,
              K8 6 + 6 and K7 6 + 6 launches per unfrozen step, 6 + 0 frozen),
              one fp32 step of a small DaViT on the card against the CPU, and
              the train step A/B'd against the plain channel attention in
              turns (wall time and a profiled step's device time)
 13e. swin    the Swin-tiny model: fused against plain engine (K7 with the
              relative-position bias and the shifted mask launched 12 times
              per forward), the fp32 engine on the card against the CPU;
              run_service with CNN_MODEL_NAME=swin_tiny_patch4_window7_224;
              the train step at B=64: the loss falls, K7 12 + 12 per unfrozen
              step, 12 + 0 frozen; a small Swin's fp32 step on the card
              against the CPU; swin_tiny_images_per_sec and a profiled step;
              then swin_tiny(fused_attn=True, strip_attn=False): the train
              step at B=64 (K7-pad 12 forwards + 12 recompute backward cores
              with the window mask a step), a small padded Swin's fp32 step on
              the card against the CPU, and the two routes' train steps A/B'd.
              (K8's and K7-pad's times at each stage, against their twins,
              bounds and a library yardstick, run right after phase 3.)
 13f. batchnorm  NextViT-small (``skinjax_torch.NEXTVIT``) with its 61
              BatchNorms fused (``fuse_batch_norms``: K6 in train mode): fused
              against plain engine at B=1 and 8 (K6 launching nothing in eval
              mode), the fp32 engine on the card against the CPU, run_service;
              the train step at B=64: the loss falls, K6 61 stats + 61 grad
              stats a step, 61 + 0 frozen; a small fused NextViT's fp32 step on
              the card against the CPU's twin route; train images/s and a
              profiled step; its train step and the flagship's (B=128) A/B'd
              against the native BatchNorm in turns (nextvit_small_images_per_sec
              on both routes); DenseNet-169, MobileNet-V2, EfficientNet-B0/B7 and
              VGG16 on the K6 route: a served forward and the train step
              (densenet169_images_per_sec). (K6's checks, at ResNet-50's first
              BN at B=128 and NextViT-small's stem, stage-3 and pooled-token
              BNs at B=64, bf16, fp32, odd rows and odd channels, and the
              train route against the twin route, run in phase 3; its times,
              with torch.batch_norm_stats and batch_norm_backward_reduce as
              yardsticks, right after.)
 14. mechanisms  all 18 at full width around one ResNet-50 tower: the 10 the
              engine fuses, fused against plain with their launches per fused
              forward (metablock: K4 1 + K3 1; …+metablock: K1 4 + K2 2 + K4 1);
              the other 8, the plain forward
 15. cli      a PAD-UFES-20-shaped dataset written to a temporary directory
              (96 rows, 300×400 PNGs); python -m skinjax_torch.tools.train_cli
              as a subprocess (metablock and …+metablock × ResNet-50 × 2 folds,
              1 epoch, B=32): its fold results and artifacts; run_service with
              one of its …+metablock checkpoints answers four POST /predict/
              with raw CSV lines, K4's launches counted over them; the CLI's
              wall time and the PNG decode rate; the metablock engine's p50/p95

 16. sentence the tokens model (DaViT-tiny + BERT-base, RG-ATT, 768 text
              features, bf16, B=32, the sentence augment recipe, drawn once on
              the CPU): 10 train steps on one batch at T=512, unfrozen (K12 12
              forwards + 12 recompute backwards, K7 6 + 6, K5 0 a step; the
              loss falls), at T=256 with the text tower frozen (K12 12 + 0;
              the tower bit-identical; sentence_frozen_images_per_sec), both
              timed and profiled; GPT-2 small at T=512 unfrozen (12 + 12
              recompute); one fp32 step of a small BERT tokens model on the
              card against the CPU, on the recompute route
 17. sentence cli  python -m skinjax_torch.tools.train_cli as a subprocess on
              a sentence dataset it writes (96 rows with a sentence column, a
              WordPiece vocab.txt, TEXT_MODEL_NAME=bert-base-uncased,
              MAX_SEQ_LENGTH=512; DaViT-tiny + BERT-base, 2 folds × 1 epoch,
              B=32, unfrozen); its first checkpoint reloaded and evaluated
 18. models   TabTransformer, static-embedding, sequence fusion, the
              baselines, the batching service (``--models`` below)
 19. xai      the XAI slice (``--xai`` below)
 20. nas      the NAS slice (``--nas`` below)

Any failure exits non-zero. The second-to-last line is the kernels' JSON
record; the last line is {"ok": true, "device": {...}}. Exits non-zero, with
no result, when CUDA is not available or the package is not beside it.

    python3 chip_smoke.py --attention

builds the three attention sources only and runs the checks and times of
K7's strip pair, K12 (with the recompute backward's split by kernel at
BERT-base T=512: with
kmask + pmult, kmask alone and neither), K11 and the K7-pad core, and the
bf16 stored-P backwards' split by kernel (K12 at BEiT-large over bias-group
counts, K11 at stages 0 and 2): the quick loop for work on those kernels
(last line {"ok": true, "attention": true}).

    python3 chip_smoke.py --k8

builds csrc/channel_attention.cu only and runs K8's checks (DaViT-tiny's four
stages, bf16 at B=64 and fp32 at B=8, two forward and two backward calls
bit-identical; bf16 at four heads, which takes the CUDA-core kernels) and
times (per call and by kernel against the twin, the bound and the plain
DaViTChannelAttention, device time against device time) alone (last line
{"ok": true, "k8": true}).

    python3 chip_smoke.py --fusion

builds csrc/fusion_kernels.cu and augment_kernel.cu only and runs K1-K5's
checks and times, the flagship served (fused against plain, launches per
forward, the engine's p50 in turns) and trained (K5 once a step) and the
augment stage with and without K5 (last line {"ok": true, "fusion": true}).

    python3 chip_smoke.py --mlp

builds csrc/fused_mlp.cu only and runs K9's and K10's checks (every shape,
bf16 and fp32, two backward calls bit-identical at the record shapes) and
times (per call, device time by kernel, bound, the unfused chain, a train
step's sums) alone (last line {"ok": true, "mlp": true}).

    python3 chip_smoke.py --xai

builds csrc/fusion_kernels.cu, fused_mlp.cu, global_attention.cu and
window_attention.cu and runs the XAI slice alone (phase 19; the whole run
runs it last): Grad-CAM and Grad-CAM++ at B=2 on the flagship, ViT-base
(CLS pooling: the delta's gradient goes back through the last block's K12,
forward with P and stored-P backward), CoaT-lite-small (the last serial
block's K9 forward and backward) and DaViT-tiny (K7 forward only), fp32 on
the card against the CPU, bf16 under autocast against the card's fp32, each
Grad-CAM's launches counted; Score-CAM on the flagship at B=1, exact (2048
channels) and top-64, the top-64 map on the card against the CPU; the XAI
app as run_service serves it with XAI=1 (three POSTs: the prediction is
engine.predict's, K1/K2/K3 4/2/1 a request, an overlay PNG, the latency
split); python -m skinjax_torch.tools.xai_cli missing-data and flip-rate as
subprocesses on phase 15's dataset; and the missing-data sweep (5 folds × 6
rates over 2298 rows, B=64) timed (last line {"ok": true, "device": ...},
after a JSON summary line).

    python3 chip_smoke.py --nas

builds csrc/augment_kernel.cu and runs the NAS slice alone (phase 20; the
whole run runs it after the XAI slice): the population step of four small
candidates (every mechanism, 16×16, fp32) on the card against the CPU, and
the card's population forward against each candidate's own DynamicCNN;
eight full-width candidates of the search space (10 blocks, 5×5 kernels,
pooling, one of them the space's maximum) as one vmapped bucket at B=32,
224×224, bf16 images: 2 + 10 population steps timed against the same
candidates trained one at a time through the train step, peak memory
against the supernet's estimate, K5 once a population step; and the NAS
CLI's entry point twice, REINFORCE over populations of 4 on the synthetic
fixture, then BO's sequential path and a 5-fold retrain on a
PAD-UFES-20-like dataset from disk (last line {"ok": true, "device": ...},
after a {"nas_launches": ...} line).
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import threading
import time
import urllib.request
import uuid
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

KERNELS = {  # name -> the Pallas TPU kernel it replaces (file:line)
    "seq1_attention": "skinjax/ops/pallas/fusion_kernels.py:66",
    "gated_residual_seq1": "skinjax/ops/pallas/fusion_kernels.py:105",
    "metablock_film": "skinjax/ops/pallas/fusion_kernels.py:142",
    "mlp_head": "skinjax/ops/pallas/fusion_kernels.py:178",
}
K4 = "metablock_film"
# K4's (Du, Vd) on the main paths: metablock on ResNet-50's and on DaViT's raw
# features, and …+metablock on the cross-attended pair
K4_WIDTHS = (2048, 768, 512)
K4_DU = 512
K5 = "fused_color_stage"
K5_REPLACES = "skinjax/ops/pallas/augment_kernel.py:119"
K7 = {  # name -> the Pallas TPU function it replaces (file:line)
    "window_attention_fwd": "skinjax/ops/pallas/window_attention.py:645",
    "window_attention_bwd": "skinjax/ops/pallas/window_attention.py:828",
}
K12 = {  # name -> the Pallas TPU function it replaces (file:line)
    "global_attention_fwd": "skinjax/ops/pallas/global_attention.py:224",
    "global_attention_bwd": "skinjax/ops/pallas/global_attention.py:367",
    "global_attention_bwd_recompute": "skinjax/ops/pallas/window_attention.py:351",
}
K12_RECOMPUTE = "global_attention_bwd_recompute"
K8 = {  # name -> the Pallas TPU function it replaces (file:line)
    "channel_attention_fwd": "skinjax/ops/pallas/channel_attention.py:201",
    "channel_attention_bwd": "skinjax/ops/pallas/channel_attention.py:201",
}
K7_PAD = "window_attention_pad_fwd"
K7_PAD_REPLACES = "skinjax/ops/pallas/window_attention.py:199"
# the padded entry's backward core: K12's recompute kernel with the window
# mask (its launches count as K12_RECOMPUTE's); the record's name for it
K7_PAD_BWD = "global_attention_bwd_recompute (window mask)"
K7_PAD_BWD_REPLACES = "skinjax/ops/pallas/window_attention.py:351"
K11 = {  # name -> the Pallas TPU function it replaces (file:line)
    "pooled_attention_fwd": "skinjax/ops/pallas/pooled_attention.py:169",
    "pooled_attention_bwd": "skinjax/ops/pallas/pooled_attention.py:208",
}
K9 = {  # name -> the Pallas TPU function it replaces (file:line)
    "mlp_gelu_fwd": "skinjax/ops/pallas/fused_mlp.py:133",
    "mlp_gelu_bwd": "skinjax/ops/pallas/fused_mlp.py:154",
}
K10 = {  # name -> the Pallas TPU function it replaces (file:line)
    "mlp_star_fwd": "skinjax/ops/pallas/fused_mlp.py:270",
    "mlp_star_bwd": "skinjax/ops/pallas/fused_mlp.py:291",
}
K6 = {  # name -> the Pallas TPU function it replaces (file:line)
    "bn_stats": "skinjax/ops/pallas/bn_kernels.py:62",
    "bn_grad_stats": "skinjax/ops/pallas/bn_kernels.py:106",
}
SOURCE = "skinjax_torch/csrc/fusion_kernels.cu"
K5_SOURCE = "skinjax_torch/csrc/augment_kernel.cu"
K7_SOURCE = "skinjax_torch/csrc/window_attention.cu"
K12_SOURCE = "skinjax_torch/csrc/global_attention.cu"
K11_SOURCE = "skinjax_torch/csrc/pooled_attention.cu"
MLP_SOURCE = "skinjax_torch/csrc/fused_mlp.cu"
K8_SOURCE = "skinjax_torch/csrc/channel_attention.cu"
K6_SOURCE = "skinjax_torch/csrc/bn_kernels.cu"
BUILDS = {"fusion_kernels": SOURCE, "augment_kernel": K5_SOURCE, "window_attention": K7_SOURCE,
          "global_attention": K12_SOURCE, "pooled_attention": K11_SOURCE,
          "fused_mlp": MLP_SOURCE, "channel_attention": K8_SOURCE, "bn_kernels": K6_SOURCE}
# each K1-K4 call's kernel at the flagship's widths; all four run on
# thread-block clusters there (ops/fusion_kernels.py seq1_attention_plan,
# gated_residual_plan, metablock_film_plan, mlp_head_plan), at K1_BLOCK_D
# (K1, K2), K4_BLOCK_VD (K4) and K3_BLOCK_K1 (K3) on their one-block kernels
KERNEL_NAMES = {"seq1_attention": "seq1_cluster_kernel",
                "gated_residual_seq1": "gated_residual_cluster_kernel",
                "metablock_film": "metablock_film_cluster_kernel",
                "mlp_head": "mlp_head_cluster_kernel"}
K1_BLOCK_KERNEL = "seq1_attention_kernel"
K1_BLOCK_D = 768  # a width K1's and K2's cluster routes do not take (above 512)
K2_BLOCK_KERNEL = "gated_residual_kernel"
K4_BLOCK_KERNEL = "metablock_film_kernel"
# a width K4's cluster route does not take (above 16 CTAs of 128 columns):
# MetaBlock on EfficientNet-B7's 2560-wide feature
K4_BLOCK_VD = 2560
K3 = "mlp_head"
# K3's input widths K1 on the main paths (→ 512 → 256 → 6): the flagship's and
# every fc_fusion mechanism's pair of 512-wide features, and metablock's head
# on ResNet-50's raw 2048-wide feature
K3_WIDTHS = (1024, 2048)
K3_HEAD = (512, 256, 6)  # N1, N2, N3
# a width K3's cluster route does not take (8 rows of x do not fit beside its
# ring): metablock's head on VGG16's 4096-wide feature
K3_BLOCK_K1 = 4096
BLOCK_KERNELS = {"seq1_attention": K1_BLOCK_KERNEL, "gated_residual_seq1": K2_BLOCK_KERNEL,
                 K4: K4_BLOCK_KERNEL, K3: "mlp_head_kernel"}
# the widths each route check runs at (the served ones on the cluster
# kernel, then one on the one-block kernel) and the rows a cluster tile takes
ROUTE_WIDTHS = {"seq1_attention": (512, K1_BLOCK_D), "gated_residual_seq1": (512, K1_BLOCK_D),
                K4: (*K4_WIDTHS, K4_BLOCK_VD), K3: (*K3_WIDTHS, K3_BLOCK_K1)}
CLUSTER_ROWS = {"seq1_attention": (1, 8, 32), "gated_residual_seq1": (1, 8, 16), K4: (1, 8, 32),
                K3: (1, 8, 16)}
K5_KERNELS = ["color_stage_kernel"]  # each K5 call's kernel
# each bf16 K7 call's kernels (a call with a bias adds dbias_reduce_kernel);
# the forward and backward run on the tensor cores (their fp32 instantiations
# keep wa_fwd_kernel + proj_kernel and wa_bwd_kernel: K7_F32)
K7_KERNELS = {"window_attention_fwd": ["wa_fwd_mma_kernel", "wa_proj_mma_kernel"],
              "window_attention_bwd": ["wa_bwd_mma_kernel"]}
K7_F32 = ["wa_fwd_kernel", "proj_kernel", "wa_bwd_kernel"]
# each bf16 K12 call's kernels at BEiT's shape (the stored-P backward's last
# one adds the bias gradient's group planes, in tiles, into dbias's layout;
# without a bias gradient it is not launched); the forward and both
# backwards run on the tensor cores (their fp32 instantiations keep
# ga_fwd_kernel, ga_bwd_dq_kernel and ga_bwd_dkv_kernel, ga_bwd_rows_kernel
# and ga_bwd_cols_kernel)
K12_KERNELS = {"global_attention_fwd": ["ga_fwd_mma_kernel"],
               "global_attention_bwd": ["ga_bwd_p_rows_mma_kernel", "ga_bwd_p_cols_mma_kernel",
                                        "ga_dbias_tiles_kernel"],
               K12_RECOMPUTE: ["ga_bwd_rows_mma_kernel", "ga_bwd_cols_mma_kernel"]}
# each bf16 K11 call's kernels (the fp32 forward keeps pa_fwd_kernel, the
# fp32 backward pa_bwd_dq_kernel and pa_bwd_dkv_kernel)
K11_KERNELS = {"pooled_attention_fwd": ["pa_fwd_mma_kernel"],
               "pooled_attention_bwd": ["pa_bwd_rows_mma_kernel", "pa_bwd_cols_mma_kernel"]}
# each bf16 fused-MLP call's kernels (K9 and K10 alike); a forward whose
# token tiles are too few to fill the card also sums its hidden splits
# (MLP_SPLIT). Both run on the tensor cores: the forward in one launch, the
# backward's hidden planes, dx, dW, then the fixed-order sums; the fp32
# instantiations keep the CUDA-core kernels (MLP_F32_FWD, MLP_F32_BWD)
MLP_KERNELS = {"fwd": ["mlp_fwd_wgmma_kernel"],
               "bwd": ["mlp_bwd_act_wgmma_kernel", "mlp_bwd_dx_wgmma_kernel",
                       "mlp_bwd_dw_wgmma_kernel", "mlp_bwd_colsum_kernel"]}
MLP_F32_FWD = ["mlp_fwd_kernel"]
MLP_F32_BWD = ["mlp_bwd_dx_kernel", "mlp_bwd_dw_kernel", "mlp_bwd_reduce_kernel"]
MLP_SPLIT = "mlp_split_reduce_kernel"
# each bf16 K8 call's kernels at 32 channels a head and a multiple of 3
# heads (DaViT's), on the tensor cores but the softmax: the segments' partial sums (the backward's
# also storing q, k, v, do), the softmax, then the forward's q, of and fused
# output projection or the backward's gradients; the fp32 instantiations
# and bf16 at other head counts keep the CUDA-core kernels (K8_F32: forward
# partial, softmax, out, proj; backward partial, softmax, grad)
K8_KERNELS = {"channel_attention_fwd": ["ca_partial_mma_kernel", "ca_softmax_kernel",
                                        "ca_out_mma_kernel"],
              "channel_attention_bwd": ["ca_partial_mma_kernel", "ca_softmax_kernel",
                                        "ca_grad_mma_kernel"]}
K8_F32 = ["ca_partial_kernel", "ca_softmax_kernel", "ca_out_kernel", "ca_proj_kernel",
          "ca_grad_kernel"]
# the padded entry's forward, and its backward core with a bias gradient
# summed over groups of windows
K7_PAD_KERNELS = {K7_PAD: K7_KERNELS["window_attention_fwd"],
                  K7_PAD_BWD: [*K12_KERNELS[K12_RECOMPUTE], "ga_dbias_reduce_kernel"]}
# each K6 call's two launches (the partial sums, then their reduction)
K6_KERNELS = ["bn_partial_kernel", "bn_reduce_kernel"]
KERNEL_SYMBOLS = (*KERNEL_NAMES.values(), *BLOCK_KERNELS.values(), *K5_KERNELS, *K7_F32,
                  *K6_KERNELS, "dbias_reduce_kernel", "ga_fwd_kernel",
                  "ga_bwd_dq_kernel", "ga_bwd_dkv_kernel", "ga_bwd_rows_kernel",
                  "ga_bwd_cols_kernel", *K12_KERNELS[K12_RECOMPUTE],
                  *K12_KERNELS["global_attention_bwd"], "pa_fwd_kernel",
                  *K11_KERNELS["pooled_attention_fwd"], "pa_bwd_dq_kernel", "pa_bwd_dkv_kernel",
                  *K11_KERNELS["pooled_attention_bwd"],
                  *MLP_KERNELS["fwd"], *MLP_KERNELS["bwd"], *MLP_F32_FWD, *MLP_F32_BWD,
                  MLP_SPLIT,
                  *K8_KERNELS["channel_attention_fwd"], *K8_KERNELS["channel_attention_bwd"],
                  *K8_F32)
# the card's published peaks (H100 SXM data sheet): device memory, float32
# outside the tensor cores, dense bf16 on the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12
# DaViT-tiny's window attention at 224×224: (map side, channels, heads) per
# stage; window 7, 32 channels a head
K7_STAGES = ((56, 96, 3), (28, 192, 6), (14, 384, 12), (7, 768, 24))
K7_BATCHES = (1, 64)
# K7 with a relative-position bias (B, map side, channels, heads, bias,
# shifted-window masks): a few windows at stage 0 (one a bias block), a
# count of windows that the bias blocks do not divide (320 over 256), and
# Swin-tiny's four stages at its train batch, where a bias block sums dbias
# over 16, 4, 1 and 1 windows (the last stage, one window a map, unshifted)
K7_BIAS_CASES = ((4, 56, 96, 3, True, True), (5, 56, 96, 3, True, True),
                 (64, 56, 96, 3, True, True), (64, 28, 192, 6, True, True),
                 (64, 14, 384, 12, True, True), (64, 7, 768, 24, True, False))
WINDOW = 7
K7_PER_FORWARD = 6  # one per spatial block: depths (1, 1, 3, 1)
K7_SERVED = {"window_attention_fwd": K7_PER_FORWARD, "window_attention_bwd": 0,
             "window_attention_pad_fwd": 0}
SMALL_DAVIT = "davit-smoke-small"  # dims (64, 128), depths (1, 1), heads (2, 4)
# DaViT-tiny's channel attention at 224×224: (tokens, channels, heads) per
# stage, 32 channels a head; one ChannelBlock per spatial block
K8_STAGES = ((3136, 96, 3), (784, 192, 6), (196, 384, 12), (49, 768, 24))
K8_F32_BATCH = 8
# bf16 at 32 channels a head but 4 heads (DaViT-base's layout), which 3 does
# not divide: the CUDA-core route, (B, tokens, channels, heads)
K8_CUDA_CORE_BF16 = (8, 784, 128, 4)
K8_PER_FORWARD = K7_PER_FORWARD
K8_ON = {"SKINJAX_CHATTN": "pallas"}  # skinjax's knob, which the port reads
# K8's fp32 outputs: |kernel - twin| within this share of max(1, max |twin|).
# Its scores sum N products (3136 at stage 0) whose partial sums reach ~100
# in another order than the twin's, ~sqrt(N)·|s|·2^-24 ≈ 2e-4 apart, and the
# scale puts that into a softmax exponent of ~10: y and of moved by ~1e-4 of
# their scale on the card (bf16 keeps BF16_TOL and MLP_GRAD_TOL)
K8_F32_TOL = 1e-3
# Swin-tiny's window attention at 224×224: (map side, channels, heads,
# shifted) per stage; window 7, 32 channels a head; the last stage's 7×7 map
# is one window, so it never shifts. 12 blocks: depths (2, 2, 6, 2)
SWIN_STAGES = ((56, 96, 3, True), (28, 192, 6, True), (14, 384, 12, True), (7, 768, 24, False))
SWIN_PER_FORWARD = 12
K7_PAD_F32_BATCH = 8
SMALL_SWIN = "swin-smoke-small"  # dims (64, 128), depths (2, 2), heads (2, 4), 56×56
SMALL_SWIN_PADDED = "swin-smoke-small-padded"  # the same through the padded entry
SWIN_PADDED = "swin-tiny-padded"  # swin_tiny with fused_attn=True, strip_attn=False
# K12's shapes: (B, N, C, heads, bias, kmask, pmult); bias True is a bias with a
# gradient, CAUSAL GPT-2's causal mask as a bias without one. BEiT-large and
# ViT-large at 224×224 and their train batch; BERT-base at 128 tokens and at
# the reference's max_length 512 at its train batch, with a padding mask and
# broadcast dropout; GPT-2 at its train shape (T=512, B=32: causal bias, key
# mask and dropout) and at its 1024 positions; a sequence that is not a
# multiple of 16; CAFormer-b36's attention stages at its train batch (32
# channels a head, no bias, no mask)
CAUSAL = "causal"
K12_SHAPES = {"beitv2-large": (32, 197, 1024, 16, True, False, False),
              "vit-large": (32, 197, 1024, 16, False, False, False),
              "bert-base": (8, 128, 768, 12, False, True, True),
              "bert-base-T512": (32, 512, 768, 12, False, True, True),
              "gpt2-T512": (32, 512, 768, 12, CAUSAL, True, True),
              "gpt2-T1024": (8, 1024, 768, 12, CAUSAL, True, False),
              "n50": (4, 50, 256, 4, True, True, True),
              "caformer-b36-s3": (32, 196, 512, 16, False, False, False),
              "caformer-b36-s4": (32, 49, 768, 24, False, False, False)}
K12_PER_FORWARD = 24  # one per block of BEiT-large and ViT-large
K12_SAME_SHAPE = "bert-base-T512"  # where two recompute calls must be bit-identical
# where two bf16 forward calls must be bit-identical: P emitted with a bias,
# and kmask + pmult without P
K12_FWD_SAME_SHAPES = ("beitv2-large", "bert-base-T512")
# where the forward without P is held against the twin and, in bf16, against
# the o of the call with P, bit for bit (its own shared memory; no P staged)
K12_NO_P_SHAPES = ("beitv2-large", "bert-base-T512")
# where two bf16 stored-P backward calls must be bit-identical: the bias
# gradient summed over groups of batches, and kmask + pmult
K12_P_SAME_SHAPES = ("beitv2-large", "bert-base")
K12_SERVED = {"global_attention_fwd": K12_PER_FORWARD, "global_attention_bwd": 0, K12_RECOMPUTE: 0}
VIT_LARGE = "vit_large_patch16_224"
SMALL_BEIT = "beit-smoke-small"  # width 256, depth 2, 4 heads (64 channels a head), 224×224
# MViTv2-small's attention shapes at 224×224, 96 channels a head: label ->
# (heads, Nq, (Kh, Kw), blocks of that shape); 16 blocks a forward. skinjax
# chunks stage 0's queries and runs the stage-1 transition in XLA at B=64;
# K11 takes every block whole. Then a rectangular key grid with a ragged
# query edge, to catch swapped bias indices
K11_SHAPES = {"stage0": (1, 3136, (14, 14), 1), "stage1-transition": (2, 784, (28, 28), 1),
              "stage1": (2, 784, (14, 14), 1), "stage2-transition": (4, 196, (28, 28), 1),
              "stage2": (4, 196, (14, 14), 10), "stage3-transition": (8, 49, (14, 14), 1),
              "stage3": (8, 49, (7, 7), 1)}
K11_RAGGED = (3, 2, 37, (5, 7))  # (B, heads, Nq, (Kh, Kw))
# a one-row key grid whose bias accumulators (Kh + Kw floats a query row)
# do not fit beside the bf16 backward's tiles in shared memory: the rows
# kernel sums them in the output rows instead
K11_WIDE = (2, 2, 40, (1, 1000))
K11_HD = 96
K11_F32_BATCH = 8
K11_RECORD = "stage2"  # the record line's shape: 10 of the 16 blocks
K11_SAME_SHAPE = "stage0"  # where two forward calls must be bit-identical
# where two bf16 backward calls must be bit-identical
K11_BWD_SAME_SHAPES = ("stage0", "stage2")
K11_PER_FORWARD = sum(n for _, _, _, n in K11_SHAPES.values())
K11_SERVED = {"pooled_attention_fwd": K11_PER_FORWARD, "pooled_attention_bwd": 0}
SMALL_MVIT = "mvit-smoke-small"  # dims (96, 192), depths (1, 1), heads (1, 2), 64×64
# The fused token MLPs' shapes at 224×224: label -> (tokens an image, D, H,
# blocks of that shape), D2 = D. CAFormer-b36's K10 on 56², 28², 14², 7²
# tokens (36 blocks); CoaT-lite-small's K9 on the same maps plus each stage's
# cls token (16 blocks). A call's T is the batch times the tokens an image.
K10_SHAPES = {"stage0": (3136, 128, 512, 3), "stage1": (784, 256, 1024, 12),
              "stage2": (196, 512, 2048, 18), "stage3": (49, 768, 3072, 3)}
K9_SHAPES = {"stage1": (3137, 64, 512, 3), "stage2": (785, 128, 1024, 4),
             "stage3": (197, 320, 1280, 6), "stage4": (50, 512, 2048, 3)}
MLP_CHECK_T = 1000  # the checks' reduced token count: a multiple of no tile
K10_PER_FORWARD = sum(n for _, _, _, n in K10_SHAPES.values())
K9_PER_FORWARD = sum(n for _, _, _, n in K9_SHAPES.values())
K12_CAFORMER = 21  # CAFormer-b36's attention blocks: stages 3 and 4
# the record line's shapes: K10 at CAFormer-b36's stage 2 (18 of the 36
# blocks), K9 at CoaT-lite-small's stage 3 (6 of the 16)
MLP_RECORD = {"mlp_star": "stage2", "mlp_gelu": "stage3"}
# the weight and bias gradients: |kernel - twin| within this share of
# max(1, max |twin|) (skinjax's gradient check): fp32 sums over up to 10^5
# tokens in another order, and in bf16 an h or dpre that rounds the other way
MLP_GRAD_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
SMALL_CAFORMER = "caformer-smoke-small"  # dims (64, 128), depths (1, 1), conv + attention
SMALL_COAT = "coat-smoke-small"  # dims (64, 128), depths (1, 1), 8 heads, MLP ratio 8
# K5's float32 operations per pixel, counted from csrc/augment_kernel.cu:
# dropout 5 holes × 4 + 3, RGB→HSV 15, mod 3, shift 10, HSV→RGB 10,
# brightness/contrast 4 + normalize 3 × 6
# K6's shapes, (N, C, H, W) maps channels_last or (B, N, C) tokens as their
# (B, C, N) view: ResNet-50's first BN at B=128, NextViT-small's stem and
# stage-3 BNs and its stage-1 pooled tokens at B=64 (bf16, as trained); an
# fp32 map; an odd row count; an odd channel count (one element a load)
K6_SHAPES = {"resnet50-bn1": ((128, 64, 112, 112), "map", "bfloat16"),
             "nextvit-stem": ((64, 64, 112, 112), "map", "bfloat16"),
             "nextvit-stage3-768": ((64, 768, 7, 7), "map", "bfloat16"),
             "nextvit-stage3-1024": ((64, 1024, 7, 7), "map", "bfloat16"),
             "nextvit-tokens": ((64, 49, 192), "tokens", "bfloat16"),
             "fp32-map": ((64, 96, 56, 56), "map", "float32"),
             "odd-rows": ((3, 64, 37, 41), "map", "bfloat16"),
             "odd-channels": ((5, 37, 9, 11), "map", "float32")}
K6_RECORD = "resnet50-bn1"
K6_SUM_TOL = 1e-5  # of Σ|terms| per channel: fp32 sums in another order
# the CNN zoo: name -> train batch on the card (DenseNet-169's is DENSENET_BATCH;
# the others as the card holds them at 224×224)
ZOO = {"densenet169": 64, "mobilenet-v2": 64, "efficientnet-b0": 64, "efficientnet-b7": 16,
       "vgg16": 32}
K6_ROUTE = "+k6"  # a registered tower name + this: its BatchNorms fused (K6)
SMALL_NEXTVIT = "nextvit-smoke-small"  # stem (16, 16, 32), 4 narrow stages, 64×64
K5_OPS_PER_PIXEL = 83
# the last a width that is not a multiple of 8: the kernel's scalar loads
K5_SHAPES = ((1, 224, 224), (7, 224, 224), (128, 224, 224), (2, 300, 400), (3, 37, 45))
TRAIN_B = 128
TRAIN_HW = 224
TRAIN_LR = 1e-3  # the loss-falls check: 10 Adam steps on one batch
# BEiT-large's, MViTv2-small's, CAFormer-b36's and CoaT-lite-small's: at 1e-3
# BEiT's loss rose again after the first step (a step moves every weight of 24
# layer-scaled blocks by ~lr)
TOWER_TRAIN_LR = 1e-4
RGATT = "att-intramodal+residual+cross-attention-metadados"
# the sentence path: BERT-base and GPT-2 small have 12 layers, a K12 call
# each; the loss-falls check steps at BEiT's lr (random post-LN BERT weights)
K12_TEXT_LAYERS = 12
SENTENCE_LR = 1e-4
TOKEN_VOCAB = 30000  # token ids drawn below both towers' vocabularies
# the small BERT of the card-vs-CPU step: 64 channels a head, as BERT-base
SMALL_BERT = dict(vocab_size=1000, hidden_size=128, num_layers=2, num_heads=2,
                  intermediate_size=256, max_position_embeddings=64, hidden_dropout=0.0,
                  attention_dropout=0.0)
SENTENCE_CLI_IMAGES = 96
SENTENCE_CLI_BACKBONE = "davit_tiny"
SENTENCE_CLI_TOKENS = 512  # the reference's max_length
# fusion-kernel launches per fused forward, by mechanism
PER_FORWARD = {"seq1_attention": 4, "gated_residual_seq1": 2, "metablock_film": 0,
               "mlp_head": 1}  # RG-ATT


def _per_forward(seq1=0, grb=0, film=0, head=1):
    return {"seq1_attention": seq1, "gated_residual_seq1": grb, "metablock_film": film,
            "mlp_head": head}


FUSED_PER_FORWARD = {
    "concatenation": _per_forward(), "crossattention": _per_forward(4),
    "weighted": _per_forward(), "gfcam": _per_forward(4),
    "cross-weights-after-crossattention": _per_forward(4), "metablock": _per_forward(film=1),
    "rg-att": _per_forward(grb=2), "cross-attention-only": _per_forward(2),
    RGATT: _per_forward(4, 2), RGATT + "+metablock": _per_forward(4, 2, 1, 0),
}
CLI_MECHANISMS = ("metablock", RGATT + "+metablock")
CLI_IMAGES = 96  # PAD-UFES-20-shaped rows, one PNG each
CLI_IMAGE_HW = (300, 400)
CLI_BACKBONE = "resnet-50"
BATCHES = (1, 3, 8, 32)
TIMED_BATCHES = (1, 8, 32)
# K1's checks: BATCHES, a 32-row tile half full (16) and two tiles (33), and
# the batching service's buckets 2 and 4
K1_BATCHES = (*BATCHES, 16, 33, 2, 4)
# the rest of the model zoo: TabTransformer over PAD-UFES-20's categorical
# columns (the reference's tab_transformer.py widths, 512 out as the one-hot
# tower), the static-embedding tower over PubMedBERT-embeddings' 768-wide
# vectors, sequence fusion on ViT-small tokens, the three baselines through
# the train CLI with their towers and train batches, and the batching service
TAB_TOWER = dict(embed_dim=32, num_heads=4, num_layers=2, hidden_dim=128, out_dim=512)
TAB_COLUMNS = 18  # PAD-UFES-20's categorical columns
TAB_ROWS = 256  # PAD-UFES-20-like rows: 192 to train on at B=128, 64 to validate
STATIC_DIM = 768
SEQUENCE = dict(num_classes=6, num_heads=8, cnn_model_name="vit_small_patch16_224",
                common_dim=512, vocab_size=91, meta_tokens=4)
SEQUENCE_BATCH = 64
SEQ_K12_PER_FORWARD = 14  # ViT-small's 12 blocks and the two self-attentions
BASELINES = {"metanet": ("resnet-50", 128, 0), "mdnet": ("densenet169", 64, 0),
             "liwterm": ("vit_large_patch16_224", 32, 24)}  # tower, B, K12 a forward
BASELINE_ROWS = 256  # two folds of 128 rows: one step an epoch at B=128
# K12 at this slice's shapes: (B, N, C, heads)
K12_MODEL_SHAPES = {"tab-transformer": (TRAIN_B, TAB_COLUMNS, 32, 4),
                    "seq-meta": (SEQUENCE_BATCH, 4, 512, 8),
                    "seq-image": (SEQUENCE_BATCH, 197, 512, 8)}
MAX_BATCH = 8
BATCH_CLIENTS = 16
# fp32: the kernel and the twin sum in another order (TF32 off on both sides)
F32_TOL = (1e-4, 1e-4)  # (atol, rtol)
# bf16 activations: both round to bf16 at the same points, but a sum that
# lands near a rounding point can round the other way; one bf16 ulp near 1
# is 2**-8, so allow a few
BF16_TOL = (2e-2, 2e-2)


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def time_ms(fn, iters: int = 200, warmup: int = 20) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_args(name, B, dtype, device, gen, vd=K4_WIDTHS[0], D=512, k1=K3_WIDTHS[0]):
    """Inputs at the flagship shapes: D = 512, head k1 → 512 → 256 → 6 (k1
    1024 by default); K4 at Du = 512 and the given Vd."""
    import torch

    def w(k, n):
        return (torch.randn(k, n, generator=gen) / k ** 0.5).to(device)

    def v(n, base=0.0):
        return (base + 0.1 * torch.randn(n, generator=gen)).to(device)

    def act(n):
        return torch.randn(B, n, generator=gen).to(device=device, dtype=dtype)

    if name == "seq1_attention":
        return [act(D), w(D, D), v(D), w(D, D), v(D)]
    if name == "gated_residual_seq1":
        return [act(D), act(D), w(D, D), v(D), w(D, D), v(D), w(D, D), v(D), v(D, 1.0), v(D)]
    if name == K4:
        return [act(vd), act(K4_DU), w(K4_DU, vd), v(vd), v(vd, 1.0), v(vd),
                w(K4_DU, vd), v(vd), v(vd, 1.0), v(vd)]
    n1, n2, n3 = K3_HEAD
    return [act(k1), w(k1, n1), v(n1), v(n1, 1.0), v(n1), w(n1, n2), v(n2), v(n2, 1.0), v(n2),
            w(n2, n3), v(n3)]


def compare(out, ref, tol):
    """(max abs error, within atol + rtol·|ref|) of a kernel output against its twin's."""
    import torch

    atol, rtol = tol
    check(out.dtype == ref.dtype and out.shape == ref.shape,
          f"{out.dtype}{tuple(out.shape)} vs twin {ref.dtype}{tuple(ref.shape)}")
    check(bool(torch.isfinite(out.float()).all()), "non-finite kernel output")
    diff = (out.float() - ref.float()).abs()
    return float(diff.max()), float((diff - atol - rtol * ref.float().abs()).max()) <= 0


def phase_kernels(fk, device):
    import torch

    gen = torch.Generator().manual_seed(0)
    errors = {name: 0.0 for name in KERNELS}
    for name in KERNELS:
        kernel, twin = getattr(fk, name), getattr(fk, name + "_plain")
        for vd in (K4_WIDTHS if name == K4 else K4_WIDTHS[:1]):
            width = f" Vd={vd:4d}" if name == K4 else ""
            for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
                for B in BATCHES:
                    args = kernel_args(name, B, dtype, device, gen, vd)
                    out, ref = kernel(*args), twin(*args)
                    torch.cuda.synchronize()
                    err, ok = compare(out, ref, tol)
                    errors[name] = max(errors[name], err)
                    log(f"kernel {name:20s}{width} {str(dtype):15s} B={B:2d} max_abs_err={err:.3e}"
                        f" tol=atol {tol[0]:g} + rtol {tol[1]:g}·|twin| {'ok' if ok else 'FAIL'}")
                    check(ok, f"{name} disagrees with its twin at B={B}{width} {dtype}")
    return errors


def same_bits(a, b) -> bool:
    """Whether two tensors of one dtype and shape hold the same bits."""
    import torch

    ints = {2: torch.int16, 4: torch.int32}[a.element_size()]
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a.view(ints), b.view(ints))


def ran_kernels(fn) -> set:
    """The names of the kernels fn launched in a trace of 5 calls, traced
    again where the trace kept no device record, as torch.profiler now and
    then does (three empty traces of 5 calls in a row were seen once): up to
    six traces in all, of more calls each time, after a short pause."""
    for n in (5, 5, 5, 10, 20, 50):
        names = {e.key for e in device_events(fn, n)}
        if names:
            return names
        time.sleep(0.2)
    return set()


def route_args(name, B, dtype, device, gen, width):
    """kernel_args at a route check's width: D for K1 and K2, Vd for K4, K1
    for K3."""
    if name == K4:
        return kernel_args(name, B, dtype, device, gen, vd=width)
    if name == K3:
        return kernel_args(name, B, dtype, device, gen, k1=width)
    return kernel_args(name, B, dtype, device, gen, D=width)


def route_plan(fk, name, args):
    """The route ``ops/fusion_kernels.py`` chooses for a call on ``args``."""
    if name == "seq1_attention":
        return fk.seq1_attention_call_plan(args[0], args[1], args[3])
    if name == "gated_residual_seq1":
        return fk.gated_residual_call_plan(args[0], args[2], args[4], args[6])
    if name == K3:
        return fk.mlp_head_call_plan(args[0], args[1], args[5], args[9])
    return fk.metablock_film_call_plan(args[0], args[1], args[2], args[6])


def cluster_counts(fk, name, device, bf16, width):
    """Clusters of the kernel's cluster route the card holds at once, by rows
    a tile (CUDA's occupancy query)."""
    if name == "seq1_attention":
        return {r: fk.seq1_cluster_count(device.index, bf16, width, r)
                for r in CLUSTER_ROWS[name]}
    if name == "gated_residual_seq1":
        return {r: fk.gated_residual_cluster_count(device.index, bf16, width, r)
                for r in CLUSTER_ROWS[name]}
    if name == K3:
        return {r: fk.mlp_head_cluster_count(device.index, bf16, width, *K3_HEAD, r)
                for r in CLUSTER_ROWS[name]}
    return {r: fk.metablock_film_cluster_count(device.index, bf16, K4_DU, width, r)
            for r in CLUSTER_ROWS[name]}


def cluster_refusal(fk, name, device, gen):
    """The C entry point's answer (a CUDA error code; 0: launched) to the
    cluster route, 1 row a tile, at the width the route does not take."""
    import ctypes

    import torch

    width = ROUTE_WIDTHS[name][-1]
    args = route_args(name, 1, torch.float32, device, gen, width)
    out = torch.empty_like(args[0])
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    ptrs = [t.data_ptr() for t in args]
    if name == "seq1_attention":
        err = fk.library().skinjax_seq1_attention(0, 1, 1, *ptrs, out.data_ptr(), 1, width, stream)
    elif name == "gated_residual_seq1":
        err = fk.library().skinjax_gated_residual_seq1(0, 1, 1, *ptrs, out.data_ptr(), 1, width,
                                                       stream)
    elif name == K3:
        err = fk.library().skinjax_mlp_head(0, 1, 1, *ptrs, out.data_ptr(), 1, width, *K3_HEAD,
                                            stream)
    else:  # 16 CTAs of 160 columns
        err = fk.library().skinjax_metablock_film(0, 16, 1, *ptrs, out.data_ptr(), 1, K4_DU, width,
                                                  stream)
    torch.cuda.synchronize()
    return err


def phase_routes(fk, device, name, batches=K1_BATCHES):
    """The two routes of K1, K2, K3 or K4 on the card: at the served widths the
    cluster kernel, at the last of ROUTE_WIDTHS the one-block kernel, each
    against its twin at B in ``batches`` (K1_BATCHES), fp32 and bf16, at the unchanged
    tolerances; two calls bit-identical; each traced call ran the kernel
    the plan chose, and not the other one; the C entry point refuses the
    cluster route at the width it does not take. Returns the largest
    error."""
    import torch

    dim = {K4: "Vd", K3: "K1"}.get(name, "D")
    kernel, twin = getattr(fk, name), getattr(fk, name + "_plain")
    for width in ROUTE_WIDTHS[name][:-1]:
        for dtype in (torch.float32, torch.bfloat16):
            counts = cluster_counts(fk, name, device, dtype == torch.bfloat16, width)
            log(f"kernel {name} {dim}={width} {dtype}: clusters the card holds at once, by rows "
                f"a tile: {counts}")
    gen = torch.Generator().manual_seed(3)
    kernels = {KERNEL_NAMES[name], BLOCK_KERNELS[name]}
    worst = 0.0
    for width in ROUTE_WIDTHS[name]:
        for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
            for B in batches:
                args = route_args(name, B, dtype, device, gen, width)
                plan = route_plan(fk, name, args)
                out, again = kernel(*args), kernel(*args)
                ref = twin(*args)
                torch.cuda.synchronize()
                err, ok = compare(out, ref, tol)
                same = same_bits(out, again)
                ran = ran_kernels(lambda: kernel(*args))  # noqa: B023
                other = (kernels - {plan["kernel"]}).pop()
                routed = (any(plan["kernel"] in k for k in ran)
                          and not any(other in k for k in ran))
                worst = max(worst, err)
                log(f"kernel {name} {dim}={width} {str(dtype):15s} B={B:2d} {plan['kernel']} "
                    f"(cluster {plan['cluster']}, {plan['rows']} rows a tile): "
                    f"max_abs_err={err:.3e} tol=atol {tol[0]:g} + rtol "
                    f"{tol[1]:g}·|twin| {'ok' if ok else 'FAIL'}; two calls bit-identical: "
                    f"{same}; ran {sorted(ran)}")
                check(ok, f"{name} disagrees with its twin at {dim}={width} B={B} {dtype}")
                check(same, f"two {name} calls differ at {dim}={width} B={B} {dtype}")
                check(routed, f"{name} at {dim}={width} B={B} ran {sorted(ran)}, not "
                              f"{plan['kernel']}")
    width = ROUTE_WIDTHS[name][-1]
    err = cluster_refusal(fk, name, device, gen)
    log(f"kernel {name}: the cluster route at {dim}={width} returns CUDA error {err}")
    check(err != 0, f"the entry point of {name} took the cluster route at {dim}={width}")
    return worst


def fusion_library(name, args):
    """K1-K4's function as PyTorch calls it, on the same inputs: one
    ``torch.addmm`` a product, the casts where the kernels round, and
    ``F.layer_norm``, ``torch.sigmoid``, ``torch.tanh``, ``torch.relu``. Only
    timed here, as a yardstick."""
    import torch
    import torch.nn.functional as F

    eps = 1e-5  # the kernels' and nn.LayerNorm's

    def ln(x, g, b):
        return F.layer_norm(x, (x.shape[-1],), g, b, eps)

    if name == "seq1_attention":
        kv, wv, bv, wo, bo = args
        return lambda: torch.addmm(bo, torch.addmm(bv, kv.float(), wv).to(kv.dtype).float(),
                                   wo).to(kv.dtype)
    if name == "gated_residual_seq1":
        q, kv, wv, bv, wo, bo, wg, bg, gamma, beta = args

        def grb():
            qf = q.float()
            attn = torch.addmm(bo, torch.addmm(bv, kv.float(), wv).to(q.dtype).float(), wo)
            g = torch.sigmoid(torch.addmm(bg, qf, wg))
            return ln(g * attn + (1.0 - g) * qf, gamma, beta).to(q.dtype)
        return grb
    if name == K4:
        v, u, wf, bf, gf, hf, wg, bg, gg, hg = args

        def film():
            uf = u.float()
            t1, t2 = ln(torch.addmm(bf, uf, wf), gf, hf), ln(torch.addmm(bg, uf, wg), gg, hg)
            return torch.sigmoid(torch.tanh(v.float() * t1) + t2).to(v.dtype)
        return film
    x, w1, b1, g1, h1, w2, b2, g2, h2, w3, b3 = args

    def head():
        h = torch.relu(ln(torch.addmm(b1, x.float(), w1), g1, h1)).to(x.dtype)
        h = torch.relu(ln(torch.addmm(b2, h.float(), w2), g2, h2)).to(x.dtype)
        return torch.addmm(b3, h.float(), w3).to(x.dtype)
    return head


def l2_flush(device):
    """A 256 MB buffer and a function that writes it: five times the L2
    cache, so that nothing read before the write is left there."""
    import torch

    buf = torch.empty(256 << 20, dtype=torch.uint8, device=device)
    return lambda: buf.fill_(1)


def cold_times(fn, names, flush, n: int = 20):
    """fn with the L2 cache cold (``flush`` before each call, outside the
    timed window): CUDA events around each call alone, averaged (ms), and
    its kernels' device time (µs, torch.profiler): the kernels ``names`` or,
    with names None, every kernel of the call but the flush's fill (None:
    not measured, where the trace holds no fill)."""
    import torch

    pairs = []
    for _ in range(n + 3):
        flush()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    ms = sum(a.elapsed_time(b) for a, b in pairs[3:]) / n

    def both():
        flush()
        fn()
    if names is not None:
        return ms, kernel_device_us(both, names, n=n)
    _, by_name = device_us(both, n=n)
    fills = [k for k in by_name if "FillFunctor" in k]
    return ms, sum(v for k, v in by_name.items() if k not in fills) if fills else None


def phase_kernel_times(fk, device, card):
    """K1-K3 in bf16 at TIMED_BATCHES, K3 at each of K3_WIDTHS: per call
    (CUDA events over 200 back-to-back calls, in turns with the twin), device
    time, the bound, and the same function as PyTorch calls it
    (``fusion_library``: per call and device time); each also with its
    weights L2-cold. Returns {(name, B): numbers} at the flagship's widths,
    {(name, B, K1): numbers} at K3's others."""
    import torch

    gen = torch.Generator().manual_seed(1)
    flush = l2_flush(device)
    n1, n2, n3 = K3_HEAD
    cases = [("seq1_attention", None, [(512, 512)] * 2),
             ("gated_residual_seq1", None, [(512, 512)] * 3),
             *((K3, k1, [(k1, n1), (n1, n2), (n2, n3)]) for k1 in K3_WIDTHS)]
    times = {}
    for name, k1, products in cases:
        kernel, twin = getattr(fk, name), getattr(fk, name + "_plain")
        label = f"{name} K1={k1}" if k1 else name
        for B in TIMED_BATCHES:
            args = kernel_args(name, B, torch.bfloat16, device, gen, k1=k1 or K3_WIDTHS[0])
            lib = fusion_library(name, args)
            err, ok = compare(lib(), twin(*args), BF16_TOL)
            check(ok, f"{label}'s library chain disagrees with the twin at B={B} ({err:.3e})")
            kern = lambda: kernel(*args)  # noqa: E731,B023
            plain = lambda: twin(*args)  # noqa: E731,B023
            # in turns: twin, kernel, library, library, kernel, twin
            t = [time_ms(plain), time_ms(kern), time_ms(lib), time_ms(lib), time_ms(kern),
                 time_ms(plain)]
            ms, plain_ms, lib_ms = (t[1] + t[4]) / 2, (t[0] + t[5]) / 2, (t[2] + t[3]) / 2
            dev_k = kernel_device_us(kern, [KERNEL_NAMES[name]])
            dev_t, _ = device_us(plain)
            dev_l, _ = device_us(lib)
            bound = matmul_bound_ms(args, twin(*args), products, B)
            cold_k = cold_times(kern, [KERNEL_NAMES[name]], flush)
            cold_l = cold_times(lib, None, flush)
            key = (name, B) if k1 in (None, K3_WIDTHS[0]) else (name, B, k1)
            times[key] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound,
                              device_us=dev_k, library_device_us=dev_l, cold_ms=cold_k[0],
                              cold_device_us=cold_k[1], library_cold_ms=cold_l[0],
                              library_cold_device_us=cold_l[1])
            log(f"[{card}] time {label:20s} bf16 B={B:2d} per call: kernel {ms * 1e3:8.2f} us  "
                f"twin {plain_ms * 1e3:8.2f} us  library {lib_ms * 1e3:8.2f} us (CUDA events "
                f"over 200 back-to-back calls each, in turns, L2-warm weights); device time: "
                f"kernel {us(dev_k)}  twin {dev_t:8.2f} us  library {dev_l:8.2f} us "
                f"(torch.profiler); bound {bound * 1e3:.2f} us; "
                f"{against(ms, bound, lib_ms)}")
            log(f"[{card}] time {label:20s} bf16 B={B:2d} L2-cold (a 256 MB write before each "
                f"call, outside the timed window): kernel {cold_k[0] * 1e3:8.2f} us a call "
                f"(CUDA events around each call), device {us(cold_k[1])}; library "
                f"{cold_l[0] * 1e3:8.2f} us a call, device {us(cold_l[1])}")
    del flush
    torch.cuda.empty_cache()
    return times


def device_events(fn, n: int):
    """The device-side entries of ``key_averages()`` of a torch.profiler
    trace of n calls of fn (after one untraced call), each with some time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]


def device_us(fn, n: int = 50):
    """Device time per call (µs) from a torch.profiler trace of n calls: the
    kernels' (and device copies') own time over n, in all and by name. Only
    device-side events count, and no user annotation (such as the
    optimizer's ``Optimizer.step#Adam.step`` range): a CPU op's self device
    time and an annotation's span repeat their kernels' time."""
    by_name = {e.key: e.self_device_time_total / n for e in device_events(fn, n)
               if not e.is_user_annotation}
    return sum(by_name.values()), by_name


def kernel_device_us(fn, names, n: int = 10):
    """Device time (µs) of one call of ``fn``, whose kernels are ``names``,
    each launched once a call: the mean duration of each kernel's launches in
    a torch.profiler trace of n calls, summed. Means over the launches the
    trace recorded, so a launch missing from the trace (seen for K5 and K7 in
    a process that had traced much before) does not pull the time down;
    None (not measured) where a kernel left no record at all."""
    means = {name: e.self_device_time_total / e.count
             for e in device_events(fn, n) for name in names if name in e.key}
    return sum(means.values()) if len(means) == len(names) else None


def against(ms, bound_ms, library_ms) -> str:
    """A kernel's time (ms) as a share of its bound and as a factor of the
    same run's library call (None: not measured)."""
    factor = "not measured" if library_ms is None else f"{ms / library_ms:.2f}x"
    return f"share of bound {100 * bound_ms / ms:.1f}%, factor against the library call {factor}"


def us(t) -> str:
    return "not measured" if t is None else f"{t:9.2f} us"


def share(part, total) -> str:
    """part / total as a percentage; not measured where a trace kept no
    device record (total 0)."""
    return f"{100 * part / total:.2f}%" if total > 0 else "not measured"


def ms_us(t) -> str:
    """A time in ms (or None) printed in µs."""
    return "not measured" if t is None else f"{t * 1e3:.2f} us"


def time_record(card, name, label, kern, twin, kernel_names, bound, library):
    """One kernel timed in turns with its twin (CUDA events), their device
    times (torch.profiler), its bound and its library yardstick; logged and
    returned as the record's numbers."""
    t = [time_ms(twin, 10, 2), time_ms(kern, 10, 2), time_ms(kern, 10, 2), time_ms(twin, 10, 2)]
    ms, plain_ms = (t[1] + t[2]) / 2, (t[0] + t[3]) / 2
    dev_k = kernel_device_us(kern, kernel_names, n=5)
    dev_t, _ = device_us(twin, n=5)
    bound_ms, nbytes, ops = bound
    bound_by = "bytes" if nbytes / HBM_BYTES_PER_S >= ops / BF16_OPS_PER_S else "operations"
    log(f"[{card}] time {name} bf16 {label} per call: kernel {ms * 1e3:9.2f} us  twin "
        f"{plain_ms * 1e3:9.2f} us (CUDA events, in turns twin-kernel-kernel-twin); device time: "
        f"kernel {us(dev_k)}  twin {dev_t:9.2f} us (torch.profiler); bound "
        f"{bound_ms * 1e3:.2f} us ({nbytes / 1e6:.1f} MB at 3.35 TB/s, {ops / 1e9:.2f} GFLOP at "
        f"989 TFLOP/s); library {ms_us(library)}; {against(ms, bound_ms, library)}")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=library)


_SMOKE_MODELS = {}


def smoke_model(config, dtype):
    """A configuration (``skinjax_torch.FLAGSHIP``, ``DAVIT``, ``BEIT``,
    ``SENTENCE`` or ``GPT2``) at full width, built by ``create_model`` with
    random weights from seed 0: drawn on the CPU once per configuration
    (BEiT-large's 307 M parameters among them); each new instance is a copy
    of that model, with the compute dtype asked for."""
    import copy

    from skinjax_torch.models.factory import create_model

    key = tuple(sorted(config.items()))
    if key not in _SMOKE_MODELS:
        _SMOKE_MODELS[key] = create_model(**config, seed=0)
    model = copy.deepcopy(_SMOKE_MODELS[key])
    model.dtype = dtype
    return model


def smoke_featurizer(vocab: int):
    """A featurizer of the flagship's width: nine categorical columns of ten
    values each and one numeric column (91 features)."""
    import numpy as np

    from skinjax_torch.data.featurizer import MetadataFeaturizer

    n_cat = (vocab - 1) // 10
    check(n_cat * 10 + 1 == vocab, f"vocab {vocab} is not 10·k + 1")
    fz = MetadataFeaturizer(categorical_cols=[f"c{i}" for i in range(n_cat)],
                            numerical_cols=["age"])
    fz.ohe.categories = [[f"v{j}" for j in range(10)] for _ in range(n_cat)]
    fz.scaler.mean, fz.scaler.scale = np.array([50.0]), np.array([20.0])
    fz.label_encoder.classes = ["ACK", "BCC", "MEL", "NEV", "SCC", "SEK"]
    return fz


def phase_slice(fk, device, card, label="flagship", config=None, towers=(), fp32=True):
    """A configuration served (the flagship unless ``config``): the fused
    engine against the plain one in bf16, with the launches per fused forward
    (``towers``: the tower's (module, {kernel: launches per forward}) pairs,
    counted too), and, with ``fp32``, in fp32 on the card against the same
    model on the CPU."""
    import numpy as np
    import torch

    from skinjax_torch import FLAGSHIP
    from skinjax_torch.serve.engine import InferenceEngine

    config = config or FLAGSHIP
    counters = [fk] + [m for m, _ in towers]
    expect = dict(PER_FORWARD)
    for _, per_forward in towers:
        expect.update(per_forward)
    rng = np.random.default_rng(2)
    # bf16, as served: fused (the kernels) against plain (autocast linears)
    model = smoke_model(config, torch.bfloat16)
    fused = InferenceEngine(model, use_fused=True, device=device)
    plain = InferenceEngine(model, use_fused=False, device=device)
    check(fused.fused, f"the {label} engine did not select the fused path")
    for B in (1, 8):
        img = rng.integers(0, 256, (B, 224, 224, 3), dtype=np.uint8)
        meta = rng.normal(size=(B, model.vocab_size)).astype(np.float32)
        for c in counters:
            c.reset_launches()
        pf = fused.predict_probs(img, meta)
        torch.cuda.synchronize()
        launches = {k: v for c in counters for k, v in c.LAUNCHES.items()}
        pp = plain.predict_probs(img, meta)
        err = float(np.abs(pf - pp).max())
        log(f"slice {label} bf16 B={B}: probs {pf.shape} fused vs plain max_abs_err={err:.3e} "
            f"(tol 3e-2: the plain path runs its attention linears with bf16 weights, the "
            f"kernels with fp32); launches per fused forward {launches}")
        check(pf.shape == (B, 6) and bool(np.isfinite(pf).all()), "non-finite or misshapen probs")
        check(np.allclose(pf.sum(-1), 1.0, atol=1e-4), "probabilities do not sum to 1")
        check(err <= 3e-2, f"bf16 fused and plain {label} engines disagree at B={B}")
        check(launches == expect, f"launches per fused forward {launches} != {expect}")
    if not fp32:
        return fused, plain

    # fp32 with TF32 off: fused against plain on the card, and the card
    # against the same model on the CPU (the reference on a small batch)
    model32 = smoke_model(config, None)
    cpu_ref = InferenceEngine(smoke_model(config, None), use_fused=False, device="cpu")
    fused32 = InferenceEngine(model32, use_fused=True, device=device)
    plain32 = InferenceEngine(model32, use_fused=False, device=device)
    img = rng.integers(0, 256, (2, 224, 224, 3), dtype=np.uint8)
    meta = rng.normal(size=(2, model32.vocab_size)).astype(np.float32)
    pf, pp, pc = (e.predict_probs(img, meta) for e in (fused32, plain32, cpu_ref))
    e_fp, e_fc = float(np.abs(pf - pp).max()), float(np.abs(pf - pc).max())
    log(f"slice {label} fp32 B=2: fused vs plain max_abs_err={e_fp:.3e} (tol 1e-4); "
        f"card fused vs CPU plain max_abs_err={e_fc:.3e} (tol 1e-3: cuDNN, cuBLAS and K7 sum "
        f"the tower's layers in other orders than the CPU)")
    check(e_fp <= 1e-4, f"fp32 fused and plain {label} engines disagree")
    check(e_fc <= 1e-3, f"the card and the CPU disagree on the fp32 {label} model")
    return fused, plain


def phase_profile(engine, label, B, mean_ms, card):
    """Where one forward's time goes on the card: device time per forward
    from a trace, its share of the untraced mean forward time, and the
    largest kernels."""
    import numpy as np
    import torch

    rng = np.random.default_rng(4)
    img = torch.as_tensor(rng.normal(size=(B, 224, 224, 3)).astype(np.float32)).to(engine.device)
    meta = torch.as_tensor(rng.normal(size=(B, engine.model.vocab_size)).astype(np.float32))
    meta = meta.to(engine.device)
    with torch.inference_mode():
        total, by_name = device_us(lambda: engine._forward(img, meta), n=20)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    ours = {k: v for k, v in by_name.items() if any(n in k for n in KERNEL_SYMBOLS)}
    log(f"[{card}] profile bf16 {label} B={B}: device time {total:.1f} us per forward = "
        f"{100 * total / (mean_ms * 1e3):.1f}% of the untraced mean {mean_ms:.3f} ms "
        f"(the rest the card is idle, waiting for the host); {len(by_name)} kernel names")
    log(f"  top kernels (us per forward): "
        + "; ".join(f"{k[:70]} {v:.1f}" for k, v in top))
    if ours:
        log(f"  the port's kernels (us per forward, {sum(ours.values()):.1f} in all): "
            + "; ".join(f"{k[:70]} {v:.1f}" for k, v in sorted(ours.items())))


def _multipart(image_bytes: bytes, metadata: str):
    boundary = uuid.uuid4().hex
    body = (f"--{boundary}\r\nContent-Disposition: form-data; name=\"file\"; "
            f"filename=\"lesion.png\"\r\nContent-Type: image/png\r\n\r\n").encode()
    body += image_bytes + (
        f"\r\n--{boundary}\r\nContent-Disposition: form-data; name=\"metadata\"\r\n\r\n"
        f"{metadata}\r\n--{boundary}--\r\n").encode()
    return body, f"multipart/form-data; boundary={boundary}"


def phase_server(fk, card, cnn="resnet-50", towers=(), env=None, requests=None,
                 per_forward=None):
    """The service as ``python -m skinjax_torch.serve.run_service`` builds it
    (its environment: ``CNN_MODEL_NAME=cnn``, the flagship otherwise, random
    weights from seed 0, a featurizer JSON; or ``env``), served as
    ``api.serve`` serves it, on a localhost port, answering four requests (or
    ``requests``: (PNG bytes, CSV line) pairs). The fusion kernels' launches
    over them must be ``per_forward`` (RG-ATT's by default) per request;
    ``towers``: the tower's (module, {kernel: launches per forward}) pairs,
    counted too. Returns the launches and the engine."""
    import tempfile
    from http.server import ThreadingHTTPServer

    import numpy as np

    from skinjax_torch.serve import png, run_service
    from skinjax_torch.serve.api import make_handler

    with tempfile.TemporaryDirectory() as tmp:
        if env is None:
            path = os.path.join(tmp, "featurizer.json")
            smoke_featurizer(91).save(path)
            env = {"FEATURIZER_JSON": path, "CNN_MODEL_NAME": cnn}
        env = dict(env, DEVICE="cuda")
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            engine = run_service.build_engine()
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
    check(engine.fused and engine.model.dtype is not None, "run_service built no fused bf16 engine")
    check(engine.model.cnn_dim_output == {"resnet-18": 512, "resnet-50": 2048, "davit_tiny": 768,
                                          "beitv2_large_patch16_224": 1024,
                                          "mvitv2_small": 768, "caformer_b36": 768,
                                          "coat_lite_small": 512,
                                          "swin_tiny_patch4_window7_224": 768,
                                          "nextvit_small" + K6_ROUTE: 1024}[cnn],
          f"run_service did not build a {cnn} tower")
    if requests is None:
        n_cat = len(engine.featurizer.categorical_cols)
        rng = np.random.default_rng(3)
        requests = []
        for shape in ((224, 224), (224, 224), (224, 224), (300, 400)):
            img = rng.integers(0, 256, (*shape, 3), dtype=np.uint8)
            meta = ", ".join([f"v{rng.integers(10)}" for _ in range(n_cat)]
                             + [str(int(rng.integers(20, 90)))])
            requests.append((png.encode_png(img), meta))

    handler = make_handler(engine)
    server = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    url = f"http://127.0.0.1:{server.server_address[1]}"
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    answers = []
    counters = [fk] + [m for m, _ in towers]
    try:
        for c in counters:
            c.reset_launches()
        with urllib.request.urlopen(f"{url}/health", timeout=60) as r:
            check(r.status == 200 and json.loads(r.read()) == {"status": "ok"}, "/health failed")
        for data, meta in requests:
            body, ctype = _multipart(data, meta)
            req = urllib.request.Request(f"{url}/predict/", data=body,
                                         headers={"Content-Type": ctype})
            t0 = time.perf_counter()
            with urllib.request.urlopen(req, timeout=120) as r:
                status, out = r.status, json.loads(r.read())
            answers.append((status, out, (time.perf_counter() - t0) * 1e3))
        launches = {k: v for c in counters for k, v in c.LAUNCHES.items()}
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
        handler.worker.shutdown(wait=True)
    check(not thread.is_alive(), "the server thread did not stop")

    for (data, meta), (status, out, ms) in zip(requests, answers):
        img = png.decode_png(data)
        probs = np.asarray(out["probabilities"])
        direct = np.asarray(engine.predict(img, meta)["probabilities"])
        err = float(np.abs(probs - direct).max())
        log(f"[{card}] server POST /predict/ {img.shape[1]}x{img.shape[0]}: {status} "
            f"{out['predicted_classname']} sum={probs.sum():.6f} vs engine.predict "
            f"max_abs_err={err:.3e} (tol 1e-5) round trip {ms:.2f} ms")
        check(status == 200 and set(out) == {"predicted_label_index", "predicted_classname",
                                             "probabilities"}, "bad /predict/ answer")
        check(abs(probs.sum() - 1.0) < 1e-4, "probabilities do not sum to 1")
        check(err <= 1e-5, "the server and engine.predict disagree")
    expect = {k: v * len(requests) for k, v in (per_forward or PER_FORWARD).items()}
    for _, tower_per_forward in towers:
        expect.update({k: v * len(requests) for k, v in tower_per_forward.items()})
    log(f"server {cnn} {engine.model.attention_mechanism} launches over {len(requests)} "
        f"requests: {launches} (expected {expect})")
    check(launches == expect, "the served forwards did not run every kernel as expected")
    return launches, engine


def bf16_ulp(x):
    """One bfloat16 ulp at the magnitude of each element of x (8 significant
    bits: 2**(e - 7) for |x| in [2**e, 2**(e + 1)))."""
    import torch

    return torch.exp2(torch.floor(torch.log2(x.float().abs().clamp_min(2.0 ** -126))) - 7)


def k5_inputs(ak, B, H, W, gates_on, dtype, device, seed):
    import torch

    from skinjax_torch.data.augment import DEFAULT_CFG

    cfg = dict(DEFAULT_CFG, p_dropout=1.0, p_hsv=1.0, p_bc=1.0) if gates_on else DEFAULT_CFG
    gen = torch.Generator(device=device).manual_seed(seed)
    fparams, iparams = ak.draw_color_params(gen, B, H, W, cfg)
    img = torch.rand((B, H, W, 3), generator=gen, device=device).to(dtype)
    return img, fparams, iparams


def phase_k5(ak, device):
    """K5 bit for bit its twin at every K5_SHAPES case, bf16 and fp32 in and
    out, drawn parameters and every gate on (both compute in fp32 from the
    same input with the same operations, and round once at the end); two
    calls bit-identical; and the kernel's normalize (a product with the
    reciprocal and one fused multiply-add correction) against the IEEE
    quotient for every value clip01 returns, each channel."""
    import torch

    worst = 0.0
    for B, H, W in K5_SHAPES:
        for gates_on in (False, True):
            for dtype in (torch.bfloat16, torch.float32):
                img, fp, ip = k5_inputs(ak, B, H, W, gates_on, dtype, device, seed=B + gates_on)
                out = ak.fused_color_stage(img, fp, ip, out_dtype=dtype)
                again = ak.fused_color_stage(img, fp, ip, out_dtype=dtype)
                ref = ak.fused_color_stage_plain(img, fp, ip, out_dtype=dtype)
                torch.cuda.synchronize()
                check(out.dtype == ref.dtype and out.shape == ref.shape,
                      f"K5: {out.dtype}{tuple(out.shape)} vs twin {ref.dtype}{tuple(ref.shape)}")
                check(bool(torch.isfinite(out.float()).all()), "K5: non-finite output")
                diff = (out.float() - ref.float()).abs()
                err, exact, same = float(diff.max()), same_bits(out, ref), same_bits(out, again)
                worst = max(worst, err)
                log(f"kernel {K5} {str(dtype):15s} B={B:3d} {H}x{W} "
                    f"{'every gate on' if gates_on else 'drawn params'}: max_abs_err={err:.3e} "
                    f"({int((diff > 0).sum())} elements differ; tol: bit for bit) "
                    f"{'ok' if exact else 'FAIL'}; two calls bit-identical: {same}")
                check(exact, f"K5 differs from its twin at B={B} {H}x{W} {dtype}")
                check(same, f"two K5 calls differ at B={B} {H}x{W} {dtype}")
    t0 = time.perf_counter()
    bad = ak.division_mismatches(device)
    log(f"kernel {K5} normalize: (c - mean) / std as a reciprocal product with one FMA "
        f"correction against the IEEE quotient, every c in [0, 1] and -0 "
        f"({0x3f800000 + 2} values) a channel: mismatches {bad} "
        f"({time.perf_counter() - t0:.2f} s)")
    check(bad == (0, 0, 0), f"K5's normalize differs from the IEEE quotient: {bad}")
    return worst


def k7_inputs(B, side, C, heads, dtype, device, seed, bias=False, mask=False):
    """x, the weights and dy at one window-attention shape, drawn on the card;
    a relative-position bias (heads, 49, 49) and Swin-like per-window masks
    (-100 on a fifth of the pairs, never on the diagonal) where asked."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)

    def r(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=device) * scale

    N = WINDOW * WINDOW
    args = [r(B, side, side, C), r(C, 3 * C, scale=C ** -0.5), r(3 * C, scale=0.1),
            r(C, C, scale=C ** -0.5), r(C, scale=0.1)]
    args = [a.to(dtype) for a in args]
    dy = r(B, side, side, C).to(dtype)
    b = r(heads, N, N, scale=0.1) if bias else None
    m = None
    if mask:
        n_win = (side // WINDOW) ** 2
        m = torch.where(torch.rand((n_win, N, N), generator=gen, device=device) > 0.8, -100.0, 0.0)
        m[:, torch.arange(N), torch.arange(N)] = 0.0
    return args, dy, b, m


def phase_k7(wa, device):
    """K7 forward and backward against their twins at DaViT-tiny's stage
    shapes, B in {1, 64}, bf16 (BF16_TOL) and fp32 (F32_TOL, TF32 off), and
    at the cases with a bias (``K7_BIAS_CASES``); the backward's dqkv, of
    and dbias. Two bf16 backward calls bit-identical at stage 1, B=64, and
    at every bias case (dbias summed in a fixed order, one window or several
    a block). At every bf16 case: two forward calls bit-identical; the
    forward's of (``return_of``) equal, bit for bit, to the backward's of on
    the same inputs (one core function computes both); the padded entry on
    the same windows (``window_partition`` of x, the same bias and masks)
    gives the partitioned of and y bit for bit (the same core, the other
    address map)."""
    import torch

    errors = {name: 0.0 for name in K7}
    cases = [(B, *stage, False, False) for stage in K7_STAGES for B in K7_BATCHES]
    cases += list(K7_BIAS_CASES)
    for B, side, C, h, bias, mask in cases:
        extras = " bias+mask" if mask else " bias" if bias else ""
        for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, F32_TOL)):
            args, dy, b, m = k7_inputs(B, side, C, h, dtype, device, seed=B + side, bias=bias,
                                       mask=mask)
            x, wqkv, bqkv, wproj, bproj = args
            y, of = wa.window_attention_fwd(*args, b, m, h, WINDOW, return_of=True)
            results = [("window_attention_fwd", "y", y,
                        wa.window_attention_nhwc_plain(*args, b, m, h, WINDOW))]
            got = wa.window_attention_bwd(x, dy, wqkv, bqkv, wproj, b, m, h, WINDOW)
            want = wa.window_attention_nhwc_bwd_plain(x, dy, wqkv, bqkv, wproj, b, m, h, WINDOW)
            torch.cuda.synchronize()
            check((got[2] is None) == (want[2] is None), "dbias present on one side only")
            if dtype == torch.bfloat16:
                y2, of2 = wa.window_attention_fwd(*args, b, m, h, WINDOW, return_of=True)
                xw = wa.window_partition(x, WINDOW).contiguous()
                yp, ofp = wa.window_attention_pad_fwd(xw, wqkv, bqkv, wproj, bproj, b, m, h,
                                                      return_of=True)
                torch.cuda.synchronize()
                for what, same in (
                        ("two forward calls bit-identical (y and of)",
                         torch.equal(y, y2) and torch.equal(of, of2)),
                        ("the forward's of bit for bit the backward's of", torch.equal(of, got[1])),
                        ("the padded entry on the same windows gives of and y bit for bit",
                         torch.equal(ofp, wa.window_partition(of, WINDOW))
                         and torch.equal(yp, wa.window_partition(y, WINDOW)))):
                    log(f"kernel window_attention_fwd bfloat16 B={B:2d} {side}x{side} C={C} "
                        f"h={h}{extras}: {what}: {same}")
                    check(same, f"window_attention_fwd at B={B} {side}x{side}{extras}: {what} "
                                f"fails")
                del y2, of2, xw, yp, ofp
            if dtype == torch.bfloat16 and (bias or (B, side) == (K7_BATCHES[-1], 56)):
                again = wa.window_attention_bwd(x, dy, wqkv, bqkv, wproj, b, m, h, WINDOW)
                same = all(torch.equal(a_, b_) for a_, b_ in zip(got, again) if a_ is not None)
                n_win = B * (side // WINDOW) ** 2
                blocks = wa.bwd_blocks(n_win, bias)
                log(f"kernel window_attention_bwd {str(dtype):14s} B={B:2d} {side}x{side} C={C} "
                    f"h={h}{extras} ({n_win} windows, {blocks} blocks, up to "
                    f"{-(-n_win // blocks)} windows a block): two calls bit-identical: {same}")
                check(same, f"two window_attention_bwd calls differ at B={B} {side}x{side}{extras}")
                del again
            results += [("window_attention_bwd", part, o, r)
                        for part, o, r in zip(("dqkv", "of", "dbias"), got, want) if r is not None]
            for name, part, out, ref in results:
                err, ok = compare(out, ref, tol)
                errors[name] = max(errors[name], err)
                log(f"kernel {name} {part:5s} {str(dtype):14s} B={B:2d} {side}x{side} C={C} h={h}"
                    f"{extras}: max_abs_err={err:.3e} tol=atol {tol[0]:g} "
                    f"+ rtol {tol[1]:g}·|twin| {'ok' if ok else 'FAIL'}")
                check(ok, f"{name} {part} disagrees with its twin at B={B} {side}x{side}{extras} "
                          f"{dtype}")
            del args, dy, b, m, x, wqkv, bqkv, wproj, results, got, want, y, of
    torch.cuda.empty_cache()
    return errors


def k12_inputs(B, N, C, heads, bias, kmask, pmult, dtype, device, seed):
    """q, k, v, do (B, N, C) and the extras asked for, drawn on the card: a
    relative-position-like bias (heads, N, N) or GPT-2's causal mask as one
    (``CAUSAL``), a BERT padding mask (the last fifth of the keys of every
    other sample at -1e9) and a broadcast dropout multiplier at keep 0.9."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)

    def r(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=device) * scale

    q, k, v, do = (r(B, N, C).to(dtype) for _ in range(4))
    b = None
    if bias == CAUSAL:
        ids = torch.arange(N, device=device)
        b = torch.where(ids[None] <= ids[:, None], 0.0, -1e9).expand(heads, N, N).contiguous()
    elif bias:
        b = r(heads, N, N, scale=0.5)
    km = None
    if kmask:
        km = torch.zeros((B, N), device=device)
        km[::2, N - N // 5:] = -1e9
    pm = None
    if pmult:
        keep = torch.rand((N, N), generator=gen, device=device) < 0.9
        pm = keep.float() / 0.9
    return (q, k, v), do, b, km, pm


def phase_k12(ga, device):
    """K12 forward (o and P), stored-P backward and recompute backward (dq,
    dk, dv, dbias where the bias has a gradient) against their twins at
    K12_SHAPES, bf16 (BF16_TOL; P and dbias F32_TOL) and fp32 (F32_TOL, TF32
    off); the stored-P sides take the twin's P. Then, at each shape whose P
    is within the stored-P limit, the recompute backward against the
    stored-P backward on the kernel's own P: the bf16 recompute backward
    takes its products on the tensor cores in another order than the
    stored-P backward's CUDA-core sums, so the two agree at the twins'
    tolerances (printed as is). At ``K12_SAME_SHAPE`` two bf16 recompute
    calls are bit-identical, at ``K12_P_SAME_SHAPES`` two bf16 stored-P
    backward calls; at ``K12_FWD_SAME_SHAPES`` two bf16 forward calls (P
    included where emitted); at ``K12_NO_P_SHAPES`` the forward without P
    against the twin and, in bf16, against the o of the call with P, bit for
    bit. At every shape with no kmask and no pmult the bf16 forward's o is
    held against the recompute rows kernel's of (the padded window core's
    output, round(round(P).v) from the same scores and the same
    online_softmax): the two must be bit for bit the same."""
    import torch

    errors = {name: 0.0 for name in K12}
    for label, (B, N, C, h, bias, kmask, pmult) in K12_SHAPES.items():
        grad_bias = bias is True
        for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, F32_TOL)):
            (q, k, v), do, b, km, pm = k12_inputs(B, N, C, h, bias, kmask, pmult, dtype, device,
                                                  seed=N + C)
            o, p = ga.global_attention_fwd(q, k, v, b, km, pm, h, emit_p=True)
            ro, rp = ga.attention_core_plain(q, k, v, b, km, pm, h)
            got = ga.global_attention_bwd(q, k, v, do, rp, pm, h, grad_bias)
            want = ga.attention_core_bwd_plain(q, k, v, do, rp, pm, h, grad_bias)
            rec = ga.global_attention_bwd_recompute(q, k, v, do, b, km, pm, h, grad_bias)
            torch.cuda.synchronize()
            check((got[3] is None) == (want[3] is None) == (rec[3] is None),
                  "dbias present on one side only")
            if label in K12_FWD_SAME_SHAPES and dtype == torch.bfloat16:
                again = ga.global_attention_fwd(q, k, v, b, km, pm, h, emit_p=True)
                same = torch.equal(o, again[0]) and torch.equal(p, again[1])
                log(f"kernel global_attention_fwd {str(dtype):14s} {label}: two calls "
                    f"bit-identical (o and P): {same}")
                check(same, f"two global_attention_fwd calls differ at {label}")
                del again
            if label in K12_NO_P_SHAPES:
                o_np, p_np = ga.global_attention_fwd(q, k, v, b, km, pm, h, emit_p=False)
                torch.cuda.synchronize()
                check(p_np is None, f"global_attention_fwd emitted P unasked at {label}")
                err, ok = compare(o_np, ro, tol)
                errors["global_attention_fwd"] = max(errors["global_attention_fwd"], err)
                same = torch.equal(o_np, o)
                log(f"kernel global_attention_fwd o     {str(dtype):14s} {label} without P: "
                    f"max_abs_err={err:.3e} tol=atol {tol[0]:g} + rtol {tol[1]:g}·|twin| "
                    f"{'ok' if ok else 'FAIL'}; bit for bit the o of the call with P: {same}")
                check(ok, f"global_attention_fwd without P disagrees with its twin at {label} "
                          f"{dtype}")
                if dtype == torch.bfloat16:
                    check(same, f"the bf16 forward's o differs with and without P at {label}")
                del o_np
            if dtype == torch.bfloat16 and km is None and pm is None:
                of = ga.window_core_bwd(q, k, v, do, b, None, h, False)[3]
                torch.cuda.synchronize()
                same = torch.equal(o, of)
                log(f"kernel global_attention_fwd {str(dtype):14s} {label}: o equals the "
                    f"recompute rows kernel's of bit for bit: {same} (max abs "
                    f"difference {float((o.float() - of.float()).abs().max()):.3e})")
                check(same, f"the bf16 forward's o and the recompute rows kernel's of differ at "
                            f"{label}")
                del of
            if label == K12_SAME_SHAPE and dtype == torch.bfloat16:
                again = ga.global_attention_bwd_recompute(q, k, v, do, b, km, pm, h, grad_bias)
                same = all(torch.equal(x, y) for x, y in zip(rec, again) if x is not None)
                log(f"kernel {K12_RECOMPUTE} {str(dtype):14s} {label}: two calls bit-identical: "
                    f"{same}")
                check(same, f"two {K12_RECOMPUTE} calls differ at {label}")
                del again
            if label in K12_P_SAME_SHAPES and dtype == torch.bfloat16:
                again = ga.global_attention_bwd(q, k, v, do, rp, pm, h, grad_bias)
                same = all(torch.equal(x, y) for x, y in zip(got, again) if x is not None)
                log(f"kernel global_attention_bwd {str(dtype):14s} {label}: two calls "
                    f"bit-identical: {same}")
                check(same, f"two global_attention_bwd calls differ at {label}")
                del again
            results = [("global_attention_fwd", "o", o, ro, tol),
                       ("global_attention_fwd", "P", p, rp, F32_TOL)]
            parts = ("dq", "dk", "dv", "dbias")
            results += [("global_attention_bwd", part, g, w, tol if part != "dbias" else F32_TOL)
                        for part, g, w in zip(parts, got, want) if w is not None]
            results += [(K12_RECOMPUTE, part, g, w, tol if part != "dbias" else F32_TOL)
                        for part, g, w in zip(parts, rec, want) if w is not None]
            extras = "+".join(n for n, on in (("bias" if bias is True else "causal bias", bias),
                                              ("kmask", kmask), ("pmult", pmult))
                              if on) or "no extras"
            for name, part, out, ref, t in results:
                err, ok = compare(out, ref, t)
                errors[name] = max(errors[name], err)
                log(f"kernel {name} {part:5s} {str(dtype):14s} {label} B={B} N={N} C={C} h={h} "
                    f"{extras}: max_abs_err={err:.3e} tol=atol {t[0]:g} + rtol {t[1]:g}·|twin| "
                    f"{'ok' if ok else 'FAIL'}")
                check(ok, f"{name} {part} disagrees with its twin at {label} {dtype}")
            if B * h * N * N * 4 <= ga.STORE_P_MAX_BYTES:
                stored = ga.global_attention_bwd(q, k, v, do, p, pm, h, grad_bias)
                torch.cuda.synchronize()
                for part, r_, s_ in zip(parts, rec, stored):
                    if s_ is None:
                        continue
                    err, ok = compare(r_, s_, tol if part != "dbias" else F32_TOL)
                    log(f"kernel {K12_RECOMPUTE} {part:5s} {str(dtype):14s} {label} against "
                        f"global_attention_bwd on the kernel's P: max_abs_err={err:.3e} "
                        f"{'ok' if ok else 'FAIL'}")
                    check(ok, f"the recompute and stored-P backwards disagree on {part} at "
                              f"{label} {dtype}")
            del o, p, ro, rp, got, want, rec
    return errors


def k12_bound(B, N, C, heads, itemsize, kind, bias=True, grad_bias=True, emit_p=True,
              kmask=False, pmult=False):
    """The least time (ms) for one K12 call: every input read once and every
    output written once over the HBM rate, against its products over the
    bf16 tensor-core rate (2·B·N²·C operations each). Forward: q, k, v, the
    bias, kmask and pmult → o, and P when emitted; two products. Stored-P
    backward: q, k, v, do, P → dq, dk, dv, dbias; four products. Recompute
    backward: q, k, v, do, the bias, the kmask and pmult → dq, dk, dv,
    dbias; five products (the scores, dp, dv, dq, dk). Returns (ms, bytes,
    operations)."""
    act = B * N * C * itemsize
    plane = heads * N * N * 4
    product = 2 * B * N * N * C
    if kind == "fwd":
        nbytes = 4 * act + bias * plane + emit_p * B * plane + kmask * B * N * 4 + pmult * N * N * 4
        ops = 2 * product
    elif kind == "bwd":
        nbytes, ops = 7 * act + B * plane + grad_bias * plane, 4 * product
    else:
        nbytes = 7 * act + bias * plane + grad_bias * plane + B * N * 4 + N * N * 4
        ops = 5 * product
    return max(nbytes / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S) * 1e3, nbytes, ops


def sdpa_times(q, k, v, do, mask, h):
    """F.scaled_dot_product_attention on the same (B, N, C) q, k, v as (B, h,
    N, hd), ``mask`` its additive attn_mask (the port never calls it):
    (forward ms, backward ms), as ``sdpa_head_times`` measures them."""
    B, N, C = q.shape
    return sdpa_head_times(*(t.reshape(B, N, h, C // h).transpose(1, 2).contiguous()
                             for t in (q, k, v, do)), mask)


def sdpa_head_times(qh, kh, vh, doh, mask):
    """F.scaled_dot_product_attention on q (B, h, Nq, hd), k and v (B, h,
    Nk, hd), ``mask`` its additive attn_mask or None: (forward ms, backward
    ms). The forward is the mean of two runs of 20 calls by CUDA events. The
    backward is the device time (torch.profiler, all its device events) of
    autograd's backward alone, run again and again on one retained graph: a
    difference of two host-clock means swung 2x from run to run."""
    import torch
    import torch.nn.functional as F

    qh, kh, vh = (t.detach().requires_grad_(True) for t in (qh, kh, vh))

    def fwd():
        with torch.no_grad():
            return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)

    out = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)

    def bwd():
        return torch.autograd.grad(out, (qh, kh, vh), doh, retain_graph=True)

    f = (time_ms(fwd, 20, 3) + time_ms(fwd, 20, 3)) / 2
    bwd()
    b, _ = device_us(bwd, n=10)
    return f, (b / 1e3 if b > 0 else None)  # None: the trace kept no record of it


def phase_k12_times(ga, device, card):
    """K12 forward (emitting P, as a train step does) and stored-P backward
    against their twins at BEiT-large's shape, bf16, with a bias, and the
    recompute backward against its twin at BERT-base's T=512 train shape
    (B=32, kmask + pmult); the yardstick F.scaled_dot_product_attention on the
    same q, k, v as (B, h, N, hd) with the bias (BEiT) or the key mask (BERT,
    without pmult, which it does not take) as its additive mask, forward and
    backward (the port never calls it)."""
    import torch

    B, N, C, h, _, _, _ = K12_SHAPES["beitv2-large"]
    (q, k, v), do, b, _, _ = k12_inputs(B, N, C, h, True, False, False, torch.bfloat16, device,
                                         seed=31)
    _, p = ga.global_attention_fwd(q, k, v, b, None, None, h, emit_p=True)
    calls = {
        "global_attention_fwd": (
            lambda: ga.global_attention_fwd(q, k, v, b, None, None, h, emit_p=True),
            lambda: ga.attention_core_plain(q, k, v, b, None, None, h)),
        "global_attention_bwd": (
            lambda: ga.global_attention_bwd(q, k, v, do, p, None, h, True),
            lambda: ga.attention_core_bwd_plain(q, k, v, do, p, None, h, True)),
    }
    lib_fwd, lib_bwd = sdpa_times(q, k, v, do, b.to(torch.bfloat16)[None], h)
    shapes = {name: ("beitv2-large", B, N, C, h, "bias") for name in calls}
    library = {"global_attention_fwd": lib_fwd, "global_attention_bwd": lib_bwd}
    bounds = {"global_attention_fwd": k12_bound(B, N, C, h, 2, "fwd"),
              "global_attention_bwd": k12_bound(B, N, C, h, 2, "bwd")}

    B2, N2, C2, h2, _, _, _ = K12_SHAPES["bert-base-T512"]
    (q2, k2, v2), do2, _, km2, pm2 = k12_inputs(B2, N2, C2, h2, False, True, True,
                                                torch.bfloat16, device, seed=37)
    calls[K12_RECOMPUTE] = (
        lambda: ga.global_attention_bwd_recompute(q2, k2, v2, do2, None, km2, pm2, h2, False),
        lambda: ga.attention_core_bwd_recompute_plain(q2, k2, v2, do2, None, km2, pm2, h2,
                                                      False))
    shapes[K12_RECOMPUTE] = ("bert-base-T512", B2, N2, C2, h2, "kmask+pmult")
    library[K12_RECOMPUTE] = sdpa_times(q2, k2, v2, do2, km2.to(torch.bfloat16)[:, None, None],
                                        h2)[1]
    bounds[K12_RECOMPUTE] = k12_bound(B2, N2, C2, h2, 2, "recompute", bias=False,
                                      grad_bias=False)
    out = {}
    for name, (kern, twin) in calls.items():
        label, Bx, Nx, Cx, hx, extras = shapes[name]
        out[name] = time_record(card, name, f"{label} B={Bx} N={Nx} C={Cx} h={hx} {extras}", kern,
                                twin, K12_KERNELS[name], bounds[name], library[name])
    log(f"[{card}] time F.scaled_dot_product_attention bf16 on the same (B, h, N, hd) q, k, v: "
        f"beitv2-large with the bias as attn_mask forward {ms_us(lib_fwd)}, backward "
        f"{ms_us(lib_bwd)}; bert-base-T512 with the key mask as attn_mask (no pmult) "
        f"backward {ms_us(library[K12_RECOMPUTE])} (forwards by CUDA events; backwards "
        f"the device time of autograd's backward alone, torch.profiler)")
    del q, k, v, do, b, p, q2, k2, v2, do2, km2, pm2, calls
    phase_k12_fwd_shapes(ga, device, card)
    phase_k12_p_shapes(ga, device, card)
    return out


def sdpa_mask(b, km):
    """SDPA's additive attn_mask for K12's bias (or causal bias) and key
    mask, bf16 (None without either; SDPA takes no pmult)."""
    import torch

    mask = None if b is None else b.to(torch.bfloat16)[None]
    if km is not None:
        kmb = km.to(torch.bfloat16)[:, None, None]
        mask = kmb if mask is None else mask + kmb
    return mask


def sdpa_fwd_ms(q, k, v, mask, h):
    """F.scaled_dot_product_attention's forward on the same (B, N, C) q, k, v
    as (B, h, N, hd) with ``mask`` as its attn_mask (the port never calls
    it): the mean of two runs of 20 calls by CUDA events."""
    import torch
    import torch.nn.functional as F

    B, N, C = q.shape
    qh, kh, vh = (t.reshape(B, N, h, C // h).transpose(1, 2).contiguous() for t in (q, k, v))

    def fwd():
        with torch.no_grad():
            return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)

    return (time_ms(fwd, 20, 3) + time_ms(fwd, 20, 3)) / 2


def phase_k12_fwd_shapes(ga, device, card):
    """The bf16 forward at every shape of K12_SHAPES, emitting P where the
    stored-P route does (its P within STORE_P_MAX_BYTES) and without it
    where the recompute route runs (BERT-base and GPT-2 at T=512, GPT-2 at
    T=1024): per call and device time against the twin, the bound and the
    same run's SDPA forward, with the bias, the causal bias or the key mask
    as its attn_mask (SDPA takes no pmult)."""
    import torch

    out = {}
    for label, (B, N, C, h, bias, kmask, pmult) in K12_SHAPES.items():
        emit_p = B * h * N * N * 4 <= ga.STORE_P_MAX_BYTES
        (q, k, v), _, b, km, pm = k12_inputs(B, N, C, h, bias, kmask, pmult, torch.bfloat16,
                                             device, seed=N + C)
        extras = "+".join(n for n, on in (("bias" if bias is True else "causal bias", bias),
                                          ("kmask", kmask), ("pmult", pmult)) if on) or "no extras"
        out[label] = time_record(
            card, "global_attention_fwd",
            f"{label} B={B} N={N} C={C} h={h} {extras}, {'P emitted' if emit_p else 'no P'}",
            lambda: ga.global_attention_fwd(q, k, v, b, km, pm, h, emit_p),  # noqa: B023
            lambda: ga.attention_core_plain(q, k, v, b, km, pm, h),  # noqa: B023
            K12_KERNELS["global_attention_fwd"],
            k12_bound(B, N, C, h, 2, "fwd", bias=b is not None, emit_p=emit_p,
                      kmask=km is not None, pmult=pm is not None),
            sdpa_fwd_ms(q, k, v, sdpa_mask(b, km), h))
        del q, k, v, b, km, pm
    torch.cuda.empty_cache()
    return out


def phase_k12_p_shapes(ga, device, card):
    """The bf16 stored-P backward at every other shape of K12_SHAPES whose P
    is within the stored-P limit (where the main path runs it): per call and
    device time against the twin, the bound and the same run's SDPA
    backward, with the bias, the causal bias or the key mask as its attn_mask
    (SDPA takes no pmult)."""
    import torch

    for label, (B, N, C, h, bias, kmask, pmult) in K12_SHAPES.items():
        if label == "beitv2-large" or B * h * N * N * 4 > ga.STORE_P_MAX_BYTES:
            continue
        grad_bias = bias is True
        (q, k, v), do, b, km, pm = k12_inputs(B, N, C, h, bias, kmask, pmult, torch.bfloat16,
                                              device, seed=N + C)
        _, p = ga.global_attention_fwd(q, k, v, b, km, pm, h, emit_p=True)
        mask = sdpa_mask(b, km)
        extras = "+".join(n for n, on in (("bias" if bias is True else "causal bias", bias),
                                          ("kmask", kmask), ("pmult", pmult)) if on) or "no extras"
        names = K12_KERNELS["global_attention_bwd"][:3 if grad_bias else 2]
        time_record(card, "global_attention_bwd", f"{label} B={B} N={N} C={C} h={h} {extras}",
                    lambda: ga.global_attention_bwd(q, k, v, do, p, pm, h, grad_bias),  # noqa: B023
                    lambda: ga.attention_core_bwd_plain(q, k, v, do, p, pm, h,  # noqa: B023
                                                        grad_bias),
                    names, k12_bound(B, N, C, h, 2, "bwd", grad_bias=grad_bias),
                    sdpa_times(q, k, v, do, mask, h)[1])
        del q, k, v, do, b, km, pm, p, mask
    torch.cuda.empty_cache()


def k11_inputs(B, h, Nq, k_size, dtype, device, seed):
    """q, k, v, bias_h, bias_w and do at one pooled-attention shape (96
    channels a head), drawn on the card: unit-scale q, k, v (they come out
    of a LayerNorm), rel-pos-like bias terms at 0.5."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    Kh, Kw = k_size

    def r(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=device) * scale).to(dtype)

    return (r(B, h, Nq, K11_HD), r(B, h, Kh * Kw, K11_HD), r(B, h, Kh * Kw, K11_HD),
            r(B, h, Nq, Kh, scale=0.5), r(B, h, Nq, Kw, scale=0.5), r(B, h, Nq, K11_HD))


def phase_k11(pa, device):
    """K11 forward (o and P) and backward (dq, dk, dv, dbias_h, dbias_w)
    against their twins at MViTv2-small's seven attention shapes, B=64 in
    bf16 (BF16_TOL; P and the bias gradients F32_TOL) and B=8 in fp32
    (F32_TOL, TF32 off), and at a rectangular key grid with a ragged query
    edge, and at a one-row key grid whose bias accumulators do not fit in
    shared memory; the backward on both sides takes the twin's P. At
    ``K11_SAME_SHAPE`` two bf16 forward calls are bit-identical, at
    ``K11_BWD_SAME_SHAPES`` two bf16 backward calls."""
    import torch

    from skinjax_torch import MVIT_BATCH

    errors = {name: 0.0 for name in K11}
    cases = [(label, h, Nq, ks) for label, (h, Nq, ks, _) in K11_SHAPES.items()]
    extra = {"ragged": K11_RAGGED, "wide": K11_WIDE}
    cases += [(label, *shape[1:]) for label, shape in extra.items()]
    for label, h, Nq, k_size in cases:
        for dtype, tol, B in ((torch.bfloat16, BF16_TOL, MVIT_BATCH),
                              (torch.float32, F32_TOL, K11_F32_BATCH)):
            if label in extra:
                B = extra[label][0]
            q, k, v, bh, bw, do = k11_inputs(B, h, Nq, k_size, dtype, device, seed=Nq + h)
            o, p = pa.pooled_attention_fwd(q, k, v, bh, bw, k_size, emit_p=True)
            if label == K11_SAME_SHAPE and dtype == torch.bfloat16:
                o2, p2 = pa.pooled_attention_fwd(q, k, v, bh, bw, k_size, emit_p=True)
                same = torch.equal(o, o2) and torch.equal(p, p2)
                log(f"kernel pooled_attention_fwd {str(dtype):14s} {label}: two calls "
                    f"bit-identical (o and P): {same}")
                check(same, f"two pooled_attention_fwd calls differ at {label}")
                del o2, p2
            ro, rp = pa.pooled_attention_plain(q, k, v, bh, bw, k_size)
            got = pa.pooled_attention_bwd(q, k, v, do, rp, k_size)
            if label in K11_BWD_SAME_SHAPES and dtype == torch.bfloat16:
                again = pa.pooled_attention_bwd(q, k, v, do, rp, k_size)
                same = all(torch.equal(x, y) for x, y in zip(got, again))
                log(f"kernel pooled_attention_bwd {str(dtype):14s} {label}: two calls "
                    f"bit-identical: {same}")
                check(same, f"two pooled_attention_bwd calls differ at {label}")
                del again
            want = pa.pooled_attention_bwd_plain(q, k, v, do, rp, k_size)
            torch.cuda.synchronize()
            results = [("pooled_attention_fwd", "o", o, ro, tol),
                       ("pooled_attention_fwd", "P", p, rp, F32_TOL)]
            results += [("pooled_attention_bwd", part, g, w,
                         tol if part in ("dq", "dk", "dv") else F32_TOL)
                        for part, g, w in zip(("dq", "dk", "dv", "dbias_h", "dbias_w"), got, want)]
            for name, part, out, ref, t in results:
                err, ok = compare(out, ref, t)
                errors[name] = max(errors[name], err)
                log(f"kernel {name} {part:7s} {str(dtype):14s} {label} B={B} h={h} Nq={Nq} "
                    f"k_size={k_size} hd={K11_HD}: max_abs_err={err:.3e} tol=atol {t[0]:g} + "
                    f"rtol {t[1]:g}·|twin| {'ok' if ok else 'FAIL'}")
                check(ok, f"{name} {part} disagrees with its twin at {label} {dtype}")
            del o, p, ro, rp, got, want
    torch.cuda.empty_cache()
    return errors


def k11_bound(B, h, Nq, k_size, itemsize, backward):
    """The least time (ms) for one K11 call: every input read once and every
    output written once over the HBM rate, against its products over the
    bf16 tensor-core rate (2·B·h·Nq·Nk·hd operations each). Forward: q, k, v,
    bias_h, bias_w → o, P; two products. Backward: q, k, v, do, P → dq, dk,
    dv, dbias_h, dbias_w (fp32); four products. Returns (ms, bytes,
    operations)."""
    Kh, Kw = k_size
    Nk = Kh * Kw
    q = B * h * Nq * K11_HD * itemsize
    kv = B * h * Nk * K11_HD * itemsize
    plane = B * h * Nq * Nk * 4
    product = 2 * B * h * Nq * Nk * K11_HD
    if backward:
        nbytes, ops = 3 * q + 4 * kv + plane + B * h * Nq * (Kh + Kw) * 4, 4 * product
    else:
        nbytes, ops = 2 * q + 2 * kv + B * h * Nq * (Kh + Kw) * itemsize + plane, 2 * product
    return max(nbytes / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S) * 1e3, nbytes, ops


def phase_k11_times(pa, device, card):
    """K11 forward (emitting P, as a train step does) and backward against
    their twins at MViTv2-small's seven shapes, B=64, bf16: per call by CUDA
    events in turns, device time by torch.profiler, the bound, and the
    yardstick F.scaled_dot_product_attention on the same q, k, v with the
    expanded (B, h, Nq, Nk) bias as its attn_mask (built outside the timed
    region; the port never calls it), forward and backward. Then K11's sum
    over the 16 blocks of a train step. Returns {(name, label): times}."""
    import torch

    from skinjax_torch import MVIT_BATCH

    B = MVIT_BATCH
    out = {}
    step = {name: [0.0, 0.0, 0.0, 0.0] for name in K11}  # per call, device, twin, bound
    for label, (h, Nq, k_size, count) in K11_SHAPES.items():
        q, k, v, bh, bw, do = k11_inputs(B, h, Nq, k_size, torch.bfloat16, device, seed=41)
        _, p = pa.pooled_attention_fwd(q, k, v, bh, bw, k_size, emit_p=True)
        calls = {
            "pooled_attention_fwd": (
                lambda: pa.pooled_attention_fwd(q, k, v, bh, bw, k_size, emit_p=True),  # noqa: B023
                lambda: pa.pooled_attention_plain(q, k, v, bh, bw, k_size)),  # noqa: B023
            "pooled_attention_bwd": (
                lambda: pa.pooled_attention_bwd(q, k, v, do, p, k_size),  # noqa: B023
                lambda: pa.pooled_attention_bwd_plain(q, k, v, do, p, k_size)),  # noqa: B023
        }
        Nk = k_size[0] * k_size[1]
        mask = (bh.float()[..., :, None] + bw.float()[..., None, :]).reshape(B, h, Nq, Nk)
        library = dict(zip(K11, sdpa_head_times(q, k, v, do, mask.to(q.dtype))))
        del mask
        for name, (kern, twin) in calls.items():
            t = [time_ms(twin, 10, 2), time_ms(kern, 10, 2), time_ms(kern, 10, 2),
                 time_ms(twin, 10, 2)]
            ms, plain_ms = (t[1] + t[2]) / 2, (t[0] + t[3]) / 2
            dev_k = kernel_device_us(kern, K11_KERNELS[name], n=5)
            dev_t, _ = device_us(twin, n=5)
            bound_ms, nbytes, ops = k11_bound(B, h, Nq, k_size, 2, name.endswith("bwd"))
            bound_by = "bytes" if nbytes / HBM_BYTES_PER_S >= ops / BF16_OPS_PER_S \
                else "operations"
            out[(name, label)] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                      bound_by=bound_by, library_ms=library[name])
            for i, x in enumerate((ms, None if dev_k is None else dev_k / 1e3, plain_ms,
                                   bound_ms)):
                step[name][i] = None if None in (x, step[name][i]) else step[name][i] + count * x
            log(f"[{card}] time {name} bf16 {label} B={B} h={h} Nq={Nq} k_size={k_size} "
                f"hd={K11_HD} per call: kernel {ms * 1e3:9.2f} us  twin {plain_ms * 1e3:9.2f} us "
                f"(CUDA events, in turns twin-kernel-kernel-twin); device time: kernel "
                f"{us(dev_k)}  twin {dev_t:9.2f} us (torch.profiler); bound "
                f"{bound_ms * 1e3:.2f} us ({nbytes / 1e6:.1f} MB at 3.35 TB/s, {ops / 1e9:.2f} "
                f"GFLOP at 989 TFLOP/s); F.scaled_dot_product_attention with the expanded bias "
                f"as attn_mask {'forward' if name.endswith('fwd') else 'backward'} "
                f"{ms_us(library[name])}; {against(ms, bound_ms, library[name])}")
        del q, k, v, bh, bw, do, p, calls
        torch.cuda.empty_cache()
    for name, (ms, dev, plain_ms, bound_ms) in step.items():
        log(f"[{card}] time {name} bf16 MViTv2-small B={B}, the {K11_PER_FORWARD} blocks of a "
            f"step: kernel {ms:.3f} ms per call sum, {ms_us(dev)} device time, twin "
            f"{plain_ms:.3f} ms, bound {bound_ms:.3f} ms")
    return out


@contextlib.contextmanager
def small_mvit_registered():
    """A small MViTv2 (dims (96, 192), depths (1, 1), heads (1, 2): 96
    channels a head, as mvitv2_small; 64×64 images, so Nq 256 → Nk 16 and
    then 64 → 64) as backbone ``SMALL_MVIT`` meanwhile."""
    from skinjax_torch.models.backbones import _REGISTRY
    from skinjax_torch.models.backbones.mvit import MViTv2

    _REGISTRY[SMALL_MVIT] = (
        lambda device=None: MViTv2((96, 192), (1, 1), (1, 2), img_size=64, device=device), 192)
    try:
        yield
    finally:
        del _REGISTRY[SMALL_MVIT]


def mlp_inputs(kind, T, D, H, dtype, device, seed):
    """A fused-MLP call's arguments at (T, D, H), D2 = D, drawn on the card:
    unit-scale x and dy, fan-in-scaled weights; K9's biases at 0.1, K10's
    s = 1.3 and b = -0.2 (fp32). Returns (args, dy)."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)

    def r(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=device) * scale).to(dtype)

    x, w1, w2, dy = r(T, D), r(D, H, scale=D ** -0.5), r(H, D, scale=H ** -0.5), r(T, D)
    if kind == "gelu":
        return (x, w1, r(H, scale=0.1), w2, r(D, scale=0.1)), dy
    s = torch.tensor([1.3], device=device)
    b = torch.tensor([-0.2], device=device)
    return (x, w1, s, b, w2), dy


def mlp_calls(fm, kind, args, dy):
    """(forward kernel, forward twin, backward kernel, backward twin) on args."""
    if kind == "gelu":
        x, w1, b1, w2, _ = args
        return (lambda: fm.mlp_gelu_fwd(*args), lambda: fm.mlp_gelu_plain(*args),
                lambda: fm.mlp_gelu_bwd(x, dy, w1, b1, w2),
                lambda: fm.mlp_gelu_bwd_plain(x, dy, w1, b1, w2))
    x, w1, s, b, w2 = args
    return (lambda: fm.mlp_star_fwd(*args), lambda: fm.mlp_star_plain(*args),
            lambda: fm.mlp_star_bwd(x, dy, w1, s, b, w2),
            lambda: fm.mlp_star_bwd_plain(x, dy, w1, s, b, w2))


def compare_scaled(out, ref, tol):
    """(max abs error, within tol·max(1, max |ref|)) of a gradient against
    its twin's."""
    import torch

    check(out.dtype == ref.dtype and out.shape == ref.shape,
          f"{out.dtype}{tuple(out.shape)} vs twin {ref.dtype}{tuple(ref.shape)}")
    check(bool(torch.isfinite(out.float()).all()), "non-finite kernel output")
    err = float((out.float() - ref.float()).abs().max())
    return err, err <= tol * max(1.0, float(ref.float().abs().max()))


def raises(fn, exc) -> bool:
    try:
        fn()
    except exc:
        return True
    return False


def mlp_check(fm, fn, label, args, dy, errors):
    """One fused-MLP case against its twin: y and dx at BF16_TOL/F32_TOL,
    the weight, bias and scalar gradients at MLP_GRAD_TOL of max(1, max
    |twin|), and two backward calls bit-identical. Raises ``errors[name]``
    to each error seen; fails the run on a mismatch."""
    import torch

    kind = fn.split("_")[1]
    parts = (("dx", "dw1", "db1", "dw2", "db2") if kind == "gelu"
             else ("dx", "dw1", "ds", "db", "dw2"))
    x, w1 = args[:2]
    (T, D), H = x.shape, w1.shape[1]
    dname = str(x.dtype).split(".")[1]
    tol = BF16_TOL if x.dtype == torch.bfloat16 else F32_TOL
    fwd, fwd_twin, bwd, bwd_twin = mlp_calls(fm, kind, args, dy)
    y, y_twin = fwd(), fwd_twin()
    got, want, again = bwd(), bwd_twin(), bwd()
    torch.cuda.synchronize()
    results = [(f"{fn}_fwd", "y", *compare(y, y_twin, tol),
                f"atol {tol[0]:g} + rtol {tol[1]:g}·|twin|")]
    for part, g, w in zip(parts, got, want):
        if part == "dx":
            results.append((f"{fn}_bwd", part, *compare(g, w, tol),
                            f"atol {tol[0]:g} + rtol {tol[1]:g}·|twin|"))
        else:
            results.append((f"{fn}_bwd", part, *compare_scaled(g, w, MLP_GRAD_TOL[dname]),
                            f"{MLP_GRAD_TOL[dname]:g}·max(1, |twin|)"))
    for name, part, err, ok, tol_text in results:
        errors[name] = max(errors[name], err)
        log(f"kernel {name} {part:3s} {dname:8s} {label} T={T} D={D} H={H}: "
            f"max_abs_err={err:.3e} tol={tol_text} {'ok' if ok else 'FAIL'}")
        check(ok, f"{name} {part} disagrees with its twin at {label} {dname}")
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    log(f"kernel {fn}_bwd {dname} {label} T={T}: two calls bit-identical: {same}")
    check(same, f"two {fn}_bwd calls differ at {label} {dname}")


def phase_mlp(fm, device):
    """K10 and K9, forward and backward, against their twins at every (D, H)
    of CAFormer-b36 and CoaT-lite-small with T = MLP_CHECK_T, and K10 at
    CAFormer-b36's stage-0 shape at its full T, bf16 and fp32 (TF32 off): y
    and dx at BF16_TOL/F32_TOL, the weight, bias and scalar gradients at
    MLP_GRAD_TOL of max(1, max |twin|). At each case: two backward calls are
    bit-identical. At the first shape of each, in both dtypes: rows whose dy
    is 0 add nothing (x changed on those rows leaves every weight gradient,
    and dx on the other rows, bit-identical). The wrappers raise on fp16, a
    width that is not a multiple of 16 and a misshapen bias."""
    import torch

    from skinjax_torch import CAFORMER_BATCH

    errors = {name: 0.0 for name in (*K9, *K10)}
    cases = [("mlp_star", label, MLP_CHECK_T, D, H) for label, (_, D, H, _) in K10_SHAPES.items()]
    cases += [("mlp_gelu", label, MLP_CHECK_T, D, H) for label, (_, D, H, _) in K9_SHAPES.items()]
    n0, D0, H0, _ = K10_SHAPES["stage0"]
    cases.append(("mlp_star", "stage0-full", CAFORMER_BATCH * n0, D0, H0))
    first = {"mlp_star": cases[0][1], "mlp_gelu": cases[len(K10_SHAPES)][1]}
    for fn, label, T, D, H in cases:
        kind = fn.split("_")[1]
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).split(".")[1]
            args, dy = mlp_inputs(kind, T, D, H, dtype, device, seed=T + H)
            mlp_check(fm, fn, label, args, dy, errors)
            if label == first[fn]:
                rows = slice(T // 3, T // 3 + 77)
                dz = dy.clone()
                dz[rows] = 0
                x2 = args[0].clone()
                gen = torch.Generator(device=device).manual_seed(T)
                x2[rows] = (3 * torch.randn(x2[rows].shape, generator=gen, device=device)).to(dtype)
                _, _, bwd_a, _ = mlp_calls(fm, kind, args, dz)
                _, _, bwd_b, _ = mlp_calls(fm, kind, (x2, *args[1:]), dz)
                a, b = bwd_a(), bwd_b()
                keep = torch.ones(T, dtype=torch.bool, device=device)
                keep[rows] = False
                same = (all(torch.equal(u, v) for u, v in zip(a[1:], b[1:]))
                        and torch.equal(a[0][keep], b[0][keep]))
                log(f"kernel {fn}_bwd {dname} {label}: 77 rows of zero dy add nothing (x "
                    f"changed there, the gradients bit-identical): {same}")
                check(same, f"zero dy rows changed a {fn}_bwd gradient")
            del args, dy
    x = torch.randn(8, 64, device=device, dtype=torch.bfloat16)
    w1 = torch.randn(64, 256, device=device, dtype=torch.bfloat16)
    w2 = torch.randn(256, 64, device=device, dtype=torch.bfloat16)
    s1 = torch.ones(1, device=device)
    bad = {"fp16": (lambda: fm.mlp_star_fwd(x.half(), w1.half(), s1, s1, w2.half()), TypeError),
           "D=24": (lambda: fm.mlp_star_fwd(x[:, :24], w1[:24], s1, s1, w2[:, :24]), ValueError),
           "b1 (255,)": (lambda: fm.mlp_gelu_fwd(x, w1, w1[0, :255], w2, x[0]), ValueError)}
    for what, (call, exc) in bad.items():
        ok = raises(call, exc)
        log(f"kernel wrappers raise {exc.__name__} on {what}: {ok}")
        check(ok, f"the fused MLP wrappers took {what}")
    torch.cuda.empty_cache()
    return errors


def phase_mlp_same_bits(fm, device):
    """Two bf16 calls on the same inputs give the same bits (every sum in a
    fixed order, no atomics): ``mlp_star_fwd``/``_bwd`` at CAFormer-b36's
    stage 2 (B=32) and ``mlp_gelu_fwd``/``_bwd`` at CoaT-lite-small's stage
    3 (B=64), the record shapes, on inputs of their own seed. Then the
    served batches (B=1 and 8) at every shape of both models, where the
    forward splits its hidden columns over blocks: y against the twin
    (BF16_TOL) and two calls bit-identical."""
    import torch

    from skinjax_torch import CAFORMER_BATCH, COAT_BATCH

    for fn, shapes, B in (("mlp_star", K10_SHAPES, CAFORMER_BATCH),
                          ("mlp_gelu", K9_SHAPES, COAT_BATCH)):
        label = MLP_RECORD[fn]
        n, D, H, _ = shapes[label]
        kind = fn.split("_")[1]
        args, dy = mlp_inputs(kind, B * n, D, H, torch.bfloat16, device, seed=97)
        fwd, _, bwd, _ = mlp_calls(fm, kind, args, dy)
        y1, y2 = fwd(), fwd()
        first, second = bwd(), bwd()
        torch.cuda.synchronize()
        same = torch.equal(y1, y2)
        log(f"kernel {fn}_fwd bfloat16 {label} B={B} T={B * n} D={D} H={H}: two calls on the "
            f"same inputs bit-identical: {same}")
        check(same, f"two {fn}_fwd calls differ at {label} B={B}")
        same = all(torch.equal(u, v) for u, v in zip(first, second))
        log(f"kernel {fn}_bwd bfloat16 {label} B={B} T={B * n} D={D} H={H}: two calls on the "
            f"same inputs bit-identical (dx and every weight and bias gradient): {same}")
        check(same, f"two {fn}_bwd calls differ at {label} B={B}")
        del args, dy, first, second, y1, y2
    for fn, shapes in (("mlp_star", K10_SHAPES), ("mlp_gelu", K9_SHAPES)):
        kind = fn.split("_")[1]
        for label, (n, D, H, _) in shapes.items():
            for B in (1, 8):
                args, dy = mlp_inputs(kind, B * n, D, H, torch.bfloat16, device, seed=B + n)
                fwd, twin, _, _ = mlp_calls(fm, kind, args, dy)
                y1, y2, want = fwd(), fwd(), twin()
                torch.cuda.synchronize()
                err, ok = compare(y1, want, BF16_TOL)
                same = torch.equal(y1, y2)
                log(f"kernel {fn}_fwd bfloat16 {label} B={B} T={B * n} D={D} H={H}: "
                    f"max_abs_err={err:.3e} tol={tol_text(BF16_TOL)} {'ok' if ok else 'FAIL'}; "
                    f"two calls bit-identical: {same}")
                check(ok, f"{fn}_fwd disagrees with its twin at {label} B={B}")
                check(same, f"two {fn}_fwd calls differ at {label} B={B}")
                del args, dy, y1, y2, want
    torch.cuda.empty_cache()


def mlp_bound(T, D, H, itemsize, kind, backward):
    """The least time (ms) for one fused-MLP call (D2 = D): every input read
    once and every output written once over the HBM rate, against its
    products over the bf16 tensor-core rate (2·T·D·H operations each).
    Forward: x, w1, w2 (K9: b1, b2; K10: s, b) → y; two products. Backward:
    x, dy, w1, w2 (K9: b1) → dx, dw1 and dw2 fp32 (K9: db1, db2; K10: ds,
    db); the recomputed pre-activation and four products. Returns (ms,
    bytes, operations)."""
    act, weights = T * D * itemsize, 2 * D * H * itemsize
    extra_in = (H + D) * itemsize if kind == "gelu" else 8
    if backward:
        extra_out = (H + D) * 4 if kind == "gelu" else 8
        nbytes = 3 * act + weights + 2 * D * H * 4 + (H * itemsize if kind == "gelu" else 8) \
            + extra_out
        ops = 10 * T * D * H
    else:
        nbytes, ops = 2 * act + weights + extra_in, 4 * T * D * H
    return max(nbytes / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S) * 1e3, nbytes, ops


def mlp_chain_times(kind, args, dy):
    """The unfused chain the kernel replaces, F.linear → activation →
    F.linear (cuBLAS and PyTorch's elementwise kernels; the port never calls
    it), on the same inputs: (forward ms by CUDA events, backward device ms
    by torch.profiler of autograd's backward alone on one retained graph)."""
    import torch
    import torch.nn.functional as F

    x = args[0].detach().requires_grad_(True)
    if kind == "gelu":
        _, w1, b1, w2, b2 = args
        params = [t.detach().requires_grad_(True) for t in (w1.t(), b1, w2.t(), b2)]

        def chain():
            return F.linear(F.gelu(F.linear(x, params[0], params[1]), approximate="none"),
                            params[2], params[3])
    else:
        _, w1, s, b, w2 = args
        params = [t.detach().requires_grad_(True) for t in (w1.t(), s, b, w2.t())]

        def chain():
            r = F.relu(F.linear(x, params[0]))
            return F.linear(params[1].to(x.dtype) * r * r + params[2].to(x.dtype), params[3])

    def fwd():
        with torch.no_grad():
            return chain()

    out = chain()

    def bwd():
        return torch.autograd.grad(out, [x, *params], dy, retain_graph=True)

    f = (time_ms(fwd, 10, 2) + time_ms(fwd, 10, 2)) / 2
    bwd()
    b_us, _ = device_us(bwd, n=5)
    return f, (b_us / 1e3 if b_us > 0 else None)


def phase_mlp_times(fm, device, card, errors):
    """K10 at CAFormer-b36's four shapes (B=32) and K9 at CoaT-lite-small's
    four (B=64), bf16, forward and backward: first held against the twin on
    those inputs (``mlp_check``, raising ``errors``), then per call by CUDA
    events in turns against the twin, device time by torch.profiler, the
    bound, and the unfused cuBLAS chain as the yardstick; then each kernel's
    sum over the blocks of a train step. Returns {(name, label): times}."""
    import torch

    from skinjax_torch import CAFORMER_BATCH, COAT_BATCH

    out = {}
    for fn, shapes, B, model in (("mlp_star", K10_SHAPES, CAFORMER_BATCH, "CAFormer-b36"),
                                 ("mlp_gelu", K9_SHAPES, COAT_BATCH, "CoaT-lite-small")):
        kind = fn.split("_")[1]
        step = {f"{fn}_{d}": [0.0, 0.0, 0.0, 0.0, 0.0] for d in ("fwd", "bwd")}
        for label, (n, D, H, count) in shapes.items():
            T = B * n
            args, dy = mlp_inputs(kind, T, D, H, torch.bfloat16, device, seed=43)
            mlp_check(fm, fn, f"{model} {label} B={B}", args, dy, errors)
            fwd, fwd_twin, bwd, bwd_twin = mlp_calls(fm, kind, args, dy)
            library = dict(zip((f"{fn}_fwd", f"{fn}_bwd"), mlp_chain_times(kind, args, dy)))
            for d, kern, twin in (("fwd", fwd, fwd_twin), ("bwd", bwd, bwd_twin)):
                name = f"{fn}_{d}"
                t = [time_ms(twin, 10, 2), time_ms(kern, 10, 2), time_ms(kern, 10, 2),
                     time_ms(twin, 10, 2)]
                ms, plain_ms = (t[1] + t[2]) / 2, (t[0] + t[3]) / 2
                # per-launch means of each kernel the call runs (the split sum
                # only where T/32 tiles are few)
                means = {n: e.self_device_time_total / e.count for e in device_events(kern, 5)
                         for n in (*MLP_KERNELS[d], MLP_SPLIT) if n in e.key}
                dev_k = (sum(means.values()) if all(n in means for n in MLP_KERNELS[d])
                         else None)
                dev_t, _ = device_us(twin, n=3)
                bound_ms, nbytes, ops = mlp_bound(T, D, H, 2, kind, d == "bwd")
                bound_by = ("bytes" if nbytes / HBM_BYTES_PER_S >= ops / BF16_OPS_PER_S
                            else "operations")
                out[(name, label)] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                          bound_by=bound_by, library_ms=library[name])
                for i, x in enumerate((ms, None if dev_k is None else dev_k / 1e3, plain_ms,
                                       bound_ms, library[name])):
                    step[name][i] = (None if None in (x, step[name][i])
                                     else step[name][i] + count * x)
                log(f"[{card}] time {name} bf16 {model} {label} T={T} D={D} H={H} per call: "
                    f"kernel {ms * 1e3:9.2f} us  twin {plain_ms * 1e3:9.2f} us (CUDA events, in "
                    f"turns twin-kernel-kernel-twin); device time: kernel {us(dev_k)} "
                    f"(torch.profiler: "
                    + ", ".join(f"{k} {v:.1f}" for k, v in means.items())
                    + f"), twin {dev_t:.2f} us; bound {bound_ms * 1e3:.2f} us "
                    f"({nbytes / 1e6:.1f} MB at 3.35 TB/s, {ops / 1e9:.2f} GFLOP at 989 TFLOP/s, "
                    f"{bound_by}); the unfused F.linear chain "
                    f"{'forward' if d == 'fwd' else 'backward (device time)'} "
                    f"{ms_us(library[name])}")
            del args, dy, fwd, fwd_twin, bwd, bwd_twin
            torch.cuda.empty_cache()
        for name, (ms, dev, plain_ms, bound_ms, lib_ms) in step.items():
            log(f"[{card}] time {name} bf16 {model} B={B}, the "
                f"{sum(c for *_, c in shapes.values())} blocks of a step: kernel {ms:.3f} ms per "
                f"call sum, {ms_us(dev)} device time, twin {plain_ms:.3f} ms, bound "
                f"{bound_ms:.3f} ms, the unfused chain {ms_us(lib_ms)}")
    return out


@contextlib.contextmanager
def small_caformer_registered():
    """A small CAFormer (dims (64, 128), depths (1, 1): a SepConv stage and
    an attention stage with residual scaling, 32 channels a head, as
    caformer_b36) as backbone ``SMALL_CAFORMER`` meanwhile."""
    from skinjax_torch.models.backbones import _REGISTRY
    from skinjax_torch.models.backbones.caformer import CAFormer

    _REGISTRY[SMALL_CAFORMER] = (lambda device=None: CAFormer(
        (64, 128), (1, 1), ("conv", "attention"), (False, True), device=device), 128)
    try:
        yield
    finally:
        del _REGISTRY[SMALL_CAFORMER]


@contextlib.contextmanager
def small_coat_registered():
    """A small CoaT-lite (dims (64, 128), depths (1, 1), 8 heads, MLP ratio
    8, as coat_lite_small's first stages) as backbone ``SMALL_COAT``
    meanwhile."""
    from skinjax_torch.models.backbones import _REGISTRY
    from skinjax_torch.models.backbones.coat import CoaTLite

    _REGISTRY[SMALL_COAT] = (lambda device=None: CoaTLite(
        (64, 128), (1, 1), 8, (8.0, 8.0), device=device), 128)
    try:
        yield
    finally:
        del _REGISTRY[SMALL_COAT]


def phase_tower(counters, device, card, label, config, batch, towers, per_step,
                frozen_per_step, registered, small, kernel_names, hw=64):
    """A tower at full width, as the MViT phases drive theirs: fused against
    plain engine (``towers``: the (module, launches
    per forward) pairs), the fp32 engine on the card against the CPU;
    run_service with its CNN_MODEL_NAME; the train step at ``batch`` (augment
    on, bf16): the loss falls over 10 steps on one batch, ``per_step``
    launches a step unfrozen and ``frozen_per_step`` frozen; one fp32 step of
    a small tower on the card against the CPU (at hw × hw); the engine's
    p50/p95 at B=1
    (20 forwards in turns, no profile: these phases are host-bound and the
    script's time is bounded); train img/s unfrozen and frozen, and a
    profiled step with the shares of ``kernel_names``. Returns the 10
    unfrozen steps' launches and the train times."""
    fused, plain = phase_slice(counters[0], device, card, label, config, towers)
    phase_server(counters[0], card, cnn=config["cnn_model_name"], towers=towers)
    train_batch_, cw, step, launches = phase_train(
        counters[1:], device, card, label, config, batch, per_step=per_step,
        frozen_per_step=frozen_per_step, lr=TOWER_TRAIN_LR)
    with registered():
        phase_card_vs_cpu(device, cnn=small, hw=hw)
    engine_latency(fused, plain, label, card, batches=(1,), n=20, profile=False)
    del fused, plain
    times = phase_train_times(device, card, train_batch_, cw, step, label, config,
                              kernel_names=kernel_names)
    _SMOKE_MODELS.clear()
    return launches, times


def train_batch(device, B=None, hw=None, seed=0):
    """One batch of the synthetic dataset (class-dependent brightness and
    metadata) on ``device``, and its class weights."""
    import numpy as np
    import torch

    from skinjax_torch.data.pipeline import synthetic_source
    from skinjax_torch.data.sampling import compute_class_weights

    B, hw = B or TRAIN_B, hw or TRAIN_HW
    src = synthetic_source(n=B, image_size=(hw, hw), feature_dim=91, num_classes=6, seed=seed)
    b = src.batch(np.arange(B))
    cw = torch.as_tensor(compute_class_weights(src.labels, 6)).to(device)
    return ({k: torch.as_tensor(v).to(device) for k, v in b.items()}, cw)


def token_metadata(device, B, T, vocab=TOKEN_VOCAB, seed=0):
    """A sentence batch's metadata: token ids drawn in [1, vocab) and an
    attention mask with the last eighth of every other row padded."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed + 100)
    mask = np.ones((B, T), np.int32)
    mask[1::2, T - T // 8:] = 0
    return {"input_ids": torch.as_tensor(rng.integers(1, vocab, (B, T)).astype(np.int32)).to(
        device), "attention_mask": torch.as_tensor(mask).to(device)}


def to_device(batch, device):
    """A batch of tensors (the token metadata a dict of them) on ``device``."""
    return {k: to_device(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in batch.items()}


def train_state(config, device, unfreeze="unfrozen_weights", lr=5e-5):
    import torch

    from skinjax_torch.train.loop import TrainConfig, build_state

    cfg = TrainConfig(device=str(device), unfreeze_weights=unfreeze, learning_rate=lr)
    return build_state(smoke_model(config, torch.bfloat16), cfg)


def phase_train(counters, device, card, label="flagship", config=None, B=None,
                per_step=None, frozen_per_step=None, lr=TRAIN_LR):
    """A configuration's train step at full width (the flagship at B=128
    unless ``config`` and ``B``), augment on, bf16: finite loss, the loss
    falls over 10 steps on one batch, frozen mode keeps the image encoder
    bit-identical (and moves its BatchNorm statistics, where it has any);
    the launches of the ``counters``' kernels per step are as expected (K5
    once a step unless ``per_step`` and ``frozen_per_step`` say more).
    Returns the batch, class weights, step and the 10 unfrozen steps'
    launches."""
    import torch

    from skinjax_torch import FLAGSHIP
    from skinjax_torch.train.steps import make_train_step_weighted

    config, B = config or FLAGSHIP, B or TRAIN_B
    per_step = per_step or {K5: 1}
    frozen_per_step = frozen_per_step or per_step
    batch, cw = train_batch(device, B=B)
    step = make_train_step_weighted(augment=True, image_dtype=torch.bfloat16)

    def run(state, n):
        for c in counters:
            c.reset_launches()
        losses = [step(state, batch["image"], batch["metadata"], batch["label"], 0, cw)
                  for _ in range(n)]
        torch.cuda.synchronize()
        launches = {k: v for c in counters for k, v in c.LAUNCHES.items()}
        return [float(x) for x in losses], launches

    losses, launches = run(train_state(config, device, lr=lr), 10)
    log(f"train {label} unfrozen B={B} (lr {lr:g}, one batch, augment on): losses "
        + " ".join(f"{x:.4f}" for x in losses) + f"; launches {launches} over 10 steps")
    check(all(math.isfinite(x) for x in losses), "non-finite train loss")
    check(sum(losses[-3:]) / 3 < sum(losses[:3]) / 3 and losses[-1] < losses[0],
          f"the {label} loss did not fall over 10 steps on one batch")
    expect = {k: 10 * v for k, v in per_step.items()}
    check(launches == expect, f"launches {launches} over 10 unfrozen steps != {expect}")

    state = train_state(config, device, unfreeze="frozen_weights")
    enc = state.model.image_encoder
    params0 = {k: v.detach().clone() for k, v in enc.named_parameters()}
    stats0 = {k: v.clone() for k, v in enc.named_buffers() if k.endswith("running_var")}
    head0 = state.model.fc_fusion[0].weight.detach().clone()
    frozen_losses, frozen = run(state, 2)
    same = all(torch.equal(v, params0[k]) for k, v in enc.named_parameters())
    moved = sum(not torch.equal(v, stats0[k]) for k, v in enc.named_buffers() if k in stats0)
    log(f"train {label} frozen B={B}: losses {frozen_losses}; image_encoder parameters "
        f"bit-identical: {same}; running_var buffers changed {moved}/{len(stats0)}; fusion head "
        f"moved: {not torch.equal(head0, state.model.fc_fusion[0].weight)}; launches {frozen}")
    check(same, "frozen mode changed an image_encoder parameter")
    check(moved == len(stats0), "frozen mode left BatchNorm statistics unchanged")
    check(not torch.equal(head0, state.model.fc_fusion[0].weight), "frozen mode froze the head")
    expect = {k: 2 * v for k, v in frozen_per_step.items()}
    check(frozen == expect, f"launches {frozen} over 2 frozen steps != {expect}")
    return batch, cw, step, launches


def phase_card_vs_cpu(device, cnn="resnet-18", hw=64, sentence=False, tabular=False,
                      baseline=None):
    """One fp32 step (TF32 off, augment off, dropout 0) of a small model on
    the card and on the CPU from the same weights and batch. With
    ``sentence``, a tokens model with a small BERT (SMALL_BERT) over 48
    tokens, its attention backward forced onto the recompute route by
    ``STORE_P_MAX_BYTES`` = 0 on both sides (the card launches the recompute
    kernel once a layer). With ``tabular``, a tabular model whose
    TabTransformer (``TAB_TOWER``'s attention, 64 out) reads 18 categorical
    columns and 3 numerics; at attention dropout 0 its attention takes K12 in
    train mode (a forward and a stored-P backward a layer). With ``baseline``
    (``"metanet"``), that baseline on ``cnn``."""
    import copy
    import re

    import torch

    from skinjax_torch.models import MultimodalModel
    from skinjax_torch.models.backbones.nextvit import NextViT
    from skinjax_torch.models.text.bert import NativeBertEncoder, NativeSentenceTower
    from skinjax_torch.models.weights import init_weights
    from skinjax_torch.ops import global_attention as ga
    from skinjax_torch.train.loop import TrainConfig, build_state
    from skinjax_torch.train.steps import make_train_step_weighted

    lr = 1e-3
    text = {}
    if sentence:
        text = dict(text_model_name="bert-base-uncased", text_input_mode="tokens",
                    text_module=NativeSentenceTower(NativeBertEncoder(**SMALL_BERT)))
    if tabular:
        from skinjax_torch.models.text import TabTransformer

        cards = [3 + i % 5 for i in range(TAB_COLUMNS)]
        text = dict(text_input_mode="tabular", text_module=TabTransformer(
            cards, 3, **dict(TAB_TOWER, out_dim=64)))
    if baseline is not None:
        from skinjax_torch.models.factory import create_model

        model = create_model(num_classes=6, model_name=baseline, cnn_model_name=cnn,
                             vocab_size=91, seed=5)
    else:
        model = init_weights(MultimodalModel(num_classes=6, num_heads=8, cnn_model_name=cnn,
                                             common_dim=64, vocab_size=91,
                                             attention_mechanism="att-intramodal+residual+"
                                                                 "cross-attention-metadados",
                                             **text), seed=5)
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
        elif hasattr(m, "dropout_rate"):  # attention dropout
            m.dropout_rate = 0.0
    step = make_train_step_weighted(augment=False, image_dtype=torch.float32)
    batch, cw = train_batch("cpu", B=8, hw=hw, seed=3)
    if sentence:
        batch["metadata"] = token_metadata("cpu", 8, 48, SMALL_BERT["vocab_size"], seed=3)
    if tabular:
        gen = torch.Generator().manual_seed(4)
        batch["metadata"] = {
            "categorical": torch.stack([torch.randint(0, c, (8,), generator=gen)
                                        for c in cards], dim=1).int(),
            "numerical": torch.randn(8, 3, generator=gen)}
    out, limit = [], ga.STORE_P_MAX_BYTES
    for dev in (device, torch.device("cpu")):
        state = build_state(copy.deepcopy(model),
                            TrainConfig(device=str(dev), learning_rate=lr, image_dtype="float32"))
        b = to_device(batch, dev)
        ga.reset_launches()
        if sentence:
            ga.STORE_P_MAX_BYTES = 0
        try:
            loss = float(step(state, b["image"], b["metadata"], b["label"], 0, cw.to(dev)))
        finally:
            ga.STORE_P_MAX_BYTES = limit
        if sentence and dev.type == "cuda":
            layers = SMALL_BERT["num_layers"]
            check(ga.LAUNCHES == {"global_attention_fwd": layers, "global_attention_bwd": 0,
                                  K12_RECOMPUTE: layers},
                  f"the small BERT's card step launched {ga.LAUNCHES}")
        if tabular and dev.type == "cuda":
            layers = TAB_TOWER["num_layers"]
            check(ga.LAUNCHES == {"global_attention_fwd": layers, "global_attention_bwd": layers,
                                  K12_RECOMPUTE: 0},
                  f"the small tabular model's card step launched {ga.LAUNCHES}")
        # the step leaves each parameter's gradient in .grad
        grads = {k: p.grad.detach().cpu() for k, p in state.model.named_parameters()
                 if p.grad is not None}
        out.append((loss, grads,
                    {k: v.detach().cpu() for k, v in state.model.state_dict().items()}))
    (lc, gc, sc), (lh, gh, sh) = out
    check(set(gc) == set(gh) == set(dict(model.named_parameters())),
          "a parameter got no gradient")
    # the backward: per tensor, |g_card - g_cpu| within 1e-3·|g_cpu| + 1e-6·|all of g_cpu|
    # (2-norms; the second term covers a gradient that is 0 up to rounding)
    g_all = math.sqrt(sum(float(g.double().square().sum()) for g in gh.values()))
    gexcess = {k: float((gc[k] - gh[k]).double().norm()) / (1e-3 * float(gh[k].double().norm())
                                                             + 1e-6 * g_all) for k in gh}
    worst_g = max(gexcess, key=gexcess.get)
    # the update: Adam's first step moves each element by about ±lr, so every
    # element lies within 2·lr, and only where a gradient near 0 takes the other
    # sign in the other summation order does it go beyond 0.01·lr. The key
    # bias of a window attention is left out of that count: its gradient is 0
    # by the math (a constant added to every score of a row leaves the softmax
    # as it is), so its Adam step is lr·noise/(|noise| + eps) on either side
    # (DaViT's and Swin's window attentions; DaViT's channel attention is not
    # such a case: its key bias shifts each score row by b_k[c]·Σ v, which
    # varies along the row, so it stays in the count).
    # So are BERT's key bias and the shift of MViTv2's key LayerNorm (a
    # constant added to every pooled key): the same case, and CoaT's key bias
    # (a constant added to every token's key of a channel leaves its softmax
    # over the tokens as it is). Their largest CPU gradient is printed, as a
    # share of all gradients' norm.
    pd = {k: (sc[k].float() - sh[k].float()).abs() for k in gh}
    pdiff = max(float(d.max()) for d in pd.values())
    # So are the biases that add a constant to the residual stream of a
    # NextViT block whose output only a train-mode BatchNorm reads (through
    # the next block's 1×1 patch embedding, or the final norm), whose batch
    # mean takes it away: the block's MLP and E-MHSA output biases, and, in
    # an NTB, E-MHSA's value bias and pooled-token norm shift (attention rows
    # sum to 1) and the patch embedding's shift (its E-MHSA and MHCA halves
    # read it through a BatchNorm and a 1×1 conv); and E-MHSA's key bias.
    before_bn = set()
    if isinstance(getattr(model, "image_encoder", None), NextViT):
        blocks = [(f"image_encoder.stages.{si}.{bi}", b)
                  for si, stage in enumerate(model.image_encoder.stages)
                  for bi, b in enumerate(stage)]
        for i, (name, b) in enumerate(blocks):
            if i + 1 < len(blocks) and blocks[i + 1][1].patch_embed.identity:
                continue
            before_bn.add(f"{name}.mlp.conv2.bias")
            if hasattr(b, "e_mhsa"):
                before_bn |= {f"{name}.{p}" for p in ("e_mhsa.proj.bias", "e_mhsa.v.bias",
                                                      "e_mhsa.norm.bias",
                                                      "patch_embed.norm.bias")}
    key_bias, key_grad = 0, 0.0
    for k in pd:
        if re.fullmatch(r"image_encoder\.(stages\.\d+\.blocks\.\d+\.0\.attn|"
                        r"layers\.\d+\.blocks\.\d+\.attn|"
                        r"serial_blocks\d+\.\d+\.factoratt_crpe)\.qkv\.bias", k):
            C = pd[k].numel() // 3
            pd[k] = torch.cat([pd[k][:C], pd[k][2 * C:]])
            key_bias += C
            key_grad = max(key_grad, float(gh[k][C:2 * C].abs().max()))
        elif k.endswith(("attention.self.key.bias", ".attn.norm_k.bias", ".e_mhsa.k.bias")) \
                or k in before_bn:
            key_bias += pd[k].numel()
            key_grad = max(key_grad, float(gh[k].abs().max()))
            pd[k] = pd[k][:0]
    far = sum(int((d > 0.01 * lr).sum()) for d in pd.values())
    total = sum(d.numel() for d in pd.values())
    bn = [k for k in sc if k.endswith(("running_mean", "running_var"))]
    bdiff = max((float(((sc[k] - sh[k]).abs() / (sh[k].abs() + 1e-3)).max()) for k in bn),
                default=0.0)
    tower = (" + small BERT, 48 tokens, recompute route" if sentence
             else " + TabTransformer, 18 columns, K12 at dropout 0" if tabular
             else f", the {baseline} baseline" if baseline else "")
    log(f"train fp32 card vs CPU ({cnn}{tower}, common_dim 64, {hw}x{hw}, B=8, one Adam step, lr "
        f"{lr:g}): loss {lc:.6f} vs {lh:.6f} (tol rtol 1e-4); gradients of {len(gh)} tensors: "
        f"worst |diff|/(1e-3·|g_cpu| + 1e-6·|g_all|) = {gexcess[worst_g]:.3e} at {worst_g} "
        f"(tol 1); parameters max |diff| {pdiff:.3e} (tol 2·lr), {far} of {total} elements "
        f"beyond 0.01·lr (tol a share of 1e-4; {key_bias} key-bias elements left out, their "
        f"largest CPU gradient {key_grad / g_all:.1e}·|g_all|); BN "
        f"running stats ({len(bn)} tensors) max rel diff {bdiff:.3e} (tol 1e-3)")
    check(abs(lc - lh) <= 1e-4 * abs(lh), "the card and the CPU disagree on the fp32 loss")
    check(gexcess[worst_g] <= 1.0, f"the card and the CPU disagree on the gradient of {worst_g}")
    check(pdiff <= 2 * lr and far <= 1e-4 * total,
          "the card and the CPU disagree on the parameters after one step")
    check(bdiff <= 1e-3, "the card and the CPU disagree on the BatchNorm statistics")


def phase_sentence_train(counters, device, card, label, config, T, per_step,
                         text_frozen=False, timed=False):
    """The sentence datasets' model (``config``: ``SENTENCE`` or ``GPT2``) at
    full width, B=32, T tokens, trained by the train step as the loop builds
    it (``build_state``; augment on with the sentence recipe, bf16): finite
    loss, the loss falls over 10 steps on one batch, the counted launches
    per step are ``per_step``. With ``text_frozen`` the text tower is frozen
    and DaViT trains (``text_train_mode="frozen_weights"``, the reference's
    default that bench.py measures): the tower stays bit-identical and the
    image tower moves. With ``timed``, train images/s by CUDA events and a
    profiled step. The loss that must fall is the batch's in eval mode (no
    augmentation, no dropout), before the 10 steps and after them: each
    train step's own loss carries its augmentation's and dropout's draw, and
    with a random BERT at lr 1e-4 that noise is as large as the fall (the
    last step's loss moved between 1.83 and 2.12 from run to run on an H100,
    against a first step's 2.08). Returns the 10 steps' launches and the ms
    per step (or None)."""
    import torch

    from skinjax_torch import SENTENCE_BATCH
    from skinjax_torch.train.loop import TrainConfig, build_state
    from skinjax_torch.train.losses import weighted_loss
    from skinjax_torch.train.steps import make_loss_eval_step, make_train_step_weighted

    B = SENTENCE_BATCH
    batch, cw = train_batch(device, B=B)
    batch["metadata"] = token_metadata(device, B, T)
    step = make_train_step_weighted(augment=True, image_dtype=torch.bfloat16, recipe="sentence")
    cfg = TrainConfig(device=str(device), learning_rate=SENTENCE_LR,
                      text_train_mode="frozen_weights" if text_frozen else None)
    state = build_state(smoke_model(config, torch.bfloat16), cfg)
    model = state.model
    text0 = {k: v.detach().clone() for k, v in model.text_encoder.named_parameters()}
    image0 = {k: v.detach().clone() for k, v in model.image_encoder.named_parameters()}
    call = lambda: step(state, batch["image"], batch["metadata"], batch["label"], 0, cw)  # noqa: E731
    wloss = weighted_loss("weighted_ce")
    eval_step = make_loss_eval_step(lambda logits, y: wloss(logits, y, cw), torch.bfloat16)
    eval_loss = lambda: float(eval_step(state, batch["image"], batch["metadata"],  # noqa: E731
                                        batch["label"])[0])
    before = eval_loss()
    for c in counters:
        c.reset_launches()
    losses = [float(x) for x in [call() for _ in range(10)]]
    torch.cuda.synchronize()
    launches = {k: v for c in counters for k, v in c.LAUNCHES.items()}
    after = eval_loss()
    text_same = all(torch.equal(v, text0[k]) for k, v in model.text_encoder.named_parameters())
    image_moved = sum(not torch.equal(v, image0[k])
                      for k, v in model.image_encoder.named_parameters())
    mode = "text tower frozen" if text_frozen else "unfrozen"
    log(f"train {label} {mode} B={B} T={T} (lr {SENTENCE_LR:g}, one batch, augment on, sentence "
        f"recipe): losses " + " ".join(f"{x:.4f}" for x in losses) + f"; the batch's eval-mode "
        f"loss {before:.4f} before the 10 steps, {after:.4f} after; launches {launches} over 10 "
        f"steps; text tower bit-identical: {text_same}; image_encoder tensors moved "
        f"{image_moved}/{len(image0)}")
    check(all(math.isfinite(x) for x in (*losses, before, after)), "non-finite train loss")
    check(after < before, f"the {label} loss did not fall over 10 steps on one batch")
    expect = {k: 10 * v for k, v in per_step.items()}
    check(launches == expect, f"launches {launches} over 10 steps != {expect}")
    check(text_same == text_frozen, f"the {label} text tower {'moved' if text_frozen else 'froze'}")
    check(image_moved == len(image0), "the image tower did not train")
    ms = None
    if timed:
        ms = time_ms(call, iters=12, warmup=3)
        log(f"[{card}] train {label} {mode} B={B} T={T}: {ms:.2f} ms per step, "
            f"{B / ms * 1e3:.1f} img/s (12 steps after 3 warm-up, CUDA events, the batch "
            f"already on the card)")
        total, by_name = device_us(call, n=3)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        names = [n for names in K12_KERNELS.values() for n in names]
        k12 = sum(v for k, v in by_name.items() if any(n in k for n in names))
        k7 = sum(v for k, v in by_name.items() if any(n in k for names in K7_KERNELS.values()
                                                      for n in names))
        log(f"[{card}] profile train {label} {mode} step B={B} T={T}: device time "
            f"{total / 1e3:.2f} ms per step = {100 * total / (ms * 1e3):.1f}% of the {ms:.2f} ms "
            f"step; K12 {k12 / 1e3:.2f} ms ({share(k12, total)}), K7 {k7 / 1e3:.2f} ms "
            f"({share(k7, total)}); {len(by_name)} kernel names")
        log("  top kernels (us per step): " + "; ".join(f"{k[:70]} {v:.1f}" for k, v in top))
    del state, model, batch
    torch.cuda.empty_cache()
    return launches, ms


def phase_sentence_cli(ga, device, card):
    """The train CLI on a sentence dataset, as a user runs it: a
    PAD-UFES-20-shaped dataset with a ``sentence`` column (SENTENCE_CLI_IMAGES
    rows, 224×224 PNGs) and a WordPiece vocabulary under
    ``<tokenizers>/bert-base-uncased/vocab.txt`` in a temporary directory;
    ``python -m skinjax_torch.tools.train_cli`` as a subprocess on the card
    with ``TEXT_MODEL_NAME=bert-base-uncased``, ``MAX_SEQ_LENGTH=512`` and
    ``TOKENIZERS_DIR`` (DaViT-tiny + full-size BERT-base drawn at random,
    RG-ATT, 2 folds × 1 epoch, B=32, unfrozen); its fold results and
    checkpoints; then the first fold's checkpoint reloaded strictly into a
    new tokens model, which evaluates one batch of the token source on the
    card (finite logits, K12 launched once a BERT layer). Returns the CLI's
    wall time."""
    import csv
    import re
    import tempfile

    import numpy as np
    import torch

    from skinjax_torch.data.fixtures import (
        pad_ufes20_table,
        row_sentences,
        write_pad_ufes20_like,
        write_wordpiece_vocab,
    )
    from skinjax_torch.data.schemas import prepare_dataset
    from skinjax_torch.models.factory import create_model
    from skinjax_torch.train.experiments import build_token_source
    from skinjax_torch.train.loop import TrainConfig, build_state
    from skinjax_torch.train.steps import make_eval_step

    root = os.path.dirname(os.path.abspath(__file__))
    n, backbone, T = SENTENCE_CLI_IMAGES, SENTENCE_CLI_BACKBONE, SENTENCE_CLI_TOKENS
    with tempfile.TemporaryDirectory() as tmp:
        csv_path, images = write_pad_ufes20_like(os.path.join(tmp, "data"), n=n,
                                                 image_hw=(224, 224), seed=0, paeth=False,
                                                 sentences=True)
        tokenizers = os.path.join(tmp, "tokenizers")
        vocab = write_wordpiece_vocab(os.path.join(tokenizers, "bert-base-uncased", "vocab.txt"),
                                      row_sentences(pad_ufes20_table(n, seed=0)))
        results = os.path.join(tmp, "results")
        cmd = [sys.executable, "-m", "skinjax_torch.tools.train_cli", "--dataset", "pad-ufes-20",
               "--metadata-csv", csv_path, "--images-dir", images, "--results-dir", results,
               "--mechanisms", RGATT, "--backbones", backbone, "--k-folds", "2",
               "--epochs", "1", "--batch-size", "32"]
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            p for p in (root, os.environ.get("PYTHONPATH")) if p),
            TEXT_MODEL_NAME="bert-base-uncased", MAX_SEQ_LENGTH=str(T),
            TOKENIZERS_DIR=tokenizers)
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=root, env=env, capture_output=True, text=True,
                              timeout=600)
        wall = time.perf_counter() - t0
        if proc.returncode != 0 or "failed:" in proc.stdout:
            log(proc.stdout[-3000:] + proc.stderr[-6000:])
        check(proc.returncode == 0, f"train_cli exited {proc.returncode}")
        check("failed:" not in proc.stdout, "the sentence cell of the train CLI failed")
        found = re.search(r'"n_runs": (\d+)', proc.stdout)
        n_runs = int(found.group(1)) if found else -1
        cell = os.path.join(results, f"multimodal_{backbone}_{RGATT}_h8")
        with open(os.path.join(cell, "model_metrics.csv")) as f:
            rows = list(csv.DictReader(f))
        ckpt = os.path.join(cell, f"multimodal_{backbone}_{RGATT}_h8_fold_1", "best", "state.pt")
        log(f"[{card}] cli sentence dataset python -m skinjax_torch.tools.train_cli "
            f"(TEXT_MODEL_NAME=bert-base-uncased MAX_SEQ_LENGTH={T}, {vocab}-token vocab.txt): "
            f"{wall:.1f} s wall (process start, {n} PNG decodes, 2 folds of {backbone} + "
            f"BERT-base at B=32, T={T}, 1 epoch); n_runs {n_runs} (expected 2); per fold "
            f"balanced accuracy/auc " + ", ".join(f"{r['balanced_accuracy'][:6]}/{r['auc'][:6]}"
                                                  for r in rows))
        check(n_runs == 2, f"train_cli returned {n_runs} fold results, not 2")
        check(len(rows) == 2 and all(math.isfinite(float(r["balanced_accuracy"])) for r in rows),
              "model_metrics.csv lacks two finite folds")
        check(os.path.isfile(ckpt), "the first fold's checkpoint is missing")

        saved = torch.load(ckpt, map_location="cpu", weights_only=True)["model"]
        prepared = prepare_dataset("pad-ufes-20", csv_path)
        source = build_token_source(prepared, images, "bert-base-uncased", max_seq_length=T,
                                    tokenizers_dir=tokenizers)
        model = create_model(num_classes=prepared.num_classes, cnn_model_name=backbone,
                             text_model_name="bert-base-uncased", attention_mechanism=RGATT,
                             vocab_size=prepared.feature_dim, dtype=torch.bfloat16)
        model.load_state_dict(saved)
        b = source.batch(np.arange(8))
        state = build_state(model, TrainConfig(device=str(device)))
        ga.reset_launches()
        logits = make_eval_step(torch.bfloat16)(
            state, torch.as_tensor(b["image"]).to(device),
            {k: torch.as_tensor(v).to(device) for k, v in b["metadata"].items()})
        torch.cuda.synchronize()
        launches = dict(ga.LAUNCHES)
        log(f"cli sentence checkpoint {os.path.relpath(ckpt, results)}: {len(saved)} tensors "
            f"reloaded strictly into a new tokens model; one eval batch of the token source "
            f"(B=8, T={T}, bf16) on the card: logits {tuple(logits.shape)}, finite "
            f"{bool(torch.isfinite(logits).all())}; K12 launches {launches}")
        check(logits.shape == (8, 6) and bool(torch.isfinite(logits).all()),
              "non-finite or misshapen logits from the reloaded checkpoint")
        check(launches == {"global_attention_fwd": K12_TEXT_LAYERS, "global_attention_bwd": 0,
                           K12_RECOMPUTE: 0}, f"the eval forward launched {launches}")
    return wall


@contextlib.contextmanager
def small_davit_registered():
    """A small DaViT (dims (64, 128), depths (1, 1), heads (2, 4): 32
    channels a head, as davit_tiny) as backbone ``SMALL_DAVIT`` meanwhile."""
    from skinjax_torch.models.backbones import _REGISTRY
    from skinjax_torch.models.backbones.davit import DaViT

    _REGISTRY[SMALL_DAVIT] = (
        lambda device=None: DaViT((64, 128), (1, 1), (2, 4), device=device), 128)
    try:
        yield
    finally:
        del _REGISTRY[SMALL_DAVIT]


@contextlib.contextmanager
def small_beit_registered():
    """A small BEiT (width 256, depth 2, 4 heads: 64 channels a head, as
    BEiT-v2-large; 224×224, 197 tokens) as backbone ``SMALL_BEIT`` meanwhile."""
    from skinjax_torch.models.backbones import _REGISTRY
    from skinjax_torch.models.backbones.beit import Beit

    _REGISTRY[SMALL_BEIT] = (lambda device=None: Beit(256, 2, 4, device=device), 256)
    try:
        yield
    finally:
        del _REGISTRY[SMALL_BEIT]


def phase_fold(ak, device, card):
    """run_kfold through the public API: flagship, k=2, 2 epochs, B=32, on
    synthetic_source(n=128, 224×224); K5's launches are counted over it."""
    import csv
    import tempfile

    import numpy as np
    import torch

    from skinjax_torch import FLAGSHIP
    from skinjax_torch.data.pipeline import synthetic_source
    from skinjax_torch.train.kfold import run_kfold
    from skinjax_torch.train.loop import TrainConfig

    src = synthetic_source(n=128, image_size=(TRAIN_HW, TRAIN_HW), feature_dim=91, num_classes=6,
                           seed=1)
    cfg = TrainConfig(num_epochs=2, batch_size=32, device=str(device))
    names = ["ACK", "BCC", "MEL", "NEV", "SCC", "SEK"]
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ak.reset_launches()
        results = run_kfold(lambda: smoke_model(FLAGSHIP, torch.bfloat16), src, src.labels, None, 6,
                            names, cfg, k_folds=2, results_dir=tmp, model_name="flagship")
        torch.cuda.synchronize()
        launches = ak.LAUNCHES[K5]
        seconds = time.perf_counter() - t0
        with open(os.path.join(tmp, "model_metrics.csv")) as f:
            rows = list(csv.DictReader(f))
        files = {d: sorted(os.listdir(os.path.join(tmp, d)))
                 for d in os.listdir(tmp) if os.path.isdir(os.path.join(tmp, d))}
        probs = [np.load(os.path.join(tmp, d, "probabilities.npy")) for d in sorted(files)]
    # 2 epochs × the full batches of each fold's train split (the rest is dropped)
    steps = sum(2 * ((128 - len(p)) // 32) for p in probs)
    log(f"[{card}] fold run_kfold k=2, 2 epochs, B=32, n=128 {TRAIN_HW}x{TRAIN_HW}: "
        f"{seconds:.1f} s; "
        f"per fold balanced accuracy/auc " + "; ".join(
            f"{r['balanced_accuracy'][:6]}/{r['auc'][:6]}" for r in rows)
        + f"; K5 launches {launches} (expected {steps}); files {files}")
    check(len(results) == 2 and len(rows) == 2, "run_kfold did not return/write two folds")
    check(all(np.isfinite(p).all() and p.shape[1] == 6 for p in probs)
          and sum(len(p) for p in probs) == 128, "bad probabilities.npy")
    check(all(any(f.startswith("predictions_eval_fold") for f in fs) for fs in files.values()),
          "a prediction CSV is missing")
    check(launches == steps, f"K5 launched {launches} times over {steps} train steps")
    return launches


def phase_train_times(device, card, batch, cw, step, label="flagship", config=None,
                      kernel_names=None):
    """Train img/s at the batch's size, unfrozen and frozen; a profiled
    unfrozen step, with the share of each group of kernels named
    (``kernel_names``: {label: kernel names}; K5's by default)."""
    from skinjax_torch import FLAGSHIP

    config = config or FLAGSHIP
    B = batch["image"].shape[0]
    times = {}
    for mode in ("unfrozen_weights", "frozen_weights"):
        state = train_state(config, device, unfreeze=mode)
        call = lambda: step(state, batch["image"], batch["metadata"], batch["label"], 0, cw)  # noqa: E731,B023
        for _ in range(3):  # warm-up
            call()
        ms = time_ms(call, iters=12, warmup=0)
        times[mode] = ms
        log(f"[{card}] train {label} {mode} B={B}: {ms:.2f} ms per step, {B / ms * 1e3:.1f} img/s "
            f"(12 steps after 3 warm-up, CUDA events, the batch already on the card)")

    state = train_state(config, device)
    call = lambda: step(state, batch["image"], batch["metadata"], batch["label"], 0, cw)  # noqa: E731
    mean_ms = time_ms(call, iters=5, warmup=2)
    total, by_name = device_us(call, n=3)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    shares = []
    for name, names in (kernel_names or {"K5": K5_KERNELS}).items():
        ours = sum(v for k, v in by_name.items() if any(n in k for n in names))
        shares.append(f"{name} {ours:.1f} us ({share(ours, total)})")
    log(f"[{card}] profile train {label} step unfrozen B={B}: device time {total / 1e3:.2f} ms "
        f"per step = {100 * total / (mean_ms * 1e3):.1f}% of the untraced {mean_ms:.2f} ms "
        f"step; {'; '.join(shares)}; {len(by_name)} kernel names")
    log("  top kernels (us per step): " + "; ".join(f"{k[:70]} {v:.1f}" for k, v in top))
    return times


def phase_k5_times(ak, device, card, batch):
    """The augment stage with and without K5; K5 against its twin."""
    import torch

    from skinjax_torch.data.augment import augment_batch

    gen = torch.Generator(device=device)
    img = batch["image"]
    aug = {}
    for fused in (True, False, False, True):  # in turns
        ms = time_ms(lambda: augment_batch(img, gen, True, torch.bfloat16, fused_color=fused),
                     iters=20, warmup=3)
        aug.setdefault(fused, []).append(ms)
    log(f"[{card}] augment stage B={TRAIN_B} 224x224 bf16, in turns K5-chain-chain-K5: "
        f"K5 path {aug[True][0]:.3f} / {aug[True][1]:.3f} ms, per-sample chain "
        f"{aug[False][0]:.3f} / {aug[False][1]:.3f} ms (CUDA events, 20 calls)")

    k5 = {}
    for B in (1, TRAIN_B):
        x, fp, ip = k5_inputs(ak, B, 224, 224, False, torch.bfloat16, device, seed=11)
        kern = lambda: ak.fused_color_stage(x, fp, ip)  # noqa: E731
        twin = lambda: ak.fused_color_stage_plain(x, fp, ip)  # noqa: E731
        t = [time_ms(twin, 50, 5), time_ms(kern, 50, 5), time_ms(kern, 50, 5),
             time_ms(twin, 50, 5)]
        ms, plain_ms = (t[1] + t[2]) / 2, (t[0] + t[3]) / 2
        dev_k = kernel_device_us(kern, K5_KERNELS, n=20)
        dev_t, _ = device_us(twin, n=20)
        nbytes = 2 * x.numel() * x.element_size() + fp.numel() * 4 + ip.numel() * 4
        bound_ms = max(nbytes / HBM_BYTES_PER_S, B * 224 * 224 * K5_OPS_PER_PIXEL
                       / FP32_OPS_PER_S) * 1e3
        k5[B] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms)
        log(f"[{card}] time {K5} bf16 B={B:3d} 224x224 per call: kernel {ms * 1e3:9.2f} us  "
            f"twin {plain_ms * 1e3:9.2f} us (CUDA events, in turns twin-kernel-kernel-twin); "
            f"device time: kernel {us(dev_k)}  twin {dev_t:9.2f} us (torch.profiler); "
            f"bound {bound_ms * 1e3:.2f} us ({nbytes / 1e6:.1f} MB at 3.35 TB/s)")
    return k5


def k7_bound(B, side, C, itemsize, backward, heads=0, masks=0):
    """The least time (ms) for one K7 call: every input read once and every
    output written once over the HBM rate, against its products over the
    bf16 tensor-core rate. Forward: x, the weights → y; 2·C·4C operations a
    token for the projections, 4·N·C for scores and p·v. Backward: x, dy,
    the weights → dqkv, of; the projections recomputed, 12·N·C for the
    six attention products. With ``heads``, a bias (heads, N, N) fp32 read
    (and in the backward its gradient written); with ``masks``, that many
    (N, N) fp32 mask planes read."""
    T, N = B * side * side, WINDOW * WINDOW
    weights = (4 * C * C + 4 * C) * itemsize + (1 + backward) * heads * N * N * 4
    weights += masks * N * N * 4
    if backward:
        nbytes = (2 * T * C + 4 * T * C) * itemsize + weights - C * itemsize
        ops = 2 * T * C * 4 * C + 12 * T * N * C
    else:
        nbytes = 2 * T * C * itemsize + weights
        ops = 2 * T * C * 4 * C + 4 * T * N * C
    return max(nbytes / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S) * 1e3, nbytes, ops


def window_chain_times(wa, x, wqkv, bqkv, wproj, bproj, attn, h, dy):
    """The function K7's forwards compute as PyTorch calls (the port never
    calls them so): F.linear (qkv) → F.scaled_dot_product_attention
    (``attn``, the bias and mask, as its attn_mask) → F.linear (proj) on the
    same inputs; an NHWC x (B, H, W, C) is partitioned into windows first
    and merged after, windows (nB, N, C) are taken as they are. Returns
    (forward ms by CUDA events, two runs of 20 calls; backward ms: the
    device time of autograd's backward alone from dy to the qkv
    projection's output, what the strip backward's dqkv is, or None where
    the trace kept no record)."""
    import torch
    import torch.nn.functional as F

    nhwc = x.dim() == 4

    def windows(t):
        return wa.window_partition(t, WINDOW) if nhwc else t

    def merged(t):
        return wa.window_reverse(t, WINDOW, x.shape[1], x.shape[2]) if nhwc else t

    xw = windows(x)
    nB, N, C = xw.shape

    def attend(qkv):
        q, k, v = (t.reshape(nB, N, h, C // h).transpose(1, 2) for t in qkv.split(C, dim=-1))
        of = F.scaled_dot_product_attention(q, k, v, attn_mask=attn)
        return F.linear(of.transpose(1, 2).reshape(nB, N, C), wproj.t(), bproj)

    def fwd():
        with torch.no_grad():
            return merged(attend(F.linear(windows(x), wqkv.t(), bqkv)))

    qkv = F.linear(xw, wqkv.t(), bqkv).detach().requires_grad_(True)
    out, dyw = attend(qkv), windows(dy)

    def bwd():
        return torch.autograd.grad(out, [qkv], dyw, retain_graph=True)

    f = (time_ms(fwd, 20, 3) + time_ms(fwd, 20, 3)) / 2
    bwd()
    b, _ = device_us(bwd, n=10)
    return f, (b / 1e3 if b > 0 else None)


def phase_k7_times(wa, device, card):
    """K7 forward and backward against their twins at B=64, bf16, per stage;
    the yardstick is the same function as PyTorch calls (``window_chain_times``:
    F.linear → SDPA → F.linear, the backward to dqkv); SDPA alone on the same
    per-window q, k, v (the attention core only) is logged beside it (the
    port never calls either)."""
    import torch
    import torch.nn.functional as F

    from skinjax_torch import DAVIT_BATCH

    B = DAVIT_BATCH
    out = {}
    for side, C, h in K7_STAGES:
        args, dy, _, _ = k7_inputs(B, side, C, h, torch.bfloat16, device, seed=21)
        x, wqkv, bqkv, wproj, _ = args
        q, k, v = wa._windows_qkv(x, wqkv, bqkv, h, WINDOW)
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        calls = {
            "window_attention_fwd": (
                lambda: wa.window_attention_fwd(*args, None, None, h, WINDOW),
                lambda: wa.window_attention_nhwc_plain(*args, None, None, h, WINDOW)),
            "window_attention_bwd": (
                lambda: wa.window_attention_bwd(x, dy, wqkv, bqkv, wproj, None, None, h, WINDOW),
                lambda: wa.window_attention_nhwc_bwd_plain(x, dy, wqkv, bqkv, wproj, None, None,
                                                           h, WINDOW)),
        }
        do = torch.randn(q.shape, generator=torch.Generator(device=device).manual_seed(22),
                         device=device).to(q.dtype)
        core = dict(zip(K7, sdpa_head_times(q, k, v, do, None)))
        library = dict(zip(K7, window_chain_times(wa, x, wqkv, bqkv, wproj, args[4], None, h,
                                                  dy)))
        for name, (kern, twin) in calls.items():
            out[(name, side)] = time_record(
                card, name, f"B={B} {side}x{side} C={C} h={h}", kern, twin, K7_KERNELS[name],
                k7_bound(B, side, C, 2, name.endswith("bwd")), library[name])
        log(f"[{card}] time the same function as PyTorch calls bf16 at {side}x{side} "
            f"(partition, F.linear qkv, SDPA, F.linear proj, merge): forward "
            f"{ms_us(library['window_attention_fwd'])} per call (CUDA events), backward to dqkv "
            f"{ms_us(library['window_attention_bwd'])} (device time); "
            f"F.scaled_dot_product_attention alone on the same (nB, h, 49, 32) q, k, v (the "
            f"attention core only): forward {ms_us(core['window_attention_fwd'])}, backward "
            f"{ms_us(core['window_attention_bwd'])}")

    # the bias + mask case at Swin-tiny's stage 0 (its strip route): a
    # relative-position bias with a gradient and 64 shifted-window masks
    side, C, h = K7_STAGES[0]
    args, dy, b, m = k7_inputs(B, side, C, h, torch.bfloat16, device, seed=23, bias=True,
                               mask=True)
    x, wqkv, bqkv, wproj, _ = args
    n_win = m.shape[0]
    attn = (b[None] + m[:, None]).to(torch.bfloat16).repeat(B, 1, 1, 1)  # (B n_win, h, N, N)
    q, k, v = (t.contiguous() for t in wa._windows_qkv(x, wqkv, bqkv, h, WINDOW))
    do = torch.randn(q.shape, generator=torch.Generator(device=device).manual_seed(24),
                     device=device).to(q.dtype)
    core_bwd = sdpa_head_times(q, k, v, do, attn)[1]
    chain_bwd = window_chain_times(wa, x, wqkv, bqkv, wproj, args[4], attn, h, dy)[1]
    name = "window_attention_bwd"
    out[(name, "bias+mask")] = time_record(
        card, name, f"B={B} {side}x{side} C={C} h={h} bias+mask",
        lambda: wa.window_attention_bwd(x, dy, wqkv, bqkv, wproj, b, m, h, WINDOW),
        lambda: wa.window_attention_nhwc_bwd_plain(x, dy, wqkv, bqkv, wproj, b, m, h, WINDOW),
        [*K7_KERNELS[name], "dbias_reduce_kernel"],
        k7_bound(B, side, C, 2, True, heads=h, masks=n_win), chain_bwd)
    log(f"[{card}] time the same function as PyTorch calls bf16 at {side}x{side} with the bias "
        f"and masks as SDPA's attn_mask: backward to dqkv {ms_us(chain_bwd)} (device time); "
        f"F.scaled_dot_product_attention's backward alone {ms_us(core_bwd)}")
    del x, wqkv, bqkv, wproj, args, dy, b, m, attn, q, k, v, do
    torch.cuda.empty_cache()
    return out


def engine_latency(fused, plain, label, card, batches=(1, 8), n=50, profile=True):
    """p50/p95 of the fused and plain engines at each of ``batches``, n
    forwards each, in turns; then, with ``profile``, a profile of each."""
    for B in batches:
        means = {}
        for kind, eng in (("fused", fused), ("plain", plain), ("plain", plain),
                          ("fused", fused)):  # in turns
            lat = eng.measure_latency(n=n, batch=B)
            means.setdefault(kind, []).append(lat["mean_ms"])
            log(f"[{card}] engine {label} bf16 {kind} B={B}: p50 {lat['p50_ms']:.3f} ms "
                f"p95 {lat['p95_ms']:.3f} ms mean {lat['mean_ms']:.3f} ms ({n} forwards, host "
                f"clock to synchronize, inputs on the card)")
        for kind, eng in ((("fused", fused), ("plain", plain)) if profile else ()):
            phase_profile(eng, f"{label} {kind}", B, sum(means[kind]) / 2, card)


def matmul_bound_ms(args, out, products, B):
    """The least time for K1-K3 at their inputs: every input read once and
    the output written once over the HBM rate, against the products' 2·K·N
    operations per row over the fp32 rate (the kernels use fp32 FMAs)."""
    nbytes = sum(t.numel() * t.element_size() for t in args) + out.numel() * out.element_size()
    ops = 2 * B * sum(k * n for k, n in products)
    return max(nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S) * 1e3


def phase_k4_times(fk, device, card):
    """K4 against its twin at B=1, bf16, at each Vd of the main paths: per
    call (CUDA events, in turns), device time, the bound, the same function
    as PyTorch calls it, and the kernel and that chain with the weights
    L2-cold."""
    import torch

    gen = torch.Generator().manual_seed(7)
    flush = l2_flush(device)
    out = {}
    for vd in K4_WIDTHS:
        args = kernel_args(K4, 1, torch.bfloat16, device, gen, vd)
        kern = lambda: fk.metablock_film(*args)  # noqa: E731,B023
        twin = lambda: fk.metablock_film_plain(*args)  # noqa: E731,B023
        lib = fusion_library(K4, args)
        err, ok = compare(lib(), twin(), BF16_TOL)
        check(ok, f"{K4}'s library chain disagrees with the twin at Vd={vd} ({err:.3e})")
        t = [time_ms(twin), time_ms(kern), time_ms(lib), time_ms(lib), time_ms(kern),
             time_ms(twin)]
        ms, plain_ms, lib_ms = (t[1] + t[4]) / 2, (t[0] + t[5]) / 2, (t[2] + t[3]) / 2
        dev_k = kernel_device_us(kern, [KERNEL_NAMES[K4]])
        dev_t, _ = device_us(twin)
        dev_l, _ = device_us(lib)
        bound_ms = matmul_bound_ms(args, twin(), [(K4_DU, vd)] * 2, 1)
        cold_k = cold_times(kern, [KERNEL_NAMES[K4]], flush)
        cold_l = cold_times(lib, None, flush)
        out[vd] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, device_us=dev_k,
                       library_ms=lib_ms, library_device_us=dev_l, cold_ms=cold_k[0],
                       cold_device_us=cold_k[1], library_cold_device_us=cold_l[1])
        log(f"[{card}] time {K4} bf16 B=1 Du={K4_DU} Vd={vd:4d} per call: kernel "
            f"{ms * 1e3:8.2f} us  twin {plain_ms * 1e3:8.2f} us  library {lib_ms * 1e3:8.2f} us "
            f"(CUDA events over 200 calls, in turns); device time: kernel {us(dev_k)}  twin "
            f"{dev_t:8.2f} us  library {dev_l:8.2f} us (torch.profiler); bound "
            f"{bound_ms * 1e3:.2f} us (bytes: both weights read once at 3.35 TB/s); "
            f"{against(ms, bound_ms, lib_ms)}; L2-cold (a 256 MB write before each call): "
            f"kernel {cold_k[0] * 1e3:8.2f} us a call, device {us(cold_k[1])}; library "
            f"{cold_l[0] * 1e3:8.2f} us a call, device {us(cold_l[1])}")
    del flush
    torch.cuda.empty_cache()
    return out


def mechanism_model(mech, tower, device, seed):
    """The flagship's configuration with mechanism ``mech`` at full width, in
    bf16, on the card, around the shared image ``tower``; the rest random
    from ``seed``."""
    import torch

    from skinjax_torch import FLAGSHIP
    from skinjax_torch.models import MultimodalModel
    from skinjax_torch.models.weights import init_weights

    model = MultimodalModel(**dict(FLAGSHIP, attention_mechanism=mech), dtype=torch.bfloat16,
                            device=device)
    model.image_encoder = tower
    for name, child in model.named_children():
        if name != "image_encoder":
            init_weights(child, seed)
    return model


def phase_mechanisms(fk, device, card):
    """All 18 mechanisms at full width (ResNet-50, 224×224, common_dim 512,
    bf16) around one ResNet-50 tower: the 10 the engine fuses, fused against
    plain engine with the launches per fused forward; the other 8, the plain
    forward, finite and summing to 1."""
    import numpy as np
    import torch

    from skinjax_torch import FLAGSHIP
    from skinjax_torch.models.fusion.multimodal import MECHANISMS
    from skinjax_torch.serve.engine import FUSED_MECHANISMS, InferenceEngine

    tower = smoke_model(FLAGSHIP, torch.bfloat16).image_encoder.to(device)
    rng = np.random.default_rng(6)
    img = rng.integers(0, 256, (2, 224, 224, 3), dtype=np.uint8)
    meta = rng.normal(size=(2, 91)).astype(np.float32)
    check(set(FUSED_PER_FORWARD) == set(FUSED_MECHANISMS), "the fused set changed")
    for i, mech in enumerate(MECHANISMS):
        model = mechanism_model(mech, tower, device, seed=i + 1)
        pp = InferenceEngine(model, use_fused=False, device=device).predict_probs(img, meta)
        check(pp.shape == (2, 6) and bool(np.isfinite(pp).all()), f"{mech}: bad plain probs")
        check(np.allclose(pp.sum(-1), 1.0, atol=1e-4), f"{mech}: probabilities do not sum to 1")
        line = f"mechanism {mech}: plain probs finite, sum 1"
        if mech in FUSED_MECHANISMS:
            fused = InferenceEngine(model, use_fused=True, device=device)
            check(fused.fused, f"{mech}: the engine did not select the fused path")
            fk.reset_launches()
            pf = fused.predict_probs(img, meta)
            torch.cuda.synchronize()
            launches = dict(fk.LAUNCHES)
            err = float(np.abs(pf - pp).max())
            line += (f"; fused vs plain max_abs_err={err:.3e} (tol 3e-2, bf16); launches per "
                     f"fused forward {launches}")
            check(err <= 3e-2, f"{mech}: the fused and plain engines disagree")
            check(launches == FUSED_PER_FORWARD[mech],
                  f"{mech}: launches {launches} != {FUSED_PER_FORWARD[mech]}")
        log(line)


def phase_cli(fk, card):
    """The train CLI as a user runs it, then the service on what it wrote: a
    PAD-UFES-20-shaped dataset in a temporary directory (CLI_IMAGES rows,
    300×400 Paeth-filtered PNGs, so every image is decoded by the stdlib
    reader and resized); ``python -m skinjax_torch.tools.train_cli`` as a
    subprocess on the card (CLI_MECHANISMS × ResNet-50 × 2 folds, 1 epoch,
    B=32); its artifacts; then run_service with MODEL_CHECKPOINT one of its
    …+metablock checkpoints answers POST /predict/ with raw CSV lines through
    K1, K2 and K4. Returns the fusion kernels' launches over those requests."""
    import csv
    import re
    import tempfile

    import torch

    from skinjax_torch.data.featurizer import MetadataFeaturizer
    from skinjax_torch.data.fixtures import pad_ufes20_table, write_pad_ufes20_like
    from skinjax_torch.serve import png

    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        csv_path, images = write_pad_ufes20_like(os.path.join(tmp, "data"), n=CLI_IMAGES,
                                                 image_hw=CLI_IMAGE_HW, seed=0)
        table = pad_ufes20_table(CLI_IMAGES, seed=0)
        blobs = [Path(images, n).read_bytes() for n in table["img_id"][:8]]
        t0 = time.perf_counter()
        for b in blobs:
            png.decode_png(b)
        dec = time.perf_counter() - t0
        h, w = CLI_IMAGE_HW
        log(f"[{card}] cli PNG decode (stdlib reader, {w}x{h} RGB, Paeth rows, host): "
            f"{len(blobs) / dec:.2f} images/s, {len(blobs) * h * w * 3 / dec / 1e6:.3f} MB/s "
            f"of pixels ({len(blobs)} images in {dec:.2f} s)")

        results = os.path.join(tmp, "results")
        cmd = [sys.executable, "-m", "skinjax_torch.tools.train_cli", "--dataset", "pad-ufes-20",
               "--metadata-csv", csv_path, "--images-dir", images, "--results-dir", results,
               "--mechanisms", *CLI_MECHANISMS, "--backbones", CLI_BACKBONE, "--k-folds", "2",
               "--epochs", "1", "--batch-size", "32"]
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            p for p in (root, os.environ.get("PYTHONPATH")) if p))
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=root, env=env, capture_output=True, text=True,
                              timeout=600)
        wall = time.perf_counter() - t0
        if proc.returncode != 0 or "failed:" in proc.stdout:
            log(proc.stdout[-3000:] + proc.stderr[-6000:])
        check(proc.returncode == 0, f"train_cli exited {proc.returncode}")
        check("failed:" not in proc.stdout, "a cell of the train CLI's sweep failed")
        found = re.search(r'"n_runs": (\d+)', proc.stdout)
        n_runs = int(found.group(1)) if found else -1
        expected = len(CLI_MECHANISMS) * 1 * 1 * 2  # mechanisms × backbones × heads × folds
        cells = {m: os.path.join(results, f"multimodal_{CLI_BACKBONE}_{m}_h8")
                 for m in CLI_MECHANISMS}
        rows = {}
        for m, d in cells.items():
            with open(os.path.join(d, "model_metrics.csv")) as f:
                rows[m] = list(csv.DictReader(f))
        fz_path = os.path.join(results, "preprocess_data", "featurizer_pad-ufes-20.json")
        ckpts = {m: [os.path.join(d, f"multimodal_{CLI_BACKBONE}_{m}_h8_fold_{k}", "best")
                     for k in (1, 2)] for m, d in cells.items()}
        log(f"[{card}] cli python -m skinjax_torch.tools.train_cli: {wall:.1f} s wall (process "
            f"start, {CLI_IMAGES} PNG decodes, {expected} folds of {CLI_BACKBONE} at B=32, 1 "
            f"epoch); "
            f"n_runs {n_runs} (expected {expected}); per fold balanced accuracy/auc "
            + "; ".join(f"{m}: " + ", ".join(f"{r['balanced_accuracy'][:6]}/{r['auc'][:6]}"
                                              for r in rs) for m, rs in rows.items()))
        check(n_runs == expected, f"train_cli returned {n_runs} fold results, not {expected}")
        check(all(len(rs) == 2 and all(math.isfinite(float(r["balanced_accuracy"]))
                                       and math.isfinite(float(r["auc"])) for r in rs)
                  for rs in rows.values()), "model_metrics.csv lacks two finite folds a cell")
        check(os.path.isfile(fz_path), "the featurizer JSON is missing")
        check(all(os.path.isfile(os.path.join(c, "state.pt")) for cs in ckpts.values()
                  for c in cs), "a fold checkpoint is missing")

        # four rows of the dataset: their PNG files and raw CSV lines
        mech = RGATT + "+metablock"
        ckpt = ckpts[mech][0]
        fz = MetadataFeaturizer.load(fz_path)
        cols = fz.categorical_cols + fz.numerical_cols
        requests = [(Path(images, table["img_id"][i]).read_bytes(),
                     ", ".join(table[c][i] for c in cols)) for i in range(4)]
        launches, engine = phase_server(
            fk, card, cnn=CLI_BACKBONE,
            env={"MODEL_CHECKPOINT": ckpt, "FEATURIZER_JSON": fz_path,
                 "ATTENTION_MECHANISM": mech, "CNN_MODEL_NAME": CLI_BACKBONE},
            requests=requests, per_forward=FUSED_PER_FORWARD[mech])
        saved = torch.load(os.path.join(ckpt, "state.pt"), map_location="cpu",
                           weights_only=True)["model"]
        live = engine.model.state_dict()
        check(set(live) == set(saved) and all(torch.equal(live[k].cpu(), saved[k].cpu())
                                              for k in saved),
              "the service did not load the trained checkpoint")
        log(f"cli served {mech} from {os.path.relpath(ckpt, results)}: weights equal the "
            f"checkpoint's {len(saved)} tensors (BatchNorm buffers included)")
    return launches


def metablock_latency(device, card):
    """p50/p95 of the metablock engine (ResNet-50, bf16) at B=1, fused (K4 +
    K3) and plain, in turns."""
    import torch

    from skinjax_torch import FLAGSHIP
    from skinjax_torch.serve.engine import InferenceEngine

    model = smoke_model(dict(FLAGSHIP, attention_mechanism="metablock"), torch.bfloat16)
    engines = {"fused": InferenceEngine(model, use_fused=True, device=device),
               "plain": InferenceEngine(model, use_fused=False, device=device)}
    for kind in ("fused", "plain", "plain", "fused"):
        lat = engines[kind].measure_latency(n=50, batch=1)
        log(f"[{card}] engine metablock bf16 {kind} B=1: p50 {lat['p50_ms']:.3f} ms "
            f"p95 {lat['p95_ms']:.3f} ms mean {lat['mean_ms']:.3f} ms (50 forwards, host clock "
            f"to synchronize, inputs on the card)")


@contextlib.contextmanager
def env_set(env):
    """The environment variables ``env`` set meanwhile (the knobs a user sets)."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@contextlib.contextmanager
def swin_registered():
    """As backbones meanwhile: ``SWIN_PADDED`` (swin_tiny through the padded
    entry), and ``SMALL_SWIN`` / ``SMALL_SWIN_PADDED``, a small Swin (dims
    (64, 128), depths (2, 2), heads (2, 4): 32 channels a head, as
    swin_tiny; at 56×56 a shifted 2×2-window stage and a one-window stage) on
    the strip route and through the padded entry."""
    from skinjax_torch.models.backbones import _REGISTRY
    from skinjax_torch.models.backbones.swin import Swin, swin_tiny

    def small(padded):
        return lambda device=None: Swin((64, 128), (2, 2), (2, 4), fused_attn=padded,
                                        strip_attn=not padded, device=device)

    _REGISTRY[SWIN_PADDED] = (lambda device=None: swin_tiny(
        fused_attn=True, strip_attn=False, device=device), 768)
    _REGISTRY[SMALL_SWIN] = (small(False), 128)
    _REGISTRY[SMALL_SWIN_PADDED] = (small(True), 128)
    try:
        yield
    finally:
        for name in (SWIN_PADDED, SMALL_SWIN, SMALL_SWIN_PADDED):
            del _REGISTRY[name]


def k8_inputs(B, N, C, dtype, device, seed):
    """x, the weights and dy at one channel-attention shape, drawn on the
    card: unit-scale x and dy (x is a LayerNorm's output), weights at fan-in
    scale."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)

    def r(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=device) * scale

    args = [r(B, N, C), r(C, 3 * C, scale=C ** -0.5), r(3 * C, scale=0.1),
            r(C, C, scale=C ** -0.5), r(C, scale=0.1)]
    return [a.to(dtype) for a in args], r(B, N, C).to(dtype)


def log_checks(results, label):
    """Logs each (name, part, error, ok, tolerance text) and fails the run on
    the first mismatch."""
    for name, part, err, ok, tol_text in results:
        log(f"kernel {name} {part:5s} {label}: max_abs_err={err:.3e} tol={tol_text} "
            f"{'ok' if ok else 'FAIL'}")
        check(ok, f"{name} {part} disagrees with its twin at {label}")


def tol_text(tol):
    return f"atol {tol[0]:g} + rtol {tol[1]:g}·|twin|"


def phase_k8(ca, device):
    """K8 forward and backward against their twins at DaViT-tiny's four
    stage shapes, B=64 bf16 and B=8 fp32 (TF32 off): in bf16 y and ``of`` at
    BF16_TOL and dqkv at MLP_GRAD_TOL of max(1, max |twin|), since its dk and
    dv come through ds, the gradient of scores summed over every token (3136
    at stage 0) in another order; in fp32 all three at K8_F32_TOL of max(1,
    max |twin|); two forward and two backward calls bit-identical. Then bf16
    at four heads (``K8_CUDA_CORE_BF16``), which the CUDA-core kernels take,
    at the bf16 tolerances."""
    import torch

    from skinjax_torch import DAVIT_BATCH

    errors = {name: 0.0 for name in K8}
    Bc, Nc, Cc, hc = K8_CUDA_CORE_BF16
    cases = [(N, C, h, B, dtype) for N, C, h in K8_STAGES
             for B, dtype in ((DAVIT_BATCH, torch.bfloat16), (K8_F32_BATCH, torch.float32))]
    for N, C, h, B, dtype in cases + [(Nc, Cc, hc, Bc, torch.bfloat16)]:
        dname = str(dtype).split(".")[1]
        tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
        args, dy = k8_inputs(B, N, C, dtype, device, seed=N + C)
        x, wqkv, bqkv, wproj, _ = args
        y, y_twin = ca.channel_attention_fwd(*args, h), ca.channel_attention_plain(*args, h)
        y_again = ca.channel_attention_fwd(*args, h)
        got = ca.channel_attention_bwd(x, dy, wqkv, bqkv, wproj, h)
        again = ca.channel_attention_bwd(x, dy, wqkv, bqkv, wproj, h)
        want = ca.channel_attention_bwd_plain(x, dy, wqkv, bqkv, wproj, h)
        torch.cuda.synchronize()
        if dtype == torch.bfloat16:
            results = [
                ("channel_attention_fwd", "y", *compare(y, y_twin, tol), tol_text(tol)),
                ("channel_attention_bwd", "dqkv",
                 *compare_scaled(got[0], want[0], MLP_GRAD_TOL[dname]),
                 f"{MLP_GRAD_TOL[dname]:g}·max(1, |twin|)"),
                ("channel_attention_bwd", "of", *compare(got[1], want[1], tol),
                 tol_text(tol))]
        else:
            results = [(name, part, *compare_scaled(o, r, K8_F32_TOL),
                        f"{K8_F32_TOL:g}·max(1, |twin|)")
                       for name, part, o, r in (
                           ("channel_attention_fwd", "y", y, y_twin),
                           ("channel_attention_bwd", "dqkv", got[0], want[0]),
                           ("channel_attention_bwd", "of", got[1], want[1]))]
        for name, _, err, _, _ in results:
            errors[name] = max(errors[name], err)
        label = (f"{dname} B={B} N={N} C={C} h={h} route "
                 f"{ca.plan(dtype, B, N, C, h, False)['route']}")
        log_checks(results, label)
        same = torch.equal(y, y_again)
        log(f"kernel channel_attention_fwd {label}: two calls bit-identical: {same}")
        check(same, f"two channel_attention_fwd calls differ at {label}")
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        log(f"kernel channel_attention_bwd {label}: two calls bit-identical: {same}")
        check(same, f"two channel_attention_bwd calls differ at {label}")
        del args, dy, y, y_twin, y_again, got, again, want
    return errors


def k7pad_inputs(B, side, C, h, shifted, dtype, device, seed):
    """Swin's windows at one stage, drawn on the card: x (nB, 49, C) and the
    weights as ``k7_inputs`` draws them, a relative-position bias (h, 49,
    49), the shifted windows' mask (where the stage shifts; skinjax's
    ``_swin_attn_mask``, as the port's Swin builds it), and q, k, v, do for
    the backward core."""
    import torch

    from skinjax_torch.models.backbones.swin import swin_attn_mask

    N = WINDOW * WINDOW
    nB = B * (side // WINDOW) ** 2
    args, _, b, _ = k7_inputs(nB, WINDOW, C, h, dtype, device, seed, bias=True)
    args[0] = args[0].reshape(nB, N, C)
    mask = (torch.as_tensor(swin_attn_mask(side, side, WINDOW, WINDOW // 2), device=device)
            if shifted else None)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    qkvd = [torch.randn((nB, N, C), generator=gen, device=device).to(dtype) for _ in range(4)]
    return args, b, mask, qkvd


def phase_k7pad(wa, ga, device):
    """K7's padded entry at Swin-tiny's four stage shapes (B=64 bf16, B=8
    fp32), with the relative-position bias and, at stages 0-2, the shifted
    windows' mask: the forward against its twin; the backward core (the
    recompute kernel with the window mask) against its twin, dq, dk, dv and
    of at BF16_TOL/F32_TOL, dbias (summed over every window, in groups) at
    F32_TOL; two backward calls bit-identical."""
    import torch

    from skinjax_torch import SWIN_BATCH

    errors = {K7_PAD: 0.0, K7_PAD_BWD: 0.0}
    for side, C, h, shifted in SWIN_STAGES:
        for B, dtype in ((SWIN_BATCH, torch.bfloat16), (K7_PAD_F32_BATCH, torch.float32)):
            tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
            args, b, m, (q, k, v, do) = k7pad_inputs(B, side, C, h, shifted, dtype, device,
                                                     seed=side + C)
            y = wa.window_attention_pad_fwd(*args, b, m, h)
            y_twin = wa.window_attention_pad_plain(*args, b, m, h)
            got = ga.window_core_bwd(q, k, v, do, b, m, h, True)
            again = ga.window_core_bwd(q, k, v, do, b, m, h, True)
            want = ga.window_core_bwd_plain(q, k, v, do, b, m, h, True)
            torch.cuda.synchronize()
            results = [(K7_PAD, "y", *compare(y, y_twin, tol), tol_text(tol))]
            for part, g, w in zip(("dq", "dk", "dv", "of", "dbias"), got, want):
                t = F32_TOL if part == "dbias" else tol
                results.append((K7_PAD_BWD, part, *compare(g, w, t), tol_text(t)))
            for name, _, err, _, _ in results:
                errors[name] = max(errors[name], err)
            label = (f"{str(dtype).split('.')[1]} B={B} {side}x{side} ({q.shape[0]} windows) "
                     f"C={C} h={h} bias{'+mask' if shifted else ''}")
            log_checks(results, label)
            same = all(torch.equal(a, c) for a, c in zip(got, again))
            log(f"kernel {K7_PAD_BWD} {label}: two calls bit-identical: {same}")
            check(same, f"two window_core_bwd calls differ at {label}")
            del args, y, y_twin, got, again, want
    return errors


def k8_bound(B, N, C, h, itemsize, backward):
    """The least time (ms) for one K8 call: every input read once and every
    output written once over the HBM rate, against its products over the
    bf16 tensor-core rate. Forward: x, the weights → y; the q, k, v and
    output projections (2·4C² operations a token) and kᵀv, q·pᵀ (2·C·hd
    each). Backward: x, dy, the weights → dqkv, of; the q, k, v and do
    projections and six (hd, hd) products (kᵀv, doᵀq, of, dq, dk, dv)."""
    T, hd = B * N, C // h
    weights = (4 * C * C + 4 * C) * itemsize
    if backward:
        nbytes = (2 + 4) * T * C * itemsize + weights - C * itemsize
        ops = 2 * T * C * 4 * C + 6 * 2 * T * C * hd
    else:
        nbytes = 2 * T * C * itemsize + weights
        ops = 2 * T * C * 4 * C + 2 * 2 * T * C * hd
    return max(nbytes / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S) * 1e3, nbytes, ops


def k7pad_bound(nB, C, h, n_mask, itemsize, backward):
    """The least time (ms) for the padded entry's forward (as ``k7_bound``,
    plus the bias and the mask) or its backward core: q, k, v, do, the bias,
    the mask → dq, dk, dv, of, dbias; six (N, N) products a head (the
    scores, dp, of, dv, dq, dk)."""
    N = WINDOW * WINDOW
    T = nB * N
    planes = (h + n_mask) * N * N * 4
    if backward:
        nbytes = 8 * T * C * itemsize + planes + h * N * N * 4
        ops = 6 * 2 * T * N * C
    else:
        nbytes = 2 * T * C * itemsize + (4 * C * C + 4 * C) * itemsize + planes
        ops = 2 * T * C * 4 * C + 4 * T * N * C
    return max(nbytes / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S) * 1e3, nbytes, ops


def module_times(module, x, dy):
    """A PyTorch module as a yardstick (the port never calls it so): its
    forward per call by CUDA events (two runs of 20 calls) and as the
    torch.profiler device time, and its autograd backward as the device time
    of the backward alone on one retained graph (ms; a device time is None
    where the trace kept no record)."""
    import torch

    params = [p for p in module.parameters()]
    xr = x.detach().requires_grad_(True)

    def fwd():
        with torch.no_grad():
            return module(x)

    out = module(xr)

    def bwd():
        return torch.autograd.grad(out, [xr, *params], dy, retain_graph=True)

    f = (time_ms(fwd, 20, 3) + time_ms(fwd, 20, 3)) / 2
    fd, _ = device_us(fwd, n=10)
    bwd()
    b, _ = device_us(bwd, n=10)
    return f, (fd / 1e3 if fd > 0 else None), (b / 1e3 if b > 0 else None)


def phase_k8_times(ca, device, card):
    """K8 forward and backward against their twins at B=64, bf16, per
    DaViT-tiny stage; the yardstick is the port's plain
    ``DaViTChannelAttention`` on the same inputs (cuBLAS linears and
    einsums): its forward per call by CUDA events (the record's library
    time) and by device time, its autograd backward by device time. Each
    stage's line gives the route, the device time by kernel, the share of
    the bound and the factor against the plain module, device time against
    device time (the forward per call against per call too). Then the same
    module on K8's route (the kernels, its weight copies and the backward's
    dx and weight-gradient products on cuBLAS) against the plain one, device
    times: what a DaViT step's channel blocks save."""
    import copy

    import torch

    from skinjax_torch import DAVIT_BATCH
    from skinjax_torch.models.backbones.davit import DaViTChannelAttention

    B, out = DAVIT_BATCH, {}
    for N, C, h in K8_STAGES:
        args, dy = k8_inputs(B, N, C, torch.bfloat16, device, seed=41 + N)
        x, wqkv, bqkv, wproj, bproj = args
        plain = DaViTChannelAttention(C, h, fused=False).to(device, torch.bfloat16)
        with torch.no_grad():
            for lin, w, b in ((plain.qkv, wqkv, bqkv), (plain.proj, wproj, bproj)):
                lin.weight.copy_(w.t())
                lin.bias.copy_(b)
        fwd_call, fwd_dev, bwd_dev = module_times(plain, x, dy)
        routed = copy.deepcopy(plain)
        routed.fused = True
        _, routed_fwd, routed_bwd = module_times(routed, x, dy)
        lib = {"channel_attention_fwd": fwd_call, "channel_attention_bwd": bwd_dev}
        lib_dev = {"channel_attention_fwd": fwd_dev, "channel_attention_bwd": bwd_dev}
        calls = {
            "channel_attention_fwd": (lambda: ca.channel_attention_fwd(*args, h),
                                      lambda: ca.channel_attention_plain(*args, h)),
            "channel_attention_bwd": (
                lambda: ca.channel_attention_bwd(x, dy, wqkv, bqkv, wproj, h),
                lambda: ca.channel_attention_bwd_plain(x, dy, wqkv, bqkv, wproj, h)),
        }
        for name, (kern, twin) in calls.items():
            bwd = name.endswith("bwd")
            rec = time_record(card, name, f"B={B} N={N} C={C} h={h}", kern, twin,
                              K8_KERNELS[name], k8_bound(B, N, C, h, 2, bwd), lib[name])
            out[(name, N)] = rec
            plan = ca.plan(torch.bfloat16, B, N, C, h, bwd)
            _, by_name = device_us(kern, n=5)
            split = {k: sum(t for key, t in by_name.items() if k in key) for k in K8_KERNELS[name]}
            # None: the trace kept no record of the kernels (torch.profiler
            # now and then drops a late trace's records)
            dev_ms = sum(split.values()) / 1e3 or None
            factor = ("not measured" if lib_dev[name] is None or dev_ms is None
                      else f"{dev_ms / lib_dev[name]:.2f}x device time")
            if not bwd and lib[name] is not None:
                factor += f", {rec['ms'] / lib[name]:.2f}x per call"
            blocks = (f"{ca.HEAD_GROUP} heads a block" if plan["route"] == "mma"
                      else "a head a block")
            log(f"[{card}] K8 {name} stage B={B} N={N} C={C} h={h}: route {plan['route']}, "
                f"{plan['n_seg']} segments, {blocks}; per call "
                f"{rec['ms'] * 1e3:.2f} us, device {ms_us(dev_ms)} ("
                + ", ".join(f"{k} {t:.2f} us" for k, t in split.items())
                + f"); share of bound {100 * rec['bound_ms'] / rec['ms']:.1f}% per call, "
                + ("not measured" if dev_ms is None
                   else f"{100 * rec['bound_ms'] / dev_ms:.1f}%")
                + f" of the device time; factor against the plain module {factor}")
        log(f"[{card}] time the port's plain DaViTChannelAttention bf16 B={B} N={N} C={C} "
            f"(cuBLAS linears + einsums): forward {ms_us(fwd_call)} per call (CUDA events), "
            f"{ms_us(fwd_dev)} device time (torch.profiler); backward {ms_us(bwd_dev)} (the "
            f"device time of autograd's backward alone, torch.profiler)")
        log(f"[{card}] time DaViTChannelAttention bf16 B={B} N={N} C={C} on K8's route "
            f"against the plain module, device times (torch.profiler): forward "
            f"{ms_us(routed_fwd)} against {ms_us(fwd_dev)}, autograd backward (the kernel, dx "
            f"and the weight gradients) {ms_us(routed_bwd)} against {ms_us(bwd_dev)}")
        del args, dy, plain, routed
    return out


def phase_k7pad_times(wa, ga, device, card):
    """K7's padded forward and its masked backward core against their twins
    at B=64, bf16, per Swin-tiny stage. The forward's yardstick is the same
    function as PyTorch calls (``window_chain_times``, the bias and the mask
    as SDPA's (nB, h, 49, 49) attn_mask), the backward core's
    F.scaled_dot_product_attention's backward on the same per-window q, k, v
    and mask; SDPA's forward alone (the attention core only) is logged
    beside the forward (the port never calls either)."""
    import torch

    from skinjax_torch import SWIN_BATCH

    B, out = SWIN_BATCH, {}
    for side, C, h, shifted in SWIN_STAGES:
        args, b, m, (q, k, v, do) = k7pad_inputs(B, side, C, h, shifted, torch.bfloat16, device,
                                                 seed=51 + side)
        nB, N, _ = q.shape
        n_mask = 0 if m is None else m.shape[0]
        attn = b[None] + (m[:, None] if m is not None else 0.0)
        attn = attn.expand(nB // attn.shape[0], *attn.shape).reshape(nB, h, N, N)
        core = dict(zip((K7_PAD, K7_PAD_BWD), sdpa_times(q, k, v, do, attn.to(q.dtype), h)))
        x, wqkv, bqkv, wproj, bproj = args
        dy = torch.randn(x.shape, generator=torch.Generator(device=device).manual_seed(side),
                         device=device).to(x.dtype)
        chain, _ = window_chain_times(wa, x, wqkv, bqkv, wproj, bproj, attn.to(x.dtype), h, dy)
        lib = {K7_PAD: chain, K7_PAD_BWD: core[K7_PAD_BWD]}
        log(f"[{card}] time the same function as PyTorch calls bf16 at Swin {side}x{side} "
            f"(F.linear qkv, SDPA with bias{'+mask' if shifted else ''}, F.linear proj): forward "
            f"{ms_us(chain)} per call (CUDA events); SDPA's forward alone (the attention core "
            f"only) {ms_us(core[K7_PAD])}")
        del attn, dy
        calls = {
            K7_PAD: (lambda: wa.window_attention_pad_fwd(*args, b, m, h),
                     lambda: wa.window_attention_pad_plain(*args, b, m, h)),
            K7_PAD_BWD: (lambda: ga.window_core_bwd(q, k, v, do, b, m, h, True),
                         lambda: ga.window_core_bwd_plain(q, k, v, do, b, m, h, True)),
        }
        for name, (kern, twin) in calls.items():
            out[(name, side)] = time_record(
                card, name, f"B={B} {side}x{side} ({nB} windows) C={C} h={h} "
                f"bias{'+mask' if shifted else ''}", kern, twin, K7_PAD_KERNELS[name],
                k7pad_bound(nB, C, h, n_mask, 2, name == K7_PAD_BWD), lib[name])
        del args, q, k, v, do
    return out


def phase_route_ab(device, card, label, routes, batch, cw, step):
    """Train steps of two routes of one model in turns (A, B, B, A), each
    from its own state: ``routes`` maps a route's name to (config, the
    environment it runs under). 12 unfrozen steps after 3 warm-up each,
    CUDA events, then one torch.profiler-traced step a route in turns (its
    device time); returns {route: mean ms a step}."""
    states = {}
    for name, (config, env) in routes.items():
        states[name] = train_state(config, device)
    order = list(routes)
    times = {name: [] for name in order}
    for name in (order[0], order[1], order[1], order[0]):
        state, env = states[name], routes[name][1]
        with env_set(env):
            call = lambda: step(state, batch["image"], batch["metadata"], batch["label"], 0, cw)  # noqa: E731,B023
            for _ in range(3):
                call()
            times[name].append(time_ms(call, iters=12, warmup=0))
    # the device time of one profiled step a route, in turns too: the steps
    # are host-bound, so their wall time moves with the host
    dev = {name: [] for name in order}
    for name in (order[0], order[1], order[1], order[0]):
        state = states[name]
        with env_set(routes[name][1]):
            dev[name].append(device_us(
                lambda: step(state, batch["image"], batch["metadata"], batch["label"], 0, cw),  # noqa: B023
                n=1)[0] / 1e3)
    B = batch["image"].shape[0]
    means = {name: sum(t) / len(t) for name, t in times.items()}
    dev_means = {name: sum(t) / len(t) for name, t in dev.items()}
    log(f"[{card}] A/B train {label} unfrozen B={B}, in turns "
        f"{order[0]}-{order[1]}-{order[1]}-{order[0]} (12 steps each after 3 warm-up, CUDA "
        f"events): " + "; ".join(f"{n} {means[n]:.2f} ms ({B / means[n] * 1e3:.1f} img/s; runs "
                                 + ", ".join(f"{t:.2f}" for t in times[n]) + ")" for n in order)
        + f"; faster: {min(means, key=means.get)}")
    log(f"[{card}] A/B train {label} unfrozen B={B}: device time of one profiled step "
        f"(torch.profiler, in turns): " + "; ".join(
            f"{n} {dev_means[n]:.2f} ms (" + ", ".join(f"{t:.2f}" for t in dev[n]) + ")"
            for n in order) + f"; less device time: {min(dev_means, key=dev_means.get)}")
    return means



def phase_davit_k8(counters, device, card, batch, cw, step, k7_step):
    """DaViT-tiny with K8: skinjax's ``SKINJAX_CHATTN=pallas``, which the
    port's model reads at each forward, sends every channel attention through
    K8. Served by run_service (K8 6 a request), trained at B=64 (the loss
    falls; K8 6 + 6 a step, 6 + 0 frozen), a small DaViT's fp32 step on the
    card against the CPU, and the train step A/B'd against the plain route
    (``batch``, ``cw`` and ``step`` DaViT's). Returns K8's launches over the
    10 unfrozen steps."""
    from skinjax_torch import DAVIT, DAVIT_BATCH

    fk, ak, wa, ca = counters
    k8_step = {"channel_attention_fwd": K8_PER_FORWARD, "channel_attention_bwd": K8_PER_FORWARD}
    with env_set(K8_ON):
        phase_server(fk, card, cnn="davit_tiny",
                     towers=[(wa, K7_SERVED), (ca, dict(k8_step, channel_attention_bwd=0))])
        _, _, _, launches = phase_train(
            [ak, wa, ca], device, card, "davit+k8", DAVIT, DAVIT_BATCH,
            per_step={K5: 1, **k7_step, **k8_step},
            frozen_per_step={K5: 1, **k7_step, "window_attention_bwd": 0, **k8_step,
                             "channel_attention_bwd": 0})
        with small_davit_registered():
            phase_card_vs_cpu(device, cnn=SMALL_DAVIT, hw=56)
    phase_route_ab(device, card, "davit channel attention",
                   {"plain": (DAVIT, {}), "K8": (DAVIT, K8_ON)}, batch, cw, step)
    return {name: launches[name] for name in K8}


def phase_swin(counters, device, card):
    """Swin-tiny on its default route, K7 on the map with the relative-position
    bias and the shifted windows' mask: served, trained at B=64 (K7 12 + 12
    a step, 12 + 0 frozen; swin_tiny_images_per_sec), a small Swin's fp32
    step on the card against the CPU, as ``phase_tower`` drives a tower. Then
    through K7's padded entry (``swin_tiny(fused_attn=True,
    strip_attn=False)``): trained (K7-pad 12 forwards and 12 recompute
    backward cores with the window mask a step), a small padded Swin's fp32
    step on the card against the CPU, and the two routes' train steps A/B'd.
    Returns the padded entry's launches over its 10 unfrozen steps."""
    from skinjax_torch import SWIN, SWIN_BATCH

    fk, ak, wa, ga = counters
    wa_off = {name: 0 for name in wa.LAUNCHES}
    sw_fwd = dict(wa_off, window_attention_fwd=SWIN_PER_FORWARD)
    sw_step = {K5: 1, **sw_fwd, "window_attention_bwd": SWIN_PER_FORWARD}
    _, sw_times = phase_tower(
        [fk, ak, wa], device, card, "swin-tiny", SWIN, SWIN_BATCH, [(wa, sw_fwd)], sw_step,
        dict(sw_step, window_attention_bwd=0), swin_registered, SMALL_SWIN,
        {"K7": [n for names in K7_KERNELS.values() for n in names]}, hw=56)
    log(f"[{card}] swin_tiny_images_per_sec "
        f"{SWIN_BATCH / sw_times['unfrozen_weights'] * 1e3:.1f} (Swin-tiny, RG-ATT, "
        f"B={SWIN_BATCH}, bf16, augment on, unfrozen; CUDA events)")
    with swin_registered():
        padded = dict(SWIN, cnn_model_name=SWIN_PADDED)
        pad_step = {K5: 1, **dict(wa_off, window_attention_pad_fwd=SWIN_PER_FORWARD),
                    "global_attention_fwd": 0, "global_attention_bwd": 0,
                    K12_RECOMPUTE: SWIN_PER_FORWARD}
        batch, cw, step, launches = phase_train(
            [ak, wa, ga], device, card, "swin-tiny-padded", padded, SWIN_BATCH,
            per_step=pad_step, frozen_per_step=dict(pad_step, **{K12_RECOMPUTE: 0}),
            lr=TOWER_TRAIN_LR)
        phase_card_vs_cpu(device, cnn=SMALL_SWIN_PADDED, hw=56)
        phase_route_ab(device, card, "swin-tiny window attention",
                       {"strip": (SWIN, {}), "padded": (padded, {})}, batch, cw, step)
    _SMOKE_MODELS.clear()
    return {K7_PAD: launches[K7_PAD], K7_PAD_BWD: launches[K12_RECOMPUTE]}


def k6_inputs(shape, layout, dtype, device, seed):
    """x and dy at one K6 shape, drawn on the card, in the layout the towers
    hand their BatchNorms: a channels_last map, or the (B, C, N) view of
    (B, N, C) tokens. x has a per-channel offset (a BN input is not
    centered)."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    dt = getattr(torch, dtype)
    if layout == "map":
        N, C, H, W = shape
        x = torch.randn((N, H, W, C), generator=gen, device=device)
        x = x + torch.randn((C,), generator=gen, device=device)
        dy = torch.randn((N, H, W, C), generator=gen, device=device)
        return x.to(dt).permute(0, 3, 1, 2), dy.to(dt).permute(0, 3, 1, 2)
    B, N, C = shape
    x = torch.randn((B, N, C), generator=gen, device=device) + torch.randn(
        (C,), generator=gen, device=device)
    dy = torch.randn((B, N, C), generator=gen, device=device)
    return x.to(dt).transpose(1, 2), dy.to(dt).transpose(1, 2)


def k6_sums_ok(got, want, terms):
    """(max abs error, every channel's sum within K6_SUM_TOL·Σ|terms|)."""
    import torch

    check(got.dtype == torch.float32 and got.shape == want.shape, "misshapen K6 sums")
    check(bool(torch.isfinite(got).all()), "non-finite K6 sums")
    err = (got - want).abs()
    return float(err.max()), bool((err <= K6_SUM_TOL * terms).all())


@contextlib.contextmanager
def k6_twins(bn):
    """batch_norm_train's sums through the twins meanwhile, on any device:
    the twin route that a K6 route is held against."""
    saved = bn.bn_stats, bn.bn_grad_stats
    bn.bn_stats, bn.bn_grad_stats = bn.bn_stats_reference, bn.bn_grad_stats_reference
    try:
        yield
    finally:
        bn.bn_stats, bn.bn_grad_stats = saved


def phase_k6(bn, device):
    """K6 against its twins at K6_SHAPES: (Σx, Σx²) and (Σdy, Σdy·x) within
    K6_SUM_TOL of each channel's Σ|terms|, two calls bit-identical; the
    wrappers raise on a plain NCHW map (no hidden copy); and the train route
    (``FusedBatchNorm2d``/``1d``: y, dx, dweight, dbias and the running
    statistics) against the same module on the twin route: y and dx within
    two bf16 roundings of their largest value (fp32: 1e-5 of it), the fp32
    weight gradients and statistics within 1e-5 of max(1, |twin|)."""
    import torch

    errors = {name: 0.0 for name in K6}
    for label, (shape, layout, dtype) in K6_SHAPES.items():
        x, dy = k6_inputs(shape, layout, dtype, device, seed=len(label))
        got = bn.bn_stats(x) + bn.bn_grad_stats(x, dy)
        again = bn.bn_stats(x) + bn.bn_grad_stats(x, dy)
        want = bn.bn_stats_reference(x) + bn.bn_grad_stats_reference(x, dy)
        torch.cuda.synchronize()
        xr, gr = bn._rows(x).float(), bn._rows(dy).float()
        terms = (xr.abs().sum(0), (xr * xr).sum(0), gr.abs().sum(0), (gr * xr).abs().sum(0))
        results = []
        for i, part in enumerate(("sum x", "sum x^2", "sum dy", "sum dy*x")):
            name = "bn_stats" if i < 2 else "bn_grad_stats"
            err, ok = k6_sums_ok(got[i], want[i], terms[i])
            errors[name] = max(errors[name], err)
            results.append((name, part, err, ok, f"{K6_SUM_TOL:g}·Σ|terms| per channel"))
        M = x.numel() // x.shape[1]
        log_checks(results, f"{label} {dtype} M={M} C={x.shape[1]} {layout}")
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        log(f"kernel bn_stats/bn_grad_stats {label}: two calls bit-identical: {same}")
        check(same, f"two K6 calls differ at {label}")
        del x, dy, got, again, want, xr, gr, terms
    plain = torch.randn(2, 8, 4, 4, device=device, dtype=torch.bfloat16)
    refused = raises(lambda: bn.bn_stats(plain), ValueError)
    log(f"kernel bn_stats on a plain NCHW map (C not contiguous): raises {refused}")
    check(refused, "bn_stats took a layout it does not read")

    for label in ("nextvit-stem", "nextvit-tokens", "fp32-map", "odd-rows"):
        shape, layout, dtype = K6_SHAPES[label]
        C = shape[1] if layout == "map" else shape[2]
        outs = []
        for route in ("K6", "twin"):
            x, dy = k6_inputs(shape, layout, dtype, device, seed=7)
            x.requires_grad_(True)
            cls = bn.FusedBatchNorm2d if layout == "map" else bn.FusedBatchNorm1d
            m = cls(C).to(device).train()
            with torch.no_grad():
                m.weight.copy_(torch.linspace(0.5, 1.5, C))
                m.bias.copy_(torch.linspace(-0.2, 0.2, C))
            with k6_twins(bn) if route == "twin" else contextlib.nullcontext():
                y = m(x)
                y.backward(dy)
            outs.append((y.detach(), x.grad, m.weight.grad, m.bias.grad, m.running_mean,
                         m.running_var))
        torch.cuda.synchronize()
        results = []
        for part, a, b in zip(("y", "dx", "dweight", "dbias", "running_mean", "running_var"),
                              *outs):
            big = float(b.float().abs().max())
            if part in ("y", "dx"):
                tol = (2 * 2.0 ** -8 if dtype == "bfloat16" else 1e-5) * big
            else:
                tol = 1e-5 * max(1.0, big)
            err = float((a.float() - b.float()).abs().max())
            results.append(("batch_norm_train", part, err, err <= tol, f"{tol:.3g}"))
        log_checks(results, f"{label} {dtype} K6 route vs the twin route")
        del outs, x, dy
    return errors


def k6_bound(M, C, itemsize, grad):
    """The least time (ms) for one K6 call: x (and dy) read once, the two
    (C,) fp32 sums written once, over the HBM rate, against 3 fp32
    operations an element (an add and a fused multiply-add) over the fp32
    rate (the sums run on the CUDA cores)."""
    nbytes = (2 if grad else 1) * M * C * itemsize + 2 * C * 4
    ops = 3 * M * C
    return max(nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S) * 1e3, nbytes, ops


def phase_k6_times(bn, device, card):
    """K6 against its twins at each map shape of K6_SHAPES in bf16 (the
    record's at K6_RECORD): CUDA events in turns, device times, the bound,
    and one PyTorch call of the same sums as the yardstick
    (``torch.batch_norm_stats``, whose Welford sums give mean and invstd, and
    ``torch.batch_norm_backward_reduce``, Σdy and Σdy·(x − mean)), which the
    port never calls."""
    import torch

    out = {}
    for label in ("resnet50-bn1", "nextvit-stem", "nextvit-stage3-1024"):
        shape, layout, dtype = K6_SHAPES[label]
        x, dy = k6_inputs(shape, layout, dtype, device, seed=3)
        C = x.shape[1]
        M = x.numel() // C
        mean, invstd = torch.batch_norm_stats(x, 1e-5)
        w = torch.ones(C, device=device)
        lib = {"bn_stats": time_ms(lambda: torch.batch_norm_stats(x, 1e-5), 20, 3),
               "bn_grad_stats": time_ms(lambda: torch.batch_norm_backward_reduce(
                   dy, x, mean, invstd, w, True, False, False), 20, 3)}
        calls = {"bn_stats": (lambda: bn.bn_stats(x), lambda: bn.bn_stats_reference(x)),
                 "bn_grad_stats": (lambda: bn.bn_grad_stats(x, dy),
                                   lambda: bn.bn_grad_stats_reference(x, dy))}
        for name, (kern, twin) in calls.items():
            out[(name, label)] = time_record(
                card, name, f"{label} M={M} C={C} {layout}", kern, twin, K6_KERNELS,
                k6_bound(M, C, x.element_size(), name == "bn_grad_stats"), lib[name])
        del x, dy
    return out


def k6_count(name):
    """BatchNorms of a registered tower: K6's launches of each kind per
    unfrozen train step on its K6 route."""
    from skinjax_torch.models.backbones import create_backbone
    from skinjax_torch.ops import batch_norm as bn

    return bn.count_batch_norms(bn.fuse_batch_norms(create_backbone(name, device="meta")[0]))


def k6_steps(name):
    """(per unfrozen step, per frozen step) launches on a tower's K6 route:
    stats once per BatchNorm in both modes; grad stats once per BatchNorm
    whose input, weight or bias needs a gradient: all of them unfrozen, none
    frozen (no tower parameter and no image needs one)."""
    n = k6_count(name)
    return ({K5: 1, "bn_stats": n, "bn_grad_stats": n},
            {K5: 1, "bn_stats": n, "bn_grad_stats": 0})


@contextlib.contextmanager
def k6_registered():
    """Meanwhile each BatchNorm tower also under ``name + K6_ROUTE`` with its
    BatchNorms fused (``fuse_batch_norms``: K6 in train mode), and
    ``SMALL_NEXTVIT`` (fused) for the card-vs-CPU step."""
    from skinjax_torch.models.backbones import _REGISTRY
    from skinjax_torch.models.backbones.nextvit import NextViT
    from skinjax_torch.ops.batch_norm import fuse_batch_norms

    def fused(ctor):
        return lambda device=None: fuse_batch_norms(ctor(device=device))

    added = {f"{name}{K6_ROUTE}": (fused(_REGISTRY[name][0]), _REGISTRY[name][1])
             for name in ("resnet-50", "nextvit_small", *ZOO)}
    added[SMALL_NEXTVIT] = (fused(lambda device=None: NextViT(
        (1, 2, 2, 1), (16, 16, 32), stage_channels=((32,), (64, 128), (64, 128), (128,)),
        stage_types=(("ncb",), ("ncb", "ntb"), ("ncb", "ntb"), ("ntb",)), device=device)), 128)
    _REGISTRY.update(added)
    try:
        yield
    finally:
        for name in added:
            del _REGISTRY[name]


def phase_nextvit(counters, device, card):
    """NextViT-small (``skinjax_torch.NEXTVIT``) on its K6 route: served
    (fused against plain engine at B=1 and 8, K6 launching nothing in eval
    mode; the fp32 engine on the card against the CPU; run_service), trained
    at B=64 unfrozen and frozen (the loss falls; K6 as ``k6_steps`` counts;
    the gradients laid out anew per step), a small fused NextViT's fp32 step on
    the card against the CPU's twin route, train images/s and a profiled
    step; then the native and K6 routes' train steps A/B'd in turns
    (nextvit_small_images_per_sec on both). Returns K6's launches over the 10
    unfrozen steps and the A/B means."""
    import torch

    from skinjax_torch import NEXTVIT, NEXTVIT_BATCH

    fk, ak, bn = counters
    k6 = dict(NEXTVIT, cnn_model_name="nextvit_small" + K6_ROUTE)
    bn_off = {name: 0 for name in K6}
    per_step, frozen = k6_steps("nextvit_small")
    log(f"nextvit-small: {per_step['bn_stats']} BatchNorms ("
        f"{sum(isinstance(m, torch.nn.BatchNorm1d) for m in smoke_model(k6, None).modules())} "
        f"of them BatchNorm1d on pooled tokens); K6 a step: {per_step} unfrozen, {frozen} frozen")
    fused, plain = phase_slice(fk, device, card, "nextvit-small", k6, [(bn, bn_off)])
    phase_server(fk, card, cnn=k6["cnn_model_name"], towers=[(bn, bn_off)])
    engine_latency(fused, plain, "nextvit-small", card, batches=(1,), n=20, profile=False)
    del fused, plain
    batch, cw, step, launches = phase_train(
        [ak, bn], device, card, "nextvit-small K6", k6, NEXTVIT_BATCH, per_step=per_step,
        frozen_per_step=frozen, lr=TOWER_TRAIN_LR)
    state = train_state(k6, device)
    bn.reset_launches()
    step(state, batch["image"], batch["metadata"], batch["label"], 0, cw)
    torch.cuda.synchronize()
    log(f"nextvit-small K6 step: {bn.COPIES['dy']} incoming gradients laid out anew as x "
        f"(explicit copies in batch_norm_train's backward; the final BN's gradient is the mean "
        f"pool's broadcast)")
    del state
    phase_card_vs_cpu(device, cnn=SMALL_NEXTVIT, hw=64)
    phase_train_times(device, card, batch, cw, step, "nextvit-small K6", k6,
                      kernel_names={"K6": K6_KERNELS, "K5": K5_KERNELS})
    means = phase_route_ab(device, card, "nextvit-small BatchNorm",
                           {"native": (NEXTVIT, {}), "K6": (k6, {})}, batch, cw, step)
    for route, ms in means.items():
        log(f"[{card}] nextvit_small_images_per_sec {NEXTVIT_BATCH / ms * 1e3:.1f} on the "
            f"{route} BatchNorm route (NextViT-small, RG-ATT, B={NEXTVIT_BATCH}, bf16, augment "
            f"on, unfrozen; the A/B's means, CUDA events)")
    _SMOKE_MODELS.clear()
    return {name: launches[name] for name in K6}, means


def phase_flagship_k6_ab(device, card):
    """The flagship (ResNet-50 + RG-ATT, B=128) on the native and K6
    BatchNorm routes, train steps A/B'd in turns; returns the means."""
    import torch

    from skinjax_torch import FLAGSHIP
    from skinjax_torch.train.steps import make_train_step_weighted

    batch, cw = train_batch(device)
    step = make_train_step_weighted(augment=True, image_dtype=torch.bfloat16)
    means = phase_route_ab(device, card, "flagship BatchNorm",
                           {"native": (FLAGSHIP, {}),
                            "K6": (dict(FLAGSHIP, cnn_model_name="resnet-50" + K6_ROUTE), {})},
                           batch, cw, step)
    _SMOKE_MODELS.clear()
    return means


def phase_zoo(counters, device, card):
    """The CNN zoo at full width on its K6 route (VGG16 has no BatchNorm):
    one served bf16 forward at B=1 through the engine (K6 launching nothing),
    and the train step at ZOO's batch (phase_train: the loss falls over 10
    steps, frozen mode, K6 as ``k6_steps`` counts); DenseNet-169's train
    images/s (densenet169_images_per_sec) and a profiled step."""
    import numpy as np
    import torch

    from skinjax_torch import FLAGSHIP
    from skinjax_torch.serve.engine import InferenceEngine

    fk, ak, bn = counters
    for name, B in ZOO.items():
        n = k6_count(name)
        config = dict(FLAGSHIP, cnn_model_name=name + K6_ROUTE)
        engine = InferenceEngine(smoke_model(config, torch.bfloat16), use_fused=True,
                                 device=device)
        rng = np.random.default_rng(5)
        bn.reset_launches()
        probs = engine.predict_probs(rng.integers(0, 256, (1, 224, 224, 3), dtype=np.uint8),
                                     rng.normal(size=(1, 91)).astype(np.float32))
        torch.cuda.synchronize()
        log(f"serve {name} bf16 B=1: probs {np.round(probs, 4).tolist()}; K6 launches "
            f"{dict(bn.LAUNCHES)}")
        check(probs.shape == (1, 6) and bool(np.isfinite(probs).all())
              and abs(float(probs.sum()) - 1) < 1e-3, f"bad {name} probabilities")
        check(sum(bn.LAUNCHES.values()) == 0, "K6 launched in eval mode")
        del engine
        per_step, frozen = k6_steps(name)
        log(f"{name}: {n} BatchNorms; K6 a step: {per_step} unfrozen, {frozen} frozen")
        batch, cw, step, _ = phase_train([ak, bn], device, card, f"{name} K6", config, B,
                                         per_step=per_step, frozen_per_step=frozen,
                                         lr=TOWER_TRAIN_LR)
        if name == "densenet169":
            times = phase_train_times(device, card, batch, cw, step, f"{name} K6", config,
                                      kernel_names={"K6": K6_KERNELS})
            log(f"[{card}] densenet169_images_per_sec "
                f"{B / times['unfrozen_weights'] * 1e3:.1f} (DenseNet-169, RG-ATT, B={B}, bf16, "
                f"augment on, unfrozen, K6 route; CUDA events)")
        del batch, cw, step
        _SMOKE_MODELS.clear()


# ---------------------------------------------------------------------------
# The rest of the model zoo: TabTransformer and static-embedding towers,
# sequence fusion, the baselines and the dynamic-batching service
# ---------------------------------------------------------------------------

def tab_tower(prep):
    """TabTransformer (``TAB_TOWER``) over a prepared PAD-UFES-20 table's
    categorical columns and numerics."""
    from skinjax_torch.data.tabular import cardinalities
    from skinjax_torch.models.text import TabTransformer

    return TabTransformer(cardinalities(prep.featurizer), len(prep.featurizer.numerical_cols),
                          **TAB_TOWER)


def tab_dataset(root, n=TAB_ROWS):
    """A PAD-UFES-20-like table of ``n`` rows written to ``root``, prepared
    as the train CLI prepares it, and a ``TabularSource`` over it with 224×224
    uint8 images whose brightness follows the class (drawn in bulk)."""
    import numpy as np

    from skinjax_torch.data.fixtures import write_pad_ufes20_like
    from skinjax_torch.data.schemas import prepare_dataset
    from skinjax_torch.data.tabular import TabularSource

    csv_path, _ = write_pad_ufes20_like(root, n=n, image_hw=(8, 8), seed=0, paeth=False)
    prep = prepare_dataset("pad-ufes-20", csv_path)
    rng = np.random.default_rng(0)
    images = rng.integers(0, 200, (n, TRAIN_HW, TRAIN_HW, 3), dtype=np.uint8)
    images += (10 * prep.labels).astype(np.uint8)[:, None, None, None]
    return prep, TabularSource.from_prepared(prep, images)


def batch_of(source, B, device):
    """The first B rows of a source as tensors on ``device``."""
    import numpy as np

    from skinjax_torch.train.loop import _to_device

    return _to_device(source.batch(np.arange(B)), device)


def falls(counters, label, state, batch, cw, n=10):
    """``n`` train steps (augment on, bf16) on one batch: their losses, which
    must be finite and fall, and the ``counters``' launches over them."""
    import torch

    from skinjax_torch.train.steps import make_train_step_weighted

    step = make_train_step_weighted(augment=True, image_dtype=torch.bfloat16)
    for c in counters:
        c.reset_launches()
    losses = [float(step(state, batch["image"], batch["metadata"], batch["label"], 0, cw))
              for _ in range(n)]
    torch.cuda.synchronize()
    launches = {k: v for c in counters for k, v in c.LAUNCHES.items()}
    log(f"train {label} (one batch, augment on, bf16): losses "
        + " ".join(f"{x:.4f}" for x in losses) + f"; launches {launches} over {n} steps")
    check(all(math.isfinite(x) for x in losses), f"non-finite {label} train loss")
    check(sum(losses[-3:]) / 3 < sum(losses[:3]) / 3 and losses[-1] < losses[0],
          f"the {label} loss did not fall over {n} steps on one batch")
    return launches


def path_times(card, label, state, batch, cw, kernel_names=None):
    """A path's train step after its loss check: ms a step (12 steps after 3
    warm-up, CUDA events, the batch on the card) and a profiled step's device
    time, with the share of each group of kernels named (``kernel_names``:
    {label: kernel names}; K5's always)."""
    import torch

    from skinjax_torch.train.steps import make_train_step_weighted

    step = make_train_step_weighted(augment=True, image_dtype=torch.bfloat16)
    B = batch["label"].shape[0]

    def call():
        return step(state, batch["image"], batch["metadata"], batch["label"], 0, cw)

    for _ in range(3):
        call()
    ms = time_ms(call, iters=12, warmup=0)
    total, by_name = device_us(call, n=3)
    shares = []
    for name, names in {"K5": K5_KERNELS, **(kernel_names or {})}.items():
        ours = sum(v for k, v in by_name.items() if any(n in k for n in names))
        shares.append(f"{name} {ours:.1f} us ({share(ours, total)})")
    log(f"[{card}] train {label} unfrozen B={B}: {ms:.2f} ms per step, {B / ms * 1e3:.1f} img/s "
        f"(12 steps after 3 warm-up, CUDA events); profiled step: device time "
        f"{total / 1e3:.2f} ms = {100 * total / (ms * 1e3):.1f}% of the step; "
        + "; ".join(shares))
    return ms, total


K12_NAMES = {"K12": [n for names in K12_KERNELS.values() for n in names]}


def phase_models_k12(ga, device):
    """K12 at this slice's shapes (``K12_MODEL_SHAPES``: TabTransformer's 8
    channels a head over PAD-UFES-20's categorical columns, sequence fusion's
    4 metadata tokens and 197 image tokens at 64 channels a head), bf16 and
    fp32: the forward's o and P and the stored-P backward's dq, dk, dv
    against their twins (the backward on the twin's P), two calls of each
    bit-identical. Returns the largest errors."""
    import torch

    errors = {"global_attention_fwd": 0.0, "global_attention_bwd": 0.0}
    for label, (B, N, C, h) in K12_MODEL_SHAPES.items():
        for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, F32_TOL)):
            (q, k, v), do, _, _, _ = k12_inputs(B, N, C, h, False, False, False, dtype, device,
                                                seed=N + C)
            o, p = ga.global_attention_fwd(q, k, v, None, None, None, h, emit_p=True)
            o2, p2 = ga.global_attention_fwd(q, k, v, None, None, None, h, emit_p=True)
            ro, rp = ga.attention_core_plain(q, k, v, None, None, None, h)
            got = ga.global_attention_bwd(q, k, v, do, rp, None, h, False)
            again = ga.global_attention_bwd(q, k, v, do, rp, None, h, False)
            want = ga.attention_core_bwd_plain(q, k, v, do, rp, None, h, False)
            torch.cuda.synchronize()
            same = (torch.equal(o, o2) and torch.equal(p, p2)
                    and all(torch.equal(x, y) for x, y in zip(got[:3], again[:3])))
            results = [("global_attention_fwd", "o", o, ro, tol),
                       ("global_attention_fwd", "P", p, rp, F32_TOL)]
            results += [("global_attention_bwd", part, g, w, tol)
                        for part, g, w in zip(("dq", "dk", "dv"), got, want)]
            for name, part, out, ref, t in results:
                err, ok = compare(out, ref, t)
                errors[name] = max(errors[name], err)
                log(f"kernel {name} {part:5s} {str(dtype):14s} {label} B={B} N={N} C={C} h={h} "
                    f"({C // h} channels a head): max_abs_err={err:.3e} tol=atol {t[0]:g} + "
                    f"rtol {t[1]:g}·|twin| {'ok' if ok else 'FAIL'}")
                check(ok, f"{name} {part} disagrees with its twin at {label} {dtype}")
            log(f"kernel global_attention_fwd/bwd {str(dtype):14s} {label}: two calls of each "
                f"bit-identical: {same}")
            check(same, f"two K12 calls differ at {label} {dtype}")
            del o, p, o2, p2, ro, rp, got, again, want
    torch.cuda.empty_cache()
    return errors


def phase_models_k12_times(ga, device, card):
    """K12's bf16 forward (P emitted) and stored-P backward at
    ``K12_MODEL_SHAPES`` against the twins, the bound and the same run's
    SDPA call. Returns the times."""
    import torch

    times = {}
    for label, (B, N, C, h) in K12_MODEL_SHAPES.items():
        (q, k, v), do, _, _, _ = k12_inputs(B, N, C, h, False, False, False, torch.bfloat16,
                                            device, seed=N + C)
        _, p = ga.global_attention_fwd(q, k, v, None, None, None, h, emit_p=True)
        shape = f"{label} B={B} N={N} C={C} h={h} no extras"
        times[("global_attention_fwd", label)] = time_record(
            card, "global_attention_fwd", f"{shape}, P emitted",
            lambda: ga.global_attention_fwd(q, k, v, None, None, None, h, True),  # noqa: B023
            lambda: ga.attention_core_plain(q, k, v, None, None, None, h),  # noqa: B023
            K12_KERNELS["global_attention_fwd"],
            k12_bound(B, N, C, h, 2, "fwd", bias=False), sdpa_fwd_ms(q, k, v, None, h))
        times[("global_attention_bwd", label)] = time_record(
            card, "global_attention_bwd", shape,
            lambda: ga.global_attention_bwd(q, k, v, do, p, None, h, False),  # noqa: B023
            lambda: ga.attention_core_bwd_plain(q, k, v, do, p, None, h, False),  # noqa: B023
            K12_KERNELS["global_attention_bwd"][:2],
            k12_bound(B, N, C, h, 2, "bwd", grad_bias=False), sdpa_times(q, k, v, do, None, h)[1])
        del q, k, v, do, p
    torch.cuda.empty_cache()
    return times


def phase_models_fusion_times(fk, device, card):
    """K1-K4 in bf16 at the batching buckets 2 and 4 (K4 at Vd = 512): per
    call against the twin and the same function as PyTorch calls it (CUDA
    events, in turns), their device times (torch.profiler) and the bound."""
    import torch

    gen = torch.Generator().manual_seed(11)
    n1, n2, n3 = K3_HEAD
    products = {"seq1_attention": [(512, 512)] * 2, "gated_residual_seq1": [(512, 512)] * 3,
                K3: [(K3_WIDTHS[0], n1), (n1, n2), (n2, n3)], K4: [(K4_DU, 512)] * 2}
    times = {}
    for name in KERNELS:
        kernel, twin = getattr(fk, name), getattr(fk, name + "_plain")
        for B in (2, 4):
            args = kernel_args(name, B, torch.bfloat16, device, gen, vd=512)
            kern, plain = (lambda: kernel(*args)), (lambda: twin(*args))  # noqa: B023
            lib = fusion_library(name, args)
            t = [time_ms(plain), time_ms(kern), time_ms(lib), time_ms(lib), time_ms(kern),
                 time_ms(plain)]
            ms, plain_ms, lib_ms = (t[1] + t[4]) / 2, (t[0] + t[5]) / 2, (t[2] + t[3]) / 2
            bound = matmul_bound_ms(args, plain(), products[name], B)
            dev_k = kernel_device_us(kern, [KERNEL_NAMES[name]])
            dev_t, _ = device_us(plain)
            dev_l, _ = device_us(lib)
            times[(name, B)] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound,
                                    device_us=dev_k, library_device_us=dev_l)
            log(f"[{card}] time {name:20s} bf16 B={B} (a batching bucket) per call: kernel "
                f"{ms * 1e3:8.2f} us  twin {plain_ms * 1e3:8.2f} us  library "
                f"{lib_ms * 1e3:8.2f} us (CUDA events over 200 calls each, in turns, L2-warm); "
                f"device time: kernel {us(dev_k)}  twin {dev_t:8.2f} us  library {dev_l:8.2f} us "
                f"(torch.profiler); bound {bound * 1e3:.2f} us; {against(ms, bound, lib_ms)}")
    return times


def phase_tab(ak, ga, device, card):
    """The flagship (ResNet-50, RG-ATT) with TabTransformer (``TAB_TOWER``)
    over a PAD-UFES-20-like table (``TAB_ROWS`` rows) as a ``TabularSource``:
    10 train steps on one batch of B=128 (the loss falls; K5 once a step, no
    K12: the tower's attention dropout 0.3 takes the plain path in train
    mode); ``train_process`` for two epochs at B=128 on the card; the eval
    forward at B=128, K12 once a transformer layer. Returns K12's launches
    over that eval forward."""
    import tempfile

    import numpy as np
    import torch

    from skinjax_torch import FLAGSHIP
    from skinjax_torch.data.sampling import compute_class_weights
    from skinjax_torch.models import MultimodalModel
    from skinjax_torch.models.weights import init_weights
    from skinjax_torch.train.kfold import SubsetSource
    from skinjax_torch.train.loop import TrainConfig, build_state, train_process
    from skinjax_torch.train.steps import make_eval_step

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        prep, src = tab_dataset(tmp)
    n_cat = len(prep.featurizer.categorical_cols)
    check(n_cat == TAB_COLUMNS, f"PAD-UFES-20's table has {n_cat} categorical columns, not "
                                f"{TAB_COLUMNS}")

    def model():
        return init_weights(MultimodalModel(
            **dict(FLAGSHIP, num_classes=prep.num_classes), text_module=tab_tower(prep),
            text_input_mode="tabular", dtype=torch.bfloat16), seed=0)

    cfg = TrainConfig(device=str(device), learning_rate=TRAIN_LR, batch_size=TRAIN_B,
                      num_epochs=2)
    state = build_state(model(), cfg)
    batch = batch_of(src, TRAIN_B, device)
    cw = torch.as_tensor(compute_class_weights(src.labels, prep.num_classes)).to(device)
    launches = falls([ak, ga], f"flagship+TabTransformer B={TRAIN_B} (N={n_cat} columns, "
                               f"{TAB_TOWER['embed_dim']} wide, {TAB_TOWER['num_heads']} heads)",
                     state, batch, cw)
    check(launches == {K5: 10, **{name: 0 for name in K12}},
          f"the tabular train steps launched {launches}")
    path_times(card, "flagship+TabTransformer", state, batch, cw, K12_NAMES)
    _, metrics, history = train_process(model(), SubsetSource(src, np.arange(TAB_ROWS - 64)),
                                        SubsetSource(src, np.arange(TAB_ROWS - 64, TAB_ROWS)),
                                        prep.num_classes, config=cfg)
    log(f"train flagship+TabTransformer train_process ({TAB_ROWS - 64} rows, B={TRAIN_B}, 2 "
        f"epochs): train losses {history['train_loss']}, val losses {history['val_loss']}, "
        f"balanced accuracy {metrics['balanced_accuracy']:.4f}")
    check(all(math.isfinite(x) for x in history["train_loss"] + history["val_loss"]),
          "train_process on the tabular source gave a non-finite loss")
    ga.reset_launches()
    logits = make_eval_step(torch.bfloat16)(state, batch["image"], batch["metadata"])
    torch.cuda.synchronize()
    fwd = dict(ga.LAUNCHES)
    log(f"eval flagship+TabTransformer B={TRAIN_B}: logits {tuple(logits.shape)} finite "
        f"{bool(torch.isfinite(logits).all())}; K12 launches {fwd} (expected "
        f"{TAB_TOWER['num_layers']} forwards, one a layer); {time.perf_counter() - t0:.1f} s")
    check(bool(torch.isfinite(logits).all()), "non-finite tabular logits")
    check(fwd == {"global_attention_fwd": TAB_TOWER["num_layers"], "global_attention_bwd": 0,
                  K12_RECOMPUTE: 0}, f"the tabular eval forward launched {fwd}")
    return fwd


def phase_static(fk, ak, device, card):
    """The flagship with the static-embedding tower: a synthetic model2vec
    artifact (a random ``STATIC_DIM``-wide table over a WordPiece
    ``vocab.txt`` of the table's sentences) written and read back; the
    sentences encoded; 10 train steps on one batch of B=128 (the loss falls);
    then served through ``InferenceEngine.predict_probs`` at B=1 and 4, the
    fused route (K1-K3) against the plain one within BF16_TOL. Returns the
    fusion kernels' launches over the fused forwards."""
    import tempfile

    import numpy as np
    import torch

    from skinjax_torch import FLAGSHIP
    from skinjax_torch.data.fixtures import (
        pad_ufes20_table,
        row_sentences,
        write_model2vec,
        write_wordpiece_vocab,
    )
    from skinjax_torch.data.pipeline import ArraySource
    from skinjax_torch.data.sampling import compute_class_weights
    from skinjax_torch.models.text.static_embed import load_model2vec
    from skinjax_torch.serve.engine import InferenceEngine
    from skinjax_torch.train.loop import TrainConfig, build_state

    t0 = time.perf_counter()
    table = pad_ufes20_table(TAB_ROWS, seed=1)
    sentences = row_sentences(table)
    with tempfile.TemporaryDirectory() as tmp:
        n = write_wordpiece_vocab(os.path.join(tmp, "vocab.txt"), sentences)
        vocab = Path(tmp, "vocab.txt").read_text().splitlines()
        table_emb = np.random.default_rng(2).normal(size=(n, STATIC_DIM)).astype(np.float32)
        write_model2vec(tmp, table_emb, vocab, normalize=True)
        emb = load_model2vec(tmp).encode(sentences)
    norms = np.linalg.norm(emb, axis=1)
    log(f"static model2vec artifact ({n} tokens × {STATIC_DIM}): {len(sentences)} sentences "
        f"encoded, norms {norms.min():.6f}..{norms.max():.6f}")
    check(np.isfinite(emb).all() and np.allclose(norms, 1.0, atol=1e-5),
          "the static sentence vectors are not unit vectors")
    rng = np.random.default_rng(3)
    labels = rng.integers(0, 6, TAB_ROWS).astype(np.int32)
    images = rng.integers(0, 200, (TAB_ROWS, TRAIN_HW, TRAIN_HW, 3), dtype=np.uint8)
    images += (10 * labels).astype(np.uint8)[:, None, None, None]
    src = ArraySource(images, emb, labels)
    config = dict(FLAGSHIP, text_model_name="static-embedding", vocab_size=STATIC_DIM)
    state = build_state(smoke_model(config, torch.bfloat16),
                        TrainConfig(device=str(device), learning_rate=TRAIN_LR))
    cw = torch.as_tensor(compute_class_weights(labels, 6)).to(device)
    batch = batch_of(src, TRAIN_B, device)
    launches = falls([ak], f"flagship+static-embedding B={TRAIN_B} ({STATIC_DIM}-wide vectors)",
                     state, batch, cw)
    check(launches == {K5: 10}, f"the static-embedding train steps launched {launches}")
    path_times(card, "flagship+static-embedding", state, batch, cw)
    model = state.model
    fused = InferenceEngine(model, use_fused=True, device=device)
    plain = InferenceEngine(model, use_fused=False, device=device)
    check(fused.fused and model.text_tower.fc0.in_features == STATIC_DIM,
          "the static-embedding engine is not on the fused route")
    fk.reset_launches()
    for B in (1, 4):
        got = fused.predict_probs(images[:B], emb[:B])
        want = plain.predict_probs(images[:B], emb[:B])
        err = float(np.abs(got - want).max())
        log(f"[{card}] serve flagship+static-embedding B={B}: fused against plain max_abs_err "
            f"{err:.3e} (tol {BF16_TOL[0]:g}), rows sum to 1: "
            f"{bool(np.allclose(got.sum(1), 1, atol=1e-4))}")
        check(err <= BF16_TOL[0] and np.allclose(got.sum(1), 1, atol=1e-4),
              f"the static-embedding engine's fused route disagrees at B={B}")
    served = dict(fk.LAUNCHES)
    engine_latency(fused, plain, "flagship+static-embedding", card, batches=(1,), n=20,
                   profile=False)
    expect = {k: 2 * v for k, v in PER_FORWARD.items()}
    log(f"serve flagship+static-embedding: fusion kernel launches {served} over 2 fused "
        f"forwards (expected {expect}); {time.perf_counter() - t0:.1f} s")
    check(served == expect, f"the static-embedding forwards launched {served}")
    _SMOKE_MODELS.clear()
    return served


def phase_sequence(ak, ga, device, card):
    """``SequenceFusionModel`` (``SEQUENCE``: ViT-small tokens, common_dim
    512, 8 heads, 4 metadata tokens) at B=64: the eval forward (K12 on the
    tower's 12 blocks and the two self-attentions, 197 and 4 tokens; the
    cross-attentions plain) and 10 train steps on one batch (the loss falls;
    K12 14 + 14 a step, K5 once)."""
    import torch

    from skinjax_torch.models.fusion.sequence import SequenceFusionModel
    from skinjax_torch.models.weights import init_weights
    from skinjax_torch.train.loop import TrainConfig, build_state
    from skinjax_torch.train.steps import make_eval_step

    t0 = time.perf_counter()
    model = init_weights(SequenceFusionModel(**SEQUENCE, dtype=torch.bfloat16), seed=0)
    state = build_state(model, TrainConfig(device=str(device), learning_rate=TOWER_TRAIN_LR))
    batch, cw = train_batch(device, B=SEQUENCE_BATCH)
    ga.reset_launches()
    logits = make_eval_step(torch.bfloat16)(state, batch["image"], batch["metadata"])
    torch.cuda.synchronize()
    fwd = dict(ga.LAUNCHES)
    log(f"eval sequence fusion (vit_small tokens, B={SEQUENCE_BATCH}): logits "
        f"{tuple(logits.shape)} finite {bool(torch.isfinite(logits).all())}; K12 launches {fwd}")
    check(bool(torch.isfinite(logits).all()) and tuple(logits.shape) == (SEQUENCE_BATCH, 6),
          "bad sequence-fusion logits")
    check(fwd == {"global_attention_fwd": SEQ_K12_PER_FORWARD, "global_attention_bwd": 0,
                  K12_RECOMPUTE: 0}, f"the sequence-fusion forward launched {fwd}")
    launches = falls([ak, ga], f"sequence fusion B={SEQUENCE_BATCH} (lr {TOWER_TRAIN_LR:g})",
                     state, batch, cw)
    expect = {K5: 10, "global_attention_fwd": 10 * SEQ_K12_PER_FORWARD,
              "global_attention_bwd": 10 * SEQ_K12_PER_FORWARD, K12_RECOMPUTE: 0}
    check(launches == expect, f"the sequence-fusion steps launched {launches}, not {expect}")
    path_times(card, "sequence fusion", state, batch, cw, K12_NAMES)
    log(f"phase sequence: {time.perf_counter() - t0:.1f} s (host clock)")


def baseline_cli(card, root):
    """The three baselines through the train CLI at once, one process each
    (``--model-name`` mdnet / liwterm / metanet with their ``BASELINES``
    tower and batch, 2 folds, 1 epoch) on a PAD-UFES-20-like dataset of
    ``BASELINE_ROWS`` rows (64×64 PNGs, resized to 224×224 as they are
    read): each exits 0 with two finite fold results and its checkpoints."""
    import csv
    import re

    from skinjax_torch.data.fixtures import write_pad_ufes20_like

    csv_path, images = write_pad_ufes20_like(os.path.join(root, "data"), n=BASELINE_ROWS,
                                             image_hw=(64, 64), seed=0, paeth=False)
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (here, os.environ.get("PYTHONPATH")) if p))
    procs = {}
    t0 = time.perf_counter()
    try:
        for name, (cnn, B, _) in BASELINES.items():
            cmd = [sys.executable, "-m", "skinjax_torch.tools.train_cli", "--dataset",
                   "pad-ufes-20", "--metadata-csv", csv_path, "--images-dir", images,
                   "--results-dir", os.path.join(root, name), "--model-name", name,
                   "--backbones", cnn, "--k-folds", "2", "--epochs", "1", "--batch-size", str(B)]
            procs[name] = subprocess.Popen(cmd, cwd=here, env=env, stdout=subprocess.PIPE,
                                           stderr=subprocess.PIPE, text=True)
        outs = {name: p.communicate(timeout=600) for name, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for name, (cnn, B, _) in BASELINES.items():
        out, err = outs[name]
        if procs[name].returncode != 0 or "failed:" in out:
            log(out[-3000:] + err[-6000:])
        check(procs[name].returncode == 0, f"train_cli --model-name {name} exited "
                                           f"{procs[name].returncode}")
        check("failed:" not in out, f"a cell of the {name} sweep failed")
        found = re.search(r'"n_runs": (\d+)', out)
        cell = os.path.join(root, name, f"{name}_{cnn}_concatenation_h8")
        with open(os.path.join(cell, "model_metrics.csv")) as f:
            rows = list(csv.DictReader(f))
        log(f"[{card}] cli --model-name {name} --backbones {cnn} --batch-size {B}: n_runs "
            f"{found.group(1) if found else None}, balanced accuracy/auc per fold "
            + ", ".join(f"{r['balanced_accuracy'][:6]}/{r['auc'][:6]}" for r in rows))
        check(found is not None and int(found.group(1)) == 2, f"{name}: not two fold results")
        check(len(rows) == 2 and all(math.isfinite(float(r["balanced_accuracy"])) for r in rows),
              f"{name}: model_metrics.csv lacks two finite folds")
        check(all(os.path.isfile(os.path.join(cell, f"{name}_{cnn}_concatenation_h8_fold_{k}",
                                              "best", "state.pt")) for k in (1, 2)),
              f"{name}: a fold checkpoint is missing")
    log(f"[{card}] cli the three baselines at once: {wall:.1f} s wall ({len(BASELINES)} "
        f"processes, {BASELINE_ROWS} PNGs each, 2 folds × 1 epoch)")


def phase_baselines(ak, ga, device, card):
    """MetaNet (ResNet-50, B=128), MD-Net (DenseNet-169, B=64) and LiwTERM
    (ViT-large, B=32) as ``create_model`` builds them for ``--model-name``:
    10 train steps each on one batch (the loss falls; K5 once a step, K12
    24 + 24 a LiwTERM step), then the three through the train CLI."""
    import tempfile

    import torch

    from skinjax_torch.models.factory import create_model
    from skinjax_torch.train.loop import TrainConfig, build_state

    t0 = time.perf_counter()
    for name, (cnn, B, k12) in BASELINES.items():
        model = create_model(num_classes=6, model_name=name, cnn_model_name=cnn, vocab_size=91,
                             dtype=torch.bfloat16, seed=0)
        lr = TOWER_TRAIN_LR if name == "liwterm" else TRAIN_LR
        state = build_state(model, TrainConfig(device=str(device), learning_rate=lr))
        check(all(p.requires_grad for p in state.model.parameters()),
              f"{name}: a parameter is frozen")
        batch, cw = train_batch(device, B=B)
        launches = falls([ak, ga], f"baseline {name} ({cnn}, B={B}, lr {lr:g})", state, batch, cw)
        expect = {K5: 10, "global_attention_fwd": 10 * k12, "global_attention_bwd": 10 * k12,
                  K12_RECOMPUTE: 0}
        check(launches == expect, f"{name}'s steps launched {launches}, not {expect}")
        path_times(card, f"baseline {name} ({cnn})", state, batch, cw, K12_NAMES if k12 else None)
        del model, state, batch
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        baseline_cli(card, tmp)
    log(f"phase baselines: {time.perf_counter() - t0:.1f} s (host clock)")


def phase_batching(fk, card):
    """The service with MAX_BATCH=8 as run_service builds it (the flagship,
    bf16, a featurizer JSON): a ``BatchingEngine`` around the fused engine,
    served on a localhost port; ``BATCH_CLIENTS`` concurrent clients POST
    /predict/. Every answer equals the unbatched engine's within BF16_TOL;
    some forwards batched more than one request; K1-K3 launched their
    per-forward count once a forward (batched or direct). Returns the
    launches."""
    import tempfile
    from http.server import ThreadingHTTPServer

    import numpy as np

    from skinjax_torch.serve import png, run_service
    from skinjax_torch.serve.api import make_handler
    from skinjax_torch.serve.batching import BatchingEngine

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "featurizer.json")
        smoke_featurizer(91).save(path)
        env = {"FEATURIZER_JSON": path, "CNN_MODEL_NAME": "resnet-50", "DEVICE": "cuda",
               "MAX_BATCH": str(MAX_BATCH), "BATCH_WAIT_MS": "20"}
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            batcher = run_service.build_engine()
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
    check(isinstance(batcher, BatchingEngine) and batcher.max_batch == MAX_BATCH
          and batcher.engine.fused, "run_service built no batching engine around a fused one")
    rng = np.random.default_rng(5)
    n_cat = len(batcher.engine.featurizer.categorical_cols)
    requests = []
    for i in range(BATCH_CLIENTS):
        img = rng.integers(0, 256, ((224, 224) if i % 4 else (300, 400)) + (3,), dtype=np.uint8)
        meta = ", ".join([f"v{rng.integers(10)}" for _ in range(n_cat)]
                         + [str(int(rng.integers(20, 90)))])
        requests.append((img, meta))
    batcher.predict(*requests[0])  # warm: each bucket's first forward builds its plans
    handler = make_handler(batcher)
    server = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    url = f"http://127.0.0.1:{server.server_address[1]}/predict/"
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    answers = [None] * BATCH_CLIENTS

    def client(i):
        body, ctype = _multipart(png.encode_png(requests[i][0]), requests[i][1])
        req = urllib.request.Request(url, data=body, headers={"Content-Type": ctype})
        with urllib.request.urlopen(req, timeout=120) as r:
            answers[i] = (r.status, json.loads(r.read()))

    try:
        fk.reset_launches()
        stats0 = dict(batcher.stats)
        t0 = time.perf_counter()
        clients = [threading.Thread(target=client, args=(i,)) for i in range(BATCH_CLIENTS)]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=300)
        wall = time.perf_counter() - t0
        launches = dict(fk.LAUNCHES)
        stats = {k: batcher.stats[k] - stats0[k] for k in stats0}
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
        handler.worker.shutdown(wait=True)
        batcher.shutdown()
    check(not thread.is_alive() and not batcher._worker.is_alive(),
          "the server or the batching worker did not stop")
    check(all(a is not None and a[0] == 200 for a in answers), "a batched request failed")
    worst = 0.0
    for (img, meta), (_, out) in zip(requests, answers):
        direct = np.asarray(batcher.engine.predict(img, meta)["probabilities"])
        worst = max(worst, float(np.abs(np.asarray(out["probabilities"]) - direct).max()))
    forwards = stats["batches"] + stats["direct_requests"]
    expect = {k: v * forwards for k, v in PER_FORWARD.items()}
    log(f"[{card}] serve MAX_BATCH={MAX_BATCH}: {BATCH_CLIENTS} concurrent clients in "
        f"{wall * 1e3:.1f} ms; {stats['batches']} batched forwards holding "
        f"{stats['occupancy_sum']} requests ({stats['batched_requests']} in batches above 1), "
        f"{stats['direct_requests']} direct; the batched forwards took "
        f"{stats['forward_s'] * 1e3:.1f} ms of the worker's time (host clock); worst "
        f"|p - unbatched engine's p| {worst:.3e} (tol "
        f"{BF16_TOL[0]:g}); fusion kernel launches {launches} (expected {expect})")
    check(stats["requests"] == BATCH_CLIENTS, f"{stats['requests']} requests counted")
    check(stats["batched_requests"] > 0, "no forward batched more than one request")
    check(worst <= BF16_TOL[0], "a batched answer differs from the unbatched engine's")
    check(launches == expect, "K1-K3 did not launch once a forward")
    return launches


def build_kernels(build, modules):
    """One nvcc per source, started together (each thread waits in
    subprocess.run); then each module loads its library."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(BUILDS)) as pool:
        list(pool.map(build.build, BUILDS))
    for m in modules:
        m.library()
    log(f"phase build: nvcc {build.find_nvcc()}, {len(BUILDS)} sources at once, "
        f"{time.perf_counter() - t0:.1f} s to build and load")


def phase_k12_split(ga, device, card):
    """The recompute backward at BERT-base T=512 (B=32, bf16) with kmask +
    pmult, kmask alone and neither: per call (CUDA events) and each kernel's
    device time (torch.profiler), what the staged planes cost."""
    import torch

    B, N, C, h, _, _, _ = K12_SHAPES["bert-base-T512"]
    (q, k, v), do, _, km, pm = k12_inputs(B, N, C, h, False, True, True, torch.bfloat16, device,
                                          seed=37)
    for label, kmx, pmx in (("kmask+pmult", km, pm), ("kmask", km, None), ("neither", None, None)):
        def call(kmx=kmx, pmx=pmx):
            return ga.global_attention_bwd_recompute(q, k, v, do, None, kmx, pmx, h, False)

        ms = time_ms(call, 10, 2)
        _, by_name = device_us(call, n=5)
        split = "; ".join(f"{name} {by_name_us:.2f} us" for name in K12_KERNELS[K12_RECOMPUTE]
                          for key, by_name_us in by_name.items() if name in key)
        log(f"[{card}] time {K12_RECOMPUTE} bf16 bert-base-T512 B={B} {label}: "
            f"{ms * 1e3:.2f} us per call (CUDA events); device time {split} (torch.profiler)")


def phase_bwd_p_split(ga, pa, device, card):
    """The bf16 stored-P backwards split by kernel (torch.profiler device
    time): K12 at BEiT-large's shape with its bias gradient at the wrapper's
    group count and at others, and without a bias gradient; K11 at
    MViTv2-small's stage 0 and stage 2."""
    import torch

    from skinjax_torch import MVIT_BATCH

    def split(call, names):
        ms = time_ms(call, 10, 2)
        _, by_name = device_us(call, n=5)
        return ms, "; ".join(f"{name} {t:.2f} us" for name in names
                             for key, t in by_name.items() if name in key)

    B, N, C, h, _, _, _ = K12_SHAPES["beitv2-large"]
    (q, k, v), do, b, _, _ = k12_inputs(B, N, C, h, True, False, False, torch.bfloat16, device,
                                         seed=31)
    _, p = ga.global_attention_fwd(q, k, v, b, None, None, h, emit_p=True)
    groups = ga.stored_p_groups
    cases = [(f"bias, {groups(B, N, h)} groups (the wrapper's)", True, None)]
    cases += [(f"bias, {n} groups", True, n) for n in (1, 2, 4, 8, 16, 32)
              if n != groups(B, N, h)]
    cases.append(("no bias gradient", False, None))
    for label, grad_bias, n in cases:
        ga.stored_p_groups = groups if n is None else (lambda *_, n=n: n)
        try:
            ms, by = split(lambda g=grad_bias: ga.global_attention_bwd(q, k, v, do, p, None, h, g),
                           K12_KERNELS["global_attention_bwd"])
        finally:
            ga.stored_p_groups = groups
        log(f"[{card}] time global_attention_bwd bf16 beitv2-large B={B} {label}: "
            f"{ms * 1e3:.2f} us per call (CUDA events); device time {by} (torch.profiler)")
    del q, k, v, do, b, p
    for label in ("stage0", "stage2"):
        hh, Nq, k_size, _ = K11_SHAPES[label]
        q, k, v, bh, bw, do = k11_inputs(MVIT_BATCH, hh, Nq, k_size, torch.bfloat16, device,
                                         seed=41)
        _, p = pa.pooled_attention_fwd(q, k, v, bh, bw, k_size, emit_p=True)
        ms, by = split(lambda: pa.pooled_attention_bwd(q, k, v, do, p, k_size),  # noqa: B023
                       K11_KERNELS["pooled_attention_bwd"])
        log(f"[{card}] time pooled_attention_bwd bf16 {label} B={MVIT_BATCH}: {ms * 1e3:.2f} us "
            f"per call (CUDA events); device time {by} (torch.profiler)")
        del q, k, v, bh, bw, do, p
    torch.cuda.empty_cache()


def log_ptxas(build, names):
    """What ptxas said of each kernel of the named sources: registers, spills."""
    for name in names:
        for line in build.build_info[name]["log"].splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"  ptxas: {line.strip()}")


def log_spills(build, name, kernel):
    """ptxas's stack frame and spills of each instantiation of ``kernel`` in
    source ``name``'s build log, one line an instantiation."""
    entry = None
    for line in build.build_info[name]["log"].splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1] if "'" in line else line.strip()
        elif entry and kernel in entry and "spill" in line:
            log(f"  ptxas {kernel} ({entry}): {line.strip()}")


def fusion_only() -> int:
    """``--fusion``: K1-K5's checks and times alone, with the flagship served
    and trained and the engine's and augment stage's A/Bs."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing to run", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from skinjax_torch.ops import augment_kernel as ak
    from skinjax_torch.ops import build
    from skinjax_torch.ops import fusion_kernels as fk

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    card = card_line()
    log(card)
    names = ("fusion_kernels", "augment_kernel")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        list(pool.map(build.build, names))
    for m in (fk, ak):
        m.library()
    log(f"phase build: {len(names)} sources at once, {time.perf_counter() - t0:.1f} s")
    log_ptxas(build, names)
    log_spills(build, "fusion_kernels", KERNEL_NAMES[K3])
    phase_kernels(fk, device)
    for name in ROUTE_WIDTHS:
        phase_routes(fk, device, name)
    phase_k5(ak, device)
    phase_kernel_times(fk, device, card)
    phase_k4_times(fk, device, card)
    fused, plain = phase_slice(fk, device, card, fp32=False)
    engine_latency(fused, plain, "flagship", card)
    del fused, plain
    batch, _, _, _ = phase_train([ak], device, card)
    phase_k5_times(ak, device, card, batch)
    torch.cuda.synchronize()
    print(json.dumps({"ok": True, "fusion": True}), flush=True)
    return 0


def mlp_only() -> int:
    """``--mlp``: the fused-MLP kernels' checks and times alone."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing to run", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from skinjax_torch.ops import build
    from skinjax_torch.ops import fused_mlp as fm

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    card = card_line()
    log(card)
    t0 = time.perf_counter()
    fm.library()
    log(f"phase build: fused_mlp, {time.perf_counter() - t0:.1f} s")
    log_ptxas(build, ("fused_mlp",))
    errors = phase_mlp(fm, device)
    phase_mlp_same_bits(fm, device)
    phase_mlp_times(fm, device, card, errors)
    torch.cuda.synchronize()
    print(json.dumps({"ok": True, "mlp": True}), flush=True)
    return 0


def k8_only() -> int:
    """``--k8``: K8's checks and times alone."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing to run", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from skinjax_torch.ops import build
    from skinjax_torch.ops import channel_attention as ca

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    card = card_line()
    log(card)
    t0 = time.perf_counter()
    ca.library()
    log(f"phase build: channel_attention, {time.perf_counter() - t0:.1f} s")
    log_ptxas(build, ("channel_attention",))
    phase_k8(ca, device)
    phase_k8_times(ca, device, card)
    torch.cuda.synchronize()
    print(json.dumps({"ok": True, "k8": True}), flush=True)
    return 0


def attention_only() -> int:
    """``--attention``: the attention kernels' checks and times alone."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing to run", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from skinjax_torch.ops import build
    from skinjax_torch.ops import global_attention as ga
    from skinjax_torch.ops import pooled_attention as pa
    from skinjax_torch.ops import window_attention as wa

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    card = card_line()
    log(card)
    names = ("window_attention", "global_attention", "pooled_attention")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        list(pool.map(build.build, names))
    for m in (wa, ga, pa):
        m.library()
    log(f"phase build: {len(names)} sources at once, {time.perf_counter() - t0:.1f} s")
    log_ptxas(build, names)
    phase_k7(wa, device)
    phase_k12(ga, device)
    phase_k11(pa, device)
    phase_k7pad(wa, ga, device)
    phase_k12_split(ga, device, card)
    phase_bwd_p_split(ga, pa, device, card)
    phase_k12_times(ga, device, card)
    phase_k11_times(pa, device, card)
    phase_k7_times(wa, device, card)
    phase_k7pad_times(wa, ga, device, card)
    torch.cuda.synchronize()
    print(json.dumps({"ok": True, "attention": True}), flush=True)
    return 0


def phase_models(fk, ak, ga, device, card):
    """This slice's paths at full width: TabTransformer, static-embedding,
    sequence fusion, the baselines, the batching service and the card
    against the CPU for a small tabular model and a small MetaNet."""
    import torch

    start = time.perf_counter()

    def elapsed(label):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        log(f"elapsed in this slice's paths after {label}: {time.perf_counter() - start:.1f} s "
            f"(host clock)")

    phase_tab(ak, ga, device, card)
    elapsed("TabTransformer")
    phase_static(fk, ak, device, card)
    elapsed("static-embedding")
    phase_sequence(ak, ga, device, card)
    elapsed("sequence fusion")
    phase_baselines(ak, ga, device, card)
    elapsed("the baselines")
    phase_batching(fk, card)
    elapsed("the batching service")
    phase_card_vs_cpu(device, tabular=True)
    phase_card_vs_cpu(device, cnn="resnet-18", baseline="metanet")
    elapsed("card against CPU")


def models_only() -> int:
    """``--models``: this slice's paths alone (TabTransformer, static
    embedding, sequence fusion, the baselines, the batching service), with
    K12's checks and times at their shapes and K1-K4's at the batching
    buckets."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing to run", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from skinjax_torch.ops import augment_kernel as ak
    from skinjax_torch.ops import build
    from skinjax_torch.ops import fusion_kernels as fk
    from skinjax_torch.ops import global_attention as ga

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    card = card_line()
    log(card)
    names = ("fusion_kernels", "augment_kernel", "global_attention")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        list(pool.map(build.build, names))
    for m in (fk, ak, ga):
        m.library()
    log(f"phase build: {len(names)} sources at once, {time.perf_counter() - t0:.1f} s")
    for name in ROUTE_WIDTHS:
        phase_routes(fk, device, name, batches=(2, 4))
    phase_models_k12(ga, device)
    phase_models_k12_times(ga, device, card)
    phase_models_fusion_times(fk, device, card)
    log(f"phase models kernels: {time.perf_counter() - t0:.1f} s (host clock)")
    phase_models(fk, ak, ga, device, card)
    torch.cuda.synchronize()
    print(json.dumps({"ok": True, "models": True}), flush=True)
    return 0


# ---------------------------------------------------------------------------
# the XAI slice
# ---------------------------------------------------------------------------

# Grad-CAM and Grad-CAM++ at B=2 on four towers around the flagship's fusion
# (RG-ATT, one-hot metadata, common_dim 512), 224×224, random weights from
# seed 0: the tower and the kernels its CAM must launch
XAI_TOWERS = {"flagship": "resnet-50", "vit-base": "vit_base_patch16_224",
              "coat-lite-small": "coat_lite_small", "davit-tiny": "davit_tiny"}
XAI_B = 2
XAI_CLASSES = (1, 4)
# the card's fp32 maps against the CPU's, both in [0, 1]: skinjax's own
# tolerance for its maps against a PyTorch oracle (tests/test_cam_parity.py)
XAI_MAP_TOL = 2e-3
# bf16 under autocast against the card's fp32, each map: its mean absolute
# difference and its correlation. The largest difference is printed, not
# held: a map is Σ_c w_c·A_c min-max-normed, and at random weights the sum
# cancels, so the grid's and its gradient's bf16 errors (a CPU probe at these
# towers: 0.6–21% of A's norm, 5–38% of g's) move single pixels by up to the
# map's whole range (DaViT-tiny's Grad-CAM++ 0.99) while the map keeps its
# pattern (correlation ≥ 0.77, mean ≤ 0.075 there)
XAI_BF16_MEAN_TOL = 0.15
XAI_BF16_MIN_CORR = 0.5
# Score-CAM on the flagship at B=1: its masked images go through the model
# this many channels a forward; the exact sweep is 2048 channels
XAI_SCORE_CHANNELS = 128
XAI_TOP_K = 64
XAI_APP_REQUESTS = ((224, 224), (224, 224), (300, 400))
XAI_SWEEP_ROWS = 2298  # PAD-UFES-20's size
XAI_SWEEP_FOLDS = 5
XAI_SWEEP_BATCH = 64
REFERENCE_SWEEP = ("~30–75 min total (5 folds × 6 missing rates), ~5–15 min a fold, on one "
                   "CUDA GPU: the reference's own figure (BASELINE.md:22), not measured here")


def xai_expected(label, modules):
    """{kernel: launches} during one Grad-CAM of the tower: ViT-base's CLS
    delta enters its last block, so K12 runs 12 forwards (1 emitting P) and
    1 stored-P backward; CoaT's enters its last serial block, so K9 runs 16
    forwards and 1 backward; DaViT's follows the stages, so K7 runs forwards
    only; nothing runs K1-K4 (the CAM runs the model's modules)."""
    expect = {k: 0 for m in modules for k in m.LAUNCHES}
    if label == "vit-base":
        expect.update(global_attention_fwd=12, global_attention_bwd=1)
    elif label == "coat-lite-small":
        expect.update(mlp_gelu_fwd=K9_PER_FORWARD, mlp_gelu_bwd=1)
    elif label == "davit-tiny":
        expect.update(window_attention_fwd=K7_PER_FORWARD)
    return expect


@contextlib.contextmanager
def counting_p(ga):
    """The K12 forwards that emit P, counted while the block runs."""
    forward, emitted = ga.global_attention_fwd, []

    def spy(*args, **kwargs):
        o, p = forward(*args, **kwargs)
        emitted.append(p is not None and o.is_cuda)
        return o, p

    ga.global_attention_fwd = spy
    try:
        yield emitted
    finally:
        ga.global_attention_fwd = forward


def xai_inputs(B, seed):
    """Normalized images (B, 224, 224, 3) and metadata (B, 91), fp32."""
    import numpy as np

    from skinjax_torch import FLAGSHIP

    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, 224, 224, 3)).astype(np.float32),
            rng.normal(size=(B, FLAGSHIP["vocab_size"])).astype(np.float32))


def synced_ms(fn):
    """(fn(), its milliseconds on the host clock up to the card's end)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def phase_xai_cams(modules, device, card):
    """Grad-CAM and Grad-CAM++ on each of XAI_TOWERS: fp32 on the card (the
    fp32 kernels) against the CPU (their twins) within XAI_MAP_TOL; bf16
    under autocast against the card's fp32 within XAI_BF16_TOL; the
    launches during one fp32 Grad-CAM (``xai_expected``). Returns the
    launches summed over the towers."""
    import copy

    import numpy as np
    import torch

    from skinjax_torch import FLAGSHIP
    from skinjax_torch.xai import grad_cam, grad_cam_pp

    ga = modules[2]
    total = {}
    img, meta = xai_inputs(XAI_B, seed=0)
    for label, tower in XAI_TOWERS.items():
        cpu_model = smoke_model(dict(FLAGSHIP, cnn_model_name=tower), None).eval()
        model = copy.deepcopy(cpu_model).to(device)
        x, m = torch.from_numpy(img).to(device), torch.from_numpy(meta).to(device)
        grad_cam(model, x, m, XAI_CLASSES)  # the first call builds cuDNN's plans
        for mod in modules:
            mod.reset_launches()
        with counting_p(ga) as emitted:
            cam, cam_ms = synced_ms(lambda: grad_cam(model, x, m, XAI_CLASSES))
        launches = {k: v for mod in modules for k, v in mod.LAUNCHES.items()}
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        expect = xai_expected(label, modules)
        log(f"xai {label} one Grad-CAM's launches: {launches}, K12 forwards emitting P "
            f"{sum(emitted)} (expected {expect}, P {int(label == 'vit-base')})")
        check(launches == expect and sum(emitted) == int(label == "vit-base"),
              f"{label}'s Grad-CAM did not run its kernels as expected")
        pp, pp_ms = synced_ms(lambda: grad_cam_pp(model, x, m, XAI_CLASSES))
        t0 = time.perf_counter()
        ref = grad_cam(cpu_model, torch.from_numpy(img), torch.from_numpy(meta), XAI_CLASSES)
        ref_pp = grad_cam_pp(cpu_model, torch.from_numpy(img), torch.from_numpy(meta),
                             XAI_CLASSES)
        cpu_s = time.perf_counter() - t0
        err = max(float((cam.cpu() - ref).abs().max()), float((pp.cpu() - ref_pp).abs().max()))
        model.dtype = torch.bfloat16
        grad_cam(model, x, m, XAI_CLASSES)  # bf16's first call builds its plans
        bf, bf_ms = synced_ms(lambda: grad_cam(model, x, m, XAI_CLASSES))
        bf_pp = grad_cam_pp(model, x, m, XAI_CLASSES)
        maps = torch.stack([cam, pp, bf, bf_pp]).cpu().numpy()
        diffs = np.abs(maps[2:] - maps[:2])  # (Grad-CAM, Grad-CAM++)
        bf_max, bf_mean = diffs.reshape(2, -1).max(1), diffs.reshape(2, -1).mean(1)
        bf_corr = [float(np.corrcoef(maps[i].ravel(), maps[i + 2].ravel())[0, 1])
                   for i in range(2)]
        log(f"[{card}] xai {label} Grad-CAM B={XAI_B} 224x224: fp32 {cam_ms:.1f} ms, bf16 "
            f"{bf_ms:.1f} ms, Grad-CAM++ fp32 {pp_ms:.1f} ms (host clock, synchronized); "
            f"card fp32 vs CPU max_abs_err {err:.3e} (tol {XAI_MAP_TOL:g}; the CPU's pair "
            f"{cpu_s:.1f} s); bf16 vs fp32, Grad-CAM / ++: max {bf_max[0]:.3e} / "
            f"{bf_max[1]:.3e} (printed), mean {bf_mean[0]:.3e} / {bf_mean[1]:.3e} (tol "
            f"{XAI_BF16_MEAN_TOL:g}), correlation {bf_corr[0]:.4f} / {bf_corr[1]:.4f} (at least "
            f"{XAI_BF16_MIN_CORR:g})")
        check(maps.shape == (4, XAI_B, 224, 224) and np.isfinite(maps).all()
              and maps.min() >= 0 and maps.max() <= 1 and float(ref.std()) > 0,
              f"{label}'s maps are not finite (B, 224, 224) maps in [0, 1]")
        check(err <= XAI_MAP_TOL, f"{label}'s CAM on the card disagrees with the CPU")
        check(bf_mean.max() <= XAI_BF16_MEAN_TOL and min(bf_corr) >= XAI_BF16_MIN_CORR,
              f"{label}'s bf16 CAM is too far from fp32")
        check(all(p.requires_grad and p.grad is None for p in model.parameters()),
              "a CAM left a parameter frozen or a .grad behind")
        del model, cpu_model
        _SMOKE_MODELS.clear()
        torch.cuda.empty_cache()
    return total


def phase_xai_score_cam(device, card):
    """Score-CAM on the flagship at B=1, fp32: the exact sweep (2048
    channels, XAI_SCORE_CHANNELS masked images a forward) and top-64 on the
    card, top-64 on the CPU against the card's."""
    import numpy as np
    import torch

    from skinjax_torch import FLAGSHIP
    from skinjax_torch.xai import score_cam

    cpu_model = smoke_model(FLAGSHIP, None).eval()
    model = smoke_model(FLAGSHIP, None).eval().to(device)
    img, meta = xai_inputs(1, seed=1)
    x, m = torch.from_numpy(img).to(device), torch.from_numpy(meta).to(device)
    cls = [2]
    score_cam(model, x, m, cls, top_k=8, batch_channels=8)  # cuDNN's plans
    exact, exact_ms = synced_ms(lambda: score_cam(model, x, m, cls,
                                                  batch_channels=XAI_SCORE_CHANNELS))
    top, top_ms = synced_ms(lambda: score_cam(model, x, m, cls, top_k=XAI_TOP_K,
                                              batch_channels=XAI_TOP_K))
    t0 = time.perf_counter()
    ref = score_cam(cpu_model, torch.from_numpy(img), torch.from_numpy(meta), cls,
                    top_k=XAI_TOP_K, batch_channels=XAI_TOP_K)
    cpu_s = time.perf_counter() - t0
    err = float((top.cpu() - ref).abs().max())
    e, t = exact.cpu().numpy().ravel(), top.cpu().numpy().ravel()
    corr = float(np.corrcoef(e, t)[0, 1])
    log(f"[{card}] xai flagship Score-CAM B=1 fp32: exact (2048 channels, "
        f"{2048 // XAI_SCORE_CHANNELS} forwards of {XAI_SCORE_CHANNELS} images) "
        f"{exact_ms:.1f} ms, top-{XAI_TOP_K} (1 forward) {top_ms:.1f} ms (host clock, "
        f"synchronized); top-{XAI_TOP_K} card vs CPU max_abs_err {err:.3e} (tol "
        f"{XAI_MAP_TOL:g}; the CPU's {cpu_s:.1f} s); top-{XAI_TOP_K} vs exact max "
        f"{np.abs(e - t).max():.3e}, correlation {corr:.4f} (skinjax's bound at ResNet-18: "
        "max < 0.25, correlation > 0.9; reported)")
    check(all(np.isfinite(a).all() and a.min() >= 0 and a.max() <= 1 for a in (e, t))
          and e.std() > 0 and exact.shape == (1, 224, 224), "Score-CAM's maps are not right")
    check(err <= XAI_MAP_TOL, "Score-CAM on the card disagrees with the CPU")
    del model, cpu_model
    _SMOKE_MODELS.clear()
    torch.cuda.empty_cache()


def xai_fields(table, row, groups):
    """The app's form fields for a dataset row, with ``groups`` switched on."""
    from skinjax_torch.serve.xai_app import METADATA_GROUPS

    fields = {f: table[f][row] for g in METADATA_GROUPS.values() for f in g if f in table}
    fields.update({f"group_{g}": "on" for g in groups})
    return fields


def phase_xai_app(fk, card, fz_path, table):
    """The XAI app as ``python -m skinjax_torch.serve.run_service`` builds it
    with XAI=1 on the flagship (bf16, random weights from seed 0, the
    PAD-UFES-20 featurizer at ``fz_path``), served on a localhost port: the
    form, a first POST, then three POSTs of a PNG and a row's fields (the
    last with the symptoms group off). Each answer is 200, its prediction engine.predict's
    on the same image and CSV line, its overlay a 224×224×3 PNG; K1/K2/K3
    launch 4/2/1 times a request. Returns the launches."""
    import base64
    import re
    from http.server import ThreadingHTTPServer

    import numpy as np

    from skinjax_torch.serve import png, run_service
    from skinjax_torch.serve.engine import InferenceEngine
    from skinjax_torch.serve.xai_app import METADATA_GROUPS, build_metadata_values
    from skinjax_torch.serve.xai_app import make_xai_handler

    env = {"FEATURIZER_JSON": fz_path, "XAI": "1", "DEVICE": "cuda", "MAX_BATCH": "8"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        engine = run_service.build_engine()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    check(isinstance(engine, InferenceEngine) and engine.fused
          and engine.model.cnn_dim_output == 2048, "run_service built no XAI flagship engine")
    rng = np.random.default_rng(4)
    requests = []
    for i, shape in enumerate(XAI_APP_REQUESTS):
        groups = [g for g in METADATA_GROUPS if i < 2 or g != "symptoms"]
        requests.append((png.encode_png(rng.integers(0, 256, (*shape, 3), dtype=np.uint8)),
                         xai_fields(table, i, groups)))
    handler = make_xai_handler(engine, engine.model)
    server = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    url = f"http://127.0.0.1:{server.server_address[1]}"
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    answers = []
    try:
        with urllib.request.urlopen(url, timeout=60) as r:
            check(r.status == 200 and b'name="group_symptoms"' in r.read(), "no XAI form")
        # a first request builds cuDNN's plans and the kernels' launch state
        body, ctype = xai_form(*requests[0])
        with urllib.request.urlopen(urllib.request.Request(
                f"{url}/analyze", data=body, headers={"Content-Type": ctype}), timeout=300) as r:
            check(r.status == 200, "the XAI app's first request failed")
        fk.reset_launches()
        for data, fields in requests:
            body, ctype = xai_form(data, fields)
            req = urllib.request.Request(f"{url}/analyze", data=body,
                                         headers={"Content-Type": ctype})
            t0 = time.perf_counter()
            with urllib.request.urlopen(req, timeout=300) as r:
                status, page, timing = r.status, r.read().decode(), r.headers["Server-Timing"]
            answers.append((status, page, timing, (time.perf_counter() - t0) * 1e3))
        launches = dict(fk.LAUNCHES)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
        handler.worker.shutdown(wait=True)
    check(not thread.is_alive(), "the XAI server thread did not stop")

    splits = []
    for (data, fields), (status, page, timing, ms) in zip(requests, answers):
        check(status == 200 and "Prediction:" in page, f"the XAI app answered {status}")
        cls = re.search(r"<h3>Prediction: (.*?)</h3>", page).group(1)
        probs = np.array([float(p) for p in re.findall(r"<li>[^<]*: ([0-9.]+)</li>", page)])
        overlay = png.decode_png(base64.b64decode(
            re.search(r'src="data:image/png;base64,([^"]+)"', page).group(1)))
        values = {k: v for k, v in fields.items() if not k.startswith("group_")}
        enabled = [g for g in METADATA_GROUPS if f"group_{g}" in fields]
        direct = engine.predict(png.decode_png(data),
                                build_metadata_values(values, enabled, engine.featurizer))
        err = float(np.abs(probs - np.asarray(direct["probabilities"])).max())
        split = dict(re.findall(r"(\w+);dur=([0-9.]+)", timing))
        splits.append([ms] + [float(split[k]) for k in ("forward", "cam", "encode")])
        log(f"[{card}] xai app POST /analyze ({len(enabled)} groups on): {status} {cls}, "
            f"engine.predict {direct['predicted_classname']}, probabilities |page - engine| "
            f"{err:.2e} (the page's 3 decimals, tol 6e-4), overlay {overlay.shape}; round trip "
            f"{ms:.1f} ms: {timing}")
        check(cls == direct["predicted_classname"] and err <= 6e-4,
              "the XAI app's prediction is not engine.predict's")
        check(overlay.shape == (224, 224, 3), "the overlay is not a 224x224 RGB PNG")
    p50 = np.median(np.array(splits), axis=0)
    log(f"[{card}] xai app latency p50 over {len(splits)} requests (host clock): round trip "
        f"{p50[0]:.1f} ms = forward {p50[1]:.1f} + Grad-CAM++ {p50[2]:.1f} + overlay and PNG "
        f"encode {p50[3]:.1f} ms + HTTP and decode (ResNet-50 + RG-ATT, bf16)")
    n = len(requests)
    expect = {"seq1_attention": 4 * n, "gated_residual_seq1": 2 * n, "metablock_film": 0,
              "mlp_head": n}
    log(f"xai app launches over {n} requests: {launches} (expected {expect})")
    check(launches == expect, "the XAI app's predictions did not run K1-K3 as expected")
    del engine
    return launches


def xai_form(image_bytes, fields):
    boundary = uuid.uuid4().hex
    body = (f"--{boundary}\r\nContent-Disposition: form-data; name=\"file\"; "
            f"filename=\"lesion.png\"\r\nContent-Type: image/png\r\n\r\n").encode() + image_bytes
    for k, v in fields.items():
        body += (f"\r\n--{boundary}\r\nContent-Disposition: form-data; name=\"{k}\"\r\n\r\n"
                 f"{v}").encode()
    return body + f"\r\n--{boundary}--\r\n".encode(), f"multipart/form-data; boundary={boundary}"


def phase_xai_cli(card, csv_path, images, out):
    """``python -m skinjax_torch.tools.xai_cli missing-data`` and
    ``flip-rate`` as two subprocesses at once on the card, on phase 15's
    dataset (CLI_IMAGES rows, 300×400 PNGs; the flagship, random weights from
    seed 0), writing under ``out``: each exits 0; the CSV's six rows and the
    flip rates."""
    import csv

    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p))
    procs = {}
    t0 = time.perf_counter()
    for analysis in ("missing-data", "flip-rate"):
        cmd = [sys.executable, "-m", "skinjax_torch.tools.xai_cli", analysis,
               "--metadata-csv", csv_path, "--images-dir", images, "--out", out]
        procs[analysis] = subprocess.Popen(cmd, cwd=root, env=env, stdout=subprocess.PIPE,
                                           stderr=subprocess.PIPE, text=True)
    try:
        results = {a: p.communicate(timeout=600) for a, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for a, p in procs.items():
        if p.returncode != 0:
            log(results[a][0][-2000:] + results[a][1][-4000:])
        check(p.returncode == 0, f"xai_cli {a} exited {p.returncode}")
    with open(os.path.join(out, "missing_metadata_experiment.csv")) as f:
        rows = list(csv.DictReader(f))
    with open(os.path.join(out, "flip_rates.json")) as f:
        flips = json.load(f)
    keys = ["fold", "missing_rate", "accuracy", "balanced_accuracy", "precision", "recall",
            "f1_score", "auc"]
    log(f"[{card}] xai cli missing-data + flip-rate (two processes at once, {CLI_IMAGES} PNG "
        f"decodes each, ResNet-50 fp32): {wall:.1f} s wall; rows "
        + "; ".join(f"rate {r['missing_rate']}: bacc {float(r['balanced_accuracy']):.4f} auc "
                    f"{float(r['auc']):.4f}" for r in rows)
        + "; flip rates " + ", ".join(f"{k} {v['flip_rate']:.3f}" for k, v in flips.items()))
    check(len(rows) == 6 and all(list(r) == keys for r in rows)
          and [float(r["missing_rate"]) for r in rows] == [0.0, 0.1, 0.2, 0.3, 0.5, 0.7]
          and all(math.isfinite(float(r[k])) for r in rows for k in keys[2:]),
          "missing_metadata_experiment.csv is not the six rows of the sweep")
    check({"smoke", "age", "diameter_1", "gender", "region"} <= set(flips)
          and all(0 <= v["flip_rate"] <= 1 and v["n_flips"] == round(v["flip_rate"] * CLI_IMAGES)
                  for v in flips.values()), "flip_rates.json is not the flip analysis")


def phase_xai_sweep(fk, device, card, table_fn):
    """The missing-data sweep as the CLI runs it (``xai_cli.batched_predictor``
    over ``missing_data_sweep``), timed: 5 folds × 6 rates over
    XAI_SWEEP_ROWS PAD-UFES-20-like rows, the flagship fp32 engine at
    B=64, images drawn from the seed as uint8 arrays (no PNG decode).
    Returns the launches."""
    import tempfile

    import numpy as np

    from skinjax_torch.data import schemas
    from skinjax_torch.data.fixtures import write_csv
    from skinjax_torch.models import MultimodalModel
    from skinjax_torch.models.weights import init_weights
    from skinjax_torch.serve.engine import InferenceEngine
    from skinjax_torch.tools import xai_cli
    from skinjax_torch.xai import missing_data_sweep

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "metadata.csv")
        write_csv(path, table_fn(XAI_SWEEP_ROWS))
        prepared = schemas.prepare_dataset("pad-ufes-20", path)
    model = init_weights(MultimodalModel(
        num_classes=prepared.num_classes, cnn_model_name="resnet-50",
        vocab_size=prepared.feature_dim, attention_mechanism=RGATT), seed=0)
    engine = InferenceEngine(model, prepared.featurizer, prepared.class_names, device=device)
    images = np.random.default_rng(5).integers(0, 256, (XAI_SWEEP_ROWS, 224, 224, 3),
                                               dtype=np.uint8)
    predict = xai_cli.batched_predictor(engine, images, XAI_SWEEP_BATCH)
    forward_s = [0.0]

    def timed(features):
        t0 = time.perf_counter()
        out = predict(features)  # .cpu() inside: the card is done
        forward_s[0] += time.perf_counter() - t0
        return out

    predict(prepared.features[:XAI_SWEEP_BATCH])  # cuDNN's plans
    fk.reset_launches()
    t0 = time.perf_counter()
    rows = [r for fold in range(1, XAI_SWEEP_FOLDS + 1)
            for r in missing_data_sweep(timed, prepared.raw, prepared.featurizer,
                                        prepared.labels, fold=fold)]
    wall = time.perf_counter() - t0
    launches = dict(fk.LAUNCHES)
    n = len(rows) * math.ceil(XAI_SWEEP_ROWS / XAI_SWEEP_BATCH)
    expect = {"seq1_attention": 4 * n, "gated_residual_seq1": 2 * n, "metablock_film": 0,
              "mlp_head": n}
    log(f"[{card}] xai missing-data sweep: {XAI_SWEEP_FOLDS} folds x 6 rates over "
        f"{XAI_SWEEP_ROWS} rows, ResNet-50 + RG-ATT fp32 engine at B={XAI_SWEEP_BATCH} ({n} "
        f"forwards): {wall:.1f} s wall (host clock), the forwards (predict_probs, H2D of the "
        f"uint8 images included) {forward_s[0]:.1f} s = {forward_s[0] / wall:.1%}; K1-K3 "
        f"launches {launches} (expected {expect}); per fold "
        f"{wall / XAI_SWEEP_FOLDS:.1f} s. The reference: {REFERENCE_SWEEP}")
    check(len(rows) == 6 * XAI_SWEEP_FOLDS
          and all(math.isfinite(r["balanced_accuracy"]) for r in rows), "the sweep's rows")
    check(launches == expect, "the sweep's forwards did not run K1-K3 as expected")
    del engine, model
    return launches


def phase_xai(modules, device, card):
    """Phase 19: the XAI slice (``--xai``). Returns the launches of each of
    its kernels over its paths, each path's counts set to 0 just before it
    and read just after."""
    import tempfile

    import torch

    from skinjax_torch.data import schemas
    from skinjax_torch.data.fixtures import pad_ufes20_table, write_pad_ufes20_like

    fk = modules[0]
    start = time.perf_counter()

    def elapsed(label):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        log(f"elapsed in the XAI slice after {label}: {time.perf_counter() - start:.1f} s "
            f"(host clock)")

    with tempfile.TemporaryDirectory() as tmp:
        csv_path, images = write_pad_ufes20_like(os.path.join(tmp, "data"), n=CLI_IMAGES,
                                                 image_hw=CLI_IMAGE_HW, seed=0)
        fz_path = os.path.join(tmp, "featurizer.json")
        schemas.prepare_dataset("pad-ufes-20", csv_path, featurizer_path=fz_path)
        launches = phase_xai_cams(modules, device, card)
        elapsed("the CAMs")
        phase_xai_score_cam(device, card)
        elapsed("Score-CAM")
        for k, v in phase_xai_app(fk, card, fz_path, pad_ufes20_table(CLI_IMAGES, seed=0)).items():
            launches[k] += v
        elapsed("the XAI app")
        phase_xai_cli(card, csv_path, images, os.path.join(tmp, "xai"))
        elapsed("the XAI CLI")
    for k, v in phase_xai_sweep(fk, device, card, lambda n: pad_ufes20_table(n, seed=1)).items():
        launches[k] += v
    elapsed("the missing-data sweep")
    path = {k for k in launches if k in ("seq1_attention", "gated_residual_seq1", "mlp_head",
                                         "window_attention_fwd", "mlp_gelu_fwd",
                                         "mlp_gelu_bwd", "global_attention_fwd",
                                         "global_attention_bwd")}
    check(all(launches[k] > 0 for k in path), "a kernel of the XAI path was never launched")
    return launches


def xai_only() -> int:
    """``--xai``: the XAI slice alone."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing to run", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from skinjax_torch.ops import build
    from skinjax_torch.ops import fused_mlp as fm
    from skinjax_torch.ops import fusion_kernels as fk
    from skinjax_torch.ops import global_attention as ga
    from skinjax_torch.ops import window_attention as wa

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    card = card_line()
    log(card)
    names = ("fusion_kernels", "fused_mlp", "global_attention", "window_attention")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        list(pool.map(build.build, names))
    for m in (fk, fm, ga, wa):
        m.library()
    log(f"phase build: {len(names)} sources at once, {time.perf_counter() - t0:.1f} s")
    launches = phase_xai((fk, wa, ga, fm), device, card)
    torch.cuda.synchronize()
    print(json.dumps({"xai_launches": launches}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


# ---------------------------------------------------------------------------
# Phase 20: the NAS slice (``--nas``)
# ---------------------------------------------------------------------------

# skinjax's supernet test candidates (tests/test_supernet.py): every
# mechanism, kernel 3 inside a 5×5 envelope, one and two layers a block
NAS_SMALL = [
    {"num_blocks": 2, "initial_filters": 16, "kernel_size": 3, "layers_per_block": 1,
     "use_pooling": True, "common_dim": 32, "attention_mecanism": "concatenation",
     "num_layers_text_fc": 1, "neurons_per_layer_size_of_text_fc": 32,
     "num_layers_fc_module": 1, "neurons_per_layer_size_of_fc_module": 32},
    {"num_blocks": 3, "initial_filters": 32, "kernel_size": 5, "layers_per_block": 2,
     "use_pooling": True, "common_dim": 64, "attention_mecanism": "crossattention",
     "num_layers_text_fc": 2, "neurons_per_layer_size_of_text_fc": 64,
     "num_layers_fc_module": 2, "neurons_per_layer_size_of_fc_module": 64},
    {"num_blocks": 1, "initial_filters": 8, "kernel_size": 3, "layers_per_block": 2,
     "use_pooling": True, "common_dim": 16, "attention_mecanism": "metablock",
     "num_layers_text_fc": 1, "neurons_per_layer_size_of_text_fc": 16,
     "num_layers_fc_module": 2, "neurons_per_layer_size_of_fc_module": 32},
    {"num_blocks": 2, "initial_filters": 16, "kernel_size": 3, "layers_per_block": 1,
     "use_pooling": True, "common_dim": 64, "attention_mecanism": "gfcam",
     "num_layers_text_fc": 3, "neurons_per_layer_size_of_text_fc": 32,
     "num_layers_fc_module": 1, "neurons_per_layer_size_of_fc_module": 64},
]
NAS_SMALL_SHAPE = (8, 16, 11, 4)  # batch, image side, vocabulary, classes
NAS_STEPS_CHECKED = 2
NAS_TOL = 1e-4  # of the largest |logit|: fp32, TF32 off
# the same after two steps at lr 1e-3, where Adam's ±lr on near-zero gradients
# decides the drift: on one H100 the reading went from 5.2e-6 to 6.9e-4, one
# process to the next on the same inputs (PERF.md, the NAS slice)
NAS_WIDE_TOL = 1e-3


def _nas_config(f0, lpb, cd, mech, text, fc):
    return {"num_blocks": 10, "initial_filters": f0, "kernel_size": 5, "layers_per_block": lpb,
            "use_pooling": True, "common_dim": cd, "attention_mecanism": mech,
            "num_layers_text_fc": text[0], "neurons_per_layer_size_of_text_fc": text[1],
            "num_layers_fc_module": fc[0], "neurons_per_layer_size_of_fc_module": fc[1]}


# Eight candidates of DEFAULT_SEARCH_SPACE in one bucket (10 blocks, kernel
# 5, pooling on): the first is the space's maximum in every width, the others
# cover the four mechanisms
NAS_POPULATION = [
    _nas_config(64, 2, 512, "gfcam", (3, 512), (2, 512)),
    _nas_config(16, 1, 64, "concatenation", (1, 64), (1, 256)),
    _nas_config(32, 2, 128, "crossattention", (2, 128), (2, 256)),
    _nas_config(64, 1, 256, "metablock", (3, 256), (1, 512)),
    _nas_config(16, 2, 512, "gfcam", (1, 512), (2, 512)),
    _nas_config(32, 1, 64, "metablock", (2, 64), (2, 256)),
    _nas_config(64, 2, 128, "concatenation", (1, 256), (1, 256)),
    _nas_config(16, 1, 256, "crossattention", (3, 128), (2, 512)),
]
NAS_B = 32  # the NAS CLI's default batch
NAS_HW = TRAIN_HW  # build_source's image size
NAS_WARM = 2
NAS_STEPS = 10
NAS_CLI_ROWS = CLI_IMAGES


def envelope_conv_flops(env, hw) -> int:
    """The envelope's conv operations a sample, forward (2 per multiply-add)."""
    from skinjax_torch.nas.search_space import filters_from_config

    H = W = hw
    c_in, total = 3, 0
    for c in filters_from_config({"num_blocks": env.num_blocks,
                                  "initial_filters": env.initial_filters}):
        for _ in range(2 if env.layers_per_block >= 2 else 1):
            total += 2 * H * W * c_in * c * env.kernel_size ** 2
            c_in = c
        if env.use_pooling and min(H, W) >= 2:
            H, W = H // 2, W // 2
    return total


def phase_nas_card_vs_cpu(device):
    """The population step (fp32, TF32 off, augment off, dropout on: its keep
    masks are drawn on the host) of NAS_SMALL's four candidates on the card
    and on the CPU from the same seed, hence the same weights, at the train
    config's learning rate: the first step's gradients agree tensor by
    tensor, the parameters after two steps by the share rule of
    ``phase_card_vs_cpu``, and each candidate's logits after them within
    NAS_TOL of the largest. At lr 1e-3 (the CPU tests' rate) the logits are
    held within NAS_WIDE_TOL: Adam moves a weight by ~lr whatever its
    gradient's size, so a gradient near zero that the card's convs round to
    the other sign moves it by 2·lr, and the logits' drift grows with lr
    (the share rule does not hold there: the second step's gradients meet
    the first step's flips). At both rates every parameter stays within
    2·lr a step of the CPU's. Before the steps, the card's population
    forward matches each candidate's own DynamicCNN on the card."""
    import numpy as np
    import torch

    from skinjax_torch.data.augment import augment_batch
    from skinjax_torch.nas.dynamic_model import make_dynamic_model
    from skinjax_torch.nas.population import Population
    from skinjax_torch.train.loop import TrainConfig
    from skinjax_torch.train.steps import step_seed

    B, hw, vocab, classes = NAS_SMALL_SHAPE
    rng = np.random.default_rng(7)
    img = torch.as_tensor(rng.integers(0, 256, (B, hw, hw, 3), dtype=np.uint8))
    md = torch.as_tensor(rng.normal(size=(B, vocab)).astype(np.float32))
    lb = torch.as_tensor(rng.integers(0, classes, B))
    cw = np.ones(classes, np.float32)

    def run(lr):
        out = {}
        for dev in (device, torch.device("cpu")):
            cfg = TrainConfig(device=str(dev), image_dtype="float32", augment=False,
                              batch_size=B, **({"learning_rate": lr} if lr else {}))
            pop = Population(NAS_SMALL, classes, vocab, cfg, cw, seed=0, exact_init=True)
            args = [t.to(dev) for t in (img, md, lb)]
            start = pop.logits(*args[:2])
            pop.train_step(*args)
            grads = {n: p.grad.detach().cpu() for n, p in pop.params.items()}
            for _ in range(NAS_STEPS_CHECKED - 1):
                pop.train_step(*args)
            out[dev.type] = dict(pop=pop, start=start, grads=grads, logits=pop.logits(
                *args[:2]).cpu(), params={n: p.detach().cpu() for n, p in pop.params.items()})
        return out, cfg.learning_rate

    def param_drift(out, lr):
        """(elements beyond 0.01·lr, elements, largest |diff|) after the steps."""
        pd = [(out[device.type]["params"][n] - p).abs() for n, p in out["cpu"]["params"].items()]
        return (sum(int((d > 0.01 * lr).sum()) for d in pd), sum(d.numel() for d in pd),
                max(float(d.max()) for d in pd))

    def logit_err(out):
        ref = out["cpu"]["logits"]
        return float(((out[device.type]["logits"] - ref).abs().amax(dim=(1, 2))
                      / ref.abs().amax(dim=(1, 2))).max())

    out, lr = run(None)
    pop = out[device.type]["pop"]
    image = augment_batch(img.to(device), train=False, out_dtype=torch.float32)
    errs = []
    for k, (c, key) in enumerate(zip(NAS_SMALL, pop.keys)):
        model = make_dynamic_model(c, classes, vocab, seed=step_seed(0, key)).to(device).eval()
        with torch.no_grad():
            want = model(image, md.to(device))
        errs.append(float((out[device.type]["start"][k] - want).abs().max() / want.abs().max()))
    log(f"nas card population forward against each candidate's own DynamicCNN on the card: "
        f"max |Δ| / max |logit| {max(errs):.2e} (tolerance {NAS_TOL:.0e})")
    check(max(errs) <= NAS_TOL, "the population forward departs from the candidates' own")

    gc, gh = out[device.type]["grads"], out["cpu"]["grads"]
    g_all = float(torch.sqrt(sum((g.double() ** 2).sum() for g in gh.values())))
    gexcess = {n: float((gc[n] - gh[n]).norm() / (1e-3 * gh[n].norm() + 1e-6 * g_all))
               for n in gh}
    worst = max(gexcess, key=gexcess.get)
    far, total, pmax = param_drift(out, lr)
    err = logit_err(out)
    wide, wide_lr = run(1e-3)
    wide_far, _, wide_pmax = param_drift(wide, wide_lr)
    wide_err = logit_err(wide)
    log(f"nas card against CPU, {len(NAS_SMALL)} candidates (fp32, TF32 off, dropout on), lr "
        f"{lr:g}: the first step's gradients of {len(gh)} stacked tensors, worst "
        f"|diff|/(1e-3·|g_cpu| + 1e-6·|g_all|) {gexcess[worst]:.3e} at {worst} (tol 1); after "
        f"{NAS_STEPS_CHECKED} steps {far} of {total} parameter elements beyond 0.01·lr (tol a "
        f"share of 1e-4), max |diff| {pmax:.2e} (tol 2·lr a step), logits max |Δ| / max |logit| "
        f"{err:.2e} (tolerance {NAS_TOL:.0e}); at lr {wide_lr:g} {wide_far} elements beyond "
        f"0.01·lr (logged), max |diff| {wide_pmax:.2e}, the logits {wide_err:.2e} (tolerance "
        f"{NAS_WIDE_TOL:.0e})")
    check(gexcess[worst] <= 1.0, f"the card and the CPU disagree on the gradient of {worst}")
    check(far <= 1e-4 * total, "the card and the CPU disagree on the parameters")
    for p, r in ((pmax, lr), (wide_pmax, wide_lr)):
        check(p <= 2 * NAS_STEPS_CHECKED * r,
              f"at lr {r:g} a parameter of the card's moved further than Adam's steps allow")
    check(err <= NAS_TOL, "the card's population step departs from the CPU's")
    check(wide_err <= NAS_WIDE_TOL, f"at lr {wide_lr:g} the card's population step departs "
          f"from the CPU's")
    return err


def phase_nas_population(ak, device, card):
    """NAS_POPULATION's eight candidates as one bucket at full width:
    NAS_B images of NAS_HW², bf16 image pipeline, augment on (K5 once a
    population step), NAS_WARM + NAS_STEPS population steps timed by CUDA
    events against the same candidates trained one at a time through the
    port's train step, NAS_STEPS steps each. The trainer's width cap admits
    the K candidates, before this bucket and with its freed blocks still in
    the allocator's cache (a later bucket's view), and the peak memory stays
    within ``population_step_bytes``·K. Returns K5's launches over the
    population steps."""
    import numpy as np
    import torch

    from skinjax_torch.nas.dynamic_model import make_dynamic_model
    from skinjax_torch.nas.population import (
        Population,
        device_budget,
        envelope_step_bytes,
        hbm_width_cap,
        population_step_bytes,
    )
    from skinjax_torch.nas.supernet import envelope_of
    from skinjax_torch.train.loop import TrainConfig, build_state
    from skinjax_torch.train.steps import make_train_step_weighted, step_seed

    K = len(NAS_POPULATION)
    env = envelope_of(NAS_POPULATION)
    per = envelope_step_bytes(env, (NAS_HW, NAS_HW), NAS_B)
    port = population_step_bytes(env, (NAS_HW, NAS_HW), NAS_B, 91, 6)
    flops = envelope_conv_flops(env, NAS_HW)
    batch, cw = train_batch(device, B=NAS_B, hw=NAS_HW, seed=2)
    budget = device_budget(device)
    cap = hbm_width_cap(env, (NAS_HW, NAS_HW), NAS_B, budget, 91, 6)
    log(f"[{card}] nas population: K={K}, envelope {env}; population_step_bytes "
        f"{port / 1e9:.2f} GB a candidate, {K * port / 1e9:.2f} GB for K={K} (skinjax's "
        f"envelope_step_bytes {per / 1e9:.2f}, {K * per / 1e9:.2f}); the envelope's convs "
        f"{flops / 1e9:.1f} GFLOP a sample forward; the trainer's budget {budget / 1e9:.2f} GB, "
        f"its width cap here {cap}")
    check(cap >= K, f"the trainer would split the K={K} bucket (width cap {cap})")
    cfg = TrainConfig(device=str(device), batch_size=NAS_B)
    t0 = time.perf_counter()
    before = torch.cuda.memory_allocated(device)
    pop = Population(NAS_POPULATION, 6, 91, cfg, cw.cpu().numpy(), seed=0, exact_init=True)
    torch.cuda.synchronize()
    log(f"nas population built (exact init of {K} candidates on the host, embedded, copied "
        f"to the card): {time.perf_counter() - t0:.1f} s (host clock)")
    torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device)
    args = (batch["image"], batch["metadata"], batch["label"])
    ak.reset_launches()
    for _ in range(NAS_WARM):
        pop.train_step(*args)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(NAS_STEPS):
        losses = pop.train_step(*args)
    end.record()
    torch.cuda.synchronize()
    launches = ak.LAUNCHES[K5]
    pop_ms = start.elapsed_time(end) / NAS_STEPS
    peak = torch.cuda.max_memory_allocated(device) - base
    bucket = peak + base - before  # the parameters too
    check(bool(torch.isfinite(losses).all()), "a population loss is not finite")
    check(launches == NAS_WARM + NAS_STEPS,
          f"K5 launched {launches} times over {NAS_WARM + NAS_STEPS} population steps")
    log(f"[{card}] nas population step (K={K}, B={NAS_B}, {NAS_HW}x{NAS_HW}, bf16 images, "
        f"fp32 convs, TF32 off): {pop_ms:.2f} ms a step (CUDA events, {NAS_STEPS} steps after "
        f"{NAS_WARM}), {K * NAS_B / pop_ms * 1e3:.1f} candidate·images/s; peak device memory "
        f"above the parameters {peak / 1e9:.2f} GB ({peak / (K * per):.2f}x "
        f"envelope_step_bytes·K), with them {bucket / 1e9:.2f} GB against "
        f"population_step_bytes·K {K * port / 1e9:.2f} GB ({bucket / (K * port):.3f}x); K5 "
        f"launches {launches} ({NAS_WARM + NAS_STEPS} steps); last losses "
        f"{[round(float(x), 4) for x in losses]}")
    check(bucket <= K * port, "the population took more memory than population_step_bytes")
    keys = pop.keys
    del pop
    # a later bucket of the search meets the blocks this one left in the cache
    after = device_budget(device)
    log(f"nas the trainer's budget with the freed population's blocks still cached: "
        f"{after / 1e9:.2f} GB (before it: {budget / 1e9:.2f}; the card's free memory alone "
        f"{torch.cuda.mem_get_info(device)[0] / 1e9:.2f}); width cap "
        f"{hbm_width_cap(env, (NAS_HW, NAS_HW), NAS_B, after, 91, 6)}")
    check(hbm_width_cap(env, (NAS_HW, NAS_HW), NAS_B, after, 91, 6) == cap,
          "a later bucket's width cap differs from the first's")
    torch.cuda.empty_cache()

    step = make_train_step_weighted()
    seq_ms = 0.0
    for c, key in zip(NAS_POPULATION, keys):  # each from its population init
        state = build_state(make_dynamic_model(c, 6, 91, seed=step_seed(0, key)), cfg)
        step(state, *args, 0, cw)  # warm
        start.record()
        for _ in range(NAS_STEPS):
            loss = step(state, *args, 0, cw)
        end.record()
        torch.cuda.synchronize()
        check(bool(torch.isfinite(loss)), "a candidate's loss is not finite")
        seq_ms += start.elapsed_time(end) / NAS_STEPS
        del state
    torch.cuda.empty_cache()
    log(f"[{card}] nas the same {K} candidates one at a time through the train step: "
        f"{seq_ms:.2f} ms for a step of each, {K * NAS_B / seq_ms * 1e3:.1f} candidate·images/s; "
        f"the population step {seq_ms / pop_ms:.2f}x as fast (CUDA events)")
    return launches


def _cli_json(argv, main):
    """Run a CLI's ``main(argv)`` in this process (so its launches are
    counted here) and return the JSON lines it printed."""
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = main(argv)
    lines = [json.loads(x) for x in buf.getvalue().splitlines() if x.startswith("{")]
    return out, lines


def phase_nas_cli(ak, card):
    """``python -m skinjax_torch.tools.nas_cli``'s entry point, twice, in
    this process: the population path with the REINFORCE controller on the
    card (``--synthetic --strategy reinforce --population 4 --steps 8
    --epochs 2``), then the sequential path and a 5-fold retrain on a
    PAD-UFES-20-like dataset read from disk (``--strategy bo --steps 1
    --epochs 1 --batch-size 16 --retrain-best``). Returns K5's launches over
    both."""
    import tempfile

    from skinjax_torch.data.fixtures import write_pad_ufes20_like
    from skinjax_torch.tools import nas_cli

    total = 0
    with tempfile.TemporaryDirectory() as tmp:
        csv_path, images = write_pad_ufes20_like(os.path.join(tmp, "data"), n=NAS_CLI_ROWS,
                                                 image_hw=CLI_IMAGE_HW, seed=0)
        runs = [("reinforce population", ["--synthetic", "--strategy", "reinforce",
                                          "--population", "4", "--steps", "8",
                                          "--epochs", "2"]),
                ("bo sequential + retrain", ["--dataset", "pad-ufes-20", "--metadata-csv",
                                             csv_path, "--images-dir", images, "--strategy",
                                             "bo", "--steps", "1", "--epochs", "1",
                                             "--batch-size", "16", "--retrain-best"])]
        for i, (label, argv) in enumerate(runs):
            ak.reset_launches()
            t0 = time.perf_counter()
            (best, reward, steps_log, folds), lines = _cli_json(
                argv + ["--results-dir", os.path.join(tmp, f"nas{i}")], nas_cli.main)
            seconds = time.perf_counter() - t0
            launches = ak.LAUNCHES[K5]
            total += launches
            log(f"[{card}] nas cli {label}: {seconds:.1f} s (host clock); best reward "
                f"{reward:.4f}; steps {len(steps_log)} ({sum(bool(e.get('cached')) for e in steps_log)}"
                f" cached, {sum(bool(e.get('failed')) for e in steps_log)} failed); retrain folds "
                f"{None if folds is None else [round(m['balanced_accuracy'], 4) for m in folds]};"
                f" K5 launches {launches}; printed {lines[0]}")
            check(lines and lines[0].get("best_config") == best, f"nas cli {label}: no JSON line")
            check(len(steps_log) == int(argv[argv.index("--steps") + 1])
                  and not any(e.get("failed") for e in steps_log), f"nas cli {label}: a step failed")
            check(launches > 0, f"nas cli {label}: K5 never launched")
            if folds is not None:
                check(len(folds) == 5 and len(lines) == 2, f"nas cli {label}: no 5-fold retrain")
    return total


def phase_nas(ak, device, card):
    """Phase 20: the NAS slice (``--nas``). Returns K5's launches over its
    paths, each path's count set to 0 just before it and read just after."""
    import gc

    import torch

    start = time.perf_counter()

    def elapsed(label):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        log(f"elapsed in the NAS slice after {label}: {time.perf_counter() - start:.1f} s "
            f"(host clock)")

    # the full-width bucket takes most of the card: nothing earlier may hold it
    _SMOKE_MODELS.clear()
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info(device)
    log(f"nas: {free / 1e9:.2f} of {total / 1e9:.2f} GB of device memory free")
    phase_nas_card_vs_cpu(device)
    elapsed("the card-vs-CPU population")
    launches = {"population": phase_nas_population(ak, device, card)}
    elapsed("the full-width population")
    launches["cli"] = phase_nas_cli(ak, card)
    elapsed("the NAS CLI")
    return launches


def nas_only() -> int:
    """``--nas``: the NAS slice alone."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing to run", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from skinjax_torch.ops import augment_kernel as ak
    from skinjax_torch.ops import build

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    card = card_line()
    log(card)
    t0 = time.perf_counter()
    build.build("augment_kernel")
    ak.library()
    log(f"phase build: augment_kernel.cu, {time.perf_counter() - t0:.1f} s")
    launches = phase_nas(ak, device, card)
    print(json.dumps({"nas_launches": launches}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing to run", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from skinjax_torch import (
        BEIT,
        BEIT_BATCH,
        CAFORMER,
        CAFORMER_BATCH,
        COAT,
        COAT_BATCH,
        DAVIT,
        DAVIT_BATCH,
        FLAGSHIP,
        GPT2,
        MVIT,
        MVIT_BATCH,
        SENTENCE,
        SENTENCE_FROZEN_TOKENS,
        SENTENCE_TOKENS,
    )
    from skinjax_torch.ops import channel_attention as ca
    from skinjax_torch.ops import augment_kernel as ak
    from skinjax_torch.ops import batch_norm as bn
    from skinjax_torch.ops import build
    from skinjax_torch.ops import fused_mlp as fm
    from skinjax_torch.ops import fusion_kernels as fk
    from skinjax_torch.ops import global_attention as ga
    from skinjax_torch.ops import pooled_attention as pa
    from skinjax_torch.ops import window_attention as wa

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)

    start = time.perf_counter()

    def elapsed(label):
        log(f"elapsed after {label}: {time.perf_counter() - start:.1f} s (host clock)")

    card = card_line()
    log(card)
    log(f"phase card: {torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, devices {torch.cuda.device_count()}; TF32 off")

    build_kernels(build, (fk, ak, wa, ga, pa, fm, ca, bn))
    for name, src in BUILDS.items():
        info = build.build_info[name]
        built = f"built in {info['seconds']:.1f} s" if info["seconds"] else "already built"
        log(f"  {src} {built}")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas: {line.strip()}")
    log_spills(build, "fusion_kernels", KERNEL_NAMES[K3])

    errors = phase_kernels(fk, device)
    for name in ROUTE_WIDTHS:  # K1's, K2's, K4's and K3's two routes
        errors[name] = max(errors[name], phase_routes(fk, device, name))
    errors[K5] = phase_k5(ak, device)
    errors.update(phase_k7(wa, device))
    errors.update(phase_k12(ga, device))
    for name, err in phase_models_k12(ga, device).items():
        errors[name] = max(errors[name], err)
    errors.update(phase_k11(pa, device))
    errors.update(phase_mlp(fm, device))
    phase_mlp_same_bits(fm, device)
    errors.update(phase_k8(ca, device))
    errors.update(phase_k7pad(wa, ga, device))
    errors.update(phase_k6(bn, device))
    # K12's, K11's and K7's times first: in a process that has traced much,
    # torch.profiler dropped K7's launches from its traces
    k12_times = phase_k12_times(ga, device, card)
    phase_models_k12_times(ga, device, card)
    k11_times = phase_k11_times(pa, device, card)
    phase_bwd_p_split(ga, pa, device, card)
    mlp_times = phase_mlp_times(fm, device, card, errors)
    k7_times = phase_k7_times(wa, device, card)
    k8_times = phase_k8_times(ca, device, card)
    pad_times = phase_k7pad_times(wa, ga, device, card)
    k4_times = phase_k4_times(fk, device, card)
    phase_models_fusion_times(fk, device, card)
    k6_times = phase_k6_times(bn, device, card)
    torch.cuda.synchronize()
    elapsed("the build and the kernel checks and times")
    # the flagship: served, trained, run_kfold
    fused, plain = phase_slice(fk, device, card)
    torch.cuda.synchronize()
    launches, _ = phase_server(fk, card)
    torch.cuda.synchronize()
    batch, cw, step, _ = phase_train([ak], device, card)
    phase_card_vs_cpu(device)
    launches[K5] = phase_fold(ak, device, card)
    torch.cuda.synchronize()
    engine_latency(fused, plain, "flagship", card)
    del fused, plain
    times = phase_kernel_times(fk, device, card)
    phase_train_times(device, card, batch, cw, step)
    k5_times = phase_k5_times(ak, device, card, batch)
    del batch, cw, step
    torch.cuda.synchronize()
    elapsed("the flagship")

    # DaViT: served, trained; K7's launches on the main path are the 10
    # unfrozen train steps'
    d_fused, d_plain = phase_slice(fk, device, card, "davit", DAVIT, [(wa, K7_SERVED)])
    phase_server(fk, card, cnn="davit_tiny", towers=[(wa, K7_SERVED)])
    k7_step = {"window_attention_fwd": K7_PER_FORWARD, "window_attention_bwd": K7_PER_FORWARD,
               K7_PAD: 0}
    batch, cw, step, d_launches = phase_train(
        [ak, wa], device, card, "davit", DAVIT, DAVIT_BATCH, per_step={K5: 1, **k7_step},
        frozen_per_step={K5: 1, **k7_step, "window_attention_bwd": 0})
    launches.update({name: d_launches[name] for name in K7})
    with small_davit_registered():
        phase_card_vs_cpu(device, cnn=SMALL_DAVIT, hw=56)
    torch.cuda.synchronize()
    engine_latency(d_fused, d_plain, "davit", card, batches=(1,), n=20, profile=False)
    del d_fused, d_plain
    phase_train_times(device, card, batch, cw, step, "davit", DAVIT,
                      kernel_names={"K7": [n for names in K7_KERNELS.values() for n in names]})
    torch.cuda.synchronize()
    elapsed("DaViT")

    launches.update(phase_davit_k8((fk, ak, wa, ca), device, card, batch, cw, step, k7_step))
    del batch, cw, step
    _SMOKE_MODELS.clear()
    torch.cuda.synchronize()
    elapsed("DaViT with K8")

    # BEiT-v2-large: served, trained; K12's launches on the main path are the
    # 10 unfrozen train steps'. Then ViT-large served: K12 without a bias
    b_fused, b_plain = phase_slice(fk, device, card, "beitv2-large", BEIT, [(ga, K12_SERVED)],
                                   fp32=False)
    phase_server(fk, card, cnn=BEIT["cnn_model_name"], towers=[(ga, K12_SERVED)])
    k12_step = {"global_attention_fwd": K12_PER_FORWARD, "global_attention_bwd": K12_PER_FORWARD,
                K12_RECOMPUTE: 0}  # 79.5 MB of P a call: the stored-P route
    batch, cw, step, b_launches = phase_train(
        [ak, ga], device, card, "beitv2-large", BEIT, BEIT_BATCH, per_step={K5: 1, **k12_step},
        frozen_per_step={K5: 1, **k12_step, "global_attention_bwd": 0}, lr=TOWER_TRAIN_LR)
    launches.update({name: b_launches[name] for name in ("global_attention_fwd",
                                                         "global_attention_bwd")})
    with small_beit_registered():
        phase_card_vs_cpu(device, cnn=SMALL_BEIT, hw=224)
    torch.cuda.synchronize()
    engine_latency(b_fused, b_plain, "beitv2-large", card, batches=(1,), n=20, profile=False)
    del b_fused, b_plain
    phase_train_times(device, card, batch, cw, step, "beitv2-large", BEIT,
                      kernel_names={"K12": [n for names in K12_KERNELS.values() for n in names]})
    del batch, cw, step
    v_fused, v_plain = phase_slice(fk, device, card, "vit-large",
                                   dict(FLAGSHIP, cnn_model_name=VIT_LARGE), [(ga, K12_SERVED)],
                                   fp32=False)
    del v_fused, v_plain
    _SMOKE_MODELS.clear()
    torch.cuda.synchronize()
    elapsed("BEiT-v2-large and ViT-large")

    # MViTv2-small: served, trained; K11's launches on the main path are the
    # 10 unfrozen train steps'
    m_fused, m_plain = phase_slice(fk, device, card, "mvitv2-small", MVIT, [(pa, K11_SERVED)])
    phase_server(fk, card, cnn=MVIT["cnn_model_name"], towers=[(pa, K11_SERVED)])
    k11_step = {"pooled_attention_fwd": K11_PER_FORWARD, "pooled_attention_bwd": K11_PER_FORWARD}
    batch, cw, step, m_launches = phase_train(
        [ak, pa], device, card, "mvitv2-small", MVIT, MVIT_BATCH, per_step={K5: 1, **k11_step},
        frozen_per_step={K5: 1, **k11_step, "pooled_attention_bwd": 0}, lr=TOWER_TRAIN_LR)
    launches.update({name: m_launches[name] for name in K11})
    with small_mvit_registered():
        phase_card_vs_cpu(device, cnn=SMALL_MVIT, hw=64)
    torch.cuda.synchronize()
    engine_latency(m_fused, m_plain, "mvitv2-small", card, batches=(1,), n=20, profile=False)
    del m_fused, m_plain
    m_times = phase_train_times(device, card, batch, cw, step, "mvitv2-small", MVIT,
                                kernel_names={"K11": [n for names in K11_KERNELS.values()
                                                      for n in names]})
    log(f"[{card}] mvitv2_small_images_per_sec "
        f"{MVIT_BATCH / m_times['unfrozen_weights'] * 1e3:.1f} (MViTv2-small, RG-ATT, "
        f"B={MVIT_BATCH}, bf16, augment on, unfrozen; CUDA events)")
    del batch, cw, step
    _SMOKE_MODELS.clear()
    torch.cuda.synchronize()
    elapsed("MViTv2-small")

    # CAFormer-b36 (K10 on every MLP, K12 on the attention blocks) and
    # CoaT-lite-small (K9 on every serial MLP): served, trained; the fused
    # MLPs' launches on the main path are the 10 unfrozen train steps'
    mlp_off = {name: 0 for name in (*K9, *K10)}
    k12_off = {name: 0 for name in K12}
    k10_fwd = dict(mlp_off, mlp_star_fwd=K10_PER_FORWARD)
    k12_fwd = dict(k12_off, global_attention_fwd=K12_CAFORMER)  # 79 MB of P: stored-P
    c_step = {K5: 1, **k10_fwd, "mlp_star_bwd": K10_PER_FORWARD, **k12_fwd,
              "global_attention_bwd": K12_CAFORMER}
    c_launches, c_times = phase_tower(
        [fk, ak, fm, ga], device, card, "caformer-b36", CAFORMER, CAFORMER_BATCH,
        [(fm, k10_fwd), (ga, k12_fwd)], c_step,
        dict(c_step, mlp_star_bwd=0, global_attention_bwd=0), small_caformer_registered,
        SMALL_CAFORMER, {"K10": MLP_KERNELS["fwd"] + MLP_KERNELS["bwd"] + [MLP_SPLIT],
                         "K12": [n for names in K12_KERNELS.values() for n in names]})
    launches.update({name: c_launches[name] for name in K10})
    log(f"[{card}] caformer_b36_images_per_sec "
        f"{CAFORMER_BATCH / c_times['unfrozen_weights'] * 1e3:.1f} (CAFormer-b36, RG-ATT, "
        f"B={CAFORMER_BATCH}, bf16, augment on, unfrozen; CUDA events)")
    torch.cuda.synchronize()
    elapsed("CAFormer-b36")
    k9_fwd = dict(mlp_off, mlp_gelu_fwd=K9_PER_FORWARD)
    t_step = {K5: 1, **k9_fwd, "mlp_gelu_bwd": K9_PER_FORWARD}
    t_launches, t_times = phase_tower(
        [fk, ak, fm], device, card, "coat-lite-small", COAT, COAT_BATCH,
        [(fm, k9_fwd)], t_step, dict(t_step, mlp_gelu_bwd=0), small_coat_registered, SMALL_COAT,
        {"K9": MLP_KERNELS["fwd"] + MLP_KERNELS["bwd"] + [MLP_SPLIT]})
    launches.update({name: t_launches[name] for name in K9})
    log(f"[{card}] coat_lite_small_images_per_sec "
        f"{COAT_BATCH / t_times['unfrozen_weights'] * 1e3:.1f} (CoaT-lite-small, RG-ATT, "
        f"B={COAT_BATCH}, bf16, augment on, unfrozen; CUDA events)")
    torch.cuda.synchronize()
    elapsed("CoaT-lite-small")

    launches.update(phase_swin((fk, ak, wa, ga), device, card))
    torch.cuda.synchronize()
    elapsed("Swin-tiny")

    # the BatchNorm towers on K6's route: NextViT-small served and trained
    # (K6's launches on the main path are its 10 unfrozen train steps'), its
    # train step and the flagship's A/B'd against the native BatchNorm; the
    # CNN zoo served and trained
    with k6_registered():
        k6_launches, nextvit_ab = phase_nextvit((fk, ak, bn), device, card)
        launches.update(k6_launches)
        torch.cuda.synchronize()
        elapsed("NextViT-small")
        flagship_ab = phase_flagship_k6_ab(device, card)
        wins = nextvit_ab["K6"] < nextvit_ab["native"] and flagship_ab["K6"] < flagship_ab["native"]
        log(f"[{card}] K6 against the native BatchNorm, same run: NextViT-small "
            f"{nextvit_ab['native'] / nextvit_ab['K6']:.3f}x, flagship "
            f"{flagship_ab['native'] / flagship_ab['K6']:.3f}x (native ms / K6 ms); K6 wins both: "
            f"{wins}")
        phase_zoo((fk, ak, bn), device, card)
    torch.cuda.synchronize()
    elapsed("the BatchNorm towers")

    # the sentence path: DaViT-tiny + BERT-base (and GPT-2) tokens models at
    # B=32, trained; the recompute backward's launches on the main path are
    # the 10 unfrozen BERT T=512 steps' (402 MB of P a call, above the limit)
    text_step = {K5: 0, "window_attention_fwd": K7_PER_FORWARD,
                 "window_attention_bwd": K7_PER_FORWARD, K7_PAD: 0,
                 "global_attention_fwd": K12_TEXT_LAYERS,
                 "global_attention_bwd": 0, K12_RECOMPUTE: K12_TEXT_LAYERS}
    s_launches, _ = phase_sentence_train([ak, wa, ga], device, card, "davit+bert-base",
                                         SENTENCE, SENTENCE_TOKENS, text_step, timed=True)
    launches[K12_RECOMPUTE] = s_launches[K12_RECOMPUTE]
    _, frozen_ms = phase_sentence_train(
        [ak, wa, ga], device, card, "davit+bert-base", SENTENCE, SENTENCE_FROZEN_TOKENS,
        dict(text_step, **{K12_RECOMPUTE: 0}), text_frozen=True, timed=True)
    log(f"[{card}] sentence_frozen_images_per_sec {32 / frozen_ms * 1e3:.1f} (DaViT-tiny + "
        f"BERT-base, RG-ATT, B=32, T={SENTENCE_FROZEN_TOKENS}, text tower frozen, bf16, the "
        f"sentence recipe; CUDA events)")
    phase_sentence_train([ak, wa, ga], device, card, "davit+gpt2", GPT2, SENTENCE_TOKENS,
                         text_step)
    _SMOKE_MODELS.clear()
    phase_card_vs_cpu(device, sentence=True)
    torch.cuda.synchronize()
    elapsed("the sentence path")

    # the train CLI slice: all 18 mechanisms; the CLI from disk, then the
    # service on its …+metablock checkpoint (K4's launches on the main path
    # are the served requests')
    t0 = time.perf_counter()
    phase_mechanisms(fk, device, card)
    torch.cuda.synchronize()
    log(f"phase mechanisms: {time.perf_counter() - t0:.1f} s (host clock)")
    launches[K4] = phase_cli(fk, card)[K4]
    torch.cuda.synchronize()
    metablock_latency(device, card)
    torch.cuda.synchronize()
    elapsed("the train CLI slice")
    phase_sentence_cli(ga, device, card)
    torch.cuda.synchronize()
    elapsed("the sentence train CLI")

    # the rest of the model zoo: TabTransformer, static-embedding, sequence
    # fusion, the baselines, the batching service
    phase_models(fk, ak, ga, device, card)
    elapsed("the rest of the model zoo")

    # the XAI slice: the CAM family on four towers, Score-CAM, the XAI app,
    # the XAI CLI and the missing-data sweep
    phase_xai((fk, wa, ga, fm), device, card)
    elapsed("the XAI slice")

    # the NAS slice: the population step on the card against the CPU, eight
    # full-width candidates as one bucket (K5 once a population step), the
    # NAS CLI's population and sequential paths; K5's row counts them too
    nas_launches = phase_nas(ak, device, card)
    print(json.dumps({"nas_launches": nas_launches}), flush=True)
    launches[K5] += sum(nas_launches.values())
    elapsed("the NAS slice")

    record = {"kernels": [
        # K1-K3 at B=1, the served batch, L2-warm, K3 at the flagship's widths
        # (the other batches, K3's metablock shape and the L2-cold times are
        # printed above)
        {"name": name, "route": "cuda", "source": SOURCE, "replaces": KERNELS[name],
         "launches": launches[name], "max_abs_err": errors[name],
         "ms": times[(name, 1)]["ms"], "plain_ms": times[(name, 1)]["plain_ms"],
         "bound_ms": times[(name, 1)]["bound_ms"], "bound_by": "bytes",
         "library_ms": times[(name, 1)]["library_ms"]}
        for name in KERNELS if name != K4
    ] + [
        # K4 at the served …+metablock path's shape (Vd = 512, B = 1); the
        # other widths are printed above
        {"name": K4, "route": "cuda", "source": SOURCE, "replaces": KERNELS[K4],
         "launches": launches[K4], "max_abs_err": errors[K4],
         "ms": k4_times[512]["ms"], "plain_ms": k4_times[512]["plain_ms"],
         "bound_ms": k4_times[512]["bound_ms"], "bound_by": "bytes",
         "library_ms": k4_times[512]["library_ms"]}
    ] + [
        {"name": K5, "route": "cuda", "source": K5_SOURCE, "replaces": K5_REPLACES,
         "launches": launches[K5], "max_abs_err": errors[K5],
         "ms": k5_times[TRAIN_B]["ms"], "plain_ms": k5_times[TRAIN_B]["plain_ms"],
         "bound_ms": k5_times[TRAIN_B]["bound_ms"], "bound_by": "bytes", "library_ms": None}
    ] + [
        # DaViT-tiny's stage 1 at B=64 (the other stages are printed above)
        {"name": name, "route": "cuda", "source": K7_SOURCE, "replaces": K7[name],
         "launches": launches[name], "max_abs_err": errors[name],
         **k7_times[(name, K7_STAGES[0][0])]}
        for name in K7
    ] + [
        # the forward and stored-P backward at BEiT-v2-large's shape at its
        # train batch: B=32, N=197, C=1024, 16 heads, bf16, with the relative
        # position bias; the recompute backward at BERT-base's T=512 train
        # shape: B=32, N=512, C=768, 12 heads, bf16, kmask + pmult (the other
        # shapes are above)
        {"name": name, "route": "cuda", "source": K12_SOURCE, "replaces": K12[name],
         "launches": launches[name], "max_abs_err": errors[name], **k12_times[name]}
        for name in K12
    ] + [
        # MViTv2-small's stage-2 body at its train batch: B=64, Nq = Nk = 196,
        # 4 heads, 96 channels a head, bf16 (10 of the 16 blocks; the other
        # shapes are above)
        {"name": name, "route": "cuda", "source": K11_SOURCE, "replaces": K11[name],
         "launches": launches[name], "max_abs_err": errors[name],
         **k11_times[(name, K11_RECORD)]}
        for name in K11
    ] + [
        # K10 at CAFormer-b36's stage 2 at its train batch: T = 6272, D = 512,
        # H = 2048 (18 of the 36 blocks); K9 at CoaT-lite-small's stage 3:
        # T = 12608, D = 320, H = 1280 (6 of the 16); bf16 (the other shapes
        # are above)
        {"name": name, "route": "cuda", "source": MLP_SOURCE, "replaces": {**K10, **K9}[name],
         "launches": launches[name], "max_abs_err": errors[name],
         **mlp_times[(name, MLP_RECORD[name[:8]])]}
        for name in (*K10, *K9)
    ] + [
        # K8 at DaViT-tiny's stage 0 at its train batch: B=64, N=3136, C=96,
        # 3 heads, bf16 (the other stages are above)
        {"name": name, "route": "cuda", "source": K8_SOURCE, "replaces": K8[name],
         "launches": launches[name], "max_abs_err": errors[name],
         **k8_times[(name, K8_STAGES[0][0])]}
        for name in K8
    ] + [
        # K7's padded entry and its masked backward core at Swin-tiny's stage
        # 0 at its train batch: 4096 windows of 49 tokens, C=96, 3 heads, the
        # bias and the shifted mask, bf16 (the other stages are above)
        {"name": name, "route": "cuda", "source": source, "replaces": replaces,
         "launches": launches[name], "max_abs_err": errors[name],
         **pad_times[(name, SWIN_STAGES[0][0])]}
        for name, source, replaces in ((K7_PAD, K7_SOURCE, K7_PAD_REPLACES),
                                       (K7_PAD_BWD, K12_SOURCE, K7_PAD_BWD_REPLACES))
    ] + [
        # K6 at ResNet-50's first BN at its train batch: 1,605,632 rows of 64
        # channels, bf16, channels_last (NextViT-small's shapes are above)
        {"name": name, "route": "cuda", "source": K6_SOURCE, "replaces": K6[name],
         "launches": launches[name], "max_abs_err": errors[name],
         **k6_times[(name, K6_RECORD)]}
        for name in K6
    ]}
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit({"--attention": attention_only, "--mlp": mlp_only, "--k8": k8_only,
              "--fusion": fusion_only, "--models": models_only,
              "--xai": xai_only, "--nas": nas_only}.get(" ".join(sys.argv[1:]), main)())
