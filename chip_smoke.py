#!/usr/bin/env python3
"""Build, check, run and time the PyTorch/CUDA port on one NVIDIA card.

Run from the root of a checkout, on a machine with one CUDA card and the
CUDA toolkit:

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. print the card's name and power limit; build every CUDA kernel from
     ``src/repro_torch/kernels/csrc`` with nvcc (sm_90a), in parallel, and
     require tensor-core instructions in the SASS of the libraries with
     tensor-core routes (HGMMA for flash, HMMA for decode and the chunked
     RWKV6 scan);
  2. hold each kernel against its plain PyTorch version on the card, at
     the paths' shapes and at ragged ones (YUV decode and IoU exactly:
     the YUV decode on each of its routes, vec16 on all 2^24 triples and
     at 1080p, vec4 and scalar on ragged frames and offset inputs, strided
     views through the wrapper's copy; the IoU equal to its transpose, on
     boxes with ties and on boxes that all overlap; both bit-equal across CUDA-graph
     replays); the routes of each kernel that has more than one (matmul:
     the one-launch skinny kernel for M <= 8 and the rows kernel for 9 to
     64 rows (the serving cluster's batches), each bit-equal on a repeat
     and a CUDA-graph replay, and the tiled one; attention: tensor cores for bf16 at the
     built widths, CUDA cores for fp32 and other widths; the RWKV6 scan:
     the chunked scan for bf16 prefills from linear_scan.CHUNK_MIN_S
     steps on, the serial one for the rest; the Mamba scan: the
     time-segmented scan for prefills from linear_scan.MAMBA_SEG_MIN_S
     steps on and the lane-split step for S = 1 at N = 16, with steps
     that drive exp(delta A) to 0 and denormals, the serial kernel for
     the rest; the flash backward at llama3-8b's training shape and
     whisper's encoder, its split route at gemma3-12b's training shape,
     past gemma3's window at S = 2,048, ragged and offset, and its kv128
     route at deepseek-v2-236b's (MLA) and S = 37, with the split route
     forced there too, each a CUDA-graph replay bit-equal, and in bf16 on
     the wgmma route at every other head shape the zoo's training steps
     launch: granite-moe-3b-a800m's G = 3 at D = 64, whisper-large-v3's
     decoder self attention (187 rows) and cross attention (187 against
     1,500), qwen2.5-14b's G = 5 and chameleon-34b's and qwen1.5-110b's
     G = 8 at D = 128; decode at G = 1); the two scan backwards
     (``csrc/linear_scan_bwd.cu``), on each route that takes a case (the chunk-parallel one training takes,
     the serial one), under autograd of the forward wrappers and forced,
     against their plain formulas and autograd of the plain forward, bf16
     and fp32, at rwkv6-3b's and jamba's training shapes (4 x 1,024), a
     ragged S, each forward route, a non-zero h0 with a final-state
     gradient, hard decays and the smoke widths (2e-2 of the largest
     gradient in bf16, 1e-4 in fp32), and on each route a CUDA-graph
     replay and a second call bit-equal to the first; RMSNorm and
     LayerNorm bit-equal to the expressions they
     replace;
  3. run the face-recognition StreamingPipeline on the card at the paper's
     1080p source, fused and unfused identify, with every launch counter
     set to 0 just before each run and read just after (every matmul
     launch must take the skinny route, every YUV decode the vec16 one),
     and check its detections and identities against the same pipeline
     on the CPU (plain versions);
  4. run device NMS on candidate batteries (counters zeroed just before)
     and check its keep lists against the host NMS, one IoU launch a call;
  5. for each served arch, llama3-8b (attention kernels), rwkv6-3b (the
     RWKV6 scan kernel), jamba-v0.1-52b (the Mamba scan kernel beside
     the attention kernels, MoE MLPs), qwen2.5-14b (q/k/v bias; decode at
     G = 5), chameleon-34b (q/k norm; G = 8), granite-moe-3b-a800m (40
     experts top-8, tied embeddings; flash and decode at D = 64, G = 3),
     gemma3-12b (five sliding-window layers with rolling caches to one
     global; flash and decode at D = 256, G = 2), qwen1.5-110b (G = 8)
     and deepseek-v2-236b (MLA: flash at D = 192, Dv = 128 on the CUDA
     cores, decode in plain einsums; 160 experts top-6 and 2 shared),
     serve its smoke config (float32) on
     the card and on the CPU with the same numpy-made weights (every leaf
     drawn at random): greedy token streams must agree between the two and
     between the continuous and slot schedulers;
  6. for each served arch, serve it at full width in bf16 on the card
     (weights drawn on the card from a seed), at full depth but for
     jamba-v0.1-52b, qwen1.5-110b and deepseek-v2-236b, whose depth is
     cut to what one card is measured to hold (printed as a listed
     reduction): one prefill and one decode step
     through the kernels against the same steps with the plain versions
     swapped in (for the attention-only archs also every layer's flash
     and decode call on its own bf16 inputs; for the scan archs every
     layer's scan on its own bf16 inputs; for the MoE and scan archs, and
     qwen2.5-14b, chameleon-34b, gemma3-12b and qwen1.5-110b, the whole
     step with float32 weights), then 16 requests (gemma3-12b one more
     of 1,536 tokens, past its window)
     through the continuous-batching engine (counters zeroed just before
     the run; the attention kernels must take their tensor-core routes
     once an attention layer for every prefill and every tick, but
     deepseek-v2-236b's decode kernel no launch at all (its flash at
     D = 192, Dv = 128 on the tensor-core route too), the RWKV6
     scan its chunked route once a layer for every prefill of
     CHUNK_MIN_S steps or more and its serial route once a layer for
     every shorter prefill and every tick, the Mamba scan its segmented
     route once a layer for every prefill of MAMBA_SEG_MIN_S steps or
     more, its step route once a layer for every tick and its serial
     route for the rest), with its throughput, TTFT, tax split, transfer
     ledger and the weight-streaming floor of a decode tick;
  7. time each kernel, its plain version and the matching PyTorch library
     call with CUDA events, beside the least time the card could take
     (decode attention, matmul, the YUV decode, the IoU and the Mamba scan
     also with a cold L2; each two-route scan's kernels side by side by
     S; the scan backwards at the training shapes, each route that takes
     them in the same run), and profile the
     device's busy share of a pipeline run (which must launch no second
     matmul pass) and of each arch's serve run; the matmul also at the
     cluster's replica batches (16, 32, 64 rows: the rows route, in turns
     with the tile route it replaced, forced); MLA's backward on its kv128
     route in turns with the split route it replaced, forced; the flash
     backward at the zoo's other training head shapes (phase 2's) beside
     SDPA's backward;
  8. run the serving cluster's default deployment (8 replicas, 4
     producers, 3 brokers, 1 drive) with real-service replicas on the card
     at S = 4 under each placement, matmul and YUV counters set to 0 after
     the stack's warm-up and read after the run: completed > 0.8 produced,
     not diverged, 0 < ai_fraction < 1, the broker's measured storage
     utilization within 0.25 rho + 0.05 of the closed form's rho (priced
     at the 6,912-byte crop each real-mode message carries), and every
     identify batch two matmul launches on its route and, under the device
     placement, one vec16 YUV launch; print the tails, five-way split,
     batch histogram and mean decode + identify span a batch; hold the
     card's replica path against a CPU stack with the card's weights
     (names equal, scores within 1e-5); bracket the closed-form knee
     (stable at 0.65x, diverged at 1.4x with a saturated broker and a p99
     above twice the stable one); print the live knee beside the DES knee
     and the closed form. The phase runs in a process of its own
     (``chip_smoke.py --cluster`` runs it alone): on the H100, after the
     serve phases in one process, the producers' mean lag at 0.65x the
     knee read 0.0005-0.0203 model s in five runs against its 0.0201
     limit, alone 0.0005-0.0010 in two;
  9. wrap the fused identify of 8 crops in the paper's ``TaxedStep`` on
     the card (pre: stacking and padding on the host; h2d; compute: the
     device program, two matmul launches; d2h; post: names) and print its
     five-way split: h2d and d2h bytes equal the stack's and the fetched
     outputs', two matmul launches a compute, names equal
     ``identify_crops``'s;
 10. serve whisper-large-v3 (an encoder-decoder) at full width in bf16
     (random weights from seed 0, ~1.6 B parameters) in lock step through
     ``Model.prefill`` and ``decode_step``: 8 rows of 1,500 stub frames,
     187-token prompts, a 448-token cache, 32 greedy steps. Every attention
     call of a prefill and a step is held against its plain version on its
     own inputs, the logits against the plain-ops step (bf16 at 5e-2, argmax
     equal; float32 at 1e-3); the counts set to 0 just before the timed run
     and read after require 1,120 flash launches on wgmma (encoder, causal
     prefill, cross attention, and each step's one-row cross attention) and
     32 x 32 decode launches at G = 1 on mma. It prints encode and prefill
     ms, decode tokens/s and ms a step against the step's floor (decoder
     weights and caches over 3.35 TB/s), peak memory and the device busy
     share (``--whisper`` runs it alone);
 11. train llama3-8b, rwkv6-3b, jamba-v0.1-52b, gemma3-12b,
     deepseek-v2-236b, whisper-large-v3, granite-moe-3b-a800m,
     qwen2.5-14b, chameleon-34b and qwen1.5-110b (all ten archs) at full
     width on the card (bf16 compute on float32 masters, 4 x 1,024-token
     TokenLoader batches, whisper's 4 x 1,500 stub frames from a seed and
     4 x 187 tokens, the reference's train geometry; AdamW as
     launch/train.py sets it) at the depth ``fit_train_depth`` measures
     (jamba's a prefix of its 8-layer pattern; deepseek-v2-236b one layer
     with its routed experts cut to the most that train, printed as
     ``reduced:``; whisper's encoder and decoder cut together): step 1
     against the plain-ops step (loss 1e-3, grad norm 1e-2
     relative; at a smaller depth, printed as ``reduced:``, where the plain
     step does not fit or is slow, TRAIN_STEP1_LAYERS; for the scan archs also every scan layer's backward
     kernel on its own inputs and incoming gradient against the plain
     formulas, and the grad norm held at TRAIN_GNORM_LAYERS where that is
     shallower, once the plain step is shown conditioned there,
     ``check_step1_at_fitting_depth``),
     every gradient leaf finite and non-zero (the key bias of an arch
     without RoPE, whisper's, zero in exact arithmetic, finite and at most
     2e-2 of the largest gradient instead; under RoPE, qwen's, as any
     leaf),
     20 Trainer steps whose loss
     must fall by 0.1, the forward and backward
     launches counted (each attention or scan layer's forward twice a step,
     whisper's three attention calls a decoder layer and one an encoder
     layer, on flash's wgmma, the chunked RWKV6 or the segmented Mamba
     route, and
     its backward once, flash's on the route of the arch's head widths,
     the scans' on their chunked routes),
     ms a step, tokens/s, model FLOP/s (attention counted by head widths),
     peak memory and the device's busy share over two profiled steps; then
     llama3-8b's checkpoint at step 10 restored bit-exactly and a restarted
     Trainer resuming at step 11, at one layer (at the fitted depth two
     checkpoints would write ~104 GB to disk); the scans' decode steps
     under grad must raise, and flash's backward in float32 at D = 256 and
     at bf16 widths no route takes (``--train`` runs the phase alone, after
     the attention and scan-backward checks). The flash backward kernel
     (wgmma for bf16 at D = Dv in {64, 128}, the split wgmma kernel for
     bf16 at (256, 256), the kv128 wgmma kernel for bf16 at (192, 128),
     mma.sync at other multiples of 16
     up to 128, the CUDA cores otherwise) is held against its plain
     formulas and autograd of the plain forward in phase 2 (2e-2 of the
     largest gradient in bf16, 1e-4 in fp32) and timed in phase 7 beside
     SDPA's backward (and the earlier mma.sync route where one exists);
 12. the cost model and autotune (``--cost`` runs it alone): for every
     shape of ``kernels.autotune``'s battery, every candidate launch plan
     of the matmul (skinny cluster and K chunk, tile K splits) and of
     decode attention (blocks along L) is held against the plain version
     (matmul at MATMUL_ATOL/RTOL, decode at ATTN_ATOL) and timed in two
     rounds, forward and reverse; a line a shape prints the formula's
     plan, the analytic pick the wrappers take and the measured best with
     their times, and the bound; the measured picks go to an overlay
     under ``build/``, never to the committed seed. Then
     ``roofline.analysis.count_step`` counts a llama3-8b decode tick (8
     slots, cache 2,048) and train step (4 x 1,024 tokens, phase 11's
     depth) on fake tensors, and its ``Roofline`` is printed beside the
     tick and step phases 6 and 11 measured ("not measured" alone), with
     the Amdahl sweep of its stage profile;
 13. sharding (``--shard`` runs it alone): on ``launch.mesh.make_host_mesh()``
     (a world of one over the card, ``nccl``) (a) llama3-8b at full width
     and ``fit_depth`` depth in bf16 serves 8 prompts of 512 tokens and 16
     greedy steps through ``serve_step.make_prefill`` and
     ``make_decode_step``: the tokens must equal bit for bit those of
     ``Model.prefill`` / ``decode_step`` called directly, and the counts
     set to 0 just before the serve-step run and read after require flash
     on wgmma once a layer and decode on mma once a layer a step;
     (b) one step of ``make_train_step(sh=make_train_shardings(...))`` at
     two layers (4 x 1,024 tokens, float32 masters): its loss must equal
     the unsharded step's and flash's backward kernel must run, every
     launch on its wgmma route; (c) the
     dry run, ``python -m repro_torch.launch.dryrun --arch llama3-8b
     --shape S`` for S in train_4k, prefill_32k and decode_32k, each in a
     child process on the host (a fake group of 512 ranks, the pod16x16
     mesh), started first so that it overlaps (a) and (b): each cell must
     report ``status`` ok, 256 chips, a per-device peak within the card's
     80 GB and collective bytes above 0; its Roofline and count seconds are
     printed (a count against ``roofline.hw``'s data sheet, not a
     measurement).

Each phase prints the wall seconds it took (each served arch's smoke,
full-width, profile and float32 steps too, and each trained arch's fit
and step-1 check).

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``. Without a CUDA device, or
without the rest of the repository beside it, the script exits non-zero
and prints no result.
"""
from __future__ import annotations

import collections
import contextlib
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks at a 700 W power limit, the port's one machine model
# (repro_torch.roofline.hw: NVIDIA's data sheet): HBM3 bytes/s, fp32 FLOP/s
# outside the tensor cores, dense bf16 and tf32 tensor-core FLOP/s; and the
# SFU's exponentials: 16 a clock an SM for compute capability 9.0 at 132 SMs
# and the 1.98 GHz boost clock.
from repro_torch.roofline.hw import (  # noqa: E402
    HBM_BW as PEAK_BYTES_S, PEAK_FLOPS_BF16 as PEAK_BF16_FLOP_S,
    PEAK_FLOPS_FP32 as PEAK_FP32_FLOP_S, PEAK_FLOPS_TF32 as PEAK_TF32_FLOP_S,
    PEAK_SFU_EXP_S as PEAK_SFU_S,
)
# a kernel's device time: ``iters`` calls captured in one CUDA graph, the
# graph replayed between CUDA events, the median of ``reps`` per-call times
# (the launch-plan autotuner's timer; replaying leaves out the host's
# launch overhead, see eager_time_ms)
from repro_torch.kernels.autotune import (  # noqa: E402
    device_time_ms as cuda_time_ms,
)

MATMUL_ATOL, MATMUL_RTOL = 1e-4, 1e-5
LETTERBOX_ATOL = 1e-3
RESIZE_ATOL = 1e-4
# attention kernels vs plain: fp32 differs only in summation order; bf16
# outputs are rounded to bf16 by both (one bf16 ulp is 2^-8 relative)
ATTN_ATOL = {"float32": 2e-5, "bfloat16": 2e-2}
# RWKV6 and Mamba scans vs plain, relative to the largest output: fp32
# differs only in summation order; in bf16 both sides round the output to
# bf16 (one ulp is 2^-8); the float32 state within 1e-5 of the largest
SCAN_RTOL = {"float32": 1e-5, "bfloat16": 1e-2}
STATE_RTOL = 1e-5
# full-width logits through the kernels vs the plain versions, relative to
# the largest logit: in bf16 for the dense attention archs (llama3-8b,
# qwen2.5-14b, chameleon-34b), and with float32 weights, where only fp32
# summation order differs, for rwkv6-3b, jamba, granite, qwen2.5-14b and
# chameleon-34b
LOGITS_RTOL = 5e-2
LOGITS_RTOL_F32 = 1e-3
# free memory left beside float32 weights drawn for a logits hold: the
# 512-token prefill's activations and the plain versions' fp32 scores
F32_MARGIN_BYTES = 4 << 30
# free memory a depth probe leaves beside the bf16 weights and the decode
# cache for its 1024-token prefill: it peaked 0.63-0.79 GB above them
# (jamba 24 layers, qwen1.5-110b 27, deepseek-v2-236b 10), and qwen1.5-110b
# at 28 layers, 0.93 GB under the free memory, ran out
FIT_MARGIN_BYTES = 1 << 30
# the archs whose float32 logits hold runs once their bf16 weights are
# freed, at the most repeats of the pattern that fit (check_f32_depth):
# jamba one repeat (two are ~106 GB), qwen2.5-14b whole (59.08 GB),
# chameleon-34b as deep as fits (137.17 GB whole), gemma3-12b whole
# (~47 GB), qwen1.5-110b and deepseek-v2-236b as deep as fits (deepseek's
# MoE routes compared first). The dense archs' bf16 holds pass at 5e-2;
# these hold the same steps where rounding does not drift
F32_AFTER = ("jamba-v0.1-52b", "qwen2.5-14b", "chameleon-34b", "gemma3-12b",
             "qwen1.5-110b", "deepseek-v2-236b")

# serve phase at full width, bf16, on the card, for each served arch
SERVE_ARCHS = ("llama3-8b", "rwkv6-3b", "jamba-v0.1-52b", "qwen2.5-14b",
               "chameleon-34b", "granite-moe-3b-a800m", "gemma3-12b",
               "qwen1.5-110b", "deepseek-v2-236b")
# the other GQA archs' (heads, kv heads, head width): decode pairs G = 5, 8
# at D = 128, G = 3 at D = 64 and G = 2 at D = 256; flash at D = 128, 64
# and 256
ZOO_HEADS = {"qwen2.5-14b": (40, 8, 128), "chameleon-34b": (64, 8, 128),
             "granite-moe-3b-a800m": (24, 8, 64),
             "qwen1.5-110b": (64, 8, 128), "gemma3-12b": (16, 8, 256)}
GEMMA_HEADS, GEMMA_W = ZOO_HEADS["gemma3-12b"], 1024
# a windowed arch's full-width serve run takes one more request of this
# many tokens (1.5 windows): its prefill runs flash's window mask with
# tiles skipped and rolls the last W keys into the cache, and its decode
# writes past the rolling cache's end
LONG_PROMPT = 1536
# deepseek-v2-236b's MLA prefill: 128 heads of D = qk_nope + qk_rope = 192
# against Dv = v_head = 128, scaled by 192 ** -0.5 (an MHA: KV = H)
MLA_H, MLA_D, MLA_DV = 128, 192, 128
MLA_SCALE = MLA_D ** -0.5
MLA_HEADS = (MLA_H, MLA_H, MLA_D)
# whisper-large-v3 served in lock step (phase 10): 8 rows of 1,500 stub
# frames, prompts of 1500 / dec_ratio = 187 tokens (the reference's own
# prefill shape, Model.input_specs), whisper's 448-token decoder context,
# 32 greedy steps; its MHA heads (20, 20, 64)
WHISPER = "whisper-large-v3"
WHISPER_B, WHISPER_PROMPT, WHISPER_CACHE, WHISPER_STEPS = 8, 187, 448, 32
WHISPER_HEADS = (20, 20, 64)
# training (phase 11): llama3-8b at full width, bf16 compute on float32
# masters, TokenLoader batches of 4 x 1,024 tokens, 20 steps of AdamW as
# launch/train.py sets it (lr 3e-3, warmup steps // 10) at the depth one
# card holds for training (fit_train_depth); then the checkpoint cycle
# (a checkpoint at step 10, a restarted Trainer from it to step 20) at
# TRAIN_CKPT_LAYERS: two checkpoints of float32 masters and moments at the
# fitted 15 layers would write ~104 GB to the machine's disk, more than the
# script may write in one run (45 GiB); at one layer they write 30.5 GB
TRAIN_ARCH, TRAIN_B, TRAIN_S, TRAIN_STEPS, TRAIN_CKPT = (
    "llama3-8b", 4, 1024, 20, 10)
# the archs phase 11 trains the same way: llama3-8b (flash and its
# backward), rwkv6-3b and jamba-v0.1-52b (the scans and their backwards;
# jamba's fitted depth a prefix of its 8-layer pattern), gemma3-12b (flash
# and its split backward at D = 256, sliding windows) and deepseek-v2-236b
# (MLA's (192 | 128) on the same split backward; one layer, its routed
# experts cut to what the card trains, fit_train_depth), whisper-large-v3
# (an encoder-decoder: frames batches, FramesLoader; its encoder, decoder
# and cross attention on the wgmma backward at D = 64) and
# granite-moe-3b-a800m (GQA 24 | 8 at D = 64, 40 experts top-8, a tied
# embedding), qwen2.5-14b (q/k/v biases under RoPE, GQA 40 | 8),
# chameleon-34b (q/k norm scales, 64 | 8) and qwen1.5-110b (q/k/v biases,
# 64 | 8, 8,192 wide, a 152,064-token untied vocabulary: one layer)
TRAIN_ARCHS = (TRAIN_ARCH, "rwkv6-3b", "jamba-v0.1-52b", "gemma3-12b",
               "deepseek-v2-236b", WHISPER, "granite-moe-3b-a800m",
               "qwen2.5-14b", "chameleon-34b", "qwen1.5-110b")
# routed experts fit_train_depth steps down by where not one layer with all
# of them trains on the card (deepseek-v2-236b's 160 at 23.6 M parameters
# each: one layer holds 5.02 B, 80.3 GB at 16 bytes a parameter)
TRAIN_EXPERT_STEP = 16
# card memory a fitted step's peak must leave unallocated for the Trainer's
# run: at 135 of deepseek-v2-236b's experts one step peaked at 83.70 GB of
# 85.02 and the Trainer's next step ran out of memory at an AdamW
# temporary of one expert stack (4.25 GB) with 1.5 GB reserved but
# unallocated. AdamW's temporaries of a whole leaf did the same to
# qwen1.5-110b's one layer, whose step peaked at 77.70 GB, inside the
# headroom (4.64 GiB asked, 6.57 GiB reserved in pieces): AdamW updates a
# large leaf in slices of 256 MiB (train/optimizer.py, UPDATE_CHUNK)
TRAIN_PEAK_HEADROOM_BYTES = 6 << 30
TRAIN_CKPT_LAYERS = 1
# card memory a training depth needs beyond 16 bytes a parameter (float32
# param, grad, m, v): the chunked loss's float32 logits (4 x 512 x 128,256,
# 1.05 GB, and their softmax), the bf16 embedding and head (1.05 GB each),
# one layer's rematerialised activations and AdamW's temporaries of one
# slice of a leaf (llama3-8b's 15 layers peak 3.2 GB above their 16 bytes
# a parameter; gemma3-12b's 262,144-row tied embedding makes its logits
# chunk 2.1 GB, and its 12 layers peak 7.3 GB above)
TRAIN_MARGIN_BYTES = 12 << 30
# AdamW's learning rate in phase 11: launch/train.py's default (its
# --lr), and for the archs 8,192 wide that default scaled by llama3-8b's
# width over theirs (3e-3 x 4,096 / 8,192). AdamW moves every element of a
# matrix by about lr a step, so a logit, a sum over d_model of them, by
# about lr x d_model: at 3e-3 chameleon-34b's loss rose from 11.57 to
# 27.4 by step 11 and qwen1.5-110b's from 12.44 to 20.7, through the
# kernels and through the plain versions alike (the two curves within
# 1.8e-2 of each other), and neither fell by 0.1 in 20 steps; at 1.5e-3
# they fell from 11.47 to 8.59 and from 13.30 to 8.76
# (scripts/train_curves.py, PERF.md section 6)
TRAIN_LR_DEFAULT = 3e-3
TRAIN_LR = {"chameleon-34b": 1.5e-3, "qwen1.5-110b": 1.5e-3}
# step 1 through the kernels against the same step with the plain versions
TRAIN_LOSS_RTOL, TRAIN_GNORM_RTOL = 1e-3, 1e-2
# the relative change of the token embedding that probes whether a scan
# arch's plain grad norm is conditioned (grad_norm_moves)
TRAIN_PROBE_EPS = 1e-6
# the depth at which a scan arch's step-1 grad norm is held to the plain
# step's, where shallower than the fitted one (others: the fitted depth):
# random-init rwkv6-3b's plain grad norm moves 4.8 at 32 layers, 0.47 at
# 16, 0.035 at 8 and 4, and 8.5e-4 at 2 under a 1e-6 change of the
# embedding (grad_norm_moves, PERF.md section 6)
TRAIN_GNORM_LAYERS = {"rwkv6-3b": 2}
# the depth at which an arch's step 1 (loss, leaves, each scan layer's
# backward kernel on its own inputs) is held against the plain step, where
# shallower than the fitted one: rwkv6-3b's plain step runs its scan as a
# loop of 1,024 steps a layer under autograd, and at all 32 layers the
# check took 95.2 s of the script's 1,200 (PERF.md section 6); its 20
# Trainer steps still run at the fitted depth
TRAIN_STEP1_LAYERS = {"rwkv6-3b": 8}
# flash backward vs its plain formulas and autograd of the plain forward,
# relative to the largest gradient: fp32 differs in summation order (and
# dQ's atomic order); bf16 inputs see the forward's P rounded to bf16
BWD_RTOL = {"float32": 1e-4, "bfloat16": 2e-2}
# where the checkpoint cycle writes: inside the checkout (gitignored)
TRAIN_CKPT_DIR = ROOT / "build" / "train_ckpt"
# the tensor-core instructions in the kernel libraries' SASS (attention and
# the chunked RWKV6 scan), and the route each attention kernel must take on
# the full-width serve path: one launch an attention layer for every
# prefill (flash) and every decode tick (decode)
TC_SASS = {"flash_attention": "HGMMA", "decode_attention": "HMMA",
           "linear_scan": "HMMA", "flash_attention_bwd": "HGMMA"}
TC_GATES = {"flash_attention": ("wgmma", "prefills"),
            "decode_attention": ("mma", "ticks")}
# an MLA arch (deepseek-v2-236b): flash at D = 192 != Dv = 128 takes the
# tensor-core route too; its decode is the absorbed-matrix attention over
# the latent, plain einsums in both packages (the reference has no kernel
# of it), so the decode kernel must launch no time on its path
MLA_GATES = {"flash_attention": ("wgmma", "prefills"),
             "decode_attention": (None, "ticks")}
# kernel instantiations whose ptxas report must show no spill: the MLA
# forward at (192, 128), the wgmma backward at both widths, the split
# backward at gemma3's and MLA's, MLA's kv128 backward and the matmul's
# rows kernel
NO_SPILL = ("flash_wgmma_kernelILi192ELi128E", "flash_bwd_wgmma_kernelILi64E",
            "flash_bwd_wgmma_kernelILi128E",
            "flash_bwd_split_kernelILi256ELi256E",
            "flash_bwd_split_kernelILi192ELi128E", "flash_bwd_kv128_kernel",
            "matmul_rows_kernel")
SERVE_SLOTS, SERVE_CACHE_LEN, SERVE_REQUESTS, SERVE_MAX_TOKENS = 8, 2048, 16, 32
# bytes read between calls to time a kernel with a cold (50 MB) L2
L2_FLUSH_BYTES = 128 << 20
# NMS batteries (candidates per call; device NMS pads each to its pow2
# bucket, so the path's IoU sizes are 32, 256, 1024 and 4096), IoU sizes
# with a ragged tile or scalar stores, and the attention shapes of the path
NMS_SIZES = (32, 256, 1000, 4096)
IOU_RAGGED = (1, 33, 65, 1001, 1024)
FLASH_SEQS = (16, 37, 512, 1024)
FLASH_RAGGED = (130, 1000)               # no multiple of any tile
DECODE_LENS = (768, 2048)
DECODE_RAGGED = (2047, 50)
LLAMA_H, LLAMA_KV, LLAMA_D = 32, 8, 128
RWKV_H, RWKV_K = 40, 64                  # rwkv6-3b's heads and head width
RWKV_PREFILL, RWKV_DECODE_B = 1024, SERVE_SLOTS
# the chunked route's checks: the prefill length and lengths no chunk (64)
# or sub-chunk (16) divides
RWKV_CHUNK_SEQS = (RWKV_PREFILL, 37, 64, 65, 130, 1000)
# jamba-v0.1-52b's Mamba layers: d_inner 8192, state 16 (smoke: 128, 4)
MAMBA_DI, MAMBA_N = 8192, 16
MAMBA_PREFILL, MAMBA_DECODE_B = 1024, SERVE_SLOTS

# 1080p source, as the paper's (repro/data/video.py), resized 2:1 for detection
SRC_H, SRC_W = 1080, 1920
# the YUV decode's checks beyond all triples: (shape, byte offset of the
# input in its buffer, the route it takes)
YUV_CASES = (((1, 3, SRC_H, SRC_W), 0, "vec16"), ((2, 3, SRC_H, SRC_W), 0, "vec16"),
             ((3, 3, 6, 10), 0, "vec4"), ((1, 3, SRC_H, SRC_W), 4, "vec4"),
             ((1, 3, 7, 13), 0, "scalar"), ((2, 3, 8, 16), 1, "scalar"))
# identify batches on the face path are pow2-bucketed and at most batch_size
FACE_BATCHES = (1, 3, 8)
# the TaxedStep phase: crops a fused identify step, logged steps
TAXED_CROPS, TAXED_STEPS = 8, 20
# the skinny matmul route's row counts held against the plain version
SKINNY_CHECK_M = (1, 2, 3, 4, 8)
# the serving cluster's replicas drain a partition in one fetch and pad the
# batch to its power of two: the rows its tile-route products are timed at
CLUSTER_BATCHES = (16, 32, 64)
# the cluster phase: the reference's default deployment (8 replicas, 4
# producers, 3 brokers, 1 drive, 6 model seconds at time compression 4)
# with real service on the card, at S = 4 under each placement; then the
# bracket at these multiples of the closed-form knee and the live knee.
# A real-mode message carries its 48x48x3 crop (6,912 bytes) to the broker,
# not the workload's modelled 37,300-byte face, so the closed form that
# prices these runs is the workload's at the wire payload
CLUSTER_S = 4.0
CLUSTER_PLACEMENTS = ("device", "host")
CLUSTER_BRACKET = (0.65, 1.4)
# the bracket and the knee probe up to 2x the knee, where the four producer
# threads, beside eight replica threads on the host, fall behind their
# schedule (on the card at compression 2, 0.65x the knee
# produced 5,016 of 5,954 messages and diverged by producer lag); at 1 the
# same model-time load takes a quarter of the default's wall rate. The
# closed form does not see the compression; a real-service batch's model
# time is its wall time times the compression, so the replicas look
# faster, and they are not the resource that binds
CLUSTER_KNEE_COMPRESSION = 1.0
# the argument that runs phase 8 alone, and the seconds its process may take
CLUSTER_ONLY, CLUSTER_TIMEOUT_S = "--cluster", 600
# where phase 8's process leaves the matmul's launches by route over its
# two S = 4 runs, for the kernels line of the process that started it
CLUSTER_LAUNCHES = ROOT / "build" / "cluster_launches.json"
# the arguments that run phase 10 (whisper) or phase 11 (training) alone,
# after the build and the kernel checks of their kernels
WHISPER_ONLY, TRAIN_ONLY, COST_ONLY = "--whisper", "--train", "--cost"
SHARD_ONLY = "--shard"
# phase 13 (sharding): the serve-step run's prompts, prompt length and
# greedy steps, the sharded train step's depth, and the dry-run cells
SHARD_PROMPTS, SHARD_PROMPT_LEN, SHARD_STEPS = 8, 512, 16
SHARD_TRAIN_LAYERS = 2
DRYRUN_SHAPES = ("train_4k", "prefill_32k", "decode_32k")
DRYRUN_OUT = ROOT / "build" / "dryrun"
DRYRUN_TIMEOUT_S = 600
# the measured picks of phase 12's sweep (never the committed seed), and the
# overlay that takes the analytic picks of shapes outside the seed
MEASURED_PLANS = ROOT / "build" / "autotune_measured.json"
# every candidate's two timings of phase 12's sweep, the data the analytic
# model's constants are fitted to
PLAN_SWEEP = ROOT / "build" / "plan_sweep.json"
AUTOTUNE_OVERLAY = ROOT / "build" / "autotune_overlay.json"
# the speed-ups of phase 12's Amdahl sweep
AMDAHL_SPEEDUPS = (1, 2, 4, 8, 16, 64)
# card vs CPU identify of the same crops: fp32 throughout, the products'
# summation order differs
CLUSTER_SCORE_ATOL = 1e-5
# (K, N, epilogue) of the path's three products: fused layer 1, layer 2,
# and the unfused Embedder's layer 1
MATMUL_SHAPES = ((48 * 48 * 3, 256, "tanh"), (256, 128, "none"),
                 (32 * 32 * 3, 256, "none"))


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


@contextlib.contextmanager
def phase(name: str):
    """Print the wall seconds a phase took when it ends (a phase that
    raises prints nothing: the failure ends the script)."""
    t0 = time.perf_counter()
    yield
    print(f"phase {name}: {time.perf_counter() - t0:.1f} s")


DeviceTime = collections.namedtuple(
    "DeviceTime", "key self_device_time_total count")


def device_times(prof) -> list:
    """A finished ``torch.profiler.profile``'s device activity (kernels,
    copies, sets) by name, as ``key_averages()``'s CUDA entries give it:
    :class:`DeviceTime` (name, µs, count), each event's duration summed.
    Read from the profiler's raw events: key_averages() first builds a
    Python event for every record, tens of µs apiece, and over the tens of
    thousands of launches of a host-bound serve or training run that took
    most of each profile's 10-35 s."""
    from torch.autograd import DeviceType
    us, n = collections.Counter(), collections.Counter()
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and not e.is_async():
            us[e.name()] += e.duration_ns() / 1e3
            n[e.name()] += 1
    return [DeviceTime(k, us[k], n[k]) for k in us]


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def bound_ms(nbytes: float, flops: float,
             peak_flop_s: float = PEAK_FP32_FLOP_S,
             exps: float = 0.0) -> tuple[float, str]:
    """The least time for the work: the larger of the bytes over the memory
    rate and the operations over their peak, the operations' time the
    larger of the FLOP's and of the SFU's exponentials (other units)."""
    t_bytes = nbytes / PEAK_BYTES_S
    t_ops = max(flops / peak_flop_s, exps / PEAK_SFU_S)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def cold_time_ms(fn, scratch, iters: int = 20, reps: int = 11) -> float:
    """Device time of one call with a cold L2: ``scratch`` (float32, larger
    than the 50 MB L2) is read through before each call, so the L2 holds
    only its clean lines and the call pays no write-back of dirty ones.
    ``iters`` (read, call) pairs are captured in one CUDA graph and
    ``iters`` reads alone in another; after a replay of each, the two are
    replayed in turn between CUDA events ``reps`` times, and the median
    of the differences over ``iters`` is returned, so the call's launch is
    amortised as in ``cuda_time_ms`` and the reads' time drops out."""
    import torch
    sink = torch.empty((), dtype=scratch.dtype, device=scratch.device)

    def flush():
        torch.sum(scratch, 0, out=sink)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            flush()
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    pairs, reads = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
    with torch.cuda.graph(pairs):
        for _ in range(iters):
            flush()
            fn()
    with torch.cuda.graph(reads):
        for _ in range(iters):
            flush()

    def replay_ms(graph):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)
    replay_ms(pairs)
    replay_ms(reads)
    return statistics.median(replay_ms(pairs) - replay_ms(reads)
                             for _ in range(reps)) / iters


def eager_time_ms(fn, iters: int = 200) -> float:
    """Time per call of back-to-back eager calls, between CUDA events: the
    larger of the device time and the host's cost of one call."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# --------------------------------------------------------------------------
# Inputs at the path's shapes (seeded on the host, then moved)
# --------------------------------------------------------------------------

def _gen(seed: int):
    import torch
    return torch.Generator().manual_seed(seed)


def matmul_inputs(M, K, N, bias, device, seed=0):
    import torch
    g = _gen(seed)
    a = torch.randn((M, K), generator=g).to(device)
    b = (torch.randn((K, N), generator=g) / K**0.5).to(device)
    c = torch.randn((N,), generator=g).to(device) if bias else None
    return a, b, c


def all_yuv_triples(device):
    """Every (y, u, v) triple once, as one planar 4096 x 4096 frame."""
    import torch
    idx = torch.arange(1 << 24, device=device, dtype=torch.int32)
    planes = torch.stack([idx >> 16, (idx >> 8) & 255, idx & 255])
    return planes.to(torch.uint8).reshape(1, 3, 4096, 4096)


def letterbox_inputs(H, W, out_h, out_w, device, seed=0):
    """Planes (3, H, W) uint8, the letterbox's tap tables as the device
    path uploads them, per-plane [scale, offset] and the geometry."""
    import torch
    from repro_torch.preprocess import device as pp_device
    from repro_torch.preprocess import host
    g = _gen(seed)
    planes = torch.randint(0, 256, (3, H, W), generator=g,
                           dtype=torch.uint8).to(device)
    taps_y, taps_x = pp_device._letterbox_operators(H, W, out_h, out_w,
                                                    str(device))
    sb = torch.stack([torch.rand(3, generator=g) + 0.5,
                      torch.randn(3, generator=g)], dim=1)
    return (planes, taps_y, taps_x, sb.to(device),
            host.letterbox_geometry(H, W, out_h, out_w))


def resize_inputs(shape, device, seed=0):
    import torch
    return (torch.rand(shape, generator=_gen(seed)) * 255).to(device)


def box_battery(n: int, seed: int):
    """n candidate boxes and scores with ties: corners on a coarse grid (so
    boxes repeat exactly and IoUs tie), every 7th box of zero height, and
    scores on 16 levels."""
    import numpy as np
    rng = np.random.default_rng(seed)
    y0 = rng.integers(0, 24, n) * 4.0
    x0 = rng.integers(0, 24, n) * 4.0
    h = rng.choice([4.0, 8.0, 12.0], n)
    w = rng.choice([4.0, 8.0, 12.0], n)
    boxes = np.stack([y0, x0, y0 + h, x0 + w], axis=1).astype(np.float32)
    boxes[::7, 2] = boxes[::7, 0]
    scores = (rng.integers(0, 16, n) / 16.0).astype(np.float32)
    return boxes, scores


def dense_boxes(n: int, seed: int):
    """n boxes that all overlap (corners in [0, 8), sides in [8, 16)), so
    that every IoU is a division; scores uniform."""
    import numpy as np
    rng = np.random.default_rng(seed)
    y0, x0 = rng.random(n) * 8, rng.random(n) * 8
    h, w = 8 + rng.random(n) * 8, 8 + rng.random(n) * 8
    boxes = np.stack([y0, x0, y0 + h, x0 + w], axis=1).astype(np.float32)
    return boxes, rng.random(n).astype(np.float32)


def attn_inputs(Sq, Skv, dtype, device, seed=0,
                heads=(LLAMA_H, LLAMA_KV, LLAMA_D), Dv=None, B=1):
    """q (B, Sq, H, D), k (B, Skv, KV, D) and v (B, Skv, KV, Dv, default
    D) for ``heads`` = (H, KV, D), llama3-8b's by default."""
    import torch
    H, KV, D = heads
    g = _gen(seed)
    q = torch.randn((B, Sq, H, D), generator=g)
    k = torch.randn((B, Skv, KV, D), generator=g)
    v = torch.randn((B, Skv, KV, Dv or D), generator=g)
    return tuple(t.to(device, dtype) for t in (q, k, v))


def decode_inputs(L, dtype, device, seed=0, B=SERVE_SLOTS,
                  heads=(LLAMA_H, LLAMA_KV, LLAMA_D)):
    """q (B, 1, H, D), caches (B, L, KV, D) for ``heads`` = (H, KV, D),
    llama3-8b's by default, and kv_len (B,) int32 drawn from 0..L, its
    first three rows 0, 1 and L."""
    import numpy as np
    import torch
    H, KV, D = heads
    g = _gen(seed)
    q = torch.randn((B, 1, H, D), generator=g)
    k = torch.randn((B, L, KV, D), generator=g)
    v = torch.randn((B, L, KV, D), generator=g)
    lens = np.random.default_rng(seed).integers(0, L + 1, B).astype(np.int32)
    lens[:3] = (0, 1, L)
    return (*(t.to(device, dtype) for t in (q, k, v)),
            torch.from_numpy(lens).to(device))


def scan_inputs(B, S, dtype, device, seed=0, H=RWKV_H, K=RWKV_K):
    """r, w, k, v (B, S, H, K), u (H, K), h0 (B, H, K, K): decays
    exp(-exp(N(0, 1))) spanning (0, 1), a non-zero bonus u; w and h0 in
    float32, the rest in ``dtype``, as the model feeds the scan."""
    import torch
    g = _gen(seed)
    r = torch.randn((B, S, H, K), generator=g)
    w = torch.exp(-torch.exp(torch.randn((B, S, H, K), generator=g)))
    k = torch.randn((B, S, H, K), generator=g) * 0.3
    v = torch.randn((B, S, H, K), generator=g)
    u = torch.randn((H, K), generator=g) * 0.5
    h0 = torch.randn((B, H, K, K), generator=g) * 0.1
    return (r.to(device, dtype), w.to(device), k.to(device, dtype),
            v.to(device, dtype), u.to(device, dtype), h0.to(device))


def mamba_inputs(B, S, dtype, device, seed=0, Di=MAMBA_DI, N=MAMBA_N):
    """delta (B, S, Di) = softplus(N(0, 1)), A (Di, N) = -exp(N(0, 0.5)),
    Bt, Ct (B, S, N), x (B, S, Di), h0 (B, Di, N): A and h0 in float32, the
    rest in ``dtype``, as the model feeds the scan."""
    import torch
    g = _gen(seed)
    delta = torch.nn.functional.softplus(torch.randn((B, S, Di), generator=g))
    A = -torch.exp(0.5 * torch.randn((Di, N), generator=g))
    Bt = torch.randn((B, S, N), generator=g)
    Ct = torch.randn((B, S, N), generator=g)
    x = torch.randn((B, S, Di), generator=g)
    h0 = 0.5 * torch.randn((B, Di, N), generator=g)
    return (delta.to(device, dtype), A.to(device), Bt.to(device, dtype),
            Ct.to(device, dtype), x.to(device, dtype), h0.to(device))


# --------------------------------------------------------------------------
# Phase 2: each kernel against its plain version on the card
# --------------------------------------------------------------------------

def check_kernels(device) -> dict[str, float]:
    """Max abs error per kernel over its checks; raises on a disagreement."""
    import torch
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import preproc, resize
    err = {}

    worst = rows_worst = 0.0
    # the skinny route at the path's three products, a ragged one with bias
    # and tanh; the rows route at the cluster's two products and batches,
    # ragged (M, K and N off its tiles: its scalar copies) and with bias;
    # the tile route ragged with its K split and unsplit
    cases = [(M, K, N, epi, False) for K, N, epi in MATMUL_SHAPES
             for M in SKINNY_CHECK_M]
    cases += [(5, 200, 37, "tanh", True), (8, 48 * 48 * 3, 256, "tanh", True)]
    cases += [(M, K, N, epi, False) for K, N, epi in MATMUL_SHAPES[:2]
              for M in CLUSTER_BATCHES]
    cases += [(13, 200, 37, "tanh", True), (33, 3072, 256, "none", True),
              (64, 48 * 48 * 3, 256, "tanh", True),
              (100, 200, 37, "tanh", True), (2048, 256, 256, "tanh", True)]
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    for M, K, N, epi, bias in cases:
        a, b, c = matmul_inputs(M, K, N, bias, device)
        route = mm._route(M)
        n = mm.matmul.launches_by_route[route]
        got = mm.matmul(a, b, bias=c, epilogue=epi)
        again = mm.matmul(a, b, bias=c, epilogue=epi)
        want = mm.matmul_plain(a, b, bias=c, epilogue=epi)
        e = (got - want).abs().max().item()
        plan = f"plan {mm.matmul.last_plan}"
        same = bool(torch.equal(got, again))
        print(f"check matmul ({route} route) ({M},{K})@({K},{N}) bias={bias} "
              f"{epi} {plan}: max_abs_err={e:.3e}; repeat bit-equal: {same}")
        require(mm.matmul.launches_by_route[route] == n + 2,
                f"matmul ({M},{K},{N}): the {route} route did not launch")
        require(torch.allclose(got, want, atol=MATMUL_ATOL, rtol=MATMUL_RTOL),
                f"matmul ({M},{K},{N}) disagrees: {e}")
        require(same, f"matmul ({M},{K},{N}): a repeat differs")
        if route == "rows":
            rows_worst = max(rows_worst, e)
        else:
            worst = max(worst, e)
    require(mm.split_k(100, 37, 200, n_sm)[0] > 1
            and mm.split_k(2048, 256, 256, n_sm)[0] == 1,
            "the tile route's checks must cover a split and an unsplit K")
    # the skinny and rows routes replayed in a CUDA graph: the same bits
    for M in (8, 64):
        a, b, c = matmul_inputs(M, 48 * 48 * 3, 256, True, device, seed=1)
        same = replays_equal(lambda: mm.matmul(a, b, bias=c, epilogue="tanh"),
                             lambda: a.mul_(-1.0))
        print(f"check matmul ({mm._route(M)} route) ({M},6912)@(6912,256) "
              f"tanh, 3 CUDA-graph replays: bit-equal to the eager calls: "
              f"{same}")
        require(same, f"matmul: a CUDA-graph replay of the {mm._route(M)} "
                "route differs")
    err["matmul"] = worst
    err["matmul_rows"] = rows_worst

    err["yuv_to_rgb"] = check_yuv(device)

    worst = 0.0
    # the path's 1080p geometry, a small one, a padded one, and an upscale
    # to a ragged width (scalar stores, pad rows)
    for H, W, oh, ow, pad in ((SRC_H, SRC_W, SRC_H // 2, SRC_W // 2, 0.0),
                              (216, 384, 108, 192, 0.0),
                              (SRC_H, SRC_W, 512, 512, -1.0),
                              (20, 30, 61, 67, 0.5)):
        planes, ty, tx, sb, geom = letterbox_inputs(H, W, oh, ow, device)
        got = preproc.letterbox_normalize(planes, ty, tx, sb, geom,
                                          pad_value=pad)
        want = preproc.letterbox_normalize_plain(planes, ty, tx, sb, geom,
                                                 pad_value=pad)
        e = (got - want).abs().max().item()
        print(f"check letterbox_normalize {H}x{W}->{oh}x{ow} pad={pad}: "
              f"max_abs_err={e:.3e}")
        require(e <= LETTERBOX_ATOL, f"letterbox {H}x{W}->{oh}x{ow}: {e}")
        worst = max(worst, e)
    err["letterbox_normalize"] = worst

    worst = 0.0
    for shape, oh, ow in (((8, 48, 48, 3), 32, 32), ((3, 50, 70, 3), 21, 33),
                          ((2, 5, 16, 16, 1), 24, 8)):
        img = resize_inputs(shape, device)
        got = resize.resize_bilinear(img, oh, ow)
        want = resize.resize_bilinear_plain(img, oh, ow)
        e = (got - want).abs().max().item()
        print(f"check resize_bilinear {shape}->({oh},{ow}): "
              f"max_abs_err={e:.3e}")
        require(e <= RESIZE_ATOL, f"resize {shape}->({oh},{ow}): {e}")
        worst = max(worst, e)
    err["resize_bilinear"] = worst
    torch.cuda.synchronize()
    return err


def check_yuv(device) -> float:
    """The YUV kernel exact on every route: all 2^24 triples and 1080p
    (vec16), frames of 4k but not 16k pixels or a 4-byte-offset input
    (vec4), ragged frames or a 1-byte offset (scalar), strided views
    (copied by the wrapper, then on the copy's route); then bit-equal
    across 3 CUDA-graph replays at 1080p. Returns the max abs error."""
    import torch
    from repro_torch.kernels import preproc
    wrapper = preproc.yuv_to_rgb
    cases = [("all 2^24 triples", all_yuv_triples(device), "vec16")]
    for shape, offset, route in YUV_CASES:
        n = math.prod(shape)
        buf = torch.randint(0, 256, (n + offset,), generator=_gen(n),
                            dtype=torch.uint8).to(device)
        cases.append((f"{shape} at byte offset {offset}",
                      buf[offset:].view(shape), route))
    frames = torch.randint(0, 256, (1, 6, SRC_H, SRC_W), generator=_gen(6),
                           dtype=torch.uint8).to(device)
    cases += [(f"(1, 3, {SRC_H}, {SRC_W}) strided, every other plane of 6",
               frames[:, 1::2], "vec16"),
              ("(1, 3, 7, 13) strided, a crop of all triples",
               cases[0][1][:, :, :7, :13], "scalar")]
    worst = 0.0
    for name, yuv, route in cases:
        n = wrapper.launches_by_route[route]
        got, want = wrapper(yuv), preproc.yuv_to_rgb_plain(yuv)
        n_bad = int((got != want).sum().item())
        print(f"check yuv_to_rgb {name} ({route} route): {n_bad} channel "
              f"values differ (tolerance: exact)")
        require(wrapper.launches_by_route[route] == n + 1,
                f"yuv_to_rgb {name}: the {route} route did not launch")
        require(n_bad == 0, f"yuv_to_rgb {name} differs on {n_bad} values")
        worst = max(worst, float((got.int() - want.int()).abs().max().item()))
    yuv = cases[1][1]
    same = replays_equal(lambda: wrapper(yuv), lambda: yuv.random_(0, 256))
    print(f"check yuv_to_rgb {tuple(yuv.shape)} (vec16 route), 3 CUDA-graph "
          f"replays on new frames: bit-equal to the eager calls: {same}")
    require(same, "yuv_to_rgb: a CUDA-graph replay differs")
    return worst


def replays_equal(fn, perturb, n: int = 3) -> bool:
    """``fn`` captured in a CUDA graph after a warm-up; ``n`` times the
    inputs are changed in place by ``perturb``, then the eager call and a
    replay must give the same bits."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = fn()
    same = True
    for _ in range(n):
        perturb()
        eager = fn()
        graph.replay()
        torch.cuda.synchronize()
        same = same and bool(torch.equal(captured, eager))
    return same


def check_serve_kernels(device) -> dict[str, float]:
    """The IoU, flash and decode kernels against their plain versions."""
    import torch
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import preproc
    err = {}

    for n in NMS_SIZES + IOU_RAGGED:
        for kind, battery in (("ties, zero-area boxes", box_battery),
                              ("every pair overlapping", dense_boxes)):
            boxes, _ = battery(n, seed=n)
            bt = torch.from_numpy(boxes.T.copy()).to(device)
            before = preproc.iou_matrix.launches
            got, want = preproc.iou_matrix(bt), preproc.iou_matrix_plain(bt)
            n_bad = int((got != want).sum().item())
            n_asym = int((got != got.T).sum().item())
            print(f"check iou_matrix N={n} ({kind}): {n_bad} of {n * n} "
                  f"values differ (tolerance: exact); {n_asym} differ from "
                  f"their transpose")
            require(preproc.iou_matrix.launches == before + 1,
                    f"iou_matrix N={n}: the kernel did not launch")
            require(n_bad == 0 and n_asym == 0,
                    f"iou_matrix N={n} differs on {n_bad} values, {n_asym} "
                    f"from its transpose")
    boxes, _ = box_battery(4096, seed=7)
    bt = torch.from_numpy(boxes.T.copy()).to(device)
    same = replays_equal(lambda: preproc.iou_matrix(bt),
                         lambda: bt.copy_(bt[:, torch.randperm(
                             4096, device=device)]))
    print(f"check iou_matrix N=4096, 3 CUDA-graph replays on permuted "
          f"boxes: bit-equal to the eager calls: {same}")
    require(same, "iou_matrix: a CUDA-graph replay differs")
    err["iou_matrix"] = 0.0

    # flash: llama3-8b's heads at the path's lengths and ragged ones (bf16
    # on the wgmma route, fp32 on the CUDA-core one), then the smoke
    # configs' D = 16, the CUDA-core route in both dtypes
    worst = 0.0
    cases = [(S, S, {}) for S in FLASH_SEQS]
    cases += [(1024, 1024, {"window": 256}),          # sliding window
              (128, 640, {"q_offset": 512})]          # a chunk after a prefix
    ragged = [(S, S, {}) for S in FLASH_RAGGED]
    ragged += [(1000, 1000, {"window": 100}), (130, 300, {"q_offset": 170}),
               (130, 130, {"causal": False}), (1000, 1000, {"causal": False})]
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[1]
        for Sq, Skv, kw in cases + (ragged if dtype == torch.bfloat16 else []):
            q, k, v = attn_inputs(Sq, Skv, dtype, device)
            worst = max(worst, _check_flash(fa, q, k, v, name, kw))
        q, k, v = (t[..., :16].contiguous() for t in
                   attn_inputs(100, 100, dtype, device))
        worst = max(worst, _check_flash(fa, q, k, v, name, {}))
        # the other attention archs' heads (granite's D = 64 on the wgmma
        # route in bf16) at a prefill length, a ragged one and a window
        for heads in ZOO_HEADS.values():
            for S, kw in ((512, {}), (1000, {}), (1000, {"window": 100})):
                q, k, v = attn_inputs(S, S, dtype, device, heads=heads)
                worst = max(worst, _check_flash(fa, q, k, v, name, kw))
        # gemma3-12b's prefill at its window and without, and past the
        # window (tiles left of it skipped); deepseek-v2's MLA prefill
        for S, kw in ((1024, {"window": GEMMA_W}), (1024, {}),
                      (LONG_PROMPT, {"window": GEMMA_W})):
            q, k, v = attn_inputs(S, S, dtype, device, heads=GEMMA_HEADS)
            worst = max(worst, _check_flash(fa, q, k, v, name, kw))
        # (the MLA route at every prompt length of the checks, ragged
        # ones included: the tensor-core route in bf16)
        for S in FLASH_SEQS + FLASH_RAGGED:
            q, k, v = attn_inputs(S, S, dtype, device,
                                  heads=(MLA_H, MLA_H, MLA_D), Dv=MLA_DV)
            worst = max(worst, _check_flash(fa, q, k, v, name,
                                            {"scale": MLA_SCALE}))
        # whisper's: the encoder's 8 x 1,500 frames (non-causal, a
        # 1,500-key ragged tail), the decoder's cross attention of the
        # 187-token prompt and of one decode row against them, and its
        # causal prefill
        for Sq, Skv, kw in ((1500, 1500, {"causal": False}),
                            (WHISPER_PROMPT, 1500, {"causal": False}),
                            (1, 1500, {"causal": False}),
                            (WHISPER_PROMPT, WHISPER_PROMPT, {})):
            q, k, v = attn_inputs(Sq, Skv, dtype, device, heads=WHISPER_HEADS,
                                  B=WHISPER_B)
            worst = max(worst, _check_flash(fa, q, k, v, name, kw))
    err["flash_attention"] = worst

    # decode: llama3-8b's heads (bf16 on the mma route, fp32 on the
    # CUDA-core one) with cache lengths no tile divides, then the smoke
    # configs' G = 2, D = 16 (the mma route in bf16)
    worst = 0.0
    cases = [(L, None) for L in DECODE_LENS + DECODE_RAGGED] + [(2048, 512)]
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[1]
        for L, window in cases:
            q, k, v, lens = decode_inputs(L, dtype, device)
            worst = max(worst, _check_decode(da, q, k, v, lens, name, window))
        q, k, v, lens = decode_inputs(96, dtype, device)
        q, k, v = (q[:, :, :4, :16].contiguous(), k[:, :, :2, :16].contiguous(),
                   v[:, :, :2, :16].contiguous())
        worst = max(worst, _check_decode(da, q, k, v, lens, name, 7))
        # the pairs the other attention archs add: G = 5 and 8 at D = 128,
        # G = 3 at D = 64, at the engine's cache, a ragged one, a window
        # and gemma3-12b's windowed layers' rolling cache of 1024
        for heads in ZOO_HEADS.values():
            extra = ((GEMMA_W, None),) if heads == GEMMA_HEADS else ()
            for L, window in ((2048, None), (2047, None), (2048, 512),
                              *extra):
                q, k, v, lens = decode_inputs(L, dtype, device, heads=heads)
                worst = max(worst, _check_decode(da, q, k, v, lens, name,
                                                 window))
        # whisper's decoder self-attention: G = 1 at D = 64 over its
        # 448-entry cache, and a ragged one
        for L in (WHISPER_CACHE, 301):
            q, k, v, lens = decode_inputs(L, dtype, device,
                                          heads=WHISPER_HEADS)
            worst = max(worst, _check_decode(da, q, k, v, lens, name, None))
    err["decode_attention"] = worst
    err.update(check_flash_bwd(device))
    torch.cuda.synchronize()
    return err


def _check_flash(fa, q, k, v, name: str, kw: dict) -> float:
    """One flash call (causal unless ``kw`` says otherwise) against its
    plain version; prints the route and the error, requires ATTN_ATOL."""
    kw = {"causal": True, **kw}
    route = fa._route(q.dtype, q.shape[-1], v.shape[-1])
    n = fa.flash_attention.launches_by_route[route]
    got = fa.flash_attention(q, k, v, **kw)
    want = fa.flash_attention_plain(q, k, v, **kw)
    e = (got.float() - want.float()).abs().max().item()
    print(f"check flash_attention {name} ({route} route) q{tuple(q.shape)} "
          f"kv{tuple(k.shape)} {kw}: max_abs_err={e:.3e} (tolerance "
          f"{ATTN_ATOL[name]})")
    require(fa.flash_attention.launches_by_route[route] == n + 1,
            f"flash {name}: the {route} route did not launch")
    require(e <= ATTN_ATOL[name], f"flash {name} {tuple(q.shape)} {kw}: {e}")
    return e


def _check_decode(da, q, k, v, lens, name: str, window) -> float:
    """One decode call against its plain version; prints the route and the
    error, requires ATTN_ATOL and exact zeros where kv_len = 0."""
    route = da._route(q.dtype, q.shape[2] // k.shape[2], q.shape[-1],
                      v.shape[-1])
    n = da.decode_attention.launches_by_route[route]
    got = da.decode_attention(q, k, v, kv_len=lens, window=window)
    want = da.decode_attention_plain(q, k, v, kv_len=lens, window=window)
    e = (got.float() - want.float()).abs().max().item()
    zeros = bool((got[lens == 0] == 0).all().item())
    print(f"check decode_attention {name} ({route} route) q{tuple(q.shape)} "
          f"kv{tuple(k.shape)} kv_len={lens.tolist()} window={window}: "
          f"max_abs_err={e:.3e} (tolerance {ATTN_ATOL[name]}); kv_len=0 "
          f"rows exactly zero: {zeros}")
    require(da.decode_attention.launches_by_route[route] == n + 1,
            f"decode {name}: the {route} route did not launch")
    require(e <= ATTN_ATOL[name], f"decode {name} {tuple(k.shape)}: {e}")
    require(zeros, f"decode {name} {tuple(k.shape)}: kv_len=0 rows not zero")
    return e


# the backward's checks and timed rows: (label, B, S, heads, causal) at
# llama3-8b's training shape and whisper's encoder
BWD_SHAPES = (("llama3-8b", TRAIN_B, TRAIN_S, (LLAMA_H, LLAMA_KV, LLAMA_D),
               True),
              ("whisper encoder", WHISPER_B, 1500, WHISPER_HEADS, False))


def bwd_inputs(B, S, heads, causal, dtype, device, seed=3):
    """q, k, v, the forward's (o, lse) through the kernel, and dO."""
    from repro_torch.kernels import flash_attention as fa
    import torch
    q, k, v = attn_inputs(S, S, dtype, device, seed=seed, heads=heads, B=B)
    o, lse = fa._forward(q, k, v, causal, None, 0, None, True)
    do = torch.randn(o.shape, generator=_gen(seed + 1)).to(device, dtype)
    return q, k, v, o, lse, do


# the split backward's checks, bf16 only (label, B, Sq, Skv, (H, KV, D), Dv,
# kwargs): gemma3's training shape (G = 2), S = 2,048 past its window of
# 1,024 and a small window (tiles cross the window's edge; at S = 1,024 the
# window masks nothing), a ragged Sq, an offset chunk with Skv > Sq; MLA's
# training shape at its scale and a ragged S = 37
BWD_SPLIT_CASES = (
    ("gemma3-12b", TRAIN_B, TRAIN_S, TRAIN_S, GEMMA_HEADS, None,
     {"causal": True}),
    ("gemma3 S = 2048, window 1024", 1, 2 * TRAIN_S, 2 * TRAIN_S,
     GEMMA_HEADS, None, {"causal": True, "window": GEMMA_W}),
    ("gemma3 S = 2048, window 100", 1, 2 * TRAIN_S, 2 * TRAIN_S,
     GEMMA_HEADS, None, {"causal": True, "window": 100}),
    ("gemma3 Sq = 1000", 1, 1000, 1000, GEMMA_HEADS, None,
     {"causal": True}),
    ("gemma3 offset chunk", 1, 300, 470, GEMMA_HEADS, None,
     {"causal": True, "q_offset": 170}),
    ("deepseek-v2-236b MLA", TRAIN_B, TRAIN_S, TRAIN_S, MLA_HEADS, MLA_DV,
     {"causal": True, "scale": MLA_SCALE}),
    ("MLA S = 37", 2, 37, 37, MLA_HEADS, MLA_DV,
     {"causal": True, "scale": MLA_SCALE}),
)


# the flash backward at the zoo's other training head shapes, bf16 on the
# wgmma route (as BWD_SPLIT_CASES): granite-moe-3b-a800m's GQA 24 | 8 at
# D = 64 (G = 3); whisper-large-v3's decoder self attention (Sq = 1500 / 8
# = 187, padded to the 192-row tile) and its cross attention (those 187
# queries against the 1,500 encoder states, whose dK and dV carry the
# gradient back into the encoder); qwen2.5-14b's 40 | 8 (G = 5) and
# chameleon-34b's and qwen1.5-110b's 64 | 8 (G = 8) at D = 128
BWD_TRAIN_CASES = (
    ("granite-moe-3b-a800m", TRAIN_B, TRAIN_S, TRAIN_S,
     ZOO_HEADS["granite-moe-3b-a800m"], None, {"causal": True}),
    ("whisper decoder self", TRAIN_B, 1500 // 8, 1500 // 8, WHISPER_HEADS,
     None, {"causal": True}),
    ("whisper cross", TRAIN_B, 1500 // 8, 1500, WHISPER_HEADS, None,
     {"causal": False}),
    ("qwen2.5-14b", TRAIN_B, TRAIN_S, TRAIN_S, ZOO_HEADS["qwen2.5-14b"],
     None, {"causal": True}),
    ("chameleon-34b, qwen1.5-110b", TRAIN_B, TRAIN_S, TRAIN_S,
     ZOO_HEADS["chameleon-34b"], None, {"causal": True}),
)


def bwd_case_inputs(device, dtype, B, Sq, Skv, heads, Dv, kw, seed=5):
    """q, k, v, dO of a backward case drawn from ``seed``, and the
    forward kernel's (o, lse) on them."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    H, KV, D = heads
    Dv = Dv or D
    g = _gen(seed)
    q = torch.randn((B, Sq, H, D), generator=g).to(device, dtype)
    k = torch.randn((B, Skv, KV, D), generator=g).to(device, dtype)
    v = torch.randn((B, Skv, KV, Dv), generator=g).to(device, dtype)
    do = torch.randn((B, Sq, H, Dv), generator=g).to(device, dtype)
    o, lse = fa._forward(q, k, v, kw.get("causal", True), kw.get("window"),
                         kw.get("q_offset", 0), kw.get("scale"), True)
    return q, k, v, do, o, lse


def _check_bwd_case(device, dtype, label, B, Sq, Skv, heads, Dv,
                    kw, route=None) -> float:
    """One flash backward call on its route (or on ``route``, forced)
    against the plain formulas on the same (o, lse) and autograd of the
    plain forward, within BWD_RTOL of the largest gradient; the forward's
    lse against the plain one within 1e-4. Returns the largest absolute
    difference from the formulas."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    name = str(dtype).split(".")[1]
    q, k, v, do, o, lse = bwd_case_inputs(device, dtype, B, Sq, Skv, heads,
                                          Dv, kw)
    Dv = v.shape[-1]
    natural = fa._bwd_route(dtype, q.shape[-1], Dv)
    route = route or natural
    e_lse = (lse - fa.flash_attention_lse_plain(q, k, v, **kw)
             ).abs().max().item()
    n = fa.flash_attention_bwd.launches_by_route[route]
    with forced_route(fa, "_bwd_route", route):
        got = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    require(fa.flash_attention_bwd.launches_by_route[route] == n + 1,
            f"flash_attention_bwd: the {route} route did not launch")
    want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    leaves = [t.detach().float().requires_grad_() for t in (q, k, v)]
    auto = torch.autograd.grad(
        fa.flash_attention_plain(*leaves, **kw), leaves, do.float())
    errs, worst = [], 0.0
    for gname, a, b, c in zip("QKV", got, want, auto):
        top = c.abs().max().item()
        e_plain = (a.float() - b.float()).abs().max().item()
        e_auto = (a.float() - c).abs().max().item()
        errs.append(f"d{gname} {e_plain:.3e} / {e_auto:.3e} of {top:.3e}")
        worst = max(worst, e_plain)
        require(bool(torch.isfinite(a.float()).all())
                and e_plain <= BWD_RTOL[name] * top
                and e_auto <= BWD_RTOL[name] * top,
                f"flash_attention_bwd {name} {label} d{gname}: "
                f"{e_plain:.3e} (formulas), {e_auto:.3e} (autograd) "
                f"against the largest gradient {top:.3e}")
    print(f"check flash_attention_bwd {name} ({route} route"
          f"{'' if route == natural else ', forced'}) {label} "
          f"q{tuple(q.shape)} kv{tuple(k.shape)}|{Dv} {kw}: max_abs_err vs "
          f"formulas / vs autograd of the plain forward: {'; '.join(errs)} "
          f"(tolerance {BWD_RTOL[name]} of the largest); forward lse "
          f"max_abs_err {e_lse:.3e}")
    require(e_lse <= 1e-4, f"flash lse {name} {label}: {e_lse}")
    del q, k, v, do, o, lse, got, want, leaves, auto
    torch.cuda.empty_cache()
    return worst


def check_flash_bwd(device) -> dict[str, float]:
    """The flash backward kernel at llama3-8b's training shape (causal) and
    whisper's encoder (non-causal), bf16 and fp32, plus a window, an offset
    chunk and a ragged width; the zoo's other training head shapes
    (BWD_TRAIN_CASES, bf16 on wgmma); the wide routes (bf16) at
    BWD_SPLIT_CASES, gemma3's on the split route, MLA's on the kv128 route and on the split
    route forced (its earlier route): dQ, dK, dV against the plain formulas
    on the same (o, lse) and against autograd of the plain forward, within
    BWD_RTOL of the largest gradient; the forward's lse against the plain
    one; then the wide routes' CUDA-graph replays
    (:func:`check_split_bwd_replay`). Returns the largest absolute
    difference from the plain formulas of the first three routes, of the
    split one and of the kv128 one."""
    import torch
    worst = 0.0
    # (label, B, S, heads, causal, Dv, kwargs): in bf16 D = Dv = 64 or 128
    # take the wgmma route, other multiples of 16 the mma.sync one, and
    # widths no multiple of 16 the CUDA-core route; D != Dv on the last two
    extra = (("window", 1, 300, (LLAMA_H, LLAMA_KV, LLAMA_D), True, None,
              {"window": 100}),
             ("offset chunk", 1, 130, WHISPER_HEADS, True, None,
              {"q_offset": 170}),
             ("D = 96, Dv = 112", 1, 77, (4, 2, 96), False, 112, {}),
             ("D = 40, Dv = 24", 1, 77, (4, 2, 40), True, 24, {}))
    cases = [(*c, None, {}) for c in BWD_SHAPES] + list(extra)
    for dtype in (torch.bfloat16, torch.float32):
        for label, B, S, heads, causal, Dv, kw in cases:
            kw = {"causal": causal, **kw}
            worst = max(worst, _check_bwd_case(
                device, dtype, label, B, S, S + kw.get("q_offset", 0), heads,
                Dv, kw))
    for label, B, Sq, Skv, heads, Dv, kw in BWD_TRAIN_CASES:
        worst = max(worst, _check_bwd_case(
            device, torch.bfloat16, label, B, Sq, Skv, heads, Dv, kw))
    from repro_torch.kernels import flash_attention as fa
    wide = {"wgmma_split": 0.0, "wgmma_kv128": 0.0}
    for label, B, Sq, Skv, heads, Dv, kw in BWD_SPLIT_CASES:
        route = fa._bwd_route(torch.bfloat16, heads[2], Dv or heads[2])
        wide[route] = max(wide[route], _check_bwd_case(
            device, torch.bfloat16, label, B, Sq, Skv, heads, Dv, kw))
        if route == "wgmma_kv128":
            wide["wgmma_split"] = max(wide["wgmma_split"], _check_bwd_case(
                device, torch.bfloat16, label, B, Sq, Skv, heads, Dv, kw,
                route="wgmma_split"))
    check_split_bwd_replay(device)
    return {"flash_attention_bwd": worst,
            "flash_attention_bwd_split": wide["wgmma_split"],
            "flash_attention_bwd_kv128": wide["wgmma_kv128"]}


def check_split_bwd_replay(device) -> None:
    """The wide backward routes in CUDA graphs, gemma3's on the split
    route and MLA's on the kv128 route: with one key tile (Skv <= 64 | 128,
    each dQ element one bulk add into the zeroed buffer) every output
    bit-equal to the eager call across replays with dO's sign flipped in
    between; at the training shapes dK and dV (summed in registers)
    bit-equal, dQ's fp32 adds of several key tiles landing in no fixed
    order."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    for label, B, S, heads, Dv, kw in (
            ("gemma3 S = 60", 2, 60, GEMMA_HEADS, None, {"causal": True}),
            ("MLA S = 50", 2, 50, MLA_HEADS, MLA_DV,
             {"causal": True, "scale": MLA_SCALE}),
            ("gemma3-12b training, dK and dV", TRAIN_B, TRAIN_S,
             GEMMA_HEADS, None, {"causal": True, "window": GEMMA_W}),
            ("deepseek-v2-236b training, dK and dV", TRAIN_B, TRAIN_S,
             MLA_HEADS, MLA_DV, {"causal": True, "scale": MLA_SCALE})):
        q, k, v, do, o, lse = bwd_case_inputs(device, torch.bfloat16, B, S,
                                              S, heads, Dv, kw, seed=9)
        first = 0 if S <= 64 else 1          # dQ in the bits only at one tile

        def call():
            return torch.cat([t.reshape(-1) for t in fa.flash_attention_bwd(
                q, k, v, o, lse, do, **kw)[first:]])
        same = replays_equal(call, lambda: do.mul_(-1.0))
        route = fa._bwd_route(torch.bfloat16, heads[2], Dv or heads[2])
        print(f"check flash_attention_bwd bf16 ({route} route) {label} "
              f"q{tuple(q.shape)} kv{tuple(k.shape)}|{v.shape[-1]}, 3 "
              f"CUDA-graph replays: bit-equal to the eager calls: {same}")
        require(same, f"flash_attention_bwd {label}: a CUDA-graph replay "
                "differs")
        del q, k, v, do, o, lse
        torch.cuda.empty_cache()


def hard_decays(w, seed: int):
    """w with exact zeros, denormals (1e-40) and exact ones in about 5% of
    its values each, as the model's w = exp(-exp(z)) reaches them."""
    import torch
    u = torch.rand(w.shape, generator=_gen(seed)).to(w.device)
    w = torch.where(u < 0.05, torch.zeros_like(w), w)
    w = torch.where((u >= 0.05) & (u < 0.10), torch.full_like(w, 1e-40), w)
    return torch.where((u >= 0.10) & (u < 0.15), torch.ones_like(w), w)


def check_scan_kernel(device) -> dict[str, float]:
    """The RWKV6 scan against its plain version at rwkv6-3b's heads, both
    routes: in bf16 the chunked route at the prefill length and at lengths
    no chunk divides, from a zero state and from a random one (in place
    equal to out of place), and with decays of 0, denormals and 1; the
    serial route at a bf16 prompt just short of the chunked route's, at the
    S = 1 decode step (in place equal to out of place) and in float32 at
    the prefill and a ragged length."""
    import torch
    from repro_torch.kernels import linear_scan as ls
    worst = 0.0
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [(bf16, 1, S, h0, False) for S in RWKV_CHUNK_SEQS
             for h0 in (False, True)]
    cases += [(bf16, 1, S, True, True) for S in (RWKV_PREFILL, 130)]
    # either side of where the chunked route starts
    cases += [(bf16, 1, S, True, False)
              for S in (ls.CHUNK_MIN_S, ls.CHUNK_MIN_S - 1)]
    cases += [(bf16, RWKV_DECODE_B, 1, True, False),
              (f32, 1, RWKV_PREFILL, False, False), (f32, 1, 37, True, False),
              (f32, RWKV_DECODE_B, 1, True, False)]
    for dtype, B, S, with_h0, hard in cases:
        name = str(dtype).split(".")[1]
        r, w, k, v, u, h0 = scan_inputs(B, S, dtype, device, seed=S)
        if hard:
            w = hard_decays(w, seed=S)
        h0 = h0 if with_h0 else None
        route = ls._route(dtype, RWKV_K, RWKV_K, S)
        n = ls.rwkv_scan.launches_by_route[route]
        o, h = ls.rwkv_scan(r, w, k, v, u, h0)
        require(ls.rwkv_scan.launches_by_route[route] == n + 1,
                f"rwkv_scan {name} S={S}: the {route} route did not launch")
        po, ph = ls.rwkv_scan_plain(r, w, k, v, u, h0)
        e = (o.float() - po.float()).abs().max().item()
        rel = e / po.float().abs().max().item()
        rel_h = ((h - ph).abs().max() / ph.abs().max()).item()
        finite = bool(torch.isfinite(o.float()).all()
                      and torch.isfinite(h).all())
        line = (f"check rwkv_scan {name} ({route} route) r(B={B},S={S},"
                f"{RWKV_H},{RWKV_K}) h0={'random' if with_h0 else 'none'}"
                f"{' w with 0, denormals, 1' if hard else ''}: max_abs_err o "
                f"{e:.3e}, relative o {rel:.3e} state {rel_h:.3e} (tolerance "
                f"{SCAN_RTOL[name]} of the largest o, {STATE_RTOL} of the "
                f"largest state); finite: {finite}")
        require(finite and rel <= SCAN_RTOL[name] and rel_h <= STATE_RTOL,
                f"rwkv_scan {name} B={B} S={S}: {rel}, {rel_h}")
        if with_h0:
            state = h0.clone()
            if S == 1:
                o1, _ = ls.rwkv_decode_step(r[:, 0], w[:, 0], k[:, 0],
                                            v[:, 0], u, state)
                o1 = o1[:, None]
            else:
                o1, _ = ls.rwkv_scan(r, w, k, v, u, state, state_out=state)
            same = bool(torch.equal(o1, o) and torch.equal(state, h))
            line += f"; in place (state_out = h0) equal: {same}"
            require(same, f"rwkv_scan {name} S={S}: in place differs")
        print(line)
        worst = max(worst, e)
    torch.cuda.synchronize()
    return {"rwkv_scan": worst}


def hard_steps(delta, seed: int):
    """delta = 100 in about 5% of its elements: delta |A| reaches ~100 and
    more there, so exp(delta A) underflows to 0 and to denormals, as
    jamba's unbounded softplus steps and A down to -16 make it."""
    import torch
    u = torch.rand(delta.shape, generator=_gen(seed)).to(delta.device)
    return torch.where(u < 0.05, torch.full_like(delta, 100.0), delta)


def check_mamba_kernel(device) -> dict[str, float]:
    """The Mamba scan against its plain version, fp32 and bf16, every
    route. At jamba-v0.1-52b's width (Di 8192, N 16): the prefill length
    from a zero state, S = 37 and (B = 3, S = 50) from a random state, S =
    2, 16, 33 and either side of linear_scan.MAMBA_SEG_MIN_S (the
    segmented route from there on, the serial one below), and hard decays
    (delta |A| ~100 in 5% of the elements) at the prefill length and at
    130; the S = 1
    decode step of 8 slots, also with hard decays (the step route); and the
    smoke config's (Di 128, N 4, the serial route). y within SCAN_RTOL of
    the largest plain y, the state within STATE_RTOL of the largest plain
    state; from a random state, in place (state_out = h0) bit-equal to out
    of place."""
    import torch
    from repro_torch.kernels import linear_scan as ls
    worst = 0.0
    cases = [(1, MAMBA_PREFILL, MAMBA_DI, MAMBA_N, False, False),
             (1, 37, MAMBA_DI, MAMBA_N, True, False),
             (3, 50, MAMBA_DI, MAMBA_N, True, False)]
    cases += [(1, S, MAMBA_DI, MAMBA_N, True, False)
              for S in sorted({2, 16, 33, ls.MAMBA_SEG_MIN_S,
                               ls.MAMBA_SEG_MIN_S - 1})]
    cases += [(1, MAMBA_PREFILL, MAMBA_DI, MAMBA_N, True, True),
              (1, 130, MAMBA_DI, MAMBA_N, False, True),
              (MAMBA_DECODE_B, 1, MAMBA_DI, MAMBA_N, True, False),
              (MAMBA_DECODE_B, 1, MAMBA_DI, MAMBA_N, True, True),
              (2, 45, 128, 4, True, False),
              (MAMBA_DECODE_B, 1, 128, 4, True, False)]
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[1]
        for B, S, Di, N, with_h0, hard in cases:
            delta, A, Bt, Ct, x, h0 = mamba_inputs(B, S, dtype, device,
                                                   seed=S, Di=Di, N=N)
            if hard:
                delta = hard_steps(delta, seed=S)
            h0 = h0 if with_h0 else None
            route = ls._mamba_route(dtype, N, S)
            n = ls.mamba_scan.launches_by_route[route]
            y, h = ls.mamba_scan(delta, A, Bt, Ct, x, h0)
            require(ls.mamba_scan.launches_by_route[route] == n + 1,
                    f"mamba_scan {name} S={S}: the {route} route did not "
                    "launch")
            py, ph = ls.mamba_scan_plain(delta, A, Bt, Ct, x, h0)
            e = (y.float() - py.float()).abs().max().item()
            rel = e / py.float().abs().max().item()
            rel_h = ((h - ph).abs().max() / ph.abs().max()).item()
            finite = bool(torch.isfinite(y.float()).all()
                          and torch.isfinite(h).all())
            line = (f"check mamba_scan {name} ({route} route) delta(B={B},"
                    f"S={S},{Di}) N={N} h0={'random' if with_h0 else 'none'}"
                    f"{' delta |A| ~100 in 5%' if hard else ''}: max_abs_err "
                    f"y {e:.3e}, relative y {rel:.3e} state {rel_h:.3e} "
                    f"(tolerance {SCAN_RTOL[name]} of the largest y, "
                    f"{STATE_RTOL} of the largest state); finite: {finite}")
            require(finite and rel <= SCAN_RTOL[name] and rel_h <= STATE_RTOL,
                    f"mamba_scan {name} B={B} S={S} N={N}: {rel}, {rel_h}")
            if with_h0:
                state = h0.clone()
                if S == 1:
                    y1, _ = ls.mamba_decode_step(delta[:, 0], A, Bt[:, 0],
                                                 Ct[:, 0], x[:, 0], state)
                    y1 = y1[:, None]
                else:
                    y1, _ = ls.mamba_scan(delta, A, Bt, Ct, x, state,
                                          state_out=state)
                same = bool(torch.equal(y1, y) and torch.equal(state, h))
                line += f"; in place (state_out = h0) equal: {same}"
                require(same, f"mamba_scan {name} S={S}: in place differs")
            print(line)
            worst = max(worst, e)
    torch.cuda.synchronize()
    return {"mamba_scan": worst}


# the scan backwards' checks (phase 2): rwkv6-3b's and jamba's training
# shapes, a ragged S, S on each forward route, a non-zero h0 with a
# final-state gradient, hard decays and the smoke widths; (label, B, S,
# (H, K) or (Di, N), h0 and a final-state gradient, hard decays)
RWKV_BWD_CASES = (
    ("rwkv6-3b training", TRAIN_B, TRAIN_S, (RWKV_H, RWKV_K), False, False),
    ("ragged", 2, 37, (RWKV_H, RWKV_K), True, False),
    ("short (serial forward)", 2, 32, (RWKV_H, RWKV_K), True, False),
    ("w with 0, denormals, 1", 1, 130, (RWKV_H, RWKV_K), True, True),
    ("smoke width", 2, 45, (4, 16), True, False))
MAMBA_BWD_CASES = (
    ("jamba training", TRAIN_B, TRAIN_S, (MAMBA_DI, MAMBA_N), False, False),
    ("ragged", 2, 37, (MAMBA_DI, MAMBA_N), True, False),
    ("short (serial forward)", 2, 5, (MAMBA_DI, MAMBA_N), True, False),
    ("one step", 2, 1, (MAMBA_DI, MAMBA_N), True, False),
    ("delta |A| ~100 in 5%", 1, 130, (MAMBA_DI, MAMBA_N), True, True),
    ("smoke width", 2, 45, (128, 4), True, False))


def scan_bwd_inputs(kind: str, B, S, dims, dtype, device, with_h0, hard):
    """(the scan's inputs as the model feeds it, the forward wrapper, its
    route) for a case of RWKV_BWD_CASES or MAMBA_BWD_CASES."""
    from repro_torch.kernels import linear_scan as ls
    if kind == "rwkv":
        H, K = dims
        r, w, k, v, u, h0 = scan_inputs(B, S, dtype, device, seed=S, H=H,
                                        K=K)
        if hard:
            w = hard_decays(w, seed=S)
        return ([r, w, k, v, u, h0 if with_h0 else None], ls.rwkv_scan,
                ls._route(dtype, K, K, S))
    Di, N = dims
    delta, A, Bt, Ct, x, h0 = mamba_inputs(B, S, dtype, device, seed=S,
                                           Di=Di, N=N)
    if hard:
        delta = hard_steps(delta, seed=S)
    return ([delta, A, Bt, Ct, x, h0 if with_h0 else None], ls.mamba_scan,
            ls._mamba_route(dtype, N, S))


def check_scan_bwd(device) -> dict[str, float]:
    """The two scan backwards, bf16 and fp32, at RWKV_BWD_CASES and
    MAMBA_BWD_CASES, on every route that takes each case: the forward
    wrapper under grad (its route, with checkpoints) and autograd through
    its Function, whose backward launches the route the shape takes
    (``linear_scan._rwkv_bwd_route``, ``_mamba_bwd_route``), then the
    serial route forced on the same checkpoints where the shape takes the
    chunked one (:func:`scan_bwd_routes`), against the plain formulas
    (``*_bwd_plain``) on the same inputs and against autograd of the plain forward with float32 leaves,
    each gradient within BWD_RTOL of its largest; then, on every route, a
    CUDA-graph replay of each backward and a second eager call bit-equal to
    the first. Returns each kernel's largest absolute difference from the
    plain formulas over its routes."""
    import torch
    from repro_torch.kernels import linear_scan as ls
    worst = {"rwkv_scan_bwd": 0.0, "mamba_scan_bwd": 0.0}
    names = {"rwkv": ("r", "w", "k", "v", "u", "h0"),
             "mamba": ("delta", "A", "Bt", "Ct", "x", "h0")}
    plain = {"rwkv": (ls.rwkv_scan_plain, ls.rwkv_scan_bwd_plain),
             "mamba": (ls.mamba_scan_plain, ls.mamba_scan_bwd_plain)}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[1]
        for kind, cases in (("rwkv", RWKV_BWD_CASES),
                            ("mamba", MAMBA_BWD_CASES)):
            bwd = getattr(ls, f"{kind}_scan_bwd")
            for label, B, S, dims, with_h0, hard in cases:
                ins, fwd, route = scan_bwd_inputs(kind, B, S, dims, dtype,
                                                  device, with_h0, hard)
                routes = scan_bwd_routes(kind, dtype, dims)
                leaves = [None if t is None else t.detach().requires_grad_()
                          for t in ins]
                n_f = fwd.launches_by_route[route]
                n_b = bwd.launches_by_route[routes[0]]
                y, h = fwd(*leaves)
                g = _gen(S + 7)
                dy = torch.randn(y.shape, generator=g).to(device, dtype)
                dh = (torch.randn(h.shape, generator=g).to(device)
                      if with_h0 else None)
                live = [(n, t) for n, t in zip(names[kind], leaves)
                        if t is not None]
                outs, gouts = ((y, h), (dy, dh)) if with_h0 else ((y,), (dy,))
                got = torch.autograd.grad(outs, [t for _, t in live], gouts)
                require(fwd.launches_by_route[route] == n_f + 1
                        and bwd.launches_by_route[routes[0]] == n_b + 1,
                        f"{kind}_scan_bwd {name} {label}: the {route} "
                        f"forward or the {routes[0]} backward did not launch")
                want = [t for t in plain[kind][1](*ins, dy, dh)
                        if t is not None]
                l32 = [None if t is None else t.detach().float()
                       .requires_grad_() for t in ins]
                y32, h32 = plain[kind][0](*l32)
                auto = torch.autograd.grad(
                    (y32, h32) if with_h0 else (y32,),
                    [t for t in l32 if t is not None],
                    (dy.float(), dh) if with_h0 else (dy.float(),))
                for bwd_route in routes:
                    if bwd_route != routes[0]:
                        # each gradient in its input's dtype, as autograd
                        # narrows u's through the caller's widening
                        got = [t.to(leaf.dtype) for t, (_, leaf) in zip(
                            [t for t in scan_bwd_thunk(
                                kind, ins, dy, dh, bwd_route)()
                             if t is not None], live)]
                    errs = []
                    for (gname, _), a, b, c in zip(live, got, want, auto):
                        top = c.abs().max().item()
                        e_plain = (a.float() - b.float()).abs().max().item()
                        e_auto = (a.float() - c).abs().max().item()
                        finite = bool(torch.isfinite(a.float()).all())
                        errs.append(f"d{gname} {e_plain:.3e} / {e_auto:.3e} "
                                    f"of {top:.3e}")
                        worst[f"{kind}_scan_bwd"] = max(
                            worst[f"{kind}_scan_bwd"], e_plain)
                        require(finite and e_plain <= BWD_RTOL[name] * top
                                and e_auto <= BWD_RTOL[name] * top,
                                f"{kind}_scan_bwd {name} {label} ({bwd_route} "
                                f"route) d{gname}: {e_plain:.3e} (formulas), "
                                f"{e_auto:.3e} (autograd) against the "
                                f"largest gradient {top:.3e}; finite: "
                                f"{finite}")
                    print(f"check {kind}_scan_bwd {name} ({route} forward, "
                          f"{bwd_route} backward"
                          f"{'' if bwd_route != routes[0] else ' by autograd'}"
                          f") {label} {tuple(ins[0].shape)} dims {dims}"
                          f"{', h0 and dh' if with_h0 else ''}: max_abs_err "
                          f"vs formulas / vs autograd of the plain forward: "
                          f"{'; '.join(errs)} (tolerance {BWD_RTOL[name]} of "
                          "the largest)")
                del ins, leaves, y, h, got, want, l32, y32, h32, auto
                torch.cuda.empty_cache()
    # each backward route replayed in a CUDA graph and called twice: the
    # same bits (no atomics, sums in a fixed order)
    for kind, (label, B, S, dims, _, hard) in (("rwkv", RWKV_BWD_CASES[1]),
                                                ("mamba", MAMBA_BWD_CASES[1])):
        ins, fwd, route = scan_bwd_inputs(kind, B, S, dims, torch.bfloat16,
                                          device, True, hard)
        for bwd_route in scan_bwd_routes(kind, torch.bfloat16, dims):
            call = scan_bwd_call(kind, ins, bwd_route)
            twice = bool(torch.equal(call(), call()))
            # flip the sign of r or x (a flipped delta would grow the state
            # past float32's range, and NaN equals nothing)
            same = replays_equal(call, lambda: ins[0 if kind == "rwkv" else 4]
                                 .mul_(-1.0))
            print(f"check {kind}_scan_bwd bf16 ({bwd_route} route) {label} "
                  f"{tuple(ins[0].shape)}: a second call bit-equal to the "
                  f"first: {twice}; 3 CUDA-graph replays bit-equal to the "
                  f"eager calls: {same}")
            require(twice and same, f"{kind}_scan_bwd ({bwd_route} route): "
                    "a second call or a CUDA-graph replay differs")
    torch.cuda.synchronize()
    return worst


def scan_bwd_routes(kind: str, dtype, dims) -> list[str]:
    """The backward routes that take a case: the one the shape takes
    (``linear_scan._rwkv_bwd_route``/``_mamba_bwd_route``) first, then the
    serial route, which takes every built shape, where it is another."""
    from repro_torch.kernels import linear_scan as ls
    route = (ls._rwkv_bwd_route(dtype, dims[1], dims[1]) if kind == "rwkv"
             else ls._mamba_bwd_route(dtype, dims[1]))
    return [route] + (["serial"] if route != "serial" else [])


def scan_bwd_thunk(kind: str, ins: list, dy, dh, route: str):
    """A thunk of the ``kind`` scan's backward on ``route`` at ``ins`` (the
    model's inputs, h0 possibly None), ``dy`` and the final state's ``dh``
    (or None): the forward route the shape takes is launched once, here,
    for its checkpoints; the thunk returns the wrapper's gradients, with
    the wrapper's route chooser answering ``route`` for the length of the
    call (:func:`forced_route`)."""
    import torch
    from repro_torch.kernels import linear_scan as ls
    if kind == "rwkv":
        r, w, k, v, u, h0 = ins
        B, S, H, K = r.shape
        uf = u.float().contiguous()
        state = torch.empty((B, H, K, v.shape[-1]), device=r.device)
        _, ckpt = ls._launch(ls._route(r.dtype, K, v.shape[-1], S), r, w, k,
                             v, uf, h0, state, True)
        call = lambda: ls.rwkv_scan_bwd(r, w, k, v, uf, h0, dy, dh,
                                        ckpt=ckpt)
    else:
        delta, A, Bt, Ct, x, h0 = ins
        B, S, Di = delta.shape
        N = A.shape[1]
        Af = A.float().contiguous()
        state = torch.empty((B, Di, N), device=x.device)
        ckpt = torch.empty((B, -(-S // ls.CHUNK), Di, N), device=x.device)
        ls._launch_mamba(ls._mamba_route(x.dtype, N, S), delta, x, Af, Bt,
                         Ct, h0, state, ckpt)
        call = lambda: ls.mamba_scan_bwd(delta, Af, Bt, Ct, x, h0, dy, dh,
                                         ckpt=ckpt)
    chooser = f"_{kind}_bwd_route"

    def forced():
        with forced_route(ls, chooser, route):
            return call()
    return forced


def scan_bwd_call(kind: str, ins: list, route: str):
    """A thunk of the ``kind`` scan's backward on ``route`` at ``ins`` (h0
    given) with dO and the final state's gradient drawn
    (:func:`scan_bwd_thunk`); it returns every gradient flattened into one
    float32 tensor."""
    import torch
    g = _gen(11)
    h0 = ins[5]
    out_shape = (ins[3].shape if kind == "rwkv" else ins[4].shape)
    dy = torch.randn(out_shape, generator=g).to(h0.device, ins[0].dtype)
    dh = torch.randn(h0.shape, generator=g).to(h0.device)
    call = scan_bwd_thunk(kind, ins, dy, dh, route)
    return lambda: torch.cat([t.float().reshape(-1) for t in call()
                              if t is not None])


def check_norms(device) -> None:
    """RMSNorm and LayerNorm (one float32 copy of x in place) bit-equal on
    the card to the expressions they replace, at llama3-8b's and
    rwkv6-3b's widths, bf16 and fp32."""
    import torch
    from repro_torch.models import layers

    def rms_expr(x, w, eps=1e-6):
        xf = x.float()
        n = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
        return (n * w.float()).to(x.dtype)

    def ln_expr(x, w, b, eps=1e-5):
        xf = x.float()
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
        return ((xf - mu) * torch.rsqrt(var + eps) * w.float()
                + b.float()).to(x.dtype)

    g = _gen(13)
    for dtype in (torch.bfloat16, torch.float32):
        for shape in ((TRAIN_B, TRAIN_S, 4096), (TRAIN_B, TRAIN_S, 2560),
                      (2, 37, RWKV_H, RWKV_K)):
            x = (torch.randn(shape, generator=g) * 3 + 1).to(device, dtype)
            w = torch.randn(shape[-1:] if len(shape) == 3 else shape[-2:],
                            generator=g).to(device, dtype)
            b = torch.randn(w.shape, generator=g).to(device, dtype)
            same = (torch.equal(layers.rmsnorm(x, w), rms_expr(x, w))
                    and torch.equal(layers.layernorm(x, w, b),
                                    ln_expr(x, w, b)))
            print(f"check rmsnorm, layernorm {str(dtype).split('.')[1]} "
                  f"x{shape}: bit-equal to the expressions: {same}")
            require(same, f"norms x{shape} {dtype}: not bit-equal")


# --------------------------------------------------------------------------
# Phase 3: the pipeline on the card, against the same pipeline on the CPU
# --------------------------------------------------------------------------

def run_pipeline(device, fast_path: bool, *, n_frames: int, src_hw,
                 wrappers=()):
    """One pipeline run; returns (result, seconds, launches per wrapper,
    launches per route of each wrapper that has routes), the counts set to
    0 just before ``run()`` and read just after."""
    from repro_torch.core.pipeline import StreamingPipeline
    from repro_torch.data.video import VideoStream
    from repro_torch.kernels import build
    import torch
    pipe = StreamingPipeline(device=device, placement="device", batch_size=8,
                             n_frames=n_frames, seed=0, fast_path=fast_path)
    pipe.video = VideoStream(height=src_hw[0], width=src_hw[1], seed=0)
    for w in wrappers:
        build.zero_launches(w)
    t0 = time.perf_counter()
    res = pipe.run()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return (res, secs, {w: w.launches for w in wrappers},
            {w: dict(w.launches_by_route) for w in wrappers
             if hasattr(w, "launches_by_route")})


def identities(res) -> list:
    return sorted((rid, name) for rid, name, _ in res.identities)


def check_pipeline(device, kernels, *, n_frames: int, src_hw) -> dict:
    """Fused and unfused runs on ``device`` and on the CPU; returns the
    launch totals per kernel name and the per-run summaries. Every matmul
    launch (face batches of at most 8) must take the skinny route, and
    every YUV decode (1080p frames) the vec16 route."""
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import preproc
    wrappers = [k["wrapper"] for k in kernels]
    # warm-up: CUDA context, kernel libraries and caches, outside any count
    run_pipeline(device, True, n_frames=2, src_hw=src_hw)
    totals = dict.fromkeys((k["name"] for k in kernels), 0)
    runs = {}
    for fast in (True, False):
        res, secs, launches, routes = run_pipeline(
            device, fast, n_frames=n_frames, src_hw=src_hw, wrappers=wrappers)
        ref, ref_secs, _, _ = run_pipeline("cpu", fast, n_frames=n_frames,
                                           src_hw=src_hw)
        fr = res.ai_tax()["fractions"]
        label = "fused" if fast else "unfused"
        counts = {k["name"]: launches[k["wrapper"]] for k in kernels}
        print(f"pipeline {label}: {n_frames} frames in {secs:.3f} s "
              f"({n_frames / secs:.2f} frames/s; cpu plain {ref_secs:.3f} s); "
              f"detected={res.detected} gt={res.ground_truth} "
              f"matched={res.matched} identities={len(res.identities)}; "
              f"launches={counts}; five-way="
              + json.dumps({k: round(v, 4) for k, v in fr.items()}))
        print(f"pipeline {label} stage means (ms): " + json.dumps(
            {s: round(v * 1e3, 4) for s, v in
             sorted(res.log.breakdown().items())}))
        require(abs(sum(fr.values()) - 1.0) < 1e-9,
                f"{label}: five-way split sums to {sum(fr.values())}")
        require(res.detected > 0 and len(res.identities) == res.detected,
                f"{label}: {res.detected} detections, "
                f"{len(res.identities)} identities")
        require((res.detected, res.ground_truth, res.matched)
                == (ref.detected, ref.ground_truth, ref.matched),
                f"{label}: card {(res.detected, res.ground_truth, res.matched)}"
                f" vs cpu {(ref.detected, ref.ground_truth, ref.matched)}")
        require(identities(res) == identities(ref),
                f"{label}: identities differ between the card and the cpu")
        used = ({"matmul", "yuv_to_rgb", "letterbox_normalize"}
                | (set() if fast else {"resize_bilinear"}))
        for name in used:
            require(counts[name] > 0, f"{label}: {name} never launched")
        for w, name, route in ((mm.matmul, "matmul", "skinny"),
                               (preproc.yuv_to_rgb, "yuv_to_rgb", "vec16")):
            got = routes[w]
            print(f"pipeline {label}: {name} launches by route {got}: all "
                  f"{route}: {got[route] == counts[name]}")
            require(got[route] == counts[name]
                    and sum(got.values()) == counts[name],
                    f"{label}: {name} launches {got}, want all {route}")
        for name, n in counts.items():
            totals[name] += n
        runs[label] = {"res": res, "secs": secs, "fractions": fr}
    require(identities(runs["fused"]["res"])
            == identities(runs["unfused"]["res"]),
            "fused and unfused identify disagree")
    for name, n in totals.items():
        require(n > 0, f"{name} was not launched on the main path")
    return {"launches": totals, "runs": runs}


# --------------------------------------------------------------------------
# Phase 4: device NMS against the host NMS
# --------------------------------------------------------------------------

def run_nms_path(device) -> int:
    """Device NMS over the batteries, IoU launch counter set to 0 just
    before and read just after; every keep list must equal the host's, and
    each call must launch the IoU kernel once."""
    from repro_torch.kernels import build, preproc
    from repro_torch.preprocess import device as dev_pp
    from repro_torch.preprocess import host
    settings = ((0.5, 0.0, None), (0.3, 0.25, 16))
    build.zero_launches(preproc.iou_matrix)
    for n in NMS_SIZES:
        boxes, scores = box_battery(n, seed=n + 1)
        for iou_t, score_t, max_out in settings:
            kw = dict(iou_thresh=iou_t, score_thresh=score_t, max_out=max_out)
            got = dev_pp.nms(boxes, scores, device=device, **kw)
            want = host.nms(boxes, scores, **kw)
            print(f"nms N={n} {kw}: kept {len(got)}; equal to host.nms: "
                  f"{got == want}")
            require(got == want, f"device nms N={n} {kw} differs from host")
    launches = preproc.iou_matrix.launches
    want = len(NMS_SIZES) * len(settings)          # one launch a call
    print(f"nms: iou_matrix launches {launches}; want {want}: "
          f"{launches == want}")
    require(launches == want,
            f"iou_matrix launched {launches} times by the nms calls, want {want}")
    return launches


# --------------------------------------------------------------------------
# Phases 5 and 6: the serving engine
# --------------------------------------------------------------------------

# the models' scan ops (in repro_torch.kernels.ops) and their plain versions
# (in repro_torch.kernels.linear_scan); a ``*_decode_step`` writes its last
# argument, the state, in place
SCAN_OPS = {"rwkv_scan": "rwkv_scan_plain",
            "rwkv_decode_step": "rwkv_decode_step_plain",
            "mamba_scan": "mamba_scan_plain",
            "mamba_decode_step": "mamba_decode_step_plain"}


@contextlib.contextmanager
def swapped_ops(fns: dict):
    """``repro_torch.kernels.ops`` with the given name -> function swapped
    in, restored on exit."""
    from repro_torch.kernels import ops
    saved = {n: getattr(ops, n) for n in fns}
    for n, fn in fns.items():
        setattr(ops, n, fn)
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(ops, n, fn)


def plain_ops():
    """The models' kernel ops (attention, decode attention, the RWKV6 and
    Mamba scans and their decode steps) switched to the plain versions, on
    any device, for the kernel-vs-plain comparison of a whole model step."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import linear_scan as ls
    return swapped_ops({
        "attention": fa.flash_attention_plain,
        "decode_attention": da.decode_attention_plain,
        **{op: getattr(ls, plain) for op, plain in SCAN_OPS.items()}})


def checked_scan_ops(errs: dict):
    """The models' scan ops (RWKV6 and Mamba, scan and decode step), each
    call also run through its plain version on the same inputs: the output
    within SCAN_RTOL of the largest plain output and the state within
    STATE_RTOL of the largest plain state, layer by layer. The model goes
    on with the kernel's results. ``errs`` collects, per op, the layers
    checked and the largest relative errors."""
    from repro_torch.kernels import linear_scan as ls
    from repro_torch.kernels import ops

    def compare(op, o, h, po, ph):
        rel = ((o.float() - po.float()).abs().max()
               / po.float().abs().max()).item()
        rel_h = ((h - ph).abs().max() / ph.abs().max()).item()
        tol = SCAN_RTOL[str(o.dtype).split(".")[1]]
        n, worst, worst_h = errs.get(op, (0, 0.0, 0.0))
        require(rel <= tol and rel_h <= STATE_RTOL, f"{op} layer {n} on the "
                f"model's activations: relative output {rel:.3e} (tolerance "
                f"{tol}), state {rel_h:.3e} (tolerance {STATE_RTOL})")
        errs[op] = (n + 1, max(worst, rel), max(worst_h, rel_h))

    def checked(op):
        kernel, plain = getattr(ops, op), getattr(ls, SCAN_OPS[op])

        def scan(*args):
            o, h = kernel(*args)
            compare(op, o, h, *plain(*args))
            return o, h

        def step(*args):
            ph = args[-1].clone()
            po, _ = plain(*args[:-1], ph)
            o, h = kernel(*args)
            compare(op, o, h, po, ph)
            return o, h
        return step if op.endswith("_decode_step") else scan

    return swapped_ops({op: checked(op) for op in SCAN_OPS})


def checked_attention_ops(errs: dict):
    """The models' attention ops (prefill and decode), each call also run
    through its plain version on the same inputs: the largest difference
    within ATTN_ATOL of the largest plain output, layer by layer (the
    decode cache is written before the op reads it, so both read the same
    cache). The model goes on with the kernel's results. ``errs``
    collects, per op, the layers checked and the largest relative and
    absolute differences."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    plains = {"attention": fa.flash_attention_plain,
              "decode_attention": da.decode_attention_plain}

    def checked(op):
        kernel, plain = getattr(ops, op), plains[op]

        def call(*args, **kw):
            o = kernel(*args, **kw)
            po = plain(*args, **kw).float()
            diff = (o.float() - po).abs().max().item()
            rel = diff / po.abs().max().item()
            tol = ATTN_ATOL[str(o.dtype).split(".")[1]]
            n, worst, worst_abs = errs.get(op, (0, 0.0, 0.0))
            require(rel <= tol, f"{op} layer {n} on the model's activations:"
                    f" relative difference {rel:.3e} (tolerance {tol})")
            errs[op] = (n + 1, max(worst, rel), max(worst_abs, diff))
            return o
        return call

    return swapped_ops({op: checked(op) for op in plains})


def check_attention_layers(model, params) -> None:
    """One full-width 512-token prefill and one decode step through the
    attention kernels, every attention layer's flash and decode call held
    against the plain versions on that layer's own inputs
    (:func:`checked_attention_ops`); the logits finite. An MLA arch's
    decode calls no decode kernel (its absorbed attention is plain
    einsums): 0 decode layers are checked there, and must be."""
    import torch
    from repro_torch.models import transformer as tf
    n_layers = sum(s.kind == "attn" for s in tf.layer_specs(model.cfg))
    want = {"attention": n_layers,
            "decode_attention": 0 if model.cfg.mla else n_layers}
    errs = {}
    logits, _ = _step_logits(model, params, _batch(model),
                             lambda: checked_attention_ops(errs))
    for op, (n, rel, diff) in errs.items():
        print(f"check {model.cfg.name} {op} ({model.cfg.dtype}, 512-token "
              f"prompt) on each layer's own inputs vs plain: {n} layers, "
              f"largest difference {diff:.3e} = {rel:.3e} of the largest "
              "plain output")
    if model.cfg.mla:
        print(f"check {model.cfg.name} decode_attention: 0 layers, as its "
              "MLA decode has no kernel (absorbed einsums in both packages)")
    for op, n in want.items():
        require(errs.get(op, (0,))[0] == n,
                f"{op}: {errs.get(op, (0,))[0]} layers checked, want {n}")
    for name, a in logits.items():
        require(bool(torch.isfinite(a).all()),
                f"full-width {name} logits are not finite")


@contextlib.contextmanager
def recorded_routes(routes: list):
    """Every MoE call of the models also records its router's (probs, top-k
    expert ids) on ``routes``, in call order."""
    from repro_torch.models import moe
    apply = moe.moe_apply

    def recording(cfg, p, x):
        probs, _, idx = moe.route(cfg, p, x)
        routes.append((probs, idx))
        return apply(cfg, p, x)

    moe.moe_apply = recording
    try:
        yield
    finally:
        moe.moe_apply = apply


def numpy_lm_tree(cfg, seed: int) -> dict:
    """Random weights in the JAX package's ``Model.init`` layout (each
    pattern position's blocks stacked over n_repeats), made with numpy at
    the reference's init scales. Every leaf is drawn: the zeros- and
    ones-initialised ones (norm scales, RWKV's token-shift mixes, bonus u,
    decay bias w0, groupnorm; Mamba's conv bias, dt_bias, A_log, D) as
    their constant plus N(0, 0.2), so that the token shift, the bonus and
    the Mamba state's decay rates are exercised."""
    import numpy as np
    from repro_torch.models import transformer as tf
    from repro_torch.models.layers import map_tree
    meta = tf.lm_meta(cfg)
    n_pat = len(cfg.block_pattern)
    rng = np.random.default_rng(seed)

    def draw(p, lead=()):
        shape = (*lead, *p.shape)
        if p.init in ("zeros", "ones"):
            const = 0.0 if p.init == "zeros" else 1.0
            return (const + 0.2 * rng.standard_normal(shape)).astype(np.float32)
        fan_in = p.shape[-2] if len(p.shape) >= 2 else p.shape[-1]
        scale = p.scale if p.scale is not None else fan_in ** -0.5
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return {"embed": map_tree(draw, meta["embed"]),
            "blocks": {f"l{j}": map_tree(lambda p: draw(p, (cfg.n_repeats,)),
                                         meta["blocks"][j])
                       for j in range(n_pat)},
            "ln_f": map_tree(draw, meta["ln_f"])}


def check_serve_smoke(device, arch: str, wrappers) -> dict:
    """``arch``'s float32 smoke config on the card and on the CPU, same
    weights: greedy streams equal across devices and schedulers. Returns,
    for each card run, its launches per wrapper (counts zeroed just before
    the run and read just after)."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model, params_from_jax
    from repro_torch.serve.engine import Request, ServingEngine
    cfg = get_config(arch, smoke=True).replace(dtype="float32")
    tree = numpy_lm_tree(cfg, seed=0)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, n)
               for n in rng.integers(4, 40, 10)]
    launches = {}
    streams = {}
    for dev in (device, "cpu"):
        model = Model(cfg, device=dev)
        params = params_from_jax(cfg, tree, device=dev)
        for sched in ("continuous", "slot"):
            eng = ServingEngine(model, params, batch_slots=4, cache_len=96,
                                scheduler=sched)
            for i, p in enumerate(prompts):
                eng.submit(Request(i, p, max_tokens=12))
            for w in wrappers:
                w.launches = 0
            done = eng.run()
            if dev != "cpu":
                launches[sched] = {w: w.launches for w in wrappers}
            require(len(done) == len(prompts), f"smoke {dev} {sched}: "
                    f"{len(done)} of {len(prompts)} requests done")
            require(eng.log.transfer_bytes()["d2h"] == eng.d2h_bytes,
                    f"smoke {dev} {sched}: ledger != counters")
            streams[(str(dev), sched)] = {r.rid: r.tokens for r in done}
    ref = streams[("cpu", "continuous")]
    for key, got in streams.items():
        print(f"serve smoke {arch} {key}: {sum(map(len, got.values()))} tokens, "
              f"streams equal to the cpu continuous run: {got == ref}")
        require(got == ref, f"serve smoke {arch} {key}: token streams differ")
    return launches


def _step_logits(model, params, batch, ops_ctx, tok=None,
                 cache_len=SERVE_CACHE_LEN):
    """Logits of one prefill of ``batch`` ({"tokens"[, "frames"]}) and of
    one decode step feeding ``tok`` back (the prefill's argmax when None),
    under ``ops_ctx``."""
    import torch
    with torch.inference_mode(), ops_ctx():
        lp, cache = model.prefill(params, batch, cache_len=cache_len)
        if tok is None:
            tok = torch.argmax(lp, dim=-1).to(torch.int32)[:, None]
        ld, _ = model.decode_step(params, cache, tok)
    return {"prefill": lp.float(), "decode": ld.float()}, tok


def _prompt(model, n: int = 512):
    import numpy as np
    import torch
    rng = np.random.default_rng(1)
    return torch.from_numpy(rng.integers(0, model.cfg.vocab_size, (1, n))
                            .astype(np.int32)).to(model.device)


def _batch(model):
    """The full-width checks' step: one 512-token prompt."""
    return {"tokens": _prompt(model)}


def check_routes(cfg, plain: list, kern: list) -> None:
    """The MoE routes of a plain and a kernel run of one prefill and one
    decode step, call by call: a router near-tie that the two runs' float32
    rounding resolves differently is named (layer, token, experts, the
    plain run's gap at the k-th choice) before anything else fails."""
    import torch
    from repro_torch.models import transformer as tf
    layers = [i for i, spec in enumerate(tf.layer_specs(cfg)) if spec.moe]
    require(len(plain) == len(kern) == 2 * len(layers),
            f"{len(plain)} and {len(kern)} MoE calls, want 2 x {len(layers)}")
    K = cfg.moe.top_k
    flips = []
    for call, ((pp, pi), (_, ki)) in enumerate(zip(plain, kern)):
        phase = "prefill" if call < len(layers) else "decode"
        for b, t in (pi != ki).any(-1).nonzero().tolist():
            top = torch.sort(pp[b, t], descending=True).values
            flips.append(f"{phase} layer {layers[call % len(layers)]} token "
                         f"{t}: plain experts {pi[b, t].tolist()}, kernels "
                         f"{ki[b, t].tolist()}, plain gap at choice {K} "
                         f"{(top[K - 1] - top[K]).item():.3e}")
    print(f"check {cfg.name} MoE routes, plain vs kernels: {len(plain)} calls,"
          f" {len(flips)} tokens routed differently")
    for line in flips:
        print(f"check {cfg.name} router near-tie: {line}")
    require(not flips, f"{cfg.name}: a router near-tie flipped an expert "
            f"({flips[0] if flips else ''}); the logits are not comparable")


def check_full_width_step(model, params, rtol: float, batch=None,
                          cache_len=SERVE_CACHE_LEN,
                          label="512-token prompt") -> None:
    """One full-width prefill of ``batch`` (a 512-token prompt by default)
    and one decode step through the kernels against the same steps with
    the plain versions (:func:`plain_ops`), on the card: relative max error
    of the logits within ``rtol``, argmax equal. With MoE layers the routes
    of the two runs are compared first (:func:`check_routes`)."""
    import torch
    batch = batch or _batch(model)
    routes = {"plain": [], "kernels": []}

    def ctx(key, ops_ctx):
        def enter():
            stack = contextlib.ExitStack()
            stack.enter_context(ops_ctx())
            stack.enter_context(recorded_routes(routes[key]))
            return stack
        return enter

    plain, tok = _step_logits(model, params, batch, ctx("plain", plain_ops),
                              cache_len=cache_len)
    kern, _ = _step_logits(model, params, batch,
                           ctx("kernels", contextlib.nullcontext), tok,
                           cache_len=cache_len)
    if model.cfg.moe is not None:
        check_routes(model.cfg, routes["plain"], routes["kernels"])
    for name, b in plain.items():
        a = kern[name]
        require(bool(torch.isfinite(a).all() and torch.isfinite(b).all()),
                f"full-width {name} logits are not finite")
        rel = ((a - b).abs().max() / b.abs().max()).item()
        same = bool((a.argmax(-1) == b.argmax(-1)).all())
        print(f"check {model.cfg.name} ({model.cfg.n_layers} layers) {name} "
              f"logits ({model.cfg.dtype}, {label}) kernels vs plain "
              f"versions: max|diff|/max|plain|={rel:.3e} (tolerance {rtol}); "
              f"argmax equal: {same}")
        require(rel <= rtol, f"full-width {name} logits: {rel}")
        require(same, f"full-width {model.cfg.name} {name}: argmax differs")


def check_scan_layers(model, params, ops: tuple) -> None:
    """One full-width 512-token prefill and one decode step through the
    scan kernel, every scan layer's ``ops`` (the scan and its decode step)
    held against the plain versions on that layer's own inputs
    (:func:`checked_scan_ops`); the logits finite."""
    import torch
    from repro_torch.models import transformer as tf
    kind = ops[0].split("_")[0]
    n_layers = sum(s.kind == kind for s in tf.layer_specs(model.cfg))
    errs = {}
    logits, _ = _step_logits(model, params, _batch(model),
                             lambda: checked_scan_ops(errs))
    for op, (n, rel, rel_h) in errs.items():
        print(f"check {model.cfg.name} {op} ({model.cfg.dtype}, 512-token "
              f"prompt) on each layer's own inputs vs plain: {n} layers, "
              f"largest relative output {rel:.3e} state {rel_h:.3e}")
    for op in ops:
        require(errs.get(op, (0,))[0] == n_layers,
                f"{op}: {errs.get(op, (0,))[0]} of {n_layers} layers checked")
    for name, a in logits.items():
        require(bool(torch.isfinite(a).all()),
                f"full-width {name} logits are not finite")


def serve_requests(cfg, n: int, seed: int):
    import numpy as np
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, m)
            for m in rng.integers(16, 1025, n)]


def run_serve(model, params, prompts, max_tokens: int, wrappers=()):
    """One continuous-batching engine run at the full-width settings;
    returns (engine, finished, seconds, launches per wrapper, launches per
    route of each wrapper that has routes), the counts set to 0 just before
    ``run()`` and read just after."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.serve.engine import Request, ServingEngine
    eng = ServingEngine(model, params, batch_slots=SERVE_SLOTS,
                        cache_len=SERVE_CACHE_LEN, scheduler="continuous",
                        fast_path=True)
    for i, p in enumerate(prompts):
        eng.submit(Request(i, p, max_tokens=max_tokens))
    for w in wrappers:
        build.zero_launches(w)
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return (eng, done, secs, {w: w.launches for w in wrappers},
            {w: dict(w.launches_by_route) for w in wrappers
             if hasattr(w, "launches_by_route")})


def fit_depth(device, cfg):
    """The most repeats of ``cfg``'s block pattern that one card holds at
    full width, measured: from the largest count whose weights and decode
    cache fit in the free memory less FIT_MARGIN_BYTES, down, draw the
    weights on the card from seed 0, allocate the SERVE_SLOTS x
    SERVE_CACHE_LEN decode cache and run one MAMBA_PREFILL-token
    prefill; a count that runs out of memory is
    freed and the next one tried. Returns (cfg at that depth, model,
    params), and prints the memory and the reduction."""
    import torch
    from repro_torch.models.model import Model
    n_pat = len(cfg.block_pattern)
    free, total = torch.cuda.mem_get_info(device)
    reps = cfg.n_repeats

    def need(reps):
        model = Model(cfg.replace(n_layers=reps * n_pat), device=device)
        return (model.weight_bytes()
                + model.cache_bytes(SERVE_SLOTS, SERVE_CACHE_LEN))

    print(f"depth {cfg.name}: {cfg.n_layers} layers need "
          f"{need(reps) / 1e9:.3f} GB of weights and decode cache; "
          f"{free / 1e9:.3f} GB free of {total / 1e9:.3f} GB")
    while reps > 0 and need(reps) + FIT_MARGIN_BYTES > free:
        reps -= 1
    while reps > 0:
        model = Model(cfg.replace(n_layers=reps * n_pat), device=device)
        torch.cuda.reset_peak_memory_stats(device)
        try:
            params = model.init(seed=0)
            cache = model.init_cache(SERVE_SLOTS, SERVE_CACHE_LEN)
            with torch.inference_mode():
                logits, one = model.prefill(
                    params, {"tokens": _prompt(model, MAMBA_PREFILL)},
                    cache_len=SERVE_CACHE_LEN)
            torch.cuda.synchronize()
        except torch.cuda.OutOfMemoryError as err:
            print(f"depth {cfg.name}: {reps * n_pat} layers ran out of "
                  f"memory ({str(err).splitlines()[0]})")
            params = cache = logits = one = None
            torch.cuda.empty_cache()
            reps -= 1
            continue
        peak = torch.cuda.max_memory_allocated(device)
        require(bool(torch.isfinite(logits).all()),
                f"{cfg.name} depth probe: logits are not finite")
        del cache, one, logits
        torch.cuda.empty_cache()
        free_after, _ = torch.cuda.mem_get_info(device)
        print(f"depth {cfg.name}: {model.cfg.n_layers} layers hold "
              f"{model.weight_bytes() / 1e9:.3f} GB of weights; with the "
              f"{SERVE_SLOTS} x {SERVE_CACHE_LEN} decode cache and one "
              f"{MAMBA_PREFILL}-token prefill the peak allocated is "
              f"{peak / 1e9:.3f} GB; mem_get_info before {free / 1e9:.3f} GB "
              f"free, after (cache freed) {free_after / 1e9:.3f} GB free of "
              f"{total / 1e9:.3f} GB")
        print(f"reduced: n_layers {cfg.n_layers} \u2192 {model.cfg.n_layers} "
              f"(one card holds {peak / 1e9:.2f} GB of {total / 1e9:.2f})")
        return model.cfg, model, params
    raise SmokeFailure(f"{cfg.name}: not one repeat of the pattern fits")


def check_f32_depth(device, arch: str) -> None:
    """``arch`` at full width with float32 weights drawn on the card from
    seed 0 (no other weights resident), at the most repeats of its pattern
    whose float32 weights fit in the free memory less F32_MARGIN_BYTES
    (at least one): its logits through the kernels against the plain
    versions, where only the fp32 summation order differs."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    cfg = get_config(arch).replace(dtype="float32")
    n_pat = len(cfg.block_pattern)
    free = torch.cuda.mem_get_info(device)[0] - F32_MARGIN_BYTES
    reps = cfg.n_repeats
    while reps > 1 and Model(cfg.replace(n_layers=reps * n_pat),
                             device=device).weight_bytes() > free:
        reps -= 1
    model = Model(cfg.replace(n_layers=reps * n_pat), device=device)
    if reps < cfg.n_repeats:
        print(f"reduced: float32 n_layers {cfg.n_layers} \u2192 "
              f"{reps * n_pat} (weights {model.weight_bytes() / 1e9:.2f} GB "
              f"of {free / 1e9:.2f} GB free less the margin)")
    params = model.init(seed=0)
    print(f"serve {arch}: {reps * n_pat} of {cfg.n_layers} layers, "
          f"{model.weight_bytes() / 1e9:.3f} GB of float32 weights drawn on "
          f"the card; {torch.cuda.memory_allocated(device) / 1e9:.2f} GB "
          "allocated")
    check_full_width_step(model, params, rtol=LOGITS_RTOL_F32)


def serve_full_width(device, arch: str, wrappers) -> dict:
    """``arch`` at full width in bf16 on the card, at full depth or, where
    the weights do not fit one card, at the depth :func:`fit_depth`
    measures: the kernel-vs-plain checks, then the engine over
    SERVE_REQUESTS requests."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import events
    from repro_torch.core.metrics import percentile
    from repro_torch.models.layers import map_tree
    from repro_torch.models.model import Model
    cfg = get_config(arch)
    t0 = time.perf_counter()
    model = Model(cfg, device=device)
    if model.weight_bytes() > torch.cuda.mem_get_info(device)[0]:
        cfg, model, params = fit_depth(device, cfg)
    else:
        params = model.init(seed=0)
    torch.cuda.synchronize()
    weight_bytes = model.weight_bytes()
    print(f"serve {arch}: {model.n_params():,} parameters in {cfg.n_layers} "
          f"layers ({cfg.dtype}, {weight_bytes / 1e9:.3f} GB) drawn on the "
          f"card in {time.perf_counter() - t0:.1f} s; "
          f"{torch.cuda.memory_allocated(device) / 1e9:.2f} GB allocated")
    kinds = {spec.kind for spec in cfg.block_pattern}
    # over 32 bf16 layers of random weights a one-ulp flip of a scan output
    # moves the logits by ~0.1 of the largest (a change of the plain scan's
    # summation order alone does), and a bf16 rounding that flips one of
    # the experts a token takes moves them far more than rounding: there
    # the kernels are held layer by layer in bf16, and the whole step with
    # the same weights widened to float32 (its routes compared first). A
    # Mamba arch's float32 step runs once these weights are freed
    if "rwkv" in kinds:
        check_scan_layers(model, params, ("rwkv_scan", "rwkv_decode_step"))
    elif "mamba" in kinds:
        check_scan_layers(model, params, ("mamba_scan", "mamba_decode_step"))
    else:
        check_attention_layers(model, params)
    # (deepseek-v2's MoE step in float32 after its bf16 weights are freed:
    # widened beside them it does not fit)
    if "rwkv" in kinds or (cfg.moe is not None and "mamba" not in kinds
                           and arch not in F32_AFTER):
        wide = Model(cfg.replace(dtype="float32"), device=device)
        check_full_width_step(
            wide, map_tree(lambda t: t.float(), params), rtol=LOGITS_RTOL_F32)
        del wide
    elif "mamba" not in kinds and cfg.moe is None:
        check_full_width_step(model, params, rtol=LOGITS_RTOL)
    # warm-up outside the counts: cuBLAS handles and the kernel libraries
    run_serve(model, params, serve_requests(cfg, 2, seed=2), 2)
    prompts = serve_requests(cfg, SERVE_REQUESTS, seed=0)
    if any(spec.window for spec in cfg.block_pattern):
        prompts.append(np.random.default_rng(4).integers(
            0, cfg.vocab_size, LONG_PROMPT))
    torch.cuda.reset_peak_memory_stats(device)
    eng, done, secs, launches, routes = run_serve(
        model, params, prompts, SERVE_MAX_TOKENS, wrappers)
    peak = torch.cuda.max_memory_allocated(device)
    n_tok = sum(len(r.tokens) for r in done)
    ticks = eng.d2h_syncs - len(prompts)     # one fetch a prefill, one a tick
    decode_s = sum(ev.duration for ev in eng.log.events
                   if ev.stage == "decode")
    prefill_s = sum(ev.duration for ev in eng.log.events
                    if ev.stage == "prefill")
    ttft = eng.ttft_samples()
    rep = eng.log.ai_tax({"prefill", "decode"}, category_of=events.categorize)
    booked = eng.log.transfer_bytes()
    print(f"serve {arch} bf16: {len(done)} of {len(prompts)} requests, "
          f"{n_tok} tokens in {secs:.3f} s; prompt lengths "
          f"{sorted(len(p) for p in prompts)}")
    print(f"serve {arch}: decode {n_tok - len(done)} tokens in "
          f"{decode_s:.3f} s of {ticks} decode ticks = "
          f"{(n_tok - len(done)) / decode_s:.1f} tokens/s, "
          f"{decode_s / ticks * 1e3:.2f} ms a tick against a weight-streaming "
          f"floor of {weight_bytes / PEAK_BYTES_S * 1e3:.2f} ms; prefill "
          f"{prefill_s:.3f} s for {sum(len(p) for p in prompts)} prompt "
          f"tokens; TTFT p50 {percentile(ttft, 0.5) * 1e3:.1f} ms p99 "
          f"{percentile(ttft, 0.99) * 1e3:.1f} ms")
    print(f"serve {arch} five-way=" + json.dumps(
        {k: round(v, 4) for k, v in rep["fractions"].items()})
          + f"; d2h_syncs={eng.d2h_syncs} d2h_bytes={eng.d2h_bytes} "
          f"ledger={booked}; peak memory {peak / 1e9:.2f} GB")
    require(len(done) == len(prompts) and all(
        r.done and len(r.tokens) == SERVE_MAX_TOKENS for r in done),
        f"full-width {arch} serve: not every request completed")
    require(booked["d2h"] == eng.d2h_bytes,
            f"ledger books {booked['d2h']} d2h bytes, engine fetched "
            f"{eng.d2h_bytes}")
    require(all(0 <= t < cfg.vocab_size for r in done for t in r.tokens),
            f"full-width {arch} serve: token out of the vocabulary")
    return {"model": model, "params": params, "launches": launches,
            "routes": routes, "cfg": cfg, "prefills": len(prompts),
            "prompt_lens": [len(p) for p in prompts], "ticks": ticks,
            "tick_ms": decode_s / ticks * 1e3}


def profile_serve(model, params, cfg) -> None:
    """Where a (shorter) full-width serve run's time goes: device busy
    share of the wall time, kernel time by name (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile
    prompts = serve_requests(cfg, SERVE_SLOTS, seed=3)
    # CUDA activity alone: only the kernels' device times are read, and
    # recording every host op as well slowed the profiled run and made its
    # summary take most of each arch's serve phase
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        eng, done, secs, _, _ = run_serve(model, params, prompts, 16)
    kernels = device_times(prof)
    busy_us = sum(e.self_device_time_total for e in kernels)
    decode_s = sum(ev.duration for ev in eng.log.events
                   if ev.stage == "decode")
    print(f"profile serve {cfg.name} ({len(prompts)} requests x 16 tokens): "
          f"wall {secs:.3f} s (decode ticks {decode_s:.3f} s); device busy "
          f"{busy_us / 1e3:.3f} ms = {busy_us / 1e6 / secs:.5f} of the wall")
    ranked = sorted(kernels, key=lambda e: -e.self_device_time_total)
    # the ten largest, then the port's own kernels below them
    for e in ranked[:10] + [e for e in ranked[10:]
                            if "anonymous namespace" in e.key]:
        print(f"profile serve {cfg.name} device time "
              f"{e.self_device_time_total / 1e3:.3f} ms x{e.count}: "
              f"{e.key[:90]}")


# --------------------------------------------------------------------------
# Phase 7: times
# --------------------------------------------------------------------------

def forced_route(module, chooser: str, route: str):
    """A context in which ``module``'s route chooser (flash's ``"_route"``,
    the scans' ``"_rwkv_bwd_route"``...) answers ``route`` whatever the
    shape: a shape's other route, run beside the one it takes on the same
    card and inputs."""
    from unittest import mock
    return mock.patch.object(module, chooser, lambda *args: route)


def forced_route_ms(fa, chooser: str, route: str, call, iters: int) -> float:
    """Device ms of ``call`` with flash's route chooser (``"_route"`` or
    ``"_bwd_route"``) answering ``route`` whatever the shape: a shape's
    earlier route, timed beside its new one on the same card."""
    with forced_route(fa, chooser, route):
        return cuda_time_ms(call, iters=iters)


def sdpa_call(q, k, v, *, causal: bool, mask=None):
    """PyTorch's fused attention on the kernels' inputs (B, S, heads, D),
    as a timing yardstick only: the port never calls it. Where this PyTorch
    has no ``enable_gqa``, K and V are expanded to all heads beforehand,
    outside the timed call."""
    import torch.nn.functional as F
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if "enable_gqa" in (F.scaled_dot_product_attention.__doc__ or ""):
        return lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, is_causal=causal, enable_gqa=True)
    G = q.shape[2] // k.shape[2]
    kt, vt = (t.repeat_interleave(G, dim=1) for t in (kt, vt))
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                  is_causal=causal)


def sdpa_backward_call(q, k, v, do, *, causal: bool, mask=None):
    """PyTorch's fused attention's backward through autograd, on the
    kernels' inputs (with ``mask``, an explicit boolean mask in place of
    ``causal``), as a timing yardstick only: the forward runs once here,
    and the returned call takes the gradients of its kept graph."""
    import torch
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    out = sdpa_call(*leaves, causal=causal and mask is None, mask=mask)()
    grad = do.transpose(1, 2)
    return lambda: torch.autograd.grad(out, leaves, grad, retain_graph=True)


def bwd_work(q, k, v, kw: dict) -> tuple[int, int]:
    """(bytes, operations) of one flash backward call: each input read once
    (q, k, v, o, dO in their dtype, lse in float32) and each output written
    once (dQ, dK, dV), against 2 (3 D + 2 Dv) FLOP (S, dP, dV, dK, dQ) for
    every visible (query, key) pair of every head, counted from the mask of
    this call (causal, window, q_offset)."""
    from repro_torch.kernels import flash_attention as fa
    B, Sq, H, D = q.shape
    Skv, Dv = v.shape[1], v.shape[3]
    visible = int(fa._mask(Sq, Skv, kw.get("causal", True), kw.get("window"),
                           kw.get("q_offset", 0), q.device).sum().item())
    es = q.element_size()
    nbytes = (es * (2 * q.numel() + 2 * k.numel() + 2 * v.numel()
                    + 2 * B * Sq * H * Dv) + 4 * B * H * Sq)
    return nbytes, 2 * (3 * D + 2 * Dv) * B * H * visible


# the wide backward routes' timed rows, of BWD_SPLIT_CASES: gemma3-12b's
# and deepseek-v2-236b's training shapes, and gemma3 at S = 2,048 past its
# window (SDPA given the window's explicit mask)
BWD_SPLIT_TIMED = tuple(BWD_SPLIT_CASES[i] for i in (0, 1, 5))


def time_split_bwd(device) -> dict:
    """The flash backward (bf16) at BWD_SPLIT_TIMED, the wide routes, and
    at BWD_TRAIN_CASES, the zoo's other training head shapes on wgmma:
    kernel on its route, plain formulas and SDPA's eager backward
    (autograd) beside the bound (bwd_work); at MLA's shape also the split
    route forced (its earlier route), timed in turns with the kv128 one
    (kv128, split, kv128, split: ``ms`` and ``split_ms`` the first of
    each, ``ms_again`` and ``split_ms_again`` the second). Returns
    {"flash_attention_bwd_split": gemma3's training row,
    "flash_attention_bwd_kv128": MLA's, "flash_attention_bwd_zoo": {label:
    row} of BWD_TRAIN_CASES}."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    out = {"flash_attention_bwd_zoo": {}}
    for label, B, Sq, Skv, heads, Dv, kw in BWD_SPLIT_TIMED + BWD_TRAIN_CASES:
        q, k, v, do, o, lse = bwd_case_inputs(device, torch.bfloat16, B, Sq,
                                              Skv, heads, Dv, kw, seed=3)
        nbytes, flops = bwd_work(q, k, v, kw)
        route = fa._bwd_route(q.dtype, q.shape[-1], v.shape[-1])
        t = _timed("flash_attention_bwd",
                   f"{label} bf16 q{tuple(q.shape)} k{tuple(k.shape)} "
                   f"v{tuple(v.shape)} {kw} ({route} route)",
                   lambda: fa.flash_attention_bwd(q, k, v, o, lse, do, **kw),
                   lambda: fa.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                                        **kw),
                   None, nbytes, flops, iters=3,
                   peak_flop_s=PEAK_BF16_FLOP_S)
        mask = (fa._mask(Sq, Skv, True, kw["window"], 0, device)
                if kw.get("window") else None)
        t["library_ms"] = eager_time_ms(
            sdpa_backward_call(q, k, v, do, causal=kw["causal"], mask=mask),
            iters=5)
        print(f"time flash_attention_bwd yardstick SDPA backward (autograd, "
              f"eager{', explicit window mask' if mask is not None else ''}) "
              f"{label} bf16: {t['library_ms']:.6f} ms")
        if route == "wgmma_kv128":
            call = lambda: fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
            t["split_ms"] = forced_route_ms(fa, "_bwd_route", "wgmma_split",
                                            call, iters=3)
            t["ms_again"] = cuda_time_ms(call, iters=3)
            t["split_ms_again"] = forced_route_ms(
                fa, "_bwd_route", "wgmma_split", call, iters=3)
            print(f"time flash_attention_bwd yardstick {label} bf16 on the "
                  f"wgmma_split route (its earlier route), in turns with "
                  f"wgmma_kv128: kv128 {t['ms']:.6f} | {t['ms_again']:.6f} "
                  f"ms, split {t['split_ms']:.6f} | {t['split_ms_again']:.6f} "
                  f"ms")
        if route == "wgmma":
            out["flash_attention_bwd_zoo"][label] = t
        else:
            out.setdefault("flash_attention_bwd_"
                           + ("kv128" if route == "wgmma_kv128" else "split"),
                           t)
        del q, k, v, do, o, lse, mask
        torch.cuda.empty_cache()
    return out


def tap_work(n_planes: int, taps_y, taps_x, out_rows: int, out_cols: int,
             elem: int) -> tuple[int, int]:
    """(bytes, operations) of a 2-tap resize of ``n_planes`` planes of
    ``elem``-byte values to ``out_rows`` x ``out_cols`` computed outputs a
    plane, the output's store left out: every input value that a non-zero
    row tap and column tap reach, read once, and the four tables; ~6
    operations a row-pass value (one a computed row and reached input
    column: 2 conversions, a product, an fma) and ~3 an output."""
    import torch
    rows = torch.unique(taps_y.idx[taps_y.w != 0]).numel()
    cols = torch.unique(taps_x.idx[taps_x.w != 0]).numel()
    nbytes = (n_planes * rows * cols * elem
              + 16 * (taps_y.idx.shape[0] + taps_x.idx.shape[0]))
    return nbytes, n_planes * (6 * out_rows * cols + 3 * out_rows * out_cols)


def _timed(name: str, shape: str, kernel, plain, library, nbytes: float,
           flops: float, iters: int,
           peak_flop_s: float = PEAK_FP32_FLOP_S, exps: float = 0.0) -> dict:
    """Device times of kernel, plain version and library call (ms), the
    kernel's eager per-call time, and the bound for this work."""
    t = {"ms": cuda_time_ms(kernel, iters=iters),
         "plain_ms": cuda_time_ms(plain, iters=iters),
         "library_ms": (None if library is None
                        else cuda_time_ms(library, iters=iters))}
    t["bound_ms"], t["bound_by"] = bound_ms(nbytes, flops, peak_flop_s, exps)
    t["eager_ms"] = eager_time_ms(kernel, iters=10 * iters)
    print(f"time {name} {shape}: " + json.dumps(t))
    return t


def time_yuv(device, scratch) -> dict:
    """The YUV decode at the paper's 1080p source (vec16 route), warm and
    with a cold L2."""
    import torch
    from repro_torch.kernels import preproc
    yuv = torch.randint(0, 256, (1, 3, SRC_H, SRC_W), generator=_gen(1),
                        dtype=torch.uint8).to(device)
    kernel = lambda: preproc.yuv_to_rgb(yuv)
    shape = f"(1,3,{SRC_H},{SRC_W})"
    # ~20 operations a pixel: 2 centrings, 4 fmas, 3 roundings, 6 clamps
    t = _timed("yuv_to_rgb", shape, kernel,
               lambda: preproc.yuv_to_rgb_plain(yuv), None,
               2 * yuv.numel(), 20 * SRC_H * SRC_W, iters=20)
    t["cold_ms"] = cold_time_ms(kernel, scratch)
    print(f"time yuv_to_rgb L2-cold ({L2_FLUSH_BYTES >> 20} MiB read before "
          f"each call) {shape}: " + json.dumps({"ms": t["cold_ms"]}))
    return t


def time_iou(device, scratch) -> dict:
    """The IoU kernel at device NMS's bucket sizes, warm and with a cold
    L2; returns N = 4096's, the one reported in the kernels line."""
    import torch
    from repro_torch.kernels import preproc
    times = {}
    for kind, battery in (("", box_battery),
                          (" every pair overlapping", dense_boxes)):
        for n in (4096, 1024, 256, 32):
            boxes, _ = battery(n, seed=n)
            bt = torch.from_numpy(boxes.T.copy()).to(device)
            kernel = lambda: preproc.iou_matrix(bt)
            shape = f"(4,{n})->({n},{n}){kind}"
            # 13 operations an element: 2 min, 4 max, 3 sub, 2 mul, 1 add,
            # 1 div
            t = _timed("iou_matrix", shape, kernel,
                       lambda: preproc.iou_matrix_plain(bt), None,
                       4 * (4 * n + n * n), 13 * n * n, iters=20)
            t["cold_ms"] = cold_time_ms(kernel, scratch)
            print(f"time iou_matrix L2-cold ({L2_FLUSH_BYTES >> 20} MiB read "
                  f"before each call) {shape}: "
                  + json.dumps({"ms": t["cold_ms"]}))
            times.setdefault(n, t)
    return times[4096]


def time_kernels(device) -> dict[str, dict]:
    """Times at the path's shapes; the first shape of each kernel is the
    one reported in the kernels line."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import linear_scan as ls
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import preproc, resize
    out = {}

    # matmul at every face batch of the path's three products, warm and with
    # a cold L2: on the frame path 6 MB frame copies run between calls
    scratch = torch.zeros(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                          device=device)
    for K, N, epi in MATMUL_SHAPES:
        for M in FACE_BATCHES[::-1]:
            a, b, _ = matmul_inputs(M, K, N, False, device)
            kernel = lambda: mm.matmul(a, b, epilogue=epi)
            library = ((lambda: torch.tanh(torch.matmul(a, b)))
                       if epi == "tanh" else (lambda: torch.matmul(a, b)))
            t = _timed("matmul", f"({M},{K})@({K},{N}) {epi} "
                       f"({mm._route(M)} route)", kernel,
                       lambda: mm.matmul_plain(a, b, epilogue=epi), library,
                       4 * (M * K + K * N + M * N), 2 * M * N * K, iters=50)
            cold = {"ms": cold_time_ms(kernel, scratch),
                    "library_ms": cold_time_ms(library, scratch)}
            print(f"time matmul L2-cold ({L2_FLUSH_BYTES >> 20} MiB read "
                  f"before each call) ({M},{K})@({K},{N}) {epi}: "
                  + json.dumps(cold))
            out.setdefault("matmul", t)
    out.update(time_cluster_matmul(device, scratch))

    out["yuv_to_rgb"] = time_yuv(device, scratch)

    oh, ow = SRC_H // 2, SRC_W // 2
    planes, ty, tx, sb, geom = letterbox_inputs(SRC_H, SRC_W, oh, ow, device)
    ch, cw = geom[:2]
    # the yardsticks take the dense operators and one dtype; not timed
    ly, lx = resize.expand_taps(ty), resize.expand_taps(tx)
    planes_f = planes.float()
    nb = planes.shape[0]
    lb_bytes, lb_ops = tap_work(nb, ty, tx, ch, cw, 1)
    out["letterbox_normalize"] = _timed(
        "letterbox_normalize", f"(3,{SRC_H},{SRC_W})->(3,{oh},{ow})",
        lambda: preproc.letterbox_normalize(planes, ty, tx, sb, geom),
        lambda: preproc.letterbox_normalize_plain(planes, ty, tx, sb, geom),
        lambda: torch.einsum("oh,nhw,pw->nop", ly, planes_f, lx),
        lb_bytes + 8 * nb + 4 * nb * oh * ow, lb_ops, iters=20)
    interp_ms = cuda_time_ms(
        lambda: F.interpolate(planes_f[None], size=(ch, cw), mode="bilinear",
                              align_corners=False), iters=20)
    print(f"time letterbox_normalize yardstick F.interpolate (1,3,{SRC_H},"
          f"{SRC_W})->({ch},{cw}) f32: {interp_ms:.6f} ms")

    img = resize_inputs((8, 48, 48, 3), device)
    ry, rx = resize._taps(32, 32, 48, 48, str(img.device))
    rs_bytes, rs_ops = tap_work(8 * 3, ry, rx, 32, 32, 4)
    out["resize_bilinear"] = _timed(
        "resize_bilinear", "(8,48,48,3)->(8,32,32,3)",
        lambda: resize.resize_bilinear(img, 32, 32),
        lambda: resize.resize_bilinear_plain(img, 32, 32),
        lambda: F.interpolate(img.permute(0, 3, 1, 2), size=(32, 32),
                              mode="bilinear", align_corners=False),
        rs_bytes + 4 * 8 * 32 * 32 * 3, rs_ops, iters=50)

    out["iou_matrix"] = time_iou(device, scratch)

    # the serve path's shapes: bf16 inputs, so the bound takes the dense
    # bf16 tensor-core peak; the library yardstick is PyTorch's SDPA

    for S in (1024, 512, 37):
        q, k, v = attn_inputs(S, S, torch.bfloat16, device)
        pairs = LLAMA_H * S * (S + 1) // 2            # causal (q, k) pairs
        t = _timed("flash_attention", f"bf16 q(1,{S},32,128) kv(1,{S},8,128) "
                   "causal",
                   lambda: fa.flash_attention(q, k, v, causal=True),
                   lambda: fa.flash_attention_plain(q, k, v, causal=True),
                   sdpa_call(q, k, v, causal=True),
                   2 * (2 * q.numel() + k.numel() + v.numel()),
                   4 * LLAMA_D * pairs, iters=10, peak_flop_s=PEAK_BF16_FLOP_S)
        out.setdefault("flash_attention", t)
    # the other attention archs' heads at a 1024-token prompt (granite's
    # D = 64 the wgmma route's other width)
    for arch, (H, KV, D) in ZOO_HEADS.items():
        S = 1024
        q, k, v = attn_inputs(S, S, torch.bfloat16, device, heads=(H, KV, D))
        pairs = H * S * (S + 1) // 2
        _timed("flash_attention", f"{arch} bf16 q(1,{S},{H},{D}) "
               f"kv(1,{S},{KV},{D}) causal",
               lambda: fa.flash_attention(q, k, v, causal=True),
               lambda: fa.flash_attention_plain(q, k, v, causal=True),
               sdpa_call(q, k, v, causal=True),
               2 * (2 * q.numel() + k.numel() + v.numel()),
               4 * D * pairs, iters=10, peak_flop_s=PEAK_BF16_FLOP_S)
    # gemma3-12b's windowed layers at its window W (at S = 1024 every key
    # is in it; at 1536 the rows past W skip the tiles left of their
    # window), against SDPA with the same mask; deepseek-v2's MLA prefill
    # (D = 192, Dv = 128) on the tensor-core route, and on its earlier
    # CUDA-core one
    H, KV, D = GEMMA_HEADS
    for S in (1024, LONG_PROMPT):
        q, k, v = attn_inputs(S, S, torch.bfloat16, device, heads=GEMMA_HEADS)
        pairs = H * sum(min(i + 1, GEMMA_W) for i in range(S))
        pos = torch.arange(S, device=device)
        mask = ((pos[None, :] <= pos[:, None])
                & (pos[None, :] > pos[:, None] - GEMMA_W))
        _timed("flash_attention", f"gemma3-12b bf16 q(1,{S},{H},{D}) "
               f"kv(1,{S},{KV},{D}) causal window {GEMMA_W}",
               lambda: fa.flash_attention(q, k, v, window=GEMMA_W),
               lambda: fa.flash_attention_plain(q, k, v, window=GEMMA_W),
               sdpa_call(q, k, v, causal=False, mask=mask),
               2 * (2 * q.numel() + k.numel() + v.numel()),
               4 * D * pairs, iters=10, peak_flop_s=PEAK_BF16_FLOP_S)
    S = 1024
    q, k, v = attn_inputs(S, S, torch.bfloat16, device,
                          heads=(MLA_H, MLA_H, MLA_D), Dv=MLA_DV)
    pairs = MLA_H * S * (S + 1) // 2
    _timed("flash_attention", f"deepseek-v2-236b MLA bf16 q(1,{S},{MLA_H},"
           f"{MLA_D}) k(1,{S},{MLA_H},{MLA_D}) v(1,{S},{MLA_H},{MLA_DV}) "
           f"causal ({fa._route(q.dtype, MLA_D, MLA_DV)} route)",
           lambda: fa.flash_attention(q, k, v, scale=MLA_SCALE),
           lambda: fa.flash_attention_plain(q, k, v, scale=MLA_SCALE),
           sdpa_call(q, k, v, causal=True),
           2 * (q.numel() + k.numel() + 2 * v.numel()),
           2 * (MLA_D + MLA_DV) * pairs, iters=10,
           peak_flop_s=PEAK_BF16_FLOP_S)
    t = forced_route_ms(fa, "_route", "simt",
                        lambda: fa.flash_attention(q, k, v, scale=MLA_SCALE),
                        iters=10)
    print(f"time flash_attention yardstick deepseek-v2-236b MLA bf16 S={S} "
          f"on the CUDA-core route (its earlier route): {t:.6f} ms")

    # whisper's: the encoder's bidirectional attention over 8 x 1,500
    # frames, the decoder's cross attention of its 187-token prompts and of
    # one decode row against them (MHA, D = 64)
    H, KV, D = WHISPER_HEADS
    for Sq, Skv in ((1500, 1500), (WHISPER_PROMPT, 1500), (1, 1500)):
        q, k, v = attn_inputs(Sq, Skv, torch.bfloat16, device,
                              heads=WHISPER_HEADS, B=WHISPER_B)
        _timed("flash_attention", f"{WHISPER} bf16 q({WHISPER_B},{Sq},{H},"
               f"{D}) kv({WHISPER_B},{Skv},{KV},{D}) non-causal",
               lambda: fa.flash_attention(q, k, v, causal=False),
               lambda: fa.flash_attention_plain(q, k, v, causal=False),
               sdpa_call(q, k, v, causal=False),
               2 * (2 * q.numel() + k.numel() + v.numel()),
               4 * D * H * Sq * Skv * WHISPER_B, iters=5 if Sq > 1 else 20,
               peak_flop_s=PEAK_BF16_FLOP_S)

    # the flash backward at llama3-8b's training shape (causal) and
    # whisper's encoder, bf16 and fp32 (the first row goes into the kernels
    # line); bound (bwd_work): 2 (3 D + 2 Dv) FLOP a visible (q, k) pair
    # and head on the input type's peak, against one read of q, k, v, o,
    # dO and lse and one write of dQ, dK, dV; the yardstick is SDPA's
    # backward (autograd)
    for dtype, peak in ((torch.bfloat16, PEAK_BF16_FLOP_S),
                        (torch.float32, PEAK_FP32_FLOP_S)):
        for label, B, S, heads, causal in BWD_SHAPES:
            H, KV, D = heads
            q, k, v, o, lse, do = bwd_inputs(B, S, heads, causal, dtype,
                                             device)
            nbytes, flops = bwd_work(q, k, v, {"causal": causal})
            t = _timed("flash_attention_bwd",
                       f"{label} {str(dtype).split('.')[1]} q{tuple(q.shape)}"
                       f" kv{tuple(k.shape)} {'causal' if causal else 'non-causal'}"
                       f" ({fa._bwd_route(dtype, D, D)} route)",
                       lambda: fa.flash_attention_bwd(q, k, v, o, lse, do,
                                                      causal=causal),
                       lambda: fa.flash_attention_bwd_plain(
                           q, k, v, o, lse, do, causal=causal),
                       None, nbytes, flops, iters=3, peak_flop_s=peak)
            t["library_ms"] = eager_time_ms(
                sdpa_backward_call(q, k, v, do, causal=causal), iters=5)
            print(f"time flash_attention_bwd yardstick SDPA backward "
                  f"(autograd, eager) {label} {str(dtype).split('.')[1]}: "
                  f"{t['library_ms']:.6f} ms")
            if dtype == torch.bfloat16:
                old = forced_route_ms(
                    fa, "_bwd_route", "mma",
                    lambda: fa.flash_attention_bwd(q, k, v, o, lse, do,
                                                   causal=causal), iters=3)
                print(f"time flash_attention_bwd yardstick {label} bf16 on "
                      f"the mma.sync route (its earlier route): "
                      f"{old:.6f} ms")
            out.setdefault("flash_attention_bwd", t)
            del q, k, v, o, lse, do
            torch.cuda.empty_cache()
    out.update(time_split_bwd(device))

    # decode with a cold L2 too: the engine's cache (67 MB a layer at full
    # length) exceeds the 50 MB L2, so a tick finds it in device memory
    for L in (2048, 768):
        q, k, v, lens = decode_inputs(L, torch.bfloat16, device)
        valid = int(lens.sum().item())                 # cache entries read
        mask = (torch.arange(L, device=device)[None, :]
                < lens[:, None])[:, None, None, :]
        kernel = lambda: da.decode_attention(q, k, v, kv_len=lens)
        library = sdpa_call(q, k, v, causal=False, mask=mask)
        t = _timed("decode_attention", f"bf16 q(8,1,32,128) kv(8,{L},8,128) "
                   f"kv_len={lens.tolist()}", kernel,
                   lambda: da.decode_attention_plain(q, k, v, kv_len=lens),
                   library,
                   2 * (2 * valid * LLAMA_KV * LLAMA_D + 2 * q.numel())
                   + 4 * lens.numel(),
                   4 * LLAMA_D * LLAMA_H * valid, iters=20,
                   peak_flop_s=PEAK_BF16_FLOP_S)
        if L == 2048:
            cold = {"ms": cold_time_ms(kernel, scratch),
                    "library_ms": cold_time_ms(library, scratch)}
            print(f"time decode_attention L2-cold ({L2_FLUSH_BYTES >> 20} MiB "
                  f"read before each call) kv(8,{L},8,128): "
                  + json.dumps(cold))
        out.setdefault("decode_attention", t)
    # the pairs the other attention archs add, at the engine's full cache
    for arch, (H, KV, D) in ZOO_HEADS.items():
        L = SERVE_CACHE_LEN
        q, k, v, lens = decode_inputs(L, torch.bfloat16, device,
                                      heads=(H, KV, D))
        valid = int(lens.sum().item())
        mask = (torch.arange(L, device=device)[None, :]
                < lens[:, None])[:, None, None, :]
        kernel = lambda: da.decode_attention(q, k, v, kv_len=lens)
        library = sdpa_call(q, k, v, causal=False, mask=mask)
        _timed("decode_attention", f"{arch} bf16 q(8,1,{H},{D}) "
               f"kv(8,{L},{KV},{D}) G={H // KV} kv_len={lens.tolist()}",
               kernel,
               lambda: da.decode_attention_plain(q, k, v, kv_len=lens),
               library, 2 * (2 * valid * KV * D + 2 * q.numel())
               + 4 * lens.numel(), 4 * D * H * valid, iters=20,
               peak_flop_s=PEAK_BF16_FLOP_S)
        cold = {"ms": cold_time_ms(kernel, scratch),
                "library_ms": cold_time_ms(library, scratch)}
        print(f"time decode_attention L2-cold ({L2_FLUSH_BYTES >> 20} MiB "
              f"read before each call) {arch} kv(8,{L},{KV},{D}): "
              + json.dumps(cold))
    # whisper's decoder self-attention: G = 1 over its 448-entry cache
    H, KV, D = WHISPER_HEADS
    q, k, v, lens = decode_inputs(WHISPER_CACHE, torch.bfloat16, device,
                                  heads=WHISPER_HEADS)
    valid = int(lens.sum().item())
    mask = (torch.arange(WHISPER_CACHE, device=device)[None, :]
            < lens[:, None])[:, None, None, :]
    _timed("decode_attention", f"{WHISPER} bf16 q(8,1,{H},{D}) "
           f"kv(8,{WHISPER_CACHE},{KV},{D}) G=1 kv_len={lens.tolist()}",
           lambda: da.decode_attention(q, k, v, kv_len=lens),
           lambda: da.decode_attention_plain(q, k, v, kv_len=lens),
           sdpa_call(q, k, v, causal=False, mask=mask),
           2 * (2 * valid * KV * D + 2 * q.numel()) + 4 * lens.numel(),
           4 * D * H * valid, iters=20, peak_flop_s=PEAK_BF16_FLOP_S)
    # gemma3-12b's windowed layers' rolling cache of W entries
    H, KV, D = GEMMA_HEADS
    q, k, v, lens = decode_inputs(GEMMA_W, torch.bfloat16, device,
                                  heads=GEMMA_HEADS)
    valid = int(lens.sum().item())
    mask = (torch.arange(GEMMA_W, device=device)[None, :]
            < lens[:, None])[:, None, None, :]
    _timed("decode_attention", f"gemma3-12b windowed bf16 q(8,1,{H},{D}) "
           f"kv(8,{GEMMA_W},{KV},{D}) G={H // KV} kv_len={lens.tolist()}",
           lambda: da.decode_attention(q, k, v, kv_len=lens),
           lambda: da.decode_attention_plain(q, k, v, kv_len=lens),
           sdpa_call(q, k, v, causal=False, mask=mask),
           2 * (2 * valid * KV * D + 2 * q.numel()) + 4 * lens.numel(),
           4 * D * H * valid, iters=20, peak_flop_s=PEAK_BF16_FLOP_S)

    # the RWKV6 scan at the serve path's shapes: a 1024-token prefill and a
    # ragged 37-token one from a zero state (the chunked route), then one
    # decode step of 8 slots on their state, in place (the serial route).
    # 5 FLOP an (i, j) state element a step: r_i h_ij (2) and
    # w_i h_ij + k_i v_j (3); the bonus needs only (sum_i r_i u_i k_i) v_j,
    # 3 K + 2 V a head-step. The chunked route does them on the tf32 tensor
    # cores, the serial one on fp32 FMAs. No library call computes the scan.
    for B, S in ((1, RWKV_PREFILL), (1, 37), (RWKV_DECODE_B, 1)):
        r, w, k, v, u, h0 = scan_inputs(B, S, torch.bfloat16, device)
        n = B * S * RWKV_H * RWKV_K
        state = B * RWKV_H * RWKV_K * RWKV_K * 4
        if S == 1:
            args = (r[:, 0], w[:, 0], k[:, 0], v[:, 0], u, h0)
            kernel = lambda: ls.rwkv_decode_step(*args)
            plain = lambda: ls.rwkv_decode_step_plain(*args)
            nbytes = 4 * n * 2 + 4 * n + 2 * u.numel() + 2 * state
        else:
            kernel = lambda: ls.rwkv_scan(r, w, k, v, u)
            plain = lambda: ls.rwkv_scan_plain(r, w, k, v, u)
            nbytes = 4 * n * 2 + 4 * n + 2 * u.numel() + state
        route = ls._route(r.dtype, RWKV_K, RWKV_K, S)
        t = _timed("rwkv_scan", f"bf16 r(B={B},S={S},{RWKV_H},{RWKV_K}) "
                   f"{'state in place' if S == 1 else 'zero state'} "
                   f"({route} route)",
                   kernel, plain, None, nbytes, 5 * n * RWKV_K + 5 * n,
                   iters=5 if S > 1 else 20,
                   peak_flop_s=(PEAK_TF32_FLOP_S if route == "chunk"
                                else PEAK_FP32_FLOP_S))
        out.setdefault("rwkv_scan", t)
    # yardstick: both routes' kernels on the same bf16 prompts from a zero
    # state, around the length where ``_route`` starts the chunked one;
    # timed only (the launches count, but the counts are zeroed before
    # every path)
    for S in (RWKV_PREFILL, 64, 37, ls.CHUNK_MIN_S, ls.CHUNK_MIN_S - 1, 16,
              8, 2):
        r, w, k, v, u, h0 = scan_inputs(1, S, torch.bfloat16, device)
        uf, state = u.float().contiguous(), torch.empty_like(h0)
        times = {route: cuda_time_ms(
            lambda: ls._launch(route, r, w, k, v, uf, None, state),
            iters=5 if S > 64 else 20) for route in ("chunk", "serial")}
        taken = ls._route(r.dtype, RWKV_K, RWKV_K, S)
        print(f"time rwkv_scan yardstick both routes bf16 r(B=1,S={S},"
              f"{RWKV_H},{RWKV_K}) zero state ({taken} route taken): "
              + json.dumps(times))

    out["mamba_scan"] = time_mamba(device, scratch)
    del scratch
    out.update(time_scan_bwd(device))
    return out


def tile_plan(M: int, K: int, N: int, n_sm: int) -> dict:
    """The tile route's launch plan at (M, K, N): the analytic pick among
    its candidates, as the committed seed held it while the cluster's
    batches took that route, tuned into a scratch cache."""
    import tempfile
    from repro_torch.kernels import autotune as at
    from repro_torch.kernels import matmul as mm
    with forced_route(mm, "_route", "tile"), \
            tempfile.TemporaryDirectory() as tmp:
        cache = at.AutotuneCache(path=Path(tmp) / "tile.json", seed_path=None)
        return at.matmul_plan(M, K, N, n_sm, cache=cache)


def time_cluster_matmul(device, scratch) -> dict:
    """The cluster's replica batches: the fused identify's two products at
    the padded row counts above 8, on the rows route, beside the tile route
    they took before (forced, at :func:`tile_plan`) and the library call,
    warm and with a cold L2; the two routes in turns (rows, tile, rows,
    tile: ``ms`` and ``tile_ms`` the first of each, ``ms_again`` and
    ``tile_ms_again`` the second). Returns {"matmul_rows": the (64, 6912)
    row's times}."""
    import torch
    from repro_torch.kernels import matmul as mm
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    out = {}
    for K, N, epi in MATMUL_SHAPES[:2]:
        for M in CLUSTER_BATCHES[::-1]:
            a, b, _ = matmul_inputs(M, K, N, False, device)
            kernel = lambda: mm.matmul(a, b, epilogue=epi)
            library = ((lambda: torch.tanh(torch.matmul(a, b)))
                       if epi == "tanh" else (lambda: torch.matmul(a, b)))
            t = _timed("matmul", f"cluster batch ({M},{K})@({K},{N}) {epi} "
                       f"({mm._route(M)} route)", kernel,
                       lambda: mm.matmul_plain(a, b, epilogue=epi), library,
                       4 * (M * K + K * N + M * N), 2 * M * N * K, iters=50)
            plan = tile_plan(M, K, N, n_sm)
            tile = lambda: mm.matmul(a, b, epilogue=epi, plan=plan)
            with forced_route(mm, "_route", "tile"):
                t["tile_ms"] = cuda_time_ms(tile, iters=50)
            t["ms_again"] = cuda_time_ms(kernel, iters=50)
            with forced_route(mm, "_route", "tile"):
                t["tile_ms_again"] = cuda_time_ms(tile, iters=50)
                cold_tile = cold_time_ms(tile, scratch)
            print(f"time matmul yardstick cluster batch ({M},{K})@({K},{N}) "
                  f"{epi} on the tile route (its earlier route, plan {plan}), "
                  f"in turns with the rows route: rows {t['ms']:.6f} | "
                  f"{t['ms_again']:.6f} ms, tile {t['tile_ms']:.6f} | "
                  f"{t['tile_ms_again']:.6f} ms")
            cold = {"ms": cold_time_ms(kernel, scratch), "tile_ms": cold_tile,
                    "library_ms": cold_time_ms(library, scratch)}
            print(f"time matmul L2-cold ({L2_FLUSH_BYTES >> 20} MiB read "
                  f"before each call) cluster batch ({M},{K})@({K},{N}) "
                  f"{epi}: " + json.dumps(cold))
            out.setdefault("matmul_rows", t)
    return out


def time_scan_bwd(device) -> dict:
    """Both scan backwards at the training shapes, bf16 (4 x 1,024 tokens:
    rwkv6-3b's 40 heads of 64, the chunked forward's checkpoints; jamba's
    Di 8,192, N 16, the segmented forward's), zero initial state and no
    final-state gradient, as the training step calls them; and in fp32.
    Every route that takes the shape is timed in the same run (the chunked
    routes beside the serial kernels they replace on the training path);
    the row's times are those of the route the shape takes. Bound: the
    function's bytes (each input, the checkpoints included, read once, each
    gradient written once) against its operations: RWKV6 12 FLOP a state
    element a step (S_{t-1} do, G v, G o S_{t-1}, G^T k, the adjoint's fma
    and the state's), Mamba 18 and one exponential (the state, the adjoint
    and the five gradients' terms); no library call computes either.
    Returns each kernel's bf16 times."""
    import torch
    from repro_torch.kernels import linear_scan as ls
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[1]
        for kind, cases in (("rwkv", RWKV_BWD_CASES),
                            ("mamba", MAMBA_BWD_CASES)):
            label, B, S, dims, _, _ = cases[0]
            ins, fwd, route = scan_bwd_inputs(kind, B, S, dims, dtype,
                                              device, False, False)
            routes = scan_bwd_routes(kind, dtype, dims)
            size = dtype.itemsize
            g = _gen(17)
            if kind == "rwkv":
                r, w, k, v, u, _ = ins
                uf = u.float().contiguous()
                do = torch.randn(v.shape, generator=g).to(device, dtype)
                plain = lambda: ls.rwkv_scan_bwd_plain(r, w, k, v, uf, None,
                                                       do)
                n = r.numel()
                nbytes = (7 * n * size + 8 * n + 8 * uf.numel()
                          + 4 * n * RWKV_K // ls.CHUNK)
                elems = n * RWKV_K
                flops, exps = 12 * elems, 0
                kernels = {rt: scan_bwd_thunk(kind, ins, do, None, rt)
                           for rt in routes}
            else:
                delta, A, Bt, Ct, x, _ = ins
                dy = torch.randn(x.shape, generator=g).to(device, dtype)
                plain = lambda: ls.mamba_scan_bwd_plain(delta, A, Bt, Ct, x,
                                                        None, dy)
                n = delta.numel()
                nbytes = (5 * n * size + 4 * Bt.numel() * size
                          + 8 * A.numel()
                          + 4 * n * MAMBA_N * -(-S // ls.CHUNK) // S)
                elems = n * MAMBA_N
                flops, exps = 18 * elems, elems
                kernels = {rt: scan_bwd_thunk(kind, ins, dy, None, rt)
                           for rt in routes}
            route_ms = {rt: cuda_time_ms(fn, iters=5)
                        for rt, fn in kernels.items()}
            t = {"ms": route_ms[routes[0]],
                 "plain_ms": cuda_time_ms(plain, iters=1),
                 "library_ms": None}
            t["bound_ms"], t["bound_by"] = bound_ms(nbytes, flops,
                                                    exps=exps)
            t["eager_ms"] = eager_time_ms(kernels[routes[0]], iters=20)
            t["route_ms"] = route_ms
            print(f"time {kind}_scan_bwd {label} {name} "
                  f"{tuple(ins[0].shape)} dims {dims} ({route} forward's "
                  f"checkpoints, {routes[0]} backward route): "
                  + json.dumps(t))
            out.setdefault(f"{kind}_scan_bwd", t)
            del ins, kernels, plain
            torch.cuda.empty_cache()
    return out


def time_mamba(device, scratch) -> dict:
    """The Mamba scan's times (``scratch`` the L2 flush of
    :func:`cold_time_ms`); returns the prefill's, the one reported in the
    kernels line."""
    import torch
    from repro_torch.kernels import linear_scan as ls
    first = None
    # the Mamba scan at jamba's serve shapes: a 1024-token prefill from a
    # zero state (the segmented route), one decode step of 8 slots on their
    # state, in place (the step route), and a ragged 37-token prefill; warm
    # and with a cold L2. 6 FLOP a state element a step (delta A, exp(.) h,
    # (delta x) B, the add, h C, the add) and 1 a channel-step (delta x), and
    # one exponential a state element a step on the SFU, which binds the
    # prefills (the segmented route computes each twice: its own floor is
    # twice the bound). No library call computes the scan.
    for B, S in ((1, MAMBA_PREFILL), (MAMBA_DECODE_B, 1), (1, 37)):
        delta, A, Bt, Ct, x, h0 = mamba_inputs(B, S, torch.bfloat16, device)
        n = B * S * MAMBA_DI
        state = B * MAMBA_DI * MAMBA_N * 4
        nbytes = 3 * 2 * n + 2 * 2 * B * S * MAMBA_N + 4 * A.numel() + state
        if S == 1:
            args = (delta[:, 0], A, Bt[:, 0], Ct[:, 0], x[:, 0], h0)
            kernel = lambda: ls.mamba_decode_step(*args)
            plain = lambda: ls.mamba_decode_step_plain(*args)
            nbytes += state
        else:
            kernel = lambda: ls.mamba_scan(delta, A, Bt, Ct, x)
            plain = lambda: ls.mamba_scan_plain(delta, A, Bt, Ct, x)
        shape = (f"bf16 delta,x (B={B},S={S},{MAMBA_DI}) N={MAMBA_N} "
                 f"{'state in place' if S == 1 else 'zero state'} "
                 f"({ls._mamba_route(torch.bfloat16, MAMBA_N, S)} route)")
        t = _timed("mamba_scan", shape, kernel, plain, None, nbytes,
                   (6 * MAMBA_N + 1) * n, iters=5 if S > 64 else 20,
                   exps=n * MAMBA_N)
        cold = {"ms": cold_time_ms(kernel, scratch)}
        print(f"time mamba_scan L2-cold ({L2_FLUSH_BYTES >> 20} MiB read "
              f"before each call) {shape}: " + json.dumps(cold))
        first = first or t
    # yardstick: the segmented and serial kernels on the same prompts from a
    # zero state, in bf16 and fp32, by S (where they meet sets
    # MAMBA_SEG_MIN_S), and the step and serial kernels on the decode step;
    # timed only (the launches count, but the counts are zeroed before
    # every path)
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[1]
        seqs = sorted({1024, 256, 64, 37, 32, 16, ls.MAMBA_SEG_MIN_S,
                       ls.MAMBA_SEG_MIN_S - 1, 8, 2}, reverse=True)
        for B, S in [(1, S) for S in seqs] + [(MAMBA_DECODE_B, 1)]:
            delta, A, Bt, Ct, x, h0 = mamba_inputs(B, S, dtype, device)
            Af, state = A.float().contiguous(), torch.empty_like(h0)
            routes = ("step" if S == 1 else "segmented", "serial")
            times = {route: cuda_time_ms(
                lambda: ls._launch_mamba(route, delta, x, Af, Bt, Ct, None,
                                         state),
                iters=5 if S > 64 else 20) for route in routes}
            taken = ls._mamba_route(dtype, MAMBA_N, S)
            print(f"time mamba_scan yardstick both routes {name} delta(B={B},"
                  f"S={S},{MAMBA_DI}) N={MAMBA_N} zero state ({taken} route "
                  "taken): " + json.dumps(times))
    return first


def profile_pipeline(device, *, n_frames: int, src_hw) -> None:
    """Where one fused run's time goes: the synthetic camera's cost per
    frame on the host, and the device's busy share of the run's wall time
    (kernel time summed by torch.profiler)."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.data.video import VideoStream
    from repro_torch.preprocess import host
    video = VideoStream(height=src_hw[0], width=src_hw[1], seed=1)
    t0 = time.perf_counter()
    for _ in range(4):
        host.rgb_to_yuv(np.asarray(video.next_frame().pixels))
    camera_ms = (time.perf_counter() - t0) / 4 * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _res, secs, _, _ = run_pipeline(device, True, n_frames=n_frames,
                                        src_hw=src_hw)
    kernels = device_times(prof)
    busy_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)
    print(f"profile fused pipeline: camera frame + encode {camera_ms:.1f} ms "
          f"on the host; wall {secs:.3f} s; device busy "
          f"{busy_us / 1e3:.3f} ms = {busy_us / 1e6 / secs:.5f} of the wall")
    for e in top[:8]:
        print(f"profile device time {e.self_device_time_total / 1e3:.3f} ms "
              f"x{e.count}: {e.key[:90]}")
    matmul = [e for e in kernels if "matmul" in e.key]
    for e in matmul:
        print(f"profile matmul kernel {e.self_device_time_total / 1e3:.3f} ms "
              f"x{e.count}: {e.key[:90]}")
    require(matmul and not any("matmul_reduce_kernel" in e.key
                               for e in matmul),
            "the frame path's matmul launched a second (reduce) pass")


# --------------------------------------------------------------------------
# Phase 8: the serving cluster with real-service replicas on the card
# --------------------------------------------------------------------------

def cluster_spec(device, placement: str, **kw):
    """The default deployment with real service on ``device``, priced by
    the closed form at the wire payload (see CLUSTER_S)."""
    from repro_torch.cluster import ClusterSpec
    from repro_torch.core.facerec import CROP_SIZE
    from repro_torch.core.simulator import FaceRecWorkload
    return ClusterSpec(wl=FaceRecWorkload(face_bytes=float(CROP_SIZE**2 * 3)),
                       service="real", device=str(device),
                       placement=placement, **kw)


def run_cluster(spec):
    """One real-service run: the stack built and warmed first, then the
    matmul and YUV counts set to 0 just before ``run()`` and read just
    after. Returns (result, launches, launches by route)."""
    from repro_torch.cluster import ServingCluster
    from repro_torch.kernels import build
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import preproc
    cl = ServingCluster(spec)
    cl.warm()
    wrappers = {"matmul": mm.matmul, "yuv_to_rgb": preproc.yuv_to_rgb}
    for w in wrappers.values():
        build.zero_launches(w)
    res = cl.run()
    return (res, {n: w.launches for n, w in wrappers.items()},
            {n: dict(w.launches_by_route) for n, w in wrappers.items()})


def report_cluster_run(label: str, spec, res) -> dict:
    """Print a run's tail, five-way split, batch histogram and service
    spans; returns its ``ai_tax()``."""
    from repro_torch.core import facerec
    tax = res.ai_tax()
    fr = tax["fractions"]
    hist = dict(sorted(collections.Counter(
        n for n, _ in res.batch_spans).items()))
    spans = [s for _, s in res.batch_spans]
    mean_ms = statistics.fmean(spans) * 1e3 if spans else float("nan")
    by_bucket = {}
    for n, sec in res.batch_spans:
        by_bucket.setdefault(facerec._pad_pow2(n), []).append(sec * 1e3)
    print(f"cluster {label}: S={spec.speedup:.4f} compression "
          f"{spec.time_compression} produced={res.produced} "
          f"completed={res.completed} diverged={res.diverged} "
          f"(in-flight growth {res.inflight_growth:.1f}, producer lag "
          f"{res.producer_lag_mean:.6f} model s against 5 x period "
          f"{5 * spec.period_s:.6f}); p50/p95/p99 "
          f"{res.latency.p50:.6f}/{res.latency.p95:.6f}/"
          f"{res.latency.p99:.6f} model s; ai_fraction "
          f"{tax['ai_fraction']:.6f}; five-way "
          + json.dumps({k: round(v, 6) for k, v in fr.items()}))
    print(f"cluster {label}: utilization "
          + json.dumps({k: round(v, 6) for k, v in res.utilization.items()})
          + " predicted rho " + json.dumps(
              {k: round(v, 6) for k, v in res.predicted_rho.items()}))
    print(f"cluster {label}: {len(spans)} identify batches, decode + "
          f"identify {mean_ms:.6f} ms wall a batch on average; batch sizes "
          + json.dumps(hist) + "; mean ms by padded bucket "
          + json.dumps({b: round(statistics.fmean(v), 6)
                        for b, v in sorted(by_bucket.items())}))
    return tax


def check_cluster_launches(label: str, placement: str, res, launches,
                           routes) -> None:
    """Over the timed run every identify batch launched the matmul kernel
    twice, on the route of its padded row count, and under the device
    placement the YUV kernel once (vec16: 48 x 48 crops)."""
    from repro_torch.core import facerec
    from repro_torch.kernels import matmul as mm
    n = len(res.batch_spans)
    sizes = collections.Counter(e.meta["batch_size"] for e in res.log.events
                                if e.stage == "identify")
    from_log = round(sum(c / b for b, c in sizes.items()))
    require(n == from_log and n > 0,
            f"cluster {label}: {n} batch spans, {from_log} in the event log")
    want_mm = dict.fromkeys(mm.matmul.launches_by_route, 0)
    for b, _ in res.batch_spans:
        want_mm[mm._route(facerec._pad_pow2(b))] += 2
    want_yuv = n if placement == "device" else 0
    print(f"cluster {label}: launches {launches}; matmul by route "
          f"{routes['matmul']} (want {want_mm}); yuv_to_rgb by route "
          f"{routes['yuv_to_rgb']} (want {want_yuv} vec16)")
    require(launches["matmul"] == 2 * n and routes["matmul"] == want_mm,
            f"cluster {label}: matmul {routes['matmul']}, want {want_mm}")
    require(launches["yuv_to_rgb"] == want_yuv
            and routes["yuv_to_rgb"]["vec16"] == want_yuv,
            f"cluster {label}: yuv_to_rgb {routes['yuv_to_rgb']}, want "
            f"{want_yuv} on vec16")


def check_cluster_identities(device) -> None:
    """One seeded batch of wire-format crops through the card's replica
    path and through a CPU stack carrying the card stack's weights: names
    equal, scores within CLUSTER_SCORE_ATOL."""
    import numpy as np
    from repro_torch.cluster import ServingCluster
    from repro_torch.core import facerec
    from repro_torch.preprocess import host
    spec = cluster_spec(device, "device")
    card = ServingCluster(spec)
    card.warm()
    emb = card._stack.embedder
    params = {"w1": emb.w1.cpu(), "w2": emb.w2.cpu()}
    cpu = facerec.build_identify_stack(seed=spec.seed, fast_path=True,
                                       placement="device", params=params,
                                       device="cpu")
    rng = card._crop_rng(0)
    for n in (5, 13, 64):
        yuv = np.stack([host.rgb_to_yuv(rng.integers(0, 256, (48, 48, 3),
                                                     dtype=np.uint8))
                        for _ in range(n)])
        got, _ = card._identify_real(yuv, None)
        want = cpu.fused.identify_crops(cpu.preprocess.decode(
            facerec._pad_rows_pow2(yuv))[:n])
        err = max(abs(a[1] - b[1]) for a, b in zip(got, want))
        same = [a[0] for a in got] == [b[0] for b in want]
        print(f"cluster identities card vs cpu, batch {n}: names equal "
              f"{same}; max score error {err:.3e}")
        require(same and err <= CLUSTER_SCORE_ATOL,
                f"cluster identities batch {n}: names equal {same}, score "
                f"error {err}")


def time_replica_batches(device) -> None:
    """A replica's decode + identify of one batch with no other thread
    running, under each placement: the service span without the cluster's
    contention, to set beside the runs' mean span a batch."""
    import numpy as np
    from repro_torch.cluster import ServingCluster
    from repro_torch.preprocess import host
    for placement in CLUSTER_PLACEMENTS:
        cl = ServingCluster(cluster_spec(device, placement))
        cl.warm()
        rng = cl._crop_rng(1)
        row = {}
        for n in (1, 13, 64):
            yuv = np.stack([host.rgb_to_yuv(rng.integers(
                0, 256, (48, 48, 3), dtype=np.uint8)) for _ in range(n)])
            times = []
            for _ in range(21):
                t0 = time.perf_counter()
                cl._identify_real(yuv, None)
                times.append((time.perf_counter() - t0) * 1e3)
            row[n] = statistics.median(times)
        print(f"cluster replica alone, placement {placement}: decode + "
              "identify ms a batch (median of 21) by batch size "
              + json.dumps({n: round(v, 6) for n, v in row.items()}))


def host_state() -> str:
    """The host as phase 8 finds it: this process's threads, the load
    average, the CPU seconds the process takes in one idle second (its
    threads' own work), Python's tracked objects and the card memory the
    allocator holds."""
    import gc
    import os
    import torch
    threads = next((line.split()[1] for line in
                    Path("/proc/self/status").read_text().splitlines()
                    if line.startswith("Threads:")), "?")
    cpu0 = sum(os.times()[:2])
    time.sleep(1.0)
    idle_cpu = sum(os.times()[:2]) - cpu0
    return (f"threads {threads}, load average {os.getloadavg()[0]:.2f}, "
            f"{idle_cpu:.3f} CPU s in 1 idle s, {len(gc.get_objects())} "
            f"Python objects, {torch.cuda.memory_reserved() / 1e9:.2f} GB "
            "reserved on the card")


def run_cluster_phase(device) -> None:
    """Phase 8 (see CLUSTER_S): the S = 4 runs under each placement, the
    card against the CPU on the same crops, the bracket and the knees."""
    from dataclasses import replace
    from repro_torch.cluster import ClusterSpec
    from repro_torch.cluster.crossval import LIVE_TOL, des_knee, live_knee
    print(f"cluster: host at the start: {host_state()}")
    modelled = ClusterSpec(speedup=CLUSTER_S)
    print("cluster: the default deployment with real service; priced at "
          "the workload's 37,300-byte face the closed form would predict "
          f"broker rho {modelled.predicted_rho()['broker_storage_write']:.6f}"
          f" at S = {CLUSTER_S} and a knee of "
          f"{modelled.closed_form_knee():.6f}, but the messages carry the "
          "6,912-byte crop: the gates use the closed form at that payload")
    mm_routes = collections.Counter()
    for placement in CLUSTER_PLACEMENTS:
        spec = cluster_spec(device, placement, speedup=CLUSTER_S)
        res, launches, routes = run_cluster(spec)
        mm_routes.update(routes["matmul"])
        label = f"placement {placement}"
        ai = report_cluster_run(label, spec, res)["ai_fraction"]
        rho = res.predicted_rho["broker_storage_write"]
        util = res.utilization["broker_storage_write"]
        require(res.completed > 0.8 * res.produced,
                f"cluster {label}: {res.completed} of {res.produced}")
        require(not res.diverged, f"cluster {label}: diverged")
        require(0.0 < ai < 1.0, f"cluster {label}: ai_fraction {ai}")
        require(abs(util - rho) < 0.25 * rho + 0.05,
                f"cluster {label}: broker storage write {util} against "
                f"predicted rho {rho}")
        check_cluster_launches(label, placement, res, launches, routes)
    CLUSTER_LAUNCHES.parent.mkdir(parents=True, exist_ok=True)
    CLUSTER_LAUNCHES.write_text(json.dumps({"matmul": dict(mm_routes)}))
    check_cluster_identities(device)
    time_replica_batches(device)

    spec = cluster_spec(device, "device",
                        time_compression=CLUSTER_KNEE_COMPRESSION)
    knee = spec.closed_form_knee()
    print(f"cluster: host before the bracket: {host_state()}")
    runs = {}
    for f in CLUSTER_BRACKET:
        s = replace(spec, speedup=f * knee)
        res, _, _ = run_cluster(s)
        report_cluster_run(f"bracket {f} x knee", s, res)
        runs[f] = res
    lo, hi = (runs[f] for f in CLUSTER_BRACKET)
    print(f"cluster bracket around the closed-form knee {knee:.6f}: "
          f"{CLUSTER_BRACKET[0]}x diverged={lo.diverged}, "
          f"{CLUSTER_BRACKET[1]}x diverged={hi.diverged}; p99 "
          f"{lo.latency.p99:.6f} vs {hi.latency.p99:.6f} model s")
    require(not lo.diverged, "cluster: diverged below the knee")
    require(hi.diverged, "cluster: stable above the knee")
    require(hi.latency.p99 > 2 * lo.latency.p99,
            "cluster: the saturated p99 is not above 2x the stable one")
    require(hi.utilization["broker_storage_write"] > 0.8,
            "cluster: above the knee the broker's storage is not saturated: "
            f"{hi.utilization['broker_storage_write']}")
    t_live = time.perf_counter()
    live = live_knee(spec, iters=3)
    t_des = time.perf_counter()
    des = des_knee(spec, iters=4)
    print(f"cluster knee (real service, placement device): live "
          f"{live:.6f} ({t_des - t_live:.1f} s), des {des:.6f} "
          f"({time.perf_counter() - t_des:.1f} s), closed form {knee:.6f}; "
          f"live within LIVE_TOL "
          f"{LIVE_TOL}: {abs(live - knee) / knee <= LIVE_TOL} "
          "(printed, not gated)")


def run_cluster_process() -> dict:
    """Phase 8 in a fresh process (``CLUSTER_ONLY``), its output on this
    one's: the threads, Python objects and card memory the serve phases
    leave behind are not the deployment's. Returns its S = 4 runs'
    launches by route ({"matmul": {route: launches}})."""
    sys.stdout.flush()
    CLUSTER_LAUNCHES.unlink(missing_ok=True)
    rc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                         CLUSTER_ONLY], timeout=CLUSTER_TIMEOUT_S).returncode
    require(rc == 0, f"cluster phase: its process exited {rc}")
    return json.loads(CLUSTER_LAUNCHES.read_text())


# --------------------------------------------------------------------------
# Phase 9: the paper's tax split of one accelerated step
# --------------------------------------------------------------------------

def run_taxed_identify(device, n_steps: int = TAXED_STEPS) -> dict:
    """The fused identify of TAXED_CROPS crops wrapped in a ``TaxedStep``
    on ``device``: pre = stacking and padding the crops on the host, h2d =
    the uint8 stack's upload, compute = ``FusedIdentifier.score`` (the two
    matmul launches), d2h = the (index, score) rows, post = names from
    indices. One warm-up step outside the log, then ``n_steps`` logged
    ones. Gates: h2d bytes = the stacks' bytes, d2h bytes = the fetched
    outputs' bytes, two matmul launches inside each compute (none on the
    CPU, whose plain version counts none), (name, score) rows equal
    ``identify_crops``'s. Returns the step's ``breakdown()``."""
    import numpy as np
    import torch
    from repro_torch.core import facerec
    from repro_torch.core.events import EventLog
    from repro_torch.core.taxmeter import TaxedStep
    from repro_torch.kernels import matmul as mm
    fused = facerec.build_identify_stack(seed=0, fast_path=True,
                                         placement="device",
                                         device=device).fused
    rng = np.random.default_rng(4)
    crops = [rng.integers(0, 256, (facerec.CROP_SIZE, facerec.CROP_SIZE, 3),
                          dtype=np.uint8) for _ in range(TAXED_CROPS)]
    want = fused.identify_crops(np.stack(crops))
    per_compute, fetched = [], []

    def pre(cs):
        return np.ascontiguousarray(facerec._pad_rows_pow2(np.stack(cs)))

    def compute(x):
        before = mm.matmul.launches
        out = fused.score(x)
        per_compute.append(mm.matmul.launches - before)
        return out

    def post(y):
        fetched.append(sum(t.element_size() * t.numel() for t in y))
        return fused.named(y[0].numpy()[:len(crops)],
                           y[1].numpy()[:len(crops)])

    TaxedStep(EventLog(), "identify_fused", device=device).run(
        0, pre=pre, compute=compute, post=post, payload=crops)
    per_compute.clear()
    fetched.clear()
    step = TaxedStep(EventLog(), "identify_fused", device=device)
    names = [step.run(i, pre=pre, compute=compute, post=post, payload=crops)
             for i in range(n_steps)]
    bd = step.breakdown()
    stack_bytes = pre(crops).nbytes
    means = {st.split("/")[1]: statistics.fmean(
        ev.duration for ev in step.log.events if ev.stage == st) * 1e3
        for st in bd["per_stage"]}
    launches = 2 if torch.device(device).type == "cuda" else 0
    print(f"taxed identify_fused ({len(crops)} crops of "
          f"{facerec.CROP_SIZE}x{facerec.CROP_SIZE}x3 u8, {n_steps} steps on "
          f"{device}): mean ms " + json.dumps(
              {k: round(v, 6) for k, v in means.items()})
          + "; five-way " + json.dumps(
              {k: round(v, 6) for k, v in bd["fractions"].items()})
          + f"; ai_fraction {bd['ai_fraction']:.6f}, transfer_fraction "
          f"{bd['transfer_fraction']:.6f}; transfer bytes "
          + json.dumps(bd["transfer_bytes"]) + f"; matmul launches a "
          f"compute {sorted(set(per_compute))} (want {launches})")
    require(bd["transfer_bytes"]["h2d"] == n_steps * stack_bytes,
            f"taxed identify: h2d {bd['transfer_bytes']['h2d']} bytes, want "
            f"{n_steps} x {stack_bytes}")
    require(bd["transfer_bytes"]["d2h"] == sum(fetched)
            and len(fetched) == n_steps,
            f"taxed identify: d2h {bd['transfer_bytes']['d2h']} bytes, "
            f"fetched {sum(fetched)}")
    require(per_compute == [launches] * n_steps,
            f"taxed identify: matmul launches a compute {per_compute}, want "
            f"{launches}")
    # both sides run the same score() on the same device: the (name,
    # score) rows are bit-equal
    same = all(n == want for n in names)
    print(f"taxed identify: (name, score) rows equal identify_crops's: "
          f"{same}")
    require(same, "taxed identify: (name, score) rows differ from "
            "identify_crops's")
    require(abs(sum(bd["fractions"].values()) - 1.0) < 1e-9,
            "taxed identify: the five-way split does not sum to 1")
    return bd


# --------------------------------------------------------------------------
# Phase 10: whisper-large-v3, encoder-decoder, in lock step
# --------------------------------------------------------------------------

def whisper_inputs(model):
    """8 x 1,500 stub frames drawn on the card from seed 0 (in the compute
    dtype) and 8 prompts of WHISPER_PROMPT tokens from numpy seed 0."""
    import numpy as np
    import torch
    cfg = model.cfg
    g = torch.Generator(device=model.device).manual_seed(0)
    frames = torch.randn((WHISPER_B, cfg.cross_seq, cfg.d_model), generator=g,
                         device=model.device).to(model.dtype)
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (WHISPER_B, WHISPER_PROMPT)).astype(np.int32)
    return frames, torch.from_numpy(tokens).to(model.device)


def whisper_decode_floor_bytes(model, params, mean_len: float) -> float:
    """Bytes one lock-step decode step must read: the decoder's weights
    (every layer's but its cross-attention k/v projections, which prefill
    spent) and the head, the self-attention cache at the mean length read
    and the whole cross-attention cache."""
    cfg = model.cfg
    dec = sum(t.nbytes for lp in params["dec"]
              for path, t in _named_leaves(lp)
              if path not in ("/xattn/wk", "/xattn/wv"))
    head = params["embed"]["head"]
    per_entry = 2 * cfg.n_layers * WHISPER_B * cfg.n_heads * cfg.head_dim \
        * head.element_size()                      # k and v, every layer
    return (dec + head.nbytes + per_entry * mean_len
            + per_entry * cfg.cross_seq)


def run_whisper(device, kernels) -> dict:
    """whisper-large-v3 at full width in bf16 on the card (random weights
    from seed 0 drawn there): every attention call of one prefill and one
    decode step held against the plain versions on its own inputs, the
    logits against the plain-ops step in bf16 and with float32 weights,
    then the timed lock-step run (encode, prefill, WHISPER_STEPS greedy
    steps) with the launch counts set to 0 just before it and read just
    after, and its profile. Returns {kernel name: launches}."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.models import encdec as ed
    from repro_torch.models.layers import map_tree
    from repro_torch.models.model import Model
    from torch.profiler import ProfilerActivity, profile
    cfg = get_config(WHISPER)
    model = Model(cfg, device=device)
    t0 = time.perf_counter()
    params = model.init(seed=0)
    torch.cuda.synchronize()
    print(f"{WHISPER}: {model.n_params():,} parameters ({cfg.n_enc_layers} "
          f"encoder + {cfg.n_layers} decoder layers, d {cfg.d_model}, "
          f"{cfg.n_heads} heads, vocab {cfg.vocab_size}, {cfg.dtype}, "
          f"{model.weight_bytes() / 1e9:.3f} GB) drawn on the card in "
          f"{time.perf_counter() - t0:.1f} s")
    frames, tokens = whisper_inputs(model)

    # every attention call of a prefill and a decode step on its own inputs
    batch = {"frames": frames, "tokens": tokens}
    errs = {}
    _step_logits(model, params, batch, lambda: checked_attention_ops(errs),
                 cache_len=WHISPER_CACHE)
    for op, (n, rel, diff) in errs.items():
        print(f"check {WHISPER} {op} ({cfg.dtype}) on each call's own inputs vs "
              f"plain: {n} calls, largest difference {diff:.3e} = {rel:.3e} "
              "of the largest plain output")
    L = cfg.n_layers
    want = {"attention": cfg.n_enc_layers + 2 * L + L,   # + decode's cross
            "decode_attention": L}
    for op, n in want.items():
        require(errs.get(op, (0,))[0] == n,
                f"{WHISPER} {op}: {errs.get(op, (0,))[0]} calls checked, "
                f"want {n}")
    label = (f"{WHISPER_B} x {WHISPER_PROMPT}-token prompts on "
             f"{cfg.cross_seq} frames")
    check_full_width_step(model, params, LOGITS_RTOL, batch, WHISPER_CACHE,
                          label)
    wide = Model(cfg.replace(dtype="float32"), device=device)
    check_full_width_step(wide, map_tree(lambda t: t.float(), params),
                          LOGITS_RTOL_F32, {**batch, "frames": frames.float()},
                          WHISPER_CACHE, label)
    del wide
    torch.cuda.empty_cache()

    def lock_step():
        with torch.inference_mode():
            lp, cache = model.prefill(params, {"frames": frames,
                                               "tokens": tokens},
                                      cache_len=WHISPER_CACHE)
            torch.cuda.synchronize()
            t_pre = time.perf_counter()
            out = [torch.argmax(lp, dim=-1).to(torch.int32)]
            for _ in range(WHISPER_STEPS):
                ld, cache = model.decode_step(params, cache, out[-1][:, None])
                out.append(torch.argmax(ld, dim=-1).to(torch.int32))
            torch.cuda.synchronize()
            return torch.stack(out, 1), cache, ld, t_pre

    # warm-up outside the counts, and the encoder alone
    lock_step()
    with torch.inference_mode():
        ed.encode(cfg, params, frames)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ed.encode(cfg, params, frames)
        torch.cuda.synchronize()
        enc_s = time.perf_counter() - t0
    wrappers = [k["wrapper"] for k in kernels
                if k["name"] in ("flash_attention", "decode_attention")]
    torch.cuda.reset_peak_memory_stats(device)
    for w in wrappers:
        build.zero_launches(w)
    t0 = time.perf_counter()
    out, cache, last, t_pre = lock_step()
    t1 = time.perf_counter()
    launches = {w.__name__: w.launches for w in wrappers}
    routes = {w.__name__: dict(w.launches_by_route) for w in wrappers}
    peak = torch.cuda.max_memory_allocated(device)
    pre_s, dec_s = t_pre - t0, t1 - t_pre
    mean_len = WHISPER_PROMPT + (WHISPER_STEPS + 1) / 2
    floor = whisper_decode_floor_bytes(model, params, mean_len)
    n_tok = WHISPER_B * WHISPER_STEPS
    print(f"{WHISPER} lock step: encode {enc_s * 1e3:.3f} ms ({WHISPER_B} x "
          f"{cfg.cross_seq} frames); prefill {pre_s * 1e3:.3f} ms (encode + "
          f"{WHISPER_B} x {WHISPER_PROMPT}-token decoder prefill); decode "
          f"{WHISPER_STEPS} steps in {dec_s:.4f} s = {n_tok / dec_s:.1f} "
          f"tokens/s, {dec_s / WHISPER_STEPS * 1e3:.3f} ms a step against a "
          f"floor of {floor / PEAK_BYTES_S * 1e3:.3f} ms ({floor / 1e9:.3f} GB:"
          f" decoder weights, the self cache at its mean length "
          f"{mean_len:.1f} and the cross cache, over {PEAK_BYTES_S / 1e12:.2f}"
          f" TB/s); peak memory {peak / 1e9:.2f} GB")
    require(bool(torch.isfinite(last).all()), f"{WHISPER}: logits not finite")
    require(out.shape == (WHISPER_B, WHISPER_STEPS + 1)
            and bool(((out >= 0) & (out < cfg.vocab_size)).all()),
            f"{WHISPER}: tokens out of the vocabulary")
    require(cache["cur_len"] == WHISPER_PROMPT + WHISPER_STEPS,
            f"{WHISPER}: cache at {cache['cur_len']}")
    # flash: the encoder, the decoder's causal prefill and cross attention
    # once a layer, then every step's cross attention (Sq = 1); decode: one
    # launch a decoder layer a step; all on the tensor-core routes
    want = {"flash_attention": {"wgmma": cfg.n_enc_layers + 2 * L
                                + L * WHISPER_STEPS, "simt": 0},
            "decode_attention": {"mma": L * WHISPER_STEPS, "simt": 0}}
    for name, got in routes.items():
        print(f"{WHISPER} launches {name} by route: {got}; want "
              f"{want[name]}: {got == want[name]}")
        require(got == want[name], f"{WHISPER} {name}: {got}, want "
                f"{want[name]}")
    # where the time goes: device busy share of a profiled lock-step run
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        lock_step()
        wall = time.perf_counter() - t0
    kerns = device_times(prof)
    busy_us = sum(e.self_device_time_total for e in kerns)
    print(f"profile {WHISPER} lock step (prefill + {WHISPER_STEPS} steps): "
          f"wall {wall:.3f} s; device busy {busy_us / 1e3:.3f} ms = "
          f"{busy_us / 1e6 / wall:.5f} of the wall")
    for e in sorted(kerns, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"profile {WHISPER} device time {e.self_device_time_total / 1e3:.3f}"
              f" ms x{e.count}: {e.key[:90]}")
    return launches


# --------------------------------------------------------------------------
# Phase 11: training llama3-8b at full width
# --------------------------------------------------------------------------

def train_hp(cfg):
    """AdamW as launch/train.py sets it for TRAIN_STEPS steps, at
    ``cfg``'s TRAIN_LR (launch/train.py's ``--lr``), else its default."""
    from repro_torch.train.optimizer import AdamWConfig
    return AdamWConfig(lr=TRAIN_LR.get(cfg.name, TRAIN_LR_DEFAULT),
                       warmup_steps=max(TRAIN_STEPS // 10, 1),
                       total_steps=TRAIN_STEPS)


def train_loader(cfg, device):
    """``cfg``'s train batches: a TokenLoader of TRAIN_B x TRAIN_S tokens,
    or for an encoder-decoder a :class:`FramesLoader`."""
    from repro_torch.data.tokens import TokenLoader
    if cfg.encdec:
        return FramesLoader(cfg, device)
    return TokenLoader(cfg.vocab_size, batch=TRAIN_B, seq_len=TRAIN_S,
                       device=device)


def train_lengths(cfg) -> tuple[int, int]:
    """(encoder frames, decoder tokens) of a train batch row: the
    reference's ``input_specs`` for a train shape of ``cfg.cross_seq``
    frames, max(S // dec_ratio, 8) tokens (whisper-large-v3: 1,500 and
    187); (0, TRAIN_S) for a decoder-only arch."""
    if not cfg.encdec:
        return 0, TRAIN_S
    return cfg.cross_seq, max(cfg.cross_seq // cfg.dec_ratio, 8)


class FramesLoader:
    """An encoder-decoder's train batches: {"frames" (TRAIN_B, S_enc,
    d_model) stub embeddings in the compute dtype, drawn once on
    ``device`` from a ``torch.Generator`` seeded with ``seed`` and the same
    every step, as phase 10's stub frames are; "tokens", "labels"
    (TRAIN_B, S_dec) from a TokenLoader}, the lengths of
    :func:`train_lengths`. ``seek`` and ``next_batch`` as the
    TokenLoader's."""

    def __init__(self, cfg, device, seed: int = 0):
        import torch
        from repro_torch.data.tokens import TokenLoader
        from repro_torch.models.layers import DTYPES
        S_enc, S_dec = train_lengths(cfg)
        self.tokens = TokenLoader(cfg.vocab_size, batch=TRAIN_B,
                                  seq_len=S_dec, device=device)
        g = torch.Generator(device=self.tokens.device).manual_seed(seed)
        self.frames = torch.randn(
            (TRAIN_B, S_enc, cfg.d_model), generator=g,
            device=self.tokens.device).to(DTYPES[cfg.dtype])

    def seek(self, step: int) -> None:
        self.tokens.seek(step)

    def next_batch(self) -> dict:
        return {**self.tokens.next_batch(), "frames": self.frames}


def train_fits(cfg, free: int) -> bool:
    """Whether 16 bytes a parameter of ``cfg`` (float32 param, grad, m, v)
    fit in ``free`` bytes less TRAIN_MARGIN_BYTES, from the shapes alone."""
    from repro_torch.models.model import Model
    return (16 * Model(cfg, device="cpu").n_params() + TRAIN_MARGIN_BYTES
            <= free)


def train_depth_first_try(cfg, free: int) -> int:
    """The most layers of ``cfg`` (of :func:`train_depths`) that
    :func:`train_fits` ``free`` bytes: where :func:`fit_train_depth`
    starts."""
    depths = train_depths(cfg)
    return next((n for n in depths if train_fits(train_cfg(cfg, n), free)),
                depths[-1])


def with_experts(cfg, n: int):
    """``cfg`` with ``n`` routed experts, every other width as it is."""
    import dataclasses
    return cfg.replace(moe=dataclasses.replace(cfg.moe, n_experts=n))


def train_cuts(cfg, free: int) -> list:
    """The configurations :func:`fit_train_depth` tries, largest first:
    the depths of :func:`train_depths` from the first try down; or, where
    ``cfg`` has routed experts and not one layer with all of them fits
    (:func:`train_fits`), one layer with the most experts that fit, then
    TRAIN_EXPERT_STEP fewer at a time down to top_k."""
    depths = train_depths(cfg)
    one = train_cfg(cfg, depths[-1])
    if cfg.moe is None or train_fits(one, free):
        n = train_depth_first_try(cfg, free)
        return [train_cfg(cfg, d) for d in depths if d <= n]
    top_k = cfg.moe.top_k
    most = next((e for e in range(cfg.moe.n_experts - 1, top_k - 1, -1)
                 if train_fits(with_experts(one, e), free)), top_k)
    return [with_experts(one, e)
            for e in range(most, top_k - 1, -TRAIN_EXPERT_STEP)]


def fit_train_depth(device, cfg):
    """The most layers of ``cfg`` that one card trains at full width,
    measured: from the largest count whose 16 bytes a parameter (float32
    param, grad, m, v) fit in the free memory less TRAIN_MARGIN_BYTES,
    down, draw the float32 masters and run one training step (loss,
    gradients, AdamW) on a TokenLoader batch; a count that runs out of
    memory, or whose step leaves less than TRAIN_PEAK_HEADROOM_BYTES of the
    card unallocated, is freed and the next one tried
    (:func:`train_depths`: whole repeats of the block pattern, or a prefix
    of one). Where not one layer
    fits with all of a MoE arch's routed experts, one layer with fewer,
    fitted the same way (:func:`train_cuts`; every width, top_k, the
    shared experts and the router as the config has them). Returns the
    model."""
    import torch
    from repro_torch.models.model import Model
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.train_step import make_train_step
    free, total = torch.cuda.mem_get_info(device)
    cuts = train_cuts(cfg, free)
    first = cuts[0]
    print(f"depth train {cfg.name}: {cfg.n_layers} layers need "
          f"{16 * Model(cfg, device='cpu').n_params() / 1e9:.2f} GB at 16 "
          f"bytes a parameter; {free / 1e9:.3f} GB free of {total / 1e9:.3f} "
          f"GB; first try {first.n_layers} layers"
          + (f", {first.moe.n_experts} routed experts"
             if first.moe is not None else "")
          + f" ({16 * Model(first, device='cpu').n_params() / 1e9:.2f} GB)")
    batch = train_loader(cfg, device).next_batch()
    for cut in cuts:
        model = Model(cut, device=device)
        n = cut.n_layers
        experts = "" if cut.moe is None else f", {cut.moe.n_experts} experts"
        torch.cuda.reset_peak_memory_stats(device)
        params = opt = None
        try:
            params = model.init(seed=0, masters=True)
            opt = init_opt_state(params)
            make_train_step(model, train_hp(model.cfg))(params, opt, batch)
            torch.cuda.synchronize()
        except torch.cuda.OutOfMemoryError as err:
            print(f"depth train {cfg.name}: {n} layers{experts} ran out of "
                  f"memory ({str(err).splitlines()[0]})")
            params = opt = None
        if params is None:
            # out of the handler, whose traceback held the failed step's
            # tensors: the next try starts from an emptied cache
            torch.cuda.empty_cache()
            continue
        peak = torch.cuda.max_memory_allocated(device)
        del params, opt
        torch.cuda.empty_cache()
        if total - peak < TRAIN_PEAK_HEADROOM_BYTES:
            print(f"depth train {cfg.name}: {n} layers{experts}: one step "
                  f"peaks at {peak / 1e9:.3f} GB, less than "
                  f"TRAIN_PEAK_HEADROOM_BYTES ({TRAIN_PEAK_HEADROOM_BYTES / 1e9:.2f}"
                  f" GB) under the card's {total / 1e9:.3f} GB")
            continue
        print(f"depth train {cfg.name}: {n} layers{experts}, "
              f"{model.n_params():,} parameters ({16 * model.n_params() / 1e9:.2f}"
              f" GB at 16 bytes a parameter); one training step peaks at "
              f"{peak / 1e9:.3f} GB allocated of {total / 1e9:.3f} GB")
        enc = (f", n_enc_layers {cfg.n_enc_layers} → {cut.n_enc_layers}"
               if cfg.encdec else "")
        print(f"reduced: train n_layers {cfg.n_layers} → {n}{enc} (one card "
              f"holds {peak / 1e9:.2f} GB of {total / 1e9:.2f} in a step)")
        if cut.moe is not None and cut.moe.n_experts != cfg.moe.n_experts:
            print(f"reduced: train n_experts {cfg.moe.n_experts} → "
                  f"{cut.moe.n_experts} (one layer with all of them holds "
                  f"{16 * Model(train_cfg(cfg, 1), device='cpu').n_params() / 1e9:.2f}"
                  f" GB at 16 bytes a parameter; top_k {cut.moe.top_k}, "
                  f"d_expert {cut.moe.d_expert}, {cut.moe.n_shared} shared "
                  "experts and every width as the config has them)")
        return model
    raise SmokeFailure(f"{cfg.name}: not one layer trains on the card")


def check_train_step1(model, batch, scan_layers: bool = False,
                      gate_gnorm: bool = True) -> None:
    """Step 1's loss and gradient norm through the kernels against the same
    step with the plain versions (to TRAIN_LOSS_RTOL and, with
    ``gate_gnorm``, TRAIN_GNORM_RTOL relative), and every gradient leaf
    finite and not all zero but a sincos arch's key biases'
    (:func:`check_grad_leaves`).
    With ``scan_layers``, each scan layer's backward kernel is
    also held against the plain formulas on that layer's own inputs and
    incoming gradient, recorded during the kernel step
    (:func:`check_recorded_scan_bwd`)."""
    import torch
    from repro_torch.train.optimizer import global_norm
    from repro_torch.train.train_step import make_train_step
    step = make_train_step(model, train_hp(model.cfg))
    params = model.init(seed=0, masters=True)
    calls = []
    with (recorded_scan_calls(calls) if scan_layers
          else contextlib.nullcontext()):
        loss, grads = step.grads(params, batch)
    gnorm = float(global_norm(grads))
    check_grad_leaves(model.cfg, grads)
    del grads
    if scan_layers:
        check_recorded_scan_bwd(model.cfg.name, calls)
    del calls
    with plain_ops():
        ploss, pgrads = step.grads(params, batch)
    pnorm = float(global_norm(pgrads))
    del pgrads, params
    torch.cuda.empty_cache()
    rel_l = abs(float(loss) - float(ploss)) / abs(float(ploss))
    rel_g = abs(gnorm - pnorm) / pnorm
    print(f"check train {model.cfg.name} step 1 kernels vs plain versions "
          f"({model.cfg.n_layers} layers): loss {float(loss):.6f} vs "
          f"{float(ploss):.6f} (relative {rel_l:.3e}, tolerance "
          f"{TRAIN_LOSS_RTOL}); grad norm {gnorm:.6f} vs {pnorm:.6f} "
          f"(relative {rel_g:.3e}, tolerance {TRAIN_GNORM_RTOL}"
          f"{'' if gate_gnorm else ', held at TRAIN_GNORM_LAYERS'})")
    require(rel_l <= TRAIN_LOSS_RTOL and (not gate_gnorm
                                          or rel_g <= TRAIN_GNORM_RTOL),
            "train step 1: kernels and plain versions differ")


def check_grad_leaves(cfg, grads) -> None:
    """Every leaf of ``cfg``'s gradient tree finite and not all zero (a cut
    graph leaves a leaf without a gradient), but, where ``cfg.pos`` is not
    ``"rope"`` (whisper's sincos), the key biases' (leaves named ``*/bk``).
    There a key bias reaches the scores unrotated: it adds q . bk, one
    constant, to each row's scores, which leaves the row's softmax as it
    is, so its gradient is zero in exact arithmetic, rounding noise through
    the kernels; each is held instead to at most BWD_RTOL["bfloat16"] of
    the largest gradient of the tree, finite. Under RoPE the bias is added
    before the rotation, so each key's bias is turned by that key's
    position, moves the scores unequally and has a real gradient (qwen's):
    it is held as any other leaf."""
    import torch
    named = _named_leaves(grads)
    excused = {n for n, _ in named
               if cfg.pos != "rope" and n.endswith("/bk")}
    bad = [n for n, g in named
           if not bool(torch.isfinite(g).all())
           or not (n in excused or bool((g != 0).any()))]
    print(f"check train {cfg.name}: {len(named)} gradient leaves, "
          f"{len(named) - len(bad)} finite and non-zero" + (
              f" (the {len(excused)} key biases, pos {cfg.pos!r}, finite "
              "only)" if excused else ""))
    require(not bad, f"train: gradient leaves zero or not finite: {bad[:5]}")
    if not excused:
        return
    top = max(float(g.abs().max()) for _, g in named)
    bias = max(float(g.abs().max()) for n, g in named if n in excused)
    tol = BWD_RTOL["bfloat16"]
    print(f"check train {cfg.name}: the key biases' largest gradient "
          f"{bias:.3e} = {bias / top:.3e} of the largest gradient {top:.3e} "
          f"(zero in exact arithmetic with pos {cfg.pos!r}; at most {tol})")
    require(bias <= tol * top, f"train {cfg.name}: a key bias's gradient "
            f"{bias:.3e} above {tol} of the largest gradient {top:.3e}")


def grad_norm_moves(model, batch) -> float:
    """How far step 1's grad norm through the plain versions moves,
    relative, when the token embedding is scaled by 1 + TRAIN_PROBE_EPS:
    whether a comparison of grad norms at TRAIN_GNORM_RTOL can mean
    anything at this depth. The probe runs none of the kernels under test,
    so no kernel fault can choose the depth its own check runs at."""
    import torch
    from repro_torch.train.optimizer import global_norm
    from repro_torch.train.train_step import make_train_step
    step = make_train_step(model, train_hp(model.cfg))
    params = model.init(seed=0, masters=True)
    norms = []
    for scale in (1.0, 1 + TRAIN_PROBE_EPS):
        with torch.no_grad():
            params["embed"]["tok"].mul_(scale)
        with plain_ops():
            _, grads = step.grads(params, batch)
        norms.append(float(global_norm(grads)))
        del grads
    del params
    torch.cuda.empty_cache()
    moved = abs(norms[1] - norms[0]) / norms[0]
    print(f"check train {model.cfg.name} ({model.cfg.n_layers} layers): step "
          f"1's plain grad norm {norms[0]:.6f}, with the embedding scaled by 1 + "
          f"{TRAIN_PROBE_EPS} {norms[1]:.6f}: moves {moved:.3e} "
          f"({'conditioned' if moved <= TRAIN_GNORM_RTOL / 2 else 'not conditioned'}"
          f" at half the tolerance {TRAIN_GNORM_RTOL})")
    return moved


@contextlib.contextmanager
def recorded_scan_calls(calls: list):
    """The models' scan ops, each call under grad also recorded: its
    inputs (copies) and, once the backward reaches it, the gradient of its
    output (a hook). A rematerialised layer's second forward gets no
    gradient and is dropped by :func:`check_recorded_scan_bwd`."""
    from repro_torch.kernels import ops

    def recording(op):
        kernel = getattr(ops, op)

        def scan(*args):
            y, h = kernel(*args)
            if y.requires_grad:
                call = {"op": op, "ins": [None if t is None
                                          else t.detach().clone()
                                          for t in args]}
                y.register_hook(lambda g, c=call: c.__setitem__(
                    "dy", g.detach().clone()))
                calls.append(call)
            return y, h
        return scan
    with swapped_ops({op: recording(op)
                      for op in ("rwkv_scan", "mamba_scan")}):
        yield


def check_recorded_scan_bwd(name: str, calls: list) -> None:
    """Each recorded scan layer of a training step: the backward kernel
    (from the forward kernel's checkpoints) against the plain formulas on
    the layer's own inputs and incoming gradient, each gradient within
    BWD_RTOL of its largest. A whole step's grad norm can be ill
    conditioned; a layer's gradients given its inputs are not."""
    import torch
    from repro_torch.kernels import linear_scan as ls
    done = [c for c in calls if "dy" in c]
    worst = 0.0
    for i, call in enumerate(done):
        ins, dy = call["ins"], call["dy"].contiguous()
        if call["op"] == "rwkv_scan":
            r, w, k, v, u, h0 = ins
            uf = u.float().contiguous()
            route = ls._route(r.dtype, r.shape[-1], v.shape[-1], r.shape[1])
            state = torch.empty((r.shape[0], r.shape[2], r.shape[3],
                                 v.shape[3]), device=r.device)
            _, ckpt = ls._launch(route, r, w, k, v, uf, h0, state, True)
            got = ls.rwkv_scan_bwd(r, w, k, v, uf, h0, dy, ckpt=ckpt)
            want = ls.rwkv_scan_bwd_plain(r, w, k, v, uf, h0, dy)
        else:
            delta, A, Bt, Ct, x, h0 = ins
            Af = A.float().contiguous()
            B, S, Di = delta.shape
            route = ls._mamba_route(x.dtype, Af.shape[1], S)
            state = torch.empty((B, Di, Af.shape[1]), device=x.device)
            ckpt = torch.empty((B, -(-S // ls.CHUNK), Di, Af.shape[1]),
                               device=x.device)
            ls._launch_mamba(route, delta, x, Af, Bt, Ct, h0, state, ckpt)
            got = ls.mamba_scan_bwd(delta, Af, Bt, Ct, x, h0, dy, ckpt=ckpt)
            want = ls.mamba_scan_bwd_plain(delta, Af, Bt, Ct, x, h0, dy)
        tol = BWD_RTOL[str(dy.dtype).split(".")[1]]
        for a, b in zip(got, want):
            if a is None:
                continue
            top = b.float().abs().max().item()
            e = (a.float() - b.float()).abs().max().item() / max(top, 1e-30)
            worst = max(worst, e)
            require(bool(torch.isfinite(a.float()).all()) and e <= tol,
                    f"train {name}: {call['op']} layer {i}'s backward "
                    f"kernel {e:.3e} of the largest gradient from the plain "
                    f"formulas (tolerance {tol})")
        del ckpt, got, want
    print(f"check train {name}: {len(done)} scan layers' backward kernels "
          f"on their own inputs and incoming gradients against the plain "
          f"formulas: largest error {worst:.3e} of the largest gradient "
          f"(tolerance {BWD_RTOL['bfloat16']} bf16)")
    require(done, f"train {name}: no scan layer recorded")


def _named_leaves(tree, path=""):
    if isinstance(tree, dict):
        return [x for k, v in tree.items()
                for x in _named_leaves(v, f"{path}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in _named_leaves(v, f"{path}/{i}")]
    return [(path, tree)]


def fingerprint(tree) -> list:
    """Per leaf of a (params, opt) state: its bits as int32 words summed,
    and weighted by position mod 65521, in int64 on the device (chunked):
    equal fingerprints are what a bit-exact restore gives."""
    import torch
    out = []
    for name, t in _named_leaves(tree):
        if not isinstance(t, torch.Tensor):
            out.append((name, t))
            continue
        words = t.detach().reshape(-1).view(torch.int32)
        s0 = s1 = 0
        for i in range(0, words.numel(), 1 << 26):
            w = words[i:i + (1 << 26)].to(torch.int64)
            pos = torch.arange(i, i + w.numel(), device=w.device) % 65521 + 1
            s0 += int(w.sum())
            s1 += int((w * pos).sum())
        out.append((name, s0, s1))
    return out


def run_train(device, kernels) -> dict:
    """Phase 11: each of TRAIN_ARCHS trained on the card at full width
    (:func:`train_arch`), after the checks that what has no backward still
    refuses; then llama3-8b's checkpoint cycle at TRAIN_CKPT_LAYERS
    (:func:`check_train_restart`). Returns llama3-8b's run ({"launches",
    "routes", "step_ms", "n_layers"}) with every arch's launches under
    ``"launches_by_arch"`` and by route under ``"routes_by_arch"``."""
    from repro_torch.configs import get_config
    check_train_refusals(device)
    runs = {}
    for arch in TRAIN_ARCHS:
        with phase(f"train {arch}"):
            runs[arch] = train_arch(device, kernels, arch)
    with phase("train checkpoint cycle"):
        check_train_restart(device, get_config(TRAIN_ARCH).replace(
            n_layers=TRAIN_CKPT_LAYERS))
    return {**runs[TRAIN_ARCH],
            "launches_by_arch": {a: r["launches"] for a, r in runs.items()},
            "routes_by_arch": {a: r["routes"] for a, r in runs.items()}}


def check_train_refusals(device) -> None:
    """What has no backward kernel refuses a call autograd would have to
    differentiate: the scans' decode steps (RuntimeError) and the flash
    backward in float32 at D = 256, at a bf16 (D, Dv) above 128 that the
    split route does not take (192 | 192) and at a bf16 width above the
    split route's (ValueError, from the backward's or the forward's shape
    check)."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import linear_scan as ls
    g = torch.Generator(device=device).manual_seed(0)

    def raised(fn, kind) -> str:
        try:
            fn()
        except kind as err:
            return str(err)
        return ""

    B, H, K, Di, N = 2, RWKV_H, RWKV_K, MAMBA_DI, MAMBA_N
    r = torch.randn((B, H, K), device=device, generator=g,
                    requires_grad=True)
    w = torch.rand((B, H, K), device=device, generator=g)
    u = torch.randn((H, K), device=device, generator=g)
    hr = torch.zeros((B, H, K, K), device=device)
    delta = torch.rand((B, Di), device=device, generator=g,
                       requires_grad=True)
    A = -torch.rand((Di, N), device=device, generator=g)
    bc = torch.randn((B, N), device=device, generator=g)
    hm = torch.zeros((B, Di, N), device=device)
    def flash_grad(dtype, D, Dv):
        q = torch.randn((1, 64, 2, D), device=device, generator=g,
                        dtype=dtype, requires_grad=True)
        k = torch.randn((1, 64, 1, D), device=device, generator=g, dtype=dtype)
        v = torch.randn((1, 64, 1, Dv), device=device, generator=g,
                        dtype=dtype)
        return lambda: fa.flash_attention(q, k, v).float().sum().backward()

    for name, fn, kind, want in (
            ("rwkv_decode_step",
             lambda: ls.rwkv_decode_step(r, w, r.detach(), r.detach(), u,
                                         hr), RuntimeError, "no backward"),
            ("mamba_decode_step",
             lambda: ls.mamba_decode_step(delta, A, bc, bc, delta.detach(),
                                          hm), RuntimeError, "no backward"),
            ("flash_attention backward in float32 at D = 256",
             flash_grad(torch.float32, 256, 256), ValueError, ""),
            ("flash_attention backward in bf16 at D = Dv = 192",
             flash_grad(torch.bfloat16, 192, 192), ValueError, ""),
            ("flash_attention in bf16 at D = Dv = 288",
             flash_grad(torch.bfloat16, 288, 288), ValueError, "")):
        text = raised(fn, kind)
        print(f"check train: {name} on the card under grad raises "
              f"{kind.__name__}: {bool(text)} ({text})")
        require(bool(text) and want in text,
                f"{name} under grad did not raise {kind.__name__}")


def train_cfg(cfg, n: int):
    """``cfg`` cut to its first ``n`` layers: whole repeats of its block
    pattern, or, below one repeat, the pattern's first ``n`` layers (a
    jamba-v0.1-52b layer with a MoE MLP alone holds ~2.8 B parameters); an
    encoder-decoder's decoder and encoder together, ``n`` layers each."""
    n_pat = len(cfg.block_pattern)
    if cfg.encdec:
        return cfg.replace(n_layers=n, n_enc_layers=n)
    if n % n_pat == 0:
        return cfg.replace(n_layers=n)
    if n > n_pat:
        raise ValueError(f"{cfg.name}: {n} layers are not whole repeats of "
                         f"its {n_pat}-layer pattern")
    return cfg.replace(n_layers=n, block_pattern=cfg.block_pattern[:n])


def train_depths(cfg) -> list[int]:
    """The depths :func:`train_cfg` can cut ``cfg`` to, deepest first."""
    n_pat = len(cfg.block_pattern)
    return [n for n in range(cfg.n_layers, 0, -1)
            if n % n_pat == 0 or n < n_pat]


def train_want(cfg) -> dict:
    """{kernel: {route: launches}} a TRAIN_STEPS run of ``cfg`` must count:
    each scan and attention layer's forward twice a step (the layer is
    rematerialised in the backward), on the chunked RWKV6 route, the
    segmented Mamba route and flash's wgmma route at 4 x 1,024 tokens, and
    its backward once a step (the scans' on their chunked routes, none on
    the serial kernels). An encoder-decoder's attention calls are one an
    encoder layer (non-causal self) and two a decoder layer (causal self
    and cross; ``models/encdec.py``), every one of them under
    ``_layers``'s rematerialisation."""
    kinds = [s.kind for s in cfg.block_pattern] * cfg.n_repeats
    n = {kind: kinds.count(kind) * TRAIN_STEPS
         for kind in ("attn", "rwkv", "mamba")}
    if cfg.encdec:
        n["attn"] = (cfg.n_enc_layers + 2 * cfg.n_layers) * TRAIN_STEPS
    want = {}
    if n["attn"]:
        import torch
        from repro_torch.kernels import flash_attention as fa
        bwd = fa._bwd_route(torch.bfloat16, *attn_widths(cfg))
        want["flash_attention"] = {"wgmma": 2 * n["attn"], "simt": 0}
        want["flash_attention_bwd"] = {
            r: n["attn"] if r == bwd else 0
            for r in fa.flash_attention_bwd.launches_by_route}
    if n["rwkv"]:
        want["rwkv_scan"] = {"chunk": 2 * n["rwkv"], "serial": 0}
        want["rwkv_scan_bwd"] = {"chunk": n["rwkv"], "serial": 0}
    if n["mamba"]:
        want["mamba_scan"] = {"segmented": 2 * n["mamba"], "step": 0,
                              "serial": 0}
        want["mamba_scan_bwd"] = {"chunk": n["mamba"], "serial": 0}
    return want


def attn_widths(cfg) -> tuple[int, int]:
    """(D, Dv) of ``cfg``'s attention heads: MLA's qk_nope + qk_rope and
    v_head, else head_dim twice."""
    if cfg.mla is not None:
        return cfg.mla.qk_nope + cfg.mla.qk_rope, cfg.mla.v_head
    return cfg.head_dim, cfg.head_dim


def train_flops(model) -> float:
    """Model FLOPs of one step: 6 a token per active parameter of a
    product (the token embedding is a gather, but a tied one is also the
    head's product; of a MoE layer's experts the top k), and causal
    attention's 3 S H (D + Dv) a layer a token (QK^T and PV, forward and
    backward, halved by the mask; 6 S d_model where H D = d_model, as for
    llama3-8b and jamba; a window of at least S masks nothing more, as
    gemma3's 1,024 at TRAIN_S). The scans' own work is left out (~0.3% of
    rwkv6-3b's). An encoder-decoder counts at its own lengths
    (:func:`encdec_train_flops`)."""
    cfg = model.cfg
    if cfg.encdec:
        return encdec_train_flops(model)
    n_mat = model.n_params() - (0 if cfg.tie_embeddings
                                else cfg.vocab_size * cfg.d_model)
    specs = list(cfg.block_pattern) * cfg.n_repeats
    if cfg.moe is not None:
        idle = cfg.moe.n_experts - cfg.moe.top_k
        n_mat -= sum(s.moe for s in specs) * idle * 3 * cfg.d_model \
            * cfg.moe.d_expert
    n_attn = sum(s.kind == "attn" for s in specs)
    D, Dv = attn_widths(cfg)
    tokens = TRAIN_B * TRAIN_S
    return tokens * (6 * n_mat + 3 * n_attn * TRAIN_S * cfg.n_heads * (D + Dv))


def encdec_train_flops(model) -> float:
    """Model FLOPs of one encoder-decoder step at the lengths of
    :func:`train_lengths`: 6 a row per parameter of a product, the
    encoder's (``enc_in``, its layers, ``ln_enc``) on the TRAIN_B x S_enc
    frames, the decoder's (its layers, ``ln_f``, the head; the token
    embedding is a gather unless tied) on the TRAIN_B x S_dec tokens, but
    each decoder layer's cross K and V projections, which run on the S_enc
    encoder states; attention 6 H (D + Dv) a visible (query, key) pair
    (QK^T and PV, forward and backward): the encoder's self attention and
    the cross attention over every pair, the decoder's causal self
    attention over half of S_dec^2, as :func:`train_flops` halves it."""
    from repro_torch.models.layers import tree_leaves
    cfg = model.cfg
    S_enc, S_dec = train_lengths(cfg)
    meta = model.param_meta()

    def count(tree) -> int:
        return sum(math.prod(p.shape) for p in tree_leaves(tree))
    n_enc = count(meta["enc_in"]) + count(meta["enc"]) + count(meta["ln_enc"])
    n_cross = sum(count(lp["xattn"][w]) for lp in meta["dec"]
                  for w in ("wk", "wv"))
    n_dec = model.n_params() - n_enc - n_cross - (
        0 if cfg.tie_embeddings else cfg.vocab_size * cfg.d_model)
    D, Dv = attn_widths(cfg)
    pairs = (cfg.n_enc_layers * S_enc * S_enc
             + cfg.n_layers * (S_dec * S_enc + S_dec * S_dec / 2))
    return TRAIN_B * (6 * ((n_enc + n_cross) * S_enc + n_dec * S_dec)
                      + 6 * cfg.n_heads * (D + Dv) * pairs)


def check_step1_at_fitting_depth(device, model) -> None:
    """:func:`check_train_step1` at the model's depth, or at
    TRAIN_STEP1_LAYERS where that is shallower, or, where the plain
    step (which keeps every step's tensors of each scan) runs out of
    memory, at the next depth down, each cut printed as a ``reduced:``
    line.

    A scan arch's step 1 is checked at that depth for its loss, its leaves
    and each scan layer's backward kernel; its grad norm against the plain
    step's is held there too, or at TRAIN_GNORM_LAYERS where that is
    shallower (printed as ``reduced:``), once the plain step, which runs
    none of the kernels under test, is shown conditioned there
    (:func:`grad_norm_moves`)."""
    import torch
    from repro_torch.models.model import Model
    cfg = model.cfg
    scan = any(s.kind in ("rwkv", "mamba") for s in cfg.block_pattern)
    depths = train_depths(cfg)
    batch = train_loader(cfg, device).next_batch()
    n, m = cfg.n_layers, model
    if TRAIN_STEP1_LAYERS.get(cfg.name, n) < n:
        print(f"reduced: train step-1 check {cfg.name} n_layers {n} → "
              f"{TRAIN_STEP1_LAYERS[cfg.name]} (TRAIN_STEP1_LAYERS: the plain "
              "step's scan loop, PERF.md section 6)")
        n = TRAIN_STEP1_LAYERS[cfg.name]
        m = Model(train_cfg(cfg, n), device=device)
    n_g = min(n, TRAIN_GNORM_LAYERS.get(cfg.name, n))
    while True:
        try:
            check_train_step1(m, batch, scan_layers=scan,
                              gate_gnorm=n_g == n)
            break
        except torch.cuda.OutOfMemoryError as err:
            print(f"check train {cfg.name} step 1 at {n} layers ran out of "
                  f"memory ({str(err).splitlines()[0]})")
        torch.cuda.empty_cache()
        lower = [d for d in depths if d < n]
        if not lower:
            raise SmokeFailure(f"{cfg.name}: the step-1 check fits at no "
                               "depth")
        print(f"reduced: train step-1 check {cfg.name} n_layers {n} → "
              f"{lower[0]} (the plain step at {n} does not fit the card)")
        n = lower[0]
        n_g = min(n, n_g)
        m = Model(train_cfg(cfg, n), device=device)
    if n_g == n:
        return
    print(f"reduced: train step-1 grad-norm check {cfg.name} n_layers {n} → "
          f"{n_g} (TRAIN_GNORM_LAYERS: the plain step's grad norm deeper is "
          "not conditioned, PERF.md section 6)")
    m = Model(train_cfg(cfg, n_g), device=device)
    require(grad_norm_moves(m, batch) <= TRAIN_GNORM_RTOL / 2,
            f"train {cfg.name}: the plain step's grad norm at {n_g} layers is "
            "not conditioned, so a comparison of grad norms means nothing")
    check_train_step1(m, batch)


def train_arch(device, kernels, arch: str) -> dict:
    """``arch`` at full width trained on the card: at the depth
    fit_train_depth measures, step 1 against the plain versions, then
    TRAIN_STEPS steps through a Trainer without checkpoints, every launch
    count set to 0 just before it and read just after (:func:`train_want`),
    the loss required to fall by 0.1; its ms a step, tokens/s, model FLOP/s,
    peak memory and the device's busy share over two profiled steps.
    Returns {"launches": {kernel: n}, "routes": {kernel: {route: n}},
    "step_ms", "n_layers"}."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.train.train_step import make_train_step
    from repro_torch.train.trainer import Trainer, TrainerConfig

    with phase(f"train {arch} fit"):
        model = fit_train_depth(device, get_config(arch))
    cfg = model.cfg
    with phase(f"train {arch} step 1"):
        check_step1_at_fitting_depth(device, model)
    want = train_want(cfg)
    wrappers = {k["name"]: k["wrapper"] for k in kernels
                if k["name"] in want}
    tc = TrainerConfig(steps=TRAIN_STEPS, ckpt_dir=None, log_every=5)
    step = make_train_step(model, train_hp(model.cfg))
    trainer = Trainer(model, step, train_loader(cfg, device), tc)
    torch.cuda.reset_peak_memory_stats(device)
    for wr in wrappers.values():
        build.zero_launches(wr)
    t0 = time.perf_counter()
    params, opt, hist = trainer.run()
    wall = time.perf_counter() - t0
    routes = {name: dict(getattr(wr, "launches_by_route",
                                 {None: wr.launches}))
              for name, wr in wrappers.items()}
    launches = {name: wr.launches for name, wr in wrappers.items()}
    peak = torch.cuda.max_memory_allocated(device)
    count = opt.count
    # where the time goes: the device's busy share of two more steps
    with phase(f"train {arch} profile"):
        batch = train_loader(cfg, device).next_batch()
        step(params, opt, batch)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            for _ in range(2):
                step(params, opt, batch)
            torch.cuda.synchronize()
            prof_wall = time.perf_counter() - t1
        kerns = device_times(prof)
    busy_us = sum(e.self_device_time_total for e in kerns)
    del params, opt, trainer, step
    torch.cuda.empty_cache()

    require([h["step"] for h in hist] == list(range(1, TRAIN_STEPS + 1)),
            f"train {arch}: steps missing from the history")
    require(count == TRAIN_STEPS - sum(h["skipped"] for h in hist),
            f"train {arch}: optimizer count {count}")
    losses = [h["loss"] for h in hist]
    first, last = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    print(f"train {cfg.name} losses: " + json.dumps(
        [round(x, 4) for x in losses]) + "; grad norms: " + json.dumps(
        [round(h["grad_norm"], 3) for h in hist]) + f"; skipped "
        f"{sum(h['skipped'] for h in hist)}; mean of the first 5 "
        f"{first:.4f}, of the last 5 {last:.4f}")
    require(all(math.isfinite(x) for x in losses),
            f"train {arch}: a loss not finite")
    require(last <= first - 0.1,
            f"train {arch}: loss fell {first - last:.4f} < 0.1")
    print(f"train {cfg.name} launches by route: {routes}; want {want}: "
          f"{routes == want}")
    require(routes == want and launches == {
        n: sum(r.values()) for n, r in want.items()},
        f"train {arch} launches {launches} {routes}, want {want}")
    step_s = statistics.median(h["dt"] for h in hist[1:])
    flops = train_flops(model)
    S_enc, S_dec = train_lengths(cfg)
    frames = (f" and {TRAIN_B} x {S_enc} frames, {cfg.n_enc_layers} "
              "encoder layers" if cfg.encdec else "")
    print(f"train {cfg.name} ({cfg.n_layers} layers, {model.n_params():,} "
          f"parameters, {TRAIN_B} x {S_dec} tokens{frames} a step): median "
          f"step {step_s * 1e3:.1f} ms (step 1 left out), "
          f"{TRAIN_B * S_dec / step_s:.0f} tokens/s"
          + (f", {TRAIN_B * S_enc / step_s:.0f} frames/s" if S_enc else "")
          + ", model "
          f"{flops / step_s / 1e12:.1f} TFLOP/s = "
          f"{flops / step_s / PEAK_BF16_FLOP_S:.4f} of "
          f"{PEAK_BF16_FLOP_S / 1e12:.0f}; peak memory {peak / 1e9:.2f} GB; "
          f"{TRAIN_STEPS} steps in {wall:.1f} s; device busy "
          f"{busy_us / 1e3:.3f} ms of 2 profiled steps' {prof_wall:.3f} s = "
          f"{busy_us / 1e6 / prof_wall:.5f} of the wall")
    for e in sorted(kerns, key=lambda e: -e.self_device_time_total)[:6]:
        print(f"profile train {cfg.name} device time "
              f"{e.self_device_time_total / 1e3:.3f} ms x{e.count}: "
              f"{e.key[:90]}")
    del model
    torch.cuda.empty_cache()
    return {"launches": launches, "routes": routes, "step_ms": step_s * 1e3,
            "n_layers": cfg.n_layers}


def check_train_restart(device, cfg) -> None:
    """The checkpoint cycle on the card at ``cfg``'s depth: a Trainer runs
    TRAIN_CKPT steps and checkpoints; a restarted Trainer restores it
    (bit-exactly: the fingerprints of the restored state equal the saved
    state's) and resumes at step TRAIN_CKPT + 1 up to TRAIN_STEPS."""
    import shutil
    import torch
    from repro_torch.models.model import Model
    from repro_torch.train.train_step import make_train_step
    from repro_torch.train.trainer import Trainer, TrainerConfig
    model = Model(cfg, device=device)
    print(f"reduced: train checkpoint cycle {TRAIN_ARCH} n_layers 32 → "
          f"{cfg.n_layers} ({model.n_params():,} parameters, "
          f"{12 * model.n_params() / 1e9:.2f} GB a checkpoint of float32 "
          "masters and moments; at the fitted depth two would write ~104 GB "
          "to the disk)")
    shutil.rmtree(TRAIN_CKPT_DIR, ignore_errors=True)
    fps = {}

    class CheckedTrainer(Trainer):
        """Records the fingerprint of the state it restores."""

        def restore_or_init(self):
            params, opt, start = super().restore_or_init()
            if start:
                fps["restored"] = fingerprint({"params": params, "opt": opt})
            return params, opt, start

    def trainer(steps):
        tc = TrainerConfig(steps=steps, ckpt_every=TRAIN_CKPT, keep=1,
                           ckpt_dir=str(TRAIN_CKPT_DIR), log_every=5)
        return CheckedTrainer(model, make_train_step(model, train_hp(cfg)),
                              train_loader(cfg, device), tc)

    t0 = time.perf_counter()
    params, opt, hist_a = trainer(TRAIN_CKPT).run()
    t_a = time.perf_counter() - t0
    fps["saved"] = fingerprint({"params": params, "opt": opt})
    del params, opt
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params, opt, hist_b = trainer(TRAIN_STEPS).run()
    t_b = time.perf_counter() - t0
    count = opt.count
    del params, opt
    torch.cuda.empty_cache()
    shutil.rmtree(TRAIN_CKPT_DIR, ignore_errors=True)
    same = fps.get("restored") == fps["saved"]
    print(f"check train checkpoint ({cfg.n_layers} layer): step "
          f"{TRAIN_CKPT} restored on the card bit-exactly "
          f"({len(fps['saved'])} leaves' fingerprints equal): {same}; the "
          f"restarted Trainer resumed at step {hist_b[0]['step']}, ended at "
          f"count {count}; {t_a:.1f} s for steps 1-{TRAIN_CKPT} and the "
          f"checkpoint, {t_b:.1f} s for the restore, the rest and the final "
          "checkpoint")
    require(same, "train: the restored state differs from the saved one")
    require(hist_b[0]["step"] == TRAIN_CKPT + 1,
            f"train: restart resumed at {hist_b[0]['step']}")
    require([h["step"] for h in hist_a + hist_b]
            == list(range(1, TRAIN_STEPS + 1)),
            "train: the restarted run's steps do not follow on")


# --------------------------------------------------------------------------
# Phase 12: the cost model and autotune
# --------------------------------------------------------------------------

def time_plans(calls: dict) -> dict:
    """Device ms of each call of ``calls`` (plan key -> thunk) in two
    rounds, forward then reverse, in one process: key -> [first, second]."""
    times = {key: [] for key in calls}
    for order in (list(calls), list(calls)[::-1]):
        for key in order:
            times[key].append(cuda_time_ms(calls[key], iters=20))
    return times


def report_plans(label: str, key: str, formula: dict, pick: dict,
                 times: dict, bound: tuple, cands: list) -> dict:
    """One line for a battery shape: the formula's plan, the analytic pick
    the wrappers take and the measured best, each with the mean of its
    two rounds and their spread, and the bound; returns the record."""
    def name(plan):
        return json.dumps(plan, sort_keys=True)

    mean = {k: statistics.mean(v) for k, v in times.items()}
    best = min(cands, key=lambda p: (mean[name(p)], name(p)))
    f_ms, p_ms, b_ms = (mean[name(p)] for p in (formula, pick, best))
    spread = max(abs(times[name(p)][0] - times[name(p)][1])
                 for p in (formula, pick))
    print(f"plan {label}: formula {name(formula)} {f_ms:.6f} ms; analytic "
          f"{name(pick)} {p_ms:.6f} ms; measured best {name(best)} "
          f"{b_ms:.6f} ms; bound {bound[0]:.6f} ms ({bound[1]}); analytic "
          f"no slower than the formula beyond the spread {spread:.6f}: "
          f"{p_ms <= f_ms + spread}")
    return {"key": key, "label": label, "formula": formula, "pick": pick,
            "best": best, "best_ms": b_ms, "bound_ms": bound[0],
            "times": dict(times),
            "n_candidates": len(cands)}


def sweep_matmul_plans(device, n_sm: int) -> list[dict]:
    """Every candidate plan of every matmul battery shape against the plain
    version, and timed (phase 12 a)."""
    import torch
    from repro_torch.kernels import autotune as at
    from repro_torch.kernels import matmul as mm
    epilogues = {(K, N): epi for K, N, epi in MATMUL_SHAPES}
    out = []
    for M, K, N in at.MATMUL_BATTERY:
        epi = epilogues[(K, N)]
        a, b, _ = matmul_inputs(M, K, N, False, device)
        want = mm.matmul_plain(a, b, epilogue=epi)
        cands = at.matmul_candidates(M, K, N, n_sm)
        calls = {}
        for plan in cands:
            got = mm.matmul(a, b, epilogue=epi, plan=plan)
            require(torch.allclose(got, want, atol=MATMUL_ATOL,
                                   rtol=MATMUL_RTOL),
                    f"matmul ({M},{K})@({K},{N}) plan {plan}: "
                    f"{(got - want).abs().max().item():.3g} off the plain")
            calls[json.dumps(plan, sort_keys=True)] = (
                lambda plan=plan: mm.matmul(a, b, epilogue=epi, plan=plan))
        pick = at.matmul_plan(M, K, N, n_sm)
        out.append(report_plans(
            f"matmul ({M},{K})@({K},{N}) {epi} ({mm._route(M)})",
            at.matmul_key(M, K, N, n_sm), at.matmul_formula(M, K, N, n_sm),
            pick, time_plans(calls),
            bound_ms(4 * (M * K + K * N + M * N), 2 * M * N * K), cands))
    return out


def sweep_decode_plans(device, n_sm: int) -> list[dict]:
    """Every candidate n_split of every decode battery shape against the
    plain version, and timed, on decode_inputs' ragged rows (0, 1, L and
    five drawn; phase 12 a)."""
    import torch
    from repro_torch.kernels import autotune as at
    from repro_torch.kernels import decode_attention as da
    out = []
    for B, KV, G, D, L in at.DECODE_BATTERY:
        for dtype in at.DECODE_DTYPES:
            dt = getattr(torch, dtype)
            q, k, v, lens = decode_inputs(L, dt, device, B=B,
                                          heads=(KV * G, KV, D))
            want = da.decode_attention_plain(q, k, v, kv_len=lens)
            cands = at.decode_candidates(L)
            calls = {}
            for plan in cands:
                got = da.decode_attention(q, k, v, kv_len=lens, plan=plan)
                err = (got.float() - want.float()).abs().max().item()
                require(err <= ATTN_ATOL[dtype],
                        f"decode G={G} D={D} L={L} {dtype} plan {plan}: "
                        f"{err:.3g} off the plain")
                calls[json.dumps(plan, sort_keys=True)] = (
                    lambda plan=plan: da.decode_attention(
                        q, k, v, kv_len=lens, plan=plan))
            valid = int(lens.sum().item())
            isz = q.element_size()
            pick = at.decode_plan(B, KV, G, D, D, L, dtype, n_sm)
            out.append(report_plans(
                f"decode B={B} KV={KV} G={G} D={D} L={L} {dtype} "
                f"({da._route(dt, G, D, D)})",
                at.decode_key(B, KV, G, D, D, L, dtype, n_sm),
                {"n_split": da.split_l(B, KV, L, n_sm)}, pick,
                time_plans(calls),
                bound_ms(isz * (2 * valid * KV * D + 2 * q.numel())
                         + 4 * B, 4 * D * KV * G * valid,
                         PEAK_BF16_FLOP_S if dtype == "bfloat16"
                         else PEAK_FP32_FLOP_S), cands))
    return out


def roofline_of_step(arch: str, n_layers: int, kind: str, batch: int,
                     seq: int, measured_ms) -> dict:
    """Count one ``kind`` step of ``arch`` at ``n_layers`` on fake tensors
    and print its Roofline beside the time a phase measured (phase 12 c)."""
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.core import acceleration
    from repro_torch.models.model import Model
    from repro_torch.roofline import analysis
    cfg = get_config(arch).replace(n_layers=n_layers)
    shape = ShapeConfig(f"{kind}_{batch}x{seq}", kind, seq, batch)
    t0 = time.perf_counter()
    counted = analysis.count_step(Model(cfg, device="cpu"), None, shape, kind)
    rl = analysis.from_counted(
        arch, shape.name, "1", 1, counted.counter, counted.lib_flops, cfg,
        shape, param_bytes=counted.param_bytes,
        cache_bytes=counted.cache_bytes)
    d = rl.to_dict()
    require(d["hlo_flops"] > 0 and d["hlo_bytes"] > 0
            and 0 < d["useful_flops_ratio"] <= 1.2
            and d["flash_bytes"] <= d["hlo_bytes"]
            and all(math.isfinite(x) for x in d.values()
                    if isinstance(x, float)),
            f"roofline {arch} {kind}: {d}")
    print(f"roofline {arch} {kind} ({n_layers} layers, {batch} x {seq}; "
          f"counted in {time.perf_counter() - t0:.1f} s): "
          + json.dumps(d, default=str))
    if measured_ms is None:
        print(f"roofline {arch} {kind}: measured not measured (run alone)")
    else:
        print(f"roofline {arch} {kind}: measured {measured_ms:.3f} ms; "
              f"bound {rl.t_bound * 1e3:.3f} ms (plain versions' traffic, "
              f"{rl.bottleneck}) = {rl.t_bound * 1e3 / measured_ms:.4f} of "
              f"it; with the kernels' traffic {rl.t_bound_pallas * 1e3:.3f} "
              f"ms = {rl.t_bound_pallas * 1e3 / measured_ms:.4f}; ideal "
              f"{rl.t_ideal * 1e3:.3f} ms = "
              f"{rl.t_ideal * 1e3 / measured_ms:.4f}")
    sweep = acceleration.roofline_sweep(rl.stage_profile(), AMDAHL_SPEEDUPS)
    print(f"roofline {arch} {kind} Amdahl (s, speed-up, residual tax) at ai "
          f"{rl.ai_fraction:.4f}: " + json.dumps(
              [[s, round(a, 4), round(r, 4)] for s, a, r in sweep]))
    return d


def run_cost_phase(device, tick=None, train=None) -> None:
    """Phase 12: the plan sweep, its overlay, and the roofline of a
    llama3-8b decode tick and train step beside phases 6 and 11's times
    (``tick``, ``train``: their measured ms and depth; None run alone)."""
    import torch
    from repro_torch.kernels import autotune as at
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    rows = sweep_matmul_plans(device, n_sm) + sweep_decode_plans(device, n_sm)
    MEASURED_PLANS.unlink(missing_ok=True)
    overlay = at.AutotuneCache(path=MEASURED_PLANS, seed_path=None)
    for r in rows:
        overlay.store(r["key"], at.TuneResult(
            r["best"], r["best_ms"] * 1e3, "measured",
            r["n_candidates"]).to_json())
    PLAN_SWEEP.write_text(json.dumps(rows, indent=1))
    print(f"plans: {len(rows)} battery shapes, "
          f"{sum(r['n_candidates'] for r in rows)} candidate plans held and "
          f"timed ({PLAN_SWEEP.relative_to(ROOT)}); measured picks in "
          f"{MEASURED_PLANS.relative_to(ROOT)} "
          f"(the seed {at.SEED_PATH.relative_to(ROOT)} untouched)")
    from repro_torch.configs import get_config
    cfg = get_config(TRAIN_ARCH)
    tick_layers = tick["n_layers"] if tick else cfg.n_layers
    if train:
        train_layers = train["n_layers"]
    else:
        train_layers = train_depth_first_try(
            cfg, torch.cuda.mem_get_info(device)[0])
        print(f"roofline {TRAIN_ARCH} train: {train_layers} layers, "
              "fit_train_depth's first try (no step run alone)")
    roofline_of_step(TRAIN_ARCH, tick_layers, "decode", SERVE_SLOTS,
                     SERVE_CACHE_LEN, tick["tick_ms"] if tick else None)
    roofline_of_step(TRAIN_ARCH, train_layers, "train", TRAIN_B, TRAIN_S,
                     train["step_ms"] if train else None)


def start_dryrun() -> dict:
    """Phase 13 (c): one child process a dry-run cell of TRAIN_ARCH on the
    pod16x16 mesh, started now; :func:`check_dryrun` waits for them."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = {}
    for shape in DRYRUN_SHAPES:
        procs[shape] = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             TRAIN_ARCH, "--shape", shape, "--out", str(DRYRUN_OUT)],
            env=env, cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    return procs


def check_dryrun(procs: dict) -> None:
    """Wait for :func:`start_dryrun`'s cells and hold each one's record."""
    from repro_torch.roofline.hw import HBM_BYTES
    for shape, proc in procs.items():
        try:
            out, _ = proc.communicate(timeout=DRYRUN_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for p in procs.values():
                p.kill()
                p.communicate()
            raise SmokeFailure(f"dry run {shape}: over {DRYRUN_TIMEOUT_S} s")
        path = DRYRUN_OUT / "pod16x16" / f"{TRAIN_ARCH}__{shape}.json"
        tail = "\n".join(out.splitlines()[-12:])
        require(proc.returncode == 0 and path.exists(),
                f"dry run {shape}: exit {proc.returncode}\n{tail}")
        rec = json.loads(path.read_text())
        require(rec["status"] == "ok", f"dry run {shape}: {rec}")
        keys = ("chips", "hlo_flops", "hlo_bytes", "coll_bytes",
                "coll_breakdown", "bytes_per_device", "t_compute",
                "t_memory", "t_collective", "bottleneck", "t_bound",
                "t_ideal", "roofline_fraction", "model_flops", "t_count_s")
        print(f"dryrun {TRAIN_ARCH} {shape} pod16x16: "
              + json.dumps({k: rec[k] for k in keys}))
        require(rec["chips"] == 256, f"dry run {shape}: {rec['chips']} chips")
        require(rec["bytes_per_device"] <= HBM_BYTES,
                f"dry run {shape}: {rec['bytes_per_device']} bytes a device")
        require(rec["coll_bytes"] > 0, f"dry run {shape}: no collective")


def shard_serve(device, mesh) -> dict:
    """Phase 13 (a): greedy tokens of the serve steps on ``mesh`` against
    the model's own prefill and decode, and the kernels' launches."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.serve import serve_step
    cfg, model, params = fit_depth(device, get_config(TRAIN_ARCH))
    cache_len = SHARD_PROMPT_LEN + SHARD_STEPS
    rng = np.random.default_rng(13)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (SHARD_PROMPTS, SHARD_PROMPT_LEN))
        .astype(np.int32)).to(device)

    def greedy(prefill, decode):
        with torch.inference_mode():
            logits, cache = prefill(params, {"tokens": prompts})
            toks = [torch.argmax(logits, -1).to(torch.int32)[:, None]]
            for _ in range(SHARD_STEPS):
                logits, cache = decode(params, cache, toks[-1])
                toks.append(torch.argmax(logits, -1).to(torch.int32)[:, None])
        torch.cuda.synchronize()
        return torch.cat(toks, 1)

    direct = greedy(lambda p, b: model.prefill(p, b, cache_len=cache_len),
                    model.decode_step)
    sh = serve_step.make_serve_shardings(model, mesh, SHARD_PROMPTS,
                                         cache_len)
    for w in (fa.flash_attention, da.decode_attention):
        build.zero_launches(w)
    t0 = time.perf_counter()
    sharded = greedy(serve_step.make_prefill(model, sh, cache_len),
                     serve_step.make_decode_step(model, sh))
    ms = (time.perf_counter() - t0) * 1e3
    routes = {"flash_attention": dict(fa.flash_attention.launches_by_route),
              "decode_attention": dict(da.decode_attention.launches_by_route)}
    same = bool(torch.equal(direct, sharded))
    print(f"shard serve {cfg.name} {cfg.n_layers} layers: {SHARD_PROMPTS} x "
          f"{SHARD_PROMPT_LEN} prompts, {SHARD_STEPS} steps through "
          f"serve_step on {tuple(mesh.shape)} {mesh.device_type} mesh in "
          f"{ms:.1f} ms; tokens bit-equal to Model.prefill/decode_step: "
          f"{same}; launches {routes}")
    require(same, "shard serve: serve_step tokens differ from the model's")
    n = cfg.n_layers
    require(routes["flash_attention"]["wgmma"] == n,
            f"shard serve: flash wgmma launches {routes['flash_attention']}")
    require(routes["decode_attention"]["mma"] == n * SHARD_STEPS,
            f"shard serve: decode mma launches {routes['decode_attention']}")
    return {"n_layers": n, "ms": ms, "routes": routes}


def shard_train(device, mesh) -> dict:
    """Phase 13 (b): one sharded train step on ``mesh`` against the
    unsharded step's loss, and flash's backward launches."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.model import Model
    from repro_torch.train import train_step as ts
    from repro_torch.train.optimizer import init_opt_state
    cfg = get_config(TRAIN_ARCH).replace(n_layers=SHARD_TRAIN_LAYERS)
    model = Model(cfg, device=device)
    params = model.init(seed=0, masters=True)
    batch = train_loader(cfg, device).next_batch()
    loss_u, grads = ts.make_train_step(model, train_hp(cfg)).grads(params,
                                                                  batch)
    loss_u = float(loss_u)
    del grads
    sh = ts.make_train_shardings(model, mesh)
    build.zero_launches(fa.flash_attention_bwd)
    t0 = time.perf_counter()
    params, opt, metrics = ts.make_train_step(model, train_hp(cfg), sh)(
        params, init_opt_state(params), batch)
    loss = float(metrics["loss"])
    ms = (time.perf_counter() - t0) * 1e3
    bwd = dict(fa.flash_attention_bwd.launches_by_route)
    print(f"shard train {cfg.name} {cfg.n_layers} layers: loss {loss!r} "
          f"(unsharded {loss_u!r}), grad norm {float(metrics['grad_norm']):.4f}, "
          f"{ms:.1f} ms; flash backward launches {bwd}")
    require(loss == loss_u, f"shard train: loss {loss} != unsharded {loss_u}")
    require(bwd["wgmma"] == sum(bwd.values()) >= cfg.n_layers,
            f"shard train: flash backward launches {bwd}, want every one on "
            f"the wgmma route")
    require(opt.count == 1, "shard train: no update")
    return {"loss": loss, "ms": ms}


def run_shard_phase(device) -> dict:
    """Phase 13: the serve and train steps under shardings on a mesh of
    one over the card, and the dry run's llama3-8b cells."""
    import torch
    from repro_torch.launch.mesh import destroy, make_host_mesh
    procs = start_dryrun()
    try:
        mesh = make_host_mesh(device=device)
        try:
            serve = shard_serve(device, mesh)
            torch.cuda.empty_cache()
            train = shard_train(device, mesh)
            torch.cuda.empty_cache()
        finally:
            destroy()
        check_dryrun(procs)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()
    return {"serve": serve, "train": train}


def kernel_table():
    """Every ported kernel: its wrapper, source, the TPU kernel it
    replaces, and the path (for serve, the arch) whose run counts its
    launches in the kernels line; ``archs``, where given, every served
    arch whose runs gate its launches (all must launch it, but where
    MLA_GATES says that an arch's path has no such kernel)."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import linear_scan as ls
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import preproc, resize
    csrc = "src/repro_torch/kernels/csrc/"
    return [
        {"name": "matmul", "wrapper": mm.matmul, "source": csrc + "matmul.cu",
         "replaces": "src/repro/kernels/matmul.py:106", "path": "pipeline"},
        # the same wrapper's rows route (9 to 64 rows), a kernel of its own
        # in the same source; its launches are the cluster phase's two
        # S = 4 runs' (every replica batch's two products)
        {"name": "matmul_rows", "wrapper": mm.matmul,
         "source": csrc + "matmul.cu",
         "replaces": "src/repro/kernels/matmul.py:106", "path": "cluster"},
        {"name": "yuv_to_rgb", "wrapper": preproc.yuv_to_rgb,
         "source": csrc + "preproc.cu",
         "replaces": "src/repro/kernels/preproc.py:56", "path": "pipeline"},
        {"name": "letterbox_normalize", "wrapper": preproc.letterbox_normalize,
         "source": csrc + "preproc.cu",
         "replaces": "src/repro/kernels/preproc.py:111", "path": "pipeline"},
        {"name": "resize_bilinear", "wrapper": resize.resize_bilinear,
         "source": csrc + "resize.cu",
         "replaces": "src/repro/kernels/resize.py:65", "path": "pipeline"},
        {"name": "iou_matrix", "wrapper": preproc.iou_matrix,
         "source": csrc + "iou.cu",
         "replaces": "src/repro/kernels/preproc.py:156", "path": "nms"},
        {"name": "decode_attention", "wrapper": da.decode_attention,
         "source": csrc + "decode_attention.cu",
         "replaces": "src/repro/kernels/decode_attention.py:116",
         "path": "serve", "arch": "llama3-8b",
         "archs": ("llama3-8b", "jamba-v0.1-52b", *ZOO_HEADS,
                   "deepseek-v2-236b")},
        {"name": "flash_attention", "wrapper": fa.flash_attention,
         "source": csrc + "flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:115",
         "path": "serve", "arch": "llama3-8b",
         "archs": ("llama3-8b", "jamba-v0.1-52b", *ZOO_HEADS,
                   "deepseek-v2-236b")},
        # the gradient of the flash forward: the TPU package has no
        # backward kernel (XLA differentiates its attention), so it stands
        # beside the forward's pallas_call
        {"name": "flash_attention_bwd", "wrapper": fa.flash_attention_bwd,
         "source": csrc + "flash_attention_bwd.cu",
         "replaces": "src/repro/kernels/flash_attention.py:115",
         "path": "train"},
        # the same wrapper's split route (gemma3's 256 and MLA's 192 | 128),
        # a kernel of its own in the same source; its launches are the
        # wgmma_split route's over every arch phase 11 trains
        {"name": "flash_attention_bwd_split",
         "wrapper": fa.flash_attention_bwd,
         "source": csrc + "flash_attention_bwd.cu",
         "replaces": "src/repro/kernels/flash_attention.py:115",
         "path": "train"},
        # its kv128 route (MLA's 192 | 128), likewise: the wgmma_kv128
        # route's launches over every arch phase 11 trains
        {"name": "flash_attention_bwd_kv128",
         "wrapper": fa.flash_attention_bwd,
         "source": csrc + "flash_attention_bwd.cu",
         "replaces": "src/repro/kernels/flash_attention.py:115",
         "path": "train"},
        {"name": "rwkv_scan", "wrapper": ls.rwkv_scan,
         "source": csrc + "linear_scan.cu",
         "replaces": "src/repro/kernels/linear_scan.py:147",
         "path": "serve", "arch": "rwkv6-3b"},
        {"name": "mamba_scan", "wrapper": ls.mamba_scan,
         "source": csrc + "linear_scan.cu",
         "replaces": "src/repro/kernels/linear_scan.py:74",
         "path": "serve", "arch": "jamba-v0.1-52b"},
        # the scans' gradients: the TPU package has no backward kernel (XLA
        # differentiates its scans), so each stands beside its forward's
        # pallas_call; their launches are the training runs' of their arch.
        # Each has two routes, the chunk-parallel one that training
        # takes and the serial kernel (float32 RWKV6, the smoke widths),
        # both in the same source
        {"name": "rwkv_scan_bwd", "wrapper": ls.rwkv_scan_bwd,
         "source": csrc + "linear_scan_bwd.cu",
         "replaces": "src/repro/kernels/linear_scan.py:147",
         "path": "train", "arch": "rwkv6-3b", "routes": ("chunk", "serial")},
        {"name": "mamba_scan_bwd", "wrapper": ls.mamba_scan_bwd,
         "source": csrc + "linear_scan_bwd.cu",
         "replaces": "src/repro/kernels/linear_scan.py:74",
         "path": "train", "arch": "jamba-v0.1-52b",
         "routes": ("chunk", "serial")},
    ]


def serve_arch(device, arch: str, kernels, launches: dict) -> dict:
    """Phases 5 and 6 for ``arch``: the smoke-size card-vs-CPU serve and
    the full-width serve with its launch and route gates; the launches of
    the kernels whose kernels-line arch is ``arch`` go into ``launches``.
    Returns the full-width run's ms a decode tick and depth."""
    import torch
    serve = [k for k in kernels if k["path"] == "serve"
             and arch in k.get("archs", (k.get("arch"),))]
    wrappers = [k["wrapper"] for k in serve]
    with phase(f"serve {arch} smoke"):
        smoke = check_serve_smoke(device, arch, wrappers)
    with phase(f"serve {arch} full width"):
        full = serve_full_width(device, arch, wrappers)
    gates = MLA_GATES if full["cfg"].mla is not None else TC_GATES
    for k in serve:
        n_full = full["launches"][k["wrapper"]]
        by_sched = {s: n[k["wrapper"]] for s, n in smoke.items()}
        print(f"serve launches {k['name']}: {arch} full width {n_full}; "
              f"smoke config on the card, each run alone: {by_sched}")
        if gates.get(k["name"], ("",))[0] is None:
            # a kernel the arch's path has none of: it must not launch
            require(n_full == 0 and not any(by_sched.values()),
                    f"{k['name']} launched on the {arch} path, which has "
                    "no such kernel")
            continue
        require(n_full > 0,
                f"{k['name']} was not launched on the {arch} serve path")
        require(all(n > 0 for n in by_sched.values()),
                f"{k['name']} was not launched by a {arch} smoke run")
        if k["arch"] == arch:
            launches[k["name"]] = n_full
    for name, kind in (("rwkv_scan", "rwkv"), ("mamba_scan", "mamba")):
        if any(k["name"] == name for k in serve):
            # one scan launch a layer of the kind for every prefill and
            # every decode tick
            n_kind = sum(s.kind == kind for s in
                         full["cfg"].block_pattern) * full["cfg"].n_repeats
            want = n_kind * (full["prefills"] + full["ticks"])
            print(f"serve launches {name}: {launches[name]} = {n_kind} "
                  f"{kind} layers x ({full['prefills']} prefills + "
                  f"{full['ticks']} ticks) = {want}: "
                  f"{launches[name] == want}")
            require(launches[name] == want,
                    f"{name} launched {launches[name]} times, want {want}")
            # by route: the long prefills on the chunked (RWKV6) or
            # segmented (Mamba) scan, from CHUNK_MIN_S or MAMBA_SEG_MIN_S
            # steps on; the decode ticks on the serial (RWKV6) or step
            # (Mamba) kernel; shorter prefills on the serial kernels
            from repro_torch.kernels import linear_scan as ls
            got = full["routes"][
                next(k["wrapper"] for k in serve if k["name"] == name)]
            lens, ticks = full["prompt_lens"], full["ticks"]
            if name == "rwkv_scan":
                long = sum(n >= ls.CHUNK_MIN_S for n in lens)
                want = {"chunk": n_kind * long,
                        "serial": n_kind * (len(lens) - long + ticks)}
            else:
                long = sum(n >= ls.MAMBA_SEG_MIN_S for n in lens)
                want = {"segmented": n_kind * long,
                        "step": n_kind * ticks,
                        "serial": n_kind * (len(lens) - long)}
            print(f"serve launches {name} by route: {arch} {got}; want "
                  f"{want}: {got == want}")
            require(got == want, f"{name}: {got} on {arch}, want {want}")
    n_attn = sum(s.kind == "attn" for s in
                 full["cfg"].block_pattern) * full["cfg"].n_repeats
    for k in serve:
        if k["name"] not in gates:
            continue
        route, per = gates[k["name"]]
        got = full["routes"][k["wrapper"]]
        if route is None:
            print(f"serve launches {k['name']} by route: {arch} {got}; want "
                  f"0 over {full[per]} {per}: MLA's absorbed decode is plain "
                  f"einsums in both packages: {sum(got.values()) == 0}")
            require(sum(got.values()) == 0,
                    f"{k['name']}: {got} on {arch}, want no launch")
            continue
        want = n_attn * full[per]
        print(f"serve launches {k['name']} by route: {arch} {got}; "
              f"{route} = {n_attn} attention layers x {full[per]} {per} "
              f"= {want}: {got[route] == want}")
        require(got[route] == want and sum(got.values()) == want,
                f"{k['name']}: {got} on {arch}, want {want} on {route}")
    with phase(f"serve {arch} profile"):
        profile_serve(full["model"], full["params"], full["cfg"])
    measured = {"tick_ms": full["tick_ms"], "n_layers": full["cfg"].n_layers}
    del full                     # free the weights before the next arch
    torch.cuda.empty_cache()
    if arch in F32_AFTER:
        with phase(f"serve {arch} float32"):
            check_f32_depth(device, arch)
        torch.cuda.empty_cache()
    return measured


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import autotune, build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    # launch plans: the committed seed, and shapes outside it tuned
    # analytically into an overlay of this checkout's build/ (made afresh)
    AUTOTUNE_OVERLAY.unlink(missing_ok=True)
    autotune.set_cache(autotune.AutotuneCache(path=AUTOTUNE_OVERLAY))

    if sys.argv[1:] == [CLUSTER_ONLY]:
        build.build_all()
        run_cluster_phase(device)
        return 0
    if sys.argv[1:] == [COST_ONLY]:
        card = card_line()
        print(f"card: {card}")
        build.build_all()
        with phase("cost model and autotune"):
            run_cost_phase(device)
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    if sys.argv[1:] == [SHARD_ONLY]:
        card = card_line()
        print(f"card: {card}")
        print(f"torch {torch.__version__} cuda {torch.version.cuda}")
        build.build_all()
        with phase("sharding"):
            run_shard_phase(device)
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    if sys.argv[1:] in ([WHISPER_ONLY], [TRAIN_ONLY]):
        print(f"card: {card_line()}")
        build.build_all()
        kernels = kernel_table()
        with phase("kernel checks (attention)"):
            check_serve_kernels(device)
        if sys.argv[1] == TRAIN_ONLY:
            with phase("kernel checks (scan backwards)"):
                check_scan_bwd(device)
        if sys.argv[1] == WHISPER_ONLY:
            with phase("whisper"):
                run_whisper(device, kernels)
        else:
            with phase("train"):
                run_train(device, kernels)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    start = time.perf_counter()
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    build.build_all()
    print(f"built {sorted(build.BUILD_LOG) or 'nothing (cached)'} in "
          f"{time.perf_counter() - t0:.1f} s")
    for stem, log in sorted(build.BUILD_LOG.items()):
        entry = ""
        for line in log.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]     # the mangled kernel name
            if "Used" in line or "spill" in line:
                print(f"ptxas {stem} {entry}: {line.strip()}")
            if "spill" in line and any(k in entry for k in NO_SPILL):
                require(" 0 bytes spill stores" in line
                        and " 0 bytes spill loads" in line,
                        f"ptxas: {entry} spills: {line.strip()}")
    for stem, op in TC_SASS.items():
        n = build.sass(stem).count(op)
        print(f"sass {stem}: {n} {op} instructions (tensor cores)")
        require(n > 0, f"{stem}: no {op} instruction in its SASS")

    kernels = kernel_table()
    with phase("kernel checks"):
        errors = check_kernels(device)
        errors.update(check_serve_kernels(device))
        errors.update(check_scan_kernel(device))
        errors.update(check_mamba_kernel(device))
        errors.update(check_scan_bwd(device))
        check_norms(device)
    launches = {}
    with phase("pipeline"):
        path = check_pipeline(
            device, [k for k in kernels if k["path"] == "pipeline"],
            n_frames=16, src_hw=(SRC_H, SRC_W))
    launches.update(path["launches"])
    with phase("nms"):
        launches["iou_matrix"] = run_nms_path(device)
    ticks = {}
    for arch in SERVE_ARCHS:
        with phase(f"serve {arch}"):
            ticks[arch] = serve_arch(device, arch, kernels, launches)
    with phase("times"):
        times = time_kernels(device)
        profile_pipeline(device, n_frames=16, src_hw=(SRC_H, SRC_W))
    with phase("cluster"):
        cluster = run_cluster_process()
    launches["matmul_rows"] = cluster["matmul"].get("rows", 0)
    with phase("taxed step"):
        run_taxed_identify(device)
    torch.cuda.empty_cache()
    # the encoder-decoder and training phases last: phase 8's producer
    # threads are sensitive to what runs before them (PERF.md, section 6)
    with phase("whisper"):
        run_whisper(device, kernels)
    torch.cuda.empty_cache()
    with phase("train"):
        train = run_train(device, kernels)
    launches["flash_attention_bwd"] = train["launches"]["flash_attention_bwd"]
    for name, route in (("flash_attention_bwd_split", "wgmma_split"),
                        ("flash_attention_bwd_kv128", "wgmma_kv128")):
        launches[name] = sum(
            r.get("flash_attention_bwd", {}).get(route, 0)
            for r in train["routes_by_arch"].values())
    for k in kernels:
        if k["path"] == "train" and "arch" in k:
            launches[k["name"]] = train["launches_by_arch"][k["arch"]][
                k["name"]]
    torch.cuda.empty_cache()
    with phase("cost model and autotune"):
        run_cost_phase(device, ticks[TRAIN_ARCH], train)
    torch.cuda.empty_cache()
    with phase("sharding"):
        run_shard_phase(device)

    rows = []
    for k in kernels:
        t = times[k["name"]]
        rows.append({"name": k["name"], "route": "cuda", "source": k["source"],
                     "replaces": k["replaces"],
                     "launches": launches[k["name"]],
                     "max_abs_err": errors[k["name"]], "ms": t["ms"],
                     "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                     "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
        if "routes" in k:
            # the wrapper's routes: its launches on the path by route, and
            # each route's ms at the row's shape in the same run
            rows[-1]["launches_by_route"] = train["routes_by_arch"][
                k["arch"]][k["name"]]
            rows[-1]["route_ms"] = t["route_ms"]
        for earlier in ("tile_ms", "split_ms"):
            # a redesigned route's predecessor, forced at the row's shape
            if earlier in t:
                rows[-1][earlier] = t[earlier]
    idle = [r["name"] for r in rows if not r["launches"]]
    require(not idle, f"kernels launched no time on their path: {idle}")
    print(f"chip_smoke: {time.perf_counter() - start:.1f} s in all")
    print(card)        # as nvidia-smi reports it: name, power limit
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
