#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py          # from the root of a checkout, on a GPU host
    python3 chip_smoke.py --b1 [--src DIR]   # csrc/gemm.cu's B1, B2, B3 alone (b1_only)
    python3 chip_smoke.py --b6 [--src DIR]   # B6's wide form alone (b6_only)

Phases (any failure exits non-zero):

1. print the card's name and power limit; turn TF32 off for cuDNN and
   cuBLAS so every f32 reference below is IEEE f32;
2. build the hand-written kernels from ``src/repro_torch/kernels/csrc``
   (one nvcc per source, in parallel);
3. hold each kernel against its plain PyTorch version on the card, at
   batch 1 over the six nets: the fused conv at every distinct
   ``groups == 1`` conv geometry and the fused dense GEMM at every fc
   shape (3a); the patch matrix (B4) at every conv geometry at batch 1
   and 4, and at AlexNet's sliced convs on the
   channel-slice views the served graph hands it (each launched once, read
   in place), bitwise, with its library yardstick ``im2col_library``; the
   GEMM (B3) at every ``groups == 1`` conv GEMM shape and every fc
   shape; the quantized conv (B1q) at every ``groups == 1`` conv
   geometry, bitwise (3c).  Then time every kernel at VGG-16's shapes at
   batch 4 beside its plain version, one library call where there is
   one, and its bound (3b, 3d; for csrc/gemm.cu's entries their route's
   own, the split-TF32 rate where they sum in the tensor-core order,
   with the f32 CUDA-core bound beside it), as device time (a run of calls queued
   behind a sleep kernel, ``device_ms``), with the host-paced time
   (``time_ms``) beside it.  3d also holds bits: at each VGG-16 conv the
   fused conv's image 0 alone equals image 0 of the batch of 4, every
   tile variant gives the same output, and the output equals
   ``relu(gemm(im2col(x)) + b)``; at each fc the fused GEMM's rows at M =
   1, 4, 8 and 16 are equal, and equal ``relu(gemm(a, w) + b)``; at each
   conv GEMM the first 4 rows of the tiled result and every tile
   variant's result equal the served tiled result; at each conv the
   quantized conv's every tile variant, and its kernel alone on ready u8
   operands, equal ``qfused_route_ref``.  B1q is timed as that kernel
   alone, with its bound on the int8 tensor cores, beside the whole call
   (quantization included), the quantization alone and the filter's
   packing, which a layer does once.  B4 is timed beside
   ``im2col_library`` (``F.pad``, then one strided copy; the copy alone
   beside it), both bitwise equal, and its per-layer times are printed on
   a line of their own;
4. drive the port's main path, ``serve("vgg16", backend="cuda_fused",
   batch_size=4)``, with 32 seeded images, twice on the same weights:
   with the stage functions op by op (``stage_fn_builder=`` the eager
   builder), then as CUDA graphs (the default: each stage captured at
   its first micro-batch, replayed for every later one).  In each the
   launch counters must show 13 conv and 3 dense launches per
   micro-batch (12 and 3 of them in csrc/gemm.cu's tensor-core order) (a replay counts what its capture recorded) and the
   graph launches one per stage and micro-batch (none op by op); the
   graph outputs must be bitwise equal to the eager outputs and to the
   single-stage ``cuda_fused`` engine's (itself a graph) and close to the
   plain ``torch`` route's; each server is timed over three steady
   windows of 1024 images and traced by the profiler over a window of
   256 (the device's busy share).  On the live graph server a thread
   submits 128 images while ``swap_plan`` moves to another plan: no ticket
   may be lost or change its bits, the old graphs are never replayed
   again, and the new epoch's replays count as before.  4b: the same for
   the unfused route, ``serve("vgg16", backend="cuda", ...)``: 13 im2col
   and 16 GEMM launches per micro-batch and no fused one, bitwise equal
   to its eager outputs, to the single-stage ``cuda`` engine and to the
   served ``cuda_fused`` outputs in each mode (the fused kernels sum in
   the GEMM's order).  The eager-against-graph numbers of both routes go
   on a ``serve_eager_vs_graph`` line.
   4c: the quantized path at full width: each of the served VGG-16's 13 conv nodes through
   ``make_quant_conv_fn(..., kernel=True)`` on its real batch-4 input
   (teacher-forced from a ``cuda_fused`` forward), bitwise equal to
   ``qfused_route_ref`` and close to ``im2col`` + ``qgemm``, with each
   node's relative error against its f32 output printed (paper Fig. 13);
5. the plan from the card (``plan_from_card``): a ``ConvAutotuner`` on
   a cold cache file in a temp directory sweeps B1's tile variants (the
   kernel's shape heuristic -1 first, then every variant, CUDA events behind a sleep kernel,
   best of 3 at the served batch 4) at VGG-16's 9 conv geometries, and each layer's
   conv at batch 4 is timed on the pick and on -1 (bitwise equal); a
   second tuner on the same file times nothing and picks the same (5a).
   ``measure_graph_routes`` times every layer at batch 1 on
   ``cuda_fused`` and ``cuda`` (5b).  ``serve("vgg16",
   backend="cuda_fused", platform=host_platform(2), tuner=tuner)`` plans
   from those times and serves as phase 4 does: bitwise equal to phase
   4's graph server, 13 + 3 launches a micro-batch, its predicted stage
   times (batch 1) beside the measured p50s and its img/s beside the
   ``hikey970()`` plan's (5c).  A server with ``plan_store=`` persists
   its startup plan and the plan ``swap_plan`` moves it to; ``crash()``
   fails a ticket in flight and ``stop()`` re-raises; ``serve(...,
   resume_from=)`` makes no ``pipe_it_search`` call (counted) and serves
   the persisted plan with the same bits (5d).  The closed loop
   (``closed_loop``): 5e serves VGG-16 on ``cuda_fused`` (graphs) under
   ``serve(adaptive=True)`` on ``host_platform(2)`` with 5b's measured
   layer times as the prior on both core types, behind
   ``delayed_stage_fn_builder`` (a sleep kernel of BATCH x the truth's
   stage time after each stage's replay); after a window the truth of
   core type ``L`` slows 2x, and windows of 256 images run until the
   monitor thread has hot-swapped (then one more) or 8 pass.  Gated: a
   swap after the drift, every ticket resolved once, every output
   bitwise equal to phase 4's, no monitor error, a quiet ``stop()``, 13
   + 3 launches a micro-batch and warm-up, and the reserved memory after
   the last swap no higher than after the first plus one epoch's (also
   over six swaps of a static server on the drifted truth between its
   plan and the oracle's, ``pipe_it_search`` on the drifted truth, whose
   img/s it prints).  5e-ii runs the loop on 5c's card plan with its
   default prior (Eq. 6-8 with the measurements), without delay or drift:
   gated on correctness and swaps <= rounds.  5f serves on
   ``hikey970()`` with ``power_cap_w=1.05 x`` its modeled envelope and a
   plan store, then ``governor.throttle`` to the reference test's deep
   cap (0.08 x) with 128 images in flight: no ticket lost, epoch 1, the
   capped plan and its clocks on the governor and in the store, the same
   bits.  Its clocks and watts are ``hikey970()``'s modeled ones.
   5g (``co_serving``): ``serve({"vgg16": ModelEntry(<phase 4's
   weights>), "mobilenet": "mobilenet"}, backend="cuda_fused",
   platform=host_platform(4), tuner=<phase 5's>, batch_size=4,
   plan_store=)``, the partition planned from the routes
   ``measure_graph_routes`` times under ``cuda_fused`` for both models
   (VGG-16's are cache hits: the tuner may time only MobileNet's new
   geometries).  32 images per model through ``run()``: each model
   bitwise equal to its single-stage engine, VGG-16 also to phase 4, 13
   + 3 (VGG-16) and 14 + 1 (MobileNet's ``groups == 1`` convs and fc;
   its 13 depthwise convs run ``F.conv2d``) launches a micro-batch, one
   graph launch per stage.  Three steady windows of 1024 images per
   model, both streams fed at once (aggregate and per-model img/s beside
   phase 4's VGG-16 alone), a profiled window of 256 (the device's busy
   share), then the ``TimeSlicedEngine`` (quantum 4,
   each model on its own ``host_platform(4)`` plan) against the
   co-served partition, both at batch 1 over 256 images per model, on
   one ``multimodel`` line (rates recorded, bits gated).  While a thread
   submits 128 images per model, ``swap_partition`` moves to the
   ``fairness="max-min"`` partition (or else the best-scored assignment
   whose plans differ): no ticket lost, the same bits, epoch 1, the
   store holding it; four more swaps back and forth, the reserved memory
   after the last no higher than after the first plus one epoch's.
   ``serve({...}, resume_from=)`` makes no ``partition_search`` call
   (counted) and serves the stored partition with the same bits; a short
   ``serve({...}, adaptive=True)`` run: no monitor error, a quiet
   ``stop()``, the same bits.
   5h (``open_loop``): phase 4's ``cuda_fused`` graph server (an ingress of
   16 micro-batches, a flush timeout of 10 ms) under ``run_open_loop``:
   seeded Poisson traces at 0.5x and 0.85x phase 4's mean img/s (2048
   arrivals each), an MMPP (calm 0.3x, bursts 1.2x, mean dwells 0.5 s and
   0.2 s, 3 s), and the same MMPP behind a ``QueueController`` with an SLO
   of twice the 0.5x run's p99.  A wrapper around the server records each
   submitted ticket with its arrival: every one must complete, bitwise
   equal to phase 4's output for its image, nothing may be shed at 0.5x,
   and each micro-batch replays 13 + 3 launches; the latencies, sheds,
   goodput and how late each submission left behind its trace time go on
   the ``open_loop_5h`` line.  5i (``fleet``): two ``host_platform(4)``
   boards on the card, ``fleet_search`` with two replicas a model over
   5g's measured routes and ``verify_placement``; a ``FleetRouter`` of
   5g's registry on ``cuda_fused`` graphs at micro-batch 4, warmed up
   (every graph capture counted with its thread: none may come from a
   stage worker); three windows of 512 images a model fed at once; three
   times the seeded victim fails from a thread in the middle of a window,
   rejoins, and a window follows (reserved memory after each cycle, no
   higher after the last than after the first plus one board's epoch);
   ``apply_plan`` to one replica a model, then ``FleetAutoscaler.step()``
   in the middle of a window; ``apply_plan`` with the same plan changes
   no board's generation.  No ticket lost or failed, every output bitwise
   equal to its model's single-stage engine (5g's), 13 + 3 and 14 + 1
   launches a micro-batch; the ``fleet_5i`` line;
6. the transformer slice (``hymba_phases``): 6a holds the decode-attention
   kernel (B5) against its plain version at G in {1, 5}, D in {64, 128},
   S in {1, 300, 1024}, a valid prefix of 1, a ragged value, S and each
   side of the first split boundary, and S = 32768 with prefixes 1 and
   777 (most splits empty), batch 4 with 5 KV heads, and at the shapes of
   6e and 6f (Hkv 5, G 3, D 64 and Hkv 16, G 1, D 128, 896 slots) and
   StarCoder2-15B's decode step (Hkv 4, G 12, D 128 on a 4096-slot window
   ring that has wrapped), at 6g's (Hkv 1, G 8, D 256, 1152 slots) and on
   6h's int8 cache (Hkv 32, G 1, D 64, 896 slots, f32 scales), f32 and
   bf16; the int8 cache also bitwise against the kernel on the cache
   dequantized into q's type; a row
   at batch 1, a second call and the length read on the device (as the
   captured decode step passes it; past S it clamps to S) must give the
   same bits; 6b the SSD scan
   (B6) at Hymba's 50 heads
   of P = 64, N = 16, chunk 64 and 128, a nonzero h0, head-stride-0 B/C,
   f32 and bf16, and its wide form with the normalizer at xLSTM's N = P =
   512, chunk 128 (the served prefill's shape, a ragged S of 300, and 768
   tokens from a given h0 and n0; y, h_final, den and n_final in f32 and
   bf16, gated relative to the output's scale); 6c, 6e, 6f, 6g, 6h and
   6i (``lm_phase``, one body for the six models) serve Hymba-1.5B (32 layers), SmolLM-360M (32 dense
   layers), OLMoE-1B-7B (16 MoE layers, 64 experts, top-8), PaliGemma-3B
   (18 layers, MQA at head_dim 256, 256 random SigLIP-width image
   features projected before the prompt and attended both ways),
   MusicGen-large (48 layers, four codebooks summed in and read out by
   four heads, an int8 KV cache) and xLSTM-1.3B (48 layers: six runs of
   7 mLSTM layers, each followed by one sLSTM layer; 6i, after 6h) at
   full width and depth (random weights from seed 0, bf16 on f32 weights, after checking
   that the f32 weights and their bf16 copy fit) through
   ``repro_torch.launch.serve.generate``, the CLI's own loop: batch 4, a
   768-token prompt (896 with Hymba's meta tokens, 1024 with PaliGemma's
   patches; 768 x 4 codebook tokens for MusicGen), 128 greedy steps, the
   first op by op and the rest replaying one captured step.  The launch
   counters must show one SSD launch a Hymba or mLSTM layer and no other
   launch in the prefill, exactly one flash-decode launch an attention
   layer and no other in each decode step (none in xLSTM's), and one
   graph launch in each step after the first.
   The same 128 steps op by op, and both again in f32, must give the same
   greedy tokens and bitwise equal logits at every step.  A further run,
   op by op in bf16 and in f32, repeats every B5 and B6 call of the
   prefill and 8 decode steps through the plain version on the same
   activations (B6 with the normalizer relative to its outputs' scale,
   as in 6b).  The kernel route against the plain route, teacher-forced
   over the prefill's last hidden state and 8 steps' logits with every
   router call recorded: a routing flip (the experts a token picks, as a
   set) is counted, the first flip in a sequence must lie on a near-tie
   of the plain route's probabilities (gap below ``FLIP_GAP``), and the
   outputs of the sequences no flip has reached are gated in f32 at 3e-2
   (bf16 printed).  Printed: the pairs a MoE prefill drops past capacity,
   prefill ms, the steady replayed step against its bounds from the
   bytes a step moves (a MoE step with every expert, as the reference's
   algorithm reads them, and with the experts its router picked; xLSTM's
   f32 recurrent state read and written once), the
   reserved memory after load, and a profiler trace of 3 decode steps, op
   by op and replayed (the device's busy and idle share, the host's CUDA
   API calls a step).  Each model is freed before the next.  6d, between
   6c and 6e, times B5 (its length on the device, the int form beside it)
   at Hymba's served shape, at ``decode_32k``'s (batch 16, 32768 slots)
   and at 6a's served shapes of 6e-6h (6h's on its int8 cache), and B6
   at the served prefill's (one memset and one kernel launch a call) and
   at xLSTM's (the wide form with the normalizer),
   each beside its plain version, its bound and, for B5,
   ``F.scaled_dot_product_attention`` with a length mask (on the int8
   cache: the dequantize into bf16 and SDPA, SDPA alone beside it);
   6j (``train_phase``): SmolLM-360M trained at full width and depth
   (32 layers, d 960, vocab 49152, tied embeddings, ``remat``, bf16 on
   f32 parameters, random weights from seed 0) by ``make_train_step`` on
   ``make_batch_iterator``: 40 steps of 8 x 1024 tokens, AdamW to 1e-3
   after a 10-step warmup, a cosine to step 40.  The train step takes
   the plain routes and launches no counted kernel (gated).  Gated also:
   the memory fits (16 bytes a parameter), finite losses and grad norms,
   the last 5 steps' mean loss below step 1's, every parameter moved by
   step 2, grad_accum=2 against 1 in f32 on one batch (loss and grad
   norm within 1e-4), and a checkpoint of the trained parameters
   restored into a fresh model bitwise, whose prefill and first decode
   step give the trained model's bits.  Printed (line ``train_lm_6j``):
   the median step time of steps 4-40, tok/s, peak memory, the losses
   beside ln V, the bound (6 N T plus the causal attention products at
   the bf16 peak) and the last step's device trace;
   6k (``dryrun_phase``): ``launch/dryrun.py::run_one`` on ``meta``
   tensors with the card's peaks for every config at ``decode_32k`` and
   ``long_500k`` (skipped where the config has no sub-quadratic decode)
   and SmolLM-360M at ``train_4k`` and ``prefill_32k`` (line
   ``dryrun_6k``), then for 6e's decode step and 6j's train step: the
   parameter, compute-copy, cache and AdamW-state bytes counted on
   ``meta`` must equal what those phases held on the card, the traced
   decode step's B5 calls 6e's launches a step, and neither measured
   step may be faster than its roofline bound;
7. print ``{"kernels": [...]}`` with each kernel's numbers (seven rows:
   the five above and B5, B6; B5's launches summed over 6c, 6e-6h and
   B6's over 6c and 6i, each with its times at every shape 6d timed),
   then the ``{"ok": true,
   ...}`` line last.

Tolerances: kernel vs plain version ``|y - r| <= RTOL*|r| + ATOL*max(1, max|r|)``
with ``RTOL, ATOL = 1e-4, 1e-5`` (the reference's bar, its absolute floor
scaled by the output range because f32 reordering error of a K-term sum
follows the size of its partial sums).  Served outputs vs the plain
``torch`` route, 16 chained layers summed in different orders, are held
to ``rtol=1e-3, atol=1e-6`` on the softmax probabilities.  The patch
matrix is a copy and the quantized conv an exact int32 sum followed by
the same two f32 roundings as its plain version, so both are held
bitwise (``torch.equal``); the quantized conv against ``im2col`` +
``qgemm``, whose requant rounds in another order, is held to the
reference's flat bar ``rtol=1e-4, atol=1e-5``.

B5 and B6 in f32 are held to ``rtol = atol = 2e-4``, the reference's bar
for its flash-decode and SSD kernels.  With bf16 operands B5's output
must lie within one bf16 ulp of the plain version computed in f32 (the
ulp taken no finer than at 2^-8 of the largest output: an output that
cancels to near 0 is rounded from terms as large as the others), and B6
within the reference's bf16 bar ``5e-2``.  The served model's kernel
route against its plain route, end to end, is gated at ``rtol = atol =
3e-2`` (the reference's bar for lossy decode paths) in f32.  In bf16 the
same comparison is printed, not gated: a rounding flip in one kernel's
bf16 output grows through 32 random-weight layers past any fixed bar, so
in bf16 the kernels are held at each call on the served activations
instead.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")
RTOL, ATOL = 1e-4, 1e-5
SERVE_RTOL, SERVE_ATOL = 1e-3, 1e-6
N_IMAGES = 32
STEADY_IMAGES = 1024  # per steady window: 256 micro-batches, some seconds
STEADY_REPS = 3
PROFILE_IMAGES = 256  # one steady window traced by torch.profiler: 64 micro-batches
SWAP_IMAGES = 128  # submitted by a thread while swap_plan runs
BATCH = 4
SEED = 0
DEVICE = "cuda"
# the closed loop (phases 5e, 5f): windows of LOOP_IMAGES, at most
# LOOP_WINDOWS after the drift in 5e, LOOP_WINDOWS_II in 5e-ii
LOOP_IMAGES = 256
LOOP_WINDOWS = 8
LOOP_WINDOWS_II = 6
THROTTLE_IMAGES = 128  # submitted by a thread while the governor throttles
# co-serving (phase 5g): the time-sliced baseline's images per model and
# quantum, and the short adaptive run's windows (of LOOP_IMAGES per model)
COSERVE_SLICED_IMAGES = 256
SLICE_QUANTUM = 4
COSERVE_LOOP_WINDOWS = 3
# open-loop load (phase 5h): the server's ingress holds OPEN_LOOP_QUEUE_DEPTH
# micro-batches, and a micro-batch leaves when full or OPEN_LOOP_FLUSH_S after
# its first image (serve()'s default); each Poisson trace has
# OPEN_LOOP_ARRIVALS arrivals, the MMPP traces MMPP_S seconds
OPEN_LOOP_QUEUE_DEPTH = 16
OPEN_LOOP_FLUSH_S = 0.01
OPEN_LOOP_ARRIVALS = 2048
MMPP_S = 3.0
# the fleet (phase 5i): images a model in each window, and the loss/rejoin
# cycles of the seeded victim board
FLEET_IMAGES = 512
FLEET_CYCLES = 3

# Published dense peaks (NVIDIA data sheets, ``repro_torch/roofline/
# analysis.py::PEAKS``, read by ``peaks``): f32 CUDA-core FLOP/s, HBM
# bytes/s, int8 tensor-core op/s and bf16 tensor-core FLOP/s; the SXM part
# unless the card names another.  The quantized conv (B1q) runs on the
# int8 tensor cores, its bound; the CUDA cores' int32 multiply-add rate,
# half the f32 FMA rate (64 INT32 lanes per SM against 128 FP32), is
# printed beside it.  The train step of 6j is bounded by its products at
# the bf16 rate.
KERNELS = {
    "conv2d_fused": {
        "source": "src/repro_torch/kernels/csrc/gemm.cu",
        "replaces": "src/repro/kernels/conv_fused.py:53",
    },
    "matmul_fused": {
        "source": "src/repro_torch/kernels/csrc/gemm.cu",
        "replaces": "src/repro/kernels/conv_fused.py:260",
    },
    "qconv2d_fused": {
        "source": "src/repro_torch/kernels/csrc/conv_fused.cu",
        "replaces": "src/repro/kernels/conv_fused.py:53",
    },
    "gemm": {
        "source": "src/repro_torch/kernels/csrc/gemm.cu",
        "replaces": "src/repro/kernels/gemm.py:31",
    },
    "im2col": {
        "source": "src/repro_torch/kernels/csrc/im2col.cu",
        "replaces": "src/repro/kernels/im2col.py:24",
    },
}
# the transformer slice's kernels, timed by hymba_phases() and counted by lm_phase()
LM_KERNELS = {
    "flash_decode": {
        "source": "src/repro_torch/kernels/csrc/flash_decode.cu",
        "replaces": "src/repro/kernels/flash_decode.py:38",
    },
    "ssd": {
        "source": "src/repro_torch/kernels/csrc/ssd.cu",
        "replaces": "src/repro/kernels/ssd.py:32",
    },
}
NO_LIBRARY = {
    "qconv2d_fused": "no PyTorch call computes an int32 conv on CUDA",
    "ssd": "no PyTorch call computes the SSD chunked scan",
}
# per-layer numbers of 3d that are also summed over the layers
EXTRA_TOTALS = ("whole_call_ms", "quantize_ms", "pack_once_ms", "int32_cuda_core_bound_ms",
                "library_copy_only_ms", "f32_cuda_core_bound_ms")
# csrc/gemm.cu's tensor-core order (gemm.order 1) issues three TF32 term
# products for each f32 one, at the TF32 rate, half the bf16 rate: 989 / 2
# / 3 = 165 TFLOP/s of f32 work on an H100, the bound of B1, B2 and B3 at
# the shapes that take it (the f32 CUDA cores' printed beside it)
TC_SPLIT_PRODUCTS = 3
# Hymba-1.5B served at full width: batch 4, a 768-token prompt (896 with the
# 128 meta tokens), 128 greedy steps, so max_len = 1024 = the window
LM_ARCH, LM_BATCH, LM_PROMPT, LM_GEN = "hymba-1.5b", 4, 768, 128
LM_CHECK_STEPS = 8  # decode steps held against the plain route
# B5's shapes on the dense and MoE paths (B, Hkv, G, D, W): SmolLM-360M
# and OLMoE-1B-7B served as Hymba is (batch 4, 768 + 128 slots, no meta
# tokens), and StarCoder2-15B's decode step on its 4096-slot window ring
LM_FD_SHAPES = (("smollm_served", 4, 5, 3, 64, 896), ("olmoe_served", 4, 16, 1, 128, 896),
                ("starcoder2_decode", 4, 4, 12, 128, 4096))
LM_PROFILE_STEPS = 3  # decode steps traced for the busy/idle split
LM_RTOL = LM_ATOL = 3e-2  # the reference's bar for lossy decode paths
# phases 6e and 6f: the dense and MoE models, served by lm_phase() as 6c serves Hymba
DENSE_LMS = (("6e", "smollm-360m"), ("6f", "olmoe-1b-7b"))
# phases 6g and 6h: the model features, served by lm_phase() in the same way:
# PaliGemma-3B (256 image patches before the prompt, MQA at head_dim 256)
# and MusicGen-large (four codebooks, an int8 KV cache)
FEATURE_LMS = (("6g", "paligemma-3b"), ("6h", "musicgen-large"))
# B5's shapes on the feature models' decode steps (B, Hkv, G, D, W), served
# as the others are (768 prompt tokens + 128 steps, PaliGemma's 256 patches
# before them): PaliGemma's MQA at D = 256, and MusicGen's 32 heads on its
# int8 cache (q in f32 and bf16, the cache int8 with f32 scales)
D256_FD_SHAPES = (("paligemma_served", 4, 1, 8, 256, 1152),)
INT8_FD_SHAPES = (("musicgen_served_int8", 4, 32, 1, 64, 896),)
# a float32 routing flip between the kernel and plain routes (inputs equal
# to about 1e-6) may only sit where the plain route's k-th and (k+1)-th
# router probabilities are closer than this
FLIP_GAP = 1e-3
FD_TOL = 2e-4  # f32 bar of the reference's flash-decode and SSD kernel tests
SSD_BF16_TOL = 5e-2  # the reference's bf16 bar for the SSD kernel
# phase 6i: xLSTM-1.3B (42 mLSTM layers through B6 with its normalizer,
# 6 sLSTM layers), served by lm_phase() as 6c serves Hymba; its mLSTM
# head size d_model / n_heads, B6's N = P at its served prefill
XLSTM_LMS = (("6i", "xlstm-1.3b"),)
XLSTM_DH = 512
ATTN_KINDS = ("dense", "moe", "hymba")  # the layer groups with an attention cache
# A random-weight xLSTM stack is chaotic in f32: its plain route against
# itself, with B6's plain version at chunk 64 instead of 128 (the same
# scan summed in another order), differs by RMS ~0.3 on logits of range
# ~4.5 (25-78x the 3e-2 bar) after a 768-token prompt.  So 6i holds the
# kernel route, teacher-forced in f32, within REORDER_SLACK times that
# reordering's RMS distance from the plain route; every B6 call is held
# to its own bar on the served activations besides
REORDER_CHUNK = 64
REORDER_SLACK = 2.0
# phase 6l: the configs that fit one card only in the serving form (the
# blocks in bf16 alone, 2 bytes a block parameter): StarCoder2-15B (B5 at
# G = 12, two blocks a KV head), DeepSeek-MoE-16B (a dense layer, then MoE
# with shared experts) and Moonlight-16B-A3B (an int8 cache under MoE, a
# 163,840-token vocabulary), each served as 6e serves SmolLM, at full
# width and depth.  Their f32 gates run on the first F32_CUT_LAYERS layers
# in f32 (whole, the f32 weights do not fit): for the MoE configs the dense
# layer and 7 MoE layers
SERVING_FORM_LMS = (("6l", "starcoder2-15b"), ("6l", "deepseek-moe-16b"), ("6l", "moonshot-v1-16b-a3b"))
F32_CUT_LAYERS = 8
# the caching allocator's rounding: a tensor of up to 1 MiB takes a block
# of a multiple of 512 bytes; a larger one a block that may keep up to
# 1 MiB past it unsplit (its segment's tail, or a cached block's)
ALLOC_ROUND, ALLOC_UNSPLIT = 512, 1 << 20
# phase 6j: SmolLM-360M trained at full width and depth (remat, bf16 on
# f32 parameters) through make_train_step on the synthetic token stream:
# TRAIN_STEPS steps of TRAIN_BATCH x TRAIN_SEQ tokens, AdamW to TRAIN_LR
# after TRAIN_WARMUP steps, a cosine to TRAIN_STEPS; steps TRAIN_TIMED_FROM
# on are timed.  grad_accum=2 against 1 on one batch, in f32, is held to
# ACCUM_RTOL: the same sums in another order (two half batches, cuBLAS's
# algorithms for M = 4096 and 8192) through 32 layers
TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = "smollm-360m", 8, 1024, 40
TRAIN_LR, TRAIN_WARMUP, TRAIN_TIMED_FROM = 1e-3, 10, 4
TRAIN_PROMPT = 256  # the trained and the restored model's prefill: 4 x 256 tokens, then one decode step
ACCUM_RTOL = 1e-4


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def peaks(name: str):
    """(f32 FLOP/s, HBM bytes/s, int8 op/s, bf16 FLOP/s) of the card."""
    from repro_torch.roofline.analysis import card_peaks

    p = card_peaks(name)
    return p.f32_flops, p.hbm_bytes_per_s, p.int8_ops, p.bf16_flops


def tol_ok(y, r):
    """(max_abs_err, worst err/tol ratio) under the stated tolerance."""
    diff = (y - r).abs()
    tol = RTOL * r.abs() + ATOL * max(1.0, float(r.abs().max()))
    return float(diff.max()), float((diff / tol).max())


def time_ms(fn, torch):
    """CUDA-event time of one call, averaged over a run of calls sized to
    about 50 ms of work (3 to 50 calls)."""
    fn()
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    fn()
    e.record()
    e.synchronize()
    iters = int(min(50, max(3, 50.0 / max(s.elapsed_time(e), 1e-3))))
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(iters):
        fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / iters


def device_ms(fn, torch, target_ms=20.0):
    """Device time of one call: a run of calls sized to about ``target_ms``
    of device work, enqueued behind a sleep kernel long enough that the
    host has queued them all before the first starts, so the CUDA events
    around them time the device and not the host's launch rate."""
    fn()
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    fn()
    e.record()
    e.synchronize()
    n = int(min(200, max(5, target_ms / max(s.elapsed_time(e), 1e-3))))
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda._sleep(int(2 * host_s * 2.0e9) + 1_000_000)  # >= 2x the host's time at <= 2 GHz
    s.record()
    for _ in range(n):
        fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / n


def cuda_api_call(name: str) -> bool:
    """A profiler key that names a CUDA runtime or driver API call
    (``cudaLaunchKernel``, ``cudaGraphLaunch``, ``cuLaunchKernel``, ...)."""
    return name.startswith("cuda") or (name.startswith("cu") and name[2:3].isupper())


def scaled_ratio(torch, y, r, tol):
    """Worst ``|y - r| / (tol |r| + tol max(1, max|r|))``: a tolerance
    relative to the output's scale, the absolute floor scaled by its range
    as ``tol_ok``'s."""
    y, r = y.float(), r.float()
    return float(((y - r).abs() / (tol * r.abs() + tol * max(1.0, float(r.abs().max())))).max())


def bf16_ulp(torch, r):
    """Spacing of bf16 numbers (8 significant bits) at |r|, taken no finer
    than at 2^-8 of the largest |r|: an output that cancels to near 0 is
    rounded from a sum of terms as large as the others, whose f32 rounding
    error does not shrink with it."""
    _, e = torch.frexp(torch.maximum(r.abs(), r.abs().max() * 2.0 ** -8))
    return torch.ldexp(torch.ones_like(r), e - 8)


def timed_row(torch, bytes_peak, name, where, kern, plain, lib, op_count, op_peak, nbytes, **extra):
    """One kernel's timing line: device time of the kernel, its plain
    version and its library call (None: no call), its host-paced time, and
    its bound from ``op_count`` operations at ``op_peak`` and ``nbytes``
    bytes at ``bytes_peak``."""
    op_ms, byte_ms = op_count / op_peak * 1e3, nbytes / bytes_peak * 1e3
    row = {"shape": where, "kernel": name, "kernel_ms": device_ms(kern, torch),
           "plain_ms": device_ms(plain, torch),
           "library_ms": None if lib is None else device_ms(lib, torch),
           "host_paced_kernel_ms": time_ms(kern, torch),
           "flop_bound_ms": op_ms, "byte_bound_ms": byte_ms, "bound_ms": max(op_ms, byte_ms),
           "bound_by": "operations" if op_ms >= byte_ms else "bytes",
           "timer": "cuda events behind a sleep kernel (device time)", **extra}
    print(json.dumps(row))
    return row


def b6_wide_inputs(torch, randn):
    """6d's inputs of B6's wide form at xLSTM-1.3B's served prefill: one
    mLSTM layer over the 768-token prompt (B 4, H 4, N = P = 512, bf16),
    the input gate e^min(i, 8) in B."""
    import torch.nn.functional as F

    b, s_len, h, p, n = LM_BATCH, LM_PROMPT, 4, XLSTM_DH, XLSTM_DH
    x = randn(b, s_len, h, p, dtype=torch.bfloat16)
    la = F.logsigmoid(2.0 + randn(b, s_len, h)).to(torch.bfloat16)
    B = (randn(b, s_len, h, n) * n ** -0.5 * torch.exp(torch.clamp(randn(b, s_len, h), max=8.0))[..., None]
         ).to(torch.bfloat16)
    C = randn(b, s_len, h, n, dtype=torch.bfloat16)
    return x, la, B, C


def b6_wide_timed(torch, randn, flops_peak, bytes_peak):
    """6d's row of B6 at xLSTM-1.3B's served prefill: the wide form with the
    normalizer, 6 chunks of 128.  ``bound_ms`` is the route's own: the
    multiply-adds the kernel issues to the bf16 tensor cores
    (``wide_tensor_core_macs``: the bf16 scores once, every product with
    an f32 operand as three bf16 terms) at the bf16 rate, or its bytes;
    beside it ``f32_cuda_core_bound_ms``, ssd_cost's operations at the f32
    CUDA-core rate, the bound of every earlier run; and the launch: blocks
    a cluster, clusters resident at once, registers and local memory."""
    from repro_torch.kernels import ops as OPS
    from repro_torch.kernels import ssd as SSD
    from repro_torch.roofline.analysis import ssd_cost

    x, la, B, C = b6_wide_inputs(torch, randn)
    b, s_len, h, p = x.shape
    n, chunk = B.shape[-1], 128
    xl_flops, xl_bytes = ssd_cost(b, s_len, h, n, p, chunk, normalizer=True)
    launch = SSD.wide_launch_info(chunk, p, torch.bfloat16)
    macs = SSD.wide_tensor_core_macs(b, s_len, h, n, p, chunk, launch["cluster_blocks"])
    row = timed_row(
        torch, bytes_peak,
        "ssd", f"xLSTM served prefill: B{b} S{s_len} H{h} P{p} N{n} chunk{chunk} bf16, normalizer (wide form)",
        lambda: OPS.ssd(x, la, B, C, normalizer=True),
        lambda: OPS.ssd(x, la, B, C, normalizer=True, backend="torch"),
        None, 2.0 * macs, peaks(torch.cuda.get_device_name(0))[3], xl_bytes,
        library_null_reason=NO_LIBRARY["ssd"],
        cuda_work_per_call="one memset (ticket counter and flags) and one kernel launch",
        blocks=b * h * (-(-s_len // chunk)) * (p // 64), tensor_core_macs=macs,
        f32_cuda_core_bound_ms=max(xl_flops / flops_peak, xl_bytes / bytes_peak) * 1e3, launch=launch,
    )
    del x, la, B, C
    torch.cuda.empty_cache()
    return row


def b6_wide_cases(torch, randn, err):
    """6b's cases of B6's wide form: xLSTM's mLSTM with the normalizer at
    N = P = 512, chunk 128 (B, S, H, h0 and n0 given): the served
    prefill's shape, a ragged S (padded to 3 chunks) and 6 chunks from a
    given state.  Inputs as the mLSTM makes them, the input gate e^min(i,
    8) with i of spread 2 (B reaches ~3000 k).  Each output held relative
    to its scale (the absolute floor scaled by max|r|, as tol_ok: the
    scan's sums run over 512 and 128 terms as large as the output's range)
    at its own type's bar: y at x's, and den and both states, f32 on bf16
    inputs too, at the f32 bar (the kernel's products are exact, so only
    the order of its f32 sums differs); the elementwise ratio of the Hymba
    cases printed beside it.  Each call is made twice and must give the
    same bits.  Returns (cases, worst err/tol)."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops as OPS

    norm_cases, norm_worst = [], 0.0
    n = p = XLSTM_DH
    for (b, s_len, h, state) in ((LM_BATCH, LM_PROMPT, 4, False), (2, 300, 4, True), (2, LM_PROMPT, 4, True)):
        for dtype in (torch.float32, torch.bfloat16):
            x = randn(b, s_len, h, p, dtype=dtype)
            la = F.logsigmoid(2.0 + randn(b, s_len, h)).to(dtype)
            gate = torch.exp(torch.clamp(randn(b, s_len, h, scale=2.0), max=8.0))
            B = (randn(b, s_len, h, n) * n ** -0.5 * gate[..., None]).to(dtype)
            C = randn(b, s_len, h, n, dtype=dtype)
            h0 = randn(b, h, n, p, scale=0.3) if state else None
            n0 = randn(b, h, n).abs() if state else None
            got = OPS.ssd(x, la, B, C, h0=h0, n0=n0, normalizer=True)
            again = OPS.ssd(x, la, B, C, h0=h0, n0=n0, normalizer=True)
            want = OPS.ssd(x, la, B, C, h0=h0, n0=n0, normalizer=True, backend="torch")
            tols = [FD_TOL if g.dtype == torch.float32 else SSD_BF16_TOL for g in got]
            ratios = [scaled_ratio(torch, g, w, tol) for g, w, tol in zip(got, want, tols)]
            elementwise = [float(((g.float() - w.float()).abs() / (tol + tol * w.float().abs())).max())
                           for g, w, tol in zip(got, want, tols)]
            err["ssd"] = max([err["ssd"]] + [float((g.float() - w.float()).abs().max()) for g, w in zip(got, want)])
            norm_cases.append({"B": b, "S": s_len, "H": h, "P": p, "N": n, "chunk": 128, "h0_n0": state,
                               "dtype": str(dtype).split(".")[-1],
                               "err_over_tol": dict(zip(("y", "h_final", "den", "n_final"), ratios)),
                               "elementwise_err_over_tol": dict(zip(("y", "h_final", "den", "n_final"), elementwise)),
                               "max_abs_out": [float(w.float().abs().max()) for w in want],
                               "finite": all(bool(torch.isfinite(g).all()) for g in got),
                               "repeat_bitwise": all(torch.equal(g, a) for g, a in zip(got, again))})
            norm_worst = max([norm_worst] + ratios)
            del x, la, gate, B, C, h0, n0, got, again, want
    return norm_cases, norm_worst


def hymba_phases(torch, dev, flops_peak, bytes_peak):
    """Phases 6a-6d: B5 and B6 against their plain versions, Hymba-1.5B
    served at full width through them (``lm_phase``), and their timing.
    Returns the kernels-line rows of both kernels."""
    import torch.nn.functional as F

    from repro_torch.configs import SHAPES, get_config
    from repro_torch.kernels import flash_decode as FD
    from repro_torch.kernels import ops as OPS
    from repro_torch.models.blocks import _quantize_kv
    from repro_torch.models.model import N_META_TOKENS
    from repro_torch.roofline.analysis import flash_decode_cost, ssd_cost

    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    err = {"flash_decode": 0.0, "ssd": 0.0}

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, device=dev, generator=gen) * scale).to(dtype)

    # ---------------------------- 6a. B5 against its plain version
    # valid prefixes of 1, a ragged one and all slots, each side of the
    # first split boundary, and a 32768-slot cache with most splits empty;
    # a row at batch 1 and a repeated call must give the same bits
    fd_cases, fd_int8_cases, fd_worst = 0, 0, {"float32": (0.0, ""), "bfloat16": (0.0, "")}
    fd_not_bitwise = []
    # (label, B, Hkv, G, D, W, lengths, int8 cache): the grid at batch 4
    # with 5 KV heads, then the served shapes of 6e and 6f and StarCoder2's
    # decode shape on a 4096-slot window ring that has wrapped (every slot
    # valid, length W: a device length past W clamps to it), then 6g's at
    # D = 256 and 6h's on its int8 cache
    fd_shapes = []
    for g in (1, 5):
        for d in (64, 128):
            for s_len in (1, 300, 1024, 32768):
                split = FD.split_len(s_len, d)
                lengths = {1, 777} if s_len == 32768 else {
                    1, (2 * s_len) // 3 + 1, s_len, split - 1, split, split + 1}
                fd_shapes.append(("grid", 4, 5, g, d, s_len, lengths, False))
    for label, b, hkv, g, d, w in LM_FD_SHAPES + D256_FD_SHAPES + INT8_FD_SHAPES:
        split = FD.split_len(w, d)
        wrapped = label == "starcoder2_decode"
        # the served steps' lengths: the first (after the prompt and
        # PaliGemma's patches), each side of the first split, the last
        served = LM_PROMPT + (256 if label == "paligemma_served" else 0) + 1
        fd_shapes.append((label, b, hkv, g, d, w, {w} if wrapped else {1, served, split - 1, split, split + 1, w},
                          (label, b, hkv, g, d, w) in INT8_FD_SHAPES))
    fd_int8_not_dequant_bitwise = []
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for label, b, hkv, g, d, s_len, lengths, quant in fd_shapes:
            split = FD.split_len(s_len, d)
            for length in sorted(n for n in lengths if 1 <= n <= s_len):
                q = randn(b, hkv, g, d, scale=0.5, dtype=dtype)
                k = randn(b, s_len, hkv, d, scale=0.5, dtype=dtype)
                v = randn(b, s_len, hkv, d, dtype=dtype)
                sc, kd, vd = {}, k, v
                if quant:  # int8 with its scales, and the cache dequantized into q's type
                    (k, ks), (v, vs) = _quantize_kv(k), _quantize_kv(v)
                    sc = {"k_scale": ks, "v_scale": vs}
                    kd, vd = FD.dequantize(k, ks, dtype), FD.dequantize(v, vs, dtype)
                y = OPS.flash_decode(q, k, v, length, **sc)
                where = (f"{label} B{b} Hkv{hkv} G{g} D{d} S{s_len} split{split} len{length} {dname}"
                         + (" int8 cache" if quant else ""))
                r1 = b // 2
                sc1 = {key: t[r1:r1 + 1].contiguous() for key, t in sc.items()}
                y1 = OPS.flash_decode(q[r1:r1 + 1].contiguous(), k[r1:r1 + 1].contiguous(),
                                      v[r1:r1 + 1].contiguous(), length, **sc1)
                if not (torch.equal(y1, y[r1:r1 + 1]) and torch.equal(OPS.flash_decode(q, k, v, length, **sc), y)):
                    fd_not_bitwise.append(where)
                # the length read on the device, as a captured decode
                # step passes it: the int form's bits at batch B and 1
                dev_len = torch.tensor([length], dtype=torch.int32, device=dev)
                if not (torch.equal(OPS.flash_decode(q, k, v, dev_len, **sc), y) and torch.equal(
                        OPS.flash_decode(q[r1:r1 + 1].contiguous(), k[r1:r1 + 1].contiguous(),
                                         v[r1:r1 + 1].contiguous(), dev_len, **sc1), y1)):
                    fd_not_bitwise.append(f"{where} device length")
                # an int8 cache is dequantized as it is read, in the plain
                # version's arithmetic: the kernel's bits on the dequantized cache
                if quant and not torch.equal(OPS.flash_decode(q, kd, vd, length), y):
                    fd_int8_not_dequant_bitwise.append(where)
                if dtype == torch.float32:
                    r = OPS.flash_decode(q, k, v, length, **sc, backend="torch")
                    ratio = float(((y - r).abs() / (FD_TOL + FD_TOL * r.abs())).max())
                else:
                    r = OPS.flash_decode(q.float(), kd.float(), vd.float(), length, backend="torch")
                    ratio = float(((y.float() - r).abs() / bf16_ulp(torch, r)).max())
                err["flash_decode"] = max(err["flash_decode"], float((y.float() - r).abs().max()))
                check(bool(torch.isfinite(y).all()), f"flash_decode non-finite at {where}")
                if ratio >= fd_worst[dname][0]:
                    fd_worst[dname] = (ratio, where)
                fd_cases += 1
                fd_int8_cases += quant
            # a device length past W is clamped to W, as the reference's
            # position mask would take every slot (a wrapped ring's position)
            past = torch.tensor([s_len + 5], dtype=torch.int32, device=dev)
            if not torch.equal(OPS.flash_decode(q, k, v, past, **sc), OPS.flash_decode(q, k, v, s_len, **sc)):
                fd_not_bitwise.append(f"{label} G{g} D{d} S{s_len} {dname} device length past W")
            del q, k, v, kd, vd, y, y1, r, sc, sc1

    # ---------------------------- 6b. B6 against its plain version
    ssd_cases, ssd_worst = [], 0.0
    # (B, S, H, P, N, chunk, nonzero h0, head-stride-0 B/C): Hymba's heads
    for (b, s_len, h, p, n, chunk, h0_on, shared) in (
        (2, 896, 50, 64, 16, 64, False, True), (2, 896, 50, 64, 16, 64, True, True),
        (2, 512, 50, 64, 16, 128, True, False),
    ):
        for dtype in (torch.float32, torch.bfloat16):
            x = randn(b, s_len, h, p, dtype=dtype)
            la = (-randn(b, s_len, h).abs() * 0.3).to(dtype)
            if shared:
                B = randn(b, s_len, 1, n, scale=0.4, dtype=dtype).expand(b, s_len, h, n)
                C = randn(b, s_len, 1, n, scale=0.4, dtype=dtype).expand(b, s_len, h, n)
            else:
                B, C = randn(b, s_len, h, n, scale=0.4, dtype=dtype), randn(b, s_len, h, n, scale=0.4, dtype=dtype)
            h0 = randn(b, h, n, p) if h0_on else None
            y, hf = OPS.ssd(x, la, B, C, h0=h0, chunk=chunk)
            ry, rh = OPS.ssd(x, la, B, C, h0=h0, chunk=chunk, backend="torch")
            tol = FD_TOL if dtype == torch.float32 else SSD_BF16_TOL
            ratio = max(float(((y.float() - ry.float()).abs() / (tol + tol * ry.float().abs())).max()),
                        float(((hf - rh).abs() / (tol + tol * rh.abs())).max()))
            err["ssd"] = max(err["ssd"], float((y.float() - ry.float()).abs().max()), float((hf - rh).abs().max()))
            ssd_cases.append({"B": b, "S": s_len, "H": h, "P": p, "N": n, "chunk": chunk, "h0": h0_on,
                              "head_stride_0": shared, "dtype": str(dtype).split(".")[-1],
                              "err_over_tol": ratio, "finite": bool(torch.isfinite(y).all())})
            ssd_worst = max(ssd_worst, ratio)
    norm_cases, norm_worst = b6_wide_cases(torch, randn, err)
    torch.cuda.synchronize()
    print(json.dumps({"correctness_lm_kernels": {
        "flash_decode": {"cases": fd_cases, "worst_err_over_tol": {k: v[0] for k, v in fd_worst.items()},
                         "worst_at": {k: v[1] for k, v in fd_worst.items()},
                         "device_length_cases": fd_cases, "int8_cache_cases": fd_int8_cases,
                         "batch1_repeat_or_device_length_not_bitwise": fd_not_bitwise,
                         "int8_not_bitwise_equal_dequantized": fd_int8_not_dequant_bitwise,
                         "tolerance": {"float32": f"|y-r| <= {FD_TOL} + {FD_TOL}*|r|",
                                       "bfloat16": "|y - r_f32| <= 1 bf16 ulp of r_f32 (no finer than at 2^-8 max|r_f32|)"}},
        "ssd": {"cases": ssd_cases, "tolerance": {"float32": f"rtol=atol={FD_TOL}",
                                                  "bfloat16": f"rtol=atol={SSD_BF16_TOL}"}},
        "ssd_normalizer": {"cases": norm_cases, "tolerance": {
            "float32": f"|y-r| <= {FD_TOL}*|r| + {FD_TOL}*max(1, max|r|)",
            "bfloat16": f"y: |y-r| <= {SSD_BF16_TOL}*|r| + {SSD_BF16_TOL}*max(1, max|r|); den, h_final, "
                        f"n_final (f32): the float32 bar"}},
    }}))
    for dname, (ratio, where) in fd_worst.items():
        check(ratio <= 1.0, f"flash_decode exceeds its {dname} bar at {where} (err/tol {ratio:.3g})")
    check(not fd_not_bitwise, f"flash_decode rows differ at batch 1, between calls or with a device length "
                              f"at {fd_not_bitwise[:3]}")
    check(fd_int8_cases > 0 and not fd_int8_not_dequant_bitwise,
          f"flash_decode on an int8 cache differs from itself on the dequantized cache at "
          f"{fd_int8_not_dequant_bitwise[:3]}")
    check(all(c["finite"] for c in ssd_cases), "ssd output is not finite")
    check(ssd_worst <= 1.0, f"ssd exceeds its bar (err/tol {ssd_worst:.3g})")
    check(all(c["finite"] for c in norm_cases), "ssd with the normalizer: an output is not finite")
    check(all(c["repeat_bitwise"] for c in norm_cases), "ssd with the normalizer: a second call differs")
    check(norm_worst <= 1.0, f"ssd with the normalizer exceeds its bar (err/tol {norm_worst:.3g})")

    # ----------------- 6c. Hymba-1.5B served at full width through B5, B6
    lm = lm_phase(torch, dev, "6c", LM_ARCH, bytes_peak)
    launches = lm["launches"]
    for name in LM_KERNELS:
        err[name] = max(err[name], lm["max_abs_err"][name])
    cfg = get_config(LM_ARCH)

    # ---------------------------- 6d. timing of B5 and B6
    rows = {}

    def timed(name, where, kern, plain, lib, op_count, op_peak, nbytes, **extra):
        return timed_row(torch, bytes_peak, name, where, kern, plain, lib, op_count, op_peak, nbytes, **extra)

    hkv, g, d = cfg.n_kv_heads, cfg.q_per_kv, cfg.resolved_head_dim
    n32k = SHAPES["decode_32k"].seq_len
    # (label, B, Hkv, G, D, W, length, int8 cache)
    fd_timed = [("served", LM_BATCH, hkv, g, d, lm["max_len"], lm["max_len"], False),
                ("decode_32k", 16, hkv, g, d, n32k, n32k, False)]
    fd_timed += [(label, b_, hkv_, g_, d_, w_, w_, False) for label, b_, hkv_, g_, d_, w_ in LM_FD_SHAPES]
    fd_timed += [(label, b_, hkv_, g_, d_, w_, w_, False) for label, b_, hkv_, g_, d_, w_ in D256_FD_SHAPES]
    fd_timed += [(label, b_, hkv_, g_, d_, w_, w_, True) for label, b_, hkv_, g_, d_, w_ in INT8_FD_SHAPES]
    for label, b, hkv, g, d, w, length, quant in fd_timed:
        q = randn(b, hkv, g, d, scale=0.5, dtype=torch.bfloat16)
        k = randn(b, w, hkv, d, scale=0.5, dtype=torch.bfloat16)
        v = randn(b, w, hkv, d, dtype=torch.bfloat16)
        sc, extra = {}, {}
        if quant:  # int8 values and an f32 scale a (slot, head); the library dequantizes first
            (k, ks), (v, vs) = _quantize_kv(k), _quantize_kv(v)
            sc = {"k_scale": ks, "v_scale": vs}
            extra = {"library": "FD.dequantize of K and V into bf16, then F.scaled_dot_product_attention",
                     "library_sdpa_alone_ms": None}
        kt = lambda: (FD.dequantize(k, ks, torch.bfloat16) if quant else k).transpose(1, 2)  # [B, Hkv, W, D]
        vt = lambda: (FD.dequantize(v, vs, torch.bfloat16) if quant else v).transpose(1, 2)
        q4 = q.reshape(b, hkv * g, 1, d)
        mask = (torch.arange(w, device=dev) < length)[None, None, None, :]
        # the length on the device, as the captured decode step passes it;
        # the int form's time beside it
        dev_len = torch.tensor([length], dtype=torch.int32, device=dev)
        y = OPS.flash_decode(q, k, v, dev_len, **sc)
        check(torch.equal(y, OPS.flash_decode(q, k, v, length, **sc)), f"flash_decode {label}: device length not bitwise")
        lib = lambda: F.scaled_dot_product_attention(q4, kt(), vt(), attn_mask=mask, enable_gqa=True)
        fd_flops, fd_bytes = flash_decode_cost(b, hkv, g, d, length, quant=quant)  # bf16 q, K and V
        lib_err = float((lib().reshape(q.shape).float() - y.float()).abs().max())
        if quant:
            kd, vd = kt(), vt()
            extra["library_sdpa_alone_ms"] = device_ms(
                lambda: F.scaled_dot_product_attention(q4, kd, vd, attn_mask=mask, enable_gqa=True), torch)
            del kd, vd
        rows[label] = timed(
            "flash_decode", f"{label}: B{b} Hkv{hkv} G{g} D{d} W{w} len{length} bf16"
            + (" q, int8 K/V with f32 scales" if quant else "") + ", length on the device",
            lambda: OPS.flash_decode(q, k, v, dev_len, **sc),
            lambda: OPS.flash_decode(q, k, v, length, **sc, backend="torch"),
            lib, fd_flops, flops_peak, fd_bytes,
            library_max_abs_diff=lib_err,
            int_length_kernel_ms=device_ms(lambda: OPS.flash_decode(q, k, v, length, **sc), torch),
            **extra,
        )
        del q, k, v, y, sc

    # B6 at the served prefill shape: Hymba's mamba heads over 896 tokens
    s_len, h, p, n, chunk = LM_PROMPT + N_META_TOKENS, cfg.d_inner // 64, 64, cfg.ssm_state, cfg.ssd_chunk
    b = LM_BATCH
    x = randn(b, s_len, h, p, dtype=torch.bfloat16)
    la = (-randn(b, s_len, h).abs() * 0.3).to(torch.bfloat16)
    B = randn(b, s_len, 1, n, scale=0.4, dtype=torch.bfloat16).expand(b, s_len, h, n)
    C = randn(b, s_len, 1, n, scale=0.4, dtype=torch.bfloat16).expand(b, s_len, h, n)
    n_chunks = b * h * (-(-s_len // chunk))
    # the causal half of the Q x Q products and the two N x P terms, per chunk;
    # B and C read once for all heads (a head stride of 0)
    ssd_flops, ssd_bytes = ssd_cost(b, s_len, h, n, p, chunk, bc_heads=1)
    rows["ssd"] = timed(
        "ssd", f"served prefill: B{b} S{s_len} H{h} P{p} N{n} chunk{chunk} bf16, B/C head stride 0",
        lambda: OPS.ssd(x, la, B, C, chunk=chunk),
        lambda: OPS.ssd(x, la, B, C, chunk=chunk, backend="torch"),
        None, ssd_flops, flops_peak, ssd_bytes,
        dense_form_flop_bound_ms=2.0 * n_chunks * (chunk * chunk * n + chunk * chunk * p + 2 * chunk * n * p)
        / flops_peak * 1e3,
        library_null_reason=NO_LIBRARY["ssd"],
        cuda_work_per_call="one memset (ticket counter and flags) and one kernel launch",
    )
    del x, la, B, C
    rows["ssd_xlstm"] = b6_wide_timed(torch, randn, flops_peak, bytes_peak)
    torch.cuda.empty_cache()

    kernels = []
    for name, meta in LM_KERNELS.items():
        row = rows["served"] if name == "flash_decode" else rows["ssd"]
        kernels.append({
            "name": name, "route": "cuda", "source": meta["source"], "replaces": meta["replaces"],
            "launches": launches[name], "max_abs_err": err[name], "ms": row["kernel_ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
        })
    # B5's row: Hymba's served shape, and beside it every other shape timed
    kernels[0]["shapes"] = {
        label: {key: row[key] for key in ("shape", "kernel_ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
        for label, row in rows.items() if label not in ("ssd", "ssd_xlstm")}
    kernels[0]["launches_by_path"] = {"6c hymba-1.5b": launches["flash_decode"]}
    # B6's row: Hymba's served shape, and beside it xLSTM's (phase 6i adds its launches)
    kernels[1]["shapes"] = {
        label: {key: rows[label][key] for key in ("shape", "kernel_ms", "plain_ms", "bound_ms", "bound_by",
                                                  "library_ms", "f32_cuda_core_bound_ms", "launch")
                if key in rows[label]}
        for label in ("ssd", "ssd_xlstm")}
    kernels[1]["launches_by_path"] = {"6c hymba-1.5b": launches["ssd"]}
    return kernels


def route_flips(torch, kern_calls, plain_calls, n_moe, batch):
    """Routing flips between two runs' router calls (the experts each
    token picks, compared as sets, with the plain run's gap between its
    k-th and (k+1)-th probability).  Call ``c`` belongs to output ``c //
    n_moe`` (0: the prefill's last hidden state, 1 + i: decode step i).  A
    flip is primary when it lies in the first call that differs in its
    sequence (its inputs are the same in both runs); the later ones follow
    from it.  Returns ({sequence: first output a flip reaches}, flips)."""
    reached, flips = {}, []
    for call, ((ik, _), (ip, gp)) in enumerate(zip(kern_calls, plain_calls)):
        out_i, tokens = call // n_moe, ik.shape[0] // batch
        differ = (ik.sort(-1).values != ip.sort(-1).values).any(-1)
        first_call = {}
        for t in differ.nonzero().flatten().tolist():
            row = t // tokens
            primary = row not in reached or first_call.get(row) == call
            if row not in reached:
                reached[row], first_call[row] = out_i, call
            flips.append({"output": out_i, "layer": call % n_moe, "row": row, "token": t % tokens,
                          "gap": float(gp[t]), "primary": primary})
    return reached, flips


def profile_decode(torch, step, model, caches, tok, pos0):
    """Device busy time of LM_PROFILE_STEPS decode steps after two warm
    ones (the profiler, kernels summed), the kernels and host CUDA API
    calls a step, and the six largest device times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for i in range(2):
        step(model, caches, tok, pos0 + i)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(LM_PROFILE_STEPS):
            step(model, caches, tok, pos0 + 2 + i)
        torch.cuda.synchronize()
    events = prof.key_averages()
    dev_events = [e for e in events if e.device_type == DeviceType.CUDA]
    api = [e for e in events if e.device_type == DeviceType.CPU and cuda_api_call(e.key)]
    top = sorted(dev_events, key=lambda e: -e.self_device_time_total)[:6]
    return {
        "device_busy_ms_per_step": sum(e.self_device_time_total for e in dev_events) / 1e3 / LM_PROFILE_STEPS
        if dev_events else None,
        "device_kernels_per_step": sum(e.count for e in dev_events) / LM_PROFILE_STEPS,
        "host_api_calls_per_step": sum(e.count for e in api) / LM_PROFILE_STEPS,
        "graph_launches_per_step": sum(e.count for e in api if e.key == "cudaGraphLaunch") / LM_PROFILE_STEPS,
        "top_device_ms_per_step": {e.key[:80]: e.self_device_time_total / 1e3 / LM_PROFILE_STEPS for e in top},
    }


def lm_inputs(torch, cfg, dev):
    """The served batch of ``lm_phase``, drawn from a generator seeded with
    SEED: a prompt [LM_BATCH, LM_PROMPT] of token ids ([..., K] with K
    codebooks) and, with a vision prefix, the stubbed vision tower's
    features [LM_BATCH, n_patches, 1152] (else None)."""
    from repro_torch.models.model import SIGLIP_DIM

    g = torch.Generator(device=dev).manual_seed(SEED)
    books = (cfg.n_codebooks,) if cfg.n_codebooks else ()
    prompt = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT) + books, device=dev, generator=g)
    patches = torch.randn((LM_BATCH, cfg.n_patches, SIGLIP_DIM), device=dev, generator=g) \
        if cfg.n_patches else None
    return prompt, patches


def lm_phase(torch, dev, phase, arch, bytes_peak, serving_form=False, f32_layers=None, tie_serving_form=False):
    """Phases 6c (Hymba-1.5B), 6e (SmolLM-360M), 6f (OLMoE-1B-7B), 6g
    (PaliGemma-3B), 6h (MusicGen-large), 6i (xLSTM-1.3B) and 6l
    (StarCoder2-15B, DeepSeek-MoE-16B, Moonlight-16B-A3B): one model at
    full width and depth, random weights from seed 0, bf16 on f32 weights
    (with ``serving_form``, the blocks held in bf16 only, as the CLI holds
    them), served through ``generate``, the CLI's own loop: batch 4, a
    768-token prompt (of four codebooks for MusicGen; after Hymba's 128
    meta tokens or PaliGemma's 256 image patches, ``lm_inputs``), 128
    greedy steps, the first op by op and the rest replaying one captured
    step.  Gated: the weights fit (the serving form: the bytes counted on
    ``meta`` are what the load allocates, up to the allocator's rounding,
    and the init holds at most one f32 block above them); the prefill
    launches one B6 a Hymba or mLSTM layer and no other counted kernel;
    each decode step exactly one B5 launch an attention layer and nothing
    else, one graph launch in each replayed step; the same steps op by
    op, in bf16 and f32, give the same tokens and bitwise-equal logits;
    every B5 and B6 call of the prefill and LM_CHECK_STEPS op-by-op decode
    steps, in bf16 and f32, against its plain version on the same
    activations (B5: one bf16 ulp, FD_TOL in f32, and on an int8 cache
    bitwise equal to B5 on the dequantized cache; B6: SSD_BF16_TOL, FD_TOL
    in f32, with the normalizer relative to the outputs' scale), and those
    runs' logits equal to the served ones; the kernel route against the
    plain route, teacher-forced, within LM_RTOL in f32 on the sequences no
    routing flip has reached, and every primary flip on a near-tie (gap
    below FLIP_GAP); bf16 printed.  The f32 gates need f32 blocks: with
    ``f32_layers`` they run, after the served model is freed, on a model
    of the config's first ``f32_layers`` layers in f32 (its own served
    run giving the stream it is teacher-forced on).  With
    ``tie_serving_form`` the serving form of the same weights serves the
    same prompt too: tokens, prefill state and logits bitwise equal to the
    two-copy run's, its load's bytes as counted on ``meta``.  Printed
    beside them: the pairs a MoE prefill drops past capacity, the prefill
    and step times, the steady step against its bounds (``decode_bound``),
    the reserved memory after load and a profiler trace of
    LM_PROFILE_STEPS steps, op by op and replayed.  The models are freed.
    Returns {"launches": {kernel: served-run count}, "max_abs_err":
    {kernel: against its plain version}, "max_len": slots, "held_bytes"
    (the serving form's with ``tie_serving_form``), ...}."""
    import dataclasses
    import gc

    import repro_torch.models.moe as MOE
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_decode as FD
    from repro_torch.kernels import ops as OPS
    from repro_torch.kernels import runtime
    from repro_torch.kernels import ssd as SSD
    from repro_torch.launch.serve import generate
    from repro_torch.launch.steps import make_eager_serve_step, make_prefill_step, make_serve_step
    from repro_torch.models import abstract_params, init_cache, init_params, layer_groups, prefix_tokens
    from repro_torch.roofline.analysis import storage_bytes

    t_phase = time.perf_counter()
    cfg = get_config(arch)
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32",
                                **({"n_layers": f32_layers} if f32_layers else {}))
    n_layers, offset = cfg.n_layers, LM_PROMPT + prefix_tokens(cfg)

    def layer_counts(c):
        """(MoE layers, B6 in each prefill layer, B5 in each decode layer)."""
        gs = layer_groups(c)
        return (sum(g.n for g in gs if g.kind == "moe"), sum(g.n for g in gs if g.kind in ("hymba", "mlstm")),
                sum(g.n for g in gs if g.kind in ATTN_KINDS))

    groups = layer_groups(cfg)
    n_moe, n_ssd, n_fd = layer_counts(cfg)
    recurrent = any(g.kind in ("mlstm", "slstm") for g in groups)

    def param_bytes(m):
        return sum(p.numel() * p.element_size() for p in m.parameters())

    def rounding(tensors):
        """The most the allocator may add to these tensors' bytes."""
        return sum(ALLOC_ROUND if t.numel() * t.element_size() <= ALLOC_UNSPLIT else ALLOC_UNSPLIT
                   for t in tensors)

    def load(c, serving):
        """The model of ``c`` on the card, after a check that it fits:
        (model, bytes counted on meta, bytes the load allocated, the
        load's peak above what it started from, seconds)."""
        gc.collect()
        torch.cuda.empty_cache()  # what earlier phases left cached counts as free
        counted = param_bytes(abstract_params(c, serving=serving))
        need = counted if serving else counted + 2 * sum(
            p.numel() for p in abstract_params(c).groups.parameters())  # the bf16 copy beside the f32 blocks
        free_b, _ = torch.cuda.mem_get_info(dev)
        check(need < 0.9 * free_b, f"{phase}: {c.name} needs {need / 1e9:.1f} GB, {free_b / 1e9:.1f} GB free")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        before = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        m = init_params(c, seed=SEED, device=dev, serving=serving)
        m.compute_blocks(getattr(torch, c.compute_dtype))
        torch.cuda.synchronize()
        return (m, counted, torch.cuda.memory_allocated(dev) - before,
                torch.cuda.max_memory_allocated(dev) - before, time.perf_counter() - t0)

    # the served model: the f32 parameters and the blocks' bf16 copy, or
    # the serving form (each block drawn in f32, cast, then freed)
    shape = abstract_params(cfg)
    n_params = sum(p.numel() for p in shape.parameters())
    block_params = sum(p.numel() for grp in shape.groups for p in grp.parameters())
    largest_f32_block = max(4 * sum(p.numel() for p in blk.parameters()) for grp in shape.groups for blk in grp)
    block_slack = max(rounding(p.float() for p in blk.parameters()) for grp in shape.groups for blk in grp)
    slack = rounding(abstract_params(cfg, serving=serving_form).parameters())
    del shape
    model, counted_b, model_b, init_peak_b, init_s = load(cfg, serving_form)
    need_gb = (counted_b if serving_form else 4 * n_params + 2 * block_params) / 1e9
    model_gb = model_b / 1e9  # the weights (and their bf16 copy)
    reserved_gb = torch.cuda.memory_reserved(dev) / 1e9  # the allocator's whole pool, earlier phases' cache included
    prompt, patches = lm_inputs(torch, cfg, dev)
    for graphs in (True, False):  # warm-up: cuBLAS handles, first launches, a capture
        generate(cfg, model, prompt[:, :64], 3, graphs=graphs, patches=patches)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    per_step = []

    def hook(ph, i):
        per_step.append((ph, runtime.launch_counts(), runtime.graph_launches()))
        runtime.reset_launches()

    # the served run: the first decode step op by op, then one captured
    # step replayed (launch/steps.py::GraphedServeStep); each replay counts
    # the launches its capture recorded, and one graph launch; the counts
    # are set to 0 just before and read after each step
    runtime.reset_launches()
    out = generate(cfg, model, prompt, LM_GEN, keep_logits=LM_GEN, step_hook=hook, patches=patches)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    ph0, prefill_counts, prefill_graphs = per_step[0]
    check(ph0 == "prefill" and prefill_graphs == 0
          and all(n == (n_ssd if k == "ssd" else 0) for k, n in prefill_counts.items()),
          f"{phase}: prefill launched {prefill_counts} and {prefill_graphs} graphs, "
          f"want {n_ssd} ssd and nothing else")
    decode_counts = [c for _, c, _ in per_step[1:]]
    decode_graphs = [n for _, _, n in per_step[1:]]
    check(len(decode_counts) == LM_GEN, f"{phase}: {len(decode_counts)} decode steps, want {LM_GEN}")
    for i, c in enumerate(decode_counts):
        check(all(n == (n_fd if k == "flash_decode" else 0) for k, n in c.items()),
              f"{phase}: decode step {i} launched {c}, want {n_fd} flash_decode and nothing else")
    check(decode_graphs == [0] + [1] * (LM_GEN - 1),
          f"{phase}: graph launches per decode step {decode_graphs[:4]}..., want 0 (the eager first step), then 1")
    tokens = out["tokens"]
    check(tuple(tokens.shape) == (LM_BATCH, LM_GEN) + tuple(prompt.shape[2:])
          and bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()),
          f"{phase}: generated tokens of shape {tuple(tokens.shape)} or out of range")
    check(all(bool(torch.isfinite(lg).all()) for lg in out["logits"]), f"{phase}: served logits are not finite")
    check(bool(torch.isfinite(out["last_hidden"]).all()), f"{phase}: prefill hidden state is not finite")
    if serving_form:
        check(0 <= model_b - counted_b <= slack,
              f"{phase}: the serving form allocated {model_b} bytes, {counted_b} counted on meta "
              f"(the allocator may add {slack})")
        check(init_peak_b <= counted_b + largest_f32_block + slack + block_slack,
              f"{phase}: the init's peak {init_peak_b} bytes lies above the model's {counted_b} and one f32 block "
              f"({largest_f32_block})")

    # the serving form of the same weights, serving the same prompt: the
    # same bits as the two-copy run (6e), and what phase 6k holds against
    tie, held_from = None, (model, out)
    if tie_serving_form:
        sv, sv_counted, sv_b, sv_peak, _ = load(cfg, True)
        generate(cfg, sv, prompt[:, :64], 3, patches=patches)  # warm-up: its own capture
        sv_out = generate(cfg, sv, prompt, LM_GEN, keep_logits=LM_GEN, patches=patches)
        tie = {"tokens_equal": bool(torch.equal(sv_out["tokens"], tokens)),
               "last_hidden_bitwise": bool(torch.equal(sv_out["last_hidden"], out["last_hidden"])),
               "kept_logits_bitwise": len(sv_out["logits"]) == LM_GEN
               and all(torch.equal(a, b) for a, b in zip(sv_out["logits"], out["logits"])),
               "bytes_counted_on_meta": sv_counted, "bytes_allocated": sv_b, "init_peak_above_start": sv_peak,
               "two_copy_bytes_allocated": model_b,
               "steady_ms_per_step": sv_out["steady_ms_per_step"], "prefill_ms": sv_out["prefill_ms"]}
        held_from = (sv, sv_out)
        check(tie["tokens_equal"] and tie["last_hidden_bitwise"] and tie["kept_logits_bitwise"],
              f"{phase}: the serving form's run differs from the two-copy run's: {tie}")
        sv_slack = rounding(abstract_params(cfg, serving=True).parameters())
        tie["allocator_rounding_at_most"] = sv_slack
        check(0 <= sv_b - sv_counted <= sv_slack,
              f"{phase}: the serving form allocated {sv_b} bytes, {sv_counted} counted on meta "
              f"(the allocator may add {sv_slack})")
    # what the card holds, for phase 6k's dry run of the same decode step
    params_on_card = storage_bytes(list(held_from[0].parameters()))
    held_bytes = {"params": sum(params_on_card.values()),
                  "compute_copy": sum(nb for key, nb in storage_bytes(held_from[0]).items()
                                      if key not in params_on_card),
                  "caches": sum(storage_bytes(held_from[1]["caches"]).values())}
    held_steady_ms = held_from[1]["steady_ms_per_step"]
    del held_from
    if tie is not None:
        del sv, sv_out

    orig_router = MOE.router

    def eager_vs_graph_row(c, m, graph_out, record=None):
        """The served steps op by op: the same greedy tokens, and every
        kept logit bitwise equal (the captured kernels and cuBLAS calls are
        the eager step's, in the same order).  With ``record`` (a list) the
        eager run records the experts each router call picks: the served
        run's routing, since its tokens and logits are the same."""
        if record is not None:
            def recording(x, w, k, renorm=True):
                res = orig_router(x, w, k, renorm=renorm)
                record.append(res[1])
                return res

            MOE.router = recording
        try:
            e = generate(c, m, prompt, LM_GEN, keep_logits=LM_GEN, graphs=False, patches=patches)
        finally:
            MOE.router = orig_router
        return {
            "tokens_equal": bool(torch.equal(e["tokens"], graph_out["tokens"])),
            "kept_logits_bitwise": len(e["logits"]) == len(graph_out["logits"]) == LM_GEN
            and all(torch.equal(a, b) for a, b in zip(e["logits"], graph_out["logits"])),
            **{mode: {"prefill_ms": r["prefill_ms"], "decode_ms": r["decode_ms"],
                      "decode_ms_per_step": r["decode_ms"] / LM_GEN, "decode_tok_per_s": r["decode_tok_per_s"],
                      "steady_ms_per_step": r["steady_ms_per_step"],
                      "steady_tok_per_s": LM_BATCH / (r["steady_ms_per_step"] / 1e3)}
               for mode, r in (("eager", e), ("graph", graph_out))},
        }

    # kernel parity on the served activations: every B5 and B6 call of a
    # prefill and LM_CHECK_STEPS op-by-op decode steps, in bf16 and f32,
    # repeated through the plain version on the same inputs
    served = {(name, dname): [0, 0.0, 0.0] for name in LM_KERNELS  # calls, worst ratio, max abs
              for dname in ("bfloat16", "float32")}
    want_calls, int8_not_bitwise = {}, []
    orig_fd, orig_ssd = OPS.flash_decode, OPS.ssd

    def record(name, dtype, ratio, d):
        rec = served[(name, str(dtype).split(".")[-1])]
        rec[0] += 1
        rec[1] = max(rec[1], ratio)
        rec[2] = max(rec[2], float(d.max()))

    def fd_checked(q, k, v, length, k_scale=None, v_scale=None, backend=None):
        y = orig_fd(q, k, v, length, k_scale=k_scale, v_scale=v_scale, backend=backend)
        if k_scale is not None:  # an int8 cache, in q's type as the plain version takes it
            k, v = FD.dequantize(k, k_scale, q.dtype), FD.dequantize(v, v_scale, q.dtype)
            if not torch.equal(orig_fd(q, k, v, length, backend=backend), y):  # B5 dequantizes as it reads
                int8_not_bitwise.append(str(q.dtype))
        r = orig_fd(q.float(), k.float(), v.float(), length, backend="torch")
        d = (y.float() - r).abs()
        tol = bf16_ulp(torch, r) if q.dtype == torch.bfloat16 else FD_TOL + FD_TOL * r.abs()
        record("flash_decode", q.dtype, float((d / tol).max()), d)
        return y

    def ssd_checked(x, log_a, B, C, h0=None, chunk=128, backend=None, normalizer=False, n0=None):
        got = orig_ssd(x, log_a, B, C, h0=h0, chunk=chunk, backend=backend, normalizer=normalizer, n0=n0)
        want = orig_ssd(x, log_a, B, C, h0=h0, chunk=chunk, backend="torch", normalizer=normalizer, n0=n0)
        tol = SSD_BF16_TOL if x.dtype == torch.bfloat16 else FD_TOL
        d = torch.stack([(g.float() - w.float()).abs().max() for g, w in zip(got, want)])
        if normalizer:  # the mLSTM's wide form: y, h_final, den, n_final, relative to their scale (6b)
            ratio = max(scaled_ratio(torch, g, w, tol) for g, w in zip(got, want))
        else:
            (y, hf), (ry, rh) = got, want
            ratio = max(float(((y.float() - ry.float()).abs() / (tol + tol * ry.float().abs())).max()),
                        float(((hf - rh).abs() / (tol + tol * rh.abs())).max()))
        record("ssd", x.dtype, ratio, d)
        return got

    def kernel_parity(c, m, served_logits):
        """Every B5 and B6 call of an op-by-op run of ``c`` held to its
        plain version; True when that run's logits equal the served ones
        (the checks read device values on the host, which no capture may)."""
        _, c_ssd, c_fd = layer_counts(c)
        want_calls[("flash_decode", c.compute_dtype)] = c_fd * LM_CHECK_STEPS
        want_calls[("ssd", c.compute_dtype)] = c_ssd
        OPS.flash_decode, OPS.ssd = fd_checked, ssd_checked
        try:
            checked = generate(c, m, prompt, LM_CHECK_STEPS, keep_logits=LM_CHECK_STEPS, graphs=False,
                               patches=patches)
        finally:
            OPS.flash_decode, OPS.ssd = orig_fd, orig_ssd
        return all(torch.equal(a, b) for a, b in zip(checked["logits"], served_logits))

    def forced(c, m, stream, max_len, backend):
        """Teacher-forced on ``stream``: the prefill's last hidden state
        and LM_CHECK_STEPS decode steps' logits, every router call
        recorded with its gap."""
        calls = []

        def rec(x, w, k, renorm=True):
            res = orig_router(x, w, k, renorm=renorm)
            p = torch.softmax(x.float() @ w.float(), dim=-1).sort(dim=-1, descending=True).values
            calls.append((res[1], p[:, k - 1] - p[:, k]))
            return res

        MOE.router = rec
        try:
            caches = init_cache(c, LM_BATCH, max_len, device=dev)
            batch = {"tokens": prompt} if patches is None else {"tokens": prompt, "patches": patches}
            outs = [make_prefill_step(c, backend)(m, batch, caches).float()]
            step = make_eager_serve_step(c, backend)
            tok = prompt[:, -1:]
            for i in range(LM_CHECK_STEPS):
                outs.append(step(m, caches, tok, offset + i))
                tok = stream[:, i:i + 1]
        finally:
            MOE.router = orig_router
        return outs, calls

    def teacher_forced(c, m, stream, max_len):
        """End to end on ``stream``: the kernel route against the plain
        route, the rows no routing flip has reached (and, for a recurrent
        stack in f32, the plain route reordered as the yardstick)."""
        c_moe = layer_counts(c)[0]
        kern, kcalls = forced(c, m, stream, max_len, None)
        plain, pcalls = forced(c, m, stream, max_len, "torch")
        yardstick = None
        if c.compute_dtype == "float32" and recurrent:
            # the yardstick of a recurrent stack: the plain route against
            # itself with B6's plain version at a chunk of REORDER_CHUNK,
            # the same scan summed in another order
            orig_ref = SSD.ssd_ref

            def reordered_ref(*args, chunk=128, **kw):
                return orig_ref(*args, chunk=min(chunk, REORDER_CHUNK), **kw)

            SSD.ssd_ref = reordered_ref
            try:
                reordered, _ = forced(c, m, stream, max_len, "torch")
            finally:
                SSD.ssd_ref = orig_ref

            def rms_apart(outs, ref):
                return float(torch.cat([(o - r).flatten() for o, r in zip(outs, ref)]).pow(2).mean().sqrt())

            yardstick = {"kernel_vs_plain_rms": rms_apart(kern, plain),
                         "plain_reordered_vs_plain_rms": rms_apart(reordered, plain),
                         "plain_reordered_worst_err_over_tol": max(
                             float(((a - b).abs() / (LM_ATOL + LM_RTOL * b.abs())).max())
                             for a, b in zip(reordered, plain)),
                         "reorder_chunk": REORDER_CHUNK, "slack": REORDER_SLACK}
            del reordered
        check(len(kcalls) == len(pcalls) == c_moe * (1 + LM_CHECK_STEPS),
              f"{phase}: {len(kcalls)} and {len(pcalls)} router calls, want {c_moe * (1 + LM_CHECK_STEPS)}")
        reached, flips = route_flips(torch, kcalls, pcalls, max(c_moe, 1), LM_BATCH)
        worst, mx, gated = 0.0, 0.0, 0
        for out_i, (x, r) in enumerate(zip(kern, plain)):
            rows = [b for b in range(LM_BATCH) if reached.get(b, out_i + 1) > out_i]
            if not rows:
                continue
            gated += len(rows)
            d = (x[rows] - r[rows]).abs()
            worst = max(worst, float((d / (LM_ATOL + LM_RTOL * r[rows].abs())).max()))
            mx = max(mx, float(d.max()))
        primary = [f for f in flips if f["primary"]]
        row = {"layers": c.n_layers, "worst_err_over_tol": worst, "max_abs_err": mx, "rows_gated": gated,
               "rows_compared": LM_BATCH * (1 + LM_CHECK_STEPS)}
        if c_moe:
            # pairs past capacity in each MoE layer of the prefill (the kernel route's routing)
            cap = MOE.capacity(LM_BATCH * LM_PROMPT * c.top_k, c.n_experts, c.capacity_factor)
            row.update({"router_flips": len(flips), "primary_flips": primary[:16],
                        "max_primary_gap": max((f["gap"] for f in primary), default=None),
                        "sequences_reached": {str(k): v for k, v in sorted(reached.items())},
                        "prefill_capacity": cap, "prefill_pairs": LM_BATCH * LM_PROMPT * c.top_k,
                        "prefill_pairs_dropped_per_layer": [
                            int((torch.bincount(idx.flatten(), minlength=c.n_experts) - cap).clamp(min=0).sum())
                            for idx, _ in kcalls[:c_moe]]})
        if yardstick is not None:
            row["recurrent_yardstick"] = yardstick
        return row

    def f32_gates(c, m, graph_out):
        """The f32 runs of ``c`` on ``m``: graph = op by op, the kernels on
        the served activations, the kernel route against the plain one."""
        row = eager_vs_graph_row(c, m, graph_out)
        repeat = kernel_parity(c, m, graph_out["logits"])
        return row, repeat, teacher_forced(c, m, graph_out["tokens"], graph_out["max_len"])

    # bf16 on the served model: the served run op by op, the kernels on its
    # activations, the kernel route against the plain route (printed)
    picked = []
    eager_vs_graph = {"bfloat16": eager_vs_graph_row(cfg, model, out, record=picked)}
    repeatable = {"bfloat16": kernel_parity(cfg, model, out["logits"])}
    e2e = {"bfloat16": teacher_forced(cfg, model, tokens, out["max_len"])}
    if not f32_layers:  # f32 on the same weights
        f32_out = generate(cfg32, model, prompt, LM_GEN, keep_logits=LM_GEN, patches=patches)
        eager_vs_graph["float32"], repeatable["float32"], e2e["float32"] = f32_gates(cfg32, model, f32_out)
        del f32_out

    # where an xLSTM prefill's time goes: one more op-by-op prefill with
    # each mLSTM and sLSTM cell timed by CUDA events around it (a sync a
    # cell), beside the whole prefill's time
    prefill_split = None
    if recurrent:
        import repro_torch.models.blocks as BLK

        spent = {"mlstm": [], "slstm": []}
        cells = {"mlstm": BLK.mlstm_mix, "slstm": BLK.slstm_mix}

        def timed_cell(kind):
            def run(*args, **kw):
                s_ev, e_ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                s_ev.record()
                res = cells[kind](*args, **kw)
                e_ev.record()
                e_ev.synchronize()
                spent[kind].append(s_ev.elapsed_time(e_ev))
                return res
            return run

        BLK.mlstm_mix, BLK.slstm_mix = timed_cell("mlstm"), timed_cell("slstm")
        try:
            caches = init_cache(cfg, LM_BATCH, out["max_len"], device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            make_prefill_step(cfg)(model, {"tokens": prompt}, caches)
            torch.cuda.synchronize()
            split_ms = (time.perf_counter() - t0) * 1e3
        finally:
            BLK.mlstm_mix, BLK.slstm_mix = cells["mlstm"], cells["slstm"]
        del caches
        prefill_split = {
            "prefill_ms_host_clock": split_ms,
            **{f"{kind}_cells": len(v) for kind, v in spent.items()},
            **{f"{kind}_ms": sum(v) for kind, v in spent.items()},
            **{f"{kind}_share": sum(v) / split_ms for kind, v in spent.items()},
            "timer": "CUDA events around each cell (a sync a cell), the host clock around the prefill"}

    # where a decode step's time goes, op by op and replayed: device busy
    # time of a few steps (profiler, kernels summed) against the served
    # runs' step times, and the host's CUDA API calls a step
    breakdown = {}
    for mode, step in (("eager", make_eager_serve_step(cfg)), ("graph", make_serve_step(cfg))):
        # eager: two warm steps; graph: the eager step and capture, one replay
        prof = profile_decode(torch, step, model, out["caches"], tokens[:, -1:], out["max_len"])
        busy_ms = prof["device_busy_ms_per_step"]
        run = eager_vs_graph["bfloat16"][mode]
        step_ms, steady_ms = run["decode_ms_per_step"], run["steady_ms_per_step"]
        breakdown[mode] = {
            "served_step_ms": step_ms, "served_steady_step_ms": steady_ms, **prof,
            "device_idle_share": (1.0 - busy_ms / step_ms) if busy_ms else None,
            "device_idle_share_steady": (1.0 - busy_ms / steady_ms) if busy_ms else None,
            "graph_device_ms": graph_device_ms(torch, step.graph) if mode == "graph" else None,
        }
        del step

    # the least time a steady decode step could take, from the bytes it
    # must move, averaged over the steady steps (the third on): every
    # non-expert block parameter read once in bf16, the f32 head(s) and
    # final norm, each attention layer's valid cache prefix (its window's
    # at most; an int8 cache's values at a byte each and its f32 scales)
    # read and one slot written; Hymba's SSM and conv states are left
    # out.  A MoE step reads, in the reference's algorithm, every expert
    # (all-experts bound), and needs only the experts its router picked
    # (routed bound: counted per layer from the bf16 eager run's routing)
    head = model.heads if cfg.n_codebooks else model.embed if cfg.tie_embeddings else model.lm_head
    # K and V of one slot: bf16, or int8 values and one f32 scale a head
    slot_bytes = 2 * LM_BATCH * cfg.n_kv_heads * (
        cfg.resolved_head_dim + 4 if cfg.kv_quant else 2 * cfg.resolved_head_dim)
    expert_params = 0
    if n_moe:
        check(len(picked) == n_moe * (1 + LM_GEN), f"{phase}: {len(picked)} router calls in the eager run")
        moe = next(blk.moe for grp in model.groups for blk in grp if getattr(blk, "moe", None) is not None)
        expert_params = sum(t.numel() for t in (moe.w1, moe.w2, moe.w3) if t is not None) // cfg.n_experts
        sel = torch.stack(picked[n_moe:]).view(LM_GEN, n_moe, -1)  # the decode steps' picks
        hit = torch.zeros(LM_GEN, n_moe, cfg.n_experts, device=dev).scatter_(2, sel, 1.0)
        experts_read = hit.sum((1, 2)).tolist()  # distinct experts a step, over its MoE layers
    else:
        experts_read = [0.0] * LM_GEN
    fixed = 2 * (block_params - n_moe * cfg.n_experts * expert_params) \
        + 4 * (head.numel() + model.final_norm.scale.numel())
    steady = range(2, LM_GEN)
    kv = [sum(g.n * slot_bytes * ((min(offset + i + 1, g.window) if g.window else offset + i + 1) + 1)
              for g in groups if g.kind in ATTN_KINDS) for i in steady]
    # xLSTM's recurrent state, f32, read and written once a step: each
    # mLSTM layer's h [B, H, dh, dh] and n [B, H, dh], each sLSTM layer's
    # c, n, h, m [B, H, dh] (Hymba's SSM and conv states stay left out)
    dh = cfg.resolved_head_dim
    state_bytes = 2 * 4 * LM_BATCH * cfg.n_heads * sum(
        g.n * (dh * dh + dh if g.kind == "mlstm" else 4 * dh) for g in groups if g.kind in ("mlstm", "slstm"))
    kv = [b + state_bytes for b in kv]
    all_ms = sum(fixed + 2 * n_moe * cfg.n_experts * expert_params + b for b in kv) / len(kv) / bytes_peak * 1e3
    routed_ms = sum(fixed + 2 * expert_params * experts_read[i] + b
                    for i, b in zip(steady, kv)) / len(kv) / bytes_peak * 1e3
    steady_ms = out["steady_ms_per_step"]
    del head, picked

    # the f32 gates on the first f32_layers layers in f32, once the served
    # model is freed: its own served run is the stream it is forced on
    f32_gate = None
    if f32_layers:
        del model, out
        gc.collect()
        torch.cuda.empty_cache()
        m32, _, m32_b, _, _ = load(cfg32, False)
        g32 = generate(cfg32, m32, prompt, LM_GEN, keep_logits=LM_GEN, patches=patches)
        eager_vs_graph["float32"], repeatable["float32"], e2e["float32"] = f32_gates(cfg32, m32, g32)
        f32_gate = {"layers": f32_layers, "of": n_layers, "groups": [(g.kind, g.n) for g in layer_groups(cfg32)],
                    "model_allocated_gb": m32_b / 1e9, "sample_tokens": g32["tokens"][0, :8].tolist()}
        del m32, g32
    else:
        del model, out
    report = {
        "phase": phase, "model": arch, "params": n_params, "block_params": block_params,
        "n_layers": n_layers, "moe_layers": n_moe, "ssd_layers": n_ssd, "attention_layers": n_fd,
        "experts": cfg.n_experts,
        "top_k": cfg.top_k, "batch": LM_BATCH, "prompt": LM_PROMPT, "prefix_tokens": prefix_tokens(cfg),
        "n_patches": cfg.n_patches, "n_codebooks": cfg.n_codebooks, "kv_quant": cfg.kv_quant,
        "head_dim": cfg.resolved_head_dim, "kv_heads": cfg.n_kv_heads, "q_per_kv": cfg.q_per_kv,
        "gen": LM_GEN, "max_len": offset + LM_GEN, "compute_dtype": cfg.compute_dtype,
        "serving_form": serving_form, "init_and_cast_s": init_s,
        "memory_needed_gb": need_gb, "model_allocated_gb": model_gb, "bytes_counted_on_meta": counted_b,
        "bytes_allocated_at_load": model_b, "init_peak_above_start_bytes": init_peak_b,
        "largest_f32_block_bytes": largest_f32_block, "allocator_rounding_at_most": slack,
        "reserved_gb_after_load": reserved_gb,
        "peak_memory_gb": peak_gb,
        "prefill_ms": eager_vs_graph["bfloat16"]["graph"]["prefill_ms"],
        "decode_ms_per_step": eager_vs_graph["bfloat16"]["graph"]["decode_ms_per_step"],
        "steady_ms_per_step": steady_ms, "steady_tok_per_s": LM_BATCH / (steady_ms / 1e3),
        "decode_tok_per_s": eager_vs_graph["bfloat16"]["graph"]["decode_tok_per_s"], "timer": "cuda_events",
        "decode_bound": {
            "all_experts_ms": all_ms, "routed_experts_ms": routed_ms,
            "steady_over_all_experts_bound": steady_ms / all_ms,
            "steady_over_routed_bound": steady_ms / routed_ms,
            "experts_read_per_moe_layer": sum(experts_read[i] for i in steady) / len(kv) / max(n_moe, 1),
            "recurrent_state_bytes": state_bytes,
            "counts": "bf16 block weights (every expert, or the routed ones), f32 head(s) and final norm, "
                      "each attention layer's valid KV prefix read and one slot written (an int8 cache at "
                      "a byte a value plus its f32 scales), xLSTM's f32 recurrent state read and written "
                      "once; mean over steps 3 on",
        },
        "decode_step_breakdown": {
            "steps_profiled": LM_PROFILE_STEPS, **breakdown,
            "source": "torch.profiler over steps after the served run; step times from the served bf16 runs "
                      "(decode_ms / steps, and steady: steps 3 on)"},
        "launches": {"prefill": prefill_counts, "per_decode_step": decode_counts[0],
                     "graph_launches_per_decode_step": {"first": decode_graphs[0], "later": decode_graphs[1]}},
        "eager_vs_graph": eager_vs_graph,
        "serving_form_vs_two_copy": tie,
        "f32_gate_depth_cut": f32_gate,
        "prefill_split": prefill_split,
        "kernel_parity_on_served_activations": {
            f"{name} {dname}": {"calls": v[0], "worst_err_over_tol": v[1], "max_abs_err": v[2]}
            for (name, dname), v in served.items() if v[0]},
        "int8_cache_calls_not_bitwise_to_dequantized": int8_not_bitwise,
        "checked_runs_bitwise_equal_served_logits": repeatable,
        "teacher_forced_vs_plain_route": {
            **e2e, "compared": f"prefill last hidden state + logits of {LM_CHECK_STEPS} decode steps, "
                               "on the sequences no routing flip has reached",
            "tolerance": f"rtol={LM_RTOL}, atol={LM_ATOL}; gated in float32; primary flips' gap < {FLIP_GAP}"},
        "sample_tokens": tokens[0, :8].tolist(),
        "phase_s": time.perf_counter() - t_phase,
    }
    print(json.dumps({f"serve_lm_{phase}": report}))
    for dname, row in eager_vs_graph.items():
        check(row["tokens_equal"], f"{phase} {dname}: greedy tokens with graphs differ from the eager run's")
        check(row["kept_logits_bitwise"], f"{phase} {dname}: kept logits with graphs differ from the eager run's")
    for (name, dname), (calls, ratio, _) in served.items():
        check(calls == want_calls[(name, dname)],
              f"{phase} {dname}: {name} parity saw {calls} calls, want {want_calls[(name, dname)]}")
        check(ratio <= 1.0, f"{phase} {dname}: {name} on served activations exceeds its bar ({ratio:.3g})")
    check(not int8_not_bitwise, f"{phase}: B5 on the int8 cache differs from B5 on the dequantized cache "
                                f"({len(int8_not_bitwise)} calls)")
    check(all(repeatable.values()), f"{phase}: the checked op-by-op runs' logits differ from the served runs' "
                                    f"{repeatable}")
    f32 = e2e["float32"]
    if recurrent:  # as close to the plain route as the plain route reordered is
        ys = f32["recurrent_yardstick"]
        check(ys["kernel_vs_plain_rms"] <= REORDER_SLACK * ys["plain_reordered_vs_plain_rms"],
              f"{phase}: float32 kernel route lies farther from the plain route ({ys['kernel_vs_plain_rms']:.3g} "
              f"RMS) than {REORDER_SLACK} x the plain route reordered ({ys['plain_reordered_vs_plain_rms']:.3g})")
    else:
        check(f32["worst_err_over_tol"] <= 1.0, f"{phase}: float32 kernel route differs from the plain route "
                                                f"(err/tol {f32['worst_err_over_tol']:.3g})")
    check(f32["rows_gated"] * 2 >= f32["rows_compared"], f"{phase}: routing flips left too few rows to compare")
    check(f32.get("max_primary_gap") is None or f32["max_primary_gap"] < FLIP_GAP,
          f"{phase}: a float32 routing flip off a near-tie: {f32.get('primary_flips', [])[:3]}")
    result = {"launches": {"flash_decode": sum(c["flash_decode"] for c in decode_counts),
                           "ssd": prefill_counts["ssd"]},
              "max_abs_err": {name: max(served[(name, d)][2] for d in ("bfloat16", "float32"))
                              for name in LM_KERNELS},
              "max_len": offset + LM_GEN, "held_bytes": held_bytes,
              "flash_decode_per_step": decode_counts[1]["flash_decode"],
              "steady_ms_per_step": held_steady_ms, "peak_memory_gb": peak_gb,
              "phase_s": report["phase_s"]}
    del prompt, patches, tokens
    gc.collect()
    torch.cuda.empty_cache()
    return result


def train_step_profile(prof, wall_s):
    """A train step traced by the profiler (device activity only, which
    keeps the trace's processing short): the device's busy time, its
    kernels, and the ten largest device times by kernel name.  The
    profiler slows the traced step's host side, so its wall time is not
    the step's; the busy time is."""
    from torch.autograd import DeviceType

    dev_events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    top = sorted(dev_events, key=lambda e: -e.self_device_time_total)[:10]
    busy = device_busy(prof, wall_s)
    families = {}
    for e in dev_events:
        name = e.key.lower()
        if any(k in name for k in ("gemm", "xmma", "cutlass", "nvjet")):  # cuBLAS's kernels
            fam = "f32 GEMM (CUDA cores)" if "f32f32" in name or "sgemm" in name else "tensor-core GEMM"
        elif "elementwise" in name:
            fam = "elementwise"
        elif "reduce" in name:
            fam = "reductions"
        else:
            fam = "other"
        families[fam] = families.get(fam, 0.0) + e.self_device_time_total / 1e3
    return {
        "traced_wall_ms": wall_s * 1e3,
        "device_busy_ms": None if busy["device_busy_s"] is None else busy["device_busy_s"] * 1e3,
        "device_kernels": sum(e.count for e in dev_events),
        "device_ms_by_family": families,
        "top_device_ms": {e.key[:90]: e.self_device_time_total / 1e3 for e in top},
    }


def train_phase(torch, dev, bf16_peak):
    """Phase 6j: SmolLM-360M at full width and depth (32 layers, d 960,
    vocab 49152, tied embeddings, ``remat``), random weights from SEED,
    bf16 compute on f32 parameters, trained by ``make_train_step`` on
    ``make_batch_iterator`` (seed 0): TRAIN_STEPS steps of TRAIN_BATCH x
    TRAIN_SEQ tokens.  Gated: parameters, gradients and both moments (16
    bytes a parameter) fit before loading; every loss and grad norm
    finite; the mean loss of the last 5 steps below step 1's; every
    parameter moved from its initial value by step 2 (step 1 runs at lr
    0, the warmup's first step); no counted kernel launched during the
    steps; on one batch, in f32, grad_accum=2 against 1 within ACCUM_RTOL
    in loss and grad norm; the trained parameters saved with
    ``save_checkpoint`` and restored into a fresh model bitwise equal,
    and that model's prefill and first decode step give the trained
    model's hidden state and logits bitwise.  Printed: the median step
    time of steps TRAIN_TIMED_FROM on (each step synchronised), tok/s,
    the peak memory, the losses at steps 1, 10, 20, 30 and 40 beside ln
    V, the step's bound (6 N T plus the causal attention products of the
    32 layers, forward and backward, at the bf16 peak), the last step's
    device trace (``train_step_profile``) and the phase's seconds by
    part."""
    import dataclasses
    import gc
    import math
    import shutil
    import statistics
    import tempfile

    from repro_torch.checkpoint import restore, save_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.data import make_batch_iterator
    from repro_torch.kernels import runtime
    from repro_torch.launch.steps import loss_and_grads, make_train_step
    from repro_torch.models import (abstract_params, init_cache, init_params, params_from_numpy,
                                    params_to_numpy, prefill, serve_step)
    from repro_torch.optim import adamw_init, adamw_update, clip_by_global_norm
    from repro_torch.roofline.analysis import storage_bytes
    from torch.profiler import ProfilerActivity, profile

    t_phase = time.perf_counter()
    cfg = get_config(TRAIN_ARCH)
    check(cfg.remat and cfg.tie_embeddings and cfg.compute_dtype == "bfloat16",
          f"6j: {TRAIN_ARCH} is not the remat, tied, bf16 config")
    n_params = sum(p.numel() for p in abstract_params(cfg).parameters())
    need_gb = 16 * n_params / 1e9  # f32 parameters, gradients, m and v
    free_b, _ = torch.cuda.mem_get_info(dev)
    check(need_gb < 0.9 * free_b / 1e9, f"6j: {TRAIN_ARCH} training needs {need_gb:.1f} GB, "
                                        f"{free_b / 1e9:.1f} GB free")
    split = {}
    t0 = time.perf_counter()
    base_gb = torch.cuda.memory_allocated(dev) / 1e9  # what earlier phases still hold
    model = init_params(cfg, seed=SEED, device=dev)
    named = dict(model.named_parameters())
    opt = adamw_init(named)
    initial = {k: p.detach().clone() for k, p in named.items()}
    step_fn = make_train_step(cfg, base_lr=TRAIN_LR, warmup=TRAIN_WARMUP, total=TRAIN_STEPS)
    stream = make_batch_iterator(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0, device=dev, prefetch=2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    split["init_s"] = time.perf_counter() - t0
    losses, gnorms, lrs, step_s = [], [], [], []
    moved = None
    runtime.reset_launches()
    t_steps = time.perf_counter()
    for i in range(1, TRAIN_STEPS + 1):
        batch = next(stream)
        t0 = time.perf_counter()
        if i == TRAIN_STEPS:  # the last step traced (its time stays in the median's set)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                model, opt, metrics = step_fn(model, opt, batch)
                torch.cuda.synchronize()
        else:
            model, opt, metrics = step_fn(model, opt, batch)
            torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
        gnorms.append(float(metrics["grad_norm"]))
        lrs.append(float(metrics["lr"]))
        if i == 2:
            moved = {k: float((p.detach() != initial[k]).float().mean()) for k, p in named.items()}
            del initial
    counts = runtime.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    held = {"params": sum(storage_bytes(list(model.parameters())).values()),
            "optimizer": sum(storage_bytes(opt).values())}  # for phase 6k's dry run
    stream.close()
    split["steps_s"] = time.perf_counter() - t_steps
    t0 = time.perf_counter()
    traced = train_step_profile(prof, step_s[-1])
    del prof
    split["profile_s"] = time.perf_counter() - t0
    check(all(math.isfinite(x) for x in losses + gnorms), f"6j: a loss or grad norm is not finite: "
                                                           f"{losses} {gnorms}")
    tail = sum(losses[-5:]) / 5
    check(tail < losses[0], f"6j: the last 5 steps' mean loss {tail:.4f} is not below step 1's {losses[0]:.4f}")
    still = sorted(k for k, f in moved.items() if f == 0.0)
    check(not still, f"6j: parameters unmoved after step 2: {still[:5]}")
    check(all(n == 0 for n in counts.values()), f"6j: the train steps launched counted kernels: {counts}")

    # grad_accum=2 against 1 on one batch, in f32 (the model is not changed)
    t0 = time.perf_counter()
    batch = next(make_batch_iterator(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=1, device=dev, prefetch=0))
    accum = {}
    for n in (1, 2):
        c = dataclasses.replace(cfg, compute_dtype="float32", grad_accum=n)
        loss, _, grads = loss_and_grads(c, model, batch)
        accum[n] = (float(loss), float(clip_by_global_norm(grads, 1.0)[1]))
        del grads
    accum_err = {"loss": abs(accum[2][0] - accum[1][0]) / abs(accum[1][0]),
                 "grad_norm": abs(accum[2][1] - accum[1][1]) / abs(accum[1][1])}
    check(max(accum_err.values()) <= ACCUM_RTOL, f"6j: grad_accum=2 against 1 in f32: {accum_err}, "
                                                 f"bar {ACCUM_RTOL}")
    split["accum_s"] = time.perf_counter() - t0

    # the step's two parts apart, once each, synchronised (the model is not changed)
    batch = next(make_batch_iterator(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=2, device=dev, prefetch=0))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, _, grads = loss_and_grads(cfg, model, batch)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    adamw_update(named, grads, opt, TRAIN_LR)
    torch.cuda.synchronize()
    parts_ms = {"loss_and_grads": (t1 - t0) * 1e3, "adamw_update": (time.perf_counter() - t1) * 1e3}
    del grads

    # the trained parameters through a checkpoint into a fresh model
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        t0 = time.perf_counter()
        tree = {"params": params_to_numpy(cfg, model)}
        path = save_checkpoint(tmp, TRAIN_STEPS, tree, metadata={"arch": cfg.name, "loss": losses[-1]})
        ckpt_bytes = sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))
        fresh = params_from_numpy(cfg, restore(tmp, tree)["params"], device=dev)
        ckpt_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del tree
    same_params = all(torch.equal(p, q) for p, q in zip(model.parameters(), fresh.parameters()))
    check(same_params, "6j: the restored parameters differ from the trained ones")
    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(SEED)
    prompt = torch.randint(0, cfg.vocab_size, (4, TRAIN_PROMPT + 1), device=dev, generator=g)
    served = []
    for m in (model, fresh):
        caches = init_cache(cfg, 4, TRAIN_PROMPT + 1, device=dev)
        h = prefill(cfg, m, {"tokens": prompt[:, :TRAIN_PROMPT]}, caches)
        served.append((h, serve_step(cfg, m, caches, prompt[:, TRAIN_PROMPT:], TRAIN_PROMPT)))
    torch.cuda.synchronize()
    check(torch.equal(served[0][0], served[1][0]) and torch.equal(served[0][1], served[1][1]),
          "6j: the restored model's prefill or decode step differs from the trained model's")
    split["serve_check_s"] = time.perf_counter() - t0

    timed = sorted(step_s[TRAIN_TIMED_FROM - 1:])
    median_s = statistics.median(timed)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    h, dh = cfg.n_heads, cfg.resolved_head_dim
    dense_flop = 6 * n_params * tokens
    # causal QK^T and PV: 2 products x 2 B H S^2 dh / 2 forward, x 3 with the backward
    attn_flop = cfg.n_layers * 3 * 2 * TRAIN_BATCH * h * TRAIN_SEQ ** 2 * dh
    bound_ms = (dense_flop + attn_flop) / bf16_peak * 1e3
    report = {
        "phase": "6j", "model": TRAIN_ARCH, "params": n_params, "n_layers": cfg.n_layers,
        "d_model": cfg.d_model, "vocab": cfg.vocab_size, "remat": cfg.remat, "batch": TRAIN_BATCH,
        "seq": TRAIN_SEQ, "steps": TRAIN_STEPS, "base_lr": TRAIN_LR, "warmup": TRAIN_WARMUP,
        "memory_needed_gb": need_gb, "peak_memory_gb": peak_gb, "allocated_before_phase_gb": base_gb,
        "held_bytes": held,
        "step_ms_median": median_s * 1e3, "step_ms_min": timed[0] * 1e3, "step_ms_max": timed[-1] * 1e3,
        "timed_steps": f"{TRAIN_TIMED_FROM}-{TRAIN_STEPS}, each ended by torch.cuda.synchronize()",
        "first_step_ms": step_s[0] * 1e3, "tok_per_s": tokens / median_s,
        "bound": {"flop": dense_flop + attn_flop, "dense_6NT_flop": dense_flop, "attention_flop": attn_flop,
                  "bf16_peak_flop_per_s": bf16_peak, "bound_ms": bound_ms,
                  "median_over_bound": median_s * 1e3 / bound_ms},
        "losses": {str(i): losses[i - 1] for i in (1, 10, 20, 30, 40) if i <= TRAIN_STEPS},
        "ln_vocab": math.log(cfg.vocab_size), "last5_mean_loss": tail,
        "grad_norms": {str(i): gnorms[i - 1] for i in (1, 10, 20, 30, 40) if i <= TRAIN_STEPS},
        "lrs": {str(i): lrs[i - 1] for i in (1, 2, 10, 11, 40) if i <= TRAIN_STEPS},
        "moved_after_step_2": {"params": len(moved), "unmoved": len(still),
                               "least_moved_fraction": min(moved.values())},
        "launches_during_steps": counts, "step_parts_ms": parts_ms, "step_40_traced": traced,
        "accum_f32": {"loss": {"1": accum[1][0], "2": accum[2][0]},
                      "grad_norm": {"1": accum[1][1], "2": accum[2][1]}, "rel_err": accum_err,
                      "bar": ACCUM_RTOL},
        "checkpoint": {"bytes": ckpt_bytes, "save_and_restore_s": ckpt_s, "params_bitwise": same_params,
                       "prefill_and_step_bitwise": True},
        "phase_split_s": split, "phase_s": time.perf_counter() - t_phase,
    }
    print(json.dumps({"train_lm_6j": report}))
    del model, fresh, opt, named, served, caches, batch
    gc.collect()
    torch.cuda.empty_cache()
    return report


def dryrun_phase(torch, kind, lm_6e, train_6j):
    """Phase 6k: the dry run (``launch/dryrun.py::run_one``) on ``meta``
    tensors with the detected card's peaks, for every arch at
    ``decode_32k`` and ``long_500k`` (skipped exactly where the config has
    no sub-quadratic decode, as in the reference) and SmolLM-360M at
    ``train_4k`` and ``prefill_32k`` (line ``dryrun_6k``), then held
    against two runs of the card: 6e's SmolLM-360M decode step from the
    serving form (batch 4, the cache ``lm_phase`` allocated; the dry run
    traces the serving form too) and 6j's train step (8 x 1024, remat,
    bf16 on f32).  Gated: every record ``ok`` or ``skipped`` where it
    should be; the parameter, compute-copy (0), cache and AdamW-state
    bytes counted on ``meta`` equal those the phases held on the card; the
    B5 calls of the traced decode step equal 6e's launches a step; neither
    measured step is faster than its roofline bound, ``max(compute_s,
    memory_s)``.  Printed beside them: the predicted peak against 6j's
    ``max_memory_allocated`` and 6j's hand-written bound against the
    roofline's compute term and useful ratio."""
    from repro_torch.configs import ARCHS, get_config
    from repro_torch.configs.shapes import InputShape
    from repro_torch.launch.dryrun import run_one

    t_phase = time.perf_counter()
    combos = [(a, s) for s in ("decode_32k", "long_500k") for a in ARCHS]
    combos += [(TRAIN_ARCH, "train_4k"), (TRAIN_ARCH, "prefill_32k")]
    records, wrong = [], []
    for arch, shape in combos:
        try:
            rec = run_one(arch, shape, card=kind)
        except Exception as e:  # gated below with the others
            rec = {"arch": arch, "shape": shape, "status": "error", "error": f"{type(e).__name__}: {e}"}
        want = "skipped" if shape == "long_500k" and not get_config(arch).supports_long_context() else "ok"
        if rec["status"] != want:
            wrong.append((arch, shape, rec.get("error", rec["status"])))
        records.append(rec)

    def brief(rec):
        if rec["status"] != "ok":
            return {k: rec[k] for k in ("arch", "shape", "status") if k in rec}
        roof = rec["roofline"]
        return {"arch": rec["arch"], "shape": rec["shape"], "status": "ok", "trace_s": rec["trace_s"],
                "per_chip_gb": rec["memory"]["per_chip_gb"], "fits": rec["memory"]["fits"],
                "flops": roof["flops_per_chip"], "bytes": roof["bytes_per_chip"],
                "compute_ms": roof["compute_s"] * 1e3, "memory_ms": roof["memory_s"] * 1e3,
                "bottleneck": roof["bottleneck"], "useful_ratio": roof["useful_ratio"],
                "kernel_calls": {k: v["calls"] for k, v in rec["kernel_calls"].items()},
                "scaled": rec["scaled"]}

    # held against the card: 6e's decode step and 6j's train step
    dec = run_one("smollm-360m", InputShape("6e_decode", lm_6e["max_len"], LM_BATCH, "decode"), card=kind)
    trn = run_one(TRAIN_ARCH, InputShape("6j_train", TRAIN_SEQ, TRAIN_BATCH, "train"), card=kind)
    bound_ms = {name: max(r["roofline"]["compute_s"], r["roofline"]["memory_s"]) * 1e3
                for name, r in (("6e", dec), ("6j", trn))}
    measured_ms = {"6e": lm_6e["steady_ms_per_step"], "6j": train_6j["step_ms_median"]}
    counted = {"6e": {k: dec["memory"]["argument_parts"][k] for k in lm_6e["held_bytes"]},
               "6j": {k: trn["memory"]["argument_parts"][k] for k in train_6j["held_bytes"]}}
    held = {"6e": lm_6e["held_bytes"], "6j": train_6j["held_bytes"]}
    fd_calls = dec["kernel_calls"].get("flash_decode", {}).get("calls", 0)
    report = {
        "card": kind, "records": [brief(r) for r in records],
        "held_against_the_card": {
            "bytes_counted_on_meta": counted, "bytes_held_on_card": held,
            "flash_decode_calls_traced": fd_calls, "flash_decode_launches_per_step_6e": lm_6e["flash_decode_per_step"],
            "measured_ms": measured_ms, "roofline_bound_ms": bound_ms,
            "measured_over_bound": {k: measured_ms[k] / bound_ms[k] for k in bound_ms},
            "6e": brief(dec), "6j": brief(trn),
            "6j_predicted_peak_gb": trn["memory"]["per_chip_gb"],
            "6j_max_memory_allocated_gb": train_6j["peak_memory_gb"],
            "6j_allocated_before_phase_gb": train_6j["allocated_before_phase_gb"],
            "6j_hand_bound_ms": train_6j["bound"]["bound_ms"],
            "6j_roofline_compute_ms": trn["roofline"]["compute_s"] * 1e3,
            "6j_roofline_useful_ratio": trn["roofline"]["useful_ratio"],
            "6j_memory_parts": trn["memory"],
        },
        "phase_s": time.perf_counter() - t_phase,
    }
    print(json.dumps({"dryrun_6k": report}))
    check(not wrong, f"6k: dry-run records not as the reference's skips: {wrong}")
    for ph in ("6e", "6j"):
        check(counted[ph] == held[ph], f"6k: {ph}'s bytes counted on meta {counted[ph]} differ from the card's "
                                       f"{held[ph]}")
        check(measured_ms[ph] >= bound_ms[ph], f"6k: {ph}'s measured {measured_ms[ph]:.4f} ms is below its "
                                               f"roofline bound {bound_ms[ph]:.4f} ms")
    check(fd_calls == lm_6e["flash_decode_per_step"],
          f"6k: the traced decode step counts {fd_calls} flash_decode calls, 6e launched "
          f"{lm_6e['flash_decode_per_step']} a step")
    return report


def device_busy(prof, wall_s):
    """The share of a profiled window of ``wall_s`` seconds in which the
    device ran anything: the union of its traced activities' intervals
    (two stages' kernels overlap on the card), beside their plain sum."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy_us, reach = 0.0, float("-inf")
    for a, b in spans:
        busy_us += max(0.0, b - max(a, reach))
        reach = max(reach, b)
    return {"window_s": wall_s, "device_activities": len(spans),
            "device_busy_s": busy_us / 1e6 if spans else None,
            "device_busy_share": busy_us / 1e6 / wall_s if spans else None,
            "device_time_summed_s": sum(b - a for a, b in spans) / 1e6 if spans else None}


def graph_device_ms(torch, captured):
    """Device time of one replay of a captured graph
    (``kernels/graphs.py::Captured``), and of the work a call adds around
    it: its inputs copied into the static buffers, its outputs cloned."""
    srcs = [b.clone() for b in captured.static_in]
    outs = captured.static_out
    outs = list(outs.values()) if isinstance(outs, dict) else [outs]

    def copies():
        for buf, src in zip(captured.static_in, srcs):
            buf.copy_(src)
        return [t.clone() for t in outs]

    return {"replay_ms": device_ms(captured.graph.replay, torch), "copies_ms": device_ms(copies, torch)}


def serve_route(torch, serve, backend, images, graphs, live=None, **kw):
    """Serve ``images`` through VGG-16 on ``backend`` at micro-batch BATCH
    with the launch counts set to 0 just before and read just after; then
    three steady windows of STEADY_IMAGES, and after them a profiled window
    of PROFILE_IMAGES, on the same server.  ``graphs`` False serves the stage
    functions op by op (``build_eager_stage_fns``), True as CUDA graphs
    (the default builder).  ``live(server, outputs)`` runs on the server
    after the counts are read, before it stops."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import runtime
    from repro_torch.serving import build_eager_stage_fns

    if not graphs:
        kw["stage_fn_builder"] = lambda g, p: build_eager_stage_fns(g, p, backend=backend)
    mode = "graph" if graphs else "eager"
    runtime.reset_launches()
    t_build = time.perf_counter()
    server = serve("vgg16", backend=backend, batch_size=BATCH, seed=SEED, device=DEVICE, **kw)
    live_report = None
    try:
        setup_s = time.perf_counter() - t_build
        t0 = time.perf_counter()
        tickets = [server.submit(img) for img in images]
        outs = [t.result(timeout=600) for t in tickets]
        wall = time.perf_counter() - t0

        def window(n):
            t0 = time.perf_counter()
            ts = [server.submit(images[i % len(images)]) for i in range(n)]
            for t in ts:
                t.result(timeout=600)
            return time.perf_counter() - t0

        # served rate over steady windows, each long enough that filling
        # and draining the pipeline is a few of its 256 micro-batches
        steady_s = [window(STEADY_IMAGES) for _ in range(STEADY_REPS)]
        snap = server.metrics.snapshot()
        counts = runtime.launch_counts(tensor_cores=True)
        graph_launches = runtime.graph_launches()
        stage_graphs = [graph_device_ms(torch, c) for fn in server._stage_fns
                        for c in fn.graphs.values()] if graphs else []
        # one more window under the profiler (after the counts: the served
        # run they check is the one without it)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            profiled_s = window(PROFILE_IMAGES)
        busy = device_busy(prof, profiled_s)
        del prof
        outs_cpu = [o.cpu() for o in outs]
        plan = server.plan.notation()
        if live is not None:
            live_report = live(server, outs_cpu)
    finally:
        server.stop()
    stage_batches = [st["batches"] for st in snap["stages"]]
    check(len(set(stage_batches)) == 1, f"{backend} {mode}: stages saw different batch counts {stage_batches}")
    check(all(o.shape == (1, 1000) and bool(torch.isfinite(o).all()) for o in outs_cpu),
          f"{backend} {mode}: served outputs are not finite [1, 1000] rows")
    sums = torch.cat(outs_cpu).sum(-1)
    check(bool(torch.allclose(sums, torch.ones_like(sums), atol=1e-4)),
          f"{backend} {mode}: softmax rows do not sum to 1")
    n_stages = len(stage_batches)
    # the warm-up runs each stage once op by op (capturing its graph after it),
    # then every micro-batch replays each stage's graph once
    want_graphs = n_stages * stage_batches[0] if graphs else 0
    check(graph_launches == want_graphs,
          f"{backend} {mode}: {graph_launches} graph launches, want {want_graphs}")
    report = {
        "model": "vgg16", "backend": backend, "stage_fns": mode, "batch_size": BATCH,
        "images": len(images), "plan": plan,
        "setup_s": setup_s, "checked_window_s": wall,
        "steady_images": STEADY_IMAGES, "steady_img_per_s": [STEADY_IMAGES / t for t in steady_s],
        "ms_between_micro_batches": [t * 1e3 / (STEADY_IMAGES / BATCH) for t in steady_s],
        "stage_p50_ms": [st["service_p50_s"] * 1e3 for st in snap["stages"]],
        "stage_occupancy": [st["occupancy"] for st in snap["stages"]],
        "profiled_window": {"images": PROFILE_IMAGES, "img_per_s": PROFILE_IMAGES / profiled_s, **busy},
        "micro_batches": stage_batches[0], "launches": counts, "graph_launches": graph_launches,
        "stage_graphs_device_ms": stage_graphs,
    }
    if live_report is not None:
        report["live"] = live_report
    # + the warmup batch serve() runs
    return server, outs_cpu, counts, stage_batches[0] + 1, report


def hot_swap(torch, server, images, want):
    """``swap_plan`` on a live graph server while a thread keeps submitting:
    the new epoch is captured in the swap's prepare phase; every ticket
    resolves with the bits it had before; the old epoch's graphs are never
    replayed after the swap; the new epoch's replays count 13 conv and 3
    fc launches a micro-batch and one graph launch per stage."""
    import threading

    from repro_torch.core.pipeline import Pipeline, PipelinePlan
    from repro_torch.kernels import runtime

    plan = server.plan
    n = sum(len(a) for a in plan.allocation)
    first = plan.pipeline.stages[0]
    if len(plan.allocation) > 1:  # all layers in one stage
        new_plan = PipelinePlan(pipeline=Pipeline(stages=(first,)), allocation=(tuple(range(n)),))
    else:  # two stages, cut in the middle
        new_plan = PipelinePlan(pipeline=Pipeline(stages=(first, first)),
                                allocation=(tuple(range(n // 2)), tuple(range(n // 2, n))))
    old = [c for fn in server._stage_fns for c in fn.graphs.values()]
    tickets = []

    def feed():
        for i in range(SWAP_IMAGES):
            tickets.append((i, server.submit(images[i % len(images)])))

    feeder = threading.Thread(target=feed, daemon=True)
    feeder.start()
    while len(tickets) < SWAP_IMAGES // 4 and feeder.is_alive():
        time.sleep(0.001)
    t0 = time.perf_counter()
    server.swap_plan(new_plan)
    swap_s = time.perf_counter() - t0
    old_replays = [c.replays for c in old]
    feeder.join(timeout=600)
    lost, not_bitwise = SWAP_IMAGES - len(tickets), []
    for i, t in tickets:
        try:
            if not torch.equal(t.result(timeout=600).cpu(), want[i % len(want)]):
                not_bitwise.append(i)
        except Exception:  # noqa: BLE001 — a failed ticket is a lost one
            lost += 1
    # the new epoch alone, counted by its replays' tallies
    b0 = server.metrics.stages[0].snapshot()["batches"]
    runtime.reset_launches()
    after = [t.result(timeout=600).cpu() for t in [server.submit(img) for img in images]]
    batches = server.metrics.stages[0].snapshot()["batches"] - b0
    counts, graph_launches = runtime.launch_counts(), runtime.graph_launches()
    new = [c for fn in server._stage_fns for c in fn.graphs.values()]
    report = {
        "from_plan": plan.notation(), "to_plan": new_plan.notation(), "swap_s": swap_s,
        "submitted_around_swap": SWAP_IMAGES, "lost": lost, "not_bitwise": not_bitwise[:8],
        "old_graphs": len(old), "old_graph_replays_after_swap": sum(c.replays for c in old) - sum(old_replays),
        "new_graphs": len(new), "new_epoch_micro_batches": batches, "new_epoch_launches": counts,
        "new_epoch_graph_launches": graph_launches,
        "after_bitwise": all(torch.equal(a, b) for a, b in zip(after, want)),
    }
    check(lost == 0, f"hot swap lost {lost} tickets")
    check(not not_bitwise, f"hot swap changed the outputs of tickets {not_bitwise[:8]}")
    check(report["after_bitwise"], "outputs after the hot swap differ from those before it")
    check(report["old_graph_replays_after_swap"] == 0, "an old epoch's graph was replayed after the swap")
    check(len(new) == len(new_plan.allocation) and not {id(c) for c in new} & {id(c) for c in old},
          "the swap did not capture the new epoch's graphs")
    check(counts["conv2d_fused"] == 13 * batches and counts["matmul_fused"] == 3 * batches
          and graph_launches == len(new) * batches,
          f"after the swap: {counts} and {graph_launches} graph launches over {batches} micro-batches")
    return report


def plan_from_card(torch, serve, images, params, want, hikey_report):
    """Phase 5: the plan from the card.  (a) A ConvAutotuner, on a cache
    file of its own (cold), sweeps B1's tile variants at every distinct
    VGG-16 conv geometry at the served micro-batch BATCH; each layer's
    conv at batch BATCH is then timed on the picked variant and on the
    heuristic (-1), and a second tuner on the same file must time nothing
    and pick the same.  (b)
    measure_graph_routes at batch 1 on ``cuda_fused`` and ``cuda``.  (c)
    ``serve(..., platform=host_platform(2), tuner=tuner)`` plans from
    those measurements and serves bitwise equal to phase 4's graph server
    (``want``), 13 + 3 launches a micro-batch, its steady img/s beside the
    hikey970() plan's.  (d) A server with ``plan_store=`` persists its
    plan and the plan a swap_plan moves it to; crash() fails a ticket and
    stop() re-raises; ``serve(resume_from=)`` makes no pipe_it_search call
    and serves the persisted plan with the same bits."""
    import tempfile

    import repro_torch.serving.planner as planner_mod
    from repro_torch.cnn.models import MODELS
    from repro_torch.core.pipeline import Pipeline, PipelinePlan
    from repro_torch.kernels import conv_fused as K
    from repro_torch.kernels.autotune import ConvAutotuner, descriptor_key
    from repro_torch.kernels.backend import measure_graph_routes, resolve_backend
    from repro_torch.serving import AutoPlanner, PlanStore, ServingError, host_platform

    tmp = tempfile.mkdtemp(prefix="chip_smoke_autotune_")
    cache = os.path.join(tmp, "autotune_cache.json")
    graph = MODELS["vgg16"]()
    descs = graph.descriptors()
    convs = [d for d in descs if d.kind == "conv"]
    dev = torch.device(DEVICE)

    # ------------------------------------------------------- 5a. the sweep
    tuner = ConvAutotuner(cache_path=cache, device=DEVICE, batch=BATCH)
    check(tuner.sweep, "the tuner does not sweep on the card")
    geometries = {}
    for d in convs:
        geometries.setdefault(descriptor_key(d), []).append(d.name)
        tuner.tune(d)
    check(len(geometries) == 9, f"VGG-16 has {len(geometries)} conv geometries, want 9")
    n_cands = len(tuner.entry(convs[0])["candidate_s"])
    check(tuner.timings_run == len(geometries) * n_cands,
          f"the sweep timed {tuner.timings_run} candidates, want {len(geometries)} x {n_cands}")
    sweep_rows = []
    for key, names in geometries.items():
        e = tuner.entry(next(d for d in convs if descriptor_key(d) == key))
        check(e["swept"] and e["candidates"] == n_cands, f"{key} was not swept: {e}")
        sweep_rows.append({"geometry": key, "layers": names, "variant": e["variant"],
                           "ms": e["time_s"] * 1e3, "heuristic_ms": e["candidate_s"]["-1"] * 1e3,
                           "candidate_ms": {v: t * 1e3 for v, t in e["candidate_s"].items()}})
    warm = ConvAutotuner(cache_path=cache, device=DEVICE, batch=BATCH)
    same = all(warm.tune(d) == tuner.tune(d) for d in convs)
    check(warm.timings_run == 0 and same,
          f"a second tuner on the warm cache timed {warm.timings_run} candidates (same picks: {same})")
    # each layer at the served micro-batch: the picked variant against -1
    gen = torch.Generator(device=dev).manual_seed(SEED)
    layer_rows, tuned_total, heuristic_total = [], 0.0, 0.0
    for d in convs:
        x = torch.randn(BATCH, d.i_h, d.i_w, d.i_d, device=dev, generator=gen)
        wt = torch.randn(d.f_h, d.f_w, d.i_d, d.ofm, device=dev, generator=gen) * (2.0 / (9 * d.i_d)) ** 0.5
        b = torch.randn(d.ofm, device=dev, generator=gen) * 0.1
        v = tuner.tune(d).variant
        y = K.conv2d_fused(x, wt, b, stride=d.stride, pad=d.pad, relu=True, variant=v)
        check(bool(torch.equal(y, K.conv2d_fused(x, wt, b, stride=d.stride, pad=d.pad, relu=True))),
              f"conv2d_fused on tile variant {v} differs from -1 at vgg16:{d.name}")
        t_v = device_ms(lambda: K.conv2d_fused(x, wt, b, stride=d.stride, pad=d.pad, relu=True, variant=v), torch)
        t_h = device_ms(lambda: K.conv2d_fused(x, wt, b, stride=d.stride, pad=d.pad, relu=True), torch)
        tuned_total, heuristic_total = tuned_total + t_v, heuristic_total + t_h
        layer_rows.append({"layer": d.name, "variant": v, "tuned_device_ms": t_v, "heuristic_device_ms": t_h})
    print(json.dumps({"autotune_sweep_5a": {
        "platform": tuner.platform, "repeats": tuner.repeats, "timer": "CUDA events behind a sleep kernel, one call, best of k",
        "batch": tuner.batch, "geometries": sweep_rows, "warm_tuner_timings_run": warm.timings_run,
        "layers_at_batch": BATCH, "layers_timer": "device_ms", "layers": layer_rows,
        "tuned_device_ms_total": tuned_total, "heuristic_device_ms_total": heuristic_total}}))

    # -------------------------------------------------- 5b. measured routes
    routes = {}
    for route in ("cuda_fused", "cuda"):
        measured = measure_graph_routes(graph, resolve_backend(route, tuner=tuner), tuner)
        per_layer = {d.name: measured[descriptor_key(d)] * 1e3 for d in descs}
        check(all(t > 0 for t in per_layer.values()), f"{route}: a measured layer time is not positive")
        routes[route] = {"layer_ms": per_layer, "sum_ms": sum(per_layer.values()), "measured": measured}
    print(json.dumps({"measured_routes_5b": {
        "batch": 1, "timer": "CUDA events behind a sleep kernel, one call, best of k",
        **{r: {k: v for k, v in m.items() if k != "measured"} for r, m in routes.items()}}}))

    # ----------------------------------------- 5c. a plan from the card, served
    before = tuner.timings_run
    server, outs, counts, n_batches, report = serve_route(
        torch, serve, "cuda_fused", images, True, params=params, platform=host_platform(2), tuner=tuner)
    check(tuner.timings_run == before, f"serve() re-timed {tuner.timings_run - before} entries of a warm tuner")
    check(counts["conv2d_fused"] == 13 * n_batches and counts["matmul_fused"] == 3 * n_batches,
          f"card plan: {counts} over {n_batches} micro-batches, want 13 + 3 each")
    check(all(torch.equal(a, b) for a, b in zip(outs, want)),
          "the card plan's outputs differ from phase 4's cuda_fused graph server")
    T = AutoPlanner(platform=host_platform(2), measured=routes["cuda_fused"]["measured"]).time_matrix(graph)
    plan = server.plan
    predicted = [t * 1e3 for t in plan.stage_times(T)]
    measured_sums = [sum(routes["cuda_fused"]["layer_ms"][descs[l].name] for l in a) for a in plan.allocation]
    print(json.dumps({"card_plan_5c": {
        "platform": "host_platform(2)", "plan": plan.notation(),
        "allocation": [[l + 1 for l in a] for a in plan.allocation],
        "predicted_stage_ms_batch1": predicted, "measured_layer_sum_ms_batch1": measured_sums,
        "measured_stage_p50_ms_batch": report["stage_p50_ms"], "batch": BATCH,
        "p50_over_predicted": [m / p for m, p in zip(report["stage_p50_ms"], predicted)],
        "steady_img_per_s": report["steady_img_per_s"],
        "hikey970_plan": hikey_report["plan"], "hikey970_steady_img_per_s": hikey_report["steady_img_per_s"],
        "profiled_window": report["profiled_window"], "launches": counts, "micro_batches": n_batches,
        "bitwise_vs_phase4": True}}))

    # ------------------------------------------ 5d. persist, swap, crash, resume
    path = os.path.join(tmp, "last_known_good.json")
    search_calls = []
    real_search = planner_mod.pipe_it_search

    def counting_search(*a, **kw):
        search_calls.append(1)
        return real_search(*a, **kw)

    planner_mod.pipe_it_search = counting_search
    try:
        srv = serve("vgg16", backend="cuda_fused", batch_size=BATCH, device=DEVICE, params=params,
                    platform=host_platform(2), tuner=tuner, plan_store=path)
        cold_calls = len(search_calls)
        try:
            check(PlanStore(path).load_plan().as_pipeline_plan() == srv.plan,
                  "the plan store does not hold the startup plan")
            n = sum(len(a) for a in srv.plan.allocation)
            first = srv.plan.pipeline.stages[0]
            if len(srv.plan.allocation) > 1:  # all layers in one stage
                new_plan = PipelinePlan(pipeline=Pipeline(stages=(first,)), allocation=(tuple(range(n)),))
            else:
                new_plan = PipelinePlan(pipeline=Pipeline(stages=(first, first)),
                                        allocation=(tuple(range(n // 2)), tuple(range(n // 2, n))))
            srv.swap_plan(new_plan)
            check(PlanStore(path).load_plan().as_pipeline_plan() == new_plan,
                  "the plan store does not hold the plan swap_plan moved to")
            swapped = [t.result(timeout=600).cpu() for t in [srv.submit(img) for img in images]]
            check(all(torch.equal(a, b) for a, b in zip(swapped, want)),
                  "outputs after the persisted swap differ from phase 4's")
            ticket = srv.submit(images[0])
            srv.crash()
            try:
                ticket.result(timeout=600)
                ticket_failed = False
            except ServingError:
                ticket_failed = True
            check(ticket_failed, "a ticket in flight at crash() did not fail")
        finally:
            try:
                srv.stop()
                stop_raised = False
            except ServingError:
                stop_raised = True
        check(stop_raised, "stop() after crash() did not re-raise")
        resumed = serve("vgg16", backend="cuda_fused", batch_size=BATCH, device=DEVICE, params=params,
                        platform=host_platform(2), tuner=tuner, resume_from=path)
        try:
            resume_calls = len(search_calls) - cold_calls
            resumed_plan = resumed.plan
            outs_r = [t.result(timeout=600).cpu() for t in [resumed.submit(img) for img in images]]
        finally:
            resumed.stop()
    finally:
        planner_mod.pipe_it_search = real_search
    check(cold_calls >= 1, "the cold start made no pipe_it_search call (the counter is not wired)")
    check(resume_calls == 0, f"serve(resume_from=) called pipe_it_search {resume_calls} times")
    check(resumed_plan == new_plan, f"resumed on {resumed_plan.notation()}, want {new_plan.notation()}")
    check(all(torch.equal(a, b) for a, b in zip(outs_r, want)), "the resumed server's outputs differ from phase 4's")
    print(json.dumps({"persist_resume_5d": {
        "startup_plan": plan.notation(), "swapped_to": new_plan.notation(),
        "cold_pipe_it_search_calls": cold_calls, "resume_pipe_it_search_calls": resume_calls,
        "crash_failed_ticket": ticket_failed, "stop_reraised": stop_raised,
        "resumed_plan": resumed_plan.notation(), "bitwise_after_swap_and_resume": True}}))
    return tuner, routes["cuda_fused"]["measured"], tmp


def loop_window(torch, server, images, want, n=None):
    """Submit ``n`` images (LOOP_IMAGES by default; ``images`` cycled),
    wait for every ticket and hold each output bitwise against phase 4's
    (``want``); returns the window's img/s, the tickets that failed and
    the outputs that differ."""
    n = LOOP_IMAGES if n is None else n
    t0 = time.perf_counter()
    tickets = [(i, server.submit(images[i % len(images)])) for i in range(n)]
    failed, differ = 0, []
    for i, t in tickets:
        try:
            out = t.result(timeout=600).cpu()
        except Exception:  # noqa: BLE001 — a failed ticket is a lost one
            failed += 1
            continue
        if not torch.equal(out, want[i % len(want)]):
            differ.append(i)
    return n / (time.perf_counter() - t0), failed, differ


def served_batches(server):
    """Micro-batches stage 0 ran over every epoch of ``server``."""
    snaps = [epoch[0] for epoch in server.metrics.stage_history]
    return sum(s["batches"] for s in snaps) + server.metrics.stages[0].snapshot()["batches"]


def stop_quietly(server):
    """``server.stop()``; returns what it raised (None when nothing)."""
    try:
        server.stop()
    except Exception as e:  # noqa: BLE001 — reported and gated by the caller
        return repr(e)
    return None


def loop_report(server, monitor, windows, reserved):
    ctrl = monitor.controller
    return {
        "rounds": ctrl.rounds, "swaps": ctrl.swaps, "epochs": server.epoch,
        "events": [{"round": e.round, "old_plan": e.old_plan.notation(), "new_plan": e.new_plan.notation(),
                    "deviation": e.deviation, "predicted_gain": e.predicted_gain, "swapped": e.swapped}
                   for e in ctrl.history],
        "corrections": dict(ctrl.calibrator.correction),
        "windows": windows, "reserved_bytes_after_swaps": reserved,
        "monitor_error": None if monitor.error is None else repr(monitor.error),
    }


def reserved_bytes(torch):
    torch.cuda.synchronize()
    return torch.cuda.memory_reserved()


def baseline_bytes(torch):
    """Reserved bytes before a server starts: nothing of an earlier one
    left in the allocator's cache."""
    import gc

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.memory_reserved()


def check_launches(name, counts, micro_batches):
    """``counts`` (``launch_counts(tensor_cores=True)``) over VGG-16's
    ``micro_batches``: 13 conv and 3 fc launches each, all but conv1_1's
    (K = 27) in csrc/gemm.cu's tensor-core order."""
    want = {"conv2d_fused": 13, "conv2d_fused_tc": 12, "matmul_fused": 3, "matmul_fused_tc": 3}
    check(all(counts[k] == n * micro_batches for k, n in want.items()),
          f"{name}: {counts} over {micro_batches} micro-batches (served and warm-ups), want {want} each")


def closed_loop(torch, serve, images, params, want, tuner, measured, tmp):
    """Phases 5e and 5f: the closed control loop over VGG-16 served on
    ``cuda_fused`` with CUDA-graph stage functions.  Returns the B1 and B2
    launches counted in their runs.

    5e: the prior is 5b's measured batch-1 layer times, the same on both
    core types of ``host_platform(2)`` (no Eq. 6-8 terms); the stages run
    behind ``delayed_stage_fn_builder`` (a sleep kernel after each stage's
    graph replay of BATCH x the truth's stage time, ``truth`` starting at
    the prior) under ``serve(adaptive=True)``, the monitor thread running.
    A window, then ``truth.scale("L", 2.0)``, then windows until the loop
    has swapped (and one more) or LOOP_WINDOWS pass.  Beside it a static
    server on the same builder at the drifted truth, then swapped to the
    plan ``pipe_it_search`` makes from the drifted truth (the oracle) and
    back, six swaps, with the reserved memory after each.  5e-ii: the loop
    on 5c's card plan with its default prior (Eq. 6-8 with the
    measurements) and no delay or drift.  5f: ``serve(power_cap_w=cap0,
    plan_store=)`` on ``hikey970()``, then ``governor.throttle(cap1)`` with
    images in flight; the clocks and watts are ``hikey970()``'s modeled
    ones, never the card's."""
    import threading

    from repro_torch.cnn.models import MODELS
    from repro_torch.core import hikey970, pipe_it_search, power_aware_search
    from repro_torch.kernels import runtime
    from repro_torch.kernels.autotune import descriptor_key
    from repro_torch.serving import (AdaptiveConfig, AutoPlanner, DriftingMatrix, PlanStore,
                                     delayed_stage_fn_builder, host_platform)
    from repro_torch.serving.adaptive import StageDelay

    dev = torch.device(DEVICE)
    graph = MODELS["vgg16"]()
    descs = graph.descriptors()
    plat = host_platform(2)
    cfg = AdaptiveConfig(alpha=0.5, threshold=0.3, patience=2, min_gain=1.05, interval_s=0.2,
                         min_items=8 * BATCH)
    cfg_line = {k: getattr(cfg, k) for k in ("alpha", "threshold", "patience", "min_gain", "interval_s",
                                             "min_items")}
    path_launches = {"conv2d_fused": 0, "matmul_fused": 0}

    def add(counts):
        for k in path_launches:
            path_launches[k] += counts[k]

    def reserved():
        return reserved_bytes(torch)

    def baseline():
        return baseline_bytes(torch)

    # ------------------------------------------ 5e. the adaptive loop, drifted
    T = [{st: measured[descriptor_key(d)] for st in plat.stage_vocabulary()} for d in descs]
    plan0 = pipe_it_search(len(T), plat, T, mode="best")
    truth = DriftingMatrix(T)
    r_start = baseline()
    server = serve("vgg16", backend="cuda_fused", batch_size=BATCH, device=DEVICE, params=params,
                   platform=plat, time_matrix=T, adaptive=True, adaptive_config=cfg,
                   stage_fn_builder=delayed_stage_fn_builder(truth, scale=BATCH, backend="cuda_fused"))
    epoch_bytes = reserved() - r_start
    monitor = server.monitor
    check(server.plan == plan0, f"5e served {server.plan.notation()}, the DSE made {plan0.notation()}")
    runtime.reset_launches()
    completed0, submitted, lost, differ = server.metrics.completed, 0, 0, []
    windows, after_swaps, swaps_at_drift, swapped_in = [], [], None, None
    try:
        for w in range(1 + LOOP_WINDOWS):
            if w == 1:
                swaps_at_drift = monitor.controller.swaps
                truth.scale("L", 2.0)
            epoch = server.epoch
            rate, failed, bad = loop_window(torch, server, images, want)
            submitted, lost, differ = submitted + LOOP_IMAGES, lost + failed, differ + bad
            windows.append({"window": w, "drifted": w >= 1, "img_per_s": rate, "epoch": server.epoch,
                            "plan": server.plan.notation()})
            if server.epoch != epoch:
                after_swaps.append(reserved())
            if swapped_in is not None:
                break  # this window ran on the plan the loop swapped to
            if w >= 1 and monitor.controller.swaps > swaps_at_drift:
                swapped_in = w
    finally:
        stop_error = stop_quietly(server)
    counts = runtime.launch_counts(tensor_cores=True)
    swaps = monitor.controller.swaps
    report = loop_report(server, monitor, windows, after_swaps)
    report["launches"] = counts
    check_launches("5e", counts, served_batches(server) + swaps)
    add(counts)
    completed = server.metrics.completed - completed0
    del server, monitor

    # the same drift on a static server, then the oracle's plan and back
    truth_s = DriftingMatrix(T)
    truth_s.scale("L", 2.0)
    oracle = pipe_it_search(len(T), plat, truth_s.T, mode="best")
    r_start = baseline()
    static = serve("vgg16", backend="cuda_fused", batch_size=BATCH, device=DEVICE, params=params,
                   platform=plat, time_matrix=T,
                   stage_fn_builder=delayed_stage_fn_builder(truth_s, scale=BATCH, backend="cuda_fused"))
    static_epoch_bytes = reserved() - r_start
    runtime.reset_launches()
    static_reserved, static_lost, static_differ, n_static = [], 0, [], 0
    try:
        static_rate, failed, bad = loop_window(torch, static, images, want)
        static_lost, static_differ, n_static = failed, bad, LOOP_IMAGES
        for k, p in enumerate((oracle, plan0) * 3):
            static.swap_plan(p)
            static_reserved.append(reserved())
            n = LOOP_IMAGES if k == 0 else len(images)
            rate, failed, bad = loop_window(torch, static, images, want, n=n)
            static_lost, static_differ, n_static = static_lost + failed, static_differ + bad, n_static + n
            if k == 0:
                oracle_rate = rate
    finally:
        static_stop_error = stop_quietly(static)
    static_counts = runtime.launch_counts(tensor_cores=True)
    check_launches("5e static", static_counts, served_batches(static) + 6)
    add(static_counts)
    del static
    report.update({
        "platform": "host_platform(2)", "prior": "5b's measured batch-1 layer times (cuda_fused), both core types",
        "delay": f"sleep kernel after each stage's graph replay: {BATCH} x stage_time(truth)",
        "sleep_kernel_cycles_per_s": StageDelay().cycles_per_s(dev), "config": cfg_line,
        "plan0": plan0.notation(), "drift": "truth.scale('L', 2.0) after window 0",
        "swaps_after_drift": swaps - swaps_at_drift, "final_plan": windows[-1]["plan"],
        "submitted": submitted, "completed": completed, "lost": lost, "not_bitwise": differ[:8],
        "stop_error": stop_error, "epoch_bytes": epoch_bytes, "static_launches": static_counts,
        "static_img_per_s": static_rate, "oracle_plan": oracle.notation(), "oracle_img_per_s": oracle_rate,
        "recovery_vs_oracle": windows[-1]["img_per_s"] / oracle_rate,
        "static_swaps_reserved_bytes": static_reserved, "static_epoch_bytes": static_epoch_bytes,
        "static_lost": static_lost, "static_not_bitwise": static_differ[:8],
    })
    print(json.dumps({"adaptive_5e": report}))
    check(report["swaps_after_drift"] >= 1, "5e: the loop did not swap after the 2x drift")
    check(lost == 0 and completed == submitted, f"5e: {lost} lost, {completed} resolved of {submitted}")
    check(not differ, f"5e: outputs of tickets {differ[:8]} differ from phase 4's")
    check(report["monitor_error"] is None and stop_error is None,
          f"5e: monitor error {report['monitor_error']}, stop() raised {stop_error}")
    check(not after_swaps or after_swaps[-1] <= after_swaps[0] + epoch_bytes,
          f"5e: reserved memory grew across swaps {after_swaps} (one epoch {epoch_bytes})")
    check(static_lost == 0 and not static_differ and static_stop_error is None,
          f"5e static: {static_lost} lost, {static_differ[:8]} differ, stop() raised {static_stop_error}")
    check(static_reserved[-1] <= static_reserved[0] + static_epoch_bytes,
          f"5e static: reserved memory grew across six swaps {static_reserved} (one epoch {static_epoch_bytes})")

    # ----------------------------- 5e-ii. the loop on the card plan's prior
    server = serve("vgg16", backend="cuda_fused", batch_size=BATCH, device=DEVICE, params=params,
                   platform=plat, tuner=tuner, adaptive=True, adaptive_config=cfg)
    monitor = server.monitor
    runtime.reset_launches()
    completed0, submitted, lost, differ, windows, after_swaps = server.metrics.completed, 0, 0, [], [], []
    try:
        for w in range(LOOP_WINDOWS_II):
            epoch = server.epoch
            rate, failed, bad = loop_window(torch, server, images, want)
            submitted, lost, differ = submitted + LOOP_IMAGES, lost + failed, differ + bad
            windows.append({"window": w, "img_per_s": rate, "epoch": server.epoch, "plan": server.plan.notation()})
            if server.epoch != epoch:
                after_swaps.append(reserved())
    finally:
        stop_error = stop_quietly(server)
    counts = runtime.launch_counts(tensor_cores=True)
    report = loop_report(server, monitor, windows, after_swaps)
    check_launches("5e-ii", counts, served_batches(server) + monitor.controller.swaps)
    add(counts)
    completed = server.metrics.completed - completed0
    report.update({"platform": "host_platform(2)", "prior": "default: Eq. 6-8 (synthetic_model) with 5b's measurements",
                   "config": cfg_line, "drift": None, "submitted": submitted, "completed": completed,
                   "lost": lost, "not_bitwise": differ[:8], "stop_error": stop_error, "launches": counts,
                   "predicted_stage_ms_batch1": [t * 1e3 for t in monitor.controller.plan.stage_times(
                       monitor.controller.calibrator.prior)],
                   "stage_p50_ms_batch": [st["service_p50_s"] * 1e3 for st in server.metrics.snapshot()["stages"]]})
    print(json.dumps({"adaptive_5e_ii": report}))
    check(lost == 0 and completed == submitted, f"5e-ii: {lost} lost, {completed} resolved of {submitted}")
    check(not differ, f"5e-ii: outputs of tickets {differ[:8]} differ from phase 4's")
    check(report["monitor_error"] is None and stop_error is None,
          f"5e-ii: monitor error {report['monitor_error']}, stop() raised {stop_error}")
    check(report["swaps"] <= report["rounds"], f"5e-ii: {report['swaps']} swaps in {report['rounds']} rounds")
    del server, monitor

    # -------------------------------------------- 5f. the governor, throttled
    hk = hikey970()
    T_h = AutoPlanner(platform=hk).time_matrix(graph)
    envelope = hk.max_power_w()
    cap0 = 1.05 * envelope
    p0 = power_aware_search(len(T_h), hk, T_h, mode="best", power_cap_w=cap0)
    for frac in (0.08, 0.05, 0.1, 0.2, 0.3, 0.4, 0.5):  # the reference test's deep throttle first
        p1 = power_aware_search(len(T_h), hk, T_h, mode="best", power_cap_w=frac * envelope)
        if p1.plan != p0.plan:
            break
    check(p1.plan != p0.plan, "5f: no cap moves the plan")
    cap1 = frac * envelope
    path = os.path.join(tmp, "governor_plan.json")
    server = serve("vgg16", backend="cuda_fused", batch_size=BATCH, device=DEVICE, params=params,
                   power_cap_w=cap0, plan_store=path)
    stored0 = PlanStore(path).load_plan()
    runtime.reset_launches()
    completed0, tickets = server.metrics.completed, []

    def feed():
        for i in range(THROTTLE_IMAGES):
            tickets.append((i, server.submit(images[i % len(images)])))

    try:
        start_plan = server.plan
        feeder = threading.Thread(target=feed, daemon=True)
        feeder.start()
        while len(tickets) < THROTTLE_IMAGES // 4 and feeder.is_alive():
            time.sleep(0.001)
        t0 = time.perf_counter()
        got = server.governor.throttle(cap1)
        throttle_s = time.perf_counter() - t0
        feeder.join(timeout=600)
        lost, differ = THROTTLE_IMAGES - len(tickets), []
        for i, t in tickets:
            try:
                if not torch.equal(t.result(timeout=600).cpu(), want[i % len(want)]):
                    differ.append(i)
            except Exception:  # noqa: BLE001 — a failed ticket is a lost one
                lost += 1
        snap = server.governor.snapshot()
        stage_freqs = server.governor.stage_freqs
    finally:
        stop_error = stop_quietly(server)
    counts = runtime.launch_counts(tensor_cores=True)
    check_launches("5f", counts, served_batches(server) + 1)
    add(counts)
    stored = PlanStore(path).load_plan()
    completed = server.metrics.completed - completed0
    print(json.dumps({"governor_5f": {
        "platform": "hikey970(): its modeled OPP clocks and watts, not the card's", "time_matrix": "synthetic",
        "envelope_w_modeled": envelope, "cap0_w": cap0, "cap1_w": cap1,
        "plan0": p0.notation(), "plan0_avg_power_w_modeled": p0.avg_power_w,
        "plan1": p1.notation(), "plan1_avg_power_w_modeled": p1.avg_power_w,
        "served_plan_before": start_plan.notation(), "served_plan_after": server.plan.notation(),
        "throttle_s": throttle_s, "epoch": server.epoch, "submitted": THROTTLE_IMAGES,
        "completed": completed, "lost": lost, "not_bitwise": differ[:8], "stop_error": stop_error,
        "governor": snap, "stored_before": stored0.notation(), "stored_after": stored.notation(),
        "launches": counts}}))
    check(start_plan == p0.plan and stored0.stage_freqs == tuple(p0.stage_freqs),
          f"5f: started on {start_plan.notation()} (stored {stored0.notation()}), want {p0.notation()}")
    check(lost == 0 and completed == THROTTLE_IMAGES, f"5f: {lost} lost, {completed} resolved")
    check(server.epoch == 1 and server.plan == p1.plan and got.plan == p1.plan,
          f"5f: epoch {server.epoch} on {server.plan.notation()}, want epoch 1 on {p1.notation()}")
    check(not differ, f"5f: outputs of tickets {differ[:8]} differ from phase 4's")
    check(tuple(stage_freqs) == tuple(p1.stage_freqs), f"5f: clocks {stage_freqs}, the search's {p1.stage_freqs}")
    check(stored.as_pipeline_plan() == p1.plan and stored.stage_freqs == tuple(p1.stage_freqs),
          f"5f: the plan store holds {stored.notation()}, want {p1.notation()}")
    check(stop_error is None, f"5f: stop() raised {stop_error}")
    return path_launches


def other_partition(Ts, plat, current):
    """The best-scored share assignment of ``plat`` (the utilitarian sum,
    each share's plan from ``pipe_it_search``) whose plans differ from
    ``current``'s."""
    from repro_torch.core import enumerate_shares, partition_objective, pipe_it_search
    from repro_torch.core.dse import ModelPlan, PartitionPlan

    best = None
    for assignment in enumerate_shares(plat, len(Ts)):
        mps = []
        for (name, T), share in zip(Ts.items(), assignment):
            sub = plat.subset(dict(share))
            plan = pipe_it_search(len(T), sub, T, mode="best")
            mps.append(ModelPlan(name=name, share=sub, plan=plan, throughput=plan.throughput(T)))
        cand = PartitionPlan(assignments=tuple(mps), feasible=True,
                             objective=partition_objective([m.throughput for m in mps]))
        if cand.plans() != current.plans() and (best is None or cand.objective > best.objective):
            best = cand
    return best


def co_serving(torch, serve, images, params, want, tuner, tmp, vgg_single_img_per_s):
    """Phase 5g: VGG-16 (phase 4's weights) and MobileNet (weights from
    seed 0) co-served on ``cuda_fused`` graphs at micro-batch BATCH, on a
    partition of ``host_platform(4)`` planned from phase 5's tuner: the
    routes ``measure_graph_routes`` times for both models under
    ``cuda_fused`` (VGG-16's are cache hits, so the tuner times only
    MobileNet's new geometries).  Gated: each model bitwise equal to its
    single-stage engine (VGG-16 also to phase 4, ``want``), 13 + 3 and 14
    + 1 launches a micro-batch and one graph launch per stage; no ticket
    lost across a ``swap_partition`` with traffic in flight, the bits
    kept, the store holding the new partition, reserved memory after four
    more swaps no higher than after the first plus one epoch's; a resume
    with no ``partition_search`` call and the same bits; a short adaptive
    run with no monitor error.  Recorded, not gated: the co-served img/s
    over three steady windows, and the time-sliced baseline against the
    co-served partition at batch 1.  Returns the B1 and B2 launches of
    its gated served runs, and for phase 5i the registry it served (VGG-16
    on phase 4's weights, MobileNet's from seed 0), each model's
    single-stage outputs on ``images`` and its steady windows."""
    import threading

    from torch.profiler import ProfilerActivity, profile

    import repro_torch.serving.planner as planner_mod
    from repro_torch.cnn.models import MODELS
    from repro_torch.kernels import runtime
    from repro_torch.kernels.autotune import descriptor_key
    from repro_torch.kernels.backend import resolve_backend
    from repro_torch.kernels.conv_fused import supports
    from repro_torch.serving import (AdaptiveConfig, AutoPlanner, ModelEntry, MultiModelServer,
                                     PipelinedGraphEngine, PlanStore, SingleStageEngine,
                                     TimeSlicedEngine, host_platform)

    dev = torch.device(DEVICE)
    plat = host_platform(4)
    names = ("vgg16", "mobilenet")
    per_batch = {"vgg16": (13, 3), "mobilenet": (14, 1)}
    vgg = MODELS["vgg16"]()
    store = os.path.join(tmp, "partition.json")
    path_launches = {"conv2d_fused": 0, "matmul_fused": 0}

    def spec():
        return {"vgg16": ModelEntry(name="vgg16", graph=vgg, params=params), "mobilenet": "mobilenet"}

    def served_counts(mm, tag, b0=None):
        """Launches since the last reset against each model's micro-batches
        since ``b0`` (one graph launch per stage and micro-batch)."""
        counts, graph_launches = runtime.launch_counts(), runtime.graph_launches()
        nb = {n: mm.servers[n].metrics.stages[0].snapshot()["batches"] - (b0 or {}).get(n, 0) for n in names}
        want_conv = sum(per_batch[n][0] * nb[n] for n in names)
        want_fc = sum(per_batch[n][1] * nb[n] for n in names)
        want_graphs = sum(len(mm.servers[n].plan.allocation) * nb[n] for n in names)
        check(counts["conv2d_fused"] == want_conv and counts["matmul_fused"] == want_fc
              and graph_launches == want_graphs,
              f"5g {tag}: {counts} and {graph_launches} graph launches over micro-batches {nb}, "
              f"want {want_conv} conv, {want_fc} fc, {want_graphs} graph launches")
        return {"micro_batches": nb, "conv2d_fused": counts["conv2d_fused"],
                "matmul_fused": counts["matmul_fused"], "graph_launches": graph_launches}

    def differing(outs, ref):
        """Indices of ``outs`` (cycled over ``ref``) not bitwise equal."""
        return [i for i, o in enumerate(outs) if not torch.equal(o.cpu(), ref[i % len(ref)])]

    # what the shared tuner must still time: MobileNet's geometries alone
    mob = MODELS["mobilenet"]()
    n_cands = tuner.entry(vgg.descriptors()[0])["candidates"]

    def swept(d):
        e = tuner.entry(d)
        return e is not None and "variant" in e and e.get("batch") == tuner.batch

    new_sweeps = {descriptor_key(d) for d in mob.descriptors()
                  if d.kind == "conv" and supports(d.f_h, d.f_w, d.stride, d.groups) and not swept(d)}
    new_routes = {descriptor_key(d) for d in mob.descriptors() if tuner.measured_route(d, "cuda_fused") is None}
    want_timings = len(new_sweeps) * n_cands + len(new_routes)
    vgg_entries = {descriptor_key(d): json.dumps(tuner.entry(d), sort_keys=True) for d in vgg.descriptors()}

    search_calls = []
    real_search = planner_mod.partition_search

    def counting_search(*a, **kw):
        search_calls.append(1)
        return real_search(*a, **kw)

    planner_mod.partition_search = counting_search
    try:
        # ------------------------------------------------ the server, planned
        r0 = baseline_bytes(torch)
        t_before = tuner.timings_run
        t0 = time.perf_counter()
        mm = serve(spec(), backend="cuda_fused", platform=plat, tuner=tuner, batch_size=BATCH,
                   device=DEVICE, plan_store=store)
        setup_s = time.perf_counter() - t0
        cold_calls, new_timings = len(search_calls), tuner.timings_run - t_before
        vgg_hits = all(json.dumps(tuner.entry(d), sort_keys=True) == vgg_entries[descriptor_key(d)]
                       for d in vgg.descriptors())
        part0 = mm.partition
        epoch_bytes = baseline_bytes(torch) - r0
        graphs = {n: mm.registry[n].graph for n in names}
        measured = tuner.route_seconds("cuda_fused")
        planner = AutoPlanner(platform=plat, measured=measured)
        Ts = planner.time_matrices(graphs)
        replanned = planner.partition(graphs, Ts)
        kb = resolve_backend("cuda_fused", tuner=tuner)
        single = {n: [o.cpu() for o in SingleStageEngine(graphs[n], mm.registry[n].params, backend=kb,
                                                          device=dev).run(images)["outputs"]]
                  for n in names}
        try:
            # ------------------------------------- bits and launches, then rates
            runtime.reset_launches()
            res = mm.run({n: images for n in names}, timeout=600)
            run_counts = served_counts(mm, "run()")
            outs = {n: [o.cpu() for o in res["outputs"][n]] for n in names}

            def window(n_img):
                done = {}

                def feed(n):
                    t1 = time.perf_counter()
                    ts = [mm.submit(n, images[i % len(images)], timeout=600) for i in range(n_img)]
                    for t in ts:
                        t.result(timeout=600)
                    done[n] = time.perf_counter() - t1

                threads = [threading.Thread(target=feed, args=(n,), daemon=True) for n in names]
                t1 = time.perf_counter()
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=600)
                wall = time.perf_counter() - t1
                check(sorted(done) == sorted(names), f"5g: a steady window's feeder failed ({sorted(done)})")
                return {"seconds": wall, "aggregate_img_per_s": len(names) * n_img / wall,
                        **{f"{n}_img_per_s": n_img / done[n] for n in names}}

            windows = [window(STEADY_IMAGES) for _ in range(STEADY_REPS)]
            steady_counts = served_counts(mm, "steady windows")
            snap = mm.metrics()
            # one more window under the profiler (after the counts, as in phase 4)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                profiled = window(PROFILE_IMAGES)
            busy = device_busy(prof, profiled["seconds"])
            del prof
            for k in path_launches:
                path_launches[k] += steady_counts[k]

            # -------------- the time-sliced baseline against the partition, batch 1
            sliced_images = [images[i % len(images)] for i in range(COSERVE_SLICED_IMAGES)]
            streams = {n: sliced_images for n in names}
            engines = {n: PipelinedGraphEngine(graphs[n], mm.registry[n].params, planner.plan(graphs[n]),
                                               backend=kb, device=dev) for n in names}
            sliced = TimeSlicedEngine(engines, quantum=SLICE_QUANTUM)
            sliced.warmup({n: images[0] for n in names})
            ts_res = sliced.run(streams)
            mm1 = MultiModelServer(mm.registry, part0, batch_size=1, backend=kb, device=dev)
            mm1.warmup()
            mm1.start()
            try:
                mm1_res = mm1.run(streams, timeout=600)
            finally:
                mm1_stop = stop_quietly(mm1)
            sliced_differ = {n: differing(ts_res["outputs"][n], single[n]) for n in names}
            mm1_differ = {n: differing(mm1_res["outputs"][n], single[n]) for n in names}
            multimodel = {
                "models": list(names), "platform": "host_platform(4)", "partition": part0.notation(),
                "batch": 1, "images_per_model": COSERVE_SLICED_IMAGES,
                "time_sliced": {"quantum": SLICE_QUANTUM, "slices": ts_res["slices"],
                                "plans": {n: e.plan.notation() for n, e in engines.items()},
                                "aggregate_img_per_s": ts_res["throughput"], "seconds": ts_res["seconds"]},
                "coserved": {"aggregate_img_per_s": mm1_res["throughput"], "seconds": mm1_res["seconds"]},
                "coserved_over_time_sliced": mm1_res["throughput"] / ts_res["throughput"],
                "bitwise_vs_single_stage": {"time_sliced": not any(sliced_differ.values()),
                                            "coserved": not any(mm1_differ.values())},
            }
            print(json.dumps({"multimodel": multimodel}))
            del engines, sliced, mm1, ts_res, mm1_res

            # ------------------------------------ swap_partition with traffic
            alt, alt_from = planner.partition(graphs, Ts, fairness="max-min"), "max-min"
            if alt.plans() == part0.plans():
                alt, alt_from = other_partition(Ts, plat, part0), "best-scored other assignment"
            tickets = []

            def feed_swap():
                for i in range(SWAP_IMAGES):
                    for n in names:
                        tickets.append((n, i, mm.submit(n, images[i % len(images)], timeout=600)))

            feeder = threading.Thread(target=feed_swap, daemon=True)
            feeder.start()
            while len(tickets) < SWAP_IMAGES // 2 and feeder.is_alive():
                time.sleep(0.001)
            t1 = time.perf_counter()
            mm.swap_partition(alt)
            swap_s = time.perf_counter() - t1
            feeder.join(timeout=600)
            lost = len(names) * SWAP_IMAGES - len(tickets)
            swap_differ = []
            for n, i, t in tickets:
                try:
                    if not torch.equal(t.result(timeout=600).cpu(), single[n][i % len(images)]):
                        swap_differ.append((n, i))
                except Exception:  # noqa: BLE001 — a failed ticket is a lost one
                    lost += 1
            swap_epoch = mm.partition_epoch
            stored = PlanStore(store).load_partition(plat)
            after_swaps, back_differ = [reserved_bytes(torch)], []
            for p in (part0, alt) * 2:
                mm.swap_partition(p)
                got = mm.run({n: images for n in names}, timeout=600)["outputs"]
                back_differ += [(n, i) for n in names for i in differing(got[n], single[n])]
                after_swaps.append(reserved_bytes(torch))
        finally:
            stop_error = stop_quietly(mm)

        # ----------------------------------------------- resume: no DSE call
        resume_calls0, t_before = len(search_calls), tuner.timings_run
        mm2 = serve(spec(), backend="cuda_fused", platform=plat, tuner=tuner, batch_size=BATCH,
                    device=DEVICE, resume_from=store)
        try:
            resume_calls = len(search_calls) - resume_calls0
            resume_timings = tuner.timings_run - t_before
            resumed = mm2.partition
            runtime.reset_launches()
            got = mm2.run({n: images for n in names}, timeout=600)["outputs"]
            resume_counts = served_counts(mm2, "resume")
            resume_differ = {n: differing(got[n], single[n]) for n in names}
        finally:
            resume_stop = stop_quietly(mm2)
        for k in path_launches:
            path_launches[k] += resume_counts[k]
    finally:
        planner_mod.partition_search = real_search

    # ------------------------------------------ the partition loop, short
    cfg = AdaptiveConfig(interval_s=0.2, min_items=8 * BATCH)
    mm3 = serve(spec(), backend="cuda_fused", platform=plat, tuner=tuner, batch_size=BATCH,
                device=DEVICE, adaptive=True, adaptive_config=cfg)
    loop_windows, loop_differ = [], []
    try:
        for w in range(COSERVE_LOOP_WINDOWS):
            t1 = time.perf_counter()
            got = mm3.run({n: [images[i % len(images)] for i in range(LOOP_IMAGES)] for n in names},
                          timeout=600)["outputs"]
            loop_windows.append({"window": w, "aggregate_img_per_s": len(names) * LOOP_IMAGES
                                 / (time.perf_counter() - t1),
                                 "epoch": mm3.partition_epoch, "partition": mm3.partition.notation()})
            loop_differ += [(w, n, i) for n in names for i in differing(got[n], single[n])]
        ctrl = mm3.monitor.controller
        loop = {"rounds": ctrl.rounds, "swaps": ctrl.swaps, "windows": loop_windows,
                "events": [{"round": e.round, "triggered_by": list(e.triggered_by),
                            "new_partition": e.new_partition.notation(), "predicted_gain": e.predicted_gain,
                            "swapped": e.swapped} for e in ctrl.history]}
    finally:
        loop_stop = stop_quietly(mm3)
    loop["monitor_error"] = None if mm3.monitor.error is None else repr(mm3.monitor.error)

    report = {
        "models": list(names), "platform": "host_platform(4)", "batch": BATCH, "setup_s": setup_s,
        "partition": part0.notation(),
        "shares": {mp.name: [(c.name, c.count) for c in mp.share.core_types] for mp in part0.assignments},
        "predicted_img_per_s_batch1": part0.throughputs(), "objective": part0.objective,
        "cold_partition_search_calls": cold_calls, "replanned_from_the_served_routes": replanned.notation(),
        "tuner_timings": new_timings, "tuner_timings_expected": want_timings,
        "mobilenet_new_sweeps": len(new_sweeps), "mobilenet_new_routes": len(new_routes),
        "vgg16_entries_unchanged": vgg_hits,
        "bitwise": {n: {"vs_single_stage": not differing(outs[n], single[n]),
                        "vs_phase4": (not differing(outs[n], want)) if n == "vgg16" else None}
                    for n in names},
        "launches_run": run_counts, "launches_steady": steady_counts,
        "steady_images_per_model": STEADY_IMAGES, "steady_windows": windows,
        "vgg16_alone_phase4_steady_img_per_s": vgg_single_img_per_s,
        "profiled_window": {"images_per_model": PROFILE_IMAGES, **profiled, **busy},
        "stage_p50_ms": {n: [st["service_p50_s"] * 1e3 for st in snap["models"][n]["stages"]] for n in names},
        "swap": {"to": alt.notation(), "from": alt_from, "swap_s": swap_s, "submitted": len(names) * SWAP_IMAGES,
                 "lost": lost, "not_bitwise": swap_differ[:8], "epoch": swap_epoch,
                 "store_holds_new": stored is not None and stored.plans() == alt.plans(),
                 "back_and_forth_not_bitwise": back_differ[:8], "reserved_bytes_after_swaps": after_swaps,
                 "epoch_bytes": epoch_bytes, "stop_error": stop_error},
        "resume": {"partition": resumed.notation(), "partition_search_calls": resume_calls,
                   "tuner_timings": resume_timings, "launches": resume_counts,
                   "not_bitwise": {n: v[:8] for n, v in resume_differ.items()}, "stop_error": resume_stop},
        "adaptive": {**loop, "not_bitwise": loop_differ[:8], "stop_error": loop_stop},
    }
    print(json.dumps({"coserve_5g": report}))
    check(replanned.notation() == part0.notation(),
          f"5g: served {part0.notation()}, the served routes plan {replanned.notation()}")
    check(cold_calls >= 1, "5g: the cold start made no partition_search call (the counter is not wired)")
    check(vgg_hits and new_timings == want_timings,
          f"5g: the tuner timed {new_timings}, want {want_timings} (MobileNet's new geometries); "
          f"VGG-16's entries unchanged: {vgg_hits}")
    for n in names:
        check(report["bitwise"][n]["vs_single_stage"], f"5g: served {n} differs from its single-stage engine")
    check(report["bitwise"]["vgg16"]["vs_phase4"], "5g: served VGG-16 differs from phase 4's")
    check(multimodel["bitwise_vs_single_stage"]["time_sliced"] and multimodel["bitwise_vs_single_stage"]["coserved"],
          f"5g: batch-1 outputs differ: time-sliced {sliced_differ}, co-served {mm1_differ}")
    check(mm1_stop is None, f"5g: the batch-1 co-served server's stop() raised {mm1_stop}")
    check(alt.plans() != part0.plans(), "5g: the swap's partition changes no model's plan")
    check(lost == 0 and not swap_differ, f"5g swap: {lost} lost, {swap_differ[:8]} differ")
    check(swap_epoch == 1 and report["swap"]["store_holds_new"],
          f"5g swap: epoch {swap_epoch}, store {None if stored is None else stored.notation()}")
    check(not back_differ and stop_error is None, f"5g swaps: {back_differ[:8]} differ, stop() raised {stop_error}")
    check(after_swaps[-1] <= after_swaps[0] + epoch_bytes,
          f"5g: reserved memory grew across the swaps {after_swaps} (one epoch {epoch_bytes})")
    check(resume_calls == 0 and resumed.plans() == alt.plans(),
          f"5g resume: {resume_calls} partition_search calls, resumed {resumed.notation()}")
    check(not any(resume_differ.values()) and resume_stop is None,
          f"5g resume: {resume_differ}, stop() raised {resume_stop}")
    check(loop["monitor_error"] is None and loop_stop is None and not loop_differ,
          f"5g adaptive: monitor error {loop['monitor_error']}, stop() raised {loop_stop}, "
          f"{loop_differ[:8]} differ")
    return path_launches, {"registry": mm.registry, "single": single, "steady_windows": windows}


class Arrivals:
    """``images`` cycled over the ``n`` arrivals of a trace, indexed as
    ``run_open_loop`` indexes them (``images[z % len(images)]``; with a
    length of ``n`` that is ``z`` itself): remembers the last index read."""

    def __init__(self, images, n):
        self.images, self.n, self.z = images, n, None

    def __len__(self):
        return self.n

    def __getitem__(self, z):
        self.z = z
        return self.images[z % len(self.images)]


class Recording:
    """A server seen through ``run_open_loop``'s interface (which returns
    only a report): each submit is passed on, and its arrival index, the
    time of the call, how long the call held the pacing thread and its
    ticket are recorded."""

    def __init__(self, server, arrivals):
        self.server, self.arrivals = server, arrivals
        self.attempts, self.tickets, self.held = [], [], []

    def ingress_depth(self):
        return self.server.ingress_depth()

    def set_batching(self, **kw):
        self.server.set_batching(**kw)

    def submit(self, image, *, block=True):
        z, t = self.arrivals.z, time.perf_counter()
        self.attempts.append((z, t))
        try:
            ticket = self.server.submit(image, block=block)
        finally:
            self.held.append(time.perf_counter() - t)
        self.tickets.append((z, ticket))
        return ticket


def open_loop(torch, serve, images, params, want, vgg_img_per_s):
    """Phase 5h: VGG-16 under open-loop arrivals.  Phase 4's ``cuda_fused``
    graph server (``hikey970()``'s plan, micro-batch BATCH, phase 4's
    weights; an ingress of OPEN_LOOP_QUEUE_DEPTH micro-batches, a flush
    timeout of OPEN_LOOP_FLUSH_S) takes seeded traces through
    ``run_open_loop`` at shares of phase 4's mean steady img/s in this run:
    Poisson at 0.5x and 0.85x (OPEN_LOOP_ARRIVALS each), an MMPP (calm
    0.3x, bursts 1.2x, mean dwells 0.5 s and 0.2 s, MMPP_S seconds), and
    the same MMPP behind a ``QueueController`` whose SLO is twice the 0.5x
    run's p99.  Gated: every submitted ticket completes, bitwise equal to
    phase 4's output for its image; nothing is shed at 0.5x; 13 + 3
    launches and one graph launch a stage per micro-batch.  Recorded, not
    gated: the latencies, goodput, sheds, how late each submission left
    behind its trace time (the pacing thread shares the interpreter lock
    with the workers) and how long each ``submit()`` held it (a host
    image crosses to the card in stage 0, not in ``submit()``).  The
    objects the earlier phases left are
    collected and frozen first (``gc.freeze``), so that no full pass of
    the collector over them stalls the pacing thread and the workers
    inside a timed run; each run records the collections that ran in it
    and the longest.  Returns the B1 and B2 launches of its runs."""
    import gc

    from repro_torch.kernels import runtime
    from repro_torch.serving import (QueueController, QueuePolicy, mmpp_trace, percentile, poisson_trace,
                                     run_open_loop)

    rate = sum(vgg_img_per_s) / len(vgg_img_per_s)
    server = serve("vgg16", backend="cuda_fused", batch_size=BATCH, params=params, device=DEVICE,
                   queue_depth=OPEN_LOOP_QUEUE_DEPTH, flush_timeout_s=OPEN_LOOP_FLUSH_S)
    n_stages = len(server.plan.allocation)
    runs = []

    gc_pauses, gc_started = [], [0.0]  # the milliseconds of each collection while the runs go

    def on_gc(phase, info):
        if phase == "start":
            gc_started[0] = time.perf_counter()
        else:
            gc_pauses.append((time.perf_counter() - gc_started[0]) * 1e3)

    def drive(name, trace, controller=None):
        arrivals = Arrivals(images, trace.n)
        rec = Recording(server, arrivals)
        st0 = server.metrics.stages[0].snapshot()
        runtime.reset_launches()
        n_gc = len(gc_pauses)
        t_start = time.perf_counter()
        report = run_open_loop(rec, trace, arrivals, controller=controller, result_timeout_s=600)
        run_gc = gc_pauses[n_gc:]
        counts, graph_launches = runtime.launch_counts(), runtime.graph_launches()
        st1 = server.metrics.stages[0].snapshot()
        batches = st1["batches"] - st0["batches"]
        failed, differ = 0, []
        for z, ticket in rec.tickets:
            try:
                out = ticket.result(timeout=600).cpu()
            except Exception:  # noqa: BLE001 — a failed ticket is a lost one
                failed += 1
                continue
            if not torch.equal(out, want[z % len(want)]):
                differ.append(z)
        late = [t - (t_start + trace.times[z]) for z, t in rec.attempts]
        row = {
            "run": name, "kind": trace.kind, "offered": report.offered,
            "offered_img_per_s": trace.offered_rate(), "submitted": report.submitted,
            "completed": report.completed, "tickets_recorded": len(rec.tickets),
            "shed_admission": report.shed_admission, "shed_backpressure": report.shed_backpressure,
            "failed": failed, "not_bitwise": differ[:8], "n_not_bitwise": len(differ),
            "latency_p50_ms": report.latency_p50_s * 1e3, "latency_p95_ms": report.latency_p95_s * 1e3,
            "latency_p99_ms": report.latency_p99_s * 1e3, "goodput_img_per_s": report.goodput,
            "duration_s": report.duration_s,
            "lateness_p50_ms": percentile(late, 50) * 1e3, "lateness_p99_ms": percentile(late, 99) * 1e3,
            "lateness_max_ms": max(late) * 1e3 if late else None,
            "submit_p99_ms": percentile(rec.held, 99) * 1e3, "submit_max_ms": max(rec.held, default=0.0) * 1e3,
            "gc_collections": len(run_gc), "gc_max_pause_ms": max(run_gc, default=0.0),
            "micro_batches": batches,
            "mean_fill": (st1["items"] - st0["items"]) / (BATCH * batches) if batches else None,
            "launches": {k: counts[k] for k in ("conv2d_fused", "matmul_fused")},
            "graph_launches": graph_launches,
            "launches_per_micro_batch_ok": (counts["conv2d_fused"] == 13 * batches
                                            and counts["matmul_fused"] == 3 * batches
                                            and graph_launches == n_stages * batches),
        }
        runs.append(row)
        return row

    mmpp = {"duration_s": MMPP_S, "calm_s": 0.5, "burst_s": 0.2}
    ctrl_meta = {}
    gc.collect()
    gc.freeze()
    frozen = gc.get_freeze_count()
    gc.callbacks.append(on_gc)
    try:
        base = drive("poisson_0.5x", poisson_trace(0.5 * rate, n=OPEN_LOOP_ARRIVALS, seed=SEED))
        drive("poisson_0.85x", poisson_trace(0.85 * rate, n=OPEN_LOOP_ARRIVALS, seed=SEED + 1))
        drive("mmpp", mmpp_trace(0.3 * rate, 1.2 * rate, seed=SEED + 2, **mmpp))
        slo_s = 2.0 * base["latency_p99_ms"] / 1e3
        ctrl = QueueController(QueuePolicy(slo_p99_s=slo_s), base_latency_s=base["latency_p50_ms"] / 1e3,
                               service_s=1.0 / rate)
        row = drive("mmpp_queue_controller", mmpp_trace(0.3 * rate, 1.2 * rate, seed=SEED + 2, **mmpp), ctrl)
        ctrl_meta = {"slo_p99_ms": slo_s * 1e3, "base_latency_ms": ctrl.base_latency_s * 1e3,
                     "service_ms": ctrl.service_s * 1e3, "admitted": ctrl.admitted, "shed": ctrl.shed,
                     "last_flush_timeout_ms": server.flush_timeout_s * 1e3,
                     "p99_within_slo": row["latency_p99_ms"] <= slo_s * 1e3}
        server.set_batching(flush_timeout_s=OPEN_LOOP_FLUSH_S)
    finally:
        gc.callbacks.remove(on_gc)
        gc.unfreeze()
        stop_error = stop_quietly(server)
    report = {
        "model": "vgg16", "backend": "cuda_fused", "plan": server.plan.notation(), "batch": BATCH,
        "queue_depth": OPEN_LOOP_QUEUE_DEPTH, "ingress_images": OPEN_LOOP_QUEUE_DEPTH * BATCH,
        "flush_timeout_ms": OPEN_LOOP_FLUSH_S * 1e3, "phase4_mean_steady_img_per_s": rate,
        "mmpp": {"calm": 0.3, "burst": 1.2, **mmpp}, "queue_controller": ctrl_meta, "runs": runs,
        "gc_frozen_objects": frozen, "stop_error": stop_error,
    }
    print(json.dumps({"open_loop_5h": report}))
    for row in runs:
        check(row["failed"] == 0 and row["completed"] == row["submitted"] == row["tickets_recorded"],
              f"5h {row['run']}: {row['failed']} failed, {row['completed']} of {row['submitted']} completed")
        check(not row["not_bitwise"], f"5h {row['run']}: outputs of arrivals {row['not_bitwise']} differ "
              "from phase 4's")
        check(row["launches_per_micro_batch_ok"],
              f"5h {row['run']}: {row['launches']} and {row['graph_launches']} graph launches over "
              f"{row['micro_batches']} micro-batches, want 13 + 3 and {n_stages} each")
    check(runs[0]["shed_admission"] == runs[0]["shed_backpressure"] == 0,
          f"5h: the 0.5x run shed {runs[0]['shed_admission']} + {runs[0]['shed_backpressure']}")
    check(stop_error is None, f"5h: stop() raised {stop_error}")
    return {k: sum(row["launches"][k] for row in runs) for k in ("conv2d_fused", "matmul_fused")}


def fleet(torch, images, tuner, coserved):
    """Phase 5i: a two-board fleet of VGG-16 and MobileNet on the card.
    Both boards are ``host_platform(4)`` (they share the one card, as the
    reference's boards share one host); the time matrices come from phase
    5's tuner, the routes measured under ``cuda_fused`` (5g's).
    ``fleet_search(replicas={"vgg16": 2, "mobilenet": 2})``, then
    ``verify_placement``; a ``FleetRouter`` (``cuda_fused`` graphs,
    micro-batch BATCH, 5g's registry) warmed up, with every ``Captured``
    graph counted by the thread that captured it.  Served: three windows of
    FLEET_IMAGES a model, both models fed at once from a thread each;
    FLEET_CYCLES times the seeded victim (``FaultPlan.seeded_board_cycle(11,
    ...)``) fails from a thread in the middle of a window, then rejoins, and
    a window follows; the fleet is moved to one replica a model
    (``apply_plan``), and ``FleetAutoscaler.step()`` runs in the middle of a
    window; ``apply_plan`` with the same plan; a last window.  Gated: no
    ticket lost or failed, each client ticket resolved once, every output
    bitwise equal to its model's single-stage engine (5g's), 13 + 3 and 14 +
    1 launches and one graph launch a stage per micro-batch (steady and last
    windows), no graph captured by a stage worker, the same plan leaves
    every board's generation as it was, and the reserved memory after the
    last cycle no higher than after the first plus one board's epoch.
    Returns the B1 and B2 launches of its counted windows."""
    import gc
    import threading

    from repro_torch.core import BoardSpec, fleet_search, verify_placement
    from repro_torch.kernels import graphs as graphs_mod
    from repro_torch.kernels import runtime
    from repro_torch.kernels.backend import resolve_backend
    from repro_torch.serving import AutoPlanner, FaultPlan, FleetAutoscaler, FleetRouter, host_platform

    names = ("vgg16", "mobilenet")
    per_batch = {"vgg16": (13, 3), "mobilenet": (14, 1)}
    reg, single = coserved["registry"], coserved["single"]
    plat = host_platform(4)
    boards = (BoardSpec("b0", plat), BoardSpec("b1", plat))
    Ts = AutoPlanner(platform=plat, measured=tuner.route_seconds("cuda_fused")).time_matrices(reg.graphs())
    plan22 = fleet_search(Ts, boards, replicas={"vgg16": 2, "mobilenet": 2})
    verdicts = verify_placement(plan22, Ts)
    plan11 = fleet_search(Ts, boards, replicas={"vgg16": 1, "mobilenet": 1})
    kb = resolve_backend("cuda_fused", tuner=tuner)
    victim = FaultPlan.seeded_board_cycle(11, [b.name for b in boards]).events[0].board
    path_launches = {"conv2d_fused": 0, "matmul_fused": 0}

    captured_on = []
    real_captured = graphs_mod.Captured

    class Counting(real_captured):
        def __init__(self, *a, **kw):
            captured_on.append(threading.current_thread().name)
            super().__init__(*a, **kw)

    def window(router, n_img, during=None):
        """One window: a thread a model submits ``n_img`` images (blocking
        fleet submits, ``images`` cycled) and waits for them; ``during()``
        runs on this thread once half the images are submitted."""
        tickets, done = {n: [] for n in names}, {}

        def feed(n):
            t1 = time.perf_counter()
            for i in range(n_img):
                tickets[n].append((i, router.submit(n, images[i % len(images)], timeout=600)))
            for _, t in tickets[n]:
                try:
                    t.result(timeout=600)
                except Exception:  # noqa: BLE001 — counted below
                    pass
            done[n] = time.perf_counter() - t1

        threads = [threading.Thread(target=feed, args=(n,), daemon=True) for n in names]
        t1 = time.perf_counter()
        for t in threads:
            t.start()
        if during is not None:
            while (sum(len(v) for v in tickets.values()) < len(names) * n_img // 2
                   and any(t.is_alive() for t in threads)):
                time.sleep(0.001)
            during()
        for t in threads:
            t.join(timeout=900)
        wall = time.perf_counter() - t1
        check(sorted(done) == sorted(names), f"5i: a window's feeder failed ({sorted(done)})")
        lost, differ = 0, []
        for n in names:
            lost += n_img - len(tickets[n])
            for i, t in tickets[n]:
                try:
                    out = t.result(timeout=0).cpu()
                except Exception:  # noqa: BLE001 — a failed ticket is a lost one
                    lost += 1
                    continue
                if not torch.equal(out, single[n][i % len(images)]):
                    differ.append((n, i))
        return {"seconds": wall, "aggregate_img_per_s": len(names) * n_img / wall,
                **{f"{n}_img_per_s": n_img / done[n] for n in names},
                "lost": lost, "n_not_bitwise": len(differ), "not_bitwise": differ[:8]}

    def servers(router):
        """Every (board, model) -> its live inner server."""
        return {(b, n): srv for b, st in router._boards.items() if st.server is not None
                for n, srv in st.server.servers.items()}

    def counted(router, fn):
        """``fn()`` with the launch counts set to 0 just before and read just
        after, against the micro-batches every live inner server ran."""
        b0 = {k: srv.metrics.stages[0].snapshot()["batches"] for k, srv in servers(router).items()}
        runtime.reset_launches()
        out = fn()
        counts, graph_launches = runtime.launch_counts(), runtime.graph_launches()
        nb = {k: srv.metrics.stages[0].snapshot()["batches"] - b0.get(k, 0)
              for k, srv in servers(router).items()}
        want_conv = sum(per_batch[n][0] * v for (_, n), v in nb.items())
        want_fc = sum(per_batch[n][1] * v for (_, n), v in nb.items())
        want_graphs = sum(len(servers(router)[k].plan.allocation) * v for k, v in nb.items())
        ok = (counts["conv2d_fused"] == want_conv and counts["matmul_fused"] == want_fc
              and graph_launches == want_graphs)
        for k in path_launches:
            path_launches[k] += counts[k]
        return out, {"micro_batches": {f"{b}/{n}": v for (b, n), v in nb.items()},
                     "conv2d_fused": counts["conv2d_fused"], "matmul_fused": counts["matmul_fused"],
                     "graph_launches": graph_launches, "per_micro_batch_ok": ok}

    graphs_mod.Captured = Counting
    try:
        r0 = baseline_bytes(torch)
        router = FleetRouter(reg, plan22, backend=kb, batch_size=BATCH, boards=boards, device=DEVICE)
        router.start()
        try:
            t0 = time.perf_counter()
            router.warmup()
            warmup_s = time.perf_counter() - t0
            warm_captures = len(captured_on)
            fleet_bytes = baseline_bytes(torch) - r0
            steady, steady_counts = counted(router, lambda: [window(router, FLEET_IMAGES)
                                                              for _ in range(STEADY_REPS)])
            cycles, board_bytes = [], None
            for c in range(FLEET_CYCLES):
                loss = {}

                def lose():
                    def run():
                        t2 = time.perf_counter()
                        loss["redispatched"] = router.fail_board(victim)
                        loss["fail_board_s"] = time.perf_counter() - t2

                    loss["thread"] = threading.Thread(target=run, daemon=True)
                    loss["thread"].start()

                w_loss = window(router, FLEET_IMAGES, during=lose)
                loss["thread"].join(timeout=600)
                check(not loss["thread"].is_alive() and "redispatched" in loss,
                      f"5i cycle {c}: fail_board did not finish")
                after_loss = router.metrics()["boards"][victim]
                if c == 0:
                    # what one full collection costs at this heap (fail_board
                    # runs one to free the lost board; nothing is left here)
                    t1 = time.perf_counter()
                    gc.collect()
                    gc_collect_s = time.perf_counter() - t1
                    r_loss = baseline_bytes(torch)
                n_cap = len(captured_on)
                t1 = time.perf_counter()
                router.rejoin_board(victim)
                rejoin_s = time.perf_counter() - t1
                if c == 0:
                    board_bytes = baseline_bytes(torch) - r_loss
                w_after = window(router, FLEET_IMAGES)
                cycles.append({"cycle": c, "redispatched": loss["redispatched"],
                               "fail_board_s": loss["fail_board_s"],
                               "victim_alive_after_loss": after_loss["alive"], "rejoin_s": rejoin_s,
                               "rejoin_captures": len(captured_on) - n_cap, "window_with_loss": w_loss,
                               "window_after_rejoin": w_after,
                               "generation": router.metrics()["boards"][victim]["generation"],
                               "reserved_bytes": reserved_bytes(torch)})
            # ------------------------------------- autoscaling from one replica a model
            n_cap = len(captured_on)
            t1 = time.perf_counter()
            router.apply_plan(plan11)
            to_one_s = time.perf_counter() - t1
            scaler = FleetAutoscaler(router, Ts)
            scaled = {}

            def scale():
                scaled["desired"] = scaler.desired_replicas()
                t2 = time.perf_counter()
                scaled["replanned"] = scaler.step() is not None
                scaled["step_s"] = time.perf_counter() - t2

            w_scale = window(router, FLEET_IMAGES, during=scale)
            scale_captures = len(captured_on) - n_cap
            # ------------------------------------------------ hot swap, same plan
            gens = {b: d["generation"] for b, d in router.metrics()["boards"].items()}
            router.apply_plan(router.plan)
            gens_after = {b: d["generation"] for b, d in router.metrics()["boards"].items()}
            last, last_counts = counted(router, lambda: window(router, FLEET_IMAGES))
            snap = router.metrics()
        finally:
            stop_error = stop_quietly(router)
    finally:
        graphs_mod.Captured = real_captured

    windows = [*steady, *(w for c in cycles for w in (c["window_with_loss"], c["window_after_rejoin"])),
               w_scale, last]
    stage_captures = [t for t in captured_on if "-stage" in t]
    after_cycles = [c["reserved_bytes"] for c in cycles]
    report = {
        "models": list(names), "boards": [b.name for b in boards], "platform": "host_platform(4)",
        "batch": BATCH, "backend": "cuda_fused (phase 5's tuner)",
        "plan": plan22.notation(), "predicted_img_per_s_batch1": plan22.throughputs(),
        "objective": plan22.objective, "feasible": plan22.feasible,
        "verified_replicas": sorted(f"{b}/{n}" for b, n in verdicts),
        "warmup_s": warmup_s, "warmup_captures": warm_captures, "fleet_bytes": fleet_bytes,
        "steady_images_per_model": FLEET_IMAGES, "steady_windows": steady, "launches_steady": steady_counts,
        "single_board_5g_steady_windows": coserved["steady_windows"],
        "victim": victim, "cycles": cycles, "board_epoch_bytes": board_bytes, "gc_collect_s": gc_collect_s,
        "autoscale": {"from": plan11.notation(), "to_one_replica_s": to_one_s, **scaled,
                      "decisions": scaler.decisions, "window": w_scale, "captures": scale_captures,
                      "plan_after": router.plan.notation()},
        "hot_swap_same_plan": {"generations_before": gens, "generations_after": gens_after},
        "last_window": last, "launches_last": last_counts,
        "captures": len(captured_on), "captures_on_stage_workers": stage_captures[:8],
        "router": {k: snap[k] for k in ("submitted", "completed", "failed", "redispatched",
                                        "duplicates_discarded", "inflight")},
        "stop_error": stop_error,
    }
    print(json.dumps({"fleet_5i": report}))
    check(all(w["lost"] == 0 for w in windows), f"5i: tickets lost {[w['lost'] for w in windows]}")
    check(all(w["n_not_bitwise"] == 0 for w in windows),
          f"5i: outputs differ from the single-stage engines {[w['not_bitwise'] for w in windows if w['not_bitwise']]}")
    check(snap["failed"] == 0 and snap["completed"] == snap["submitted"] == len(names) * FLEET_IMAGES * len(windows)
          and snap["inflight"] == 0, f"5i: router counters {report['router']}")
    check(steady_counts["per_micro_batch_ok"] and last_counts["per_micro_batch_ok"],
          f"5i: launches {steady_counts}, {last_counts}; want 13 + 3 and 14 + 1 a micro-batch")
    check(warm_captures > 0 and not stage_captures, f"5i: graphs captured on stage workers {stage_captures[:8]}")
    check(all(not c["victim_alive_after_loss"] for c in cycles), "5i: the victim stayed alive after fail_board")
    check(gens == gens_after, f"5i: the same plan rebuilt boards: {gens} -> {gens_after}")
    check(after_cycles[-1] <= after_cycles[0] + board_bytes,
          f"5i: reserved memory grew across the cycles {after_cycles} (one board {board_bytes})")
    check(stop_error is None, f"5i: stop() raised {stop_error}")
    return path_launches


def b6_only(torch, src: str) -> int:
    """``--b6``: B6's wide form alone, from the ``repro_torch`` under
    ``src``: the card, the build of ``ssd.cu``, 6b's wide-form cases and
    the kernel's and the plain version's times on 6d's xLSTM inputs (the
    bounds and the launch are the full run's 6d row).  With ``--src``
    naming an earlier tree unpacked beside this one, the same draws run
    on that tree's kernel, so two trees compare on one card in one call."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "unknown")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels import build
    from repro_torch.kernels import ops as OPS

    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind} src {src}")
    t0 = time.perf_counter()
    build.build_all(["ssd"])
    print(f"build_s={time.perf_counter() - t0:.3f}")
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, device=dev, generator=gen) * scale).to(dtype)

    err = {"ssd": 0.0}
    cases, worst = b6_wide_cases(torch, randn, err)
    print(json.dumps({"b6_wide_cases": cases, "worst_err_over_tol": worst, "max_abs_err": err["ssd"]}))
    x, la, B, C = b6_wide_inputs(torch, randn)
    print(json.dumps({"shape": f"xLSTM served prefill {tuple(x.shape)} bf16, normalizer", "src": src,
                      "kernel_ms": device_ms(lambda: OPS.ssd(x, la, B, C, normalizer=True), torch),
                      "plain_ms": device_ms(lambda: OPS.ssd(x, la, B, C, normalizer=True, backend="torch"), torch),
                      "timer": "cuda events behind a sleep kernel (device time)"}))
    check(all(c["finite"] for c in cases), "ssd with the normalizer: an output is not finite")
    check(all(c["repeat_bitwise"] for c in cases), "ssd with the normalizer: a second call differs")
    check(worst <= 1.0, f"ssd with the normalizer exceeds its bar (err/tol {worst:.3g})")
    print(json.dumps({"b6_only": True, "src": src, "device": kind}))
    return 0


B1_BATCHES = (1, 4, 32)  # --b1: the fused conv at the open-loop, smoke and benchmark micro-batches


def b1_only(torch, src: str) -> int:
    """``--b1``: csrc/gemm.cu's three entries alone at VGG-16's shapes, from
    the ``repro_torch`` under ``src``: B1 (the fused conv) at every conv at
    batch 1, 4 and 32, B2 (the fused fc) at batch 4 (the skinny path) and
    32 (the tiled one), B3 (the GEMM) at every conv GEMM and fc at batch 4.
    Each call is held to its plain version's tolerance and timed as device
    time; beside it the f32 CUDA cores' bound and the tensor-core order's
    (TF32 at half the bf16 rate, three products a multiply-add), each the
    larger of its operations' and the bytes' time.  With ``--src`` naming
    an earlier tree unpacked beside this one, the same draws run on that
    tree's kernels, so two trees compare on one card in one call."""
    import numpy as np

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "unknown")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.cnn.models import MODELS
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import conv_fused as K
    from repro_torch.kernels import gemm as G

    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind} src {src}")
    t0 = time.perf_counter()
    build.build_all(["gemm", "im2col"])
    print(f"build_s={time.perf_counter() - t0:.3f}")
    flops_peak, bytes_peak, _, bf16_peak = peaks(kind)
    tc_peak = bf16_peak / 2 / TC_SPLIT_PRODUCTS
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 17)
    vgg = MODELS["vgg16"]()
    shapes = vgg.infer_shapes()
    totals, worst = {}, 0.0

    def row(kernel, where, batch, fn, y, ref, flops, nbytes):
        nonlocal worst
        err, ratio = tol_ok(y, ref)
        worst = max(worst, ratio)
        r = {"kernel": kernel, "shape": where, "batch": batch, "kernel_ms": device_ms(fn, torch),
             "f32_cuda_core_bound_ms": max(flops / flops_peak, nbytes / bytes_peak) * 1e3,
             "tensor_core_bound_ms": max(flops / tc_peak, nbytes / bytes_peak) * 1e3,
             "byte_bound_ms": nbytes / bytes_peak * 1e3, "max_abs_err": err, "err_over_tol": ratio}
        print(json.dumps({"b1": r}))
        t = totals.setdefault(f"{kernel} batch {batch}", {"kernel_ms": 0.0, "f32_cuda_core_bound_ms": 0.0,
                                                          "tensor_core_bound_ms": 0.0, "layers": 0})
        for key in ("kernel_ms", "f32_cuda_core_bound_ms", "tensor_core_bound_ms"):
            t[key] += r[key]
        t["layers"] += 1

    for node in vgg.major_nodes():
        hin = shapes[node.inputs[0]]
        relu = node.attrs.get("act") == "relu"
        where = f"vgg16:{node.name}"
        if node.kind == "conv":
            h, w, c = hin
            fk, st, pd, cout = node.attrs["kernel"], node.attrs["stride"], node.attrs["pad"], node.attrs["out_ch"]
            wt = torch.randn(fk, fk, c, cout, device=dev, generator=gen) * (2.0 / (fk * fk * c)) ** 0.5
            b = torch.randn(cout, device=dev, generator=gen) * 0.1
            for batch in B1_BATCHES:
                x = torch.randn(batch, h, w, c, device=dev, generator=gen)
                y = K.conv2d_fused(x, wt, b, stride=st, pad=pd, relu=relu)
                flops = 2.0 * y.shape[0] * y.shape[1] * y.shape[2] * cout * fk * fk * c
                nbytes = 4.0 * (x.numel() + wt.numel() + 2 * cout + y.numel())
                row("conv2d_fused", where, batch, lambda: K.conv2d_fused(x, wt, b, stride=st, pad=pd, relu=relu),
                    y, K.fused_route_ref(x, wt, b, stride=st, pad=pd, relu=relu), flops, nbytes)
                if batch == BATCH:
                    cols, w2 = ops.im2col_batched(x, fk, fk, st, pd), wt.reshape(fk * fk * c, cout)
                    yg = ops.gemm(cols, w2)
                    row("gemm", where, batch, lambda: ops.gemm(cols, w2), yg, G.gemm_ref(cols, w2), flops,
                        4.0 * (cols.numel() + w2.numel() + yg.numel()))
                    del cols, yg
                del x, y
        else:
            k, n = int(np.prod(hin)), node.attrs["out_features"]
            wt = torch.randn(k, n, device=dev, generator=gen) * (1.0 / k) ** 0.5
            b = torch.randn(n, device=dev, generator=gen) * 0.1
            for batch in (BATCH, 32):
                a = torch.randn(batch, k, device=dev, generator=gen)
                y = K.matmul_fused(a, wt, b, relu=relu)
                nbytes = 4.0 * (a.numel() + wt.numel() + 2 * n + y.numel())
                row("matmul_fused", where, batch, lambda: K.matmul_fused(a, wt, b, relu=relu),
                    y, K.matmul_fused_ref(a, wt, b, relu=relu), 2.0 * batch * k * n, nbytes)
                if batch == BATCH:
                    yg = ops.gemm(a, wt)
                    row("gemm", where, batch, lambda: ops.gemm(a, wt), yg, G.gemm_ref(a, wt), 2.0 * batch * k * n,
                        4.0 * (a.numel() + wt.numel() + yg.numel()))
    torch.cuda.synchronize()
    print(json.dumps({"b1_totals": totals, "src": src, "device": kind, "worst_err_over_tol": worst,
                      "timer": "cuda events behind a sleep kernel (device time)"}))
    check(worst <= 1.0, f"--b1: a kernel exceeds its tolerance (err/tol {worst:.3g})")
    print(json.dumps({"b1_only": True, "src": src, "device": kind}))
    return 0


def main() -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description="Smoke run of the PyTorch/CUDA port on one NVIDIA card.")
    ap.add_argument("--b6", action="store_true",
                    help="only B6's wide form: 6b's wide-form cases and 6d's xLSTM row")
    ap.add_argument("--b1", action="store_true",
                    help="only csrc/gemm.cu's entries (B1, B2, B3) at VGG-16's shapes, timed beside their bounds")
    ap.add_argument("--src", default=SRC,
                    help="the directory holding repro_torch (with --b6 or --b1; default: this checkout's src)")
    args = ap.parse_args()
    src = os.path.abspath(args.src)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; needs a CUDA card",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print(f"chip_smoke: {src}/repro_torch not found; run from a checkout",
              file=sys.stderr)
        return 2
    sys.path.insert(0, src)
    if args.b6:
        return b6_only(torch, src)
    if args.b1:
        return b1_only(torch, src)
    import numpy as np
    import torch.nn.functional as F

    from repro_torch.cnn import quant as Q
    from repro_torch.cnn.models import MODELS
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import conv_fused as K
    from repro_torch.kernels import gemm as G
    from repro_torch.kernels import im2col as I
    from repro_torch.kernels.backend import resolve_backend
    from repro_torch.serving import SingleStageEngine, serve

    t_start = time.perf_counter()

    def mark(phase):  # wall time so far, to keep the run inside its limit
        print(json.dumps({"phase_done": phase, "elapsed_s": time.perf_counter() - t_start}))

    # ---------------------------------------------------------- 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    card_line = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "unknown"
    print(card_line)
    kind = torch.cuda.get_device_name(0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}")
    flops_peak, bytes_peak, int8_peak, bf16_peak = peaks(kind)
    int_ops_peak = flops_peak / 2
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED)

    # ---------------------------------------------------------- 2. build
    t0 = time.perf_counter()
    libs = build.build_all()
    print(f"build_s={time.perf_counter() - t0:.3f} libs={[os.path.basename(p) for p in libs]}")

    mark("2")

    # ------------------------------------------- 3a. correctness, all nets
    convs, fcs, all_convs = {}, [], {}
    for net, make in sorted(MODELS.items()):
        for d in make().descriptors():
            if d.kind == "conv" and d.groups == 1:
                convs.setdefault(
                    (d.i_h, d.i_w, d.i_d, d.f_h, d.f_w, d.stride, d.pad, d.ofm), f"{net}:{d.name}"
                )
            elif d.kind == "fc":
                fcs.append((d.i_w * d.i_h * d.i_d, d.ofm, f"{net}:{d.name}"))
            if d.kind == "conv":  # the patch matrix of each group
                all_convs.setdefault(
                    (d.i_h, d.i_w, d.i_d // d.groups, d.f_h, d.f_w, d.stride, d.pad), f"{net}:{d.name}"
                )
    worst = {"conv2d_fused": (0.0, 0.0, ""), "matmul_fused": (0.0, 0.0, "")}
    for (h, w, c, fh, fw, st, pd, cout), where in convs.items():
        x = torch.randn(1, h, w, c, device=dev, generator=gen)
        wt = torch.randn(fh, fw, c, cout, device=dev, generator=gen) * (2.0 / (fh * fw * c)) ** 0.5
        b = torch.randn(cout, device=dev, generator=gen) * 0.1
        y = K.conv2d_fused(x, wt, b, stride=st, pad=pd, relu=True)
        r = K.fused_route_ref(x, wt, b, stride=st, pad=pd, relu=True)
        err, ratio = tol_ok(y, r)
        check(bool(torch.isfinite(y).all()), f"conv2d_fused non-finite at {where}")
        if ratio >= worst["conv2d_fused"][1]:
            worst["conv2d_fused"] = (err, ratio, where)
    for k, n, where in fcs:
        a = torch.randn(1, k, device=dev, generator=gen)
        wt = torch.randn(k, n, device=dev, generator=gen) * (1.0 / k) ** 0.5
        b = torch.randn(n, device=dev, generator=gen) * 0.1
        y = K.matmul_fused(a, wt, b, relu=True)
        r = K.matmul_fused_ref(a, wt, b, relu=True)
        err, ratio = tol_ok(y, r)
        if ratio >= worst["matmul_fused"][1]:
            worst["matmul_fused"] = (err, ratio, where)
    torch.cuda.synchronize()
    print(json.dumps({
        "correctness": {
            "conv2d_fused": {"shapes": len(convs), "max_abs_err": worst["conv2d_fused"][0],
                             "worst_err_over_tol": worst["conv2d_fused"][1],
                             "worst_at": worst["conv2d_fused"][2]},
            "matmul_fused": {"shapes": len(fcs), "max_abs_err": worst["matmul_fused"][0],
                             "worst_err_over_tol": worst["matmul_fused"][1],
                             "worst_at": worst["matmul_fused"][2]},
            "tolerance": f"|y-r| <= {RTOL}*|r| + {ATOL}*max(1, max|r|)",
        }
    }))
    for name, (_, ratio, where) in worst.items():
        check(ratio <= 1.0, f"{name} exceeds tolerance at {where} (err/tol {ratio:.3g})")

    mark("3a")

    # --------------------------- 3c. correctness of B4, B3, B1q, all nets
    # B4 at batch 1 and 4 (spans of runs cross images) and the library
    # yardstick; AlexNet's sliced convs as the channel-slice views the
    # served graph hands over
    im2col_bad, im2col_paths = [], {"wide": 0, "staged": 0}
    for (h, w, c, fh, fw, st, pd), where in all_convs.items():
        for bsz in (1, BATCH):
            x = torch.randn(bsz, h, w, c, device=dev, generator=gen)
            r = I.im2col_ref(x, fh, fw, st, pd)
            im2col_paths["wide" if I.wide_path(x) else "staged"] += 1
            if not torch.equal(ops.im2col_batched(x, fh, fw, st, pd), r):
                im2col_bad.append(f"{where} batch {bsz}")
            if not torch.equal(I.im2col_library(x, fh, fw, st, pd), r):
                im2col_bad.append(f"{where} batch {bsz} im2col_library")
            del r
    alex = MODELS["alexnet"]()
    alex_shapes, by_name = alex.infer_shapes(), {nd.name: nd for nd in alex.nodes}
    sliced = [(nd, by_name[nd.inputs[0]]) for nd in alex.nodes
              if nd.kind == "conv" and nd.inputs[0] in by_name and by_name[nd.inputs[0]].kind == "slice"]
    for nd, sl in sliced:
        h, w, pitch = alex_shapes[sl.inputs[0]]
        fk, st, pd = nd.attrs["kernel"], nd.attrs["stride"], nd.attrs["pad"]
        for bsz in (1, BATCH):
            view = torch.randn(bsz, h, w, pitch, device=dev, generator=gen)[..., sl.attrs["lo"]:sl.attrs["hi"]]
            before = K.launch_counts()["im2col"]
            cols = ops.im2col_batched(view, fk, fk, st, pd)
            if K.launch_counts()["im2col"] != before + 1 or not I.wide_path(view) or not (
                torch.equal(cols, I.im2col_ref(view, fk, fk, st, pd))
                and torch.equal(cols, ops.im2col_batched(view.contiguous(), fk, fk, st, pd))
            ):
                im2col_bad.append(f"alexnet:{nd.name} channel-slice view batch {bsz}")
            del cols
    gemm_shapes = [
        (((h - fh + 2 * pd) // st + 1) * ((w - fw + 2 * pd) // st + 1), fh * fw * c, cout, where)
        for (h, w, c, fh, fw, st, pd, cout), where in convs.items()
    ] + [(1, k, n, where) for k, n, where in fcs]
    gemm_worst = (0.0, 0.0, "")
    for m, k, n, where in gemm_shapes:
        a = torch.randn(m, k, device=dev, generator=gen)
        wt = torch.randn(k, n, device=dev, generator=gen) * (1.0 / k) ** 0.5
        err, ratio = tol_ok(ops.gemm(a, wt), G.gemm_ref(a, wt))
        if ratio >= gemm_worst[1]:
            gemm_worst = (err, ratio, where)
    qconv_bad = []
    for (h, w, c, fh, fw, st, pd, cout), where in convs.items():
        x = torch.randn(1, h, w, c, device=dev, generator=gen)
        wt = torch.randn(fh, fw, c, cout, device=dev, generator=gen) * (2.0 / (fh * fw * c)) ** 0.5
        b = torch.randn(cout, device=dev, generator=gen) * 0.1
        qp = Q.quantize_graph_params({"l": {"w": wt, "b": b}})["l"]
        args = (qp["qw"], qp["scale"], qp["zp"], qp["b"], qp["shape"])
        y = K.qconv2d_fused(x, *args, stride=st, pad=pd, relu=True)
        if not torch.equal(y, K.qfused_route_ref(x, *args, stride=st, pad=pd, relu=True)):
            qconv_bad.append(where)
    torch.cuda.synchronize()
    print(json.dumps({
        "correctness_unfused_and_quantized": {
            "im2col": {"geometries": len(all_convs), "batches": [1, BATCH], "paths": im2col_paths,
                       "alexnet_slice_views": [nd.name for nd, _ in sliced], "not_bitwise": im2col_bad},
            "gemm": {"shapes": len(gemm_shapes), "max_abs_err": gemm_worst[0],
                     "worst_err_over_tol": gemm_worst[1], "worst_at": gemm_worst[2]},
            "qconv2d_fused": {"geometries": len(convs), "not_bitwise": qconv_bad},
        }
    }))
    check(not im2col_bad, f"im2col differs from its plain version at {im2col_bad[:5]}")
    check(gemm_worst[1] <= 1.0, f"gemm exceeds tolerance at {gemm_worst[2]} (err/tol {gemm_worst[1]:.3g})")
    check(not qconv_bad, f"qconv2d_fused differs from its plain version at {qconv_bad[:5]}")

    mark("3c")

    # ---------------------------------- 3b, 3d. timing, VGG-16 at batch 4
    vgg = MODELS["vgg16"]()
    shapes = vgg.infer_shapes()
    totals = {n: {"ms": 0.0, "host_paced_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
                  "flop_ms": 0.0, "byte_ms": 0.0, "max_abs_err": 0.0} for n in KERNELS}
    not_bitwise = []  # 3d's bitwise checks of B1, B2, B3, B4
    layer_rows = {}  # each kernel's 3d rows, in layer order

    def route_bound(order, flops, byte_ms):
        """The operations' bound on the units csrc/gemm.cu's ``order`` runs
        them on, and beside it the f32 CUDA cores' bound (the larger of
        their operations' time and the bytes')."""
        f32_ms = flops / flops_peak * 1e3
        op_ms = flops / (bf16_peak / 2 / TC_SPLIT_PRODUCTS) * 1e3 if order else f32_ms
        return {"op_ms": op_ms, "extra": {"order": order, "f32_cuda_core_bound_ms": max(f32_ms, byte_ms)}}

    def record(name, where, kern, plain, lib, y, r, op_ms, byte_ms, exact=False, **extra):
        err, ratio = tol_ok(y, r)
        if exact:
            check(bool(torch.equal(y, r)), f"{name} differs from its plain version at {where}")
        else:
            check(ratio <= 1.0, f"{name} exceeds tolerance at {where} batch {BATCH}")
        row = {
            "shape": where, "kernel": name, "batch": BATCH, "timer": "device_ms",
            "kernel_ms": device_ms(kern, torch), "plain_ms": device_ms(plain, torch),
            "library_ms": None if lib is None else device_ms(lib, torch),
            "host_paced_ms": {"kernel": time_ms(kern, torch), "plain": time_ms(plain, torch),
                              "library": None if lib is None else time_ms(lib, torch)},
            "flop_bound_ms": op_ms, "byte_bound_ms": byte_ms,
            "max_abs_err": err, "err_over_tol": ratio,
            "tolerance": "bitwise" if exact else f"rtol={RTOL}, atol={ATOL}*max(1,max|r|)",
            **extra,
        }
        row["bound_ms"] = max(op_ms, byte_ms)
        row["bound_by"] = "operations" if op_ms >= byte_ms else "bytes"
        print(json.dumps(row))
        t = totals[name]
        layer_rows.setdefault(name, []).append(row)
        for key in EXTRA_TOTALS:
            if key in extra:
                t[key] = t.get(key, 0.0) + extra[key]
        t["max_abs_err"] = max(t["max_abs_err"], err)
        t["ms"] += row["kernel_ms"]
        t["host_paced_ms"] += row["host_paced_ms"]["kernel"]
        t["plain_ms"] += row["plain_ms"]
        t["library_ms"] += row["library_ms"] or 0.0
        t["bound_ms"] += row["bound_ms"]
        t["flop_ms"] += op_ms
        t["byte_ms"] += byte_ms

    for node in vgg.major_nodes():
        hin = shapes[node.inputs[0]]
        relu = node.attrs.get("act") == "relu"
        where = f"vgg16:{node.name}"
        if node.kind == "conv":
            h, w, c = hin
            fk, st, pd, cout = node.attrs["kernel"], node.attrs["stride"], node.attrs["pad"], node.attrs["out_ch"]
            x = torch.randn(BATCH, h, w, c, device=dev, generator=gen)
            wt = torch.randn(fk, fk, c, cout, device=dev, generator=gen) * (2.0 / (fk * fk * c)) ** 0.5
            b = torch.randn(cout, device=dev, generator=gen) * 0.1
            xn, wn = x.permute(0, 3, 1, 2), wt.permute(3, 2, 0, 1)
            y = K.conv2d_fused(x, wt, b, stride=st, pad=pd, relu=relu)
            # B1: image 0 alone gives the bits it has in the batch of 4, and
            # so does every tile variant
            if not torch.equal(K.conv2d_fused(x[:1].contiguous(), wt, b, stride=st, pad=pd, relu=relu), y[:1]):
                not_bitwise.append(f"conv2d_fused batch 1 vs {BATCH} at {where}")
            for variant in range(G.tile_variants()):
                if not torch.equal(K.conv2d_fused_tiled(x, wt, b, variant, stride=st, pad=pd, relu=relu), y):
                    not_bitwise.append(f"conv2d_fused tile variant {variant} at {where}")
            oh, ow = y.shape[1], y.shape[2]
            m, k = BATCH * oh * ow, fk * fk * c
            flops = 2.0 * m * cout * k
            nbytes = 4.0 * (x.numel() + wt.numel() + 2 * cout + y.numel())
            route = route_bound(G.order(k, cout), flops, nbytes / bytes_peak * 1e3)
            record(
                "conv2d_fused", where,
                lambda: K.conv2d_fused(x, wt, b, stride=st, pad=pd, relu=relu),
                lambda: K.fused_route_ref(x, wt, b, stride=st, pad=pd, relu=relu),
                lambda: F.conv2d(xn, wn, b, stride=st, padding=pd),
                y, K.fused_route_ref(x, wt, b, stride=st, pad=pd, relu=relu),
                route["op_ms"], nbytes / bytes_peak * 1e3, **route["extra"],
            )
            # B4: the patch matrix of this conv, beside one PyTorch copy of
            # the same matrix (im2col_library: F.pad, then one strided copy;
            # the copy alone on the padded input beside it), bitwise equal
            cols = ops.im2col_batched(x, fk, fk, st, pd)
            cols_ref = I.im2col_ref(x, fk, fk, st, pd)
            if not torch.equal(I.im2col_library(x, fk, fk, st, pd), cols_ref):
                not_bitwise.append(f"im2col_library vs im2col_ref at {where}")
            patches = I.patch_view(F.pad(x, (0, 0, pd, pd, pd, pd)), fk, fk, st, oh, ow)
            record(
                "im2col", where,
                lambda: ops.im2col_batched(x, fk, fk, st, pd),
                lambda: I.im2col_ref(x, fk, fk, st, pd),
                lambda: I.im2col_library(x, fk, fk, st, pd),
                cols, cols_ref,
                0.0, 4.0 * (x.numel() + cols.numel()) / bytes_peak * 1e3, exact=True,
                library_copy_only_ms=device_ms(lambda: patches.reshape(m, k), torch),
                path="16-byte" if I.wide_path(x) else "staged",
            )
            del cols_ref, patches
            # B3: the conv's GEMM on that patch matrix; its first rows
            # bitwise equal to the skinny path's, and every tile variant's
            w2 = wt.reshape(k, cout)
            yg = ops.gemm(cols, w2)
            if not torch.equal(ops.gemm(cols[:BATCH].contiguous(), w2), yg[:BATCH]):
                not_bitwise.append(f"gemm tiled rows vs the skinny path's at {where}")
            for variant in range(G.tile_variants()):
                if not torch.equal(G.gemm_tiled(cols, w2, variant), yg):
                    not_bitwise.append(f"gemm tile variant {variant} at {where}")
            # B1 = the unfused route: relu(gemm(patch matrix) + b), bitwise
            unfused = yg.reshape(y.shape) + b
            if not torch.equal(torch.relu(unfused) if relu else unfused, y):
                not_bitwise.append(f"conv2d_fused vs relu(gemm(im2col) + b) at {where}")
            del unfused
            gbyte_ms = 4.0 * (cols.numel() + w2.numel() + yg.numel()) / bytes_peak * 1e3
            groute = route_bound(G.order(k, cout), flops, gbyte_ms)
            record(
                "gemm", where,
                lambda: ops.gemm(cols, w2), lambda: G.gemm_ref(cols, w2), lambda: torch.mm(cols, w2),
                yg, G.gemm_ref(cols, w2), groute["op_ms"], gbyte_ms, m=m, k=k, n=cout, **groute["extra"],
            )
            del cols, yg
            # B1q: the quantized conv at this geometry.  Timed as the kernel
            # alone on ready u8 operands (the quantized input, the filter's
            # transposed copy and column sums), beside the whole call and
            # the quantization; every tile variant gives the same bits
            qp = Q.quantize_graph_params({"l": {"w": wt, "b": b}})["l"]
            qargs = (qp["qw"], qp["scale"], qp["zp"], qp["b"], qp["shape"])
            qkw = dict(stride=st, pad=pd, relu=relu)
            yq = K.qconv2d_fused(x, *qargs, **qkw)
            qa, sa, za = Q.quantize_tensor(x, axis=None)
            wpk, colsum = K.packed_weights(qp["qw"])

            def qconv_alone():
                return K.qconv_launch(qa, sa, za, wpk, colsum, qp["scale"], qp["zp"], qp["b"], qp["shape"], **qkw)

            for variant in range(K.qconv_tile_variants()):
                if not torch.equal(K.qconv2d_fused_tiled(x, *qargs, variant, **qkw), yq):
                    not_bitwise.append(f"qconv2d_fused tile variant {variant} at {where}")
            qplain = K.qfused_route_ref(x, *qargs, **qkw)
            if not torch.equal(qconv_alone(), qplain):
                not_bitwise.append(f"qconv2d_fused kernel alone vs qfused_route_ref at {where}")
            # u8 input and filter read once, f32 output and the per-channel
            # vectors (scale, zero point, bias, column sums) written / read once
            qbytes = qa.numel() + wpk.numel() + 4.0 * (yq.numel() + 4 * cout)
            record(
                "qconv2d_fused", where, qconv_alone,
                lambda: K.qfused_route_ref(x, *qargs, **qkw), None,
                yq, qplain,
                flops / int8_peak * 1e3, qbytes / bytes_peak * 1e3, exact=True,
                whole_call_ms=device_ms(lambda: K.qconv2d_fused(x, *qargs, **qkw), torch),
                quantize_ms=device_ms(lambda: Q.quantize_tensor(x, axis=None), torch),
                pack_once_ms=device_ms(lambda: K.pack_weights(qp["qw"]), torch),
                int32_cuda_core_bound_ms=flops / int_ops_peak * 1e3,
                za=float(za),
                library_null_reason=NO_LIBRARY["qconv2d_fused"],
            )
            del yq, qa, qplain
        else:
            k = int(np.prod(hin))
            n = node.attrs["out_features"]
            a = torch.randn(BATCH, k, device=dev, generator=gen)
            wt = torch.randn(k, n, device=dev, generator=gen) * (1.0 / k) ** 0.5
            b = torch.randn(n, device=dev, generator=gen) * 0.1
            y = K.matmul_fused(a, wt, b, relu=relu)
            # B2: a row's bits at M = 1, 4, 8 (split K) and 16 (tiled), and
            # those of relu(gemm(a, w) + b)
            a16 = torch.cat([a, torch.randn(16 - BATCH, k, device=dev, generator=gen)])
            y16 = K.matmul_fused(a16, wt, b, relu=relu)
            for mm in (1, 4, 8):
                if not torch.equal(K.matmul_fused(a16[:mm].contiguous(), wt, b, relu=relu), y16[:mm]):
                    not_bitwise.append(f"matmul_fused M={mm} vs M=16 at {where}")
            for mm in (BATCH, 16):
                unfused = ops.gemm(a16[:mm].contiguous(), wt) + b
                if not torch.equal(torch.relu(unfused) if relu else unfused, y16[:mm]):
                    not_bitwise.append(f"matmul_fused M={mm} vs relu(gemm + b) at {where}")
            del a16, y16, unfused
            flops = 2.0 * BATCH * k * n
            nbytes = 4.0 * (a.numel() + wt.numel() + 2 * n + y.numel())
            route = route_bound(G.order(k, n), flops, nbytes / bytes_peak * 1e3)
            record(
                "matmul_fused", where,
                lambda: K.matmul_fused(a, wt, b, relu=relu),
                lambda: K.matmul_fused_ref(a, wt, b, relu=relu),
                lambda: torch.addmm(b, a, wt),
                y, K.matmul_fused_ref(a, wt, b, relu=relu),
                route["op_ms"], nbytes / bytes_peak * 1e3, **route["extra"],
            )
            yg = ops.gemm(a, wt)
            gbyte_ms = 4.0 * (a.numel() + wt.numel() + yg.numel()) / bytes_peak * 1e3
            groute = route_bound(G.order(k, n), flops, gbyte_ms)
            record(
                "gemm", where,
                lambda: ops.gemm(a, wt), lambda: G.gemm_ref(a, wt), lambda: torch.mm(a, wt),
                yg, G.gemm_ref(a, wt), groute["op_ms"], gbyte_ms, m=BATCH, k=k, n=n, **groute["extra"],
            )
        del y

    print(json.dumps({"im2col_layers_3d": [
        {"layer": row["shape"], "path": row["path"], "device_ms": row["kernel_ms"],
         "library_ms": row["library_ms"],
         "library_copy_only_ms": row["library_copy_only_ms"], "bound_ms": row["bound_ms"],
         "bound_share": row["bound_ms"] / row["kernel_ms"]}
        for row in layer_rows["im2col"]]}))
    print(json.dumps({"bitwise_3d": {
        "checks": "B1 batch 1 = batch 4 and every tile variant, B1 = relu(gemm(im2col) + b); "
                  "B2 rows at M = 1, 4, 8, 16 and = relu(gemm + b); B3 tiled = skinny rows, every tile variant; "
                  "B1q every tile variant and the kernel alone = qfused_route_ref; "
                  "B4's library yardstick im2col_library = im2col_ref",
        "not_bitwise": not_bitwise}}))
    check(not not_bitwise, f"bitwise checks failed: {not_bitwise[:5]}")
    print(json.dumps({"kernel_totals_3d": {
        n: {"device_ms": t["ms"], "host_paced_ms": t["host_paced_ms"], "plain_device_ms": t["plain_ms"],
            "library_device_ms": None if n in NO_LIBRARY else t["library_ms"], "bound_ms": t["bound_ms"],
            "bound_share": t["bound_ms"] / t["ms"] if t["ms"] else None,
            **{k: t[k] for k in EXTRA_TOTALS if k in t}}
        for n, t in totals.items()}}))

    mark("3b,3d")

    # ------------------------------------------------ 4. the main path
    # each route served twice on the same weights: its stage functions op
    # by op (the eager side), then as CUDA graphs (the default); the graph
    # server of cuda_fused also takes a hot swap
    rng = np.random.default_rng(SEED)
    images = [rng.standard_normal((1, 224, 224, 3)).astype(np.float32) for _ in range(N_IMAGES)]
    # all but conv1_1 (K = 27) in csrc/gemm.cu's tensor-core order (gemm.order)
    per_batch = {"cuda_fused": {"conv2d_fused": 13, "matmul_fused": 3, "conv2d_fused_tc": 12, "matmul_fused_tc": 3},
                 "cuda": {"im2col": 13, "gemm": 16, "gemm_tc": 15}}
    served_outs, served_reports, path_counts, params = {}, {}, {}, None
    for backend in ("cuda_fused", "cuda"):
        for graphs in (False, True):
            mode = "graph" if graphs else "eager"
            live = (lambda srv, outs: hot_swap(torch, srv, images, outs)) if backend == "cuda_fused" and graphs else None
            server, outs_cpu, counts, n_batches, report = serve_route(
                torch, serve, backend, images, graphs, live=live, params=params
            )
            params = server.params
            for name, n in per_batch[backend].items():
                check(counts[name] == n * n_batches,
                      f"{backend} {mode}: {name} launched {counts[name]} times, want {n} x {n_batches}")
            if backend == "cuda":
                check(counts["conv2d_fused"] == counts["matmul_fused"] == counts["qconv2d_fused"] == 0,
                      f"the cuda route launched a fused kernel: {counts}")
            if graphs:  # the main path as it runs: its launches go on the kernels line
                path_counts.update({name: counts[name] for name in per_batch[backend]})
            served_outs[(backend, mode)], served_reports[(backend, mode)] = outs_cpu, report
        if backend == "cuda_fused":
            graph, single_engines = server.graph, {}
            plain = SingleStageEngine(graph, params, backend="torch", device=dev).run(images)
            ref = torch.cat([o.cpu() for o in plain["outputs"]])
        single_engines[backend] = SingleStageEngine(graph, params, backend=backend, device=dev).run(images)
        outs_g, outs_e = served_outs[(backend, "graph")], served_outs[(backend, "eager")]
        got = torch.cat(outs_g)
        result = {
            "bitwise_graph_vs_eager": all(torch.equal(a, b) for a, b in zip(outs_g, outs_e)),
            "bitwise_vs_single_stage": all(torch.equal(a, b.cpu())
                                           for a, b in zip(outs_g, single_engines[backend]["outputs"])),
            "max_abs_diff_vs_torch_route": float((got - ref).abs().max()),
            "allclose_vs_torch_route": bool(torch.allclose(got, ref, rtol=SERVE_RTOL, atol=SERVE_ATOL)),
            "tolerance_vs_torch_route": f"rtol={SERVE_RTOL}, atol={SERVE_ATOL}",
            "single_stage_img_per_s": single_engines[backend]["throughput"],
        }
        if backend == "cuda":  # the fused kernels sum in the unfused GEMM's order: the same bits
            result["bitwise_vs_served_cuda_fused"] = all(
                torch.equal(a, b) for mode in ("eager", "graph")
                for a, b in zip(served_outs[("cuda_fused", mode)], served_outs[("cuda", mode)]))
        else:
            result["torch_route_img_per_s"] = plain["throughput"]
        for mode in ("eager", "graph"):
            print(json.dumps({"serve": {**served_reports[(backend, mode)],
                                        **(result if mode == "graph" else {})}}))
        check(result["bitwise_graph_vs_eager"], f"{backend}: served outputs with graphs differ from op by op")
        check(result["bitwise_vs_single_stage"], f"served outputs differ from the single-stage {backend} engine")
        check(result["allclose_vs_torch_route"], f"{backend} outputs differ from the plain torch route beyond tolerance")
        if backend == "cuda":
            check(result["bitwise_vs_served_cuda_fused"], "served cuda_fused outputs differ from the served cuda route's")
        mark("4" if backend == "cuda_fused" else "4b")
    print(json.dumps({"serve_eager_vs_graph": {
        f"{backend} {mode}": {k: r[k] for k in ("steady_img_per_s", "ms_between_micro_batches", "stage_p50_ms",
                                                "stage_graphs_device_ms")}
        | {"device_busy_share": r["profiled_window"]["device_busy_share"],
           "profiled_img_per_s": r["profiled_window"]["img_per_s"]}
        for (backend, mode), r in served_reports.items()}}))
    fused_graph_outs = served_outs[("cuda_fused", "graph")]
    hikey_report = served_reports[("cuda_fused", "graph")]
    del served_outs, single_engines, plain

    # ------------------------- 4c. the quantized path at VGG-16's full width
    graph = server.graph
    kb = resolve_backend("cuda_fused")
    env = {"input": torch.from_numpy(np.concatenate(images[:BATCH])).to(dev)}
    for node in graph.nodes:  # the f32 path's activations, every node kept
        env[node.name] = graph._apply_node(node, params, env, backend=kb)
    qparams = Q.quantize_graph_params(params)
    conv_nodes = [nd for nd in graph.nodes if nd.kind == "conv"]
    fns = {
        nd.name: Q.make_quant_conv_fn(
            qparams[nd.name], stride=nd.attrs["stride"], pad=nd.attrs["pad"],
            relu=nd.attrs.get("act") == "relu", kernel=True,
        )
        for nd in conv_nodes
    }
    torch.cuda.synchronize()
    K.reset_launches()
    quant_out = {nd.name: fns[nd.name](env[nd.inputs[0]]) for nd in conv_nodes}
    torch.cuda.synchronize()
    path_counts["qconv2d_fused"] = K.launch_counts()["qconv2d_fused"]
    check(path_counts["qconv2d_fused"] == len(conv_nodes),
          f"qconv2d_fused launched {path_counts['qconv2d_fused']} times, want {len(conv_nodes)}")
    quant_rows = []
    for nd in conv_nodes:
        x, yq, qp = env[nd.inputs[0]], quant_out[nd.name], qparams[nd.name]
        relu = nd.attrs.get("act") == "relu"
        fk, st, pd = nd.attrs["kernel"], nd.attrs["stride"], nd.attrs["pad"]
        plain_q = K.qfused_route_ref(
            x, qp["qw"], qp["scale"], qp["zp"], qp["b"], qp["shape"], stride=st, pad=pd, relu=relu
        )
        cols = I.im2col_ref(x, fk, fk, st, pd)
        via_qgemm = (Q.qgemm(cols, qp["qw"], qp["scale"], qp["zp"]).reshape(yq.shape) + qp["b"])
        del cols
        if relu:
            via_qgemm = torch.relu(via_qgemm)
        diff = (yq - via_qgemm).abs()
        tol = RTOL * via_qgemm.abs() + ATOL
        y32 = env[nd.name]
        quant_rows.append({
            "node": nd.name, "shape": list(yq.shape),
            "bitwise_vs_qfused_route_ref": bool(torch.equal(yq, plain_q)),
            "max_abs_err_vs_im2col_qgemm": float(diff.max()),
            "err_over_tol_vs_im2col_qgemm": float((diff / tol).max()),
            "rel_err_vs_f32": float((yq - y32).norm() / y32.norm()),
            "finite": bool(torch.isfinite(yq).all()),
        })
        del plain_q, via_qgemm, diff, tol
    print(json.dumps({"quantized": {
        "model": "vgg16", "batch": BATCH, "teacher_forced_from": "cuda_fused",
        "tolerance_vs_im2col_qgemm": f"|y-r| <= {RTOL}*|r| + {ATOL}", "nodes": quant_rows,
    }}))
    for row in quant_rows:
        check(row["finite"], f"quantized {row['node']} is not finite")
        check(row["bitwise_vs_qfused_route_ref"], f"qconv2d_fused differs from qfused_route_ref at {row['node']}")
        check(row["err_over_tol_vs_im2col_qgemm"] <= 1.0,
              f"quantized {row['node']} differs from im2col + qgemm beyond tolerance")
    del env, quant_out
    mark("4c")

    # ------------------------------ 5. the plan from the card, persisted
    tuner, measured, tmp = plan_from_card(torch, serve, images, params, fused_graph_outs, hikey_report)
    mark("5")

    # ------------------- 5e, 5f. the closed loop: adaptive and governed
    for name, n in closed_loop(torch, serve, images, params, fused_graph_outs, tuner, measured, tmp).items():
        path_counts[name] += n
    mark("5e,5f")

    # ------------- 5g. VGG-16 and MobileNet co-served on host_platform(4)
    coserve_launches, coserved = co_serving(torch, serve, images, params, fused_graph_outs, tuner, tmp,
                                            hikey_report["steady_img_per_s"])
    for name, n in coserve_launches.items():
        path_counts[name] += n
    mark("5g")

    # ------------- 5h. VGG-16 under open-loop arrivals
    for name, n in open_loop(torch, serve, images, params, fused_graph_outs,
                             hikey_report["steady_img_per_s"]).items():
        path_counts[name] += n
    del fused_graph_outs
    mark("5h")

    # ------------- 5i. a two-board fleet of VGG-16 and MobileNet
    for name, n in fleet(torch, images, tuner, coserved).items():
        path_counts[name] += n
    del coserved
    mark("5i")

    # ------------- 6. the transformer slice: B5, B6 and Hymba-1.5B served
    lm_kernels = hymba_phases(torch, dev, flops_peak, bytes_peak)
    mark("6")

    # ------------- 6e-6h. SmolLM-360M, OLMoE-1B-7B, PaliGemma-3B and
    # MusicGen-large served through B5
    fd_row = lm_kernels[0]
    served_lms = {}
    for phase, arch in DENSE_LMS + FEATURE_LMS:
        # 6e also serves the same weights from the serving form: the same
        # bits, and what 6k holds against its dry run
        lm = served_lms[phase] = lm_phase(torch, dev, phase, arch, bytes_peak, tie_serving_form=phase == "6e")
        n = lm["launches"]["flash_decode"]
        fd_row["launches"] += n
        fd_row["launches_by_path"][f"{phase} {arch}"] = n
        fd_row["max_abs_err"] = max(fd_row["max_abs_err"], lm["max_abs_err"]["flash_decode"])
        mark(phase)

    # ------------- 6i. xLSTM-1.3B served through B6 with its normalizer
    ssd_row = lm_kernels[1]
    for phase, arch in XLSTM_LMS:
        lm = lm_phase(torch, dev, phase, arch, bytes_peak)
        n = lm["launches"]["ssd"]
        ssd_row["launches"] += n
        ssd_row["launches_by_path"][f"{phase} {arch}"] = n
        ssd_row["max_abs_err"] = max(ssd_row["max_abs_err"], lm["max_abs_err"]["ssd"])
        mark(phase)

    # ------------- 6j. SmolLM-360M trained at full width (no counted kernel)
    trained = train_phase(torch, dev, bf16_peak)
    mark("6j")

    # ------------- 6k. the dry run on meta, held against 6e and 6j
    dryrun_phase(torch, kind, served_lms["6e"], trained)
    mark("6k")

    # ------------- 6l. StarCoder2-15B, DeepSeek-MoE-16B and Moonlight-16B-A3B
    # served from the serving form, one after the other, through B5
    for phase, arch in SERVING_FORM_LMS:
        lm = lm_phase(torch, dev, phase, arch, bytes_peak, serving_form=True, f32_layers=F32_CUT_LAYERS)
        n = lm["launches"]["flash_decode"]
        fd_row["launches"] += n
        fd_row["launches_by_path"][f"{phase} {arch}"] = n
        fd_row["max_abs_err"] = max(fd_row["max_abs_err"], lm["max_abs_err"]["flash_decode"])
        mark(f"{phase} {arch}")

    # ------------------------------------------------ 7. kernels line
    kernels = []
    for name, meta in KERNELS.items():
        t = totals[name]
        kernels.append({
            "name": name, "route": "cuda", "source": meta["source"],
            "replaces": meta["replaces"], "launches": path_counts[name],
            "max_abs_err": t["max_abs_err"], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": "operations" if t["flop_ms"] >= t["byte_ms"] else "bytes",
            "library_ms": None if name in NO_LIBRARY else t["library_ms"],
        })
    kernels += lm_kernels
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
