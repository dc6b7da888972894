#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py          # from the root of a checkout, on a GPU host

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
   one, and its bound (3b, 3d), as device time (a run of calls queued
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
   micro-batch (a replay counts what its capture recorded) and the
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
   777 (most splits empty), batch 4 with 5 KV heads, f32 and bf16; a row
   at batch 1, a second call and the length read on the device (as the
   captured decode step passes it; past S it clamps to S) must give the
   same bits; 6b the SSD scan
   (B6) at Hymba's 50 heads
   of P = 64, N = 16, chunk 64 and 128, a nonzero h0, head-stride-0 B/C,
   f32 and bf16; 6c serves Hymba-1.5B at full width (32 layers, random
   weights from seed 0) through ``repro_torch.launch.serve.generate``, the
   CLI's own loop: batch 4, a 768-token prompt (896 with the meta tokens),
   128 greedy steps, the first op by op and the rest replaying one
   captured step.  The launch counters must show exactly 32 SSD and no
   other launch in the prefill and exactly 32 flash-decode launches and no
   other in each decode step, and one graph launch in each step after
   the first.  The same 128 steps op by op, and both again in f32, must
   give the same greedy tokens and bitwise equal logits at every step.
   A further run, op by op, repeats every B5 and B6 call
   of the prefill and 8 decode steps through the plain version on the
   same activations; the prefill's last hidden state and the logits of 8
   teacher-forced decode steps are compared with the plain route's, gated
   in f32 and printed in bf16; a profiler trace of 3 decode steps, op by
   op and replayed, gives the device's busy and idle share and the host's
   CUDA API calls a step.  6d times B5 (its length on the device, the int
   form beside it) at the served shape and
   at ``decode_32k``'s (batch 16, 32768 slots) and B6 at the served
   prefill's (one memset and one kernel launch a call), each beside its
   plain version, its bound and, for B5,
   ``F.scaled_dot_product_attention`` with a length mask;
7. print ``{"kernels": [...]}`` with each kernel's numbers (seven rows:
   the five above and B5, B6), then the ``{"ok": true, ...}`` line last.

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

# Published dense peaks (NVIDIA data sheets): f32 CUDA-core FLOP/s, HBM
# bytes/s and int8 tensor-core op/s; the SXM part unless the card names
# another.  The quantized conv (B1q) runs on the int8 tensor cores, its
# bound; the CUDA cores' int32 multiply-add rate, half the f32 FMA rate
# (64 INT32 lanes per SM against 128 FP32), is printed beside it.
PEAKS = {
    "H100 PCIe": (51.2e12, 2.0e12, 1513e12),
    "H100 NVL": (60.0e12, 3.9e12, 1671e12),
    "H100": (67.0e12, 3.35e12, 1979e12),
}
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
# the transformer slice's kernels, timed and counted by hymba_phases()
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
                "library_copy_only_ms")
# Hymba-1.5B served at full width: batch 4, a 768-token prompt (896 with the
# 128 meta tokens), 128 greedy steps, so max_len = 1024 = the window
LM_ARCH, LM_BATCH, LM_PROMPT, LM_GEN = "hymba-1.5b", 4, 768, 128
LM_CHECK_STEPS = 8  # decode steps held against the plain route
LM_PROFILE_STEPS = 3  # decode steps traced for the busy/idle split
LM_RTOL = LM_ATOL = 3e-2  # the reference's bar for lossy decode paths
FD_TOL = 2e-4  # f32 bar of the reference's flash-decode and SSD kernel tests
SSD_BF16_TOL = 5e-2  # the reference's bf16 bar for the SSD kernel


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def peaks(name: str):
    for key, val in PEAKS.items():
        if key in name:
            return val
    return PEAKS["H100"]


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


def bf16_ulp(torch, r):
    """Spacing of bf16 numbers (8 significant bits) at |r|, taken no finer
    than at 2^-8 of the largest |r|: an output that cancels to near 0 is
    rounded from a sum of terms as large as the others, whose f32 rounding
    error does not shrink with it."""
    _, e = torch.frexp(torch.maximum(r.abs(), r.abs().max() * 2.0 ** -8))
    return torch.ldexp(torch.ones_like(r), e - 8)


def hymba_phases(torch, dev, flops_peak, bytes_peak):
    """Phases 6a-6d: B5 and B6 against their plain versions, Hymba-1.5B
    served at full width through them, and their timing.  Returns the
    kernels-line rows of both kernels."""
    import dataclasses

    import torch.nn.functional as F

    from repro_torch.configs import SHAPES, get_config
    from repro_torch.kernels import flash_decode as FD
    from repro_torch.kernels import ops as OPS
    from repro_torch.kernels import runtime
    from repro_torch.kernels import ssd as SSD
    from repro_torch.launch.serve import generate
    from repro_torch.launch.steps import make_eager_serve_step, make_prefill_step, make_serve_step
    from repro_torch.models import init_cache, init_params
    from repro_torch.models.model import N_META_TOKENS

    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    err = {"flash_decode": 0.0, "ssd": 0.0}

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, device=dev, generator=gen) * scale).to(dtype)

    # ---------------------------- 6a. B5 against its plain version
    # valid prefixes of 1, a ragged one and all slots, each side of the
    # first split boundary, and a 32768-slot cache with most splits empty;
    # a row at batch 1 and a repeated call must give the same bits
    fd_cases, fd_worst = 0, {"float32": (0.0, ""), "bfloat16": (0.0, "")}
    fd_not_bitwise = []
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for g in (1, 5):
            for d in (64, 128):
                for s_len in (1, 300, 1024, 32768):
                    split = FD.split_len(s_len, d)
                    lengths = {1, 777} if s_len == 32768 else {
                        1, (2 * s_len) // 3 + 1, s_len, split - 1, split, split + 1}
                    for length in sorted(n for n in lengths if 1 <= n <= s_len):
                        b, hkv = 4, 5
                        q = randn(b, hkv, g, d, scale=0.5, dtype=dtype)
                        k = randn(b, s_len, hkv, d, scale=0.5, dtype=dtype)
                        v = randn(b, s_len, hkv, d, dtype=dtype)
                        y = OPS.flash_decode(q, k, v, length)
                        where = f"G{g} D{d} S{s_len} split{split} len{length} {dname}"
                        y1 = OPS.flash_decode(q[2:3].contiguous(), k[2:3].contiguous(), v[2:3].contiguous(), length)
                        if not (torch.equal(y1, y[2:3]) and torch.equal(OPS.flash_decode(q, k, v, length), y)):
                            fd_not_bitwise.append(where)
                        # the length read on the device, as a captured decode
                        # step passes it: the int form's bits at batch 4 and 1
                        dev_len = torch.tensor([length], dtype=torch.int32, device=dev)
                        if not (torch.equal(OPS.flash_decode(q, k, v, dev_len), y) and torch.equal(
                                OPS.flash_decode(q[2:3].contiguous(), k[2:3].contiguous(), v[2:3].contiguous(),
                                                 dev_len), y1)):
                            fd_not_bitwise.append(f"{where} device length")
                        if dtype == torch.float32:
                            r = OPS.flash_decode(q, k, v, length, backend="torch")
                            ratio = float(((y - r).abs() / (FD_TOL + FD_TOL * r.abs())).max())
                        else:
                            r = OPS.flash_decode(q.float(), k.float(), v.float(), length, backend="torch")
                            ratio = float(((y.float() - r).abs() / bf16_ulp(torch, r)).max())
                        err["flash_decode"] = max(err["flash_decode"], float((y.float() - r).abs().max()))
                        check(bool(torch.isfinite(y).all()), f"flash_decode non-finite at {where}")
                        if ratio >= fd_worst[dname][0]:
                            fd_worst[dname] = (ratio, where)
                        fd_cases += 1
                    # a device length past W is clamped to W, as the reference's
                    # position mask would take every slot
                    past = torch.tensor([s_len + 5], dtype=torch.int32, device=dev)
                    if not torch.equal(OPS.flash_decode(q, k, v, past), OPS.flash_decode(q, k, v, s_len)):
                        fd_not_bitwise.append(f"G{g} D{d} S{s_len} {dname} device length past W")

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
    torch.cuda.synchronize()
    print(json.dumps({"correctness_lm_kernels": {
        "flash_decode": {"cases": fd_cases, "worst_err_over_tol": {k: v[0] for k, v in fd_worst.items()},
                         "worst_at": {k: v[1] for k, v in fd_worst.items()},
                         "device_length_cases": fd_cases,
                         "batch1_repeat_or_device_length_not_bitwise": fd_not_bitwise,
                         "tolerance": {"float32": f"|y-r| <= {FD_TOL} + {FD_TOL}*|r|",
                                       "bfloat16": "|y - r_f32| <= 1 bf16 ulp of r_f32 (no finer than at 2^-8 max|r_f32|)"}},
        "ssd": {"cases": ssd_cases, "tolerance": {"float32": f"rtol=atol={FD_TOL}",
                                                  "bfloat16": f"rtol=atol={SSD_BF16_TOL}"}},
    }}))
    for dname, (ratio, where) in fd_worst.items():
        check(ratio <= 1.0, f"flash_decode exceeds its {dname} bar at {where} (err/tol {ratio:.3g})")
    check(not fd_not_bitwise, f"flash_decode rows differ at batch 1, between calls or with a device length "
                              f"at {fd_not_bitwise[:3]}")
    check(all(c["finite"] for c in ssd_cases), "ssd output is not finite")
    check(ssd_worst <= 1.0, f"ssd exceeds its bar (err/tol {ssd_worst:.3g})")

    # ----------------- 6c. Hymba-1.5B served at full width through B5, B6
    cfg = get_config(LM_ARCH)
    t0 = time.perf_counter()
    model = init_params(cfg, seed=SEED, device=dev)
    model.compute_blocks(torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    prompt = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(SEED))
    for graphs in (True, False):  # warm-up: cuBLAS handles, first launches, a capture
        generate(cfg, model, prompt[:, :64], 3, graphs=graphs)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    per_step = []

    def hook(phase, i):
        per_step.append((phase, runtime.launch_counts(), runtime.graph_launches()))
        runtime.reset_launches()

    # the served run: the first decode step op by op, then one captured
    # step replayed (launch/steps.py::GraphedServeStep); each replay counts
    # the launches its capture recorded, and one graph launch
    runtime.reset_launches()
    out = generate(cfg, model, prompt, LM_GEN, keep_logits=LM_GEN, step_hook=hook)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    n_layers = cfg.n_layers
    others = [k for k in runtime.KERNEL_NAMES if k not in LM_KERNELS]
    phase0, prefill_counts, prefill_graphs = per_step[0]
    check(phase0 == "prefill" and prefill_counts["ssd"] == n_layers and prefill_graphs == 0
          and prefill_counts["flash_decode"] == 0 and not any(prefill_counts[k] for k in others),
          f"prefill launched {prefill_counts} and {prefill_graphs} graphs, want {n_layers} ssd and nothing else")
    decode_counts = [c for ph, c, _ in per_step[1:]]
    decode_graphs = [n for ph, _, n in per_step[1:]]
    check(len(decode_counts) == LM_GEN, f"{len(decode_counts)} decode steps, want {LM_GEN}")
    for i, c in enumerate(decode_counts):
        check(c["flash_decode"] == n_layers and c["ssd"] == 0 and not any(c[k] for k in others),
              f"decode step {i} launched {c}, want {n_layers} flash_decode and nothing else")
    check(decode_graphs == [0] + [1] * (LM_GEN - 1),
          f"graph launches per decode step {decode_graphs[:4]}..., want 0 (the eager first step), then 1")

    # the same steps op by op, in bf16 and in f32: the same greedy tokens,
    # and every kept logit bitwise equal (the captured kernels and cuBLAS
    # calls are the eager step's, in the same order)
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    runs = {"bfloat16": {"graph": out, "eager": generate(cfg, model, prompt, LM_GEN, keep_logits=LM_GEN,
                                                           graphs=False)}}
    runs["float32"] = {mode: generate(cfg32, model, prompt, LM_GEN, keep_logits=LM_GEN, graphs=mode == "graph")
                       for mode in ("eager", "graph")}
    eager_vs_graph = {}
    for dname, pair in runs.items():
        e, gr = pair["eager"], pair["graph"]
        eager_vs_graph[dname] = {
            "tokens_equal": bool(torch.equal(e["tokens"], gr["tokens"])),
            "kept_logits_bitwise": all(torch.equal(a, b) for a, b in zip(e["logits"], gr["logits"]))
            and len(e["logits"]) == len(gr["logits"]) == LM_GEN,
            **{mode: {"decode_ms": r["decode_ms"], "decode_ms_per_step": r["decode_ms"] / LM_GEN,
                      "steady_ms_per_step": r["steady_ms_per_step"], "decode_tok_per_s": r["decode_tok_per_s"],
                      "steady_tok_per_s": LM_BATCH / (r["steady_ms_per_step"] / 1e3)}
               for mode, r in pair.items()},
        }
    del runs["float32"]
    tokens = out["tokens"]
    check(tuple(tokens.shape) == (LM_BATCH, LM_GEN) and bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()),
          "generated tokens out of range")
    check(all(bool(torch.isfinite(lg).all()) for lg in out["logits"]), "served logits are not finite")
    check(bool(torch.isfinite(out["last_hidden"]).all()), "prefill hidden state is not finite")
    launches = {"flash_decode": sum(c["flash_decode"] for c in decode_counts), "ssd": prefill_counts["ssd"]}

    # kernel-level parity on the served activations: every B5 and B6 call
    # of a prefill and LM_CHECK_STEPS decode steps is repeated through the
    # plain version on the same inputs (teacher forcing at the kernel)
    served = {"flash_decode": [0, 0.0, 0.0], "ssd": [0, 0.0, 0.0]}  # calls, worst ratio, max abs
    orig_fd, orig_ssd = OPS.flash_decode, OPS.ssd

    def fd_checked(q, k, v, length, backend=None):
        y = orig_fd(q, k, v, length, backend=backend)
        r = orig_fd(q.float(), k.float(), v.float(), length, backend="torch")
        d = (y.float() - r).abs()
        rec = served["flash_decode"]
        rec[0] += 1
        rec[1] = max(rec[1], float((d / bf16_ulp(torch, r)).max()))
        rec[2] = max(rec[2], float(d.max()))
        return y

    def ssd_checked(x, log_a, B, C, h0=None, chunk=128, backend=None):
        y, hf = orig_ssd(x, log_a, B, C, h0=h0, chunk=chunk, backend=backend)
        ry, rh = orig_ssd(x, log_a, B, C, h0=h0, chunk=chunk, backend="torch")
        d = (y.float() - ry.float()).abs()
        rec = served["ssd"]
        rec[0] += 1
        rec[1] = max(rec[1], float((d / (SSD_BF16_TOL + SSD_BF16_TOL * ry.float().abs())).max()),
                     float(((hf - rh).abs() / (SSD_BF16_TOL + SSD_BF16_TOL * rh.abs())).max()))
        rec[2] = max(rec[2], float(d.max()))
        return y, hf

    OPS.flash_decode, OPS.ssd = fd_checked, ssd_checked
    try:  # op by op: the checks read device values on the host, which no capture may
        checked = generate(cfg, model, prompt, LM_CHECK_STEPS, keep_logits=LM_CHECK_STEPS, graphs=False)
    finally:
        OPS.flash_decode, OPS.ssd = orig_fd, orig_ssd
    repeatable = all(torch.equal(a, b) for a, b in zip(checked["logits"], out["logits"]))
    for name in LM_KERNELS:
        err[name] = max(err[name], served[name][2])

    # end-to-end, teacher-forced: the served token stream through the
    # kernel route and the plain route, compared in f32 (gated) and bf16
    stream = out["tokens"]

    def forced(cfg_, backend):
        caches = init_cache(cfg_, LM_BATCH, out["max_len"], device=dev)
        last = make_prefill_step(cfg_, backend)(model, {"tokens": prompt}, caches)
        step = make_eager_serve_step(cfg_, backend)
        tok, logits = prompt[:, -1:], []
        for i in range(LM_CHECK_STEPS):
            logits.append(step(model, caches, tok, LM_PROMPT + N_META_TOKENS + i))
            tok = stream[:, i:i + 1]
        del caches
        return [last.float()] + logits

    def compare(a, b):
        worst, mx = 0.0, 0.0
        for x, r in zip(a, b):
            d = (x - r).abs()
            worst = max(worst, float((d / (LM_ATOL + LM_RTOL * r.abs())).max()))
            mx = max(mx, float(d.max()))
        return worst, mx

    f32_worst, f32_max = compare(forced(cfg32, None), forced(cfg32, "torch"))
    bf16_worst, bf16_max = compare([out["last_hidden"].float()] + out["logits"], forced(cfg, "torch"))
    torch.cuda.synchronize()
    report = {
        "model": LM_ARCH, "params": n_params, "batch": LM_BATCH, "prompt": LM_PROMPT,
        "meta_tokens": N_META_TOKENS, "gen": LM_GEN, "max_len": out["max_len"],
        "compute_dtype": cfg.compute_dtype, "init_and_cast_s": init_s,
        "prefill_ms": out["prefill_ms"], "decode_ms": out["decode_ms"],
        "decode_tok_per_s": out["decode_tok_per_s"], "decode_ms_per_step": out["decode_ms"] / LM_GEN,
        "timer": out["timer"], "peak_memory_gb": peak_gb,
        "launches": {"prefill": {k: prefill_counts[k] for k in LM_KERNELS},
                     "per_decode_step": {k: decode_counts[0][k] for k in LM_KERNELS},
                     "graph_launches_per_decode_step": {"first": decode_graphs[0], "later": decode_graphs[1]}},
        "kernel_parity_on_served_activations": {
            name: {"calls": served[name][0], "worst_err_over_tol": served[name][1],
                   "max_abs_err": served[name][2]} for name in LM_KERNELS},
        "checked_run_bitwise_equal_served_logits": repeatable,
        "teacher_forced_vs_plain_route": {
            "float32": {"worst_err_over_tol": f32_worst, "max_abs_err": f32_max},
            "bfloat16": {"worst_err_over_tol": bf16_worst, "max_abs_err": bf16_max},
            "compared": f"prefill last hidden state + logits of {LM_CHECK_STEPS} decode steps",
            "tolerance": f"rtol={LM_RTOL}, atol={LM_ATOL}; gated in float32",
        },
        "sample_tokens": tokens[0, :8].tolist(),
    }
    print(json.dumps({"serve_lm": report}))
    check(served["flash_decode"][0] == n_layers * LM_CHECK_STEPS and served["ssd"][0] == n_layers,
          f"kernel parity saw {served['flash_decode'][0]} flash_decode and {served['ssd'][0]} ssd calls")
    check(served["flash_decode"][1] <= 1.0, f"flash_decode on served activations exceeds 1 bf16 ulp "
                                           f"({served['flash_decode'][1]:.3g})")
    check(served["ssd"][1] <= 1.0, f"ssd on served activations exceeds its bf16 bar ({served['ssd'][1]:.3g})")
    check(f32_worst <= 1.0, f"float32 kernel route differs from the plain route (err/tol {f32_worst:.3g})")
    del checked

    # where a decode step's time goes, op by op and replayed: device busy
    # time of a few steps (profiler, kernels summed) against the served
    # runs' step times, and the host's CUDA API calls a step
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    tok, pos0 = out["tokens"][:, -1:], out["max_len"]
    breakdown = {}
    for mode, step in (("eager", make_eager_serve_step(cfg)), ("graph", make_serve_step(cfg))):
        for i in range(2):  # eager: two warm steps; graph: the eager step and capture, one replay
            step(model, out["caches"], tok, pos0 + i)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for i in range(LM_PROFILE_STEPS):
                step(model, out["caches"], tok, pos0 + 2 + i)
            torch.cuda.synchronize()
        events = prof.key_averages()
        dev_events = [e for e in events if e.device_type == DeviceType.CUDA]
        api = [e for e in events if e.device_type == DeviceType.CPU and cuda_api_call(e.key)]
        busy_ms = sum(e.self_device_time_total for e in dev_events) / 1e3 / LM_PROFILE_STEPS
        copies = graph_device_ms(torch, step.graph) if mode == "graph" else None
        served_run = runs["bfloat16"][mode]
        step_ms, steady_ms = served_run["decode_ms"] / LM_GEN, served_run["steady_ms_per_step"]
        top = sorted(dev_events, key=lambda e: -e.self_device_time_total)[:6]
        breakdown[mode] = {
            "served_step_ms": step_ms, "served_steady_step_ms": steady_ms,
            "device_busy_ms_per_step": busy_ms if dev_events else None,
            "device_idle_share": (1.0 - busy_ms / step_ms) if dev_events else None,
            "device_idle_share_steady": (1.0 - busy_ms / steady_ms) if dev_events else None,
            "device_kernels_per_step": sum(e.count for e in dev_events) / LM_PROFILE_STEPS,
            "host_api_calls_per_step": sum(e.count for e in api) / LM_PROFILE_STEPS,
            "graph_launches_per_step": sum(e.count for e in api if e.key == "cudaGraphLaunch")
            / LM_PROFILE_STEPS,
            "graph_device_ms": copies,
            "top_device_ms_per_step": {e.key[:80]: e.self_device_time_total / 1e3 / LM_PROFILE_STEPS
                                       for e in top},
        }
    del runs
    print(json.dumps({"decode_step_breakdown": {
        "steps_profiled": LM_PROFILE_STEPS, **breakdown,
        "source": "torch.profiler over steps after the served run; step times from the served bf16 runs "
                  "(decode_ms / steps, and steady: steps 2 on)",
    }}))
    print(json.dumps({"decode_eager_vs_graph": {
        "model": LM_ARCH, "batch": LM_BATCH, "prompt": LM_PROMPT, "gen": LM_GEN, **eager_vs_graph,
        "timer": "cuda events after a device sync; steady from the third step to the end",
    }}))
    for dname, row in eager_vs_graph.items():
        check(row["tokens_equal"], f"{dname}: greedy tokens with graphs differ from the eager run's")
        check(row["kept_logits_bitwise"], f"{dname}: kept logits with graphs differ from the eager run's")

    # ---------------------------- 6d. timing of B5 and B6
    rows = {}

    def timed(name, where, kern, plain, lib, op_count, op_peak, nbytes, **extra):
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

    hkv, g, d = cfg.n_kv_heads, cfg.q_per_kv, cfg.resolved_head_dim
    for label, b, w, length in (("served", LM_BATCH, out["max_len"], out["max_len"]),
                                ("decode_32k", 16, SHAPES["decode_32k"].seq_len, SHAPES["decode_32k"].seq_len)):
        q = randn(b, hkv, g, d, scale=0.5, dtype=torch.bfloat16)
        k = randn(b, w, hkv, d, scale=0.5, dtype=torch.bfloat16)
        v = randn(b, w, hkv, d, dtype=torch.bfloat16)
        kt, vt = k.transpose(1, 2), v.transpose(1, 2)  # [B, Hkv, W, D] views
        q4 = q.reshape(b, hkv * g, 1, d)
        mask = (torch.arange(w, device=dev) < length)[None, None, None, :]
        # the length on the device, as the captured decode step passes it;
        # the int form's time beside it
        dev_len = torch.tensor([length], dtype=torch.int32, device=dev)
        y = OPS.flash_decode(q, k, v, dev_len)
        check(torch.equal(y, OPS.flash_decode(q, k, v, length)), f"flash_decode {label}: device length not bitwise")
        lib_y = F.scaled_dot_product_attention(q4, kt, vt, attn_mask=mask, enable_gqa=True)
        lib_err = float((lib_y.reshape(q.shape).float() - y.float()).abs().max())
        rows[label] = timed(
            "flash_decode", f"{label}: B{b} Hkv{hkv} G{g} D{d} W{w} len{length} bf16, length on the device",
            lambda: OPS.flash_decode(q, k, v, dev_len),
            lambda: OPS.flash_decode(q, k, v, length, backend="torch"),
            lambda: F.scaled_dot_product_attention(q4, kt, vt, attn_mask=mask, enable_gqa=True),
            4.0 * b * hkv * g * length * d, flops_peak,
            2.0 * (2 * q.numel() + 2 * b * length * hkv * d),
            library_max_abs_diff=lib_err,
            int_length_kernel_ms=device_ms(lambda: OPS.flash_decode(q, k, v, length), torch),
        )
        del q, k, v, kt, vt, y, lib_y

    # B6 at the served prefill shape: Hymba's mamba heads over 896 tokens
    s_len, h, p, n, chunk = LM_PROMPT + N_META_TOKENS, cfg.d_inner // 64, 64, cfg.ssm_state, cfg.ssd_chunk
    b = LM_BATCH
    x = randn(b, s_len, h, p, dtype=torch.bfloat16)
    la = (-randn(b, s_len, h).abs() * 0.3).to(torch.bfloat16)
    B = randn(b, s_len, 1, n, scale=0.4, dtype=torch.bfloat16).expand(b, s_len, h, n)
    C = randn(b, s_len, 1, n, scale=0.4, dtype=torch.bfloat16).expand(b, s_len, h, n)
    n_chunks = b * h * (-(-s_len // chunk))
    # the causal half of the Q x Q products and the two N x P terms, per chunk
    causal = chunk * (chunk + 1) // 2
    ssd_flops = 2.0 * n_chunks * (causal * n + causal * p + 2 * chunk * n * p)
    ssd_bytes = 2.0 * (2 * x.numel() + la.numel() + 2 * b * s_len * n) + 4.0 * b * h * n * p
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
    del x, la, B, C, model, out

    kernels = []
    for name, meta in LM_KERNELS.items():
        row = rows["served"] if name == "flash_decode" else rows["ssd"]
        kernels.append({
            "name": name, "route": "cuda", "source": meta["source"], "replaces": meta["replaces"],
            "launches": launches[name], "max_abs_err": err[name], "ms": row["kernel_ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
        })
    return kernels


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
        counts = runtime.launch_counts()
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
    check(counts["conv2d_fused"] == 13 * micro_batches and counts["matmul_fused"] == 3 * micro_batches,
          f"{name}: {counts} over {micro_batches} micro-batches (served and warm-ups), want 13 + 3 each")


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
    counts = runtime.launch_counts()
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
    static_counts = runtime.launch_counts()
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
    counts = runtime.launch_counts()
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
    counts = runtime.launch_counts()
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
    time of the call and its ticket are recorded."""

    def __init__(self, server, arrivals):
        self.server, self.arrivals = server, arrivals
        self.attempts, self.tickets = [], []

    def ingress_depth(self):
        return self.server.ingress_depth()

    def set_batching(self, **kw):
        self.server.set_batching(**kw)

    def submit(self, image, *, block=True):
        z = self.arrivals.z
        self.attempts.append((z, time.perf_counter()))
        ticket = self.server.submit(image, block=block)
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
    gated: the latencies, goodput, sheds, and how late each submission
    left behind its trace time (the pacing thread shares the interpreter
    lock with the workers).  Returns the B1 and B2 launches of its runs."""
    from repro_torch.kernels import runtime
    from repro_torch.serving import (QueueController, QueuePolicy, mmpp_trace, percentile, poisson_trace,
                                     run_open_loop)

    rate = sum(vgg_img_per_s) / len(vgg_img_per_s)
    server = serve("vgg16", backend="cuda_fused", batch_size=BATCH, params=params, device=DEVICE,
                   queue_depth=OPEN_LOOP_QUEUE_DEPTH, flush_timeout_s=OPEN_LOOP_FLUSH_S)
    n_stages = len(server.plan.allocation)
    runs = []

    def drive(name, trace, controller=None):
        arrivals = Arrivals(images, trace.n)
        rec = Recording(server, arrivals)
        st0 = server.metrics.stages[0].snapshot()
        runtime.reset_launches()
        t_start = time.perf_counter()
        report = run_open_loop(rec, trace, arrivals, controller=controller, result_timeout_s=600)
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
        stop_error = stop_quietly(server)
    report = {
        "model": "vgg16", "backend": "cuda_fused", "plan": server.plan.notation(), "batch": BATCH,
        "queue_depth": OPEN_LOOP_QUEUE_DEPTH, "ingress_images": OPEN_LOOP_QUEUE_DEPTH * BATCH,
        "flush_timeout_ms": OPEN_LOOP_FLUSH_S * 1e3, "phase4_mean_steady_img_per_s": rate,
        "mmpp": {"calm": 0.3, "burst": 1.2, **mmpp}, "queue_controller": ctrl_meta, "runs": runs,
        "stop_error": stop_error,
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; needs a CUDA card",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: {SRC}/repro_torch not found; run from a checkout",
              file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
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
    flops_peak, bytes_peak, int8_peak = peaks(kind)
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
            record(
                "conv2d_fused", where,
                lambda: K.conv2d_fused(x, wt, b, stride=st, pad=pd, relu=relu),
                lambda: K.fused_route_ref(x, wt, b, stride=st, pad=pd, relu=relu),
                lambda: F.conv2d(xn, wn, b, stride=st, padding=pd),
                y, K.fused_route_ref(x, wt, b, stride=st, pad=pd, relu=relu),
                flops / flops_peak * 1e3, nbytes / bytes_peak * 1e3,
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
            record(
                "gemm", where,
                lambda: ops.gemm(cols, w2), lambda: G.gemm_ref(cols, w2), lambda: torch.mm(cols, w2),
                yg, G.gemm_ref(cols, w2),
                flops / flops_peak * 1e3, 4.0 * (cols.numel() + w2.numel() + yg.numel()) / bytes_peak * 1e3,
                m=m, k=k, n=cout,
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
            record(
                "matmul_fused", where,
                lambda: K.matmul_fused(a, wt, b, relu=relu),
                lambda: K.matmul_fused_ref(a, wt, b, relu=relu),
                lambda: torch.addmm(b, a, wt),
                y, K.matmul_fused_ref(a, wt, b, relu=relu),
                flops / flops_peak * 1e3, nbytes / bytes_peak * 1e3,
            )
            yg = ops.gemm(a, wt)
            record(
                "gemm", where,
                lambda: ops.gemm(a, wt), lambda: G.gemm_ref(a, wt), lambda: torch.mm(a, wt),
                yg, G.gemm_ref(a, wt),
                flops / flops_peak * 1e3, 4.0 * (a.numel() + wt.numel() + yg.numel()) / bytes_peak * 1e3,
                m=BATCH, k=k, n=n,
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
    per_batch = {"cuda_fused": {"conv2d_fused": 13, "matmul_fused": 3}, "cuda": {"im2col": 13, "gemm": 16}}
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
