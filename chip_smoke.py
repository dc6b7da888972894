#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py          # from the root of a checkout, on a GPU host

Phases (any failure exits non-zero):

1. print the card's name and power limit; turn TF32 off for cuDNN and
   cuBLAS so every f32 reference below is IEEE f32;
2. build the hand-written kernels from ``src/repro_torch/kernels/csrc``
   (one nvcc per source, in parallel);
3. hold each kernel against its plain PyTorch version on the card: the
   fused conv at every distinct ``groups == 1`` conv geometry of the six
   nets (batch 1) and the fused dense GEMM at every fc shape of the six
   nets, then time both kernels at VGG-16's shapes at batch 4 beside
   their plain version, one library call and their bound;
4. drive the port's main path, ``serve("vgg16", backend="cuda_fused",
   batch_size=4)``, with 32 seeded images; the launch counters must show
   13 conv and 3 dense launches per micro-batch, the outputs must be
   bitwise equal to the single-stage ``cuda_fused`` engine's and close to
   the plain ``torch`` route's; then time the same server over three
   steady windows of 1024 images each;
5. print ``{"kernels": [...]}`` with each kernel's numbers, then the
   ``{"ok": true, ...}`` line last.

Tolerances: kernel vs plain version ``|y - r| <= RTOL*|r| + ATOL*max(1, max|r|)``
with ``RTOL, ATOL = 1e-4, 1e-5`` (the reference's bar, its absolute floor
scaled by the output range because f32 reordering error of a K-term sum
follows the size of its partial sums).  Served outputs vs the plain
``torch`` route, 16 chained layers summed in different orders, are held
to ``rtol=1e-3, atol=1e-6`` on the softmax probabilities.
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
BATCH = 4
SEED = 0

# Published dense peaks (NVIDIA data sheets): f32 CUDA-core FLOP/s and
# HBM bytes/s; the SXM part unless the card names another.
PEAKS = {
    "H100 PCIe": (51.2e12, 2.0e12),
    "H100 NVL": (60.0e12, 3.9e12),
    "H100": (67.0e12, 3.35e12),
}
KERNELS = {
    "conv2d_fused": {
        "source": "src/repro_torch/kernels/csrc/conv_fused.cu",
        "replaces": "src/repro/kernels/conv_fused.py:53",
    },
    "matmul_fused": {
        "source": "src/repro_torch/kernels/csrc/matmul_fused.cu",
        "replaces": "src/repro/kernels/conv_fused.py:260",
    },
}


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

    from repro_torch.cnn.models import MODELS
    from repro_torch.kernels import build
    from repro_torch.kernels import conv_fused as K
    from repro_torch.serving import SingleStageEngine, serve

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
    flops_peak, bytes_peak = peaks(kind)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)

    # ---------------------------------------------------------- 2. build
    t0 = time.perf_counter()
    libs = build.build_all()
    print(f"build_s={time.perf_counter() - t0:.3f} libs={[os.path.basename(p) for p in libs]}")

    # ------------------------------------------- 3a. correctness, all nets
    convs, fcs = {}, []
    for net, make in sorted(MODELS.items()):
        for d in make().descriptors():
            if d.kind == "conv" and d.groups == 1:
                convs.setdefault(
                    (d.i_h, d.i_w, d.i_d, d.f_h, d.f_w, d.stride, d.pad, d.ofm), f"{net}:{d.name}"
                )
            elif d.kind == "fc":
                fcs.append((d.i_w * d.i_h * d.i_d, d.ofm, f"{net}:{d.name}"))
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

    # ---------------------------------------- 3b. timing, VGG-16 at batch 4
    vgg = MODELS["vgg16"]()
    shapes = vgg.infer_shapes()
    totals = {n: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
                  "flop_ms": 0.0, "byte_ms": 0.0, "max_abs_err": 0.0} for n in KERNELS}
    for node in vgg.major_nodes():
        hin = shapes[node.inputs[0]]
        relu = node.attrs.get("act") == "relu"
        if node.kind == "conv":
            h, w, c = hin
            fk, st, pd, cout = node.attrs["kernel"], node.attrs["stride"], node.attrs["pad"], node.attrs["out_ch"]
            x = torch.randn(BATCH, h, w, c, device=dev, generator=gen)
            wt = torch.randn(fk, fk, c, cout, device=dev, generator=gen) * (2.0 / (fk * fk * c)) ** 0.5
            b = torch.randn(cout, device=dev, generator=gen) * 0.1
            kern = lambda: K.conv2d_fused(x, wt, b, stride=st, pad=pd, relu=relu)
            plain = lambda: K.fused_route_ref(x, wt, b, stride=st, pad=pd, relu=relu)
            xn, wn = x.permute(0, 3, 1, 2), wt.permute(3, 2, 0, 1)
            lib = lambda: F.conv2d(xn, wn, b, stride=st, padding=pd)
            y = kern()
            oh, ow = y.shape[1], y.shape[2]
            flops = 2.0 * BATCH * oh * ow * cout * fk * fk * c
            nbytes = 4.0 * (x.numel() + wt.numel() + 2 * cout + y.numel())
            name = "conv2d_fused"
        else:
            k = int(np.prod(hin))
            n = node.attrs["out_features"]
            a = torch.randn(BATCH, k, device=dev, generator=gen)
            wt = torch.randn(k, n, device=dev, generator=gen) * (1.0 / k) ** 0.5
            b = torch.randn(n, device=dev, generator=gen) * 0.1
            kern = lambda: K.matmul_fused(a, wt, b, relu=relu)
            plain = lambda: K.matmul_fused_ref(a, wt, b, relu=relu)
            lib = lambda: torch.addmm(b, a, wt)
            y = kern()
            flops = 2.0 * BATCH * k * n
            nbytes = 4.0 * (a.numel() + wt.numel() + 2 * n + y.numel())
            name = "matmul_fused"
        r = plain()
        err, ratio = tol_ok(y, r)
        check(ratio <= 1.0, f"{name} exceeds tolerance at vgg16:{node.name} batch {BATCH}")
        row = {
            "shape": f"vgg16:{node.name}", "kernel": name, "batch": BATCH,
            "kernel_ms": time_ms(kern, torch), "plain_ms": time_ms(plain, torch),
            "library_ms": time_ms(lib, torch),
            "flop_bound_ms": flops / flops_peak * 1e3, "byte_bound_ms": nbytes / bytes_peak * 1e3,
            "max_abs_err": err, "err_over_tol": ratio,
            "tolerance": f"rtol={RTOL}, atol={ATOL}*max(1,max|r|)",
        }
        row["bound_ms"] = max(row["flop_bound_ms"], row["byte_bound_ms"])
        row["bound_by"] = "operations" if row["flop_bound_ms"] >= row["byte_bound_ms"] else "bytes"
        print(json.dumps(row))
        t = totals[name]
        for key in ("plain_ms", "library_ms", "bound_ms", "max_abs_err"):
            t[key] = max(t[key], row[key]) if key == "max_abs_err" else t[key] + row[key]
        t["ms"] += row["kernel_ms"]
        t["flop_ms"] += row["flop_bound_ms"]
        t["byte_ms"] += row["byte_bound_ms"]
        del kern, plain, lib, y, r

    # ------------------------------------------------ 4. the main path
    rng = np.random.default_rng(SEED)
    images = [rng.standard_normal((1, 224, 224, 3)).astype(np.float32) for _ in range(N_IMAGES)]
    K.reset_launches()
    t_build = time.perf_counter()
    server = serve("vgg16", backend="cuda_fused", batch_size=BATCH, seed=SEED)
    try:
        setup_s = time.perf_counter() - t_build
        t0 = time.perf_counter()
        tickets = [server.submit(img) for img in images]
        outs = [t.result(timeout=600) for t in tickets]
        wall = time.perf_counter() - t0
        # served rate over steady windows, each long enough that filling
        # and draining the pipeline is a few of its 256 micro-batches
        steady = []
        for _ in range(STEADY_REPS):
            t0 = time.perf_counter()
            ts = [server.submit(images[i % N_IMAGES]) for i in range(STEADY_IMAGES)]
            for t in ts:
                t.result(timeout=600)
            steady.append(STEADY_IMAGES / (time.perf_counter() - t0))
        snap = server.metrics.snapshot()
    finally:
        server.stop()
    counts = K.launch_counts()
    stage_batches = [s["batches"] for s in snap["stages"]]
    check(len(set(stage_batches)) == 1, f"stages saw different batch counts {stage_batches}")
    n_batches = stage_batches[0] + 1  # + the warmup batch serve() runs
    check(counts["conv2d_fused"] == 13 * n_batches,
          f"conv2d_fused launched {counts['conv2d_fused']} times, want 13 x {n_batches}")
    check(counts["matmul_fused"] == 3 * n_batches,
          f"matmul_fused launched {counts['matmul_fused']} times, want 3 x {n_batches}")
    outs_cpu = [o.cpu() for o in outs]
    check(all(o.shape == (1, 1000) and bool(torch.isfinite(o).all()) for o in outs_cpu),
          "served outputs are not finite [1, 1000] rows")
    sums = torch.cat(outs_cpu).sum(-1)
    check(bool(torch.allclose(sums, torch.ones_like(sums), atol=1e-4)), "softmax rows do not sum to 1")
    single = SingleStageEngine(server.graph, server.params, backend="cuda_fused").run(images)
    bitwise = all(torch.equal(a, b.cpu()) for a, b in zip(outs_cpu, single["outputs"]))
    plain = SingleStageEngine(server.graph, server.params, backend="torch").run(images)
    ref = torch.cat([o.cpu() for o in plain["outputs"]])
    got = torch.cat(outs_cpu)
    close = bool(torch.allclose(got, ref, rtol=SERVE_RTOL, atol=SERVE_ATOL))
    print(json.dumps({
        "serve": {
            "model": "vgg16", "backend": "cuda_fused", "batch_size": BATCH,
            "images": N_IMAGES, "plan": server.plan.notation(),
            "setup_s": setup_s, "checked_window_s": wall,
            "steady_images": STEADY_IMAGES, "steady_img_per_s": steady,
            "stage_p50_ms": [s["service_p50_s"] * 1e3 for s in snap["stages"]],
            "stage_occupancy": [s["occupancy"] for s in snap["stages"]],
            "micro_batches": stage_batches[0], "launches": counts,
            "bitwise_vs_single_stage": bitwise,
            "max_abs_diff_vs_torch_route": float((got - ref).abs().max()),
            "allclose_vs_torch_route": close,
            "tolerance_vs_torch_route": f"rtol={SERVE_RTOL}, atol={SERVE_ATOL}",
            "single_stage_img_per_s": single["throughput"],
            "torch_route_img_per_s": plain["throughput"],
        }
    }))
    check(bitwise, "served outputs differ from the single-stage cuda_fused engine")
    check(close, "served outputs differ from the plain torch route beyond tolerance")

    # ------------------------------------------------ 5. kernels line
    kernels = []
    for name, meta in KERNELS.items():
        t = totals[name]
        kernels.append({
            "name": name, "route": "cuda", "source": meta["source"],
            "replaces": meta["replaces"], "launches": counts[name],
            "max_abs_err": t["max_abs_err"], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": "operations" if t["flop_ms"] >= t["byte_ms"] else "bytes",
            "library_ms": t["library_ms"],
        })
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
