#!/usr/bin/env python3
"""Sweep build-time variants of the port's B5 (flash-decode), B3 (GEMM),
B6 (SSD scan) and B4 (patch matrix) kernels, and of B1 (fused conv) and
B2 (fused fc GEMM), which share B3's source, on one NVIDIA card, beside
the library call each one is held to; and time B1q (the quantized conv)
beside its first version.

    python3 benchmarks/port_kernel_variants.py [--out FILE] [--only SECTIONS] [--old DIR]

from the repo root.  ``--old DIR`` names the ``csrc`` directory of an
earlier tree: the sources of it that a section knows how to call are
built and timed beside the built ones, in the same process (``ssd.cu``
with the first, one-block-per-sequence ``ssd_fwd``; ``conv_fused.cu``
with the first int32 ``conv_fused_i32`` or the first f32
``conv_fused_f32``; ``matmul_fused.cu``; ``im2col.cu`` with the first,
one-block-per-row ``im2col_f32`` on contiguous input).

Each variant is ``src/repro_torch/kernels/csrc/<kernel>.cu`` with some
of its constants (B5, B6) or tile definitions (B3) replaced, built by nvcc
into a temporary directory (all builds at once) and loaded with ctypes;
the variant named ``built`` is the source as it stands.  Prints one JSON
object per line and, with ``--out``, writes them all to FILE:

* ``flash_decode``: at Hymba-1.5B's served shape (batch 4, 5 KV heads,
  G 5, D 64, 1024 slots, bf16) and at ``decode_32k``'s (batch 16, 32768
  slots): each variant's device time and its error in bf16 ulps of the
  plain version in f32, ``F.scaled_dot_product_attention``'s time, and
  the time of a copy-only kernel that moves the same cache rows through
  the same cp.async pattern (what the memory system allows);
* ``registers``: each kernel's registers a thread as ptxas reports them;
* ``gemm``: at each distinct conv GEMM of VGG-16 at batch 4, each
  variant's time for each of its tile variants (``gemm_f32_tiled``;
  ``registers`` swaps where the slice totals live), all of which must
  give the same bits, beside ``torch.mm`` (TF32 off);
* ``gemm_fc``: the built kernel's skinny path at the three fc GEMMs;
* ``conv``: B1 at each distinct conv of VGG-16 at batch 4, each variant
  for each of its tile variants (``conv_fused_f32``'s ``shape``), all of
  which must give the same bits, beside the old kernel (``--old``) and
  ``F.conv2d`` (TF32 off);
* ``fc``: B2 at the three fc layers at batch 4 (the built kernel, the old
  one, ``torch.addmm``);
* ``ssd``: B6 at Hymba-1.5B's served prefill (batch 4, 896 steps, 50
  heads of P 64, N 16, chunk 64, bf16, B and C at head stride 0): each
  variant's time and its error over the plain version's bar, the old
  kernel's (``--old``), the built kernel's memset and launch apart
  (``torch.profiler``), and the cycles of each phase of a block (mean and
  95th percentile over the chunks, from a build that clocks them);
* ``qconv``: B1q at each conv of VGG-16 at batch 4: the kernel alone on
  ready u8 operands for each of its tile variants (all bitwise equal to
  the plain version), the whole call (quantization included), the
  quantization alone, and the old int32 kernel on ready shifted operands
  (``--old``), with the bound on the int8 tensor cores;
* ``im2col``: B4 at each distinct conv of VGG-16 at batch 4 (and summed
  over the 13 convs): each variant (span size, loads in flight a thread,
  evict-first stores, registers) on the path its input takes, alone and
  followed by the conv's GEMM (B3, which reads the matrix back), the
  built kernel's staged path forced, the old kernel (``--old``), and the
  library yardstick ``im2col_library`` (``F.pad`` plus one strided copy,
  and the copy alone on the padded input), every one bitwise equal to
  ``im2col_ref``; with each layer's byte bound (input read once, patch
  matrix written once, over 3.35 TB/s).

Times are device times: a run of calls queued behind a sleep kernel,
between two CUDA events.  Nothing here runs without a card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

FD_VARIANTS = {
    "built": {},
    "warps4": {"WARPS": "4"},
    "warps1": {"WARPS": "1"},
    "stages4": {"NSTAGE": "4"},
    "rows2": {"U": "2"},
    "rows8": {"U": "8"},
}
GEMM_VARIANTS = {
    "built": {},
    "stages4": {0: "<128, 64, 8, 8, 16, 4>", 1: "<64, 128, 8, 8, 16, 4, true, 3>",
                2: "<64, 64, 8, 4, 32, 4, false, 3>"},
    "registers": {0: "<128, 64, 8, 8, 16, 3, true, 3>", 1: "<64, 128, 8, 8, 16, 3>",
                  2: "<64, 64, 8, 8, 16, 3, true, 3>"},
    "bk16": {2: "<64, 64, 8, 4, 16, 3, false, 3>", 3: "<32, 64, 8, 4, 16, 3>"},
    "wide": {1: "<128, 128, 8, 8, 16, 3>", 3: "<64, 32, 8, 4, 32, 3>"},
}
SSD_VARIANTS = {
    "built": {},
    "registers80": {"MINB": "3"},  # three blocks an SM, up to 80 registers a thread
    "threads128": {"NT": "128", "MINB": "8"},
    "phase_clocks": {"CLOCK_TICKETS": "4096"},  # the built kernel with its phases clocked
}
IM2COL_VARIANTS = {
    "built": {},
    "span2k": {"SPAN4": "2048"},
    "stage2k": {"STAGE": "2048"},
    "stage8k": {"STAGE": "8192"},
    "unroll2": {"U": "2"},
    "unroll8": {"U": "8"},
    "plain_stores": {"STREAMING": "0"},
    "uncapped": {"MINB": "1"},  # registers as the compiler likes (94 staged, 46 16-byte)
    "minb8": {"MINB": "8"},  # registers capped for 8 blocks of 256 an SM
}
SSD_PHASES = ("staged", "scanned", "weights", "H_c and waited", "state loaded", "published", "scores", "y")
COPY_ONLY = r"""
#include <cuda_runtime.h>
#include <stdint.h>
// The cache rows of flash_decode.cu's first pass (bf16, D = 64: 8 lanes a
// row, 16 rows a warp step, 3 stages, 2 warps, heads fastest), copied
// into shared memory and folded into one word a thread.
__global__ void copy_only(const uint4* k, const uint4* v, unsigned* out, int hkv, int W, int split) {
  extern __shared__ uint4 sm[];
  const int h = blockIdx.x, s_idx = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, r = lane / 8, piece = lane % 8;
  const int per_warp = split / 2, w0 = s_idx * split + warp * per_warp, n_steps = per_warp / 16;
  uint4* ring = sm + warp * 3 * 256;
  const int64_t rs = (int64_t)hkv * 8, base = ((int64_t)b * W * hkv + h) * 8 + piece;
  unsigned x = 0;
  auto issue = [&](int st) {
    if (st < n_steps) {
      uint4* sk = ring + (st % 3) * 256;
      for (int u = 0; u < 4; ++u) {
        const int j = u * 4 + r;
        const int64_t slot = w0 + st * 16 + j;
        unsigned d0 = (unsigned)__cvta_generic_to_shared(sk + j * 8 + piece);
        unsigned d1 = (unsigned)__cvta_generic_to_shared(sk + 128 + j * 8 + piece);
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d0), "l"(k + base + slot * rs) : "memory");
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d1), "l"(v + base + slot * rs) : "memory");
      }
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };
  issue(0);
  issue(1);
  for (int st = 0; st < n_steps; ++st) {
    asm volatile("cp.async.wait_group 1;" ::: "memory");
    const uint4* sk = ring + (st % 3) * 256;
    for (int u = 0; u < 4; ++u) {
      const int j = u * 4 + r;
      const uint4 a = sk[j * 8 + piece], c = sk[128 + j * 8 + piece];
      x ^= a.x ^ a.y ^ a.z ^ a.w ^ c.x ^ c.y ^ c.z ^ c.w;
    }
    issue(st + 2);
  }
  out[((blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x) * 64 + threadIdx.x] = x;
}
extern "C" int copy_only_launch(const void* k, const void* v, void* out, int B, int hkv, int W,
                                int split, void* stream) {
  copy_only<<<dim3(hkv, W / split, B), 64, 2 * 3 * 256 * 16, (cudaStream_t)stream>>>(
      (const uint4*)k, (const uint4*)v, (unsigned*)out, hkv, W, split);
  return (int)cudaGetLastError();
}
"""


def _variant_sources(name, variants):
    from repro_torch.kernels import build

    src = open(os.path.join(build.CSRC, f"{name}.cu")).read()
    out = {}
    for vname, subs in variants.items():
        text = src
        for key, val in subs.items():
            if isinstance(key, int):
                pat, rep = rf"using Tile{key} = Tile<[^>]*>;", f"using Tile{key} = Tile{val};"
            else:
                pat, rep = rf"constexpr int {key} = [^;]+;", f"constexpr int {key} = {val};"
            text, n = re.subn(pat, rep, text)
            if n != 1:
                raise SystemExit(f"{name}: variant {vname} matches {pat!r} {n} times")
        out[f"{name}_{vname}"] = text
    return out


def _build(sources, tmp):
    from repro_torch.kernels import build

    nvcc = build.nvcc_path()
    jobs = {}
    for name, text in sources.items():
        path = os.path.join(tmp, f"{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        jobs[name] = subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, "-Xptxas", "-v", "-o", path[:-3] + ".so", path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs, registers = {}, {}
    for name, proc in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed on {name}:\n{log}")
        libs[name] = ctypes.CDLL(os.path.join(tmp, f"{name}.so"))
        # ptxas: "Compiling entry function '<mangled>'", "N bytes spill stores",
        # then "Used N registers"
        kernels = re.findall(r"Compiling entry function '(\w+)'.*?(\d+) bytes spill stores.*?Used (\d+) registers",
                             log, re.S)
        registers[name] = {_short(k): int(r) if not int(sp) else f"{r} ({sp} bytes spilled)"
                           for k, sp, r in kernels}
    return libs, registers


def _short(mangled: str) -> str:
    """``gemm_tiled_kernel<Tile<128, 64, ...>, PatchA, NoEpi>``-like name of
    a mangled kernel (c++filt where the toolkit's host has it)."""
    try:
        name = subprocess.run(["c++filt"], input=mangled, capture_output=True, text=True,
                              timeout=10).stdout.strip() or mangled
    except OSError:
        return mangled
    name = name.replace("(anonymous namespace)::", "")
    depth = 0
    for i, ch in enumerate(name):  # drop the parameter list
        depth += ch == "<"
        depth -= ch == ">"
        if ch == "(" and depth == 0:
            return name[:i].replace("void ", "", 1)
    return name


def ssd_section(emit, libs, randn, device_ms, stream, dev):
    """B6 at Hymba-1.5B's served prefill: every variant and the old kernel,
    each against the plain version at the bf16 bar; the built kernel's
    memset and launch apart."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops
    from repro_torch.kernels import runtime as R
    from repro_torch.kernels import ssd as SSD

    b, s_len, h, p, n, q = 4, 896, 50, 64, 16, 64
    x = randn(b, s_len, h, p, dtype=torch.bfloat16)
    la = (-randn(b, s_len, h).abs() * 0.3).to(torch.bfloat16)
    B = randn(b, s_len, 1, n, scale=0.4, dtype=torch.bfloat16).expand(b, s_len, h, n)
    C = randn(b, s_len, 1, n, scale=0.4, dtype=torch.bfloat16).expand(b, s_len, h, n)
    ry, rh = SSD.ssd_ref(x, la, B, C, chunk=q)
    strides = [st for t in (x, la, B, C) for st in t.stride()[:3]]
    nc, tol = s_len // q, 5e-2

    def ratio(y, hf):
        return max(float(((y.float() - ry.float()).abs() / (tol + tol * ry.float().abs())).max()),
                   float(((hf - rh).abs() / (tol + tol * rh.abs())).max()))

    row = {"kernel": "ssd", "shape": f"B{b} S{s_len} H{h} P{p} N{n} chunk{q} bf16, B/C head stride 0",
           "plain_ms": device_ms(lambda: SSD.ssd_ref(x, la, B, C, chunk=q), 10)}
    for name, lib in libs.items():
        if not name.startswith("ssd_"):
            continue
        y, hf = torch.empty_like(x), torch.empty(b, h, n, p, device=dev)
        fn = lib.ssd_fwd
        if name == "ssd_old":  # one block per (batch, head), the chunks a loop
            fn.argtypes = [R.P] * 7 + [R.I] * 8 + [R.L] * 12 + [R.P]
            call = lambda: fn(x.data_ptr(), la.data_ptr(), B.data_ptr(), C.data_ptr(), None,  # noqa: E731
                              y.data_ptr(), hf.data_ptr(), 1, 1, b, s_len, h, p, n, q, *strides, stream())
        else:  # one block a chunk, the state handed down in order
            states = torch.empty(nc - 1, b, h, n, p, device=dev)
            sync = torch.empty(1 + nc * b * h, dtype=torch.int32, device=dev)
            fn.argtypes = [R.P] * 9 + [R.I] * 9 + [R.L] * 12 + [R.P]
            call = lambda: fn(x.data_ptr(), la.data_ptr(), B.data_ptr(), C.data_ptr(), None,  # noqa: E731
                              y.data_ptr(), hf.data_ptr(), states.data_ptr(), sync.data_ptr(), 1, 1, 7,
                              b, s_len, h, p, n, q, *strides, stream())
        R.check(call(), name)
        row[name[len("ssd_"):]] = {"ms": device_ms(call, 50), "err_over_tol": ratio(y, hf)}
    clocked = libs.get("ssd_phase_clocks")
    if clocked is not None:  # its last call's clocks: each phase's cycles, mean and 95th percentile
        import numpy as np

        n_chunks = b * nc * h
        buf = (ctypes.c_longlong * (n_chunks * 9))()
        clocked.ssd_phase_clocks.argtypes = [R.P, R.I]
        R.check(clocked.ssd_phase_clocks(ctypes.addressof(buf), n_chunks), "ssd_phase_clocks")
        marks = np.frombuffer(buf, dtype=np.int64).reshape(n_chunks, 9)
        cycles = np.diff(marks, axis=1)
        row["phase_cycles"] = {name: {"mean": float(cycles[:, i].mean()), "p95": float(np.percentile(cycles[:, i], 95))}
                               for i, name in enumerate(SSD_PHASES)}
        row["phase_cycles"]["block_total"] = float((marks[:, -1] - marks[:, 0]).mean())
    ops.ssd(x, la, B, C, chunk=q)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            ops.ssd(x, la, B, C, chunk=q)
        torch.cuda.synchronize()
    row["built_launches_ms"] = {
        (re.search(r"ssd_\w+", e.key) or re.search(r".{1,60}", e.key)).group(0):
            e.self_device_time_total / 1e3 / e.count
        for e in prof.key_averages() if e.self_device_time_total > 0}
    emit(row)


def qconv_section(emit, libs, randn, device_ms, stream, dev, vgg, shapes):
    """B1q at each VGG-16 conv at batch 4: the kernel alone on ready u8
    operands (each tile variant, bitwise), the whole call, the
    quantization, and the old int32 kernel on ready shifted operands."""
    import torch

    from repro_torch.cnn import quant as Q
    from repro_torch.kernels import conv_fused as K
    from repro_torch.kernels import runtime as R

    lib = libs["qconv_built"]
    lib.qconv_u8.argtypes = [R.P] * 9 + [R.I] * 15 + [R.P]
    old = libs.get("conv_fused_old")
    old = old if old is not None and hasattr(old, "conv_fused_i32") else None
    if old is not None:
        old.conv_fused_i32.argtypes = [R.P] * 5 + [R.I] * 12 + [R.P]
    totals = {}
    for node in vgg.major_nodes():
        if node.kind != "conv":
            continue
        h, w, c = shapes[node.inputs[0]]
        fk, st, pd, cout = node.attrs["kernel"], node.attrs["stride"], node.attrs["pad"], node.attrs["out_ch"]
        b = 4
        x = randn(b, h, w, c)
        wt = randn(fk, fk, c, cout, scale=(2.0 / (fk * fk * c)) ** 0.5)
        bias = randn(cout, scale=0.1)
        qp = Q.quantize_graph_params({"l": {"w": wt, "b": bias}})["l"]
        qargs = (qp["qw"], qp["scale"], qp["zp"], bias, qp["shape"])
        ref = K.qfused_route_ref(x, *qargs, stride=st, pad=pd, relu=True)
        qa, sa, za = Q.quantize_tensor(x, axis=None)
        wtp, colsum = K.packed_weights(qp["qw"])
        oh, ow = ref.shape[1], ref.shape[2]
        k = fk * fk * c
        geo = (b, h, w, c, fk, fk, cout, st, pd, oh, ow, 1, wtp.shape[1], int(c % 16 == 0))
        row = {"kernel": "qconv2d_fused", "layer": node.name, "m": b * oh * ow, "k": k, "n": cout,
               "za": float(za),
               "bound_ms": max(2.0 * b * oh * ow * cout * k / 1979e12,
                               (x.numel() + k * cout + 4.0 * ref.numel()) / 3.35e12) * 1e3,
               "whole_call_ms": device_ms(lambda: K.qconv2d_fused(x, *qargs, stride=st, pad=pd, relu=True), 20),
               "quantize_ms": device_ms(lambda: Q.quantize_tensor(x, axis=None), 20)}
        for t in range(-1, lib.qconv_tile_variants()):
            y = torch.empty_like(ref)
            call = lambda: lib.qconv_u8(  # noqa: E731
                qa.data_ptr(), wtp.data_ptr(), colsum.data_ptr(), za.data_ptr(), qp["zp"].data_ptr(),
                sa.data_ptr(), qp["scale"].data_ptr(), bias.data_ptr(), y.data_ptr(), *geo, t, stream())
            R.check(call(), "qconv_u8")
            row[f"built/{'auto' if t < 0 else f'tile{t}'}"] = {"ms": device_ms(call, 20),
                                                               "bitwise": bool(torch.equal(y, ref))}
        if old is not None:
            xq = qa.to(torch.int32) - za.to(torch.int32)
            wq = (qp["qw"].to(torch.int32) - qp["zp"].to(torch.int32)).reshape(qp["shape"]).contiguous()
            merged = (sa * qp["scale"]).reshape(-1).contiguous()
            y = torch.empty_like(ref)
            call = lambda: old.conv_fused_i32(  # noqa: E731
                xq.data_ptr(), wq.data_ptr(), merged.data_ptr(), bias.data_ptr(), y.data_ptr(),
                b, h, w, c, fk, fk, cout, st, pd, oh, ow, 1, stream())
            R.check(call(), "old conv_fused_i32")
            row["old"] = {"ms": device_ms(call, 10), "bitwise": bool(torch.equal(y, ref))}
        for key, val in row.items():
            if isinstance(val, dict) or key.endswith("_ms"):
                totals[key] = totals.get(key, 0.0) + (val["ms"] if isinstance(val, dict) else val)
        emit(row)
    emit({"kernel": "qconv2d_fused", "vgg16_totals_ms": totals})


def im2col_section(emit, libs, randn, device_ms, stream, vgg, shapes):
    """B4 at each distinct VGG-16 conv at batch 4: every variant, the
    staged path, the old kernel and the library copy, all bitwise."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import gemm as G
    from repro_torch.kernels import im2col as I
    from repro_torch.kernels import runtime as R

    built = {name[len("im2col_"):]: lib for name, lib in libs.items()
             if name.startswith("im2col_") and name != "im2col_old"}
    for lib in built.values():
        lib.im2col_f32.argtypes = [R.P] * 2 + [R.I] * 10 + [R.L] * 3 + [R.I, R.P]
    old = libs.get("im2col_old")
    if old is not None:  # the first kernel: one block a row, contiguous input
        old.im2col_f32.argtypes = [R.P] * 2 + [R.I] * 10 + [R.P]
    layers = {}
    for node in vgg.major_nodes():
        if node.kind == "conv":
            h, w, c = shapes[node.inputs[0]]
            key = (h, w, c, node.attrs["kernel"], node.attrs["stride"], node.attrs["pad"], node.attrs["out_ch"])
            layers.setdefault(key, []).append(node.name)
    totals = {}
    for (h, w, c, fk, st, pd, cout), names in layers.items():
        b = 4
        x = randn(b, h, w, c)
        w2 = randn(fk * fk * c, cout, scale=(fk * fk * c) ** -0.5)
        ref = I.im2col_ref(x, fk, fk, st, pd)
        oh, ow = I.out_hw(h, w, fk, fk, st, pd)
        geo = (b, h, w, c, fk, fk, st, pd, oh, ow)
        row = {"kernel": "im2col", "layers": names, "m": ref.shape[0], "k": ref.shape[1],
               "path": "16-byte" if I.wide_path(x) else "staged",
               "bound_ms": 4.0 * (x.numel() + ref.numel()) / 3.35e12 * 1e3}

        def timed(call, out):
            """The call's time, its bits, and its time with the conv's GEMM
            (B3) after it, which reads the matrix back (from L2 in part)."""
            R.check(call(), "im2col_f32")
            return {"ms": device_ms(call, 20), "bitwise": bool(torch.equal(out, ref)),
                    "then_gemm_ms": device_ms(lambda: (call(), G.gemm(out, w2)), 10)}

        for name, lib in built.items():
            for wide in ((int(I.wide_path(x)), 0) if name == "built" else (int(I.wide_path(x)),)):
                out = torch.empty_like(ref)
                call = lambda: lib.im2col_f32(  # noqa: E731
                    x.data_ptr(), out.data_ptr(), *geo, *I.kernel_strides(x), wide, stream())
                row[name if wide == int(I.wide_path(x)) else f"{name}/staged"] = timed(call, out)
        if old is not None:
            out = torch.empty_like(ref)
            row["old"] = timed(lambda: old.im2col_f32(x.data_ptr(), out.data_ptr(), *geo, stream()), out)
        xp = F.pad(x, (0, 0, pd, pd, pd, pd))
        patches = I.patch_view(xp, fk, fk, st, oh, ow)
        row["library"] = {"ms": device_ms(lambda: I.im2col_library(x, fk, fk, st, pd), 20),
                          "bitwise": bool(torch.equal(I.im2col_library(x, fk, fk, st, pd), ref))}
        row["library_copy_only"] = {"ms": device_ms(lambda: patches.reshape(ref.shape), 20),
                                    "bitwise": bool(torch.equal(patches.reshape(ref.shape), ref))}
        row["bound_share"] = row["bound_ms"] / row["built"]["ms"]
        for key, val in row.items():
            if isinstance(val, dict) or key == "bound_ms":
                totals[key] = totals.get(key, 0.0) + len(names) * (val["ms"] if isinstance(val, dict) else val)
            if isinstance(val, dict) and "then_gemm_ms" in val:
                key = f"{key}+gemm"
                totals[key] = totals.get(key, 0.0) + len(names) * val["then_gemm_ms"]
        emit(row)
        del x, w2, ref, xp, patches
    emit({"kernel": "im2col", "vgg16_totals_ms": totals,
          "bound_share": totals["bound_ms"] / totals["built"]})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the JSON lines to this file")
    ap.add_argument("--only", default="flash_decode,gemm,conv,fc,ssd,qconv,im2col",
                    help="comma-separated sections: flash_decode, gemm, conv, fc, ssd, qconv, im2col")
    ap.add_argument("--old", help="csrc directory of an earlier tree, whose kernels are timed beside")
    args = ap.parse_args()
    only = set(args.only.split(","))
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("port_kernel_variants: needs a CUDA card", file=sys.stderr)
        return 2
    from repro_torch.cnn.models import MODELS
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_decode as FD
    from repro_torch.kernels import gemm as G
    from repro_torch.kernels import runtime as R

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    lines = []

    def emit(obj):
        print(json.dumps(obj))
        lines.append(obj)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    emit({"card": smi.stdout.strip(), "device": torch.cuda.get_device_name(0)})

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, device=dev, generator=gen) * scale).to(dtype)

    def device_ms(fn, n=30):
        fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(200_000_000)  # the host queues the run before it starts
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(n):
            fn()
        e.record()
        e.synchronize()
        return s.elapsed_time(e) / n

    with tempfile.TemporaryDirectory() as tmp:
        sources = {}
        if "flash_decode" in only:
            sources.update(_variant_sources("flash_decode", FD_VARIANTS), copy_only=COPY_ONLY)
        if only & {"gemm", "conv", "fc"}:
            sources.update(_variant_sources("gemm", GEMM_VARIANTS))
        if "ssd" in only:
            sources.update(_variant_sources("ssd", SSD_VARIANTS))
        if "qconv" in only:
            sources["qconv_built"] = open(os.path.join(build.CSRC, "conv_fused.cu")).read()
        if "im2col" in only:
            sources.update(_variant_sources("im2col", IM2COL_VARIANTS))
        wanted = set()  # the earlier tree's sources the sections call
        if only & {"gemm", "conv", "fc"}:
            wanted |= {"conv_fused", "matmul_fused", "gemm"}
        if "ssd" in only:
            wanted.add("ssd")
        if "qconv" in only:
            wanted.add("conv_fused")
        if "im2col" in only:
            wanted.add("im2col")
        for name in sorted(wanted) if args.old else ():
            path = os.path.join(args.old, f"{name}.cu")
            if os.path.exists(path):
                with open(path) as f:
                    sources[f"{name}_old"] = f.read()
        libs, registers = _build(sources, tmp)
        emit({"registers": registers})
        stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

        # ------------------------------------------------ B5 flash-decode
        def fd_call(lib, q, k, v, length):
            b, hkv, g, d = q.shape
            w = k.shape[1]
            split = lib.flash_decode_split_len(w, d)
            part = torch.empty(b * hkv * -(-w // split) * g * (d + 2), device=dev)
            out = torch.empty_like(q)
            fn = lib.flash_decode_fwd
            fn.argtypes = [R.P] * 6 + [R.I] * 7 + [R.F, R.P]
            R.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), part.data_ptr(), None, 1,
                       b, hkv, g, d, w, length, 1.0 / d ** 0.5, stream()), "flash_decode_fwd")
            return out

        for label, b, w in (("served", 4, 1024), ("decode_32k", 16, 32768)) if "flash_decode" in only else ():
            hkv, g, d = 5, 5, 64
            q = randn(b, hkv, g, d, scale=0.5, dtype=torch.bfloat16)
            k = randn(b, w, hkv, d, scale=0.5, dtype=torch.bfloat16)
            v = randn(b, w, hkv, d, dtype=torch.bfloat16)
            r = FD.flash_decode_ref(q.float(), k.float(), v.float(), w)
            _, ex = torch.frexp(torch.maximum(r.abs(), r.abs().max() * 2.0 ** -8))
            ulp = torch.ldexp(torch.ones_like(r), ex - 8)
            q4, kt, vt = q.reshape(b, hkv * g, 1, d), k.transpose(1, 2), v.transpose(1, 2)
            mask = torch.ones(1, 1, 1, w, dtype=torch.bool, device=dev)  # chip_smoke.py's length mask
            row = {"kernel": "flash_decode", "shape": f"{label}: B{b} Hkv{hkv} G{g} D{d} W{w} bf16",
                   "sdpa_ms": device_ms(
                       lambda: F.scaled_dot_product_attention(q4, kt, vt, attn_mask=mask, enable_gqa=True)),
                   "bound_ms": 2.0 * (2 * q.numel() + 2 * b * w * hkv * d) / 3.35e12 * 1e3}
            if w % 512 == 0:
                sink = torch.empty(b * hkv * (w // 512) * 64, dtype=torch.int32, device=dev)
                cp = libs["copy_only"].copy_only_launch
                cp.argtypes = [R.P] * 3 + [R.I] * 4 + [R.P]
                row["copy_only_ms"] = device_ms(
                    lambda: cp(k.data_ptr(), v.data_ptr(), sink.data_ptr(), b, hkv, w, 512, stream()))
            for name, lib in libs.items():
                if name.startswith("flash_decode_"):
                    lib.flash_decode_split_len.argtypes = [R.I, R.I]
                    y = fd_call(lib, q, k, v, w)
                    row[name[len("flash_decode_"):]] = {
                        "ms": device_ms(lambda: fd_call(lib, q, k, v, w)),
                        "err_bf16_ulps": float(((y.float() - r).abs() / ulp).max())}
            emit(row)
            del q, k, v, q4, kt, vt

        # ---------------------------------------------------- B3 gemm
        vgg = MODELS["vgg16"]()
        shapes = vgg.infer_shapes()
        convs, fcs = {}, []
        for node in vgg.major_nodes():
            hin = shapes[node.inputs[0]]
            if node.kind == "conv":
                hout = shapes[node.name]
                key = (4 * hout[0] * hout[1], node.attrs["kernel"] ** 2 * hin[2], node.attrs["out_ch"])
                convs[key] = convs.get(key, 0) + 1
            else:
                fcs.append((4, int(torch.tensor(hin).prod()), node.attrs["out_features"]))
        for (m, kk, n), count in convs.items() if "gemm" in only else ():
            a, wt = randn(m, kk), randn(kk, n, scale=kk ** -0.5)
            ref = G.gemm(a, wt)
            row = {"kernel": "gemm", "m": m, "k": kk, "n": n, "layers": count,
                   "mm_ms": device_ms(lambda: torch.mm(a, wt), 10), "built_ms": device_ms(lambda: G.gemm(a, wt), 10)}
            for name, lib in libs.items():
                if not name.startswith("gemm_"):
                    continue
                fn = lib.gemm_f32_tiled
                fn.argtypes = [R.P] * 3 + [R.I] * 4 + [R.P]
                for t in range(lib.gemm_tile_variants()):
                    out = torch.empty(m, n, device=dev)
                    call = lambda: fn(a.data_ptr(), wt.data_ptr(), out.data_ptr(), m, kk, n, t, stream())  # noqa: E731
                    R.check(call(), "gemm_f32_tiled")
                    row[f"{name[len('gemm_'):]}/tile{t}"] = {"ms": device_ms(call, 10),
                                                            "bitwise": bool(torch.equal(out, ref))}
            emit(row)
        for m, kk, n in fcs if "gemm" in only else ():
            a, wt = randn(m, kk), randn(kk, n, scale=kk ** -0.5)
            emit({"kernel": "gemm_fc", "m": m, "k": kk, "n": n, "built_ms": device_ms(lambda: G.gemm(a, wt), 20),
                  "mm_ms": device_ms(lambda: torch.mm(a, wt), 20), "bound_ms": 4.0 * (m * kk + kk * n + m * n) / 3.35e12 * 1e3})
        # ------------------------------------------------ B1 fused conv
        gemm_libs = {name[len("gemm_"):]: lib for name, lib in libs.items()
                     if name.startswith("gemm_") and hasattr(lib, "conv_fused_f32")}
        for lib in gemm_libs.values():
            lib.conv_fused_f32.argtypes = [R.P] * 4 + [R.I] * 13 + [R.P]
            lib.matmul_fused_f32.argtypes = [R.P] * 5 + [R.I] * 4 + [R.P]
            lib.gemm_slice_len.argtypes = [R.I, R.I]
        old = {n: libs.get(f"{n}_old") for n in ("conv_fused", "matmul_fused")}
        if old["conv_fused"] is not None and not hasattr(old["conv_fused"], "conv_fused_f32"):
            old["conv_fused"] = None  # a tree whose conv_fused.cu holds only the quantized conv
        if old["conv_fused"] is not None:
            old["conv_fused"].conv_fused_f32.argtypes = [R.P] * 5 + [R.I] * 12 + [R.P]
        if old["matmul_fused"] is not None:
            old["matmul_fused"].matmul_fused_f32.argtypes = [R.P] * 6 + [R.I] * 4 + [R.P]
            old["matmul_fused"].matmul_fused_splits.argtypes = [R.I, R.I]
        layers = {}
        for node in vgg.major_nodes() if "conv" in only else ():
            if node.kind != "conv":
                continue
            h, w, c = shapes[node.inputs[0]]
            key = (h, w, c, node.attrs["kernel"], node.attrs["stride"], node.attrs["pad"], node.attrs["out_ch"])
            layers.setdefault(key, []).append(node.name)
        for (h, w, c, fk, st, pd, cout), names in layers.items():
            b = 4
            x = randn(b, h, w, c)
            wt, bias = randn(fk, fk, c, cout, scale=(2.0 / (fk * fk * c)) ** 0.5), randn(cout, scale=0.1)
            oh, ow = (h - fk + 2 * pd) // st + 1, (w - fk + 2 * pd) // st + 1
            geo = (b, h, w, c, fk, fk, cout, st, pd, oh, ow, 1)
            ref = torch.empty(b, oh, ow, cout, device=dev)
            R.check(gemm_libs["built"].conv_fused_f32(x.data_ptr(), wt.data_ptr(), bias.data_ptr(), ref.data_ptr(),
                                                       *geo, -1, stream()), "conv_fused_f32")
            xn, wn = x.permute(0, 3, 1, 2), wt.permute(3, 2, 0, 1)
            row = {"kernel": "conv2d_fused", "layers": names, "m": b * oh * ow, "k": fk * fk * c, "n": cout,
                   "conv2d_ms": device_ms(lambda: F.conv2d(xn, wn, bias, stride=st, padding=pd), 10),
                   "bound_ms": 2.0 * b * oh * ow * cout * fk * fk * c / 67e12 * 1e3}
            if old["conv_fused"] is not None:
                ones, y_old = torch.ones(cout, device=dev), torch.empty_like(ref)
                call = lambda: old["conv_fused"].conv_fused_f32(  # noqa: E731
                    x.data_ptr(), wt.data_ptr(), ones.data_ptr(), bias.data_ptr(), y_old.data_ptr(), *geo, stream())
                R.check(call(), "old conv_fused_f32")
                row["old"] = {"ms": device_ms(call, 10), "max_abs_diff": float((y_old - ref).abs().max())}
            for name, lib in gemm_libs.items():
                for t in range(-1, lib.gemm_tile_variants()):
                    out = torch.empty_like(ref)
                    call = lambda: lib.conv_fused_f32(  # noqa: E731
                        x.data_ptr(), wt.data_ptr(), bias.data_ptr(), out.data_ptr(), *geo, t, stream())
                    R.check(call(), "conv_fused_f32")
                    row[f"{name}/{'auto' if t < 0 else f'tile{t}'}"] = {
                        "ms": device_ms(call, 10), "bitwise": bool(torch.equal(out, ref))}
            emit(row)
            del x, ref

        # ------------------------------------------------ B2 fused fc
        for m, kk, n in fcs if "fc" in only else ():
            a, wt, bias = randn(m, kk), randn(kk, n, scale=kk ** -0.5), randn(n, scale=0.1)
            out = torch.empty(m, n, device=dev)
            lib = gemm_libs["built"]
            part = torch.empty(-(-kk // lib.gemm_slice_len(kk, n)) * m * n, device=dev)
            call = lambda: lib.matmul_fused_f32(  # noqa: E731
                a.data_ptr(), wt.data_ptr(), bias.data_ptr(), out.data_ptr(), part.data_ptr(), m, kk, n, 1, stream())
            R.check(call(), "matmul_fused_f32")
            row = {"kernel": "matmul_fused", "m": m, "k": kk, "n": n, "built_ms": device_ms(call, 20),
                   "addmm_ms": device_ms(lambda: torch.addmm(bias, a, wt), 20),
                   "bound_ms": 4.0 * (m * kk + kk * n + 2 * n + m * n) / 3.35e12 * 1e3}
            if old["matmul_fused"] is not None:
                olib = old["matmul_fused"]
                ones, y_old = torch.ones(n, device=dev), torch.empty_like(out)
                opart = torch.empty(olib.matmul_fused_splits(kk, n) * m * n, device=dev)
                ocall = lambda: olib.matmul_fused_f32(  # noqa: E731
                    a.data_ptr(), wt.data_ptr(), ones.data_ptr(), bias.data_ptr(), y_old.data_ptr(),
                    opart.data_ptr(), m, kk, n, 1, stream())
                R.check(ocall(), "old matmul_fused_f32")
                row["old"] = {"ms": device_ms(ocall, 20), "max_abs_diff": float((y_old - out).abs().max())}
            emit(row)

        # ------------------------------------------------ B6 SSD scan
        if "ssd" in only:
            ssd_section(emit, libs, randn, device_ms, stream, dev)
        # ------------------------------------------------ B1q quantized conv
        if "qconv" in only:
            qconv_section(emit, libs, randn, device_ms, stream, dev, vgg, shapes)
        # ------------------------------------------------ B4 patch matrix
        if "im2col" in only:
            im2col_section(emit, libs, randn, device_ms, stream, vgg, shapes)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            for obj in lines:
                f.write(json.dumps(obj) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
