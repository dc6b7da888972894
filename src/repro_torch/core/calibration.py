"""Microbenchmark calibration of the performance model (paper §V-B).

The paper measures ARM-CL GEMM micro-benchmarks on the target board over a
grid of layer descriptors and fits Eq. 5 / Eq. 8 by linear regression.  We
do the honest analogue on the serving device: time single-stream f32
GEMMs with PyTorch (on the card by default) for a sub-grid of the paper's
parameter values

    I_w = I_h in {7, 14, 28, 56, 112}
    F_w = F_h in {1, 3, 5}
    I_d = F_d in {32, 64, 128}        Ofm in {32, 64, 128}

and fit the Eq. 5 coefficients.  Multi-core points for the alpha fit are
*synthesised* with a concave speedup law (measured thread scaling is not
controllable in-process; recorded as an adaptation in DESIGN.md §2).

Results are cached per device type in ``calibration-<type>.json`` next to
this file because the measurement sweep takes tens of seconds; a CPU sweep
and a card sweep never share a cache.
"""
from __future__ import annotations

import json
import math
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .descriptors import ConvDescriptor, GemmDims, conv_descriptor
from .perfmodel import MultiCoreModel, SingleCoreModel

def _cache_path(device_type: str) -> str:
    return os.path.join(os.path.dirname(__file__), f"calibration-{device_type}.json")

# Sub-grid of the paper's §V-B microbenchmark sweep.
GRID_IHW = (7, 14, 28, 56, 112)
GRID_F = (1, 3, 5)
GRID_ID = (32, 64, 128)
GRID_OFM = (32, 64, 128)


def microbenchmark_grid() -> List[ConvDescriptor]:
    descs = []
    for ihw in GRID_IHW:
        for f in GRID_F:
            if f > ihw:
                continue
            for i_d in GRID_ID:
                for ofm in GRID_OFM:
                    descs.append(
                        conv_descriptor(
                            f"ub_{ihw}_{f}_{i_d}_{ofm}", ihw, i_d, f, ofm
                        )
                    )
    return descs


def _time_gemm(n: int, k: int, m: int, repeats: int = 3, device=None) -> float:
    """Median time of a single f32 [n,k]x[k,m] GEMM on ``device``.

    On the card each repeat is bracketed by CUDA events (the host clock
    would only see the enqueue); on the CPU by ``time.perf_counter``.
    """
    import torch

    from ..kernels.config import resolve_device

    dev = resolve_device(device)
    a = torch.from_numpy(
        np.random.default_rng(0).standard_normal((n, k)).astype(np.float32)
    ).to(dev)
    b = torch.from_numpy(
        np.random.default_rng(1).standard_normal((k, m)).astype(np.float32)
    ).to(dev)
    torch.matmul(a, b)  # warm the library's kernel selection
    ts = []
    for _ in range(repeats):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            torch.matmul(a, b)
            stop.record()
            stop.synchronize()
            ts.append(start.elapsed_time(stop) * 1e-3)
        else:
            t0 = time.perf_counter()
            torch.matmul(a, b)
            ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def measure_grid(
    descs: Optional[Sequence[ConvDescriptor]] = None,
    device=None,
) -> List[Tuple[Dict[str, int], float]]:
    descs = list(descs) if descs is not None else microbenchmark_grid()
    out = []
    for d in descs:
        g = d.gemm_dims()
        t = _time_gemm(g.N, g.K, g.M, device=device)
        out.append(({"N": g.N, "K": g.K, "M": g.M}, t))
    return out


def _synthetic_multicore_samples(
    single: SingleCoreModel,
    samples: Sequence[Tuple[GemmDims, float]],
    tile_size: int,
    cores: Sequence[int] = (1, 2, 3, 4),
    per_iter_dispatch_s: float = 2e-6,
    pool_overhead_s: float = 15e-6,
) -> List[Tuple[GemmDims, int, float]]:
    """Multi-threaded samples consistent with the Eq. 6-7 iteration model:
    a constant per-iteration dispatch cost plus a fixed thread-pool fork/
    join overhead.  The ceil() split of iterations over threads yields the
    concave speedup the paper observes (Fig. 11)."""
    out = []
    for dims, t1 in samples:
        n_it = max(1, math.ceil(dims.N / tile_size))
        t_iter = t1 / n_it + per_iter_dispatch_s
        for h in cores:
            iters_slowest = math.ceil(n_it / h)
            t = t_iter * iters_slowest + pool_overhead_s
            out.append((dims, h, t))
    return out


def calibrate(
    use_cache: bool = True,
    tile_size: int = 16,
    device=None,
) -> MultiCoreModel:
    """Fit the Eq. 5/8 model, measuring ``device`` if no cache exists."""
    from ..kernels.config import resolve_device

    dev = resolve_device(device)
    cache = _cache_path(dev.type)
    meas: List[Tuple[Dict[str, int], float]]
    if use_cache and os.path.exists(cache):
        with open(cache) as f:
            meas = [(s["dims"], s["t"]) for s in json.load(f)["samples"]]
    else:
        meas = measure_grid(device=dev)
        with open(cache, "w") as f:
            json.dump(
                {"samples": [{"dims": d, "t": t} for d, t in meas]}, f, indent=1
            )
    samples = [(GemmDims(**d), t) for d, t in meas]
    single = SingleCoreModel.fit(samples)
    multi_samples = _synthetic_multicore_samples(single, samples, tile_size)
    return MultiCoreModel.fit(single, multi_samples, tile_size=tile_size)


# ---------------------------------------------------------------------------
# Online correction (the adaptive runtime's calibration primitive)
# ---------------------------------------------------------------------------
#
# The offline fit above produces the Eq. 5/8 *prior*; the serving runtime
# observes actual per-stage service times (metrics.py) and folds them back
# into the time matrix as per-core-type multiplicative corrections — the
# minimal model that captures the paper's dominant error mode (Table III:
# whole-cluster mis-prediction, e.g. DVFS or contention slowing one cluster
# uniformly).  See serving/adaptive.py for the EWMA estimator.

def apply_correction(
    T: Sequence[Dict], correction: Dict[str, float]
) -> List[Dict]:
    """Scale a time matrix by per-core-type factors: ``T'[l][(ct, n)] =
    T[l][(ct, n)] * correction.get(ct, 1.0)``.  Returns a new matrix."""
    return [
        {stage: t * correction.get(stage[0], 1.0) for stage, t in row.items()}
        for row in T
    ]


def scale_core_type(
    T: Sequence[Dict], core_type: str, factor: float
) -> List[Dict]:
    """A drifted copy of ``T`` with one cluster uniformly ``factor`` x
    slower — the synthetic-drift injector used by tests and benchmarks."""
    return apply_correction(T, {core_type: factor})


def synthetic_model(tile_size: int = 16) -> MultiCoreModel:
    """A deterministic analytical model (no host measurement) for tests and
    CI: times follow a two-term roofline ``max(flops/F, bytes/B)`` with a
    fixed per-call overhead, then Eq. 5 is fitted to it."""
    F, B, C = 2.0e9, 8.0e9, 30e-6  # flops/s, bytes/s, fixed cost (1 ARM core)
    descs = microbenchmark_grid()
    samples = []
    for d in descs:
        g = d.gemm_dims()
        t = max(g.flops / F, g.bytes_touched() / B) + C
        samples.append((g, t))
    single = SingleCoreModel.fit(samples)
    multi = _synthetic_multicore_samples(single, samples, tile_size)
    return MultiCoreModel.fit(single, multi, tile_size=tile_size)
