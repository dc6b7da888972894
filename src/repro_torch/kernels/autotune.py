"""Descriptor-keyed tile-variant autotuner for the fused conv (B1), and
cached measurements of each layer's serving route.

The paper ties its throughput model to per-layer kernel timings measured
on the deployment target (§V-B).  This module is the counterpart of the
JAX package's ``repro/kernels/autotune.py``: every conv layer's
`ConvDescriptor` maps to a geometry-only cache key
(:func:`descriptor_key`, byte-identical to the reference's, because the
performance model looks measured times up by it); on first sight the
tuner times the candidates and persists the winner to a JSON cache, so
the cost is paid once per device.

Two kinds of measurement, both cached:

* ``tune(desc)`` — the fused conv's tile variant.  The reference sweeps
  Pallas (bm, bn, bk) blocks; the port's ``csrc/gemm.cu`` kernel has a
  fixed set of register-tile variants (``gemm.tile_variants()``), and
  ``-1`` lets the kernel choose one from the shape.  Every variant sums
  each output in the same order, so the pick moves no output bit and is
  made by time alone.  The sweep runs where B1 really runs: on a CUDA
  device, at the layer's full geometry and at the tuner's ``batch``, the
  micro-batch that will serve (``serve(autotune=True)`` passes its
  ``batch_size``): a pick made at one batch can lose to the heuristic at
  another, because the kernel's own choice follows M = B*OH*OW.  An
  entry swept at another batch is a miss.  On the CPU the tuner records
  the heuristic (``-1``) without timing (``swept=False``).
* ``measure_route(desc, fn, route)`` — the time of the layer's *serving
  route* (``fn`` runs one full layer), stored PER ROUTE so a ``"cuda"``
  measurement is never served as a ``"cuda_fused"`` one.  These are the
  numbers `LayerTimePredictor` consumes as measured single-stream layer
  times (core/perfmodel.py).

What a time is: one call's device time, best of ``repeats`` after one
warm call.  On a CUDA device the call is bracketed by a pair of
``torch.cuda.Event(enable_timing=True)`` on the current stream, enqueued
behind a sleep kernel that outlasts the host's enqueue of the call, so
the time between the events is the device's work and not the host's
launch rate (a graph-replayed server never pays the per-call dispatch,
and a bias from it would be larger than the gaps between tile variants);
on the CPU it is ``time.perf_counter`` around the call.  Nothing is timed while the
current stream is being captured into a CUDA graph: a cache miss there
raises, so every descriptor a graph runs is tuned before its capture
(``KernelBackend.tune_graph``).

Cache file format (``autotune_cache.json`` next to this module, override
with ``REPRO_TORCH_AUTOTUNE_CACHE``; never the JAX tuner's file or
variable, and keyed by device name, so neither package ever adopts the
other's entries)::

    {"version": 1,
     "platforms": {
       "NVIDIA H100 80GB HBM3": {
         "conv_fused/f32/i14x14x512/f3x3/s1/p1/g1/ofm512": {
           "variant": 2, "batch": 4,      # the pick, and the batch it was timed at
           "time_s": 1.2e-4,              # the chosen candidate's seconds
           "candidate_s": {"-1": 1.3e-4, "0": 1.4e-4, ...},
           "routes": {"cuda_fused": 1.2e-4},  # serving-route seconds
           "swept": true, "candidates": 5},
       ...}}}

Keys carry geometry, not layer names, so every VGG-16 3x3/512 conv at
14x14 shares one entry.
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..core.descriptors import ConvDescriptor
from .config import DeviceLike, resolve_device
from .conv_fused import conv2d_fused, supports
from .gemm import tile_variants

_DEFAULT_CACHE = os.path.join(os.path.dirname(__file__), "autotune_cache.json")
_ENV_CACHE = "REPRO_TORCH_AUTOTUNE_CACHE"
CPU_PLATFORM = "torch-cpu"


@dataclasses.dataclass(frozen=True)
class TileConfig:
    """The fused conv's tile variant: ``-1`` (chosen by the kernel from
    the shape) or ``0 .. gemm.tile_variants() - 1``."""

    variant: int

    def as_kwargs(self) -> Dict[str, int]:
        return {"variant": self.variant}


def descriptor_key(desc: ConvDescriptor, op: str = "conv_fused") -> str:
    """Geometry-only cache key (layer-name independent)."""
    if desc.kind == "fc":
        return f"{op}/f32/fc/K{desc.i_w * desc.i_h * desc.i_d}/M{desc.ofm}"
    return (
        f"{op}/f32/i{desc.i_h}x{desc.i_w}x{desc.i_d}/f{desc.f_h}x{desc.f_w}"
        f"/s{desc.stride}/p{desc.pad}/g{desc.groups}/ofm{desc.ofm}"
    )


def candidate_variants(n_variants: Optional[int] = None) -> List[TileConfig]:
    """The sweep's candidates: the shape heuristic (``-1``) first, then
    every tile variant, so the tuned pick never loses to the heuristic at
    the batch it was timed at (a tie keeps the first).  ``n_variants`` defaults to the built
    kernel's ``gemm.tile_variants()``."""
    if n_variants is None:
        n_variants = tile_variants()
    return [TileConfig(v) for v in range(-1, n_variants)]


def _capturing(device: torch.device) -> bool:
    return device.type == "cuda" and torch.cuda.is_current_stream_capturing()


def _best_of_k(fn: Callable[[], object], k: int, device: torch.device) -> float:
    """Seconds of one call of ``fn``, best of ``k`` after one warm call.

    On a CUDA device each call is enqueued behind ``torch.cuda._sleep``
    for at least twice the host's slowest enqueue seen so far (cycles at
    <= 2 GHz), so the events time the device's work alone."""
    fn()  # warm: loads the kernel, sizes the allocator's pool
    ts = []
    if device.type != "cuda":
        for _ in range(k):
            t0 = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t0)
        return float(min(ts))
    stream = torch.cuda.current_stream(device)
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0  # the enqueue: nothing waits for the device
    for _ in range(k):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(device)
        torch.cuda._sleep(int(2 * host_s * 2.0e9) + 200_000)
        t0 = time.perf_counter()
        start.record(stream)
        fn()
        end.record(stream)
        host_s = max(host_s, time.perf_counter() - t0)
        end.synchronize()
        ts.append(start.elapsed_time(end) * 1e-3)
    return float(min(ts))


class ConvAutotuner:
    """Tile-variant + route-time cache for the ``cuda_fused`` backend.

    ``device`` is where the candidates and routes run (``None``: the
    card; a host without CUDA raises).  ``sweep=None`` sweeps exactly
    where B1 runs, a CUDA device; ``sweep=True`` on the CPU raises (the
    port has no interpret mode to sweep in).  ``batch`` is the batch the
    sweep times each candidate at (the serving micro-batch); route
    measurements run at the batch their caller gives.  ``timings_run``
    counts actual timings (not cache hits) — a warm cache keeps it at 0.

    One lock guards the entries and the file: a server's stage threads
    and ``swap_plan``'s prepare phase call the backend, and so the
    tuner, at the same time.
    """

    def __init__(
        self,
        cache_path: Optional[str] = None,
        repeats: int = 3,
        sweep: Optional[bool] = None,
        device: DeviceLike = None,
        batch: int = 1,
    ):
        if batch < 1:
            raise ValueError("batch must be >= 1")
        self.device = resolve_device(device)
        on_card = self.device.type == "cuda"
        if sweep is None:
            sweep = on_card
        if sweep and not on_card:
            raise ValueError(
                f"ConvAutotuner(sweep=True) needs a CUDA device, got {self.device}: "
                "the fused conv's tile variants run on the card only"
            )
        self.cache_path = cache_path or os.environ.get(_ENV_CACHE) or _DEFAULT_CACHE
        # the cache's platform key: the card's name, or the port's own CPU
        # key (never the JAX tuner's ``"cpu"``)
        self.platform = torch.cuda.get_device_name(self.device) if on_card else CPU_PLATFORM
        self.repeats = repeats
        self.sweep = sweep
        self.batch = batch
        self.timings_run = 0
        self._lock = threading.RLock()
        self._entries: Dict[str, dict] = {}
        self.load()

    # ------------------------------------------------------------ persistence
    #
    # The cache is an accelerator, never a correctness dependency: a
    # damaged, truncated or concurrently rewritten file must degrade to
    # re-timing, not raise.
    @staticmethod
    def _read_cache(path: str) -> dict:
        """Best-effort parse of a cache file; {} on any damage."""
        try:
            with open(path) as f:
                data = json.load(f)
        except (OSError, ValueError):
            return {}
        return data if isinstance(data, dict) else {}

    def load(self) -> None:
        """Adopt the file's entries for this platform; a damaged file or
        entry means an empty one, and the tuner re-times on demand."""
        entries = {}
        platforms = self._read_cache(self.cache_path).get("platforms", {})
        mine = platforms.get(self.platform, {}) if isinstance(platforms, dict) else {}
        for k, v in (mine.items() if isinstance(mine, dict) else ()):
            if not isinstance(v, dict):
                continue
            # drop damaged fields inside an otherwise healthy entry
            if "routes" in v and not isinstance(v["routes"], dict):
                v = {kk: vv for kk, vv in v.items() if kk != "routes"}
            if not (_is_int(v.get("variant")) and _is_int(v.get("batch"))):
                v = {kk: vv for kk, vv in v.items() if kk not in ("variant", "batch")}
            entries[k] = v
        with self._lock:
            self._entries = entries

    def save(self) -> None:
        """Merge this tuner's entries into the file atomically.

        The file is re-read and rewritten through a temp file unique to
        this writer, then ``os.replace``d: the file is always one writer's
        complete JSON (a lost update costs a re-time later, never a parse
        error), and a peer's routes for a key this tuner also holds are
        kept.  A damaged file is rebuilt."""
        with self._lock:
            data = self._read_cache(self.cache_path)
            if not isinstance(data.get("platforms"), dict):
                data = {"version": 1, "platforms": {}}
            data.setdefault("version", 1)
            mine = data["platforms"].setdefault(self.platform, {})
            if not isinstance(mine, dict):
                mine = data["platforms"][self.platform] = {}
            for key, entry in self._entries.items():
                hit = mine.get(key)
                if isinstance(hit, dict):  # merge: keep a peer's routes
                    peer = hit.get("routes")
                    routes = {**(peer if isinstance(peer, dict) else {}),
                              **entry.get("routes", {})}
                    merged = {**hit, **entry}
                    if routes:
                        merged["routes"] = routes
                    mine[key] = merged
                else:
                    mine[key] = entry
            tmp = f"{self.cache_path}.{os.getpid()}.{id(self):x}.tmp"
            try:
                with open(tmp, "w") as f:
                    json.dump(data, f, indent=1, sort_keys=True)
                os.replace(tmp, self.cache_path)
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)

    def _refuse_capture(self, what: str, key: str) -> None:
        if _capturing(self.device):
            raise RuntimeError(
                f"autotune: {what} of {key} would start while the current stream "
                "is capturing a CUDA graph; tune the graph's descriptors before "
                "capturing (KernelBackend.tune_graph)"
            )

    # --------------------------------------------------------------- tuning
    def tune(self, desc: ConvDescriptor) -> TileConfig:
        """The tile variant for this descriptor, from cache or a sweep."""
        key = descriptor_key(desc)
        with self._lock:
            hit = self._entries.get(key)
            # route-only entries (measure_route) carry no variant, and a pick
            # timed at another batch is not this one's: neither suppresses
            # the sweep
            if hit is not None and "variant" in hit and hit["batch"] == self.batch:
                return TileConfig(hit["variant"])
            self._refuse_capture("a tile sweep", key)
            entry = self._entries.setdefault(key, {})
            if (
                not self.sweep
                or desc.kind != "conv"
                or not supports(desc.f_h, desc.f_w, desc.stride, desc.groups)
            ):
                entry.update(variant=-1, batch=self.batch, time_s=None, swept=False,
                             candidates=0)
                self.save()
                return TileConfig(-1)
            rng = np.random.default_rng(0)
            x = _tensor(rng.standard_normal((self.batch, desc.i_h, desc.i_w, desc.i_d)),
                        self.device)
            w = _tensor(rng.standard_normal((desc.f_h, desc.f_w, desc.i_d, desc.ofm)) * 0.05,
                        self.device)
            b = torch.zeros(desc.ofm, device=self.device)
            cands = candidate_variants()
            times: Dict[str, float] = {}
            best, best_t = cands[0], float("inf")
            for cfg in cands:  # every variant takes every shape supports() takes
                self.timings_run += 1
                t = _best_of_k(
                    lambda v=cfg.variant: conv2d_fused(
                        x, w, b, stride=desc.stride, pad=desc.pad, relu=True, variant=v
                    ),
                    self.repeats, self.device,
                )
                times[str(cfg.variant)] = t
                if t < best_t:
                    best, best_t = cfg, t
            entry.update(variant=best.variant, batch=self.batch, time_s=best_t,
                         candidate_s=times, swept=True, candidates=len(cands))
            self.save()
            return best

    # --------------------------------------------------- route measurement
    def measured_route(self, desc: ConvDescriptor, route: str) -> Optional[float]:
        with self._lock:
            hit = self._entries.get(descriptor_key(desc))
            return None if hit is None else hit.get("routes", {}).get(route)

    def measure_route(
        self, desc: ConvDescriptor, fn: Callable[[], object], route: str = "default"
    ) -> float:
        """Seconds of the layer's serving route (``fn`` runs one full
        layer), cached per ``route`` name — measurements of one backend
        are never served as another backend's times."""
        key = descriptor_key(desc)
        with self._lock:
            hit = self.measured_route(desc, route)
            if hit is not None:
                return hit
            self._refuse_capture(f"a {route!r} route measurement", key)
            self.timings_run += 1
            t = _best_of_k(fn, self.repeats, self.device)
            entry = self._entries.setdefault(key, {"swept": False, "candidates": 0})
            entry.setdefault("routes", {})[route] = t
            self.save()
            return t

    def route_seconds(self, route: Optional[str] = None) -> Dict[str, float]:
        """{descriptor key: measured route seconds} — what the Eq. 5/8
        layer consumes (``LayerTimePredictor(measured=)``).  ``route=None``
        merges every route (the fastest per key)."""
        out: Dict[str, float] = {}
        with self._lock:
            for k, v in self._entries.items():
                routes = v.get("routes", {})
                if route is not None:
                    if route in routes:
                        out[k] = routes[route]
                elif routes:
                    out[k] = min(routes.values())
        return out

    def entry(self, desc: ConvDescriptor) -> Optional[dict]:
        with self._lock:
            return self._entries.get(descriptor_key(desc))


def _is_int(v) -> bool:
    return isinstance(v, int) and not isinstance(v, bool)


def _tensor(a: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(a.astype(np.float32)).to(device)
