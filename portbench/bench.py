"""One run of one cell: set-up, the window, the judgement, the readings.

Everything that belongs to one configuration, traffic mix or metric is
found by name under ``portbench/``: ``configs/<config>.json`` (sizes,
weights, the limit of the comparison), ``reference/<config>.py`` (the
plain reference), ``counts/<config>.py`` (the frozen counts),
``traffic/<mix>.json`` (read by ``traffic.py``), ``e2e/<metric>.py`` and
``layers/<metric>.py`` (one reader a metric).  The program is reached
only through ``repro_torch.serving.planner.serve`` and the server and
tickets it returns.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import os
import re
import subprocess
import time
from typing import Any, Dict, List, Optional

import torch

from . import traffic as traffic_mod
from . import yardstick as Y
from .readers import percentile
from .reference.common import precision
from .trace import Tracer, summarize
from .weights import make_images, make_weights

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
TRACE_MAX_S = 6.0  # the traced window: at most this long
REF_BLOCK = 32  # images a reference call
SMI_QUERY = "name,power.limit,clocks.sm,temperature.gpu,power.draw"


def load_spec(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(rel: str) -> dict:
    with open(os.path.join(ROOT, rel)) as f:
        return json.load(f)


def load_reader(kind: str, name: str):
    """``portbench/<kind>/<name>.py``, a reader module found by its name."""
    path = os.path.join(HERE, kind, f"{name}.py")
    mod_name = f"portbench.{kind}.{re.sub(r'[^0-9A-Za-z_]', '_', name)}"
    spec = importlib.util.spec_from_file_location(mod_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class Cell:
    """A workload of BENCHMARK.json with its files resolved by name."""

    name: str
    chips: int
    config: dict
    mix: dict
    reference: Any
    counts: Any
    end_to_end: List[str]
    per_layer: List[str]

    @classmethod
    def resolve(cls, spec: dict, name: str) -> "Cell":
        entry = next((w for w in spec["workloads"] if w["name"] == name), None)
        if entry is None:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        return cls.of(spec, name, entry["config"], entry["traffic"], int(entry["chips"]))

    @classmethod
    def named(cls, spec: dict, name: str) -> "Cell":
        """A workload of BENCHMARK.json, or else ``<config>.<traffic>``
        made from its files (a cell kept for later)."""
        if any(w["name"] == name for w in spec["workloads"]):
            return cls.resolve(spec, name)
        return cls.of(spec, name, *name.split(".", 1))

    @classmethod
    def of(cls, spec: dict, name: str, config: str, traffic: str, chips: int = 1) -> "Cell":
        """A cell of ``config`` under ``traffic``; a configuration that
        BENCHMARK.json does not list is read from ``configs/<config>.json``."""
        cfg_file = next((c["file"] for c in spec["configs"] if c["name"] == config),
                        os.path.join("portbench", "configs", f"{config}.json"))
        applies = lambda m: name in m.get("workloads", [name])
        return cls(
            name=name,
            chips=chips,
            config=_json(cfg_file),
            mix=_json(os.path.join("portbench", "traffic", f"{traffic}.json")),
            reference=importlib.import_module(f"portbench.reference.{config}"),
            counts=importlib.import_module(f"portbench.counts.{config}"),
            end_to_end=[m["name"] for m in spec["end_to_end"] if applies(m)],
            per_layer=[m["name"] for m in spec["per_layer"] if applies(m)],
        )


@dataclasses.dataclass
class Run:
    """What the readers read: the window's requests and counters, the
    trace summary (traced runs), the counted layers, the set-up time."""

    cell: Cell
    window: traffic_mod.Window
    layers: list
    batch: int
    setup_s: float
    trace: Optional[dict] = None


def nvidia_smi() -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={SMI_QUERY}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20,
        )
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip() or None


class GcPauses:
    """The interpreter's garbage collections while the run lasts, timed
    (every Python thread waits through one)."""

    def __init__(self):
        self.spans: List[tuple] = []
        self._begun = 0.0
        gc.callbacks.append(self._note)

    def _note(self, phase, info) -> None:
        now = time.perf_counter()
        if phase == "start":
            self._begun = now
        else:
            self.spans.append((info["generation"], self._begun, now))

    def close(self) -> None:
        if self._note in gc.callbacks:
            gc.callbacks.remove(self._note)

    def summary(self, t0: float, t1: float) -> Dict[str, list]:
        """{generation: [collections, seconds, longest]} in [t0, t1]."""
        out: Dict[str, list] = {}
        for gen, a, b in self.spans:
            if t0 <= a <= t1:
                n, tot, top = out.get(str(gen), [0, 0.0, 0.0])
                out[str(gen)] = [n + 1, tot + b - a, max(top, b - a)]
        return out


def _graph(config: dict):
    from repro_torch.cnn.models import MODELS

    graph = MODELS[config["model"]]()
    graph.input_shape = tuple(config["input"])
    return graph


def pool_images(cell: Cell, seed: int, device) -> list:
    """The pool of images the traffic submits, one tensor an image: in
    host memory (the mix's ``ingress`` is ``host``, the default), or left
    on the card where they were made (``card``: decoded upstream on the
    card, so stage 0 takes them without a host copy)."""
    images = make_images(int(cell.mix["pool"]), cell.config["input"], seed, device)
    ingress = cell.mix.get("ingress", "host")
    if ingress == "host":
        images = images.cpu()
    elif ingress != "card":
        raise ValueError(f"ingress {ingress!r}: host or card")
    if images.device.type == "cuda":
        torch.cuda.synchronize(images.device)
    return list(images.unbind(0))


def reference_probs(cell: Cell, seed: int, device, mode: str = "f32", batch: int = REF_BLOCK):
    """The reference's probabilities for every image of the pool, made
    again from the seed, in blocks of ``batch`` images."""
    cfg = cell.config
    layers = cell.reference.layers(cfg["input"][0])
    params = make_weights(layers, seed, cfg["weights"], device)
    images = make_images(int(cell.mix["pool"]), cfg["input"], seed, device)
    with torch.no_grad(), precision(mode):
        return torch.cat([
            cell.reference.forward(params, images[i:i + batch])
            for i in range(0, images.shape[0], batch)
        ])


def worst_gap(probs: torch.Tensor, ref: torch.Tensor) -> float:
    """max over rows of ||p - r|| / ||r||."""
    return float(((probs - ref).norm(dim=1) / ref.norm(dim=1)).max())


def judge(cell: Cell, window: traffic_mod.Window, seed: int, device) -> Dict[str, dict]:
    """Every answer the run produced against the reference's for its image,
    and every admitted request resolved."""
    classes = int(cell.config["classes"])
    served = [r for r in window.requests if r.output is not None]
    unresolved = sum(1 for r in window.requests if r.admitted and r.output is None)
    misshapen = sum(1 for r in served if tuple(r.output.shape) != (1, classes))
    compared = {
        "unresolved": {"value": unresolved, "limit": 0},
        "misshapen": {"value": misshapen, "limit": 0},
    }
    ok = [r for r in served if tuple(r.output.shape) == (1, classes)]
    gap = None  # nothing to compare fails the run
    if ok:
        ref = reference_probs(cell, seed, device)
        idx = torch.tensor([r.pool_index for r in ok], device=device)
        probs = torch.cat([r.output.to(device) for r in ok])
        gap = worst_gap(probs, ref[idx])
    name = cell.config["correct"]["number"]
    compared = {name: {"value": gap, "limit": cell.config["correct"]["limit"]}, **compared}
    return compared


def passes(compared: Dict[str, dict]) -> bool:
    return all(c["value"] is not None and c["value"] <= c["limit"] for c in compared.values())


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device="cuda",
             t_start: Optional[float] = None):
    """Set up, drive the window, judge and read the metrics.  Returns the
    result (the last line, as a dict) and the run's other facts (earlier
    lines and the run file)."""
    from repro_torch.serving.planner import serve

    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    cfg, mix = cell.config, cell.mix
    batch = int(mix["batch_size"])
    layers = cell.counts.layers(cfg["input"][0])
    params = make_weights(layers, seed, cfg["weights"], device)
    images = pool_images(cell, seed, device)
    server = serve(
        _graph(cfg), backend=cfg["route"], batch_size=batch,
        flush_timeout_s=float(mix["flush_timeout_s"]),
        queue_depth=int(mix.get("queue_depth", 2)), params=params, device=device,
    )
    info: Dict[str, Any] = {
        "plan": server.plan.pipeline.notation(),
        "stages": [list(a) for a in server.plan.allocation],
    }
    if trace:
        seconds = min(seconds, TRACE_MAX_S)
    tracer = Tracer() if trace and device.type == "cuda" else None
    smi_before = nvidia_smi() if device.type == "cuda" else None
    load_before = os.getloadavg()
    # The window starts from a collected heap, frozen as a long-running
    # server freezes its start-up heap: a full collection in the window
    # then scans what the traffic made, not every object of the set-up.
    gc.collect()
    gc.freeze()
    info["gc_frozen_objects"] = gc.get_freeze_count()
    pauses = GcPauses()
    try:
        window = traffic_mod.drive(
            server, images, mix, seconds, seed,
            on_start=tracer.start if tracer else None,
            on_end=tracer.stop if tracer else None,
        )
        service = [(st["service_p50_s"], st["service_p99_s"]) for st in server.metrics.snapshot()["stages"]]
    finally:
        pauses.close()
        gc.unfreeze()
        server.stop(timeout=traffic_mod.DRAIN_S)
    smi_after = nvidia_smi() if device.type == "cuda" else None
    setup_s = window.t0 - t_start
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    run = Run(cell, window, layers, batch, setup_s)
    if tracer is not None:
        ops, calls = tracer.events()
        epoch = time.time_ns() - time.perf_counter_ns()
        run.trace = summarize(ops, calls, int(window.t0 * 1e9) + epoch, int(window.t1 * 1e9) + epoch)
    del server, params, images, tracer
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    compared = judge(cell, window, seed, device)
    names = cell.per_layer if trace else cell.end_to_end
    kind = "layers" if trace else "e2e"
    units = {m["name"]: m["unit"] for m in load_spec()["per_layer" if trace else "end_to_end"]}
    metrics = {}
    for name in names:
        value = load_reader(kind, name).read(run)
        if value is not None:
            metrics[name] = {"value": value, "unit": units[name]}
    wreqs = window.window_requests()
    failed = sum(1 for r in wreqs if r.output is None)
    result = {
        "correct": passes(compared),
        "attempted": len(wreqs),
        "failed": failed,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if device.type == "cuda" else device.type,
            "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
            "count": cell.chips,
            "memory_peak_bytes": int(peak),
        },
    }
    if run.trace is not None:
        result["device"]["busy_s"] = run.trace["busy_s"]
        result["device"]["window_s"] = run.trace["window_s"]
        result["breakdown"] = run.trace["breakdown"]
    result["compared"] = compared

    stage0 = [(b1[1] - b0[1], b1[2] - b0[2]) for b0, b1 in zip(window.stages0, window.stages1)][0]
    late = [r.submitted - r.due for r in wreqs if r.submitted is not None]
    info.update({
        "workload": cell.name, "seed": seed, "seconds": window.seconds, "trace": trace,
        "device": result["device"]["kind"], "device_count": torch.cuda.device_count() if device.type == "cuda" else 0,
        "nvidia_smi": {"query": SMI_QUERY, "before": smi_before, "after": smi_after},
        "requests": len(window.requests), "window_requests": len(wreqs),
        "shed": sum(1 for r in wreqs if r.shed), "errors": sum(1 for r in wreqs if r.error is not None),
        "generator_late_ms": {q: 1e3 * (percentile(late, q) or 0.0) for q in (50, 99, 100)},
        "latency_ms": {q: 1e3 * min(percentile([r.latency_s() for r in wreqs], q) or 0.0, traffic_mod.DRAIN_S)
                       for q in (50, 90, 95, 99)},
        "stage0_fill": stage0[0] / stage0[1] if stage0[1] else None,
        "stage_busy_s": [b1[0] - b0[0] for b0, b1 in zip(window.stages0, window.stages1)],
        "graph_launches": window.launches1 - window.launches0,
        "gc_pauses": pauses.summary(window.t0, window.t1),
        "stage_service_p50_p99_s": service,
        "host": {"cpus": len(os.sched_getaffinity(0)), "loadavg_before": load_before,
                 "loadavg_after": os.getloadavg()},
        "setup_s": setup_s,
    })
    if run.trace is not None:
        from .readers import kernel_roofline, mfu

        info["kernel_roofline_f32_pct"] = kernel_roofline(run, Y.PEAK_FLOPS_F32)
        info["mfu_f32_pct"] = mfu(run, Y.PEAK_FLOPS_F32)
        info["kernel_busy_s"] = run.trace["kernel_busy_s"]
    return result, info
