"""One-shot serving engines — the kernel-level baseline and the original
per-image pipelined engine.

Each pipeline stage owns (a) a contiguous node range of the CNN graph
(from a Pipe-it layer allocation, Eq. 10: the stage's service time is the
sum of its layers' times) and (b) a stage function that runs that range.
Stages run on their own host threads connected by bounded queues, and on
the card each stage thread issues its kernels on a CUDA stream of its
own; an image stream enters stage 0 and classified outputs leave the last
stage.  This is the one-thread-per-stage analogue of the paper's
one-thread-per-core ARM-CL scheduler: stage k processes image z while
stage k+1 processes image z-1 (paper Fig. 2, Layer-level), so
steady-state throughput is set by the slowest stage (Eq. 12).

These engines build their worker threads per ``run()`` call and move one
image at a time; the production runtime with persistent workers,
micro-batching and metrics lives in :mod:`repro_torch.serving.server`
(``PipelineServer``).  ``SingleStageEngine`` stays as the kernel-level
baseline (whole graph, one kernel at a time on one stream).

Where the reference jits a stage function or the whole graph, the port
captures it on the card as a CUDA graph per input shape and replays it
(``kernels/graphs.py``); :func:`build_eager_stage_fns` keeps the stage
functions op by op, which the CPU runs and which the comparisons on the
card use as the eager side.
"""
from __future__ import annotations

import contextlib
import queue
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from ..cnn.graph import Graph
from ..core.pipeline import PipelinePlan
from ..kernels.config import resolve_device, synchronize
from ..kernels.graphs import GraphedFn

StageFn = Callable[..., Dict[str, torch.Tensor]]


def stage_stream(device: torch.device) -> Optional["torch.cuda.Stream"]:
    """A CUDA stream of the calling stage's own; ``None`` on the CPU."""
    return torch.cuda.Stream(device) if device.type == "cuda" else None


def on_stream(stream):
    """Make ``stream`` the calling thread's current stream (no-op for None)."""
    return contextlib.nullcontext() if stream is None else torch.cuda.stream(stream)


def sync_stream(stream) -> None:
    """Wait until ``stream`` has run every kernel queued on it so far."""
    if stream is not None:
        stream.synchronize()


def build_eager_stage_fns(
    graph: Graph, plan: PipelinePlan, backend=None
) -> List[StageFn]:
    """One plain function per pipeline stage, run op by op.

    Each function executes the stage's contiguous node range against a
    live-tensor env and returns the pruned env that crosses the stage
    boundary (the activation transfer the platform's CCI/ICI model
    charges for).  Kernels launch on the caller's current stream.

    ``backend`` selects the kernel execution backend for the stage's
    major layers (``repro_torch.kernels.backend``: "torch",
    "cuda", "cuda_fused", a per-node mapping/callable, or a resolved
    ``KernelBackend``).  The spec is resolved ONCE here so fallback
    bookkeeping is shared across stages.  A backend with a tuner has
    every fused conv of the graph tuned here, before any stage function
    runs or is captured (the captured graphs and the eager calls then
    run the same tile variants, and no sweep starts inside a capture).
    """
    from ..kernels.backend import resolve_backend

    kb = resolve_backend(backend)
    if kb is not None:
        kb.tune_graph(graph)
    fns: List[StageFn] = []
    for start, stop in graph.stage_slices(plan.allocation):

        def stage_fn(p, env, s=start, e=stop):
            with torch.no_grad():
                return graph.apply_range(p, env, s, e, backend=kb)

        fns.append(stage_fn)
    return fns


def build_stage_fns(
    graph: Graph, plan: PipelinePlan, backend=None
) -> List[StageFn]:
    """The stage functions of :func:`build_eager_stage_fns`, each captured
    as a CUDA graph on the card at every input shape it is called with
    (the reference jits each stage), and run op by op on CPU tensors.  The
    first call at a shape runs eagerly and captures; later calls replay
    and return fresh tensors."""
    return [GraphedFn(fn) for fn in build_eager_stage_fns(graph, plan, backend=backend)]


def _as_input(image, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(image, dtype=torch.float32).to(device)


class SingleStageEngine:
    """Baseline: the whole graph as one function (kernel-level), one CUDA
    graph per input shape on the card, as the reference jits it."""

    def __init__(self, graph: Graph, params, backend=None, device=None):
        from ..kernels.backend import resolve_backend

        self.backend = resolve_backend(backend)
        if self.backend is not None:
            self.backend.tune_graph(graph)
        self.graph = graph
        self.params = params
        self.device = resolve_device(device)
        self._fn = GraphedFn(self._apply)

    def _apply(self, params, x: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return self.graph.apply(params, x, backend=self.backend)

    def warmup(self, x):
        self._fn(self.params, _as_input(x, self.device))
        synchronize(self.device)

    def run(self, images: Sequence[Any]) -> Dict[str, Any]:
        xs = [_as_input(img, self.device) for img in images]
        synchronize(self.device)
        outs = []
        t0 = time.perf_counter()
        for x in xs:
            outs.append(self._fn(self.params, x))
        synchronize(self.device)
        dt = time.perf_counter() - t0
        return {"outputs": outs, "seconds": dt, "throughput": len(images) / dt}


class PipelinedGraphEngine:
    """Layer-level pipelined execution of a CNN graph per a PipelinePlan.

    ``stage_fn_builder`` mirrors the PipelineServer hook: a
    ``(graph, plan) -> [stage_fn]`` factory replacing the default stage
    functions (fake-stage benchmarks inject scripted delays here).
    """

    def __init__(
        self, graph: Graph, params, plan: PipelinePlan,
        queue_depth: int = 4, backend=None, stage_fn_builder=None, device=None,
    ):
        self.graph = graph
        self.params = params
        self.plan = plan
        self.queue_depth = queue_depth
        self.device = resolve_device(device)
        if stage_fn_builder is None:
            self._stage_fns = build_stage_fns(graph, plan, backend=backend)
        else:
            self._stage_fns = stage_fn_builder(graph, plan)

    def warmup(self, x):
        env = {"input": _as_input(x, self.device)}
        for fn in self._stage_fns:
            env = fn(self.params, env)
        synchronize(self.device)
        return env

    def run(self, images: Sequence[Any]) -> Dict[str, Any]:
        n_stages = len(self._stage_fns)
        qs: List[queue.Queue] = [
            queue.Queue(maxsize=self.queue_depth) for _ in range(n_stages + 1)
        ]
        results: List[Optional[Any]] = [None] * len(images)
        errors: List[BaseException] = []
        inputs = [_as_input(img, self.device) for img in images]
        synchronize(self.device)  # copies done before any stage stream reads them

        def stage_worker(si: int):
            fn = self._stage_fns[si]
            try:
                stream = stage_stream(self.device)
                while True:
                    item = qs[si].get()
                    if item is None:
                        qs[si + 1].put(None)
                        return
                    idx, env = item
                    with on_stream(stream):
                        out_env = fn(self.params, env)
                    # materialize before handing off: the stage boundary is
                    # where the activation crosses clusters in the paper
                    sync_stream(stream)
                    qs[si + 1].put((idx, out_env))
            except BaseException as e:  # pragma: no cover
                errors.append(e)
                qs[si + 1].put(None)

        threads = [
            threading.Thread(target=stage_worker, args=(si,), daemon=True)
            for si in range(n_stages)
        ]
        for t in threads:
            t.start()

        t0 = time.perf_counter()

        def feeder():
            for i, x in enumerate(inputs):
                qs[0].put((i, {"input": x}))
            qs[0].put(None)

        feed = threading.Thread(target=feeder, daemon=True)
        feed.start()

        done = 0
        while done < len(images):
            item = qs[-1].get()
            if item is None:
                break
            idx, env = item
            results[idx] = next(iter(env.values()))
            done += 1
        dt = time.perf_counter() - t0
        feed.join(timeout=5)
        for t in threads:
            t.join(timeout=5)
        if errors:
            raise errors[0]
        return {
            "outputs": results,
            "seconds": dt,
            "throughput": done / dt,
            "stages": self.plan.pipeline.notation(),
        }
