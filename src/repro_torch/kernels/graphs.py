"""CUDA graphs: the port's counterpart of ``jax.jit``.

The reference compiles each stage function and the single-stage baseline
(``repro/serving/engine.py``) and the decode step
(``repro/launch/serve.py``) with ``jax.jit``.  On one card the
counterpart of a compiled program is a CUDA graph: the kernels of one
call are captured once, and every later call replays the whole graph
with one host API call (``cudaGraphLaunch``) in place of one launch per
kernel.

:class:`GraphedFn` wraps a function ``fn(consts, inputs)`` of constants
that the graph reads in place (the parameters) and inputs (a tensor or a
dict of tensors).  The first call at each signature (the inputs' names,
shapes, strides and dtypes, and the constants' identity) runs ``fn``
eagerly, on a side stream: its result is that call's, and it loads the
kernels' libraries and sets their one-time ``cudaFuncSetAttribute``
flags outside any capture.  Then it captures a :class:`Captured` graph,
which every later call at that signature replays.  On CPU tensors it
calls ``fn``, always.

A :class:`Captured` graph

- has a memory pool of its own, so two graphs replayed on two streams
  (the stages of one server) never share scratch;
- is captured with ``capture_error_mode="thread_local"``, so other
  threads may launch, allocate and synchronise meanwhile (the old epoch's
  workers while ``swap_plan`` captures the new epoch);
- is captured on a high-priority stream of PyTorch's pool.  The stage
  workers and the eager calls take default-priority streams from the
  same pool, which PyTorch hands out round-robin, so none of their work
  can land on a stream being captured; captures are serialised in the
  process, so two never share one;
- is called by copying the inputs into its static buffers on the
  caller's current stream, replaying there, and returning clones of its
  static outputs: the next replay overwrites them, while the server has
  handed the last ones to the next stage;
- gives its pool back when it is dropped: the pool stays in the
  allocator's cache until the next capture, which empties the cache as
  it begins (``torch.cuda.graph``), so a server that swaps plans holds
  at most one retired epoch's pools;
- replays one call at a time: a lock serialises the callers on the host,
  and each replay's stream waits for the previous replay's clones on the
  device, so a stalled stage worker and its replacement
  (``serving/server.py::_recover_stage``) never share the buffers.

Launch counts: each capture records its kernels' launches on a tally of
the capturing thread's own (``runtime.recording``), and each replay adds
the tally to ``runtime.launches`` and counts one graph launch.

There is no fallback: on the card a capture that fails raises.
"""
from __future__ import annotations

import threading
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import torch

from . import runtime as R

Inputs = Union[torch.Tensor, Dict[str, torch.Tensor]]
_capture_lock = threading.Lock()


def _leaves(tree: Inputs) -> Tuple[torch.Tensor, ...]:
    return (tree,) if isinstance(tree, torch.Tensor) else tuple(tree.values())


def _clone(tree: Inputs) -> Inputs:
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    return {k: t.clone() for k, t in tree.items()}


def run_on_side_stream(fn: Callable, *args) -> Any:
    """``fn(*args)`` on a side stream that waits for the caller's current
    stream, which then waits for it.  The tensors among ``args`` (and the
    values of a dict of tensors) are marked as used on the side stream,
    the result's as used on the caller's, so neither stream's allocator
    reuses them too early."""
    cur = torch.cuda.current_stream()
    side = torch.cuda.Stream(cur.device)
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        out = fn(*args)
    cur.wait_stream(side)
    for a in args:
        for t in _leaves(a) if isinstance(a, (dict, torch.Tensor)) else ():
            if isinstance(t, torch.Tensor):
                t.record_stream(side)
    for t in _leaves(out):
        t.record_stream(cur)
    return out


class Captured:
    """``fn(*buffers)`` captured once as a CUDA graph over static input
    buffers shaped like ``example``; ``keep`` holds what the graph reads
    in place (the parameters, a cache) alive as long as the graph."""

    def __init__(self, fn: Callable, example: Sequence[torch.Tensor], keep: Any = None):
        self.device = example[0].device
        self._keep = keep
        self.static_in = tuple(torch.empty_like(t) for t in example)
        self.graph = torch.cuda.CUDAGraph()
        with _capture_lock:
            stream = torch.cuda.Stream(self.device, priority=-1)
            with R.recording() as tally, torch.cuda.graph(
                self.graph, pool=torch.cuda.graph_pool_handle(), stream=stream,
                capture_error_mode="thread_local",
            ):
                self.static_out = fn(*self.static_in)
        self.tally = {name: n for name, n in tally.items() if n}
        self.replays = 0
        self._lock = threading.Lock()
        self._done: Optional[torch.cuda.Event] = None

    def __call__(self, args: Sequence[Union[torch.Tensor, int, None]]):
        """Set the static inputs (a tensor is copied, an int filled in,
        ``None`` leaves the buffer as the last replay left it), replay on
        the current stream, and return clones of the outputs."""
        with self._lock:
            stream = torch.cuda.current_stream(self.device)
            if self._done is not None:
                stream.wait_event(self._done)
            for buf, a in zip(self.static_in, args):
                if isinstance(a, torch.Tensor):
                    buf.copy_(a)
                elif a is not None:
                    buf.fill_(a)
            self.graph.replay()
            out = _clone(self.static_out)
            self._done = torch.cuda.Event()
            self._done.record(stream)
            self.replays += 1
        R.add_launches(self.tally)
        return out


class GraphedFn:
    """``fn(consts, inputs)`` as one CUDA graph per input signature on the
    card; eager on CPU tensors.  ``graphs`` maps each signature to its
    :class:`Captured` graph."""

    def __init__(self, fn: Callable[[Any, Inputs], Any]):
        self.fn = fn
        self.graphs: Dict[tuple, Captured] = {}
        self._lock = threading.Lock()

    def __call__(self, consts, inputs: Inputs):
        leaves = _leaves(inputs)
        if not leaves[0].is_cuda:
            return self.fn(consts, inputs)
        names = None if isinstance(inputs, torch.Tensor) else tuple(inputs)
        key = (id(consts), names) + tuple(
            (tuple(t.shape), t.stride(), t.dtype, t.device) for t in leaves
        )
        graph = self.graphs.get(key)
        if graph is None:
            with self._lock:
                graph = self.graphs.get(key)
                if graph is None:
                    out = run_on_side_stream(self.fn, consts, inputs)

                    def body(*buffers, _names=names):
                        return self.fn(
                            consts, buffers[0] if _names is None else dict(zip(_names, buffers))
                        )

                    self.graphs[key] = Captured(body, leaves, keep=consts)
                    return out
        return graph(leaves)
