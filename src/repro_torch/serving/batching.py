"""Micro-batching at pipeline-stage boundaries.

The paper streams one image per pipeline slot (Fig. 2): stage i processes
image z while stage i+1 processes image z-1.  A serving runtime can widen
each slot to a *micro-batch* of images without changing the pipeline
algebra — Eq. 10's stage time becomes the time for B images and Eq. 12's
throughput gains a factor ~B/T_B, which is > 1 whenever the backend
amortises per-call overhead across the batch (kernel launches here;
ARM-CL thread-pool fork/join on the board — the same ``a2/a3`` overheads
Eq. 6-8 model per GEMM call).

Two invariants keep the runtime simple and fast:

* **Fixed batch shape.**  Every micro-batch env is padded to exactly
  ``batch_size`` rows, so each stage runs one stable set of kernel
  shapes.  A partial
  flush (timeout) pays the padded rows' FLOPs; ``valid`` tracks how many
  leading rows are real images.
* **Per-image independence.**  Every graph node is batch-elementwise
  (conv/pool/fc/softmax act per image), so padded rows never contaminate
  real rows and pipelined outputs match single-image execution.
"""
from __future__ import annotations

import dataclasses
import queue
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

Env = Dict[str, torch.Tensor]


@dataclasses.dataclass
class MicroBatch:
    """A batch of ``valid`` live images travelling the pipeline together.

    ``tickets`` carries the per-image bookkeeping (request ids / futures)
    in row order; ``env`` maps tensor names to arrays whose leading
    dimension is the padded batch size.  ``id`` is given by stage 0 when
    it gathers the batch, and kept through every stage and re-dispatch,
    so the span log joins one micro-batch's spans by it.
    """

    tickets: Tuple[Any, ...]
    env: Env
    valid: int
    id: int = -1

    @property
    def padded(self) -> int:
        first = next(iter(self.env.values()))
        return int(first.shape[0]) - self.valid


def stack_envs(envs: Sequence[Env], pad_to: Optional[int] = None) -> Env:
    """Concatenate per-image envs along the batch axis, padding with zeros
    up to ``pad_to`` rows so the stage functions see one stable shape."""
    keys = envs[0].keys()
    out: Env = {}
    for k in keys:
        x = torch.cat([e[k] for e in envs], dim=0)
        if pad_to is not None and x.shape[0] < pad_to:
            zeros = x.new_zeros((pad_to - x.shape[0], *x.shape[1:]))
            x = torch.cat([x, zeros], dim=0)
        out[k] = x
    return out


def split_rows(x: torch.Tensor, valid: int) -> List[torch.Tensor]:
    """The first ``valid`` rows of a batched output, one array per image
    (keeping the leading batch dim of 1, matching per-image execution)."""
    return [x[i : i + 1] for i in range(valid)]


def gather(
    q: "queue.Queue",
    max_batch: int,
    flush_timeout_s: float,
    sentinel: Any,
    arrived: Optional[List[int]] = None,
) -> Tuple[List[Any], bool]:
    """Collect up to ``max_batch`` items from ``q``.

    Blocks for the first item, then drains more until the batch is full or
    ``flush_timeout_s`` has elapsed since the first item arrived — the
    classic size-or-deadline micro-batch trigger.  Returns
    ``(items, saw_sentinel)``; a sentinel ends collection immediately and
    is consumed (callers re-emit it downstream).  A list passed as
    ``arrived`` receives the ``perf_counter_ns`` at which the first item
    was taken (the span log's end of the wait and start of the fill).
    """
    first = q.get()
    if first is sentinel:
        return [], True
    if arrived is not None:
        arrived.append(time.perf_counter_ns())
    items = [first]
    deadline = time.perf_counter() + flush_timeout_s
    while len(items) < max_batch:
        remaining = deadline - time.perf_counter()
        if remaining <= 0:
            break
        try:
            item = q.get(timeout=remaining)
        except queue.Empty:
            break
        if item is sentinel:
            return items, True
        items.append(item)
    return items, False
