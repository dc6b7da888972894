"""The device trace: ``torch.profiler`` (CUPTI) over the traced window,
reduced to the device's busy time, its kernels and its idle gaps.

Only the CUDA activity is recorded (kernels, copies, sets, and the
runtime calls that launched them); no CPU operator is traced, so the
host path runs as it does untraced.  Events are clipped to the window
``[t0_ns, t1_ns]`` on the profiler's clock (Unix nanoseconds).

An idle gap is named by what ended it: the runtime call that launched
the device work after it and that work's stream (one stream a pipeline
stage), as ``cudaGraphLaunch@stream7``, or ``no_traced_host_call`` where
no traced call launched it.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Dict, Iterable, List, Sequence, Tuple

TOP = 10
NAME_CHARS = 80


@dataclasses.dataclass(frozen=True)
class DeviceOp:
    start_ns: int
    end_ns: int
    name: str
    kernel: bool  # a kernel; False for a copy or a set
    corr: int
    stream: int = 0


@dataclasses.dataclass(frozen=True)
class HostCall:
    name: str
    start_ns: int


def union(intervals: Iterable[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Merged, sorted, disjoint intervals."""
    out: List[List[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _clip(ops: Sequence[DeviceOp], t0: int, t1: int):
    for op in ops:
        a, b = max(op.start_ns, t0), min(op.end_ns, t1)
        if b > a:
            yield op, a, b


def summarize(ops: Sequence[DeviceOp], calls: Dict[int, HostCall], t0_ns: int, t1_ns: int) -> dict:
    """Busy seconds (every op; kernels alone), the window, and the
    breakdown: the ten device ops with the most time and the ten gap
    names with the most idle time."""
    clipped = list(_clip(ops, t0_ns, t1_ns))
    busy = union((a, b) for _, a, b in clipped)
    kernel_busy = union((a, b) for op, a, b in clipped if op.kernel)
    by_name: Dict[str, float] = collections.defaultdict(float)
    for op, a, b in clipped:
        by_name[op.name[:NAME_CHARS]] += (b - a) * 1e-9
    starts = sorted((op.start_ns, op) for op in ops)
    gaps: Dict[str, float] = collections.defaultdict(float)
    edges = [t0_ns] + [x for iv in busy for x in iv] + [t1_ns]
    j = 0
    for g0, g1 in zip(edges[0::2], edges[1::2]):
        if g1 <= g0:
            continue
        while j < len(starts) and starts[j][0] < g1:
            j += 1
        after = starts[j][1] if j < len(starts) else None
        call = calls.get(after.corr) if after is not None else None
        name = f"{call.name}@stream{after.stream}" if call is not None else "no_traced_host_call"
        gaps[name] += (g1 - g0) * 1e-9
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
    return {
        "busy_s": sum(b - a for a, b in busy) * 1e-9,
        "kernel_busy_s": sum(b - a for a, b in kernel_busy) * 1e-9,
        "window_s": (t1_ns - t0_ns) * 1e-9,
        "breakdown": {"device_ops": top(by_name), "idle_gaps": top(gaps)},
    }


class Tracer:
    """``torch.profiler`` with the CUDA activity alone, started and
    stopped at the window's edges (the traffic's marks)."""

    def __init__(self):
        self.prof = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()

    def stop(self) -> None:
        self.prof.stop()

    def events(self) -> Tuple[List[DeviceOp], Dict[int, HostCall]]:
        """The device's operations and, by correlation id, the runtime
        calls that launched them."""
        ops, calls = [], {}
        for e in self.prof.profiler.kineto_results.events():
            if "CUDA" in str(e.device_type()):
                ops.append(DeviceOp(
                    e.start_ns(), e.start_ns() + e.duration_ns(), e.name(),
                    not e.name().startswith(("Memcpy", "Memset")),
                    e.correlation_id() or e.linked_correlation_id(), e.device_resource_id(),
                ))
            elif e.name().startswith("cuda"):
                calls[e.correlation_id()] = HostCall(e.name(), e.start_ns())
        return ops, calls
