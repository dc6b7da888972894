"""A traced run of one cell with the server's span log on, read beside
the device trace.

    python3 portbench/spantrace.py --workload <name> --seed <n> [--seconds 6]

This is ``run.py --trace 1``: set-up, window, judgement, readers and
output are the harness's own.  For the run, four names of ``bench`` are
swapped: the tracer also turns the span log on and off at the window's
edges, times the interpreter's collections from the window's start until
the trace is read, and reads the span facts beside the trace; ``Run``
carries the spans and each stage's device seconds to the readers;
``load_spec`` adds the span metrics (``SPAN_METRICS``) beside
the benchmark's own; ``serve`` hands over the server.  One line more
comes before the result line (``portbench spans``: idle seconds by span,
the clock check, each stage's device seconds, the drops), and
``portbench-runs/<workload>.<seed>.spans.json`` holds those facts with
the records.  Once ``bench.py`` starts the span log in its traced window
this file has no more to do.
"""
import argparse
import dataclasses
import functools
import json
import os
import sys
from typing import Optional
from unittest import mock

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
os.environ.setdefault("USE_FLAX", "0")

from portbench import run as run_mod  # noqa: E402  (its clock starts here)
from portbench import bench  # noqa: E402
from portbench import spans as S  # noqa: E402
from repro_torch.serving import planner  # noqa: E402

CELL = "vgg16.offline.card.b32"
SPAN_METRICS = [
    {"name": "stage_device_balance.offline", "unit": "ratio", "better": "higher",
     "source": "device_trace", "layer": "server", "moves": "img_per_s", "workloads": [CELL]},
    {"name": "handoff_p50_ms.offline", "unit": "ms", "better": "lower",
     "source": "program_span", "layer": "server", "moves": "img_per_s", "workloads": [CELL]},
    {"name": "ingress_gather_share.offline", "unit": "%", "better": "lower",
     "source": "program_span", "layer": "ingress", "moves": "img_per_s", "workloads": [CELL]},
]


class Capture:
    """What one traced run with the span log on leaves for its readers."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self.server = None
        self.run = None
        self.log = None
        self.records = None
        self.pauses = None
        self.device_s = None
        self.facts = None

    def serving(self, serve):
        def wrapped(*args, **kwargs):
            self.server = serve(*args, **kwargs)
            return self.server
        return wrapped

    def read_trace(self, ops, calls) -> None:
        """The span facts of the window, on the profiler's clock."""
        offset = S.clock_offset()
        t0, t1 = (t + offset for t in S.window_ns(self.run))
        mapped = S.shifted(self.records, offset)
        pauses = [(int(a * 1e9) + offset, int(b * 1e9) + offset) for _, a, b in self.pauses.spans]
        self.device_s = S.stage_device_seconds(mapped, calls, ops, t0, t1)
        idle = S.idle_by_span(ops, calls, mapped, pauses, t0, t1)
        idle_s = sum(idle.values())
        self.facts = {
            "span_records": len(self.records), "span_drops": self.log.dropped,
            "span_capacity": self.capacity,
            "redispatched_records": sum(1 for s in self.records if s.redispatched),
            "clock_offset_ns": offset,
            "clock_check": S.clock_check(mapped, calls, t0, t1),
            "idle_by_span": idle, "idle_s": idle_s,
            "idle_named_share": (1.0 - (idle.get(S.BETWEEN, 0.0) + idle.get(S.UNTRACED, 0.0)) / idle_s)
            if idle_s else None,
            "stage_streams": S.stage_streams(mapped, calls, ops),
            "stage_device_s": self.device_s,
        }
        print("portbench spans " + json.dumps(self.facts), flush=True)


class SpanTracer(bench.Tracer):
    """The harness's tracer, with the span log on inside its window and a
    collection timer from its start until the trace is read."""

    def __init__(self, capture: Capture):
        super().__init__()
        self.capture = capture

    def start(self) -> None:
        super().start()
        self.capture.pauses = bench.GcPauses()
        self.capture.server.metrics.start_spans(self.capture.capacity)

    def stop(self) -> None:
        c = self.capture
        c.log = c.server.metrics.stop_spans()
        super().stop()
        c.records = c.log.records()

    def events(self):
        # The collection timer stays on past the window's close: a full
        # collection runs finalizers, during which the harness's thread
        # can close the window, so one that began in the window may end
        # after it.
        self.capture.pauses.close()
        ops, launched = super().events()
        self.capture.read_trace(ops, S.runtime_calls(self.prof))
        return ops, launched


@dataclasses.dataclass
class SpanRun(bench.Run):
    """The harness's run, with the spans (host clock) and each stage's
    device seconds for the span metrics' readers."""

    capture: Optional[Capture] = None

    def __post_init__(self):
        self.capture.run = self  # made before the trace is read

    @property
    def spans(self):
        return self.capture.records

    @property
    def stage_device_s(self):
        return self.capture.device_s


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=bench.TRACE_MAX_S)
    args = ap.parse_args(argv)

    capture = Capture(S.SPAN_CAPACITY)
    load_spec = bench.load_spec

    def with_span_metrics(root=bench.ROOT):
        spec = load_spec(root)
        return dict(spec, per_layer=spec["per_layer"] + SPAN_METRICS)

    with mock.patch.object(bench, "Tracer", functools.partial(SpanTracer, capture)), \
            mock.patch.object(bench, "Run", functools.partial(SpanRun, capture=capture)), \
            mock.patch.object(bench, "load_spec", with_span_metrics), \
            mock.patch.object(planner, "serve", capture.serving(planner.serve)):
        rc = run_mod.main(["--workload", args.workload, "--seed", str(args.seed),
                           "--seconds", str(args.seconds), "--trace", "1"])
    if rc == 0:
        with open(os.path.join(ROOT, "portbench-runs", f"{args.workload}.{args.seed}.spans.json"), "w") as f:
            json.dump(dict(capture.facts, records=[list(s) for s in capture.records]), f)
    return rc


if __name__ == "__main__":
    sys.exit(main())
