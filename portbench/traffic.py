"""The general traffic generator: one function per ``mode`` of a mix file
(``portbench/traffic/<mix>.json``), feeding a live server images from
the pool and stamping every request.  The mix also says where the pool
lies (``ingress``: ``host`` memory, the default, or ``card``, see
``bench.pool_images``), the micro-batch, the flush and the server's
``queue_depth`` (micro-batches a queue holds; the ingress holds that
many micro-batches of images; default 2).

``offline``: one feeder thread submits the pool's images in turn and
keeps at least a micro-batch waiting in the ingress: whenever a whole
micro-batch fits (``queue_depth * batch_size`` images, less those
waiting), it submits that many in a row, and else sleeps
``REFILL_POLL_S``.  Refilled a micro-batch at a time, the feeder does not
wake at each image stage 0 takes, so it does not contend with stage 0
for the interpreter while that stage gathers its micro-batch.  The
window opens once ``preroll_batches`` micro-batches have completed.

``poisson``: open-loop arrivals at ``rate`` a second, paced from the
calling thread; a full ingress sheds the request (``submit(block=False)``
raises).  Each segment (``preroll_s``, the window, ``postroll_s``) draws
its gaps from one fixed set, the exponential distribution's quantiles at
``(i + 1/2) / n``, ``n = round(rate * length)``, scaled to fill the
segment exactly and put in an order drawn from the seed: every seed
offers the same gaps and the same count in another order.  Latency runs
from a request's due time, so a late generator or a stall counts.

Outputs stay on the device until the window has closed and the run is
judged; the harness touches the card only through ``submit``.
"""
from __future__ import annotations

import dataclasses
import math
import random
import threading
import time
from typing import Any, Callable, List, Optional

from .weights import derive

MISS_S = float("inf")
REFILL_POLL_S = 0.0005  # the offline feeder's sleep while no micro-batch fits
DRAIN_S = 60.0  # how long past the window's close a request may still resolve


class Request:
    """One request's stamps and answer.  Slotted, and the ticket is let go
    once it resolves, so a request holds two objects the collector tracks
    (itself and its answer): the harness adds little to the collections
    that pause every thread of the program."""

    __slots__ = ("index", "pool_index", "due", "in_window", "submitted", "ticket", "admitted",
                 "shed", "error", "done_at", "output", "queued_s")

    def __init__(self, index: int, pool_index: int, due: float, in_window: bool = True,
                 submitted: Optional[float] = None, done_at: Optional[float] = None, output: Any = None):
        self.index, self.pool_index, self.due, self.in_window = index, pool_index, due, in_window
        self.submitted, self.done_at, self.output = submitted, done_at, output
        self.ticket = self.error = self.queued_s = None
        self.admitted = self.shed = False

    def done(self, ticket) -> None:
        """The ticket's done-callback (the egress thread): stamp, keep the
        answer and the ingress wait, drop the ticket."""
        self.done_at = time.perf_counter()
        try:
            self.output = ticket.result(timeout=0)
        except Exception as e:  # noqa: BLE001 — a failed request is a miss
            self.error = e
        if ticket.dequeued_at is not None:
            self.queued_s = ticket.dequeued_at - ticket.submitted_at
        self.ticket = None

    def latency_s(self) -> float:
        """Due time to resolution; a miss (shed, failed, never resolved)
        reads as ``MISS_S``, above every latency."""
        if self.output is None or self.done_at is None:
            return MISS_S
        return self.done_at - self.due


@dataclasses.dataclass
class Window:
    mode: str
    t0: float = 0.0
    t1: float = 0.0
    requests: List[Request] = dataclasses.field(default_factory=list)
    stages0: Any = None
    stages1: Any = None
    launches0: int = 0
    launches1: int = 0

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0

    def window_requests(self) -> List[Request]:
        return [r for r in self.requests if r.in_window]


class Marks:
    """What happens at the window's edges: the stage counters and graph
    launches are read; ``on_end`` (the tracer's stop) runs after the close."""

    def __init__(self, server, window: Window, on_end=None):
        self.server, self.window = server, window
        self.on_end = on_end

    def _read(self):
        from repro_torch.kernels import runtime

        stages = [s.totals() + (s.batches,) for s in self.server.metrics.stages]
        return stages, runtime.graph_launches()

    def start(self, t0: Optional[float] = None) -> None:
        self.window.stages0, self.window.launches0 = self._read()
        self.window.t0 = time.perf_counter() if t0 is None else t0

    def end(self, t1: Optional[float] = None) -> None:
        self.window.t1 = time.perf_counter() if t1 is None else t1
        self.window.stages1, self.window.launches1 = self._read()
        if self.on_end is not None:
            self.on_end()


def _submit(server, req: Request, image, block: bool) -> None:
    from repro_torch.serving.server import Backpressure

    req.submitted = time.perf_counter()
    try:
        req.ticket = server.submit(image, block=block)
    except Backpressure:
        req.shed = True
        return
    req.admitted = True
    req.ticket.add_done_callback(req.done)


def offline(server, images, mix, seconds: float, marks: Marks, seed: int) -> None:
    window = marks.window
    stop = threading.Event()
    errors: List[BaseException] = []
    batch = int(mix["batch_size"])
    capacity = int(mix.get("queue_depth", 2)) * batch

    def feed() -> None:
        i = 0
        try:
            while not stop.is_set():
                room = capacity - server.ingress_depth()
                if room < batch:
                    time.sleep(REFILL_POLL_S)
                    continue
                for _ in range(room):
                    req = Request(i, i % len(images), time.perf_counter())
                    _submit(server, req, images[req.pool_index], block=True)
                    window.requests.append(req)
                    i += 1
        except BaseException as e:  # noqa: BLE001 — re-raised by the caller's thread
            errors.append(e)

    feeder = threading.Thread(target=feed, name="portbench-feeder", daemon=True)
    feeder.start()
    first = int(mix["preroll_batches"]) * batch
    deadline = time.perf_counter() + DRAIN_S
    while not errors and (
        len(window.requests) < first or window.requests[first - 1].done_at is None
    ):
        if time.perf_counter() > deadline:
            raise TimeoutError("the pre-roll did not complete")
        time.sleep(0.005)
    try:
        if errors:
            raise errors[0]
        marks.start()
        time.sleep(seconds)
        marks.end()
    finally:
        stop.set()
        feeder.join(timeout=DRAIN_S)
    if errors:
        raise errors[0]
    if feeder.is_alive():
        raise TimeoutError("the feeder did not stop")
    for req in window.requests:
        req.in_window = req.done_at is None or req.done_at >= window.t0


def gaps(n: int, length: float, rng: random.Random) -> List[float]:
    """``n`` exponential quantile gaps in the seed's order, summing to ``length``."""
    q = [-math.log(1.0 - (i + 0.5) / n) for i in range(n)]
    rng.shuffle(q)
    scale = length / sum(q)
    return [g * scale for g in q]


def schedule(mix, seconds: float, seed: int):
    """``[(offset_s, in_window)]`` of every arrival, and the window's
    ``(start, end)`` offsets."""
    rng = random.Random(derive(seed, "arrivals"))
    rate = float(mix["rate"])
    out, offset = [], 0.0
    segments = ((float(mix["preroll_s"]), False), (seconds, True), (float(mix["postroll_s"]), False))
    for length, in_window in segments:
        t = offset
        for g in gaps(max(1, round(rate * length)), length, rng):
            t += g
            out.append((t, in_window))
        offset += length
    start = segments[0][0]
    return out, (start, start + seconds)


def poisson(server, images, mix, seconds: float, marks: Marks, seed: int) -> None:
    window = marks.window
    arrivals, (w0, w1) = schedule(mix, seconds, seed)
    base = time.perf_counter() + 0.05
    started = ended = False
    for i, (offset, in_window) in enumerate(arrivals):
        due = base + offset
        if not started and offset >= w0:
            marks.start(base + w0)
            started = True
        if not ended and offset > w1:
            marks.end(base + w1)
            ended = True
        wait = due - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        req = Request(i, i % len(images), due, in_window)
        window.requests.append(req)
        try:
            _submit(server, req, images[req.pool_index], block=False)
        except Exception as e:  # noqa: BLE001 — a closed server fails the request
            req.error = e
    if not ended:
        marks.end(base + w1)


MODES: dict = {"offline": offline, "poisson": poisson}


def drive(server, images, mix, seconds: float, seed: int, on_start: Callable = None,
          on_end: Callable = None) -> Window:
    """Run ``mix`` against ``server`` for a window of ``seconds``, then wait
    (at most ``DRAIN_S`` past the window) for every admitted request.
    ``on_start`` runs before the first request (the tracer starts there,
    so its own start-up lands in set-up), ``on_end`` after the window."""
    window = Window(mix["mode"])
    if on_start is not None:
        on_start()
    MODES[mix["mode"]](server, images, mix, seconds, Marks(server, window, on_end), seed)
    deadline = window.t1 + DRAIN_S
    for req in window.requests:
        ticket = req.ticket  # still pending: resolved ones have let theirs go
        if ticket is None:
            continue
        try:
            ticket.result(timeout=max(0.0, deadline - time.perf_counter()))
        except TimeoutError as e:
            req.error = e
        except Exception:  # noqa: BLE001 — the done-callback records the failure
            pass
    return window
