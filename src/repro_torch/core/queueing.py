"""Tail-latency model for an open-loop pipeline (ROADMAP item 4).

Pipe-it's Eq. 12 plans for *saturation throughput*: 1/max_i T_{L_i}^{P_i}.
Under an open-loop arrival process (requests arrive whether or not the
board is ready — the serving regime, not the benchmark regime) the
binding constraint becomes the *waiting time* ahead of the bottleneck
stage.  This module layers a queueing model on top of the same stage-time
matrix the DSE already uses:

* Each stage is a deterministic server: the Eq. 12 stage time
  T_{L_i}^{P_i} is a constant service time (CNN inference has no
  data-dependent control flow).  A stage's core count enters through
  that multi-core service time — this is the "M/D/c-style" model: c
  cores shorten D rather than forming c independent servers, because the
  runtime data-parallelizes ONE image across the stage's cores.
* Poisson arrivals at rate ``lambda`` make stage 0 an M/D/1 queue.  For
  a *tandem* line of deterministic servers fed by one Poisson stream,
  Friedman's reduction applies: the end-to-end delay distribution equals
  (sum of all service times + transfers) + the waiting time of a single
  M/D/1 queue at the *slowest* stage, independent of stage order —
  interior stages see arrivals already smoothed by upstream service, so
  only the bottleneck accumulates a queue.
* The M/D/1 waiting-time CDF is exact (Erlang):

      P(W <= t) = (1-rho) * sum_{j=0}^{floor(t/D)}
                  [lambda (jD - t)]^j / j! * e^{-lambda (jD - t)}

  inverted by bisection for p50/p95/p99.  The alternating series is
  evaluated directly while ``lambda*t`` is small enough for double
  precision and switched to the exact asymptotic exponential tail
  ``P(W > t) ~ A e^{-theta t}`` beyond that (DESIGN.md §8).

``predict_latency(plan, T, platform, rate)`` is the public surface the
SLO-aware DSE (``pipe_it_search(slo_p99_ms=..., arrival_rate=...)``) and
the queue-aware governor rank candidates with; ``core.simulator`` is the
ground truth it is validated against (tests/test_queueing.py pins the
tolerance band below ~0.85 utilization).
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

from .pipeline import PipelinePlan, TimeMatrix
from .platform import HeteroPlatform

# Largest lambda*t the alternating Erlang series is summed directly for.
# Terms can reach ~e^{lambda*t}, so the cancellation error is about
# eps * n_terms * e^{lambda*t}: ~1e-10 absolute at 12, but already
# ~1e-3 at 30 — worse than the tail probabilities being resolved
# (tests/test_queueing.py pins CDF monotonicity/continuity across the
# hand-off).  Beyond the switch the continuity-matched asymptotic
# exponential tail is strictly more accurate.
_DIRECT_MAX = 12.0


def empirical_percentile(values: Sequence[float], q: float) -> float:
    """Nearest-rank percentile — THE canonical implementation.

    The value at (1-based) rank ``ceil(q/100 * N)`` of the sorted
    samples (clamped to [1, N]); 0.0 on empty input.  Lives in core so
    the simulator can report latency percentiles without importing the
    serving package; ``serving.metrics.percentile`` delegates here so
    serving metrics and queueing predictions can never disagree on the
    same samples.
    """
    if not values:
        return 0.0
    xs = sorted(values)
    rank = max(1, math.ceil(q / 100.0 * len(xs)))
    return xs[min(rank, len(xs)) - 1]


# --------------------------------------------------------------- M/D/1 core
def md1_mean_wait(rate: float, service_s: float) -> float:
    """Pollaczek-Khinchine mean wait for M/D/1: rho*D / (2(1-rho))."""
    rho = rate * service_s
    if rho >= 1.0:
        return math.inf
    if rho <= 0.0:
        return 0.0
    return rho * service_s / (2.0 * (1.0 - rho))


def _md1_decay_rate(rate: float, service_s: float) -> float:
    """The tail exponent theta: smallest positive root of
    lambda + theta = lambda * e^{theta D} (P(W>t) ~ A e^{-theta t})."""
    rho = rate * service_s
    # Newton from the quadratic approximation u0 = 2(1-rho)/rho,
    # u = theta*D; g(u) = rho*(e^u - 1) - u is convex with g(0)=0.
    u = 2.0 * (1.0 - rho) / rho
    for _ in range(50):
        g = rho * (math.exp(u) - 1.0) - u
        gp = rho * math.exp(u) - 1.0
        if gp <= 0.0:
            break
        step = g / gp
        u -= step
        if abs(step) < 1e-14 * max(u, 1.0):
            break
    return max(u, 1e-300) / service_s


def _md1_cdf_direct(t: float, rate: float, service_s: float) -> float:
    """Exact Erlang series for P(W <= t); valid while lambda*t is small."""
    rho = rate * service_s
    k = int(math.floor(t / service_s))
    total = 0.0
    for j in range(k + 1):
        x = rate * (j * service_s - t)  # <= 0
        total += (x ** j) / math.factorial(j) * math.exp(-x)
    return min(max((1.0 - rho) * total, 0.0), 1.0)


def md1_wait_cdf(t: float, rate: float, service_s: float) -> float:
    """P(W <= t) for the M/D/1 waiting time (exact below the numeric
    switch point, asymptotic exponential tail beyond it)."""
    if service_s <= 0.0 or rate <= 0.0:
        return 1.0 if t >= 0.0 else 0.0
    rho = rate * service_s
    if rho >= 1.0:
        return 0.0  # unstable: no steady-state wait distribution
    if t < 0.0:
        return 0.0
    if rate * t <= _DIRECT_MAX:
        return _md1_cdf_direct(t, rate, service_s)
    # Continuity-matched tail: A = P(W > t*) e^{theta t*} at the largest
    # directly-summable point t*.
    t_star = _DIRECT_MAX / rate
    theta = _md1_decay_rate(rate, service_s)
    tail_star = max(1.0 - _md1_cdf_direct(t_star, rate, service_s), 0.0)
    return min(1.0, 1.0 - tail_star * math.exp(-theta * (t - t_star)))


def md1_wait_quantile(q: float, rate: float, service_s: float) -> float:
    """The q-quantile (q in [0,1)) of the M/D/1 waiting time, by
    bisection on the exact CDF.  inf when the queue is unstable."""
    if not 0.0 <= q < 1.0:
        raise ValueError(f"quantile {q} outside [0, 1)")
    if service_s <= 0.0 or rate <= 0.0:
        return 0.0
    rho = rate * service_s
    if rho >= 1.0:
        return math.inf
    if q <= 1.0 - rho + 1e-15:
        return 0.0  # P(W = 0) = 1 - rho
    lo, hi = 0.0, max(4.0 * md1_mean_wait(rate, service_s), service_s)
    for _ in range(200):
        if md1_wait_cdf(hi, rate, service_s) >= q:
            break
        hi *= 2.0
    for _ in range(100):
        mid = 0.5 * (lo + hi)
        if md1_wait_cdf(mid, rate, service_s) >= q:
            hi = mid
        else:
            lo = mid
    return hi


# ----------------------------------------------------------- plan-level API
@dataclasses.dataclass(frozen=True)
class LatencyPrediction:
    """End-to-end latency of one plan under one Poisson arrival rate."""

    arrival_rate: float  # images/s offered
    stable: bool  # bottleneck utilization < 1
    utilization: float  # rho at the bottleneck stage
    stage_utilization: Tuple[float, ...]
    base_latency_s: float  # sum of services + transfers (zero-queue latency)
    bottleneck_s: float  # D of the reduced M/D/1 queue
    mean_wait_s: float
    p50_s: float
    p95_s: float
    p99_s: float

    def quantile(self, q: float) -> float:
        """End-to-end latency at an arbitrary quantile q in [0, 1)."""
        if not self.stable:
            return math.inf
        w = md1_wait_quantile(q, self.arrival_rate, self.bottleneck_s)
        return self.base_latency_s + w


def _plan_services(
    plan: PipelinePlan,
    T: TimeMatrix,
    platform: HeteroPlatform,
    stage_freqs: Optional[Sequence[Optional[float]]],
    boundary_bytes: Optional[Sequence[int]],
) -> Tuple[List[float], List[float]]:
    """Per-stage service times (freq-scaled) and boundary transfers,
    mirroring ``core.simulator.simulate`` exactly."""
    p = plan.pipeline.p
    service = plan.stage_times(T)
    if stage_freqs is not None:
        if len(stage_freqs) != p:
            raise ValueError(f"{len(stage_freqs)} stage_freqs for {p} stages")
        service = [
            t * platform.freq_scale(stage[0], f)
            for t, stage, f in zip(service, plan.pipeline.stages, stage_freqs)
        ]
    if boundary_bytes is None:
        boundary_bytes = [0] * max(p - 1, 0)
    transfer = []
    for i in range(p - 1):
        (ta, _), (tb, _) = plan.pipeline.stages[i], plan.pipeline.stages[i + 1]
        nbytes = boundary_bytes[i]
        transfer.append(platform.transfer_time(nbytes) if ta != tb and nbytes else 0.0)
    return service, transfer


def predict_latency(
    plan: PipelinePlan,
    T: TimeMatrix,
    platform: HeteroPlatform,
    rate: float,
    *,
    stage_freqs: Optional[Sequence[Optional[float]]] = None,
    boundary_bytes: Optional[Sequence[int]] = None,
) -> LatencyPrediction:
    """Predict end-to-end p50/p95/p99 for ``plan`` under Poisson arrivals
    at ``rate`` images/s — the analytic counterpart of
    ``simulate(..., arrival_s=poisson_trace(rate, ...).times)``.

    An unstable plan (rate >= Eq.12 throughput) reports infinite
    percentiles and ``stable=False``; SLO-aware search ranks it last.
    """
    if rate < 0.0:
        raise ValueError(f"arrival rate {rate} < 0")
    service, transfer = _plan_services(plan, T, platform, stage_freqs, boundary_bytes)
    base = sum(service) + sum(transfer)
    bottleneck = max(service) if service else 0.0
    utils = tuple(rate * s for s in service)
    rho = rate * bottleneck
    stable = rho < 1.0
    if stable:
        p50, p95, p99 = (
            base + md1_wait_quantile(q, rate, bottleneck)
            for q in (0.50, 0.95, 0.99)
        )
        mean_wait = md1_mean_wait(rate, bottleneck)
    else:
        p50 = p95 = p99 = math.inf
        mean_wait = math.inf
    return LatencyPrediction(
        arrival_rate=rate,
        stable=stable,
        utilization=rho,
        stage_utilization=utils,
        base_latency_s=base,
        bottleneck_s=bottleneck,
        mean_wait_s=mean_wait,
        p50_s=p50,
        p95_s=p95,
        p99_s=p99,
    )


def mixture_latency_quantile(
    predictions: Sequence[LatencyPrediction],
    weights: Sequence[float],
    q: float,
) -> float:
    """Quantile of a mixture of per-phase latency distributions.

    Used for phase-modulated arrivals (MMPP burst/calm) under the
    quasi-stationary approximation: each phase contributes its stationary
    latency distribution weighted by the fraction of *arrivals* it
    carries (w_i ~ rate_i * dwell_i).  Valid when phase dwell times are
    long against the queue's relaxation time (DESIGN.md §8).
    """
    if len(predictions) != len(weights) or not predictions:
        raise ValueError("predictions and weights must be equal-length, non-empty")
    wsum = float(sum(weights))
    if wsum <= 0.0:
        raise ValueError("weights must have positive sum")
    ws = [w / wsum for w in weights]
    stable_mass = sum(w for w, p in zip(ws, predictions) if p.stable)
    if q >= stable_mass - 1e-15:
        return math.inf  # the unstable phase owns this quantile

    def cdf(t: float) -> float:
        total = 0.0
        for w, p in zip(ws, predictions):
            if not p.stable or t < p.base_latency_s:
                continue
            total += w * md1_wait_cdf(
                t - p.base_latency_s, p.arrival_rate, p.bottleneck_s
            )
        return total

    lo = 0.0
    hi = max(
        p.quantile(min(q, 0.999)) for p in predictions if p.stable
    ) + max(p.base_latency_s for p in predictions)
    for _ in range(200):
        if cdf(hi) >= q:
            break
        hi *= 2.0
    for _ in range(100):
        mid = 0.5 * (lo + hi)
        if cdf(mid) >= q:
            hi = mid
        else:
            lo = mid
    return hi


def predict_mmpp_latency(
    plan: PipelinePlan,
    T: TimeMatrix,
    platform: HeteroPlatform,
    *,
    calm_rate: float,
    burst_rate: float,
    calm_s: float,
    burst_s: float,
    stage_freqs: Optional[Sequence[Optional[float]]] = None,
    boundary_bytes: Optional[Sequence[int]] = None,
) -> Tuple[float, float, float]:
    """Quasi-stationary (p50, p95, p99) under a 2-state MMPP: per-phase
    stationary predictions mixed by arrival mass.  Conservative planning
    should additionally check the burst phase alone via
    ``predict_latency(plan, ..., burst_rate)``."""
    preds = [
        predict_latency(
            plan, T, platform, r,
            stage_freqs=stage_freqs, boundary_bytes=boundary_bytes,
        )
        for r in (calm_rate, burst_rate)
    ]
    weights = [calm_rate * calm_s, burst_rate * burst_s]
    return tuple(
        mixture_latency_quantile(preds, weights, q) for q in (0.50, 0.95, 0.99)
    )
