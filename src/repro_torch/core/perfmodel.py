"""Layer-level performance estimation (paper §V, Eqs. 5-8).

Single-core model (Eq. 5):

    T = b1*N + b2*K + b3*M + b4*NK + b5*KM + b6*NM + b7*NKM + b8

Multi-core model (Eqs. 6-8) over ARM-CL's row-tiled GEMM: the image matrix
is split along N into ``n_iter = ceil(N / ts)`` iterations dispatched over
H threads:

    T_iter  = (T - a1) / n_iter + a2                       (Eq. 6)
    T_multi = max_t (T_iter * iter_t) + a3                 (Eq. 7)
            = (T - a1)/H + a2 * N/(ts*H) + a3   (equal split, Eq. 8)

The coefficients are fitted by linear least squares on microbenchmark
measurements (``core/calibration.py``).  Heterogeneity enters through the
platform's per-core-type ``speed`` factor: a core of speed ``v`` executes
the same iteration stream ``1/v`` times slower.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from .descriptors import ConvDescriptor, GemmDims
from .platform import HeteroPlatform, StageConfig

# DVFS-extended time matrix: T[layer][(core_type, count, freq_hz)] — the
# (layer, config, freq) form; freq None marks a fixed-clock cluster.
FreqTimeMatrix = List[Dict[Tuple[str, int, Optional[float]], float]]


def _features(dims: GemmDims) -> np.ndarray:
    n, k, m = float(dims.N), float(dims.K), float(dims.M)
    return np.array([n, k, m, n * k, k * m, n * m, n * m * k, 1.0])


@dataclasses.dataclass
class SingleCoreModel:
    """Eq. 5 regression.  ``beta`` has 8 coefficients (b1..b8)."""

    beta: np.ndarray

    def predict(self, dims: GemmDims) -> float:
        return float(max(_features(dims) @ self.beta, 1e-9))

    @staticmethod
    def fit(samples: Sequence[Tuple[GemmDims, float]]) -> "SingleCoreModel":
        x = np.stack([_features(d) for d, _ in samples])
        y = np.array([t for _, t in samples])
        # Weighted least squares in relative error: scale rows by 1/y so
        # small layers are not drowned out by the large ones.
        w = 1.0 / np.maximum(y, 1e-9)
        beta, *_ = np.linalg.lstsq(x * w[:, None], y * w, rcond=None)
        return SingleCoreModel(beta=beta)

    def mean_abs_pct_error(
        self, samples: Sequence[Tuple[GemmDims, float]]
    ) -> float:
        errs = [
            abs(self.predict(d) - t) / max(t, 1e-12) for d, t in samples
        ]
        return 100.0 * float(np.mean(errs))


@dataclasses.dataclass
class MultiCoreModel:
    """Eqs. 6-8.  ``alpha = (a1, a2, a3)``; ``tile_size`` is ARM-CL's ts."""

    single: SingleCoreModel
    alpha: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    tile_size: int = 16

    def n_iter(self, dims: GemmDims) -> int:
        return max(1, math.ceil(dims.N / self.tile_size))

    def predict(self, dims: GemmDims, cores: int, speed: float = 1.0) -> float:
        """Execution time of one layer's GEMM on ``cores`` homogeneous cores
        of relative speed ``speed`` (equal split, Eq. 8)."""
        return self.predict_from_t1(dims, self.single.predict(dims), cores, speed)

    def predict_from_t1(
        self, dims: GemmDims, t1: float, cores: int, speed: float = 1.0
    ) -> float:
        """Eq. 6-8 scaling from an arbitrary single-stream time ``t1``
        (reference-speed seconds).  This is how *measured* kernel times —
        e.g. the autotuner's per-layer route measurements — replace the
        Eq. 5 regression while keeping the paper's multi-core model."""
        if cores < 1:
            raise ValueError("cores must be >= 1")
        t1 = t1 / speed
        a1, a2, a3 = self.alpha
        n_it = self.n_iter(dims)
        t_iter = (t1 - a1) / n_it + a2 / speed
        # The slowest thread executes ceil(n_iter / H) iterations (Eq. 7).
        iters_slowest = math.ceil(n_it / cores)
        return max(t_iter * iters_slowest + a3, 1e-9)

    @staticmethod
    def fit(
        single: SingleCoreModel,
        samples: Sequence[Tuple[GemmDims, int, float]],
        tile_size: int = 16,
    ) -> "MultiCoreModel":
        """Fit (a1, a2, a3) from (dims, cores, measured_time) samples.

        Rearranging Eq. 7 with equal split gives a linear system in
        (a1, a2, a3):  T_multi = c/H' - a1/n_iter*H'' + a2*... ;  we fit by
        least squares on the residual against the alpha-free prediction.
        """
        model = MultiCoreModel(single=single, alpha=(0.0, 0.0, 0.0), tile_size=tile_size)
        rows, ys = [], []
        for dims, cores, t in samples:
            t1 = single.predict(dims)
            n_it = model.n_iter(dims)
            iters_slowest = math.ceil(n_it / cores)
            base = (t1 / n_it) * iters_slowest
            # T = base - a1*(iters/n_iter) + a2*iters + a3
            rows.append([-iters_slowest / n_it, iters_slowest, 1.0])
            ys.append(t - base)
        a, *_ = np.linalg.lstsq(np.array(rows), np.array(ys), rcond=None)
        return MultiCoreModel(single=single, alpha=(float(a[0]), float(a[1]), float(a[2])), tile_size=tile_size)


@dataclasses.dataclass
class LayerTimePredictor:
    """Produces the paper's time matrix T: layers x stage configurations.

    ``T[l][(core_type, count)]`` = predicted seconds for layer ``l`` on that
    homogeneous stage configuration (paper §VI-A).

    ``measured`` maps autotuner descriptor keys
    (:func:`repro.kernels.autotune.descriptor_key`) to measured
    single-stream route seconds; layers present there use
    ``predict_from_t1`` (measured t1, Eq. 6-8 core scaling) so the time
    matrix reflects the kernels that actually serve, and only unmeasured
    layers fall back to the Eq. 5 regression prior.
    """

    model: MultiCoreModel
    platform: HeteroPlatform
    measured: Optional[Dict[str, float]] = None

    def layer_time(
        self,
        desc: ConvDescriptor,
        stage: StageConfig,
        freq_hz: Optional[float] = None,
    ) -> float:
        """Predicted seconds for one layer on ``stage``, optionally at a
        non-top OPP: the Eq. 5/8 prior (or a measured t1) is scaled by the
        cluster's ``(f_max/f)^kappa`` latency factor (platform.py) — the
        DVFS extension of the paper's frequency-blind model.  ``None``
        means f_max, reproducing the legacy prediction exactly."""
        core_type, count = stage
        scale = self.platform.freq_scale(core_type, freq_hz)
        if self.measured:
            from ..kernels.autotune import descriptor_key

            t1 = self.measured.get(descriptor_key(desc))
            if t1 is not None:
                return scale * self.model.predict_from_t1(
                    desc.gemm_dims(), t1, cores=count,
                    speed=self.platform.speed(core_type),
                )
        return scale * self.model.predict(
            desc.gemm_dims(), cores=count, speed=self.platform.speed(core_type)
        )

    def time_matrix(
        self, layers: Sequence[ConvDescriptor]
    ) -> List[Dict[StageConfig, float]]:
        vocab = self.platform.stage_vocabulary()
        return [
            {stage: self.layer_time(desc, stage) for stage in vocab}
            for desc in layers
        ]

    def freq_time_matrix(
        self, layers: Sequence[ConvDescriptor]
    ) -> "FreqTimeMatrix":
        """The DVFS-extended time matrix: ``T[l][(core_type, count, f)]``
        over every stage configuration x the cluster's OPP table (a
        fixed-clock cluster contributes one ``(ct, n, None)`` entry).
        The planner's frequency-assignment search (core/dse.py) consumes
        the equivalent factored form (2-D matrix x freq_scale) — this
        explicit product form is the validation/reporting view."""
        vocab = self.platform.stage_vocabulary()
        out: FreqTimeMatrix = []
        for desc in layers:
            row: Dict[Tuple[str, int, Optional[float]], float] = {}
            for stage in vocab:
                freqs = self.platform.freq_levels(stage[0]) or (None,)
                for f in freqs:
                    row[(*stage, f)] = self.layer_time(desc, stage, f)
            out.append(row)
        return out

    def time_matrices(
        self, layers_by_model: "Mapping[str, Sequence[ConvDescriptor]]"
    ) -> "Dict[str, List[Dict[StageConfig, float]]]":
        """Time matrices for several co-resident models at once, with one
        shared per-geometry memo: layer times depend only on descriptor
        geometry (the autotuner cache key), and zoo CNNs share many conv
        shapes, so the partition DSE's M-model input costs roughly the
        number of *unique* geometries rather than the total layer count."""
        from ..kernels.autotune import descriptor_key

        vocab = self.platform.stage_vocabulary()
        memo: Dict[str, Dict[StageConfig, float]] = {}
        out: Dict[str, List[Dict[StageConfig, float]]] = {}
        for name, layers in layers_by_model.items():
            rows = []
            for desc in layers:
                key = descriptor_key(desc)
                row = memo.get(key)
                if row is None:
                    row = {stage: self.layer_time(desc, stage) for stage in vocab}
                    memo[key] = row
                rows.append(dict(row))
            out[name] = rows
        return out
