"""Heterogeneous platform models.

Two concrete platforms drive the Pipe-it algorithms:

* :class:`BigLittlePlatform` — the paper's Hikey-970-like big.LITTLE
  multi-core.  Because this container has no asymmetric silicon, the Small
  cluster is a *calibrated simulation*: a speed factor relative to the Big
  core (default 0.36 ~ A53@1.8GHz / A73@2.4GHz incl. IPC gap) applied to
  the measured/regressed Big-core layer times.  This is recorded in
  DESIGN.md §2 as a hardware-adaptation assumption.

* :class:`TpuStagePlatform` — the TPU-pod adaptation: "core types" are
  sub-mesh group sizes; see ``core/tpu_pipeit.py``.

The platform exposes the *stage configuration vocabulary*: every
``(core_type, core_count)`` tuple a pipeline stage may use, plus the
cross-"cluster" boundary transfer cost model (the CCI / ICI analogue).

DVFS (frequency- and power-aware planning) enters here too: each
:class:`CoreType` optionally carries an OPP table — the discrete
``(frequency, voltage)`` operating points cpufreq exposes on the real
board — plus an effective switched capacitance, giving the classic CMOS
active-power model per cluster

    P_active(f) = n_cores * C_eff * f * V(f)^2

and a calibratable latency-scaling exponent ``kappa``:

    t(f) = t(f_max) * (f_max / f)^kappa

(``kappa = 1`` is pure frequency scaling; memory-bound layers on real
silicon show ``kappa < 1`` because DRAM does not slow down with the
core clock — DESIGN.md §7).  A :class:`CoreType` with an empty
``freq_levels`` is fixed-clock: the power model degrades to zero and
every frequency-aware code path treats it as a single implicit level.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

StageConfig = Tuple[str, int]  # (core_type, core_count), e.g. ("B", 3)


@dataclasses.dataclass(frozen=True)
class CoreType:
    name: str
    count: int
    speed: float  # relative single-core throughput vs. reference core (B=1.0),
    # measured AT f_max (the top OPP); lower OPPs scale via freq_scale()
    l2_bytes: int = 0
    # --- DVFS / power model (empty tuple => fixed clock, no power model) ---
    freq_levels: Tuple[float, ...] = ()  # OPP frequencies in Hz, ascending
    volts: Tuple[float, ...] = ()  # V(f) per OPP (same length); () => all 1.0 V
    capacitance_f: float = 0.0  # effective switched capacitance C_eff (farads)
    freq_exponent: float = 1.0  # kappa: t(f) = t(f_max) * (f_max/f)^kappa

    def __post_init__(self) -> None:
        if self.freq_levels:
            if list(self.freq_levels) != sorted(self.freq_levels):
                raise ValueError(f"{self.name}: freq_levels must be ascending")
            if self.volts and len(self.volts) != len(self.freq_levels):
                raise ValueError(
                    f"{self.name}: volts must match freq_levels "
                    f"({len(self.volts)} vs {len(self.freq_levels)})"
                )

    @property
    def f_max(self) -> Optional[float]:
        return self.freq_levels[-1] if self.freq_levels else None

    def volt(self, freq_hz: float) -> float:
        """V(f) at an OPP (exact match required — OPPs are discrete)."""
        if not self.freq_levels:
            return 1.0
        i = self.freq_levels.index(freq_hz)  # raises ValueError off-table
        return self.volts[i] if self.volts else 1.0

    def freq_scale(self, freq_hz: Optional[float]) -> float:
        """Latency multiplier at ``freq_hz`` relative to f_max:
        ``(f_max / f)^kappa``.  ``None`` (or a fixed-clock type) => 1.0."""
        if freq_hz is None or not self.freq_levels:
            return 1.0
        if freq_hz not in self.freq_levels:
            raise ValueError(
                f"{self.name}: {freq_hz:.3g} Hz is not an OPP "
                f"(table: {[f'{f:.3g}' for f in self.freq_levels]})"
            )
        return (self.f_max / freq_hz) ** self.freq_exponent

    def active_power_w(self, freq_hz: Optional[float], n_cores: int = 1) -> float:
        """CMOS active power of ``n_cores`` busy cores at an OPP:
        ``n * C_eff * f * V(f)^2``.  Fixed-clock core types model 0 W."""
        if freq_hz is None or not self.freq_levels:
            return 0.0
        return n_cores * self.capacitance_f * freq_hz * self.volt(freq_hz) ** 2


@dataclasses.dataclass(frozen=True)
class HeteroPlatform:
    """A heterogeneous multi-core: ordered core types, fastest first."""

    name: str
    core_types: Tuple[CoreType, ...]
    # Boundary transfer model: seconds per byte moved across the cluster
    # boundary (CCI on big.LITTLE, ICI hop for TPU stage groups), plus a
    # fixed per-image handoff latency.
    boundary_bytes_per_s: float = 5.0e9
    boundary_latency_s: float = 20e-6

    def stage_vocabulary(self) -> List[StageConfig]:
        """All (H_B + H_s) possible stage configurations (paper §VI-A)."""
        vocab: List[StageConfig] = []
        for ct in self.core_types:
            vocab.extend((ct.name, n) for n in range(1, ct.count + 1))
        return vocab

    def counts(self) -> Dict[str, int]:
        return {ct.name: ct.count for ct in self.core_types}

    def speed(self, core_type: str) -> float:
        for ct in self.core_types:
            if ct.name == core_type:
                return ct.speed
        raise KeyError(core_type)

    def core_type(self, name: str) -> CoreType:
        for ct in self.core_types:
            if ct.name == name:
                return ct
        raise KeyError(name)

    def total_cores(self) -> int:
        return sum(ct.count for ct in self.core_types)

    # ------------------------------------------------------------- DVFS
    def freq_levels(self, core_type: str) -> Tuple[float, ...]:
        """The cluster's OPP frequencies (ascending); ``()`` = fixed clock."""
        return self.core_type(core_type).freq_levels

    def freq_scale(self, core_type: str, freq_hz: Optional[float]) -> float:
        """Latency multiplier for running ``core_type`` at ``freq_hz``."""
        return self.core_type(core_type).freq_scale(freq_hz)

    def active_power_w(
        self, core_type: str, n_cores: int, freq_hz: Optional[float]
    ) -> float:
        """Active power of ``n_cores`` busy cores of ``core_type`` at an OPP."""
        return self.core_type(core_type).active_power_w(freq_hz, n_cores)

    def max_power_w(self) -> float:
        """Every core busy at its cluster's top OPP — the machine's modeled
        active-power envelope (the reference point power caps are set
        against)."""
        return sum(
            ct.active_power_w(ct.f_max, ct.count) for ct in self.core_types
        )

    def has_dvfs(self) -> bool:
        return any(ct.freq_levels for ct in self.core_types)

    def transfer_time(self, nbytes: int) -> float:
        return self.boundary_latency_s + nbytes / self.boundary_bytes_per_s

    def subset(
        self, counts: Dict[str, int], name: str = "", strict: bool = True
    ) -> "HeteroPlatform":
        """A sub-platform holding ``counts[ct]`` cores of each core type.

        The multi-model partition DSE (core/dse.py) carves the machine
        into disjoint *cluster shares*, one per co-resident model; each
        share is itself a :class:`HeteroPlatform` so the single-model DSE
        (``pipe_it_search``) runs unchanged within it.  Core types with a
        zero share are dropped; speeds, L2 sizes, and the boundary
        transfer model are inherited (the CCI is chip-wide).

        A share naming a core type this platform lacks raises ``KeyError``
        (a plan carved for one board must not be silently re-shaped onto
        another).  Degrade paths that intentionally project a share onto
        the surviving clusters pass ``strict=False``.
        """
        if strict:
            known = {ct.name for ct in self.core_types}
            absent = sorted(k for k in counts if k not in known)
            if absent:
                raise KeyError(
                    f"share names core types {absent} absent from platform "
                    f"{self.name!r} (have {sorted(known)}); pass strict=False "
                    "to project onto the available clusters"
                )
        kept: List[CoreType] = []
        for ct in self.core_types:
            n = counts.get(ct.name, 0)
            if n < 0 or n > ct.count:
                raise ValueError(
                    f"share wants {n} {ct.name!r} cores, platform has {ct.count}"
                )
            if n:
                kept.append(dataclasses.replace(ct, count=n))
        if not kept:
            raise ValueError("a cluster share needs >= 1 core")
        return HeteroPlatform(
            name=name
            or f"{self.name}[{'+'.join(f'{ct.name}{ct.count}' for ct in kept)}]",
            core_types=tuple(kept),
            boundary_bytes_per_s=self.boundary_bytes_per_s,
            boundary_latency_s=self.boundary_latency_s,
        )


# Kirin-970-like OPP tables (a sub-grid of the kernel's cpufreq tables;
# voltages follow the usual near-linear V(f) of the A73/A53 DVFS curves).
# C_eff is set so the modeled envelope matches the board's measured order
# of magnitude: ~1.3 W per A73 core and ~0.35 W per A53 core at f_max,
# i.e. ~6.6 W all-cores-max for the SoC's CPU complex (DESIGN.md §7).
BIG_OPPS = (0.682e9, 1.210e9, 1.844e9, 2.093e9, 2.362e9)
BIG_VOLTS = (0.70, 0.80, 0.93, 1.02, 1.10)
BIG_CEFF = 1.3 / (BIG_OPPS[-1] * BIG_VOLTS[-1] ** 2)
SMALL_OPPS = (0.533e9, 0.999e9, 1.402e9, 1.709e9, 1.844e9)
SMALL_VOLTS = (0.65, 0.75, 0.85, 0.95, 1.00)
SMALL_CEFF = 0.35 / (SMALL_OPPS[-1] * SMALL_VOLTS[-1] ** 2)


def hikey970(small_speed: float = 0.36, dvfs: bool = True) -> HeteroPlatform:
    """The paper's evaluation platform: 4x A73 'B' + 4x A53 's' (Fig. 1).

    ``dvfs=True`` (the default) attaches the Kirin-970-like OPP tables and
    the per-cluster ``P = C_eff * f * V(f)^2`` power model; ``speed`` stays
    the f_max relative throughput, so every existing fixed-clock consumer
    sees identical times (frequency only enters when a caller asks for a
    non-top OPP).  ``dvfs=False`` returns the legacy fixed-clock platform.
    """
    big_kw = dict(freq_levels=BIG_OPPS, volts=BIG_VOLTS,
                  capacitance_f=BIG_CEFF) if dvfs else {}
    small_kw = dict(freq_levels=SMALL_OPPS, volts=SMALL_VOLTS,
                    capacitance_f=SMALL_CEFF) if dvfs else {}
    return HeteroPlatform(
        name="hikey970",
        core_types=(
            CoreType("B", 4, 1.0, l2_bytes=2 * 1024 * 1024, **big_kw),
            CoreType("s", 4, small_speed, l2_bytes=1 * 1024 * 1024, **small_kw),
        ),
        # CCI-500 effective ~5 GB/s; the paper attributes the kernel-level
        # collapse (Fig. 3) to cross-cluster conflict-miss latency.
        boundary_bytes_per_s=5.0e9,
        boundary_latency_s=20e-6,
    )
