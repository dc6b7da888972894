"""ModelRegistry — the co-serving model zoo handle.

A production edge box never serves one CNN (PICO, arXiv 2206.08662;
Synergy, arXiv 1804.00706): the registry holds the co-resident graphs,
their parameters, and the per-model serving policy the two-level
partition DSE consumes — a relative ``weight`` (how much this model's
throughput counts in the aggregate objective) and an ``slo_rate``
throughput floor (images/second this model must sustain; 0 = none).

Entries are ordered (insertion order defines model order everywhere:
share enumeration, router metrics, benchmark tables).  ``coerce`` turns
the loose dict forms ``serve()`` accepts into a registry:

    serve({"vgg16": "vgg16", "mine": my_graph})
    serve({"a": ModelEntry(...), "b": {"graph": g, "weight": 2.0}})

The port's copy of ``repro/serving/registry.py``: missing parameters are
made by the port's ``Graph.init(seed, device)`` on the serving device
(``None`` means the card).  They are other numbers than the reference's
for the same seed; to co-serve the reference's weights, pass entries
whose params come from ``cnn.params.params_from_numpy``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, Mapping, Optional

from ..cnn.graph import Graph
from ..cnn.models import MODELS


@dataclasses.dataclass
class ModelEntry:
    """One co-resident model: graph + params + serving policy."""

    name: str
    graph: Graph
    params: Any
    weight: float = 1.0  # relative value of this model's throughput
    slo_rate: float = 0.0  # min sustained img/s (0 = best effort)

    def __post_init__(self) -> None:
        if self.weight <= 0.0:
            raise ValueError(f"{self.name}: weight must be > 0")
        if self.slo_rate < 0.0:
            raise ValueError(f"{self.name}: slo_rate must be >= 0")


class ModelRegistry:
    """Ordered name -> :class:`ModelEntry` map for multi-model serving."""

    def __init__(self) -> None:
        self._entries: Dict[str, ModelEntry] = {}

    def add(
        self,
        name: str,
        graph: Optional[Graph | str] = None,
        params: Any = None,
        *,
        weight: float = 1.0,
        slo_rate: float = 0.0,
        seed: int = 0,
        device=None,
    ) -> ModelEntry:
        """Register a model.  ``graph`` may be a :class:`Graph`, a zoo
        name from ``repro_torch.cnn.MODELS``, or None (then ``name`` itself
        is looked up in the zoo).  Missing ``params`` are initialised from
        ``seed`` on ``device`` (``None`` means the card)."""
        if name in self._entries:
            raise ValueError(f"model {name!r} already registered")
        if graph is None:
            graph = name
        if isinstance(graph, str):
            if graph not in MODELS:
                raise KeyError(
                    f"unknown zoo model {graph!r}; have {sorted(MODELS)}"
                )
            graph = MODELS[graph]()
        if params is None:
            params = graph.init(seed=seed, device=device)
        entry = ModelEntry(
            name=name, graph=graph, params=params, weight=weight, slo_rate=slo_rate
        )
        self._entries[name] = entry
        return entry

    @classmethod
    def coerce(
        cls, spec: "ModelRegistry | Mapping[str, Any]", device=None
    ) -> "ModelRegistry":
        """Accept the loose forms ``serve()`` takes for its multi-model
        path: an existing registry, or a mapping whose values are a
        Graph, a zoo name, a :class:`ModelEntry`, or a kwargs dict for
        :meth:`add`.  Parameters this makes are made on ``device``
        (``None`` means the card) unless a kwargs dict names its own."""
        if isinstance(spec, cls):
            return spec
        if not isinstance(spec, Mapping):
            raise TypeError(f"cannot build a ModelRegistry from {type(spec)!r}")
        reg = cls()
        for name, val in spec.items():
            if isinstance(val, ModelEntry):
                if val.name != name:
                    val = dataclasses.replace(val, name=name)
                reg._entries[name] = val
            elif isinstance(val, Mapping):
                reg.add(name, **{"device": device, **val})
            else:  # Graph | zoo name | None
                reg.add(name, val, device=device)
        return reg

    # ------------------------------------------------------------- accessors
    def __len__(self) -> int:
        return len(self._entries)

    def __iter__(self) -> Iterator[ModelEntry]:
        return iter(self._entries.values())

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def __getitem__(self, name: str) -> ModelEntry:
        return self._entries[name]

    @property
    def names(self) -> list:
        return list(self._entries)

    def graphs(self) -> Dict[str, Graph]:
        return {e.name: e.graph for e in self}

    def weights(self) -> Dict[str, float]:
        return {e.name: e.weight for e in self}

    def slo_rates(self) -> Dict[str, float]:
        return {e.name: e.slo_rate for e in self}
