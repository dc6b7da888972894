"""Roofline terms of one step, counted on the ``meta`` device.

Port of ``repro/roofline/analysis.py``.  The reference reads XLA's
``cost_analysis`` and ``memory_analysis`` of a compiled program against
TPU v5e constants.  PyTorch runs a program op by op and compiles
nothing, so :func:`analyze_step` runs the step itself on ``meta``
tensors (shapes and dtypes, no storage, no device) and counts:

- FLOPs with ``torch.utils.flop_counter.FlopCounterMode`` (the products:
  ``mm``, ``bmm``, ``addmm``, convolutions; elementwise work counts 0);
- bytes with :class:`_OpCounter`, a ``TorchDispatchMode`` of its own:
  each op's distinct input elements read once and its outputs written
  once.  A view adds nothing, an in-place op's output (an alias of its
  input) adds nothing, an ``empty`` allocation adds nothing, and an
  indexed write (``index_copy_`` and its kin) counts its source and
  indices and the slots it writes, not the whole destination.  This is
  what the eager program moves op by op, the counterpart of XLA's "bytes
  accessed" for a program that PyTorch does not fuse;
- the peak of live bytes: the same mode follows every storage an op
  creates until it is freed.  With the step's arguments, outputs and
  their aliases this gives the counterpart of ``memory_analysis()``.
  The peak is also kept by region (the port's Python call stack at the
  allocation), so that ``launch/dryrun.py`` can fit each region's peak
  on its own when it scales a trace: the step's peak is the largest of
  them, and which region holds it can change with the sequence.

A hand-written kernel's call on ``meta`` (``kernels/ops.py``) runs no
op that could be counted: it records its own FLOPs and bytes from
:func:`flash_decode_cost` or :func:`ssd_cost` into the active counter
(:func:`note_kernel_call`), the same functions ``chip_smoke.py`` bounds
those kernels by.  The kernels' scratch buffers are not counted.

The card's rates come from :func:`card_peaks`, NVIDIA's data sheets.
One card runs no collective, so the collective terms are 0 and the
reference's HLO parser ``collective_bytes`` has no counterpart.
"""
from __future__ import annotations

import contextvars
import dataclasses
import math
import os
import sys
import weakref
from typing import Any, Dict, Iterator, NamedTuple, Optional, Tuple

import torch
from torch import nn
# PyTorch's private modules: the pytree walker, and the home of the
# documented TorchDispatchMode; a storage's ``_cdata`` (its identity) is
# private too.  A PyTorch upgrade may move them.
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode


class CardPeaks(NamedTuple):
    """Published dense rates of one card (no sparsity)."""

    f32_flops: float  # CUDA-core f32 FLOP/s
    hbm_bytes_per_s: float
    int8_ops: float  # int8 tensor-core op/s
    bf16_flops: float  # bf16 tensor-core FLOP/s
    nvlink_bytes_per_s: float  # NVLink, each direction
    memory_gb: float  # HBM capacity


# NVIDIA's H100 data sheets: f32 CUDA-core FLOP/s, HBM bytes/s, int8
# tensor-core op/s and bf16 tensor-core FLOP/s, dense; NVLink's total
# (900 GB/s SXM, 600 GB/s NVL and the PCIe card's bridge) halved for one
# direction; HBM capacity.  A name matches the first product it contains,
# so "H100" (the SXM part) comes last.
PEAKS = {
    "H100 PCIe": CardPeaks(51.2e12, 2.0e12, 1513e12, 756e12, 300e9, 80.0),
    "H100 NVL": CardPeaks(60.0e12, 3.9e12, 1671e12, 835e12, 300e9, 94.0),
    "H100": CardPeaks(67.0e12, 3.35e12, 1979e12, 989e12, 450e9, 80.0),
}


def card_peaks(name: str) -> CardPeaks:
    """The rates of the card ``name`` (``torch.cuda.get_device_name``, or a
    product of :data:`PEAKS` such as ``"H100"``); an unknown card raises."""
    for key, val in PEAKS.items():
        if key in name:
            return val
    raise KeyError(f"no published rates for card {name!r}; known: {list(PEAKS)}")


# ------------------------------------------------------ the kernels' costs
def flash_decode_cost(b: int, hkv: int, g: int, d: int, length: int, q_bytes: int = 2,
                      kv_bytes: int = 2, quant: bool = False) -> Tuple[int, int]:
    """(FLOPs, bytes) of one B5 call: q ``[b, hkv, g, d]`` over ``length``
    valid slots.  FLOPs: QK^T and PV, 4 b hkv g length d.  Bytes: q read
    and the output written (``q_bytes`` an element), and the valid K and
    V prefix read once (``kv_bytes`` an element; an int8 cache at a byte
    a value plus one f32 scale a slot and head)."""
    flops = 4 * b * hkv * g * length * d
    kv = 2 * b * length * hkv * (d + 4) if quant else 2 * b * length * hkv * d * kv_bytes
    return flops, 2 * q_bytes * b * hkv * g * d + kv


def ssd_cost(b: int, s: int, h: int, n: int, p: int, chunk: int, normalizer: bool = False,
             bc_heads: Optional[int] = None, x_bytes: int = 2, la_bytes: int = 2,
             h0: bool = False, n0: bool = False) -> Tuple[int, int]:
    """(FLOPs, bytes) of one B6 call over x ``[b, s, h, p]`` and B/C
    ``[b, s, h, n]``, in chunks of ``chunk``.  FLOPs, per chunk: the
    causal half of the ``Q x Q`` scores (C.B over N) and their product
    with x (over P), and the two ``N x P`` terms (the chunk's state
    summary and the carried state's output).  Bytes: x read and y
    written and B and C read (``x_bytes`` an element; ``bc_heads`` = 1
    for B and C broadcast over the heads by a stride of 0), log a read
    (``la_bytes``), the f32 final state written, and with the normalizer
    den ``[b, s, h]`` and the final normalizer state ``[b, h, n]`` in
    f32; an initial state ``h0`` and ``n0`` read where given."""
    bc = h if bc_heads is None else bc_heads
    n_chunks = b * h * -(-s // chunk)
    causal = chunk * (chunk + 1) // 2
    flops = 2 * n_chunks * (causal * n + causal * p + 2 * chunk * n * p)
    nbytes = (x_bytes * (2 * b * s * h * p + 2 * b * s * bc * n) + la_bytes * b * s * h
              + 4 * b * h * n * p)
    if normalizer:
        nbytes += 4 * (b * s * h + b * h * n)
    if h0:
        nbytes += 4 * b * h * n * p
    if n0:
        nbytes += 4 * b * h * n
    return flops, nbytes


# ---------------------------------------------------------------- counting
_COUNTER: contextvars.ContextVar[Optional["_OpCounter"]] = contextvars.ContextVar(
    "repro_torch_op_counter", default=None)


def note_kernel_call(name: str, flops: int, nbytes: int) -> None:
    """Record one call of the kernel ``name`` with its cost in the counter
    of the running :func:`trace_step`, if any."""
    counter = _COUNTER.get()
    if counter is not None:
        rec = counter.kernels.setdefault(name, {"calls": 0, "flops": 0, "bytes": 0})
        rec["calls"] += 1
        rec["flops"] += int(flops)
        rec["bytes"] += int(nbytes)


aten = torch.ops.aten
# allocations that write nothing
_NO_TRAFFIC = {aten.empty.memory_format, aten.empty_strided.default, aten.empty_like.default,
               aten.new_empty.default, aten.new_empty_strided.default}
# indexed writes: the destination (argument 0) is written at the slots
# its source fills, not read or written whole
_INDEXED_WRITES = {aten.index_copy_.default, aten.index_put_.default, aten._index_put_impl_.default,
                   aten.index_add_.default, aten.scatter_.src, aten.scatter_add_.default,
                   aten.masked_scatter_.default}


_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))  # repro_torch/
_HERE = os.path.dirname(os.path.abspath(__file__))


def _region(stop) -> Tuple[Any, ...]:
    """The code objects of the port's frames on the stack below the frame
    ``stop`` (the tracer's) and outside this package, innermost first:
    where an op runs, stable from one trace to the next.  Ops the
    autograd engine runs have none of them."""
    f, key = sys._getframe(2), []
    while f is not None and f is not stop:
        name = f.f_code.co_filename
        if name.startswith(_PKG) and not name.startswith(_HERE):
            key.append(f.f_code)
        f = f.f_back
    return tuple(key)


def _region_name(key: Tuple[Any, ...]) -> str:
    return " < ".join(f"{os.path.basename(co.co_filename)}:{co.co_name}:{co.co_firstlineno}"
                      for co in key) or "outside the port's code (the autograd engine)"


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _distinct_bytes(t: torch.Tensor) -> int:
    """The bytes of ``t``'s distinct elements: a broadcast (stride-0)
    dimension is read once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size() if t.numel() else 0


def _tensors(obj: Any, seen: set) -> Iterator[torch.Tensor]:
    """Every tensor reachable from a step's arguments or outputs: through
    dicts, lists, tuples, dataclasses and named tuples, and a module's
    parameters, buffers and the modules it keeps beside them (the model's
    compute-dtype copy of its blocks)."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, nn.Module):
        if id(obj) in seen:
            return
        seen.add(id(obj))
        yield from obj.parameters()
        yield from obj.buffers()
        for key, val in vars(obj).items():
            if key not in ("_parameters", "_buffers", "_modules"):
                yield from _tensors(val, seen)
    elif isinstance(obj, dict):
        for val in obj.values():
            yield from _tensors(val, seen)
    elif isinstance(obj, (list, tuple)):
        for val in obj:
            yield from _tensors(val, seen)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            yield from _tensors(getattr(obj, f.name), seen)


def storage_bytes(*objs: Any) -> Dict[int, int]:
    """{storage key: bytes} of the distinct storages reachable from
    ``objs``."""
    seen: set = set()
    out: Dict[int, int] = {}
    for obj in objs:
        for t in _tensors(obj, seen):
            out[_storage_key(t)] = t.untyped_storage().nbytes()
    return out


class _OpCounter(TorchDispatchMode):
    """Counts the bytes each op moves and follows the live bytes of the
    storages the ops create (see the module's docstring)."""

    def __init__(self, stop):
        super().__init__()
        self._stop = stop  # the tracer's frame: regions are the frames below it
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self.kernels: Dict[str, Dict[str, int]] = {}
        self.regions: Dict[Tuple[Any, ...], int] = {}  # region -> the most bytes live after its allocations
        self._tracked: set = set()

    def _free(self, key: int, nbytes: int) -> None:
        self.live -= nbytes
        self._tracked.discard(key)

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._tracked:
            return
        nbytes = st.nbytes()
        self._tracked.add(key)
        self.live += nbytes
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key, nbytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = [t for t in pytree.tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
        outs = [t for t in pytree.tree_leaves(out) if isinstance(t, torch.Tensor)]
        in_keys = {_storage_key(t) for t in ins}
        new = [t for t in outs if _storage_key(t) not in in_keys]
        if func in _INDEXED_WRITES:
            src = ins[1:]  # indices and source; the slots written are the source's size
            self.bytes += sum(_distinct_bytes(t) for t in src) + _distinct_bytes(src[-1])
        elif func not in _NO_TRAFFIC and (new or func._schema.is_mutable):
            ids: set = set()
            for t in ins:
                if id(t) not in ids:
                    ids.add(id(t))
                    self.bytes += _distinct_bytes(t)
            self.bytes += sum(_distinct_bytes(t) for t in new)
        for t in new:
            self._track(t)
        if new:
            key = _region(self._stop)
            self.regions[key] = max(self.regions.get(key, 0), self.live)
        return out


@dataclasses.dataclass
class StepTrace:
    """What one traced step moved and held.  ``flops`` and ``bytes`` are the
    PyTorch ops' (the kernels' are in ``kernels``: {name: {"calls",
    "flops", "bytes"}}); ``argument_bytes`` the distinct storages of the
    arguments, ``output_bytes`` of the outputs, ``alias_bytes`` the
    outputs' storages that are arguments' (updated in place),
    ``temp_bytes`` the peak of the bytes the step allocated and held at
    once, less the new outputs', and ``regions`` that peak by region of
    the step (the most bytes the step held after an allocation there)."""

    flops: int
    bytes: int
    kernels: Dict[str, Dict[str, int]]
    argument_bytes: int
    output_bytes: int
    alias_bytes: int
    temp_bytes: int
    regions: Dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def total_flops(self) -> int:
        return self.flops + sum(k["flops"] for k in self.kernels.values())

    @property
    def total_bytes(self) -> int:
        return self.bytes + sum(k["bytes"] for k in self.kernels.values())

    @property
    def peak_bytes(self) -> int:
        """argument + output + temp - alias: the arguments and the most the
        step holds beside them."""
        return self.argument_bytes + self.output_bytes + self.temp_bytes - self.alias_bytes


def trace_step(fn, *args, **kwargs) -> Tuple[StepTrace, Any]:
    """Run ``fn(*args, **kwargs)`` once (on ``meta`` tensors) under the
    counters; returns (its :class:`StepTrace`, its output)."""
    arg_storages = storage_bytes(args, kwargs)
    counter = _OpCounter(sys._getframe())
    token = _COUNTER.set(counter)
    try:
        with FlopCounterMode(display=False) as flop_mode, counter:
            out = fn(*args, **kwargs)
    finally:
        _COUNTER.reset(token)
    outs = storage_bytes(out)
    new_out = sum(nb for key, nb in outs.items() if key not in arg_storages)
    alias = sum(nb for key, nb in outs.items() if key in arg_storages)
    trace = StepTrace(
        flops=int(flop_mode.get_total_flops()), bytes=counter.bytes, kernels=counter.kernels,
        argument_bytes=sum(arg_storages.values()), output_bytes=sum(outs.values()), alias_bytes=alias,
        temp_bytes=max(0, counter.peak - new_out),
        regions={_region_name(key): nb for key, nb in counter.regions.items()},
    )
    return trace, out


# ---------------------------------------------------------------- terms
@dataclasses.dataclass
class RooflineTerms:
    flops_per_chip: float
    bytes_per_chip: float
    collective_bytes_per_chip: float
    collectives: Dict[str, int]
    n_chips: int
    compute_s: float = 0.0
    memory_s: float = 0.0
    collective_s: float = 0.0
    bottleneck: str = ""
    model_flops: float = 0.0
    useful_ratio: float = 0.0
    memory_per_chip_gb: float = 0.0

    def finalize(self, model_flops: float, peaks: CardPeaks) -> "RooflineTerms":
        """The terms at the card's bf16 peak and HBM rate; one card runs
        no collective."""
        self.compute_s = self.flops_per_chip / peaks.bf16_flops
        self.memory_s = self.bytes_per_chip / peaks.hbm_bytes_per_s
        self.collective_s = 0.0
        terms = {"compute": self.compute_s, "memory": self.memory_s, "collective": self.collective_s}
        self.bottleneck = max(terms, key=terms.get)
        self.model_flops = model_flops
        self.useful_ratio = model_flops / self.flops_per_chip if self.flops_per_chip else 0.0
        return self

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def terms_of(trace: StepTrace) -> RooflineTerms:
    """The un-finalized terms of one card from a trace, kernels included."""
    t = RooflineTerms(
        flops_per_chip=float(trace.total_flops), bytes_per_chip=float(trace.total_bytes),
        collective_bytes_per_chip=0.0, collectives={}, n_chips=1,
    )
    t.memory_per_chip_gb = trace.peak_bytes / 1e9
    return t


def analyze_step(fn, *args, peaks: CardPeaks, model_flops: float = 0.0,
                 **kwargs) -> Tuple[RooflineTerms, StepTrace]:
    """Counterpart of the reference's ``analyze_compiled``: one step of
    ``fn`` traced on ``meta`` tensors (:func:`trace_step`), its terms
    finalized at ``peaks``."""
    trace, _ = trace_step(fn, *args, **kwargs)
    return terms_of(trace).finalize(model_flops, peaks), trace


# ------------------------------------------------------------ model counts
def count_params(cfg, model: nn.Module) -> Tuple[int, int]:
    """(total, active) parameter counts.  Active discounts routed experts
    (a name containing ``.moe.`` whose last part is ``w1``, ``w2`` or
    ``w3``) to their top_k / n_experts fraction (MoE: 6*N_active*D
    convention)."""
    total = routed = 0
    for name, p in model.named_parameters():
        n = math.prod(p.shape)
        total += n
        if ".moe." in name and name.rsplit(".", 1)[-1] in ("w1", "w2", "w3"):
            routed += n
    active = total - routed
    if cfg.n_experts:
        active += routed * cfg.top_k / cfg.n_experts
    return total, int(active)


def model_flops(cfg, model: nn.Module, shape) -> float:
    """6*N*D for training, 2*N*D for inference (D = tokens per step)."""
    _, active = count_params(cfg, model)
    if shape.kind == "train":
        return 6.0 * active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * active * shape.global_batch * shape.seq_len
    return 2.0 * active * shape.global_batch

