"""Kernel execution backends for the CNN serving hot path.

Every conv/fc node a `Graph` executes routes through one of three
backends, selectable per node; the counterparts of the JAX package's
``"xla"``, ``"pallas"`` and ``"pallas_fused"`` routes:

``"torch"``
    The plain route: explicit im2col patch matrix + matmul
    (`cnn/layers.py`).  Reference semantics and the numerical baseline.
``"cuda"``
    The unfused conv-as-GEMM route of paper section V-A, through the
    hand-written kernels of `kernels/ops.py`: each conv writes its
    explicit patch matrix with ``im2col`` (B4, batched, one launch) and
    multiplies it with ``gemm`` (B3); fc nodes go through ``gemm``.  The
    bias add stays outside the GEMM and the ReLU is left to
    `finish_act`.  Grouped convs run one patch matrix and one GEMM per
    group; depthwise convs keep their native conv.  On CPU tensors both
    kernels take their plain versions.
``"cuda_fused"``
    The hand-written fused kernels (`kernels/conv_fused.py`): the
    implicit-GEMM conv and the fc GEMM, both with the epilogue (bias,
    ReLU) fused.  On a CUDA tensor they launch the kernel or raise; on a
    CPU tensor they take their plain PyTorch versions.  Shapes
    `conv_fused.supports` rejects (grouped and depthwise convs) take the
    plain fused route and are counted in ``fallbacks``.  With a
    `ConvAutotuner` attached, each conv runs on the tile variant the
    tuner picked for its geometry (every variant gives the same bits).

A backend *spec* is a backend name, a ``{node_name: name}`` mapping
(missing nodes get ``default``), or a callable ``node_name -> name``.
`resolve_backend` turns a spec into a `KernelBackend`; everything above
`Graph._apply_node` (stage builders, engines, server, planner) just
threads the spec through.

:func:`measure_graph_routes` times every major layer of a graph on the
route this backend selects for it (the paper's T-matrix unit: one
image, one stream), through the tuner's route cache.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from ..core.descriptors import ConvDescriptor
from .autotune import ConvAutotuner, descriptor_key
from .conv_fused import conv2d_fused, fused_route_ref, matmul_fused, supports

BACKENDS = ("torch", "cuda", "cuda_fused")

BackendSpec = Union[str, Mapping[str, str], Callable[[str], str], "KernelBackend"]


@dataclasses.dataclass
class KernelBackend:
    """Per-node kernel routing.

    ``tuner`` (a :class:`~repro_torch.kernels.autotune.ConvAutotuner`)
    picks the ``cuda_fused`` conv's tile variant per geometry.
    ``fallbacks`` records nodes the fused kernel declined (a shape it
    does not take) as ``{node_name: reason}``.
    """

    spec: BackendSpec = "torch"
    default: str = "torch"
    tuner: Optional[ConvAutotuner] = None
    fallbacks: Dict[str, str] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if isinstance(self.spec, str) and self.spec not in BACKENDS:
            raise ValueError(f"unknown backend {self.spec!r}; pick from {BACKENDS}")

    # ------------------------------------------------------------- routing
    def for_node(self, name: str) -> str:
        if callable(self.spec):
            choice = self.spec(name)
        elif isinstance(self.spec, str):
            choice = self.spec
        else:
            choice = self.spec.get(name, self.default)
        if choice not in BACKENDS:
            raise ValueError(f"unknown backend {choice!r} for node {name!r}")
        return choice

    def _tile(self, name, x, w, stride, pad, groups) -> Dict[str, int]:
        """The tuner's tile variant for this conv's geometry ({} with no
        tuner: the kernel's own choice)."""
        if self.tuner is None:
            return {}
        fh, fw, _, cout = w.shape
        desc = ConvDescriptor(
            name=name, i_w=x.shape[2], i_h=x.shape[1], i_d=x.shape[3],
            f_w=fw, f_h=fh, ofm=cout, pad=pad, stride=stride, groups=groups,
        )
        return self.tuner.tune(desc).as_kwargs()

    def tune_graph(self, graph) -> None:
        """Tune every conv of ``graph`` this backend runs on the fused
        kernel, so that later lookups, including those made while a CUDA
        graph captures a stage, are cache hits."""
        if self.tuner is None:
            return
        for d in graph.descriptors():
            if (d.kind == "conv" and self.for_node(d.name) == "cuda_fused"
                    and supports(d.f_h, d.f_w, d.stride, d.groups)):
                self.tuner.tune(d)

    # -------------------------------------------------------------- convs
    def conv2d(
        self,
        name: str,
        x: torch.Tensor,
        w: torch.Tensor,
        b: Optional[torch.Tensor],
        *,
        stride: int = 1,
        pad: int = 0,
        groups: int = 1,
        relu: bool = False,
    ) -> Tuple[torch.Tensor, bool]:
        """Returns ``(y, act_done)`` — ``act_done`` when the backend fused
        the ReLU into the kernel epilogue."""
        from ..cnn import layers as L

        choice = self.for_node(name)
        if choice == "torch":
            return L.conv2d(x, w, b, stride=stride, pad=pad, groups=groups), False
        if choice == "cuda":
            return _unfused_conv(x, w, b, stride=stride, pad=pad, groups=groups), False
        fh, fw, _, _ = w.shape
        if not supports(fh, fw, stride, groups):
            # grouped convolution is the only shape supports() rejects today
            self.fallbacks[name] = f"groups={groups}"
            return (
                fused_route_ref(
                    x, w, b, stride=stride, pad=pad, groups=groups, relu=relu
                ),
                True,
            )
        tile = self._tile(name, x, w, stride, pad, groups)
        y = conv2d_fused(x, w, b, stride=stride, pad=pad, relu=relu, **tile)
        return y, True

    def depthwise(
        self,
        name: str,
        x: torch.Tensor,
        w: torch.Tensor,
        b: Optional[torch.Tensor],
        *,
        stride: int = 1,
        pad: int = 0,
        relu: bool = False,
    ) -> Tuple[torch.Tensor, bool]:
        """Depthwise convs keep their native grouped-conv implementation on
        every backend; under ``cuda_fused`` the epilogue still fuses and
        the fallback is recorded."""
        from ..cnn import layers as L

        if self.for_node(name) == "cuda_fused":
            self.fallbacks[name] = "depthwise"
            return (
                fused_route_ref(
                    x, w, b, stride=stride, pad=pad,
                    groups=x.shape[-1], relu=relu,
                ),
                True,
            )
        return L.depthwise_conv2d(x, w, b, stride=stride, pad=pad), False

    # -------------------------------------------------------------- dense
    def dense(
        self,
        name: str,
        x: torch.Tensor,
        w: torch.Tensor,
        b: Optional[torch.Tensor],
        *,
        relu: bool = False,
    ) -> Tuple[torch.Tensor, bool]:
        from ..cnn import layers as L

        choice = self.for_node(name)
        if choice == "torch":
            return L.dense(x, w, b), False
        if choice == "cuda":
            from .ops import gemm

            return L.dense(x, w, b, gemm_fn=gemm), False
        x2 = x.reshape(x.shape[0], -1)  # NHWC flatten: (h, w, c) order
        bias = torch.zeros(w.shape[1], device=w.device) if b is None else b
        return matmul_fused(x2, w, bias, relu=relu), True


def _unfused_conv(
    x: torch.Tensor,
    w: torch.Tensor,
    b: Optional[torch.Tensor],
    *,
    stride: int,
    pad: int,
    groups: int,
) -> torch.Tensor:
    """The ``"cuda"`` route's conv: per group, the batched patch matrix
    ``[B*OH*OW, FH*FW*Cg]`` (B4), freed after its GEMM (B3) with the
    filter reshaped to ``[FH*FW*Cg, Cout_g]``; then the bias."""
    from .ops import gemm, im2col_batched

    bsz = x.shape[0]
    fh, fw, cin_g, cout = w.shape
    cout_g = cout // groups
    outs = []
    for g in range(groups):
        xg = x if groups == 1 else x[..., g * cin_g : (g + 1) * cin_g]
        wg = w if groups == 1 else w[..., g * cout_g : (g + 1) * cout_g]
        cols = im2col_batched(xg, fh, fw, stride, pad)
        outs.append(gemm(cols, wg.reshape(fh * fw * cin_g, cout_g)))
        del cols
    y = outs[0] if groups == 1 else torch.cat(outs, dim=-1)
    h, wd = x.shape[1], x.shape[2]
    oh = (h - fh + 2 * pad) // stride + 1
    ow = (wd - fw + 2 * pad) // stride + 1
    y = y.reshape(bsz, oh, ow, cout)
    return y + b if b is not None else y


def resolve_backend(
    spec: Optional[BackendSpec], *, tuner: Optional[ConvAutotuner] = None
) -> Optional[KernelBackend]:
    """None passes through (the graph then runs its plain layers); a
    resolved backend keeps its own tuner."""
    if spec is None or isinstance(spec, KernelBackend):
        return spec
    return KernelBackend(spec=spec, tuner=tuner)


def finish_act(result: Tuple[torch.Tensor, bool]) -> torch.Tensor:
    """Apply the ReLU a backend did NOT fuse — keeps cross-backend timing
    and parity comparisons symmetric (same total work on every route)."""
    y, act_done = result
    return y if act_done else torch.relu(y)


def measure_graph_routes(
    graph, kb: KernelBackend, tuner: ConvAutotuner, batch: int = 1
) -> Dict[str, float]:
    """Measure (best of k, cached per route name in ``tuner``) the
    serving-route seconds of every major layer of ``graph`` under backend
    ``kb``, on the tuner's device — ``batch`` images, one stream, the
    paper's T-matrix measurement unit.  Inputs are made by numpy from
    seed 0, as the reference makes them.  Returns {descriptor key:
    seconds} for exactly the routes this backend selects — the mapping
    `LayerTimePredictor` consumes.  Every conv the fused route runs is
    tuned first (:meth:`KernelBackend.tune_graph`)."""
    rng = np.random.default_rng(0)
    dev = tuner.device
    measured: Dict[str, float] = {}

    def tensor(shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(dev)

    def timed(desc, fn):
        measured[descriptor_key(desc)] = tuner.measure_route(
            desc, fn, route=kb.for_node(desc.name)
        )

    kb.tune_graph(graph)
    with torch.no_grad():
        for desc in graph.descriptors():
            if desc.kind == "fc":
                k, m = desc.i_w * desc.i_h * desc.i_d, desc.ofm
                x, w = tensor((batch, k)), tensor((k, m), 0.02)
                b = torch.zeros(m, device=dev)
                timed(desc, lambda x=x, w=w, b=b, n=desc.name: finish_act(
                    kb.dense(n, x, w, b, relu=True)))
            elif desc.kind == "depthwise":
                x = tensor((batch, desc.i_h, desc.i_w, desc.i_d))
                w = tensor((desc.f_h, desc.f_w, 1, desc.i_d), 0.1)
                b = torch.zeros(desc.i_d, device=dev)
                timed(desc, lambda x=x, w=w, b=b, d=desc: finish_act(
                    kb.depthwise(d.name, x, w, b, stride=d.stride, pad=d.pad, relu=True)))
            else:
                x = tensor((batch, desc.i_h, desc.i_w, desc.i_d))
                w = tensor((desc.f_h, desc.f_w, desc.f_d, desc.ofm), 0.05)
                b = torch.zeros(desc.ofm, device=dev)
                timed(desc, lambda x=x, w=w, b=b, d=desc: finish_act(
                    kb.conv2d(d.name, x, w, b, stride=d.stride, pad=d.pad,
                              groups=d.groups, relu=True)))
    return measured
