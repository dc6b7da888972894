"""A small CNN graph IR mirroring the ARM-CL Graph API (paper §II).

PyTorch counterpart of ``repro/cnn/graph.py``: the same nodes, shapes,
descriptors and stage slicing; execution on torch tensors (NHWC).

Each network is a topologically-ordered list of nodes.  Weighted nodes
(conv / depthwise / fc) are the paper's *major layers*; every other node
(pool, LRN, concat, add, ...) is attached to the preceding major layer for
scheduling purposes (paper §III-B: "all kernels from the non-convolutional
layers are considered part of the previous convolutional layer").

The graph supports executing an arbitrary contiguous node range against an
environment of live tensors — exactly what a pipeline stage needs.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..core.descriptors import ConvDescriptor
from . import layers as L

MAJOR_KINDS = ("conv", "depthwise", "fc")


@dataclasses.dataclass(frozen=True)
class Node:
    name: str
    kind: str
    inputs: Tuple[str, ...]
    attrs: Dict[str, object] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Graph:
    name: str
    input_shape: Tuple[int, int, int]  # H, W, C
    nodes: List[Node] = dataclasses.field(default_factory=list)

    # ------------------------------------------------------------- builder
    def add(self, kind: str, name: str, inputs: Sequence[str], **attrs) -> str:
        self.nodes.append(Node(name=name, kind=kind, inputs=tuple(inputs), attrs=attrs))
        return name

    def conv(self, name, src, out_ch, kernel, stride=1, pad=None, groups=1, act="relu"):
        pad = kernel // 2 if pad is None else pad
        return self.add(
            "conv", name, [src], out_ch=out_ch, kernel=kernel, stride=stride,
            pad=pad, groups=groups, act=act,
        )

    def depthwise(self, name, src, kernel=3, stride=1, pad=None, act="relu"):
        pad = kernel // 2 if pad is None else pad
        return self.add("depthwise", name, [src], kernel=kernel, stride=stride, pad=pad, act=act)

    def fc(self, name, src, out_features, act="none"):
        return self.add("fc", name, [src], out_features=out_features, act=act)

    def pool_max(self, name, src, window, stride, pad=0):
        return self.add("pool_max", name, [src], window=window, stride=stride, pad=pad)

    def pool_avg(self, name, src, window, stride, pad=0):
        return self.add("pool_avg", name, [src], window=window, stride=stride, pad=pad)

    def gap(self, name, src):
        return self.add("gap", name, [src])

    def lrn(self, name, src):
        return self.add("lrn", name, [src])

    def concat(self, name, srcs):
        return self.add("concat", name, list(srcs))

    def residual_add(self, name, a, b, act="relu"):
        return self.add("add", name, [a, b], act=act)

    def softmax(self, name, src):
        return self.add("softmax", name, [src])

    def slice_ch(self, name, src, lo, hi):
        """Channel slice — lets a grouped conv be expressed as two plain
        conv nodes, matching ARM-CL's AlexNet implementation (Table I)."""
        return self.add("slice", name, [src], lo=lo, hi=hi)

    # ------------------------------------------------------- shape inference
    def infer_shapes(self) -> Dict[str, Tuple[int, ...]]:
        """Per-node output shape, excluding the batch dimension."""
        shapes: Dict[str, Tuple[int, ...]] = {"input": self.input_shape}
        for n in self.nodes:
            ins = [shapes[i] for i in n.inputs]
            s = ins[0]
            if n.kind in ("conv", "depthwise"):
                h, w, c = s
                k, st, pd = n.attrs["kernel"], n.attrs["stride"], n.attrs["pad"]
                oh = (h - k + 2 * pd) // st + 1
                ow = (w - k + 2 * pd) // st + 1
                oc = c if n.kind == "depthwise" else n.attrs["out_ch"]
                shapes[n.name] = (oh, ow, oc)
            elif n.kind == "fc":
                shapes[n.name] = (n.attrs["out_features"],)
            elif n.kind in ("pool_max", "pool_avg"):
                h, w, c = s
                k, st, pd = n.attrs["window"], n.attrs["stride"], n.attrs["pad"]
                oh = (h - k + 2 * pd) // st + 1
                ow = (w - k + 2 * pd) // st + 1
                shapes[n.name] = (oh, ow, c)
            elif n.kind == "gap":
                shapes[n.name] = (s[-1],)
            elif n.kind in ("lrn", "softmax"):
                shapes[n.name] = s
            elif n.kind == "concat":
                shapes[n.name] = (*s[:-1], sum(i[-1] for i in ins))
            elif n.kind == "add":
                shapes[n.name] = s
            elif n.kind == "slice":
                shapes[n.name] = (*s[:-1], n.attrs["hi"] - n.attrs["lo"])
            else:
                raise ValueError(f"unknown node kind {n.kind}")
        return shapes

    # ------------------------------------------------------- major layers
    def major_nodes(self) -> List[Node]:
        return [n for n in self.nodes if n.kind in MAJOR_KINDS]

    def descriptors(self) -> List[ConvDescriptor]:
        """ConvDescriptors (paper Eq. 3-4 inputs) for every major layer."""
        shapes = self.infer_shapes()
        out = []
        for n in self.nodes:
            if n.kind not in MAJOR_KINDS:
                continue
            s_in = shapes[n.inputs[0]]
            if n.kind == "fc":
                feats = int(np.prod(s_in))
                out.append(
                    ConvDescriptor(
                        name=n.name, i_w=1, i_h=1, i_d=feats, f_w=1, f_h=1,
                        ofm=n.attrs["out_features"], kind="fc",
                    )
                )
            else:
                h, w, c = s_in
                dw = n.kind == "depthwise"
                out.append(
                    ConvDescriptor(
                        name=n.name, i_w=w, i_h=h, i_d=c,
                        f_w=n.attrs["kernel"], f_h=n.attrs["kernel"],
                        ofm=(c if dw else n.attrs["out_ch"]),
                        pad=n.attrs["pad"], stride=n.attrs["stride"],
                        groups=(c if dw else n.attrs.get("groups", 1)),
                        kind="depthwise" if dw else "conv",
                    )
                )
        return out

    def boundary_bytes(self, dtype_bytes: int = 4) -> List[int]:
        """Activation bytes flowing out of each major layer (the tensor a
        stage boundary after that layer would move across the CCI/ICI)."""
        shapes = self.infer_shapes()
        majors = self.major_nodes()
        return [
            int(np.prod(shapes[n.name])) * dtype_bytes for n in majors
        ]

    # ---------------------------------------------------------- parameters
    def init(self, seed: int = 0, device=None) -> Dict[str, Dict[str, torch.Tensor]]:
        """Random He-style parameters from a ``torch.Generator`` seeded
        with ``seed``, made on ``device`` (``None`` means the card).  The numbers differ from the JAX package's
        ``Graph.init`` for the same seed; to run both packages on identical
        weights, convert the reference's with ``cnn.params.params_from_numpy``."""
        from ..kernels.config import resolve_device

        dev = resolve_device(device)
        generator = torch.Generator(device=dev).manual_seed(seed)

        def normal(shape, std):
            return torch.randn(shape, generator=generator, device=dev) * std

        shapes = self.infer_shapes()
        params: Dict[str, Dict[str, torch.Tensor]] = {}
        for n in self.nodes:
            if n.kind == "conv":
                h, w, c = shapes[n.inputs[0]]
                k, oc, g = n.attrs["kernel"], n.attrs["out_ch"], n.attrs.get("groups", 1)
                fan_in = k * k * (c // g)
                params[n.name] = {
                    "w": normal((k, k, c // g, oc), float(np.sqrt(2.0 / fan_in))),
                    "b": torch.zeros((oc,), device=dev),
                }
            elif n.kind == "depthwise":
                h, w, c = shapes[n.inputs[0]]
                k = n.attrs["kernel"]
                params[n.name] = {
                    "w": normal((k, k, 1, c), float(np.sqrt(2.0 / (k * k)))),
                    "b": torch.zeros((c,), device=dev),
                }
            elif n.kind == "fc":
                feats = int(np.prod(shapes[n.inputs[0]]))
                of = n.attrs["out_features"]
                params[n.name] = {
                    "w": normal((feats, of), float(np.sqrt(1.0 / feats))),
                    "b": torch.zeros((of,), device=dev),
                }
        return params

    # ----------------------------------------------------------- execution
    def _apply_node(self, n: Node, params, env, gemm_fn=None, backend=None):
        """Execute one node.  ``backend`` (a resolved
        :class:`repro_torch.kernels.backend.KernelBackend`) routes the
        major layers through the selected kernel backend and may fuse the
        node's ReLU into the kernel epilogue; ``None`` runs the plain
        layers (the ``"torch"`` route).  ``gemm_fn`` is the injection
        point of the plain layers' GEMM (quantized closures, tests) and
        wins over ``backend`` when both are set."""
        ins = [env[i] for i in n.inputs]
        x = ins[0]
        act_done = False
        relu = n.attrs.get("act") == "relu"
        if n.kind == "conv":
            p = params[n.name]
            if backend is not None and gemm_fn is None:
                y, act_done = backend.conv2d(
                    n.name, x, p["w"], p["b"], stride=n.attrs["stride"],
                    pad=n.attrs["pad"], groups=n.attrs.get("groups", 1),
                    relu=relu,
                )
            else:
                y = L.conv2d(
                    x, p["w"], p["b"], stride=n.attrs["stride"], pad=n.attrs["pad"],
                    groups=n.attrs.get("groups", 1), gemm_fn=gemm_fn,
                )
        elif n.kind == "depthwise":
            p = params[n.name]
            if backend is not None and gemm_fn is None:
                y, act_done = backend.depthwise(
                    n.name, x, p["w"], p["b"], stride=n.attrs["stride"],
                    pad=n.attrs["pad"], relu=relu,
                )
            else:
                y = L.depthwise_conv2d(x, p["w"], p["b"], stride=n.attrs["stride"], pad=n.attrs["pad"])
        elif n.kind == "fc":
            p = params[n.name]
            if backend is not None and gemm_fn is None:
                y, act_done = backend.dense(n.name, x, p["w"], p["b"], relu=relu)
            else:
                y = L.dense(x, p["w"], p["b"], gemm_fn=gemm_fn)
        elif n.kind == "pool_max":
            y = L.max_pool(x, n.attrs["window"], n.attrs["stride"], n.attrs["pad"])
        elif n.kind == "pool_avg":
            y = L.avg_pool(x, n.attrs["window"], n.attrs["stride"], n.attrs["pad"])
        elif n.kind == "gap":
            y = L.global_avg_pool(x)
        elif n.kind == "lrn":
            y = L.lrn(x)
        elif n.kind == "concat":
            y = torch.cat(ins, dim=-1)
        elif n.kind == "add":
            y = ins[0] + ins[1]
        elif n.kind == "softmax":
            y = L.softmax(x)
        elif n.kind == "slice":
            y = x[..., n.attrs["lo"] : n.attrs["hi"]]
        else:
            raise ValueError(n.kind)
        if relu and not act_done:
            y = L.relu(y)
        return y

    def apply_range(
        self,
        params,
        env: Dict[str, torch.Tensor],
        start: int,
        stop: int,
        gemm_fn=None,
        backend=None,
    ) -> Dict[str, torch.Tensor]:
        """Execute nodes[start:stop] on the live-tensor environment ``env``
        and return the pruned environment (only tensors still needed by
        nodes >= stop survive — this is what crosses a stage boundary).

        ``backend`` selects the kernel execution backend per node — a
        name from ``repro_torch.kernels.backend.BACKENDS``, a per-node mapping,
        a callable, or an already-resolved ``KernelBackend``."""
        from ..kernels.backend import resolve_backend

        backend = resolve_backend(backend)
        env = dict(env)
        for n in self.nodes[start:stop]:
            env[n.name] = self._apply_node(
                n, params, env, gemm_fn=gemm_fn, backend=backend
            )
        needed = set()
        for n in self.nodes[stop:]:
            needed.update(n.inputs)
        if stop < len(self.nodes):
            env = {k: v for k, v in env.items() if k in needed}
        else:
            env = {self.nodes[-1].name: env[self.nodes[-1].name]}
        return env

    def apply(self, params, x: torch.Tensor, gemm_fn=None, backend=None) -> torch.Tensor:
        env = self.apply_range(
            params, {"input": x}, 0, len(self.nodes), gemm_fn=gemm_fn, backend=backend
        )
        return env[self.nodes[-1].name]

    # -------------------------------------------------- stage partitioning
    def major_boundaries(self) -> List[int]:
        """node index just past each major layer's attached minor nodes —
        i.e. valid stage cut points, one per major layer."""
        majors = [i for i, n in enumerate(self.nodes) if n.kind in MAJOR_KINDS]
        bounds = []
        for j, mi in enumerate(majors):
            nxt = majors[j + 1] if j + 1 < len(majors) else len(self.nodes)
            bounds.append(nxt)  # everything before the next major layer
        return bounds

    def stage_slices(self, allocation: Sequence[Sequence[int]]) -> List[Tuple[int, int]]:
        """Convert a Pipe-it layer allocation (contiguous major-layer index
        ranges) to node-range slices."""
        bounds = self.major_boundaries()
        slices = []
        start = 0
        for stage_layers in allocation:
            stop = bounds[stage_layers[-1]] if stage_layers else start
            slices.append((start, stop))
            start = stop
        if slices:
            slices[-1] = (slices[-1][0], len(self.nodes))
        return slices


def major_layers(graph: Graph) -> List[ConvDescriptor]:
    return graph.descriptors()
