"""PyTorch/CUDA port of the Pipe-it CNN serving system.

Laid out module for module like the JAX package ``repro``: ``core`` (the
planning core: descriptors, performance model, DSE), ``cnn`` (graph IR,
layers, the six nets), ``kernels`` (the hand-written CUDA kernels of the
hot paths and the backend that routes graph nodes to them), ``serving``
(micro-batched pipelined server and the ``serve`` planner), and the
transformer substrate as far as Hymba needs it: ``configs`` (the
architecture configs), ``models`` (Hymba's blocks and the causal LM) and
``launch`` (the prefill + greedy decode launcher).

Activations are NHWC and filters HWIO at every public function, so
weights cross between the two packages unchanged.  Entry points run on
the CUDA device unless the caller passes ``device="cpu"``.
"""
from .kernels.config import resolve_device

__all__ = ["resolve_device"]
