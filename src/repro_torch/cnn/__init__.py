"""CNN substrate of the port: the graph IR, layers and six nets in PyTorch.

Convolutions execute the ARM-CL way (im2col + GEMM) on the ``torch``
route, through the hand-written patch-matrix and GEMM kernels on
``cuda``, and through the hand-written fused kernel on ``cuda_fused``; the
layer descriptors that drive the performance model are the same objects
that parameterize the compute.
"""
from .graph import Graph, Node, major_layers
from .models import MODELS, alexnet, googlenet, mobilenet, resnet50, squeezenet, vgg16
from .params import params_from_numpy

__all__ = [
    "Graph",
    "Node",
    "major_layers",
    "MODELS",
    "alexnet",
    "googlenet",
    "mobilenet",
    "params_from_numpy",
    "resnet50",
    "squeezenet",
    "vgg16",
]
