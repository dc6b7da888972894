"""VGG-16 in plain PyTorch, f32.

Simonyan and Zisserman, "Very Deep Convolutional Networks for
Large-Scale Image Recognition", arXiv:1409.1556, Table 1, configuration
D: thirteen 3x3/1 convs with padding 1 and ReLU in five blocks of 2, 2,
3, 3 and 3 at widths 64, 128, 256, 512 and 512, each block closed by a
2x2/2 max pool; fc 4096, fc 4096 (each with ReLU), fc 1000, softmax.
The first fc reads the 7x7x512 map flattened in (h, w, c) order, as the
served graph has it (NHWC).
"""
from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F

from .common import Layer, Params, same, conv, fc, nhwc_flatten

INPUT = (224, 224, 3)
CLASSES = 1000
BLOCKS = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))
FCS = (("fc6", 4096, True), ("fc7", 4096, True), ("fc8", CLASSES, False))


def layers(hw: int = INPUT[0]) -> List[Layer]:
    """The 13 convs and 3 fcs, in the order the graph runs them, for
    square ``hw`` x ``hw`` images (224 as published)."""
    out, h, cin = [], hw, 3
    for bi, (ch, reps) in enumerate(BLOCKS, start=1):
        for ri in range(1, reps + 1):
            out.append(Layer(f"conv{bi}_{ri}", "conv", 3, cin, ch, 1, 1, h, h))
            cin = ch
        h //= 2
    feats = h * h * cin
    for name, width, _ in FCS:
        out.append(Layer(name, "fc", 1, feats, width, 1, 0, 1, 1))
        feats = width
    return out


def forward(params: Params, x: torch.Tensor, cast=same) -> torch.Tensor:
    """NHWC images [B, 224, 224, 3] -> class probabilities [B, 1000];
    ``cast`` maps the operands of every product (the CPU control)."""
    h = x.permute(0, 3, 1, 2)
    for bi, (_, reps) in enumerate(BLOCKS, start=1):
        for ri in range(1, reps + 1):
            h = conv(h, params[f"conv{bi}_{ri}"], 1, 1, relu=True, cast=cast)
        h = F.max_pool2d(h, 2, 2)
    h = nhwc_flatten(h)
    for name, _, relu in FCS:
        h = fc(h, params[name], relu=relu, cast=cast)
    return torch.softmax(h, dim=-1)
