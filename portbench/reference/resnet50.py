"""ResNet-50 v1 in plain PyTorch, f32.

He et al., "Deep Residual Learning for Image Recognition",
arXiv:1512.03385, Table 1, the 50-layer column: a 7x7/2 conv, a 3x3/2
max pool, four stages of bottleneck blocks (1x1, 3x3, 1x1 with 4x
expansion) of 3, 4, 6 and 3 blocks at widths 64, 128, 256 and 512, a
global average pool and a 1000-way fc with softmax.  As the served graph
has it: the stride of a stage's first block sits on its first 1x1 conv
and on the 1x1 projection shortcut, batch norm is folded into the conv
biases (a conv, then its ReLU), the residual add is followed by a ReLU,
max pooling pads with -inf.
"""
from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F

from .common import Layer, Params, same, conv, fc

INPUT = (224, 224, 3)
CLASSES = 1000
STAGES = ((64, 3), (128, 4), (256, 6), (512, 3))


def _block_name(si: int, bi: int) -> str:
    return f"res{si}{chr(97 + bi)}"


def layers(hw: int = INPUT[0]) -> List[Layer]:
    """The 53 convs and the fc, in the order the graph runs them, for
    square ``hw`` x ``hw`` images (224 as published)."""
    out = [Layer("conv1", "conv", 7, 3, 64, 2, 3, hw, hw)]
    h = (out[0].oh - 1) // 2 + 1  # after the 3x3/2 max pool, padded by 1
    cin = 64
    for si, (ch, blocks) in enumerate(STAGES, start=2):
        for bi in range(blocks):
            s = 2 if (bi == 0 and si > 2) else 1
            name = _block_name(si, bi)
            oh = (h - 1) // s + 1
            out.append(Layer(f"{name}_1", "conv", 1, cin, ch, s, 0, h, h))
            out.append(Layer(f"{name}_2", "conv", 3, ch, ch, 1, 1, oh, oh))
            out.append(Layer(f"{name}_3", "conv", 1, ch, 4 * ch, 1, 0, oh, oh))
            if bi == 0:
                out.append(Layer(f"{name}_proj", "conv", 1, cin, 4 * ch, s, 0, h, h))
            h, cin = oh, 4 * ch
    out.append(Layer("fc", "fc", 1, cin, CLASSES, 1, 0, 1, 1))
    return out


def forward(params: Params, x: torch.Tensor, cast=same) -> torch.Tensor:
    """NHWC images [B, 224, 224, 3] -> class probabilities [B, 1000];
    ``cast`` maps the operands of every product (the CPU control)."""
    h = conv(x.permute(0, 3, 1, 2), params["conv1"], 2, 3, relu=True, cast=cast)
    h = F.max_pool2d(h, 3, 2, padding=1)
    for si, (_, blocks) in enumerate(STAGES, start=2):
        for bi in range(blocks):
            s = 2 if (bi == 0 and si > 2) else 1
            name = _block_name(si, bi)
            a = conv(h, params[f"{name}_1"], s, 0, relu=True, cast=cast)
            a = conv(a, params[f"{name}_2"], 1, 1, relu=True, cast=cast)
            a = conv(a, params[f"{name}_3"], 1, 0, relu=False, cast=cast)
            sc = conv(h, params[f"{name}_proj"], s, 0, relu=False, cast=cast) if bi == 0 else h
            h = torch.relu(a + sc)
    h = h.mean(dim=(2, 3))
    return torch.softmax(fc(h, params["fc"], relu=False, cast=cast), dim=-1)
