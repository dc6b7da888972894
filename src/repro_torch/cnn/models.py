"""The paper's five benchmark CNNs (Table I), with major-node counts that
match their ARM-CL implementations exactly:

    AlexNet     11 major nodes (conv2/4/5 grouped -> two nodes each)
    GoogLeNet   58 (3 conv + 9 inception x 6 conv + 1 fc)
    MobileNet   28 (14 conv + 13 depthwise + 1 fc)
    ResNet50    54 (1 conv + 52 block convs + 1 fc)
    SqueezeNet  26 (2 conv + 8 fire x 3 conv)
"""
from __future__ import annotations

from typing import Callable, Dict

from .graph import Graph


def alexnet() -> Graph:
    g = Graph("alexnet", (227, 227, 3))
    c1 = g.conv("conv1", "input", 96, 11, stride=4, pad=0)
    g.lrn("lrn1", c1)
    p1 = g.pool_max("pool1", "lrn1", 3, 2)
    # conv2: grouped (2 groups) -> two nodes + concat (ARM-CL style)
    a = g.slice_ch("c2_in_a", p1, 0, 48)
    b = g.slice_ch("c2_in_b", p1, 48, 96)
    c2a = g.conv("conv2a", a, 128, 5, pad=2)
    c2b = g.conv("conv2b", b, 128, 5, pad=2)
    c2 = g.concat("conv2_cat", [c2a, c2b])
    g.lrn("lrn2", c2)
    p2 = g.pool_max("pool2", "lrn2", 3, 2)
    c3 = g.conv("conv3", p2, 384, 3, pad=1)
    a4 = g.slice_ch("c4_in_a", c3, 0, 192)
    b4 = g.slice_ch("c4_in_b", c3, 192, 384)
    c4a = g.conv("conv4a", a4, 192, 3, pad=1)
    c4b = g.conv("conv4b", b4, 192, 3, pad=1)
    c4 = g.concat("conv4_cat", [c4a, c4b])
    a5 = g.slice_ch("c5_in_a", c4, 0, 192)
    b5 = g.slice_ch("c5_in_b", c4, 192, 384)
    c5a = g.conv("conv5a", a5, 128, 3, pad=1)
    c5b = g.conv("conv5b", b5, 128, 3, pad=1)
    c5 = g.concat("conv5_cat", [c5a, c5b])
    p5 = g.pool_max("pool5", c5, 3, 2)
    f6 = g.fc("fc6", p5, 4096, act="relu")
    f7 = g.fc("fc7", f6, 4096, act="relu")
    f8 = g.fc("fc8", f7, 1000)
    g.softmax("prob", f8)
    return g


def _inception(g: Graph, name: str, src: str, c1, c3r, c3, c5r, c5, pp) -> str:
    b1 = g.conv(f"{name}_1x1", src, c1, 1)
    r3 = g.conv(f"{name}_3x3r", src, c3r, 1)
    b3 = g.conv(f"{name}_3x3", r3, c3, 3, pad=1)
    r5 = g.conv(f"{name}_5x5r", src, c5r, 1)
    b5 = g.conv(f"{name}_5x5", r5, c5, 5, pad=2)
    pl = g.pool_max(f"{name}_pool", src, 3, 1, pad=1)
    bp = g.conv(f"{name}_poolproj", pl, pp, 1)
    return g.concat(f"{name}_out", [b1, b3, b5, bp])


def googlenet() -> Graph:
    g = Graph("googlenet", (224, 224, 3))
    c1 = g.conv("conv1", "input", 64, 7, stride=2, pad=3)
    p1 = g.pool_max("pool1", c1, 3, 2, pad=1)
    g.lrn("lrn1", p1)
    c2 = g.conv("conv2_reduce", "lrn1", 64, 1)
    c3 = g.conv("conv2", c2, 192, 3, pad=1)
    g.lrn("lrn2", c3)
    p2 = g.pool_max("pool2", "lrn2", 3, 2, pad=1)
    i3a = _inception(g, "i3a", p2, 64, 96, 128, 16, 32, 32)
    i3b = _inception(g, "i3b", i3a, 128, 128, 192, 32, 96, 64)
    p3 = g.pool_max("pool3", i3b, 3, 2, pad=1)
    i4a = _inception(g, "i4a", p3, 192, 96, 208, 16, 48, 64)
    i4b = _inception(g, "i4b", i4a, 160, 112, 224, 24, 64, 64)
    i4c = _inception(g, "i4c", i4b, 128, 128, 256, 24, 64, 64)
    i4d = _inception(g, "i4d", i4c, 112, 144, 288, 32, 64, 64)
    i4e = _inception(g, "i4e", i4d, 256, 160, 320, 32, 128, 128)
    p4 = g.pool_max("pool4", i4e, 3, 2, pad=1)
    i5a = _inception(g, "i5a", p4, 256, 160, 320, 32, 128, 128)
    i5b = _inception(g, "i5b", i5a, 384, 192, 384, 48, 128, 128)
    gp = g.gap("gap", i5b)
    fc = g.fc("fc", gp, 1000)
    g.softmax("prob", fc)
    return g


def mobilenet() -> Graph:
    g = Graph("mobilenet", (224, 224, 3))
    x = g.conv("conv1", "input", 32, 3, stride=2, pad=1)
    plan = [
        (1, 64), (2, 128), (1, 128), (2, 256), (1, 256), (2, 512),
        (1, 512), (1, 512), (1, 512), (1, 512), (1, 512), (2, 1024), (1, 1024),
    ]
    for i, (stride, out_ch) in enumerate(plan, start=1):
        x = g.depthwise(f"dw{i}", x, 3, stride=stride, pad=1)
        x = g.conv(f"pw{i}", x, out_ch, 1)
    gp = g.gap("gap", x)
    fc = g.fc("fc", gp, 1000)
    g.softmax("prob", fc)
    return g


def resnet50() -> Graph:
    g = Graph("resnet50", (224, 224, 3))
    x = g.conv("conv1", "input", 64, 7, stride=2, pad=3)
    x = g.pool_max("pool1", x, 3, 2, pad=1)
    stage_blocks = [(64, 3), (128, 4), (256, 6), (512, 3)]
    for si, (ch, blocks) in enumerate(stage_blocks, start=2):
        for bi in range(blocks):
            stride = 2 if (bi == 0 and si > 2) else 1
            src = x
            a = g.conv(f"res{si}{chr(97+bi)}_1", src, ch, 1, stride=stride)
            b = g.conv(f"res{si}{chr(97+bi)}_2", a, ch, 3, pad=1)
            c = g.conv(f"res{si}{chr(97+bi)}_3", b, ch * 4, 1, act="none")
            if bi == 0:
                sc = g.conv(f"res{si}a_proj", src, ch * 4, 1, stride=stride, act="none")
            else:
                sc = src
            x = g.residual_add(f"res{si}{chr(97+bi)}_add", c, sc, act="relu")
    gp = g.gap("gap", x)
    fc = g.fc("fc", gp, 1000)
    g.softmax("prob", fc)
    return g


def _fire(g: Graph, name: str, src: str, s1, e1, e3) -> str:
    sq = g.conv(f"{name}_squeeze", src, s1, 1)
    x1 = g.conv(f"{name}_e1", sq, e1, 1)
    x3 = g.conv(f"{name}_e3", sq, e3, 3, pad=1)
    return g.concat(f"{name}_out", [x1, x3])


def squeezenet() -> Graph:
    g = Graph("squeezenet", (224, 224, 3))
    c1 = g.conv("conv1", "input", 96, 7, stride=2, pad=3)
    p1 = g.pool_max("pool1", c1, 3, 2)
    f2 = _fire(g, "fire2", p1, 16, 64, 64)
    f3 = _fire(g, "fire3", f2, 16, 64, 64)
    f4 = _fire(g, "fire4", f3, 32, 128, 128)
    p4 = g.pool_max("pool4", f4, 3, 2)
    f5 = _fire(g, "fire5", p4, 32, 128, 128)
    f6 = _fire(g, "fire6", f5, 48, 192, 192)
    f7 = _fire(g, "fire7", f6, 48, 192, 192)
    f8 = _fire(g, "fire8", f7, 64, 256, 256)
    p8 = g.pool_max("pool8", f8, 3, 2)
    f9 = _fire(g, "fire9", p8, 64, 256, 256)
    c10 = g.conv("conv10", f9, 1000, 1)
    gp = g.gap("gap", c10)
    g.softmax("prob", gp)
    return g


def vgg16() -> Graph:
    """VGG-16 (not in the paper's Table I; added as the kernel backend's
    conv-dominated acceptance workload — 13 uniform 3x3 convs + 3 fc)."""
    g = Graph("vgg16", (224, 224, 3))
    x = "input"
    plan = [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]
    for bi, (ch, reps) in enumerate(plan, start=1):
        for ri in range(1, reps + 1):
            x = g.conv(f"conv{bi}_{ri}", x, ch, 3, pad=1)
        x = g.pool_max(f"pool{bi}", x, 2, 2)
    f1 = g.fc("fc6", x, 4096, act="relu")
    f2 = g.fc("fc7", f1, 4096, act="relu")
    f3 = g.fc("fc8", f2, 1000)
    g.softmax("prob", f3)
    return g


MODELS: Dict[str, Callable[[], Graph]] = {
    "alexnet": alexnet,
    "googlenet": googlenet,
    "mobilenet": mobilenet,
    "resnet50": resnet50,
    "squeezenet": squeezenet,
    "vgg16": vgg16,
}

# Paper Table I major-node counts, used as a structural regression test
# (vgg16 is beyond Table I: 13 conv + 3 fc).
PAPER_MAJOR_COUNTS = {
    "alexnet": 11,
    "googlenet": 58,
    "mobilenet": 28,
    "resnet50": 54,
    "squeezenet": 26,
    "vgg16": 16,
}
