"""ResNet-50's weighted layers as counted: 53 convs and the fc.

He et al. (arXiv:1512.03385, Table 1) give 3.8e9 multiply-adds an image
for the 50-layer net with the stride on the first 1x1 conv of a stage
(v1, as served); the 4.1e9 often quoted is v1.5's, stride on the 3x3.
"""
from portbench.reference import resnet50

PUBLISHED_MACS = 3.8e9
MACS_PER_IMAGE = 3_857_973_248


def layers(hw: int = 224):
    return resnet50.layers(hw)
