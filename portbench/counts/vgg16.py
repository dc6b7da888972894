"""VGG-16's weighted layers as counted: 13 convs and 3 fcs.

Configuration D (arXiv:1409.1556) is 15.5e9 multiply-adds an image."""
from portbench.reference import vgg16

PUBLISHED_MACS = 15.5e9
MACS_PER_IMAGE = 15_470_264_320


def layers(hw: int = 224):
    return vgg16.layers(hw)
