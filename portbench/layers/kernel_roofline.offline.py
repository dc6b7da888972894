"""Summed roofline bound (989 TFLOP/s, 3.35 TB/s) of the conv and fc work
of the images completed in the traced window, over the union of the
kernels' intervals in it, in %."""
from portbench.readers import kernel_roofline


def read(run):
    return kernel_roofline(run)
