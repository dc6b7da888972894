"""Model FLOPs (2 x the multiply-adds of every conv and fc) of the images
completed in the traced window, over the window at 989 TFLOP/s, in %."""
from portbench.readers import mfu


def read(run):
    return mfu(run)
