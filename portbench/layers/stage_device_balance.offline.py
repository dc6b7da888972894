"""Mean over stages of their device seconds in the window, over the
largest stage's.  A stage's device seconds are the profiler's busy time
on the stream its thread launched on (the server's span log ties the
thread to the stage).  Beside ``stage_balance.offline`` (host clock) it
tells a plan unbalanced on the card from one unbalanced on the host.
Nothing to read without spans."""
from portbench.spans import stage_device_balance


def read(run):
    return stage_device_balance(getattr(run, "stage_device_s", None))
