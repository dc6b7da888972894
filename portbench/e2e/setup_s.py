"""Process start to the first timed request (host clock): imports, the
weights and images, the plan, the build, graph capture, the pre-roll."""


def read(run):
    return run.setup_s
