"""Set-up time: process start to the first timed request or step (host
clock). It holds loading, the fixture's decode, building the program
(and, on a checkout's first run, the kernels' build) and the warm-up."""


def read(run):
    return run.setup_s
