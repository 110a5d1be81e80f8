"""Seconds from the process's start to the first timed batch: imports,
the kernels' load (their build in a fresh checkout), the weights drawn
and quantized, the warm-up batch."""


def read(run):
    return run["setup_s"]
