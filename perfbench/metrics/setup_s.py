"""Seconds from the start of the benchmark's process to the window's
opening: imports, the device's context, the kernels' libraries (built on
a checkout's first run), the model and its weights, the id pool, the
engine's buckets compiled and warmed."""


def read(run):
    return run.setup_s
