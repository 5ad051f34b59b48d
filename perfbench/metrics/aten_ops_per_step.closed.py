"""ATen ops the host dispatches for one step of the served path: the
profiler's ops on one thread over a few requests of the cell's own
sizes, run once the window has closed (``devtrace.ops_per_step``)."""


def read(run):
    return run.ops_per_step
