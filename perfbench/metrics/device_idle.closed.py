"""Share of the profiled part of the window in which no kernel, copy or
set ran on the device, its ends included."""


def read(run):
    t = run.trace
    if t is None or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
