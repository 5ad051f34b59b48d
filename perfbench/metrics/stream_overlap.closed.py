"""Share of the device's busy time during which events on two or more
streams ran at once (the two branches of the "dual" step)."""


def read(run):
    t = run.trace
    if t is None or t.busy_s <= 0:
        return None
    return 100.0 * t.overlap_s / t.busy_s
