"""K9's share of its roofline: the least time the card's memory could move
the cross tails' bytes in (``counts/cross.py``) over K9's device time, in
the profiled part of the window."""


def read(run):
    t = run.kernel_seconds("cross")
    bw = run.peak("hbm_bytes_per_s")
    steps, rows = run.executed_in_profile()
    if not t or not bw or not steps:
        return None
    moved = run.count("cross").bytes_moved(run.config,
                                           rows=rows)
    return 100.0 * moved / bw / t
