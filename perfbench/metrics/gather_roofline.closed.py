"""K1's share of its roofline: the least time the card's memory could
move the gathers' bytes in (``counts/gather.py``) over K1's device time,
in the profiled part of the window."""


def read(run):
    t = run.kernel_seconds("gather")
    bw = run.peak("hbm_bytes_per_s")
    steps, rows = run.executed_in_profile()
    if not t or not bw or not steps:
        return None
    moved = run.count("gather").bytes_moved(
        run.config, rows=rows, steps=steps,
        distinct_rows=run.distinct_rows_in_profile())
    return 100.0 * moved / bw / t
