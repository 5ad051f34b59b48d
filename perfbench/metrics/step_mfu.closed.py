"""The whole step's share of the card's fp32 peak (the precision the
configuration states): the model's operations for the rows scored in the
profiled part of the window (``counts/step.py``) over that part's length
times the peak."""


def read(run):
    peak = run.peak("fp32_flops_per_s")
    if run.trace is None or not peak or run.trace.busy_s <= 0:
        return None
    flops = run.count("step").flops_per_row(run.config) \
        * run.rows_in_profile()
    return 100.0 * flops / (run.trace.window_s * peak)
