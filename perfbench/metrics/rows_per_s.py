"""Candidate rows scored per second: the rows of every answered request,
padding excluded, over the whole window, from its opening to the last
answer."""


def read(run):
    w = run.window
    rows = sum(r.rows for r in w.answered)
    return rows / (w.t_end - w.t0) if rows else None
