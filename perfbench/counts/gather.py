"""K1, the fused gather: the bytes a step's gathers need.

Each table of the model is gathered once a step (the d-wide table, and
the d = 1 first-order table where the model has one). A gather of ``b``
rows reads the (b, k) int32 ids and the (k,) int32 field offsets, reads
each distinct table row that the ids name once, and writes the (b, k * d)
fp32 output. ``distinct_rows`` is the number of distinct (field, id)
pairs; ids repeat under a skewed law, and a repeated row needs no second
read from device memory.
"""

from perfbench.reference import module


def table_widths(cfg: dict) -> list[int]:
    return [leaf.shape[1] for leaf in module(cfg["model"]).layout(cfg)
            if leaf.law == "table"]


def bytes_moved(cfg: dict, rows: float, steps: int,
                distinct_rows: float) -> float:
    k = len(cfg["field_sizes"])
    total = 0.0
    for d in table_widths(cfg):
        total += rows * k * 4 + steps * k * 4      # ids, offsets
        total += distinct_rows * d * 4             # table rows
        total += rows * k * d * 4                  # output
    return total
