"""K9, the DCN-V2 cross tail ``x0 * xw + x``: the bytes of a step's tails.

Each cross layer's tail reads its distinct (b, k * d) fp32 inputs once and
writes its output once: layer 0 reads ``x0`` and ``xw`` (there ``x`` is
``x0``), every later layer ``x0``, ``xw`` and ``x``.
"""


def bytes_moved(cfg: dict, rows: float) -> float:
    d_in = len(cfg["field_sizes"]) * cfg["embed_dim"]
    layers = cfg["cross_layers"]
    tensors = 3 + 4 * (layers - 1) if layers else 0
    return rows * d_in * 4 * tensors
