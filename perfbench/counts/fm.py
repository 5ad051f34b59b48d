"""K11, DeepFM's second-order term: it reads the (b, k, d) fp32 rows once
and writes (b, 1) fp32."""


def bytes_moved(cfg: dict, rows: float) -> float:
    k, d = len(cfg["field_sizes"]), cfg["embed_dim"]
    return rows * (k * d * 4 + 4)
